"""The port's serving CLI (``repro_torch.launch.serve``) against the
reference CLI's (``repro/launch/serve.py``), in-process on the CPU.

* ``--chaos-seed`` builds the reference CLI's fault plan; a run prints the
  ``fault plane:`` line, every request ends finished or with a typed
  error, and ``counters()`` equal the reference engine's on that plan and
  geometry (the reduced ``tinyllama-1.1b``, reference weights: with no EOS
  the schedule ignores the weights);
* ``--deadline-steps`` bounds each request (``DeadlineExceeded``), and 0 is
  refused;
* the ``--legacy`` wave batcher (:class:`BatchedServer`) emits the reference
  ``BatchedServer``'s tokens on ``TINY_DENSE`` weights carried across by
  ``repro_torch.interop``, and the CLI refuses every option of the paged
  engine with the reference CLI's message;
* ``--ffn-backend`` takes ``grouped`` and ``ref`` into the engine's config
  and refuses the reference's ``scan`` and ``interpret`` by name;
* ``repro_torch.launch.train`` takes the reference's ``--reduced``.
"""
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import serving as J  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.registry import get_model as jget_model  # noqa: E402

from repro_torch import interop  # noqa: E402
from repro_torch import serving as T  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402

from _torch_interop import flatten_reference, torch_one_thread  # noqa: E402,F401
from test_serving_sim import TINY_DENSE  # noqa: E402

ARCH = "tinyllama-1.1b"
CHAOS = ["--arch", ARCH, "--requests", "4", "--max-new", "4", "--device", "cpu"]


def _reference_plan(seed, requests=4, max_new=4):
    """The plan the reference CLI attaches for ``--chaos-seed seed``
    (``repro/launch/serve.py:390``; no ``--resident-experts``)."""
    return J.FaultPlan.generate(seed, n_faults=8, max_step=4 * max_new,
                                sites=("swap_out", "swap_in", "pool", "logits"),
                                rids=list(range(requests)))


def _reference_engine(plan):
    """The reference engine on the CLI's geometry for 4 requests of 24 + 4
    tokens (4 slots, 16-token pages, 3 pages a request, growth, swap),
    serving the CLI's prompts on the reduced config's reference weights."""
    cfg = jget_config(ARCH).reduced()
    params = jget_model(cfg).init(jax.random.PRNGKey(0))
    eng = J.PagedServingEngine(cfg, params, J.EngineConfig(
        max_slots=4, block_size=16, num_blocks=12, max_blocks_per_slot=3, decode_horizon=8),
        faults=plan)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=24).astype(np.int32) for _ in range(4)]
    eng.serve([J.Request(rid=i, prompt=p, max_new=4) for i, p in enumerate(prompts)])
    return eng


@pytest.mark.parametrize("seed", [0, 3])
def test_chaos_seed_run_matches_reference(seed, capsys):
    engine = tserve.main(CHAOS + ["--chaos-seed", str(seed)])
    printed = capsys.readouterr().out
    want = _reference_plan(seed)
    assert [dataclasses.asdict(s) for s in engine.faults.specs] == \
        [dataclasses.asdict(s) for s in want.specs]
    ctr = engine.metrics.counters()
    line = [ln for ln in printed.splitlines() if ln.startswith("fault plane:")]
    assert line == [f"fault plane: {ctr['fault_injected']} injected {ctr['faults_by_site']}; "
                    f"0 upload retries, 0 degraded serves, {ctr['swap_fallbacks']} swap "
                    f"fallbacks, 0 cancelled, 0 deadline-exceeded, {ctr['poisoned']} poisoned"]
    for rid in range(4):
        assert len(engine.results[rid]) == 4 or isinstance(engine.errors[rid], T.ServingFault)
    ref = _reference_engine(want)
    assert ctr == ref.metrics.counters()
    assert {r: type(e).__name__ for r, e in engine.errors.items()} == \
        {r: type(e).__name__ for r, e in ref.errors.items()}
    if seed == 3:  # its logits fault poisons rid 3 at admission
        assert ctr["fault_injected"] > 0 and "rid 3: PoisonedRequest" in printed


def test_deadline_steps(capsys):
    engine = tserve.main(CHAOS + ["--slots", "2", "--deadline-steps", "1"])
    printed = capsys.readouterr().out
    assert {type(e).__name__ for e in engine.errors.values()} == {"DeadlineExceeded"}
    assert engine.metrics.counters()["deadline_exceeded"] == len(engine.errors) > 0
    assert "typed errors: " in printed and "fault plane:" in printed
    with pytest.raises(SystemExit, match="--deadline-steps must be >= 1"):
        tserve.main(CHAOS + ["--deadline-steps", "0"])


def test_batched_server_matches_reference():
    """Two waves of 4 (the second padded with a dummy), prompts cut and
    left-padded to 32 tokens, ``max_new`` 0 to 6."""
    params_j = jget_model(TINY_DENSE).init(jax.random.PRNGKey(0))
    params_t = interop.params_from_reference(*flatten_reference(params_j), device="cpu")
    rng = np.random.default_rng(9)
    specs = [(40, 5), (7, 3), (32, 6), (19, 0), (12, 4)]
    prompts = [rng.integers(0, TINY_DENSE.vocab_size, size=n).astype(np.int32)
               for n, _ in specs]
    want = jserve.BatchedServer(TINY_DENSE, params_j).serve(
        [jserve.Request(rid=i, prompt=p, max_new=m) for i, (p, (_, m)) in
         enumerate(zip(prompts, specs))])
    server = tserve.BatchedServer(TModelConfig(**dataclasses.asdict(TINY_DENSE)), params_t,
                                  device="cpu")
    got = server.serve([tserve.Request(rid=i, prompt=p, max_new=m) for i, (p, (_, m)) in
                        enumerate(zip(prompts, specs))])
    assert got == want
    assert [len(got[i]) for i in range(5)] == [m for _, m in specs]
    assert set(server.summary()) == {"prefill_mean_s", "decode_mean_s", "decode_p95_s",
                                     "tokens_per_s"}


def test_legacy_cli_serves(capsys):
    server = tserve.main(["--arch", ARCH, "--requests", "5", "--max-new", "3", "--legacy",
                          "--device", "cpu"])
    printed = capsys.readouterr().out
    assert isinstance(server, tserve.BatchedServer)
    assert len(server.stats["prefill_s"]) == 2  # two waves of 4 slots
    assert "served 5 requests on cpu (legacy wave batcher)" in printed
    assert printed.count("request ") == 5


REFUSED = [["--prefix-cache"], ["--kv-bits", "8"], ["--trace-out", "t.json"],
           ["--trace-level", "spans"], ["--chaos-seed", "1"], ["--deadline-steps", "2"],
           ["--policy", "fair"], ["--tenant-weights", "a=1"], ["--ttft-budget-ms", "5"],
           ["--resident-experts", "4"]]


@pytest.mark.parametrize("extra", REFUSED, ids=lambda e: e[0])
def test_legacy_refusals_match_reference(extra, monkeypatch):
    argv = ["--arch", ARCH, "--legacy"] + extra
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with pytest.raises(SystemExit) as ref:
        jserve.main()
    with pytest.raises(SystemExit) as got:
        tserve.main(argv + ["--device", "cpu"])
    assert isinstance(got.value.code, str) and "(drop --legacy)" in got.value.code
    assert got.value.code == ref.value.code


def test_ffn_backend_flag():
    results = {}
    for backend in ("grouped", "ref", "scan"):
        engine = tserve.main(CHAOS + ["--ffn-backend", backend])
        assert engine.ecfg.ffn_backend == backend and len(engine.results) == 4
        results[backend] = engine.results
    assert results["scan"] == results["grouped"]
    with pytest.raises(SystemExit, match="'interpret' is not ported.*Pallas interpreter"):
        tserve.main(CHAOS + ["--ffn-backend", "interpret"])


def _train_output(argv, capsys):
    from repro_torch.launch import train as ttrain

    hist = ttrain.main(argv)
    out = capsys.readouterr().out
    return hist, [re.sub(r"\(\d+ ms\)", "(ms)", line) for line in out.splitlines()]


def test_train_takes_reduced_as_the_reference_does(capsys):
    """``--reduced`` parses, as the reference's ``store_true`` flag with
    default True, and trains the reduced config: the losses and the rest of
    the output equal the run without the flag (the step times aside)."""
    argv = ["--arch", ARCH, "--steps", "2", "--batch", "2", "--seq", "16", "--device", "cpu"]
    with_flag = _train_output(argv + ["--reduced"], capsys)
    without = _train_output(argv, capsys)
    assert len(with_flag[0]) == 2 and with_flag == without
    assert any(line.startswith("{") and "last_loss" in line for line in with_flag[1])
