"""The port's expert ranking (``repro_torch.models.moe._rank_within_expert``)
against the JAX reference's (``repro.models.moe._rank_within_expert``) on
the CPU, byte for byte: the same numpy-seeded expert ids, drop-bucket ids
(``e``) among them, through the one-shot one-hot and through the chunked
scan that large problems take (more than 2**26 one-hot elements).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

from _torch_interop import torch_one_thread  # noqa: E402,F401


def _eids(seed, n, e, hot):
    """``n`` ids over a few hot experts, the last expert and the drop id."""
    rng = np.random.default_rng(seed)
    pool = np.array(list(range(hot)) + [e - 1, e], dtype=np.int32)
    return pool[rng.integers(0, len(pool), size=n)]


def _both(eids, e, **kw):
    want = np.asarray(jmoe._rank_within_expert(jnp.asarray(eids), e))
    got = tmoe._rank_within_expert(torch.from_numpy(eids).long(), e, **kw)
    assert got.dtype == torch.int64
    return got.numpy(), want


@pytest.mark.parametrize("n,e", [(1, 4), (64, 5), (300, 8), (4096, 64)])
def test_rank_one_shot_matches_reference(n, e):
    got, want = _both(_eids(n, n, e, hot=3), e)
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n,e,limit", [(100, 8, 2**8), (257, 5, 2**8), (64, 8, 64),
                                       (9, 3, 2)])
def test_rank_chunked_matches_reference(n, e, limit):
    """The port's chunked scan at a lowered one-hot limit (chunks of 32, 48,
    8 and 1 rows, the last chunk padded with the drop id) against the
    reference's one-shot ranks."""
    assert n * e > limit
    got, want = _both(_eids(n + e, n, e, hot=2), e, max_onehot=limit)
    assert np.array_equal(got, want.astype(np.int64))


def test_rank_chunked_at_the_reference_limit():
    """Both sides take the chunked path at the real 2**26 limit: 2**23 + 1
    experts make chunks of one row (9 × (2**23 + 1) one-hot elements)."""
    e, n = 2**23 + 1, 9
    assert n * e > 2**26 and max(1, 2**26 // e // 8 * 8) == 1
    got, want = _both(_eids(7, n, e, hot=2), e)
    assert np.array_equal(got, want.astype(np.int64))
    assert got.max() >= 2  # some expert really ranks across chunks
