// quant_matmul: y[M, N] = x[M, K] @ dq(W_packed) for every PackedTensor linear
// (attention q/k/v/o and the shared-expert gate/up/down at 4 bits).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py:99
// quant_matmul_pallas (grid (M/bm, N/bn, K/bk), K innermost, f32 VMEM
// accumulator, unpack + dequant on the VPU before the MXU dot).
//
// What bounds it on the H100: weight bytes. At decode M is the number of
// slots (4) and at prefill the chunk (16), far below the ~295 operations
// per byte where bf16 tensor cores become the limit; one 2048x2048 4-bit
// projection moves 2.1 MB of codes plus 0.26 MB of f32 scale/zero, about
// 0.7 us at 3.35 TB/s, against 34 MFLOP.
//
// Design (bf16, dequant_gemm_sm90.cuh): work items of 8 rows x 16 columns
// over all of K, so N = 2048 gives 128 items and N = 2816 gives 176 — the
// grid fills the 132 SMs at decode. Each item puts its whole K range of
// packed bytes, its scale/zero rows and its x rows in flight at once with
// 16-byte cp.async copies, dequantises through per-(group, column) value
// tables and multiplies on the tensor cores (mma.sync m16n8k16, swap-AB:
// the 16 columns are the MMA's M, the rows its N). The row tile is fixed
// at 8 whatever M is, and K is cut over the block's warps in an order fixed
// by K alone, so a row's output never depends on M. Where an item's whole K
// range outgrows shared memory (4-bit K = 7168 and up), it walks K in the
// fewest even chunks of whole groups that fit (dequant_gemm_sm90.cuh). f32
// activations (the card-vs-CPU parity path) keep IEEE f32 FMAs on CUDA cores
// in the older body (dequant_gemm.cuh), never TF32.
//
// Measured (chip_smoke.py: median of 50 launches, L2 flushed before each;
// NVIDIA H100 80GB HBM3, 700.00 W): M=4, K=N=2048, 4-bit: 0.0102 ms, against
// 0.0664-0.0668 ms for the CUDA-core body it replaces in the same call and
// 0.0111-0.0114 ms for torch.matmul on the pre-dequantized bf16 weight
// (bound 0.00071 ms). M=16, K=2048, N=2816: 0.0173 ms (torch.matmul
// 0.0121 ms). What holds it now: one item per block at decode, so the
// staging round trip, the value tables and the products run one after the
// other with nothing to overlap them; launch/probe_dequant.py splits the time.
#include "dequant_gemm_sm90.cuh"

extern "C" int repro_quant_matmul(const void* x, const void* w0, const void* w1,
                                  const void* scale, const void* zero, void* y, int M, int K,
                                  int N, int bits, int group, int dtype, void* stream) {
    repro::Operand a{static_cast<const uint8_t*>(w0), static_cast<const uint8_t*>(w1),
                     static_cast<const float*>(scale), static_cast<const float*>(zero)};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_BF16)
        return (int)repro::sm90::dispatch<1>(x, a, a, nullptr, nullptr, y, M, K, N, bits, group,
                                             8, s);
    if (dtype != REPRO_DT_F32) return (int)cudaErrorInvalidValue;
    const int bm = M <= 8 ? 8 : 16;  // f32: row grouping only, the arithmetic is per row
    return (int)repro::dispatch_dequant_gemm<false>(x, a, a, nullptr, nullptr, y, M, K, N, bits,
                                                     group, bm, s);
}

// Shared-memory bytes of one block of the bf16 body (rows 8 or 16; one
// operand, or two for SwiGLU), so the host-side plan
// (kernels/quant_matmul.py: tile_plan) can be held to it.
extern "C" long repro_dequant_gemm_sm90_smem(int K, int bits, int group, int rows,
                                             int operands) {
    return repro::sm90::smem_bytes(K, bits, group, rows, operands);
}

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
