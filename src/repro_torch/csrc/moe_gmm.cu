// moe_gmm and moe_gmm_swiglu: the grouped, ragged dequantize-GEMMs of one
// PMQ bit bucket's expert FFN.
//
//   moe_gmm:        y[rows of block i] = x @ dq(W[block_expert[i]])
//   moe_gmm_swiglu: y[rows of block i] = silu(x @ dq(Wg[e])) * (x @ dq(Wu[e]))
//
// Replace the TPU kernels repro/kernels/moe_gmm.py:93 moe_gmm_pallas and
// :191 moe_gmm_swiglu_pallas (scalar-prefetched block_expert/num_active,
// grid (Mp/bm, N/bn, K/bk), blocks at or past num_active skip all work).
//
// What bounds them on the H100: the packed bytes of the experts that live
// row blocks touch, plus their f32 scale/zero rows. Drop-free serving
// capacity (capacity factor = number of experts) leaves almost every row
// block dead: at decode with 4 slots, 64 experts x 24 rows of capacity hold
// at most 24 routed rows. At the main path's 2-bit decode shape (20 live
// blocks of 177, K = 1408 -> N = 2048) that is ~18 MB, ~7 us at 3.35 TB/s.
//
// bf16, both kernels (dequant_gemm_sm90.cuh): a persistent grid of as
// many blocks as fit on the SMs at once reads num_active[0] and
// block_expert on the device (the host never syncs on them), splits the
// live (row block x 16-column tile) items evenly, and zero-fills the dead
// rows with 16-byte stores — dead row blocks cost no block launch and read
// no weights. Each item stages its expert's whole K range of packed bytes
// and scale/zero rows (gate and up for SwiGLU) and, once per row block, its
// bm rows of x with 16-byte cp.async copies (where that outgrows shared
// memory, the fewest even K chunks of whole groups, each with its x
// slice), dequantises through per-(group, column) value tables and runs
// bf16 mma.sync m16n8k16
// (swap-AB; bm 16 takes two n8 tiles; SwiGLU feeds its gate and up A
// fragments from the same x B fragments), f32 accumulation, K cut over the
// warps in an order fixed by K. SwiGLU adds the warps' gate, then up
// partials in warp order and applies silu(g) * u in f32 before its single
// store, so the [M, N] gate and up products never reach device memory.
//
// f32 (the parity path) keeps the older body (dequant_gemm.cuh): one block
// per (row block, 32-column tile) reading block_expert/num_active itself,
// packed bytes staged one group at a time, IEEE f32 FMAs on CUDA cores
// (tensor-core TF32 would round x), sliced-K across the warps with a
// fixed-order reduction; its SwiGLU variant feeds two accumulators from one
// staged x tile and applies the same silu(g) * u before its store.
//
// Measured at the 2-bit decode shape, bf16 (chip_smoke.py: median of 50
// launches, L2 flushed before each; NVIDIA H100 80GB HBM3, 700.00 W):
// moe_gmm 0.0382-0.0383 ms (bound 0.00713 ms; torch.bmm over the live
// blocks' pre-dequantized experts 0.0531-0.0533 ms); moe_gmm_swiglu
// 0.0618-0.0621 ms against 0.3144-0.3160 ms for the CUDA-core body in the
// same call (bound 0.01198 ms; one torch.bmm of the gate and up products
// alone 0.0910-0.0914 ms). What holds SwiGLU now is on-chip work per item
// (tables, barriers, lookup-then-MMA steps): with the weights warm in L2 it
// still takes 0.050 ms (launch/probe_dequant.py).
#include "dequant_gemm_sm90.cuh"

extern "C" int repro_moe_gmm(const void* x, const void* w0, const void* w1, const void* scale,
                             const void* zero, const void* block_expert,
                             const void* num_active, void* y, int M, int K, int N, int bits,
                             int group, int bm, int dtype, void* stream) {
    repro::Operand a{static_cast<const uint8_t*>(w0), static_cast<const uint8_t*>(w1),
                     static_cast<const float*>(scale), static_cast<const float*>(zero)};
    const int* be = static_cast<const int*>(block_expert);
    const int* na = static_cast<const int*>(num_active);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_BF16)
        return (int)repro::sm90::dispatch<1>(x, a, a, be, na, y, M, K, N, bits, group, bm, s);
    if (dtype == REPRO_DT_F32)
        return (int)repro::dispatch_dequant_gemm<false>(x, a, a, be, na, y, M, K, N, bits, group,
                                                         bm, s);
    return (int)cudaErrorInvalidValue;
}

extern "C" int repro_moe_gmm_swiglu(const void* x, const void* g0, const void* g1,
                                    const void* g_scale, const void* g_zero, const void* u0,
                                    const void* u1, const void* u_scale, const void* u_zero,
                                    const void* block_expert, const void* num_active, void* y,
                                    int M, int K, int N, int bits, int group, int bm, int dtype,
                                    void* stream) {
    repro::Operand g{static_cast<const uint8_t*>(g0), static_cast<const uint8_t*>(g1),
                     static_cast<const float*>(g_scale), static_cast<const float*>(g_zero)};
    repro::Operand u{static_cast<const uint8_t*>(u0), static_cast<const uint8_t*>(u1),
                     static_cast<const float*>(u_scale), static_cast<const float*>(u_zero)};
    const int* be = static_cast<const int*>(block_expert);
    const int* na = static_cast<const int*>(num_active);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_BF16)
        return (int)repro::sm90::dispatch<2>(x, g, u, be, na, y, M, K, N, bits, group, bm, s);
    if (dtype == REPRO_DT_F32)
        return (int)repro::dispatch_dequant_gemm<true>(x, g, u, be, na, y, M, K, N, bits, group,
                                                        bm, s);
    return (int)cudaErrorInvalidValue;
}
