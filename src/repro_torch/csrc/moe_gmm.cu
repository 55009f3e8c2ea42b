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
// at most 24 routed rows.
//
// What the design does about it: one thread block per (row block, 32-column
// tile) reads block_expert[i] and num_active[0] from device memory itself
// (the host never syncs on them); a dead block writes zeros and reads no
// weights, so only the experts with routed tokens are streamed. Live blocks
// run the shared dequant-GEMM body (dequant_gemm.cuh): packed bytes staged
// once per quantization group in shared memory, dequantized in registers,
// f32 accumulation, sliced-K across the block's warps with a fixed-order
// reduction. The SwiGLU variant feeds two accumulators from one staged x
// tile and applies silu(g) * u before its single store. bm is 8 or 16 (the
// row block of gmm_block_rows), bits 1/2/3/4, and any K (K = 1408 = 11
// groups for the down projection; a ragged last group is bounded).
#include "dequant_gemm.cuh"

extern "C" int repro_moe_gmm(const void* x, const void* w0, const void* w1, const void* scale,
                             const void* zero, const void* block_expert,
                             const void* num_active, void* y, int M, int K, int N, int bits,
                             int group, int bm, int dtype, void* stream) {
    repro::Operand a{static_cast<const uint8_t*>(w0), static_cast<const uint8_t*>(w1),
                     static_cast<const float*>(scale), static_cast<const float*>(zero)};
    return (int)repro::dispatch_dequant_gemm<false>(
        x, a, a, static_cast<const int*>(block_expert), static_cast<const int*>(num_active), y,
        M, K, N, bits, group, bm, dtype, static_cast<cudaStream_t>(stream));
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
    return (int)repro::dispatch_dequant_gemm<true>(
        x, g, u, static_cast<const int*>(block_expert), static_cast<const int*>(num_active), y,
        M, K, N, bits, group, bm, dtype, static_cast<cudaStream_t>(stream));
}
