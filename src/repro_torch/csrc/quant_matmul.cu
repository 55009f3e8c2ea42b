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
// What the design does about it: the weights are read exactly once, as
// packed bytes, and expanded only in shared memory and registers — the
// dequantized matrix never exists in device memory. Each block owns a
// 32-column tile for all rows of a BM row block, so every weight byte
// feeds BM rows; its warps slice each quantization group along K (fixed
// order reduction at the end) so that N / 32 blocks still put eight warps
// per SM in flight. Plain FMA on CUDA cores for now: at M <= 16 the
// tensor cores would idle on the byte stream anyway. wgmma, TMA and a
// persistent schedule are later work.
#include "dequant_gemm.cuh"

extern "C" int repro_quant_matmul(const void* x, const void* w0, const void* w1,
                                  const void* scale, const void* zero, void* y, int M, int K,
                                  int N, int bits, int group, int dtype, void* stream) {
    repro::Operand a{static_cast<const uint8_t*>(w0), static_cast<const uint8_t*>(w1),
                     static_cast<const float*>(scale), static_cast<const float*>(zero)};
    const int bm = M <= 8 ? 8 : 16;
    return (int)repro::dispatch_dequant_gemm<false>(x, a, a, nullptr, nullptr, y, M, K, N, bits,
                                                     group, bm, dtype,
                                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* repro_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
