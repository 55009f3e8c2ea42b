// binary_matmul: the 1-bit matmul of paper Eq. 9,
//
//   y[M, N] = (x[M, K] @ (2 * B~ - 1)) * alpha[1, N]
//
// with B~ packed 8 codes a byte along K (b_packed [ceil(K/8), N] uint8, bit i
// of byte r is row 8r + i, as core/packing.py lays it out) and alpha the f32
// per-column L1 scale, applied after the f32-accumulated sum. The product
// runs in f32 for f32 x and in bf16 for bf16 x (the +-1 weights are exact in
// both, so every product is exact in f32).
//
// Replaces the TPU kernel repro/kernels/binary_matmul.py:48
// binary_matmul_pallas (grid (M/bm, N/bn, K/bk), K innermost with an f32
// VMEM accumulator; the VPU unpacks to +-1 and the MXU runs a normal dot).
//
// What bounds it on the H100: the packed weight bytes (K*N/8) at decode
// shapes; at M = 16, K = 2048, N = 1408 it moves 0.36 MB of bits against
// 92 MFLOP.
//
// What the design does about it: one thread block per (16-row block,
// 32-column tile) walks all of K itself — no split-K across blocks, no
// atomics. K goes in chunks of 256 codes: the block stages the chunk's x
// tile (as f32) and its 32 packed rows of the tile's columns in shared
// memory, and each of the 8 warps takes a fixed 32-code slice of every
// chunk, lane c adding or subtracting x for column n0 + c. The 8 warp
// partials are added in warp order at the end (a fixed-order reduction),
// then multiplied by alpha, so a row's result never depends on M or its
// neighbours.
#include "common.cuh"

namespace {

constexpr int kBM = 16;      // rows per block
constexpr int kWarps = 8;
constexpr int kChunk = 256;  // codes of K per staged chunk
constexpr int kSlice = kChunk / kWarps;

template <typename T>
__global__ void binary_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ b,
                                     const float* __restrict__ alpha, T* __restrict__ y,
                                     int M, int K, int N) {
    __shared__ float xs[kBM][kChunk];
    __shared__ uint8_t bits[kChunk / 8][32];
    __shared__ float red[kWarps][kBM][32];

    const int lane = threadIdx.x, wid = threadIdx.y, tid = wid * 32 + lane;
    const int n0 = blockIdx.x * 32, col = n0 + lane;
    const int m0 = blockIdx.y * kBM;

    float acc[kBM];
#pragma unroll
    for (int m = 0; m < kBM; ++m) acc[m] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kChunk) {
        const int kc = min(kChunk, K - k0);
        __syncthreads();  // previous chunk consumed
        for (int idx = tid; idx < kBM * kChunk; idx += kWarps * 32) {
            const int m = idx / kChunk, kk = idx - m * kChunk;
            xs[m][kk] = (m0 + m < M && kk < kc) ? to_f32(x[(size_t)(m0 + m) * K + k0 + kk])
                                                : 0.f;
        }
        for (int idx = tid; idx < (kChunk / 8) * 32; idx += kWarps * 32) {
            const int r = idx >> 5, c = idx & 31;
            const bool ok = r * 8 < kc && n0 + c < N;
            bits[r][c] = ok ? b[(size_t)(k0 / 8 + r) * N + n0 + c] : 0;
        }
        __syncthreads();
        const int k_lo = wid * kSlice, k_hi = min(k_lo + kSlice, kc);
        for (int kk = k_lo; kk < k_hi; ++kk) {
            const float w = ((bits[kk >> 3][lane] >> (kk & 7)) & 1) ? 1.f : -1.f;
#pragma unroll
            for (int m = 0; m < kBM; ++m) acc[m] = fmaf(xs[m][kk], w, acc[m]);
        }
    }

    __syncthreads();
#pragma unroll
    for (int m = 0; m < kBM; ++m) red[wid][m][lane] = acc[m];
    __syncthreads();
    if (col >= N) return;
    const float a = alpha[col];
    for (int m = wid; m < kBM; m += kWarps) {
        if (m0 + m >= M) continue;
        float sum = red[0][m][lane];
        for (int w2 = 1; w2 < kWarps; ++w2) sum += red[w2][m][lane];
        y[(size_t)(m0 + m) * N + col] = from_f32<T>(sum * a);
    }
}

template <typename T>
cudaError_t launch(const void* x, const uint8_t* b, const float* alpha, void* y, int M, int K,
                   int N, cudaStream_t stream) {
    dim3 grid((N + 31) / 32, (M + kBM - 1) / kBM);
    binary_matmul_kernel<T><<<grid, dim3(32, kWarps), 0, stream>>>(
        static_cast<const T*>(x), b, alpha, static_cast<T*>(y), M, K, N);
    return cudaGetLastError();
}

}  // namespace

extern "C" int repro_binary_matmul(const void* x, const void* b_packed, const void* alpha,
                                   void* y, int M, int K, int N, int dtype, void* stream) {
    auto* b = static_cast<const uint8_t*>(b_packed);
    auto* a = static_cast<const float*>(alpha);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_F32) return (int)launch<float>(x, b, a, y, M, K, N, s);
    if (dtype == REPRO_DT_BF16) return (int)launch<__nv_bfloat16>(x, b, a, y, M, K, N, s);
    return (int)cudaErrorInvalidValue;
}
