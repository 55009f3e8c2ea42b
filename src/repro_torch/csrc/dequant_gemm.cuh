// Grouped dequantize-GEMM body on CUDA cores: the f32 activations of
// quant_matmul.cu and moe_gmm.cu (moe_gmm and moe_gmm_swiglu), the parity
// path that keeps IEEE f32 products. Every bf16 call runs
// dequant_gemm_sm90.cuh.
//
//   y[rows of block rb, cols] = x[rows, :] @ dq(W[e]),  e = block_expert[rb]
//   dq(W)[k, n] = (q[k, n] - zero[k / group, n]) * scale[k / group, n]   (f32)
//
// q is unpacked from uint8 along K: code k of a column sits in byte k / per
// at shift (k % per) * bits; 3-bit weights are a (hi: 2-bit, lo: 1-bit)
// plane pair with q = (hi << 1) | lo. K need not hold whole groups: the
// codes are padded to a whole byte (3 bits: to a multiple of 8) and the last
// group covers only K - g * group codes, so the kernel bounds its loop there
// and computes what the reference's padded dequant computes (its padding
// rows meet no x columns).
//
// Tiling (static shapes only, so a row's result never depends on M or its
// neighbours): one thread block per (row block of BM rows, 32-column tile).
// Lane c of every warp owns column n0 + c. K is walked one quantization
// group at a time; the block stages the group's packed bytes, its
// scale/zero row and the x tile in shared memory, and each of the NW warps
// consumes a fixed slice of group / NW codes of every group ("sliced-K":
// the K range is partitioned across the warps of ONE block, never across
// blocks). The NW partial sums are added in warp order after the K loop —
// a fixed-order reduction in shared memory, no atomics, no split-K across
// blocks, f32 accumulation throughout.
//
// Ragged skip: a block whose row block is at or past num_active[0] reads no
// weights and writes zeros (block_expert/num_active stay on the device).
// SWIGLU keeps gate and up accumulators side by side off one staged x tile
// and stores silu(g) * u once, so the [M, N] hidden never reaches memory.
#pragma once

#include "common.cuh"

namespace repro {
// Internal linkage: quant_matmul.cu and moe_gmm.cu each compile their own
// instances, so the two objects link without sharing kernel symbols.
namespace {

// Packed rows of one quantization group for a pow-2 width, or (hi, lo)
// rows for 3 bits.
// rows0/rows1(n): packed rows of n codes (n a whole group, a ragged last
// group or all of K), the codes padded to a whole byte.
template <int BITS> struct Planes {
    static constexpr int kPer = 8 / BITS;
    __host__ __device__ static int rows0(int n) { return (n + kPer - 1) / kPer; }
    __host__ __device__ static int rows1(int) { return 0; }
};
template <> struct Planes<3> {
    __host__ __device__ static int rows0(int n) { return (n + 7) / 8 * 2; }
    __host__ __device__ static int rows1(int n) { return (n + 7) / 8; }
};

// Code kk (0 <= kk < group) of column c from a staged tile laid out
// [rows0 + rows1][32] bytes.
template <int BITS>
__device__ __forceinline__ int tile_code(const uint8_t* t, int kk, int c, int group) {
    if constexpr (BITS == 3) {
        int hi = (t[(kk >> 2) * 32 + c] >> ((kk & 3) * 2)) & 3;
        int lo = (t[(group / 4 + (kk >> 3)) * 32 + c] >> (kk & 7)) & 1;
        return (hi << 1) | lo;
    } else {
        constexpr int per = 8 / BITS;
        return (t[(kk / per) * 32 + c] >> ((kk % per) * BITS)) & ((1 << BITS) - 1);
    }
}

// Stage the packed bytes of group g (kg codes) for columns [n0, n0 + 32) of
// one expert's planes (p0: [rows0(K), N], p1: [rows1(K), N] for 3 bits) into
// a tile laid out [rows0(group) + rows1(group)][32]; rows past the kg codes
// are zero and never read.
template <int BITS>
__device__ __forceinline__ void stage_tile(uint8_t* t, const uint8_t* p0, const uint8_t* p1,
                                           int g, int group, int kg, int N, int n0, int tid,
                                           int nthreads) {
    const int r0 = Planes<BITS>::rows0(group);
    const int r1 = Planes<BITS>::rows1(group);
    const int v0 = Planes<BITS>::rows0(kg), v1 = Planes<BITS>::rows1(kg);
    for (int idx = tid; idx < (r0 + r1) * 32; idx += nthreads) {
        const int r = idx >> 5, c = idx & 31, col = n0 + c;
        uint8_t v = 0;
        if (col < N) {
            if (r < r0) {
                if (r < v0) v = p0[(size_t)(g * r0 + r) * N + col];
            } else if (r - r0 < v1) {
                v = p1[(size_t)(g * r1 + (r - r0)) * N + col];
            }
        }
        t[idx] = v;
    }
}

struct Operand {  // one packed weight stack [E, ...] with its group params
    const uint8_t* p0;
    const uint8_t* p1;
    const float* scale;
    const float* zero;
};

template <int BITS>
__host__ __device__ inline int tile_bytes(int group) {
    return (Planes<BITS>::rows0(group) + Planes<BITS>::rows1(group)) * 32;
}

template <int BITS, int BM, bool SWIGLU>
__host__ inline size_t dequant_gemm_smem(int group, int nwarps) {
    const int nop = SWIGLU ? 2 : 1;
    size_t b = (size_t)BM * group * sizeof(float);          // x tile
    b += (size_t)nop * 2 * 32 * sizeof(float);               // scale, zero rows
    b += (size_t)nwarps * BM * 32 * nop * sizeof(float);     // partial sums
    b += (size_t)nop * tile_bytes<BITS>(group);              // packed tiles
    return b;
}

template <int BITS, int BM, bool SWIGLU>
__global__ void dequant_gemm_kernel(const float* __restrict__ x, Operand a, Operand b,
                                    const int* __restrict__ block_expert,
                                    const int* __restrict__ num_active, float* __restrict__ y,
                                    int M, int K, int N, int group) {
    constexpr int NOP = SWIGLU ? 2 : 1;
    extern __shared__ float4 smem_f4[];
    const int lane = threadIdx.x, wid = threadIdx.y, nw = blockDim.y;
    const int tid = wid * 32 + lane, nthreads = nw * 32;
    const int n0 = blockIdx.x * 32, col = n0 + lane;
    const int rb = blockIdx.y, m0 = rb * BM;

    if (num_active != nullptr && rb >= num_active[0]) {
        for (int m = wid; m < BM; m += nw)
            if (m0 + m < M && col < N) y[(size_t)(m0 + m) * N + col] = 0.f;
        return;
    }
    const int e = block_expert != nullptr ? block_expert[rb] : 0;

    float* xs = reinterpret_cast<float*>(smem_f4);       // [BM][group]
    float* sz = xs + BM * group;                         // [NOP][2][32]
    float* red = sz + NOP * 64;                          // [nw][BM][NOP][32]
    uint8_t* tiles = reinterpret_cast<uint8_t*>(red + nw * BM * NOP * 32);
    const int tbytes = tile_bytes<BITS>(group);

    const int ngroups = (K + group - 1) / group;
    const int r0 = Planes<BITS>::rows0(K);  // plane rows per expert
    const int r1 = Planes<BITS>::rows1(K);
    const Operand ops[2] = {a, b};
    const uint8_t* p0[NOP];
    const uint8_t* p1[NOP];
    const float* sc[NOP];
    const float* ze[NOP];
#pragma unroll
    for (int o = 0; o < NOP; ++o) {
        p0[o] = ops[o].p0 + (size_t)e * r0 * N;
        p1[o] = BITS == 3 ? ops[o].p1 + (size_t)e * r1 * N : nullptr;
        sc[o] = ops[o].scale + (size_t)e * ngroups * N;
        ze[o] = ops[o].zero + (size_t)e * ngroups * N;
    }

    float acc[NOP][BM];
#pragma unroll
    for (int o = 0; o < NOP; ++o)
#pragma unroll
        for (int m = 0; m < BM; ++m) acc[o][m] = 0.f;

    const int slice = group / nw;
    const int k_lo = wid * slice;
    for (int g = 0; g < ngroups; ++g) {
        const int kg = min(group, K - g * group);  // codes in this group
        __syncthreads();  // previous group fully consumed
        for (int idx = tid; idx < BM * group; idx += nthreads) {
            const int m = idx / group, kk = idx - m * group;
            xs[idx] = (m0 + m < M && kk < kg)
                          ? x[(size_t)(m0 + m) * K + g * group + kk] : 0.f;
        }
#pragma unroll
        for (int o = 0; o < NOP; ++o) {
            stage_tile<BITS>(tiles + o * tbytes, p0[o], p1[o], g, group, kg, N, n0, tid,
                             nthreads);
            if (tid < 32) {
                const bool ok = n0 + tid < N;
                sz[o * 64 + tid] = ok ? sc[o][(size_t)g * N + n0 + tid] : 0.f;
                sz[o * 64 + 32 + tid] = ok ? ze[o][(size_t)g * N + n0 + tid] : 0.f;
            }
        }
        __syncthreads();
#pragma unroll
        for (int o = 0; o < NOP; ++o) {
            const float s = sz[o * 64 + lane], z = sz[o * 64 + 32 + lane];
            const uint8_t* t = tiles + o * tbytes;
            for (int kk = k_lo; kk < min(k_lo + slice, kg); ++kk) {
                const float q = (float)tile_code<BITS>(t, kk, lane, group);
                const float w = __fmul_rn(__fsub_rn(q, z), s);
#pragma unroll
                for (int m = 0; m < BM; ++m) acc[o][m] = fmaf(xs[m * group + kk], w, acc[o][m]);
            }
        }
    }

    __syncthreads();
#pragma unroll
    for (int o = 0; o < NOP; ++o)
#pragma unroll
        for (int m = 0; m < BM; ++m) red[((wid * BM + m) * NOP + o) * 32 + lane] = acc[o][m];
    __syncthreads();
    for (int m = wid; m < BM; m += nw) {
        if (m0 + m >= M || col >= N) continue;
        float r[NOP];
#pragma unroll
        for (int o = 0; o < NOP; ++o) {
            float sum = red[(m * NOP + o) * 32 + lane];
            for (int w2 = 1; w2 < nw; ++w2) sum += red[((w2 * BM + m) * NOP + o) * 32 + lane];
            r[o] = sum;
        }
        float out = r[0];
        if constexpr (SWIGLU) out = (r[0] / (1.f + expf(-r[0]))) * r[1];
        y[(size_t)(m0 + m) * N + col] = out;
    }
}

// Warps per block: each takes group / nw codes of every group; the slice
// stays a multiple of 8 so it never splits a packed byte.
inline int dequant_gemm_warps(int group) {
    int nw = group / 16;
    return nw > 8 ? 8 : (nw < 1 ? 1 : nw);
}

template <int BITS, int BM, bool SWIGLU>
cudaError_t launch_dequant_gemm(const void* x, Operand a, Operand b, const int* block_expert,
                                const int* num_active, void* y, int M, int K, int N,
                                int group, cudaStream_t stream) {
    const int nw = dequant_gemm_warps(group);
    const size_t smem = dequant_gemm_smem<BITS, BM, SWIGLU>(group, nw);
    auto kernel = dequant_gemm_kernel<BITS, BM, SWIGLU>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((N + 31) / 32, (M + BM - 1) / BM);
    dim3 block(32, nw);
    kernel<<<grid, block, smem, stream>>>(static_cast<const float*>(x), a, b, block_expert,
                                          num_active, static_cast<float*>(y), M, K, N, group);
    return cudaGetLastError();
}

// Runtime (bits, bm) -> template instance, f32 activations only: bf16 runs
// the tensor-core body (dequant_gemm_sm90.cuh), so it has no instance here.
template <bool SWIGLU>
cudaError_t dispatch_dequant_gemm(const void* x, Operand a, Operand b, const int* block_expert,
                                  const int* num_active, void* y, int M, int K, int N,
                                  int bits, int group, int bm, cudaStream_t stream) {
#define REPRO_CASE(B, BMV)                                                                     \
    if (bits == B && bm == BMV)                                                                \
        return launch_dequant_gemm<B, BMV, SWIGLU>(x, a, b, block_expert, num_active, y, M, K, \
                                                   N, group, stream);
    REPRO_CASE(1, 8) REPRO_CASE(2, 8) REPRO_CASE(3, 8) REPRO_CASE(4, 8)
    REPRO_CASE(1, 16) REPRO_CASE(2, 16) REPRO_CASE(3, 16) REPRO_CASE(4, 16)
#undef REPRO_CASE
    return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace repro
