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
// Replaces the TPU kernel repro/kernels/binary_matmul.py:49
// binary_matmul_pallas (grid (M/bm, N/bn, K/bk), K innermost with an f32
// VMEM accumulator; the VPU unpacks to +-1 and the MXU runs a normal dot).
//
// What bounds it on the H100: not its bytes. At M = 16, K = 2048, N = 1408
// it moves 0.36 MB of bits (0.00014 ms at 3.35 TB/s) against 92 MFLOP, so
// what it costs is latency: how many blocks run at once, and how many round
// trips to memory each makes before its products.
//
// bf16 (its own kernel, built from the bf16 dequant body's cp_async16 and
// mma_16816 helpers, dequant_gemm_sm90.cuh): one block per work item of 8
// rows x a 16-column tile over all of K (88 column tiles x 2 row blocks =
// 176 blocks at M = 16, all resident at once on the 132 SMs). Each block puts
// the tile's ceil(K/8) packed rows (16 bytes each: 4 KB at K = 2048) and its
// 8 rows of x in flight at once with 16-byte cp.async copies — one round
// trip. A fragments are built in registers straight from the bits as +-1
// bf16 pairs (0x3F80 / 0xBF80: no tables, no scale/zero), half a byte per
// lane and k16 step, with the code-to-lane mapping of the dequant body's
// 1-bit fragments; bf16 mma.sync m16n8k16 in swap-AB form (the 16 columns
// are the MMA's M, the 8 rows its N) with f32 accumulation; K cut over the
// 8 warps in contiguous slices fixed by K; the warps' partial tiles added
// in warp order in shared memory; then alpha per column on the f32 sum, as
// the reference orders it. A ragged K (codes padded to a whole byte and to
// the k16 step) meets x zeroed past K; N off the 16-column tile stages and
// stores with scalar, bounds-checked accesses. Tiles depend on K and N
// only, so a row's output is bit-identical whatever M is. Measured at
// M = 16 (chip_smoke.py, median of 50 L2-flushed launches; NVIDIA H100
// 80GB HBM3, 700.00 W): 0.0090-0.0091 ms, against 0.0709-0.0712 ms for the
// CUDA-core kernel it replaces and 0.0108 ms for torch.matmul over the
// pre-expanded +-alpha weight in the same call; about 0.005 ms of it is the
// timing method's own floor.
//
// f32: the older CUDA-core kernel (tensor-core TF32 would round x): one
// thread block per (16-row block, 32-column tile) walks all of K in chunks
// of 256 codes, stages x (f32) and the chunk's packed rows in shared memory,
// each of the 8 warps takes a fixed 32-code slice of every chunk, lane c
// adding or subtracting x for column n0 + c; the warp partials are added in
// warp order, then multiplied by alpha.
#include "dequant_gemm_sm90.cuh"

namespace {

// ------------------------------------------------ bf16: tensor cores
namespace tc {

constexpr int kCols = 16, kRows = 8, kWarps = 8, kThreads = kWarps * 32;

// Byte offsets of one block's dynamic shared memory (16-byte aligned regions).
// Mirrored by kernels/binary_matmul.py: binary_plan.
struct Layout {
    int kx;      // K rounded up to the k16 step
    int brows;   // staged packed rows (kx / 8)
    int xs;      // x row stride in bf16, padded so the 8 rows' 8-byte loads hit distinct banks
    size_t x_off, red_off, total;
};

__host__ __device__ inline Layout layout(int K) {
    Layout L;
    L.kx = (K + 15) / 16 * 16;
    L.brows = L.kx / 8;
    L.xs = L.kx + 2 * ((8 - (L.kx / 2) % 32 + 32) % 32);
    L.x_off = (size_t)L.brows * kCols;
    L.red_off = L.x_off + (size_t)kRows * L.xs * sizeof(__nv_bfloat16);
    L.total = L.red_off + (size_t)kWarps * kRows * kCols * sizeof(float);
    return L;
}

// Two codes (bit 0 the lower k) as a bf16x2 of +-1: bit set +1 (0x3F80),
// clear -1 (0xBF80, the same with the sign bit).
__device__ __forceinline__ uint32_t pm1_pair(uint32_t p) {
    return 0x3F803F80u | ((~p & 1u) << 15) | ((~p & 2u) << 30);
}

__global__ void __launch_bounds__(kThreads)
binary_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ b,
                        const float* __restrict__ alpha, __nv_bfloat16* __restrict__ y, int M,
                        int K, int N) {
    using repro::sm90::cp_async16;
    extern __shared__ __align__(16) uint8_t smem[];
    const Layout L = layout(K);
    uint8_t* bs = smem;                                                     // [brows][16]
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.x_off);  // [8][xs]
    float* red = reinterpret_cast<float*>(smem + L.red_off);               // [warps][8][16]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int n0 = blockIdx.x * kCols, m0 = blockIdx.y * kRows;
    const int R = (K + 7) / 8;  // packed rows in memory
    const bool vec_b = (N % kCols) == 0 && (reinterpret_cast<uintptr_t>(b) & 15) == 0;
    const bool vec_x = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;

    for (int r = tid; r < L.brows; r += kThreads) {  // the tile's packed rows, zero past R
        uint8_t* dst = bs + r * kCols;
        const uint8_t* src = b + (size_t)r * N + n0;
        if (vec_b && r < R) {
            cp_async16(dst, src);
        } else if (vec_b) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        } else {
            for (int c = 0; c < kCols; ++c) dst[c] = (r < R && n0 + c < N) ? src[c] : 0;
        }
    }
    const int chunks = L.kx / 8;  // 16-byte chunks of one x row, zero past M and past K
    for (int i = tid; i < kRows * chunks; i += kThreads) {
        const int r = i / chunks, k = (i % chunks) * 8;
        __nv_bfloat16* dst = xs + r * L.xs + k;
        const bool row_ok = m0 + r < M;
        const __nv_bfloat16* src = x + (size_t)(m0 + r) * K + k;
        if (vec_x && row_ok && k < K) {
            cp_async16(dst, src);
        } else if (vec_x) {
            *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        } else {
            for (int j = 0; j < 8; ++j)
                dst[j] = row_ok && k + j < K ? src[j] : __float2bfloat16_rn(0.f);
        }
    }
    repro::sm90::cp_async_commit();
    repro::sm90::cp_async_wait<0>();
    __syncthreads();

    // this warp's K slice: lane t's codes kb+4t..kb+4t+3 of columns c0, c0+1
    // are half of byte kb/8 + t/2 in each column
    const int S = L.kx / 16, spw = (S + kWarps - 1) / kWarps;
    const int s_lo = warp * spw, s_hi = min(S, s_lo + spw);
    const int t = lane & 3, gq = lane >> 2, c0 = 2 * gq, sh = 4 * (t & 1);
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int s = s_lo; s < s_hi; ++s) {
        const int kb = s * 16;
        const uint32_t two =
            *reinterpret_cast<const uint16_t*>(bs + ((kb >> 3) + (t >> 1)) * kCols + c0);
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t codes = two >> (8 * h + sh);
            a[h] = pm1_pair(codes & 3);
            a[2 + h] = pm1_pair((codes >> 2) & 3);
        }
        const uint2 bx = *reinterpret_cast<const uint2*>(xs + gq * L.xs + kb + 4 * t);
        repro::sm90::mma_16816(acc, a, bx.x, bx.y);
    }

    // fixed-order reduction of the warps' partial tiles, then alpha and the store
    float* rw = red + warp * kRows * kCols;
    const int r = 2 * t;  // MMA rows gq | gq + 8 are columns c0 | c0 + 1
    *reinterpret_cast<float2*>(rw + r * kCols + c0) = make_float2(acc[0], acc[2]);
    *reinterpret_cast<float2*>(rw + (r + 1) * kCols + c0) = make_float2(acc[1], acc[3]);
    __syncthreads();
    if (tid < kRows * kCols) {
        const int m = m0 + tid / kCols, n = n0 + tid % kCols;
        if (m < M && n < N) {
            float v = red[tid];
            for (int w = 1; w < kWarps; ++w) v += red[w * kRows * kCols + tid];
            y[(size_t)m * N + n] = __float2bfloat16_rn(v * alpha[n]);
        }
    }
}

cudaError_t launch(const void* x, const uint8_t* b, const float* alpha, void* y, int M, int K,
                   int N, cudaStream_t stream) {
    const Layout L = layout(K);
    static bool opted = false;  // opt in to the card's whole shared memory once
    if (!opted) {
        int dev = 0, optin = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err == cudaSuccess) err = allow_smem(binary_matmul_tc_kernel, (size_t)optin);
        if (err != cudaSuccess) return err;
        opted = true;
    }
    dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
    binary_matmul_tc_kernel<<<grid, kThreads, L.total, stream>>>(
        static_cast<const __nv_bfloat16*>(x), b, alpha, static_cast<__nv_bfloat16*>(y), M, K, N);
    return cudaGetLastError();
}

}  // namespace tc

// ------------------------------------------------ f32: CUDA cores
namespace f32 {

constexpr int kBM = 16;      // rows per block
constexpr int kWarps = 8;
constexpr int kChunk = 256;  // codes of K per staged chunk
constexpr int kSlice = kChunk / kWarps;

__global__ void binary_matmul_f32_kernel(const float* __restrict__ x,
                                         const uint8_t* __restrict__ b,
                                         const float* __restrict__ alpha, float* __restrict__ y,
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
            xs[m][kk] = (m0 + m < M && kk < kc) ? x[(size_t)(m0 + m) * K + k0 + kk] : 0.f;
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
        y[(size_t)(m0 + m) * N + col] = sum * a;
    }
}

cudaError_t launch(const void* x, const uint8_t* b, const float* alpha, void* y, int M, int K,
                   int N, cudaStream_t stream) {
    dim3 grid((N + 31) / 32, (M + kBM - 1) / kBM);
    binary_matmul_f32_kernel<<<grid, dim3(32, kWarps), 0, stream>>>(
        static_cast<const float*>(x), b, alpha, static_cast<float*>(y), M, K, N);
    return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" int repro_binary_matmul(const void* x, const void* b_packed, const void* alpha,
                                   void* y, int M, int K, int N, int dtype, void* stream) {
    auto* b = static_cast<const uint8_t*>(b_packed);
    auto* a = static_cast<const float*>(alpha);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_F32) return (int)f32::launch(x, b, a, y, M, K, N, s);
    if (dtype == REPRO_DT_BF16) return (int)tc::launch(x, b, a, y, M, K, N, s);
    return (int)cudaErrorInvalidValue;
}

// Shared-memory bytes of one block of the bf16 kernel, for the host-side
// plan (kernels/binary_matmul.py: binary_plan) to check against.
extern "C" long repro_binary_matmul_smem(int K) { return (long)tc::layout(K).total; }
