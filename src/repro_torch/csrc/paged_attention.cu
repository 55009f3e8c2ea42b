// paged_attention and paged_attention_quant: decode attention of one query
// token per sequence over a paged KV pool — fp pools, or uint8 pools with a
// per-row affine dequant epilogue.
//
//   out[b, h, g] = softmax_pos(q[b, h, g] . k[pos] * dh^-0.5) @ v[pos]
//   valid positions: pos < len[b] and pos > len[b] - 1 - window
//   page j of sequence b lives at physical page block_tables[b, j]
//   int8 pools: k[pos] = (float(code) - k_zero[row]) * k_scale[row] in f32
//               (row = (page, offset, kv head); likewise v)
//
// Replaces the TPU kernels repro/kernels/paged_attention.py:225
// paged_attention_pallas (kernel body :44) and :158
// paged_attention_quant_pallas (body :94): grid (B, Hkv, MB) with the block
// tables scalar-prefetched into the index maps, the page axis walked
// sequentially with an online softmax in VMEM scratch, and (int8) the
// scale/zero rows of each page streamed through the same index maps.
//
// What bounds them on the H100: the KV bytes of the pages they visit — two
// [BS, dh] rows per page per KV head, 2 bytes a value for bf16 pools, 1 byte
// plus 16 bytes of tables per row for int8 pools; ~4 FLOP per byte.
//
// What the design does about it: one thread block per (sequence, KV head)
// walks its sequence's pages itself through block_tables — a loop inside
// the block replaces both the scalar prefetch and the sequential MB grid
// axis — and visits only the pages that hold valid positions (pages before
// the window or past the length are never read). A page loader stages each
// page's K and V rows once in shared memory as f32: the fp loader converts,
// the int8 loader applies the dequant epilogue with exactly the expression
// of dequantize_kv_rows (no contraction: __fsub_rn then __fmul_rn), so
// prefill and decode read a shared page as bit-identical floats. Everything
// after the staging is one body for both: warps reduce the (query head,
// token) dot products with shuffles; the online-softmax state (m, l) of all
// G query heads lives in registers, replicated identically in every thread,
// and thread d owns acc[g][d]. The output is acc / max(l, 1e-30).
//
// A sequence with no valid position (length <= 0 when window >= 1) scores
// every position -1e30, as the reference does, so every position weighs
// exp(0) = 1: the kernel then visits all MB pages and returns the average
// of V over the whole block table, the reference's result.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxG = 8;
constexpr int kMaxDPerThread = 2;  // dh <= 256
constexpr float kNegInf = -1e30f;

// fp pools [NB, BS, Hkv, dh] of the activation type
template <typename T>
struct FpPages {
    const T* k;
    const T* v;
    __device__ __forceinline__ void stage(float* ks, float* vs, int page, int h, int Hkv,
                                          int dh, int BS, int tid) const {
        for (int i = tid; i < BS * dh; i += kThreads) {
            const int t = i / dh, d = i - t * dh;
            const size_t off = (((size_t)page * BS + t) * Hkv + h) * dh + d;
            ks[i] = to_f32(k[off]);
            vs[i] = to_f32(v[off]);
        }
    }
};

// uint8 pools [NB, BS, Hkv, dh] + f32 scale/zero tables [NB, BS, Hkv]
struct QuantPages {
    const uint8_t* k;
    const uint8_t* v;
    const float* k_scale;
    const float* k_zero;
    const float* v_scale;
    const float* v_zero;
    __device__ __forceinline__ void stage(float* ks, float* vs, int page, int h, int Hkv,
                                          int dh, int BS, int tid) const {
        for (int i = tid; i < BS * dh; i += kThreads) {
            const int t = i / dh, d = i - t * dh;
            const size_t row = ((size_t)page * BS + t) * Hkv + h;
            const size_t off = row * dh + d;
            ks[i] = __fmul_rn(__fsub_rn((float)k[off], k_zero[row]), k_scale[row]);
            vs[i] = __fmul_rn(__fsub_rn((float)v[off], v_zero[row]), v_scale[row]);
        }
    }
};

template <typename T, typename Pages>
__global__ void paged_attention_kernel(const T* __restrict__ q, Pages pages,
                                       const int* __restrict__ tables,
                                       const int* __restrict__ lengths, T* __restrict__ out,
                                       int Hkv, int G, int dh, int BS, int MB, int window,
                                       float scale) {
    extern __shared__ float4 smem_f4[];
    float* qs = reinterpret_cast<float*>(smem_f4);  // [G][dh]
    float* ks = qs + G * dh;                         // [BS][dh]
    float* vs = ks + BS * dh;                        // [BS][dh]
    float* ps = vs + BS * dh;                        // [G][BS] scores

    const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5, nwarps = kThreads / 32;
    const size_t qbase = ((size_t)b * Hkv + h) * G * dh;
    for (int i = tid; i < G * dh; i += kThreads) qs[i] = to_f32(q[qbase + i]) * scale;

    float acc[kMaxG][kMaxDPerThread];
    float m_run[kMaxG], l_run[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
        m_run[g] = kNegInf;
        l_run[g] = 0.f;
#pragma unroll
        for (int i = 0; i < kMaxDPerThread; ++i) acc[g][i] = 0.f;
    }

    const int len = lengths[b];
    const int first = max(0, len - window);    // first valid position
    const int last = min(len, MB * BS) - 1;    // last valid position
    const bool none = first > last;            // no valid position: average all
    const int j_lo = none ? 0 : first / BS;
    const int j_hi = none ? MB - 1 : last / BS;
    for (int j = j_lo; j <= j_hi; ++j) {
        const int page = tables[b * MB + j];
        __syncthreads();  // previous page consumed
        pages.stage(ks, vs, page, h, Hkv, dh, BS, tid);
        __syncthreads();
        for (int pi = warp; pi < G * BS; pi += nwarps) {
            const int g = pi / BS, t = pi - g * BS;
            float s = 0.f;
            for (int d = lane; d < dh; d += 32) s = fmaf(qs[g * dh + d], ks[t * dh + d], s);
#pragma unroll
            for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
            if (lane == 0) {
                const int pos = j * BS + t;
                const bool valid = pos < len && pos > len - 1 - window;
                ps[pi] = valid ? s : kNegInf;
            }
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) {
            if (g >= G) break;
            float mx = kNegInf;
            for (int t = 0; t < BS; ++t) mx = fmaxf(mx, ps[g * BS + t]);
            const float m_new = fmaxf(m_run[g], mx);
            const float alpha = expf(m_run[g] - m_new);
            float lsum = 0.f;
#pragma unroll
            for (int i = 0; i < kMaxDPerThread; ++i) acc[g][i] *= alpha;
            for (int t = 0; t < BS; ++t) {
                const float p = expf(ps[g * BS + t] - m_new);
                lsum += p;
#pragma unroll
                for (int i = 0; i < kMaxDPerThread; ++i) {
                    const int d = tid + i * kThreads;
                    if (d < dh) acc[g][i] = fmaf(p, vs[t * dh + d], acc[g][i]);
                }
            }
            l_run[g] = l_run[g] * alpha + lsum;
            m_run[g] = m_new;
        }
    }

#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        const float inv_l = 1.f / fmaxf(l_run[g], 1e-30f);
#pragma unroll
        for (int i = 0; i < kMaxDPerThread; ++i) {
            const int d = tid + i * kThreads;
            if (d < dh) out[qbase + (size_t)g * dh + d] = from_f32<T>(acc[g][i] * inv_l);
        }
    }
}

template <typename T, typename Pages>
cudaError_t launch(const void* q, Pages pages, const int* tables, const int* lengths,
                   void* out, int B, int Hkv, int G, int dh, int BS, int MB, int window,
                   float scale, cudaStream_t stream) {
    const size_t smem = (size_t)(G * dh + 2 * BS * dh + G * BS) * sizeof(float);
    auto kernel = paged_attention_kernel<T, Pages>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(B, Hkv), kThreads, smem, stream>>>(
        static_cast<const T*>(q), pages, tables, lengths, static_cast<T*>(out), Hkv, G, dh, BS,
        MB, window, scale);
    return cudaGetLastError();
}

}  // namespace

extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* tables, const void* lengths, void* out, int B,
                                     int Hkv, int G, int dh, int BS, int MB, int window,
                                     float scale, int dtype, void* stream) {
    if (G > kMaxG || dh > kThreads * kMaxDPerThread) return (int)cudaErrorInvalidValue;
    auto* t = static_cast<const int*>(tables);
    auto* l = static_cast<const int*>(lengths);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_F32) {
        FpPages<float> p{static_cast<const float*>(k_pool), static_cast<const float*>(v_pool)};
        return (int)launch<float>(q, p, t, l, out, B, Hkv, G, dh, BS, MB, window, scale, s);
    }
    if (dtype == REPRO_DT_BF16) {
        FpPages<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(k_pool),
                                 static_cast<const __nv_bfloat16*>(v_pool)};
        return (int)launch<__nv_bfloat16>(q, p, t, l, out, B, Hkv, G, dh, BS, MB, window,
                                          scale, s);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int repro_paged_attention_quant(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* k_zero, const void* v_scale,
                                           const void* v_zero, const void* tables,
                                           const void* lengths, void* out, int B, int Hkv,
                                           int G, int dh, int BS, int MB, int window,
                                           float scale, int dtype, void* stream) {
    if (G > kMaxG || dh > kThreads * kMaxDPerThread) return (int)cudaErrorInvalidValue;
    QuantPages p{static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                 static_cast<const float*>(k_scale),  static_cast<const float*>(k_zero),
                 static_cast<const float*>(v_scale),  static_cast<const float*>(v_zero)};
    auto* t = static_cast<const int*>(tables);
    auto* l = static_cast<const int*>(lengths);
    auto s = static_cast<cudaStream_t>(stream);
    if (dtype == REPRO_DT_F32)
        return (int)launch<float>(q, p, t, l, out, B, Hkv, G, dh, BS, MB, window, scale, s);
    if (dtype == REPRO_DT_BF16)
        return (int)launch<__nv_bfloat16>(q, p, t, l, out, B, Hkv, G, dh, BS, MB, window,
                                          scale, s);
    return (int)cudaErrorInvalidValue;
}
