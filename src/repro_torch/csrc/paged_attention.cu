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
// tables scalar-prefetched into the index maps, the page axis walked in
// order with an online softmax in VMEM scratch, and (int8) the scale/zero
// rows of each page streamed through the same index maps.
//
// Bound on the H100: the KV bytes of the pages a sequence must visit — two
// [BS, dh] rows per page and KV head, 2 bytes a value for bf16 pools, 1 byte
// plus 16 bytes of tables per row for int8 pools; ~4 FLOP per byte, far
// below the card's ridge, so only the bytes in flight and the SMs issuing
// them matter.
//
// What held the first body back: one block per (sequence, KV head) — 64
// blocks at the decode shape, most SMs idle — walked its pages one after
// another; each page paid a DRAM round trip of scalar 1-2 byte loads with
// nothing in flight behind it, two barriers, and every thread recomputed the
// page's max and exps on its own.
//
// This body:
// - Fixed page chunks across blocks. The grid is (chunks, Hkv, B); chunk c
//   covers the kChunkPages pages [c·kChunkPages, (c+1)·kChunkPages) of the
//   block table whatever MB is, and chunks = ceil(MB / kChunkPages) comes
//   from MB, never from the lengths (no host sync). A block whose chunk holds
//   no page to visit writes an empty partial (m = -1e30, l = 0, acc = 0).
//   With one chunk the block writes the output; with more, each writes its
//   (acc, m, l) partial and paged_attention_merge_kernel merges them in
//   chunk order.
// - Pages in parallel inside a block. Warp w owns the chunk's pages w,
//   w + kWarps, ... It keeps q for its G heads in registers, keeps as many of
//   its pages in flight as its share of the ring holds (16-byte cp.async
//   into shared memory; page i + stages is issued as page i is consumed),
//   and runs its own online softmax: lanes_per_row lanes share a row
//   (elements e0..e0+EPL of it), so a warp takes 32 / lanes_per_row rows
//   per step and kBatch steps
//   at once (a whole 16-row page for G = 1): the batch's dot products are
//   reduced by shuffles within each row's lanes, its max by shuffles across
//   rows, all independent of one another, and the running max and the
//   rescale of l and acc happen once per batch. m is the same in every
//   lane; l and acc are per row group, summed across the groups at the
//   end. The warps' states merge in shared memory in warp order.
// - The int8 loader copies 16 codes per 16-byte cp.async and each row's
//   four table entries once; a code becomes a float by a byte permute
//   (exact, cheaper than the integer conversion), and the dequant is exactly
//   dequantize_kv_rows' expression (no contraction: __fsub_rn then
//   __fmul_rn), so prefill and decode read a shared page as bit-identical
//   floats.
// A merge skips empty states and scales the others by expf(m - m_max), so
// a state that holds the maximum enters as acc·1.0 and l·1.0 exactly: a
// sequence's output depends only on its q, its own pages' contents, its
// length and the window — not on B, MB, the other sequences or which
// physical pages it holds — bit for bit. No atomics; partitions and merge
// orders come from static shapes.
//
// A sequence with no valid position (length <= 0 when window >= 1) scores
// every position -1e30, as the reference does, so every position weighs
// exp(0) = 1: the kernel then visits all MB pages and returns the average
// of V over the whole block table, the reference's result.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kPagesPerWarp = 4;
constexpr int kChunkPages = kWarps * kPagesPerWarp;
constexpr int kThreads = kWarps * 32;
// A block's page ring: 64 KB, 32 KB for uint8 pools. An int8 page costs
// more work per byte (the dequant), so its warps do better with one page in
// flight each and more blocks resident than with three pages and fewer
// blocks (launch/probe_attention.py timings at 4096 positions).
constexpr size_t kRingBytes = 64 * 1024;
constexpr int kMaxG = 8;
constexpr int kMaxHeadDim = 256;
constexpr size_t kSmemOptin = 232448;  // a block's shared memory on the H100
constexpr float kNegInf = -1e30f;
static_assert(kPagesPerWarp <= 4, "the ring waits with cp.async.wait_group 0-3");

// pool codes (kernels/paged_attention.py POOL_CODES)
constexpr int kPoolF32 = 0, kPoolBF16 = 1, kPoolU8 = 2;

// The host-side plan (kernels/paged_attention.py: attention_plan).
struct Plan {
    int epl;          // elements of a row per lane
    int stage_bytes;  // one page of K and V (and int8 tables) in shared memory
    int stages;       // pages of a warp in flight at once
    size_t smem;      // per block
};

Plan make_plan(int bs, int dh, int g, int pool) {
    const int elem = pool == kPoolF32 ? 4 : pool == kPoolBF16 ? 2 : 1;
    Plan p;
    p.epl = (pool == kPoolF32 && dh <= 128) ? 4 : 8;
    p.stage_bytes = 2 * bs * dh * elem + (pool == kPoolU8 ? 16 * bs : 0);
    const size_t ring_bytes = pool == kPoolU8 ? kRingBytes / 2 : kRingBytes;
    p.stages = 1;  // as many of a warp's pages in flight as the ring holds
    while (p.stages < kPagesPerWarp &&
           (size_t)kWarps * (p.stages + 1) * p.stage_bytes <= ring_bytes)
        ++p.stages;
    const size_t ring = (size_t)kWarps * p.stages * p.stage_bytes;
    const size_t merge = (size_t)kWarps * g * (dh + 2) * sizeof(float);
    p.smem = ring > merge ? ring : merge;
    return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy the [BS, dh] rows of KV head h of one page into a stage, 16 bytes a
// lane at a time: K rows, then V rows.
template <typename P>
__device__ __forceinline__ void issue_rows(unsigned char* stage, const P* k, const P* v,
                                           int page, int h, int Hkv, int dh, int BS,
                                           int lane) {
    const int row_bytes = dh * (int)sizeof(P);
    const int pieces = row_bytes / 16;  // per row
    const size_t half = (size_t)BS * row_bytes;
    const size_t row_stride = (size_t)Hkv * row_bytes;  // between a page's rows of head h
    const unsigned char* kb =
        reinterpret_cast<const unsigned char*>(k) + ((size_t)page * BS * Hkv + h) * row_bytes;
    const unsigned char* vb =
        reinterpret_cast<const unsigned char*>(v) + ((size_t)page * BS * Hkv + h) * row_bytes;
    // piece i = lane + 32·n is (row t, piece u) of the page; step (t, u) by 32
    const int dt = 32 / pieces, du = 32 - dt * pieces;
    int t = lane / pieces, u = lane - t * pieces;
    for (int i = lane; i < BS * pieces; i += 32) {
        const size_t off = t * row_stride + (size_t)u * 16;
        cp_async16(stage + (size_t)i * 16, kb + off);
        cp_async16(stage + half + (size_t)i * 16, vb + off);
        t += dt;
        u += du;
        if (u >= pieces) {
            u -= pieces;
            ++t;
        }
    }
}

// fp pools [NB, BS, Hkv, dh] of the activation type
template <typename P>
struct FpPages {
    const P* k;
    const P* v;
    __device__ __forceinline__ void issue(unsigned char* stage, int page, int h, int Hkv,
                                          int dh, int BS, int lane) const {
        issue_rows(stage, k, v, page, h, Hkv, dh, BS, lane);
    }
    // EPL elements e0.. of row t of K (which = 0) or V (which = 1) as f32;
    // zero past dh
    template <int EPL>
    __device__ __forceinline__ void row(const unsigned char* stage, int which, int t, int e0,
                                        int dh, int BS, float* out) const {
        static_assert(EPL * sizeof(P) % 16 == 0, "a lane reads whole 16-byte pieces");
        const P* base = reinterpret_cast<const P*>(stage) + ((size_t)which * BS + t) * dh + e0;
        constexpr int kPer = 16 / (int)sizeof(P);  // elements per 16 bytes
#pragma unroll
        for (int u = 0; u < EPL / kPer; ++u) {
            if (e0 + u * kPer < dh) {
                const uint4 w = *reinterpret_cast<const uint4*>(base + u * kPer);
                const P* e = reinterpret_cast<const P*>(&w);
#pragma unroll
                for (int i = 0; i < kPer; ++i) out[u * kPer + i] = to_f32(e[i]);
            } else {
#pragma unroll
                for (int i = 0; i < kPer; ++i) out[u * kPer + i] = 0.f;
            }
        }
    }
};

// uint8 pools [NB, BS, Hkv, dh] + f32 scale/zero tables [NB, BS, Hkv]; a
// stage holds K codes, V codes, then k_scale, k_zero, v_scale, v_zero [BS]
struct QuantPages {
    const uint8_t* k;
    const uint8_t* v;
    const float* k_scale;
    const float* k_zero;
    const float* v_scale;
    const float* v_zero;
    __device__ __forceinline__ void issue(unsigned char* stage, int page, int h, int Hkv,
                                          int dh, int BS, int lane) const {
        issue_rows(stage, k, v, page, h, Hkv, dh, BS, lane);
        float* tabs = reinterpret_cast<float*>(stage + (size_t)2 * BS * dh);
        const size_t first = (size_t)page * BS * Hkv + h;  // row 0 of the page, head h
        for (int i = lane; i < 4 * BS; i += 32) {
            const int which = i / BS, t = i - which * BS;
            const float* src = which == 0 ? k_scale : which == 1 ? k_zero
                             : which == 2 ? v_scale : v_zero;
            cp_async4(tabs + i, src + first + (size_t)t * Hkv);
        }
    }
    template <int EPL>
    __device__ __forceinline__ void row(const unsigned char* stage, int which, int t, int e0,
                                        int dh, int BS, float* out) const {
        static_assert(EPL == 8, "int8 rows are read 8 codes a lane");
        const float* tabs = reinterpret_cast<const float*>(stage + (size_t)2 * BS * dh);
        const float s = tabs[(2 * which) * BS + t], z = tabs[(2 * which + 1) * BS + t];
        if (e0 < dh) {
            const uint2 w = *reinterpret_cast<const uint2*>(
                stage + ((size_t)which * BS + t) * dh + e0);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                // float(code) exactly, without the slow integer conversion:
                // the bits 0x4B0000cc are 2^23 + code, minus 2^23 exactly
                const unsigned bits = __byte_perm(i < 4 ? w.x : w.y, 0x4B000000u,
                                                  0x7650u + (i & 3));
                const float code = __fsub_rn(__uint_as_float(bits), 8388608.f);
                out[i] = __fmul_rn(__fsub_rn(code, z), s);
            }
        } else {
#pragma unroll
            for (int i = 0; i < 8; ++i) out[i] = 0.f;
        }
    }
};

template <typename T, typename Pages, int EPL, int MAXG>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, Pages pages, const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       float* __restrict__ partials, int Hkv, int G, int dh, int BS, int MB,
                       int window, float scale, int stages, int stage_bytes) {
    extern __shared__ float4 smem_f4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f4);
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, chunks = gridDim.x;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    int lanes = 1;  // lanes per row, a power of two
    while (lanes * EPL < dh) lanes <<= 1;
    const int rows_per_step = 32 / lanes;
    const int grp = lane / lanes, e0 = (lane & (lanes - 1)) * EPL;
    // steps of rows a warp takes at once: 8 (a 16-row page of 2 rows a step)
    // for G = 1; 2 for G up to 8, where q and acc take most registers
    constexpr int kBatch = MAXG == 1 ? 8 : 2;
    const size_t bh = (size_t)b * Hkv + h;

    const int len = lengths[b];
    const int first = max(0, len - window);  // first valid position
    const int last = min(len, MB * BS) - 1;  // last valid position
    const bool none = first > last;          // no valid position: average all
    const int j_lo = max(none ? 0 : first / BS, c * kChunkPages);
    const int j_hi = min(none ? MB - 1 : last / BS, c * kChunkPages + kChunkPages - 1);
    if (j_lo > j_hi) {  // nothing of this sequence in the chunk: an empty partial
        float* p = partials + (bh * chunks + c) * G * (dh + 2);
        for (int i = tid; i < G * (dh + 2); i += kThreads) {
            const int d = i % (dh + 2);
            p[i] = d == dh ? kNegInf : 0.f;
        }
        return;
    }

    // this warp's pages, in order: chunk pages warp, warp + kWarps, ...; the
    // ones to visit are a run of them, pages j0, j0 + kWarps, ... (n of them)
    int j0 = c * kChunkPages + warp;
    while (j0 < j_lo) j0 += kWarps;
    const int n = j0 > j_hi ? 0 : (j_hi - j0) / kWarps + 1;  // j_hi is inside the chunk
    unsigned char* ring = smem + (size_t)warp * stages * stage_bytes;
    const int* table = tables + (size_t)b * MB;
    for (int s = 0; s < stages; ++s) {
        if (s < n)
            pages.issue(ring + (size_t)s * stage_bytes, table[j0 + s * kWarps], h, Hkv, dh, BS,
                        lane);
        cp_async_commit();
    }

    float qr[MAXG][EPL], acc[MAXG][EPL], m[MAXG], l[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        m[g] = kNegInf;
        l[g] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
            const int d = e0 + e;
            qr[g][e] = (g < G && d < dh) ? to_f32(q[(bh * G + g) * dh + d]) * scale : 0.f;
            acc[g][e] = 0.f;
        }
    }

    for (int i = 0; i < n; ++i) {
        switch (stages) {  // page i has landed: at most stages - 1 groups pending
            case 1: cp_async_wait<0>(); break;
            case 2: cp_async_wait<1>(); break;
            case 3: cp_async_wait<2>(); break;
            default: cp_async_wait<3>(); break;
        }
        __syncwarp();
        const unsigned char* st = ring + (size_t)(i % stages) * stage_bytes;
        const int j = j0 + i * kWarps;
        const bool inside = !none && j * BS >= first && j * BS + BS - 1 <= last;  // no mask
        // kBatch steps of rows_per_step rows at a time: their dot products,
        // reductions and exps are independent, so their latencies overlap,
        // and the running max and the rescale of l and acc happen once
        for (int t0 = 0; t0 < BS; t0 += rows_per_step * kBatch) {
            float sc[kBatch][MAXG];
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
                const int t = t0 + r * rows_per_step + grp;
                float kv[EPL];
                if (t < BS) pages.template row<EPL>(st, 0, t, e0, dh, BS, kv);
                else {
#pragma unroll
                    for (int e = 0; e < EPL; ++e) kv[e] = 0.f;
                }
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    float d = 0.f;
#pragma unroll
                    for (int e = 0; e < EPL; ++e) d = fmaf(qr[g][e], kv[e], d);
                    sc[r][g] = d;
                }
            }
            for (int o = lanes >> 1; o > 0; o >>= 1) {  // dot products within a row's lanes
#pragma unroll
                for (int r = 0; r < kBatch; ++r)
#pragma unroll
                    for (int g = 0; g < MAXG; ++g)
                        sc[r][g] += __shfl_xor_sync(0xffffffffu, sc[r][g], o);
            }
            float mx[MAXG];
#pragma unroll
            for (int g = 0; g < MAXG; ++g) mx[g] = kNegInf;
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
                const int t = t0 + r * rows_per_step + grp;
                const bool valid = t < BS && (inside || (j * BS + t <= last &&
                                                         j * BS + t >= first));
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    sc[r][g] = valid ? sc[r][g] : kNegInf;  // rows past the page too
                    mx[g] = fmaxf(mx[g], sc[r][g]);
                }
            }
            for (int o = lanes; o < 32; o <<= 1) {  // the max across the warp's rows
#pragma unroll
                for (int g = 0; g < MAXG; ++g)
                    mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
            }
#pragma unroll
            for (int g = 0; g < MAXG; ++g) {
                const float m_new = fmaxf(m[g], mx[g]);
                const float alpha = expf(m[g] - m_new);
                l[g] *= alpha;
#pragma unroll
                for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
                m[g] = m_new;
            }
#pragma unroll
            for (int r = 0; r < kBatch; ++r) {
                const int t = t0 + r * rows_per_step + grp;
                if (t >= BS) continue;  // past the page: weight 0
                float kv[EPL];
                pages.template row<EPL>(st, 1, t, e0, dh, BS, kv);
#pragma unroll
                for (int g = 0; g < MAXG; ++g) {
                    const float pr = expf(sc[r][g] - m[g]);
                    l[g] += pr;
#pragma unroll
                    for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pr, kv[e], acc[g][e]);
                }
            }
        }
        __syncwarp();  // every lane is done with the slot before it is refilled
        if (i + stages < n)
            pages.issue(ring + (size_t)(i % stages) * stage_bytes,
                        table[j0 + (i + stages) * kWarps], h, Hkv, dh, BS, lane);
        cp_async_commit();
    }

    // sum l and acc over the warp's row groups (m is the same in every lane)
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        for (int o = lanes; o < 32; o <<= 1) {
            l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
        }
    }

    // the warps' states, merged in warp order
    __syncthreads();  // every warp is done with its ring
    float* ms = reinterpret_cast<float*>(smem);  // [kWarps][G][dh + 2]
    if (grp == 0) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
            if (g >= G) break;
            float* row = ms + ((size_t)warp * G + g) * (dh + 2);
#pragma unroll
            for (int e = 0; e < EPL; ++e)
                if (e0 + e < dh) row[e0 + e] = acc[g][e];
            if (lane == 0) {
                row[dh] = m[g];
                row[dh + 1] = l[g];
            }
        }
    }
    __syncthreads();
    for (int idx = tid; idx < G * dh; idx += kThreads) {
        const int g = idx / dh, d = idx - g * dh;
        float m_max = kNegInf;
        bool any = false;
        for (int w = 0; w < kWarps; ++w) {
            const float* row = ms + ((size_t)w * G + g) * (dh + 2);
            if (row[dh + 1] > 0.f) {
                m_max = any ? fmaxf(m_max, row[dh]) : row[dh];
                any = true;
            }
        }
        float a = 0.f, lt = 0.f;
        any = false;
        for (int w = 0; w < kWarps; ++w) {
            const float* row = ms + ((size_t)w * G + g) * (dh + 2);
            if (row[dh + 1] > 0.f) {
                const float f = expf(row[dh] - m_max);
                a = any ? a + row[d] * f : row[d] * f;
                lt = any ? lt + row[dh + 1] * f : row[dh + 1] * f;
                any = true;
            }
        }
        if (chunks == 1) {
            out[(bh * G + g) * dh + d] = from_f32<T>(a / fmaxf(lt, 1e-30f));
        } else {
            float* p = partials + ((bh * chunks + c) * G + g) * (dh + 2);
            p[d] = a;
            if (d == 0) {
                p[dh] = m_max;
                p[dh + 1] = lt;
            }
        }
    }
}

// One block per (sequence, KV head): the chunks' partial states [chunks][G]
// [dh + 2] merged in chunk order, skipping empty ones, then divided by
// max(l, 1e-30). Each chunk's factor expf(m - m_max) and its l·factor are
// computed once into shared memory ([2][G][chunks]; -1 marks an empty
// chunk); each thread then sums one output element over the chunks.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const float* __restrict__ partials, T* __restrict__ out,
                             int chunks, int G, int dh) {
    extern __shared__ float fs[];  // factors [G][chunks], then l·factor [G][chunks]
    float* lf = fs + G * chunks;
    const size_t bh = blockIdx.x;
    const size_t stride = (size_t)G * (dh + 2);  // one chunk
    const float* base = partials + bh * chunks * stride;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int g = warp; g < G; g += kWarps) {  // m_max of head g (max: any order is exact)
        float m_max = kNegInf;
        for (int c = lane; c < chunks; c += 32) {
            const float* st = base + c * stride + (size_t)g * (dh + 2);
            if (st[dh + 1] > 0.f) m_max = fmaxf(m_max, st[dh]);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, o));
        for (int c = lane; c < chunks; c += 32) {
            const float* st = base + c * stride + (size_t)g * (dh + 2);
            const bool live = st[dh + 1] > 0.f;
            const float f = live ? expf(st[dh] - m_max) : -1.f;
            fs[g * chunks + c] = f;
            lf[g * chunks + c] = live ? st[dh + 1] * f : 0.f;
        }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < G * dh; idx += kThreads) {
        const int g = idx / dh, d = idx - g * dh;
        const float* p = base + (size_t)g * (dh + 2) + d;
        float a = 0.f, lt = 0.f;
        bool any = false;
#pragma unroll 8
        for (int c = 0; c < chunks; ++c) {
            const float x = p[c * stride];
            const float f = fs[g * chunks + c];
            if (f >= 0.f) {
                a = any ? a + x * f : x * f;
                lt = any ? lt + lf[g * chunks + c] : lf[g * chunks + c];
                any = true;
            }
        }
        out[(bh * G + g) * dh + d] = from_f32<T>(a / fmaxf(lt, 1e-30f));
    }
}

template <typename T, typename Pages, int EPL>
cudaError_t launch_g(const void* q, Pages pages, const int* tables, const int* lengths,
                     void* out, float* partials, int B, int Hkv, int G, int dh, int BS, int MB,
                     int window, float scale, int chunks, const Plan& plan,
                     cudaStream_t stream) {
    auto kernel = G == 1 ? paged_attention_kernel<T, Pages, EPL, 1>
                         : paged_attention_kernel<T, Pages, EPL, kMaxG>;
    cudaError_t err = allow_smem(kernel, plan.smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(chunks, Hkv, B), kThreads, plan.smem, stream>>>(
        static_cast<const T*>(q), pages, tables, lengths, static_cast<T*>(out), partials, Hkv,
        G, dh, BS, MB, window, scale, plan.stages, plan.stage_bytes);
    err = cudaGetLastError();
    if (err != cudaSuccess || chunks == 1) return err;
    const size_t merge_smem = (size_t)2 * G * chunks * sizeof(float);
    auto merge = paged_attention_merge_kernel<T>;
    err = allow_smem(merge, merge_smem);
    if (err != cudaSuccess) return err;
    merge<<<B * Hkv, kThreads, merge_smem, stream>>>(partials, static_cast<T*>(out), chunks, G,
                                                      dh);
    return cudaGetLastError();
}

// Checks the host's plan against this file's and launches.
template <typename T, typename Pages>
int launch(const void* q, Pages pages, int pool, const void* tables, const void* lengths,
           void* out, void* partials, int B, int Hkv, int G, int dh, int BS, int MB, int window,
           float scale, int chunks, int stages, void* stream) {
    const Plan plan = make_plan(BS, dh, G, pool);
    const int elem = pool == kPoolF32 ? 4 : pool == kPoolBF16 ? 2 : 1;
    if (G < 1 || G > kMaxG || dh < 1 || dh > kMaxHeadDim || (dh * elem) % 16 != 0 ||
        MB < 1 || chunks != (MB + kChunkPages - 1) / kChunkPages || stages != plan.stages ||
        (chunks > 1 && partials == nullptr) || plan.smem > kSmemOptin ||
        (size_t)2 * G * chunks * sizeof(float) > kSmemOptin)
        return (int)cudaErrorInvalidValue;
    auto* t = static_cast<const int*>(tables);
    auto* l = static_cast<const int*>(lengths);
    auto* part = static_cast<float*>(partials);
    auto s = static_cast<cudaStream_t>(stream);
    if constexpr (std::is_same<Pages, FpPages<float>>::value) {  // f32 pools, dh <= 128
        if (plan.epl == 4)
            return (int)launch_g<T, Pages, 4>(q, pages, t, l, out, part, B, Hkv, G, dh, BS, MB,
                                              window, scale, chunks, plan, s);
    }
    return (int)launch_g<T, Pages, 8>(q, pages, t, l, out, part, B, Hkv, G, dh, BS, MB, window,
                                      scale, chunks, plan, s);
}

}  // namespace

// Shared-memory bytes of one block for these shapes, so the host-side plan
// (kernels/paged_attention.py: attention_plan) can be held to it.
extern "C" long repro_paged_attention_smem(int BS, int dh, int G, int pool) {
    return (long)make_plan(BS, dh, G, pool).smem;
}

extern "C" int repro_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                                     const void* tables, const void* lengths, void* out,
                                     void* partials, int B, int Hkv, int G, int dh, int BS,
                                     int MB, int window, float scale, int chunks, int stages,
                                     int dtype, void* stream) {
    if (dtype == REPRO_DT_F32) {
        FpPages<float> p{static_cast<const float*>(k_pool), static_cast<const float*>(v_pool)};
        return launch<float>(q, p, kPoolF32, tables, lengths, out, partials, B, Hkv, G, dh, BS,
                             MB, window, scale, chunks, stages, stream);
    }
    if (dtype == REPRO_DT_BF16) {
        FpPages<__nv_bfloat16> p{static_cast<const __nv_bfloat16*>(k_pool),
                                 static_cast<const __nv_bfloat16*>(v_pool)};
        return launch<__nv_bfloat16>(q, p, kPoolBF16, tables, lengths, out, partials, B, Hkv, G,
                                     dh, BS, MB, window, scale, chunks, stages, stream);
    }
    return (int)cudaErrorInvalidValue;
}

extern "C" int repro_paged_attention_quant(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* k_zero, const void* v_scale,
                                           const void* v_zero, const void* tables,
                                           const void* lengths, void* out, void* partials,
                                           int B, int Hkv, int G, int dh, int BS, int MB,
                                           int window, float scale, int chunks, int stages,
                                           int dtype, void* stream) {
    QuantPages p{static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                 static_cast<const float*>(k_scale),  static_cast<const float*>(k_zero),
                 static_cast<const float*>(v_scale),  static_cast<const float*>(v_zero)};
    if (dtype == REPRO_DT_F32)
        return launch<float>(q, p, kPoolU8, tables, lengths, out, partials, B, Hkv, G, dh, BS,
                             MB, window, scale, chunks, stages, stream);
    if (dtype == REPRO_DT_BF16)
        return launch<__nv_bfloat16>(q, p, kPoolU8, tables, lengths, out, partials, B, Hkv, G,
                                     dh, BS, MB, window, scale, chunks, stages, stream);
    return (int)cudaErrorInvalidValue;
}
