// Grouped dequantize-GEMM body for bf16 activations on Hopper, shared by
// quant_matmul.cu and moe_gmm.cu, with one weight operand or two:
//
//   NOP 1: y[rows of block rb, cols] = x[rows, :] @ dq(W[e]),  e = block_expert[rb]
//   NOP 2: y[rows of block rb, cols] = silu(x @ dq(Wg[e])) * (x @ dq(Wu[e]))   (SwiGLU)
//   dq(W)[k, n] = round_bf16((q[k, n] - zero[k / group, n]) * scale[k / group, n])
//
// The packed layout is the reference's, read as it is stored: uint8 along K,
// code k of a column in byte k / per at shift (k % per) * bits, 3-bit
// weights as a (hi: 2-bit, lo: 1-bit) plane pair, f32 scale/zero
// [E, K/group, N], the last group bounded at K.
//
// Work item: ROWS (8 or 16) rows x a 16-column tile, over all of K.
//  - Staging: one 16-byte cp.async per packed row of the tile (the tile's
//    16 columns of one packed row are 16 contiguous bytes) and operand, the
//    scale/zero rows of every group and the item's x rows: a whole item's K
//    range is in flight at once. Two stage buffers, each holding every
//    operand: while a block computes one item the next item's codes and
//    group params (gate and up for SwiGLU) are already on their way. x is
//    staged once per row block.
//  - K chunks: where the whole K range of an item does not fit in shared
//    memory (kernels/quant_matmul.py: tile_plan), K is cut into the fewest
//    chunks of whole quantization groups that do, fixed by (K, bits, group,
//    ROWS, NOP) alone. An item then walks its chunks in order through the
//    same two-buffer ring: each stage buffer holds one (item, chunk)'s codes,
//    group params and x slice, and the next (item, chunk) streams in behind
//    the current one's products. Each warp adds its k16 slice of every
//    chunk into the same accumulators, so the warps' partial tiles are
//    still reduced once per item, in warp order. One chunk is the layout
//    above, byte for byte.
//  - Dequantisation: a code takes 2^bits values per (group, column), so
//    those values are computed once per item and operand with the exact
//    expression round_bf16(__fmul_rn(__fsub_rn(q, z), s)) into shared-memory
//    tables: for 1 and 2 bits one bf16 pair per pair of codes (a nibble or
//    two bits index a ready A-fragment register), for 3 and 4 bits one bf16
//    per code. Each weight is a lookup, bit-identical to a per-weight dequant.
//  - Products: bf16 mma.sync.m16n8k16 with f32 accumulation in swap-AB
//    form, y^T[16 cols, 8 rows] += dq(W)^T[16 cols, 16 k] . x^T[16 k, 8 rows]:
//    the 16 columns are the MMA's M, the rows its N (ROWS = 16 takes two
//    n8 tiles off the same A fragments; SwiGLU builds gate and up A
//    fragments per k16 step and feeds both from the same x B fragments into
//    2 x NT accumulator sets). A fragments are built in registers from the
//    staged codes (ldmatrix cannot read codes). Within each k16 step, MMA k
//    slots (2t, 2t+1 | 2t+8, 2t+9) of lane t carry codes 4t..4t+3, and MMA
//    rows (g | g+8) columns (2g | 2g+1), so a lane's codes for one step come
//    in one 16-bit load and its x in one 8-byte one.
//  - K: the k16 steps are cut into kWarps contiguous slices, one per warp
//    of the block, and the warps' partial tiles are added in warp order in
//    shared memory (SwiGLU: gate, then up, through the same buffer), then
//    SwiGLU applies silu(g) * u in f32 before the single bf16 store: the
//    gate and up products never reach device memory. No atomics; every
//    reduction runs in an order fixed by (K, N, bits, group), never by M or
//    the row block, so a row's output is bit-identical whatever M or row
//    block it is computed in.
//  - Grid: persistent. A fixed number of blocks (what fits on the SMs at
//    once, at most one per work item) reads num_active[0] and block_expert
//    on the device, takes an even contiguous share of the live (row block x
//    column tile) items — consecutive items share a row block, whose x stays
//    staged — and zero-fills the dead rows [num_active * ROWS, M) with
//    16-byte stores in a grid-stride loop. No host sync.
//  - Residency at K = 2048, group 128 (kernels/quant_matmul.py: tile_plan):
//    SwiGLU's 2- and 3-bit rows-8 (decode) blocks take 110.25 and 102.25 KB
//    of shared memory, so two fit on an SM; its 2- and 3-bit rows-16
//    (prefill) blocks take 146.5 and 138.5 KB and run one per SM. At K =
//    7168 every instance but 1-bit rows-8 quant_matmul takes 2-4 chunks.
#pragma once

#include "dequant_gemm.cuh"

namespace repro {
namespace {
namespace sm90 {

constexpr int kCols = 16;             // column tile: the MMA's M dimension
constexpr int kWarps = 8;             // K slices of one work item
constexpr int kThreads = kWarps * 32;

// Per-(group, column) value tables: 1 and 2 bits hold a bf16x2 per code
// pair (4^bits entries), 3 and 4 bits a bf16 per code; a column's entries
// are padded (stride) so the lanes' lookups spread over the banks.
template <int BITS> struct Table {
    static constexpr bool kPairs = BITS <= 2;
    static constexpr int kEntries = kPairs ? 1 << (2 * BITS) : 1 << BITS;
    static constexpr int kStride = kPairs ? kEntries + 1 : kEntries + 2;
    static constexpr int kEntryBytes = kPairs ? 4 : 2;
};

// What one block may opt in to on an H100; the plan keeps every layout
// within it (kernels/quant_matmul.py: SMEM_OPTIN).
constexpr size_t kSmemOptin = 232448;

// Byte offsets of one block's dynamic shared memory; every region starts on
// 16 bytes. Mirrored by kernels/quant_matmul.py: tile_plan.
struct Layout {
    int kx;      // codes of one K chunk, rounded up to the k16 step
    int ng;      // quantization groups of one chunk
    int chunks;  // K chunks, walked in order (1: all of K)
    int r0;      // staged rows of plane 0 (rows of kx codes)
    int wrows;   // staged packed rows: plane 0, then plane 1 (3 bits)
    int xs;      // x row stride in bf16, padded so the 8 rows' 8-byte loads hit distinct banks
    size_t sz_off;     // within one operand's stage: its scale, zero after the packed rows
    size_t op_stage;   // one operand's stage: packed rows, then scale, zero
    size_t x_stage;    // several chunks: the x slice's offset within a stage buffer
    size_t stage;      // one stage buffer: every operand's stage (and the x slice)
    size_t tab_bytes;  // one operand's value tables
    size_t tab_off, x_off, red_off, total;
};

__host__ __device__ inline size_t round16(size_t b) { return (b + 15) / 16 * 16; }

// The layout with chunks of gpc groups (gpc >= the group count: one chunk).
// One chunk stages x once per row block beside the tables; several carry
// each chunk's x slice in the stage buffers, with its codes.
template <int BITS, int ROWS, int NOP>
__host__ __device__ inline Layout layout(int K, int group, int gpc) {
    Layout L;
    const int ng_all = (K + group - 1) / group;
    L.chunks = (ng_all + gpc - 1) / gpc;
    L.kx = L.chunks == 1 ? (K + 15) / 16 * 16 : gpc * group;
    L.ng = L.chunks == 1 ? ng_all : gpc;
    L.r0 = Planes<BITS>::rows0(L.kx);
    L.wrows = L.r0 + Planes<BITS>::rows1(L.kx);
    L.xs = L.kx + 2 * ((8 - (L.kx / 2) % 32 + 32) % 32);
    const size_t x_bytes = (size_t)ROWS * L.xs * sizeof(__nv_bfloat16);
    L.sz_off = (size_t)L.wrows * kCols;
    L.op_stage = L.sz_off + (size_t)L.ng * 2 * kCols * sizeof(float);
    L.x_stage = NOP * L.op_stage;
    L.stage = L.x_stage + (L.chunks > 1 ? x_bytes : 0);
    L.tab_off = 2 * L.stage;
    L.tab_bytes = round16((size_t)L.ng * kCols * Table<BITS>::kStride * Table<BITS>::kEntryBytes);
    L.x_off = L.tab_off + NOP * L.tab_bytes;
    L.red_off = L.x_off + (L.chunks > 1 ? 0 : x_bytes);
    L.total = L.red_off + (size_t)kWarps * ROWS * kCols * sizeof(float);
    return L;
}

// Groups per K chunk: all of them where that layout fits, else those of the
// fewest even chunks that fit (1 when none does: the launch is refused).
template <int BITS, int ROWS, int NOP>
inline int chunk_groups(int K, int group) {
    const int ng = (K + group - 1) / group;
    if (layout<BITS, ROWS, NOP>(K, group, ng).total <= kSmemOptin) return ng;
    for (int n = 2; n <= ng; ++n) {
        const int gpc = (ng + n - 1) / n;
        if (layout<BITS, ROWS, NOP>(K, group, gpc).total <= kSmemOptin) return gpc;
    }
    return 1;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The dequantised weight as bf16 bits: the kernels' one dequant expression.
__device__ __forceinline__ uint32_t dq_bits(int q, float z, float s) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(__fmul_rn(__fsub_rn((float)q, z), s)));
}

// The four A-fragment registers of lane t for one k16 step at code kb:
// a[h] = column 2g + h, codes kb+4t, +1; a[2 + h] = the same column, codes
// kb+4t+2, +3 (low half the lower code). ws: staged packed rows [*, 16];
// tb: the step's group's table; c0 = 2g.
template <int BITS>
__device__ __forceinline__ void a_fragments(uint32_t (&a)[4], const uint8_t* ws, int r0, int kb,
                                            int t, int c0, const void* tb) {
    using T = Table<BITS>;
    if constexpr (BITS == 1 || BITS == 2) {
        const uint32_t* tp = static_cast<const uint32_t*>(tb);
        // BITS 2: codes 4t..4t+3 fill byte kb/4 + t; BITS 1: half of byte kb/8 + t/2
        const int row = BITS == 2 ? (kb >> 2) + t : (kb >> 3) + (t >> 1);
        const int sh = BITS == 2 ? 0 : 4 * (t & 1);
        const uint32_t two = *reinterpret_cast<const uint16_t*>(ws + row * kCols + c0);
        constexpr int pb = 2 * BITS, pm = (1 << pb) - 1;  // bits of one code pair
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint32_t codes = two >> (8 * h + sh);
            a[h] = tp[(c0 + h) * T::kStride + (codes & pm)];
            a[2 + h] = tp[(c0 + h) * T::kStride + ((codes >> pb) & pm)];
        }
    } else {
        const uint16_t* tv = static_cast<const uint16_t*>(tb);
        int q[2][4];  // [h][code 4t + i]
        if constexpr (BITS == 4) {
#pragma unroll
            for (int jb = 0; jb < 2; ++jb) {  // byte kb/2 + 2t + jb: codes 4t + 2jb, +1
                const uint32_t two =
                    *reinterpret_cast<const uint16_t*>(ws + ((kb >> 1) + 2 * t + jb) * kCols + c0);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    q[h][2 * jb] = (two >> (8 * h)) & 15;
                    q[h][2 * jb + 1] = (two >> (8 * h + 4)) & 15;
                }
            }
        } else {  // 3 bits: hi byte kb/4 + t, lo half byte r0 + kb/8 + t/2
            const uint32_t hi2 = *reinterpret_cast<const uint16_t*>(ws + ((kb >> 2) + t) * kCols + c0);
            const uint32_t lo2 = *reinterpret_cast<const uint16_t*>(
                ws + (r0 + (kb >> 3) + (t >> 1)) * kCols + c0);
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    q[h][i] = (((hi2 >> (8 * h + 2 * i)) & 3) << 1) |
                              ((lo2 >> (8 * h + 4 * (t & 1) + i)) & 1);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const uint16_t* tl = tv + (c0 + h) * T::kStride;
            a[h] = tl[q[h][0]] | ((uint32_t)tl[q[h][1]] << 16);
            a[2 + h] = tl[q[h][2]] | ((uint32_t)tl[q[h][3]] << 16);
        }
    }
}

// CHUNKED: the plan cuts K (L.chunks > 1); a one-chunk plan runs the
// instance without the chunk loop, whose instructions are the whole-K body's.
template <int BITS, int ROWS, int NOP, bool CHUNKED>
__global__ void __launch_bounds__(kThreads, 2)
dequant_gemm_sm90_kernel(const __nv_bfloat16* __restrict__ x, Operand a, Operand b,
                         const int* __restrict__ block_expert,
                         const int* __restrict__ num_active, __nv_bfloat16* __restrict__ y,
                         int M, int K, int N, int group, int gpc) {
    constexpr int NT = ROWS / 8;  // n8 tiles per item
    static_assert(ROWS * kCols <= kThreads, "one output element per thread");
    using T = Table<BITS>;
    extern __shared__ __align__(16) uint8_t smem[];
    const Layout L = layout<BITS, ROWS, NOP>(K, group, gpc);
    uint8_t* tab = smem + L.tab_off;                                        // [NOP][ng][16][stride]
    __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + L.x_off);  // [ROWS][xs]
    float* red = reinterpret_cast<float*>(smem + L.red_off);               // [warps][ROWS][16]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int ntiles = (N + kCols - 1) / kCols;
    const int nrb = (M + ROWS - 1) / ROWS;
    const int live_rb = num_active != nullptr ? min(max(num_active[0], 0), nrb) : nrb;

    if (num_active != nullptr) {  // dead rows are exactly zero
        const size_t lo = (size_t)live_rb * ROWS * N, hi = (size_t)M * N;
        const size_t stride = (size_t)gridDim.x * kThreads;
        if ((N & 7) == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0) {
            uint4* y4 = reinterpret_cast<uint4*>(y);
            for (size_t i = lo / 8 + (size_t)blockIdx.x * kThreads + tid; i < hi / 8; i += stride)
                y4[i] = make_uint4(0, 0, 0, 0);
        } else {
            for (size_t i = lo + (size_t)blockIdx.x * kThreads + tid; i < hi; i += stride)
                y[i] = __float2bfloat16_rn(0.f);
        }
    }

    const long items = (long)live_rb * ntiles;
    const int i0 = (int)(items * blockIdx.x / gridDim.x);
    const int i1 = (int)(items * (blockIdx.x + 1) / gridDim.x);
    if (i0 >= i1) return;

    const Operand ops[2] = {a, b};
    // 16-byte copies need 16-byte aligned rows: N a multiple of 16 for the
    // packed planes and scale/zero, K a multiple of 8 for x
    uintptr_t align = 0;
#pragma unroll
    for (int o = 0; o < NOP; ++o)
        align |= reinterpret_cast<uintptr_t>(ops[o].p0) | reinterpret_cast<uintptr_t>(ops[o].p1) |
                 reinterpret_cast<uintptr_t>(ops[o].scale) |
                 reinterpret_cast<uintptr_t>(ops[o].zero);
    const bool vec_w = (N % kCols) == 0 && (align & 15) == 0;
    const bool vec_x = (K % 8) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
    const int R0 = Planes<BITS>::rows0(K), R1 = Planes<BITS>::rows1(K);  // rows in memory
    const int C = CHUNKED ? L.chunks : 1, NG = (K + group - 1) / group;
    // several chunks: the x slice of the (item, chunk) in stage buffer buf
    auto x_slice = [&](int buf) {
        return reinterpret_cast<__nv_bfloat16*>(smem + buf * L.stage + L.x_stage);
    };

    // the ROWS rows of x of row block rb, K chunk c, into xd (zero past M
    // and past K)
    auto stage_x = [&](int rb, int c, __nv_bfloat16* xd) {
        const int m0 = rb * ROWS, k0 = c * L.kx, chunks = L.kx / 8;  // 16-byte pieces of a row
        for (int i = tid; i < ROWS * chunks; i += kThreads) {
            const int r = i / chunks, kk = (i % chunks) * 8, k = k0 + kk;
            __nv_bfloat16* dst = xd + r * L.xs + kk;
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
    };
    // every operand's packed rows and group params of K chunk c of item
    // `it` (several chunks: and its x slice) into stage buffer `buf`
    auto stage_w = [&](int it, int c, int buf) {
        const int rb = it / ntiles, n0 = (it % ntiles) * kCols;
        const int e = block_expert != nullptr ? block_expert[rb] : 0;
        const int k0 = c * L.kx, gc0 = c * L.ng, ngc = CHUNKED ? min(L.ng, NG - gc0) : L.ng;
        const int q0 = Planes<BITS>::rows0(k0), q1 = Planes<BITS>::rows1(k0);  // chunk's first rows
#pragma unroll
        for (int o = 0; o < NOP; ++o) {
            uint8_t* ws = smem + buf * L.stage + o * L.op_stage;
            float* sz = reinterpret_cast<float*>(ws + L.sz_off);  // scale [ng][16], zero [ng][16]
            const uint8_t* g0 = ops[o].p0 + ((size_t)e * R0 + q0) * N + n0;
            const uint8_t* g1 = BITS == 3 ? ops[o].p1 + ((size_t)e * R1 + q1) * N + n0 : nullptr;
            for (int r = tid; r < L.wrows; r += kThreads) {
                const uint8_t* src = nullptr;
                if (r < L.r0) {
                    if (q0 + r < R0) src = g0 + (size_t)r * N;
                } else if (q1 + r - L.r0 < R1) {
                    src = g1 + (size_t)(r - L.r0) * N;
                }
                uint8_t* dst = ws + r * kCols;
                if (vec_w && src != nullptr) {
                    cp_async16(dst, src);
                } else if (vec_w) {
                    *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
                } else {
                    for (int j = 0; j < kCols; ++j) dst[j] = (src && n0 + j < N) ? src[j] : 0;
                }
            }
            const size_t gbase = ((size_t)e * NG + gc0) * N + n0;
            for (int i = tid; i < ngc * 8; i += kThreads) {  // [scale|zero][group][4 x 16 B]
                const int arr = i / (ngc * 4), g = (i / 4) % ngc, ch = i % 4;
                const float* src = (arr ? ops[o].zero : ops[o].scale) + gbase + (size_t)g * N +
                                   ch * 4;
                float* dst = sz + (arr * L.ng + g) * kCols + ch * 4;
                if (vec_w) {
                    cp_async16(dst, src);
                } else {
                    for (int j = 0; j < 4; ++j) dst[j] = n0 + ch * 4 + j < N ? src[j] : 0.f;
                }
            }
        }
        if constexpr (CHUNKED) stage_x(rb, c, x_slice(buf));
    };

    const int spg = group / 16;
    const int t = lane & 3, gq = lane >> 2, c0 = 2 * gq;  // MMA fragment coordinates
    const size_t tab_group = (size_t)kCols * T::kStride * T::kEntryBytes;

    // units: (item, chunk) pairs, chunks innermost
    const int units = (i1 - i0) * C;
    float acc[NOP][NT][4];
    int staged_rb = -1;
    for (int u = 0; u < units; ++u) {
        const int it = i0 + u / C, c = u % C;
        const int buf = u & 1;
        const int rb = it / ntiles, n0 = (it % ntiles) * kCols, m0 = rb * ROWS;
        // a later chunk: every warp is done with the previous chunk's
        // products (its stage buffer, which the next unit overwrites)
        if (CHUNKED && c > 0) __syncthreads();
        if (u == 0) stage_w(it, c, buf);
        if (!CHUNKED && rb != staged_rb) {  // the last item's products are done (barrier below)
            stage_x(rb, 0, xs);
            staged_rb = rb;
        }
        cp_async_commit();
        if (u + 1 < units) {  // the next unit's codes stream in behind this one's products
            stage_w(i0 + (u + 1) / C, (u + 1) % C, buf ^ 1);
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();

        // ---- the chunk's value tables: one thread per (group, column) of
        // each operand computes its 2^bits values once and writes the entries
        constexpr int NQ = 1 << BITS;
        const int ngc = CHUNKED ? min(L.ng, NG - c * L.ng) : L.ng;
#pragma unroll
        for (int o = 0; o < NOP; ++o) {
            const float* sc = reinterpret_cast<const float*>(smem + buf * L.stage +
                                                             o * L.op_stage + L.sz_off);
            const float* ze = sc + L.ng * kCols;
            uint8_t* to = tab + o * L.tab_bytes;
            for (int gc = tid; gc < ngc * kCols; gc += kThreads) {
                const float z = ze[gc], s = sc[gc];
                uint32_t v[NQ];
#pragma unroll
                for (int q = 0; q < NQ; ++q) v[q] = dq_bits(q, z, s);
                if constexpr (T::kPairs) {
                    uint32_t* dst = reinterpret_cast<uint32_t*>(to) + gc * T::kStride;
#pragma unroll
                    for (int p = 0; p < T::kEntries; ++p)
                        dst[p] = v[p & (NQ - 1)] | (v[p >> BITS] << 16);
                } else {
                    uint16_t* dst = reinterpret_cast<uint16_t*>(to) + gc * T::kStride;
#pragma unroll
                    for (int q = 0; q < NQ; ++q) dst[q] = (uint16_t)v[q];
                }
            }
        }
        __syncthreads();

        // ---- this warp's slice of the chunk's k16 steps: A from the staged
        // codes, B from x
        const uint8_t* ws = smem + buf * L.stage;
        const __nv_bfloat16* xb = CHUNKED ? x_slice(buf) : xs;
        if (c == 0) {
#pragma unroll
            for (int o = 0; o < NOP; ++o)
#pragma unroll
                for (int nt = 0; nt < NT; ++nt)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[o][nt][j] = 0.f;
        }
        const int S = CHUNKED ? (min(L.kx, K - c * L.kx) + 15) / 16 : L.kx / 16;
        const int spw = (S + kWarps - 1) / kWarps;
        const int s_lo = warp * spw, s_hi = min(S, s_lo + spw);
        int g = s_lo / spg, left = spg - s_lo % spg;  // group of the step, steps left in it
        const uint8_t* tb = tab + g * tab_group;
        // launch/probe_dequant.py builds a copy without the products to split
        // an item's time between them and the rest
#ifndef REPRO_SM90_PROBE_NO_PRODUCTS
#pragma unroll 2
        for (int s = s_lo; s < s_hi; ++s) {
            const int kb = s * 16;
#pragma unroll
            for (int o = 0; o < NOP; ++o) {  // SwiGLU: gate, then up, off the same x
                uint32_t A[4];
                a_fragments<BITS>(A, ws + o * L.op_stage, L.r0, kb, t, c0, tb + o * L.tab_bytes);
#pragma unroll
                for (int nt = 0; nt < NT; ++nt) {
                    const uint2 b = *reinterpret_cast<const uint2*>(xb + (nt * 8 + gq) * L.xs +
                                                                    kb + 4 * t);
                    mma_16816(acc[o][nt], A, b.x, b.y);
                }
            }
            if (--left == 0) {
                left = spg;
                tb += tab_group;
            }
        }

#endif
        if (CHUNKED && c + 1 < C) continue;  // the item's later chunks add into acc
        // ---- fixed-order reduction of the warps' partial tiles (SwiGLU: gate,
        // then up, through the one buffer), then the epilogue and the store
        float* rw = red + warp * ROWS * kCols;
        float out[NOP];
#pragma unroll
        for (int o = 0; o < NOP; ++o) {
            if (o > 0) __syncthreads();  // the previous operand's sums are read
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {  // MMA rows gq | gq + 8 are columns c0 | c0 + 1
                const int r = nt * 8 + 2 * t;
                *reinterpret_cast<float2*>(rw + r * kCols + c0) =
                    make_float2(acc[o][nt][0], acc[o][nt][2]);
                *reinterpret_cast<float2*>(rw + (r + 1) * kCols + c0) =
                    make_float2(acc[o][nt][1], acc[o][nt][3]);
            }
            __syncthreads();
            if (tid < ROWS * kCols) {
                float v = red[tid];
                for (int w = 1; w < kWarps; ++w) v += red[w * ROWS * kCols + tid];
                out[o] = v;
            }
        }
        if (tid < ROWS * kCols) {
            const int m = m0 + tid / kCols, n = n0 + tid % kCols;
            float v = out[0];
            if constexpr (NOP == 2) v = v / (1.f + expf(-v)) * out[1];
            if (m < M && n < N) y[(size_t)m * N + n] = __float2bfloat16_rn(v);
        }
        // the next item's tables and partials are written only after its own
        // wait barrier, which every thread reaches after this store
    }
}

template <int BITS, int ROWS, int NOP, bool CHUNKED>
cudaError_t run(const Layout& L, const void* x, Operand a, Operand b, const int* block_expert,
                const int* num_active, void* y, int M, int K, int N, int group, int gpc,
                cudaStream_t stream) {
    auto kernel = dequant_gemm_sm90_kernel<BITS, ROWS, NOP, CHUNKED>;
    // Opt in to the card's whole shared memory once per instance; then the
    // blocks resident per SM at each shared-memory size seen (a few K per
    // model), so the CUDA runtime is queried once per size, not per launch.
    static bool opted = false;
    static size_t seen_smem[8];
    static int seen_blocks[8], nseen = 0;
    cudaError_t err;
    int dev = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
    if (!opted) {
        int optin = 0;
        err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
        if (err != cudaSuccess) return err;
        if ((err = allow_smem(kernel, (size_t)optin)) != cudaSuccess) return err;
        opted = true;
    }
    int blocks = 0;
    for (int i = 0; i < nseen; ++i)
        if (seen_smem[i] == L.total) blocks = seen_blocks[i];
    if (blocks == 0) {
        int sms = 0, per_sm = 0;
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, L.total);
        if (err != cudaSuccess) return err;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        blocks = sms * per_sm;
        seen_smem[nseen % 8] = L.total;
        seen_blocks[nseen % 8] = blocks;
        ++nseen;
    }
    const long items = (long)((M + ROWS - 1) / ROWS) * ((N + kCols - 1) / kCols);
    const int grid = (int)(items < blocks ? items : blocks);
    kernel<<<grid, kThreads, L.total, stream>>>(static_cast<const __nv_bfloat16*>(x), a, b,
                                                block_expert, num_active,
                                                static_cast<__nv_bfloat16*>(y), M, K, N, group,
                                                gpc);
    return cudaGetLastError();
}

template <int BITS, int ROWS, int NOP>
cudaError_t launch(const void* x, Operand a, Operand b, const int* block_expert,
                   const int* num_active, void* y, int M, int K, int N, int group,
                   cudaStream_t stream) {
    const int gpc = chunk_groups<BITS, ROWS, NOP>(K, group);
    const Layout L = layout<BITS, ROWS, NOP>(K, group, gpc);
    if (L.total > kSmemOptin) return cudaErrorInvalidValue;  // one group overflows the ring
    if (L.chunks > 1)
        return run<BITS, ROWS, NOP, true>(L, x, a, b, block_expert, num_active, y, M, K, N,
                                          group, gpc, stream);
    return run<BITS, ROWS, NOP, false>(L, x, a, b, block_expert, num_active, y, M, K, N, group,
                                       gpc, stream);
}

// Runtime (bits, rows) -> template instance; bf16 activations only. NOP 1
// reads operand a alone; NOP 2 is SwiGLU with gate a and up b.
template <int NOP>
cudaError_t dispatch(const void* x, Operand a, Operand b, const int* block_expert,
                     const int* num_active, void* y, int M, int K, int N, int bits, int group,
                     int rows, cudaStream_t stream) {
#define REPRO_SM90_CASE(B, R)                                                                 \
    if (bits == B && rows == R)                                                               \
        return launch<B, R, NOP>(x, a, b, block_expert, num_active, y, M, K, N, group, stream);
    REPRO_SM90_CASE(1, 8) REPRO_SM90_CASE(2, 8) REPRO_SM90_CASE(3, 8) REPRO_SM90_CASE(4, 8)
    REPRO_SM90_CASE(1, 16) REPRO_SM90_CASE(2, 16) REPRO_SM90_CASE(3, 16) REPRO_SM90_CASE(4, 16)
#undef REPRO_SM90_CASE
    return cudaErrorInvalidValue;
}

// Shared-memory bytes of one block, for the host-side plan to check against.
inline long smem_bytes(int K, int bits, int group, int rows, int operands) {
#define REPRO_SM90_SMEM(B, R)                                                              \
    if (bits == B && rows == R)                                                            \
        return (long)(operands == 2                                                        \
                          ? layout<B, R, 2>(K, group, chunk_groups<B, R, 2>(K, group))     \
                          : layout<B, R, 1>(K, group, chunk_groups<B, R, 1>(K, group)))    \
            .total;
    if (operands != 1 && operands != 2) return -1;
    REPRO_SM90_SMEM(1, 8) REPRO_SM90_SMEM(2, 8) REPRO_SM90_SMEM(3, 8) REPRO_SM90_SMEM(4, 8)
    REPRO_SM90_SMEM(1, 16) REPRO_SM90_SMEM(2, 16) REPRO_SM90_SMEM(3, 16) REPRO_SM90_SMEM(4, 16)
#undef REPRO_SM90_SMEM
    return -1;
}

}  // namespace sm90
}  // namespace
}  // namespace repro
