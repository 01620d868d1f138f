// Pattern-masked sparse-sparse product for NVIDIA Hopper (sm_90a).
//
//   out[i, o] = sum_a sum_b Ad[i, a] * Bd[Ac[i, a], b]
//                           * [Bc[Ac[i, a], b] == pat[i, o]]
//
// A (n, w_a), B (nb, w_b) and the output pattern (n, w_out) are padded-ELL
// slabs, row-major.  The pattern's padding slots hold -1 and match nothing;
// its valid columns are sorted ascending in front of them.  A's and B's
// padding slots hold data 0 (and, in a SparseELL, their own row index as
// the column).  This is the numeric half of the device Galerkin setup (S*T,
// A*P and R*(A*P) of every level); the host builds the patterns.
//
// Two kernels, one per TPU kernel they replace:
//  * masked_spgemm_gather replaces pyamg_tpu/sparse/spgemm_pallas.py::
//    _spgemm_pallas (the one-hot MXU kernel, bf16x3, ~1e-5 relative) and
//    serves any A.  It is exact in the input type.
//  * masked_spgemm_banded replaces pyamg_tpu/sparse/spgemm_dia.py::
//    _banded_spgemm and serves a banded A (at most 64 distinct col - row
//    offsets, sorted ascending, passed by value).
//
// What bounds them on this card: bytes and the latency of dependent loads,
// not flops.  Each product is one multiply-add against 8-16 bytes of B, and
// a row's work is a gather whose address comes from A's column slab.  The
// products of the setup are a few MB to a few tens of MB, so most of B's
// re-reads come from the 50 MB L2.  Tensor cores do not help: there is no
// tile of dense work, and each product is exact in the input type.
//
// What the design does about it (the tiled bodies):
//  * a block owns a tile of `rows` consecutive output rows and stages the
//    tile's A slabs (values and columns) and pattern slab into shared
//    memory with cp.async (16-byte copies where the slab's alignment
//    allows, 4-byte copies for the ragged ends), double-buffered in a
//    persistent loop over tiles, so the next tile's slabs arrive while this
//    tile's B loads run.  TMA bulk copies would need 16-byte-aligned
//    windows, which these slabs (and the banded kernel's B windows at odd
//    offsets) do not always have;
//  * work goes over (row, B slot) for each A slot (banded: each offset) in
//    turn, so a row issues w_a + w_a * w_b + w_out index loads, each once,
//    where a thread per output slot re-walked the whole row product;
//  * a row has 2^lg lanes, chosen by the wrapper from the shape.  With one
//    lane (a product of many rows: every level-0 and level-1 product of the
//    1M setup) a thread walks its row alone and keeps the row's pattern
//    (at most 32 slots) and sums in registers: a product is compared with
//    every slot of the pattern, unrolled, and added where it matches, so
//    the hot loop touches shared memory only for A, and each width class
//    (8, 16, 32 slots) is a kernel of its own with its own register count.
//    With more lanes (a product of few rows, where one thread a row would
//    leave the card idle) lane q of a row takes B slots q, q + 2^lg, ...,
//    issues kUnroll steps' B loads together, finds its output slot in the
//    staged pattern row (a linear scan up to 8 slots, a binary search
//    beyond) and adds into a shared-memory accumulator;
//  * a slab of any width whose tile fits a block's shared memory runs: the
//    wrapper lowers the tile to 16 rows, and below 16 (8, 4, 2, 1) only
//    where a 16-row tile would not fit.  Rows wider than the register
//    classes (R of a 3-D operator: 125 slots and more) take the
//    shared-memory accumulator, whose binary search serves any pattern;
//  * the block writes the tile's outputs with coalesced stores at the end;
//  * banded only: A's values are mapped once per (row, offset) into
//    adia[k][r] when the tile arrives, so step k reads B row i + off_k with
//    no index load, and a warp's rows read one contiguous window of B.
//
// Bitwise equal to the plain twin (pyamg_tpu_torch/sparse/spgemm_kernel.py):
// the twin adds, for each A slot in order, one rounded product per output
// slot.  So the steps go over a (banded: the offsets, which for a banded A
// are its slots' order) ascending, the products and sums are rounded with
// __fmul_rn / __fadd_rn (nvcc may not contract them into an FMA), and where
// a row has several lanes they share one warp, with __syncwarp after every
// element, so the adds into one slot land in step order.
//
// Hazard: two lanes, one accumulator.  A SparseELL's padding slot holds data
// 0 and cols == its own row index, which can equal a stored column of the
// same row.  The padding lane and the real lane would then add into the
// same acc[r][o] in the same step, and one add could be lost.  So every B
// slot whose value is 0 is skipped (a stored zero contributes exactly 0),
// and so is every A slot whose value is 0 or whose row lies outside B.
//
// The first bodies, one thread per output slot that re-walks its row's
// whole product, stay under the entry points
// masked_spgemm_{gather,banded}_slotwise_{f32,f64}: chip_smoke.py holds them
// against the twin and times them beside the tiled bodies, and nothing else
// calls them.
//
// The launchers run on the caller's stream, allocate nothing, and return
// cudaGetLastError() (or cudaErrorInvalidValue for a geometry the kernel
// refuses) so that the Python wrapper can raise.  The tiled launchers take
// two CUDA events (or null) that they record on that stream just before
// and after the kernel, after the kernel's function attributes are set:
// the pair then holds the kernel, not the first use's loading of it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;             // slotwise bodies
// 8 resident blocks of 256 threads fill an SM's 2048 thread slots; 132 SMs.
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kMaxOffsets = 64;
constexpr int kTileThreads = 256;         // most threads of a tiled block
constexpr int kMaxTileRows = 256;
constexpr int64_t kMaxSharedBytes = 232448;   // a block's, on sm_90
constexpr int kUnroll = 8;                // B loads issued together
constexpr int kRowUnroll = 4;             // B slots a row's thread loads together

struct Offsets {
    int k;
    int v[kMaxOffsets];
};

// ---------------------------------------------------------------------------
// the tiled bodies
// ---------------------------------------------------------------------------

__host__ __device__ inline int64_t round16(int64_t b) {
    return (b + 15) & ~int64_t(15);
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
    return a < b ? a : b;
}

// Byte offsets into a block's dynamic shared memory: two stages of
// {A values, A columns, pattern}, each slab with 16 bytes of slack for its
// alignment shift, then the accumulator, A by diagonal and the offsets
// (these two for the banded kernel only, k = 0 otherwise).  The Python
// wrapper computes the same total (spgemm_kernel.shared_bytes).
struct Layout {
    int64_t ad, ac, pat, stage, acc, adia, offs, total;
};

__host__ __device__ inline Layout tile_layout(int rows, int w_a, int w_out,
                                              int es, int k) {
    Layout L;
    L.ad = 0;
    L.ac = L.ad + round16(int64_t(rows) * w_a * es) + 16;
    L.pat = L.ac + round16(int64_t(rows) * w_a * 4) + 16;
    L.stage = L.pat + round16(int64_t(rows) * w_out * 4) + 16;
    L.acc = 2 * L.stage;
    L.adia = L.acc + round16(int64_t(rows) * w_out * es);
    L.offs = L.adia + round16(int64_t(k) * rows * es);
    L.total = L.offs + round16(int64_t(k) * 4);
    return L;
}

template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
template <> __device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
template <> __device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Where a slab copied from `src` starts inside its region: shifted by the
// source's misalignment, so that source and copy agree modulo 16 bytes.
template <typename T>
__device__ __forceinline__ T* staged(unsigned char* region, const void* src) {
    return reinterpret_cast<T*>(
        region + (reinterpret_cast<uintptr_t>(src) & 15));
}

// Copy nbytes (a multiple of 4, src 4-byte aligned) into `region` + the
// shift: 4-byte copies up to the first 16-byte boundary of src and after
// the last, 16-byte copies between.  Every thread of the block takes part.
__device__ __forceinline__ void stage_async(unsigned char* region,
                                            const void* src_v,
                                            int64_t nbytes) {
    const unsigned char* src = static_cast<const unsigned char*>(src_v);
    unsigned char* dst = staged<unsigned char>(region, src_v);
    int64_t head = (16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15;
    if (head > nbytes) head = nbytes;
    const int64_t body_end = head + ((nbytes - head) & ~int64_t(15));
    const int64_t t = threadIdx.x, nt = blockDim.x;
    for (int64_t x = 4 * t; x < head; x += 4 * nt) cp_async4(dst + x, src + x);
    for (int64_t x = head + 16 * t; x < body_end; x += 16 * nt) {
        cp_async16(dst + x, src + x);
    }
    for (int64_t x = body_end + 4 * t; x < nbytes; x += 4 * nt) {
        cp_async4(dst + x, src + x);
    }
}

// The slot of column c in a staged pattern row (valid columns ascending,
// then -1), or -1.
__device__ __forceinline__ int find_slot(const int32_t* row, int w,
                                         int32_t c) {
    if (w <= 8) {
        for (int o = 0; o < w; ++o) {
            if (row[o] == c) return o;
        }
        return -1;
    }
    int lo = 0, hi = w;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        const int32_t v = row[mid];
        if (v >= 0 && v < c) lo = mid + 1; else hi = mid;
    }
    return (lo < w && row[lo] == c) ? lo : -1;
}

// The index of delta among the k sorted offsets, or -1.
__device__ __forceinline__ int find_offset(const int32_t* offs, int k,
                                           int64_t delta) {
    int lo = 0, hi = k;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (offs[mid] < delta) lo = mid + 1; else hi = mid;
    }
    return (lo < k && offs[lo] == delta) ? lo : -1;
}

template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* stage,
                                           const Layout& L, const T* ad,
                                           const int32_t* ac, int w_a,
                                           const int32_t* pat, int w_out,
                                           int64_t i0, int64_t cnt) {
    stage_async(stage + L.ad, ad + i0 * w_a, cnt * w_a * sizeof(T));
    stage_async(stage + L.ac, ac + i0 * w_a, cnt * w_a * 4);
    stage_async(stage + L.pat, pat + i0 * w_out, cnt * w_out * 4);
}

// One tile's products into acc.  A row takes g = 2^lg lanes of one warp (a
// warp takes 32/g rows at a time); lane q of a row takes B slots q, q + g,
// ..., so a step (an A slot, or an offset) is `passes` elements for each
// lane.  A lane walks its elements step-major, kUnroll at a time: their B
// loads go out together, then the adds land in order.  Where g > 1 the
// lanes of a row meet in acc, so __syncwarp follows every element; with
// g = 1 a thread owns its row and needs none.
template <typename T, bool kBanded>
__device__ __forceinline__ void accumulate_tile(
    const T* ad_s, const int32_t* ac_s, const int32_t* pat_s, const T* adia,
    const int32_t* offs_s, int k, T* acc, int w_a, int64_t i0, int cnt,
    int rows, const T* __restrict__ bd, const int32_t* __restrict__ bc,
    int w_b, int64_t nb, int w_out, int lg) {
    const int g = 1 << lg;
    const int passes = (w_b + g - 1) >> lg;
    const int per_warp = 32 >> lg;
    const int lane = threadIdx.x & 31;
    const int sub = lane >> lg, q = lane & (g - 1);
    const int total = (kBanded ? k : w_a) * passes;
    const int groups = (cnt + per_warp - 1) / per_warp;
    for (int grp = threadIdx.x >> 5; grp < groups; grp += blockDim.x >> 5) {
        const int r = grp * per_warp + sub;
        const bool row_ok = r < cnt;
        const int32_t* pat_row = pat_s + r * w_out;
        T* acc_row = acc + r * w_out;
        int a = 0, m = 0;                // step and pass of element s0
        for (int s0 = 0; s0 < total; s0 += kUnroll) {
            int64_t idx[kUnroll];
            T av[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int b = q + (m << lg);
                idx[u] = -1;
                av[u] = T(0);
                if (row_ok && s0 + u < total && b < w_b) {
                    T v;
                    int64_t j;
                    if constexpr (kBanded) {
                        v = adia[a * rows + r];
                        j = i0 + r + offs_s[a];
                    } else {
                        v = ad_s[r * w_a + a];
                        j = ac_s[r * w_a + a];
                    }
                    if (v != T(0) && j >= 0 && j < nb) {
                        idx[u] = j * w_b + b;
                        av[u] = v;
                    }
                }
                if (++m == passes) {
                    m = 0;
                    ++a;
                }
            }
            int32_t col[kUnroll];
            T bv[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                col[u] = -1;
                bv[u] = T(0);
                if (idx[u] >= 0) {
                    col[u] = __ldg(bc + idx[u]);
                    bv[u] = __ldg(bd + idx[u]);
                }
            }
            int o[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                // a zero B slot (padding, which may alias a stored column
                // of the row) adds nothing and must not touch acc
                o[u] = bv[u] != T(0) ? find_slot(pat_row, w_out, col[u]) : -1;
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                if (o[u] >= 0) {
                    acc_row[o[u]] = add_rn(acc_row[o[u]],
                                           mul_rn(av[u], bv[u]));
                }
                if (g > 1) __syncwarp();
            }
        }
    }
}

// One tile's products with a thread to a row and the row's pattern (at most
// W slots) and sums in registers: every compare of a product with the
// pattern is unrolled, so the loop touches shared memory only for A.  The
// sums go to acc for the block's coalesced store.
template <typename T, bool kBanded, int W>
__device__ __forceinline__ void accumulate_rows(
    const T* ad_s, const int32_t* ac_s, const int32_t* pat_s, const T* adia,
    const int32_t* offs_s, int k, T* acc, int w_a, int64_t i0, int cnt,
    int rows, const T* __restrict__ bd, const int32_t* __restrict__ bc,
    int w_b, int64_t nb, int w_out) {
    const int steps = kBanded ? k : w_a;
    // the wider patterns come with wider B rows (level-0 R*AP: 6 slots),
    // which then load in one chunk a step; narrow ones keep registers low
    constexpr int kChunk = W > 8 ? 2 * kRowUnroll : kRowUnroll;
    for (int r = threadIdx.x; r < cnt; r += blockDim.x) {
        int32_t p[W];
        T s[W];
#pragma unroll
        for (int o = 0; o < W; ++o) {
            p[o] = o < w_out ? pat_s[r * w_out + o] : -1;
            s[o] = T(0);
        }
        for (int a = 0; a < steps; ++a) {
            T v;
            int64_t j;
            if constexpr (kBanded) {
                v = adia[a * rows + r];
                j = i0 + r + offs_s[a];
            } else {
                v = ad_s[r * w_a + a];
                j = ac_s[r * w_a + a];
            }
            if (v == T(0) || j < 0 || j >= nb) continue;
            const int32_t* bcr = bc + j * w_b;
            const T* bdr = bd + j * w_b;
            for (int b0 = 0; b0 < w_b; b0 += kChunk) {
                int32_t c[kChunk];
                T x[kChunk];
#pragma unroll
                for (int u = 0; u < kChunk; ++u) {
                    const bool in = b0 + u < w_b;
                    c[u] = in ? __ldg(bcr + b0 + u) : -1;
                    x[u] = in ? __ldg(bdr + b0 + u) : T(0);
                }
#pragma unroll
                for (int u = 0; u < kChunk; ++u) {
                    // a zero B slot (padding) adds nothing
                    if (x[u] == T(0)) continue;
                    const T prod = mul_rn(v, x[u]);
#pragma unroll
                    for (int o = 0; o < W; ++o) {
                        if (c[u] == p[o]) s[o] = add_rn(s[o], prod);
                    }
                }
            }
        }
#pragma unroll
        for (int o = 0; o < W; ++o) {
            if (o < w_out) acc[r * w_out + o] = s[o];
        }
    }
}

// W > 0: a thread to a row, the row's pattern and sums in registers (a
// pattern at most W wide); W = 0: lanes of a row meet in shared memory.
// Each is a kernel of its own, so each keeps its own register count.
template <typename T, bool kBanded, int W>
__global__ void __launch_bounds__(kTileThreads)
masked_spgemm_tiled_kernel(const T* __restrict__ ad,
                           const int32_t* __restrict__ ac, int w_a, int64_t n,
                           const T* __restrict__ bd,
                           const int32_t* __restrict__ bc, int w_b,
                           int64_t nb, const int32_t* __restrict__ pat,
                           int w_out, T* __restrict__ out, int rows, int lg,
                           Offsets offs) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int k = kBanded ? offs.k : 0;
    const Layout L = tile_layout(rows, w_a, w_out, sizeof(T), k);
    T* acc = reinterpret_cast<T*>(smem + L.acc);
    T* adia = reinterpret_cast<T*>(smem + L.adia);
    int32_t* offs_s = reinterpret_cast<int32_t*>(smem + L.offs);
    const int tid = threadIdx.x, nt = blockDim.x;
    for (int x = tid; x < rows * w_out; x += nt) acc[x] = T(0);
    if constexpr (kBanded) {
        for (int x = tid; x < k; x += nt) offs_s[x] = offs.v[x];
    }

    const int64_t tiles = (n + rows - 1) / rows;
    int64_t tile = blockIdx.x;
    if (tile < tiles) {
        stage_tile(smem, L, ad, ac, w_a, pat, w_out, tile * rows,
                   min64(rows, n - tile * rows));
    }
    cp_async_commit();
    for (int buf = 0; tile < tiles; tile += gridDim.x, buf ^= 1) {
        const int64_t next = tile + gridDim.x;
        if (next < tiles) {
            stage_tile(smem + (buf ^ 1) * L.stage, L, ad, ac, w_a, pat, w_out,
                       next * rows, min64(rows, n - next * rows));
        }
        cp_async_commit();
        cp_async_wait<1>();          // this tile's stage has landed
        __syncthreads();

        const int64_t i0 = tile * rows;
        const int cnt = static_cast<int>(min64(rows, n - i0));
        unsigned char* stage = smem + buf * L.stage;
        const T* ad_s = staged<T>(stage + L.ad, ad + i0 * w_a);
        const int32_t* ac_s = staged<int32_t>(stage + L.ac, ac + i0 * w_a);
        const int32_t* pat_s = staged<int32_t>(stage + L.pat,
                                               pat + i0 * w_out);
        if constexpr (kBanded) {
            // A by diagonal, once per (row, offset), a thread to a row; zero
            // slots (padding) are skipped, so no two slots write one entry
            for (int r = tid; r < cnt; r += nt) {
                for (int kk = 0; kk < k; ++kk) adia[kk * rows + r] = T(0);
                for (int a = 0; a < w_a; ++a) {
                    const T v = ad_s[r * w_a + a];
                    if (v == T(0)) continue;
                    const int kk = find_offset(
                        offs_s, k, int64_t(ac_s[r * w_a + a]) - (i0 + r));
                    if (kk >= 0) adia[kk * rows + r] = v;
                }
            }
            __syncthreads();
        }
        if constexpr (W > 0) {
            accumulate_rows<T, kBanded, W>(ad_s, ac_s, pat_s, adia, offs_s, k,
                                           acc, w_a, i0, cnt, rows, bd, bc,
                                           w_b, nb, w_out);
        } else {
            accumulate_tile<T, kBanded>(ad_s, ac_s, pat_s, adia, offs_s, k,
                                        acc, w_a, i0, cnt, rows, bd, bc, w_b,
                                        nb, w_out, lg);
        }
        __syncthreads();
        T* out_t = out + i0 * w_out;
        for (int x = tid; x < cnt * w_out; x += nt) {
            out_t[x] = acc[x];
            acc[x] = T(0);
        }
        __syncthreads();             // before the next stage reuses buf
    }
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// the slotwise bodies: one thread per output slot (measurement comparators)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_spgemm_gather_slotwise_kernel(const T* __restrict__ ad,
                                     const int32_t* __restrict__ ac, int w_a,
                                     int64_t n, const T* __restrict__ bd,
                                     const int32_t* __restrict__ bc, int w_b,
                                     int64_t nb,
                                     const int32_t* __restrict__ pat,
                                     int w_out, T* __restrict__ out) {
    const int64_t total = n * w_out;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
         t < total; t += stride) {
        const int64_t i = t / w_out;
        const int32_t p = __ldg(pat + t);
        T acc = T(0);
        if (p >= 0) {
            const T* arow = ad + i * w_a;
            const int32_t* acol = ac + i * w_a;
            for (int a = 0; a < w_a; ++a) {
                const int64_t j = __ldg(acol + a);
                // a padding slot may name a row past B's end (its own row
                // index); its data is 0, so it contributes nothing
                if (j < 0 || j >= nb) continue;
                const T av = __ldg(arow + a);
                const int32_t* brow_c = bc + j * w_b;
                const T* brow_d = bd + j * w_b;
                T s = T(0);
                for (int b = 0; b < w_b; ++b) {
                    if (__ldg(brow_c + b) == p) s += av * __ldg(brow_d + b);
                }
                acc += s;
            }
        }
        out[t] = acc;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_spgemm_banded_slotwise_kernel(const T* __restrict__ ad,
                                     const int32_t* __restrict__ ac, int w_a,
                                     int64_t n, const T* __restrict__ bd,
                                     const int32_t* __restrict__ bc, int w_b,
                                     int64_t nb,
                                     const int32_t* __restrict__ pat,
                                     int w_out, T* __restrict__ out,
                                     Offsets offs) {
    const int64_t total = n * w_out;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
         t < total; t += stride) {
        const int64_t i = t / w_out;
        const int32_t p = __ldg(pat + t);
        T acc = T(0);
        if (p >= 0) {
            const T* arow = ad + i * w_a;
            const int32_t* acol = ac + i * w_a;
            for (int kk = 0; kk < offs.k; ++kk) {
                const int delta = offs.v[kk];
                const int64_t j = i + delta;
                if (j < 0 || j >= nb) continue;
                // A's value on diagonal delta, re-derived from its slab
                T val = T(0);
                for (int a = 0; a < w_a; ++a) {
                    if (static_cast<int64_t>(__ldg(acol + a)) - i == delta) {
                        val += __ldg(arow + a);
                    }
                }
                if (val == T(0)) continue;      // contributes exactly 0
                const int32_t* brow_c = bc + j * w_b;
                const T* brow_d = bd + j * w_b;
                T s = T(0);
                for (int b = 0; b < w_b; ++b) {
                    if (__ldg(brow_c + b) == p) s += val * __ldg(brow_d + b);
                }
                acc += s;
            }
        }
        out[t] = acc;
    }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

cudaError_t use_device(int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return err;
    if (current != device) return cudaSetDevice(device);
    return cudaSuccess;
}

unsigned blocks_for(int64_t work) {
    int64_t blocks = (work + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    return static_cast<unsigned>(blocks);
}

bool offsets_from(const int32_t* offsets, int k, Offsets* offs) {
    if (k < 0 || k > kMaxOffsets) return false;
    offs->k = k;
    for (int kk = 0; kk < k; ++kk) offs->v[kk] = offsets[kk];
    return true;
}

template <typename T, bool kBanded>
int launch_tiled(const void* ad, const void* ac, int w_a, int64_t n,
                 const void* bd, const void* bc, int w_b, int64_t nb,
                 const void* pat, int w_out, void* out,
                 const int32_t* offsets, int k, int rows, int lanes_log2,
                 int threads, int blocks, void* stream, int device,
                 void* ev_start, void* ev_end) {
    Offsets offs{};
    if (!offsets_from(offsets, kBanded ? k : 0, &offs) || rows < 1
        || rows > kMaxTileRows || lanes_log2 < 0 || lanes_log2 > 5
        || threads < 32 || threads > kTileThreads || threads % 32 != 0
        || blocks < 1 || w_a < 0 || w_b < 0 || w_out < 0) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const Layout L = tile_layout(rows, w_a, w_out, sizeof(T), offs.k);
    if (L.total > kMaxSharedBytes) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || w_out <= 0) return static_cast<int>(cudaSuccess);
    auto kernel = masked_spgemm_tiled_kernel<T, kBanded, 0>;
    if (lanes_log2 == 0 && w_out <= 8) {
        kernel = masked_spgemm_tiled_kernel<T, kBanded, 8>;
    } else if (lanes_log2 == 0 && w_out <= 16) {
        kernel = masked_spgemm_tiled_kernel<T, kBanded, 16>;
    } else if (lanes_log2 == 0 && w_out <= 32) {
        kernel = masked_spgemm_tiled_kernel<T, kBanded, 32>;
    }
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L.total));
    if (err != cudaSuccess) return static_cast<int>(err);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (ev_start != nullptr) {
        err = cudaEventRecord(static_cast<cudaEvent_t>(ev_start), s);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    kernel<<<blocks, threads, L.total, s>>>(
        static_cast<const T*>(ad), static_cast<const int32_t*>(ac), w_a, n,
        static_cast<const T*>(bd), static_cast<const int32_t*>(bc), w_b, nb,
        static_cast<const int32_t*>(pat), w_out, static_cast<T*>(out), rows,
        lanes_log2, offs);
    err = cudaGetLastError();
    if (err == cudaSuccess && ev_end != nullptr) {
        err = cudaEventRecord(static_cast<cudaEvent_t>(ev_end), s);
    }
    return static_cast<int>(err);
}

template <typename T>
int launch_gather_slotwise(const void* ad, const void* ac, int w_a,
                           int64_t n, const void* bd, const void* bc,
                           int w_b, int64_t nb, const void* pat, int w_out,
                           void* out, void* stream, int device) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || w_out <= 0) return static_cast<int>(cudaSuccess);
    masked_spgemm_gather_slotwise_kernel<T>
        <<<blocks_for(n * w_out), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(ad), static_cast<const int32_t*>(ac), w_a,
            n, static_cast<const T*>(bd), static_cast<const int32_t*>(bc),
            w_b, nb, static_cast<const int32_t*>(pat), w_out,
            static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded_slotwise(const void* ad, const void* ac, int w_a,
                           int64_t n, const void* bd, const void* bc,
                           int w_b, int64_t nb, const void* pat, int w_out,
                           void* out, const int32_t* offsets, int k,
                           void* stream, int device) {
    Offsets offs{};
    if (!offsets_from(offsets, k, &offs)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || w_out <= 0) return static_cast<int>(cudaSuccess);
    masked_spgemm_banded_slotwise_kernel<T>
        <<<blocks_for(n * w_out), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
            static_cast<const T*>(ad), static_cast<const int32_t*>(ac), w_a,
            n, static_cast<const T*>(bd), static_cast<const int32_t*>(bc),
            w_b, nb, static_cast<const int32_t*>(pat), w_out,
            static_cast<T*>(out), offs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared bytes a tiled launch asks for (k = 0 for the gather kernel).
extern "C" int64_t masked_spgemm_shared_bytes(int rows, int w_a, int w_out,
                                              int itemsize, int k) {
    return tile_layout(rows, w_a, w_out, itemsize, k).total;
}

extern "C" int masked_spgemm_gather_f32(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, int rows, int lanes_log2, int threads, int blocks,
    void* stream, int device, void* ev_start, void* ev_end) {
    return launch_tiled<float, false>(ad, ac, w_a, n, bd, bc, w_b, nb, pat,
                                      w_out, out, nullptr, 0, rows,
                                      lanes_log2, threads, blocks, stream,
                                      device, ev_start, ev_end);
}

extern "C" int masked_spgemm_gather_f64(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, int rows, int lanes_log2, int threads, int blocks,
    void* stream, int device, void* ev_start, void* ev_end) {
    return launch_tiled<double, false>(ad, ac, w_a, n, bd, bc, w_b, nb, pat,
                                       w_out, out, nullptr, 0, rows,
                                       lanes_log2, threads, blocks, stream,
                                       device, ev_start, ev_end);
}

extern "C" int masked_spgemm_banded_f32(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, const int32_t* offsets, int k, int rows, int lanes_log2,
    int threads, int blocks, void* stream, int device, void* ev_start,
    void* ev_end) {
    return launch_tiled<float, true>(ad, ac, w_a, n, bd, bc, w_b, nb, pat,
                                     w_out, out, offsets, k, rows,
                                     lanes_log2, threads, blocks, stream,
                                     device, ev_start, ev_end);
}

extern "C" int masked_spgemm_banded_f64(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, const int32_t* offsets, int k, int rows, int lanes_log2,
    int threads, int blocks, void* stream, int device, void* ev_start,
    void* ev_end) {
    return launch_tiled<double, true>(ad, ac, w_a, n, bd, bc, w_b, nb, pat,
                                      w_out, out, offsets, k, rows,
                                      lanes_log2, threads, blocks, stream,
                                      device, ev_start, ev_end);
}

extern "C" int masked_spgemm_gather_slotwise_f32(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, void* stream, int device) {
    return launch_gather_slotwise<float>(ad, ac, w_a, n, bd, bc, w_b, nb,
                                         pat, w_out, out, stream, device);
}

extern "C" int masked_spgemm_gather_slotwise_f64(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, void* stream, int device) {
    return launch_gather_slotwise<double>(ad, ac, w_a, n, bd, bc, w_b, nb,
                                          pat, w_out, out, stream, device);
}

extern "C" int masked_spgemm_banded_slotwise_f32(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, const int32_t* offsets, int k, void* stream, int device) {
    return launch_banded_slotwise<float>(ad, ac, w_a, n, bd, bc, w_b, nb,
                                         pat, w_out, out, offsets, k, stream,
                                         device);
}

extern "C" int masked_spgemm_banded_slotwise_f64(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, const int32_t* offsets, int k, void* stream, int device) {
    return launch_banded_slotwise<double>(ad, ac, w_a, n, bd, bc, w_b, nb,
                                          pat, w_out, out, offsets, k, stream,
                                          device);
}
