// DIA sparse matrix-vector product for NVIDIA Hopper (sm_90a).
//
//   y[i] = sum_k diags[k, i] * x[i + offsets[k]],  zero where i + offsets[k]
//   falls outside [0, m);  diags is (k, n) row-major, x has m entries, y n.
//
// Replaces pyamg_tpu/sparse/pallas_kernels.py::dia_matvec_pallas, the
// TPU kernel behind every SparseDIA matvec of the structured SA solve: each
// level's A, the prolongation smoother S and its transpose inside P and R,
// and the float64 fine operator of the mixed-precision outer residual.
// Five instantiations: float32, float64, bfloat16 diagonals with a float32
// x and y (the JAX package's DIA benchmark runs its kernel on that pair to
// halve the diagonals' bytes), and complex64 and complex128 (interleaved
// real and imaginary parts, as PyTorch stores them, read as float2 and
// double2), which the JAX package sends through its shift-multiply-add form.
//
// What bounds it on this card: HBM bytes.  A call reads the k diagonals once
// (k*n*itemsize), x about once and writes y once: ~(k+2)*n*itemsize bytes
// ((2k+8)*n for bfloat16 diagonals) against 2*k*n flops, i.e. 1/4 flop per
// byte in float32 -- two orders of magnitude below the H100's ratio of
// compute to bandwidth.
//
// What the design does about it:
//  * one thread per output row in a grid-stride loop, so a warp reads 32
//    consecutive entries of each diagonal and of each shifted window of x:
//    every load is coalesced, and no byte of diags is read twice;
//  * the k shifted windows of x overlap (a stencil's offsets are small or
//    repeat a grid stride), so after the first diagonal x is served from L1
//    and L2 rather than HBM: x costs ~n*itemsize of HBM traffic, not k*n;
//  * read-only loads go through the non-coherent cache (__ldg);
//  * the offsets live in a small device array that every thread of a warp
//    reads at the same address (a broadcast); the row bound c in [0, m) is
//    checked per entry, so rectangular operators need no padded copy of x
//    (the TPU kernel and the XLA formulation build one per call).
// Accumulation is in x's type, in offset order, each product rounded before
// it is added (no fused multiply-add), like the reference and the plain
// PyTorch twin; a bfloat16 diagonal is widened to float32 exactly on load.
// A complex product is (ar*br - ai*bi, ar*bi + ai*br), its four real products
// and two sums each rounded, then added to the sum part by part.
//
// That is the tall route, and it needs rows to fill the card: 132 SMs hold
// 270,336 threads.  A coarse level of few rows and many offsets (4,096 rows
// x 179 offsets: 16 blocks on 132 SMs) leaves it idle, each thread walking
// its offsets one dependent add after another, bound by load latency.  The
// wide route spreads (row, offset) pairs over the threads instead:
//  * a block of 512 threads owns a tile of R consecutive rows and walks the
//    offsets in chunks of C; L = 512 / R threads serve each row, and
//    thread t takes row t % R, so a warp reads 32 consecutive rows of one
//    diagonal (R >= 32), or R rows of 32 / R diagonals: loads stay
//    coalesced along i and independent.  R is the smallest power of two
//    from 4 up that keeps the grid within 4 blocks an SM (528), and at
//    least 512 over k rounded up to a power of two, so that no lane of a
//    short stencil idles: few rows get many lanes a row (every thread a
//    few products, all in flight at once), more rows get more rows a
//    block, and with them more summing warps an SM;
//  * each thread forms its products, rounded as the tall route rounds
//    them (the complex forms of mul_add), and stores them in shared memory
//    offset-major, tile[j * R + r];
//  * after a barrier the first R threads add their row's products in
//    offset order, carrying the sum from chunk to chunk: the same additions
//    in the same order as the tall route, so both routes, and the plain
//    twin, agree bitwise in the real types.  An out-of-range column stores
//    +0, and adding +0 leaves a sum that starts at +0 unchanged bit for bit
//    (a round-to-nearest sum is -0 only when both terms are), which is the
//    tall route's skip;
//  * the tile is 32 KB whatever the type (C = 32 KB / (R * sizeof(T)):
//    at R = 8, 1,024 float32 products a row, 256 complex128), static
//    shared memory under the 48 KB that needs no opt-in, beside the
//    chunk's offsets (8 KB at most), which the block stages first; up to
//    4 blocks share an SM.
// At 4,096 rows x 179 offsets: R = 8, 512 blocks of 512 threads, every
// (row, offset) load in flight at once, then 179 shared-memory adds a row;
// at 32,768 rows: R = 64, 512 blocks, two summing warps a block.
// The launcher chooses the route from (n, k) -- see choose_route -- so the
// wrapper adds nothing per call; an explicit route argument lets a timing
// harness run either route on one shape.
//
// The launcher runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 8 resident blocks of 256 threads fill an SM's 2048 thread slots; 132 SMs.
constexpr int64_t kMaxBlocks = 132 * 8;

// A diagonal entry in the accumulator's type.
__device__ __forceinline__ float widen(const float* p) { return __ldg(p); }
__device__ __forceinline__ double widen(const double* p) { return __ldg(p); }
__device__ __forceinline__ float widen(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ float2 widen(const float2* p) { return __ldg(p); }
__device__ __forceinline__ double2 widen(const double2* p) {
    return __ldg(p);
}

template <typename T> __device__ __forceinline__ T zero() { return T(0); }
template <> __device__ __forceinline__ float2 zero<float2>() {
    return make_float2(0.f, 0.f);
}
template <> __device__ __forceinline__ double2 zero<double2>() {
    return make_double2(0., 0.);
}

// acc + a * b with the product rounded first, as two PyTorch ops round it.
__device__ __forceinline__ float mul_add(float acc, float a, float b) {
    return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ double mul_add(double acc, double a, double b) {
    return __dadd_rn(acc, __dmul_rn(a, b));
}

__device__ __forceinline__ float2 mul_add(float2 acc, float2 a, float2 b) {
    const float re = __fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
    const float im = __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x));
    return make_float2(__fadd_rn(acc.x, re), __fadd_rn(acc.y, im));
}
__device__ __forceinline__ double2 mul_add(double2 acc, double2 a,
                                           double2 b) {
    const double re = __dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y));
    const double im = __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x));
    return make_double2(__dadd_rn(acc.x, re), __dadd_rn(acc.y, im));
}

// TD: the diagonals' type; T: the type of x, y and the sum.
template <typename TD, typename T>
__global__ void __launch_bounds__(kThreads)
dia_matvec_kernel(const TD* __restrict__ diags,
                  const int32_t* __restrict__ offsets, int k, int64_t n,
                  int64_t m, const T* __restrict__ x, T* __restrict__ y) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
         i < n; i += stride) {
        T acc = zero<T>();
        for (int kk = 0; kk < k; ++kk) {
            const int64_t c = i + static_cast<int64_t>(__ldg(offsets + kk));
            if (c >= 0 && c < m) {
                acc = mul_add(acc,
                              widen(diags + static_cast<int64_t>(kk) * n + i),
                              __ldg(x + c));
            }
        }
        y[i] = acc;
    }
}

// The wide route's helpers: a product and a sum, each rounded, in the
// arithmetic of mul_add.
__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float2 mul(float2 a, float2 b) {
    return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}
__device__ __forceinline__ double2 mul(double2 a, double2 b) {
    return make_double2(
        __dsub_rn(__dmul_rn(a.x, b.x), __dmul_rn(a.y, b.y)),
        __dadd_rn(__dmul_rn(a.x, b.y), __dmul_rn(a.y, b.x)));
}

__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float2 add(float2 a, float2 b) {
    return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ double2 add(double2 a, double2 b) {
    return make_double2(__dadd_rn(a.x, b.x), __dadd_rn(a.y, b.y));
}

constexpr int kRouteAuto = 0;
constexpr int kRouteTall = 1;
constexpr int kRouteWide = 2;

constexpr int kWideThreads = 512;
constexpr int kWideMinRows = 4;            // rows a block, at least
constexpr int kWideBlocks = 132 * 4;       // 4 blocks of 512 fill an SM
constexpr int kWideTileBytes = 32 * 1024;  // staged products a block
// the most offsets a chunk holds: 4 rows of 4-byte products
constexpr int kWideMaxChunk = kWideTileBytes / (kWideMinRows * 4);

// Rows a block and offsets a chunk of the wide route for an (n, k)
// operator with itemsize-byte products.
struct WideGeometry {
    int rows, chunk;
};

inline WideGeometry wide_geometry(int64_t n, int k, int itemsize) {
    int kp = 1;                               // k rounded up to a power of 2
    while (kp < k && kp < kWideThreads) kp *= 2;
    int rows = kWideMinRows;
    while (rows < kWideThreads
           && (rows * kp < kWideThreads
               || (n + rows - 1) / rows > kWideBlocks)) {
        rows *= 2;
    }
    return {rows, kWideTileBytes / (rows * itemsize)};
}

// The route for an (n, k) operator: wide where the tall route's thread a
// row cannot fill the card and its chain of k dependent adds a thread is
// long.  Up to kWideLimits[b].rows rows, the wide route from
// kWideLimits[b].offsets offsets on; above the last, tall.  The limits are
// the crossovers that pyamg_tpu_torch/benchmarks/dia_route_sweep.py
// measured on an H100, the same in float32 and float64.
struct WideLimit {
    int64_t rows;
    int offsets;
};
constexpr WideLimit kWideLimits[] = {
    {8192, 7}, {16384, 16}, {32768, 21}, {65536, 111}};

inline int choose_route(int64_t n, int k) {
    for (const WideLimit& limit : kWideLimits) {
        if (n <= limit.rows) {
            return k >= limit.offsets ? kRouteWide : kRouteTall;
        }
    }
    return kRouteTall;
}

template <typename TD, typename T>
__global__ void __launch_bounds__(kWideThreads)
dia_matvec_wide_kernel(const TD* __restrict__ diags,
                       const int32_t* __restrict__ offsets, int k, int64_t n,
                       int64_t m, const T* __restrict__ x, T* __restrict__ y,
                       int rows, int chunk) {
    __shared__ __align__(16) unsigned char tile_bytes[kWideTileBytes];
    __shared__ int32_t chunk_offsets[kWideMaxChunk];
    T* tile = reinterpret_cast<T*>(tile_bytes);
    const int lanes = kWideThreads / rows;
    const int r = threadIdx.x % rows;
    const int lane = threadIdx.x / rows;
    const int64_t i = static_cast<int64_t>(blockIdx.x) * rows + r;
    const bool live = i < n;
    T acc = zero<T>();
    for (int k0 = 0; k0 < k; k0 += chunk) {
        const int width = min(chunk, k - k0);
        for (int j = threadIdx.x; j < width; j += kWideThreads) {
            chunk_offsets[j] = __ldg(offsets + k0 + j);
        }
        __syncthreads();
        if (live) {
#pragma unroll 4
            for (int j = lane; j < width; j += lanes) {
                const int64_t c = i + static_cast<int64_t>(chunk_offsets[j]);
                T p = zero<T>();
                if (c >= 0 && c < m) {
                    p = mul(widen(diags + static_cast<int64_t>(k0 + j) * n
                                  + i),
                            __ldg(x + c));
                }
                tile[j * rows + r] = p;
            }
        }
        __syncthreads();
        if (lane == 0 && live) {
#pragma unroll 16
            for (int j = 0; j < width; ++j) acc = add(acc, tile[j * rows + r]);
        }
        __syncthreads();
    }
    if (lane == 0 && live) y[i] = acc;
}

template <typename TD, typename T>
int launch(const void* diags, const void* offsets, int k, int64_t n,
           int64_t m, const void* x, void* y, void* stream, int device,
           int route) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (n <= 0) return static_cast<int>(cudaSuccess);
    if (route == kRouteAuto) route = choose_route(n, k);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (route == kRouteTall) {
        int64_t blocks = (n + kThreads - 1) / kThreads;
        if (blocks > kMaxBlocks) blocks = kMaxBlocks;
        dia_matvec_kernel<TD, T><<<static_cast<unsigned>(blocks), kThreads,
                                   0, s>>>(
            static_cast<const TD*>(diags),
            static_cast<const int32_t*>(offsets), k, n, m,
            static_cast<const T*>(x), static_cast<T*>(y));
    } else if (route == kRouteWide) {
        const WideGeometry g = wide_geometry(n, k, sizeof(T));
        const int64_t blocks = (n + g.rows - 1) / g.rows;
        if (blocks > 0x7fffffff)
            return static_cast<int>(cudaErrorInvalidConfiguration);
        dia_matvec_wide_kernel<TD, T><<<static_cast<unsigned>(blocks),
                                        kWideThreads, 0, s>>>(
            static_cast<const TD*>(diags),
            static_cast<const int32_t*>(offsets), k, n, m,
            static_cast<const T*>(x), static_cast<T*>(y), g.rows, g.chunk);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 0 chooses from (n, k) as the port does, 1 forces the tall route,
// 2 the wide one (for timing both on one shape); any other value refuses.
#define DIA_ENTRY(name, TD, T)                                              \
    extern "C" int name(const void* diags, const void* offsets, int k,     \
                        int64_t n, int64_t m, const void* x, void* y,      \
                        void* stream, int device, int route) {             \
        return launch<TD, T>(diags, offsets, k, n, m, x, y, stream, device, \
                             route);                                       \
    }

DIA_ENTRY(dia_matvec_f32, float, float)
DIA_ENTRY(dia_matvec_f64, double, double)
DIA_ENTRY(dia_matvec_bf16_f32, __nv_bfloat16, float)
DIA_ENTRY(dia_matvec_c64, float2, float2)
DIA_ENTRY(dia_matvec_c128, double2, double2)

// What the launcher decides, for the wrapper's tests: the route that
// route 0 takes (1 tall, 2 wide), and the wide route's rows a block and
// offsets a chunk, for itemsize-byte products.
extern "C" int dia_matvec_route(int64_t n, int k) {
    return choose_route(n, k);
}

extern "C" int dia_matvec_wide_rows(int64_t n, int k, int itemsize) {
    return wide_geometry(n, k, itemsize).rows;
}

extern "C" int dia_matvec_wide_chunk(int64_t n, int k, int itemsize) {
    return wide_geometry(n, k, itemsize).chunk;
}
