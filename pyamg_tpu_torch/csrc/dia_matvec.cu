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

template <typename TD, typename T>
int launch(const void* diags, const void* offsets, int k, int64_t n,
           int64_t m, const void* x, void* y, void* stream, int device) {
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (n <= 0) return static_cast<int>(cudaSuccess);
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    dia_matvec_kernel<TD, T><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const TD*>(diags), static_cast<const int32_t*>(offsets),
        k, n, m, static_cast<const T*>(x), static_cast<T*>(y));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dia_matvec_f32(const void* diags, const void* offsets, int k,
                              int64_t n, int64_t m, const void* x, void* y,
                              void* stream, int device) {
    return launch<float, float>(diags, offsets, k, n, m, x, y, stream,
                                device);
}

extern "C" int dia_matvec_f64(const void* diags, const void* offsets, int k,
                              int64_t n, int64_t m, const void* x, void* y,
                              void* stream, int device) {
    return launch<double, double>(diags, offsets, k, n, m, x, y, stream,
                                  device);
}

extern "C" int dia_matvec_bf16_f32(const void* diags, const void* offsets,
                                   int k, int64_t n, int64_t m, const void* x,
                                   void* y, void* stream, int device) {
    return launch<__nv_bfloat16, float>(diags, offsets, k, n, m, x, y,
                                        stream, device);
}

extern "C" int dia_matvec_c64(const void* diags, const void* offsets, int k,
                              int64_t n, int64_t m, const void* x, void* y,
                              void* stream, int device) {
    return launch<float2, float2>(diags, offsets, k, n, m, x, y, stream,
                                  device);
}

extern "C" int dia_matvec_c128(const void* diags, const void* offsets, int k,
                               int64_t n, int64_t m, const void* x, void* y,
                               void* stream, int device) {
    return launch<double2, double2>(diags, offsets, k, n, m, x, y, stream,
                                    device);
}
