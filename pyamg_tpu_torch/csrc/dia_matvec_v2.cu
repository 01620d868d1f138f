// DIA sparse matrix-vector product over a (rows, 128) view of x, for NVIDIA
// Hopper (sm_90a).
//
//   y[i] = sum_k diags[k, i] * x[i + offsets[k]],  zero where i + offsets[k]
//   falls outside [0, n);  diags is (k, n) row-major, x and y have n entries.
//
// Replaces pyamg_tpu/sparse/pallas_kernels.py::dia_matvec_pallas_v2, the
// TPU kernel that views x as (R, 128), splits each offset as
// o = q*128 + s (floor division, 0 <= s < 128), reads rows r+q of a halo'd
// VMEM window, and stitches two lane rolls with a select where s != 0.
//
// What bounds it on this card: HBM bytes, as for every DIA SpMV: the
// diagonals once, x once and y once, (k+2)*n*4 bytes against 2*k*n flops.
//
// What the design does about it:
//  * a block owns a tile of `rows` rows x 128 lanes of y and first stages
//    the window of x rows [r0 - H, r0 + rows + H) into shared memory with
//    coalesced loads, zero-filled outside [0, n).  The window is row-major,
//    so row r+q, lane l+s is word (H + r)*128 + l + o, and when l + s runs
//    past 127 the same word is row r+q+1, lane l+s-128: the TPU kernel's
//    two rolls and its select are one shared-memory read at a shifted
//    index.  Neighbouring blocks' windows overlap by 2H rows, which L2
//    serves, so x costs ~n*4 bytes of HBM traffic;
//  * a block owns few rows (the wrapper's plan: 32), so that the grid
//    fills the card: 1,024 blocks at 2048^2 (with 128 rows, a 1024^2 grid
//    made 64 blocks for 132 SMs);
//  * the diagonals stream from global memory, one coalesced read per entry;
//  * H comes from the offsets (the wrapper's plan: the TPU kernel's halo
//    rule), and the window stays within the 227 KB a block may hold: the
//    wrapper refuses offsets whose halo would not fit, so every read is a
//    shared-memory read with no bound check;
//  * the offsets arrive as a kernel argument (the constant bank), read by
//    every thread at the same address.
// Accumulation is in float32, in offset order, each product rounded before
// it is added (no fused multiply-add), like the plain PyTorch twin.
//
// The launcher runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 128;
constexpr int kThreads = 512;                   // 4 rows of 128 lanes a pass
constexpr int kRowsPerPass = kThreads / kLanes;
constexpr int kMaxOffsets = 128;

struct Offsets {
    int v[kMaxOffsets];
};

__global__ void __launch_bounds__(kThreads)
dia_matvec_v2_kernel(const float* __restrict__ diags, const Offsets offs,
                     int k, int64_t n, const float* __restrict__ x,
                     float* __restrict__ y, int rows, int halo) {
    extern __shared__ float win[];              // (rows + 2*halo) x 128
    const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows;
    const int64_t base = (r0 - halo) * kLanes;  // x index of win[0]
    const int wlen = (rows + 2 * halo) * kLanes;
    for (int j = threadIdx.x; j < wlen; j += kThreads) {
        const int64_t g = base + j;
        win[j] = (g >= 0 && g < n) ? __ldg(x + g) : 0.0f;
    }
    __syncthreads();

    const int lane = threadIdx.x % kLanes;
    for (int r = threadIdx.x / kLanes; r < rows; r += kRowsPerPass) {
        const int64_t i = (r0 + r) * kLanes + lane;
        if (i >= n) break;
        const int w = (halo + r) * kLanes + lane;
        float acc = 0.0f;
        for (int kk = 0; kk < k; ++kk)
            acc = __fadd_rn(acc, __fmul_rn(
                __ldg(diags + static_cast<int64_t>(kk) * n + i),
                win[w + offs.v[kk]]));
        y[i] = acc;
    }
}

}  // namespace

extern "C" int dia_matvec_v2_f32(const void* diags, const int32_t* offsets,
                                 int k, int64_t n, const void* x, void* y,
                                 int rows, int halo, void* stream,
                                 int device) {
    if (k < 0 || k > kMaxOffsets || rows < 1 || halo < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int current = -1;
    cudaError_t err = cudaGetDevice(&current);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (current != device) {
        err = cudaSetDevice(device);
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (n <= 0) return static_cast<int>(cudaSuccess);
    Offsets offs{};
    for (int kk = 0; kk < k; ++kk) offs.v[kk] = offsets[kk];
    const size_t smem = static_cast<size_t>(rows + 2 * halo) * kLanes
                        * sizeof(float);
    err = cudaFuncSetAttribute(dia_matvec_v2_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const int64_t R = (n + kLanes - 1) / kLanes;
    const int64_t blocks = (R + rows - 1) / rows;
    dia_matvec_v2_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(diags), offs, k, n,
        static_cast<const float*>(x), static_cast<float*>(y), rows, halo);
    return static_cast<int>(cudaGetLastError());
}
