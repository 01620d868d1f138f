// DIA sparse matrix-vector product in 1-D tiles over a zero-padded copy of
// x, for NVIDIA Hopper (sm_90a).
//
//   y[i] = sum_k diags[k, i] * xpad[halo + i + offsets[k]],   0 <= i < n,
//
// where xpad = [halo zeros | x | halo zeros] and halo >= max |offsets[k]|:
// the square DIA SpMV with zero wherever i + offsets[k] falls outside
// [0, n).  diags is (k, n) row-major.
//
// Replaces pyamg_tpu/sparse/pallas_kernels.py::dia_matvec_pallas_v1, the
// TPU kernel that pads x with one 65536-element tile of zeros on each side
// and has each grid step read the tiles before, at and after its own, so
// that it is valid for |offset| <= 65536.  Here the wrapper sizes the
// margins from the offsets themselves (halo = max |offset|), so no offset
// can fall outside them and the kernel has no domain limit; within the TPU
// kernel's domain the two give the same values.
//
// What bounds it on this card: HBM bytes.  The function moves (k+2)*n*4
// bytes (diagonals, x, y) against 2*k*n flops; the padded copy the wrapper
// builds before the launch adds ~2*n*4 bytes more, and its time is counted
// in this kernel's, as the TPU kernel paid for its own padded copy.
//
// What the design does about it:
//  * a block owns a tile of kTile consecutive rows; each thread keeps
//    kItems rows kThreads apart, so a warp's loads of a diagonal and of a
//    shifted window of xpad are coalesced, and each thread has kItems
//    independent loads in flight per offset;
//  * the padded copy removes the bound check from the inner loop (the
//    difference from dia_matvec.cu, which checks every entry): only the
//    ragged last tile checks its rows;
//  * the offsets arrive as a kernel argument (the constant bank).
// Accumulation is in float32, in offset order, each product rounded before
// it is added (no fused multiply-add), like the plain PyTorch twin.
//
// The launcher runs on the caller's stream, allocates nothing, and returns
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kMaxOffsets = 128;

struct Offsets {
    int v[kMaxOffsets];
};

__global__ void __launch_bounds__(kThreads)
dia_matvec_v1_kernel(const float* __restrict__ diags, const Offsets offs,
                     int k, int64_t n, const float* __restrict__ xpad,
                     int64_t halo, float* __restrict__ y) {
    const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kTile
                       + threadIdx.x;
    float acc[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) acc[j] = 0.0f;
    if (i0 + (kItems - 1) * kThreads < n) {        // a whole tile
        for (int kk = 0; kk < k; ++kk) {
            const float* d = diags + static_cast<int64_t>(kk) * n + i0;
            const float* xs = xpad + halo + offs.v[kk] + i0;
#pragma unroll
            for (int j = 0; j < kItems; ++j)
                acc[j] = __fadd_rn(acc[j], __fmul_rn(__ldg(d + j * kThreads),
                                                     __ldg(xs + j * kThreads)));
        }
#pragma unroll
        for (int j = 0; j < kItems; ++j) y[i0 + j * kThreads] = acc[j];
    } else {                                        // the ragged last tile
        for (int kk = 0; kk < k; ++kk) {
            const float* d = diags + static_cast<int64_t>(kk) * n + i0;
            const float* xs = xpad + halo + offs.v[kk] + i0;
#pragma unroll
            for (int j = 0; j < kItems; ++j)
                if (i0 + j * kThreads < n)
                    acc[j] = __fadd_rn(acc[j],
                                       __fmul_rn(__ldg(d + j * kThreads),
                                                 __ldg(xs + j * kThreads)));
        }
#pragma unroll
        for (int j = 0; j < kItems; ++j)
            if (i0 + j * kThreads < n) y[i0 + j * kThreads] = acc[j];
    }
}

}  // namespace

extern "C" int dia_matvec_v1_f32(const void* diags, const int32_t* offsets,
                                 int k, int64_t n, const void* xpad,
                                 int64_t halo, void* y, void* stream,
                                 int device) {
    if (k < 0 || k > kMaxOffsets || halo < 0)
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
    for (int kk = 0; kk < k; ++kk) {
        if (offsets[kk] > halo || -static_cast<int64_t>(offsets[kk]) > halo)
            return static_cast<int>(cudaErrorInvalidValue);
        offs.v[kk] = offsets[kk];
    }
    const int64_t blocks = (n + kTile - 1) / kTile;
    dia_matvec_v1_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(diags), offs, k, n,
        static_cast<const float*>(xpad), halo, static_cast<float*>(y));
    return static_cast<int>(cudaGetLastError());
}
