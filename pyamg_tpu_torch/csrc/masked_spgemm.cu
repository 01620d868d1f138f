// Pattern-masked sparse-sparse product for NVIDIA Hopper (sm_90a).
//
//   out[i, o] = sum_a sum_b Ad[i, a] * Bd[Ac[i, a], b]
//                           * [Bc[Ac[i, a], b] == pat[i, o]]
//
// A (n, w_a), B (nb, w_b) and the output pattern (n, w_out) are padded-ELL
// slabs, row-major.  The pattern's padding slots hold -1 and match nothing;
// A's and B's padding slots hold data 0.  This is the numeric half of the
// device Galerkin setup (S*T, A*P and R*(A*P) of every level); the host
// builds the patterns.
//
// Two kernels, one per TPU kernel they replace:
//  * masked_spgemm_gather replaces pyamg_tpu/sparse/spgemm_pallas.py::
//    _spgemm_pallas (the one-hot MXU kernel, bf16x3, ~1e-5 relative) and
//    serves any A.  It is exact in the input type.
//  * masked_spgemm_banded replaces pyamg_tpu/sparse/spgemm_dia.py::
//    _banded_spgemm and serves a banded A (at most 64 distinct col - row
//    offsets).  It walks the plan's offsets in place of A's column slab,
//    derives A's value on each diagonal from A's slab by compare, as the
//    TPU kernel does, and reads B row i + delta.
//
// What bounds them on this card: loads, not flops.  Each output slot costs
// a few multiply-adds against ~w_a * w_b index and value loads, and the
// products of the setup are a few MB to a few tens of MB, so the working
// set sits in L2 and the rate is set by how the loads coalesce.
//
// What the design does about it:
//  * one thread per output slot (row, o), so no thread needs an array, a
//    search, shared memory or an atomic: it sums over a, then b, in
//    registers and writes its slot once;
//  * slot-major threads (t = row * w_out + o): a warp's pattern reads and
//    output writes are contiguous, and the w_out threads of one row read
//    the same A row and the same B rows (broadcast loads served from L1);
//  * banded: for one offset the rows of a warp read neighbouring B rows
//    i + delta, so those loads coalesce into a line or two, and the
//    offsets arrive as a kernel argument (the constant bank), read by
//    every thread at the same address.  (A first version with row-major
//    threads, o = blockIdx.y, read every slab with a stride of its width
//    and took ~2x the gather kernel's time on a smaller product.)
// Accumulation is in the input type, in A's slot (= offset) order, like the
// plain PyTorch twin (pyamg_tpu_torch/sparse/spgemm_kernel.py).
//
// The launchers run on the caller's stream, allocate nothing, and return
// cudaGetLastError() so that the Python wrapper can raise on a refused
// launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 8 resident blocks of 256 threads fill an SM's 2048 thread slots; 132 SMs.
constexpr int64_t kMaxBlocks = 132 * 8;
constexpr int kMaxOffsets = 64;

struct Offsets {
    int k;
    int v[kMaxOffsets];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_spgemm_gather_kernel(const T* __restrict__ ad,
                            const int32_t* __restrict__ ac, int w_a,
                            int64_t n, const T* __restrict__ bd,
                            const int32_t* __restrict__ bc, int w_b,
                            int64_t nb, const int32_t* __restrict__ pat,
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
masked_spgemm_banded_kernel(const T* __restrict__ ad,
                            const int32_t* __restrict__ ac, int w_a,
                            int64_t n, const T* __restrict__ bd,
                            const int32_t* __restrict__ bc, int w_b,
                            int64_t nb, const int32_t* __restrict__ pat,
                            int w_out, T* __restrict__ out, Offsets offs) {
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

template <typename T>
int launch_gather(const void* ad, const void* ac, int w_a, int64_t n,
                  const void* bd, const void* bc, int w_b, int64_t nb,
                  const void* pat, int w_out, void* out, void* stream,
                  int device) {
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || w_out <= 0) return static_cast<int>(cudaSuccess);
    masked_spgemm_gather_kernel<T><<<blocks_for(n * w_out), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(ad), static_cast<const int32_t*>(ac), w_a, n,
        static_cast<const T*>(bd), static_cast<const int32_t*>(bc), w_b, nb,
        static_cast<const int32_t*>(pat), w_out, static_cast<T*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded(const void* ad, const void* ac, int w_a, int64_t n,
                  const void* bd, const void* bc, int w_b, int64_t nb,
                  const void* pat, int w_out, void* out,
                  const int32_t* offsets, int k, void* stream, int device) {
    if (k < 0 || k > kMaxOffsets) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaError_t err = use_device(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0 || w_out <= 0) return static_cast<int>(cudaSuccess);
    Offsets offs{};
    offs.k = k;
    for (int kk = 0; kk < k; ++kk) offs.v[kk] = offsets[kk];
    masked_spgemm_banded_kernel<T><<<blocks_for(n * w_out), kThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const T*>(ad), static_cast<const int32_t*>(ac), w_a, n,
        static_cast<const T*>(bd), static_cast<const int32_t*>(bc), w_b, nb,
        static_cast<const int32_t*>(pat), w_out, static_cast<T*>(out), offs);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int masked_spgemm_gather_f32(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, void* stream, int device) {
    return launch_gather<float>(ad, ac, w_a, n, bd, bc, w_b, nb, pat, w_out,
                                out, stream, device);
}

extern "C" int masked_spgemm_gather_f64(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, void* stream, int device) {
    return launch_gather<double>(ad, ac, w_a, n, bd, bc, w_b, nb, pat, w_out,
                                 out, stream, device);
}

extern "C" int masked_spgemm_banded_f32(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, const int32_t* offsets, int k, void* stream, int device) {
    return launch_banded<float>(ad, ac, w_a, n, bd, bc, w_b, nb, pat, w_out,
                                out, offsets, k, stream, device);
}

extern "C" int masked_spgemm_banded_f64(
    const void* ad, const void* ac, int w_a, int64_t n, const void* bd,
    const void* bc, int w_b, int64_t nb, const void* pat, int w_out,
    void* out, const int32_t* offsets, int k, void* stream, int device) {
    return launch_banded<double>(ad, ac, w_a, n, bd, bc, w_b, nb, pat, w_out,
                                 out, offsets, k, stream, device);
}
