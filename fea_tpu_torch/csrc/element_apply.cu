// Element-by-element apply f_e = Ke u_e on the card: K6 (a stored Ke for
// every element) and K7 (one Ke shared by all), each in f32 and f64.
//
// Replaces the TPU kernels
//   K6  fea_tpu/ops/pallas_apply.py::batched_matvec_stored   (_stored_kernel)
//   K7  fea_tpu/ops/pallas_apply.py::batched_matvec_uniform  (_uniform_kernel)
// The TPU padded E to 512-element tiles and laid elements on its 128-wide
// lanes; neither is needed here. These kernels compute the functions'
// contracts for any E >= 1 and any k <= 32 (k = 24 for hex8, 4 for a beam
// or a 2D bar, 6 for a 3D bar), where the TPU's stored kernel summed 24
// columns whatever k was.
//
// K6: out[e, a] = sum_b ke[e, a, b] u[e, b]. One warp an element. For each
// row a, lane b < k reads ke[e, a, b] (the row is contiguous, so the warp's
// read coalesces) times u[e, b], and an xor-shuffle sum leaves the row's
// value in every lane; lane a keeps it, and lanes < k write the element's
// k outputs at the end in one coalesced store. Bound: bytes. Ke is read
// once, k*k values an element against 2k of u and out: at k = 24 about
// 26 B an FMA in f32, far above the card's ridge.
//
// K7: out[e, a] = sum_b ke[a, b] u[e, b]. One thread an output. The block
// stages Ke transposed in shared memory (k*k <= 1,024 values, 8 kB in f64),
// so that consecutive threads (consecutive a) read consecutive words. A
// warp's u reads touch at most two elements' rows and hit L1 after the
// first. Bound: bytes, u read once and out written once, 2k values an
// element for 2k*k flops (6 flop/B in f32 at k = 24). On an H100 (700 W,
// chip_smoke.py phase [8]) this form reaches only ~22% of that bound: its
// k loads a thread through L1 cost more than the bytes. One thread an
// element, Ke broadcast from shared memory, is the planned redesign.
//
// Sums run in the order b = 0 .. k-1 with fused multiply-adds. No tensor
// cores: TF32 would break the f32 tolerance, and an f64 MMA tile does not
// pay at k = 24. Each extern "C" entry launches on the caller's stream and
// returns cudaGetLastError() as an int; the Python wrapper raises when it
// is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 32;
constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

template <typename T>
__global__ void stored_kernel(const T* __restrict__ ke, const T* __restrict__ u, T* __restrict__ out,
                              int64_t E, int k) {
    const int lane = threadIdx.x & 31;
    const int64_t e = static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
    if (e >= E) return;  // the whole warp leaves together
    const T* __restrict__ Ke = ke + e * k * k;
    const bool active = lane < k;
    const T ub = active ? __ldg(u + e * k + lane) : T(0);
    T mine = T(0);
    for (int a = 0; a < k; ++a) {
        T p = active ? __ldg(Ke + a * k + lane) * ub : T(0);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) p += __shfl_xor_sync(0xffffffffu, p, off);
        if (lane == a) mine = p;
    }
    if (active) out[e * k + lane] = mine;
}

template <typename T>
__global__ void uniform_kernel(const T* __restrict__ ke, const T* __restrict__ u, T* __restrict__ out,
                               int64_t n_out, int k) {
    __shared__ T keT[kMaxK * kMaxK];
    for (int i = threadIdx.x; i < k * k; i += blockDim.x) {
        keT[(i % k) * k + i / k] = ke[i];  // keT[b * k + a] = ke[a * k + b]
    }
    __syncthreads();
    const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (t >= n_out) return;
    const int64_t e = t / k;
    const int a = static_cast<int>(t - e * k);
    const T* __restrict__ ue = u + e * k;
    T acc = T(0);
    for (int b = 0; b < k; ++b) acc = fma(keT[b * k + a], __ldg(ue + b), acc);
    out[t] = acc;
}

template <typename T>
int launch_stored(const T* ke, const T* u, T* out, int64_t E, int k, void* stream) {
    if (E < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t blocks = (E + kWarpsPerBlock - 1) / kWarpsPerBlock;
    stored_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ke, u, out, E, k);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_uniform(const T* ke, const T* u, T* out, int64_t E, int k, void* stream) {
    if (E < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_out = E * k;
    const int64_t blocks = (n_out + kThreads - 1) / kThreads;
    uniform_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        ke, u, out, n_out, k);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K6: the `stored` operator's element apply (beams, bars, a stored hex8 Ke batch).
extern "C" int fea_batched_matvec_stored_f32(const float* ke, const float* u, float* out,
                                             int64_t E, int k, void* stream) {
    return launch_stored<float>(ke, u, out, E, k, stream);
}

extern "C" int fea_batched_matvec_stored_f64(const double* ke, const double* u, double* out,
                                             int64_t E, int k, void* stream) {
    return launch_stored<double>(ke, u, out, E, k, stream);
}

// K7: the `uniform` operator's element apply (congruent hex8 meshes).
extern "C" int fea_batched_matvec_uniform_f32(const float* ke, const float* u, float* out,
                                              int64_t E, int k, void* stream) {
    return launch_uniform<float>(ke, u, out, E, k, stream);
}

extern "C" int fea_batched_matvec_uniform_f64(const double* ke, const double* u, double* out,
                                              int64_t E, int k, void* stream) {
    return launch_uniform<double>(ke, u, out, E, k, stream);
}
