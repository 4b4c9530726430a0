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
// K7: out[e, a] = sum_b ke[a, b] u[e, b]. Bound: bytes, u read once and
// out written once, 2k values an element for 2k*k flops (6 flop/B in f32
// at k = 24, 3 in f64, under the card's ridge). The first form (one thread
// an output: one shared and one global load through L1 for every FMA, 24
// threads reloading the same row of u) reached 21-24% of that bound and
// was 2-2.9x slower than cuBLAS: the load pipes, not HBM, set its time.
// For k = 24 (hex8, the only k the uniform operator meets today) the
// kernel is uniform_tile_kernel<T, 24>:
//   * a block owns a tile of 128 elements, whose rows of u are one
//     contiguous range; it copies them to shared memory in coalesced
//     16-byte pieces with cp.async, into rows padded to an odd number of
//     pieces (7 in f32, 13 in f64), so that the 16-byte reads of a row by
//     the threads of a quarter warp fall into different banks;
//   * one thread two elements: their rows go into 48 registers; each
//     output is 24 FMAs against a row of Ke read from shared memory as a
//     broadcast in 16-byte pieces, each piece serving both elements (8
//     FMAs a load in f32, 4 in f64: a broadcast load still fills 32 lanes'
//     registers, so loads of Ke, not FMAs, are what a thread must save);
//     the outputs go back into the thread's own rows of the tile, and the
//     block stores the tile to global in coalesced 16-byte pieces;
//   * u and out must be 16-byte aligned (the wrapper checks; a tile starts
//     at a multiple of 128 rows), the last tile may be ragged.
// Any other k <= 32 takes uniform_kernel, the first form, unchanged (one
// thread an output, Ke transposed in shared memory): beams and bars
// (k = 4, 6) never reach K7 today. Both are hand kernels; neither falls
// back to a library.
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

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

__device__ __forceinline__ void unpack(const float4& v, float* p) {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* p) {
    p[0] = v.x; p[1] = v.y;
}
__device__ __forceinline__ float4 pack(const float* p) { return make_float4(p[0], p[1], p[2], p[3]); }
__device__ __forceinline__ double2 pack(const double* p) { return make_double2(p[0], p[1]); }

// 16 bytes global -> shared, asynchronously; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

constexpr int kTile = 128;       // elements a block
constexpr int kRowsPerThread = 2;  // elements a thread: each piece of Ke read serves this many FMAs a value
constexpr int kTileThreads = kTile / kRowsPerThread;

template <typename T, int K>
__global__ void __launch_bounds__(kTileThreads)
uniform_tile_kernel(const T* __restrict__ ke, const T* __restrict__ u, T* __restrict__ out, int64_t E) {
    using V = typename Vec16<T>::type;
    constexpr int P = 16 / sizeof(T);  // values a 16-byte piece
    constexpr int R = kRowsPerThread;
    static_assert(K % P == 0, "a row must be whole 16-byte pieces");
    constexpr int RP = K / P;          // pieces a row
    constexpr int RS = RP | 1;         // row stride in shared memory, odd: no bank conflicts
    __shared__ V s_ke[K * RP];         // ke[a][b], row-major
    __shared__ V s_t[kTile * RS];      // the tile: u on the way in, out on the way back

    const int tid = threadIdx.x;
    const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kTile;
    const int rows = static_cast<int>(E - e0 < kTile ? E - e0 : kTile);
    const int pieces = rows * RP;
    const V* __restrict__ src = reinterpret_cast<const V*>(u + e0 * K);
    for (int c = tid; c < pieces; c += kTileThreads) cp_async_16(&s_t[(c / RP) * RS + c % RP], src + c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = tid; i < K * K; i += kTileThreads) reinterpret_cast<T*>(s_ke)[i] = __ldg(ke + i);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // rows tid and tid + kTileThreads of the tile; a row past the ragged
    // end is computed on whatever the tile holds and never stored
    if (tid < rows) {
        T ur[R][K];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int j = 0; j < RP; ++j) unpack(s_t[(tid + r * kTileThreads) * RS + j], ur[r] + j * P);
        }
#pragma unroll
        for (int a0 = 0; a0 < K; a0 += P) {
            T o[R][P];
#pragma unroll
            for (int i = 0; i < P; ++i) {
                T acc[R];
#pragma unroll
                for (int r = 0; r < R; ++r) acc[r] = T(0);
#pragma unroll
                for (int j = 0; j < RP; ++j) {
                    T w[P];
                    unpack(s_ke[(a0 + i) * RP + j], w);
#pragma unroll
                    for (int b = 0; b < P; ++b) {  // b ascending over the row
#pragma unroll
                        for (int r = 0; r < R; ++r) acc[r] = fma(w[b], ur[r][j * P + b], acc[r]);
                    }
                }
#pragma unroll
                for (int r = 0; r < R; ++r) o[r][i] = acc[r];
            }
            // the thread's own rows: nobody else reads them
#pragma unroll
            for (int r = 0; r < R; ++r) s_t[(tid + r * kTileThreads) * RS + a0 / P] = pack(o[r]);
        }
    }
    __syncthreads();
    V* __restrict__ dst = reinterpret_cast<V*>(out + e0 * K);
    for (int c = tid; c < pieces; c += kTileThreads) dst[c] = s_t[(c / RP) * RS + c % RP];
}

template <typename T>
int launch_uniform(const T* ke, const T* u, T* out, int64_t E, int k, void* stream) {
    if (E < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
    if (k == 24) {
        if ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(out)) & 15) {
            return static_cast<int>(cudaErrorMisalignedAddress);
        }
        const int64_t blocks = (E + kTile - 1) / kTile;
        uniform_tile_kernel<T, 24><<<static_cast<unsigned int>(blocks), kTileThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(ke, u, out, E);
        return static_cast<int>(cudaGetLastError());
    }
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

// K7: the `uniform` operator's element apply (congruent hex8 meshes): the
// tile kernel at k = 24, the one-thread-an-output kernel at any other k.
extern "C" int fea_batched_matvec_uniform_f32(const float* ke, const float* u, float* out,
                                              int64_t E, int k, void* stream) {
    return launch_uniform<float>(ke, u, out, E, k, stream);
}

extern "C" int fea_batched_matvec_uniform_f64(const double* ke, const double* u, double* out,
                                              int64_t E, int k, void* stream) {
    return launch_uniform<double>(ke, u, out, E, k, stream);
}
