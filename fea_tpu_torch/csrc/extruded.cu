// E: the extruded operator's apply as one kernel, masked or raw, f32 or f64.
//
//   masked  y = F * K (F * x) + (1 - F) * x
//   raw     y = K x
//
// x, y and F are the (L, n2, 3) layer-major fields of an extruded mesh
// (fea_tpu_torch/ops/extruded.py::ExtrudedOperator): node l * n2 + i sits at
// section node i of node layer l, and every element is a section quad q
// between node layers e and e + 1 with one 24x24 Ke_q for all e (columns:
// the quad's 4 corners on layer e, then on layer e + 1, xyz each). The plain
// version is that module's apply: a corner gather, a batched bmm over the
// Q2 section quads, two incidence gather-sums and the mask terms, about 17
// launches with every intermediate in device memory.
//
// Replaces no TPU kernel: the JAX package applies the extruded operator
// with jnp ops (fea_tpu/ops/extruded.py). Added because the plain version
// ran at 3-4% of its byte bound, 37 times an FCG step of the 591,360-DOF
// tube (35 f32 V-cycle applies over 385 to 25 node layers, 2 f64 applies).
//
// Bound: bytes. Masked f32 at 385 layers of 512 nodes: x, F and y, 2.37 MB
// each, and the 256 Ke, 0.59 MB: 7.69 MB, 2.30 us at 3.35 TB/s; f64 twice
// that. The element products (576 multiply-adds an element) take about as
// long in f32 at the card's FMA rate, so the design keeps loads per FMA low.
//
// Design. A block owns a chunk of nb <= 8 section nodes (a warp each) over a
// tile of TL = 32 LPL node layers (LPL consecutive layers a lane). The chunks
// are a host plan (fea_tpu_torch/ops/cuda_extruded.py::tile_plan): the nodes
// in order of first appearance in the quads, cut so that the section nodes a
// chunk needs (the corners of every quad incident to its nodes, its halo)
// stay few. The block
//   1. stages in shared memory, each thread issuing kUnroll independent loads
//      before it waits: the 6 x 6 blocks of Ke that its nodes' incidences use
//      (laid out by the plan, kp[q][c][k]: the rows of corners c and c + 4,
//      the columns of corner k), and its halo's values on node layers
//      l0 - 1 .. l0 + TL, F applied as they load, transposed so that a node's
//      value of one DOF over the tile's layers is one row: the lanes of a warp
//      read neighbouring words;
//   2. each warp sums its node's outputs on its lanes' layers: for each
//      incidence (quad q, corner c) of the plan, for each corner k of q, the
//      3 bottom-face rows (corner c) and 3 top-face rows (corner c + 4) of
//      Ke_q times the corner's 3 DOFs on layers l - 1 .. l + LPL. Every lane
//      reads the same Ke block (all layers share it), in 16-byte pieces that
//      serve all LPL layers of a lane: no Ke and no element force is stored
//      per element;
//   3. writes the tile's outputs once each, through shared memory, rows of
//      nb nodes per layer, with the mask terms.
// On an H100 (700 W) the masked f32 apply takes 12.1 us at 385 layers (19% of
// the bound) and 5.0-8.1 us at 193 to 25, the f64 one 19.9 us (23%), against
// 95.7 and 130.7 us for the plain version.
// Sums run in one fixed order: a node's bottom-face terms (incidence, corner
// k, DOF, layer e then e + 1), then its top-face terms in the same order,
// the two added last. Nothing is atomic, so two launches on one input give
// the same bits and a CUDA graph replay repeats the last. The plain version
// sums in cuBLAS's order: the two agree to rounding, not bit for bit.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError() as an int; the Python wrapper raises when it is not 0.
// The wrapper checks dtype, shapes, contiguity and the valence (at most 8,
// which keeps a chunk's halo, and shared memory, bounded); the plan's
// tables are int32.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kMaxSlots = 8;   // owned nodes a block, one warp each
constexpr int kBlock = 36;     // values of one (q, c, k) block of kp: 6 rows x 6 columns
constexpr int kIncWidth = 6;   // an incidence in the plan: q, c, and the halo slots of q's 4 corners
constexpr int kUnroll = 4;     // global loads a thread issues before it waits for them

__device__ __forceinline__ float madd(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double madd(double a, double b, double c) { return fma(a, b, c); }

template <typename T> struct Vec2;
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// 12 consecutive values of a Ke block in shared memory (two of its rows),
// 16-byte aligned; every lane of a warp reads the same address (a broadcast)
__device__ __forceinline__ void load12(const float* p, float (&k)[12]) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
        const float4 v = reinterpret_cast<const float4*>(p)[i];
        k[4 * i] = v.x;
        k[4 * i + 1] = v.y;
        k[4 * i + 2] = v.z;
        k[4 * i + 3] = v.w;
    }
}

__device__ __forceinline__ void load12(const double* p, double (&k)[12]) {
#pragma unroll
    for (int i = 0; i < 6; ++i) {
        const double2 v = reinterpret_cast<const double2*>(p)[i];
        k[2 * i] = v.x;
        k[2 * i + 1] = v.y;
    }
}

// a halo node's 3 DOFs on staged layers lam .. lam + LPL + 1 (row d of the
// node at base + d * TLX); for LPL = 2, lam is even and the row 8-byte
// (f32) or 16-byte (f64) aligned, so two 2-wide loads a DOF
template <typename T, int LPL, int TLX>
__device__ __forceinline__ void load_x(const T* base, T (&xv)[3][LPL + 2]) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
        const T* row = base + d * TLX;
        if constexpr (LPL == 2) {
            using V2 = typename Vec2<T>::type;
            const V2 a = *reinterpret_cast<const V2*>(row);
            const V2 b = *reinterpret_cast<const V2*>(row + 2);
            xv[d][0] = a.x;
            xv[d][1] = a.y;
            xv[d][2] = b.x;
            xv[d][3] = b.y;
        } else {
#pragma unroll
            for (int j = 0; j < LPL + 2; ++j) xv[d][j] = row[j];
        }
    }
}

template <typename T, int LPL>
constexpr size_t smem_bytes(int nb, int H, int V) {
    return (static_cast<size_t>(nb) * V * 4 * kBlock + static_cast<size_t>(H) * 3 * (kLanes * LPL + 2) +
            static_cast<size_t>(kLanes * LPL) * (nb * 3 + 1)) * sizeof(T);
}

template <typename T, int LPL, bool MASKED>
__global__ void __launch_bounds__(kLanes * kMaxSlots)
extruded_apply_kernel(const T* __restrict__ x, const T* __restrict__ F, T* __restrict__ y,
                      const T* __restrict__ kp, const int* __restrict__ nodes, const int* __restrict__ halo,
                      const int* __restrict__ inc, int L, int n2, int nb, int H, int V) {
    constexpr int TL = kLanes * LPL;  // node layers a block
    constexpr int TLX = TL + 2;       // staged layers: one more each side
    constexpr int kQC = 4 * kBlock;   // values of one (q, c) of kp: its 4 blocks
    using V16 = typename std::conditional<sizeof(T) == 4, float4, double2>::type;
    constexpr int kQCv = kQC * static_cast<int>(sizeof(T)) / 16;  // 16-byte pieces of one (q, c)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* s_k = reinterpret_cast<T*>(smem_raw);  // [nb * V][kQC]: the Ke blocks of the chunk's incidences
    T* s_x = s_k + nb * V * kQC;              // [H * 3][TLX]: F x of the halo, a row a (node, DOF)
    T* s_y = s_x + H * 3 * TLX;               // [TL][nb * 3 + 1]: the tile's sums
    const int ys = nb * 3 + 1;
    const int tid = threadIdx.x;
    const int threads = blockDim.x;
    const int chunk = blockIdx.x;
    const int l0 = blockIdx.y * TL;
    const int64_t layer = static_cast<int64_t>(n2) * 3;
    const int* cinc = inc + static_cast<int64_t>(chunk) * nb * V * kIncWidth;

    // 1. stage: the Ke blocks of the chunk's incidences (16-byte pieces), then
    // the halo's values, a thread a (node, DOF) row and every `step`-th
    // layer, so that consecutive threads read consecutive (node, DOF) of one
    // layer. Each thread issues kUnroll loads before it stores any: the
    // loads' latency is paid once, not once a loop trip.
    {
        const V16* src = reinterpret_cast<const V16*>(kp);
        V16* dst = reinterpret_cast<V16*>(s_k);
        const int total = nb * V * kQCv;
        for (int base = tid; base < total; base += kUnroll * threads) {
            V16 v[kUnroll];
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int i = base + u * threads;
                const int wv = i / kQCv;
                const int* e = cinc + wv * kIncWidth;
                if (i < total && e[0] >= 0) v[u] = src[static_cast<int64_t>(e[0] * 4 + e[1]) * kQCv + i - wv * kQCv];
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int i = base + u * threads;
                if (i < total && cinc[(i / kQCv) * kIncWidth] >= 0) dst[i] = v[u];
            }
        }
    }
    {
        const int per = H * 3;
        const int rows = per < threads ? per : threads;
        const int step = threads / rows;
        const int lam0 = tid / rows;
        if (lam0 < step) {
            const int* hal = halo + static_cast<int64_t>(chunk) * H;
            for (int r = tid - lam0 * rows; r < per; r += rows) {
                const int n = hal[r / 3];
                const int64_t off = static_cast<int64_t>(n) * 3 + (r % 3);
                for (int base = lam0; base < TLX; base += kUnroll * step) {
                    T v[kUnroll];
#pragma unroll
                    for (int u = 0; u < kUnroll; ++u) {
                        const int l = l0 - 1 + base + u * step;
                        v[u] = T(0);
                        if (n >= 0 && l >= 0 && l < L && l < l0 - 1 + TLX) {
                            const int64_t g = l * layer + off;
                            v[u] = MASKED ? x[g] * F[g] : x[g];
                        }
                    }
#pragma unroll
                    for (int u = 0; u < kUnroll; ++u) {
                        const int lam = base + u * step;
                        if (lam < TLX) s_x[r * TLX + lam] = v[u];
                    }
                }
            }
        }
    }
    __syncthreads();

    // 2. a warp a node, LPL layers a lane
    const int w = tid >> 5;
    const int lane = tid & 31;
    const int node = nodes[chunk * nb + w];
    T ab[LPL][3], at[LPL][3];  // bottom-face and top-face sums
#pragma unroll
    for (int i = 0; i < LPL; ++i) {
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            ab[i][d] = T(0);
            at[i][d] = T(0);
        }
    }
    if (node >= 0) {
        for (int v = 0; v < V; ++v) {
            const int* e = cinc + (w * V + v) * kIncWidth;
            if (e[0] < 0) continue;  // past the node's valence: the same in every lane
            const T* kq = s_k + (w * V + v) * kQC;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                T xv[3][LPL + 2];
                load_x<T, LPL, TLX>(s_x + e[2 + k] * 3 * TLX + lane * LPL, xv);
#pragma unroll
                for (int j = 0; j < 3; ++j) {  // the block's rows in pairs
                    T kr[12];
                    load12(kq + k * kBlock + 12 * j, kr);
#pragma unroll
                    for (int s = 0; s < 2; ++s) {
                        const int r = 2 * j + s;  // rows 0-2: corner c's DOFs; 3-5: corner c + 4's
                        const T* K = kr + 6 * s;
#pragma unroll
                        for (int i = 0; i < LPL; ++i) {
                            if (r < 3) {  // element layer l: this layer, then the one above
                                T a = ab[i][r];
#pragma unroll
                                for (int d = 0; d < 3; ++d) {
                                    a = madd(K[d], xv[d][i + 1], a);
                                    a = madd(K[3 + d], xv[d][i + 2], a);
                                }
                                ab[i][r] = a;
                            } else {  // element layer l - 1: the layer below, then this one
                                T a = at[i][r - 3];
#pragma unroll
                                for (int d = 0; d < 3; ++d) {
                                    a = madd(K[d], xv[d][i], a);
                                    a = madd(K[3 + d], xv[d][i + 1], a);
                                }
                                at[i][r - 3] = a;
                            }
                        }
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < LPL; ++i) {
        const int lam = lane * LPL + i;
        const int l = l0 + lam;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
            // no element above the last layer, none below the first
            s_y[lam * ys + w * 3 + d] = (l < L - 1 ? ab[i][d] : T(0)) + (l >= 1 ? at[i][d] : T(0));
        }
    }
    __syncthreads();

    // 3. write, a thread a (node, DOF) and every `step`-th layer:
    // consecutive threads, consecutive (node, DOF) of one layer
    const int per_y = nb * 3;
    const int step = threads / per_y;
    const int lam0 = tid / per_y;
    const int r = tid - lam0 * per_y;
    const int n = nodes[chunk * nb + r / 3];
    if (lam0 < step && n >= 0) {
        const int64_t off = static_cast<int64_t>(n) * 3 + (r % 3);
        for (int base = lam0; base < TL; base += kUnroll * step) {
            T f[kUnroll], xo[kUnroll];
            if (MASKED) {
#pragma unroll
                for (int u = 0; u < kUnroll; ++u) {
                    const int lam = base + u * step;
                    const int64_t g = (l0 + lam) * layer + off;
                    f[u] = T(0);
                    xo[u] = T(0);
                    if (lam < TL && l0 + lam < L) {
                        f[u] = F[g];
                        xo[u] = x[g];
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kUnroll; ++u) {
                const int lam = base + u * step;
                if (lam < TL && l0 + lam < L) {
                    const int64_t g = (l0 + lam) * layer + off;
                    const T acc = s_y[lam * ys + r];
                    y[g] = MASKED ? f[u] * acc + (T(1) - f[u]) * xo[u] : acc;
                }
            }
        }
    }
}

template <typename T, int LPL, bool MASKED>
int launch(const T* x, const T* F, T* y, const T* kp, const int* nodes, const int* halo, const int* inc, int L,
           int n2, int chunks, int nb, int H, int V, cudaStream_t stream) {
    constexpr int TL = kLanes * LPL;
    const size_t smem = smem_bytes<T, LPL>(nb, H, V);
    static size_t configured = 48 * 1024;  // the dynamic shared memory allowed so far
    if (smem > configured) {
        const cudaError_t err = cudaFuncSetAttribute(extruded_apply_kernel<T, LPL, MASKED>,
                                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
        configured = smem;
    }
    const dim3 grid(chunks, (L + TL - 1) / TL);
    extruded_apply_kernel<T, LPL, MASKED><<<grid, kLanes * nb, smem, stream>>>(x, F, y, kp, nodes, halo, inc, L,
                                                                                n2, nb, H, V);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* x, const T* F, T* y, const T* kp, const int* nodes, const int* halo, const int* inc,
             int64_t L, int64_t n2, int64_t chunks, int64_t nb, int64_t H, int64_t V, int64_t lpl, int64_t masked,
             void* stream) {
    const auto s = static_cast<cudaStream_t>(stream);
    const int l = static_cast<int>(L), n = static_cast<int>(n2), c = static_cast<int>(chunks);
    const int b = static_cast<int>(nb), h = static_cast<int>(H), v = static_cast<int>(V);
    if (lpl == 2) {
        return masked ? launch<T, 2, true>(x, F, y, kp, nodes, halo, inc, l, n, c, b, h, v, s)
                      : launch<T, 2, false>(x, F, y, kp, nodes, halo, inc, l, n, c, b, h, v, s);
    }
    return masked ? launch<T, 1, true>(x, F, y, kp, nodes, halo, inc, l, n, c, b, h, v, s)
                  : launch<T, 1, false>(x, F, y, kp, nodes, halo, inc, l, n, c, b, h, v, s);
}

}  // namespace

// f32: the V-cycle's level applies. F is not read when masked is 0.
extern "C" int fea_extruded_apply_f32(const float* x, const float* F, float* y, const float* kp, const int* nodes,
                                      const int* halo, const int* inc, int64_t L, int64_t n2, int64_t chunks,
                                      int64_t nb, int64_t H, int64_t V, int64_t lpl, int64_t masked, void* stream) {
    return dispatch<float>(x, F, y, kp, nodes, halo, inc, L, n2, chunks, nb, H, V, lpl, masked, stream);
}

// f64: the FCG's apply, the composition's residual update, the right-hand
// side, certification and the reactions.
extern "C" int fea_extruded_apply_f64(const double* x, const double* F, double* y, const double* kp,
                                      const int* nodes, const int* halo, const int* inc, int64_t L, int64_t n2,
                                      int64_t chunks, int64_t nb, int64_t H, int64_t V, int64_t lpl, int64_t masked,
                                      void* stream) {
    return dispatch<double>(x, F, y, kp, nodes, halo, inc, L, n2, chunks, nb, H, V, lpl, masked, stream);
}
