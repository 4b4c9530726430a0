// Variable-weight 27-offset block stencil on the card: K4 (f32) and K5 (f64).
//
//   out[n] = sum over the 27 offsets d of W_d[n] @ g[n + d]
//
// on the node-major (Z, Y, X, 3) grid, with a 3x3 block per node and
// offset: the assembled stiffness of a hex8 mesh whose connectivity is the
// box grid and whose node positions are free (the curvilinear route).
//
// Replaces the TPU kernels
//   K4  fea_tpu/ops/pallas_varstencil.py::var_apply_transposed     (_kernel_var27)
//   K5  fea_tpu/ops/pallas_varstencil.py::var_apply_transposed_dd  (_kernel_var27_dd)
// K5 computes in native FP64; the TPU kernel emulated f64 with f32
// (hi, lo) pairs, Veltkamp splits and TwoSum only because that chip has
// no IEEE f64.
//
// Layout: the weight field is the kernel's own, plane-major
// W[(d * 3 + r) * 3 + c][n] with n = (z * Y + y) * X + x, i.e. a
// contiguous (27, 3, 3, Z, Y, X) tensor, built once per level
// (fea_tpu_torch/ops/curvilinear.py). A warp's load of one of the 243
// planes is one coalesced run of 32 consecutive nodes. The state g and
// the output keep the node-major (Z, Y, X, 3) layout of the public arrays.
//
// Method: one thread per node, the form of csrc/stencil.cu. The assembled
// weights are zero toward missing neighbours, so there is no boundary
// term: neighbours outside the grid are skipped only so that no thread
// reads outside g.
//
// Bound: the weights dominate the traffic, 243 values per node against 6
// of state in and out (at ideal neighbour reuse): 996 B a node in f32 and
// 1,992 B in f64, for 243 FMAs, ~0.25 and ~0.12 FMA per byte. Both are
// far below the card's ridge points, so the kernel is bound by memory
// bandwidth. This first form streams each weight once through the
// read-only path and relies on L1/L2 for neighbour reuse of g; the
// symmetric 14-block form (w(-d) = w(d)^T) would halve the weight bytes.
//
// Offsets are 64-bit: 243 planes x 270,641 nodes is already 6.6e7.
//
// Slab form (K4-slab, K5-slab): the same body on one z slab of a sharded
// grid (fea_tpu_torch/parallel/curv.py). The weights are the slab's own,
// (27, 3, 3, Zl, Y, X), and the state is the slab between its neighbours'
// edge planes, (Zl + 2, Y, X, 3): output plane z reads state planes z,
// z + 1 and z + 2. No z term is skipped. Toward a plane past the global
// ends the assembled weights are zero, and the halo there holds zeros, so
// each such term adds an exact zero: a slab's output is, value for value,
// the unsharded kernel's on the same planes. Padding planes past the grid
// carry zero weights and come out 0. The slab form reads 27 weight blocks
// a node where the unsharded kernel skips the z terms past the grid ends.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError() as an int; the Python wrapper raises when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// kSlab: g holds Z + 2 planes, plane z + 1 being output plane z.
template <typename T, bool kSlab>
__global__ void var27_kernel(const T* __restrict__ W,
                             const T* __restrict__ g,
                             T* __restrict__ out,
                             int64_t X, int64_t Y, int64_t Z) {
    const int64_t N = X * Y * Z;
    const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (n >= N) return;
    const int64_t x = n % X;
    const int64_t t = n / X;
    const int64_t y = t % Y;
    const int64_t z = t / Y;
    T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
        const int64_t zz = kSlab ? z + 1 + dz : z + dz;
        if (!kSlab && (zz < 0 || zz >= Z)) continue;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
            const int64_t yy = y + dy;
            if (yy < 0 || yy >= Y) continue;
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
                const int64_t xx = x + dx;
                if (xx < 0 || xx >= X) continue;
                const int d = ((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1);
                const T* __restrict__ w = W + static_cast<int64_t>(d) * 9 * N + n;
                const T* __restrict__ u = g + ((zz * Y + yy) * X + xx) * 3;
                const T u0 = __ldg(u), u1 = __ldg(u + 1), u2 = __ldg(u + 2);
                a0 = fma(__ldg(w + 0 * N), u0, fma(__ldg(w + 1 * N), u1, fma(__ldg(w + 2 * N), u2, a0)));
                a1 = fma(__ldg(w + 3 * N), u0, fma(__ldg(w + 4 * N), u1, fma(__ldg(w + 5 * N), u2, a1)));
                a2 = fma(__ldg(w + 6 * N), u0, fma(__ldg(w + 7 * N), u1, fma(__ldg(w + 8 * N), u2, a2)));
            }
        }
    }
    out[n * 3 + 0] = a0;
    out[n * 3 + 1] = a1;
    out[n * 3 + 2] = a2;
}

constexpr int kThreads = 256;

template <typename T, bool kSlab>
int launch(const T* W, const T* g, T* out, int64_t X, int64_t Y, int64_t Z, void* stream) {
    const int64_t nodes = X * Y * Z;
    const int64_t blocks = (nodes + kThreads - 1) / kThreads;
    var27_kernel<T, kSlab><<<static_cast<unsigned int>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(W, g, out, X, Y, Z);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: f32 variable-weight apply, used by the f32 V-cycle levels.
extern "C" int fea_var_apply_f32(const float* W, const float* g, float* out,
                                 int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, false>(W, g, out, X, Y, Z, stream);
}

// K5: f64 variable-weight apply, used by the FCG apply, the true-residual
// check, the reactions and the f64 V-cycle levels.
extern "C" int fea_var_apply_f64(const double* W, const double* g, double* out,
                                 int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, false>(W, g, out, X, Y, Z, stream);
}

// K4-slab: K4 on one z slab, g (Zl + 2, Y, X, 3) -> out (Zl, Y, X, 3) with
// Z = Zl; used by the sharded curvilinear V-cycle's f32 levels.
extern "C" int fea_var_apply_slab_f32(const float* W, const float* g, float* out,
                                      int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, true>(W, g, out, X, Y, Z, stream);
}

// K5-slab: K5 on one z slab; used by the sharded FCG apply, the
// true-residual check, the reactions and the f64 sharded levels.
extern "C" int fea_var_apply_slab_f64(const double* W, const double* g, double* out,
                                      int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, true>(W, g, out, X, Y, Z, stream);
}
