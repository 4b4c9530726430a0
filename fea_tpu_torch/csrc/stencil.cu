// Structured hex8 voxel stencil K @ u on the card: K1 (f32) and K2 (f64).
//
// Replaces the TPU kernels
//   K1  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed     (_kernel27)
//   K2  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed_dd  (_kernel27_dd)
// K2 computes in native FP64; the TPU kernel emulated f64 with f32
// (hi, lo) pairs only because that chip has no IEEE f64.
//
// Layout: the node-major grid (Z, Y, X, 3) of box_hex_mesh order, not the
// TPU's (3, Y, X, Z). A warp reads 32 consecutive nodes x 3 components,
// which coalesces as it stands.
//
// Method: node-centric, the form of fea_tpu/native/stencil.cpp. One thread
// per node. Per axis the node has a boundary class (0 = min face,
// 1 = interior, 2 = max face); the 27 classes pick a (27 offsets, 3, 3)
// block of the region table W[(rz*3+ry)*3+rx][((dz+1)*3+(dy+1))*3+(dx+1)]
// built once per Ke on the host (fea_tpu_torch/ops/cuda_stencil.py::
// region_weight_table). A (class, offset) pair whose supporting element
// does not exist carries a zero block, and the bounds checks skip exactly
// those reads, so no inclusion-exclusion is needed. The table (26 kB in
// f32, 52 kB in f64) is read through the read-only data cache; all threads
// of a warp except those on a boundary read the same interior block.
//
// Bound: at ideal neighbour reuse each node moves 3 values in and 3 out
// (24 B in f32, 48 B in f64) and does 27 x 9 = 243 FMAs, about 20 flop/B
// in f32 and 10 flop/B in f64. Both sit near the card's plain (non-tensor)
// FP32 and FP64 ridge points, so neither bytes nor FMAs can be ignored.
// This first form relies on L1/L2 for neighbour reuse and keeps no tile
// in shared memory.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError() as an int; the Python wrapper raises when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int axis_class(int64_t i, int64_t n) {
    return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}

template <typename T>
__global__ void stencil27_kernel(const T* __restrict__ W,
                                 const T* __restrict__ g,
                                 T* __restrict__ out,
                                 int64_t X, int64_t Y, int64_t Z) {
    const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (n >= X * Y * Z) return;
    const int64_t x = n % X;
    const int64_t t = n / X;
    const int64_t y = t % Y;
    const int64_t z = t / Y;
    const int region = (axis_class(z, Z) * 3 + axis_class(y, Y)) * 3 + axis_class(x, X);
    const T* __restrict__ Wr = W + static_cast<int64_t>(region) * 27 * 9;
    T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll
    for (int dz = -1; dz <= 1; ++dz) {
        const int64_t zz = z + dz;
        if (zz < 0 || zz >= Z) continue;
#pragma unroll
        for (int dy = -1; dy <= 1; ++dy) {
            const int64_t yy = y + dy;
            if (yy < 0 || yy >= Y) continue;
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
                const int64_t xx = x + dx;
                if (xx < 0 || xx >= X) continue;
                const T* __restrict__ w = Wr + (((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)) * 9;
                const T* __restrict__ u = g + ((zz * Y + yy) * X + xx) * 3;
                const T u0 = __ldg(u), u1 = __ldg(u + 1), u2 = __ldg(u + 2);
                a0 = fma(__ldg(w + 0), u0, fma(__ldg(w + 1), u1, fma(__ldg(w + 2), u2, a0)));
                a1 = fma(__ldg(w + 3), u0, fma(__ldg(w + 4), u1, fma(__ldg(w + 5), u2, a1)));
                a2 = fma(__ldg(w + 6), u0, fma(__ldg(w + 7), u1, fma(__ldg(w + 8), u2, a2)));
            }
        }
    }
    out[n * 3 + 0] = a0;
    out[n * 3 + 1] = a1;
    out[n * 3 + 2] = a2;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const T* W, const T* g, T* out, int64_t X, int64_t Y, int64_t Z, void* stream) {
    const int64_t nodes = X * Y * Z;
    const int64_t blocks = (nodes + kThreads - 1) / kThreads;
    stencil27_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(W, g, out, X, Y, Z);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: f32 K @ u, used by the f32 V-cycle levels.
extern "C" int fea_stencil_apply_f32(const float* W, const float* g, float* out,
                                     int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float>(W, g, out, X, Y, Z, stream);
}

// K2: f64 K @ u, used by the FCG apply, the true-residual check, the
// reactions and the f64 V-cycle levels.
extern "C" int fea_stencil_apply_f64(const double* W, const double* g, double* out,
                                     int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double>(W, g, out, X, Y, Z, stream);
}
