// Structured hex8 voxel stencil K @ u on the card: K1 (f32) and K2 (f64)
// over a whole grid, and their z-slab forms: K3 (f64) and K1's halo form
// (f32), which the z-sharded solve (fea_tpu_torch/parallel/halo.py) runs
// on each shard.
//
// Replaces the TPU kernels
//   K1  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed     (_kernel27)
//       and its z_halo=True form on one shard (fea_tpu/parallel/halo.py)
//   K2  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed_dd  (_kernel27_dd)
//   K3  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed_dd_chunked
//       (K2's z_halo=True form on static z slabs)
// K2 and K3 compute in native FP64; the TPU kernels emulated f64 with f32
// (hi, lo) pairs only because that chip has no IEEE f64.
//
// Layout: the node-major grid (Z, Y, X, 3) of box_hex_mesh order, not the
// TPU's (3, Y, X, Z). A warp reads 32 consecutive nodes x 3 components,
// which coalesces as it stands. z is the slowest axis, so a z slab and its
// halo planes are one contiguous range of the grid.
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
// Slabs: one template serves the whole grid and a slab. The kernel is told
// the global index z0 of its first output plane, the global index zin0 of
// the first plane of its input, and the real global plane count z_real.
// The z class comes from the global plane z0 + i, and reads of global
// planes outside [0, z_real) are skipped, so a slab sees the global z-min
// and z-max faces wherever they fall: on any shard, mid-slab, with zero
// padding past the real z-max plane (output planes there are written 0).
// The TPU form needed three extra mechanisms for that, because its
// inclusion-exclusion cannot see the global boundary from inside a slab:
// the table-row gating (fea_tpu/parallel/halo.py::_gate_w with
// pallas_stencil.z_boundary_row_masks), the thin-slab z-max correction
// (pallas_stencil.py::z_slab_correction) and the phantom-element
// subtraction of the sharded certification apply
// (fea_tpu/parallel/halo.py::ZShardedSolver._exact_res_T). None of them
// exists here. The slab logic is compiled out of the whole-grid instance;
// the per-node body and its FMA order are the same in both, so a slab's
// planes are bit for bit what the unchunked kernel writes there.
//
// Bound: at ideal neighbour reuse each node moves 3 values in and 3 out
// (24 B in f32, 48 B in f64) and does 27 x 9 = 243 FMAs, about 20 flop/B
// in f32 and 10 flop/B in f64. Both sit near the card's plain (non-tensor)
// FP32 and FP64 ridge points, so neither bytes nor FMAs can be ignored.
// A slab adds its two halo planes to the bytes. This first form relies on
// L1/L2 for neighbour reuse and keeps no tile in shared memory.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError() as an int; the Python wrapper raises when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int axis_class(int64_t i, int64_t n) {
    return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}

// Output planes [z0, z0 + Zout) of the grid of z_real planes, from an
// input that holds global planes [zin0, ...); both (planes, Y, X, 3). The
// whole-grid instance (kSlab = false) has z0 = zin0 = 0 and z_real = Zout
// fixed at compile time, and compiles to K1/K2's code as it was before the
// slab forms existed.
template <typename T, bool kSlab>
__global__ void stencil27_kernel(const T* __restrict__ W,
                                 const T* __restrict__ g,
                                 T* __restrict__ out,
                                 int64_t X, int64_t Y, int64_t Zout,
                                 int64_t z0, int64_t zin0, int64_t z_real) {
    const int64_t n = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (n >= X * Y * Zout) return;
    const int64_t x = n % X;
    const int64_t t = n / X;
    const int64_t y = t % Y;
    const int64_t z = kSlab ? z0 + t / Y : t / Y;  // global plane
    const int64_t Z = kSlab ? z_real : Zout;
    if (kSlab && z >= Z) {  // zero padding past the real z-max plane
        out[n * 3 + 0] = T(0);
        out[n * 3 + 1] = T(0);
        out[n * 3 + 2] = T(0);
        return;
    }
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
                const T* __restrict__ u = g + (((kSlab ? zz - zin0 : zz) * Y + yy) * X + xx) * 3;
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

template <typename T, bool kSlab>
int launch(const T* W, const T* g, T* out, int64_t X, int64_t Y, int64_t Zout,
           int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    const int64_t nodes = X * Y * Zout;
    const int64_t blocks = (nodes + kThreads - 1) / kThreads;
    stencil27_kernel<T, kSlab><<<static_cast<unsigned int>(blocks), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(W, g, out, X, Y, Zout, z0, zin0, z_real);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1: f32 K @ u, used by the f32 V-cycle levels.
extern "C" int fea_stencil_apply_f32(const float* W, const float* g, float* out,
                                     int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, false>(W, g, out, X, Y, Z, 0, 0, Z, stream);
}

// K2: f64 K @ u, used by the FCG apply, the true-residual check, the
// reactions and the f64 V-cycle levels.
extern "C" int fea_stencil_apply_f64(const double* W, const double* g, double* out,
                                     int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, false>(W, g, out, X, Y, Z, 0, 0, Z, stream);
}

// K1's halo form: f32 K @ u on output planes [z0, z0 + Zout) of a grid of
// z_real planes, from input planes [zin0, ...). Used by the sharded
// V-cycle's f32 levels.
extern "C" int fea_stencil_apply_slab_f32(const float* W, const float* g, float* out,
                                          int64_t X, int64_t Y, int64_t Zout,
                                          int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    return launch<float, true>(W, g, out, X, Y, Zout, z0, zin0, z_real, stream);
}

// K3: the same in f64, used by the sharded FCG apply, its true-residual
// check and reactions, the sharded f64 V-cycle levels, and the chunked
// apply (ops/cuda_stencil.py::stencil_apply_chunked).
extern "C" int fea_stencil_apply_slab_f64(const double* W, const double* g, double* out,
                                          int64_t X, int64_t Y, int64_t Zout,
                                          int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    return launch<double, true>(W, g, out, X, Y, Zout, z0, zin0, z_real, stream);
}
