// Variable-weight 27-offset block stencil on the card: K4 (f32) and K5 (f64),
// whole and on one z slab, raw and masked.
//
//   out[n] = sum over the 27 offsets d of W_d[n] @ g[n + d]
//
// on the node-major (Z, Y, X, 3) grid, with a 3x3 block per node and
// offset: the assembled stiffness of a hex8 mesh whose connectivity is the
// box grid and whose node positions are free (the curvilinear route). The
// masked form computes F * K(F * g) + (1 - F) * g in the one launch, F the
// 0/1 free mask in g's layout: each neighbour's state is read as F * g, and
// the output is F * (K . ) + (1 - F) * g. Every product by a 0/1 value is
// exact, so a masked launch is, value for value, that expression written
// around the raw launch.
//
// Replaces the TPU kernels
//   K4  fea_tpu/ops/pallas_varstencil.py::var_apply_transposed     (_kernel_var27)
//   K5  fea_tpu/ops/pallas_varstencil.py::var_apply_transposed_dd  (_kernel_var27_dd)
// and, for the masked form, the expression the JAX package writes around
// them (fea_tpu/ops/curvilinear.py, the operator's and each level's apply).
// K5 computes in native FP64; the TPU kernel emulated f64 with f32
// (hi, lo) pairs, Veltkamp splits and TwoSum only because that chip has
// no IEEE f64.
//
// Layout: the weight field is the kernel's own, plane-major
// W[(d * 3 + r) * 3 + c][n] with n = (z * Y + y) * X + x, i.e. a
// contiguous (27, 3, 3, Z, Y, X) tensor (fea_tpu_torch/ops/curvilinear.py).
// A warp's read of one of the 243 planes at 32 consecutive nodes is one
// coalesced run, at the node itself or shifted to its neighbour. The state
// g, the mask and the output keep the node-major (Z, Y, X, 3) layout of the
// public arrays.
//
// Input contract: the field is exactly block-symmetric,
//   W_{26-d}[n + d] = W_d[n]^T  wherever n + d is inside the grid,
// which every producer of the port guarantees (curvilinear.py::
// symmetrize_field at the end of the assembly, of each Galerkin level and
// of every field that comes in from the host; slabs are cut from
// symmetrized fields). An assembled hex8 stiffness is symmetric, and so is
// a Galerkin level P^T A P with R = P^T, so the producers change a field at
// rounding level only. The whole form reads no weight toward a neighbour
// outside the grid.
//
// Bound: on a symmetric field 13 of the 27 blocks repeat the other 14
// (offset index d >= 13: the nine of dz = +1, the centre, (0,0,+1) and
// (0,+1,-1..+1)), so the least traffic is 126 values a node plus the
// state in and out: ~528 B a node in f32 and ~1,056 B in f64 for 243 FMAs,
// far under the card's ridge points. The first form of this kernel read
// all 27 blocks from memory, one thread a node, at about the card's
// achievable memory rate (79-85% of its 27-block bound): halving the bytes
// is the lever, and keeping the first form's occupancy is what lets it
// work. This form:
//
//   * Reads only the upper blocks. The lower offset d's block at n is the
//     transpose of upper block e = 26 - d at n + d, so term d reads block e
//     at the neighbour, column by column.
//   * Takes the 27 terms in the pairs (d, 26 - d), d = 0..12, then the
//     centre: term d (block e at n + d) and at once term e (block e at n).
//     The thread at n + d reads its own block e in the same pair, at the
//     same point of the same code, so the two reads of each stored block
//     meet in the L2 (or L1) and the block leaves memory once. One thread
//     a node in 256-thread blocks, ~60 registers, no shared memory: the
//     card holds most of the 811,923-DOF grid's threads at once, and every
//     block's partners (one plane away at most: 1,681 nodes, 7 blocks) run
//     beside it.
//   * Sums in that pair order, not the first form's offset order 0..26:
//     the output differs from the first form's by rounding, and from the
//     plain version (curvilinear.py::curv_apply_grid) within the same
//     tolerances as before. The slab form sums in the same order, so a
//     slab is, value for value, the whole grid's apply on its planes.
//
//   Two designs that kept the first form's order were built and timed on
//   an H100 and dropped, neither faster than the first form: a block that
//   marches a tile over z planes with the dz = +1 blocks staged in shared
//   memory by cp.async (its barriers and low occupancy left it latency
//   bound), and three threads a node, each keeping its row of the 13 upper
//   blocks in registers until their turn (register pressure, and no L2
//   reuse worth having).
//
// Offsets are 64-bit: 243 planes x 270,641 nodes is already 6.6e7.
//
// Slab form (K4-slab, K5-slab): the same body on one z slab of a sharded
// grid (fea_tpu_torch/parallel/curv.py). The weights are the slab's own,
// (27, 3, 3, Zl, Y, X), and the state is the slab between its neighbours'
// edge planes, (Zl + 2, Y, X, 3): output plane z reads state planes z,
// z + 1 and z + 2. No z term is skipped. On the slab's first plane the
// dz = -1 terms read the slab's own lower blocks (their mirrors lie on the
// neighbouring shard); this is exact because the field was symmetrized
// before it was cut. Toward a plane past the global ends the assembled
// weights are zero and the halo there holds zeros, so each such term adds
// an exact zero: a slab's output is, value for value, the unsharded
// kernel's on the same planes. Padding planes past the grid carry zero
// weights, mirror the zero dz = +1 blocks of the grid's last plane, and
// come out 0.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError() as an int; the Python wrapper raises when it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// acc[r] += sum over c of w(r, c) u[c], columns 2, 1, 0 fused in that
// order, with w(r, c) = w[r * rs + c * cs]: (rs, cs) = (3N, N) reads a
// block as stored, (N, 3N) its transpose.
template <typename T>
__device__ __forceinline__ void block_term(T acc[3], const T* __restrict__ w, int64_t rs, int64_t cs,
                                           const T u[3]) {
#pragma unroll
    for (int r = 0; r < 3; ++r)
        acc[r] = fma(__ldg(w + r * rs), u[0],
                     fma(__ldg(w + r * rs + cs), u[1], fma(__ldg(w + r * rs + 2 * cs), u[2], acc[r])));
}

// kSlab: g (and F) hold Z + 2 planes, plane z + 1 being output plane z.
// kMasked: the neighbours' state is F * g, and the output F * K + (1 - F) * g.
template <typename T, bool kSlab, bool kMasked>
__global__ void __launch_bounds__(kThreads)
var27_sym_kernel(const T* __restrict__ W, const T* __restrict__ g, const T* __restrict__ F,
                 T* __restrict__ out, int64_t X, int64_t Y, int64_t Z) {
    const int64_t YX = X * Y;
    const int64_t N = YX * Z;
    const int64_t n = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    if (n >= N) return;
    const int64_t x = n % X;
    const int64_t t = n / X;
    const int64_t y = t % Y;
    const int64_t z = t / Y;
    const int64_t gn = kSlab ? n + YX : n;  // the node in g
    // neighbour (dz, dy, dx) inside the grid (a slab's halo planes count as inside)
    auto inside = [&](int dz, int dy, int dx) {
        return (kSlab || (z + dz >= 0 && z + dz < Z)) && y + dy >= 0 && y + dy < Y && x + dx >= 0 && x + dx < X;
    };
    // the state of the neighbour at flat offset off, masked where asked
    auto state = [&](int64_t off, T u[3]) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            const int64_t m = (gn + off) * 3 + c;
            u[c] = kMasked ? __ldg(F + m) * __ldg(g + m) : __ldg(g + m);
        }
    };
    T acc[3] = {T(0), T(0), T(0)};
    T u[3];
#pragma unroll
    for (int d = 0; d < 13; ++d) {
        const int dz = d / 9 - 1, dy = d / 3 % 3 - 1, dx = d % 3 - 1;
        const int e = 26 - d;
        const int64_t off = dz * YX + dy * X + dx;
        // term d: block e at n + d, transposed; on a slab's first plane the
        // node's own lower block d
        if (inside(dz, dy, dx)) {
            state(off, u);
            if (kSlab && dz == -1 && z == 0) {
                block_term(acc, W + static_cast<int64_t>(d * 9) * N + n, 3 * N, N, u);
            } else {
                block_term(acc, W + static_cast<int64_t>(e * 9) * N + n + off, N, 3 * N, u);
            }
        }
        // term e: block e at n
        if (inside(-dz, -dy, -dx)) {
            state(-off, u);
            block_term(acc, W + static_cast<int64_t>(e * 9) * N + n, 3 * N, N, u);
        }
    }
    state(0, u);
    block_term(acc, W + static_cast<int64_t>(13 * 9) * N + n, 3 * N, N, u);
#pragma unroll
    for (int r = 0; r < 3; ++r) {
        if (kMasked) {
            const T f = __ldg(F + gn * 3 + r);
            out[n * 3 + r] = f * acc[r] + (T(1) - f) * __ldg(g + gn * 3 + r);
        } else {
            out[n * 3 + r] = acc[r];
        }
    }
}

template <typename T, bool kSlab, bool kMasked>
int launch(const T* W, const T* g, const T* F, T* out, int64_t X, int64_t Y, int64_t Z, void* stream) {
    const int64_t blocks = (X * Y * Z + kThreads - 1) / kThreads;
    var27_sym_kernel<T, kSlab, kMasked><<<static_cast<unsigned>(blocks), kThreads, 0,
                                          static_cast<cudaStream_t>(stream)>>>(W, g, F, out, X, Y, Z);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K4: f32 variable-weight apply, used by the f32 V-cycle levels.
extern "C" int fea_var_apply_f32(const float* W, const float* g, float* out,
                                 int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, false, false>(W, g, nullptr, out, X, Y, Z, stream);
}

// K5: f64 variable-weight apply, used by the FCG apply, the true-residual
// check, the reactions and the f64 V-cycle levels.
extern "C" int fea_var_apply_f64(const double* W, const double* g, double* out,
                                 int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, false, false>(W, g, nullptr, out, X, Y, Z, stream);
}

// K4-slab: K4 on one z slab, g (Zl + 2, Y, X, 3) -> out (Zl, Y, X, 3) with
// Z = Zl; used by the sharded curvilinear V-cycle's f32 levels.
extern "C" int fea_var_apply_slab_f32(const float* W, const float* g, float* out,
                                      int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, true, false>(W, g, nullptr, out, X, Y, Z, stream);
}

// K5-slab: K5 on one z slab; used by the sharded FCG apply, the
// true-residual check, the reactions and the f64 sharded levels.
extern "C" int fea_var_apply_slab_f64(const double* W, const double* g, double* out,
                                      int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, true, false>(W, g, nullptr, out, X, Y, Z, stream);
}

// The masked forms, used by the operators' and the levels' masked apply:
// F has g's shape (on a slab, the mask between its neighbours' edge planes).
extern "C" int fea_var_apply_masked_f32(const float* W, const float* g, const float* F, float* out,
                                        int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, false, true>(W, g, F, out, X, Y, Z, stream);
}

extern "C" int fea_var_apply_masked_f64(const double* W, const double* g, const double* F, double* out,
                                        int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, false, true>(W, g, F, out, X, Y, Z, stream);
}

extern "C" int fea_var_apply_slab_masked_f32(const float* W, const float* g, const float* F, float* out,
                                             int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float, true, true>(W, g, F, out, X, Y, Z, stream);
}

extern "C" int fea_var_apply_slab_masked_f64(const double* W, const double* g, const double* F, double* out,
                                             int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double, true, true>(W, g, F, out, X, Y, Z, stream);
}
