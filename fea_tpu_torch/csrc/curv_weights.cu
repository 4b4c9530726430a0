// The curvilinear weight field's assembly on the card: each hex8 element's
// stiffness blocks, computed in shared memory and registers, added straight
// into the (27, 3, 3, Z, Y, X) field.
//
//   W_d[n] += Ke[3a:3a+3, 3b:3b+3]  for n = p + c_a, d = c_b - c_a,
//
// element e at grid position p, corners a and b at offsets c_a, c_b in
// {0, 1}^3 (fea_tpu_torch/ops/structured.py::_CORNERS). The field layout is
// the kernels' own, plane-major (fea_tpu_torch/ops/curvilinear.py, and
// csrc/varstencil.cu, which reads it).
//
// Replaces no TPU kernel: the JAX package assembles the field with jnp ops
// (fea_tpu/ops/curvilinear.py::assemble_curv_weights, a batched Ke and 64
// slice-adds a chunk of element layers), and so did the port until this
// kernel, whose plain version that loop still is
// (curvilinear.py::assemble_curv_weights_plain). Launched from Python, the
// loop made ~6,000 launches a 40x40x160 assembly, and its time was the
// host's.
//
// Mathematics: 2x2x2 Gauss at the natural-gradient table D (elements/hex8.py
// ::_D_QP, computed by each block with the NumPy table's roundings, so the
// same values, and rounded to the field's dtype as the plain version
// rounds it; nothing is uploaded for it), the Jacobian
// J = D_q X inverted in closed form (adjugate over det, as hex8.py's _inv3),
// global gradients g = J^-1 D_q, and for the isotropic (lambda, mu)
//
//   Ke_ab[i][j] = sum_q detJ_q (lambda g_a,i g_b,j + mu g_a,j g_b,i + mu (g_a . g_b) [i = j]),
//
// which is B_a^T C B_b in Voigt form with engineering shear, summed in
// another order than the plain version's B^T (C B).
//
// Upper blocks only: the kernel adds the 36 corner pairs of an element whose
// offset index d = (dz+1)*9 + (dy+1)*3 + (dx+1) is >= 13, the 8 diagonal
// pairs and 28 of the 56 others. The field's 13 lower blocks stay zero, and
// symmetrize_field writes each as its mirror, as it does for every field:
// the field leaves the assembly exactly block-symmetric, as K4/K5 take it.
//
// Deterministic, no atomics. The elements are coloured by parity,
// c = 4 (ez & 1) + 2 (ey & 1) + (ex & 1), one launch a colour, in the order
// 0..7 on one stream. Two elements of one colour share no node; for one
// element the node p + c_a and the offset d fix the pair (a, b). So within
// one launch each (node, offset) block takes at most one plain +=, and over
// the 8 launches always the same elements' in the same order: two calls on
// one input give bitwise-equal fields. Nothing the size of the mesh is held
// but the field and one value an element, its least detJ over the 8
// quadrature points (+inf for a void cell), which the wrapper reduces.
//
// Bound: the field's bytes, as the kernel runs. At 40x40x160 (811,923 DOF)
// the 126 upper planes take 83M read-modify-writes of (node, offset)
// entries, ~1.3 GB in f64, where writing the 273 MB of planes once would
// take ~0.08 ms at 3.35 TB/s; the arithmetic as written is ~5.5 GFLOP in
// f64, ~0.16 ms at 34 TFLOP/s (chip_smoke.py's bound for W is the larger
// of the two). What the design does about the bytes: no (E, 24, 24) batch
// leaves the chip, each Ke block goes from registers to its place in the
// field once, and a warp's 32 tasks are two corner pairs of 16 elements of
// one colour, consecutive along x: each of its nine stores a pair is a run
// over one field plane at a stride of two nodes (a colour holds every
// other element along x). On an H100 at that size in f64 the 8 launches
// take ~1.5 ms, ~10% of the larger bound: each += moves a 32-byte sector
// for its 8 bytes, and the planes leave the 50 MB L2 between colours.
// That is ~1% of a fresh solve there, so the design stops here; a block
// that ran both x parities of a tile back to back would keep the sectors
// in cache.
//
// A block takes 16 elements of one colour (kTile). First its 192 threads
// write the table D into shared memory, one entry each. Phase 1, 128
// threads, one an (element, quadrature point): the Jacobian, its
// determinant and inverse, the 8 global gradients into shared memory; the
// element's least detJ over its 8 lanes by shuffles. Phase 2, all 192
// threads over the 16 x 36 (element, pair) tasks: the 3x3 block summed over
// the quadrature points from shared memory, then its nine += into the field.
//
// A void cell (the embedded route's valid mask, 0) is skipped whole: its
// geometry is not computed, so a degenerate void cell cannot carry an inf or
// a NaN anywhere, it adds nothing, and its detJ is +inf.
//
// Offsets are 64-bit: 243 planes x 270,641 nodes is already 6.6e7.
//
// Each extern "C" entry launches the 8 colours on the caller's stream and
// returns the first cudaGetLastError() that is not 0, as an int; the Python
// wrapper (fea_tpu_torch/ops/cuda_curv_weights.py) raises when it is not 0.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;                   // elements a block, all of one colour
constexpr int kThreads = 192;               // phase 1: kTile x 8 lanes; phase 2: 3 rounds of kTile x kPairs
constexpr int kPairs = 36;                  // corner pairs (a, b) with offset index >= 13
constexpr int kGeo = 8 * 3 * 8 + 8;         // an element's gradients (q, i, a) and its 8 detJ
constexpr int kStride = kGeo + 1;           // odd in doubles: the 16 elements of a half warp hit distinct banks

// (a, b) of the 36 upper pairs, a's pairs in b's order
__constant__ unsigned char kPair[kPairs][2] = {
    {0, 0}, {0, 1}, {0, 2}, {0, 3}, {0, 4}, {0, 5}, {0, 6}, {0, 7},
    {1, 1}, {1, 2}, {1, 3}, {1, 4}, {1, 5}, {1, 6}, {1, 7},
    {2, 2}, {2, 4}, {2, 5}, {2, 6}, {2, 7},
    {3, 2}, {3, 3}, {3, 4}, {3, 5}, {3, 6}, {3, 7},
    {4, 4}, {4, 5}, {4, 6}, {4, 7},
    {5, 5}, {5, 6}, {5, 7},
    {6, 6},
    {7, 6}, {7, 7},
};

// corner a's offset (z, y, x) in {0, 1}^3: the bottom face 0..3, counter-
// clockwise from the origin, then the top face 4..7 the same
__device__ __forceinline__ int corner_z(int a) { return a >> 2; }
__device__ __forceinline__ int corner_y(int a) { return (a & 3) >= 2; }
__device__ __forceinline__ int corner_x(int a) { return (a & 3) == 1 || (a & 3) == 2; }

// dN_a / dxi_i at Gauss point q (elements/hex8.py::natural_gradients):
// s_ai / 8 times the product over the two other axes o of (1 + g s_qo s_ao),
// g = 1 / sqrt(3), s the corners' signs (2 c - 1); the Gauss points carry
// the corners' signs. One rounded product scaled by a power of two, as in
// the NumPy table, whose values these are bit for bit.
__device__ __forceinline__ double natural_gradient(int q, int i, int a) {
    const int cq[3] = {corner_x(q), corner_y(q), corner_z(q)};
    const int ca[3] = {corner_x(a), corner_y(a), corner_z(a)};
    const double g = 1.0 / sqrt(3.0);
    double t = 1.0;
    for (int o = 0; o < 3; ++o)
        if (o != i) t *= 1.0 + g * static_cast<double>((2 * cq[o] - 1) * (2 * ca[o] - 1));
    return static_cast<double>(2 * ca[i] - 1) * 0.125 * t;
}

// min that keeps a NaN, as torch's amin does
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (a != a || a < b) ? a : b; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
curv_weights_kernel(const T* __restrict__ xyz, const uint8_t* __restrict__ valid,
                    T* __restrict__ W, T* __restrict__ detj_min, const T lam, const T mu,
                    const int64_t nx, const int64_t ny, const int64_t nz, const int pz, const int py, const int px) {
    __shared__ T geo[kTile * kStride];
    __shared__ int64_t node0[kTile];  // corner 0's flat node of a live slot, else -1
    __shared__ T D[8 * 3 * 8];        // D[q][i][a], kThreads entries

    const int64_t cx = (nx - px + 1) / 2, cy = (ny - py + 1) / 2, cz = (nz - pz + 1) / 2;
    const int64_t count = cx * cy * cz;
    const int64_t Xn = nx + 1, YXn = (ny + 1) * Xn, N = YXn * (nz + 1);
    const int t = threadIdx.x;
    static_assert(kThreads == 8 * 3 * 8, "one thread an entry of D");
    D[t] = static_cast<T>(natural_gradient(t / 24, t / 8 % 3, t % 8));
    __syncthreads();

    if (t < kTile * 8) {  // phase 1: warps 0-3 whole, so the shuffles see all their lanes
        const int s = t >> 3, q = t & 7;
        const int64_t l = static_cast<int64_t>(blockIdx.x) * kTile + s;
        const bool inside = l < count;
        int64_t e = 0, n0 = -1;
        if (inside) {
            const int64_t ex = 2 * (l % cx) + px, ey = 2 * (l / cx % cy) + py, ez = 2 * (l / (cx * cy)) + pz;
            e = (ez * ny + ey) * nx + ex;
            if (valid == nullptr || valid[e]) n0 = ez * YXn + ey * Xn + ex;
        }
        T* g = geo + s * kStride;
        T dj = static_cast<T>(INFINITY);
        if (n0 >= 0) {
            const T* Dq = D + q * 24;  // D[q][i][a]
            T J[3][3] = {};            // J[i][k] = d x_k / d xi_i
#pragma unroll
            for (int a = 0; a < 8; ++a) {
                const T* xa = xyz + (n0 + corner_z(a) * YXn + corner_y(a) * Xn + corner_x(a)) * 3;
                const T x0 = __ldg(xa), x1 = __ldg(xa + 1), x2 = __ldg(xa + 2);
#pragma unroll
                for (int i = 0; i < 3; ++i) {
                    const T dia = Dq[i * 8 + a];
                    J[i][0] = fma(dia, x0, J[i][0]);
                    J[i][1] = fma(dia, x1, J[i][1]);
                    J[i][2] = fma(dia, x2, J[i][2]);
                }
            }
            const T c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1];
            const T c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2];
            const T c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0];
            const T det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02;
            const T inv[3][3] = {  // the adjugate over det
                {c00 / det, (J[0][2] * J[2][1] - J[0][1] * J[2][2]) / det,
                 (J[0][1] * J[1][2] - J[0][2] * J[1][1]) / det},
                {c01 / det, (J[0][0] * J[2][2] - J[0][2] * J[2][0]) / det,
                 (J[0][2] * J[1][0] - J[0][0] * J[1][2]) / det},
                {c02 / det, (J[0][1] * J[2][0] - J[0][0] * J[2][1]) / det,
                 (J[0][0] * J[1][1] - J[0][1] * J[1][0]) / det},
            };
#pragma unroll
            for (int a = 0; a < 8; ++a) {
                const T d0 = Dq[a], d1 = Dq[8 + a], d2 = Dq[16 + a];
#pragma unroll
                for (int i = 0; i < 3; ++i)
                    g[q * 24 + i * 8 + a] = inv[i][0] * d0 + inv[i][1] * d1 + inv[i][2] * d2;
            }
            g[192 + q] = det;
            dj = det;
        }
        // the element's least detJ over its 8 lanes (+inf for a void cell)
#pragma unroll
        for (int off = 1; off < 8; off <<= 1) dj = nan_min(dj, __shfl_xor_sync(0xffffffffu, dj, off));
        if (q == 0) {
            node0[s] = n0;
            if (inside) detj_min[e] = dj;
        }
    }
    __syncthreads();

    // phase 2: task = pair-major, slot-minor, so a warp is 2 pairs x 16 elements
    for (int task = t; task < kTile * kPairs; task += kThreads) {
        const int p = task / kTile, s = task % kTile;
        const int64_t n0 = node0[s];
        if (n0 < 0) continue;
        const int a = kPair[p][0], b = kPair[p][1];
        const T* g = geo + s * kStride;
        T acc[3][3] = {};
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            const T* gq = g + q * 24;
            const T ga[3] = {gq[a], gq[8 + a], gq[16 + a]};
            const T gb[3] = {gq[b], gq[8 + b], gq[16 + b]};
            const T wl = g[192 + q] * lam, wm = g[192 + q] * mu;
            const T wdot = wm * (ga[0] * gb[0] + ga[1] * gb[1] + ga[2] * gb[2]);
#pragma unroll
            for (int i = 0; i < 3; ++i) {
#pragma unroll
                for (int j = 0; j < 3; ++j) acc[i][j] += wl * ga[i] * gb[j] + wm * ga[j] * gb[i];
                acc[i][i] += wdot;
            }
        }
        const int dz = corner_z(b) - corner_z(a), dy = corner_y(b) - corner_y(a), dx = corner_x(b) - corner_x(a);
        const int d = (dz + 1) * 9 + (dy + 1) * 3 + (dx + 1);
        const int64_t n = n0 + corner_z(a) * YXn + corner_y(a) * Xn + corner_x(a);
        T* wd = W + static_cast<int64_t>(d * 9) * N + n;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) wd[(i * 3 + j) * N] += acc[i][j];
        }
    }
}

template <typename T>
int launch(const T* xyz, const uint8_t* valid, T* W, T* detj_min, double lam, double mu,
           int64_t nx, int64_t ny, int64_t nz, void* stream) {
    for (int c = 0; c < 8; ++c) {
        const int pz = c >> 2, py = (c >> 1) & 1, px = c & 1;
        const int64_t count = ((nx - px + 1) / 2) * ((ny - py + 1) / 2) * ((nz - pz + 1) / 2);
        // an empty colour (an axis of one element) still launches one block, which exits
        const int64_t blocks = count > 0 ? (count + kTile - 1) / kTile : 1;
        curv_weights_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
            xyz, valid, W, detj_min, static_cast<T>(lam), static_cast<T>(mu), nx, ny, nz, pz, py, px);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

}  // namespace

// xyz: the nodes (Z, Y, X, 3) in box grid order; valid: (nz, ny, nx) 0/1 bytes or null; W: the zeroed
// (27, 3, 3, Z, Y, X) field; detj_min: (nz, ny, nx), each element's least
// detJ. nx, ny, nz count elements.
extern "C" int fea_curv_weights_f32(const float* xyz, const uint8_t* valid, float* W,
                                    float* detj_min, double lam, double mu, int64_t nx, int64_t ny, int64_t nz,
                                    void* stream) {
    return launch<float>(xyz, valid, W, detj_min, lam, mu, nx, ny, nz, stream);
}

extern "C" int fea_curv_weights_f64(const double* xyz, const uint8_t* valid, double* W,
                                    double* detj_min, double lam, double mu, int64_t nx, int64_t ny, int64_t nz,
                                    void* stream) {
    return launch<double>(xyz, valid, W, detj_min, lam, mu, nx, ny, nz, stream);
}
