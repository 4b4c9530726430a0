// Structured hex8 voxel stencil K @ u on the card: K1 (f32) and K2 (f64)
// over a whole grid, and their z-slab forms: K3 (f64) and K1's halo form
// (f32), which the z-sharded solve (fea_tpu_torch/parallel/halo.py) runs
// on each shard. Each has a masked form that computes the operator with
// Dirichlet rows, F * K(F * g) + (1 - F) * g, in the one launch.
//
// Replaces the TPU kernels
//   K1  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed     (_kernel27)
//       and its z_halo=True form on one shard (fea_tpu/parallel/halo.py)
//   K2  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed_dd  (_kernel27_dd)
//   K3  fea_tpu/ops/pallas_stencil.py::stencil_apply_transposed_dd_chunked
//       (K2's z_halo=True form on static z slabs)
// and, for the masked form, the expression the JAX package writes around
// them and leaves to XLA to fuse (fea_tpu/ops/transposed.py::masked_apply_T).
// K2 and K3 compute in native FP64; the TPU kernels emulated f64 with f32
// (hi, lo) pairs only because that chip has no IEEE f64.
//
// Layout: the node-major grid (Z, Y, X, 3) of box_hex_mesh order, not the
// TPU's (3, Y, X, Z). z is the slowest axis, so a z slab and its halo
// planes are one contiguous range of the grid, and a band of whole rows of
// one plane is one contiguous range of X * 3 * rows values.
//
// What bounds it: a node moves 3 values in and 3 out (24 B in f32, 48 B in
// f64; the masked form reads F too) and does 27 x 9 = 243 FMAs: about 20
// flop/B in f32 and 10 in f64, both at the card's plain FP32/FP64 ridge.
// Neither limit is what a kernel meets first. Every operand that reaches an
// FMA through a load, from L1 or from shared memory, a broadcast included,
// fills 32 lanes' registers at 128 bytes a clock an SM: one value costs a
// warp a clock (two in f64), where its FMA costs a quarter (a half). The
// first form of this kernel (one thread a node, 81 neighbour and 243 weight
// loads through L1 for 243 FMAs) ran at that rate: 3-16% of the bound. This
// form cuts the loads, not the bytes:
//
//   * A block owns a band of BY whole rows (all X nodes of each) and a
//     chunk of output planes, and marches along z. Each input plane's band
//     (rows y0 - 1 .. y0 + BY, one contiguous range) is copied from global
//     to shared memory once, by cp.async in 16-byte pieces. No alignment
//     is asked of the grid, of a row (X * 3 values) or of a view: the tile
//     is laid in shared memory at the misalignment its values have in
//     global memory, so that whole pieces stay whole, and the pieces at
//     the band's ends go value by value; rows outside the grid and one
//     node of slack at each end are zero-filled by the same instruction
//     (src-size 0). The copies run kPrefetch planes ahead of the
//     arithmetic in a ring of tiles, with one barrier a plane.
//   * One thread a node of the band, the same (y, x) for the whole march.
//     For each input plane it reads its 27 neighbour values from shared
//     memory once into registers (27 loads a node where the first form
//     issued 81), and adds the plane's three dz blocks to the three
//     outputs in flight: the planes above, at and below it.
//   * The weights. The region table W[(rz*3+ry)*3+rx][((dz+1)*3+(dy+1))*3
//     +(dx+1)][3][3] (fea_tpu_torch/ops/cuda_stencil.py::region_weight_table)
//     has one block that nearly every node uses, the interior region's. It
//     rides in the kernel's parameters, which lie in the constant bank: an
//     FMA takes such a weight as an operand, with no load at all. A warp
//     takes that path when all its lanes are interior nodes; threads are
//     laid over the warps so that most are (BandPlan). Any other warp, and
//     the two z-face planes, read the weights of each lane's own region
//     from a copy of the table in shared memory (only the regions the
//     block can meet are staged), each (region, dz) block of 81 values
//     padded to 84 so that it is read in 16-byte pieces. A (class, offset)
//     pair whose supporting element does not exist carries a zero block,
//     and what lies outside the grid is zero in shared memory, so the
//     inner loops have no bounds checks.
//   * The order of a node's FMAs is (dz, dy, dx), then the three columns
//     from the last to the first, whatever the band, the chunk or the slab
//     it falls in: the march adds plane z - 1, then z, then z + 1 to output
//     z. That is the first form's order, so results are bit for bit those
//     of that kernel (signed zeros aside), a slab's planes are bit for bit
//     the whole grid's, and iteration counts do not move.
//   * The mask (kMasked): F, a 0/1 grid of g's shape and dtype, rides the
//     same copies into a second ring; a neighbour value is F * g as it
//     enters the registers, and the store writes F ? K(F g) : g. With F
//     exactly 0 or 1 that is the unfused expression value for value.
//   * The launch cuts z into chunks so that the blocks are one wave of
//     what the card holds at once (cudaOccupancyMaxActiveBlocksPer-
//     Multiprocessor): every block pays for staging its weights and filling
//     its pipeline, and a second wave would pay it again.
//
// Where it stands on an H100 (700 W; chip_smoke.py [3]): 1.4-1.6x the
// first form at 8,124,675 DOF raw, and the masked form 1.7-2.0x the six
// launches it replaces; still 5x (f32) and 4x (f64) off the bound. On the
// coarse multigrid levels (17x17x161 nodes and below: 1-40 blocks) a launch
// is all latency, and staging the weights and filling the pipeline first
// makes this form 2-3 us slower than the first (10-15 us against 10-13;
// chip_pair.py); its masked form is still ahead of the six launches. A weight
// that is an operand from the constant bank turned out to cost about what a
// load costs (the interior path gains 5% in f32, 15-25% in f64), so the
// weights' traffic, 243 values a node whatever their source, still sets
// the time. What else was tried and did not pay, so that it is not tried
// again blind: all nine z-interior regions in the parameters (nine unrolled
// copies of the FMAs thrash the instruction cache: 1.3-2.6x slower); two to
// four planes a step sharing each weight piece read from shared memory
// (130-168 registers, fewer warps an SM: no faster); three lanes a node,
// each holding one dz block's 81 weights in registers and handing its
// partial sum on by a shuffle (bit for bit too, fastest on the coarse
// grids, but 162 registers of weights in f64 leave a block one row:
// 1.1-1.4x slower at 8.1M DOF); a whole chunk of planes resident in shared
// memory with nine passes over it, each pass's 27 weights in registers
// (0.09 ms f32 raw at 8.1M DOF, but the mask then doubles the shared
// memory or costs a pass of its own: masked 1.4x slower than this form),
// and the same with the passes over (dy, dx) so that a pass loads 3 values
// for 27 FMAs (another FMA order; 137 registers, one block an SM, the
// copies and the arithmetic no longer overlap: 0.12 ms).
//
// Slabs: the kernel is told the global index z0 of its first output plane,
// the global index zin0 of the first plane of its input, the number of
// input planes, and the real global plane count z_real. The z class of an
// output comes from its global plane, and input planes outside
// [0, z_real) count as zero, so a slab sees the global z-min and z-max
// faces wherever they fall: on any shard, mid-slab, with zero padding past
// the real z-max plane (output planes there are written 0, or g where the
// mask is 0). The TPU form needed three extra mechanisms for that
// (fea_tpu/parallel/halo.py::_gate_w, pallas_stencil.py::z_slab_correction,
// ZShardedSolver._exact_res_T); none of them exists here. The whole grid is
// the slab with z0 = zin0 = 0 and z_real = Zin = Zout: one kernel body.
//
// Wide rows: a block of whole rows, one thread a node, holds a row of at
// most kWholeRowNodes = 256 nodes, fewer where five tiles of three such rows
// (ten with the mask) exceed its shared memory (the widest grid of the
// package's scenes has 65). A wider grid is cut along x too: grid.z segments of at most
// kSegNodes nodes, and a block owns a segment of its band's rows. Its tile
// then holds the segment between one halo node column each side, row by
// row, copied value by value (a tile row is no longer next to the following
// one in global memory, so the pieces would not stay whole); columns outside
// the grid are zero-filled like rows outside it. The same threads do the
// same FMAs in the same order, so a wide grid is bit for bit what whole
// rows would give; only the end segments hold a face column.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError() as an int; the Python wrapper raises when it is not 0.

#include <cstdint>
#include <mutex>

#include <cuda_runtime.h>

namespace {

constexpr int kPrefetch = 3;                 // planes whose copies are in flight ahead of the arithmetic
constexpr int kStages = kPrefetch + 2;       // tiles in the ring: a thread may lag one step behind
constexpr int kMaxThreads = 320;             // a block: rows or segments of rows, one thread a node
constexpr int kWholeRowNodes = 256;          // the widest row a block holds whole
constexpr int kSegNodes = 128;               // nodes of a segment of a wider row, at most
constexpr int kPad = 4;                      // values before a tile's band: the slack node, in whole 16-byte pieces
constexpr int kBlockVals = 84;               // one (region, dz) block in shared memory: 81 weights, padded to pieces
constexpr int kRegionVals = 3 * kBlockVals;  // one region in shared memory
constexpr int kTableVals = 27 * kRegionVals;
constexpr int kMinChunkPlanes = 4;           // output planes a block marches over, at least
constexpr int kMaxDevices = 64;
constexpr int kMaxAsked = 16;                // block shapes whose occupancy is kept
constexpr size_t kMaxShared = 232448;        // bytes of shared memory a block can use on sm_90
constexpr int kThreadsTarget = 288;          // nodes a band aims at
constexpr int kMaxBlocksPerSM = 8;           // blocks an SM counted on when the chunks are cut

template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

// The interior region's weights, a parameter of the kernel: they lie in the
// card's constant bank.
template <typename T> struct ConstWeights { T w[243]; };

__device__ __forceinline__ void unpack(const float4& v, float* p) {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
}
__device__ __forceinline__ void unpack(const double2& v, double* p) {
    p[0] = v.x; p[1] = v.y;
}

__host__ __device__ inline int axis_class(int64_t i, int64_t n) {
    return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}

// Values of one plane's tile in shared memory: kPad, up to a piece less one
// of misalignment, the band with its two halo rows, a slack node; in whole
// 16-byte pieces.
template <typename T>
__host__ __device__ constexpr int tile_values(int BY, int X) {
    constexpr int P = 16 / sizeof(T);
    return (kPad + (P - 1) + (BY + 2) * 3 * X + 3 + P - 1) / P * P;
}

// How the nodes of one block (columns [x0, x0 + BX) of rows [y0, y0 + BY)
// of a Y x X plane; BX == X for whole rows) are laid over its warps, so
// that the lanes of a warp share a weight region: the x-interior nodes of
// the y-interior rows first (all one region), then the x-interior nodes of
// the y = 0 row and of the y = Y - 1 row where the band has them, then the
// x = 0 column and the x = X - 1 column where the segment has them, each
// group starting a new warp.
struct BandPlan {
    int rows;      // rows of the band inside the grid
    int in_first;  // first y-interior row, relative to y0
    int in_rows;   // y-interior rows
    int xi_first;  // first x-interior node of the segment
    int xi;        // x-interior nodes a row of the segment
    bool has0, has2;    // the band holds row y = 0, row y = Y - 1
    bool hasx0, hasx2;  // the segment holds column x = 0, column x = X - 1
    int wA, wB, wC;     // warps of the interior group, of a face row, of a column

    __host__ __device__ BandPlan(int BY, int X, int Y, int y0, int x0, int BX) {
        const int y1 = y0 + BY < Y ? y0 + BY : Y;
        rows = y1 - y0;
        has0 = y0 == 0;
        has2 = y1 == Y;
        const int lo = y0 > 1 ? y0 : 1, hi = y1 < Y - 1 ? y1 : Y - 1;
        in_first = lo - y0;
        in_rows = hi > lo ? hi - lo : 0;
        const int x1 = x0 + BX < X ? x0 + BX : X;
        hasx0 = x0 == 0;
        hasx2 = x1 == X;
        const int xlo = x0 > 1 ? x0 : 1, xhi = x1 < X - 1 ? x1 : X - 1;
        xi_first = xlo;
        xi = xhi > xlo ? xhi - xlo : 0;
        wA = (in_rows * xi + 31) / 32;
        wB = (xi + 31) / 32;
        wC = (rows + 31) / 32;
    }
    __host__ __device__ int warps() const {
        return wA + (has0 ? wB : 0) + (has2 ? wB : 0) + ((hasx0 ? 1 : 0) + (hasx2 ? 1 : 0)) * wC;
    }
    // (row relative to y0, x) of thread tid, or row = -1 when it has no node
    __device__ void node(int tid, int Y, int y0, int X, int& row, int& x) const {
        row = -1;
        x = 0;
        int t = tid;
        if (t < 32 * wA) {
            if (t < in_rows * xi) { row = in_first + t / xi; x = xi_first + t % xi; }
            return;
        }
        t -= 32 * wA;
        if (has0) {
            if (t < 32 * wB) { if (t < xi) { row = 0; x = xi_first + t; } return; }
            t -= 32 * wB;
        }
        if (has2) {
            if (t < 32 * wB) { if (t < xi) { row = Y - 1 - y0; x = xi_first + t; } return; }
            t -= 32 * wB;
        }
        if (hasx0) {
            if (t < 32 * wC) { if (t < rows) { row = t; x = 0; } return; }
            t -= 32 * wC;
        }
        if (hasx2 && t < rows) { row = t; x = X - 1; }
    }
};

// One value global -> shared, asynchronously; zero when !valid (src-size 0
// reads nothing and fills the destination with zeros).
template <typename T>
__device__ __forceinline__ void cp_async_value(T* dst, const T* src, bool valid) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    const int n = valid ? static_cast<int>(sizeof(T)) : 0;
    if (sizeof(T) == 4) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
    } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n) : "memory");
    }
}
// 16 bytes global -> shared, asynchronously; both addresses 16-byte aligned.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait_but() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// acc[r] += sum over the 9 (dy, dx) offsets o of one dz block of
// w[o][r][c] * u[3 o + c]: offsets ascending, columns c = 2, 1, 0 within an
// offset. Two sources of w, one order of FMAs:
// the block in shared memory, read in 16-byte pieces just before their use
// (any region, any mix of regions in a warp) ...
template <typename T>
__device__ __forceinline__ void block_fma_shared(const T* __restrict__ wb, const T* u, T* acc) {
    using V = typename Vec16<T>::type;
    constexpr int P = 16 / sizeof(T);  // values a piece
    const V* __restrict__ wv = reinterpret_cast<const V*>(wb);
    T w[kBlockVals];
#pragma unroll
    for (int o = 0; o < 9; ++o) {
#pragma unroll
        for (int j = 0; j < kBlockVals / P; ++j) {
            if (j >= (9 * o + P - 1) / P && j < (9 * o + 9 + P - 1) / P) unpack(wv[j], w + j * P);
        }
        const T u0 = u[3 * o], u1 = u[3 * o + 1], u2 = u[3 * o + 2];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            const T* wr = w + 9 * o + 3 * r;
            acc[r] = fma(wr[0], u0, fma(wr[1], u1, fma(wr[2], u2, acc[r])));
        }
    }
}
// ... or the kernel's parameters, which hold the interior region: every
// weight is an operand of its FMA from the constant bank, and no load is
// issued for it (a warp whose lanes all lie in the interior region).
template <typename T, int DZB>
__device__ __forceinline__ void block_fma_const(const ConstWeights<T>& cw, const T* u, T* acc) {
#pragma unroll
    for (int o = 0; o < 9; ++o) {
        const T u0 = u[3 * o], u1 = u[3 * o + 1], u2 = u[3 * o + 2];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            const T* wr = cw.w + DZB * 81 + 9 * o + 3 * r;
            acc[r] = fma(wr[0], u0, fma(wr[1], u1, fma(wr[2], u2, acc[r])));
        }
    }
}

// Output planes [z0, z0 + Zout) of the grid of z_real planes, from an input
// that holds global planes [zin0, zin0 + Zin); all (planes, Y, X, 3). F is
// read only when kMasked, with g's geometry. Block (band, chunk, segment):
// rows [band * BY, band * BY + BY), output planes [z0 + chunk * ZC, ... +
// ZC), and when kSeg columns [segment * BX, segment * BX + BX), else whole
// rows (BX is not read). kSeg is compiled in so that the whole-row kernel
// carries nothing of the segments.
// W is the whole region table in global memory, cw its interior region.
// Step s of a block's march takes input plane zs - 1 + s; whatever depends
// on the step alone is a 32-bit count of steps or a pointer advanced by one
// plane, so that a step costs few instructions besides its loads and FMAs.
template <typename T, bool kMasked, bool kSeg>
__global__ void __launch_bounds__(kMaxThreads)
stencil27_kernel(const __grid_constant__ ConstWeights<T> cw, const T* __restrict__ W,
                 const T* __restrict__ g, const T* __restrict__ F, T* __restrict__ out,
                 int X, int Y, int64_t Zout, int64_t Zin, int64_t z0, int64_t zin0, int64_t z_real,
                 int BY, int ZC, int BX) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const s_w = reinterpret_cast<T*>(smem_raw);
    const int row_vals = 3 * X;
    constexpr int P = 16 / sizeof(T);  // values a 16-byte piece
    // a tile row: the whole row of the grid, or the block's segment between two halo columns
    const int bx = kSeg ? BX : X;
    const int x0 = kSeg ? blockIdx.z * BX : 0;
    const int tn = kSeg ? BX + 2 : X;     // its nodes
    const int xoff = kSeg ? x0 - 1 : 0;   // the grid column of its first node
    const int ts = 3 * tn;                // its values
    const int tile_vals = tile_values<T>(BY, tn);
    T* const s_g = s_w + kTableVals;
    T* const s_f = s_g + kStages * tile_vals;  // used only when kMasked

    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int y0 = blockIdx.x * BY;
    const int64_t zs = z0 + static_cast<int64_t>(blockIdx.y) * ZC;  // outputs [zs, ze), global planes
    const int64_t ze = min(zs + ZC, z0 + Zout);
    const int64_t plane_vals = static_cast<int64_t>(Y) * row_vals;
    const int nsteps = static_cast<int>(ze - zs + 2);  // planes zs - 1 .. ze
    const int64_t p_first = zs - 1;
    auto clamp_step = [&](int64_t v) { return static_cast<int>(max(int64_t(0), min(v, int64_t(nsteps)))); };
    // steps whose plane the input holds, and of those the ones inside the grid
    const int have_lo = clamp_step(zin0 - p_first), have_hi = clamp_step(zin0 + Zin - p_first);
    const int real_lo = max(have_lo, clamp_step(-p_first)), real_hi = min(have_hi, clamp_step(z_real - p_first));
    // at step s, dz block dzb goes to output t = zs + s - dzb: the steps
    // where t is one of this block's outputs inside the grid, and the two
    // where it is a z face
    int ok_lo[3], ok_hi[3], face0[3], face2[3];
#pragma unroll
    for (int dzb = 0; dzb < 3; ++dzb) {
        ok_lo[dzb] = max(real_lo, dzb);
        ok_hi[dzb] = min(real_hi, min(nsteps - 2 + dzb, clamp_step(z_real - zs + dzb)));
        face0[dzb] = static_cast<int>(max(int64_t(-2), min(dzb - zs, int64_t(1) << 30)));
        face2[dzb] = static_cast<int>(max(int64_t(-2), min(z_real - 1 - zs + dzb, int64_t(1) << 30)));
    }
    const int store_real_hi = clamp_step(z_real - zs + 2);  // output zs - 2 + s lies in the grid below this step

    // this thread's node, its region in a plane, and whether its whole
    // warp lies in the interior region, whose weights the parameters hold
    int row, x;
    BandPlan(BY, X, Y, y0, x0, bx).node(tid, Y, y0, X, row, x);
    const bool active = row >= 0;
    const int y = y0 + (active ? row : 0);
    const int ryx = axis_class(y, Y) * 3 + axis_class(x, X);
    const bool warp_interior = __all_sync(0xffffffffu, !active || ryx == 4);
    const int center = kPad + ((row + 1) * tn + x - xoff) * 3;  // this node in a tile, before the misalignment
    const T* const w_mine = s_w + ryx * kRegionVals;     // + rz * 9 * kRegionVals + dzb * kBlockVals

    // the weights of the regions this block can meet, for the warps and the
    // planes off the constant path: for each z and y class that occurs, the
    // three x classes are 729 consecutive values
    {
        const bool need_rz[3] = {zs == 0, true, z_real - 1 >= zs && z_real - 1 < ze};
        const bool need_ry[3] = {y0 == 0, true, Y - 1 >= y0 && Y - 1 < y0 + BY};
#pragma unroll
        for (int cz = 0; cz < 3; ++cz) {
#pragma unroll
            for (int cy = 0; cy < 3; ++cy) {
                if (!(need_rz[cz] && need_ry[cy])) continue;
                const int first = (cz * 3 + cy) * 3;  // region (cz, cy, 0)
#pragma unroll 3
                for (int i = tid; i < 3 * 243; i += nthreads) {
                    const int rx = i / 243, rem = i - rx * 243;
                    s_w[(first + rx) * kRegionVals + (rem / 81) * kBlockVals + rem % 81] = __ldg(W + first * 243 + i);
                }
            }
        }
    }

    // A tile holds band offset j (0 = row y0 - 1, x = 0, component 0) at
    // index kPad + m + j, m the misalignment of that value's address in
    // global memory, so that a 16-byte piece of the tile is a 16-byte piece
    // of global memory. Offsets [v_lo, v_hi) are rows of the grid; a piece
    // that lies inside them is one 16-byte copy, any other goes value by
    // value, zero where the grid has nothing. A tile of segments has no
    // misalignment: its rows go value by value, see copy_segments.
    const int v_lo = (max(y0 - 1, 0) - (y0 - 1)) * row_vals;
    const int v_hi = (min(y0 + BY + 1, Y) - (y0 - 1)) * row_vals;
    const int64_t first_off = (p_first - zin0) * plane_vals + static_cast<int64_t>(y0 - 1) * row_vals;
    const int dm = kSeg ? 0 : static_cast<int>(plane_vals & (P - 1));  // the misalignment's step from plane to plane
    auto misalign0 = [&](const T* base) {
        const int64_t at = static_cast<int64_t>(reinterpret_cast<uintptr_t>(base) / sizeof(T)) + first_off;
        return kSeg ? 0 : static_cast<int>(at & (P - 1));
    };
    auto copy_tile = [&](T* tile, const T* src, int m) {  // src: band offset 0 of the plane
        for (int i0 = tid * P; i0 < tile_vals; i0 += nthreads * P) {
            const int j0 = i0 - kPad - m;
            if (j0 >= v_lo && j0 + P <= v_hi) {
                cp_async_16(tile + i0, src + j0);
            } else {
                for (int e = 0; e < P; ++e) {
                    const bool valid = j0 + e >= v_lo && j0 + e < v_hi;
                    cp_async_value(tile + i0 + e, valid ? src + j0 + e : src + v_lo, valid);
                }
            }
        }
    };
    // the same for a block of segments: tile row r, value j is value 3 * xoff + j of grid row y0 - 1 + r
    auto copy_segments = [&](T* tile, const T* src) {
        for (int i = tid; i < (BY + 2) * ts; i += nthreads) {
            const int r = i / ts, j = i - r * ts;
            const int at = r * row_vals + 3 * xoff + j;  // band offset
            const bool valid = at >= v_lo && at < v_hi && 3 * xoff + j >= 0 && 3 * xoff + j < row_vals;
            cp_async_value(tile + kPad + i, valid ? src + at : src + v_lo, valid);
        }
    };
    // the copies run kPrefetch steps ahead: their own plane pointers, stage and misalignment
    const T* g_next = g + first_off;
    const T* f_next = kMasked ? F + first_off : nullptr;
    int m_g_next = misalign0(g), m_f_next = kMasked ? misalign0(F) : 0, stage_next = 0;
    auto issue = [&](int step) {  // one commit a call, so that the groups count the steps
        if (step >= have_lo && step < have_hi) {
            if (kSeg) {
                copy_segments(s_g + stage_next * tile_vals, g_next);
                if (kMasked) copy_segments(s_f + stage_next * tile_vals, f_next);
            } else {
                copy_tile(s_g + stage_next * tile_vals, g_next, m_g_next);
                if (kMasked) copy_tile(s_f + stage_next * tile_vals, f_next, m_f_next);
            }
        }
        cp_async_commit();
        g_next += plane_vals;
        if (kMasked) f_next += plane_vals;
        m_g_next = (m_g_next + dm) & (P - 1);
        m_f_next = (m_f_next + dm) & (P - 1);
        stage_next = stage_next + 1 == kStages ? 0 : stage_next + 1;
    };

    T acc[3][3];  // acc[j]: output plane p - 1 + j while plane p is added
#pragma unroll
    for (int j = 0; j < 3; ++j) acc[j][0] = acc[j][1] = acc[j][2] = T(0);
    T g_prev[3] = {T(0), T(0), T(0)}, f_prev[3] = {T(0), T(0), T(0)};  // this node on the plane before
    int m_g = m_g_next, m_f = m_f_next, stage = 0;
    T* o = out + (zs - 2 - z0) * plane_vals + (static_cast<int64_t>(y) * X + x) * 3;  // output zs - 2 + s

#pragma unroll 1
    for (int s = 0; s < kPrefetch; ++s) issue(s);
#pragma unroll 1
    for (int s = 0; s < nsteps; ++s) {
        issue(s + kPrefetch);
        cp_async_wait_but<kPrefetch>();
        __syncthreads();

        T g_c[3] = {T(0), T(0), T(0)}, f_c[3] = {T(0), T(0), T(0)};
        if (active) {
            const T* tg = s_g + stage * tile_vals + m_g + center;
            const T* tf = s_f + stage * tile_vals + m_f + center;
            if (kMasked && s >= have_lo && s < have_hi) {
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    g_c[c] = tg[c];
                    f_c[c] = tf[c];
                }
            }
            if (s >= real_lo && s < real_hi) {
                T u[27];
#pragma unroll
                for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
                    for (int k = 0; k < 9; ++k) {  // (dx, c): nine consecutive values
                        const int at = dy * ts + k - 3;
                        u[(dy + 1) * 9 + k] = kMasked ? tf[at] * tg[at] : tg[at];
                    }
                }
#pragma unroll
                for (int dzb = 0; dzb < 3; ++dzb) {  // plane p adds its dz block to output p - dz, acc[2 - dzb]
                    if (s >= ok_lo[dzb] && s < ok_hi[dzb]) {
                        if (s != face0[dzb] && s != face2[dzb]) {
                            if (warp_interior) {
                                if (dzb == 0) block_fma_const<T, 0>(cw, u, acc[2]);
                                if (dzb == 1) block_fma_const<T, 1>(cw, u, acc[1]);
                                if (dzb == 2) block_fma_const<T, 2>(cw, u, acc[0]);
                            } else {
                                block_fma_shared<T>(w_mine + 9 * kRegionVals + dzb * kBlockVals, u, acc[2 - dzb]);
                            }
                        } else {
                            const int rz = s == face0[dzb] ? 0 : 2;
                            block_fma_shared<T>(w_mine + rz * 9 * kRegionVals + dzb * kBlockVals, u, acc[2 - dzb]);
                        }
                    }
                }
            }
            if (s >= 2) {  // output zs - 2 + s is complete
#pragma unroll
                for (int c = 0; c < 3; ++c) {
                    T v = s < store_real_hi ? acc[0][c] : T(0);  // zero padding past the real z-max plane
                    if (kMasked) v = f_prev[c] != T(0) ? v : g_prev[c];
                    o[c] = v;
                }
            }
        }
        o += plane_vals;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            acc[0][c] = acc[1][c];
            acc[1][c] = acc[2][c];
            acc[2][c] = T(0);
            g_prev[c] = g_c[c];
            f_prev[c] = f_c[c];
        }
        m_g = (m_g + dm) & (P - 1);
        m_f = (m_f + dm) & (P - 1);
        stage = stage + 1 == kStages ? 0 : stage + 1;
    }
}

// Threads of a block of BY rows by BX columns: the most any block's plan asks.
int block_threads(int BY, int X, int Y, int BX) {
    int warps = 1;
    for (int y0 = 0; y0 < Y; y0 += BY) {
        for (int x0 = 0; x0 < X; x0 += BX) {
            const int w = BandPlan(BY, X, Y, y0, x0, BX).warps();
            if (w > warps) warps = w;
        }
    }
    return 32 * warps;
}

// What a launch asks of the runtime once and keeps: the SMs of a device,
// the kernel's shared-memory attributes on it, and the blocks an SM holds
// of each block shape. One mutex guards them all: the caller may launch
// from several host threads at once.
std::mutex g_setup_mutex;
struct Asked { int device, threads; size_t shared; int per_sm; };

// Sets `sms` and `per_sm` for `kernel` at this block shape on `device`.
template <typename Kernel>
cudaError_t launch_setup(Kernel kernel, bool* attr_set, Asked* asked, int* n_asked, int device, int threads,
                         size_t shared, int* sms, int* per_sm) {
    static int sm_cached[kMaxDevices] = {0};
    std::lock_guard<std::mutex> lock(g_setup_mutex);
    if (sm_cached[device] == 0) {
        int n = 0;
        if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || n < 1) n = 132;
        sm_cached[device] = n;
    }
    *sms = sm_cached[device];
    if (!attr_set[device]) {
        cudaError_t err =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxShared));
        if (err == cudaSuccess) {
            // all of the SM's L1 as shared memory, so that several blocks fit an SM
            err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       static_cast<int>(cudaSharedmemCarveoutMaxShared));
        }
        if (err != cudaSuccess) return err;
        attr_set[device] = true;
    }
    *per_sm = 0;
    for (int i = 0; i < *n_asked; ++i) {
        const Asked& a = asked[i];
        if (a.device == device && a.threads == threads && a.shared == shared) *per_sm = a.per_sm;
    }
    if (*per_sm == 0) {
        const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, shared);
        if (err != cudaSuccess) return err;
        if (*per_sm > 0 && *n_asked < kMaxAsked) asked[(*n_asked)++] = Asked{device, threads, shared, *per_sm};
    }
    return cudaSuccess;
}

// The blocks of one launch: BX columns by BY rows each, one thread a node.
struct Plan { int BX, BY, segs, bands, threads; size_t shared; };

// The plan for blocks of BX columns (BX == X: whole rows), or false when a
// block of one row of them exceeds kMaxThreads or the shared memory.
template <typename T, bool kMasked>
bool plan_blocks(int X, int Y, int BX, Plan* p) {
    const int tile_nodes = BX < X ? BX + 2 : X;  // a tile row: the kernel's tn
    auto shared_bytes = [&](int by) {
        const size_t tiles = (kMasked ? 2 : 1) * kStages * static_cast<size_t>(tile_values<T>(by, tile_nodes));
        return (kTableVals + tiles) * sizeof(T);
    };
    // rows a band: as many as the thread target holds, spread evenly over
    // the bands, fewer while the warps of a block's plan exceed a block or
    // the tiles exceed its shared memory
    int BY = kThreadsTarget / BX > 0 ? kThreadsTarget / BX : 1;
    const int bands = (Y + BY - 1) / BY;
    BY = (Y + bands - 1) / bands;
    while (BY > 1 && (block_threads(BY, X, Y, BX) > kMaxThreads || shared_bytes(BY) > kMaxShared)) --BY;
    *p = Plan{BX, BY, (X + BX - 1) / BX, (Y + BY - 1) / BY, block_threads(BY, X, Y, BX), shared_bytes(BY)};
    return p->threads <= kMaxThreads && p->shared <= kMaxShared;
}

template <typename T, bool kMasked, bool kSeg>
int launch_planned(const Plan& p, int device, const T* W_host, const T* W, const T* g, const T* F, T* out, int X,
                   int Y, int64_t Zout, int64_t Zin, int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    auto kernel = stencil27_kernel<T, kMasked, kSeg>;
    // planes a chunk: one wave of blocks, as many as the card holds at once
    // (every block pays for staging its weights and filling its pipeline),
    // each at least kMinChunkPlanes long to amortise its two halo planes
    // (asked of the runtime once for each block shape; a launch is on the host's critical path)
    static bool attr_set[kMaxDevices] = {false};
    static Asked asked[kMaxAsked] = {};
    static int n_asked = 0;
    int sms = 0, per_sm = 0;
    const cudaError_t err = launch_setup(kernel, attr_set, asked, &n_asked, device, p.threads, p.shared, &sms, &per_sm);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidValue);
    if (per_sm > kMaxBlocksPerSM) per_sm = kMaxBlocksPerSM;
    int64_t want_chunks = static_cast<int64_t>(sms) * per_sm / (static_cast<int64_t>(p.bands) * p.segs);
    if (want_chunks < 1) want_chunks = 1;
    int64_t ZC = (Zout + want_chunks - 1) / want_chunks;
    if (ZC < kMinChunkPlanes) ZC = kMinChunkPlanes;
    if (ZC > Zout) ZC = Zout;
    const int64_t chunks = (Zout + ZC - 1) / ZC;
    if (chunks > 65535 || p.segs > 65535) return static_cast<int>(cudaErrorInvalidValue);
    ConstWeights<T> cw;
    for (int i = 0; i < 243; ++i) cw.w[i] = W_host[13 * 243 + i];  // region (1, 1, 1)
    const dim3 grid(static_cast<unsigned int>(p.bands), static_cast<unsigned int>(chunks),
                    static_cast<unsigned int>(p.segs));
    kernel<<<grid, p.threads, p.shared, static_cast<cudaStream_t>(stream)>>>(
        cw, W, g, F, out, X, Y, Zout, Zin, z0, zin0, z_real, p.BY, static_cast<int>(ZC), p.BX);
    return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kMasked>
int launch_as(const T* W_host, const T* W, const T* g, const T* F, T* out, int64_t X, int64_t Y, int64_t Zout,
              int64_t Zin, int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    if (X < 2 || Y < 2 || Zout < 1 || Zin < 1 || X > (1 << 22) || Y > (1 << 20)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    int device = 0;
    const cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    const int Xi = static_cast<int>(X), Yi = static_cast<int>(Y);
    // whole rows where a block holds one; else even segments of the rows
    Plan p;
    if (Xi <= kWholeRowNodes && plan_blocks<T, kMasked>(Xi, Yi, Xi, &p)) {
        return launch_planned<T, kMasked, false>(p, device, W_host, W, g, F, out, Xi, Yi, Zout, Zin, z0, zin0, z_real,
                                                 stream);
    }
    const int want_segs = Xi > kSegNodes ? (Xi + kSegNodes - 1) / kSegNodes : 2;
    if (!plan_blocks<T, kMasked>(Xi, Yi, (Xi + want_segs - 1) / want_segs, &p)) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_planned<T, kMasked, true>(p, device, W_host, W, g, F, out, Xi, Yi, Zout, Zin, z0, zin0, z_real,
                                            stream);
}

template <typename T>
int launch(const T* W_host, const T* W, const T* g, const T* F, T* out, int64_t X, int64_t Y, int64_t Zout,
           int64_t Zin, int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    if (W_host == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return F != nullptr ? launch_as<T, true>(W_host, W, g, F, out, X, Y, Zout, Zin, z0, zin0, z_real, stream)
                        : launch_as<T, false>(W_host, W, g, nullptr, out, X, Y, Zout, Zin, z0, zin0, z_real, stream);
}

}  // namespace

// In every entry W_host and W are the region table (27, 27, 3, 3) in host
// and in device memory, and F is null for the raw K @ u, or the 0/1 mask
// grid of g's shape and dtype for F * K(F * g) + (1 - F) * g.

// K1: f32, used by the f32 V-cycle levels.
extern "C" int fea_stencil_apply_f32(const float* W_host, const float* W, const float* g, const float* F,
                                     float* out, int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<float>(W_host, W, g, F, out, X, Y, Z, Z, 0, 0, Z, stream);
}

// K2: f64, used by the FCG apply, the true-residual check, the reactions
// and the f64 V-cycle levels.
extern "C" int fea_stencil_apply_f64(const double* W_host, const double* W, const double* g, const double* F,
                                     double* out, int64_t X, int64_t Y, int64_t Z, void* stream) {
    return launch<double>(W_host, W, g, F, out, X, Y, Z, Z, 0, 0, Z, stream);
}

// K1's halo form: f32 on output planes [z0, z0 + Zout) of a grid of z_real
// planes, from the Zin input planes [zin0, zin0 + Zin). Used by the sharded
// V-cycle's f32 levels.
extern "C" int fea_stencil_apply_slab_f32(const float* W_host, const float* W, const float* g, const float* F,
                                          float* out, int64_t X, int64_t Y, int64_t Zout, int64_t Zin,
                                          int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    return launch<float>(W_host, W, g, F, out, X, Y, Zout, Zin, z0, zin0, z_real, stream);
}

// K3: the same in f64, used by the sharded FCG apply, its true-residual
// check and reactions, the sharded f64 V-cycle levels, and the chunked
// apply (ops/cuda_stencil.py::stencil_apply_chunked).
extern "C" int fea_stencil_apply_slab_f64(const double* W_host, const double* W, const double* g, const double* F,
                                          double* out, int64_t X, int64_t Y, int64_t Zout, int64_t Zin,
                                          int64_t z0, int64_t zin0, int64_t z_real, void* stream) {
    return launch<double>(W_host, W, g, F, out, X, Y, Zout, Zin, z0, zin0, z_real, stream);
}
