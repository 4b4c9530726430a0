// The block-Thomas solve of a block-tridiagonal system from its factors, as
// one kernel: a cluster of 8 thread blocks walks the chain of layers.
//
//   forward   y_0 = r_0,   y_l = r_l - G_{l-1}^T y_{l-1}
//   diagonal  u_l = Uinv_l y_l
//   back      x_{L-1} = u_{L-1},   x_l = u_l - G_l x_{l+1}
//
// Uinv (L, b, b) and G (L - 1, b, b) are f32 and row-major, as
// fea_tpu_torch/ops/extruded_mg.py::_thomas_chain stores them; r and x are
// (L, b). The arithmetic is that module's plain version (_thomas_addmv: one
// addmv_ a layer a sweep around one batched product, 2 (L - 1) dependent
// launches), in f32 with f32 sums taken in another, fixed, order.
//
// Replaces no TPU kernel: the JAX package solves with jnp ops
// (fea_tpu/ops/extruded_mg.py). Added for the section rigid-body coarse
// space of an extruded mesh (SectionCoarse: L = 385 node layers of
// b = 168 on the 591,360-DOF tube), where the 768 dependent launches of
// the plain version cost 2.7 ms a solve on an H100 and its bytes 0.04 ms.
//
// Bound: the bytes are two reads of G and one of Uinv, ~130 MB at L = 385,
// b = 168 (0.039 ms at 3.35 TB/s); but the 2 L - 1 layer steps depend on
// each other, so the latency of one step bounds the kernel: a product of
// length b and one exchange between the cluster's blocks (an exchange alone,
// exchange_probe below, takes ~0.21 us a step on an H100). There the kernel
// takes ~0.75 ms at L = 385, b = 168 (~1 us a layer step: the partial sums,
// the waits and, one layer behind, the diagonal product), against ~2.6 ms
// for the plain version's 768 launches captured in a CUDA graph.
//
// Design. Block c of the cluster owns the rows [c R, c R + R) of every
// block matrix, R = ceil(b / 8) rounded up to even (so that every copy is
// 16-byte aligned and column pairs share an owner). It reads only its row
// slices of G_l and Uinv_l, each contiguous in the stored factors, by TMA
// bulk copies (cp.async.bulk) into two rings in shared memory. Thread 0
// refills a stage once every thread has read it; one thread of a diagonal
// warp waits on the stages the next step reads before the __syncthreads
// that ends a step (the refills there measured slower).
// Nothing of the factors is copied or re-laid out in device memory: the
// only scratch is the output x, which holds u between the sweeps.
//
//   * Forward step l, warps 0-3 (the chain): the transposed product from
//     the row slice. Block c sums p_c[i] = sum_{j in its rows} G_l[j][i]
//     y_l[j] (thread t the columns 2t and 2t + 1, its rows in four chains
//     j mod 4, in order) and sends the pair to the block that owns rows 2t
//     and 2t + 1; the owner forms y_{l+1} = r_{l+1} - sum_c p_c on its rows,
//     the 8 partials summed pairwise in rank order, in each chain warp, and
//     sends its slice of y_{l+1} to all 8 blocks.
//   * Forward step l, warps 4-7: the diagonal product one layer behind the
//     chain, rows of u_{l-1} = Uinv_{l-1} y_{l-1} from the whole y_{l-1},
//     8 lanes a row and a butterfly; lane 0 keeps u in x.
//   * Back step l, all 8 warps: x_l = u_l - G_l x_{l+1} on this block's rows
//     from the whole x_{l+1}, 8 lanes a row, and its slice sent to all 8.
//   * The values travel by st.async into the receiver's shared memory, each
//     store completing bytes on the receiver's mbarrier: a step waits only
//     for the bytes it reads, one way, with no cluster-wide barrier and no
//     release fence (whose wait for the stores' acknowledgement alone took
//     ~0.47 us a step on an H100). Three buffers of each kind, and one
//     __syncthreads a step, keep a sender from overwriting a buffer that a
//     slower warp of the receiver still reads: the sender of a buffer's
//     next contents has waited for values this block sent after that
//     __syncthreads.
//
// Deterministic: every sum has a fixed order and nothing is atomic, so two
// calls on one input give the same bits. Capturable: one launch on the
// caller's stream, no allocation, no synchronisation.
//
// The extern "C" entries return cudaGetLastError() after the launch, as an
// int; the Python wrapper (fea_tpu_torch/ops/cuda_thomas.py) raises when it
// is not 0. The wrapper checks the arguments: f32, contiguous, 16-byte
// aligned, b even and at most kMaxB.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace {

constexpr int kCluster = 8;                  // blocks of the cluster, neighbouring SMs
constexpr int kThreads = 256;                // 8 warps; thread t the column pair 2t, 2t + 1 of the partials
constexpr int kMaxB = 256;                   // the widest block
constexpr int kMaxR = kMaxB / kCluster;      // rows a block owns, at most 32 (one warp's lanes)
constexpr int kGroup = 8;                    // lanes a row in the row products (32 rows a block)
constexpr int kChain = 4;                    // warps that carry the forward chain; the rest form u
constexpr int kRingBars = 32;                // mbarriers kept for the two rings
constexpr int kBufs = 3;                     // buffers of each kind of exchanged value
constexpr int kBarBytes = 512;               // the ring's and the exchange's mbarriers
constexpr int kHeader = kBarBytes + 4 * (kBufs * (kCluster * kMaxR + 2 * kMaxB) + kChain * kMaxR);  // before the rings
constexpr int kSmemMax = 232448;             // dynamic shared memory a block may have on sm_90
constexpr unsigned kFull = 0xffffffffu;

static_assert(8 * (kRingBars + 3 * kBufs) <= kBarBytes, "mbarriers overflow their space");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return r;
}

// the address of the same shared-memory offset in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
    uint32_t out;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
    return out;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\tbarrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

// this block's arrival on `bar`'s current phase, which then completes once
// `bytes` more have landed (0: at once)
__device__ __forceinline__ void arm(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
}

// wait for the phase of `bar` with this parity to complete; a wait that
// never ends (a fault in the protocol) says which and traps after ~2^26
// polls rather than holding the card
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    for (uint32_t polls = 0; !done; ++polls) {
        if (polls == (1u << 26)) {
            printf("thomas_kernel: block %d thread %d: the wait on the mbarrier at shared address %u, parity %u, "
                   "never ended\n", blockIdx.x, threadIdx.x, smem_addr(bar), parity);
            __trap();
        }
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(smem_addr(bar)), "r"(parity)
            : "memory");
    }
}

// two floats into another block's shared memory at `addr`, completing 8
// bytes on its mbarrier at `bar` (both shared::cluster addresses)
__device__ __forceinline__ void send2(uint32_t addr, float a, float b, uint32_t bar) {
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];" ::"r"(addr),
                 "r"(__float_as_uint(a)), "r"(__float_as_uint(b)), "r"(bar)
                 : "memory");
}

// `bytes` (a multiple of 16, 0 allowed) from global `src` to shared `dst`,
// completing on `bar`'s current phase
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes, uint64_t* bar) {
    arm(bar, bytes);
    if (bytes == 0) return;
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(bytes), "r"(smem_addr(bar))
                 : "memory");
}

// the sum of a value over the 8 lanes of a row, the same bits in each
__device__ __forceinline__ float row_sum(float v) {
    v += __shfl_xor_sync(kFull, v, 4);
    v += __shfl_xor_sync(kFull, v, 2);
    return v + __shfl_xor_sync(kFull, v, 1);
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    thomas_kernel(const float* __restrict__ uinv, const float* __restrict__ G, const float* __restrict__ r,
                  float* x, int L, int b, int R, int SG, int SU) {
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full_g = reinterpret_cast<uint64_t*>(smem);      // a ring stage's bytes have landed
    uint64_t* full_u = full_g + kRingBars / 2;
    uint64_t* bar_p = full_g + kRingBars;                      // a buffer's values have landed
    uint64_t* bar_y = bar_p + kBufs;
    uint64_t* bar_x = bar_y + kBufs;
    float* P = reinterpret_cast<float*>(smem + kBarBytes);     // [kBufs][kCluster][kMaxR] partials, by sender
    float* Y = P + kBufs * kCluster * kMaxR;                   // [kBufs][kMaxB] the whole y of a layer
    float* X = Y + kBufs * kMaxB;                              // [kBufs][kMaxB] the whole x of a layer
    float* ys = X + kBufs * kMaxB;                             // [kChain][kMaxR] a chain warp's y slice
    float* ring_g = ys + kChain * kMaxR;                       // SG tiles of R x b
    const int tile = R * b;
    float* ring_u = ring_g + SG * tile;                        // SU tiles

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int grp = tid / kGroup, gq = tid % kGroup;           // row grp of the slice, lane gq of its 8
    const uint32_t rank = cluster_rank();
    const int row0 = static_cast<int>(rank) * R;
    const int rows = max(0, min(R, b - row0));                 // even, as R and b are
    const uint32_t tile_bytes = static_cast<uint32_t>(rows) * b * 4;
    const uint32_t p_bytes = static_cast<uint32_t>(rows) * kCluster * 4;
    const uint32_t vec_bytes = static_cast<uint32_t>(b) * 4;
    const size_t bb = static_cast<size_t>(b) * b;
    const int nG = 2 * (L - 1);                                // G tiles read: forward 0..L-2, back L-2..0

    // G tile n of the sequence: layer n forward, then 2 L - 3 - n back
    auto issue_g = [&](int n) {
        const int layer = n < L - 1 ? n : 2 * L - 3 - n;
        bulk_load(ring_g + (n % SG) * tile, G + layer * bb + static_cast<size_t>(row0) * b, tile_bytes,
                  &full_g[n % SG]);
    };
    auto issue_u = [&](int m) {
        bulk_load(ring_u + (m % SU) * tile, uinv + m * bb + static_cast<size_t>(row0) * b, tile_bytes,
                  &full_u[m % SU]);
    };

    if (tid == 0) {
        for (int s = 0; s < SG; ++s) mbar_init(&full_g[s]);
        for (int s = 0; s < SU; ++s) mbar_init(&full_u[s]);
        for (int k = 0; k < 3 * kBufs; ++k) mbar_init(&bar_p[k]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int k = 0; k < kBufs; ++k) {
            arm(&bar_p[k], p_bytes);
            arm(&bar_y[k], vec_bytes);
            arm(&bar_x[k], vec_bytes);
        }
        for (int n = 0; n < min(SG, nG); ++n) issue_g(n);
        for (int m = 0; m < min(SU, L); ++m) issue_u(m);
    }
    // where this thread's values go: its column pair's partials to their
    // owner, its warp's y slice to blocks `warp` and `warp + 4`, its lane's
    // x rows to block `gq`
    const int owner = 2 * tid < b ? 2 * tid / R : 0;
    const uint32_t to_p = map_rank(smem_addr(P), owner) + 4 * (rank * kMaxR + (2 * tid - owner * R));
    const uint32_t to_p_bar = map_rank(smem_addr(bar_p), owner);
    const int half = warp % kChain;
    const uint32_t to_y0 = map_rank(smem_addr(Y), half) + 4 * (row0 + lane);
    const uint32_t to_y0_bar = map_rank(smem_addr(bar_y), half);
    const uint32_t to_y1 = map_rank(smem_addr(Y), half + kChain) + 4 * (row0 + lane);
    const uint32_t to_y1_bar = map_rank(smem_addr(bar_y), half + kChain);
    const uint32_t to_x = map_rank(smem_addr(X), gq) + 4 * (row0 + grp);
    const uint32_t to_x_bar = map_rank(smem_addr(bar_x), gq);

    // the 8-lane dot product of row `row` of `t` (b wide) with `v`: lane gq
    // sums the pairs at j = 2 gq (mod 16) in two chains, in order, then the
    // chains, the pair and the lanes; the same bits in all 8 lanes
    auto row_dot = [&](int row, const float* t, const float* v) {
        float2 a = make_float2(0.f, 0.f), c = make_float2(0.f, 0.f);
        if (row < rows) {
            t += row * b;
            int j = 2 * gq;
#pragma unroll 2
            for (; j + 2 * kGroup < b; j += 4 * kGroup) {
                const float2 t0 = *reinterpret_cast<const float2*>(t + j), v0 = *reinterpret_cast<const float2*>(v + j);
                const float2 t1 = *reinterpret_cast<const float2*>(t + j + 2 * kGroup);
                const float2 v1 = *reinterpret_cast<const float2*>(v + j + 2 * kGroup);
                a.x = fmaf(t0.x, v0.x, a.x);
                a.y = fmaf(t0.y, v0.y, a.y);
                c.x = fmaf(t1.x, v1.x, c.x);
                c.y = fmaf(t1.y, v1.y, c.y);
            }
            if (j < b) {
                const float2 t0 = *reinterpret_cast<const float2*>(t + j), v0 = *reinterpret_cast<const float2*>(v + j);
                a.x = fmaf(t0.x, v0.x, a.x);
                a.y = fmaf(t0.y, v0.y, a.y);
            }
        }
        return row_sum((a.x + a.y) + (c.x + c.y));
    };
    // row `row` of u_m = Uinv_m y_m (y_m whole in Y, waited for); lane 0
    // keeps it in x until the back sweep
    auto u_row = [&](int m, int row) {
        const float u = row_dot(row, ring_u + (m % SU) * tile, Y + (m % kBufs) * kMaxB);
        if (row < rows && gq == 0) x[static_cast<size_t>(m) * b + row0 + row] = u;
        return u;
    };
    auto wait_y = [&](int m, bool arms) {
        wait_phase(&bar_y[m % kBufs], (m / kBufs) & 1);
        if (arms) arm(&bar_y[m % kBufs], vec_bytes);  // for y_{m+3}
    };
    // One thread waits for the ring stages that the next step reads, before
    // the __syncthreads that ends this step; the others read them after it.
    // The forward's step l reads G tile l and U tile l - 1, the junction U
    // tile L - 1, back step l G tile 2 L - 3 - l.
    const int waiter = kThreads - 1;  // a diagonal warp's, off the forward chain
    auto ready_g = [&](int n) {
        if (tid == waiter && n < nG) wait_phase(&full_g[n % SG], (n / SG) & 1);
    };
    auto ready_u = [&](int m) {
        if (tid == waiter && m >= 0 && m < L) wait_phase(&full_u[m % SU], (m / SU) & 1);
    };

    __syncthreads();  // the mbarriers are set before any thread waits on one
    ready_g(0);
    cluster_sync();  // and before any remote store reaches them; G tile 0 has landed

    // ---- forward sweep. Warps 0-3 carry the chain; warps 4-7 form the
    // diagonal product one layer behind it, rows g and g + 16 by their
    // 8-lane group g
    const bool chain = warp < kChain;
    const bool pairs = chain && warp * 64 < b;                 // a warp that holds column pairs
    float rk = chain && lane < rows ? r[row0 + lane] : 0.f;   // r_l and r_{l+1} on lane k's row
    float rn = chain && lane < rows && L > 1 ? r[static_cast<size_t>(b) + row0 + lane] : 0.f;
    for (int l = 0; l < L; ++l) {
        if (chain) {
            float yk = 0.f;  // lane k: y_l[row0 + k]
            if (l > 0) {
                wait_phase(&bar_p[l % kBufs], ((l - 1) / kBufs) & 1);  // the partials of y_l
                if (tid == 0) arm(&bar_p[l % kBufs], p_bytes);        // for y_{l+3}
            }
            if (lane < rows) {
                float s = 0.f;
                if (l > 0) {
                    const float* p = P + (l % kBufs) * kCluster * kMaxR + lane;  // by sender, summed pairwise
                    s = ((p[0] + p[kMaxR]) + (p[2 * kMaxR] + p[3 * kMaxR])) +
                        ((p[4 * kMaxR] + p[5 * kMaxR]) + (p[6 * kMaxR] + p[7 * kMaxR]));
                }
                yk = rk - s;
            }
            {
                const float y1 = __shfl_down_sync(kFull, yk, 1);
                const int k = l % kBufs;
                if (lane < rows && !(lane & 1)) {
                    send2(to_y0 + 4 * k * kMaxB, yk, y1, to_y0_bar + 8 * k);
                    send2(to_y1 + 4 * k * kMaxB, yk, y1, to_y1_bar + 8 * k);
                }
            }
            rk = rn;
            if (lane < rows && l + 2 < L) rn = r[static_cast<size_t>(l + 2) * b + row0 + lane];
            if (pairs && l + 1 < L) {  // columns 2 tid, 2 tid + 1 of G_l^T y_l over this block's rows
                float* yw = ys + warp * kMaxR;
                if (lane < rows) yw[lane] = yk;
                __syncwarp();
                const bool mine = 2 * tid < b;
                const float* t = ring_g + (l % SG) * tile + (mine ? 2 * tid : 0);
                float2 a[4] = {};  // the two columns' sums over rows j = 0, 1, 2, 3 (mod 4), in order
                int j = 0;
#pragma unroll 4
                for (; j + 4 <= rows; j += 4) {
                    const float4 y = *reinterpret_cast<const float4*>(yw + j);
                    const float2 g0 = *reinterpret_cast<const float2*>(t + j * b);
                    const float2 g1 = *reinterpret_cast<const float2*>(t + (j + 1) * b);
                    const float2 g2 = *reinterpret_cast<const float2*>(t + (j + 2) * b);
                    const float2 g3 = *reinterpret_cast<const float2*>(t + (j + 3) * b);
                    a[0].x = fmaf(g0.x, y.x, a[0].x);
                    a[0].y = fmaf(g0.y, y.x, a[0].y);
                    a[1].x = fmaf(g1.x, y.y, a[1].x);
                    a[1].y = fmaf(g1.y, y.y, a[1].y);
                    a[2].x = fmaf(g2.x, y.z, a[2].x);
                    a[2].y = fmaf(g2.y, y.z, a[2].y);
                    a[3].x = fmaf(g3.x, y.w, a[3].x);
                    a[3].y = fmaf(g3.y, y.w, a[3].y);
                }
                if (j < rows) {  // rows is even: two more
                    const float2 g0 = *reinterpret_cast<const float2*>(t + j * b);
                    const float2 g1 = *reinterpret_cast<const float2*>(t + (j + 1) * b);
                    a[0].x = fmaf(g0.x, yw[j], a[0].x);
                    a[0].y = fmaf(g0.y, yw[j], a[0].y);
                    a[1].x = fmaf(g1.x, yw[j + 1], a[1].x);
                    a[1].y = fmaf(g1.y, yw[j + 1], a[1].y);
                }
                const float a0 = (a[0].x + a[1].x) + (a[2].x + a[3].x);
                const float a1 = (a[0].y + a[1].y) + (a[2].y + a[3].y);
                const int k = (l + 1) % kBufs;
                if (mine) send2(to_p + 4 * k * kCluster * kMaxR, a0, a1, to_p_bar + 8 * k);
            }
        } else if (l > 0) {
            wait_y(l - 1, tid == kChain * 32);
            const int g = grp - kChain * 4;
            u_row(l - 1, g);
            u_row(l - 1, g + 16);
        }
        if (l + 1 < L - 1) ready_g(l + 1);
        else if (l + 1 == L - 1 || l == L - 1) ready_g(L - 1);  // the back sweep's first
        ready_u(l);
        __syncthreads();  // every thread is done with the stages and buffers it read this step
        if (tid == 0) {
            if (l < L - 1 && l + SG < nG) issue_g(l + SG);
            if (l > 0 && l - 1 + SU < L) issue_u(l - 1 + SU);
        }
    }

    // ---- back sweep: x_{L-1} = u_{L-1}, then x_l = u_l - G_l x_{l+1}
    {
        wait_y(L - 1, tid == 0);
        const float xl = u_row(L - 1, grp);
        const float x1 = __shfl_down_sync(kFull, xl, kGroup);  // row grp + 1
        const int k = (L - 1) % kBufs;
        if (L > 1 && grp < rows && !(grp & 1)) send2(to_x + 4 * k * kMaxB, xl, x1, to_x_bar + 8 * k);
    }
    float uv = 0.f, un = 0.f;  // u_l and u_{l-1} of row grp, kept in x by the forward sweep
    if (L > 1 && grp < rows) uv = x[static_cast<size_t>(L - 2) * b + row0 + grp];
    if (L > 2 && grp < rows) un = x[static_cast<size_t>(L - 3) * b + row0 + grp];
    __syncthreads();
    for (int l = L - 2; l >= 0; --l) {
        const int n = 2 * L - 3 - l;  // this step's G tile: layer l
        const int kn = (l + 1) % kBufs;
        wait_phase(&bar_x[kn], ((L - 2 - l) / kBufs) & 1);  // x_{l+1}
        if (tid == 0) arm(&bar_x[kn], vec_bytes);            // for x_{l-2}
        const float xl = uv - row_dot(grp, ring_g + (n % SG) * tile, X + kn * kMaxB);
        if (l > 0) {
            const float x1 = __shfl_down_sync(kFull, xl, kGroup);
            const int k = l % kBufs;
            if (grp < rows && !(grp & 1)) send2(to_x + 4 * k * kMaxB, xl, x1, to_x_bar + 8 * k);
        }
        if (grp < rows && gq == 0) x[static_cast<size_t>(l) * b + row0 + grp] = xl;
        uv = un;
        if (l > 1 && grp < rows) un = x[static_cast<size_t>(l - 2) * b + row0 + grp];
        if (l > 0) ready_g(n + 1);
        __syncthreads();
        if (tid == 0 && n + SG < nG) issue_g(n + SG);
    }
    cluster_sync();  // no block leaves while a value it awaits is still on its way
}

// The exchange of one layer step without its arithmetic: each block sends 8
// bytes to each of the 8 (itself included) by st.async and waits for the 64
// it receives, `steps` times, through three buffers as the solve does. Its
// time a step is the solve's floor.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    exchange_probe(int steps, float* out) {
    __shared__ __align__(8) float buf[kBufs][kCluster][2];
    __shared__ uint64_t bar[kBufs];
    const int tid = threadIdx.x;
    const uint32_t rank = cluster_rank();
    if (tid == 0) {
        for (int k = 0; k < kBufs; ++k) mbar_init(&bar[k]);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        for (int k = 0; k < kBufs; ++k) arm(&bar[k], 8 * kCluster);
    }
    const uint32_t to = map_rank(smem_addr(&buf[0][rank][0]), tid % kCluster);
    const uint32_t to_bar = map_rank(smem_addr(&bar[0]), tid % kCluster);
    float v = static_cast<float>(rank);
    cluster_sync();
    for (int s = 0; s < steps; ++s) {
        const int k = s % kBufs;
        if (tid < kCluster) send2(to + 4 * k * kCluster * 2, v, v, to_bar + 8 * k);
        wait_phase(&bar[k], (s / kBufs) & 1);
        if (tid == 0) arm(&bar[k], 8 * kCluster);
        float sum = 0.f;
        for (int c = 0; c < kCluster; ++c) sum += buf[k][c][0];
        v = sum * 0.125f;
        __syncthreads();
    }
    cluster_sync();
    if (rank == 0 && tid == 0) out[0] = v;
}

// rows a block owns and the stages of the two rings, for a block width b
void plan(int b, int* R, int* SG, int* SU, int* smem) {
    int rows = (b + kCluster - 1) / kCluster;
    rows += rows & 1;
    const int tile_bytes = rows * b * 4;
    int n = (kSmemMax - kHeader) / tile_bytes;
    n = n < kRingBars ? n : kRingBars;
    *R = rows;
    *SG = (n + 1) / 2;
    *SU = n - *SG;
    *smem = kHeader + n * tile_bytes;
}

}  // namespace

extern "C" int fea_thomas_solve_f32(const float* uinv, const float* G, const float* r, float* x, int64_t L,
                                    int64_t b, void* stream) {
    int R, SG, SU, smem;
    plan(static_cast<int>(b), &R, &SG, &SU, &smem);
    static int configured = 0;  // the dynamic shared memory allowed so far
    if (smem > configured) {
        const cudaError_t err = cudaFuncSetAttribute(thomas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        configured = smem;
    }
    thomas_kernel<<<kCluster, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        uinv, G, r, x, static_cast<int>(L), static_cast<int>(b), R, SG, SU);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int fea_thomas_exchange_probe(int64_t steps, float* out, void* stream) {
    exchange_probe<<<kCluster, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int>(steps), out);
    return static_cast<int>(cudaGetLastError());
}
