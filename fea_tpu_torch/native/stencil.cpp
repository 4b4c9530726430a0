// Host-side exact-IEEE-f64 stencil applies and masked residuals.
//
// A copy of fea_tpu/native/stencil.cpp, the reference's host check, for
// fea_tpu_torch/native: the C++ twin of
// fea_tpu_torch/ops/structured.py::stencil_apply_np, node-centric (one
// pass over the grid, 27 neighbour offsets x 3x3 weight blocks chosen by
// the node's boundary region, no temporaries), plus the
// variable-weight (curvilinear) apply and the fused residuals. It never
// runs on the card: it checks the card's results on the host.
//
// Weight-table layout (built on the Python side,
// fea_tpu_torch/ops/cuda_stencil.py::region_weight_table):
//   W[(rz*3+ry)*3+rx][(dz+1)*3+(dy+1))*3+(dx+1)][3][3]
// where r* classify the node per axis (0 = min face, 1 = interior,
// 2 = max face) and d* in {-1,0,1} are node-neighbour offsets.  A
// (region, offset) pair whose supporting element does not exist holds a
// zero block, and the bounds checks below skip exactly those
// (zero-weight) out-of-range reads, so the result equals the assembled
// K @ u in f64.

#include <cstdint>

namespace {
inline int region(int64_t i, int64_t n) {
    return i == 0 ? 0 : (i == n - 1 ? 2 : 1);
}
}  // namespace

extern "C" void fea_stencil_apply_f64(
    const double* __restrict__ W,   // (27, 27, 3, 3) region-major
    const double* __restrict__ g,   // (Z, Y, X, 3) node displacements
    double* __restrict__ out,       // (Z, Y, X, 3) K @ u
    int64_t X, int64_t Y, int64_t Z) {
    for (int64_t z = 0; z < Z; ++z) {
        const int rz = region(z, Z);
        for (int64_t y = 0; y < Y; ++y) {
            const int ry = region(y, Y);
            const int64_t row = (z * Y + y) * X;
            double* __restrict__ orow = out + row * 3;
            for (int64_t x = 0; x < X; ++x) {
                const int rx = region(x, X);
                const double* __restrict__ Wr =
                    W + static_cast<int64_t>(((rz * 3 + ry) * 3 + rx)) * 27 * 9;
                double a0 = 0.0, a1 = 0.0, a2 = 0.0;
                for (int dz = -1; dz <= 1; ++dz) {
                    const int64_t zz = z + dz;
                    if (zz < 0 || zz >= Z) continue;
                    for (int dy = -1; dy <= 1; ++dy) {
                        const int64_t yy = y + dy;
                        if (yy < 0 || yy >= Y) continue;
                        const int64_t nrow = (zz * Y + yy) * X;
                        for (int dx = -1; dx <= 1; ++dx) {
                            const int64_t xx = x + dx;
                            if (xx < 0 || xx >= X) continue;
                            const double* __restrict__ w =
                                Wr + (((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)) * 9;
                            const double* __restrict__ u = g + (nrow + xx) * 3;
                            a0 += w[0] * u[0] + w[1] * u[1] + w[2] * u[2];
                            a1 += w[3] * u[0] + w[4] * u[1] + w[5] * u[2];
                            a2 += w[6] * u[0] + w[7] * u[1] + w[8] * u[2];
                        }
                    }
                }
                orow[x * 3 + 0] = a0;
                orow[x * 3 + 1] = a1;
                orow[x * 3 + 2] = a2;
            }
        }
    }
}

// Fused masked-residual companion: r = free * (b - K@u) written in the
// same pass, plus the squared norm of r — saves two further full-grid
// NumPy passes per certification round at >1M DOF.
extern "C" double fea_stencil_residual_f64(
    const double* __restrict__ W,
    const double* __restrict__ g,     // iterate u, (Z, Y, X, 3)
    const double* __restrict__ b,     // rhs/loads, (Z, Y, X, 3)
    const double* __restrict__ freem, // free-DOF mask, (Z, Y, X, 3)
    double* __restrict__ r,           // out: masked residual
    double* __restrict__ au,          // out: raw K @ u (reaction recovery)
    int64_t X, int64_t Y, int64_t Z) {
    double nrm2 = 0.0;
    for (int64_t z = 0; z < Z; ++z) {
        const int rz = region(z, Z);
        for (int64_t y = 0; y < Y; ++y) {
            const int ry = region(y, Y);
            const int64_t row = (z * Y + y) * X;
            for (int64_t x = 0; x < X; ++x) {
                const int rx = region(x, X);
                const double* __restrict__ Wr =
                    W + static_cast<int64_t>(((rz * 3 + ry) * 3 + rx)) * 27 * 9;
                double a0 = 0.0, a1 = 0.0, a2 = 0.0;
                for (int dz = -1; dz <= 1; ++dz) {
                    const int64_t zz = z + dz;
                    if (zz < 0 || zz >= Z) continue;
                    for (int dy = -1; dy <= 1; ++dy) {
                        const int64_t yy = y + dy;
                        if (yy < 0 || yy >= Y) continue;
                        const int64_t nrow = (zz * Y + yy) * X;
                        for (int dx = -1; dx <= 1; ++dx) {
                            const int64_t xx = x + dx;
                            if (xx < 0 || xx >= X) continue;
                            const double* __restrict__ w =
                                Wr + (((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)) * 9;
                            const double* __restrict__ u = g + (nrow + xx) * 3;
                            a0 += w[0] * u[0] + w[1] * u[1] + w[2] * u[2];
                            a1 += w[3] * u[0] + w[4] * u[1] + w[5] * u[2];
                            a2 += w[6] * u[0] + w[7] * u[1] + w[8] * u[2];
                        }
                    }
                }
                const int64_t i = (row + x) * 3;
                au[i + 0] = a0;
                au[i + 1] = a1;
                au[i + 2] = a2;
                const double r0 = freem[i + 0] * (b[i + 0] - a0);
                const double r1 = freem[i + 1] * (b[i + 1] - a1);
                const double r2 = freem[i + 2] * (b[i + 2] - a2);
                r[i + 0] = r0;
                r[i + 1] = r1;
                r[i + 2] = r2;
                nrm2 += r0 * r0 + r1 * r1 + r2 * r2;
            }
        }
    }
    return nrm2;
}

// ---------------------------------------------------------------------------
// Variable-weight (curvilinear) twins: per-NODE 27-offset 3x3 blocks
// instead of the 27-region table: the assembled weight field of
// fea_tpu_torch/ops/curvilinear.py (grid connectivity, arbitrary node
// positions).  Layout is node-major (Z, Y, X, 27, 3, 3): each node's
// 27x9 block row is contiguous (one ~1.9 KB stream per node), packed
// once per operator by fea_tpu_torch/native/__init__.py::pack_var_weights.
// Out-of-range neighbours carry exactly-zero blocks by assembly, so the
// bounds skips below drop only zero contributions and the result is
// the exact IEEE-f64 assembled K @ u.

extern "C" void fea_varstencil_apply_f64(
    const double* __restrict__ Wn,  // (Z*Y*X, 27, 3, 3) node-major
    const double* __restrict__ g,   // (Z, Y, X, 3)
    double* __restrict__ out,       // (Z, Y, X, 3)
    int64_t X, int64_t Y, int64_t Z) {
    for (int64_t z = 0; z < Z; ++z) {
        for (int64_t y = 0; y < Y; ++y) {
            const int64_t row = (z * Y + y) * X;
            for (int64_t x = 0; x < X; ++x) {
                const double* __restrict__ Wr = Wn + (row + x) * 27 * 9;
                double a0 = 0.0, a1 = 0.0, a2 = 0.0;
                for (int dz = -1; dz <= 1; ++dz) {
                    const int64_t zz = z + dz;
                    if (zz < 0 || zz >= Z) continue;
                    for (int dy = -1; dy <= 1; ++dy) {
                        const int64_t yy = y + dy;
                        if (yy < 0 || yy >= Y) continue;
                        const int64_t nrow = (zz * Y + yy) * X;
                        for (int dx = -1; dx <= 1; ++dx) {
                            const int64_t xx = x + dx;
                            if (xx < 0 || xx >= X) continue;
                            const double* __restrict__ w =
                                Wr + (((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)) * 9;
                            const double* __restrict__ u = g + (nrow + xx) * 3;
                            a0 += w[0] * u[0] + w[1] * u[1] + w[2] * u[2];
                            a1 += w[3] * u[0] + w[4] * u[1] + w[5] * u[2];
                            a2 += w[6] * u[0] + w[7] * u[1] + w[8] * u[2];
                        }
                    }
                }
                double* __restrict__ o = out + (row + x) * 3;
                o[0] = a0;
                o[1] = a1;
                o[2] = a2;
            }
        }
    }
}

extern "C" double fea_varstencil_residual_f64(
    const double* __restrict__ Wn,
    const double* __restrict__ g,     // iterate u, (Z, Y, X, 3)
    const double* __restrict__ b,     // rhs/loads
    const double* __restrict__ freem, // free-DOF mask
    double* __restrict__ r,
    double* __restrict__ au,
    int64_t X, int64_t Y, int64_t Z) {
    double nrm2 = 0.0;
    for (int64_t z = 0; z < Z; ++z) {
        for (int64_t y = 0; y < Y; ++y) {
            const int64_t row = (z * Y + y) * X;
            for (int64_t x = 0; x < X; ++x) {
                const double* __restrict__ Wr = Wn + (row + x) * 27 * 9;
                double a0 = 0.0, a1 = 0.0, a2 = 0.0;
                for (int dz = -1; dz <= 1; ++dz) {
                    const int64_t zz = z + dz;
                    if (zz < 0 || zz >= Z) continue;
                    for (int dy = -1; dy <= 1; ++dy) {
                        const int64_t yy = y + dy;
                        if (yy < 0 || yy >= Y) continue;
                        const int64_t nrow = (zz * Y + yy) * X;
                        for (int dx = -1; dx <= 1; ++dx) {
                            const int64_t xx = x + dx;
                            if (xx < 0 || xx >= X) continue;
                            const double* __restrict__ w =
                                Wr + (((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)) * 9;
                            const double* __restrict__ u = g + (nrow + xx) * 3;
                            a0 += w[0] * u[0] + w[1] * u[1] + w[2] * u[2];
                            a1 += w[3] * u[0] + w[4] * u[1] + w[5] * u[2];
                            a2 += w[6] * u[0] + w[7] * u[1] + w[8] * u[2];
                        }
                    }
                }
                const int64_t i = (row + x) * 3;
                au[i + 0] = a0;
                au[i + 1] = a1;
                au[i + 2] = a2;
                const double r0 = freem[i + 0] * (b[i + 0] - a0);
                const double r1 = freem[i + 1] * (b[i + 1] - a1);
                const double r2 = freem[i + 2] * (b[i + 2] - a2);
                r[i + 0] = r0;
                r[i + 1] = r1;
                r[i + 2] = r2;
                nrm2 += r0 * r0 + r1 * r1 + r2 * r2;
            }
        }
    }
    return nrm2;
}

// ---------------------------------------------------------------------------
// Z-slab windowed residual (round-4 capacity-tier streaming): computes
// rows [z0, z0+nz_loc) of the masked residual/raw apply against a g
// buffer that spans [g0, g0+gz) with g0 = max(z0-1, 0) — the caller
// streams the iterate host-ward in overlapping z-chunks and runs this
// on chunk i while chunk i+1 is still in flight on the transfer
// engine, hiding the ~GB/s-limited device->host pull behind compute.
// b/free/r/au buffers cover exactly the [z0, z0+nz_loc) rows.
// Returns the slab's squared residual norm (caller accumulates).

extern "C" double fea_stencil_residual_slab_f64(
    const double* __restrict__ W,     // (27, 27, 3, 3) region-major
    const double* __restrict__ g,     // (gz, Y, X, 3), rows [g0, g0+gz)
    const double* __restrict__ b,     // (nz_loc, Y, X, 3), rows [z0, ...)
    const double* __restrict__ freem, // same shape as b
    double* __restrict__ r,           // out, same shape as b
    double* __restrict__ au,          // out, same shape as b
    int64_t X, int64_t Y, int64_t Z,
    int64_t z0, int64_t nz_loc, int64_t g0) {
    double nrm2 = 0.0;
    for (int64_t zl = 0; zl < nz_loc; ++zl) {
        const int64_t z = z0 + zl;
        const int rz = region(z, Z);
        for (int64_t y = 0; y < Y; ++y) {
            const int ry = region(y, Y);
            for (int64_t x = 0; x < X; ++x) {
                const int rx = region(x, X);
                const double* __restrict__ Wr =
                    W + static_cast<int64_t>(((rz * 3 + ry) * 3 + rx)) * 27 * 9;
                double a0 = 0.0, a1 = 0.0, a2 = 0.0;
                for (int dz = -1; dz <= 1; ++dz) {
                    const int64_t zz = z + dz;
                    if (zz < 0 || zz >= Z) continue;
                    for (int dy = -1; dy <= 1; ++dy) {
                        const int64_t yy = y + dy;
                        if (yy < 0 || yy >= Y) continue;
                        const int64_t nrow = ((zz - g0) * Y + yy) * X;
                        for (int dx = -1; dx <= 1; ++dx) {
                            const int64_t xx = x + dx;
                            if (xx < 0 || xx >= X) continue;
                            const double* __restrict__ w =
                                Wr + (((dz + 1) * 3 + (dy + 1)) * 3 + (dx + 1)) * 9;
                            const double* __restrict__ u = g + (nrow + xx) * 3;
                            a0 += w[0] * u[0] + w[1] * u[1] + w[2] * u[2];
                            a1 += w[3] * u[0] + w[4] * u[1] + w[5] * u[2];
                            a2 += w[6] * u[0] + w[7] * u[1] + w[8] * u[2];
                        }
                    }
                }
                const int64_t i = ((zl * Y + y) * X + x) * 3;
                au[i + 0] = a0;
                au[i + 1] = a1;
                au[i + 2] = a2;
                const double r0 = freem[i + 0] * (b[i + 0] - a0);
                const double r1 = freem[i + 1] * (b[i + 1] - a1);
                const double r2 = freem[i + 2] * (b[i + 2] - a2);
                r[i + 0] = r0;
                r[i + 1] = r1;
                r[i + 2] = r2;
                nrm2 += r0 * r0 + r1 * r1 + r2 * r2;
            }
        }
    }
    return nrm2;
}
