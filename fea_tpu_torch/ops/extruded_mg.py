"""z-semicoarsened multigrid for extruded meshes, and its section-RBM
coarse space.

An extruded mesh is structured only along z, so this preconditioner
coarsens ONLY z (the 1D [1/2, 1, 1/2] transfers of ``ops/multigrid.py``
along the layer axis) and compensates with a LINE smoother: per-layer
section-block Jacobi (every layer's full 3 n2 x 3 n2 block inverted),
accelerated by Chebyshev. The coarsest level is solved exactly by a
block-tridiagonal (Thomas) factorization: the extruded stiffness couples
only adjacent layers. What z-coarsening cannot see, error smooth along
the section but arbitrary in z (the shell-bending modes of a thin tube),
goes to :class:`SectionCoarse`: rigid-body modes a (node layer x section
aggregate), whose Galerkin matrix is block-tridiagonal too and is solved
exactly by the same Thomas sweeps, composed multiplicatively with the
V-cycle (:class:`ComposedExtrudedPrecond`).

**One build, in torch, on the scene's device.** The host integrates one
f64 Ke a section quad a level (O(Q2)); the section blocks (a one-hot
product, no scatter-add), the layer-block inverses (``torch.linalg.inv_ex``
in f64), the Chebyshev bound, the Galerkin projections and both Thomas
chains run in f64 on the device, and what the V-cycle applies is stored
in f32:

  * **Certified lambda_max.** The Chebyshev window must bound
    rho(M^-1 A) for the inverses that are STORED and applied, which are
    f32: ``||X D_m - I||_inf`` and the coupling row sums are computed from
    the f32 X cast up to f64 (an uncertified window diverged the
    reference's 1M-DOF voxel solve).
  * **Thomas chains in f64.** U = D - O^T G is built in f64 and the
    factors stored in f32: an all-f32 chain gave 30% error in G on a
    slender tube and the V-cycle diverged.

Applies: the block-Jacobi is one GEMM of the (L, 3 n2) residual by the
interior inverse, the few special layers (first, last, constrained)
overwritten from their own inverses by an index made once at build time.
A Thomas solve takes one of two executions of the same sweeps, by what it
can observe (:func:`_thomas_solve`): on the card, f32 factors of an even
block width of at most 256 (the section coarse space's 6 x aggregates) go
to one hand-written kernel (``ops/cuda_thomas.py``, ``csrc/thomas.cu``: a
cluster of 8 thread blocks walks the layers); everything else (the CPU,
the z-coarsest level's wide blocks) takes the plain version,
:func:`_thomas_addmv`, 2 (L - 1) dependent matrix-vector products
(``addmv_`` in place, one launch each) around one batched product.
``LAUNCHES["thomas"]`` counts every launch of either, ``LAUNCHES
["thomas_kernel"]`` the kernel's alone (zeroed and read like the kernels'
``LAUNCHES``; ``solve/staged.py`` credits a captured step's count to each
of its replays). The reference has no Pallas kernel on this route.
Counterpart of
``fea_tpu/ops/extruded_mg.py`` without its TPU-only parts: the
choice between a host and a device build, and the Newton-refined f32
inverse standing in for the f64 factorization a TPU lacks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..utils.profiling import span
from . import cuda_thomas
from .extruded import ExtrudedOperator, _make, integrate_section_kes
from .multigrid import _prolong, _restrict
from .twolevel import _rbm_blocks, rigid_body_geometry

__all__ = [
    "LAUNCHES",
    "ComposedExtrudedPrecond",
    "ExtrudedMultigrid",
    "SectionCoarse",
    "build_extruded_multigrid",
    "build_section_coarse",
]

_F64 = torch.float64
_F32 = torch.float32  # what the V-cycle stores and applies
_MARGIN = 1.001  # the reference's inflation of every row sum of the bound

# the Thomas sweeps' launches: "thomas" each ``addmv_`` and each kernel
# launch, "thomas_kernel" the kernel's alone (both keys exist before any
# capture, which credits only the keys it finds)
LAUNCHES = {"thomas": 0, "thomas_kernel": 0}


def _thomas_solve(uinv: torch.Tensor, G: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """Block-tridiagonal solve from Thomas factors, rf (L, b) in the
    factors' dtype: forward y_l = r_l - G_{l-1}^T y_{l-1}, diagonal
    u = Uinv y, back x_l = u_l - G_l x_{l+1} (U symmetric, so
    O^T Uinv = G^T). Shared by the z-coarsest exact solve and the
    section-RBM coarse correction: one kernel launch where
    ``cuda_thomas.takes`` the factors, the ``addmv_`` chain elsewhere."""
    if cuda_thomas.takes(uinv, G, rf):
        x = cuda_thomas.thomas_solve(uinv, G, rf.contiguous())
        LAUNCHES["thomas"] += 1
        LAUNCHES["thomas_kernel"] += 1
        return x
    return _thomas_addmv(uinv, G, rf)


def _thomas_addmv(uinv: torch.Tensor, G: torch.Tensor, rf: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`_thomas_solve`: 2 (L - 1) dependent
    ``addmv_`` launches around one batched product."""
    L = rf.shape[0]
    y = rf.clone()
    for l in range(1, L):  # in place: one matrix-vector launch a layer, no copy
        y[l].addmv_(G[l - 1].T, y[l - 1], alpha=-1.0)
        LAUNCHES["thomas"] += 1
    x = torch.bmm(uinv, y.unsqueeze(-1)).squeeze(-1)
    for l in range(L - 2, -1, -1):
        x[l].addmv_(G[l], x[l + 1], alpha=-1.0)
        LAUNCHES["thomas"] += 1
    return x


@dataclasses.dataclass(frozen=True)
class _ELevel:
    """One z-level of the extruded hierarchy."""

    op: ExtrudedOperator  # level operator (f32 payloads)
    minv_interior: torch.Tensor  # (b, b) inverse of the interior (all-free) layer block
    special_idx: tuple  # layers with their own inverse
    special: torch.Tensor  # the same, an int64 index on the device, made once
    minv_special: torch.Tensor  # (n_special, b, b)
    lam_max: float  # certified upper bound on rho(M^-1 A) for the stored inverses

    def apply(self, g: torch.Tensor) -> torch.Tensor:
        """Masked operator on (L, n2, 3) level fields."""
        return self.op.apply(g.reshape(-1, 3)).reshape(g.shape)

    def block_jacobi(self, r: torch.Tensor) -> torch.Tensor:
        """z = blockdiag(M)^-1 r on (L, n2, 3): one GEMM with the interior
        inverse for every layer, then the special layers overwritten with
        their own inverses."""
        L, n2, _ = r.shape
        rf = r.reshape(L, 3 * n2)
        z = rf @ self.minv_interior.to(r.dtype).T
        if self.special_idx:
            zs = torch.bmm(self.minv_special.to(r.dtype), rf[self.special].unsqueeze(-1)).squeeze(-1)
            z.index_copy_(0, self.special, zs)
        return z.reshape(L, n2, 3)


@dataclasses.dataclass(frozen=True)
class ExtrudedMultigrid:
    """V-cycle preconditioner z = M^-1 r for the masked extruded operator,
    callable on flat (N, 3) residuals: Chebyshev line smoothing on each
    level, the exact block-Thomas solve at the coarsest."""

    levels: tuple[_ELevel, ...]
    thomas_uinv: torch.Tensor  # (Lc, b, b) built f64, stored f32
    thomas_g: torch.Tensor  # (Lc - 1, b, b) G_l = U_l^-1 O_l
    coarse_free: torch.Tensor  # (Lc, n2, 3) free mask of the Thomas level
    degree: int = 2
    lam_min_frac: float = 1.0 / 6.0

    @classmethod
    def from_numpy(cls, levels: list[dict], thomas_uinv: np.ndarray, thomas_g: np.ndarray,
                   coarse_free: np.ndarray, *, degree: int, device) -> "ExtrudedMultigrid":
        """The hierarchy of host arrays (for example ``fea_tpu``'s, pulled to
        the host): each level a dict of its operator's ``kes``, ``quads``,
        ``free`` and ``n_layers`` and its ``minv_interior``,
        ``special_idx``, ``minv_special`` and ``lam_max``; the Thomas
        factors in their dtype, on ``device``."""
        device = torch.device(device)
        t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
        built = []
        for lv in levels:
            op = ExtrudedOperator.from_numpy(lv["kes"], lv["quads"], lv["free"], n_layers=lv["n_layers"],
                                             device=device)
            special = tuple(int(s) for s in lv["special_idx"])
            built.append(_ELevel(op=op, minv_interior=t(lv["minv_interior"]), special_idx=special,
                                 special=torch.as_tensor(special, dtype=torch.int64, device=device),
                                 minv_special=t(lv["minv_special"]), lam_max=float(lv["lam_max"])))
        uinv = t(thomas_uinv)
        return cls(levels=tuple(built), thomas_uinv=uinv, thomas_g=t(thomas_g),
                   coarse_free=t(coarse_free).to(uinv.dtype), degree=degree)

    @property
    def free(self) -> torch.Tensor:
        """(N, 3) free mask of the finest level."""
        return self.levels[0].op.free if self.levels else self.coarse_free.reshape(-1, 3)

    def _smooth(self, level: _ELevel, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """Chebyshev on the block-Jacobi-preconditioned operator (the
        d-vector recurrence of ``ops.multigrid.chebyshev_smooth``, the
        pointwise inverse diagonal replaced by the per-layer block solve)."""
        lam_max = level.lam_max
        lam_min = lam_max * self.lam_min_frac
        theta = 0.5 * (lam_max + lam_min)
        delta = 0.5 * (lam_max - lam_min)
        sigma = theta / delta
        rho = 1.0 / sigma
        d = level.block_jacobi(r - level.apply(x)) / theta
        x = x + d
        for _ in range(self.degree - 1):
            z = level.block_jacobi(r - level.apply(x))
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            x = x + d
            rho = rho_new
        return x

    def _coarse_solve(self, r: torch.Tensor) -> torch.Tensor:
        """Exact block-tridiagonal solve on (Lc, n2, 3) by the Thomas factors."""
        Lc = r.shape[0]
        x = _thomas_solve(self.thomas_uinv, self.thomas_g, r.reshape(Lc, -1).to(self.thomas_uinv.dtype))
        return x.reshape(r.shape).to(r.dtype)

    def _vcycle(self, idx: int, r: torch.Tensor) -> torch.Tensor:
        if idx == len(self.levels):
            return self._coarse_solve(r)
        level = self.levels[idx]
        z = self._smooth(level, torch.zeros_like(r), r)
        rc = _restrict(r - level.apply(z), axes=(0,))
        if idx + 1 < len(self.levels):
            Fc = self.levels[idx + 1].op.free.to(rc.dtype).reshape(rc.shape)
        else:
            Fc = self.coarse_free.to(rc.dtype)
        zc = self._vcycle(idx + 1, Fc * rc)
        Ff = level.op.free.to(r.dtype).reshape(r.shape)
        z = z + Ff * _prolong(Fc * zc, axes=(0,))
        return self._smooth(level, z, r)

    def __call__(self, r_flat: torch.Tensor) -> torch.Tensor:
        if self.levels:
            lv0 = self.levels[0].op
            shape = (lv0.n_layers, lv0.n2, 3)
        else:  # the mesh is already at Thomas size: M is the exact solve
            shape = tuple(self.coarse_free.shape)
        return self._vcycle(0, r_flat.reshape(shape)).reshape(r_flat.shape)


def _corner_onehot(quads: np.ndarray, n2: int, device) -> torch.Tensor:
    """(Q2, 12, 3 n2) f64 one-hot map of each quad's 12 corner DOFs to
    section DOFs: a section block is the product E^T blockdiag(Ke) E,
    summed by GEMM in a fixed order instead of scattered."""
    Q = quads.shape[0]
    loc = np.arange(12)
    grow = 3 * quads[:, loc // 3] + (loc % 3)  # (Q, 12) section DOF of each corner DOF
    E = torch.zeros((Q, 12, 3 * n2), dtype=_F64, device=device)
    E.scatter_(2, torch.as_tensor(grow, device=device)[:, :, None], 1.0)
    return E


def _section_blocks(kes: np.ndarray, E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three distinct (3 n2, 3 n2) section blocks of an extruded
    operator, f64 on E's device: S_bb (a layer's coupling through the
    element layer above it), S_tt (through the one below), O (layer l to
    l + 1)."""
    k = torch.as_tensor(kes, device=E.device)
    Ef = E.reshape(-1, E.shape[-1])

    def block(rows: slice, cols: slice) -> torch.Tensor:
        return Ef.T @ torch.bmm(k[:, rows, cols], E).reshape(Ef.shape)

    return block(slice(0, 12), slice(0, 12)), block(slice(12, 24), slice(12, 24)), block(slice(0, 12), slice(12, 24))


def _mask_block(D: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Masked diagonal block F D F + (1 - F) for a layer's DOF mask f."""
    return D * f[:, None] * f[None, :] + torch.diag(1.0 - f)


def _inverse(D: torch.Tensor, infos: list) -> torch.Tensor:
    """f64 inverse without a host sync; its info is checked once, in
    :func:`_check_inverses`."""
    X, info = torch.linalg.inv_ex(D)
    infos.append(info)
    return X


def _check_inverses(infos: list, what: str) -> None:
    if infos and bool(torch.stack([i.reshape(()) for i in infos]).ne(0).any()):
        raise ValueError(f"extruded multigrid: a singular block in {what}")


def _thomas_chain(D: Callable[[int], torch.Tensor], O: Callable[[int], torch.Tensor], L: int,
                  what: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Block-Thomas factors of the block-tridiagonal matrix with diagonal
    blocks D(l) and couplings O(l) (layer l to l + 1), the chain
    G_l = U_l^-1 O_l, U_{l+1} = D_{l+1} - O_l^T G_l built in f64 and the
    factors stored in f32."""
    infos: list = []
    prev = _inverse(D(0), infos)
    b = prev.shape[0]
    uinv = torch.empty((L, b, b), dtype=_F32, device=prev.device)
    G = torch.empty((L - 1, b, b), dtype=_F32, device=prev.device)
    uinv[0] = prev
    for l in range(1, L):
        O_prev = O(l - 1)
        G_prev = prev @ O_prev
        G[l - 1] = G_prev
        prev = _inverse(D(l) - O_prev.T @ G_prev, infos)
        uinv[l] = prev
    _check_inverses(infos, what)
    return uinv, G


def _rowsum(P: torch.Tensor) -> torch.Tensor:
    """max_i sum_j |P_ij|, with the reference's margin."""
    return P.abs().sum(dim=-1).max() * _MARGIN


def _level_blocks(S_bb, S_tt, O, f_flat: np.ndarray, special: list, check: list):
    """One z-level's inverses (stored in f32) and the certified
    bound on rho(M^-1 A) for them: per layer
    1 + ||X D_m - I||_inf + ||X O_prev||_inf + ||X O_next||_inf, each
    product in f64 from the STORED X. Generic interior layers (all free,
    all-free neighbours) share one bound; only special layers and their
    neighbours are evaluated one by one."""
    Ln, b = f_flat.shape
    dev = S_bb.device
    I = torch.eye(b, dtype=_F64, device=dev)
    D_int = S_bb + S_tt
    infos: list = []
    x_int = _inverse(D_int, infos).to(_F32)  # all free: the mask is the identity on D
    f_t = {l: torch.as_tensor(f_flat[l], device=dev) for l in set(check) | {c + d for c in check for d in (-1, 1)}
           if 0 <= l < Ln}

    def D_of(l):
        return S_bb if l == 0 else S_tt if l == Ln - 1 else D_int

    by_key: dict = {}
    minvs = []
    for l in special:
        key = (l == 0, l == Ln - 1, f_flat[l].tobytes())
        if key not in by_key:
            by_key[key] = _inverse(_mask_block(D_of(l), f_t[l]), infos).to(_F32)
        minvs.append(by_key[key])
    _check_inverses(infos, "the layer blocks")
    minv_special = torch.stack(minvs)  # the first and last layers are always special
    x64_int = x_int.to(_F64)
    totals = []
    if len(special) < Ln:
        totals.append(1.0 + _rowsum(x64_int @ D_int - I) + _rowsum(x64_int @ O.T) + _rowsum(x64_int @ O))
    sp_map = dict(zip(special, range(len(special))))
    for l in check:
        X = minv_special[sp_map[l]].to(_F64) if l in sp_map else x64_int
        f = f_t[l]
        total = 1.0 + _rowsum(X @ _mask_block(D_of(l), f) - I)
        if l > 0:
            total = total + _rowsum(X @ (O.T * f[:, None] * f_t[l - 1][None, :]))
        if l < Ln - 1:
            total = total + _rowsum(X @ (O * f[:, None] * f_t[l + 1][None, :]))
        totals.append(total)
    lam = float(torch.stack(totals).max())
    return x_int, minv_special, lam


@span("fea.build.hierarchy")
def build_extruded_multigrid(
    scene,
    detected,
    *,
    degree: int = 2,
    thomas_layers: int = 17,
) -> ExtrudedMultigrid:
    """Build the z-semicoarsened hierarchy of an extruded scene on its
    device.

    ``detected`` is ``infer_extruded(scene)``. Coarsening halves the
    element-layer count while it is even and above ``thomas_layers - 1``;
    the last level is factored block-tridiagonally (exact solve), and a
    ValueError is raised if that level has more than 64 node layers. Each
    level re-integrates the per-quad Ke at the doubled z spacing (an
    anisotropic scaling, not the voxel hierarchy's uniform 2x).
    """
    quads, n2, L = detected
    quads = np.asarray(quads, np.int64)
    dev = scene.device
    grid = scene.host_nodes.astype(np.float64).reshape(L, n2, 3)
    h = float(grid[1, 0, 2] - grid[0, 0, 2])
    free_np = (1.0 - scene.fixed.cpu().numpy().astype(np.float64)).reshape(L, n2, 3)
    b = 3 * n2
    E = _corner_onehot(quads, n2, dev)

    levels = []
    Lz = L - 1  # element layers
    while Lz > thomas_layers - 1 and Lz % 2 == 0:
        kes = integrate_section_kes(grid[0], quads, h, scene.material)
        Ln = Lz + 1
        f_flat = free_np.reshape(Ln, b)
        special = [l for l in range(Ln) if l == 0 or l == Ln - 1 or not np.all(f_flat[l] == 1.0)]
        check = sorted({c for s in special for c in (s - 1, s, s + 1)} & set(range(Ln)))
        minv_int, minv_special, lam = _level_blocks(*_section_blocks(kes, E), f_flat, special, check)
        levels.append(_ELevel(
            op=_make(kes, quads, free_np.reshape(-1, 3), n2, Ln, _F32, dev),
            minv_interior=minv_int,
            special_idx=tuple(special),
            special=torch.as_tensor(special, dtype=torch.int64, device=dev),
            minv_special=minv_special,
            lam_max=lam,
        ))
        Lz //= 2
        h *= 2.0
        free_np = free_np[::2]

    Ln = Lz + 1
    if Ln > 64:
        raise ValueError(
            f"extruded multigrid stopped coarsening at {Ln} node layers "
            f"(> 64): pick an element-layer count divisible by 2 down to "
            f"<= {thomas_layers - 1} (e.g. a multiple of a power of two)"
        )
    S_bb, S_tt, O = _section_blocks(integrate_section_kes(grid[0], quads, h, scene.material), E)
    f = torch.as_tensor(free_np.reshape(Ln, b), device=dev)

    def D(l):
        return _mask_block(S_bb if l == 0 else S_tt if l == Ln - 1 else S_bb + S_tt, f[l])

    uinv, G = _thomas_chain(D, lambda l: O * f[l][:, None] * f[l + 1][None, :], Ln, "the z-coarsest chain")
    return ExtrudedMultigrid(
        levels=tuple(levels), thomas_uinv=uinv, thomas_g=G,
        coarse_free=torch.as_tensor(free_np, device=dev).to(_F32), degree=degree,
    )


# -- section-RBM coarse space (z-resolved) ------------------------------------


@dataclasses.dataclass(frozen=True)
class SectionCoarse:
    """Exact solve in the per-layer section-RBM coarse space, callable on
    flat (N, 3) residuals of any float dtype; the Thomas sweeps run in the
    factors' stored dtype, f32 (built in f64).

    Restriction P^T r sums, for each (layer, aggregate), the translations
    r and the rotations r x x of its nodes: a gather of each aggregate's
    section nodes (padded, in ascending order) and a sum over them, in a
    fixed order (no atomics), so a graph replay is bit for bit the last.
    """

    agg_s: torch.Tensor  # (n2,) int64 section aggregate of each section node
    xrel: torch.Tensor  # (n2, 3) radius-normalized in-plane offsets, f32
    members: torch.Tensor  # (As, C) int64 section nodes of each aggregate, padded
    member_m: torch.Tensor  # (As, C, 1) 0/1 mask of the padding, f32
    thomas_uinv: torch.Tensor  # (L, 6 As, 6 As) built f64, stored f32
    thomas_g: torch.Tensor  # (L - 1, 6 As, 6 As)
    n_aggs: int
    n_layers: int

    @classmethod
    def from_numpy(cls, agg: np.ndarray, xrel: np.ndarray, thomas_uinv: np.ndarray, thomas_g: np.ndarray, *,
                   n_aggs: int, n_layers: int, device) -> "SectionCoarse":
        """The coarse space of host arrays laid out as ``fea_tpu``'s
        (``agg`` (N,) = layer * As + section aggregate, ``xrel`` (N, 3)
        tiled over the layers), on ``device``."""
        agg = np.asarray(agg, np.int64)
        n2 = agg.size // n_layers
        agg_s = agg[:n2]
        if not np.array_equal(agg, (np.arange(n_layers)[:, None] * n_aggs + agg_s).reshape(-1)):
            raise ValueError("agg is not one section aggregation repeated layer by layer")
        t = lambda a: torch.tensor(np.asarray(a), device=device)  # noqa: E731
        return _section_coarse(agg_s, n_aggs, np.asarray(xrel)[:n2], t(thomas_uinv), t(thomas_g), n_layers,
                               torch.device(device))

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        dt = r.dtype
        L, As = self.n_layers, self.n_aggs
        x = self.xrel.to(dt)
        g = r.reshape(L, -1, 3)
        rc = torch.cat([g, torch.linalg.cross(g, x.expand_as(g), dim=-1)], dim=-1)  # (L, n2, 6)
        rs = (rc[:, self.members] * self.member_m.to(dt)).sum(dim=2)  # (L, As, 6)
        zf = _thomas_solve(self.thomas_uinv, self.thomas_g, rs.reshape(L, -1).to(self.thomas_uinv.dtype))
        zc = zf.reshape(L, As, 6).to(dt)[:, self.agg_s]  # (L, n2, 6)
        z = zc[..., :3] + torch.linalg.cross(x.expand_as(g), zc[..., 3:], dim=-1)
        return z.reshape(r.shape)


def _section_coarse(agg_s: np.ndarray, As: int, xrel_s: np.ndarray, uinv: torch.Tensor, G: torch.Tensor, L: int,
                    device: torch.device) -> SectionCoarse:
    counts = np.bincount(agg_s, minlength=As)
    C = int(counts.max())
    members = np.zeros((As, C), np.int64)
    member_m = np.zeros((As, C, 1), np.float32)
    for a in range(As):
        nodes_a = np.nonzero(agg_s == a)[0]  # ascending
        members[a, : nodes_a.size] = nodes_a
        member_m[a, : nodes_a.size] = 1.0
    t = lambda a: torch.tensor(a, device=device)  # noqa: E731
    return SectionCoarse(agg_s=t(agg_s.astype(np.int64)), xrel=t(xrel_s).to(torch.float32), members=t(members),
                         member_m=t(member_m), thomas_uinv=uinv, thomas_g=G, n_aggs=As, n_layers=L)


@dataclasses.dataclass(frozen=True)
class ComposedExtrudedPrecond:
    """Multiplicative composition: the section-RBM coarse correction
    first, then the z-semicoarsened V-cycle on the updated residual
    r - A z, taken with ``op``. :func:`build_extruded` gives it the f64
    operator: the reference takes that residual with the V-cycle's f32
    fine-level operator (an f64 apply is emulated on its chip), whose
    rounding of A z, for a z near a rigid motion, costs iterations (on the
    CPU: 25 against 23 on the slender tube of
    ``tests/test_section_coarse.py``); on the card the f64 apply costs
    about 0.03 ms more. The composition is multiplicative also when the
    mesh is already at Thomas size (the reference adds the two there, for
    want of a level-0 operator), where the V-cycle is the exact solve.

    The output is masked by the free mask, as the two-level correction
    is: the masked operator's fixed rows are an identity block with a zero
    residual, so the fixed rows of an iterate never drift; the free rows
    are the reference's."""

    mg: ExtrudedMultigrid
    sc: SectionCoarse
    op: ExtrudedOperator  # the operator of the residual update

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        z = self.sc(r)
        F = self.mg.free.to(r.dtype).reshape(r.shape)
        dt = self.op.dtype
        rm = (r.to(dt) - self.op.apply(z.to(dt).reshape(-1, 3)).reshape(r.shape)).to(r.dtype)
        return F * (z + self.mg(rm))


def _aggregate_section_2d(xy: np.ndarray, target: int) -> tuple[np.ndarray, int]:
    """Geometric 2D binning of section nodes into ~``target`` cells (the
    3D binning of ``twolevel.aggregate_nodes`` degenerates to one
    aggregate on a flat section)."""
    xy = np.asarray(xy, np.float64)
    lo = xy.min(axis=0)
    span = xy.max(axis=0) - lo
    span = np.where(span > 0, span, 1.0)
    h = float(np.sqrt(np.prod(span) / max(target, 1)))
    k = np.maximum(1, np.round(span / h)).astype(np.int64)
    ix = np.minimum((xy - lo) / (span / k), k - 1e-9).astype(np.int64)
    cell = ix[:, 0] * k[1] + ix[:, 1]
    _, agg = np.unique(cell, return_inverse=True)
    return agg.astype(np.int32), int(agg.max()) + 1


def _decoupling(xrel_s: np.ndarray, agg_s: np.ndarray, As: int) -> Optional[np.ndarray]:
    """Per-aggregate projector onto the null rigid-body modes (P e = 0) of
    degenerate aggregates (collinear or too few nodes), from each
    aggregate's 6x6 Gram of P; None when no aggregate has one. Those
    directions get a stiff decoupling diagonal, exact for the data, which
    has zero component there; a relative ridge would damage the low modes
    the coarse space exists to correct."""
    Pn = _rbm_blocks(torch.as_tensor(xrel_s)).numpy()  # (n2, 3, 6)
    gram = np.zeros((As, 6, 6))
    np.add.at(gram, agg_s, np.einsum("nia,nib->nab", Pn, Pn))
    decouple = np.zeros((As, 6, 6))
    for a in range(As):
        w_eig, V = np.linalg.eigh(gram[a])
        null = w_eig < 1e-8 * max(float(w_eig[-1]), 1.0)
        if null.any():
            Vn = V[:, null]
            decouple[a] = Vn @ Vn.T
    return decouple if decouple.any() else None


@span("fea.build.hierarchy")
def build_section_coarse(scene, detected, *, target_section_aggregates: int = 16) -> SectionCoarse:
    """Build the per-layer section-RBM coarse space of an extruded scene
    on its device: section aggregation (2D binning, on the host), the
    projected masked layer blocks Dc_l = (F P)^T D_l (F P) + P^T (1 - F) P
    and couplings Oc_l in f64, and the block-Thomas factors of the
    (L x 6 As)-block tridiagonal Galerkin matrix, chained in f64 and
    stored in f32. Interior all-free layers share one projection; layers
    touching constraints are projected one by one."""
    quads, n2, L = detected
    quads = np.asarray(quads, np.int64)
    dev = scene.device
    nodes = scene.host_nodes.astype(np.float64).reshape(L, n2, 3)
    h0 = float(nodes[1, 0, 2] - nodes[0, 0, 2])
    sec = nodes[0].copy()
    sec[:, 2] = 0.0
    agg_s, As = _aggregate_section_2d(sec[:, :2], target_section_aggregates)
    xrel_s = rigid_body_geometry(sec, agg_s, As)  # (n2, 3), z column 0
    b, bc = 3 * n2, 6 * As

    # P_s (b, bc): node i's rows hold [I3 | S(xrel_i)] in its aggregate's 6 columns
    Ps = torch.zeros((n2, 3, As, 6), dtype=_F64, device=dev)
    Ps[torch.arange(n2, device=dev), :, torch.as_tensor(agg_s, dtype=torch.int64, device=dev)] = \
        _rbm_blocks(torch.as_tensor(xrel_s, device=dev))
    Ps = Ps.reshape(b, bc)

    S_bb, S_tt, O = _section_blocks(integrate_section_kes(nodes[0], quads, h0, scene.material),
                                    _corner_onehot(quads, n2, dev))
    D_int = S_bb + S_tt
    free_np = (1.0 - scene.fixed.cpu().numpy().astype(np.float64)).reshape(L, b)
    allfree = [bool(np.all(fl == 1.0)) for fl in free_np]
    free = torch.as_tensor(free_np, device=dev)
    Dc_int = Ps.T @ D_int @ Ps
    Oc_int = Ps.T @ O @ Ps
    decouple = _decoupling(xrel_s, agg_s, As)
    if decouple is not None:
        dec = torch.zeros((As, 6, As, 6), dtype=_F64, device=dev)
        idx = torch.arange(As, device=dev)
        dec[idx, :, idx] = torch.as_tensor(decouple, device=dev)
        dec = dec.reshape(bc, bc)

    def Dc(l: int) -> torch.Tensor:
        first, last = l == 0, l == L - 1
        if allfree[l] and not first and not last:
            out = Dc_int
        else:
            f = free[l]
            D_l = S_bb if first else S_tt if last else D_int
            FP = f[:, None] * Ps
            out = FP.T @ D_l @ FP + ((1.0 - f)[:, None] * Ps).T @ Ps
        if decouple is not None:
            out = out + torch.clamp(torch.trace(out) / bc, min=1.0) * dec
        return out

    def Oc(l: int) -> torch.Tensor:
        if allfree[l] and allfree[l + 1]:
            return Oc_int
        return (free[l][:, None] * Ps).T @ O @ (free[l + 1][:, None] * Ps)

    uinv, G = _thomas_chain(Dc, Oc, L, "the section-coarse chain")
    return _section_coarse(agg_s.astype(np.int64), As, xrel_s, uinv, G, L, dev)
