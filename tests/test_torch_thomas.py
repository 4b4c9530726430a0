"""The block-Thomas solve's dispatch and its kernel wrapper's checks, on the
CPU: the wrapper refuses what the kernel does not take before it builds
anything, and the CPU keeps the ``addmv_`` chain and its count."""
import numpy as np
import pytest
import torch

from fea_tpu_torch.ops import cuda_thomas, extruded_mg


def _factors(L, b, seed=3, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(L, b, b))
    uinv = (M + M.transpose(0, 2, 1)) / (2.0 * np.sqrt(b)) + 2.0 * np.eye(b)  # symmetric, as built
    G = rng.normal(size=(L - 1, b, b)) * (0.25 / np.sqrt(b))
    rf = rng.normal(size=(L, b))
    return tuple(torch.as_tensor(a, dtype=dtype) for a in (uinv, G, rf))


def _f64(args):
    return tuple(a.double() for a in args)


def _short_G(args):
    uinv, G, rf = args
    return uinv, G[1:], rf


def _wide_uinv(args):
    uinv, G, rf = args
    return torch.zeros((uinv.shape[0], 6, 8)), G, rf


def _strided_rf(args):
    uinv, G, rf = args
    return uinv, G, torch.zeros((rf.shape[1], rf.shape[0])).T


def _wide(args):
    return _factors(2, cuda_thomas.MAX_B + 2)


def _odd(args):
    return _factors(2, 7)


@pytest.mark.parametrize("bad,error,match", [
    (_f64, TypeError, "float32"),
    (_short_G, ValueError, "do not fit"),
    (_wide_uinv, ValueError, "do not fit"),
    (_strided_rf, ValueError, "not contiguous"),
    (_wide, ValueError, "not even in"),
    (_odd, ValueError, "not even in"),
    (lambda args: args, ValueError, "CUDA device"),
])
def test_the_wrapper_refuses_before_building(bad, error, match, monkeypatch):
    """f64 factors, a G or a Uinv that does not fit rf (L, b), a strided
    right-hand side, a block past the kernel's width or of odd width, and
    CPU tensors each raise before ``build()`` runs."""
    def no_build():
        raise AssertionError("built")

    monkeypatch.setattr(cuda_thomas, "build", no_build)
    with pytest.raises(error, match=match):
        cuda_thomas.thomas_solve(*bad(_factors(4, 6)))


@pytest.mark.parametrize("L,b", [(1, 6), (5, 12), (33, 42)])
def test_the_cpu_keeps_the_addmv_chain(L, b):
    """On the CPU the solve is the plain version, bit for bit, counted 2 (L - 1)
    launches and no kernel launch, and it solves the block-tridiagonal system
    the factors describe (its f64 answer against a dense solve)."""
    args = _factors(L, b)
    assert not cuda_thomas.takes(*args)
    n0 = dict(extruded_mg.LAUNCHES)
    got = extruded_mg._thomas_solve(*args)
    assert extruded_mg.LAUNCHES["thomas"] == n0["thomas"] + 2 * (L - 1)
    assert extruded_mg.LAUNCHES["thomas_kernel"] == n0["thomas_kernel"]
    assert torch.equal(got, extruded_mg._thomas_addmv(*args))
    # the system: U_l = Uinv_l^-1 on the diagonal, U_l G_l above it, its transpose below
    uinv, G, rf = (a.double().numpy() for a in args)
    U = np.linalg.inv(uinv)
    A = np.zeros((L * b, L * b))
    for l in range(L):
        A[l * b:(l + 1) * b, l * b:(l + 1) * b] = U[l] + (G[l - 1].T @ U[l - 1] @ G[l - 1] if l else 0.0)
        if l + 1 < L:
            O = U[l] @ G[l]
            A[l * b:(l + 1) * b, (l + 1) * b:(l + 2) * b] = O
            A[(l + 1) * b:(l + 2) * b, l * b:(l + 1) * b] = O.T
    x64 = extruded_mg._thomas_solve(*_f64(args)).numpy()
    want = np.linalg.solve(A, rf.reshape(-1)).reshape(L, b)
    assert np.abs(x64 - want).max() <= 1e-9 * np.abs(want).max()
    assert float((got.double() - torch.as_tensor(want)).abs().max()) <= 1e-5 * np.abs(want).max()


def test_thomas_counter_keys_exist_before_any_solve():
    """Both keys exist at import: a capture credits only the keys it finds."""
    assert {"thomas", "thomas_kernel"} <= set(extruded_mg.LAUNCHES)
