"""The port's PCG (on ``device="cpu"``) against the JAX package's on the
same IC(0)-preconditioned 5-point Laplacian: equal iteration counts and
iterates within tolerance for exact, sweep (inexact) and guarded
preconditioners, ``stall_window``, the batched solve and the edge cases."""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

import repro.core.pcg as j_pcg
import repro.sparse as jsparse
from repro.compat import enable_x64
from repro.core import GuardConfig as JaxGuardConfig

import repro_torch.core.pcg as t_pcg
from repro_torch.core import GuardConfig

from _torch_parity import carry, to_port

# (port options, JAX options) of each preconditioner held against JAX
PRECONDITIONERS = {
    "levelset+rewrite": (dict(), dict()),
    "levelset": (dict(rewrite=None), dict(rewrite=None)),
    "serial": (dict(strategy="serial", rewrite=None),
               dict(strategy="serial", rewrite=None)),
    "pallas_level": (dict(strategy="pallas_level", rewrite=None),
                     dict(strategy="levelset", rewrite=None)),
    # the JAX fused kernel fails under JAX 0.9 (ROADMAP C-ref 1): the same
    # exact preconditioner through levelset is the reference
    "pallas_fused": (dict(strategy="pallas_fused", rewrite=None),
                     dict(strategy="levelset", rewrite=None)),
    "auto": (dict(strategy="auto", rewrite=None),
             dict(strategy="auto", rewrite=None)),
    "sweeps=8": (dict(sweeps=8), dict(sweeps=8)),
}


def _problem(nx=16, seed=0, m=None):
    A = jsparse.poisson2d(nx, nx)
    L = jsparse.ic0_factor(A)
    rng = np.random.default_rng(seed)
    b = rng.standard_normal(A.n if m is None else (A.n, m))
    return A, L, b


def _both(A, L, b, name, **pcg_kw):
    ours_kw, jax_kw = PRECONDITIONERS[name]
    M = t_pcg.make_ic_preconditioner(to_port(L), device="cpu", **ours_kw)
    got = t_pcg.pcg(to_port(A), torch.from_numpy(b), M, **pcg_kw)
    with enable_x64():
        Mj = j_pcg.make_ic_preconditioner(L, backend="interpret", **jax_kw)
        want = j_pcg.pcg(A, jnp.asarray(b), Mj, **pcg_kw)
        want_x = np.asarray(want.x)
    return got, want, want_x


@pytest.mark.parametrize("name", sorted(PRECONDITIONERS))
def test_pcg_matches_jax(name):
    A, L, b = _problem()
    got, want, want_x = _both(A, L, b, name, tol=1e-8, maxiter=300)
    assert got.converged and want.converged
    assert got.iters == want.iters
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-8, atol=1e-8)
    r = b - A.matvec(got.x.numpy())
    assert np.linalg.norm(r) <= 1e-8 * np.linalg.norm(b)
    assert got.residual == pytest.approx(want.residual, rel=1e-4)


def test_pcg_without_preconditioner_and_edge_cases():
    A, _, b = _problem(nx=8)
    got = t_pcg.pcg(to_port(A), torch.from_numpy(b), tol=1e-10, maxiter=200)
    with enable_x64():
        want = j_pcg.pcg(A, jnp.asarray(b), tol=1e-10, maxiter=200)
    assert got.iters == want.iters and got.converged
    # maxiter 0 and a zero right-hand side
    r0 = t_pcg.pcg(to_port(A), torch.from_numpy(b), maxiter=0)
    assert (r0.iters, r0.converged) == (0, False)
    z = t_pcg.pcg(to_port(A), torch.zeros(A.n, dtype=torch.float64))
    assert (z.iters, z.converged) == (0, True)
    # A = 0: pᵀAp = 0 is a breakdown, reported as not converged
    Z = to_port(A)
    Z = type(Z).from_numpy(Z.indptr, Z.indices, np.zeros_like(Z.data), Z.shape)
    brk = t_pcg.pcg(Z, torch.from_numpy(b), maxiter=10)
    assert not brk.converged and torch.isfinite(brk.x).all()


def test_stall_window_stops_like_jax():
    """Too few sweeps at a tight tolerance: the residual stagnates and the
    window stops the loop at the same iteration as the JAX package."""
    A, L, b = _problem(nx=24, seed=1)
    got, want, want_x = _both(A, L, b, "sweeps=8", tol=1e-14, maxiter=400,
                              stall_window=5)
    assert got.iters == want.iters
    assert got.converged == want.converged
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-8, atol=1e-8)


def test_guarded_preconditioner_matches_jax():
    A, L, b = _problem(seed=2)
    cfg = GuardConfig(residual_tol=1e-6, on_breakdown="refine")
    M = t_pcg.make_ic_preconditioner(to_port(L), guard=cfg, device="cpu")
    got = t_pcg.pcg(to_port(A), torch.from_numpy(b), M, tol=1e-8,
                    maxiter=400, stall_window=40)
    with enable_x64():
        Mj = j_pcg.make_ic_preconditioner(L, guard=carry(cfg, JaxGuardConfig),
                                          backend="interpret")
        want = j_pcg.pcg(A, jnp.asarray(b), Mj, tol=1e-8, maxiter=400,
                         stall_window=40)
        want_x = np.asarray(want.x)
    assert got.converged and want.converged and got.iters == want.iters
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-8, atol=1e-8)
    fwd, bwd = M.solvers
    assert fwd.guard.stats.solves == bwd.guard.stats.solves > 0


@pytest.mark.parametrize("name", ["levelset+rewrite", "pallas_fused",
                                  "sweeps=8"])
def test_pcg_batched_matches_jax(name):
    A, L, B = _problem(seed=3, m=4)
    B[:, 2] = 0.0  # converges in 0 iterations
    ours_kw, jax_kw = PRECONDITIONERS[name]
    M = t_pcg.make_ic_preconditioner_batched(to_port(L), device="cpu",
                                             **ours_kw)
    got = t_pcg.pcg_batched(to_port(A), torch.from_numpy(B), M, tol=1e-8,
                            maxiter=300)
    with enable_x64():
        Mj = j_pcg.make_ic_preconditioner_batched(L, backend="interpret",
                                                  **jax_kw)
        want = j_pcg.pcg_batched(A, jnp.asarray(B), Mj, tol=1e-8, maxiter=300)
        want_x = np.asarray(want.x)
    np.testing.assert_array_equal(got.iters, want.iters)
    np.testing.assert_array_equal(got.converged, want.converged)
    assert got.converged.all() and got.iters[2] == 0
    np.testing.assert_allclose(got.x.numpy(), want_x, rtol=1e-8, atol=1e-8)
    # each column's iterations are those of its own single-RHS run
    one = t_pcg.pcg(to_port(A), torch.from_numpy(B[:, 0]), M, tol=1e-8,
                    maxiter=300)
    assert one.iters == got.iters[0]
    with pytest.raises(ValueError):
        t_pcg.pcg_batched(to_port(A), torch.from_numpy(B[:, 0]), M)


def test_pcg_module_binds_like_the_reference():
    """``import repro_torch.core.pcg as m`` binds the module, as ``import
    repro.core.pcg`` does: ``repro_torch.core`` exports no PCG name."""
    import types

    import repro.core as j_core
    import repro_torch.core as t_core

    assert isinstance(t_pcg, types.ModuleType)
    assert isinstance(j_pcg, types.ModuleType)
    for name in ("make_ic_preconditioner", "make_ic_preconditioner_batched",
                 "pcg", "pcg_batched", "PCGResult", "BatchedPCGResult"):
        assert hasattr(t_pcg, name) and hasattr(j_pcg, name)
        assert (name in t_core.__all__) == (name in getattr(j_core, "__all__", ()))
        assert name not in t_core.__all__
