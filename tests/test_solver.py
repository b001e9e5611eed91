"""Solver integration tests: stepper order, solve paths, manufactured gate."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ksfd_tpu import NumericsOptions
from ksfd_tpu.solvers import Solver, make_step_fn, get_tableau
from manufactured import make_problem, exact_state, LAMDA


def _scalar_rosw(tab, f, dfdu, u0, h, T):
    """Scalar Rosenbrock-W integrator for order checks (pure python)."""
    u, t = u0, 0.0
    while t < T - 1e-12:
        W = 1.0 / (h * tab.gamma) - dfdu(u, t)
        Ys = []
        for i in range(tab.stages):
            Ui = u + sum(tab.a[i][j] * Ys[j] for j in range(i))
            bi = f(Ui, t + tab.alpha[i] * h) + sum(
                tab.c[i][j] / h * Ys[j] for j in range(i)
            )
            Ys.append(bi / W)
        u = u + sum(tab.m[j] * Ys[j] for j in range(tab.stages))
        t += h
    return u


def test_ros34pw2_order3():
    tab = get_tableau("rosw")
    f = lambda u, t: -u * u
    dfdu = lambda u, t: -2 * u
    errs = [
        abs(_scalar_rosw(tab, f, dfdu, 1.0, h, 1.0) - 0.5)
        for h in (0.1, 0.05, 0.025)
    ]
    orders = [np.log2(errs[i] / errs[i + 1]) for i in range(2)]
    assert min(orders) > 2.8


def test_beuler_order1():
    tab = get_tableau("beuler")
    f = lambda u, t: -u * u
    dfdu = lambda u, t: -2 * u
    errs = [
        abs(_scalar_rosw(tab, f, dfdu, 1.0, h, 1.0) - 0.5)
        for h in (0.1, 0.05)
    ]
    assert 0.8 < np.log2(errs[0] / errs[1]) < 1.3


@pytest.fixture(scope="module")
def manufactured32():
    ps, grid, ops = make_problem(nx=32)
    return ps, grid, ops


def test_dense_and_gmres_steps_agree(manufactured32):
    """One implicit step: exact dense LU vs preconditioned GMRES."""
    ps, grid, ops = manufactured32
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    dense_fn, _ = make_step_fn(
        ops, NumericsOptions(ksp_type="dense"), atol=0.01, rtol=1e-6
    )
    gmres_fn, _ = make_step_fn(
        ops, NumericsOptions(ksp_iters=20), atol=0.01, rtol=1e-6
    )
    ud, ed = dense_fn(u0, 0.0, 1.0)
    ug, eg = gmres_fn(u0, 0.0, 1.0)
    np.testing.assert_allclose(np.asarray(ug), np.asarray(ud), rtol=2e-9)
    assert float(ed) == pytest.approx(float(eg), rel=5e-2)


def test_manufactured_solution_gate_dense():
    """options93-style gate: fixed dt=1, exact exponential solution.

    Solver error after 20 steps must be at the spatial-truncation
    level, far below the solution's deviation amplitude.
    """
    ps, grid, ops = make_problem(nx=64)
    numerics = NumericsOptions(adapt_type="none", ksp_type="dense")
    solver = Solver(
        ops, numerics, t0=0.0, dt=1.0, tmax=1e9, maxsteps=20,
        rtol=1e-6, atol=0.01,
    )
    u0 = exact_state(ps, grid, 0.0)
    u = np.asarray(solver.solve(jnp.asarray(u0)))
    assert solver.k == 20 and solver.t == pytest.approx(20.0)
    uex = exact_state(ps, grid, 20.0)
    err = np.abs(u - uex).max()
    # deviation amplitude at t=20 is ~1.08; nx=64 4th-order spatial
    # truncation keeps the defect ~1e-4
    assert err < 2e-3, err


def test_gmres_rolled_matches_dense_step(manufactured32):
    """The rolled restarted GMRES (robust-tier workhorse) must match
    the exact dense LU stage solves to Krylov-convergence accuracy."""
    ps, grid, ops = manufactured32
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    dense_fn, _ = make_step_fn(
        ops, NumericsOptions(ksp_type="dense"), atol=0.01, rtol=1e-6
    )
    rolled_fn, _ = make_step_fn(
        ops,
        NumericsOptions(
            ksp_type="gmres_rolled", ksp_restart=12, ksp_max_it=3
        ),
        atol=0.01, rtol=1e-6,
    )
    ud, ed = dense_fn(u0, 0.0, 1.0)
    ur, er = rolled_fn(u0, 0.0, 1.0)
    np.testing.assert_allclose(np.asarray(ur), np.asarray(ud), rtol=2e-9)
    assert float(ed) == pytest.approx(float(er), rel=5e-2)


def test_gmres_rolled_agrees_with_fixed():
    """Same Krylov space -> same answer: rolled vs unrolled GMRES on a
    preconditioned nonsymmetric system, plus breakdown safety."""
    from ksfd_tpu.solvers.gmres import gmres_fixed, gmres_rolled

    rng = np.random.default_rng(7)
    n = 30
    A = np.eye(n) * 2.5 + 0.3 * rng.standard_normal((n, n))
    b = jnp.asarray(rng.standard_normal(n))
    op = lambda v: jnp.asarray(A) @ v
    M = lambda v: v / 2.5
    xref = np.linalg.solve(A, np.asarray(b))
    xr = np.asarray(gmres_rolled(op, b, M=M, iters=15, restarts=2))
    assert np.abs(xr - xref).max() < 1e-8
    xf = np.asarray(gmres_fixed(op, b, M=M, iters=15))
    x1 = np.asarray(gmres_rolled(op, b, M=M, iters=15, restarts=1))
    np.testing.assert_allclose(x1, xf, rtol=1e-6, atol=1e-9)
    # breakdown: zero rhs stays finite (zero)
    x0b = np.asarray(gmres_rolled(op, jnp.zeros(n), iters=5, restarts=2))
    assert np.all(x0b == 0.0)


def test_manufactured_solution_gate_gmres():
    ps, grid, ops = make_problem(nx=64)
    numerics = NumericsOptions(adapt_type="none", ksp_rtol=1e-10)
    solver = Solver(
        ops, numerics, t0=0.0, dt=1.0, tmax=1e9, maxsteps=20,
        rtol=1e-6, atol=0.01,
    )
    u0 = exact_state(ps, grid, 0.0)
    u = np.asarray(solver.solve(jnp.asarray(u0)))
    uex = exact_state(ps, grid, 20.0)
    assert np.abs(u - uex).max() < 2e-3


def test_adaptive_growth_and_monitors(manufactured32):
    """Adaptive run: h grows at small error; monitors fire per step."""
    ps, grid, ops = manufactured32
    numerics = NumericsOptions(ksp_type="dense")
    solver = Solver(
        ops, numerics, t0=0.0, dt=0.5, tmax=1e9, maxsteps=10,
        rtol=1e-6, atol=0.01,
    )
    seen = []
    solver.add_monitor(lambda s, k, t, u: seen.append((k, t)))
    solver.solve(jnp.asarray(exact_state(ps, grid, 0.0)))
    assert [k for k, _ in seen] == list(range(11))
    assert solver.h > 0.5  # error is tiny, controller must grow h
    assert not solver.diverged


def test_reject_and_rollback(manufactured32):
    """A huge dt must be rejected and cut back, not accepted."""
    ps, grid, ops = manufactured32
    numerics = NumericsOptions(ksp_type="dense", max_snes_failures=100)
    solver = Solver(
        ops, numerics, t0=0.0, dt=5e4, tmax=1e9, maxsteps=3,
        rtol=1e-10, atol=1e-8,
    )
    solver.solve(jnp.asarray(exact_state(ps, grid, 0.0)))
    assert solver.snes_failures > 0
    assert solver.h < 5e4


def test_gmres_breakdown_finite_and_judged():
    """Breakdown yields finite values; solve quality is judged upstream.

    gmres_fixed deliberately converts Krylov/Givens breakdown into a
    finite answer (see its docstring): benign breakdown (residual hit
    zero early) still returns the exact solution, and a singular
    operator leaves a large residual for the step-error control to
    reject — never NaN.
    """
    import jax.numpy as jnp

    from ksfd_tpu.solvers.gmres import gmres_fixed

    # benign breakdown: identity converges in 1 iter; the remaining 5
    # iterations divide by guarded zeros and must not corrupt x
    b = jnp.asarray(np.linspace(1.0, 2.0, 8))
    x = gmres_fixed(lambda v: v, b, iters=6)
    assert np.allclose(np.asarray(x), np.asarray(b), atol=1e-12)

    # genuine breakdown: singular projection operator, b not in range
    mask = jnp.asarray([1.0] * 4 + [0.0] * 4)
    op = lambda v: mask * v
    bb = jnp.ones(8)
    xx = gmres_fixed(op, bb, iters=6)
    assert np.all(np.isfinite(np.asarray(xx)))
    res = float(jnp.linalg.norm(bb - op(xx)))
    assert res > 0.5  # visibly unsolved -> embedded error rejects the step


def test_bf16_pc_transforms_step_agrees(manufactured32):
    """-pc_dtype bf16: transform matmuls in bfloat16 (the tensor-core
    rate for the many-sweep large-grid regime) with mode-space arithmetic kept
    f32 must still contract — the step lands within the dense step's
    neighborhood and the embedded error agrees to leading order."""
    from ksfd_tpu import decode_numerics

    ps, grid, ops = manufactured32
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    dense_fn, _ = make_step_fn(
        ops, NumericsOptions(ksp_type="dense"), atol=0.01, rtol=1e-6
    )
    nm = decode_numerics(["-pc_dtype", "bf16", "-ksp_iters", "20"])
    assert nm.pc_dtype == "bfloat16"
    bf_fn, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
    ud, ed = dense_fn(u0, 0.0, 1.0)
    ub, eb = bf_fn(u0, 0.0, 1.0)
    # bf16 transforms only slow convergence; 20 sweeps still land the
    # solve well inside the step-error tolerance
    np.testing.assert_allclose(np.asarray(ub), np.asarray(ud), rtol=1e-6)
    assert np.isfinite(float(eb))
    assert float(eb) == pytest.approx(float(ed), rel=0.2)


def test_fft_pc_matches_matmul_pc_operator():
    """-pc_fft: rfftn/irfftn applies the SAME circulant inverse as the
    DFT-basis matmuls (both diagonalize the discrete stencil exactly);
    agreement to f32 rounding on both pc variants."""
    from ksfd_tpu.solvers.linalg import (
        BlockSpectralPreconditioner,
        SpectralPreconditioner,
    )

    import __graft_entry__ as ge

    ps, grid, ops = ge._make_problem(24, 16)  # 2D: rfft truncation + x fft
    key = jax.random.PRNGKey(3)
    v = jax.random.normal(key, grid.Vshape, dtype=jnp.float64) * 10.0
    diff = [1e-6, 1e-5, 2e-5]
    decay = [0.0, 0.01, 0.02]
    pm = SpectralPreconditioner(grid)
    pf = SpectralPreconditioner(grid, use_fft=True)
    am = np.asarray(pm.apply(v, 0.5, diff, decay))
    af = np.asarray(pf.apply(v, 0.5, diff, decay))
    np.testing.assert_allclose(af, am, rtol=0, atol=5e-5 * np.abs(am).max())

    bm = BlockSpectralPreconditioner(grid, ops)
    bf = BlockSpectralPreconditioner(grid, ops, use_fft=True)
    u = jnp.asarray(ge._initial_state(grid))
    means = [jnp.mean(u[i]) for i in range(u.shape[0])]
    lm = np.asarray(bm.apply_linearized(v, 0.5, 0.0, means, rho_diff=1e-4))
    lf = np.asarray(bf.apply_linearized(v, 0.5, 0.0, means, rho_diff=1e-4))
    np.testing.assert_allclose(lf, lm, rtol=0, atol=5e-5 * np.abs(lm).max())

    # FFT mode must clamp an f64 pc_dtype to f32 (the approximate
    # inverse needs no complex128 transforms)
    b64 = BlockSpectralPreconditioner(
        grid, ops, compute_dtype=jnp.float64, use_fft=True
    )
    assert b64.compute_dtype == jnp.float32
    l64 = np.asarray(
        b64.apply_linearized(v, 0.5, 0.0, means, rho_diff=1e-4)
    )
    np.testing.assert_allclose(l64, lm, rtol=0, atol=5e-5 * np.abs(lm).max())


def test_fft_pc_step_agrees_with_dense(manufactured32):
    """A -pc_fft 1 step lands on the dense-LU step like the matmul-pc
    step does."""
    from ksfd_tpu import decode_numerics

    ps, grid, ops = manufactured32
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    dense_fn, _ = make_step_fn(
        ops, NumericsOptions(ksp_type="dense"), atol=0.01, rtol=1e-6
    )
    nm = decode_numerics(["-pc_fft", "1", "-ksp_iters", "20"])
    assert nm.pc_fft == "on"
    fft_fn, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
    ud, ed = dense_fn(u0, 0.0, 1.0)
    uf, ef = fft_fn(u0, 0.0, 1.0)
    np.testing.assert_allclose(np.asarray(uf), np.asarray(ud), rtol=1e-6)
    assert float(ef) == pytest.approx(float(ed), rel=0.2)


def test_wlte_norm_delta_matches_wlte_norm():
    # contract: d = uhat - u1, never-materialized uhat = u1 + d
    from ksfd_tpu.solvers.steppers import wlte_norm, wlte_norm_delta

    rng = np.random.default_rng(7)
    u1 = jnp.asarray(rng.normal(size=(3, 32)) * 100.0)
    d = jnp.asarray(rng.normal(size=(3, 32)) * 5.0)  # non-negligible
    atol, rtol = 0.01, 1e-6
    a = wlte_norm(u1, u1 + d, atol, rtol)
    b = wlte_norm_delta(u1, d, atol, rtol)
    assert abs(float(a) - float(b)) < 1e-12 * float(a)
    # bhat == b tableau: no embedded pair -> zero estimate
    assert float(wlte_norm_delta(u1, None, atol, rtol)) == 0.0
