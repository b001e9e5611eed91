"""Stage-delta tests: PDEOperators.rhs_delta and the solver paths that
use it (stage RHS increments, f0-chaining), on 1D/2D/3D grids.

rhs_delta(u0, d, u1, t) must reproduce the float64 increment
rhs(u1) - rhs(u0) to ~f32 eps RELATIVE TO THE INCREMENT, which is what
lets it replace 3 of the 4 float64 stage RHS evaluations per step.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ksfd_tpu import Grid, NumericsOptions, SolutionParameters
from ksfd_tpu.ops import PDEOperators
from helpers import make_clargs, OPTIONS92_PARAMS

# grid points per axis by dimension: small, but every axis has the
# stencil's full support and divides the 8-device test mesh
NPTS = {1: 64, 2: 64, 3: 16}


def _problem(dim):
    n = NPTS[dim]
    params = [
        p for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0]
        not in ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + ["nelements=%d" % n, "dim=%d" % dim, "height=1", "depth=1",
         "rho0=murho", "U0_1_1=", "U0_2_1="]
    ps = SolutionParameters(make_clargs(params=params))
    grid = Grid(dim=dim, width=1.0, height=1.0, depth=1.0, nx=n, ny=n,
                nz=n, dof=3, order=3)
    return ps, grid, PDEOperators(ps, grid)


_PROBLEMS = {}


def problem(dim):
    if dim not in _PROBLEMS:
        _PROBLEMS[dim] = _problem(dim)
    return _PROBLEMS[dim]


@pytest.fixture(scope="module")
def ops2d():
    return problem(2)


def rough_state(grid, scale=1000.0, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(grid.Sshape)),
        6000 + scale * np.abs(rng.standard_normal(grid.Sshape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(grid.Sshape)),
    ])


def near_uniform_state(grid):
    n = grid.Sshape[0]
    wave = np.sin(2 * np.pi * np.arange(n) / n).reshape(
        (n,) + (1,) * (grid.dim - 1)
    ) * np.ones(grid.Sshape)
    return np.stack([9000 + wave, 6162 + 0.7 * wave, 797 + 0.1 * wave])


def _ref_and_delta(ops, u0, u1, t=0.5):
    ref = np.asarray(ops.rhs(u1, t) - ops.rhs(u0, t))
    out = np.asarray(jax.jit(ops.rhs_delta)(u0, u1 - u0, u1, t))
    return ref, out


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_delta_accuracy(dim):
    """float32 rhs_delta matches the f64 oracle increment to ~f32 eps
    RELATIVE TO THE INCREMENT on rough and near-uniform states (the
    bounds chip_smoke.py holds the GPU to)."""
    from chip_smoke import DELTA_BOUNDS

    ps, grid, ops = problem(dim)
    rng = np.random.default_rng(3)
    for name, u0, scale in (
        ("rough", rough_state(grid), 100.0),
        ("near_uniform", near_uniform_state(grid), 1e-3),
    ):
        u0 = ops.groom(jnp.asarray(u0))
        u1 = ops.groom(u0 + scale * rng.standard_normal(grid.Vshape))
        ref, out = _ref_and_delta(ops, u0, u1)
        assert out.dtype == np.float32
        err = np.abs(out - ref).max() / np.abs(ref).max()
        assert err < DELTA_BOUNDS[name], (name, err)


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_delta_clamp_to_floor(dim):
    """Increments that groom-clamp rho to its floor (drho/rho0 == -1
    in f32) must not produce inf/NaN and must stay accurate — the
    shifted-state input exists for exactly this."""
    ps, grid, ops = problem(dim)
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    rng = np.random.default_rng(4)
    u1 = ops.groom(u0 + 3e4 * rng.standard_normal(grid.Vshape))
    assert float(jnp.min(u1[0])) == ops.rhomin  # clamps happened
    ref, out = _ref_and_delta(ops, u0, u1)
    assert np.all(np.isfinite(out))
    assert np.abs(out - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_delta_periodic_wrap(dim):
    """Stencils wrap periodically: translating both states along every
    axis translates the increment."""
    ps, grid, ops = problem(dim)
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    u1 = ops.groom(u0 * (1.0 + 1e-3 * jnp.asarray(
        np.random.default_rng(5).standard_normal(grid.Vshape))))
    delta = jax.jit(ops.rhs_delta)
    out = np.asarray(delta(u0, u1 - u0, u1, 0.0))
    axes = tuple(range(1, 1 + dim))
    shifts = (5,) * dim
    s0, s1 = (jnp.roll(a, shifts, axis=axes) for a in (u0, u1))
    out_s = np.asarray(delta(s0, s1 - s0, s1, 0.0))
    np.testing.assert_allclose(
        out_s, np.roll(out, shifts, axis=axes),
        rtol=1e-4, atol=1e-5 * np.abs(out).max(),
    )


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_delta_groom_clamps_nan(dim):
    """A stage state with NaN entries (a diverging solve) goes through
    groom before rhs_delta, as in the solver's stage evaluation: NaN
    maps to the floor and the increment stays finite and equal to the
    increment towards the floor-clamped state."""
    ps, grid, ops = problem(dim)
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    u1 = np.asarray(u0) * 1.001
    u1_nan, u1_cl = u1.copy(), u1.copy()
    idx = (0,) + (3,) * dim
    u1_nan[idx] = np.nan
    u1_cl[idx] = ops.rhomin
    idx = (1,) + (2,) * dim
    u1_nan[idx] = np.nan
    u1_cl[idx] = ops.Umin
    delta = jax.jit(ops.rhs_delta)
    g_nan = ops.groom(jnp.asarray(u1_nan))
    g_cl = ops.groom(jnp.asarray(u1_cl))
    out_nan = np.asarray(delta(u0, g_nan - u0, g_nan, 0.0))
    out_cl = np.asarray(delta(u0, g_cl - u0, g_cl, 0.0))
    assert np.isfinite(out_nan).all()
    np.testing.assert_array_equal(out_nan, out_cl)


def test_stage_delta_ok_gates():
    """stage_delta_ok is the numerical precondition only: the flux form
    and the with-G operator keep full f64 stage evaluations; the
    -stage_delta option (default off) opts in on the mixed path."""
    from ksfd_tpu.ops import WithGOperators, with_g_grid
    from ksfd_tpu.solvers import make_step_fn
    from ksfd_tpu.solvers.solver import BUILD_INFO

    ps, grid, ops = problem(2)
    assert ops.stage_delta_ok()
    assert not PDEOperators(ps, grid, flux_form=True).stage_delta_ok()
    assert not WithGOperators(ps, with_g_grid(grid)).stage_delta_ok()
    make_step_fn(ops, NumericsOptions(stage_delta=True), atol=0.01, rtol=1e-6)
    assert BUILD_INFO["delta"] and BUILD_INFO["mixed32"]
    for nm in (NumericsOptions(),
               NumericsOptions(stage_delta=True, sweep_dtype="float64"),
               NumericsOptions(stage_delta=True, precision="float32")):
        make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
        assert not BUILD_INFO["delta"], nm


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_delta_sharded_matches_single(dim):
    """rhs_delta on x-sharded state (XLA inserts the halo exchanges and
    the f64 mean reductions) equals the single-device evaluation."""
    from ksfd_tpu.parallel import distribute, grid_mesh

    ps, grid, ops = problem(dim)
    mesh = grid_mesh(grid, shape=(8,) + (1,) * (dim - 1))
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    u1 = ops.groom(u0 + 100.0 * jnp.asarray(
        np.random.default_rng(2).standard_normal(grid.Vshape)))
    delta = jax.jit(ops.rhs_delta)
    out1 = np.asarray(delta(u0, u1 - u0, u1, 0.5))
    s0, _ = distribute(u0, grid, mesh=mesh)
    s1, _ = distribute(u1, grid, mesh=mesh)
    outs = delta(s0, s1 - s0, s1, 0.5)
    assert not outs.sharding.is_fully_replicated
    # identical math; only the f64 mean reduction order differs
    np.testing.assert_allclose(
        np.asarray(outs), out1, rtol=1e-5, atol=1e-6 * np.abs(out1).max()
    )


@pytest.mark.parametrize("dim", [1, 2, 3])
def test_delta_vmap_matches_members(dim):
    """jax.vmap over members (the ensemble path) matches per-member
    calls."""
    ps, grid, ops = problem(dim)
    U0 = jnp.stack([
        ops.groom(jnp.asarray(rough_state(grid, seed=i))) for i in range(3)
    ])
    U1 = jax.vmap(ops.groom)(U0 * 1.001)
    ts = jnp.asarray([0.25, 0.5, 1.0])
    out_v = np.asarray(jax.vmap(ops.rhs_delta)(U0, U1 - U0, U1, ts))
    out_s = np.stack([
        np.asarray(ops.rhs_delta(U0[i], U1[i] - U0[i], U1[i], ts[i]))
        for i in range(3)
    ])
    np.testing.assert_allclose(out_v, out_s, rtol=1e-6, atol=1e-6)


def test_stage_delta_step_matches_full(ops2d):
    """An f64 step with stage-delta evals must match the full-f64-eval
    step to the mixed-precision envelope."""
    from ksfd_tpu.solvers import make_step_fn

    ps, grid, ops = ops2d
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    t = jnp.asarray(0.0)
    # an ACCEPTED step (enorm < 1): a hugely rejected step's states
    # diverge inside the failing solve and amplify representation
    # differences meaninglessly
    h = jnp.asarray(1e-3)
    step_full, _ = make_step_fn(
        ops, NumericsOptions(), atol=0.01, rtol=1e-6
    )
    u_ref, e_ref = step_full(u0, t, h)
    assert float(e_ref) < 1.0
    step_delta, _ = make_step_fn(
        ops, NumericsOptions(stage_delta=True), atol=0.01, rtol=1e-6
    )
    u_del, e_del = step_delta(u0, t, h)
    assert u_del.dtype == jnp.float64
    inc = float(jnp.max(jnp.abs(u_ref - u0)))
    dev = float(jnp.max(jnp.abs(u_del - u_ref)))
    assert dev / inc < 1e-5, (dev, inc)
    # the embedded error estimates must agree (controller parity)
    assert abs(float(e_del) - float(e_ref)) / float(e_ref) < 1e-2


def test_mixed_precision_W_matches_f64_sweeps(ops2d):
    """The f32 sweep chain (f32 re-linearization W, f32 pc) must not
    move the accepted state beyond the sweep-truncation floor of the
    all-f64 sweeps."""
    from ksfd_tpu.solvers import make_step_fn

    ps, grid, ops = ops2d
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    t, h = jnp.asarray(0.0), jnp.asarray(1e-3)
    step64, _ = make_step_fn(
        ops, NumericsOptions(sweep_dtype="float64"), atol=0.01, rtol=1e-6
    )
    u_ref, e_ref = step64(u0, t, h)
    assert float(e_ref) < 1.0
    step32, _ = make_step_fn(ops, NumericsOptions(), atol=0.01, rtol=1e-6)
    u32, e32 = step32(u0, t, h)
    assert u32.dtype == jnp.float64
    inc = float(jnp.max(jnp.abs(u_ref - u0)))
    assert float(jnp.max(jnp.abs(u32 - u_ref))) / inc < 1e-5
    assert abs(float(e32) - float(e_ref)) / float(e_ref) < 1e-2


def test_multistep_f0_chaining_matches_per_step(ops2d):
    """The fused fixed-dt multistep advances the base RHS f0 through
    rhs_delta (one fresh f64 eval per block); the result must match
    per-step fresh evaluations to the mixed-precision envelope,
    accumulated over the block."""
    from ksfd_tpu.solvers import make_multistep_fn
    from ksfd_tpu.solvers.solver import make_step_fn

    ps, grid, ops = ops2d
    numerics = NumericsOptions(stage_delta=True)
    # chaining must actually engage
    sc, _ = make_step_fn(ops, numerics, atol=0.01, rtol=1e-6,
                         chain_f0=True)
    assert sc is not None
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    h = jnp.asarray(1e-3)
    n = 6
    multi, _ = make_multistep_fn(ops, numerics, atol=0.01, rtol=1e-6)
    u_chain, t_chain, emax = multi(u0, jnp.asarray(0.0), h, n)
    assert float(emax) < 1.0  # all steps accepted territory
    step, _ = make_step_fn(ops, numerics, atol=0.01, rtol=1e-6)
    u = u0
    inc_total = 0.0
    for i in range(n):
        u_prev = u
        u, _ = step(u, jnp.asarray(i * 1e-3), h)
        inc_total += float(jnp.max(jnp.abs(u - u_prev)))
    dev = float(jnp.max(jnp.abs(np.asarray(u_chain) - np.asarray(u))))
    assert dev / inc_total < 1e-5, (dev, inc_total)


def test_adaptive_chunk_f0_chaining(ops2d):
    """The fused adaptive chunk carries the chained base RHS across
    accept/reject; its trajectory must match the chunk with full f64
    stage evaluations."""
    from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn, make_step_fn

    ps, grid, ops = ops2d
    assert make_step_fn(
        ops, NumericsOptions(stage_delta=True), atol=0.01, rtol=1e-6,
        chain_f0=True,
    )[0] is not None
    assert make_step_fn(
        ops, NumericsOptions(), atol=0.01, rtol=1e-6,
        chain_f0=True,
    )[0] is None
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    args = (u0, jnp.asarray(0.0), jnp.asarray(1e-3), 1e9, 6)
    chunk_c, _ = make_adaptive_chunk_fn(
        ops, NumericsOptions(stage_delta=True), atol=0.01, rtol=1e-6
    )
    uc, tc, hc, kc, ac, _rc = chunk_c(*args)
    chunk_p, _ = make_adaptive_chunk_fn(
        ops, NumericsOptions(), atol=0.01, rtol=1e-6
    )
    up, tp, hp, kp, ap, _rp = chunk_p(*args)
    assert int(kc) == int(kp) and int(ac) == int(ap)
    # adaptive h amplifies the delta-vs-full representation difference
    # into slightly different accepted h's; the step SEQUENCE must
    # agree, t to ~0.1%
    assert abs(float(tc) - float(tp)) / float(tp) < 1e-3
    inc = float(jnp.max(jnp.abs(up - u0)))
    assert float(jnp.max(jnp.abs(uc - up))) / inc < 1e-4


def test_sharded_f64_mixed_step_matches_single(ops2d):
    """The flagship path on a mesh: the default f64 mixed-precision
    step built with mesh= runs sharded with stage-delta engaged and
    matches the single-device step at the established envelope."""
    from ksfd_tpu.parallel import distribute, grid_mesh
    from ksfd_tpu.solvers import make_step_fn
    from ksfd_tpu.solvers.solver import BUILD_INFO

    ps, grid, ops = ops2d
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    t, h = jnp.asarray(0.0), jnp.asarray(1e-3)
    nm = NumericsOptions(pc_dtype="float32", stage_delta=True)
    step_1, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
    u_ref, e_ref = step_1(u0, t, h)
    assert float(e_ref) < 1.0
    mesh = grid_mesh(grid, shape=(8, 1))
    step_s, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6, mesh=mesh)
    assert BUILD_INFO["mesh_shape"] == {"x": 8, "y": 1}
    assert BUILD_INFO["mixed32"] and BUILD_INFO["delta"]
    u_sh, _ = distribute(u0, grid, mesh=mesh)
    u_s, e_s = step_s(u_sh, t, h)
    assert u_s.dtype == jnp.float64
    assert not u_s.sharding.is_fully_replicated
    inc = float(jnp.max(jnp.abs(u_ref - u0)))
    dev = float(jnp.max(jnp.abs(u_s - u_ref)))
    assert dev / inc < 1e-5, (dev, inc)
    assert abs(float(e_s) - float(e_ref)) / float(e_ref) < 1e-2


def test_sharded_adaptive_chunk_f64(ops2d):
    """The device-fused adaptive chunk runs SHARDED on the f64 mixed
    path: same accept/attempt counts and trajectory as single-device."""
    from ksfd_tpu.parallel import distribute, grid_mesh
    from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn

    ps, grid, ops = ops2d
    u0 = ops.groom(jnp.asarray(rough_state(grid)))
    t0, h0 = jnp.asarray(0.0), jnp.asarray(1e-3)
    # pc_dtype pinned f32: the identity comparison needs the same pc
    # on both sides ('auto' engages the bf16 wire lever on the
    # sharded side, a deliberate non-identity default)
    nm = NumericsOptions(pc_dtype="float32", stage_delta=True)
    chunk1, _ = make_adaptive_chunk_fn(ops, nm, atol=0.01, rtol=1e-6)
    u1, t1, h1, k1, a1, r1 = chunk1(u0, t0, h0, 1e9, 5)
    assert int(k1) > 0
    mesh = grid_mesh(grid, shape=(8, 1))
    u_sh, _ = distribute(u0, grid, mesh=mesh)
    chunks, _ = make_adaptive_chunk_fn(
        ops, nm, atol=0.01, rtol=1e-6, mesh=mesh
    )
    us, ts_, hs_, ks_, as_, rs_ = chunks(u_sh, t0, h0, 1e9, 5)
    assert int(ks_) == int(k1) and int(as_) == int(a1)
    assert not us.sharding.is_fully_replicated
    inc = float(jnp.max(jnp.abs(u1 - u0)))
    assert float(jnp.max(jnp.abs(us - u1))) / inc < 1e-4
    assert abs(float(ts_) - float(t1)) / float(t1) < 1e-3


def test_solver_sharded_default_mesh_engages_delta(ops2d):
    """A DEFAULT-mesh (x-only via mesh_shape_for) sharded f64 run
    through Solver.solve rebuilds for the mesh with stage-delta
    engaged and matches the single-device solve."""
    from ksfd_tpu.parallel import distribute
    from ksfd_tpu.solvers import Solver

    ps, grid, ops = ops2d
    u0 = jnp.asarray(rough_state(grid))
    numerics = NumericsOptions(adapt_type="none", pc_dtype="float32",
                               stage_delta=True)

    def run(u):
        s = Solver(ops, numerics, t0=0.0, dt=1e-3, tmax=1e9, maxsteps=3,
                   rtol=1e-6, atol=0.01)
        return s, np.asarray(s.solve(u))

    s1, ref = run(u0)
    assert s1._mesh is None
    u_sh, mesh = distribute(u0, grid)  # DEFAULT mesh: x-only
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "x": 8, "y": 1,
    }
    ss, out = run(u_sh)
    assert ss._mesh == mesh
    assert ss.build_info["mixed32"] and ss.build_info["delta"]
    assert ss.build_info["mesh_shape"] == {"x": 8, "y": 1}
    inc = np.abs(ref - np.asarray(ops.groom(u0))).max()
    assert np.abs(out - ref).max() / inc < 1e-4


def test_sharded_f32_fast_solve_matches_single(ops2d):
    """The float32 fast mode (f32 state, XLA f32 RHS and J-action) runs
    on sharded state through Solver.solve and matches the
    single-device run."""
    from ksfd_tpu.parallel import distribute, grid_mesh
    from ksfd_tpu.solvers import Solver

    ps, grid, ops = ops2d
    u0 = rough_state(grid)
    numerics = NumericsOptions(precision="float32", adapt_type="none")

    def run(u_init):
        solver = Solver(ops, numerics, t0=0.0, dt=0.05, tmax=0.2,
                        maxsteps=3)
        return solver, np.asarray(solver.solve(u_init))

    s1, ref = run(jnp.asarray(u0, dtype=jnp.float32))
    assert not s1.build_info["delta"] and s1.build_info["fast32"]
    mesh = grid_mesh(grid, shape=(8, 1))
    u_sh, _ = distribute(jnp.asarray(u0, dtype=jnp.float32), grid,
                         mesh=mesh)
    ss, out = run(u_sh)
    assert ss._mesh == mesh
    np.testing.assert_allclose(
        out, ref, rtol=2e-4, atol=2e-4 * np.abs(ref).max()
    )
