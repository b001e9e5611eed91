"""Sharded-vs-single-device identity: the 'multi-node without a
cluster' test strategy (SURVEY §4): the same jitted implicit step must
produce (near-)identical results on an 8-device virtual CPU mesh."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ksfd_tpu import Grid, NumericsOptions, SolutionParameters
from ksfd_tpu.ops import PDEOperators
from ksfd_tpu.parallel import distribute, grid_mesh, mesh_shape_for, state_sharding
from ksfd_tpu.solvers import Solver, make_step_fn
from helpers import make_clargs, OPTIONS92_PARAMS
from manufactured import make_problem, exact_state


def test_mesh_shape_factoring():
    assert mesh_shape_for(8, 1) == (8,)
    assert sorted(mesh_shape_for(8, 2)) == [2, 4]
    assert mesh_shape_for(8, 2, nps=(4, 64)) in ((2, 4), (4, 2))
    assert mesh_shape_for(1, 2) == (1, 1)


@pytest.mark.parametrize("n, dims, nps, want", [
    (8, 2, (1024, 1024), (8, 1)),
    (8, 2, (64, 64), (8, 1)),
    (8, 3, (64, 16, 16), (8, 1, 1)),
    (4, 2, (1536, 1536), (4, 1)),
    # any nx the devices divide keeps x-slabs (no 8-row tile rule)
    (4, 2, (36, 1024), (4, 1)),
    (8, 2, (40, 1024), (8, 1)),
    (1, 2, (64, 64), (1, 1)),
])
def test_mesh_shape_prefers_x_slabs(n, dims, nps, want):
    """Default 2D/3D meshes are x-only slabs whenever the devices
    divide nx: the sharded block-pc apply contracts x locally with one
    all-reduce per apply, and slabs exchange halos with two
    neighbours only."""
    assert mesh_shape_for(n, dims, nps=nps) == want


def test_mesh_shape_balanced_when_nx_indivisible():
    """nx not divisible by the device count: balanced factoring,
    capped so every axis divides its points."""
    assert sorted(mesh_shape_for(8, 2, nps=(36, 1024))) == [2, 4]
    shape = mesh_shape_for(8, 2, nps=(36, 1024))
    assert 36 % shape[0] == 0 and 1024 % shape[1] == 0
    grid = Grid(dim=2, width=1.0, height=1.0, nx=36, ny=1024, dof=3,
                order=3)
    assert grid_mesh(grid).devices.shape == shape


def test_rhs_sharded_matches_single():
    ps, grid, ops = make_problem(nx=64)
    u = jnp.asarray(exact_state(ps, grid, 0.0))
    rhs = jax.jit(ops.rhs)
    ref = np.asarray(rhs(u, 0.0))
    us, mesh = distribute(u, grid)
    assert mesh.devices.size == 8
    out = rhs(us, 0.0)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-9, atol=1e-10)


def test_step_sharded_matches_single_2d():
    """Full implicit step (GMRES + FFT precond) on a 2D sharded mesh."""
    params = [
        p for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0] not in
        ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + ["nelements=32", "dim=2", "height=1",
         "rho0=murho + arho*sin(2*pi*(x+y))", "U0_1_1=", "U0_2_1="]
    ps = SolutionParameters(make_clargs(params=params))
    grid = Grid(dim=2, width=1.0, height=1.0, nx=32, ny=32,
                dof=3, order=3)
    ops = PDEOperators(ps, grid)
    x = np.arange(32) / 32.0
    X, Y = np.meshgrid(x, x, indexing="ij")
    u = np.stack([
        9000 + np.sin(2 * np.pi * (X + Y)),
        9000 + 0.5 * np.cos(2 * np.pi * X),
        9000 + 0.25 * np.sin(2 * np.pi * Y),
    ])
    u = jnp.asarray(u)
    # f64 sweeps: the strict single-vs-sharded identity is an f64-path
    # property (mixed f32 sweeps reassociate at f32 eps; covered by a
    # looser check in test_3d.py)
    step, _ = make_step_fn(
        ops, NumericsOptions(ksp_rtol=1e-10, sweep_dtype="float64"),
        atol=0.01, rtol=1e-6)
    u1_ref, e_ref = step(u, 0.0, 1.0)
    us, mesh = distribute(u, grid)
    u1_sh, e_sh = step(us, 0.0, 1.0)
    # GMRES reductions reassociate across shards: tolerance not exact
    np.testing.assert_allclose(
        np.asarray(u1_sh), np.asarray(u1_ref), rtol=1e-9, atol=1e-9
    )
    assert float(e_sh) == pytest.approx(float(e_ref), rel=1e-2)
    # output keeps the sharding (no gather to one device)
    assert not u1_sh.sharding.is_fully_replicated


def test_distribute_preserves_values():
    ps, grid, ops = make_problem(nx=64)
    u = jnp.asarray(exact_state(ps, grid, 0.0))
    us, mesh = distribute(u, grid)
    np.testing.assert_array_equal(np.asarray(us), np.asarray(u))


def test_solver_loop_with_sharded_state():
    """The full outer solve (monitors, grooming, adaptivity) works on
    state distributed over the 8-device mesh."""
    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import Solver

    ps, grid, ops = make_problem(nx=64)
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    # pc_dtype pinned f32: the identity comparison needs the same pc
    # on both sides (the default 'auto' engages the bf16 wire lever
    # on the sharded side's >1-device mesh)
    numerics = NumericsOptions(adapt_type="none", sweep_dtype="float64",
                               pc_dtype="float32")
    ref_solver = Solver(ops, numerics,
                        t0=0.0, dt=1.0, tmax=1e9, maxsteps=3,
                        rtol=1e-6, atol=0.01)
    u_ref = np.asarray(ref_solver.solve(u0))
    us, mesh = distribute(u0, grid)
    sh_solver = Solver(ops, numerics,
                       t0=0.0, dt=1.0, tmax=1e9, maxsteps=3,
                       rtol=1e-6, atol=0.01)
    u_sh = sh_solver.solve(us)
    assert not u_sh.sharding.is_fully_replicated
    np.testing.assert_allclose(np.asarray(u_sh), u_ref,
                               rtol=1e-9, atol=1e-9)


def test_pc_dtype_auto_resolution():
    """pc_dtype 'auto' (the default) resolves to bfloat16 exactly when
    the build mesh spans >1 device — engaging the explicitly-sharded
    one-bf16-psum apply (the multi-device wire lever, VERDICT r4 #2) —
    and to float32 for single-device builds.  Explicit -pc_dtype
    always wins."""
    from ksfd_tpu.solvers.solver import BUILD_INFO

    ps, grid, ops = make_problem(nx=64)
    assert NumericsOptions().pc_dtype == "auto"
    # single-device build (no mesh): f32, transparent apply
    make_step_fn(ops, NumericsOptions(), atol=0.01, rtol=1e-6)
    assert BUILD_INFO["pc_dtype"] == "float32"
    assert not BUILD_INFO["pc_sharded"]
    # sharded build over the 8-device mesh: bf16 + sharded apply
    mesh = grid_mesh(grid)
    assert mesh.devices.size > 1
    make_step_fn(ops, NumericsOptions(), atol=0.01, rtol=1e-6,
                 mesh=mesh)
    assert BUILD_INFO["pc_dtype"] == "bfloat16"
    assert BUILD_INFO["pc_sharded"]
    # explicit pin beats auto
    make_step_fn(ops, NumericsOptions(pc_dtype="float32"), atol=0.01,
                 rtol=1e-6, mesh=mesh)
    assert BUILD_INFO["pc_dtype"] == "float32"
    assert not BUILD_INFO["pc_sharded"]


def test_mesh_shape_caps_and_divides():
    """mesh_shape_for never overshards a tiny grid (1D included —
    regression: the 1D branch skipped the cap) and every axis count
    divides the points (device_put rejects uneven shards)."""
    assert mesh_shape_for(8, 1, (4,)) == (4,)
    assert mesh_shape_for(8, 1, (6,)) == (2,)
    assert mesh_shape_for(8, 1, (1024,)) == (8,)
    for shape, nps in ((mesh_shape_for(8, 2, (4, 4)), (4, 4)),
                       (mesh_shape_for(8, 2, (6, 2)), (6, 2))):
        for s, npts in zip(shape, nps):
            assert s <= npts and npts % s == 0
    # end-to-end: a tiny 1D grid distributes over the 8-device mesh
    grid = Grid(dim=1, nx=4, dof=2)
    u = np.arange(8.0).reshape(2, 4)
    sharded, mesh = distribute(jnp.asarray(u), grid)
    np.testing.assert_array_equal(np.asarray(sharded), u)
