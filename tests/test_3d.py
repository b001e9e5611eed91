"""3D end-to-end: solves, CLI, and sharding (reference dim 1-3,
KSFD/ksfdgrid.py:60-148)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from helpers import make_clargs
from ksfd_tpu import Grid, NumericsOptions, SolutionParameters
from ksfd_tpu.ops import PDEOperators
from ksfd_tpu.parallel import distribute
from ksfd_tpu.solvers import Solver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PARAMS_3D = [
    "dim=3", "nelements=16", "width=1", "height=1", "depth=1",
    "degree=3", "rhomax=28000", "cushion=2000", "s2=2.78e-4",
    "ngroups=1", "nligands_1=1", "alpha_1=1500", "beta_1=5.56e-4",
    "s_1_1=0.01", "gamma_1_1=0.01", "D_1_1=1e-6",
]


def _problem(nx=16):
    ps = SolutionParameters(make_clargs(params=PARAMS_3D))
    grid = Grid(dim=3, width=1, height=1, depth=1,
                nx=nx, ny=nx, nz=nx, dof=2, order=3)
    return ps, grid, PDEOperators(ps, grid)


def _u0(grid, amp=50.0):
    x = np.arange(grid.nx) / grid.nx
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    rho = 9000.0 + amp * np.sin(2 * np.pi * (X + Y + Z))
    return np.stack([rho, rho.copy()])


def test_3d_adaptive_solve():
    """Multiple accepted adaptive implicit steps on a 16^3 grid with
    the spectral block preconditioner; the unstable mode grows."""
    ps, grid, ops = _problem()
    numerics = NumericsOptions(ksp_iters=16)
    s = Solver(ops, numerics, t0=0.0, dt=1.0, tmax=50.0, maxsteps=50,
               rtol=1e-6, atol=0.01)
    u = np.asarray(s.solve(jnp.asarray(_u0(grid))))
    assert s.t > 50.0 and s.snes_failures == 0
    assert np.isfinite(u).all()
    # chemotaxis amplifies the perturbation (unstable equilibrium)
    assert u[0].max() - u[0].min() > 120.0


def test_3d_sharded_matches_single_device():
    """The 2x2x2 mesh solve agrees with the single-device solve:
    sharding-transparent 3D halos."""
    ps, grid, ops = _problem()
    # fixed dt: adaptive h depends on enorm whose reduction order
    # differs across shardings in the last ulps, so trajectories are
    # only comparable at identical step sequences
    numerics = NumericsOptions(ksp_iters=16, adapt_type="none",
                               sweep_dtype="float64")

    def run(u0):
        s = Solver(ops, numerics, t0=0.0, dt=1.0, tmax=1e9, maxsteps=8,
                   rtol=1e-6, atol=0.01)
        return np.asarray(s.solve(u0)), s.t

    u0 = _u0(grid)
    u_single, t1 = run(jnp.asarray(u0))
    u_sharded, mesh = distribute(jnp.asarray(u0), grid, shape=(2, 2, 2))
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "x": 2, "y": 2, "z": 2,
    }
    u_mesh, t2 = run(u_sharded)
    assert t1 == t2
    np.testing.assert_allclose(u_mesh, u_single, rtol=0, atol=1e-9)


@pytest.mark.slow
def test_3d_cli_end_to_end(tmp_path):
    """examples/aggregation3d shrunk to 16^3 x 4 steps through the
    real driver: random IC, CFL monitor, adaptive ramp, HDF5 output."""
    src = open(os.path.join(REPO, "examples", "aggregation3d")).read()
    lines = [
        ln for ln in src.splitlines()
        if not (ln.startswith("nelements=") or ln.startswith("--save")
                or ln.startswith("maxsteps="))
    ] + ["nelements=16", "maxsteps=4"]
    optfile = str(tmp_path / "options")
    with open(optfile, "w") as f:
        f.write("\n".join(lines) + "\n")
    save = str(tmp_path / "agg3d")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["KSFD_PLATFORM"] = "cpu"
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "ksfdsolver.py"),
         "@" + optfile, "--save=" + save],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=400,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    import h5py

    with h5py.File(save + "s1r0.h5", "r") as f:
        assert f["data4"].shape == (3, 16, 16, 16)
        assert np.isfinite(np.asarray(f["data4"])).all()


def test_3d_sharded_mixed_sweeps_close():
    """The default mixed-precision (f32) sweep chain is sharding-safe:
    sharded vs single-device agree to f32-reassociation level (halo
    bugs would show up as O(1) errors)."""
    ps, grid, ops = _problem()
    numerics = NumericsOptions(ksp_iters=4, adapt_type="none")
    assert numerics.sweep_dtype == "float32"  # the default under test

    def run(u0):
        s = Solver(ops, numerics, t0=0.0, dt=1.0, tmax=1e9, maxsteps=8,
                   rtol=1e-6, atol=0.01)
        return np.asarray(s.solve(u0))

    u0 = _u0(grid)
    u_single = run(jnp.asarray(u0))
    u_sharded, _ = distribute(jnp.asarray(u0), grid, shape=(2, 2, 2))
    u_mesh = run(u_sharded)
    np.testing.assert_allclose(u_mesh, u_single, rtol=0, atol=1e-4)


# ---------------------------------------------------------------------

def test_3d_fft_pc_matches_matmul_pc():
    """-pc_fft in 3D: rfftn over all three axes applies the same
    circulant inverse as the basis matmuls (f32 rounding)."""
    from ksfd_tpu.solvers.linalg import BlockSpectralPreconditioner

    ps, grid, ops = _problem(nx=12)
    u = jnp.asarray(_u0(grid))
    v = jax.random.normal(
        jax.random.PRNGKey(7), grid.Vshape, dtype=jnp.float64
    ) * 10.0
    means = [jnp.mean(u[i]) for i in range(u.shape[0])]
    bm = BlockSpectralPreconditioner(grid, ops)
    bf = BlockSpectralPreconditioner(grid, ops, use_fft=True)
    am = np.asarray(bm.apply_linearized(v, 0.5, 0.0, means, rho_diff=1e-4))
    af = np.asarray(bf.apply_linearized(v, 0.5, 0.0, means, rho_diff=1e-4))
    np.testing.assert_allclose(af, am, rtol=0, atol=5e-5 * np.abs(am).max())


