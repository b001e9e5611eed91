#!/usr/bin/env python3
"""Big-3D benchmark of the implicit step on a GPU.

The 3D analog of bench.py (same slope timing): the options84-class
physics (rho + attractant + repellent, 3 dofs) on an nx^3 grid, f64
mixed-precision ROS34PW2 steps chained inside one device execution.
Reference capability: dim-3 grids are first-class
(KSFD/ksfdgrid.py:60-148).

--check first compares PDEOperators.rhs_delta against the f64
difference of two RHS evaluations on a ROUGH state.

Exits non-zero without a GPU.  Prints ONE JSON line like bench.py.
"""

import argparse
import json
import os
import sys

BASELINE_DOF_UPDATES_PER_SEC = 7.08e6 * 1e4 / 86400.0  # bench.py

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _HERE)
sys.path.insert(0, os.path.join(_HERE, "tests"))


def make_problem3d(nx, ny=None, nz=None):
    from helpers import make_clargs, OPTIONS92_PARAMS
    from ksfd_tpu import Grid, SolutionParameters
    from ksfd_tpu.ops import PDEOperators

    ny = ny or nx
    nz = nz or nx
    params = [
        p
        for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0]
        not in ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + [
        "nelements=%d" % nx,
        "nwidth=%d" % nx,
        "nheight=%d" % ny,
        "ndepth=%d" % nz,
        "dim=3",
        "height=1",
        "depth=1",
        "rho0=murho + arho*sin(2*pi*(x+y+z))",
        "U0_1_1=",
        "U0_2_1=",
    ]
    ps = SolutionParameters(make_clargs(params=params))
    grid = Grid(
        dim=3, width=1.0, height=1.0, depth=1.0,
        nx=nx, ny=ny, nz=nz, dof=3, order=3,
    )
    return ps, grid, PDEOperators(ps, grid)


def rough_state(grid, scale=1000.0):
    import numpy as np

    rng = np.random.default_rng(0)
    return np.stack([
        6000 + 3 * scale * np.abs(rng.standard_normal(grid.Sshape)),
        6000 + scale * np.abs(rng.standard_normal(grid.Sshape)),
        6000 + 0.5 * scale * np.abs(rng.standard_normal(grid.Sshape)),
    ])


def check_delta(ops, grid):
    """Max deviation of rhs_delta from the f64 increment on a rough
    state, relative to the increment."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    u = ops.groom(jnp.asarray(rough_state(grid)))
    v = jnp.asarray(np.random.default_rng(1).standard_normal(grid.Vshape))
    u1 = ops.groom(u + 100.0 * v)
    ref = ops.rhs(u1, 0.5) - ops.rhs(u, 0.5)
    got = jax.jit(ops.rhs_delta)(u, u1 - u, u1, 0.5)
    return float(jnp.max(jnp.abs(got - ref)) / jnp.max(jnp.abs(ref)))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=128)
    parser.add_argument("--ny", type=int, default=None)
    parser.add_argument("--nz", type=int, default=None)
    parser.add_argument("--steps", type=int, default=24)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--check", action="store_true",
                        help="validate rhs_delta vs the f64 oracle on a "
                             "rough state first")
    args = parser.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import make_multistep_fn

    if jax.devices()[0].platform != "gpu":
        print("bench3d: no GPU", file=sys.stderr)
        return 2
    ps, grid, ops = make_problem3d(args.nx, args.ny, args.nz)
    record = bench.device_record()
    if args.check:
        record["delta_err_over_increment"] = check_delta(ops, grid)
    multi, _ = make_multistep_fn(
        ops, NumericsOptions(), atol=0.01, rtol=1e-6, static_steps=False
    )
    x = np.arange(grid.nx) / grid.nx
    y = np.arange(grid.ny) / grid.ny
    z = np.arange(grid.nz) / grid.nz
    X, Y, Z = np.meshgrid(x, y, z, indexing="ij")
    s = np.sin(2 * np.pi * (X + Y + Z))
    u = jnp.asarray(
        np.stack([9000.0 + s, 9000.0 + 0.7 * s, 9000.0 + 0.1 * s])
    )
    t = jnp.asarray(0.0)
    h = jnp.asarray(args.dt)
    i32 = lambda n: jnp.asarray(n, jnp.int32)
    multi(u, t, h, i32(2))  # compile
    step_time, (_, _, enorm) = bench.slope_time(
        multi, lambda n: (u, t, h, i32(n)), 2, args.steps + 2,
        args.repeats,
    )
    dof = grid.n_dofs
    rate = dof / step_time
    assert np.isfinite(float(enorm)), "benchmark step diverged"
    print(json.dumps(dict(
        record,
        metric="implicit KS step DOF-updates/sec (3D %dx%dx%d, 3 dofs, "
               "f64, ROS34PW2)" % (grid.nx, grid.ny, grid.nz),
        value=rate, step_s=step_time, unit="DOF-updates/sec",
        vs_baseline=rate / BASELINE_DOF_UPDATES_PER_SEC,
    )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
