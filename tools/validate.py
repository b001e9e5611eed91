#!/usr/bin/env python3
"""Run the reference's convergence gate end-to-end and report error.

The options93nx128dt1 workload: 1D n=128, two ligand groups, fixed
dt=1, 2080 implicit steps, with a closed-form rho source that makes
the exponentially growing eigenmode solution EXACT for the continuum
system (we derive the source symbolically from the exact solution —
tests/manufactured.py).  The reference solved it in ~14 min on the
author's PC (/root/reference/options93nx128dt1:15-19); the final
error vs the exact solution measures the solver's spatial+temporal
discretization quality.

    python tools/validate.py                 # full 2080 steps
    python tools/validate.py --steps 100 --nx 64
    python tools/validate.py --ksp banded    # native direct solves
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), os.pardir, "tests")
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=128)
    parser.add_argument("--steps", type=int, default=2080)
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--ksp", default=None,
                        help="richardson|gmres|dense|banded")
    parser.add_argument("--iters", type=int, default=None)
    parser.add_argument("--block", type=int, default=1,
                        help="fuse this many fixed steps per device "
                             "execution (block_steps)")
    parser.add_argument("--convergence", action="store_true",
                        help="run nx=32/64/128 at fixed t and report "
                             "the spatial convergence order (the "
                             "reference thesis-section-3.8 test)")
    args = parser.parse_args(argv)
    if args.convergence:
        return convergence(args)

    r = gate(nx=args.nx, steps=args.steps, dt=args.dt, ksp=args.ksp,
             iters=args.iters, block=args.block)
    print(
        "nx=%d steps=%d dt=%g t=%g wall=%.2fs (%.1f steps/s)"
        % (args.nx, r["steps"], args.dt, r["t"], r["wall"],
           r["steps"] / r["wall"])
    )
    print(
        "max abs error=%.3e  deviation amplitude=%.3e  relative=%.3e"
        % (r["max_abs_err"], r["amplitude"], r["rel_err"])
    )
    print(
        "reference figure for this workload: ~14 min for 2080 steps "
        "(~2.5 steps/s) on the author's PC"
    )
    return 0


def gate(nx=128, steps=2080, dt=1.0, ksp=None, iters=None, block=1):
    """Run the manufactured-solution workload; returns a dict with the
    step count, final t, wall seconds, max abs error against the exact
    solution, the deviation amplitude and their ratio (rel_err)."""
    import numpy as np
    import jax.numpy as jnp

    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import Solver
    from manufactured import make_problem, exact_state

    ps, grid, ops = make_problem(nx=nx)
    kw = dict(adapt_type="none")
    if ksp:
        kw["ksp_type"] = ksp
    if iters:
        kw["ksp_iters"] = iters
    numerics = NumericsOptions(**kw)
    solver = Solver(
        ops, numerics, t0=0.0, dt=dt, tmax=1e18,
        maxsteps=steps, rtol=1e-6, atol=0.01,
        block_steps=block,
    )
    u0 = exact_state(ps, grid, 0.0)
    t0 = time.perf_counter()
    u = np.asarray(solver.solve(jnp.asarray(u0)))
    elapsed = time.perf_counter() - t0
    uex = exact_state(ps, grid, solver.t)
    err = np.abs(u - uex).max()
    amp = np.abs(uex - 9000.0).max()
    return dict(steps=solver.k, t=solver.t, wall=elapsed,
                max_abs_err=err, amplitude=amp, rel_err=err / amp)


def convergence(args):
    """Fixed-t spatial convergence sweep: error must fall ~h^4
    (degree-3 stencils => 4th-order central differences)."""
    import numpy as np
    import jax.numpy as jnp

    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import Solver
    from manufactured import make_problem, exact_state

    steps = min(args.steps, 50)
    errs = []
    nxs = [32, 64, 128]
    kw = dict(adapt_type="none", ksp_iters=args.iters or 16)
    if args.ksp:
        kw["ksp_type"] = args.ksp
    for nx in nxs:
        ps, grid, ops = make_problem(nx=nx)
        numerics = NumericsOptions(**kw)
        solver = Solver(ops, numerics, t0=0.0, dt=args.dt, tmax=1e18,
                        maxsteps=steps, rtol=1e-6, atol=0.01,
                        block_steps=args.block)
        u = np.asarray(solver.solve(jnp.asarray(exact_state(ps, grid, 0.0))))
        err = np.abs(u - exact_state(ps, grid, solver.t)).max()
        errs.append(err)
        print("nx=%4d  t=%g  max err=%.4e" % (nx, solver.t, err))
    for i in range(1, len(nxs)):
        order = np.log2(errs[i - 1] / errs[i])
        print("order(%d->%d) = %.2f" % (nxs[i - 1], nxs[i], order))
    return 0


if __name__ == "__main__":
    sys.exit(main())
