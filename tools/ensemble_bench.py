#!/usr/bin/env python3
"""Ensemble throughput benchmark: N members as ONE vmapped program.

Measures ms per ensemble step (every member advances one fixed-dt
implicit ROS34PW2 step) and aggregate DOF-updates/sec on the GPU, one
JSON line per member count, slope-timed like bench.py over two chained
execution lengths so fixed per-dispatch costs cancel.  Exits non-zero
without a GPU.
"""

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--members", default="1,4,8,16",
                    help="comma-separated member counts")
    ap.add_argument("--steps", type=int, default=24,
                    help="timed chained steps (after warmup)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed repeats per chain length (min taken)")
    ap.add_argument("--dt", type=float, default=1.0)
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as ge
    import bench
    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import make_multistep_fn

    if jax.devices()[0].platform != "gpu":
        print("ensemble_bench: no GPU", file=sys.stderr)
        return 2
    record = bench.device_record()
    ps, grid, ops = ge._make_problem(args.nx, args.nx)
    multi, _ = make_multistep_fn(ops, NumericsOptions(), atol=0.01,
                                 rtol=1e-6)
    vmulti = jax.jit(
        jax.vmap(multi, in_axes=(0, 0, 0, None)), static_argnums=3
    )
    base = np.asarray(ge._initial_state(grid))
    n_small, n_big = 2, args.steps + 2

    for N in [int(x) for x in args.members.split(",")]:
        rng = np.random.default_rng(0)
        U0 = jnp.asarray(np.stack([
            base * (1.0 + 1e-4 * rng.standard_normal(base.shape))
            for _ in range(N)
        ]))
        ts = jnp.zeros(N)
        hs = jnp.full(N, args.dt)
        for nst in (n_small, n_big):  # compile both chain lengths
            jax.block_until_ready(vmulti(U0, ts, hs, nst))
        step_time, (_, _, e1) = bench.slope_time(
            vmulti, lambda n: (U0, ts, hs, n), n_small, n_big,
            args.repeats,
        )
        assert np.isfinite(np.asarray(e1)).all(), "step diverged"
        print(json.dumps(dict(
            record, nx=args.nx, members=N,
            ms_per_ensemble_step=step_time * 1e3,
            per_member_ms=step_time * 1e3 / N,
            aggregate_dof_per_s=N * grid.n_dofs / step_time,
        )), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
