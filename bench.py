#!/usr/bin/env python3
"""Benchmark: DOF-updates/sec for the implicit Keller-Segel step on a GPU.

Workload: the options84-class 2D problem (worm density + attractant +
repellent ligand groups, periodic, degree-3 stencils) at nx=ny=1024,
3 dofs = 3.1M DOF, float64 state.  One "update" = one full implicit
Rosenbrock-W (ROS34PW2) step: 4 stages, spectrally block-
preconditioned mixed-precision Richardson stage solves (matrix-free
GMRES is the rejection fallback), stage RHS increments and the
block-chained base RHS via PDEOperators.rhs_delta, embedded error
estimate — the same work the reference does per PETSc TSStep with
analytic-Jacobian assembly + MUMPS LU.

Figures (--figures, default all three):
  fixed     the fused fixed-dt multistep on a smooth state;
  adaptive  the device-fused adaptive chunk at a pinned h (same state);
  stiff     the adaptive chunk on a rough capped-peak state at a
            solve-limited h, where the escalation tiers engage.
Each is slope-timed: (t(n_big) - t(n_small)) / (n_big - n_small) over
chained steps inside one device execution, min over --repeats, each
execution ended by block_until_ready; fixed per-call costs cancel.
Compilation is timed separately (ahead-of-time lower().compile()).

Baseline derivation (BASELINE.md): the reference's only at-scale
figure is the options84 cluster config — 16 MPI ranks x 8 threads,
1536^2 x 3 dofs (~7.08M DOF), maxsteps=10000, completing within the
24 h SLURM walltime (options84s16.sh) => >= 7.08e6*1e4/86400 =
8.19e5 DOF-updates/sec for the whole 16-rank allocation.

Exits non-zero when JAX finds no GPU.  Prints ONE JSON line naming the
device (platform, device_kind, count) and the card (nvidia-smi name
and power limit).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

BASELINE_DOF_UPDATES_PER_SEC = 7.08e6 * 1e4 / 86400.0  # 819,200/s


def _rough_state(grid, ps):
    """Deterministic aggregated-phase-like state: sharp capped peaks
    over a depleted background — the regime the production E2E runs
    live in (post-onset aggregation2d: rho spans ~[300, 25000] with
    cell-scale gradients, 16+-application solves).  Pseudo-random but
    seed-fixed so the bench is reproducible run to run."""
    import numpy as np

    v0 = ps.values0
    rhomax = float(v0.get("rhomax", 28000.0))
    nx, ny = int(grid.nx), int(grid.ny)
    x = np.arange(nx) / nx
    y = np.arange(ny) / ny
    X, Y = np.meshgrid(x, y, indexing="ij")
    rng = np.random.default_rng(1234)
    # aggregation-scale capped peaks holding MOST of the mass (the
    # production pattern at 1536^2 has ~420 aggregates of ~15-25 cell
    # radius at the cap with a depleted background; a state whose
    # peaks hold negligible mass just diffuses flat and the stiffness
    # evaporates within a few accepts).  rho*Vcap' at the capped peaks
    # is the stiffness driver: the pc's max-bound rho diffusivity then
    # over-damps the background by ~2 orders.
    npeaks = max(48, (nx * ny) // 8192)
    rho = np.full((nx, ny), 300.0)
    for cx, cy in rng.random((npeaks, 2)):
        # periodic squared distance, width ~10 cells
        dx = np.minimum(np.abs(X - cx), 1.0 - np.abs(X - cx))
        dy = np.minimum(np.abs(Y - cy), 1.0 - np.abs(Y - cy))
        w = 10.0 / nx
        rho += 0.95 * rhomax * np.exp(-(dx**2 + dy**2) / (2 * w * w))
    rho = np.minimum(rho, 0.93 * rhomax)
    # ligands at their pointwise steady state s/gamma * rho: the
    # rho gradients then transfer straight into the chemotactic
    # velocity, keeping the solve stiffness sustained
    fields = [rho]
    for lig in ps.Vgroups.ligands():
        suffix = lig.name()[1:]
        sval = float(v0.get("s" + suffix, lig.s))
        gval = float(v0.get("gamma" + suffix, lig.gamma))
        fields.append(rho * (sval / gval))
    return np.stack(fields)


def device_record():
    """platform, device_kind, count and the card's nvidia-smi
    `name, power.limit` line(s)."""
    import jax

    devs = jax.devices()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return dict(platform=devs[0].platform, device_kind=devs[0].device_kind,
                count=len(devs), card=smi)


def slope_time(fn, args_for, n_small, n_big, repeats):
    """(seconds per step, outputs of the last n_big call): fn(*args_for(n))
    timed to block_until_ready, min over repeats, slope between the two
    chain lengths."""
    import jax

    times = {n_small: [], n_big: []}
    out = None
    for _ in range(repeats):
        for n in (n_small, n_big):
            args = args_for(n)
            jax.block_until_ready(args)
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            times[n].append(time.perf_counter() - t0)
    return (min(times[n_big]) - min(times[n_small])) / (n_big - n_small), out


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--nx", type=int, default=1024,
                        help="grid points per axis")
    parser.add_argument("--steps", type=int, default=48,
                        help="timed chained steps (after warmup)")
    parser.add_argument("--repeats", type=int, default=3,
                        help="timed repeats per chain length (min taken)")
    parser.add_argument("--dt", type=float, default=1.0)
    parser.add_argument("--ksp-iters", type=int, default=None,
                        help="preconditioned Richardson sweeps per stage "
                             "(default: the library default)")
    parser.add_argument("--stage-delta", type=int, choices=(0, 1),
                        default=None,
                        help="force -stage_delta (default: the library "
                             "default)")
    parser.add_argument("--cheb-unroll", action="store_true",
                        help="unroll every Chebyshev/Richardson "
                             "iteration (the 48-application top tier "
                             "included) instead of rolling long ones")
    parser.add_argument("--figures", default="fixed,adaptive,stiff",
                        help="comma-separated subset of fixed,adaptive,"
                             "stiff")
    parser.add_argument("--stiff-h", type=float, default=2.0,
                        help="pinned step size for the stiff-regime "
                             "figure (must be solve-limited on the "
                             "rough state: fast tier rejects, "
                             "escalated tiers carry it)")
    args = parser.parse_args(argv)
    figures = set(args.figures.split(","))

    import jax
    import jax.numpy as jnp
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        print("bench: no GPU (JAX platform %r)" % jax.devices()[0].platform,
              file=sys.stderr)
        return 2

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import __graft_entry__ as ge
    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import gmres, make_adaptive_chunk_fn
    from ksfd_tpu.solvers import make_multistep_fn

    if args.cheb_unroll:
        gmres.UNROLL_MAX = 1 << 30
    nx = args.nx
    ps, grid, ops = ge._make_problem(nx, nx)
    kw = {}
    if args.ksp_iters is not None:
        kw["ksp_iters"] = args.ksp_iters
    if args.stage_delta is not None:
        kw["stage_delta"] = bool(args.stage_delta)
    numerics = NumericsOptions(**kw)
    dof = grid.n_dofs
    u = jnp.asarray(ge._initial_state(grid))
    t = jnp.asarray(0.0)
    h = jnp.asarray(args.dt)
    n_small, n_big = 2, args.steps + 2
    i32 = lambda n: jnp.asarray(n, jnp.int32)
    result = dict(device_record(), nx=nx, dof=dof,
                  stage_delta=numerics.stage_delta,
                  cheb_unroll=bool(args.cheb_unroll),
                  unit="DOF-updates/sec")

    def compiled(fn, *example):
        t0 = time.perf_counter()
        c = fn.lower(*example).compile()
        return c, time.perf_counter() - t0

    if "fixed" in figures:
        # the fused fixed-dt multi-step driver: the steps are CHAINED
        # inside one device execution, like a production fixed-dt run
        multi, _ = make_multistep_fn(
            ops, numerics, atol=0.01, rtol=1e-6, static_steps=False
        )
        c, ct = compiled(multi, u, t, h, i32(n_small))
        st, (_, _, enorm) = slope_time(
            c, lambda n: (u, t, h, i32(n)), n_small, n_big, args.repeats
        )
        assert np.isfinite(float(enorm)), "benchmark step diverged"
        result["fixed"] = dict(value=dof / st, step_s=st, compile_s=ct,
                               enorm=float(enorm))

    def chunk_figure(nm, u0, h0, max_attempts, spinup=0):
        chunk, _ = make_adaptive_chunk_fn(
            ops, nm, atol=0.01, rtol=1e-6, max_attempts=max_attempts,
        )
        c, ct = compiled(chunk, u0, t, h0, 1e30, i32(n_small))
        if spinup:
            # untimed ON-DEVICE spin-up from a SMALL h: settles the
            # synthetic state onto the dynamics' own rough manifold so
            # the timed regime is the sustained stiff one
            u0 = c(u0, t, jnp.asarray(1e-3), 1e30, i32(spinup))[0]
        st, out = slope_time(
            c, lambda n: (u0, t, h0, 1e30, i32(n)), n_small, n_big,
            args.repeats,
        )
        k, att, rej = int(out[3]), int(out[4]), bool(out[5])
        assert k == n_big and not rej, (k, att, rej)
        return dict(value=dof / st, step_s=st, compile_s=ct,
                    attempts_per_accept=att / k)

    if "adaptive" in figures:
        # dt_max pinned to the bench h: every accept runs at the same h
        # on the smooth bench state, while the chunk pays its full
        # production machinery per step
        result["adaptive"] = chunk_figure(
            dataclasses.replace(numerics, dt_max=float(args.dt)), u, h,
            4 * (args.steps + 4),
        )
    if "stiff" in figures:
        result["stiff"] = chunk_figure(
            dataclasses.replace(numerics, dt_max=float(args.stiff_h)),
            jnp.asarray(_rough_state(grid, ps)), jnp.asarray(args.stiff_h),
            8 * (args.steps + 4), spinup=64,
        )
        assert result["stiff"]["attempts_per_accept"] > 1.0, (
            "stiff bench state did not engage the escalation tiers"
        )
    head = result.get("fixed") or next(
        result[f] for f in ("adaptive", "stiff") if f in result
    )
    result["vs_baseline"] = head["value"] / BASELINE_DOF_UPDATES_PER_SEC
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
