#!/usr/bin/env python3
"""Probe the h-gap: stage-solve strength vs step size on a ROUGH state.

VERDICT r4 #1: the aggregated phase pins accepted h at 0.5-4 because
the embedded error is SOLVE-limited (16-sweep-stiff, CFL headroom
~25x unused), so the 850x per-step win collapses to ~23x end-to-end
against the reference's exact-LU stepping.  This probe measures, on
the stored rough aggregation2d state (solutions/agg2d_r4, t~5.5e4,
1536^2x3), the embedded error enorm(h) for a ladder of h under each
candidate stage solver — richardson-16 (the r4 escalated tier) vs
Chebyshev-accelerated tiers — plus honest slope-timed ms/step, to
pick the escalation-tier defaults.

enorm <= 1 means the controller would ACCEPT the step: the h where a
tier's curve crosses 1 is the h that tier can sustain.

Timing discipline per CLAUDE.md: chained work inside one jit
(multistep), host-transfer fence, slope timing, perturbed inputs.
RUN ALONE on the card.

Usage: python tools/probe_hgap.py [--prefix solutions/agg2d_r4]
       [--hs 1,2,4,8,16,32] [--iters ...] [--time]
"""

import argparse
import dataclasses
import os
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--prefix", default="solutions/agg2d_r4")
    ap.add_argument("--hs", default="1,2,4,8,16,32,64")
    ap.add_argument(
        "--configs",
        default="rich3,rich16,cheb16,cheb24,cheb32,cheb48,rich48",
    )
    ap.add_argument("--cheb-lmax", type=float, default=None)
    ap.add_argument("--cheb-safety", type=float, default=None)
    ap.add_argument("--time", action="store_true",
                    help="also slope-time ms/step per config")
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)

    import jax
    import jax.numpy as jnp

    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.io.solution import Solution
    from ksfd_tpu.solvers import make_multistep_fn, make_step_fn

    sol = Solution(args.prefix)
    u = jnp.asarray(sol.images(sol.tmax))
    ops = sol.derivatives
    t0 = float(sol.tmax)
    print(
        "platform=%s state=%s t=%.6g shape=%s rho=[%.3g, %.3g]"
        % (
            jax.devices()[0].platform, args.prefix, t0,
            u.shape, float(u[0].min()), float(u[0].max()),
        ),
        flush=True,
    )
    # gate tolerances of examples/aggregation2d
    atol, rtol = 0.01, 1e-6
    hs = [float(x) for x in args.hs.split(",")]

    def make_nm(tag):
        kind = "chebyshev" if tag.startswith("cheb") else "richardson"
        iters = int(tag[4:])
        nm = NumericsOptions(ksp_type=kind, ksp_iters=iters)
        if args.cheb_lmax is not None:
            nm = dataclasses.replace(nm, cheb_lmax=args.cheb_lmax)
        if args.cheb_safety is not None:
            nm = dataclasses.replace(nm, cheb_safety=args.cheb_safety)
        return nm

    configs = [c.strip() for c in args.configs.split(",") if c.strip()]
    print("enorm(h) per solver tier (<=1 accepts):", flush=True)
    hdr = "  %-8s" + " %9.3g" * len(hs)
    print(hdr % tuple(["tier"] + hs), flush=True)
    for tag in configs:
        nm = make_nm(tag)
        step, _ = make_step_fn(ops, nm, atol=atol, rtol=rtol)
        row = []
        for h in hs:
            _, enorm = step(u, jnp.asarray(t0), jnp.asarray(h))
            row.append(float(enorm))
        print(("  %-8s" + " %9.3g" * len(hs)) % tuple([tag] + row),
              flush=True)

    if args.time:
        print("slope-timed ms/step (chained multistep, h=2):",
              flush=True)
        for tag in configs:
            nm = make_nm(tag)
            multi, _ = make_multistep_fn(
                ops, nm, atol=atol, rtol=rtol, static_steps=False
            )
            fence = lambda a, e: float(a[0, 0, 0]) + float(e)
            h = jnp.asarray(2.0)
            ts = jnp.asarray(t0)
            for nst in (2, 10):
                u1, _, e1 = multi(u, ts, h, nst)
                fence(u1, e1)
            times = {}
            for nst, pert in ((2, 1e-9), (10, 2e-9)):
                up = u * (1.0 + pert)
                fence(up, 0.0)
                tic = time.perf_counter()
                u1, _, e1 = multi(up, ts, h, nst)
                fence(u1, e1)
                times[nst] = time.perf_counter() - tic
            ms = (times[10] - times[2]) / 8 * 1e3
            print("  %-8s %8.2f ms/step" % (tag, ms), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
