#!/usr/bin/env python3
"""Numerics-configuration smoke matrix.

Integrates 3 implicit steps of the manufactured 1D problem under
every supported combination of stepper / linear solver /
preconditioner / loop mode / precision and reports OK, BAD
(non-finite or short), or CRASH per configuration.  The kind of
cross-option interaction bug this catches: the fused adaptive chunk
arming a robust-fallback retry that does not exist for non-richardson
ksp_types (fixed in f419ecd after a review found it — this sweep
would have caught it earlier).

Intended as an occasional robustness sweep, not a CI test: the full
matrix compiles ~50 configurations and takes ~30-75 min on CPU.

    KSFD_PLATFORM=cpu python tools/smoke_matrix.py [--quick]
"""

import argparse
import itertools
import os
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))
sys.path.insert(
    0, os.path.join(os.path.dirname(__file__), os.pardir, "tests")
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="ts_type x ksp_type grid only")
    ap.add_argument("--nx", type=int, default=32)
    args = ap.parse_args(argv)

    import numpy as np
    import jax.numpy as jnp

    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import Solver
    from manufactured import make_problem, exact_state

    ps, grid, ops = make_problem(nx=args.nx)
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))

    cases = []
    for ts in ("rosw", "arkimex", "ark436", "beuler"):
        for ksp in ("richardson", "chebyshev", "gmres", "gmres_scipy",
                    "gmres_rolled", "gmres_restarted", "dense",
                    "banded", "lu"):
            cases.append(dict(ts_type=ts, ksp_type=ksp))
    if not args.quick:
        for ksp in ("richardson", "chebyshev", "gmres_rolled", "gmres"):
            cases.append(dict(ksp_type=ksp, device_loop=True))
        cases.append(dict(device_loop=True, esc_cheb=False))
        cases.append(dict(device_loop=True, ksp_iters_max2=0))
        for pc in ("block", "spectral", "none"):
            cases.append(dict(pc_type=pc))
            cases.append(dict(pc_type=pc, ksp_type="gmres_scipy"))
        cases += [
            dict(precision="float32"),
            dict(precision="float32", device_loop=True),
            dict(adapt_type="none"),
            dict(adapt_type="none", ts_type="arkimex"),
            dict(sweep_dtype="float64"),
            dict(stage_delta=True),
            dict(stage_delta=True, device_loop=True),
            dict(pc_fft="on"),
            dict(pc_fft="on", ksp_type="gmres_scipy"),
            dict(ts_type="arkimex", device_loop=True),
            dict(ts_type="beuler", device_loop=True),
            dict(ts_type="ark436", device_loop=True),
        ]

    # combinations the library REJECTS by design, with a clear message
    expected_reject = [
        dict(ts_type="arkimex", ksp_type="banded"),
        dict(ts_type="ark436", ksp_type="banded"),
        dict(ts_type="arkimex", ksp_type="lu"),
        dict(ts_type="ark436", ksp_type="lu"),
    ]

    fails = []
    for kw in cases:
        tag = ",".join("%s=%s" % kv for kv in sorted(kw.items()))
        try:
            nm = NumericsOptions(**kw)
            s = Solver(ops, nm, t0=0.0, dt=1.0, tmax=1e9, maxsteps=3,
                       rtol=1e-6, atol=0.01)
            u = np.asarray(s.solve(u0))
            ok = np.isfinite(u).all() and s.k == 3
            print("%-60s %s k=%d fails=%d"
                  % (tag, "OK " if ok else "BAD", s.k, s.snes_failures),
                  flush=True)
            if not ok:
                fails.append((tag, "non-finite state or short run"))
            if kw in expected_reject:
                fails.append((tag, "expected a rejection but ran"))
        except ValueError as e:
            if kw in expected_reject:
                print("%-60s OK (rejected: %s)" % (tag, e), flush=True)
            else:
                print("%-60s CRASH %s" % (tag, e), flush=True)
                fails.append((tag, str(e)))
        except Exception as e:
            print("%-60s CRASH %s" % (tag, e), flush=True)
            traceback.print_exc()
            fails.append((tag, str(e)))

    print("\n%d/%d failed" % (len(fails), len(cases)))
    for t, e in fails:
        print("  FAIL", t, "->", e[:120])
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
