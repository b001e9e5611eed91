#!/usr/bin/env python3
"""Smoke test of the solver's main path on an NVIDIA GPU.

    python chip_smoke.py            # one card, every default phase
    python chip_smoke.py --multi    # four cards: the sharded path only

Default phases, in order (any failure exits non-zero):

1. environment: device, card name and power limit, package versions,
   XLA_FLAGS and the compile-cache directory;
2. oracle gates: the options93 manufactured-solution error
   (tools/validate.py) and the options92 adaptive run
   (ksfdsolver.py @examples/eigenmode1d);
3. PDEOperators.rhs_delta against the float64 difference of two RHS
   evaluations at 1536^2 x 3, on a rough and a near-uniform state;
4. the flagship deployment, ksfdsolver.py @examples/aggregation2d
   --numerics -device_loop 1 -stage_delta 1 -- at 1536^2 x 3 for a
   few dozen steps (stage-delta is off by default; this keeps its
   path exercised on the card);
5. a few steps of @examples/aggregation3d and of a 4-member
   --ensemble of @examples/hexagons2d.

sympy is required.  Without h5py (an optional package: only --save,
--check and series readers need it) the runs above skip --save and
--check, and the environment line says so.

Every phase runs in this one process, so one process holds the card.
The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}; it is printed
only when every phase passed on a GPU.  Outputs (series, checkpoints,
derived options files) go to --out.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: options93 relative error recorded for the manufactured gate, to the
#: three significant digits it was recorded with
OPTIONS93_REL_ERR = 6.18e-5
#: rhs_delta error bounds, relative to max |increment|: rough states,
#: near-uniform states (tests/test_operators.py uses the same)
DELTA_BOUNDS = {"rough": 3e-6, "near_uniform": 1e-6}


def log(*a):
    print("chip_smoke:", *a, flush=True)


def nvidia_smi_lines(indices=None):
    """`name, power.limit` of the cards (those at ``indices``, else
    all) as nvidia-smi reports them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()
    return lines if indices is None else [lines[i] for i in indices]


def derived_options(src, dst, drop=(), **params):
    """Write options file ``src`` to ``dst`` with the ``name=`` lines
    of ``params`` replaced (appended when absent) and lines starting
    with any prefix in ``drop`` removed.  Returns '@dst'."""
    lines = []
    for ln in open(src).read().splitlines():
        key = ln.split("=", 1)[0]
        if key in params or any(ln.startswith(p) for p in drop):
            continue
        lines.append(ln)
    # parameters go before the numerics block
    at = next(
        (i for i, ln in enumerate(lines)
         if ln.startswith(("--numerics", "--petsc"))),
        len(lines),
    )
    lines[at:at] = ["%s=%s" % kv for kv in params.items()]
    with open(dst, "w") as f:
        f.write("\n".join(lines) + "\n")
    return "@" + dst


class CompileClock:
    """Sums XLA's compile and compile-cache load durations while
    active (tracing, which nests, is not counted)."""

    EVENTS = (
        "/jax/core/compile/backend_compile_duration",
        "/jax/compilation_cache/cache_retrieval_time_sec",
    )

    def __init__(self):
        self.seconds = 0.0

    def _listen(self, event, duration, **kw):
        if event in self.EVENTS:
            self.seconds += duration

    def __enter__(self):
        import jax

        jax.monitoring.register_event_duration_secs_listener(self._listen)
        return self

    def __exit__(self, *exc):
        import jax

        jax.monitoring.unregister_event_duration_listener(self._listen)


def run_cli(argv):
    """ksfdsolver.run in this process; returns the solver, raising on
    a non-zero status."""
    import ksfdsolver

    log("ksfdsolver.py " + " ".join(argv))
    status, solver = ksfdsolver.run(argv)
    if status != 0:
        raise RuntimeError("ksfdsolver exited with status %d" % status)
    return solver


# ---------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------

def phase_env():
    """Log the environment; returns it as a dict (h5py: whether series
    can be written)."""
    import importlib

    import jax

    vers = {}
    for mod in ("jax", "jaxlib", "numpy", "scipy", "sympy", "h5py"):
        try:
            vers[mod] = importlib.import_module(mod).__version__
        except ImportError as e:
            if mod == "h5py":
                vers[mod] = "not installed: runs skip --save/--check"
                continue
            raise RuntimeError(
                "package %s is not installed (%s)" % (mod, e)
            )
    import ksfd_tpu  # noqa: F401  (places the compile cache)

    devs = jax.devices()
    info = dict(
        platform=devs[0].platform, device_kind=devs[0].device_kind,
        count=len(devs), versions=vers,
        XLA_FLAGS=os.environ.get("XLA_FLAGS", ""),
        compile_cache=jax.config.jax_compilation_cache_dir,
    )
    log("env", json.dumps(info))
    info["h5py"] = not vers["h5py"].startswith("not installed")
    return info


def phase_gates(out, validate_steps=2080, eigen_tmax=None, persist=True):
    """options93 manufactured error and the options92 adaptive run
    (persist: also --save the run)."""
    import numpy as np

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import validate

    r = validate.gate(steps=validate_steps)
    log("options93: steps=%d rel_err=%.6e (limit %.2e) wall=%.2fs"
        % (r["steps"], r["rel_err"], OPTIONS93_REL_ERR, r["wall"]))
    if validate_steps == 2080 and not (
        float("%.3g" % r["rel_err"]) <= OPTIONS93_REL_ERR
    ):
        raise AssertionError("options93 gate: rel_err %.6e > %.2e"
                             % (r["rel_err"], OPTIONS93_REL_ERR))
    params = {} if eigen_tmax is None else {"tmax": eigen_tmax}
    opt = derived_options(
        os.path.join(HERE, "examples", "eigenmode1d"),
        os.path.join(out, "eigenmode1d.opts"), drop=("--save",), **params
    )
    s = run_cli(
        [opt] + (["--save=" + os.path.join(out, "eigenmode1d")]
                 if persist else [])
    )
    rho = np.asarray(s.u[0])
    above = rho > rho.mean()
    peaks = int((np.diff(np.r_[above, above[0]].astype(int)) == 1).sum())
    log("options92: steps=%d t=%.6g h=%.4g peaks=%d rho=[%.1f, %.1f] "
        "failures=%d" % (s.k, s.t, s.h, peaks, rho.min(), rho.max(),
                         s.snes_failures))
    checks = dict(
        reached_tmax=s.t >= s.tmax,
        steps=100 <= s.k <= 500,
        peaks=peaks == 4,
        rho_min=200.0 < rho.min() < 600.0,
        rho_max=20000.0 < rho.max() < 28000.0,
        ligands_positive=float(np.min(np.asarray(s.u[1:]))) > 0.0,
    )
    if eigen_tmax is None:
        # full run: the step size must have grown to dt_max scale
        checks["h_grew"] = s.h > 2000.0
        bad = [k for k, v in checks.items() if not v]
        if bad:
            raise AssertionError("options92 gate failed: %s" % bad)
    return r, s


def near_uniform_state(grid):
    """Fields ~1e4 with ~1-amplitude structure (float32 quantization of
    the state itself dominates there)."""
    import numpy as np

    n = grid.Sshape[0]
    wave = np.sin(2 * np.pi * np.arange(n) / n).reshape(
        (n,) + (1,) * (grid.dim - 1)
    ) * np.ones(grid.Sshape)
    return np.stack([9000 + wave, 6162 + 0.7 * wave, 797 + 0.1 * wave])


def phase_delta(nx=1536):
    """rhs_delta against the f64 difference of two full RHS evaluations,
    on bench._rough_state and a near-uniform wave; returns the
    measured ratios max|error| / max|increment|."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import __graft_entry__ as ge
    import bench

    ps, grid, ops = ge._make_problem(nx, nx)
    rng = np.random.default_rng(3)
    delta = jax.jit(ops.rhs_delta)
    ref_fn = jax.jit(lambda u1, u0: ops.rhs(u1, 0.5) - ops.rhs(u0, 0.5))
    ratios = {}
    for name, u0, scale in (
        ("rough", bench._rough_state(grid, ps), 100.0),
        ("near_uniform", near_uniform_state(grid), 1e-3),
    ):
        u0 = ops.groom(jnp.asarray(u0))
        u1 = ops.groom(u0 + scale * rng.standard_normal(grid.Vshape))
        ref = ref_fn(u1, u0)
        out = delta(u0, u1 - u0, u1, 0.5)
        ratio = float(jnp.max(jnp.abs(out - ref)) / jnp.max(jnp.abs(ref)))
        ratios[name] = ratio
        log("delta %s %dx%d: err/increment = %.3e (bound %.0e)"
            % (name, nx, nx, ratio, DELTA_BOUNDS[name]))
    bad = {k: v for k, v in ratios.items() if not v < DELTA_BOUNDS[k]}
    if bad:
        raise AssertionError("rhs_delta outside its bounds: %s" % bad)
    return ratios


def phase_flagship(out, steps=40, nelements=None, persist=True):
    """aggregation2d through the CLI with the device-fused chunk and
    stage-delta (persist: with --save and --check)."""
    import jax
    import jax.numpy as jnp

    params = dict(maxsteps=steps)
    if nelements is not None:
        params["nelements"] = nelements
    opt = derived_options(
        os.path.join(HERE, "examples", "aggregation2d"),
        os.path.join(out, "aggregation2d.opts"),
        drop=("--save", "--check"), **params
    )
    t0 = time.perf_counter()
    with CompileClock() as cc:
        s = run_cli(
            [opt]
            + ([
                "--save=" + os.path.join(out, "aggregation2d"),
                "--check=" + os.path.join(out, "aggregation2d_cp"),
            ] if persist else [])
            + ["--numerics", "-device_loop", "1", "-stage_delta", "1",
               "--"]
        )
    wall = time.perf_counter() - t0
    info = s.build_info
    finite = bool(jnp.all(jnp.isfinite(s.u)))
    log("aggregation2d %s: k=%d t=%.6g h=%.4g finite=%s build=%s"
        % ("x".join(map(str, s.ops.grid.Sshape)), s.k, s.t, s.h, finite,
           json.dumps(info)))
    if not (finite and s.k == steps and not s.diverged):
        raise AssertionError("flagship run: k=%d finite=%s diverged=%s"
                             % (s.k, finite, s.diverged))
    if not (info.get("mixed32") and info.get("delta")):
        raise AssertionError("flagship numerics not engaged: %s" % info)
    compiled = s.step_fn.lower(
        s.u, jnp.asarray(s.t), jnp.asarray(s.h)
    ).compile()
    card = jax.devices()[0].device_kind
    log("aggregation2d step memory_analysis on %s: %s"
        % (card, compiled.memory_analysis()))
    log("aggregation2d on %s: %d steps, wall %.2fs, of which XLA "
        "compile %.2fs, the rest %.2fs" % (card, s.k, wall, cc.seconds,
                                          wall - cc.seconds))
    return s


def phase_3d_ensemble(out, steps=3, n3d=None, nens=None, members=4,
                      persist=True):
    """A few steps of aggregation3d and of a hexagons2d ensemble."""
    import jax.numpy as jnp
    import numpy as np

    p3 = dict(maxsteps=steps)
    if n3d is not None:
        p3["nelements"] = n3d
    s = run_cli(
        [derived_options(os.path.join(HERE, "examples", "aggregation3d"),
                         os.path.join(out, "aggregation3d.opts"),
                         drop=("--save",), **p3)]
        + (["--save=" + os.path.join(out, "aggregation3d")]
           if persist else [])
    )
    ok3 = bool(jnp.all(jnp.isfinite(s.u))) and s.k == steps
    log("aggregation3d %s: k=%d finite=%s build=%s"
        % ("x".join(map(str, s.ops.grid.Sshape)), s.k, ok3,
           json.dumps(s.build_info)))
    pe = dict(maxsteps=steps)
    if nens is not None:
        pe["nelements"] = nens
    es = run_cli([
        derived_options(os.path.join(HERE, "examples", "hexagons2d"),
                        os.path.join(out, "hexagons2d.opts"),
                        drop=("--save",), **pe),
        "--ensemble=%d" % members,
    ])
    ks = np.asarray(es.ks)
    oke = bool(jnp.all(jnp.isfinite(es.u))) and bool((ks == steps).all())
    log("hexagons2d ensemble %s: ks=%s finite=%s"
        % (tuple(es.u.shape), ks.tolist(), oke))
    if not (ok3 and oke):
        raise AssertionError("3D ok=%s, ensemble ok=%s" % (ok3, oke))


def result_line(devices):
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    ap.add_argument("--out", default=os.path.join(HERE, "chiprun_out",
                                                  "chip_smoke"),
                    help="directory for series, checkpoints and options")
    args = ap.parse_args(argv)
    ncards = 4 if args.multi else 1
    # one card unless --multi: pin the visible set before JAX starts
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (
        [c for c in visible.split(",") if c] if visible
        else [str(i) for i in range(ncards)]
    )[:ncards]
    os.environ["CUDA_VISIBLE_DEVICES"] = ",".join(cards)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        log("no GPU: JAX's default platform is %r" % devices[0].platform)
        return 2
    if len(devices) != ncards:
        log("need %d GPU(s), JAX sees %d" % (ncards, len(devices)))
        return 2
    sys.path.insert(0, HERE)
    os.makedirs(args.out, exist_ok=True)
    persist = phase_env()["h5py"]
    for line in nvidia_smi_lines([int(c) for c in cards]
                                 if all(c.isdigit() for c in cards)
                                 else None):
        print(line, flush=True)
    if args.multi:
        import __graft_entry__ as ge

        ge.multichip_check(devices, nelements=1536, out=args.out)
    else:
        for name, fn in (
            ("gates", lambda: phase_gates(args.out, persist=persist)),
            ("delta", phase_delta),
            ("flagship", lambda: phase_flagship(args.out,
                                                persist=persist)),
            ("3d+ensemble", lambda: phase_3d_ensemble(args.out,
                                                      persist=persist)),
        ):
            t0 = time.perf_counter()
            fn()
            log("phase %s passed in %.1fs" % (name, time.perf_counter() - t0))
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
