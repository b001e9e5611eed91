#!/usr/bin/env python3
"""Per-component profile of the implicit step on a GPU.

Slope-times the fused ROS34PW2 step (the bench.py workload) and its
hot components on the default device: the block pc apply, the f32 W
apply of the sweep chain, PDEOperators.rhs_delta and the f64 RHS.

With --xprof DIR it also traces a window of fused steps with
jax.profiler, writes the optimized HLO beside the trace, and reduces
the trace to per-kernel device time joined with each fusion's bytes
(operands + result, from the HLO): achieved bandwidth and its share of
the card's HBM peak (PEAK_HBM, keyed by device_kind).

Usage:  python tools/profile_step.py [--nx 1536] [--xprof DIR]
"""

import argparse
import collections
import glob
import os
import re
import sys
import time

#: HBM bandwidth by device_kind (NVIDIA H100 SXM data sheet).
PEAK_HBM = {"NVIDIA H100 80GB HBM3": 3.35e12}

_DT_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4,
             "pred": 1, "s8": 1, "u8": 1, "s64": 8, "u64": 8, "c64": 8,
             "c128": 16}


def _shape_bytes(text):
    """Total bytes of every dtype[dims] shape in an HLO fragment."""
    total = 0
    for dt, dims in re.findall(r"\b([a-z]+[0-9]*)\[([0-9,]*)\]", text):
        if dt not in _DT_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DT_BYTES[dt]
    return total


def hlo_bytes(hlo_text):
    """{instruction name: bytes of its result + operands} for every
    fusion, custom call, copy or dot — the instructions that become
    device kernels.  Operand shapes come from their definitions (the
    optimized HLO prints operands by name only)."""
    define = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(\S+)\s")
    kernel = re.compile(
        r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=\s*(.*?)\s"
        r"(?:fusion|custom-call|copy|dot|convolution)\((.*)$"
    )
    shape = {}
    for line in hlo_text.splitlines():
        m = define.match(line)
        if m:
            shape[m.group(1)] = _shape_bytes(m.group(2))
    out = {}
    for line in hlo_text.splitlines():
        m = kernel.match(line)
        if not m:
            continue
        name, result, rest = m.groups()
        operands = re.findall(r"%([\w.\-]+)", rest.split(")", 1)[0])
        out[name] = _shape_bytes(result) + sum(
            shape.get(o, 0) for o in operands
        )
    return out


def _norm(name):
    return name.lstrip("%").replace(".", "_").replace("-", "_")


def reduce_trace(xdir, hlo_text, window_s, device_kind):
    """Print per-kernel device time, bytes, GB/s and HBM share."""
    import jax

    paths = sorted(glob.glob(os.path.join(
        xdir, "plugins", "profile", "*", "*.xplane.pb")))
    pd = jax.profiler.ProfileData.from_file(paths[-1])
    nbytes = {_norm(k): v for k, v in hlo_bytes(hlo_text).items()}
    dur = collections.Counter()
    count = collections.Counter()
    busy = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                dur[ev.name] += ev.duration_ns
                count[ev.name] += 1
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    union, end = 0, None
    for a, b in busy:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    total = sum(dur.values())
    peak = PEAK_HBM.get(device_kind)
    print("trace: %d kernel names, %.3f ms summed device time, busy "
          "%.3f ms of a %.3f ms window"
          % (len(dur), total / 1e6, union / 1e6, window_s * 1e3))
    print("%-44s %6s %10s %10s %8s %6s" % (
        "kernel", "calls", "ms", "MB/call", "GB/s", "HBM%"))
    hbm_time = hbm_ideal = 0.0
    for name, ns in dur.most_common(25):
        b = nbytes.get(_norm(name.split(":")[0].strip()))
        calls = count[name]
        if b:
            rate = b * calls / (ns * 1e-9)
            share = rate / peak if peak else float("nan")
            hbm_time += ns
            hbm_ideal += b * calls / peak * 1e9 if peak else 0.0
            print("%-44s %6d %10.3f %10.2f %8.0f %6.1f" % (
                name[:44], calls, ns / 1e6, b / 1e6, rate / 1e9,
                100 * share))
        else:
            print("%-44s %6d %10.3f %10s" % (name[:44], calls, ns / 1e6,
                                             "?"))
    if hbm_time:
        print("matched kernels: %.1f%% of device time; their HBM-bound "
              "time is %.1f%% of their measured time"
              % (100 * hbm_time / total, 100 * hbm_ideal / hbm_time))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=1536)
    ap.add_argument("--ksp-iters", type=int, default=None)
    ap.add_argument("--xprof", metavar="DIR",
                    help="trace a window of fused steps into DIR")
    args = ap.parse_args(argv)

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)

    import dataclasses

    import jax
    import jax.numpy as jnp

    import __graft_entry__ as ge
    from ksfd_tpu import NumericsOptions
    from ksfd_tpu.solvers import make_multistep_fn
    from ksfd_tpu.solvers.linalg import BlockSpectralPreconditioner

    dev = jax.devices()[0]
    nx = args.nx
    ps, grid, ops = ge._make_problem(nx, nx)
    u = jnp.asarray(ge._initial_state(grid))
    t0s = jnp.asarray(0.0)
    h = jnp.asarray(1.0)
    print("platform=%s kind=%s count=%d grid=%dx%d dofs=%d"
          % (dev.platform, dev.device_kind, len(jax.devices()), nx, nx,
             u.shape[0]), flush=True)
    base = NumericsOptions()
    if args.ksp_iters is not None:
        base = dataclasses.replace(base, ksp_iters=args.ksp_iters)
    i32 = lambda n: jnp.asarray(n, jnp.int32)

    def timed(fn, *a):
        jax.block_until_ready(a)
        tic = time.perf_counter()
        jax.block_until_ready(fn(*a))
        return time.perf_counter() - tic

    def slope_step(numerics, tag, n_small=2, n_big=12):
        multi, _ = make_multistep_fn(
            ops, numerics, atol=0.01, rtol=1e-6, static_steps=False
        )
        c = multi.lower(u, t0s, h, i32(n_small)).compile()
        ts = {n: min(timed(c, u, t0s, h, i32(n)) for _ in range(3))
              for n in (n_small, n_big)}
        ms = (ts[n_big] - ts[n_small]) / (n_big - n_small) * 1e3
        print("  %-36s %8.3f ms/step" % (tag, ms), flush=True)
        return c

    def slope_apply(fn, v0, tag, n_small=5, n_big=45):
        """Chained unary-operator timing: v <- fn(v)*0.999."""
        cj = jax.jit(lambda v, n: jax.lax.fori_loop(
            0, n, lambda i, v: fn(v) * 0.999, v))
        c = cj.lower(v0, i32(n_small)).compile()
        ts = {n: min(timed(c, v0, i32(n)) for _ in range(3))
              for n in (n_small, n_big)}
        us = (ts[n_big] - ts[n_small]) / (n_big - n_small) * 1e6
        print("  %-36s %8.1f us/apply" % (tag, us), flush=True)

    print("full step (fused multistep):", flush=True)
    c_default = slope_step(base, "default (iters=%d)" % base.ksp_iters)
    slope_step(dataclasses.replace(base, ksp_iters=1), "iters=1 (intercept)")
    slope_step(dataclasses.replace(base, stage_delta=True), "stage_delta on")

    print("components:", flush=True)
    nf = ops.nligands + 1
    means = [jnp.mean(u[i]) for i in range(nf)]
    dG0 = ops._dG_fns[0](*[u[i] for i in range(nf)], 0.0)
    rho_diff = jnp.max(u[0] * dG0)
    v0 = (u * 1e-3).astype(jnp.float32)
    pc = BlockSpectralPreconditioner(grid, ops, compute_dtype="float32")
    slope_apply(
        lambda v: pc.apply_linearized(v, 2.29, 0.0, means,
                                      rho_diff=rho_diff),
        v0, "block pc apply f32",
    )
    _, jvp32 = jax.linearize(lambda uu: ops.rhs(uu, 0.0),
                             u.astype(jnp.float32))
    slope_apply(lambda v: 2.29 * v - jvp32(v), v0, "f32 W apply")
    slope_apply(
        lambda v: ops.rhs_delta(
            u, v.astype(u.dtype), u + v.astype(u.dtype), 0.0
        ),
        v0, "rhs_delta (stage RHS incr)",
    )
    slope_apply(
        lambda v: (v + ops.rhs(u + v.astype(u.dtype), 0.0)
                   .astype(jnp.float32)),
        v0, "f64 RHS",
    )

    if args.xprof:
        os.makedirs(args.xprof, exist_ok=True)
        hlo = c_default.as_text()
        with open(os.path.join(args.xprof, "step.hlo.txt"), "w") as f:
            f.write(hlo)
        n = 6
        jax.block_until_ready(c_default(u, t0s, h, i32(n)))
        tic = time.perf_counter()
        with jax.profiler.trace(args.xprof):
            jax.block_until_ready(c_default(u, t0s, h, i32(n)))
        window = time.perf_counter() - tic
        print("traced %d fused steps into %s" % (n, args.xprof))
        reduce_trace(args.xprof, hlo, window, dev.device_kind)
    return 0


if __name__ == "__main__":
    sys.exit(main())
