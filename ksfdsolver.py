#!/usr/bin/env python3
"""Solve the Keller-Segel PDE system with ksfd_tpu (GPU or CPU).

The counterpart of the reference driver
(/root/reference/ksfdsolver2.py:1-784).  The command-line grammar is
the same three languages (ksfdsolver2.py:33-52):

- options ``--name=value`` controlling how to solve (save/check/
  resume/restart/seed/onestep/showparams/source/cappotential/...),
- parameters ``name=value`` with sympy-expression values describing
  the problem (users may invent new parameters; dependencies are
  resolved by topological sort),
- a numerics block choosing the method: ``--numerics ... --`` (native)
  or ``--petsc ... --`` (reference options files run unchanged; the
  meaningful -ts_*/-ksp_* entries are translated, the rest ignored).

Plus ``@optionsfile`` indirection with '#' comments.

Examples:
    python ksfdsolver.py @options92
    python ksfdsolver.py dim=2 nelements=256 --save=solutions/run1
"""

import sys

import numpy as np

from ksfd_tpu import (
    Grid,
    KSFDException,
    Parser,
    SolutionParameters,
    decode_numerics,
)
from ksfd_tpu.ops import PDEOperators, SpatialExpression
from ksfd_tpu.solvers import Solver, print_monitor
from ksfd_tpu.io import TimeSeries, make_save_monitor, make_checkpoint_monitor, write_info
from ksfd_tpu.ic import initial_values
from ksfd_tpu.randomfield import Generator
from ksfd_tpu.utils import find_duplicates
from ksfd_tpu.utils.debug import logger

logMAIN = logger("MAIN")


def parse_commandline(args=None):
    parser = Parser(description="Solve Keller-Segel PDEs")
    parser.add_argument("--cappotential", choices=["tophat", "witch"],
                        default="tophat",
                        help="potential function for capping rho")
    parser.add_argument("--save",
                        help="filename prefix in which to save results")
    parser.add_argument("--save_every", type=int, default=1,
                        help="minimum steps between saved snapshots "
                             "(default 1 = every accepted step; the "
                             "final state is always saved)")
    parser.add_argument("--check", help="filename prefix for checkpoints")
    parser.add_argument("--resume",
                        help="resume from last point of a TimeSeries")
    parser.add_argument("--restart",
                        help="restart (t=t0) from last point of a TimeSeries")
    parser.add_argument("--series_retries", type=int, default=0,
                        help="# retries to open TimeSeries")
    parser.add_argument("--series_retry_interval", type=int, default=60,
                        help="time (s) between open retries")
    parser.add_argument("--mpiok", action="store_true",
                        help="accepted for compatibility.  Multi-"
                             "process runs always write per-rank slab "
                             "files AND any single-process reader "
                             "(Solution, tools, resume) opens the "
                             "complete slab set as one logical series "
                             "(the virtual slab view) — the working "
                             "equivalent of the reference's broken "
                             "parallel-HDF5 mode")
    parser.add_argument("--showparams", action="store_true",
                        help="print all parameters and exit")
    parser.add_argument("--noperiodic", action="store_true",
                        help="not implemented: only periodic BCs exist")
    parser.add_argument("--onestep", action="store_true",
                        help="exit after one step (pre-compile check)")
    parser.add_argument("--solver", help="accepted for compat")
    parser.add_argument("--seed", type=int, default=793817931,
                        help="random number generator seed")
    parser.add_argument("--source", type=str, action="append", default=[],
                        help="source function for rho, U_1_1, ...")
    parser.add_argument("--flux_form", action="store_true",
                        help="use the exactly-conservative flux discretization"
                             " of div(rho grad G) instead of the reference's"
                             " product-rule form")
    parser.add_argument("--with_g", action="store_true",
                        help="carry the free energy G as an extra stored"
                             " field (the reference's _with_G variant)")
    parser.add_argument("--xprof", metavar="DIR",
                        help="write a JAX profiler (xplane) trace of the"
                             " solve to DIR")
    parser.add_argument("--ensemble", type=int, default=0, metavar="N",
                        help="integrate N ensemble members (fresh starts"
                             " with per-member IC seeds seed..seed+N-1 and"
                             " independent noise chains) as ONE vmapped"
                             " program; members save to <save>_m<i>")
    parser.add_argument("params", type=str, nargs="*",
                        help="parameter values (name=value, sympy exprs)")
    return parser.parse_args(args=args)


def catch_signals():
    """Convert catchable signals to KeyboardInterrupt so files close.

    Reference: ksfdsolver2.py:433-471.
    """
    import signal as sig

    def handler(signum, frame):
        raise KeyboardInterrupt("Caught signal " + str(signum))

    for name in (
        "SIGHUP", "SIGINT", "SIGPIPE", "SIGALRM", "SIGTERM", "SIGXCPU",
        "SIGXFSZ", "SIGVTALRM", "SIGPROF", "SIGUSR1", "SIGUSR2", "SIGQUIT",
    ):
        try:
            sig.signal(getattr(sig, name), handler)
        except (OSError, ValueError, AttributeError):
            pass


def decode_sources(sargs, ps, grid):
    """--source=<field>=<expr> list -> per-field SpatialExpressions.

    Reference: ksfdsolver2.py:473-498.
    """
    sources = [0.0] * (ps.nligands + 1)
    keys = [arg.split("=", maxsplit=1)[0] for arg in sargs]
    dups = find_duplicates(keys)
    if dups:
        raise KSFDException("duplicated sources: " + ", ".join(dups))
    names = ["rho"] + [lig.name() for lig in ps.groups.ligands()]
    for k in keys:
        if k not in names:
            raise KSFDException("unknown function: " + k)
    for name in keys:
        snum = keys.index(name)
        fnum = names.index(name)
        _, val = sargs[snum].split("=", maxsplit=1)
        sources[fnum] = SpatialExpression(ps, grid, val, name="src_" + name)
    return [
        s if isinstance(s, SpatialExpression)
        else SpatialExpression(ps, grid, s)
        for s in sources
    ]


def build(clargs):
    """(ps, grid, numerics, sources) of a parsed command line; seeds
    the initial-condition generator."""
    ps = SolutionParameters(clargs)
    Generator(seed=clargs.seed)
    numerics = decode_numerics(clargs.numerics, petsc_tokens=clargs.petsc)
    grid = Grid(
        dim=ps.dim,
        dof=ps.nligands + 1,
        width=ps.width, height=ps.height, depth=ps.depth,
        nx=ps.nwidth, ny=ps.nheight, nz=ps.ndepth,
        order=ps.degree,
    )
    sources = decode_sources(clargs.source, ps, grid)
    return ps, grid, numerics, sources


def run_ensemble(clargs, ps, grid, ops, numerics):
    """--ensemble=N: N trajectories as ONE vmapped SPMD program.

    Each member draws its own initial random field (seed, seed+1, ...,
    seed+N-1) and noise PRNG chain; the member axis shards over the
    devices as pure data parallelism when N divides the device count.
    Member i saves to ``<save>_m<i>`` — a standard TimeSeries readable
    by Solution/moviemaker/tsmerge.  No reference counterpart: there,
    an ensemble is N separate cluster jobs (one options file each,
    e.g. /root/reference/options84s16.sh submitting one SLURM job per
    configuration).

    Multi-process runs (jax.process_count() > 1) slab the members
    contiguously over the processes: members are communication-free
    data parallelism, so process p integrates its own slab on its own
    local devices with zero collectives, and writes its members'
    series itself.  Per-member ICs (Generator(seed + global_i)) and
    noise key chains (fold_in(key, global_i), EnsembleSolver
    member_offset) are derived from the GLOBAL member index, so every
    member's trajectory and series file are bit-identical to the
    single-process run's (tests/test_distributed.py).
    """
    import time as _time

    import jax
    import jax.numpy as jnp

    from ksfd_tpu.ic import start_values
    from ksfd_tpu.solvers import EnsembleSolver, shard_members

    N = int(clargs.ensemble)
    if clargs.resume or clargs.restart or clargs.check:
        raise KSFDException(
            "--ensemble supports fresh starts only "
            "(no --resume/--restart/--check)"
        )
    nproc = jax.process_count()
    pid = jax.process_index()
    if N % nproc:
        raise KSFDException(
            "--ensemble=%d members must divide evenly over %d "
            "processes (members slab contiguously per process)"
            % (N, nproc)
        )
    nloc = N // nproc
    m0 = pid * nloc  # first GLOBAL member index of this process
    members = []
    t0 = float(ps.t0)
    for i in range(m0, m0 + nloc):
        Generator(seed=clargs.seed + i)
        u0, t0 = start_values(clargs, grid, ps)
        members.append(np.asarray(u0))
    U0 = jnp.asarray(np.stack(members))
    ldev = jax.local_devices()
    if len(ldev) > 1 and nloc % len(ldev) == 0:
        U0 = shard_members(U0, devices=ldev)
    maxsteps = 1 if clargs.onestep else int(ps.params0["maxsteps"])
    es = EnsembleSolver(
        ops, numerics, t0=t0, dt=float(ps.params0["dt"]),
        tmax=float(ps.params0["tmax"]), maxsteps=maxsteps,
        rtol=float(ps.params0["rtol"]), atol=float(ps.params0["atol"]),
        rng_key=jax.random.PRNGKey(clargs.seed),
        member_offset=m0,
    )
    series = []
    if clargs.save:
        for i in range(m0, m0 + nloc):
            ts_i = TimeSeries(
                "%s_m%d" % (clargs.save, i), grid=grid, mode="w",
                retries=clargs.series_retries,
                retry_interval=clargs.series_retry_interval,
            )
            write_info(ts_i, clargs=clargs, ps=ps, sources=ops.sources)
            ts_i.try_to_set("/info/member", i)
            ts_i.flush()
            series.append(ts_i)
    every = max(1, int(clargs.save_every))
    lastk = [None] * nloc

    def store_members(ks, ts, U, force=False):
        Uh = np.asarray(U)
        for i, s in enumerate(series):
            k = int(ks[i])
            if lastk[i] == k:
                continue
            if (
                not force
                and lastk[i] is not None
                and k - lastk[i] < every
            ):
                continue
            if not s.tsFile:
                s.reopen()
            s.store(Uh[i], float(ts[i]), k=k)
            s.temp_close()
            lastk[i] = k

    slab = "" if nproc == 1 else " members %d-%d," % (m0, m0 + nloc - 1)

    def ens_print(es_, ks, ts, U):
        print(
            "clock: %s,%s steps %d-%d t=[%.6g, %.6g] h=[%.3g, %.3g]"
            % (
                _time.strftime("%H:%M:%S"), slab,
                int(np.min(ks)), int(np.max(ks)),
                float(np.min(ts)), float(np.max(ts)),
                float(np.min(es_.hs)), float(np.max(es_.hs)),
            ),
            flush=True,
        )

    es.add_monitor(ens_print)
    if series:
        es.add_monitor(lambda es_, ks, ts, U: store_members(ks, ts, U))
    status = 0
    out = None
    try:
        import contextlib

        prof = (
            jax.profiler.trace(clargs.xprof)
            if clargs.xprof else contextlib.nullcontext()
        )
        with prof:
            out = es.solve(U0)
    except KeyboardInterrupt as e:
        print("KeyboardInterrupt:", str(e))
    except Exception as e:
        print("Exception:", str(e))
        import traceback

        traceback.print_exc()
        status = 1
    if series:
        if es.u is not None and es.ks is not None:
            try:
                store_members(es.ks, es.ts, es.u, force=True)
            except Exception as e:
                print("final save failed:", str(e))
        for s in series:
            s.close()
    if out is not None:
        print(
            "members = %d%s diverged = %d, solve failures = %d"
            % (nloc, slab or ",", int(np.sum(out.diverged)),
               int(np.sum(out.snes_failures)))
        )
    return status, es


def run(argv):
    """Run the command line ``argv`` (without the program name).

    Returns (exit status, the Solver or EnsembleSolver that ran, or
    None for --showparams)."""
    # Multi-process (multi-host) runs — the mpiexec analog — must join
    # the jax.distributed runtime before any backend use.
    from ksfd_tpu.parallel import maybe_init_distributed

    maybe_init_distributed()
    clargs = parse_commandline(argv)
    catch_signals()
    if clargs.noperiodic:
        raise KSFDException("--noperiodic not implemented: BCs are periodic")
    ps, grid, numerics, sources = build(clargs)
    if clargs.showparams:
        for n, p, d, h in ps.params0.params():
            print("{n}={val} -- {h}".format(n=n, val=p(), h=h))
        return 0, None
    if int(getattr(clargs, "ensemble", 0) or 0) >= 1:
        if clargs.with_g:
            raise KSFDException("--ensemble does not support --with_g")
        ops = PDEOperators(ps, grid, sources=sources,
                           flux_form=clargs.flux_form)
        return run_ensemble(clargs, ps, grid, ops, numerics)
    if clargs.with_g:
        from ksfd_tpu.ops import WithGOperators, with_g_grid

        full_grid = with_g_grid(grid)
        ops = WithGOperators(ps, full_grid, sources=sources,
                             flux_form=clargs.flux_form)
        if clargs.resume or clargs.restart:
            # with-G snapshots carry the G slot already
            u0, t, extras = initial_values(clargs, full_grid, ps)
        else:
            u0p, t, extras = initial_values(clargs, grid, ps)
            u0 = np.concatenate(
                [u0p, np.zeros((1,) + grid.Sshape)], axis=0
            )
        grid = full_grid
    else:
        u0, t, extras = initial_values(clargs, grid, ps)
        ops = PDEOperators(ps, grid, sources=sources,
                           flux_form=clargs.flux_form)
        # a PETSc '-ksp_type preonly -pc_type lu' block means exact
        # direct solves (the reference's MUMPS configuration); route
        # it onto the banded/sparse-LU tier when this grid fits a
        # host factorization (VERDICT r3 #4)
        from ksfd_tpu.solvers import route_petsc_direct

        numerics = route_petsc_direct(numerics, grid)
    # Shard the state over all devices (all hosts' devices in a
    # multi-process run); XLA inserts the halo collectives.  The
    # spatial decomposition is the framework's one parallelism
    # strategy (SURVEY §2), the DMDA replacement.
    import jax

    nprocs = jax.process_count()
    rank = jax.process_index()
    slab = None
    if len(jax.devices()) > 1:
        from ksfd_tpu.parallel import (
            grid_mesh, state_sharding, process_box, global_from_local,
        )

        mesh = grid_mesh(grid)
        if nprocs > 1:
            slab = process_box(grid, state_sharding(mesh))
        # a multi-process resume read only this process's slab; its box
        # (extras['box'], from the checkpoint's /ranges) seeds the
        # reassembly — it must match the block this run's mesh assigns
        # the process (resuming with a different device layout needs a
        # tsmerge first, like a different rank count)
        box = extras.get("box")
        if box is not None and slab is not None and \
                tuple(box) != tuple(slab):
            raise KSFDException(
                "checkpoint slab %r does not match this run's "
                "decomposition %r; tsmerge the series first"
                % (box, slab)
            )
        u0 = global_from_local(np.asarray(u0), grid, mesh, box=box)
    if clargs.save:
        tseries = TimeSeries(
            clargs.save, grid=grid, mode="w",
            retries=clargs.series_retries,
            retry_interval=clargs.series_retry_interval,
            size=nprocs, rank=rank, ranges=slab,
        )
        write_info(tseries, clargs=clargs, ps=ps, sources=sources)
        tseries.try_to_set("/info/dt", float(ps.params0["dt"]))
        if "lastvart" in ps.params0:
            tseries.try_to_set(
                "/info/lastvart", float(ps.params0["lastvart"])
            )
        tseries.flush()
    else:
        tseries = None
    maxsteps = 1 if clargs.onestep else int(ps.params0["maxsteps"])
    solver = Solver(
        ops,
        numerics,
        t0=t,
        dt=float(ps.params0["dt"]),
        tmax=float(ps.params0["tmax"]),
        maxsteps=maxsteps,
        rtol=float(ps.params0["rtol"]),
        atol=float(ps.params0["atol"]),
        rng_key=extras.get("rng_key", Generator.current_key()),
        lastvart=(
            float(ps.params0["lastvart"])
            if "lastvart" in ps.params0 else None
        ),
        k0=int(extras.get("k", 0)),
    )
    if rank == 0:  # reference printMonitor is rank-0 (ksfdts.py:337-353)
        solver.add_monitor(print_monitor)
    closer = None
    if tseries is not None:
        save_monitor, closer = make_save_monitor(
            tseries, every=clargs.save_every
        )
        solver.add_monitor(save_monitor)
    if clargs.check:
        solver.add_monitor(
            make_checkpoint_monitor(
                clargs.check, grid, clargs=clargs, ps=ps, sources=sources,
                retries=clargs.series_retries,
                retry_interval=clargs.series_retry_interval,
                size=nprocs, rank=rank, ranges=slab,
            )
        )
    status = 0
    try:
        import contextlib

        import jax
        import jax.numpy as jnp

        prof = (
            jax.profiler.trace(clargs.xprof)
            if clargs.xprof else contextlib.nullcontext()
        )
        with prof:
            solver.solve(jnp.asarray(u0), t=t)
    except KeyboardInterrupt as e:
        print("KeyboardInterrupt:", str(e))
    except Exception as e:
        print("Exception:", str(e))
        import traceback

        traceback.print_exc()
        status = 1
    if tseries is not None:
        if solver.u is not None:
            # --save_every thinning: always land the last accepted
            # state (also after an interrupt/exception unwound solve)
            try:
                save_monitor(solver, solver.k, solver.t, solver.u,
                             force=True)
            except Exception as e:
                print("final save failed:", str(e))
        if closer:
            closer()
        tseries.close()
    print("solve failures =", solver.snes_failures)
    return status, solver


def main(*args):
    args = list(args) if args else sys.argv
    return run(args[1:])[0]


if __name__ == "__main__":
    sys.exit(main())
