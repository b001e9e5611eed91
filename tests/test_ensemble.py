"""EnsembleSolver: N trajectories as one vmapped SPMD program.

No reference counterpart (the reference integrates one options file
per cluster job); this is the batch-of-trajectories DP axis noted in
SURVEY §2 "Parallelism strategies".  The oracle is the scalar Solver:
each member of an ensemble must follow the same adaptive trajectory
as its own scalar run, to the mixed-precision cross-compilation
envelope (vmapped and scalar steps are different XLA executables).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ksfd_tpu import NumericsOptions
from ksfd_tpu.solvers import EnsembleSolver, Solver, shard_members
from manufactured import make_problem, exact_state


@pytest.fixture(scope="module")
def prob():
    return make_problem(nx=32)


def _members(ps, grid, n):
    """n distinct perturbations of the manufactured state."""
    base = np.asarray(exact_state(ps, grid, 0.0))
    rng = np.random.default_rng(42)
    out = []
    for i in range(n):
        pert = 1.0 + 1e-3 * rng.standard_normal(base.shape)
        out.append(base * pert)
    return np.stack(out)


def test_ensemble_matches_scalar_trajectories(prob):
    """Each member follows its own scalar-Solver trajectory.  Compared
    on the pure-f64 sweep path, which is reproducible across the
    scalar and vmapped compilations (the default mixed path drifts at
    the f32 envelope and is covered by the other tests)."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 3)
    nm = NumericsOptions(sweep_dtype="float64")
    kw = dict(t0=0.0, dt=1.0, tmax=40.0, maxsteps=60, rtol=1e-6,
              atol=0.01)
    es = EnsembleSolver(ops, nm, **kw)
    out = es.solve(jnp.asarray(U0))
    assert not out.diverged.any()
    for i in range(3):
        s = Solver(ops, nm, **kw)
        ui = np.asarray(s.solve(jnp.asarray(U0[i])))
        # same controller decisions => same step counts and times
        assert out.k[i] == s.k
        assert out.t[i] == pytest.approx(s.t, rel=1e-9)
        assert out.h[i] == pytest.approx(s.h, rel=1e-9)
        np.testing.assert_allclose(
            np.asarray(out.u[i]), ui, rtol=1e-9, atol=1e-9
        )


def test_ensemble_members_independent(prob):
    """Changing one member's IC must not perturb the others at all
    (data parallelism is communication-free)."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    kw = dict(t0=0.0, dt=1.0, tmax=20.0, maxsteps=40, rtol=1e-6,
              atol=0.01)
    outA = EnsembleSolver(ops, NumericsOptions(), **kw).solve(
        jnp.asarray(U0)
    )
    U0b = U0.copy()
    U0b[1] *= 1.0 + 1e-2
    outB = EnsembleSolver(ops, NumericsOptions(), **kw).solve(
        jnp.asarray(U0b)
    )
    np.testing.assert_array_equal(
        np.asarray(outA.u[0]), np.asarray(outB.u[0])
    )
    assert np.abs(np.asarray(outA.u[1]) - np.asarray(outB.u[1])).max() > 0


def test_ensemble_sharded_over_mesh(prob):
    """8 members sharded over the 8-device mesh: same answer as the
    unsharded run, member axis actually distributed."""
    ps, grid, ops = prob
    n = len(jax.devices())
    U0 = _members(ps, grid, n)
    kw = dict(t0=0.0, dt=1.0, tmax=20.0, maxsteps=40, rtol=1e-6,
              atol=0.01)
    ref = EnsembleSolver(ops, NumericsOptions(), **kw).solve(
        jnp.asarray(U0)
    )
    Us = shard_members(jnp.asarray(U0))
    assert len(Us.sharding.device_set) == n
    out = EnsembleSolver(ops, NumericsOptions(), **kw).solve(Us)
    assert (out.k == ref.k).all()
    np.testing.assert_allclose(
        np.asarray(out.u), np.asarray(ref.u), rtol=1e-6, atol=1e-6
    )


def test_ensemble_fixed_dt_and_divergence_isolation(prob):
    """adapt none: accepted members keep the nominal dt; a member
    driven to divergence (absurd dt) is flagged without stopping the
    healthy members."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    nm = NumericsOptions(adapt_type="none", ksp_iters=2,
                         max_snes_failures=1)
    es = EnsembleSolver(ops, nm, t0=0.0, dt=1.0, tmax=5.0, maxsteps=5,
                        rtol=1e-6, atol=0.01)
    out = es.solve(jnp.asarray(U0))
    assert not out.diverged.any()
    assert (out.k == 5).all()
    assert np.allclose(out.t, 5.0)


def test_ensemble_block_steps_matches_stepping(prob):
    """block_steps>1 fixed-dt: fused vmapped blocks between monitor
    calls, same final states as per-step ensemble integration."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    nm = NumericsOptions(adapt_type="none", sweep_dtype="float64")
    kw = dict(t0=0.0, dt=1.0, tmax=1e9, maxsteps=6, rtol=1e-6,
              atol=0.01)
    ref = EnsembleSolver(ops, nm, **kw).solve(jnp.asarray(U0))
    esB = EnsembleSolver(ops, nm, block_steps=3, **kw)
    seen = []
    esB.add_monitor(lambda es, ks, ts, U: seen.append(ks.copy()))
    out = esB.solve(jnp.asarray(U0))
    assert (out.k == 6).all() and (ref.k == 6).all()
    assert [list(k) for k in seen] == [[0, 0], [3, 3], [6, 6]]
    np.testing.assert_allclose(
        np.asarray(out.u), np.asarray(ref.u), rtol=1e-12, atol=1e-12
    )


def test_ensemble_noise_streams_differ(prob):
    """Per-member PRNG chains: with noise active, members starting
    from the SAME state receive different injections."""
    ps, grid, ops = make_problem(
        nx=32,
        extra_params=["variance_rate=1e-6",
                      "variance_timing_function=t/4"],
    )
    base = np.asarray(exact_state(ps, grid, 0.0))
    U0 = np.stack([base, base])
    es = EnsembleSolver(ops, NumericsOptions(), t0=0.0, dt=1.0,
                        tmax=30.0, maxsteps=100, rtol=1e-6, atol=0.01,
                        rng_key=jax.random.PRNGKey(7))
    out = es.solve(jnp.asarray(U0))
    assert not out.diverged.any()
    d = np.abs(np.asarray(out.u[0]) - np.asarray(out.u[1])).max()
    assert d > 1e-8  # injections actually differed between members


def test_ensemble_member_offset_slabs():
    """member_offset: two slab solvers (members 0-1 and 2-3 of a
    4-member ensemble) reproduce the full run's per-member
    trajectories BIT-exactly, noise chains included — the contract the
    multi-process ensemble mode (ksfdsolver.run_ensemble) rests on."""
    ps, grid, ops = make_problem(
        nx=32,
        extra_params=["variance_rate=1e-6",
                      "variance_timing_function=t/4"],
    )
    base = np.asarray(exact_state(ps, grid, 0.0))
    rng = np.random.default_rng(3)
    U0 = np.stack([
        base * (1.0 + 1e-3 * rng.standard_normal(base.shape))
        for _ in range(4)
    ])
    kw = dict(t0=0.0, dt=1.0, tmax=30.0, maxsteps=40, rtol=1e-6,
              atol=0.01, rng_key=jax.random.PRNGKey(7))
    full = EnsembleSolver(ops, NumericsOptions(), **kw).solve(
        jnp.asarray(U0)
    )
    assert not full.diverged.any()
    for m0 in (0, 2):
        slab = EnsembleSolver(
            ops, NumericsOptions(), member_offset=m0, **kw
        ).solve(jnp.asarray(U0[m0:m0 + 2]))
        for j in range(2):
            i = m0 + j
            assert slab.k[j] == full.k[i]
            assert float(slab.t[j]) == float(full.t[i])
            assert np.array_equal(
                np.asarray(slab.u[j]), np.asarray(full.u[i])
            ), i
    # and a WRONG offset must actually change the noise draws
    # (guards against fold_in silently ignoring the offset)
    wrong = EnsembleSolver(
        ops, NumericsOptions(), member_offset=1, **kw
    ).solve(jnp.asarray(U0[0:2]))
    d = np.abs(np.asarray(wrong.u[0]) - np.asarray(full.u[0])).max()
    assert d > 1e-8


def _rough_2d_problem():
    """A 2D stage-delta problem + a rough 2-member batch."""
    from helpers import make_clargs, OPTIONS92_PARAMS
    from ksfd_tpu import Grid, SolutionParameters
    from ksfd_tpu.ops import PDEOperators

    params = [
        p for p in OPTIONS92_PARAMS
        if p.split("=", 1)[0]
        not in ("nelements", "dim", "rho0", "U0_1_1", "U0_2_1")
    ] + ["nelements=32", "dim=2", "height=1", "rho0=murho",
         "U0_1_1=", "U0_2_1="]
    ps = SolutionParameters(make_clargs(params=params))
    grid = Grid(dim=2, width=1.0, height=1.0, nx=32, ny=32, dof=3,
                order=3)
    ops = PDEOperators(ps, grid)
    rng = np.random.default_rng(5)
    base = np.stack([
        6000 + 3000 * np.abs(rng.standard_normal(grid.Sshape)),
        6000 + 1000 * np.abs(rng.standard_normal(grid.Sshape)),
        6000 + 500 * np.abs(rng.standard_normal(grid.Sshape)),
    ])
    return ops, grid, np.stack([base, base * 1.01])


def test_ensemble_uses_batched_delta_step():
    """The unsharded ensemble vmaps the default step with stage-delta
    engaged, and the vmapped step matches per-member scalar
    stepping."""
    from ksfd_tpu.solvers import make_step_fn
    from ksfd_tpu.solvers.solver import BUILD_INFO

    ops, grid, U0 = _rough_2d_problem()

    nm = NumericsOptions(adapt_type="none", stage_delta=True)
    es = EnsembleSolver(ops, nm,
                        t0=0.0, dt=1e-3, tmax=1e9, maxsteps=2,
                        rtol=1e-6, atol=0.01)
    out = es.solve(jnp.asarray(U0))
    assert es._vstep_flavor == "plain"
    assert (out.k == 2).all()

    # per-member scalar oracle on the same (stage-delta) path
    step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
    assert BUILD_INFO["delta"] and BUILD_INFO["mixed32"]
    for i in range(2):
        u, t = jnp.asarray(U0[i]), 0.0
        u = ops.groom(u)
        for _ in range(2):
            u, _e = step(u, t, 1e-3)
            u = ops.groom(u)
            t += 1e-3
        ref = np.asarray(u)
        got = np.asarray(out.u[i])
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() / scale < 1e-5


def test_ensemble_sharded_members_keep_delta():
    """Members sharded over the device mesh run the SAME batched
    stage-delta step inside shard_map over the member axis — one
    collective-free program per device (VERDICT r2 weak #7).  Oracle:
    the unsharded run."""
    ops, grid, U2 = _rough_2d_problem()
    n = len(jax.devices())
    U0 = np.concatenate(
        [U2[:1] * (1.0 + 1e-3 * i) for i in range(n)], axis=0
    )
    kw = dict(t0=0.0, dt=1e-3, tmax=1e9, maxsteps=3, rtol=1e-6,
              atol=0.01)
    nm = NumericsOptions(stage_delta=True)
    es_ref = EnsembleSolver(ops, nm, **kw)
    ref = es_ref.solve(jnp.asarray(U0))
    assert es_ref._vstep_flavor == "plain"

    Us = shard_members(jnp.asarray(U0))
    es = EnsembleSolver(ops, nm, **kw)
    out = es.solve(Us)
    # the same step, under shard_map over the member mesh
    assert es._vstep_flavor.startswith("smap")
    assert es._member_mesh is not None
    assert (out.k == ref.k).all()
    # NOT bit-exact vs the unsharded run: the shard_map body compiles
    # the batched f32 sweeps and increments at a different batch
    # shape, and f32 reassociation across executables moves the
    # mixed-precision increments at their last bit.  1e-6 of state
    # scale is the envelope the sharded-vs-single step tests use
    # (test_delta.py).
    scale = np.abs(np.asarray(ref.u)).max()
    assert np.abs(np.asarray(out.u) - np.asarray(ref.u)).max() / scale \
        < 1e-6

    # the per-step program must be collective-free (members are
    # independent; shard_map bodies see only local members)
    ts = jnp.zeros(n)
    hs = jnp.full(n, 1e-3)
    hlo = es._vstep.lower(Us, ts, hs).compile().as_text()
    for coll in ("all-gather", "all-reduce", "collective-permute",
                 "all-to-all"):
        assert coll not in hlo, coll


def test_ensemble_sharded_chunk_and_block_modes():
    """The -device_loop adaptive chunk and the fixed-dt block mode
    also run sharded members through shard_map (same results as the
    unsharded runs)."""
    import dataclasses

    ops, grid, U2 = _rough_2d_problem()
    n = len(jax.devices())
    U0 = np.concatenate(
        [U2[:1] * (1.0 + 1e-3 * i) for i in range(n)], axis=0
    )
    kw = dict(t0=0.0, dt=1e-3, tmax=1e9, maxsteps=3, rtol=1e-6,
              atol=0.01)

    nm_dl = NumericsOptions(device_loop=True)
    ref = EnsembleSolver(ops, nm_dl, **kw).solve(jnp.asarray(U0))
    es = EnsembleSolver(ops, nm_dl, **kw)
    out = es.solve(shard_members(jnp.asarray(U0)))
    assert es._vchunk is not None and es._vstep_flavor.startswith("smap")
    assert (out.k == ref.k).all()
    # f32 envelope across batch-shape recompilations (see
    # test_ensemble_sharded_members_keep_delta)
    scale = np.abs(np.asarray(ref.u)).max()
    assert np.abs(np.asarray(out.u) - np.asarray(ref.u)).max() / scale \
        < 1e-6

    nm_fx = dataclasses.replace(NumericsOptions(), adapt_type="none")
    ref = EnsembleSolver(ops, nm_fx, block_steps=3, **kw).solve(
        jnp.asarray(U0)
    )
    es = EnsembleSolver(ops, nm_fx, block_steps=3, **kw)
    out = es.solve(shard_members(jnp.asarray(U0)))
    assert es._vmulti is not None
    assert (out.k == ref.k).all()
    scale = np.abs(np.asarray(ref.u)).max()
    assert np.abs(np.asarray(out.u) - np.asarray(ref.u)).max() / scale \
        < 1e-6


def test_ensemble_device_fused_adaptive_chunk(prob):
    """-device_loop ensembles: each member's adaptive accept/reject/h
    walk runs inside ONE vmapped lax.while_loop dispatch per chunk.
    Each member must follow its own scalar device-loop Solver
    trajectory (f64 sweep path, reproducible across the scalar and
    vmapped chunk compilations) with far fewer host round-trips than
    steps."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 3)
    nm = NumericsOptions(device_loop=True, sweep_dtype="float64")
    kw = dict(t0=0.0, dt=1.0, tmax=50.0, maxsteps=200, rtol=1e-6,
              atol=0.01)
    fused = EnsembleSolver(ops, nm, **kw)
    assert fused._vchunk is None  # built lazily in solve()
    monitor_calls = []
    fused.add_monitor(lambda es, ks, ts, U: monitor_calls.append(ks.copy()))
    of = fused.solve(jnp.asarray(U0))
    assert fused._vchunk is not None
    assert (~of.diverged).all() and (of.t >= 50.0).all()
    # far fewer host round-trips than accepted steps
    assert len(monitor_calls) - 1 < of.k.max()
    for i in range(3):
        s = Solver(ops, nm, **kw)
        ui = np.asarray(s.solve(jnp.asarray(U0[i])))
        assert of.k[i] == s.k
        assert of.t[i] == pytest.approx(s.t, rel=1e-9)
        assert of.h[i] == pytest.approx(s.h, rel=1e-9)
        np.testing.assert_allclose(
            np.asarray(of.u[i]), ui, rtol=1e-9, atol=1e-9
        )


def test_ensemble_chunk_respects_maxsteps_and_isolation(prob):
    """Per-member max_accepts: a member that reaches maxsteps stops
    while the rest keep stepping (the chunk no-ops it via
    max_accepts=0)."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    es = EnsembleSolver(ops, NumericsOptions(device_loop=True),
                        t0=0.0, dt=1.0, tmax=1e9, maxsteps=5,
                        rtol=1e-6, atol=0.01)
    out = es.solve(jnp.asarray(U0))
    assert (out.k == 5).all()
    assert np.isfinite(np.asarray(out.u)).all()


def test_ensemble_chunk_noise_matches_host():
    """Noise injection with -device_loop ensembles: each member's
    chunk is bounded at ITS next injection time, so injections land on
    the same accepted steps (and consume the same per-member key
    chain) as the per-step host ensemble loop — identical final
    states on the f64 sweep path."""
    ps, grid, ops = make_problem(
        nx=32,
        extra_params=["variance_rate=1e-6",
                      "variance_timing_function=t/4"],
    )
    base = np.asarray(exact_state(ps, grid, 0.0))
    U0 = np.stack([base, base * (1.0 + 1e-3)])
    kw = dict(t0=0.0, dt=1.0, tmax=30.0, maxsteps=100, rtol=1e-6,
              atol=0.01, rng_key=jax.random.PRNGKey(7))
    oh = EnsembleSolver(
        ops, NumericsOptions(sweep_dtype="float64"), **kw
    ).solve(jnp.asarray(U0))
    of = EnsembleSolver(
        ops, NumericsOptions(device_loop=True, sweep_dtype="float64"),
        **kw
    ).solve(jnp.asarray(U0))
    assert not of.diverged.any()
    assert (of.k == oh.k).all()
    np.testing.assert_allclose(of.t, oh.t, rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(of.u), np.asarray(oh.u), rtol=1e-9, atol=1e-9
    )


def test_ensemble_chunk_noise_straddle_terminates():
    """A member that crosses its injection time while variance_rate is
    still zero there cannot advance lastvart, so its next chunk bound
    lands BEFORE its current t.  The chunk loop must not spin on such
    a member forever: it falls through to one-accept-per-dispatch
    stepping (the scalar host-fallthrough semantics) until the
    injection lands, matching the per-step host ensemble loop
    exactly on the f64 sweep path."""
    import signal

    ps, grid, ops = make_problem(
        nx=32,
        extra_params=["variance_rate=1e-7*Max(0,t-12)",
                      "variance_timing_function=t/4"],
    )
    base = np.asarray(exact_state(ps, grid, 0.0))
    U0 = np.stack([base, base * (1.0 + 1e-3)])
    kw = dict(t0=0.0, dt=1.0, tmax=20.0, maxsteps=100, rtol=1e-6,
              atol=0.01, rng_key=jax.random.PRNGKey(7))

    def on_alarm(signum, frame):
        raise TimeoutError("ensemble chunk loop appears stuck")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.alarm(600)
    try:
        of = EnsembleSolver(
            ops,
            NumericsOptions(device_loop=True, sweep_dtype="float64"),
            **kw,
        ).solve(jnp.asarray(U0))
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
    assert not of.diverged.any()
    assert (of.t > 20.0).all()
    oh = EnsembleSolver(
        ops, NumericsOptions(sweep_dtype="float64"), **kw
    ).solve(jnp.asarray(U0))
    assert (of.k == oh.k).all()
    np.testing.assert_allclose(of.t, oh.t, rtol=1e-9)
    np.testing.assert_allclose(
        np.asarray(of.u), np.asarray(oh.u), rtol=1e-9, atol=1e-9
    )


def test_ensemble_u_current_during_run(prob):
    """solve() keeps self.u/self.ks current at every monitor call, so
    the driver's interrupt-time forced save (ksfdsolver.run_ensemble
    after KeyboardInterrupt) captures the accepted progress instead of
    finding u=None."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    es = EnsembleSolver(ops, NumericsOptions(), t0=0.0, dt=1.0,
                        tmax=40.0, maxsteps=60, rtol=1e-6, atol=0.01)
    seen = []

    def interrupter(es_, ks, ts, U):
        assert es_.u is not None
        seen.append((ks.copy(), np.asarray(U)))
        if len(seen) == 3:
            raise KeyboardInterrupt

    es.add_monitor(interrupter)
    with pytest.raises(KeyboardInterrupt):
        es.solve(jnp.asarray(U0))
    ks_last, U_last = seen[-1]
    assert es.u is not None
    assert (es.ks == ks_last).all()
    assert ks_last.max() > 0  # interrupted mid-run, after real steps
    np.testing.assert_array_equal(np.asarray(es.u), U_last)


def test_ensemble_fallback_hysteresis(prob):
    """VERDICT r2 #8: a rescued member STAYS on the robust solver for
    fb_probe accepts (the scalar controller's _fb_mode hysteresis)
    and follows the scalar Solver's forced-failure trajectory.

    The fast step is forced to fail once for member 0 and the robust
    retry is forced to accept it (the true LTE at dt=1 rejects any
    solver, so a natural rescue cannot be staged); the scalar oracle
    gets the identical forcing, so every later controller decision —
    including staying parked on the fallback — must match."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    nm = NumericsOptions(sweep_dtype="float64")
    kw = dict(t0=0.0, dt=1.0, tmax=1e6, maxsteps=8, rtol=1e-6,
              atol=0.01)

    def force_pair(step, fb, member=None):
        """(wrapped_step, wrapped_fb): first step call fails (member 0
        / the scalar run), first fb call accepts with enorm 0.5."""
        st = {"step": True, "fb": True}

        def wstep(u, t, h):
            u1, e = step(u, t, h)
            if st["step"]:
                st["step"] = False
                e = (
                    jnp.asarray(e).at[0].set(jnp.inf)
                    if member == 0 else jnp.asarray(jnp.inf)
                )
            return u1, e

        def wfb(u, t, h):
            u1, e = fb(u, t, h)
            if st["fb"]:
                st["fb"] = False
                e = (
                    jnp.asarray(e).at[0].set(0.5)
                    if member == 0 else jnp.asarray(0.5)
                )
            return u1, e

        return wstep, wfb

    es = EnsembleSolver(ops, nm, **kw)
    es._build_steps(None)
    es._vstep, es._vfallback = force_pair(
        es._vstep, es._get_vfallback(), member=0
    )
    out = es.solve(jnp.asarray(U0))
    assert not out.diverged.any()
    assert out.k[0] == 8 and out.k[1] == 8
    # member 0 engaged the fallback and is still parked on it
    assert es._fbm[0] and not es._fbm[1]
    assert es._fbacc[1] == 0

    # scalar oracle with the identical forcing
    s = Solver(ops, nm, **kw)
    s.step_fn, s._fallback_fn = force_pair(
        s.step_fn, s._get_fallback()
    )
    us = np.asarray(s.solve(jnp.asarray(U0[0])))
    assert s._fb_mode
    assert es._fbacc[0] == s._fb_accepts
    assert out.snes_failures[0] == s.snes_failures
    assert out.k[0] == s.k
    assert out.t[0] == pytest.approx(s.t, rel=1e-9)
    assert out.h[0] == pytest.approx(s.h, rel=1e-9)
    np.testing.assert_allclose(
        np.asarray(out.u[0]), us, rtol=1e-9, atol=1e-9
    )


def test_ensemble_chunk_fallback_hysteresis(prob):
    """Chunk-stuck members engage fallback mode at the streak-scaled
    probe length, step host-side on the robust solver, and hand the
    run back to the fused chunk after fb_probe accepts (the scalar
    device-loop controller's _chunk_rej_streak semantics)."""
    ps, grid, ops = prob
    U0 = _members(ps, grid, 2)
    nm = NumericsOptions(sweep_dtype="float64", device_loop=True)
    kw = dict(t0=0.0, dt=1.0, tmax=1e6, maxsteps=6, rtol=1e-6,
              atol=0.01)
    es = EnsembleSolver(ops, nm, **kw)
    es._build_steps(None)
    real = es._vchunk
    state = {"first": True}

    def fake(U, ts, hs, tmax, macc):
        u1, t1, h1, kacc, att, rej = real(U, ts, hs, tmax, macc)
        if state["first"]:
            state["first"] = False
            # member 0: stuck, zero accepts, state/h unchanged
            u1 = jnp.asarray(u1).at[0].set(U[0])
            t1 = jnp.asarray(t1).at[0].set(ts[0])
            h1 = jnp.asarray(h1).at[0].set(hs[0])
            kacc = jnp.asarray(kacc).at[0].set(0)
            att = jnp.asarray(att).at[0].set(8)
            rej = jnp.asarray(rej).at[0].set(True)
        return u1, t1, h1, kacc, att, rej

    es._vchunk = fake
    out = es.solve(jnp.asarray(U0))
    assert not out.diverged.any()
    assert out.k[0] == 6 and out.k[1] == 6
    # engaged at probe 2 (streak 1), took 2 fallback accepts, then
    # handed back to the chunk
    assert not es._fbm[0] and not es._fbm[1]
    assert es._fbprobe[0] == 2 and es._fbacc[0] == 2
    # the 8 on-device attempts of the stuck dispatch count as failures
    assert out.snes_failures[0] >= 8
