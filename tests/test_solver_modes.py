"""Tests for solver modes: multistep fusion, GMRES fallback, float32."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from ksfd_tpu import NumericsOptions
from ksfd_tpu.solvers import Solver, make_step_fn, make_multistep_fn
from manufactured import make_problem, exact_state


@pytest.fixture(scope="module")
def prob():
    return make_problem(nx=32)


@pytest.mark.parametrize("sweep_dtype", ["float32", "float64"])
def test_multistep_matches_stepping(prob, sweep_dtype):
    """Fused multistep ≡ host stepping.

    On the default mixed-precision path (sweep_dtype float32) the
    stage combinations accumulate in f32, so results are only
    reproducible across different XLA compilations (standalone step
    vs fori_loop body) to f32-eps-of-increment — the established
    mixed-precision envelope; the error estimate (a cancelling sum at
    ~1e-7 of the increments) is compared at a matching 1% tolerance.
    The pure-f64 sweep path must match bit-for-bit in state and to
    f64 roundoff in enorm.
    """
    ps, grid, ops = prob
    mixed = sweep_dtype == "float32"
    nm = NumericsOptions(adapt_type="none", sweep_dtype=sweep_dtype)
    step, _ = make_step_fn(ops, nm, atol=0.01, rtol=1e-6)
    multi, _ = make_multistep_fn(ops, nm, atol=0.01, rtol=1e-6)
    u = jnp.asarray(exact_state(ps, grid, 0.0))
    uref, t = u, 0.0
    emax = 0.0
    for _ in range(4):
        uref, e = step(uref, t, 1.0)
        emax = max(emax, float(e))
        t += 1.0
    um, tm, em = multi(u, 0.0, 1.0, 4)
    np.testing.assert_allclose(np.asarray(um), np.asarray(uref),
                               rtol=1e-10 if mixed else 1e-12,
                               atol=1e-8 if mixed else 1e-12)
    assert float(tm) == pytest.approx(4.0)
    assert float(em) == pytest.approx(emax, rel=0.01 if mixed else 1e-6)


def test_solver_block_steps(prob):
    ps, grid, ops = prob
    nm = NumericsOptions(adapt_type="none")
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    s1 = Solver(ops, nm, t0=0.0, dt=1.0, tmax=1e9, maxsteps=6,
                rtol=1e-6, atol=0.01)
    sB = Solver(ops, nm, t0=0.0, dt=1.0, tmax=1e9, maxsteps=6,
                rtol=1e-6, atol=0.01, block_steps=3)
    seen = []
    sB.add_monitor(lambda s, k, t, u: seen.append(k))
    u1 = np.asarray(s1.solve(u0))
    uB = np.asarray(sB.solve(u0))
    np.testing.assert_allclose(uB, u1, rtol=1e-12, atol=1e-12)
    assert sB.k == 6 and seen == [0, 3, 6]


def test_gmres_fallback_engages(prob):
    """A dt far beyond the Richardson stability range must not kill the
    run: the controller retries with the GMRES fallback."""
    ps, grid, ops = prob
    nm = NumericsOptions(ksp_iters=2)  # deliberately weak primary
    solver = Solver(ops, nm, t0=0.0, dt=500.0, tmax=1e9, maxsteps=4,
                    rtol=1e-6, atol=0.01)
    u = solver.solve(jnp.asarray(exact_state(ps, grid, 0.0)))
    assert solver.k == 4
    assert not solver.diverged
    assert np.all(np.isfinite(np.asarray(u)))
    # the fallback was built (i.e. it was needed at least once)
    assert solver._fallback_fn is not None


def test_float32_mode_step(prob):
    ps, grid, ops = prob
    s64, _ = make_step_fn(ops, NumericsOptions(), atol=0.01, rtol=1e-6)
    s32, _ = make_step_fn(
        ops, NumericsOptions(precision="float32"), atol=0.01, rtol=1e-6
    )
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    u64, e64 = s64(u0, 0.0, 1.0)
    u32, e32 = s32(u0, 0.0, 1.0)
    assert u32.dtype == jnp.float32
    rel = float(
        jnp.abs(u32.astype(jnp.float64) - u64).max() / jnp.abs(u64).max()
    )
    assert rel < 1e-5
    assert np.isfinite(float(e32))


def test_precision_numerics_decoding():
    from ksfd_tpu import decode_numerics

    opts = decode_numerics(["-precision", "f32"])
    assert opts.precision == "float32"
    opts = decode_numerics(["-precision", "float64"])
    assert opts.precision == "float64"


def test_device_fused_adaptive_loop(prob):
    """The fused adaptive chunk (device accept/reject + in-body robust
    retry) must match the host loop's trajectory quality."""
    ps, grid, ops = prob
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    host = Solver(ops, NumericsOptions(), t0=0.0, dt=1.0, tmax=50.0,
                  maxsteps=1000, rtol=1e-6, atol=0.01)
    uh = np.asarray(host.solve(u0))
    th = host.t
    fused = Solver(ops, NumericsOptions(device_loop=True), t0=0.0,
                   dt=1.0, tmax=50.0, maxsteps=1000, rtol=1e-6, atol=0.01)
    monitor_calls = []
    fused.add_monitor(lambda s, k, t, u: monitor_calls.append(k))
    uf = np.asarray(fused.solve(u0))
    assert fused.t >= 50.0 and not fused.diverged
    # far fewer host round-trips than steps
    assert len(monitor_calls) - 1 < fused.k
    # both land on the exact manufactured solution's trajectory
    ex_h = exact_state(ps, grid, th)
    ex_f = exact_state(ps, grid, fused.t)
    assert np.abs(uh - ex_h).max() < 5e-2
    assert np.abs(uf - ex_f).max() < 5e-2


def test_chunk_shrinks_h_on_device(prob):
    """A finite-enorm rejection inside the fused adaptive chunk must be
    handled ON DEVICE (shrink h, keep stepping) — not by exiting to the
    host fallback.  Regression for the hexagons2d rough phase, where
    exit-on-first-reject parked the run permanently on the ~1000x
    slower host robust path (round-2 measurement)."""
    from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn

    ps, grid, ops = prob
    # weak solver: h=500 rejects; ksp_iters_max=0 disables the
    # on-device sweep-tier escalation so the h-shrink path itself is
    # what gets exercised (the escalation has its own test below)
    nm = NumericsOptions(ksp_iters=2, ksp_iters_max=0)
    chunk, _ = make_adaptive_chunk_fn(ops, nm, atol=0.01, rtol=1e-6)
    u0 = ops.groom(jnp.asarray(exact_state(ps, grid, 0.0)))
    u, t, h, k, att, rej = chunk(u0, 0.0, 500.0, 1e9, 8)
    assert not bool(rej)          # never escalated to the host
    assert int(k) == 8            # all requested accepts delivered
    assert int(att) > int(k)      # ... after on-device rejections
    assert float(h) < 500.0       # h was shrunk into the stable range
    assert np.all(np.isfinite(np.asarray(u)))


def test_chunk_sweep_tier_escalation(prob):
    """A finite rejection of the fast attempt retries once at
    ksp_iters_max sweeps at the SAME h inside the chunk (VERDICT r3
    #2): where the weak tier alone must shrink h, the escalated tier
    keeps stepping at large h, delivering the same accepts in fewer
    attempts and without the h collapse."""
    from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn

    ps, grid, ops = prob
    u0 = ops.groom(jnp.asarray(exact_state(ps, grid, 0.0)))

    # iters=1 + diagonal pc at h=150 is SOLVE-limited (enorm ~1.3
    # from solve error; 16 sweeps pass the same h at ~0.4 — measured
    # sweep scan in this module's history), unlike large-h rejections
    # which are truncation-limited and no solver can rescue
    weak, _ = make_adaptive_chunk_fn(
        ops,
        NumericsOptions(ksp_iters=1, pc_type="spectral",
                        ksp_iters_max=0),
        atol=0.01, rtol=1e-6,
    )
    esc, _ = make_adaptive_chunk_fn(
        ops,
        NumericsOptions(ksp_iters=1, pc_type="spectral",
                        ksp_iters_max=16),
        atol=0.01, rtol=1e-6,
    )
    _, t_w, h_w, k_w, att_w, rej_w = weak(u0, 0.0, 150.0, 1e9, 8)
    u_e, t_e, h_e, k_e, att_e, rej_e = esc(u0, 0.0, 150.0, 1e9, 8)
    assert not bool(rej_e) and int(k_e) == 8
    # the escalated tier holds the solve-limited h the weak tier had
    # to shrink away from, covering more t in the same accept budget
    assert float(h_e) > 1.2 * float(h_w), (float(h_e), float(h_w))
    assert float(t_e) > float(t_w), (float(t_e), float(t_w))
    assert np.all(np.isfinite(np.asarray(u_e)))


def test_chunk_exits_rejected_on_nonfinite(prob):
    """A non-finite error estimate must exit the chunk immediately with
    h untouched, handing the state to the host robust path."""
    from ksfd_tpu.solvers.solver import make_adaptive_chunk_fn

    ps, grid, ops = prob
    chunk, _ = make_adaptive_chunk_fn(
        ops, NumericsOptions(), atol=0.01, rtol=1e-6
    )
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    ubad = u0.at[0, 0].set(jnp.nan)
    u, t, h, k, att, rej = chunk(ubad, 0.0, 1.0, 1e9, 8)
    assert bool(rej)
    assert int(k) == 0 and int(att) == 1
    assert float(h) == pytest.approx(1.0)


def test_device_loop_respects_maxsteps(prob):
    """The fused chunk must stop at the remaining maxsteps budget
    (max_accepts is passed per dispatch), not overshoot by up to a
    full chunk."""
    ps, grid, ops = prob
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    s = Solver(ops, NumericsOptions(device_loop=True), t0=0.0, dt=1.0,
               tmax=1e9, maxsteps=5, rtol=1e-6, atol=0.01)
    s.solve(u0)
    assert s.k == 5 and not s.diverged


def test_device_loop_disabled_when_cfl_time_dependent():
    ps, grid, ops = make_problem(
        nx=32, extra_params=["CFL_safety_factor=0.5+1e-12*sin(t)"]
    )
    s = Solver(ops, NumericsOptions(device_loop=True), t0=0.0, dt=1.0,
               tmax=10.0, maxsteps=5, rtol=1e-6, atol=0.01)
    assert s._chunk is None  # TD CFL factor needs per-step host logic


def test_device_loop_cfl_matches_host():
    """A constant CFL safety factor is clamped ON DEVICE inside the
    fused chunk, reproducing the host loop's per-accept clamp."""
    extra = ["CFL_safety_factor=1e-5"]  # binds: maxh ~31 vs free h ~120
    runs = {}
    for name, nm in (
        ("host", NumericsOptions()),
        ("fused", NumericsOptions(device_loop=True)),
    ):
        ps, grid, ops = make_problem(nx=32, extra_params=extra)
        s = Solver(ops, nm, t0=0.0, dt=1.0, tmax=200.0, maxsteps=500,
                   rtol=1e-6, atol=0.01)
        u = np.asarray(s.solve(jnp.asarray(exact_state(ps, grid, 0.0))))
        runs[name] = (s, u)
    sh, uh = runs["host"]
    sf, uf = runs["fused"]
    assert sf._chunk is not None  # constant CFL kept the fused loop
    # the clamp actually bound (h pinned to safety * CFL bound)
    assert sh.h == pytest.approx(1e-5 * sh.CFL_maxh, rel=1e-6)
    assert sf.k == sh.k
    # mixed-precision envelope: the fused chunk and the host step are
    # different XLA compilations, so the f32 stage combinations drift
    # at f32-eps-of-increment; through the CFL-clamped h trajectory
    # that compounds to ~1e-8 relative on t/h over ~100 steps.
    assert sf.t == pytest.approx(sh.t, rel=1e-6)
    assert sf.h == pytest.approx(sh.h, rel=1e-6)
    np.testing.assert_allclose(uf, uh, rtol=1e-6, atol=1e-6)


def test_device_loop_noise_matches_host():
    """Noise injection is fused-loop compatible: the chunk is bounded
    by the next injection time, so injections land on the same
    accepted steps as in the host loop (same PRNG stream => matching
    trajectories)."""
    extra = ["variance_rate=1e-6", "variance_timing_function=t/4",
             "conserve_worms=True"]
    key = jax.random.PRNGKey(7)
    runs = {}
    for name, nm in (
        ("host", NumericsOptions()),
        ("fused", NumericsOptions(device_loop=True)),
    ):
        ps, grid, ops = make_problem(nx=32, extra_params=extra)
        s = Solver(ops, nm, t0=0.0, dt=1.0, tmax=30.0, maxsteps=500,
                   rtol=1e-6, atol=0.01, rng_key=key)
        u = np.asarray(s.solve(jnp.asarray(exact_state(ps, grid, 0.0))))
        runs[name] = (s, u)
    sh, uh = runs["host"]
    sf, uf = runs["fused"]
    assert sf._chunk is not None  # noise did NOT disable the chunk
    # both injected, at the same time points (same PRNG splits)
    assert sh.lastvart > 0.0
    assert sf.lastvart == pytest.approx(sh.lastvart, rel=1e-6)
    assert np.asarray(sf.rng_key).tolist() == np.asarray(
        sh.rng_key
    ).tolist()
    # mixed-precision envelope across compilations (see the CFL test)
    assert sf.t == pytest.approx(sh.t, rel=1e-6)
    np.testing.assert_allclose(uf, uh, rtol=1e-6, atol=1e-6)


def test_history_and_print_monitors(prob, capsys):
    from ksfd_tpu.solvers import history_monitor, print_monitor

    ps, grid, ops = prob
    s = Solver(ops, NumericsOptions(adapt_type="none"), t0=0.0, dt=1.0,
               tmax=1e9, maxsteps=2, rtol=1e-6, atol=0.01)
    s.add_monitor(print_monitor)
    s.add_monitor(history_monitor)
    s.solve(jnp.asarray(exact_state(ps, grid, 0.0)))
    out = capsys.readouterr().out
    assert "step   2" in out and "CFL=" in out
    assert len(s.history) == 3  # k=0,1,2
    assert s.history[-1]["t"] == pytest.approx(2.0)
    assert s.history[-1]["u"].shape == grid.Vshape


def test_driver_onestep(tmp_path):
    import os, subprocess, sys

    REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    optfile = tmp_path / "opts"
    optfile.write_text(
        "dt=1\nmaxsteps=50\ntmax=1e6\nwidth=1\nnelements=16\ndim=1\n"
        "sigma=0.02357\ns2=sigma**2/2\nNworms=0\nsrho0=0\nrho0=9000\n"
        "ngroups=1\nnligands_1=1\nalpha_1=1500\nbeta_1=5.56e-4\n"
        "s_1_1=0.01\ngamma_1_1=0.01\nD_1_1=1e-6\n"
    )
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "ksfdsolver.py"),
         "@" + str(optfile), "--onestep"],
        capture_output=True, text=True,
        env=dict(os.environ, KSFD_PLATFORM="cpu", PYTHONPATH=REPO),
        cwd=REPO,
    )
    assert r.returncode == 0, r.stderr + r.stdout
    assert "step   1" in r.stdout
    assert "step   2" not in r.stdout


def test_chunk_rejection_without_fallback_continues(prob):
    """A stuck fused chunk under a ksp_type with no robust fallback
    (anything but richardson) must shrink h and continue instead of
    arming a fallback mode that calls None (regression: TypeError
    aborted the whole run)."""
    ps, grid, ops = prob
    nm = NumericsOptions(device_loop=True, ksp_type="gmres_rolled",
                         sweep_dtype="float64")
    s = Solver(ops, nm, t0=0.0, dt=1.0, tmax=20.0, maxsteps=60,
               rtol=1e-6, atol=0.01)
    assert s._get_fallback() is None
    real_chunk = s._chunk
    calls = {"n": 0}

    def fake_chunk(u, t, h, tmax, maxacc):
        calls["n"] += 1
        if calls["n"] == 1:
            # simulate a stuck exit: nothing accepted, rejected flag
            return u, t, h, 0, 8, True
        return real_chunk(u, t, h, tmax, maxacc)

    s._chunk = fake_chunk
    u = s.solve(jnp.asarray(exact_state(ps, grid, 0.0)))
    assert calls["n"] > 1          # it re-entered the chunk
    assert s.snes_failures >= 1    # the stuck exit was counted
    assert not s.diverged
    assert not s._fb_mode
    assert np.isfinite(np.asarray(u)).all()


def test_solver_reuse_resets_controller_state(prob):
    """solve() resets the fallback-controller state, so a reused
    Solver instance reproduces a fresh run bit-for-bit even after the
    previous run parked on the robust fallback."""
    ps, grid, ops = prob
    nm = NumericsOptions(sweep_dtype="float64")
    kw = dict(t0=0.0, dt=1.0, tmax=20.0, maxsteps=40, rtol=1e-6,
              atol=0.01)
    s = Solver(ops, nm, **kw)
    u0 = jnp.asarray(exact_state(ps, grid, 0.0))
    u_first = np.asarray(s.solve(u0))
    k_first, t_first = s.k, s.t
    # poison the controller state as a stiff previous run would
    s._fb_mode, s._fb_probe, s._chunk_rej_streak = True, 1, 5
    s._fb_accepts = 3
    u_again = np.asarray(s.solve(u0))
    assert s.k == k_first and s.t == t_first
    np.testing.assert_array_equal(u_again, u_first)
