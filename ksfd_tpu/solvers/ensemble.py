"""Ensemble integration: N independent trajectories as ONE program.

The reference runs one options file per process (its only parallelism
is spatial domain decomposition, KSFD/ksfdgrid.py:1-4); parameter
sweeps and noise ensembles there mean N separate cluster jobs.  On an
accelerator the natural "free" axis (SURVEY §2 "Parallelism strategies") is
batch-of-trajectories data parallelism: the jitted implicit step is
`jax.vmap`-ped over a leading member axis, every member carries its
own (t, h, PRNG key, controller state) on the host, and the member
axis shards over the device mesh as pure DP (no cross-member
communication at all, so scaling is embarrassing by construction).

Semantics per member match the scalar `Solver` host loop: accept /
reject via the embedded WLTE estimate, PETSc-style h controller with
clip/rollback, GMRES fallback retry at the same h WITH the scalar
controller's per-member hysteresis (a rescued member stays on the
robust solver for fb_probe accepts before re-probing the fast path;
chunk-stuck members scale the probe by the consecutive-rejection
streak, exactly like Solver._chunk_rej_streak), CFL clamp, noise
injection with per-member keys, and worm-count conservation.
Trajectories are identical to the scalar loop's up to the
mixed-precision cross-compilation envelope (vmapped step vs scalar
step are different XLA executables).

Usage:
    es = EnsembleSolver(ops, numerics, t0=.., dt=.., tmax=..,
                        maxsteps=.., atol=.., rtol=..)
    out = es.solve(U0)            # U0: (n_members, dof, nx[, ny[, nz]])
    out.u, out.t, out.k, out.diverged, out.snes_failures  # per member

Shard the member axis over the devices with `shard_members(U0)`
before calling solve(); everything downstream is sharding-transparent.

With ``NumericsOptions(device_loop=True)`` (CLI: ``-device_loop 1``)
adaptive ensembles run the scalar Solver's fused adaptive chunk
vmapped over members: each member walks its own accept/reject/h
trajectory inside ONE batched lax.while_loop dispatch (up to 128
attempts), instead of paying one host round-trip per step.  Noise
injection bounds each member's chunk at its own next injection time;
a stuck member gets the vmapped robust-fallback retry.
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.cli import NumericsOptions
from ..utils.debug import logger
from .solver import make_step_fn
from .steppers import DIRKTableau, get_tableau

logENS = logger("ENSEMBLE")

__all__ = ["EnsembleSolver", "shard_members"]


def shard_members(U, devices=None):
    """Distribute the leading member axis of U over the devices.

    Pure data parallelism: a 1D Mesh('e') with NamedSharding
    P('e', None, ...).  n_members must be divisible by the device
    count.  Returns the sharded array (use .sharding/.addressable_
    shards to inspect placement).
    """
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    devices = list(devices if devices is not None else jax.devices())
    if U.shape[0] % len(devices):
        raise ValueError(
            "n_members=%d not divisible by %d devices"
            % (U.shape[0], len(devices))
        )
    mesh = Mesh(np.array(devices), ("e",))
    spec = PartitionSpec("e", *([None] * (U.ndim - 1)))
    return jax.device_put(U, NamedSharding(mesh, spec))


class EnsembleSolver:
    """Vector adaptive controller over a vmapped implicit step."""

    default_hmin = 1e-20

    def __init__(
        self,
        ops,
        numerics=None,
        t0=0.0,
        dt=0.001,
        tmax=20.0,
        maxsteps=100,
        rtol=1e-5,
        atol=1e-5,
        hmin=None,
        rng_key=None,
        block_steps=1,
        member_offset=0,
    ):
        """block_steps > 1 (fixed-dt runs only): fuse that many steps
        per member into one vmapped device execution between monitor
        calls — the scalar Solver's block mode, essential over a
        high-dispatch-latency device link.

        member_offset: GLOBAL index of this solver's first member.
        Per-member noise key chains fold rng_key with the global
        member index, so a multi-process ensemble (each process
        integrating its own member slab, ksfdsolver.run_ensemble)
        reproduces the single-process run's per-member trajectories
        bit-exactly."""
        self.ops = ops
        self.ps = ops.ps
        self.numerics = numerics or NumericsOptions()
        self.t0 = float(t0)
        self.dt0 = float(dt)
        self.tmax = float(tmax)
        self.maxsteps = int(maxsteps)
        self.rtol = float(rtol)
        self.atol = float(atol)
        self.hmin = float(hmin) if hmin else self.default_hmin
        self.rng_key = (
            rng_key if rng_key is not None else jax.random.PRNGKey(0)
        )
        self.monitors = []
        if self.numerics.ksp_type in ("banded", "lu"):
            from ..utils.exceptions import KSFDException

            raise KSFDException(
                "ksp_type=%s is a host-side direct solve (scalar "
                "Solver only); ensembles need a device stage solver"
                % self.numerics.ksp_type
            )
        self.tableau = get_tableau(self.numerics.ts_type)
        self.block_steps = int(block_steps)
        self.member_offset = int(member_offset)
        # The vmapped step functions are built lazily in solve().
        # Sharded ensembles wrap the vmapped step in jax.shard_map
        # over the member mesh: each device runs the batched step on
        # its local members with ZERO collectives (the trajectories
        # are independent by construction — the compiled HLO is
        # collective-free, tests/test_ensemble.py).
        self._vstep = None
        self._vmulti = None
        self._vchunk = None
        self._vstep_flavor = None
        self._member_mesh = None
        self._member_axis = None
        self._vgroom = jax.jit(jax.vmap(self.ops.groom))
        self._vfallback = None
        self._vmax_fn = jax.jit(
            jax.vmap(
                lambda u, t: jnp.stack(
                    [jnp.max(jnp.abs(v)) for v in ops.velocity(u, t)]
                )
            )
        )
        # per-member state, filled by solve()
        self.u = None
        self.ts = self.hs = self.ks = None
        self.diverged = None
        self.snes_failures = None

    # -- monitors ---------------------------------------------------
    def add_monitor(self, monitor):
        """monitor(es, ks, ts, U) with per-member vectors, called after
        every outer iteration that accepted at least one member."""
        self.monitors.append(monitor)

    def monitor(self, ks, ts, U):
        for m in self.monitors:
            m(self, ks, ts, U)

    # -- vector h controller (elementwise Solver._new_h_*) ----------
    def _h_accept_vec(self, h, enorm):
        n = self.numerics
        expo = -1.0 / (self.tableau.order + 1)
        with np.errstate(divide="ignore", over="ignore",
                         invalid="ignore"):
            hfac = np.where(
                enorm <= 0.0,
                n.clip_high,
                n.safety * np.maximum(enorm, 1e-300) ** expo,
            )
        hfac = np.clip(hfac, n.clip_low, n.clip_high)
        return np.clip(h * hfac, n.dt_min, n.dt_max)

    def _h_reject_vec(self, h, enorm, finite):
        n = self.numerics
        expo = -1.0 / (self.tableau.order + 1)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            hfac = np.where(
                finite,
                np.clip(
                    n.safety
                    * np.where(finite, np.maximum(enorm, 1e-300), 1.0)
                    ** expo,
                    n.clip_low,
                    0.9,
                ),
                n.rollback_factor,
            )
        return np.maximum(h * hfac, n.dt_min)

    @staticmethod
    def _extract_member_mesh(U):
        """Classify the member placement of U for _build_steps.

        Returns a 1D Mesh for a shard_members-style NamedSharding over
        the leading member axis only (shard_map the batched step over
        it), else None (single device, or a sharding the plain jitted
        step handles transparently)."""
        from jax.sharding import NamedSharding

        sh = getattr(U, "sharding", None)
        if not isinstance(sh, NamedSharding) or len(sh.device_set) <= 1:
            return None
        mesh, spec = sh.mesh, sh.spec
        if len(mesh.axis_names) != 1:
            return None
        axis = mesh.axis_names[0]
        if len(spec) < 1 or spec[0] != axis:
            return None
        if any(s is not None for s in spec[1:]):
            return None
        if U.shape[0] % mesh.devices.size:
            return None
        return mesh

    def _wrap_members(self, vfn, n_in, n_out):
        """jit a member-batched device function, shard_mapped over the
        member mesh when one is active.  Every input and output is
        member-leading, so in/out specs are P(member_axis) throughout
        and the body is collective-free."""
        if self._member_mesh is None:
            return jax.jit(vfn)
        from jax.sharding import PartitionSpec

        spec = PartitionSpec(self._member_axis)
        return jax.jit(
            jax.shard_map(
                vfn, mesh=self._member_mesh,
                in_specs=(spec,) * n_in,
                out_specs=(spec,) * n_out if n_out > 1 else spec,
                check_vma=False,
            )
        )

    def _build_steps(self, member_mesh):
        """(Re)build the vmapped step functions for the input placement.

        member_mesh: None for members on one device (or a sharding the
        jitted step handles transparently); a 1D Mesh for members
        sharded over devices (solve() extracts it from the input
        sharding), which runs the SAME batched step inside shard_map
        over that mesh."""
        if member_mesh is not None:
            flavor = "smap:%s" % id(member_mesh)
            self._member_axis = member_mesh.axis_names[0]
        else:
            flavor = "plain"
            self._member_axis = None
        self._member_mesh = member_mesh
        if self._vstep_flavor == flavor:
            return
        nm = self.numerics
        step, _ = make_step_fn(
            self.ops, nm, atol=self.atol, rtol=self.rtol,
        )
        self._vstep = self._wrap_members(jax.vmap(step), 3, 2)
        self._vmulti = None
        if self.block_steps > 1 and nm.adapt_type == "none":
            from .solver import make_multistep_fn

            multi, _ = make_multistep_fn(
                self.ops, nm, atol=self.atol, rtol=self.rtol,
            )
            if self._member_mesh is None:
                self._vmulti = jax.jit(
                    jax.vmap(multi, in_axes=(0, 0, 0, None)),
                    static_argnums=3,
                )
            else:
                from jax.sharding import PartitionSpec

                spec = PartitionSpec(self._member_axis)
                mesh = self._member_mesh

                def _vmulti(U, ts, hs, nblk):
                    body = jax.vmap(
                        lambda u, t, h: multi(u, t, h, nblk)
                    )
                    return jax.shard_map(
                        body, mesh=mesh, in_specs=(spec,) * 3,
                        out_specs=(spec,) * 3, check_vma=False,
                    )(U, ts, hs)

                self._vmulti = jax.jit(_vmulti, static_argnums=3)
        # Device-fused adaptive chunk, vmapped over members: each
        # member walks its own accept/reject/h trajectory inside ONE
        # lax.while_loop execution (JAX's batched while_loop runs
        # until every member's cond exits, masking finished members),
        # so an adaptive ensemble pays one dispatch per chunk instead
        # of one per step.  Same eligibility as the scalar Solver.
        self._vchunk = None
        if (
            nm.device_loop
            and nm.adapt_type != "none"
            and nm.ksp_type != "banded"
            and "CFL_safety_factor" not in self.ps.tdfuncs
        ):
            from .solver import chunk_cfl_safety, make_adaptive_chunk_fn

            chunk, _ = make_adaptive_chunk_fn(
                self.ops, nm, atol=self.atol, rtol=self.rtol,
                max_attempts=128,
                cfl_safety=chunk_cfl_safety(self.ps),
            )
            self._vchunk = self._wrap_members(jax.vmap(chunk), 5, 6)
        self._vfallback = None
        self._vstep_flavor = flavor

    def _get_vfallback(self):
        if self.numerics.ksp_type not in ("richardson",):
            return None
        if self._vfallback is None:
            import dataclasses

            nm = dataclasses.replace(
                self.numerics, ksp_type="gmres_scipy",
                ksp_restart=12, ksp_max_it=4, stage_delta=False,
                # DIRK retries escalate the Newton count like the
                # scalar Solver._get_fallback (rosw ignores it)
                snes_iters=max(4, self.numerics.snes_iters),
            )
            fb, _ = make_step_fn(
                self.ops, nm, atol=self.atol, rtol=self.rtol,
            )
            self._vfallback = self._wrap_members(jax.vmap(fb), 3, 2)
        return self._vfallback

    # -- per-member physics helpers ---------------------------------
    def _cfl_maxh(self, U, ts):
        """Per-member max stable h (Solver.CFL_step vectorized)."""
        vmaxs = np.asarray(self._vmax_fn(U, jnp.asarray(ts)))
        sw = self.ops.grid.stencil_width
        sp = np.asarray(self.ops.grid.spacing)
        with np.errstate(divide="ignore"):
            hmaxs = np.where(vmaxs == 0.0, np.inf, sw * sp / vmaxs)
        return hmaxs.min(axis=1)

    def _cfl_clamp(self, U, ts, hs, active):
        # Constant factor (the usual case): ONE values0 read, no
        # per-member full-parameter evaluation on the hot host loop.
        if "CFL_safety_factor" in self.ps.tdfuncs:
            fn = self.ps.funcs["CFL_safety_factor"]
            sf = np.asarray([float(fn(float(t))) for t in ts])
        else:
            s0 = float(
                self.ps.values0.get("CFL_safety_factor", 0.0) or 0.0
            )
            if s0 <= 0.0:
                return hs
            sf = np.full(len(ts), s0)
        if not (sf > 0.0).any():
            return hs
        maxh = np.where(sf > 0.0, sf * self._cfl_maxh(U, ts), np.inf)
        return np.where(active, np.minimum(hs, maxh), hs)

    def _noise_active(self):
        from .solver import noise_active

        return noise_active(self.ps)

    def _inject_noise(self, U, ts, lastvart, accepted, conserve, Nw0):
        """Per-member geometric-Brownian injection (Solver.add_variance
        with an independent key chain per member; only injected members
        consume their chain)."""
        inject = np.zeros(len(ts), dtype=bool)
        sds = np.zeros(len(ts))
        # single-parameter funcs, not ps.values(): this runs per
        # accepted member per outer iteration
        vr_fn = self.ps.funcs["variance_rate"]
        vtf_fn = self.ps.funcs["variance_timing_function"]
        for i in np.nonzero(accepted)[0]:
            t, lv = float(ts[i]), float(lastvart[i])
            vrate = float(vr_fn(t) or 0.0)
            if vrate <= 0.0:
                continue
            if float(vtf_fn(t)) - float(vtf_fn(lv)) < 1.0:
                continue
            inject[i] = True
            sds[i] = np.sqrt(vrate * (t - lv))
        if not inject.any():
            return U, lastvart
        keys2 = jax.vmap(jax.random.split)(self._keys)
        subs = keys2[:, 1]
        stn = jax.vmap(
            lambda kk, uu: jax.random.normal(
                kk, uu[0].shape, dtype=uu.dtype
            )
        )(subs, U)
        mshape = (len(ts),) + (1,) * (U.ndim - 2)
        m = jnp.asarray(inject).reshape(mshape)
        rho = jnp.where(
            m,
            U[:, 0] * jnp.exp(jnp.asarray(sds).reshape(mshape) * stn),
            U[:, 0],
        )
        U = jnp.concatenate([rho[:, None], U[:, 1:]], axis=1)
        if conserve:
            corr = jnp.asarray(Nw0) / jnp.sum(
                U[:, 0], axis=tuple(range(1, U.ndim - 1))
            )
            corr = jnp.where(jnp.asarray(inject), corr, 1.0)
            U = jnp.concatenate(
                [(U[:, 0] * corr.reshape(mshape))[:, None], U[:, 1:]],
                axis=1,
            )
        # advance only the injected members' key chains
        self._keys = jnp.where(
            jnp.asarray(inject)[:, None], keys2[:, 0], self._keys
        )
        lastvart = np.where(inject, ts, lastvart)
        return U, lastvart

    # -- device-fused adaptive iteration ------------------------------
    def _post_accept(self, U, ts, hs, lastvart, mask, conserve, Nw0,
                     vrefresh):
        """The scalar Solver's post-accept sequence (noise -> groom ->
        refresh_G -> CFL clamp) applied to the members in ``mask``.
        groom/refresh_G are idempotent, so re-applying them to members
        outside the mask (whose states were groomed at their own last
        accept) is a mathematical no-op."""
        if self._noise_active():
            U, lastvart = self._inject_noise(
                U, ts, lastvart, mask, conserve, Nw0
            )
        U = self._vgroom(U)
        if vrefresh is not None:
            U = vrefresh(U, jnp.asarray(ts))
        hs = self._cfl_clamp(U, ts, hs, mask)
        return U, hs, lastvart

    def _chunk_iteration(self, U, ts, hs, ks, snes, consec, diverged,
                         lastvart, active, conserve, Nw0, vrefresh):
        """One vmapped adaptive-chunk dispatch (the -device_loop mode
        of the scalar Solver, per member): every active member runs up
        to 128 step attempts on device with its own h walk; inactive
        members get max_accepts=0 and no-op.  Each member's chunk is
        bounded at its next noise-injection time so injections land on
        the same accepted steps as the per-step host loop; a member
        already PAST its bound (its injection time was crossed while
        variance_rate <= 0 there, so lastvart could not advance) gets
        the scalar path's host-fallthrough semantics: an unbounded
        chunk limited to ONE accept per dispatch, so the injection
        check runs after every accepted step until it lands.  A member
        whose chunk exits STUCK (max_rejects consecutive rejections or
        non-finite enorm) gets one vmapped robust-fallback retry at
        its h — on the groomed/G-refreshed post-accept state, exactly
        like the scalar host path's next-iteration retry; unrescued
        members shrink h and count a failure."""
        n = self.numerics
        N = len(ts)
        # members parked on the robust fallback (hysteresis) skip the
        # chunk this iteration (max_accepts=0 no-ops them on device)
        # and take one host fallback step below — the scalar Solver's
        # _fb_mode arm of the device-loop controller
        fbm = active & self._fbm
        chunk_active = active & ~self._fbm
        kacc = np.zeros(N, dtype=np.int64)
        attempts = np.zeros(N, dtype=np.int64)
        rej = np.zeros(N, dtype=bool)
        # when every active member is parked in fallback hysteresis
        # the chunk would no-op (all max_accepts=0): skip the device
        # dispatch entirely, like the scalar Solver while _fb_mode
        # holds, and go straight to the host fallback step below
        if chunk_active.any():
            tmax_eff = np.full(N, self.tmax)
            if self._noise_active():
                from .solver import next_noise_time

                for i in np.nonzero(chunk_active)[0]:
                    tn = next_noise_time(
                        self.ps, float(lastvart[i]), self.tmax
                    )
                    if tn is not None and tn < tmax_eff[i]:
                        tmax_eff[i] = tn
            max_acc = np.where(
                chunk_active, self.maxsteps - ks, 0
            ).astype(np.int32)
            straddled = chunk_active & (tmax_eff < ts)
            if straddled.any():
                tmax_eff = np.where(straddled, self.tmax, tmax_eff)
                max_acc = np.where(
                    straddled, np.minimum(max_acc, 1), max_acc
                ).astype(np.int32)
            u1, t1, h1, kacc, attempts, rej = self._vchunk(
                U, jnp.asarray(ts), jnp.asarray(hs),
                jnp.asarray(tmax_eff), jnp.asarray(max_acc),
            )
            kacc = np.asarray(kacc)
            attempts = np.asarray(attempts)
            rej = np.asarray(rej)
            logENS("vchunk accepted/attempts", kacc, attempts)
            # on-device rejections count as solve failures (parity
            # with the reference's SNES-failure accounting)
            snes = snes + np.where(
                active, np.maximum(0, attempts - kacc), 0
            )
            sel = jnp.asarray(active).reshape(
                (N,) + (1,) * (U.ndim - 1)
            )
            U = jnp.where(sel, u1, U)
            ts = np.where(active, np.asarray(t1), ts)
            hs = np.where(active, np.asarray(h1), hs)
            ks = ks + np.where(active, kacc, 0)
        anyacc = active & (kacc > 0)
        consec = np.where(anyacc, 0, consec)
        if anyacc.any():
            U, hs, lastvart = self._post_accept(
                U, ts, hs, lastvart, anyacc, conserve, Nw0, vrefresh
            )
        stuck = chunk_active & rej
        # the scalar controller's _chunk_rej_streak, per member: a
        # zero-accept rejection doubles the next fallback-probe length
        # so a persistently-marginal member settles into fallback
        # stepping instead of paying a wasted chunk dispatch per step
        self._rejstreak = np.where(
            stuck & (kacc == 0),
            self._rejstreak + 1,
            np.where(chunk_active, 0, self._rejstreak),
        )
        need_fb = stuck | fbm
        if need_fb.any():
            vfb = self._get_vfallback()
            ebn = np.full(N, np.nan)
            rescued = np.zeros(N, dtype=bool)
            if vfb is not None:
                if stuck.any():
                    logENS("vchunk stuck members", np.nonzero(stuck)[0])
                    # stuck members engage fallback mode at the
                    # streak-scaled probe (min(64, 2**streak))
                    self._fbprobe = np.where(
                        stuck,
                        np.minimum(
                            64, 1 << np.minimum(self._rejstreak, 6)
                        ),
                        self._fbprobe,
                    )
                    self._fbacc = np.where(stuck, 0, self._fbacc)
                    self._fbm = self._fbm | stuck
                u1b, eb = vfb(U, jnp.asarray(ts), jnp.asarray(hs))
                ebn = np.asarray(eb)
                rescued = need_fb & np.isfinite(ebn) & (ebn <= 1.0)
                if rescued.any():
                    logENS(
                        "fallback accepted members",
                        np.nonzero(rescued)[0],
                    )
                    selr = jnp.asarray(rescued).reshape(
                        (N,) + (1,) * (U.ndim - 1)
                    )
                    U = jnp.where(selr, u1b, U)
                    ts = np.where(rescued, ts + hs, ts)
                    ks = ks + rescued
                    anyacc = anyacc | rescued
                    consec = np.where(rescued, 0, consec)
                    hs = np.where(
                        rescued, self._h_accept_vec(hs, ebn), hs
                    )
                    U, hs, lastvart = self._post_accept(
                        U, ts, hs, lastvart, rescued, conserve, Nw0,
                        vrefresh,
                    )
                    # hysteresis: exit fallback mode after fb_probe
                    # accepts (the rescue counts as the first)
                    self._fbacc = np.where(
                        rescued, self._fbacc + 1, self._fbacc
                    )
                    leave = rescued & (
                        self._fbacc % np.maximum(self._fbprobe, 1) == 0
                    )
                    self._fbm = self._fbm & ~leave
            failed = need_fb & ~rescued
            snes = snes + failed
            consec = np.where(failed, consec + 1, consec)
            hs = np.where(
                failed,
                self._h_reject_vec(hs, ebn, np.isfinite(ebn)),
                hs,
            )
            # a one-shot-probe member whose retry failed hands the
            # (shrunk) h back to the fused chunk (scalar: _fb_probe==1)
            self._fbm = self._fbm & ~(failed & (self._fbprobe <= 1))
            diverged = diverged | (consec > n.max_snes_failures)
        if anyacc.any():
            self.u = U
            self.ks, self.ts, self.hs = ks, ts, hs
            self.monitor(ks, ts, U)
        return U, ts, hs, ks, snes, consec, diverged, lastvart

    # -- the loop ----------------------------------------------------
    def solve(self, U0):
        """Integrate every member to tmax/maxsteps.  Returns a
        SimpleNamespace with per-member u, t, h, k, diverged,
        snes_failures (and leaves the same on self)."""
        n = self.numerics
        adapt = n.adapt_type != "none"
        U = jnp.asarray(U0)
        N = U.shape[0]
        self._build_steps(self._extract_member_mesh(U))
        vrefresh = None
        if hasattr(self.ops, "refresh_G"):
            vrefresh = jax.jit(jax.vmap(self.ops.refresh_G))
        U = self._vgroom(U)
        if vrefresh is not None:
            U = vrefresh(U, jnp.full(N, self.t0))
        ts = np.full(N, self.t0)
        hs = np.full(N, min(max(self.dt0, n.dt_min), n.dt_max))
        ks = np.zeros(N, dtype=int)
        diverged = np.zeros(N, dtype=bool)
        consec = np.zeros(N, dtype=int)
        snes = np.zeros(N, dtype=int)
        # per-member fallback hysteresis (the scalar controller's
        # _fb_mode/_fb_accepts/_fb_probe/_chunk_rej_streak, Solver):
        # a member whose step the robust solver rescued STAYS on it
        # for fb_probe accepts before probing the fast path again
        self._fbm = np.zeros(N, dtype=bool)
        self._fbacc = np.zeros(N, dtype=int)
        self._fbprobe = np.full(N, 64, dtype=int)
        self._rejstreak = np.zeros(N, dtype=int)
        self._keys = jax.vmap(jax.random.fold_in)(
            jnp.broadcast_to(self.rng_key, (N,) + self.rng_key.shape),
            jnp.arange(N) + self.member_offset,
        )
        lastvart = np.full(N, self.t0)
        conserve = self.ps.params0["conserve_worms"]
        conserve = False if conserve == "False" else bool(conserve)
        Nw0 = np.asarray(
            jnp.sum(U[:, 0], axis=tuple(range(1, U.ndim - 1)))
        )
        hs = self._cfl_clamp(U, ts, hs, np.ones(N, dtype=bool))
        self.u = U
        self.ks, self.ts, self.hs = ks, ts, hs
        self.monitor(ks, ts, U)
        while True:
            active = (
                ~diverged
                & (ks < self.maxsteps)
                & (ts <= self.tmax)
                & (hs >= self.hmin)
            )
            if not active.any():
                break
            if self._vchunk is not None:
                U, ts, hs, ks, snes, consec, diverged, lastvart = (
                    self._chunk_iteration(
                        U, ts, hs, ks, snes, consec, diverged,
                        lastvart, active, conserve, Nw0, vrefresh,
                    )
                )
                continue
            nblk = 1
            if self._vmulti is not None:
                nblk = max(
                    1,
                    min(
                        self.block_steps,
                        self.maxsteps - int(ks[active].max()),
                    ),
                )
            if nblk > 1:
                # fused fixed-dt blocks (noise/CFL/monitors act at
                # block boundaries, like the scalar block mode)
                u1, _, enorm = self._vmulti(
                    U, jnp.asarray(ts), jnp.asarray(hs), nblk
                )
            else:
                u1, enorm = self._vstep(
                    U, jnp.asarray(ts), jnp.asarray(hs)
                )
            e = np.asarray(enorm)
            finite = np.isfinite(e)
            rejected = active & (
                (~finite) | (adapt & (e > 1.0))
            )
            fbm = active & self._fbm
            if (
                nblk == 1
                and ((rejected & ~self._fbm).any() or fbm.any())
                and self._get_vfallback() is not None
            ):
                u1b, eb = self._get_vfallback()(
                    U, jnp.asarray(ts), jnp.asarray(hs)
                )
                ebn = np.asarray(eb)
                # members IN fallback mode take the robust result as
                # THE step (the scalar loop never runs the fast step
                # while _fb_mode holds); rejected fast-path members get
                # the same-h robust retry and ENGAGE fallback mode
                rescued = (
                    rejected
                    & ~self._fbm
                    & np.isfinite(ebn)
                    & ((ebn <= 1.0) | (not adapt))
                )
                if rescued.any():
                    logENS("fallback rescued members", np.nonzero(rescued)[0])
                    self._fbm = self._fbm | rescued
                    self._fbacc = np.where(rescued, 0, self._fbacc)
                    self._fbprobe = np.where(rescued, 64, self._fbprobe)
                take_fb = fbm | rescued
                sel = jnp.asarray(take_fb).reshape(
                    (N,) + (1,) * (U.ndim - 1)
                )
                u1 = jnp.where(sel, u1b, u1)
                e = np.where(take_fb, ebn, e)
                finite = np.isfinite(e)
                rejected = active & (
                    (~finite) | (adapt & (e > 1.0))
                )
            accepted = active & ~rejected
            # hysteresis bookkeeping: after fb_probe accepts on the
            # robust solver, probe the fast path again
            fb_acc = accepted & self._fbm
            self._fbacc = np.where(fb_acc, self._fbacc + 1, self._fbacc)
            leave = fb_acc & (
                self._fbacc % np.maximum(self._fbprobe, 1) == 0
            )
            self._fbm = self._fbm & ~leave
            snes += rejected
            consec = np.where(rejected, consec + 1, 0)
            diverged |= consec > n.max_snes_failures
            # commit accepted members
            if accepted.any():
                sel = jnp.asarray(accepted).reshape(
                    (N,) + (1,) * (U.ndim - 1)
                )
                U = jnp.where(sel, u1, U)
                ts = np.where(accepted, ts + nblk * hs, ts)
                ks = ks + nblk * accepted
            if adapt:
                hs = np.where(
                    accepted,
                    self._h_accept_vec(hs, e),
                    np.where(
                        rejected,
                        self._h_reject_vec(hs, e, finite),
                        hs,
                    ),
                )
            else:
                hs = np.where(
                    rejected, self._h_reject_vec(hs, e, finite), hs
                )
                # fixed-dt semantics: restore the nominal dt on accept
                hs = np.where(
                    accepted,
                    min(max(self.dt0, n.dt_min), n.dt_max),
                    hs,
                )
            if accepted.any():
                if self._noise_active():
                    U, lastvart = self._inject_noise(
                        U, ts, lastvart, accepted, conserve, Nw0
                    )
                U = self._vgroom(U)
                if vrefresh is not None:
                    U = vrefresh(U, jnp.asarray(ts))
                hs = self._cfl_clamp(U, ts, hs, accepted)
                self.u = U
                self.ks, self.ts, self.hs = ks, ts, hs
                self.monitor(ks, ts, U)
        self.u = U
        self.ts, self.hs, self.ks = ts, hs, ks
        self.diverged = diverged
        self.snes_failures = snes
        return SimpleNamespace(
            u=U, t=ts, h=hs, k=ks, diverged=diverged,
            snes_failures=snes,
        )
