"""The Keller-Segel PDE operator: RHS, free energy G, velocity, J-action.

This is the counterpart of the reference's Derivatives class
(KSFD/ksfdsym.py:145-1209).  The same math, assembled symbolically:

- free energy   G = V(U..) + Vcap(rho) + s2*log(rho)
                (KSFD/ksfdsym.py:983-990)
- worm density  drho/dt = grad(rho).grad(G) + rho*laplacian(G)
                (= div(rho grad G); product rule as in
                KSFD/ksfdsym.py:531-571) + source
- each ligand   dU/dt = -gamma*U + s*rho + D*laplacian(U) + source
                (KSFD/ksfdsym.py:583-613)
- velocity      v = grad(G)   (KSFD/ksfdsym.py:1158-1209)

but compiled differently: the pointwise nonlinearity (G) is a
sympy->JAX function and the stencil operators are shifted-array linear
combinations, all fused by XLA into device kernels under jit.  The
analytically assembled sparse Jacobian + ksfdMat machinery
(KSFD/ksfdsym.py:630-886) is replaced by the exact matrix-free
Jacobian action ``jax.jvp(rhs)``; its stiff constant-coefficient part
is exposed via ``stiff_coefficients`` for the spectral preconditioner.

Time-dependent parameters are evaluated *inside* jit from the traced
time via their resolved expressions (the analog of the reference's
time_dependent_symbols split, KSFD/ksfdsoln.py:244-252).
"""

import numbers

import jax
import jax.numpy as jnp
import sympy as sy

from ..utils.debug import logger
from ..utils.exceptions import KSFDException
from ..utils.symbolic import jaxify
from .spatial import SpatialExpression
from .stencil import (
    deriv_apply,
    deriv_coeffs,
    grad_apply,
    laplacian_apply,
    laplacian_symbol,
)

logSYM = logger("SYM")

__all__ = ["PDEOperators"]

_T = sy.Symbol("t")


class PDEOperators:
    """Callable PDE operators for one problem on one grid.

    Parameters
    ----------
    ps : SolutionParameters
    grid : Grid with dof == ps.nligands + 1
    sources : optional list of nligands+1 source terms (expressions /
        SpatialExpressions), rho first.
    """

    def __init__(self, ps, grid, sources=None, flux_form=False):
        """``flux_form=False`` reproduces the reference discretization
        (product rule: grad(rho).grad(G) + rho*lap(G),
        KSFD/ksfdsym.py:531-571), which does not conserve sum(rho)
        exactly at the discrete level (the reference carries a
        commented-out correction for this, KSFD/ksfdsym.py:806-808).
        ``flux_form=True`` uses the conservative divergence-of-flux
        discretization sum_d D1_d(rho * D1_d(G)), which conserves
        sum(rho) to roundoff by antisymmetry of the D1 stencil."""
        self.ps = ps
        self.grid = grid
        self.dim = grid.dim
        self.sw = grid.stencil_width
        self.spacing = tuple(float(h) for h in grid.spacing)
        self.flux_form = bool(flux_form)
        self.nligands = ps.nligands
        if grid.dof != ps.nligands + 1:
            raise KSFDException(
                "grid.dof=%d but problem has %d fields"
                % (grid.dof, ps.nligands + 1)
            )
        if sources is None:
            sources = [0.0] * (ps.nligands + 1)
        self.sources = [
            s if isinstance(s, SpatialExpression) else SpatialExpression(ps, grid, s)
            for s in sources
        ]
        self._source_active = [not s.is_zero() for s in self.sources]

        # groom bounds are t0 values, as in the reference
        # (KSFD/ksfdsym.py:888-900)
        self.rhomin = float(ps.values0["rhomin"])
        self.Umin = float(ps.values0["Umin"])

        self._build_G()
        self._build_ligand_coeffs()
        self._build_s2()

    # ------------------------------------------------------------------
    def _resolve_td(self, expr, allowed=()):
        """Substitute time-dependent parameter symbols with their
        resolved expressions in t; returns (expr_in_t, is_time_dep).

        ``allowed`` lists extra symbols (field names) that may remain.
        """
        if isinstance(expr, numbers.Number):
            return sy.Float(float(expr)), False
        allowed = set(allowed) | {_T}
        resolved = self.ps.resolved
        for _ in range(4):
            free = [s for s in expr.free_symbols if s not in allowed]
            if not free:
                break
            subs = {s: resolved[str(s)] for s in free if str(s) in resolved}
            if not subs:
                break
            expr = expr.subs(subs)
        extra = [s for s in expr.free_symbols if s not in allowed]
        if extra:
            raise KSFDException(
                "unresolved symbols {s} in PDE coefficient {e!r}".format(
                    s=sorted(map(str, extra)), e=str(expr)
                )
            )
        return expr, _T in expr.free_symbols

    def _build_G(self):
        """Compile the pointwise free energy G(rho, U..., t)."""
        ps = self.ps
        rho = sy.Symbol("rho")
        Us = [sy.Symbol(lig.name()) for lig in ps.Vgroups.ligands()]
        params = ps.time_dependent_symbols()  # constants folded, TD symbolic
        Gexp = ps.V(Us, rho, params=params) + params["s2"] * sy.log(rho)
        Gexp, self._G_tdep = self._resolve_td(Gexp, allowed=[rho] + Us)
        self.G_expr = Gexp
        self._G_fn = jaxify([rho] + Us + [_T], Gexp, name="G")
        # partial derivatives of G w.r.t. each field, used by the
        # block-spectral preconditioner's mean-state linearization
        fields = [rho] + Us
        self._dG_fns = [
            jaxify(fields + [_T], sy.diff(Gexp, f), name="dG_d" + str(f))
            for f in fields
        ]
        # cancellation-free increment form G(u + d) - G(u) (the
        # pointwise core of rhs_delta); None when the
        # expression has no known rewrite (ops/delta.py).  Signature:
        # (fields0..., deltas..., shifted_fields..., t) — the shifted
        # state is a separate input so float32 evaluation survives
        # clamp-to-floor increments (see delta_expr).
        from .delta import UnsupportedDelta, delta_expr, jaxify_delta

        dfields = [sy.Symbol("_d_" + str(f)) for f in fields]
        sfields = [sy.Symbol("_s_" + str(f)) for f in fields]
        try:
            Gdelta = delta_expr(
                Gexp,
                dict(zip(fields, dfields)),
                shifted_map=dict(zip(fields, sfields)),
            )
            self._G_delta_fn = jaxify_delta(
                fields + dfields + sfields + [_T], Gdelta, name="G_delta"
            )
        except UnsupportedDelta:
            self._G_delta_fn = None

    def _build_ligand_coeffs(self):
        """Per-ligand gamma/s/D as JAX functions of t (TD-aware)."""
        self._lig_coeffs = []
        self._lig_tdep = False
        for lig in self.ps.Vgroups.ligands():
            coeffs = {}
            for cname, val in (("gamma", lig.gamma), ("s", lig.s), ("D", lig.D)):
                expr = sy.sympify(val)
                expr, tdep = self._resolve_td(expr)
                if tdep:
                    coeffs[cname] = jaxify((_T,), expr, name=cname)
                    self._lig_tdep = True
                else:
                    const = float(expr)
                    coeffs[cname] = lambda t, c=const: c
            self._lig_coeffs.append(coeffs)

    def stage_delta_ok(self):
        """True when stage RHS evaluations may use the increment form
        f(u0 + d) = f(u0) + rhs_delta(...), i.e. the free energy has an
        increment rewrite, the drift uses the product-rule form that
        rhs_delta differentiates, and the PDE coefficients carry no
        explicit time dependence (the stages sit at shifted times
        t + alpha_i*h; time-dependent SOURCES are corrected exactly by
        the solver)."""
        return (
            self._G_delta_fn is not None
            and not self.flux_form
            and not self._G_tdep
            and not self._lig_tdep
        )

    def _mean_groomed(self, u, i):
        """float64 mean of field i over its groomed (floor-clamped,
        NaN -> floor) view, as ops.rhs sees the state."""
        lo = self.rhomin if i == 0 else self.Umin
        f = u[i].astype(jnp.float64)
        return jnp.mean(jnp.where(f >= lo, f, lo))

    def rhs_delta(self, u0, d, u1, t):
        """The source-free increment rhs(u1) - rhs(u0) in float32,
        accurate to ~f32 eps RELATIVE TO THE INCREMENT.

        u0 must be groomed; u1 = groom(u0 + inc) and d = u1 - u0 are
        formed in f64 by the caller (u1 is passed separately: f32(u0)
        + f32(d) cannot recover a clamped-to-floor u1).  Product rule
        of div(rho grad G) for the increment:

          d(drho) = grad(d_rho).grad(Gs) + grad(rho0c).grad(dG)
                  + d_rho*lap(Gs) + rho0*lap(dG),   Gs = G0c + dG,

        where dG is the cancellation-free increment of G (ops/delta.py)
        and G0c, rho0c are centred on their f64 means, so no stencil
        ever differences the O(1e4) fields themselves in float32.
        Requires stage_delta_ok().
        """
        f32 = jnp.float32
        nf = self.nligands + 1
        means = [self._mean_groomed(u0, i) for i in range(nf)]
        G_mean = self._G_fn(*means, t).astype(f32)
        t = jnp.asarray(t, f32)
        u0, d, u1 = (a.astype(f32) for a in (u0, d, u1))
        rho0, Us0 = u0[0], [u0[1 + l] for l in range(nf - 1)]
        drho, dUs = d[0], [d[1 + l] for l in range(nf - 1)]
        dG = self._G_delta_fn(
            rho0, *Us0, drho, *dUs, *[u1[i] for i in range(nf)], t
        )
        Gs = self._G_fn(rho0, *Us0, t) - G_mean + dG
        rho0c = rho0 - means[0].astype(f32)
        grad = lambda f: grad_apply(f, self.spacing, self.sw)
        lap = lambda f: laplacian_apply(f, self.spacing, self.sw)
        graddot = lambda a, b: sum(
            x * y for x, y in zip(grad(a), grad(b))
        )
        outs = [
            graddot(drho, Gs) + graddot(rho0c, dG)
            + drho * lap(Gs) + rho0 * lap(dG)
        ]
        for l, c in enumerate(self._lig_coeffs):
            outs.append(
                -c["gamma"](t) * dUs[l] + c["s"](t) * drho
                + c["D"](t) * lap(dUs[l])
            )
        return jnp.stack(outs, axis=0)

    # ------------------------------------------------------------------
    def groom(self, u):
        """Clamp rho >= rhomin, U >= Umin; NaN -> min (traceable).

        Reference: KSFD/ksfdsym.py:888-900.
        """
        rho = u[0]
        rho = jnp.where(jnp.isnan(rho), self.rhomin, rho)
        rho = jnp.maximum(rho, self.rhomin)
        Us = u[1:]
        Us = jnp.where(jnp.isnan(Us), self.Umin, Us)
        Us = jnp.maximum(Us, self.Umin)
        return jnp.concatenate([rho[None], Us], axis=0)

    def G(self, u, t=None):
        """Pointwise free energy of a (groomed) state array."""
        t = self.ps.t0 if t is None else t
        fields = [u[i] for i in range(self.nligands + 1)]
        return self._G_fn(fields[0], *fields[1:], t)

    def rhs(self, u, t, groom=True):
        """du/dt of the full system.  Traceable; u: (dof, *Sshape)."""
        if groom:
            u = self.groom(u)
        rho = u[0]
        G = self.G(u, t)
        grad_G = grad_apply(G, self.spacing, self.sw)
        if self.flux_form:
            # conservative: drho = sum_d D1_d(rho * dG/dx_d)
            drho = None
            for d, gG in enumerate(grad_G):
                div_d = deriv_apply(rho * gG, d, self.spacing, self.sw)
                drho = div_d if drho is None else drho + div_d
        else:
            grad_rho = grad_apply(rho, self.spacing, self.sw)
            lap_G = laplacian_apply(G, self.spacing, self.sw)
            drho = (
                sum(gr * gG for gr, gG in zip(grad_rho, grad_G)) + rho * lap_G
            )
        if self._source_active[0]:
            drho = drho + self.sources[0](t).astype(drho.dtype)
        outs = [drho]
        for l in range(self.nligands):
            U = u[1 + l]
            c = self._lig_coeffs[l]
            dU = (
                -c["gamma"](t) * U
                + c["s"](t) * rho
                + c["D"](t) * laplacian_apply(U, self.spacing, self.sw)
            )
            if self._source_active[1 + l]:
                dU = dU + self.sources[1 + l](t).astype(dU.dtype)
            outs.append(dU)
        return jnp.stack(outs, axis=0)

    # reference-compatible name
    def dfdt(self, u, t=None):
        return self.rhs(u, self.ps.t0 if t is None else t)

    def velocity(self, u, t=None):
        """Worm velocity grad(G): shape (dim, *Sshape).

        Reference: KSFD/ksfdsym.py:1188-1209.
        """
        t = self.ps.t0 if t is None else t
        u = self.groom(u)
        G = self.G(u, t)
        return jnp.stack(grad_apply(G, self.spacing, self.sw), axis=0)

    def jacobian_action(self, u, t, v, groom=True):
        """Exact Jacobian-vector product d(rhs)/du @ v via jax.jvp.

        The matrix-free replacement of the assembled sparse Jacobian +
        MatSetValuesStencil path (KSFD/ksfdsym.py:630-886,
        cython/ksfdMat/ksfdMat.pyx).
        """
        _, jv = jax.jvp(lambda uu: self.rhs(uu, t, groom=groom), (u,), (v,))
        return jv

    # ------------------------------------------------------------------
    def stiff_coefficients(self, t):
        """(diffusion, decay) per field for the spectral preconditioner.

        The stiff linear-in-Fourier part of the operator:
        - rho: the self-diffusion s2*laplacian(rho) hidden in
          div(rho grad(s2 log rho)); decay 0.
        - ligand l: D_l*laplacian - gamma_l.

        Traceable in t.  Cross-field coupling (chemotaxis) is left to
        the Krylov iteration.
        """
        s2 = self._s2_fn(t)
        diff = [s2]
        decay = [jnp.zeros_like(jnp.asarray(s2, dtype=jnp.result_type(float)))]
        for c in self._lig_coeffs:
            diff.append(c["D"](t))
            decay.append(c["gamma"](t))
        return diff, decay

    def _build_s2(self):
        """Resolve the s2 coefficient eagerly (like the ligand
        coefficients): a host-side sympy resolution must not happen
        mid-trace, and a missing s2 should error at construction."""
        expr, tdep = self._resolve_td(sy.Symbol("s2"))
        if tdep:
            self._s2_fn = jaxify((_T,), expr, name="s2")
        else:
            const = float(expr)
            self._s2_fn = lambda tt, c=const: c

    def laplacian_symbol(self):
        """DFT eigenvalues of the discrete Laplacian on this grid."""
        return laplacian_symbol(self.grid.nps, self.spacing, self.sw)

    def linearization_coefficients(self, means, t):
        """Mean-state linearization data for the block preconditioner.

        means: per-field mean values (traceable scalars), rho first.
        Returns (dG, s, gamma, D): dG[i] = dG/dfield_i at the means;
        s/gamma/D per ligand at time t.  The per-Fourier-mode Jacobian
        of the uniform-state linearization is then

          J_rho,i(lam) = rho_mean * lam * dG[i]
          J_Ul,rho     = s_l ;  J_Ul,Ul = -gamma_l + D_l*lam.
        """
        dG = [fn(*means, t) for fn in self._dG_fns]
        s = [c["s"](t) for c in self._lig_coeffs]
        gamma = [c["gamma"](t) for c in self._lig_coeffs]
        D = [c["D"](t) for c in self._lig_coeffs]
        return dG, s, gamma, D
