"""Linear solvers for the implicit stages: the MUMPS-LU replacement.

Each Rosenbrock-W stage needs (shift*I - J) y = b with J the RHS
Jacobian.  The reference solves this with a parallel sparse direct LU
(MUMPS) under PETSc KSP preonly (/root/reference/options84 PETSc
block).  Strategy here:

- ``gmres``: matrix-free restarted GMRES (J action via jax.jvp), right
  thing at scale.  Preconditioned by the *exact* inverse of the stiff
  constant-coefficient part: on the periodic uniform grid every
  per-field operator (shift + gamma_f - D_f*Laplacian) is diagonal in
  Fourier space (ops/stencil.py laplacian_symbol is the exact DFT
  symbol of the discrete stencil, not the continuum symbol).  For the
  linear ligand fields the preconditioner *is* the exact inverse, so
  Krylov work is driven only by the rho-row nonlinearity.

- ``dense``: exact dense LU (jax.scipy lu_factor/lu_solve) of the full
  Jacobian built by jacfwd.  This is the MUMPS-parity path for small
  1D problems (the reference's options92/93 gates are 384 dofs) and
  the correctness oracle for the Krylov path.
"""


import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl

from ..utils.debug import logger

logLIN = logger("LINALG")

__all__ = [
    "SpectralPreconditioner",
    "BlockSpectralPreconditioner",
    "make_sharded_block_apply",
    "gmres_solve",
    "dense_solve_factory",
]


# Matmul precision of the preconditioner's basis transforms.  The pc
# is an approximate inverse: its rounding moves only the Richardson
# contraction rate (~0.1 per sweep), never the fixed point.  HIGH lets
# float32 operands run as TF32 on NVIDIA tensor cores (10-bit mantissa,
# ~1e-3 relative), far inside that margin, at several times the
# rate of full-f32 (HIGHEST) products; CPU backends compute f32
# exactly either way.  bf16 and f64 operands ignore it.
PC_PRECISION = jax.lax.Precision.HIGH


class SpectralPreconditioner:
    """M^{-1} for W = shift*I - J, inverting the per-field stiff part.

    Per field f the stiff operator is decay_f - diff_f*Laplacian; on
    the periodic uniform grid the discrete Laplacian is a symmetric
    circulant per axis, diagonalized EXACTLY by the orthonormal real
    DFT basis (ops/stencil.py real_dft_basis).  The transform is
    applied as per-axis matmuls with that basis — float64-capable,
    layout-robust, and sharding-transparent (XLA partitions the
    einsums).

    lam (<= 0) makes What_f = shift + decay_f - diff_f*lam >= shift
    > 0: never singular.
    """

    def __init__(self, grid, compute_dtype=None, use_fft=False):
        """compute_dtype: dtype of the transform matmuls.  The
        preconditioner is an approximate inverse, so float32 is the
        default — the basis matmuls run at the matrix units' rate
        while the iteration itself stays in the solve dtype; only the
        convergence rate is (marginally) affected, never the
        solution.

        bfloat16 runs the TRANSFORM matmuls on bf16 operands AND
        stores the transform intermediates/coefficients in bf16
        (preferred_element_type=bfloat16), while all mode-space
        arithmetic (denominators, Schur complement) is computed in
        float32 from the bf16 coefficients — bf16 rounding perturbs
        M^{-1} by ~1e-2 relative, far inside the Richardson
        contraction margin, but bf16 DENOMINATOR arithmetic would be
        fatal (mode stiffness spans ~6 orders).  Sharded, the bf16
        storage halves the all-reduce wire bytes of the pc floor
        (tests/test_comm_audit.py).

        use_fft: apply the SAME circulant inverse through rfftn/irfftn
        instead of the basis matmuls — O(n log n) per axis instead of
        O(n^2), a ~100x FLOP cut at 1536^2 where the 16-sweep stage
        solves make the transforms the dominant step cost.  Exact up
        to f32 rounding (the complex DFT diagonalizes every circulant;
        laplacian_symbol is the same discrete-stencil symbol the
        matmul basis uses).  f32-only (an approximate inverse needs no
        more) and single-shard only (an FFT along a sharded axis would gather;
        the einsum path shards transparently) — make_step_fn gates it
        accordingly (-pc_fft auto|on|off)."""
        from ..ops.stencil import laplacian_eigendecomp, laplacian_symbol

        self.sshape = tuple(grid.Sshape)
        self.dim = grid.dim
        self.use_fft = bool(use_fft)
        compute_dtype = jnp.dtype(compute_dtype or jnp.float32)
        self.transform_dtype = compute_dtype
        self.compute_dtype = (
            jnp.float32
            if compute_dtype == jnp.bfloat16
            else compute_dtype
        )
        # bf16 mode keeps the GEMM outputs (intermediates, mode
        # coefficients) in bf16 storage; otherwise they match the
        # mode-arithmetic dtype
        self._interm_dtype = (
            jnp.bfloat16
            if compute_dtype == jnp.bfloat16
            else self.compute_dtype
        )
        if self.use_fft:
            # FFT mode is f32-only: clamp the mode-arithmetic dtype so
            # an f64 pc_dtype cannot promote the complex64 rfftn
            # coefficients to complex128.
            self.compute_dtype = jnp.float32
            self.Qs = None
            self.lam = jnp.asarray(
                laplacian_symbol(
                    [int(n) for n in grid.nps],
                    [float(s) for s in grid.spacing],
                    grid.stencil_width,
                ),
                dtype=jnp.float32,
            )
            return
        sw = grid.stencil_width
        Qs, lams = [], []
        for d in range(grid.dim):
            Q, lam = laplacian_eigendecomp(
                int(grid.nps[d]), float(grid.spacing[d]), sw
            )
            Qs.append(jnp.asarray(Q, dtype=self.transform_dtype))
            lams.append(lam)
        self.Qs = Qs
        # total eigenvalue per spatial mode: lam_x (+ lam_y (+ lam_z))
        total = lams[0]
        for d in range(1, grid.dim):
            total = total[..., None] + lams[d]
        self.lam = jnp.asarray(total)

    def _forward(self, v):
        # v: (dof, *sshape) -> spectral coefficients.  FFT mode:
        # complex64 rfftn coefficients (last axis truncated to
        # n//2+1); matmul mode: real coefficients, same shape as v.
        if self.use_fft:
            axes = tuple(range(1, 1 + self.dim))
            return jnp.fft.rfftn(v.astype(jnp.float32), axes=axes)
        # Inputs are cast to the transform dtype.  f32/f64 transforms
        # accumulate and return coefficients in compute_dtype; bf16
        # transforms also STORE intermediates/coefficients in bf16;
        # mode arithmetic upcasts to f32 at its use sites.
        v = v.astype(self.transform_dtype)
        kw = dict(
            preferred_element_type=self._interm_dtype,
            precision=PC_PRECISION,
        )
        if self.dim == 1:
            return jnp.einsum("fi,ik->fk", v, self.Qs[0], **kw)
        if self.dim == 2:
            return jnp.einsum(
                "fij,ik,jl->fkl", v, self.Qs[0], self.Qs[1], **kw
            )
        return jnp.einsum(
            "fijm,ik,jl,mn->fkln",
            v, self.Qs[0], self.Qs[1], self.Qs[2], **kw,
        )

    def _inverse(self, c):
        if self.use_fft:
            axes = tuple(range(1, 1 + self.dim))
            return jnp.fft.irfftn(c, s=self.sshape, axes=axes)
        c = c.astype(self.transform_dtype)
        # the FINAL inverse-transform output feeds f32/f64 consumers:
        # accumulate/store it in compute_dtype even in bf16 mode (the
        # caller casts to the solve dtype; a bf16 final result would
        # round the preconditioned residual itself, not just M^{-1})
        kw = dict(
            preferred_element_type=self.compute_dtype,
            precision=PC_PRECISION,
        )
        if self.dim == 1:
            return jnp.einsum("fk,ik->fi", c, self.Qs[0], **kw)
        if self.dim == 2:
            return jnp.einsum(
                "fkl,ik,jl->fij", c, self.Qs[0], self.Qs[1], **kw
            )
        return jnp.einsum(
            "fkln,ik,jl,mn->fijm",
            c, self.Qs[0], self.Qs[1], self.Qs[2], **kw,
        )

    def apply(self, v, shift, diff, decay):
        """v: (dof, *sshape); diff/decay: per-field scalars (traceable)."""
        in_dtype = v.dtype
        cd = self.compute_dtype
        c = self._forward(v.astype(cd))
        diff = jnp.stack([jnp.asarray(d, dtype=cd) for d in diff])
        decay = jnp.stack([jnp.asarray(d, dtype=cd) for d in decay])
        denom = (
            jnp.asarray(shift, dtype=cd)
            + decay.reshape((-1,) + (1,) * self.dim)
            - diff.reshape((-1,) + (1,) * self.dim)
            * self.lam.astype(cd)
        )
        return self._inverse(c / denom).astype(in_dtype)


class BlockSpectralPreconditioner(SpectralPreconditioner):
    """Per-mode EXACT inverse of the mean-state linearization.

    The diagonal SpectralPreconditioner inverts only each field's own
    diffusion/decay; this one also inverts the chemotaxis coupling of
    the PDE system linearized at the spatial means of the current
    state: per Fourier mode (Laplacian eigenvalue lam <= 0) the
    (dof x dof) matrix

        W(lam) = shift*I - J(lam),
        J_rho,i(lam) = rho_mean * lam * dG/dfield_i |_means
        J_Ul,rho = s_l,   J_Ul,Ul = -gamma_l + D_l*lam

    is an 'arrow' matrix (dense first row/column, diagonal ligand
    block), solved in closed form by a Schur complement on the rho
    row — pure elementwise arithmetic over the mode array, no batched
    linalg.  For near-uniform states this makes the Richardson
    iteration matrix nearly nilpotent; it degrades gracefully (and
    never below the diagonal version's quality in practice) for
    strongly aggregated states.
    """

    def __init__(self, grid, ops, compute_dtype=None, use_fft=False):
        super().__init__(grid, compute_dtype=compute_dtype,
                         use_fft=use_fft)
        self.ops = ops
        self.nfields = ops.nligands + 1

    def _arrow_solve(self, c, shift, t, means, rho_diff, nextra=0):
        """Per-mode arrow-system solve on transformed coefficients c
        (f32 arithmetic; shared by the transparent apply_linearized
        and the explicitly-sharded apply of make_sharded_block_apply).
        """
        cd = self.compute_dtype
        nf = self.nfields
        lam = self.lam.astype(cd)
        dG, s, gamma, D = self.ops.linearization_coefficients(means, t)
        rho_mean = jnp.asarray(means[0], dtype=cd)
        shift = jnp.asarray(shift, dtype=cd)
        dG = [jnp.asarray(g, dtype=cd) for g in dG]
        # arrow system per mode:
        #   a x_r + sum_l b_l x_l = y_r
        #   c_l x_r + d_l x_l     = y_l
        if rho_diff is not None:
            a = shift - jnp.asarray(rho_diff, dtype=cd) * lam
        else:
            a = shift - rho_mean * lam * dG[0]
        y_r = c[0]
        schur = a
        rhs_r = y_r
        xs_den = []
        for l in range(nf - 1):
            b_l = -rho_mean * lam * dG[1 + l]
            c_l = -jnp.asarray(s[l], dtype=cd)
            d_l = shift + jnp.asarray(gamma[l], dtype=cd) - jnp.asarray(
                D[l], dtype=cd
            ) * lam
            schur = schur - b_l * c_l / d_l
            rhs_r = rhs_r - b_l * c[1 + l] / d_l
            xs_den.append((c_l, d_l))
        x_r = rhs_r / schur
        outs = [x_r]
        for l in range(nf - 1):
            c_l, d_l = xs_den[l]
            outs.append((c[1 + l] - c_l * x_r) / d_l)
        # any extra (non-physical) trailing fields: shift-only inverse
        for extra in range(nf, nf + nextra):
            outs.append(c[extra] / shift)
        return jnp.stack(outs, axis=0)

    def apply_linearized(self, v, shift, t, means, rho_diff=None):
        """v: (dof, *sshape); means: per-field scalars of the STATE
        being linearized (not of v, which is a residual).

        rho_diff: optional scalar upper bound on the rho row's
        effective diffusivity max_x(rho * dG/drho).  At capped density
        peaks rho*Vcap' exceeds the mean-state value by orders of
        magnitude; overestimating the diffusion in M keeps the
        preconditioned spectrum inside the Richardson stability region
        (slow modes are then caught by the step-error control), while
        the mean-state value underestimates it and lets the iteration
        diverge — the options92 equilibrium exposed exactly this.
        """
        in_dtype = v.dtype
        c = self._forward(v.astype(self.compute_dtype))
        outs = self._arrow_solve(
            c, shift, t, means, rho_diff,
            nextra=v.shape[0] - self.nfields,
        )
        return self._inverse(outs).astype(in_dtype)


def make_sharded_block_apply(precond, ops, mesh):
    """Explicitly sharded block-pc apply with ONE reduced-dtype psum
    per apply — the multi-device wire-byte knob (VERDICT r3 #1).

    XLA's transparent partitioning of the einsum apply must all-reduce
    the contraction partials in f32 even under -pc_dtype bf16 (the
    dot's preferred_element_type rounding is specified AFTER the full
    contraction, so per-shard rounding would change semantics —
    verified in the lowered HLO).  This wrapper instead runs the apply
    per shard under shard_map: the forward transform contracts only
    the LOCAL x rows against the shard's Qx slab, the partial mode
    coefficients are explicitly cast to the transform dtype and
    psum'ed (bf16 on the wire when -pc_dtype bf16 — per-shard rounding
    is exactly the approximation bf16 transforms accept), the arrow
    solve runs replicated, and the inverse transform produces only the
    local rows with no further collective.  One psum per apply also
    merges the forward/inverse all-reduce pair of the transparent
    lowering.  Engaged by make_step_fn when the state is sharded over
    a mesh and pc_dtype is bfloat16 (tests/test_comm_audit.py pins
    the byte halving).
    """
    from jax.sharding import PartitionSpec

    axis = mesh.axis_names[0]
    n_x = dict(zip(mesh.axis_names, mesh.devices.shape))[axis]
    dim = precond.dim
    td = precond.transform_dtype
    cd = precond.compute_dtype
    Qs = [q.astype(td) for q in precond.Qs]
    kwf = dict(
        preferred_element_type=precond._interm_dtype,
        precision=PC_PRECISION,
    )
    kwi = dict(preferred_element_type=cd, precision=PC_PRECISION)
    state = PartitionSpec(None, axis, *([None] * (dim - 1)))

    def local_apply(v, qx, shift, t, means, rho_diff):
        in_dtype = v.dtype
        vt = v.astype(td)
        if dim == 1:
            cp = jnp.einsum("fi,ik->fk", vt, qx, **kwf)
        elif dim == 2:
            cp = jnp.einsum("fij,ik,jl->fkl", vt, qx, Qs[1], **kwf)
        else:
            cp = jnp.einsum(
                "fijm,ik,jl,mn->fkln", vt, qx, Qs[1], Qs[2], **kwf
            )
        # THE collective: partial mode coefficients, transform dtype
        c = jax.lax.psum(cp.astype(td), axis)
        outs = precond._arrow_solve(
            c, shift, t, list(means), rho_diff,
            nextra=v.shape[0] - precond.nfields,
        ).astype(td)
        if dim == 1:
            out = jnp.einsum("fk,ik->fi", outs, qx, **kwi)
        elif dim == 2:
            out = jnp.einsum("fkl,ik,jl->fij", outs, qx, Qs[1], **kwi)
        else:
            out = jnp.einsum(
                "fkln,ik,jl,mn->fijm", outs, qx, Qs[1], Qs[2], **kwi
            )
        return out.astype(in_dtype)

    smapped = jax.shard_map(
        local_apply,
        mesh=mesh,
        in_specs=(
            state,                      # v: x-sharded state
            PartitionSpec(axis, None),  # Qx rows follow the x shards
            PartitionSpec(), PartitionSpec(), PartitionSpec(),
            PartitionSpec(),
        ),
        out_specs=state,
        check_vma=False,
    )

    def apply(v, shift, t, means, rho_diff):
        return smapped(
            v, Qs[0], jnp.asarray(shift), jnp.asarray(t),
            jnp.stack([jnp.asarray(m) for m in means]),
            jnp.asarray(rho_diff),
        )

    return apply


def gmres_solve(op, b, M=None, tol=1e-8, restart=20, maxiter=50, x0=None):
    """Restarted GMRES on a matrix-free operator.  Traceable.

    Returns the solution (no convergence flag: like the reference's
    'ksp preonly' usage, failures surface through the step-error
    control and trigger rollback).
    """
    x, _ = jax.scipy.sparse.linalg.gmres(
        op,
        b,
        x0=x0,
        tol=tol,
        atol=0.0,
        restart=restart,
        maxiter=maxiter,
        M=M,
        solve_method="batched",
    )
    return x


def dense_solve_factory(rhs, shape):
    """Build exact dense stage solvers for small problems.

    Returns ``prepare(u, t, shift) -> carry`` and
    ``solve(carry, b) -> y``: ``prepare`` builds the Jacobian of
    ``rhs(u, t)`` and LU-factors (shift*I - J) ONCE per step (shift
    and J are fixed across the Rosenbrock stages); ``solve`` runs only
    the O(N^2) triangular solves per stage.
    """
    n = 1
    for s in shape:
        n *= int(s)

    def prepare(u, t, shift):
        flat_rhs = lambda uf: rhs(uf.reshape(shape), t).reshape(-1)
        J = jax.jacfwd(flat_rhs)(u.reshape(-1))
        W = shift * jnp.eye(n, dtype=J.dtype) - J
        return jsl.lu_factor(W)

    def solve(lu_piv, b):
        return jsl.lu_solve(lu_piv, b.reshape(-1)).reshape(shape)

    return prepare, solve
