"""Fixed-count stage solvers: preconditioned GMRES, Richardson and
Chebyshev iterations.

Design notes:
- jnp.linalg.lstsq lowers to an SVD whose Jacobi sweeps appear in the
  HLO as thousands of serialized 4x4 ops — catastrophic inside a hot
  step.  The least-squares problem here is tiny and triangular-izable
  on the fly, so we apply classical Givens rotations as we go: pure
  scalar arithmetic, fully unrolled at trace time.
- The iteration count is STATIC (no data-dependent control flow):
  solve quality is judged by the caller's embedded step-error control,
  the same way the reference leaves linear-solve failures to TS
  rollback (SURVEY §5.3).

Left-preconditioned: minimizes || M^{-1}(b - W x) || over the Krylov
space K_m(M^{-1}W, M^{-1}b).
"""

import jax.numpy as jnp

__all__ = [
    "gmres_fixed",
    "gmres_restarted",
    "gmres_rolled",
    "richardson_solve",
    "chebyshev_solve",
]

# Fixed-count iterations with at most this many operator applications
# are unrolled; longer ones run as a lax.fori_loop.  See _cheb_core.
UNROLL_MAX = 16


def gmres_restarted(op, b, M=None, iters=8, restarts=3):
    """Restarted GMRES(iters) x restarts, statically unrolled.

    Selectable via ksp_type='gmres_restarted'.  Restarting keeps each
    unrolled cycle's graph small (O(iters^2) scalar Givens/dot nodes
    instead of O((iters*restarts)^2)).  The solver's automatic retry
    path uses the rolled-loop jax.scipy GMRES instead (see
    Solver._get_fallback).
    """
    x = None
    for _ in range(int(restarts)):
        x = gmres_fixed(op, b, M=M, iters=iters, x0=x)
    return x


def richardson_solve(op, b, M, iters=12, x0=None):
    """Preconditioned Richardson: x += M^{-1}(b - W x), fixed count.

    With the spectral preconditioner the iteration matrix I - M^{-1}W
    contains only the (preconditioned) nonlinear coupling terms; on the
    Keller-Segel stages its spectral radius is small (measured ~0.1 at
    dt=1 on the options84-class workload: relres 1e-11 in 16 sweeps).
    This is the framework's default stage solver: a pure
    operator-application chain with no inner products, which XLA
    compiles to back-to-back fused kernels.
    Divergence at large dt is caught by the embedded step-error
    control, which rejects the step and shrinks h — the same failure
    path the reference relies on for SNES failures
    (KSFD/ksfdts.py:135, setMaxSNESFailures).
    """
    import jax

    x = M(b) if x0 is None else x0 + M(b - op(x0))

    # Small static sweep counts are UNROLLED: a lax.fori_loop body is
    # a fusion barrier (the += of sweep k cannot fuse into sweep k+1's
    # residual pass), and at the default 3 sweeps the loop saves no
    # compile time worth having.  The threshold covers the escalated
    # chunk tier (ksp_iters_max=16).
    if int(iters) <= UNROLL_MAX:
        for _ in range(int(iters) - 1):
            x = x + M(b - op(x))
        return x

    def body(j, x):
        return x + M(b - op(x))

    return jax.lax.fori_loop(0, int(iters) - 1, body, x)


def _cheb_core(resid, b, M, iters, lmin, lmax):
    """Shared preconditioned-Chebyshev recurrence.

    resid(x) must return b - W x.  lmin/lmax (traceable scalars) bound
    the spectrum of M^{-1} W; Chebyshev reaches a given contraction in
    ~sqrt(kappa) fewer applications than Richardson on [lmin, lmax]
    (kappa = lmax/lmin), using NO inner products — the property that
    makes it chunk-safe where Krylov compositions are not.

    Stage-solve role (VERDICT r4 next #1): the aggregated Keller-Segel
    phase makes the preconditioned spectrum spread to kappa ~ 60 (the
    block pc bounds the rho diffusivity by its max, over-damping the
    smooth regions), which pins Richardson at 16 sweeps per accepted
    step while CFL headroom sits ~25x unused.  Chebyshev turns the
    extra headroom into larger accepted h at ~sqrt(kappa) cost.

    Recurrence (Saad, Iterative Methods for Sparse Linear Systems,
    2nd ed., Alg. 12.1, preconditioned form):
      theta = (lmax+lmin)/2, delta = (lmax-lmin)/2, sigma = theta/delta
      d_0 = M(b)/theta, x_1 = d_0, rho_0 = 1/sigma
      rho_k = 1/(2 sigma - rho_{k-1})
      d_k = rho_k rho_{k-1} d_{k-1} + (2 rho_k / delta) M(b - W x_k)
      x_{k+1} = x_k + d_k
    ``iters`` counts preconditioner applications (= W applications +
    1), matching richardson_solve's convention.
    """
    import jax

    dt = b.dtype
    lmin = jnp.asarray(lmin, dtype=dt)
    lmax = jnp.asarray(lmax, dtype=dt)
    theta = 0.5 * (lmax + lmin)
    delta = jnp.maximum(0.5 * (lmax - lmin), jnp.asarray(1e-8, dt))
    sigma = theta / delta
    rho = 1.0 / sigma
    d = M(b) / theta
    x = d

    # One unroll policy on every backend: roll above UNROLL_MAX
    # applications.  The unrolled 3+16+48 tier graph inside the
    # chunk's 3-branch switch-in-while overflows XLA:CPU's recursive
    # passes (segfault at 2D sizes), and the rolled body is a plain
    # 3-term tensor recurrence, bit-identical to the unrolled form
    # (tests/test_chebyshev.py).  On the GPU the two forms were
    # timed against each other for that graph: see PERF.md.
    if int(iters) - 1 <= UNROLL_MAX:
        for _ in range(int(iters) - 1):
            z = M(resid(x))
            rho_new = 1.0 / (2.0 * sigma - rho)
            d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
            x = x + d
            rho = rho_new
        return x

    def body(i, carry):
        x, d, rho = carry
        z = M(resid(x))
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * z
        return (x + d, d, rho_new)

    x, _, _ = jax.lax.fori_loop(
        0, int(iters) - 1, body, (x, d, rho)
    )
    return x


def chebyshev_solve(op, b, M, iters=16, lmin=0.05, lmax=1.05):
    """Preconditioned Chebyshev on W x = b (see _cheb_core).

    Like richardson_solve, a fixed-count inner-product-free iteration:
    solve quality is judged by the caller's embedded step-error
    control (SURVEY §5.3 division of labor), so a spectrum excursion
    outside [lmin, lmax] degrades to a rejected step, never a crash.
    """
    return _cheb_core(lambda x: b - op(x), b, M, iters, lmin, lmax)


def gmres_rolled(op, b, M=None, iters=12, restarts=4, x0=None):
    """Left-preconditioned restarted GMRES(iters) with ROLLED loops.

    The robust-tier workhorse.  Three implementations coexist because
    they trade compile time against run time differently:

    - gmres_fixed: fully unrolled; fastest per call at tiny iters but
      its O(m^2) scalar Givens graph compiles slowly beyond m ~ 8.
    - jax.scipy gmres (gmres_solve): rolled and compile-cheap, but its
      generic machinery costs ~20x the component arithmetic per call.
    - THIS: rolled lax.fori_loop Arnoldi with the Krylov basis held in
      one (m+1, n) array (rows filled as they are created; dot products
      against still-zero rows vanish, so no masking is needed) and the
      Givens/Hessenberg recurrences on small arrays.  The compiled
      graph is O(1) in m, and per call it runs the same large-array
      work as gmres_fixed: basis matvec + rank-1 updates (GEMV
      friendly), none of jax.scipy's per-iteration pytree overhead.

    Breakdown contract matches gmres_fixed: safe() division yields a
    finite (possibly wrong) answer; the caller's embedded step-error
    control judges solve quality (SURVEY §5.3 division of labor).

    Structure: ONE lax.fori_loop (the Arnoldi), with the Givens update
    applied via an accumulated (m+1, m+1) rotation matrix instead of
    an inner loop, back substitution unrolled (m is small and
    static), and restarts as a static Python loop, so no lax loop is
    nested in another.
    """
    from jax import lax

    if M is None:
        M = lambda v: v
    shape = b.shape
    m = int(iters)
    flat = lambda v: v.reshape(-1)
    n = b.size
    dtype = b.dtype
    safe = lambda x: jnp.where(x > 0, x, jnp.ones_like(x))

    def A(v):
        return flat(M(op(v.reshape(shape))))

    eye = jnp.eye(m + 1, dtype=dtype)

    def cycle(x):
        r0 = flat(M(b - op(x.reshape(shape))))
        beta = jnp.linalg.norm(r0)
        V = jnp.zeros((m + 1, n), dtype=dtype)
        V = V.at[0].set(r0 / safe(beta))
        R = jnp.zeros((m, m), dtype=dtype)
        Om = eye  # product of the Givens rotations applied so far
        g = jnp.zeros((m + 1,), dtype=dtype).at[0].set(beta)

        def arnoldi(j, carry):
            V, R, Om, g = carry
            w = A(V[j])
            # CGS2: dots against not-yet-created rows are exactly zero
            h1 = V @ w
            w = w - V.T @ h1
            h2 = V @ w
            w = w - V.T @ h2
            h = h1 + h2
            hlast = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / safe(hlast))
            # rotations 0..j-1 in one tiny matvec (slots >= j are
            # still untouched identity rows in Om)
            col = Om @ h.at[j + 1].set(hlast)
            denom = jnp.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            cj = col[j] / safe(denom)
            sj = col[j + 1] / safe(denom)
            G = (
                eye.at[j, j].set(cj)
                .at[j, j + 1].set(sj)
                .at[j + 1, j].set(-sj)
                .at[j + 1, j + 1].set(cj)
            )
            Om = G @ Om
            col = col.at[j].set(denom).at[j + 1].set(0.0)
            R = R.at[:, j].set(col[:m])
            gj = cj * g[j] + sj * g[j + 1]
            gj1 = -sj * g[j] + cj * g[j + 1]
            g = g.at[j].set(gj).at[j + 1].set(gj1)
            return (V, R, Om, g)

        V, R, Om, g = lax.fori_loop(0, m, arnoldi, (V, R, Om, g))
        # back substitution R y = g[:m], unrolled (m static, small)
        y = [None] * m
        for j in range(m - 1, -1, -1):
            s = g[j]
            for k in range(j + 1, m):
                s = s - R[j, k] * y[k]
            y[j] = s / jnp.where(R[j, j] != 0, R[j, j], 1.0)
        dx = V[:m].T @ jnp.stack(y)
        dx = jnp.where(beta > 0, dx, jnp.zeros_like(dx))
        return x + dx

    x = flat(x0) if x0 is not None else jnp.zeros((n,), dtype=dtype)
    for _ in range(int(restarts)):
        x = cycle(x)
    return x.reshape(shape)


def gmres_fixed(op, b, M=None, iters=8, x0=None):
    """Unrolled GMRES(iters).  op/M: linear callables on b-shaped arrays.

    Breakdown contract: the safe() guards below turn a Krylov/Givens
    breakdown (hlast == 0 or a singular R) into a FINITE, possibly
    wrong, answer instead of NaN.  Benign breakdown (the space closed
    because the residual is already zero) still yields the exact
    solution; a genuine singular-operator breakdown leaves a large
    residual.  This is deliberate: the caller judges solve quality via
    the embedded step-error estimate and rejects the step (the same
    division of labor the reference uses, leaving linear-solve failure
    to TS rollback — SURVEY §5.3).  Covered by
    tests/test_solver.py::test_gmres_breakdown_finite_and_judged.
    """
    if M is None:
        M = lambda v: v
    shape = b.shape
    m = int(iters)
    flat = lambda v: v.reshape(-1)

    def A(v):
        return flat(M(op(v.reshape(shape))))

    r0 = flat(M(b)) if x0 is None else flat(M(b - op(x0)))
    beta = jnp.linalg.norm(r0)
    safe = lambda x: jnp.where(x > 0, x, 1.0)
    Vs = [r0 / safe(beta)]

    # Givens-rotation state: R columns (upper triangular), rotations,
    # and the rotated residual vector g.
    Rcols = []
    cs = []
    sn = []
    g = [beta] + [jnp.zeros_like(beta) for _ in range(m)]

    for j in range(m):
        w = A(Vs[j])
        # classical Gram-Schmidt with one re-orthogonalization (CGS2)
        h = [jnp.dot(Vi, w) for Vi in Vs]
        for i, Vi in enumerate(Vs):
            w = w - h[i] * Vi
        h2 = [jnp.dot(Vi, w) for Vi in Vs]
        for i, Vi in enumerate(Vs):
            w = w - h2[i] * Vi
        h = [a + b2 for a, b2 in zip(h, h2)]
        hlast = jnp.linalg.norm(w)
        Vs.append(w / safe(hlast))
        # apply existing rotations to the new column
        col = list(h) + [hlast]
        for i in range(j):
            t0 = cs[i] * col[i] + sn[i] * col[i + 1]
            t1 = -sn[i] * col[i] + cs[i] * col[i + 1]
            col[i], col[i + 1] = t0, t1
        # new rotation eliminating col[j+1]
        denom = jnp.sqrt(col[j] ** 2 + col[j + 1] ** 2)
        cj = col[j] / safe(denom)
        sj = col[j + 1] / safe(denom)
        cs.append(cj)
        sn.append(sj)
        col[j] = denom
        col[j + 1] = jnp.zeros_like(denom)
        Rcols.append(col[: j + 1])  # strictly upper-triangular storage
        # rotate g
        gj = cs[j] * g[j] + sn[j] * g[j + 1]
        gj1 = -sn[j] * g[j] + cs[j] * g[j + 1]
        g[j], g[j + 1] = gj, gj1

    # back substitution R y = g[:m]
    y = [None] * m
    for j in range(m - 1, -1, -1):
        s = g[j]
        for k in range(j + 1, m):
            s = s - Rcols[k][j] * y[k]
        y[j] = s / safe(Rcols[j][j])

    x = jnp.zeros_like(r0)
    for j in range(m):
        x = x + y[j] * Vs[j]
    # beta == 0 means the (preconditioned) initial residual vanished:
    # the correction is zero, the answer is x0 (or 0 without one)
    x = jnp.where(beta > 0, x, jnp.zeros_like(x))
    if x0 is not None:
        x = x + flat(x0)
    return x.reshape(shape)
