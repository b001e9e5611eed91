"""Exact direct stage solves at ANY dimension via sparse LU.

Reference parity: the reference assembles its analytic Jacobian into a
PETSc AIJ matrix and LU-factors it with MUMPS every step at any
dimension and size (KSFD/ksfdsym.py:814-886; the options84 PETSc block
``-ksp_type preonly -pc_type lu -pc_factor_mat_solver_type mumps``).
The 1D counterpart here is the native cyclic banded LU
(solvers/banded_path.py); this module is the >= 2D counterpart:

1. The W-operator (shift*I - J) couples a column (g, p) only to rows
   (f, q) with q within the AXIS CROSS of p of halfwidth 2*sw — the
   RHS is a sum over axes of compositions of two axis-aligned
   halfwidth-sw stencils (div_d(rho grad_d G), D lap_d U) around
   pointwise nonlinearities, so no mixed-axis coupling exists
   (ops/operators.py).  Its entries are therefore extracted EXACTLY
   with colored jvp probes: one probe per (axis-phase, field) with a
   per-axis phase stride >= 4*sw+1 guarantees no row couples to two
   same-color columns (two columns < (4*sw+1) apart along one axis —
   or differing along two axes by <= 2*sw each — can share a row;
   stride-separated ones cannot).
2. The probes run ON DEVICE (vmapped jvp = the fused J-action);
   assembly and the SuperLU factorization run on host — the same
   division of labor as the reference (device/worker ufuncs + MUMPS on
   CPU) and as the 1D banded path.
3. The assembled matrix is VERIFIED against the operator (two random
   matvecs) before factoring, so a future operator with wider or
   mixed-axis coupling fails loudly instead of silently mis-solving.

Selected by numerics ``ksp_type='lu'``.  Complexity is the classic
sparse-direct one (2D fill ~O(N^1.5)): exact and unconditionally
robust on small/medium grids, while the spectral-preconditioned
iterative stack remains the at-scale default (its role in the
reference is played by MUMPS only because PETSc has no GPU path here).
"""

import numpy as np
import jax
import jax.numpy as jnp

from ..utils.exceptions import KSFDException
from .steppers import wlte_norm_delta

__all__ = [
    "axis_strides",
    "extract_w_sparse",
    "make_sparse_step",
    "gather_global",
    "place_like",
]


def gather_global(u):
    """Host numpy copy of a possibly MULTI-PROCESS global array.

    The host-side direct solvers (this module + banded_path) assemble
    and factor the GLOBAL operator; under multi-controller JAX the
    state's shards are spread over processes and ``np.asarray`` on
    non-addressable shards raises.  Every process gathers the full
    state (one all-gather over the process mesh) and then performs the
    IDENTICAL host factorization/solve — the replicated-host-solve
    pattern.  Redundant compute, but this tier is a rare rescue/exact
    path; the reference pays MUMPS's distributed factorization instead
    (/root/reference/options84 PETSc block), which only wins at scales
    where the iterative stack is the default here anyway.
    """
    if isinstance(u, jax.Array) and not u.is_fully_addressable:
        from jax.experimental import multihost_utils

        return np.asarray(multihost_utils.process_allgather(u, tiled=True))
    return np.asarray(u)


def place_like(u_np, like):
    """Place replicated host data back with ``like``'s sharding.

    Inverse of gather_global: after the replicated host solve, every
    process holds the same global numpy result; rebuild a global
    jax.Array with the INPUT state's sharding so the downstream loop
    (monitors, next step) sees the same placement it handed in.
    """
    if isinstance(like, jax.Array) and not like.is_fully_addressable:
        return jax.make_array_from_callback(
            u_np.shape, like.sharding, lambda idx: u_np[idx]
        )
    return jnp.asarray(u_np)


def axis_strides(nps, sw):
    """Per-axis color strides: the smallest divisor of n_d that is
    >= 4*sw+1 (cross-coupling halfwidth is 2*sw, see module doc); a
    short axis falls back to stride n_d (every offset its own phase).
    """
    need = 4 * int(sw) + 1
    strides = []
    for n in nps:
        n = int(n)
        s = n
        for cand in range(min(need, n), n + 1):
            if n % cand == 0:
                s = cand
                break
        strides.append(s)
    return tuple(strides)


def _cross_offsets(nps, sw):
    """Axis-cross offsets of halfwidth 2*sw (center included once).

    Offsets are reduced mod the axis extent and DEDUPLICATED: on a
    short axis (n_d <= 4*sw) distinct stencil offsets alias to the
    same periodic neighbor, and appending the same (row, col) twice
    would double-count the entry in the COO sum."""
    dim = len(nps)
    offs = [tuple([0] * dim)]
    for a in range(dim):
        seen = {0}
        for k in range(-2 * sw, 2 * sw + 1):
            km = k % int(nps[a])
            if km in seen:
                continue
            seen.add(km)
            d = [0] * dim
            d[a] = km
            offs.append(tuple(d))
    return offs


def extract_w_sparse(w_op, nps, dof, sw, *, verify=True,
                     max_chunk_bytes=1 << 28, w_batch=None):
    """Assemble the exact sparse matrix of a cross-coupled operator.

    w_op: linear callable on (dof, *nps) arrays (e.g. the W-action
    v -> shift*v - J v).  Returns a scipy CSC matrix over the
    interleaved-dof ordering index(p, f) = lin(p)*dof + f (lin
    row-major), matching banded_path's 1D layout.

    w_batch: optional batched evaluator P -> stacked w_op responses;
    pass a PRE-JITTED one when extracting repeatedly (make_sparse_step
    does) so the vmapped probe evaluation is not retraced per call.

    Probes are evaluated on device in vmap chunks bounded by
    max_chunk_bytes of probe+response storage; entries are scattered
    per chunk so peak host memory stays bounded.
    """
    from scipy import sparse

    nps = tuple(int(n) for n in nps)
    dim = len(nps)
    dof = int(dof)
    sw = int(sw)
    strides = axis_strides(nps, sw)
    nphases = int(np.prod(strides))
    N_pts = int(np.prod(nps))
    N = N_pts * dof

    # all phase tuples, row-major over the stride box
    phase_grid = np.stack(
        np.meshgrid(*[np.arange(s) for s in strides], indexing="ij"),
        axis=-1,
    ).reshape(nphases, dim)
    offsets = _cross_offsets(nps, sw)

    # coordinates of every grid point, per axis (for scatter)
    coords = np.stack(
        np.meshgrid(*[np.arange(n) for n in nps], indexing="ij"),
        axis=-1,
    ).reshape(N_pts, dim)
    lin_strides = np.array(
        [int(np.prod(nps[a + 1:])) for a in range(dim)], dtype=np.int64
    )

    probe_bytes = (1 + 1) * dof * N_pts * 8  # probe + response, f64
    phases_per_chunk = max(1, int(max_chunk_bytes // (probe_bytes * dof)))

    rows_acc, cols_acc, vals_acc = [], [], []
    w_vmapped = w_batch if w_batch is not None else jax.jit(jax.vmap(w_op))
    out_dtype = None
    deltas = np.asarray(offsets, dtype=np.int64)       # (noff, dim)
    noff = len(deltas)
    nps_arr = np.asarray(nps, dtype=np.int64)
    for start in range(0, nphases, phases_per_chunk):
        chunk = phase_grid[start:start + phases_per_chunk]
        nc = len(chunk)
        # probes: P[(c, g)] = ones at field g, points p ≡ phase_c (mod s)
        P = np.zeros((nc * dof, dof) + nps)
        for ci, ph in enumerate(chunk):
            sel = tuple(
                slice(int(ph[a]), None, strides[a]) for a in range(dim)
            )
            for g in range(dof):
                P[(ci * dof + g, g) + sel] = 1.0
        WP = np.asarray(w_vmapped(jnp.asarray(P)))
        out_dtype = WP.dtype
        for ci, ph in enumerate(chunk):
            # columns of this phase: points p ≡ ph (mod strides).
            # Gathers/scatters are vectorized over (offset, point,
            # field) at once — the python-per-offset-per-field loop
            # was ~40% of the LU step time (VERDICT r3 #9).
            mask = np.all(coords % strides == ph, axis=1)
            pcols = coords[mask]                       # (npc, dim)
            lin_p = pcols @ lin_strides                # (npc,)
            npc = len(pcols)
            q = (pcols[None, :, :] + deltas[:, None, :]) % nps_arr
            qf = q.reshape(-1, dim)                    # (noff*npc, dim)
            lin_q = qf @ lin_strides                   # (noff*npc,)
            col_lin = np.tile(lin_p, noff)             # seed per entry
            idx = tuple(qf.T)
            for g in range(dof):
                resp = WP[ci * dof + g]                # (dof, *nps)
                vals = resp[(slice(None),) + idx]      # (dof, noff*npc)
                f_idx, e_idx = np.nonzero(vals)
                if not len(f_idx):
                    continue
                rows_acc.append(lin_q[e_idx] * dof + f_idx)
                cols_acc.append(col_lin[e_idx] * dof + g)
                vals_acc.append(vals[f_idx, e_idx])
    rows = np.concatenate(rows_acc) if rows_acc else np.zeros(0, int)
    cols = np.concatenate(cols_acc) if cols_acc else np.zeros(0, int)
    vals = np.concatenate(vals_acc) if vals_acc else np.zeros(0)
    A = sparse.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsc()

    if verify:
        # two random matvecs: catches any coupling wider than the
        # assumed axis cross (a future operator variant must fail
        # loudly here, not solve wrong).  The gate scales with the
        # OPERATOR's dtype: f32 probe responses carry ~1e-7-relative
        # rounding (KSFD_TPU_X64=0 mode), while a genuine support
        # violation shows up at the size of the missing entries.
        tol = 1e-9 if np.dtype(out_dtype).itemsize >= 8 else 1e-4
        rng = np.random.default_rng(12345)
        for _ in range(2):
            v = rng.standard_normal((dof,) + nps)
            want = np.asarray(w_op(jnp.asarray(v)))
            vi = np.moveaxis(v, 0, -1).reshape(-1)
            got = (A @ vi).reshape(nps + (dof,))
            got = np.moveaxis(got, -1, 0)
            scale = np.max(np.abs(want)) or 1.0
            if np.max(np.abs(got - want)) > tol * scale:
                raise KSFDException(
                    "sparse W assembly does not reproduce the operator "
                    "(max dev %.3e of %.3e): coupling exceeds the "
                    "axis-cross support assumed by ksp_type=lu"
                    % (float(np.max(np.abs(got - want))), float(scale))
                )
    return A


def make_sparse_step(ops, tab, atol, rtol):
    """Host-side implicit step using sparse LU — same contract as
    make_step_fn's jitted step: (u, t, h) -> (u1, enorm).

    Mirrors banded_path.make_banded_step (which stays the faster 1D
    choice): the RHS/jvp evaluations run on device; assembly,
    SuperLU factorization (once per step — shift and J are fixed
    across the Rosenbrock stages), and the triangular solves run on
    host.
    """
    from scipy.sparse.linalg import splu

    grid = ops.grid
    nps = tuple(int(n) for n in grid.nps)
    dof = grid.dof
    sw = grid.stencil_width
    rhs_jit = jax.jit(ops.rhs)

    # ONE jitted probe evaluator for the life of the step function:
    # (u, t, shift) are traced arguments, so repeated steps (and the
    # automatic LU rescue firing many times in a stiff stretch) reuse
    # the compiled executable instead of retracing a fresh closure
    # per call (at most two compiles: full chunk + remainder chunk).
    @jax.jit
    def _w_batch(u, t, shift, P):
        _, f_jvp = jax.linearize(lambda uu: ops.rhs(uu, t), u)
        return jax.vmap(lambda p: shift * p - f_jvp(p))(P)

    def step(u, t, h):
        u_in = u
        u = gather_global(ops.groom(jnp.asarray(u)))
        t = float(t)
        h = float(h)
        shift = 1.0 / (h * tab.gamma)
        uj = jnp.asarray(u)
        tj = jnp.asarray(t)
        sj = jnp.asarray(shift)
        w_op = lambda v: _w_batch(uj, tj, sj, jnp.asarray(v)[None])[0]
        w_batch = lambda P: _w_batch(uj, tj, sj, P)
        A = extract_w_sparse(w_op, nps, dof, sw, w_batch=w_batch)
        lu = splu(A)
        Ys = []
        for i in range(tab.stages):
            Ui = u.copy()
            for jj in range(i):
                if tab.a[i][jj]:
                    Ui = Ui + tab.a[i][jj] * Ys[jj]
            bi = np.asarray(
                rhs_jit(jnp.asarray(Ui), t + tab.alpha[i] * h)
            )
            for jj in range(i):
                if tab.c[i][jj]:
                    bi = bi + (tab.c[i][jj] / h) * Ys[jj]
            # interleaved-dof ordering: index (p, f) = lin(p)*dof + f
            yi = lu.solve(np.moveaxis(bi, 0, -1).reshape(-1))
            Ys.append(
                np.moveaxis(yi.reshape(nps + (dof,)), -1, 0).copy()
            )
        u1 = u.copy()
        d = np.zeros_like(u)
        for jj in range(tab.stages):
            u1 = u1 + tab.m[jj] * Ys[jj]
            dm = tab.m2[jj] - tab.m[jj]
            if dm:
                d = d + dm * Ys[jj]
        enorm = float(
            wlte_norm_delta(jnp.asarray(u1), jnp.asarray(d), atol, rtol)
        )
        return place_like(u1, u_in), enorm

    return step
