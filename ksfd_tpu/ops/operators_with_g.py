"""The with-G variant: free energy carried as an extra state field.

The reference keeps a legacy architecture (KSFD/ksfdsym_with_G.py,
KSFD/ksfdts_with_G.py) in which the state vector has nligands+2 dofs:
rho, the ligands, and G — G is recomputed in place into the state
inside drhodt and ends up stored in every snapshot, so offline
analysis can read the free-energy landscape directly.

Equivalent here: WithGOperators works on a (nligands+2)-dof
state whose last slot mirrors G.  The PDE derivatives are computed
from the physical fields exactly as in PDEOperators (the G slot's
time derivative is zero inside the implicit solve); ``refresh_G``
recomputes the slot from the current fields and the Solver calls it
after every accepted step when the operators expose it, so saved
snapshots always carry an up-to-date G — the capability the legacy
variant provided, without its save/restore slice dance
(ksfdsym_with_G.py's drhodt).
"""

import jax.numpy as jnp

from ..grid import Grid
from ..utils.exceptions import KSFDException
from .operators import PDEOperators

__all__ = ["WithGOperators", "with_g_grid"]


def with_g_grid(grid):
    """The same grid with one extra dof for the G slot."""
    state = grid.state()
    state["dof"] = state["dof"] + 1
    return Grid(**state)


class WithGOperators(PDEOperators):
    """PDE operators over a state with a trailing G field."""

    def __init__(self, ps, grid, sources=None, flux_form=False):
        if grid.dof != ps.nligands + 2:
            raise KSFDException(
                "with-G grid needs dof=%d (rho + %d ligands + G), got %d"
                % (ps.nligands + 2, ps.nligands, grid.dof)
            )
        self._full_grid = grid
        super().__init__(
            ps, _strip_g(grid), sources=sources, flux_form=flux_form
        )
        # expose the full (dof+1) grid to callers: persistence uses it
        self.grid = grid

    # internal helpers operate on the physical slice u[:-1]
    def split(self, u):
        return u[:-1], u[-1]

    def refresh_G(self, u, t=None):
        """Recompute the G slot from the physical fields."""
        phys, _ = self.split(u)
        phys = super().groom(phys)
        G = super().G(phys, t)
        return jnp.concatenate([phys, G[None]], axis=0)

    def groom(self, u):
        phys, G = self.split(u)
        return jnp.concatenate([super().groom(phys), G[None]], axis=0)

    def rhs(self, u, t, groom=True):
        phys, _ = self.split(u)
        dphys = super().rhs(phys, t, groom=groom)
        return jnp.concatenate(
            [dphys, jnp.zeros_like(u[-1])[None]], axis=0
        )

    def stage_delta_ok(self):
        # rhs_delta models the physical fields only, not the G slot
        return False

    def velocity(self, u, t=None):
        phys, _ = self.split(u)
        return super().velocity(phys, t)

    def stiff_coefficients(self, t):
        diff, decay = super().stiff_coefficients(t)
        # G slot: no dynamics; shift-only inverse
        return diff + [0.0], decay + [0.0]


def _strip_g(grid):
    state = grid.state()
    state["dof"] = state["dof"] - 1
    return Grid(**state)
