"""ksfd_tpu — Keller-Segel finite-difference framework in JAX.

A from-scratch rebuild of the capabilities of leonavery/KSFD:

- the symbolic PDE assembly (sympy) compiles to XLA-fused device
  kernels instead of runtime-generated C ufuncs;
- PETSc DMDA/TS/SNES/KSP/MUMPS is replaced by an implicit Rosenbrock-W
  stepper with matrix-free Newton-Krylov (Jacobian action via jax.jvp,
  GMRES, exact spectral preconditioning of the stiff linear part);
- MPI domain decomposition becomes jax.sharding over a device mesh
  (XLA inserts the halo collectives);
- per-rank HDF5 time series becomes a single sharded checkpoint store
  with bit-exact restart.

Importing this package enables float64 (jax_enable_x64) unless the
environment variable KSFD_TPU_X64=0: the PDE system is stiff and the
parity target vs the reference is 1e-8.
"""

import os as _os

import jax as _jax

if _os.environ.get("KSFD_TPU_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

# KSFD_PLATFORM / KSFD_NUM_CPU_DEVICES select the JAX platform and the
# virtual CPU device count from the environment (KSFD_PLATFORM=cpu
# KSFD_NUM_CPU_DEVICES=8 runs on an 8-device virtual CPU mesh on a
# machine whose default platform is a GPU).
if _os.environ.get("KSFD_PLATFORM"):
    _jax.config.update("jax_platforms", _os.environ["KSFD_PLATFORM"])
if _os.environ.get("KSFD_NUM_CPU_DEVICES"):
    _jax.config.update(
        "jax_num_cpu_devices", int(_os.environ["KSFD_NUM_CPU_DEVICES"])
    )

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR
# itself; without it the cache lives at a FIXED path in the checkout
# (the path is part of the cache key, so a directory that moves never
# hits).
CHECKOUT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir", _os.path.join(CHECKOUT, ".jax_cache")
    )

__version__ = "0.1.0"

from .utils import (  # noqa: E402
    KSFDException,
    Parameter,
    ParameterList,
    Parser,
    NumericsOptions,
    decode_numerics,
    default_parameters,
    find_duplicates,
    safe_sympify,
    jaxify,
    log,
)
from .models import (  # noqa: E402
    Ligand,
    LigandGroup,
    LigandGroups,
    SolutionParameters,
)
from .grid import Grid  # noqa: E402

__all__ = [
    "KSFDException",
    "Parameter",
    "ParameterList",
    "Parser",
    "NumericsOptions",
    "decode_numerics",
    "default_parameters",
    "find_duplicates",
    "safe_sympify",
    "jaxify",
    "log",
    "Ligand",
    "LigandGroup",
    "LigandGroups",
    "SolutionParameters",
    "Grid",
]
