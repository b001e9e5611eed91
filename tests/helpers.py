"""Shared test helpers: canned problem specifications."""

from argparse import Namespace


def make_clargs(params=(), source=(), cappotential="tophat", seed=793817931, **kw):
    """A Namespace shaped like the driver's parsed command line."""
    ns = Namespace(
        cappotential=cappotential,
        save=None,
        check=None,
        resume=None,
        restart=None,
        series_retries=0,
        series_retry_interval=60,
        mpiok=False,
        showparams=False,
        noperiodic=False,
        onestep=False,
        solver=None,
        seed=seed,
        source=list(source),
        params=list(params),
        numerics=[],
        petsc=[],
    )
    for k, v in kw.items():
        setattr(ns, k, v)
    return ns


#: Parameters of the two-ligand-group problem used by the reference's
#: convergence tests (options92 / options93nx128dt1).
OPTIONS92_PARAMS = [
    "dt=1",
    "tmax=200000",
    "maxsteps=10000",
    "width=1",
    "nelements=128",
    "dim=1",
    "degree=3",
    "atol=0.01",
    "rtol=1e-6",
    "rhomin=1e-7",
    "rhomax=28000",
    "cushion=2000",
    "sigma=0.02357",
    "s2=sigma**2/2",
    "Nworms=0",
    "rho0=murho + arho*sin(2*pi*(0.25+k0*x))",
    "U0_1_1=murho + arho*aUa*sin(2*pi*(0.25+k0*x))",
    "U0_2_1=murho + arho*aUr*sin(2*pi*(0.25+k0*x))",
    "murho=9000.0",
    "arho=1.0",
    "aUa=0.6846227279629311",
    "aUr=0.088562372925828",
    "lamda=0.003974930217658144",
    "k0=4.0",
    "srho0=0",
    "ngroups=2",
    "nligands_1=1",
    "alpha_1=1500",
    "beta_1=5.56e-4",
    "s_1_1=0.01",
    "gamma_1_1=0.01",
    "D_1_1=1e-6",
    "nligands_2=1",
    "alpha_2=1500",
    "beta_2=-5.56e-4",
    "s_2_1=0.001",
    "gamma_2_1=0.001",
    "D_2_1=1e-5",
]
