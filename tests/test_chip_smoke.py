"""chip_smoke.py, bench.py and the multi-device check, rehearsed on CPU.

The scripts must refuse to run without a GPU (no CPU fallback); their
phase functions run here at tiny sizes, which checks the control flow
and the last-line contract.  The gpu-marked test runs on a card only
(JAX_PLATFORMS=cuda python -m pytest tests -m gpu).
"""

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(argv, env_extra=None, timeout=300):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable] + argv, cwd=REPO, env=env, capture_output=True,
        text=True, timeout=timeout,
    )


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_exits_nonzero_without_gpu(script):
    r = _run([os.path.join(REPO, script)])
    assert r.returncode != 0, r.stdout
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stdout + r.stderr


def test_derived_options(tmp_path):
    src = tmp_path / "opts"
    src.write_text("# comment\n--save=x\nmaxsteps=9\nnelements=8\n"
                   "--numerics\n-ts_type rosw\n--\n")
    at = chip_smoke.derived_options(str(src), str(tmp_path / "d"),
                                    drop=("--save",), maxsteps=3, dt=1)
    assert at == "@" + str(tmp_path / "d")
    assert (tmp_path / "d").read_text().splitlines() == [
        "# comment", "nelements=8", "maxsteps=3", "dt=1",
        "--numerics", "-ts_type rosw", "--",
    ]


def test_phases_tiny_and_last_line(tmp_path):
    """delta, flagship (device-fused chunk, save + checkpoint), 3D and
    ensemble phases at tiny sizes, then the result line."""
    ratios = chip_smoke.phase_delta(nx=32)
    assert set(ratios) == {"rough", "near_uniform"}
    s = chip_smoke.phase_flagship(str(tmp_path), steps=3, nelements=32)
    assert s.k == 3 and s.build_info["delta"]
    assert any(p.name.startswith("aggregation2d") and p.suffix == ".h5"
               for p in tmp_path.iterdir())
    chip_smoke.phase_3d_ensemble(str(tmp_path), steps=2, n3d=8, nens=16,
                                 members=2, persist=False)
    line = json.loads(chip_smoke.result_line(jax.devices()))
    assert line == {"ok": True, "device": {
        "platform": "cpu", "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }}


def test_gates_phase_tiny(tmp_path):
    """The gate phase's plumbing on a short options93 run and a
    shortened options92 run (the physical checks need the full runs,
    which chip_smoke.py makes on the card)."""
    r, s = chip_smoke.phase_gates(str(tmp_path), validate_steps=20,
                                  eigen_tmax=500, persist=False)
    assert r["steps"] == 20 and 0 < r["rel_err"] < 1e-3
    assert s.t >= 500 and not s.diverged


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR, when set, is the cache and the code
    sets no other; otherwise the cache is <checkout>/.jax_cache."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_dir else {}
    drop = None if env_dir else "JAX_COMPILATION_CACHE_DIR"
    full = dict(os.environ, JAX_PLATFORMS="cpu", **env)
    full.pop(drop, None)
    r = subprocess.run(
        [sys.executable, "-c",
         "import ksfd_tpu, jax; "
         "print(jax.config.jax_compilation_cache_dir)"],
        cwd=REPO, env=full, capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if env_dir else os.path.join(REPO, ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == want


def test_multichip_check_rehearsal(tmp_path):
    """The four-card --multi phase on 4 virtual CPU devices at a small
    grid: sharded-vs-single identity, bf16 sharded pc by default, and
    a collective-free member-sharded ensemble."""
    import __graft_entry__ as ge

    res = ge.multichip_check(jax.devices()[:4], nelements=32,
                             out=str(tmp_path), steps=6, ens_nelements=16)
    assert res["mesh"] == {"x": 4, "y": 1}
    assert res["dev_over_inc"] < 1e-4
    assert res["default_pc_dtype"] == "bfloat16"
    assert res["default_pc_sharded"]
    assert res["ensemble_collectives"] == []


@pytest.mark.gpu
def test_delta_bounds_on_gpu(gpu):
    """rhs_delta within its bounds at the flagship width on the card."""
    ratios = chip_smoke.phase_delta(nx=1536)
    assert all(ratios[k] < chip_smoke.DELTA_BOUNDS[k] for k in ratios)
