"""The one device decision (sfm_jax/device.py), the compile-cache
placement, and the rule that no module imports the Mosaic Pallas backend."""

import os
import pathlib
import re
import subprocess
import sys

import jax
import pytest

from sfm_jax import device
from sfm_jax.models import bundle_adjust as ba

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_platform_is_cpu_here():
    assert device.platform() == "cpu"


@pytest.mark.parametrize("backend,want", [("gpu", "gpu"), ("cuda", "gpu"),
                                          ("cpu", "cpu")])
def test_platform_names(monkeypatch, backend, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert device.platform() == want


@pytest.mark.parametrize("backend", ["rocm", "METAL", "neuron"])
def test_unknown_platform_raises(monkeypatch, backend):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    with pytest.raises(RuntimeError, match="unsupported"):
        device.platform()


def test_require_gpu_fails_without_gpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        device.require_gpu()


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_ba_auto_solver_rule_is_device_independent(monkeypatch, backend):
    # "auto" is dense while the grouped cross blocks fit and CG beyond,
    # on every device (the card's dense solve is checked against CG and
    # the CPU on a gauge-degenerate problem by chip_smoke.py phase 4).
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert ba.auto_solver(50, 50_000) == "dense"
    assert ba.auto_solver(200, 100_000) == "cg"


def test_no_module_imports_the_mosaic_pallas_backend():
    # Neither the Mosaic (non-GPU) Pallas backend module nor its usual
    # alias may appear in the program, its tools or its tests.
    pattern = re.compile(r"pallas[.\s]+(import\s+)?t[p]u|\bplt[p]u\b")
    files = [p for root in ("sfm_jax", "tools", "tests")
             for p in (REPO / root).rglob("*.py")]
    files += [REPO / f for f in ("bench.py", "chip_smoke.py",
                                 "__graft_entry__.py")]
    hits = [str(f.relative_to(REPO)) for f in files
            if pattern.search(f.read_text())]
    assert hits == []


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert device.compile_cache_dir() == tmp_path / "c"


def test_compile_cache_default_inside_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = device.compile_cache_dir()
    assert d == REPO / ".jax_cache"
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_enable_compile_cache_sets_no_dir_when_env_set(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.enable_compile_cache() == tmp_path
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_stable_across_processes(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    code = ("from sfm_jax import device; import jax; "
            "d = device.enable_compile_cache(); "
            "print(d, jax.config.jax_compilation_cache_dir)")
    outs = [
        subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                       capture_output=True, text=True, check=True,
                       ).stdout.split()
        for cwd in (REPO, tmp_path)
    ]
    assert outs[0] == outs[1] == [str(REPO / ".jax_cache")] * 2
