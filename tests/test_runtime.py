"""Entry-point set-up: the GPU requirement, the compile cache, and
chip_smoke.py's refusal to run without a GPU."""

import json
import os
import subprocess
import sys

import jax
import pytest

from mojosplat_jax.utils import runtime

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
        runtime.require_gpu()


def test_compile_cache_env_var_wins(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert calls == []  # JAX reads the variable itself


def test_compile_cache_defaults_to_checkout(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]


def test_chip_smoke_fails_without_gpu(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    lines = out.stdout.strip().splitlines()
    if lines:
        with pytest.raises(json.JSONDecodeError):
            json.loads(lines[-1])
