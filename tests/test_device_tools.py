"""Device plumbing that runs without an accelerator: the compile-cache
rule, the device_kind-keyed peak table, and chip_smoke.py refusing to
run (and printing no result) without a GPU."""
import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from rltime_tpu.utils import compile_cache, device_info

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _recording_config(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_compile_cache_honours_env_var(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    calls = _recording_config(monkeypatch)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_is_fixed_checkout_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _recording_config(monkeypatch)
    d = compile_cache.enable_compile_cache()
    assert d == os.path.join(REPO, ".jax_cache")
    assert calls == [("jax_compilation_cache_dir", d)]
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_peak_table_rejects_unknown_device_kind():
    assert device_info.peak("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(KeyError, match="no published peak"):
        device_info.peak("cpu")


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (ValueError, TypeError):
            continue
    return False


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO)
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert not _printed_result(r.stdout)


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert not _printed_result(r.stdout)
