"""Option values that chose removed device routes are rejected by name;
the compile-cache location rules; the on-card entry points refuse a
machine without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from detqmc import compile_cache
from detqmc.config import (
    ConfigurationError,
    build_hubbard_config,
    build_sdw_config,
)
from detqmc.models.hubbard import HubbardConfig
from detqmc.models.sdw import SDWConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_HUB = {"L": "2", "beta": "1.0", "m": "4", "s": "2"}
_SDW = {"L": "2", "opdim": "2", "beta": "1.0", "m": "4", "s": "2"}

# (model, key, removed value, text the error must name)
_REMOVED_CLI = [
    ("hubbard", "updateKernel", "pallas", "auto|scan|triton"),
    ("hubbard", "updateKernel", "lanes", "auto|scan|triton"),
    ("hubbard", "greenKernel", "df32", "unknown parameter 'greenKernel'"),
    ("hubbard", "greenKernel", "refine", "unknown parameter 'greenKernel'"),
    ("hubbard", "greenKernel", "pallas", "unknown parameter 'greenKernel'"),
    ("hubbard", "greenRefineIters", "2",
     "unknown parameter 'greenRefineIters'"),
    ("hubbard", "ozakiChainLimbs", "5",
     "unknown parameter 'ozakiChainLimbs'"),
    ("sdw", "fermionRepr", "native_pair", "auto|complex|real_embed"),
    ("sdw", "updateKernel", "pallas", "auto|scan"),
    ("sdw", "updateKernel", "delayed", "auto|scan"),
    ("sdw", "greenKernel", "df32", "unknown parameter 'greenKernel'"),
    ("sdw", "greenKernel", "refine", "unknown parameter 'greenKernel'"),
    ("sdw", "greenKernel", "pallas", "unknown parameter 'greenKernel'"),
    ("sdw", "wrapKernel", "fused", "unknown parameter 'wrapKernel'"),
    ("sdw", "greenRefineIters", "2", "unknown parameter 'greenRefineIters'"),
    ("sdw", "ozakiChainLimbs", "4", "unknown parameter 'ozakiChainLimbs'"),
]


@pytest.mark.parametrize("model, key, value, named", _REMOVED_CLI)
def test_removed_cli_value_rejected(model, key, value, named):
    build, base = ((build_hubbard_config, _HUB) if model == "hubbard"
                   else (build_sdw_config, _SDW))
    with pytest.raises(ConfigurationError, match=named.replace("|", r"\|")):
        build({**base, key: value})


_REMOVED_FIELDS = [
    (HubbardConfig, "update_kernel", "pallas", ValueError),
    (HubbardConfig, "update_kernel", "lanes", ValueError),
    (HubbardConfig, "green_kernel", "df32", TypeError),
    (HubbardConfig, "green_refine_iters", 2, TypeError),
    (HubbardConfig, "ozaki_chain_limbs", 5, TypeError),
    (SDWConfig, "fermion_repr", "native_pair", ValueError),
    (SDWConfig, "update_kernel", "pallas", ValueError),
    (SDWConfig, "update_kernel", "delayed", ValueError),
    (SDWConfig, "green_kernel", "refine", TypeError),
    (SDWConfig, "wrap_kernel", "fused", TypeError),
    (SDWConfig, "green_refine_iters", 2, TypeError),
    (SDWConfig, "ozaki_chain_limbs", 4, TypeError),
]


@pytest.mark.parametrize("cls, field, value, exc", _REMOVED_FIELDS)
def test_removed_dataclass_value_rejected(cls, field, value, exc):
    """A removed value raises ValueError naming the valid ones; a field
    that only chose removed routes no longer exists (TypeError)."""
    with pytest.raises(exc) as info:
        cls(**{field: value})
    if exc is ValueError:
        assert "auto" in str(info.value)


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    try:
        yield
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_defaults_inside_checkout(monkeypatch,
                                                restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", None)
    compile_cache.enable()
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        ROOT, ".jax_cache")
    assert os.path.isdir(os.path.join(ROOT, ".jax_cache"))


def test_compile_cache_env_sets_nothing(monkeypatch, restore_cache_dir,
                                        tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    jax.config.update("jax_compilation_cache_dir", None)
    compile_cache.enable()
    assert jax.config.jax_compilation_cache_dir is None


def test_compile_cache_keeps_configured_dir(monkeypatch, restore_cache_dir,
                                            tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    jax.config.update("jax_compilation_cache_dir", str(tmp_path))
    compile_cache.enable()
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def _run_cpu(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_on_card_scripts_refuse_cpu(script):
    out = _run_cpu([script], ROOT)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the package, the smoke test cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    out = _run_cpu(["chip_smoke.py"], tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
