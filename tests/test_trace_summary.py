"""scripts/trace_summary.py reduces a recorded jax.profiler trace: busy
time is the union of event intervals, idle share = 1 - busy / window."""

import os
import sys

import jax
import jax.numpy as jnp
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))

import trace_summary  # noqa: E402


def test_summarize_recorded_trace(tmp_path):
    f = jax.jit(lambda x: jnp.sin(x) @ x)
    x = jnp.ones((128, 128))
    f(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        for _ in range(3):
            f(x).block_until_ready()
    out = trace_summary.summarize(str(tmp_path), device_prefix="/host:CPU")
    assert out["device_events"] > 0
    assert 0.0 <= out["idle_share"] <= 1.0
    assert out["busy_ms"] <= out["window_ms"] + 1e-9
    assert out["top_kernels"]
    # no GPU plane in a CPU trace
    assert trace_summary.summarize(str(tmp_path))["device_events"] == 0


def test_newest_xplane_missing(tmp_path):
    with pytest.raises(FileNotFoundError):
        trace_summary.newest_xplane(str(tmp_path))
