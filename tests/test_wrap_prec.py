"""Wrap-only matmul precision knob (SDWConfig.wrap_prec / wrapPrec).

wrap_prec="high" lets the backend run the B G B^-1 wrap products at a
reduced-precision rate where it has one — only the wrapped G between
stabilization anchors is affected (accept decisions; every measured G is
freshly stabilized and green_dev gates drift). On the CPU, HIGH and
HIGHEST are both full f32, so sweeps must be bit-identical — which also
proves the knob threads through the whole wrap path rather than silently
falling back.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.config import build_sdw_config
from detqmc.models.sdw import SDWConfig, SDWModel


def _sweep_obs(model):
    st = jax.jit(model.init_state)(jax.random.key(7))
    step = jax.jit(lambda s: model.sweep_pair(s, measure=True))
    for _ in range(3):
        st, obs = step(st)
    return st, obs


@pytest.mark.parametrize("opdim", [1, 3])
def test_wrap_prec_high_matches_highest_on_cpu(opdim):
    kw = dict(L=4, opdim=opdim, beta=2.0, m=16, s=4, dtype="float32",
              checkerboard=True)
    m_hi = SDWModel(SDWConfig(**kw, wrap_prec="highest"))
    m_h = SDWModel(SDWConfig(**kw, wrap_prec="high"))
    assert m_hi._wrap_prec == jax.lax.Precision.HIGHEST
    assert m_h._wrap_prec == jax.lax.Precision.HIGH
    st_hi, obs_hi = _sweep_obs(m_hi)
    st_h, obs_h = _sweep_obs(m_h)
    # CPU: HIGH == HIGHEST == full f32 -> identical Markov chain
    np.testing.assert_array_equal(np.asarray(st_hi.phi),
                                  np.asarray(st_h.phi))
    np.testing.assert_allclose(np.asarray(obs_hi.phiSquared),
                               np.asarray(obs_h.phiSquared), rtol=0)
    assert bool(jnp.all(jnp.isfinite(st_h.G)))


def test_wrap_prec_config_key_and_validation():
    cfg = build_sdw_config({"L": "4", "opdim": "1", "beta": "2.0",
                            "m": "8", "s": "2", "wrapPrec": "high"})
    assert cfg.wrap_prec == "high"
    with pytest.raises(ValueError):
        SDWConfig(L=4, opdim=1, beta=2.0, m=8, s=2, wrap_prec="bf16")


def test_wrap_prec_auto_resolves_highest_and_env_validated(monkeypatch):
    """auto = full f32, and a typo'd value fails loudly instead of
    silently measuring nothing; the config field is the only way to
    select the precision."""
    kw = dict(L=4, opdim=1, beta=2.0, m=8, s=2, dtype="float32")
    m_auto = SDWModel(SDWConfig(**kw, wrap_prec="auto"))
    assert m_auto._wrap_prec == jax.lax.Precision.HIGHEST
    with pytest.raises(ValueError):
        SDWModel(SDWConfig(**kw, wrap_prec="hgih"))
