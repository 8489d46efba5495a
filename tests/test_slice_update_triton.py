"""The fused Hubbard slice-update kernel (Pallas, Triton route) against the
lax.scan reference, in the Pallas interpreter; and the model's choice of
route. The compiled kernel runs on the GPU only (chip_smoke.py compares
it with the scan there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.linalg import slice_update_triton as sut
from detqmc.models.hubbard import HubbardConfig, HubbardModel

_LATTICE = {4: (2, 2), 16: (4, 2), 36: (6, 2), 64: (8, 2)}  # N: (L, d)


def _setup(n, ncomp, walkers=2):
    L, d = _LATTICE[n]
    cfg = HubbardConfig(L=L, d=d, U=4.0, beta=2.0, m=8, s=4,
                        dtype="float32", update_kernel="scan",
                        ph_symmetry="on" if ncomp == 1 else "off")
    model = HubbardModel(cfg)
    states = jax.vmap(model.init_state)(
        jax.random.split(jax.random.key(n), walkers))
    return cfg, model, states


@pytest.mark.parametrize("regime", ["all", "none", "random"])
@pytest.mark.parametrize("ncomp", [1, 2])
@pytest.mark.parametrize("n", [4, 16, 36, 64])
def test_kernel_matches_scan(n, ncomp, regime):
    """Identical accept decisions, signs and acceptance; G to f32
    rounding. N = 36 pads the tile to 64."""
    cfg, model, states = _setup(n, ncomp)
    W = states.G.shape[0]
    if regime == "all":
        u01 = jnp.zeros((W, n), jnp.float32)
    elif regime == "none":
        u01 = jnp.full((W, n), jnp.inf, jnp.float32)
    else:
        u01 = jax.random.uniform(jax.random.key(5), (W, n), jnp.float32)
    signs = jnp.asarray([1.0, -1.0][:W], jnp.float32)
    fl = states.field[:, 3]
    G1, f1, s1, a1 = jax.vmap(model._update_slice)(states.G, fl, u01,
                                                   signs)
    G2, f2, s2, a2 = jax.vmap(lambda g, f, u, s: sut.slice_update(
        g, f, u, s, alpha=cfg.alpha, ph_on=cfg.ph_on, interpret=True))(
            states.G, fl, u01, signs)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    assert G2.shape == G1.shape
    np.testing.assert_allclose(np.asarray(G1), np.asarray(G2), atol=1e-5)
    if regime == "none":
        np.testing.assert_array_equal(np.asarray(G2),
                                      np.asarray(states.G))


def test_padded_size():
    assert [sut.padded_size(n) for n in (4, 16, 36, 64)] == [16, 16, 64, 64]


def test_kernel_rejects_large_or_f64():
    G = jnp.zeros((1, 100, 100), jnp.float32)
    with pytest.raises(ValueError, match="N <= 64"):
        sut.slice_update(G, jnp.ones(100), jnp.ones(100), jnp.ones(()),
                         alpha=0.5, ph_on=True, interpret=True)
    with pytest.raises(ValueError, match="float32"):
        sut.slice_update(jnp.zeros((1, 4, 4)), jnp.ones(4), jnp.ones(4),
                         jnp.ones(()), alpha=0.5, ph_on=True,
                         interpret=True)


@pytest.mark.parametrize("kw, use_kernel", [
    (dict(), False),                       # auto off the GPU: scan
    (dict(update_kernel="scan"), False),
    (dict(update_kernel="triton"), True),
])
def test_model_route_choice(kw, use_kernel):
    model = HubbardModel(HubbardConfig(L=4, beta=1.0, m=4, s=2,
                                       dtype="float32", **kw))
    assert model._use_kernel is use_kernel


@pytest.mark.parametrize("kw", [
    dict(dtype="float64"),
    dict(dtype="float32", delay=4),
    dict(dtype="float32", L=10),
])
def test_model_rejects_forced_kernel_outside_its_range(kw):
    kw = {"L": 4, **kw}
    with pytest.raises(ValueError, match="update_kernel='triton'"):
        HubbardModel(HubbardConfig(beta=1.0, m=4, s=2,
                                   update_kernel="triton", **kw))


def test_forced_kernel_never_falls_back_to_the_cpu_interpreter():
    """Forcing the kernel where there is no GPU fails instead of running
    the interpreter silently."""
    cfg = HubbardConfig(L=2, beta=1.0, m=4, s=2, dtype="float32",
                        update_kernel="triton")
    model = HubbardModel(cfg)
    st = model.init_state(jax.random.key(0))
    with pytest.raises(Exception, match="interpret"):
        jax.jit(model.update_slice)(st.G, st.field[0],
                                    jnp.zeros(4, jnp.float32), st.sign)


@pytest.mark.gpu
def test_compiled_kernel_matches_scan(gpu):
    """The kernel as compiled for the card (no interpreter) at the bench
    shape: N = 64, 256 walkers (chip_smoke.py's update_kernel phase)."""
    import chip_smoke

    rec = chip_smoke.phase_update_kernel()
    assert rec["ok"], rec
