"""sweepSimple cross-check (SURVEY.md §5 item 2): the intentionally naive
recompute-from-scratch sweep must walk the SAME Markov chain as the
stabilized sweep (identical RNG stream, same accept decisions) and agree
on the Green function and observables at 1e-8 in fp64 — the reference's
de-facto integration test of the wrap/UdV-stack machinery."""

import jax
import jax.numpy as jnp
import numpy as np

from detqmc.models.hubbard import HubbardConfig, HubbardModel
from detqmc.models.sdw import SDWConfig, SDWModel


def test_hubbard_sweep_simple_matches_stabilized():
    cfg = HubbardConfig(L=4, U=4.0, mu=0.0, beta=1.2, m=12, s=4,
                        dtype="float64", ph_symmetry="off")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(7))

    st_fast, obs_fast = model.sweep_up(state, measure=True)
    st_naive, obs_naive = model.sweep_simple(state, measure=True)

    # identical accept decisions -> identical fields
    np.testing.assert_array_equal(np.asarray(st_fast.field),
                                  np.asarray(st_naive.field))
    assert float(st_fast.sign) == float(st_naive.sign)
    # same field => the naive path's from-scratch G(m) must equal the
    # stabilized sweep's final G (validates wraps + stack consumption)
    G_naive_m = model.green_at_slice(st_naive.field, cfg.m)
    np.testing.assert_allclose(np.asarray(st_fast.G),
                               np.asarray(G_naive_m), atol=1e-8)
    for name in ("occupancy", "doubleOccupancy", "kineticEnergy",
                 "spinStructureFactorAF", "acceptance"):
        np.testing.assert_allclose(
            float(getattr(obs_fast, name)),
            float(getattr(obs_naive, name)), atol=1e-8,
            err_msg=name)
    np.testing.assert_allclose(np.asarray(obs_fast.spinCorrelation),
                               np.asarray(obs_naive.spinCorrelation),
                               atol=1e-8)


def test_hubbard_sweep_simple_delayed_kernel_paths():
    """The naive sweep composes with the delayed-update path too."""
    cfg = HubbardConfig(L=4, U=4.0, beta=1.0, m=8, s=4, delay=4,
                        dtype="float64", ph_symmetry="off",
                        update_kernel="scan")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(3))
    st_fast, _ = model.sweep_up(state)
    st_naive, _ = model.sweep_simple(state)
    np.testing.assert_array_equal(np.asarray(st_fast.field),
                                  np.asarray(st_naive.field))


def test_sdw_sweep_simple_matches_stabilized():
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=1.0, m=8, s=4,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(11))

    st_fast, obs_fast = model.sweep_up(state, measure=True)
    st_naive, obs_naive = model.sweep_simple(state, measure=True)

    np.testing.assert_allclose(np.asarray(st_fast.phi),
                               np.asarray(st_naive.phi), atol=0, rtol=0)
    G_naive_m = model.green_at_slice(st_naive.phi, cfg.m)
    np.testing.assert_allclose(np.asarray(st_fast.G),
                               np.asarray(G_naive_m), atol=1e-8)
    for name in ("phiSquared", "occupancy", "kineticEnergy", "acceptance"):
        np.testing.assert_allclose(
            float(jnp.real(getattr(obs_fast, name))),
            float(jnp.real(getattr(obs_naive, name))), atol=1e-8,
            err_msg=name)


def test_sdw_sweep_simple_opdim3():
    cfg = SDWConfig(L=2, opdim=3, r=1.0, beta=1.0, m=8, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(5))
    st_fast, _ = model.sweep_up(state)
    st_naive, _ = model.sweep_simple(state)
    np.testing.assert_allclose(np.asarray(st_fast.phi),
                               np.asarray(st_naive.phi), atol=0, rtol=0)
