"""Correctness gates for the Hubbard DQMC core (SURVEY.md §5 implications:
fp64 oracle agreement at 1e-8, free-fermion closed form, stabilized-vs-naive
agreement)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.models.hubbard import HubbardConfig, HubbardModel
from tests.oracle.hubbard_oracle import HubbardOracle, exact_free_green

CFG = HubbardConfig(L=4, t=1.0, U=4.0, mu=0.0, beta=4.0, m=40, s=8,
                    dtype="float64", ph_symmetry="off")


def make_state(cfg=CFG, seed=0):
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(seed))
    return model, state


def test_free_fermion_green():
    """U=0: G is slice-independent and equals [1 + e^{-beta K}]^{-1}."""
    cfg = HubbardConfig(L=4, U=0.0, beta=4.0, m=40, s=8, dtype="float64")
    model, state = make_state(cfg, seed=1)
    K = model.lat.hopping_matrix(cfg.t)
    G_exact = exact_free_green(K, cfg.beta)
    np.testing.assert_allclose(np.asarray(state.G[0]), G_exact, atol=1e-10)
    np.testing.assert_allclose(np.asarray(state.G[1]), G_exact, atol=1e-10)


def test_fixed_field_green_matches_oracle():
    """G(0) from the jitted stack build == fp64 NumPy oracle, 1e-8 gate."""
    model, state = make_state(seed=2)
    oracle = HubbardOracle(L=4, U=4.0, beta=4.0, m=40)
    s_field = np.asarray(state.field)
    for comp, spin in [(0, +1), (1, -1)]:
        G_oracle = oracle.green(s_field, spin, 0)
        np.testing.assert_allclose(np.asarray(state.G[comp]), G_oracle,
                                   atol=1e-8)


def test_green_naive_agrees_with_stabilized_oracle():
    """Oracle self-check: stabilized == naive at beta=4 in fp64."""
    oracle = HubbardOracle(L=2, U=4.0, beta=4.0, m=40)
    rng = np.random.default_rng(3)
    s = rng.choice([-1.0, 1.0], size=(40, 4))
    for spin in (+1, -1):
        G1 = oracle.green(s, spin, 13)
        G2 = oracle.green_naive(s, spin, 13)
        # the naive inverse itself carries O(kappa * eps) ~ 1e-8 error at
        # beta = 4; the tight 1e-8 gates are stabilized-vs-stabilized
        np.testing.assert_allclose(G1, G2, atol=1e-7)


def test_update_slice_matches_fresh_green():
    """Force-accept all flips in slice l; the SM-updated G must equal the
    from-scratch stabilized G of the flipped configuration (validates the
    determinant-ratio bookkeeping and rank-1 update exactly)."""
    model, state = make_state(seed=4)
    oracle = HubbardOracle(L=4, U=4.0, beta=4.0, m=40)
    s_field = np.asarray(state.field)
    l = 17
    G = jnp.stack([jnp.asarray(oracle.green(s_field, +1, l)),
                   jnp.asarray(oracle.green(s_field, -1, l))])
    u01 = jnp.zeros(16, jnp.float64)  # accept everything (|R| > 0)
    G_new, fl_new, _, acc = model.update_slice(G, state.field[l - 1], u01)
    assert float(acc) == 1.0
    np.testing.assert_array_equal(np.asarray(fl_new), -s_field[l - 1])
    s_flipped = s_field.copy()
    s_flipped[l - 1] = -s_flipped[l - 1]
    for comp, spin in [(0, +1), (1, -1)]:
        G_oracle = oracle.green(s_flipped, spin, l)
        np.testing.assert_allclose(np.asarray(G_new[comp]), G_oracle,
                                   atol=1e-8)


def test_sweep_self_consistency():
    """After each sweep, G at the sweep edge must equal the from-scratch
    stabilized recompute of the updated field (the reference's
    greenConsistency instrumentation as a hard test, SURVEY.md §5 item 1)."""
    model, state = make_state(seed=5)
    for i in range(3):
        state, _ = model.sweep_up(state) if i % 2 == 0 \
            else model.sweep_down(state)
        refreshed = model.refresh_from_field(state)
        np.testing.assert_allclose(np.asarray(state.G),
                                   np.asarray(refreshed.G), atol=1e-8)
        assert float(state.green_dev) < 1e-8
        assert int(state.sweeps_done) == i + 1


def test_sweep_changes_field_and_accepts():
    model, state = make_state(seed=6)
    f0 = np.asarray(state.field).copy()
    state, obs = model.sweep_up(state, measure=True)
    assert (np.asarray(state.field) != f0).any()
    assert 0.05 < float(obs.acceptance) < 0.95
    # half filling: the tracked weight sign must stay exactly +1
    assert float(state.sign) == 1.0
    assert float(obs.sign) == 1.0


def test_observables_match_oracle_fixed_field():
    model, state = make_state(seed=7)
    oracle = HubbardOracle(L=4, U=4.0, beta=4.0, m=40)
    obs = model.measure_equal_time(state.G, jnp.zeros(()))
    s_field = np.asarray(state.field)
    Gu = oracle.green(s_field, +1, 0)
    Gd = oracle.green(s_field, -1, 0)
    ref = oracle.observables(Gu, Gd)
    for name in ("occupancy", "doubleOccupancy", "kineticEnergy",
                 "potentialEnergy", "totalEnergy"):
        np.testing.assert_allclose(float(getattr(obs, name)), ref[name],
                                   atol=1e-8, err_msg=name)
    assert float(obs.sign) == pytest.approx(1.0)


def test_delayed_update_equals_plain():
    """delay>0 must reproduce the plain rank-1 path exactly (same RNG)."""
    cfg_plain = CFG
    cfg_delay = HubbardConfig(**{**dataclass_asdict(CFG), "delay": 8})
    m1 = HubbardModel(cfg_plain)
    m2 = HubbardModel(cfg_delay)
    s1 = m1.init_state(jax.random.key(8))
    s2 = m2.init_state(jax.random.key(8))
    np.testing.assert_array_equal(np.asarray(s1.field), np.asarray(s2.field))
    s1, o1 = m1.sweep_up(s1, measure=True)
    s2, o2 = m2.sweep_up(s2, measure=True)
    np.testing.assert_array_equal(np.asarray(s1.field), np.asarray(s2.field))
    np.testing.assert_allclose(np.asarray(s1.G), np.asarray(s2.G), atol=1e-9)
    np.testing.assert_allclose(float(o1.occupancy), float(o2.occupancy),
                               atol=1e-10)


def test_checkerboard_self_consistency():
    """Checkerboard breakup is a different discretization; it must still be
    internally consistent (stabilized == wrapped) and accept flips."""
    cfg = HubbardConfig(L=4, U=4.0, beta=4.0, m=40, s=8,
                        checkerboard=True, dtype="float64")
    model, state = make_state(cfg, seed=9)
    state, obs = model.sweep_up(state, measure=True)
    refreshed = model.refresh_from_field(state)
    np.testing.assert_allclose(np.asarray(state.G),
                               np.asarray(refreshed.G), atol=1e-8)
    assert float(state.green_dev) < 1e-8
    state, _ = model.sweep_down(state)
    assert float(state.green_dev) < 1e-8


def test_vmap_walkers():
    """Walker batching: vmapped sweeps run and stay self-consistent."""
    model = HubbardModel(CFG)
    keys = jax.random.split(jax.random.key(10), 3)
    states = jax.vmap(model.init_state)(keys)
    sweep = jax.vmap(lambda st: model.sweep_up(st, measure=True))
    states, obs = sweep(states)
    assert obs.occupancy.shape == (3,)
    assert np.asarray(states.green_dev).max() < 1e-8
    # walkers decorrelate: fields differ
    f = np.asarray(states.field)
    assert (f[0] != f[1]).any()


def dataclass_asdict(cfg):
    import dataclasses
    return dataclasses.asdict(cfg)


def test_ph_symmetry_equivalent_chain():
    """Particle-hole mode must produce the same Markov chain as the
    two-sector simulation (the accept ratios are mathematically equal:
    R_up R_dn = R_up^2 e^{2 alpha s})."""
    import dataclasses
    base = dict(L=4, U=4.0, mu=0.0, beta=4.0, m=40, s=8, dtype="float64")
    m_off = HubbardModel(HubbardConfig(**base, ph_symmetry="off"))
    m_on = HubbardModel(HubbardConfig(**base, ph_symmetry="on"))
    s_off = m_off.init_state(jax.random.key(12))
    s_on = m_on.init_state(jax.random.key(12))
    np.testing.assert_array_equal(np.asarray(s_off.field),
                                  np.asarray(s_on.field))
    for _ in range(2):
        s_off, o_off = m_off.sweep_pair(s_off, measure=True)
        s_on, o_on = m_on.sweep_pair(s_on, measure=True)
    np.testing.assert_array_equal(np.asarray(s_off.field),
                                  np.asarray(s_on.field))
    np.testing.assert_allclose(np.asarray(s_off.G[0]),
                               np.asarray(s_on.G[0]), atol=1e-10)
    for name in ("occupancy", "doubleOccupancy", "totalEnergy",
                 "spinStructureFactorAF"):
        np.testing.assert_allclose(float(getattr(o_off, name)),
                                   float(getattr(o_on, name)), atol=1e-9,
                                   err_msg=name)
