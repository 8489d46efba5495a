"""Wolff cluster update: invariants and boson-limit distribution check."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.models.sdw import SDWConfig, SDWModel


def test_wolff_preserves_phi_norm_and_consistency():
    cfg = SDWConfig(L=2, opdim=3, r=0.5, beta=1.0, m=4, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(0))
    norms_before = np.sort(np.asarray(
        jnp.sum(state.phi ** 2, axis=-1)).ravel())
    state2, accepted, csize = model.attempt_wolff_update(state)
    # reflections preserve each |phi| exactly
    norms_after = np.sort(np.asarray(
        jnp.sum(state2.phi ** 2, axis=-1)).ravel())
    np.testing.assert_allclose(norms_after, norms_before, rtol=1e-12)
    assert 1 <= int(csize) <= cfg.m * cfg.n_sites
    refreshed = model.refresh_from_field(state2)
    np.testing.assert_allclose(np.asarray(state2.G),
                               np.asarray(refreshed.G), atol=1e-10)


def test_wolff_always_accepts_in_boson_limit():
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(1))
    for i in range(3):
        state, accepted, _ = model.attempt_wolff_update(state)
        assert bool(accepted)


@pytest.mark.slow
def test_wolff_plus_metropolis_samples_same_distribution():
    """Boson limit: interleaving Wolff clusters with Metropolis sweeps must
    not change <phi^2> (detailed-balance check vs Metropolis-only)."""
    cfg = SDWConfig(L=2, opdim=2, r=1.5, u=0.5, beta=2.0, m=8, s=2,
                    turnoffFermions=True, dtype="float64", box_width=1.2)
    model = SDWModel(cfg)

    def run(with_wolff, seed, n=260, warm=60):
        state = model.init_state(jax.random.key(seed))
        step = jax.jit(lambda st: model.sweep_pair(st, measure=True))
        wolff = jax.jit(model.attempt_wolff_update)
        vals = []
        for it in range(n):
            state, obs = step(state)
            if with_wolff and it % 2 == 0:
                state, _, _ = wolff(state)
            if it >= warm:
                vals.append(float(obs.phiSquared))
        return np.array(vals)

    a = np.concatenate([run(False, 3), run(False, 5)])
    b = np.concatenate([run(True, 4), run(True, 6)])
    err = np.hypot(a.std() / np.sqrt(len(a) / 10),
                   b.std() / np.sqrt(len(b) / 10))
    assert abs(a.mean() - b.mean()) < 5 * err + 0.02, \
        f"{a.mean()} vs {b.mean()} +- {err}"

def test_wolff_shift_preserves_distribution():
    """Boson limit: interleaving the compound cluster-reflection+shift
    move must not change <phi^2> (acceptance carries the r/u potential
    difference; the shift is drawn perpendicular to the reflection axis
    so the cluster construction stays balanced)."""
    cfg = SDWConfig(L=2, opdim=2, r=1.5, u=0.5, beta=2.0, m=8, s=2,
                    turnoffFermions=True, dtype="float64", box_width=1.2,
                    wolffClusterShiftUpdate=True)
    model = SDWModel(cfg)

    def run(with_move, seed, n=260, warm=60):
        state = model.init_state(jax.random.key(seed))
        step = jax.jit(lambda st: model.sweep_pair(st, measure=True))
        move = jax.jit(model.attempt_wolff_shift_update)
        vals = []
        for it in range(n):
            state, obs = step(state)
            if with_move and it % 2 == 0:
                state, _, _ = move(state)
            if it >= warm:
                vals.append(float(obs.phiSquared))
        return np.array(vals)

    a = np.concatenate([run(False, 3), run(False, 5)])
    b = np.concatenate([run(True, 4), run(True, 6)])
    err = np.hypot(a.std() / np.sqrt(len(a) / 10),
                   b.std() / np.sqrt(len(b) / 10))
    assert abs(a.mean() - b.mean()) < 5 * err + 0.02, \
        f"{a.mean()} vs {b.mean()} +- {err}"


def test_wolff_shift_state_consistency_with_fermions():
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=1.0, m=4, s=2,
                    dtype="float64", wolffClusterShiftUpdate=True)
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(9))
    state, accepted, size = model.attempt_wolff_shift_update(state)
    refreshed = model.refresh_from_field(state)
    np.testing.assert_allclose(np.asarray(state.G),
                               np.asarray(refreshed.G), atol=1e-10)
    assert int(size) >= 1


@pytest.mark.parametrize("method", ["rotate_then_scale",
                                    "rotate_and_scale"])
def test_proposal_methods_sample_same_distribution(method):
    """Boson limit, opdim=3 (the r^2 measure factor (r'/r)^{opdim-2} is
    nontrivial): rotate/scale proposals must reproduce the box-proposal
    <phi^2> within errors."""
    base = dict(L=2, opdim=3, r=1.5, u=0.5, beta=2.0, m=8, s=2,
                turnoffFermions=True, dtype="float64", box_width=1.0)

    def run(spm, seed, n=300, warm=60):
        model = SDWModel(SDWConfig(**base, spinProposalMethod=spm))
        state = model.init_state(jax.random.key(seed))
        step = jax.jit(lambda st: model.sweep_pair(st, measure=True))
        vals = []
        for it in range(n):
            state, obs = step(state)
            if it >= warm:
                vals.append(float(obs.phiSquared))
        return np.array(vals)

    a = np.concatenate([run("box", 3), run("box", 5)])
    b = np.concatenate([run(method, 4), run(method, 6)])
    err = np.hypot(a.std() / np.sqrt(len(a) / 10),
                   b.std() / np.sqrt(len(b) / 10))
    assert abs(a.mean() - b.mean()) < 5 * err + 0.02, \
        f"box {a.mean()} vs {method} {b.mean()} +- {err}"


def test_rotate_scale_fermionic_self_consistency():
    """Full fermionic sweep with rotate_and_scale proposals: wrapped G
    stays on the stabilized one and accept/reject stays sane."""
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=2.0, m=8, s=2,
                    dtype="float64",
                    spinProposalMethod="rotate_and_scale")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(12))
    for _ in range(2):
        state, obs = model.sweep_pair(state, measure=True)
    refreshed = model.refresh_from_field(state)
    np.testing.assert_allclose(np.asarray(state.G),
                               np.asarray(refreshed.G), atol=1e-8)
    assert float(state.green_dev) < 1e-8
    assert 0.0 < float(obs.acceptance) < 1.0
