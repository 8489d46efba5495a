"""Away from half filling: exact sign tracking + sign-weighted estimates
vs exact diagonalization (the reference records observables and sign
separately; reweighting <O s>/<s> happens in analysis)."""

import jax
import numpy as np
import pytest

from detqmc.models.hubbard import HubbardConfig, HubbardModel
from tests.oracle.hubbard_oracle import hubbard_ed


@pytest.mark.slow
def test_mu_nonzero_vs_ed():
    cfg = HubbardConfig(L=2, U=4.0, mu=0.6, beta=2.0, m=40, s=4,
                        dtype="float64")
    assert cfg.ncomp == 2  # ph mode must auto-disable away from mu=0
    model = HubbardModel(cfg)
    keys = jax.random.split(jax.random.key(0), 8)
    states = jax.jit(jax.vmap(model.init_state))(keys)
    step = jax.jit(jax.vmap(lambda st: model.sweep_pair(st, measure=True)))

    # init signs must match the slogdet of the actual chains
    host_sign = model.host_chain_sign(states)
    np.testing.assert_allclose(np.asarray(states.sign), host_sign)

    occ_s, docc_s, sgn_s = [], [], []
    for it in range(400):
        states, obs = step(states)
        if it >= 80:
            occ_s.append(np.asarray(obs.occupancy))
            docc_s.append(np.asarray(obs.doubleOccupancy))
            sgn_s.append(np.asarray(obs.sign))
    occ = np.concatenate(occ_s)
    docc = np.concatenate(docc_s)
    sgn = np.concatenate(sgn_s)

    # signs average within a sweep; must stay in [-1, 1] and mostly +1
    assert np.all(np.abs(sgn) <= 1.0 + 1e-12) and np.mean(sgn) > 0.5

    # observables come sign-weighted from the model: estimate = <Os>/<s>
    def est(o):
        return float(np.mean(o) / np.mean(sgn))

    K = model.lat.hopping_matrix(cfg.t)
    exact = hubbard_ed(np.asarray(K), cfg.U, cfg.mu, cfg.beta)
    n_eff = len(occ) / 20.0  # crude autocorrelation discount
    for name, series in [("occupancy", occ), ("doubleOccupancy", docc)]:
        err = np.std(series) / np.sqrt(n_eff) / max(abs(np.mean(sgn)), .1)
        tol = 5 * err + 0.03  # + Trotter headroom (dtau = 0.05)
        assert abs(est(series) - exact[name]) < tol, (
            f"{name}: {est(series)} vs ED {exact[name]} (tol {tol}, "
            f"<sign> = {np.mean(sgn):.3f})")
    # occupancy must shift away from 1 with mu > 0
    assert est(occ) > 1.02