"""Driver end-to-end: tiny Hubbard run vs exact diagonalization, checkpoint
determinism (SURVEY.md §5 implications (c), (e))."""

import numpy as np
import pytest

from detqmc.driver import DetQMC, DriverConfig
from detqmc.models.hubbard import HubbardConfig, HubbardModel
from tests.oracle.hubbard_oracle import hubbard_ed


def test_sweep_pair_self_consistent_after_init():
    """Pairs must compose with the init-built stack (up first)."""
    import jax
    model = HubbardModel(HubbardConfig(L=4, U=4.0, beta=4.0, m=40, s=8,
                                       dtype="float64"))
    state = model.init_state(jax.random.key(0))
    for _ in range(2):
        state, _ = model.sweep_pair(state, measure=True)
        assert float(state.green_dev) < 1e-8
        refreshed = model.refresh_from_field(state)
        np.testing.assert_allclose(np.asarray(state.G),
                                   np.asarray(refreshed.G), atol=1e-8)


@pytest.mark.slow
def test_hubbard_vs_exact_diagonalization():
    """Statistical end-to-end gate: L=2 lattice (4 sites, doubled bonds ->
    effective hopping 2t) vs exact diagonalization of the identical
    Hamiltonian. Tolerance = Trotter error (~U t dtau^2) + 5 sigma MC."""
    from detqmc.lattice import SquareLattice

    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=40, s=4, dtype="float64")
    model = HubbardModel(cfg)
    p = DriverConfig(sweeps=400, thermalization=60, measure_interval=1,
                     jk_blocks=10, n_walkers=8, seed=11, block_meas=100)
    qmc = DetQMC(model, p)
    res = qmc.run()

    K = SquareLattice(2).hopping_matrix(cfg.t)
    exact = hubbard_ed(K, cfg.U, cfg.mu, cfg.beta)
    for name in ("occupancy", "doubleOccupancy", "kineticEnergy",
                 "totalEnergy"):
        mean, err = res[name]
        tol = 5.0 * err + 0.02  # MC + Trotter headroom (dtau = 0.05)
        assert abs(mean - exact[name]) < tol, (
            f"{name}: qmc {mean}+-{err} vs ED {exact[name]}")


@pytest.mark.slow
def test_driver_run_and_resume(tmp_path):
    cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=20, s=4, dtype="float64")
    model = HubbardModel(cfg)
    out = str(tmp_path / "run")
    p = DriverConfig(sweeps=40, thermalization=10, measure_interval=1,
                     save_interval=20, jk_blocks=4, timeseries=True,
                     outdir=out, n_walkers=2, seed=3, block_meas=10)
    qmc = DetQMC(model, p)
    res = qmc.run()
    assert res["occupancy"][0] == pytest.approx(1.0, abs=1e-9)
    assert (tmp_path / "run" / "info.dat").exists()
    assert (tmp_path / "run" / "results.values").exists()
    assert (tmp_path / "run" / "state.npz").exists()

    # interrupted-vs-continuous determinism: fresh driver resumes and
    # continues; counters and accumulators restore
    qmc2 = DetQMC(HubbardModel(cfg), p)
    qmc2.init(resume=True)
    assert qmc2.measurements_done == 40
    assert qmc2.handler.n_samples() == 40
    np.testing.assert_allclose(np.asarray(qmc2.states.field),
                               np.asarray(qmc.states.field))
    np.testing.assert_allclose(np.asarray(qmc2.states.G),
                               np.asarray(qmc.states.G), atol=1e-8)


@pytest.mark.slow
def test_small_lattice_vs_oracle_mc():
    """Independent-code cross-check: the jitted JAX chain and the
    fp64 NumPy oracle chain sample the same distribution (L=2, beta=2).
    Observables must agree within combined stochastic error."""
    import jax
    from tests.oracle.hubbard_oracle import HubbardOracle

    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=20, s=4, dtype="float64")
    model = HubbardModel(cfg)
    p = DriverConfig(sweeps=300, thermalization=50, measure_interval=1,
                     jk_blocks=10, n_walkers=8, seed=1, block_meas=50)
    qmc = DetQMC(model, p)
    res = qmc.run()

    oracle = HubbardOracle(L=2, U=4.0, beta=2.0, m=20)
    rng = np.random.default_rng(7)
    s = rng.choice([-1.0, 1.0], size=(20, 4))
    vals = {"occupancy": [], "doubleOccupancy": [], "totalEnergy": []}
    for it in range(260):
        s, _ = oracle.sweep(s, rng, stab_interval=4)
        if it >= 60:
            Gu = oracle.green(s, +1, 0)
            Gd = oracle.green(s, -1, 0)
            o = oracle.observables(Gu, Gd)
            for k in vals:
                vals[k].append(o[k])
    for k in vals:
        o_mean = np.mean(vals[k])
        o_err = np.std(vals[k]) / np.sqrt(len(vals[k]) / 10)  # crude tau
        mean, err = res[k]
        tol = 5.0 * np.hypot(err, o_err)
        assert abs(mean - o_mean) < max(tol, 0.02), (
            f"{k}: jax {mean}+-{err} vs oracle {o_mean}+-{o_err}")
