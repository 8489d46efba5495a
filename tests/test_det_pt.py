"""Det-coupled (config-swap) parallel tempering: log-weight oracles +
driver behavior (VERDICT r4 item 6; SURVEY.md §9 "Parallel tempering" —
the beta/det-coupled case the reference's bosonic-only exchange formula
cannot cover)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.driver import DriverConfig
from detqmc.models.hubbard import HubbardConfig, HubbardModel
from detqmc.models.sdw import SDWConfig, SDWModel
from detqmc.parallel.det_pt import DetPTConfig, DetQMCPTDet
from tests.oracle.hubbard_oracle import HubbardOracle
from tests.oracle.sdw_oracle import SDWOracle


# ---- log-weight oracles ----------------------------------------------------

@pytest.mark.parametrize("opdim", [2, 3])
def test_sdw_log_weight_matches_dense_oracle(opdim):
    """model.log_weight == log|det(1 + B-chain)| - S_B from the dense
    fp64 4N-complex oracle (physical weight; the reduced opdim<=2
    representation's 2 log|det M_A| equals log|det M_full|)."""
    cfg = SDWConfig(L=2, opdim=opdim, r=0.3, beta=2.0, m=8, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    oracle = SDWOracle(L=2, opdim=opdim, r=0.3, beta=2.0, m=8)
    rng = np.random.default_rng(3)
    phi = rng.normal(size=(8, 4, opdim)) * 0.7
    ld_oracle = np.log(np.abs(oracle.det_M(phi)))
    sb_oracle = oracle.boson_action(phi)
    got = float(model.log_weight(jnp.asarray(phi)))
    np.testing.assert_allclose(got, ld_oracle - sb_oracle, rtol=1e-8)


def test_sdw_log_weight_r_override():
    """The optional r override shifts the weight by exactly the linear
    bosonic term (the det is r-independent) — consistency between the
    det-PT path and the label-swap exchange_action convention."""
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=2.0, m=8, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    rng = np.random.default_rng(4)
    phi = jnp.asarray(rng.normal(size=(8, 4, 2)) * 0.7)
    lw_a = float(model.log_weight(phi, r=0.5))
    lw_b = float(model.log_weight(phi, r=1.1))
    a = 0.5 * cfg.dtau * float(jnp.sum(phi ** 2))
    np.testing.assert_allclose(lw_a - lw_b, (1.1 - 0.5) * a, rtol=1e-10)


@pytest.mark.parametrize("mode", ["ph", "two_sector"])
def test_hubbard_log_weight_matches_dense_oracle(mode):
    mu = 0.0 if mode == "ph" else -0.4
    cfg = HubbardConfig(L=2, U=4.0, mu=mu, beta=2.0, m=8, s=2,
                        dtype="float64",
                        ph_symmetry="auto" if mode == "ph" else "off")
    model = HubbardModel(cfg)
    oracle = HubbardOracle(L=2, U=4.0, mu=mu, beta=2.0, m=8)
    rng = np.random.default_rng(5)
    field = rng.choice([-1.0, 1.0], size=(8, 4))
    want = 0.0
    for spin in (+1, -1):
        A = np.eye(4) + oracle.b_chain(field, spin, 0, 8)
        want += np.linalg.slogdet(A)[1]
    got = float(model.log_weight(jnp.asarray(field)))
    np.testing.assert_allclose(got, want, rtol=1e-8)


def test_hubbard_log_weight_beta_grid_delta():
    """The det-PT swap log-ratio for a beta pair matches the brute-force
    fp64 determinant computation (VERDICT r4 item 6 'Done' criterion)."""
    betas = (2.0, 2.6)
    models, oracles = [], []
    for b in betas:
        models.append(HubbardModel(HubbardConfig(
            L=2, U=4.0, beta=b, m=8, s=2, dtype="float64")))
        oracles.append(HubbardOracle(L=2, U=4.0, beta=b, m=8))
    rng = np.random.default_rng(6)
    C0 = rng.choice([-1.0, 1.0], size=(8, 4))
    C1 = rng.choice([-1.0, 1.0], size=(8, 4))

    def lw_oracle(o, s):
        out = 0.0
        for spin in (+1, -1):
            A = np.eye(4) + o.b_chain(s, spin, 0, 8)
            out += np.linalg.slogdet(A)[1]
        return out

    delta_oracle = (lw_oracle(oracles[0], C1) + lw_oracle(oracles[1], C0)
                    - lw_oracle(oracles[0], C0)
                    - lw_oracle(oracles[1], C1))
    delta_model = (float(models[0].log_weight(jnp.asarray(C1)))
                   + float(models[1].log_weight(jnp.asarray(C0)))
                   - float(models[0].log_weight(jnp.asarray(C0)))
                   - float(models[1].log_weight(jnp.asarray(C1))))
    np.testing.assert_allclose(delta_model, delta_oracle, atol=1e-8)


# ---- driver ---------------------------------------------------------------

def _beta_models(betas, **kw):
    return [HubbardModel(HubbardConfig(
        L=2, U=4.0, beta=b, m=8, s=2, dtype="float64", **kw))
        for b in betas]


def test_det_pt_equal_grid_always_swaps(tmp_path):
    """On a degenerate grid (all values equal) every swap's Delta is
    exactly 0, so every attempt must accept — a sharp end-to-end check
    of the 4-term weight assembly (any asymmetry or stale cache shows up
    as a rejection)."""
    models = _beta_models([2.0, 2.0, 2.0])
    p = DriverConfig(sweeps=4, thermalization=2, n_walkers=1, seed=2,
                     outdir=str(tmp_path / "eq"), jk_blocks=2)
    qmc = DetQMCPTDet(models, [2.0, 2.0, 2.0], p,
                      DetPTConfig(exchange_interval=1, n_ensembles=2))
    qmc.run()
    assert qmc.n_attempted.sum() > 0
    assert (qmc.n_accepted == qmc.n_attempted).all()


def test_det_pt_beta_grid_end_to_end(tmp_path):
    """A real beta grid (fixed m, dtau varies): runs, swaps at a
    nontrivial rate, writes per-value output + exchange rates, and the
    double occupancy stays physical at every value."""
    betas = [1.6, 2.0, 2.4]
    models = _beta_models(betas)
    p = DriverConfig(sweeps=12, thermalization=6, n_walkers=1, seed=3,
                     outdir=str(tmp_path / "bg"), jk_blocks=3,
                     block_meas=4)
    qmc = DetQMCPTDet(models, betas, p,
                      DetPTConfig(exchange_interval=1, n_ensembles=2))
    results = qmc.run()
    assert qmc.n_attempted.sum() > 0
    for k in range(3):
        docc = results[k]["doubleOccupancy"][0]
        assert 0.0 < docc < 0.5
        assert (tmp_path / "bg" / f"p{k}" / "results.values").exists()
    assert (tmp_path / "bg" / "exchange-rates.dat").exists()
    # adjacent-beta overlap at these sizes is large: some swaps accept
    assert qmc.n_accepted.sum() > 0


def test_det_pt_resume_determinism(tmp_path):
    """Split run (checkpoint + resume) reproduces the straight run's
    accumulated observables exactly (reference walltime/resume
    contract, SURVEY.md §6)."""
    betas = [2.0, 2.4]

    def fresh(outdir):
        return DetQMCPTDet(
            _beta_models(betas), betas,
            DriverConfig(sweeps=6, thermalization=2, n_walkers=1,
                         seed=7, outdir=str(outdir), jk_blocks=2,
                         save_interval=1),
            DetPTConfig(exchange_interval=1))

    a = fresh(tmp_path / "a")
    res_a = a.run()

    b1 = fresh(tmp_path / "b")
    b1.p = b1.p.__class__(**{**b1.p.__dict__, "sweeps": 3})
    b1.run()
    b2 = fresh(tmp_path / "b")
    res_b = b2.run()

    for k in range(2):
        np.testing.assert_allclose(res_b[k]["doubleOccupancy"][0],
                                   res_a[k]["doubleOccupancy"][0],
                                   rtol=1e-12)
    assert (a.n_accepted == b2.n_accepted).all()


def test_det_pt_validates_inputs():
    models = _beta_models([2.0, 2.4])
    from detqmc.exceptions import ConfigurationError

    with pytest.raises(ConfigurationError):
        DetQMCPTDet(models, [2.0], DriverConfig(n_walkers=1))
    with pytest.raises(ConfigurationError):
        DetQMCPTDet(models, [2.0, 2.4], DriverConfig(n_walkers=4))


def test_det_pt_sdw_beta_grid_smoke(tmp_path):
    """SDW beta grid (the reference's named use case): a short run on
    the O(2) model must execute swaps and produce finite phiSquared per
    value."""
    betas = [1.6, 2.0]
    models = [SDWModel(SDWConfig(L=2, opdim=2, r=0.5, beta=b, m=8, s=2,
                                 dtype="float64"))
              for b in betas]
    p = DriverConfig(sweeps=6, thermalization=3, n_walkers=1, seed=9,
                     outdir=str(tmp_path / "sdwb"), jk_blocks=2)
    qmc = DetQMCPTDet(models, betas, p,
                      DetPTConfig(exchange_interval=1))
    results = qmc.run()
    assert qmc.n_attempted.sum() > 0
    for k in range(2):
        assert np.isfinite(results[k]["phiSquared"][0])
