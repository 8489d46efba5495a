"""f32-chain vs fp64-chain statistical agreement.

The accelerator Markov chain runs accept decisions on the wrapped f32 Green
function between stabilizations (~1e-3 drift at beta=8); the 1e-8 oracle
gates all run on fp64. This is the end-to-end check that the f32 physics
is unbiased: the same config run as an f32 ensemble and an fp64 ensemble
must agree on observables within combined stochastic error (VERDICT
round-2 weak #4; reference analogue: the sweepSimple/logSV consistency
philosophy, SURVEY.md §5).
"""

import numpy as np
import pytest

from detqmc.driver import DetQMC, DriverConfig
from detqmc.models.hubbard import HubbardConfig, HubbardModel
from detqmc.models.sdw import SDWConfig, SDWModel


def _assert_within_error(res32, res64, floor=0.01):
    for name in res32:
        m32, e32 = res32[name]
        m64, e64 = res64[name]
        err = float(np.hypot(e32, e64))
        # 5 sigma + a small absolute floor for near-zero error estimates
        tol = 5.0 * err + floor * max(1.0, abs(m64))
        assert abs(m32 - m64) < tol, (
            f"{name}: f32 {m32}+-{e32} vs f64 {m64}+-{e64} "
            f"(|diff|={abs(m32 - m64):.3e} > tol={tol:.3e}) — "
            "f32 chain bias exceeds stochastic error; decrease s or "
            "check the wrap path")


@pytest.mark.slow
def test_f32_chain_unbiased_vs_f64():
    obs_names = ("doubleOccupancy", "kineticEnergy", "spinStructureFactorAF")

    def run(dtype, seed):
        cfg = HubbardConfig(L=4, U=4.0, beta=4.0, m=40, s=4, dtype=dtype)
        p = DriverConfig(sweeps=150, thermalization=40, n_walkers=8,
                         seed=seed, block_meas=50, jk_blocks=10)
        qmc = DetQMC(HubbardModel(cfg), p)
        res = qmc.run()
        return {k: res[k] for k in obs_names if k in res}, qmc

    res32, q32 = run("float32", 3)
    res64, _ = run("float64", 4)
    assert res32, "observable names drifted; update the test"
    _assert_within_error(res32, res64)
    # and the f32 run's own stabilization monitor must stay sane
    dev = float(np.median(np.asarray(q32.states.green_dev)))
    assert dev < 5e-3, f"f32 wrapped-G drift {dev} out of spec"


@pytest.mark.slow
def test_sdw_f32_chain_unbiased_vs_f64():
    """SDW analogue of the Hubbard bias gate: the f32 chain (the device
    arithmetic; the fused kernels are identical-chain-tested against
    this scan path) must agree with the fp64 ensemble on the bosonic
    and fermionic observables within combined stochastic error."""
    obs_names = ("phiSquared", "phiNorm", "occupancy", "kineticEnergy")

    def run(dtype, seed):
        cfg = SDWConfig(L=4, opdim=2, r=1.0, beta=2.0, m=20, s=2,
                        dtype=dtype)
        p = DriverConfig(sweeps=240, thermalization=60, n_walkers=8,
                         seed=seed, block_meas=40, jk_blocks=10)
        qmc = DetQMC(SDWModel(cfg), p)
        res = qmc.run()
        return {k: res[k] for k in obs_names if k in res}, qmc

    res32, q32 = run("float32", 5)
    res64, _ = run("float64", 6)
    assert res32, "observable names drifted; update the test"
    _assert_within_error(res32, res64)
    dev = float(np.median(np.asarray(q32.states.green_dev)))
    assert dev < 5e-3, f"f32 wrapped-G drift {dev} out of spec"


# The headline-shape ensembles below cost ~0.5-1 h each on this 1-CPU
# box, which would dominate the whole suite's budget — they are gated
# behind DETQMC_RUN_HEADLINE_BIAS=1 and run once per round as the
# recorded bias evidence (BASELINE.md "Bias bounds at the headline
# shapes"); the L=4-class tests above stay in every run.
_headline = pytest.mark.skipif(
    not __import__("os").environ.get("DETQMC_RUN_HEADLINE_BIAS"),
    reason="headline-shape ensemble (set DETQMC_RUN_HEADLINE_BIAS=1)")


@pytest.mark.slow
@_headline
def test_hubbard_headline_shape_bias():
    """Hubbard L=8 beta=8 (the bench.py headline shape): the f32 chain's
    acceptance bias must stay inside combined stochastic error — this is
    the measurement the bench gate (6e-3 on wrapped drift) is restated
    from (VERDICT r4 item 5)."""
    obs_names = ("doubleOccupancy", "kineticEnergy",
                 "spinStructureFactorAF")

    def run(dtype, seed):
        cfg = HubbardConfig(L=8, U=4.0, beta=8.0, m=80, s=4, dtype=dtype)
        p = DriverConfig(sweeps=120, thermalization=30, n_walkers=8,
                         seed=seed, block_meas=30, jk_blocks=10)
        qmc = DetQMC(HubbardModel(cfg), p)
        res = qmc.run()
        return {k: res[k] for k in obs_names if k in res}, qmc

    res32, q32 = run("float32", 11)
    res64, _ = run("float64", 12)
    assert res32, "observable names drifted; update the test"
    _assert_within_error(res32, res64)
    dev = float(np.median(np.asarray(q32.states.green_dev)))
    assert dev < 6e-3, f"f32 wrapped-G drift {dev} out of the bench gate"


@pytest.mark.slow
@_headline
def test_sdw_headline_shape_bias():
    """SDW O(3) L=8 beta=4 (the bench.py sdw_l8 shape, s=8): f32 vs fp64
    ensemble agreement at the science-scale lattice."""
    obs_names = ("phiSquared", "phiNorm", "occupancy", "kineticEnergy")

    def run(dtype, seed):
        cfg = SDWConfig(L=8, opdim=3, r=0.5, beta=4.0, m=40, s=8,
                        dtype=dtype, checkerboard=True)
        p = DriverConfig(sweeps=100, thermalization=25, n_walkers=8,
                         seed=seed, block_meas=25, jk_blocks=10)
        qmc = DetQMC(SDWModel(cfg), p)
        res = qmc.run()
        return {k: res[k] for k in obs_names if k in res}, qmc

    res32, q32 = run("float32", 13)
    res64, _ = run("float64", 14)
    assert res32, "observable names drifted; update the test"
    _assert_within_error(res32, res64)
    dev = float(np.median(np.asarray(q32.states.green_dev)))
    assert dev < 1e-4, f"f32 wrapped-G drift {dev} out of the bench gate"
