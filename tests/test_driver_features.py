"""Driver features: time-displaced measurement stream, adaptive proposal
tuning, phi config dumps."""

import numpy as np
import pytest

from detqmc.driver import DetQMC, DriverConfig
from detqmc.io.binarystream import read_binarystream
from detqmc.models.hubbard import HubbardConfig, HubbardModel
from detqmc.models.sdw import SDWConfig, SDWModel


def test_timedisplaced_measurement(tmp_path):
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64")
    p = DriverConfig(sweeps=20, thermalization=5, n_walkers=2, seed=1,
                     block_meas=10, timedisplaced=True,
                     outdir=str(tmp_path / "run"), timeseries=True)
    qmc = DetQMC(HubbardModel(cfg), p)
    qmc.run()
    vres = qmc.handler.vector_results()
    assert "greenKTauVector" in vres
    mean, err = vres["greenKTauVector"]
    assert mean.shape == ((cfg.n_stack + 1) * cfg.n_sites,)
    # tau=0 diagonal: filling 0.5 per spin at half filling -> G(k,0) sums
    gk0 = mean[:cfg.n_sites]
    assert gk0.mean() == pytest.approx(0.5, abs=0.1)


def test_adaptive_tuning_and_phi_dump(tmp_path):
    cfg = SDWConfig(L=2, opdim=2, r=1.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64",
                    box_width=20.0)  # absurd width -> low acceptance
    p = DriverConfig(sweeps=20, thermalization=40, n_walkers=2, seed=2,
                     block_meas=10, outdir=str(tmp_path / "run"),
                     dump_config_stream=True, target_acc_ratio=0.5)
    qmc = DetQMC(SDWModel(cfg), p)
    qmc.run()
    w = np.asarray(qmc.states.box_width)
    assert (w < 20.0).all()  # tuned down toward the target acceptance
    phi = read_binarystream(str(tmp_path / "run" / "phi.binarystream"))
    assert phi.shape[1:] == (4, 4, 2)  # (m, N, opdim), stacked walkers
    assert np.isfinite(phi).all()

def test_global_update_interval_honored():
    """globalUpdateInterval gates global moves on the sweep counter
    (reference: attempted every globalUpdateInterval sweeps). A never-
    firing interval must leave the trajectory identical to a run without
    global moves (global moves consume RNG even when rejected)."""
    base = dict(L=2, opdim=1, r=1.0, u=0.5, beta=1.0, m=4, s=2,
                turnoffFermions=True, dtype="float64")
    p = DriverConfig(sweeps=8, thermalization=4, n_walkers=1, seed=3,
                     block_meas=4, tune_proposals=False)

    off = DetQMC(SDWModel(SDWConfig(**base, globalShift=False)), p)
    off.run()
    never = DetQMC(SDWModel(SDWConfig(**base, globalShift=True,
                                      globalUpdateInterval=10_000)), p)
    never.run()
    np.testing.assert_array_equal(np.asarray(off.states.phi),
                                  np.asarray(never.states.phi))

    every = DetQMC(SDWModel(SDWConfig(**base, globalShift=True,
                                      globalUpdateInterval=1)), p)
    every.run()
    assert not np.array_equal(np.asarray(off.states.phi),
                              np.asarray(every.states.phi))


def test_consistency_logs_written(tmp_path):
    """The green_dev / SV monitors must reach run output (reference:
    DetModelLoggingParams' logSV + wrapped-vs-stabilized deviation files,
    SURVEY.md §5 item 1) and echo into info.dat."""
    from detqmc.io.series import load_series
    from detqmc.metadata import read_metadata

    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=8, s=4, dtype="float64")
    p = DriverConfig(sweeps=10, thermalization=2, n_walkers=2, seed=4,
                     block_meas=5, outdir=str(tmp_path / "run"))
    qmc = DetQMC(HubbardModel(cfg), p)
    qmc.run()
    gd, _ = load_series(str(tmp_path / "run" / "greendev.series"))
    sv, _ = load_series(str(tmp_path / "run" / "sv.series"))
    assert gd.shape == (2, 2) and sv.shape == (2, 2)  # (blocks, [med max])
    assert (gd >= 0).all() and np.isfinite(sv).all()
    assert (gd[:, 1] >= gd[:, 0]).all()       # max >= median
    assert (sv[:, 1] >= sv[:, 0]).all()       # log10 sv_max >= sv_min
    info = read_metadata(str(tmp_path / "run" / "info.dat"))
    assert "greenDevMedian" in info and "svLog10Max" in info
    assert float(info["greenDevMedian"]) >= 0.0


def test_tail_block_sized_to_remaining():
    """sweeps not a multiple of block_meas*measure_interval must produce
    exactly n_measurements samples with a right-sized final device block
    (no compute-and-discard overshoot)."""
    cfg = HubbardConfig(L=2, U=4.0, beta=1.0, m=8, s=4, dtype="float64")
    p = DriverConfig(sweeps=7, thermalization=2, n_walkers=1, seed=5,
                     block_meas=5)
    qmc = DetQMC(HubbardModel(cfg), p)
    qmc.run()
    assert qmc.handler.n_samples() == 7
    assert qmc.measurements_done == 7


def test_timedisplaced_per_slice_driver(tmp_path):
    """timedisplaced_slices resolves all m+1 tau points and records the
    wrap-deviation monitor as a scalar observable."""
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64")
    p = DriverConfig(sweeps=4, thermalization=2, n_walkers=2, seed=7,
                     block_meas=4, timedisplaced=True,
                     timedisplaced_slices=True)
    qmc = DetQMC(HubbardModel(cfg), p)
    qmc.run()
    vres = qmc.handler.vector_results()
    mean, _ = vres["greenKTauVector"]
    assert mean.shape == ((cfg.m + 1) * cfg.n_sites,)
    res = qmc.results() if hasattr(qmc, "results") else qmc.handler.results()
    td = qmc.handler.results()["timeDisplacedDev"]
    assert 0.0 <= td[0] < 1e-8   # fp64 wrap drift is tiny
    # per-slice G also yields the tau-integrated pairing
    # susceptibilities (Wick at fixed field; oracle-tested in
    # test_time_displaced.py) — the driver books them as scalars
    res = qmc.handler.results()
    assert np.isfinite(res["pairingSusceptibilityS"][0])
    assert np.isfinite(res["pairingSusceptibilityD"][0])
    assert res["pairingSusceptibilityS"][0] > 0.0  # on-site pair bubble


def test_auto_stabilize_steps_s_down():
    """auto_stabilize: an absurdly long stabilization interval (s = m)
    trips the green_dev threshold during thermalization, the driver
    steps s down to the next divisor of m and rebuilds its programs,
    and the run completes with the drift reduced (reference: the
    "decrease s when the consistency check trips" guidance behind
    DetModelLoggingParams, SURVEY.md §5 item 1)."""
    model = HubbardModel(HubbardConfig(L=2, U=4.0, beta=4.0, m=40, s=40,
                                       dtype="float32"))
    qmc = DetQMC(model, DriverConfig(
        sweeps=4, thermalization=8, n_walkers=2, block_meas=4,
        auto_stabilize=True, green_dev_threshold=1e-6, seed=1))
    qmc.run()
    assert qmc.model.cfg.s < 40
    assert qmc.model.cfg.m % qmc.model.cfg.s == 0
    assert qmc.meta.get("autoStabilized") == "true"
    assert qmc.handler.n_samples() == 4
    # the rebuilt chain keeps the walkers' fields: states are valid and
    # the post-rebuild drift reflects the smaller interval
    dev = float(np.median(np.asarray(qmc.states.green_dev)))
    assert np.isfinite(dev)


def test_current_correlators_driver():
    """currentCorrelators books Lambda_xx(q), rhoS and the wrap-dev
    monitor into run output (formula oracle-tested in
    test_time_displaced.py)."""
    cfg = HubbardConfig(L=4, U=4.0, beta=2.0, m=16, s=4, dtype="float64")
    p = DriverConfig(sweeps=4, thermalization=2, n_walkers=2, seed=7,
                     block_meas=4, current_correlators=True)
    qmc = DetQMC(HubbardModel(cfg), p)
    qmc.run()
    res = qmc.handler.results()
    assert np.isfinite(res["rhoS"][0])
    assert 0.0 <= res["currentWrapDev"][0] < 1e-8
    lam, _ = qmc.handler.vector_results()["currentCorrelatorVector"]
    assert lam.shape == (cfg.n_sites,)
    assert np.isfinite(lam).all()


def test_sdw_timedisplaced_susceptibilities_driver():
    """The generic driver hook books SDW pairing susceptibilities too
    (SDW measure_time_displaced supports the susceptibilities kwarg)."""
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=1.0, m=8, s=2,
                    dtype="float64")
    p = DriverConfig(sweeps=2, thermalization=1, n_walkers=1, seed=3,
                     block_meas=2, timedisplaced=True,
                     timedisplaced_slices=True)
    qmc = DetQMC(SDWModel(cfg), p)
    qmc.run()
    res = qmc.handler.results()
    assert np.isfinite(res["pairingSusceptibilityS"][0])
    assert np.isfinite(res["pairingSusceptibilityD"][0])
    assert 0.0 <= res["timeDisplacedDev"][0] < 1e-8


def test_profile_trace_captured(tmp_path):
    """profileDir captures a jax.profiler trace of the first measurement
    block (the op-level complement of the timing report, SURVEY.md §6)."""
    import os

    cfg = HubbardConfig(L=2, U=4.0, beta=1.0, m=8, s=4, dtype="float64")
    prof = tmp_path / "trace"
    p = DriverConfig(sweeps=4, thermalization=1, n_walkers=1, seed=5,
                     block_meas=2, profile_dir=str(prof))
    qmc = DetQMC(HubbardModel(cfg), p)
    qmc.run()
    # the profiler writes plugins/profile/<ts>/*.trace.json.gz (exact
    # layout is a jax implementation detail; just require content)
    found = [os.path.join(r, f) for r, _, fs in os.walk(prof) for f in fs]
    assert found, "profiler trace directory is empty"
