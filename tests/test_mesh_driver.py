"""Driver with the walker axis sharded over the (virtual) device mesh:
results must match the single-device run exactly (embarrassingly parallel;
sharding changes layout, not math)."""

import jax
import numpy as np
import pytest

from detqmc.driver import DetQMC, DriverConfig
from detqmc.models.hubbard import HubbardConfig, HubbardModel


def test_sharded_driver_matches_single_device():
    assert len(jax.devices()) == 8
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64")
    base = dict(sweeps=20, thermalization=5, n_walkers=8, seed=3,
                block_meas=10)
    res1 = DetQMC(HubbardModel(cfg), DriverConfig(**base)).run()
    qmc = DetQMC(HubbardModel(cfg), DriverConfig(**base, mesh_devices=8))
    res8 = qmc.run()
    # states are actually distributed
    shard_devs = {d for s in qmc.states.G.addressable_shards
                  for d in [s.device]}
    assert len(shard_devs) == 8
    for name in res1:
        np.testing.assert_allclose(res1[name][0], res8[name][0],
                                   rtol=1e-10, err_msg=name)


def test_sharded_driver_validates_divisibility():
    cfg = HubbardConfig(L=2, beta=1.0, m=8, s=4, dtype="float64")
    qmc = DetQMC(HubbardModel(cfg),
                 DriverConfig(sweeps=4, thermalization=2, n_walkers=3,
                              mesh_devices=2, block_meas=2))
    with pytest.raises(ValueError):
        qmc.init()

def test_sharded_pt_driver_matches_single_device():
    """DetQMCPT with mesh_devices: the replica axis shards over the
    mesh (GSPMD, same pattern as the walker sharding) and results match
    the single-device run exactly."""
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    r_grid = list(np.linspace(0.0, 1.4, 8))
    base = dict(sweeps=16, thermalization=4, n_walkers=1, seed=5,
                block_meas=8, jk_blocks=2)

    res1 = DetQMCPT(SDWModel(cfg), r_grid,
                    DriverConfig(**base), PTConfig()).run()
    qmc = DetQMCPT(SDWModel(cfg), r_grid,
                   DriverConfig(**base, mesh_devices=8), PTConfig())
    res8 = qmc.run()
    shard_devs = {d for s in qmc.states.phi.addressable_shards
                  for d in [s.device]}
    assert len(shard_devs) == 8
    for k in res1:
        for name in res1[k]:
            np.testing.assert_allclose(
                res1[k][name][0], res8[k][name][0], rtol=1e-10,
                err_msg=f"p{k}/{name}")


def test_sharded_pt_driver_ensemble_axis():
    """With ensembles the ENSEMBLE axis shards (whole PT systems per
    device; swaps never cross devices) — results match unsharded."""
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    base = dict(sweeps=8, thermalization=2, n_walkers=1, seed=6,
                block_meas=4, jk_blocks=2)
    ptp = PTConfig(n_ensembles=4)
    res1 = DetQMCPT(SDWModel(cfg), [0.0, 0.7, 1.4],
                    DriverConfig(**base), ptp).run()
    qmc = DetQMCPT(SDWModel(cfg), [0.0, 0.7, 1.4],
                   DriverConfig(**base, mesh_devices=4), ptp)
    res4 = qmc.run()
    shard_devs = {d for s in qmc.states.phi.addressable_shards
                  for d in [s.device]}
    assert len(shard_devs) == 4
    for k in res1:
        np.testing.assert_allclose(res1[k]["phiSquared"][0],
                                   res4[k]["phiSquared"][0], rtol=1e-10)
