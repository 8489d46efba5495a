"""Parallel tempering: swap kinematics, sharded==local equivalence on the
virtual 8-device mesh, and an end-to-end physics check (SURVEY.md §5
implication (f): multi-replica PT on a mocked mesh)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.parallel import pt as pt_mod


def test_param_assignment_stays_permutation():
    key = jax.random.key(0)
    pt = pt_mod.init_pt(8, key)
    r_values = jnp.linspace(0.0, 2.0, 8)
    for i in range(50):
        actions = jax.random.normal(jax.random.fold_in(key, i), (8,)) * 5.0
        pt = pt_mod.exchange_step(pt, actions, r_values)
        perm = np.sort(np.asarray(pt.param_of_replica))
        np.testing.assert_array_equal(perm, np.arange(8))
    assert int(pt.n_attempted.sum()) > 0


def test_exchange_acceptance_formula():
    """Two replicas: acceptance statistics must follow
    min(1, exp[(r0 - r1)(a0 - a1)])."""
    r_values = jnp.asarray([0.5, 1.5])
    a = jnp.asarray([2.0, 1.0])   # (r0-r1)(a0-a1) = (-1)(1) = -1
    expected_p = np.exp(-1.0)
    n_acc = 0
    n_try = 400
    pt = pt_mod.init_pt(2, jax.random.key(1))
    for i in range(n_try):
        prev = np.asarray(pt.param_of_replica)
        pt = pt_mod.exchange_step(pt, a, r_values)
        # with R=2, parity alternates; only even parity attempts the pair
        new = np.asarray(pt.param_of_replica)
        if not np.array_equal(prev, new):
            n_acc += 1
            # undo so the same (r, a) situation is re-tested
            pt = pt._replace(param_of_replica=jnp.asarray(prev))
    # pair attempted every other call (parity) -> n_try/2 attempts
    rate = n_acc / (n_try / 2)
    assert rate == pytest.approx(expected_p, abs=0.08)


def test_always_swap_when_favorable():
    """(r_i - r_j)(a_i - a_j) > 0 -> always swap."""
    r_values = jnp.asarray([0.0, 1.0])
    a = jnp.asarray([1.0, 5.0])   # (0-1)(1-5) = 4 > 0
    pt = pt_mod.init_pt(2, jax.random.key(2))
    pt = pt_mod.exchange_step(pt, a, r_values)  # parity 0: attempts
    np.testing.assert_array_equal(np.asarray(pt.param_of_replica), [1, 0])


def test_sharded_exchange_matches_local():
    from jax.sharding import Mesh, PartitionSpec as P
    from jax import shard_map

    n_dev = len(jax.devices())
    assert n_dev == 8, "conftest should provide 8 cpu devices"
    R = 8
    mesh = Mesh(np.array(jax.devices()), ("replica",))
    r_values = jnp.linspace(0.0, 1.0, R)
    actions = jax.random.normal(jax.random.key(3), (R,))
    pt0 = pt_mod.init_pt(R, jax.random.key(4))

    local = pt_mod.exchange_step(pt0, actions, r_values)

    @functools.partial(shard_map, mesh=mesh,
                       in_specs=(P(), P("replica"), P()), out_specs=P(),
                       check_vma=False)
    def sharded(pt, local_actions, r_vals):
        return pt_mod.exchange_step_sharded(pt, local_actions, r_vals,
                                            "replica")

    out = sharded(pt0, actions, r_values)
    np.testing.assert_array_equal(np.asarray(local.param_of_replica),
                                  np.asarray(out.param_of_replica))


@pytest.mark.slow
def test_pt_end_to_end_boson_limit(tmp_path):
    """4 replicas over an r grid in the turnoffFermions limit: each
    parameter's <phi^2> must match an independent single-r run within
    errors, and <phi^2> must decrease with r."""
    from detqmc.driver import DriverConfig
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    r_grid = [0.0, 0.7, 1.4, 2.1]
    cfg = SDWConfig(L=2, opdim=2, r=0.0, u=0.5, beta=2.0, m=8, s=2,
                    turnoffFermions=True, dtype="float64", box_width=1.5)
    model = SDWModel(cfg)
    p = DriverConfig(sweeps=300, thermalization=60, jk_blocks=8,
                     outdir=str(tmp_path / "pt"), n_walkers=1, seed=5,
                     block_meas=50)
    qmc = DetQMCPT(model, r_grid, p, PTConfig(exchange_interval=1))
    results = qmc.run()

    phi2 = [results[k]["phiSquared"][0] for k in range(4)]
    errs = [results[k]["phiSquared"][1] for k in range(4)]
    # monotone decrease with r
    assert phi2[0] > phi2[-1]
    assert (tmp_path / "pt" / "p0" / "results.values").exists()
    assert (tmp_path / "pt" / "exchange-rates.dat").exists()

    # cross-check r = 2.1 against an independent single-parameter run
    cfg1 = SDWConfig(L=2, opdim=2, r=2.1, u=0.5, beta=2.0, m=8, s=2,
                     turnoffFermions=True, dtype="float64", box_width=1.5)
    from detqmc.driver import DetQMC
    single = DetQMC(SDWModel(cfg1),
                    DriverConfig(sweeps=300, thermalization=60,
                                 jk_blocks=8, n_walkers=4, seed=11,
                                 block_meas=50))
    res1 = single.run()
    tol = 5 * np.hypot(errs[-1], res1["phiSquared"][1]) + 0.02
    assert abs(phi2[-1] - res1["phiSquared"][0]) < tol

def test_meas_round_tags_pre_exchange_assignment():
    """Measurements run under the INCOMING parameter assignment; the tag
    emitted with them must be that assignment, not the post-swap one
    (a post-swap tag books every accepted swap's measurements into the
    adjacent parameter's stream)."""
    from detqmc.driver import DriverConfig
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.1, beta=0.5, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    model = SDWModel(cfg)
    p = DriverConfig(sweeps=2, thermalization=0, n_walkers=1, seed=0,
                     block_meas=2)
    qmc = DetQMCPT(model, [0.0, 10.0], p, PTConfig(exchange_interval=1))
    qmc.init()
    # make replica 1's exchange action enormous: the first adjacent-pair
    # swap has log_p = (r0 - r1)(a0 - a1) = (-10)(-huge) > 0 -> accepted
    phi = np.array(qmc.states.phi)  # writable copy
    phi[1] *= 100.0
    states = qmc.states._replace(phi=jnp.asarray(phi))
    states = jax.vmap(model.refresh_from_field)(states)
    carry, (obs, tags) = qmc._meas_block((states, qmc.pt_state), 2)
    _, pt1 = carry
    assert int(np.asarray(pt1.n_accepted).sum()) >= 1  # swap really fired
    tags = np.asarray(tags)
    # round 1 measured under the initial assignment [0, 1]
    np.testing.assert_array_equal(tags[0], np.arange(2))
    # round 2 measured under the post-swap assignment [1, 0]
    np.testing.assert_array_equal(tags[1], np.asarray([1, 0]))


def test_pt_checkpoint_resume_determinism(tmp_path):
    """A PT run interrupted after half its measurements and resumed by a
    fresh DetQMCPT must produce the same final chain state and the same
    per-parameter sample counts as an uninterrupted run (reference: PT
    saves per-rank state + assignment; SURVEY.md §6)."""
    from detqmc.driver import DriverConfig
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    r_values = [0.0, 0.5, 1.0]
    ptp = PTConfig(exchange_interval=1)

    def make(outdir, sweeps):
        p = DriverConfig(sweeps=sweeps, thermalization=4, n_walkers=1,
                         seed=5, block_meas=4, outdir=outdir, jk_blocks=2,
                         timeseries=True)
        return DetQMCPT(SDWModel(cfg), r_values, p, ptp)

    # uninterrupted
    full = make(str(tmp_path / "full"), 8)
    full.run()

    # interrupted: 4 measurements, save, then a FRESH object resumes
    part = make(str(tmp_path / "split"), 4)
    part.run()
    cont = make(str(tmp_path / "split"), 8)
    cont.run()
    assert cont.measurements_done == 8
    np.testing.assert_allclose(np.asarray(cont.states.phi),
                               np.asarray(full.states.phi), atol=1e-10)
    np.testing.assert_array_equal(
        np.asarray(cont.pt_state.param_of_replica),
        np.asarray(full.pt_state.param_of_replica))
    np.testing.assert_array_equal(
        np.asarray(cont.pt_state.n_accepted),
        np.asarray(full.pt_state.n_accepted))
    for k in range(3):
        assert cont.handlers[k].n_samples() == full.handlers[k].n_samples()
        np.testing.assert_allclose(
            cont.handlers[k].scalar_series("phiSquared"),
            full.handlers[k].scalar_series("phiSquared"), atol=1e-10)


def test_pt_walltime_stops_and_saves(tmp_path):
    from detqmc.driver import DriverConfig
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    p = DriverConfig(sweeps=10_000, thermalization=4, n_walkers=1, seed=6,
                     block_meas=2, outdir=str(tmp_path / "wt"),
                     walltime_secs=1e-9)  # expire immediately
    qmc = DetQMCPT(SDWModel(cfg), [0.0, 1.0], p, PTConfig())
    qmc.run()
    assert qmc.measurements_done < 10_000
    assert (tmp_path / "wt" / "state.npz").exists()


def test_pt_control_parameter_validated():
    """PTConfig.control_parameter is checked against the model's declared
    exchange parameter (dead-knob fix: an unsupported name must fail
    loudly, not silently swap r anyway)."""
    import pytest as _pytest

    from detqmc.driver import DriverConfig
    from detqmc.exceptions import ConfigurationError
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=1.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    with _pytest.raises(ConfigurationError):
        DetQMCPT(SDWModel(cfg), [0.0, 1.0], DriverConfig(n_walkers=1),
                 PTConfig(control_parameter="beta"))


def test_pt_phi_dumps_feed_sdwcorr(tmp_path):
    """PT runs dump per-parameter phi .binarystream files routed by the
    current label assignment (reference: DetSDWSystemConfig per-replica
    dumps), and the offline sdwcorr pipeline consumes them."""
    from detqmc.analysis.sdwcorr import phi_correlations
    from detqmc.driver import DriverConfig
    from detqmc.io.binarystream import read_binarystream
    from detqmc.io.series import load_series
    from detqmc.metadata import read_metadata
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    r_grid = [0.2, 1.0]
    cfg = SDWConfig(L=2, opdim=2, r=0.2, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    p = DriverConfig(sweeps=12, thermalization=4, n_walkers=1, seed=6,
                     block_meas=6, outdir=str(tmp_path / "pt"),
                     dump_config_stream=True)
    qmc = DetQMCPT(SDWModel(cfg), r_grid, p, PTConfig())
    qmc.run()
    for k in range(2):
        path = str(tmp_path / "pt" / f"p{k}" / "phi.binarystream")
        phi = read_binarystream(path)
        assert phi.shape == (2, 4, 4, 2)  # (blocks, m, N, opdim)
        out = phi_correlations(phi, cfg.L)
        assert np.isfinite(out["struct_k"]).all()
        assert out["chi_q0"] >= 0.0
    # PT run-level consistency logs + info.dat
    gd, _ = load_series(str(tmp_path / "pt" / "greendev.series"))
    assert gd.shape[0] == 2 and (gd >= 0).all()
    info = read_metadata(str(tmp_path / "pt" / "info.dat"))
    assert "greenDevMedian" in info
    assert info["controlParameter"] == "r"


def test_pt_ensembles_end_to_end(tmp_path):
    """E=2 independent PT systems vmapped into one batch: every parameter
    value books E chains' measurements, assignments stay per-ensemble
    permutations, exchange-rate counters aggregate both systems."""
    from detqmc.driver import DriverConfig
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    r_grid = [0.0, 0.8, 1.6]
    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.5, beta=1.0, m=4, s=2,
                    turnoffFermions=True, dtype="float64", box_width=1.5)
    p = DriverConfig(sweeps=40, thermalization=10, jk_blocks=4,
                     outdir=str(tmp_path / "pt_e"), n_walkers=1, seed=5,
                     block_meas=20, dump_config_stream=True)
    qmc = DetQMCPT(SDWModel(cfg), r_grid, p,
                   PTConfig(exchange_interval=1, n_ensembles=2))
    results = qmc.run()

    # per-ensemble permutations of the parameter grid
    perm = np.sort(np.asarray(qmc.pt_state.param_of_replica), axis=-1)
    assert perm.shape == (2, 3)
    np.testing.assert_array_equal(perm, np.tile(np.arange(3), (2, 1)))
    # every parameter stream holds E * sweeps samples (masks route each
    # ensemble's chain at that parameter into the same handler)
    for k in range(3):
        n = qmc.handlers[k].scalar_series("phiSquared").size
        assert n == 2 * 40, (k, n)
        assert np.isfinite(results[k]["phiSquared"][0])
    # phi dump stream: E configs per dump round
    from detqmc.io.binarystream import read_binarystream

    cfgs = read_binarystream(str(tmp_path / "pt_e" / "p0" /
                                 "phi.binarystream"))
    assert cfgs.shape[0] == 2 * 2  # two measurement blocks x two ensembles
    # aggregated exchange-rate file exists and counts both systems
    rates = (tmp_path / "pt_e" / "exchange-rates.dat").read_text()
    att_total = sum(int(line.split()[1])
                    for line in rates.splitlines()[1:])
    assert att_total == 2 * 40 + 2 * 10  # E * (meas + therm) attempts


def test_pt_ensembles_resume_guard(tmp_path):
    """Resuming an E=2 checkpoint with a different ensemble count must
    fail loudly, not garble shapes."""
    from detqmc.driver import DriverConfig
    from detqmc.exceptions import ConfigurationError
    from detqmc.models.sdw import SDWConfig, SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    cfg = SDWConfig(L=2, opdim=1, r=0.0, u=0.5, beta=0.5, m=4, s=2,
                    turnoffFermions=True, dtype="float64")
    p = DriverConfig(sweeps=4, thermalization=0, n_walkers=1, seed=0,
                     outdir=str(tmp_path / "ptr"), block_meas=4)
    qmc = DetQMCPT(SDWModel(cfg), [0.0, 1.0], p,
                   PTConfig(n_ensembles=2))
    qmc.run()
    qmc2 = DetQMCPT(SDWModel(cfg), [0.0, 1.0], p,
                    PTConfig(n_ensembles=1))
    with pytest.raises(ConfigurationError):
        qmc2.init(resume=True)


def test_pt_ensembles_sharded_2d_mesh_matches_local():
    """The ensemble axis shards over a 'dp' mesh axis while replicas
    shard over 'replica' (2-D mesh): one exchange round on the 2x4
    virtual mesh must reproduce the single-device vmapped result
    exactly (same keys, same swap decisions, layout only)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from jax import shard_map

    E, R = 4, 8
    devs = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devs, ("dp", "replica"))
    r_values = jnp.linspace(0.0, 1.0, R)
    actions = jax.random.normal(jax.random.key(3), (E, R))
    pt0 = jax.vmap(functools.partial(pt_mod.init_pt, R))(
        jax.random.split(jax.random.key(4), E))

    local = jax.vmap(
        lambda p_, a: pt_mod.exchange_step(p_, a, r_values))(pt0, actions)

    # PTState is per-ensemble (sharded over dp, replicated over replica);
    # actions shard over both axes and all_gather over 'replica' only
    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P("dp"), P("dp", "replica"), P()),
        out_specs=P("dp"), check_vma=False)
    def sharded(pt, local_actions, r_vals):
        return jax.vmap(lambda p_, a: pt_mod.exchange_step_sharded(
            p_, a, r_vals, "replica"))(pt, local_actions)

    out = jax.jit(sharded)(pt0, actions, r_values)
    np.testing.assert_array_equal(np.asarray(local.param_of_replica),
                                  np.asarray(out.param_of_replica))
    np.testing.assert_array_equal(np.asarray(local.n_accepted),
                                  np.asarray(out.n_accepted))


def test_hubbard_stagger_bias_polarizes():
    """The staggered HS-bias h (the Hubbard PT control parameter) must
    polarize the auxiliary field toward the AF pattern: <sum eta s>
    clearly positive at large h, near zero at h = 0. Validates the
    u01-prescale implementation of the bias in HubbardModel._sweep."""
    from detqmc.models.hubbard import HubbardConfig, HubbardModel

    def mean_stagger(h):
        cfg = HubbardConfig(L=2, U=2.0, beta=2.0, m=8, s=4,
                            dtype="float64", stagger_h=h)
        model = HubbardModel(cfg)
        st = jax.jit(model.init_state)(jax.random.key(3))
        step = jax.jit(lambda s: model.sweep_pair(s, measure=False)[0])
        for _ in range(10):
            st = step(st)
        acc = 0.0
        for _ in range(20):
            st = step(st)
            acc += float(-model.exchange_action(st))  # = sum eta s
        mN = cfg.m * cfg.n_sites
        return acc / 20 / mN

    assert abs(mean_stagger(0.0)) < 0.35          # unbiased: ~0 +- noise
    assert mean_stagger(1.0) > 0.6                # strongly polarized


def test_pt_hubbard_h_grid_end_to_end(tmp_path):
    """Parallel tempering over the Hubbard staggered HS-bias grid — the
    second worked PT control parameter next to SDW's r. Checks driver
    wiring (per-parameter streams, exchange accounting) and physics:
    the replica holding the largest h must be more AF-polarized than
    the h = 0 one."""
    from detqmc.driver import DriverConfig
    from detqmc.exceptions import ConfigurationError
    from detqmc.models.hubbard import HubbardConfig, HubbardModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    h_grid = [0.0, 0.25, 0.6, 1.2]
    cfg = HubbardConfig(L=2, U=2.0, beta=2.0, m=8, s=4, dtype="float64")
    model = HubbardModel(cfg)
    p = DriverConfig(sweeps=60, thermalization=20, jk_blocks=4,
                     outdir=str(tmp_path / "pth"), n_walkers=1, seed=9,
                     block_meas=20)

    # the default PTConfig control parameter ("r") must be rejected
    with pytest.raises(ConfigurationError):
        DetQMCPT(model, h_grid, p, PTConfig())

    qmc = DetQMCPT(model, h_grid, p,
                   PTConfig(exchange_interval=1,
                            control_parameter="stagger_h"))
    results = qmc.run()
    for k in range(4):
        assert "occupancy" in results[k]
        assert (tmp_path / "pth" / f"p{k}" / "results.values").exists()
    assert (tmp_path / "pth" / "exchange-rates.dat").exists()
    assert int(np.asarray(qmc.pt_state.n_attempted).sum()) > 0

    # physics: AF polarization of the HS field grows along the h ladder
    assign = np.asarray(qmc.pt_state.param_of_replica)
    a = np.asarray(jax.vmap(model.exchange_action)(qmc.states))
    stag = {int(assign[k]): float(-a[k]) for k in range(4)}
    mN = cfg.m * cfg.n_sites
    assert stag[3] / mN > stag[0] / mN + 0.3
