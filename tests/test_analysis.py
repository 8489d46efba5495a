"""Analysis toolchain: deteval, tauint CLI, jointimeseries, binarystream,
sdwcorr, and the Ferrenberg-Swendsen reweighting against exact toys."""

import numpy as np
import pytest

from detqmc.analysis.deteval import evaluate_run, main as deteval_main
from detqmc.analysis.jointimeseries import join
from detqmc.analysis.mrpt import (
    MultireweightPT,
    find_binder_intersection,
    jackknife_reweighted,
)
from detqmc.analysis.sdwcorr import phi_correlations
from detqmc.io.binarystream import (
    BinaryStreamWriter,
    extract_doubles,
    read_binarystream,
)
from detqmc.io.series import SeriesWriter, load_results, load_series
from detqmc.metadata import write_metadata


def test_deteval_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    rundir = str(tmp_path)
    w = SeriesWriter(f"{rundir}/energy.series", "energy")
    w.append(rng.normal(-1.5, 0.1, 2000))
    write_metadata(f"{rundir}/info.dat", {"L": "4"})
    res = evaluate_run(rundir, discard=100, jk_blocks=10)
    mean, err, tau = res["energy"]
    assert mean == pytest.approx(-1.5, abs=0.02)
    assert 0 < err < 0.02
    assert deteval_main([rundir]) == 0
    out = load_results(f"{rundir}/eval-results.values")
    assert "energy" in out


def test_jointimeseries(tmp_path):
    a = str(tmp_path / "a.series")
    b = str(tmp_path / "b.series")
    SeriesWriter(a, "x", meta={"L": "4"}).append(np.arange(3.0))
    SeriesWriter(b, "x").append(np.arange(3.0, 5.0))
    out = str(tmp_path / "joined.series")
    n = join(out, [a, b])
    assert n == 5
    arr, meta = load_series(out)
    np.testing.assert_allclose(arr, [0, 1, 2, 3, 4])
    assert meta["L"] == "4"


def test_binarystream_roundtrip(tmp_path):
    p = str(tmp_path / "phi.binarystream")
    w = BinaryStreamWriter(p, (2, 4, 3))
    data = np.arange(48.0).reshape(2, 2, 4, 3)
    w.append(data[0])
    w.append(data[1])
    back = read_binarystream(p)
    np.testing.assert_allclose(back, data)
    raw = extract_doubles(p, start=1, count=3)
    np.testing.assert_allclose(raw, [1.0, 2.0, 3.0])


def test_sdwcorr_uniform_field():
    """A constant field has all weight at q=0."""
    L, m, op = 4, 3, 2
    phi = np.ones((5, m, L * L, op))
    out = phi_correlations(phi, L)
    assert out["struct_k"][0, 0] == pytest.approx(L * L * op)
    assert abs(out["struct_k"][1, 0]) < 1e-10
    np.testing.assert_allclose(out["corr_r"], op, atol=1e-10)


def _exact_exp_mean(r, A):
    """<a> for p(a) ~ exp(-r a) on [0, A]."""
    if abs(r) < 1e-12:
        return A / 2
    return 1.0 / r - A / (np.exp(r * A) - 1.0)


def _sample_exp(rng, r, A, n):
    """Inverse-CDF samples from p(a) ~ exp(-r a) on [0, A]."""
    u = rng.random(n)
    if abs(r) < 1e-12:
        return u * A
    return -np.log(1.0 - u * (1.0 - np.exp(-r * A))) / r


def test_mrpt_reweighting_exact_toy():
    """FS reweighting across three r values reproduces the analytic
    <a>(r) at interpolated targets."""
    rng = np.random.default_rng(1)
    A = 3.0
    r_values = [0.5, 1.0, 2.0]
    actions = [_sample_exp(rng, r, A, 40000) for r in r_values]
    obs = {"a": [a.copy() for a in actions],
           "a2": [a ** 2 for a in actions]}
    m = MultireweightPT(np.asarray(r_values), actions, obs)
    m.solve()
    for r_t in (0.7, 1.5, 1.0):
        got = m.expectation("a", r_t)
        assert got == pytest.approx(_exact_exp_mean(r_t, A), abs=0.02), r_t
    # free energies match analytic log Z ratios: Z(r) = (1-e^{-rA})/r
    logZ = np.log((1 - np.exp(-np.asarray(r_values) * A))
                  / np.asarray(r_values))
    expected_f = -(logZ - logZ[0])
    np.testing.assert_allclose(m.f, expected_f, atol=0.02)


def test_mrpt_native_core_matches_numpy():
    """The OpenMP C++ FS core (native/mrpt, loaded via ctypes) must agree
    with the pure-NumPy fallback on free energies, log weights and curves
    (skipped when no compiler/prebuilt library exists)."""
    from detqmc.analysis import _native

    if _native.get_lib() is None:
        pytest.skip("native mrpt core unavailable (no g++?)")
    rng = np.random.default_rng(7)
    A = 3.0
    r_values = [0.5, 1.0, 2.0]
    actions = [_sample_exp(rng, r, A, 5000) for r in r_values]
    obs = {"a": [a.copy() for a in actions]}
    m_nat = MultireweightPT(np.asarray(r_values),
                            [a.copy() for a in actions],
                            {k: [s.copy() for s in v]
                             for k, v in obs.items()})
    m_np = MultireweightPT(np.asarray(r_values),
                           [a.copy() for a in actions],
                           {k: [s.copy() for s in v]
                            for k, v in obs.items()}, use_native="never")
    m_nat.solve()
    m_np.solve()
    np.testing.assert_allclose(m_nat.f, m_np.f, atol=1e-8)
    grid = np.linspace(0.6, 1.8, 7)
    np.testing.assert_allclose(m_nat.curve("a", grid),
                               m_np.curve("a", grid), rtol=1e-10)
    np.testing.assert_allclose(m_nat._log_weights(1.3),
                               m_np._log_weights(1.3), atol=1e-9)


def test_mrpt_jackknife_and_binder():
    rng = np.random.default_rng(2)
    A = 3.0
    r_values = [0.5, 1.5]
    actions = [_sample_exp(rng, r, A, 20000) for r in r_values]
    obs = {"phiSquared": [a.copy() for a in actions],
           "phiFourth": [a ** 2 * 2.5 for a in actions]}
    est, err = jackknife_reweighted(
        r_values, actions, obs,
        lambda m: m.expectation("phiSquared", 1.0), n_blocks=8)
    assert est == pytest.approx(_exact_exp_mean(1.0, A), abs=0.03)
    assert 0 < err < 0.05

    # Binder intersection of two synthetic "sizes" with known crossing
    m1 = MultireweightPT(np.asarray(r_values),
                         [a.copy() for a in actions],
                         {"phiSquared": [a.copy() for a in actions],
                          "phiFourth": [a ** 2 * 2.0 for a in actions]})
    m2 = MultireweightPT(np.asarray(r_values),
                         [a.copy() for a in actions],
                         {"phiSquared": [a.copy() for a in actions],
                          "phiFourth": [a ** 2 * 2.6 for a in actions]})
    m1.solve()
    m2.solve()
    # U1 - U2 = (2.6 - 2.0)/3 * <a^2>/<a>^2 > 0 everywhere -> no crossing
    assert find_binder_intersection(m1, m2, 0.6, 1.4) is None

def test_mrpt_observable_maximum():
    """Golden-section maximum finder agrees with a dense scan of the
    same reweighted curve (reference: susceptibility-maximum finders)."""
    from detqmc.analysis.mrpt import find_observable_maximum

    rng = np.random.default_rng(3)
    A = 3.0
    r_values = [0.5, 1.0, 2.0]
    actions = [_sample_exp(rng, r, A, 20000) for r in r_values]
    obs = {"chi": [a * (A - a) for a in actions]}
    m = MultireweightPT(np.asarray(r_values),
                        [a.copy() for a in actions], obs)
    m.solve()
    r_star, val = find_observable_maximum(m, "chi", 0.55, 1.95, tol=1e-9)
    grid = np.linspace(0.55, 1.95, 2001)
    curve = m.curve("chi", grid)
    i = int(np.argmax(curve))
    assert abs(r_star - grid[i]) < 2 * (grid[1] - grid[0])
    assert val >= curve[i] - 1e-6


def test_mrpt_jackknife_intersection():
    """jackknife_intersection finds a constructed Binder crossing and
    returns a positive, small error (the whole FS solve repeats per
    leave-one-out block, both runs)."""
    from detqmc.analysis.mrpt import jackknife_intersection

    rng = np.random.default_rng(4)
    A = 3.0
    r_values = [0.5, 1.0, 2.0]
    a1 = [_sample_exp(rng, r, A, 12000) for r in r_values]
    a2 = [_sample_exp(rng, r, A, 12000) for r in r_values]
    # pick k so U1 - U2 = [2 <a^2> - k <a^3>] / (3 <a>^2) crosses zero
    # near r = 1.2: probe the moments there from a throwaway solve
    probe = MultireweightPT(
        np.asarray(r_values), [a.copy() for a in a1],
        {"m2": [a ** 2 for a in a1], "m3": [a ** 3 for a in a1]})
    probe.solve()
    k = 2.0 * probe.expectation("m2", 1.2) / probe.expectation("m3", 1.2)
    run1 = (r_values, a1, {"phiSquared": [a.copy() for a in a1],
                           "phiFourth": [2.0 * a ** 2 for a in a1]})
    run2 = (r_values, a2, {"phiSquared": [a.copy() for a in a2],
                           "phiFourth": [k * a ** 3 for a in a2]})
    est, err = jackknife_intersection(run1, run2, 0.55, 1.95,
                                      n_blocks=6)
    assert 0.55 < est < 1.95
    assert abs(est - 1.2) < 0.25       # crossing engineered near 1.2
    assert 0.0 < err < 0.2


def test_mrpt_cli_maxsusc_and_intersect(tmp_path, capsys):
    """CLI wiring: --maxsusc and --intersect on synthetic PT run dirs."""
    from detqmc.cli.main_mrpt import main as mrpt_main
    from detqmc.io.series import SeriesWriter
    from detqmc.metadata import write_metadata

    rng = np.random.default_rng(5)
    A = 3.0
    r_values = [0.5, 1.0, 2.0]

    def write_run(root, fourth):
        for kdx, r in enumerate(r_values):
            a = _sample_exp(rng, r, A, 6000)
            sub = root / f"p{kdx}"
            sub.mkdir(parents=True)
            write_metadata(str(sub / "info.dat"),
                           {"r": str(r), "L": "2", "m": "4",
                            "beta": "1.0"})
            for name, series in (
                    ("exchangeAction", a),
                    ("phiSquared", a),
                    ("phiFourth", fourth(a)),
                    ("sdwSusceptibility", a * (A - a))):
                w = SeriesWriter(str(sub / f"{name}.series"), name)
                w.append(series)

    # engineer a crossing near r = 1.2 (cf. test_mrpt_jackknife_
    # intersection): U1 - U2 = [2<a^2> - k<a^3>] / (3<a>^2)
    probe_a = [_sample_exp(np.random.default_rng(6), r, A, 6000)
               for r in r_values]
    probe = MultireweightPT(
        np.asarray(r_values), [a.copy() for a in probe_a],
        {"m2": [a ** 2 for a in probe_a],
         "m3": [a ** 3 for a in probe_a]})
    probe.solve()
    k = 2.0 * probe.expectation("m2", 1.2) / probe.expectation("m3", 1.2)
    write_run(tmp_path / "run1", lambda a: 2.0 * a ** 2)
    write_run(tmp_path / "run2", lambda a: k * a ** 3)
    rc = mrpt_main([str(tmp_path / "run1"), "--grid", "0.55,1.95,21",
                    "--maxsusc", "sdwSusceptibility",
                    "--intersect", str(tmp_path / "run2"),
                    "--jackknife", "4"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "max sdwSusceptibility" in out
    assert "binderIntersection" in out and "+/-" in out
