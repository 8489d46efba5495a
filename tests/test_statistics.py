import numpy as np
import pytest

from detqmc.statistics import (
    binning_error,
    jackknife,
    jackknife_multi,
    rebin,
    tau_int,
)


def test_rebin():
    s = np.arange(10.0)
    b = rebin(s, 5)
    np.testing.assert_allclose(b, [0.5, 2.5, 4.5, 6.5, 8.5])
    # tail dropped
    b = rebin(np.arange(11.0), 5)
    assert len(b) == 5


def test_jackknife_mean_iid():
    rng = np.random.default_rng(0)
    x = rng.normal(3.0, 2.0, size=20000)
    est, err = jackknife(x, 20)
    assert est == pytest.approx(3.0, abs=0.1)
    # error of the mean ~ sigma/sqrt(T)
    assert err == pytest.approx(2.0 / np.sqrt(20000), rel=0.4)


def test_jackknife_nonlinear_bias_correction():
    """Jackknife handles nonlinear estimators: est = mean^2."""
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 1.0, size=40000)
    est, err = jackknife(x, 20, estimator=lambda b: float(np.mean(b)) ** 2)
    assert est == pytest.approx(4.0, abs=0.15)
    assert 0 < err < 0.2


def test_jackknife_multi_binder_like():
    rng = np.random.default_rng(2)
    phi2 = rng.normal(1.0, 0.1, size=10000)
    phi4 = 3 * phi2 ** 2 * (1 + rng.normal(0, 0.01, size=10000))
    u, err = jackknife_multi([phi4, phi2],
                             20, lambda a, b: 1.0 - a / (3.0 * b ** 2))
    assert abs(u) < 0.1


def test_tau_int_iid_and_correlated():
    rng = np.random.default_rng(3)
    iid = rng.normal(size=50000)
    assert tau_int(iid) == pytest.approx(0.5, abs=0.15)
    # AR(1) with rho=0.9: tau_int = (1+rho)/(2(1-rho)) = 9.5
    rho = 0.9
    x = np.zeros(200000)
    eps = rng.normal(size=200000)
    for i in range(1, len(x)):
        x[i] = rho * x[i - 1] + eps[i]
    assert tau_int(x) == pytest.approx(9.5, rel=0.2)


def test_binning_error_grows_with_correlation():
    rng = np.random.default_rng(4)
    x = np.zeros(20000)
    eps = rng.normal(size=20000)
    for i in range(1, len(x)):
        x[i] = 0.8 * x[i - 1] + eps[i]
    naive = np.std(x, ddof=1) / np.sqrt(len(x))
    assert binning_error(x) > 2 * naive
