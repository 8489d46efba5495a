"""The XLA stabilization path at the shapes and conditionings the models
run: UdV factorization, the V-chain composition, the stabilized Green
functions of both models against the NumPy f64 oracles over graded
chains (beta up to 12), and the log-determinant.

Precision routes covered: float64 and complex128 end to end, and the
float32 / complex64 chains with their f64 / complex128 stabilization
island (the models' defaults).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.linalg.udv import (
    UDV,
    log_det_one_plus_udv,
    udv_decompose,
    udv_refactor,
)
from detqmc.models.hubbard import HubbardConfig, HubbardModel
from detqmc.models.sdw import SDWConfig, SDWModel
from tests.oracle.hubbard_oracle import HubbardOracle
from tests.oracle.sdw_oracle import SDWOracle

_EPS = {"float32": 2e-6, "complex64": 2e-6,
        "float64": 1e-13, "complex128": 1e-13}


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if np.dtype(dtype).kind == "c":
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


@pytest.mark.parametrize("n", [8, 24, 64, 136])
@pytest.mark.parametrize("dtype",
                         ["float32", "float64", "complex64", "complex128"])
def test_udv_decompose_factors(dtype, n):
    """U unitary, d > 0, V unit-diagonal upper triangular, U d V = A."""
    A = _rand(np.random.default_rng(n), (2, n, n), dtype)
    f = udv_decompose(jnp.asarray(A))
    U, d, V = (np.asarray(x, np.complex128) for x in f)
    tol = 50 * n * _EPS[dtype]
    eye = np.eye(n)
    for b in range(2):
        np.testing.assert_allclose(U[b].conj().T @ U[b], eye, atol=tol)
        assert np.all(d[b].real > 0)
        np.testing.assert_allclose(np.diag(V[b]), 1.0, atol=tol)
        assert np.abs(np.tril(V[b], -1)).max() == 0.0
        np.testing.assert_allclose(
            (U[b] * d[b][None, :]) @ V[b], A[b],
            atol=tol * np.abs(A[b]).max())


@pytest.mark.parametrize("length", [2, 6])
@pytest.mark.parametrize("n", [8, 32])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_udv_refactor_chain_matches_numpy(dtype, n, length):
    """The V-chain composition of udv_refactor: a chain of `length`
    blocks accumulated from the identity reproduces the NumPy product
    to 1e-12 relative to its norm."""
    rng = np.random.default_rng(7 * n + length)
    blocks = [_rand(rng, (n, n), dtype) for _ in range(length)]
    real = np.finfo(np.dtype(dtype)).dtype
    f = UDV(jnp.eye(n, dtype=dtype), jnp.ones((n,), real),
            jnp.eye(n, dtype=dtype))
    ref = np.eye(n, dtype=dtype)
    for B in blocks:
        f = udv_refactor(jnp.asarray(B) @ f.U, f.d, f.V,
                         compose_dtype=jnp.dtype(dtype))
        ref = B @ ref
    got = (np.asarray(f.U) * np.asarray(f.d)[None, :]) @ np.asarray(f.V)
    rel = np.abs(got - ref).max() / np.abs(ref).max()
    assert rel < 1e-12, rel


@pytest.mark.parametrize("dtype, beta", [
    ("float64", 2.0), ("float64", 4.0), ("float64", 8.0), ("float64", 12.0),
    ("float32", 1.0), ("float32", 2.0), ("float32", 4.0), ("float32", 8.0)])
def test_hubbard_green_matches_oracle_graded(dtype, beta):
    """Stabilized G(0) of a random field vs the f64 oracle over chains
    whose scales grow like e^{beta W}: float64 end to end to 1e-8 up to
    beta = 12, float32 with its f64 island to 1e-4 up to the headline
    beta = 8."""
    m = int(round(beta * 10))
    cfg = HubbardConfig(L=4, U=4.0, beta=beta, m=m, s=5, dtype=dtype,
                        ph_symmetry="off")
    model = HubbardModel(cfg)
    st = jax.jit(model.init_state)(jax.random.key(int(beta)))
    field = np.asarray(st.field, np.float64)
    oracle = HubbardOracle(L=4, U=4.0, beta=beta, m=m)
    tol = 1e-8 if dtype == "float64" else 1e-4
    for c, spin in enumerate((+1, -1)):
        ref = oracle.green(field, spin, 0, stab_interval=5)
        np.testing.assert_allclose(np.asarray(st.G[c], np.float64), ref,
                                   atol=tol, err_msg=f"spin {spin}")


@pytest.mark.parametrize("beta", [1.0, 4.0])
@pytest.mark.parametrize("opdim", [1, 2, 3])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sdw_green_matches_oracle_graded(dtype, opdim, beta):
    """SDW full 4-orbital G(0) vs the oracle: complex128 (real for
    opdim 1) to 1e-8, complex64 with its complex128 island to 1e-4."""
    m = int(round(beta * 8))
    cfg = SDWConfig(L=2, opdim=opdim, r=0.5, beta=beta, m=m, s=2,
                    dtype=dtype, fermion_matrix="full")
    model = SDWModel(cfg)
    st = jax.jit(model.init_state)(jax.random.key(opdim))
    oracle = SDWOracle(L=2, opdim=opdim, r=0.5, beta=beta, m=m)
    ref = oracle.green(np.asarray(st.phi, np.float64), 0)
    tol = 1e-8 if dtype == "float64" else 1e-4
    np.testing.assert_allclose(np.asarray(st.G, np.complex128), ref,
                               atol=tol)


@pytest.mark.parametrize("spread", [0.5, 3.0, 8.0])
@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_log_det_one_plus_udv_graded(dtype, spread):
    """log|det(1 + U d V)| and its phase vs NumPy slogdet of the formed
    matrix, for scales spanning e^{+-spread}."""
    n = 12
    rng = np.random.default_rng(int(10 * spread))
    U = np.linalg.qr(_rand(rng, (n, n), dtype))[0]
    V = np.triu(_rand(rng, (n, n), dtype), 1) + np.eye(n)
    d = np.exp(np.linspace(spread, -spread, n))
    ld, ph = log_det_one_plus_udv(UDV(jnp.asarray(U), jnp.asarray(d),
                                      jnp.asarray(V)))
    s_ref, ld_ref = np.linalg.slogdet(np.eye(n) + (U * d[None, :]) @ V)
    np.testing.assert_allclose(float(ld), ld_ref, rtol=1e-10)
    np.testing.assert_allclose(complex(ph), complex(s_ref), atol=1e-10)
