import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.linalg.udv import (
    UDV,
    green_from_two_udv,
    green_from_udv,
    log_det_one_plus_udv,
    singular_value_range,
    udv_decompose,
    udv_eye,
    udv_multiply_left,
)


def _rand(key, shape, dtype=jnp.float64):
    x = jax.random.normal(key, shape, dtype=jnp.float64)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        key2 = jax.random.fold_in(key, 1)
        x = x + 1j * jax.random.normal(key2, shape, dtype=jnp.float64)
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.complex128])
def test_udv_reconstructs(dtype):
    A = _rand(jax.random.key(0), (16, 16), dtype)
    f = udv_decompose(A)
    rec = f.U @ jnp.diag(f.d.astype(dtype)) @ f.V
    np.testing.assert_allclose(rec, A, atol=1e-12)
    # U unitary, d positive
    np.testing.assert_allclose(f.U.conj().T @ f.U, jnp.eye(16), atol=1e-12)
    assert (f.d > 0).all()


def test_udv_batched():
    A = _rand(jax.random.key(1), (5, 8, 8))
    f = udv_decompose(A)
    rec = f.U @ (f.d[..., :, None] * f.V)
    np.testing.assert_allclose(rec, A, atol=1e-12)


def test_udv_multiply_left_ill_conditioned():
    """Chain of exponentially scaled matrices stays accurate in factored
    form — the whole point of UdV stabilization."""
    key = jax.random.key(2)
    n = 12
    f = udv_eye(n, jnp.float64)
    acc = jnp.eye(n)
    Bs = []
    for i in range(8):
        B = _rand(jax.random.fold_in(key, i), (n, n)) @ jnp.diag(
            jnp.exp(jnp.linspace(-3, 3, n)))
        Bs.append(B)
        f = udv_multiply_left(B, f)
        acc = B @ acc
    rec = f.U @ (f.d[:, None] * f.V)
    np.testing.assert_allclose(rec, acc, rtol=1e-9)
    lo_hi = singular_value_range(f)
    assert lo_hi[0] > lo_hi[1]


def test_green_from_udv_matches_direct():
    A = _rand(jax.random.key(3), (16, 16)) * 0.5
    f = udv_decompose(A)
    G = green_from_udv(f)
    G_direct = jnp.linalg.inv(jnp.eye(16) + A)
    np.testing.assert_allclose(G, G_direct, atol=1e-12)


def test_green_from_two_udv_matches_direct():
    key = jax.random.key(4)
    n = 16
    Lm = _rand(key, (n, n)) * 0.7
    Rm = _rand(jax.random.fold_in(key, 1), (n, n)) * 0.7
    left = udv_decompose(Lm)
    right_t = udv_decompose(Rm.T)  # transposed-right convention
    G = green_from_two_udv(left, right_t)
    G_direct = jnp.linalg.inv(jnp.eye(n) + Lm @ Rm)
    np.testing.assert_allclose(G, G_direct, atol=1e-12)


def test_green_stable_for_long_chain():
    """G from factored halves of a long ill-conditioned chain matches the
    fp64 direct inverse computed while it is still representable."""
    key = jax.random.key(5)
    n = 10
    m = 12
    Bs = [jnp.linalg.qr(_rand(jax.random.fold_in(key, i), (n, n)))[0]
          @ jnp.diag(jnp.exp(jnp.linspace(-2.5, 2.5, n)))
          for i in range(m)]
    l_split = 5
    left = udv_eye(n, jnp.float64)
    for B in Bs[:l_split]:
        left = udv_multiply_left(B, left)
    right_t = udv_eye(n, jnp.float64)
    # right product B_m...B_{l+1} transposed = B_{l+1}^T ... B_m^T:
    # build by prepending B^T in decreasing slice order (down-sweep order)
    for B in reversed(Bs[l_split:]):
        right_t = udv_multiply_left(B.T, right_t)
    G = green_from_two_udv(left, right_t)
    prod = jnp.eye(n)
    for B in Bs:
        prod = B @ prod  # B_m ... B_1
    # direct (1 + B_l..B_1 B_m..B_{l+1})^{-1}
    Lp = jnp.eye(n)
    for B in Bs[:l_split]:
        Lp = B @ Lp
    Rp = jnp.eye(n)
    for B in Bs[l_split:]:
        Rp = B @ Rp
    G_direct = jnp.linalg.inv(jnp.eye(n) + Lp @ Rp)
    np.testing.assert_allclose(G, G_direct, rtol=2e-7, atol=1e-9)


def test_right_stack_transpose_convention():
    """Appending B blocks to a transposed right stack factors B_m...B_{l+1}."""
    key = jax.random.key(6)
    n = 8
    Bs = [_rand(jax.random.fold_in(key, i), (n, n)) for i in range(4)]
    f = udv_eye(n, jnp.float64)
    # accumulate slices l+1..m in increasing order (down-stack build order is
    # decreasing, but multiply_left with B^T handles either: product of
    # transposes in reverse order). Here: descending l like a down sweep.
    for B in reversed(Bs):
        f = udv_multiply_left(B.T, f)
    rec_t = f.U @ (f.d[:, None] * f.V)
    prod = jnp.eye(n)
    for B in Bs:
        prod = B @ prod  # B_4 B_3 B_2 B_1
    np.testing.assert_allclose(rec_t.T, prod, rtol=1e-10)


def test_log_det_one_plus_udv():
    A = _rand(jax.random.key(7), (12, 12)) * 0.6
    f = udv_decompose(A)
    ld, sign = log_det_one_plus_udv(f)
    det = jnp.linalg.det(jnp.eye(12) + A)
    np.testing.assert_allclose(sign * jnp.exp(ld), det, rtol=1e-10)


def test_udv_jit_and_vmap():
    A = _rand(jax.random.key(8), (3, 8, 8))
    f = jax.jit(jax.vmap(udv_decompose))(A)
    rec = f.U @ (f.d[..., :, None] * f.V)
    np.testing.assert_allclose(rec, A, atol=1e-12)
