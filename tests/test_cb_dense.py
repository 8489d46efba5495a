"""Dense-product checkerboard apply (cb_apply="dense", the default).

The checkerboard breakup defines E as a PRODUCT of bond-group factors;
applying the precomputed product matrix as one matmul must agree with the
literal sequential gather+axpy passes (cb_apply="sparse" — the
reference's O(N) apply, SURVEY.md §3 row "Checkerboard hopping") to
fp64 rounding, for every variant (inverse, transpose, right-apply) and
for both models, including d != 2 Hubbard lattices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc import lattice as lattice_mod
from detqmc.linalg import bchain
from detqmc.models.hubbard import HubbardConfig, HubbardModel
from detqmc.models.sdw import SDWConfig, SDWModel


@pytest.mark.parametrize("opdim", [1, 3])
def test_sdw_dense_matches_sparse_applies(opdim):
    kw = dict(L=4, opdim=opdim, beta=2.0, m=20, s=2, dtype="float64",
              checkerboard=True)
    md = SDWModel(SDWConfig(**kw))                  # auto -> dense
    ms = SDWModel(SDWConfig(**kw, cb_apply="sparse"))
    assert not md.cb_sparse and ms.cb_sparse
    eye = jnp.eye(md.dim, dtype=md.cdtype)
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.normal(size=(md.dim, md.dim)), md.cdtype)
    for kwargs in ({}, {"inv": True}, {"transpose": True},
                   {"inv": True, "transpose": True}):
        np.testing.assert_allclose(
            np.asarray(md.kinetic_mult_left(X, **kwargs)),
            np.asarray(ms.kinetic_mult_left(X, **kwargs)), atol=1e-12)
    for kwargs in ({}, {"inv": True}):
        np.testing.assert_allclose(
            np.asarray(md.kinetic_mult_right(X, **kwargs)),
            np.asarray(ms.kinetic_mult_right(X, **kwargs)), atol=1e-12)
    # the product matrix is exactly invertible (per-factor inverses)
    E = np.asarray(md.kinetic_mult_left(eye))
    Einv = np.asarray(md.kinetic_mult_left(eye, inv=True))
    np.testing.assert_allclose(E @ Einv, np.eye(md.dim), atol=1e-12)


@pytest.mark.parametrize("d,L,mu", [(2, 4, 0.0), (2, 4, -0.3), (3, 2, 0.0)])
def test_hubbard_dense_matches_sparse_applies(d, L, mu):
    lat = lattice_mod.SquareLattice(L) if d == 2 else \
        lattice_mod.HyperCubicLattice(L, d)
    kw = dict(dtype=jnp.float64, checkerboard=True)
    pd = bchain.make_propagators(lat, 1.0, 0.1, mu, cb_dense=True, **kw)
    ps = bchain.make_propagators(lat, 1.0, 0.1, mu, cb_dense=False, **kw)
    rng = np.random.default_rng(5)
    X = jnp.asarray(rng.normal(size=(lat.n_sites, lat.n_sites)),
                    jnp.float64)
    e = jnp.asarray(np.exp(rng.normal(size=lat.n_sites) * 0.3), jnp.float64)
    for fd, fs in (
        (lambda: bchain.b_mult_left(pd, e, X),
         lambda: bchain.b_mult_left(ps, e, X, checkerboard=True)),
        (lambda: bchain.b_inv_mult_left(pd, e, X),
         lambda: bchain.b_inv_mult_left(ps, e, X, checkerboard=True)),
        (lambda: bchain.b_mult_right(pd, X, e),
         lambda: bchain.b_mult_right(ps, X, e, checkerboard=True)),
        (lambda: bchain.b_inv_mult_right(pd, X, e),
         lambda: bchain.b_inv_mult_right(ps, X, e, checkerboard=True)),
        (lambda: bchain.bT_mult_left(pd, e, X),
         lambda: bchain.bT_mult_left(ps, e, X, checkerboard=True)),
    ):
        np.testing.assert_allclose(np.asarray(fd()), np.asarray(fs()),
                                   atol=1e-12)


def test_hubbard_dense_transpose_is_reversed_product():
    """The cb product matrix is NOT symmetric; the dense apply must honor
    transpose (E^T = reversed factor order), which the sparse path
    computes explicitly. (L=6: on an L=4 ring the even/odd matchings
    happen to commute — shift by +2 == -2 mod 4 — making the product
    accidentally symmetric, so L=4 cannot detect a transpose bug.)"""
    lat = lattice_mod.SquareLattice(6)
    pd = bchain.make_propagators(lat, 1.0, 0.1, 0.0, dtype=jnp.float64,
                                 checkerboard=True, cb_dense=True)
    E = np.asarray(pd.expK)
    assert np.abs(E - E.T).max() > 1e-8  # genuinely asymmetric
    eye = jnp.eye(lat.n_sites, dtype=jnp.float64)
    ET = np.asarray(bchain.kinetic_mult_left(pd, eye, transpose=True))
    np.testing.assert_allclose(ET, E.T, atol=1e-14)


def test_hubbard_sparse_sweep_self_consistent():
    """cb_apply='sparse' keeps full-sweep coverage of the literal
    bond-group path (auto now runs dense)."""
    cfg = HubbardConfig(L=4, U=4.0, beta=4.0, m=40, s=8,
                        checkerboard=True, cb_apply="sparse",
                        dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(9))
    state, _ = model.sweep_up(state, measure=True)
    assert float(state.green_dev) < 1e-8


def test_sdw_sparse_sweep_self_consistent():
    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=2.0, m=8, s=2,
                    dtype="float64", checkerboard=True, cb_apply="sparse")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(21))
    state, _ = model.sweep_pair(state, measure=True)
    assert float(state.green_dev) < 1e-8
