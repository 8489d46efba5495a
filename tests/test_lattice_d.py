"""L^d lattices (d = 1, 3) for the Hubbard model.

Reference parity: the reference's Hubbard model runs on L^d periodic
lattices (SURVEY.md §1/§3 "Hubbard model"); oracle anchor is the d=1
free-fermion closed form.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.lattice import HyperCubicLattice
from detqmc.models.hubbard import HubbardConfig, HubbardModel


def test_hypercubic_tables():
    for d in (1, 2, 3):
        lat = HyperCubicLattice(4, d)
        N = 4 ** d
        assert lat.n_sites == N
        nb = lat.neighbors()
        assert nb.shape == (N, 2 * d)
        s = np.arange(N)
        # +ax then -ax are inverse maps
        for ax in range(d):
            fwd, bwd = nb[:, 2 * ax], nb[:, 2 * ax + 1]
            np.testing.assert_array_equal(fwd[bwd], s)
        K = lat.hopping_matrix(1.0)
        np.testing.assert_array_equal(K, K.T)
        assert (K.sum(axis=1) == -2 * d).all()
        groups = lat.checkerboard_groups()
        assert groups.shape == (2 * d, N)
        # the group factors reassemble the full bond set
        pair_count = sum((groups[g] != s).sum() for g in range(2 * d))
        assert pair_count == 2 * d * N  # every site in d matchings x2


@pytest.mark.parametrize("d,L", [(1, 8), (3, 2)])
def test_free_fermion_d(d, L):
    """U=0 in d dimensions: G = (1 + expK^m)^{-1} exactly."""
    cfg = HubbardConfig(L=L, d=d, U=0.0, beta=2.0, m=16, s=4,
                        dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))
    expK = np.asarray(model.prop.expK, np.float64)
    G_exact = np.linalg.inv(
        np.eye(cfg.n_sites) + np.linalg.matrix_power(expK, cfg.m))
    np.testing.assert_allclose(np.asarray(state.G[0]), G_exact, atol=1e-10)


@pytest.mark.parametrize("d,L", [(1, 8), (3, 2)])
def test_interacting_sweep_d(d, L):
    """Interacting d=1/3 sweeps: stabilization consistent (green_dev ~ 0
    in fp64) and half-filling occupancy exactly 1 in ph mode."""
    cfg = HubbardConfig(L=L, d=d, U=4.0, beta=2.0, m=16, s=4,
                        dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(1))
    state, obs = model.sweep_pair(state, measure=True)
    assert float(state.green_dev) < 1e-9
    assert float(obs.occupancy) == pytest.approx(1.0, abs=1e-12)
    assert 0.0 < float(obs.doubleOccupancy) < 0.25


@pytest.mark.parametrize("d,L", [(1, 8), (3, 2)])
def test_checkerboard_matches_dense_d(d, L):
    """2d-group checkerboard breakup vs the dense propagator: identical
    Markov chain up to Trotter-breakup differences in the weight — here
    just compare the kinetic applies algebraically at first order and
    the exact involution identity E_cb E_cb^{-1} = 1."""
    from detqmc.linalg import bchain
    from detqmc.lattice import HyperCubicLattice

    lat = HyperCubicLattice(L, d)
    dtau = 0.05
    prop = bchain.make_propagators(lat, 1.0, dtau, 0.3, dtype=jnp.float64,
                                   checkerboard=True)
    N = lat.n_sites
    X = jnp.asarray(np.random.default_rng(0).normal(size=(N, N)))
    Y = bchain.kinetic_mult_left(prop, X, checkerboard=True)
    Yb = bchain.kinetic_mult_left(
        prop, Y, inv=True, checkerboard=True)
    np.testing.assert_allclose(np.asarray(Yb), np.asarray(X), atol=1e-12)
    # breakup error is O(dtau^2) against the dense exponential
    Yd = bchain.kinetic_mult_left(prop, X, checkerboard=False)
    assert float(jnp.abs(Y - Yd).max()) < 10 * dtau ** 2 * float(
        jnp.abs(X).max())
