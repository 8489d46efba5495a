import numpy as np
import pytest

from detqmc.lattice import SquareLattice, kinetic_exponentials


def test_neighbors_periodic():
    lat = SquareLattice(4)
    nb = lat.neighbors()
    assert nb.shape == (16, 4)
    # site 0 = (0,0): +x -> 1, -x -> 3, +y -> 4, -y -> 12
    assert list(nb[0]) == [1, 3, 4, 12]
    # every site appears exactly 4 times as someone's neighbor
    counts = np.bincount(nb.ravel(), minlength=16)
    assert (counts == 4).all()


def test_hopping_matrix_symmetric_and_row_sums():
    lat = SquareLattice(4)
    K = lat.hopping_matrix(t=1.0)
    assert np.allclose(K, K.T)
    assert np.allclose(K.sum(axis=1), -4.0)  # 4 neighbors * (-t)
    assert np.allclose(np.diag(K), 0.0)


def test_kinetic_exponential_inverse():
    lat = SquareLattice(4)
    K = lat.hopping_matrix()
    expK, expK_inv = kinetic_exponentials(K, dtau=0.1, mu=0.3)
    assert np.allclose(expK @ expK_inv, np.eye(16), atol=1e-12)
    # expm(-dtau K) for dtau -> 0 ~ 1 - dtau K + dtau mu
    expK2, _ = kinetic_exponentials(K, dtau=1e-6, mu=0.0)
    assert np.allclose(expK2, np.eye(16) - 1e-6 * K, atol=1e-10)


def test_checkerboard_groups_are_perfect_matchings():
    lat = SquareLattice(6)
    partner = lat.checkerboard_groups()
    s = np.arange(36)
    for g in range(4):
        p = partner[g]
        assert (p[p] == s).all()          # involution
        assert (p != s).all()             # no fixed points
    # union of the four groups covers every nn bond exactly once
    bonds = set()
    for g in range(4):
        for i in range(36):
            bonds.add(frozenset((i, int(partner[g][i]))))
    assert len(bonds) == 2 * 36  # 2N bonds on a periodic square lattice


def test_checkerboard_product_approximates_dense_exp():
    """First-order breakup error is O(dtau^2): halving dtau quarters it.

    (L=6: for L=4 the ring bond groups happen to commute and the breakup
    is exact, so it cannot probe the error scaling.)
    """
    lat = SquareLattice(6)
    K = lat.hopping_matrix()
    partner = lat.checkerboard_groups()

    def cb_dense(dtau):
        # build the dense matrix of the checkerboard product
        N = lat.n_sites
        c, s = np.cosh(dtau), np.sinh(dtau)  # t = 1
        M = np.eye(N)
        for g in range(4):
            F = np.zeros((N, N))
            F[np.arange(N), np.arange(N)] = c
            F[np.arange(N), partner[g]] = s
            M = F @ M
        return M

    errs = []
    for dtau in (0.1, 0.05):
        expK, _ = kinetic_exponentials(K, dtau)
        errs.append(np.abs(cb_dense(dtau) - expK).max())
    assert errs[0] / errs[1] == pytest.approx(4.0, rel=0.35)


def test_checkerboard_requires_even_L():
    with pytest.raises(ValueError):
        SquareLattice(5).checkerboard_groups()


def test_fourier_phases_unitary_rows():
    lat = SquareLattice(4)
    F = lat.fourier_phases()
    # rows orthogonal: F F^H = N * Identity
    assert np.allclose(F @ F.conj().T, 16 * np.eye(16), atol=1e-10)
