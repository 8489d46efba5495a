"""Naive fp64/complex128 NumPy oracle for the SDW model.

Brute-force construction of the (4N, 4N) fermion matrices, stabilized
Green's functions and determinant ratios, mirroring tests/oracle/
hubbard_oracle.py. Conventions identical to detqmc.models.sdw:
B_l = exp(-dtau V(phi_l)) @ exp(-dtau K), orbital-major (x_up, x_dn,
y_up, y_dn) layout.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla

PAULIS = np.array([
    [[0, 1], [1, 0]],
    [[0, -1j], [1j, 0]],
    [[1, 0], [0, -1]],
], dtype=np.complex128)


class SDWOracle:
    def __init__(self, L=2, opdim=2, r=0.5, lam=1.0, u=1.0, c=1.0,
                 txhor=-1.0, txver=-0.5, tyhor=-0.5, tyver=-1.0,
                 mu=-0.5, beta=2.0, m=8):
        from detqmc.lattice import SquareLattice, kinetic_exponentials

        self.lat = SquareLattice(L)
        self.N = self.lat.n_sites
        self.dim = 4 * self.N
        self.opdim = opdim
        self.r, self.lam, self.u, self.c = r, lam, u, c
        self.mu, self.beta, self.m = mu, beta, m
        self.dtau = beta / m
        Kx = self.lat.hopping_matrix(1.0, tx=txhor, ty=txver)
        Ky = self.lat.hopping_matrix(1.0, tx=tyhor, ty=tyver)
        self.Kx, self.Ky = Kx, Ky
        ex, exi = kinetic_exponentials(Kx, self.dtau, mu)
        ey, eyi = kinetic_exponentials(Ky, self.dtau, mu)
        Z = np.zeros_like(ex)
        self.expK = np.block([
            [ex, Z, Z, Z], [Z, ex, Z, Z], [Z, Z, ey, Z], [Z, Z, Z, ey]
        ]).astype(np.complex128)
        self.expK_inv = np.block([
            [exi, Z, Z, Z], [Z, exi, Z, Z], [Z, Z, eyi, Z], [Z, Z, Z, eyi]
        ]).astype(np.complex128)

    def v_matrix(self, phi_slice: np.ndarray) -> np.ndarray:
        """Dense (4N, 4N) V for one slice (lam included)."""
        N = self.N
        V = np.zeros((self.dim, self.dim), np.complex128)
        for i in range(N):
            Phi = np.tensordot(phi_slice[i], PAULIS[:self.opdim], axes=1)
            idx = [i, N + i, 2 * N + i, 3 * N + i]
            block = self.lam * np.block(
                [[np.zeros((2, 2)), Phi], [Phi.conj().T, np.zeros((2, 2))]])
            V[np.ix_(idx, idx)] = block
        return V

    def b_mat(self, phi_slice: np.ndarray) -> np.ndarray:
        return sla.expm(-self.dtau * self.v_matrix(phi_slice)) @ self.expK

    def b_chain(self, phi, lo, hi):
        A = np.eye(self.dim, dtype=np.complex128)
        for l in range(lo + 1, hi + 1):
            A = self.b_mat(phi[l - 1]) @ A
        return A

    def green(self, phi, l, stab_interval=2):
        left = self._stab(phi, 0, l, stab_interval)
        right = self._stab(phi, l, self.m, stab_interval)
        U1, d1, V1 = left
        U2, d2, V2 = right
        d1max, d1min = np.maximum(d1, 1), np.minimum(d1, 1)
        d2max, d2min = np.maximum(d2, 1), np.minimum(d2, 1)
        inner = (np.diag(1 / d1max) @ U1.conj().T @ np.linalg.inv(V2)
                 @ np.diag(1 / d2max)
                 + np.diag(d1min) @ (V1 @ U2) @ np.diag(d2min))
        return (np.linalg.inv(V2) @ np.diag(1 / d2max)
                @ np.linalg.inv(inner) @ np.diag(1 / d1max) @ U1.conj().T)

    def _stab(self, phi, lo, hi, step_size):
        U = np.eye(self.dim, dtype=np.complex128)
        d = np.ones(self.dim)
        V = np.eye(self.dim, dtype=np.complex128)
        l = lo
        while l < hi:
            step = min(step_size, hi - l)
            blk = self.b_chain(phi, l, l + step)
            C = (blk @ U) * d[None, :]
            Q, R = np.linalg.qr(C)
            diag = np.diag(R)
            dn = np.abs(diag)
            ph = np.where(dn == 0, 1.0, diag / np.where(dn == 0, 1, dn))
            U = Q * ph[None, :]
            d = dn
            V = ((R * ph.conj()[:, None]) / np.where(dn == 0, 1, dn)[:, None]
                 ) @ V
            l += step
        return U, d, V

    def det_M(self, phi):
        return np.linalg.det(
            np.eye(self.dim) + self.b_chain(phi, 0, self.m))

    def boson_action(self, phi):
        dtau, c = self.dtau, self.c
        s_tau = np.sum((phi - np.roll(phi, 1, axis=0)) ** 2) \
            / (2 * c ** 2 * dtau ** 2)
        nb = self.lat.neighbors()
        dx = phi - phi[:, nb[:, 0]]
        dy = phi - phi[:, nb[:, 2]]
        s_grad = 0.5 * (np.sum(dx ** 2) + np.sum(dy ** 2))
        phi2 = np.sum(phi ** 2, axis=-1)
        s_pot = 0.5 * self.r * np.sum(phi2) + 0.25 * self.u * np.sum(
            phi2 ** 2)
        return dtau * (s_tau + s_grad + s_pot)


def classical_on_mc(L, opdim, r, u, c, beta, m, n_sweeps, rng, box=1.0):
    """Independent plain-Metropolis sampler of the pure boson action
    (turnoffFermions limit), for statistical cross-checks."""
    from detqmc.lattice import SquareLattice

    lat = SquareLattice(L)
    N = lat.n_sites
    nb = lat.neighbors()
    dtau = beta / m
    phi = rng.normal(0, 0.5, (m, N, opdim))

    def local_dS(phi, l, i, new):
        old = phi[l, i]
        lp, lm = (l + 1) % m, (l - 1) % m
        def terms(v):
            t = (np.sum((v - phi[lp, i]) ** 2)
                 + np.sum((v - phi[lm, i]) ** 2)) / (2 * c ** 2 * dtau ** 2)
            g = 0.5 * np.sum((v[None] - phi[l, nb[i]]) ** 2)
            p2 = np.sum(v ** 2)
            return t + g + 0.5 * r * p2 + 0.25 * u * p2 ** 2
        return dtau * (terms(new) - terms(old))

    samples = []
    for sweep in range(n_sweeps):
        for l in range(m):
            for i in range(N):
                new = phi[l, i] + rng.uniform(-box, box, opdim)
                if rng.random() < np.exp(-local_dS(phi, l, i, new)):
                    phi[l, i] = new
        if sweep >= n_sweeps // 3:
            samples.append(np.mean(np.sum(phi ** 2, axis=-1)))
    return np.array(samples)
