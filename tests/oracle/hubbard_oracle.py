"""Naive fp64 NumPy oracle for BSS determinantal QMC on the Hubbard model.

Deliberately simple and slow: Green's functions are recomputed from scratch
with fp64 QR stabilization, determinant ratios are evaluated exactly, and
the Metropolis sweep mirrors the reference algorithm (SURVEY.md §9 "Hubbard
HS"). This stands in for the absent reference binary as the correctness
anchor (SURVEY.md §5, §8 step 1) — detqmc must agree with this to
1e-8 on fixed auxiliary-field configurations in float64.

Conventions (shared with detqmc.models.hubbard):
  H = -t sum_<ij>s c+_is c_js + U sum_i (n_up - 1/2)(n_dn - 1/2)
      - mu sum n                                  (half filling at mu = 0)
  cosh(alpha) = exp(dtau U / 2)
  B_s(l) = diag(exp(s_spin * alpha * s[l])) @ expm(-dtau(K - mu))
           with s_spin = +1 (up), -1 (down), s[l] in {-1, +1}^N
           (potential factor leftmost so the G(l)-based flip formulas hold)
  M_s = 1 + B_s(m) ... B_s(1)
  G_s(l) = [1 + B_s(l)...B_s(1) B_s(m)...B_s(l+1)]^{-1},  G_ij = <c_i c+_j>
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class HubbardOracle:
    L: int
    t: float = 1.0
    U: float = 4.0
    mu: float = 0.0
    beta: float = 4.0
    m: int = 40  # number of imaginary-time slices; dtau = beta / m

    def __post_init__(self):
        from detqmc.lattice import SquareLattice, kinetic_exponentials

        self.lat = SquareLattice(self.L)
        self.N = self.lat.n_sites
        self.dtau = self.beta / self.m
        self.alpha = np.arccosh(np.exp(self.dtau * self.U / 2.0))
        self.K = self.lat.hopping_matrix(self.t)
        self.expK, self.expK_inv = kinetic_exponentials(
            self.K, self.dtau, self.mu)

    # -- B matrices --------------------------------------------------------
    def b_mat(self, s_slice: np.ndarray, spin: int) -> np.ndarray:
        """B_spin(l) = diag(exp(spin*alpha*s_l)) @ expK (potential leftmost;
        see detqmc.linalg.bchain for why this ordering pairs with the
        G(l)-based update formulas)."""
        return np.exp(spin * self.alpha * s_slice)[:, None] * self.expK

    def b_chain(self, s: np.ndarray, spin: int, lo: int, hi: int
                ) -> np.ndarray:
        """B(hi) ... B(lo+1) as a plain fp64 product (slices are 1-based;
        s has shape (m, N))."""
        A = np.eye(self.N)
        for l in range(lo + 1, hi + 1):
            A = self.b_mat(s[l - 1], spin) @ A
        return A

    # -- stabilized Green --------------------------------------------------
    def green(self, s: np.ndarray, spin: int, l: int, stab_interval: int = 8
              ) -> np.ndarray:
        """G_spin(l) via QR-stabilized chain products (fp64)."""
        left = self._stab_product(s, spin, 0, l, stab_interval)
        right = self._stab_product(s, spin, l, self.m, stab_interval)
        # G = (1 + L R)^{-1}, with L = B_l..B_1, R = B_m..B_{l+1}
        U1, d1, V1 = left
        U2, d2, V2 = right
        # inner = U1^T V2^{-1}... use the simple fp64 route: form with
        # range-split to be safe even at large beta.
        d1max, d1min = np.maximum(d1, 1), np.minimum(d1, 1)
        d2max, d2min = np.maximum(d2, 1), np.minimum(d2, 1)
        inner = (np.diag(1 / d1max) @ U1.T @ np.linalg.inv(V2)
                 @ np.diag(1 / d2max)
                 + np.diag(d1min) @ (V1 @ U2) @ np.diag(d2min))
        G = (np.linalg.inv(V2) @ np.diag(1 / d2max) @ np.linalg.inv(inner)
             @ np.diag(1 / d1max) @ U1.T)
        return G

    def _stab_product(self, s, spin, lo, hi, stab_interval):
        """QR-stabilized U d V of B(hi) ... B(lo+1)."""
        U = np.eye(self.N)
        d = np.ones(self.N)
        V = np.eye(self.N)
        l = lo
        while l < hi:
            step = min(stab_interval, hi - l)
            blk = self.b_chain(s, spin, l, l + step)
            C = (blk @ U) * d[None, :]
            Q, R = np.linalg.qr(C)
            sign = np.sign(np.diag(R))
            sign[sign == 0] = 1.0
            U = Q * sign[None, :]
            d = np.abs(np.diag(R))
            V = ((R * sign[:, None]) / d[:, None]) @ V
            l += step
        return U, d, V

    def green_naive(self, s: np.ndarray, spin: int, l: int) -> np.ndarray:
        """Unstabilized G for tiny systems (direct inverse)."""
        left = self.b_chain(s, spin, 0, l)
        right = self.b_chain(s, spin, l, self.m)
        return np.linalg.inv(np.eye(self.N) + left @ right)

    # -- Metropolis sweep (sequential, reference algorithm) -----------------
    def flip_ratio(self, G: dict, s: np.ndarray, i: int, l: int):
        """Per-spin determinant ratios for flipping s[l-1, i]."""
        out = {}
        for spin in (+1, -1):
            delta = np.exp(-2.0 * spin * self.alpha * s[l - 1, i]) - 1.0
            out[spin] = 1.0 + delta * (1.0 - G[spin][i, i])
        return out

    def sm_update(self, G: np.ndarray, i: int, delta: float, R: float
                  ) -> np.ndarray:
        """Sherman-Morrison rank-1 update of G after an accepted flip."""
        u = G[:, i].copy()
        w = -G[i, :].copy()
        w[i] += 1.0  # (e_i - G[i, :]) = row i of (1 - G)
        return G - (delta / R) * np.outer(u, w)

    def sweep(self, s: np.ndarray, rng: np.random.Generator,
              stab_interval: int = 8):
        """One full up-sweep of sequential single-site Metropolis updates,
        recomputing stabilized G at every slice (slow but exact).
        Returns (s, n_accepted)."""
        n_acc = 0
        for l in range(1, self.m + 1):
            G = {spin: self.green(s, spin, l, stab_interval)
                 for spin in (+1, -1)}
            for i in range(self.N):
                ratios = self.flip_ratio(G, s, i, l)
                R = ratios[+1] * ratios[-1]
                if rng.random() < R:
                    for spin in (+1, -1):
                        delta = np.exp(
                            -2.0 * spin * self.alpha * s[l - 1, i]) - 1.0
                        G[spin] = self.sm_update(
                            G[spin], i, delta, ratios[spin])
                    s[l - 1, i] = -s[l - 1, i]
                    n_acc += 1
        return s, n_acc

    # -- observables --------------------------------------------------------
    def observables(self, Gu: np.ndarray, Gd: np.ndarray) -> dict:
        N = self.N
        nu = 1.0 - np.diag(Gu)
        nd = 1.0 - np.diag(Gd)
        occ = (nu + nd).mean()
        docc = (nu * nd).mean()
        e_kin = -(np.sum(self.K.T * Gu) + np.sum(self.K.T * Gd)) / N
        e_pot = self.U * np.mean(nu * nd - 0.5 * (nu + nd) + 0.25)
        return {
            "occupancy": occ,
            "doubleOccupancy": docc,
            "kineticEnergy": e_kin,
            "potentialEnergy": e_pot,
            "totalEnergy": e_kin + e_pot,
        }


def exact_free_green(K: np.ndarray, beta: float, mu: float = 0.0
                     ) -> np.ndarray:
    """U=0 closed form: G = [1 + e^{-beta (K-mu)}]^{-1} (slice-independent).

    Continuum answer; the Trotterized U=0 chain [1 + (e^{-dtau(K-mu)})^m]^{-1}
    equals it exactly because all factors commute.
    """
    w, V = np.linalg.eigh(K)
    g = 1.0 / (1.0 + np.exp(-beta * (w - mu)))
    return (V * g) @ V.T


def hubbard_ed(K: np.ndarray, U: float, mu: float, beta: float) -> dict:
    """Exact diagonalization of the Hubbard model on an arbitrary small
    hopping matrix K (4^N-dim Fock space; N <= 5 practical) — the
    statistical end-to-end anchor (SURVEY.md §5 implication (c)).

    H = sum_s sum_ij K_ij c+_is c_js + U sum_i (n_iu - .5)(n_id - .5)
        - mu sum_i n_i
    Returns per-site occupancy, double occupancy, kinetic/potential/total
    energy per site.
    """
    N = K.shape[0]
    dim = 4 ** N
    nbits = 2 * N  # up bits 0..N-1, down bits N..2N-1

    def occ(state: int, mode: int) -> int:
        return (state >> mode) & 1

    def parity_between(state: int, a: int, b: int) -> int:
        lo, hi = (a, b) if a < b else (b, a)
        mask = ((1 << hi) - 1) ^ ((1 << (lo + 1)) - 1)
        return bin(state & mask).count("1")

    H = np.zeros((dim, dim))
    Ekin_op = np.zeros((dim, dim))
    n_diag = np.zeros(dim)
    docc_diag = np.zeros(dim)
    for st in range(dim):
        ntot = 0
        dd = 0.0
        epot = 0.0
        for i in range(N):
            nu_, nd_ = occ(st, i), occ(st, N + i)
            ntot += nu_ + nd_
            dd += nu_ * nd_
            epot += U * (nu_ - 0.5) * (nd_ - 0.5)
        n_diag[st] = ntot
        docc_diag[st] = dd / N
        H[st, st] += epot - mu * ntot
        # hopping: c+_a c_b within each spin sector
        for sigma in range(2):
            off = sigma * N
            for a in range(N):
                for b in range(N):
                    if a == b or K[a, b] == 0.0 or not occ(st, off + b):
                        continue
                    mid = st & ~(1 << (off + b))
                    if occ(mid, off + a):
                        continue
                    new = mid | (1 << (off + a))
                    sign = (-1) ** parity_between(st, off + a, off + b)
                    amp = K[a, b] * sign
                    H[new, st] += amp
                    Ekin_op[new, st] += amp

    w, V = np.linalg.eigh(H)
    w0 = w.min()
    rho = np.exp(-beta * (w - w0))
    Z = rho.sum()

    def expect(op) -> float:
        if op.ndim == 1:
            d = np.einsum("as,a,as->s", V, op, V)
        else:
            d = np.einsum("as,ab,bs->s", V, op, V)
        return float((d * rho).sum() / Z)

    e_tot = float((w * rho).sum() / Z) / N
    e_kin = expect(Ekin_op) / N
    return {
        "occupancy": expect(n_diag) / N,
        "doubleOccupancy": expect(docc_diag),
        "kineticEnergy": e_kin,
        "totalEnergy": e_tot + mu * expect(n_diag) / N,
        "potentialEnergy": e_tot + mu * expect(n_diag) / N - e_kin,
    }
