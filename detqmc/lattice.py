"""Periodic square-lattice geometry: neighbor tables, checkerboard bond
groups, hopping matrices, and momentum grids.

Reference parity: the reference builds nearest-neighbor tables and
checkerboard bond groupings inside its model classes (SURVEY.md §3 rows
"Lattice/neighbors" and "Checkerboard hopping"). Here they are a standalone
module producing static NumPy index tables that get closed over by jitted
sweep programs — geometry never changes during a run, so it must be trace
-time constant for XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class HyperCubicLattice:
    """L^d periodic hypercubic lattice, d in {1, 2, 3}.

    Reference parity: the reference's Hubbard model runs on L^d periodic
    lattices (SURVEY.md §1/§3 "Hubbard model"). Site index convention:
    site = sum_ax c_ax * L^ax (axis 0 fastest — for d=2 this is the
    row-major y*L + x of SquareLattice).
    """

    L: int
    d: int = 2

    def __post_init__(self):
        if self.d not in (1, 2, 3):
            raise ValueError(f"d must be 1, 2 or 3, got {self.d}")

    @property
    def n_sites(self) -> int:
        return self.L ** self.d

    # -- coordinates ------------------------------------------------------
    def coords(self, site: np.ndarray) -> np.ndarray:
        """(..., d) coordinates, axis 0 fastest."""
        site = np.asarray(site)
        return np.stack([(site // self.L ** ax) % self.L
                         for ax in range(self.d)], axis=-1)

    def site_of(self, coords: np.ndarray) -> np.ndarray:
        """(..., d) coordinates (any integers; wrapped) -> site index."""
        c = np.asarray(coords) % self.L
        s = np.zeros(c.shape[:-1], dtype=np.int64)
        for ax in range(self.d):
            s = s + c[..., ax] * self.L ** ax
        return s

    # -- neighbor table ---------------------------------------------------
    def neighbors(self) -> np.ndarray:
        """(N, 2d) int array: +ax0, -ax0, +ax1, -ax1, ... periodic nn."""
        s = np.arange(self.n_sites)
        c = self.coords(s)
        cols = []
        for ax in range(self.d):
            step = np.zeros(self.d, dtype=np.int64)
            step[ax] = 1
            cols.append(self.site_of(c + step))
            cols.append(self.site_of(c - step))
        return np.stack(cols, axis=1)

    # -- hopping matrix ---------------------------------------------------
    def hopping_matrix(self, t: float = 1.0, tx: float | None = None,
                       ty: float | None = None) -> np.ndarray:
        """Dense tight-binding matrix K with K[i, j] = -t for nn pairs.

        ``tx``/``ty`` allow anisotropic hopping along axes 0/1 (the SDW
        model's band structure; d=2 only); default isotropic ``t``.
        """
        ts = [t] * self.d
        if tx is not None:
            ts[0] = tx
        if ty is not None:
            assert self.d >= 2
            ts[1] = ty
        N = self.n_sites
        K = np.zeros((N, N))
        s = np.arange(N)
        c = self.coords(s)
        for ax in range(self.d):
            step = np.zeros(self.d, dtype=np.int64)
            step[ax] = 1
            K[s, self.site_of(c + step)] -= ts[ax]
            K[s, self.site_of(c - step)] -= ts[ax]
        return K

    # -- checkerboard bond groups ----------------------------------------
    def checkerboard_groups(self) -> np.ndarray:
        """Partner tables for the 2d bond groups of the checkerboard
        breakup (groups 2*ax / 2*ax+1 = axis-ax bonds starting at
        even/odd coordinate). For even L each group is a perfect matching:
        ``partner[g]`` is an involutive permutation.

        exp(-dtau*K_g) applied to a vector mixes each (i, partner_g[i])
        pair through a 2x2 [[cosh, sinh], [sinh, cosh]] rotation, so the
        whole group factor is one gather + axpy — the vectorized
        replacement for the reference's per-plaquette loop (SURVEY.md §3
        "Checkerboard").
        """
        if self.L % 2 != 0:
            raise ValueError(
                f"checkerboard breakup requires even L, got L={self.L}"
            )
        N = self.n_sites
        s = np.arange(N)
        c = self.coords(s)
        partner = np.zeros((2 * self.d, N), dtype=np.int32)
        for ax in range(self.d):
            step = np.zeros(self.d, dtype=np.int64)
            step[ax] = 1
            fwd = self.site_of(c + step)
            bwd = self.site_of(c - step)
            par = c[:, ax] % 2
            partner[2 * ax] = np.where(par == 0, fwd, bwd)
            partner[2 * ax + 1] = np.where(par == 1, fwd, bwd)
        for g in range(2 * self.d):
            assert (partner[g][partner[g]] == s).all()
        return partner

    # -- momentum grid ----------------------------------------------------
    def k_grid(self) -> np.ndarray:
        """(N, d) array of momenta 2*pi*n/L, same ordering as sites."""
        return 2.0 * np.pi / self.L * self.coords(np.arange(self.n_sites))

    def fourier_phases(self) -> np.ndarray:
        """(N_k, N_r) matrix exp(-i k.r) for structure factors."""
        k = self.k_grid()
        r = self.coords(np.arange(self.n_sites)).astype(np.float64)
        return np.exp(-1j * (k @ r.T))

    def stagger(self) -> np.ndarray:
        """(-1)^(sum of coordinates): the AF / particle-hole staggering."""
        return (-1.0) ** self.coords(np.arange(self.n_sites)).sum(axis=-1)


@dataclasses.dataclass(frozen=True)
class SquareLattice(HyperCubicLattice):
    """L x L periodic square lattice (d = 2, the reference's default)
    with the legacy (x, y) coordinate API used by the SDW model."""

    d: int = 2

    def __post_init__(self):
        super().__post_init__()
        if self.d != 2:
            raise ValueError("SquareLattice is d=2; use HyperCubicLattice")

    def xy(self, site: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return site % self.L, site // self.L

    def site(self, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        return (y % self.L) * self.L + (x % self.L)


def kinetic_exponentials(K: np.ndarray, dtau: float, mu: float = 0.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Dense exp(-dtau*(K - mu)) and its inverse via eigendecomposition.

    The reference precomputes the dense hopping exponential the same way
    (SURVEY.md §3 "Hubbard model": dense e^{-dtau K} via eigendecomposition);
    both the propagator and its inverse are needed for Green wrapping
    G -> B G B^{-1} without triangular solves (matmuls only).
    Computed once at setup in float64 on host, cast to the run dtype.
    """
    w, V = np.linalg.eigh(K)
    expK = (V * np.exp(-dtau * (w - mu))) @ V.T
    expK_inv = (V * np.exp(dtau * (w - mu))) @ V.T
    return expK, expK_inv
