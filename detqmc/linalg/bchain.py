"""B-matrix application: dense and checkerboard kinetic propagators.

JAX form of the reference's B-multiply callbacks (SURVEY.md §3 rows
"DQMC core" / "Checkerboard hopping": computeBmat, cbLMultHoppingExp /
cbRMultHoppingExp). A slice propagator is

    B_l = E_K @ diag(e_l),     E_K = exp(-dtau (K - mu)),
    e_l = exp(-dtau V(conf_l)) diagonal (Hubbard: e^{spin*alpha*s_l}),

so every application is (kinetic apply) x (diagonal scale). The kinetic
apply is either one dense matmul (preferred at small N, where a GEMM
is cheap) or the 4-bond-group checkerboard factorization
(one gather + axpy per group, O(N^2) for matrix operands).

All functions broadcast over arbitrary leading batch dims (spin components,
walkers) — geometry tables are trace-time constants.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from detqmc.lattice import SquareLattice, kinetic_exponentials
from detqmc.precision import mm


class Propagators(NamedTuple):
    """Static per-run propagator data (closed over by jitted sweeps)."""

    expK: jax.Array        # (N, N) dense exp(-dtau (K - mu))
    expK_inv: jax.Array    # (N, N)
    cb_partner: jax.Array  # (4, N) int32 bond-partner tables
    cb_cosh: jax.Array     # (4,) cosh(dtau * t_g) per group
    cb_sinh: jax.Array     # (4,) sinh per group
    cb_gamma: jax.Array    # (N,) exp(dtau * mu / n_applications) onsite piece


def make_propagators(lat: SquareLattice, t: float, dtau: float, mu: float,
                     dtype=jnp.float32, checkerboard: bool = False,
                     cb_dense: bool = False) -> Propagators:
    """``cb_dense``: replace expK/expK_inv by the EXACT dense product of
    the checkerboard factors (E = F_0..F_{g-1} * diag(gamma), inverse from
    the per-factor inverses — det F_g = 1 per bond). Same factorized
    physics; callers then use the dense apply (checkerboard=False), which
    is one matmul instead of 2d serial gather+axpy passes — the right
    trade at these matrix sizes."""
    K = lat.hopping_matrix(t)
    expK, expK_inv = kinetic_exponentials(K, dtau, mu)
    n_groups = 2 * getattr(lat, "d", 2)
    if checkerboard:
        partner = lat.checkerboard_groups()
        n_groups = partner.shape[0]
        # chemical potential folded as a uniform diagonal factor applied
        # once per kinetic apply
        gamma = np.full(lat.n_sites, np.exp(dtau * mu))
    else:
        partner = np.zeros((n_groups, lat.n_sites), dtype=np.int32)
        gamma = np.ones(lat.n_sites)
    c = np.cosh(dtau * t) * np.ones(n_groups)
    s = np.sinh(dtau * t) * np.ones(n_groups)
    if checkerboard and cb_dense:
        E = np.eye(lat.n_sites)
        Einv = np.eye(lat.n_sites)
        for g in reversed(range(n_groups)):  # E = F0 F1 ... (F_last first)
            E = c[g] * E + s[g] * E[partner[g], :]
        for g in range(n_groups):            # E^{-1} = F'_last ... F'_0
            Einv = c[g] * Einv - s[g] * Einv[partner[g], :]
        expK = gamma[:, None] * E
        expK_inv = Einv * (1.0 / gamma)[None, :]
    return Propagators(
        expK=jnp.asarray(expK, dtype),
        expK_inv=jnp.asarray(expK_inv, dtype),
        cb_partner=jnp.asarray(partner, jnp.int32),
        cb_cosh=jnp.asarray(c, dtype),
        cb_sinh=jnp.asarray(s, dtype),
        cb_gamma=jnp.asarray(gamma, dtype),
    )


# -- kinetic applies --------------------------------------------------------

def _cb_group_left(X, partner_g, c, s):
    """F_g @ X: rows i and partner[i] mix via [[c, s], [s, c]]."""
    return c * X + s * jnp.take(X, partner_g, axis=-2)


def _cb_group_right(X, partner_g, c, s):
    """X @ F_g (F_g symmetric): columns mix."""
    return c * X + s * jnp.take(X, partner_g, axis=-1)


def kinetic_mult_left(prop: Propagators, X: jax.Array, *,
                      inv: bool = False, transpose: bool = False,
                      checkerboard: bool = False) -> jax.Array:
    """E_K @ X (or E_K^{-1} @ X / E_K^T @ X).

    Dense E_K is symmetric so transpose is free. The checkerboard product
    E_cb = F_0 F_1 F_2 F_3 has E_cb^T = F_3 F_2 F_1 F_0 (each factor is
    symmetric), so transpose = reversed group order; inverse flips the sinh
    sign (each factor has det 1: F_g^{-1} = c - s * swap).
    """
    if not checkerboard:
        E = prop.expK_inv if inv else prop.expK
        if transpose:
            # free for the symmetric dense exponential; material for the
            # cb_dense product matrix (F0 F1 F2 F3 is NOT symmetric —
            # its transpose is the reversed product)
            E = jnp.swapaxes(E, -1, -2)
        return mm(E, X)
    # left-apply order for E = F0 F1 F2 F3: innermost factor first (F3).
    # E^T = F3 F2 F1 F0 and E^{-1} = F3' F2' F1' F0' both start with F0-ish,
    # E^{-T} starts with F3' again: reversed order iff transpose xor inv.
    ng = prop.cb_partner.shape[0]
    groups = list(range(ng))[::-1] if transpose == inv else list(range(ng))
    sgn = -1.0 if inv else 1.0
    out = X
    if inv:
        out = out / prop.cb_gamma[..., :, None]
    for g in groups:
        out = _cb_group_left(out, prop.cb_partner[g], prop.cb_cosh[g],
                             sgn * prop.cb_sinh[g])
    if not inv:
        out = prop.cb_gamma[..., :, None] * out
    return out


def kinetic_mult_right(prop: Propagators, X: jax.Array, *,
                       inv: bool = False, transpose: bool = False,
                       checkerboard: bool = False) -> jax.Array:
    """X @ E_K (or X @ E_K^{-1} / X @ E_K^T)."""
    if not checkerboard:
        E = prop.expK_inv if inv else prop.expK
        if transpose:
            E = jnp.swapaxes(E, -1, -2)
        return mm(X, E)
    # right-apply order: X E = X F0 F1 F2 F3 -> apply F0 first.
    ng = prop.cb_partner.shape[0]
    groups = list(range(ng))
    if transpose != inv:
        groups = list(range(ng))[::-1]
    sgn = -1.0 if inv else 1.0
    out = X
    if inv:
        out = out / prop.cb_gamma[..., None, :]
    for g in groups:
        out = _cb_group_right(out, prop.cb_partner[g], prop.cb_cosh[g],
                              sgn * prop.cb_sinh[g])
    if not inv:
        out = out * prop.cb_gamma[..., None, :]
    return out


# -- full B applies ---------------------------------------------------------
# B = diag(e) E_K; e is the exp-potential diagonal, batched (..., N).
#
# The potential factor sits LEFT of the kinetic one so that a flip at slice
# l is a left rank-1 perturbation of the chain A_l = B_l...B_1 B_m...B_{l+1}:
# then the textbook ratio R = 1 + delta (1 - G(l)_ii) and the
# Sherman-Morrison update of G(l) hold with G at slice l itself — the
# convention the sweep code and SURVEY.md §9 use.

def b_mult_left(prop, e, X, *, checkerboard=False):
    """B @ X = e * (E_K X)."""
    return e[..., :, None] * kinetic_mult_left(
        prop, X, checkerboard=checkerboard)


def b_inv_mult_left(prop, e, X, *, checkerboard=False):
    """B^{-1} @ X = E_K^{-1} ((1/e) * X)."""
    return kinetic_mult_left(prop, (1.0 / e)[..., :, None] * X, inv=True,
                             checkerboard=checkerboard)


def b_mult_right(prop, X, e, *, checkerboard=False):
    """X @ B = (X * e) E_K."""
    return kinetic_mult_right(prop, X * e[..., None, :],
                              checkerboard=checkerboard)


def b_inv_mult_right(prop, X, e, *, checkerboard=False):
    """X @ B^{-1} = (X E_K^{-1}) * (1/e)."""
    return kinetic_mult_right(prop, X, inv=True, checkerboard=checkerboard) \
        * (1.0 / e)[..., None, :]


def bT_mult_left(prop, e, X, *, checkerboard=False):
    """B^T @ X = E_K^T (e * X) — used to extend the transposed right stack."""
    return kinetic_mult_left(prop, e[..., :, None] * X, transpose=True,
                             checkerboard=checkerboard)
