"""Multiple-histogram (Ferrenberg-Swendsen) reweighting over a PT grid.

Reference parity: SURVEY.md §3 "mrpt family" and §4.5: combine the time
series of all parallel-tempering parameter values into continuous
estimates <O>(r) on an arbitrary grid, via the self-consistent
free-energy solve; locate Binder-cumulant crossings between system sizes
and susceptibility maxima; jackknifed errors by repeating the whole solve
per leave-one-block-out set.

Weight model: w_r(conf) = exp(-r * a(conf)) * (r-independent), where
``a`` is the exchange-conjugate action (for the SDW model a = dtau/2 *
sum phi^2 — derivable from the recorded phiSquared series and the run
metadata). Self-consistency (log-domain, MBAR/FS form):

    f_k = -log sum_s exp(-r_k a_s) / sum_j n_j exp(f_j - r_j a_s)

Reweighted averages: <O>(r) = sum_s O_s W_r(s) / sum_s W_r(s),
W_r(s) = exp(-r a_s) / sum_j n_j exp(f_j - r_j a_s).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def _logsumexp(x, axis=None):
    m = np.max(x, axis=axis, keepdims=True)
    out = m + np.log(np.sum(np.exp(x - m), axis=axis, keepdims=True))
    return np.squeeze(out, axis=axis) if axis is not None else out.ravel()[0]


@dataclasses.dataclass
class MultireweightPT:
    """Ferrenberg-Swendsen solver (reference: MultireweightHistosPT).

    The iteration and the weight evaluation run in the native OpenMP core
    (native/mrpt via analysis/_native — the reference's mrpt is OpenMP
    C++, SURVEY.md §3 "mrpt family") when a compiler/prebuilt library is
    available; the NumPy path below is the always-available fallback and
    the cross-check oracle (tests assert they agree).
    """

    r_values: np.ndarray                 # (R,)
    actions: List[np.ndarray]            # per-parameter a-series
    observables: Dict[str, List[np.ndarray]]  # name -> per-parameter series
    use_native: str = "auto"             # "auto" | "never"

    def __post_init__(self):
        self.r_values = np.asarray(self.r_values, np.float64)
        self.n_k = np.array([len(a) for a in self.actions])
        self.a_all = np.ascontiguousarray(
            np.concatenate(self.actions), np.float64)
        self.f = np.zeros(len(self.r_values))
        self._solved = False

    def _native(self):
        if self.use_native == "never":
            return None
        from detqmc.analysis import _native
        return _native

    def solve(self, tol: float = 1e-10, max_iter: int = 10000) -> None:
        """Self-consistent free energies (log-domain iteration)."""
        r = self.r_values
        a = self.a_all                                    # (S,)
        log_n = np.log(self.n_k)
        nat = self._native()
        if nat is not None:
            iters = nat.fs_solve(a, r, log_n.astype(np.float64), self.f,
                                 tol, max_iter)
            if iters is not None:
                self._solved = True
                return
        f = self.f
        for _ in range(max_iter):
            # log denominator per sample: logsumexp_j [log n_j + f_j - r_j a_s]
            z = log_n[None, :] + f[None, :] - np.outer(a, r)   # (S, R)
            log_den = _logsumexp(z, axis=1)                    # (S,)
            f_new = -np.array([
                _logsumexp(-rk * a - log_den) for rk in r])
            f_new -= f_new[0]
            if np.max(np.abs(f_new - f)) < tol:
                f = f_new
                break
            f = f_new
        self.f = f
        self._solved = True

    # -- reweighted expectations ------------------------------------------------
    def _log_weights(self, r_target: float) -> np.ndarray:
        if not self._solved:
            from detqmc.exceptions import GeneralError

            raise GeneralError(
                "MultireweightPT used before solve(): call solve() to "
                "fit the free-energy shifts before reweighting")
        nat = self._native()
        if nat is not None:
            lw = nat.fs_log_weights(self.a_all, self.r_values,
                                    np.log(self.n_k).astype(np.float64),
                                    self.f, r_target)
            if lw is not None:
                return lw
        z = (np.log(self.n_k)[None, :] + self.f[None, :]
             - np.outer(self.a_all, self.r_values))
        log_den = _logsumexp(z, axis=1)
        return -r_target * self.a_all - log_den

    def expectation(self, name: str, r_target: float) -> float:
        o = np.concatenate(self.observables[name])
        lw = self._log_weights(r_target)
        lw -= lw.max()
        w = np.exp(lw)
        return float(np.sum(w * o) / np.sum(w))

    def curve(self, name: str, r_grid: Sequence[float]) -> np.ndarray:
        nat = self._native()
        if nat is not None and self._solved:
            o = np.concatenate(self.observables[name])[None, :]
            out = nat.fs_curve(self.a_all, self.r_values,
                               np.log(self.n_k).astype(np.float64),
                               self.f, np.asarray(r_grid, np.float64), o)
            if out is not None:
                return out[:, 0]
        return np.array([self.expectation(name, r) for r in r_grid])

    def binder(self, r_target: float, phi2="phiSquared",
               phi4="phiFourth") -> float:
        """U = 1 - <phi^4> / (3 <phi^2>^2) reweighted to r_target."""
        p2 = self.expectation(phi2, r_target)
        p4 = self.expectation(phi4, r_target)
        return float(1.0 - p4 / (3.0 * p2 ** 2))

    def susceptibility_max(self, name: str, r_grid: Sequence[float]):
        vals = self.curve(name, r_grid)
        i = int(np.argmax(vals))
        return float(r_grid[i]), float(vals[i])


def find_binder_intersection(m1: MultireweightPT, m2: MultireweightPT,
                             r_lo: float, r_hi: float,
                             tol: float = 1e-8) -> Optional[float]:
    """Root of U_L1(r) - U_L2(r) by bisection (reference:
    findBinderIntersect)."""
    def g(r):
        return m1.binder(r) - m2.binder(r)

    glo, ghi = g(r_lo), g(r_hi)
    if glo * ghi > 0:
        return None
    for _ in range(200):
        mid = 0.5 * (r_lo + r_hi)
        gm = g(mid)
        if abs(gm) < tol or (r_hi - r_lo) < tol:
            return mid
        if glo * gm <= 0:
            r_hi, ghi = mid, gm
        else:
            r_lo, glo = mid, gm
    return 0.5 * (r_lo + r_hi)


def find_observable_maximum(m: MultireweightPT, name: str,
                            r_lo: float, r_hi: float,
                            tol: float = 1e-8):
    """Location and value of the maximum of the reweighted <O>(r) by
    golden-section search (reference: the mrpt family's susceptibility-
    maximum finders). Assumes <O>(r) is unimodal on [r_lo, r_hi]."""
    g = 0.5 * (np.sqrt(5.0) - 1.0)
    a, b = float(r_lo), float(r_hi)
    c, d = b - g * (b - a), a + g * (b - a)
    fc, fd = m.expectation(name, c), m.expectation(name, d)
    while (b - a) > tol:
        if fc > fd:
            b, d, fd = d, c, fc
            c = b - g * (b - a)
            fc = m.expectation(name, c)
        else:
            a, c, fc = c, d, fd
            d = a + g * (b - a)
            fd = m.expectation(name, d)
    r_star = 0.5 * (a + b)
    return r_star, float(m.expectation(name, r_star))


def _leave_one_out(actions, observables, b: int, n_blocks: int):
    """Leave-one-out block copies of a PT run's series (block b of
    n_blocks deleted from every parameter's series, jackknife
    convention)."""
    acts = []
    obs: Dict[str, List[np.ndarray]] = {k: [] for k in observables}
    for k_idx, a in enumerate(actions):
        nb = len(a) // n_blocks
        mask = np.ones(nb * n_blocks, bool)
        mask[b * nb:(b + 1) * nb] = False
        acts.append(a[:nb * n_blocks][mask])
        for name, series_list in observables.items():
            s = series_list[k_idx][:nb * n_blocks]
            obs[name].append(s[mask])
    return acts, obs


def jackknife_reweighted(
    r_values, actions, observables, estimator:
        Callable[[MultireweightPT], float], n_blocks: int = 10):
    """Jackknifed errors: the WHOLE FS solve repeats per leave-one-out
    block set (reference: mrpt-jk)."""
    full = MultireweightPT(np.asarray(r_values),
                           [a.copy() for a in actions],
                           {k: [s.copy() for s in v]
                            for k, v in observables.items()})
    full.solve()
    est_full = estimator(full)

    loo_vals = []
    for b in range(n_blocks):
        acts, obs = _leave_one_out(actions, observables, b, n_blocks)
        m = MultireweightPT(np.asarray(r_values), acts, obs)
        m.solve()
        loo_vals.append(estimator(m))
    loo = np.array(loo_vals)
    err = np.sqrt((n_blocks - 1) / n_blocks
                  * np.sum((loo - loo.mean()) ** 2))
    est = n_blocks * est_full - (n_blocks - 1) * loo.mean()
    return float(est), float(err)


def jackknife_intersection(run1, run2, r_lo: float, r_hi: float,
                           n_blocks: int = 10):
    """Jackknifed Binder-cumulant crossing between two PT runs (two
    system sizes): BOTH runs' FS solves repeat per leave-one-out block
    (reference: the jackknifed intersect finders). Each ``run`` is a
    ``(r_values, actions, observables)`` triple; observables must carry
    phiSquared and phiFourth. Returns (r*, err); raises if the full
    solve finds no crossing in [r_lo, r_hi]."""
    def solved(run, b=None):
        r_values, actions, observables = run
        if b is not None:
            actions, observables = _leave_one_out(actions, observables,
                                                  b, n_blocks)
        m = MultireweightPT(np.asarray(r_values), actions, observables)
        m.solve()
        return m

    full = find_binder_intersection(solved(run1), solved(run2),
                                    r_lo, r_hi)
    if full is None:
        raise ValueError(
            f"no Binder crossing in [{r_lo}, {r_hi}] for the full data")
    loo = []
    for b in range(n_blocks):
        x = find_binder_intersection(solved(run1, b), solved(run2, b),
                                     r_lo, r_hi)
        loo.append(full if x is None else x)
    loo = np.asarray(loo)
    err = np.sqrt((n_blocks - 1) / n_blocks
                  * np.sum((loo - loo.mean()) ** 2))
    est = n_blocks * full - (n_blocks - 1) * loo.mean()
    return float(est), float(err)
