"""BSS determinantal QMC for the repulsive Hubbard model in JAX.

Reference parity: SURVEY.md §3 row "Hubbard model" (DetHubbard:
Hirsch +-1 auxiliary field, alpha = acosh(e^{dtau U/2}), per-site Metropolis
with closed-form determinant ratio, Sherman-Morrison rank-1 Green updates,
two spin components) and §3 row "DQMC core" (sweep up/down with Green
wrapping and UdV-stack stabilization).

Design decisions (NOT a translation of the C++ loop nest):

- One walker's sweep is a nest of ``lax.scan``s: outer over stabilization
  intervals (consuming/emitting UdV stack entries as scan xs/ys), inner
  over the ``s`` slices of an interval, innermost over lattice sites. The
  whole sweep is a single XLA program.
- Both spin sectors ride a leading component axis (2, N, N) so every
  linear-algebra op is batched; independent walkers are ``vmap``-ed on top,
  turning the per-site rank-1 updates into large batched outer products and
  the wraps/QRs into large batched matmuls (SURVEY.md §3 parallelism
  table, "data parallelism" row).
- The right-moving stack stores the *conjugate-transposed* partial products
  so stack extension is always a left QR update (see linalg/udv.py).
- Between stabilizations, the pending B-block product is absorbed lazily
  into the stack factor's U (one B apply per slice, one QR per interval).

The "sweep" unit matches the reference: one full pass over all time slices
in one direction; the driver alternates directions (reference:
DetModelGC::sweep with lastSweepDir, SURVEY.md §4.1).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from detqmc import lattice as lattice_mod
from detqmc.linalg import bchain
from detqmc.linalg.udv import (
    UDV,
    green_from_two_udv,
    log_det_one_plus_udv,
    udv_refactor,
)
from detqmc.precision import mm

SPIN_SIGN = np.array([+1.0, -1.0])  # component axis: [up, down]
UPDATE_KERNELS = ("auto", "scan", "triton")


@dataclasses.dataclass(frozen=True)
class HubbardConfig:
    """Static simulation parameters (reference: ModelParams<DetHubbard> +
    DetQMCParams core numerics, SURVEY.md §3 "Config/flag system").

    Exactly two of (beta, m, dtau) must be consistent: we take (beta, m)
    and derive dtau = beta / m, mirroring the reference's two-of-three rule.
    """

    L: int = 4
    d: int = 2                  # lattice dimension (L^d periodic)
    t: float = 1.0
    U: float = 4.0
    mu: float = 0.0
    beta: float = 4.0
    m: int = 40                 # imaginary-time slices
    s: int = 8                  # stabilization interval (slices per UdV)
    checkerboard: bool = False
    # checkerboard apply mode: "sparse" = literal sequential bond-group
    # gather+axpy passes (the reference's O(N) apply); "dense"/"auto" =
    # precompute the EXACT product matrix of the breakup once and apply
    # it as one matmul (same factorized physics)
    cb_apply: str = "auto"
    delay: int = 0              # 0 = plain rank-1 SM updates; k>0 = delayed
    # particle-hole symmetry at half filling (mu = 0): the down sector is
    # exactly G_dn = eta (1 - G_up^T) eta and R_dn = e^{2 alpha s} R_up, so
    # only ONE spin sector is simulated — halving every matrix operation.
    # "auto": on iff mu == 0; "on"/"off" force.
    ph_symmetry: str = "auto"
    # site-update path: "scan" = the lax.scan loop over sites (or the
    # delayed rank-k loop when delay > 0); "triton" = the fused Pallas
    # slice kernel for the GPU (linalg/slice_update_triton: float32,
    # delay == 0, N <= its MAX_N); "auto" = the kernel on a GPU where it
    # applies (measured on an H100 at L=8 beta=8, 256 walkers: 492 vs
    # 464 sweeps/s for the scan, PERF.md), else the scan
    update_kernel: str = "auto"
    dtype: str = "float32"
    # precision island for the stabilized G recompute; "auto" = float64
    # when dtype is float32 (the inner matrix's condition ~ e^{beta W}
    # exceeds fp32 past beta ~ 4; see linalg/udv.green_from_two_udv)
    stab_dtype: str = "auto"
    # staggered bias on the Hirsch auxiliary field: adds -h * sum_{l,i}
    # eta_i s_{l,i} (eta = (-1)^{sum coords}) to the bosonic action.
    # h = 0 is the physical Hubbard model; h != 0 biases the HS spins
    # toward the AF pattern. Its purpose is PARALLEL TEMPERING: h is
    # linear in the action (exchange-conjugate a = -sum eta s), so an
    # h-grid tempers Hubbard with determinant-free swaps — the second
    # worked PT control parameter next to SDW's r (reference: detqmcpt
    # tempers a model-declared scalar the same way; SURVEY.md §1/§3
    # "Parallel tempering"). Carried traced in WalkerState.h so PT can
    # relabel replicas without recompiling.
    stagger_h: float = 0.0

    def __post_init__(self):
        if self.m % self.s != 0:
            raise ValueError(f"m={self.m} must be divisible by s={self.s}")
        if self.d not in (1, 2, 3):
            raise ValueError(f"d must be 1, 2 or 3, got {self.d}")
        if self.checkerboard and self.L % 2 != 0:
            raise ValueError("checkerboard requires even L")
        if self.delay < 0:
            raise ValueError("delay must be >= 0")
        if self.cb_apply not in ("auto", "dense", "sparse"):
            raise ValueError("cb_apply must be auto|dense|sparse, got "
                             f"{self.cb_apply!r}")
        if self.update_kernel not in UPDATE_KERNELS:
            raise ValueError("update_kernel must be one of "
                             f"{'|'.join(UPDATE_KERNELS)}, got "
                             f"{self.update_kernel!r}")

    @property
    def dtau(self) -> float:
        return self.beta / self.m

    @property
    def n_sites(self) -> int:
        return self.L ** self.d

    @property
    def n_stack(self) -> int:
        return self.m // self.s

    @property
    def alpha(self) -> float:
        return float(np.arccosh(np.exp(self.dtau * self.U / 2.0)))

    @property
    def ph_on(self) -> bool:
        if self.ph_symmetry == "auto":
            return self.mu == 0.0
        if self.ph_symmetry in ("on", "off"):
            return self.ph_symmetry == "on"
        raise ValueError(f"bad ph_symmetry {self.ph_symmetry!r}")

    @property
    def ncomp(self) -> int:
        return 1 if self.ph_on else 2

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    @property
    def stab_jdtype(self):
        if self.stab_dtype == "auto":
            return jnp.dtype("float64") if self.dtype == "float32" \
                else jnp.dtype(self.dtype)
        return jnp.dtype(self.stab_dtype)


class Stack(NamedTuple):
    """UdV stack storage: entry k factors either B_{ks}..B_1 (left, after an
    up sweep) or (B_m..B_{ks+1})^T (right, after a down sweep / init)."""

    U: jax.Array  # (K+1, 2, N, N)
    d: jax.Array  # (K+1, 2, N)
    V: jax.Array  # (K+1, 2, N, N)

    def entry(self, k) -> UDV:
        return UDV(self.U[k], self.d[k], self.V[k])


class WalkerState(NamedTuple):
    """Per-walker device state (leading walker axis added by vmap)."""

    field: jax.Array       # (m, N) +-1 Hirsch spins, run dtype
    G: jax.Array           # (2, N, N) equal-time Green at the sweep edge
    stack: Stack
    key: jax.Array         # PRNG key
    sign: jax.Array        # exact weight sign, tracked via ratio signs
    next_dir: jax.Array    # int32: 0 = next sweep goes up, 1 = down
    sweeps_done: jax.Array  # int32 counter (for checkpoint/resume parity)
    green_dev: jax.Array   # f32: max |G_wrapped - G_stabilized| last sweep
    sv_min: jax.Array      # f32: log10 smallest stack scale seen last sweep
    sv_max: jax.Array      # f32
    h: jax.Array           # staggered HS-bias (PT control parameter;
    #                        cfg.stagger_h outside tempering)


class Observables(NamedTuple):
    """Per-measurement observable values (reference set, SURVEY.md §3
    "Hubbard model" observables).

    All Wick-contracted quantities are SIGN-WEIGHTED (O * sign): away from
    half filling the physical estimate is <O s>/<s>, and the weighting must
    pair O with the sign at the same measurement instant. At half filling
    sign == 1 and the weighting is a no-op."""

    occupancy: jax.Array
    doubleOccupancy: jax.Array
    kineticEnergy: jax.Array
    potentialEnergy: jax.Array
    totalEnergy: jax.Array
    sign: jax.Array
    spinCorrelation: jax.Array      # (N,) <S^z_0 S^z_r> translation-averaged
    spinStructureFactorAF: jax.Array  # S(pi, pi)
    acceptance: jax.Array


class HubbardModel:
    """Factory binding static config + device constants to jitted kernels.

    ``vector_observables`` declares which observable names are vectors
    (drivers register them so the handler never guesses from names).

    Not a translation of the reference's DetHubbard class: methods are pure
    functions over WalkerState pytrees; `self` only holds trace-time
    constants.
    """

    vector_observables = ("spinCorrelation", "greenKTauVector",
                          "currentCorrelatorVector")

    def __init__(self, cfg: HubbardConfig):
        self.cfg = cfg
        self.lat = (lattice_mod.SquareLattice(cfg.L) if cfg.d == 2 else
                    lattice_mod.HyperCubicLattice(cfg.L, cfg.d))
        from detqmc.precision import ensure_runtime

        ensure_runtime(need_x64=cfg.stab_jdtype == jnp.dtype("float64"))
        dt = cfg.jdtype
        self.cb_sparse = cfg.checkerboard and cfg.cb_apply == "sparse"
        self.prop = bchain.make_propagators(
            self.lat, cfg.t, cfg.dtau, cfg.mu, dtype=dt,
            checkerboard=cfg.checkerboard,
            cb_dense=cfg.checkerboard and not self.cb_sparse)
        self.K_mat = jnp.asarray(self.lat.hopping_matrix(cfg.t), dt)
        if cfg.ph_on and cfg.mu != 0.0:
            raise ValueError("ph_symmetry='on' requires mu == 0")
        self.ncomp = cfg.ncomp
        self.spin_sign = jnp.asarray(SPIN_SIGN[:self.ncomp], dt)
        # displacement table for translation-averaged correlations:
        # disp_idx[d, i] = site index of (r_i + r_d)
        N = cfg.n_sites
        s_ = np.arange(N)
        c_ = self.lat.coords(s_)
        self.disp_idx = jnp.asarray(
            self.lat.site_of(c_[None, :, :] + c_[:, None, :]), jnp.int32)
        # (-1)^(sum of coords) staggering for the AF structure factor
        self.stagger = jnp.asarray(self.lat.stagger(), dt)
        # d_{x2-y2} pair form factor as a dense (N, N) matrix (+1 for x
        # neighbors, -1 for y): pair_susceptibilities applies it as
        # matmuls. 2-D lattices only.
        if cfg.d == 2:
            nbr = self.lat.neighbors()          # (N, 4): +x, -x, +y, -y
            Dmat = np.zeros((N, N))
            np.add.at(Dmat, (s_, nbr[:, 0]), 1.0)
            np.add.at(Dmat, (s_, nbr[:, 1]), 1.0)
            np.add.at(Dmat, (s_, nbr[:, 2]), -1.0)
            np.add.at(Dmat, (s_, nbr[:, 3]), -1.0)
            self._dwave_D = jnp.asarray(Dmat, dt)
            # cos/sin Fourier matrices + smallest-momentum indices for
            # the current correlator (real arithmetic only) and the
            # longitudinal/transverse superfluid-stiffness limits
            kg = self.lat.k_grid()                        # (N, 2)
            rg = c_.astype(np.float64)
            self._four_cos = jnp.asarray(np.cos(kg @ rg.T), dt)
            self._four_sin = jnp.asarray(np.sin(kg @ rg.T), dt)
            q1 = 2.0 * np.pi / cfg.L
            self._q_long_idx = int(np.argmin(
                np.abs(kg - np.asarray([q1, 0.0])).sum(axis=1)))
            self._q_trans_idx = int(np.argmin(
                np.abs(kg - np.asarray([0.0, q1])).sum(axis=1)))
        else:
            self._dwave_D = None
        # site-update path (see HubbardConfig.update_kernel)
        from detqmc.linalg import slice_update_triton as sut

        kernel_ok = (dt == jnp.dtype("float32") and cfg.delay == 0
                     and N <= sut.MAX_N)
        if cfg.update_kernel == "triton" and not kernel_ok:
            raise ValueError(
                "update_kernel='triton' needs dtype=float32, delay=0 and "
                f"n_sites <= {sut.MAX_N} (got dtype={cfg.dtype}, "
                f"delay={cfg.delay}, n_sites={N})")
        self._use_kernel = cfg.update_kernel == "triton" or (
            cfg.update_kernel == "auto" and kernel_ok
            and jax.default_backend() == "gpu")
        self._jit_cache = {}

    def _green(self, left: UDV, right_t: UDV) -> jax.Array:
        """Stabilized G from factored halves in the precision island."""
        return green_from_two_udv(
            left, right_t, compute_dtype=self.cfg.stab_jdtype
        ).astype(self.cfg.jdtype)

    def _eye_mixed(self):
        """Identity UdV with U in run dtype and d/V in the stab island
        dtype (the stack layout: U carries no scale, d/V carry the chain's
        dynamic range — see linalg.udv.udv_refactor)."""
        N, dt, sdt = self.cfg.n_sites, self.cfg.jdtype, self.cfg.stab_jdtype
        C = self.ncomp
        eye_dt = jnp.broadcast_to(jnp.eye(N, dtype=dt), (C, N, N))
        eye_sdt = jnp.broadcast_to(jnp.eye(N, dtype=sdt), (C, N, N))
        d = jnp.ones((C, N), jnp.finfo(sdt).dtype)
        return UDV(eye_dt, d, eye_sdt)

    # -- potential diagonals ------------------------------------------------
    def exp_v(self, field_slice: jax.Array) -> jax.Array:
        """e_l = exp(spin * alpha * s_l): (ncomp, N) from (N,)."""
        return jnp.exp(self.spin_sign[:, None] * self.cfg.alpha
                       * field_slice[None, :])

    # -- site updates (the sequential Metropolis inner loop) ----------------
    def _update_slice(self, G, field_l, u01, sign):
        """Sequential single-site Metropolis with Sherman-Morrison rank-1
        updates (reference: DetHubbard::updateInSlice, SURVEY.md §9
        "Hubbard HS"). G: (2,N,N); field_l, u01: (N,). The exact weight sign
        is threaded through accepted ratio signs (a slogdet of the
        ill-conditioned G would be unreliable in fp32)."""
        alpha = self.cfg.alpha
        ss = self.spin_sign

        def site_step(carry, i):
            G, field_l, sign = carry
            s_i = field_l[i]
            delta = jnp.exp(-2.0 * ss * alpha * s_i) - 1.0        # (2,)
            Gii = G[:, i, i]
            R = 1.0 + delta * (1.0 - Gii)                     # (ncomp,)
            if self.cfg.ph_on:
                # R_dn = e^{2 alpha s} R_up = R_up / (1 + delta_up)
                Rtot = R[0] * R[0] / (1.0 + delta[0])
            else:
                Rtot = R[0] * R[1]
            accept = u01[i] < jnp.abs(Rtot)
            coef = jnp.where(accept, delta / R, 0.0)               # (2,)
            u = G[:, :, i]                                         # (2, N)
            w = -G[:, i, :]
            w = w.at[:, i].add(1.0)                                # e_i - G_i.
            G = G - coef[:, None, None] * u[:, :, None] * w[:, None, :]
            field_l = field_l.at[i].set(jnp.where(accept, -s_i, s_i))
            sign = jnp.where(accept, sign * jnp.sign(Rtot), sign)
            return (G, field_l, sign), accept

        (G, field_l, sign), acc = jax.lax.scan(
            site_step, (G, field_l, sign), jnp.arange(self.cfg.n_sites))
        return G, field_l, sign, acc.mean(dtype=self.cfg.jdtype)

    def _update_slice_delayed(self, G, field_l, u01, sign):
        """Delayed (block rank-k) update: accumulate accepted rank-1 updates
        in (N,k) buffers; reconstruct needed rows/columns on the fly; flush
        with one batched matmul per block (reference: updateMethod=delayed,
        SURVEY.md §3 "SDW model" — the reference applies it to SDW; it is
        offered for Hubbard too: each flush is one batched GEMM)."""
        cfg = self.cfg
        N, kd = cfg.n_sites, cfg.delay
        alpha, ss = cfg.alpha, self.spin_sign
        n_blocks = -(-N // kd)
        pad = n_blocks * kd - N
        # process sites in blocks of kd; pad tail with "site N-1 repeated,
        # forced-reject" slots
        site_ids = jnp.concatenate(
            [jnp.arange(N), jnp.full((pad,), N - 1, jnp.int32)])
        u01p = jnp.concatenate([u01, jnp.full((pad,), jnp.inf, u01.dtype)])
        # u01 = +inf never accepts (weights are finite), so pad slots are
        # inert even when a repeat-flip ratio would exceed any finite bound

        def block_step(carry, b):
            G, field_l, sign = carry
            Ubuf = jnp.zeros((self.ncomp, N, kd), G.dtype)
            Wbuf = jnp.zeros((self.ncomp, kd, N), G.dtype)

            def site_step(c, j):
                G, field_l, Ubuf, Wbuf, sign = c
                i = site_ids[b * kd + j]
                s_i = field_l[i]
                # effective row/col i of G including pending updates
                g_col = G[:, :, i] + jnp.einsum(
                    "cnk,ck->cn", Ubuf, Wbuf[:, :, i])
                g_row = G[:, i, :] + jnp.einsum(
                    "ck,ckn->cn", Ubuf[:, i, :], Wbuf)
                g_ii = g_col[:, i]  # == g_row[:, i]
                delta = jnp.exp(-2.0 * ss * alpha * s_i) - 1.0
                R = 1.0 + delta * (1.0 - g_ii)
                if self.cfg.ph_on:
                    Rtot = R[0] * R[0] / (1.0 + delta[0])
                else:
                    Rtot = R[0] * R[1]
                accept = u01p[b * kd + j] < jnp.abs(Rtot)
                coef = jnp.where(accept, -delta / R, 0.0)
                w = -g_row
                w = w.at[:, i].add(1.0)
                Ubuf = Ubuf.at[:, :, j].set(coef[:, None] * g_col)
                Wbuf = Wbuf.at[:, j, :].set(
                    jnp.where(accept, w, jnp.zeros_like(w)))
                field_l = field_l.at[i].set(jnp.where(accept, -s_i, s_i))
                sign = jnp.where(accept, sign * jnp.sign(Rtot), sign)
                return (G, field_l, Ubuf, Wbuf, sign), accept

            (G, field_l, Ubuf, Wbuf, sign), acc = jax.lax.scan(
                site_step, (G, field_l, Ubuf, Wbuf, sign), jnp.arange(kd))
            G = G + mm(Ubuf, Wbuf)  # flush: one batched (N,k)@(k,N) gemm
            return (G, field_l, sign), acc

        (G, field_l, sign), acc = jax.lax.scan(
            block_step, (G, field_l, sign), jnp.arange(n_blocks))
        acc_real = acc.reshape(-1)[:N]  # drop inert pad slots
        return G, field_l, sign, acc_real.mean(dtype=self.cfg.jdtype)

    def update_slice(self, G, field_l, u01, sign=None):
        if sign is None:
            sign = jnp.ones((), self.cfg.jdtype)
        if self._use_kernel:
            from detqmc.linalg import slice_update_triton

            return slice_update_triton.slice_update(
                G, field_l, u01, sign, alpha=self.cfg.alpha,
                ph_on=self.cfg.ph_on)
        if self.cfg.delay > 0:
            return self._update_slice_delayed(G, field_l, u01, sign)
        return self._update_slice(G, field_l, u01, sign)

    # -- wraps ----------------------------------------------------------------
    def wrap_up(self, G, e):
        """G(l) = B_l G(l-1) B_l^{-1}."""
        cb = self.cb_sparse
        return bchain.b_mult_left(
            self.prop, e,
            bchain.b_inv_mult_right(self.prop, G, e, checkerboard=cb),
            checkerboard=cb)

    def wrap_down(self, G, e):
        """G(l-1) = B_l^{-1} G(l) B_l."""
        cb = self.cb_sparse
        return bchain.b_inv_mult_left(
            self.prop, e,
            bchain.b_mult_right(self.prop, G, e, checkerboard=cb),
            checkerboard=cb)

    # -- measurements ----------------------------------------------------------
    def measure_equal_time(self, G: jax.Array, acc_rate,
                           sign=None) -> Observables:
        """Wick-contracted equal-time estimators from G (SURVEY.md §3
        "Hubbard model" observable list). `sign` is the exactly-tracked
        configuration weight sign (ratio-sign bookkeeping; a slogdet of the
        exponentially ill-conditioned G is not fp32-safe)."""
        cfg = self.cfg
        N = cfg.n_sites
        if sign is None:
            sign = jnp.ones((), G.dtype)
        Gu = G[0]
        if cfg.ph_on:
            eye_ = jnp.eye(N, dtype=G.dtype)
            st_ = self.stagger
            Gd = st_[:, None] * (eye_ - Gu.T) * st_[None, :]
        else:
            Gd = G[1]
        nu = 1.0 - jnp.diagonal(Gu)
        nd = 1.0 - jnp.diagonal(Gd)
        occ = (nu + nd).mean()
        docc = (nu * nd).mean()
        e_kin = -(jnp.sum(self.K_mat.T * Gu) + jnp.sum(self.K_mat.T * Gd)) / N
        e_pot = cfg.U * jnp.mean(nu * nd - 0.5 * (nu + nd) + 0.25)
        # <S^z_i S^z_j> Wick contraction
        eye = jnp.eye(N, dtype=G.dtype)
        mz = nu - nd
        corr = 0.25 * (jnp.outer(mz, mz)
                       + (eye - Gu.T) * Gu + (eye - Gd.T) * Gd)
        # translation average: c(d) = mean_i corr[i, i + d]
        rows = jnp.arange(N)[None, :]
        c_of_d = corr[rows, self.disp_idx].mean(axis=1)
        s_af = self.stagger @ mm(corr, self.stagger[:, None])[:, 0] / N
        return Observables(
            occupancy=occ * sign,
            doubleOccupancy=docc * sign,
            kineticEnergy=e_kin * sign,
            potentialEnergy=e_pot * sign,
            totalEnergy=(e_kin + e_pot) * sign,
            sign=sign,
            spinCorrelation=c_of_d * sign,
            spinStructureFactorAF=s_af * sign,
            acceptance=acc_rate,
        )

    # -- sweeps -----------------------------------------------------------------
    def _sweep(self, state: WalkerState, up: bool, measure: bool):
        """One full pass over all time slices (up: l=1..m, down: l=m..1),
        consuming the opposite-direction UdV stack and emitting this
        direction's (reference: sweepUp/sweepDown + advanceUp/DownGreen,
        SURVEY.md §4.1)."""
        cfg = self.cfg
        K, s_int, N = cfg.n_stack, cfg.s, cfg.n_sites
        dt = cfg.jdtype
        sdt = cfg.stab_jdtype  # stack/stabilization precision island
        cb = self.cb_sparse

        field, G, stack, key = state.field, state.G, state.stack, state.key
        sign = state.sign
        key, sweep_key = jax.random.split(key)
        # one uniform vector per slice, drawn up front: (m, N)
        u01 = jax.random.uniform(sweep_key, (cfg.m, N), dtype=dt)
        # staggered HS-bias (cfg.stagger_h / PT control parameter): the
        # flip of s_{l,i} changes the bosonic action by 2 h eta_i s_{l,i},
        # i.e. accept iff u < |R_fermion| e^{-2 h eta s}. Each site is
        # visited exactly once per slice pass with its field value still
        # equal to the sweep-start value, so the bias folds EXACTLY into
        # a pre-scaling of the uniform draws — the update kernels never
        # see h. At h = 0 the scale is exp(0) = 1.0 and u01 * 1.0 is
        # bit-identical, so untempered runs are unchanged.
        u01 = u01 * jnp.exp((2.0 * state.h) * self.stagger[None, :] * field)

        eye_f = self._eye_mixed()

        def interval(carry, xs):
            G, lazy_U, d_c, V_c, field, sign, dev, acc_sum, obs_sum = carry
            k, stack_entry = xs  # consumed opposite stack entry

            def slice_step(c, l_rel):
                G, lazy_U, field, sign, acc_sum = c
                l = (k - 1) * s_int + 1 + l_rel if up else k * s_int - l_rel
                fl = field[l - 1]
                if up:
                    e_old = self.exp_v(fl)
                    G = self.wrap_up(G, e_old)
                G, fl_new, sign, acc = self.update_slice(
                    G, fl, u01[l - 1], sign)
                field = field.at[l - 1].set(fl_new)
                e_new = self.exp_v(fl_new)
                if up:
                    lazy_U = bchain.b_mult_left(self.prop, e_new, lazy_U,
                                                checkerboard=cb)
                else:
                    lazy_U = bchain.bT_mult_left(self.prop, e_new, lazy_U,
                                                 checkerboard=cb)
                    G = self.wrap_down(G, e_new)
                return (G, lazy_U, field, sign, acc_sum + acc), None

            (G, lazy_U, field, sign, acc_sum), _ = jax.lax.scan(
                slice_step, (G, lazy_U, field, sign, acc_sum),
                jnp.arange(s_int))

            # re-orthogonalize: factor (B-block @ U) diag(d) V (scaled QR).
            # lazy_U absorbed B's in run dtype (cond per interval is small);
            # the QR + composition + stored stack live in the precision
            # island so full-chain scales keep their relative accuracy.
            f_new = udv_refactor(lazy_U, d_c, V_c, compose_dtype=sdt)
            other = UDV(*stack_entry)
            if up:
                G_stab = self._green(f_new, other)
            else:
                G_stab = self._green(other, f_new)
            dev = jnp.maximum(dev, jnp.abs(G - G_stab).max())
            G = G_stab
            if measure:
                obs = self.measure_equal_time(G, jnp.zeros((), dt), sign)
                obs_sum = jax.tree.map(jnp.add, obs_sum, obs)
            carry = (G, f_new.U, f_new.d, f_new.V, field, sign,
                     dev, acc_sum, obs_sum)
            return carry, f_new

        ks = jnp.arange(1, K + 1) if up else jnp.arange(K, 0, -1)
        # consumed entries: up uses right entries k (k=1..K); down uses left
        # entries k-1 (k=K..1)
        consumed_idx = ks if up else ks - 1
        consumed = jax.tree.map(lambda a: a[consumed_idx], stack)

        zero_obs = jax.tree.map(
            lambda a: jnp.zeros_like(a),
            self.measure_equal_time(G, jnp.zeros((), dt)))
        dev0 = jnp.zeros((), dt)
        carry0 = (G, eye_f.U, eye_f.d, eye_f.V, field, sign, dev0,
                  jnp.zeros((), dt), zero_obs)
        (G, _, _, _, field, sign, dev, acc_sum, obs_sum), emitted = \
            jax.lax.scan(interval, carry0, (ks, tuple(consumed)))

        # assemble the new stack by concatenation (no scatter into the
        # (K+1, 2, N, N) storage)
        def assemble(entries, eye_leaf):
            if up:  # emitted positions 1..K in scan order
                return jnp.concatenate([eye_leaf[None], entries], axis=0)
            # down: emitted positions K-1..0 in scan order
            return jnp.concatenate([jnp.flip(entries, axis=0),
                                    eye_leaf[None]], axis=0)
        newU = assemble(emitted.U, eye_f.U.astype(emitted.U.dtype))
        newd = assemble(emitted.d, eye_f.d)
        newV = assemble(emitted.V, eye_f.V)

        sv_max, sv_min = (jnp.log10(jnp.maximum(emitted.d, 1e-38)).max(),
                          jnp.log10(jnp.maximum(emitted.d, 1e-38)).min())
        new_state = WalkerState(
            field=field, G=G,
            stack=Stack(newU, newd, newV),
            key=key,
            sign=sign,
            next_dir=jnp.asarray(1 if up else 0, jnp.int32),
            sweeps_done=state.sweeps_done + 1,
            green_dev=dev.astype(jnp.float32),
            sv_min=sv_min.astype(jnp.float32),
            sv_max=sv_max.astype(jnp.float32),
            h=state.h,
        )
        n_meas = jnp.asarray(K, dt)
        obs_mean = jax.tree.map(lambda a: a / n_meas, obs_sum)
        # acceptance is a whole-sweep average (per-slice rates summed over m)
        obs_mean = obs_mean._replace(
            acceptance=acc_sum / jnp.asarray(cfg.m, dt))
        return new_state, obs_mean

    def sweep_up(self, state, measure=False):
        return self._sweep(state, up=True, measure=measure)

    def sweep_down(self, state, measure=False):
        return self._sweep(state, up=False, measure=measure)

    def sweep_pair(self, state: WalkerState, measure: bool):
        """Up+down pair = 2 reference sweeps; measurements averaged.

        Up first: init_state / refresh_from_field leave a *right* stack
        (next_dir = up), and after the down sweep the stack is right-handed
        again — so pairs compose with init and with checkpoint restore.
        """
        state, obs1 = self._sweep(state, up=True, measure=measure)
        state, obs2 = self._sweep(state, up=False, measure=measure)
        obs = jax.tree.map(lambda a, b: 0.5 * (a + b), obs1, obs2)
        return state, obs

    # -- parallel tempering hooks -------------------------------------------
    # Hubbard tempers the staggered HS-bias h (cfg.stagger_h): linear in
    # the bosonic action, so swaps exchange labels with NO determinant
    # re-evaluation — the same protocol as SDW's r (SURVEY.md §1/§3
    # "Parallel tempering"; reference: detqmcpt.h's model-declared
    # exchange parameter). h = 0 replicas sample the physical model;
    # the graded-h ladder mixes AF-ordered HS configurations down into
    # the physical ensemble.
    control_parameter = "stagger_h"

    def exchange_action(self, state: WalkerState) -> jax.Array:
        """The h-conjugate action piece a = dS/dh = -sum_{l,i} eta_i
        s_{l,i} (weight = e^{-h a}; see _sweep's u01 bias note)."""
        return -jnp.sum(self.stagger[None, :] * state.field)

    def with_r(self, state: WalkerState, h) -> WalkerState:
        """PT relabel hook (name shared with SDW's with_r: the driver is
        parameter-agnostic). h never touches the fermion determinant, so
        G/stacks stay valid across a swap."""
        return state._replace(h=jnp.asarray(h, self.cfg.jdtype))

    def _full_chain_t(self, field: jax.Array) -> UDV:
        """Full transposed B-chain (B_m...B_1)^T as a stabilized UdV
        factor, rebuilt from the field (the interval scan of
        refresh_from_field without the stack emission)."""
        cfg = self.cfg
        s_int, K, sdt = cfg.s, cfg.n_stack, cfg.stab_jdtype
        cb = self.cb_sparse

        def build_interval(f_carry, k):
            def absorb(lazy_U, l_rel):
                l = k * s_int - l_rel
                e = self.exp_v(field[l - 1])
                return bchain.bT_mult_left(self.prop, e, lazy_U,
                                           checkerboard=cb), None

            lazy_U, _ = jax.lax.scan(absorb, f_carry.U,
                                     jnp.arange(s_int))
            f_new = udv_refactor(lazy_U, f_carry.d, f_carry.V,
                                 compose_dtype=sdt)
            return f_new, None

        full_t, _ = jax.lax.scan(build_interval, self._eye_mixed(),
                                 jnp.arange(K, 0, -1))
        return full_t

    def log_weight(self, field: jax.Array, h=None) -> jax.Array:
        """log|w(s)| of a full HS configuration, up to an s-independent
        constant: sum_sigma log|det(1 + B_sigma-chain)| (+ the staggered
        bias term h * sum eta s when tempering h).

        Used by det-coupled parallel tempering (parallel/det_pt.py):
        tempering a determinant-coupled parameter (beta/dtau, U, mu)
        needs the fermionic weight at both grid values at swap time.
        Returns log|w|: in a sign-problem regime the chain samples |w|
        and folds the sign into observables, so |w| is the correct swap
        weight for the sampled distribution. ph mode uses the exact
        half-filling identity det M_up det M_dn = e^{-alpha sum s}
        (det M_up)^2 (see _chain_sign). det(1 + A^T) = det(1 + A).
        (Reference parity: SURVEY.md §9 swap weights; src/detqmcpt.h.)"""
        if h is None:
            h = self.cfg.stagger_h
        full_t = self._full_chain_t(field)
        lds, _ = log_det_one_plus_udv(UDV(
            full_t.U, full_t.d, full_t.V.astype(full_t.U.dtype)))
        if self.cfg.ph_on:
            ld = 2.0 * lds[0] - self.cfg.alpha * jnp.sum(field)
        else:
            ld = lds[0] + lds[1]
        stag = jnp.sum(self.stagger[None, :] * field)
        return ld + h * stag

    # -- naive cross-check sweep --------------------------------------------
    def green_at_slice(self, field: jax.Array, l: int) -> jax.Array:
        """Stabilized G(l) rebuilt from the field alone, refactoring at
        EVERY slice (s_eff = 1) — the naive recompute primitive behind
        sweep_simple (reference: DetModelGC::sweepSimple /
        greenFromEye_and_UdV, SURVEY.md §5 item 2). ``l`` is a static int
        in 0..m."""
        cfg = self.cfg
        sdt = cfg.stab_jdtype
        cb = self.cb_sparse
        left = self._eye_mixed()
        for j in range(1, l + 1):
            M = bchain.b_mult_left(self.prop, self.exp_v(field[j - 1]),
                                   left.U, checkerboard=cb)
            left = udv_refactor(M, left.d, left.V, compose_dtype=sdt)
        right = self._eye_mixed()
        for j in range(cfg.m, l, -1):
            M = bchain.bT_mult_left(self.prop, self.exp_v(field[j - 1]),
                                    right.U, checkerboard=cb)
            right = udv_refactor(M, right.d, right.V, compose_dtype=sdt)
        return self._green(left, right)

    def sweep_simple(self, state: WalkerState, measure: bool = False):
        """Intentionally naive up sweep: G(l) is recomputed from scratch at
        every slice, then the exact same per-site updates run on the same
        RNG stream as the stabilized sweep_up — so both paths walk the SAME
        Markov chain and any disagreement indicts the wrap/stack machinery
        (reference: DetModelGC::sweepSimple vs sweep, SURVEY.md §5 item 2).
        O(m^2) refactors: a correctness cross-check, not a production path.
        """
        cfg = self.cfg
        dt = cfg.jdtype
        field, sign = state.field, state.sign
        key, sweep_key = jax.random.split(state.key)
        u01 = jax.random.uniform(sweep_key, (cfg.m, cfg.n_sites), dtype=dt)
        acc_sum = jnp.zeros((), dt)
        obs_sum = jax.tree.map(
            lambda a: jnp.zeros_like(a),
            self.measure_equal_time(state.G, jnp.zeros((), dt)))
        for l in range(1, cfg.m + 1):
            G = self.green_at_slice(field, l)       # fresh, pre-update
            G, fl_new, sign, acc = self.update_slice(
                G, field[l - 1], u01[l - 1], sign)
            field = field.at[l - 1].set(fl_new)
            acc_sum = acc_sum + acc
            if measure and l % cfg.s == 0:
                obs = self.measure_equal_time(G, jnp.zeros((), dt), sign)
                obs_sum = jax.tree.map(jnp.add, obs_sum, obs)
        refreshed = self.refresh_from_field(
            state._replace(field=field, key=key))
        new_state = refreshed._replace(
            sign=sign,  # ratio-tracked sign wins (cf. driver resume)
            sweeps_done=state.sweeps_done + 1)
        obs_mean = jax.tree.map(
            lambda a: a / jnp.asarray(cfg.n_stack, dt), obs_sum)
        obs_mean = obs_mean._replace(
            acceptance=acc_sum / jnp.asarray(cfg.m, dt))
        return new_state, obs_mean

    # -- time-displaced Green functions ------------------------------------
    def _td_stacks(self, field: jax.Array):
        """Both half-chain UdV stacks for unequal-time evaluation:
        left entries k hold B(ks, 0), right entries k hold
        B(beta, ks)^H — built fresh from the field, (K+1)-batched."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        dt, sdt = cfg.jdtype, cfg.stab_jdtype
        cb = self.cb_sparse
        eye_f = self._eye_mixed()

        def build(transposed):
            def interval(f_carry, k):
                def absorb(lazy_U, l_rel):
                    l = k * s_int - l_rel if transposed \
                        else (k - 1) * s_int + 1 + l_rel
                    e = self.exp_v(field[l - 1])
                    if transposed:
                        out = bchain.bT_mult_left(self.prop, e, lazy_U,
                                                  checkerboard=cb)
                    else:
                        out = bchain.b_mult_left(self.prop, e, lazy_U,
                                                 checkerboard=cb)
                    return out, None

                lazy_U, _ = jax.lax.scan(absorb, f_carry.U.astype(dt),
                                         jnp.arange(s_int))
                f_new = udv_refactor(lazy_U, f_carry.d, f_carry.V,
                                     compose_dtype=sdt)
                return f_new, f_new

            ks = jnp.arange(K, 0, -1) if transposed else jnp.arange(1, K + 1)
            _, emitted = jax.lax.scan(interval, eye_f, ks)
            if transposed:  # positions K-1..0 emitted; identity at K
                U = jnp.concatenate([jnp.flip(emitted.U, 0),
                                     eye_f.U[None].astype(emitted.U.dtype)])
                d = jnp.concatenate([jnp.flip(emitted.d, 0), eye_f.d[None]])
                V = jnp.concatenate([jnp.flip(emitted.V, 0), eye_f.V[None]])
            else:           # positions 1..K; identity at 0
                U = jnp.concatenate([eye_f.U[None].astype(emitted.U.dtype),
                                     emitted.U])
                d = jnp.concatenate([eye_f.d[None], emitted.d])
                V = jnp.concatenate([eye_f.V[None], emitted.V])
            return UDV(U, d, V)

        return build(transposed=False), build(transposed=True)

    def _gtz(self):
        """The stable dense-RHS solver gtz(left, right_t) =
        [1 + A C]^{-1} A (A from left, C^H from right_t) in the precision
        island."""
        sdt = self.cfg.stab_jdtype
        from detqmc.linalg.udv import green_tau_zero

        return lambda l_, r_: green_tau_zero(l_, r_, compute_dtype=sdt)

    def time_displaced_greens(self, field: jax.Array) -> jax.Array:
        """G(tau=k*s, 0) for k = 0..K: (K+1, 2, N, N).

        Builds both half-chain stacks fresh from the field and evaluates
        all K+1 displaced Greens in one batched stable solve (reference:
        TimeDisplaced=true template path, SURVEY.md §3 "DQMC core"; here
        the tau-resolution is the stabilization grid)."""
        cfg = self.cfg
        left, right_t = self._td_stacks(field)
        gtz = self._gtz()
        G_up = gtz(left, right_t)
        if not cfg.ph_on:
            return G_up
        # particle-hole mode: the down sector is the exact per-configuration
        # image G_dn(tau, 0) = eta G_up(beta, tau)^T eta (eta = stagger;
        # from eta B_dn,l eta = B_up,l^{-T} at mu = 0). The transposed
        # G_up(beta, tau)^T = [1 + A'C']^{-1} A' = A'[1 + C'A']^{-1} with
        # A' = B(beta,tau)^T and C' = B(tau,0)^T, which for the real field
        # is green_tau_zero with the two stacks' roles SWAPPED — the right
        # stack already stores B(beta,tau)^T and the left one equals
        # C'^H = B(tau,0).
        G_bt = gtz(right_t, left)
        eta = self.stagger.astype(G_up.dtype)
        G_dn = eta[:, None] * G_bt * eta[None, :]
        return jnp.concatenate([G_up, G_dn], axis=1)      # (K+1, 2, N, N)

    def time_displaced_greens_all(self, field: jax.Array):
        """G(tau, 0) at EVERY slice tau = 0..m: (m+1, C, N, N), plus the
        max wrap deviation against the stabilized anchors.

        Reference: the TimeDisplaced=true path resolves all m slices by
        B-wrapping between stabilization points (SURVEY.md §3 "DQMC
        core", §9 "Unequal-time"): within interval k,
        G(ks+j, 0) = B_{ks+j} ... B_{ks+1} G(ks, 0); at each next anchor
        the freshly stabilized value replaces the wrapped one and their
        difference is monitored like green_dev."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        cb = self.cb_sparse
        anchors = self.time_displaced_greens(field)   # (K+1, C, N, N)
        e = jax.vmap(self.exp_v)(field)               # (m, ncomp, N)
        if cfg.ph_on:
            # wrap the reconstructed down sector with its own
            # B_dn = expK e^{-alpha s} (exact at mu = 0, cf. ph image)
            e = jnp.concatenate([e, 1.0 / e], axis=1)     # (m, 2, N)

        def interval(_, xs):
            g0, g_next, e_k = xs                      # e_k: (s, C, N)

            def wrap(G, j):
                G = bchain.b_mult_left(self.prop, e_k[j], G,
                                       checkerboard=cb)
                return G, G

            g_last, wrapped = jax.lax.scan(wrap, g0,
                                           jnp.arange(s_int - 1))
            g_end, _ = wrap(g_last, s_int - 1)
            dev = jnp.abs(g_end - g_next).max()
            out = jnp.concatenate([g0[None], wrapped], axis=0)  # (s, ...)
            return None, (out, dev)

        e_blocks = e.reshape((K, s_int) + e.shape[1:])
        _, (blocks, devs) = jax.lax.scan(
            interval, None, (anchors[:K], anchors[1:], e_blocks))
        G_all = jnp.concatenate(
            [blocks.reshape((K * s_int,) + anchors.shape[1:]),
             anchors[K][None]], axis=0)
        return G_all, devs.max()

    def unequal_time_greens_all(self, field: jax.Array):
        """G(tau,0), G(0,tau) and G(tau,tau) at EVERY slice, both spin
        sectors: three (m+1, 2, N, N) arrays + the max wrap deviation.

        The reverse propagator comes from the stable swapped-stack
        solve: with A = B(tau,0) (left stack) and C = B(beta,tau)
        (right stack), gtz(right_t, left) = [1 + C^H A^H]^{-1} C^H =
        [(1 + C A)^{-1} C]^H, so G(0,tau) = -(1+CA)^{-1}C =
        -gtz(right_t, left)^T for the real field. Equal-time anchors
        use the standard pair formula at each stabilization point. All
        three chains then wrap between anchors (G(0,tau+1) =
        G(0,tau) B^{-1}; G(tau+1,tau+1) = B G B^{-1}), each anchor
        mismatch monitored like green_dev. In ph mode the down sector
        is reconstructed exactly: G_dn(tau,0) = eta G_up(beta,tau)^T
        eta, G_dn(0,tau) = -eta G_up(tau,0)^T eta, G_dn(tau,tau) =
        eta (1 - G_up(tau,tau))^T eta (all from eta B_dn eta =
        B_up^{-T} at mu = 0).

        Reference: the TimeDisplaced=true path carries BOTH G(tau,0)
        and G(0,tau) forward/backward propagators (SURVEY.md §3 "DQMC
        core", §9 "Unequal-time")."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        cb = self.cb_sparse
        left, right_t = self._td_stacks(field)
        gtz = self._gtz()
        G_fwd = gtz(left, right_t)           # (K+1, C, N, N) = G_up(t,0)
        G_bwd = gtz(right_t, left)           # swapped roles
        Gtt_a = jax.vmap(self._green)(left, right_t)      # G(tau,tau)
        T = lambda M: jnp.swapaxes(M, -1, -2)  # noqa: E731
        if cfg.ph_on:
            eta = self.stagger.astype(G_fwd.dtype)
            sgn = eta[:, None] * eta[None, :]
            t0 = jnp.concatenate([G_fwd, sgn * G_bwd], axis=1)
            zt = jnp.concatenate([-T(G_bwd), -sgn * T(G_fwd)], axis=1)
            eyeN = jnp.eye(cfg.n_sites, dtype=Gtt_a.dtype)
            tt = jnp.concatenate([Gtt_a, sgn * (eyeN - T(Gtt_a))], axis=1)
        else:
            t0, zt, tt = G_fwd, -T(G_bwd), Gtt_a
        e = jax.vmap(self.exp_v)(field)
        if cfg.ph_on:
            e = jnp.concatenate([e, 1.0 / e], axis=1)

        def interval(_, xs):
            a0, an, b0, bn, c0, cn, e_k = xs

            def wrap(carry, j):
                a, b, c = carry
                a = bchain.b_mult_left(self.prop, e_k[j], a,
                                       checkerboard=cb)
                b = bchain.b_inv_mult_right(self.prop, b, e_k[j],
                                            checkerboard=cb)
                c = bchain.b_mult_left(self.prop, e_k[j], c,
                                       checkerboard=cb)
                c = bchain.b_inv_mult_right(self.prop, c, e_k[j],
                                            checkerboard=cb)
                return (a, b, c), (a, b, c)

            last, wrapped = jax.lax.scan(wrap, (a0, b0, c0),
                                         jnp.arange(s_int - 1))
            (a_e, b_e, c_e), _ = wrap(last, s_int - 1)
            dev = jnp.maximum(
                jnp.abs(a_e - an).max(),
                jnp.maximum(jnp.abs(b_e - bn).max(),
                            jnp.abs(c_e - cn).max()))
            outs = tuple(
                jnp.concatenate([g0[None], w], axis=0)
                for g0, w in zip((a0, b0, c0), wrapped))
            return None, (outs, dev)

        e_blocks = e.reshape((K, s_int) + e.shape[1:])
        _, ((blk_a, blk_b, blk_c), devs) = jax.lax.scan(
            interval, None, (t0[:K], t0[1:], zt[:K], zt[1:],
                             tt[:K], tt[1:], e_blocks))
        shape = (K * s_int,) + t0.shape[1:]
        cat = lambda blk, anc: jnp.concatenate(   # noqa: E731
            [blk.reshape(shape), anc[K][None]], axis=0)
        return cat(blk_a, t0), cat(blk_b, zt), cat(blk_c, tt), devs.max()

    def measure_current_correlators(self, state: WalkerState):
        """tau-integrated current-current correlator Lambda_xx(q, iw=0)
        over the full q grid, plus the superfluid-stiffness estimator
        rho_s = [Lambda_L - Lambda_T] / 4 from the smallest longitudinal
        (qx = 2pi/L, qy = 0) and transverse (qx = 0, qy = 2pi/L) momenta
        (Scalapino-White-Zhang). Wick at fixed field with all three
        unequal-time chains; with j_x(i) = i t sum_sigma
        (c+_{i+x} c_i - c+_i c_{i+x}) every contraction is an
        elementwise product of +x-shifted G matrices:

            <j_x(i,tau) j_x(j,0)> = -t^2 [ u(tau)_i u(0)_j
                - sum_sigma ((PX)(YP^T) - (PXP^T)Y - X(PYP^T)
                             + (XP^T)(PY))_ij ]

        with X = G(0,tau)^T, Y = G(tau,0), P the +x shift, and
        u(tau)_i = sum_sigma [G(tau,tau)_{i,i+x} - G(tau,tau)_{i+x,i}]
        the per-configuration bond current. Reference observable class:
        current correlators (SURVEY.md §1 "pairing and current
        correlators"). Returns (lambda_q (N,), rho_s, wrap_dev). 2-D
        lattices only."""
        cfg = self.cfg
        if cfg.d != 2:
            raise ValueError("current correlators are implemented for "
                             "d = 2 lattices")
        t0, zt, tt, dev = self.unequal_time_greens_all(state.field)
        N = cfg.n_sites
        px = jnp.asarray(self.lat.neighbors()[:, 0], jnp.int32)  # i -> i+x
        ar = jnp.arange(N)

        u_tau = ((tt[:, :, ar, px] - tt[:, :, px, ar])
                 .sum(axis=1))                           # (m+1, N)
        X = jnp.swapaxes(zt, -1, -2)                     # G(0,t)^T
        Y = t0
        PX, XP = X[..., px, :], X[..., :, px]
        PY, YP = Y[..., px, :], Y[..., :, px]
        PXP = PX[..., :, px]
        PYP = PY[..., :, px]
        conn = (PX * YP - PXP * Y - X * PYP + XP * PY).sum(axis=1)
        w = jnp.full((cfg.m + 1,), cfg.dtau, conn.dtype)
        w = w.at[0].mul(0.5).at[-1].mul(0.5)             # trapezoid
        lam_mat = -(cfg.t ** 2) * (
            jnp.einsum("t,ti,j->ij", w, u_tau, u_tau[0])
            - jnp.einsum("t,tij->ij", w, conn))
        Fc, Fs = self._four_cos, self._four_sin
        lam_q = (jnp.einsum("qi,ij,qj->q", Fc, lam_mat, Fc,
                            precision="highest")
                 + jnp.einsum("qi,ij,qj->q", Fs, lam_mat, Fs,
                              precision="highest")) / N
        rho_s = 0.25 * (lam_q[self._q_long_idx] - lam_q[self._q_trans_idx])
        return lam_q, rho_s, dev

    def measure_time_displaced(self, state: WalkerState,
                               per_slice: bool = False,
                               susceptibilities: bool = False):
        """Momentum-diagonal G(k, tau), spin-averaged over BOTH sectors
        (in ph mode the down sector is reconstructed exactly — reference
        observable: time-displaced Green). tau on the stabilization grid
        ((K+1, N)) or, with ``per_slice``, at every slice ((m+1, N),
        returned with the wrap-deviation monitor).

        ``susceptibilities`` (needs ``per_slice``) additionally returns
        the tau-integrated s- and d-wave pairing susceptibilities
        computed from the same per-slice G(tau, 0)."""
        if per_slice:
            G_tau, dev = self.time_displaced_greens_all(state.field)
        else:
            G_tau = self.time_displaced_greens(state.field)
        F = jnp.asarray(self.lat.fourier_phases())
        gk = jnp.einsum("kn,tcnm,mk->tck", F, G_tau.astype(jnp.complex64)
                        if G_tau.dtype == jnp.float32 else
                        G_tau.astype(jnp.complex128), jnp.conj(F).T)
        gk = jnp.real(gk).mean(axis=1) / self.cfg.n_sites  # spin-avg
        if susceptibilities:
            if not per_slice:
                raise ValueError("susceptibilities need per_slice=True "
                                 "(trapezoid over every tau slice)")
            ps, pd = self.pair_susceptibilities(G_tau)
            return gk, dev, ps, pd
        if per_slice:
            return gk, dev
        return gk

    def pair_susceptibilities(self, G_tau: jax.Array):
        """tau-integrated s- and d_{x2-y2}-wave pairing susceptibilities
        from per-slice time-displaced Greens, by Wick factorization at
        fixed auxiliary field:

            P = (1/N) sum_ij int_0^beta dtau <Delta_i(tau) Delta_j+(0)>
            <Delta_i(tau) Delta_j+(0)>
                = G_up(tau,0)_ij * [D G_dn(tau,0) D^T]_ij

        with Delta_i = sum_delta f_delta c_{i+delta,dn} c_{i,up}. The
        form-factor matrix D is the identity for the on-site s-wave pair
        and the signed nearest-neighbor adjacency (+1 along x, -1 along
        y) for d-wave — applied as two matmuls per slice, never a
        gather. The tau integral is the trapezoid over all m+1 slices.
        Reference observable class: unequal-time pairing correlators
        (SURVEY.md §1 "pairing and current correlators"; the reference
        computes these in its TimeDisplaced=true measure path). d-wave
        is 2-D only: for d != 2 lattices it returns 0.

        G_tau: (m+1, C, N, N); returns two scalars (P_s, P_d)."""
        cfg = self.cfg
        up = G_tau[:, 0]
        dn = G_tau[:, -1]                       # == up's partner sector
        w = jnp.full((cfg.m + 1,), cfg.dtau, up.dtype)
        w = w.at[0].mul(0.5).at[-1].mul(0.5)    # trapezoid
        ps = jnp.einsum("t,tij,tij->", w, up, dn) / cfg.n_sites
        if self._dwave_D is None:
            return ps, jnp.zeros_like(ps)
        D = self._dwave_D.astype(up.dtype)
        dn_d = jnp.einsum("in,tnm,jm->tij", D, dn, D,
                          preferred_element_type=up.dtype)
        pd = jnp.einsum("t,tij,tij->", w, up, dn_d) / cfg.n_sites
        return ps, pd

    # -- setup -------------------------------------------------------------------
    def init_state(self, key: jax.Array) -> WalkerState:
        """Random Hirsch field; build the right stack from scratch and the
        stabilized G(0) (reference: setupUdVStorage..., SURVEY.md §3)."""
        cfg = self.cfg
        N, K, s_int = cfg.n_sites, cfg.n_stack, cfg.s
        dt = cfg.jdtype
        key, fkey = jax.random.split(key)
        field = (2.0 * jax.random.bernoulli(fkey, 0.5, (cfg.m, N)) - 1.0
                 ).astype(dt)
        sdt = cfg.stab_jdtype
        rsdt = jnp.finfo(sdt).dtype
        state0 = WalkerState(
            field=field, G=jnp.zeros((cfg.ncomp, N, N), dt),
            stack=Stack(U=jnp.zeros((K + 1, cfg.ncomp, N, N), dt),
                        d=jnp.zeros((K + 1, cfg.ncomp, N), rsdt),
                        V=jnp.zeros((K + 1, cfg.ncomp, N, N), sdt)),
            key=key,
            sign=jnp.ones((), dt),
            next_dir=jnp.asarray(0, jnp.int32),
            sweeps_done=jnp.asarray(0, jnp.int32),
            green_dev=jnp.zeros((), jnp.float32),
            sv_min=jnp.zeros((), jnp.float32),
            sv_max=jnp.zeros((), jnp.float32),
            h=jnp.asarray(cfg.stagger_h, dt),
        )
        return self.refresh_from_field(state0)

    def refresh_from_field(self, state: WalkerState) -> WalkerState:
        """Recompute stack + G from the field alone (used by init and by
        checkpoint restore — the reference also reconstructs G on load,
        SURVEY.md §6 "Checkpoint / resume")."""
        cfg = self.cfg
        N, K, s_int = cfg.n_sites, cfg.n_stack, cfg.s
        dt = cfg.jdtype
        sdt = cfg.stab_jdtype
        cb = self.cb_sparse
        field = state.field
        eye_f = self._eye_mixed()
        rsdt = jnp.finfo(sdt).dtype

        def build_interval(f_carry, k):
            # absorb block (B_{ks} .. B_{(k-1)s+1})^T in descending order
            def absorb(lazy_U, l_rel):
                l = k * s_int - l_rel
                e = self.exp_v(field[l - 1])
                return bchain.bT_mult_left(self.prop, e, lazy_U,
                                           checkerboard=cb), None

            lazy_U, _ = jax.lax.scan(absorb, f_carry.U,
                                     jnp.arange(s_int))
            f_new = udv_refactor(lazy_U, f_carry.d, f_carry.V,
                                 compose_dtype=sdt)
            return f_new, f_new

        _, emitted = jax.lax.scan(build_interval, eye_f,
                                  jnp.arange(K, 0, -1))
        # emitted entries correspond to positions K-1 .. 0: flip + append
        # identity (concat, not scatter — see _sweep)
        newU = jnp.concatenate(
            [jnp.flip(emitted.U, axis=0), eye_f.U[None].astype(dt)], axis=0)
        newd = jnp.concatenate(
            [jnp.flip(emitted.d, axis=0), eye_f.d[None]], axis=0)
        newV = jnp.concatenate(
            [jnp.flip(emitted.V, axis=0), eye_f.V[None]], axis=0)
        full_t = UDV(newU[0], newd[0], newV[0])
        G = self._green(self._eye_mixed(), full_t)
        # exact weight sign from the factored chain: det(1 + A^T) = det(1+A)
        sign = self._chain_sign(full_t).astype(dt)
        return state._replace(
            G=G, stack=Stack(newU, newd, newV),
            sign=sign,
            next_dir=jnp.asarray(0, jnp.int32))

    def _chain_sign(self, full_t: UDV) -> jax.Array:
        """sign(prod_sigma det(1 + B-chain)) from the factored chain, in
        the precision island. Ratio-sign tracking during sweeps is exact
        in all configurations."""
        if self.cfg.ph_on:
            # det M_up det M_dn = e^{-alpha sum s} (det M_up)^2 > 0
            return jnp.ones(())
        _, sgns = log_det_one_plus_udv(full_t)
        return sgns[0] * sgns[1]

    def host_chain_sign(self, states) -> np.ndarray:
        """NumPy f64 determinant signs from (possibly vmapped) state stacks
        — the driver's host-side check of the initial sign for
        sign-problem runs."""
        U = np.asarray(states.stack.U)   # (..., K+1, 2, N, N)
        d = np.asarray(states.stack.d)
        V = np.asarray(states.stack.V)
        batch = U.shape[:-4]
        out = np.ones(batch or ())
        for idx in np.ndindex(batch) if batch else [()]:
            s = 1.0
            for c in range(self.ncomp):
                Uc, dc, Vc = U[idx][0][c], d[idx][0][c], V[idx][0][c]
                sU, _ = np.linalg.slogdet(Uc)
                sV, _ = np.linalg.slogdet(Vc)
                dmax, dmin = np.maximum(dc, 1), np.minimum(dc, 1)
                inner = (Uc.T @ np.linalg.inv(Vc)) / dmax[:, None] \
                    + np.diag(dmin)
                sI, _ = np.linalg.slogdet(inner)
                s *= sU * sV * sI
            if batch:
                out[idx] = s
            else:
                out = np.asarray(s)
        return out
