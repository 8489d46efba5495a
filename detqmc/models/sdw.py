"""O(N) spin-density-wave metal model — BSS DQMC in JAX.

Reference parity: SURVEY.md §3 row "SDW model" (DetSDW<CB, OPDIM>:
O(opdim in {1,2,3}) order-parameter field phi(i, l) Yukawa-coupled to two
fermion bands; analytic per-site exp(-dtau V(phi)); box proposals with
adaptive width; Woodbury rank-k Green updates; global shift moves;
turnoffFermions mode; control parameter r settable for parallel
tempering) and §9's algorithm appendix.

Model (Schattner-Gerlach-Trebst-Berg; PRB 95, 035124 (2017)):

  S = S_B[phi] + fermion determinant, with per time slice
  B_l = exp(-dtau V(phi_l)) exp(-dtau K),
  V_i = lam [[0, Phi_i], [Phi_i^H, 0]] in the (x_up, x_dn, y_up, y_dn)
  orbital basis, Phi = phi . sigma (first `opdim` Pauli matrices), so
  V^2 = (lam |phi|)^2 and exp(-dtau V) is closed-form:
      exp(-dtau V) = cosh(a) 1 - sinh(a)/(lam|phi|) V,  a = dtau lam |phi|.

  S_B = dtau sum_{i,l} [ (phi_{i,l+1}-phi_{i,l})^2 / (2 c^2 dtau^2)
        + (1/2) sum_nn (phi_i - phi_j)^2 + (r/2) phi^2 + (u/4) (phi^2)^2 ]

The design mirrors models/hubbard.py: the sweep is nested lax.scans
over (stabilization intervals, slices, sites); the fermion matrix is
(4N, 4N) complex64/128 with orbital-major layout so the block-diagonal
potential applies as an (N, 4, 4) batched matmul and the kinetic factor
as a (4, N, N) batched matmul; walkers vmap on top. The same UdV stack
machinery (transposed right products, log-domain refactor, range-split
pair formula) stabilizes the chain — it is dtype-generic and handles the
complex case. Single-site Metropolis uses the exact 4x4-block determinant
ratio and a rank-4 Woodbury update of G.

Where Hubbard has two decoupled spin sectors, here there is ONE fermion
matrix; the weight is det M, guaranteed non-negative for opdim 2, 3 by
the model's antiunitary symmetry (tracked anyway via phases).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from detqmc import lattice as lattice_mod
from detqmc.lattice import kinetic_exponentials
from detqmc.linalg.udv import (
    UDV,
    green_from_two_udv,
    udv_refactor,
)
from detqmc.precision import mm

N_ORB = 4  # (band x, band y) x (spin up, spin dn)
# update_kernel="auto" at delay = 0: (smallest fermion-matrix dim, delay K)
# from which the XLA delayed path replaces the scan. Measured on an H100
# at O(3) L=8 (dim 256, 128 walkers): delayed K=8 80.7 sweeps/s, K=16
# 80.2, scan 75.4 (PERF.md); smaller dims keep the scan.
AUTO_DELAY = (256, 8)


@dataclasses.dataclass(frozen=True)
class SDWConfig:
    """Static parameters (reference: ModelParams<DetSDW>, SURVEY.md §3)."""

    L: int = 4
    opdim: int = 2              # O(1) / O(2) / O(3) order parameter
    r: float = 0.0              # tuning parameter (PT control parameter)
    lam: float = 1.0            # Yukawa coupling
    u: float = 1.0              # quartic coupling
    c: float = 1.0              # bare boson velocity
    # band structure (x band hops strongly along x; y band along y)
    txhor: float = -1.0
    txver: float = -0.5
    tyhor: float = -0.5
    tyver: float = -1.0
    mu: float = -0.5
    beta: float = 4.0
    m: int = 40
    s: int = 4                  # stabilization interval
    # delayed (block) updates: buffer `delay` accepted rank-n_orb Woodbury
    # updates and flush them with one blocked GEMM (reference:
    # updateMethod=delayed, SURVEY.md §3 "SDW model"); 0 = immediate
    # iterative/Woodbury updates
    delay: int = 0
    box_width: float = 1.0      # phi proposal box half-width (tunable)
    # checkerboard hopping-exponential breakup (reference:
    # CheckerboardMethod / CB_ASSAAD_BERG, SURVEY.md §3 "Checkerboard
    # hopping"): exp(-dtau K_band) factors into 4 bond groups of disjoint
    # 2x2 mixers with per-band anisotropic coefficients — an O(N) apply
    # instead of an O(N^2) gemm per operand column
    checkerboard: bool = False
    # how the checkerboard factors are applied: "sparse" = the literal
    # 4 sequential gather+axpy group passes (the reference's O(N) apply —
    # right for CPUs); "dense" = precompute the exact PRODUCT matrix
    # E = F0 F1 F2 F3 of the breakup once (and its exact inverse from the
    # per-factor inverses) and apply it as one matmul — same
    # checkerboard-factorized physics, but one GEMM instead of 4 serial
    # gather passes over the operand, which suits these sizes (N <= a
    # few hundred). "auto" = dense.
    cb_apply: str = "auto"
    # single-site proposal kind (reference: spinProposalMethod =
    # BOX | ROTATE_THEN_SCALE | ROTATE_AND_SCALE, SURVEY.md §3):
    #   box              phi' = phi + box_width * uniform[-1,1]^opdim
    #   rotate_then_scale  alternate sweeps: direction resample at fixed
    #                      |phi| / symmetric-in-|phi|^2 radius proposal
    #   rotate_and_scale   both in one proposal
    # radius proposals in r^2 = |phi|^2 carry the measure factor
    # (r'^2/r^2)^{(opdim-2)/2} in the Metropolis ratio.
    spinProposalMethod: str = "box"
    globalShift: bool = False
    wolffClusterUpdate: bool = False
    # compound cluster move (reference: wolffClusterShiftUpdate): Wolff
    # reflection about a random axis e + a global shift delta PERP e (so
    # the cluster bond strengths (phi.e)(phi'.e) are shift-invariant and
    # the construction stays balanced); accepted with the r/u potential
    # difference + full stabilized fermion determinant ratio
    wolffClusterShiftUpdate: bool = False
    globalUpdateInterval: int = 5   # sweeps between global moves
    turnoffFermions: bool = False
    # fermion-matrix representation for opdim >= 2 (complex matrices):
    # "complex" (natural complex64/complex128 arithmetic; "auto" picks
    # it) or "real_embed" (rho(M) = [[Re,-Im],[Im,Re]]: 2x the dimension
    # but pure-real linear algebra; the embedded determinant is |det|^2,
    # so Metropolis ratios take a sqrt — exact because det M >= 0 by the
    # model's antiunitary symmetry)
    fermion_repr: str = "auto"
    # two-sector dimensional reduction for opdim <= 2 (reference: DetSDW's
    # matrix is 2N x 2N below opdim 3, SURVEY.md §3 "SDW model"): with
    # phi_z = 0 the 4-orbital matrix decouples into (x_up, y_dn) and its
    # complex conjugate (x_dn, y_up), so the physical weight is
    # |det M_A|^2 on a HALF-size matrix. "auto" = reduce when opdim <= 2;
    # "full" forces the 4N representation (cross-validation / oracle).
    fermion_matrix: str = "auto"
    # site-update path: "scan" = the sequential lax.scan over sites (or
    # the XLA delayed path when delay > 0); "auto" = the faster route on
    # the device in use (see SDWModel.__init__)
    update_kernel: str = "auto"
    # matmul precision of the Green-function WRAP products B G B^-1 only
    # (reference: the wrapped-G propagation between stabilizations,
    # SURVEY.md §9 "Wrapping & stabilization"): "highest" (full f32;
    # "auto" picks it) or "high" (a faster reduced-precision product
    # where the backend has one; the per-wrap error compounds over the s
    # wraps between anchors and shows in green_dev)
    wrap_prec: str = "auto"
    dtype: str = "float32"
    stab_dtype: str = "auto"

    def __post_init__(self):
        if self.m % self.s != 0:
            raise ValueError(f"m={self.m} must be divisible by s={self.s}")
        if self.opdim not in (1, 2, 3):
            raise ValueError("opdim must be 1, 2 or 3")
        if self.delay < 0:
            raise ValueError("delay must be >= 0")
        if self.checkerboard and self.L % 2 != 0:
            raise ValueError("checkerboard requires even L")
        if self.spinProposalMethod not in (
                "box", "rotate_then_scale", "rotate_and_scale"):
            raise ValueError("spinProposalMethod must be box|"
                             "rotate_then_scale|rotate_and_scale, got "
                             f"{self.spinProposalMethod!r}")
        if self.spinProposalMethod != "box" and self.opdim == 1:
            raise ValueError("rotate/scale proposals need opdim >= 2 "
                             "(an Ising field has no direction to rotate)")
        if self.update_kernel not in ("auto", "scan"):
            raise ValueError("update_kernel must be auto|scan, got "
                             f"{self.update_kernel!r}")
        if self.fermion_repr not in ("auto", "complex", "real_embed"):
            raise ValueError("fermion_repr must be auto|complex|real_embed"
                             f", got {self.fermion_repr!r}")
        if self.cb_apply not in ("auto", "dense", "sparse"):
            raise ValueError("cb_apply must be auto|dense|sparse, got "
                             f"{self.cb_apply!r}")
        if self.wrap_prec not in ("auto", "highest", "high"):
            raise ValueError("wrap_prec must be auto|highest|high, got "
                             f"{self.wrap_prec!r}")

    @property
    def dtau(self) -> float:
        return self.beta / self.m

    @property
    def n_sites(self) -> int:
        return self.L * self.L

    @property
    def dim(self) -> int:
        return N_ORB * self.n_sites

    @property
    def n_stack(self) -> int:
        return self.m // self.s

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    @property
    def cdtype(self):
        """Fermion-matrix dtype: complex for opdim >= 2 (sigma_y), real
        for the Ising case."""
        if self.opdim == 1:
            return jnp.dtype(self.dtype)
        return jnp.dtype("complex64") if self.dtype == "float32" \
            else jnp.dtype("complex128")

    @property
    def stab_jdtype(self):
        if self.stab_dtype == "auto":
            if self.cdtype == jnp.dtype("complex64"):
                return jnp.dtype("complex128")
            if self.cdtype == jnp.dtype("float32"):
                return jnp.dtype("float64")
            return self.cdtype
        return jnp.dtype(self.stab_dtype)


class SDWState(NamedTuple):
    """Per-walker device state."""

    phi: jax.Array         # (m, N, opdim) order-parameter field
    G: jax.Array           # (dim, dim) equal-time Green at sweep edge
    stack_U: jax.Array     # (K+1, dim, dim) cdtype
    stack_d: jax.Array     # (K+1, dim) real
    stack_V: jax.Array     # (K+1, dim, dim) stab cdtype
    key: jax.Array
    phase: jax.Array       # complex phase/sign of det M (tracked exactly)
    box_width: jax.Array   # adaptive proposal width (device scalar)
    r: jax.Array           # traced control parameter (PT swaps change it)
    next_dir: jax.Array
    sweeps_done: jax.Array
    green_dev: jax.Array
    sv_min: jax.Array
    sv_max: jax.Array


class SDWObservables(NamedTuple):
    """Reference observable set (SURVEY.md §3: phi moments for Binder
    cumulants, SDW susceptibility, occupancy, action pieces)."""

    phiSquared: jax.Array       # <|phi|^2> per site
    phiFourth: jax.Array        # <(|phi|^2)^2> (Binder numerator)
    phiNorm: jax.Array          # <|phi|>
    sdwSusceptibility: jax.Array  # beta * N * <|phibar|^2>, phibar = mean
    occupancy: jax.Array        # fermion filling per site (all 4 orbitals)
    kineticEnergy: jax.Array
    bosonAction: jax.Array      # S_B / (m N)
    # exchange-conjugate action a = dtau/2 sum phi^2 of ONE configuration
    # (the sweep's final field, not an interval average): the
    # Ferrenberg-Swendsen weights exp(-dr*a) are nonlinear in a, so mrpt
    # must see single-configuration samples (Jensen bias otherwise)
    exchangeAction: jax.Array
    phase: jax.Array            # Re of the tracked det phase
    acceptance: jax.Array
    # ---- vector observables (the reference's scientific payload:
    # k-resolved structure factors, fermionic spin/charge/pairing
    # correlators — SURVEY.md §1/§3 "SDW model" measure()) ----
    phiCorrelation: jax.Array        # (N,) <phi_0 . phi_d>, equal-time
    phiStructureFactor: jax.Array    # (N,) S_phi(k) over the k-grid
    chargeCorrelation: jax.Array     # (N,) <n_0 n_d> (all 4 orbitals)
    chargeStructureFactor: jax.Array  # (N,) FT of the connected part
    spinZCorrelation: jax.Array      # (N,) <S^z_0 S^z_d> fermionic
    spinZStructureFactor: jax.Array  # (N,)
    pairingCorrelation: jax.Array    # (N,) onsite s-wave <Delta†_0 Delta_d>
    kOccupationX: jax.Array          # (N,) n_x(k) over the k-grid
    kOccupationY: jax.Array          # (N,) n_y(k) (both spins each)
    occupancyX: jax.Array            # filling of the x band (both spins)
    occupancyY: jax.Array


def _pauli_stack(opdim: int) -> np.ndarray:
    sx = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    sy = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
    sz = np.array([[1, 0], [0, -1]], dtype=np.complex128)
    return np.stack([sx, sy, sz][:opdim])


def _cb_dense_product(partner: np.ndarray, cosh_og: np.ndarray,
                      sinh_og: np.ndarray, gamma: float
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Exact dense product matrices of the checkerboard breakup.

    E = gamma * F_0 F_1 ... F_{g-1} per orbital (the apply order of
    `_kinetic_cb_left`), each F_g = cosh_g * I + sinh_g * P_g with P_g the
    bond-partner involution of group g. The inverse is exact as the
    reversed product of per-factor inverses (det F_g = 1 per bond:
    F_g^{-1} just flips the sinh sign) — no matrix inversion. Computed
    once in fp64 at setup; the device then applies the factorized kinetic
    as one matmul instead of 4 serial gather+axpy passes.

    partner: (n_g, N) int; cosh_og/sinh_og: (n_orb, n_g); returns a pair
    of (n_orb, N, N) fp64 arrays (E, E^{-1}).
    """
    n_g, N = partner.shape
    n_orb = cosh_og.shape[0]
    E = np.broadcast_to(np.eye(N), (n_orb, N, N)).copy()
    Einv = E.copy()
    for g in reversed(range(n_g)):   # F_{g-1} applied first to identity
        E = cosh_og[:, g][:, None, None] * E \
            + sinh_og[:, g][:, None, None] * E[:, partner[g], :]
    for g in range(n_g):             # E^{-1} = F'_{g-1} ... F'_1 F'_0
        Einv = cosh_og[:, g][:, None, None] * Einv \
            - sinh_og[:, g][:, None, None] * Einv[:, partner[g], :]
    return gamma * E, Einv / gamma


class SDWModel:
    """Factory binding static config + device constants to jitted kernels
    (structure mirrors HubbardModel)."""

    vector_observables = ("phiCorrelation", "phiStructureFactor",
                          "chargeCorrelation", "chargeStructureFactor",
                          "spinZCorrelation", "spinZStructureFactor",
                          "pairingCorrelation", "kOccupationX",
                          "kOccupationY", "greenKTauVector")

    def __init__(self, cfg: SDWConfig):
        self.cfg = cfg
        self.lat = lattice_mod.SquareLattice(cfg.L)
        from detqmc.precision import ensure_runtime

        ensure_runtime(need_x64=(jnp.dtype(cfg.stab_jdtype).kind in "cf"
                                 and jnp.dtype(cfg.stab_jdtype).itemsize
                                 >= 8))
        self.embed = (cfg.fermion_repr == "real_embed" and cfg.opdim >= 2)
        if cfg.fermion_matrix == "auto":
            self.reduced = cfg.opdim <= 2
        elif cfg.fermion_matrix in ("full", "reduced"):
            if cfg.fermion_matrix == "reduced" and cfg.opdim == 3:
                raise ValueError("opdim=3 has no two-sector reduction "
                                 "(phi_z couples the sectors)")
            self.reduced = cfg.fermion_matrix == "reduced"
        else:
            raise ValueError(f"bad fermion_matrix {cfg.fermion_matrix!r}")
        # base orbitals: reduced sector A = (x_up, y_dn); full = 4 orbitals
        self.n_orb_base = 2 if self.reduced else N_ORB
        self.n_orb = (2 if self.embed else 1) * self.n_orb_base
        self.dim = self.n_orb * cfg.n_sites
        self.cdtype = cfg.jdtype if self.embed else cfg.cdtype
        # _chain_logdet returns the model-representation log|det|; this
        # factor converts it to the PHYSICAL fermionic log-weight
        # log(det M_A det M_B) = 2 log|det M_A|:
        #   reduced+embed:  det rho(M_A) = |det M_A|^2  -> x1 (exact!)
        #   reduced:        log|det M_A|                -> x2
        #   full+embed:     2 log|det M_full|           -> x0.5
        #   full:           log|det M_full|             -> x1
        if self.reduced:
            self.logdet_fac = 1.0 if self.embed else 2.0
        else:
            self.logdet_fac = 0.5 if self.embed else 1.0
        if self.embed and jnp.dtype(cfg.stab_jdtype).kind == "c":
            self.stab_dtype_eff = jnp.dtype(
                "float64" if jnp.dtype(cfg.stab_jdtype).itemsize == 16
                else "float32")
        else:
            self.stab_dtype_eff = jnp.dtype(cfg.stab_jdtype)
        cdt = self.cdtype
        N = cfg.n_sites
        # per-band kinetic exponentials (x: strong along x; y: rotated)
        Kx = self.lat.hopping_matrix(1.0, tx=cfg.txhor, ty=cfg.txver)
        Ky = self.lat.hopping_matrix(1.0, tx=cfg.tyhor, ty=cfg.tyver)
        expKx, expKx_inv = kinetic_exponentials(Kx, cfg.dtau, cfg.mu)
        expKy, expKy_inv = kinetic_exponentials(Ky, cfg.dtau, cfg.mu)
        # orbital-major order: (x_up, x_dn, y_up, y_dn), or the reduced
        # sector (x_up, y_dn) [+ Im copies when embedded: each complex
        # orbital contributes a (Re, Im) pair with the same real kinetic
        # matrix]
        reps = 2 if self.embed else 1
        if self.reduced:
            ek, eki, ko = [expKx, expKy], [expKx_inv, expKy_inv], [Kx, Ky]
        else:
            ek = [expKx, expKx, expKy, expKy]
            eki = [expKx_inv, expKx_inv, expKy_inv, expKy_inv]
            ko = [Kx, Kx, Ky, Ky]
        self.expK = jnp.asarray(np.stack(ek * reps), cdt)
        self.expK_inv = jnp.asarray(np.stack(eki * reps), cdt)
        self.K_orb = jnp.asarray(np.stack(ko * reps), cdt)
        # The real-embedded path uses split Re/Im pauli copies and never
        # materializes a complex array; the complex stack is only created
        # when the complex representation is in use.
        if not self.embed and not self.reduced:
            self.paulis = jnp.asarray(_pauli_stack(cfg.opdim), cfg.cdtype)
        self.paulis_re = jnp.asarray(
            np.real(_pauli_stack(cfg.opdim)), cfg.jdtype)
        self.paulis_im = jnp.asarray(
            np.imag(_pauli_stack(cfg.opdim)), cfg.jdtype)
        self.nb = jnp.asarray(self.lat.neighbors(), jnp.int32)  # (N, 4)
        # displacement table + cos-Fourier matrix for translation-averaged
        # correlations and k-resolved structure factors (correlations are
        # inversion-symmetric on the torus, so the sine part vanishes)
        s_ = np.arange(N)
        xs, ys = self.lat.xy(s_)
        self.disp_idx = jnp.asarray(
            self.lat.site(xs[None, :] + xs[:, None],
                          ys[None, :] + ys[:, None]), jnp.int32)
        kg = self.lat.k_grid()                              # (N, 2)
        rg = np.stack([xs, ys], axis=1)
        self.four_cos = jnp.asarray(np.cos(kg @ rg.T), cfg.jdtype)
        self.four_sin = jnp.asarray(np.sin(kg @ rg.T), cfg.jdtype)
        # d_{x2-y2} pair form factor (+1 x, -1 y neighbors) as a dense
        # matrix: pair_susceptibilities applies it as matmuls
        nb_np = self.lat.neighbors()
        Dmat = np.zeros((N, N))
        np.add.at(Dmat, (s_, nb_np[:, 0]), 1.0)
        np.add.at(Dmat, (s_, nb_np[:, 1]), 1.0)
        np.add.at(Dmat, (s_, nb_np[:, 2]), -1.0)
        np.add.at(Dmat, (s_, nb_np[:, 3]), -1.0)
        self._dwave_D = jnp.asarray(Dmat, cfg.jdtype)
        self.cb_sparse = cfg.checkerboard and cfg.cb_apply == "sparse"
        # wrap-only matmul precision (see SDWConfig.wrap_prec); "highest"
        # maps to an explicit Precision so the wrap path never depends on
        # the mutable jax_default_matmul_precision global
        self._wrap_prec = (jax.lax.Precision.HIGH if cfg.wrap_prec == "high"
                           else jax.lax.Precision.HIGHEST)
        if cfg.checkerboard:
            # per-orbital group coefficients: groups (0, 1) are horizontal
            # bonds (amplitude t_hor of that orbital's band), (2, 3)
            # vertical; K has -t on bonds so each group factor is
            # [[cosh(dtau t), sinh(dtau t)], [sinh, cosh]] per bond pair,
            # and the uniform mu enters as one scalar e^{dtau mu} per apply
            partner_np = self.lat.checkerboard_groups()
            self.cb_partner = jnp.asarray(partner_np, jnp.int32)  # (4, N)
            bands = (["x", "y"] if self.reduced
                     else ["x", "x", "y", "y"]) * reps
            th = np.array([cfg.txhor if b == "x" else cfg.tyhor
                           for b in bands])
            tv = np.array([cfg.txver if b == "x" else cfg.tyver
                           for b in bands])
            tg = np.stack([th, th, tv, tv], axis=1)             # (n_orb, 4)
            self.cb_cosh = jnp.asarray(np.cosh(cfg.dtau * tg), cdt)
            self.cb_sinh = jnp.asarray(np.sinh(cfg.dtau * tg), cdt)
            self.cb_gamma = float(np.exp(cfg.dtau * cfg.mu))
            if not self.cb_sparse:
                # dense-product apply (cb_apply="dense"/"auto"): replace
                # exp(-dtau K) by the EXACT product matrix of the
                # checkerboard breakup so the dense einsum path computes
                # the factorized physics in one matmul per apply
                E, Einv = _cb_dense_product(
                    partner_np, np.cosh(cfg.dtau * tg),
                    np.sinh(cfg.dtau * tg), self.cb_gamma)
                self.expK = jnp.asarray(E, cdt)
                self.expK_inv = jnp.asarray(Einv, cdt)
        # site-update route (see SDWConfig.update_kernel): an explicit
        # delay > 0 always takes the XLA delayed path; "auto" may also
        # pick it at delay = 0 (AUTO_DELAY below)
        self._delay = cfg.delay
        if (cfg.update_kernel == "auto" and cfg.delay == 0
                and AUTO_DELAY is not None and self.dim >= AUTO_DELAY[0]):
            self._delay = AUTO_DELAY[1]
        self._jit_cache = {}

    def _green(self, left: UDV, right_t: UDV) -> jax.Array:
        """Stabilized G from factored halves in the precision island."""
        return green_from_two_udv(
            left, right_t, compute_dtype=self.stab_dtype_eff
        ).astype(self.cdtype)

    def _refactor(self, M, d, V, compose_dtype=None) -> UDV:
        return udv_refactor(M, d, V,
                            compose_dtype=compose_dtype or self.stab_dtype_eff)

    # ---- potential factor ---------------------------------------------------
    def _embed(self, blocks: jax.Array) -> jax.Array:
        """rho(M) = [[Re M, -Im M], [Im M, Re M]]: (..., k, k) complex ->
        (..., 2k, 2k) real (ring isomorphism; all UdV/Green identities
        carry over verbatim on the image)."""
        re = jnp.real(blocks).astype(self.cfg.jdtype)
        im = jnp.imag(blocks).astype(self.cfg.jdtype)
        top = jnp.concatenate([re, -im], axis=-1)
        bot = jnp.concatenate([im, re], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)

    def _phi_matrix(self, phi_site: jax.Array) -> jax.Array:
        """Phi = phi . sigma: (..., 2, 2) from (..., opdim)."""
        return jnp.einsum("...o,oab->...ab",
                          phi_site.astype(self.cfg.cdtype), self.paulis)

    def _phi_matrix_reim(self, phi_site: jax.Array):
        """(Re Phi, Im Phi) via REAL einsums, so the embedded path never
        materializes a complex array."""
        dt = self.cfg.jdtype
        re = jnp.einsum("...o,oab->...ab", phi_site, self.paulis_re)
        im = jnp.einsum("...o,oab->...ab", phi_site, self.paulis_im)
        return re.astype(dt), im.astype(dt)

    def exp_v_blocks(self, phi_slice: jax.Array, sign: float = -1.0
                     ) -> jax.Array:
        """exp(sign * dtau * V(phi)) as per-site 4x4 blocks: (N, 4, 4).

        Closed form via V^2 = (lam |phi|)^2 (SURVEY.md §9 "SDW model")."""
        cfg = self.cfg
        nrm = jnp.sqrt(jnp.sum(phi_slice ** 2, axis=-1))        # (N,)
        a = cfg.dtau * cfg.lam * nrm
        ch_r = jnp.cosh(a)
        sh_r = jnp.where(nrm > 0, jnp.sinh(a) / jnp.maximum(nrm, 1e-30),
                         cfg.dtau * cfg.lam)                    # sinh/|phi|
        # [[ch 1, s Phi], [s Phi^H, ch 1]]: V = lam [[0, Phi], [Phi^H, 0]]
        # and sinh(a) V/(lam|phi|) = (sinh(a)/|phi|) [[0, Phi], [Phi^H, 0]]
        if self.reduced:
            return self._assemble_reduced(phi_slice, ch_r, sh_r, sign)
        if self.embed:
            return self._assemble_embedded(phi_slice, ch_r, sh_r, sign)
        cdt = cfg.cdtype
        ch = ch_r.astype(cdt)
        sh_over = sh_r
        Phi = self._phi_matrix(phi_slice)                       # (N, 2, 2)
        eye2 = jnp.eye(2, dtype=cdt)
        coef = (sign * sh_over).astype(cdt)[:, None, None]
        off = coef * Phi
        offH = coef * jnp.conj(jnp.swapaxes(Phi, -1, -2))
        row1 = jnp.concatenate([ch[:, None, None] * eye2, off], axis=-1)
        row2 = jnp.concatenate([offH, ch[:, None, None] * eye2], axis=-1)
        return jnp.concatenate([row1, row2], axis=-2)           # (N, 4, 4)

    def _assemble_reduced(self, phi_site, ch, sh_over, sign):
        """Sector-A block exp(sign dtau V_A), V_A = lam [[0, p], [p*, 0]],
        p = phi_x - i phi_y (phi_z = 0 below opdim 3, so the 4-orbital
        matrix decouples; reference: DetSDW's 2N x 2N case, SURVEY.md §3).
        Closed form exp = cosh(a) 1 + sign sinh(a)/(lam |phi|) V_A.
        Returns (..., 2, 2) real (opdim 1) / complex (opdim 2), or the
        (..., 4, 4) real embedding rho(B). Works for single sites
        ((opdim,) input) and slices ((N, opdim))."""
        cfg = self.cfg
        dt = cfg.jdtype
        px = phi_site[..., 0]
        py = (phi_site[..., 1] if cfg.opdim >= 2 else jnp.zeros_like(px))
        ch = jnp.asarray(ch, dt)
        s = sign * jnp.asarray(sh_over, dt)
        off_re, off_im = s * px, -s * py      # off = s * p
        if self.embed:
            z = jnp.zeros_like(ch)
            reB = jnp.stack([jnp.stack([ch, off_re], -1),
                             jnp.stack([off_re, ch], -1)], -2)
            imB = jnp.stack([jnp.stack([z, off_im], -1),
                             jnp.stack([-off_im, z], -1)], -2)
            top = jnp.concatenate([reB, -imB], axis=-1)
            bot = jnp.concatenate([imB, reB], axis=-1)
            return jnp.concatenate([top, bot], axis=-2)   # (..., 4, 4)
        if cfg.opdim == 1:
            return jnp.stack([jnp.stack([ch, off_re], -1),
                              jnp.stack([off_re, ch], -1)], -2)
        cdt = cfg.cdtype
        off = (off_re + 1j * off_im).astype(cdt)
        chc = ch.astype(cdt)
        return jnp.stack([jnp.stack([chc, off], -1),
                          jnp.stack([jnp.conj(off), chc], -1)], -2)

    def _assemble_embedded(self, phi_slice, ch, sh_over, sign):
        """rho of the 4x4 block assembled from purely real pieces:
        Re B = [[ch, s*PhiRe], [s*PhiRe^T, ch]],
        Im B = [[0, s*PhiIm], [-s*PhiIm^T, 0]] (Phi Hermitian-coupled
        block structure), rho(B) = [[ReB, -ImB], [ImB, ReB]]: (..., 8, 8).
        Works for single sites ((opdim,) input) and slices ((N, opdim))."""
        dt = self.cfg.jdtype
        pre, pim = self._phi_matrix_reim(phi_slice)      # (..., 2, 2)
        ch = jnp.asarray(ch, dt)[..., None, None]
        s = (sign * jnp.asarray(sh_over, dt))[..., None, None]
        eye2 = jnp.eye(2, dtype=dt)
        z2 = jnp.zeros_like(pre)
        preT = jnp.swapaxes(pre, -1, -2)
        pimT = jnp.swapaxes(pim, -1, -2)
        reB = jnp.concatenate([
            jnp.concatenate([ch * eye2, s * pre], axis=-1),
            jnp.concatenate([s * preT, ch * eye2], axis=-1)], axis=-2)
        imB = jnp.concatenate([
            jnp.concatenate([z2, s * pim], axis=-1),
            jnp.concatenate([-s * pimT, z2], axis=-1)], axis=-2)
        top = jnp.concatenate([reB, -imB], axis=-1)
        bot = jnp.concatenate([imB, reB], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)      # (..., 8, 8)

    # ---- block-diagonal / kinetic applies -----------------------------------
    def _as_orb(self, X: jax.Array) -> jax.Array:
        """(n_orb*N, k) -> (n_orb, N, k) orbital-major view."""
        return X.reshape(self.n_orb, self.cfg.n_sites, -1)

    def _from_orb(self, X: jax.Array) -> jax.Array:
        return X.reshape(self.n_orb * self.cfg.n_sites, -1)

    def dv_mult_left(self, blocks: jax.Array, X: jax.Array,
                     prec=None) -> jax.Array:
        """D_V @ X with D_V block-diagonal per site: blocks (N, 4, 4)."""
        Xo = self._as_orb(X)                                    # (4, N, k)
        Xo = jnp.einsum("iab,bik->aik", blocks, Xo, precision=prec)
        return self._from_orb(Xo)

    def dv_mult_right(self, X: jax.Array, blocks: jax.Array,
                      prec=None) -> jax.Array:
        """X @ D_V."""
        no, N = self.n_orb, self.cfg.n_sites
        k = X.shape[0]
        xo = X.reshape(k, no, N)
        return jnp.einsum("kai,iab->kbi", xo, blocks,
                          precision=prec).reshape(k, no * N)

    def kinetic_mult_left(self, X: jax.Array, inv=False,
                          transpose=False, prec=None) -> jax.Array:
        if self.cb_sparse:
            return self._kinetic_cb_left(X, inv, transpose)
        E = self.expK_inv if inv else self.expK
        if transpose:
            E = jnp.swapaxes(E, -1, -2)
        Xo = self._as_orb(X)
        return self._from_orb(
            jnp.einsum("onm,omk->onk", E, Xo, precision=prec))

    def kinetic_mult_right(self, X: jax.Array, inv=False,
                           prec=None) -> jax.Array:
        if self.cb_sparse:
            return self._kinetic_cb_right(X, inv)
        E = self.expK_inv if inv else self.expK
        k = X.shape[0]
        Xo = X.reshape(k, self.n_orb, self.cfg.n_sites)
        Xo = jnp.einsum("kom,omn->kon", Xo, E, precision=prec)
        return Xo.reshape(k, self.n_orb * self.cfg.n_sites)

    def _kinetic_cb_left(self, X, inv, transpose):
        """Checkerboard E @ X: E = F0 F1 F2 F3, every F symmetric with
        det 1 per bond, so E^T reverses the group order and E^{-1} flips
        the sinh sign (same ordering logic as linalg/bchain.py)."""
        Xo = self._as_orb(X)                          # (n_orb, N, k)
        groups = list(range(4))[::-1] if transpose == inv else \
            list(range(4))
        sgn = -1.0 if inv else 1.0
        for g in groups:
            p = self.cb_partner[g]
            c = self.cb_cosh[:, g][:, None, None]
            s = sgn * self.cb_sinh[:, g][:, None, None]
            Xo = c * Xo + s * jnp.take(Xo, p, axis=1)
        if self.cfg.mu != 0.0:
            gam = self.cb_gamma if not inv else 1.0 / self.cb_gamma
            Xo = Xo * jnp.asarray(gam, Xo.dtype)
        return self._from_orb(Xo)

    def _kinetic_cb_right(self, X, inv):
        k = X.shape[0]
        Xo = X.reshape(k, self.n_orb, self.cfg.n_sites)
        groups = list(range(4))[::-1] if inv else list(range(4))
        sgn = -1.0 if inv else 1.0
        for g in groups:
            p = self.cb_partner[g]
            c = self.cb_cosh[:, g][None, :, None]
            s = sgn * self.cb_sinh[:, g][None, :, None]
            Xo = c * Xo + s * jnp.take(Xo, p, axis=2)
        if self.cfg.mu != 0.0:
            gam = self.cb_gamma if not inv else 1.0 / self.cb_gamma
            Xo = Xo * jnp.asarray(gam, Xo.dtype)
        return Xo.reshape(k, self.n_orb * self.cfg.n_sites)

    # B = D_V expK (potential leftmost, same convention as Hubbard)
    def b_mult_left(self, blocks, X, prec=None):
        return self.dv_mult_left(blocks,
                                 self.kinetic_mult_left(X, prec=prec),
                                 prec=prec)

    def b_inv_mult_left(self, blocks_inv, X, prec=None):
        return self.kinetic_mult_left(
            self.dv_mult_left(blocks_inv, X, prec=prec),
            inv=True, prec=prec)

    def b_mult_right(self, X, blocks, prec=None):
        return self.kinetic_mult_right(
            self.dv_mult_right(X, blocks, prec=prec), prec=prec)

    def b_inv_mult_right(self, X, blocks_inv, prec=None):
        return self.dv_mult_right(
            self.kinetic_mult_right(X, inv=True, prec=prec),
            blocks_inv, prec=prec)

    def bT_mult_left(self, blocks, X):
        """B^H @ X = expK^H (D_V^H X) for the transposed right stack."""
        blocksH = jnp.conj(jnp.swapaxes(blocks, -1, -2))
        return self.kinetic_mult_left(self.dv_mult_left(blocksH, X),
                                      transpose=True)

    # ---- boson action -------------------------------------------------------
    def boson_action(self, phi: jax.Array, r=None) -> jax.Array:
        """S_B[phi] (SURVEY.md §9). phi: (m, N, opdim). ``r`` may be a
        traced per-replica value (parallel tempering swaps it)."""
        cfg = self.cfg
        if r is None:
            r = cfg.r
        dtau = cfg.dtau
        d_tau = phi - jnp.roll(phi, 1, axis=0)       # periodic in tau
        s_tau = jnp.sum(d_tau ** 2) / (2.0 * cfg.c ** 2 * dtau ** 2)
        # spatial gradient: +x and +y neighbors only (each bond once)
        nb_px = self.nb[:, 0]
        nb_py = self.nb[:, 2]
        dx = phi - phi[:, nb_px]
        dy = phi - phi[:, nb_py]
        s_grad = 0.5 * (jnp.sum(dx ** 2) + jnp.sum(dy ** 2))
        phi2 = jnp.sum(phi ** 2, axis=-1)
        s_pot = 0.5 * r * jnp.sum(phi2) + 0.25 * cfg.u * jnp.sum(phi2 ** 2)
        return dtau * (s_tau + s_grad + s_pot)

    def _local_action(self, phi, l_idx, i, phi_i, r):
        """Boson action terms containing site (i, l) evaluated at phi_i.

        phi: (m, N, opdim); l_idx 1-based slice converted by caller to
        0-based. Includes the two tau-links, four spatial bonds, r and u
        terms — everything that changes under a single-site update."""
        m = self.cfg.m
        return self._local_action_slice(
            phi[l_idx], phi[(l_idx + 1) % m], phi[(l_idx - 1) % m],
            i, phi_i, r)

    def _local_action_slice(self, phi_l, phi_lp, phi_lm, i, phi_i, r):
        """Same as _local_action from pre-gathered slices: phi_l is the
        LIVE current slice (earlier sites of the sweep already updated),
        phi_lp/phi_lm the tau-neighbor slices (constant during one
        slice's site scan — the update loops hoist these out of the
        sequential scan so the per-site op chain stays short)."""
        cfg = self.cfg
        dtau = cfg.dtau
        tau_term = (jnp.sum((phi_i - phi_lp[i]) ** 2)
                    + jnp.sum((phi_i - phi_lm[i]) ** 2)) \
            / (2.0 * cfg.c ** 2 * dtau ** 2)
        nbs = self.nb[i]                              # (4,)
        grad = 0.5 * jnp.sum((phi_i[None, :] - phi_l[nbs]) ** 2)
        phi2 = jnp.sum(phi_i ** 2)
        pot = 0.5 * r * phi2 + 0.25 * cfg.u * phi2 ** 2
        return dtau * (tau_term + grad + pot)

    # ---- per-site Metropolis -------------------------------------------------
    def _site_indices(self, i):
        N = self.cfg.n_sites
        return jnp.arange(self.n_orb) * N + i

    def _draw_proposal_randoms(self, key, box_w):
        """Per-slice random draws for the configured spinProposalMethod.
        Returns (key, u01, rnd) with rnd the method-specific arrays."""
        cfg = self.cfg
        N = cfg.n_sites
        key, k_prop, k_acc = jax.random.split(key, 3)
        u01 = jax.random.uniform(k_acc, (N,), dtype=cfg.jdtype)
        if cfg.spinProposalMethod == "box":
            deltas = jax.random.uniform(
                k_prop, (N, cfg.opdim), dtype=cfg.jdtype,
                minval=-1.0, maxval=1.0) * box_w
            return key, u01, (deltas,)
        k_dir, k_r = jax.random.split(k_prop)
        dirs = jax.random.normal(k_dir, (N, cfg.opdim), dtype=cfg.jdtype)
        gs = jax.random.normal(k_r, (N,), dtype=cfg.jdtype)
        return key, u01, (dirs, gs)

    def _propose_site(self, phi_old, i, rnd, box_w, alt):
        """Site proposal -> (phi_new, log measure factor).

        box: symmetric additive box, factor 0. rotate: uniform direction
        resample at fixed |phi| (symmetric, factor 0). scale: reflected
        Gaussian in r^2 = |phi|^2 (symmetric in r^2), whose d^n phi
        measure contributes (r'^2/r^2)^{(opdim-2)/2} to the Metropolis
        ratio. rotate_then_scale alternates by sweep parity ``alt``;
        rotate_and_scale combines both in one proposal."""
        cfg = self.cfg
        if cfg.spinProposalMethod == "box":
            (deltas,) = rnd
            return phi_old + deltas[i], jnp.zeros((), cfg.jdtype)
        dirs, gs = rnd
        tiny = 1e-30
        r2_old = jnp.sum(phi_old ** 2)
        r_old = jnp.sqrt(jnp.maximum(r2_old, tiny))
        d = dirs[i]
        dir_new = d / jnp.sqrt(jnp.maximum(jnp.sum(d ** 2), tiny))
        r2_new = jnp.abs(r2_old + box_w * gs[i])
        r_new = jnp.sqrt(jnp.maximum(r2_new, tiny))
        jac_scale = (0.5 * (cfg.opdim - 2)
                     * (jnp.log(jnp.maximum(r2_new, tiny))
                        - jnp.log(jnp.maximum(r2_old, tiny)))
                     ).astype(cfg.jdtype)
        if cfg.spinProposalMethod == "rotate_and_scale":
            return r_new * dir_new, jac_scale
        rot = r_old * dir_new
        scl = phi_old * (r_new / r_old)
        phi_new = jnp.where(alt == 0, rot, scl)
        jac = jnp.where(alt == 0, jnp.zeros((), cfg.jdtype), jac_scale)
        return phi_new, jac

    def update_slice(self, G, phi, l_1based, key, phase, box_w, r=None,
                     alt=0):
        """Sequential single-site phi updates in slice l (reference:
        DetSDW::updateInSlice with updateMethod=iterative/woodbury/
        delayed). G: (dim, dim); phi: (m, N, opdim). ``alt`` is the sweep
        parity used by rotate_then_scale proposals. Returns updated
        (G, phi, key, phase, acc_rate)."""
        if self._delay > 0 and not self.cfg.turnoffFermions:
            return self._update_slice_delayed(G, phi, l_1based, key,
                                              phase, box_w, r, alt)
        cfg = self.cfg
        cdt = self.cdtype
        N = cfg.n_sites
        m = cfg.m
        if r is None:
            r = jnp.asarray(cfg.r, cfg.jdtype)
        l_idx = l_1based - 1
        key, u01, rnd = self._draw_proposal_randoms(key, box_w)
        eye4 = jnp.eye(self.n_orb, dtype=cdt)
        # hoisted out of the sequential site scan (the per-site op chain
        # is latency-bound): tau-neighbor slices are constant
        # during one slice's scan (m >= 2), and every site's OLD
        # exp(+dtau V) is known up front — one batched assembly
        phi_lp = phi[(l_idx + 1) % m]
        phi_lm = phi[(l_idx - 1) % m]
        phi_l0 = phi[l_idx]
        evs_old_inv = self.exp_v_blocks(phi_l0, sign=+1.0)   # (N, q, q)

        def site_step(carry, i):
            G, phi_l, phase = carry
            phi_old = phi_l[i]
            phi_new, jac = self._propose_site(phi_old, i, rnd, box_w, alt)
            dS = (self._local_action_slice(phi_l, phi_lp, phi_lm, i,
                                           phi_new, r)
                  - self._local_action_slice(phi_l, phi_lp, phi_lm, i,
                                             phi_old, r))
            if cfg.turnoffFermions:
                accept = u01[i] < jnp.exp(jac - dS)
                phi_l = phi_l.at[i].set(
                    jnp.where(accept, phi_new, phi_old))
                return (G, phi_l, phase), accept.astype(cfg.jdtype)
            # Delta = e^{-dtau V(new)} e^{+dtau V(old)} - 1 (4x4, site i);
            # the inverse of e^{-dtau V(old)} is e^{+dtau V(old)}
            ev_new = self._exp_v_single(phi_new, -1.0)
            ev_old_inv = evs_old_inv[i]
            Delta = mm(ev_new, ev_old_inv) - eye4
            idx = self._site_indices(i)
            G_II = G[jnp.ix_(idx, idx)]
            A = eye4 + mm(Delta, eye4 - G_II)
            R = jnp.linalg.det(A)
            if self.reduced:
                # physical ratio = |R_A|^2 (the conjugate sector B
                # contributes conj(R_A)); with the real embedding
                # det rho(A) = |R_A|^2 IS the physical ratio — no sqrt
                if self.embed:
                    weight = jnp.maximum(jnp.real(R), 0.0) * jnp.exp(jac - dS)
                else:
                    weight = (jnp.abs(R) ** 2) * jnp.exp(jac - dS)
            elif self.embed:
                # det rho(A) = |det A|^2; the physical ratio det A is real
                # and non-negative by the model's antiunitary symmetry
                weight = jnp.sqrt(jnp.maximum(jnp.real(R), 0.0)) \
                    * jnp.exp(jac - dS)
            else:
                weight = jnp.abs(R) * jnp.exp(jac - dS)
            accept = u01[i] < weight
            # Woodbury rank-4: G' = G - G[:,I] [A^{-1} Delta] (1-G)[I,:]
            Ainv_D = jnp.linalg.solve(A, Delta)
            Gcols = G[:, idx]                                   # (dim, 4)
            rowsI = -G[idx, :]
            rowsI = rowsI.at[jnp.arange(self.n_orb), idx].add(1.0)
            upd = mm(Gcols, mm(Ainv_D, rowsI))
            gate = accept.astype(cfg.jdtype)
            G = G - gate * upd
            phi_l = phi_l.at[i].set(
                jnp.where(accept, phi_new, phi_old))
            if self.embed or self.reduced:
                pass  # physical ratios are real non-negative; phase stays 1
            else:
                phase = jnp.where(accept, phase * R / jnp.abs(R), phase)
            return (G, phi_l, phase), gate

        (G, phi_l, phase), acc = jax.lax.scan(
            site_step, (G, phi_l0, phase), jnp.arange(N))
        phi = phi.at[l_idx].set(phi_l)    # one slice write-back
        return G, phi, key, phase, acc.mean()

    def _update_slice_delayed(self, G, phi, l_1based, key, phase, box_w,
                              r=None, alt=0):
        """Delayed (block rank-k) variant of update_slice (reference:
        updateMethod=delayed, SURVEY.md §3 "SDW model"): accepted rank-q
        Woodbury updates (q = n_orb) accumulate in (dim, delay*q) buffers;
        each site reconstructs its affected rows/columns from G plus the
        pending buffers (O(dim * delay * q) work instead of an O(dim^2)
        outer product), and every `delay` sites one blocked
        (dim, kq) @ (kq, dim) GEMM flushes the buffers into G.
        Identical Markov chain to the iterative path (same RNG draws,
        exact algebra)."""
        cfg = self.cfg
        cdt = self.cdtype
        q = self.n_orb
        N, kd = cfg.n_sites, self._delay
        if r is None:
            r = jnp.asarray(cfg.r, cfg.jdtype)
        l_idx = l_1based - 1
        key, u01, rnd = self._draw_proposal_randoms(key, box_w)
        eyeq = jnp.eye(q, dtype=cdt)

        n_blocks = -(-N // kd)
        pad = n_blocks * kd - N
        # pad tail with inert slots: u01 = +inf never accepts (weights are
        # finite), so padded sites change nothing
        site_ids = jnp.concatenate(
            [jnp.arange(N), jnp.full((pad,), N - 1, jnp.int32)])
        u01p = jnp.concatenate([u01, jnp.full((pad,), jnp.inf, u01.dtype)])
        rnd = tuple(jnp.concatenate(
            [a, jnp.ones((pad,) + a.shape[1:], a.dtype)]) for a in rnd)

        # hoisted like update_slice: tau-neighbor slices + all OLD
        # exp(+dtau V) blocks, one batched assembly (m >= 2)
        m = cfg.m
        phi_lp = phi[(l_idx + 1) % m]
        phi_lm = phi[(l_idx - 1) % m]
        phi_l0 = phi[l_idx]
        evs_old_inv = self.exp_v_blocks(phi_l0, sign=+1.0)   # (N, q, q)

        def block_step(carry, b):
            G, phi_l, phase = carry
            Ubuf = jnp.zeros((self.dim, kd * q), cdt)
            Wbuf = jnp.zeros((kd * q, self.dim), cdt)

            def site_step(c, j):
                G, phi_l, Ubuf, Wbuf, phase = c
                t = b * kd + j
                i = site_ids[t]
                phi_old = phi_l[i]
                phi_new, jac = self._propose_site(phi_old, t, rnd, box_w,
                                                  alt)
                dS = (self._local_action_slice(phi_l, phi_lp, phi_lm, i,
                                               phi_new, r)
                      - self._local_action_slice(phi_l, phi_lp, phi_lm, i,
                                                 phi_old, r))
                ev_new = self._exp_v_single(phi_new, -1.0)
                ev_old_inv = evs_old_inv[i]
                Delta = mm(ev_new, ev_old_inv) - eyeq
                idx = self._site_indices(i)
                # effective rows/cols of G including pending updates
                g_cols = G[:, idx] + mm(Ubuf, Wbuf[:, idx])     # (dim, q)
                g_rows = G[idx, :] + mm(Ubuf[idx, :], Wbuf)     # (q, dim)
                G_II = g_cols[idx, :]
                A = eyeq + mm(Delta, eyeq - G_II)
                R = jnp.linalg.det(A)
                if self.reduced:
                    if self.embed:
                        weight = jnp.maximum(jnp.real(R), 0.0) \
                            * jnp.exp(jac - dS)
                    else:
                        weight = (jnp.abs(R) ** 2) * jnp.exp(jac - dS)
                elif self.embed:
                    weight = jnp.sqrt(jnp.maximum(jnp.real(R), 0.0)) \
                        * jnp.exp(jac - dS)
                else:
                    weight = jnp.abs(R) * jnp.exp(jac - dS)
                accept = u01p[t] < weight
                gate = accept.astype(cfg.jdtype)
                Ainv_D = jnp.linalg.solve(A, Delta)
                rowsI = -g_rows
                rowsI = rowsI.at[jnp.arange(q), idx].add(1.0)
                Ucol = (-gate) * mm(g_cols, Ainv_D)             # (dim, q)
                z = jnp.int32(0)
                Ubuf = jax.lax.dynamic_update_slice(Ubuf, Ucol, (z, j * q))
                Wbuf = jax.lax.dynamic_update_slice(Wbuf, rowsI, (j * q, z))
                phi_l = phi_l.at[i].set(
                    jnp.where(accept, phi_new, phi_old))
                if not (self.embed or self.reduced):
                    phase = jnp.where(accept, phase * R / jnp.abs(R),
                                      phase)
                return (G, phi_l, Ubuf, Wbuf, phase), gate

            (G, phi_l, Ubuf, Wbuf, phase), acc = jax.lax.scan(
                site_step, (G, phi_l, Ubuf, Wbuf, phase),
                jnp.arange(kd, dtype=jnp.int32))
            G = G + mm(Ubuf, Wbuf)  # flush: one blocked GEMM
            return (G, phi_l, phase), acc

        (G, phi_l, phase), acc = jax.lax.scan(
            block_step, (G, phi_l0, phase),
            jnp.arange(n_blocks, dtype=jnp.int32))
        phi = phi.at[l_idx].set(phi_l)    # one slice write-back
        acc_real = acc.reshape(-1)[:N]
        return G, phi, key, phase, acc_real.mean()

    def _exp_v_single(self, phi_i: jax.Array, sign: float) -> jax.Array:
        """exp(sign * dtau * V) for one site: (n_orb, n_orb)."""
        cfg = self.cfg
        nrm = jnp.sqrt(jnp.sum(phi_i ** 2))
        a = cfg.dtau * cfg.lam * nrm
        ch_r = jnp.cosh(a)
        sh_r = jnp.where(nrm > 0, jnp.sinh(a) / jnp.maximum(nrm, 1e-30),
                         cfg.dtau * cfg.lam)
        if self.reduced:
            return self._assemble_reduced(phi_i, ch_r, sh_r, sign)
        if self.embed:
            return self._assemble_embedded(phi_i, ch_r, sh_r, sign)
        cdt = cfg.cdtype
        ch = ch_r.astype(cdt)
        sh_over = sh_r.astype(cdt)
        Phi = self._phi_matrix(phi_i)                           # (2, 2)
        eye2 = jnp.eye(2, dtype=cdt)
        off = sign * sh_over * Phi
        offH = sign * sh_over * jnp.conj(Phi.T)
        return jnp.block([[ch * eye2, off], [offH, ch * eye2]])

    # ---- wraps ---------------------------------------------------------------
    def wrap_up(self, G, blocks, blocks_inv):
        p = self._wrap_prec
        return self.b_mult_left(
            blocks, self.b_inv_mult_right(G, blocks_inv, prec=p), prec=p)

    def wrap_down(self, G, blocks, blocks_inv):
        p = self._wrap_prec
        return self.b_inv_mult_left(
            blocks_inv, self.b_mult_right(G, blocks, prec=p), prec=p)

    # ---- measurement -----------------------------------------------------------
    def _phys_green_parts(self, G):
        """(re, im) parts of the PHYSICAL 4-orbital Green <c c†> blocks:
        (4, 4, N, N) in the basis (x_up, x_dn, y_up, y_dn).

        Representation-independent: the reduced model carries sector
        A = (x_up, y_dn) with sector B = conj(A) on (x_dn, y_up) and zero
        cross-sector blocks; the real embedding supplies (Re, Im)
        quadrants directly."""
        cfg = self.cfg
        N = cfg.n_sites
        nb_ = self.n_orb_base
        if self.embed:
            h = G.shape[-1] // 2
            gre, gim = G[:h, :h], G[h:, :h]
        elif jnp.issubdtype(G.dtype, jnp.complexfloating):
            gre, gim = jnp.real(G).astype(cfg.jdtype), \
                jnp.imag(G).astype(cfg.jdtype)
        else:
            gre, gim = G, jnp.zeros_like(G)
        g_re = gre.reshape(nb_, N, nb_, N).transpose(0, 2, 1, 3)
        g_im = gim.reshape(nb_, N, nb_, N).transpose(0, 2, 1, 3)
        if not self.reduced:
            return g_re, g_im
        z = jnp.zeros((N, N), cfg.jdtype)
        # model sector-A orbitals: 0 = x_up, 1 = y_dn; physical order
        # (x_up, x_dn, y_up, y_dn); B entries are conjugates of A's
        a, b = g_re, g_im

        def row(entries):
            return [e if e is not None else z for e in entries]

        re_rows = [row([a[0, 0], None, None, a[0, 1]]),
                   row([None, a[0, 0], a[0, 1], None]),
                   row([None, a[1, 0], a[1, 1], None]),
                   row([a[1, 0], None, None, a[1, 1]])]
        im_rows = [row([b[0, 0], None, None, b[0, 1]]),
                   row([None, -b[0, 0], -b[0, 1], None]),
                   row([None, -b[1, 0], -b[1, 1], None]),
                   row([b[1, 0], None, None, b[1, 1]])]
        re4 = jnp.stack([jnp.stack(r_) for r_ in re_rows])
        im4 = jnp.stack([jnp.stack(r_) for r_ in im_rows])
        return re4, im4

    def _translation_average(self, X):
        """(N, N) matrix -> (N,) c(d) = mean_i X[i, i + d]."""
        rows = jnp.arange(self.cfg.n_sites)[None, :]
        return X[rows, self.disp_idx].mean(axis=1)

    def _fermion_correlations(self, G):
        """Equal-time Wick-contracted correlators from the 4-orbital
        blocks (reference: DetSDW::measure's fermionic observable set).
        Returns a dict of (N,) vectors + per-band occupancies."""
        cfg = self.cfg
        N = cfg.n_sites
        re, im = self._phys_green_parts(G)                  # (4,4,N,N)
        eyeN = jnp.eye(N, dtype=cfg.jdtype)
        d4 = jnp.eye(4, dtype=cfg.jdtype)
        # A[o,o',i,j] = <c†_{o,i} c_{o',j}> = δ δ − G[o',o]_{ji}
        A_re = d4[:, :, None, None] * eyeN \
            - jnp.transpose(re, (1, 0, 3, 2))
        A_im = -jnp.transpose(im, (1, 0, 3, 2))
        n_oi = jnp.diagonal(A_re, axis1=-2, axis2=-1)       # (4, 4, N) diag
        n_oi = jnp.stack([n_oi[o, o] for o in range(4)])    # (4, N)
        n_i = n_oi.sum(axis=0)                              # (N,)
        # exchange term Re<c† c><c c†> summed over orbital pairs
        exch = lambda w: jnp.einsum(                        # noqa: E731
            "o,p,opij->ij", w, w,
            A_re * re - A_im * im, precision="highest")
        ones4 = jnp.ones((4,), cfg.jdtype)
        wz = jnp.asarray([0.5, -0.5, 0.5, -0.5], cfg.jdtype)
        exch_nn, exch_zz = exch(ones4), exch(wz)   # reused by the SFs below
        nn = n_i[:, None] * n_i[None, :] + exch_nn
        sz_i = jnp.einsum("o,on->n", wz, n_oi)
        szsz = sz_i[:, None] * sz_i[None, :] + exch_zz
        # onsite s-wave pairing Delta_i = sum_b c_{b dn, i} c_{b up, i}:
        # P = sum_{b,b'} [<c†_up c_up><c†_dn c_dn> - <c†_up c_dn><c†_dn
        # c_up>]; the direct term survives only band-diagonally (inter-
        # band same-spin pairs cross the decoupled sectors), while the
        # exchange term survives for the two cross-band pairs that stay
        # inside one sector ((x_up, y_dn) in A, (x_dn, y_up) in B)
        pair = jnp.zeros((N, N), cfg.jdtype)
        for up, dn in ((0, 1), (2, 3)):
            pair = pair + (A_re[up, up] * A_re[dn, dn]
                           - A_im[up, up] * A_im[dn, dn])
        for (a1, a2), (b1, b2) in (((0, 3), (1, 2)), ((2, 1), (3, 0))):
            pair = pair - (A_re[a1, a2] * A_re[b1, b2]
                           - A_im[a1, a2] * A_im[b1, b2])
        c_nn = self._translation_average(nn)
        c_zz = self._translation_average(szsz)
        c_pair = self._translation_average(pair)
        # k-resolved single-particle occupation per band (both spins):
        # n_o(k) = sum_d e^{-ik.d} c_o(d), c_o(d) = (1/N) sum_i
        # <c†_{o,i} c_{o,i+d}> — A is Hermitian so n(k) is real and the
        # sin part picks up c_o's imaginary plane (reference: DetSDW
        # measure()'s kOcc vectors, SURVEY.md §3 "SDW model"; VERDICT r4
        # missing #4). Works across all four fermion representations via
        # the physical-parts reconstruction above.
        kocc = []
        for orbs in ((0, 1), (2, 3)):
            cre = sum(self._translation_average(A_re[o, o]) for o in orbs)
            cim = sum(self._translation_average(A_im[o, o]) for o in orbs)
            kocc.append(mm(self.four_cos, cre[:, None])[:, 0]
                        + mm(self.four_sin, cim[:, None])[:, 0])
        # structure factors: FT of the connected (exchange) parts
        conn_nn = self._translation_average(exch_nn)
        conn_zz = self._translation_average(exch_zz)
        return {
            "chargeCorrelation": c_nn,
            "chargeStructureFactor": mm(self.four_cos,
                                        conn_nn[:, None])[:, 0],
            "spinZCorrelation": c_zz,
            "spinZStructureFactor": mm(self.four_cos,
                                       conn_zz[:, None])[:, 0],
            "pairingCorrelation": c_pair,
            "kOccupationX": kocc[0],
            "kOccupationY": kocc[1],
            "occupancyX": n_oi[0].mean() + n_oi[1].mean(),
            "occupancyY": n_oi[2].mean() + n_oi[3].mean(),
        }

    def _phi_correlations(self, phi):
        """Equal-time order-parameter observables, tau-averaged:
        S_phi(k) = (1/(mN)) sum_l |phi~_l(k)|^2 (summed over components)
        and its exact inverse FT c(d) = <phi_0 . phi_d>. Real cos/sin
        parts only (the embedded representation has no complex arrays)."""
        cfg = self.cfg
        N = cfg.n_sites
        ph = phi.astype(cfg.jdtype)                        # (m, N, opdim)
        C = jnp.einsum("kn,lno->lko", self.four_cos, ph,
                       precision="highest")
        S = jnp.einsum("kn,lno->lko", self.four_sin, ph,
                       precision="highest")
        sk = (C ** 2 + S ** 2).sum(-1).mean(0) / N         # (N,)
        cd = jnp.einsum("kd,k->d", self.four_cos, sk,
                        precision="highest") / N
        return cd, sk

    def measure(self, G, phi, phase, acc_rate) -> SDWObservables:
        cfg = self.cfg
        N = cfg.n_sites
        phi2 = jnp.sum(phi ** 2, axis=-1)                       # (m, N)
        phibar = phi.mean(axis=(0, 1))                          # (opdim,)
        chi = cfg.beta * N * jnp.sum(phibar ** 2)
        # embedded traces double-count (tr rho(G) = 2 Re tr G); the reduced
        # representation carries only sector A, whose conjugate sector B
        # contributes identically to every real trace -> x2
        tr_fac = 2.0 if self.embed else 1.0
        sector = 2.0 if self.reduced else 1.0
        G_re = G
        occ = (N_ORB - sector * jnp.real(jnp.trace(G_re)) / (tr_fac * N))
        # kinetic: sum_o tr(K_o G_o) with G_o the (N,N) diagonal block
        Gorb = G_re.reshape(self.n_orb, N, self.n_orb, N)
        e_kin = -sector * jnp.real(sum(
            jnp.sum(self.K_orb[o].T * Gorb[o, :, o, :])
            for o in range(self.n_orb))) / (tr_fac * N)
        phicorr, phisf = self._phi_correlations(phi)
        ferm = self._fermion_correlations(G)
        return SDWObservables(
            phiSquared=phi2.mean(),
            phiFourth=(phi2 ** 2).mean(),
            phiNorm=jnp.sqrt(phi2).mean(),
            sdwSusceptibility=chi,
            occupancy=occ,
            kineticEnergy=e_kin,
            bosonAction=self.boson_action(phi) / (cfg.m * N),
            exchangeAction=0.5 * cfg.dtau * jnp.sum(phi ** 2),
            phase=jnp.real(phase),
            acceptance=acc_rate,
            phiCorrelation=phicorr,
            phiStructureFactor=phisf,
            **ferm,
        )

    # ---- sweeps (same stack choreography as Hubbard) --------------------------
    def _sweep(self, state: SDWState, up: bool, measure: bool):
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        dim = self.dim
        cdt = self.cdtype
        sdt = self.stab_dtype_eff

        phi, G, key, phase = state.phi, state.G, state.key, state.phase
        box_w = state.box_width
        stack = (state.stack_U, state.stack_d, state.stack_V)
        eye_f = self._eye_mixed()

        def interval(carry, xs):
            G, lazy_U, d_c, V_c, phi, key, phase, dev, acc_sum, obs_sum = \
                carry
            k, entry_U, entry_d, entry_V = xs

            def slice_step(c, l_rel):
                G, lazy_U, phi, key, phase, acc_sum = c
                l = (k - 1) * s_int + 1 + l_rel if up else k * s_int - l_rel
                if up:
                    blocks_old = self.exp_v_blocks(phi[l - 1])
                    blocks_old_inv = self.exp_v_blocks(phi[l - 1],
                                                       sign=+1.0)
                    G = self.wrap_up(G, blocks_old, blocks_old_inv)
                G, phi, key, phase, acc = self.update_slice(
                    G, phi, l, key, phase, box_w, state.r,
                    alt=state.sweeps_done % 2)
                blocks_new = self.exp_v_blocks(phi[l - 1])
                if up:
                    lazy_U = self.b_mult_left(blocks_new, lazy_U)
                else:
                    blocks_new_inv = self.exp_v_blocks(phi[l - 1],
                                                       sign=+1.0)
                    lazy_U = self.bT_mult_left(blocks_new, lazy_U)
                    G = self.wrap_down(G, blocks_new, blocks_new_inv)
                return (G, lazy_U, phi, key, phase, acc_sum + acc), None

            (G, lazy_U, phi, key, phase, acc_sum), _ = jax.lax.scan(
                slice_step, (G, lazy_U, phi, key, phase, acc_sum),
                jnp.arange(s_int))

            f_new = self._refactor(lazy_U, d_c, V_c, compose_dtype=sdt)
            other = UDV(entry_U, entry_d, entry_V)
            if up:
                G_stab = self._green(f_new, other)
            else:
                G_stab = self._green(other, f_new)
            dev = jnp.maximum(dev, jnp.abs(G - G_stab).max())
            G = G_stab
            if measure:
                obs = self.measure(G, phi, phase, jnp.zeros((), cfg.jdtype))
                obs_sum = jax.tree.map(jnp.add, obs_sum, obs)
            carry = (G, f_new.U.astype(cdt), f_new.d, f_new.V, phi, key,
                     phase, dev, acc_sum, obs_sum)
            return carry, f_new

        ks = jnp.arange(1, K + 1) if up else jnp.arange(K, 0, -1)
        consumed_idx = ks if up else ks - 1
        consumed = tuple(a[consumed_idx] for a in stack)

        zero_obs = jax.tree.map(
            lambda a: jnp.zeros_like(a),
            self.measure(G, phi, phase, jnp.zeros((), cfg.jdtype)))
        rdt = jnp.zeros((), cfg.jdtype)
        carry0 = (G, eye_f.U.astype(cdt), eye_f.d, eye_f.V, phi, key,
                  phase, rdt, jnp.zeros((), cfg.jdtype), zero_obs)
        (G, _, _, _, phi, key, phase, dev, acc_sum, obs_sum), emitted = \
            jax.lax.scan(interval, carry0, (ks, *consumed))

        def assemble(entries, eye_leaf):
            if up:
                return jnp.concatenate([eye_leaf[None], entries], axis=0)
            return jnp.concatenate([jnp.flip(entries, axis=0),
                                    eye_leaf[None]], axis=0)

        newU = assemble(emitted.U, eye_f.U.astype(emitted.U.dtype))
        newd = assemble(emitted.d, eye_f.d)
        newV = assemble(emitted.V, eye_f.V)

        logd = jnp.log10(jnp.maximum(emitted.d, 1e-38))
        new_state = SDWState(
            phi=phi, G=G,
            stack_U=newU, stack_d=newd, stack_V=newV,
            key=key, phase=phase, box_width=box_w, r=state.r,
            next_dir=jnp.asarray(1 if up else 0, jnp.int32),
            sweeps_done=state.sweeps_done + 1,
            green_dev=dev.astype(jnp.float32),
            sv_min=logd.min().astype(jnp.float32),
            sv_max=logd.max().astype(jnp.float32),
        )
        n_meas = jnp.asarray(K, cfg.jdtype)
        obs_mean = jax.tree.map(lambda a: a / n_meas, obs_sum)
        obs_mean = obs_mean._replace(
            acceptance=acc_sum / jnp.asarray(cfg.m, cfg.jdtype),
            # single-configuration sample (final field), NOT the interval
            # average — see SDWObservables.exchangeAction
            exchangeAction=0.5 * cfg.dtau * jnp.sum(phi ** 2))
        return new_state, obs_mean

    def sweep_up(self, state, measure=False):
        return self._sweep(state, up=True, measure=measure)

    def sweep_down(self, state, measure=False):
        return self._sweep(state, up=False, measure=measure)

    def sweep_pair(self, state, measure: bool):
        state, o1 = self._sweep(state, up=True, measure=measure)
        state, o2 = self._sweep(state, up=False, measure=measure)
        obs = jax.tree.map(lambda a, b: 0.5 * (a + b), o1, o2)
        # keep the pair-final single-configuration action (no averaging)
        obs = obs._replace(exchangeAction=o2.exchangeAction)
        return state, obs

    # ---- naive cross-check sweep ---------------------------------------------
    def green_at_slice(self, phi: jax.Array, l: int) -> jax.Array:
        """Stabilized G(l) rebuilt from the field alone with a refactor at
        EVERY slice — the naive recompute primitive behind sweep_simple
        (reference: DetModelGC::sweepSimple, SURVEY.md §5 item 2). ``l``
        is a static int in 0..m."""
        cfg = self.cfg
        sdt = self.stab_dtype_eff
        left = self._eye_mixed()
        for j in range(1, l + 1):
            M = self.b_mult_left(self.exp_v_blocks(phi[j - 1]),
                                 left.U.astype(self.cdtype))
            left = self._refactor(M, left.d, left.V, compose_dtype=sdt)
        right = self._eye_mixed()
        for j in range(cfg.m, l, -1):
            M = self.bT_mult_left(self.exp_v_blocks(phi[j - 1]),
                                  right.U.astype(self.cdtype))
            right = self._refactor(M, right.d, right.V, compose_dtype=sdt)
        return self._green(left, right)

    def sweep_simple(self, state: SDWState, measure: bool = False):
        """Naive up sweep: from-scratch stabilized G at every slice + the
        same per-site updates on the same RNG stream as sweep_up, so both
        paths walk the SAME Markov chain and any disagreement indicts the
        wrap/stack machinery (reference: sweepSimple vs sweep, SURVEY.md
        §5 item 2). O(m^2) refactors — cross-check only."""
        cfg = self.cfg
        dt = cfg.jdtype
        phi, key, phase = state.phi, state.key, state.phase
        box_w = state.box_width
        acc_sum = jnp.zeros((), dt)
        obs_sum = jax.tree.map(
            lambda a: jnp.zeros_like(a),
            self.measure(state.G, phi, phase, jnp.zeros((), dt)))
        for l in range(1, cfg.m + 1):
            G = self.green_at_slice(phi, l)         # fresh, pre-update
            G, phi, key, phase, acc = self.update_slice(
                G, phi, l, key, phase, box_w, state.r,
                alt=state.sweeps_done % 2)
            acc_sum = acc_sum + acc
            if measure and l % cfg.s == 0:
                obs = self.measure(G, phi, phase, jnp.zeros((), dt))
                obs_sum = jax.tree.map(jnp.add, obs_sum, obs)
        refreshed = self.refresh_from_field(
            state._replace(phi=phi, key=key))
        new_state = refreshed._replace(
            phase=phase, sweeps_done=state.sweeps_done + 1)
        obs_mean = jax.tree.map(
            lambda a: a / jnp.asarray(cfg.n_stack, dt), obs_sum)
        obs_mean = obs_mean._replace(
            acceptance=acc_sum / jnp.asarray(cfg.m, dt),
            exchangeAction=0.5 * cfg.dtau * jnp.sum(phi ** 2))
        return new_state, obs_mean

    # ---- global moves ----------------------------------------------------------
    def attempt_global_shift(self, state: SDWState):
        """phi -> phi + delta everywhere; Metropolis with full stabilized
        determinant recompute (reference: attemptGlobalShiftMove)."""
        cfg = self.cfg
        key, k_d, k_a = jax.random.split(state.key, 3)
        delta = jax.random.normal(k_d, (cfg.opdim,), dtype=cfg.jdtype) \
            * state.box_width
        phi_new = state.phi + delta
        dS = (self.boson_action(phi_new, state.r)
              - self.boson_action(state.phi, state.r))
        if cfg.turnoffFermions:
            log_ratio = -dS
        else:
            ld_old, _ = self._chain_logdet(state.phi)
            ld_new, _ = self._chain_logdet(phi_new)
            log_ratio = self.logdet_fac * (ld_new - ld_old) - dS
        accept = jnp.log(jax.random.uniform(
            k_a, (), dtype=cfg.jdtype)) < log_ratio
        phi = jnp.where(accept, phi_new, state.phi)
        st = state._replace(phi=phi, key=key)
        return self.refresh_from_field(st), accept

    def _grow_wolff_cluster(self, phi, e, k_seed, k_bonds):
        """Wolff cluster on the (m, N) space-time lattice for reflection
        axis e: bonds activate with p = 1 - exp(min(0, -2 K_bond s_i s_j)),
        s = phi . e, K_spatial = dtau, K_temporal = 1/(c^2 dtau).

        Vectorized: the data-dependent growth is a bounded
        ``lax.while_loop`` frontier expansion on (m, N) boolean masks —
        each iteration processes ALL frontier bonds at once."""
        cfg = self.cfg
        m, N = cfg.m, cfg.n_sites
        s = jnp.einsum("lno,o->ln", phi, e)                # (m, N)
        seed = jax.random.randint(k_seed, (2,), 0,
                                  jnp.asarray([m, N]))
        in_cluster = jnp.zeros((m, N), bool).at[seed[0], seed[1]].set(True)

        k_sp = cfg.dtau
        k_tau = 1.0 / (cfg.c ** 2 * cfg.dtau)
        nb = self.nb                                        # (N, 4)

        def neighbors_of(mask):
            outs = []
            for d in range(4):                              # spatial
                outs.append((mask[:, nb[:, d]], k_sp))
            outs.append((jnp.roll(mask, 1, axis=0), k_tau))   # tau +
            outs.append((jnp.roll(mask, -1, axis=0), k_tau))  # tau -
            return outs

        def body(carry):
            in_c, frontier, key = carry
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (6, m, N), dtype=cfg.jdtype)
            new = jnp.zeros((m, N), bool)
            for d, (reach, kb) in enumerate(neighbors_of(frontier)):
                # bond (x in frontier) -- (y here): s_x values arrive
                # aligned with y via the same neighbor map
                if d < 4:
                    s_from = s[:, nb[:, d]]
                elif d == 4:
                    s_from = jnp.roll(s, 1, axis=0)
                else:
                    s_from = jnp.roll(s, -1, axis=0)
                p = 1.0 - jnp.exp(jnp.minimum(0.0, -2.0 * kb * s * s_from))
                add = reach & (~in_c) & (u[d] < p)
                new = new | add
            return in_c | new, new & (~in_c), key

        def cond(carry):
            _in_c, frontier, _key = carry
            return frontier.any()

        in_cluster, _, _ = jax.lax.while_loop(
            cond, body, (in_cluster, in_cluster, k_bonds))
        # reflected field: phi -> phi - 2 (phi.e) e inside the cluster
        refl = phi - 2.0 * s[..., None] * e[None, None, :]
        phi_refl = jnp.where(in_cluster[..., None], refl, phi)
        return in_cluster, phi_refl

    def attempt_wolff_update(self, state: SDWState):
        """Embedded O(n) Wolff cluster reflection (reference:
        attemptWolffClusterUpdate, SURVEY.md §9 "Wolff").

        The cluster construction balances the gradient/tau bond terms and
        the r/u terms are reflection-invariant, so only the fermion
        determinant enters the Metropolis accept (full stabilized
        recompute, like the reference)."""
        cfg = self.cfg
        key, k_axis, k_seed, k_bonds, k_acc = jax.random.split(state.key, 5)
        e = jax.random.normal(k_axis, (cfg.opdim,), dtype=cfg.jdtype)
        e = e / jnp.sqrt(jnp.sum(e ** 2))
        in_cluster, phi_new = self._grow_wolff_cluster(
            state.phi, e, k_seed, k_bonds)

        if cfg.turnoffFermions:
            accept = jnp.asarray(True)
        else:
            ld_old, _ = self._chain_logdet(state.phi)
            ld_new, _ = self._chain_logdet(phi_new)
            accept = jnp.log(jax.random.uniform(
                k_acc, (), dtype=cfg.jdtype)) \
                < self.logdet_fac * (ld_new - ld_old)
        phi = jnp.where(accept, phi_new, state.phi)
        st = state._replace(phi=phi, key=key)
        return self.refresh_from_field(st), accept, in_cluster.sum()

    def attempt_wolff_shift_update(self, state: SDWState):
        """Compound cluster-reflection + global-shift move (reference:
        wolffClusterShiftUpdate, SURVEY.md §3 "SDW model").

        The shift delta is drawn PERPENDICULAR to the reflection axis e:
        then (i) s = phi . e is shift-invariant, so the cluster bond
        probabilities are identical for the forward and reverse moves
        (the construction stays balanced), and (ii) reflection and shift
        commute. Gradient/tau terms are invariant under the uniform
        shift (differences) and balanced by the cluster for the
        reflection, so the acceptance carries only the r/u potential
        difference plus the full stabilized fermion determinant ratio."""
        cfg = self.cfg
        key, k_axis, k_seed, k_bonds, k_d, k_acc = jax.random.split(
            state.key, 6)
        e = jax.random.normal(k_axis, (cfg.opdim,), dtype=cfg.jdtype)
        e = e / jnp.sqrt(jnp.sum(e ** 2))
        g = jax.random.normal(k_d, (cfg.opdim,), dtype=cfg.jdtype) \
            * state.box_width
        delta = g - jnp.sum(g * e) * e                  # delta . e = 0
        in_cluster, phi_refl = self._grow_wolff_cluster(
            state.phi, e, k_seed, k_bonds)
        phi_new = phi_refl + delta

        # r/u potential difference (gradient/tau terms cancel or are
        # balanced by the cluster construction)
        def s_pot(phi):
            phi2 = jnp.sum(phi ** 2, axis=-1)
            return cfg.dtau * (0.5 * state.r * jnp.sum(phi2)
                               + 0.25 * cfg.u * jnp.sum(phi2 ** 2))

        dS = s_pot(phi_new) - s_pot(state.phi)
        if cfg.turnoffFermions:
            log_ratio = -dS
        else:
            ld_old, _ = self._chain_logdet(state.phi)
            ld_new, _ = self._chain_logdet(phi_new)
            log_ratio = self.logdet_fac * (ld_new - ld_old) - dS
        accept = jnp.log(jax.random.uniform(
            k_acc, (), dtype=cfg.jdtype)) < log_ratio
        phi = jnp.where(accept, phi_new, state.phi)
        st = state._replace(phi=phi, key=key)
        return self.refresh_from_field(st), accept, in_cluster.sum()

    def global_moves(self, state: SDWState) -> SDWState:
        """Configured global updates; the driver fires this every
        globalUpdateInterval sweeps (reference semantics) via per-block
        fire flags."""
        if self.cfg.globalShift:
            state, _ = self.attempt_global_shift(state)
        if self.cfg.wolffClusterUpdate:
            state, _, _ = self.attempt_wolff_update(state)
        if self.cfg.wolffClusterShiftUpdate:
            state, _, _ = self.attempt_wolff_shift_update(state)
        return state

    @property
    def has_global_moves(self) -> bool:
        return (self.cfg.globalShift or self.cfg.wolffClusterUpdate
                or self.cfg.wolffClusterShiftUpdate)

    def _chain_logdet(self, phi):
        """log|det(1 + B_m...B_1)| via the factored chain."""
        from detqmc.linalg.udv import log_det_one_plus_udv
        stack = self._build_right_stack(phi)
        full_t = UDV(stack.U[0], stack.d[0], stack.V[0])
        return log_det_one_plus_udv(UDV(
            full_t.U, full_t.d, full_t.V.astype(full_t.U.dtype)))

    # ---- parallel tempering hooks -------------------------------------------
    # the parameter the PT exchange swaps (reference: the SDW tuning
    # parameter r; PTConfig.control_parameter is validated against this)
    control_parameter = "r"

    def exchange_action(self, state: "SDWState") -> jax.Array:
        """The r-conjugate action piece a = dS/dr = dtau/2 sum phi^2 —
        the only term that moves in a parameter swap (the fermion
        determinant is r-independent; reference/SURVEY.md §9)."""
        return 0.5 * self.cfg.dtau * jnp.sum(state.phi ** 2)

    def with_r(self, state: "SDWState", r) -> "SDWState":
        return state._replace(r=jnp.asarray(r, self.cfg.jdtype))

    def log_weight(self, phi, r=None) -> jax.Array:
        """Full configuration log-weight log w(phi) = logdet_fac *
        log|det chain| - S_B[phi], up to a phi-independent constant.

        Used by det-coupled parallel tempering (parallel/det_pt.py):
        swapping configurations between replicas whose DETERMINANT
        depends on the tempered parameter (beta/dtau, lambda, u)
        requires the full weight at both parameter values — unlike the
        action-linear r/stagger_h swaps the reference's bosonic-only
        exchange formula covers (SURVEY.md §9 "Parallel tempering";
        src/detqmcpt.h). Cost: one stabilized chain build + log-det
        (the same class as a global-move accept)."""
        ld, _ = self._chain_logdet(phi)
        return self.logdet_fac * ld - self.boson_action(phi, r)

    # ---- setup -------------------------------------------------------------------
    def _eye_mixed(self):
        cfg = self.cfg
        dim, cdt, sdt = self.dim, self.cdtype, self.stab_dtype_eff
        d = jnp.ones((dim,), jnp.finfo(sdt).dtype)
        eye_c = jnp.eye(dim, dtype=cdt)
        eye_s = jnp.eye(dim, dtype=sdt)
        return UDV(eye_c, d, eye_s)

    def _build_right_stack(self, phi):
        """Right (transposed) stack entries from the field. Returns list
        indexed by position k = 0..K (entry K = identity); entry 0 is the
        full transposed chain."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        eye_f = self._eye_mixed()
        sdt = self.stab_dtype_eff

        def build_interval(f_carry, k):
            def absorb(lazy_U, l_rel):
                l = k * s_int - l_rel
                blocks = self.exp_v_blocks(phi[l - 1])
                return self.bT_mult_left(blocks, lazy_U), None

            lazy_U, _ = jax.lax.scan(absorb, f_carry.U.astype(self.cdtype),
                                     jnp.arange(s_int))
            f_new = self._refactor(lazy_U, f_carry.d, f_carry.V,
                                   compose_dtype=sdt)
            return f_new, f_new

        _, emitted = jax.lax.scan(build_interval, eye_f,
                                  jnp.arange(K, 0, -1))
        newU = jnp.concatenate(
            [jnp.flip(emitted.U, axis=0),
             eye_f.U[None].astype(emitted.U.dtype)], axis=0)
        newd = jnp.concatenate([jnp.flip(emitted.d, axis=0),
                                eye_f.d[None]], axis=0)
        newV = jnp.concatenate([jnp.flip(emitted.V, axis=0),
                                eye_f.V[None]], axis=0)
        return UDV(newU, newd, newV)

    def _build_left_stack(self, phi):
        """Straight stack entries k = 0..K: B_{ks}..B_1 (identity at 0) —
        the forward-propagator half for time-displaced Greens."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        eye_f = self._eye_mixed()
        sdt = self.stab_dtype_eff

        def build_interval(f_carry, k):
            def absorb(lazy_U, l_rel):
                l = (k - 1) * s_int + 1 + l_rel
                blocks = self.exp_v_blocks(phi[l - 1])
                return self.b_mult_left(blocks, lazy_U), None

            lazy_U, _ = jax.lax.scan(absorb, f_carry.U.astype(self.cdtype),
                                     jnp.arange(s_int))
            f_new = self._refactor(lazy_U, f_carry.d, f_carry.V,
                                   compose_dtype=sdt)
            return f_new, f_new

        _, emitted = jax.lax.scan(build_interval, eye_f,
                                  jnp.arange(1, K + 1))
        U = jnp.concatenate([eye_f.U[None].astype(emitted.U.dtype),
                             emitted.U])
        d = jnp.concatenate([eye_f.d[None], emitted.d])
        V = jnp.concatenate([eye_f.V[None], emitted.V])
        return UDV(U, d, V)

    def _td_solver(self):
        """The stable dense-RHS solver gtz(left, right_t) =
        [1 + A C]^{-1} A used by every unequal-time path."""
        from detqmc.linalg.udv import green_tau_zero

        return lambda l_, r_: green_tau_zero(
            l_, r_, compute_dtype=self.stab_dtype_eff)

    def time_displaced_greens(self, phi) -> jax.Array:
        """Stable G(tau = k s dtau, 0) for k = 0..K: (K+1, dim, dim)
        (reference: the SDW model's unequal-time Green support; tau on the
        stabilization grid, same approach as hubbard.time_displaced_greens
        — both half-chain stacks built fresh, one batched stable solve)."""
        left = self._build_left_stack(phi)
        right_t = self._build_right_stack(phi)
        return self._td_solver()(left, right_t)

    def _neg_conj_transpose(self, G):
        """-G^H in whatever representation the chain runs: a plain
        transpose in the rho embedding (rho(M^H) = rho(M)^T), jnp.conj
        for complex arrays."""
        T = lambda M: jnp.swapaxes(M, -1, -2)  # noqa: E731
        if jnp.issubdtype(G.dtype, jnp.complexfloating):
            return -jnp.conj(T(G))
        return -T(G)

    def time_displaced_greens_rev(self, phi) -> jax.Array:
        """Stable G(0, tau = k s dtau) at the anchors: with A = B(tau,0)
        and C = B(beta,tau), G(0,tau) = -(1 + C A)^{-1} C =
        -[gtz(right_t, left)]^H — the swapped-stack solve, no new
        kernel (reference: the TimeDisplaced path's backward propagator,
        SURVEY.md §3 "DQMC core", §9 "Unequal-time")."""
        left = self._build_left_stack(phi)
        right_t = self._build_right_stack(phi)
        return self._neg_conj_transpose(self._td_solver()(right_t, left))

    def time_displaced_greens_rev_all(self, phi):
        """G(0, tau) at EVERY slice tau = 0..m, plus the max wrap
        deviation: anchors from the swapped-stack solve, then
        G(0, tau+1) = G(0, tau) B_{tau+1}^{-1} between anchors (mirror
        of time_displaced_greens_all)."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        anchors = self.time_displaced_greens_rev(phi)
        inv_all = jax.vmap(
            lambda p: self.exp_v_blocks(p, sign=+1.0))(phi)

        def interval(_, xs):
            g0, g_next, blk_k = xs

            def wrap(G, j):
                G = self.b_inv_mult_right(G, blk_k[j])
                return G, G

            g_last, wrapped = jax.lax.scan(wrap, g0,
                                           jnp.arange(s_int - 1))
            g_end, _ = wrap(g_last, s_int - 1)
            dev = jnp.abs(g_end - g_next).max()
            out = jnp.concatenate([g0[None], wrapped], axis=0)
            return None, (out, dev)

        blk = inv_all.reshape((K, s_int) + inv_all.shape[1:])
        _, (blocks, devs) = jax.lax.scan(
            interval, None, (anchors[:K], anchors[1:], blk))
        G_all = jnp.concatenate(
            [blocks.reshape((K * s_int,) + anchors.shape[1:]),
             anchors[K][None]], axis=0)
        return G_all, devs.max()

    def time_displaced_greens_all(self, phi):
        """G(tau, 0) at EVERY slice tau = 0..m: (m+1, dim, dim), plus the
        max wrap deviation against the stabilized anchors (reference:
        the TimeDisplaced path resolves all m slices by B-wrapping
        between stabilization points, SURVEY.md §3 "DQMC core", §9
        "Unequal-time"; same scheme as hubbard.time_displaced_greens_all)."""
        cfg = self.cfg
        K, s_int = cfg.n_stack, cfg.s
        anchors = self.time_displaced_greens(phi)     # (K+1, dim, dim)
        blocks_all = jax.vmap(self.exp_v_blocks)(phi)  # (m, N, q, q)

        def interval(_, xs):
            g0, g_next, blk_k = xs                    # blk_k: (s, N, q, q)

            def wrap(G, j):
                G = self.b_mult_left(blk_k[j], G)
                return G, G

            g_last, wrapped = jax.lax.scan(wrap, g0,
                                           jnp.arange(s_int - 1))
            g_end, _ = wrap(g_last, s_int - 1)
            dev = jnp.abs(g_end - g_next).max()
            out = jnp.concatenate([g0[None], wrapped], axis=0)
            return None, (out, dev)

        blk = blocks_all.reshape((K, s_int) + blocks_all.shape[1:])
        _, (blocks, devs) = jax.lax.scan(
            interval, None, (anchors[:K], anchors[1:], blk))
        G_all = jnp.concatenate(
            [blocks.reshape((K * s_int,) + anchors.shape[1:]),
             anchors[K][None]], axis=0)
        return G_all, devs.max()

    def pair_susceptibilities(self, G_tau):
        """tau-integrated onsite s-wave and d_{x2-y2}-wave pairing
        susceptibilities from per-slice G(tau, 0), for the same pair
        operator as the equal-time pairingCorrelation:
        Delta_i = sum_b c_{b dn, i} c_{b up, i}. Wick at fixed phi:

            <Delta_i(tau) Delta_j+(0)> = Re[ G00 G11 + G22 G33
                                            - G03 G12 - G21 G30 ]_ij

        in the physical orbital basis (x_up, x_dn, y_up, y_dn) — these
        are the four contractions that survive the two decoupled fermion
        sectors A = (x_up, y_dn), B = (x_dn, y_up). The d-wave form
        factor dresses the dn operators: a row matmul with D where a
        factor annihilates a dn orbital, a column matmul with D^T where
        it creates one — exactly one D and one D^T per term, all matmul
        work. Reference observable class: unequal-time pairing
        correlators near the SDW QCP (SURVEY.md §1 "pairing and current
        correlators"). Returns (P_s, P_d) scalars; trapezoid over all
        m+1 slices (driver flag timedisplacedSlices)."""
        cfg = self.cfg
        D = self._dwave_D
        # ((ann1, cre1), (ann2, cre2), sign): dn orbitals are odd
        terms = (((0, 0), (1, 1), 1.0), ((2, 2), (3, 3), 1.0),
                 ((0, 3), (1, 2), -1.0), ((2, 1), (3, 0), -1.0))

        def one(G):
            re, im = self._phys_green_parts(G)          # (4, 4, N, N)
            ps = jnp.zeros((), cfg.jdtype)
            pd = jnp.zeros((), cfg.jdtype)
            for (a1, c1), (a2, c2), sgn in terms:
                r1, i1 = re[a1, c1], im[a1, c1]
                r2, i2 = re[a2, c2], im[a2, c2]
                ps = ps + sgn * jnp.sum(r1 * r2 - i1 * i2)

                def dress(r_, i_, ann, cre):
                    if ann % 2 == 1:
                        r_, i_ = D @ r_, D @ i_
                    if cre % 2 == 1:
                        r_, i_ = r_ @ D.T, i_ @ D.T
                    return r_, i_

                r1d, i1d = dress(r1, i1, a1, c1)
                r2d, i2d = dress(r2, i2, a2, c2)
                pd = pd + sgn * jnp.sum(r1d * r2d - i1d * i2d)
            return ps, pd

        ps_l, pd_l = jax.vmap(one)(G_tau)               # (m+1,) each
        w = jnp.full((cfg.m + 1,), cfg.dtau, ps_l.dtype)
        w = w.at[0].mul(0.5).at[-1].mul(0.5)            # trapezoid
        return (w @ ps_l) / cfg.n_sites, (w @ pd_l) / cfg.n_sites

    def measure_time_displaced(self, state: SDWState,
                               per_slice: bool = False,
                               susceptibilities: bool = False):
        """Momentum-diagonal G(k, tau) averaged over the 4 physical
        orbitals: (K+1, N) real on the stabilization grid, or (m+1, N)
        at every slice with ``per_slice`` (returned with the
        wrap-deviation monitor). ``susceptibilities`` (needs
        ``per_slice``) additionally returns the tau-integrated pairing
        susceptibilities from the same per-slice Greens."""
        if per_slice:
            G_tau, dev = self.time_displaced_greens_all(state.phi)
        else:
            if susceptibilities:
                raise ValueError("susceptibilities need per_slice=True "
                                 "(trapezoid over every tau slice)")
            G_tau = self.time_displaced_greens(state.phi)
        Fc, Fs = self.four_cos, self.four_sin

        def project(G):
            re, im = self._phys_green_parts(G)          # (4,4,N,N)
            g = jnp.zeros((self.cfg.n_sites,), self.cfg.jdtype)
            for o in range(4):
                gr, gi = re[o, o], im[o, o]
                # Re (F G F^H)_kk with F = exp(-i k r): cos/sin split
                g = g + jnp.einsum("ki,ij,kj->k", Fc, gr, Fc,
                                   precision="highest")
                g = g + jnp.einsum("ki,ij,kj->k", Fs, gr, Fs,
                                   precision="highest")
                g = g + jnp.einsum("ki,ij,kj->k", Fs, gi, Fc,
                                   precision="highest")
                g = g - jnp.einsum("ki,ij,kj->k", Fc, gi, Fs,
                                   precision="highest")
            return g / (4.0 * self.cfg.n_sites)

        gk = jax.vmap(project)(G_tau)
        if susceptibilities:
            ps, pd = self.pair_susceptibilities(G_tau)
            return gk, dev, ps, pd
        if per_slice:
            return gk, dev
        return gk

    def refresh_from_field(self, state: SDWState) -> SDWState:
        cfg = self.cfg
        stack = self._build_right_stack(state.phi)
        full_t = UDV(stack.U[0], stack.d[0], stack.V[0])
        G = self._green(self._eye_mixed(), full_t)
        return state._replace(
            G=G, stack_U=stack.U, stack_d=stack.d, stack_V=stack.V,
            next_dir=jnp.asarray(0, jnp.int32))

    def init_state(self, key: jax.Array) -> SDWState:
        cfg = self.cfg
        key, k_phi = jax.random.split(key)
        phi = jax.random.normal(
            k_phi, (cfg.m, cfg.n_sites, cfg.opdim), dtype=cfg.jdtype) * 0.5
        dim, cdt, sdt = self.dim, self.cdtype, self.stab_dtype_eff
        K = cfg.n_stack
        rdt = jnp.finfo(sdt).dtype
        mshape = (dim, dim)
        state0 = SDWState(
            phi=phi,
            G=jnp.zeros(mshape, cdt),
            stack_U=jnp.zeros((K + 1, *mshape), cdt),
            stack_d=jnp.zeros((K + 1, dim), rdt),
            stack_V=jnp.zeros((K + 1, *mshape), sdt),
            key=key,
            phase=jnp.ones((), cdt),
            box_width=jnp.asarray(cfg.box_width, cfg.jdtype),
            r=jnp.asarray(cfg.r, cfg.jdtype),
            next_dir=jnp.asarray(0, jnp.int32),
            sweeps_done=jnp.asarray(0, jnp.int32),
            green_dev=jnp.zeros((), jnp.float32),
            sv_min=jnp.zeros((), jnp.float32),
            sv_max=jnp.zeros((), jnp.float32),
        )
        return self.refresh_from_field(state0)
