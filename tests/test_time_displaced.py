"""Unequal-time Green functions vs oracle and closed forms."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detqmc.models.hubbard import HubbardConfig, HubbardModel
from tests.oracle.hubbard_oracle import HubbardOracle


def test_free_fermion_time_displaced():
    """U=0: G(tau,0) = expK^{tau/dtau} (1 + expK^m)^{-1} exactly."""
    cfg = HubbardConfig(L=4, U=0.0, beta=2.0, m=20, s=4, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))
    G_tau = np.asarray(model.time_displaced_greens(state.field))
    expK = np.asarray(model.prop.expK, np.float64)
    full = np.linalg.matrix_power(expK, cfg.m)
    G0 = np.linalg.inv(np.eye(cfg.n_sites) + full)
    for k in range(cfg.n_stack + 1):
        expected = np.linalg.matrix_power(expK, k * cfg.s) @ G0
        np.testing.assert_allclose(G_tau[k, 0], expected, atol=1e-10,
                                   err_msg=f"k={k}")


def test_interacting_time_displaced_vs_oracle():
    """Fixed random field: G(tau,0) matches the naive fp64 product."""
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64",
                        ph_symmetry="off")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(1))
    oracle = HubbardOracle(L=2, U=4.0, beta=2.0, m=16)
    s_field = np.asarray(state.field)
    G_tau = np.asarray(model.time_displaced_greens(state.field))
    for comp, spin in [(0, +1), (1, -1)]:
        full = oracle.b_chain(s_field, spin, 0, cfg.m)
        G0 = np.linalg.inv(np.eye(cfg.n_sites) + full)
        for k in range(cfg.n_stack + 1):
            expected = oracle.b_chain(s_field, spin, 0, k * cfg.s) @ G0
            np.testing.assert_allclose(
                G_tau[k, comp], expected, atol=1e-8,
                err_msg=f"k={k} spin={spin}")


def test_gk_tau_properties():
    """G(k, tau=0) diagonal equals the fourier equal-time occupancy and
    values decay with tau at U=0 for k away from the Fermi surface."""
    cfg = HubbardConfig(L=4, U=0.0, beta=4.0, m=40, s=4, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(2))
    gk = np.asarray(model.measure_time_displaced(state))
    assert gk.shape == (cfg.n_stack + 1, cfg.n_sites)
    # at U=0: G(k, tau) = e^{-tau eps_k} / (1 + e^{-beta eps_k}), exact
    K = model.lat.hopping_matrix(cfg.t)
    # our k-grid diagonalizes K with eigenvalue eps_k = -2t(cos kx + cos ky)
    kgrid = model.lat.k_grid()
    eps = -2.0 * (np.cos(kgrid[:, 0]) + np.cos(kgrid[:, 1]))
    for k_stack in range(cfg.n_stack + 1):
        tau = k_stack * cfg.s * cfg.dtau
        expected = np.exp(-tau * eps) / (1.0 + np.exp(-cfg.beta * eps))
        np.testing.assert_allclose(gk[k_stack], expected, atol=1e-9)

def test_ph_mode_time_displaced_matches_two_sector():
    """In ph mode the down sector of G(k, tau) is reconstructed from the
    exact particle-hole image G_dn(tau,0) = eta G_up(beta,tau)^T eta;
    the spin-averaged observable must match a two-sector run on the SAME
    field configuration elementwise."""
    import jax

    from detqmc.models.hubbard import HubbardConfig, HubbardModel

    kw = dict(L=2, U=4.0, mu=0.0, beta=2.0, m=16, s=4, dtype="float64")
    m2 = HubbardModel(HubbardConfig(**kw, ph_symmetry="off"))
    mp = HubbardModel(HubbardConfig(**kw, ph_symmetry="on"))
    key = jax.random.key(3)
    s2 = m2.init_state(key)
    sp = mp.init_state(key)  # same field draw (independent of ncomp)
    np.testing.assert_array_equal(np.asarray(s2.field), np.asarray(sp.field))
    gk2 = np.asarray(m2.measure_time_displaced(s2))
    gkp = np.asarray(mp.measure_time_displaced(sp))
    np.testing.assert_allclose(gkp, gk2, atol=1e-9)
    # both sectors present: the raw greens stack to (K+1, 2, N, N)
    G = np.asarray(mp.time_displaced_greens(sp.field))
    assert G.shape[1] == 2


def test_sdw_time_displaced_free_fermion_limit():
    """lam = 0 decouples the fermions: B_l = expK exactly, so
    G(k, tau) = e^{-tau(eps-mu)} / (1 + e^{-beta(eps-mu)}) per band."""
    import jax

    from detqmc.models.sdw import SDWConfig, SDWModel

    cfg = SDWConfig(L=4, opdim=2, lam=0.0, mu=-0.5, beta=2.0, m=16, s=4,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(2))
    gk = np.asarray(model.measure_time_displaced(state))   # (K+1, N)

    k = model.lat.k_grid()                                  # (N, 2)
    eps_x = -2 * cfg.txhor * np.cos(k[:, 0]) - 2 * cfg.txver * np.cos(k[:, 1])
    eps_y = -2 * cfg.tyhor * np.cos(k[:, 0]) - 2 * cfg.tyver * np.cos(k[:, 1])
    for ki, tau_idx in ((0, 0), (3, 1), (7, 2), (11, 4)):
        tau = tau_idx * cfg.s * cfg.dtau
        expect = 0.0
        for eps in (eps_x[ki], eps_y[ki]):
            e = eps - cfg.mu
            expect += np.exp(-tau * e) / (1.0 + np.exp(-cfg.beta * e))
        expect /= 2.0
        assert gk[tau_idx, ki] == pytest.approx(expect, abs=1e-9), \
            f"k={ki} tau_idx={tau_idx}"


def test_sdw_time_displaced_cross_representation():
    """Reduced and full representations give the same G(k, tau) for the
    same field (interacting case)."""
    import jax

    from detqmc.models.sdw import SDWConfig, SDWModel

    kw = dict(L=2, opdim=2, beta=2.0, m=8, s=2, dtype="float64")
    full = SDWModel(SDWConfig(**kw, fermion_matrix="full"))
    red = SDWModel(SDWConfig(**kw, fermion_matrix="reduced"))
    sf = full.init_state(jax.random.key(7))
    sr = red.init_state(jax.random.key(7))
    gf = np.asarray(full.measure_time_displaced(sf))
    gr = np.asarray(red.measure_time_displaced(sr))
    np.testing.assert_allclose(gr, gf, atol=1e-9)
    # tau = 0 consistency with the equal-time G
    re, im = red._phys_green_parts(sr.G)
    assert gf.shape == (kw["m"] // kw["s"] + 1, 4)


def test_per_slice_time_displaced_free_fermion():
    """per-slice resolution: U=0 gives G(tau,0) = expK^tau G0 at EVERY
    slice (not just the stabilization grid) — m+1 tau points."""
    cfg = HubbardConfig(L=4, U=0.0, beta=2.0, m=20, s=4, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))
    G_all, dev = model.time_displaced_greens_all(state.field)
    G_all = np.asarray(G_all)
    assert G_all.shape[0] == cfg.m + 1
    assert float(dev) < 1e-10
    expK = np.asarray(model.prop.expK, np.float64)
    full = np.linalg.matrix_power(expK, cfg.m)
    G0 = np.linalg.inv(np.eye(cfg.n_sites) + full)
    for tau in range(cfg.m + 1):
        expected = np.linalg.matrix_power(expK, tau) @ G0
        np.testing.assert_allclose(G_all[tau, 0], expected, atol=1e-10,
                                   err_msg=f"tau={tau}")


def test_per_slice_time_displaced_vs_oracle():
    """Fixed random field, interacting: per-slice G(tau,0) matches the
    naive fp64 product B(tau,0) G(0) at every tau, both sectors
    (reference: the TimeDisplaced path resolves all m slices)."""
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64",
                        ph_symmetry="off")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(1))
    oracle = HubbardOracle(L=2, U=4.0, beta=2.0, m=16)
    s_field = np.asarray(state.field)
    G_all, dev = model.time_displaced_greens_all(state.field)
    G_all = np.asarray(G_all)
    assert float(dev) < 1e-8
    for comp, spin in [(0, +1), (1, -1)]:
        full = oracle.b_chain(s_field, spin, 0, cfg.m)
        G0 = np.linalg.inv(np.eye(cfg.n_sites) + full)
        for tau in range(cfg.m + 1):
            expected = oracle.b_chain(s_field, spin, 0, tau) @ G0
            np.testing.assert_allclose(
                G_all[tau, comp], expected, atol=1e-8,
                err_msg=f"tau={tau} spin={spin}")


def test_per_slice_ph_mode_matches_two_sector():
    """ph mode per-slice: the reconstructed+wrapped down sector matches
    the two-sector run on the same field at every slice."""
    kw = dict(L=2, U=4.0, mu=0.0, beta=2.0, m=16, s=4, dtype="float64")
    m2 = HubbardModel(HubbardConfig(**kw, ph_symmetry="off"))
    mp = HubbardModel(HubbardConfig(**kw, ph_symmetry="on"))
    key = jax.random.key(3)
    s2 = m2.init_state(key)
    sp = mp.init_state(key)
    gk2, dev2 = m2.measure_time_displaced(s2, per_slice=True)
    gkp, devp = mp.measure_time_displaced(sp, per_slice=True)
    assert np.asarray(gk2).shape == (kw["m"] + 1, 4)
    np.testing.assert_allclose(np.asarray(gk2), np.asarray(gkp),
                               atol=1e-8)


def test_per_slice_time_displaced_sdw():
    """SDW per-slice G(tau,0): matches the naive fp64 product
    B(tau,0) G(0) built from the model's own B applies."""
    from detqmc.models.sdw import SDWConfig, SDWModel

    cfg = SDWConfig(L=2, opdim=2, r=0.5, beta=1.0, m=8, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(4))
    G_all, dev = model.time_displaced_greens_all(state.phi)
    G_all = np.asarray(G_all)
    assert G_all.shape[0] == cfg.m + 1
    assert float(dev) < 1e-8
    G = np.asarray(G_all[0])
    for tau in range(1, cfg.m + 1):
        blocks = model.exp_v_blocks(state.phi[tau - 1])
        G = np.asarray(model.b_mult_left(blocks, jnp.asarray(G)))
        np.testing.assert_allclose(G_all[tau], G, atol=1e-8,
                                   err_msg=f"tau={tau}")
    # the projected observable carries the per-slice axis
    gk, dev2 = model.measure_time_displaced(state, per_slice=True)
    assert np.asarray(gk).shape == (cfg.m + 1, cfg.n_sites)


def _dwave_form_factor(lat) -> np.ndarray:
    """Independent d_{x2-y2} form-factor matrix from the lattice's
    neighbor table (+1 along x, -1 along y)."""
    N = lat.n_sites
    nbr = lat.neighbors()
    D = np.zeros((N, N))
    s = np.arange(N)
    np.add.at(D, (s, nbr[:, 0]), 1.0)
    np.add.at(D, (s, nbr[:, 1]), 1.0)
    np.add.at(D, (s, nbr[:, 2]), -1.0)
    np.add.at(D, (s, nbr[:, 3]), -1.0)
    return D


def test_pair_susceptibilities_free_fermion():
    """U=0 closed form: in the expK eigenbasis G(tau) = Q diag(g) Q^T
    with g_p(l) = a_p^l / (1 + a_p^m), so
        P_s = (1/N) sum_l w_l sum_p g_p(l)^2
    and the d-wave integral contracts the same spectral G against the
    form factor."""
    cfg = HubbardConfig(L=4, U=0.0, beta=2.0, m=16, s=4, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))
    G_all, _dev = model.time_displaced_greens_all(state.field)
    ps, pd = model.pair_susceptibilities(G_all)

    expK = np.asarray(model.prop.expK, np.float64)
    a, Q = np.linalg.eigh(expK)
    w = np.full(cfg.m + 1, cfg.dtau)
    w[0] *= 0.5
    w[-1] *= 0.5
    g = lambda l: a ** l / (1.0 + a ** cfg.m)  # noqa: E731
    ps_exp = sum(w[l] * float((g(l) ** 2).sum())
                 for l in range(cfg.m + 1)) / cfg.n_sites
    np.testing.assert_allclose(float(ps), ps_exp, rtol=1e-10)

    D = _dwave_form_factor(model.lat)
    pd_exp = 0.0
    for l in range(cfg.m + 1):
        G = (Q * g(l)) @ Q.T
        pd_exp += w[l] * float(np.sum(G * (D @ G @ D.T)))
    pd_exp /= cfg.n_sites
    np.testing.assert_allclose(float(pd), pd_exp, rtol=1e-8)
    assert ps_exp > 0.0 and pd_exp > 0.0  # free pair bubbles are positive


def test_pair_susceptibilities_interacting_oracle():
    """Fixed random field, interacting: the model's Wick contraction
    matches the same trapezoid evaluated in fp64 NumPy on brute-force
    B-product Greens."""
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64",
                        ph_symmetry="off")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(1))
    G_all, dev = model.time_displaced_greens_all(state.field)
    ps, pd = model.pair_susceptibilities(G_all)
    assert float(dev) < 1e-8

    oracle = HubbardOracle(L=2, U=4.0, beta=2.0, m=16)
    s_field = np.asarray(state.field)
    N = cfg.n_sites
    up, dn = [], []
    for spin, out in [(+1, up), (-1, dn)]:
        full = oracle.b_chain(s_field, spin, 0, cfg.m)
        G0 = np.linalg.inv(np.eye(N) + full)
        for tau in range(cfg.m + 1):
            out.append(oracle.b_chain(s_field, spin, 0, tau) @ G0)
    w = np.full(cfg.m + 1, cfg.dtau)
    w[0] *= 0.5
    w[-1] *= 0.5
    D = _dwave_form_factor(model.lat)
    ps_exp = sum(w[l] * float(np.sum(up[l] * dn[l]))
                 for l in range(cfg.m + 1)) / N
    pd_exp = sum(w[l] * float(np.sum(up[l] * (D @ dn[l] @ D.T)))
                 for l in range(cfg.m + 1)) / N
    np.testing.assert_allclose(float(ps), ps_exp, atol=1e-8)
    np.testing.assert_allclose(float(pd), pd_exp, atol=1e-7)


def test_pair_susceptibilities_ph_mode_matches_two_sector():
    """ph mode reconstructs the down sector exactly, so both pairing
    susceptibilities must match the two-sector run on the same field."""
    kw = dict(L=2, U=4.0, mu=0.0, beta=2.0, m=16, s=4, dtype="float64")
    m2 = HubbardModel(HubbardConfig(**kw, ph_symmetry="off"))
    mp = HubbardModel(HubbardConfig(**kw, ph_symmetry="on"))
    key = jax.random.key(3)
    out2 = m2.measure_time_displaced(m2.init_state(key), per_slice=True,
                                     susceptibilities=True)
    outp = mp.measure_time_displaced(mp.init_state(key), per_slice=True,
                                     susceptibilities=True)
    np.testing.assert_allclose(float(out2[2]), float(outp[2]), atol=1e-8)
    np.testing.assert_allclose(float(out2[3]), float(outp[3]), atol=1e-8)


@pytest.mark.parametrize("opdim", [2, 3])
def test_sdw_pair_susceptibilities_vs_oracle(opdim):
    """SDW tau-integrated pairing susceptibilities: the model's
    sector-aware contraction (with D-dressed d-wave factors) matches an
    independent complex-NumPy Wick evaluation on brute-force 4N Greens
    from the oracle's own B matrices."""
    from detqmc.models.sdw import SDWConfig, SDWModel
    from tests.oracle.sdw_oracle import SDWOracle

    cfg = SDWConfig(L=2, opdim=opdim, r=0.5, beta=1.0, m=8, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(4))
    G_all, dev = model.time_displaced_greens_all(state.phi)
    ps, pd = model.pair_susceptibilities(G_all)
    assert float(dev) < 1e-8

    oracle = SDWOracle(L=2, opdim=opdim, r=0.5, beta=1.0, m=8)
    phi = np.asarray(state.phi)
    N = cfg.n_sites
    full = oracle.b_chain(phi, 0, cfg.m)
    G0 = np.linalg.inv(np.eye(4 * N) + full)
    D = _dwave_form_factor(model.lat)
    blk = lambda G, o, p: G[o * N:(o + 1) * N, p * N:(p + 1) * N]
    terms = (((0, 0), (1, 1), 1.0), ((2, 2), (3, 3), 1.0),
             ((0, 3), (1, 2), -1.0), ((2, 1), (3, 0), -1.0))
    w = np.full(cfg.m + 1, cfg.dtau)
    w[0] *= 0.5
    w[-1] *= 0.5
    ps_exp = pd_exp = 0.0
    for tau in range(cfg.m + 1):
        Gt = oracle.b_chain(phi, 0, tau) @ G0
        for (a1, c1), (a2, c2), sgn in terms:
            m1, m2 = blk(Gt, a1, c1), blk(Gt, a2, c2)
            ps_exp += w[tau] * sgn * float(np.real(m1 * m2).sum())
            d1 = (D @ m1 if a1 % 2 else m1) @ (D.T if c1 % 2 else
                                               np.eye(N))
            d2 = (D @ m2 if a2 % 2 else m2) @ (D.T if c2 % 2 else
                                               np.eye(N))
            pd_exp += w[tau] * sgn * float(np.real(d1 * d2).sum())
    ps_exp /= N
    pd_exp /= N
    np.testing.assert_allclose(float(ps), ps_exp, atol=1e-8)
    np.testing.assert_allclose(float(pd), pd_exp, atol=1e-7)


def _brute_unequal_time(oracle, field, m, N, spin):
    """fp64 brute-force G(tau,0), G(0,tau), G(tau,tau) per slice."""
    full = oracle.b_chain(field, spin, 0, m)
    G0 = np.linalg.inv(np.eye(N) + full)
    out = []
    for tau in range(m + 1):
        A = oracle.b_chain(field, spin, 0, tau)
        C = oracle.b_chain(field, spin, tau, m)
        out.append((A @ G0,
                    -np.linalg.inv(np.eye(N) + C @ A) @ C,
                    np.linalg.inv(np.eye(N) + A @ C)))
    return out


def test_unequal_time_all_directions_vs_oracle():
    """G(tau,0), G(0,tau) = -(1+CA)^{-1}C and G(tau,tau) at every slice
    match brute-force fp64 products, both spin sectors."""
    cfg = HubbardConfig(L=2, U=4.0, beta=2.0, m=16, s=4, dtype="float64",
                        ph_symmetry="off")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(1))
    t0, zt, tt, dev = model.unequal_time_greens_all(state.field)
    t0, zt, tt = map(np.asarray, (t0, zt, tt))
    assert float(dev) < 1e-8
    oracle = HubbardOracle(L=2, U=4.0, beta=2.0, m=16)
    f = np.asarray(state.field)
    for comp, spin in [(0, +1), (1, -1)]:
        ref = _brute_unequal_time(oracle, f, cfg.m, cfg.n_sites, spin)
        for tau, (rt0, rzt, rtt) in enumerate(ref):
            np.testing.assert_allclose(t0[tau, comp], rt0, atol=1e-8,
                                       err_msg=f"t0 tau={tau}")
            np.testing.assert_allclose(zt[tau, comp], rzt, atol=1e-8,
                                       err_msg=f"zt tau={tau}")
            np.testing.assert_allclose(tt[tau, comp], rtt, atol=1e-8,
                                       err_msg=f"tt tau={tau}")


def test_unequal_time_free_fermion_reverse():
    """U=0 closed form for the reverse propagator:
    G(0,tau) = -(1 - G0) expK^{-tau} = -expK^{m-tau}(1+expK^m)^{-1}."""
    cfg = HubbardConfig(L=4, U=0.0, beta=2.0, m=16, s=4, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))
    _, zt, _, dev = model.unequal_time_greens_all(state.field)
    zt = np.asarray(zt)
    assert float(dev) < 1e-10
    expK = np.asarray(model.prop.expK, np.float64)
    denom = np.linalg.inv(np.eye(cfg.n_sites)
                          + np.linalg.matrix_power(expK, cfg.m))
    for tau in range(cfg.m + 1):
        expected = -np.linalg.matrix_power(expK, cfg.m - tau) @ denom
        np.testing.assert_allclose(zt[tau, 0], expected, atol=1e-10,
                                   err_msg=f"tau={tau}")


def test_unequal_time_ph_mode_matches_two_sector():
    """ph mode's reconstructed down sectors for all three chains equal
    the two-sector run on the same field."""
    kw = dict(L=2, U=4.0, mu=0.0, beta=2.0, m=16, s=4, dtype="float64")
    m2 = HubbardModel(HubbardConfig(**kw, ph_symmetry="off"))
    mp = HubbardModel(HubbardConfig(**kw, ph_symmetry="on"))
    key = jax.random.key(3)
    o2 = m2.unequal_time_greens_all(m2.init_state(key).field)
    op = mp.unequal_time_greens_all(mp.init_state(key).field)
    for a, b, name in zip(o2[:3], op[:3], ("t0", "zt", "tt")):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-8, err_msg=name)


def test_current_correlator_vs_brute_force():
    """Lambda_xx(q) from the model's shifted-matrix contraction matches
    an explicit per-(i, j, s1, s2) fp64 Wick evaluation on brute-force
    Greens, at every q."""
    cfg = HubbardConfig(L=4, U=4.0, beta=1.0, m=8, s=4, dtype="float64",
                        ph_symmetry="off")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(2))
    lam_q, rho_s, dev = model.measure_current_correlators(state)
    assert float(dev) < 1e-8

    oracle = HubbardOracle(L=4, U=4.0, beta=1.0, m=8)
    f = np.asarray(state.field)
    N, m, t = cfg.n_sites, cfg.m, cfg.t
    xp = model.lat.neighbors()[:, 0]
    ref = {s: _brute_unequal_time(oracle, f, m, N, s) for s in (+1, -1)}
    w = np.full(m + 1, cfg.dtau)
    w[0] *= 0.5
    w[-1] *= 0.5
    lam = np.zeros((N, N))
    sides = {+1: (lambda i: xp[i], lambda i: i),
             -1: (lambda i: i, lambda i: xp[i])}   # (a, b) of s c+_a c_b
    for tau in range(m + 1):
        u = np.zeros(N)
        v = np.zeros(N)
        conn = np.zeros((N, N))
        for spin in (+1, -1):
            Gt0_t, G0t_t, Gtt_t = ref[spin][tau]
            _, _, G00 = ref[spin][0]
            for i in range(N):
                u[i] += Gtt_t[i, xp[i]] - Gtt_t[xp[i], i]
                v[i] += G00[i, xp[i]] - G00[xp[i], i]
            for s1 in (+1, -1):
                a1f, b1f = sides[s1]
                for s2 in (+1, -1):
                    a2f, b2f = sides[s2]
                    for i in range(N):
                        for j in range(N):
                            conn[i, j] += s1 * s2 * (
                                -G0t_t[b2f(j), a1f(i)]
                                * Gt0_t[b1f(i), a2f(j)])
        lam += w[tau] * (-(t ** 2)) * (np.outer(u, v) + conn)
    kg = model.lat.k_grid()
    rg = model.lat.coords(np.arange(N)).astype(np.float64)
    F = np.exp(-1j * (kg @ rg.T))
    lam_q_ref = np.real(np.einsum("qi,ij,qj->q", F, lam, F.conj())) / N
    np.testing.assert_allclose(np.asarray(lam_q), lam_q_ref, atol=1e-8)
    q1 = 2.0 * np.pi / cfg.L
    il = int(np.argmin(np.abs(kg - [q1, 0.0]).sum(axis=1)))
    it_ = int(np.argmin(np.abs(kg - [0.0, q1]).sum(axis=1)))
    np.testing.assert_allclose(
        float(rho_s), 0.25 * (lam_q_ref[il] - lam_q_ref[it_]), atol=1e-8)


def test_current_correlator_f_sum_sanity():
    """Sign/normalization sanity at U=0: the longitudinal limit obeys
    the f-sum rule Lambda_L(q->0) = -<k_x> (Scalapino-White-Zhang);
    at the smallest finite q on L=8 they agree to ~a few percent."""
    cfg = HubbardConfig(L=8, U=0.0, beta=2.0, m=16, s=4, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))
    lam_q, _rho, dev = model.measure_current_correlators(state)
    assert float(dev) < 1e-10
    N = cfg.n_sites
    expK = np.asarray(model.prop.expK, np.float64)
    G0 = np.linalg.inv(np.eye(N) + np.linalg.matrix_power(expK, cfg.m))
    A = np.eye(N) - G0.T                      # <c+_a c_b>, per spin
    xp = model.lat.neighbors()[:, 0]
    kx = 0.0
    for i in range(N):
        kx += 2 * (-cfg.t) * (A[xp[i], i] + A[i, xp[i]])  # both spins
    kx /= N
    lam_L = float(np.asarray(lam_q)[model._q_long_idx])
    assert kx < 0.0 and lam_L > 0.0           # sign convention pinned
    assert abs(lam_L - (-kx)) < 0.2 * abs(kx)


@pytest.mark.parametrize("opdim", [2, 3])
def test_sdw_reverse_time_displaced_vs_oracle(opdim):
    """SDW G(0,tau) at every slice: the swapped-stack anchors +
    inverse-B wrapping match -(1+CA)^{-1}C built brute-force in complex
    fp64, in every physical orbital block (the reduced sector's
    conjugate reconstruction holds for G(0,tau) because sector B's
    propagators are the conjugates of sector A's)."""
    from detqmc.models.sdw import SDWConfig, SDWModel
    from tests.oracle.sdw_oracle import SDWOracle

    cfg = SDWConfig(L=2, opdim=opdim, r=0.5, beta=1.0, m=8, s=2,
                    dtype="float64")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(4))
    G_all, dev = model.time_displaced_greens_rev_all(state.phi)
    assert float(dev) < 1e-8

    oracle = SDWOracle(L=2, opdim=opdim, r=0.5, beta=1.0, m=8)
    phi = np.asarray(state.phi)
    N = cfg.n_sites
    for tau in range(cfg.m + 1):
        A = oracle.b_chain(phi, 0, tau)
        C = oracle.b_chain(phi, tau, cfg.m)
        expected = -np.linalg.inv(np.eye(4 * N) + C @ A) @ C
        re4, im4 = model._phys_green_parts(G_all[tau])
        re4, im4 = np.asarray(re4), np.asarray(im4)
        for o in range(4):
            for p in range(4):
                blk = expected[o * N:(o + 1) * N, p * N:(p + 1) * N]
                np.testing.assert_allclose(
                    re4[o, p] + 1j * im4[o, p], blk, atol=1e-8,
                    err_msg=f"tau={tau} block=({o},{p})")
