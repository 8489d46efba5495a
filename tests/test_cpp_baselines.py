"""Parity gates for the single-core C++ baselines (BASELINE.md's
denominators): each C++ chain must produce the exact same stabilized
Green function as the Python fp64 model from the same field — this
pins the B construction, the UdV, and the stable pair formula to the
model's conventions, so the denominators measure the same algorithm
(reference analogues: src/dethubbard.cpp / src/detsdwopdim.cpp,
SURVEY.md §3)."""

import os
import shutil
import subprocess

import numpy as np
import pytest

BASE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native", "baseline")


def _lcg_phi(m, N):
    """The baseline's deterministic selftest field (same 64-bit LCG)."""
    st = np.uint64(42)
    A = np.uint64(6364136223846793005)
    C = np.uint64(1442695040888963407)
    vals = np.empty(m * N * 3)
    with np.errstate(over="ignore"):
        for t in range(m * N * 3):
            st = st * A + C
            vals[t] = float(st >> np.uint64(11)) / 9007199254740992.0 - 0.5
    return vals.reshape(m, N, 3)


@pytest.mark.slow
def test_cpp_sdw_baseline_green_matches_model(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    exe = os.path.join(BASE, "sdw_baseline")
    r = subprocess.run(["make", "-C", BASE, "sdw_baseline"],
                       capture_output=True, text=True)
    if r.returncode != 0 or not os.path.exists(exe):
        pytest.skip(f"baseline build unavailable: {r.stderr[-200:]}")

    import jax

    from detqmc.models.sdw import SDWConfig, SDWModel

    L, beta, m, s = 2, 1.0, 4, 2
    N = L * L
    out = tmp_path / "G.bin"
    subprocess.run([exe, "selftest", str(L), str(beta), str(m), str(s),
                    str(out)], check=True, capture_output=True)
    G_cpp = np.fromfile(out, dtype=np.complex128).reshape(
        4 * N, 4 * N, order="F")

    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=beta, m=m, s=s,
                    dtype="float64", fermion_repr="complex")
    model = SDWModel(cfg)
    state = model.init_state(jax.random.key(0))._replace(
        phi=jax.numpy.asarray(_lcg_phi(m, N)))
    G_py = np.asarray(model.refresh_from_field(state).G)
    assert np.abs(G_py - G_cpp).max() < 1e-12


@pytest.mark.slow
def test_cpp_hubbard_baseline_green_matches_model(tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    exe = os.path.join(BASE, "dqmc_baseline")
    r = subprocess.run(["make", "-C", BASE, "dqmc_baseline"],
                       capture_output=True, text=True)
    if r.returncode != 0 or not os.path.exists(exe):
        pytest.skip(f"baseline build unavailable: {r.stderr[-200:]}")

    import jax

    from detqmc.models.hubbard import HubbardConfig, HubbardModel

    L, beta, m, s = 4, 2.0, 8, 4
    N = L * L
    out = tmp_path / "G.bin"
    subprocess.run([exe, "selftest", str(L), str(beta), str(m), str(s),
                    str(out)], check=True, capture_output=True)
    G_cpp = np.fromfile(out, dtype=np.float64).reshape(N, N, order="F")

    st = np.uint64(42)
    A = np.uint64(6364136223846793005)
    C = np.uint64(1442695040888963407)
    vals = np.empty(m * N)
    with np.errstate(over="ignore"):
        for t in range(m * N):
            st = st * A + C
            vals[t] = float(st >> np.uint64(11)) / 9007199254740992.0
    field = np.where(vals.reshape(m, N) < 0.5, -1.0, 1.0)

    cfg = HubbardConfig(L=L, U=4.0, beta=beta, m=m, s=s, dtype="float64")
    model = HubbardModel(cfg)
    state = model.init_state(jax.random.key(0))._replace(
        field=jax.numpy.asarray(field))
    G_py = np.asarray(model.refresh_from_field(state).G)[0]  # ph: up only
    assert np.abs(G_py - G_cpp).max() < 1e-12
