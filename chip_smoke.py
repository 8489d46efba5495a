"""Smoke test of detqmc on an NVIDIA GPU: the main path once, checked.

Usage:
    python chip_smoke.py            # one card: all single-card phases
    python chip_smoke.py --chips 4  # only the four-card mesh phases

Each phase prints one JSON line with its checked values, the tolerance
of each check, and its compile seconds kept apart from its run seconds.
The last line is {"ok": true, "device": {...}} only when every phase
passed; any failed phase makes the exit status non-zero. Without a GPU
the script stops at once with status 1. Float32 products run at
HIGHEST precision throughout (precision.ensure_runtime sets it for the
process), so no f32 matmul runs in TF32.

Phases (one card):
  hubbard_cli     the Hubbard CLI on examples/hubbard_l8_beta8.conf
  hubbard_oracle  stabilized G of 4 walkers vs the NumPy f64 oracle
  sdw_cli         the SDW CLI on examples/sdw_o3_l8.conf (global moves on)
  sdw_precision   SDW O(3) complex64 G with its complex128 island vs
                  complex128 end to end, one field configuration
  update_kernel   the Hubbard slice-update kernel vs the lax.scan loop
Phases (--chips 4):
  mesh_hubbard    Hubbard with meshDevices=4 vs the same seed on one card
  mesh_pt         examples/pt_sdw_r_grid.conf with meshDevices=4 vs one card
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(ROOT, "examples")

# acceptance limits (the bench gates and BASELINE.json's stabilized-G
# target); each phase prints the limit beside the measured value
HUBBARD_GREEN_DEV = 6e-3      # wrapped-vs-stabilized drift, f32 chain
SDW_GREEN_DEV = 1e-4
ORACLE_F32 = 1e-4             # f32 run vs f64 oracle, max |dG|
ORACLE_F64 = 1e-8             # f64 run vs f64 oracle, max |dG|
SDW_ISLAND = 1e-4             # complex64+complex128 island vs complex128
KERNEL_G = 1e-5               # update kernel vs scan, max |dG| (f32)


def _load_hubbard_oracle():
    """tests/oracle/hubbard_oracle.py by path: the installation may hold
    another top-level package named ``tests``."""
    import importlib.util

    path = os.path.join(ROOT, "tests", "oracle", "hubbard_oracle.py")
    spec = importlib.util.spec_from_file_location("hubbard_oracle", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod      # dataclasses look the module up
    spec.loader.exec_module(mod)
    return mod.HubbardOracle


def _read_run(outdir):
    from detqmc.io.series import load_results
    from detqmc.metadata import read_metadata

    res = load_results(os.path.join(outdir, "results.values"))
    info = read_metadata(os.path.join(outdir, "info.dat"))
    return res, info


def phase_hubbard_cli(tmp, sweeps=20, thermalization=10, extra=()):
    from detqmc.cli import main_hubbard

    out = os.path.join(tmp, "hubbard")
    rc = main_hubbard.main(
        ["--conf", os.path.join(EXAMPLES, "hubbard_l8_beta8.conf"),
         f"sweeps={sweeps}", f"thermalization={thermalization}",
         f"outdir={out}", *extra])
    res, info = _read_run(out)
    occ, sign = res["occupancy"][0], res["sign"][0]
    dev = float(info["greenDevMedian"])
    return {
        "ok": rc == 0 and abs(occ - 1.0) <= 1e-3 and sign == 1.0
        and dev < HUBBARD_GREEN_DEV,
        "exit_code": rc, "occupancy": occ, "occupancy_tol": 1e-3,
        "sign": sign, "green_dev_median": dev,
        "green_dev_limit": HUBBARD_GREEN_DEV, "precision": "float32",
    }


def phase_hubbard_oracle(L=8, beta=8.0, m=80, s=4, walkers=4,
                         sweep_pairs=2):
    import jax
    import jax.numpy as jnp

    from detqmc.models.hubbard import HubbardConfig, HubbardModel

    HubbardOracle = _load_hubbard_oracle()

    cfg32 = HubbardConfig(L=L, U=4.0, beta=beta, m=m, s=s,
                          dtype="float32")
    m32 = HubbardModel(cfg32)
    keys = jax.random.split(jax.random.key(11), walkers)
    states = jax.jit(jax.vmap(m32.init_state))(keys)
    step = jax.jit(jax.vmap(lambda st: m32.sweep_pair(st, False)[0]))
    for _ in range(sweep_pairs):
        states = step(states)
    field = np.asarray(states.field, np.float64)
    g32 = np.asarray(states.G[:, 0], np.float64)

    m64 = HubbardModel(dataclasses.replace(cfg32, dtype="float64"))
    rebuild = jax.jit(jax.vmap(lambda k, f: m64.refresh_from_field(
        m64.init_state(k)._replace(field=f)).G[0]))
    g64 = np.asarray(rebuild(keys, jnp.asarray(field)))
    oracle = HubbardOracle(L=L, U=4.0, beta=beta, m=m)
    ref = np.stack([oracle.green(field[w], +1, 0, stab_interval=s)
                    for w in range(walkers)])
    d32 = float(np.abs(g32 - ref).max())
    d64 = float(np.abs(g64 - ref).max())
    return {
        "ok": d32 <= ORACLE_F32 and d64 <= ORACLE_F64,
        "max_abs_dG_float32": d32, "limit_float32": ORACLE_F32,
        "max_abs_dG_float64": d64, "limit_float64": ORACLE_F64,
        "walkers": walkers, "matmul_precision": "highest",
    }


def phase_sdw_cli(tmp, sweeps=20, thermalization=10, extra=()):
    from detqmc.cli import main_sdw

    out = os.path.join(tmp, "sdw")
    rc = main_sdw.main(
        ["--conf", os.path.join(EXAMPLES, "sdw_o3_l8.conf"),
         f"sweeps={sweeps}", f"thermalization={thermalization}",
         f"outdir={out}", *extra])
    res, info = _read_run(out)
    phi2 = res["phiSquared"][0]
    dev = float(info["greenDevMedian"])
    return {
        "ok": rc == 0 and dev < SDW_GREEN_DEV and bool(np.isfinite(phi2)),
        "exit_code": rc, "green_dev_median": dev,
        "green_dev_limit": SDW_GREEN_DEV, "phiSquared": phi2,
        "precision": "complex64 with complex128 island",
    }


def phase_sdw_precision(L=8, beta=4.0, m=40, s=4):
    import jax

    from detqmc.models.sdw import SDWConfig, SDWModel

    cfg = SDWConfig(L=L, opdim=3, r=0.5, beta=beta, m=m, s=s,
                    checkerboard=True, dtype="float32")
    m32 = SDWModel(cfg)
    m128 = SDWModel(dataclasses.replace(cfg, dtype="float64"))
    st = jax.jit(m32.init_state)(jax.random.key(5))
    st128 = jax.jit(lambda k, p: m128.refresh_from_field(
        m128.init_state(k)._replace(phi=p)))(
            jax.random.key(5), st.phi.astype("float64"))
    g32 = np.asarray(st.G, np.complex128)
    g128 = np.asarray(st128.G)
    dev = float(np.abs(g32 - g128).max())
    return {"ok": dev <= SDW_ISLAND, "max_abs_dG": dev,
            "limit": SDW_ISLAND, "dim": int(m32.dim)}


def phase_update_kernel(L=8, beta=8.0, m=80, s=4, walkers=256):
    import jax
    import jax.numpy as jnp

    from detqmc.linalg import slice_update_triton
    from detqmc.models.hubbard import HubbardConfig, HubbardModel

    cfg = HubbardConfig(L=L, U=4.0, beta=beta, m=m, s=s, dtype="float32",
                        update_kernel="scan")
    model = HubbardModel(cfg)
    states = jax.jit(jax.vmap(model.init_state))(
        jax.random.split(jax.random.key(3), walkers))
    u01 = jax.random.uniform(jax.random.key(4), (walkers, cfg.n_sites),
                             dtype=jnp.float32)
    signs = jnp.ones((walkers,), jnp.float32)
    fl = states.field[:, 7]
    ref = jax.jit(jax.vmap(model._update_slice))(states.G, fl, u01, signs)
    ker = jax.jit(jax.vmap(lambda g, f, u, sg: slice_update_triton
                           .slice_update(g, f, u, sg, alpha=cfg.alpha,
                                         ph_on=cfg.ph_on)))(
        states.G, fl, u01, signs)
    (G1, f1, s1, a1), (G2, f2, s2, a2) = jax.device_get((ref, ker))
    same = bool(np.array_equal(f1, f2) and np.array_equal(s1, s2)
                and np.array_equal(a1, a2))
    dG = float(np.abs(G1 - G2).max())
    return {"ok": same and dG <= KERNEL_G, "accept_identical": same,
            "max_abs_dG": dG, "limit": KERNEL_G,
            "acceptance": float(np.mean(a1)), "N": cfg.n_sites,
            "walkers": walkers}


def _driver_config(conf, **overrides):
    from detqmc import config as cf

    params = cf.parse_args(["--conf", os.path.join(EXAMPLES, conf)])
    params.update({k: str(v) for k, v in overrides.items()})
    return params


def phase_mesh_hubbard(devices=4, sweeps=4, thermalization=2,
                       **overrides):
    from detqmc import config as cf
    from detqmc.driver import DetQMC
    from detqmc.models.hubbard import HubbardModel

    runs = {}
    for n in (1, devices):
        params = _driver_config("hubbard_l8_beta8.conf", sweeps=sweeps,
                                thermalization=thermalization,
                                meshDevices=n, rngSeed=7, **overrides)
        params.pop("outdir")
        model_p, driver_p, _ = cf.split_params(params, cf._HUBBARD_KEYS)
        qmc = DetQMC(HubbardModel(cf.build_hubbard_config(model_p)),
                     cf.build_driver_config(driver_p))
        res = qmc.run()
        runs[n] = (res, np.asarray(qmc.states.field),
                   np.asarray(qmc.states.G))
    (r1, f1, g1), (rn, fn, gn) = runs[1], runs[devices]
    same_w = np.all(f1 == fn, axis=(1, 2))
    frac = float(same_w.mean())
    dG = float(np.abs(g1[same_w] - gn[same_w]).max()) if same_w.any() \
        else float("inf")
    obs = max(abs(r1[k][0] - rn[k][0]) / max(abs(r1[k][0]), 1e-12)
              for k in r1)
    return {
        # the two programs are compiled separately (per-device batch 64
        # vs 256), so batched GEMMs may differ in the last bit, and a
        # last-bit change flips a Metropolis decision with probability
        # ~1e-7 per site: >= 99% of walkers must keep identical fields
        "ok": frac >= 0.99 and dG <= 1e-4 and obs <= 1e-3,
        "walkers_identical_fields": frac, "limit_fraction": 0.99,
        "max_abs_dG_identical_walkers": dG, "limit_dG": 1e-4,
        "max_rel_obs_diff": obs, "limit_obs": 1e-3,
        "mesh_devices": devices,
    }


def phase_mesh_pt(devices=4, sweeps=8, thermalization=4, **overrides):
    from detqmc import config as cf
    from detqmc.models.sdw import SDWModel
    from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

    runs = {}
    for n in (1, devices):
        params = _driver_config("pt_sdw_r_grid.conf", sweeps=sweeps,
                                thermalization=thermalization,
                                meshDevices=n, rngSeed=9, **overrides)
        params.pop("outdir")
        model_p, driver_p, extra = cf.split_params(
            params, cf._SDW_KEYS, extra_keys=cf._PT_KEYS)
        ptp = cf.pt_params(extra)
        qmc = DetQMCPT(
            SDWModel(cf.build_sdw_config(model_p)), ptp["values"],
            cf.build_driver_config(driver_p),
            PTConfig(exchange_interval=ptp["exchangeInterval"],
                     control_parameter=ptp["controlParameter"],
                     n_ensembles=ptp["ptEnsembles"]))
        qmc.run()
        runs[n] = (np.asarray(qmc.pt_state.param_of_replica),
                   np.asarray(qmc.pt_state.n_accepted),
                   np.asarray(qmc.pt_state.n_attempted))
    (p1, a1, t1), (pn, an, tn) = runs[1], runs[devices]
    R = p1.shape[-1]
    valid = bool(np.all(np.sort(pn, axis=-1) == np.arange(R)))
    same = bool(np.array_equal(p1, pn) and np.array_equal(a1, an))
    return {"ok": same and valid, "same_swap_decisions": same,
            "permutation_valid": valid, "swaps_accepted": int(an.sum()),
            "swaps_attempted": int(tn.sum()), "mesh_devices": devices}


def run_phases(phases, clock):
    ok = True
    for name, fn in phases:
        t0, c0 = time.perf_counter(), clock.seconds
        try:
            rec = fn()
        except Exception as e:  # noqa: BLE001 — recorded, exit non-zero
            traceback.print_exc()
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        wall = time.perf_counter() - t0
        compile_s = clock.seconds - c0
        rec = {"phase": name, **rec, "compile_s": round(compile_s, 2),
               "run_s": round(wall - compile_s, 2)}
        print(json.dumps(rec), flush=True)
        ok = ok and bool(rec["ok"])
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    import jax
    import jaxlib

    from detqmc import compile_cache
    from detqmc.device import CompileClock, nvidia_smi, require_gpu

    device = require_gpu()
    if device["count"] < args.chips:
        print(f"--chips {args.chips} needs {args.chips} GPUs; JAX found "
              f"{device['count']}", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {nvidia_smi()}", flush=True)
    print(f"jax {jax.__version__} jaxlib {jaxlib.__version__}", flush=True)
    compile_cache.enable()
    clock = CompileClock()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        if args.chips == 4:
            phases = [("mesh_hubbard", phase_mesh_hubbard),
                      ("mesh_pt", phase_mesh_pt)]
        else:
            phases = [
                ("hubbard_cli", lambda: phase_hubbard_cli(tmp)),
                ("hubbard_oracle", phase_hubbard_oracle),
                ("sdw_cli", lambda: phase_sdw_cli(tmp)),
                ("sdw_precision", phase_sdw_precision),
                ("update_kernel", phase_update_kernel),
            ]
        ok = run_phases(phases, clock)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
