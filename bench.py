"""Headline benchmark: DQMC sweeps/sec per GPU, 8x8 Hubbard at beta=8.

Matches BASELINE.md's driver-defined target: full sweep pairs (up+down,
every site Metropolis-updated, QR/UdV stabilization every s slices,
measurements on) batched over vmapped walkers on one GPU.

Prints ONE JSON line at the end; every section is failure-isolated
(round-3 lesson: a single gate trip at one shape must not erase the
other sections' already-computed numbers). Each section's metric is
echoed to stderr as it lands; gate values are *recorded* (value + pass
flag), never raised, and the process exits 0 whenever the JSON printed
— the `ok` field and per-section `status` carry the failure signal.

Sections:
  1. hubbard   — L=8 beta=8 sweeps/s per GPU (the BASELINE.json target)
  2. sdw_l4    — O(3) SDW L=4 sweeps/s (BASELINE.json config #3)
  3. sdw_l8    — O(3) SDW L=8 (science scale, checkerboard, s=8)
  4. qr_gflops — stabilized B-chain refactor GFLOP/s (the second
                 BASELINE.json metric: f64-equivalent FLOP/s through
                 the UdV stabilization step at both bench shapes)

The baseline denominator is the single-core fp64 CPU implementation in
native/baseline (same algorithm: dense wraps, rank-1 SM updates, QR
stabilization), measured on the host of an earlier accelerator — see
BASELINE.md; it is a sanity ratio until it is re-measured on the GPU's
host. A sweep here = one full pass over all m time slices (reference
semantics).

The benchmark runs on an NVIDIA GPU only: without one it exits with
status 1. The JSON names the device (JAX's platform, device_kind and
count) and the card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import json
import sys
import time
import traceback

import jax
import numpy as np

from detqmc import compile_cache
from detqmc.device import nvidia_smi, require_gpu

from detqmc.models.hubbard import HubbardConfig, HubbardModel

# single-core C++ baseline (native/baseline/dqmc_baseline.cpp); see
# BASELINE.md "Measured baseline denominator".
BASELINE_SWEEPS_PER_SEC = 27.2

L, BETA, M, S = 8, 8.0, 80, 4
N_WALKERS = 256
N_TIMED_PAIRS = 5

# BASELINE.json config #3: the O(3) SDW metal (detqmcsdw path). The
# denominators are native/baseline/sdw_baseline.cpp — a single-core fp64
# C++ implementation of the same full-complex opdim-3 algorithm (zgemm
# wraps, rank-4 Woodbury updates, complex QR/UdV stabilization),
# selftest-pinned to the model's G at 1e-12 (tests/test_cpp_baselines.py;
# BASELINE.md). Two sizes: L=4 and the science-scale L=8 (complex dim
# 256; the SDW papers run L = 8-14). The L=8 line runs s=8 and is
# divided by the C++ baseline at the SAME s.
SDW_L, SDW_BETA, SDW_M, SDW_S, SDW_W = 4, 4.0, 40, 4, 128
SDW_BASELINE_SWEEPS_PER_SEC = {4: 67.6, 8: 3.41}
SDW8_S = 8
SDW8_W = 128
# science regime (beta=8 m=80 s=8): single-core C++ sdw_baseline at the
# same (L, beta, m, s): `OPENBLAS_NUM_THREADS=1 ./sdw_baseline 8 8.0 80
# 8 2` (BASELINE.md)
SDW_L8B8_BASELINE = 1.22

# Wrapped-vs-stabilized drift gates (medians over walkers; the max has a
# sporadic tail from near-singular Metropolis ratios). The Hubbard gate
# bounds the f32 chain's wrapped drift; the measured G is the stabilized
# one.
GATES = {
    "hubbard": 6e-3,
    "sdw_l4": 1e-4,
    "sdw_l8": 1e-4,
    "sdw_l8b8": 1e-4,
}


def _bench_hubbard(out):
    cfg = HubbardConfig(L=L, U=4.0, beta=BETA, m=M, s=S, dtype="float32")
    model = HubbardModel(cfg)
    keys = jax.random.split(jax.random.key(0), N_WALKERS)
    states = jax.jit(jax.vmap(model.init_state))(keys)

    def block(sts):
        def body(s_, _):
            s_, obs = model.sweep_pair(s_, measure=True)
            return s_, obs.occupancy
        sts, occ = jax.lax.scan(body, sts, None, length=N_TIMED_PAIRS)
        return sts, occ

    step = jax.jit(jax.vmap(block))
    states, occ = jax.block_until_ready(step(states))  # compile + warmup

    t0 = time.perf_counter()
    states, occ = jax.block_until_ready(step(states))
    dt = time.perf_counter() - t0
    dev_np = np.asarray(states.green_dev)

    sweeps = N_WALKERS * N_TIMED_PAIRS * 2  # pair = 2 sweeps
    value = sweeps / dt
    occ_mean = float(np.asarray(occ).mean())
    dev_med = float(np.median(dev_np))
    out["value"] = round(value, 2)
    out["vs_baseline"] = round(value / BASELINE_SWEEPS_PER_SEC, 2)
    out["green_dev_med"] = dev_med
    out["occupancy"] = round(occ_mean, 6)
    # physics sanity (half filling) + stabilization gate
    out["gate_pass"] = bool(dev_med < GATES["hubbard"]
                            and abs(occ_mean - 1.0) < 1e-3)


def _bench_sdw_o3(out, L_, W, n_timed=3, checkerboard=False,
                  s=SDW_S, gate=1e-4, beta=SDW_BETA, m=SDW_M,
                  baseline=None):
    from detqmc.models.sdw import SDWConfig, SDWModel

    cfg = SDWConfig(L=L_, opdim=3, r=0.5, beta=beta, m=m,
                    s=s, dtype="float32", checkerboard=checkerboard)
    model = SDWModel(cfg)
    keys = jax.random.split(jax.random.key(1), W)
    states = jax.jit(jax.vmap(model.init_state))(keys)
    step = jax.jit(jax.vmap(lambda st: model.sweep_pair(st, measure=True)))
    states, obs = jax.block_until_ready(step(states))  # compile + warmup
    t0 = time.perf_counter()
    for _ in range(n_timed):
        states, obs = step(states)
    jax.block_until_ready(states)
    dt = time.perf_counter() - t0
    dev_np = np.asarray(states.green_dev)
    value = W * n_timed * 2 / dt
    dev_med = float(np.median(dev_np))
    phi2 = float(np.asarray(obs.phiSquared).mean())
    base = (SDW_BASELINE_SWEEPS_PER_SEC[L_] if baseline is None
            else baseline)
    out["value"] = round(value, 2)
    out["vs_baseline"] = round(value / base, 2)
    out["green_dev_med"] = dev_med
    out["gate_pass"] = bool(dev_med < gate and np.isfinite(phi2))


def _bench_qr_gflops(out):
    """f64-equivalent FLOP/s through one stabilized B-chain refactor
    step (compose B.(U d V) -> QR -> V-chain product) at both bench
    shapes, vmapped over the bench walker counts.

    FLOP accounting (f64-equivalent, the algorithm's arithmetic):
      compose M.(U diag(d)) : 2 n^3       (one n x n matmul)
      Householder QR with Q : 8/3 n^3     (R: 4/3, forming Q: 4/3)
      V-chain (R' V)        : 2 n^3
      total                 : 20/3 n^3 real; complex = 4x real.
    """
    # section isolation: the f64 stab-island casts below need x64 (the
    # model constructors normally enable it; a standalone
    # `bench.py qr_gflops` run otherwise silently truncates the d/V
    # chain to f32 and measures the wrong thing)
    from detqmc.precision import ensure_runtime

    ensure_runtime(need_x64=True)
    from detqmc.linalg import udv

    results = {}
    # --- Hubbard shape: real 64x64, W=256, m/s = 20 anchors/sweep ---
    n, W = L * L, N_WALKERS
    key = jax.random.key(2)
    M_ = jax.random.normal(key, (W, n, n), dtype=jnp_f32())
    d0 = jnp_exp_spread(key, W, n, spread=4.0)
    f0 = jax.jit(jax.vmap(udv.udv_decompose))(M_)

    import jax.numpy as jnp

    def refac_real(Mb, db, Vb):
        # compose in f64 like the models do (beta=8 d-span needs it)
        return udv.udv_refactor(Mb, db, Vb, compose_dtype=jnp.float64)

    n_rep = 8
    d64, V64 = d0.astype(jnp.float64), f0.V.astype(jnp.float64)

    # distinct per-call scalar input and fully-consumed outputs (sum over
    # every factor) so nothing is deduplicated or elided; n_rep steps
    # run in one device program
    def chain_real(Mb, db, Vb, k0):
        def body(acc, i):
            f = refac_real(Mb * (1.0 + 1e-6 * (k0 + i)), db, Vb)
            return acc + f.d.sum() + f.V.sum() + f.U.sum(), None
        out, _ = jax.lax.scan(body, jnp.float64(0.0),
                              jnp.arange(n_rep, dtype=jnp.float32))
        return out

    stepn = jax.jit(jax.vmap(chain_real, in_axes=(0, 0, 0, None)))
    jax.block_until_ready(stepn(M_, d64, V64, jnp.float32(-99.0)))
    t0 = time.perf_counter()
    jax.block_until_ready(stepn(M_, d64, V64, jnp.float32(1.0)))
    dt = time.perf_counter() - t0
    flops = n_rep * W * (20.0 / 3.0) * n ** 3
    results["hubbard_qr_gflops"] = round(flops / dt / 1e9, 1)

    # --- SDW shape: complex64 256x256 composed in complex128 (the O(3)
    # model's stack layout), W=128 ---
    nc, Wc = 4 * 8 * 8, SDW8_W
    kr, ki = jax.random.split(jax.random.key(3))
    Mc = (jax.random.normal(kr, (Wc, nc, nc), dtype=jnp_f32())
          + 1j * jax.random.normal(ki, (Wc, nc, nc), dtype=jnp_f32()))
    dc = jnp_exp_spread(kr, Wc, nc, spread=4.0)
    fc = jax.jit(jax.vmap(udv.udv_decompose))(Mc)
    dc64 = dc.astype(jnp.float64)
    Vc128 = fc.V.astype(jnp.complex128)

    def chain_cplx(Mb, db, Vb, k0):
        def body(acc, i):
            f = udv.udv_refactor(Mb * (1.0 + 1e-6 * (k0 + i)), db, Vb,
                                 compose_dtype=jnp.complex128)
            return (acc + f.d.sum() + jnp.abs(f.V).sum()
                    + jnp.abs(f.U).sum()), None
        out_, _ = jax.lax.scan(body, jnp.float64(0.0),
                               jnp.arange(n_rep, dtype=jnp.float32))
        return out_

    stepcn = jax.jit(jax.vmap(chain_cplx, in_axes=(0, 0, 0, None)))
    jax.block_until_ready(stepcn(Mc, dc64, Vc128, jnp.float32(-99.0)))
    t0 = time.perf_counter()
    jax.block_until_ready(stepcn(Mc, dc64, Vc128, jnp.float32(1.0)))
    dt = time.perf_counter() - t0
    flops = n_rep * Wc * 4.0 * (20.0 / 3.0) * nc ** 3
    results["sdw_qr_gflops"] = round(flops / dt / 1e9, 1)
    out.update(results)
    out["gate_pass"] = True


def jnp_f32():
    import jax.numpy as jnp
    return jnp.float32


def jnp_exp_spread(key, W, n, spread):
    """Graded positive scales spanning e^{+-spread} — a realistic UdV
    d-spectrum so the scaled-QR path is exercised, not an identity."""
    import jax.numpy as jnp
    u = jax.random.uniform(key, (W, n), dtype=jnp.float32,
                           minval=-spread, maxval=spread)
    return jnp.exp(jnp.sort(u, axis=-1)[..., ::-1])


def main() -> None:
    device = require_gpu()
    device["nvidia_smi"] = nvidia_smi()
    compile_cache.enable()
    sections = {}

    def run(name, fn, *a, **kw):
        out = {"status": "ok"}
        t0 = time.perf_counter()
        try:
            fn(out, *a, **kw)
        except Exception:
            out["status"] = "error"
            out["error"] = traceback.format_exc().strip().splitlines()[-1]
            traceback.print_exc(file=sys.stderr)
        out["wall_s"] = round(time.perf_counter() - t0, 1)
        sections[name] = out
        print(f"# [{name}] {json.dumps(out)}", file=sys.stderr, flush=True)

    # optional argv section filter (debug / re-measure one line);
    # `python bench.py` with no args runs all sections
    known = {"hubbard", "sdw_l4", "sdw_l8", "sdw_l8b8", "qr_gflops"}
    only = set(sys.argv[1:])
    unknown = only - known
    if unknown:
        print(f"bench.py: unknown section(s) {sorted(unknown)}; "
              f"known: {sorted(known)}", file=sys.stderr)
        sys.exit(2)

    def want(name):
        return not only or name in only

    if want("hubbard"):
        run("hubbard", _bench_hubbard)
    if want("sdw_l4"):
        run("sdw_l4", _bench_sdw_o3, SDW_L, SDW_W,
            gate=GATES["sdw_l4"])
    if want("sdw_l8"):
        run("sdw_l8", _bench_sdw_o3, 8, SDW8_W, checkerboard=True,
            s=SDW8_S, gate=GATES["sdw_l8"])
    if want("sdw_l8b8"):
        # the SDW model's SCIENCE regime (the reference's payload runs
        # live at beta ~ 8-20): L=8 beta=8 m=80, s=8 (denominator in
        # BASELINE.md "SDW science regime")
        run("sdw_l8b8", _bench_sdw_o3, 8, SDW8_W,
            checkerboard=True, s=SDW8_S, gate=GATES["sdw_l8b8"],
            beta=8.0, m=80, baseline=SDW_L8B8_BASELINE)
    if want("qr_gflops"):
        run("qr_gflops", _bench_qr_gflops)

    hub = sections.get("hubbard", {})
    sdw4 = sections.get("sdw_l4", {})
    sdw8 = sections.get("sdw_l8", {})
    sdwb8 = sections.get("sdw_l8b8", {})
    qr = sections.get("qr_gflops", {})
    ok = all(s.get("status") == "ok" and s.get("gate_pass", False)
             for s in sections.values())
    print(json.dumps({
        "metric": f"hubbard_L{L}_beta{int(BETA)}_sweeps_per_sec_per_gpu",
        "value": hub.get("value"),
        "unit": "sweeps/s",
        "vs_baseline": hub.get("vs_baseline"),
        f"sdw_o3_L{SDW_L}_beta{int(SDW_BETA)}_sweeps_per_sec":
            sdw4.get("value"),
        f"sdw_o3_L{SDW_L}_vs_baseline": sdw4.get("vs_baseline"),
        f"sdw_o3_L8_beta{int(SDW_BETA)}_sweeps_per_sec": sdw8.get("value"),
        "sdw_o3_L8_vs_baseline": sdw8.get("vs_baseline"),
        "sdw_o3_L8_beta8_sweeps_per_sec": sdwb8.get("value"),
        "sdw_o3_L8_beta8_vs_baseline": sdwb8.get("vs_baseline"),
        "qr_chain_gflops": {k: v for k, v in qr.items()
                            if k.endswith("gflops")},
        "ok": ok,
        "device": device,
        "sections": sections,
    }))


if __name__ == "__main__":
    main()
