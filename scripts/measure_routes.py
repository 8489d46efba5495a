"""Time the site-update routes end to end on the GPU, and trace each.

Usage: python scripts/measure_routes.py [OUTDIR [CELL ...]]
       (OUTDIR defaults to routes_out; CELL is hubbard or sdw_l8, default
       both)

Cells (the bench shapes):
  Hubbard  L=8 beta=8 m=80 s=4, 256 walkers, f32 with the f64 island:
           routes scan, delayed K=8, delayed K=16, triton (the fused
           Pallas slice kernel)
  SDW O(3) L=8 beta=4 m=40 s=8 checkerboard, 128 walkers, complex64 with
           the complex128 island: routes scan, delayed K=8, K=16

Each route is compiled and warmed up first (set-up, reported apart);
then the timed windows run in the order A B C .. C B A, each a jitted
block of full sweep pairs with measurement, ended by block_until_ready.
sweeps/s counts walker-sweeps (one pair = 2 sweeps). Afterwards one
window per route runs under jax.profiler and is reduced by
trace_summary (device busy, idle share, gaps between kernels, top
kernels). Results go to OUTDIR/routes.json and to stdout.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import trace_summary  # noqa: E402
from detqmc import compile_cache  # noqa: E402
from detqmc.device import CompileClock, nvidia_smi, require_gpu  # noqa
from detqmc.models.hubbard import HubbardConfig, HubbardModel  # noqa
from detqmc.models.sdw import SDWConfig, SDWModel  # noqa: E402

HUBBARD = dict(L=8, U=4.0, beta=8.0, m=80, s=4, dtype="float32")
HUBBARD_ROUTES = {
    "scan": dict(update_kernel="scan"),
    "delay8": dict(update_kernel="scan", delay=8),
    "delay16": dict(update_kernel="scan", delay=16),
    "triton": dict(update_kernel="triton"),
}
SDW = dict(L=8, opdim=3, r=0.5, beta=4.0, m=40, s=8, checkerboard=True,
           dtype="float32")
SDW_ROUTES = {
    "scan": dict(update_kernel="scan"),
    "delay8": dict(update_kernel="scan", delay=8),
    "delay16": dict(update_kernel="scan", delay=16),
}


def make_route(model, walkers, pairs, seed):
    states = jax.jit(jax.vmap(model.init_state))(
        jax.random.split(jax.random.key(seed), walkers))

    def block(st):
        def body(s_, _):
            s_, obs = model.sweep_pair(s_, measure=True)
            return s_, None
        return jax.lax.scan(body, st, None, length=pairs)[0]

    return states, jax.jit(jax.vmap(block))


def measure(cell, routes, build, walkers, pairs, rounds, clock, trace_root):
    out = {}
    runs = {}
    for name, kw in routes.items():
        c0, t0 = clock.seconds, time.perf_counter()
        states, step = make_route(build(kw), walkers, pairs, seed=1)
        states = jax.block_until_ready(step(states))     # compile + warm
        out[name] = {"setup_s": time.perf_counter() - t0,
                     "compile_s": clock.seconds - c0, "sweeps_per_s": []}
        runs[name] = [states, step]
    order = list(routes) + list(reversed(routes))
    for _ in range(rounds):
        for name in order:
            states, step = runs[name]
            t0 = time.perf_counter()
            states = jax.block_until_ready(step(states))
            dt = time.perf_counter() - t0
            runs[name][0] = states
            out[name]["sweeps_per_s"].append(walkers * pairs * 2 / dt)
    for name in routes:
        states, step = runs[name]
        r = out[name]
        r["median_sweeps_per_s"] = float(np.median(r["sweeps_per_s"]))
        r["green_dev_median"] = float(np.median(np.asarray(
            states.green_dev)))
        tdir = os.path.join(trace_root, f"{cell}_{name}")
        with jax.profiler.trace(tdir):
            jax.block_until_ready(step(states))
        r["trace"] = trace_summary.summarize(tdir, top_n=25)
        print(json.dumps({"cell": cell, "route": name, **r}), flush=True)
    return out


def main() -> int:
    outdir = sys.argv[1] if len(sys.argv) > 1 else "routes_out"
    cells = set(sys.argv[2:]) or {"hubbard", "sdw_l8"}
    device = require_gpu()
    device["nvidia_smi"] = nvidia_smi()
    print(json.dumps(device), flush=True)
    compile_cache.enable()
    clock = CompileClock()
    result = {"device": device}
    with tempfile.TemporaryDirectory() as trace_root:
        if "hubbard" in cells:
            result["hubbard"] = measure(
                "hubbard", HUBBARD_ROUTES,
                lambda kw: HubbardModel(HubbardConfig(**HUBBARD, **kw)),
                walkers=256, pairs=5, rounds=2, clock=clock,
                trace_root=trace_root)
        if "sdw_l8" in cells:
            result["sdw_l8"] = measure(
                "sdw_l8", SDW_ROUTES,
                lambda kw: SDWModel(SDWConfig(**SDW, **kw)),
                walkers=128, pairs=2, rounds=2, clock=clock,
                trace_root=trace_root)
    os.makedirs(outdir, exist_ok=True)
    with open(os.path.join(outdir, "routes.json"), "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
