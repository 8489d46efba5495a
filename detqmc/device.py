"""The accelerator a measurement runs on, and the time JAX spends compiling.

bench.py, chip_smoke.py and the measurement scripts run on an NVIDIA GPU
only: a measurement that finds no GPU stops instead of reporting a CPU
number under a device metric.
"""

from __future__ import annotations

import subprocess
import sys

import jax
from jax import monitoring


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def require_gpu() -> dict:
    """{"platform", "kind", "count"} of the JAX devices; exits with
    status 1 when JAX finds no GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"needs an NVIDIA GPU; JAX found {devs[0].platform!r} "
              f"({devs[0].device_kind})", file=sys.stderr)
        raise SystemExit(1)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


# per top-level computation; the tracing event also fires for nested
# jits inside an outer trace, so it would count twice
_COMPILE_EVENTS = ("/jax/core/compile/jaxpr_to_mlir_module_duration",
                   "/jax/core/compile/backend_compile_duration")


class CompileClock:
    """Accumulates the seconds JAX reports for lowering and compiling
    programs, so a phase's compile time can be kept apart from its run
    time (tracing Python stays in the run time). The listener stays
    registered for the life of the process: make one clock per process
    and read differences of ``seconds``."""

    def __init__(self) -> None:
        self.seconds = 0.0
        monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event: str, duration: float, **_) -> None:
        if event in _COMPILE_EVENTS:
            self.seconds += duration
