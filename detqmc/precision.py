"""Matmul-precision helpers.

Accelerators may run float32 matmuls at reduced precision by default
(TF32 on NVIDIA GPUs keeps about three decimal digits), which is far too
coarse for DQMC stabilization (the whole point of the UdV machinery is
taming condition-number growth; see SURVEY.md §9 "Wrapping &
stabilization"). Every core contraction in this package goes through these
helpers so matmuls run at full precision regardless of global config.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

HIGHEST = jax.lax.Precision.HIGHEST

_setup_done: set = set()


def ensure_runtime(need_x64: bool) -> None:
    """Idempotent process-level precision setup, called once per
    requirement by model constructors (and available for explicit use at
    program entry).

    - ``need_x64``: the stabilization precision island stores real f64
      arrays (stack scales/V factors), which requires jax_enable_x64.
      All hot-path state carries explicit f32 dtypes, so enabling x64
      does not change the compiled sweep programs.
    - matmul precision: jnp.linalg.qr's internal contractions honor the
      GLOBAL default, which may be a reduced-precision mode (TF32 on
      NVIDIA GPUs) — catastrophic for stabilization QRs. Package
      contractions pass HIGHEST explicitly (``mm``); the
      global default covers library internals.

    Centralized here (instead of ad-hoc mutations inside each model
    __init__) so repeated construction is a no-op and the policy is
    auditable in one place. Changing these flags mid-process invalidates
    jit caches, hence the set-once guard.
    """
    if "matmul" not in _setup_done:
        if jax.config.jax_default_matmul_precision is None:
            jax.config.update("jax_default_matmul_precision", "highest")
        _setup_done.add("matmul")
    if need_x64 and "x64" not in _setup_done:
        if not jax.config.jax_enable_x64:
            jax.config.update("jax_enable_x64", True)
        _setup_done.add("x64")


def mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Matrix multiply at highest available precision for the input dtype."""
    return jnp.matmul(a, b, precision=HIGHEST)


def mm3(a: jax.Array, b: jax.Array, c: jax.Array) -> jax.Array:
    """a @ b @ c at highest precision (left to right)."""
    return mm(mm(a, b), c)


def scale_cols(a: jax.Array, d: jax.Array) -> jax.Array:
    """a @ diag(d) without forming the diagonal matrix."""
    return a * d[..., None, :]


def scale_rows(d: jax.Array, a: jax.Array) -> jax.Array:
    """diag(d) @ a without forming the diagonal matrix."""
    return d[..., :, None] * a
