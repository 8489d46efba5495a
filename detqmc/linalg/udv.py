"""QR-based UdV factorization and stable Green's-function formulas.

This is the JAX form of the reference's stabilization primitive
(SURVEY.md §3 rows "UdV decomposition" / "DQMC core": ``udvDecompose``,
``greenFromUdV``, ``greenFromEye_and_UdV``). A long B-matrix chain has
condition number ~exp(beta*W); partial products are therefore kept in
factored form A = U @ diag(d) @ V with U unitary and d positive, and the
Green's function G = (1 + A)^{-1} is evaluated without ever forming the
ill-conditioned sum (SURVEY.md §9).

Convention used by the sweep (chosen so every ill-conditioned object is
sandwiched between *unitary* factors — no triangular inverses of stack
factors are ever needed, which is both more stable and more GEMM-friendly
than solve-heavy forms):

- "left" stack entries factor   B_l ... B_1          = U1 d1 V1   (straight)
- "right" stack entries factor (B_m ... B_{l+1})^H   = U2 d2 V2,
  i.e. B_m ... B_{l+1} = V2^H d2 U2^H                (transposed)

so that G(l) = [1 + (U1 d1 V1)(V2^H d2 U2^H)]^{-1}
             = U2 [U1^H U2 + d1 (V1 V2^H) d2]^{-1} U1^H

with the inner bracket re-UdV'd and range-split (d = max(d,1)*min(d,1))
before any product is formed.

All functions are pure, jit-safe, batchable (leading batch dims broadcast),
and run contractions at HIGHEST precision (no reduced-precision matmuls).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from detqmc.precision import mm, scale_cols, scale_rows


class UDV(NamedTuple):
    """A = U @ diag(d) @ V; U unitary, d > 0."""

    U: jax.Array  # (..., n, n)
    d: jax.Array  # (..., n)      positive, real
    V: jax.Array  # (..., n, n)


def _H(a: jax.Array) -> jax.Array:
    """Conjugate transpose (plain transpose for real dtypes)."""
    at = jnp.swapaxes(a, -1, -2)
    return jnp.conj(at) if jnp.issubdtype(a.dtype, jnp.complexfloating) else at


def udv_decompose(A: jax.Array) -> UDV:
    """QR-based UdV: A = Q R = (Q s) |diag(R)| (diag(conj(s)/|R_ii|) R).

    The phase/sign of R's diagonal is folded into U so d stays positive,
    matching the reference's convention (positive scales make log-domain
    bookkeeping and conditioning monitors straightforward).
    """
    Q, R = jnp.linalg.qr(A)
    return _sign_fix(A, Q, R)


def _sign_fix(A, Q, R) -> UDV:
    diag = jnp.diagonal(R, axis1=-2, axis2=-1)
    d = jnp.abs(diag)
    safe = jnp.where(d == 0, 1.0, d)  # guard degenerate input
    if jnp.issubdtype(A.dtype, jnp.complexfloating):
        sign = jnp.where(d == 0, 1.0 + 0j, diag / safe)
    else:
        sign = jnp.where(diag >= 0, 1.0, -1.0).astype(A.dtype)
    U = scale_cols(Q, sign)
    V = scale_rows(jnp.conj(sign) / safe, R)
    return UDV(U=U, d=d, V=V)


def udv_refactor(M: jax.Array, d: jax.Array, V: jax.Array,
                 compose_dtype=None) -> UDV:
    """UdV of (M @ diag(d) @ V) for well-conditioned M and positive d.

    Key trick: QR commutes with positive column scaling —
    Q(M diag(d)) == Q(M) and R(M diag(d)) == R(M) diag(d) — so we QR the
    *unscaled* M (column norms O(1); a direct QR of M diag(d) overflows
    fp32 column-norm accumulation once d spans ~1e20, which happens at
    beta >~ 6). The d and V compositions then happen in the log
    domain:
        M diag(d) = U_g diag(g_d) V_g diag(d)
                  = U_g diag(g_d * d) [V_g o (d_k / d_j)]        (j <= k)
    with the d-ratio evaluated as exp(log d_k - log d_j) and masked to the
    upper triangle (V_g is unit-diagonal upper triangular).

    ``compose_dtype``: precision for the d/V accumulation across the whole
    chain. The QR itself sees only one well-conditioned interval block, so
    it can stay in the run dtype; but d spans e^{+-beta W} and V
    accumulates multiplicatively over the chain — composing those in fp32
    limits the stabilized G to ~1e-3 at beta=8. Passing float64 here keeps
    the *accumulated* factors accurate with no f64 QR anywhere (U stays in
    the run dtype: it is orthogonal and carries no scale).
    """
    g = udv_decompose(M)
    cdt = compose_dtype or d.dtype
    rdt = jnp.finfo(cdt).dtype
    d = d.astype(rdt)
    d_new = g.d.astype(rdt) * d
    tiny = jnp.finfo(rdt).tiny
    n = M.shape[-1]
    upper = jnp.triu(jnp.ones((n, n), dtype=bool))
    # d_k / d_j directly: the ratio is bounded by the chain's d-SPREAD
    # (e^{2 beta W} ~ 1e55 at beta=8), far inside f64 range up to
    # beta ~ 25, so one divide per entry replaces a log/exp round trip.
    # In f32 compose mode the spread can overflow f32 at beta >~ 6, so
    # that path keeps the log-domain form.
    if rdt == jnp.float64:
        ds = jnp.maximum(d, tiny)
        ratio = jnp.where(upper,
                          ds[..., None, :] / ds[..., :, None], 0.0)
    else:
        logd = jnp.log(jnp.maximum(d, tiny))
        ratio = jnp.where(
            upper,
            jnp.exp(logd[..., None, :] - logd[..., :, None]), 0.0)
    Vb = g.V.astype(cdt) * ratio.astype(cdt)
    return UDV(U=g.U, d=d_new, V=mm(Vb, V.astype(cdt)))


def udv_multiply_left(B: jax.Array, f: UDV) -> UDV:
    """UdV of (B @ U d V): refactor (B U) d, accumulate V.

    Stack-advance step: extend a factored partial product by a freshly
    computed block of B matrices on the left (time grows leftward in
    B_m ... B_1). For the transposed right stack, pass B^H of the new block.
    """
    return udv_refactor(mm(B, f.U), f.d, f.V)


def udv_eye(n: int, dtype, batch_shape=()) -> UDV:
    eye = jnp.broadcast_to(jnp.eye(n, dtype=dtype), (*batch_shape, n, n))
    real_dtype = jnp.finfo(dtype).dtype  # f32 for c64, f64 for c128, etc.
    one = jnp.ones((*batch_shape, n), dtype=real_dtype)
    return UDV(U=eye, d=one, V=eye)


def green_from_two_udv(left: UDV, right_t: UDV,
                       compute_dtype=None) -> jax.Array:
    """Stable G(l) = (1 + B_{<=l} B_{>l})^{-1} from factored halves.

    left    straight UdV of B_l ... B_1            (= U1 d1 V1)
    right_t UdV of the conj-transposed right half: (B_m ... B_{l+1})^H
            (= U2 d2 V2), so B_{>l} = V2^H d2 U2^H.

    G = U2 [ d1max (d1max^{-1} U1^H U2 d2max^{-1}
             + d1min (V1 V2^H) d2min) d2max ]^{-1} U1^H

    where dmax = max(d, 1), dmin = min(d, 1) bound every formed product's
    dynamic range. Only the inner re-UdV's V' is triangular-solved; all
    other inverses are unitary transposes.
    (Reference parity: greenFromUdV / advanceUp(Down)Green, SURVEY.md §9.)

    ``compute_dtype``: precision island for the inner combine/QR/solve.
    The inner matrix's condition grows like exp(beta * W), so fp32 drowns
    past beta ~ 4-5; passing float64 here (about 7 matmul-equivalents per
    call) restores dev ~ 1e-7 while the rest of the sweep stays fp32.
    Inputs are upcast, G is cast back.
    """
    out_dtype = left.U.dtype
    if compute_dtype is not None and compute_dtype != out_dtype:
        cast = lambda a: a.astype(compute_dtype)  # noqa: E731
        left = UDV(cast(left.U), left.d.astype(
            jnp.finfo(compute_dtype).dtype), cast(left.V))
        right_t = UDV(cast(right_t.U), right_t.d.astype(
            jnp.finfo(compute_dtype).dtype), cast(right_t.V))
    d1 = left.d.astype(left.U.real.dtype)
    d2 = right_t.d.astype(left.U.real.dtype)
    d1max, d1min = jnp.maximum(d1, 1.0), jnp.minimum(d1, 1.0)
    d2max, d2min = jnp.maximum(d2, 1.0), jnp.minimum(d2, 1.0)
    UhU = mm(_H(left.U), right_t.U)            # U1^H U2
    VVh = mm(left.V, _H(right_t.V))            # V1 V2^H
    inner = (scale_cols(scale_rows(1.0 / d1max, UhU), 1.0 / d2max)
             + scale_cols(scale_rows(d1min, VVh), d2min))
    g = udv_decompose(inner)
    # G = U2 d2max^{-1} V'^{-1} d'^{-1} U'^H d1max^{-1} U1^H
    rhs = scale_rows(1.0 / g.d.astype(d1.dtype),
                     scale_cols(_H(g.U), 1.0 / d1max))
    # g.V is unit-diagonal upper triangular by construction
    mid = jax.lax.linalg.triangular_solve(
        g.V, rhs.astype(g.V.dtype), left_side=True, lower=False)
    G = mm(scale_cols(right_t.U, 1.0 / d2max), mm(mid, _H(left.U)))
    return G.astype(out_dtype)


def green_from_udv(f: UDV) -> jax.Array:
    """Stable G = (1 + U d V)^{-1} for a straight full-chain factorization
    (used at sweep boundaries and after global moves).

    Implemented as the pair formula with an identity other half.
    """
    n = f.U.shape[-1]
    eye_t = udv_eye(n, f.U.dtype, batch_shape=f.d.shape[:-1])
    return green_from_two_udv(f, eye_t)


def green_tau_zero(left: UDV, right_t: UDV, compute_dtype=None
                   ) -> jax.Array:
    """Stable time-displaced G(tau, 0) = B(tau,0) [1 + B(beta,0)]^{-1}.

    Via the identity A(1+CA)^{-1} = [A^{-1} + C]^{-1} with A = B(tau,0)
    = U1 d1 V1 (left stack entry) and C = B(beta,tau) = V2^H d2 U2^H
    (transposed right entry):

        G(tau,0) = U2 [d1^{-1} U1^H U2 + (V1 V2^H) d2]^{-1} V1
                 = U2 D2max^{-1} inner^{-1} (D1min V1)

    where `inner` is EXACTLY the range-split matrix of the equal-time pair
    formula — only the right-hand side and outer scalings differ. All
    scalings stay bounded (d1min <= 1, 1/d2max <= 1).
    (Reference parity: time-displaced Green support, SURVEY.md §3 "DQMC
    core" and §9 "Unequal-time".)
    """
    out_dtype = left.U.dtype
    if compute_dtype is not None and compute_dtype != out_dtype:
        cast = lambda a: a.astype(compute_dtype)  # noqa: E731
        rdt = jnp.finfo(compute_dtype).dtype
        left = UDV(cast(left.U), left.d.astype(rdt), cast(left.V))
        right_t = UDV(cast(right_t.U), right_t.d.astype(rdt),
                      cast(right_t.V))
    d1 = left.d.astype(left.U.real.dtype)
    d2 = right_t.d.astype(left.U.real.dtype)
    d1max, d1min = jnp.maximum(d1, 1.0), jnp.minimum(d1, 1.0)
    d2max, d2min = jnp.maximum(d2, 1.0), jnp.minimum(d2, 1.0)
    UhU = mm(_H(left.U), right_t.U)
    VVh = mm(left.V, _H(right_t.V))
    inner = (scale_cols(scale_rows(1.0 / d1max, UhU), 1.0 / d2max)
             + scale_cols(scale_rows(d1min, VVh), d2min))
    g = udv_decompose(inner)
    rhs = scale_rows(1.0 / g.d.astype(d1.dtype),
                     mm(_H(g.U), scale_rows(d1min, left.V)))
    mid = jax.lax.linalg.triangular_solve(
        g.V, rhs.astype(g.V.dtype), left_side=True, lower=False)
    G = mm(scale_cols(right_t.U, 1.0 / d2max), mid)
    return G.astype(out_dtype)


def log_det_one_plus_udv(f: UDV) -> Tuple[jax.Array, jax.Array]:
    """(log|det(1 + UdV)|, sign/phase) in the log domain.

    Used for global-move Metropolis ratios (the reference recomputes the
    stabilized determinant for globalShift/Wolff accepts, SURVEY.md §4.1).
    det(1 + UdV) = det(U) * det(U^H V^{-1} + d) * det(V); computed via the
    range-split inner matrix so no overflow occurs.
    """
    n = f.U.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(n, dtype=f.U.dtype), f.U.shape)
    Vinv = jnp.linalg.solve(f.V, eye)
    d = f.d.astype(f.U.real.dtype)
    dmax, dmin = jnp.maximum(d, 1.0), jnp.minimum(d, 1.0)
    # 1 + UdV = U dmax (dmax^{-1} U^H V^{-1} + dmin) V  (det of each factor)
    inner = scale_rows(1.0 / dmax, mm(_H(f.U), Vinv)) + _diag_embed(
        dmin.astype(f.U.dtype))
    sU, ldU = jnp.linalg.slogdet(f.U)
    sI, ldI = jnp.linalg.slogdet(inner)
    sV, ldV = jnp.linalg.slogdet(f.V)
    log_dmax = jnp.log(dmax).sum(axis=-1)
    return ldU + ldI + ldV + log_dmax, sU * sI * sV


def _diag_embed(d: jax.Array) -> jax.Array:
    n = d.shape[-1]
    return d[..., :, None] * jnp.eye(n, dtype=d.dtype)


def singular_value_range(f: UDV) -> Tuple[jax.Array, jax.Array]:
    """(log10 max d, log10 min d): the conditioning monitor the reference
    exposes via its logSV instrumentation (SURVEY.md §5 item 1)."""
    logd = jnp.log10(jnp.maximum(f.d, jnp.finfo(f.d.dtype).tiny))
    return logd.max(axis=-1), logd.min(axis=-1)
