"""Fused Hubbard Metropolis slice update for the GPU (Pallas, Triton route).

Same contract and arithmetic as ``HubbardModel._update_slice`` (the
``lax.scan`` reference): N sequential single-site Metropolis steps with
Sherman-Morrison rank-1 updates of G. The scan costs N dependent XLA
steps per slice, each a tiny op over the walker batch; here one program
per walker holds its (ncomp, P, P) f32 G in registers for the whole slice
(P = N padded to a power of two), loops over the N sites inside the
kernel, takes row i and column i by masked reductions, applies each
accepted rank-1 update in registers, and stores G once.

Per site i (reference: DetHubbard::updateInSlice, SURVEY.md §9
"Hubbard HS"):
    delta_c = exp(-2 sgn_c alpha s_i) - 1      (precomputed per slice)
    R_c     = 1 + delta_c (1 - G_c[i, i])
    accept  = u01_i < |R_up R_dn|      (ncomp=1: R^2/(1+delta), ph mode)
    G_c    -= (delta_c/R_c) * G_c[:, i] (x) (e_i - G_c[i, :])
    s_i    -> -s_i on accept; sign *= sign(R_tot)

The walker batch becomes the kernel grid through ``pallas_call``'s own
vmap rule: one program per walker. ``delta`` is computed outside the
kernel by the same XLA expression as the scan, so both paths see the
same bits; each site's field value is still its slice-start value when
it is visited.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

# Largest lattice the kernel takes: a 64 x 64 f32 tile is 32 registers a
# thread per spin component over 4 warps; larger N goes to the scan.
MAX_N = 64
_MIN_P = 16


def _kernel(g_ref, f_ref, u_ref, d_ref, g_out, f_out, sfac_out, cnt_out,
            *, n: int, ncomp: int, ph_on: bool):
    P = f_ref.shape[0]
    rows = jax.lax.broadcasted_iota(jnp.int32, (P, P), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (P, P), 1)
    idx = jax.lax.broadcasted_iota(jnp.int32, (P,), 0)
    u01 = u_ref[...]
    deltas = [d_ref[c, :] for c in range(ncomp)]

    def site_step(i, carry):
        *Gs, field, sfac, cnt = carry
        sel = idx == i
        u_i = jnp.sum(jnp.where(sel, u01, 0.0))
        d_i, cols_i, rows_i, R = [], [], [], []
        for c in range(ncomp):
            col = jnp.sum(jnp.where(cols == i, Gs[c], 0.0), axis=1)
            row = jnp.sum(jnp.where(rows == i, Gs[c], 0.0), axis=0)
            gii = jnp.sum(jnp.where(sel, col, 0.0))
            d = jnp.sum(jnp.where(sel, deltas[c], 0.0))
            d_i.append(d)
            cols_i.append(col)
            rows_i.append(row)
            R.append(1.0 + d * (1.0 - gii))
        if ph_on:
            # R_dn = e^{2 alpha s} R_up = R_up / (1 + delta_up)
            r_tot = R[0] * R[0] / (1.0 + d_i[0])
        else:
            r_tot = R[0] * R[1]
        accept = u_i < jnp.abs(r_tot)
        new_G = []
        for c in range(ncomp):
            coef = jnp.where(accept, d_i[c] / R[c], 0.0)
            u = coef * cols_i[c]
            w = jnp.where(sel, 1.0 - rows_i[c], -rows_i[c])   # e_i - G_i.
            new_G.append(Gs[c] - u[:, None] * w[None, :])
        field = jnp.where(sel & accept, -field, field)
        sfac = jnp.where(accept, sfac * jnp.sign(r_tot), sfac)
        cnt = cnt + accept.astype(jnp.float32)
        return (*new_G, field, sfac, cnt)

    init = tuple(g_ref[c, :, :] for c in range(ncomp)) + (
        f_ref[...], jnp.float32(1.0), jnp.float32(0.0))
    *Gs, field, sfac, cnt = jax.lax.fori_loop(0, n, site_step, init)
    for c in range(ncomp):
        g_out[c, :, :] = Gs[c]
    f_out[...] = field
    sfac_out[...] = sfac
    cnt_out[...] = cnt


def padded_size(n: int) -> int:
    """Power-of-two tile edge P >= n (Triton block shapes)."""
    return max(_MIN_P, pl.next_power_of_2(n))


def slice_update(G, field_l, u01, sign, *, alpha: float, ph_on: bool,
                 interpret: bool = False):
    """f(G (C,N,N) f32, field_l (N,), u01 (N,), sign scalar) ->
    (G', field_l', sign', acc_rate), the contract of
    ``HubbardModel.update_slice``. Under ``vmap`` the walker axis becomes
    the kernel grid. ``interpret`` runs the Pallas interpreter (tests on
    machines without a GPU)."""
    ncomp, n = G.shape[0], G.shape[-1]
    if n > MAX_N:
        raise ValueError(f"slice_update takes N <= {MAX_N}, got {n}")
    if G.dtype != jnp.float32:
        raise ValueError(f"slice_update needs float32 G, got {G.dtype}")
    P = padded_size(n)
    pad = P - n
    ss = jnp.asarray([1.0, -1.0][:ncomp], jnp.float32)
    delta = jnp.exp(-2.0 * ss[:, None] * alpha * field_l[None, :]) - 1.0
    # inert padding: zero G rows/cols stay zero under every update, and
    # the padded sites are never visited (u01 = +inf would reject them)
    Gp = jnp.pad(G, ((0, 0), (0, pad), (0, pad)))
    fp = jnp.pad(field_l, (0, pad), constant_values=1.0)
    up = jnp.pad(u01, (0, pad), constant_values=jnp.inf)
    dp = jnp.pad(delta, ((0, 0), (0, pad)))
    f32 = jnp.float32
    call = pl.pallas_call(
        functools.partial(_kernel, n=n, ncomp=ncomp, ph_on=ph_on),
        out_shape=(jax.ShapeDtypeStruct((ncomp, P, P), f32),
                   jax.ShapeDtypeStruct((P,), field_l.dtype),
                   jax.ShapeDtypeStruct((), f32),
                   jax.ShapeDtypeStruct((), f32)),
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=4 if P <= 64 else 8, num_stages=1),
        interpret=interpret,
        name="hubbard_slice_update",
    )
    G_o, f_o, sfac, cnt = call(Gp, fp, up, dp)
    acc = cnt / jnp.asarray(n, f32)
    return (G_o[:, :n, :n], f_o[:n], sign * sfac.astype(sign.dtype),
            acc.astype(field_l.dtype))
