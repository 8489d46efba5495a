"""Replica-exchange parallel tempering over a device mesh.

Reference parity: SURVEY.md §3 row "Parallel tempering" and §4.3
(DetQMCPT: MPI, one replica per rank at one value of a control-parameter
grid; every exchangeInterval sweeps the master proposes adjacent swaps of
the parameter VALUES with Metropolis
    p = min(1, exp[(r_i - r_j)(a_i - a_j)])
where a is the exchange-conjugate action piece — for the SDW model
a = dtau/2 * sum phi^2, so the fermion determinant never recomputes on a
swap; configurations never move, only parameter labels do).

Accelerator redesign (NOT an MPI translation):

- replicas are just a leading axis of the vmapped walker batch; on a
  multi-chip mesh that axis is sharded over a ``replica`` mesh axis
  (``shard_map``), so each chip owns a contiguous block of replicas;
- the exchange step is collective-free within a chip and needs ONE
  ``all_gather`` of (action scalar) per exchange across a mesh —
  every replica then computes the identical swap decisions
  deterministically (same key), so no master rank and no scatter exists
  (reference's master/gather/scatter pattern collapses into replicated
  arithmetic on gathered scalars);
- swaps alternate even/odd adjacent pairs (standard DEO scheme), each
  exchange sweep touching every pair once.

The module is model-agnostic: a model exposes ``exchange_action(state)``
(the r-conjugate scalar) and ``set_control_parameter`` semantics via the
``r_values`` array indexing trick — the *field configurations stay put*
while the replica->parameter assignment permutes, exactly like the
reference. The model must accept its control parameter as a traced value;
for SDW the bosonic r-term enters only through exp(-dS) in updates, so we
carry r in the walker state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class PTState(NamedTuple):
    """Replica-exchange bookkeeping (device arrays, replicated)."""

    param_of_replica: jax.Array   # (R,) int32: grid index held by replica k
    key: jax.Array                # PRNG key for swap decisions
    n_attempted: jax.Array        # (R-1,) pair attempt counts
    n_accepted: jax.Array         # (R-1,)
    parity: jax.Array             # int32: even/odd alternation


def init_pt(n_replicas: int, key: jax.Array) -> PTState:
    return PTState(
        param_of_replica=jnp.arange(n_replicas, dtype=jnp.int32),
        key=key,
        n_attempted=jnp.zeros(n_replicas - 1, jnp.int32),
        n_accepted=jnp.zeros(n_replicas - 1, jnp.int32),
        parity=jnp.asarray(0, jnp.int32),
    )


def exchange_step(pt: PTState, actions: jax.Array, r_values: jax.Array
                  ) -> PTState:
    """One replica-exchange step (even or odd adjacent pairs).

    actions: (R,) exchange-conjugate action a_k of each REPLICA's current
    configuration. r_values: (G,) control-parameter grid. The swap
    exchanges parameter indices between replicas (configurations stay).

    Accept probability for replicas (i, j) holding parameters (r_i, r_j):
        p = min(1, exp[(r_i - r_j)(a_i - a_j)])
    (reference formula, SURVEY.md §9 "Parallel tempering"; sign convention:
    the r-dependent action is +r*a, so swapping labels changes the total
    action by (r_i - r_j)(a_j - a_i)).
    """
    R = pt.param_of_replica.shape[0]
    key, sub = jax.random.split(pt.key)
    u = jax.random.uniform(sub, (R,))

    # order replicas by their current parameter index: swaps are between
    # ADJACENT PARAMETERS, not adjacent replica ids (reference semantics)
    replica_of_param = jnp.argsort(pt.param_of_replica)      # (R,)
    a_sorted = actions[replica_of_param]                      # by param idx
    r_sorted = r_values[jnp.sort(pt.param_of_replica)]

    # pair p = (2t + parity, 2t + parity + 1)
    idx = jnp.arange(R)
    is_left = ((idx - pt.parity) % 2 == 0) & (idx + 1 < R) & \
        (idx >= pt.parity)
    partner = jnp.where(is_left, idx + 1, idx)
    log_p = (r_sorted - r_sorted[partner]) * (a_sorted - a_sorted[partner])
    accept_left = is_left & (jnp.log(jnp.maximum(u, 1e-38)) < log_p)
    # a pair swaps iff its left member accepted
    swap_with_next = accept_left
    swap_with_prev = jnp.roll(swap_with_next, 1) & (idx > 0)
    # new parameter position for the replica currently at position idx
    new_pos = jnp.where(swap_with_next, idx + 1,
                        jnp.where(swap_with_prev, idx - 1, idx))
    # replica at sorted position idx is replica_of_param[idx]; it moves to
    # parameter new_pos
    new_param_of_replica = jnp.zeros_like(pt.param_of_replica)
    new_param_of_replica = new_param_of_replica.at[
        replica_of_param].set(new_pos.astype(jnp.int32))

    pair_idx = jnp.minimum(idx, R - 2)
    att = jnp.zeros(R - 1, jnp.int32).at[
        jnp.where(is_left, pair_idx, 0)].add(is_left.astype(jnp.int32))
    acc = jnp.zeros(R - 1, jnp.int32).at[
        jnp.where(is_left, pair_idx, 0)].add(accept_left.astype(jnp.int32))

    return PTState(
        param_of_replica=new_param_of_replica,
        key=key,
        n_attempted=pt.n_attempted + att,
        n_accepted=pt.n_accepted + acc,
        parity=1 - pt.parity,
    )


def exchange_step_sharded(pt: PTState, local_actions: jax.Array,
                          r_values: jax.Array, axis_name: str) -> PTState:
    """Mesh version: each shard holds a block of replicas; one all_gather
    of the action scalars over ICI, then the identical deterministic swap
    computation everywhere (no master). PTState is replicated."""
    actions = jax.lax.all_gather(local_actions, axis_name, tiled=True)
    return exchange_step(pt, actions, r_values)


def replica_r(pt: PTState, r_values: jax.Array) -> jax.Array:
    """Current control-parameter value of each replica: (R,)."""
    return r_values[pt.param_of_replica]
