"""Det-coupled parallel tempering: config swaps over any model parameter.

The label-swap PT (parallel/pt.py + pt_driver.py) covers parameters
whose action is LINEAR with a fermion-det-free exchange weight (SDW r,
Hubbard stagger_h) — the reference's own scheme (SURVEY.md §9 "Parallel
tempering": "fermion det independent of r => no det recompute on swap";
src/detqmcpt.h). Tempering a parameter the DETERMINANT depends on —
beta (via dtau at fixed m), the coupling U / lambda, mu — needs the
fermionic weight difference at swap time:

    log p = [log w_g(C') + log w_g'(C)] - [log w_g(C) + log w_g'(C')]

where w_g(C) = e^{-S_B(C; p_g)} |det(1 + B-chain(C; p_g))| is the full
configuration weight under grid value p_g (models expose it as
``log_weight``, one stabilized chain build + log-det — the same cost
class as a global-move accept, amortized over exchange_interval).

Accelerator redesign (NOT an MPI translation):

- one model INSTANCE per grid value: every dtau/alpha/expK constant is
  compiled into that value's program, so the sweep kernels never see a
  traced parameter (XLA-friendly; the reference's equivalent is its
  runtime->compile-time template dispatch);
- the swap moves the CONFIGURATION between adjacent grid positions, not
  the label: on-chip that is a cheap HBM gather of the field array
  (phi: ~60 KB at L=8 m=80), nothing like the MPI-era cost that forced
  the reference's label-swap design. Position k therefore always
  samples at value p_k and its measurements route straight to value
  k's observable stream — no retagging;
- after an accepted swap both positions rebuild G + UdV stacks from
  the moved field (``refresh_from_field``, the checkpoint-restore
  path), because the old factors were built at the other parameter
  value;
- E ensembles vmap per grid value (batch E per program), the DEO
  even/odd pair alternation matches pt.py.

Adaptive proposal-width note: widths (SDW box_width) are POSITION-bound
here (the config moves under them), while the reference's label-swap
keeps tuning replica-bound. Both are valid Markov schemes once widths
freeze after thermalization; thermalization-phase swaps simply tune
each position for its own parameter value — arguably the better target.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from detqmc import checkpoint as ckpt_mod
from detqmc import compile_cache
from detqmc.driver import DriverConfig
from detqmc.exceptions import ConfigurationError
from detqmc.metadata import write_metadata
from detqmc.observables import ObservableHandler
from detqmc.timing import timing


@dataclasses.dataclass(frozen=True)
class DetPTConfig:
    exchange_interval: int = 1    # sweep pairs between exchange attempts
    control_parameter: str = "beta"   # metadata only (grid lives in the
    #                                   per-value model configs)
    n_ensembles: int = 1          # independent chains per grid value


def _config_leaf(state) -> str:
    """Name of the state leaf that carries the sampled configuration."""
    for name in ("phi", "field"):
        if hasattr(state, name):
            return name
    raise ConfigurationError(
        "det-PT needs a state with a 'phi' or 'field' leaf")


class DetQMCPTDet:
    """Config-swap PT over a list of per-grid-value model instances."""

    def __init__(self, models: Sequence[Any], values: Sequence[float],
                 params: DriverConfig,
                 pt_params: DetPTConfig = DetPTConfig(),
                 meta_extra: Optional[Dict[str, str]] = None):
        compile_cache.enable()
        if len(models) != len(values) or len(models) < 2:
            raise ConfigurationError(
                f"need one model per grid value (>= 2): got "
                f"{len(models)} models, {len(values)} values")
        if params.n_walkers != 1:
            raise ConfigurationError(
                "DetQMCPTDet runs one chain per (value, ensemble); use "
                "DetPTConfig.n_ensembles for more chains per value")
        self.models = list(models)
        self.values = [float(v) for v in values]
        self.p = params
        self.ptp = pt_params
        self.G = len(models)
        self.E = max(1, int(pt_params.n_ensembles))
        self.meta = {k: str(v) for k, v in
                     dataclasses.asdict(models[0].cfg).items()}
        self.meta.update({
            "exchangeInterval": str(pt_params.exchange_interval),
            "controlParameter": pt_params.control_parameter,
            "controlParameterValues": ",".join(
                str(v) for v in self.values),
            "ptEnsembles": str(self.E),
            "ptScheme": "det-coupled config swap",
            **(meta_extra or {}),
        })
        self.handlers = [
            ObservableHandler(
                outdir=None if params.outdir is None else
                os.path.join(params.outdir, f"p{k}"),
                jk_blocks=params.jk_blocks, timeseries=params.timeseries,
                meta={**self.meta,
                      pt_params.control_parameter: str(self.values[k])})
            for k in range(self.G)
        ]
        for h in self.handlers:
            h.register_vectors(getattr(models[0],
                                       "vector_observables", ()))

        vm = jax.vmap
        self._sweep_n = [
            jax.jit(lambda sts, n, m=m: jax.lax.scan(
                lambda s, _: (vm(lambda x: m.sweep_pair(
                    x, measure=False)[0])(s), None),
                sts, None, length=n)[0], static_argnums=1)
            for m in self.models]
        self._sweep_meas = [
            jax.jit(vm(lambda s, m=m: m.sweep_pair(s, measure=True)))
            for m in self.models]
        self._logw = [jax.jit(vm(m.log_weight)) for m in self.models]
        self._refresh = [jax.jit(vm(m.refresh_from_field))
                         for m in self.models]
        self._init_states = [jax.jit(vm(m.init_state))
                             for m in self.models]

        self.states: Optional[List[Any]] = None
        self.key = None
        self.parity = 0
        self.n_attempted = np.zeros(self.G - 1, np.int64)
        self.n_accepted = np.zeros(self.G - 1, np.int64)
        self.measurements_done = 0
        self.therm_done = 0
        self._t_start = time.time()
        from detqmc.driver import ConsistencyLogger

        self._consistency = ConsistencyLogger(params.outdir, self.meta)

    # ---- exchange ----------------------------------------------------------
    def _exchange(self) -> None:
        """One DEO exchange round (even or odd adjacent value pairs).

        Per pair (g, g+1) and ensemble lane e: evaluate the four full
        log-weights, accept with min(1, exp Delta), swap the field
        configurations of accepting lanes and rebuild their G/stacks at
        the new parameter value."""
        leaf = _config_leaf(self.states[0])
        self.key, sub = jax.random.split(self.key)
        u = np.asarray(jax.random.uniform(sub, (self.G - 1, self.E),
                                          dtype=jnp.float32))
        # own weights, computed once per position in this round
        pos_in_pair = set()
        for g in range(self.parity, self.G - 1, 2):
            pos_in_pair.update((g, g + 1))
        own = {}
        fields = {g: getattr(self.states[g], leaf) for g in pos_in_pair}
        for g in sorted(pos_in_pair):
            own[g] = self._logw[g](fields[g])
        for g in range(self.parity, self.G - 1, 2):
            lw_cross_lo = self._logw[g](fields[g + 1])    # C' under p_g
            lw_cross_hi = self._logw[g + 1](fields[g])    # C under p_g+1
            delta = np.asarray(
                (lw_cross_lo + lw_cross_hi) - (own[g] + own[g + 1]),
                np.float64)
            accept = np.log(np.maximum(u[g], 1e-38)) < delta
            self.n_attempted[g] += self.E
            self.n_accepted[g] += int(accept.sum())
            if not accept.any():
                continue
            mask = jnp.asarray(accept)

            def pick(mine, other):
                m = mask.reshape(mask.shape + (1,) * (mine.ndim - 1))
                return jnp.where(m, other, mine)

            f_lo, f_hi = fields[g], fields[g + 1]
            st_lo = self.states[g]._replace(**{leaf: pick(f_lo, f_hi)})
            st_hi = self.states[g + 1]._replace(
                **{leaf: pick(f_hi, f_lo)})
            self.states[g] = self._refresh[g](st_lo)
            self.states[g + 1] = self._refresh[g + 1](st_hi)
        self.parity = 1 - self.parity

    # ---- checkpoint --------------------------------------------------------
    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.p.outdir is None:
            return None
        return os.path.join(self.p.outdir, "state")

    def save(self) -> None:
        if self._ckpt_path is None or self.states is None:
            return
        stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *self.states)
        extra: Dict[str, np.ndarray] = {}
        for k, h in enumerate(self.handlers):
            for name, arr in h.state_dict().items():
                extra[f"p{k}|{name}"] = arr
        extra["pt|key"] = np.asarray(jax.random.key_data(self.key))
        extra["pt|parity"] = np.asarray(self.parity)
        extra["pt|n_attempted"] = self.n_attempted
        extra["pt|n_accepted"] = self.n_accepted
        manifest = {
            "measurements_done": self.measurements_done,
            "therm_done": self.therm_done,
            "meta": self.meta,
        }
        ckpt_mod.save_checkpoint(self._ckpt_path, stacked, extra,
                                 manifest)

    def init(self, resume: bool = True) -> None:
        loaded = None
        if resume and self._ckpt_path:
            loaded = ckpt_mod.load_checkpoint(self._ckpt_path)
        keys = jax.random.split(jax.random.key(self.p.seed),
                                self.G * self.E).reshape(
                                    self.G, self.E)
        blank = [self._init_states[g](keys[g]) for g in range(self.G)]
        self.key = jax.random.key(self.p.seed + 7919)
        if loaded is None:
            self.states = blank
            return
        arrays, extra, manifest = loaded
        stacked_blank = jax.tree.map(lambda *xs: jnp.stack(xs), *blank)
        restored = ckpt_mod.restore_state(stacked_blank, arrays)
        unstacked = [jax.tree.map(lambda a, g=g: a[g], restored)
                     for g in range(self.G)]
        self.states = [self._refresh[g](unstacked[g])
                       for g in range(self.G)]
        self.key = jax.random.wrap_key_data(jnp.asarray(extra["pt|key"]))
        self.parity = int(extra["pt|parity"])
        self.n_attempted = np.asarray(extra["pt|n_attempted"], np.int64)
        self.n_accepted = np.asarray(extra["pt|n_accepted"], np.int64)
        for k, h in enumerate(self.handlers):
            pref = f"p{k}|"
            h.load_state_dict({key[len(pref):]: arr
                               for key, arr in extra.items()
                               if key.startswith(pref)})
        self.measurements_done = int(manifest.get("measurements_done", 0))
        self.therm_done = int(manifest.get("therm_done", 0))

    def _out_of_time(self, margin: float = 0.0) -> bool:
        if self.p.walltime_secs <= 0:
            return False
        return (time.time() - self._t_start
                + margin) >= self.p.walltime_secs

    # ---- run ---------------------------------------------------------------
    def run(self) -> Dict[int, Dict[str, Tuple[float, float]]]:
        if self.states is None:
            self.init()
        ei = self.ptp.exchange_interval
        leaf = _config_leaf(self.states[0])

        rounds_total = max(1, self.p.thermalization // ei)
        t_block = 0.0
        while self.therm_done // ei < rounds_total:
            t0 = time.time()
            with timing("thermalization"):
                for g in range(self.G):
                    self.states[g] = self._sweep_n[g](self.states[g], ei)
                self._exchange()
                jax.block_until_ready(getattr(self.states[0], leaf))
            t_block = time.time() - t0
            self.therm_done += ei
            if self._out_of_time(margin=t_block):
                self.save()
                return {k: h.results()
                        for k, h in enumerate(self.handlers)}

        n_meas = self.p.n_measurements
        while self.measurements_done < n_meas:
            t0 = time.time()
            with timing("measurement round"):
                for g in range(self.G):
                    if ei > 1:
                        self.states[g] = self._sweep_n[g](
                            self.states[g], ei - 1)
                    self.states[g], obs = self._sweep_meas[g](
                        self.states[g])
                    self.handlers[g].insert_batch(
                        {name: np.asarray(v)
                         for name, v in obs._asdict().items()})
                self._exchange()
            t_block = time.time() - t0
            self.measurements_done += 1
            if (self.p.save_interval and self.measurements_done
                    % max(self.p.save_interval, 1) == 0):
                self.save()
            if self._out_of_time(margin=t_block):
                self.save()
                break

        self.save()
        results = {}
        for k, h in enumerate(self.handlers):
            if h.outdir:
                os.makedirs(h.outdir, exist_ok=True)
                h.write_output()
                write_metadata(os.path.join(h.outdir, "info.dat"),
                               dict(h.meta))
            results[k] = h.results()
        if self.p.outdir:
            info = dict(self.meta)
            info["measurementsDone"] = str(self.measurements_done)
            write_metadata(os.path.join(self.p.outdir, "info.dat"), info)
            with open(os.path.join(self.p.outdir,
                                   "exchange-rates.dat"), "w") as f:
                f.write("# pair attempted accepted rate\n")
                for i in range(self.G - 1):
                    rate = self.n_accepted[i] / max(self.n_attempted[i],
                                                    1)
                    f.write(f"{i} {self.n_attempted[i]} "
                            f"{self.n_accepted[i]} {rate:.4f}\n")
        return results
