"""Parallel-tempering driver (reference: DetQMCPT::run, SURVEY.md §4.3).

Runs R replicas of a model over a control-parameter grid; every
``exchange_interval`` sweep pairs the replica-exchange step swaps
parameter *labels* between replicas (configurations never move). Each
parameter value gets its own observable stream and output subdirectory —
the reference's per-r_k output contract.

Single-chip: replicas are the vmap axis. Multi-chip: shard the replica
axis over a mesh and use exchange_step_sharded (one all_gather of scalars
over ICI per exchange) — exercised by tests/test_pt.py on a virtual mesh
and by __graft_entry__.dryrun_multichip.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import partial
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from detqmc import checkpoint as ckpt_mod
from detqmc import compile_cache
from detqmc.driver import DriverConfig
from detqmc.metadata import Metadata, write_metadata
from detqmc.observables import ObservableHandler
from detqmc.parallel import pt as pt_mod
from detqmc.timing import timing


@dataclasses.dataclass(frozen=True)
class PTConfig:
    exchange_interval: int = 1   # sweep pairs between exchange attempts
    # which model parameter the exchange swaps (reference: the PT config's
    # controlParameter — "r" for the SDW model). Validated against the
    # model's declared ``control_parameter`` at driver construction and
    # echoed into the per-run metadata.
    control_parameter: str = "r"
    # independent PT systems vmapped into one device batch. The reference
    # runs ONE chain per parameter value (one MPI rank per replica); on an
    # accelerator that starves the device at batch=R small matrices. E
    # ensembles are E statistically independent R-replica PT systems —
    # every parameter value accumulates E chains' measurements, and the
    # device batch becomes E*R. On a mesh the ensemble axis shards over a
    # second ("dp") axis, making PT a 2-D (dp x replica) program.
    n_ensembles: int = 1


class DetQMCPT:
    """Owns R replica states + PT bookkeeping + per-parameter handlers."""

    def __init__(self, model, r_values: Sequence[float],
                 params: DriverConfig, pt_params: PTConfig = PTConfig(),
                 meta_extra: Optional[Metadata] = None):
        compile_cache.enable()
        self.model = model
        self.p = params
        self.ptp = pt_params
        supported = getattr(model, "control_parameter", "r")
        if pt_params.control_parameter != supported:
            from detqmc.exceptions import ConfigurationError

            raise ConfigurationError(
                f"PT control_parameter={pt_params.control_parameter!r} "
                f"but {type(model).__name__} exchanges "
                f"{supported!r} (its with_r/exchange_action hooks)")
        if params.n_walkers != 1:
            from detqmc.exceptions import ConfigurationError

            raise ConfigurationError(
                "DetQMCPT runs one chain per replica; for multiple "
                "chains per parameter value use PTConfig.n_ensembles "
                "(config key ptEnsembles) — got "
                f"n_walkers={params.n_walkers}")
        ne = max(1, int(pt_params.n_ensembles))
        if params.mesh_devices > 1:
            lead, what = ((ne, "ptEnsembles") if ne > 1
                          else (len(r_values), "replica count"))
            if lead % params.mesh_devices != 0:
                from detqmc.exceptions import ConfigurationError

                raise ConfigurationError(
                    f"{what} ({lead}) must divide evenly over "
                    f"meshDevices ({params.mesh_devices}) — the "
                    f"{'ensemble' if ne > 1 else 'replica'} axis is "
                    "the sharded one")
        self.r_values = jnp.asarray(np.asarray(r_values, np.float64),
                                    model.cfg.jdtype)
        self.R = len(r_values)
        self.E = max(1, int(pt_params.n_ensembles))
        self.meta = {k: str(v) for k, v in
                     dataclasses.asdict(model.cfg).items()}
        self.meta.update({
            "exchangeInterval": str(pt_params.exchange_interval),
            "controlParameter": pt_params.control_parameter,
            "controlParameterValues": ",".join(str(v) for v in r_values),
            "ptEnsembles": str(self.E),
            **(meta_extra or {}),
        })
        self.handlers = [
            ObservableHandler(
                outdir=None if params.outdir is None else
                os.path.join(params.outdir, f"p{k}"),
                jk_blocks=params.jk_blocks, timeseries=params.timeseries,
                meta={**self.meta, "r": str(float(r_values[k]))})
            for k in range(self.R)
        ]
        for h in self.handlers:
            h.register_vectors(getattr(model, "vector_observables", ()))
        self.measurements_done = 0
        self.therm_done = 0
        self._t_start = time.time()
        from detqmc.driver import ConsistencyLogger

        self._consistency = ConsistencyLogger(params.outdir, self.meta)
        self._phi_streams: Dict[int, Any] = {}

        vm = jax.vmap
        # E > 1: every per-system op maps over the leading ensemble axis
        # too (states carry (E, R, ...) leaves, PTState carries (E, ...))
        ev = (lambda f: jax.vmap(f)) if self.E > 1 else (lambda f: f)
        exchange = ev(lambda p, a: pt_mod.exchange_step(
            p, a, self.r_values))
        current_r = ev(lambda p: pt_mod.replica_r(p, self.r_values))

        def therm_round(carry, _):
            states, pt = carry
            states, _ = jax.lax.scan(
                lambda sts, x: (ev(vm(lambda s: model.sweep_pair(
                    s, measure=False)[0]))(sts), None),
                states, None, length=pt_params.exchange_interval)
            actions = ev(vm(model.exchange_action))(states)
            pt = exchange(pt, actions)
            states = ev(vm(model.with_r))(states, current_r(pt))
            return (states, pt), None

        def meas_round(carry, _):
            states, pt = carry
            def inner(sts, x):
                sts = ev(vm(lambda s: model.sweep_pair(
                    s, measure=False)[0]))(sts)
                return sts, None
            if pt_params.exchange_interval > 1:
                states, _ = jax.lax.scan(
                    inner, states, None,
                    length=pt_params.exchange_interval - 1)
            states, obs = ev(vm(
                lambda s: model.sweep_pair(s, measure=True)))(states)
            # the measurements above ran under the INCOMING parameter
            # assignment — tag them with it before the exchange step
            # reshuffles labels (tagging post-exchange would book every
            # accepted swap's measurements into the adjacent parameter's
            # stream, biasing all PT output)
            tag = pt.param_of_replica
            actions = ev(vm(model.exchange_action))(states)
            pt = exchange(pt, actions)
            states = ev(vm(model.with_r))(states, current_r(pt))
            return (states, pt), (obs, tag)

        self._therm_block = jax.jit(
            lambda c, n: jax.lax.scan(therm_round, c, None, length=n)[0],
            static_argnums=1)
        self._meas_block = jax.jit(
            lambda c, n: jax.lax.scan(meas_round, c, None, length=n),
            static_argnums=1)

        self.states = None
        self.pt_state = None

    # -- checkpoint / resume (reference: PT saves per-rank state + master
    # assignment, SURVEY.md §6 "Checkpoint / resume") ------------------------
    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.p.outdir is None:
            return None
        return os.path.join(self.p.outdir, "state")

    def save(self) -> None:
        if self._ckpt_path is None or self.states is None:
            return
        extra: Dict[str, np.ndarray] = {}
        for k, h in enumerate(self.handlers):
            for name, arr in h.state_dict().items():
                extra[f"p{k}|{name}"] = arr
        pt = self.pt_state
        extra["pt|param_of_replica"] = np.asarray(pt.param_of_replica)
        extra["pt|key"] = np.asarray(jax.random.key_data(pt.key))
        extra["pt|n_attempted"] = np.asarray(pt.n_attempted)
        extra["pt|n_accepted"] = np.asarray(pt.n_accepted)
        extra["pt|parity"] = np.asarray(pt.parity)
        manifest: Dict[str, Any] = {
            "measurements_done": self.measurements_done,
            "therm_done": self.therm_done,
            "meta": self.meta,
        }
        ckpt_mod.save_checkpoint(self._ckpt_path, self.states, extra,
                                 manifest)

    def init(self, resume: bool = True) -> None:
        loaded = None
        if resume and self._ckpt_path:
            loaded = ckpt_mod.load_checkpoint(self._ckpt_path)
        keys = jax.random.split(jax.random.key(self.p.seed),
                                self.E * self.R)
        if self.E > 1:
            keys = keys.reshape(self.E, self.R)
            init_states = jax.jit(jax.vmap(jax.vmap(
                self.model.init_state)))
            with_r_all = jax.vmap(
                lambda sts: jax.vmap(self.model.with_r)(
                    sts, self.r_values))
            refresh = jax.jit(jax.vmap(jax.vmap(
                self.model.refresh_from_field)))
            ptkeys = jax.random.split(
                jax.random.key(self.p.seed + 7919), self.E)
            init_pt_all = lambda: jax.vmap(  # noqa: E731
                partial(pt_mod.init_pt, self.R))(ptkeys)
        else:
            init_states = jax.jit(jax.vmap(self.model.init_state))
            with_r_all = lambda sts: jax.vmap(self.model.with_r)(  # noqa: E731
                sts, self.r_values)
            refresh = jax.jit(jax.vmap(self.model.refresh_from_field))
            init_pt_all = lambda: pt_mod.init_pt(  # noqa: E731
                self.R, jax.random.key(self.p.seed + 7919))
        if loaded is None:
            self.states = with_r_all(init_states(keys))
            self.pt_state = init_pt_all()
            self._shard_states()
            return
        arrays, extra, manifest = loaded
        saved_e = int(manifest.get("meta", {}).get("ptEnsembles", 1))
        if saved_e != self.E:
            from detqmc.exceptions import ConfigurationError

            raise ConfigurationError(
                f"checkpoint has ptEnsembles={saved_e}, run configured "
                f"with n_ensembles={self.E}")
        blank = init_states(keys)
        restored = ckpt_mod.restore_state(blank, arrays)
        self.states = refresh(restored)
        self.pt_state = pt_mod.PTState(
            param_of_replica=jnp.asarray(extra["pt|param_of_replica"],
                                         jnp.int32),
            key=jax.random.wrap_key_data(jnp.asarray(extra["pt|key"])),
            n_attempted=jnp.asarray(extra["pt|n_attempted"], jnp.int32),
            n_accepted=jnp.asarray(extra["pt|n_accepted"], jnp.int32),
            parity=jnp.asarray(extra["pt|parity"], jnp.int32),
        )
        for k, h in enumerate(self.handlers):
            pref = f"p{k}|"
            h.load_state_dict({key[len(pref):]: arr
                               for key, arr in extra.items()
                               if key.startswith(pref)})
        self.measurements_done = int(manifest.get("measurements_done", 0))
        self.therm_done = int(manifest.get("therm_done", 0))
        self._shard_states()

    def _shard_states(self) -> None:
        """Distribute the replica batch over a device mesh (no-op for
        mesh_devices <= 1; same GSPMD pattern as the single-run driver's
        walker sharding — the sharding propagates through the jitted
        blocks, the exchange bookkeeping stays replicated). With
        ensembles the ensemble axis shards (each device holds whole PT
        systems, so swaps never cross devices); otherwise the replica
        axis shards and the exchange's gather/argsort of (R,) scalars
        lowers to collectives over the mesh."""
        n_dev = self.p.mesh_devices
        if n_dev <= 1:
            return
        devs = jax.devices()[:n_dev]
        if len(devs) < n_dev:
            raise RuntimeError(
                f"mesh_devices={n_dev} but only {len(devs)} devices")
        lead, axis = (self.E, "dp") if self.E > 1 else (self.R, "replica")
        if lead % n_dev != 0:
            from detqmc.exceptions import ConfigurationError

            raise ConfigurationError(
                f"the {axis} axis ({lead}) must divide evenly over "
                f"mesh_devices ({n_dev})")
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.asarray(devs), (axis,))
        shard = NamedSharding(mesh, P(axis))
        self.states = jax.tree.map(
            lambda a: jax.device_put(a, shard), self.states)
        pt_spec = shard if self.E > 1 else NamedSharding(mesh, P())
        self.pt_state = jax.tree.map(
            lambda a: jax.device_put(a, pt_spec), self.pt_state)

    def _out_of_time(self, margin: float = 0.0) -> bool:
        if self.p.walltime_secs <= 0:
            return False
        return (time.time() - self._t_start + margin) >= self.p.walltime_secs

    def _dump_configs(self) -> None:
        """Per-parameter phi .binarystream dumps (reference:
        DetSDWSystemConfig per-replica config streams, SURVEY.md §3 "SDW
        config dumps"): each parameter value's stream receives the field
        of whichever replica currently holds that parameter, so the
        offline sdwcorr-over-PT pipeline reads a fixed-r ensemble."""
        if not (self.p.dump_config_stream and self.p.outdir
                and hasattr(self.states, "phi")):
            return
        from detqmc.io.binarystream import BinaryStreamWriter

        # (R, m, N, opdim), or (E, R, m, N, opdim) with ensembles
        phi = np.asarray(self.states.phi)
        if self.E == 1:
            phi = phi[None]
        # param -> replica, per ensemble: (E, R)
        rep_of_param = np.argsort(
            np.asarray(self.pt_state.param_of_replica).reshape(
                self.E, self.R), axis=-1)
        for k in range(self.R):
            if k not in self._phi_streams:
                self._phi_streams[k] = BinaryStreamWriter(
                    os.path.join(self.p.outdir, f"p{k}",
                                 "phi.binarystream"), phi.shape[2:])
            for e in range(self.E):
                self._phi_streams[k].append(phi[e, rep_of_param[e, k]])

    def run(self) -> Dict[int, Dict[str, Tuple[float, float]]]:
        """Thermalize + measure with walltime-aware checkpointing; a
        resumed run continues the exact Markov chain (reference: the
        batch-queue stop/resubmit pattern, SURVEY.md §6)."""
        if self.states is None:
            self.init()
        carry = (self.states, self.pt_state)
        ei = self.ptp.exchange_interval
        rounds_total = max(1, self.p.thermalization // ei)
        rounds_done = self.therm_done // ei
        t_block = 0.0
        while rounds_done < rounds_total:
            n = min(max(1, self.p.block_meas), rounds_total - rounds_done)
            t0 = time.time()
            with timing("thermalization"):
                carry = self._therm_block(carry, n)
                jax.block_until_ready(
                    carry[0].phi if hasattr(carry[0], "phi")
                    else carry[0].G)
            t_block = time.time() - t0
            rounds_done += n
            self.therm_done = rounds_done * ei
            self.states, self.pt_state = carry
            if self._out_of_time(margin=t_block):
                self.save()
                return {k: h.results()
                        for k, h in enumerate(self.handlers)}

        n_meas = self.p.n_measurements
        block = min(self.p.block_meas, max(1, n_meas))
        while self.measurements_done < n_meas:
            n = min(block, n_meas - self.measurements_done)
            t0 = time.time()
            with timing("measurement block"):
                carry, (obs, param_idx) = self._meas_block(carry, n)
                obs_np = {k: np.asarray(v)
                          for k, v in obs._asdict().items()}
            t_block = time.time() - t0
            pidx = np.asarray(param_idx)        # (T, R) or (T, E, R)
            # route each (measurement[, ensemble], replica) sample to its
            # parameter's handler: one boolean-mask selection per
            # parameter value (vectorized over the whole block; the mask
            # flattens every leading sample axis, so E>1 just contributes
            # E independent chains to each parameter's stream)
            for k in range(self.R):
                mask = pidx == k
                if not mask.any():
                    continue
                self.handlers[k].insert_batch(
                    {name: arr[mask] for name, arr in obs_np.items()})
            self.measurements_done += n
            self.states, self.pt_state = carry
            self._consistency.log(self.states)
            self._dump_configs()
            if (self.p.save_interval and self.measurements_done % max(
                    self.p.save_interval, 1) < block):
                self.save()
            if self._out_of_time(margin=t_block):
                self.save()
                break

        self.states, self.pt_state = carry
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
            info.update(self._consistency.info_entries())
            write_metadata(os.path.join(self.p.outdir, "info.dat"), info)
            # with ensembles the counters carry a leading E axis; the
            # reported per-pair rates aggregate all independent systems
            att = np.asarray(self.pt_state.n_attempted).reshape(
                self.E, self.R - 1).sum(axis=0)
            acc = np.asarray(self.pt_state.n_accepted).reshape(
                self.E, self.R - 1).sum(axis=0)
            with open(os.path.join(self.p.outdir, "exchange-rates.dat"),
                      "w") as f:
                f.write("# pair attempted accepted rate\n")
                for i in range(self.R - 1):
                    rate = acc[i] / max(att[i], 1)
                    f.write(f"{i} {att[i]} {acc[i]} {rate:.4f}\n")
        return results
