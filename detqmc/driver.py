"""Monte-Carlo driver: thermalize, sweep, measure, checkpoint, resume.

Reference parity: SURVEY.md §3 row "MC driver" (DetQMC<Model>::run —
thermalization, measurement sweeps every measureInterval, periodic
saveState every saveInterval, wall-time budget awareness, resume, final
results) and §4.1's call stack.

Structure: the device program is a single jitted "block" — a
``lax.scan`` over measurements, each measurement being ``measure_interval``
sweep pairs — batched over vmapped walkers. The host loop only runs between
blocks: observable accumulation, .series appends, checkpoints, wall-time
checks. Device stays hot; host work is O(observables), not O(N^3).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from detqmc import checkpoint as ckpt_mod
from detqmc import compile_cache
from detqmc.metadata import Metadata, write_metadata
from detqmc.observables import ObservableHandler
from detqmc.timing import timing


@dataclasses.dataclass(frozen=True)
class DriverConfig:
    """Reference: DetQMCParams (SURVEY.md §3 "Config/flag system").

    All sweep counts are in *sweep pairs* (one down+up pass = 2 reference
    sweeps) so the compiled step is direction-free.
    """

    sweeps: int = 200              # production measurements... see below
    thermalization: int = 100      # thermalization sweep pairs
    measure_interval: int = 1      # sweep pairs between measurements
    save_interval: int = 0         # measurements between checkpoints (0=off)
    jk_blocks: int = 20
    timeseries: bool = False
    walltime_secs: float = 0.0     # 0 = unlimited (grantedWalltimeSecs)
    outdir: Optional[str] = None
    n_walkers: int = 1
    seed: int = 0
    block_meas: int = 25           # measurements per device block
    timedisplaced: bool = False    # unequal-time G(k, tau) once per block
    # resolve G(k, tau) at every slice (m+1 tau points, B-wrapped between
    # stabilization anchors — the reference's TimeDisplaced resolution)
    # instead of the K+1 stabilization-grid points; the wrap deviation is
    # recorded as the timeDisplacedDev observable
    timedisplaced_slices: bool = False
    # tau-integrated current-current correlator Lambda_xx(q, iw=0) +
    # superfluid stiffness rho_s once per block (Hubbard; needs the
    # G(0,tau)/G(tau,tau) reverse chains on top of G(tau,0))
    current_correlators: bool = False
    # shard the walker axis over this many devices (0 = single device;
    # walkers are embarrassingly parallel, so XLA partitions the vmapped
    # blocks across the mesh with no collectives — the device-mesh
    # generalization of launching independent reference processes)
    mesh_devices: int = 0
    # adaptive proposal-width tuning during thermalization (models whose
    # state carries box_width; reference: updateInSliceThermalization's
    # acceptance-ratio targeting)
    target_acc_ratio: float = 0.5
    tune_proposals: bool = True
    dump_config_stream: bool = False  # phi .binarystream dumps per block
    # auto-stabilization: when the walker-median wrapped-vs-stabilized
    # Green deviation exceeds green_dev_threshold after a thermalization
    # block, step the stabilization interval s down to the next divisor
    # of m (<= s/2) and rebuild the programs — the automated form of the
    # reference's "decrease s when the consistency check trips" guidance
    # (SURVEY.md §5 item 1). Fires during thermalization only, so the
    # measurement program stays fixed.
    auto_stabilize: bool = False
    green_dev_threshold: float = 1e-3
    # capture a jax.profiler trace (XLA op-level timeline, viewable
    # in TensorBoard/Perfetto) of the FIRST measurement block into this
    # directory — the op-level complement of the named timing report
    # (reference: timing.h instrumentation, SURVEY.md §6 "Tracing")
    profile_dir: Optional[str] = None

    @property
    def n_measurements(self) -> int:
        return self.sweeps // self.measure_interval


class ConsistencyLogger:
    """Run-output numerical self-checks (reference: DetModelLoggingParams'
    logSV singular-value files + wrapped-vs-stabilized Green deviation
    logging, SURVEY.md §5 item 1).

    Appends one row per device block to ``greendev.series`` (walker
    median + max of the wrapped-vs-freshly-stabilized G deviation) and
    ``sv.series`` (walker medians of the log10 extreme stack singular
    values), and exposes the latest values for the info.dat echo."""

    def __init__(self, outdir: Optional[str], meta: Optional[Metadata]):
        self.outdir = outdir
        self.meta = meta
        self._writers = None
        self.last: Dict[str, float] = {}

    def log(self, states) -> None:
        if self.outdir is None or not hasattr(states, "green_dev"):
            return
        dev = np.asarray(states.green_dev, np.float64).ravel()
        svlo = np.asarray(states.sv_min, np.float64).ravel()
        svhi = np.asarray(states.sv_max, np.float64).ravel()
        self.last = {
            "greenDevMedian": float(np.median(dev)),
            "greenDevMax": float(dev.max()),
            "svLog10Min": float(np.median(svlo)),
            "svLog10Max": float(np.median(svhi)),
        }
        if self._writers is None:
            from detqmc.io.series import SeriesWriter

            self._writers = (
                SeriesWriter(f"{self.outdir}/greendev.series",
                             "greendev: median max", meta=self.meta),
                SeriesWriter(f"{self.outdir}/sv.series",
                             "sv: log10_min log10_max", meta=self.meta),
            )
        self._writers[0].append(np.asarray(
            [[self.last["greenDevMedian"], self.last["greenDevMax"]]]))
        self._writers[1].append(np.asarray(
            [[self.last["svLog10Min"], self.last["svLog10Max"]]]))

    def info_entries(self) -> Dict[str, str]:
        return {k: repr(v) for k, v in self.last.items()}


class DetQMC:
    """Owns model + walker states + observable handler (reference: DetQMC
    owns model, RNG, handlers)."""

    def __init__(self, model, params: DriverConfig,
                 meta_extra: Optional[Metadata] = None):
        compile_cache.enable()
        self.model = model
        self.p = params
        self.meta = self._build_metadata(meta_extra or {})
        self.handler = ObservableHandler(
            outdir=params.outdir, jk_blocks=params.jk_blocks,
            timeseries=params.timeseries, meta=self.meta)
        self.handler.register_vectors(
            getattr(model, "vector_observables", ()))
        self.measurements_done = 0
        self.therm_done = 0
        self._t_start = time.time()
        self._stopped_early = False
        self._phi_stream = None
        self._consistency = ConsistencyLogger(params.outdir, self.meta)

        self._build_programs()

        self.states = None

    def _build_programs(self) -> None:
        """(Re)build the jitted device programs for the current model —
        called from __init__ and after an auto-stabilize s change."""
        model, params = self.model, self.p
        # vmapped device programs, compiled lazily on first use
        vm = jax.vmap
        self._init_fn = jax.jit(vm(model.init_state))
        self._refresh_fn = jax.jit(vm(model.refresh_from_field))

        do_global = getattr(model, "has_global_moves", False)

        # Global moves fire every `globalUpdateInterval` sweeps (reference
        # semantics, SURVEY.md §3 "SDW model"). The sweep counter lives on
        # the host, so each device block receives precomputed boolean
        # fire-flags; the predicate is unbatched, so under vmap the
        # lax.cond stays a real branch and idle steps cost nothing.
        def maybe_global(st, f):
            if not do_global:
                return st
            return jax.lax.cond(f, model.global_moves, lambda s: s, st)

        def therm_block(states, fire):
            def body(st, f):
                st, obs = model.sweep_pair(st, measure=False)
                return maybe_global(st, f), obs.acceptance
            states, acc = jax.lax.scan(body, states, fire)
            return states, acc.mean()

        def meas_block(states, fire):
            def one_measurement(st, f):
                def pair(st2, _):
                    st2, _o = model.sweep_pair(st2, measure=False)
                    return st2, None
                if params.measure_interval > 1:
                    st, _ = jax.lax.scan(pair, st, None,
                                         length=params.measure_interval - 1)
                st, obs = model.sweep_pair(st, measure=True)
                return maybe_global(st, f), obs
            states, obs = jax.lax.scan(one_measurement, states, fire)
            return states, obs

        self._therm_block = jax.jit(vm(therm_block, in_axes=(0, None)))
        self._meas_block = jax.jit(vm(meas_block, in_axes=(0, None)))
        self._timedisp_fn = None
        self._timedisp_chi = False
        if params.timedisplaced and hasattr(model,
                                            "measure_time_displaced"):
            import functools as _ft

            kw = {"per_slice": params.timedisplaced_slices}
            # per-slice G(tau,0) also yields the tau-integrated pairing
            # susceptibilities for free where the model supports them
            if params.timedisplaced_slices and hasattr(
                    model, "pair_susceptibilities"):
                kw["susceptibilities"] = True
                self._timedisp_chi = True
            self._timedisp_fn = jax.jit(vm(_ft.partial(
                model.measure_time_displaced, **kw)))
        self._current_fn = None
        if params.current_correlators:
            if not hasattr(model, "measure_current_correlators"):
                raise ValueError(
                    f"{type(model).__name__} has no current-correlator "
                    "measurement (currentCorrelators is Hubbard-only)")
            self._current_fn = jax.jit(vm(
                model.measure_current_correlators))

    # -- setup / resume -----------------------------------------------------
    def _build_metadata(self, extra: Metadata) -> Metadata:
        meta: Metadata = {}
        for k, v in dataclasses.asdict(self.model.cfg).items():
            meta[k] = str(v)
        for k, v in dataclasses.asdict(self.p).items():
            if k != "outdir":
                meta[k] = str(v)
        meta.update(extra)
        return meta

    @property
    def _ckpt_path(self) -> Optional[str]:
        if self.p.outdir is None:
            return None
        return f"{self.p.outdir}/state"

    def init(self, resume: bool = True) -> None:
        """Fresh start, or resume from a checkpoint in outdir (reference:
        resume-from-state with G recomputed on load, SURVEY.md §6)."""
        loaded = None
        if resume and self._ckpt_path:
            loaded = ckpt_mod.load_checkpoint(self._ckpt_path)
        if loaded is None:
            keys = jax.random.split(
                jax.random.key(self.p.seed), self.p.n_walkers)
            with timing("init"):
                self.states = self._init_fn(keys)
            self._shard_states()
            # recompute the initial sign host-side in NumPy f64 when the
            # model has a sign problem (mu != 0 etc.)
            if (getattr(self.model, "host_chain_sign", None) is not None
                    and getattr(self.model.cfg, "mu", 0.0) != 0.0):
                sgn = self.model.host_chain_sign(self.states)
                self.states = self.states._replace(
                    sign=jnp.asarray(sgn, self.states.sign.dtype))
            return
        arrays, handler_arrays, manifest = loaded
        blank = self._init_fn(jax.random.split(
            jax.random.key(self.p.seed), self.p.n_walkers))
        restored = ckpt_mod.restore_state(blank, arrays)
        self.states = self._refresh_fn(restored)
        if hasattr(restored, "sign"):
            # refresh_from_field recomputes the sign from the factored
            # chain; the checkpointed sign was tracked exactly through accepted-ratio
            # signs, so the saved value wins on resume
            self.states = self.states._replace(
                sign=jnp.asarray(restored.sign, self.states.sign.dtype))
        self._shard_states()
        self.handler.load_state_dict(handler_arrays)
        self.measurements_done = int(manifest.get("measurements_done", 0))
        self.therm_done = int(manifest.get("therm_done", 0))

    def _shard_states(self) -> None:
        """Distribute the walker axis over a device mesh (no-op for
        mesh_devices <= 1). Sharding propagates through the jitted blocks;
        measurements gather to host as before."""
        n_dev = self.p.mesh_devices
        if n_dev <= 1:
            return
        devs = jax.devices()[:n_dev]
        if len(devs) < n_dev:
            raise RuntimeError(
                f"mesh_devices={n_dev} but only {len(devs)} devices")
        if self.p.n_walkers % n_dev != 0:
            raise ValueError("n_walkers must divide evenly over "
                             f"mesh_devices ({self.p.n_walkers} % {n_dev})")
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

        mesh = Mesh(np.array(devs), ("walkers",))
        shard = NamedSharding(mesh, P("walkers"))
        self.states = jax.tree.map(
            lambda a: jax.device_put(a, shard), self.states)

    def _global_fire_flags(self, start_sweeps: int, n_units: int,
                           sweeps_per_unit: int) -> jax.Array:
        """fire[t] = True iff device-block unit t crosses a
        globalUpdateInterval boundary (reference: global moves attempted
        every globalUpdateInterval sweeps)."""
        gui = int(getattr(self.model.cfg, "globalUpdateInterval", 0) or 0)
        if not getattr(self.model, "has_global_moves", False) or gui <= 0:
            return jnp.zeros((n_units,), bool)
        s0 = start_sweeps + sweeps_per_unit * np.arange(n_units)
        s1 = s0 + sweeps_per_unit
        return jnp.asarray((s1 // gui) > (s0 // gui))

    # -- auto-stabilization ---------------------------------------------------
    def _maybe_auto_stabilize(self) -> None:
        """Step cfg.s down when the wrapped-G drift trips the threshold
        (thermalization only — see DriverConfig.auto_stabilize)."""
        if (not self.p.auto_stabilize
                or not hasattr(self.states, "green_dev")):
            return
        dev = float(np.median(np.asarray(self.states.green_dev)))
        s = int(getattr(self.model.cfg, "s", 1))
        if dev <= self.p.green_dev_threshold or s <= 1:
            return
        m = int(self.model.cfg.m)
        new_s = max((d for d in range(1, s) if m % d == 0
                     and d <= max(1, s // 2)), default=1)
        import logging

        logging.getLogger(__name__).warning(
            "auto_stabilize: green_dev median %.2e > %.1e; "
            "s %d -> %d (model programs rebuilt)",
            dev, self.p.green_dev_threshold, s, new_s)
        from detqmc.checkpoint import RECOMPUTED

        old = self.states
        self.model = type(self.model)(
            dataclasses.replace(self.model.cfg, s=new_s))
        self._build_programs()
        blank = self._init_fn(jax.random.split(
            jax.random.key(self.p.seed), self.p.n_walkers))
        keep = {n: getattr(old, n) for n in old._fields
                if n not in RECOMPUTED}
        self.states = self._refresh_fn(blank._replace(**keep))
        self._shard_states()
        self.meta["s"] = str(new_s)
        self.meta["autoStabilized"] = "true"

    # -- wall-time ------------------------------------------------------------
    def _out_of_time(self, margin: float = 0.0) -> bool:
        if self.p.walltime_secs <= 0:
            return False
        return (time.time() - self._t_start + margin) >= self.p.walltime_secs

    def save(self) -> None:
        if self._ckpt_path is None:
            return
        manifest: Dict[str, Any] = {
            "measurements_done": self.measurements_done,
            "therm_done": self.therm_done,
            "meta": self.meta,
        }
        with timing("saveState"):
            ckpt_mod.save_checkpoint(self._ckpt_path, self.states,
                                     self.handler.state_dict(), manifest)
        if self.p.outdir:
            info = dict(self.meta)
            info["measurementsDone"] = str(self.measurements_done)
            info["thermalizationDone"] = str(self.therm_done)
            info.update(self._consistency.info_entries())
            write_metadata(f"{self.p.outdir}/info.dat", info)

    # -- main loop ---------------------------------------------------------------
    def run(self) -> Dict[str, tuple]:
        """Thermalize, then measure; returns jackknifed results.

        Stops early (after a clean checkpoint) when the wall-time budget is
        about to run out — the reference's batch-queue pattern."""
        if self.states is None:
            self.init()
        # thermalization in blocks so walltime checks stay responsive
        block = max(1, self.p.block_meas * self.p.measure_interval)
        t_block = None
        while self.therm_done < self.p.thermalization:
            n = min(block, self.p.thermalization - self.therm_done)
            fire = self._global_fire_flags(2 * self.therm_done, n, 2)
            with timing("thermalization"):
                self.states, acc = self._therm_block(self.states, fire)
                jax.block_until_ready(self.states.G)
            self.therm_done += n
            # adaptive proposal-width tuning (reference:
            # updateInSliceThermalization targeting accRatio): multiply
            # widths toward the target between device blocks, keeping the
            # compiled program static
            if (self.p.tune_proposals
                    and hasattr(self.states, "box_width")):
                rate = np.asarray(acc)
                factor = np.clip(rate / self.p.target_acc_ratio, 0.5, 2.0)
                new_w = np.asarray(self.states.box_width) * factor
                self.states = self.states._replace(
                    box_width=jnp.asarray(new_w,
                                          self.states.box_width.dtype))
            self._maybe_auto_stabilize()
            if self._out_of_time(margin=(t_block or 0.0)):
                self.save()
                self._stopped_early = True
                return self.handler.results()

        while self.measurements_done < self.p.n_measurements:
            t0 = time.time()
            # the last block is sized to the remaining measurements (no
            # compute-and-discard tail overshoot); a non-multiple sweep
            # count costs one extra trace/compile for the short block
            n_new = min(self.p.block_meas,
                        self.p.n_measurements - self.measurements_done)
            fire = self._global_fire_flags(
                2 * self.p.measure_interval * self.measurements_done,
                n_new, 2 * self.p.measure_interval)
            profile_this = (self.p.profile_dir
                            and self.measurements_done == 0)
            with timing("measurement block"):
                if profile_this:
                    with jax.profiler.trace(self.p.profile_dir):
                        self.states, obs = self._meas_block(
                            self.states, fire)
                        jax.block_until_ready(self.states.G)
                else:
                    self.states, obs = self._meas_block(self.states, fire)
                    jax.block_until_ready(self.states.G)
            t_block = time.time() - t0
            # device layout: (W, T, ...) -> handler wants (T, W, ...)
            batch = {k: np.swapaxes(np.asarray(v), 0, 1)
                     for k, v in obs._asdict().items()}
            if self._timedisp_fn is not None:
                out = self._timedisp_fn(self.states)
                if self._timedisp_chi:
                    gk, td_dev, ps, pd = out
                    batch["pairingSusceptibilityS"] = np.asarray(ps)[None]
                    batch["pairingSusceptibilityD"] = np.asarray(pd)[None]
                if self.p.timedisplaced_slices:
                    if not self._timedisp_chi:
                        gk, td_dev = out              # (W, m+1, N), (W,)
                    batch["timeDisplacedDev"] = np.asarray(
                        td_dev)[None]                 # (1, W) scalar obs
                else:
                    gk = out                          # (W, K+1, N)
                gk = np.asarray(gk)
                batch["greenKTauVector"] = gk.reshape(
                    1, gk.shape[0], -1)  # one sample per block
            if self._current_fn is not None:
                lam_q, rho_s, cdev = self._current_fn(self.states)
                batch["currentCorrelatorVector"] = np.asarray(
                    lam_q)[None]                          # (1, W, N)
                batch["rhoS"] = np.asarray(rho_s)[None]   # (1, W)
                batch["currentWrapDev"] = np.asarray(cdev)[None]
            self.handler.insert_batch(batch)
            if self.p.dump_config_stream and self.p.outdir and \
                    hasattr(self.states, "phi"):
                from detqmc.io.binarystream import BinaryStreamWriter
                phi = np.asarray(self.states.phi)
                if self._phi_stream is None:
                    self._phi_stream = BinaryStreamWriter(
                        f"{self.p.outdir}/phi.binarystream", phi.shape[1:])
                self._phi_stream.append(phi)
            self._consistency.log(self.states)
            self.measurements_done += n_new
            if (self.p.save_interval and self.measurements_done %
                    self.p.save_interval < self.p.block_meas):
                self.save()
            if self._out_of_time(margin=t_block):
                self.save()
                self._stopped_early = True
                break

        self.save()
        if self.p.outdir:
            self.handler.write_output()
        return self.handler.results()

    @property
    def stopped_early(self) -> bool:
        return self._stopped_early
