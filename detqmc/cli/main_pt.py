"""detqmc-pt — parallel-tempering binary, model- and parameter-generic.

Reference parity: SURVEY.md §3 "CLI mains" (maindetqmcptsdwopdim.cpp;
mpirun -n R is replaced by the `values` grid over one device/mesh
program). Generalizations beyond the reference binary:

  model = sdw | hubbard      which model samples (VERDICT r4 item 7:
                             the Hubbard stagger_h grid is first-class)
  controlParameter =         which parameter the grid tempers:
      r          (sdw, default)     label-swap, det-free exchange
      stagger_h  (hubbard, default) label-swap, det-free exchange
      beta       (either model)     DET-COUPLED config-swap PT
                 (parallel/det_pt.py): one model instance per grid
                 value at fixed m (dtau = beta_k / m varies), swap
                 weights carry the fermionic log-det difference

Config keys: everything the single-run main takes, plus
    values = v0,v1,...      control-parameter grid (one replica each)
    exchangeInterval = n    sweep pairs between exchange attempts
    ptEnsembles = E         independent chains per grid value
"""

from __future__ import annotations

import dataclasses
import sys

from detqmc import compile_cache
from detqmc.config import (
    ConfigurationError,
    _HUBBARD_KEYS,
    _PT_KEYS,
    _SDW_KEYS,
    build_driver_config,
    build_hubbard_config,
    build_sdw_config,
    parse_args,
    pt_params,
    split_params,
)

_DEFAULT_CONTROL = {"sdw": "r", "hubbard": "stagger_h"}


def main(argv=None, default_model: str = "sdw") -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        params = parse_args(argv)
        model_name = params.get("model", default_model)
        if model_name not in ("sdw", "hubbard"):
            raise ConfigurationError(
                f"model must be sdw|hubbard, got {model_name!r}")
        keys = _SDW_KEYS if model_name == "sdw" else _HUBBARD_KEYS
        build = (build_sdw_config if model_name == "sdw"
                 else build_hubbard_config)
        model_p, driver_p, extra = split_params(params, keys,
                                                extra_keys=_PT_KEYS)
        cfg = build(model_p)
        drv = build_driver_config(driver_p)
        ptp = pt_params(extra)
        values = ptp.get("values")
        if not values:
            raise ConfigurationError(
                "parallel tempering needs `values = v0,v1,...`")
        control = ptp.get("controlParameter",
                          _DEFAULT_CONTROL[model_name])
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2

    compile_cache.enable()
    if model_name == "sdw":
        from detqmc.models.sdw import SDWModel as Model
    else:
        from detqmc.models.hubbard import HubbardModel as Model

    try:
        if control == "beta":
            from detqmc.parallel.det_pt import (DetPTConfig,
                                                    DetQMCPTDet)

            models = [Model(dataclasses.replace(cfg, beta=float(v)))
                      for v in values]
            qmc = DetQMCPTDet(
                models, values, drv,
                DetPTConfig(
                    exchange_interval=ptp.get("exchangeInterval", 1),
                    control_parameter="beta",
                    n_ensembles=ptp.get("ptEnsembles", 1)),
                meta_extra={"model": f"{model_name}-pt"})
        else:
            from detqmc.parallel.pt_driver import DetQMCPT, PTConfig

            qmc = DetQMCPT(
                Model(cfg), values, drv,
                PTConfig(
                    exchange_interval=ptp.get("exchangeInterval", 1),
                    control_parameter=control,
                    n_ensembles=ptp.get("ptEnsembles", 1)),
                meta_extra={"model": f"{model_name}-pt"})
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2
    results = qmc.run()
    for k, res in results.items():
        print(f"# parameter {k} ({control} = {values[k]})")
        for name, (mean, err) in sorted(res.items()):
            print(f"{name} = {mean!r} +/- {err!r}")
    from detqmc.timing import timing

    print(timing.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
