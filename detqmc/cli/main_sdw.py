"""detqmc-sdw — O(N) SDW-model DQMC simulation binary.

Reference parity: SURVEY.md §3 "CLI mains" (maindetqmcsdwopdim.cpp); the
reference's runtime->compile-time template dispatch over (opdim,
checkerboard) becomes config-driven jit specialization here.
"""

from __future__ import annotations

import sys

from detqmc import compile_cache
from detqmc.config import (
    ConfigurationError,
    _SDW_KEYS,
    build_driver_config,
    build_sdw_config,
    parse_args,
    split_params,
)
from detqmc.driver import DetQMC
from detqmc.timing import timing


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        params = parse_args(argv)
        model_p, driver_p, _ = split_params(params, _SDW_KEYS)
        cfg = build_sdw_config(model_p)
        drv = build_driver_config(driver_p)
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2

    compile_cache.enable()
    from detqmc.models.sdw import SDWModel

    model = SDWModel(cfg)
    qmc = DetQMC(model, drv, meta_extra={"model": "sdw"})
    results = qmc.run()
    for name, (mean, err) in sorted(results.items()):
        print(f"{name} = {mean!r} +/- {err!r}")
    print(timing.report(), file=sys.stderr)
    return 3 if qmc.stopped_early else 0


if __name__ == "__main__":
    raise SystemExit(main())
