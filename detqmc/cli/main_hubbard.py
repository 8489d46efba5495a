"""detqmc-hubbard — Hubbard-model DQMC simulation binary.

Reference parity: SURVEY.md §3 "CLI mains" (maindetqmchubbard.cpp).
Usage:
    detqmc-hubbard --conf sim.conf [--key value ...]
    python -m detqmc.cli.main_hubbard L=4 beta=4 U=4 sweeps=200 ...
"""

from __future__ import annotations

import sys

from detqmc import compile_cache
from detqmc.config import (
    ConfigurationError,
    _HUBBARD_KEYS,
    build_driver_config,
    build_hubbard_config,
    parse_args,
    split_params,
)
from detqmc.driver import DetQMC
from detqmc.timing import timing


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        params = parse_args(argv)
        model_p, driver_p, _ = split_params(params, _HUBBARD_KEYS)
        cfg = build_hubbard_config(model_p)
        drv = build_driver_config(driver_p)
    except ConfigurationError as e:
        print(f"configuration error: {e}", file=sys.stderr)
        return 2

    compile_cache.enable()
    from detqmc.models.hubbard import HubbardModel

    model = HubbardModel(cfg)
    qmc = DetQMC(model, drv, meta_extra={"model": "hubbard"})
    results = qmc.run()
    for name, (mean, err) in sorted(results.items()):
        print(f"{name} = {mean!r} +/- {err!r}")
    print(timing.report(), file=sys.stderr)
    if qmc.stopped_early:
        print("walltime exhausted: state saved, resume with the same "
              "command", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
