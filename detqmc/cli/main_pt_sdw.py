"""detqmc-pt-sdw — SDW parallel-tempering binary (compatibility entry).

Delegates to the generic detqmc-pt main (cli/main_pt.py) with
model=sdw as the default; all historical config keys keep working
(reference parity: maindetqmcptsdwopdim.cpp, SURVEY.md §3 "CLI mains").
"""

from __future__ import annotations

from detqmc.cli.main_pt import main as _main


def main(argv=None) -> int:
    return _main(argv, default_model="sdw")


if __name__ == "__main__":
    raise SystemExit(main())
