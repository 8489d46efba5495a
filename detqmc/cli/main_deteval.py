"""deteval console entry (see detqmc.analysis.deteval)."""

from detqmc.analysis.deteval import main

if __name__ == "__main__":
    raise SystemExit(main())
