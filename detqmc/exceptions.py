"""Typed errors (reference parity: SURVEY.md §3 "Exceptions" —
GeneralError / ConfigurationError)."""

from __future__ import annotations


class GeneralError(RuntimeError):
    """Unrecoverable runtime failure in a simulation component."""


class ConfigurationError(ValueError):
    """Bad or inconsistent parameters (also raised by detqmc.config)."""


class NumericalError(GeneralError):
    """Numerical sanity violation (NaN/Inf state, stabilization failure).

    The analogue of the reference's consistency instrumentation
    escalating to a hard stop (SURVEY.md §6 "Race detection / sanitizers":
    the framework's sanitizers are numerical, not thread-based)."""
