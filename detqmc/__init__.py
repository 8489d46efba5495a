"""detqmc — determinantal quantum Monte Carlo in JAX.

A brand-new JAX/XLA/Pallas framework with the capabilities of the reference
C++ code ``crstnbr/detqmc`` (BSS determinantal QMC for the Hubbard model and
the O(1/2/3) spin-density-wave metal), re-designed for accelerators:

- dense linear algebra (B-chain propagation, QR/UdV stabilization, Green's
  function updates) runs as batched matmuls over vmapped walkers;
- the sequential imaginary-time sweep is ``lax.scan``; per-site Metropolis
  updates use delayed (block rank-k) Green updates so the hot flush is a
  matmul;
- replica-exchange parallel tempering runs over a ``jax.sharding.Mesh`` axis
  with XLA collectives instead of MPI.

Reference behavior map: see SURVEY.md at the repo root (the reference mount
was empty; component parity targets SURVEY.md §2/§3).
"""

__version__ = "0.1.0"
