"""sdwcorr — offline phi-field correlations from dumped configurations.

Reference parity: SURVEY.md §3 "sdwcorr" (mainsdwcorr.cpp): real- and
k-space correlation functions / structure factors of the O(N) field from
.binarystream dumps.

Usage: python -m detqmc.analysis.sdwcorr <phi.binarystream> [--L L]
Record shape must be (m, N, opdim) (written by the SDW driver's
``dump_config`` option).
"""

from __future__ import annotations

import sys

import numpy as np

from detqmc.io.binarystream import read_binarystream


def phi_correlations(phi: np.ndarray, L: int):
    """phi: (n_meas, m, N, opdim). Returns dict with:
    - corr_r: (L, L) translation-averaged equal-time <phi_0 . phi_r>
    - struct_k: (L, L) static structure factor S(q) (FFT of corr_r)
    - chi_q0: susceptibility-like sum over tau at q=0
    """
    n_meas, m, N, opdim = phi.shape
    assert N == L * L, (N, L)
    conf = phi.reshape(n_meas * m, L, L, opdim)
    # translation-averaged equal-time correlation via FFT
    f = np.fft.fft2(conf, axes=(1, 2))
    power = (f * f.conj()).real.sum(axis=-1)        # (n, L, L)
    struct_k = power.mean(axis=0) / (L * L)
    corr_r = np.fft.ifft2(struct_k).real
    # q=0 susceptibility: beta factor is applied by the caller if desired
    phibar = phi.mean(axis=(1, 2))                  # (n_meas, opdim)
    chi_q0 = (phibar ** 2).sum(axis=-1).mean() * N
    return {"corr_r": corr_r, "struct_k": struct_k, "chi_q0": chi_q0}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: sdwcorr <phi.binarystream> [--L L]", file=sys.stderr)
        return 2
    path = argv[0]
    phi = read_binarystream(path)
    if phi.ndim != 4:
        print(f"unexpected record shape {phi.shape[1:]}", file=sys.stderr)
        return 2
    L = int(round(np.sqrt(phi.shape[2])))
    if "--L" in argv:
        L = int(argv[argv.index("--L") + 1])
    out = phi_correlations(phi, L)
    np.savez(path + ".corr.npz", **out)
    print(f"chi(q=0) = {out['chi_q0']!r}")
    print(f"S(pi,pi) = {out['struct_k'][L // 2, L // 2]!r}")
    print(f"wrote {path}.corr.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
