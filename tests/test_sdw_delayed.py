"""The SDW XLA delayed update (rank-q Woodbury updates buffered K sites at
a time, flushed as one GEMM) walks the same Markov chain as the
sequential lax.scan, for every order-parameter dimension and fermion
representation."""

import jax
import numpy as np
import pytest

from detqmc.models.sdw import SDWConfig, SDWModel


@pytest.mark.parametrize("delay", [2, 4, 8])
@pytest.mark.parametrize("repr_", ["complex", "real_embed"])
@pytest.mark.parametrize("opdim", [1, 2, 3])
def test_xla_delayed_matches_scan(opdim, repr_, delay):
    base = dict(L=2, opdim=opdim, r=0.5, beta=1.0, m=4, s=2,
                dtype="float64", fermion_repr=repr_, update_kernel="scan")
    scan = SDWModel(SDWConfig(**base))
    dl = SDWModel(SDWConfig(**base, delay=delay))
    s1 = scan.init_state(jax.random.key(21))
    s2 = dl.init_state(jax.random.key(21))
    s1, o1 = scan.sweep_pair(s1, measure=True)
    s2, o2 = dl.sweep_pair(s2, measure=True)
    np.testing.assert_allclose(np.asarray(s1.phi), np.asarray(s2.phi),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(s1.G), np.asarray(s2.G),
                               atol=1e-9)
    np.testing.assert_allclose(float(o1.acceptance), float(o2.acceptance),
                               atol=1e-12)
    np.testing.assert_allclose(complex(s1.phase), complex(s2.phase),
                               atol=1e-9)


@pytest.mark.parametrize("kw, delay", [
    (dict(L=8, opdim=3), 8),                        # dim 256: auto delays
    (dict(L=4, opdim=3), 0),                        # dim 64: scan
    (dict(L=8, opdim=3, update_kernel="scan"), 0),  # forced scan
    (dict(L=8, opdim=3, delay=4), 4),               # explicit delay wins
    (dict(L=4, opdim=3, delay=4), 4),
])
def test_auto_route_by_dimension(kw, delay):
    model = SDWModel(SDWConfig(beta=1.0, m=4, s=2, **kw))
    assert model._delay == delay
