import numpy as np

from detqmc.io.series import (
    SeriesWriter,
    load_results,
    load_series,
    write_results,
)
from detqmc.metadata import read_metadata, write_metadata
from detqmc.observables import ObservableHandler


def test_series_roundtrip(tmp_path):
    p = str(tmp_path / "energy.series")
    w = SeriesWriter(p, "energy", meta={"L": "4", "beta": "4.0"})
    w.append(np.array([1.0, 2.0]))
    w.append(3.5)
    arr, meta = load_series(p)
    np.testing.assert_allclose(arr, [1.0, 2.0, 3.5])
    assert meta["L"] == "4"


def test_vector_series_roundtrip(tmp_path):
    p = str(tmp_path / "corr.series")
    w = SeriesWriter(p, "corr")
    w.append(np.arange(6.0).reshape(2, 3))
    arr, _ = load_series(p)
    assert arr.shape == (2, 3)
    np.testing.assert_allclose(arr, np.arange(6.0).reshape(2, 3))


def test_results_roundtrip(tmp_path):
    p = str(tmp_path / "results.values")
    write_results(p, {"occ": (1.0, 0.01), "energy": (-1.5, 0.02)})
    r = load_results(p)
    assert r["occ"] == (1.0, 0.01)
    assert r["energy"] == (-1.5, 0.02)


def test_metadata_roundtrip(tmp_path):
    p = str(tmp_path / "info.dat")
    write_metadata(p, {"model": "hubbard", "L": "4"})
    meta = read_metadata(p)
    assert meta == {"model": "hubbard", "L": "4"}


def test_handler_scalar_and_vector(tmp_path):
    h = ObservableHandler(outdir=str(tmp_path), jk_blocks=4,
                          timeseries=True)
    rng = np.random.default_rng(0)
    for _ in range(5):
        h.insert_batch({
            "occupancy": rng.normal(1.0, 0.1, size=(10, 3)),   # (T, W)
            "spinCorrelation": rng.normal(0.0, 1.0, size=(10, 3, 4)),
        })
    res = h.results()
    assert abs(res["occupancy"][0] - 1.0) < 0.1
    vres = h.vector_results()
    assert vres["spinCorrelation"][0].shape == (4,)
    h.write_output()
    assert (tmp_path / "results.values").exists()
    assert (tmp_path / "occupancy.series").exists()
    arr, _ = load_series(str(tmp_path / "occupancy.series"))
    assert arr.shape == (50,)
    # state dict roundtrip
    h2 = ObservableHandler(jk_blocks=4)
    h2.load_state_dict(h.state_dict())
    assert h2.results()["occupancy"] == res["occupancy"]
