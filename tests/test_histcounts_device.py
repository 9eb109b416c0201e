"""The plain O(N) device histcounts (accel/dense.py _b_histcounts): bin by
searchsorted, last edge closed as in MATLAB, NaN and out-of-range values
dropped, counts by one scatter-add — pinned against np.histogram."""

import numpy as np
import pytest

from runmat_tpu.accel import active_engine, init_engine


def _reference(x, edges):
    x = np.asarray(x, np.float64)
    return np.histogram(x[~np.isnan(x)], bins=np.asarray(edges, np.float64))[0]


_CASES = {
    "last_edge_closed": ([0.1, 0.5, 0.5, 0.9, 1.0], [0.0, 0.5, 1.0]),
    "nan_dropped": ([np.nan, 0.2, np.nan, 0.7], [0.0, 0.5, 1.0]),
    "out_of_range": ([-3.0, -1e-9, 0.0, 1.0, 1.0 + 1e-6, 7.0],
                     [0.0, 0.25, 1.0]),
    "non_uniform_edges": ([0.05, 0.1, 0.3, 1.5, 2.0, 9.9, 10.0, 11.0],
                          [0.0, 0.1, 0.5, 2.0, 10.0]),
    "single_bin": ([0.0, 0.5, 1.0, 2.0], [0.0, 1.0]),
    "empty": ([], [0.0, 1.0, 2.0]),
    "many_points": (np.random.default_rng(3).standard_normal(100_000),
                    np.linspace(-3.0, 3.0, 65)),
}


@pytest.fixture(scope="module")
def hist():
    import jax
    from runmat_tpu.accel.dense import _b_histcounts
    eng = active_engine() or init_engine(platform="cpu")
    return jax.jit(_b_histcounts(eng, ()))


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["single", "double"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_histcounts_matches_np_histogram(hist, case, dtype):
    x, edges = _CASES[case]
    x = np.asarray(x, dtype)
    edges = np.asarray(edges, dtype)
    got = np.asarray(hist(x, edges))
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, _reference(x, edges))


def test_histcounts_matlab_surface_on_device():
    """histcounts of a gpuArray goes through the device builder and returns
    a 1xB row, MATLAB's last bin closed."""
    from runmat_tpu.session import Session
    eng = active_engine() or init_engine(platform="cpu")
    s = Session(accelerate=True)
    n0 = eng.stats["dispatches"]
    s.run_source("x = gpuArray(single([0.1 0.5 0.5 0.9 1.0 NaN -2])); "
                 "h = histcounts(x, [0 0.5 1.0]); on = isgpuarray(h);", "h")
    assert eng.stats["dispatches"] > n0
    assert bool(s.get("on").host().ravel()[0])
    h = s.get("h").host()
    assert h.shape == (1, 2)
    np.testing.assert_array_equal(h.ravel(), [1, 4])
