"""Utility-layer tests (reference: test/misc.jl + types accessors)."""

import numpy as np
import pytest

from flashweave.preprocessing import convert_to_target_prec
from flashweave.types import FWResult, Graph, HitonState, LGLResult
from flashweave.utils.misc import (
    make_symmetric_graph,
    make_weights,
    maxweight,
    mode_string,
)


def test_precision_conversion():
    # reference: test/misc.jl:4-26
    A64 = np.vstack([np.ones((100, 10)), np.zeros((100, 10))])
    A32 = A64.astype(np.float32)
    for test_name in ["mi", "mi_nz", "fz", "fz_nz"]:
        for prec in [32, 64]:
            for A in (A32, A64):
                out = convert_to_target_prec(A, prec, test_name=test_name)
                assert str(out.dtype).endswith(str(prec)), (test_name, prec, out.dtype)
                is_float = np.issubdtype(out.dtype, np.floating)
                assert is_float == (test_name.startswith("fz"))


def test_mode_string():
    assert mode_string(False, True, 3) == "FlashWeave - sensitive (conditional)"
    assert mode_string(True, False, 0) == "FlashWeaveHE - fast (univariate)"


def test_maxweight():
    assert maxweight(np.nan, 2.0) == 2.0
    assert maxweight(3.0, np.nan) == 3.0
    assert maxweight(-2.0, -3.0) == -3.0
    with pytest.warns(UserWarning):
        assert maxweight(2.0, -3.0) == 2.0  # sign conflict -> first


def test_make_weights_discrete_sign():
    # discrete weights re-signed by the univariate sign (reference misc.jl:147-152)
    PC = {1: (0.5, 0.001)}
    uni = {1: (-0.2, 0.0001)}
    w = make_weights(PC, uni, "cond_stat", "mi")
    assert w[1] == -0.5
    w = make_weights(PC, uni, "uni_stat", "mi")
    assert w[1] == -0.2


def test_symmetric_graph_nan_drop():
    weights = {0: {1: np.nan}, 1: {0: np.nan}, 2: {0: 1.5}}
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        g = make_symmetric_graph(weights, "OR", max_var=3)
    assert not g.has_edge(0, 1)
    assert g.has_edge(0, 2) and g.weight(0, 2) == 1.5


def test_fwresult_show_and_accessors():
    g = Graph(4)
    g.add_edge(0, 1, 0.5)
    state = HitonState("I", {2: (0.1, 0.001)}, {}, [3], {})
    res = FWResult(
        LGLResult(g, {}, {0: state}),
        parameters=dict(heterogeneous=False, sensitive=True, max_k=3),
    )
    s = repr(res)
    assert "FlashWeave - sensitive (conditional)" in s
    assert "1 interactions between 4 variables" in s
    assert res.converged()
    n_unf, mean_unchecked, mean_frac = res.unchecked_statistics()
    assert n_unf == 1 and mean_unchecked == 1 and mean_frac == 0.5
    assert res.names() == ["X1", "X2", "X3", "X4"]


def test_graph_adjacency_exports():
    g = Graph(3)
    g.add_edge(0, 2, -1.5)
    g.add_edge(1, 2, 0.5)
    W = g.adjacency_matrix()
    assert W[0, 2] == W[2, 0] == -1.5
    assert W[1, 2] == 0.5 and W[0, 1] == 0
    S = g.sparse_adjacency()
    np.testing.assert_array_equal(S.toarray(), W)


def test_stage_timing_and_profiler_trace(tmp_path):
    """Per-stage timings are recorded in the result parameters and an
    optional jax.profiler trace is captured (SURVEY §5 aux subsystems)."""
    from flashweave import learn_network

    rng = np.random.default_rng(3)
    data = rng.integers(0, 50, (80, 12)).astype(np.float64)
    data[rng.random((80, 12)) < 0.4] = 0
    data[:, 1] = data[:, 0]
    trace_dir = tmp_path / "jax_trace"
    res = learn_network(
        data, sensitive=False, heterogeneous=False, max_k=1, verbose=False,
        parallel_mode="single", profile_dir=str(trace_dir),
    )
    st = res.parameters["stage_times"]
    assert {"normalize", "univariate", "conditional", "postprocess"} <= set(st)
    assert all(v >= 0 for v in st.values())
    assert trace_dir.exists() and any(trace_dir.rglob("*"))
