"""I/O parity tests (reference: test/io.jl)."""

import numpy as np
import pytest

from flashweave import io as fio
from flashweave.types import FWResult, HitonState, LGLResult, TestResult

from conftest import reference_data_path, requires_reference_data


@pytest.fixture(scope="module")
def net_result():
    return fio.load_network(
        reference_data_path("learning_expected", "exp_mi_maxk3.edgelist")
    )


@requires_reference_data
def test_npz_network_full_fidelity(tmp_path, net_result):
    """The binary format must round-trip everything text formats lose:
    parameters, rejections, and checkpointed search states (the reference's
    JLD2 role, src/io.jl:97)."""
    rej_dict = {
        0: {
            1: ((2,), TestResult(0.0, 1.0, 1, False), (10, 0.2)),
            2: ((3, 4, 5), TestResult(0.1, 0.2, 3, True), (1000, 1.0)),
        }
    }
    unf_dict = {
        0: HitonState("I", {4: (0.5, 1e-4)}, {5: (0.1, 0.9)}, [6, 7, 8], {}),
        1: HitonState("C", {}, {}, [10], rej_dict[0]),
    }
    params = {"test_name": "mi", "alpha": 0.01, "max_k": 3, "FDR": True}
    det = FWResult(
        LGLResult(net_result.graph, rej_dict, unf_dict),
        variable_ids=net_result.variable_ids,
        meta_variable_mask=net_result.meta_variable_mask,
        parameters=params,
    )
    path = str(tmp_path / "net.npz")
    fio.save_network(path, det)
    ld = fio.load_network(path)
    assert ld.graph == det.graph
    assert ld.variable_ids == det.variable_ids
    assert np.array_equal(ld.meta_variable_mask, det.meta_variable_mask)
    assert ld.parameters == params
    assert ld.rejections == rej_dict
    assert ld.unfinished_states == unf_dict


@requires_reference_data
def test_npz_data_roundtrip(tmp_path, tiny_expected):
    data, header, meta_data, meta_header = tiny_expected
    path = str(tmp_path / "table.npz")
    fio.save_npz_data(path, data, header, meta_data, meta_header)
    d2, h2, m2, mh2 = fio.load_data(path)
    assert np.array_equal(d2, data)
    assert h2 == list(header)
    assert np.array_equal(np.asarray(m2, dtype=np.float64), meta_data)
    assert mh2 == list(meta_header)
    # transposed loading mirrors the dlm path (reference src/io.jl:142-148)
    fio.save_npz_data(str(tmp_path / "t.npz"), data.T, header)
    d3, _, _, _ = fio.load_data(str(tmp_path / "t.npz"), transposed=True)
    assert np.array_equal(d3, data)
    # external meta files are rejected, like the reference's jld2 branch
    with pytest.raises(ValueError):
        fio.load_data(path, "meta.tsv")


@requires_reference_data
@pytest.mark.parametrize("fmt", ["edgelist", "gml"])
def test_network_roundtrip(tmp_path, net_result, fmt):
    path = str(tmp_path / f"net.{fmt}")
    fio.save_network(path, net_result)
    loaded = fio.load_network(path)
    assert loaded.graph == net_result.graph
    assert loaded.variable_ids == net_result.variable_ids
    assert np.array_equal(loaded.meta_variable_mask, net_result.meta_variable_mask)


@requires_reference_data
def test_detailed_outputs(tmp_path, net_result):
    # reference: test/io.jl:44-69 (0-based internal ids here)
    rej_dict = {
        0: {
            1: ((2,), TestResult(0.0, 1.0, 1, False), (10, 0.2)),
            2: ((3, 4, 5), TestResult(0.1, 0.2, 3, True), (1000, 1.0)),
        }
    }
    unf_dict = {
        0: HitonState("I", {}, {}, [6, 7, 8], {}),
        1: HitonState("E", {}, {}, [10], {}),
    }
    det = FWResult(
        LGLResult(net_result.graph, rej_dict, unf_dict),
        variable_ids=net_result.variable_ids,
        meta_variable_mask=net_result.meta_variable_mask,
    )
    path = str(tmp_path / "net.edgelist")
    fio.save_network(path, det, detailed=True)

    rej_ld = fio.load_rejections(str(tmp_path / "net_rejections.tsv"))
    for A, d in rej_ld.items():
        for B, (Zs, tres, pair) in d.items():
            eZs, etres, epair = rej_dict[A][B]
            assert Zs == eZs
            assert np.isclose(tres.stat, etres.stat)
            assert np.isclose(tres.pval, etres.pval)
            assert tres.df == etres.df and tres.suff_power == etres.suff_power
            assert pair == epair

    unf_ld = fio.load_unfinished_variable_info(str(tmp_path / "net_unchecked.tsv"))
    for A, rec in unf_ld.items():
        assert rec["phase"] == unf_dict[A].phase
        assert rec["unchecked_vars"] == unf_dict[A].unchecked_vars


@pytest.fixture(scope="module")
def tiny_expected():
    raw = [
        l.rstrip("\n").split("\t")
        for l in open(reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_small.tsv"))
    ]
    header = raw[0][1:20]
    data = np.array([r[1:20] for r in raw[1:20]], dtype=np.float64)
    meta_raw = [
        l.rstrip("\n").split("\t")
        for l in open(reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_meta.tsv"))
    ]
    meta_header = meta_raw[0]
    meta_data = np.array(meta_raw[1:], dtype=np.float64)
    return data, header, meta_data, meta_header


@requires_reference_data
@pytest.mark.parametrize("data_suff,meta_suff", [
    (".tsv", "_meta.tsv"),
    ("_ids.tsv", "_meta.csv"),
    (".csv", "_meta.csv"),
    ("_json.biom", "_meta.tsv"),
    ("_hdf5.biom", "_meta.tsv"),
])
def test_table_data(tiny_expected, data_suff, meta_suff):
    # reference: test/io.jl:86-106
    data, header, meta_data, meta_header = tiny_expected
    data_path = reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny" + data_suff)
    meta_path = reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny" + meta_suff)
    d, h, md, mh = fio.load_data(data_path, meta_path)
    np.testing.assert_array_equal(np.asarray(d, dtype=np.float64), data)
    assert h == header
    np.testing.assert_array_equal(np.asarray(md, dtype=np.float64), meta_data)
    assert mh == meta_header


@requires_reference_data
def test_transposed(tiny_expected):
    # reference: test/io.jl:109-129
    data, header, meta_data, meta_header = tiny_expected
    d, h, md, mh = fio.load_data(
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_ids_transposed.tsv"),
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_meta_transposed.tsv"),
        transposed=True,
    )
    np.testing.assert_array_equal(np.asarray(d, dtype=np.float64), data)
    assert h == header
    np.testing.assert_array_equal(np.asarray(md, dtype=np.float64), meta_data)
    assert mh == meta_header


@requires_reference_data
def test_string_factors(tiny_expected):
    # reference: test/io.jl:132-141
    data, header, _, _ = tiny_expected
    d, h, md, mh = fio.load_data(
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_ids.tsv"),
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_meta_oneHotTest.tsv"),
    )
    np.testing.assert_array_equal(np.asarray(d, dtype=np.float64), data)
    assert h == header
    assert md.shape[1] == 6
    assert any(isinstance(x, str) for x in md[0])


@requires_reference_data
def test_numeric_ids(tiny_expected):
    # reference: test/io.jl:143-148
    data, header, _, _ = tiny_expected
    d, h, _, _ = fio.load_data(
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_numIDs.tsv")
    )
    np.testing.assert_array_equal(np.asarray(d, dtype=np.float64), data)
    assert h == [x[2:] for x in header]


@requires_reference_data
def test_jld2_table_data(tiny_expected):
    """Read-only JLD2 interop: the reference's own (skipped) test matrix
    pairs HMP_SRA_gut_tiny_plus_meta.jld2 with the tsv-loaded tuple
    (reference: test/io.jl:85-100; loader src/io.jl:119-148).  The file
    stores otu_data as a Julia SparseMatrixCSC compound and meta as a dense
    int matrix -- both layouts must decode to the exact tsv values."""
    data, header, meta_data, meta_header = tiny_expected
    with pytest.warns(UserWarning, match="deprecated"):
        d, h, md, mh = fio.load_data(
            reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_plus_meta.jld2")
        )
    np.testing.assert_array_equal(np.asarray(d, dtype=np.float64), data)
    assert h == header
    np.testing.assert_array_equal(np.asarray(md, dtype=np.float64), meta_data)
    assert mh == meta_header


@requires_reference_data
def test_jld2_transposed_and_sparse(tiny_expected):
    # reference: test/io.jl:107-124 (transposed variant, dense layout)
    from scipy import sparse as sp

    data, header, meta_data, meta_header = tiny_expected
    with pytest.warns(UserWarning, match="deprecated"):
        d, h, md, mh = fio.load_data(
            reference_data_path(
                "HMP_SRA_gut", "HMP_SRA_gut_tiny_plus_meta_transposed.jld2"),
            transposed=True,
        )
    np.testing.assert_array_equal(np.asarray(d, dtype=np.float64), data)
    assert h == header
    np.testing.assert_array_equal(np.asarray(md, dtype=np.float64), meta_data)
    assert mh == meta_header
    # make_sparse keeps the on-disk CSC structure as scipy.sparse
    with pytest.warns(UserWarning, match="deprecated"):
        ds, hs, _, _ = fio.load_data(
            reference_data_path(
                "HMP_SRA_gut", "HMP_SRA_gut_tiny_plus_meta.jld2"),
            make_sparse=True,
        )
    assert sp.issparse(ds)
    np.testing.assert_array_equal(np.asarray(ds.todense()), data)
    assert hs == header


@requires_reference_data
def test_jld2_missing_key_and_meta_path_errors(tmp_path):
    with pytest.raises(KeyError, match="otu_data_key"):
        fio.load_jld2_data(
            reference_data_path(
                "HMP_SRA_gut", "HMP_SRA_gut_tiny_plus_meta.jld2"),
            otu_data_key="no_such_key",
        )
    with pytest.raises(ValueError, match="not compatible with external"):
        fio.load_data(
            reference_data_path(
                "HMP_SRA_gut", "HMP_SRA_gut_tiny_plus_meta.jld2"),
            meta_data_path=str(tmp_path / "meta.tsv"),
        )


@requires_reference_data
@pytest.mark.parametrize("data_suff", ["_json.biom", "_hdf5.biom"])
def test_biom_sparse_loading(tiny_expected, data_suff):
    """make_sparse keeps .biom tables as scipy.sparse with identical values
    (the reference is sparse-first for biom, src/io.jl:208-225)."""
    from scipy import sparse as sp

    data, header, _, _ = tiny_expected
    path = reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny" + data_suff)
    d, h, _, _ = fio.load_data(path, make_sparse=True)
    assert sp.issparse(d)
    np.testing.assert_array_equal(np.asarray(d.todense()), data)
    assert h == header


# ---------------------------------------------------------------------------
# native fast delimited parser (flashweave/native/fast_dlm.cpp)
# ---------------------------------------------------------------------------

def _slow_load_dlm(path, **kw):
    """Force the pure-Python reference path for parity comparison."""
    import unittest.mock as mock

    with mock.patch.object(fio, "_load_dlm_fast", lambda *a, **k: None):
        return fio.load_dlm(path, **kw)


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


@pytest.mark.parametrize("name,text", [
    ("plain.tsv", "a\tb\tc\n1\t2\t3\n4.5\t-6\t7e-2\n0\t0\t12\n"),
    ("ids.tsv", "\tv1\tv2\nS1\t1\t2\nS2\t3\t4\n"),
    ("string_ids.tsv", "id\tv1\tv2\nsampA\t1\t2\nsampB\t3\t4\n"),
    ("num_header.tsv", "1\t2\t3\n5\t6\t7\n8\t9\t10\n"),
    ("blank_lines.tsv", "a\tb\n1\t2\n\n3\t4\n   \n5\t6\n"),
    ("csv.csv", "x,y,z\n1,2,3\n4,5,6\n"),
    ("sci.tsv", "a\tb\n1e10\t-2.5E-3\ninf\t+4\n"),
])
def test_fast_dlm_matches_python_path(tmp_path, name, text):
    """The native parser must agree exactly with the pure-Python path on
    header, row-id sniffing, and values."""
    path = _write(tmp_path, name, text)
    fast = fio.load_dlm(path)
    slow = _slow_load_dlm(path)
    np.testing.assert_array_equal(fast[0], slow[0])
    assert fast[1] == slow[1]


def test_fast_dlm_used_for_numeric_tables(tmp_path):
    """On a clean numeric table the fast path really is taken (guards
    against silently always falling back)."""
    from flashweave import native

    if native.get_lib() is None:
        pytest.skip("no native toolchain")
    path = _write(tmp_path, "t.tsv", "a\tb\n1\t2\n3\t4\n")
    out = fio._load_dlm_fast(path, "\t")
    assert out is not None
    np.testing.assert_array_equal(out[0], [[1.0, 2.0], [3.0, 4.0]])
    assert out[1] == ["a", "b"]


def test_fast_dlm_fallback_on_string_cell(tmp_path):
    """Tables with non-numeric body cells fall back (and then raise like
    the slow path does for type_data=True)."""
    path = _write(tmp_path, "bad.tsv", "a\tb\n1\toops\n2\t3\n")
    assert fio._load_dlm_fast(path, "\t") is None


def test_fast_dlm_fallback_on_ragged_rows(tmp_path):
    path = _write(tmp_path, "ragged.tsv", "a\tb\tc\n1\t2\t3\n4\t5\n")
    assert fio._load_dlm_fast(path, "\t") is None


def test_load_dlm_without_native_lib(tmp_path, monkeypatch):
    """If the native library cannot be built, loading still works."""
    from flashweave import native

    monkeypatch.setattr(native, "get_lib", lambda: None)
    path = _write(tmp_path, "t.tsv", "a\tb\n1\t2\n3\t4\n")
    data, header, _, _ = fio.load_dlm(path)
    np.testing.assert_array_equal(data, [[1.0, 2.0], [3.0, 4.0]])
    assert header == ["a", "b"]
