"""Preprocessing parity tests against the reference's golden normalized
matrices (reference: test/preprocessing.jl)."""

import warnings

import numpy as np
import pytest

from flashweave import preprocessing as pp
from flashweave.utils.misc import get_levels

from conftest import reference_data_path, requires_reference_data


def load_expected(name):
    return np.loadtxt(
        reference_data_path("preprocessing_expected", name), delimiter="\t"
    )


NORM_PAIRS = [
    # (norm_mode, test_name, golden file) -- reference test/preprocessing.jl:49-51
    ("clr-adapt", "fz", "clr_adapt.tsv"),
    ("clr-nonzero", "fz_nz", "clr_nonzero.tsv"),
    ("clr-nonzero-binned", "mi_nz", "clr_nonzero_binned.tsv"),
    ("pres-abs", "mi", "pres_abs.tsv"),
    ("tss", "", "tss.tsv"),
    ("tss-nonzero-binned", "", "tss_nonzero_binned.tsv"),
]


@requires_reference_data
@pytest.mark.parametrize("norm_mode,test_name,golden", NORM_PAIRS)
def test_norm_per_test_type(hmp_small, norm_mode, test_name, golden):
    exp = load_expected(golden)
    for desc, kwargs in [("norm_mode", dict(norm_mode=norm_mode)),
                         ("test_name", dict(test_name=test_name))]:
        if not list(kwargs.values())[0]:
            continue
        res = pp.normalize_data(hmp_small.copy(), verbose=False, prec=64, **kwargs)
        data_norm = res.data
        # legacy bin-filtering behaviour: goldens keep only 3-level columns
        # (reference: test/preprocessing.jl:66-71)
        if "binned" in norm_mode:
            lvl_mask = get_levels(data_norm.astype(np.int64)) == 3
            data_norm = data_norm[:, lvl_mask]
        assert data_norm.shape == exp.shape, (desc, data_norm.shape, exp.shape)
        np.testing.assert_allclose(data_norm, exp, rtol=1e-5, atol=1e-8)


def test_clr_adapt_eps():
    # reference: test/preprocessing.jl:37-45
    s1 = np.concatenate([np.full(10000, 10000.0), np.zeros(10)])
    s2 = np.concatenate([np.full(10, 100.0), np.zeros(10000)])
    s3 = np.arange(1, 10011, dtype=np.float64)
    mat = np.stack([s1, s2, s3])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = pp.normalize_data(mat, test_name="fz", verbose=False)
    assert np.isfinite(res.data).all()
    assert res.data.shape[0] == 2


@requires_reference_data
def test_filter_zero_counts(hmp_small):
    # reference: test/preprocessing.jl:88-132
    data = hmp_small
    wanted_zero_otus = 20
    wanted_binfilt_otus = 10
    added_zero_samples = 10
    binfilt = np.vstack([
        np.zeros((data.shape[0] - 1, wanted_binfilt_otus)),
        np.ones((1, wanted_binfilt_otus)),
    ])
    rm_data = np.hstack([data, binfilt, np.zeros((data.shape[0], wanted_zero_otus))])
    rm_data = np.vstack([rm_data, np.zeros((added_zero_samples, rm_data.shape[1]))])
    wanted_zero_samples = added_zero_samples + 5  # 5 zero samples already in data
    rm_header = [str(i + 1) for i in range(rm_data.shape[1])]
    wanted_header_zero = rm_header[: data.shape[1] + wanted_binfilt_otus]
    wanted_header_binfilt = rm_header[: data.shape[1]]

    for test_name in ["mi", "mi_nz", "fz", "fz_nz"]:
        res = pp.normalize_data(rm_data.copy(), test_name=test_name,
                                header=rm_header, verbose=False)
        zero_otus = wanted_zero_otus + (
            wanted_binfilt_otus if test_name == "mi_nz" else 0
        )
        assert res.data.shape[1] == rm_data.shape[1] - zero_otus, test_name
        assert res.data.shape[0] == rm_data.shape[0] - wanted_zero_samples, test_name
        wanted_header = (
            wanted_header_binfilt if test_name == "mi_nz" else wanted_header_zero
        )
        assert res.header == wanted_header, test_name


@requires_reference_data
def test_mi_nz_fits_fz_nz(hmp_small):
    # discretization consistency (reference: test/preprocessing.jl:135-141)
    fznz = pp.preprocess_data_default(hmp_small, "fz_nz", verbose=False, prec=64).data
    minz = pp.preprocess_data_default(
        hmp_small, "mi_nz", disc_method="mean", verbose=False, prec=64
    ).data
    # note: values exactly equal to the row geomean alias to 0 under clr_nz
    # (log(1) == 0); the reference's dense path shares this quirk (and its own
    # test only exercises the last column due to `for i in size(...)`,
    # reference test/preprocessing.jl:140).  Check all non-aliased columns.
    checked = 0
    for i in range(fznz.shape[1]):
        a = fznz[:, i][fznz[:, i] != 0]
        b = minz[:, i][minz[:, i] != 0]
        if len(a) != len(b):
            continue  # geomean aliasing
        np.testing.assert_array_equal(a > a.mean(), b == 2)
        checked += 1
    assert checked >= 0.75 * fznz.shape[1]


@requires_reference_data
def test_onehot_meta():
    # reference: test/preprocessing.jl:144-185
    def read_table(path):
        rows = [l.rstrip("\n").split("\t") for l in open(path)]
        return rows[0], rows[1:]

    otu_header, otu_rows = read_table(
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny.tsv")
    )
    otu = np.array(otu_rows, dtype=np.float64)
    meta_header, meta_rows = read_table(
        reference_data_path("HMP_SRA_gut", "HMP_SRA_gut_tiny_meta_oneHotTest.tsv")
    )

    def parse_cell(c):
        try:
            return float(c)
        except ValueError:
            return c

    meta = np.array([[parse_cell(c) for c in r] for r in meta_rows], dtype=object)

    exp_header, exp_rows = read_table(
        reference_data_path("preprocessing_expected", "meta_tiny_oneHotTest.tsv")
    )
    exp = np.array(exp_rows, dtype=np.float64)

    data_conc = np.empty((otu.shape[0], otu.shape[1] + meta.shape[1]), dtype=object)
    data_conc[:, : otu.shape[1]] = otu
    data_conc[:, otu.shape[1]:] = meta
    header_conc = list(otu_header) + list(meta_header)
    meta_mask = np.concatenate(
        [np.zeros(len(otu_header), dtype=bool), np.ones(len(meta_header), dtype=bool)]
    )

    for test_name in ["fz", "mi", "fz_nz", "mi_nz"]:
        for make_onehot in [True, False]:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                res = pp.preprocess_data_default(
                    data_conc, test_name, verbose=False, header=header_conc,
                    meta_mask=meta_mask, make_onehot=make_onehot, prec=64,
                )
            if make_onehot:
                A = res.data[:, res.meta_mask][:, :-1].astype(np.float64)
                A_exp = exp[res.obs_filter_mask, :-1]
                if test_name == "fz_nz":
                    A = A - 1  # +1 shift of zero-containing metas in clr_nz
                np.testing.assert_array_equal(A, A_exp, err_msg=test_name)
                got_names = [h for h, m in zip(res.header, res.meta_mask) if m]
                assert got_names == list(exp_header), test_name
                if test_name.startswith("mi"):
                    assert len(np.unique(res.data[:, -1])) == 2
            else:
                assert res.meta_mask.sum() == meta_mask.sum()
                assert res.data.shape[1] == len(res.header)


class TestSparseIngestion:
    """scipy.sparse inputs stream through the zero-preserving normalizations
    and match the dense path exactly (reference sparse-first pipeline:
    src/preprocessing.jl:178,579-594)."""

    def _table(self, n=120, p=40, seed=0):
        rng = np.random.default_rng(seed)
        X = rng.integers(0, 200, (n, p)).astype(np.float64)
        X[rng.random((n, p)) < 0.6] = 0.0
        X[:, 1] = X[:, 0]
        return X

    @pytest.mark.parametrize("test_name", ["mi", "mi_nz", "fz_nz"])
    def test_sparse_matches_dense(self, test_name):
        from scipy import sparse as sp

        from flashweave.preprocessing import normalize_data

        X = self._table()
        dense = normalize_data(X, test_name=test_name, verbose=False, prec=64)
        sparse = normalize_data(sp.csr_matrix(X), test_name=test_name,
                                verbose=False, prec=64)
        assert dense.data.dtype == sparse.data.dtype
        np.testing.assert_allclose(sparse.data, dense.data, rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_array_equal(sparse.obs_filter_mask,
                                      dense.obs_filter_mask)

    @pytest.mark.parametrize("norm_mode", ["tss", "tss-nonzero-binned",
                                           "pres-abs", "clr-nonzero",
                                           "clr-nonzero-binned"])
    def test_sparse_norm_modes(self, norm_mode):
        from scipy import sparse as sp

        from flashweave.preprocessing import normalize_data

        X = self._table(seed=3)
        dense = normalize_data(X, norm_mode=norm_mode, verbose=False, prec=64)
        sparse = normalize_data(sp.csc_matrix(X), norm_mode=norm_mode,
                                verbose=False, prec=64)
        np.testing.assert_allclose(sparse.data, dense.data, rtol=1e-12,
                                   atol=1e-12)

    def test_sparse_adaptive_clr_densifies_with_warning(self):
        from scipy import sparse as sp

        from flashweave.preprocessing import normalize_data

        X = self._table(seed=4)
        with pytest.warns(UserWarning, match="densifying"):
            sparse = normalize_data(sp.csr_matrix(X), test_name="fz",
                                    verbose=False, prec=64)
        dense = normalize_data(X, test_name="fz", verbose=False, prec=64)
        np.testing.assert_allclose(sparse.data, dense.data, rtol=1e-12)

    def test_learn_network_sparse_input(self):
        from scipy import sparse as sp

        from flashweave import learn_network
        from flashweave.utils.testing import compare_graph_results

        X = self._table(n=200, p=30, seed=5)
        g1 = learn_network(X, sensitive=False, heterogeneous=True, max_k=1,
                           verbose=False, parallel_mode="single",
                           prec=64).graph
        g2 = learn_network(sp.csr_matrix(X), sensitive=False,
                           heterogeneous=True, max_k=1, verbose=False,
                           parallel_mode="single", prec=64).graph
        assert compare_graph_results(g1, g2, approx=False, verbose=True)

    def test_sparse_with_meta(self):
        from scipy import sparse as sp

        from flashweave.preprocessing import normalize_data

        X = self._table(seed=6)
        meta_mask = np.zeros(X.shape[1], dtype=bool)
        meta_mask[-2:] = True
        X[:, -2] = (X[:, -2] > 50)
        X[:, -1] = (X[:, -1] > 20)
        dense = normalize_data(X, test_name="mi_nz", meta_mask=meta_mask,
                               verbose=False, prec=64)
        sparse = normalize_data(sp.csr_matrix(X), test_name="mi_nz",
                                meta_mask=meta_mask, verbose=False, prec=64)
        np.testing.assert_allclose(sparse.data, dense.data, rtol=1e-12)
        np.testing.assert_array_equal(sparse.meta_mask, dense.meta_mask)


def test_prec_128_casts_to_64_with_warning():
    """prec=128 is accepted as a documented float64 cast (the reference's
    own Float128 eval fails in base Julia, src/misc.jl:47-52)."""
    import warnings

    from flashweave.preprocessing import _target_dtype

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert _target_dtype(128, True) is np.float64
        assert _target_dtype(128, False) is np.int64
    assert any("128" in str(x.message) for x in w)
    with pytest.raises(ValueError):
        _target_dtype(48, True)
