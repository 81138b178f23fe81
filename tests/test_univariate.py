"""Univariate all-pairs kernel parity tests against the reference's expected
test results (reference: test/tests.jl, fixtures test/data/tests_expected.tsv)."""

import numpy as np
import pytest

from flashweave import preprocessing as pp
from flashweave.ops import univariate as uv

from conftest import reference_data_path, requires_reference_data


def load_tests_expected():
    rows = [l.rstrip("\n").split("\t")
            for l in open(reference_data_path("tests_expected.tsv"))][1:]
    exp = {}
    for key, stat, pval, df, suff in rows:
        rec = (float(stat), float(pval), int(float(df)), suff == "true")
        if key.startswith("exp_cond"):
            exp[key] = rec
        else:
            exp.setdefault(key, []).append(rec)
    return exp


@pytest.fixture(scope="module")
def norm_data(hmp_small):
    return {
        "mi": pp.preprocess_data_default(hmp_small, "mi", verbose=False, prec=64).data,
        "mi_nz": pp.preprocess_data_default(hmp_small, "mi_nz", verbose=False, prec=64).data,
        "fz": pp.preprocess_data_default(hmp_small, "fz", verbose=False, prec=64).data,
        "fz_nz": pp.preprocess_data_default(hmp_small, "fz_nz", verbose=False, prec=64).data,
    }


@requires_reference_data
@pytest.mark.parametrize("test_name", ["mi", "mi_nz", "fz", "fz_nz"])
def test_univar_row_matches_reference(norm_data, test_name):
    # compare raw (no FDR) pair results of X=0 vs Y=1..49 with the
    # reference fixtures generated by FlashWeave.test(1, 2:50, ...)
    exp = load_tests_expected()[f"exp_uni_{test_name}"]
    data = norm_data[test_name]
    _, res = uv.pw_univar_neighbors(
        data, test_name=test_name, FDR=False, correct_reliable_only=False,
        n_obs_min=0, return_result=True,
    )
    p = data.shape[1]
    iu, ju = uv.condensed_index(p)
    row_idx = np.nonzero(iu == 0)[0]
    assert len(row_idx) == len(exp) == p - 1
    for idx, (estat, epval, edf, esuff) in zip(row_idx, exp):
        stat, pval = res.stats[idx], res.pvals[idx]
        suff = bool(res.suff_power[idx])
        assert suff == esuff, (ju[idx], suff, esuff)
        assert np.isclose(stat, estat, rtol=1e-6, atol=1e-12), (ju[idx], stat, estat)
        assert np.isclose(pval, epval, rtol=1e-5, atol=1e-300), (ju[idx], pval, epval)


@requires_reference_data
@pytest.mark.parametrize("test_name", ["mi_nz", "fz_nz"])
def test_tiling_invariance(norm_data, test_name):
    data = norm_data[test_name][:, :20]
    _, r1 = uv.pw_univar_neighbors(data, test_name=test_name, FDR=False,
                                   tile=20, return_result=True)
    _, r2 = uv.pw_univar_neighbors(data, test_name=test_name, FDR=False,
                                   tile=7, return_result=True)
    np.testing.assert_allclose(
        np.nan_to_num(r1.stats, nan=-9), np.nan_to_num(r2.stats, nan=-9),
        rtol=1e-10,
    )


@requires_reference_data
def test_fdr_neighbor_dicts(norm_data):
    # smoke: FDR pass produces symmetric significant neighborhoods
    nbrs = uv.pw_univar_neighbors(norm_data["fz"], test_name="fz", alpha=0.01)
    assert set(nbrs.keys()) == set(range(norm_data["fz"].shape[1]))
    for X, d in nbrs.items():
        for Y, (stat, pval) in d.items():
            assert nbrs[Y][X] == (stat, pval)
            assert pval < 0.01


@requires_reference_data
@pytest.mark.parametrize("test_name", ["mi", "mi_nz", "fz", "fz_nz"])
@pytest.mark.parametrize("FDR", [True, False])
def test_device_extract_matches_host(norm_data, test_name, FDR):
    """The accelerator path (int8 MI route + log-space device BH +
    significant-pair extraction) must produce the same neighbor sets and
    equivalent (stat, adjusted pval) entries as the host float64 pipeline."""
    data = norm_data[test_name]
    host = uv.pw_univar_neighbors(data, test_name=test_name, alpha=0.01,
                                  FDR=FDR)
    uv.FORCE_PALLAS = True
    try:
        dev = uv.pw_univar_neighbors(data, test_name=test_name, alpha=0.01,
                                     FDR=FDR)
    finally:
        uv.FORCE_PALLAS = False
    assert set(host.keys()) == set(dev.keys())
    for X in host:
        assert set(host[X]) == set(dev[X]), (X, host[X], dev[X])
        for Y, (stat, pval) in host[X].items():
            dstat, dpval = dev[X][Y]
            assert np.isclose(dstat, stat, rtol=1e-5, atol=1e-7)
            assert np.isclose(dpval, pval, rtol=1e-3, atol=1e-12)


def test_condensed_pair_inversion():
    from flashweave.ops.univariate import condensed_pos, condensed_to_pair

    for p in [2, 3, 17, 1000, 20000]:
        n_pairs = p * (p - 1) // 2
        idx = np.unique(np.concatenate([
            np.arange(min(n_pairs, 100)),
            np.linspace(0, n_pairs - 1, 100, dtype=np.int64),
        ]))
        X, Y = condensed_to_pair(idx, p)
        assert (X < Y).all() and (Y < p).all() and (X >= 0).all()
        np.testing.assert_array_equal(condensed_pos(X, Y, p), idx)


@pytest.mark.parametrize("test_name", ["mi_nz", "fz", "fz_nz"])
@pytest.mark.parametrize("FDR", [True, False])
def test_scan_extract_multiblock_matches_host(test_name, FDR):
    """The two-pass scan extraction (pass-A count tables -> BH-safe edge ->
    pass-B exact-capacity compaction + in-program BH) must reproduce the
    host float64 pipeline across MULTIPLE X-blocks and slab groups -- the
    geometry that the p~100k scale path exercises (small-p runs cover only
    a single block).  Signal comes from correlated variable groups so the
    candidate set spans blocks unevenly (distinct per-group caps)."""
    rng = np.random.default_rng(7)
    n, p, tile = 256, 384, 64
    base = rng.integers(0, 3, (n, p // 4))
    data = np.repeat(base, 4, axis=1).astype(np.float64)
    flip = rng.random((n, p)) < 0.4
    data = np.where(flip, rng.integers(0, 3, (n, p)).astype(np.float64), data)
    if test_name in ("fz", "fz_nz"):
        data = np.where(data > 0, np.log1p(data + rng.random((n, p))), 0.0)
    host = uv.pw_univar_neighbors(data, test_name=test_name, alpha=0.05,
                                  FDR=FDR, n_obs_min=20, tile=tile)
    uv.FORCE_PALLAS = True
    try:
        dev = uv.pw_univar_neighbors(data, test_name=test_name, alpha=0.05,
                                     FDR=FDR, n_obs_min=20, tile=tile)
    finally:
        uv.FORCE_PALLAS = False
    n_pairs_sig = sum(len(d) for d in host.values())
    assert n_pairs_sig > 0, "test fixture produced no significant pairs"
    assert set(host.keys()) == set(dev.keys())
    for X in host:
        assert set(host[X]) == set(dev[X]), (X, len(host[X]), len(dev[X]))
        for Y, (stat, pval) in host[X].items():
            dstat, dpval = dev[X][Y]
            # the device extraction's closed-form log p-values and sums
            # in another order carry evaluation-order noise
            assert np.isclose(dstat, stat, rtol=1e-4, atol=1e-6)
            assert np.isclose(dpval, pval, rtol=5e-3, atol=1e-300)


def test_select_bin_bh_safety_property():
    """Property test of the extraction-edge selection: for random p-value
    mixtures, every BH-significant p must fall strictly below the selected
    edge (the safety invariant the two-pass extraction rests on), and the
    extracted superset must stay tight (within the one-bin overshoot the
    geometric edge spacing implies)."""
    from flashweave.ops import statfuns as sf

    rng = np.random.default_rng(11)
    alpha = 0.05
    for trial in range(40):
        m = int(rng.integers(500, 20000))
        n_signal = int(rng.integers(0, 200))
        pv = np.concatenate([
            rng.random(m - n_signal),
            10 ** (-rng.random(n_signal) * 40),
        ])
        edges = uv._extract_edges(alpha, m)
        logp = np.log(np.maximum(pv, 1e-300))
        counts = np.array([(logp < e).sum() for e in edges], dtype=np.int64)
        b = uv._select_bin(counts, m, alpha, edges)
        thresh = edges[b]
        adj = sf.benjamini_hochberg(pv, alpha=alpha, m=m)
        with np.errstate(invalid="ignore"):
            sig = np.nonzero(adj < alpha)[0]
        # safety: the extraction edge is above every significant p
        assert (logp[sig] < thresh).all(), (trial, b, len(sig))
        # tightness: the superset exceeds the significant set by at most
        # the pairs inside one extra geometric bin
        if len(sig) and b + 1 < len(edges):
            surplus = int(counts[b]) - len(sig)
            bin_width_pairs = int(counts[max(b - 1, 0)]) - int(
                counts[b + 1]) + len(sig)
            assert surplus <= max(bin_width_pairs, 64), (trial, surplus)


_MI_ROUTE_CASES = [(nz, L, ragged)
                   for nz in ("plain", "nz", "nz-uniform")
                   for L in (2, 3, 4)
                   for ragged in (False, True)
                   if nz != "nz-uniform" or L == 3]


@pytest.mark.parametrize(
    "nz, L, ragged", _MI_ROUTE_CASES,
    ids=[f"{nz}-L{L}-{'ragged' if r else 'aligned'}"
         for nz, L, r in _MI_ROUTE_CASES])
def test_mi_int8_route_matches_float64(nz, L, ragged):
    """The accelerator path's int8 univariate MI route (indicator planes,
    one int8 dot, margin reconstruction + epilogue) against the float64
    numpy one-hot reference: counts, df and power flags bit-equal."""
    from flashweave.utils.devcheck import check_mi_univariate

    flag = {"plain": 0, "nz": 1, "nz-uniform": 2}[nz]
    if ragged:
        kw = dict(n=301, p=203, tile=37, y_len=83)
    else:
        kw = dict(n=256, p=256, tile=64, y_len=128)
    res = check_mi_univariate(L=L, nz=flag, n_blocks=2, seed=L, **kw)
    assert res["blocks"] == 2

