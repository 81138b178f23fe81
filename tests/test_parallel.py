"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest
import jax

from flashweave.parallel.mesh import get_mesh
from flashweave.ops import univariate as uv
from flashweave.ops.condtests import CondTestEngine
from flashweave.learning.lgl import LGL
from flashweave.utils.misc import get_levels, get_max_vals
from flashweave.utils.testing import compare_graph_results

from conftest import requires_reference_data

needs_mesh = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


@pytest.fixture(scope="module")
def synth():
    rng = np.random.default_rng(42)
    n, p = 200, 36
    base = rng.integers(0, 3, (n, p)).astype(np.float64)
    # inject correlated pairs so networks are nonempty
    base[:, 1] = base[:, 0]
    base[:, 3] = np.where(rng.random(n) < 0.8, base[:, 2], base[:, 3])
    return base


@needs_mesh
def test_univar_mesh_matches_single(synth):
    mesh = get_mesh(8)
    lv, mx = get_levels(synth.astype(int)), get_max_vals(synth.astype(int))
    _, r1 = uv.pw_univar_neighbors(synth, "mi_nz", levels=lv, max_vals=mx,
                                   FDR=False, return_result=True)
    _, r2 = uv.pw_univar_neighbors(synth, "mi_nz", levels=lv, max_vals=mx,
                                   FDR=False, return_result=True, mesh=mesh)
    np.testing.assert_allclose(
        np.nan_to_num(r1.stats, nan=-1), np.nan_to_num(r2.stats, nan=-1),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        np.nan_to_num(r1.pvals, nan=-1), np.nan_to_num(r2.pvals, nan=-1),
        rtol=1e-10,
    )


@needs_mesh
def test_cond_mesh_matches_single(synth):
    mesh = get_mesh(8)
    lv, mx = get_levels(synth.astype(int)), get_max_vals(synth.astype(int))
    rng = np.random.default_rng(0)
    B = 100
    p = synth.shape[1]
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 2, B)).astype(np.int32) % p
    Zs = rng.integers(0, p, (B, 3)).astype(np.int32)
    k = rng.integers(0, 4, B).astype(np.int32)
    e1 = CondTestEngine(synth, "mi_nz", 3, levels=lv, max_vals=mx)
    e2 = CondTestEngine(synth, "mi_nz", 3, levels=lv, max_vals=mx, mesh=mesh)
    r1 = e1.mi_tests(X, Y, Zs, k)
    r2 = e2.mi_tests(X, Y, Zs, k)
    for a, b in zip(r1, r2):
        assert np.isclose(a.stat, b.stat, rtol=1e-12)
        assert a.df == b.df and a.suff_power == b.suff_power


@needs_mesh
@requires_reference_data
def test_lgl_multi_il_mesh_matches_unmeshed(hmp_small):
    from flashweave import preprocessing as pp

    d = pp.preprocess_data_default(hmp_small, "fz_nz", verbose=False, prec=64).data
    mesh = get_mesh(8)
    g1 = LGL(d, test_name="fz_nz", max_k=3, parallel="multi_il",
             time_limit=0.0, convergence_threshold=0.0, verbose=False).graph
    g2 = LGL(d, test_name="fz_nz", max_k=3, parallel="multi_il",
             time_limit=0.0, convergence_threshold=0.0, verbose=False,
             mesh=mesh).graph
    assert compare_graph_results(g1, g2, approx=True, approx_nbr_diff=0,
                                 approx_weight_meandiff=0.01, verbose=True)


def _nbr_dicts_close(a, b, rtol_stat=1e-5, rtol_pval=1e-3):
    assert set(a.keys()) == set(b.keys())
    for T in a:
        assert set(a[T].keys()) == set(b[T].keys()), f"target {T}"
        for nbr, (st1, pv1) in a[T].items():
            st2, pv2 = b[T][nbr]
            assert np.isclose(st1, st2, rtol=rtol_stat), (T, nbr)
            assert np.isclose(pv1, pv2, rtol=rtol_pval, atol=1e-280), (T, nbr)


@needs_mesh
@pytest.mark.parametrize("p", [36, 37])  # 37: padding path (p % ndev != 0)
@pytest.mark.parametrize("force_pallas", [False, True])
@pytest.mark.parametrize("test_name", ["mi_nz", "mi", "fz_nz", "fz"])
def test_univar_mesh_extract_matches_host(test_name, force_pallas, p):
    """The mesh fast path (shard_map Y-slab sharding + device log-space BH +
    significant-pair extraction) must reproduce the single-device host-f64
    path's significant set and values -- on the parity path and forced onto
    the accelerator path (int8 MI route)."""
    mesh = get_mesh(8)
    rng = np.random.default_rng(5)
    n = 300
    if test_name.startswith("mi"):
        data = rng.integers(0, 3, (n, p)).astype(np.float64)
        data[rng.random((n, p)) < 0.3] = 0.0
    else:
        data = np.where(rng.random((n, p)) < 0.3, 0.0,
                        rng.standard_normal((n, p)))
    # strong + medium signal so the significant set is stable across dtypes
    data[:, 1] = data[:, 0]
    data[:, 3] = np.where(rng.random(n) < 0.7, data[:, 2], data[:, 3])
    lv = mx = None
    if test_name.startswith("mi"):
        from flashweave.utils.misc import get_levels, get_max_vals

        lv, mx = get_levels(data.astype(int)), get_max_vals(data.astype(int))
    host = uv.pw_univar_neighbors(data, test_name, levels=lv, max_vals=mx)
    old = uv.FORCE_PALLAS
    uv.FORCE_PALLAS = force_pallas
    try:
        meshed = uv.pw_univar_neighbors(data, test_name, levels=lv,
                                        max_vals=mx, mesh=mesh)
    finally:
        uv.FORCE_PALLAS = old
    _nbr_dicts_close(host, meshed)


@needs_mesh
@pytest.mark.parametrize("test_name", ["mi_nz", "fz"])
def test_univar_mesh_extract_multiblock_matches_host(test_name):
    """Mesh fast path at MULTI-BLOCK geometry (p=384, tile=64 -> several
    sweep blocks per device): the production shape every real multichip run
    uses.  Covers the pass-B overflow check against gathered recounts
    (regression: (ndev*nsteps,) vs (nsteps,) broadcasting crash)."""
    mesh = get_mesh(8)
    rng = np.random.default_rng(7)
    n, p = 200, 384
    if test_name.startswith("mi"):
        data = rng.integers(0, 3, (n, p)).astype(np.float64)
        data[rng.random((n, p)) < 0.3] = 0.0
    else:
        data = np.where(rng.random((n, p)) < 0.3, 0.0,
                        rng.standard_normal((n, p)))
    data[:, 1] = data[:, 0]
    data[:, 3] = np.where(rng.random(n) < 0.7, data[:, 2], data[:, 3])
    # extra signal pairs spread across blocks
    for a, b in [(70, 250), (130, 300), (200, 383)]:
        data[:, b] = np.where(rng.random(n) < 0.8, data[:, a], data[:, b])
    lv = mx = None
    if test_name.startswith("mi"):
        lv, mx = get_levels(data.astype(int)), get_max_vals(data.astype(int))
    host = uv.pw_univar_neighbors(data, test_name, levels=lv, max_vals=mx,
                                  tile=64)
    meshed = uv.pw_univar_neighbors(data, test_name, levels=lv, max_vals=mx,
                                    tile=64, mesh=mesh)
    _nbr_dicts_close(host, meshed)


@needs_mesh
@pytest.mark.parametrize("test_name", ["mi", "fz"])
def test_lgl_mesh_matches_single(test_name):
    """mi / fz LGL over the mesh vs exact sequential single mode."""
    rng = np.random.default_rng(11)
    n, p = 250, 30
    if test_name == "mi":
        d = rng.integers(0, 2, (n, p)).astype(np.float64)
        d[:, 1] = d[:, 0]
        d[:, 3] = np.where(rng.random(n) < 0.8, d[:, 2], d[:, 3])
    else:
        d = rng.standard_normal((n, p))
        d[:, 1] = d[:, 0] + 0.1 * rng.standard_normal(n)
        d[:, 3] = d[:, 2] + 0.5 * rng.standard_normal(n)
    mesh = get_mesh(8)
    g1 = LGL(d, test_name=test_name, max_k=2, parallel="single",
             time_limit=0.0, convergence_threshold=0.0, verbose=False).graph
    g2 = LGL(d, test_name=test_name, max_k=2, parallel="multi_il",
             time_limit=0.0, convergence_threshold=0.0, verbose=False,
             mesh=mesh).graph
    assert compare_graph_results(g1, g2, approx=True, approx_nbr_diff=0,
                                 approx_weight_meandiff=0.01, verbose=True)


@needs_mesh
def test_dryrun_multichip():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@needs_mesh
def test_scaling_harness(synth):
    """The scaling harness runs the sharded paths at every mesh size and
    reports identical significant sets (the CPU mesh validates the SPMD
    expression; wall-clock efficiency is only meaningful on real chips)."""
    from flashweave.parallel.scaling import (
        cond_scaling, report, univar_scaling,
    )

    res = univar_scaling(synth, "mi_nz", device_counts=(1, 2, 8), repeats=1)
    assert set(res) == {1, 2, 8}
    sigs = {r["n_significant"] for r in res.values()}
    assert len(sigs) == 1, f"mesh sizes disagree on significant pairs: {sigs}"
    assert all(r["tests_per_sec"] > 0 for r in res.values())
    assert res[1]["efficiency"] == 1.0
    out = report(res, "univar")
    assert "8 device(s)" in out

    res2 = cond_scaling(synth, "mi_nz", B=512, device_counts=(1, 8),
                        repeats=1)
    assert set(res2) == {1, 8}
