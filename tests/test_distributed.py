"""2-process multi-host validation (reference scale-out contract:
README.md:185-216).

Launches two REAL OS processes that join one JAX distributed runtime over
gloo CPU collectives (2 virtual devices each -> a 4-device global mesh) and
run the SAME shard_map programs as single-host: the univariate two-pass
extraction and a conditional mega-batch.  Process 0's results must equal the
single-process reference computed in this test -- turning the "the
collective layout is DCN-valid" argument into executed evidence.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "_distributed_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _reference_results():
    """Single-process (8-device virtual mesh of THIS process) expectation,
    same data/batches as the worker."""
    from flashweave.ops import univariate as uv
    from flashweave.ops.condtests import CondTestEngine
    from flashweave.utils.misc import get_levels, get_max_vals

    rng = np.random.default_rng(3)
    n, p = 128, 96
    base = rng.integers(0, 3, (n, p // 4)).astype(np.int8)
    data = np.repeat(base, 4, axis=1)
    flip = rng.random((n, p)) < 0.4
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8),
                    data).astype(np.float64)
    lv, mx = get_levels(data), get_max_vals(data)
    nbrs = uv.pw_univar_neighbors(data, "mi_nz", alpha=0.05, n_obs_min=10,
                                  levels=lv, max_vals=mx)
    pairs = sorted(
        (T, Y, st, pv) for T, d in nbrs.items() for Y, (st, pv) in d.items()
        if T < Y
    )
    engine = CondTestEngine(data, "mi_nz", 3, levels=lv, max_vals=mx,
                            hps=5, n_obs_min=10)
    B = 300
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 1, B).astype(np.int32)) % p
    Zs = rng.integers(0, p, (B, 3)).astype(np.int32)
    kv = rng.integers(0, 4, B).astype(np.int32)
    stat, pval, df, suff = engine.mi_tests_raw(X, Y, Zs, kv)
    cont = np.where(data > 0, np.log1p(data), 0.0)
    eng_fz = CondTestEngine(cont, "fz", 3, hps=5, n_obs_min=10)
    fstat, fpval, _, _ = eng_fz.fz_tests_raw(X, Y, Zs, kv)
    return pairs, stat, pval, df, suff, fstat, fpval


def test_two_process_parity(tmp_path):
    out = str(tmp_path / "dist_out.npz")
    port = _free_port()
    env_base = {
        k: v for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    procs = []
    for pid in range(2):
        env = dict(env_base)
        env.update(
            FLASHWEAVE_COORDINATOR=f"127.0.0.1:{port}",
            FLASHWEAVE_NUM_PROCESSES="2",
            FLASHWEAVE_PROCESS_ID=str(pid),
            FLASHWEAVE_TEST_OUT=out,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
        )
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        ))
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode(errors="replace")[-4000:]
    assert os.path.exists(out)
    got = np.load(out)

    exp_pairs, stat, pval, df, suff, fstat, fpval = _reference_results()
    exp_arr = np.array(exp_pairs, dtype=np.float64).reshape(-1, 4)
    assert got["pairs"].shape == exp_arr.shape
    np.testing.assert_allclose(got["pairs"], exp_arr, rtol=1e-10, atol=0)
    np.testing.assert_allclose(got["stat"], stat, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got["pval"], pval, rtol=1e-10, atol=0)
    np.testing.assert_array_equal(got["df"], df)
    np.testing.assert_array_equal(got["suff"], suff)
    np.testing.assert_allclose(got["fstat"], fstat, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["fpval"], fpval, rtol=1e-9, atol=1e-300)

    # -- full 2-process learn_network: identical networks on every process
    #    (deterministic multi-process LGL incl. the rank-0-broadcast clock)
    #    + golden parity for the untimed runs (reference
    #    test/learning.jl:176-237 runs the full matrix with a worker added)
    r0 = np.load(out + ".rank0.npz")
    r1 = np.load(out + ".rank1.npz")
    net_keys = [k for k in r0.files if k.startswith("net_")]
    if not net_keys:
        pytest.skip("reference data unavailable for e2e networks")
    assert set(net_keys) == {"net_mi_nz", "net_fz_nz", "net_mi", "net_fz",
                             "net_mi_nz_timed"}
    for k in net_keys:
        np.testing.assert_array_equal(
            r0[k], r1[k],
            err_msg=f"{k}: networks differ across processes")

    import flashweave as fw
    from flashweave.types import Graph
    from flashweave.utils.testing import compare_graph_results

    for k, name in (("net_mi_nz", "mi_nz"), ("net_fz_nz", "fz_nz"),
                    ("net_mi", "mi"), ("net_fz", "fz")):
        gold = fw.load_network(
            "/root/reference/test/data/learning_expected/"
            f"exp_{name}_maxk3.edgelist").graph
        if name == "mi":
            # conditional mi is the order-sensitive special case: the
            # reference's own tolerance model grants it 22 nbr diffs
            # (test/learning.jl:210-216); compare under that model
            got_g = Graph(gold.n_nodes)
            for u, v, w in r0[k]:
                got_g.add_edge(int(u), int(v), float(w))
            assert compare_graph_results(
                gold, got_g, rtol=1e-2, approx=True, approx_nbr_diff=22,
                approx_weight_meandiff=0.25, verbose=True)
            continue
        got_edges = {(int(u), int(v)) for u, v, _ in r0[k]}
        exp_edges = {(u, v) for u, v, _ in gold.edges()}
        assert got_edges == exp_edges, (
            f"{name}: 2-process network != reference golden "
            f"(only in got: {got_edges - exp_edges}, "
            f"only in golden: {exp_edges - got_edges})")
