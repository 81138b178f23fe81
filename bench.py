"""Benchmark on one NVIDIA GPU: CI-test throughput + end-to-end edges/sec.

Measurements (no benchmark cells yet; they are the next step of the
roadmap, ROADMAP.md S1):

1. univariate CI-test throughput of the mi_nz int8 route (level-indicator
   int8 dots + G-test epilogue + closed-form chi2 tails) and of the fz_nz
   masked moments over the X<Y triangle at n = p = 8192;
2. edges/sec of the full LGL inference (univariate pass + HITON
   conditional search through the round scheduler at max_k=3) on a
   synthetic 10k-OTU table, one cold run then four warm runs;
3. the turbo-window conditional kernel's device rate;
4. p=65,536 and p=98,304 univariate extraction and full LGL at scale;
5. golden parity against the reference's expected networks when the
   reference fixtures are mounted.

Device times are host-clock medians of warm calls ended by
``block_until_ready``; the LGL runs are wall-clock end-to-end host+device
measurements.  Fails when JAX finds no GPU.  Prints the card's name and
power limit, then ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "device", "extra"}.

The reference (FlashWeave.jl) publishes no quantitative numbers
(BASELINE.md); `vs_baseline` is reported against the documented working
assumption of 1e6 univariate CI tests/sec for the reference's optimized
single-core sparse kernels.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ASSUMED_REFERENCE_TESTS_PER_SEC = 1.0e6
REFERENCE_DATA = "/root/reference/test/data"


def univar_bench(n=8192, p=8192, L=3):
    """mi_nz and fz_nz univariate sweep throughput (tests/s) over the X<Y
    triangle, each block's statistics and log p-values reduced on device."""
    import jax
    import jax.numpy as jnp

    from flashweave.ops import statfuns as sf
    from flashweave.ops import univariate as uv
    from flashweave.utils.devcheck import time_call

    tile = 512
    rng = np.random.default_rng(0)
    # zero-inflated 3-level data like a binned OTU table
    data = rng.integers(0, L, (n, p)).astype(np.int8)
    data[rng.random((n, p)) < 0.4] = 0
    levels = jnp.full(p, 3, jnp.int32)
    maxv = jnp.full(p, 2, jnp.int32)
    slab = uv._y_slabs(p, tile, triangle=True)
    dT = jnp.asarray(np.ascontiguousarray(data.T))
    marg = uv.level_marginals(dT, L)

    @jax.jit
    def mi_pipeline(dT):
        outs = []
        for s in range(0, p, tile):
            y_start, y_len = slab(s)
            stat, df, n_obs, suff = uv.mi_univar_stats(
                dT, marg, levels, maxv, s, tile, L, y_start, y_len, 2, 5.0,
                20.0)
            lp = sf.mi_logpval_smalldf(stat, df, n_obs, (L - 1) ** 2, xp=jnp)
            outs.append(stat.sum() + lp.sum() + suff.sum())
        return jnp.stack(outs)

    n_tests = p * (p - 1) // 2
    mi_tps = n_tests / time_call(mi_pipeline, dT)

    cont = np.where(data > 0, np.log1p(data), 0.0).astype(np.float32)
    dc = jnp.asarray(cont)

    @jax.jit
    def fz_pipeline(dc):
        outs = []
        for s in range(0, p, tile):
            y_start, y_len = slab(s)
            r, N = uv.fz_nz_block(dc, s, tile, y_start, y_len)
            lp = sf.fz_logpval(r, N, 0, xp=jnp)
            outs.append(r.sum() + lp.sum())
        return jnp.stack(outs)

    fz_tps = n_tests / time_call(fz_pipeline, dc)
    return mi_tps, fz_tps


def cond_device_rate_bench(n=2048, p=4096, m=8):
    """Device rate of the turbo-window conditional kernel
    (ops/condtests._turbo_digest_fn): the conditional stage's kernel
    co-metric, free of host scheduling."""
    import math

    import jax
    import jax.numpy as jnp

    from flashweave.learning.hiton import _turbo_mxu_template
    from flashweave.ops.condtests import CondTestEngine, _turbo_digest_fn
    from flashweave.utils.devcheck import time_call

    rng = np.random.default_rng(0)
    data = rng.integers(0, 3, (n, p)).astype(np.int8)
    data[rng.random((n, p)) < 0.4] = 0
    lv = np.full(p, 3, np.int32)
    mx = np.full(p, 2, np.int32)
    eng = CondTestEngine(data.astype(np.float32), "mi_nz", 3, levels=lv,
                         max_vals=mx, hps=5, n_obs_min=20)
    tpl = _turbo_mxu_template(m, 3)
    B, U, NC = tpl["B"], tpl["U"], tpl["NC"]
    W = 512
    Ts = rng.integers(0, p, W)
    cands = rng.integers(0, p, (W, m))
    eng.turbo_tests_finish(eng.turbo_tests_begin(m, Ts, cands, 0.01, tpl))
    dev = eng._turbo_dev_cache[m]
    # the window chunk turbo_tests_begin's working-set rule picks
    Wc = min(64, 1 << max(0, ((1 << 26) // (n * U * 27)).bit_length() - 1))
    nseg = W // Wc
    fn = _turbo_digest_fn(None, nseg, Wc, m, 3, 3, 27, True, True, NC, B, U,
                          108, True)
    la = jnp.asarray(math.log(0.01),
                     jnp.float64 if jax.config.jax_enable_x64
                     else jnp.float32)
    Tsj = jnp.asarray(Ts.astype(np.uint16).reshape(nseg, Wc))
    Csj = jnp.asarray(cands.astype(np.uint16).reshape(nseg, Wc, m))
    dt = time_call(lambda: fn(eng.data_j, eng.levels_j, eng.maxv_j, Tsj,
                              Csj, *dev, 5.0, la))
    return {
        "cond_device_tests_per_sec": round(W * B / dt, 1),
        "cond_device_windows_per_sec": round(W / dt, 1),
        "cond_device_probe": f"turbo m={m} W={W} n={n} Wc={Wc}",
    }


def _synth_table(n, p, group, seed=1):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 3, (n, p // group)).astype(np.int8)
    data = np.repeat(base, group, axis=1)
    flip = rng.random((n, p)) < 0.35
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8), data)
    return data.astype(np.float32)


def lgl_run(data, max_k=3, test_name="mi_nz"):
    from flashweave.learning.lgl import LGL
    from flashweave.utils.timing import StageTimer
    from flashweave.ops import condtests as ct

    ct.N_TESTS_DISPATCHED = 0
    timer = StageTimer()
    t0 = time.perf_counter()
    res = LGL(data, test_name=test_name, max_k=max_k, parallel="multi_il",
              time_limit=0.0, convergence_threshold=0.0, verbose=False,
              n_obs_min=20, stage_timer=timer)
    total = time.perf_counter() - t0
    n_edges = res.graph.n_edges()
    cond_s = timer.stages.get("conditional", float("nan"))
    univar_s = timer.stages.get("univariate", float("nan"))
    return dict(
        edges_per_sec=round(n_edges / total, 1),
        n_edges=n_edges,
        total_sec=round(total, 2),
        univar_stage_sec=round(univar_s, 2),
        cond_stage_sec=round(cond_s, 2),
        cond_tests_per_sec=(
            round(ct.N_TESTS_DISPATCHED / cond_s, 1) if cond_s > 0 else None
        ),
        n_cond_tests_dispatched=int(ct.N_TESTS_DISPATCHED),
    )


def lgl_bench(n=2048, p=10000, group=5, max_k=3):
    """End-to-end LGL on a synthetic 10k-OTU table (BASELINE.json metric #2):
    one cold run (compile-inflated) then 4 warm steady-state runs; the best
    warm run (labeled best-of-4) and the median are both reported."""
    data = _synth_table(n, p, group)
    cold = lgl_run(data, max_k)
    warm_runs = [lgl_run(data, max_k) for _ in range(4)]
    warm = min(warm_runs, key=lambda r: r["total_sec"])
    med = sorted(r["total_sec"] for r in warm_runs)[len(warm_runs) // 2]
    med_run = next(r for r in warm_runs if r["total_sec"] == med)
    return dict(
        edges_per_sec_10k_otus=warm["edges_per_sec"],
        n_edges_10k=warm["n_edges"],
        lgl_total_sec=warm["total_sec"],
        lgl_warm_policy="best-of-4",
        lgl_total_sec_median=med_run["total_sec"],
        edges_per_sec_10k_otus_median=med_run["edges_per_sec"],
        univar_stage_sec=warm["univar_stage_sec"],
        cond_stage_sec=warm["cond_stage_sec"],
        cond_tests_per_sec=warm["cond_tests_per_sec"],
        cond_tests_per_sec_median=med_run["cond_tests_per_sec"],
        n_cond_tests=warm["n_cond_tests_dispatched"],
        cold=dict(
            edges_per_sec_10k_otus=cold["edges_per_sec"],
            lgl_total_sec=cold["total_sec"],
            univar_stage_sec=cold["univar_stage_sec"],
            cond_stage_sec=cold["cond_stage_sec"],
        ),
    )


def lgl_scale_bench(p=98304, n=2048, max_k=3, test_name="mi_nz", runs=2,
                    tag=None):
    """FULL end-to-end LGL (univariate + conditional HITON search) at the
    reference's headline ~100k-variable regime (reference: README.md:8,183)
    -- not just the univariate pass.  Best of ``runs``; the first run
    reuses every kernel shape the 10k/65k benches compiled."""
    data = _synth_table(n, p, 8, seed=0)
    if not test_name.startswith("mi"):
        data = np.where(data > 0, np.log1p(data), 0.0).astype(np.float32)
    rs = [lgl_run(data, max_k, test_name=test_name) for _ in range(runs)]
    r = min(rs, key=lambda x: x["total_sec"])
    tag = tag or f"p{p}"
    return {
        f"lgl_{tag}_edges_per_sec": r["edges_per_sec"],
        f"lgl_{tag}_n_edges": r["n_edges"],
        f"lgl_{tag}_total_sec": r["total_sec"],
        f"lgl_{tag}_total_sec_all_runs": [x["total_sec"] for x in rs],
        f"lgl_{tag}_cond_tests_per_sec": r["cond_tests_per_sec"],
        f"lgl_{tag}_n_cond_tests": r["n_cond_tests_dispatched"],
    }


def scale_bench(p=65536, n=2048, test_name="mi_nz"):
    """Univariate extraction beyond the former 2^31-covered-pairs hard
    limit.  Warm number: second call in-process (persistent compile cache);
    includes the host->device table upload."""
    from flashweave.ops.univariate import pw_univar_neighbors

    data = _synth_table(n, p, 8, seed=0)
    kw = {}
    if test_name.startswith("mi"):
        kw = dict(levels=np.full(p, 3, np.int32),
                  max_vals=np.full(p, 2, np.int32))
    else:
        data = np.where(data > 0, np.log1p(data), 0.0).astype(np.float32)

    def run():
        t0 = time.perf_counter()
        nbrs = pw_univar_neighbors(data, test_name, alpha=0.01, n_obs_min=20,
                                   **kw)
        dt = time.perf_counter() - t0
        nsig = sum(len(d) for d in nbrs.values()) // 2
        return dt, nsig

    cold_s, _ = run()
    warm_s, n_sig = run()
    n_pairs = p * (p - 1) // 2
    tag = f"p{p}" if test_name == "mi_nz" else f"p{p}_{test_name}"
    return {
        f"univar_{tag}_tests_per_sec": round(n_pairs / warm_s, 1),
        f"univar_{tag}_warm_sec": round(warm_s, 2),
        f"univar_{tag}_cold_sec": round(cold_s, 2),
        f"univar_{tag}_n_sig": int(n_sig),
    }


def golden_parity_bench():
    """Reference-golden network parity computed through the accelerator path
    (int8 univariate route + device log-space BH + int8 conditional
    kernels) at prec=32, judged under the reference's own tolerance model
    (reference: test/learning.jl:46-103, tolerances :210-216)."""
    import os
    import warnings

    if not os.path.isdir(REFERENCE_DATA):
        return {"golden_parity": None}
    from flashweave import learn_network, load_network
    from flashweave.utils.testing import compare_graph_results

    tsv = os.path.join(REFERENCE_DATA, "HMP_SRA_gut", "HMP_SRA_gut_small.tsv")
    ok = True
    detail = {}
    for test, sens, het in (("mi_nz", False, True), ("fz_nz", True, True),
                            ("mi", False, False), ("fz", True, False)):
        exp = load_network(os.path.join(
            REFERENCE_DATA, "learning_expected",
            f"exp_{test}_maxk3.edgelist")).graph
        n_obs_min = 160 if test.startswith("mi") else -1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            net = learn_network(
                tsv, sensitive=sens, heterogeneous=het, max_k=3, prec=32,
                parallel_mode="single_il", time_limit=0.0, verbose=False,
                n_obs_min=n_obs_min,
            )
        good = compare_graph_results(
            exp, net.inference_results.graph, rtol=1e-2, approx=True,
            approx_nbr_diff=0, approx_weight_meandiff=0.05,
        )
        detail[f"golden_{test}_maxk3"] = bool(good)
        ok = ok and good
    return {"golden_parity": bool(ok), **detail}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from flashweave.utils.cache import configure_compile_cache

    configure_compile_cache(os.path.dirname(os.path.abspath(__file__)))
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        sys.exit(1)
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)

    mi_tps, fz_tps = univar_bench(8192, 8192)
    extra = lgl_bench(2048, 10000)
    extra.update(cond_device_rate_bench())
    extra.update(scale_bench(65536, 2048))
    # the reference's headline ~100k-variable regime (4.8e9 pairs)
    extra.update(scale_bench(98304, 2048))
    # continuous (sensitive) modes at scale: univariate extraction + full
    # end-to-end LGL (fz rides the on-the-fly conditional correlations
    # past the device-memory limit of the materialized matrix)
    extra.update(scale_bench(65536, 2048, test_name="fz_nz"))
    extra.update(scale_bench(65536, 2048, test_name="fz"))
    extra.update(lgl_scale_bench(65536, 2048, test_name="fz_nz",
                                 runs=2, tag="p65536_fznz"))
    extra.update(lgl_scale_bench(65536, 2048, test_name="fz",
                                 runs=2, tag="p65536_fz"))
    # full inference (not just univariate) at the headline regime
    extra.update(lgl_scale_bench(98304, 2048, runs=2))
    extra["fz_nz_univar_tests_per_sec"] = round(fz_tps, 1)
    extra.update(golden_parity_bench())

    result = {
        "metric": "univariate CI tests/sec (mi_nz G-test, n=8192, p=8192)",
        "value": round(mi_tps, 1),
        "unit": "tests/s",
        "vs_baseline": round(mi_tps / ASSUMED_REFERENCE_TESTS_PER_SEC, 3),
        "device": device,
        "extra": extra,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
