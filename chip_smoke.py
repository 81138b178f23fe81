#!/usr/bin/env python3
"""Smoke run of FlashWeave on one NVIDIA GPU.

    python chip_smoke.py            # phases (a)-(e) on one card
    python chip_smoke.py --four     # multi_il over a 4-GPU mesh vs one card

Phases, all in this process on the card (the float64 reference of phase
(d) runs in a child process held to the CPU, which never opens the card):

  (a) device and card: JAX's device, ``nvidia-smi`` name and power limit;
  (b) kernel parity at real widths: the int8 univariate MI route and the
      fz_nz masked moments at n = p = 8192 against float64 numpy, the
      turbo-window kernel (n=2048, p=4096, m=8, W=512) against the per-test
      histogram digest;
  (c) main path: ``learn_network`` on a seeded raw count table (2048 samples
      x 10,000 OTUs) in all four modes, cold and warm, and in mi_nz and
      fz_nz the device-extracted univariate pairs against host float64 BH
      on the same statistics;
  (d) whole-network parity: a 2048 x 1,000 table in all four modes against
      the CPU float64 parity path;
  (e) headline scale: univariate extraction and full LGL mi_nz at
      p = 65,536, n = 2,048.

Exits non-zero, printing no result line, when JAX finds no GPU, when the
package is not next to this script, or when any phase fails.  The last line
of a passing run is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
MODES = (("mi", False, False), ("mi_nz", False, True),
         ("fz", True, False), ("fz_nz", True, True))
# phase (c) batches all targets per round (multi_il, run to completion):
# one device holds the whole search; the one-device default (single_il)
# dispatches per target and is exercised by phase (d)
MAIN_PATH_KW = dict(parallel_mode="multi_il", time_limit=0.0, conv=0.0)
# real widths of each phase: (b) kernel parity, the turbo window, (c) the
# main-path table, (d) the parity table, (e) the headline scale
SIZES = {"kernel": 8192, "kernel_tile": 512, "turbo": (2048, 4096, 8, 512),
         "main": (2048, 10000), "parity": (2048, 1000),
         "headline": (2048, 65536)}


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def peak_bytes(dev):
    return (dev.memory_stats() or {}).get("peak_bytes_in_use")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_b(dev):
    from flashweave.utils import devcheck as dc

    k, t = SIZES["kernel"], SIZES["kernel_tile"]
    n, p, m, W = SIZES["turbo"]
    return {"mi_univariate": dc.check_mi_univariate(k, k, tile=t,
                                                    y_len=2 * t, n_blocks=3),
            "fz_nz": dc.check_fz_nz_univariate(k, k, tile=t, y_len=2 * t,
                                               n_blocks=3),
            "turbo_window": dc.check_turbo_window(n, p, m=m, W=W)}


def univariate_pairs_match(data, test_name, alpha=0.01):
    """Device-extracted univariate pairs vs host float64 p-values + BH on
    the same device statistics; pairs within 1e-6 relative of alpha may
    differ."""
    from flashweave.learning.lgl import prepare_lgl
    from flashweave.ops import univariate as uv

    levels, max_vals, _, _, n_obs_min = prepare_lgl(
        data, test_name, 0.0, "single_il", True, 3, -1, 5, True, False)
    kw = dict(alpha=alpha, n_obs_min=n_obs_min, levels=levels,
              max_vals=max_vals)
    dev = uv.pw_univar_neighbors(data, test_name, **kw)
    _, res = uv.pw_univar_neighbors(data, test_name, return_result=True, **kw)
    p = data.shape[1]
    got = {(x, y) for x, nb in dev.items() for y in nb if x < y}
    with np.errstate(invalid="ignore"):
        sig = np.nonzero(res.pvals < alpha)[0]
    X, Y = uv.condensed_to_pair(sig, p)
    want = set(zip(X.tolist(), Y.tolist()))
    diff = got ^ want
    near = 0
    for x, y in diff:
        pv = res.pvals[uv.condensed_pos(x, y, p)]
        if abs(pv - alpha) <= 1e-6 * alpha:
            near += 1
        else:
            raise AssertionError(
                f"{test_name}: pair ({x}, {y}) adjusted p {pv} differs "
                f"between device extraction and host BH")
    return {"pairs": len(want), "differ_near_alpha": near}


def phase_c(dev, seed):
    import flashweave as fw
    from flashweave import preprocessing as pp
    from flashweave.utils.devcheck import raw_count_table

    raw = raw_count_table(*SIZES["main"], seed=seed)
    out = {"zero_fraction": float((raw == 0).mean())}
    for test, sens, het in MODES:
        row = {}
        for run in ("cold", "warm"):
            t0 = time.perf_counter()
            res = fw.learn_network(raw, sensitive=sens, heterogeneous=het,
                                   max_k=3, verbose=False, **MAIN_PATH_KW)
            row[f"{run}_s"] = time.perf_counter() - t0
        row["edges"] = res.inference_results.graph.n_edges()
        row["stages_s"] = res.parameters["stage_times"]
        row["peak_bytes_in_use"] = peak_bytes(dev)
        if het:
            data = pp.normalize_data(raw, test_name=test, verbose=False,
                                     prec=32).data
            row["univariate_vs_host_bh"] = univariate_pairs_match(data, test)
        out[test] = row
        log(f"  (c) {test}: {json.dumps(row)}")
    return out


def graph_edges(g):
    return [[int(u), int(v), float(w)] for u, v, w in g.edges()]


def reference_networks(seed):
    """Child process: the four networks of the phase-(d) table on the CPU
    float64 parity path, printed as one JSON line."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import flashweave as fw
    from flashweave.utils.devcheck import raw_count_table

    raw = raw_count_table(*SIZES["parity"], seed=seed + 1)
    out = {}
    for test, sens, het in MODES:
        res = fw.learn_network(raw, sensitive=sens, heterogeneous=het,
                               max_k=3, verbose=False, prec=64)
        out[test] = graph_edges(res.inference_results.graph)
    print(json.dumps(out), flush=True)


def start_reference(seed):
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference",
         "--seed", str(seed)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        text=True)


def phase_d(child, seed):
    import flashweave as fw
    from flashweave.types import Graph
    from flashweave.utils.devcheck import raw_count_table
    from flashweave.utils.testing import compare_graph_results

    raw = raw_count_table(*SIZES["parity"], seed=seed + 1)
    gpu = {}
    for test, sens, het in MODES:
        res = fw.learn_network(raw, sensitive=sens, heterogeneous=het,
                               max_k=3, verbose=False)
        gpu[test] = res.inference_results.graph
    stdout, _ = child.communicate(timeout=900)
    if child.returncode != 0:
        raise RuntimeError(f"CPU reference exited {child.returncode}")
    ref = json.loads(stdout.strip().splitlines()[-1])
    out = {}
    failed = []
    for test, _, _ in MODES:
        g_ref = Graph(raw.shape[1])
        for u, v, w in ref[test]:
            g_ref.add_edge(u, v, w)
        g = gpu[test]
        e_ref = {(u, v) for u, v, _ in ref[test]}
        e_gpu = {(u, v) for u, v, _ in g.edges()}
        ok = compare_graph_results(
            g_ref, g, rtol=1e-2, approx=True, approx_nbr_diff=0,
            approx_weight_meandiff=0.05)
        w_ref = {(u, v): w for u, v, w in ref[test]}
        w_gpu = {(u, v): w for u, v, w in g.edges()}
        off = [(k, w_ref[k], w_gpu[k]) for k in sorted(e_ref & e_gpu)
               if not np.isclose(w_ref[k], w_gpu[k], rtol=1e-2)]
        out[test] = {"edges_cpu_f64": len(e_ref), "edges_gpu": len(e_gpu),
                     "flipped_edges": len(e_ref ^ e_gpu),
                     "weights_off_1pct": len(off), "first_off": off[:5],
                     "match": bool(ok)}
        if not ok:
            failed.append(test)
    if failed:
        raise AssertionError(f"network parity failed: {failed}: {out}")
    return out


def phase_e(dev):
    from flashweave.learning.lgl import LGL
    from flashweave.ops import univariate as uv
    from flashweave.utils.devcheck import grouped_table

    n, p = SIZES["headline"]
    data = grouped_table(n, p, group=8, seed=0).astype(np.float32)
    kw = dict(levels=np.full(p, 3, np.int32), max_vals=np.full(p, 2, np.int32),
              alpha=0.01, n_obs_min=20)
    out = {}
    for run in ("cold", "warm"):
        t0 = time.perf_counter()
        nb = uv.pw_univar_neighbors(data, "mi_nz", **kw)
        out[f"univariate_{run}_s"] = time.perf_counter() - t0
    out["univariate_pairs"] = sum(len(v) for v in nb.values()) // 2
    t0 = time.perf_counter()
    res = LGL(data, test_name="mi_nz", max_k=3, parallel="multi_il",
              time_limit=0.0, convergence_threshold=0.0, n_obs_min=20,
              verbose=False)
    out["lgl_s"] = time.perf_counter() - t0
    out["lgl_edges"] = res.graph.n_edges()
    out["peak_bytes_in_use"] = peak_bytes(dev)
    return out


def phase_four(seed):
    """multi_il over a 4-GPU mesh against the same run on one card."""
    import jax

    from flashweave import preprocessing as pp
    from flashweave.learning.lgl import LGL
    from flashweave.parallel.mesh import get_mesh
    from flashweave.utils.devcheck import raw_count_table
    from flashweave.utils.testing import compare_graph_results

    if len(jax.devices()) < 4:
        raise RuntimeError(f"--four needs 4 GPUs, JAX sees {jax.devices()}")
    raw = raw_count_table(*SIZES["main"], seed=seed)
    out = {}
    failed = []
    for test in ("mi_nz", "fz_nz"):
        data = pp.normalize_data(raw, test_name=test, verbose=False,
                                 prec=32).data
        kw = dict(test_name=test, max_k=3, parallel="multi_il",
                  time_limit=0.0, convergence_threshold=0.0, verbose=False)
        t0 = time.perf_counter()
        g4 = LGL(data, mesh=get_mesh(4), **kw).graph
        t4 = time.perf_counter() - t0
        t0 = time.perf_counter()
        g1 = LGL(data, mesh=get_mesh(1), **kw).graph
        t1 = time.perf_counter() - t0
        ok = compare_graph_results(g1, g4, approx=True, approx_nbr_diff=0,
                                   approx_weight_meandiff=0.01)
        out[test] = {"edges_1": g1.n_edges(), "edges_4": g4.n_edges(),
                     "cold_seconds_1": t1, "cold_seconds_4": t4,
                     "match": bool(ok)}
        log(f"  (four) {test}: {json.dumps(out[test])}")
        if not ok:
            failed.append(test)
    if failed:
        raise AssertionError(f"mesh vs single card differ: {failed}")
    return out


# --------------------------------------------------------------------------
# driver
# --------------------------------------------------------------------------

def run_phase(name, fn, *args):
    t0 = time.perf_counter()
    try:
        res = fn(*args)
    except Exception:  # noqa: BLE001 -- report every phase, fail at the end
        log(f"phase {name}: FAILED after {time.perf_counter() - t0:.1f} s")
        traceback.print_exc()
        return False
    log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
        f"{json.dumps(res, default=str)}")
    return True


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-GPU mesh phase and its 1-card baseline")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu-reference", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    try:
        from flashweave.utils.cache import configure_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the flashweave package is not next to this "
              f"script ({e})", file=sys.stderr)
        return 2
    configure_compile_cache(ROOT)
    if args.cpu_reference:
        reference_networks(args.seed)
        return 0

    import jax

    try:
        devs = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: JAX found no device: {e}", file=sys.stderr)
        return 1
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 1
    dev = devs[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(devs)}
    log(f"phase a: device {json.dumps(device)}")
    log(f"card: {card_line()}")

    if args.four:
        ok = run_phase("four", phase_four, args.seed)
    else:
        child = start_reference(args.seed)
        try:
            ok = run_phase("b", phase_b, dev)
            ok &= run_phase("c", phase_c, dev, args.seed)
            ok &= run_phase("d", phase_d, child, args.seed)
            ok &= run_phase("e", phase_e, dev)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
