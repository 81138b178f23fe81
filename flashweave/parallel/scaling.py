"""Scaling harness: per-device throughput/efficiency over mesh sizes.

The reference scales over cluster workers and documents only qualitative
behavior (reference: README.md:185-216); BASELINE.json's north star is >=80%
CI-tests/s scaling efficiency at N>=2 hosts.  This harness runs the sharded
univariate pass and a sharded conditional batch over growing device meshes
and reports throughput + efficiency vs the 1-device run.

On real multi-GPU meshes the numbers are true scaling measurements (the
sharded paths' only collectives are the unreliable-count psum and the
BH-sort gather; the conditional batch has none).  On the virtual
multi-device CPU mesh (tests, single-chip dev) the devices share host cores,
so the harness validates the SPMD *expression* and the result parity, not
wall-clock speedup; efficiency numbers are meaningful only on real devices.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from .mesh import get_mesh


def univar_scaling(
    data: np.ndarray,
    test_name: str = "mi_nz",
    device_counts: Sequence[int] = (1, 2, 4, 8),
    repeats: int = 3,
    **kwargs,
) -> Dict[int, dict]:
    """Time the sharded univariate pass at each mesh size.

    Returns {ndev: {seconds, tests_per_sec, efficiency}}; efficiency is
    throughput / (ndev * 1-device throughput).
    """
    import jax

    from ..ops.univariate import pw_univar_neighbors
    from ..utils.misc import get_levels, get_max_vals, isdiscrete

    data = np.asarray(data)
    n, p = data.shape
    n_tests = p * (p - 1) // 2
    levels = max_vals = None
    if isdiscrete(test_name):
        levels = get_levels(data)
        max_vals = get_max_vals(data)

    results: Dict[int, dict] = {}
    avail = len(jax.devices())
    for ndev in device_counts:
        if ndev > avail:
            continue
        mesh = get_mesh(ndev) if ndev > 1 else None
        # warm (compile) pass, then timed repeats
        pw_univar_neighbors(data, test_name, levels=levels,
                            max_vals=max_vals, mesh=mesh, **kwargs)
        t0 = time.perf_counter()
        for _ in range(repeats):
            nbrs = pw_univar_neighbors(data, test_name, levels=levels,
                                       max_vals=max_vals, mesh=mesh, **kwargs)
        dt = (time.perf_counter() - t0) / repeats
        results[ndev] = {
            "seconds": dt,
            "tests_per_sec": n_tests / dt,
            "n_significant": sum(len(v) for v in nbrs.values()) // 2,
        }
    base = results.get(min(results), {}).get("tests_per_sec")
    for ndev, r in results.items():
        r["efficiency"] = (
            r["tests_per_sec"] / (base * ndev / min(results)) if base else None
        )
    return results


def cond_scaling(
    data: np.ndarray,
    test_name: str = "mi_nz",
    B: int = 8192,
    max_k: int = 3,
    device_counts: Sequence[int] = (1, 2, 4, 8),
    repeats: int = 3,
    seed: int = 0,
) -> Dict[int, dict]:
    """Time a fixed batch of sharded conditional MI tests at each mesh size."""
    import jax

    from ..ops.condtests import CondTestEngine
    from ..utils.misc import get_levels, get_max_vals

    data = np.asarray(data)
    p = data.shape[1]
    rng = np.random.default_rng(seed)
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 2, B)).astype(np.int32) % p
    Zs = rng.integers(0, p, (B, max_k)).astype(np.int32)
    kv = rng.integers(1, max_k + 1, B).astype(np.int32)
    lv, mx = get_levels(data.astype(int)), get_max_vals(data.astype(int))

    results: Dict[int, dict] = {}
    avail = len(jax.devices())
    for ndev in device_counts:
        if ndev > avail:
            continue
        mesh = get_mesh(ndev) if ndev > 1 else None
        eng = CondTestEngine(data, test_name, max_k, levels=lv, max_vals=mx,
                             mesh=mesh)
        eng.mi_tests_raw(X, Y, Zs, kv)      # warm/compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            eng.mi_tests_raw(X, Y, Zs, kv)
        dt = (time.perf_counter() - t0) / repeats
        results[ndev] = {"seconds": dt, "tests_per_sec": B / dt}
    base = results.get(min(results), {}).get("tests_per_sec")
    for ndev, r in results.items():
        r["efficiency"] = (
            r["tests_per_sec"] / (base * ndev / min(results)) if base else None
        )
    return results


def report(results: Dict[int, dict], label: str) -> str:
    lines = [f"Scaling: {label}"]
    for ndev, r in sorted(results.items()):
        eff = r.get("efficiency")
        eff_s = f"{eff * 100:5.1f}%" if eff is not None else "  n/a"
        lines.append(
            f"\t{ndev} device(s): {r['tests_per_sec']:.3e} tests/s "
            f"({r['seconds'] * 1e3:.1f} ms, efficiency {eff_s})"
        )
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """CLI: python -m flashweave.parallel.scaling [n] [p]"""
    import sys

    args = list(argv if argv is not None else sys.argv[1:])
    n = int(args[0]) if args else 1024
    p = int(args[1]) if len(args) > 1 else 512
    rng = np.random.default_rng(0)
    data = rng.integers(0, 3, (n, p)).astype(np.float32)
    data[rng.random((n, p)) < 0.4] = 0.0
    print(report(univar_scaling(data), f"univariate mi_nz (n={n}, p={p})"))
    print(report(cond_scaling(data), f"conditional mi_nz batch (n={n}, p={p})"))


if __name__ == "__main__":
    main()
