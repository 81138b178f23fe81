"""Worker program for the 2-process CPU validation of the multi-host path.

Launched by tests/test_distributed.py with FLASHWEAVE_* env vars; joins the
JAX distributed runtime (gloo cross-process CPU collectives), builds the
GLOBAL mesh from all processes' devices, and runs the univariate fast path
plus a conditional mega-batch through the same shard_map programs used
single-host.  Process 0 writes the results to OUT_PATH as npz.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
if "--xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
# cross-process CPU collectives ride gloo; must be configured before the
# backend client exists
jax.config.update("jax_cpu_collectives_implementation", "gloo")
jax.config.update("jax_enable_x64", True)

from flashweave.utils.cache import configure_compile_cache  # noqa: E402

configure_compile_cache(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

from flashweave.parallel.distributed import initialize_from_env  # noqa: E402

assert initialize_from_env(), "FLASHWEAVE_* env vars missing"

import numpy as np  # noqa: E402

from flashweave.ops import univariate as uv  # noqa: E402
from flashweave.ops.condtests import CondTestEngine  # noqa: E402
from flashweave.parallel.mesh import get_mesh  # noqa: E402
from flashweave.utils.misc import get_levels, get_max_vals  # noqa: E402


def main():
    out_path = os.environ["FLASHWEAVE_TEST_OUT"]
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()
    mesh = get_mesh(4)

    rng = np.random.default_rng(3)
    n, p = 128, 96
    base = rng.integers(0, 3, (n, p // 4)).astype(np.int8)
    data = np.repeat(base, 4, axis=1)
    flip = rng.random((n, p)) < 0.4
    data = np.where(flip, rng.integers(0, 3, (n, p), dtype=np.int8),
                    data).astype(np.float64)
    lv, mx = get_levels(data), get_max_vals(data)

    # univariate fast path (two-pass scan extraction) over the global mesh
    nbrs = uv.pw_univar_neighbors(data, "mi_nz", alpha=0.05, n_obs_min=10,
                                  levels=lv, max_vals=mx, mesh=mesh)
    pairs = sorted(
        (T, Y, st, pv) for T, d in nbrs.items() for Y, (st, pv) in d.items()
        if T < Y
    )

    # conditional mega-batch over the global mesh
    engine = CondTestEngine(data, "mi_nz", 3, levels=lv, max_vals=mx,
                            hps=5, n_obs_min=10, mesh=mesh)
    B = 300
    X = rng.integers(0, p, B).astype(np.int32)
    Y = (X + 1 + rng.integers(0, p - 1, B).astype(np.int32)) % p
    Zs = rng.integers(0, p, (B, 3)).astype(np.int32)
    kv = rng.integers(0, 4, B).astype(np.int32)
    stat, pval, df, suff = engine.mi_tests_raw(X, Y, Zs, kv)

    # sharded fz conditional kernel (device-resident correlation + pcor DP)
    cont = np.where(data > 0, np.log1p(data), 0.0)
    eng_fz = CondTestEngine(cont, "fz", 3, hps=5, n_obs_min=10, mesh=mesh)
    assert eng_fz.cor_device
    fstat, fpval, _, _ = eng_fz.fz_tests_raw(X, Y, Zs, kv)

    # -- full end-to-end learn_network across BOTH processes (the
    #    reference's scale-out contract: a complete inference with workers
    #    attached, reference test/learning.jl:176-237) -------------------
    import flashweave as fw

    tsv = "/root/reference/test/data/HMP_SRA_gut/HMP_SRA_gut_small.tsv"
    nets = {}
    if os.path.isdir("/root/reference/test/data"):
        for name, sens, het, kw in (
            # all 4 modes (reference's multi-worker matrix covers every
            # mode, test/learning.jl:176-237)
            ("mi_nz", False, True, dict(n_obs_min=160)),
            ("fz_nz", True, True, {}),
            ("mi", False, False, dict(n_obs_min=160)),
            ("fz", True, False, {}),
            # exercises the rank-0-broadcast deterministic clock: checkpoint
            # and convergence decisions must be identical on both processes
            ("mi_nz_timed", False, True,
             dict(n_obs_min=160, time_limit=0.02, conv=0.01)),
        ):
            res = fw.learn_network(
                tsv, sensitive=sens, heterogeneous=het, max_k=3, prec=64,
                parallel_mode="multi_il", verbose=False,
                **({"time_limit": 0.0, "conv": 0.0} if "timed" not in name
                   else {}), **kw,
            )
            g = fw.graph(res)
            nets[name] = np.array(
                [(u, v, w) for u, v, w in g.edges()], dtype=np.float64
            ).reshape(-1, 3)

    # EVERY process writes its own results: the test asserts bit-identical
    # networks across processes (multi-process determinism)
    np.savez(out_path + f".rank{jax.process_index()}",
             pairs=np.array(pairs, dtype=np.float64).reshape(-1, 4),
             stat=stat, pval=pval, df=df, suff=suff,
             fstat=fstat, fpval=fpval,
             X=X, Y=Y, Zs=Zs, kv=kv,
             **{f"net_{k}": v for k, v in nets.items()})
    if jax.process_index() == 0:
        np.savez(out_path,
                 pairs=np.array(pairs, dtype=np.float64).reshape(-1, 4),
                 stat=stat, pval=pval, df=df, suff=suff,
                 fstat=fstat, fpval=fpval,
                 X=X, Y=Y, Zs=Zs, kv=kv)
    # all processes must exit cleanly
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
