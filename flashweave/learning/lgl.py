"""LGL: local-to-global learning driver.

Mirrors the reference's inference driver (reference: src/learning.jl:1-279):
parameter resolution (auto time_limit / n_obs_min heuristics), the univariate
stage, the conditional neighborhood search, and weight assembly into the
final symmetric graph.

Execution modes map the reference's process-parallel options onto the
device round scheduler:
- parallel="single"   : exact sequential reference semantics per target
                        (still device-batched per conditioning chunk)
- parallel="multi_ep" : embarrassingly parallel over target variables
                        (reference: src/learning.jl:141-144): many targets
                        advance per round, device batches sharded over the
                        mesh, but no feed-forward/convergence -- per-target
                        decisions identical to "single"
- parallel="single_il"/"multi_il" : round-based batched scheduler with
                        feed-forward + convergence (learning/scheduler.py);
                        multi_il additionally shards device batches over the
                        jax device mesh.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Dict, Optional

import numpy as np

from ..ops import univariate as uv
from ..ops.condtests import CondTestEngine
from ..types import HitonState, LGLResult
from ..utils.accel import on_accelerator
from ..utils.misc import (
    get_levels,
    get_max_vals,
    is_zero_adjusted,
    isdiscrete,
    make_symmetric_graph,
    make_weights,
    maxweight,
)
from .hiton import HitonConfig
from .scheduler import RoundScheduler

VALID_PARALLEL = ("single", "single_il", "multi_ep", "multi_il")


def _device_levels(data):
    """(data_dev int8, levels, max_vals) sharing ONE int8 table upload with
    the univariate pass and the conditioning engine -- or None when the data
    is not small-non-negative-integer.

    Levels come from a minimum-pass host computation (cast + verify + one
    chunked presence-bitmask pass + int8 column max) instead of the ~9 full
    float passes of the general get_levels, and the device upload starts
    asynchronously in the middle.
    """
    import jax.numpy as jnp

    data = np.asarray(data)
    di8 = data.astype(np.int8)
    if di8.min(initial=0) < 0 or not np.array_equal(di8, data):
        return None
    p = data.shape[1]
    max_vals = di8.max(axis=0, initial=0).astype(np.int32)
    if max_vals.max(initial=0) > 63:
        return None
    data_dev = jnp.asarray(di8)          # async device upload starts here
    mask = np.zeros(p, np.uint64)
    tmp = np.empty((min(256, max(data.shape[0], 1)), p), np.uint64)
    for s in range(0, data.shape[0], 256):
        c = di8[s : s + 256]
        np.left_shift(np.uint64(1), c.astype(np.uint64), out=tmp[: len(c)])
        mask |= np.bitwise_or.reduce(tmp[: len(c)], axis=0)
    levels = np.bitwise_count(mask).astype(np.int32)
    return data_dev, levels, max_vals


def prepare_lgl(data, test_name, time_limit, parallel, feed_forward, max_k,
                n_obs_min, hps, dense_cor, verbose, data_dev_out=None,
                mesh=None):
    """Parameter resolution heuristics (reference: src/learning.jl:1-81)."""
    if time_limit == -1.0:
        if parallel == "multi_il" and max_k > 0:
            time_limit = float(round(math.log2(data.shape[1])))
            if verbose:
                print(f"Setting 'time_limit' to {time_limit} s.")
        else:
            time_limit = 0.0
    if time_limit != 0.0 and not parallel.endswith("_il"):
        warnings.warn("Using time_limit without interleaved parallelism is not advised.")

    levels = max_vals = None
    cor_mat = None
    if isdiscrete(test_name):
        if verbose:
            print("Computing levels")
        dev = None
        # single-device accelerator path only: the sharded paths place
        # their own replicated copies, so the upload here would be pure
        # waste under a mesh
        if on_accelerator() and mesh is None:
            dev = _device_levels(data)
        if dev is not None:
            data_j, levels, max_vals = dev
            if data_dev_out is not None:
                data_dev_out.append(data_j)
        else:
            levels = get_levels(data)
            max_vals = get_max_vals(data)
    # fz conditioning no longer materializes a HOST p x p float64 matrix
    # (80 GB at p=100k): CondTestEngine keeps the correlation matrix
    # device-resident and gathers/recurses on device (the reference's
    # dense_cor option, re-sited; reference src/learning.jl:42-47).  An
    # explicit ``cor_mat`` kwarg still routes through the host path.

    if n_obs_min < 0:
        # reference quirk: `n_obs_min < 0 & is_zero_adjusted(test_name)`
        # parses as `n_obs_min < (0 & ...)` == `n_obs_min < 0`, so the auto
        # threshold applies to ALL tests (reference: src/learning.jl:51-64)
        if isdiscrete(test_name):
            max_level = int(np.max(levels))
            n_strata = min(max_level ** max_k, 8)
            n_obs_min = hps * 2 * 2 * n_strata
        else:
            n_obs_min = 20
        if verbose:
            print(f"Automatically setting 'n_obs_min' to {n_obs_min} for enhanced reliability")

    if n_obs_min > data.shape[0]:
        msg = (
            "Dataset has an insufficient number of observations, need at "
            f"least {n_obs_min} ('n_obs_min') for reliable tests"
        )
        if max_k > 0:
            msg += (". Try using a smaller 'max_k' parameter (at the cost of "
                    "higher numbers of indirect associations).")
        raise ValueError(msg)

    if verbose and is_zero_adjusted(test_name):
        n_unrel = int((np.count_nonzero(np.asarray(data), axis=0) < n_obs_min).sum())
        if n_unrel > 0:
            warnings.warn(
                f"{n_unrel} variables have insufficient observations "
                f"(< {n_obs_min} ('n_obs_min')) and will not be used for "
                "interaction prediction"
            )

    return levels, max_vals, cor_mat, time_limit, n_obs_min


def LGL(
    data,
    test_name: str = "mi",
    max_k: int = 3,
    alpha: float = 0.01,
    hps: int = 5,
    n_obs_min: int = -1,
    max_tests: int = int(10e6),
    convergence_threshold: float = 0.01,
    FDR: bool = True,
    parallel: str = "single",
    fast_elim: bool = True,
    no_red_tests: bool = True,
    weight_type: str = "cond_stat",
    edge_rule: str = "OR",
    verbose: bool = True,
    update_interval: float = 30.0,
    edge_merge_fun=maxweight,
    tmp_folder: str = "",
    debug: int = 0,
    time_limit: float = -1.0,
    header=None,
    meta_variable_mask=None,
    dense_cor: bool = True,
    recursive_pcor: bool = True,
    cache_pcor: bool = False,
    correct_reliable_only: bool = True,
    feed_forward: bool = True,
    track_rejections: bool = False,
    all_univar_nbrs: Optional[Dict] = None,
    tile: Optional[int] = None,
    mesh=None,
    stage_timer=None,
    profile_dir: str = "",
    **kwargs,
) -> LGLResult:
    """Learn a network via local-to-global HITON-PC (reference:
    src/learning.jl:203-279).

    ``cache_pcor`` is accepted for API compatibility but has no effect: the
    batched pcor DP evaluates every recursion node of a test batch in one
    vectorized sweep.  ``dense_cor`` is likewise superseded: with
    ``recursive_pcor`` the correlation matrix is always device-resident in
    the conditioning engine (see learn_network's documented divergences)."""
    if tmp_folder:
        warnings.warn("tmp_folder currently not implemented")
    if edge_rule != "OR":
        warnings.warn(f"edge_rule {edge_rule} not a valid option, setting it to OR")
        edge_rule = "OR"
    if parallel not in VALID_PARALLEL:
        raise ValueError(f"'{parallel}' not a valid parallel mode")

    from ..utils.timing import StageTimer, profiler_trace

    own_timer = stage_timer is None
    timer = StageTimer() if own_timer else stage_timer
    with profiler_trace(profile_dir):
        result = _lgl_timed(
            data, test_name, max_k, alpha, hps, n_obs_min, max_tests,
            convergence_threshold, FDR, parallel, fast_elim, no_red_tests,
            weight_type, edge_rule, verbose, update_interval, edge_merge_fun,
            debug, time_limit, header, dense_cor, recursive_pcor,
            correct_reliable_only, feed_forward, track_rejections,
            all_univar_nbrs, tile, mesh, timer, kwargs,
        )
    if verbose and own_timer:
        print(timer.summary())
    return result


def _lgl_timed(
    data, test_name, max_k, alpha, hps, n_obs_min, max_tests,
    convergence_threshold, FDR, parallel, fast_elim, no_red_tests,
    weight_type, edge_rule, verbose, update_interval, edge_merge_fun,
    debug, time_limit, header, dense_cor, recursive_pcor,
    correct_reliable_only, feed_forward, track_rejections, all_univar_nbrs,
    tile, mesh, timer, kwargs,
) -> LGLResult:
    data = np.asarray(data)
    n, p = data.shape

    # multi-chip: shard over the device mesh (power-of-two device count so
    # batch buckets stay evenly divisible)
    if mesh is None and parallel in ("multi_il", "multi_ep"):
        import jax

        ndev = len(jax.devices())
        if ndev > 1:
            from ..parallel.mesh import get_mesh

            mesh = get_mesh(1 << (ndev.bit_length() - 1))

    with timer.stage("prepare"):
        _dev_out = []
        levels, max_vals, cor_mat, time_limit, n_obs_min = prepare_lgl(
            data, test_name, time_limit, parallel, feed_forward, max_k,
            n_obs_min, hps, dense_cor, verbose, data_dev_out=_dev_out,
            mesh=mesh,
        )
    data_dev = _dev_out[0] if _dev_out else None
    if (data_dev is None and not isdiscrete(test_name) and mesh is None
            and on_accelerator()):
        # one upload serves the univariate sweep and the conditioning engine
        data_dev = uv.put_continuous(np.asarray(data))

    if all_univar_nbrs is None:
        if verbose:
            print("Computing univariate associations")
        with timer.stage("univariate"):
            all_univar_nbrs = uv.pw_univar_neighbors(
                data, test_name=test_name, alpha=alpha, hps=hps,
                n_obs_min=n_obs_min, FDR=FDR, levels=levels,
                max_vals=max_vals, cor_mat=cor_mat,
                correct_reliable_only=correct_reliable_only,
                tile=tile, mesh=mesh, data_dev=data_dev,
            )
        if verbose:
            nbr_nums = [len(v) for v in all_univar_nbrs.values()]
            print("\nUnivariate degree stats:")
            print(f"mean degree {np.mean(nbr_nums):.2f}, max {np.max(nbr_nums)}\n")
            if np.mean(nbr_nums) > p * 0.2:
                warnings.warn(
                    "The univariate network is exceptionally dense, "
                    "computations may be slow."
                )
    # fewest univariate neighbors first (reference: src/learning.jl:97-98)
    target_vars = sorted(all_univar_nbrs.keys(),
                         key=lambda x: len(all_univar_nbrs[x]))

    rej_dict: Dict[int, dict] = {}
    unfinished: Dict[int, HitonState] = {}

    if max_k == 0:
        nbr_dict = all_univar_nbrs
    else:
        if verbose:
            print("\nStarting conditioning search")
        with timer.stage("engine_init"):
            engine = CondTestEngine(
                data, test_name, max_k, levels=levels, max_vals=max_vals,
                cor_mat=cor_mat, hps=hps, n_obs_min=n_obs_min,
                recursive_pcor=recursive_pcor, mesh=mesh, data_dev=data_dev,
            )
        cfg = HitonConfig(
            test_name=test_name, max_k=max_k, alpha=alpha, hps=hps,
            n_obs_min=n_obs_min, max_tests=max_tests, fast_elim=fast_elim,
            no_red_tests=no_red_tests, weight_type=weight_type,
            time_limit=time_limit, track_rejections=track_rejections,
            debug=debug, bnb=bool(kwargs.pop("bnb", False)),
            cut_test_branches=bool(kwargs.pop("cut_test_branches", True)),
        )
        scheduler = RoundScheduler(
            engine, cfg, target_vars, all_univar_nbrs,
            feed_forward=(feed_forward and parallel.endswith("_il")),
            convergence_threshold=(
                convergence_threshold if parallel.endswith("_il") else 0.0
            ),
            update_interval=update_interval, verbose=verbose,
            sequential=(parallel in ("single", "single_il")),
        )
        with timer.stage("conditional"):
            nbr_states = scheduler.run()
        nbr_dict = {T: st.state_results for T, st in nbr_states.items()}
        if time_limit != 0.0 or convergence_threshold != 0.0:
            for T, st in nbr_states.items():
                if st.unchecked_vars:
                    unfinished[T] = st
        if track_rejections:
            for T, st in nbr_states.items():
                if st.state_rejections:
                    rej_dict[T] = st.state_rejections

    if verbose:
        print("\nPostprocessing")
    with timer.stage("postprocess"):
        if edge_merge_fun is maxweight and edge_rule == "OR":
            from ..utils.misc import assemble_graph_bulk

            graph = assemble_graph_bulk(
                nbr_dict, all_univar_nbrs, weight_type, test_name,
                max_var=p, header=header,
            )
        else:
            weights_dict = {
                T: make_weights(nbr_dict[T], all_univar_nbrs[T], weight_type,
                                test_name)
                for T in nbr_dict
            }
            graph = make_symmetric_graph(
                weights_dict, edge_rule, edge_merge_fun=edge_merge_fun,
                max_var=p, header=header,
            )
    if verbose:
        print("Complete")
    return LGLResult(graph, rej_dict, unfinished)
