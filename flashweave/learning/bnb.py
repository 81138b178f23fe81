"""Experimental branch-and-bound conditioning-set enumeration.

Faithful re-implementation of the reference's BNBIterator (reference:
src/types.jl:271-385, activated by the experimental kwarg ``bnb=true``,
src/hiton.jl:87-98): best-first expansion of conditioning sets driven by
per-level max-priority queues of p-values, with optional branch cutting
(a subset element only spawns deeper branches if its p-value exceeds the
parent's, or the level queue is still near-empty).

The enumeration is inherently sequential, but every FRONTIER (the sibling
extensions of one prefix against the current pool) ships as one batched
device request consumed in order with early exit -- this collapses
O(tests) device round-trips into O(frontiers), with decisions
identical to one-at-a-time enumeration.  The speedup tracks frontier width:
wide candidate pools batch fully; reject-on-first-test frontiers stay
inherently sequential.
Note: for fz_nz the reference's bnb path reads the pre-allocated
(all-zero) correlation matrix because cor_subset! only runs in the non-bnb
test_subsets (src/tests.jl:303-307) -- effectively broken upstream; here the
per-pair masked correlation is computed first, which preserves the documented
BNB semantics while producing meaningful statistics.
"""

from __future__ import annotations

import heapq
import itertools
from typing import List, Sequence, Tuple

import numpy as np

from ..types import TestResult
from .hiton import issig


class _MaxQueue:
    """Max-priority queue over (Z, pval) with dict-like key semantics."""

    def __init__(self):
        self._heap: List[Tuple[float, int, int]] = []
        self._entries = {}
        self._counter = itertools.count()

    def __len__(self):
        return len(self._entries)

    def __setitem__(self, Z: int, pval: float):
        self._entries[Z] = pval
        heapq.heappush(self._heap, (-pval, next(self._counter), Z))

    def keys(self):
        return list(self._entries.keys())

    def pop_max(self) -> Tuple[int, float]:
        while self._heap:
            negp, _, Z = heapq.heappop(self._heap)
            if Z in self._entries and self._entries[Z] == -negp:
                del self._entries[Z]
                return Z, -negp
        raise KeyError("empty queue")


def bnb_test_subsets_gen(T: int, cand: int, Z_total: Sequence[int],
                         cfg, engine, cut_branches: bool = True):
    """Generator evaluating subsets in BNB order; yields single-test device
    requests and returns (test_result, Zs, num_tests) compatible with
    test_subsets (reference: src/tests.jl:349-367)."""
    if not Z_total:
        return TestResult(float("nan"), float("nan"), -1, True), (-1,), -1, float("nan")

    # pre-compute correlation context for continuous modes
    mcor = None
    n_obs = None
    positions = None
    if not cfg.discrete:
        if cfg.nz:
            var_list = [T, cand] + list(Z_total)
            mcor, n_obs = yield ("mcor", (T, cand), var_list)
            positions = {v: i for i, v in enumerate(var_list)}
        else:
            mcor = engine.cor_mat
            n_obs = engine.n
        if cfg.n_obs_min > n_obs:
            return TestResult(0.0, 1.0, 0, False), (), 0, float("nan")

    def eval_pool(Zs_prefix, pool):
        """Evaluate ALL sibling extensions Zs_prefix + (Z,) of the current
        frontier pool as ONE device request.  Results are consumed
        sequentially in pool order with early exit, so decisions and
        num_tests match the one-test-at-a-time enumeration exactly; wasted
        post-exit evaluations are the price of collapsing O(tests) device
        round-trips into O(frontiers)."""
        nb = len(pool)
        kpre = len(Zs_prefix)
        Zarr = np.zeros((nb, cfg.max_k), np.int32)
        if kpre:
            Zarr[:, :kpre] = Zs_prefix
        Zarr[:, kpre] = pool
        kv = np.full(nb, kpre + 1, np.int32)
        if cfg.discrete:
            got = yield ("mi", T, cand, Zarr, kv)
            if len(got) == 5:
                # round-scheduler response defers p-values behind a digest;
                # BNB consumes out of enumeration order, so compute them
                from ..ops import statfuns as sf

                stat, df, nobs, suff, _dig = got
                pval = np.where(suff, sf.mi_pval(stat, df, nobs), 1.0)
            else:
                stat, pval, df, suff = got
        elif not cfg.nz and getattr(engine, "cor_device", False):
            # fz against the device-resident correlation matrix
            stat, pval, df, suff = yield ("fz", T, cand, Zarr, kv)
        else:
            if positions is None:
                pos_X = np.full(nb, T, np.int64)
                pos_Y = np.full(nb, cand, np.int64)
                pos_Z = Zarr.astype(np.int64)
            else:
                pos_X = np.full(nb, positions[T], np.int64)
                pos_Y = np.full(nb, positions[cand], np.int64)
                pos_Z = np.array(
                    [[positions.get(int(v), 0) for v in row] for row in Zarr]
                )
            stat, pval, df, suff = engine.fz_tests_from_cor_raw(
                mcor, pos_X, pos_Y, pos_Z, kv, n_obs)
        return [TestResult(float(stat[j]), float(pval[j]), int(df[j]),
                           bool(suff[j])) for j in range(nb)]

    max_k = min(cfg.max_k, len(Z_total))
    num_tests = 0
    ret = TestResult(1.0, 0.0, 0, True)
    ret_Zs: Tuple[int, ...] = ()

    qs = [_MaxQueue() for _ in range(max_k)]
    i = 1
    Zs: Tuple[int, ...] = ()
    ref_pval = -1.0
    Z_pool = list(Z_total)
    pool_res = None
    pool_idx = 0

    while True:
        if pool_idx >= len(Z_pool):
            # backtrack to a queue with >= 2 entries (reference:
            # src/types.jl:362-368)
            while len(qs[i - 1]) < 2:
                i -= 1
                if i == 0:
                    return ret, ret_Zs, num_tests, float("nan")
            if len(Zs) >= i:
                Zs = Zs[: i - 1]
            Z_ext, pval = qs[i - 1].pop_max()
            Zs = Zs + (Z_ext,)
            ref_pval = pval if cut_branches else -1.0
            i += 1
            Z_pool = qs[i - 2].keys()
            pool_res = None
            pool_idx = 0
            if not Z_pool:
                continue
        if pool_res is None:
            pool_res = yield from eval_pool(Zs, Z_pool)
        Z = Z_pool[pool_idx]
        res = pool_res[pool_idx]
        pool_idx += 1

        Zs_test = Zs + (Z,)
        num_tests += 1
        # queue admission (reference: src/types.jl:309-320)
        if i < max_k and res.suff_power and (
            not cut_branches or res.pval > ref_pval or len(qs[i - 1]) < 2
        ):
            qs[i - 1][Z] = res.pval

        if (not issig(res, cfg.alpha)) or (0 < cfg.max_tests <= num_tests):
            return res, Zs_test, num_tests, float("nan")
        elif res.pval > ret.pval:
            ret = res
            ret_Zs = Zs_test
