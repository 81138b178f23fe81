"""Semi-interleaved HITON-PC per-variable neighborhood search.

Faithful host-side re-expression of the reference's search control flow
(reference: src/hiton.jl): interleaving phase (univar-p-sorted candidates
admitted one at a time against the growing accepted set), elimination phase
(each accepted variable re-tested against the others), whitelist/blacklist
short-circuits, time-limit checkpointing into resumable HitonStates, and the
fast_elim / no_red_tests heuristics.

Batched divergence: the search logic is a Python GENERATOR per target
variable that yields fixed-shape batched test requests; a scheduler
(learning/scheduler.py) advances many targets per round and dispatches their
requests as single device batches (ops/condtests.py).  The per-pair
early-exit subset loop (reference src/tests.jl:281-346) becomes "evaluate a
chunk of subsets in one batch, then scan host-side in enumeration order" --
identical accept/reject decisions and reported statistics, with wasted
subset evaluations traded for batched device throughput.
"""

from __future__ import annotations

import itertools
import math
import warnings
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..types import HitonState, NbrStatDict, PSortedNbrs, RejDict, TestResult

# subsets evaluated per device round for one (target, candidate) pair
SUBSET_CHUNK = 1024

NAN = float("nan")


def issig(res: TestResult, alpha: float) -> bool:
    # reference: src/tests.jl:1-3 (NaN pval compares False)
    return res.pval < alpha and res.suff_power


@dataclass
class HitonConfig:
    test_name: str
    max_k: int = 3
    alpha: float = 0.01
    hps: int = 5
    n_obs_min: int = 0
    max_tests: int = int(10e6)
    fast_elim: bool = True
    no_red_tests: bool = True
    weight_type: str = "cond_stat"
    time_limit: float = 0.0
    track_rejections: bool = False
    debug: int = 0
    # experimental branch-and-bound enumeration (reference: src/hiton.jl:87-98)
    bnb: bool = False
    cut_test_branches: bool = True

    @property
    def discrete(self) -> bool:
        return self.test_name.startswith("mi")

    @property
    def nz(self) -> bool:
        return self.test_name.endswith("_nz")


class SearchControl:
    """Shared convergence signal.  In the reference, global convergence NEVER
    interrupts a running job: it only freezes jobs that checkpoint at their
    per-job time limit and come back to the master for requeueing
    (src/interleaved.jl:119-124 marks only non-'F'/'C' *results* as 'C';
    fresh jobs from the waiting stack always run a full pass).  The flag is
    therefore consulted exclusively at time-limit checkpoints.

    ``now_fn`` is the clock every JobClock reads.  Default: wall time.  The
    multi-process scheduler replaces it with a rank-0-broadcast value that
    updates once per round, so every time-limit checkpoint decision is
    IDENTICAL on every process (a divergent decision would fork the
    processes' shard_map request streams and desync the collectives)."""

    def __init__(self):
        import time as _time

        self.converged = False
        self.now_fn = _time.time
        # adaptive full-target speculation: when mispredicts (which rerun
        # the standard path from scratch) exceed ~40% of attempts, stop
        # speculating for the rest of the run.  Counter-based, so the
        # decision is deterministic and identical on every process.
        self.turbo_attempts = 0
        self.turbo_fallbacks = 0

    def turbo_worthwhile(self) -> bool:
        a = self.turbo_attempts
        return a < 256 or 5 * self.turbo_fallbacks <= 2 * a


class JobClock:
    """Per-job time-limit clock.  The reference restarts the clock on every
    (re)entry into si_HITON_PC (src/hiton.jl:305 sets start_time per call, and
    checkpointed jobs are requeued and re-enter with a fresh clock), so a
    checkpoint that is immediately resumed is equivalent to resetting the
    timer and continuing."""

    def __init__(self, time_limit: float, now_fn=None):
        import time as _time

        self._now = now_fn or _time.time
        self.time_limit = time_limit
        self.start = self._now() if time_limit > 0.0 else 0.0

    def expired(self) -> bool:
        return (self.time_limit > 0.0
                and self._now() - self.start > self.time_limit)

    def reset(self) -> None:
        if self.time_limit > 0.0:
            self.start = self._now()


def _empty_state(phase="F") -> HitonState:
    return HitonState(phase, {}, {}, [], {})


# ---------------------------------------------------------------------------
# subset enumeration + early-exit scan (reference: src/tests.jl:281-346)
# ---------------------------------------------------------------------------

# cached position templates keyed by (len(Z_total), max_k): most candidates
# have small accepted sets, so one cached fancy-index replaces per-candidate
# itertools enumeration (the per-send numpy bookkeeping dominated large runs)
_combo_cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]] = {}


def _combo_template(a: int, max_k: int) -> Tuple[np.ndarray, np.ndarray]:
    """All subsets of range(a) in the reference's enumeration order -- sizes
    max_k..1 descending, lexicographic within a size (src/tests.jl:311-316).
    Returns (pos (B_total, max_k) int32 zero-padded, kvec (B_total,) int32)."""
    tpl = _combo_cache.get((a, max_k))
    if tpl is None:
        pos_parts, k_parts = [], []
        for k in range(min(max_k, a), 0, -1):
            nc = math.comb(a, k)
            block = np.zeros((nc, max_k), np.int32)
            block[:, :k] = np.fromiter(
                itertools.chain.from_iterable(
                    itertools.combinations(range(a), k)),
                np.int32, count=nc * k,
            ).reshape(nc, k)
            pos_parts.append(block)
            k_parts.append(np.full(nc, k, np.int32))
        tpl = (np.concatenate(pos_parts), np.concatenate(k_parts))
        _combo_cache[(a, max_k)] = tpl
    return tpl


_subset_total_cache: Dict[Tuple[int, int], int] = {}


def _subset_total(a: int, max_k: int) -> int:
    t = _subset_total_cache.get((a, max_k))
    if t is None:
        t = sum(math.comb(a, k) for k in range(1, min(max_k, a) + 1))
        _subset_total_cache[(a, max_k)] = t
    return t


def _materialize_lowest(low_m, low_ref):
    """Resolve the deferred weakest-significant reference into a TestResult.

    Two layouts: the digest fast path stores the p-value directly (the
    scheduler computed it on the early-exit prefix); the fallback scan stores
    the full p-value array."""
    if low_ref is None:
        return TestResult(0.0, 0.0, 0, True), ()
    if low_ref[0] is None:
        _, pv, stat_a, df_a, suff_a, Zarr, kvec, i = low_ref
        return (
            TestResult(stat_a.item(i), pv, int(df_a.item(i)),
                       bool(suff_a.item(i))),
            tuple(Zarr[i, : kvec.item(i)].tolist()),
        )
    stat_a, pval_a, df_a, suff_a, Zarr, kvec, i = low_ref
    return (
        TestResult(stat_a.item(i), pval_a.item(i), int(df_a.item(i)),
                   bool(suff_a.item(i))),
        tuple(Zarr[i, : kvec.item(i)].tolist()),
    )


def _combo_chunks(a: int, max_k: int):
    """Yield (pos, kvec) chunks covering all subsets in enumeration order.

    Small candidate sets (the overwhelmingly common case) come from the
    template cache as ONE chunk, so a candidate costs a single device round;
    large sets are enumerated lazily in SUBSET_CHUNK slices so early-exit
    still bounds the work and nothing huge is materialized."""
    total = _subset_total(a, max_k)
    if total <= SUBSET_CHUNK:
        yield _combo_template(a, max_k)
        return
    for k in range(min(max_k, a), 0, -1):
        it = itertools.combinations(range(a), k)
        while True:
            block = list(itertools.islice(it, SUBSET_CHUNK))
            if not block:
                break
            nc = len(block)
            pos = np.zeros((nc, max_k), np.int32)
            pos[:, :k] = np.fromiter(
                itertools.chain.from_iterable(block), np.int32, count=nc * k,
            ).reshape(nc, k)
            yield pos, np.full(nc, k, np.int32)


class _ChunkScan:
    """Host-side early-exit / weakest-significant bookkeeping over evaluated
    subset chunks -- the response-processing half of the subset search,
    shared by the chunked generator path and the speculative-window consumer
    (semantics of the reference's sequential loop, src/tests.jl:311-343)."""

    __slots__ = ("cfg", "T", "cand", "total", "num_tests", "low_m", "low_ref")

    def __init__(self, cfg: HitonConfig, T: int, cand: int, a: int):
        self.cfg = cfg
        self.T = T
        self.cand = cand
        self.total = _subset_total(a, cfg.max_k)
        self.num_tests = 0
        self.low_m = 0.0
        self.low_ref = None

    def consume(self, got, Zarr, kvec):
        """Scan one evaluated chunk in enumeration order.  ``got`` is either
        the scheduler 5-tuple (stat, df, n_obs, suff, digest) or a plain
        (stat, pval, df, suff).  Returns the (res, Zs) exit pair if the
        candidate's decision is final, else None."""
        cfg = self.cfg
        digest = None
        nobs_a = None
        pval_a = None
        if len(got) == 5:
            stat_a, df_a, nobs_a, suff_a, digest = got
        else:
            stat_a, pval_a, df_a, suff_a = got
        B = len(kvec)

        # fast path: the scheduler precomputed this request's early-exit /
        # weakest digest (same float64 semantics, one vectorized pass over
        # the whole mega-batch); only a possible max_tests cutoff inside
        # this chunk forces the local scan
        if digest is not None and not (
            0 < cfg.max_tests <= self.num_tests + B
        ):
            e, w, maxp, exit_pv = digest
            if w >= 0:
                m = float(maxp)
                if m >= self.low_m or math.isnan(self.low_m):
                    self.low_m = m
                    self.low_ref = (None, m, stat_a, df_a, suff_a, Zarr,
                                    kvec, w)
            if e >= 0:
                self.num_tests += e + 1
                res = TestResult(stat_a.item(e), float(exit_pv),
                                 int(df_a.item(e)), bool(suff_a.item(e)))
                return res, tuple(Zarr[e, : kvec.item(e)].tolist())
            self.num_tests += B
            return None
        if pval_a is None:
            # digest skipped (max_tests budget falls inside this chunk, or a
            # non-digest dispatcher): full p-value semantics of
            # condtests.mi_tests_finish, computed consumer-side
            from ..ops import statfuns as sf

            pval_a = np.where(suff_a, sf.mi_pval(stat_a, df_a, nobs_a), 1.0)

        # vectorized early-exit scan in enumeration order; NaN pvals compare
        # False like the reference's issig (src/tests.jl:1-3)
        sig = (pval_a < cfg.alpha) & suff_a
        exit_flags = ~sig
        if cfg.max_tests > 0:
            exit_flags |= (self.num_tests + 1 + np.arange(B)) >= cfg.max_tests

        def upd_lowest(upto):
            if upto == 0:
                return
            # argmax over the reversed view finds the LAST max occurrence --
            # one numpy call resolves both the max and the reference's
            # sequential >= tie-break (NaNs propagate to m and compare False,
            # exactly like the running max)
            i = upto - 1 - int(np.argmax(pval_a[upto - 1 :: -1]))
            m = float(pval_a[i])
            if m >= self.low_m or math.isnan(self.low_m):
                self.low_m = m
                self.low_ref = (stat_a, pval_a, df_a, suff_a, Zarr, kvec, i)

        if exit_flags.any():
            e = int(np.argmax(exit_flags))
            upd_lowest(e)
            self.num_tests += e + 1
            res = TestResult(stat_a.item(e), pval_a.item(e),
                             int(df_a.item(e)), bool(suff_a.item(e)))
            if 0 < cfg.max_tests <= self.num_tests:
                frac = self.num_tests / self.total
                warnings.warn(
                    f"Maximum number of tests for variable pair {self.T} / "
                    f"{self.cand} at {self.num_tests} out of {self.total} "
                    f"tests (fraction: {round(frac, 3)})."
                )
            return res, tuple(Zarr[e, : kvec.item(e)].tolist())
        upd_lowest(B)
        self.num_tests += B
        return None

    def finish(self):
        lowest, lowest_Zs = _materialize_lowest(self.low_m, self.low_ref)
        return lowest, lowest_Zs, self.num_tests, self.num_tests / self.total


def _fznz_subset_stats(engine, pos, Zarr, kvec, mcor, mcor_nobs,
                       nz_positions):
    """Partial-correlation stats of one subset chunk from a (masked)
    correlation matrix (reference: src/tests.jl:293-307 + pcor recursion)."""
    B = len(kvec)
    if nz_positions:
        # mcor is over [T, cand, Z_total...]: position of Z_total[i] is
        # i + 2, so the position template maps directly
        pos_X = np.zeros(B, np.int64)
        pos_Y = np.ones(B, np.int64)
        pos_Z = (pos + 2).astype(np.int64)
    else:
        raise AssertionError("global-cor path uses engine positions")
    return engine.fz_tests_from_cor_raw(mcor, pos_X, pos_Y, pos_Z, kvec,
                                        mcor_nobs)


def test_subsets_gen(T: int, cand: int, Z_total: Sequence[int],
                     cfg: HitonConfig, engine):
    """Generator evaluating conditioning subsets of Z_total, largest first,
    early-exiting on the first non-significant result.

    Yields batched device requests ("mi", T, cand, Zarr, kvec) -- all subset
    sizes of a small candidate set ship as ONE request (wasted post-exit
    evaluations traded for one scheduler round per candidate); the host-side
    scan in enumeration order keeps accept/reject decisions and reported
    statistics identical to the reference's sequential loop.  Returns
    (test_result, lowest_sig_Zs, num_tests, frac_tests)."""
    if not Z_total:
        return TestResult(NAN, NAN, -1, True), (-1,), -1, NAN

    mcor = None
    mcor_nobs = None
    nz_positions = False
    if not cfg.discrete:
        if cfg.nz:
            # per-pair masked correlations over [X, Y, Z_total...]
            # (reference: src/tests.jl:293-307 cor_subset!)
            if engine.recursive_pcor:
                var_list = [T, cand] + list(Z_total)
                mcor, mcor_nobs = yield ("mcor", (T, cand), var_list)
                nz_positions = True
            else:
                mcor_nobs = engine.nz_pair_count(T, cand)
            if cfg.n_obs_min > mcor_nobs:
                return TestResult(0.0, 1.0, 0, False), (), 0, 0.0
        elif not getattr(engine, "cor_device", False):
            mcor = engine.cor_mat
            mcor_nobs = engine.n

    a = len(Z_total)
    max_k = cfg.max_k
    Z_np = np.asarray(Z_total, dtype=np.int32)
    scan = _ChunkScan(cfg, T, cand, a)

    for pos, kvec in _combo_chunks(a, max_k):
        B = len(kvec)
        Zarr = Z_np[pos]  # padded pos 0 -> a real column; kvec masks it
        if cfg.discrete:
            got = yield ("mi", T, cand, Zarr, kvec)
        elif not engine.recursive_pcor:
            subsets = [tuple(Zarr[i, :kvec[i]]) for i in range(B)]
            results = engine.fz_tests_iterative(T, cand, subsets)
            got = (np.array([r.stat for r in results]),
                   np.array([r.pval for r in results]),
                   np.array([r.df for r in results], dtype=np.int64),
                   np.array([r.suff_power for r in results]))
        elif nz_positions:
            got = _fznz_subset_stats(engine, pos, Zarr, kvec, mcor,
                                     mcor_nobs, nz_positions)
        elif getattr(engine, "cor_device", False):
            got = yield ("fz", T, cand, Zarr, kvec)
        else:
            pos_X = np.full(B, T, np.int64)
            pos_Y = np.full(B, cand, np.int64)
            got = engine.fz_tests_from_cor_raw(
                mcor, pos_X, pos_Y, Zarr.astype(np.int64), kvec, mcor_nobs
            )
        hit = scan.consume(got, Zarr, kvec)
        if hit is not None:
            res, Zs = hit
            return res, Zs, scan.num_tests, scan.num_tests / scan.total

    return scan.finish()


# ---------------------------------------------------------------------------
# phase backend (reference: src/hiton.jl:109-149)
# ---------------------------------------------------------------------------

# max candidates whose subset batches ride one speculative window
SPEC_WINDOW_MAX = 32
# shared reject-chain windows (one template, vectorized consume) can grow
# much deeper: a mispredicted tail costs only already-dispatched device
# tests, no per-candidate host work
SPEC_SHARED_MAX = 256

# diagnostics: set to a dict to count windows by kind (shared/erot/chain/legacy)
WINDOW_STATS = None


def fast_mode(cfg: HitonConfig) -> bool:
    """True when per-candidate results can be consumed as bare decisions
    (exit index + weakest stat/pval): nothing to record for rejections, no
    debug tracing, and the max_tests budget can't cut a window chunk.  The
    scheduler ships minimal per-candidate digests in this mode (computed on
    device on the accelerator path); the generator's superfast consume reads
    them directly."""
    return (not cfg.track_rejections and cfg.debug == 0
            and (cfg.max_tests <= 0 or cfg.max_tests > SUBSET_CHUNK))


def _decide(cfg: HitonConfig, phase: str, cand: int, res, lowest_Zs,
            num_tests, frac, accepted, accepted_dict, support_dict,
            rej_dict) -> None:
    """update_sig_result! (reference: src/hiton.jl:53-78)."""
    if not accepted:
        accepted.append(cand)
        accepted_dict[cand] = support_dict[cand]
    elif issig(res, cfg.alpha):
        accepted.append(cand)
        accepted_dict[cand] = (res.stat, res.pval)
        if cfg.debug > 0:
            print(f"\taccepted: {res}")
    else:
        if cfg.debug > 0:
            print(f"\trejected: {res} through Z {lowest_Zs}")
        if phase == "E" and not cfg.fast_elim:
            accepted.append(cand)
        if cfg.track_rejections:
            rej_dict[cand] = (lowest_Zs, res, (num_tests, frac))


def phase_backend(T: int, candidates: List[int], cfg: HitonConfig, engine,
                  phase: str,
                  prev_accepted_dict: Optional[NbrStatDict],
                  candidates_unchecked: List[int],
                  support_dict: NbrStatDict,
                  whitelist, blacklist: Set[int],
                  rej_dict: RejDict,
                  control: SearchControl, clock: JobClock):
    """One HITON phase ('I' interleaving / 'E' elimination).  Returns
    (accepted_dict, candidates_unchecked).

    Batched divergence (exact semantics preserved): candidates are
    processed through SPECULATIVE WINDOWS -- the next w candidates' whole
    subset batches are built against the CURRENT accepted set and dispatched
    as one device round; responses are consumed strictly in candidate order,
    and any result whose build-time conditioning list no longer equals the
    live one (the set mutated: an accept in 'I', any tested candidate in 'E'
    where remove/re-append reorders the list) is DISCARDED and rebuilt next
    round.  Because rejections -- the common case -- never mutate the set,
    most windows consume fully: host generator round-trips and device
    dispatches shrink ~w-fold while every accept/reject decision, reported
    statistic, and num_tests count stays identical to the sequential loop
    (reference: src/hiton.jl:126-147).

    Whitelist semantics (UNIFIED, round 5): membership is SNAPSHOTTED when a
    window is built and every consume of that window reads the snapshot --
    the same semantic as the turbo full-target window and the reference's
    job-start skip_nbrs snapshot (reference: src/interleaved.jl:124-131).  A
    neighbor fed forward between a window's build and its consume is NOT
    whitelisted for that window (it is for the next); the OR-rule graph
    merge keeps the edge either way, exactly as in the reference."""
    if prev_accepted_dict:
        accepted_dict = prev_accepted_dict
        candidates = list(candidates_unchecked)
    else:
        accepted_dict = {}

    accepted: List[int] = list(candidates) if phase == "E" else []
    discrete = cfg.discrete
    nz = cfg.nz
    fz_dev = (not discrete and not nz
              and getattr(engine, "cor_device", False))
    spec_able = (not cfg.bnb) and (
        discrete or fz_dev
        or (nz and engine.recursive_pcor and not discrete)
    )
    check_clock = cfg.time_limit > 0.0
    debug = cfg.debug
    max_k = cfg.max_k
    n_c = len(candidates)
    # initial speculation depth: the E phase re-tests already-accepted
    # neighbors, which overwhelmingly pass -- cover the whole phase in one
    # rotational window; the I phase's strongest-first prefix is mostly
    # accepts too, so start moderately deep instead of at 2
    spec = n_c if phase == "E" else 4
    ci = 0
    last_accept = True   # univar-strength-sorted: accept runs come first
    # fz_nz rides the same fast digest machinery since round 5: the
    # dispatcher digests a whole round's masked-cor windows in vectorized
    # float64 passes (scheduler._digest_from_pvals), so per-candidate host
    # consume work disappears for the continuous modes too
    fznz_dev = nz and not discrete and engine.recursive_pcor
    fast = fast_mode(cfg) and (discrete or fz_dev or fznz_dev)
    # fz past the p x p wall routes through the continuous var-list windows
    # (per-candidate on-the-fly correlations + round/device digests)
    # instead of per-test submatrix Grams
    fz_gather = fz_dev and not (getattr(engine, "cor_onfly", False)
                                and fast)
    cont_win = fznz_dev or (fz_dev and not fz_gather)
    cache_a = -1         # shared-template cache: valid while len(accepted)
    cache = None         # is unchanged ('I' only ever appends)
    while ci < n_c:
        window = min(spec, n_c - ci) if spec_able else 1
        # whitelist SNAPSHOT at window build (the single unified semantic,
        # see docstring); every consume path below reads wl_snap only
        wl_snap = (whitelist.live_set()
                   if hasattr(whitelist, "live_set") else whitelist)
        wl_snap = set(wl_snap) if wl_snap else ()
        # -- build: CHAINED speculation.  Each window assumes the last
        #    observed outcome keeps repeating along the window:
        #      reject-chain ('I'): all candidates share the unchanged set
        #                          (one combo template serves the window)
        #      accept-chain ('I'): candidate k conditioned on set + priors
        #      accept-chain ('E'): the remove/re-append rotation
        #      reject-chain ('E'): the set shrinking by each prior (fast_elim)
        #    Blacklist membership is static (checked at build); whitelist
        #    membership is the build-time snapshot ------------------------
        mode_accept = last_accept or (phase == "E" and not cfg.fast_elim)
        cands_w: List[int] = []        # candidates with device requests
        varlists_w: List[List[int]] = []
        items = []                     # (cand, Zs_build | None, has_req, legacy)
        Zarr_parts, kvec_parts = [], []
        shared = False
        erot = False
        ichain = False
        if (spec_able and (discrete or not nz or fast) and phase == "I"
                and not mode_accept and accepted
                and _subset_total(len(accepted), max_k) <= SUBSET_CHUNK):
            # one conditioning template serves the window: valid for plain
            # tests AND for discrete nz (mi_nz), whose per-candidate row
            # masking happens on device from the request's own (X, Y)
            # columns; fz_nz additionally attaches per-candidate mcor
            # var-lists [T, cand] + Zs (the positions template is shared).
            # reject-chain interleaving: every candidate in the window
            # shares the SAME conditioning set -- one template serves all,
            # cached across consecutive reject-windows of this target
            shared = True
            if cache_a != len(accepted):
                Zs_shared = list(accepted)
                pos, kvec = _combo_template(len(Zs_shared), max_k)
                Zarr = np.asarray(Zs_shared, np.int32)[pos]
                cache_a = len(accepted)
                cache = (Zs_shared, pos, kvec, Zarr)
            else:
                Zs_shared, pos, kvec, Zarr = cache
            if fast and not blacklist:
                # plain shared window: no per-candidate bookkeeping at all
                cands_w = candidates[ci : ci + window]
                items = None
            else:
                for cand in candidates[ci : ci + window]:
                    if blacklist and cand in blacklist:
                        items.append((cand, None, False, False))
                    else:
                        items.append((cand, Zs_shared, True, False))
                        cands_w.append(cand)
            if cont_win or (nz and not discrete):
                varlists_w = [[T, c] + Zs_shared for c in cands_w]
        elif (spec_able and fast and phase == "E" and mode_accept
              and not blacklist and len(accepted) >= 2
              and _subset_total(len(accepted) - 1, max_k) <= SUBSET_CHUNK
              and accepted[: min(window, n_c - ci)]
                  == candidates[ci : ci + min(window, n_c - ci)]):
            # rotational shared-E window: under the all-accept assumption the
            # E phase's remove/re-append rotation makes candidate k's
            # conditioning list the k-step CYCLIC rotation of the current
            # accepted list minus itself -- the whole window's subset arrays
            # come from ONE fancy-index instead of per-candidate chain
            # builds.  Guard: the unprocessed candidates must still be the
            # prefix of the rotated accepted list (always true unless a
            # whitelist hit appended a duplicate).
            erot = True
            W = min(window, n_c - ci)
            if not discrete:
                # continuous windows pay a per-candidate correlation; an
                # elimination mispredict discards the rest of the window,
                # so whole-phase rotations exploded dispatched work 2.5x
                # on elimination-heavy fz_nz data (measured p=65k) --
                # cap accept-assumption windows at the conservative depth
                W = min(W, SPEC_WINDOW_MAX)
            cands_w = candidates[ci : ci + W]
            items = None
            a = len(accepted)
            acc_np = np.asarray(accepted, np.int32)
            rot = acc_np[(1 + np.arange(a - 1, dtype=np.int64)[None, :]
                          + np.arange(W, dtype=np.int64)[:, None]) % a]
            pos, kvec_t = _combo_template(a - 1, max_k)
            if discrete or fz_gather:
                Zarr_e = rot[:, pos].reshape(-1, max_k)
                kvec_e = np.tile(kvec_t, W)
                counts_e = np.full(W, len(kvec_t), np.int64)
            else:
                # fz_nz: the positions template is shared; each candidate
                # carries its own rotated mcor var-list
                varlists_w = [[T, c] + rot[j].tolist()
                              for j, c in enumerate(cands_w)]
        elif (spec_able and fast and phase == "I" and mode_accept
              and not blacklist and accepted
              and _subset_total(len(accepted) + min(window, SPEC_WINDOW_MAX,
                                                    n_c - ci) - 1, max_k)
                  <= SUBSET_CHUNK):
            # vectorized I-phase accept-chain: candidate k's conditioning
            # list under the all-accept assumption is accepted + priors, so
            # one cached index template over [accepted + cands_w] builds the
            # whole window.  Whitelist hits act exactly like accepts (same
            # append), so only a test REJECTION ends the window.
            ichain = True
            a0 = len(accepted)
            W = min(window, SPEC_WINDOW_MAX, n_c - ci)
            cands_w = candidates[ci : ci + W]
            items = None
            IDX, kvec_e, counts_e = _ichain_template(a0, W, max_k)
            vm = np.asarray(accepted + cands_w, np.int32)
            if discrete or fz_gather:
                Zarr_e = vm[IDX]
            else:
                # fz_nz: candidate k's mcor var-list is [T, c_k] + the
                # all-accept prefix; IDX already indexes that prefix
                vml = vm.tolist()
                varlists_w = [[T, c] + vml[: a0 + k]
                              for k, c in enumerate(cands_w)]
        else:
            # accept-chain / E-phase builds pay per-candidate host work and
            # mispredict at the first outcome flip -- cap them at the
            # conservative window even when shared-window spec has grown deep
            chain = list(accepted)
            for cand in candidates[ci : ci + min(window, SPEC_WINDOW_MAX)]:
                if blacklist and cand in blacklist:
                    items.append((cand, None, False, False))
                    continue
                Zs = ([a for a in chain if a != cand] if phase == "E"
                      else list(chain))
                a = len(Zs)
                if a == 0:
                    # empty conditioning set auto-accepts DETERMINISTICALLY
                    # (reference: src/hiton.jl:57-59) -- not speculation
                    items.append((cand, Zs, False, False))
                    chain = Zs + [cand]
                    continue
                if not spec_able or _subset_total(a, max_k) > SUBSET_CHUNK:
                    # oversized subset space (or bnb / plain-fz): chunked
                    # generator path, alone in its window
                    if not items:
                        items.append((cand, Zs, False, True))
                    break
                pos, kvec = _combo_template(a, max_k)
                if discrete or fz_gather:
                    Zarr_parts.append(np.asarray(Zs, np.int32)[pos])
                elif fast:
                    Zarr_parts.append(pos)    # continuous digest: POSITIONS
                kvec_parts.append(kvec)
                items.append((cand, Zs, True, False))
                cands_w.append(cand)
                if cont_win or (nz and not discrete):
                    varlists_w.append([T, cand] + Zs)
                if mode_accept:
                    chain = Zs + [cand]
                elif phase == "E":
                    chain = Zs          # assumed fast_elim reject

        if WINDOW_STATS is not None:
            k = ("shared" if shared else "erot" if erot
                 else "ichain" if ichain
                 else "legacy" if (items and items[0][3]) else "chain")
            WINDOW_STATS[k] = WINDOW_STATS.get(k, 0) + 1
            WINDOW_STATS[k + "_cands"] = (WINDOW_STATS.get(k + "_cands", 0)
                                          + (len(cands_w) if cands_w else 1))
        got = None
        if cands_w:
            if erot or ichain:
                if discrete or fz_gather:
                    kind = "miwin" if discrete else "fzwin"
                    req = (kind, T, cands_w, Zarr_e, kvec_e, counts_e,
                           False)
                elif erot:
                    # fz_nz rotational-E: ONE shared positions template
                    req = ("mcorwin", T, cands_w, varlists_w, pos, kvec_t,
                           None)
                else:
                    req = ("mcorwin", T, cands_w, varlists_w, IDX, kvec_e,
                           counts_e)
            elif discrete or fz_gather:
                kind = "miwin" if discrete else "fzwin"
                if shared:
                    req = (kind, T, cands_w, Zarr, kvec,
                           np.full(len(cands_w), len(kvec), np.int64), True)
                else:
                    counts = np.fromiter((len(k) for k in kvec_parts),
                                         np.int64, count=len(kvec_parts))
                    req = (kind, T, cands_w,
                           np.concatenate(Zarr_parts),
                           np.concatenate(kvec_parts), counts, False)
            elif fast:
                # fz_nz fast windows: POSITIONS templates + per-candidate
                # mcor var-lists; the dispatcher returns per-candidate
                # digests (exit, weakest) computed in vectorized float64
                # (scheduler._finish_fz_mcor / _digest_from_pvals)
                if shared:
                    req = ("mcorwin", T, cands_w, varlists_w, pos, kvec,
                           None)
                else:
                    counts = np.fromiter((len(k) for k in kvec_parts),
                                         np.int64, count=len(kvec_parts))
                    req = ("mcorwin", T, cands_w, varlists_w,
                           np.concatenate(Zarr_parts),
                           np.concatenate(kvec_parts), counts)
            else:
                req = ("mcorwin", T, [(T, c) for c in cands_w], varlists_w)
            got = yield req

        # -- superfast consume: discrete window with nothing to record for
        #    rejected candidates.  The scheduler digest already IS the
        #    decision (exit_e >= 0 <=> a non-significant subset was found
        #    <=> rejected; exit_e == -1 <=> every subset significant <=>
        #    accepted with the weakest result) -- rejected candidates cost
        #    no per-candidate host work at all.  Validity per candidate:
        #    its build-time conditioning list must equal the live one ------
        if ichain:
            # accept-chain consume: accepts (test or whitelist) extend the
            # set exactly as speculated; the first test REJECTION ends the
            # window (the set stops growing, so the remaining speculative
            # conditioning lists are stale)
            exit_e, wstat, wpval = got
            W = len(cands_w)
            consumed = 0
            wasted = False
            for j, cand in enumerate(cands_w):
                if cand in wl_snap:
                    accepted.append(cand)
                    accepted_dict[cand] = (NAN, NAN)
                elif int(exit_e[j]) < 0:
                    accepted.append(cand)
                    accepted_dict[cand] = (float(wstat[j]), float(wpval[j]))
                else:
                    last_accept = False
                    consumed = j + 1
                    wasted = j + 1 < W
                    break
            else:
                last_accept = True
                consumed = W
            ci += consumed
            if check_clock and clock.expired() and ci < n_c:
                if control.converged:
                    return accepted_dict, candidates[ci:]
                clock.reset()
            spec = (max(2, spec // 2) if wasted
                    else min(SPEC_SHARED_MAX, spec * 4))
            continue

        if erot:
            # rotational-E consume: accepts keep the rotation deterministic,
            # so the only mispredict points are a fast_elim elimination or a
            # whitelist hit (which appends a duplicate, existing semantics).
            # Rejections with fast_elim=False re-append -- the same rotation
            # as an accept -- so those windows consume fully.
            exit_e, wstat, wpval = got
            W = len(cands_w)
            ex = np.asarray(exit_e[:W])
            stop = W
            stop_kind = None
            if cfg.fast_elim:
                rej = np.nonzero(ex >= 0)[0]
                if rej.size:
                    stop = int(rej[0])
                    stop_kind = "rej"
            if wl_snap:
                for j, cand in enumerate(
                        cands_w[: stop + 1] if stop < W else cands_w):
                    if cand in wl_snap:
                        if j <= stop:
                            stop = j
                            stop_kind = "wl"
                        break
            m = stop if stop < W else W
            for j in range(m):
                if ex[j] < 0:
                    accepted_dict[cands_w[j]] = (float(wstat[j]),
                                                 float(wpval[j]))
                # ex[j] >= 0 here only with fast_elim=False: rejected, the
                # re-append keeps the rotation -- nothing recorded
            accepted = accepted[m:] + accepted[:m]
            ci += m
            if stop_kind == "rej":
                accepted = accepted[1:]     # eliminate the rejected member
                ci += 1
                last_accept = False
                wasted = m + 1 < W
            elif stop_kind == "wl":
                cand = cands_w[m]
                accepted.append(cand)       # duplicate append (existing
                accepted_dict[cand] = (NAN, NAN)   # whitelist semantics)
                ci += 1
                last_accept = True
                wasted = m + 1 < W
            else:
                last_accept = True
                wasted = False
            if check_clock and clock.expired() and ci < n_c:
                if control.converged:
                    return accepted_dict, candidates[ci:]
                clock.reset()
            spec = (max(2, spec // 2) if wasted
                    else min(SPEC_SHARED_MAX, spec * 4))
            continue

        if fast and cands_w and items is None:
            # plain shared-I consume, VECTORIZED: within this window the
            # accepted list can only mutate through an accept (exit -1) or a
            # whitelist hit, and the first mutation ends the window -- so
            # the whole decision is "find the first accepting position".
            # Semantics identical to the former per-candidate scan; the
            # per-candidate time-limit check coarsens to once per window
            # (checkpoint boundaries shift by <= one window; wall-clock
            # checkpoints are inherently timing-dependent).
            exit_e, wstat, wpval = got
            nw = len(cands_w)
            acc = np.asarray(exit_e[:nw]) < 0
            p_exit = int(np.argmax(acc)) if acc.any() else nw
            p_wl = nw
            if wl_snap:
                for j, cand in enumerate(cands_w[:p_exit + 1]):
                    if cand in wl_snap:
                        p_wl = j
                        break
            p_acc = min(p_exit, p_wl)
            if p_acc < nw:
                cand = cands_w[p_acc]
                accepted.append(cand)
                accepted_dict[cand] = (
                    (NAN, NAN) if p_wl <= p_exit
                    else (float(wstat[p_acc]), float(wpval[p_acc]))
                )
                last_accept = True
                ci += p_acc + 1
                wasted = p_acc + 1 < nw
            else:
                last_accept = False
                ci += nw
                wasted = False
            if check_clock and clock.expired() and ci < n_c:
                if control.converged:
                    return accepted_dict, candidates[ci:]
                clock.reset()
            spec = (max(2, spec // 2) if wasted
                    else min(SPEC_SHARED_MAX, spec * 4))
            continue

        if fast and cands_w:
            exit_e, wstat, wpval = got
            gi = 0
            wasted = False
            for (cand, Zs_build, has_req, _leg) in items:
                if cand in wl_snap:
                    if has_req:
                        gi += 1
                    accepted.append(cand)
                    accepted_dict[cand] = (NAN, NAN)
                    last_accept = True
                elif Zs_build is not None:
                    Zs_now = ([x for x in accepted if x != cand]
                              if phase == "E" else accepted)
                    if Zs_now != Zs_build:
                        wasted = True
                        break
                    if phase == "E":
                        accepted = Zs_now
                    if has_req:
                        if int(exit_e[gi]) < 0:
                            accepted.append(cand)
                            accepted_dict[cand] = (float(wstat[gi]),
                                                   float(wpval[gi]))
                            last_accept = True
                        else:
                            if phase == "E" and not cfg.fast_elim:
                                accepted.append(cand)
                            last_accept = False
                        gi += 1
                    else:
                        # empty conditioning set: auto-accept
                        accepted.append(cand)
                        accepted_dict[cand] = support_dict[cand]
                        last_accept = True
                # else: blacklisted -- nothing to do
                ci += 1
                if check_clock and clock.expired() and ci < n_c:
                    if control.converged:
                        return accepted_dict, candidates[ci:]
                    clock.reset()
            spec = (max(1, spec // 2) if wasted
                    else min(SPEC_WINDOW_MAX, spec * 2))
            continue

        # -- consume: strictly in candidate order, discarding stale results -
        gi = 0
        wasted = False
        for (cand, Zs_build, has_req, legacy) in items:
            if debug > 0:
                print(f"\tTesting candidate {cand} ({ci + 1} out of "
                      f"{n_c}) conditioned on {accepted}, current set "
                      f"size: {len(accepted)}")
            in_list = False
            if cand in wl_snap:
                # whitelist feed-forward (reference: src/hiton.jl:20-38);
                # the window's build-time snapshot decides membership
                if has_req:
                    gi += 1
                accepted.append(cand)
                accepted_dict[cand] = (NAN, NAN)
                in_list = True
                last_accept = True
                if debug > 0:
                    print("\tin whitelist")
            elif Zs_build is None:      # blacklisted at build (static set)
                in_list = True
                if debug > 0:
                    print("\tin blacklist")

            if not in_list:
                if legacy:
                    if phase == "E":
                        accepted = [a for a in accepted if a != cand]
                    if cfg.bnb:
                        from .bnb import bnb_test_subsets_gen

                        res, lowest_Zs, num_tests, frac = (
                            yield from bnb_test_subsets_gen(
                                T, cand, accepted, cfg, engine,
                                cfg.cut_test_branches))
                    else:
                        res, lowest_Zs, num_tests, frac = (
                            yield from test_subsets_gen(
                                T, cand, accepted, cfg, engine))
                else:
                    Zs_now = ([a for a in accepted if a != cand]
                              if phase == "E" else accepted)
                    if Zs_now != Zs_build:
                        # stale speculation: the set mutated since build
                        wasted = True
                        break
                    if phase == "E":
                        accepted = list(Zs_now)
                    if not has_req:         # empty conditioning set
                        res, lowest_Zs, num_tests, frac = (
                            TestResult(NAN, NAN, -1, True), (-1,), -1, NAN)
                    else:
                        if shared:
                            z_i, k_i = Zarr, kvec
                        else:
                            z_i, k_i = Zarr_parts[gi], kvec_parts[gi]
                        res, lowest_Zs, num_tests, frac = _consume_window(
                            T, cand, cfg, engine, got, gi, z_i, k_i,
                            len(Zs_now))
                        gi += 1
                n_before = len(accepted)
                _decide(cfg, phase, cand, res, lowest_Zs, num_tests, frac,
                        accepted, accepted_dict, support_dict, rej_dict)
                last_accept = len(accepted) > n_before

            ci += 1
            # per-job time-limit checkpoint (reference: src/hiton.jl:143-146).
            # Global convergence only takes effect HERE: a checkpointed job
            # is frozen instead of resumed (reference:
            # src/interleaved.jl:119-124); an unconverged checkpoint resumes
            # with a fresh clock (the reference requeues + restarts the
            # clock on re-entry, src/hiton.jl:305).
            if check_clock and clock.expired() and ci < n_c:
                if control.converged:
                    return accepted_dict, candidates[ci:]
                clock.reset()
        # adapt the speculation depth: grow while windows consume fully,
        # shrink when results were thrown away
        if wasted:
            spec = max(1, spec // 2)
        else:
            spec = min(SPEC_WINDOW_MAX, spec * 2)
    return accepted_dict, []


def _consume_window(T, cand, cfg, engine, got, gi, Zarr, kvec, a):
    """Finish one speculative candidate from the window's device response:
    scan its slice of the window's subset mega-chunk (mi) or run the pcor DP
    over its fetched masked correlation (fz_nz) -- the response half of
    test_subsets_gen."""
    if cfg.discrete:
        stat, df, n_obs, suff, offsets, exit_e, w_loc, maxp, epv = got
        o = offsets[gi]
        sl = slice(o, o + len(kvec))
        chunk = (stat[sl], df[sl], n_obs[sl], suff[sl],
                 (exit_e[gi], w_loc[gi], maxp[gi], epv[gi]))
    elif not cfg.nz:
        # fzwin: (stat, pval, df, suff, offsets) window arrays
        stat, pval, df, suff, offsets = got
        sl = slice(offsets[gi], offsets[gi] + len(kvec))
        chunk = (stat[sl], pval[sl], df[sl], suff[sl])
    else:
        mcor, mcor_nobs = got[gi]
        if cfg.n_obs_min > mcor_nobs:
            return TestResult(0.0, 1.0, 0, False), (), 0, 0.0
        # mcor is over [T, cand, Zs...]: Z_total[i] sits at position i + 2,
        # so the (cached) combo template maps directly
        tmpl_pos, _ = _combo_template(a, cfg.max_k)
        chunk = _fznz_subset_stats(engine, tmpl_pos, Zarr, kvec, mcor,
                                   mcor_nobs, True)
    scan = _ChunkScan(cfg, T, cand, a)
    hit = scan.consume(chunk, Zarr, kvec)
    if hit is not None:
        res, Zs = hit
        return res, Zs, scan.num_tests, scan.num_tests / scan.total
    return scan.finish()


# ---------------------------------------------------------------------------
# full per-target search (reference: src/hiton.jl:283-400)
# ---------------------------------------------------------------------------

# device-test budget for the single full-target speculative window.
# Waste scales ~m^3 with the candidate count while the early-exit path's
# real work scales ~m, so deep speculation only pays while the saved host
# round-trips dominate: 700 (m <= 8) covers the typical m ~ 3-5 targets
# while bounding the dispatched-test inflation of large candidate lists.
TURBO_TEST_BUDGET = 700
# the turbo kernel's marginal cost per window scales with the union subset
# family (~U*S plane traffic), not the test count, so deeper windows are
# affordable there: 1700 covers m <= 10
TURBO_MXU_BUDGET = 1700

# full-target window layouts keyed by (m, max_k): every Z entry is an index
# into the target's candidate array, so one cached template + one fancy
# index builds the whole request
_turbo_cache: Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

# accept-chain window layouts keyed by (a0, W, max_k): candidate k's
# conditioning list under the all-accept assumption is
# [accepted..., cands_w[:k]...], so the subset position templates for sizes
# a0..a0+W-1 index the concatenated [accepted + cands_w] array directly.
# lru-bounded: each template is up to SUBSET_CHUNK*max_k int32s and
# long-lived processes running many networks would otherwise accumulate
# them indefinitely (advisor finding, round 4).
@lru_cache(maxsize=512)
def _ichain_template(a0: int, W: int, max_k: int):
    idx_parts, kv_parts, counts = [], [], []
    for k in range(W):
        pos, kv = _combo_template(a0 + k, max_k)
        idx_parts.append(pos)
        kv_parts.append(kv)
        counts.append(len(kv))
    return (np.concatenate(idx_parts), np.concatenate(kv_parts),
            np.asarray(counts, np.int64))


def _turbo_template(m: int, max_k: int):
    """(IDX (B, max_k) candidate-index rows, KV (B,) subset sizes,
    COUNTS per-candidate test counts) for the full-target window: the
    all-accept interleaving prefixes (Zs_k = candidates[:k]) followed by the
    all-accept elimination rotation."""
    tpl = _turbo_cache.get((m, max_k))
    if tpl is None:
        idx_parts, kv_parts, counts = [], [], []
        for k in range(1, m):
            pos, kv = _combo_template(k, max_k)
            idx_parts.append(pos)            # pos < k indexes the prefix
            kv_parts.append(kv)
            counts.append(len(kv))
        posE, kvE = _combo_template(m - 1, max_k)
        # rotation k maps template position j to candidate (k + 1 + j) % m
        rotE = (1 + np.arange(m, dtype=np.int64)[:, None, None]
                + posE[None, :, :]) % m
        idx_parts.append(rotE.reshape(-1, max_k).astype(np.int32))
        kv_parts.append(np.tile(kvE, m))
        counts.extend([len(kvE)] * m)
        tpl = (np.concatenate(idx_parts), np.concatenate(kv_parts),
               np.asarray(counts, np.int64))
        _turbo_cache[(m, max_k)] = tpl
    return tpl


@lru_cache(maxsize=64)
def _turbo_mxu_template(m: int, max_k: int):
    """Host-side constants for the turbo-window kernel
    (ops/condtests.turbo_tests_begin): the window's UNION subset family --
    all subsets of the m candidates of size 1..min(max_k, m-1), each
    encoded once as stratum indicator planes on device -- plus each
    template test's (candidate lane jb, subset id ub) coordinates and the
    per-digest-slot segment bookkeeping.  The test order/slot layout is
    exactly _turbo_template's, so the digest consume in _turbo_target is
    shared between the turbo-kernel and histogram paths."""
    IDX, KV, COUNTS = _turbo_template(m, max_k)
    B = len(KV)
    subsets = []
    for k in range(1, min(max_k, m - 1) + 1):
        subsets.extend(itertools.combinations(range(m), k))
    sid = {frozenset(s): i for i, s in enumerate(subsets)}
    U = len(subsets)
    memb = np.zeros((U, max_k), np.int32)
    klen = np.zeros(U, np.int32)
    for i, s in enumerate(subsets):
        memb[i, : len(s)] = s
        klen[i] = len(s)
    ub = np.fromiter(
        (sid[frozenset(IDX[b, : KV[b]].tolist())] for b in range(B)),
        np.int32, count=B)
    # per-test candidate lane: I slots test candidates 1..m-1 against
    # all-accept prefixes, then E slots rotate candidates 0..m-1
    jb = np.repeat(np.concatenate([np.arange(1, m), np.arange(m)]),
                   COUNTS).astype(np.int32)
    NC = 2 * m - 1
    offs = np.zeros(NC, np.int64)
    np.cumsum(COUNTS[:-1], out=offs[1:])
    return dict(B=B, U=U, NC=NC, memb=memb, klen=klen, jb=jb, ub=ub,
                offs=offs, counts=np.asarray(COUNTS, np.int64))


def _turbo_target(T, candidates, cfg, engine, support_dict, whitelist,
                  control):
    """ONE speculative window covering the target's whole search: every
    interleaving candidate conditioned on the all-accept prefix
    (Zs_k = candidates[:k]) plus the all-accept elimination rotation.

    Univariate FDR pre-filters candidate lists so hard that most targets'
    conditional searches are pure confirmation runs; for those this replaces
    ~4-6 sequential window round-trips with ONE dispatch.  Returns:
      HitonState       -- every speculated outcome held (the common case)
      ("tpc", TPC)     -- the I phase completed exactly but an E-stage
                          outcome mispredicted (elimination, or a live
                          whitelist hit whose duplicate-append would
                          reorder the rotation); the caller keeps TPC and
                          reruns only the standard E phase
      None             -- an I rejection: rerun everything
    Decisions and recorded statistics are identical to the sequential path
    by construction; mispredicts only waste already-dispatched device
    tests."""
    m = len(candidates)
    max_k = cfg.max_k
    # whitelist SNAPSHOT at window build -- the same unified semantic as
    # every standard window (see phase_backend docstring), matching the
    # reference's job-start skip_nbrs snapshot (reference
    # src/interleaved.jl:124-131; whitelists attach when a job is
    # (re)queued, not live).  Practically, turbo windows build in round 1
    # when the feed-forward graph is still empty; a live re-read at consume
    # saw the filled graph and forced E-phase reruns for most targets
    # (+2x dispatched tests).
    wl_live = (whitelist.live_set() if hasattr(whitelist, "live_set")
               else whitelist)
    wl_live = set(wl_live) if wl_live else ()
    if m == 1:
        c0 = candidates[0]
        entry = (NAN, NAN) if c0 in wl_live else support_dict[c0]
        return HitonState("F", {c0: entry}, {c0: entry}, [], {})
    stE = _subset_total(m - 1, max_k)
    total = sum(_subset_total(k, max_k) for k in range(1, m)) + m * stE
    mxu = getattr(engine, "turbo_mxu", False)
    budget = TURBO_MXU_BUDGET if mxu else TURBO_TEST_BUDGET
    if stE > SUBSET_CHUNK or total > budget:
        return None
    control.turbo_attempts += 1
    if WINDOW_STATS is not None:
        WINDOW_STATS["turbo"] = WINDOW_STATS.get("turbo", 0) + 1
        if mxu:
            WINDOW_STATS["turbo_mxu"] = WINDOW_STATS.get("turbo_mxu", 0) + 1
    if mxu:
        # turbo-kernel path: the engine computes every (candidate, subset)
        # joint table of this window with ONE contraction and returns
        # the same per-slot digest layout (ops/condtests._turbo_digest_fn)
        got = yield ("turbowin", T, candidates, m)
    else:
        cands_np = np.asarray(candidates, np.int32)
        IDX, KV, COUNTS = _turbo_template(m, max_k)
        got = yield ("miwin", T, candidates[1:] + candidates,
                     cands_np[IDX], KV, COUNTS, False)
    exit_e, wstat, wpval = got
    # interleaving scan: candidate 0 auto-accepts (reference hiton.jl:57-59)
    c0 = candidates[0]
    TPC = {c0: (NAN, NAN) if c0 in wl_live else support_dict[c0]}
    for k in range(1, m):
        cand = candidates[k]
        if cand in wl_live:
            TPC[cand] = (NAN, NAN)
        elif int(exit_e[k - 1]) < 0:
            TPC[cand] = (float(wstat[k - 1]), float(wpval[k - 1]))
        else:
            control.turbo_fallbacks += 1
            if WINDOW_STATS is not None:
                WINDOW_STATS["turbo_irej"] = (
                    WINDOW_STATS.get("turbo_irej", 0) + 1)
            return None                 # I rejection: speculation dead
    # elimination scan over the rotation; an E mispredict keeps the exact,
    # complete I results and reruns only the E phase (a live whitelist will
    # commonly have entries by consume time under feed-forward -- a full
    # rerun here doubled the 10k bench's dispatched tests)
    PC = {}
    off = m - 1
    for k in range(m):
        cand = candidates[k]
        if cand in wl_live:
            if WINDOW_STATS is not None:
                WINDOW_STATS["turbo_ewl"] = (
                    WINDOW_STATS.get("turbo_ewl", 0) + 1)
            return ("tpc", TPC)         # duplicate-append would de-sync
        if int(exit_e[off + k]) < 0:
            PC[cand] = (float(wstat[off + k]), float(wpval[off + k]))
        else:
            if WINDOW_STATS is not None:
                WINDOW_STATS["turbo_eelim"] = (
                    WINDOW_STATS.get("turbo_eelim", 0) + 1)
            return ("tpc", TPC)         # elimination: rerun E only
    # min-weight reconciliation (reference: src/hiton.jl:249-256)
    if cfg.no_red_tests or cfg.fast_elim:
        for nbr in PC:
            tv = TPC.get(nbr)
            if tv is not None and (tv[1] > PC[nbr][1]
                                   or math.isnan(PC[nbr][1])):
                PC[nbr] = tv
    if WINDOW_STATS is not None:
        WINDOW_STATS["turbo_full"] = WINDOW_STATS.get("turbo_full", 0) + 1
    return HitonState("F", PC, TPC, [], {})


def si_hiton_pc_gen(T: int, cfg: HitonConfig, engine,
                    univar_nbrs: NbrStatDict,
                    prev_state: Optional[HitonState] = None,
                    whitelist=None, blacklist: Optional[Set[int]] = None,
                    control: Optional[SearchControl] = None):
    """Generator running the full HITON-PC search for target T.  Yields
    batched test requests and returns the final (or partial) HitonState."""
    if prev_state is None:
        prev_state = HitonState("S", {}, {}, [], {})
    if control is None:
        control = SearchControl()
    blacklist = blacklist or set()
    rej_dict: RejDict = {}

    if cfg.discrete and engine.levels[T] < 2:
        return _empty_state()

    # per-job clock, started when this target's search actually begins
    # (generator body runs on first advance; reference: src/hiton.jl:305)
    clock = JobClock(cfg.time_limit, control.now_fn)

    if cfg.max_k <= 0:
        TPC_dict: NbrStatDict = {}
        PC_dict = univar_nbrs
        return _make_final_state(prev_state, PC_dict, TPC_dict, rej_dict)

    if prev_state.phase == "C":
        # global convergence froze this variable (reference: src/hiton.jl:315-322)
        if prev_state.inter_results:
            TPC_dict = prev_state.inter_results
            PC_dict = prev_state.state_results
        else:
            TPC_dict, PC_dict = {}, {}
        return _make_final_state(prev_state, PC_dict, TPC_dict, rej_dict)

    TPC_dict = {}
    if prev_state.phase in ("I", "S"):
        # prepare interleaving (reference: src/hiton.jl:199-220)
        if prev_state.phase == "I":
            prev_TPC = prev_state.state_results
            candidates_unchecked = list(prev_state.unchecked_vars)
            candidates: List[int] = []
            if cfg.track_rejections:
                rej_dict = prev_state.state_rejections
        else:
            # univar-p-sorted candidates; stable argsort keeps insertion
            # order on ties like the previous sorted() (vectorized -- per-
            # target Python sorts dominated large runs)
            if isinstance(univar_nbrs, PSortedNbrs):
                # extraction-built dicts: insertion order IS the stable
                # ascending-p sort; the alpha filter still applies (a
                # precomputed all_univar_nbrs may come from a looser alpha)
                candidates = [c for c, v in univar_nbrs.items()
                              if v[1] < cfg.alpha]
            else:
                nn = len(univar_nbrs)
                cs = np.fromiter((c for c in univar_nbrs), np.int64, count=nn)
                pv = np.fromiter((v[1] for v in univar_nbrs.values()),
                                 np.float64, count=nn)
                keep = pv < cfg.alpha
                cs, pv = cs[keep], pv[keep]
                if pv.size <= 1 or not (np.diff(pv) < 0).any():
                    candidates = cs.tolist()
                else:
                    candidates = cs[np.argsort(pv, kind="stable")].tolist()
            candidates_unchecked = []
            prev_TPC = {}
        if not candidates and not candidates_unchecked and not prev_TPC:
            return _empty_state()

        turbo_tpc = None
        if (prev_state.phase == "S" and cfg.discrete and not cfg.bnb
                and not blacklist and candidates and fast_mode(cfg)
                and control.turbo_worthwhile()):
            done = yield from _turbo_target(T, candidates, cfg, engine,
                                            univar_nbrs, whitelist, control)
            if isinstance(done, HitonState):
                return done
            if done is not None:        # ("tpc", TPC): rerun only phase E
                turbo_tpc = done[1]

        if turbo_tpc is not None:
            TPC_dict = turbo_tpc
        else:
            TPC_dict, candidates_unchecked = yield from phase_backend(
                T, candidates, cfg, engine, "I", prev_TPC,
                candidates_unchecked, univar_nbrs, whitelist, blacklist,
                rej_dict, control, clock,
            )
            if candidates_unchecked:
                return HitonState("I", TPC_dict, {}, candidates_unchecked,
                                  rej_dict)

    # prepare elimination (reference: src/hiton.jl:223-246)
    if prev_state.phase == "E":
        prev_PC = prev_state.state_results
        if cfg.no_red_tests or cfg.fast_elim:
            TPC_dict = prev_state.inter_results
        PC_unchecked = list(prev_state.unchecked_vars)
        PC_candidates = list(prev_PC.keys()) + PC_unchecked
        if cfg.track_rejections:
            rej_dict = prev_state.state_rejections
    else:
        prev_PC = {}
        PC_unchecked = []
        PC_candidates = list(TPC_dict.keys())

    PC_dict, TPC_unchecked = yield from phase_backend(
        T, PC_candidates, cfg, engine, "E", prev_PC, PC_unchecked,
        TPC_dict, whitelist, blacklist, rej_dict, control, clock,
    )
    if TPC_unchecked:
        return HitonState("E", PC_dict, TPC_dict, TPC_unchecked, rej_dict)

    # reconcile weakest-significance weights (reference: src/hiton.jl:249-256)
    if cfg.no_red_tests or cfg.fast_elim:
        for nbr in PC_dict:
            if nbr in TPC_dict and (
                TPC_dict[nbr][1] > PC_dict[nbr][1] or np.isnan(PC_dict[nbr][1])
            ):
                PC_dict[nbr] = TPC_dict[nbr]

    return _make_final_state(prev_state, PC_dict, TPC_dict, rej_dict)


def si_hiton_pc(T: int, data, test_name: str = "mi", **kwargs) -> HitonState:
    """Convenience wrapper: learn the local neighborhood of one variable
    (reference: src/hiton.jl:403-409).  Runs the univariate pass, then drives
    the search generator to completion with a local engine."""
    import numpy as np

    from ..ops.condtests import CondTestEngine
    from ..ops.univariate import cor_matrix, pw_univar_neighbors
    from ..utils.misc import get_levels, get_max_vals, isdiscrete

    data = np.asarray(data)
    cfg_keys = {f.name for f in __import__("dataclasses").fields(HitonConfig)}
    cfg = HitonConfig(test_name=test_name,
                      **{k: v for k, v in kwargs.items() if k in cfg_keys})
    levels = max_vals = None
    cor_mat = None
    if isdiscrete(test_name):
        levels = get_levels(data)
        max_vals = get_max_vals(data)
    elif test_name == "fz":
        cor_mat = np.asarray(cor_matrix(data), dtype=np.float64)
    univar = pw_univar_neighbors(
        data, test_name=test_name, alpha=cfg.alpha, hps=cfg.hps,
        n_obs_min=cfg.n_obs_min, levels=levels, max_vals=max_vals,
        cor_mat=cor_mat,
    )
    engine = CondTestEngine(data, test_name, cfg.max_k, levels=levels,
                            max_vals=max_vals, cor_mat=cor_mat, hps=cfg.hps,
                            n_obs_min=cfg.n_obs_min)
    from .scheduler import Dispatcher

    dispatcher = Dispatcher(engine, cfg.alpha, fast=fast_mode(cfg))
    gen = si_hiton_pc_gen(T, cfg, engine, univar[T])
    resp = None
    while True:
        try:
            req = gen.send(resp)
        except StopIteration as stop:
            return stop.value
        resp = dispatcher.one(req)


def _make_final_state(prev_state: HitonState, PC_dict, TPC_dict,
                      rej_dict) -> HitonState:
    # reference: src/hiton.jl:259-277
    if prev_state.phase == "C":
        return HitonState("C", PC_dict, TPC_dict,
                          list(prev_state.unchecked_vars),
                          prev_state.state_rejections)
    return HitonState("F", PC_dict, TPC_dict, [], rej_dict)
