"""Batched all-pairs univariate association tests.

Device replacement for the reference's pairwise pass (reference:
src/tests.jl:370-532 ``pw_univar_neighbors`` + per-pair kernels).  Instead of
n*(n-1)/2 scalar tests distributed over worker processes, the whole pass is a
handful of (vars x samples) @ (samples x vars) matmuls:

- fz        : one standardized Gram matrix (the correlation matrix)
- fz_nz     : four masked-moment matmuls (n, sum x, sum x^2, sum xy over rows
              where BOTH variables are nonzero) -- replaces the sparse
              merge-join streaming correlation (reference src/statfuns.jl:91-123)
- mi / mi_nz: L^2 one-hot matmuls producing all-pairs contingency tables
              (replaces reference src/contingency.jl:80-123)

Work is processed in X-variable blocks so device memory stays bounded and the
block axis / output columns can be sharded over a device mesh.  p-values are
computed on host in float64 (the reference keeps all stats in Float64;
float32 p-values would collapse the BH-FDR ranking of highly significant
pairs) from tiny per-pair aggregates pulled off-device.
"""

from __future__ import annotations

import math
import warnings
from functools import lru_cache, partial
from typing import Dict, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from . import statfuns as sf
from .contingency import pair_ctab_block
from ..types import PSortedNbrs
from ..utils.accel import on_accelerator
from ..utils.misc import is_zero_adjusted, isdiscrete


# ---------------------------------------------------------------------------
# device kernels
# ---------------------------------------------------------------------------

@jax.jit
def cor_matrix(data):
    """Full correlation matrix as one Gram matmul (reference equivalent:
    Statistics.cor used at src/learning.jl:44).

    HIGHEST matmul precision: a default-precision f32 matmul may run in
    TF32 (~1e-3 relative error) -- enough to flip near-threshold fz
    decisions."""
    n = data.shape[0]
    mu = data.mean(axis=0, keepdims=True)
    xc = data - mu
    cov = jnp.matmul(xc.T, xc, precision=lax.Precision.HIGHEST)
    d = jnp.sqrt(jnp.diag(cov))
    denom = d[:, None] * d[None, :]
    r = jnp.where(denom > 0, cov / jnp.where(denom > 0, denom, 1.0), jnp.nan)
    # Julia's Statistics.cor clamps to [-1, 1] (clampcor); without it an
    # exact-copy column pair can round to 1+eps -> NaN Fisher-z p-value
    return jnp.clip(r, -1.0, 1.0)


@partial(jax.jit, static_argnames=("tile", "y_len"))
def fz_nz_block(data, start, tile, y_start=0, y_len=None):
    """Masked pairwise correlation of an X-block against a Y-slab (default:
    all variables) over rows where both are nonzero (reference:
    src/statfuns.jl:91-123 with nz=true).  Returns (stat, n_obs) of shape
    (tile, y_len)."""
    n = data.shape[0]
    if y_len is None:
        y_len = data.shape[1]
    yslab = lax.dynamic_slice(data, (0, y_start), (n, y_len))
    nzmask = (yslab != 0).astype(data.dtype)
    xslab = lax.dynamic_slice(data, (0, start), (n, tile))
    mb = (xslab != 0).astype(data.dtype)
    db = xslab * mb
    dm = yslab * nzmask
    # the joint count multiplies 0/1 operands: exact at any matmul precision
    # (f32 accumulation of counts < 2^24).  The value moments feed the
    # Sxx - Sx^2/N cancellation, where TF32 flips fz decisions: HIGHEST.
    hi = lax.Precision.HIGHEST
    N = jnp.matmul(mb.T, nzmask, precision=lax.Precision.DEFAULT)
    Sx = jnp.matmul(db.T, nzmask, precision=hi)       # sum x over joint rows
    Sy = jnp.matmul(mb.T, dm, precision=hi)
    Sxx = jnp.matmul((db * db).T, nzmask, precision=hi)
    Syy = jnp.matmul(mb.T, dm * dm, precision=hi)
    Sxy = jnp.matmul(db.T, dm, precision=hi)
    safe_n = jnp.where(N > 0, N, 1.0)
    cov = Sxy - Sx * Sy / safe_n
    varx = Sxx - Sx * Sx / safe_n
    vary = Syy - Sy * Sy / safe_n
    denom = jnp.sqrt(varx * vary)
    r = cov / denom                                   # 0/0 -> NaN, x/0 -> inf
    # sparse-path clamp semantics (reference src/statfuns.jl:116-120):
    # inf -> 1, -inf -> -1, NaN propagates
    r = jnp.where(r > 1.0, 1.0, r)
    r = jnp.where(r < -1.0, -1.0, r)
    r = jnp.where(N > 0, r, 0.0)                      # n_obs == 0 -> stat 0
    return r, N


def _mi_block_stats_impl(ctab, levels_x, levels_y, maxv_x, maxv_y, hps,
                         n_obs_min, nz, L, xp=jnp):
    t, p = ctab.shape[:2]
    lx = levels_x[:, None].astype(ctab.dtype)
    ly = levels_y[None, :].astype(ctab.dtype)
    if nz:
        ox = (maxv_x > 1).astype(xp.int32)[:, None] * xp.ones((1, p), xp.int32)
        oy = (maxv_y > 1).astype(xp.int32)[None, :] * xp.ones((t, 1), xp.int32)
        a = xp.arange(L)
        keep = (a[:, None] >= ox[..., None, None]) & (a[None, :] >= oy[..., None, None])
        sub = ctab * keep.astype(ctab.dtype)
        lx_eff = (L - ox).astype(ctab.dtype)          # size of sliced table
        ly_eff = (L - oy).astype(ctab.dtype)
        # rows of the X-trimmed view (pre-check n_obs): all rows with x >= ox
        rowkeep = (a[:, None] >= ox[..., None, None]) & xp.ones(
            (1, L), bool
        )
        n_view = (ctab * rowkeep.astype(ctab.dtype)).sum(axis=(-2, -1))
    else:
        ox = xp.zeros((t, p), xp.int32)
        oy = xp.zeros((t, p), xp.int32)
        sub = ctab
        lx_eff = lx * xp.ones((t, p), ctab.dtype)
        ly_eff = ly * xp.ones((t, p), ctab.dtype)
        n_view = ctab.sum(axis=(-2, -1))

    stat, df, n_obs = sf.mi_stats(sub[..., None], ox, oy, xp=xp)

    # pre-check (reference src/tests.jl:9-20): offsets from LEVELS (>1 -> 2),
    # zero denominators pass (Julia n/0 == Inf)
    plx = lx - xp.where(lx > 1, 2.0, 1.0)
    ply = ly - xp.where(ly > 1, 2.0, 1.0)
    cells_pre = plx * ply
    pre_ok = (n_view >= n_obs_min) & xp.where(
        cells_pre > 0, n_view / xp.where(cells_pre > 0, cells_pre, 1.0) > hps, True
    )
    # post-check (reference src/tests.jl:56-62)
    cells_post = lx_eff * ly_eff
    post_ok = (n_obs >= n_obs_min) & xp.where(
        cells_post > 0, n_obs / xp.where(cells_post > 0, cells_post, 1.0) > hps, True
    )
    # X variables with < 2 levels never test (reference src/tests.jl:86-92)
    row_ok = lx >= 2
    suff = pre_ok & post_ok & row_ok
    stat = xp.where(suff, stat, 0.0)
    df = xp.where(suff, df, 0)
    return stat, df, n_obs, suff


@partial(jax.jit, static_argnames=("nz", "L"))
def mi_block_stats(ctab, levels_x, levels_y, maxv_x, maxv_y, hps, n_obs_min,
                   nz, L):
    """Univariate MI G-test statistics from a block of pair tables.

    Implements the reference's dense univariate test logic (reference:
    src/tests.jl:28-77): nz slicing, power pre/post checks, signed MI, df
    adjustment.  Shapes: ctab (t, p, L, L); levels_x/maxv_x (t,);
    levels_y/maxv_y (p,).  Returns (stat, df, n_obs, suff_power).
    """
    return _mi_block_stats_impl(ctab, levels_x, levels_y, maxv_x, maxv_y,
                                hps, n_obs_min, nz, L)


def mi_block_stats_np(data, xs, ys, levels, max_vals, hps, n_obs_min, nz, L):
    """Float64 numpy reference of the univariate MI test for the pairs
    (xs x ys) of an (n, p) integer table: the plain formulation (one-hot
    contingency tables, then :func:`_mi_block_stats_impl` in numpy) that
    the int8 device route is checked against."""
    d = np.asarray(data)
    n, t, q = d.shape[0], len(xs), len(ys)
    ex = (d[:, xs, None] == np.arange(L)).astype(np.float64)   # (n, t, L)
    ey = (d[:, ys, None] == np.arange(L)).astype(np.float64)   # (n, q, L)
    ctab = (ex.reshape(n, t * L).T @ ey.reshape(n, q * L)).reshape(
        t, L, q, L).transpose(0, 2, 1, 3)
    lv = np.asarray(levels)
    mv = np.asarray(max_vals)
    return _mi_block_stats_impl(ctab, lv[xs], lv[ys], mv[xs], mv[ys], hps,
                                n_obs_min, nz, L, xp=np)


def _mi_epilogue(joint, mx, my, lx, ly, mvx, mvy, L, nz, hps, n_obs_min,
                 n_rows):
    """G-test epilogue from the (L-1)^2 joint counts of levels >= 1 plus the
    fixed table margins: full-table reconstruction, nz slicing, signed MI,
    df adjustment, power checks (semantics of :func:`mi_block_stats`,
    reference src/statfuns.jl:163-323 + src/tests.jl:28-103).

    Args:
      joint(ia, ib): int32 (tx, ty) count plane of level pair (ia, ib) for
        1 <= ia, ib < L.
      mx, my: lists indexed by level 1..L-1 (index 0 unused) of int32
        level marginals shaped (tx, 1) / (1, ty).
      lx, ly, mvx, mvy: int32 levels and max values, (tx, 1) / (1, ty).
      nz: 3-state static flag: 0 plain, 1 per-variable nz offsets, 2
        nz-UNIFORM (every variable 3-level, so ox = oy = 1 are constants).
    Returns (stat f32, df i32, n_obs i32, suff i32), each (tx, ty).
    """
    uniform = (nz == 2)
    f32 = jnp.float32
    lx = lx.astype(f32)
    ly = ly.astype(f32)
    lo = 1 if uniform else 0
    cnt = {}
    for ia in range(1, L):
        for ib in range(1, L):
            cnt[(ia, ib)] = joint(ia, ib)
    if not uniform:
        # reconstruct the full L x L table from the (L-1)^2 joint counts
        # and the fixed margins, exactly, in int32
        for ia in range(1, L):
            cnt[(ia, 0)] = mx[ia] - sum(cnt[(ia, ib)] for ib in range(1, L))
        for ib in range(1, L):
            cnt[(0, ib)] = my[ib] - sum(cnt[(ia, ib)] for ia in range(1, L))
        cnt[(0, 0)] = (
            n_rows - sum(mx[1:]) - sum(my[1:])
            + sum(cnt[(ia, ib)] for ia in range(1, L) for ib in range(1, L))
        )
    if uniform:
        def subplane(av, bv):
            return cnt[(av, bv)].astype(f32)

        def diagf(av, bv):
            return 1.0 if av == bv else 0.0
    else:
        if nz:
            ox = (mvx > 1).astype(f32)
            oy = (mvy > 1).astype(f32)
        else:
            ox = jnp.zeros_like(lx)
            oy = jnp.zeros_like(ly)
        xmask = [(av >= ox).astype(f32) for av in range(L)]
        ymask = [(bv >= oy).astype(f32) for bv in range(L)]
        _spc = {}

        def subplane(av, bv):
            if (av, bv) not in _spc:
                _spc[(av, bv)] = (cnt[(av, bv)].astype(f32)
                                  * xmask[av] * ymask[bv])
            return _spc[(av, bv)]

        def diagf(av, bv):
            return ((av - ox) == (bv - oy)).astype(f32)

    row = {av: sum(subplane(av, bv) for bv in range(lo, L))
           for av in range(lo, L)}
    col = {bv: sum(subplane(av, bv) for av in range(lo, L))
           for bv in range(lo, L)}
    n_obs = sum(row.values())
    # MI terms with diag/offdiag split (sign semantics of
    # reference src/statfuns.jl:209-254)
    mi_pos = jnp.zeros_like(n_obs)
    mi_neg = jnp.zeros_like(n_obs)
    n_pos = jnp.zeros_like(n_obs)
    for av in range(lo, L):
        for bv in range(lo, L):
            s_ab = subplane(av, bv)
            # s_ab > 0 implies row/col marginals > 0
            validf = (s_ab > 0).astype(f32)
            inv = 1.0 - validf
            ratio = (n_obs * s_ab + inv) / (row[av] * col[bv] + inv)
            term = jnp.log(ratio) * s_ab
            d = diagf(av, bv)
            if isinstance(d, float):
                if d:
                    mi_pos += term
                    n_pos += s_ab
                else:
                    mi_neg += term
            else:
                mi_pos += d * term
                mi_neg += (1.0 - d) * term
                n_pos += d * s_ab
    n_neg = n_obs - n_pos
    safe_n = jnp.maximum(n_obs, 1.0)
    mi = (mi_pos + mi_neg) / safe_n
    flipf = (mi_neg * n_neg > mi_pos * n_pos).astype(f32)
    mi = mi * (1.0 - 2.0 * flipf)
    # adjusted df (reference src/statfuns.jl:281-305)
    alx = sum((r != 0).astype(f32) for r in row.values())
    aly = sum((c != 0).astype(f32) for c in col.values())
    df = (jnp.maximum(alx, 1.0) - 1.0) * (jnp.maximum(aly, 1.0) - 1.0)
    # pre-check on the X-trimmed view (reference src/tests.jl:9-20): its
    # total follows from the fixed margins alone
    if uniform:
        n_view = sum(mx[av].astype(f32) for av in range(1, L))
    else:
        n_view = sum(cnt[(av, bv)].astype(f32) * xmask[av]
                     for av in range(L) for bv in range(L))
    plx = lx - 1.0 - (lx > 1.0).astype(f32)
    ply = ly - 1.0 - (ly > 1.0).astype(f32)
    cells_pre = plx * ply
    # ok iff cells <= 0 OR n/cells > hps (Julia n/0 == Inf > hps)
    pre_ratio_ok = jnp.maximum((n_view > hps * cells_pre).astype(f32),
                               (cells_pre <= 0).astype(f32))
    pre_ok = (n_view >= n_obs_min).astype(f32) * pre_ratio_ok
    if uniform:
        cells_post = float((L - 1) * (L - 1))
        post_ok = ((n_obs >= n_obs_min).astype(f32)
                   * (n_obs > hps * cells_post).astype(f32))
    else:
        if nz:
            lx_eff = L - ox
            ly_eff = L - oy
        else:
            lx_eff = lx * jnp.ones_like(oy)
            ly_eff = ly * jnp.ones_like(ox)
        cells_post = lx_eff * ly_eff
        post_ratio_ok = jnp.maximum((n_obs > hps * cells_post).astype(f32),
                                    (cells_post <= 0).astype(f32))
        post_ok = (n_obs >= n_obs_min).astype(f32) * post_ratio_ok
    sufff = pre_ok * post_ok * (lx >= 2.0).astype(f32)
    return (mi * sufff, (df * sufff).astype(jnp.int32),
            n_obs.astype(jnp.int32), sufff.astype(jnp.int32))


@partial(jax.jit, static_argnames=("L",))
def level_marginals(dataT, L):
    """(L, p) int32 per-variable level counts of a (p, n) table: the fixed
    contingency-table margins (one cheap reduction replaces the
    L*L - (L-1)^2 count products that involve level 0)."""
    lv = jnp.arange(L, dtype=jnp.int32).reshape(-1, 1, 1)
    return (dataT[None].astype(jnp.int32) == lv).sum(axis=2).astype(
        jnp.int32)


@partial(jax.jit, static_argnames=("tile", "L", "y_len", "nz", "hps",
                                   "n_obs_min"))
def mi_univar_stats(dataT, marg, levels, max_vals, start, tile, L, y_start=0,
                    y_len=None, nz=True, hps=5.0, n_obs_min=0.0):
    """Univariate MI stats of an X-block against a Y-slab on the int8 route:
    returns (stat f32, df i32, n_obs i32, suff bool), each (tile, y_len).

    Only the (L-1)^2 joint counts of levels >= 1 are products: int8 level
    indicator planes, X as (K*tile, n) and Y as (K*y_len, n), contract in
    ONE int8 dot with exact int32 accumulation; the level-0 cells follow
    from the margins inside :func:`_mi_epilogue`.

    Args:
      dataT: (p, n) int8 table, variables as rows (both operands contract
        along their contiguous sample axis).
      marg:  (L, p) int32 level marginals from :func:`level_marginals`.
    """
    p, n = dataT.shape
    if y_len is None:
        y_len = p
    K = L - 1
    lv = jnp.arange(1, L, dtype=dataT.dtype)[:, None, None]
    xs = lax.dynamic_slice(dataT, (start, 0), (tile, n))
    ys = lax.dynamic_slice(dataT, (y_start, 0), (y_len, n))
    ex = (xs[None] == lv).astype(jnp.int8).reshape(K * tile, n)
    ey = (ys[None] == lv).astype(jnp.int8).reshape(K * y_len, n)
    cnt = lax.dot_general(ex, ey, (((1,), (1,)), ((), ())),
                          preferred_element_type=jnp.int32)
    cnt = cnt.reshape(K, tile, K, y_len)
    mx = lax.dynamic_slice(marg, (0, start), (L, tile))
    my = lax.dynamic_slice(marg, (0, y_start), (L, y_len))
    lx = lax.dynamic_slice(levels, (start,), (tile,))
    ly = lax.dynamic_slice(levels, (y_start,), (y_len,))
    mvx = lax.dynamic_slice(max_vals, (start,), (tile,))
    mvy = lax.dynamic_slice(max_vals, (y_start,), (y_len,))
    stat, df, nobs, suff = _mi_epilogue(
        lambda ia, ib: cnt[ia - 1, :, ib - 1, :],
        [None] + [mx[lv_, :, None] for lv_ in range(1, L)],
        [None] + [my[lv_, None, :] for lv_ in range(1, L)],
        lx[:, None], ly[None, :], mvx[:, None], mvy[None, :],
        L, nz, float(hps), float(n_obs_min), n)
    return stat, df, nobs, suff.astype(bool)


# ---------------------------------------------------------------------------
# host driver
# ---------------------------------------------------------------------------

# test hook: take the accelerator path (int8 mi route + device-side FDR
# extraction) on the CPU; the name predates the removal of the Pallas kernels
FORCE_PALLAS = False


def put_continuous(data, mesh=None):
    """Device placement for continuous (fz / fz_nz) tables: float64 under
    x64 (parity runs), float32 otherwise, replicated over ``mesh``."""
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    x = jnp.asarray(data, dtype)
    if mesh is not None:
        from ..parallel.mesh import put_replicated

        x = put_replicated(x, mesh)
    return x


def _choose_tile(p: int, requested: Optional[int]) -> int:
    if requested is not None:
        return min(requested, p)
    return min(p, 512)


def condensed_index(p: int):
    """Upper-triangle (X < Y) index pairs, row-major like the reference's
    condensed layout (reference: src/tests.jl:377-388)."""
    iu = np.triu_indices(p, k=1)
    return iu


def condensed_pos(X, Y, p):
    """Row-major condensed position of pair (X < Y) in the n_pairs vector."""
    X = np.asarray(X, dtype=np.int64)
    Y = np.asarray(Y, dtype=np.int64)
    return X * (2 * p - X - 1) // 2 + (Y - X - 1)


def condensed_to_pair(idx, p):
    """Inverse of condensed_pos (vectorized), avoiding O(p^2) index tables."""
    idx = np.asarray(idx, dtype=np.int64)
    # solve X(2p - X - 1)/2 <= idx: X = floor((2p-1 - sqrt((2p-1)^2-8idx))/2)
    disc = (2 * p - 1) ** 2 - 8 * idx.astype(np.float64)
    X = ((2 * p - 1 - np.sqrt(disc)) / 2).astype(np.int64)
    # fp-correct the boundary
    for _ in range(2):
        base = X * (2 * p - X - 1) // 2
        X = np.where(base > idx, X - 1, X)
        base = X * (2 * p - X - 1) // 2
        too_low = idx - base >= (p - 1 - X)
        X = np.where(too_low, X + 1, X)
    base = X * (2 * p - X - 1) // 2
    Y = idx - base + X + 1
    return X, Y


def _condense_block(s, t, p, blocks, outs, y_start=0):
    """Scatter a (tile, y_len) block slab's X<Y entries (Y < p) into the
    condensed output vectors.  Column q of the slab is variable y_start+q."""
    y_len = blocks[0].shape[1]
    ys = np.arange(y_start, min(y_start + y_len, p))
    rows, cols = np.nonzero(np.arange(s, s + t)[:, None] < ys[None, :])
    pos = condensed_pos(rows + s, ys[cols], p)
    for blk, out in zip(blocks, outs):
        out[pos] = blk[rows, cols]


def _y_slabs(p_int: int, tile_sz: int, triangle: bool):
    """Per-X-block Y-slab choices [y_start, p_int) for the pair sweep.

    With triangle=True each slab covers only Y >= x_start (every X<Y pair is
    still produced exactly once), bucketed to at most ~8 distinct slab
    lengths so the number of compiled kernel shapes stays bounded.  Cuts
    device work ~1.8x versus the full rectangle.
    """
    if not triangle:
        return lambda s: (0, p_int)
    step = max(tile_sz, -(-p_int // (8 * tile_sz)) * tile_sz)

    def slab(s):
        y_len = min(p_int, -(-(p_int - s) // step) * step)
        return p_int - y_len, y_len

    return slab


# ---------------------------------------------------------------------------
# device-side FDR + significant-pair extraction (accelerator path)
#
# Pulling the full condensed statistics to host costs O(pairs) transfer and
# host memory (~25 B per pair: 54 GB at p=65,536), and host-side gammaincc
# over them costs minutes.  p-values are computed on device in LOG space
# (no underflow, total order preserved) and only the significant pairs
# (plus tiny count tables) ever cross to the host.
#
# The extraction is TWO sweep passes so device memory stays O(significant)
# instead of O(covered pairs) -- the reference's univariate pass works at any
# p (reference: src/tests.jl:474-519), and at its headline ~100k-variable
# scale O(pairs) buffers (~10^10 entries) cannot exist on one device:
#
#   pass A: run the sweep kernels, reduce each block to CUMULATIVE counts of
#           log p-values below ~48 host-chosen edges (a tiny count table per
#           block) plus unreliable-test counts.  No per-pair output.
#   host:   pick the BH-safe extraction edge e* from the count table -- the
#           smallest edge provably above every BH-significant p-value (the
#           argument: a significant p in bin b needs p <= alpha*rank/m and
#           rank <= C[b], so bins with lower_edge > alpha*C[b]/m cannot hold
#           one) -- and per-block candidate counts at e* (exact, the same
#           comparison pass B performs).
#   pass B: re-run the sweep; each block compacts its p < e* candidates into
#           an exactly-sized buffer (two-level sized nonzero), then one
#           global sort + log-space BH over all candidates finishes in the
#           same dispatch.  Candidate ranks in the global sort equal their
#           ranks over all pairs because every excluded pair has
#           p >= e* > every candidate -- the same argument as the
#           reference's accelerated pre-filtering BH (src/statfuns.jl:326).
#
# Re-running the kernels costs 2x FLOPs, but both passes emit only
# O(counts) / O(candidates) bytes instead of O(pairs).
# ---------------------------------------------------------------------------

N_EXTRACT_BINS = 48
EXTRACT_BUDGET = 1 << 26  # max candidates held on device (x ~16 B each)


@jax.jit
def _fz_center(data):
    """Per-variable centering + sum-of-squares sqrt for the blocked fz sweep
    (one pass; the blocked correlation r = xc_X.T @ xc_Y / (ssd_X ssd_Y) then
    matches cor_matrix exactly)."""
    mu = data.mean(axis=0, keepdims=True)
    xc = data - mu
    ssd = jnp.sqrt((xc * xc).sum(axis=0))
    return xc, ssd


def _mi_stats_block(accel, data_args, s, tile, L, y0, ylen, nz, hps,
                    n_obs_min):
    """(stat, df, n_obs, suff) of one X-block x Y-slab: the int8 route on
    the accelerator path (data_args = (dataT int8, marg, levels, maxv)),
    one-hot tables in the table's own dtype on the parity path
    (data_args = (data, levels, maxv))."""
    if accel:
        dataT, marg, levels, maxv = data_args
        return mi_univar_stats(dataT, marg, levels, maxv, s, tile, L, y0,
                               ylen, nz, hps, n_obs_min)
    data, levels, maxv = data_args
    ctab = pair_ctab_block(data, s, tile, L, y0, ylen)
    lx = lax.dynamic_slice(levels, (s,), (tile,))
    ly = lax.dynamic_slice(levels, (y0,), (ylen,))
    mx = lax.dynamic_slice(maxv, (s,), (tile,))
    my = lax.dynamic_slice(maxv, (y0,), (ylen,))
    return _mi_block_stats_impl(ctab, lx, ly, mx, my, hps, n_obs_min, nz, L)


def _block_scores(kind, accel, data_args, s, start, y0, tile_sz, ylen,
                  L, p, nz, hps, n_obs_min, reliable, max_df):
    """One X-block x Y-slab of the sweep reduced to extraction scores.

    Returns (logp, stat, X, Y, unrel): logp is the log p-value with +inf in
    non-pair/invalid slots and the reliable-only fill for unreliable tests;
    X/Y are global variable indices.  ``X >= start`` dedupes the overlap of
    the re-aligned final block.
    """
    if kind == "mi":
        stat, df, nobs, suff = _mi_stats_block(
            accel, data_args, s, tile_sz, L, y0, ylen, nz, hps, n_obs_min)
        logp = sf.mi_logpval_smalldf(stat, df, nobs, max_df, xp=jnp)
    elif kind == "fznz":
        (data,) = data_args
        r, N = fz_nz_block(data, s, tile_sz, y0, ylen)
        suff = N >= n_obs_min
        stat = jnp.where(suff, r, 0.0)
        logp = sf.fz_logpval(stat, N, 0, xp=jnp)
    else:  # "fz": blocked correlation sweep over centered data
        xc, ssd = data_args
        n = xc.shape[0]
        xslab = lax.dynamic_slice(xc, (0, s), (n, tile_sz))
        yslab = lax.dynamic_slice(xc, (0, y0), (n, ylen))
        # decision-grade precision (see cor_matrix)
        cov = jnp.matmul(xslab.T, yslab, precision=lax.Precision.HIGHEST)
        dx = lax.dynamic_slice(ssd, (s,), (tile_sz,))
        dy = lax.dynamic_slice(ssd, (y0,), (ylen,))
        denom = dx[:, None] * dy[None, :]
        stat = jnp.where(denom > 0, cov / jnp.where(denom > 0, denom, 1.0),
                         jnp.nan)
        stat = jnp.clip(stat, -1.0, 1.0)     # Julia cor clampcor parity
        if n >= n_obs_min:
            # NaN correlations (zero variance) are unreliable like the host
            # path's NaN p-values
            logp = sf.fz_logpval(stat, n, 0, xp=jnp)
            suff = ~jnp.isnan(logp)
        else:
            stat = jnp.zeros_like(stat)
            logp = jnp.zeros_like(stat)
            suff = jnp.zeros(stat.shape, bool)
    t, q = stat.shape
    X = s + lax.broadcasted_iota(jnp.int32, (t, q), 0)
    Y = y0 + lax.broadcasted_iota(jnp.int32, (t, q), 1)
    valid = (X < Y) & (X >= start) & (Y < p)
    fill = jnp.inf if reliable else 0.0
    logp = jnp.where(suff, logp, fill)
    logp = jnp.where(valid, logp, jnp.inf)
    unrel = (valid & ~suff).sum()
    return logp, stat, X, Y, unrel


# ---------------------------------------------------------------------------
# explicit SPMD expression over a device mesh (shard_map)
#
# Each X-block call shards its Y-slab over the mesh's 'd' axis: device d
# computes the (tile, y_len/ndev) stats slab for Y variables
# [y_start + d*ylen_loc, y_start + (d+1)*ylen_loc) from REPLICATED data (an
# OTU table is small relative to HBM: 50k x 100k int8 is 5 GB/device).
# Replication keeps every matmul device-local, so the only collectives in
# the whole univariate pass are a psum of the unreliable-test count and the
# all-gather inside the global BH argsort -- O(n_pairs) scalars once per
# run, over NVLink within a host or the network across hosts.  This is the
# mesh expression of the reference's distributed univariate pass
# (reference: src/tests.jl:474-519 pmap over row-blocks + gather).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=8)
def _mesh_mi_block_fn(mesh, accel, tile, L, ylen_loc, nz, hps, n_obs_min):
    """jit(shard_map) computing one X-block's raw (stat, df, n_obs, suff)
    slabs with the Y-slab sharded over the mesh (the condensed host path;
    the fast path goes through _extract_scan)."""
    n_data = 4 if accel else 3

    def body(*args):
        s, start, y_start = args[n_data:]
        di = lax.axis_index("d").astype(s.dtype)
        y0 = y_start + di * ylen_loc
        return _mi_stats_block(accel, args[:n_data], s, tile, L, y0,
                               ylen_loc, nz, hps, n_obs_min)

    in_specs = (P(),) * (n_data + 3)
    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=in_specs,
                                 out_specs=(P(None, "d"),) * 4,
                                 check_vma=False))


@lru_cache(maxsize=8)
def _mesh_fznz_block_fn(mesh, tile, ylen_loc):
    def body(data, s, start, y_start):
        di = lax.axis_index("d").astype(s.dtype)
        y0 = y_start + di * ylen_loc
        return fz_nz_block(data, s, tile, y0, ylen_loc)

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(),) * 4,
                                 out_specs=(P(None, "d"),) * 2,
                                 check_vma=False))


@lru_cache(maxsize=8)
def _mesh_fz_fn(mesh, ploc):
    """Sharded full correlation matrix: device d computes the (p_int, ploc)
    correlation slab against its own column range via one local matmul."""
    def body(data):
        n = data.shape[0]
        di = lax.axis_index("d")
        y0 = (di * ploc).astype(
            jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
        )
        mu = data.mean(axis=0, keepdims=True)
        xc = data - mu
        ss = (xc * xc).sum(axis=0)
        yslab = lax.dynamic_slice(xc, (0, y0), (n, ploc))
        cov = jnp.matmul(xc.T, yslab, precision=lax.Precision.HIGHEST)
        d_all = jnp.sqrt(ss)
        d_y = lax.dynamic_slice(d_all, (y0,), (ploc,))
        denom = d_all[:, None] * d_y[None, :]
        r = jnp.where(denom > 0, cov / jnp.where(denom > 0, denom, 1.0),
                      jnp.nan)
        return jnp.clip(r, -1.0, 1.0)        # Julia cor clampcor parity

    return jax.jit(jax.shard_map(body, mesh=mesh, in_specs=(P(),),
                                 out_specs=P(None, "d"), check_vma=False))


# ---------------------------------------------------------------------------
# two-pass scan extraction (see the design comment above _block_scores)
# ---------------------------------------------------------------------------

def _extract_edges(alpha: float, n_pairs: int) -> np.ndarray:
    """Decreasing log p-value edges e_0 = log(alpha) .. log(alpha/(4m)).

    Everything below the last edge is automatically BH-significant
    (p < alpha/m implies p <= alpha*rank/m for any rank >= 1), so the edge
    grid only needs to resolve the region where the BH cutoff can fall; the
    geometric spacing bounds extraction overshoot to ~45% of the pair count
    in the cutoff's own bin."""
    la = math.log(alpha)
    return np.linspace(la, la - math.log(4.0 * max(float(n_pairs), 2.0)),
                       N_EXTRACT_BINS)


def _select_bin(counts: np.ndarray, m: float, alpha: float,
                edges: np.ndarray) -> int:
    """Smallest bin index b such that the extraction edge e_b provably
    exceeds every BH-significant p-value.

    A significant p in bin b (edges[b+1] <= log p < edges[b]) satisfies
    p <= alpha * rank(p) / m with rank(p) <= counts[b], so a bin with
    edges[b+1] > log(alpha * counts[b] / m) cannot contain one; the first
    bin violating that bound is the safe (and tight, to one bin) choice.
    Falls through to the auto-significant last bin."""
    la = math.log(alpha)
    lm = math.log(max(m, 1.0))
    for b in range(len(edges) - 1):
        if counts[b] > 0 and edges[b + 1] <= la + math.log(counts[b]) - lm:
            return b
    return len(edges) - 1


def _scan_groups(p_int, tile_sz, slab, ndev=1):
    """Sweep blocks grouped by per-device Y-slab length for lax.scan.

    Returns a static tuple of (ylen_loc, ((s, start, y_start), ...)) groups;
    the triangle slab bucketing keeps this to <= ~8 groups, so the compiled
    sweep program is O(groups), not O(blocks)."""
    by_len: Dict[int, list] = {}
    order = []
    for start in range(0, p_int, tile_sz):
        t = min(tile_sz, p_int - start)
        s = start if t == tile_sz else max(0, p_int - tile_sz)
        y_start, y_len = slab(s)
        ylen_loc = y_len // ndev
        if ylen_loc not in by_len:
            by_len[ylen_loc] = []
            order.append(ylen_loc)
        by_len[ylen_loc].append((s, start, y_start))
    return tuple((yl, tuple(by_len[yl])) for yl in order)


@lru_cache(maxsize=8)
def _passA_fn(mesh, kind, accel, groups, tile_sz, L, p, nz, hps,
              n_obs_min, reliable, max_df, n_data):
    """Counting sweep: per block, cumulative counts of log p below each edge
    (plus the unreliable count), packed as one (nsteps, nbins+1) i32 table.
    Under a mesh each device counts its own Y-slab shard (device-major rows,
    no collectives)."""
    nbins = N_EXTRACT_BINS

    def body(*args):
        data_args = args[:n_data]
        edges = args[n_data]
        di = lax.axis_index("d") if mesh is not None else 0
        rows = []
        for ylen_loc, steps in groups:
            s_a = jnp.asarray([st[0] for st in steps], jnp.int32)
            st_a = jnp.asarray([st[1] for st in steps], jnp.int32)
            ys_a = jnp.asarray([st[2] for st in steps], jnp.int32)

            def step_fn(carry, xs, ylen_loc=ylen_loc):
                s, start, y_start = xs
                idt = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
                s = s.astype(idt)
                y0 = (y_start + di * ylen_loc).astype(idt)
                logp, _, _, _, unrel = _block_scores(
                    kind, accel, data_args, s, start, y0, tile_sz,
                    ylen_loc, L, p, nz, hps, n_obs_min, reliable, max_df)
                # materialize logp ONCE: without the barrier XLA fuses (and
                # so re-evaluates) the whole transcendental logp chain into
                # every per-edge reduction -- ~50x the epilogue cost and a
                # compile-time blowup
                logp = lax.optimization_barrier(logp)
                cnt = (logp.ravel()[:, None] < edges[None, :]).sum(axis=0)
                cnt = jnp.concatenate([cnt.astype(jnp.int32),
                                       unrel.astype(jnp.int32)[None]])
                return carry, cnt

            _, c_g = lax.scan(step_fn, 0, (s_a, st_a, ys_a))
            rows.append(c_g)
        out = jnp.concatenate(rows)
        if mesh is not None:
            # device-major gather -> replicated: every process (multi-host)
            # reads the full count table locally
            out = lax.all_gather(out, "d", tiled=True)
        return out

    if mesh is None:
        return jax.jit(body)
    return jax.jit(jax.shard_map(body, mesh=mesh,
                                 in_specs=(P(),) * (n_data + 1),
                                 out_specs=P(), check_vma=False))


@lru_cache(maxsize=8)
def _passB_fn(mesh, kind, accel, groups, caps, tile_sz, L, p, nz, hps,
              n_obs_min, reliable, max_df, fdr, n_data):
    """Extraction sweep + in-program global BH.

    Each block compacts its logp < e* candidates into an exactly-sized
    buffer (cap per group, from pass A's counts): chunk-occupancy sort
    selects the candidate-bearing 128-wide chunks, a second sort over the
    gathered chunks orders the candidates by p.  All blocks' candidates are
    then globally sorted and log-space BH runs over them -- candidate ranks
    equal all-pairs ranks because every excluded pair has p >= e*.  Returns
      packed  (4, M) int: [X, Y, bitcast log-padj, bitcast stat], p-sorted
      scalars (2,)   int: [n_sig, overflow]  (overflow: a block recounted
              more candidates than pass A -- impossible unless XLA rounds
              the two passes differently; host retries with larger caps)
      recount (nsteps,) i32 per-block candidate recounts (diagnostics)
    """
    CH = 128

    def body(*args):
        data_args = args[:n_data]
        thresh, la, m = args[n_data:]
        dtype = thresh.dtype
        it = jnp.int64 if dtype == jnp.float64 else jnp.int32
        di = lax.axis_index("d") if mesh is not None else 0
        Xs, Ys, lps, sts, recounts = [], [], [], [], []
        for (ylen_loc, steps), cap in zip(groups, caps):
            s_a = jnp.asarray([st[0] for st in steps], jnp.int32)
            st_a = jnp.asarray([st[1] for st in steps], jnp.int32)
            ys_a = jnp.asarray([st[2] for st in steps], jnp.int32)
            E = tile_sz * ylen_loc
            nchunk = -(-E // CH)
            ncap = min(cap, nchunk)          # chunk-selection slots
            ocap = min(cap, nchunk * CH)     # candidate output slots

            def step_fn(carry, xs, ylen_loc=ylen_loc, nchunk=nchunk,
                        ncap=ncap, ocap=ocap, E=E):
                s, start, y_start = xs
                idt = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
                s = s.astype(idt)
                y0 = (y_start + di * ylen_loc).astype(idt)
                logp, stat, X, Y, _ = _block_scores(
                    kind, accel, data_args, s, start, y0, tile_sz,
                    ylen_loc, L, p, nz, hps, n_obs_min, reliable, max_df)
                logp, stat = lax.optimization_barrier((logp, stat))
                lp = logp.ravel()
                stf = stat.ravel().astype(dtype)
                Xf = X.ravel()
                Yf = Y.ravel()
                pad = nchunk * CH - E
                if pad:
                    lp = jnp.concatenate(
                        [lp, jnp.full((pad,), jnp.inf, lp.dtype)])
                    stf = jnp.concatenate([stf, jnp.zeros((pad,), dtype)])
                    Xf = jnp.concatenate([Xf, jnp.zeros((pad,), Xf.dtype)])
                    Yf = jnp.concatenate([Yf, jnp.zeros((pad,), Yf.dtype)])
                mask = lp < thresh
                recount = mask.sum().astype(jnp.int32)
                if ocap == 0:
                    return carry, recount
                # two-level compaction via sized nonzero: candidates arrive
                # UNSORTED (only the final global argsort orders them), and
                # the nonzeros run over only (nchunk,) + (ncap*CH,) elements
                cc = mask.reshape(nchunk, CH).sum(axis=1)
                chunk_sel = jnp.nonzero(cc > 0, size=ncap,
                                        fill_value=nchunk)[0]
                csafe = jnp.where(chunk_sel < nchunk, chunk_sel, 0)
                live = (chunk_sel < nchunk)[:, None]
                glp = jnp.where(live, lp.reshape(nchunk, CH)[csafe], jnp.inf)
                gmask = glp < thresh
                sel = jnp.nonzero(gmask.ravel(), size=ocap,
                                  fill_value=ncap * CH)[0]
                ssafe = jnp.where(sel < ncap * CH, sel, 0)
                cl = jnp.where(sel < ncap * CH,
                               jnp.take(glp.ravel(), ssafe), jnp.inf)
                flat = csafe[ssafe // CH] * CH + (ssafe % CH).astype(jnp.int32)
                return carry, (recount, jnp.take(Xf, flat),
                               jnp.take(Yf, flat), cl, jnp.take(stf, flat))

            if min(cap, nchunk * CH) == 0:
                _, rc_g = lax.scan(step_fn, 0, (s_a, st_a, ys_a))
            else:
                _, (rc_g, cx_g, cy_g, cl_g, cs_g) = lax.scan(
                    step_fn, 0, (s_a, st_a, ys_a))
                Xs.append(cx_g.ravel())
                Ys.append(cy_g.ravel())
                lps.append(cl_g.ravel())
                sts.append(cs_g.ravel())
            recounts.append(rc_g)
        recount = jnp.concatenate(recounts)
        # per-group capacity check against the recount (deterministic
        # recompute; a mismatch can only come from cross-program rounding).
        # Compare LOCALLY (recount and caps_by_step are both (nsteps,) here)
        # before the device-major all_gather widens recount to (ndev*nsteps,).
        caps_by_step = jnp.concatenate([
            jnp.full(len(steps), min(cap, -(-tile_sz * yl // CH) * CH),
                     jnp.int32)
            for (yl, steps), cap in zip(groups, caps)
        ])
        overflow = (recount > caps_by_step).any()
        if mesh is not None:
            recount = lax.all_gather(recount, "d", tiled=True)
            overflow = lax.psum(overflow.astype(jnp.int32), "d") > 0
        X_all = jnp.concatenate(Xs)
        Y_all = jnp.concatenate(Ys)
        lp_all = jnp.concatenate(lps)
        st_all = jnp.concatenate(sts)
        if mesh is not None:
            X_all = lax.all_gather(X_all, "d", tiled=True)
            Y_all = lax.all_gather(Y_all, "d", tiled=True)
            lp_all = lax.all_gather(lp_all, "d", tiled=True)
            st_all = lax.all_gather(st_all, "d", tiled=True)
        order = jnp.argsort(lp_all)
        slog = jnp.take(lp_all, order)
        Xs_ = jnp.take(X_all, order)
        Ys_ = jnp.take(Y_all, order)
        sts_ = jnp.take(st_all, order)
        if fdr:
            M = slog.shape[0]
            ranks = jnp.arange(1, M + 1, dtype=slog.dtype)
            terms = jnp.where(slog < la, slog + jnp.log(m) - jnp.log(ranks),
                              jnp.inf)
            ladj = jnp.minimum(lax.cummin(terms, reverse=True), 0.0)
        else:
            ladj = slog
        n_sig = (ladj < la).sum()
        packed = jnp.stack([
            Xs_.astype(it), Ys_.astype(it),
            lax.bitcast_convert_type(ladj.astype(dtype), it),
            lax.bitcast_convert_type(sts_.astype(dtype), it),
        ])
        scal = jnp.stack([n_sig.astype(it), overflow.astype(it)])
        return packed, scal, recount

    if mesh is None:
        return jax.jit(body)
    return jax.jit(jax.shard_map(body, mesh=mesh,
                                 in_specs=(P(),) * (n_data + 3),
                                 out_specs=(P(), P(), P()),
                                 check_vma=False))


def _extract_scan(kind, data_args, mesh, accel, p_int, tile_sz, slab, p,
                  n_pairs, alpha, FDR, reliable, L=0, nz=False, hps=0.0,
                  n_obs_min=0.0, max_df=0):
    """Host driver of the two-pass extraction; returns the neighbor dicts of
    BH-significant pairs (the fast-path result of pw_univar_neighbors)."""
    ndev = 1 if mesh is None else mesh.devices.size
    groups = _scan_groups(p_int, tile_sz, slab, ndev)
    group_sizes = [len(g[1]) for g in groups]
    nsteps = sum(group_sizes)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    edges = _extract_edges(alpha, n_pairs)
    kw = dict(L=L, nz=nz, hps=float(hps), n_obs_min=float(n_obs_min))
    fA = _passA_fn(mesh, kind, accel, groups, tile_sz, kw["L"], p,
                   kw["nz"], kw["hps"], kw["n_obs_min"], bool(reliable),
                   max_df, len(data_args))
    tbl = np.asarray(fA(*data_args, jnp.asarray(edges, dtype))).astype(
        np.int64)                                   # (ndev*nsteps, nbins+1)
    cnts = tbl[:, :N_EXTRACT_BINS]
    unrel_tot = int(tbl[:, N_EXTRACT_BINS].sum())
    m = n_pairs - (unrel_tot if reliable else 0)
    tot = cnts.sum(axis=0)
    b_hat = _select_bin(tot, m, alpha, edges) if FDR else 0
    K = int(tot[b_hat])
    if K == 0:
        return {i: PSortedNbrs() for i in range(p)}
    if K > EXTRACT_BUDGET:
        raise RuntimeError(
            f"{K} sub-threshold univariate pairs exceed the device "
            f"extraction budget ({EXTRACT_BUDGET}); the network is "
            "pathologically dense at this scale -- raise alpha and/or keep "
            "FDR enabled to shrink the significant set (the host condensed "
            "path is NOT an option here: it allocates O(p^2) float64)"
        )
    # per-group caps: exact per-(device, block) candidate counts at e*
    step_counts = cnts[:, b_hat].reshape(ndev, nsteps)
    offs = np.cumsum([0] + group_sizes)
    caps = []
    for gi in range(len(groups)):
        c = int(step_counts[:, offs[gi]:offs[gi + 1]].max(initial=0))
        caps.append(0 if c == 0 else max(64, 1 << (c - 1).bit_length()))
    overflowed = True
    for _ in range(3):
        fB = _passB_fn(mesh, kind, accel, groups, tuple(caps), tile_sz,
                       kw["L"], p, kw["nz"], kw["hps"], kw["n_obs_min"],
                       bool(reliable), max_df, bool(FDR), len(data_args))
        packed, scal, recount = fB(
            *data_args, jnp.asarray(edges[b_hat], dtype),
            jnp.asarray(math.log(alpha), dtype), jnp.asarray(float(m), dtype))
        sc = np.asarray(scal)
        n_sig = int(sc[0])
        if not int(sc[1]):
            overflowed = False
            break
        rc = np.asarray(recount).reshape(ndev, nsteps)
        warnings.warn(
            "univariate extraction recount exceeded pass-A capacity "
            "(cross-program rounding divergence?); retrying with larger caps"
        )
        caps = []
        for gi in range(len(groups)):
            c = int(rc[:, offs[gi]:offs[gi + 1]].max(initial=0))
            caps.append(0 if c == 0 else max(64, 1 << c.bit_length()))
    if overflowed:
        # never silently return a truncated candidate set: dropped
        # candidates could be BH-significant pairs
        raise RuntimeError(
            "univariate extraction recount still exceeds capacity after 3 "
            "cap-doubling retries; refusing to return a truncated candidate "
            "set (raise alpha, or report this as a compiler rounding bug)"
        )
    # fetch a pow2-padded prefix: ONE transfer, bounded compiled slice shapes
    M_tot = int(packed.shape[1])
    ns_pad = min(max(1 << max(int(n_sig).bit_length(), 10), n_sig), M_tot)
    buf = np.asarray(packed[:, :ns_pad])[:, :n_sig]
    ft = np.float64 if buf.dtype == np.int64 else np.float32
    pvals_sig = np.exp(buf[2].view(ft).astype(np.float64))
    stats_sig = buf[3].view(ft).astype(np.float64)
    Xs_sig = buf[0]
    Ys_sig = buf[1]
    if kind == "fz" and ft == np.float32 and n_sig > 0:
        # refine in float64 on host: the f32 device log-p ordering can swap
        # near-tied candidates, and candidate ORDER feeds the HITON search
        # (a swapped order changes which conditioning subset is recorded as
        # the weakest -- observed as a 6% golden weight drift at prec=32).
        # The extracted stats are HIGHEST-precision matmul outputs
        # (~1e-7), so f64 p-values from them restore the f64 order;
        # BH-adjustment over the extracted prefix is exact because the
        # extraction threshold guarantees these are the top-ranked pairs.
        n_rows = data_args[0].shape[0]
        praw = np.asarray(sf.fz_pval(stats_sig, n_rows, 0), np.float64)
        order = np.argsort(praw, kind="stable")
        praw_s = praw[order]
        if FDR:
            ranks = np.arange(1, n_sig + 1, dtype=np.float64)
            terms = praw_s * (float(m) / ranks)
            adj = np.minimum.accumulate(terms[::-1])[::-1]
            np.minimum(adj, 1.0, out=adj)
        else:
            adj = praw_s
        keep = adj < alpha
        stats_sig = stats_sig[order][keep]
        pvals_sig = adj[keep]
        Xs_sig = Xs_sig[order][keep]
        Ys_sig = Ys_sig[order][keep]
    if n_sig > 0:
        # BH plateaus produce EXACT adjusted-p ties; the host path's
        # candidate order breaks those ties by condensed pair index (its
        # dicts insert in condensed order, then stable-sort by adjusted p),
        # so the dict insertion order here must too -- a swapped tie
        # changes HITON's candidate order and thereby which conditioning
        # subset gets recorded as an edge weight
        cpos = condensed_pos(np.minimum(Xs_sig, Ys_sig),
                             np.maximum(Xs_sig, Ys_sig), p)
        tie_order = np.lexsort((cpos, pvals_sig))
        stats_sig = stats_sig[tie_order]
        pvals_sig = pvals_sig[tie_order]
        Xs_sig = Xs_sig[tie_order]
        Ys_sig = Ys_sig[tie_order]
    nbr = {i: PSortedNbrs() for i in range(p)}
    for x, y, st, pv in zip(Xs_sig, Ys_sig, stats_sig, pvals_sig):
        entry = (float(st), float(pv))
        nbr[int(x)][int(y)] = entry
        nbr[int(y)][int(x)] = entry
    return nbr


class UnivarResult:
    """All-pairs statistics in condensed (X < Y) layout."""

    def __init__(self, p, stats, pvals, suff_power):
        self.p = p
        self.stats = stats          # (n_pairs,) float64, raw stats
        self.pvals = pvals          # (n_pairs,) float64 (NaN = unreliable)
        self.suff_power = suff_power

    def neighbor_dicts(self, alpha: float) -> Dict[int, "OrderedDictType"]:
        """Per-variable neighbor dicts of significant pairs sorted later by
        the caller (reference: src/tests.jl:372-388)."""
        p = self.p
        nbr = {X: {} for X in range(p)}
        with np.errstate(invalid="ignore"):
            sig = self.pvals < alpha        # NaN -> False
        sig_idx = np.nonzero(sig)[0]
        Xs, Ys = condensed_to_pair(sig_idx, p)
        for idx, X, Y in zip(sig_idx, Xs, Ys):
            entry = (float(self.stats[idx]), float(self.pvals[idx]))
            nbr[int(X)][int(Y)] = entry
            nbr[int(Y)][int(X)] = entry
        return nbr


@jax.jit
def _transpose(x):
    return x.T


@lru_cache(maxsize=8)
def _mi_block_host_fn(accel, tile, L, ylen, nz, hps, n_obs_min):
    """One jitted X-block of the condensed (host float64 p-value) path."""
    def fn(*args):
        *data_args, s, y0 = args
        return _mi_stats_block(accel, tuple(data_args), s, tile, L, y0, ylen,
                               nz, hps, n_obs_min)

    return jax.jit(fn)


def pw_univar_neighbors(
    data: np.ndarray,
    test_name: str = "mi",
    alpha: float = 0.01,
    hps: int = 5,
    n_obs_min: int = 0,
    FDR: bool = True,
    levels: Optional[np.ndarray] = None,
    max_vals: Optional[np.ndarray] = None,
    cor_mat: Optional[np.ndarray] = None,
    correct_reliable_only: bool = True,
    tile: Optional[int] = None,
    return_result: bool = False,
    mesh=None,
    data_dev=None,
):
    """All-pairs univariate pass (reference: src/tests.jl:436-532).

    Returns per-variable neighbor dicts {X: {Y: (stat, pval)}} (0-based) of
    FDR-significant pairs; with return_result=True also the condensed
    UnivarResult.  With a mesh, the variable axis is sharded across devices
    so each matmul (and its output slab) is computed SPMD.
    """
    from ..utils.misc import get_levels, get_max_vals

    n, p = data.shape
    nz = is_zero_adjusted(test_name)
    dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    n_pairs = p * (p - 1) // 2
    idx_dt = np.int64 if jax.config.jax_enable_x64 else np.int32

    # pad the variable axis so Y-slabs shard evenly over the mesh; padded
    # columns are all-zero (levels=1) and their pair results are discarded
    ndev = 1
    p_int = p
    tile_sz = _choose_tile(p, tile)
    if mesh is not None:
        from ..parallel.mesh import pad_to_multiple

        ndev = mesh.devices.size
        p0 = p + (-p) % ndev
        tile_sz = min(_choose_tile(p0, tile) + (-_choose_tile(p0, tile)) % ndev,
                      p0)
        data = pad_to_multiple(np.asarray(data), tile_sz, axis=1)
        p_int = data.shape[1]
        if levels is not None:
            levels = np.concatenate(
                [np.asarray(levels), np.ones(p_int - p, np.int32)]
            )
            max_vals = np.concatenate(
                [np.asarray(max_vals), np.zeros(p_int - p, np.int32)]
            )

    def _put(arr, put_dtype=None):
        x = jnp.asarray(arr, dtype=put_dtype or dtype)
        if mesh is not None:
            from ..parallel.mesh import put_replicated

            x = put_replicated(x, mesh)
        return x

    if isdiscrete(test_name):
        if levels is None:
            levels = get_levels(data)
            max_vals = get_max_vals(data)
        L = int(np.max(max_vals)) + 1
        if nz and L == 3 and (np.asarray(max_vals) > 1).all():
            # 3-state nz flag: 2 = nz-UNIFORM (every variable 3-level), which
            # lets the int8 route's epilogue fold all slicing masks
            # statically; truthiness is unchanged for the parity path
            nz = 2
        stats = np.empty(n_pairs)
        df_c = np.empty(n_pairs, dtype=np.int64)
        nobs_c = np.empty(n_pairs, dtype=np.int64)
        suff = np.empty(n_pairs, dtype=bool)
        levels_np = np.asarray(levels, dtype=np.int32)
        maxv_np = np.asarray(max_vals, dtype=np.int32)
        accel = on_accelerator(FORCE_PALLAS) and L < 128
        device_extract = (accel or mesh is not None) and not return_result
        slab = _y_slabs(p_int, tile_sz, triangle=True)
        if accel:
            if data_dev is not None and mesh is None:
                # the caller's int8 upload (levels rode it too)
                data_jT = _transpose(data_dev)
            else:
                data_jT = _put(np.ascontiguousarray(
                    np.asarray(data, dtype=np.int8).T), jnp.int8)
            marg = level_marginals(data_jT, L)
        else:
            data_j = _put(data)
        lvl_j, mv_j = _put(levels_np, jnp.int32), _put(maxv_np, jnp.int32)
        data_args = ((data_jT, marg, lvl_j, mv_j) if accel
                     else (data_j, lvl_j, mv_j))
        if device_extract:
            return _extract_scan(
                "mi", data_args, mesh, accel, p_int, tile_sz, slab, p,
                n_pairs, alpha, FDR, correct_reliable_only, L=L, nz=nz,
                hps=float(hps), n_obs_min=float(n_obs_min),
                max_df=(L - 1) ** 2,
            )
        for start in range(0, p_int, tile_sz):
            t = min(tile_sz, p_int - start)
            # fixed tile size for jit cache: pad the final block
            s = start if t == tile_sz else max(0, p_int - tile_sz)
            y_start, y_len = slab(s)
            if mesh is not None:
                ylen_loc = y_len // ndev
                fn = _mesh_mi_block_fn(
                    mesh, accel, tile_sz, L, ylen_loc, nz, float(hps),
                    float(n_obs_min),
                )
                stat, df, n_obs, sp = fn(*data_args, idx_dt(s),
                                         idx_dt(start), idx_dt(y_start))
            else:
                stat, df, n_obs, sp = _mi_block_host_fn(
                    accel, tile_sz, L, y_len, nz, float(hps),
                    float(n_obs_min))(*data_args, idx_dt(s), idx_dt(y_start))
            _condense_block(
                s, tile_sz, p,
                [np.asarray(stat, np.float64), np.asarray(df),
                 np.asarray(n_obs), np.asarray(sp)],
                [stats, df_c, nobs_c, suff],
                y_start=y_start,
            )
        pvals = sf.mi_pval(stats, df_c, nobs_c)
        pvals = np.where(df_c > 0, pvals, 1.0)
        pvals = np.where(suff, pvals, 1.0)
        stats = np.where(suff, stats, 0.0)
    elif test_name == "fz":
        have_cor = cor_mat is not None and cor_mat.size
        device_extract = ((on_accelerator(FORCE_PALLAS) or mesh is not None)
                          and not return_result and not have_cor)
        if device_extract:
            # blocked correlation sweep: never materializes the p x p matrix
            if data_dev is not None and mesh is None:
                xc, ssd = _fz_center(data_dev)
            else:
                xc, ssd = _fz_center(put_continuous(data, mesh))
            slab = _y_slabs(p_int, tile_sz, triangle=True)
            return _extract_scan(
                "fz", (xc, ssd), mesh, False, p_int, tile_sz, slab, p,
                n_pairs, alpha, FDR, correct_reliable_only,
                n_obs_min=float(n_obs_min),
            )
        if have_cor:
            C = np.asarray(cor_mat, dtype=np.float64)[:p, :p]
        elif mesh is not None:
            ploc = p_int // ndev
            fn = _mesh_fz_fn(mesh, ploc)
            C = np.asarray(fn(_put(data)), dtype=np.float64)[:p, :p]
        else:
            C = np.asarray(cor_matrix(_put(data)), dtype=np.float64)[:p, :p]
        stats = C[np.triu_indices(p, 1)]
        n_obs = np.full(n_pairs, n)
        suff = n_obs >= n_obs_min
        pvals = sf.fz_pval(stats, n_obs, 0)
        stats = np.where(suff, stats, 0.0)
        pvals = np.where(suff, pvals, 1.0)
    elif test_name == "fz_nz":
        if data_dev is not None and mesh is None:
            data_j = data_dev
        else:
            data_j = put_continuous(data, mesh)
        stats = np.empty(n_pairs)
        n_obs = np.empty(n_pairs, dtype=np.int64)
        device_extract = ((on_accelerator(FORCE_PALLAS) or mesh is not None)
                          and not return_result)
        slab = _y_slabs(p_int, tile_sz, triangle=True)
        if device_extract:
            return _extract_scan(
                "fznz", (data_j,), mesh, False, p_int, tile_sz, slab,
                p, n_pairs, alpha, FDR, correct_reliable_only,
                n_obs_min=float(n_obs_min),
            )
        for start in range(0, p_int, tile_sz):
            t = min(tile_sz, p_int - start)
            s = start if t == tile_sz else max(0, p_int - tile_sz)
            y_start, y_len = slab(s)
            if mesh is not None:
                ylen_loc = y_len // ndev
                fn = _mesh_fznz_block_fn(mesh, tile_sz, ylen_loc)
                r, N = fn(data_j, idx_dt(s), idx_dt(start), idx_dt(y_start))
            else:
                r, N = fz_nz_block(data_j, s, tile_sz, y_start, y_len)
            _condense_block(
                s, tile_sz, p,
                [np.asarray(r, np.float64), np.asarray(N, np.int64)],
                [stats, n_obs],
                y_start=y_start,
            )
        # n_obs < n_obs_min -> stat forced to 0 (reference src/tests.jl:121-125)
        stats = np.where(n_obs >= n_obs_min, stats, 0.0)
        suff = n_obs >= n_obs_min
        pvals = sf.fz_pval(stats, n_obs, 0)
    else:
        raise ValueError(f"{test_name} is not a valid test name")

    if correct_reliable_only:
        stats = np.where(suff, stats, np.nan)
        pvals = np.where(suff, pvals, np.nan)

    if FDR:
        m = n_pairs
        if correct_reliable_only:
            m -= int(np.isnan(pvals).sum())
        pvals = sf.benjamini_hochberg(pvals, alpha=alpha, m=m)

    result = UnivarResult(p, stats, pvals, suff)
    nbrs = result.neighbor_dicts(alpha)
    if return_result:
        return nbrs, result
    return nbrs
