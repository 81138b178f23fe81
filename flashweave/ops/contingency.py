"""Contingency tables as one-hot matmuls.

Device replacement for the reference's hand-written sparse merge-join
contingency kernels (reference: src/contingency.jl).  The key re-design: a
contingency table is a product of one-hot encodings,

    ctab[x_level, y_level] = sum_r onehot(X)[r, x_level] * onehot(Y)[r, y_level]

so ALL-PAIRS tables become L^2 (vars x samples) @ (samples x vars) matmuls
that run on the tensor cores, and stratified 3-way tables become batched matmuls with
the (y_level, stratum) axes fused.  Zero-adjustment ("heterogeneous" modes,
reference src/statfuns.jl:313-323) is table-cell slicing, not row trimming:
slicing the full-data table at [x>=ox, y>=oy] counts exactly the rows with
X!=0 / Y!=0, which replaces every nz-aware merge-join special case in the
reference.

The z-stratum hash (reference ZMapper, src/types.jl:26-51) becomes a radix
encoding z_code = sum_j Z_j * L^j.  Empty strata contribute nothing to the
MI statistic and 0 to the adjusted df (max(1, nonzero_margins) - 1 == 0), so
small stratum spaces use the fixed width S = L^max_k directly; when that
blows up (many-level meta variables) the codes are remapped to dense
occupied ranks per test (_remap_strata), capping the width at the point
where the power heuristic would fail anyway (occupied > n/hps).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax



def onehot_encode(data, L):
    """(n, p) integer matrix -> (n, p, L) one-hot in the input float dtype."""
    lv = jnp.arange(L, dtype=jnp.int32)
    return (data[..., None].astype(jnp.int32) == lv).astype(data.dtype)


@partial(jax.jit, static_argnames=("tile", "L", "y_len"))
def pair_ctab_block(data, start, tile, L, y_start=0, y_len=None):
    """Contingency tables of a block of X-variables against a Y-slab
    (default: ALL variables).

    Args:
      data: (n, p) discrete values in 0..L-1 (float dtype for the matmuls).
      start: first X-variable of the block.
      y_start/y_len: Y-variable slab [y_start, y_start+y_len) -- triangle
        sweeps pass y_start <= start so only X < Y work is computed.
    Returns:
      (tile, y_len, L, L) float tables; ctab[t, q, a, b] = #rows with
      X_{start+t} == a and Y_{y_start+q} == b.
    """
    n = data.shape[0]
    if y_len is None:
        y_len = data.shape[1]
    yslab = lax.dynamic_slice(data, (0, y_start), (n, y_len))
    enc = onehot_encode(yslab, L)                          # (n, y_len, L)
    block = lax.dynamic_slice(data, (0, start), (n, tile))
    enc_block = onehot_encode(block, L)                    # (n, tile, L)
    # (tile*L, n) @ (n, y_len*L): one matmul
    a = enc_block.transpose(1, 2, 0).reshape(tile * L, n)
    b = enc.reshape(n, -1)
    ctab = (a @ b).reshape(tile, L, y_len, L)
    return ctab.transpose(0, 2, 1, 3)                      # (tile, y_len, L, L)


def _remap_strata(zcode, row_mask, S_cap):
    """Dense occupied-stratum ranks per test -- the batched, sort-based
    equivalent of the reference's lazy ZMapper (reference: src/types.jl:26-51):
    stratum IDENTITY is irrelevant to the G-test (a sum over strata) and to
    the adjusted df, only distinctness matters, so z-codes are remapped to
    their per-test rank among occupied codes.  This caps the histogram width
    at S_cap instead of L^max_k (32k cells/row at L=8, max_k=3).

    Returns (ranks (n, B) int32 clipped to S_cap-1, occupied (B,) int32).
    Tests whose occupied count exceeds S_cap get merged trailing strata --
    harmless, because occupied > n/hps forces the power check false and the
    statistics are zeroed (the caller receives the EXACT occupied count)."""
    big = jnp.int32(2 ** 30)
    codesT = jnp.where(row_mask > 0, zcode, big).astype(jnp.int32).T  # (B, n)
    order = jnp.argsort(codesT, axis=1)
    sc = jnp.take_along_axis(codesT, order, axis=1)
    new = jnp.concatenate(
        [jnp.ones(sc.shape[:1] + (1,), bool), sc[:, 1:] != sc[:, :-1]],
        axis=1) & (sc < big)
    ranks_sorted = jnp.cumsum(new.astype(jnp.int32), axis=1) - 1
    occ = new.sum(axis=1).astype(jnp.int32)
    inv = jnp.argsort(order, axis=1)
    ranks = jnp.take_along_axis(ranks_sorted, inv, axis=1)
    return jnp.clip(ranks, 0, S_cap - 1).T, occ


def _packed_hist(cell_q, sf, Cq, fdt):
    """Byte-packed cell histogram: 4 cells share one int32 lane.

    cell_q: (n, B) quarter-cell index (values >= Cq never counted);
    sf: (n, B) int32 byte-lane scale 1 << (8 * (cell & 3)), 0 on masked rows.
    Rows are chunked at 128 so every byte lane's per-chunk count <= 128 --
    no cross-byte carries (the 128-count top-byte case survives the final
    arithmetic shift + 0xFF mask exactly).  4x fewer compares than the
    plain (n, B, C) compare-reduce, plus an O(n/128 * B * Cq) unpack, and
    no one-hot intermediate in device memory.  Returns (B, 4 * Cq) counts
    in fdt.
    """
    n, B = cell_q.shape
    pad = (-n) % 128
    if pad:
        cell_q = jnp.concatenate(
            [cell_q, jnp.full((pad, B), Cq, cell_q.dtype)])
        sf = jnp.concatenate([sf, jnp.zeros((pad, B), sf.dtype)])
    nch = (n + pad) // 128
    qr = cell_q.reshape(nch, 128, B)
    sfr = sf.reshape(nch, 128, B)
    acc = ((qr[:, :, :, None] == jnp.arange(Cq, dtype=cell_q.dtype))
           * sfr[:, :, :, None]).sum(axis=1)               # (nch, B, Cq)
    cnt4 = jnp.stack([(acc >> (8 * t)) & 0xFF for t in range(4)], axis=-1)
    return cnt4.sum(axis=0).reshape(B, Cq * 4).astype(fdt)


def cond_ctab_batch(data, X, Y, Zs, kvec, row_mask, B_pad, max_k, L, S,
                    reduced=False):
    """Stratified contingency tables for a batch of (X, Y, Zs) descriptors.

    Replaces the reference's generated sparse N-column merge-join backend
    (reference: src/contingency.jl:300-480).  The table is a fused
    CELL-CODE HISTOGRAM: each row of each test folds (x, y, zcode) into one
    radix cell index and the counts come from a byte-packed compare-reduce
    (_packed_hist) -- no materialized one-hot intermediates.

    Args:
      data: (n, p) discrete values in 0..L-1 (float or int8 dtype).
      X, Y: (B_pad,) int32 column indices.
      Zs:   (B_pad, max_k) int32 conditioning columns (entries >= kvec ignored).
      kvec: (B_pad,) conditioning-set sizes.
      row_mask: (n, B_pad) 0/1 -- rows included per test (the reference's
        dense-path view trimming, src/hiton.jl:41-50).
      S: stratum-table width.  When S < L^max_k the z-codes are remapped to
        dense occupied ranks (see _remap_strata); the second return value is
        then the EXACT per-test occupied-stratum count.
      reduced: every test is nz-adjusted with 3-level X and Y (ox = oy = 1,
        L == 3): the x=0 / y=0 cells are structurally empty (row_mask already
        excludes those rows), so the histogram runs over the (L-1)^2 * S
        sliced cells only -- 2.25x fewer compares -- and the return shape is
        (B_pad, L-1, L-1, S), consumed with ox = oy = 0 downstream.
    Returns:
      ((B_pad, L, L, S) tables over the masked rows ((L-1)^2 when reduced),
       (B_pad,) occupied counts or None when S == L^max_k).
    """
    n = data.shape[0]
    x = jnp.take(data, X, axis=1)                          # (n, B)
    y = jnp.take(data, Y, axis=1)
    # radix z-code with base L (reference ZMapper cum_levels, src/types.jl:32-46)
    zcode = jnp.zeros((n, B_pad), dtype=jnp.int32)
    for j in range(max_k):
        zj = jnp.take(data, Zs[:, j], axis=1).astype(jnp.int32)
        zcode = zcode + jnp.where(j < kvec[None, :], zj * (L ** j), 0)

    occ = None
    if S < L ** max_k:
        zcode, occ = _remap_strata(zcode, row_mask, S)

    fdt = jnp.promote_types(data.dtype, jnp.float32)       # data may be int8
    mask = row_mask > 0
    # masking rides entirely on sf == 0: every row's cell code is in-range
    # regardless of mask, so no OOB rewrite pass is needed
    if reduced:
        # lane = (x-1) + (L-1)(y-1) in [0, 4); quarter = stratum
        lane = (x.astype(jnp.int32) - 1) + (L - 1) * (
            y.astype(jnp.int32) - 1)
        sf = jnp.where(mask, jnp.left_shift(jnp.int32(1), 8 * lane), 0)
        cnt = _packed_hist(zcode, sf, S, fdt)              # (B, 4S)
        Lr = L - 1
        ctab = cnt[:, : Lr * Lr * S].reshape(B_pad, S, Lr, Lr)
        return ctab.transpose(0, 3, 2, 1), occ             # (B, Lr, Lr, S)
    C = L * L * S
    cell = x.astype(jnp.int32) + L * y.astype(jnp.int32) + (L * L) * zcode
    Cq = -(-C // 4)
    sf = jnp.where(mask, jnp.left_shift(jnp.int32(1), 8 * (cell & 3)), 0)
    cnt = _packed_hist(cell >> 2, sf, Cq, fdt)
    # cell = x + L*y + L^2*z  ->  (B, S, y_level, x_level) -> (B, L, L, S)
    return cnt[:, :C].reshape(B_pad, S, L, L).transpose(0, 3, 2, 1), occ


def slice_mask(ctab, ox, oy, xp=jnp):
    """Zero the table cells removed by nz-adjustment (reference:
    src/statfuns.jl:313-323): level-rows a < ox and level-cols b < oy.

    ctab: (..., L, L, S) stratified tables; ox, oy: (...,) int offsets in
    {0, 1}.  Slicing-by-zeroing keeps shapes static for XLA; the statistics in
    ops.statfuns.mi_stats ignore zeroed cells exactly like the reference's
    sub-table views.
    """
    L = ctab.shape[-3]
    a = xp.arange(L)
    b = xp.arange(L)
    keep = (a[:, None, None] >= ox[..., None, None, None]) & (
        b[None, :, None] >= oy[..., None, None, None]
    )
    return ctab * keep.astype(ctab.dtype)
