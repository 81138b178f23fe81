"""Batched conditional independence tests.

Device replacement for the reference's per-subset scalar conditional
tests (reference: src/tests.jl:184-276).  The HITON host loop
(learning/hiton.py) enumerates conditioning subsets and ships them here as
flat fixed-shape batches:

- mi / mi_nz : stratified contingency tables via batched one-hot matmuls
  (ops/contingency.py), then vectorized G-test statistics.  The reference's
  dense-path view trimming (rows with X==0 / Y==0 removed for 3-level
  variables, reference src/hiton.jl:41-50 + src/tests.jl:193-208) becomes a
  row mask folded into the one-hot product.
- fz         : gathers from the precomputed global correlation matrix + the
  pcor recursion DP (ops/statfuns.pcor_dp) -- no device work per test.
- fz_nz      : per-pair masked correlation sub-matrices over rows where both
  target variables are nonzero (reference: src/statfuns.jl:138-155
  ``cor_subset!``), computed as batched masked-moment matmuls, then the same
  pcor DP on host in float64.

Device kernels are jit-cached per (batch-bucket, shape) so the host loop pays
compilation once per bucket.  p-values are finished on host in float64.
"""

from __future__ import annotations

from functools import lru_cache, partial
from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from . import statfuns as sf
from .contingency import cond_ctab_batch
from ..types import TestResult
from ..utils.accel import on_accelerator

# batch-size buckets bound the jit cache (requests are padded up)
BATCH_BUCKETS = (64, 256, 1024, 4096)

# test hook: exercise the on-device digest path on the CPU mesh
FORCE_DEV_DIGEST = False

# test hook: exercise the continuous (fz_nz / on-the-fly fz) device window
# digest on the CPU mesh
FORCE_CONT_DEV = False

# fz conditioning materializes the p x p correlation matrix on the device
# while it (and the Gram temporary that builds it) fits in this share of
# the device's memory limit (fz_cor_materialize_max); beyond it the engine
# computes each batch's (B, m, m) submatrices ON THE FLY from the centered
# device data (identical arithmetic to cor_matrix per entry, one
# HIGHEST-precision Gram per batch).
# Test hook: FORCE_COR_ONFLY / FLASHWEAVE_FZ_ONFLY=1 force the on-fly path.
FZ_COR_MEMORY_SHARE = 0.5
FORCE_COR_ONFLY = False


def fz_cor_materialize_max(itemsize: int, device=None) -> Optional[int]:
    """Largest p whose p x p correlation matrix (plus the equal-sized Gram
    it is built from) fits in FZ_COR_MEMORY_SHARE of ``device``'s memory
    limit; None when the backend reports no limit (the CPU)."""
    device = device or jax.local_devices()[0]
    stats = device.memory_stats() or {}
    limit = stats.get("bytes_limit")
    if not limit:
        return None
    return int((FZ_COR_MEMORY_SHARE * limit / (2 * itemsize)) ** 0.5)

# running count of conditional CI tests dispatched (bench/diagnostics)
N_TESTS_DISPATCHED = 0

# max elements in flight for the gathered (rows, B, m) masked-cor tensor
MCOR_ROW_BUDGET = 1 << 26

# giant round batches dispatch in fixed full-size chunks of this many scan
# segments (one compiled shape reused) plus a pow2-bucketed remainder --
# the former single pow2-padded mega-dispatch wasted up to ~64% of the
# descriptor upload as padding at production scale
CHUNK_SEGS = 1024


def _prefetch(x):
    """Enqueue the device->host copy right after dispatch: the transfer
    overlaps the host's next advance phase, so the later np.asarray returns
    without a blocking round trip."""
    try:
        x.copy_to_host_async()
    except AttributeError:
        pass
    return x


def _bucket(b: int) -> int:
    for s in BATCH_BUCKETS:
        if b <= s:
            return s
    return ((b + BATCH_BUCKETS[-1] - 1) // BATCH_BUCKETS[-1]) * BATCH_BUCKETS[-1]


# pow2 segment-count buckets: every DISTINCT scan shape costs a retrace and
# compile.  The digest NC axis is TIED to the bucket (two variants), so the
# total shape space is ~2x the ladder length and the fn caches never thrash
NSEG_BUCKETS = (4, 8, 16, 32, 64, 128, 256, 512, CHUNK_SEGS)


def _nseg_bucket(k: int) -> int:
    for b in NSEG_BUCKETS:
        if k <= b:
            return b
    return CHUNK_SEGS


# ---------------------------------------------------------------------------
# discrete conditional kernel
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("B", "max_k", "L", "S", "nz", "nzu"))
def _mi_cond_kernel(data, levels, maxv, X, Y, Zs, kvec, hps, B, max_k, L, S,
                    nz, nzu=False):
    """(stat, df, n_obs, suff, levels_z) for B conditional MI tests.

    Mirrors the reference's dense MiTestCond test (reference:
    src/tests.jl:184-229): view trimming -> contingency -> nz slicing ->
    power check n/(lx*ly*lz) > hps -> signed MI + adjusted df.

    ``nzu`` (nz-uniform): every variable in the dataset has 3 levels, so all
    nz offsets are ox = oy = 1 and the x=0 / y=0 table cells are
    structurally empty -- the contingency histogram runs over the sliced
    (L-1)^2 * S cells only (2.25x fewer compares) and the statistics see the
    sliced table directly with zero offsets.  Bit-identical results.
    """
    # data may be device-resident int8 (a quarter of the f32 upload);
    # statistics accumulate in the promoted float dtype
    fdt = jnp.promote_types(data.dtype, jnp.float32)
    x = jnp.take(data, X, axis=1)                     # (n, B)
    y = jnp.take(data, Y, axis=1)
    if nzu:
        ox = jnp.ones(B, jnp.int32)
        oy = jnp.ones(B, jnp.int32)
        mask = (x != 0) & (y != 0)
    elif nz:
        ox = (jnp.take(maxv, X) > 1).astype(jnp.int32)    # (B,)
        oy = (jnp.take(maxv, Y) > 1).astype(jnp.int32)
        mask = ((x != 0) | (ox[None, :] == 0)) & ((y != 0) | (oy[None, :] == 0))
    else:
        ox = jnp.zeros(B, jnp.int32)
        oy = jnp.zeros(B, jnp.int32)
        mask = jnp.ones(x.shape, bool)
    ctab, occ = cond_ctab_batch(data, X, Y, Zs, kvec, mask,
                                B, max_k, L, S, reduced=nzu)
    zeros = jnp.zeros(B, jnp.int32)
    stat, df, n_obs = sf.mi_stats(ctab, zeros if nzu else ox,
                                  zeros if nzu else oy, xp=jnp)
    if occ is None:
        levels_z = (ctab.sum(axis=(1, 2)) > 0).sum(axis=-1)  # occupied strata
    else:
        # compacted-strata mode: the EXACT occupied count (can exceed the
        # table width S; such tests fail the power check below by
        # construction, so their merged-tail tables never matter)
        levels_z = occ
    if nz:
        lx_eff = (L - ox).astype(fdt)
        ly_eff = (L - oy).astype(fdt)
    else:
        lx_eff = jnp.take(levels, X).astype(fdt)
        ly_eff = jnp.take(levels, Y).astype(fdt)
    cells = lx_eff * ly_eff * levels_z.astype(fdt)
    suff = jnp.where(cells > 0, n_obs / jnp.where(cells > 0, cells, 1.0) > hps,
                     True)
    stat = jnp.where(suff, stat, 0.0)
    df = jnp.where(suff, df, 0)
    return stat, df, n_obs, suff


@partial(jax.jit, static_argnames=("B", "max_k", "L", "S", "nz", "nzu",
                                   "pack2"))
def _mi_cond_kernel_packed(data, levels, maxv, X, Y, Zs, kvec, hps, B, max_k,
                           L, S, nz, nzu, pack2=False):
    return _pack4(*_mi_cond_kernel(data, levels, maxv, X, Y, Zs, kvec, hps,
                                   B, max_k, L, S, nz, nzu), pack2=pack2)


def _pack4(stat, df, n_obs, suff, pack2=False):
    """Pack the four result vectors into ONE (4, B) float -- or, when the
    static df bound fits (pack2), (2, B) int -- array, so results ship as a
    single transfer at minimum width (pack2 layout: [bitcast stat,
    df<<21 | n_obs<<1 | suff]; n_obs < 2^20 guaranteed by the engine
    gate)."""
    f = stat.dtype
    if pack2:
        it = jnp.int64 if f == jnp.float64 else jnp.int32
        meta = ((df.astype(it) << 21) | (n_obs.astype(it) << 1)
                | suff.astype(it))
        from jax import lax

        return jnp.stack([lax.bitcast_convert_type(stat, it), meta])
    return jnp.stack([stat, df.astype(f), n_obs.astype(f), suff.astype(f)])


# ---------------------------------------------------------------------------
# explicit batch sharding over the mesh (shard_map)
#
# Conditional-test batches are embarrassingly parallel: each device evaluates
# its slice of the (X, Y, Zs) descriptor batch against the REPLICATED data
# with zero collectives.  This is the mesh expression of the reference's
# @distributed test dispatch
# (reference: src/learning.jl:141-144, src/interleaved.jl:90-93).
# ---------------------------------------------------------------------------

@lru_cache(maxsize=16)
def _sharded_mi_cond_fn(mesh, Bloc, max_k, L, S, nz, nzu, pack2):
    def body(data, levels, maxv, X, Y, Zs, kvec, hps):
        return _pack4(*_mi_cond_kernel(data, levels, maxv, X, Y, Zs, kvec,
                                       hps, Bloc, max_k, L, S, nz, nzu),
                      pack2=pack2)

    def gathered(*args):
        return lax.all_gather(body(*args), "d", axis=1, tiled=True)

    return jax.jit(jax.shard_map(
        gathered, mesh=mesh,
        in_specs=(P(), P(), P(), P("d"), P("d"), P("d"), P("d"), P()),
        out_specs=P(), check_vma=False,
    ))


@lru_cache(maxsize=64)
def _mi_cond_digest_scan_fn(mesh, nseg, Bloc, max_k, L, S, nz, nzu,
                            NC, max_df):
    """Scan kernel + ON-DEVICE per-candidate digest.

    Segment reductions over the mega-batch produce the three scalars the
    fast consume needs per candidate -- first-non-significant index,
    weakest-significant stat, weakest p-value -- so only O(candidates)
    bytes reach the host instead of O(tests) packed results (no per-test
    output exists at all on this path).  Significance classifies by the
    closed-form log p-value; the weakest tie-break (bit-equal log-p ->
    LAST index) matches the host digest's semantics at working precision.
    """
    def fn(data, levels, maxv, X, Y, Zs, kvec, hps, counts, la):
        def body(carry, seg):
            Xs, Ys, Zss, ks = seg
            return carry, _mi_cond_kernel(data, levels, maxv,
                                          Xs.astype(jnp.int32),
                                          Ys.astype(jnp.int32),
                                          Zss.astype(jnp.int32),
                                          ks.astype(jnp.int32),
                                          hps, Bloc, max_k, L, S, nz,
                                          nzu)

        _, (stat, df, nobs, suff) = jax.lax.scan(body, 0, (X, Y, Zs, kvec))
        if mesh is not None:
            stat = lax.all_gather(stat, "d", axis=1, tiled=True)
            df = lax.all_gather(df, "d", axis=1, tiled=True)
            nobs = lax.all_gather(nobs, "d", axis=1, tiled=True)
            suff = lax.all_gather(suff, "d", axis=1, tiled=True)
        stat = stat.reshape(-1)
        df = df.reshape(-1)
        nobs = nobs.reshape(-1)
        suff = suff.reshape(-1)
        # segment bookkeeping is DERIVED ON DEVICE from the (NC,) counts
        # vector: the descriptor upload was the production-scale wall (the
        # (B,) int32 segid/locidx arrays more than doubled it)
        Bp = stat.shape[0]
        ends = jnp.cumsum(counts)
        offsets = ends - counts
        iota = jnp.arange(Bp, dtype=jnp.int32)
        segid = jnp.searchsorted(ends, iota, side="right").astype(jnp.int32)
        segid = jnp.minimum(segid, NC - 1)
        locidx = iota - jnp.take(offsets, segid)
        logp = sf.mi_logpval_smalldf(stat, df, nobs, max_df, xp=jnp)
        logp = lax.optimization_barrier(jnp.where(suff, logp, 0.0))
        sig = logp < la
        BIG = jnp.int32(1 << 30)
        exit_loc = jax.ops.segment_min(
            jnp.where(sig, BIG, locidx), segid, num_segments=NC,
            indices_are_sorted=True)
        exit_e = jnp.where(exit_loc >= BIG, -1, exit_loc)
        M = jax.ops.segment_max(
            jnp.where(sig, logp, -jnp.inf), segid, num_segments=NC,
            indices_are_sorted=True)
        is_w = sig & (logp == jnp.take(M, segid))
        w = jax.ops.segment_max(
            jnp.where(is_w, locidx, -1), segid, num_segments=NC,
            indices_are_sorted=True)
        widx = offsets + jnp.clip(w, 0, None)
        wstat = jnp.take(stat, jnp.clip(widx, 0, stat.shape[0] - 1))
        fdt = stat.dtype
        # the weakest p-value ships in LOG space: exp() of a working-
        # precision log-p underflows to 0 below ~1e-38 in float32, and the
        # consumers compare weakest p-values across windows
        digest = jnp.stack([exit_e.astype(fdt), wstat.astype(fdt),
                            M.astype(fdt)])
        return digest

    if mesh is None:
        return jax.jit(fn)
    return jax.jit(jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(None, "d"), P(None, "d"), P(None, "d"),
                  P(None, "d"), P(), P(), P()),
        out_specs=P(), check_vma=False,
    ))


@lru_cache(maxsize=64)
def _turbo_digest_fn(mesh, nseg, Wc, m, max_k, L, S, nz, nzu, NC, B, U,
                     max_df, bf16):
    """Turbo-window tensor-core kernel + on-device per-slot digest.

    Replaces the per-test histogram for full-target speculative windows
    (the stage's reference counterpart: src/interleaved.jl:42-249 +
    src/contingency.jl:300-480).  Per window of m candidates:

      A  (n, m*Lq)  per-candidate xy-level indicator planes with the nz row
                    mask folded in (an indicator pair (x=a>=1, y=b>=1) is
                    itself the nz mask in the uniform case);
      Bz (n, U*S)   stratum indicator planes of the window's UNION subset
                    family (U = all subsets of the m candidates of size
                    1..min(max_k, m-1); radix z-codes in base L);
      P = A^T @ Bz  ONE batched contraction -- 0/1 products are exact in
                    bf16 (``bf16``, the accelerator path; the parity path
                    contracts in its own float dtype) and f32 accumulation
                    of counts <= n < 2^24 is integer-exact -- yields EVERY
                    (candidate, subset) joint contingency table at once.

    Statistics are computed once per (candidate, subset) PAIR directly in
    P's native (m, Lr_a, Lr_b, U, S) layout -- marginal reductions run
    over the tiny middle level axes while the big (U, S) trailing block
    stays contiguous.  Tests duplicated between the I prefix and the E
    rotation share their pair.  The per-(window, slot) digest maps pairs
    onto a rectangular (NC, maxC) slot grid with ONE exact selection matmul
    (0/1 rows at HIGHEST precision reproduce the selected value exactly)
    and plain axis reductions -- no gathers or segment scatters.
    Windows scan in chunks of Wc; with a mesh the Wc axis shards over
    devices (embarrassingly parallel)."""
    Lq = (L - 1) ** 2 if nzu else L * L
    Lr = L - 1 if nzu else L
    NP_ = m * U                                        # pairs per window

    def fn(data, levels, maxv, Ts, cands, memb, klen, Esel, bias, hps,
           la):
        n = data.shape[0]
        fdt = la.dtype
        mm, acc = (jnp.bfloat16, jnp.float32) if bf16 else (fdt, fdt)
        maxC = Esel.shape[0] // NC
        lv = jnp.arange(1 if nzu else 0, L, dtype=jnp.int32)
        pw = L ** jnp.arange(max_k, dtype=jnp.int32)
        wz = jnp.where(jnp.arange(max_k)[None, :] < klen[:, None],
                       pw[None, :], 0)                       # (U, max_k)
        BIG = jnp.int32(1 << 30)
        iota_c = jnp.arange(maxC, dtype=jnp.int32)
        hi = lax.Precision.HIGHEST

        def step(carry, seg):
            Tw, Cw = seg
            Tw = Tw.astype(jnp.int32)
            Cw = Cw.astype(jnp.int32)
            x = jnp.take(data, Tw, axis=1).astype(jnp.int32)     # (n, Wc)
            ys = jnp.take(data, Cw.reshape(-1), axis=1).reshape(
                n, Wc, m).astype(jnp.int32)
            xo = x[..., None] == lv                              # (n,Wc,Lr)
            yo = ys[..., None] == lv                             # (n,Wc,m,Lr)
            if nzu or not nz:
                A = xo[:, :, None, :, None] & yo[:, :, :, None, :]
            else:
                # generic nz: binary variables keep their zeros (offset 0)
                ox = jnp.take(maxv, Tw) > 1                      # (Wc,)
                oyv = jnp.take(maxv, Cw.reshape(-1)).reshape(Wc, m) > 1
                mask = (((x != 0) | ~ox[None, :])[:, :, None]
                        & ((ys != 0) | ~oyv[None, :, :]))        # (n,Wc,m)
                A = (xo[:, :, None, :, None] & yo[:, :, :, None, :]
                     & mask[..., None, None])
            A2 = A.reshape(n, Wc, m * Lq).astype(mm)
            zm = jnp.take(ys, memb.reshape(-1), axis=2).reshape(
                n, Wc, U, max_k)
            zc = (zm * wz[None, None]).sum(-1)                   # (n,Wc,U)
            Bz = zc[..., None] == jnp.arange(S, dtype=jnp.int32)
            Bz2 = Bz.reshape(n, Wc, U * S).astype(mm)
            P = jnp.einsum("nwa,nwu->wau", A2, Bz2,
                           preferred_element_type=acc)
            # native pair layout: (Wc, m, a, b, U, S); counts in fdt
            P6 = P.reshape(Wc, m, Lr, Lr, U, S).astype(fdt)
            marg_i = P6.sum(axis=3)                    # (Wc,m,a,U,S)
            marg_j = P6.sum(axis=2)                    # (Wc,m,b,U,S)
            marg_k = marg_i.sum(axis=2)                # (Wc,m,U,S)
            n_obs = marg_k.sum(axis=-1)                # (Wc,m,U)
            valid = ((P6 != 0) & (marg_i[:, :, :, None] != 0)
                     & (marg_j[:, :, None] != 0))
            denom = jnp.where(valid, marg_i[:, :, :, None]
                              * marg_j[:, :, None], 1.0)
            term = jnp.where(
                valid, jnp.log((marg_k[:, :, None, None] * P6) / denom)
                * P6, 0.0)
            av = jnp.arange(Lr, dtype=jnp.int32)
            if nzu or not nz:
                diag = (av[:, None] == av[None, :])[None, None, :, :,
                                                    None, None]
            else:
                oxb = ox.astype(jnp.int32)[:, None, None, None, None, None]
                oyb = oyv.astype(jnp.int32)[:, :, None, None, None, None]
                diag = ((av[None, None, :, None, None, None] - oxb)
                        == (av[None, None, None, :, None, None] - oyb))
            mi_pos = jnp.where(diag, term, 0.0).sum(axis=(2, 3, 5))
            mi_neg = jnp.where(diag, 0.0, term).sum(axis=(2, 3, 5))
            n_pos = jnp.where(diag, P6, 0.0).sum(axis=(2, 3, 5))
            n_neg = n_obs - n_pos                      # (Wc,m,U)
            safe_n = jnp.where(n_obs > 0, n_obs, 1.0)
            stat = (mi_pos + mi_neg) / safe_n
            flip = mi_neg * (n_neg / safe_n) > mi_pos * (n_pos / safe_n)
            stat = jnp.where(flip, -stat, stat)
            alx = jnp.maximum((marg_i != 0).sum(axis=2), 1)   # (Wc,m,U,S)
            aly = jnp.maximum((marg_j != 0).sum(axis=2), 1)
            df = ((alx - 1) * (aly - 1)).sum(axis=-1).astype(fdt)
            levels_z = (marg_k > 0).sum(axis=-1)       # (Wc,m,U)
            if nzu:
                lx = ly = jnp.asarray(float(L - 1), fdt)
            elif nz:
                lx = (L - ox.astype(jnp.int32))[:, None, None].astype(fdt)
                ly = (L - oyv.astype(jnp.int32))[:, :, None].astype(fdt)
            else:
                lx = jnp.take(levels, Tw)[:, None, None].astype(fdt)
                ly = jnp.take(levels, Cw)[:, :, None].astype(fdt)
            cells = lx * ly * levels_z.astype(fdt)
            suff = jnp.where(cells > 0,
                             n_obs / jnp.where(cells > 0, cells, 1.0) > hps,
                             True)
            stat = jnp.where(suff, stat, 0.0)
            df = jnp.where(suff, df, 0.0)
            logp = sf.mi_logpval_smalldf(stat, df, n_obs, max_df, xp=jnp)
            logp = lax.optimization_barrier(jnp.where(suff, logp, 0.0))
            # rectangular slot digest: select each slot position's pair
            # scalars with one exact 0/1 matmul, then plain reductions
            pair_f = jnp.stack([logp.reshape(Wc, NP_),
                                stat.reshape(Wc, NP_)])      # (2, Wc, NP_)
            sel = jnp.einsum("cp,twp->twc", Esel, pair_f,
                             precision=hi)                   # (2, Wc, NCmC)
            logp_r = (sel[0] + bias[None, :]).reshape(Wc, NC, maxC)
            stat_r = sel[1].reshape(Wc, NC, maxC)
            sig = logp_r < la                # padded: -1e30 -> always sig
            exit_loc = jnp.where(sig, BIG, iota_c).min(axis=-1)
            exit_e = jnp.where(exit_loc >= BIG, -1, exit_loc)
            M = jnp.where(sig, logp_r, -jnp.inf).max(axis=-1)
            w = jnp.where(sig & (logp_r == M[..., None]), iota_c,
                          -1).max(axis=-1)
            wstat = jnp.where(w[..., None] == iota_c, stat_r,
                              0.0).sum(axis=-1)
            dig = jnp.stack([exit_e.astype(fdt), wstat.astype(fdt),
                             M.astype(fdt)])                 # (3, Wc, NC)
            return carry, dig

        _, digs = lax.scan(step, 0, (Ts, cands))
        return digs                                    # (nseg, 3, Wc, NC)

    if mesh is None:
        return jax.jit(fn)

    def gathered(*args):
        return lax.all_gather(fn(*args), "d", axis=2, tiled=True)

    return jax.jit(jax.shard_map(
        gathered, mesh=mesh,
        in_specs=(P(), P(), P(), P(None, "d"), P(None, "d", None),
                  P(), P(), P(), P(), P(), P()),
        out_specs=P(), check_vma=False,
    ))


@lru_cache(maxsize=64)
def _mi_cond_scan_fn(mesh, nseg, Bloc, max_k, L, S, nz, nzu, pack2):
    """lax.scan of the conditional MI kernel over ``nseg`` fixed-size
    segments -- ONE device dispatch per scheduler round no matter how large
    the round batch, instead of ceil(B/bucket) sequential calls each paying
    dispatch latency.  With a mesh, each segment's batch axis is
    sharded over the devices (embarrassingly parallel, no collectives)."""
    def scan_body(data, levels, maxv, X, Y, Zs, kvec, hps):
        def body(carry, seg):
            Xs, Ys, Zss, ks = seg
            out = _pack4(*_mi_cond_kernel(data, levels, maxv,
                                          Xs.astype(jnp.int32),
                                          Ys.astype(jnp.int32),
                                          Zss.astype(jnp.int32),
                                          ks.astype(jnp.int32),
                                          hps, Bloc, max_k, L, S, nz,
                                          nzu), pack2=pack2)
            return carry, out

        _, outs = jax.lax.scan(body, 0, (X, Y, Zs, kvec))
        return outs                                    # (nseg, 2|4, Bloc)

    if mesh is None:
        return jax.jit(scan_body)

    def gathered(*args):
        return lax.all_gather(scan_body(*args), "d", axis=2, tiled=True)

    return jax.jit(jax.shard_map(
        gathered, mesh=mesh,
        in_specs=(P(), P(), P(), P(None, "d"), P(None, "d"), P(None, "d"),
                  P(None, "d"), P()),
        out_specs=P(), check_vma=False,
    ))


@lru_cache(maxsize=16)
def _sharded_masked_cor_fn(mesh, Bloc, m, plain=False):
    def body(data, X, Y, VI):
        return _masked_cor_kernel(data, X, Y, VI, Bloc, m, plain)

    def gathered(data, X, Y, VI):
        return lax.all_gather(body(data, X, Y, VI), "d", tiled=True)

    return jax.jit(jax.shard_map(
        gathered, mesh=mesh, in_specs=(P(), P("d"), P("d"), P("d")),
        out_specs=P(), check_vma=False,
    ))


# ---------------------------------------------------------------------------
# fz conditional kernel: device-resident correlation matrix
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("B", "max_k"))
def _fz_cond_kernel(C, X, Y, Zs, kvec, B, max_k):
    """Gather the (max_k+2)^2 correlation submatrices of B conditional fz
    tests from the device-resident p x p matrix.  The pcor recursion DP
    itself runs on HOST in float64 (fz_tests_finish): the recursion's
    compounding 1e-5 roundings drift in f32 and flipped a near-threshold
    golden edge at prec=32, while the per-batch (B, m, m) fetch is tiny.
    The device-resident matrix still replaces the host float64 p x p
    requirement (80 GB at p=100k)."""
    karr = jnp.arange(max_k, dtype=kvec.dtype)
    pad = jnp.where(karr[None, :] < kvec[:, None], Zs, X[:, None])
    idx = jnp.concatenate([X[:, None], Y[:, None], pad], axis=1)   # (B, m)
    return C[idx[:, :, None], idx[:, None, :]]


@lru_cache(maxsize=8)
def _sharded_fz_cond_fn(mesh, Bloc, max_k):
    def body(C, X, Y, Zs, kvec):
        out = _fz_cond_kernel(C, X, Y, Zs, kvec, Bloc, max_k)
        return lax.all_gather(out, "d", tiled=True)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(P(), P("d"), P("d"), P("d"), P("d")),
        out_specs=P(), check_vma=False,
    ))


@partial(jax.jit, static_argnames=("B", "max_k"))
def _fz_cond_onfly_kernel(xc, ssd, X, Y, Zs, kvec, B, max_k):
    """Correlation submatrices of B conditional fz tests computed ON THE FLY
    from the centered device data -- the path past the p x p HBM wall
    (reference equivalent: the host-memory all-pairs matrix,
    src/statfuns.jl:125-136, re-sited as per-batch Gram matmuls).

    xc: (n, p) column-centered data; ssd: (p,) per-column sqrt sum of
    squares (ops/univariate._fz_center).  Per entry the arithmetic matches
    cor_matrix exactly (HIGHEST-precision matmul, NaN on zero variance,
    clampcor), so decisions agree with the materialized-matrix path up to
    matmul reduction order (~1e-7 relative in f32).
    Returns (B, m, m) with m = max_k + 2; padded Z columns repeat X."""
    n = xc.shape[0]
    m = max_k + 2
    karr = jnp.arange(max_k, dtype=kvec.dtype)
    pad = jnp.where(karr[None, :] < kvec[:, None], Zs, X[:, None])
    idx = jnp.concatenate([X[:, None], Y[:, None], pad], axis=1)   # (B, m)
    chunk = max(64, min(n, MCOR_ROW_BUDGET // max(B * m, 1)))

    def gram(rows):
        V = jnp.take(rows, idx.reshape(-1), axis=1).reshape(
            rows.shape[0], B, m)
        return jnp.einsum("nbi,nbj->bij", V, V,
                          precision=lax.Precision.HIGHEST)

    if n <= chunk:
        G = gram(xc)
    else:
        n_pad = ((n + chunk - 1) // chunk) * chunk
        xp_ = jnp.pad(xc, ((0, n_pad - n), (0, 0)))   # zero rows: no-ops
        chunks = xp_.reshape(n_pad // chunk, chunk, xc.shape[1])

        def body(acc, rows):
            return acc + gram(rows), None

        G, _ = jax.lax.scan(body, jnp.zeros((B, m, m), xc.dtype), chunks)
    d = jnp.take(ssd, idx)                                         # (B, m)
    denom = d[:, :, None] * d[:, None, :]
    C = jnp.where(denom > 0, G / jnp.where(denom > 0, denom, 1.0), jnp.nan)
    return jnp.clip(C, -1.0, 1.0)


@lru_cache(maxsize=8)
def _sharded_fz_cond_onfly_fn(mesh, Bloc, max_k):
    def body(xc, ssd, X, Y, Zs, kvec):
        out = _fz_cond_onfly_kernel(xc, ssd, X, Y, Zs, kvec, Bloc, max_k)
        return lax.all_gather(out, "d", tiled=True)

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("d"), P("d"), P("d"), P("d")),
        out_specs=P(), check_vma=False,
    ))


def _bucket_pow2(b: int) -> int:
    """Power-of-two padding above the largest fixed bucket (bounds the jit
    cache for arbitrarily large mega-round batches)."""
    s = _bucket(b)
    if s <= BATCH_BUCKETS[-1]:
        return s
    return 1 << (b - 1).bit_length()


# ---------------------------------------------------------------------------
# continuous window digest (fz_nz / on-the-fly fz): per-candidate
# correlations + pcor DP + decision digest, all on device
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _cont_digest_fn(mesh, nseg, NCc, Bseg, mv, max_k, nz, on_x64):
    """Window digest for the continuous modes, computed entirely on device.

    The host-digest path fetches every candidate's (mv, mv) correlation
    matrix (~2 KB each) and digests it per candidate on the host.  Here
    each scan segment computes its candidates' (masked or plain)
    correlation submatrices, evaluates every conditioning subset's partial
    correlation with the batched fixed-depth DP (ops/statfuns.pcor_dp --
    the reference's memoized recursion, src/statfuns.jl:23-75, incl. the
    1e-5 rounding), classifies by the Fisher-z log p-value, and reduces to
    per-candidate (exit, weakest) digests -- only (3, NC) scalars reach
    the host.  f32 on the accelerator path (the recursion's compounding
    roundings can flip tests near alpha vs the host float64 digest);
    bit-comparable f64 under x64 parity runs."""
    def fn(data, VI, POS, KV, counts, la, n_obs_min):
        # data: (n, p) continuous (centered NOT required -- moments below);
        # VI (nseg, NCc, mv) per-candidate var-lists [T, cand, Zs...];
        # POS (nseg, Bseg, max_k) positions into the Zs part; KV sizes;
        # counts (nseg, NCc) per-candidate test counts (padded tail rides
        # the sink candidate NCc-1, never a real candidate)
        n = data.shape[0]
        fdt = la.dtype

        def step(carry, seg):
            VIs, POSs, KVs, cnt = seg
            VIs = VIs.astype(jnp.int32)
            # --- per-candidate correlation submatrices ---------------
            chunk = max(64, min(n, MCOR_ROW_BUDGET // max(NCc * mv, 1)))

            def moments(rows):
                V = jnp.take(rows, VIs.reshape(-1), axis=1).reshape(
                    rows.shape[0], NCc, mv)
                if nz:
                    mk = ((V[:, :, 0] != 0)
                          & (V[:, :, 1] != 0)).astype(rows.dtype)
                    Vm = V * mk[..., None]
                else:
                    mk = jnp.ones(V.shape[:2], rows.dtype)
                    Vm = V
                return (mk.sum(axis=0), Vm.sum(axis=0),
                        jnp.einsum("nbi,nbj->bij", Vm, Vm,
                                   precision=lax.Precision.HIGHEST))

            if n <= chunk:
                nob, S1, G = moments(data)
            else:
                n_pad = ((n + chunk - 1) // chunk) * chunk
                dp_ = jnp.pad(data, ((0, n_pad - n), (0, 0)))
                ch = dp_.reshape(n_pad // chunk, chunk, data.shape[1])

                def body(c, rows):
                    dn, dS, dG = moments(rows)
                    return (c[0] + dn, c[1] + dS, c[2] + dG), None

                (nob, S1, G), _ = jax.lax.scan(
                    body, (jnp.zeros((NCc,), data.dtype),
                           jnp.zeros((NCc, mv), data.dtype),
                           jnp.zeros((NCc, mv, mv), data.dtype)), ch)
            safe_n = jnp.where(nob > 0, nob, 1.0)
            mu = S1 / safe_n[:, None]
            cov = G - safe_n[:, None, None] * mu[:, :, None] * mu[:, None, :]
            d = jnp.sqrt(jnp.maximum(jnp.einsum("bii->bi", cov), 0.0))
            den = d[:, :, None] * d[:, None, :]
            C = jnp.where(den > 0, cov / jnp.where(den > 0, den, 1.0), 0.0)
            C = jnp.clip(C, -1.0, 1.0)

            # --- per-test submatrix extraction + pcor DP -------------
            ends = jnp.cumsum(cnt)
            offs = ends - cnt
            iota = jnp.arange(Bseg, dtype=jnp.int32)
            segid = jnp.searchsorted(ends, iota,
                                     side="right").astype(jnp.int32)
            segid = jnp.minimum(segid, NCc - 1)
            locidx = iota - jnp.take(offs, segid)
            Csel = jnp.take(C.reshape(NCc, mv * mv), segid,
                            axis=0).reshape(Bseg, mv, mv)
            m = max_k + 2
            karr = jnp.arange(max_k, dtype=jnp.int32)
            KVs = KVs.astype(jnp.int32)
            posm = jnp.where(karr[None, :] < KVs[:, None],
                             POSs.astype(jnp.int32) + 2, 0)
            idx = jnp.concatenate(
                [jnp.zeros((Bseg, 1), jnp.int32),
                 jnp.ones((Bseg, 1), jnp.int32), posm], axis=1)  # (B, m)
            # exact gather of each test's (m, m) submatrix
            sub = jnp.take_along_axis(
                jnp.take_along_axis(Csel, idx[:, :, None], axis=1),
                idx[:, None, :], axis=2)                         # (B, m, m)
            stat = sf.pcor_dp(sub, KVs, max_k, xp=jnp)
            nob_t = jnp.take(nob, segid)
            logp = sf.fz_logpval(stat, nob_t, 0, xp=jnp)
            logp = lax.optimization_barrier(
                jnp.where(jnp.isnan(logp), 0.0, logp))
            sig = (logp < la) & (nob_t >= n_obs_min)
            BIG = jnp.int32(1 << 30)
            exit_loc = jax.ops.segment_min(
                jnp.where(sig, BIG, locidx), segid, num_segments=NCc,
                indices_are_sorted=True)
            exit_e = jnp.where(exit_loc >= BIG, -1, exit_loc)
            M = jax.ops.segment_max(
                jnp.where(sig, logp, -jnp.inf), segid, num_segments=NCc,
                indices_are_sorted=True)
            is_w = sig & (logp == jnp.take(M, segid))
            w = jax.ops.segment_max(
                jnp.where(is_w, locidx, -1), segid, num_segments=NCc,
                indices_are_sorted=True)
            widx = offs + jnp.clip(w, 0, None)
            wstat = jnp.take(stat, jnp.clip(widx, 0, Bseg - 1))
            dig = jnp.stack([exit_e.astype(fdt), wstat.astype(fdt),
                             M.astype(fdt)])                # (3, NCc)
            return carry, dig

        _, digs = lax.scan(step, 0, (VI, POS, KV, counts))
        return digs                                    # (nseg, 3, NCc)

    if mesh is None:
        return jax.jit(fn)

    # mesh: shard whole SCAN SEGMENTS over devices (each segment is a
    # closed chunk of candidates + their tests -- embarrassingly parallel)
    def gathered(*args):
        return lax.all_gather(fn(*args), "d", axis=0, tiled=True)

    return jax.jit(jax.shard_map(
        gathered, mesh=mesh,
        in_specs=(P(), P("d"), P("d"), P("d"), P("d"), P(), P()),
        out_specs=P(), check_vma=False,
    ))


# ---------------------------------------------------------------------------
# masked correlation kernel (fz_nz)
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("B", "m", "plain"))
def _masked_cor_kernel(data, X, Y, var_idx, B, m, plain=False):
    """Correlation sub-matrices over rows where X and Y are both nonzero
    (``plain=True``: over ALL rows -- the on-the-fly fz variant).

    var_idx: (B, m) column sets [X, Y, Z_total...] (padded entries repeat X).
    Returns (C, n_obs): (B, m, m) correlations (NaN -> 0, reference
    src/statfuns.jl:150) and (B,) included row counts.

    Rows are processed in chunks via lax.scan when the gathered (n, B, m)
    tensor would exceed the MCOR_ROW_BUDGET working set.
    """
    n = data.shape[0]
    chunk = max(64, min(n, MCOR_ROW_BUDGET // max(B * m, 1)))

    def moments(rows, valid):
        x = jnp.take(rows, X, axis=1)
        y = jnp.take(rows, Y, axis=1)
        if plain:
            mask = jnp.broadcast_to(valid[:, None], x.shape).astype(
                rows.dtype)
        else:
            # zero-padded scan rows fail the nonzero test automatically
            mask = ((x != 0) & (y != 0)).astype(rows.dtype)  # (c, B)
        V = jnp.take(rows, var_idx.reshape(-1), axis=1).reshape(
            rows.shape[0], B, m
        )
        Vm = V * mask[..., None]
        return (
            mask.sum(axis=0),
            Vm.sum(axis=0),
            jnp.einsum("nbi,nbj->bij", Vm, Vm,
                       precision=lax.Precision.HIGHEST,
                       preferred_element_type=rows.dtype),
        )

    if n <= chunk:
        n_obs, S1, G = moments(data, jnp.ones((n,), data.dtype))
    else:
        n_pad = ((n + chunk - 1) // chunk) * chunk
        data_p = jnp.pad(data, ((0, n_pad - n), (0, 0)))   # zero rows: masked out
        chunks = data_p.reshape(n_pad // chunk, chunk, data.shape[1])
        valid = (jnp.arange(n_pad) < n).astype(data.dtype).reshape(
            n_pad // chunk, chunk)

        def body(carry, xs):
            rows, vl = xs
            n_obs, S1, G = carry
            dn, dS, dG = moments(rows, vl)
            return (n_obs + dn, S1 + dS, G + dG), None

        init = (
            jnp.zeros((B,), data.dtype),
            jnp.zeros((B, m), data.dtype),
            jnp.zeros((B, m, m), data.dtype),
        )
        (n_obs, S1, G), _ = jax.lax.scan(body, init, (chunks, valid))
    safe_n = jnp.where(n_obs > 0, n_obs, 1.0)
    mu = S1 / safe_n[:, None]
    cov = G - safe_n[:, None, None] * mu[:, :, None] * mu[:, None, :]
    d = jnp.sqrt(jnp.maximum(jnp.einsum("bii->bi", cov), 0.0))
    denom = d[:, :, None] * d[:, None, :]
    C = jnp.where(denom > 0, cov / jnp.where(denom > 0, denom, 1.0), 0.0)
    # pack (C, n_obs) into ONE (B, m*m + 1) array: a single host fetch
    return jnp.concatenate([C.reshape(B, m * m), n_obs[:, None]], axis=1)


# ---------------------------------------------------------------------------
# host-facing engine
# ---------------------------------------------------------------------------

class CondTestEngine:
    """Holds device-resident data and evaluates flat batches of conditional
    tests, returning reference-semantics TestResults (host float64 p-values)."""

    def __init__(self, data: np.ndarray, test_name: str, max_k: int,
                 levels: Optional[np.ndarray] = None,
                 max_vals: Optional[np.ndarray] = None,
                 cor_mat: Optional[np.ndarray] = None,
                 hps: int = 5, n_obs_min: int = 0,
                 recursive_pcor: bool = True, mesh=None, data_dev=None):
        self.mesh = mesh
        self.test_name = test_name
        self.max_k = max_k
        self.hps = hps
        self.n_obs_min = n_obs_min
        self.nz = test_name.endswith("_nz")
        self.discrete = test_name.startswith("mi")
        self.recursive_pcor = recursive_pcor
        self.n, self.p = data.shape
        self.data_np = np.asarray(data)
        self.levels = None
        dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        accel = on_accelerator()
        if data_dev is not None and mesh is None:
            # ride the caller's existing device-resident table (one upload
            # serves levels + univariate + conditioning)
            self.data_j = data_dev
        elif (self.discrete and accel
                and max_vals is not None and int(np.max(max_vals)) < 128):
            # discrete levels fit int8: a quarter of the f32 upload; the
            # conditional kernel promotes to f32 for statistics
            self.data_j = jnp.asarray(np.asarray(data, dtype=np.int8))
        elif not self.discrete:
            from .univariate import put_continuous

            self.data_j = put_continuous(np.asarray(data), mesh)
        else:
            self.data_j = jnp.asarray(data, dtype=dtype)
        if mesh is not None and self.discrete:
            # continuous tables were already placed by put_continuous
            from ..parallel.mesh import put_replicated

            self.data_j = put_replicated(self.data_j, mesh)
        if self.discrete:
            self.levels = np.asarray(levels, dtype=np.int32)
            self.max_vals = np.asarray(max_vals, dtype=np.int32)
            self.levels_j = jnp.asarray(self.levels)
            self.maxv_j = jnp.asarray(self.max_vals)
            self.L = int(self.max_vals.max()) + 1
            self.S = self.L ** max_k if max_k > 0 else 1
            # occupied-strata cap (ZMapper-equivalent compaction): beyond
            # n/hps occupied strata the power check fails regardless, so the
            # histogram width never needs to exceed it (nor n, the row count)
            cap = self.n if hps <= 0 else min(self.n, int(self.n // hps) + 1)
            self.S_hist = min(self.S, max(int(cap), 1))
            # nz-uniform: every variable 3-level -> all nz offsets are 1 and
            # the contingency kernel can run over the sliced cells only
            self.nzu = bool(self.nz and self.L == 3
                            and (self.max_vals > 1).all())
            # on-device digest path: per-candidate decisions are computed by
            # segment reductions on device and ship as one tiny fetch
            # instead of the packed per-test results.  Default on the
            # accelerator path; on the CPU it stays opt-in (the float64
            # host digest is exact there).  Opt out with
            # FLASHWEAVE_DEV_DIGEST=0.  Decision parity: significance
            # classifies via the f32 closed-form log p-value -- tests
            # within ~1e-7 relative of alpha can flip vs the host float64
            # digest (bounded by tests/test_condtests digest-parity tests).
            import os as _os

            _env = _os.environ.get("FLASHWEAVE_DEV_DIGEST")
            self.dev_digest = (
                (_env == "1" or on_accelerator(FORCE_DEV_DIGEST)
                 and _env != "0")
                and (self.L - 1) ** 2 * self.S_hist <= 128
            )
            # narrow (2, B) result packing needs df < 2^10 (f32 path) and
            # n_obs < 2^20
            self.pack2 = self.n < (1 << 20) and (
                jax.config.jax_enable_x64
                or (self.L - 1) ** 2 * self.S_hist < (1 << 10)
            )
            # turbo-window kernel (see _turbo_digest_fn): one contraction
            # per full-target window computes every (candidate, subset)
            # joint table exactly.  Requires the full radix stratum space
            # (no compaction in play) and the on-device digest's
            # significance semantics (f32 closed-form log-p on the
            # accelerator; bit-exact vs the host digest under x64 parity
            # runs).  Opt out with FLASHWEAVE_TURBO_MXU=0.
            self._turbo_dev_cache = {}
            self.turbo_mxu = (
                _os.environ.get("FLASHWEAVE_TURBO_MXU") != "0"
                and max_k > 0
                and self.S == self.S_hist
                and (self.L - 1) ** 2 * self.S <= 128
                and (self.dev_digest or jax.config.jax_enable_x64))
        self.cor_mat = cor_mat  # host float64 (fz mode, explicit matrix)
        # fz without an explicit host matrix: DEVICE-resident correlation
        # matrix (f32 on the accelerator) + the host pcor DP -- drops the
        # host float64 p x p requirement (80 GB at p=100k).  Beyond the
        # device memory budget for the p x p matrix itself, submatrices are
        # computed ON THE FLY from centered data (_fz_cond_onfly_kernel).
        self.cor_device = False
        self.cor_onfly = False
        if (not self.discrete and not self.nz and recursive_pcor
                and max_k > 0 and cor_mat is None):
            import os as _os

            p_max = fz_cor_materialize_max(self.data_j.dtype.itemsize)
            self.cor_onfly = (
                (p_max is not None and self.p > p_max) or FORCE_COR_ONFLY
                or _os.environ.get("FLASHWEAVE_FZ_ONFLY") == "1")
            if self.cor_onfly:
                from .univariate import _fz_center

                self.xc_j, self.ssd_j = _fz_center(self.data_j)
            else:
                from .univariate import cor_matrix

                self.cor_j = cor_matrix(self.data_j)
            self.cor_device = True
        # continuous window digest ON DEVICE (fz_nz, and fz past the p x p
        # wall): per-candidate correlations + pcor DP + decision digest all
        # stay on device, only (3, NC) scalars reach the host.  Default on
        # the accelerator path; on the CPU the float64 host digest is both
        # exact and fast.  NOTE: classifies via the f32 pcor DP + log-p --
        # the recursion's compounding roundings can flip tests near alpha
        # vs the host float64 digest (tolerance-model bounded; opt out with
        # FLASHWEAVE_CONT_DEV=0).
        self.cont_dev = False
        if not self.discrete and max_k > 0 and (self.nz or
                                                getattr(self, "cor_onfly",
                                                        False)):
            import os as _os

            _env = _os.environ.get("FLASHWEAVE_CONT_DEV")
            self.cont_dev = (_env == "1" or on_accelerator(FORCE_CONT_DEV)
                             and _env != "0")

    # -- discrete -----------------------------------------------------------

    def _desc_dtype(self):
        """Narrowest dtype for variable-id descriptor uploads (the scan
        kernels widen on device)."""
        return np.uint16 if self.p <= (1 << 16) else np.int32

    def mi_tests_begin(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                       kvec: np.ndarray):
        """Launch B conditional MI tests asynchronously (jax dispatch does
        not block); returns an opaque handle for mi_tests_finish.  Lets the
        scheduler overlap host-side bookkeeping with device execution.
        Giant batches dispatch in CHUNK_SEGS-segment chunks."""
        global N_TESTS_DISPATCHED
        B = len(X)
        N_TESTS_DISPATCHED += B
        seg = BATCH_BUCKETS[-1]
        if B <= seg:
            return [self._mi_tests_seg(X, Y, Zs, kvec)]
        max_chunk = CHUNK_SEGS * seg
        return [
            self._mi_tests_scan(X[s0:s0 + max_chunk], Y[s0:s0 + max_chunk],
                                Zs[s0:s0 + max_chunk],
                                kvec[s0:s0 + max_chunk], seg)
            for s0 in range(0, B, max_chunk)
        ]

    def _unpack(self, out, Bp):
        """ONE device fetch -> host (stat, df, n_obs, suff) float64 views."""
        arr = np.asarray(out)
        w = arr.shape[-2] if arr.ndim == 3 else arr.shape[0]
        if arr.ndim == 3:                              # scan: (nseg, w, seg)
            arr = np.moveaxis(arr, 1, 0).reshape(w, Bp)
        if w == 2:
            ft = np.float64 if arr.dtype == np.int64 else np.float32
            stat = arr[0].view(ft).astype(np.float64)
            meta = arr[1]
            df = (meta >> 21).astype(np.int64)
            n_obs = ((meta >> 1) & 0xFFFFF).astype(np.float64)
            suff = (meta & 1) != 0
            return stat, df, n_obs, suff
        return (arr[0].astype(np.float64), arr[1].astype(np.int64),
                arr[2].astype(np.float64), arr[3] != 0)

    def mi_tests_finish(self, handle):
        """Block on a mi_tests_begin handle; returns (stat, pval, df, suff)."""
        stat, df, n_obs, suff = self.mi_tests_finish_lazy(handle)
        pval = np.where(suff, sf.mi_pval(stat, df, n_obs), 1.0)
        return stat, pval, df, suff

    def mi_tests_finish_lazy(self, handle):
        """Block on a mi_tests_begin handle WITHOUT computing p-values;
        returns (stat, df, n_obs, suff) in host float64.  The scheduler
        classifies significance via chi2 thresholds (statfuns.
        chi2_g_threshold) and evaluates gammaincc only on the early-exit
        prefix, so the per-element host p-value pass over the padded
        mega-batch disappears."""
        parts = [self._unpack(out, Bp) for out, _, Bp in handle]
        if len(parts) == 1:
            (stat, df, n_obs, suff), (_, B, _) = parts[0], handle[0]
            return stat[:B], df[:B], n_obs[:B], suff[:B]
        return tuple(
            np.concatenate([p[i][: h[1]] for p, h in zip(parts, handle)])
            for i in range(4)
        )

    def mi_tests_begin_digest(self, X, Y, Zs, kvec, counts, alpha):
        """Launch B conditional MI tests plus their ON-DEVICE per-candidate
        digest (counts: per-candidate test counts; candidates are contiguous
        segments of the batch).  Returns a handle for mi_tests_finish_digest.
        Giant batches split at candidate boundaries into CHUNK_SEGS-segment
        chunks so the descriptor upload carries no pow2-bucket padding."""
        global N_TESTS_DISPATCHED
        B = len(X)
        N_TESTS_DISPATCHED += B
        seg = BATCH_BUCKETS[-1]
        counts = np.asarray(counts, np.int64)
        max_chunk = CHUNK_SEGS * seg
        # candidate cap keeps every chunk in the small tied-NCp shape
        # variant (digest downloads stay a few MB even for tiny-count mixes)
        max_cand = max_chunk // 32
        if B <= max_chunk and len(counts) <= max_cand:
            return [self._digest_chunk(X, Y, Zs, kvec, counts, alpha)]
        bounds = np.cumsum(counts)
        handles = []
        c0 = b0 = 0
        while c0 < len(counts):
            c1 = int(np.searchsorted(bounds, b0 + max_chunk, side="right"))
            c1 = min(max(c1, c0 + 1), c0 + max_cand)
            b1 = int(bounds[c1 - 1])
            handles.append(self._digest_chunk(
                X[b0:b1], Y[b0:b1], Zs[b0:b1], kvec[b0:b1],
                counts[c0:c1], alpha))
            c0, b0 = c1, b1
        return handles

    def _digest_chunk(self, X, Y, Zs, kvec, counts, alpha):
        import math as _math

        B = len(X)
        seg = BATCH_BUCKETS[-1]
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        nseg = _nseg_bucket(-(-B // seg))
        Bp = nseg * seg
        NC_real = len(counts)
        # NCp is TIED to the batch shape (two variants per nseg bucket), not
        # to the candidate count: a free NCp axis would multiply the compiled
        # shape space ~10x
        NCp = Bp // 8 if NC_real < Bp // 8 else Bp + 8
        ddt = self._desc_dtype()
        Xp = np.zeros(Bp, ddt); Xp[:B] = X
        Yp = np.zeros(Bp, ddt); Yp[:B] = Y
        Zp = np.zeros((Bp, self.max_k), ddt); Zp[:B] = Zs
        kp = np.zeros(Bp, np.int8); kp[:B] = kvec
        # padded tail rides the sink segment NCp-1 (never a real candidate);
        # segid/locidx derive from this vector ON DEVICE
        cnt_p = np.zeros(NCp, np.int32)
        cnt_p[:NC_real] = counts
        cnt_p[NCp - 1] += Bp - B
        fdt = (jnp.float64 if jax.config.jax_enable_x64 else jnp.float32)
        fn = _mi_cond_digest_scan_fn(
            self.mesh, nseg, seg // ndev, self.max_k, self.L, self.S_hist,
            self.nz, self.nzu, NCp,
            (self.L - 1) ** 2 * self.S_hist)
        digest = fn(
            self.data_j, self.levels_j, self.maxv_j,
            Xp.reshape(nseg, seg), Yp.reshape(nseg, seg),
            Zp.reshape(nseg, seg, self.max_k), kp.reshape(nseg, seg),
            float(self.hps), jnp.asarray(cnt_p),
            jnp.asarray(_math.log(alpha), fdt))
        return (None, _prefetch(digest), B, Bp, NC_real)

    def mi_tests_finish_digest(self, handle):
        """(exit_e, weakest stat, weakest pval) per candidate -- ONE tiny
        fetch per chunk (this path produces no per-test results)."""
        d = np.concatenate([np.asarray(digest)[:, :nc]
                            for _, digest, _, _, nc in handle], axis=1)
        return _digest_out(d)

    def turbo_tests_begin(self, m: int, Ts: np.ndarray, cands: np.ndarray,
                          alpha: float, tpl: dict):
        """Launch W full-target turbo windows (Ts (W,), cands (W, m));
        ``tpl`` is hiton._turbo_mxu_template(m, max_k).  Every window's
        (candidate, subset) joint tables come from ONE contraction
        (_turbo_digest_fn); only the (3, W, NC) per-slot digest reaches the
        host.  Returns a handle for turbo_tests_finish."""
        global N_TESTS_DISPATCHED
        W = len(Ts)
        B, U, NC = tpl["B"], tpl["U"], tpl["NC"]
        N_TESTS_DISPATCHED += W * B
        S = self.L ** self.max_k
        dev = self._turbo_dev_cache.get(m)
        if dev is None:
            # device-cached template constants: uploaded once per (m, L).
            # Esel maps the rectangular (slot, position) grid onto pair
            # ids (one-hot rows; padded positions all-zero with a -1e30
            # log-p bias so they read as always-significant, never-weakest)
            pairid = tpl["jb"].astype(np.int64) * U + tpl["ub"]
            counts, offs = tpl["counts"], tpl["offs"]
            maxC = int(counts.max())
            fdt = np.float64 if jax.config.jax_enable_x64 else np.float32
            Esel = np.zeros((NC * maxC, m * U), fdt)
            valid_q = np.arange(maxC)[None, :] < counts[:, None]
            rows = (np.arange(NC)[:, None] * maxC
                    + np.arange(maxC)[None, :])[valid_q]
            bvals = (offs[:, None] + np.arange(maxC)[None, :])[valid_q]
            Esel[rows, pairid[bvals]] = 1.0
            bias = np.where(valid_q.reshape(-1), 0.0, -1e30).astype(fdt)
            dev = (jnp.asarray(tpl["memb"]), jnp.asarray(tpl["klen"]),
                   jnp.asarray(Esel), jnp.asarray(bias))
            self._turbo_dev_cache[m] = dev
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        # window-chunk size: the largest power of two whose (n, Wc, U*S)
        # stratum-plane working set stays within 2^26 elements, at most 64,
        # and no larger than the smallest segment ladder needs to hold W
        # windows (a chunk is computed whole, padding included)
        per_w = max(self.n * U * S, 1)
        cap = max(1, 1 << max(0, ((1 << 26) // per_w).bit_length() - 1))
        need = -(-W // NSEG_BUCKETS[0])
        Wc = min(cap, 64, 1 << (need - 1).bit_length())
        Wc = max(Wc, ndev)
        handles = []
        step = Wc * NSEG_BUCKETS[-2]          # cap nseg per dispatch at 512
        for s0 in range(0, W, step):
            handles.append(self._turbo_chunk(
                Ts[s0:s0 + step], cands[s0:s0 + step], alpha, m, Wc, dev,
                NC, B, U))
        return handles

    def _turbo_chunk(self, Ts, cands, alpha, m, Wc, dev, NC, B, U):
        import math as _math

        W = len(Ts)
        need = -(-W // Wc)
        nseg = _nseg_bucket(need)
        Wp = nseg * Wc
        ddt = self._desc_dtype()
        Tp = np.zeros(Wp, ddt); Tp[:W] = Ts
        Cp = np.zeros((Wp, m), ddt); Cp[:W] = cands
        fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        fn = _turbo_digest_fn(
            self.mesh, nseg, Wc // ndev, m, self.max_k, self.L,
            self.L ** self.max_k, self.nz, self.nzu, NC, B, U,
            (self.L - 1) ** 2 * self.S_hist,
            on_accelerator())
        digs = fn(self.data_j, self.levels_j, self.maxv_j,
                  Tp.reshape(nseg, Wc), Cp.reshape(nseg, Wc, m),
                  *dev, float(self.hps), jnp.asarray(_math.log(alpha), fdt))
        return (_prefetch(digs), W, Wc, NC)

    def turbo_tests_finish(self, handles):
        """(exit_e (W, NC) int, wstat (W, NC), wpval (W, NC)) -- the same
        per-slot digest layout the miwin path produces per window."""
        outs = []
        for digs, W, Wc, NC in handles:
            d = np.asarray(digs)                   # (nseg, 3, Wc, NC)
            outs.append(np.moveaxis(d, 1, 0).reshape(3, -1, NC)[:, :W])
        return _digest_out(outs[0] if len(outs) == 1
                           else np.concatenate(outs, axis=1))

    def mi_tests_raw(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                     kvec: np.ndarray):
        """Evaluate B conditional MI tests; Zs shape (B, max_k), padded with 0.
        Returns numpy arrays (stat, pval, df, suff).

        B up to the largest bucket compiles one fixed BATCH_BUCKETS shape;
        larger batches dispatch fixed-size scanned chunks, so a big
        scheduler round never pays per-segment dispatch latency."""
        return self.mi_tests_finish(self.mi_tests_begin(X, Y, Zs, kvec))

    def _mi_tests_scan(self, X, Y, Zs, kvec, seg):
        B = len(X)
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        nseg = _nseg_bucket(-(-B // seg))
        Bp = nseg * seg
        ddt = self._desc_dtype()
        Xp = np.zeros(Bp, ddt); Xp[:B] = X
        Yp = np.zeros(Bp, ddt); Yp[:B] = Y
        Zp = np.zeros((Bp, self.max_k), ddt); Zp[:B] = Zs
        kp = np.zeros(Bp, np.int8); kp[:B] = kvec
        fn = _mi_cond_scan_fn(self.mesh, nseg, seg // ndev, self.max_k,
                              self.L, self.S_hist, self.nz, self.nzu,
                              self.pack2)
        out = fn(                                      # async: (nseg, 4, seg)
            self.data_j, self.levels_j, self.maxv_j,
            Xp.reshape(nseg, seg), Yp.reshape(nseg, seg),
            Zp.reshape(nseg, seg, self.max_k), kp.reshape(nseg, seg),
            float(self.hps),
        )
        return _prefetch(out), B, Bp

    def mi_tests(self, X, Y, Zs, kvec) -> List[TestResult]:
        stat, pval, df, suff = self.mi_tests_raw(X, Y, Zs, kvec)
        return [
            TestResult(float(stat[i]), float(pval[i]), int(df[i]), bool(suff[i]))
            for i in range(len(X))
        ]

    def _mi_tests_seg(self, X, Y, Zs, kvec):
        B = len(X)
        Bp = self._bucket(B)
        Xp = np.zeros(Bp, np.int32); Xp[:B] = X
        Yp = np.zeros(Bp, np.int32); Yp[:B] = Y
        Zp = np.zeros((Bp, self.max_k), np.int32); Zp[:B] = Zs
        kp = np.zeros(Bp, np.int32); kp[:B] = kvec
        if self.mesh is not None:
            fn = _sharded_mi_cond_fn(
                self.mesh, Bp // self.mesh.devices.size, self.max_k, self.L,
                self.S_hist, self.nz, self.nzu, self.pack2,
            )
            out = _prefetch(fn(self.data_j, self.levels_j, self.maxv_j, Xp,
                               Yp, Zp, kp, float(self.hps)))
        else:
            out = _mi_cond_kernel_packed(
                self.data_j, self.levels_j, self.maxv_j,
                Xp, Yp, Zp, kp,
                float(self.hps), Bp, self.max_k, self.L, self.S_hist,
                self.nz, self.nzu, self.pack2,
            )
        return _prefetch(out), B, Bp

    # -- continuous ---------------------------------------------------------

    def masked_cor_begin(self, pairs: Sequence[Tuple[int, int]],
                         var_lists: Sequence[Sequence[int]],
                         plain: bool = False):
        """Launch masked-correlation segments asynchronously (``plain``:
        unmasked, all rows -- the on-the-fly fz host-digest variant)."""
        handles = []
        seg_max = BATCH_BUCKETS[1]  # keep B*n*m memory bounded
        for s in range(0, len(pairs), seg_max):
            handles.append(
                self._masked_cor_seg(pairs[s : s + seg_max],
                                     var_lists[s : s + seg_max], plain)
            )
        return handles

    def masked_cor_finish(self, handles):
        out = []
        for dev, B, Bp, m in handles:
            buf = np.asarray(dev, np.float64)           # ONE fetch per segment
            C = buf[:, : m * m].reshape(Bp, m, m)
            n_obs = buf[:, m * m]
            out.extend((C[i], float(n_obs[i])) for i in range(B))
        return out

    def masked_cor_finish_raw(self, handles):
        """Segment-level finish: (C (Wtot, mv, mv) float64, n_obs (Wtot,))
        with every segment's matrices padded to the round's max variable
        count -- lets the dispatcher digest a whole round's fz_nz windows
        in a handful of vectorized passes instead of per-candidate loops."""
        mv = max(m for _, _, _, m in handles)
        Cs, Ns = [], []
        for dev, B, Bp, m in handles:
            buf = np.asarray(dev, np.float64)
            C = buf[:B, : m * m].reshape(B, m, m)
            if m < mv:
                Cp = np.zeros((B, mv, mv))
                Cp[:, :m, :m] = C
                C = Cp
            Cs.append(C)
            Ns.append(buf[:B, m * m])
        return (Cs[0] if len(Cs) == 1 else np.concatenate(Cs),
                Ns[0] if len(Ns) == 1 else np.concatenate(Ns))

    def masked_cor(self, pairs: Sequence[Tuple[int, int]],
                   var_lists: Sequence[Sequence[int]]):
        """Masked correlation matrices for (T, C) pairs over their variable
        subsets [T, C, Z_total...].  Returns list of (C_sub f64, n_obs)."""
        return self.masked_cor_finish(self.masked_cor_begin(pairs, var_lists))

    def _masked_cor_seg(self, pairs, var_lists, plain=False):
        B = len(pairs)
        m = _bucket_m(max(len(v) for v in var_lists))
        Bp = self._bucket(B)
        X = np.zeros(Bp, np.int32)
        Y = np.zeros(Bp, np.int32)
        VI = np.zeros((Bp, m), np.int32)
        for i, ((x, y), vl) in enumerate(zip(pairs, var_lists)):
            X[i], Y[i] = x, y
            VI[i, : len(vl)] = vl
            VI[i, len(vl):] = x  # pad with X; padded entries never gathered
        if self.mesh is not None:
            fn = _sharded_masked_cor_fn(self.mesh,
                                        Bp // self.mesh.devices.size, m,
                                        plain)
            out = fn(self.data_j, X, Y, VI)
        else:
            out = _masked_cor_kernel(self.data_j, X, Y, VI, Bp, m, plain)
        return _prefetch(out), B, Bp, m

    # max fz tests per device call: the on-the-fly kernel's gathered
    # (rows, B*m) working set must stay bounded (a 4M-test mega-round
    # overflowed the remote compiler), and the materialized gather gains
    # nothing from bigger calls
    FZ_CHUNK = 1 << 16

    # continuous window-digest packing: candidates and their tests pack
    # into fixed (CONT_NCC, CONT_BSEG) scan segments split at candidate
    # boundaries; the last candidate slot is the sink for padded tests
    CONT_NCC = 256
    CONT_BSEG = 8192

    def cont_tests_begin(self, var_lists, POS, KV, counts, alpha):
        """Launch NC continuous candidate windows (fz_nz masked / fz plain)
        with their conditioning-subset tests as ON-DEVICE digests
        (_cont_digest_fn); only the per-candidate (exit, weakest) scalars
        are fetched.  var_lists: per-candidate [T, cand] + Zs; POS (B,
        max_k) positions into the Zs part; counts (NC,) per-candidate test
        counts."""
        global N_TESTS_DISPATCHED
        Bt = len(KV)
        N_TESTS_DISPATCHED += Bt
        NC = len(var_lists)
        mv = _bucket_m(max(len(v) for v in var_lists))
        NCc, Bseg = self.CONT_NCC, self.CONT_BSEG
        cend = np.zeros(NC + 1, np.int64)
        np.cumsum(np.asarray(counts, np.int64), out=cend[1:])
        # greedy segment split at candidate boundaries
        bounds = [0]
        c0 = 0
        while c0 < NC:
            c1 = min(c0 + NCc - 1, NC)
            c1 = min(c1, int(np.searchsorted(cend, cend[c0] + Bseg,
                                             side="right")) - 1)
            c1 = max(c1, c0 + 1)
            bounds.append(c1)
            c0 = c1
        nseg_real = len(bounds) - 1
        ndev = 1 if self.mesh is None else self.mesh.devices.size
        max_nseg = NSEG_BUCKETS[-2]
        handles = []
        for s0 in range(0, nseg_real, max_nseg):
            segs = bounds[s0 : min(s0 + max_nseg, nseg_real) + 1]
            handles.append(self._cont_chunk(
                var_lists, POS, KV, counts, cend, segs, mv, NCc, Bseg,
                ndev, alpha))
        return handles

    def _cont_chunk(self, var_lists, POS, KV, counts, cend, bounds, mv,
                    NCc, Bseg, ndev, alpha):
        import math as _math

        ns_real = len(bounds) - 1
        nseg = _nseg_bucket(ns_real)
        nseg += (-nseg) % ndev
        ddt = self._desc_dtype()
        VIp = np.zeros((nseg, NCc, mv), ddt)
        POSp = np.zeros((nseg, Bseg, self.max_k), np.int8)
        KVp = np.zeros((nseg, Bseg), np.int8)
        CNTp = np.zeros((nseg, NCc), np.int32)
        CNTp[:, NCc - 1] = Bseg            # dummy segments: all sink
        spans = []
        for si in range(ns_real):
            c0, c1 = bounds[si], bounds[si + 1]
            nc = c1 - c0
            for j in range(nc):
                vl = var_lists[c0 + j]
                VIp[si, j, : len(vl)] = vl
            b0, b1 = int(cend[c0]), int(cend[c1])
            POSp[si, : b1 - b0] = POS[b0:b1]
            KVp[si, : b1 - b0] = KV[b0:b1]
            CNTp[si, :nc] = counts[c0:c1]
            CNTp[si, NCc - 1] = Bseg - (b1 - b0)
            spans.append(nc)
        fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        fn = _cont_digest_fn(self.mesh, nseg, NCc, Bseg, mv, self.max_k,
                             self.nz, jax.config.jax_enable_x64)
        digs = fn(self.data_j, jnp.asarray(VIp), jnp.asarray(POSp),
                  jnp.asarray(KVp), jnp.asarray(CNTp),
                  jnp.asarray(_math.log(alpha), fdt),
                  jnp.asarray(float(self.n_obs_min), fdt))
        return (_prefetch(digs), spans)

    def cont_tests_finish(self, handles):
        """(exit_e, wstat, wpval) per candidate, flat across all chunks."""
        parts = []
        for digs, spans in handles:
            d = np.asarray(digs)                  # (nseg, 3, NCc)
            parts.extend(d[si, :, :nc] for si, nc in enumerate(spans))
        return _digest_out(np.concatenate(parts, axis=1))

    def fz_tests_begin(self, X: np.ndarray, Y: np.ndarray, Zs: np.ndarray,
                       kvec: np.ndarray):
        """Launch B fz conditional tests against the device-resident
        correlation data (submatrix gather -- or on-the-fly Gram past the
        p x p HBM budget -- on device; the pcor DP runs in host float64 at
        finish); returns a handle for fz_tests_finish.  Giant mega-round
        batches dispatch in FZ_CHUNK-test chunks (one compiled shape)."""
        global N_TESTS_DISPATCHED
        B = len(X)
        N_TESTS_DISPATCHED += B
        if self.n < self.n_obs_min:
            return [(None, B, None, None)]
        CH = self.FZ_CHUNK
        return [
            self._fz_chunk(X[s:s + CH], Y[s:s + CH], Zs[s:s + CH],
                           kvec[s:s + CH])
            for s in range(0, B, CH)
        ]

    def _fz_chunk(self, X, Y, Zs, kvec):
        B = len(X)
        Bp = self._bucket(B) if B <= BATCH_BUCKETS[-1] else _bucket_pow2(B)
        if self.mesh is not None:
            Bp += (-Bp) % self.mesh.devices.size
        Xp = np.zeros(Bp, np.int32); Xp[:B] = X
        Yp = np.zeros(Bp, np.int32); Yp[:B] = Y
        Zp = np.zeros((Bp, self.max_k), np.int32); Zp[:B] = Zs
        kp = np.zeros(Bp, np.int32); kp[:B] = kvec
        if self.cor_onfly:
            if self.mesh is not None:
                fn = _sharded_fz_cond_onfly_fn(
                    self.mesh, Bp // self.mesh.devices.size, self.max_k)
                out = fn(self.xc_j, self.ssd_j, Xp, Yp, Zp, kp)
            else:
                out = _fz_cond_onfly_kernel(self.xc_j, self.ssd_j, Xp, Yp,
                                            Zp, kp, Bp, self.max_k)
        elif self.mesh is not None:
            fn = _sharded_fz_cond_fn(self.mesh,
                                     Bp // self.mesh.devices.size,
                                     self.max_k)
            out = fn(self.cor_j, Xp, Yp, Zp, kp)
        else:
            out = _fz_cond_kernel(self.cor_j, Xp, Yp, Zp, kp, Bp, self.max_k)
        return (_prefetch(out), B, Bp, np.asarray(kvec, np.int64))

    def fz_tests_finish(self, handle):
        """(stat, pval, df, suff) in host float64 (reference semantics:
        src/tests.jl:250-265 -- df 0, suff is the run-level n_obs check).
        The pcor recursion runs here in float64 incl. the reference's 1e-5
        rounding (src/statfuns.jl:39,51)."""
        if handle[0][0] is None:       # run-level n_obs_min failure
            B = handle[0][1]
            return (np.zeros(B), np.ones(B), np.zeros(B, np.int64),
                    np.zeros(B, bool))
        stats = []
        for out, B, Bp, kvec in handle:
            sub = np.asarray(out).astype(np.float64)[:B]
            kp = np.zeros(B, np.int64); kp[:] = kvec[:B]
            stats.append(sf.pcor_dp(sub, kp, self.max_k, xp=np))
        stat = stats[0] if len(stats) == 1 else np.concatenate(stats)
        pval = np.asarray(sf.fz_pval(stat, self.n, 0))
        B = len(stat)
        return stat, pval, np.zeros(B, np.int64), np.ones(B, bool)

    def fz_tests_raw(self, X, Y, Zs, kvec):
        return self.fz_tests_finish(self.fz_tests_begin(X, Y, Zs, kvec))

    def fz_tests_from_cor_raw(self, C: np.ndarray, pos_X: np.ndarray,
                              pos_Y: np.ndarray, pos_Zs: np.ndarray,
                              kvec: np.ndarray, n_obs: float):
        """Partial-correlation tests from a single correlation matrix C
        (global for fz, per-pair masked for fz_nz).  Positions index into C.
        Returns numpy arrays (stat, pval, df, suff).

        Mirrors reference src/tests.jl:250-265: suff_power is the
        n_obs >= n_obs_min check; pval uses len_z = 0.
        """
        global N_TESTS_DISPATCHED
        B = len(pos_X)
        N_TESTS_DISPATCHED += B
        if n_obs < self.n_obs_min:
            return (np.zeros(B), np.ones(B), np.zeros(B, np.int64),
                    np.zeros(B, bool))
        kvec = np.asarray(kvec, dtype=np.int64)
        pos_Zs = np.asarray(pos_Zs, dtype=np.int64)
        # gather (max_k+2)^2 submatrices: idx[b] = [X, Y, Z_1..Z_maxk(padded X)]
        pad = np.where(
            np.arange(self.max_k)[None, :] < kvec[:, None],
            pos_Zs[:, : self.max_k],
            np.asarray(pos_X, dtype=np.int64)[:, None],
        )
        idx = np.concatenate(
            [np.asarray(pos_X)[:, None], np.asarray(pos_Y)[:, None], pad],
            axis=1,
        )
        sub = C[idx[:, :, None], idx[:, None, :]]
        stat = sf.pcor_dp(sub, kvec, self.max_k, xp=np)
        pval = sf.fz_pval(stat, n_obs, 0)
        return (stat, np.asarray(pval), np.zeros(B, np.int64),
                np.ones(B, bool))

    def fz_tests_from_cor(self, C, pos_X, pos_Y, pos_Zs, kvec,
                          n_obs: float) -> List[TestResult]:
        stat, pval, df, suff = self.fz_tests_from_cor_raw(
            C, pos_X, pos_Y, pos_Zs, kvec, n_obs
        )
        return [
            TestResult(float(stat[i]), float(pval[i]), int(df[i]),
                       bool(suff[i]))
            for i in range(len(pos_X))
        ]

    def _bucket(self, b: int) -> int:
        """Batch bucket, rounded up so it shards evenly over the mesh."""
        Bp = _bucket(b)
        if self.mesh is not None:
            ndev = self.mesh.devices.size
            Bp += (-Bp) % ndev
        return Bp

    def nz_pair_count(self, X: int, Y: int) -> int:
        """Rows where both variables are nonzero (the doubly-trimmed view size)."""
        d = self.data_np
        return int(((d[:, X] != 0) & (d[:, Y] != 0)).sum())

    def fz_tests_iterative(self, X: int, Y: int,
                           Zs_list: Sequence[Tuple[int, ...]]) -> List[TestResult]:
        """Regression-based partial correlation (recursive_pcor=False mode,
        reference: src/statfuns.jl:19-21 + src/tests.jl:250-265)."""
        d = self.data_np.astype(np.float64)
        if self.nz:
            mask = (d[:, X] != 0) & (d[:, Y] != 0)
            d = d[mask]
        n_obs = d.shape[0]
        if n_obs < self.n_obs_min:
            return [TestResult(0.0, 1.0, 0, False)] * len(Zs_list)
        out = []
        for Zs in Zs_list:
            stat = sf.pcor_iterative(X, Y, Zs, d)
            pval = float(sf.fz_pval(np.float64(stat), n_obs, 0))
            out.append(TestResult(stat, pval, 0, True))
        return out


def _digest_out(d):
    """(exit_e int, weakest stat, weakest p-value) in host float64 from a
    (3, ...) device digest whose last row holds the weakest LOG p-value."""
    return (d[0].astype(np.int64), d[1].astype(np.float64),
            np.exp(d[2].astype(np.float64)))


def _bucket_m(m: int) -> int:
    """Pad variable-subset width to bound the jit cache."""
    for s in (8, 16, 32, 64, 128):
        if m <= s:
            return s
    return ((m + 127) // 128) * 128
