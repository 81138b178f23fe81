"""Statistical kernels: Fisher-z, G-test mutual information, BH-FDR, partial
correlation.

Batched re-design of the reference's numeric layer (reference:
src/statfuns.jl).  The array-heavy pieces (contingency tables, correlation
moments) are produced by matmul kernels in ops/contingency.py and
ops/univariate.py; the functions here turn those aggregates into test
statistics.  Every statistic function is written backend-agnostic (``xp`` is
either numpy or jax.numpy), so the exact same formula runs

- on host in float64 for parity-critical p-values (the reference computes all
  stats/p-values in Float64, reference src/types.jl:140-145), and
- on device in float32 inside fully fused jitted pipelines for the
  benchmark/large-scale path.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc as _erfc, gammaincc as _gammaincc

import jax.numpy as jnp
import jax.scipy.special as jsp


# ---------------------------------------------------------------------------
# Fisher-z (continuous tests)
# ---------------------------------------------------------------------------

def fisher_z_transform(p, n, len_z, xp=np):
    """z-statistic of a (partial) correlation (reference: src/statfuns.jl:3-11)."""
    sample_factor = xp.asarray(n - len_z - 3, dtype=xp.float64 if xp is np else None)
    p = xp.asarray(p)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = (xp.sqrt(xp.maximum(sample_factor, 0)) / 2.0) * xp.log((1.0 + p) / (1.0 - p))
    return xp.where(sample_factor > 0, z, 0.0)


def fz_pval(stat, n, len_z, xp=np):
    """Two-sided normal p-value of the Fisher-z statistic (reference:
    src/statfuns.jl:13-17).  ccdf(Normal(), |z|)*2 == erfc(|z|/sqrt(2))."""
    fz_stat = fisher_z_transform(stat, n, len_z, xp=xp)
    erfc = _erfc if xp is np else jsp.erfc
    return erfc(xp.abs(fz_stat) / np.sqrt(2.0))


# ---------------------------------------------------------------------------
# Mutual information / G-test (discrete tests)
# ---------------------------------------------------------------------------

def mi_pval(mi, df, n_obs, xp=np):
    """chi2 p-value of the G statistic 2*MI*n (reference: src/statfuns.jl:157-161).
    ccdf(Chisq(df), g) == gammaincc(df/2, g/2); df <= 0 -> 1.0."""
    g_stat = 2.0 * xp.abs(mi) * n_obs
    df = xp.asarray(df)
    gammaincc = _gammaincc if xp is np else jsp.gammaincc
    safe_df = xp.where(df > 0, df, 1)
    pval = gammaincc(safe_df / 2.0, g_stat / 2.0)
    return xp.where(df > 0, pval, 1.0)


_chi2_thr_cache: dict = {}


def chi2_g_threshold(alpha: float, max_df: int) -> np.ndarray:
    """Per-df significance thresholds on the scaled G statistic x = |mi|*n.

    thr[d] solves gammaincc(d/2, thr[d]) == alpha, so
    ``mi_pval(mi, df, n) < alpha  <=>  |mi|*n > thr[df]`` for integer df >= 1
    (df <= 0 maps to pval 1.0, thr[0] = inf).  Lets the scheduler classify
    significance over a mega-batch WITHOUT evaluating gammaincc per element;
    exact p-values are then computed only on the early-exit prefix -- the
    tests the reference's sequential loop would actually have evaluated
    (reference: src/tests.jl:326-336)."""
    arr = _chi2_thr_cache.get(alpha)
    if arr is None or len(arr) <= max_df:
        from scipy.special import gammainccinv

        d = np.arange(1, max_df + 1, dtype=np.float64)
        arr = np.concatenate([[np.inf], gammainccinv(d / 2.0, alpha)])
        _chi2_thr_cache[alpha] = arr
    return arr


def mi_pval_smalldf(mi, df, n_obs, max_df, xp=jnp):
    """chi2 p-value of the G statistic via closed forms for small integer df.

    Univariate tables have df <= (L-1)^2, where the chi2 survival function
    reduces to exp/erfc polynomials -- on device this replaces the iterative
    ``gammaincc`` series (which costs more than the contingency matmuls
    themselves).  With x = g/2:
      df=2k   : Q = e^{-x} * sum_{i<k} x^i / i!
      df=2k+1 : Q = erfc(sqrt(x)) + e^{-x} * sum_{1<=i<=k} x^{i-1/2}/G(i+1/2)
    Exactly matches mi_pval for integer 0 <= df <= max_df (df<=0 -> 1.0).
    """
    x = xp.abs(mi) * xp.asarray(n_obs, dtype=mi.dtype)   # g/2 = |mi| * n
    erfc = _erfc if xp is np else jsp.erfc
    ex = xp.exp(-x)
    sx = xp.sqrt(x)
    er = erfc(sx)
    from math import gamma as _gamma

    branches = []
    for d in range(1, max_df + 1):
        k = d // 2
        if d % 2 == 0:
            poly = xp.ones_like(x)
            term = xp.ones_like(x)
            for i in range(1, k):
                term = term * x / i
                poly = poly + term
            branches.append(ex * poly)
        else:
            q = er
            for i in range(1, k + 1):
                q = q + ex * x ** (i - 0.5) / _gamma(i + 0.5)
            branches.append(q)
    df = xp.asarray(df)
    out = xp.ones_like(x)
    for d, b in zip(range(1, max_df + 1), branches):
        out = xp.where(df == d, b, out)
    return out


def log_erfc(z, xp=jnp):
    """log(erfc(z)) for z >= 0, stable far into the tail.

    Direct evaluation underflows (f32 at z ~ 9, f64 at z ~ 26); beyond that
    the 3-term asymptotic expansion erfc(z) ~ e^{-z^2}/(z sqrt(pi)) *
    (1 - 1/(2 z^2) + 3/(4 z^4)) is accurate to ~1e-7 relative."""
    erfc = _erfc if xp is np else jsp.erfc
    zs = xp.maximum(z, 1e-30)
    small = xp.log(xp.maximum(erfc(xp.minimum(z, 8.0)), 1e-300))
    z2 = zs * zs
    large = (-z2 - xp.log(zs * np.sqrt(np.pi))
             + xp.log1p(-1.0 / (2.0 * z2) + 3.0 / (4.0 * z2 * z2)))
    return xp.where(z < 8.0, small, large)


def _logsumexp2(a, b, xp):
    m = xp.maximum(a, b)
    m = xp.where(xp.isfinite(m), m, 0.0)  # both -inf
    return m + xp.log(xp.exp(a - m) + xp.exp(b - m))


def mi_logpval_smalldf(mi, df, n_obs, max_df, xp=jnp):
    """log of the chi2 G-test p-value for small integer df, computed in log
    space so ultra-significant pairs keep a total order (float p-values
    underflow to indistinguishable 0 around g ~ 180 in f32 / 1420 in f64;
    the BH ranking and the HITON candidate order both sort by p-value).
    Matches log(mi_pval(...)) for integer 0 <= df <= max_df.

    The per-df series are built INCREMENTALLY: each branch's logsumexp
    chain is a prefix of the next (same accumulation order, bit-identical
    values), so the total cost is O(max_df) chained logsumexps instead of
    the O(max_df^2/4) independent re-evaluations of the naive unroll --
    at max_df ~ 100 (conditional digests) this was the dominant elementwise cost
    of the digest kernels."""
    from math import lgamma as _lgamma

    x = xp.abs(mi) * xp.asarray(n_obs, dtype=mi.dtype)   # g/2
    logx = xp.log(xp.maximum(x, 1e-300))
    sx = xp.sqrt(x)
    ler = log_erfc(sx, xp=xp)

    df = xp.asarray(df)
    out = xp.zeros_like(x)                                # df <= 0 -> log 1
    # even d = 2k: Q = e^{-x} sum_{i<k} x^i / i!; running chain over i
    acc_e = xp.zeros_like(x)                              # i = 0 term
    # odd d = 2k+1: Q = erfc(sqrt(x)) + e^{-x} sum_{1<=i<=k} x^{i-1/2} /
    # Gamma(i+1/2); running chain over i (None until k >= 1)
    acc_o = None
    for d in range(1, max_df + 1):
        k = d // 2
        if d % 2 == 0:
            logq = -x + acc_e if k > 1 else -x
            # extend the chain for the NEXT even branch (i = k term)
            acc_e = _logsumexp2(acc_e, k * logx - _lgamma(k + 1), xp)
        else:
            if k == 0:
                logq = ler
            else:
                t = (k - 0.5) * logx - _lgamma(k + 0.5)
                acc_o = t if acc_o is None else _logsumexp2(acc_o, t, xp)
                logq = _logsumexp2(ler, -x + acc_o, xp)
        out = xp.where(df == d, logq, out)
    return xp.minimum(out, 0.0)


def fz_logpval(stat, n, len_z, xp=jnp):
    """log of the two-sided Fisher-z normal p-value (log-space counterpart
    of fz_pval): log(erfc(|z|/sqrt(2)))."""
    fz_stat = fisher_z_transform(stat, n, len_z, xp=xp)
    return log_erfc(xp.abs(fz_stat) / np.sqrt(2.0), xp=xp)


def mi_stats(ctab, ox, oy, signed=True, xp=np):
    """Batched signed mutual information + adjusted df from stratified
    contingency tables.

    Vectorized re-expression of the reference's scalar loops (reference:
    src/statfuns.jl:163-254 ``mutual_information`` and :281-305 ``adjust_df``).
    The 2-way test is the single-stratum case (S=1); the reference's nz
    sub-table slicing (src/statfuns.jl:313-323) is expressed by ZEROING the
    sliced-away cells beforehand and passing the slice offsets ``ox, oy`` in
    {0,1} (0-based) so the diagonal test ``i == j`` of the SUB-table becomes
    ``(a - ox) == (b - oy)`` on the full table.

    Args:
      ctab: (..., L, L, S) contingency counts, float; invalid cells zeroed.
      ox, oy: (...,) int offsets of the valid region (0 or 1).
    Returns:
      (mi_stat, df, n_obs) with shapes (...,), matching reference semantics:
      mi = (sum_terms)/n_obs with sign from diag-vs-offdiag contributions;
      df = sum over strata of (nonzero_rows-1)*(nonzero_cols-1) (min 1 each).
    """
    ctab = ctab.astype(xp.float64 if xp is np else ctab.dtype)
    L = ctab.shape[-2]
    marg_i = ctab.sum(axis=-2)                    # (..., L, S)
    marg_j = ctab.sum(axis=-3)                    # (..., L, S)
    marg_k = marg_i.sum(axis=-2)                  # (..., S)
    n_obs = marg_k.sum(axis=-1)                   # (...,)

    mik = marg_i[..., :, None, :]
    mjk = marg_j[..., None, :, :]
    mk = marg_k[..., None, None, :]
    valid = (ctab != 0) & (mik != 0) & (mjk != 0)
    denom = xp.where(valid, mik * mjk, 1.0)
    ratio = xp.where(valid, (mk * ctab) / denom, 1.0)
    term = xp.where(valid, xp.log(ratio) * ctab, 0.0)

    a_idx = np.arange(L)[:, None, None]           # static; broadcasts over (L, L, S)
    b_idx = np.arange(L)[None, :, None]
    a_idx = xp.asarray(a_idx)
    b_idx = xp.asarray(b_idx)
    diag = (a_idx - ox[..., None, None, None]) == (b_idx - oy[..., None, None, None])

    mi_pos = xp.where(diag, term, 0.0).sum(axis=(-3, -2, -1))
    mi_neg = xp.where(diag, 0.0, term).sum(axis=(-3, -2, -1))
    n_pos = xp.where(diag, ctab, 0.0).sum(axis=(-3, -2, -1))
    n_neg = n_obs - n_pos

    safe_n = xp.where(n_obs > 0, n_obs, 1.0)
    mi_stat = (mi_pos + mi_neg) / safe_n
    if signed:
        flip = mi_neg * (n_neg / safe_n) > mi_pos * (n_pos / safe_n)
        mi_stat = xp.where(flip, -mi_stat, mi_stat)

    # adjusted degrees of freedom (reference: src/statfuns.jl:281-305)
    alx = xp.maximum((marg_i != 0).sum(axis=-2), 1)   # (..., S)
    aly = xp.maximum((marg_j != 0).sum(axis=-2), 1)
    df = ((alx - 1) * (aly - 1)).sum(axis=-1)

    return mi_stat, df, n_obs


def sufficient_power(levels_x, levels_y, n_obs, hps, levels_z=None, xp=np):
    """Heuristic power criterion (reference: src/tests.jl:5-6).  Zero level
    products follow Julia's n/0 == Inf > hps semantics."""
    cells = levels_x * levels_y * (levels_z if levels_z is not None else 1)
    cells = xp.asarray(cells, dtype=jnp.float32 if xp is jnp else np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = xp.where(cells > 0, n_obs / xp.where(cells > 0, cells, 1.0), xp.inf)
    return ratio > hps


# ---------------------------------------------------------------------------
# Partial correlation (recursive DP, matches pcor_rec incl. 1e-5 rounding)
# ---------------------------------------------------------------------------

def pcor_dp(C, kvec, max_k, xp=np):
    """Batched recursive partial correlation.

    Evaluates the reference's memoized recursion (reference:
    src/statfuns.jl:23-75 ``pcor_rec``) as a dense dynamic program: step t
    conditions every pair among {X, Y, Z_1..Z_k} on Z_t, which is exactly the
    recursion's prefix structure (Z_k is split off last).  Includes the
    reference's 5-digit rounding of the numerator and the [-1, 1) clamp at
    every node, so results agree bit-for-bit in float64.

    Args:
      C: (..., m, m) correlation submatrices; index 0 = X, 1 = Y, 2.. = Zs
         (padded columns beyond k are ignored via kvec masking).
      kvec: (...,) number of conditioning variables per item.
      max_k: static maximum conditioning-set size.
    Returns:
      (...,) pcor(X, Y | Z_1..Z_k).
    """
    C = xp.asarray(C)
    kvec = xp.asarray(kvec)
    for t in range(max_k):
        z = t + 2
        cz = C[..., :, z]                                  # (..., m)
        num = C - cz[..., :, None] * cz[..., None, :]
        num = xp.round(num * 1e5) / 1e5
        dvec = xp.sqrt(xp.maximum(1.0 - cz * cz, 0.0))
        den = dvec[..., :, None] * dvec[..., None, :]
        P = xp.where(den == 0.0, 0.0, num / xp.where(den == 0.0, 1.0, den))
        P = xp.where(P < -1.0, -1.0, P)
        P = xp.where(P >= 1.0, 1.0, P)
        C = xp.where((t < kvec)[..., None, None], P, C)
    return C[..., 0, 1]


def pcor_iterative(X, Y, Zs, data):
    """Direct partial correlation via linear regression (reference:
    src/statfuns.jl:19-21 using StatsBase.partialcor).  Host-only; used for
    the recursive_pcor=False cross-check mode."""
    data = np.asarray(data, dtype=np.float64)
    x = data[:, X]
    y = data[:, Y]
    Z = data[:, list(Zs)]
    Z1 = np.column_stack([np.ones(len(x)), Z])
    bx, *_ = np.linalg.lstsq(Z1, x, rcond=None)
    by, *_ = np.linalg.lstsq(Z1, y, rcond=None)
    rx = x - Z1 @ bx
    ry = y - Z1 @ by
    denom = np.sqrt((rx * rx).sum() * (ry * ry).sum())
    if denom == 0:
        return 0.0
    return float((rx * ry).sum() / denom)


# ---------------------------------------------------------------------------
# Benjamini-Hochberg FDR
# ---------------------------------------------------------------------------

def benjamini_hochberg(pvals, alpha=0.01, m=None):
    """Accelerated BH correction on the significant tail (reference:
    src/statfuns.jl:326-350).

    Returns a NEW array: entries with raw p < alpha hold the adjusted p-value,
    all others (including NaN unreliable tests) are NaN.  ``m`` is the number
    of tests used for correction (may exclude unreliable tests, reference
    src/tests.jl:521-528)."""
    p = np.asarray(pvals, dtype=np.float64)
    out = np.full(p.shape, np.nan)
    if p.size == 0:
        return out
    if m is None:
        m = p.size
    with np.errstate(invalid="ignore"):
        mask = p < alpha                       # NaN compares False
    idx = np.nonzero(mask)[0]
    if idx.size == 0:
        return out
    order = np.argsort(p[idx], kind="stable")
    sidx = idx[order]
    sp = p[sidx]
    nf = sp.size
    # reversed running minimum of sp[i] * m / (i+1), capped at 1 -- the
    # vectorized form of the reference's descending min loop (same
    # left-to-right operation order, so values are bit-identical)
    terms = sp * float(m) / np.arange(1.0, nf + 1.0)
    adj = np.minimum.accumulate(terms[::-1])[::-1]
    np.minimum(adj, 1.0, out=adj)
    out[sidx] = adj
    return out
