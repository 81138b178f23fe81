"""Data preprocessing / normalization.

Faithful re-implementation of the reference's preprocessing layer (reference:
src/preprocessing.jl): CLR-family normalizations (plain, adaptive-pseudocount,
nonzero-only), TSS row normalization, presence/absence, rank-based
discretization (plain and nonzero-aware), one-hot meta-variable encoding,
variance/zero filtering, and multi-experiment combining.

These transforms run once per dataset on host in float64 (the reference also
normalizes in Float64 and casts afterwards, reference
src/preprocessing.jl:325-346, misc.jl:54-62); the device data plane receives the
final dense matrix.  Sparse storage is a CPU memory optimization in the
reference -- on the device zeros are SEMANTIC (the `_nz` modes) and are represented
as dense values + masks, so the DEVICE layout is always dense.

HOST-side sparse ingestion is supported end-to-end (reference sparse-first
pipeline: src/preprocessing.jl:178,579-594): scipy.sparse inputs stay sparse
through filtering and the zero-preserving normalizations (presence/absence,
TSS, CLR-over-nonzeros, nz-binning), which stream column/row chunks through
the exact dense kernels into the final target-precision matrix -- a
50k x 100k table never materializes as dense float64 (40 GB); it goes
straight to the ~5-20 GB prec-16/32 result.  The zero-filling normalizations
(`clr`, `clr_adapt`) inherently densify and fall back to dense with a
warning.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
from scipy.stats import rankdata

from .utils.misc import get_levels


class NormalizedData(NamedTuple):
    data: np.ndarray
    header: List[str]
    meta_mask: np.ndarray
    obs_filter_mask: np.ndarray


# ---------------------------------------------------------------------------
# factor / one-hot encoding (reference: src/preprocessing.jl:42-117)
# ---------------------------------------------------------------------------

def _is_numeric_value(v) -> bool:
    return isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(
        v, bool
    )


def factors_to_ints_vec(x: np.ndarray) -> np.ndarray:
    # reference: src/preprocessing.jl:42-50 (string factors -> 1-based ints)
    if len(x) > 0 and isinstance(x[0], str):
        cats = sorted(set(x))
        fmap = {c: i + 1 for i, c in enumerate(cats)}
        return np.array([fmap[xi] for xi in x], dtype=np.float64)
    return np.asarray(x, dtype=np.float64)


def check_onehot(x: np.ndarray) -> Tuple[bool, list]:
    # reference: src/preprocessing.jl:59-68
    if len(x) > 0 and _is_numeric_value(x[0]):
        return False, []
    cats = sorted(set(x))
    return len(cats) > 2, cats


def onehot_vec(x: np.ndarray, var_name: str = "", check: bool = True):
    # reference: src/preprocessing.jl:71-88
    needs, cats = check_onehot(x)
    if not check or needs:
        cols, names = [], []
        for cat in cats:
            cols.append((np.asarray(x) == cat).astype(np.float64))
            if var_name:
                names.append(f"{var_name}_{cat}")
        return np.column_stack(cols), names
    return factors_to_ints_vec(x)[:, None], [var_name]


def onehot(
    X: np.ndarray, vnames: Optional[Sequence[str]] = None, check: bool = True,
    verbose: bool = True,
):
    # reference: src/preprocessing.jl:91-117
    vnames = list(vnames) if vnames else []
    results = [
        onehot_vec(X[:, i], vnames[i] if vnames else "", check)
        for i in range(X.shape[1])
    ]
    if verbose:
        enc_mask = [r[0].shape[1] > 1 for r in results]
        num_enc = sum(enc_mask)
        if num_enc > 0:
            enc_vnames = [v for v, m in zip(vnames, enc_mask) if m] if vnames else []
            name_str = f" ({', '.join(enc_vnames)})" if enc_vnames else ""
            pl1 = "" if num_enc == 1 else "s"
            pl2 = "it" if num_enc == 1 else "them"
            warnings.warn(
                f"{num_enc} factor variable{pl1} with more than two categories "
                f"were detected{name_str}, splitting {pl2} into separate dummy "
                "variables (One Hot)"
            )
    X_enc = np.hstack([r[0] for r in results]).astype(np.float64)
    names_enc = [n for r in results for n in r[1]] if vnames else []
    return X_enc, names_enc


def factors_to_ints(X: np.ndarray) -> np.ndarray:
    # reference: src/preprocessing.jl:53-56
    return np.column_stack(
        [factors_to_ints_vec(X[:, i]) for i in range(X.shape[1])]
    ).astype(np.float64)


# ---------------------------------------------------------------------------
# CLR family (reference: src/preprocessing.jl:120-214, 325-346)
# ---------------------------------------------------------------------------

def _geomean(x: np.ndarray) -> float:
    return float(np.exp(np.mean(np.log(x))))


def _pseudocount_vars_from_sample(s: np.ndarray):
    # reference: src/preprocessing.jl:133-139
    z_mask = s == 0
    k = int(z_mask.sum())
    nprod = float(np.log(s[~z_mask]).sum())
    return k, nprod, len(s)


def adaptive_pseudocount(x1: float, k: int, nprod1_log: float, p: int,
                         s2: np.ndarray) -> float:
    # reference: src/preprocessing.jl:148-154
    n, nprod2_log, _ = _pseudocount_vars_from_sample(s2)
    assert n < p and k < p, "samples with all zero abundances are not allowed"
    x2_log = (1.0 / (n - p)) * ((k - p) * np.log(x1) + nprod1_log - nprod2_log)
    return float(np.exp(x2_log))


def adaptive_pseudocount_fill(X: np.ndarray):
    """Derive per-sample pseudo-counts from the deepest sample and fill zeros
    (reference: src/preprocessing.jl:157-176).  Returns (X, keep_row_mask)."""
    max_depth_index = int(np.argmax(X.sum(axis=1)))
    min_abund = float(X[X != 0].min())
    base_pcount = 1.0 if min_abund >= 1 else min_abund / 10
    k, nprod, p = _pseudocount_vars_from_sample(X[max_depth_index, :])
    pseudo_counts = np.array(
        [adaptive_pseudocount(base_pcount, k, nprod, p, X[i, :]) for i in range(X.shape[0])]
    )
    nz_mask = pseudo_counts != 0.0
    if not nz_mask.all():
        warnings.warn(
            f"adaptive pseudo-counts for {int((~nz_mask).sum())} samples were "
            "lower than machine precision due to insufficient counts, removing them"
        )
        X = X[nz_mask, :]
        pseudo_counts = pseudo_counts[nz_mask]
    X = X.copy()
    for i in range(X.shape[0]):
        row = X[i, :]
        row[row == 0] = pseudo_counts[i]
    return X, nz_mask


def clr(X: np.ndarray, pseudo_count: float = 1e-5, ignore_zeros: bool = False):
    """Centered log-ratio transform (reference: src/preprocessing.jl:192-207).
    With ignore_zeros, rows are centered on the geomean of their NONZERO
    entries and structural zeros map to 0."""
    X = np.asarray(X, dtype=np.float64).copy()
    if not ignore_zeros:
        X += pseudo_count
        gmeans = np.exp(np.mean(np.log(X), axis=1))
    else:
        with np.errstate(divide="ignore"):
            logX = np.where(X != 0, np.log(np.where(X != 0, X, 1.0)), 0.0)
        counts = (X != 0).sum(axis=1)
        gmeans = np.exp(logX.sum(axis=1) / np.maximum(counts, 1))
    with np.errstate(divide="ignore", invalid="ignore"):
        X = np.log(X / gmeans[:, None])
    if ignore_zeros:
        X[~np.isfinite(X)] = 0.0
    return X


def adaptive_clr(X: np.ndarray):
    # reference: src/preprocessing.jl:210-214
    X, row_mask = adaptive_pseudocount_fill(np.asarray(X, dtype=np.float64))
    return clr(X, pseudo_count=0.0, ignore_zeros=False), row_mask


def clrnorm(data: np.ndarray, norm: str, clr_pseudo_count: float):
    """All CLR flavors (reference: src/preprocessing.jl:325-346)."""
    row_mask = np.ones(data.shape[0], dtype=bool)
    if norm == "clr":
        data = clr(data, pseudo_count=clr_pseudo_count)
    elif norm == "clr_adapt":
        data, row_mask = adaptive_clr(data)
    elif norm == "clr_nz":
        data = clr(data, pseudo_count=0.0, ignore_zeros=True)
    return data, row_mask


def rownorm(X: np.ndarray) -> np.ndarray:
    # TSS (reference: src/preprocessing.jl:348)
    X = np.asarray(X, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return X / X.sum(axis=1, keepdims=True)


def presabs_norm(X: np.ndarray) -> np.ndarray:
    # reference: src/preprocessing.jl:364-365
    return np.sign(np.asarray(X, dtype=np.float64))


# ---------------------------------------------------------------------------
# discretization (reference: src/preprocessing.jl:217-322)
# ---------------------------------------------------------------------------

def discretize_vec(x: np.ndarray, n_bins: int = 3, rank_method: str = "tied",
                   disc_method: str = "median") -> np.ndarray:
    # reference: src/preprocessing.jl:238-270
    x = np.asarray(x, dtype=np.float64)
    if disc_method == "median":
        if x.size == 0:
            return x.astype(np.int64)
        if rank_method == "dense":
            r = rankdata(x, method="dense").astype(np.float64)
        elif rank_method == "tied":
            r = rankdata(x, method="average")
        else:
            raise ValueError(f"{rank_method} not a valid ranking method")
        r = r / r.max()
        step = (1.0 / n_bins) + 1e-5
        return np.floor(r / step).astype(np.int64)
    elif disc_method == "mean":
        if n_bins > 2:
            raise ValueError(f"disc_method {disc_method} only works with 2 bins")
        thresh = x.mean()
        return (x > thresh).astype(np.int64)
    raise ValueError(f"{disc_method} is not a valid discretization method")


def discretize_nz_vec(x: np.ndarray, nz_vec: np.ndarray, n_bins: int = 3,
                      rank_method: str = "tied", disc_method: str = "median"):
    # reference: src/preprocessing.jl:280-291 (zeros stay 0, nonzeros 1-based)
    out = np.zeros(len(x), dtype=np.int64)
    if nz_vec.any():
        out[nz_vec] = discretize_vec(
            x[nz_vec], n_bins - 1, rank_method=rank_method, disc_method=disc_method
        ) + 1
    return out


def _rankdata_cols(X: np.ndarray, method: str) -> np.ndarray:
    """Column-wise 'average' or 'dense' ranks, fully vectorized (scipy's
    rankdata(axis=0) falls back to a per-column Python loop)."""
    n, p = X.shape
    s_idx = np.argsort(X, axis=0, kind="stable").astype(np.int32)
    xs = np.take_along_axis(X, s_idx, axis=0)
    new = np.empty((n, p), dtype=bool)
    new[0] = True
    np.not_equal(xs[1:], xs[:-1], out=new[1:])
    if method == "dense":
        r_sorted = np.cumsum(new, axis=0, dtype=np.int32).astype(np.float32)
    else:
        pos = np.broadcast_to(np.arange(n, dtype=np.int32)[:, None], (n, p))
        start = np.maximum.accumulate(np.where(new, pos, 0), axis=0)
        is_end = np.empty((n, p), dtype=bool)
        is_end[-1] = True
        is_end[:-1] = new[1:]
        end = np.minimum.accumulate(
            np.where(is_end, pos, np.int32(n - 1))[::-1], axis=0
        )[::-1]
        # exact in f64: rank sums stay far below 2^53
        r_sorted = (start + end).astype(np.float64) / 2.0 + 1.0
    r = np.empty((n, p), dtype=np.float64)
    np.put_along_axis(r, s_idx, r_sorted, axis=0)
    return r


def _discretize_median_all(X: np.ndarray, n_bins: int,
                           rank_method: str) -> np.ndarray:
    """Vectorized column-wise median-rank binning (== discretize_vec per
    column; one axis-wide rank pass instead of a Python loop)."""
    method = "dense" if rank_method == "dense" else "average"
    if rank_method not in ("dense", "tied"):
        raise ValueError(f"{rank_method} not a valid ranking method")
    r = _rankdata_cols(X, method)
    rmax = r.max(axis=0)
    step = (1.0 / n_bins) + 1e-5
    return np.floor((r / rmax) / step).astype(np.int64)


def _discretize_median_nz(X: np.ndarray, n_bins: int, nz_mask: np.ndarray,
                          rank_method: str) -> np.ndarray:
    """Vectorized nz-aware binning (== discretize_nz_vec per column).

    Ranks within each column's nonzero subset equal the full-column ranks
    with zeros replaced by -inf, minus the per-column zero count ('tied') or
    minus one dense rank ('dense') -- ties never straddle the -inf block."""
    method = "dense" if rank_method == "dense" else "average"
    if rank_method not in ("dense", "tied"):
        raise ValueError(f"{rank_method} not a valid ranking method")
    Xm = np.where(nz_mask, X, -np.inf)
    r = _rankdata_cols(Xm, method)
    n_zero = (~nz_mask).sum(axis=0)
    offset = (n_zero > 0).astype(np.float64) if method == "dense" \
        else n_zero.astype(np.float64)
    r_nz = r - offset[None, :]
    rmax = np.where(nz_mask, r_nz, -np.inf).max(axis=0)
    rmax = np.where(rmax > 0, rmax, 1.0)        # all-zero columns
    step = (1.0 / (n_bins - 1)) + 1e-5
    out = np.floor((r_nz / rmax) / step).astype(np.int64) + 1
    return np.where(nz_mask, out, 0)


def discretize(X: np.ndarray, n_bins: int = 3, nz: bool = True,
               rank_method: str = "tied", disc_method: str = "median",
               nz_mask: Optional[np.ndarray] = None) -> np.ndarray:
    # reference: src/preprocessing.jl:217-235
    # ranking only compares values, so the native float dtype is kept
    # (float32 ranks == float64 ranks of the same float32 data; half the
    # memory traffic through the sort)
    X = np.asarray(X)
    if X.dtype.kind != "f":
        X = X.astype(np.float64)
    if X.shape[1] == 0:
        return X.astype(np.int64)
    if nz:
        if nz_mask is None or nz_mask.size == 0:
            nz_mask = X != 0
        if disc_method == "median":
            return _discretize_median_nz(X, n_bins, nz_mask, rank_method)
        cols = [
            discretize_nz_vec(X[:, j], nz_mask[:, j], n_bins,
                              rank_method=rank_method, disc_method=disc_method)
            for j in range(X.shape[1])
        ]
    else:
        if disc_method == "median":
            return _discretize_median_all(X, n_bins, rank_method)
        cols = [
            discretize_vec(X[:, j], n_bins, rank_method=rank_method,
                           disc_method=disc_method)
            for j in range(X.shape[1])
        ]
    return np.column_stack(cols) if cols else X.astype(np.int64)


def iscontinuousnorm(norm: str) -> bool:
    # reference: src/preprocessing.jl:294
    return norm == "rows" or norm.startswith("clr")


def iscontinuous_vec(x: np.ndarray) -> bool:
    # reference: src/preprocessing.jl:295-302
    x = np.asarray(x, dtype=np.float64)
    if np.allclose(np.round(x, 0), x):
        return x.max() > 1 or len(np.unique(x)) > 2
    return True


def discretize_meta(meta_data: np.ndarray, norm: str, n_bins: int) -> np.ndarray:
    # reference: src/preprocessing.jl:307-316
    meta_data = np.asarray(meta_data, dtype=np.float64).copy()
    for i in range(meta_data.shape[1]):
        col = meta_data[:, i]
        if iscontinuous_vec(col):
            meta_data[:, i] = discretize_vec(col, n_bins).astype(np.float64)
    return meta_data


# ---------------------------------------------------------------------------
# sparse ingestion helpers
# ---------------------------------------------------------------------------

def issparse(x) -> bool:
    from scipy import sparse as sp

    return sp.issparse(x)


def _col_chunks(n_rows: int, n_cols: int, budget_bytes: int = 1 << 28):
    """Column-chunk slices bounding the dense working set to ~budget."""
    per = max(1, budget_bytes // max(8 * n_rows, 1))
    for s in range(0, n_cols, per):
        yield slice(s, min(s + per, n_cols))


def _sparse_col_variance_mask(X) -> np.ndarray:
    """Columns with more than one distinct value (csc, zeros eliminated)."""
    n = X.shape[0]
    nnz = np.diff(X.indptr)
    colmin = np.full(X.shape[1], np.inf)
    colmax = np.full(X.shape[1], -np.inf)
    nz_cols = nnz > 0
    starts = X.indptr[:-1][nz_cols]
    colmin[nz_cols] = np.minimum.reduceat(X.data, starts)
    colmax[nz_cols] = np.maximum.reduceat(X.data, starts)
    return nz_cols & ((nnz < n) | (colmax != colmin))


def _sparse_row_lognz(X):
    """Per-row (count, mean log) over the nonzero entries (csr)."""
    X = X.tocsr()
    n = X.shape[0]
    cnt = np.diff(X.indptr).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.log(X.data)
    row_of = np.repeat(np.arange(n), np.diff(X.indptr))
    logsum = np.bincount(row_of, weights=logs, minlength=n)
    return cnt, logsum / np.maximum(cnt, 1.0)


# ---------------------------------------------------------------------------
# filtering & pipeline (reference: src/preprocessing.jl:367-594)
# ---------------------------------------------------------------------------

def filter_by_variance(data, meta_data, header, verbose,
                       filter_rows=True, filter_cols=True):
    # reference: src/preprocessing.jl:367-409; sparse-aware
    sparse = issparse(data)
    unfilt = data.shape
    if filter_cols:
        if sparse:
            col_mask = _sparse_col_variance_mask(data)
        else:
            col_mask = np.var(data, axis=0) > 0.0
        data = data[:, col_mask]
        if header:
            header = [h for h, m in zip(header, col_mask) if m]
    else:
        col_mask = np.ones(data.shape[1], dtype=bool)

    if filter_rows:
        if sparse:
            row_mask = np.asarray(data.sum(axis=1)).ravel() > 0
            data = data.tocsr()[row_mask, :]
        else:
            row_mask = data.sum(axis=1) > 0
            data = data[row_mask, :]
        if meta_data is not None:
            meta_data = meta_data[row_mask, :]
    else:
        row_mask = np.ones(data.shape[0], dtype=bool)

    if verbose:
        rm_samples = unfilt[0] - data.shape[0]
        rm_vars = unfilt[1] - data.shape[1]
        if rm_samples > 0 or rm_vars > 0:
            if filter_rows and filter_cols:
                print(f"\t-> discarded {rm_samples} samples and {rm_vars} variables")
            elif filter_rows:
                print(f"\t-> discarded {rm_samples} samples")
            elif filter_cols:
                print(f"\t-> discarded {rm_vars} variables")
        else:
            print("\t-> no samples or variables discarded")
    return data, meta_data, header, row_mask, col_mask


def _normalize_sparse(data, norm, n_bins, rank_method, prec):
    """Zero-preserving normalizations streamed from scipy.sparse into the
    final dense target-precision matrix.  Column chunks run the EXACT dense
    kernels (same binning/level semantics as the dense path, reference:
    src/preprocessing.jl:459-525), so only ~256 MB is dense-float64 at any
    time.  Returns (dense ndarray, col_keep_mask or None)."""
    n, p = data.shape
    csc = data.tocsc()

    if norm == "binary":
        nnz = np.diff(csc.indptr)
        keep = (nnz > 0) & (nnz < n)          # exactly 2 presence levels
        csc = csc[:, keep]
        out = np.empty((n, csc.shape[1]), dtype=_target_dtype(prec, False))
        for sl in _col_chunks(n, csc.shape[1]):
            out[:, sl] = np.sign(csc[:, sl].toarray())
        return out, keep

    if norm == "rows" or norm == "clr_nz":
        if norm == "rows":
            sums = np.asarray(csc.sum(axis=1)).ravel()
        else:
            _, gl = _sparse_row_lognz(csc)
        out = np.empty((n, p), dtype=_target_dtype(prec, True))
        for sl in _col_chunks(n, p):
            ch = csc[:, sl].toarray().astype(np.float64)
            if norm == "rows":
                with np.errstate(divide="ignore", invalid="ignore"):
                    out[:, sl] = ch / sums[:, None]
            else:
                nzm = ch != 0
                with np.errstate(divide="ignore", invalid="ignore"):
                    v = np.log(np.where(nzm, ch, 1.0)) - gl[:, None]
                out[:, sl] = np.where(nzm, v, 0.0)
        return out, None

    if norm.startswith("binned"):
        nz_variant = norm.startswith("binned_nz")
        if nz_variant and norm.endswith("rows"):
            sums = np.asarray(csc.sum(axis=1)).ravel()
        elif nz_variant:
            _, gl = _sparse_row_lognz(csc)
        dtype = _target_dtype(prec, False)
        chunks, masks = [], []
        for sl in _col_chunks(n, p):
            ch = csc[:, sl].toarray().astype(np.float64)
            if nz_variant:
                nzm = ch != 0                 # pre-normalization zeros
                if norm.endswith("rows"):
                    with np.errstate(divide="ignore", invalid="ignore"):
                        ch = ch / sums[:, None]
                else:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        ch = np.where(nzm, np.log(np.where(nzm, ch, 1.0))
                                      - gl[:, None], 0.0)
                binned = _discretize_median_nz(ch, n_bins, nzm, rank_method)
            else:
                binned = _discretize_median_all(ch, n_bins, rank_method)
            # keep columns with exactly n_bins-1 distinct nonzero levels ==
            # all nonzero bins present (bins are 1..n_bins-1)
            present = np.stack(
                [(binned == b).any(axis=0) for b in range(1, n_bins)]
            )
            keep = present.all(axis=0)
            chunks.append(binned[:, keep].astype(dtype))
            masks.append(keep)
        out = (np.concatenate(chunks, axis=1) if chunks
               else np.empty((n, 0), dtype=dtype))
        return out, np.concatenate(masks) if masks else np.zeros(0, bool)

    raise ValueError(f"{norm} is not a valid normalization method")


DEFAULT_NORM_DICT = {
    # reference: src/preprocessing.jl:569-573
    "mi": "binary",
    "mi_nz": "binned_nz_clr",
    "fz": "clr_adapt",
    "fz_nz": "clr_nz",
    "mi_expdz": "binned_nz_clr",
}


def _target_dtype(prec: int, continuous: bool):
    # reference: src/misc.jl:47-62
    if prec == 128:
        # the reference advertises 128 but its own eval(Symbol("Float128"))
        # fails in base Julia (src/misc.jl:47-52); accept it as a documented
        # float64/int64 cast instead of erroring
        import warnings

        warnings.warn("prec=128 is not natively supported; using 64-bit "
                      "precision (the reference's Float128 path fails in "
                      "base Julia as well)")
        prec = 64
    fmap = {16: np.float16, 32: np.float32, 64: np.float64}
    imap = {16: np.int16, 32: np.int32, 64: np.int64}
    m = fmap if continuous else imap
    if prec not in m:
        raise ValueError(f"'{prec}' not a valid precision")
    return m[prec]


def convert_to_target_prec(data: np.ndarray, prec: int, norm_mode=None,
                           test_name=None) -> np.ndarray:
    from .utils.misc import iscontinuous as _tn_cont

    if norm_mode is not None:
        continuous = iscontinuousnorm(norm_mode)
    else:
        continuous = _tn_cont(test_name)
    return np.ascontiguousarray(data, dtype=_target_dtype(prec, continuous))


def preprocess_data(
    data: np.ndarray,
    norm: str,
    clr_pseudo_count: float = 1e-5,
    n_bins: int = 3,
    rank_method: str = "tied",
    disc_method: str = "median",
    verbose: bool = True,
    meta_mask: Optional[np.ndarray] = None,
    make_sparse: bool = False,
    prec: int = 32,
    filter_data: bool = True,
    header: Optional[Sequence[str]] = None,
    make_onehot: bool = True,
) -> NormalizedData:
    """Full preprocessing pipeline (reference: src/preprocessing.jl:412-563).

    ``data`` may be a dense ndarray or any scipy.sparse matrix; sparse inputs
    stream through the zero-preserving normalizations without ever
    materializing a dense float64 copy (``make_sparse`` is accepted for API
    compatibility; the OUTPUT layout is always dense -- on the device zeros are
    semantic masks, not a storage format)."""
    del make_sparse

    sparse = issparse(data)
    if meta_mask is None:
        meta_mask = np.zeros(data.shape[1], dtype=bool)
    meta_mask = np.asarray(meta_mask, dtype=bool)
    header = list(header) if header else []
    has_meta = bool(meta_mask.any())

    if has_meta:
        if sparse:
            meta_data = np.asarray(data.tocsc()[:, meta_mask].todense())
            data = data.tocsc()[:, ~meta_mask]
        else:
            meta_data = data[:, meta_mask]
            data = data[:, ~meta_mask]
        if header:
            meta_header = [h for h, m in zip(header, meta_mask) if m]
            header = [h for h, m in zip(header, meta_mask) if not m]
        else:
            meta_header = []
        if make_onehot:
            meta_data, meta_header = onehot(meta_data, meta_header, verbose=verbose)
        else:
            warnings.warn("Skipping one-hot encoding, only experts should choose this option")
            meta_data = factors_to_ints(meta_data)
    else:
        meta_data = None

    if sparse:
        if norm in ("clr", "clr_adapt") or (
            norm.startswith("binned") and disc_method != "median"
        ):
            warnings.warn(
                f"'{norm}' with disc_method='{disc_method}' fills structural "
                "zeros; densifying the sparse input"
            )
            data = np.asarray(data.todense(), dtype=np.float64)
            sparse = False
        else:
            data = data.tocsc().astype(np.float64)
            data.eliminate_zeros()
    if not sparse:
        data = np.asarray(data, dtype=np.float64)

    if verbose:
        print("Removing variables with 0 variance (or equivalently 1 level) and samples with 0 reads")
    if filter_data:
        data, meta_data, header, row_mask, _ = filter_by_variance(
            data, meta_data, header, verbose
        )
    else:
        row_mask = np.ones(data.shape[0], dtype=bool)

    if verbose:
        print("\nNormalization")
    if sparse:
        unreduced = data.shape[1]
        data, keep = _normalize_sparse(data, norm, n_bins, rank_method, prec)
        if keep is not None:
            if header:
                header = [h for h, m in zip(header, keep) if m]
            if verbose:
                n_rm = unreduced - data.shape[1]
                if norm == "binary":
                    if n_rm > 0:
                        print(f"\t-> removed {n_rm} variables with not exactly 2 levels")
                else:
                    print(f"\t-> removed {n_rm} variables with not exactly {n_bins} non-zero levels")
    elif norm == "rows":
        data = rownorm(data)
    elif norm.startswith("clr"):
        data, clr_row_mask = clrnorm(data, norm, clr_pseudo_count)
        if has_meta:
            meta_data = meta_data[clr_row_mask, :]
        # map removed rows back into the global filter mask
        # (reference: src/preprocessing.jl:468-473)
        sample_idx = np.arange(len(row_mask))
        rm_samples = sample_idx[row_mask][~clr_row_mask]
        row_mask[rm_samples] = False
    elif norm == "binary":
        data = presabs_norm(data).astype(np.int64)
        unreduced = data.shape[1]
        bin_mask = get_levels(data) == 2
        data = data[:, bin_mask]
        if header:
            header = [h for h, m in zip(header, bin_mask) if m]
        if verbose:
            n_rm = unreduced - data.shape[1]
            if n_rm > 0:
                print(f"\t-> removed {n_rm} variables with not exactly 2 levels")
    elif norm.startswith("binned"):
        if norm.startswith("binned_nz"):
            # zeros produced by pre-normalization must not count as absences
            # (reference: src/preprocessing.jl:493-504)
            nz_mask = data != 0
            if norm.endswith("rows"):
                data = rownorm(data)
            elif norm.endswith("clr"):
                data, _ = clrnorm(data, "clr_nz", 0.0)
            data = discretize(data, n_bins=n_bins, nz=True, rank_method=rank_method,
                              disc_method=disc_method, nz_mask=nz_mask)
        else:
            data = discretize(data, n_bins=n_bins, nz=False, rank_method=rank_method,
                              disc_method=disc_method)
        unreduced = data.shape[1]
        # keep only variables with exactly n_bins-1 distinct nonzero levels
        bin_mask = np.array(
            [len(np.unique(data[:, j][data[:, j] != 0])) == n_bins - 1
             for j in range(data.shape[1])]
        )
        data = data[:, bin_mask]
        if header:
            header = [h for h, m in zip(header, bin_mask) if m]
        if verbose:
            print(f"\t-> removed {unreduced - data.shape[1]} variables with not exactly {n_bins} non-zero levels")
    else:
        raise ValueError(f"{norm} is not a valid normalization method")

    if has_meta:
        if not iscontinuousnorm(norm):
            if verbose:
                print("\nDiscretizing meta variables")
            meta_data = discretize_meta(meta_data, norm, 2)
        if norm == "clr_nz":
            # assure zeros are used for meta variables in fz_nz mode
            # (reference: src/preprocessing.jl:537-545)
            meta_data = meta_data.copy()
            for i in range(meta_data.shape[1]):
                if (meta_data[:, i] == 0).any():
                    meta_data[:, i] += 1
        if verbose:
            print("\nRemoving meta variables with 0 variance (or equivalently 1 level)")
        meta_data, _, meta_header, _, _ = filter_by_variance(
            meta_data, None, meta_header, verbose, filter_rows=False
        )
        out_meta_mask = np.concatenate(
            [np.zeros(data.shape[1], dtype=bool), np.ones(meta_data.shape[1], dtype=bool)]
        )
        data = np.hstack([np.asarray(data, dtype=np.float64), meta_data])
        if header:
            header = header + meta_header
    else:
        out_meta_mask = np.zeros(data.shape[1], dtype=bool)

    data = convert_to_target_prec(data, prec, norm_mode=norm)
    return NormalizedData(data, header, out_meta_mask, row_mask)


def preprocess_data_default(data, test_name, verbose=True, make_sparse=False,
                            make_onehot=True, meta_mask=None, prec=32,
                            header=None, **preprocess_kwargs) -> NormalizedData:
    # reference: src/preprocessing.jl:566-576
    return preprocess_data(
        data, DEFAULT_NORM_DICT[test_name], verbose=verbose,
        make_sparse=make_sparse, make_onehot=make_onehot, meta_mask=meta_mask,
        prec=prec, header=header, **preprocess_kwargs
    )


NORM_MODE_MAP = {
    # reference: src/preprocessing.jl:666-668
    "clr-adapt": "clr_adapt",
    "clr-nonzero": "clr_nz",
    "clr-nonzero-binned": "binned_nz_clr",
    "pres-abs": "binary",
    "tss": "rows",
    "tss-nonzero-binned": "binned_nz_rows",
}


def normalize_data(data, extra_data=None, test_name: str = "", norm_mode: str = "",
                   header=None, meta_mask=None, verbose: bool = True,
                   prec: int = 32, filter_data: bool = True, make_sparse: bool = True,
                   make_onehot: bool = True, **preprocess_kwargs) -> NormalizedData:
    """Normalize an OTU table (reference: src/preprocessing.jl:660-701).

    Provide exactly one of ``test_name`` (normalization chosen per test mode)
    or ``norm_mode`` (explicit mode: 'clr-adapt', 'clr-nonzero',
    'clr-nonzero-binned', 'pres-abs', 'tss', 'tss-nonzero-binned')."""
    if extra_data is not None:
        if verbose:
            print("Normalization")
            print("\t-> multiple data sets provided, using separate normalization mode")
        kw = dict(test_name=test_name, norm_mode=norm_mode, prec=prec,
                  filter_data=filter_data, make_sparse=make_sparse,
                  make_onehot=make_onehot, **preprocess_kwargs)
        main = normalize_data(data, header=header, meta_mask=meta_mask,
                              verbose=False, **kw)
        extra_norm = []
        for X, extra_header in extra_data:
            r = normalize_data(X, header=extra_header,
                               meta_mask=np.zeros(X.shape[1], dtype=bool),
                               verbose=False, **kw)
            extra_norm.append((r.data, r.header, r.obs_filter_mask))
        sample_idx = np.arange(data.shape[0])
        return combine_data(main.data, main.header, main.meta_mask,
                            main.obs_filter_mask, sample_idx, extra_norm)

    assert (test_name == "") != (norm_mode == ""), (
        "provide exactly one out of 'test_name' and 'norm_mode'"
    )
    if norm_mode:
        assert norm_mode in NORM_MODE_MAP, f"{norm_mode} is not a valid normalization mode"
        norm_str = NORM_MODE_MAP[norm_mode]
        fn = preprocess_data
    else:
        norm_str = test_name
        fn = preprocess_data_default
    return fn(data, norm_str, meta_mask=meta_mask, header=header, verbose=verbose,
              filter_data=filter_data, prec=prec, make_sparse=make_sparse,
              make_onehot=make_onehot, **preprocess_kwargs)


def combine_data(data, header, meta_mask, obs_filter_mask, sample_idx,
                 extra_data) -> NormalizedData:
    """Row-align and hcat independently normalized datasets (reference:
    src/preprocessing.jl:596-635)."""
    if sample_idx is not None:
        assert all(len(x) > 2 for x in extra_data), (
            "extra_data is missing sample filter information"
        )
        comb_mask = np.asarray(obs_filter_mask, dtype=bool).copy()
        for x in extra_data:
            comb_mask &= np.asarray(x[2], dtype=bool)
        n_removed = int((~comb_mask).sum())
        if n_removed > 0:
            warnings.warn(
                f"{n_removed} samples had only zero counts in at least one "
                "data set and will not be used for inference"
            )
        sample_idx = np.asarray(sample_idx)
        sample_idx_comb = sample_idx[comb_mask]
        sample_idx_data = sample_idx[np.asarray(obs_filter_mask, dtype=bool)]
        sel = np.searchsorted(sample_idx_data, sample_idx_comb)
        data = data[sel, :]
    else:
        comb_mask = np.asarray(obs_filter_mask, dtype=bool)

    data_vec = [data]
    header_vec = [list(header)]
    meta_vec = [np.asarray(meta_mask, dtype=bool)]
    for tup in extra_data:
        X, extra_header = tup[0], tup[1]
        if sample_idx is not None:
            extra_obs_mask = np.asarray(tup[2], dtype=bool)
            sample_idx_X = sample_idx[extra_obs_mask]
            sel = np.searchsorted(sample_idx_X, sample_idx_comb)
            X = X[sel, :]
        data_vec.insert(0, X)
        header_vec.insert(0, list(extra_header))
        meta_vec.insert(0, np.zeros(X.shape[1], dtype=bool))

    # mixed int/float blocks promote to float (reference hcat semantics)
    comb = np.hstack([np.asarray(d, dtype=np.float64) for d in data_vec])
    if all(np.issubdtype(np.asarray(d).dtype, np.integer) for d in data_vec):
        comb = comb.astype(data_vec[0].dtype)
    else:
        comb = comb.astype(
            max((np.asarray(d).dtype for d in data_vec), key=lambda t: t.itemsize)
        ) if all(np.issubdtype(np.asarray(d).dtype, np.floating) for d in data_vec) else comb
    return NormalizedData(
        comb,
        [h for hs in header_vec for h in hs],
        np.concatenate(meta_vec),
        comb_mask,
    )
