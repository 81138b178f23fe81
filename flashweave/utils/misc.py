"""Small host-side utilities.

Mirrors the semantics of the reference's utility layer (reference:
src/misc.jl) -- mode strings, level/metadata introspection, edge weighting and
symmetric-graph assembly.  These are cheap host operations on small data; the
heavy numerics live in flashweave.ops.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from ..types import Graph, NbrStatDict

# float64 overflow bound of the fisher-z statistic scale (reference src/misc.jl:1)
INF_WEIGHT = 708.3964185322641


def mode_string(heterogeneous: bool, sensitive: bool, max_k: int) -> str:
    # reference: src/misc.jl:4-9
    het_str = "HE" if heterogeneous else ""
    sens_str = "sensitive" if sensitive else "fast"
    cond_str = "univariate" if max_k == 0 else "conditional"
    return f"FlashWeave{het_str} - {sens_str} ({cond_str})"


def check_data(data, header, meta_mask=None) -> None:
    # reference: src/misc.jl:23-31
    assert data.shape[1] == len(header), (
        f"header does not fit data: {data.shape[1]} vs. {len(header)}"
    )
    if meta_mask is not None:
        assert data.shape[1] == len(meta_mask), (
            f"meta_mask does not fit data: {data.shape[1]} vs. {len(meta_mask)}"
        )
    if len(header) != len(set(header)):
        seen, dups = set(), set()
        for h in header:
            if h in seen:
                dups.add(h)
            seen.add(h)
        raise ValueError("Variable names are not unique: " + ", ".join(sorted(dups)))


def is_zero_adjusted(test_name: str) -> bool:
    # reference: src/types.jl:64
    return test_name.endswith("_nz")


def isdiscrete(test_name: str) -> bool:
    # reference: src/types.jl:68
    return test_name in ("mi", "mi_nz")


def iscontinuous(test_name: str) -> bool:
    # reference: src/types.jl:72
    return test_name in ("fz", "fz_nz")


def get_levels(data: np.ndarray) -> np.ndarray:
    """Distinct-value count per column (reference: src/misc.jl:75-81).

    Fast path for the usual case (small non-negative integer levels, e.g.
    binned OTU tables): one presence pass per level value.  General data
    falls back to a vectorized column-sort + run-length count."""
    if data.shape[0] <= 1:
        return np.full(data.shape[1], data.shape[0], dtype=np.int32)
    data = np.asarray(data)
    mx = data.max() if data.size else 0
    if data.size and data.min() >= 0 and mx <= 64:
        if np.issubdtype(data.dtype, np.integer):
            di, intlike = data, True
        else:
            # integer cast + equality compare beats np.mod by ~5x; the
            # presence loop then runs on the narrow uint8 view
            di = data.astype(np.int32)
            intlike = not (di != data).any()
        if intlike:
            d8 = di.astype(np.uint8)
            levels = np.zeros(data.shape[1], dtype=np.int32)
            for v in range(int(mx) + 1):
                levels += (d8 == v).any(axis=0)
            return levels
    s = np.sort(data, axis=0)
    return (1 + (np.diff(s, axis=0) != 0).sum(axis=0)).astype(np.int32)


def get_max_vals(data: np.ndarray) -> np.ndarray:
    """Column-wise maximum value (reference: src/misc.jl:90-97)."""
    if data.shape[0] == 0:
        return np.zeros(data.shape[1], dtype=np.int32)
    return np.asarray(data.max(axis=0), dtype=np.int32)


def stop_reached(start_time: float, time_limit: float) -> bool:
    # reference: src/misc.jl:100
    return (time.time() - start_time > time_limit) if time_limit > 0.0 else False


def signed_weight(stat: float, pval: float, kind: str = "stat") -> float:
    # reference: src/misc.jl:111-119
    return stat if kind == "stat" else pval


def make_weights(
    PC_dict: NbrStatDict,
    univar_nbrs: NbrStatDict,
    weight_type: str,
    test_name: str,
) -> Dict[int, float]:
    """Per-neighborhood edge weights (reference: src/misc.jl:137-159).

    'cond_stat' (default): conditional stat, re-signed by the univariate sign
    for discrete tests.  'uni_*': univariate stat/pval.
    """
    weight_kind = weight_type.split("_")[1]
    if weight_type.startswith("uni"):
        return {
            nbr: signed_weight(*univar_nbrs[nbr], weight_kind) for nbr in PC_dict
        }
    if isdiscrete(test_name):
        out = {}
        for nbr in PC_dict:
            edge_sign = np.sign(univar_nbrs[nbr][0])
            out[nbr] = float(edge_sign * abs(signed_weight(*PC_dict[nbr], weight_kind)))
        return out
    return {nbr: signed_weight(*PC_dict[nbr], weight_kind) for nbr in PC_dict}


def maxweight(
    weight1: float, weight2: float, e1: int = -1, e2: int = -1, header=None,
    warn: bool = True,
) -> float:
    """OR-rule symmetric merge: max-|w| with sign checks (reference: src/misc.jl:201-218)."""
    if np.isnan(weight1):
        return weight2
    if np.isnan(weight2):
        return weight1
    sign1, sign2 = np.sign(weight1), np.sign(weight2)
    if sign1 * sign2 < 0:
        if warn:
            e1w, e2w = (header[e1], header[e2]) if header is not None else (e1, e2)
            import warnings

            warnings.warn(
                f"Opposite signs for edge {e1w} <-> {e2w} detected. "
                "Arbitarily choosing one."
            )
        return weight1
    return max(abs(weight1), abs(weight2)) * sign1


def assemble_graph_bulk(
    nbr_dict: Dict[int, NbrStatDict],
    all_univar_nbrs: Dict[int, NbrStatDict],
    weight_type: str,
    test_name: str,
    max_var: int,
    header=None,
) -> Graph:
    """Vectorized make_weights + maxweight OR-merge + graph build.

    Semantics identical to make_weights/make_symmetric_graph with the
    default ``maxweight`` merge (reference: src/misc.jl:137-159, 201-272)
    incl. per-edge sign-conflict warnings keyed by the FIRST-seen direction
    and NaN-edge dropping -- but the numeric work (signing, |max| merge,
    NaN rules) runs as array passes instead of per-edge numpy scalar calls.
    """
    import warnings

    uni = weight_type.startswith("uni")
    kind_i = 1 if weight_type.split("_")[1] == "pval" else 0
    discrete = isdiscrete(test_name)
    us, vs, ws, sgn = [], [], [], []
    for T, d in nbr_dict.items():
        univ = all_univar_nbrs[T]
        for nbr, cw in d.items():
            us.append(T)
            vs.append(nbr)
            ws.append(univ[nbr][kind_i] if uni else cw[kind_i])
            if discrete and not uni:
                sgn.append(univ[nbr][0])
    G = Graph(max_var)
    if not us:
        return G
    u = np.asarray(us, np.int64)
    v = np.asarray(vs, np.int64)
    w = np.asarray(ws, np.float64)
    if discrete and not uni:
        w = np.sign(np.asarray(sgn, np.float64)) * np.abs(w)
    lo = np.minimum(u, v)
    hi = np.maximum(u, v)
    key = lo * np.int64(max_var) + hi
    order = np.lexsort((np.arange(len(key)), key))
    ks = key[order]
    wsrt = w[order]
    first = np.ones(len(ks), bool)
    first[1:] = ks[1:] != ks[:-1]
    gstart = np.nonzero(first)[0]
    gsize = np.diff(np.append(gstart, len(ks)))
    w1 = wsrt[gstart]
    w2 = np.where(gsize > 1, wsrt[np.minimum(gstart + 1, len(ks) - 1)],
                  np.nan)
    with np.errstate(invalid="ignore"):
        nan1 = np.isnan(w1)
        nan2 = np.isnan(w2)
        s1 = np.sign(w1)
        conflict = ~nan1 & ~nan2 & (s1 * np.sign(w2) < 0)
        merged = np.where(
            nan1, w2,
            np.where(nan2, w1,
                     np.maximum(np.abs(w1), np.abs(w2)) * s1))
        merged = np.where(conflict, w1, merged)
    if conflict.any():
        oi = order[gstart]
        for gi in np.nonzero(conflict)[0]:
            e1, e2 = int(u[oi[gi]]), int(v[oi[gi]])
            e1w, e2w = (header[e1], header[e2]) if header is not None else (
                e1, e2)
            warnings.warn(
                f"Opposite signs for edge {e1w} <-> {e2w} detected. "
                "Arbitarily choosing one."
            )
    keep = ~np.isnan(merged)
    n_nan = int((~keep).sum())
    if n_nan > 0:
        warnings.warn(f"{n_nan} edges with NaN weights were removed.")
    adj = G.adj
    for a, b, m in zip((ks[gstart[keep]] // max_var).tolist(),
                       (ks[gstart[keep]] % max_var).tolist(),
                       merged[keep].tolist()):
        adj.setdefault(a, {})[b] = m
        adj.setdefault(b, {})[a] = m
    return G


def make_symmetric_graph(
    weights_dict: Dict[int, Dict[int, float]],
    edge_rule: str = "OR",
    edge_merge_fun=maxweight,
    max_var: int = -1,
    header=None,
) -> Graph:
    """OR-rule merge of per-variable neighborhoods into an undirected weighted
    graph; NaN-weight edges are dropped (reference: src/misc.jl:230-272)."""
    if max_var < 0:
        max_val_key = max(
            (max(d.keys()) if d else 0 for d in weights_dict.values()), default=0
        )
        max_key_key = max(weights_dict.keys(), default=0)
        max_var = max(max_key_key, max_val_key) + 1  # 0-based node ids

    G = Graph(max_var)
    nan_edges = 0
    seen = set()
    for node1, nbrs in weights_dict.items():
        for node2, weight in nbrs.items():
            e = (node1, node2) if node1 <= node2 else (node2, node1)
            if e in seen:
                continue
            seen.add(e)
            rev_weight = weights_dict.get(node2, {}).get(node1, np.nan)
            sym_weight = edge_merge_fun(weight, rev_weight, node1, node2, header)
            if np.isnan(sym_weight):
                nan_edges += 1
                continue
            G.add_edge(e[0], e[1], float(sym_weight))
    if nan_edges > 0:
        import warnings

        warnings.warn(f"{nan_edges} edges with NaN weights were removed.")
    return G
