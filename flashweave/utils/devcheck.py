"""Parity checks of the device routes against their plain float64 references.

Each check builds a seeded table, runs the route the accelerator path uses
on the default device and compares it with an independent float64 numpy
formulation of the same statistic, raising ``AssertionError`` on a
mismatch and returning a dict of what it compared.  ``chip_smoke.py`` runs
them on the GPU at real widths; the tests run them on the CPU at small
widths (and carry the ``gpu`` marker where only the card can run them).
"""

from __future__ import annotations

import time

import numpy as np


def _ready(x):
    import jax

    return jax.block_until_ready(x)


def time_call(fn, *args, reps=5):
    """Median seconds of ``fn(*args)`` after one warm-up call, each call
    waited for with ``block_until_ready``."""
    _ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def discrete_table(n, p, L=3, zero_frac=0.4, seed=0):
    """(n, p) int8 levels 0..L-1, zero-inflated, every variable holding
    every level."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, L, (n, p), dtype=np.int8)
    d[rng.random((n, p)) < zero_frac] = 0
    d[:L] = np.arange(L, dtype=np.int8)[:, None]
    return d


def check_mi_univariate(n, p, L=3, nz=2, tile=256, y_len=512, n_blocks=3,
                        seed=0, stats_fn=None):
    """The int8 univariate MI route (``stats_fn``, default
    :func:`flashweave.ops.univariate.mi_univar_stats`) against the float64
    numpy reference on ``n_blocks`` sampled (tile x y_len) blocks of an
    (n, p) table: n_obs, df and the power flag bit-equal, the statistic to
    rtol 1e-5 (atol 2e-6 covers the f32 log terms of near-zero MI)."""
    import jax.numpy as jnp

    from ..ops import univariate as uv

    stats_fn = stats_fn or uv.mi_univar_stats
    d = discrete_table(n, p, L, seed=seed)
    levels = np.array([len(np.unique(d[:, j])) for j in range(p)], np.int32)
    max_vals = d.max(axis=0).astype(np.int32)
    dT = jnp.asarray(np.ascontiguousarray(d.T))
    marg = uv.level_marginals(dT, L)
    lv, mv = jnp.asarray(levels), jnp.asarray(max_vals)
    rng = np.random.default_rng(seed + 1)
    worst = 0.0
    for _ in range(n_blocks):
        s = int(rng.integers(0, p - tile + 1))
        y0 = int(rng.integers(0, p - y_len + 1))
        got = [np.asarray(a) for a in stats_fn(
            dT, marg, lv, mv, s, tile, L, y0, y_len, nz, 5.0, 20.0)]
        ref = uv.mi_block_stats_np(d, np.arange(s, s + tile),
                                   np.arange(y0, y0 + y_len), levels,
                                   max_vals, 5.0, 20.0, nz, L)
        np.testing.assert_array_equal(got[2], ref[2], err_msg="n_obs")
        np.testing.assert_array_equal(got[1], ref[1], err_msg="df")
        np.testing.assert_array_equal(got[3], ref[3], err_msg="suff")
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5, atol=2e-6,
                                   err_msg="stat")
        worst = max(worst, float(np.max(np.abs(got[0] - ref[0]))))
    return {"blocks": n_blocks, "max_abs_stat_err": worst}


def continuous_table(n, p, zero_frac=0.6, seed=0):
    """(n, p) float32 zero-inflated values on a CLR-like scale with
    correlated column pairs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, p)).astype(np.float32)
    x[:, 1::2] = 0.7 * x[:, 0::2][:, : x[:, 1::2].shape[1]] + 0.7 * x[:, 1::2]
    x[rng.random((n, p)) < zero_frac] = 0.0
    return x


def check_fz_nz_univariate(n, p, tile=256, y_len=512, n_blocks=3, seed=0):
    """fz_nz masked correlations on the device route
    (:func:`flashweave.ops.univariate.fz_nz_block`) against float64 numpy
    moments: joint counts exact, |dr| <= 1e-5."""
    import jax.numpy as jnp

    from ..ops import univariate as uv

    x = continuous_table(n, p, seed=seed)
    xj = jnp.asarray(x)
    rng = np.random.default_rng(seed + 1)
    worst = 0.0
    for _ in range(n_blocks):
        s = int(rng.integers(0, p - tile + 1))
        y0 = int(rng.integers(0, p - y_len + 1))
        r, N = (np.asarray(a, np.float64)
                for a in uv.fz_nz_block(xj, s, tile, y0, y_len))
        a = x[:, s:s + tile].astype(np.float64)
        b = x[:, y0:y0 + y_len].astype(np.float64)
        ma, mb = (a != 0).astype(np.float64), (b != 0).astype(np.float64)
        Nr = ma.T @ mb
        Sx, Sy = a.T @ mb, ma.T @ b
        Sxx, Syy, Sxy = (a * a).T @ mb, ma.T @ (b * b), a.T @ b
        safe = np.where(Nr > 0, Nr, 1.0)
        with np.errstate(invalid="ignore", divide="ignore"):
            rr = (Sxy - Sx * Sy / safe) / np.sqrt(
                (Sxx - Sx * Sx / safe) * (Syy - Sy * Sy / safe))
        rr = np.where(Nr > 0, np.clip(rr, -1.0, 1.0), 0.0)
        np.testing.assert_array_equal(N, Nr, err_msg="joint counts")
        ok = np.isfinite(rr) & np.isfinite(r)
        np.testing.assert_array_equal(np.isfinite(r), np.isfinite(rr))
        err = float(np.max(np.abs(r[ok] - rr[ok]), initial=0.0))
        assert err <= 1e-5, f"fz_nz |dr| = {err}"
        worst = max(worst, err)
    return {"blocks": n_blocks, "max_abs_r_err": worst}


def turbo_window_inputs(p, W, m, group=8, seed=0):
    """Targets and candidate windows: half of each window from the
    target's correlated column group of :func:`grouped_table` (so some
    tests are significant), the rest drawn at random."""
    rng = np.random.default_rng(seed)
    Ts = rng.integers(0, p, W)
    cands = np.empty((W, m), np.int64)
    for w, T in enumerate(Ts):
        g0 = T // group * group
        mates = [c for c in range(g0, min(g0 + group, p)) if c != T]
        near = [int(c) for c in rng.permutation(mates)[: m // 2]]
        others = [int(c) for c in rng.permutation(p)[: 4 * m]
                  if c != T and c not in near]
        cands[w] = near + others[: m - len(near)]
    return Ts, cands


def grouped_table(n, p, group=8, L=3, flip=0.35, seed=0):
    """(n, p) int8 table of L-level columns in correlated groups."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, L, (n, -(-p // group)), dtype=np.int8)
    d = np.repeat(base, group, axis=1)[:, :p]
    mask = rng.random((n, p)) < flip
    return np.where(mask, rng.integers(0, L, (n, p), dtype=np.int8), d)


def check_turbo_window(n, p, m=8, W=512, max_k=3, alpha=0.01, seed=0):
    """The turbo-window kernel's per-slot digest against the per-test
    histogram digest of the same tests: identical exit decisions, weakest
    statistics to 1e-5 relative."""
    from ..learning.hiton import _turbo_mxu_template, _turbo_template
    from ..ops.condtests import CondTestEngine

    d = grouped_table(n, p, seed=seed)
    lv = np.array([len(np.unique(d[:, j])) for j in range(p)], np.int32)
    mx = d.max(axis=0).astype(np.int32)
    eng = CondTestEngine(d, "mi_nz", max_k, levels=lv, max_vals=mx, hps=5,
                         n_obs_min=20)
    assert eng.dev_digest and eng.turbo_mxu, "device digest paths are off"
    Ts, cands = turbo_window_inputs(p, W, m, seed=seed)
    tpl = _turbo_mxu_template(m, max_k)
    ex_t, ws_t, _ = eng.turbo_tests_finish(
        eng.turbo_tests_begin(m, Ts, cands, alpha, tpl))
    IDX, KV, COUNTS = _turbo_template(m, max_k)
    slots = np.concatenate([cands[:, 1:], cands], axis=1)       # (W, NC)
    X = np.repeat(Ts, len(KV))
    Y = np.repeat(slots, COUNTS, axis=1).reshape(-1)
    Zs = cands[:, IDX].reshape(-1, max_k)
    kv = np.tile(KV, W)
    counts = np.tile(COUNTS, W)
    ex_h, ws_h, _ = eng.mi_tests_finish_digest(
        eng.mi_tests_begin_digest(X, Y, Zs, kv, counts, alpha))
    ex_h = ex_h.reshape(W, -1)
    ws_h = ws_h.reshape(W, -1)
    np.testing.assert_array_equal(ex_t, ex_h, err_msg="turbo exit decisions")
    sig = ex_t != 0
    np.testing.assert_allclose(ws_t[sig], ws_h[sig], rtol=1e-5, atol=1e-7,
                               err_msg="weakest statistics")
    return {"windows": W, "tests": int(W * len(KV)),
            "slots_with_significant_tests": int(sig.sum())}


def raw_count_table(n, p, group=5, present=0.33, seed=0):
    """(n, p) float64 raw OTU counts: about 1 - ``present`` zeros, uneven
    sequencing depth (log-normal), OTUs in correlated groups of ``group``
    (shared presence and abundance factors per group)."""
    rng = np.random.default_rng(seed)
    ng = -(-p // group)
    gid = np.arange(p) // group
    pres_f = rng.standard_normal((n, ng)).astype(np.float32)
    abund_f = rng.standard_normal((n, ng)).astype(np.float32)
    # per-OTU prevalence offsets centred on the target presence rate
    from scipy.stats import norm

    off = (norm.ppf(present) + 0.5 * rng.standard_normal(p)).astype(
        np.float32)
    noise = rng.standard_normal((n, p)).astype(np.float32)
    is_present = (0.8 * pres_f[:, gid] + 0.6 * noise) < off * 1.0
    mu = rng.normal(1.0, 1.0, p).astype(np.float32)
    depth = rng.lognormal(0.0, 0.6, n).astype(np.float32)
    lam = np.exp(mu + 0.9 * abund_f[:, gid]
                 + 0.4 * rng.standard_normal((n, p)).astype(np.float32))
    lam *= depth[:, None]
    counts = rng.poisson(lam).astype(np.float64)
    counts[~is_present] = 0.0
    counts[:, counts.sum(axis=0) == 0] = 0.0
    return counts
