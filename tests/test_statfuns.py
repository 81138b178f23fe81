"""Unit tests for the statistics kernels against the reference's
hand-computed fixtures (reference: test/statfuns.jl)."""

import numpy as np
import jax.numpy as jnp
import pytest

from flashweave.ops import statfuns as sf


def _ctab3(arr2d):
    """2-way table as single-stratum 3-way."""
    a = np.asarray(arr2d, dtype=np.float64)
    return a[:, :, None]


class TestMutualInformation:
    # fixtures from reference test/statfuns.jl:4-19
    def test_twoway(self):
        ctab12 = _ctab3([[4, 2], [2, 4]])
        mi, df, n = sf.mi_stats(ctab12[None], np.array([0]), np.array([0]))
        assert np.isclose(abs(mi[0]), 0.05663301226513242, rtol=1e-6)
        assert df[0] == 1
        assert n[0] == 12

    def test_threeway_Z1(self):
        ctab = np.zeros((2, 2, 3))
        ctab[0, 0, 0] = 4
        ctab[1, 0, 0] = 2
        ctab[0, 1, 1] = 2
        ctab[1, 1, 1] = 3
        ctab[1, 1, 2] = 1
        mi, df, n = sf.mi_stats(ctab[None], np.array([0]), np.array([0]))
        assert np.isclose(mi[0], 0.0, atol=1e-12)

    def test_threeway_Z2(self):
        ctab = np.zeros((2, 2, 6))
        ctab[0, 0, 0] = 2
        ctab[0, 1, 1] = 2
        ctab[1, 1, 1] = 2
        ctab[0, 0, 2] = 2
        ctab[1, 0, 2] = 2
        ctab[1, 1, 3] = 1
        ctab[1, 1, 4] = 1
        mi, df, n = sf.mi_stats(ctab[None], np.array([0]), np.array([0]))
        assert np.isclose(mi[0], 0.0, atol=1e-12)

    def test_pval(self):
        pval = sf.mi_pval(np.array(0.05663301226513242), np.array(1), np.array(351))
        assert np.isclose(pval, 2.8770005665168745e-10, rtol=1e-6)

    def test_jax_matches_numpy(self):
        rng = np.random.default_rng(0)
        ctab = rng.integers(0, 20, size=(16, 3, 3, 9)).astype(np.float64)
        ox = rng.integers(0, 2, size=16)
        oy = rng.integers(0, 2, size=16)
        # zero the invalid region like the engine does
        for b in range(16):
            ctab[b, : ox[b], :, :] = 0
            ctab[b, :, : oy[b], :] = 0
        mi_np, df_np, n_np = sf.mi_stats(ctab, ox, oy, xp=np)
        mi_j, df_j, n_j = sf.mi_stats(jnp.asarray(ctab), jnp.asarray(ox), jnp.asarray(oy), xp=jnp)
        np.testing.assert_allclose(mi_np, np.asarray(mi_j), rtol=1e-10)
        np.testing.assert_array_equal(df_np, np.asarray(df_j))
        np.testing.assert_array_equal(n_np, np.asarray(n_j))


class TestFisherZ:
    # fixtures from reference test/statfuns.jl:38-41
    def test_pval_fz(self):
        assert np.isclose(
            sf.fz_pval(np.array(-0.16393307352649356), 351, 1),
            0.0020593283914246987,
            rtol=1e-6,
        )
        assert np.isclose(
            sf.fz_pval(np.array(-0.07643814205965811), 351, 3),
            0.1548665431407692,
            rtol=1e-6,
        )

    def test_degenerate(self):
        # sample_factor <= 0 -> stat 0 -> pval 1
        assert sf.fz_pval(np.array(0.5), 2, 0) == 1.0
        # perfect correlation -> pval 0
        assert sf.fz_pval(np.array(1.0), 100, 0) == 0.0


class TestBenjaminiHochberg:
    # fixture from reference test/statfuns.jl:61-70
    def test_reference_vector(self):
        pvals = np.array([0.0, 1.0, 0.973774, 0.722245, 0.805758, 0.713164,
                          0.314595, 0.947966, 0.001, 0.0339692])
        exp = np.array([0.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.786488, 1.0, 0.005, 0.113231])
        adj = sf.benjamini_hochberg(pvals)
        with np.errstate(invalid="ignore"):
            assert np.array_equal(np.nan_to_num(adj, nan=np.inf) < 0.01, exp < 0.01)
        sig = np.nan_to_num(adj, nan=np.inf) < 0.01
        np.testing.assert_allclose(adj[sig], exp[sig], rtol=1e-6)

    def test_nan_and_alpha_filtering(self):
        pvals = np.array([np.nan, 0.5, 0.001, 0.005])
        adj = sf.benjamini_hochberg(pvals, alpha=0.01, m=3)
        assert np.isnan(adj[0]) and np.isnan(adj[1])
        # ranks 1, 2 among filtered; m=3
        assert np.isclose(adj[2], min(min(0.005 * 3 / 2, 1.0), 0.001 * 3 / 1))
        assert np.isclose(adj[3], min(0.005 * 3 / 2, 1.0))


class TestPcor:
    def _rand_data(self, n=200, p=6, seed=1):
        rng = np.random.default_rng(seed)
        return rng.standard_normal((n, p)) @ rng.standard_normal((p, p))

    def _pcor_rec_scalar(self, X, Y, Zs, C, cache):
        """Direct transcription of the reference recursion for cross-checking
        (reference: src/statfuns.jl:23-75)."""
        key = (X, Y, Zs)
        if key in cache:
            return cache[key]
        if len(Zs) == 1:
            Z = Zs[0]
            num = C[X, Y] - C[X, Z] * C[Y, Z]
            num = np.round(num * 1e5) / 1e5
            den = np.sqrt(1 - C[X, Z] ** 2) * np.sqrt(1 - C[Y, Z] ** 2)
            p = 0.0 if den == 0.0 else num / den
        else:
            Zp, Z0 = Zs[:-1], Zs[-1]
            pXY = self._pcor_rec_scalar(X, Y, Zp, C, cache)
            pXZ = self._pcor_rec_scalar(X, Z0, Zp, C, cache)
            pYZ = self._pcor_rec_scalar(Y, Z0, Zp, C, cache)
            num = np.round((pXY - pXZ * pYZ) * 1e5) / 1e5
            den = np.sqrt(1 - pXZ ** 2) * np.sqrt(1 - pYZ ** 2)
            p = 0.0 if den == 0.0 else num / den
        p = -1.0 if p < -1.0 else (1.0 if p >= 1.0 else p)
        cache[key] = p
        return p

    def test_dp_matches_recursion(self):
        data = self._rand_data()
        C = np.corrcoef(data, rowvar=False)
        for Zs in [(2,), (2, 3), (2, 3, 4), (5, 2, 3)]:
            k = len(Zs)
            idx = [0, 1] + list(Zs) + [0] * (3 - k)  # pad to max_k+2
            sub = C[np.ix_(idx, idx)]
            got = sf.pcor_dp(sub[None], np.array([k]), max_k=3)[0]
            exp = self._pcor_rec_scalar(0, 1, tuple(Zs), C, {})
            assert np.isclose(got, exp, rtol=0, atol=1e-14), (Zs, got, exp)

    def test_dp_matches_iterative(self):
        # recursive formula equals regression-based pcor up to fp noise
        # (reference cross-check: test/learning.jl:239-260)
        data = self._rand_data(seed=7)
        C = np.corrcoef(data, rowvar=False)
        for Zs in [(2,), (3, 4), (2, 4, 5)]:
            k = len(Zs)
            idx = [0, 1] + list(Zs) + [0] * (3 - k)
            sub = C[np.ix_(idx, idx)]
            got = sf.pcor_dp(sub[None], np.array([k]), max_k=3)[0]
            exp = sf.pcor_iterative(0, 1, Zs, data)
            assert np.isclose(got, exp, atol=1e-4), (Zs, got, exp)

    def test_jax_matches_numpy(self):
        data = self._rand_data(seed=3)
        C = np.corrcoef(data, rowvar=False)
        idx = [0, 1, 2, 3, 4]
        sub = C[np.ix_(idx, idx)][None]
        kvec = np.array([3])
        got_np = sf.pcor_dp(sub, kvec, max_k=3, xp=np)
        got_j = sf.pcor_dp(jnp.asarray(sub), jnp.asarray(kvec), max_k=3, xp=jnp)
        # XLA FMA contraction can flip the reference's 1e-5 rounding at exact
        # .5 boundaries; the reference itself tolerates atol=1e-4 here
        # (reference: test/statfuns.jl:31).
        np.testing.assert_allclose(got_np, np.asarray(got_j), atol=1e-4)


def test_mi_pval_smalldf_matches_gammaincc():
    rng = np.random.default_rng(1)
    mi = rng.exponential(0.02, 5000)
    n_obs = rng.integers(10, 9000, 5000)
    df = rng.integers(0, 9, 5000)
    ref = sf.mi_pval(mi, df, n_obs, xp=np)
    got = np.asarray(sf.mi_pval_smalldf(
        jnp.asarray(mi), jnp.asarray(df), jnp.asarray(n_obs), 8, xp=jnp
    ))
    np.testing.assert_allclose(got, ref, rtol=5e-12, atol=1e-300)
