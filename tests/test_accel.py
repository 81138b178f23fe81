"""Path choice, precision of the decision-grade products, the compile
cache location, and the chip smoke script's refusal to run without a GPU."""

import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flashweave.utils import accel
from flashweave.utils.cache import CACHE_ENV, configure_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_on_accelerator_follows_backend(monkeypatch):
    assert accel.on_accelerator() is False          # the tests run on CPU
    assert accel.on_accelerator(force=True) is True
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert accel.on_accelerator() is True


def test_path_choice_is_made_in_one_place():
    """No module chooses a path by the backend's name except the capability
    module, and no Pallas call infers interpret mode."""
    pkg = os.path.join(ROOT, "flashweave")
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith(".py") or f == "accel.py":
                continue
            src = open(os.path.join(dirpath, f)).read()
            assert "default_backend()" not in src, f
            for m in re.finditer(r"interpret=([^,)\n]+)", src):
                assert m.group(1).strip() in ("interpret", "False"), (f, m)


def _dot_precisions(fn, *args):
    txt = jax.jit(fn).lower(*args).as_text()
    dots = [ln for ln in txt.splitlines() if "dot_general" in ln]
    return [("HIGHEST" if "HIGHEST" in ln else "DEFAULT") for ln in dots]


def _fz_nz(x):
    from flashweave.ops.univariate import fz_nz_block

    return fz_nz_block(x, 0, 16, 0, 32)


def _masked_cor(x):
    from flashweave.ops.condtests import _masked_cor_kernel

    B, m = 8, 4
    idx = jnp.arange(B * m, dtype=jnp.int32).reshape(B, m) % x.shape[1]
    return _masked_cor_kernel(x, idx[:, 0], idx[:, 1], idx, B, m)


def _cont_digest(x):
    from flashweave.ops.condtests import _cont_digest_fn

    nseg, NCc, Bseg, mv, max_k = 1, 4, 16, 8, 3
    fn = _cont_digest_fn(None, nseg, NCc, Bseg, mv, max_k, True, False)
    VI = (jnp.arange(nseg * NCc * mv) % x.shape[1]).reshape(nseg, NCc, mv)
    POS = jnp.zeros((nseg, Bseg, max_k), jnp.int8)
    KV = jnp.ones((nseg, Bseg), jnp.int8)
    cnt = jnp.full((nseg, NCc), Bseg // NCc, jnp.int32)
    return fn(x, VI, POS, KV, cnt, jnp.float32(-4.6), jnp.float32(0.0))


def _cor_onfly(x):
    from flashweave.ops.condtests import _fz_cond_onfly_kernel
    from flashweave.ops.univariate import _fz_center

    xc, ssd = _fz_center(x)
    B, max_k = 8, 3
    X = jnp.arange(B, dtype=jnp.int32)
    Zs = jnp.zeros((B, max_k), jnp.int32) + 5
    return _fz_cond_onfly_kernel(xc, ssd, X, X + 1, Zs,
                                 jnp.full(B, 2, jnp.int32), B, max_k)


@pytest.mark.parametrize("fn, expect", [
    # the joint count multiplies 0/1 operands (exact at any precision);
    # the five value moments must be HIGHEST
    (_fz_nz, ["DEFAULT"] + ["HIGHEST"] * 5),
    (_masked_cor, ["HIGHEST"]),
    (_cont_digest, ["HIGHEST"]),      # the per-test submatrix is a gather
    (_cor_onfly, ["HIGHEST"]),
], ids=["fz_nz_moments", "masked_cor_gram", "cont_digest", "fz_onfly_gram"])
def test_decision_grade_products_are_highest(fn, expect):
    x = jnp.asarray(np.random.default_rng(0).standard_normal((64, 40)),
                    jnp.float32)
    assert sorted(_dot_precisions(fn, x)) == sorted(expect)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.setenv(CACHE_ENV, str(tmp_path / "c"))
    assert configure_compile_cache(ROOT) == str(tmp_path / "c")
    assert "jax_compilation_cache_dir" not in calls


def test_compile_cache_defaults_inside_checkout(monkeypatch):
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv(CACHE_ENV, raising=False)
    path = configure_compile_cache(ROOT)
    assert path == os.path.join(ROOT, ".jax_cache")
    assert calls["jax_compilation_cache_dir"] == path


@pytest.mark.parametrize("alone", [False, True],
                         ids=["no_gpu", "script_alone"])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        dst = tmp_path / "chip_smoke.py"
        dst.write_text(open(script).read())
        script, cwd = str(dst), str(tmp_path)
    else:
        cwd = ROOT
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_main_path_does_not_import_h5py():
    """h5py is imported lazily, for HDF5 formats only."""
    code = (
        "import sys, numpy as np, jax; jax.config.update('jax_platforms', "
        "'cpu'); import flashweave as fw; "
        "d = np.random.default_rng(0).poisson(2.0, (60, 12)).astype(float); "
        "fw.learn_network(d, sensitive=True, max_k=1, verbose=False); "
        "print('h5py' in sys.modules)")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "False"
