"""The device-route parity checks that ``chip_smoke.py`` runs on the GPU:
exercised here on the CPU at small widths, and at real widths on a card
(``gpu`` marker)."""

import numpy as np
import pytest

from flashweave.utils import devcheck as dc


def test_check_fz_nz_univariate_small():
    res = dc.check_fz_nz_univariate(300, 256, tile=64, y_len=128)
    assert res["max_abs_r_err"] <= 1e-5


def test_check_turbo_window_small(monkeypatch):
    from flashweave.ops import condtests as ct

    monkeypatch.setattr(ct, "FORCE_DEV_DIGEST", True)
    res = dc.check_turbo_window(256, 256, m=6, W=16)
    assert res["slots_with_significant_tests"] > 0


def test_raw_count_table_shape():
    c = dc.raw_count_table(400, 100, seed=3)
    assert c.shape == (400, 100) and (c >= 0).all()
    assert 0.6 < (c == 0).mean() < 0.8
    assert (c.sum(axis=0) > 0).all()
    # OTUs of one group co-occur more than OTUs of different groups
    pres = (c > 0).astype(float)
    within = np.corrcoef(pres[:, 0], pres[:, 1])[0, 1]
    across = np.corrcoef(pres[:, 0], pres[:, 7])[0, 1]
    assert within > across + 0.2


@pytest.mark.gpu
def test_mi_univariate_real_width(gpu_device):
    dc.check_mi_univariate(8192, 8192, tile=512, y_len=1024)


@pytest.mark.gpu
def test_fz_nz_univariate_real_width(gpu_device):
    dc.check_fz_nz_univariate(8192, 8192, tile=512, y_len=1024)


@pytest.mark.gpu
def test_turbo_window_real_width(gpu_device):
    dc.check_turbo_window(2048, 4096, m=8, W=512)
