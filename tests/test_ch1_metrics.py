"""ch1-style golden metric tests (reference tests/ch1.py) on synthetic fixtures."""

import numpy as np

from ivclab_tpu.utils import calc_mse, calc_psnr


def test_mse_matches_numpy(lena, lena_rec):
    ours = float(calc_mse(lena, lena_rec))
    ref = np.mean((lena.astype(np.float64) - lena_rec.astype(np.float64)) ** 2)
    assert abs(ours - ref) < 0.5


def test_psnr_matches_formula(lena, lena_rec):
    ours = float(calc_psnr(lena, lena_rec))
    mse = np.mean((lena.astype(np.float64) - lena_rec.astype(np.float64)) ** 2)
    ref = 20 * np.log10(255.0 / np.sqrt(mse))
    assert abs(ours - ref) < 0.01


def test_gray_rgb_coercion(lena):
    gray = lena.mean(axis=-1)
    mse = float(calc_mse(gray, lena))
    ref = np.mean((np.stack([gray] * 3, -1).astype(np.float64) - lena.astype(np.float64)) ** 2)
    assert abs(mse - ref) < 0.5


def test_golden_values(lena, lena_rec):
    """Pinned golden values for the synthetic lena/lena_rec pair
    (regression contract in the style of reference tests/ch1.py:11-17)."""
    mse = float(calc_mse(lena, lena_rec))
    psnr = float(calc_psnr(lena, lena_rec))
    assert abs(mse - GOLDEN_MSE) < 2.0
    assert abs(psnr - GOLDEN_PSNR) < 0.2


# Computed once from the deterministic fixtures.
GOLDEN_MSE = 1237.0134
GOLDEN_PSNR = 17.2071
