"""Real-image acceptance suite.

The reference's golden values are pinned to the course images
(lena.tif, lena_rec.tif, satpic1.bmp, sail.tif), which are distributed via
Moodle and not redistributable (``/root/reference/README.md:32-34``) — the
default test suite therefore pins its goldens to synthetic fixtures. When
the real images ARE available, point ``IVC_DATA_DIR`` at the directory
holding them and this module runs the reference's golden table verbatim
against ``ivclab_tpu``:

    IVC_DATA_DIR=/path/to/data python -m pytest tests/test_real_images.py

Golden values and tolerances are copied from the reference test suite
(``/root/reference/tests/ch1.py:11-17``, ``ch2.py:15-58``, ``ch3.py:18-47``).
Skipped (not failed) when the directory or a needed file is absent.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
import pytest

_DATA = os.environ.get("IVC_DATA_DIR")

pytestmark = pytest.mark.skipif(
    not _DATA or not Path(_DATA).is_dir(),
    reason="set IVC_DATA_DIR to the reference course-image directory",
)


def _load(name: str) -> np.ndarray:
    from ivclab_tpu.utils.io import imread

    path = Path(_DATA) / name
    if not path.exists():
        pytest.skip(f"{name} not present in IVC_DATA_DIR")
    return imread(str(path))


# ------------------------------------------------------------------- ch1


def test_ch1_mse_golden():
    from ivclab_tpu.utils import calc_mse

    mse = float(calc_mse(_load("lena.tif"), _load("lena_rec.tif")))
    assert abs(mse - 1849.6111) < 2.0  # tests/ch1.py:13


def test_ch1_psnr_golden():
    from ivclab_tpu.utils import calc_psnr

    psnr = float(calc_psnr(_load("lena.tif"), _load("lena_rec.tif")))
    assert abs(psnr - 15.4599) < 0.2  # tests/ch1.py:17


# ------------------------------------------------------------------- ch2


def test_ch2_marginal_entropy_golden():
    from ivclab_tpu.entropy.stats import calc_entropy, stats_marg

    pmf = stats_marg(_load("satpic1.bmp"), np.arange(256))
    assert abs(float(calc_entropy(pmf)) - 6.80779061643218) < 0.2  # ch2.py:18


def test_ch2_cross_entropy_golden():
    from ivclab_tpu.entropy.stats import min_code_length, stats_marg

    target = stats_marg(_load("satpic1.bmp"), np.arange(256))
    common = stats_marg(_load("lena.tif"), np.arange(256))
    assert abs(float(min_code_length(target, common)) - 7.423096098407454) < 0.2


def test_ch2_joint_entropy_golden():
    from ivclab_tpu.entropy.stats import calc_entropy, stats_joint

    joint = stats_joint(_load("satpic1.bmp"), np.arange(256))
    assert abs(float(calc_entropy(joint)) - 12.02494851967153) < 0.2  # ch2.py:35


def test_ch2_cond_entropy_golden():
    from ivclab_tpu.entropy.stats import stats_cond

    cond = float(stats_cond(_load("satpic1.bmp"), np.arange(256)))
    assert abs(cond - 5.22159752979922) < 0.2  # ch2.py:39


def test_ch2_single_pixel_predictor_golden():
    from ivclab_tpu.entropy.stats import calc_entropy, stats_marg
    from ivclab_tpu.models import single_pixel_predictor

    res = single_pixel_predictor(_load("sail.tif"))
    pmf = stats_marg(res, np.arange(-255, 255))
    assert abs(float(calc_entropy(pmf)) - 5.67565776280646) < 0.2  # ch2.py:51


def test_ch2_three_pixels_predictor_golden():
    from ivclab_tpu.entropy.stats import calc_entropy, stats_marg
    from ivclab_tpu.models import three_pixels_predictor

    res_y, res_cbcr = three_pixels_predictor(
        _load("sail.tif"), subsample_color_channels=False
    )
    merged = np.concatenate([np.asarray(res_y).ravel(), np.asarray(res_cbcr).ravel()])
    pmf = stats_marg(merged, np.arange(-255, 255))
    assert abs(float(calc_entropy(pmf)) - 3.850937452840888) < 0.2  # ch2.py:58


# ------------------------------------------------------------------- ch3


def test_ch3_dct_energy_golden():
    from ivclab_tpu.ops.dct import DiscreteCosineTransform
    from ivclab_tpu.utils.shape import Patcher

    patched = Patcher(window_size=(8, 8)).patch(_load("satpic1.bmp"))
    transformed = np.asarray(DiscreteCosineTransform(norm="ortho").transform(patched))
    assert abs(float(np.mean(transformed**2)) - 10616) < 100  # ch3.py:21


def test_ch3_dct_roundtrip_exact():
    from ivclab_tpu.ops.dct import DiscreteCosineTransform
    from ivclab_tpu.utils.shape import Patcher

    patched = Patcher(window_size=(8, 8)).patch(_load("satpic1.bmp"))
    dct = DiscreteCosineTransform(norm="ortho")
    recon = np.asarray(dct.inverse_transform(dct.transform(patched)))
    assert np.allclose(recon, np.asarray(patched), atol=1e-3)  # ch3.py:27


def test_ch3_quantized_energy_golden():
    from ivclab_tpu.ops.quant import PatchQuant
    from ivclab_tpu.utils.shape import Patcher

    patched = Patcher(window_size=(8, 8)).patch(_load("satpic1.bmp"))
    quantized = np.asarray(PatchQuant(quantization_scale=1.0).quantize(patched))
    assert abs(float(np.mean(quantized.astype(np.float64) ** 2)) - 7.5409901936848955) < 0.1


def test_ch3_quant_roundtrip_mse_golden():
    from ivclab_tpu.ops.quant import PatchQuant
    from ivclab_tpu.utils.metrics import calc_mse
    from ivclab_tpu.utils.shape import Patcher

    img = _load("satpic1.bmp")
    patcher = Patcher(window_size=(8, 8))
    quant = PatchQuant(quantization_scale=1.0)
    recon = patcher.unpatch(quant.dequantize(quant.quantize(patcher.patch(img))))
    assert abs(float(calc_mse(img, recon)) - 348.2207400004069) < 5  # ch3.py:47
