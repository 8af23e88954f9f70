"""Differential parity vs the reference implementation itself.

The golden-value suites pin this repo's own fixtures; these tests go
further and diff ``ivclab_tpu`` against the actual reference modules
(loaded by file path, bypassing the ``constriction`` import — see
``ref_loader``) on identical inputs:

  DCT/IDCT            allclose        (ivclab/signal/dct.py)
  color transforms    allclose/exact  (ivclab/signal/color.py)
  zigzag flatten      exact           (ivclab/utils/shape.py, signal/zigzag.py)
  Patcher             exact           (ivclab/utils/shape.py)
  quant/dequant       exact           (ivclab/quantization/patchquant.py)
  zero-run streams    exact           (ivclab/entropy/zerorun.py)
  entropy stats       float tol       (ivclab/entropy/{entropy,probability}.py)
  predictor residuals exact/tol       (ivclab/image/predictive.py)
  motion search       exact           (ivclab/video/motion.py)
  metrics             float tol       (ivclab/utils/metrics.py)
"""

from __future__ import annotations

import numpy as np
import pytest

from ref_loader import load_reference

ref = load_reference()
pytestmark = pytest.mark.skipif(ref is None, reason="reference tree unavailable")


@pytest.fixture()
def patched():
    """Random patched image [Hp, Wp, C, 8, 8] float32."""
    return (np.random.default_rng(7).random((6, 8, 3, 8, 8)) * 255 - 128).astype(np.float32)


@pytest.fixture()
def rng_mod():
    """Per-test deterministic generator (order-independent)."""
    return np.random.default_rng(7)


def test_dct_matches_reference(patched):
    from ivclab_tpu.ops.dct import DiscreteCosineTransform

    r = ref["dct"].DiscreteCosineTransform()
    o = DiscreteCosineTransform()
    want = r.transform(patched)
    got = np.asarray(o.transform(patched))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    back = np.asarray(o.inverse_transform(got))
    np.testing.assert_allclose(back, r.inverse_transform(want), rtol=1e-4, atol=1e-2)


def test_color_transforms_match_reference(rng_mod):
    from ivclab_tpu.ops.color import rgb2gray, rgb2ycbcr, ycbcr2rgb

    img = (rng_mod.random((32, 48, 3)) * 255).astype(np.float64)
    np.testing.assert_allclose(np.asarray(rgb2ycbcr(img)), ref["color"].rgb2ycbcr(img), atol=1e-3)
    ycc = ref["color"].rgb2ycbcr(img)
    np.testing.assert_allclose(
        np.asarray(ycbcr2rgb(ycc)).astype(np.float64),
        ref["color"].ycbcr2rgb(ycc).astype(np.float64),
        atol=1.0,  # both clip+round to uint8-range ints; allow 1-count rounding skew
    )
    np.testing.assert_allclose(np.asarray(rgb2gray(img)), ref["color"].rgb2gray(img), atol=1e-3)


def test_zigzag_matches_reference(patched, rng_mod):
    from ivclab_tpu.utils.shape import ZigZag
    from ivclab_tpu.ops.dct import zigzag_scan

    r = ref["shape"].ZigZag()
    o = ZigZag()
    want = r.flatten(patched)
    got = np.asarray(o.flatten(patched))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(o.unflatten(got)), r.unflatten(want))

    block = rng_mod.integers(-128, 128, (8, 8)).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(zigzag_scan(block)), ref["zigzag"].zigzag_scan(block))


def test_patcher_matches_reference(rng_mod):
    from ivclab_tpu.utils.shape import Patcher

    img = (rng_mod.random((40, 64, 3)) * 255).astype(np.float32)
    r = ref["shape"].Patcher()
    o = Patcher()
    want = r.patch(img)
    got = np.asarray(o.patch(img))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.asarray(o.unpatch(got)), r.unpatch(want))


def test_patchquant_matches_reference(patched):
    from ivclab_tpu.ops.quant import PatchQuant

    for scale in (0.15, 1.0, 4.5):
        r = ref["patchquant"].PatchQuant(quantization_scale=scale)
        o = PatchQuant(quantization_scale=scale)
        np.testing.assert_array_equal(
            np.asarray(o.get_quantization_table()), r.get_quantization_table()
        )
        want_q = r.quantize(patched)
        got_q = np.asarray(o.quantize(patched))
        np.testing.assert_array_equal(got_q, want_q)
        np.testing.assert_array_equal(np.asarray(o.dequantize(got_q)), r.dequantize(want_q))


def test_zerorun_stream_matches_reference(rng_mod):
    from ivclab_tpu.ops.zerorun import ZeroRunCoder

    # sparse quantized-coefficient blocks in zigzag order [Hp, Wp, C, 64]
    flat = rng_mod.integers(-6, 7, (4, 5, 3, 64)).astype(np.int32)
    flat[np.abs(flat) < 4] = 0  # realistic zero density
    r = ref["zerorun"].ZeroRunCoder()
    o = ZeroRunCoder()
    want = r.encode(flat)
    got = o.encode(flat)
    np.testing.assert_array_equal(np.asarray(got, dtype=np.int64), np.asarray(want, dtype=np.int64))
    np.testing.assert_array_equal(o.decode(got, flat.shape[:3]), r.decode(want, flat.shape[:3]))
    np.testing.assert_array_equal(o.decode(got, flat.shape[:3]), flat)


def test_entropy_stats_match_reference(rng_mod):
    from ivclab_tpu.entropy.stats import calc_entropy, min_code_length, smooth_pmf, stats_marg

    img = rng_mod.integers(0, 256, (48, 56)).astype(np.uint8)
    pr = np.arange(256)
    want = ref["entropy"].stats_marg(img, pr)
    got = np.asarray(stats_marg(img, pr))
    np.testing.assert_allclose(got, want, atol=1e-12)
    np.testing.assert_allclose(
        float(calc_entropy(smooth_pmf(got))),
        ref["entropy"].calc_entropy(ref["entropy"].smooth_pmf(want)),
        atol=1e-5,  # device float32 log2 vs host float64
    )
    other = np.asarray(stats_marg(rng_mod.integers(0, 256, (48, 56)), pr))
    np.testing.assert_allclose(
        float(min_code_length(smooth_pmf(got), smooth_pmf(other))),
        ref["entropy"].min_code_length(
            ref["entropy"].smooth_pmf(want), ref["entropy"].smooth_pmf(np.asarray(other))
        ),
        atol=1e-5,
    )


def test_joint_and_cond_stats_match_reference(rng_mod):
    from ivclab_tpu.entropy.stats import stats_cond, stats_joint

    # the reference consumes [H, W, 1] grayscale (rgb2gray keeps the axis)
    img = rng_mod.integers(0, 256, (40, 64, 1)).astype(np.uint8)
    pr = np.arange(257)
    np.testing.assert_allclose(
        np.asarray(stats_joint(img, pr)), ref["probability"].stats_joint(img, pr), atol=1e-12
    )
    np.testing.assert_allclose(
        float(stats_cond(img, pr)), ref["probability"].stats_cond(img, pr), atol=1e-5
    )


def test_single_pixel_predictor_matches_reference(rng_mod):
    from ivclab_tpu.models.predictive import single_pixel_predictor

    # the reference workload is grayscale [H, W, 1] (tests/ch2.py:47-51); its
    # implementation drops the unpredictable first column, ours copies it
    # through (per the reference's own docstring) — compare the predicted part
    img = (rng_mod.random((24, 32, 1)) * 255).astype(np.float64)
    want = np.asarray(ref["predictive"].single_pixel_predictor(img))
    got = np.asarray(single_pixel_predictor(img))
    np.testing.assert_allclose(got[:, 1:].reshape(want.shape), want, atol=1e-3)


def _load_ref_min_entropy_predictor():
    """Extract exercises/ch2/ex_huffcoder.py:minimum_entropy_predictor.

    The module imports constriction/matplotlib at top level, so the
    function body is compiled alone via ast (its only dependency is np).
    """
    import ast
    from pathlib import Path

    path = Path("/root/reference/exercises/ch2/ex_huffcoder.py")
    if not path.is_file():
        return None
    tree = ast.parse(path.read_text())
    fn = next(
        (n for n in tree.body
         if isinstance(n, ast.FunctionDef) and n.name == "minimum_entropy_predictor"),
        None,
    )
    if fn is None:
        return None
    ns = {"np": np}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["minimum_entropy_predictor"]


def test_min_entropy_predictor_matches_reference(rng_mod):
    from ivclab_tpu.models.predictive import min_entropy_predictor

    ref_fn = _load_ref_min_entropy_predictor()
    if ref_fn is None:
        pytest.skip("reference ex_huffcoder.py unavailable")
    # int32 input: the reference's uint8 buffer wraps on the gradient case
    # (N + W - NW can leave [0, 255]); both sides get widened pixels so the
    # comparison is of the predictor rule, not the latent overflow
    img = (rng_mod.random((24, 32)) * 255).astype(np.int32)
    want_res, want_pred = ref_fn(img)
    got_res, got_pred = min_entropy_predictor(img)
    np.testing.assert_array_equal(got_res, np.asarray(want_res))
    np.testing.assert_array_equal(got_pred, np.asarray(want_pred))


def test_three_pixels_predictor_matches_reference(rng_mod):
    from ivclab_tpu.models.predictive import three_pixels_predictor

    img = (rng_mod.random((64, 64, 3)) * 255).astype(np.float64)
    for subsample in (False, True):
        want_y, want_c = ref["predictive"].three_pixels_predictor(img, subsample)
        got_y, got_c = three_pixels_predictor(img, subsample)
        # closed-loop DPCM over int32 residuals: exact wavefront parity on Y;
        # the chroma path runs through the float32 IIR decimate, whose ~4e-3
        # skew vs scipy's float64 can flip isolated roundings that the closed
        # loop then carries a step or two (bounded, coefficients sum to 1)
        np.testing.assert_array_equal(np.asarray(got_y).reshape(want_y.shape), want_y)
        got_c = np.asarray(got_c).reshape(want_c.shape)
        np.testing.assert_allclose(got_c, want_c, atol=3)
        assert (got_c == want_c).mean() > 0.98


def test_motion_search_matches_reference(rng_mod):
    from ivclab_tpu.ops.motion import MotionCompensator

    ref_img = (rng_mod.random((32, 40)) * 255).astype(np.float64)
    # shifted + noisy current frame so best offsets are nontrivial
    cur = np.roll(ref_img, (2, -3), axis=(0, 1)) + rng_mod.normal(0, 2, ref_img.shape)
    r = ref["motion"].MotionCompensator()
    o = MotionCompensator()
    want_mv = r.compute_motion_vector(ref_img, cur)
    got_mv = o.compute_motion_vector(ref_img, cur)
    np.testing.assert_array_equal(got_mv, want_mv)
    np.testing.assert_allclose(
        o.reconstruct_with_motion_vector(ref_img, got_mv),
        r.reconstruct_with_motion_vector(ref_img[:, :, None], want_mv)[:, :, 0],
        atol=1e-6,
    )


def test_rd_curve_matches_reference_pipeline():
    """Differential RD parity on the ch3 sweep (exercises/ch3/ex1.py:21-51):
    the reference's OWN image2symbols/symbols2image pipeline (loaded by
    file path; its symbol streams coded by this repo's canonical coder, so
    rate <= constriction's Huffman on the same pmf) against IntraCodec,
    per q: |dPSNR| < 0.1 dB, |dbpp| < 2%."""
    import contextlib
    import io

    from ivclab_tpu.models import IntraCodec
    from ivclab_tpu.utils import calc_psnr, fixtures

    ref_ic = ref["intracodec"]
    lena = fixtures.image("lena")
    lena_small = fixtures.image("lena_small")

    for q in (0.05, 0.15, 0.3):
        r = ref_ic.IntraCodec(quantization_scale=q)
        with contextlib.redirect_stdout(io.StringIO()):  # debug-print spray
            r.train_huffman_from_image(lena_small, is_source_rgb=True)
            bitstream, bpp_ref = r.intra_encode(lena, return_bpp=True)
            recon_ref = r.intra_decode(bitstream, lena.shape)
        psnr_ref = float(calc_psnr(lena, recon_ref))

        c = IntraCodec(quantization_scale=q)
        c.train_huffman_from_image(lena_small)
        recon, _, _, bpp = c.encode_decode(lena, return_bpp=True)
        psnr_ours = float(calc_psnr(lena, recon))

        assert abs(psnr_ours - psnr_ref) < 0.1, (q, psnr_ours, psnr_ref)
        assert abs(bpp - bpp_ref) / bpp_ref < 0.02, (q, bpp, bpp_ref)


def test_signal_helpers_match_reference(rng_mod):
    from ivclab_tpu.ops.resample import (
        downsample, interpolation_upsample, lowpass_filter, upsample,
    )

    x = (rng_mod.random((32, 40)) * 255).astype(np.float64)
    np.testing.assert_allclose(
        np.asarray(downsample(x)), ref["signal"].downsample(x), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(upsample(x)), ref["signal"].upsample(x), atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(interpolation_upsample(x, 2)),
        ref["signal"].interpolation_upsample(x, 2),
        atol=5e-3,
    )
    k = np.ones((3, 3)) / 9
    np.testing.assert_allclose(
        np.asarray(lowpass_filter(x, k)), ref["signal"].lowpass_filter(x, k), atol=1e-4
    )


def test_yuv420_matches_reference():
    """Full 4:2:0 chroma pipeline (decimate -> pad -> FFT resample -> crop)
    against the reference's own yuv420compression, loaded by file path.
    Both quantize to uint8; a ~1-per-million fraction of pixels lands on
    the other side of a rounding boundary (|diff| == 2 max)."""
    from ivclab_tpu.models.yuv420 import yuv420compression
    from ivclab_tpu.utils import fixtures

    img = fixtures.image("sail")
    ours = np.asarray(yuv420compression(img)).astype(np.float64)
    theirs = np.asarray(ref["yuv420"].yuv420compression(img)).astype(np.float64)
    diff = np.abs(ours - theirs)
    assert diff.max() <= 2.0
    assert (diff > 1).mean() < 1e-4


@pytest.mark.parametrize("mode,ref_key", [("fft", "ex_ict"), ("fir", "ex_ict_decimate")])
def test_ict_codec_matches_reference(mode, ref_key):
    """ICT + 4:2:0 codec variants against the reference ch1 study drivers
    (``exercises/ch1/ex_ict.py`` / ``ex_ict_decimate.py``), loaded by file
    path. The device pipeline runs float32 FFTs vs the reference's float64
    scipy.signal.resample; a small fraction of pixels lands on the other
    side of a rounding boundary."""
    from ivclab_tpu.models.yuv420 import ict_compression
    from ivclab_tpu.utils import fixtures
    from ivclab_tpu.utils.metrics import calc_psnr

    img = fixtures.image("sail")
    ours = np.asarray(ict_compression(img, chroma_mode=mode)).astype(np.float64)
    theirs = np.asarray(ref[ref_key].codec_ict(img)).astype(np.float64)
    assert np.abs(ours - theirs).mean() < 0.05
    psnr_ours = float(calc_psnr(img, ours))
    psnr_theirs = float(calc_psnr(img, theirs))
    assert abs(psnr_ours - psnr_theirs) < 0.1


def test_metrics_match_reference(rng_mod):
    from ivclab_tpu.utils.metrics import calc_mse, calc_psnr

    a = (rng_mod.random((32, 32, 3)) * 255).astype(np.float64)
    b = (rng_mod.random((32, 32, 3)) * 255).astype(np.float64)
    np.testing.assert_allclose(float(calc_mse(a, b)), ref["metrics"].calc_mse(a, b), rtol=1e-6)
    np.testing.assert_allclose(float(calc_psnr(a, b)), ref["metrics"].calc_psnr(a, b), rtol=1e-6)
