"""Predictive (DPCM) image coding facades.

Reference parity: ``ivclab/image/predictive.py`` (single_pixel_predictor,
three_pixels_predictor) on top of the wavefront kernel in
``ivclab_tpu/ops/predictive.py``.

Note on single_pixel_predictor: the reference's channel loop overwrites its
output each iteration, returning only the *last* channel's ``[H, W-1]``
residual (predictive.py:27-31) — contradicting its own docstring. Here the
documented behavior is implemented: all channels, first column copied
verbatim, output shape equals the input shape (SURVEY-style bug fix, not a
copy).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ivclab_tpu.ops.color import rgb2ycbcr
from ivclab_tpu.ops.predictive import predict_from_neighbors
from ivclab_tpu.ops.resample import decimate_iir

COEFFS_Y = (7 / 8, -4 / 8, 5 / 8)
COEFFS_CBCR = (3 / 8, -2 / 8, 7 / 8)


def single_pixel_predictor(image):
    """Residual of the left-neighbor predictor ``R - L`` (a1 = 1).

    First column (no left neighbor) is copied from the original. Output is
    rounded and clipped to [-255, 255].
    """
    x = jnp.asarray(image, dtype=jnp.float32)
    residual = jnp.concatenate([x[:, :1], x[:, 1:] - x[:, :-1]], axis=1)
    return np.asarray(jnp.round(jnp.clip(residual, -255, 255)))


def min_entropy_predictor(image):
    """Open-loop LOCO-I (median / edge-detecting) predictor residuals.

    Reference parity: ``exercises/ch2/ex_huffcoder.py:76-116``. Per pixel,
    with N/W/NW the original (not reconstructed) neighbors:

      pred = min(N, W)      if NW >= max(N, W)   (edge above/left)
             max(N, W)      if NW <= min(N, W)
             N + W - NW     otherwise            (gradient plane)

    First row predicts from W, first column from N, pixel (0, 0) from 128.
    Open-loop means no wavefront dependency: the whole field is three
    shifted views and two selects, one fused elementwise pass. Arithmetic is int32
    (the reference's uint8 buffer can wrap on the gradient case; inputs
    here are widened first).

    Returns ``(residuals [H*W] int32 row-major, predicted [H, W] int32)``
    — the reference's output contract.
    """
    x = jnp.asarray(image, dtype=jnp.int32)
    if x.ndim == 3 and x.shape[2] == 1:  # [H, W, 1] grayscale (rgb2gray)
        x = x[:, :, 0]
    H, W = x.shape
    N = jnp.concatenate([jnp.zeros((1, W), jnp.int32), x[:-1]], axis=0)
    Wn = jnp.concatenate([jnp.zeros((H, 1), jnp.int32), x[:, :-1]], axis=1)
    NW = jnp.concatenate([jnp.zeros((H, 1), jnp.int32), N[:, :-1]], axis=1)
    mx = jnp.maximum(N, Wn)
    mn = jnp.minimum(N, Wn)
    pred = jnp.where(NW >= mx, mn, jnp.where(NW <= mn, mx, N + Wn - NW))
    pred = pred.at[0, :].set(Wn[0, :])  # first row: left neighbor
    pred = pred.at[:, 0].set(N[:, 0])   # first column: upper neighbor
    pred = pred.at[0, 0].set(128)
    residuals = (x - pred).reshape(-1)
    return np.asarray(residuals), np.asarray(pred)


def three_pixels_predictor(image, subsample_color_channels: bool = False):
    """Closed-loop 3-neighbor DPCM residuals for Y and CbCr.

    Y coefficients (7/8, -4/8, 5/8), CbCr (3/8, -2/8, 7/8); optional
    chroma decimation by 2 (order-8 Chebyshev-I IIR, zero-phase — the
    scipy.signal.decimate default the reference uses,
    predictive.py:121-125). Returns int32 residuals clipped to [-255, 255].
    """
    x = jnp.asarray(image, dtype=jnp.float32)
    ycbcr = rgb2ycbcr(x)
    Y = ycbcr[:, :, 0:1]
    CbCr = ycbcr[:, :, 1:3]

    residual_Y = predict_from_neighbors(Y, COEFFS_Y)

    if subsample_color_channels:
        cb = decimate_iir(decimate_iir(CbCr[:, :, 0], 2, axis=0), 2, axis=1)
        cr = decimate_iir(decimate_iir(CbCr[:, :, 1], 2, axis=0), 2, axis=1)
        CbCr = jnp.stack([cb, cr], axis=-1)
    residual_CbCr = predict_from_neighbors(CbCr, COEFFS_CBCR)

    residual_Y = np.asarray(jnp.round(jnp.clip(residual_Y, -255, 255))).astype(np.int32)
    residual_CbCr = np.asarray(jnp.round(jnp.clip(residual_CbCr, -255, 255))).astype(np.int32)
    return residual_Y, residual_CbCr
