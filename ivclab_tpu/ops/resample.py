"""Sampling-rate conversion and filtering, XLA-native.

Reference parity: ``ivclab/signal/signal.py`` (downsample/upsample/
interpolation_upsample/lowpass_filter/FilterPipeline) and the scipy calls it
leans on — ``scipy.signal.decimate(ftype='fir', zero_phase=True)``,
``scipy.signal.resample`` (FFT method), ``scipy.ndimage.zoom(order=1)``.
Those native-library routines are re-implemented here on top of
``lax.conv_general_dilated`` / ``jnp.fft`` so the whole chroma pipeline
stays on device and fuses.

Boundary handling uses symmetric padding (the reference pads explicitly in
``ivclab/image/yuv420codec.py:31-47`` for the same reason); the FIR
anti-alias filter is the same Hamming-windowed sinc family scipy's
``decimate`` uses (length ``20*q + 1``, cutoff ``1/q``), applied zero-phase
via its linear-phase symmetry.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def downsample(image, factor: int = 2):
    """Keep every ``factor``-th pixel (ivclab/signal/signal.py:6-20)."""
    x = jnp.asarray(image)
    return x[0::factor, 0::factor]


def upsample(image, factor: int = 2):
    """Zero-insertion upsampling (ivclab/signal/signal.py:22-39)."""
    x = jnp.asarray(image)
    H, W = x.shape[0], x.shape[1]
    out_shape = (factor * H, factor * W) + x.shape[2:]
    out = jnp.zeros(out_shape, dtype=x.dtype)
    return out.at[0::factor, 0::factor].set(x)


def interpolation_upsample(image, factor: int = 2, classic: bool = False):
    """Bilinear upsampling (ivclab/signal/signal.py:41-57).

    Matches ``scipy.ndimage.zoom(order=1)`` semantics: output size
    ``factor*H`` with corner-aligned sample positions.
    """
    if classic:
        return upsample(image, factor)
    x = jnp.asarray(image, dtype=jnp.float32)
    H, W = x.shape[0], x.shape[1]
    oH, oW = factor * H, factor * W

    # scipy.ndimage.zoom maps output grid [0, oH-1] onto input [0, H-1]
    # (corner-aligned); separable bilinear gather reproduces that exactly.
    def axis_weights(n, on):
        pos = jnp.arange(on, dtype=jnp.float32) * ((n - 1) / (on - 1))
        i0 = jnp.clip(jnp.floor(pos).astype(jnp.int32), 0, n - 2)
        return i0, pos - i0.astype(jnp.float32)

    y0, fy = axis_weights(H, oH)
    x0, fx = axis_weights(W, oW)
    fy = fy.reshape(-1, *([1] * (x.ndim - 1)))
    fx = fx.reshape(1, -1, *([1] * (x.ndim - 2)))
    top = x[y0][:, x0] * (1 - fx) + x[y0][:, x0 + 1] * fx
    bot = x[y0 + 1][:, x0] * (1 - fx) + x[y0 + 1][:, x0 + 1] * fx
    return top * (1 - fy) + bot * fy


@functools.lru_cache(maxsize=None)
def antialias_fir_taps(q: int) -> np.ndarray:
    """Hamming-windowed sinc lowpass, length ``20*q + 1``, cutoff ``1/q``.

    The same design scipy's ``decimate(ftype='fir')`` defaults to; unity DC
    gain.
    """
    numtaps = 20 * q + 1
    cutoff = 1.0 / q
    n = np.arange(numtaps) - (numtaps - 1) / 2.0
    h = cutoff * np.sinc(cutoff * n)
    h *= np.hamming(numtaps)
    h /= h.sum()
    return h.astype(np.float32)


def _conv1d_same(x2d, taps, axis: int, boundary: str = "symmetric"):
    """Convolve a 2-D array along one axis, same size.

    ``boundary``: 'symmetric' (even reflection) or 'zero'.
    """
    taps = jnp.asarray(taps, dtype=jnp.float32)
    k = taps.shape[0]
    lo, hi = (k - 1) // 2, k // 2
    pad = [(0, 0), (0, 0)]
    pad[axis] = (lo, hi)
    x2d = x2d.astype(jnp.float32)
    if boundary == "zero":
        xp = jnp.pad(x2d, pad, mode="constant")
    else:
        xp = jnp.pad(x2d, pad, mode="symmetric")
    if axis == 0:
        lhs = xp.T[:, None, :]  # [batch=W, chan=1, length=H+pad]
    else:
        lhs = xp[:, None, :]
    rhs = taps[::-1][None, None, :]  # convolution (not correlation)
    out = jax.lax.conv_general_dilated(
        lhs, rhs, (1,), "VALID", precision=jax.lax.Precision.HIGHEST
    )[:, 0, :]
    return out.T if axis == 0 else out


def decimate(x, q: int = 2, axis: int = 0):
    """FIR anti-alias filter + keep every ``q``-th sample, zero phase.

    Exact equivalent of ``scipy.signal.decimate(x, q, ftype='fir',
    zero_phase=True)`` as used by ``ivclab/image/yuv420codec.py:88-92`` and
    ``ivclab/image/predictive.py:121-125``: scipy implements that as a
    centered single-pass polyphase FIR (``resample_poly``) with zero-padded
    boundaries — the callers pre-pad symmetrically themselves to soften the
    edges (yuv420codec.py:85-86).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim != 2:
        raise ValueError("decimate expects a 2-D plane")
    y = _conv1d_same(x, antialias_fir_taps(q), axis, boundary="zero")
    sl = [slice(None), slice(None)]
    sl[axis] = slice(0, None, q)
    return y[tuple(sl)]


# scipy.signal.cheby1(8, 0.05, 0.8/2) — the anti-alias IIR that
# scipy.signal.decimate(q=2) defaults to (used by the reference's
# three-pixel predictor chroma path, ivclab/image/predictive.py:122-123).
# Derived once offline; kept as float64 constants so the filter is not a
# runtime scipy dependency.
_CHEBY1_Q2_B = np.array([
    0.00069873707728414, 0.00558989661827313, 0.01956463816395597,
    0.03912927632791193, 0.04891159540988991, 0.03912927632791193,
    0.01956463816395597, 0.00558989661827313, 0.00069873707728414,
])
_CHEBY1_Q2_A = np.array([
    1.0, -3.159100504614808, 5.967108107202708, -7.519348642687463,
    6.827184931315479, -4.482072321959029, 2.070876731225458,
    -0.6163275358434664, 0.09158859355707848,
])
# scipy.signal.lfilter_zi(b, a): steady-state initial conditions filtfilt
# seeds each pass with (scaled by the first extended sample).
_CHEBY1_Q2_ZI = np.array([
    0.9935613368756748, -2.1529960610857475, 3.760296648702961,
    -3.7550207651814698, 2.9840650341088955, -1.511409800512511,
    0.528015613259219, -0.09036414472602423,
])


def _lfilter_scan(b, a, x, zi=None):
    """Order-N IIR over axis 0 (direct form II transposed, lax.scan).

    The sequential recursion is the filter definition; the scan runs it in
    lockstep across the other axis. float32 on device — the
    cheby1 q=2 filter is well-conditioned enough for image-range data.
    ``zi``: optional [n-1, B] initial state.
    """
    b = jnp.asarray(b, dtype=jnp.float32)
    a = jnp.asarray(a, dtype=jnp.float32)
    n = b.shape[0]
    B = x.shape[1]

    def step(z, xk):
        yk = b[0] * xk + z[0]
        znew = jnp.stack(
            [b[i] * xk + z[i] - a[i] * yk for i in range(1, n - 1)]
            + [b[n - 1] * xk - a[n - 1] * yk],
            axis=0,
        )
        return znew, yk

    z0 = jnp.zeros((n - 1, B), dtype=jnp.float32) if zi is None else zi
    _, y = jax.lax.scan(step, z0, x)
    return y


def _filtfilt(b, a, zi, x, axis: int):
    """Zero-phase IIR: scipy.signal.filtfilt defaults (odd-reflection
    padding, padlen = 3 * max(len(a), len(b)), passes seeded with
    ``lfilter_zi * first_sample``)."""
    n = max(len(b), len(a))
    pad = 3 * n
    zi = jnp.asarray(zi, dtype=jnp.float32)[:, None]
    xt = x.T if axis == 1 else x
    top = 2.0 * xt[0] - xt[pad:0:-1]
    bot = 2.0 * xt[-1] - xt[-2 : -pad - 2 : -1]
    ext = jnp.concatenate([top, xt, bot], axis=0)
    y = _lfilter_scan(b, a, ext, zi * ext[0][None, :])
    yr = y[::-1]
    y = _lfilter_scan(b, a, yr, zi * yr[0][None, :])[::-1]
    y = y[pad:-pad]
    return y.T if axis == 1 else y


def decimate_iir(x, q: int = 2, axis: int = 0):
    """IIR anti-alias decimate: ``scipy.signal.decimate(x, q)`` defaults
    (order-8 Chebyshev-I, zero-phase via filtfilt), as the reference's
    predictive chroma subsampling uses (``ivclab/image/predictive.py:122``).
    Only q=2 is supported (the only factor the reference uses)."""
    if q != 2:
        raise NotImplementedError("decimate_iir supports q=2 only")
    x = jnp.asarray(x, dtype=jnp.float32)
    if x.ndim != 2:
        raise ValueError("decimate_iir expects a 2-D plane")
    y = _filtfilt(_CHEBY1_Q2_B, _CHEBY1_Q2_A, _CHEBY1_Q2_ZI, x, axis)
    sl = [slice(None), slice(None)]
    sl[axis] = slice(0, None, q)
    return y[tuple(sl)]


def fft_resample(x, num: int, axis: int = 0):
    """Fourier-domain resampling of a real signal along ``axis``.

    Device equivalent of ``scipy.signal.resample`` (used for chroma
    upsampling in ``ivclab/image/yuv420codec.py:101-107`` and the filter
    pipeline ``ivclab/signal/signal.py:110-113``).
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    n = x.shape[axis]
    if num == n:
        return x
    X = jnp.fft.fft(x, axis=axis)
    keep = min(n, num)
    nyq = keep // 2 + 1

    def take(arr, start, stop):
        sl = [slice(None)] * arr.ndim
        sl[axis] = slice(start, stop)
        return arr[tuple(sl)]

    # Spectrum surgery happens on float re/im planes (complex constants and
    # complex scatters are not lowered by every backend); fft of existing
    # complex values is fine.
    def build(part):
        pos = take(part, 0, nyq)
        neg = keep - nyq
        negative = take(part, n - neg, n) if neg > 0 else None
        if keep % 2 == 0:
            nyq_bin = take(part, nyq - 1, nyq)
            if num > n:
                # upsampling: split the Nyquist bin between +/- frequencies
                half = nyq_bin * 0.5
                pos = jnp.concatenate([take(part, 0, nyq - 1), half], axis=axis)
                mirror = half if part is not None else half
                negative = (
                    jnp.concatenate([mirror, negative], axis=axis)
                    if negative is not None
                    else mirror
                )
            elif num < n:
                # downsampling: fold the mirrored bin into the new Nyquist
                folded = nyq_bin + take(part, n - nyq + 1, n - nyq + 2)
                pos = jnp.concatenate([take(part, 0, nyq - 1), folded], axis=axis)
        mid_len = num - pos.shape[axis] - (negative.shape[axis] if negative is not None else 0)
        mid_shape = list(part.shape)
        mid_shape[axis] = mid_len
        pieces = [pos]
        if mid_len > 0:
            pieces.append(jnp.zeros(mid_shape, dtype=part.dtype))
        if negative is not None:
            pieces.append(negative)
        return jnp.concatenate(pieces, axis=axis)

    re = build(jnp.real(X))
    im_full = jnp.imag(X)
    if keep % 2 == 0 and num > n:
        # the mirrored +Nyquist-half is conjugated on the negative side
        im = build(im_full)
        # fix the sign of the mirrored bin (first element of the negative span)
        neg_len = (keep - nyq) + 1
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(num - neg_len, num - neg_len + 1)
        im = im.at[tuple(sl)].multiply(-1.0)
    else:
        im = build(im_full)

    Y = jax.lax.complex(re, im)
    y = jnp.fft.ifft(Y, axis=axis) * (num / n)
    return jnp.real(y)


# scipy.signal.resample alias under the reference's import name
resample = fft_resample


def lowpass_filter(image, kernel):
    """Normalized-kernel 2-D convolution, symmetric boundary, same size.

    Reference parity: ``ivclab/signal/signal.py:59-73`` (scipy
    ``convolve2d(mode='same', boundary='symm')``). Accepts ``[H, W]`` or
    ``[H, W, C]``.
    """
    x = jnp.asarray(image, dtype=jnp.float32)
    kernel = np.asarray(kernel, dtype=np.float64)
    kernel = (kernel / kernel.sum()).astype(np.float32)
    kh, kw = kernel.shape
    squeeze = x.ndim == 2
    if squeeze:
        x = x[:, :, None]
    xp = jnp.pad(x, ((kh // 2, (kh - 1) // 2), (kw // 2, (kw - 1) // 2), (0, 0)), mode="symmetric")
    lhs = xp.transpose(2, 0, 1)[:, None]  # [C, 1, H+, W+]
    rhs = jnp.asarray(kernel)[::-1, ::-1][None, None]
    out = jax.lax.conv_general_dilated(
        lhs, rhs, (1, 1), "VALID", precision=jax.lax.Precision.HIGHEST
    )[:, 0]
    out = out.transpose(1, 2, 0)
    return out[..., 0] if squeeze else out


class FilterPipeline:
    """Pre-filter -> decimate x2 -> FFT-resample back -> post lowpass.

    Reference parity: ``ivclab/signal/signal.py:75-128``. Note the
    reference's ``filter_img`` is accidentally defined at module level (its
    ``self`` argument never binds — SURVEY.md component #6); here it is an
    actual method.
    """

    PRE_KERNEL = np.array([[1, 2, 1], [2, 4, 2], [1, 2, 1]], dtype=np.float64)
    POST_KERNEL = np.array([[1, 1, 1], [1, 2, 1], [1, 1, 1]], dtype=np.float64)

    def __init__(self, kernel=None):
        kernel = self.PRE_KERNEL if kernel is None else np.asarray(kernel, dtype=np.float64)
        self.kernel = kernel / kernel.sum()

    def filter_img(self, image, prefilter: bool = True):
        x = jnp.asarray(image, dtype=jnp.float32)
        H, W = x.shape[0], x.shape[1]
        if x.ndim == 2:
            x = x[:, :, None]

        def per_channel(plane):
            out = plane
            if prefilter:
                out = lowpass_filter(out, self.kernel)
            out = decimate(decimate(out, 2, axis=0), 2, axis=1)
            out = fft_resample(fft_resample(out, H, axis=0), W, axis=1)
            return lowpass_filter(out, self.POST_KERNEL)

        out = jnp.stack([per_channel(x[:, :, c]) for c in range(x.shape[2])], axis=-1)
        out = jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
        return out[..., 0] if image.ndim == 2 else out
