"""Probability-mass and entropy statistics, device-native.

Reference parity: ``ivclab/entropy/entropy.py:6-72`` (stats_marg,
smooth_pmf, calc_entropy, min_code_length) and
``ivclab/entropy/probability.py:20-212`` (basic_histo, stats_joint,
stats_cond). All histograms are scatter-add ``bincount``s so they run on
the device; bin-edge semantics exactly reproduce ``np.histogram`` with an edge
array (B edges -> B-1 bins, last bin right-inclusive, out-of-range values
dropped) because the reference's golden entropy values depend on that
quirk (SURVEY.md component #10).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _edge_histogram(values, lo: int, hi: int):
    """Counts for integer-edge bins [lo, lo+1, ..., hi] (np.histogram rules).

    Returns ``counts`` of shape ``[hi - lo]``: bin i counts value lo+i,
    except the last bin which also absorbs value == hi.
    """
    v = jnp.asarray(values).reshape(-1)
    v = jnp.floor(v.astype(jnp.float32)).astype(jnp.int32)
    nbins = hi - lo
    off = jnp.where(v == hi, nbins - 1, v - lo)
    valid = (v >= lo) & (v <= hi)
    off = jnp.where(valid, off, 0)
    return jnp.zeros((nbins,), jnp.int32).at[off].add(valid.astype(jnp.int32))


def stats_marg(image, pixel_range):
    """Marginal pmf of pixel values over the given bin-edge array.

    Normalized by the *total* element count (so out-of-range values shrink
    the pmf mass, as in ivclab/entropy/entropy.py:21-29).
    """
    edges = np.asarray(pixel_range)
    counts = _edge_histogram(image, int(edges[0]), int(edges[-1]))
    total = int(np.prod(np.shape(image)))
    return counts.astype(jnp.float32) / total


def smooth_pmf(pmf, epsilon: float = 1e-9):
    """Add-epsilon smoothing + renormalize (ivclab/entropy/entropy.py:31-35)."""
    p = jnp.asarray(pmf, dtype=jnp.float32) + epsilon
    return p / jnp.sum(p)


def calc_entropy(pmf):
    """Shannon entropy ``-sum p log2 p`` over nonzero bins."""
    p = jnp.asarray(pmf, dtype=jnp.float32)
    logp = jnp.log2(jnp.where(p > 0, p, 1.0))
    return -jnp.sum(p * logp)


def min_code_length(target_pmf, common_pmf, eps: float = 1e-8):
    """Cross-entropy ``-sum p log2 (q + eps)`` (ivclab/entropy/entropy.py:69-72)."""
    p = jnp.asarray(target_pmf, dtype=jnp.float32)
    q = jnp.asarray(common_pmf, dtype=jnp.float32) + eps
    return -jnp.sum(p * jnp.log2(q))


def _pairs_nonoverlapping(image):
    """Non-overlapping horizontal pixel pairs -> ``[N, 2]``."""
    x = jnp.asarray(image)
    if x.ndim == 2:
        x = x[:, :, None]
    H, W, C = x.shape
    x = x[:, : (W // 2) * 2, :]
    return x.reshape(H, W // 2, 2, C).transpose(0, 1, 3, 2).reshape(-1, 2)


def _pairs_overlapping(image):
    """Overlapping horizontal pixel pairs -> ``[N, 2]``."""
    x = jnp.asarray(image)
    if x.ndim == 2:
        x = x[:, :, None]
    left = x[:, :-1, :].reshape(-1)
    right = x[:, 1:, :].reshape(-1)
    return jnp.stack([left, right], axis=-1)


def _joint_counts(pairs, lo: int, hi: int):
    """2-D integer-edge histogram (np.histogram2d rules) as flat bincount."""
    nbins = hi - lo
    v = jnp.floor(pairs.astype(jnp.float32)).astype(jnp.int32)
    off = jnp.where(v == hi, nbins - 1, v - lo)
    valid = jnp.all((v >= lo) & (v <= hi), axis=-1)
    off = jnp.where(valid[:, None], off, 0)
    flat = off[:, 0] * nbins + off[:, 1]
    return (
        jnp.zeros((nbins * nbins,), jnp.int32).at[flat].add(valid.astype(jnp.int32)),
        nbins,
    )


def stats_joint(image, pixel_range, to_flat: bool = True):
    """Joint pmf of non-overlapping horizontal pairs.

    Matches ``ivclab/entropy/probability.py:140-172``: bins are the full
    ``arange(last_edge + 2)`` edge array (one bin per value), normalized by
    the pair count.
    """
    edges = np.asarray(pixel_range)
    pairs = _pairs_nonoverlapping(image)
    counts, nbins = _joint_counts(pairs, 0, int(edges[-1]) + 1)
    pmf = counts.astype(jnp.float32) / jnp.sum(counts)
    return pmf if to_flat else pmf.reshape(nbins, nbins)


def stats_cond(image, pixel_range, eps: float = 1e-8, to_flat: bool = False):
    """Conditional entropy H(right | left) of overlapping horizontal pairs.

    Matches ``ivclab/entropy/probability.py:174-212`` including its use of
    the raw edge array for histogram2d (B edges -> B-1 bins).
    """
    edges = np.asarray(pixel_range)
    pairs = _pairs_overlapping(image)
    counts, nbins = _joint_counts(pairs, int(edges[0]), int(edges[-1]))
    table = counts.astype(jnp.float32).reshape(nbins, nbins)
    table = table / jnp.sum(table)
    p_x = jnp.sum(table, axis=1)
    table = table + eps
    p_x = p_x + eps
    return -jnp.sum(table * (jnp.log2(table) - jnp.log2(p_x)[:, None]))


def basic_histo(image):
    """256-bin intensity histogram(s) for 8-bit images.

    Grayscale -> ``[256]``; RGB -> tuple of three ``[256]`` histograms
    (ivclab/entropy/probability.py:20-48, vectorized).
    """
    x = jnp.clip(jnp.asarray(image), 0, 255).astype(jnp.int32)
    if x.ndim == 2:
        return jnp.zeros((256,), jnp.int32).at[x.reshape(-1)].add(1)
    if x.ndim == 3 and x.shape[2] == 3:
        return tuple(
            jnp.zeros((256,), jnp.int32).at[x[:, :, c].reshape(-1)].add(1) for c in range(3)
        )
    raise ValueError("Unsupported image format. Must be 2D grayscale or 3D RGB.")


def count_rgb_histogram(image, grayscale: bool = False):
    """Histogram over the packed 24-bit RGB cube (or 256 gray bins).

    Vectorized form of ``ivclab/entropy/probability.py:51-69``; returns a
    dict {packed_value: count} for color images.
    """
    img = np.asarray(image)
    if grayscale and img.ndim == 3:
        img = np.mean(img, axis=-1)
    if img.ndim == 2:
        return np.bincount(np.clip(img, 0, 255).astype(np.int64).ravel(), minlength=256)
    flat = img.reshape(-1, img.shape[2]).astype(np.int64)
    packed = flat[:, 0] * 256**2 + flat[:, 1] * 256 + flat[:, 2]
    values, counts = np.unique(packed, return_counts=True)
    return dict(zip(values.tolist(), counts.tolist()))


def histogram_int32(values, lo: int, hi: int, mask=None):
    """Device histogram of int32 symbols over [lo, hi).

    The codec-path primitive behind Huffman training: counts symbols into
    ``hi - lo`` bins with an optional validity mask (for padded symbol
    buffers). Out-of-range symbols are dropped.
    """
    v = jnp.asarray(values, dtype=jnp.int32).reshape(-1)
    valid = (v >= lo) & (v < hi)
    if mask is not None:
        valid = valid & jnp.asarray(mask, dtype=bool).reshape(-1)
    off = jnp.where(valid, v - lo, 0)
    return jnp.zeros((hi - lo,), jnp.int32).at[off].add(valid.astype(jnp.int32))
