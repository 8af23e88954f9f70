"""Orthonormal 8x8 DCT-II / DCT-III for block grids, as matmuls.

Reference parity: ``ivclab/signal/dct.py:4-46`` (scipy.fft.dct over the last
two axes). Two matmul formulations are provided:

1. Separable: ``Y = D @ X @ D.T`` over ``[..., 8, 8]`` blocks — two small
   matmuls, used by the class facade.
2. Kronecker ("fused"): blocks laid out as ``[N, 64]`` row-major vectors and
   transformed by one ``[64, 64]`` matmul ``y = x @ kron(D, D).T``. One
   large matmul instead of many 8x8 ones, and the zig-zag permutation is
   folded in for free by permuting the matrix rows (output arrives directly
   in JPEG scan order). The intra codec's whole transform front-end
   (DCT + quantize + zig-zag, ``ivclab/image/intracodec.py:69-75``) then
   collapses to one matmul + one multiply + one round.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np

from ivclab_tpu.utils.shape import zigzag_gather_indices


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int = 8) -> np.ndarray:
    """Orthonormal DCT-II matrix ``D`` with ``y = D @ x`` (float64).

    ``D[k, m] = s_k * cos(pi * (2m + 1) * k / (2n))``,
    ``s_0 = sqrt(1/n)``, ``s_k = sqrt(2/n)``.
    """
    k = np.arange(n)[:, None]
    m = np.arange(n)[None, :]
    D = np.cos(np.pi * (2 * m + 1) * k / (2 * n))
    D *= np.sqrt(2.0 / n)
    D[0] *= np.sqrt(0.5)
    return D


@functools.lru_cache(maxsize=None)
def dct2_kron_matrix(n: int = 8, zigzag: bool = True, inverse: bool = False) -> np.ndarray:
    """``[n*n, n*n]`` matrix applying the 2-D DCT to row-major flattened blocks.

    Forward: ``y_flat = K @ x_flat`` equals ``vec(D @ X @ D.T)``; with
    ``zigzag`` the rows are permuted so ``y`` is in JPEG scan order.
    Inverse maps (optionally scan-ordered) coefficients back to pixels.
    """
    D = dct_matrix(n)
    K = np.kron(D, D)
    if inverse:
        K = K.T  # orthonormal
        if zigzag:
            K = K[:, zigzag_gather_indices(n)]
    elif zigzag:
        K = K[zigzag_gather_indices(n), :]
    return np.ascontiguousarray(K)


def dct2(blocks):
    """Forward 2-D DCT on the last two axes of ``[..., n, n]``."""
    x = jnp.asarray(blocks, dtype=jnp.float32)
    D = jnp.asarray(dct_matrix(x.shape[-1]), dtype=jnp.float32)
    return jnp.einsum("ij,...jk,lk->...il", D, x, D, precision="highest", preferred_element_type=jnp.float32)


def idct2(blocks):
    """Inverse 2-D DCT on the last two axes of ``[..., n, n]``."""
    x = jnp.asarray(blocks, dtype=jnp.float32)
    D = jnp.asarray(dct_matrix(x.shape[-1]), dtype=jnp.float32)
    return jnp.einsum("ji,...jk,kl->...il", D, x, D, precision="highest", preferred_element_type=jnp.float32)


def dct2_fused(flat_blocks, zigzag: bool = True):
    """Fused forward transform: ``[N, 64]`` row-major blocks -> coefficients.

    Output is zig-zag scan ordered when ``zigzag`` (the default used by the
    codec path).
    """
    x = jnp.asarray(flat_blocks, dtype=jnp.float32)
    K = jnp.asarray(dct2_kron_matrix(int(np.sqrt(x.shape[-1])), zigzag=zigzag), dtype=jnp.float32)
    return jnp.dot(x, K.T, precision="highest", preferred_element_type=jnp.float32)


def idct2_fused(flat_coeffs, zigzag: bool = True):
    """Fused inverse: (scan-ordered) ``[N, 64]`` coefficients -> pixels."""
    x = jnp.asarray(flat_coeffs, dtype=jnp.float32)
    K = jnp.asarray(
        dct2_kron_matrix(int(np.sqrt(x.shape[-1])), zigzag=zigzag, inverse=True),
        dtype=jnp.float32,
    )
    return jnp.dot(x, K.T, precision="highest", preferred_element_type=jnp.float32)


class DiscreteCosineTransform:
    """Facade matching ``ivclab/signal/dct.py`` (transform/inverse_transform).

    Operates on ``[..., H_window, W_window]`` block tensors.
    """

    def __init__(self, norm: str = "ortho"):
        if norm != "ortho":
            raise NotImplementedError("only the orthonormal DCT is supported")
        self.norm = norm

    def transform(self, patched_img):
        return dct2(patched_img)

    def inverse_transform(self, transformed):
        return idct2(transformed)


def zigzag_scan(block):
    """Zig-zag scan a single ``[n, n]`` block to a ``[n*n]`` vector.

    Reference parity: ``ivclab/signal/zigzag.py:3-27`` (explicit index list
    there; derived permutation here).
    """
    x = jnp.asarray(block)
    n = x.shape[-1]
    if x.shape[-2] != n:
        raise ValueError("zigzag_scan expects a square block")
    return x.reshape(*x.shape[:-2], n * n)[..., zigzag_gather_indices(n)]
