"""The fused intra transform pipeline: image plane(s) <-> coded symbols.

This is the data-parallel reshape of the reference's 5-stage object pipeline
(``ivclab/image/intracodec.py:66-78``: patch -> DCT -> quantize -> zigzag ->
zero-run). Here the whole front-end is one jitted program over
``[num_blocks, 64]`` tensors:

  pixels --(one [N,64]x[64,64] matmul: DCT with zig-zag folded into the
  matrix rows)--> scan-ordered coefficients --(multiply by reciprocal
  table + round, fused into the matmul epilogue by XLA)--> quantized
  symbols --(vectorized zero-run scatter)--> per-block symbol buffers
  --(code gather + prefix-sum bit layout + scatter-add pack)--> bitstream.

The decode direction mirrors it, block-parallel end to end.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ivclab_tpu.ops.bitpack import (
    pack_codes,
    pack_codes_grouped_dense,
    symbol_bit_layout,
)
from ivclab_tpu.ops.dct import dct2_fused, idct2_fused
from ivclab_tpu.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks_dense
from ivclab_tpu.entropy.stats import histogram_int32


def blocks_from_plane(img, block: int = 8):
    """``[H, W, C]`` -> row-major flat blocks ``[hp*wp*C, block*block]``.

    Block order is (h, w, c) to match the reference's symbol stream
    ordering (``ivclab/entropy/zerorun.py:15`` rearrange 'h w c p').
    """
    H, W, C = img.shape
    x = img.reshape(H // block, block, W // block, block, C)
    x = x.transpose(0, 2, 4, 1, 3)
    return x.reshape(-1, block * block)


def plane_from_blocks(blocks, shape, block: int = 8):
    """Inverse of :func:`blocks_from_plane`."""
    H, W, C = shape
    x = blocks.reshape(H // block, W // block, C, block, block)
    x = x.transpose(0, 3, 1, 4, 2)
    return x.reshape(H, W, C)


@partial(jax.jit, static_argnames=("eob",))
def forward_symbolize(img_ycbcr, inv_qtable_zz, eob: int = 4000):
    """YCbCr plane(s) -> zero-run symbol buffers.

    img_ycbcr: ``[H, W, C]`` float32 (H, W multiples of 8)
    inv_qtable_zz: ``[C, 64]`` reciprocal quantization table, scan order
    returns: (buf ``[N, BLOCK_CAP]`` int32, valid_len ``[N]`` int32,
              qsym ``[N, 64]`` int32 scan-ordered quantized coefficients)
    """
    H, W, C = img_ycbcr.shape
    flat = blocks_from_plane(img_ycbcr.astype(jnp.float32))
    coeffs = dct2_fused(flat)  # [N, 64], zig-zag order
    inv = jnp.asarray(inv_qtable_zz, dtype=jnp.float32)
    scaled = coeffs.reshape(H // 8, W // 8, C, 64) * inv[None, None]
    qsym = jnp.round(scaled).astype(jnp.int32).reshape(-1, 64)
    # dense (scatter-free) encode: identical buffers to
    # zerorun_encode_blocks, without scatters (chosen for the first target
    # hardware, where scatters serialized) — the one-hot deposit is a fused
    # reduce. Its cost is
    # linear in the slot capacity, and typical codec content peaks well
    # under 32 symbols/block, so encode at a small capacity and zero-pad
    # to BLOCK_CAP — falling back to the full-capacity pass (identical
    # output) when any block overflows. One branch executes per call.
    from ivclab_tpu.ops.zerorun import zerorun_counts

    FAST_CAP = 32
    counts = zerorun_counts(qsym, 64)

    def fast():
        buf_s, valid_s = zerorun_encode_blocks_dense(qsym, 64, eob, FAST_CAP)
        pad = jnp.zeros((buf_s.shape[0], BLOCK_CAP - FAST_CAP), jnp.int32)
        return jnp.concatenate([buf_s, pad], axis=1), valid_s

    def full():
        return zerorun_encode_blocks_dense(qsym, 64, eob, BLOCK_CAP)

    buf, valid_len = jax.lax.cond(jnp.max(counts) <= FAST_CAP, fast, full)
    return buf, valid_len, qsym


@partial(jax.jit, static_argnames=("shape",))
def inverse_reconstruct(qsym, qtable_zz, shape):
    """Scan-ordered quantized coefficients -> YCbCr plane(s).

    Dequantization truncates toward zero to int32 for parity with the
    reference (``ivclab/quantization/patchquant.py:78`` astype(int32)).
    """
    H, W, C = shape
    table = jnp.asarray(qtable_zz, dtype=jnp.float32)
    deq = (qsym.reshape(H // 8, W // 8, C, 64).astype(jnp.float32) * table[None, None]).astype(jnp.int32)
    pix = idct2_fused(deq.reshape(-1, 64).astype(jnp.float32))
    return plane_from_blocks(pix, shape)


@partial(jax.jit, static_argnames=("lo", "hi"))
def symbol_histogram(buf, valid_len, lo: int, hi: int):
    """Device histogram of the valid symbols (Huffman training input)."""
    N, cap = buf.shape
    pos = jnp.arange(cap, dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    return histogram_int32(buf, lo, hi, mask=mask)


@partial(jax.jit, static_argnames=("num_words", "lower_bound"))
def pack_symbols(buf, valid_len, enc_codes, enc_lens, num_words: int, lower_bound: int):
    """Huffman-pack per-block symbol buffers into one u32 stream.

    Returns (words ``[num_words]`` u32, total_bits, block_bit_offsets ``[N]``).
    Invalid (padded) slots encode zero bits, so the packed stream equals the
    serial encoding of the compacted symbol sequence.
    """
    N, cap = buf.shape
    pos = jnp.arange(cap, dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    idx = jnp.clip(buf - lower_bound, 0, enc_lens.shape[0] - 1)
    lens = jnp.where(mask, enc_lens[idx], 0).reshape(-1)
    codes = jnp.where(mask, enc_codes[idx], 0).reshape(-1)
    off, total = symbol_bit_layout(lens)
    words = pack_codes(codes, lens, off, num_words)
    block_offsets = off.reshape(N, cap)[:, 0]
    return words, total, block_offsets


# Group geometry for the two-level packer: 16 blocks per word-aligned
# substream. Worst case 16 blocks x 97 symbols x 32 bits = 1552 words.
PACK_GROUP = 16
GROUP_WORDS = 1600


@partial(jax.jit, static_argnames=("lower_bound",))
def pack_symbols_grouped(buf, valid_len, enc_codes, enc_lens, lower_bound: int):
    """Huffman-pack per-block buffers into word-aligned group substreams.

    The scatter-free path (see ``pack_codes_grouped_dense``): scatters
    stay row-local. Blocks are grouped ``PACK_GROUP`` at a time; each group's
    stream starts word-aligned. Returns:
      group_words  [G, GROUP_WORDS] u32
      group_bits   [G] i32   (exact payload bits, no padding)
      block_bit_offsets [N] i32  — offsets into group_words.reshape(-1)
                                    viewed as one bit stream
      total_bits   i32 scalar (sum of code lengths = payload rate)
    ``N`` must be a multiple of PACK_GROUP (pad with empty blocks upstream).
    """
    N, cap = buf.shape
    G = N // PACK_GROUP
    pos = jnp.arange(cap, dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    # Out-of-alphabet symbols clamp to the alphabet EDGE. The reference's
    # first-p-frame policy clamps to the NEAREST TRAINED symbol
    # (exercises/ch4/ex1.py:163-176); these are the same mapping because
    # codebooks are trained over contiguous bucketed bounds [lo, hi)
    # covering the training min/max (models/intracodec.py bucket_bounds),
    # so the nearest in-alphabet value to any outside symbol IS the edge
    # (asserted by tests/test_ch4_video.py::test_edge_clamp_equals_nearest_trained).
    idx = jnp.clip(buf - lower_bound, 0, enc_lens.shape[0] - 1)
    lens = jnp.where(mask, enc_lens[idx], 0)
    codes = jnp.where(mask, enc_codes[idx], 0)

    del G
    group_words, group_bits, block_offsets = pack_codes_grouped_dense(
        codes, lens, PACK_GROUP, GROUP_WORDS
    )
    total_bits = jnp.sum(group_bits)
    return group_words, group_bits, block_offsets, total_bits


# Speculative pack buckets for the per-frame-adaptive paths: measured
# content at 1080p/q=1.0 peaks at ~51 used words per 16-block group, and
# the full-stride (1600-word) packer arena is 12.5x as wide as the 128-word
# one. Callers validate adequacy from the returned
# (group_bits, offsets) — which are exact regardless of word truncation —
# and fall back to :func:`pack_symbols_grouped` when content overflows.
ADAPTIVE_WPG = 128   # words per group (power of two for the roll arena)
ADAPTIVE_BW = 32     # per-block deposit buffer words


# symbol-capacity buckets for the adaptive pack's gather domain: the
# code-table gathers are the pack's dominant cost, so the
# dispatcher slices the buffers to the smallest bucket holding the frame's
# measured max symbol count (one compiled variant per bucket)
CAP_SLICES = (32, 48, 64, 96, 128)


def cap_slice(vmax: int, full: int) -> int:
    """Smallest capacity bucket holding ``vmax`` symbols (else ``full``)."""
    for c in CAP_SLICES:
        if c >= vmax and c <= full:
            return c
    return full


# A fused (code << 6 | len) u32 table entry holds codes up to this many
# bits; canonical codes CAN reach MAX_CODE_LEN=32 on pathologically skewed
# pmfs, so dispatchers must check the trained max length and disable the
# fusion for such frames (pack_symbols_grouped_sized fuse_table=False).
FUSED_TABLE_MAX_LEN = 26


@partial(jax.jit, static_argnames=("words_per_group", "block_words", "fuse_table"))
def pack_symbols_grouped_sized(buf, valid_len, enc_codes, enc_lens, lower_bound,
                               words_per_group: int, block_words: int,
                               fuse_table: bool = False):
    """Cap-sized grouped pack with TRACED tables and lower bound.

    Same group-stream bits and in-group block offsets as
    :func:`pack_symbols_grouped` wherever the buckets fit the content
    (verified bit-for-bit on the adaptive workloads); ``lower_bound`` is a
    traced operand so per-frame codebooks never retrace. With
    ``fuse_table=True`` the per-symbol lookup is ONE gather of a fused
    ``(code << 6) | len`` u32 table — gathers dominate the pack, and
    fusing halves them — but the caller MUST have verified every code
    length is <= :data:`FUSED_TABLE_MAX_LEN` (longer codes would lose top
    bits). Returns ``(group_words [G, wpg], group_bits [G],
    block_offsets [N], total)`` with offsets at ``words_per_group``
    stride.
    """
    from ivclab_tpu.ops.bitpack import pack_codes_grouped_dense2

    N, cap = buf.shape
    pos = jnp.arange(cap, dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    idx = jnp.clip(buf - lower_bound, 0, enc_lens.shape[0] - 1)
    if fuse_table:
        fused_table = (enc_codes.astype(jnp.uint32) << 6) | enc_lens.astype(jnp.uint32)
        fused = jnp.where(mask, fused_table[idx], 0)
        lens = (fused & 63).astype(jnp.int32)
        codes = fused >> 6
    else:
        lens = jnp.where(mask, enc_lens[idx], 0)
        codes = jnp.where(mask, enc_codes[idx], 0)
    words, group_bits, block_offsets = pack_codes_grouped_dense2(
        codes, lens, PACK_GROUP, words_per_group, block_words
    )
    return words, group_bits, block_offsets, jnp.sum(group_bits)


def map_codes_hot(buf, valid_len, hot_values, hot_fused, esc_code: int | None = None,
                  esc_len: int | None = None, raw_bits: int = 12):
    """Dense symbol -> (codeword, length) mapping for a hot+escape code.

    ``buf``: [N, S] 0-based alphabet indices; ``hot_values``: [K] alphabet
    indices of the hot symbols; ``hot_fused``: [K] uint32 (code << 6 | len).
    Escape symbols emit (esc_code << raw_bits) | index, esc_len + raw_bits.
    No gathers: the table interaction is one [N, S, K] compare-select
    reduction that XLA fuses into a single pass (chosen for the first
    target hardware, where the equivalent gather was far slower).
    """
    sym = jnp.asarray(buf, dtype=jnp.int32)
    N, S = sym.shape
    pos = jnp.arange(S, dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    hv = jnp.asarray(hot_values, dtype=jnp.int32)
    hf = jnp.asarray(hot_fused, dtype=jnp.uint32)

    eq = sym[:, :, None] == hv[None, None, :]
    fused = jnp.sum(jnp.where(eq, hf[None, None, :], jnp.uint32(0)), axis=-1)
    is_hot = jnp.any(eq, axis=-1)

    esc_full_code = (jnp.uint32(esc_code) << raw_bits) | sym.astype(jnp.uint32)
    esc_full_len = esc_len + raw_bits

    codes = jnp.where(is_hot, fused >> 6, esc_full_code)
    lens = jnp.where(
        mask, jnp.where(is_hot, (fused & 63).astype(jnp.int32), esc_full_len), 0
    )
    return codes, lens


@partial(jax.jit, static_argnames=("words_per_group", "block_words"))
def pack_grouped_sized(codes, lens, words_per_group: int, block_words: int):
    """Grouped pack with explicitly sized group/block word buffers.

    The fused codec buckets ``words_per_group``/``block_words`` from the
    measured maxima of the current GOP (a cheap jitted extent pass + host
    pick), so the dense deposit/placement phases touch buffers sized to the
    data instead of the format's worst case.
    """
    from ivclab_tpu.ops.bitpack import pack_codes_grouped_dense2

    return pack_codes_grouped_dense2(codes, lens, PACK_GROUP, words_per_group, block_words)


@jax.jit
def pack_extents(lens):
    """(max block words, max group words) for bucketing the pack buffers."""
    block_bits = jnp.sum(lens, axis=1)
    bw = (jnp.max(block_bits) + 31) // 32
    G = lens.shape[0] // PACK_GROUP
    gw = (jnp.max(jnp.sum(block_bits.reshape(G, PACK_GROUP), axis=1)) + 31) // 32
    return bw, gw


