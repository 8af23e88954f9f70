"""Zero-run-length coding of scan-ordered coefficient blocks, fully vectorized.

Reference parity: ``ivclab/entropy/zerorun.py:4-88``. The reference walks
every 64-coefficient block with Python ``while`` loops (the intra codec's
hot loop, SURVEY.md §3.1). Here both directions are data-parallel over all
blocks at once:

- encode: per-position emit counts (value -> 1 symbol, zero-run start -> 2
  symbols, trailing zeros -> 0) + an exclusive prefix sum give each symbol
  its output slot; one scatter materializes a fixed-capacity ``[N, CAP]``
  buffer with per-block valid lengths. No data-dependent shapes under jit.
- decode: symbols classify positionally (run marker / run length / value /
  EOB); a segmented prefix sum over contributed coefficient counts gives
  every value symbol its coefficient position; one scatter rebuilds the
  blocks.

The per-block EOB framing (every block is terminated, as in the reference
``ivclab/entropy/zerorun.py:38``) is what makes decode embarrassingly
parallel.

Symbol grammar (identical to the reference):
  value v != 0      -> "v"
  run of k zeros    -> "0 k"     (only runs before the last nonzero)
  trailing zeros    -> dropped, block closed by the EOB symbol
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Worst case symbols per 64-coeff block: 32 isolated zeros (2 each) +
# 32 values + EOB = 97. Padded to a power of two, 128; slot CAP-1 is a
# write trash can and can never be a valid slot.
BLOCK_CAP = 128
DEFAULT_EOB = 4000


@partial(jax.jit, static_argnames=("block_size", "eob"))
def zerorun_encode_blocks(zz, block_size: int = 64, eob: int = DEFAULT_EOB):
    """Encode ``[N, block_size]`` scan-ordered int32 blocks.

    Returns ``(buf, valid_len)``: ``buf`` is ``[N, BLOCK_CAP]`` int32 with
    each block's symbols left-packed, ``valid_len[N]`` the symbol count per
    block (including the closing EOB).
    """
    x = jnp.asarray(zz, dtype=jnp.int32)
    N = x.shape[0]
    pos = jnp.arange(block_size, dtype=jnp.int32)

    nz = x != 0
    last_nz = jnp.max(jnp.where(nz, pos[None, :], -1), axis=1)  # [N]
    in_range = pos[None, :] <= last_nz[:, None]

    prev_nz = jnp.concatenate([jnp.ones((N, 1), dtype=bool), nz[:, :-1]], axis=1)
    is_value = nz & in_range
    run_start = in_range & (~nz) & prev_nz

    # next nonzero at-or-after each position (run end; always exists inside range)
    idx_if_nz = jnp.where(nz, pos[None, :], block_size)
    next_nz = jax.lax.cummin(idx_if_nz[:, ::-1], axis=1)[:, ::-1]
    run_len = (next_nz - pos[None, :]).astype(jnp.int32)

    emit = is_value.astype(jnp.int32) + 2 * run_start.astype(jnp.int32)
    off = jnp.cumsum(emit, axis=1) - emit  # exclusive
    total = off[:, -1] + emit[:, -1]  # symbols before EOB
    valid_len = total + 1

    b_idx = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, block_size))
    buf = jnp.zeros((N, BLOCK_CAP), dtype=jnp.int32)
    tgt1 = jnp.where(emit > 0, off, BLOCK_CAP - 1)
    buf = buf.at[b_idx, tgt1].set(jnp.where(is_value, x, 0), mode="drop")
    tgt2 = jnp.where(run_start, off + 1, BLOCK_CAP - 1)
    buf = buf.at[b_idx, tgt2].set(run_len, mode="drop")
    buf = buf.at[jnp.arange(N), total].set(jnp.int32(eob))
    buf = buf.at[:, BLOCK_CAP - 1].set(0)
    return buf, valid_len


@partial(jax.jit, static_argnames=("block_size",))
def zerorun_counts(zz, block_size: int = 64):
    """Per-block symbol counts only (incl. EOB) — no buffer materialized.

    Cheap pre-pass the fused codec uses to pick a static symbol capacity
    bucket before tracing the cap-specialized encode/pack programs.
    """
    x = jnp.asarray(zz, dtype=jnp.int32)
    N = x.shape[0]
    pos = jnp.arange(block_size, dtype=jnp.int32)
    nz = x != 0
    last_nz = jnp.max(jnp.where(nz, pos[None, :], -1), axis=1)
    in_range = pos[None, :] <= last_nz[:, None]
    prev_nz = jnp.concatenate([jnp.ones((N, 1), dtype=bool), nz[:, :-1]], axis=1)
    emit = (nz & in_range).astype(jnp.int32) + 2 * (in_range & (~nz) & prev_nz).astype(jnp.int32)
    return jnp.sum(emit, axis=1) + 1


@partial(jax.jit, static_argnames=("block_size", "eob", "cap"))
def zerorun_encode_blocks_dense(zz, block_size: int = 64, eob: int = DEFAULT_EOB, cap: int = BLOCK_CAP):
    """Scatter-free zero-run encode into ``[N, cap]`` buffers.

    Same grammar as :func:`zerorun_encode_blocks`, but the output slots are
    materialized with one-hot broadcast-reductions (chosen where scatters
    serialize; the dense form is a fused reduce). ``cap`` must
    be >= max per-block symbol count (pick it from :func:`zerorun_counts`).
    """
    x = jnp.asarray(zz, dtype=jnp.int32)
    N = x.shape[0]
    pos = jnp.arange(block_size, dtype=jnp.int32)

    nz = x != 0
    last_nz = jnp.max(jnp.where(nz, pos[None, :], -1), axis=1)
    in_range = pos[None, :] <= last_nz[:, None]
    prev_nz = jnp.concatenate([jnp.ones((N, 1), dtype=bool), nz[:, :-1]], axis=1)
    is_value = nz & in_range
    run_start = in_range & (~nz) & prev_nz

    idx_if_nz = jnp.where(nz, pos[None, :], block_size)
    next_nz = jax.lax.cummin(idx_if_nz[:, ::-1], axis=1)[:, ::-1]
    run_len = (next_nz - pos[None, :]).astype(jnp.int32)

    emit = is_value.astype(jnp.int32) + 2 * run_start.astype(jnp.int32)
    off = jnp.cumsum(emit, axis=1) - emit
    total = off[:, -1] + emit[:, -1]
    valid_len = total + 1

    slots = jnp.arange(cap, dtype=jnp.int32)
    val1 = jnp.where(is_value, x, 0)
    val2 = jnp.where(run_start, run_len, 0)
    # one-hot deposit: values at slot off, run lengths at off+1 (markers are
    # literal zeros, so they need no write at all)
    contrib = (
        val1[:, :, None] * (off[:, :, None] == slots[None, None, :])
        + val2[:, :, None] * ((off[:, :, None] + 1) == slots[None, None, :])
    )
    buf = jnp.sum(contrib, axis=1)
    buf = buf + jnp.where(slots[None, :] == total[:, None], jnp.int32(eob), 0)
    return buf, valid_len


@partial(jax.jit, static_argnames=("block_size", "eob"))
def zerorun_decode_blocks_dense(buf, valid_len, block_size: int = 64, eob: int = DEFAULT_EOB):
    """Scatter-free row-local zero-run decode (``[N, cap]`` -> ``[N, block_size]``).

    Identical semantics to :func:`zerorun_decode_blocks`; the value scatter
    becomes a one-hot broadcast-reduce over coefficient positions.
    """
    s = jnp.asarray(buf, dtype=jnp.int32)
    N, cap = s.shape
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid_len = jnp.asarray(valid_len, dtype=jnp.int32)
    valid = pos < valid_len[:, None]

    is_eob = (s == eob) & valid
    is_marker = (s == 0) & valid & ~is_eob
    prev_marker = jnp.concatenate([jnp.zeros((N, 1), bool), is_marker[:, :-1]], axis=1)
    is_runlen = prev_marker & valid
    is_value = valid & ~is_eob & ~is_marker & ~is_runlen

    run_next = jnp.concatenate([s[:, 1:], jnp.zeros((N, 1), jnp.int32)], axis=1)
    contributed = jnp.where(is_marker, run_next, jnp.where(is_value, 1, 0))
    csum = jnp.cumsum(contributed, axis=1)
    coeff_pos = csum - contributed

    cpos = jnp.where(is_value, jnp.minimum(coeff_pos, block_size - 1), block_size)
    cols = jnp.arange(block_size, dtype=jnp.int32)
    out = jnp.sum(
        s[:, :, None] * (cpos[:, :, None] == cols[None, None, :]),
        axis=1,
        dtype=jnp.int32,
    )

    terminated = jnp.where(
        valid_len > 0, s[jnp.arange(N), jnp.maximum(valid_len - 1, 0)] == eob, False
    )
    no_overflow = jnp.all(jnp.where(valid, coeff_pos + contributed <= block_size, True))
    ok = jnp.all(terminated) & no_overflow
    return out, ok


@jax.jit
def compact_symbols(buf, valid_len):
    """Left-pack per-block symbol buffers into one padded stream.

    Returns ``(stream, total)``: ``stream`` has the same total capacity as
    ``buf`` flattened, symbols from all blocks concatenated in block order
    at the front, zeros after; ``total`` is the true symbol count.
    """
    N, cap = buf.shape
    valid_len = jnp.asarray(valid_len, dtype=jnp.int32)
    starts = jnp.cumsum(valid_len) - valid_len  # exclusive
    total = starts[-1] + valid_len[-1] if N else jnp.int32(0)
    pos = jnp.arange(cap, dtype=jnp.int32)
    valid = pos[None, :] < valid_len[:, None]
    tgt = jnp.where(valid, starts[:, None] + pos[None, :], N * cap)
    out = jnp.zeros((N * cap,), dtype=buf.dtype)
    out = out.at[tgt.reshape(-1)].set(buf.reshape(-1), mode="drop")
    return out, total


@partial(jax.jit, static_argnames=("num_blocks", "block_size", "eob"))
def zerorun_decode_stream(stream, num_symbols, num_blocks: int, block_size: int = 64, eob: int = DEFAULT_EOB):
    """Decode a (padded) symbol stream back to ``[num_blocks, block_size]``.

    ``stream``: int32 1-D, first ``num_symbols`` entries valid.
    Fully parallel: classification + segmented prefix sum + one scatter.
    Also returns ``ok``: per-stream bool diagnostics (EOB count and block
    fill match), replacing the reference decoder's serial raise-on-error
    validation (``ivclab/entropy/zerorun.py:66-84``).
    """
    s = jnp.asarray(stream, dtype=jnp.int32)
    L = s.shape[0]
    pos = jnp.arange(L, dtype=jnp.int32)
    valid = pos < num_symbols

    is_eob = (s == eob) & valid
    prev_eob = jnp.concatenate([jnp.zeros((1,), jnp.int32), jnp.cumsum(is_eob.astype(jnp.int32))[:-1]])
    block_id = prev_eob  # block index of each symbol

    is_marker = (s == 0) & valid & ~is_eob
    prev_marker = jnp.concatenate([jnp.zeros((1,), bool), is_marker[:-1]])
    is_runlen = prev_marker & valid
    is_value = valid & ~is_eob & ~is_marker & ~is_runlen

    run_next = jnp.concatenate([s[1:], jnp.zeros((1,), jnp.int32)])
    contributed = jnp.where(is_marker, run_next, jnp.where(is_value, 1, 0))

    # coefficient start position within each block = segmented exclusive cumsum
    csum = jnp.cumsum(contributed)
    excl = csum - contributed
    # offset at each block's first symbol: gather csum at positions of EOBs
    eob_positions_excl = jnp.where(is_eob, excl, 0)
    # segment base = excl value at the segment's first element; compute via
    # cummax of (excl where segment starts else 0)
    seg_start = jnp.concatenate([jnp.ones((1,), bool), is_eob[:-1]])
    base = jax.lax.cummax(jnp.where(seg_start, excl, 0))
    coeff_pos = excl - base

    out = jnp.zeros((num_blocks, block_size), dtype=jnp.int32)
    tgt_b = jnp.where(is_value, block_id, num_blocks)
    tgt_c = jnp.where(is_value, jnp.minimum(coeff_pos, block_size - 1), 0)
    out = out.at[tgt_b, tgt_c].set(s, mode="drop")

    num_eob = jnp.sum(is_eob.astype(jnp.int32))
    no_overflow = jnp.all(jnp.where(valid, coeff_pos + contributed <= block_size, True))
    ok = (num_eob == num_blocks) & no_overflow
    del eob_positions_excl
    return out, ok


@partial(jax.jit, static_argnames=("block_size", "eob"))
def zerorun_decode_blocks(buf, valid_len, block_size: int = 64, eob: int = DEFAULT_EOB):
    """Decode per-block symbol buffers ``[N, CAP]`` -> ``[N, block_size]``.

    Row-local counterpart of :func:`zerorun_decode_stream`: classification
    and the coefficient-position prefix sum run within each row, and the
    value scatter stays row-local — no global stream, no global cumsum.
    This is the decode path the fused codec uses after the parallel
    Huffman block decode.
    """
    s = jnp.asarray(buf, dtype=jnp.int32)
    N, cap = s.shape
    pos = jnp.arange(cap, dtype=jnp.int32)[None, :]
    valid_len = jnp.asarray(valid_len, dtype=jnp.int32)
    valid = pos < valid_len[:, None]

    is_eob = (s == eob) & valid
    is_marker = (s == 0) & valid & ~is_eob
    prev_marker = jnp.concatenate([jnp.zeros((N, 1), bool), is_marker[:, :-1]], axis=1)
    is_runlen = prev_marker & valid
    is_value = valid & ~is_eob & ~is_marker & ~is_runlen

    run_next = jnp.concatenate([s[:, 1:], jnp.zeros((N, 1), jnp.int32)], axis=1)
    contributed = jnp.where(is_marker, run_next, jnp.where(is_value, 1, 0))
    csum = jnp.cumsum(contributed, axis=1)
    coeff_pos = csum - contributed

    out = jnp.zeros((N, block_size), dtype=jnp.int32)
    row = jnp.broadcast_to(jnp.arange(N, dtype=jnp.int32)[:, None], (N, cap))
    tgt = jnp.where(is_value, jnp.minimum(coeff_pos, block_size - 1), block_size)
    out = out.at[row, tgt].set(s, mode="drop")

    terminated = jnp.where(
        valid_len > 0, s[jnp.arange(N), jnp.maximum(valid_len - 1, 0)] == eob, False
    )
    no_overflow = jnp.all(jnp.where(valid, coeff_pos + contributed <= block_size, True))
    ok = jnp.all(terminated) & no_overflow
    return out, ok


class ZeroRunCoder:
    """Facade matching ``ivclab/entropy/zerorun.py`` (encode/decode).

    ``encode`` takes ``[H_patch, W_patch, C, block_size]`` and returns the
    compact int32 symbol stream; ``decode`` inverts it given the block-grid
    shape.
    """

    def __init__(self, end_of_block: int = DEFAULT_EOB, block_size: int = 64):
        self.EOB = int(end_of_block)
        self.block_size = int(block_size)

    def encode(self, flat_patch_img) -> np.ndarray:
        x = jnp.asarray(flat_patch_img, dtype=jnp.int32)
        blocks = x.reshape(-1, self.block_size)
        buf, valid_len = zerorun_encode_blocks(blocks, self.block_size, self.EOB)
        stream, total = compact_symbols(buf, valid_len)
        return np.asarray(stream)[: int(total)]

    def decode(self, encoded, original_shape) -> np.ndarray:
        h, w, c = (int(v) for v in original_shape)
        s = jnp.asarray(np.asarray(encoded), dtype=jnp.int32)
        out, ok = zerorun_decode_stream(s, s.shape[0], h * w * c, self.block_size, self.EOB)
        if not bool(ok):
            raise ValueError("zero-run decode failed: corrupt stream or wrong shape")
        return np.asarray(out).reshape(h, w, c, self.block_size)
