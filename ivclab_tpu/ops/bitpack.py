"""Parallel variable-length bitstream packing/unpacking on device.

This replaces the reference's inherently serial per-symbol queue encode
(``ivclab/entropy/huffman.py:28-33``, Python -> Rust per symbol) with the
data-parallel restructuring from SURVEY.md §7:

encode:  gather (codeword, length) per symbol -> exclusive prefix sum of
         lengths -> every symbol knows its bit offset -> each left-justified
         codeword splits into at most two u32 words -> one scatter-add
         materializes the stream (disjoint bit ranges make add == or).

decode:  the per-block EOB framing keeps blocks independently decodable;
         given per-block bit offsets (carried by the container, or the
         implicit offsets of fixed-rate streams) all blocks decode in
         parallel, each walking its own bits with the canonical 32-boundary
         comparison decode.

Bitstream format: MSB-first within big-endian u32 words — bit ``k`` of the
stream is bit ``31 - (k mod 32)`` of word ``k // 32``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ivclab_tpu.entropy.codebook import MAX_CODE_LEN, CanonicalCode

U32 = jnp.uint32


def _u32(x):
    return jnp.asarray(x).astype(U32)


@jax.jit
def symbol_bit_layout(lens):
    """Exclusive prefix-sum of code lengths -> (bit_offsets, total_bits)."""
    lens = jnp.asarray(lens, dtype=jnp.int32).reshape(-1)
    csum = jnp.cumsum(lens)
    return csum - lens, (csum[-1] if lens.size else jnp.int32(0))


@partial(jax.jit, static_argnames=("num_words",))
def pack_codes(codes, lens, bit_offsets, num_words: int):
    """Scatter left-justified codewords into a ``[num_words]`` u32 stream.

    ``codes``: right-aligned uint32; ``lens``: int32 in [0, 32] (0 = skip,
    used for padded/invalid symbol slots); ``bit_offsets``: int32.
    """
    codes = _u32(codes).reshape(-1)
    lens = jnp.asarray(lens, dtype=jnp.int32).reshape(-1)
    off = jnp.asarray(bit_offsets, dtype=jnp.int32).reshape(-1)

    shift_lj = _u32((32 - lens) & 31)
    lj = jnp.where(lens > 0, codes << shift_lj, _u32(0))

    word = off >> 5
    shift = _u32(off & 31)
    part1 = lj >> shift
    part2 = jnp.where(shift == 0, _u32(0), lj << (_u32(32) - shift))
    # invalid symbols (len 0) must not write anywhere
    word = jnp.where(lens > 0, word, num_words + 1)

    words = jnp.zeros((num_words,), dtype=U32)
    words = words.at[word].add(part1, mode="drop")
    words = words.at[word + 1].add(part2, mode="drop")
    return words


@jax.jit
def bit_window32(words, bitpos):
    """Load the 32-bit window starting at ``bitpos`` (MSB-first stream)."""
    words = _u32(words)
    w = bitpos >> 5
    sh = _u32(bitpos & 31)
    w1 = words[w]
    w2 = words[jnp.minimum(w + 1, words.shape[0] - 1)]
    lo = jnp.where(sh == 0, _u32(0), w2 >> (_u32(32) - sh))
    return jnp.where(sh == 0, w1, (w1 << sh) | lo)


@partial(jax.jit, static_argnames=("max_syms",))
def decode_blocks_device(words, block_bit_offsets, block_sym_counts, tables, max_syms: int):
    """Decode all blocks in parallel from one packed stream.

    ``block_bit_offsets[b]``: starting bit of block b;
    ``block_sym_counts[b]``: symbols to decode for block b (<= max_syms).
    ``tables``: tuple of device arrays + scalar
        (lj_next_minus1[32] u32, first_code[33] u32,
         group_offset[33] i32, sorted_syms[n] i32, min_len i32).
    Returns ``out [B, max_syms] int32`` of 0-based symbol indices (padded
    slots are 0).

    Each block walks its own bits with a ``fori_loop``; all blocks advance
    in lockstep — the sequential depth is max_syms, not
    num_blocks * max_syms as in the reference's Python loop.
    """
    lj, fc, go, ss, min_len = (jnp.asarray(t) for t in tables)
    offs = jnp.asarray(block_bit_offsets, dtype=jnp.int32)
    counts = jnp.asarray(block_sym_counts, dtype=jnp.int32)
    B = offs.shape[0]

    def body(i, carry):
        bitpos, out = carry
        window = jax.vmap(lambda p: bit_window32(words, p))(bitpos)
        past = (window[:, None] > lj[None, : MAX_CODE_LEN - 1]).astype(jnp.int32)
        length = min_len + jnp.sum(past, axis=1)
        code_val = window >> _u32(32 - length)
        rank = (code_val - fc[length]).astype(jnp.int32)
        sym = ss[jnp.clip(go[length] + rank, 0, ss.shape[0] - 1)]
        active = i < counts
        out = out.at[:, i].set(jnp.where(active, sym, 0))
        bitpos = jnp.where(active, bitpos + length, bitpos)
        return bitpos, out

    out0 = jnp.zeros((B, max_syms), dtype=jnp.int32)
    max_needed = jnp.minimum(jnp.max(counts), max_syms)

    def cond(carry):
        i, _, _ = carry
        return i < max_needed

    def wbody(carry):
        i, bitpos, out = carry
        bitpos, out = body(i, (bitpos, out))
        return i + 1, bitpos, out

    _, _, out = jax.lax.while_loop(cond, wbody, (jnp.int32(0), offs, out0))
    return out


def decode_tables(code: CanonicalCode):
    """Device-ready decoder table tuple for ``decode_blocks_device``."""
    return (
        jnp.asarray(code.lj_next_minus1),
        jnp.asarray(np.asarray(code.first_code, dtype=np.uint32)),
        jnp.asarray(code.group_offset.astype(np.int32)),
        jnp.asarray(code.sorted_syms),
        jnp.int32(code.min_len),
    )


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


@partial(jax.jit, static_argnames=("group_size", "words_per_group", "block_words"))
def pack_codes_grouped_dense2(codes, lens, group_size: int, words_per_group: int, block_words: int):
    """Cap-sized variant of :func:`pack_codes_grouped_dense`.

    Identical algorithm, but the per-block word buffer (``block_words``) and
    the roll arena are sized from the actual symbol capacity instead of the
    97-symbol worst case — the fused codec picks a capacity bucket per GOP
    from :func:`ivclab_tpu.ops.zerorun.zerorun_counts`, which shrinks every
    dense pass (deposit loop, phase shift, placement rolls) by the same
    factor.
    """
    N, S = lens.shape
    G = N // group_size
    BW = block_words

    lens = jnp.asarray(lens, dtype=jnp.int32)
    codes = _u32(codes)

    csum = jnp.cumsum(lens, axis=1)
    off = csum - lens
    block_bits = csum[:, -1]

    shift_lj = _u32((32 - lens) & 31)
    lj = jnp.where(lens > 0, codes << shift_lj, _u32(0))
    word = off >> 5
    sh = _u32(off & 31)
    p1 = lj >> sh
    p2 = jnp.where(sh == 0, _u32(0), lj << (_u32(32) - sh))

    iota = jnp.arange(BW, dtype=jnp.int32)[None, :]
    max_slots = jnp.max(jnp.sum((lens > 0).astype(jnp.int32), axis=1))

    def cond_body(carry):
        i, acc = carry
        wi = word[:, i][:, None]
        acc = acc + jnp.where(iota == wi, p1[:, i][:, None], _u32(0))
        acc = acc + jnp.where(iota == wi + 1, p2[:, i][:, None], _u32(0))
        return i + 1, acc

    acc0 = jnp.zeros((N, BW), dtype=U32)
    _, acc = jax.lax.while_loop(lambda c: c[0] < max_slots, cond_body, (jnp.int32(0), acc0))

    Lg = block_bits.reshape(G, group_size)
    O = jnp.cumsum(Lg, axis=1) - Lg
    group_bits = jnp.sum(Lg, axis=1)

    shp = _u32((O & 31).reshape(N))[:, None]
    acc_prev = jnp.concatenate([jnp.zeros((N, 1), U32), acc[:, :-1]], axis=1)
    shifted = jnp.where(shp == 0, acc, (acc >> shp) | (acc_prev << (_u32(32) - shp)))
    spill = jnp.where(shp[:, 0] == 0, _u32(0), acc[:, -1] << (_u32(32) - shp[:, 0]))
    shifted = jnp.concatenate([shifted, spill[:, None]], axis=1)  # [N, BW+1]

    P = (O >> 5).reshape(G, group_size)
    pad_w = _next_pow2(words_per_group + BW + 2)
    n_steps = pad_w.bit_length() - 1
    out = jnp.zeros((G, words_per_group), dtype=U32)
    shifted_g = shifted.reshape(G, group_size, BW + 1)
    for b in range(group_size):
        x = jnp.zeros((G, pad_w), dtype=U32).at[:, : BW + 1].set(shifted_g[:, b])
        pb = P[:, b]
        for k in range(n_steps):
            bit = ((pb >> k) & 1) == 1
            x = jnp.where(bit[:, None], jnp.roll(x, 1 << k, axis=1), x)
        out = out + x[:, :words_per_group]

    base = (jnp.arange(G, dtype=jnp.int32) * (words_per_group * 32))[:, None]
    block_offsets = (base + O).reshape(-1)
    return out, group_bits, block_offsets


@partial(jax.jit, static_argnames=("group_size", "local_words"))
def locals_from_groups(group_words, block_bit_offsets, group_size: int, local_words: int):
    """Per-block phase-aligned local streams via binary word rolls.

    Inverse of the grouped packer's placement: for each of the
    ``group_size`` block slots, rotate every group row left by that block's
    word offset (log2(W) dense roll steps) and keep the first
    ``local_words`` words, then shift by the bit phase so the next code
    starts at bit 31 of word 0. All dense row ops — replaces the
    ``words[idx]`` gather (B x LW elements) that dominated the LUT
    decoder's setup on the first target hardware.

    group_words: [G, W] u32 (W a power of two); block_bit_offsets: [G*gs]
    bit offsets into the flat stream. Returns local [G*gs, local_words].
    """
    G, W = group_words.shape
    assert W & (W - 1) == 0, "words_per_group must be a power of two"
    offs = jnp.asarray(block_bit_offsets, dtype=jnp.int32).reshape(G, group_size)
    in_group = offs - (jnp.arange(G, dtype=jnp.int32) * (W * 32))[:, None]
    P = in_group >> 5  # word offset of each block in its group
    n_steps = W.bit_length() - 1

    locs = []
    for b in range(group_size):
        x = group_words
        pb = P[:, b]
        for k in range(n_steps):
            bit = ((pb >> k) & 1) == 1
            x = jnp.where(bit[:, None], jnp.roll(x, -(1 << k), axis=1), x)
        locs.append(x[:, :local_words])
    local = jnp.stack(locs, axis=1).reshape(G * group_size, local_words)

    B = G * group_size
    phase = _u32(in_group.reshape(B) & 31)[:, None]
    nxt = jnp.concatenate([local[:, 1:], jnp.zeros((B, 1), U32)], axis=1)
    local = jnp.where(phase == 0, local, (local << phase) | (nxt >> (_u32(32) - phase)))
    return local


@partial(jax.jit, static_argnames=("max_syms", "raw_bits", "max_len"))
def decode_blocks_hot(local, block_sym_counts, lj, first_code, group_offset,
                      alpha_of_rank, min_len, esc_rank, max_syms: int, raw_bits: int,
                      max_len: int | None = None):
    """Gather-free canonical decode of hot+escape streams.

    ``local``: [B, LW] phase-aligned block streams (see
    :func:`locals_from_groups`). Per symbol, everything is dense vector math:
    the code length comes from <= max_len-1 boundary compares
    (canonical left-justified layout), first_code/group_offset from
    max_len+1-wide select reductions, the hot symbol value from a
    <=128-wide select reduction over ``alpha_of_rank``, and escapes read
    their raw payload arithmetically from the window. Returns
    [B, max_syms] alphabet indices.

    ``max_len`` (static) is the code's real maximum length: boundary
    entries past it are saturated sentinels (0xFFFFFFFF, never satisfied)
    and lengths past it can never decode, so slicing every per-symbol
    [B, width] select to it is value-identical — and hot/escape codes cap
    at 16 bits, halving the decode loop's dominant materialized traffic.
    """
    from ivclab_tpu.entropy.codebook import MAX_CODE_LEN

    if max_len is None:
        max_len = MAX_CODE_LEN
    local = _u32(local)
    counts = jnp.asarray(block_sym_counts, dtype=jnp.int32)
    lj = _u32(lj)[: max_len - 1] if max_len > 1 else _u32(lj)[:1]
    fc = _u32(first_code)[: max_len + 1]
    go = jnp.asarray(group_offset, dtype=jnp.int32)[: max_len + 1]
    ar = jnp.asarray(alpha_of_rank, dtype=jnp.int32)
    B, LW = local.shape
    n_ranks = ar.shape[0]
    lsel = jnp.arange(max_len + 1, dtype=jnp.int32)
    rsel = jnp.arange(n_ranks, dtype=jnp.int32)

    max_needed = jnp.max(counts)

    def body(carry):
        i, local, out = carry
        win = local[:, 0]
        past = (win[:, None] > lj[None, :]).astype(jnp.int32)
        L = min_len + jnp.sum(past, axis=1)
        eqL = L[:, None] == lsel[None, :]
        fcv = jnp.sum(jnp.where(eqL, fc[None, :], _u32(0)), axis=1)
        gov = jnp.sum(jnp.where(eqL, go[None, :], 0), axis=1)
        code_val = win >> _u32(32 - L)
        rank = gov + (code_val - fcv).astype(jnp.int32)
        rank = jnp.clip(rank, 0, n_ranks - 1)
        val_hot = jnp.sum(
            jnp.where(rank[:, None] == rsel[None, :], ar[None, :], 0), axis=1
        )
        is_esc = rank == esc_rank
        raw = (win << _u32(L)) >> _u32(32 - raw_bits)
        value = jnp.where(is_esc, raw.astype(jnp.int32), val_hot)
        Lt = L + jnp.where(is_esc, raw_bits, 0)

        active = i < counts
        out = out.at[i].set(jnp.where(active, value, 0))
        lu = _u32(jnp.where(active, Lt, 0))[:, None]
        nxt = jnp.concatenate([local[:, 1:], jnp.zeros((B, 1), U32)], axis=1)
        shifted = (local << (lu & 31)) | jnp.where(
            (lu & 31) == 0, _u32(0), nxt >> (_u32(32) - (lu & 31))
        )
        # lu == 32 (max esc_len+raw==32) shifts a full word: roll instead
        shifted = jnp.where(lu == 32, nxt, shifted)
        local = jnp.where(lu == 0, local, shifted)
        return i + 1, local, out

    out0 = jnp.zeros((max_syms, B), dtype=jnp.int32)
    _, _, out = jax.lax.while_loop(
        lambda c: c[0] < max_needed, body, (jnp.int32(0), local, out0)
    )
    return out.T


@partial(jax.jit, static_argnames=("group_size", "words_per_group"))
def pack_codes_grouped_dense(codes, lens, group_size: int = 16, words_per_group: int = 1600):
    """Scatter-free grouped packer: dense one-hot accumulate + binary rolls.

    Chosen for the first target hardware, whose scatter throughput made
    the index-based packers the pipeline bottleneck; every step here is a
    dense op:

      1. per-block pack: a ``fori_loop`` over symbol slots; at step i every
         block deposits its i-th codeword's two word-parts into a private
         ``[128]``-word row via an iota==word compare (one-hot masked add —
         disjoint bit ranges make add == or);
      2. per-block streams shift by their in-group bit phase (dense row
         shift);
      3. placement at each block's in-group word offset happens by rotating
         rows with a binary-decomposed ``jnp.roll`` chain (11 dense steps),
         accumulated into the group buffer.

    codes/lens: ``[N, S]`` per-block symbol codes (u32) / lengths (i32,
    0 = padded). N must be a multiple of ``group_size``.
    Returns (group_words ``[G, words_per_group]`` u32, group_bits ``[G]``,
    block_bit_offsets ``[N]`` — bit offsets into the flattened
    ``group_words`` stream).
    """
    N, S = lens.shape
    G = N // group_size
    BW = 128  # per-block word buffer (>= ceil(97*32/32)+1)

    lens = jnp.asarray(lens, dtype=jnp.int32)
    codes = _u32(codes)

    csum = jnp.cumsum(lens, axis=1)
    off = csum - lens  # in-block bit offsets
    block_bits = csum[:, -1]

    shift_lj = _u32((32 - lens) & 31)
    lj = jnp.where(lens > 0, codes << shift_lj, _u32(0))
    word = off >> 5
    sh = _u32(off & 31)
    p1 = lj >> sh
    p2 = jnp.where(sh == 0, _u32(0), lj << (_u32(32) - sh))

    iota = jnp.arange(BW, dtype=jnp.int32)[None, :]
    max_slots = jnp.max(jnp.sum((lens > 0).astype(jnp.int32), axis=1))

    def body(i, acc):
        wi = word[:, i][:, None]
        acc = acc + jnp.where(iota == wi, p1[:, i][:, None], _u32(0))
        acc = acc + jnp.where(iota == wi + 1, p2[:, i][:, None], _u32(0))
        return acc

    def cond_body(carry):
        i, acc = carry
        return i + 1, body(i, acc)

    acc0 = jnp.zeros((N, BW), dtype=U32)
    _, acc = jax.lax.while_loop(
        lambda c: c[0] < max_slots, cond_body, (jnp.int32(0), acc0)
    )

    # in-group placement of each block's stream
    Lg = block_bits.reshape(G, group_size)
    O = jnp.cumsum(Lg, axis=1) - Lg  # in-group bit offsets [G, gs]
    group_bits = jnp.sum(Lg, axis=1)

    # phase shift: rotate each block's bits right by O & 31 within words
    shp = _u32((O & 31).reshape(N))[:, None]
    acc_prev = jnp.concatenate([jnp.zeros((N, 1), U32), acc[:, :-1]], axis=1)
    shifted = jnp.where(
        shp == 0,
        acc,
        (acc >> shp) | (acc_prev << (_u32(32) - shp)),
    )
    # the shift pushes up to 31 bits into one extra trailing word
    spill = jnp.where(shp[:, 0] == 0, _u32(0), acc[:, -1] << (_u32(32) - shp[:, 0]))
    shifted = jnp.concatenate([shifted, spill[:, None]], axis=1)  # [N, BW+1]

    P = (O >> 5).reshape(G, group_size)  # word offsets
    pad_w = 2048  # roll arena: power of two >= words_per_group + BW + 1
    out = jnp.zeros((G, words_per_group), dtype=U32)
    shifted_g = shifted.reshape(G, group_size, BW + 1)
    for b in range(group_size):
        x = jnp.zeros((G, pad_w), dtype=U32).at[:, : BW + 1].set(shifted_g[:, b])
        pb = P[:, b]
        for k in range(11):  # 2^11 = 2048 covers all offsets
            bit = ((pb >> k) & 1) == 1
            x = jnp.where(bit[:, None], jnp.roll(x, 1 << k, axis=1), x)
        out = out + x[:, :words_per_group]

    base = (jnp.arange(G, dtype=jnp.int32) * (words_per_group * 32))[:, None]
    block_offsets = (base + O).reshape(-1)
    return out, group_bits, block_offsets
