"""Fused single-chip GOP codec: the throughput path.

The facade ``VideoCodec`` mirrors the reference API frame by frame, paying
host round trips per frame. This module is the production path: one jitted
program per GOP for each phase, everything resident on device.

  encode:  lax.scan over frames — halo-free single-chip ME (dense candidate
           scan), dense MC, fused DCT+quant — emitting per-frame quantized
           symbol buffers, motion fields, reconstructions and exact coded
           bit counts;
  pack:    zero-run + hot/escape Huffman packing of all T*N blocks in one
           flat pass (frames folded into the block axis): dense
           compare-select code mapping (no gathers), deposit + binary-roll
           placement into word-aligned group substreams whose buffer sizes
           are bucketed from the GOP's measured extents;
  decode:  binary-roll de-interleave into per-block shift registers, then a
           gather-free canonical walk (boundary compares + select
           reductions; escapes read raw bits arithmetically), zero-run
           decode, fused IDCT, and a dense-MC scan rebuilding the recon
           chain.

Codebooks are fixed per sequence (the first-p-frame policy of
exercises/ch4/ex1.py), which keeps the GOP recursion free of host syncs;
per-frame adaptive codebooks remain available through ``VideoCodec``.

All jitted phases are module-level functions taking the codebook/quant
tables as *traced* array arguments: retraining a codec or sweeping
quantization scales never bakes stale constants into a cached program and
never retraces (shapes being equal, one compile serves every q / codebook).

Why hot/escape instead of full-alphabet tables: on the hardware this was
first built for, reference-style per-symbol codebook lookups (alphabet of thousands)
lowered to slow gathers that dominated both pack and decode. See
``ivclab_tpu/entropy/codebook.py:HotCode``.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ivclab_tpu.entropy.codebook import HotCode, build_hot_code
from ivclab_tpu.models.intracodec import bucket_bounds
from ivclab_tpu.ops.bitpack import decode_blocks_hot, locals_from_groups
from ivclab_tpu.ops.dct import dct2_fused, idct2_fused
from ivclab_tpu.ops.motion import (
    motion_compensate,
    motion_compensate_dense,
    motion_search,
    motion_search_auto,
)
from ivclab_tpu.ops.quant import quant_table_zigzag
from ivclab_tpu.ops.transform import (
    PACK_GROUP,
    map_codes_hot,
    pack_extents,
    pack_grouped_sized,
)
from ivclab_tpu.ops.zerorun import (
    zerorun_counts,
    zerorun_decode_blocks_dense,
    zerorun_encode_blocks_dense,
)

EOB = 4000

# Static size buckets: each is a separately compiled program; the cheap
# extent pre-passes pick the smallest adequate bucket per GOP.
CAP_BUCKETS = (32, 64, 128)        # symbols per block (97 = worst case)
GW_BUCKETS = (64, 128, 256, 512, 1024, 2048)  # words per 16-block group
BW_BUCKETS = (4, 8, 16, 32, 64, 128)          # words per block stream


def _bucket(v: int, buckets) -> int:
    for b in buckets:
        if b >= v:
            return b
    raise ValueError(f"{v} exceeds the largest bucket {buckets[-1]}")


class PackedGop(NamedTuple):
    """Device-side result of :meth:`FusedVideoCodec.pack_gop`."""

    words: jnp.ndarray        # [T, G, GW] u32 group substreams
    totals: jnp.ndarray       # [T] exact residual payload bits
    offsets: jnp.ndarray      # [T, N] frame-relative block bit offsets
    counts: jnp.ndarray       # [T, N] per-block symbol counts
    group_bits: jnp.ndarray   # [T, G] exact per-group bits
    block_words: int          # decoder shift-register width (bucketed)
    cap: int                  # symbol-capacity bucket
    ok: jnp.ndarray | None = None  # device bool: sticky buckets were adequate


def _plane_to_blocks(y):
    H, W = y.shape
    return y.reshape(H // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)


def _blocks_to_plane(blocks, H, W):
    return blocks.reshape(H // 8, W // 8, 8, 8).transpose(0, 2, 1, 3).reshape(H, W)


# --------------------------------------------------------------- jitted phases
#
# Module-level so the compile cache is keyed on shapes + static ints only;
# tables/codebooks flow through as traced operands.


@partial(jax.jit, static_argnames=("sr",))
def _encode_gop(frames_y, qt, inv_qt, mv_lens, sr: int):
    """[T, H, W] float32 -> per-frame (qsyms, mvs, mv_bits, recons)."""
    T, H, W = frames_y.shape

    def symbolize(plane):
        coeffs = dct2_fused(_plane_to_blocks(plane))
        qsym = jnp.round(coeffs * inv_qt[None, :]).astype(jnp.int32)
        deq = (qsym.astype(jnp.float32) * qt[None, :]).astype(jnp.int32)
        recon = _blocks_to_plane(idct2_fused(deq.astype(jnp.float32)), H, W)
        return qsym, recon

    def frame_step(recon_prev, inputs):
        t, y = inputs

        def intra():
            qsym, recon = symbolize(y)
            mv = jnp.full((H // 8, W // 8), (sr * (2 * sr + 1)) + sr, jnp.int32)
            return qsym, mv, jnp.int32(0), recon

        def inter():
            mv = motion_search_auto(recon_prev, y, sr)
            # dense MC (chosen where gathers were slow); the masked
            # candidate accumulation is bit-identical for encoder MVs
            pred = motion_compensate_dense(recon_prev, mv, sr)
            qsym, rrec = symbolize(y - pred)
            mv_bits = jnp.sum(mv_lens[jnp.clip(mv, 0, mv_lens.shape[0] - 1)])
            return qsym, mv, mv_bits, pred + rrec

        qsym, mv, bits, recon = jax.lax.cond(t == 0, intra, inter)
        return recon, (qsym, mv, bits, recon)

    ts = jnp.arange(T, dtype=jnp.int32)
    _, (qsyms, mvs, mv_bits, recons) = jax.lax.scan(
        frame_step, jnp.zeros((H, W), jnp.float32), (ts, frames_y)
    )
    return qsyms, mvs, mv_bits, recons


@jax.jit
def _gop_counts_max(qsyms):
    """Max zero-run symbol count over a GOP (the bucket-picking pre-pass).

    Module-level jit: building this inside ``pack_gop`` retraced on every
    call.
    """
    return jnp.max(jax.vmap(zerorun_counts)(qsyms.reshape(qsyms.shape[0], -1, 64)))


@partial(jax.jit, static_argnames=("cap", "raw_bits"))
def _map_gop_hot(qsyms, hot_vals, hot_fused, esc_code, esc_len, lower_bound,
                 cap: int, raw_bits: int):
    """Zero-run encode + dense hot/escape code mapping, flat over T*N.

    Also returns the pack extents (max block words, max group words) and a
    capacity flag so the dispatcher can validate its sticky buckets from
    one lazy fetch instead of separate blocking pre-passes.
    """
    T, N, _ = qsyms.shape
    flat = qsyms.reshape(T * N, 64)
    true_counts = zerorun_counts(flat)
    buf, valid = zerorun_encode_blocks_dense(flat, 64, EOB, cap)
    codes, lens = map_codes_hot(
        buf - lower_bound, valid, hot_vals, hot_fused, esc_code, esc_len, raw_bits
    )
    bw_max, gw_max = pack_extents(lens)
    cap_ok = jnp.max(true_counts) <= cap
    return codes, lens, valid, bw_max, gw_max, cap_ok


@partial(jax.jit, static_argnames=("H", "W", "cap", "lw", "sr", "raw_bits", "max_len"))
def _decode_gop_hot(words, block_offsets, block_counts, mvs,
                    lj, first_code, group_offset, alpha_of_rank, min_len,
                    esc_rank, lower_bound, qt,
                    H: int, W: int, cap: int, lw: int, sr: int, raw_bits: int,
                    max_len: int = 16):
    """Entropy decode + reconstruct: one flat gather-free pass."""
    T, G, GW = words.shape
    N = block_counts.shape[1]

    frame_base = (jnp.arange(T, dtype=jnp.int32) * (G * GW * 32))[:, None]
    offs = (block_offsets + frame_base).reshape(-1)
    cnts = block_counts.reshape(-1)

    local = locals_from_groups(words.reshape(T * G, GW), offs, PACK_GROUP, lw)
    sym_idx = decode_blocks_hot(
        local, cnts, lj, first_code, group_offset, alpha_of_rank,
        min_len, esc_rank, cap, raw_bits, max_len,
    )
    syms = jnp.where(
        jnp.arange(cap)[None, :] < cnts[:, None],
        sym_idx + lower_bound,
        0,
    )
    blocks, ok = zerorun_decode_blocks_dense(syms, cnts, 64, EOB)
    deq = (blocks.astype(jnp.float32) * qt[None, :]).astype(jnp.int32)
    pix = idct2_fused(deq.astype(jnp.float32))
    planes = (
        pix.reshape(T, H // 8, W // 8, 8, 8).transpose(0, 1, 3, 2, 4).reshape(T, H, W)
    )

    def rebuild(recon_prev, inputs):
        t, residual, mv = inputs
        pred = jnp.where(
            t == 0,
            jnp.zeros_like(recon_prev),
            motion_compensate_dense(recon_prev, mv, sr),
        )
        recon = pred + residual
        return recon, recon

    ts = jnp.arange(T, dtype=jnp.int32)
    _, recons = jax.lax.scan(rebuild, jnp.zeros((H, W), jnp.float32), (ts, planes, mvs))
    return recons, ok


@partial(jax.jit, static_argnames=("bw", "gw"))
def _buckets_ok(bw_max, gw_max, cap_ok, bw: int, gw: int):
    """Single device bool: this GOP fits the sticky pack buckets."""
    return cap_ok & (bw_max + 2 <= bw) & (gw_max <= gw)


@partial(jax.jit, static_argnames=("n_blocks", "raw_bits"))
def _map_stream_hot(flat_syms, hot_vals, hot_fused, esc_code, esc_len,
                    n_blocks: int, raw_bits: int):
    """Flat symbol stream -> 64-symbol blocks + dense hot code mapping."""
    M = flat_syms.shape[0]
    S = 64
    padded = jnp.zeros((n_blocks * S,), jnp.int32).at[:M].set(flat_syms)
    buf = padded.reshape(n_blocks, S)
    counts = jnp.clip(M - jnp.arange(n_blocks, dtype=jnp.int32) * S, 0, S)
    codes, lens = map_codes_hot(buf, counts, hot_vals, hot_fused, esc_code, esc_len, raw_bits)
    bw_max, gw_max = pack_extents(lens)
    return codes, lens, counts, bw_max, gw_max


@partial(jax.jit, static_argnames=("cap", "lw", "raw_bits", "max_len"))
def _decode_stream_hot(words, offsets, counts, lj, fc, go, ar, min_len, esc_rank,
                       cap: int, lw: int, raw_bits: int, max_len: int = 16):
    local = locals_from_groups(words, offsets, PACK_GROUP, lw)
    return decode_blocks_hot(
        local, counts, lj, fc, go, ar, min_len, esc_rank, cap, raw_bits, max_len
    )


class FusedVideoCodec:
    """Fixed-codebook hybrid codec with fully device-resident GOP phases."""

    def __init__(self, quantization_scale: float = 1.0, search_range: int = 4):
        self.q = float(quantization_scale)
        self.sr = int(search_range)
        qt = quant_table_zigzag(self.q, 1)[0]
        self.qt = jnp.asarray(qt)
        self.inv_qt = jnp.asarray((1.0 / qt).astype(np.float32))
        self.residual_code: HotCode | None = None
        self.mv_code: HotCode | None = None

    # ------------------------------------------------------------ training

    def train(self, frames_y: np.ndarray):
        """Fit residual + MV codebooks from a few frames (host, once)."""
        frames_y = np.asarray(frames_y, dtype=np.float32)
        # I-frame stats from frame 0; P-residual stats from frame 1 if present
        planes = [frames_y[0]]
        if frames_y.shape[0] > 1:
            mv = motion_search(frames_y[0], frames_y[1], self.sr)
            pred = np.asarray(motion_compensate(frames_y[0], mv, self.sr))
            planes.append(frames_y[1] - pred)
        from ivclab_tpu.ops.transform import forward_symbolize, symbol_histogram
        from ivclab_tpu.models.intracodec import _sym_min_max

        bufs = []
        for p in planes:
            buf, valid, _ = forward_symbolize(p[:, :, None], self.inv_qt[None], EOB)
            bufs.append((buf, valid))
        mn = min(int(_sym_min_max(b, v)[0]) for b, v in bufs)
        mx = max(int(_sym_min_max(b, v)[1]) for b, v in bufs)
        lo, hi = bucket_bounds(mn, mx)
        hist = sum(np.asarray(symbol_histogram(b, v, lo, hi)) for b, v in bufs)
        self.set_residual_code(build_hot_code(hist, lower_bound=lo))

        n_mv = (2 * self.sr + 1) ** 2
        self.mv_code = build_hot_code(np.ones(n_mv), lower_bound=0, K=n_mv)
        return self

    def set_residual_code(self, code: HotCode):
        """Install a residual hot/escape codebook + device tables."""
        self.residual_code = code
        self._hot_vals = jnp.asarray(code.hot_values)
        fused = code.fused_table()
        self._hot_fused = jnp.asarray(fused[: code.K])
        self._esc_code = jnp.asarray(code.code.codes[code.K], dtype=jnp.uint32)
        self._esc_len = jnp.asarray(int(code.code.lengths[code.K]), dtype=jnp.int32)
        self._dec_lj = jnp.asarray(code.code.lj_next_minus1)
        self._dec_fc = jnp.asarray(np.asarray(code.code.first_code, dtype=np.uint32))
        self._dec_go = jnp.asarray(code.code.group_offset.astype(np.int32))
        self._dec_ar = jnp.asarray(code.alpha_of_rank)
        self._dec_minlen = jnp.int32(code.code.min_len)
        self._dec_escrank = jnp.int32(code.esc_rank)
        self._buckets = None  # sticky pack buckets are per-codebook
        return self

    # ------------------------------------------------------------ phases

    def encode_gop(self, frames_y):
        """[T, H, W] float32 -> per-frame symbols/motion/recon/bits."""
        # MV alphabet indices == canonical hot slots only if hot_values is
        # the identity; build_hot_code with K = n keeps hot_values sorted by
        # frequency, so map alphabet index -> its code length:
        lens = np.zeros(self.mv_code.alphabet_n, dtype=np.int32)
        lens[self.mv_code.hot_values] = self.mv_code.code.lengths[: self.mv_code.K]
        esc = int(self.mv_code.code.lengths[self.mv_code.K]) + self.mv_code.raw_bits
        lens[lens == 0] = esc
        return _encode_gop(frames_y, self.qt, self.inv_qt, jnp.asarray(lens), self.sr)

    def pack_gop(self, qsyms, check: bool = True):
        """Flat hot/escape Huffman packing of the residual symbol buffers.

        Host dispatcher with *sticky* size buckets: the first GOP pays
        blocking extent pre-passes to pick the symbol-capacity, group-words
        and block-words buckets; subsequent GOPs pack SPECULATIVELY with
        the sticky buckets (map + pack + adequacy flag all dispatched
        back-to-back, no host read in between) and only then block on the
        single ``ok`` flag — the host read overlaps the device executing
        the pack instead of serializing ahead of it. A
        bucket violation (content grew) triggers one synchronous re-bucket
        + re-pack.

        With ``check=False`` the method performs no host synchronization
        once sticky buckets are established: the returned :class:`PackedGop`
        carries the adequacy flag as a device bool in ``.ok`` and the caller
        is responsible for checking it at its next natural sync point (and
        re-packing via :meth:`repack_gop` if it reads False). The very first
        GOP after (re)training still pays the blocking bucket-picking
        pre-passes regardless of ``check``. The streaming/bench hot loops
        use this to keep the steady-state GOP round trip free of host
        syncs.

        qsyms: [T, N, 64] -> (group_words [T, G, GW] u32, total_bits [T],
        block_offsets [T, N], block_counts [T, N], block_words int).
        """
        code = self.residual_code
        lo = jnp.int32(code.lower_bound)
        if getattr(self, "_buckets", None) is None:
            cap = _bucket(int(_gop_counts_max(qsyms)), CAP_BUCKETS)
            out = _map_gop_hot(
                qsyms, self._hot_vals, self._hot_fused, self._esc_code,
                self._esc_len, lo, cap, code.raw_bits,
            )
            codes, lens, valid, bw_max, gw_max, _ = out
            bw = _bucket(int(bw_max) + 2, BW_BUCKETS)
            gw = _bucket(int(gw_max), GW_BUCKETS)
            self._buckets = (cap, bw, gw)
            okflag = jnp.bool_(True)
        else:
            cap, bw, gw = self._buckets
            codes, lens, valid, bw_max, gw_max, cap_ok = _map_gop_hot(
                qsyms, self._hot_vals, self._hot_fused, self._esc_code,
                self._esc_len, lo, cap, code.raw_bits,
            )
            okflag = _buckets_ok(bw_max, gw_max, cap_ok, bw, gw)
        group_words, group_bits, offsets = pack_grouped_sized(codes, lens, gw, bw)

        T, N, _ = qsyms.shape
        G = group_words.shape[0] // T
        words = group_words.reshape(T, G, gw)
        frame_base = (jnp.arange(T, dtype=jnp.int32) * (G * gw * 32))[:, None]
        offs = offsets.reshape(T, N) - frame_base
        gbits = group_bits.reshape(T, G)
        p = PackedGop(
            words, jnp.sum(gbits, axis=1), offs, valid.reshape(T, N), gbits, bw, cap,
            okflag,
        )
        if check and not bool(okflag):  # blocks; overlaps the pack execution
            return self.repack_gop(qsyms)
        return p

    def repack_gop(self, qsyms):
        """Drop the sticky buckets and re-pack (bucket-violation recovery)."""
        self._buckets = None
        return self.pack_gop(qsyms)

    def decode_gop(self, words, block_offsets, block_counts, mvs, H: int, W: int,
                   block_words: int | None = None, cap: int | None = None):
        """Entropy decode + reconstruct the GOP from the packed streams."""
        code = self.residual_code
        if cap is None:
            cap = _bucket(int(jnp.max(block_counts)), CAP_BUCKETS)
        if block_words is None:
            # conservative: every symbol at the max coded length
            block_words = _bucket(cap * code.mean_len_bound() // 32 + 2, BW_BUCKETS)
        return _decode_gop_hot(
            words, block_offsets, block_counts, mvs,
            self._dec_lj, self._dec_fc, self._dec_go, self._dec_ar,
            self._dec_minlen, self._dec_escrank, jnp.int32(code.lower_bound),
            self.qt, H, W, cap, block_words, self.sr, code.raw_bits,
            code.code.max_len,
        )

    # ------------------------------------------------------------ container

    def encode_to_container(self, frames_y) -> bytes:
        """Encode a GOP into a self-contained IVC1 video payload.

        Unlike the reference, whose decoder reads the motion vectors and
        symbol counts from encoder state
        (``ivclab/video/videocodec.py:57-86``), the returned bytes carry
        everything: header, hot/escape codebooks (residual + MV), the
        grouped residual streams with their parallel-decode sidecar, and
        the Huffman-packed MV streams for frames 1..T-1.
        """
        frames_y = jnp.asarray(frames_y, dtype=jnp.float32)
        T, H, W = frames_y.shape
        qsyms, mvs, _, _ = self.encode_gop(frames_y)
        p = self.pack_gop(qsyms)
        return self.container_from_packed(p, mvs, (T, H, W))

    def container_from_packed(self, p: PackedGop, mvs, shape) -> bytes:
        """Serialize an already-packed GOP (+ motion fields) to IVC1 bytes.

        Shared by the single-chip ``encode_to_container`` path and the
        multi-device assembly (``ivclab_tpu.parallel.video``): the sharded
        encoder's gathered group substreams feed in as a :class:`PackedGop`
        and serialize identically to the single-device pack.
        """
        from ivclab_tpu.runtime.container import (
            GroupedSection, HotCodebook, VideoPayload,
        )

        T, H, W = shape

        # MV substream: frames 1..T-1, 64 symbols per block
        mv_flat = mvs[1:].reshape(-1)
        M = int(mv_flat.shape[0])
        n_blocks = max(-(-M // 64), 1)
        n_blocks = -(-n_blocks // PACK_GROUP) * PACK_GROUP
        mvc = self.mv_code
        mv_fused = jnp.asarray(mvc.fused_table())
        codes, lens, mv_counts, bw_max, gw_max = _map_stream_hot(
            mv_flat, jnp.asarray(mvc.hot_values), mv_fused[: mvc.K],
            jnp.asarray(mvc.code.codes[mvc.K], dtype=jnp.uint32),
            jnp.asarray(int(mvc.code.lengths[mvc.K]), dtype=jnp.int32),
            n_blocks, mvc.raw_bits,
        )
        mv_bw = _bucket(int(bw_max) + 2, BW_BUCKETS)
        mv_gw = _bucket(int(gw_max), GW_BUCKETS)
        mv_words, mv_gbits, mv_offs = pack_grouped_sized(codes, lens, mv_gw, mv_bw)

        T_, G, GW = p.words.shape
        frame_base = np.arange(T_, dtype=np.int64)[:, None] * (G * GW * 32)
        global_offs = np.asarray(p.offsets).astype(np.int64) + frame_base
        residual = GroupedSection.from_device(
            p.words, p.group_bits, global_offs, p.counts, PACK_GROUP, GW
        )
        mv_section = GroupedSection.from_device(
            mv_words, mv_gbits, mv_offs, mv_counts, PACK_GROUP, mv_gw
        )
        totals = np.asarray(p.totals, dtype=np.uint64)
        payload = VideoPayload(
            quantization_scale=self.q,
            eob=EOB,
            search_range=self.sr,
            shape=(T, H, W),
            payload_bits=int(totals.sum()) + int(np.asarray(mv_gbits).sum()),
            frame_bits=totals,
            residual_codebook=HotCodebook.from_code(self.residual_code),
            mv_codebook=HotCodebook.from_code(mvc),
            residual=residual,
            mv=mv_section,
        )
        return payload.to_bytes()

    @classmethod
    def decode_from_container(cls, blob: bytes):
        """Reconstruct a GOP from bytes alone. Returns ([T, H, W] float32
        Y reconstructions, ok)."""
        from ivclab_tpu.runtime.container import VideoPayload

        p = VideoPayload.from_bytes(blob)
        T, H, W = p.shape
        codec = cls(quantization_scale=p.quantization_scale, search_range=p.search_range)
        codec.set_residual_code(p.residual_codebook.to_code())
        mvc = p.mv_codebook.to_code()
        codec.mv_code = mvc

        # MV substream first
        mv_words, mv_offs, mv_counts = p.mv.device_views()
        n_mv_blocks = mv_counts.shape[0]
        mv_lw = p.mv.words_per_group  # small sections: full-width register
        mv_lw = min(mv_lw, _bucket(64 * mvc.mean_len_bound() // 32 + 2, BW_BUCKETS))
        sym = _decode_stream_hot(
            mv_words.reshape(-1, p.mv.words_per_group), mv_offs, mv_counts,
            jnp.asarray(mvc.code.lj_next_minus1),
            jnp.asarray(np.asarray(mvc.code.first_code, dtype=np.uint32)),
            jnp.asarray(mvc.code.group_offset.astype(np.int32)),
            jnp.asarray(mvc.alpha_of_rank),
            jnp.int32(mvc.code.min_len), jnp.int32(mvc.esc_rank),
            64, mv_lw, mvc.raw_bits, mvc.code.max_len,
        )
        hb, wb = H // 8, W // 8
        M = (T - 1) * hb * wb
        mv_p = jnp.reshape(sym.reshape(-1)[:M], (T - 1, hb, wb))
        filler = jnp.full(
            (1, hb, wb), (codec.sr * (2 * codec.sr + 1)) + codec.sr, jnp.int32
        )
        mvs = jnp.concatenate([filler, mv_p], axis=0)

        # residual streams
        words_flat, offs, counts = p.residual.device_views()
        n_groups = p.residual.group_word_counts.size
        G = n_groups // T
        GW = p.residual.words_per_group
        words = words_flat.reshape(T, G, GW)
        frame_base = (jnp.arange(T, dtype=jnp.int32) * (G * GW * 32))[:, None]
        offsets = offs.reshape(T, -1) - frame_base
        counts = counts.reshape(T, -1)
        cap = _bucket(int(p.residual.block_counts.max(initial=1)), CAP_BUCKETS)
        bw = _bucket(p.max_block_words(), BW_BUCKETS)
        recons, ok = codec.decode_gop(words, offsets, counts, mvs, H, W, bw, cap)
        return recons, ok

    # ------------------------------------------------------------ one-call

    def encode_decode_gop(self, frames_y):
        """Full encode -> pack -> decode round trip; host-friendly wrapper.

        Returns (recons, bits_per_frame, ok, encoder_recons).
        """
        frames_y = jnp.asarray(frames_y, dtype=jnp.float32)
        qsyms, mvs, mv_bits, enc_recons = self.encode_gop(frames_y)
        p = self.pack_gop(qsyms)
        bits = p.totals + mv_bits
        T, H, W = frames_y.shape
        recons, ok = self.decode_gop(
            p.words, p.offsets, p.counts, mvs, H, W, p.block_words, p.cap
        )
        return recons, bits, ok, enc_recons
