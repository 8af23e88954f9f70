"""Hybrid I/P video codec: motion-compensated prediction + intra residuals.

Reference parity: ``ivclab/video/videocodec.py:12-104`` plus the three ch4
exercise variants, collapsed into one codec with a ``codebook_policy``
(SURVEY.md §7 step 7):

- ``"per-frame"``   — retrain the residual codebook every frame (library
  VideoCodec behavior, videocodec.py:72; codebook transmission not counted,
  as in the reference).
- ``"adaptive"``    — per-frame retrain AND the serialized codebook bits
  are charged to the stream (AdaptiveVideoCodec, exercises/ch4/E4-1.py).
- ``"first-p-frame"`` — train once on the first P-frame and reuse;
  out-of-alphabet symbols clamp to the nearest trained symbol
  (SimpleVideoCodec, exercises/ch4/ex1.py:163-176).

Deviations by design:
- The reference's ``motion_huffman`` is built with
  ``lower_bound = -((2sr+1)^2 - 1)//2`` but fed 0-based packed indices
  (videocodec.py:30,62) — any index > 40 raises. Here MV symbols are
  0-based over the (2sr+1)^2 alphabet.
- Grayscale planes quantize with the luminance table only (see
  ivclab_tpu/models/intracodec.py notes).

Frame recursion runs against the *decoder* reconstruction
(videocodec.py:51-52,75), so encoder and decoder stay in lockstep.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ivclab_tpu.entropy.huffman import HuffmanCoder
from ivclab_tpu.models.intracodec import IntraCodec, IntraCodecAdaptive, _sym_min_max, bucket_bounds
from ivclab_tpu.ops.color import rgb2ycbcr, ycbcr2rgb
from ivclab_tpu.ops.motion import motion_compensate, motion_search

CODEBOOK_POLICIES = ("per-frame", "adaptive", "first-p-frame")


# Full-range histogram window for the pipelined path: covers any bucketed
# bounds the per-frame codebooks can pick (EOB=4000 included). The
# per-frame bucketed histogram is a slice of this one, so it can be
# computed INSIDE the device step — no data-dependent-bounds dispatch after
# the fact, which is what lets the tree builds overlap the device pipeline.
_HIST_LO, _HIST_HI = -4096, 4160

# Fast-path histogram window (chosen for the first target hardware, whose
# scatter-adds made the full-range histogram a third of the device step). Typical residual
# streams live in a narrow band around zero (plus run-length symbols
# 1..63 and EOB), so the step counts a static window with a dense
# compare-reduce, places it into the full-range
# array, and sets the EOB bin from an exact count. Content with any
# non-EOB symbol outside the window falls back to the exact scatter
# histogram via lax.cond — both branches produce identical integer
# counts, so codebooks (and therefore bits) never depend on the branch.
_WIN_LO, _WIN_HI = -512, 576


def _stream_histogram(buf, valid, eob: int):
    """Full-range [_HIST_LO, _HIST_HI) histogram of the valid symbols."""
    from ivclab_tpu.entropy.stats import histogram_int32

    pos = jnp.arange(buf.shape[1], dtype=jnp.int32)
    mask = pos[None, :] < valid[:, None]
    non_eob = mask & (buf != eob)
    mx_content = jnp.max(jnp.where(non_eob, buf, jnp.int32(_WIN_LO)))
    mn, mx = _sym_min_max(buf, valid)
    win_ok = (mn >= _WIN_LO) & (mx_content < _WIN_HI)

    def windowed():
        v = jnp.where(non_eob, buf, jnp.int32(_WIN_LO - 1)).reshape(-1)
        pad = (-v.shape[0]) % 64
        if pad:
            v = jnp.concatenate([v, jnp.full((pad,), _WIN_LO - 1, jnp.int32)])
        bins = jnp.arange(_WIN_LO, _WIN_HI, dtype=jnp.int32)
        chunks = v.reshape(64, -1)

        def body(acc, c):
            return acc + jnp.sum(c[:, None] == bins[None, :], axis=0, dtype=jnp.int32), None

        win, _ = jax.lax.scan(body, jnp.zeros((_WIN_HI - _WIN_LO,), jnp.int32), chunks)
        h = jnp.zeros((_HIST_HI - _HIST_LO,), jnp.int32)
        h = jax.lax.dynamic_update_slice(h, win, (_WIN_LO - _HIST_LO,))
        n_eob = jnp.sum((mask & (buf == eob)).astype(jnp.int32))
        return h.at[eob - _HIST_LO].set(n_eob)

    def full():
        return histogram_int32(buf, _HIST_LO, _HIST_HI, mask=mask)

    hist = jax.lax.cond(win_ok, windowed, full)
    return mn, mx, hist


def _pframe_core(y, recon_prev, t, inv_qt, qt, sr: int, eob: int):
    """One frame's device work for the pipelined adaptive path.

    Everything the codebook does NOT gate: motion search + compensation
    against the previous reconstruction, residual transform/quantize/
    symbolize, the closed-loop reconstruction (the entropy stage is
    lossless, so the recon chain never waits on it), and the full-range
    symbol histogram + min/max the host needs to build this frame's
    codebook.

    ME runs through the backend dispatcher (``motion_search_auto``) and MC
    through the dense select form — both bit-identical to the serial
    facade's ``motion_search``/``motion_compensate`` for the in-bounds
    fields the encoder emits (ME up to float near-ties on the GPU).
    """
    from ivclab_tpu.ops.motion import motion_compensate_dense, motion_search_auto
    from ivclab_tpu.ops.transform import forward_symbolize, inverse_reconstruct

    H, W = y.shape

    def intra():
        return jnp.zeros_like(y), jnp.zeros((H // 8, W // 8), jnp.int32)

    def inter():
        mv = motion_search_auto(recon_prev, y, sr)
        pred = motion_compensate_dense(recon_prev, mv, sr)
        return pred, mv

    pred, mv = jax.lax.cond(t == 0, intra, inter)
    residual = y - pred
    buf, valid, qsym = forward_symbolize(residual[:, :, None], inv_qt, eob)
    recon_residual = inverse_reconstruct(qsym, qt, (H, W, 1))[:, :, 0]
    recon = pred + recon_residual
    mn, mx, hist = _stream_histogram(buf, valid, eob)
    # vmax lets the host pick the pack's symbol-capacity slice BEFORE
    # dispatching it: the code-table gathers scale with the slots mapped,
    # and typical content fits the 32-slot prefix of the 128-slot buffers
    return buf, valid, mn, mx, hist, mv, recon, jnp.max(valid)


@partial(jax.jit, static_argnames=("sr", "eob"))
def _pframe_device_step(y, recon_prev, t, inv_qt, qt, sr: int, eob: int):
    """Single-frame dispatch of :func:`_pframe_core` (tests/tools)."""
    return _pframe_core(y, recon_prev, t, inv_qt, qt, sr, eob)


@partial(jax.jit, static_argnames=("sr", "eob"))
def _pframe_device_scan(frames_y, ts, inv_qt, qt, sr: int, eob: int):
    """One ``lax.scan`` over the per-frame device step: the WHOLE
    sequence's ME/MC/transform/histogram pipeline is a single dispatch
    (the per-frame dispatch chain cost host work per frame and let
    scheduling gaps creep between programs). ``ts`` carries
    the in-GOP frame indices (``t % gop_size`` for GOP restarts), so one
    compiled program serves every GOP structure of the same shape.
    Outputs are the stacked per-frame tuples of :func:`_pframe_core`.
    """
    def body(recon_prev, inputs):
        t, y = inputs
        out = _pframe_core(y, recon_prev, t, inv_qt, qt, sr, eob)
        return out[6], out

    _, outs = jax.lax.scan(
        body, jnp.zeros(frames_y.shape[1:], jnp.float32), (ts, frames_y)
    )
    return outs


@jax.jit
def _masked_code_bits(buf, valid, enc_lens, lower):
    """Exact coded bits of the valid symbols under a trained code."""
    pos = jnp.arange(buf.shape[1], dtype=jnp.int32)
    mask = pos[None, :] < valid[:, None]
    idx = jnp.clip(buf - lower, 0, enc_lens.shape[0] - 1)
    return jnp.sum(jnp.where(mask, enc_lens[idx], 0))


def _mv_fetch_dtype(search_range: int):
    """Narrowest dtype holding every packed motion index for a fetch
    (u8 covers search_range <= 7; larger ranges keep int32 — an
    unconditional u8 cast silently wrapped indices at sr >= 8)."""
    return jnp.uint8 if (2 * search_range + 1) ** 2 <= 255 else jnp.int32


def _sized_buckets_ok(gb_np, in_group_np, wpg: int, bw: int) -> bool:
    """True when the speculative pack buckets held this frame's content.

    ``group_bits`` and block offsets are exact cumsum-of-lengths outputs
    regardless of word-buffer truncation, so the host can validate the
    word streams without ever reading them: every group must fit its
    ``wpg``-word buffer and every block its ``bw``-word deposit window.
    ``in_group_np`` holds IN-GROUP bit offsets (u16-compact form is fine:
    an overflow that would wrap them also trips the group-bits bound).
    """
    from ivclab_tpu.ops.transform import PACK_GROUP

    gb = np.asarray(gb_np).astype(np.int64)
    if gb.size == 0:
        return True
    if int(gb.max()) > wpg * 32:
        return False
    ig = np.asarray(in_group_np).astype(np.int64).reshape(-1, PACK_GROUP)
    ends = np.concatenate([ig[:, 1:], gb[:, None]], axis=1)
    return int(((ends - ig).max(initial=0) + 31) // 32) <= bw


@partial(jax.jit, static_argnames=("wpg",))
def _compact_sidecar(gb, boffs, valid, wpg: int):
    """Device-side sidecar compaction before the host fetch.

    Chosen when the adaptive encode was bound by host-transfer bandwidth;
    rebasing the
    packer's global bit offsets to in-group u16 (they fit whenever the
    speculative buckets held — and an overflow wraps AFTER the group-bits
    check already failed), clipping group bits to u16, and narrowing the
    counts to u8 cuts the per-frame sidecar fetch ~3.5x.
    """
    from ivclab_tpu.ops.transform import PACK_GROUP

    G = gb.shape[0]
    base = jnp.arange(G, dtype=jnp.int32) * (wpg * 32)
    ig = boffs - jnp.repeat(base, PACK_GROUP)
    return (
        jnp.minimum(gb, 65535).astype(jnp.uint16),
        jnp.clip(ig, 0, 65535).astype(jnp.uint16),
        valid.astype(jnp.uint8),
    )


def _pack_section(buf, valid, code):
    """Grouped-pack one frame's symbol buffers under a plain canonical code.

    Returns ``(GroupedSection, exact payload bits)``; the section's words
    are word-aligned per group with the parallel-decode sidecar, so the
    container decoder runs ``decode_blocks_device`` over all blocks at once.

    Packs speculatively with the small ADAPTIVE_WPG/ADAPTIVE_BW buckets
    (the full-stride 1600-word packer costs 9x more device time and its
    mostly-empty word fetch dominated the adaptive container encode);
    content overflowing the buckets — validated exactly from the fetched
    sidecar, see :func:`_sized_buckets_ok` — re-packs full-stride. Bytes
    are identical either way.
    """
    from ivclab_tpu.models.intracodec import _pad_blocks
    from ivclab_tpu.ops.transform import (
        ADAPTIVE_BW, ADAPTIVE_WPG, FUSED_TABLE_MAX_LEN, GROUP_WORDS, PACK_GROUP,
        pack_symbols_grouped, pack_symbols_grouped_sized,
    )
    from ivclab_tpu.runtime.container import GroupedSection, packer_wmax

    buf, valid, _ = _pad_blocks(buf, valid)
    gw, gb, boffs, total = pack_symbols_grouped_sized(
        buf, valid, jnp.asarray(code.codes), jnp.asarray(code.lengths),
        jnp.int32(code.lower_bound), ADAPTIVE_WPG, ADAPTIVE_BW,
        fuse_table=bool(code.max_len <= FUSED_TABLE_MAX_LEN),
    )
    gb_np, boffs_np = np.asarray(gb), np.asarray(boffs)
    stride = ADAPTIVE_WPG
    base = np.arange(gb_np.shape[0], dtype=np.int64) * (ADAPTIVE_WPG * 32)
    ig = boffs_np.astype(np.int64) - np.repeat(base, PACK_GROUP)
    if not _sized_buckets_ok(gb_np, ig, ADAPTIVE_WPG, ADAPTIVE_BW):
        gw, gb, boffs, total = pack_symbols_grouped(
            buf, valid, jnp.asarray(code.codes), jnp.asarray(code.lengths),
            code.lower_bound,
        )
        gb_np, boffs_np = np.asarray(gb), np.asarray(boffs)
        stride = GROUP_WORDS
    wmax = packer_wmax(gb_np, stride)
    section = GroupedSection.from_packer_sliced(
        np.asarray(gw[:, :wmax]), gb_np, boffs_np, np.asarray(valid),
        PACK_GROUP, stride, wmax,
    )
    return section, int(total)


def _pack_flat_section(flat_syms, code):
    """Pack a flat symbol stream (e.g. motion indices) as 64-symbol blocks.

    Packed ON HOST through the C++ serial engine: motion streams are tiny
    (tens of KB), and the previous device pack cost five sequential
    blocking host round trips. The group-stream layout (MSB-first blocks
    concatenated per 16-block group, word-aligned group starts, u16
    in-group offsets, width-sliced words) is byte-identical to the device
    packer's; ``tests/test_video_container.py`` asserts the containers.
    """
    from ivclab_tpu.ops.transform import GROUP_WORDS, PACK_GROUP
    from ivclab_tpu.runtime import native
    from ivclab_tpu.runtime.container import GroupedSection, packer_wmax

    S = 64
    M = int(np.asarray(flat_syms).size)
    n_blocks = max(-(-M // S), 1)
    n_blocks = -(-n_blocks // PACK_GROUP) * PACK_GROUP
    padded = np.zeros(n_blocks * S, dtype=np.int64)
    padded[:M] = np.asarray(flat_syms).reshape(-1)
    counts = np.clip(M - np.arange(n_blocks) * S, 0, S).astype(np.int32)

    idx = np.clip(padded - code.lower_bound, 0, code.lengths.size - 1)
    blk_codes = code.codes[idx].astype(np.uint32).reshape(n_blocks, S)
    blk_lens = code.lengths[idx].astype(np.int32).reshape(n_blocks, S)
    mask = np.arange(S)[None, :] < counts[:, None]
    blk_lens = np.where(mask, blk_lens, 0)
    block_bits = blk_lens.sum(axis=1, dtype=np.int64)

    G = n_blocks // PACK_GROUP
    group_bits = block_bits.reshape(G, PACK_GROUP).sum(axis=1)
    wmax = packer_wmax(group_bits, GROUP_WORDS)
    words = np.zeros((G, wmax), dtype=np.uint32)
    for g in range(G):
        sl = slice(g * PACK_GROUP * S, (g + 1) * PACK_GROUP * S)
        w, _ = native.pack_bits(
            blk_codes.reshape(-1)[sl], blk_lens.reshape(-1)[sl]
        )
        words[g, : min(w.size, wmax)] = w[:wmax]
    bb = block_bits.reshape(G, PACK_GROUP)
    in_group = (np.cumsum(bb, axis=1) - bb).reshape(-1)
    section = GroupedSection(
        words=words,
        group_word_counts=((group_bits + 31) // 32).astype(np.uint32),
        block_offsets=in_group.astype(np.uint16),
        block_counts=counts.astype(np.uint8),
        group_size=PACK_GROUP,
        words_per_group=wmax,
    )
    return section, int(group_bits.sum())


class VideoCodec:
    def __init__(
        self,
        quantization_scale: float = 1.0,
        bounds=None,
        end_of_block: int = 4000,
        block_shape=(8, 8),
        search_range: int = 4,
        codebook_policy: str = "per-frame",
        verify_entropy: bool = False,
    ):
        """``verify_entropy=True`` forces the per-frame policies to run the
        full entropy encode+decode on every residual plane (instead of
        reconstructing from the on-device quantized coefficients and
        relying on the property-tested losslessness of the entropy stage).
        The bits and reconstructions are identical either way — asserted by
        ``tests/test_ch4_video.py::test_per_frame_sweep_verify_entropy``."""
        if codebook_policy not in CODEBOOK_POLICIES:
            raise ValueError(f"codebook_policy must be one of {CODEBOOK_POLICIES}")
        self.verify_entropy = bool(verify_entropy)
        self.quantization_scale = float(quantization_scale)
        self.bounds = bounds
        self.end_of_block = int(end_of_block)
        self.block_shape = tuple(block_shape)
        self.search_range = int(search_range)
        self.codebook_policy = codebook_policy

        codec_cls = IntraCodecAdaptive if codebook_policy == "adaptive" else IntraCodec
        self.intra_codec = codec_cls(
            quantization_scale=quantization_scale,
            bounds=bounds,
            end_of_block=end_of_block,
            block_shape=block_shape,
        )
        self.residual_codec = codec_cls(
            quantization_scale=quantization_scale,
            bounds=bounds,
            end_of_block=end_of_block,
            block_shape=block_shape,
        )

        self.motion_huffman = HuffmanCoder(lower_bound=0)
        self._motion_trained = False
        self.decoder_recon = None

    # ------------------------------------------------------------------

    def _code_motion(self, mv_grid: np.ndarray):
        """Huffman-code the packed motion field; returns (words, bits, decoded)."""
        num_symbols = (2 * self.search_range + 1) ** 2
        if not self._motion_trained:
            uniform = np.full(num_symbols, 1.0 / num_symbols)
            self.motion_huffman.train(uniform)
            self._motion_trained = True
        flat = mv_grid.reshape(-1)
        words, bits = self.motion_huffman.encode(flat)
        decoded = self.motion_huffman.decode(words, flat.size).reshape(mv_grid.shape)
        return words, bits, decoded.astype(np.int32)

    def _code_residual_plane(self, plane):
        """Train-per-policy + encode/decode one plane; returns (recon, bits)."""
        codec = self.residual_codec
        policy = self.codebook_policy
        codebook_bits = 0
        if policy == "adaptive":
            packed, bitsize = codec.intra_encode(np.asarray(plane), is_source_rgb=False)
            codebook_len, _, _, n_syms = packed
            codebook_bits = 8 * (codebook_len + 12)  # blob + (len,num_symbols) header
            recon = codec.intra_decode(packed, np.asarray(plane).shape)
            return recon, int(bitsize) + codebook_bits
        if policy == "per-frame" or codec.huffman is None:
            codec.train_huffman_from_image(plane, is_source_rgb=False)
        # first-p-frame reuses the codebook; the pack stage clamps
        # out-of-alphabet symbols to the alphabet edge (nearest trained value)
        verify = policy == "first-p-frame" or self.verify_entropy
        recon, _, bitsize = codec.encode_decode(
            plane, is_source_rgb=False, verify_entropy=verify
        )
        return recon, int(bitsize)

    # ------------------------------------------------------------------

    def encode_decode(self, frame, frame_num: int = 0, is_source_rgb: bool = False):
        """Encode+decode one frame; returns (recon_rgb u8, bitstream, bitsize).

        Frame 0 is an I-frame; later frames are P-frames predicted from the
        decoder reconstruction of the previous frame. Only luma is coded;
        chroma passes through (reference videocodec.py:77-80).

        ``bitstream`` is a self-contained IVC1 frame blob (codebooks + MV +
        residual streams) that :meth:`decode_frame_payload` reconstructs
        without encoder state — unlike the reference, which returns the MV
        words only and decodes residuals from internal state
        (``ivclab/video/videocodec.py:57-86``). ``bitsize`` keeps the
        reference's rate accounting (exact residual + MV code lengths,
        plus the codebook charge under the ``adaptive`` policy).
        """
        frame_ycbcr = np.asarray(rgb2ycbcr(np.asarray(frame, dtype=np.float32)))
        y_channel = frame_ycbcr[..., 0]

        if frame_num == 0:
            if self.codebook_policy != "adaptive":
                self.intra_codec.train_huffman_from_image(y_channel, is_source_rgb=False)
                recon_y, _, residual_bits = self.intra_codec.encode_decode(
                    y_channel, is_source_rgb=False, verify_entropy=self.verify_entropy
                )
            else:
                packed, residual_bits = self.intra_codec.intra_encode(
                    y_channel, is_source_rgb=False
                )
                recon_y = self.intra_codec.intra_decode(packed, y_channel.shape)
            motion_bits = 0
            self.decoder_recon = np.asarray(recon_y)
            bitstream = self._frame_blob(y_channel, self.intra_codec, residual_bits)
        else:
            ref_y = self.decoder_recon
            mv = np.asarray(motion_search(ref_y, y_channel, self.search_range))
            _, motion_bits, mv_decoded = self._code_motion(mv)
            prediction = np.asarray(
                motion_compensate(ref_y, jnp.asarray(mv_decoded), self.search_range)
            )
            residual = y_channel - prediction
            recon_residual, residual_bits = self._code_residual_plane(residual)
            recon_y = prediction + np.asarray(recon_residual)
            self.decoder_recon = recon_y
            bitstream = self._frame_blob(
                residual, self.residual_codec,
                int(residual_bits) + int(motion_bits), mv=mv_decoded,
            )

        recon_ycbcr = frame_ycbcr.copy()
        recon_ycbcr[..., 0] = np.clip(recon_y, 0, 255)
        recon_rgb = np.asarray(ycbcr2rgb(recon_ycbcr)).astype(np.uint8)
        return recon_rgb, bitstream, int(residual_bits) + int(motion_bits)

    # -------------------------------------------------- per-frame wire blobs

    def _require_mv_code(self):
        num_symbols = (2 * self.search_range + 1) ** 2
        if not self._motion_trained:
            self.motion_huffman.train(np.full(num_symbols, 1.0 / num_symbols))
            self._motion_trained = True
        return self.motion_huffman.code

    def _frame_blob(self, plane, codec_obj, bits: int, mv=None) -> bytes:
        """Serialize one facade frame to a self-contained IVC1 blob.

        I-frames (``mv is None``) become a T=1 ``AdaptiveVideoPayload``;
        P-frames a ``PFramePayload`` (MV + residual streams + codebooks).
        ``codec_obj`` supplies the trained canonical code and quant tables
        actually used by the facade for this frame.
        """
        from ivclab_tpu.ops.transform import forward_symbolize
        from ivclab_tpu.runtime.container import (
            AdaptiveVideoPayload, Codebook, PFramePayload,
        )

        code = codec_obj.huffman.code
        x, orig_shape = codec_obj._prepare(plane, is_source_rgb=False)
        _, inv_qt = codec_obj._tables(1)
        buf, valid, _ = forward_symbolize(x, jnp.asarray(inv_qt), self.end_of_block)
        section, _ = _pack_section(buf, valid, code)
        cb = Codebook(code.lower_bound, np.asarray(code.lengths, dtype=np.uint8))
        mv_code = self._require_mv_code()
        mv_cb = Codebook(0, np.asarray(mv_code.lengths, dtype=np.uint8))
        H, W = orig_shape[0], orig_shape[1]
        if mv is None:
            mv_section, _ = _pack_flat_section(np.zeros(0, np.int32), mv_code)
            return AdaptiveVideoPayload(
                quantization_scale=self.quantization_scale,
                eob=self.end_of_block,
                search_range=self.search_range,
                policy=1 if self.codebook_policy == "adaptive" else 0,
                shape=(1, H, W),
                payload_bits=int(bits),
                frame_bits=np.asarray([bits], dtype=np.uint64),
                mv_codebook=mv_cb,
                mv=mv_section,
                frames=[(cb, section)],
            ).to_bytes()
        mv_section, _ = _pack_flat_section(np.asarray(mv).reshape(-1), mv_code)
        return PFramePayload(
            quantization_scale=self.quantization_scale,
            eob=self.end_of_block,
            search_range=self.search_range,
            shape=(H, W),
            payload_bits=int(bits),
            mv_codebook=mv_cb,
            mv=mv_section,
            residual_codebook=cb,
            residual=section,
        ).to_bytes()

    @staticmethod
    def decode_frame_payload(blob: bytes, recon_prev=None):
        """Reconstruct one facade frame's luma plane from its blob alone.

        I-frame blobs (T=1 adaptive payloads) decode standalone; P-frame
        blobs additionally need the caller's previous reconstruction (the
        natural decoder state — NOT encoder state: codebooks, symbol
        counts and MVs all come from the bytes, unlike the reference's
        ``intra_decode``/``encode_decode`` side channels,
        ``ivclab/video/videocodec.py:57-86``).
        """
        from ivclab_tpu.ops.bitpack import decode_blocks_device, decode_tables
        from ivclab_tpu.ops.quant import quant_table_zigzag
        from ivclab_tpu.ops.transform import inverse_reconstruct
        from ivclab_tpu.ops.zerorun import BLOCK_CAP, zerorun_decode_blocks
        from ivclab_tpu.runtime.container import (
            KIND_PFRAME, KIND_VIDEO_ADAPTIVE, MAGIC, PFramePayload,
        )

        if len(blob) < 7 or blob[:4] != MAGIC:
            raise ValueError("not an IVC1 container")
        kind = blob[6]
        if kind == KIND_VIDEO_ADAPTIVE:
            return VideoCodec.decode_from_container(blob)[0]
        if kind != KIND_PFRAME:
            raise ValueError(f"not a frame payload (kind={kind})")
        if recon_prev is None:
            raise ValueError("P-frame decode needs the previous reconstruction")
        p = PFramePayload.from_bytes(blob)
        H, W = p.shape
        sr, eob = p.search_range, p.eob
        if H % 8 or W % 8:
            # the encoder's P-frame path (motion_search) only produces
            # 8-multiple planes; anything else here is a corrupt header
            raise ValueError(f"P-frame dims must be multiples of 8, got ({H}, {W})")
        hb, wb = H // 8, W // 8
        n_real = hb * wb

        mv_code = p.mv_codebook.canonical()
        words, offs, counts = p.mv.device_views()
        sym = decode_blocks_device(words, offs, counts, decode_tables(mv_code), 64)
        pos = jnp.arange(64, dtype=jnp.int32)
        sym = jnp.where(pos[None, :] < counts[:, None], sym, 0)
        mv = jnp.asarray(np.asarray(sym.reshape(-1)[:n_real]).reshape(hb, wb))

        code = p.residual_codebook.canonical()
        words, offs, counts = p.residual.device_views()
        sym_idx = decode_blocks_device(words, offs, counts, decode_tables(code), BLOCK_CAP)
        syms = jnp.where(
            jnp.arange(BLOCK_CAP)[None, :] < counts[:, None],
            sym_idx + code.lower_bound,
            0,
        )[:n_real]
        blocks, ok = zerorun_decode_blocks(syms, counts[:n_real], 64, eob)
        if not bool(ok):
            raise ValueError("corrupt P-frame residual stream")
        qt = jnp.asarray(quant_table_zigzag(p.quantization_scale, 1))
        rrec = inverse_reconstruct(blocks, qt, (H, W, 1))[:, :, 0]
        pred = motion_compensate(jnp.asarray(recon_prev, dtype=jnp.float32), mv, sr)
        return np.asarray(pred + rrec)

    # -------------------------------------------------- container (wire format)

    def encode_to_container(self, frames_y) -> bytes:
        """Encode a luma sequence into a self-contained IVC1 byte stream
        with PER-FRAME residual codebooks (``per-frame``/``adaptive``
        policies — the fixed-codebook ``first-p-frame`` policy serializes
        through :class:`~ivclab_tpu.models.fastvideo.FusedVideoCodec`'s
        ``KIND_VIDEO_GOP`` instead).

        The reference ships adaptive codebooks as pickles reloaded from
        encoder-side files (``exercises/ch4/E4-1.py:240-263,326-334``);
        here each frame section carries its canonical code lengths, so
        :meth:`decode_from_container` reconstructs the sequence from bytes
        alone, bit-identical to the in-memory ``encode_decode`` chain.

        ``frames_y``: ``[T, H, W]`` float (H, W multiples of 8).
        """
        if self.codebook_policy not in ("per-frame", "adaptive"):
            raise ValueError(
                "the adaptive container serializes per-frame codebooks; use "
                "policy 'per-frame' or 'adaptive' (first-p-frame streams "
                "serialize via FusedVideoCodec.encode_to_container)"
            )
        from ivclab_tpu.entropy.stats import smooth_pmf
        from ivclab_tpu.ops.transform import symbol_histogram
        from ivclab_tpu.runtime.container import AdaptiveVideoPayload, Codebook

        # jnp.asarray keeps already-device-resident frames on device (a
        # np.asarray here would force a download+upload)
        y_dev = jnp.asarray(frames_y, dtype=jnp.float32)
        T, H, W = y_dev.shape
        if H % 8 or W % 8:
            raise ValueError("container path needs frame dims divisible by 8")
        qt_np, inv_np = self.intra_codec._tables(1)
        qt, inv_qt = jnp.asarray(qt_np), jnp.asarray(inv_np)
        sr, eob = self.search_range, self.end_of_block

        n_mv = (2 * sr + 1) ** 2
        if not self._motion_trained:
            self.motion_huffman.train(np.full(n_mv, 1.0 / n_mv))
            self._motion_trained = True
        mv_code = self.motion_huffman.code

        # phase 1: ONE scan dispatch for every frame's device work (the
        # same pipelined structure as encode_decode_sequence_pipelined —
        # the closed-loop recon chain stays on device). Ops and operands
        # are identical to the serial facade, so the bytes are too.
        bufs, valids, _, _, _, mvs_dev, recons_dev, _ = outs = _pframe_device_scan(
            y_dev, jnp.arange(T, dtype=jnp.int32), inv_qt, qt, sr, eob
        )

        # phase 2a: ONE batched fetch for every frame's training stats + MVs
        # (per-frame fetches made the encoder latency-bound)
        from ivclab_tpu.models.intracodec import _pad_blocks
        from ivclab_tpu.ops.transform import pack_symbols_grouped

        mn_np, mx_np, hist_all, mv_all, vmax_np = jax.device_get(
            (outs[2], outs[3], outs[4],
             mvs_dev.astype(_mv_fetch_dtype(sr)), outs[7])
        )

        # phase 2b-i: dispatch every frame's pmf (device ops identical to
        # the serial facade's _train_from_buffers) and fetch them in ONE
        # batched device_get — per-frame fetches cost a host round trip
        # each
        pmf_pend = []
        for t in range(T):
            lo, hi = bucket_bounds(int(mn_np[t]), int(mx_np[t]))
            if _HIST_LO <= lo and hi <= _HIST_HI:
                hist = jnp.asarray(hist_all[t, lo - _HIST_LO : hi - _HIST_LO])
            else:  # pathological bounds: fall back to a direct histogram
                hist = symbol_histogram(bufs[t], valids[t], lo, hi)
            pmf_pend.append((lo, smooth_pmf(hist.astype(jnp.float32) / jnp.sum(hist))))
        pmfs = jax.device_get([p for _, p in pmf_pend])

        # phase 2b-ii: per-frame codebook builds (host) + SPECULATIVE
        # cap-sized pack dispatches (ADAPTIVE_WPG/ADAPTIVE_BW buckets; the
        # full-stride packer costs 9x more device time)
        from ivclab_tpu.ops.transform import (
            ADAPTIVE_BW, ADAPTIVE_WPG, FUSED_TABLE_MAX_LEN, GROUP_WORDS,
            PACK_GROUP, cap_slice, pack_symbols_grouped_sized,
        )

        pend = []
        for t, ((lo, _), pmf_np) in enumerate(zip(pmf_pend, pmfs)):
            coder = HuffmanCoder(lower_bound=lo).train(np.asarray(pmf_np, dtype=np.float64))
            code = coder.code
            bufp, validp, _ = _pad_blocks(bufs[t], valids[t])
            # capacity slice picked from the already-fetched per-frame max
            # symbol count: the code-table gathers dominate the pack, and
            # slots past the max count are masked anyway
            cap = cap_slice(int(vmax_np[t]), bufp.shape[1])
            gw, gb, boffs, _ = pack_symbols_grouped_sized(
                bufp[:, :cap], validp, jnp.asarray(code.codes), jnp.asarray(code.lengths),
                jnp.int32(lo), ADAPTIVE_WPG, ADAPTIVE_BW,
                fuse_table=bool(code.max_len <= FUSED_TABLE_MAX_LEN),
            )
            compact = _compact_sidecar(gb, boffs, validp, ADAPTIVE_WPG)
            pend.append([code, lo, mv_all[t], gw, compact, bufp, validp])

        # phase 2c: batched COMPACT sidecar fetch (u16 group bits + u16
        # in-group offsets + u8 counts); frames whose content overflowed the speculative buckets
        # (exact check from group bits + offsets) re-pack full-stride,
        # then one batched width-sliced word fetch
        from ivclab_tpu.runtime.container import GroupedSection, packer_wmax

        metas = jax.device_get([p[4] for p in pend])
        strides = [ADAPTIVE_WPG] * T
        for t, (p, (gb_np, ig_np, _)) in enumerate(zip(pend, metas)):
            if not _sized_buckets_ok(gb_np, ig_np, ADAPTIVE_WPG, ADAPTIVE_BW):
                code, lo = p[0], p[1]
                gw, gb, boffs, _ = pack_symbols_grouped(
                    p[5], p[6], jnp.asarray(code.codes),
                    jnp.asarray(code.lengths), lo,
                )
                p[3] = gw
                gb_np = np.asarray(gb)
                base = np.arange(gb_np.shape[0], dtype=np.int64) * (GROUP_WORDS * 32)
                ig_full = np.asarray(boffs).astype(np.int64) - np.repeat(base, PACK_GROUP)
                metas[t] = (gb_np, ig_full, metas[t][2])
                strides[t] = GROUP_WORDS
        wmaxes = []
        sliced = []
        for p, (gb_np, _, _), stride in zip(pend, metas, strides):
            wmax = packer_wmax(gb_np, stride)
            wmaxes.append(wmax)
            sliced.append(p[3][:, :wmax])
        words_all = jax.device_get(sliced)

        mvs = []
        frame_sections = []
        frame_bits = np.zeros(T, dtype=np.uint64)
        for t, ((code, lo, mv_np, *_), (gb_np, ig_np, valid_np),
                words_np, wmax, stride) in enumerate(
                    zip(pend, metas, words_all, wmaxes, strides)):
            if int(np.asarray(ig_np).max(initial=0)) >= 1 << 16:
                raise ValueError("in-group offset exceeds u16 sidecar range")
            section = GroupedSection(
                words=np.asarray(words_np),
                group_word_counts=(
                    (np.asarray(gb_np).astype(np.int64) + 31) // 32
                ).astype(np.uint32),
                block_offsets=np.asarray(ig_np).astype(np.uint16),
                block_counts=np.asarray(valid_np).astype(np.uint8),
                group_size=PACK_GROUP,
                words_per_group=wmax,
            )
            frame_sections.append(
                (Codebook(lo, np.asarray(code.lengths, dtype=np.uint8)), section)
            )
            bits = int(gb_np.astype(np.int64).sum())
            if t > 0:
                mvs.append(mv_np)
                # facade rate parity (_code_residual_plane/_code_motion):
                # MV code lengths + the adaptive policy's codebook charge
                bits += int(np.sum(np.asarray(mv_code.lengths)[mv_np.reshape(-1)]))
                if self.codebook_policy == "adaptive":
                    bits += 8 * ((8 + code.n) + 12)
            frame_bits[t] = bits
        self.decoder_recon = recons_dev[-1]  # fetched lazily if the caller reads it

        mv_flat = (
            np.stack(mvs).reshape(-1).astype(np.int32)
            if mvs else np.zeros(0, dtype=np.int32)
        )
        mv_section, _ = _pack_flat_section(mv_flat, mv_code)
        payload = AdaptiveVideoPayload(
            quantization_scale=self.quantization_scale,
            eob=eob,
            search_range=sr,
            policy=1 if self.codebook_policy == "adaptive" else 0,
            shape=(T, H, W),
            payload_bits=int(frame_bits.sum()),
            frame_bits=frame_bits,
            mv_codebook=Codebook(0, np.asarray(mv_code.lengths, dtype=np.uint8)),
            mv=mv_section,
            frames=frame_sections,
        )
        return payload.to_bytes()

    @classmethod
    def decode_from_container(cls, blob: bytes, return_device: bool = False):
        """Reconstruct ``[T, H, W]`` float32 luma from bytes alone.

        A fresh process needs nothing but the blob: per-frame codebooks,
        MV streams and residual streams all come out of the container
        (unlike the reference decoder, which reads codebook metadata from
        encoder-side pickle files, ``exercises/ch4/E4-1.py:326-334``).

        ``return_device=True`` returns ``(device [T, H, W] array, ok
        flags)`` without the host fetch — at 1080p the float32
        reconstruction of an 8-frame GOP is ~66 MB; device-resident
        consumers (metrics, re-encode, display pipelines) should keep the
        frames on device.
        """
        from ivclab_tpu.ops.bitpack import decode_blocks_device, decode_tables
        from ivclab_tpu.ops.transform import inverse_reconstruct
        from ivclab_tpu.ops.zerorun import BLOCK_CAP, zerorun_decode_blocks
        from ivclab_tpu.runtime.container import AdaptiveVideoPayload

        p = AdaptiveVideoPayload.from_bytes(blob)
        T, H, W = p.shape
        sr, eob = p.search_range, p.eob
        codec = cls(
            quantization_scale=p.quantization_scale,
            end_of_block=eob,
            search_range=sr,
            codebook_policy="adaptive" if p.policy else "per-frame",
        )
        qt = jnp.asarray(codec.intra_codec._tables(1)[0])
        hb, wb = H // 8, W // 8
        hp, wp = -(-H // 8), -(-W // 8)  # padded grid (T=1 I-frame blobs
        # from the facade may carry edge-padded non-8-multiple shapes)

        # MV streams (frames 1..T-1)
        M = (T - 1) * hb * wb
        if M:
            mv_code = p.mv_codebook.canonical()
            words, offs, counts = p.mv.device_views()
            sym = decode_blocks_device(words, offs, counts, decode_tables(mv_code), 64)
            pos = jnp.arange(64, dtype=jnp.int32)
            sym = jnp.where(pos[None, :] < counts[:, None], sym, 0)
            mvs = np.asarray(sym.reshape(-1)[:M]).reshape(T - 1, hb, wb)

        n_real = hp * wp
        recon_prev = None
        recons = []
        oks = []
        # every frame's entropy decode + reconstruction is DISPATCHED
        # without a host sync (a per-frame bool(ok) fetch would cost a
        # host round trip per frame); validity flags drain in one
        # batched fetch with the reconstructions
        from ivclab_tpu.ops.motion import motion_compensate_dense

        from ivclab_tpu.ops.transform import cap_slice

        for t, (cb, section) in enumerate(p.frames):
            code = cb.canonical()
            words, offs, counts = section.device_views()
            # the canonical walk's sequential depth is the symbol
            # capacity; the sidecar's max block count picks the smallest
            # adequate bucket (typically 48 vs the 128 worst case)
            cap = cap_slice(int(section.block_counts.max(initial=1)), BLOCK_CAP)
            sym_idx = decode_blocks_device(
                words, offs, counts, decode_tables(code), cap
            )
            syms = jnp.where(
                jnp.arange(cap)[None, :] < counts[:, None],
                sym_idx + code.lower_bound,
                0,
            )[:n_real]
            blocks, ok = zerorun_decode_blocks(syms, counts[:n_real], 64, eob)
            oks.append(ok)
            rrec = inverse_reconstruct(blocks, qt, (hp * 8, wp * 8, 1))[:H, :W, 0]
            if t == 0:
                recon = rrec
            else:
                pred = motion_compensate_dense(recon_prev, jnp.asarray(mvs[t - 1]), sr)
                recon = pred + rrec
            recon_prev = recon
            recons.append(recon)
        if return_device:
            return jnp.stack(recons), jnp.stack(oks)
        recons_np, oks_np = jax.device_get((recons, oks))  # one batched fetch
        for t, ok in enumerate(oks_np):
            if not bool(ok):
                raise ValueError(f"frame {t}: corrupt residual stream")
        return np.stack(recons_np)

    def encode_decode_sequence_checkpointed(self, frames, gop_size: int, checkpointer):
        """GOP-granular fault-tolerant encode (SURVEY.md §5 'Failure
        detection'): completed GOPs are loaded from the checkpointer, the
        rest are encoded and persisted atomically. A crashed run resumes
        re-encoding only its unfinished GOPs.
        """
        frames = np.asarray(frames)
        T = frames.shape[0]
        n_gops = -(-T // gop_size)
        recons = np.zeros_like(frames)
        bits = np.zeros(T, dtype=np.int64)
        for g in range(n_gops):
            lo, hi = g * gop_size, min((g + 1) * gop_size, T)
            cached = checkpointer.load_gop(g)
            if cached is not None:
                # GOPs open with an I-frame, so no cross-GOP state is
                # needed: restore outputs and skip the compute entirely
                _, gop_recons, gop_bits = cached
                recons[lo:hi] = gop_recons
                bits[lo:hi] = gop_bits
                continue
            gop_recons, gop_bits = [], []
            for t in range(lo, hi):
                recon, _, b = self.encode_decode(frames[t], frame_num=t - lo)
                gop_recons.append(recon)
                gop_bits.append(b)
            recons[lo:hi] = np.stack(gop_recons)
            bits[lo:hi] = gop_bits
            checkpointer.save_gop(
                g, b"", np.stack(gop_recons), np.asarray(gop_bits, dtype=np.int64)
            )
        return recons, bits

    def encode_decode_sequence_pipelined(self, frames, gop_size: int | None = None):
        """Per-frame-adaptive sequence coding with tree-build/transform
        overlap (SURVEY.md §7 'Hard parts': per-frame Huffman retraining
        forces a histogram -> host-tree-build -> rate round trip per frame;
        pipeline it).

        Bit-for-bit the same rates and reconstructions as the serial
        ``encode_decode_sequence`` for the ``per-frame`` and ``adaptive``
        policies (asserted by tests/test_ch4_video.py), restructured so the
        device never waits on the host:

        1. ALL per-frame device steps (motion search/compensation, residual
           transform, closed-loop reconstruction) are dispatched up front —
           the recon recursion is closed-loop through the *quantized*
           residual, so it never depends on the entropy stage (lossless).
        2. The host then walks the frames building each one's codebook
           (bucketed bounds -> device histogram -> canonical tree) and
           dispatching the exact-rate reduction, while the device pipeline
           runs ahead asynchronously.
        3. The serial path's per-frame host Huffman decode
           (``IntraCodecAdaptive.intra_decode``) is dropped entirely: the
           entropy stage is bit-lossless (property-tested), so the decoded
           symbols equal the quantized coefficients already on device.

        Returns ``(recons_rgb uint8 [T, H, W, 3], bits [T])``. Frames must
        be multiples of 8 in both dimensions (every reference workload is).
        """
        if self.codebook_policy not in ("per-frame", "adaptive"):
            raise ValueError(
                "pipelined sequence coding retrains per frame; use policy "
                "'per-frame' or 'adaptive' (first-p-frame has no per-frame "
                "tree build to pipeline — use FusedVideoCodec)"
            )
        frames = np.asarray(frames)
        T, H, W = frames.shape[:3]
        if H % 8 or W % 8:
            raise ValueError("pipelined path needs frame dims divisible by 8")
        from ivclab_tpu.entropy.stats import smooth_pmf
        from ivclab_tpu.ops.transform import cap_slice, symbol_histogram

        # stays on device end to end, and uint8 sources upload as uint8
        # (float32 RGB at 1080p is 25 MB/frame, uint8 a quarter of it).
        # The device-side f32 cast is exact.
        ycbcr = rgb2ycbcr(jnp.asarray(frames).astype(jnp.float32))
        y = ycbcr[..., 0]
        qt_np, inv_np = self.intra_codec._tables(1)
        qt, inv_qt = jnp.asarray(qt_np), jnp.asarray(inv_np)

        # phase 1: ONE scan dispatch over the whole sequence; the
        # dependency recon_{t-1} -> frame t stays on device. The in-GOP
        # frame indices ride in as data, so one compiled program serves
        # every gop_size.
        local_ts = np.arange(T) if gop_size is None else np.arange(T) % gop_size
        outs = _pframe_device_scan(
            y, jnp.asarray(local_ts, dtype=jnp.int32), inv_qt, qt,
            self.search_range, self.end_of_block,
        )
        bufs, valids, _, _, _, _, recons_dev, _ = outs

        # MV codebook: uniform pmf trained once (reference videocodec.py:57-60)
        n_mv = (2 * self.search_range + 1) ** 2
        if not self._motion_trained:
            self.motion_huffman.train(np.full(n_mv, 1.0 / n_mv))
            self._motion_trained = True
        mv_lens = self.motion_huffman.code.lengths

        # phase 2: host tree builds overlap the queued device pipeline —
        # each frame's histogram was computed inside its device step, so
        # the per-frame device->host traffic collapses into two batched
        # fetches (stats, then pmfs); the rate reductions dispatch
        # asynchronously (fetched in phase 3)
        mn_np, mx_np, hist_all, mv_all, vmax_np = jax.device_get(
            (outs[2], outs[3], outs[4],
             outs[5].astype(_mv_fetch_dtype(self.search_range)), outs[7])
        )
        pmf_pend = []
        for t in range(T):
            lo, hi = bucket_bounds(int(mn_np[t]), int(mx_np[t]))
            if _HIST_LO <= lo and hi <= _HIST_HI:
                h = jnp.asarray(hist_all[t, lo - _HIST_LO : hi - _HIST_LO])
            else:  # pathological bounds: fall back to a direct histogram
                h = symbol_histogram(bufs[t], valids[t], lo, hi)
            # same device ops on the same integer counts as the serial
            # facade -> bit-identical pmf -> identical canonical code
            pmf_pend.append((lo, smooth_pmf(h.astype(jnp.float32) / jnp.sum(h))))
        pmfs = jax.device_get([p for _, p in pmf_pend])

        pending = []
        for t, ((lo, _), pmf_np) in enumerate(zip(pmf_pend, pmfs)):
            coder = HuffmanCoder(lower_bound=lo).train(np.asarray(pmf_np, dtype=np.float64))
            code = coder.code
            cap = cap_slice(int(vmax_np[t]), bufs.shape[2])
            bits_dev = _masked_code_bits(
                bufs[t, :, :cap], valids[t], jnp.asarray(code.lengths), jnp.int32(lo)
            )
            extra = 0
            if int(local_ts[t]) > 0:
                # serialized codebook charge, P-frames only (facade parity:
                # _code_residual_plane; blob = 8B header + n lengths, +12B)
                if self.codebook_policy == "adaptive":
                    extra += 8 * ((8 + code.n) + 12)
                extra += int(np.sum(mv_lens[mv_all[t].reshape(-1)]))
            pending.append((bits_dev, extra))

        # phase 3: drain the async rate reductions
        bits_frames = [int(b) + extra for b, extra in pending]

        recon_y = jnp.clip(recons_dev, 0, 255)[..., None]
        recon_ycbcr = jnp.concatenate([recon_y, ycbcr[..., 1:]], axis=-1)
        # truncating uint8 cast matches the facade's np astype(np.uint8)
        recons_rgb = np.asarray(ycbcr2rgb(recon_ycbcr).astype(jnp.uint8))
        return recons_rgb, np.asarray(bits_frames, dtype=np.int64)

    def encode_decode_sequence(self, frames, gop_size: int | None = None):
        """Encode a whole sequence; returns (recons, bits_per_frame).

        ``gop_size`` restarts an I-frame every N frames (the GOP structure
        multi-host sharding keys on, SURVEY.md §5 'long-context' row).
        """
        recons, bits = [], []
        for t, frame in enumerate(np.asarray(frames)):
            local_t = t if gop_size is None else t % gop_size
            recon, _, bitsize = self.encode_decode(frame, frame_num=local_t)
            recons.append(recon)
            bits.append(bitsize)
        return np.stack(recons), np.asarray(bits)
