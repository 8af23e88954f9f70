"""JPEG-style still-image intra codec, device-parallel end to end.

Reference parity: ``ivclab/image/intracodec.py:11-306`` (IntraCodec,
IntraCodecAdaptive). API mirrors the reference; internals are the fused
device pipeline (``ivclab_tpu/ops/transform.py``):

  encode: rgb2ycbcr -> pad -> [one fused matmul: DCT+zigzag] ->
          [quantize epilogue] -> [vectorized zero-run] -> [device Huffman
          prefix-sum pack]        — all one jitted program per image shape
  decode: [parallel canonical Huffman block decode] -> [parallel zero-run
          decode] -> [dequantize + fused IDCT matmul] -> unpatch -> crop ->
          ycbcr2rgb

Differences from the reference, by design:
- ``num_symbols`` is carried in the container format
  (``ivclab_tpu/runtime/container.py``) rather than as instance state; the
  attribute is still kept for API compatibility
  (reference side channel: ivclab/image/intracodec.py:206-210).
- Grayscale inputs are quantized with the luminance table only; the
  reference silently broadcasts its [3,8,8] table stack against C=1 blocks,
  tripling the symbol stream (latent bug, like SURVEY.md component #6).
- Training bounds are bucketed to multiples of 64 so recompilation does not
  trigger per frame (the data-driven margin of +/-20 of
  ivclab/image/intracodec.py:163-165 is preserved inside the bucket).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ivclab_tpu.entropy.huffman import HuffmanCoder
from ivclab_tpu.entropy.stats import smooth_pmf
from ivclab_tpu.ops.bitpack import decode_blocks_device, decode_tables
from ivclab_tpu.ops.color import rgb2ycbcr, ycbcr2rgb
from ivclab_tpu.ops.quant import quant_table_zigzag
from ivclab_tpu.ops.transform import (
    GROUP_WORDS,
    PACK_GROUP,
    forward_symbolize,
    inverse_reconstruct,
    pack_symbols,
    pack_symbols_grouped,
    symbol_histogram,
)
from ivclab_tpu.ops.zerorun import (
    BLOCK_CAP,
    compact_symbols,
    zerorun_decode_blocks,
    zerorun_decode_stream,
)

_BOUND_BUCKET = 64
_SAFETY_MARGIN = 20  # matches ivclab/image/intracodec.py:163


@jax.jit
def _sym_min_max(buf, valid_len):
    pos = jnp.arange(buf.shape[1], dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    mn = jnp.min(jnp.where(mask, buf, jnp.int32(2**31 - 1)))
    mx = jnp.max(jnp.where(mask, buf, jnp.int32(-(2**31 - 1))))
    return mn, mx


def bucket_bounds(mn: int, mx: int, margin: int = _SAFETY_MARGIN, bucket: int = _BOUND_BUCKET):
    lo = ((mn - margin) // bucket) * bucket
    hi = -((-(mx + margin + 1)) // bucket) * bucket
    return int(lo), int(hi)


class IntraCodec:
    """Facade matching ``ivclab/image/intracodec.py`` over the fused pipeline."""

    def __init__(
        self,
        quantization_scale: float = 1.0,
        bounds=None,
        end_of_block: int = 4000,
        block_shape=(8, 8),
    ):
        self.quantization_scale = float(quantization_scale)
        self.bounds = bounds
        self.end_of_block = int(end_of_block)
        self.block_shape = tuple(block_shape)
        self.huffman: HuffmanCoder | None = None
        self.num_symbols: int | None = None
        self._qt_cache: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # ------------------------------------------------------------ plumbing

    def _tables(self, C: int):
        if C not in self._qt_cache:
            qt = quant_table_zigzag(self.quantization_scale, max(C, 1))
            self._qt_cache[C] = (qt, (1.0 / qt).astype(np.float32))
        return self._qt_cache[C]

    def _prepare(self, img, is_source_rgb: bool):
        """-> (device [H8, W8, C] float32 YCbCr, original shape tuple)."""
        x = jnp.asarray(img, dtype=jnp.float32)
        orig_shape = tuple(int(s) for s in x.shape)
        if is_source_rgb:
            x = rgb2ycbcr(x)
        if x.ndim == 2:
            x = x[:, :, None]
        H, W = x.shape[0], x.shape[1]
        ph, pw = (-H) % 8, (-W) % 8
        if ph or pw:
            x = jnp.pad(x, ((0, ph), (0, pw), (0, 0)), mode="edge")
        return x, orig_shape

    def _padded_grid(self, original_shape):
        H, W = original_shape[0], original_shape[1]
        C = original_shape[2] if len(original_shape) == 3 else 1
        hp = -(-H // 8)
        wp = -(-W // 8)
        return hp, wp, C

    # ------------------------------------------------ symbol-level API

    def image2symbols(self, img, is_source_rgb: bool = True) -> np.ndarray:
        """Image -> compact zero-run symbol stream (int32)."""
        x, _ = self._prepare(img, is_source_rgb)
        _, inv_qt = self._tables(x.shape[2])
        buf, valid_len, _ = forward_symbolize(x, inv_qt, self.end_of_block)
        stream, total = compact_symbols(buf, valid_len)
        return np.asarray(stream)[: int(total)]

    def symbols2image(self, symbols, original_shape):
        """Symbol stream -> reconstructed image (inverse of image2symbols)."""
        hp, wp, C = self._padded_grid(original_shape)
        qt, _ = self._tables(C)
        s = jnp.asarray(np.asarray(symbols), dtype=jnp.int32)
        blocks, ok = zerorun_decode_stream(s, s.shape[0], hp * wp * C, 64, self.end_of_block)
        if not bool(ok):
            raise ValueError("zero-run decode failed: corrupt stream or wrong shape")
        recon = inverse_reconstruct(blocks, qt, (hp * 8, wp * 8, C))
        return self._finalize(recon, original_shape)

    def _finalize(self, recon_ycbcr, original_shape):
        H, W = original_shape[0], original_shape[1]
        recon = recon_ycbcr[:H, :W]
        if len(original_shape) == 2:
            return np.asarray(recon[:, :, 0])
        if original_shape[2] == 3:
            return np.asarray(ycbcr2rgb(recon))
        return np.asarray(recon)

    # ------------------------------------------------ codebook training

    def _train_from_buffers(self, buf, valid_len):
        mn, mx = _sym_min_max(buf, valid_len)
        lo, hi = bucket_bounds(int(mn), int(mx))
        self.bounds = (lo, hi)
        hist = symbol_histogram(buf, valid_len, lo, hi)
        pmf = smooth_pmf(hist.astype(jnp.float32) / jnp.sum(hist))
        self.huffman = HuffmanCoder(lower_bound=lo).train(np.asarray(pmf, dtype=np.float64))
        code = self.huffman.code
        self._enc_codes = jnp.asarray(code.codes)
        self._enc_lens = jnp.asarray(code.lengths)
        self._dec_tables = decode_tables(code)
        return self.huffman

    def train_huffman_from_image(self, training_img, is_source_rgb: bool = True):
        """Symbolize, histogram on device, build the canonical codebook.

        Reference: ivclab/image/intracodec.py:149-171.
        """
        x, _ = self._prepare(training_img, is_source_rgb)
        _, inv_qt = self._tables(x.shape[2])
        buf, valid_len, _ = forward_symbolize(x, inv_qt, self.end_of_block)
        self._train_from_buffers(buf, valid_len)
        return None

    def _require_code(self):
        if self.huffman is None or self.huffman.code is None:
            raise RuntimeError("Train the Huffman coder before encoding.")
        return self.huffman.code

    # ------------------------------------------------ bitstream API

    def _encode_device(self, x):
        """Device encode of a prepared plane stack -> stream pieces."""
        code = self._require_code()
        _, inv_qt = self._tables(x.shape[2])
        buf, valid_len, qsym = forward_symbolize(x, inv_qt, self.end_of_block)
        N = buf.shape[0]
        num_words = N * BLOCK_CAP  # worst-case static capacity
        words, total_bits, block_offsets = pack_symbols(
            buf, valid_len, self._enc_codes, self._enc_lens, num_words, code.lower_bound
        )
        return words, total_bits, block_offsets, valid_len, qsym

    def intra_encode(self, img, return_bpp: bool = False, is_source_rgb: bool = True):
        """Encode to a u32 word stream; optionally report payload bpp.

        bpp uses the reference's convention bits/(H*W)
        (ivclab/image/intracodec.py:187-189).
        """
        x, orig_shape = self._prepare(img, is_source_rgb)
        words, total_bits, _, valid_len, _ = self._encode_device(x)
        total_bits = int(total_bits)
        self.num_symbols = int(jnp.sum(valid_len))
        bitstream = np.asarray(words[: (total_bits + 31) // 32])
        if return_bpp:
            return bitstream, total_bits / (orig_shape[0] * orig_shape[1])
        return bitstream, None

    def intra_decode(self, bitstream, original_shape, num_symbols: int | None = None):
        """Decode a u32 word stream back to an image.

        ``num_symbols`` defaults to the encoder side channel for reference
        API parity; the container API carries it explicitly.
        """
        if num_symbols is None:
            if self.num_symbols is None:
                raise RuntimeError(
                    "No symbol count found. Make sure to encode first or store symbol count."
                )
            num_symbols = self.num_symbols
        symbols = self.huffman.decode(np.asarray(bitstream, dtype=np.uint32), num_symbols)
        return self.symbols2image(symbols.astype(np.int32), original_shape)

    def decode_device(self, words, block_offsets, block_sym_counts, original_shape):
        """Fully device-parallel decode (per-block offsets from the container)."""
        code = self._require_code()
        hp, wp, C = self._padded_grid(original_shape)
        qt, _ = self._tables(C)
        sym_idx = decode_blocks_device(
            jnp.asarray(words), block_offsets, block_sym_counts, self._dec_tables, BLOCK_CAP
        )
        syms = sym_idx + code.lower_bound
        stream, total = compact_symbols(syms, block_sym_counts)
        blocks, ok = zerorun_decode_stream(stream, total, hp * wp * C, 64, self.end_of_block)
        recon = inverse_reconstruct(blocks, qt, (hp * 8, wp * 8, C))
        return self._finalize(recon, original_shape), ok

    # ------------------------------------------------ container API

    def encode_to_container(self, img, is_source_rgb: bool = True) -> bytes:
        """Encode to a self-contained IVC1 byte stream (shape, codebook,
        symbol count and the parallel-decode sidecar all included —
        replacing the reference's side channels,
        ivclab/image/intracodec.py:206-210, 252-263)."""
        from ivclab_tpu.runtime import container as ct

        code = self._require_code()
        x, orig_shape = self._prepare(img, is_source_rgb)
        _, inv_qt = self._tables(x.shape[2])
        buf, valid_len, _ = forward_symbolize(x, inv_qt, self.end_of_block)
        buf, valid_len, _ = _pad_blocks(buf, valid_len)
        group_words, group_bits, block_offsets, total_bits = pack_symbols_grouped(
            buf, valid_len, self._enc_codes, self._enc_lens, code.lower_bound
        )
        self.num_symbols = int(jnp.sum(valid_len))
        # width-slice the section to the measured used words, like the
        # video paths: a full-stride (GROUP_WORDS=1600) words_per_group
        # made the decoder materialize [G, 1600] buffers — which large
        # legitimate images could not even get past the decoder's
        # allocation cap — and fetched the mostly-empty tail to the
        # host. Offsets rebase to the sliced stride.
        gb_np = np.asarray(group_bits)
        wmax = ct.packer_wmax(gb_np, GROUP_WORDS)
        G = gb_np.shape[0]
        base_old = np.arange(G, dtype=np.int64) * (GROUP_WORDS * 32)
        base_new = np.arange(G, dtype=np.int64) * (wmax * 32)
        offs = (
            np.asarray(block_offsets).astype(np.int64)
            - np.repeat(base_old, PACK_GROUP)
            + np.repeat(base_new, PACK_GROUP)
        )
        payload = ct.grouped_payload_from_device(
            kind=ct.KIND_INTRA if len(orig_shape) == 3 else ct.KIND_PLANE,
            shape=orig_shape,
            q=self.quantization_scale,
            eob=self.end_of_block,
            num_symbols=self.num_symbols,
            group_words=np.asarray(group_words[:, :wmax]),
            group_bits=gb_np,
            block_offsets=offs,
            block_counts=valid_len,
            codebook=ct.Codebook(code.lower_bound, np.asarray(code.lengths, dtype=np.uint8)),
            words_per_group=wmax,
            group_size=PACK_GROUP,
        )
        return payload.to_bytes()

    @staticmethod
    def decode_from_container(data: bytes):
        """Decode an IVC1 byte stream with a fresh codec (no shared state)."""
        from ivclab_tpu.runtime import container as ct

        payload = ct.IntraPayload.from_bytes(data)
        codec = IntraCodec(
            quantization_scale=payload.quantization_scale,
            end_of_block=payload.eob,
        )
        code = payload.codebook.canonical()
        hp, wp, C = codec._padded_grid(payload.shape)
        qt, _ = codec._tables(C)
        words, offs, counts = ct.device_views(payload)
        # canonical-walk depth bucketed from the sidecar (the sequential
        # symbol loop dominates decode; typical content fits 48 of the
        # 128-slot worst case)
        from ivclab_tpu.ops.transform import cap_slice

        cap = cap_slice(int(payload.block_counts.max(initial=1)), BLOCK_CAP)
        sym_idx = decode_blocks_device(words, offs, counts, decode_tables(code), cap)
        n_real = hp * wp * C
        syms = jnp.where(
            jnp.arange(cap)[None, :] < counts[:, None],
            sym_idx + code.lower_bound,
            0,
        )[:n_real]
        blocks, ok = zerorun_decode_blocks(syms, counts[:n_real], 64, payload.eob)
        if not bool(ok):
            raise ValueError("container decode failed: corrupt stream")
        recon = inverse_reconstruct(blocks, qt, (hp * 8, wp * 8, C))
        return codec._finalize(recon, payload.shape)

    def encode_decode(self, img, return_bpp: bool = False, is_source_rgb: bool = True, verify_entropy: bool = False):
        """Encode and decode in one device round trip.

        The entropy stage is bit-lossless (tested property), so by default
        reconstruction reuses the quantized coefficients already on device
        instead of re-decoding the stream; ``verify_entropy=True`` forces
        the full Huffman+zero-run decode path like the reference
        (ivclab/image/intracodec.py:214-241).
        """
        x, orig_shape = self._prepare(img, is_source_rgb)
        words, total_bits, block_offsets, valid_len, qsym = self._encode_device(x)
        total_bits = int(total_bits)
        self.num_symbols = int(jnp.sum(valid_len))
        bitstream = np.asarray(words[: (total_bits + 31) // 32])

        if verify_entropy:
            recon, ok = self.decode_device(words, block_offsets, valid_len, orig_shape)
            if not bool(ok):
                raise ValueError("entropy round-trip verification failed")
        else:
            hp, wp, C = self._padded_grid(orig_shape)
            qt, _ = self._tables(C)
            recon_pad = inverse_reconstruct(qsym, qt, (hp * 8, wp * 8, C))
            recon = self._finalize(recon_pad, orig_shape)

        if return_bpp:
            bpp = total_bits / (orig_shape[0] * orig_shape[1])
            return recon, bitstream, total_bits, bpp
        return recon, bitstream, total_bits


def _pad_blocks(buf, valid_len, multiple: int = PACK_GROUP):
    """Pad the block axis to a multiple of the pack group (empty blocks)."""
    N = buf.shape[0]
    pad = (-N) % multiple
    if pad:
        buf = jnp.concatenate([buf, jnp.zeros((pad, buf.shape[1]), buf.dtype)], axis=0)
        valid_len = jnp.concatenate([valid_len, jnp.zeros((pad,), valid_len.dtype)], axis=0)
    return buf, valid_len, N


class IntraCodecAdaptive(IntraCodec):
    """Per-frame adaptive variant shipping its codebook with the stream.

    Reference parity: ``ivclab/image/intracodec.py:244-306``, with the
    pickle side channel replaced by a compact deterministic serialization
    (lower bound + per-symbol canonical code lengths — canonical codes are
    fully reconstructible from lengths).
    """

    def _serialize_codebook(self) -> bytes:
        code = self._require_code()
        import struct

        header = struct.pack("<iI", code.lower_bound, code.n)
        return header + code.lengths.astype(np.uint8).tobytes()

    def _deserialize_codebook(self, blob: bytes):
        import struct

        from ivclab_tpu.entropy.codebook import canonical_from_lengths

        lower, n = struct.unpack("<iI", blob[:8])
        lengths = np.frombuffer(blob[8 : 8 + n], dtype=np.uint8).astype(np.int32)
        code = canonical_from_lengths(lengths, lower)
        self.huffman = HuffmanCoder(lower_bound=lower)
        self.huffman.code = code
        self.bounds = (lower, lower + n)
        self._enc_codes = jnp.asarray(code.codes)
        self._enc_lens = jnp.asarray(code.lengths)
        self._dec_tables = decode_tables(code)

    def intra_encode(self, img, return_bpp: bool = False, is_source_rgb: bool = True):
        x, orig_shape = self._prepare(img, is_source_rgb)
        _, inv_qt = self._tables(x.shape[2])
        buf, valid_len, _ = forward_symbolize(x, inv_qt, self.end_of_block)
        self._train_from_buffers(buf, valid_len)
        code = self.huffman.code
        N = buf.shape[0]
        words, total_bits, _ = pack_symbols(
            buf, valid_len, self._enc_codes, self._enc_lens, N * BLOCK_CAP, code.lower_bound
        )
        total_bits = int(total_bits)
        self.num_symbols = int(jnp.sum(valid_len))
        bitstream = np.asarray(words[: (total_bits + 31) // 32])
        blob = self._serialize_codebook()
        packed = (len(blob), blob, bitstream, self.num_symbols)
        if return_bpp:
            return packed, total_bits / (orig_shape[0] * orig_shape[1])
        return packed, total_bits

    def intra_decode(self, packed_bitstream, original_shape, num_symbols: int | None = None):
        codebook_len, blob, bitstream, n_syms = packed_bitstream
        del codebook_len
        self._deserialize_codebook(blob)
        symbols = self.huffman.decode(np.asarray(bitstream, dtype=np.uint32), n_syms)
        return self.symbols2image(symbols.astype(np.int32), original_shape)
