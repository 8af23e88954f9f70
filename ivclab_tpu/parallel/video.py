"""Multi-device hybrid video coding: GOP x tile sharding via shard_map.

The multi-device reshape of the reference's serial frame loop
(``ivclab/video/videocodec.py:37-86``):

- the frame stack is sharded ``(gop, tile)``: independent GOPs across the
  ``gop`` axis (each opens with an I-frame so the decoder-reconstruction
  recursion stays local), row bands across the ``tile`` axis;
- inside each shard a ``lax.scan`` runs the I/P recursion; per frame the
  reconstructed-reference halo (search_range rows) is exchanged with ring
  neighbors via ``ppermute`` before tile-local motion search;
- per-frame bit counts are ``psum``-reduced over the tile axis.

Everything under one ``jax.jit``; ``__graft_entry__.dryrun_multichip``
runs it on a virtual CPU mesh and ``chip_smoke.py --four-cards`` on four
GPUs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ivclab_tpu.ops.dct import dct2_fused, idct2_fused
from ivclab_tpu.ops.motion import resolve_me_backend
from ivclab_tpu.ops.quant import quant_table_zigzag
from ivclab_tpu.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks_dense
from ivclab_tpu.parallel.halo import (
    exchange_row_halo,
    motion_compensate_tile,
    motion_search_tile,
)


def _tile_me(me_backend: str | None, total_h: int, sr: int):
    """Tile ME callable ``(ref_ext, cur, row0) -> mv`` for a backend
    (``ops.motion.resolve_me_backend``; all are bit-identical on integer
    frames)."""
    me_backend = resolve_me_backend(me_backend)
    if me_backend == "scan":
        return lambda ref_ext, cur, row0: motion_search_tile(
            ref_ext, cur, row0, total_h, sr
        )
    from ivclab_tpu.ops.motion_pallas import motion_search_tile_pallas

    interpret = me_backend == "pallas-interpret"
    return lambda ref_ext, cur, row0: motion_search_tile_pallas(
        ref_ext, cur, row0, total_h, sr, interpret=interpret
    )


def _band_symbol_bits(plane, inv_qt, qt, enc_lens, lower_bound: int, eob: int):
    """Transform+quantize one row band, return (coded bits, reconstruction).

    The rate comes from the trained code lengths over the zero-run symbol
    buffers; reconstruction reuses the quantized coefficients (the entropy
    stage is lossless).
    """
    Ht, W = plane.shape
    x = plane.reshape(Ht // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
    coeffs = dct2_fused(x)
    qsym = jnp.round(coeffs * inv_qt[None, :]).astype(jnp.int32)
    buf, valid_len = zerorun_encode_blocks_dense(qsym, 64, eob, BLOCK_CAP)
    pos = jnp.arange(buf.shape[1], dtype=jnp.int32)
    mask = pos[None, :] < valid_len[:, None]
    idx = jnp.clip(buf - lower_bound, 0, enc_lens.shape[0] - 1)
    bits = jnp.sum(jnp.where(mask, enc_lens[idx], 0))
    deq = (qsym.astype(jnp.float32) * qt[None, :]).astype(jnp.int32)
    pix = idct2_fused(deq.astype(jnp.float32))
    recon = pix.reshape(Ht // 8, W // 8, 8, 8).transpose(0, 2, 1, 3).reshape(Ht, W)
    return bits, recon


def build_sharded_video_encoder(
    mesh,
    gop_len: int,
    band_h: int,
    width: int,
    quantization_scale: float = 1.0,
    search_range: int = 4,
    residual_code=None,
    mv_code=None,
    me_backend: str | None = None,
):
    """Compile a GOP+tile-sharded video encode step over ``mesh``.

    Returns ``step(frames_y) -> (recon_y, bits_per_frame)`` where
    ``frames_y`` is ``[gops * gop_len, H, W]`` float32 (H = band_h * tile
    axis size), sharded gop-major. Codebooks are fixed (the
    ``first-p-frame`` policy of exercises/ch4/ex1.py) so the whole GOP
    recursion stays on device.
    """
    n_tile = mesh.shape["tile"]
    H = band_h * n_tile
    qt = jnp.asarray(quant_table_zigzag(quantization_scale, 1)[0])
    inv_qt = 1.0 / qt
    sr = search_range

    if residual_code is not None:
        enc_lens = jnp.asarray(residual_code.lengths)
        lower = residual_code.lower_bound
    else:
        # entropy proxy: ~6 bits per nonzero symbol when no code is trained
        enc_lens = jnp.full((5120,), 6, dtype=jnp.int32)
        lower = -1024
    mv_lens = (
        jnp.asarray(mv_code.lengths)
        if mv_code is not None
        else jnp.full(((2 * sr + 1) ** 2,), 7, dtype=jnp.int32)
    )
    eob = 4000
    tile_me = _tile_me(me_backend, H, sr)

    def shard_fn(frames_local):
        """frames_local: [gop_len, band_h, W] — one GOP's row band."""
        tile_idx = jax.lax.axis_index("tile")
        row0 = tile_idx.astype(jnp.int32) * band_h

        def frame_step(recon_prev, inputs):
            t, y = inputs

            def intra():
                bits, recon = _band_symbol_bits(y, inv_qt, qt, enc_lens, lower, eob)
                return bits, recon

            def inter():
                ref_ext = exchange_row_halo(recon_prev, sr, "tile")
                mv = tile_me(ref_ext, y, row0)
                mv_bits = jnp.sum(mv_lens[jnp.clip(mv, 0, mv_lens.shape[0] - 1)])
                pred = motion_compensate_tile(ref_ext, mv, sr)
                residual = y - pred
                rbits, rrec = _band_symbol_bits(residual, inv_qt, qt, enc_lens, lower, eob)
                return rbits + mv_bits, pred + rrec

            bits, recon = jax.lax.cond(t == 0, intra, inter)
            bits = jax.lax.psum(bits, "tile")
            return recon, (bits, recon)

        ts = jnp.arange(frames_local.shape[0], dtype=jnp.int32)
        _, (bits, recons) = jax.lax.scan(
            frame_step, jnp.zeros_like(frames_local[0]), (ts, frames_local)
        )
        return recons, bits

    from jax import shard_map

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("gop", "tile", None),
        out_specs=(P("gop", "tile", None), P("gop")),
        check_vma=False,
    )

    @jax.jit
    def step(frames_y):
        n_gop = mesh.shape["gop"]
        T, Hf, Wf = frames_y.shape
        assert Hf == H and Wf == width and T % n_gop == 0
        recons, bits = sharded(frames_y)
        return recons, bits.reshape(-1)

    return step


def shard_frames(frames_y, mesh):
    """Place a ``[T, H, W]`` stack with T over gop and H over tile."""
    return jax.device_put(frames_y, NamedSharding(mesh, P("gop", "tile", None)))


# --------------------------------------------------------------------------
# Full sharded codec: distributed entropy coding + bitstream assembly
# (SURVEY.md §7.6). Unlike ``build_sharded_video_encoder`` (a rate
# calculator), this path PACKS real bitstreams on every shard.


class ShardedGopStreams(NamedTuple):
    """Gathered outputs of one sharded encode+pack step.

    Global layouts match the single-device fused codec exactly: frames are
    gop-major on the T axis; within a frame, blocks/groups are band-major,
    which — row bands being contiguous row ranges — IS raster order, so the
    assembled stream is bit-identical to ``FusedVideoCodec.pack_gop`` on
    the same frames (asserted by ``__graft_entry__.dryrun_multichip`` and
    ``tests/test_parallel.py``).
    """

    words: jnp.ndarray       # [T, G, GW] u32 word-aligned group substreams
    offsets: jnp.ndarray     # [T, N] frame-relative block bit offsets
    counts: jnp.ndarray      # [T, N] per-block symbol counts
    group_bits: jnp.ndarray  # [T, G] exact per-group payload bits
    totals: jnp.ndarray      # [T] per-frame residual bits (psum over tiles)
    mvs: jnp.ndarray         # [T, H/8, W/8] packed motion indices
    recons: jnp.ndarray      # [T, H, W] closed-loop reconstructions


def build_sharded_video_codec(
    mesh,
    codec,
    gop_len: int,
    band_h: int,
    width: int,
    cap: int,
    group_words: int,
    block_words: int,
    me_backend: str | None = None,
):
    """Compile a GOP+tile-sharded encode **and entropy-pack** step.

    The distributed form of the reference's serial encode
    (``ivclab/video/videocodec.py:37-86``) including the entropy stage the
    rate-only ``build_sharded_video_encoder`` omits:

    - each (gop, tile) shard runs the I/P recursion on its row band with
      ``ppermute`` halo motion search (neighbour-to-neighbour traffic
      only);
    - each shard zero-run + hot/escape Huffman-packs its own blocks into
      word-aligned group substreams (``pack_grouped_sized``) — entropy
      coding is fully distributed, no host round trip;
    - per-frame bit totals are ``psum``-reduced over the tile axis;
    - the ``out_specs`` gather IS the distributed assembly: group
      substreams concatenate band-major per frame (= raster block order),
      and each shard rebases its block bit offsets by its tile's group
      prefix (``tile_idx * Gb * GW * 32``) so the gathered offsets index
      the global frame stream directly. Host 0 then only compacts
      (``assemble_video_payloads``): per-group word counts -> prefix
      layout -> concat, the §7.6 all-gather/prefix-sum/concat step.

    ``codec`` is a trained :class:`~ivclab_tpu.models.fastvideo.FusedVideoCodec`
    whose codebooks/tables are baked into the compiled program;
    ``cap``/``group_words``/``block_words`` are the static size buckets and
    must match the fused codec's for bit-identical streams
    (``codec._buckets`` after a ``pack_gop`` call).

    Returns ``step(frames_y) -> ShardedGopStreams`` over
    ``[n_gop * gop_len, band_h * n_tile, width]`` float32 stacks.
    """
    from ivclab_tpu.models.fastvideo import EOB
    from ivclab_tpu.ops.transform import PACK_GROUP, map_codes_hot, pack_grouped_sized
    from ivclab_tpu.ops.zerorun import zerorun_encode_blocks_dense
    from ivclab_tpu.parallel.halo import motion_compensate_tile_dense

    n_tile = mesh.shape["tile"]
    n_gop = mesh.shape["gop"]
    H = band_h * n_tile
    W = width
    sr = codec.sr
    Nb = (band_h // 8) * (W // 8)  # blocks per band per frame
    if Nb % PACK_GROUP:
        raise ValueError(
            f"band blocks ({Nb}) must be a multiple of PACK_GROUP ({PACK_GROUP})"
        )
    Gb = Nb // PACK_GROUP
    GW = group_words

    code = codec.residual_code
    qt, inv_qt = codec.qt, codec.inv_qt
    hot_vals, hot_fused = codec._hot_vals, codec._hot_fused
    esc_code, esc_len = codec._esc_code, codec._esc_len
    lower = jnp.int32(code.lower_bound)
    raw_bits = code.raw_bits
    tile_me = _tile_me(me_backend, H, sr)

    def symbolize(plane):
        x = plane.reshape(band_h // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
        coeffs = dct2_fused(x)
        qsym = jnp.round(coeffs * inv_qt[None, :]).astype(jnp.int32)
        deq = (qsym.astype(jnp.float32) * qt[None, :]).astype(jnp.int32)
        pix = idct2_fused(deq.astype(jnp.float32))
        recon = pix.reshape(band_h // 8, W // 8, 8, 8).transpose(0, 2, 1, 3).reshape(band_h, W)
        return qsym, recon

    def shard_fn(frames_local):
        """frames_local: [gop_len, band_h, W] — one GOP's row band."""
        tile_idx = jax.lax.axis_index("tile").astype(jnp.int32)
        row0 = tile_idx * band_h

        def frame_step(recon_prev, inputs):
            t, y = inputs

            def intra():
                qsym, recon = symbolize(y)
                mv = jnp.full(
                    (band_h // 8, W // 8), (sr * (2 * sr + 1)) + sr, jnp.int32
                )
                return qsym, mv, recon

            def inter():
                ref_ext = exchange_row_halo(recon_prev, sr, "tile")
                mv = tile_me(ref_ext, y, row0)
                pred = motion_compensate_tile_dense(ref_ext, mv, sr)
                qsym, rrec = symbolize(y - pred)
                return qsym, mv, pred + rrec

            qsym, mv, recon = jax.lax.cond(t == 0, intra, inter)
            return recon, (qsym, mv, recon)

        ts = jnp.arange(gop_len, dtype=jnp.int32)
        _, (qsyms, mvs, recons) = jax.lax.scan(
            frame_step, jnp.zeros((band_h, W), jnp.float32), (ts, frames_local)
        )

        # distributed entropy coding: this shard packs its own blocks
        flat = qsyms.reshape(gop_len * Nb, 64)
        buf, valid = zerorun_encode_blocks_dense(flat, 64, EOB, cap)
        codes, lens = map_codes_hot(
            buf - lower, valid, hot_vals, hot_fused, esc_code, esc_len, raw_bits
        )
        words, gbits, offs = pack_grouped_sized(codes, lens, GW, block_words)

        # rebase block offsets: shard-local group index (t*Gb + g) ->
        # frame-relative global group index (tile_idx*Gb + g)
        offs = offs.reshape(gop_len, Nb)
        local_frame_base = (jnp.arange(gop_len, dtype=jnp.int32) * (Gb * GW * 32))[:, None]
        offs = offs - local_frame_base + tile_idx * (Gb * GW * 32)

        words = words.reshape(gop_len, Gb, GW)
        gbits = gbits.reshape(gop_len, Gb)
        totals = jax.lax.psum(jnp.sum(gbits, axis=1), "tile")
        return words, offs, valid.reshape(gop_len, Nb), gbits, totals, mvs, recons

    from jax import shard_map

    sharded = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=P("gop", "tile", None),
        out_specs=(
            P("gop", "tile", None),   # words: groups band-major per frame
            P("gop", "tile"),         # offsets
            P("gop", "tile"),         # counts
            P("gop", "tile"),         # group_bits
            P("gop"),                 # totals (tile-replicated after psum)
            P("gop", "tile", None),   # mvs
            P("gop", "tile", None),   # recons
        ),
        check_vma=False,
    )

    @jax.jit
    def step(frames_y):
        T, Hf, Wf = frames_y.shape
        assert Hf == H and Wf == W and T == n_gop * gop_len
        return ShardedGopStreams(*sharded(frames_y))

    return step


# --------------------------------------------------------------------------
# Sharded PER-FRAME-ADAPTIVE codec (the reference's flagship
# AdaptiveVideoCodec policy, exercises/ch4/E4-1.py:54-171, under the
# (gop, tile) mesh). Unlike the fixed-codebook paths above, every frame
# retrains its residual codebook:
#
#   phase 1 (device, sharded)  halo ME + dense MC + transform/symbolize +
#                              closed-loop recon; per-frame symbol
#                              histograms psum-reduced over the tile axis,
#                              min/max pmin/pmax-reduced
#   host                       bucketed bounds -> smoothed pmf (device ops
#                              identical to the single-device path) ->
#                              canonical tree per frame
#   phase 2 (device, sharded)  every shard Huffman-packs its own blocks
#                              under the broadcast per-frame code tables
#   host 0                     width-sliced gather -> AdaptiveVideoPayload
#                              bytes, byte-identical to the single-device
#                              ``VideoCodec.encode_to_container``
#                              (asserted by tests/test_parallel.py)


class ShardedAdaptiveEncoder:
    """GOP+tile-sharded encoder with per-frame residual codebooks."""

    def __init__(self, mesh, gop_len: int, band_h: int, width: int,
                 quantization_scale: float = 1.0, search_range: int = 4,
                 codebook_policy: str = "per-frame", eob: int = 4000,
                 me_backend: str | None = None):
        from ivclab_tpu.ops.transform import PACK_GROUP

        if codebook_policy not in ("per-frame", "adaptive"):
            raise ValueError("sharded adaptive encoder: policy must be "
                             "'per-frame' or 'adaptive'")
        if band_h % 8 or width % 8:
            raise ValueError("band_h and width must be multiples of 8")
        n_tile = mesh.shape["tile"]
        Nb = (band_h // 8) * (width // 8)
        if Nb % PACK_GROUP:
            raise ValueError(
                f"band blocks ({Nb}) must be a multiple of PACK_GROUP "
                f"({PACK_GROUP}) for byte-identity with the single-device pack"
            )
        self.mesh = mesh
        self.gop_len = int(gop_len)
        self.band_h = int(band_h)
        self.width = int(width)
        self.H = band_h * n_tile
        self.q = float(quantization_scale)
        self.sr = int(search_range)
        self.eob = int(eob)
        self.policy = codebook_policy
        self.me_backend = me_backend
        self._phase1 = self._build_phase1()
        from ivclab_tpu.ops.transform import ADAPTIVE_BW, ADAPTIVE_WPG

        # speculative cap-sized pack (9x cheaper than full stride); the
        # 32-slot capacity variant compiles eagerly (typical content),
        # the 128-slot and full-stride fallbacks lazily on first need
        self._wpg, self._bw = ADAPTIVE_WPG, ADAPTIVE_BW
        self._phase2_cache = {}
        self._phase2_full = None
        self._get_phase2(32)

    # ------------------------------------------------------------ phase 1

    def _build_phase1(self):
        from ivclab_tpu.models.videocodec import _stream_histogram
        from ivclab_tpu.ops.zerorun import BLOCK_CAP, zerorun_encode_blocks_dense

        band_h, W, sr, eob = self.band_h, self.width, self.sr, self.eob
        gop_len = self.gop_len
        qt = jnp.asarray(quant_table_zigzag(self.q, 1)[0])
        inv_qt = 1.0 / qt
        tile_me = _tile_me(self.me_backend, self.H, sr)

        def symbolize(plane):
            x = plane.reshape(band_h // 8, 8, W // 8, 8).transpose(0, 2, 1, 3).reshape(-1, 64)
            coeffs = dct2_fused(x)
            qsym = jnp.round(coeffs * inv_qt[None, :]).astype(jnp.int32)
            buf, valid = zerorun_encode_blocks_dense(qsym, 64, eob, BLOCK_CAP)
            deq = (qsym.astype(jnp.float32) * qt[None, :]).astype(jnp.int32)
            pix = idct2_fused(deq.astype(jnp.float32))
            recon = pix.reshape(band_h // 8, W // 8, 8, 8).transpose(0, 2, 1, 3).reshape(band_h, W)
            return buf, valid, recon

        def shard_fn(frames_local):
            tile_idx = jax.lax.axis_index("tile").astype(jnp.int32)
            row0 = tile_idx * band_h

            def frame_step(recon_prev, inputs):
                t, y = inputs

                def intra():
                    buf, valid, recon = symbolize(y)
                    mv = jnp.zeros((band_h // 8, W // 8), jnp.int32)
                    return buf, valid, mv, recon

                def inter():
                    ref_ext = exchange_row_halo(recon_prev, sr, "tile")
                    mv = tile_me(ref_ext, y, row0)
                    from ivclab_tpu.parallel.halo import motion_compensate_tile_dense

                    pred = motion_compensate_tile_dense(ref_ext, mv, sr)
                    buf, valid, rrec = symbolize(y - pred)
                    return buf, valid, mv, pred + rrec

                buf, valid, mv, recon = jax.lax.cond(t == 0, intra, inter)
                mn, mx, hist = _stream_histogram(buf, valid, eob)
                mn = jax.lax.pmin(mn, "tile")
                mx = jax.lax.pmax(mx, "tile")
                hist = jax.lax.psum(hist, "tile")
                vmax = jax.lax.pmax(jnp.max(valid), "tile")
                return recon, (buf, valid, mn, mx, hist, mv, recon, vmax)

            ts = jnp.arange(gop_len, dtype=jnp.int32)
            _, outs = jax.lax.scan(
                frame_step, jnp.zeros((band_h, W), jnp.float32), (ts, frames_local)
            )
            return outs

        from jax import shard_map

        sharded = shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=P("gop", "tile", None),
            out_specs=(
                P("gop", "tile", None),  # buf [T, Nb, cap]
                P("gop", "tile"),        # valid [T, Nb]
                P("gop"),                # mn [T] (tile-reduced)
                P("gop"),                # mx [T]
                P("gop", None),          # hist [T, nbins] (tile-reduced)
                P("gop", "tile", None),  # mv [T, hb, wb]
                P("gop", "tile", None),  # recons [T, band, W]
                P("gop"),                # vmax [T] (tile-reduced)
            ),
            check_vma=False,
        )
        return jax.jit(sharded)

    # ------------------------------------------------------------ phase 2

    def _get_phase2(self, cap: int):
        """Phase-2 program for a symbol-capacity slice (compiled lazily)."""
        if cap not in self._phase2_cache:
            self._phase2_cache[cap] = self._build_phase2(self._wpg, self._bw, cap)
        return self._phase2_cache[cap]

    def _build_phase2(self, wpg: int, bw: int | None, cap: int | None = None):
        from ivclab_tpu.ops.bitpack import (
            pack_codes_grouped_dense, pack_codes_grouped_dense2,
        )
        from ivclab_tpu.ops.transform import PACK_GROUP

        def pack_frame(buf_t, valid_t, codes_t, lens_t, lower_t):
            # inlined pack_symbols_grouped with TRACED per-frame tables
            # (the wrapper's static lower_bound would retrace per frame);
            # the clip bound differs from the exact-alphabet call only for
            # out-of-range symbols, which the per-frame code excludes.
            # The capacity slice shrinks the code-table gathers (the pack's
            # dominant cost); slots past every block's
            # count are masked, so any adequate slice packs identically.
            if cap is not None:
                buf_t = buf_t[:, :cap]
            pos = jnp.arange(buf_t.shape[1], dtype=jnp.int32)
            mask = pos[None, :] < valid_t[:, None]
            idx = jnp.clip(buf_t - lower_t, 0, lens_t.shape[0] - 1)
            lens = jnp.where(mask, lens_t[idx], 0)
            codes = jnp.where(mask, codes_t[idx], 0)
            if bw is None:  # full-stride fallback (worst-case block buffer)
                words, gbits, boffs = pack_codes_grouped_dense(
                    codes, lens, PACK_GROUP, wpg
                )
            else:
                words, gbits, boffs = pack_codes_grouped_dense2(
                    codes, lens, PACK_GROUP, wpg, bw
                )
            G = boffs.shape[0] // PACK_GROUP
            base = (jnp.arange(G, dtype=jnp.int32) * (wpg * 32))
            in_group = boffs - jnp.repeat(base, PACK_GROUP)
            return words, gbits, in_group

        def shard_fn(buf, valid, codes, lens, lowers):
            return jax.vmap(pack_frame)(buf, valid, codes, lens, lowers)

        from jax import shard_map

        sharded = shard_map(
            shard_fn,
            mesh=self.mesh,
            in_specs=(
                P("gop", "tile", None),  # buf
                P("gop", "tile"),        # valid
                P("gop", None),          # per-frame padded code words
                P("gop", None),          # per-frame padded lengths
                P("gop"),                # per-frame lower bounds
            ),
            out_specs=(
                P("gop", "tile", None),  # words [T, Gb, GROUP_WORDS]
                P("gop", "tile"),        # gbits [T, Gb]
                P("gop", "tile"),        # in-group offsets [T, Nb]
            ),
            check_vma=False,
        )
        return jax.jit(sharded)

    # ------------------------------------------------------------ encode

    @staticmethod
    def _in_group_ok(gbits_np, in_group_np, wpg: int, bw: int) -> bool:
        """Speculative-bucket adequacy — the single-device checker applied
        to the gathered (exact) sidecar outputs, so the sharded and
        single-device overflow-fallback decisions can never diverge."""
        import numpy as np

        from ivclab_tpu.models.videocodec import _sized_buckets_ok

        return _sized_buckets_ok(
            np.asarray(gbits_np).reshape(-1),
            np.asarray(in_group_np).reshape(-1),
            wpg, bw,
        )

    def encode(self, frames_y) -> list:
        """``[n_gop * gop_len, H, W]`` float32 -> one AdaptiveVideoPayload
        ``bytes`` per GOP, byte-identical to the single-device
        ``VideoCodec.encode_to_container`` on the same frames."""
        import numpy as np

        from ivclab_tpu.entropy.huffman import HuffmanCoder
        from ivclab_tpu.entropy.stats import smooth_pmf
        from ivclab_tpu.models.intracodec import bucket_bounds
        from ivclab_tpu.models.videocodec import (
            _HIST_LO, _HIST_HI, _pack_flat_section,
        )
        from ivclab_tpu.ops.transform import GROUP_WORDS, PACK_GROUP
        from ivclab_tpu.runtime.container import (
            AdaptiveVideoPayload, Codebook, GroupedSection, packer_wmax,
        )

        mesh = self.mesh
        n_gop = mesh.shape["gop"]
        gop_len, H, W = self.gop_len, self.H, self.width
        frames_y = jax.device_put(
            jnp.asarray(frames_y, jnp.float32),
            NamedSharding(mesh, P("gop", "tile", None)),
        )
        T = frames_y.shape[0]
        assert T == n_gop * gop_len and frames_y.shape[1:] == (H, W)

        buf, valid, mn, mx, hist, mvs, recons, vmax = self._phase1(frames_y)
        stats = jax.device_get((mn, mx, hist, vmax))
        mn_np, mx_np, hist_np, vmax_np = stats

        # host tree builds (device pmf ops identical to the single-device
        # path -> identical canonical codes)
        from ivclab_tpu.ops.transform import symbol_histogram

        pmf_pend = []
        for t in range(T):
            lo, hi = bucket_bounds(int(mn_np[t]), int(mx_np[t]))
            if _HIST_LO <= lo and hi <= _HIST_HI:
                h = jnp.asarray(hist_np[t, lo - _HIST_LO : hi - _HIST_LO])
            else:  # pathological bounds: exact fallback, like the
                # single-device encoder (keeps the byte-identity contract)
                h = symbol_histogram(buf[t], valid[t], lo, hi)
            pmf_pend.append((lo, smooth_pmf(h.astype(jnp.float32) / jnp.sum(h))))
        pmfs = jax.device_get([p for _, p in pmf_pend])
        codes_list = []
        for (lo, _), pmf_np in zip(pmf_pend, pmfs):
            coder = HuffmanCoder(lower_bound=lo).train(np.asarray(pmf_np, np.float64))
            codes_list.append(coder.code)

        a_max = max(c.n for c in codes_list)
        codes_pad = np.zeros((T, a_max), dtype=np.uint32)
        lens_pad = np.zeros((T, a_max), dtype=np.int32)
        lowers = np.zeros(T, dtype=np.int32)
        for t, c in enumerate(codes_list):
            codes_pad[t, : c.n] = c.codes
            lens_pad[t, : c.n] = c.lengths
            lowers[t] = c.lower_bound

        tables = (jnp.asarray(codes_pad), jnp.asarray(lens_pad), jnp.asarray(lowers))
        from ivclab_tpu.ops.zerorun import BLOCK_CAP as _BC
        from ivclab_tpu.ops.transform import cap_slice

        cap = cap_slice(int(np.max(vmax_np)), _BC)
        words, gbits, in_group = self._get_phase2(cap)(buf, valid, *tables)
        gbits_np, offs_np, valid_np, mvs_np = jax.device_get(
            (gbits, in_group, valid, mvs)
        )
        stride = self._wpg
        if not self._in_group_ok(gbits_np, offs_np, self._wpg, self._bw):
            # content overflowed the speculative buckets: full-stride re-pack
            if self._phase2_full is None:
                self._phase2_full = self._build_phase2(GROUP_WORDS, None)
            words, gbits, in_group = self._phase2_full(buf, valid, *tables)
            gbits_np, offs_np = jax.device_get((gbits, in_group))
            stride = GROUP_WORDS
        wmaxes = [packer_wmax(gbits_np[t], stride) for t in range(T)]
        words_np = jax.device_get([words[t, :, : wmaxes[t]] for t in range(T)])

        # MV codebook: uniform pmf trained once (reference parity)
        n_mv = (2 * self.sr + 1) ** 2
        mv_coder = HuffmanCoder(lower_bound=0).train(np.full(n_mv, 1.0 / n_mv))
        mv_code = mv_coder.code
        mv_cb = Codebook(0, np.asarray(mv_code.lengths, dtype=np.uint8))

        payloads = []
        for g in range(n_gop):
            sl = range(g * gop_len, (g + 1) * gop_len)
            frame_sections = []
            frame_bits = np.zeros(gop_len, dtype=np.uint64)
            for i, t in enumerate(sl):
                code = codes_list[t]
                section = GroupedSection(
                    words=np.asarray(words_np[t]),
                    group_word_counts=(
                        (gbits_np[t].astype(np.int64) + 31) // 32
                    ).astype(np.uint32),
                    block_offsets=offs_np[t].astype(np.uint16),
                    block_counts=valid_np[t].astype(np.uint8),
                    group_size=PACK_GROUP,
                    words_per_group=wmaxes[t],
                )
                frame_sections.append(
                    (Codebook(code.lower_bound,
                              np.asarray(code.lengths, dtype=np.uint8)), section)
                )
                bits = int(gbits_np[t].astype(np.int64).sum())
                if i > 0:
                    bits += int(
                        np.sum(np.asarray(mv_code.lengths)[mvs_np[t].reshape(-1)])
                    )
                    if self.policy == "adaptive":
                        bits += 8 * ((8 + code.n) + 12)
                frame_bits[i] = bits
            gop_mvs = mvs_np[g * gop_len + 1 : (g + 1) * gop_len]
            mv_flat = (
                gop_mvs.reshape(-1).astype(np.int32)
                if gop_mvs.size else np.zeros(0, dtype=np.int32)
            )
            mv_section, _ = _pack_flat_section(mv_flat, mv_code)
            payloads.append(AdaptiveVideoPayload(
                quantization_scale=self.q,
                eob=self.eob,
                search_range=self.sr,
                policy=1 if self.policy == "adaptive" else 0,
                shape=(gop_len, H, W),
                payload_bits=int(frame_bits.sum()),
                frame_bits=frame_bits,
                mv_codebook=mv_cb,
                mv=mv_section,
                frames=frame_sections,
            ).to_bytes())
        return payloads


def assemble_video_payloads(codec, streams: ShardedGopStreams, gop_len: int) -> list:
    """Host-0 bitstream assembly: gathered shard streams -> IVC1 payloads.

    The distributed-assembly step of SURVEY.md §7.6: per-group payload bit
    counts (all-gathered by the step's out_specs) become word counts, a
    prefix layout over them compacts the word-aligned substreams, and the
    result serializes through the same :class:`VideoPayload` writer as the
    single-device encoder — one self-contained ``bytes`` per GOP, decodable
    anywhere via ``FusedVideoCodec.decode_from_container``.
    """
    from ivclab_tpu.models.fastvideo import PackedGop

    words, offsets, counts, group_bits, totals, mvs = jax.device_get(
        (streams.words, streams.offsets, streams.counts,
         streams.group_bits, streams.totals, streams.mvs)
    )
    T = words.shape[0]
    H = streams.recons.shape[1]
    W = streams.recons.shape[2]
    n_gops = T // gop_len
    bw = None  # recovered by the decoder from the sidecar
    payloads = []
    for g in range(n_gops):
        sl = slice(g * gop_len, (g + 1) * gop_len)
        p = PackedGop(
            words=jnp.asarray(words[sl]),
            totals=jnp.asarray(totals[sl]),
            offsets=jnp.asarray(offsets[sl]),
            counts=jnp.asarray(counts[sl]),
            group_bits=jnp.asarray(group_bits[sl]),
            block_words=bw,
            cap=int(counts[sl].max(initial=1)),
        )
        payloads.append(
            codec.container_from_packed(p, jnp.asarray(mvs[sl]), (gop_len, H, W))
        )
    return payloads
