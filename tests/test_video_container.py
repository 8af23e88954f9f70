"""Video bitstream container: file round-trips decode bit-for-bit.

The reference's video decoder reads motion vectors and symbol counts from
encoder state (``ivclab/video/videocodec.py:57-86``); these tests prove the
IVC1 video payload is self-contained — a fresh codec reconstructs the GOP
from bytes alone, bit-identically to the encoder's own reconstruction.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from ivclab_tpu.models.fastvideo import FusedVideoCodec
from ivclab_tpu.runtime.container import VideoPayload
from ivclab_tpu.utils import fixtures


@pytest.fixture(scope="module")
def small_video():
    frames = fixtures.video("container", num_frames=4, shape=(96, 128))
    return np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))


@pytest.fixture(scope="module")
def trained_codec(small_video):
    return FusedVideoCodec(quantization_scale=1.0).train(small_video[:2])


def test_container_roundtrip_bit_exact(small_video, trained_codec):
    enc_recons, bits, ok, _ = trained_codec.encode_decode_gop(small_video)
    assert bool(ok)
    blob = trained_codec.encode_to_container(small_video)
    # a FRESH codec, from bytes alone
    recons, ok2 = FusedVideoCodec.decode_from_container(blob)
    assert bool(ok2)
    np.testing.assert_array_equal(np.asarray(recons), np.asarray(enc_recons))


def test_container_fields(small_video, trained_codec):
    blob = trained_codec.encode_to_container(small_video)
    p = VideoPayload.from_bytes(blob)
    T, H, W = p.shape
    assert (T, H, W) == small_video.shape
    assert p.quantization_scale == pytest.approx(1.0)
    assert p.search_range == 4
    assert p.payload_bits > 0
    assert p.frame_bits.sum() <= p.payload_bits  # MV bits on top of residual
    assert p.frame_bits[0] > p.frame_bits[1:].min()  # I-frame is the big one
    assert p.container_bytes == len(blob)


def test_container_rate_accounting(small_video, trained_codec):
    """payload_bits equals the in-memory pipeline's exact rate."""
    import jax.numpy as jnp

    y = jnp.asarray(small_video)
    qsyms, mvs, mv_bits, _ = trained_codec.encode_gop(y)
    packed = trained_codec.pack_gop(qsyms)
    blob = trained_codec.encode_to_container(small_video)
    p = VideoPayload.from_bytes(blob)
    np.testing.assert_array_equal(
        p.frame_bits, np.asarray(packed.totals, dtype=np.uint64)
    )
    # container MV rate == encoder's mv-length accounting
    assert p.payload_bits - int(p.frame_bits.sum()) == int(np.asarray(mv_bits).sum())


def test_container_rejects_corruption(small_video, trained_codec):
    blob = bytearray(trained_codec.encode_to_container(small_video))
    blob[0] ^= 0xFF
    with pytest.raises(ValueError):
        VideoPayload.from_bytes(bytes(blob))


def test_cli_video_roundtrip(tmp_path, small_video):
    from ivclab_tpu import cli

    out = tmp_path / "seq.ivc"
    dec = tmp_path / "recon.npy"
    cli.main([
        "encode-video", "fixture:container", str(out),
        "--q", "1.0", "--frames", "4",
    ])
    assert out.exists() and out.stat().st_size > 0
    cli.main(["decode-video", str(out), str(dec)])
    recon = np.load(dec)
    assert recon.shape[0] == 4
    # CLI codes the BT.601 luma of the RGB fixture
    from ivclab_tpu.ops.color import rgb2ycbcr

    frames = fixtures.video("container", num_frames=4)
    yq = np.asarray(rgb2ycbcr(frames.astype(np.float32)))[..., 0]
    psnr = 10 * np.log10(255.0**2 / np.mean((recon.astype(np.float64) - yq) ** 2))
    assert psnr > 28.0


def test_cli_info_video(tmp_path, capsys):
    from ivclab_tpu import cli

    out = tmp_path / "seq.ivc"
    cli.main(["encode-video", "fixture:container", str(out), "--frames", "4"])
    capsys.readouterr()
    cli.main(["info", str(out)])
    report = json.loads(capsys.readouterr().out)
    assert report["kind"] == "video-stream"
    gop = report["gops"][0]
    assert len(gop["per_frame_bits"]) == 4
    assert gop["payload_bits"] >= sum(gop["per_frame_bits"])


# ---------------------------------------------------------------- adaptive
# Per-frame-codebook wire format: the reference ships
# adaptive codebooks as encoder-side pickles (exercises/ch4/E4-1.py:240-334);
# here they serialize into the stream and a FRESH process decodes from
# bytes alone.


@pytest.fixture(scope="module")
def rgb_video():
    return fixtures.video("container", num_frames=4, shape=(96, 128))


@pytest.mark.parametrize("policy", ["adaptive", "per-frame"])
def test_adaptive_container_bit_exact_and_rate_parity(rgb_video, policy):
    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.ops.color import rgb2ycbcr
    from ivclab_tpu.runtime.container import AdaptiveVideoPayload

    y = np.asarray(rgb2ycbcr(rgb_video.astype(np.float32)))[..., 0]
    enc = VideoCodec(quantization_scale=1.0, codebook_policy=policy)
    blob = enc.encode_to_container(y)

    # a fresh codec, from bytes alone
    dec = VideoCodec.decode_from_container(blob)

    # the facade's in-memory recursion (reference-parity path)
    facade = VideoCodec(quantization_scale=1.0, codebook_policy=policy)
    fac_recons, fac_bits = [], []
    for t in range(rgb_video.shape[0]):
        facade.encode_decode(rgb_video[t], frame_num=t)
        fac_recons.append(np.asarray(facade.decoder_recon))
        fac_bits.append(0)
    np.testing.assert_array_equal(dec, np.stack(fac_recons))

    p = AdaptiveVideoPayload.from_bytes(blob)
    assert p.policy == (1 if policy == "adaptive" else 0)
    assert p.shape == y.shape
    assert len(p.frames) == y.shape[0]
    assert p.container_bytes == len(blob)


def test_adaptive_container_rate_matches_facade(rgb_video):
    """frame_bits reproduce the facade's exact per-frame rate accounting
    (residual + MV code lengths + the adaptive codebook charge)."""
    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.ops.color import rgb2ycbcr
    from ivclab_tpu.runtime.container import AdaptiveVideoPayload

    y = np.asarray(rgb2ycbcr(rgb_video.astype(np.float32)))[..., 0]
    for policy in ("adaptive", "per-frame"):
        blob = VideoCodec(
            quantization_scale=1.0, codebook_policy=policy
        ).encode_to_container(y)
        p = AdaptiveVideoPayload.from_bytes(blob)
        facade = VideoCodec(quantization_scale=1.0, codebook_policy=policy)
        fac_bits = [
            facade.encode_decode(rgb_video[t], frame_num=t)[2]
            for t in range(rgb_video.shape[0])
        ]
        assert [int(b) for b in p.frame_bits] == fac_bits


def test_adaptive_container_rejects_corruption(rgb_video):
    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.ops.color import rgb2ycbcr
    from ivclab_tpu.runtime.container import AdaptiveVideoPayload

    y = np.asarray(rgb2ycbcr(rgb_video.astype(np.float32)))[..., 0]
    blob = bytearray(
        VideoCodec(quantization_scale=1.0, codebook_policy="adaptive")
        .encode_to_container(y)
    )
    blob[0] ^= 0xFF  # magic
    with pytest.raises(ValueError):
        AdaptiveVideoPayload.from_bytes(bytes(blob))


def test_adaptive_container_rejects_first_p_frame_policy(rgb_video):
    from ivclab_tpu.models.videocodec import VideoCodec

    vc = VideoCodec(codebook_policy="first-p-frame")
    with pytest.raises(ValueError, match="per-frame codebooks"):
        vc.encode_to_container(np.zeros((2, 16, 16), np.float32))


def test_cli_adaptive_video_roundtrip(tmp_path, rgb_video, capsys):
    import json as _json

    from ivclab_tpu import cli
    from ivclab_tpu.ops.color import rgb2ycbcr

    out = tmp_path / "seq_adaptive.ivc"
    dec = tmp_path / "recon.npy"
    cli.main([
        "encode-video", "fixture:container", str(out),
        "--q", "1.0", "--frames", "4", "--codebook-policy", "adaptive",
    ])
    capsys.readouterr()
    cli.main(["decode-video", str(out), str(dec)])
    capsys.readouterr()
    recon = np.load(dec)
    frames = fixtures.video("container", num_frames=4)
    yq = np.asarray(rgb2ycbcr(frames.astype(np.float32)))[..., 0]
    psnr = 10 * np.log10(255.0**2 / np.mean((recon.astype(np.float64) - yq) ** 2))
    assert psnr > 28.0
    cli.main(["info", str(out)])
    report = _json.loads(capsys.readouterr().out)
    gop = report["gops"][0]
    assert gop["kind"] == "video-gop-adaptive"
    assert gop["policy"] == "adaptive"
    assert len(gop["per_frame_codebook_symbols"]) == 4


# -------------------------------------------------------------- frame blobs
# The facade's per-frame bitstream: every encode_decode
# call returns a blob decodable with only the previous reconstruction.


@pytest.mark.parametrize("policy", ["first-p-frame", "per-frame", "adaptive"])
def test_facade_frame_blobs_decode_without_encoder_state(rgb_video, policy):
    from ivclab_tpu.models.videocodec import VideoCodec

    enc = VideoCodec(quantization_scale=1.0, codebook_policy=policy)
    recon_prev = None
    for t in range(3):
        _, blob, bits = enc.encode_decode(rgb_video[t], frame_num=t)
        assert isinstance(blob, bytes) and bits > 0
        dec = VideoCodec.decode_frame_payload(blob, recon_prev)
        np.testing.assert_array_equal(dec, np.asarray(enc.decoder_recon))
        recon_prev = dec


def test_pframe_blob_requires_reference(rgb_video):
    from ivclab_tpu.models.videocodec import VideoCodec

    enc = VideoCodec(quantization_scale=1.0)
    enc.encode_decode(rgb_video[0], frame_num=0)
    _, blob, _ = enc.encode_decode(rgb_video[1], frame_num=1)
    with pytest.raises(ValueError, match="previous reconstruction"):
        VideoCodec.decode_frame_payload(blob)


def test_pack_gop_deferred_check_and_repack(small_video):
    """check=False packs with zero host syncs, carrying bucket adequacy as
    a device bool; a violation (content outgrew the sticky buckets) reads
    False and ``repack_gop`` recovers with identical streams."""
    import jax.numpy as jnp

    codec = FusedVideoCodec(quantization_scale=1.0).train(small_video[:2])
    y = jnp.asarray(small_video)
    qsyms, mvs, _, _ = codec.encode_gop(y)
    ref = codec.pack_gop(qsyms)             # picks + validates the buckets
    p = codec.pack_gop(qsyms, check=False)  # sticky speculative path
    assert p.ok is not None and bool(p.ok)
    np.testing.assert_array_equal(np.asarray(p.words), np.asarray(ref.words))
    np.testing.assert_array_equal(np.asarray(p.totals), np.asarray(ref.totals))

    # force a violation: shrink the sticky buckets below the content
    cap, bw, gw = codec._buckets
    from ivclab_tpu.models.fastvideo import GW_BUCKETS
    if GW_BUCKETS.index(gw) > 0:
        codec._buckets = (cap, bw, GW_BUCKETS[GW_BUCKETS.index(gw) - 1])
        bad = codec.pack_gop(qsyms, check=False)
        assert not bool(bad.ok)
        fixed = codec.repack_gop(qsyms)
        np.testing.assert_array_equal(np.asarray(fixed.words), np.asarray(ref.words))
    # check=True self-heals from the same violation
    codec._buckets = (cap, bw, GW_BUCKETS[0])
    healed = codec.pack_gop(qsyms)
    np.testing.assert_array_equal(np.asarray(healed.words), np.asarray(ref.words))


def test_adaptive_sized_pack_fallback_byte_identical(rgb_video, monkeypatch):
    """The adaptive paths pack speculatively with small cap-sized buckets
    and fall back to the full-stride packer when content overflows
    (validated exactly from the sidecar). Shrinking the buckets to force
    the fallback must not change a single byte."""
    import ivclab_tpu.ops.transform as tf
    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.ops.color import rgb2ycbcr

    y = np.asarray(rgb2ycbcr(rgb_video.astype(np.float32)))[..., 0]
    want = VideoCodec(quantization_scale=1.0, codebook_policy="per-frame").encode_to_container(y)

    monkeypatch.setattr(tf, "ADAPTIVE_WPG", 8)  # guaranteed overflow
    monkeypatch.setattr(tf, "ADAPTIVE_BW", 2)
    got = VideoCodec(quantization_scale=1.0, codebook_policy="per-frame").encode_to_container(y)
    assert got == want

    # facade per-frame blobs go through _pack_section's fallback too
    rgb0 = rgb_video[0]
    c1 = VideoCodec(quantization_scale=1.0)
    c1.encode_decode(rgb0, frame_num=0)
    _, blob_small, _ = c1.encode_decode(rgb_video[1], frame_num=1)
    monkeypatch.undo()
    c2 = VideoCodec(quantization_scale=1.0)
    c2.encode_decode(rgb0, frame_num=0)
    _, blob_full, _ = c2.encode_decode(rgb_video[1], frame_num=1)
    assert blob_small == blob_full


def test_adaptive_decode_return_device(rgb_video):
    """return_device=True skips the host fetch and matches the host path."""
    import jax

    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.ops.color import rgb2ycbcr

    y = np.asarray(rgb2ycbcr(rgb_video.astype(np.float32)))[..., 0]
    blob = VideoCodec(quantization_scale=1.0, codebook_policy="per-frame").encode_to_container(y)
    host = VideoCodec.decode_from_container(blob)
    dev, oks = VideoCodec.decode_from_container(blob, return_device=True)
    assert all(bool(o) for o in jax.device_get(oks))
    assert np.array_equal(np.asarray(dev), host)
