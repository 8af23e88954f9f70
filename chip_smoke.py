"""Bring-up check: the codec's main path on one GPU, at 1080p.

Runs every phase in this one process (a JAX process reserves most of the
card's memory, so nothing here starts a second one on the card):

  device          platform, device kind, count, JAX version, card name
                  and power limit; the C++ entropy engine is built
  me-kernel       the Pallas motion-search kernel compiled at 1088x1920
                  (frame and 544-row band forms) against the XLA scan
  fused-1080p     FusedVideoCodec train -> encode_gop -> pack_gop ->
                  container bytes -> decode_from_container
  adaptive-1080p  VideoCodec(per-frame) encode_to_container ->
                  decode_from_container
  cli             ``ivclab_tpu.cli.main`` encode-video / decode-video, both
                  codebook policies
  intra-chroma    IntraCodec and yuv420compression on lena, against
                  values computed by the same code on the CPU

``--four-cards`` runs only the sharded 1080p encode over a 2 (gop) x 2
(tile) mesh of four GPUs, against the single-device encode of each GOP.

Each phase prints one JSON line; any failure raises and the process exits
non-zero. The last line is ``{"ok": true, "device": {...}}``. There is no
CPU path: without a GPU the script fails before the first phase.

Usage: ``python3 chip_smoke.py [--four-cards]``
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

H, W, FRAMES, Q, SR = 1088, 1920, 8, 1.0, 4
BAND_H = 544
ME_REPS = 21

# The 1080p operating point of the repo's benchmark (device independent)
FUSED_PSNR_Y, FUSED_BPP = 31.17, 0.5566
PSNR_TOL_DB, BPP_REL_TOL = 0.1, 0.01
# IntraCodec(0.15) trained on lena_small, container round trip on lena, and
# yuv420compression(lena), computed by this code on the CPU (float32)
INTRA_PSNR_CPU, INTRA_BPP_CPU = 38.93010711669922, 4.510734558105469
YUV420_PSNR_CPU = 37.45833969116211
CPU_TOL_DB = 0.05
# near-tie tolerance for ME on float reconstructions (see me_agreement)
ME_MIN_IDENTICAL, ME_SSD_RTOL = 0.999, 1e-5

SINGLE_CARD_PHASES = ("device", "me-kernel", "fused-1080p", "adaptive-1080p", "cli",
                      "intra-chroma")
FOUR_CARD_PHASES = ("four-cards",)


def select_phases(four_cards: bool) -> tuple[str, ...]:
    return FOUR_CARD_PHASES if four_cards else SINGLE_CARD_PHASES


def last_line(devices) -> str:
    """The final stdout line: ok flag and the device as JAX reports it."""
    d = devices[0]
    return json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)},
    })


def require_gpu(devices) -> None:
    if not devices or any(d.platform != "gpu" for d in devices):
        raise SystemExit(f"chip_smoke needs GPU devices, JAX reports {devices}")


def card_info() -> str:
    """``name, power.limit`` of every card, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


class CompileClock:
    """Seconds spent in backend compiles (persistent-cache reads included)."""

    def __init__(self):
        import jax

        self.seconds, self.cache_hits = 0.0, 0

        def on_duration(name, secs, **_):
            if name == "/jax/core/compile/backend_compile_duration":
                self.seconds += secs

        def on_event(name, **_):
            if name == "/jax/compilation_cache/cache_hits":
                self.cache_hits += 1

        jax.monitoring.register_event_duration_secs_listener(on_duration)
        jax.monitoring.register_event_listener(on_event)


def _emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def _timed(fn):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _median_ms(samples) -> float:
    return float(np.median(samples) * 1000)


def psnr_y(ref, rec) -> float:
    """Mean over frames of per-frame PSNR (the benchmark's PSNR-Y)."""
    mse = np.mean((np.asarray(rec, np.float64) - ref) ** 2, axis=(1, 2))
    return float(np.mean(20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))))


def bench_luma(frames: int = FRAMES) -> np.ndarray:
    """The benchmark sequence reduced to luma exactly as ``bench.py`` does."""
    from ivclab_tpu.utils import fixtures

    rgb = fixtures.video("bench", num_frames=frames, shape=(H, W))
    return np.ascontiguousarray(rgb.astype(np.float32).mean(axis=-1))


def block_ssd(ref, cur, mv, rows, cols, sr: int, block: int = 8) -> np.ndarray:
    """float64 SSD of blocks ``(rows[k], cols[k])`` at their packed candidate."""
    ref = np.pad(np.asarray(ref, np.float64), sr)
    cur = np.asarray(cur, np.float64)
    out = np.empty(len(rows))
    for k, (i, j) in enumerate(zip(rows, cols)):
        dy, dx = divmod(int(mv[i, j]), 2 * sr + 1)
        y0, x0 = i * block, j * block
        win = ref[y0 + dy : y0 + dy + block, x0 + dx : x0 + dx + block]
        out[k] = np.sum((cur[y0 : y0 + block, x0 : x0 + block] - win) ** 2)
    return out


def me_agreement(ref, cur, mv_kernel, mv_scan, sr: int) -> dict:
    """Blocks where kernel and scan agree; the rest must be near-ties.

    On float inputs the two sum each 8x8 SSD in a different order, so a
    block whose best candidates tie to the last bits may pick either; the
    MV travels in the bitstream, so the decoder follows whichever it is.
    """
    rows, cols = np.nonzero(mv_kernel != mv_scan)
    worst = 0.0
    if rows.size:
        sk = block_ssd(ref, cur, mv_kernel, rows, cols, sr)
        ss = block_ssd(ref, cur, mv_scan, rows, cols, sr)
        worst = float(np.max(np.abs(sk - ss) / np.maximum(ss, 1.0)))
    return {"blocks": int(mv_scan.size), "differ": int(rows.size), "worst_rel_ssd_gap": worst}


# ---------------------------------------------------------------- phases


def phase_device(ctx) -> dict:
    import jax

    from ivclab_tpu.runtime import native

    if not native.available():
        raise RuntimeError("the C++ entropy engine did not build")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind, "count": len(jax.devices()),
            "jax": jax.__version__, "compile_cache": ctx["cache_dir"]}


def phase_me_kernel(ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from ivclab_tpu.ops.motion import motion_search
    from ivclab_tpu.ops.motion_pallas import motion_search_pallas, motion_search_tile_pallas
    from ivclab_tpu.parallel.halo import motion_search_tile

    y = bench_luma(2)
    # integer-valued frames: every 8x8 SSD < 2^24, exact in any sum order
    ref, cur = (jnp.asarray(np.round(p)) for p in y)

    kernel = jax.jit(lambda r, c: motion_search_pallas(r, c, SR))
    scan = jax.jit(lambda r, c: motion_search(r, c, SR))
    compiled = kernel.lower(ref, cur).compile()
    mem = compiled.memory_analysis()
    mv_k = np.asarray(compiled(ref, cur))
    mv_s = np.asarray(scan(ref, cur))
    if not np.array_equal(mv_k, mv_s):
        raise AssertionError(f"kernel != scan on integer frames: {(mv_k != mv_s).sum()} blocks")

    # the row-band form: 544-row bands of the same frames with +/-SR halos
    ref_np, cur_np = np.asarray(ref), np.asarray(cur)
    tile_k = jax.jit(lambda e, c, r0: motion_search_tile_pallas(e, c, r0, H, SR))
    tile_s = jax.jit(lambda e, c, r0: motion_search_tile(e, c, r0, H, SR))
    for lo in range(0, H, BAND_H):
        ext = np.zeros((BAND_H + 2 * SR, W), np.float32)
        top, bot = max(lo - SR, 0), min(lo + BAND_H + SR, H)
        ext[top - (lo - SR) : bot - (lo - SR)] = ref_np[top:bot]
        args = (jnp.asarray(ext), jnp.asarray(cur_np[lo : lo + BAND_H]), jnp.int32(lo))
        a, b = np.asarray(tile_k(*args)), np.asarray(tile_s(*args))
        if not np.array_equal(a, b):
            raise AssertionError(f"tile kernel != tile scan on band at row {lo}")
        if not np.array_equal(a, mv_s[lo // 8 : (lo + BAND_H) // 8]):
            raise AssertionError(f"tile kernel != frame search on band at row {lo}")

    times = {"kernel": [], "scan": []}
    for _ in range(ME_REPS):  # alternate, so drift hits both alike
        for name, fn in (("kernel", compiled), ("scan", scan)):
            times[name].append(_timed(lambda: fn(ref, cur))[1])
    return {
        "shape": [H, W], "search_range": SR, "integer_frames_identical": True,
        "band_rows": BAND_H, "bands_identical": True,
        "memory_analysis": str(mem),
        "warm_calls": ME_REPS,
        "kernel_median_ms": _median_ms(times["kernel"]),
        "scan_median_ms": _median_ms(times["scan"]),
    }


def phase_fused(ctx) -> dict:
    import jax

    from ivclab_tpu.models.fastvideo import FusedVideoCodec
    from ivclab_tpu.ops.motion import motion_search
    from ivclab_tpu.ops.motion_pallas import motion_search_pallas

    y = bench_luma()
    dev_y = jax.device_put(y)

    def roundtrip(codec):
        qsyms, mvs, mv_bits, enc_recons = codec.encode_gop(dev_y)
        p = codec.pack_gop(qsyms)
        blob = codec.container_from_packed(p, mvs, y.shape)
        recons, ok = FusedVideoCodec.decode_from_container(blob)
        return blob, recons, ok, enc_recons, p.totals + mv_bits

    t0 = time.perf_counter()
    codec = FusedVideoCodec(quantization_scale=Q).train(y[:2])
    blob, recons, ok, enc_recons, bits = jax.block_until_ready(roundtrip(codec))
    cold = time.perf_counter() - t0
    if not bool(ok):
        raise AssertionError("fused entropy decode failed")
    err = float(np.abs(np.asarray(recons) - np.asarray(enc_recons)).max())
    if err >= 1e-2:
        raise AssertionError(f"fused decode != encoder reconstruction: {err}")
    psnr = psnr_y(y, recons)
    bpp = float(np.mean(np.asarray(bits))) / (H * W)
    if abs(psnr - FUSED_PSNR_Y) > PSNR_TOL_DB or abs(bpp / FUSED_BPP - 1) > BPP_REL_TOL:
        raise AssertionError(f"operating point moved: {psnr} dB, {bpp} bpp")

    # ME on the codec's own float inputs: reconstruction t-1 against frame t
    rec_np = np.asarray(enc_recons)
    agree = {"blocks": 0, "differ": 0, "worst_rel_ssd_gap": 0.0}
    for t in range(1, FRAMES):
        a = np.asarray(motion_search_pallas(rec_np[t - 1], y[t], SR))
        b = np.asarray(motion_search(rec_np[t - 1], y[t], SR))
        g = me_agreement(rec_np[t - 1], y[t], a, b, SR)
        agree["blocks"] += g["blocks"]
        agree["differ"] += g["differ"]
        agree["worst_rel_ssd_gap"] = max(agree["worst_rel_ssd_gap"], g["worst_rel_ssd_gap"])
    agree["identical_share"] = 1 - agree["differ"] / agree["blocks"]
    if agree["identical_share"] < ME_MIN_IDENTICAL or agree["worst_rel_ssd_gap"] > ME_SSD_RTOL:
        raise AssertionError(f"kernel and scan disagree beyond near-ties: {agree}")

    enc, trip = [], []
    for _ in range(3):
        enc.append(_timed(lambda: codec.encode_gop(dev_y))[1])
        trip.append(_timed(lambda: roundtrip(codec))[1])
    return {
        "psnr_y_db": psnr, "mean_bpp": bpp, "decode_max_abs_err": err,
        "container_bytes": len(blob), "me_on_reconstructions": agree,
        "cold_s": cold, "warm_encode_gop_ms": _median_ms(enc),
        "warm_roundtrip_gop_ms": _median_ms(trip),
    }


def adaptive_encoder_recons(codec, y_dev):
    """The encoder's closed-loop reconstructions, computed by the same
    device scan that ``VideoCodec.encode_to_container`` runs."""
    import jax.numpy as jnp

    from ivclab_tpu.models.videocodec import _pframe_device_scan

    qt, inv_qt = (jnp.asarray(a) for a in codec.intra_codec._tables(1))
    T = y_dev.shape[0]
    return _pframe_device_scan(y_dev, jnp.arange(T, dtype=jnp.int32), inv_qt, qt,
                               codec.search_range, codec.end_of_block)[6]


def phase_adaptive(ctx) -> dict:
    import jax

    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.runtime.container import AdaptiveVideoPayload

    y = bench_luma()
    dev_y = jax.device_put(y)
    codec = VideoCodec(quantization_scale=Q, codebook_policy="per-frame")
    blob, enc_cold = _timed(lambda: codec.encode_to_container(dev_y))
    recons, dec_cold = _timed(lambda: VideoCodec.decode_from_container(blob))
    enc_recons = np.asarray(adaptive_encoder_recons(codec, dev_y))
    err = float(np.abs(np.asarray(recons) - enc_recons).max())
    if err >= 1e-2:
        raise AssertionError(f"adaptive decode != encoder reconstruction: {err}")
    enc, dec = [], []
    for _ in range(3):
        enc.append(_timed(lambda: codec.encode_to_container(dev_y))[1])
        dec.append(_timed(lambda: VideoCodec.decode_from_container(blob))[1])
    payload = AdaptiveVideoPayload.from_bytes(blob)
    return {
        "psnr_y_db": psnr_y(y, recons), "bpp": payload.payload_bits / (FRAMES * H * W),
        "container_bytes": len(blob), "decode_max_abs_err": err,
        "cold_encode_s": enc_cold, "cold_decode_s": dec_cold,
        "warm_encode_ms": _median_ms(enc), "warm_decode_ms": _median_ms(dec),
    }


def _cli(argv) -> dict | None:
    from ivclab_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    text = buf.getvalue().strip()
    return json.loads(text.splitlines()[-1]) if text else None


def phase_cli(ctx) -> dict:
    import jax
    import jax.numpy as jnp

    from ivclab_tpu.models.fastvideo import FusedVideoCodec
    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.ops.color import rgb2ycbcr
    from ivclab_tpu.utils import fixtures

    frames = 8
    y = np.asarray(rgb2ycbcr(fixtures.video("foreman", num_frames=frames).astype(np.float32)))[..., 0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for policy in ("first-p-frame", "per-frame"):
            ivc, npy = str(Path(tmp) / f"{policy}.ivc"), str(Path(tmp) / f"{policy}.npy")
            t0 = time.perf_counter()
            rep = _cli(["encode-video", "fixture:foreman", ivc, "--q", str(Q),
                        "--frames", str(frames), "--codebook-policy", policy])
            _cli(["decode-video", ivc, npy])
            wall = time.perf_counter() - t0
            decoded = np.load(npy).astype(np.float64)
            if policy == "first-p-frame":
                codec = FusedVideoCodec(quantization_scale=Q).train(y[:2])
                enc = np.asarray(jax.block_until_ready(codec.encode_gop(y)[3]))
            else:
                codec = VideoCodec(quantization_scale=Q, codebook_policy=policy)
                enc = np.asarray(adaptive_encoder_recons(codec, jnp.asarray(y, jnp.float32)))
            expect = np.clip(np.round(enc), 0, 255)
            gap = np.abs(decoded - expect)
            # decode-video writes uint8: pixels within 1e-2 of a .5 boundary may round apart
            if gap.max() > 1 or (gap > 0).mean() > 1e-3:
                raise AssertionError(f"{policy}: decode-video != encoder reconstruction")
            out[policy] = {"mean_psnr_y_db": rep["mean_psnr_y_db"], "mean_bpp": rep["mean_bpp"],
                           "container_bytes": rep["container_bytes"],
                           "pixels_off_by_one": int((gap > 0).sum()), "wall_s": wall}
    return out


def phase_intra_chroma(ctx) -> dict:
    from ivclab_tpu.models import IntraCodec, yuv420compression
    from ivclab_tpu.runtime.container import IntraPayload
    from ivclab_tpu.utils import calc_psnr, fixtures

    lena, lena_small = fixtures.image("lena"), fixtures.image("lena_small")
    codec = IntraCodec(quantization_scale=0.15)
    codec.train_huffman_from_image(lena_small)
    blob = codec.encode_to_container(lena)
    recon = IntraCodec.decode_from_container(blob)
    psnr = float(calc_psnr(lena, recon))
    bpp = IntraPayload.from_bytes(blob).payload_bits / (lena.shape[0] * lena.shape[1])
    yuv = float(calc_psnr(lena, yuv420compression(lena)))
    if abs(psnr - INTRA_PSNR_CPU) > CPU_TOL_DB or abs(yuv - YUV420_PSNR_CPU) > CPU_TOL_DB:
        raise AssertionError(f"intra {psnr} dB / yuv420 {yuv} dB differ from the CPU values")
    return {"intra_psnr_db": psnr, "intra_bpp": bpp, "intra_cpu_psnr_db": INTRA_PSNR_CPU,
            "intra_cpu_bpp": INTRA_BPP_CPU, "yuv420_psnr_db": yuv,
            "yuv420_cpu_psnr_db": YUV420_PSNR_CPU}


def phase_four_cards(ctx) -> dict:
    """Sharded 1080p encode on a 2 (gop) x 2 (tile) mesh vs one device."""
    import jax
    import jax.numpy as jnp

    from ivclab_tpu.models.fastvideo import FusedVideoCodec
    from ivclab_tpu.models.videocodec import VideoCodec
    from ivclab_tpu.parallel.mesh import make_mesh
    from ivclab_tpu.parallel.video import (
        ShardedAdaptiveEncoder, build_sharded_video_codec, shard_frames,
    )

    devices = jax.devices()
    if len(devices) < 4:
        raise SystemExit(f"--four-cards needs 4 devices, found {len(devices)}")
    mesh = make_mesh(n_gop=2, n_tile=2, devices=devices[:4])
    n_gop = 2
    y = bench_luma(n_gop * FRAMES)
    gops = [y[g * FRAMES : (g + 1) * FRAMES] for g in range(n_gop)]

    codec = FusedVideoCodec(quantization_scale=Q).train(y[:2])
    encoded = [codec.encode_gop(jnp.asarray(g)) for g in gops]
    for qs, *_ in encoded:  # settle the sticky pack buckets over both GOPs
        codec.pack_gop(qs)
    cap, bw, gw = codec._buckets
    packed = [codec.pack_gop(qs) for qs, *_ in encoded]
    if codec._buckets != (cap, bw, gw):
        raise AssertionError("pack buckets moved between GOPs")

    step = build_sharded_video_codec(mesh, codec, FRAMES, BAND_H, W,
                                     cap=cap, group_words=gw, block_words=bw)
    frames = shard_frames(y, mesh)
    out, cold = _timed(lambda: step(frames))
    for g, (p, (_, mvs, _, _)) in enumerate(zip(packed, encoded)):
        sl = slice(g * FRAMES, (g + 1) * FRAMES)
        if not np.array_equal(np.asarray(out.mvs[sl]), np.asarray(mvs)):
            raise AssertionError(f"sharded MVs differ from one device on GOP {g}")
        if not np.array_equal(np.asarray(out.words[sl]), np.asarray(p.words)):
            raise AssertionError(f"sharded words differ from one device on GOP {g}")
    warm = [_timed(lambda: step(frames))[1] for _ in range(3)]

    enc = ShardedAdaptiveEncoder(mesh, FRAMES, BAND_H, W, quantization_scale=Q)
    blobs, acold = _timed(lambda: enc.encode(y))
    ref = VideoCodec(quantization_scale=Q, codebook_policy="per-frame")
    for g, blob in enumerate(blobs):
        if blob != ref.encode_to_container(jnp.asarray(gops[g])):
            raise AssertionError(f"sharded adaptive container differs on GOP {g}")
    awarm = [_timed(lambda: enc.encode(y))[1] for _ in range(3)]
    return {
        "mesh": {"gop": 2, "tile": 2}, "shape": [n_gop * FRAMES, H, W], "band_rows": BAND_H,
        "fused_words_mvs_identical": True, "adaptive_bytes_identical": True,
        "device_set": sorted(str(d) for d in out.words.sharding.device_set),
        "fused_cold_s": cold, "fused_warm_ms": _median_ms(warm),
        "adaptive_cold_s": acold, "adaptive_warm_ms": _median_ms(awarm),
    }


PHASES = {
    "device": phase_device,
    "me-kernel": phase_me_kernel,
    "fused-1080p": phase_fused,
    "adaptive-1080p": phase_adaptive,
    "cli": phase_cli,
    "intra-chroma": phase_intra_chroma,
    "four-cards": phase_four_cards,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded 1080p encode on four GPUs")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices)
    from ivclab_tpu.runtime.compile_cache import enable_compile_cache

    ctx = {"cache_dir": enable_compile_cache()}
    cards = card_info()
    print(cards, flush=True)
    card = cards.splitlines()[0]
    clock = CompileClock()
    for name in select_phases(args.four_cards):
        c0, h0 = clock.seconds, clock.cache_hits
        t0 = time.perf_counter()
        result = PHASES[name](ctx)
        _emit({"phase": name, "card": card, "wall_s": time.perf_counter() - t0,
               "compile_s": clock.seconds - c0, "cache_hits": clock.cache_hits - h0,
               **result})
    print(last_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
