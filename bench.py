"""Benchmark: 1080p hybrid video encode+decode throughput on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "Mpix/s", "device": {...}, "detail": {...}}

The workload is full hybrid coding of a 1080p luma sequence — motion
search, motion compensation, fused DCT+quant, zero-run, canonical Huffman
pack, parallel entropy decode, inverse transform, MC reconstruction chain
— through the fused device GOP pipeline (``ivclab_tpu.models.fastvideo``).

- the HEADLINE is ``sustained_mpix_per_s``: one continuous stream of
  IVC_BENCH_SUSTAINED (default 32) GOP round trips with a bounded
  in-flight depth of 2 (GOP i+1 is dispatched while GOP i drains);
  per-GOP completion gaps (min/median/max) show stalls.
- ``first_gop_latency_ms`` reports the stream's pipeline-fill latency
  (dispatch of GOP 0 -> its completion) separately from the sustained
  rate.
- short sync-free repeat loops are reported beside it.
- per-stage attribution comes from amortized per-phase loops (N
  dispatches of one phase, one sync, time/N).
- PSNR-Y and mean bpp give the quality of the operating point; the
  per-frame-adaptive path is reported under ``adaptive_1080p``.

There is no CPU path: without a GPU the benchmark fails.

Env knobs: IVC_BENCH_H/W/FRAMES/ITERS/REPEATS/SUSTAINED/Q
(1088/1920/8/3/3/32/1.0). IVC_BENCH_ADAPTIVE=0 skips the adaptive entry.
"""

from __future__ import annotations

import json
import os
import subprocess
import time


def main():
    H = int(os.environ.get("IVC_BENCH_H", 1088))
    W = int(os.environ.get("IVC_BENCH_W", 1920))
    T = int(os.environ.get("IVC_BENCH_FRAMES", 8))
    iters = int(os.environ.get("IVC_BENCH_ITERS", 3))
    repeats = int(os.environ.get("IVC_BENCH_REPEATS", 3))
    sustained_n = int(os.environ.get("IVC_BENCH_SUSTAINED", 32))
    q = float(os.environ.get("IVC_BENCH_Q", 1.0))
    bench_adaptive = os.environ.get("IVC_BENCH_ADAPTIVE", "1") != "0"

    import jax
    import numpy as np

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX reports {devices}")
    from ivclab_tpu.runtime.compile_cache import enable_compile_cache

    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]

    from ivclab_tpu.models.fastvideo import FusedVideoCodec
    from ivclab_tpu.utils import fixtures

    frames = fixtures.video("bench", num_frames=T, shape=(H, W))
    y = np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))

    codec = FusedVideoCodec(quantization_scale=q)
    codec.train(y[:2])

    dev_y = jax.device_put(y)

    def roundtrip():
        """One GOP encode->pack->decode, every phase dispatched
        back-to-back with ZERO host syncs; bucket adequacy rides along as
        the device bool checked at the caller's sync point.
        """
        qsyms, mvs, mv_bits, enc_recons = codec.encode_gop(dev_y)
        p = codec.pack_gop(qsyms, check=False)
        recons, ok = codec.decode_gop(
            p.words, p.offsets, p.counts, mvs, H, W, p.block_words, p.cap
        )
        return recons, p.totals + mv_bits, ok, enc_recons, p, qsyms, mvs

    # warmup / compile + correctness + quality (PSNR-Y of the decoded
    # frames against the source — the quality half of the headline claim)
    codec.pack_gop(codec.encode_gop(dev_y)[0])  # establish sticky buckets
    recons, bits, ok, enc_recons, p, qsyms_w, mvs_w = roundtrip()
    recons.block_until_ready()
    # warm the ok-flag AND reduction: the timed loops accumulate
    # `ok & p.ok` on device, and its first use compiles a program
    jax.block_until_ready(ok & p.ok)
    assert bool(ok) and bool(p.ok), "entropy decode / pack buckets failed"
    err = float(abs(np.asarray(recons) - np.asarray(enc_recons)).max())
    assert err < 1e-2, f"decoder mismatch: {err}"
    rec_np = np.asarray(recons)
    mse = np.mean((rec_np - y) ** 2, axis=(1, 2))
    psnr_y = float(np.mean(20 * np.log10(255.0 / np.sqrt(np.maximum(mse, 1e-12)))))
    # fail loudly if throughput ever comes at the cost of quality: ~31 dB
    # is this content's q=1.0 operating point (reference-parity transform)
    assert psnr_y > 28.0, f"PSNR-Y collapsed: {psnr_y:.2f} dB"

    # one untimed loop to warm allocator state
    for _ in range(iters):
        recons, *_ = roundtrip()
    recons.block_until_ready()

    # ---------------- sustained streaming (the headline) ----------------
    # bounded in-flight depth 2: dispatch GOP i+1, then block on GOP i.
    pend = []
    oks = []
    gop_done = []
    t0 = time.perf_counter()
    for _ in range(sustained_n):
        r, _, ok_i, _, p_i, _, _ = roundtrip()
        oks.append(ok_i & p_i.ok)
        pend.append(r)
        if len(pend) >= 2:
            pend.pop(0).block_until_ready()
            gop_done.append(time.perf_counter() - t0)
    while pend:
        pend.pop(0).block_until_ready()
        gop_done.append(time.perf_counter() - t0)
    sustained_dt = time.perf_counter() - t0
    assert all(bool(o) for o in jax.device_get(oks)), "entropy decode failed in stream"
    gaps_ms = np.diff([0.0] + gop_done) * 1000
    gop_pixels = H * W * T
    sustained_mpix = gop_pixels * sustained_n / sustained_dt / 1e6
    first_gop_ms = gop_done[0] * 1000

    # ------------- short sync-free repeats (r3/r4 comparability) -------------
    repeat_dts = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        all_ok = None
        for _ in range(iters):
            recons, bits, ok, _, p, _, _ = roundtrip()
            it_ok = ok if p.ok is None else ok & p.ok
            all_ok = it_ok if all_ok is None else all_ok & it_ok
        recons.block_until_ready()
        repeat_dts.append(time.perf_counter() - t0)
        assert bool(all_ok), "entropy decode / pack buckets failed in timed loop"
    reps_mpix = sorted(gop_pixels * iters / dt / 1e6 for dt in repeat_dts)

    mpix_per_s = float(sustained_mpix)
    fps = mpix_per_s * 1e6 / (H * W)

    # per-stage attribution: amortized per-phase loops (N dispatches, ONE
    # sync, time/N)
    def timed_phase(fn, n=iters):
        out = None
        t0 = time.perf_counter()
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        return 1000 * (time.perf_counter() - t0) / n

    stages = {
        "encode": timed_phase(lambda: codec.encode_gop(dev_y)[0]),
        "pack": timed_phase(lambda: codec.pack_gop(qsyms_w, check=False).words),
        "decode": timed_phase(
            lambda: codec.decode_gop(
                p.words, p.offsets, p.counts, mvs_w, H, W, p.block_words, p.cap
            )[0]
        ),
    }

    # ------------------------- per-frame-adaptive path -------------------------
    adaptive = None
    if bench_adaptive:
        from ivclab_tpu.models.videocodec import VideoCodec

        acodec = VideoCodec(quantization_scale=q, codebook_policy="per-frame")
        blob = acodec.encode_to_container(dev_y)  # compile + warm
        enc_dts = []
        for _ in range(max(2, repeats - 1)):
            t0 = time.perf_counter()
            blob = acodec.encode_to_container(dev_y)
            enc_dts.append(time.perf_counter() - t0)
        enc_dt = float(np.median(enc_dts))
        # compile + warm the SAME path that is timed (the host-path warm
        # leaves the device-return stack ops uncompiled)
        jax.block_until_ready(
            VideoCodec.decode_from_container(blob, return_device=True)[0]
        )
        # device-resident decode (the serving path) vs the float32 host
        # reconstruction download, reported separately: the fetch is a
        # transfer, not codec work
        t0 = time.perf_counter()
        arec_dev, _ = VideoCodec.decode_from_container(blob, return_device=True)
        jax.block_until_ready(arec_dev)
        dec_dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        arec = np.asarray(arec_dev)
        fetch_dt = time.perf_counter() - t0
        amse = np.mean((arec - y) ** 2, axis=(1, 2))
        apsnr = float(np.mean(20 * np.log10(255.0 / np.sqrt(np.maximum(amse, 1e-12)))))
        adaptive = {
            "encode_mpix_per_s": round(gop_pixels / enc_dt / 1e6, 2),
            "encode_fps": round(T / enc_dt, 2),
            "decode_mpix_per_s": round(gop_pixels / dec_dt / 1e6, 2),
            "decode_fps": round(T / dec_dt, 2),
            "recon_fetch_ms": round(1000 * fetch_dt, 1),
            "psnr_y_db": round(apsnr, 2),
            "container_bytes": len(blob),
            "note": (
                "per-frame codebook retraining (reference AdaptiveVideoCodec "
                "flagship policy), self-contained container in/out; decode "
                "is device-resident, recon_fetch_ms is the host download"
            ),
        }

    # optional xprof capture of one sync-free loop (view with tensorboard)
    trace_dir = os.environ.get("IVC_BENCH_TRACE")
    if trace_dir:
        from ivclab_tpu.runtime.trace import device_trace

        with device_trace(trace_dir):
            for _ in range(iters):
                recons, *_ = roundtrip()
            recons.block_until_ready()

    detail = {
        "fps": round(fps, 2),
        "frames": T,
        "sustained_gops": sustained_n,
        "sustained_mpix_per_s": round(float(sustained_mpix), 2),
        "first_gop_latency_ms": round(first_gop_ms, 1),
        "gop_gap_ms": {
            "min": round(float(gaps_ms.min()), 1),
            "median": round(float(np.median(gaps_ms)), 1),
            "max": round(float(gaps_ms.max()), 1),
        },
        "repeats_mpix_per_s": [round(v, 2) for v in reps_mpix],
        "psnr_y_db": round(psnr_y, 2),
        "mean_bpp": round(float(np.mean(np.asarray(bits))) / (H * W), 4),
        "card": card,
        "gop_ms": round(1000 * sustained_dt / sustained_n, 1),
        # amortized per-phase device-loop times; their sum should track
        # gop_ms
        "stages_ms_per_gop_amortized": {k: round(v, 1) for k, v in stages.items()},
        "stage_sum_ms": round(sum(stages.values()), 1),
    }
    if adaptive is not None:
        detail["adaptive_1080p"] = adaptive
    print(
        json.dumps(
            {
                "metric": (
                    f"encode+decode {W}x{H} hybrid video sustained throughput "
                    f"(1 chip, q={q}, {sustained_n}-GOP stream)"
                ),
                "value": round(mpix_per_s, 2),
                "unit": "Mpix/s",
                "device": {
                    "platform": devices[0].platform,
                    "kind": devices[0].device_kind,
                    "count": len(devices),
                    "card": card,
                },
                "detail": detail,
            }
        )
    )


if __name__ == "__main__":
    main()
