"""Worker process for the 2-process ``jax.distributed`` codec test.

Launched by ``tests/test_distributed.py`` with the coordinator address /
process id in ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
``JAX_PROCESS_ID`` — exactly the environment ``init_distributed``
(``ivclab_tpu/parallel/mesh.py``) reads on a real multi-host pod. Each
process owns 2 virtual CPU devices; the (gop=2, tile=2) mesh therefore
spans the process boundary, so the ``ppermute`` halo exchange and the
``psum`` bit reduction exercise real cross-process collectives.

Process 0 writes the assembled container bytes (host-0 bitstream
assembly) plus a small JSON header to the output path; the parent
compares them word-for-word with its own single-process encode.
"""

from __future__ import annotations

import json
import struct
import sys


def main() -> int:
    out_path = sys.argv[1]
    cap, bw, gw = (int(x) for x in sys.argv[2:5])

    import jax

    jax.config.update("jax_platforms", "cpu")

    from ivclab_tpu.parallel.mesh import init_distributed, make_mesh

    assert init_distributed() is True, "init_distributed must report multi-process"
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4, jax.devices()
    assert len(jax.local_devices()) == 2

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ivclab_tpu.models.fastvideo import FusedVideoCodec
    from ivclab_tpu.parallel.video import (
        ShardedGopStreams,
        assemble_video_payloads,
        build_sharded_video_codec,
    )
    from ivclab_tpu.utils import fixtures

    T, H, W = 4, 64, 64
    gop_len, band_h = 2, 32
    frames = fixtures.video("dist", num_frames=T, shape=(H, W))
    y = np.ascontiguousarray(frames.astype(np.float32).mean(axis=-1))

    # identical deterministic training in every process (as on a real pod)
    codec = FusedVideoCodec(quantization_scale=1.0).train(y[:2])

    mesh = make_mesh(n_gop=2, n_tile=2)
    step = build_sharded_video_codec(
        mesh, codec, gop_len, band_h, W, cap=cap, group_words=gw, block_words=bw
    )
    sharding = NamedSharding(mesh, P("gop", "tile", None))
    garr = jax.make_array_from_callback(y.shape, sharding, lambda idx: y[idx])
    streams = step(garr)

    # heartbeat over the coordination service: report after the GOP step,
    # then poll until every peer's stamp is visible (the real failure-
    # detection transport — SURVEY.md §5)
    import time as _time

    from ivclab_tpu.runtime.elastic import DistributedHeartbeat

    hb = DistributedHeartbeat(timeout_s=30.0)
    hb.report()
    deadline = _time.monotonic() + 20.0
    while len(hb.poll()) < jax.process_count():
        if _time.monotonic() > deadline:
            raise RuntimeError(f"heartbeats missing: {hb.poll()}")
        _time.sleep(0.05)
    assert sorted(hb.alive_hosts()) == list(range(jax.process_count()))
    assert hb.dead_hosts() == []

    gathered = multihost_utils.process_allgather(tuple(streams), tiled=True)
    if jax.process_index() == 0:
        st = ShardedGopStreams(*(np.asarray(g) for g in gathered))
        payloads = assemble_video_payloads(codec, st, gop_len)
        with open(out_path, "wb") as f:
            head = json.dumps(
                {
                    "processes": jax.process_count(),
                    "devices": len(jax.devices()),
                    "gops": len(payloads),
                }
            ).encode()
            f.write(struct.pack("<I", len(head)) + head)
            for blob in payloads:
                f.write(struct.pack("<Q", len(blob)))
                f.write(blob)
    multihost_utils.sync_global_devices("ivclab-dist-done")
    print(f"WORKER_OK {jax.process_index()}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
