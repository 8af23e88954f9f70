"""Device mesh construction for the codec's two parallel axes.

The reference is strictly serial (SURVEY.md §2.3); the codec shards along
the two independence structures it exposes:

- ``gop``  — groups of pictures. Each GOP opens with an I-frame, so the
  P-frame recursion through the decoder reconstruction
  (reference ivclab/video/videocodec.py:48,75) never crosses shards.
  This is the data-parallel axis, and the one to put across hosts.
- ``tile`` — spatial row-bands of a frame. Intra stages (DCT/quant/
  zero-run) are blockwise and need no communication; motion estimation
  needs a +/-search_range halo of the reconstructed reference, exchanged
  with ``ppermute`` (ring-neighbor pattern).

The GPUs of one host are joined all to all (NVLink), so any device order
serves; the mesh follows the algorithm alone.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_gop: int | None = None, n_tile: int | None = None, devices=None) -> Mesh:
    """Build a ``(gop, tile)`` mesh over the available devices.

    Default factorization puts at most 4 devices on the tile axis (halo
    exchange is a small nearest-neighbor pattern) and the rest on the
    embarrassingly parallel gop axis.
    """
    devices = np.asarray(jax.devices() if devices is None else devices)
    n = devices.size
    if n_gop is None and n_tile is None:
        n_tile = 1
        for cand in (4, 2, 1):
            if n % cand == 0 and cand <= n:
                n_tile = cand
                break
        n_gop = n // n_tile
    elif n_gop is None:
        n_gop = n // n_tile
    elif n_tile is None:
        n_tile = n // n_gop
    if n_gop * n_tile != n:
        raise ValueError(f"mesh {n_gop}x{n_tile} != {n} devices")
    return Mesh(devices.reshape(n_gop, n_tile), axis_names=("gop", "tile"))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Multi-host entry: bring up the JAX distributed runtime.

    The SURVEY.md §5 'Distributed communication backend' row: on a
    multi-host cluster each process calls this before ``make_mesh`` so
    ``jax.devices()`` spans every host (gop axis across hosts, tile axis
    within one). Arguments default to the ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID`` environment. Returns
    True when a multi-process runtime was initialized, False for the
    single-process case (no-op — every test/bench path in this repo).
    """
    import os

    coordinator_address = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False  # single process: nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def frame_sharding(mesh: Mesh):
    """Sharding for a ``[T, H, W, ...]`` frame stack: T over gop, H over tile."""
    return NamedSharding(mesh, P("gop", "tile"))


def plane_sharding(mesh: Mesh):
    """Sharding for a single ``[H, W]`` plane: rows over tile."""
    return NamedSharding(mesh, P("tile"))
