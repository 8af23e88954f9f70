"""Full-search block motion estimation as a Pallas kernel (Triton route, GPU).

The XLA form (:func:`ivclab_tpu.ops.motion.motion_search`) is a scan over
the ``(2sr+1)^2`` candidate displacements: every step shifts, subtracts and
block-reduces the whole frame, so one P-frame costs a device-loop
iteration per candidate, each reading the current and reference frames.
This kernel runs the whole search in one launch. A 2-D grid of
``TILE_H x TILE_W`` pixel tiles covers the frame; each program loads its
tile of the current frame once, then reads the reference window at every
candidate offset from the halo-padded reference. A tile plus its +/-sr
halo is about 22 KB, so those repeated reads hit L1/L2, and device
memory sees about one read of each frame.

Block SSDs are float32 sums over each ``block x block`` block: the 8
rows of every block are 8 row-strided loads summed elementwise, then one
reduction over each block's 8 columns (a tensor-core product would run
in TF32 and flip near-tie argmins). The row offset ``dy`` is a loop, the
column offset ``dx`` is unrolled. Candidates are visited in the
reference scan order with strict-< updates, and candidates that leave
the frame are masked to +inf (``ivclab/video/motion.py:39-42``), exactly
as the scan does; the packed index is ``(dy + sr) * (2 sr + 1) + (dx + sr)``.

One kernel serves both call sites: the single-frame search is the
row-band search with row offset 0, the frame height as total height and
zero-filled halos. The wrapper pads rows and columns up to whole tiles,
so every frame with ``block``-aligned sides takes the kernel.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

TILE_H, TILE_W = 32, 128  # 4 x 16 MV blocks per program; powers of two
NUM_WARPS, NUM_STAGES = 8, 2


def _me_kernel(row0_ref, ref_ref, cur_ref, out_ref, *, sr, block, total_h, width):
    th, tw = cur_ref.shape
    nby, nbx = th // block, tw // block
    total = 2 * sr + 1
    r0 = pl.program_id(0) * th
    c0 = pl.program_id(1) * tw

    # row r of every block in the tile: [nby, tw] strided views, so the
    # row sum of a block is a sum of 8 such slices (no reshape of rows)
    cur_rows = [cur_ref[pl.ds(r, nby, stride=block), :] for r in range(block)]
    # global top row / left column of every block in this tile
    by = row0_ref[0] + r0 + jax.lax.broadcasted_iota(jnp.int32, (nby, nbx), 0) * block
    bx = c0 + jax.lax.broadcasted_iota(jnp.int32, (nby, nbx), 1) * block

    def row_of_candidates(iy, carry):
        best_ssd, best_idx = carry
        dy = iy - sr
        valid_y = (by + dy >= 0) & (by + dy + block <= total_h)
        for ix in range(total):  # static: fixed column offsets per load
            dx = ix - sr
            acc = None
            for r in range(block):
                win = ref_ref[pl.ds(r0 + sr + dy + r, nby, stride=block),
                              pl.ds(c0 + sr + dx, tw)]
                d = cur_rows[r] - win
                acc = d * d if acc is None else acc + d * d
            ssd = acc.reshape(nby, nbx, block).sum(axis=2)
            valid = valid_y & (bx + dx >= 0) & (bx + dx + block <= width)
            ssd = jnp.where(valid, ssd, jnp.inf)
            take = ssd < best_ssd  # strict: first candidate in scan order wins ties
            best_ssd = jnp.where(take, ssd, best_ssd)
            best_idx = jnp.where(take, iy * total + ix, best_idx)
        return best_ssd, best_idx

    init = (jnp.full((nby, nbx), jnp.inf, jnp.float32), jnp.zeros((nby, nbx), jnp.int32))
    _, best = jax.lax.fori_loop(0, total, row_of_candidates, init)
    out_ref[...] = best


@partial(jax.jit, static_argnames=("total_h", "search_range", "block", "interpret"))
def motion_search_tile_pallas(ref_ext, cur_tile, tile_row0, total_h: int,
                              search_range: int = 4, block: int = 8,
                              interpret: bool = False):
    """Pallas ME for one row band with a pre-exchanged halo.

    Drop-in for :func:`ivclab_tpu.parallel.halo.motion_search_tile`:
    ``ref_ext`` is ``[Ht + 2sr, W]`` (the band plus ``sr`` halo rows above
    and below), ``cur_tile`` ``[Ht, W]``, ``tile_row0`` the band's global
    first row (a traced scalar under ``shard_map``) and ``total_h`` the
    frame height. Returns packed indices ``[Ht/block, W/block]``.
    """
    sr = search_range
    ref_ext = jnp.asarray(ref_ext, dtype=jnp.float32)
    cur = jnp.asarray(cur_tile, dtype=jnp.float32)
    Ht, W = cur.shape
    if Ht % block or W % block or TILE_H % block or TILE_W % block:
        raise ValueError(f"frame {Ht}x{W} and tiles must be multiples of block={block}")
    Hp = -(-Ht // TILE_H) * TILE_H
    Wp = -(-W // TILE_W) * TILE_W
    cur = jnp.pad(cur, ((0, Hp - Ht), (0, Wp - W)))
    # rows carry the halo already; columns get +/-sr, both get tile padding
    ref = jnp.pad(ref_ext, ((0, Hp - Ht), (sr, sr + Wp - W)))
    row0 = jnp.asarray(tile_row0, dtype=jnp.int32).reshape(1)

    kernel = partial(_me_kernel, sr=sr, block=block, total_h=total_h, width=W)
    out = pl.pallas_call(
        kernel,
        grid=(Hp // TILE_H, Wp // TILE_W),
        in_specs=[
            pl.no_block_spec,
            pl.no_block_spec,
            pl.BlockSpec((TILE_H, TILE_W), lambda i, j: (i, j)),
        ],
        out_specs=pl.BlockSpec((TILE_H // block, TILE_W // block), lambda i, j: (i, j)),
        out_shape=jax.ShapeDtypeStruct((Hp // block, Wp // block), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=NUM_STAGES),
        interpret=interpret,
        name="motion_search",
    )(row0, ref, cur)
    return out[: Ht // block, : W // block]


def motion_search_pallas(ref_image, image, search_range: int = 4, block: int = 8,
                         interpret: bool = False):
    """Pallas full-search ME; drop-in for :func:`ops.motion.motion_search`."""
    sr = search_range
    ref = jnp.pad(jnp.asarray(ref_image, dtype=jnp.float32), ((sr, sr), (0, 0)))
    H = ref.shape[0] - 2 * sr
    return motion_search_tile_pallas(ref, image, 0, H, sr, block, interpret=interpret)
