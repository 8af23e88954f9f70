"""Halo exchange + tile-local motion estimation under ``shard_map``.

The sequence-parallel analog for a codec (SURVEY.md §5): a frame's rows are
sharded into bands across the ``tile`` mesh axis; full-search motion
estimation needs ``search_range`` rows of the *reconstructed reference*
from each neighboring band. Those halos travel as two ``ppermute`` ring
shifts between devices, after which every band runs the motion search
locally — the result is bit-identical to the single-device search.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def exchange_row_halo(x_tile, halo: int, axis_name: str = "tile"):
    """Append ``halo`` rows from the ring neighbors above and below.

    x_tile: ``[Ht, W]`` local band. Returns ``[Ht + 2*halo, W]``; frame
    edges are zero-filled (the bounds masks in the search make them
    unreachable, matching the reference's out-of-bounds candidate skip).
    """
    n = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    top_rows = x_tile[:halo]  # my top rows -> neighbor below me receives them
    bot_rows = x_tile[-halo:]

    # ppermute: send my bottom rows to the next tile (they become its top halo)
    from_above = jax.lax.ppermute(bot_rows, axis_name, [(i, i + 1) for i in range(n - 1)])
    from_below = jax.lax.ppermute(top_rows, axis_name, [(i + 1, i) for i in range(n - 1)])
    from_above = jnp.where(idx == 0, jnp.zeros_like(from_above), from_above)
    from_below = jnp.where(idx == n - 1, jnp.zeros_like(from_below), from_below)
    return jnp.concatenate([from_above, x_tile, from_below], axis=0)


def motion_search_tile(ref_ext, cur_tile, tile_row0, total_h, search_range: int = 4, block: int = 8):
    """Dense candidate scan for one row band with a pre-exchanged halo.

    ref_ext: ``[Ht + 2*sr, W]`` reference band with halos
    cur_tile: ``[Ht, W]`` current band
    tile_row0: global row of the band's first row (traced scalar)
    total_h: full frame height (static int)
    Returns packed indices ``[Ht/block, W/block]`` identical to the global
    :func:`ivclab_tpu.ops.motion.motion_search`.
    """
    sr = search_range
    Ht, W = cur_tile.shape
    hb, wb = Ht // block, W // block

    dys, dxs = np.meshgrid(np.arange(-sr, sr + 1), np.arange(-sr, sr + 1), indexing="ij")
    candidates = jnp.asarray(np.stack([dys.ravel(), dxs.ravel()], axis=1), dtype=jnp.int32)

    by_local = jnp.arange(hb, dtype=jnp.int32) * block
    by_global = by_local + tile_row0
    bx = jnp.arange(wb, dtype=jnp.int32) * block

    def body(carry, cand):
        min_ssd, best = carry
        dy, dx = cand[0], cand[1]
        # candidate rows live at offset sr+dy inside the extended band
        shifted = jax.lax.dynamic_slice(ref_ext, (sr + dy, 0), (Ht, W))
        shifted = jnp.roll(shifted, -dx, axis=1)
        diff = cur_tile - shifted
        ssd = (diff * diff).reshape(hb, block, wb, block).sum(axis=(1, 3))
        valid_y = (by_global + dy >= 0) & (by_global + dy + block <= total_h)
        valid_x = (bx + dx >= 0) & (bx + dx + block <= W)
        ssd = jnp.where(valid_y[:, None] & valid_x[None, :], ssd, jnp.inf)
        idx = (dy + sr) * (2 * sr + 1) + (dx + sr)
        take = ssd < min_ssd
        return (jnp.where(take, ssd, min_ssd), jnp.where(take, idx, best)), None

    init = (jnp.full((hb, wb), jnp.inf, dtype=jnp.float32), jnp.zeros((hb, wb), jnp.int32))
    (_, best), _ = jax.lax.scan(body, init, candidates)
    return best


def motion_compensate_tile_dense(ref_ext, motion_idx, search_range: int = 4, block: int = 8):
    """Select-based tile MC from the halo-extended reference band.

    The tile analog of :func:`ivclab_tpu.ops.motion.motion_compensate_dense`:
    accumulate the (2sr+1)^2 shifted views of the extended band under the
    per-block motion masks — dense passes instead of per-pixel gathers
    (chosen where gathers were slow). Bit-identical to the gather form for the
    in-bounds motion fields the encoder emits.
    """
    sr = search_range
    Hext, W = ref_ext.shape
    Ht = Hext - 2 * sr
    total = 2 * sr + 1
    mv = jnp.asarray(motion_idx, dtype=jnp.int32)
    mv_pix = jnp.repeat(jnp.repeat(mv, block, axis=0), block, axis=1)

    # rows already carry the +/-sr halo; pad columns only
    ref_pad = jnp.pad(ref_ext, ((0, 0), (sr, sr)))
    dys, dxs = np.meshgrid(np.arange(-sr, sr + 1), np.arange(-sr, sr + 1), indexing="ij")
    candidates = jnp.asarray(np.stack([dys.ravel(), dxs.ravel()], axis=1), dtype=jnp.int32)

    def body(acc, cand):
        dy, dx = cand[0], cand[1]
        idx = (dy + sr) * total + (dx + sr)
        shifted = jax.lax.dynamic_slice(ref_pad, (sr + dy, sr + dx), (Ht, W))
        return acc + jnp.where(mv_pix == idx, shifted, 0.0), None

    acc, _ = jax.lax.scan(body, jnp.zeros((Ht, W), jnp.float32), candidates)
    return acc


def motion_compensate_tile(ref_ext, motion_idx, search_range: int = 4, block: int = 8):
    """Tile-local MC gather from the halo-extended reference band."""
    sr = search_range
    Hext, W = ref_ext.shape
    Ht = Hext - 2 * sr
    total = 2 * sr + 1
    dy = motion_idx // total - sr
    dx = motion_idx % total - sr
    dy_pix = jnp.repeat(jnp.repeat(dy, block, axis=0), block, axis=1)
    dx_pix = jnp.repeat(jnp.repeat(dx, block, axis=0), block, axis=1)
    yy = jnp.clip(jnp.arange(Ht, dtype=jnp.int32)[:, None] + sr + dy_pix, 0, Hext - 1)
    xx = jnp.clip(jnp.arange(W, dtype=jnp.int32)[None, :] + dx_pix, 0, W - 1)
    return ref_ext[yy, xx]
