"""Block motion estimation / compensation, data-parallel.

Reference parity: ``ivclab/video/motion.py:3-97`` (MotionCompensator).
The reference runs a triple-nested Python loop — (H/8)x(W/8) blocks x
(2*sr+1)^2 candidates x 8x8 SSD — the #1 hot loop (SURVEY.md §3.3).

Here the candidate loop is a ``lax.scan`` whose body evaluates ONE
displacement for EVERY block at once (full-frame subtract/square + blockwise
reduction), carrying the running (min SSD, argmin) pair. Memory
stays O(frame), sequential depth is the candidate count (81 for sr=4), and
XLA fuses each step into a single pass over the frame. Candidate order and
the strict-< tie-breaking replicate the reference scan order exactly, so
motion fields match block for block.

Out-of-bounds candidates are masked per block (reference 'continue',
ivclab/video/motion.py:39-42). The packed index convention matches
``(dy + sr) * (2 sr + 1) + (dx + sr)`` (ivclab/video/motion.py:55).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("search_range", "block"))
def motion_search(ref_image, image, search_range: int = 4, block: int = 8):
    """Full-search block matching -> packed motion index grid.

    ref_image, image: ``[H, W]`` float32 (H, W multiples of ``block``)
    returns: ``[H/block, W/block]`` int32 packed indices
    """
    sr = search_range
    ref = jnp.asarray(ref_image, dtype=jnp.float32)
    cur = jnp.asarray(image, dtype=jnp.float32)
    H, W = cur.shape
    hb, wb = H // block, W // block

    dys, dxs = np.meshgrid(np.arange(-sr, sr + 1), np.arange(-sr, sr + 1), indexing="ij")
    candidates = jnp.asarray(np.stack([dys.ravel(), dxs.ravel()], axis=1), dtype=jnp.int32)

    by = jnp.arange(hb, dtype=jnp.int32) * block  # top row of each block
    bx = jnp.arange(wb, dtype=jnp.int32) * block

    cur_blocks = cur.reshape(hb, block, wb, block)

    def body(carry, cand):
        min_ssd, best = carry
        dy, dx = cand[0], cand[1]
        shifted = jnp.roll(ref, shift=(-dy, -dx), axis=(0, 1))
        diff = cur - shifted
        ssd = (diff * diff).reshape(hb, block, wb, block).sum(axis=(1, 3))
        valid_y = (by + dy >= 0) & (by + dy + block <= H)
        valid_x = (bx + dx >= 0) & (bx + dx + block <= W)
        valid = valid_y[:, None] & valid_x[None, :]
        ssd = jnp.where(valid, ssd, jnp.inf)
        idx = (dy + sr) * (2 * sr + 1) + (dx + sr)
        take = ssd < min_ssd  # strict: first candidate in scan order wins ties
        return (jnp.where(take, ssd, min_ssd), jnp.where(take, idx, best)), None

    init = (jnp.full((hb, wb), jnp.inf, dtype=jnp.float32), jnp.zeros((hb, wb), jnp.int32))
    (min_ssd, best), _ = jax.lax.scan(body, init, candidates)
    del min_ssd, cur_blocks
    return best


@partial(jax.jit, static_argnames=("search_range", "block"))
def motion_compensate(ref_image, motion_idx, search_range: int = 4, block: int = 8):
    """Displace ``block`` x ``block`` tiles of ``ref_image`` by the motion field.

    ref_image: ``[H, W]`` or ``[H, W, C]``; motion_idx: ``[H/block, W/block]``
    packed indices. Gather-based: per-pixel source coordinates are computed
    from the per-block displacement and clipped to the frame (the reference
    skips impossible out-of-bounds blocks, ivclab/video/motion.py:89-93).
    """
    sr = search_range
    ref = jnp.asarray(ref_image, dtype=jnp.float32)
    squeeze = ref.ndim == 2
    if squeeze:
        ref = ref[:, :, None]
    H, W, C = ref.shape
    total = 2 * sr + 1
    mv = jnp.asarray(motion_idx, dtype=jnp.int32)
    dy = mv // total - sr
    dx = mv % total - sr
    dy_pix = jnp.repeat(jnp.repeat(dy, block, axis=0), block, axis=1)
    dx_pix = jnp.repeat(jnp.repeat(dx, block, axis=0), block, axis=1)
    yy = jnp.clip(jnp.arange(H, dtype=jnp.int32)[:, None] + dy_pix, 0, H - 1)
    xx = jnp.clip(jnp.arange(W, dtype=jnp.int32)[None, :] + dx_pix, 0, W - 1)
    out = ref[yy, xx]
    return out[:, :, 0] if squeeze else out


class MotionCompensator:
    """Facade matching ``ivclab/video/motion.py`` (packed-index convention)."""

    def __init__(self, search_range: int = 4):
        self.search_range = int(search_range)

    def compute_motion_vector(self, ref_image, image):
        mv = motion_search(ref_image, image, self.search_range)
        return np.asarray(mv)[..., None].astype(int)

    def reconstruct_with_motion_vector(self, ref_image, motion_vector):
        mv = jnp.asarray(np.asarray(motion_vector)[..., 0], dtype=jnp.int32)
        return np.asarray(motion_compensate(ref_image, mv, self.search_range))


ME_BACKENDS = ("pallas", "pallas-interpret", "scan")


def resolve_me_backend(me_backend: str | None = None) -> str:
    """Pick the motion-search implementation.

    ``None`` picks the Pallas kernel (``ops/motion_pallas.py``) on the GPU
    and the XLA candidate scan on every other backend. Explicit values:
    ``"pallas"``, ``"pallas-interpret"`` (the kernel through the Pallas
    interpreter, runs on the CPU) and ``"scan"``.
    """
    if me_backend is None:
        return "pallas" if jax.default_backend() == "gpu" else "scan"
    if me_backend not in ME_BACKENDS:
        raise ValueError(f"unknown me_backend {me_backend!r}")
    return me_backend


def motion_search_auto(ref_image, image, search_range: int = 4, block: int = 8):
    """Backend dispatcher: the Pallas kernel on the GPU, the XLA candidate
    scan elsewhere (see :func:`resolve_me_backend`)."""
    if resolve_me_backend() == "pallas":
        from ivclab_tpu.ops.motion_pallas import motion_search_pallas

        return motion_search_pallas(ref_image, image, search_range, block)
    return motion_search(ref_image, image, search_range, block)


@partial(jax.jit, static_argnames=("search_range", "block"))
def motion_compensate_dense(ref_image, motion_idx, search_range: int = 4, block: int = 8):
    """Select-based MC: accumulate the 81 shifted references under the
    per-block motion masks. Replaces the per-pixel gather (chosen where
    gathers were latency-bound) with candidate-count dense passes; bit-identical to
    :func:`motion_compensate` for in-bounds motion fields (the only fields
    the encoder emits).
    """
    sr = search_range
    ref = jnp.asarray(ref_image, dtype=jnp.float32)
    if ref.ndim != 2:
        raise ValueError("dense MC expects a single plane")
    H, W = ref.shape
    total = 2 * sr + 1
    mv = jnp.asarray(motion_idx, dtype=jnp.int32)
    mv_pix = jnp.repeat(jnp.repeat(mv, block, axis=0), block, axis=1)

    ref_pad = jnp.pad(ref, ((sr, sr), (sr, sr)))
    dys, dxs = np.meshgrid(np.arange(-sr, sr + 1), np.arange(-sr, sr + 1), indexing="ij")
    candidates = jnp.asarray(np.stack([dys.ravel(), dxs.ravel()], axis=1), dtype=jnp.int32)

    def body(acc, cand):
        dy, dx = cand[0], cand[1]
        idx = (dy + sr) * total + (dx + sr)
        shifted = jax.lax.dynamic_slice(ref_pad, (sr + dy, sr + dx), (H, W))
        return acc + jnp.where(mv_pix == idx, shifted, 0.0), None

    acc, _ = jax.lax.scan(body, jnp.zeros((H, W), jnp.float32), candidates)
    return acc
