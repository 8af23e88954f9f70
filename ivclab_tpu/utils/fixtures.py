"""Deterministic synthetic test/benchmark imagery.

The reference validates against real photographs (lena.tif, sail.tif,
satpic1.bmp, foreman frames) that are downloaded out-of-band
(``/root/reference/README.md:32-34``) and are not redistributable here.
This module synthesizes reproducible stand-ins with natural-image-like
statistics (multi-octave smooth value noise + edges + texture) so the
golden-value regression style of the reference test suite
(``/root/reference/tests/ch1.py``..``ch3.py``) carries over with golden
values pinned to these fixtures.

Everything is a pure function of the fixture name — no files, no RNG state.
"""

from __future__ import annotations

import functools

import numpy as np


def _value_noise(rng: np.random.Generator, shape, octaves=((8, 1.0), (32, 0.5), (128, 0.25))):
    """Sum of bilinearly-upsampled random grids -> smooth 'natural' field in [0,1]."""
    H, W = shape
    out = np.zeros((H, W), dtype=np.float64)
    for grid, amp in octaves:
        gh, gw = max(2, min(grid, H)), max(2, min(grid, W))
        coarse = rng.random((gh, gw))
        ys = np.linspace(0, gh - 1, H)
        xs = np.linspace(0, gw - 1, W)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        c00 = coarse[y0][:, x0]
        c01 = coarse[y0][:, x0 + 1]
        c10 = coarse[y0 + 1][:, x0]
        c11 = coarse[y0 + 1][:, x0 + 1]
        out += amp * ((1 - fy) * ((1 - fx) * c00 + fx * c01) + fy * ((1 - fx) * c10 + fx * c11))
    out -= out.min()
    peak = out.max()
    if peak > 0:
        out /= peak
    return out


def _paint_shapes(rng: np.random.Generator, base: np.ndarray, n: int = 12) -> np.ndarray:
    """Overlay flat-ish rectangles and ellipses to create hard edges."""
    H, W = base.shape
    img = base.copy()
    yy, xx = np.mgrid[0:H, 0:W]
    for _ in range(n):
        cy, cx = rng.integers(0, H), rng.integers(0, W)
        ry, rx = rng.integers(H // 16, H // 4), rng.integers(W // 16, W // 4)
        level = rng.random()
        if rng.random() < 0.5:
            mask = (np.abs(yy - cy) < ry) & (np.abs(xx - cx) < rx)
        else:
            mask = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
        img[mask] = 0.35 * img[mask] + 0.65 * level
    return img


def _synth_rgb(seed: int, shape, texture: float = 0.04, shapes: int = 12) -> np.ndarray:
    H, W = shape
    rng = np.random.default_rng(seed)
    luma = _paint_shapes(rng, _value_noise(rng, (H, W)), n=shapes)
    chroma_u = _value_noise(rng, (H, W), octaves=((4, 1.0), (16, 0.3)))
    chroma_v = _value_noise(rng, (H, W), octaves=((4, 1.0), (16, 0.3)))
    luma = luma + texture * rng.standard_normal((H, W))
    y = 16 + 219 * np.clip(luma, 0, 1)
    cb = 96 + 64 * chroma_u
    cr = 96 + 64 * chroma_v
    r = y + 1.402 * (cr - 128.0)
    g = y - 0.344136 * (cb - 128.0) - 0.714136 * (cr - 128.0)
    b = y + 1.772 * (cb - 128.0)
    rgb = np.stack([r, g, b], axis=-1)
    return np.clip(np.round(rgb), 0, 255).astype(np.uint8)


_NAMED = {
    # name: (seed, (H, W))  — stand-ins for the reference data/ images
    "lena": (1001, (512, 512)),
    "lena_small": (1001, (256, 256)),
    "sail": (1002, (480, 640)),
    "smandril": (1003, (512, 512)),
    "peppers": (1004, (512, 512)),
    "monarch": (1005, (512, 768)),
    "satpic1": (1006, (384, 512)),
}


@functools.lru_cache(maxsize=None)
def image(name: str) -> np.ndarray:
    """Named deterministic RGB uint8 fixture image."""
    if name not in _NAMED:
        raise KeyError(f"unknown fixture {name!r}; have {sorted(_NAMED)}")
    seed, shape = _NAMED[name]
    return _synth_rgb(seed, shape)


@functools.lru_cache(maxsize=None)
def degraded(name: str, seed: int = 7, noise: float = 35.0) -> np.ndarray:
    """A heavily degraded reconstruction pair for MSE/PSNR tests.

    Stand-in for the reference's precompressed lena_rec.tif
    (``tests/ch1.py:11-17``).
    """
    rng = np.random.default_rng(seed)
    img = image(name).astype(np.float64)
    blur = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    noisy = blur + noise * rng.standard_normal(img.shape)
    return np.clip(np.round(noisy), 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def video(name: str = "foreman", num_frames: int = 21, shape=(288, 352)) -> np.ndarray:
    """Deterministic CIF-like sequence ``[T, H, W, 3]`` with real motion.

    Global pan (sub-±3 px/frame) of a larger background plus two
    independently translating foreground objects, so block motion search
    with search_range=4 (the ch4 workload, ``exercises/ch4/E4-1.py:360``)
    has genuine structure to find.
    """
    H, W = shape
    # zlib.crc32 is stable across processes; Python's hash() is salted per
    # process (PYTHONHASHSEED), which made every bench run generate a
    # different sequence and drift mean_bpp run to run
    import zlib

    seed = 2000 + (zlib.crc32(name.encode()) % 1000 if name != "foreman" else 0)
    rng = np.random.default_rng(seed)
    margin = 64
    bg = _synth_rgb(seed, (H + 2 * margin, W + 2 * margin), shapes=20).astype(np.float64)

    obj_a = _synth_rgb(seed + 1, (48, 48), shapes=3).astype(np.float64)
    obj_b = _synth_rgb(seed + 2, (32, 64), shapes=3).astype(np.float64)

    frames = np.empty((num_frames, H, W, 3), dtype=np.uint8)
    for t in range(num_frames):
        # Smooth global pan within +/- 3 px/frame; clamped so long
        # sequences never run off the oversized background
        oy = min(max(margin + int(round(10 * np.sin(t / 6.0))), 0), 2 * margin)
        ox = min(max(margin + int(round(2.2 * t)), 0), 2 * margin)
        frame = bg[oy : oy + H, ox : ox + W].copy()

        ay = min(max(int(round(H * 0.3 + 3.0 * t)), 0), H - 48)
        ax = min(max(int(round(W * 0.2 + 1.5 * t)), 0), W - 48)
        frame[ay : ay + 48, ax : ax + 48] = obj_a

        by = min(max(int(round(H * 0.6 - 1.0 * t)), 0), H - 32)
        bx = min(max(int(round(W * 0.7 - 2.5 * t)), 0), W - 64)
        frame[by : by + 32, bx : bx + 64] = obj_b

        frame += 1.5 * rng.standard_normal(frame.shape)
        frames[t] = np.clip(np.round(frame), 0, 255).astype(np.uint8)
    return frames


def video_1080p(num_frames: int = 8) -> np.ndarray:
    """1080p benchmark sequence (the throughput workload)."""
    return video("bench1080", num_frames=num_frames, shape=(1088, 1920))
