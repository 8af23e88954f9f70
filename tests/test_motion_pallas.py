"""Pallas motion-search kernel: interpret-mode parity, padding, dispatch, GPU.

The kernel (``ivclab_tpu/ops/motion_pallas.py``, Triton route) is the
P-frame hot path on the GPU. Interpret mode runs the same kernel logic
through the Pallas interpreter on the CPU, so parity against the XLA
candidate scan — itself oracle-tested against the reference's triple loop
(tests/test_ch4_video.py) — is in the default suite. The compiled kernel
runs only on a GPU: those tests carry the ``gpu`` marker and run in a
subprocess, because this suite pins JAX to the CPU (tests/conftest.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from ivclab_tpu.ops.motion import motion_search
from ivclab_tpu.ops.motion_pallas import (
    TILE_H,
    TILE_W,
    motion_search_pallas,
    motion_search_tile_pallas,
)


def _frames(rng, H, W, dy, dx, noise=0.5):
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = np.roll(ref, (dy, dx), axis=(0, 1)).astype(np.float32)
    cur += rng.normal(0, noise, cur.shape).astype(np.float32)
    return ref, cur


def _band_ext(ref, lo, band, sr):
    """Rows [lo - sr, lo + band + sr) of ``ref``, zero outside the frame."""
    H, W = ref.shape
    ext = np.zeros((band + 2 * sr, W), np.float32)
    top, bot = max(lo - sr, 0), min(lo + band + sr, H)
    ext[top - (lo - sr) : bot - (lo - sr)] = ref[top:bot]
    return ext


@pytest.mark.parametrize(
    "H,W,sr",
    [
        (64, 128, 4),   # whole tiles
        (64, 48, 4),    # narrower than one tile -> column padding
        (32, 96, 2),    # small search range
        (40, 56, 4),    # odd-shaped frame (multiples of 8 only)
        (64, 256, 4),   # several tile columns
    ],
)
def test_interpret_parity_vs_xla(rng, H, W, sr):
    """Interpret-mode kernel == XLA candidate scan, bit for bit."""
    ref, cur = _frames(rng, H, W, dy=3, dx=-2)
    mv_xla = np.asarray(motion_search(ref, cur, sr))
    mv_pl = np.asarray(motion_search_pallas(ref, cur, sr, interpret=True))
    assert np.array_equal(mv_pl, mv_xla)


def test_interpret_parity_on_video_fixture(foreman):
    """Parity on real-motion content (the ch4 workload shape class)."""
    y = foreman[:2, :96, :352].astype(np.float32).mean(axis=-1)
    mv_xla = np.asarray(motion_search(y[0], y[1], 4))
    mv_pl = np.asarray(motion_search_pallas(y[0], y[1], 4, interpret=True))
    assert np.array_equal(mv_pl, mv_xla)


def test_wrapper_pads_cif_frame(foreman):
    """352 columns are no multiple of the kernel tile: the wrapper pads,
    still returns the [36, 44] field, and matches the scan."""
    assert 288 % TILE_H == 0 and 352 % TILE_W != 0
    y = foreman[:2].astype(np.float32).mean(axis=-1)
    assert y.shape[1:] == (288, 352)
    mv_pl = np.asarray(motion_search_pallas(y[0], y[1], 4, interpret=True))
    assert mv_pl.shape == (36, 44)
    assert np.array_equal(mv_pl, np.asarray(motion_search(y[0], y[1], 4)))


def test_frame_form_is_tile_form_at_row0(rng):
    """The single-frame search is the band search with row offset 0, the
    frame height as total height and zero halos."""
    H, W, sr = 40, 72, 4
    ref, cur = _frames(rng, H, W, dy=-1, dx=3)
    a = np.asarray(motion_search_pallas(ref, cur, sr, interpret=True))
    b = np.asarray(motion_search_tile_pallas(
        jnp.asarray(_band_ext(ref, 0, H, sr)), jnp.asarray(cur), jnp.int32(0), H, sr,
        interpret=True,
    ))
    assert np.array_equal(a, b)


def test_auto_dispatch_uses_xla_on_cpu(rng, monkeypatch):
    """On the CPU the dispatcher must never touch the kernel."""
    import ivclab_tpu.ops.motion as m

    def boom(*a, **k):  # pragma: no cover - failure path
        raise AssertionError("pallas path taken on CPU")

    monkeypatch.setattr(
        "ivclab_tpu.ops.motion_pallas.motion_search_pallas", boom
    )
    ref, cur = _frames(rng, 64, 64, 2, 1)
    mv = np.asarray(m.motion_search_auto(ref, cur, 4))
    assert mv.shape == (8, 8)
    assert m.resolve_me_backend() == "scan"


def test_auto_dispatch_uses_kernel_on_gpu(rng, monkeypatch):
    """When JAX reports the GPU backend, the dispatcher takes the kernel
    for every 8-aligned frame (no shape cutoff)."""
    import ivclab_tpu.ops.motion as m

    calls = []

    def fake_kernel(ref, cur, sr, block):
        calls.append(np.shape(cur))
        return jnp.zeros((np.shape(cur)[0] // block, np.shape(cur)[1] // block), jnp.int32)

    monkeypatch.setattr(m.jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr("ivclab_tpu.ops.motion_pallas.motion_search_pallas", fake_kernel)
    assert m.resolve_me_backend() == "pallas"
    for H, W in ((1088, 1920), (288, 352), (40, 56)):
        ref, cur = _frames(rng, H, W, 0, 0, noise=0.0)
        assert m.motion_search_auto(ref, cur, 4).shape == (H // 8, W // 8)
    assert calls == [(1088, 1920), (288, 352), (40, 56)]
    assert m.resolve_me_backend("scan") == "scan"
    with pytest.raises(ValueError):
        m.resolve_me_backend("bogus")


def test_tile_kernel_interpret_parity_with_halos(rng):
    """Band kernel (interpret) == scan band search, on every band."""
    from ivclab_tpu.parallel.halo import motion_search_tile

    H, W, sr, n_tile = 64, 128, 4, 4
    band = H // n_tile
    ref = (rng.random((H, W)) * 255).astype(np.float32)
    cur = (np.roll(ref, (2, -3), (0, 1)) + rng.normal(0, 0.5, (H, W))).astype(np.float32)
    for t in range(n_tile):
        lo = t * band
        ext = jnp.asarray(_band_ext(ref, lo, band, sr))
        args = (ext, jnp.asarray(cur[lo : lo + band]), jnp.int32(lo), H, sr)
        a = np.asarray(motion_search_tile(*args))
        b = np.asarray(motion_search_tile_pallas(*args, interpret=True))
        assert np.array_equal(a, b), t


_GPU_PARITY = """
import numpy as np, jax, jax.numpy as jnp
from ivclab_tpu.ops.motion import motion_search
from ivclab_tpu.ops.motion_pallas import motion_search_pallas, motion_search_tile_pallas
from ivclab_tpu.parallel.halo import motion_search_tile
assert jax.default_backend() == "gpu", jax.default_backend()
rng = np.random.default_rng(7)
H, W, sr, band = 1088, 1920, 4, 544
# integer-valued frames: every 8x8 SSD < 2^24, exact in any summation order
ref = np.round(rng.random((H, W)) * 255).astype(np.float32)
cur = np.round(np.roll(ref, (3, -2), (0, 1)) + rng.normal(0, 2, (H, W))).astype(np.float32)
{body}
print("GPU_PARITY_OK")
"""


@pytest.mark.gpu
def test_gpu_frame_kernel_matches_scan_1080p(gpu_python):
    """Compiled kernel == XLA scan at 1088x1920 and at CIF (padded)."""
    gpu_python(_GPU_PARITY.format(body=(
        "for h, w in ((H, W), (288, 352)):\n"
        "    a = np.asarray(motion_search(ref[:h, :w], cur[:h, :w], sr))\n"
        "    b = np.asarray(motion_search_pallas(ref[:h, :w], cur[:h, :w], sr))\n"
        "    assert np.array_equal(a, b), (h, w)\n"
    )))


@pytest.mark.gpu
def test_gpu_tile_kernel_matches_scan_1080p(gpu_python):
    """Compiled band kernel == band scan on the two 544-row bands of 1080p."""
    gpu_python(_GPU_PARITY.format(body=(
        "for lo in (0, band):\n"
        "    ext = np.zeros((band + 2 * sr, W), np.float32)\n"
        "    top, bot = max(lo - sr, 0), min(lo + band + sr, H)\n"
        "    ext[top - (lo - sr):bot - (lo - sr)] = ref[top:bot]\n"
        "    args = (jnp.asarray(ext), jnp.asarray(cur[lo:lo + band]), jnp.int32(lo), H, sr)\n"
        "    assert np.array_equal(np.asarray(motion_search_tile(*args)),\n"
        "                          np.asarray(motion_search_tile_pallas(*args))), lo\n"
    )))
