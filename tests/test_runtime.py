"""CLI, tracing, checkpoint tests."""

import json
from pathlib import Path

import numpy as np
import pytest

from ivclab_tpu.cli import main as cli_main
from ivclab_tpu.runtime.checkpoint import GopCheckpointer
from ivclab_tpu.runtime.trace import StageTimer


def run_cli(capsys, *argv):
    cli_main(list(argv))
    out = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(out)


def test_cli_roundtrip_image(capsys):
    out = run_cli(capsys, "roundtrip-image", "fixture:lena_small", "--q", "0.5")
    assert out["psnr_db"] > 26
    assert 0.1 < out["bpp"] < 10


def test_cli_encode_decode_info(tmp_path, capsys):
    ivc = tmp_path / "x.ivc"
    png = tmp_path / "x.png"
    out = run_cli(capsys, "encode-image", "fixture:lena_small", str(ivc), "--q", "0.5")
    assert out["container_bytes"] > 0
    info = run_cli(capsys, "info", str(ivc))
    assert info["shape"] == [256, 256, 3]
    assert info["layout"] == "grouped"
    dec = run_cli(capsys, "decode-image", str(ivc), str(png))
    assert dec["shape"] == [256, 256, 3]
    assert png.exists()


def test_cli_encode_video(capsys, tmp_path):
    out_file = str(tmp_path / "seq.ivc")
    out = run_cli(capsys, "encode-video", "fixture:foreman", out_file,
                  "--frames", "3", "--q", "2.0")
    assert out["frames"] == 3
    assert out["mean_psnr_y_db"] > 24
    assert len(out["per_frame_bits"]) == 3
    import os
    assert os.path.getsize(out_file) > 0


def test_cli_rd_sweep_dpcm(capsys):
    out = run_cli(capsys, "rd-sweep", "--kind", "dpcm")
    qs = [p["q"] for p in out["points"]]
    assert qs == [1, 2, 4, 8, 16, 32, 64]
    bpps = [p["bpp"] for p in out["points"]]
    assert bpps == sorted(bpps, reverse=True)  # coarser quant -> fewer bits


def test_stage_timer():
    t = StageTimer(annotate=False)
    with t.stage("a"):
        sum(range(1000))
    with t.stage("a"):
        pass
    rep = t.report()
    assert rep["a"]["calls"] == 2
    assert rep["a"]["total_s"] >= 0


def test_stage_timer_propagates_sync_error():
    """A device fault surfacing at the stage's sync point must not vanish."""

    class FaultyResult:
        def block_until_ready(self):
            raise RuntimeError("device fault")

    t = StageTimer(annotate=False)
    with pytest.raises(RuntimeError, match="device fault"):
        with t.stage("encode", sync=FaultyResult()):
            pass
    assert "encode" not in t.report()


def test_stage_timer_annotated_stage_syncs():
    import jax.numpy as jnp

    t = StageTimer(annotate=True)
    with t.stage("dct", sync=jnp.ones(4) * 2):
        pass
    assert t.report()["dct"]["calls"] == 1


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(monkeypatch, tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set nothing is configured in code;
    otherwise the cache sits at the fixed <checkout>/.jax_cache."""
    import jax

    from ivclab_tpu.runtime import compile_cache

    updates = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: updates.append((k, v)))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert updates == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = compile_cache.enable_compile_cache()
        assert path == str(compile_cache.DEFAULT_DIR)
        assert compile_cache.DEFAULT_DIR.parent == Path(__file__).resolve().parents[1]
        assert compile_cache.DEFAULT_DIR.name == ".jax_cache"
        assert updates == [("jax_compilation_cache_dir", path)]


def test_gop_checkpointer(tmp_path):
    ck = GopCheckpointer(tmp_path)
    assert ck.resume_plan(3) == [0, 1, 2]
    recon = np.zeros((16, 16), np.float32)
    ck.save_gop(1, b"payload-bytes", recon, np.array([100, 50]))
    assert ck.completed_gops() == [1]
    assert ck.resume_plan(3) == [0, 2]
    payload, rec, bits = ck.load_gop(1)
    assert payload == b"payload-bytes"
    assert rec.shape == (16, 16)
    assert bits.tolist() == [100, 50]
    assert ck.load_gop(2) is None


def test_plot_helpers_headless(tmp_path, lena):
    """Reference plot helpers (ivclab/entropy/probability.py:71-138),
    redesigned headless: figures render and save without a display."""
    import matplotlib

    matplotlib.use("Agg", force=True)
    from ivclab_tpu.entropy import plot_histogram, plot_image_and_joint_histogram
    from ivclab_tpu.entropy.stats import stats_joint
    from ivclab_tpu.ops.color import rgb2gray
    import numpy as np

    out = tmp_path / "hist.png"
    fig = plot_histogram(lena, title="lena", save_path=str(out))
    assert out.exists() and out.stat().st_size > 0
    assert len(fig.axes) == 4  # image + 3 channels

    gray = np.asarray(rgb2gray(lena.astype(np.float32)))
    pmf = stats_joint(gray, np.arange(257))
    out2 = tmp_path / "joint.png"
    fig2 = plot_image_and_joint_histogram(gray, pmf, "lena", save_path=str(out2))
    assert out2.exists() and out2.stat().st_size > 0


def test_write_video_fallback(tmp_path, foreman):
    """mp4 export (ch4 E4-1.py:416-424): with no cv2/imageio in this
    environment the PNG-frame fallback must kick in losslessly."""
    from ivclab_tpu.utils.io import imread, write_video
    import numpy as np

    target = str(tmp_path / "clip.mp4")
    out = write_video(target, foreman[:3], fps=10)
    import os

    if out == target:  # a real encoder backend was available
        assert os.path.getsize(target) > 0
        return
    files = sorted(os.listdir(out))
    assert files == ["frame0000.png", "frame0001.png", "frame0002.png"]
    rt = imread(os.path.join(out, files[1]))
    assert np.array_equal(rt, foreman[1])
