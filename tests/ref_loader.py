"""Load reference (/root/reference) modules by file path for parity tests.

``import ivclab`` would fail: the package __init__ star-imports
``ivclab.entropy.huffman`` which needs the Rust ``constriction`` wheel
(absent here). Instead, leaf modules are loaded in dependency order under
their real dotted names, with hand-built parent packages exposing exactly
the symbols the leaves import — the reference's own __init__.py files are
never executed.

Everything degrades to ``None`` (tests skip) if the reference tree is
missing.
"""

from __future__ import annotations

import importlib.util
import sys
import types
from pathlib import Path

REF_ROOT = Path("/root/reference")


def _load(dotted: str, path: Path):
    spec = importlib.util.spec_from_file_location(dotted, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[dotted] = mod
    spec.loader.exec_module(mod)
    return mod


def _fake_pkg(dotted: str):
    if dotted in sys.modules:
        return sys.modules[dotted]
    pkg = types.ModuleType(dotted)
    pkg.__path__ = []
    sys.modules[dotted] = pkg
    return pkg


_cache: dict | None = None


def load_reference():
    """Returns a namespace of reference modules, or None if unavailable."""
    global _cache
    if _cache is not None:
        return _cache or None
    if not (REF_ROOT / "ivclab").is_dir():
        _cache = {}
        return None

    iv = REF_ROOT / "ivclab"
    _fake_pkg("ivclab")
    sig_pkg = _fake_pkg("ivclab.signal")
    utl_pkg = _fake_pkg("ivclab.utils")
    ent_pkg = _fake_pkg("ivclab.entropy")
    qnt_pkg = _fake_pkg("ivclab.quantization")
    _fake_pkg("ivclab.image")
    _fake_pkg("ivclab.video")

    color = _load("ivclab.signal.color", iv / "signal" / "color.py")
    for name in ("rgb2gray", "rgb2ycbcr", "ycbcr2rgb"):
        setattr(sig_pkg, name, getattr(color, name))

    io_mod = _load("ivclab.utils.io", iv / "utils" / "io.py")
    utl_pkg.imread = io_mod.imread

    shape = _load("ivclab.utils.shape", iv / "utils" / "shape.py")
    metrics = _load("ivclab.utils.metrics", iv / "utils" / "metrics.py")
    dct = _load("ivclab.signal.dct", iv / "signal" / "dct.py")
    zigzag = _load("ivclab.signal.zigzag", iv / "signal" / "zigzag.py")
    signal = _load("ivclab.signal.signal", iv / "signal" / "signal.py")
    probability = _load("ivclab.entropy.probability", iv / "entropy" / "probability.py")
    ent_pkg.stats_cond = probability.stats_cond
    entropy = _load("ivclab.entropy.entropy", iv / "entropy" / "entropy.py")
    sys.modules["ivclab.entropy.probability"] = probability
    zerorun = _load("ivclab.entropy.zerorun", iv / "entropy" / "zerorun.py")
    patchquant = _load("ivclab.quantization.patchquant", iv / "quantization" / "patchquant.py")
    predictive = _load("ivclab.image.predictive", iv / "image" / "predictive.py")
    motion = _load("ivclab.video.motion", iv / "video" / "motion.py")

    # The reference IntraCodec imports HuffmanCoder (constriction-gated)
    # at module level but its transform front-end (image2symbols /
    # symbols2image) never touches it. Expose the leaf symbols it needs on
    # the fake packages, substituting this repo's API-compatible canonical
    # HuffmanCoder — the differential RD test then codes the reference's
    # own symbol streams with optimal canonical lengths (rate <=
    # constriction's Huffman on the same pmf).
    from ivclab_tpu.entropy.huffman import HuffmanCoder as _OurHuffmanCoder

    ent_pkg.ZeroRunCoder = zerorun.ZeroRunCoder
    ent_pkg.stats_marg = entropy.stats_marg
    ent_pkg.smooth_pmf = entropy.smooth_pmf
    ent_pkg.HuffmanCoder = _OurHuffmanCoder
    qnt_pkg.PatchQuant = patchquant.PatchQuant
    utl_pkg.ZigZag = shape.ZigZag
    utl_pkg.Patcher = shape.Patcher
    sig_pkg.DiscreteCosineTransform = dct.DiscreteCosineTransform
    intracodec = _load("ivclab.image.intracodec", iv / "image" / "intracodec.py")

    # yuv420codec pulls matplotlib + signal helpers at module level
    for name in ("downsample", "upsample", "interpolation_upsample", "lowpass_filter"):
        setattr(sig_pkg, name, getattr(signal, name))
    utl_pkg.metrics = metrics
    sys.modules["ivclab.utils.metrics"] = metrics
    yuv420 = _load("ivclab.image.yuv420codec", iv / "image" / "yuv420codec.py")

    # ch1 ICT study drivers (self-contained scipy pipelines; loaded under
    # private names — they are scripts, not ivclab modules)
    ex_ict = _load("ref_ex_ict", REF_ROOT / "exercises" / "ch1" / "ex_ict.py")
    ex_ict_decimate = _load(
        "ref_ex_ict_decimate", REF_ROOT / "exercises" / "ch1" / "ex_ict_decimate.py"
    )

    _cache = dict(
        color=color, shape=shape, metrics=metrics, dct=dct, zigzag=zigzag,
        signal=signal, probability=probability, entropy=entropy,
        zerorun=zerorun, patchquant=patchquant, predictive=predictive,
        motion=motion, intracodec=intracodec, yuv420=yuv420,
        ex_ict=ex_ict, ex_ict_decimate=ex_ict_decimate,
    )
    return _cache
