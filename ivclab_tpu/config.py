"""Configuration tree for codecs, sweeps, and meshes.

The reference configures everything through constructor kwargs and
hard-coded sweep lists in exercise scripts (SURVEY.md §5 'Config / flag
system'). Here the same knobs are dataclasses; the CLI consumes them
directly (e.g. ``SweepConfig`` drives ``rd-sweep``).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class IntraConfig:
    quantization_scale: float = 1.0
    end_of_block: int = 4000
    block: int = 8


@dataclass
class VideoConfig:
    quantization_scale: float = 1.0
    search_range: int = 4
    gop_size: int = 8
    codebook_policy: str = "per-frame"  # per-frame | adaptive | first-p-frame


@dataclass
class SweepConfig:
    """RD sweep workloads (reference exercise definitions)."""

    # exercises/ch3/ex1.py:21
    image_q_scales: tuple = (0.05, 0.1, 0.15, 0.2, 0.3)
    # exercises/ch4/E4-1.py:360
    video_q_scales: tuple = (0.07, 0.2, 0.4, 0.8, 1.0, 1.5, 2, 3, 4, 4.5)
    # exercises/ch4/ex1.py:417
    image_vs_video_q_scales: tuple = (0.15, 0.3, 0.7, 1.0, 1.5, 3, 5, 7, 10)
    # exercises/ch2/ex_final_codec.py
    dpcm_quant_steps: tuple = (1, 2, 4, 8, 16, 32, 64)


@dataclass
class MeshConfig:
    n_gop: int | None = None
    n_tile: int | None = None


@dataclass
class Config:
    intra: IntraConfig = field(default_factory=IntraConfig)
    video: VideoConfig = field(default_factory=VideoConfig)
    sweep: SweepConfig = field(default_factory=SweepConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
