"""Closed-loop agent configuration.

Copy of `simlingo_tpu/agent/config.py` (same fields and defaults):
controller gains, brake/creep thresholds, camera geometry and the serving
options (CoT commentary, int8 LLM, speculative CoT).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass
class AgentConfig:
    eval_route_as: str = "target_point"
    use_cot: bool = True                 # commentary chain-of-thought per frame
    int8_llm: bool = True                # w8a16 weights for the (LoRA-merged) LLM
    int4_llm: bool = False               # w4a16: not ported yet (ROADMAP A8)
    # n-gram drafts from the agent's own recent commentary, verified against
    # the model's argmax: tokens identical to plain greedy, fewer forwards.
    # The first CoT frame decodes plain (no draft corpus yet).
    speculative_cot: bool = True
    spec_k: int = 16                     # tokens per speculation round
    spec_corpus_frames: int = 8          # rolling draft-corpus window
    warmup_compile: bool = True          # run every per-frame path at setup

    carla_fps: int = 20
    # JPEG round-trip the camera frame (needs cv2)
    jpeg_roundtrip: bool = True
    initial_frames_delay: int = 40
    stuck_threshold: int = 800
    creep_duration: int = 15
    creep_throttle: float = 0.4
    wp_dilation: int = 1
    data_save_freq: int = 5

    max_throttle: float = 1.0
    brake_speed: float = 0.4
    brake_ratio: float = 1.1
    clip_delta: float = 1.0
    clip_throttle: float = 1.0

    speed_kp: float = 1.75
    speed_ki: float = 1.0
    speed_kd: float = 2.0
    speed_n: int = 20

    camera_pos: Tuple[float, float, float] = (-1.5, 0.0, 2.0)
    camera_rot: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    camera_width: int = 1024
    camera_height: int = 512
    camera_fov: int = 110

    max_new_tokens: int = 100
