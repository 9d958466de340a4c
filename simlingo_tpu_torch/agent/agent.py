"""Closed-loop driving agent core (simulator-independent).

Counterpart of `simlingo_tpu/agent/agent.py` (LingoAgent), with the same
steps per tick: camera frame -> on-device preprocessing (hood crop, cubic
resize to 448x896, normalize, 1x2 tiles) -> prompt (CoT commentary question
or action-only) -> prefill + cached decode (plain greedy on the first CoT
frame, speculative after it) + driving-query forward -> PID control, with
stuck detection and creep. At construction LoRA is merged, the LLM is
quantized to int8 (or, with `int4_llm`, to int4 with group-128 scales),
and every floating weight except the quantization scales is cast to the
compute dtype once. With `SIMLINGO_METRIC_INFO` set, the file it
names is opened for appending at construction and every inferred tick
writes and flushes one JSON line: step, steer, throttle, brake, speed,
latency_ms and language (`simlingo_tpu/agent/agent.py:130-133, 289-297`);
`close()` closes it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.agent.controllers import VehicleController
from simlingo_tpu_torch.agent.ukf import EgoUKF
from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.core.structs import DrivingInput
from simlingo_tpu_torch.data.image_pipe import preprocess_device
from simlingo_tpu_torch.data.prompts import batch_language_label, tokenize_chat
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.infer import runner
from simlingo_tpu_torch.infer import speculative as spec
from simlingo_tpu_torch.models import qwen2
from simlingo_tpu_torch.models.simlingo import SimLingoConfig


@dataclasses.dataclass
class AgentFrame:
    """One simulator tick's sensor payload."""
    rgb: np.ndarray                 # [H, W, 3] uint8 front camera
    speed: float                    # m/s
    target_point: np.ndarray        # [2] ego-frame
    next_target_point: np.ndarray   # [2] ego-frame
    compass: float = 0.0
    gps: Optional[np.ndarray] = None
    user_instruction: Optional[str] = None


def _prepare(tree, device, dtype, keep=False):
    """Move a parameter tree to `device`, casting floating leaves to dtype;
    int8 / int4 scales (siblings of "w_q") stay fp32. Leaves are detached:
    a trainer's parameters serve as they are."""
    if not isinstance(tree, dict):
        t = tree.detach().to(device)
        return t if keep or not t.is_floating_point() else t.to(dtype)
    quantized = "w_q" in tree
    return {k: _prepare(v, device, dtype, keep=quantized and k == "scale")
            for k, v in tree.items()}


class LingoAgent:
    def __init__(self, params: Dict[str, Any], model_cfg: SimLingoConfig,
                 agent_cfg: Optional[AgentConfig] = None,
                 tokenizer: Optional[SimLingoTokenizer] = None,
                 max_prompt_len: int = 640,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = agent_cfg or AgentConfig()
        self.tok = tokenizer or SimLingoTokenizer()
        if model_cfg.img_context_token_id != self.tok.img_context_id:
            model_cfg = dataclasses.replace(
                model_cfg, img_context_token_id=self.tok.img_context_id)
        self.model_cfg = model_cfg
        params = dict(params)
        # fold LoRA into the base weights: no low-rank products per token
        if "lora" in params and model_cfg.llm.lora_r > 0:
            params["llm"] = qwen2.merge_lora(params["llm"], params.pop("lora"),
                                             model_cfg.llm)
        if self.cfg.int4_llm or self.cfg.int8_llm:
            from simlingo_tpu_torch.core.quantize import quantize_llm
            params["llm"] = quantize_llm(params["llm"],
                                         bits=4 if self.cfg.int4_llm else 8)
        self.compute_dtype = compute_dtype
        self.params = _prepare(params, self.device, compute_dtype)
        self.max_prompt_len = max_prompt_len
        self.controller = VehicleController(self.cfg)
        self.ukf = EgoUKF(dt=1.0 / self.cfg.carla_fps)
        self.gen_cfg = runner.GenerateConfig(
            max_new_tokens=self.cfg.max_new_tokens,
            eos_token_id=self.tok.eos_token_id)
        self._spec_corpus: list = []
        self._draft_tables = None
        self.spec_stats: list = []   # (rounds, gen_len) per speculative frame
        if self.cfg.warmup_compile:
            self.warmup()
        self.step_count = 0
        self.stuck_count = 0
        self.creep_remaining = 0
        self.latencies: list = []
        self.last_control = (0.0, 0.0, False)
        self.last_language = ""
        self.metric_path = os.environ.get("SIMLINGO_METRIC_INFO")
        self._metric_file = open(self.metric_path, "a") if self.metric_path else None

    def close(self) -> None:
        """Close the metric file, if one is open."""
        if self._metric_file is not None:
            self._metric_file.close()
            self._metric_file = None

    # ------------------------------------------------------------------
    def _preprocessed(self, di: DrivingInput) -> DrivingInput:
        tiles = preprocess_device(di.pixel_values,
                                  image_size=self.model_cfg.vit.image_size,
                                  grid=(2, 1), do_bottom_crop=True)
        return dataclasses.replace(di, pixel_values=tiles.to(self.compute_dtype))

    def _generate(self, di: DrivingInput):
        return runner.generate_and_drive(self.params, self._preprocessed(di),
                                         self.model_cfg, self.gen_cfg,
                                         compute_dtype=self.compute_dtype)

    def _generate_spec(self, di: DrivingInput, tables):
        return spec.generate_and_drive_spec(
            self.params, self._preprocessed(di), self.model_cfg, self.gen_cfg,
            tables, spec_k=self.cfg.spec_k, compute_dtype=self.compute_dtype,
            return_stats=True)

    def _drive_only(self, di: DrivingInput):
        return runner.drive_only(self.params, self._preprocessed(di),
                                 self.model_cfg, compute_dtype=self.compute_dtype)

    def warmup(self) -> None:
        """Run every per-frame path once on a dummy frame at setup time
        (kernel build, library handles, allocator), as production shapes."""
        frame = AgentFrame(
            rgb=np.zeros((self.cfg.camera_height, self.cfg.camera_width, 3),
                         np.uint8),
            speed=0.0, target_point=np.array([5.0, 0.0]),
            next_target_point=np.array([10.0, 0.0]))
        di = self.make_input(frame)
        self._drive_only(di)
        if self.cfg.use_cot:
            self._generate(di)
            if self.cfg.speculative_cot:
                self._generate_spec(di, spec.build_draft_tables(
                    [[0, 1, 2]], self.model_cfg.llm.vocab_size))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _refresh_draft(self, tokens: List[int]) -> None:
        """Rebuild the draft tables from the rolling corpus of recent
        commentary (host-side; they stay on the host)."""
        self._spec_corpus.append(list(tokens))
        if len(self._spec_corpus) > self.cfg.spec_corpus_frames:
            self._spec_corpus.pop(0)
        self._draft_tables = spec.build_draft_tables(
            self._spec_corpus, self.model_cfg.llm.vocab_size)

    # ------------------------------------------------------------------
    def filter_ego_state(self, pos_xy: np.ndarray, yaw: float, speed: float
                         ) -> Tuple[np.ndarray, float, float]:
        """UKF-filter the raw GPS/IMU/speed measurement with the previous
        tick's control as process input. Returns (pos [2], yaw, speed)."""
        z = np.array([pos_xy[0], pos_xy[1], yaw, speed], float)
        if not self.ukf.initialized:
            self.ukf.init_state(z)
            return np.asarray(pos_xy, float), float(yaw), float(speed)
        steer, throttle, brake = self.last_control
        self.ukf.predict(steer, throttle, brake)
        self.ukf.update(z)
        x = self.ukf.x
        return x[:2].copy(), float(x[2]), float(max(x[3], 0.0))

    def build_prompt(self, frame: AgentFrame) -> Tuple[str, Dict[str, np.ndarray]]:
        speed_rounded = round(float(frame.speed), 1)
        tps = np.stack([frame.target_point, frame.next_target_point]
                       ).astype(np.float32)
        conditioning = "Target waypoint: <TARGET_POINT><TARGET_POINT>."
        task = ("What should the ego do next?" if self.cfg.use_cot
                else "Predict the waypoints.")
        prompt = f"Current speed: {speed_rounded} m/s. {conditioning} {task}"
        if frame.user_instruction:
            prompt = f"{frame.user_instruction} {prompt}"
        return prompt, {"<TARGET_POINT>": tps}

    def make_input(self, frame: AgentFrame) -> DrivingInput:
        prompt, placeholder_values = self.build_prompt(frame)
        n_img = self.model_cfg.vit.tokens_per_patch_image * 2
        chat = tokenize_chat(self.tok, prompt, None, n_img)
        label = batch_language_label(
            [chat], [{self.tok.convert_tokens_to_ids(k): v
                      for k, v in placeholder_values.items()}],
            self.tok.pad_token_id, self.max_prompt_len, pad_side="left"
        ).to(self.device)
        dev = self.device
        return DrivingInput(
            pixel_values=torch.from_numpy(np.ascontiguousarray(frame.rgb[None])).to(dev),
            vehicle_speed=torch.tensor([frame.speed], dtype=torch.float32, device=dev),
            target_point=torch.tensor(np.asarray(frame.target_point)[None],
                                      dtype=torch.float32, device=dev),
            prompt=label, prompt_inference=label)

    # ------------------------------------------------------------------
    def run_step(self, frame: AgentFrame) -> Dict[str, Any]:
        """One simulator tick -> control dict. Latency-instrumented."""
        t0 = time.perf_counter()
        self.step_count += 1
        if self.step_count <= self.cfg.initial_frames_delay:
            return {"steer": 0.0, "throttle": 0.0, "brake": True,
                    "route": np.zeros((20, 2)), "speed_wps": np.zeros((10, 2)),
                    "language": "", "latency_s": 0.0}
        if self.cfg.jpeg_roundtrip:
            import cv2
            ok, buf = cv2.imencode(".jpg", frame.rgb[:, :, ::-1])
            if ok:
                frame = dataclasses.replace(
                    frame, rgb=cv2.imdecode(buf, cv2.IMREAD_COLOR)[:, :, ::-1])

        di = self.make_input(frame)
        if self.cfg.use_cot:
            if self._draft_tables is not None:
                out, st = self._generate_spec(di, self._draft_tables)
                self.spec_stats.append((int(st["rounds"]), int(st["gen_len"])))
            else:
                out = self._generate(di)
        else:
            out = self._drive_only(di)
        route = out.route[0].double().cpu().numpy()
        speed_wps = out.speed_wps[0].double().cpu().numpy()
        language_tokens: List[int] = []
        if self.cfg.use_cot:
            n = int(out.language_lengths[0])
            language_tokens = out.language_tokens[0][:n].tolist()
            self.last_language = self.tok.decode(language_tokens)
            if self.cfg.speculative_cot and language_tokens:
                self._refresh_draft(language_tokens)

        steer, throttle, brake = self.controller.control_pid(
            route, float(frame.speed), speed_wps)
        if float(frame.speed) < 0.1:
            self.stuck_count += 1
        else:
            self.stuck_count = 0
        if self.stuck_count > self.cfg.stuck_threshold:
            self.creep_remaining = self.cfg.creep_duration
            self.stuck_count = 0
        if self.creep_remaining > 0:
            self.creep_remaining -= 1
            throttle, brake = self.cfg.creep_throttle, False

        latency = time.perf_counter() - t0
        self.latencies.append(latency)
        self.last_control = (steer, throttle, brake)
        if self._metric_file is not None:
            self._metric_file.write(json.dumps({
                "step": self.step_count, "steer": steer, "throttle": throttle,
                "brake": brake, "speed": float(frame.speed),
                "latency_ms": latency * 1e3, "language": self.last_language}) + "\n")
            self._metric_file.flush()
        return {"steer": steer, "throttle": throttle, "brake": brake,
                "route": route, "speed_wps": speed_wps,
                "language": self.last_language,
                "language_tokens": language_tokens, "latency_s": latency}

    def latency_stats(self) -> Dict[str, float]:
        lat = np.asarray(self.latencies[1:] or self.latencies)
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p90_ms": float(np.percentile(lat, 90) * 1e3),
                "mean_ms": float(lat.mean() * 1e3)}
