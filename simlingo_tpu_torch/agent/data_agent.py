"""Data-collection agent: expert + sensor saving.

Copy of `simlingo_tpu/agent/data_agent.py`, with one difference by design:
under SAVE_TF_LABELS a BEV render that fails raises, where JAX's collector
passes over it (`except Exception: pass`), so that no frame's label set is
written without its raster in silence.

Behavioral counterpart of reference `team_code/data_agent.py` (DataAgent):
wraps the privileged expert (expert/autopilot.py) with sensor capture --
normal + pose-augmented RGB cameras, GT boxes, results.json.gz on destroy --
writing the dataset layout the training pipeline consumes
(rgb/NNNN.jpg, rgb_augmented/NNNN.jpg, boxes/NNNN.json.gz,
measurements/NNNN.json.gz, results.json.gz).

The simulator-independent core (`DataCollector`) is testable offline; the
CARLA leaderboard plugin at the bottom wires it to live sensors.
"""

from __future__ import annotations

import gzip
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from simlingo_tpu_torch.expert.autopilot import AutoPilot, ExpertObservation


class DataCollector:
    """Saves one frame of sensors + expert labels every data_save_freq ticks
    (reference data_agent.py:455-496, 4 Hz at 20 FPS)."""

    def __init__(self, save_path: str, data_save_freq: int = 5,
                 camera_aug_rotation_range: float = 5.0,
                 camera_aug_translation_range: float = 1.0,
                 seed: int = 0,
                 save_lidar: bool = True,
                 save_labels: Optional[bool] = None):
        self.save_path = save_path
        self.data_save_freq = data_save_freq
        self.rng = np.random.RandomState(seed)
        self.aug_rot_range = camera_aug_rotation_range
        self.aug_trans_range = camera_aug_translation_range
        self.expert = AutoPilot(save_path=save_path,
                                data_save_freq=data_save_freq)
        # SAVE_TF_LABELS-style gate for semantics/depth/BEV (reference
        # data_agent.py:170-277 only attaches those sensors when enabled)
        if save_labels is None:
            save_labels = os.environ.get("SAVE_TF_LABELS", "0") == "1"
        self.save_labels = save_labels
        self.save_lidar_enabled = save_lidar
        subs = ["rgb", "rgb_augmented", "boxes", "measurements"]
        if save_lidar:
            subs.append("lidar")
        if save_labels:
            subs += ["semantics", "depth", "bev_semantics"]
        for sub in subs:
            os.makedirs(os.path.join(save_path, sub), exist_ok=True)
        self.tick_count = 0
        # LiDAR half-sweep state (reference :304-330)
        self._lidar_prev_half: Optional[np.ndarray] = None
        self._lidar_prev_pose: Optional[tuple] = None
        # per-route weather (reference shuffles weather, :434-453)
        from simlingo_tpu_torch.agent.lidar import sample_weather
        self.weather = sample_weather(self.rng)

    def sample_camera_augmentation(self) -> Dict[str, float]:
        """Per-frame camera pose augmentation (reference :389-402)."""
        return {
            "rotation": float(self.rng.uniform(-self.aug_rot_range,
                                               self.aug_rot_range)),
            "translation": float(self.rng.uniform(-self.aug_trans_range,
                                                  self.aug_trans_range)),
        }

    def tick(self, obs: ExpertObservation, rgb: Optional[np.ndarray] = None,
             rgb_augmented: Optional[np.ndarray] = None,
             boxes: Sequence[Dict] = (),
             scenario_result=None,
             lidar_half_sweep: Optional[np.ndarray] = None,
             semantics: Optional[np.ndarray] = None,
             depth: Optional[np.ndarray] = None,
             extra_measurements: Optional[Dict] = None,
             aug: Optional[Dict[str, float]] = None) -> Dict:
        """Run the expert; persist sensors on save frames.

        lidar_half_sweep: ego-frame points of THIS tick's half revolution
        (CARLA lidar spins at 10 Hz vs 20 Hz ticks); realigned with the
        previous half before saving (reference data_agent.py:304-330).
        aug: pre-sampled camera augmentation (a caller that renders the
        augmented view itself must sample BEFORE rendering and pass it in
        so the saved labels match the rendered pose); None samples here.
        """
        aug = aug or self.sample_camera_augmentation()
        obs.augmentation_rotation = aug["rotation"]
        obs.augmentation_translation = aug["translation"]
        out = self.expert.tick(obs, scenario_result=scenario_result,
                               extra_measurements=extra_measurements)

        full_sweep = None
        if lidar_half_sweep is not None and self.save_lidar_enabled:
            from simlingo_tpu_torch.agent import lidar as L
            pose = (np.asarray(obs.pos_global, float), float(obs.theta))
            prev_pose = self._lidar_prev_pose or pose
            full_sweep = L.realign_half_sweeps(
                self._lidar_prev_half, lidar_half_sweep,
                pos_prev=prev_pose[0], yaw_prev=prev_pose[1],
                pos_cur=pose[0], yaw_cur=pose[1])
            self._lidar_prev_half = np.asarray(lidar_half_sweep, float)
            self._lidar_prev_pose = pose

        if (self.tick_count % self.data_save_freq) == 0:
            frame = self.tick_count // self.data_save_freq
            if rgb is not None:
                self._save_jpg("rgb", frame, rgb)
            if rgb_augmented is not None:
                self._save_jpg("rgb_augmented", frame, rgb_augmented)
            with gzip.open(os.path.join(self.save_path, "boxes",
                                        f"{frame:04}.json.gz"), "wt") as f:
                json.dump(list(boxes), f)
            if full_sweep is not None:
                from simlingo_tpu_torch.agent import lidar as L
                L.save_lidar(os.path.join(self.save_path, "lidar",
                                          f"{frame:04}"), full_sweep)
            if self.save_labels:
                import cv2
                if semantics is not None:
                    cv2.imwrite(os.path.join(self.save_path, "semantics",
                                             f"{frame:04}.png"), semantics)
                if depth is not None:
                    if depth.ndim == 3:
                        # raw CARLA 24-bit encoded depth: decode to the
                        # reference's 8-bit normalized map
                        # (data_agent.py:285-290)
                        from simlingo_tpu_torch.utils.geometry import convert_depth
                        depth = (convert_depth(depth) * 255.0 + 0.5).astype(
                            np.uint8)
                    elif depth.dtype != np.uint8:
                        # metric float depth (microsim camera): store as
                        # uint16 centimetres (1 cm resolution to 655 m)
                        depth = np.clip(np.asarray(depth, np.float64)
                                        * 100.0, 0, 65535).astype(
                                            np.uint16)
                    cv2.imwrite(os.path.join(self.save_path, "depth",
                                             f"{frame:04}.png"), depth)
                # BEV semantic raster from privileged boxes + route; a
                # failure raises (JAX's collector swallows it and writes
                # the frame without its raster)
                from simlingo_tpu_torch.labels.bev_renderer import render_bev
                bev = render_bev(out["record"], list(boxes))
                np.savez_compressed(
                    os.path.join(self.save_path, "bev_semantics",
                                 f"{frame:04}.npz"), bev=bev)
        self.tick_count += 1
        return out

    def _save_jpg(self, sub: str, frame: int, img: np.ndarray) -> None:
        import cv2
        path = os.path.join(self.save_path, sub, f"{frame:04}.jpg")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))

    def destroy(self, route_completion: float = 100.0,
                infractions: Optional[Dict[str, List]] = None) -> None:
        """Write results.json.gz (reference :489-496) -- the quality gate
        input consumed by data.index.route_passes_quality_gate."""
        infractions = infractions or {"min_speed_infractions": [],
                                      "outside_route_lanes": []}
        from simlingo_tpu_torch.eval.driving_score import driving_score
        score = driving_score(route_completion, infractions)
        results = {
            "scores": {"score_composed": score,
                       "score_route": route_completion},
            "num_infractions": sum(len(v) for v in infractions.values()),
            "infractions": infractions,
        }
        with gzip.open(os.path.join(self.save_path, "results.json.gz"),
                       "wt") as f:
            json.dump(results, f)
