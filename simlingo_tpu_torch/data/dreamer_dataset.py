"""Dreamer dataset: instruction-following with alternative trajectories.

Port copy of `simlingo_tpu/data/dreamer_dataset.py`.

Behavioral counterpart of reference `Data_Dreamer`
(dataloader/dataset_dreamer.py): loads alternative-trajectory files
(dreamer/**.json.gz), picks a random mode option, 50/50 `<SAFETY>` vs
`<INSTRUCTION_FOLLOWING>` prefix when use_safety_flag; for unsafe options
under `<SAFETY>` the labels revert to the original expert waypoints/route and
the answer becomes the refusal text `dreamer_answer_safety`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from simlingo_tpu_torch.data import measurements as M
from simlingo_tpu_torch.data.driving_dataset import (DrivingDataset,
                                               DrivingDatasetConfig,
                                               RawSample)
from simlingo_tpu_torch.data.image_pipe import preprocess_numpy
from simlingo_tpu_torch.data.index import build_index


@dataclasses.dataclass
class DreamerDatasetConfig(DrivingDatasetConfig):
    use_safety_flag: bool = True
    dreamer_folder: str = "dreamer"


class DreamerDataset(DrivingDataset):
    def __init__(self, cfg: DreamerDatasetConfig, index=None):
        if not isinstance(cfg, DreamerDatasetConfig):
            cfg = DreamerDatasetConfig(
                **{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(DrivingDatasetConfig)})
        if index is None:
            index = build_index(
                cfg.data_root, cfg.split, cfg.bucket_name, cfg.bucket_path,
                cfg.hist_len, cfg.pred_len, cfg.skip_first_n_frames,
                filter_infractions=cfg.filter_infractions,
                use_old_towns=cfg.use_old_towns, use_town13=cfg.use_town13,
                dreamer=True, dreamer_folder=cfg.dreamer_folder,
                seed=cfg.seed)
        super().__init__(cfg, index=index)

    def get(self, i: int, rng: np.random.RandomState) -> RawSample:
        cfg = self.cfg
        route_dir = self.index.route_dir(i)
        start = int(self.index.frame[i])
        loaded, current, cur_path = M.load_measurement_window(
            route_dir, start, cfg.hist_len, cfg.pred_len)

        activate_safety: Optional[bool] = None
        if cfg.use_safety_flag:
            activate_safety = bool(rng.rand() < 0.5)

        # alternatives are computed for the unaugmented view only
        wp = M.waypoints_labels(loaded, cfg.hist_len, 0.0, 0.0)
        routes = M.route_labels(current, cfg.num_route_points, 0.0, 0.0)

        target_point = np.asarray(current["target_point"], np.float64)
        next_target_point = np.asarray(current["target_point_next"],
                                       np.float64)
        target_options, placeholder_values, tps = \
            self._navigational_conditioning(current, target_point,
                                            next_target_point, rng)

        alt_path = cur_path.replace("measurements", cfg.dreamer_folder) \
                           .replace("/data/", f"/{cfg.dreamer_folder}/")
        if not os.path.isfile(alt_path):
            # in-route layout: route_dir/dreamer/NNNN.json.gz
            alt_path = cur_path.replace("measurements", cfg.dreamer_folder)
        alternatives = M.read_json_gz(alt_path)
        options = []
        for key, option in alternatives.items():
            if "factor" in key:
                continue
            options.extend(option)
        chosen = dict(options[rng.randint(len(options))])

        route = (routes["route_adjusted_org"] if chosen["route"] == "org"
                 else np.asarray(chosen["route"], np.float64))
        waypoints = (wp["waypoints_org"] if chosen["waypoints"] == "org"
                     else np.asarray(chosen["waypoints"], np.float64))
        instrs = chosen["dreamer_instruction"]
        instruction = instrs[rng.randint(len(instrs))] \
            if isinstance(instrs, list) else instrs

        dreamer_answer = "Following the given instruction. Waypoints:"
        if activate_safety and not chosen.get("safe_to_execute", True):
            dreamer_answer = chosen["dreamer_answer_safety"]

        speed_rounded = round(current["speed"], 1)
        if rng.rand() < 0.8:
            opt = target_options[rng.randint(len(target_options))]
            prompt = f"Current speed: {speed_rounded} m/s. {opt} {instruction}"
        else:
            prompt = f"Current speed: {speed_rounded} m/s. {instruction}"

        wps_zero = np.concatenate([np.zeros((1, 2)), waypoints], axis=0)
        d1 = np.cumsum([np.linalg.norm(wps_zero[j + 1] - wps_zero[j])
                        for j in range(len(wps_zero) - 1)])
        waypoints_1d = np.asarray([[x, 0.0] for x in d1]).reshape(-1, 2)
        path = route

        prompt = (prompt.replace("..", ".").replace("  ", " ")
                  .replace("!.", "!").replace("?.", "?"))

        if activate_safety is not None:
            if activate_safety:
                prompt = f"<SAFETY> {prompt}"
                if not chosen.get("safe_to_execute", True):
                    waypoints = wp["waypoints_org"]
                    waypoints_1d = wp["waypoints_1d"]
                    path = routes["route_adjusted_org"]
            else:
                prompt = f"<INSTRUCTION_FOLLOWING> {prompt}"

        from simlingo_tpu_torch.data.imageio import load_rgb
        img_path = os.path.join(route_dir, "rgb",
                                f"{start + cfg.hist_len - 1:04}.jpg")
        img = load_rgb(img_path)
        if getattr(cfg, "device_preprocess", False):
            tiles = np.ascontiguousarray(img, dtype=np.uint8)
        else:
            tiles = preprocess_numpy(img, cfg.image_size, cfg.max_num_grid,
                                     do_bottom_crop=cfg.cut_bottom_quarter)

        return RawSample(
            question=prompt, answer=dreamer_answer,
            placeholder_values=placeholder_values,
            image=tiles,
            waypoints=np.asarray(waypoints, np.float32),
            waypoints_1d=np.asarray(waypoints_1d, np.float32),
            path=np.asarray(path, np.float32),
            target_points=np.asarray(tps, np.float32),
            speed=float(current["speed"]),
            measurement_path=cur_path,
            dataset="dreamer",
            eval_infos={
                "mode": chosen.get("mode"),
                "allowed": chosen.get("safe_to_execute", True),
                "org_wps": np.asarray(wp["waypoints_org"]).tolist(),
                "org_path": np.asarray(routes["route_adjusted_org"]).tolist(),
                "new_wps": np.asarray(waypoints).tolist(),
                "new_path": np.asarray(path).tolist(),
            })
