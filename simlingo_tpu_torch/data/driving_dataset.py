"""Driving/QA/commentary dataset: per-frame sample assembly.

Port copy of `simlingo_tpu/data/driving_dataset.py` (`RawSample` :43,
`DrivingDatasetConfig` :61, `DrivingDataset.get` :293) over the port's own
index, measurements, image path and decoder.

Behavioral counterpart of reference `Data_Driving`
(dataloader/dataset_driving.py): camera-shift augmentation using the recorded
augmentation pose, waypoint/route labels, commentary & VQA loading with
template augmentation and answer-dependent downsampling, task-mix prompt
selection with adaptive rebalancing every 10k samples, navigational
conditioning (target-point placeholders / command text / LMDrive templates).

TPU-framework difference: __getitem__ takes an explicit numpy RandomState so
the sample stream is deterministic and resumable (the reference relies on
global `random` inside forked torch workers).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from simlingo_tpu_torch.data import measurements as M
from simlingo_tpu_torch.data.image_pipe import preprocess_numpy
from simlingo_tpu_torch.data.index import SampleIndex, build_index

BORING_ANSWERS = (
    "There are no pedestrians.",
    "There is no traffic light",
    "No, the ego vehicle is not affected by a stop sign.",
    "No, the ego vehicle is not affected by a junction.",
    "There is no traffic light affecting the ego vehicle.",
    "There is no stop sign affecting the ego vehicle.",
    "There is no junction affecting the ego vehicle.",
    "It is not possible to tell",
    "There is no reason for the ego vehicle to brake.",
)


@dataclasses.dataclass
class RawSample:
    """Everything the collate needs, all numpy/python."""
    question: str
    answer: str
    placeholder_values: Dict[str, np.ndarray]   # token string -> [N, 2]
    image: np.ndarray                           # [NP, S, S, 3] float32
    waypoints: np.ndarray                       # [10, 2]
    waypoints_1d: np.ndarray                    # [10, 2]
    path: np.ndarray                            # [20, 2]
    target_points: np.ndarray                   # [2, 2]
    speed: float
    measurement_path: str
    dataset: str = "driving"
    qa_template: Optional[Tuple[str, str]] = None
    eval_infos: Optional[Dict] = None


@dataclasses.dataclass
class DrivingDatasetConfig:
    data_root: str
    split: str = "train"
    bucket_name: str = "all"
    bucket_path: Optional[str] = None
    hist_len: int = 1
    pred_len: int = 11
    num_route_points: int = 20
    skip_first_n_frames: int = 10
    cut_bottom_quarter: bool = True
    image_size: int = 448
    max_num_grid: int = 2
    use_commentary: bool = True
    use_qa: bool = True
    commentary_augmentation: bool = True
    qa_augmentation: bool = True
    img_shift_augmentation: bool = True
    img_shift_augmentation_prob: float = 0.5
    img_augmentation: bool = False
    img_augmentation_prob: float = 0.2
    route_as: str = "target_point_command"
    use_lmdrive_commands: bool = True
    template_dir: Optional[str] = None          # augmented_templates/*.json
    use_old_towns: bool = True
    use_town13: bool = True
    filter_infractions: bool = True
    seed: int = 42
    # ship raw uint8 frames; crop/resize/normalize/tile run fused on-device
    # inside the train step (north-star fused-preprocessing path). False
    # falls back to cv2-on-CPU per worker (the reference's layout).
    device_preprocess: bool = True


def _load_templates(template_dir: Optional[str], name: str) -> Dict:
    if template_dir is None:
        return {}
    path = os.path.join(template_dir, name)
    if not os.path.isfile(path):
        return {}
    with open(path) as f:
        return json.load(f)


class DrivingDataset:
    def __init__(self, cfg: DrivingDatasetConfig,
                 index: Optional[SampleIndex] = None):
        self.cfg = cfg
        self.index = index if index is not None else build_index(
            cfg.data_root, cfg.split, cfg.bucket_name, cfg.bucket_path,
            cfg.hist_len, cfg.pred_len, cfg.skip_first_n_frames,
            filter_infractions=cfg.filter_infractions,
            use_old_towns=cfg.use_old_towns, use_town13=cfg.use_town13,
            seed=cfg.seed)
        self.templates_commentary = _load_templates(
            cfg.template_dir, "commentary_augmented.json")
        self.q_augment = _load_templates(cfg.template_dir,
                                         "qa_augmented_questions.json")
        self.a_augment = _load_templates(cfg.template_dir,
                                         "qa_augmented_answers.json")
        self.command_templates = _load_templates(cfg.template_dir,
                                                 "lmdrive_commands.json")
        self.num_sampled_per_type = {"driving": 1, "qa": 1, "commentary": 1}
        self.prompt_probabilities = {"driving": 1 / 3, "qa": 1 / 3,
                                     "commentary": 1 / 3}

    def __len__(self) -> int:
        return len(self.index)

    # ------------------------------------------------------------------
    def _commentary(self, measurement_path: str, rng) -> Tuple[bool, str]:
        # parallel tree (reference layout) or in-route commentary/ dir
        path = measurement_path.replace("measurements", "commentary") \
                               .replace("/data/", "/commentary/")
        if not os.path.isfile(path):
            path = measurement_path.replace("measurements", "commentary")
        if "validation_" in path or not os.path.isfile(path):
            return False, ""
        try:
            cf = M.read_json_gz(path)
        except Exception:
            return False, ""
        commentary = cf.get("commentary", "")
        if (self.cfg.commentary_augmentation and rng.rand() < 0.6
                and cf.get("commentary_template") in self.templates_commentary):
            cand = self.templates_commentary[cf["commentary_template"]]
            aug = cand[rng.randint(len(cand))]
            for key, value in cf.get("placeholder", {}).items():
                if key in aug:
                    aug = aug.replace(key, value)
            if not re.search(r"<.*?>", aug):
                commentary = aug
        commentary = commentary.replace("..", ".").replace("in in", "in")
        return True, commentary

    def _qa(self, measurement_path: str, rng
            ) -> Tuple[bool, str, str, Optional[Tuple[str, str]]]:
        # parallel tree (reference layout) or in-route vqa/ dir
        path = measurement_path.replace("measurements", "vqa") \
                               .replace("/data/", "/drivelm/")
        if not os.path.isfile(path):
            path = measurement_path.replace("measurements", "vqa")
        if "validation_" in path or not os.path.isfile(path):
            return False, "", "", None
        try:
            qa_file = M.read_json_gz(path)
        except Exception:
            return False, "", "", None
        qas = [item for sub in qa_file["QA"].values() for item in sub]
        if not qas:
            return False, "", "", None
        # boring-answer downsampling to 20% (reference :137-157)
        for _ in range(100):
            chosen = qas[rng.randint(len(qas))]
            q, a = chosen["Q"], chosen["A"]
            if any(b in a for b in BORING_ANSWERS):
                if rng.rand() < 0.2:
                    break
            else:
                break
        template = (q, a)
        if self.cfg.qa_augmentation and rng.rand() < 0.6:
            q, a = self._augment_qa(q, a, qa_file, rng)
        return True, q, a, template

    def _augment_qa(self, q: str, a: str, qa_file: Dict, rng
                    ) -> Tuple[str, str]:
        """Placeholder-based paraphrase augmentation (reference :162-229)."""
        locations = [
            "nearby to the front of the ego vehicle",
            "nearby to the front right of the ego vehicle",
            "nearby to the front left of the ego vehicle",
            "nearby on the left side of the ego vehicle",
            "far to the front left of the ego vehicle",
            "far to the front right of the ego vehicle",
            "far to the front of the ego vehicle",
            "far to the left side of the ego vehicle",
            "far to the right side of the ego vehicle",
            "to the front of the ego vehicle",
            "to the front right of the ego vehicle",
            "to the front left of the ego vehicle",
            "on the left side of the ego vehicle",
            "on the right side of the ego vehicle",
        ]
        q_org, a_org = q, a
        objects = [v["Visual_description"]
                   for v in qa_file.get("key_object_infos", {}).values()]
        q_objects, a_objects = [], []
        for obj in objects:
            if obj in q:
                q = q.replace(obj, "<OBJECT>")
                q_objects.append(obj)
            if obj in a:
                a = a.replace(obj, "<OBJECT>")
                a_objects.append(obj)
        q_loc = a_loc = ""
        for loc in locations:
            if loc in q:
                q = q.replace(loc, "<LOCATION>")
                q_loc = loc
            if loc in a:
                a = a.replace(loc, "<LOCATION>")
                a_loc = loc
        q_dist = re.search(r"in (\d+) m", q_org)
        q = re.sub(r"in \d+ m", "in <DISTANCE>", q)
        a_dist = re.search(r"in (\d+) m", a_org)
        a = re.sub(r"in \d+ m", "in <DISTANCE>", a)
        if not q_objects:
            q_objects = [""]
        if not a_objects:
            a_objects = [""]
        if len(q_objects) > 1 or len(a_objects) > 1 or rng.rand() < 0.4:
            return q_org, a_org
        if q in self.q_augment:
            cand = self.q_augment[q]
            q = cand[rng.randint(len(cand))] \
                .replace("<OBJECT>", q_objects[0]).replace("<LOCATION>", q_loc)
            if q_dist:
                q = q.replace("<DISTANCE>", q_dist.group(1))
        else:
            q = q_org
        if a in self.a_augment:
            cand = self.a_augment[a]
            a = cand[rng.randint(len(cand))] \
                .replace("<OBJECT>", a_objects[0]).replace("<LOCATION>", a_loc)
            if a_dist:
                a = a.replace("<DISTANCE>", a_dist.group(1))
        else:
            a = a_org
        return q, a

    def _navigational_conditioning(self, current: Dict,
                                   target_point: np.ndarray,
                                   next_target_point: np.ndarray, rng
                                   ) -> Tuple[List[str], Dict[str, np.ndarray],
                                              np.ndarray]:
        """Reference get_navigational_conditioning (dataset_base.py:484-540)."""
        cfg = self.cfg
        placeholder_values: Dict[str, np.ndarray] = {}
        target_options: List[str] = []
        tps = np.stack([target_point, next_target_point])
        tp1 = np.round(tps[0], 2).tolist()
        tp2 = np.round(tps[1], 2).tolist()

        if "target_point" in cfg.route_as:
            if "target_point_language" in cfg.route_as:
                target_options.append(
                    f"Target waypoint: 1:{tp1} 2:{tp2}")
            else:
                target_options.append(
                    "Target waypoint: <TARGET_POINT><TARGET_POINT>.")
                placeholder_values["<TARGET_POINT>"] = tps
        if "command" in cfg.route_as:
            dist = int(np.linalg.norm(target_point))
            command = M.COMMAND_MAP[current["command"]]
            next_command = M.COMMAND_MAP[current["next_command"]]
            next_command = (f" then {next_command}"
                            if command != next_command else "")
            if current["command"] == 4:
                target_options.append(f"Command: {command}{next_command}.")
            else:
                target_options.append(
                    f"Command: {command} in {dist} meter{next_command}.")
            if cfg.use_lmdrive_commands and self.command_templates:
                idxs = M.COMMAND_TEMPLATE_MAPPINGS[current["command"]]
                key = str(idxs[rng.randint(len(idxs))])
                if key in self.command_templates:
                    cand = self.command_templates[key]
                    lm = cand[rng.randint(len(cand))].replace("[x]", str(dist))
                    target_options.append(f"Command: {lm}.")
        return target_options, placeholder_values, tps

    # ------------------------------------------------------------------
    def get(self, i: int, rng: np.random.RandomState,
            force_qa: Optional[Tuple[str, str]] = None) -> RawSample:
        """force_qa: evaluation mode -- use this exact (question, answer)
        instead of sampling (reference Data_Eval pins the evalset's QA
        template, dataset_eval_qa_comm.py)."""
        cfg = self.cfg
        route_dir = self.index.route_dir(i)
        start = int(self.index.frame[i])

        loaded, current, cur_path = M.load_measurement_window(
            route_dir, start, cfg.hist_len, cfg.pred_len)

        augment_sample = (bool(self.index.has_augmented[i])
                          and cfg.img_shift_augmentation
                          and rng.rand() <= cfg.img_shift_augmentation_prob)
        aug_rot = current["augmentation_rotation"] if augment_sample else 0.0
        aug_trans = current["augmentation_translation"] if augment_sample else 0.0

        wp = M.waypoints_labels(loaded, cfg.hist_len, aug_trans, aug_rot)
        routes = M.route_labels(current, cfg.num_route_points, aug_trans,
                                aug_rot)

        target_point = M.rotate_translate(
            np.asarray(current["target_point"], np.float64)[None],
            aug_trans, aug_rot)[0]
        next_target_point = M.rotate_translate(
            np.asarray(current["target_point_next"], np.float64)[None],
            aug_trans, aug_rot)[0]

        target_options, placeholder_values, tps = \
            self._navigational_conditioning(current, target_point,
                                            next_target_point, rng)

        speed_rounded = round(current["speed"], 1)

        # ---- task mix (reference dataset_driving.py:236-269) ----
        commentary_exists, commentary = ((False, "") if not cfg.use_commentary
                                         else self._commentary(cur_path, rng))
        qa_exists, qa_q, qa_a, qa_template = ((False, "", "", None)
                                              if not cfg.use_qa
                                              else self._qa(cur_path, rng))
        p = rng.rand()
        probs = self.prompt_probabilities
        opt = target_options[rng.randint(len(target_options))]
        if force_qa is not None:
            qa_q, qa_a = force_qa
            prompt = f"Current speed: {speed_rounded} m/s. {opt} Q: {qa_q}"
            answer = f"A: {qa_a}"
            qa_template = force_qa
        elif cfg.use_commentary and commentary_exists and p < probs["commentary"]:
            if rng.rand() < 0.2:
                if rng.rand() < 0.5:
                    prompt = (f"Current speed: {speed_rounded} m/s. {opt} "
                              f"{commentary} Predict the waypoints.")
                else:
                    prompt = (f"Current speed: {speed_rounded} m/s. "
                              f"Command: {commentary} Predict the waypoints.")
                answer = "Waypoints:"
            else:
                prompt = (f"Current speed: {speed_rounded} m/s. {opt} "
                          f"What should the ego do next?")
                answer = f"{commentary} Waypoints:"
            self.num_sampled_per_type["commentary"] += 1
        elif cfg.use_qa and qa_exists and p < probs["qa"] + probs["commentary"]:
            prompt = f"Current speed: {speed_rounded} m/s. {opt} Q: {qa_q}"
            answer = f"A: {qa_a}"
            self.num_sampled_per_type["qa"] += 1
        else:
            prompt = (f"Current speed: {speed_rounded} m/s. {opt} "
                      f"Predict the waypoints.")
            answer = "Waypoints:"
            self.num_sampled_per_type["driving"] += 1

        total = sum(self.num_sampled_per_type.values())
        if total > 10000 and total % 10000 == 0:
            inv = {k: 1 / v for k, v in self.num_sampled_per_type.items()}
            s = sum(inv.values())
            self.prompt_probabilities = {k: v / s for k, v in inv.items()}

        prompt = prompt.replace("..", ".")
        answer = answer.replace("..", ".")

        # ---- image ----
        from simlingo_tpu_torch.data.imageio import load_rgb, load_rgb_preprocessed
        img_path = os.path.join(route_dir, "rgb", f"{start + cfg.hist_len - 1:04}.jpg")
        if augment_sample:
            img_path = img_path.replace("rgb", "rgb_augmented")
        tiles = None
        if not cfg.device_preprocess and not cfg.img_augmentation:
            # no CPU-side augmentation between decode and preprocess: the
            # whole decode->crop->resize->normalize->tile path can run as one
            # native (C++/libjpeg, GIL-free) call; None => fall through
            tiles = load_rgb_preprocessed(
                img_path, cfg.image_size, cfg.max_num_grid,
                do_bottom_crop=cfg.cut_bottom_quarter)
        if tiles is None:
            img = load_rgb(img_path)
            if cfg.img_augmentation:
                from simlingo_tpu_torch.data.augment import image_augmenter
                img = image_augmenter(img, rng, cfg.img_augmentation_prob)
            if cfg.device_preprocess:
                # ship the raw uint8 frame; crop/resize/normalize/tile run
                # fused on-device inside the train step (models/simlingo.py)
                tiles = np.ascontiguousarray(img, dtype=np.uint8)
            else:
                tiles = preprocess_numpy(img, cfg.image_size,
                                         cfg.max_num_grid,
                                         do_bottom_crop=cfg.cut_bottom_quarter)

        return RawSample(
            question=prompt, answer=answer,
            placeholder_values=placeholder_values,
            image=tiles,
            waypoints=np.asarray(wp["waypoints"], np.float32),
            waypoints_1d=np.asarray(wp["waypoints_1d"], np.float32),
            path=np.asarray(routes["route_adjusted"], np.float32),
            target_points=np.asarray(tps, np.float32),
            speed=float(current["speed"]),
            measurement_path=cur_path,
            qa_template=qa_template)
