"""Dataset index: route discovery, quality gate, splits, bucket filtering.

Port copy of `simlingo_tpu/data/index.py` (`route_passes_quality_gate` :45,
`discover_routes` :65, `load_bucket_paths` :95, `build_index` :115).

Behavioral counterpart of reference `BaseDataset.__init__` index building
(dataset_base.py:143-346): glob route dirs, reject crashed/imperfect routes
via results.json.gz (score_composed < 100 allowed only when the sole
infractions are min-speed / outside-route-lanes with route score > 94),
train=routes_training / val=routes_validation split, optional bucket lists
from buckets_paths.pkl, per-frame sample enumeration skipping warmup frames.

TPU-framework difference: the index is a flat numpy structure-of-arrays
(paths as fixed-width bytes) -- cheap to fork into dataloader workers, and
deterministic (sorted glob + seeded shuffle) so sampling is resumable.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from typing import List, Optional

import numpy as np

from simlingo_tpu_torch.data.measurements import read_json_gz


@dataclasses.dataclass
class SampleIndex:
    """Flat index: one entry per trainable frame."""
    route_dirs: np.ndarray      # [R] bytes -- unique route dirs
    route_id: np.ndarray        # [N] int32 -- index into route_dirs
    frame: np.ndarray           # [N] int32 -- start frame
    has_augmented: np.ndarray   # [N] bool  -- rgb_augmented exists

    def __len__(self) -> int:
        return len(self.route_id)

    def route_dir(self, i: int) -> str:
        return self.route_dirs[self.route_id[i]].decode("utf-8")


def route_passes_quality_gate(route_dir: str) -> bool:
    """results.json.gz gate (reference dataset_base.py:232-264)."""
    path = os.path.join(route_dir, "results.json.gz")
    if not os.path.isfile(path):
        return False
    try:
        results = read_json_gz(path)
    except Exception:
        return False
    scores = results.get("scores", {})
    if scores.get("score_composed", 0.0) >= 100.0:
        return True
    cond1 = scores.get("score_route", 0.0) > 94.0
    infra = results.get("infractions", {})
    benign = (len(infra.get("min_speed_infractions", []))
              + len(infra.get("outside_route_lanes", [])))
    cond2 = results.get("num_infractions", -1) == benign
    return bool(cond1 and cond2)


def discover_routes(data_root: str, split: str = "train",
                    use_old_towns: bool = True,
                    use_town13: bool = True,
                    dreamer: bool = False,
                    seed: int = 42) -> List[str]:
    """Route-dir discovery + split (reference dataset_base.py:190-217)."""
    pattern = os.path.join(data_root, "data", "simlingo", "*", "*", "*", "Town*")
    route_dirs = sorted(glob.glob(pattern))
    if not use_old_towns:
        route_dirs = [r for r in route_dirs if "lb1_split" not in r]

    rng = np.random.RandomState(seed)
    rng.shuffle(route_dirs)

    if dreamer or not use_town13:
        if split == "train":
            route_dirs = [r for r in route_dirs if "routes_training" in r]
        elif split == "val":
            route_dirs = [r for r in route_dirs if "routes_validation" in r]
            # reference dataset_base.py:211 keeps 2% of the validation routes
            # (val is only a loss curve); floor at 1 so a small dataset still
            # validates rather than silently skipping the loop
            if route_dirs:
                route_dirs = route_dirs[:max(1, int(0.02 * len(route_dirs)))]
    else:
        cut = int(0.99 * len(route_dirs))
        route_dirs = route_dirs[:cut] if split == "train" else route_dirs[cut:]
    return route_dirs


def load_bucket_paths(bucket_path: str, bucket_name: str) -> Optional[set]:
    """buckets_paths.pkl: {bucket: [measurement file paths]}. Returns the set
    of (route_dir, frame) keys in the bucket, or None for 'all'."""
    if bucket_name in (None, "all", "all_dreamer"):
        return None
    pkl = os.path.join(bucket_path, "buckets_paths.pkl")
    if not os.path.isfile(pkl):
        return None
    with open(pkl, "rb") as f:
        buckets = pickle.load(f)
    if bucket_name not in buckets:
        return None
    keys = set()
    for p in buckets[bucket_name]:
        d = os.path.dirname(os.path.dirname(p))
        frame = int(os.path.basename(p).split(".")[0])
        keys.add((d, frame))
    return keys


def build_index(data_root: str, split: str = "train",
                bucket_name: str = "all",
                bucket_path: Optional[str] = None,
                hist_len: int = 1, pred_len: int = 11,
                skip_first_n_frames: int = 10,
                rgb_folder: str = "rgb",
                filter_infractions: bool = True,
                use_old_towns: bool = True, use_town13: bool = True,
                dreamer: bool = False,
                dreamer_folder: str = "dreamer",
                seed: int = 42) -> SampleIndex:
    routes = discover_routes(data_root, split, use_old_towns, use_town13,
                             dreamer, seed)
    bucket_keys = load_bucket_paths(bucket_path, bucket_name) \
        if bucket_path else None

    kept_routes: List[str] = []
    route_id: List[int] = []
    frames: List[int] = []
    has_aug: List[bool] = []

    for route_dir in routes:
        if dreamer:
            # parallel tree (<root>/<dreamer_folder>/... mirroring /data/,
            # reference dataset_base.py:228) or in-route route_dir/dreamer/
            ddir = route_dir.replace("/data/", f"/{dreamer_folder}/")
            if not (os.path.exists(ddir)
                    or os.path.isdir(os.path.join(route_dir, dreamer_folder))):
                continue
        if filter_infractions and not route_passes_quality_gate(route_dir):
            continue
        rgb_dir = os.path.join(route_dir, rgb_folder)
        if not os.path.isdir(rgb_dir):
            continue
        num_seq = len(os.listdir(rgb_dir))
        aug_dir_exists = os.path.isdir(os.path.join(route_dir, "rgb_augmented"))
        rid = len(kept_routes)
        kept_routes.append(route_dir)
        for seq in range(skip_first_n_frames,
                         num_seq - pred_len - hist_len - 1):
            if bucket_keys is not None and (route_dir, seq) not in bucket_keys:
                continue
            route_id.append(rid)
            frames.append(seq)
            has_aug.append(aug_dir_exists)

    return SampleIndex(
        route_dirs=np.asarray([r.encode("utf-8") for r in kept_routes]),
        route_id=np.asarray(route_id, np.int32),
        frame=np.asarray(frames, np.int32),
        has_augmented=np.asarray(has_aug, bool))
