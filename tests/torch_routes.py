"""A small CARLA dataset on disk for the port's data and trainer tests.

Routes are written by `tests.test_data_pipeline._write_route` (1024 x 512
JPEG frames of seeded noise, gz JSON measurements, results.json.gz) and
labelled by the JAX package's own generators (`labels.commentary`,
`labels.vqa`, `labels.dreamer_gen`), so nothing here needs a download.
Each training route also gets `rgb_augmented/` frames (the camera-shift
augmentation) and the dataset gets a template directory, so every
augmentation branch of the datasets has something to draw.
"""

import json
import os

import numpy as np

TRAIN_ROUTES = ("v1/b0/routes_training/Town12_Rep0_0", "v1/b0/routes_training/Town12_Rep0_1")
CRASHED_ROUTE = "v1/b0/routes_training/Town12_Rep0_2"
VAL_ROUTE = "v1/b0/routes_validation/Town13_Rep0_0"


def _augmented_frames(route: str) -> None:
    """rgb_augmented/: each frame mirrored left-right."""
    import cv2
    os.makedirs(os.path.join(route, "rgb_augmented"), exist_ok=True)
    for name in sorted(os.listdir(os.path.join(route, "rgb"))):
        img = cv2.imread(os.path.join(route, "rgb", name))
        cv2.imwrite(os.path.join(route, "rgb_augmented", name), img[:, ::-1])


def _templates(root: str, routes) -> str:
    """Paraphrase tables for every commentary template and QA pair the
    generators wrote, and LMDrive command templates for every command."""
    import gzip
    comm, qs, ans = {}, {}, {}
    for route in routes:
        for kind in ("commentary", "vqa"):
            d = os.path.join(route, kind)
            for name in sorted(os.listdir(d)) if os.path.isdir(d) else ():
                with gzip.open(os.path.join(d, name), "rt") as f:
                    data = json.load(f)
                if kind == "commentary":
                    t = data.get("commentary_template")
                    if t:
                        comm[t] = [f"In short: {t}", f"{t} Nothing else."]
                    continue
                for items in data["QA"].values():
                    for qa in items:
                        qs[qa["Q"]] = [f"Tell me: {qa['Q']}", f"{qa['Q']} Answer briefly."]
                        ans[qa["A"]] = [f"Well, {qa['A']}"]
    cmds = {str(i): [f"proceed as told ({i}) within [x] m", f"command {i} in [x] meters"]
            for i in range(46)}
    tdir = os.path.join(root, "templates")
    os.makedirs(tdir, exist_ok=True)
    for name, table in (("commentary_augmented.json", comm),
                        ("qa_augmented_questions.json", qs),
                        ("qa_augmented_answers.json", ans),
                        ("lmdrive_commands.json", cmds)):
        with open(os.path.join(tdir, name), "w") as f:
            json.dump(table, f)
    return tdir


def write_dataset(root: str, n_frames: int = 36, n_val_frames: int = 30) -> str:
    """Two labelled training routes with augmented frames, a crashed route
    (rejected by the quality gate) and a labelled validation route; returns
    the template directory."""
    from simlingo_tpu.labels import commentary, dreamer_gen, vqa
    from tests.test_data_pipeline import _write_route
    routes = [_write_route(root, rel, n_frames=n_frames, seed=i)
              for i, rel in enumerate(TRAIN_ROUTES)]
    _write_route(root, CRASHED_ROUTE, n_frames=n_frames, crashed=True, seed=7)
    val = _write_route(root, VAL_ROUTE, n_frames=n_val_frames, seed=9)
    for route in routes + [val]:
        commentary.generate_route_commentary(route)
        vqa.generate_route_vqa(route)
    for route in routes:
        dreamer_gen.generate_route_dreamer(route)
        _augmented_frames(route)
    return _templates(root, routes)


def data_overrides(root: str, template_dir: str, batch_size: int = 3):
    """Dotted overrides, the same for both packages' `compose`: the disk
    path with the dreamer mix, every augmentation on, the routes split by
    their directory names (use_town13 false)."""
    return [f"data.data_root={root}", f"data.batch_size={batch_size}", "data.num_workers=2",
            "data.use_dreamer=true", "data.max_text_len=768",
            f"data.base.template_dir={template_dir}", "data.base.use_town13=false",
            "data.base.img_augmentation=true", "data.base.img_augmentation_prob=0.5",
            "data.base.img_shift_augmentation_prob=0.5",
            "data.base.route_as=target_point_command", "data.base.image_size=56"]


def partitions() -> dict:
    return {"all": 0.6, "junction": 0.4}


def np_tree(x):
    """A JAX / torch batch field as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)
