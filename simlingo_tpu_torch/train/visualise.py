"""Training-time visualisation: waypoint / route grids, a text panel and a
camera overlay, saved as PNGs under the run directory.

Port copy of `simlingo_tpu/train/visualise.py`, with the camera model of
`simlingo_tpu/utils/geometry.py` (`camera_intrinsics`, `camera_extrinsics`,
`project_points`) copied in. It reads the port's batches (torch tensors,
moved to the host here); a raw uint8 frame is drawn as it is. matplotlib
and PIL are imported where a figure is drawn: where they are missing, the
trainer reports "visualise failed" and trains on, as JAX does.

Every N steps: a grid (up to 16 examples, 4 columns) of predicted (blue)
vs ground-truth (green) vs input (red) waypoints, the same for the route,
the ground-truth language, and the predicted waypoints projected onto the
first example's camera image (FOV 110, camera at (-1.5, 0, 2)); logged
through the trainer logger's `log_image` as well.
"""

from __future__ import annotations

import math
import os
import textwrap
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

# ImageNet statistics used by the preprocessing pipeline (for un-normalizing
# tiles back to displayable uint8)
_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _np(x) -> np.ndarray:
    """A torch tensor (any device; bf16 widened to fp32) or array -> numpy."""
    if hasattr(x, "detach"):
        x = x.detach()
        if x.is_floating_point():
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def _fig_to_np(fig) -> np.ndarray:
    """Matplotlib figure -> [H, W, 3] uint8 (reference fig_to_np)."""
    fig.tight_layout()
    fig.canvas.draw()
    data = np.asarray(fig.canvas.buffer_rgba())[..., :3]
    return np.ascontiguousarray(data)


def plot_waypoint_grid(pred: np.ndarray, gt: np.ndarray,
                       org: Optional[Sequence[np.ndarray]] = None,
                       max_examples: int = 16) -> np.ndarray:
    """Reference visualise_waypoints grid: up to 16 examples, 4 columns,
    blue predicted / green GT / red original-input trajectories, equal
    aspect with a 1.5 box aspect (tall, forward-looking)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    pred = np.asarray(pred)
    gt = np.asarray(gt)
    b = min(len(gt), max_examples)
    rows = int(np.ceil(b / 4))
    cols = min(b, 4)
    fig = plt.figure(figsize=(10.24, 10.24))
    fig.subplots_adjust(hspace=0.8)
    for i in range(b):
        ax = fig.add_subplot(rows, cols, i + 1)
        ax.scatter(pred[i, :, 1], pred[i, :, 0], marker="o", c="b",
                   label="Predicted")
        ax.plot(pred[i, :, 1], pred[i, :, 0], c="b")
        ax.scatter(gt[i, :, 1], gt[i, :, 0], marker="x", c="g",
                   label="Ground Truth")
        ax.plot(gt[i, :, 1], gt[i, :, 0], c="g")
        if org is not None and i < len(org) and org[i] is not None:
            o = np.asarray(org[i])
            ax.scatter(o[:, 1], o[:, 0], marker="o", c="r", label="Input")
            ax.plot(o[:, 1], o[:, 0], c="r")
        ax.set_title(f"waypoints {i}")
        ax.grid()
        ax.set_aspect("equal", adjustable="box")
        ax.set_box_aspect(1.5)
    out = _fig_to_np(fig)
    plt.close(fig)
    return out


def draw_text_panel(gt_texts: Sequence[str],
                    pred_texts: Optional[Sequence[str]] = None,
                    size=(1024, 1024)) -> np.ndarray:
    """GT-vs-predicted language panel (reference white_pil rendering:
    `i GT: ...` / `i Pred: ...`, wrapped at 80 chars, 20 px per line)."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", size, "white")
    draw = ImageDraw.Draw(img)
    y = 10
    for i, gt in enumerate(gt_texts):
        wrapped = textwrap.fill(str(gt), width=80)
        draw.text((10, y), f"{i} GT: {wrapped}", fill="black")
        y += 20 * max(len(wrapped.splitlines()), 1)
        if pred_texts is not None and i < len(pred_texts):
            wrapped_p = textwrap.fill(str(pred_texts[i]), width=80)
            draw.text((10, y), f"{i} Pred: {wrapped_p}", fill="blue")
            y += 20 * max(len(wrapped_p.splitlines()), 1)
        y += 20
        if y > size[1] - 40:
            break
    return np.asarray(img)


def camera_intrinsics(width: int = 1024, height: int = 512,
                      fov_deg: float = 110.0) -> np.ndarray:
    """Pinhole K (reference utils/projection.py, FOV 110)."""
    f = width / (2.0 * math.tan(math.radians(fov_deg) / 2.0))
    return np.array([[f, 0.0, width / 2.0],
                     [0.0, f, height / 2.0],
                     [0.0, 0.0, 1.0]])


def camera_extrinsics(pos=(-1.5, 0.0, 2.0), rot=(0.0, 0.0, 0.0)) -> np.ndarray:
    """Camera-to-ego 4x4 (reference camera at x=-1.5, z=2.0)."""
    roll, pitch, yaw = (math.radians(r) for r in rot)
    cr, sr = math.cos(roll), math.sin(roll)
    cp, sp = math.cos(pitch), math.sin(pitch)
    cy, sy = math.cos(yaw), math.sin(yaw)
    R = np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])
    M = np.eye(4)
    M[:3, :3] = R
    M[:3, 3] = pos
    return M


def project_points(points_ego: np.ndarray, K: Optional[np.ndarray] = None,
                   extrinsics: Optional[np.ndarray] = None) -> np.ndarray:
    """Ego-frame 3D points -> image pixels [N, 2] (z<=0 rows -> nan)."""
    K = camera_intrinsics() if K is None else K
    E = camera_extrinsics() if extrinsics is None else extrinsics
    pts = np.asarray(points_ego, float).reshape(-1, 3)
    cam = (np.linalg.inv(E) @ np.concatenate(
        [pts, np.ones((len(pts), 1))], 1).T)[:3].T
    # ego (x fwd, y right, z up) -> camera (x right, y down, z fwd)
    cam_xyz = np.stack([cam[:, 1], -cam[:, 2], cam[:, 0]], 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        uv = (K @ cam_xyz.T).T
        uv = uv[:, :2] / uv[:, 2:3]
    uv[cam_xyz[:, 2] <= 0.1] = np.nan
    return uv


def camera_overlay(image: np.ndarray, pred_wps: np.ndarray,
                   gt_wps: Optional[np.ndarray] = None,
                   K: Optional[np.ndarray] = None,
                   extrinsics: Optional[np.ndarray] = None) -> np.ndarray:
    """Project BEV waypoints onto the camera image (pinhole model from
    utils/geometry.py; ground plane z=0) and draw them: blue = predicted,
    green = ground truth. Returns a drawn copy of `image` (uint8 HWC)."""
    import cv2

    img = np.ascontiguousarray(np.asarray(image, np.uint8))
    h, w = img.shape[:2]
    if K is None:
        K = camera_intrinsics(width=w, height=h)

    def draw(wps, color):
        wps = np.asarray(wps, float).reshape(-1, 2)
        pts3 = np.concatenate([wps, np.zeros((len(wps), 1))], axis=1)
        uv = project_points(pts3, K=K, extrinsics=extrinsics)
        prev = None
        for u, v in uv:
            if not (np.isfinite(u) and np.isfinite(v)):
                prev = None
                continue
            p = (int(round(u)), int(round(v)))
            if 0 <= p[0] < w and 0 <= p[1] < h:
                cv2.circle(img, p, 4, color, -1)
                if prev is not None:
                    cv2.line(img, prev, p, color, 1)
                prev = p
            else:
                prev = None

    if gt_wps is not None:
        draw(gt_wps, (0, 200, 0))
    draw(pred_wps, (30, 60, 255))
    return img


def tiles_to_image(pixel_values: np.ndarray) -> Optional[np.ndarray]:
    """Un-normalize the first image tile of a batch back to uint8 for
    display ([NP, H, W, 3] ImageNet-normalized -> [H, W*min(NP,2), 3])."""
    if pixel_values.dtype == np.uint8 and pixel_values.ndim == 3:
        return pixel_values                     # a raw frame
    pv = np.asarray(pixel_values, np.float32)
    if pv.ndim != 4 or pv.shape[-1] != 3:
        return None
    tiles = pv * _IMAGENET_STD + _IMAGENET_MEAN
    tiles = np.clip(tiles * 255.0, 0, 255).astype(np.uint8)
    return np.concatenate(list(tiles[:2]), axis=1)


def plot_predictions(image: Optional[np.ndarray],
                     pred_route: np.ndarray, gt_route: np.ndarray,
                     pred_wps: np.ndarray, gt_wps: np.ndarray,
                     text: str = "", out_path: str = "viz.png") -> str:
    """Single-example overview PNG: camera (with projected waypoints when an
    image is given) + BEV scatter. Kept for tooling/back-compat."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ncols = 2 if image is not None else 1
    fig, axes = plt.subplots(1, ncols, figsize=(6 * ncols, 6))
    axes = np.atleast_1d(axes)
    if image is not None:
        over = camera_overlay(image, pred_wps, gt_wps)
        axes[0].imshow(over)
        axes[0].set_title("camera (projected wps)")
        axes[0].axis("off")
    ax = axes[-1]
    ax.plot(gt_route[:, 1], gt_route[:, 0], "g.-", label="route gt")
    ax.plot(pred_route[:, 1], pred_route[:, 0], "b.-", label="route pred")
    ax.plot(gt_wps[:, 1], gt_wps[:, 0], "gx", label="wps gt")
    ax.plot(pred_wps[:, 1], pred_wps[:, 0], "rx", label="wps pred")
    ax.scatter([0], [0], c="k", marker="s", label="ego")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_aspect("equal")
    ax.set_title(text[:80])
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    fig.savefig(out_path, dpi=100, bbox_inches="tight")
    plt.close(fig)
    return out_path


class VisualiseCallback:
    """Trainer hook: `maybe_plot(step, batch, preds, ...)`.

    Produces (and logs through `logger.log_image` when the logger supports
    it -- the wandb sink does):
      * `viz_waypoints_*.png` -- the 16-example waypoint grid,
      * `viz_route_*.png`     -- the 16-example route grid,
      * `viz_text_*.png`      -- GT vs predicted language panel,
      * `viz_camera_*.png`    -- projected-waypoint camera overlay
                                 (first example; when images are present).
    """

    def __init__(self, every_n_steps: int, out_dir: str,
                 logger: Any = None, tokenizer: Any = None,
                 max_examples: int = 16):
        self.every = every_n_steps
        self.out_dir = out_dir
        self.logger = logger
        self.tokenizer = tokenizer
        self.max_examples = max_examples

    # -- helpers -----------------------------------------------------------
    def _decode(self, ids: np.ndarray, mask: Optional[np.ndarray] = None
                ) -> str:
        if self.tokenizer is None:
            return ""
        ids = np.asarray(ids)
        if mask is not None:
            ids = ids[np.asarray(mask, bool)]
        try:
            return self.tokenizer.decode([int(t) for t in ids.tolist()])
        except Exception:
            return ""

    def _log_image(self, name: str, step: int, arr: np.ndarray, path: str):
        import cv2
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        cv2.imwrite(path, cv2.cvtColor(arr, cv2.COLOR_RGB2BGR))
        if self.logger is not None and hasattr(self.logger, "log_image"):
            try:
                self.logger.log_image(name, step, arr)
            except Exception:
                pass
        return path

    # -- main entry --------------------------------------------------------
    def maybe_plot(self, step: int, example, preds: Dict[str, Any],
                   language_pred: Optional[Sequence[str]] = None
                   ) -> Optional[List[str]]:
        if self.every <= 0:
            return None
        pred_wps = _np(preds["speed_wps"])
        pred_route = _np(preds["route"]) if "route" in preds else pred_wps
        gt_wps = _np(example.driving_label.waypoints)
        gt_route = _np(example.driving_label.path)

        # original/input waypoints spliced into the prompt (reference reads
        # placeholder_values; ours carries them as ph_coords with slots)
        org: List[Optional[np.ndarray]] = []
        prompt = example.driving_input.prompt
        if prompt is not None and getattr(prompt, "ph_slots", None) is not None:
            slots = _np(prompt.ph_slots)
            coords = _np(prompt.ph_coords)
            for i in range(len(gt_wps)):
                used = slots[i] >= 0
                org.append(coords[i][used] if used.sum() >= 2 else None)

        paths = []
        grid = plot_waypoint_grid(pred_wps, gt_wps, org, self.max_examples)
        paths.append(self._log_image(
            "visualise/waypoints", step, grid,
            os.path.join(self.out_dir, f"viz_waypoints_{step:08d}.png")))
        rgrid = plot_waypoint_grid(pred_route, gt_route, None,
                                   self.max_examples)
        paths.append(self._log_image(
            "visualise/route", step, rgrid,
            os.path.join(self.out_dir, f"viz_route_{step:08d}.png")))

        # language panel: GT = loss-masked prompt tokens; Pred = generated
        gt_texts = []
        if self.tokenizer is not None and prompt is not None:
            ids = _np(prompt.ids)
            lm = _np(prompt.loss_mask)
            for i in range(min(len(ids), self.max_examples)):
                gt_texts.append(self._decode(ids[i], lm[i]))
        if gt_texts or language_pred:
            panel = draw_text_panel(gt_texts or [""] * len(pred_wps),
                                    language_pred)
            paths.append(self._log_image(
                "visualise/text", step, panel,
                os.path.join(self.out_dir, f"viz_text_{step:08d}.png")))

        pv = getattr(example.driving_input, "pixel_values", None)
        if pv is not None:
            img = tiles_to_image(_np(pv[0]))
            if img is not None:
                over = camera_overlay(img, pred_wps[0], gt_wps[0])
                paths.append(self._log_image(
                    "visualise/camera", step, over,
                    os.path.join(self.out_dir,
                                 f"viz_camera_{step:08d}.png")))
        return paths
