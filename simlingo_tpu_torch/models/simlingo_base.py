"""SimLingo-Base (CarLLaVA): the vision-only driving model.

Counterpart of `simlingo_tpu/models/simlingo_base.py`: the vision
encoder -- the LLaVA-NeXT CLIP tower, or the ResNet (`encoder="resnet"`,
`models/resnet.py`) -- -> linear `language_projection` -> [vision tokens |
speed token | target-point tokens | 30 driving queries] -> the
from-scratch LLaMA (continuous tokens, no vocabulary, causal) -> the
cumsum MLP heads; smooth-L1 losses. At the defaults (two 336 tiles,
`tiny`) the sequence is 300 + 1 + 2 + 30 = 333 tokens; with the ResNet-18,
2 x 11 x 11 + 33 = 275.

The ResNet's running BatchNorm statistics sit in the parameter tree at
`bn_state`, as in JAX. The encoder always runs with training=False, in
`forward_loss` too, so they never take a batch's statistics; but they are
read by the normalisation, so they have gradients, and the training step
updates them as parameters of the "rest" group (AdamW, weight decay
included), as JAX's optax chain does.

Under tensor parallelism (`tp`, a group of the mesh) CLIP and its
projector split as `models/clip_vit.py` says and the LLaMA as
`models/qwen2.py` splits Qwen2; the ResNet, `language_projection`, the
encodings and the heads run whole on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.core.structs import TrainingOutput, summarise_losses
from simlingo_tpu_torch.models import adaptors as A
from simlingo_tpu_torch.models import clip_vit, llama, qwen2, resnet
from simlingo_tpu_torch.models import layers as L

ENCODERS = ("llavanext", "resnet")


@dataclasses.dataclass(frozen=True)
class SimLingoBaseConfig:
    llm_variant: str = "tiny"
    encoder: str = "llavanext"           # 'llavanext' | 'resnet'
    clip: clip_vit.CLIPViTConfig = dataclasses.field(
        default_factory=clip_vit.CLIPViTConfig)
    resnet: resnet.ResNetConfig = dataclasses.field(default_factory=resnet.ResNetConfig)
    speed_as_input: bool = True
    predict_route_as_wps: bool = True
    speed_wps_mode: str = "2d"
    adaptor_mlp_dim: int = 256
    new_layer_norm_minmax: bool = False

    def __post_init__(self):
        _check_encoder(self)

    @property
    def llm(self) -> qwen2.Qwen2Config:
        return llama.llama_config(self.llm_variant)

    @property
    def speed_min_max(self) -> Tuple[float, float]:
        return (0.0, 110.0 / 3.6) if self.new_layer_norm_minmax else (0.0, 64.0 / 3.6)

    @property
    def coord_min_max(self) -> Tuple[float, float]:
        return (-200.0, 200.0) if self.new_layer_norm_minmax else (-32.0, 32.0)

    @staticmethod
    def tiny() -> "SimLingoBaseConfig":
        return SimLingoBaseConfig(llm_variant="debug", clip=clip_vit.CLIPViTConfig.tiny())


def _check_encoder(cfg: SimLingoBaseConfig) -> None:
    if cfg.encoder not in ENCODERS:
        raise ValueError(f"SimLingoBaseConfig: encoder {cfg.encoder!r} is not one of "
                         f"{ENCODERS}")


def init_params(cfg: SimLingoBaseConfig, generator: torch.Generator, device="cuda",
                dtype=torch.float32) -> Dict[str, Any]:
    """Random weights from `generator` (which must live on `device`), in the
    tree of the JAX `init_params` (the ResNet's running statistics at
    `bn_state`); every leaf trains."""
    _check_encoder(cfg)
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    H = cfg.llm.hidden_size
    p: Dict[str, Any] = {
        "llm": qwen2.init_params(generator, cfg.llm, **kw),
        "adaptors": A.init_driving_adaptor(generator, H, cfg.adaptor_mlp_dim,
                                           cfg.speed_wps_mode, cfg.predict_route_as_wps,
                                           **kw),
        "route_encoder": A.init_wp_adaptor_base(generator, H, 256, **kw),
    }
    if cfg.speed_as_input:
        p["speed_encoder"] = A.init_vector_adaptor(generator, 1, H, 256, **kw)
    if cfg.encoder == "llavanext":
        C = cfg.clip.projector_out
        p["vision"] = clip_vit.init_params(generator, cfg.clip, **kw)
        p["image_newline"] = L._normal(generator, (C,), **kw)
        p["temporal_encoding"] = L._normal(generator, (1, 1, C), **kw)
        p["camera_encoding"] = L._normal(generator, (1, 1, C), **kw)
    else:
        C = cfg.resnet.token_size
        p["vision"], p["bn_state"] = resnet.init_params(cfg.resnet, generator, **kw)
    if C != H:
        p["language_projection"] = L.linear_init(generator, C, H, False, **kw)
    return p


def vision_tokens(params, pixel_values: torch.Tensor, cfg: SimLingoBaseConfig, tp=None
                  ) -> torch.Tensor:
    """pixel_values [B, NP, S, S, 3] -> [B, n_tokens, H] projected tokens.
    The ResNet runs on the B x NP tiles with training=False, as JAX's
    `vision_tokens` calls it, in training too; under `tp` it runs whole on
    every rank (JAX's rules replicate it), CLIP split."""
    if cfg.encoder == "llavanext":
        feats = clip_vit.llava_features(params["vision"], pixel_values, cfg.clip,
                                        params["image_newline"], tp=tp)
        feats = (feats + params["temporal_encoding"].to(feats.dtype)
                 + params["camera_encoding"].to(feats.dtype))
    else:
        B, NP = pixel_values.shape[:2]
        feats, _ = resnet.encode(params["vision"], params["bn_state"],
                                 pixel_values.reshape((B * NP,) + pixel_values.shape[2:]),
                                 cfg.resnet, training=False)
        feats = feats.reshape(B, -1, feats.shape[-1])
    if "language_projection" in params:
        feats = L.linear(params["language_projection"], feats)
    return feats


def _query_states(params, pixel_values, speed, target_points, cfg: SimLingoBaseConfig,
                  tp=None) -> torch.Tensor:
    """The LLM's final hidden states at the driving queries [B, n_q, H]."""
    vis = vision_tokens(params, pixel_values, cfg, tp)
    B = vis.shape[0]
    parts = [vis]
    if cfg.speed_as_input:
        parts.append(A.vector_encode(params["speed_encoder"], speed[:, None].to(vis.dtype),
                                     cfg.speed_min_max).to(vis.dtype))
    parts.append(A.wp_encode_base(params["route_encoder"], target_points.to(vis.dtype),
                                  cfg.coord_min_max))
    parts.append(A.query_tokens(params["adaptors"], B, dtype=vis.dtype))
    x = torch.cat(parts, dim=1)
    T = x.shape[1]
    pos = torch.arange(T, device=x.device).expand(B, T)
    hidden, _ = qwen2.forward(params["llm"], x, cfg.llm, pos, causal=True, tp=tp)
    return hidden[:, -A.num_queries(params["adaptors"]):]


def forward(params, pixel_values: torch.Tensor, speed: torch.Tensor,
            target_points: torch.Tensor, cfg: SimLingoBaseConfig, tp=None
            ) -> Dict[str, torch.Tensor]:
    """Waypoint / route predictions. speed [B]; target_points [B, P, 2]
    (the reference feeds two target points). `tp`: the tp group or None."""
    return A.decode_predictions(params["adaptors"],
                                _query_states(params, pixel_values, speed,
                                              target_points, cfg, tp))


def forward_loss(params, pixel_values, speed, target_points, waypoints_label,
                 route_label, cfg: SimLingoBaseConfig, count_reduce=None, tp=None
                 ) -> Tuple[TrainingOutput, Dict[str, torch.Tensor]]:
    """Route + speed-waypoint losses; `count_reduce` as
    `summarise_losses`'s (a rank's share of a multi-GPU batch); `tp`: the
    tp group (CLIP and the LLaMA split over it) or None."""
    hidden = _query_states(params, pixel_values, speed, target_points, cfg, tp)
    losses, preds = A.driving_loss(params["adaptors"], hidden,
                                   route_label if cfg.predict_route_as_wps else None,
                                   waypoints_label[:, :A.NUM_SPEED_QUERIES])
    return summarise_losses(losses, count_reduce), preds
