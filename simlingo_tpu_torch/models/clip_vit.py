"""CLIP ViT vision tower and the LLaVA-NeXT feature path of SimLingo-Base.

Counterpart of `simlingo_tpu/models/clip_vit.py`: CLIP ViT-L/14-336
(quick GELU, pre-LN blocks, class and learned position embeddings, a
pre-layernorm), hidden states of layer -2 with the CLS dropped; the
2-layer projector; the fixed 1x2 AnyRes grid (two 336 tiles -> a 24 x 48
feature grid), a 2x2 average pool and the image-newline column. Images
are NHWC. Attention reads q/k/v as [B, T, H, D] views of the three
projections (group 1) through `attention_autograd`, so training runs the
backward kernel too. There is no remat.

Tensor parallelism (`tp`, `models/layers.py`), as `models/vit.py` and
JAX's `PARTITION_RULES` (`simlingo_tpu/parallel/mesh.py:57-92`) split
the tower: each rank holds num_heads / tp heads (q, k, v column-parallel,
their replicated biases cut at use; o row-parallel) and
intermediate_size / tp of the MLP (fc1 column, fc2 row); the projector's
fc1 is column-parallel and its fc2 row-parallel. The patch and position
embeddings, the norms and the class token are replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from simlingo_tpu_torch.kernels.flash_attention import attention_autograd
from simlingo_tpu_torch.models import layers as L
from simlingo_tpu_torch.models.vit import _patchify


@dataclasses.dataclass(frozen=True)
class CLIPViTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 336
    patch_size: int = 14
    layer_norm_eps: float = 1e-5
    feature_layer: int = -2            # llava vision_feature_layer
    projector_hidden: int = 4096       # multi_modal_projector widths
    projector_out: int = 4096

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def layers_run(self) -> int:
        """Layers `encode` runs: up to and including `feature_layer`."""
        return (self.num_layers + self.feature_layer + 1 if self.feature_layer < 0
                else self.feature_layer)

    @staticmethod
    def tiny() -> "CLIPViTConfig":
        return CLIPViTConfig(hidden_size=64, num_layers=3, num_heads=4,
                             intermediate_size=128, image_size=56, patch_size=14,
                             projector_hidden=96, projector_out=96)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def init_params(gen: torch.Generator, cfg: CLIPViTConfig, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    H = cfg.hidden_size
    kw = dict(dtype=dtype, device=device)
    p: Dict[str, Any] = {
        "patch_embed": L.linear_init(gen, cfg.patch_size ** 2 * 3, H, False, **kw),
        "cls_token": L._normal(gen, (H,), **kw),
        "pos_embed": L._normal(gen, (cfg.grid ** 2 + 1, H), **kw),
        "pre_ln": L.layernorm_init(H, **kw),
        "layers": {},
        "projector": {
            "fc1": L.linear_init(gen, H, cfg.projector_hidden, True, **kw),
            "fc2": L.linear_init(gen, cfg.projector_hidden, cfg.projector_out, True, **kw),
        },
    }
    for i in range(cfg.num_layers):
        p["layers"][str(i)] = {
            "ln1": L.layernorm_init(H, **kw),
            "ln2": L.layernorm_init(H, **kw),
            "attn": {n: L.linear_init(gen, H, H, True, **kw) for n in ("q", "k", "v", "o")},
            "mlp": L.gelu_mlp_init(gen, H, cfg.intermediate_size, **kw),
        }
    return p


def _clip_layer(p, x: torch.Tensor, cfg: CLIPViTConfig, tp=None) -> torch.Tensor:
    B, T, H = x.shape
    hd = H // cfg.num_heads
    h = L.tp_copy(L.layernorm(p["ln1"], x, cfg.layer_norm_eps), tp)
    q, k, v = (L.column_linear(p["attn"][n], h, tp) for n in ("q", "k", "v"))
    nh = q.shape[-1] // hd                              # this rank's heads
    q, k, v = (t.view(B, T, nh, hd) for t in (q, k, v))
    a = attention_autograd(q, k, v, None, causal=False)
    x = x + L.row_linear(p["attn"]["o"], a.reshape(B, T, nh * hd), tp)
    h = L.tp_copy(L.layernorm(p["ln2"], x, cfg.layer_norm_eps), tp)
    h = quick_gelu(L.column_linear(p["mlp"]["fc1"], h, tp))
    return x + L.row_linear(p["mlp"]["fc2"], h, tp)


def encode(params, images: torch.Tensor, cfg: CLIPViTConfig, tp=None) -> torch.Tensor:
    """[B, H, W, 3] -> hidden states of `feature_layer` [B, T+1, hidden];
    `tp`: the tp group or None."""
    images = images.to(params["patch_embed"]["w"].dtype)
    x = L.linear(params["patch_embed"], _patchify(images, cfg))
    B = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)
    x = L.layernorm(params["pre_ln"], x, cfg.layer_norm_eps)
    for i in range(cfg.layers_run):
        x = _clip_layer(params["layers"][str(i)], x, cfg, tp)
    return x


def llava_features(params, pixel_values: torch.Tensor, cfg: CLIPViTConfig,
                   newline: torch.Tensor, downsample: int = 2, tp=None) -> torch.Tensor:
    """AnyRes 1 x NP: pixel_values [B, NP, S, S, 3] -> [B, n_tokens,
    projector_out], n_tokens = (g / d) (NP g / d + 1) with the image-newline
    column appended (300 at two 336 tiles)."""
    B, NP = pixel_values.shape[:2]
    g, d = cfg.grid, downsample
    feats = encode(params, pixel_values.reshape((B * NP,) + pixel_values.shape[2:]),
                   cfg, tp)[:, 1:]                               # drop CLS
    h = L.gelu_mlp(params["projector"], feats, tp=tp)            # [B*NP, g*g, C]
    C = h.shape[-1]
    h = h.view(B, NP, g, g, C).transpose(1, 2).reshape(B, g, NP * g, C)
    h = h.view(B, g // d, d, NP * g // d, d, C).mean(dim=(2, 4))
    nl = newline.to(h.dtype).expand(B, h.shape[1], 1, C)
    return torch.cat([h, nl], dim=2).reshape(B, -1, C)
