"""InternViT vision tower (InternVL2-1B: InternViT-300M-448px).

Counterpart of `simlingo_tpu/models/vit.py`: patch embedding as an unfold +
matmul over (ph, pw, c)-ordered patches, cls + position embedding, pre-norm
layers with layer scale, 0.5x pixel shuffle and the mlp1 projector. Images
are NHWC. Attention reads q/k/v as [B, T, H, D] views of each projection's
[B, T, H*D] output (no transpose copy), through kernels/flash_attention;
in training (autograd on) through `attention_train`, whose backward kernel
reads the same views.

Remat (`encode(..., remat)`, JAX's :186-208), only while autograd records:
  * True: each layer keeps for the backward only its input and the
    attention output (JAX's `save_only_these_names("vit_attn_out")`). Two
    regions are checkpointed (torch.utils.checkpoint, non-reentrant):
    ln1 -> q, k, v -> attention, and the rest of the layer, which takes the
    attention output as an input and so keeps it. A selective-checkpoint
    policy keyed on ops cannot name that output: the kernel wrappers fill a
    `torch.empty` through ctypes, which the dispatcher never sees. JAX's
    backward re-runs the attention forward kernel to recover the unnamed
    `lse` residual (its grad holds three Pallas calls a layer, two without
    remat); the first region's recompute does the same, so the forward
    kernel launches twice a layer a step.
  * "mlp": everything is kept except the GELU's output, which fc2's
    weight gradient recomputes from the kept pre-GELU hidden
    (`layers.gelu_mlp(recompute_gelu=True)`); nothing else re-runs.

Tensor parallelism (`tp`, `models/layers.py`): each rank holds
num_heads / tp heads (q, k, v column-parallel, o row-parallel) and
intermediate_size / tp of the MLP (fc1 column, fc2 row); the projector's
fc1 / fc2 likewise. The embeddings, norms and layer scales run replicated.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from simlingo_tpu_torch.kernels.flash_attention import attention_autograd
from simlingo_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    image_size: int = 448
    patch_size: int = 14
    layer_norm_eps: float = 1e-6
    layer_scale_init: float = 0.1
    qkv_bias: bool = True
    use_qk_norm: bool = False
    downsample_ratio: float = 0.5
    projector_out: int = 896
    gelu_approximate: bool = False

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def tokens_per_patch_image(self) -> int:
        return int(self.num_patches * self.downsample_ratio ** 2)

    @staticmethod
    def tiny() -> "ViTConfig":
        return ViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                         intermediate_size=128, image_size=56, patch_size=14,
                         projector_out=64)


def init_params(gen: torch.Generator, cfg: ViTConfig, dtype=torch.float32,
                device="cpu") -> Dict[str, Any]:
    H = cfg.hidden_size
    kw = dict(dtype=dtype, device=device)
    proj_in = int(H / (cfg.downsample_ratio ** 2))
    p: Dict[str, Any] = {
        "patch_embed": L.linear_init(gen, cfg.patch_size ** 2 * 3, H, True, **kw),
        "cls_token": torch.zeros(1, 1, H, **kw),
        "pos_embed": torch.zeros(1, cfg.num_patches + 1, H, **kw),
        "layers": {},
        "projector": {
            "ln": L.layernorm_init(proj_in, **kw),
            "fc1": L.linear_init(gen, proj_in, cfg.projector_out, True, **kw),
            "fc2": L.linear_init(gen, cfg.projector_out, cfg.projector_out,
                                 True, **kw),
        },
    }
    for i in range(cfg.num_layers):
        layer = {
            "ln1": L.layernorm_init(H, **kw),
            "ln2": L.layernorm_init(H, **kw),
            "attn": {n: L.linear_init(gen, H, H, cfg.qkv_bias or n == "o", **kw)
                     for n in ("q", "k", "v", "o")},
            "ls1": torch.full((H,), cfg.layer_scale_init, **kw),
            "ls2": torch.full((H,), cfg.layer_scale_init, **kw),
            "mlp": {"fc1": L.linear_init(gen, H, cfg.intermediate_size, True, **kw),
                    "fc2": L.linear_init(gen, cfg.intermediate_size, H, True, **kw)},
        }
        if cfg.use_qk_norm:
            layer["q_norm"] = L.rmsnorm_init(H, **kw)
            layer["k_norm"] = L.rmsnorm_init(H, **kw)
        p["layers"][str(i)] = layer
    return p


def _patchify(images: torch.Tensor, cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, 3] -> [B, num_patches, ps*ps*3], flattened (ph, pw, c)."""
    B, _, _, C = images.shape
    g, ps = cfg.grid, cfg.patch_size
    x = images.reshape(B, g, ps, g, ps, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, g * g, ps * ps * C)


def _attention_out(p, x: torch.Tensor, cfg: ViTConfig, tp=None) -> torch.Tensor:
    """ln1 -> q, k, v (-> q/k norms) -> attention: [B, T, H] (under tp,
    this rank's heads: [B, T, H / tp])."""
    B, T, H = x.shape
    hd = H // cfg.num_heads
    h = L.tp_copy(L.layernorm(p["ln1"], x, cfg.layer_norm_eps), tp)
    q = L.column_linear(p["attn"]["q"], h, tp)
    k = L.column_linear(p["attn"]["k"], h, tp)
    v = L.column_linear(p["attn"]["v"], h, tp)
    nh = q.shape[-1] // hd
    if cfg.use_qk_norm:
        if tp is not None:
            raise ValueError("use_qk_norm normalises over all heads: not split over tp")
        q = L.rmsnorm(p["q_norm"], q, cfg.layer_norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.layer_norm_eps)
    a = attention_autograd(q.view(B, T, nh, hd), k.view(B, T, nh, hd),
                           v.view(B, T, nh, hd), None, causal=False,
                           scale=hd ** -0.5)
    return a.reshape(B, T, nh * hd)


def _after_attention(p, x: torch.Tensor, a: torch.Tensor, cfg: ViTConfig,
                     recompute_gelu: bool = False, tp=None) -> torch.Tensor:
    """o projection, layer-scaled residual, ln2 -> MLP, residual."""
    a = L.row_linear(p["attn"]["o"], a, tp)
    x = x + p["ls1"].to(a.dtype) * a
    m = L.gelu_mlp(p["mlp"], L.layernorm(p["ln2"], x, cfg.layer_norm_eps),
                   approximate=cfg.gelu_approximate, recompute_gelu=recompute_gelu, tp=tp)
    return x + p["ls2"].to(m.dtype) * m


def _vit_layer(p, x: torch.Tensor, cfg: ViTConfig, remat=False, tp=None) -> torch.Tensor:
    if remat == "mlp":
        return _after_attention(p, x, _attention_out(p, x, cfg, tp), cfg,
                                recompute_gelu=True, tp=tp)
    if remat and torch.is_grad_enabled():
        # the regions draw no torch random numbers: no RNG state to replay
        kw = dict(use_reentrant=False, preserve_rng_state=False)
        a = checkpoint(_attention_out, p, x, cfg, tp, **kw)
        return checkpoint(_after_attention, p, x, a, cfg, False, tp, **kw)
    return _after_attention(p, x, _attention_out(p, x, cfg, tp), cfg, tp=tp)


def encode(params, images: torch.Tensor, cfg: ViTConfig, remat=False, tp=None
           ) -> torch.Tensor:
    """[B, H, W, 3] normalized images -> [B, T+1, hidden]. `remat`: False,
    True or "mlp" (module docstring); `tp`: the tp group or None."""
    images = images.to(params["patch_embed"]["w"].dtype)
    x = L.linear(params["patch_embed"], _patchify(images, cfg))
    B = x.shape[0]
    cls = params["cls_token"].to(x.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"].to(x.dtype)
    for i in range(cfg.num_layers):
        x = _vit_layer(params["layers"][str(i)], x, cfg, remat, tp)
    return x


def pixel_shuffle(x: torch.Tensor, scale: float) -> torch.Tensor:
    """InternVL pixel shuffle, [B, W, H, C] -> [B, H*s, W*s, C/s^2]."""
    B, W, H, C = x.shape
    x = x.reshape(B, W, int(H * scale), int(C / scale)).permute(0, 2, 1, 3)
    x = x.reshape(B, int(H * scale), int(W * scale), int(C / (scale ** 2)))
    return x.permute(0, 2, 1, 3)


def extract_features(params, images: torch.Tensor, cfg: ViTConfig, remat=False,
                     tp=None) -> torch.Tensor:
    """ViT (with `remat`) -> drop CLS -> pixel shuffle -> mlp1 projector.
    [B, H, W, 3] -> [B, tokens_per_patch_image, llm_hidden]."""
    feats = encode(params, images, cfg, remat=remat, tp=tp)[:, 1:]
    B, T, C = feats.shape
    g = cfg.grid
    feats = pixel_shuffle(feats.reshape(B, g, g, C), cfg.downsample_ratio)
    feats = feats.reshape(B, -1, feats.shape[-1])
    h = L.tp_copy(L.layernorm(params["projector"]["ln"], feats, 1e-5), tp)
    h = F.gelu(L.column_linear(params["projector"]["fc1"], h, tp))
    return L.row_linear(params["projector"]["fc2"], h, tp)
