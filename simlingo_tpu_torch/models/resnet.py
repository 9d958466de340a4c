"""ResNet-18/34 image encoder of SimLingo-Base (its ablation encoder).

Counterpart of `simlingo_tpu/models/resnet.py`: the stem (7x7 conv,
stride 2), a 3x3 max-pool of stride 2, four stages of basic blocks and a
linear projection of the final feature map to `token_size`-wide tokens.
Images come in NHWC and tokens go out [B, h*w, token_size] in row-major
(h, w) order, as in JAX; inside, activations are NCHW and conv weights
torch's [out, in, kh, kw] (`core/from_jax.py` turns JAX's HWIO kernels
into that layout). The convs are `F.conv2d` (cuDNN): JAX runs them in XLA,
outside any Pallas kernel.

Two of JAX's conventions are kept by hand rather than by torch's modules:
  * "SAME" padding pads asymmetrically, lo = total // 2 and the extra row
    or column at the end (e.g. (2, 3) for the 7x7 stride-2 stem on 336,
    (0, 1) for a 3x3 stride-2 conv or the max-pool on an even size), where
    `nn.Conv2d(padding=k // 2)` would pad symmetrically and shift every
    output; the max-pool pads with -inf.
  * BatchNorm (`batchnorm`) normalises by the biased variance of the batch
    in training and keeps momentum * old + (1 - momentum) * new with
    momentum 0.9, where `nn.BatchNorm2d` updates with the unbiased variance
    and the complementary momentum.
The running statistics (`bn_state`) are a tree beside the parameters, and
`encode` returns them updated in training mode and unchanged otherwise.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.models import layers as L


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    depth: int = 18                 # 18 or 34
    width: int = 64
    token_size: int = 512           # output embedding dim (projection)
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5

    @property
    def stage_blocks(self) -> Tuple[int, ...]:
        return {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}[self.depth]


def _conv_init(gen, kh, kw, cin, cout, dtype, device):
    """He normal, std sqrt(2 / fan_in), as JAX's `_conv_init`; [out, in, kh, kw]."""
    std = math.sqrt(2.0 / (kh * kw * cin))
    return std * torch.randn((cout, cin, kh, kw), generator=gen, dtype=dtype, device=device)


def _bn_init(c, dtype, device):
    return L.layernorm_init(c, dtype, device)          # {"scale": 1, "bias": 0}


def _bn_state_init(c, dtype, device):
    return {"mean": torch.zeros(c, dtype=dtype, device=device),
            "var": torch.ones(c, dtype=dtype, device=device)}


def _same_pad(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial dim: (before, after)."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv(w: torch.Tensor, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x [B, C, H, W] conv w [out, in, kh, kw] with "SAME" padding."""
    kh, kw = w.shape[2:]
    ph, pw = _same_pad(x.shape[2], kh, stride), _same_pad(x.shape[3], kw, stride)
    if any(ph + pw):
        x = F.pad(x, (*pw, *ph))
    return F.conv2d(x, w.to(x.dtype), stride=stride)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """3x3 max-pool of stride 2, "SAME" with -inf padding (JAX's
    `reduce_window(x, -inf, max, (1, 3, 3, 1), (1, 2, 2, 1), "SAME")`)."""
    ph, pw = _same_pad(x.shape[2], 3, 2), _same_pad(x.shape[3], 3, 2)
    return F.max_pool2d(F.pad(x, (*pw, *ph), value=float("-inf")), 3, 2)


def batchnorm(p, state, x: torch.Tensor, training: bool, momentum: float, eps: float):
    """(normalised x [B, C, H, W], new state). Training: the batch's mean
    and biased variance over (B, H, W), and state momentum * old + (1 -
    momentum) * batch; else the running statistics, state returned as it
    is."""
    if training:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mean,
                     "var": momentum * state["var"] + (1 - momentum) * var}
    else:
        mean, var = state["mean"], state["var"]
        new_state = state
    mean, inv, scale, bias = (t.to(x.dtype)[None, :, None, None]
                              for t in (mean, torch.rsqrt(var + eps), p["scale"], p["bias"]))
    return (x - mean) * inv * scale + bias, new_state


def init_params(cfg: ResNetConfig, generator: torch.Generator, device="cpu",
                dtype=torch.float32) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(params, bn_state) in the tree of the JAX `init_params`, random from
    `generator` (which must live on `device`)."""
    kw = dict(dtype=dtype, device=device)
    w = cfg.width
    p: Dict[str, Any] = {
        "stem": {"conv": _conv_init(generator, 7, 7, 3, w, **kw), "bn": _bn_init(w, **kw)},
        "stages": {},
        "proj": L.linear_init(generator, w * 8, cfg.token_size, True, **kw),
    }
    s: Dict[str, Any] = {"stem": _bn_state_init(w, **kw), "stages": {}}
    cin = w
    for si, nblocks in enumerate(cfg.stage_blocks):
        cout = w * (2 ** si)
        p["stages"][str(si)], s["stages"][str(si)] = {}, {}
        for bi in range(nblocks):
            blk = {"conv1": _conv_init(generator, 3, 3, cin if bi == 0 else cout, cout, **kw),
                   "bn1": _bn_init(cout, **kw),
                   "conv2": _conv_init(generator, 3, 3, cout, cout, **kw),
                   "bn2": _bn_init(cout, **kw)}
            st = {"bn1": _bn_state_init(cout, **kw), "bn2": _bn_state_init(cout, **kw)}
            if bi == 0 and (si > 0 or cin != cout):
                blk["down_conv"] = _conv_init(generator, 1, 1, cin, cout, **kw)
                blk["down_bn"] = _bn_init(cout, **kw)
                st["down_bn"] = _bn_state_init(cout, **kw)
            p["stages"][str(si)][str(bi)] = blk
            s["stages"][str(si)][str(bi)] = st
        cin = cout
    return p, s


def encode(params, bn_state, images: torch.Tensor, cfg: ResNetConfig,
           training: bool = False):
    """[B, H, W, 3] -> ([B, h*w, token_size] tokens, new bn_state)."""
    mom, eps = cfg.bn_momentum, cfg.bn_eps
    new_state: Dict[str, Any] = {"stages": {}}
    # the weights' dtype (fp32 pixels would promote a bf16 tower)
    x = images.to(params["stem"]["conv"].dtype).permute(0, 3, 1, 2)
    x = conv(params["stem"]["conv"], x, stride=2)
    x, new_state["stem"] = batchnorm(params["stem"]["bn"], bn_state["stem"], x, training,
                                     mom, eps)
    x = max_pool(F.relu(x))
    for si, nblocks in enumerate(cfg.stage_blocks):
        new_state["stages"][str(si)] = {}
        for bi in range(nblocks):
            p = params["stages"][str(si)][str(bi)]
            st = bn_state["stages"][str(si)][str(bi)]
            nst = {}
            stride = 2 if (si > 0 and bi == 0) else 1
            h = conv(p["conv1"], x, stride=stride)
            h, nst["bn1"] = batchnorm(p["bn1"], st["bn1"], h, training, mom, eps)
            h = conv(p["conv2"], F.relu(h))
            h, nst["bn2"] = batchnorm(p["bn2"], st["bn2"], h, training, mom, eps)
            if "down_conv" in p:
                sc = conv(p["down_conv"], x, stride=stride)
                sc, nst["down_bn"] = batchnorm(p["down_bn"], st["down_bn"], sc, training,
                                               mom, eps)
            else:
                sc = x
            x = F.relu(h + sc)
            new_state["stages"][str(si)][str(bi)] = nst
    B, C, H, W = x.shape
    tokens = L.linear(params["proj"], x.permute(0, 2, 3, 1).reshape(B, H * W, C))
    return tokens, new_state
