"""Driving adaptors: waypoint encoder, learned query tokens, decode heads,
losses.

Counterpart of `simlingo_tpu/models/adaptors.py`: 20 route queries + 10
speed queries appended to the sequence; MLP heads emit per-step deltas, and
a cumsum over the step axis gives waypoints (in fp32). Losses: smooth-L1 on
the waypoints, next-token CE on the assistant answer: chunked and
checkpointed by default, or, with SIMLINGO_CE_IMPL=pallas / pallas_dw and
the tied head, through the fused CE of `kernels/fused_ce.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.kernels.fused_ce import fused_ce
from simlingo_tpu_torch.models import layers as L

NUM_ROUTE_QUERIES = 20
NUM_SPEED_QUERIES = 10


def init_driving_adaptor(gen, hidden_size: int, mlp_dim: int = 256,
                         speed_wps_mode: str = "2d",
                         predict_route_as_wps: bool = True,
                         dtype=torch.float32, device="cpu") -> Dict[str, Any]:
    kw = dict(dtype=dtype, device=device)
    out_dim = 2 if speed_wps_mode == "2d" else 1
    p: Dict[str, Any] = {}
    if predict_route_as_wps:
        p["route_queries"] = L._normal(gen, (1, NUM_ROUTE_QUERIES, hidden_size), **kw)
        p["route_head"] = L.mlp_stack_init(
            gen, [hidden_size, mlp_dim * 2, mlp_dim, 2],
            use_bias=[True, True, False], **kw)
    p["speed_queries"] = L._normal(gen, (1, NUM_SPEED_QUERIES, hidden_size), **kw)
    p["speed_head"] = L.mlp_stack_init(gen, [hidden_size, mlp_dim, out_dim],
                                       use_bias=[True, False], **kw)
    return p


def init_wp_encoder(gen, hidden_size: int, dtype=torch.float32,
                    device="cpu") -> Dict[str, Any]:
    """Waypoint-input MLP 2 -> 256 -> 512 -> hidden (ReLU)."""
    return L.mlp_stack_init(gen, [2, 256, 512, hidden_size], dtype=dtype,
                            device=device)


def wp_encode(p: Dict[str, Any], coords: torch.Tensor) -> torch.Tensor:
    """[..., 2] -> [..., hidden]."""
    return L.mlp_stack(p, coords, F.relu)


def query_tokens(p: Dict[str, Any], batch_size: int, dtype=None) -> torch.Tensor:
    """[B, 30, H] = [route queries | speed queries]."""
    parts = []
    if "route_queries" in p:
        parts.append(p["route_queries"].expand(batch_size, -1, -1))
    parts.append(p["speed_queries"].expand(batch_size, -1, -1))
    q = torch.cat(parts, dim=1)
    return q if dtype is None else q.to(dtype)


def decode_predictions(p: Dict[str, Any], query_features: torch.Tensor
                       ) -> Dict[str, torch.Tensor]:
    """[B, 30, H] -> {'route': [B, 20, 2], 'speed_wps': [B, 10, d]} (fp32)."""
    preds: Dict[str, torch.Tensor] = {}
    idx = 0
    f = query_features.float()
    if "route_queries" in p:
        preds["route"] = L.mlp_stack(p["route_head"],
                                     f[:, idx:idx + NUM_ROUTE_QUERIES],
                                     F.silu).cumsum(dim=1)
        idx += NUM_ROUTE_QUERIES
    preds["speed_wps"] = L.mlp_stack(p["speed_head"],
                                     f[:, idx:idx + NUM_SPEED_QUERIES],
                                     F.silu).cumsum(dim=1)
    return preds


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (torch's default beta = 1)."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


def driving_loss(p: Dict[str, Any], query_features: torch.Tensor,
                 route_label: Optional[torch.Tensor], speed_label: torch.Tensor):
    """({name: (loss [B, N], count [B, N])}, predictions)."""
    preds = decode_predictions(p, query_features)
    losses = {}
    if "route" in preds and route_label is not None:
        l = smooth_l1(preds["route"], route_label.float()).sum(-1)
        losses["route_loss"] = (l, torch.ones_like(l))
    l = smooth_l1(preds["speed_wps"], speed_label.float()).sum(-1)
    losses["speed_wps_loss"] = (l, torch.ones_like(l))
    return losses, preds


def gather_answer_states(hidden: torch.Tensor, ids: torch.Tensor,
                         loss_mask: torch.Tensor, max_answer_len: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The hidden states that predict answer tokens. The loss region is
    contiguous, so each sample takes [start - 1, start - 1 + A) where start
    is its first masked slot. Returns (hidden_g [B, A, H], labels [B, A],
    valid [B, A])."""
    B, T, H = hidden.shape
    n_ans = loss_mask.sum(dim=1)
    start = loss_mask.int().argmax(dim=1)                  # first True (0 if none)
    offs = torch.arange(max_answer_len, device=hidden.device)[None, :]
    pred_idx = (start[:, None] - 1 + offs).clamp(0, T - 1)
    label_idx = (start[:, None] + offs).clamp(0, T - 1)
    hidden_g = torch.gather(hidden, 1, pred_idx[..., None].expand(-1, -1, H))
    return hidden_g, torch.gather(ids, 1, label_idx), offs < n_ans[:, None]


def _masked_ce(logits_fn, h, labels, valid):
    logits = logits_fn(h).float()
    gold = logits.gather(-1, labels[..., None]).squeeze(-1)
    return torch.where(valid, torch.logsumexp(logits, dim=-1) - gold,
                       torch.zeros((), device=h.device))


def language_loss_gathered(hidden_g: torch.Tensor, labels: torch.Tensor,
                           valid: torch.Tensor,
                           logits_fn: Callable[[torch.Tensor], torch.Tensor],
                           chunk: int = 32,
                           head_w: Optional[torch.Tensor] = None):
    """CE over the gathered answer positions. The [B, A, vocab] fp32 logits
    never exist whole: `chunk` positions at a time, each chunk under
    activation checkpointing, so the backward recomputes its logits (the
    JAX scan over a checkpointed body).

    head_w ([V, H], the tied embedding): when given and SIMLINGO_CE_IMPL is
    pallas (frozen head) or pallas_dw (the real dW), the CE runs the fused
    kernel instead, which keeps no logits at all
    (`simlingo_tpu/models/adaptors.py:217-226`)."""
    B, A, H = hidden_g.shape
    impl = gates.ce_impl()
    if head_w is not None and impl in ("pallas", "pallas_dw"):
        ce = fused_ce(hidden_g.reshape(B * A, H), labels.reshape(B * A),
                      head_w.to(hidden_g.dtype), impl == "pallas_dw").view(B, A)
        return {"language_loss": (torch.where(valid, ce, torch.zeros((), device=ce.device)),
                                  valid)}
    if chunk <= 0 or A <= chunk or A % chunk:
        return {"language_loss": (_masked_ce(logits_fn, hidden_g, labels, valid),
                                  valid)}
    parts = [checkpoint(_masked_ce, logits_fn, hidden_g[:, i:i + chunk],
                        labels[:, i:i + chunk], valid[:, i:i + chunk],
                        use_reentrant=False)
             for i in range(0, A, chunk)]
    return {"language_loss": (torch.cat(parts, dim=1), valid)}


def language_loss(logits: torch.Tensor, ids: torch.Tensor,
                  loss_mask: torch.Tensor):
    """Next-token CE over all text slots, the label being the next token
    and counted where loss_mask holds on it."""
    mask = loss_mask[:, 1:]
    ce = _masked_ce(lambda h: h, logits[:, :-1], ids[:, 1:], mask)
    return {"language_loss": (ce, mask)}
