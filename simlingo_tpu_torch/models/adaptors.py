"""Driving adaptors: waypoint encoder, learned query tokens, decode heads.

Counterpart of `simlingo_tpu/models/adaptors.py` (inference half): 20
route queries + 10 speed queries appended to the sequence; MLP heads emit
per-step deltas, and a cumsum over the step axis gives waypoints (in fp32).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

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
