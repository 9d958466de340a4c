"""Post-training int8 / int4 weight quantization for the serving path.

Counterpart of `simlingo_tpu/core/quantize.py`. Every transformer linear
becomes {"w_q", "scale", "b"?} and the tied [V, H] embedding is quantized
by rows, which serves both the gather and the LM head; all products then
take the one [N, K] layout of kernels/quantized_matmul.py. int8 (the
default): w_q int8 [N, K], one fp32 scale a row [N]. int4 (opt-in,
`bits=4`): codes nibble-packed along K, w_q int8 [N, K // 2], and one fp32
scale a (row, group of `group` columns), [N, K // group]. The layers tell
the two apart by the scale's rank, as JAX's do. Norm scales are kept as
they are.
"""

from __future__ import annotations

from typing import Any, Dict

from simlingo_tpu_torch.kernels.quantized_matmul import (quantize_weight,
                                                         quantize_weight4)

_LLM_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")


def _quantize(w, bits: int, group: int):
    if bits == 4:
        return quantize_weight4(w, group)
    if bits == 8:
        return quantize_weight(w, axis=0)
    raise ValueError(f"bits must be 8 or 4, got {bits}")


def quantize_linear(p: Dict[str, Any], bits: int = 8,
                    group: int = 128) -> Dict[str, Any]:
    w_q, scale = _quantize(p["w"], bits, group)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_embedding(p: Dict[str, Any], bits: int = 8,
                       group: int = 128) -> Dict[str, Any]:
    """[V, H] table, per-row scales (int4: per-row groups)."""
    w_q, scale = _quantize(p["w"], bits, group)
    return {"w_q": w_q, "scale": scale}


def quantize_llm(llm_params: Dict[str, Any], bits: int = 8,
                 group: int = 128) -> Dict[str, Any]:
    """Quantize every transformer linear + the (tied) embedding table.
    LoRA must be merged first (qwen2.merge_lora)."""
    out: Dict[str, Any] = {"embed": quantize_embedding(llm_params["embed"], bits, group),
                           "final_norm": llm_params["final_norm"], "layers": {}}
    if "lm_head" in llm_params:
        out["lm_head"] = quantize_linear(llm_params["lm_head"], bits, group)
    for i, layer in llm_params["layers"].items():
        out["layers"][i] = {
            "ln1": layer["ln1"], "ln2": layer["ln2"],
            **{grp: {k: (quantize_linear(v, bits, group) if k in _LLM_LINEARS else v)
                     for k, v in layer[grp].items()}
               for grp in ("attn", "mlp")},
        }
    return out


def quantize_for_inference(params: Dict[str, Any], llm_cfg=None, bits: int = 8,
                           group: int = 128) -> Dict[str, Any]:
    """The whole model for serving: LoRA merged first where there is a
    config to scale it (else dropped), then the LLM quantized; the vision
    tower and the adaptors keep their dtype (JAX's :86-99)."""
    from simlingo_tpu_torch.models import qwen2

    params = dict(params)
    llm = params["llm"]
    lora = params.pop("lora", None)
    if lora is not None and llm_cfg is not None:
        llm = qwen2.merge_lora(llm, lora, llm_cfg)
    params["llm"] = quantize_llm(llm, bits, group)
    return params
