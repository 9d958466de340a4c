"""Post-training int8 weight quantization for the serving path.

Counterpart of `simlingo_tpu/core/quantize.py`. Every transformer linear
becomes {"w_q" int8 [N, K], "scale" f32 [N], "b"?} and the tied [V, H]
embedding gets per-row scales, which serve both the gather and the LM
head; all int8 products then take the one [N, K] layout of
kernels/quantized_matmul.py. Norm scales are kept as they are.
"""

from __future__ import annotations

from typing import Any, Dict

from simlingo_tpu_torch.kernels.quantized_matmul import quantize_weight

_LLM_LINEARS = ("q", "k", "v", "o", "gate", "up", "down")


def _check_bits(bits: int) -> None:
    if bits != 8:
        raise NotImplementedError(
            f"{bits}-bit weights are not ported yet (ROADMAP A8: int4 "
            "group-128 w4a16); use bits=8")


def quantize_linear(p: Dict[str, Any], bits: int = 8) -> Dict[str, Any]:
    _check_bits(bits)
    w_q, scale = quantize_weight(p["w"], axis=0)
    out = {"w_q": w_q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_llm(llm_params: Dict[str, Any], bits: int = 8) -> Dict[str, Any]:
    """Quantize every transformer linear + the (tied) embedding table.
    LoRA must be merged first (qwen2.merge_lora)."""
    _check_bits(bits)
    w_q, scale = quantize_weight(llm_params["embed"]["w"], axis=0)
    out: Dict[str, Any] = {"embed": {"w_q": w_q, "scale": scale},
                           "final_norm": llm_params["final_norm"], "layers": {}}
    if "lm_head" in llm_params:
        out["lm_head"] = quantize_linear(llm_params["lm_head"], bits)
    for i, layer in llm_params["layers"].items():
        out["layers"][i] = {
            "ln1": layer["ln1"], "ln2": layer["ln2"],
            **{grp: {k: (quantize_linear(v, bits) if k in _LLM_LINEARS else v)
                     for k, v in layer[grp].items()}
               for grp in ("attn", "mlp")},
        }
    return out
