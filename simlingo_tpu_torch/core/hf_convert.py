"""HF / remote-code / peft state dicts -> the port's parameter tree.

Counterpart of `simlingo_tpu/core/hf_convert.py`, for the port's layout:
linears keep torch's [out, in] (JAX transposes them to [in, out]), the
patch embedding's OIHW kernel becomes [out, kh * kw * in] in the (kh, kw,
in) order of `vit._patchify`, and LoRA factors keep peft's A [r, in] /
B [out, r]. So a leaf of this tree equals `params_from_jax` of JAX's
converted leaf. Every leaf comes back as a float32 CPU tensor.

Two naming schemes: transformers-native InternVL (`InternVLVisionModel` /
`Qwen2Model`) and OpenGVLab's remote-code InternVL2 (fused
`attn.qkv`), the format of InternVL2-1B and of RenzKa/simlingo's trained
checkpoints. peft adapters are merged (W += alpha / r * B @ A,
`merge_lora_inplace`) or carried unmerged (`lora_tree_from_torch`).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch


def _t(x) -> torch.Tensor:
    """A state-dict entry as a float32 CPU tensor."""
    return torch.as_tensor(x).detach().to("cpu", torch.float32).contiguous()


def _linear(sd: Mapping[str, Any], prefix: str, bias: Optional[bool] = None
            ) -> Dict[str, torch.Tensor]:
    p = {"w": _t(sd[f"{prefix}.weight"])}
    if bias is None:
        bias = f"{prefix}.bias" in sd
    if bias:
        p["b"] = _t(sd[f"{prefix}.bias"])
    return p


def qwen2_from_torch(sd: Mapping[str, Any], cfg, prefix: str = "") -> Dict[str, Any]:
    """transformers-native Qwen2 naming (model.layers.N.self_attn.q_proj ...)."""
    def key(s):
        return f"{prefix}{s}"

    p: Dict[str, Any] = {
        "embed": {"w": _t(sd[key("embed_tokens.weight")])},
        "final_norm": {"scale": _t(sd[key("norm.weight")])},
        "layers": {},
    }
    if not cfg.tie_word_embeddings and key("lm_head.weight") in sd:
        p["lm_head"] = {"w": _t(sd[key("lm_head.weight")])}
    for i in range(cfg.num_layers):
        lp = key(f"layers.{i}.")
        p["layers"][str(i)] = {
            "ln1": {"scale": _t(sd[f"{lp}input_layernorm.weight"])},
            "ln2": {"scale": _t(sd[f"{lp}post_attention_layernorm.weight"])},
            "attn": {n: _linear(sd, f"{lp}self_attn.{n}_proj") for n in "qkvo"},
            "mlp": {n: _linear(sd, f"{lp}mlp.{n}_proj") for n in ("gate", "up", "down")},
        }
    return p


def _conv_patch_embed(w: torch.Tensor, b: torch.Tensor) -> Dict[str, torch.Tensor]:
    o, i, kh, kw = w.shape              # OIHW -> [out, (kh, kw, in)]
    return {"w": w.permute(0, 2, 3, 1).reshape(o, kh * kw * i).contiguous(), "b": b}


def vit_from_torch_native(sd: Mapping[str, Any], cfg, prefix: str = "") -> Dict[str, Any]:
    """transformers-native InternVLVisionModel naming."""
    def key(s):
        return f"{prefix}{s}"

    p: Dict[str, Any] = {
        "patch_embed": _conv_patch_embed(
            _t(sd[key("embeddings.patch_embeddings.projection.weight")]),
            _t(sd[key("embeddings.patch_embeddings.projection.bias")])),
        "cls_token": _t(sd[key("embeddings.cls_token")]),
        "pos_embed": _t(sd[key("embeddings.position_embeddings")]),
        "layers": {},
    }
    for i in range(cfg.num_layers):
        lp = key(f"encoder.layer.{i}.")
        p["layers"][str(i)] = {
            "ln1": {"scale": _t(sd[f"{lp}layernorm_before.weight"]),
                    "bias": _t(sd[f"{lp}layernorm_before.bias"])},
            "ln2": {"scale": _t(sd[f"{lp}layernorm_after.weight"]),
                    "bias": _t(sd[f"{lp}layernorm_after.bias"])},
            "attn": {"q": _linear(sd, f"{lp}attention.q_proj"),
                     "k": _linear(sd, f"{lp}attention.k_proj"),
                     "v": _linear(sd, f"{lp}attention.v_proj"),
                     "o": _linear(sd, f"{lp}attention.projection_layer")},
            "ls1": _t(sd[f"{lp}lambda_1"]),
            "ls2": _t(sd[f"{lp}lambda_2"]),
            "mlp": {"fc1": _linear(sd, f"{lp}mlp.fc1"), "fc2": _linear(sd, f"{lp}mlp.fc2")},
        }
    return p


def vit_from_torch_remote(sd: Mapping[str, Any], cfg,
                          prefix: str = "vision_model.") -> Dict[str, Any]:
    """OpenGVLab remote-code InternVisionModel naming (fused qkv [3H, H])."""
    def key(s):
        return f"{prefix}{s}"

    H = cfg.hidden_size
    p: Dict[str, Any] = {
        "patch_embed": _conv_patch_embed(
            _t(sd[key("embeddings.patch_embedding.weight")]),
            _t(sd[key("embeddings.patch_embedding.bias")])),
        "cls_token": _t(sd[key("embeddings.class_embedding")]),
        "pos_embed": _t(sd[key("embeddings.position_embedding")]),
        "layers": {},
    }
    for i in range(cfg.num_layers):
        lp = key(f"encoder.layers.{i}.")
        qkv_w = _t(sd[f"{lp}attn.qkv.weight"])
        attn = {n: {"w": qkv_w[j * H:(j + 1) * H].clone()} for j, n in enumerate("qkv")}
        attn["o"] = _linear(sd, f"{lp}attn.proj")
        if f"{lp}attn.qkv.bias" in sd:
            qkv_b = _t(sd[f"{lp}attn.qkv.bias"])
            for j, n in enumerate("qkv"):
                attn[n]["b"] = qkv_b[j * H:(j + 1) * H].clone()
        p["layers"][str(i)] = {
            "ln1": {"scale": _t(sd[f"{lp}norm1.weight"]), "bias": _t(sd[f"{lp}norm1.bias"])},
            "ln2": {"scale": _t(sd[f"{lp}norm2.weight"]), "bias": _t(sd[f"{lp}norm2.bias"])},
            "attn": attn,
            "ls1": _t(sd[f"{lp}ls1"]),
            "ls2": _t(sd[f"{lp}ls2"]),
            "mlp": {"fc1": _linear(sd, f"{lp}mlp.fc1"), "fc2": _linear(sd, f"{lp}mlp.fc2")},
        }
    return p


def projector_from_torch(sd: Mapping[str, Any], prefix: str = "mlp1.") -> Dict[str, Any]:
    """InternVL2 remote-code mlp1 projector: [LN, Linear, GELU, Linear]."""
    return {"ln": {"scale": _t(sd[f"{prefix}0.weight"]), "bias": _t(sd[f"{prefix}0.bias"])},
            "fc1": _linear(sd, f"{prefix}1"), "fc2": _linear(sd, f"{prefix}3")}


def projector_from_torch_native(sd: Mapping[str, Any],
                                prefix: str = "multi_modal_projector.") -> Dict[str, Any]:
    return {"ln": {"scale": _t(sd[f"{prefix}layer_norm.weight"]),
                   "bias": _t(sd[f"{prefix}layer_norm.bias"])},
            "fc1": _linear(sd, f"{prefix}linear_1"), "fc2": _linear(sd, f"{prefix}linear_2")}


# ---------------------------------------------------------------------------
# LoRA (peft state dicts)
# ---------------------------------------------------------------------------

_PEFT_PROJ_NAMES = {"q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
                    "gate_proj": "gate", "up_proj": "up", "down_proj": "down"}


def lora_tree_from_torch(sd: Mapping[str, Any], num_layers: int) -> Dict[str, Any]:
    """peft adapters, unmerged, in the `qwen2.init_lora_params` tree:
    layers/{i}/{q,k,v,o,gate,up,down}/{a [r, in], b [out, r]}. Targets that
    a checkpoint does not adapt are absent."""
    layers: Dict[str, Dict[str, Any]] = {}
    for k in sd:
        if ".lora_A." not in k:
            continue
        parts = k.split(".lora_A.")[0].split(".")
        proj = _PEFT_PROJ_NAMES.get(parts[-1])
        try:
            li = parts[parts.index("layers") + 1]
        except (ValueError, IndexError):
            continue
        b_key = k.replace(".lora_A.", ".lora_B.")
        if proj is None or int(li) >= num_layers or b_key not in sd:
            continue
        layers.setdefault(li, {})[proj] = {"a": _t(sd[k]), "b": _t(sd[b_key])}
    return {"layers": layers}


def _clean(k: str) -> str:
    return k.replace("base_model.model.", "").replace(".modules_to_save.default", "")


def strip_peft_inplace(sd: Dict[str, Any]) -> Dict[str, Any]:
    """peft-wrapped names -> clean names WITHOUT merging (base_layer.weight ->
    weight; lora_A/B dropped: take them first with lora_tree_from_torch)."""
    return {_clean(k.replace(".base_layer.weight", ".weight")
                   .replace(".base_layer.bias", ".bias")): v
            for k, v in sd.items() if ".lora_A." not in k and ".lora_B." not in k}


def merge_lora_inplace(sd: Dict[str, Any], alpha: float, r: int) -> Dict[str, Any]:
    """Merge peft LoRA into the base layers (W += alpha / r * B @ A, fp32) and
    strip the peft prefixes. Returns a new flat dict with clean names."""
    out: Dict[str, Any] = {}
    scale = alpha / r
    for k, v in sd.items():
        if ".lora_A." in k or ".lora_B." in k:
            continue
        if k.endswith(".base_layer.weight"):
            mod = k[: -len(".base_layer.weight")]
            w = _t(v)
            a_key, b_key = f"{mod}.lora_A.default.weight", f"{mod}.lora_B.default.weight"
            if a_key in sd and b_key in sd:
                w = w + scale * (_t(sd[b_key]) @ _t(sd[a_key]))
            out[f"{mod}.weight"] = w
        elif k.endswith(".base_layer.bias"):
            out[f"{k[: -len('.base_layer.bias')]}.bias"] = _t(v)
        else:
            out[k] = v
    return {_clean(k): v for k, v in out.items()}


# ---------------------------------------------------------------------------
# the port's tree -> a trained-SimLingo state dict
# ---------------------------------------------------------------------------

def _put_linear(sd: Dict[str, Any], prefix: str, p: Mapping[str, Any]) -> None:
    sd[f"{prefix}.weight"] = p["w"]
    if "b" in p:
        sd[f"{prefix}.bias"] = p["b"]


def simlingo_to_torch(params: Mapping[str, Any], cfg) -> Dict[str, Any]:
    """The inverse of `checkpoint.load_hf_checkpoint` on a trained SimLingo
    (DrivingModel names: `vision_model.model.*` with the remote-code fused
    qkv and the mlp1 projector, `language_model.model.model.*`, the
    driving adaptors and the waypoint encoder). A `params["lora"]` tree is
    merged into the LLM's linears (`qwen2.merge_lora`: W += alpha / r * B A),
    so the dict holds no peft names. Tensors keep their device and dtype."""
    sd: Dict[str, Any] = {}
    v, vc = params["vision"], cfg.vit
    vp = "vision_model.model.vision_model."
    w = v["patch_embed"]["w"]               # [out, (kh, kw, in)] -> OIHW
    P = vc.patch_size
    sd[vp + "embeddings.patch_embedding.weight"] = \
        w.reshape(w.shape[0], P, P, -1).permute(0, 3, 1, 2).contiguous()
    sd[vp + "embeddings.patch_embedding.bias"] = v["patch_embed"]["b"]
    sd[vp + "embeddings.class_embedding"] = v["cls_token"]
    sd[vp + "embeddings.position_embedding"] = v["pos_embed"]
    for i in range(vc.num_layers):
        lay, lp = v["layers"][str(i)], vp + f"encoder.layers.{i}."
        a = lay["attn"]
        sd[lp + "attn.qkv.weight"] = torch.cat([a[n]["w"] for n in "qkv"])
        if "b" in a["q"]:
            sd[lp + "attn.qkv.bias"] = torch.cat([a[n]["b"] for n in "qkv"])
        _put_linear(sd, lp + "attn.proj", a["o"])
        for n in ("1", "2"):
            sd[lp + f"norm{n}.weight"] = lay[f"ln{n}"]["scale"]
            sd[lp + f"norm{n}.bias"] = lay[f"ln{n}"]["bias"]
            sd[lp + f"ls{n}"] = lay[f"ls{n}"]
            _put_linear(sd, lp + f"mlp.fc{n}", lay["mlp"][f"fc{n}"])
    pr, mp = v["projector"], "vision_model.model.mlp1."
    sd[mp + "0.weight"], sd[mp + "0.bias"] = pr["ln"]["scale"], pr["ln"]["bias"]
    _put_linear(sd, mp + "1", pr["fc1"])
    _put_linear(sd, mp + "3", pr["fc2"])

    l, lc = params["llm"], cfg.llm
    if params.get("lora", {}).get("layers"):
        from simlingo_tpu_torch.models.qwen2 import merge_lora
        l = merge_lora(l, params["lora"], lc)
    pre = "language_model.model.model."
    sd[pre + "embed_tokens.weight"] = l["embed"]["w"]
    sd[pre + "norm.weight"] = l["final_norm"]["scale"]
    if "lm_head" in l:
        sd[pre + "lm_head.weight"] = l["lm_head"]["w"]
    for i in range(lc.num_layers):
        lay, lp = l["layers"][str(i)], pre + f"layers.{i}."
        sd[lp + "input_layernorm.weight"] = lay["ln1"]["scale"]
        sd[lp + "post_attention_layernorm.weight"] = lay["ln2"]["scale"]
        for n in "qkvo":
            _put_linear(sd, f"{lp}self_attn.{n}_proj", lay["attn"][n])
        for n in ("gate", "up", "down"):
            _put_linear(sd, f"{lp}mlp.{n}_proj", lay["mlp"][n])

    ad = params["adaptors"]
    if "route_queries" in ad:
        sd["adaptors.driving.query_embeds_wps"] = ad["route_queries"]
        for j, idx in enumerate((0, 2, 4)):
            _put_linear(sd, f"adaptors.driving.route_head.{idx}", ad["route_head"][f"l{j}"])
    sd["adaptors.driving.query_embeds_speed"] = ad["speed_queries"]
    for j, idx in enumerate((0, 2)):
        _put_linear(sd, f"adaptors.driving.speed_wps_head.{idx}", ad["speed_head"][f"l{j}"])
    for j, idx in enumerate((0, 2, 4)):
        _put_linear(sd, f"wp_encoder.mlp.{idx}", params["wp_encoder"][f"l{j}"])
    return sd
