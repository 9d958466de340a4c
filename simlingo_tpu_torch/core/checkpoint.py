"""Checkpoints of the training state, and the HF / torch weight import.

Counterpart of `simlingo_tpu/core/checkpoint.py` (`save_checkpoint` :45,
`latest_checkpoint` :107, `restore_checkpoint` :114, keep-N GC :130,
`load_hf_checkpoint` :160) in the port's own format instead of orbax:

  * a checkpoint is a directory `step_%08d` holding `params.pt` (the flat
    parameter tree {path: tensor} as it is trained: frozen leaves bf16,
    trainable masters fp32), `optimizer.pt` (the AdamW state dict) and
    `meta.json` (the step); any state with `params`, `optimizer` and
    `step` (train_step.TrainState, base_step.BaseTrainState) saves;
  * it is written to `step_%08d.tmp-<pid>` and renamed, so
    `latest_checkpoint` never lists a partial one;
  * `block=False` copies the state to the host synchronously and writes on
    one background thread, at most one save in flight; keep-N garbage
    collection runs after a blocking save, and before an async one once
    the previous write has finished (never on a partial directory);
  * the data order needs no state: the sampler is a pure function of
    (seed, step), so the step alone resumes it (data/sampler.py);
  * a state of a multi-GPU mesh (`state.mesh`) saves the same format: the
    shards of every leaf and AdamW moment are gathered (a collective every
    rank calls) and only the primary writes, as JAX writes its run
    artifacts on the primary (`trainer.py:294-301`); under pp the stages'
    layers (and their moments) are gathered too, and the optimizer's
    entries are numbered in the whole tree's order, as one process numbers
    them; restore reads the whole tree on every rank and keeps the rank's
    shards (a stage: its layers' alone), so a run saved on N ranks, at
    any mesh, resumes on M.

`save_hf_checkpoint` writes a trained model's parameters as the `.pt` of
a trained SimLingo (`hf_convert.simlingo_to_torch`), the form that
`load_hf_checkpoint` and `sim/suite.load_model_agent` read.

`load_hf_checkpoint` reads a `.bin` / `.pt` with `torch.load(weights_only=
True)` and a `.safetensors` with `read_safetensors`, the port's own reader
of that format (the `safetensors` package is not needed).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from simlingo_tpu_torch.parallel import mesh as meshlib
from simlingo_tpu_torch.parallel import multihost
from simlingo_tpu_torch.train.train_step import flatten

_writer: Optional[threading.Thread] = None
_writer_error: Optional[BaseException] = None


def wait_for_checkpoints() -> None:
    """Block until the save in flight (if any) is on disk; re-raises its
    error."""
    global _writer, _writer_error
    if _writer is not None:
        _writer.join()
        _writer = None
    if _writer_error is not None:
        err, _writer_error = _writer_error, None
        raise err


def _param_paths(state):
    """The optimizer's parameter index -> the leaf's path."""
    paths = {id(x): p for p, x in flatten(state.params).items()}
    return [paths[id(x)] for g in state.optimizer.param_groups for x in g["params"]]


def _whole_order(state, mine):
    """The optimizer's paths in the whole tree (every pp stage's, in the
    order of the layouts: one process's order) from this rank's `mine`;
    collective over pp."""
    if state.mesh.shape["pp"] == 1:
        return mine
    held = {p for part in state.mesh.comm["pp"].all_gather_object(mine) for p in part}
    return [p for p in state.layouts if p in held]


def _host_copy(state) -> Optional[Dict[str, Any]]:
    """The state's tensors on the host (a synchronous device-to-host copy);
    of a mesh, the whole tree gathered (collective; None off the primary)."""
    mesh = getattr(state, "mesh", None)
    if mesh is not None:
        lays = state.layouts
        params = {p: x.cpu() for p, x in meshlib.gather_tree(
            {p: x.detach() for p, x in flatten(state.params).items()}, lays, mesh).items()}
        opt = state.optimizer.state_dict()
        mine = _param_paths(state)
        entries = {}
        for i, path in enumerate(mine):
            entry = dict(opt["state"].get(i, {}))
            for k in ("exp_avg", "exp_avg_sq"):
                if k in entry:
                    entry[k] = meshlib.gather_leaf(entry[k], lays[path], mesh).cpu()
            entries[path] = entry
        entries = meshlib.gather_stages(entries, mesh)
        order = _whole_order(state, mine)
        if order is not mine:          # one param group, numbered as in one process
            opt["param_groups"] = [dict(opt["param_groups"][0], params=list(range(len(order))))]
        opt["state"] = {i: entries[p] for i, p in enumerate(order) if entries.get(p)}
        if not multihost.is_primary():
            return None
        return {"params": params, "optimizer": opt, "step": int(state.step)}

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().to("cpu", copy=True)
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x
    return {"params": {p: cpu(x) for p, x in flatten(state.params).items()},
            "optimizer": cpu(state.optimizer.state_dict()),
            "step": int(state.step)}


def _write(path: str, host: Dict[str, Any]) -> None:
    """params.pt, optimizer.pt (where `host` has an optimizer state: a
    converted save may not, `convert_orbax_torch.py`) and meta.json."""
    tmp = f"{path}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(host["params"], os.path.join(tmp, "params.pt"))
    if "optimizer" in host:
        torch.save(host["optimizer"], os.path.join(tmp, "optimizer.pt"))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": host["step"]}, f)
    os.rename(tmp, path)


def _write_async(path: str, host: Dict[str, Any]) -> None:
    global _writer_error
    try:
        _write(path, host)
    except BaseException as e:       # noqa: BLE001 -- raised by wait_for_checkpoints
        _writer_error = e
        shutil.rmtree(f"{path}.tmp-{os.getpid()}", ignore_errors=True)


def save_checkpoint(ckpt_dir: str, state, step: int, keep: Optional[int] = None,
                    block: bool = True) -> str:
    """Save `state` as `ckpt_dir/step_%08d` (nothing if it exists already).
    block=False returns once the host copy is made; the write runs on a
    background thread after the previous one has finished."""
    global _writer
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}"))
    wait_for_checkpoints()
    primary = multihost.is_primary()
    exists = os.path.isdir(path) if primary else False
    mesh = getattr(state, "mesh", None)
    if mesh is not None:             # the primary's view decides on every rank
        flag = torch.tensor([float(exists)], device=next(iter(flatten(state.params).values())).device)
        exists = bool(mesh.comm["world"].all_reduce(flag).item())
    if exists:                       # periodic and final saves collide
        if keep is not None and primary:   # an async save prunes before it writes
            _gc_checkpoints(ckpt_dir, keep)
        return path
    if primary:
        os.makedirs(ckpt_dir, exist_ok=True)
    host = _host_copy(state)
    if host is None:                 # a mesh's other ranks: the primary writes
        return path
    if block:
        _write(path, host)
        if keep is not None:
            _gc_checkpoints(ckpt_dir, keep)
        return path
    if keep is not None:             # nothing is in flight now
        _gc_checkpoints(ckpt_dir, keep)
    _writer = threading.Thread(target=_write_async, args=(path, host), daemon=True)
    _writer.start()
    return path


def _finished_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_") and "tmp" not in d)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    steps = _finished_steps(ckpt_dir)
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _gc_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Remove all but the newest `keep` finished checkpoints."""
    done = _finished_steps(ckpt_dir)
    for d in done[:max(len(done) - keep, 0)]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def restore_checkpoint(path: str, state):
    """Load a checkpoint into `state` in place (the parameters are copied
    into the existing tensors, so their devices and dtypes stay) and return
    it. Raises on a missing, extra or differently shaped leaf. A state whose
    `optimizer` is None takes the parameters and the step only (evaluation:
    a template of the trained leaves' dtypes). A mesh's state takes its
    rank's shards of the whole tree."""
    saved = torch.load(os.path.join(path, "params.pt"), map_location="cpu",
                       weights_only=True)
    leaves = flatten(state.params)
    mesh, lays = getattr(state, "mesh", None), getattr(state, "layouts", None)
    whole = set(lays) if mesh is not None else set(leaves)
    if set(saved) != whole:
        raise ValueError(f"checkpoint {path}: leaves differ from the state's: "
                         f"missing {sorted(whole - set(saved))[:4]}, "
                         f"extra {sorted(set(saved) - whole)[:4]}")
    with torch.no_grad():
        for p, x in leaves.items():
            shape = lays[p].shape if mesh is not None else tuple(x.shape)
            if tuple(saved[p].shape) != shape or saved[p].dtype != x.dtype:
                raise ValueError(f"checkpoint {path}: {p} is {saved[p].dtype} "
                                 f"{tuple(saved[p].shape)}, the state's {x.dtype} "
                                 f"{shape}")
            x.copy_(saved[p] if mesh is None else meshlib.shard_leaf(saved[p], lays[p], mesh))
    if state.optimizer is not None:
        opt = torch.load(os.path.join(path, "optimizer.pt"), map_location="cpu",
                         weights_only=True)
        if mesh is not None:
            mine = _param_paths(state)
            order = _whole_order(state, mine)
            index = {p: i for i, p in enumerate(order)}
            local = {}
            for i, p in enumerate(mine):
                entry = dict(opt["state"].get(index[p], {}))
                for k in ("exp_avg", "exp_avg_sq"):
                    if k in entry:
                        entry[k] = meshlib.shard_leaf(entry[k], lays[p], mesh)
                if entry:
                    local[i] = entry
            opt["state"] = local
            if order is not mine:
                opt["param_groups"] = [dict(opt["param_groups"][0],
                                            params=list(range(len(mine))))]
        state.optimizer.load_state_dict(opt)
    with open(os.path.join(path, "meta.json")) as f:
        state.step = int(json.load(f)["step"])
    return state


# ---------------------------------------------------------------------------
# HF / torch import
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
              "BOOL": torch.bool}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file: an 8-byte little-endian header length n, n
    bytes of JSON {name: {dtype, shape, data_offsets}}, then the raw
    little-endian bytes (offsets relative to the end of the header)."""
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    raw = torch.frombuffer(data, dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        start, end = info["data_offsets"]
        # a copy of its own bytes: aligned for `view`, and no view of `data`
        out[name] = raw[start:end].clone().view(dtype).reshape(info["shape"])
    return out


def _load_torch_state_dict(path: str) -> Dict[str, Any]:
    """A .pt / .bin / .safetensors file, or an HF directory of them."""
    def one(p):
        if p.endswith(".safetensors"):
            return read_safetensors(p)
        return torch.load(p, map_location="cpu", weights_only=True)

    if not os.path.isdir(path):
        return one(path)
    sd: Dict[str, Any] = {}
    for fn in sorted(os.listdir(path)):
        if fn.endswith(".safetensors") or fn in ("pytorch_model.bin", "pytorch_model.pt"):
            sd.update(one(os.path.join(path, fn)))
    if not sd:
        raise FileNotFoundError(f"no weights found in {path}")
    return sd


def load_hf_checkpoint(path: str, cfg, lora_merge: bool = True,
                       lora_alpha: float = 64.0, lora_r: int = 32) -> Dict[str, Any]:
    """A torch checkpoint -> the port's parameter tree (fp32 CPU tensors).

    Takes a raw InternVL2-1B checkpoint (remote-code names: vision, mlp1
    projector, LLM) or a trained SimLingo one (DrivingModel: vision_model.
    model.*, a peft-wrapped LLM, adaptors, wp_encoder). lora_merge=False
    keeps peft adapters unmerged in `params["lora"]` with the LLM's raw
    base_layer weights."""
    from simlingo_tpu_torch.core import hf_convert as C

    sd = _load_torch_state_dict(path)
    lora_tree = None
    if any(".lora_A." in k for k in sd):
        if lora_merge:
            sd = C.merge_lora_inplace(sd, alpha=lora_alpha, r=lora_r)
        else:
            lora_tree = C.lora_tree_from_torch(sd, cfg.llm.num_layers)
            sd = C.strip_peft_inplace(sd)

    def has_prefix(p):
        return any(k.startswith(p) for k in sd)

    params: Dict[str, Any] = {}
    if has_prefix("vision_model.model.vision_model."):
        base = "vision_model.model."
        params["vision"] = C.vit_from_torch_remote(sd, cfg.vit, prefix=base + "vision_model.")
        params["vision"]["projector"] = C.projector_from_torch(sd, prefix=base + "mlp1.")
        params["llm"] = C.qwen2_from_torch(sd, cfg.llm, prefix="language_model.model.model.")
        params["adaptors"] = _adaptors_from_torch(sd)
        params["wp_encoder"] = _mlp_stack(sd, "wp_encoder.mlp", (0, 2, 4))
    elif has_prefix("vision_model."):
        params["vision"] = C.vit_from_torch_remote(sd, cfg.vit, prefix="vision_model.")
        params["vision"]["projector"] = C.projector_from_torch(sd, "mlp1.")
        params["llm"] = C.qwen2_from_torch(sd, cfg.llm, prefix="language_model.model.")
    else:
        raise ValueError(f"unrecognized checkpoint layout: {sorted(sd)[:5]} ...")
    if lora_tree is not None and lora_tree["layers"]:
        params["lora"] = lora_tree
    return params


def save_hf_checkpoint(path: str, params, cfg) -> str:
    """`params` (a SimLingo tree, any device) -> `path`, a torch state dict
    in the trained-SimLingo layout, every tensor a contiguous CPU copy in
    its leaf's own dtype."""
    from simlingo_tpu_torch.core.hf_convert import simlingo_to_torch
    sd = {k: v.detach().to("cpu").contiguous()
          for k, v in simlingo_to_torch(params, cfg).items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save(sd, path)
    return path


def _mlp_stack(sd, prefix: str, layer_indices) -> Dict[str, Any]:
    from simlingo_tpu_torch.core.hf_convert import _linear
    return {f"l{i}": _linear(sd, f"{prefix}.{idx}") for i, idx in enumerate(layer_indices)}


def _adaptors_from_torch(sd) -> Dict[str, Any]:
    from simlingo_tpu_torch.core.hf_convert import _t
    p: Dict[str, Any] = {}
    if "adaptors.driving.query_embeds_wps" in sd:
        p["route_queries"] = _t(sd["adaptors.driving.query_embeds_wps"])
        p["route_head"] = _mlp_stack(sd, "adaptors.driving.route_head", (0, 2, 4))
    p["speed_queries"] = _t(sd["adaptors.driving.query_embeds_speed"])
    p["speed_head"] = _mlp_stack(sd, "adaptors.driving.speed_wps_head", (0, 2))
    return p
