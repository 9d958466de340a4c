"""Offline language evaluation runner.

Counterpart of `simlingo_tpu/eval/language_eval.py` (`EvalConfig` :26,
`run_language_eval` :43): three modes (QA / commentary / Dreaming); the
samples are fetched with one `RandomState(0)`, collated in chunks of
`batch_size` (the last one padded to the full batch with its last sample,
as JAX pads it for a static shape), left-padded for inference, and run
through batched greedy `runner.generate_and_drive`; writes
`language_preds_{cot,qa,all}.json`, `sorted_qa_templates.json`,
`eval_results.json` and, in Dreaming mode, `dreamer_results.json`, with
the same contents as JAX's.

The weights are cast once to the compute dtype on `device` (the port holds
every weight in the compute dtype), and, as `LingoAgent` does, the model's
`<IMG_CONTEXT>` id takes the tokenizer's where the two differ.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from simlingo_tpu_torch.core.device import resolve_device
from simlingo_tpu_torch.core.structs import DrivingExample
from simlingo_tpu_torch.data.collate import CollateConfig, collate, to_device
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.eval import dreamer_rules, metrics
from simlingo_tpu_torch.infer import runner
from simlingo_tpu_torch.models.simlingo import SimLingoConfig
from simlingo_tpu_torch.train.train_step import map_leaves


@dataclasses.dataclass
class EvalConfig:
    mode: str = "QA"                 # QA | commentary | Dreaming
    batch_size: int = 8
    max_new_tokens: int = 100
    output_dir: str = "predictions"
    max_text_len: int = 768


def load_eval_set(path: str) -> List[Dict]:
    """evalset json: list of {route, frame} sample descriptors."""
    with open(path) as f:
        return json.load(f)


def _on_device(params, device, dtype):
    return map_leaves(lambda _, x: x.to(device, dtype) if x.is_floating_point()
                      else x.to(device), params)


def eval_batches(samples: Sequence, dataset, tok: SimLingoTokenizer,
                 cfg: EvalConfig) -> Iterator[Tuple[List[Any], DrivingExample]]:
    """(the chunk's RawSamples, its collated batch on the host) for each
    chunk of `cfg.batch_size` samples, fetched with one RandomState(0); the
    last chunk's batch is padded with its last sample to the full size."""
    ccfg = CollateConfig(max_text_len=cfg.max_text_len, pad_side_infer="left")
    rng = np.random.RandomState(0)
    B = cfg.batch_size

    def fetch(entry):
        if isinstance(entry, tuple):
            j, template = entry
            try:
                return dataset.get(j, rng, force_qa=template)
            except TypeError:
                return dataset.get(j, rng)
        return dataset.get(entry, rng)

    for i in range(0, len(samples), B):
        chunk = [fetch(e) for e in samples[i:i + B]]
        raw = chunk + [chunk[-1]] * (B - len(chunk))     # static batch shape
        yield chunk, collate(raw, tok, ccfg)


def run_language_eval(params, model_cfg: SimLingoConfig, samples: Sequence,
                      dataset, tok: SimLingoTokenizer, cfg: EvalConfig,
                      compute_dtype=torch.bfloat16, device="cuda") -> Dict[str, Any]:
    """samples: dataset indices, or (index, (question, answer)) pairs for
    QA eval sets; dataset yields RawSamples with eval metadata. Returns and
    writes the prediction / results JSONs."""
    dev = resolve_device(device)
    if model_cfg.img_context_token_id != tok.img_context_id:
        model_cfg = dataclasses.replace(model_cfg,
                                        img_context_token_id=tok.img_context_id)
    params = _on_device(params, dev, compute_dtype)
    gen_cfg = runner.GenerateConfig(max_new_tokens=cfg.max_new_tokens,
                                    eos_token_id=tok.eos_token_id)

    preds: Dict[str, List] = {
        "language": [], "language_gt": [], "prompt": [], "path": [],
        "route": [], "speed_wps": [], "route_gt": [], "waypoints_gt": [],
        "qa_templates": [], "eval_infos": [],
    }
    for chunk, ex in eval_batches(samples, dataset, tok, cfg):
        ex, _ = to_device(ex, dev)
        out = runner.generate_and_drive(params, ex.driving_input, model_cfg, gen_cfg,
                                        compute_dtype=compute_dtype)
        tokens = out.language_tokens.cpu()
        lengths = out.language_lengths.cpu()
        route = out.route.float().cpu().numpy()
        speed_wps = out.speed_wps.float().cpu().numpy()
        for b, s in enumerate(chunk):
            preds["language"].append(tok.decode(tokens[b, :int(lengths[b])].tolist()))
            preds["language_gt"].append(s.answer)
            preds["prompt"].append(s.question)
            preds["path"].append(s.measurement_path)
            preds["route"].append(route[b].tolist())
            preds["speed_wps"].append(speed_wps[b].tolist())
            preds["route_gt"].append(np.asarray(s.path).tolist())
            preds["waypoints_gt"].append(np.asarray(s.waypoints).tolist())
            preds["qa_templates"].append(s.qa_template)
            preds["eval_infos"].append(s.eval_infos)

    os.makedirs(cfg.output_dir, exist_ok=True)
    results: Dict[str, Any] = {}

    # language predictions, grouped as the reference groups them
    idx_cot = [i for i, p in enumerate(preds["prompt"])
               if "What should the ego do next?" in p]
    idx_qa = [i for i, p in enumerate(preds["prompt"]) if "Q:" in p]
    groups = {"cot": idx_cot, "qa": idx_qa,
              "all": list(range(len(preds["prompt"])))}
    for name, idxs in groups.items():
        rows = [(preds["language"][i], preds["language_gt"][i],
                 preds["path"][i]) for i in idxs]
        with open(os.path.join(cfg.output_dir,
                               f"language_preds_{name}.json"), "w") as f:
            json.dump(rows, f, indent=2)

    if idx_qa:
        sorted_samples: Dict[str, Dict[str, List]] = {}
        for i in idx_qa:
            t = preds["qa_templates"][i]
            if not t:
                continue
            q, a = t
            sorted_samples.setdefault(q, {}).setdefault(a, []).append(
                (preds["language"][i], preds["language_gt"][i],
                 preds["path"][i]))
        with open(os.path.join(cfg.output_dir,
                               "sorted_qa_templates.json"), "w") as f:
            json.dump(sorted_samples, f, indent=2)

    results["metrics"] = metrics.evaluation_suite(preds["language"],
                                                  preds["language_gt"])

    if cfg.mode == "Dreaming":
        rows = []
        for i, info in enumerate(preds["eval_infos"]):
            if not info:
                continue
            target_speed = _parse_target_speed(preds["prompt"][i])
            cur_speed = _parse_current_speed(preds["prompt"][i])
            success = dreamer_rules.evaluate_sample(
                info["mode"],
                np.asarray(preds["speed_wps"][i]),
                np.asarray(preds["route"][i]),
                np.asarray(info["org_wps"]), np.asarray(info["org_path"]),
                np.asarray(info["new_wps"]), np.asarray(info["new_path"]),
                cur_speed, target_speed)
            rows.append({"mode": info["mode"], "success": success,
                         "allowed": info.get("allowed", True)})
        results["dreamer"] = dreamer_rules.aggregate(rows)
        with open(os.path.join(cfg.output_dir,
                               "dreamer_results.json"), "w") as f:
            json.dump(results["dreamer"], f, indent=2)

    with open(os.path.join(cfg.output_dir, "eval_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


def _parse_current_speed(prompt: str) -> float:
    m = re.search(r"Current speed: ([\d.]+)", prompt)
    return float(m.group(1)) if m else 0.0


def _parse_target_speed(prompt: str) -> Optional[float]:
    m = re.search(r"(\d+(?:\.\d+)?) m/s[.!]?\s*$", prompt)
    try:
        return float(m.group(1)) if m else None
    except ValueError:
        return None
