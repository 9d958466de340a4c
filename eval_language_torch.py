#!/usr/bin/env python3
"""Language / dreamer evaluation entry point of the PyTorch port.

    python3 eval_language_torch.py --checkpoint outputs/run/checkpoints/step_x \\
        --mode QA --data-root database/simlingo
    python3 eval_language_torch.py --checkpoint simlingo.pt --mode Dreaming \\
        --data-root DIR --device cpu

The counterpart of `eval_language.py`, with the same options and
`--device` (default cuda). The model is `presets.internvl2_1b()`, its
`speed_wps_mode` / `predict_route_as_wps` taken from `<run>/config.json`
where the checkpoint's run directory has one (the trainer writes it). A
`step_*` checkpoint directory of the port's trainer restores into a
template of the trained leaves (`models/simlingo.py:init_params`, frozen
leaves bf16); a `.pt` / `.bin` / `.safetensors` file, or any path without
`step_`, loads through `core/checkpoint.py:load_hf_checkpoint`. The
`split="val"` routes under --data-root are evaluated in batches of
--batch-size, greedy, bf16 on the GPU (fp32 on the CPU); the JSONs go to
--output-dir (eval/language_eval.py).
"""

import argparse
import json


def load_params(checkpoint: str, model_cfg, device):
    """The checkpoint's parameter tree (see the module docstring)."""
    import types

    import torch

    from simlingo_tpu_torch.core import checkpoint as ckpt
    from simlingo_tpu_torch.core.device import resolve_device
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.train import train_step as ts

    if any(checkpoint.endswith(s) for s in (".pt", ".bin", ".safetensors")) \
            or "step_" not in checkpoint:
        return ckpt.load_hf_checkpoint(checkpoint, model_cfg)
    dev = resolve_device(device)
    template = ts.cast_frozen(simlingo.init_params(
        model_cfg, torch.Generator(device=dev).manual_seed(0), device=dev),
        ts.production_trainable)
    state = types.SimpleNamespace(params=template, optimizer=None, step=0)
    return ckpt.restore_checkpoint(checkpoint, state).params


def model_config(checkpoint: str):
    """presets.internvl2_1b(), with the run's speed_wps_mode and
    predict_route_as_wps where <run>/config.json exists."""
    import dataclasses
    import os

    from simlingo_tpu_torch.core.presets import internvl2_1b

    model_cfg = internvl2_1b()
    run_dir = os.path.dirname(os.path.dirname(os.path.abspath(checkpoint)))
    run_cfg_path = os.path.join(run_dir, "config.json")
    if os.path.isfile(run_cfg_path):
        with open(run_cfg_path) as f:
            m = json.load(f).get("model", {})
        if m.get("speed_wps_mode"):
            model_cfg = dataclasses.replace(
                model_cfg, speed_wps_mode=m["speed_wps_mode"],
                predict_route_as_wps=m.get("predict_route_as_wps", True))
    return model_cfg


def eval_dataset(data_root: str, mode: str):
    """The `split="val"` dataset of a mode, without augmentation."""
    from simlingo_tpu_torch.data.dreamer_dataset import (DreamerDataset,
                                                         DreamerDatasetConfig)
    from simlingo_tpu_torch.data.driving_dataset import (DrivingDataset,
                                                         DrivingDatasetConfig)

    dcfg_kwargs = dict(
        data_root=data_root, split="val",
        use_commentary=mode == "commentary",
        use_qa=mode == "QA",
        commentary_augmentation=False, qa_augmentation=False,
        img_shift_augmentation=False)
    if mode == "Dreaming":
        return DreamerDataset(DreamerDatasetConfig(
            **dcfg_kwargs, use_safety_flag=True))
    return DrivingDataset(DrivingDatasetConfig(**dcfg_kwargs))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoint", required=True,
                    help="the port's step_* checkpoint dir, or a torch/HF checkpoint")
    ap.add_argument("--mode", default="QA",
                    choices=["QA", "commentary", "Dreaming"])
    ap.add_argument("--data-root", required=True)
    ap.add_argument("--eval-set", default=None,
                    help="json list of sample indices (default: all)")
    ap.add_argument("--tokenizer", default=None)
    ap.add_argument("--output-dir", default="predictions")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--num-samples", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from simlingo_tpu_torch.core.device import resolve_device
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.eval.language_eval import EvalConfig, run_language_eval

    dev = resolve_device(args.device)
    model_cfg = model_config(args.checkpoint)
    params = load_params(args.checkpoint, model_cfg, dev)

    dataset = eval_dataset(args.data_root, args.mode)
    if args.eval_set:
        with open(args.eval_set) as f:
            samples = json.load(f)
    else:
        samples = list(range(len(dataset)))
    if args.num_samples:
        samples = samples[: args.num_samples]

    tok = SimLingoTokenizer(args.tokenizer)
    results = run_language_eval(
        params, model_cfg, samples, dataset, tok,
        EvalConfig(mode=args.mode, batch_size=args.batch_size,
                   output_dir=args.output_dir),
        compute_dtype=torch.bfloat16 if dev.type == "cuda" else torch.float32,
        device=dev)
    print(json.dumps(results.get("metrics", {}), indent=2))
    if "dreamer" in results:
        print(json.dumps(results["dreamer"], indent=2))
    return results


if __name__ == "__main__":
    main()
