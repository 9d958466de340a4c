#!/usr/bin/env python3
"""SimLingo-Base (CarLLaVA) training entry point of the PyTorch port.

    python3 train_base_torch.py --synthetic max_steps=50 data.batch_size=16
    python3 train_base_torch.py --synthetic --tiny --device cpu max_steps=2

The counterpart of `train_base.py`: `presets.simlingo_base()` (the
LLaVA-NeXT CLIP ViT-L/14-336 tower + the tiny LLaMA, seed 42, AdamW lr
1e-4 with the vision tower at 0.1x, each group clipped to 1.0, OneCycle,
batch 16) from seeded random weights, a new synthetic batch a step, on the
GPU. `--tiny` takes the debug-size model. Dotted `key=value` pairs
override the config (core/config.py BaseTrainConfig); `output_dir=DIR`
saves the final state to DIR/checkpoints (core/checkpoint.py). Only
`--synthetic` exists: the base stack's disk data path is not ported
(ROADMAP A16).
"""

import argparse
import dataclasses
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic batches (required)")
    ap.add_argument("--tiny", action="store_true", help="debug-size model")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args()
    if not args.synthetic:
        ap.error("only --synthetic training is ported for SimLingo-Base "
                 "(its disk data path is not)")

    from simlingo_tpu_torch.core.config import compose_base
    from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
    from simlingo_tpu_torch.train import trainer

    cfg = compose_base(args.overrides)
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=SimLingoBaseConfig.tiny())
    trainer.train_base(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
