#!/usr/bin/env python3
"""SimLingo-Base (CarLLaVA) training entry point of the PyTorch port.

    python3 train_base_torch.py --synthetic --experiment configs/simlingo_base.yaml
    python3 train_base_torch.py --synthetic max_steps=50 data.batch_size=16
    python3 train_base_torch.py --synthetic --tiny --device cpu max_steps=2

The counterpart of `train_base.py`: the config is composed as there
(core/config.py `compose_base`: `BaseTrainConfig()`, whose defaults are
JAX's `TrainConfig()`'s -- seed 42, batch 6, AdamW lr 3e-5, clip 0.3 --,
then `--experiment`, then dotted `key=value` overrides), and the
LLaVA-NeXT CLIP ViT-L/14-336 tower + the tiny LLaMA (`--tiny`: the
debug-size model) train from seeded random weights with the vision tower
at 0.1x the learning rate, each group clipped, on a new synthetic batch a
step, on the GPU. `configs/simlingo_base.yaml` gives lr 1e-4, clip 1.0
and batch 16 (`presets.simlingo_base()`). The run writes
`<output_dir>/<name>_base/config.json` and its final state under
`checkpoints/` there (core/checkpoint.py), output_dir `outputs` by
default; `output_dir=` (empty) writes nothing. Only `--synthetic` exists:
`train_base.py` draws synthetic batches on every run too. Under torchrun
or SLURM it trains over `mesh.dp` x `mesh.fsdp` x `mesh.tp` (CLIP and the
LLaMA split over tp; sp and pp are refused):

    torchrun --nproc-per-node 2 train_base_torch.py --synthetic mesh.tp=2
"""

import argparse
import dataclasses
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default=None,
                    help="configs/<name>.yaml or a path, e.g. configs/simlingo_base.yaml")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on synthetic batches (required)")
    ap.add_argument("--tiny", action="store_true", help="debug-size model")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args()
    if not args.synthetic:
        ap.error("only --synthetic training is ported for SimLingo-Base "
                 "(train_base.py draws synthetic batches too)")

    from simlingo_tpu_torch.core.config import compose_base
    from simlingo_tpu_torch.models.simlingo_base import SimLingoBaseConfig
    from simlingo_tpu_torch.train import trainer

    cfg = compose_base(args.experiment, args.overrides)
    if args.tiny:
        cfg = dataclasses.replace(cfg, model=SimLingoBaseConfig.tiny())
    trainer.train_base(cfg, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
