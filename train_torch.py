#!/usr/bin/env python3
"""Training entry point of the PyTorch port (simlingo_tpu_torch).

    python3 train_torch.py --synthetic max_steps=3 data.batch_size=6

Trains `presets.internvl2_1b(lora=True)` (InternViT-300M + Qwen2-0.5B with
LoRA r=32, dropout 0.1; base LLM frozen) from seeded random weights on a
synthetic batch, on the GPU. Dotted `key=value` pairs override the
TrainConfig (core/config.py), as in train.py. Only `--synthetic` exists:
the disk data path is not ported yet.
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true",
                    help="train on a synthetic batch (required)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    args = ap.parse_args()
    if not args.synthetic:
        ap.error("only --synthetic training is ported (the disk data path is not)")

    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.train import trainer

    trainer.train(compose(args.overrides), device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
