#!/usr/bin/env python3
"""Training entry point of the PyTorch port (simlingo_tpu_torch).

    python3 train_torch.py --experiment configs/simlingo.yaml \\
        data.data_root=/path/to/database max_steps=1000
    python3 train_torch.py --synthetic max_steps=3 data.batch_size=6
    python3 train_torch.py --device cpu ...          # the plain PyTorch path

The counterpart of `train.py`: the TrainConfig (core/config.py; default
model `SimLingoConfig()`, as JAX's: InternViT-300M + Qwen2-0.5B, remat on
in both towers, no LoRA, the exact GELU, base LLM frozen) <- the
experiment YAML <- dotted `key=value` overrides. By default it trains from the CARLA dataset under
`data.data_root` (routes with measurements, rgb frames, commentary, VQA
and dreamer files) with validation, metrics in
`<output_dir>/<name>/metrics.jsonl` and checkpoints in
`<output_dir>/<name>/checkpoints` (`resume=true` continues from the
newest; `hf_checkpoint=PATH` starts from an InternVL2 / SimLingo torch
checkpoint). `--synthetic` trains on one synthetic batch instead. Runs on
the GPU unless `--device cpu`. On several GPUs, one process a GPU under
torchrun or SLURM, with `mesh.dp` / `mesh.fsdp` / `mesh.tp` / `mesh.sp` /
`mesh.pp` (ranks ordered as JAX's `make_mesh(dp, fsdp, tp, sp, pp)`, pp
innermost; dp -1 fills the processes; `data.batch_size` is per rank of dp
x fsdp). sp cuts the LLM's sequence into slabs, attention a ring over
them; the sequence (text + 30 queries) must divide sp, or the first step
raises. pp cuts the LLM's layers into GPipe stages over
`mesh.pp_microbatches` microbatches (0: one a stage), each stage's pass
recomputed in the backward; pp must divide the layers:

    torchrun --nproc-per-node 8 train_torch.py --synthetic mesh.fsdp=2 mesh.tp=2
    torchrun --nproc-per-node 8 train_torch.py --synthetic mesh.sp=2 mesh.pp=2 mesh.tp=2
"""

import argparse
import sys


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--experiment", default=None,
                    help="configs/<name>.yaml (or a path) over the defaults")
    ap.add_argument("--synthetic", action="store_true",
                    help="train on a synthetic batch (no dataset needed)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*",
                    help="dotted key=value overrides, e.g. max_steps=3 mesh.sp=2 mesh.pp=2 "
                         "mesh.pp_microbatches=4 (the mesh: dp, fsdp, tp, sp, pp)")
    args = ap.parse_args()

    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.train import trainer

    cfg = compose(args.experiment, args.overrides)
    trainer.train(cfg, make_synthetic=args.synthetic, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
