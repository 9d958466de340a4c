#!/usr/bin/env python3
"""Serving frame times of one source tree of the PyTorch port, for A/B runs.

Runs the full-width serving phase of that tree's `chip_smoke.py`
(`full_width`: CoT frames, plain then speculative, one action-only frame,
decode ms/token) on the GPU and prints one line `AB <tree> {json}`.
To compare a parent commit with the working tree on one card, unpack the
parent into an ignored directory and alternate the two in one command:

    git archive <parent> | tar -x -C build/parent
    for t in parent change change parent; do
      if [ $t = parent ]; then (cd build/parent && python3 ../../scripts/torch_serve_ab.py)
      else python3 scripts/torch_serve_ab.py; fi
    done

The tree is the current directory.
"""

import json
import os
import sys


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke
    from simlingo_tpu_torch.kernels import _build
    _build.build_all()
    ok, stats, _, _ = chip_smoke.full_width(torch, torch.device("cuda"))
    keys = ("frame_ms_cot_plain", "frame_ms_cot_spec", "frame_ms_drive_only",
            "decode_ms_per_token")
    print("AB", os.getcwd(), json.dumps({k: stats[k] for k in keys}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
