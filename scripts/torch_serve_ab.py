#!/usr/bin/env python3
"""Serving frame times and outputs of one source tree of the PyTorch port, for A/B runs.

Runs the full-width serving phase of that tree's `chip_smoke.py`
(`full_width`: CoT frames, plain then speculative, one action-only frame,
decode ms/token) on the GPU, then one more speculative CoT frame, and
prints one line `AB <tree> {json}` with the times, that frame's language
tokens and its route and speed waypoints (the weights and the frame come
from seed 0, so two trees' lines compare token by token).
To compare a parent commit with the working tree on one card, unpack the
parent into an ignored directory and alternate the two in one command:

    git archive <parent> | tar -x -C build/parent
    for t in parent change change parent; do
      if [ $t = parent ]; then (cd build/parent && python3 ../../scripts/torch_serve_ab.py)
      else python3 scripts/torch_serve_ab.py; fi
    done

The tree is the current directory. With `--fp32` it runs that tree's
`serve_fp32` instead (LingoAgent(compute_dtype=torch.float32) on the int8
LLM: CoT frames, plain then speculative, decode ms/token, launches held)
and prints its statistics, with no extra frame.
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
    if sys.argv[1:] == ["--fp32"]:
        ok, stats = chip_smoke.serve_fp32(torch, torch.device("cuda"))
        print("AB", os.getcwd(), json.dumps(stats), flush=True)
        return 0 if ok else 1
    ok, stats, agent, frame = chip_smoke.full_width(torch, torch.device("cuda"))
    keys = ("frame_ms_cot_plain", "frame_ms_cot_spec", "frame_ms_drive_only",
            "decode_ms_per_token")
    out = {k: stats[k] for k in keys}
    r = agent.run_step(frame)
    out.update(tokens=[int(t) for t in r.get("language_tokens", [])],
               route=r["route"].tolist(), speed_wps=r["speed_wps"].tolist())
    print("AB", os.getcwd(), json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
