#!/usr/bin/env python3
"""The bits of the fused CE forward of one source tree of the PyTorch port.

Runs that tree's `fused_ce_fwd` (csrc/fused_ce.cu, built into its own
build/) once on the GPU at the training shape (N = 960, H = 896,
V = 151674) on inputs made from a fixed seed, and prints one line
`CE_FWD_DIGEST <tree> {"ce": ..., "logz": ...}` with the first 12 hex
digits of the sha256 of each output. Two trees whose lines agree on one
card compute the same bits. The tree is the current directory:

    git archive <parent> | tar -x -C build/parent
    (cd build/parent && python3 ../../scripts/ce_fwd_digest.py)
    python3 scripts/ce_fwd_digest.py

`chip_smoke.py --parent DIR` runs it for both trees and compares.
"""

import hashlib
import json
import os
import sys

SEED = 10
N, H, V = 960, 896, 151674


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ce_fwd_digest: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    from simlingo_tpu_torch.kernels import fused_ce as TC
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    h = torch.randn(N, H, generator=gen, device=dev).bfloat16()
    w = (0.02 * torch.randn(V, H, generator=gen, device=dev)).bfloat16()
    labels = torch.randint(0, V, (N,), generator=gen, device=dev)
    logz, ce = TC.fused_ce_fwd(h, labels, w)
    torch.cuda.synchronize()
    digest = {k: hashlib.sha256(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
              .hexdigest()[:12] for k, x in (("ce", ce), ("logz", logz))}
    print("CE_FWD_DIGEST", os.getcwd(), json.dumps(digest), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
