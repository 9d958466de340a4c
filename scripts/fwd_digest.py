#!/usr/bin/env python3
"""The bits and device times of one forward kernel of one source tree.

Runs that tree's kernel (built from its csrc/ into its own build/) on the
GPU on the inputs and timed calls of chip_smoke.py's phase 2, taken from
the chip_smoke.py beside this script (`fwd_digests`), and prints one line
`FWD_DIGEST <kernel> <tree> {"digests": {case: {output: sha12}}, "ms":
{case: ms}, "build": the directory of the tree's built libraries}`. Two trees whose digests agree on one card compute the same
bits. KERNEL is flash_attn_fwd (every attention case), flash_attn_bwd
(every attention backward case; both at the head dims the tree builds),
fused_ce_fwd (the training shape), int8_fwd (every phase-2 int8 forward case),
norms (every phase-2 norm case, forward and backward apart) or dropout
(phase 2's zero-offset cases). The tree
is the current directory:

    git archive <parent> | tar -x -C build/parent
    (cd build/parent && python3 ../../scripts/fwd_digest.py flash_attn_fwd)
    python3 scripts/fwd_digest.py flash_attn_fwd

`chip_smoke.py --parent DIR` runs it for both trees, in turns, and compares.
"""

import importlib.util
import json
import os
import sys

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("fwd_digest: no CUDA GPU available", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", SMOKE)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    # the kernels of the tree in the current directory, not of the script's
    tree = os.getcwd()
    sys.path.insert(0, tree)
    import simlingo_tpu_torch
    if os.path.dirname(os.path.dirname(os.path.abspath(simlingo_tpu_torch.__file__))) != tree:
        print(f"fwd_digest: imported {simlingo_tpu_torch.__file__}, not {tree}'s",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    digests, ms = smoke.fwd_digests(torch, torch.device("cuda"), sys.argv[1])
    from simlingo_tpu_torch.kernels import _build
    build = str(_build.BUILD_ROOT / _build._digest())
    print("FWD_DIGEST", sys.argv[1], tree,
          json.dumps({"digests": digests, "ms": ms, "build": build}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
