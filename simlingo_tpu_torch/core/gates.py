"""Readers for the kernel gates the port honours (SIMLINGO_*).

Counterpart of `simlingo_tpu/core/gates.py`, which reads five gates:
SIMLINGO_ATTN_IMPL, SIMLINGO_CE_IMPL, SIMLINGO_DROPOUT_V2,
SIMLINGO_LN_IMPL and SIMLINGO_LORA_FUSED. The port reads two of them, the
two that choose between a hand kernel and the eager path. They read the
same environment variables, take the same values and have the same
defaults as JAX, so one setting drives both packages (the parity tests
rely on it):

  SIMLINGO_CE_IMPL  xla | pallas | pallas_dw   (default xla)
  SIMLINGO_LN_IMPL  xla | pallas               (default xla)

The other three mean nothing in the port, and `resolved()` does not
report them: attention always runs the port's kernel on a CUDA tensor
(SIMLINGO_ATTN_IMPL picks among JAX's backends), dropout is the port's
one Philox kernel (SIMLINGO_DROPOUT_V2 picks among JAX's two), and the
LoRA products are never fused with the base linear (SIMLINGO_LORA_FUSED,
off in JAX, changes its group dropout masks). Nor does the port read
JAX's SIMLINGO_SP_ATTN (`simlingo_tpu/kernels/flash_attention.py:1336-1340`),
whose "0" computes attention on a replicated sequence under sequence
parallelism: the port's sp always runs the ring (`parallel/sequence.py`).
A printed gate state of the port is not JAX's.

In the port, `pallas` means the hand-written CUDA kernel on a CUDA tensor
and its plain PyTorch version on a CPU tensor (`kernels/fused_ce.py`,
`kernels/layernorm.py`); `pallas_dw` is `pallas` with the tied head's dW
computed. `xla` means the eager PyTorch path of `models/`.

JAX reads its gates when a step is traced. Eager PyTorch has no trace:
the port reads them each time the gated function runs, so a change of the
environment applies to the next call. The one exception is
`train_step.make_train_step`, which checks its refusal rule when it
builds the step, as JAX does.
"""

import os

_DEFAULTS = {
    "SIMLINGO_CE_IMPL": "xla",
    "SIMLINGO_LN_IMPL": "xla",
}


def _get(name: str) -> str:
    return os.environ.get(name, _DEFAULTS[name])


def ce_impl() -> str:
    return _get("SIMLINGO_CE_IMPL")


def ln_impl() -> str:
    return _get("SIMLINGO_LN_IMPL")


def resolved() -> dict:
    """The gate state as the next call would see it."""
    return {name.replace("SIMLINGO_", "").lower(): _get(name)
            for name in _DEFAULTS}
