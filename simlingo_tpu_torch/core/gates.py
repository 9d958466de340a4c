"""Readers for the kernel gates the port honours (SIMLINGO_*).

Counterpart of `simlingo_tpu/core/gates.py`, which reads five gates:
SIMLINGO_ATTN_IMPL, SIMLINGO_CE_IMPL, SIMLINGO_DROPOUT_V2,
SIMLINGO_LN_IMPL and SIMLINGO_LORA_FUSED. The port reads three of them.
They read the same environment variables, take the same values and have
the same defaults as JAX, so one setting drives both packages (the
parity tests rely on it):

  SIMLINGO_CE_IMPL     xla | pallas | pallas_dw   (default xla)
  SIMLINGO_LN_IMPL     xla | pallas               (default xla)
  SIMLINGO_LORA_FUSED  0 | 1                      (default 0)

The first two choose between a hand kernel and the eager path. In the
port, `pallas` means the hand-written CUDA kernel on a CUDA tensor and
its plain PyTorch version on a CPU tensor (`kernels/fused_ce.py`,
`kernels/layernorm.py`); `pallas_dw` is `pallas` with the tied head's dW
computed. `xla` means the eager PyTorch path of `models/`.

SIMLINGO_LORA_FUSED=1 groups the LoRA adapters of Qwen2 that read one
input, q / k / v and gate / up (`models/qwen2.py`, `_LoraGroupDelta`):
the group's input goes through one dropout launch with the group's first
seed, so the adapters of a group share one mask, where the gate off
draws a mask an adapter. Forward and gradients without dropout are the
unfused ones; with dropout the masks differ, as in JAX. It fuses
adapters with each other, never an adapter with its base linear.

The other two mean nothing in the port, and `resolved()` does not report
them: attention always runs the port's kernel on a CUDA tensor
(SIMLINGO_ATTN_IMPL picks among JAX's backends), and dropout is the
port's one Philox kernel (SIMLINGO_DROPOUT_V2 picks among JAX's two).
Nor does the port read JAX's SIMLINGO_SP_ATTN
(`simlingo_tpu/kernels/flash_attention.py:1336-1340`), whose "0"
computes attention on a replicated sequence under sequence parallelism:
the port's sp always runs the ring (`parallel/sequence.py`). A printed
gate state of the port is not JAX's.

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
    "SIMLINGO_LORA_FUSED": "0",
}


def _get(name: str) -> str:
    return os.environ.get(name, _DEFAULTS[name])


def ce_impl() -> str:
    return _get("SIMLINGO_CE_IMPL")


def ln_impl() -> str:
    return _get("SIMLINGO_LN_IMPL")


def lora_fused() -> bool:
    return _get("SIMLINGO_LORA_FUSED") == "1"


def resolved() -> dict:
    """The gate state as the next call would see it."""
    return {name.replace("SIMLINGO_", "").lower(): _get(name)
            for name in _DEFAULTS}
