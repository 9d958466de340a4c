"""Readers for the kernel gates the port honours (SIMLINGO_*).

Counterpart of `simlingo_tpu/core/gates.py`, restricted to the two gates
the port implements. They read the same environment variables, take the
same values and have the same defaults as JAX, so one setting drives both
packages (the parity tests rely on it):

  SIMLINGO_CE_IMPL  xla | pallas | pallas_dw   (default xla)
  SIMLINGO_LN_IMPL  xla | pallas               (default xla)

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
