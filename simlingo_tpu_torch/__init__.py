"""simlingo_tpu_torch: the PyTorch + CUDA port of simlingo_tpu.

Each module mirrors its counterpart under `simlingo_tpu/` (same relative
path) and is held against it by the `tests/test_torch_*.py` parity tests.
The package imports torch and numpy only -- never jax, flax or
`simlingo_tpu` -- so it runs on a machine that has neither.

The kernels that the JAX package wrote in Pallas for the TPU are CUDA C++
kernels here (`csrc/`), built at first use with nvcc for sm_90a and bound
through ctypes (`kernels/_build.py`). Each wrapper launches its kernel for a
CUDA tensor and runs its plain PyTorch version for a CPU tensor.
"""
