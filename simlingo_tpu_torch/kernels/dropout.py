"""Inverted dropout with a counter-based generator: x * Bernoulli(1-p) / (1-p).

Counterpart of `simlingo_tpu/kernels/dropout.py` (`_kernel` :32, reached via
`_apply` :48 and `hw_dropout` :126), the LoRA-input dropout of training.
The TPU kernel draws the TPU's own hardware bits; here the mask is a pure
function of (seed, flat element index) through Philox4x32-10:

    key     = (seed & 0xffffffff, seed >> 32)      seed: an int in [0, 2^64)
    counter = (i // 4 low word, i // 4 high word, 0, 0)
    u32     = Philox4x32-10(counter, key)[i % 4]
    keep    = u32 >= round(rate * 2^32)

and a kept element becomes bf16(float(x) * float32(1 / (1 - rate))). The
stream differs from the TPU's and from JAX's CPU path (threefry); what
carries over is the contract: the keep rate, the scaling, one mask per
seed, and a backward that regenerates the forward's mask from the seed.

On a CUDA tensor `dropout` launches `csrc/dropout.cu`; on a CPU tensor it
runs `dropout_plain`, which computes the same Philox in int64 torch
arithmetic, so kernel and plain version give bit-identical results.
"""

from __future__ import annotations

import ctypes

import torch

from simlingo_tpu_torch.kernels import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Philox4x32 multipliers
_W0, _W1 = 0x9E3779B9, 0xBB67AE85          # Weyl key increments
_MASK32 = 0xFFFFFFFF


def _split_seed(seed: int):
    seed = int(seed) & ((1 << 64) - 1)
    return seed & _MASK32, seed >> 32


def threshold(rate: float) -> int:
    """Drop iff u32 < threshold: P(drop) = threshold / 2^32."""
    return min(int(round(rate * 2.0 ** 32)), _MASK32)


def inv_keep(rate: float) -> float:
    """1 / (1 - rate), rounded to float32 as the kernel multiplies by it."""
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a * m for u32 values held in int64. The
    product does not fit int64, so m is split into 16-bit halves: each
    partial product stays below 2^48."""
    t = a * (m & 0xFFFF)
    u = a * (m >> 16)
    lo = (((u & 0xFFFF) << 16) + t) & _MASK32
    hi = (u + (t >> 16)) >> 16
    return hi, lo


def philox4x32(counter, key):
    """Philox4x32-10 (Salmon et al., SC'11; Random123) on int64 tensors of
    u32 words: counter = (c0, c1, c2, c3), key = (k0, k1) ints. Returns the
    four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK32, (k1 + _W1) & _MASK32
    return c0, c1, c2, c3


def keep_mask(numel: int, seed: int, rate: float, device="cpu") -> torch.Tensor:
    """[numel] bool: which flat elements the seed keeps."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    ctr = idx >> 2
    zero = torch.zeros_like(ctr)
    words = philox4x32((ctr & _MASK32, ctr >> 32, zero, zero), _split_seed(seed))
    lane = idx & 3
    bits = torch.where(lane == 0, words[0], torch.where(
        lane == 1, words[1], torch.where(lane == 2, words[2], words[3])))
    return bits >= threshold(rate)


def dropout_plain(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """The plain version: the same mask and arithmetic as the kernel."""
    keep = keep_mask(x.numel(), seed, rate, x.device).view(x.shape)
    # inv_keep is float32-exact, so the fp32 product equals the kernel's
    return (x.float() * inv_keep(rate)).to(x.dtype).masked_fill(~keep, 0)


def dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    """x * mask(seed) / (1 - rate); no autograd (see `hw_dropout`)."""
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate)
    return _dropout_cuda(x, seed, rate)


def _dropout_cuda(x, seed, rate):
    if x.dtype != torch.bfloat16:
        raise TypeError(f"dropout kernel takes bf16, got {x.dtype}")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    x = _build.aligned16(x)                # the kernel reads 16 bytes a thread
    out = torch.empty_like(x)
    n = x.numel()
    if n == 0:
        return out
    k0, k1 = _split_seed(seed)
    rc = _lib().simlingo_dropout(
        x.data_ptr(), out.data_ptr(), n, k0, k1, threshold(rate),
        ctypes.c_float(inv_keep(rate)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "dropout")
    dropout.launches += 1
    return out


dropout.launches = 0


class _HWDropout(torch.autograd.Function):
    """Counterpart of JAX `hw_dropout`: the backward applies the same mask
    to the gradient, regenerated from the seed (no mask is stored)."""

    @staticmethod
    def forward(ctx, x, seed: int, rate: float):
        ctx.seed, ctx.rate = seed, rate
        return dropout(x, seed, rate)

    @staticmethod
    def backward(ctx, g):
        return dropout(g, ctx.seed, ctx.rate), None, None


def hw_dropout(x: torch.Tensor, seed: int, rate: float) -> torch.Tensor:
    return _HWDropout.apply(x, seed, rate)


def _lib():
    lib = _build.load("dropout")
    fn = lib.simlingo_dropout
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
                       ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
