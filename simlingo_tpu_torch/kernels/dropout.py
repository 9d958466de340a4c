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

A rank of a multi-GPU step holds a block of the tensor that one process
would hold: its batch rows (dp, fsdp), for a row-parallel linear's input
its columns (tp), and under sp a slab of each sequence. `block=(row0,
col0, width)` places the local tensor, viewed as [rows, cols] with cols
its last dimension, at row row0 and column col0 of a [*, width] whole:
element i takes the index (row0 + i // cols) * width + col0 + i % cols.
`block=(row0, col0, width, seg, stride)` places its rows in segments:
local row r is row row0 + (r // seg) * stride + r % seg of the whole, so
a rank's [B, T/sp, H] slab of a [B, T, H] tensor (seg T/sp, stride T,
row0 its first row) takes the rows the one-process [B * T, H] view gives
its positions. Either way each rank draws the one-process mask
restricted to its block. With no block (or (0, 0, cols)) the index is i
and the mask keeps its bits. A pipeline microbatch is a plain row offset,
so pipelined masks are the one-process masks too. Two differences from
JAX by design: JAX folds the microbatch into its key
(`simlingo_tpu/models/qwen2.py:376-386`), so its pipelined masks differ
from its own unpipelined ones; and the port's streams never equal JAX's
(Philox here, threefry there).

On a CUDA tensor `dropout` launches `csrc/dropout.cu` (`dropout_kernel`,
or `dropout_block_kernel` for a block, segmented or not); on a CPU tensor it
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


def global_index(numel: int, cols: int, block=None, device="cpu") -> torch.Tensor:
    """[numel] int64: each local element's index in the whole tensor."""
    idx = torch.arange(numel, dtype=torch.int64, device=device)
    if block is None:
        return idx
    row0, col0, width = block[:3]
    rows = idx // cols
    if len(block) == 5:                  # segments of seg rows, stride apart
        seg, stride = block[3:]
        rows = (rows // seg) * stride + rows % seg
    return (row0 + rows) * width + col0 + idx % cols


def keep_mask(numel: int, seed: int, rate: float, device="cpu", block=None,
              cols: int = 1) -> torch.Tensor:
    """[numel] bool: which flat elements the seed keeps (of a local block of
    `cols` columns placed by `block`, module docstring)."""
    idx = global_index(numel, cols, block, device)
    ctr = idx >> 2
    zero = torch.zeros_like(ctr)
    words = philox4x32((ctr & _MASK32, ctr >> 32, zero, zero), _split_seed(seed))
    lane = idx & 3
    bits = torch.where(lane == 0, words[0], torch.where(
        lane == 1, words[1], torch.where(lane == 2, words[2], words[3])))
    return bits >= threshold(rate)


def dropout_plain(x: torch.Tensor, seed: int, rate: float, block=None) -> torch.Tensor:
    """The plain version: the same mask and arithmetic as the kernel."""
    cols = x.shape[-1] if x.dim() else 1
    keep = keep_mask(x.numel(), seed, rate, x.device, block, cols).view(x.shape)
    # inv_keep is float32-exact, so the fp32 product equals the kernel's
    return (x.float() * inv_keep(rate)).to(x.dtype).masked_fill(~keep, 0)


def _normal_block(block, cols: int):
    """None where the block is the identity placement; a segmented block
    whose segments abut (seg == stride) is a plain one."""
    if block is None:
        return None
    block = tuple(int(v) for v in block)
    if len(block) == 5 and block[3] == block[4]:
        block = block[:3]
    return None if block == (0, 0, cols) else block


def dropout(x: torch.Tensor, seed: int, rate: float, block=None) -> torch.Tensor:
    """x * mask(seed) / (1 - rate); no autograd (see `hw_dropout`).
    `block`: where x lies in the whole tensor (module docstring)."""
    block = _normal_block(block, x.shape[-1] if x.dim() else 1)
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate, block)
    return _dropout_cuda(x, seed, rate, block)


def _kernel_placement(cols: int, block):
    """The block kernel's (a, b, c, mode, seg, stride): element i's index is
    a + i (mode 0), (a + i // cols) * c + b + i % cols (mode 1: a, b, c =
    row0, col0, width), or, with local row r = i // cols, (a + (r // seg)
    * stride + r % seg) * c + b + i % cols (mode 2, segmented). Each
    thread's 8 elements must start at a multiple of 4 of the index (one
    Philox block a 4), which these checks keep."""
    row0, col0, width = block[:3]
    seg, stride = block[3:] if len(block) == 5 else (0, 0)
    if row0 < 0 or col0 < 0 or col0 + cols > width:
        raise ValueError(f"dropout block {block} does not hold {cols} columns")
    if seg and (seg < 1 or stride < seg):
        raise ValueError(f"dropout block {block}: segments of {seg} rows {stride} apart")
    if not seg and col0 == 0 and width == cols:
        if (row0 * width) % 4:
            raise ValueError(f"dropout kernel: row offset x width {row0 * width} % 4 != 0")
        return row0 * width, 0, 0, 0, 0, 0
    if cols % 8 or col0 % 4 or width % 4:
        raise ValueError(f"dropout kernel: a column block or segment needs cols % 8 == 0 "
                         f"and col0, width % 4 == 0 (cols {cols}, block {block})")
    return row0, col0, width, 2 if seg else 1, seg, stride


def _dropout_cuda(x, seed, rate, block=None):
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _lib()
    if block is None:                # the one-process layout: its own kernel
        rc = lib.simlingo_dropout(x.data_ptr(), out.data_ptr(), n, k0, k1, threshold(rate),
                                  ctypes.c_float(inv_keep(rate)), stream)
    else:
        cols = x.shape[-1]
        rc = lib.simlingo_dropout_block(
            x.data_ptr(), out.data_ptr(), n, k0, k1, threshold(rate),
            ctypes.c_float(inv_keep(rate)), cols, *_kernel_placement(cols, block), stream)
    _build.check(rc, "dropout")
    dropout.launches += 1
    return out


dropout.launches = 0


class _HWDropout(torch.autograd.Function):
    """Counterpart of JAX `hw_dropout`: the backward applies the same mask
    to the gradient, regenerated from the seed (no mask is stored)."""

    @staticmethod
    def forward(ctx, x, seed: int, rate: float, block=None):
        ctx.seed, ctx.rate, ctx.block = seed, rate, block
        return dropout(x, seed, rate, block)

    @staticmethod
    def backward(ctx, g):
        return dropout(g, ctx.seed, ctx.rate, ctx.block), None, None, None


def hw_dropout(x: torch.Tensor, seed: int, rate: float, block=None) -> torch.Tensor:
    return _HWDropout.apply(x, seed, rate, block)


def _lib():
    lib = _build.load("dropout")
    if lib.simlingo_dropout.argtypes is None:
        head = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32,
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float]
        lib.simlingo_dropout.argtypes = head + [ctypes.c_void_p]
        lib.simlingo_dropout_block.argtypes = head + [ctypes.c_longlong] * 4 + [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
        lib.simlingo_dropout.restype = lib.simlingo_dropout_block.restype = ctypes.c_int
    return lib
