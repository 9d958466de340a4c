"""Fused LayerNorm / RMSNorm, forward and backward: bf16 (or, for training
at precision=fp32, fp32) in and out, fp32 statistics.

Counterpart of `simlingo_tpu/kernels/layernorm.py`: `layernorm_fused`
(:138) and `rmsnorm_fused` (:212), custom VJPs over `_ln_fwd_kernel` (:54),
`_rms_fwd_kernel` (:71), `_ln_bwd_kernel` (:84) and `_rms_bwd_kernel`
(:110). `models/layers.py` routes through them when
SIMLINGO_LN_IMPL=pallas (`core/gates.py`).

The forward saves the per-row mean (LayerNorm) and rstd in fp32. The
backward computes, with the same identities as JAX,
    xhat = (x - mean) rstd,  dxhat = dy scale,
    dx = rstd (dxhat - mean(dxhat) - xhat mean(dxhat xhat))   (LayerNorm)
    dx = rstd (dxhat - xhat mean(dxhat xhat))                  (RMSNorm)
and dscale = sum over rows of dy xhat, dbias = sum of dy, in fp32, cast to
the scale's dtype; dx comes back in x's dtype. A parameter whose gradient
autograd does not ask for (the LLM's frozen RMSNorm scales under LoRA) is
skipped; JAX always computes it, and the trainable results are the same.

Each of the four wrappers launches its kernel in `csrc/layernorm.cu` on a
CUDA tensor (bf16 or fp32 x, dy alike, scale and bias in bf16 or fp32, d %
8 == 0, d <= 8192; anything else raises) and runs its plain version on a
CPU tensor. The
launches follow `_norm_fwd_plan` (block size, and the scale loaded early
at few rows) and `_norm_bwd_plan` (a persistent grid whose partial column
sums a second launch adds), mirrored by the .cu file's constants.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from simlingo_tpu_torch.kernels import _build

MAX_D = 8192


# ---------------------------------------------------------------------------
# plain versions (fp32 math; the kernels' arithmetic)
# ---------------------------------------------------------------------------

def layernorm_fwd_plain(x2, scale, bias, eps):
    """x2 [n, d] -> (y [n, d] in x's dtype, mean [n], rstd [n] fp32)."""
    xf = x2.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    rstd = torch.rsqrt((xc * xc).mean(dim=-1, keepdim=True) + eps)
    y = xc * rstd * scale.float() + bias.float()
    return y.to(x2.dtype), mean[:, 0], rstd[:, 0]


def rmsnorm_fwd_plain(x2, scale, eps):
    """x2 [n, d] -> (y [n, d] in x's dtype, rstd [n] fp32)."""
    xf = x2.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * rstd * scale.float()).to(x2.dtype), rstd[:, 0]


def layernorm_bwd_plain(x2, scale, mean, rstd, dy2, need_dscale=True,
                        need_dbias=True):
    """(dx in x's dtype, dscale, dbias in the scale's dtype, or None where
    not needed)."""
    xhat = (x2.float() - mean[:, None]) * rstd[:, None]
    dy = dy2.float()
    dxhat = dy * scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd[:, None] * (dxhat - m1 - xhat * m2)).to(x2.dtype)
    dscale = (dy * xhat).sum(0).to(scale.dtype) if need_dscale else None
    dbias = dy.sum(0).to(scale.dtype) if need_dbias else None
    return dx, dscale, dbias


def rmsnorm_bwd_plain(x2, scale, rstd, dy2, need_dscale=True):
    """(dx in x's dtype, dscale in the scale's dtype or None)."""
    xhat = x2.float() * rstd[:, None]
    dy = dy2.float()
    dxhat = dy * scale.float()
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (rstd[:, None] * (dxhat - xhat * m2)).to(x2.dtype)
    return dx, (dy * xhat).sum(0).to(scale.dtype) if need_dscale else None


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

DTYPES = (torch.bfloat16, torch.float32)


def _check(what, x2, scale, bias=None):
    if x2.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or fp32 x, got {x2.dtype}")
    n, d = x2.shape
    if d % 8 or d > MAX_D:
        raise ValueError(f"{what} kernel needs d % 8 == 0 and d <= {MAX_D}, got {d}")
    if scale.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes a bf16 or fp32 scale, got {scale.dtype}")
    for name, p in (("scale", scale), ("bias", bias)):
        if p is None:
            continue
        if p.shape != (d,) or p.dtype != scale.dtype or p.device != x2.device:
            raise ValueError(f"{what}: {name} must be [{d}] {scale.dtype} on "
                             f"{x2.device}, got {tuple(p.shape)} {p.dtype} {p.device}")


# The geometry of csrc/layernorm.cu that the plans assume; `_lib` refuses
# a library that reports another (simlingo_norm_geometry).
_THREADS = 256                   # the backward's block, the forward's largest
_BWD_BLOCKS_PER_SM = 2           # co-resident backward blocks an SM
_BWD_WIDE_BLOCKS_PER_SM = 1      # ... with sums at VPT 4
_FWD_BLOCKS_PER_SM = 64          # the forward's grid cap an SM (grid-stride beyond)
_FWD_MIN_THREADS = 64            # the forward's block at few rows
_FWD_FEW_ROWS_PER_SM = 8         # ... and its scale loaded early, up to this


def _geometry():
    """The tuple simlingo_norm_geometry must report."""
    return (_THREADS, _BWD_BLOCKS_PER_SM, _BWD_WIDE_BLOCKS_PER_SM, _FWD_BLOCKS_PER_SM, MAX_D)


# (vectors of 8 a row up to, VPT, WPR): csrc/layernorm.cu's dispatch tables
_WIDTHS = {torch.bfloat16: ((32, 1, 1), (64, 2, 1), (128, 4, 1), (256, 4, 2),
                            (512, 4, 4), (1024, 4, 8)),
           torch.float32: ((32, 1, 1), (64, 2, 1), (128, 2, 2), (256, 2, 4),
                           (512, 2, 8), (1024, 4, 8))}


def _norm_width(d: int, dtype=torch.bfloat16):
    """(VPT, WPR): 8-value vectors a thread and warps a row, by row width
    and the rows' dtype (csrc/layernorm.cu's dispatch: bf16 one warp a row
    up to d = 1024, then 2, 4, 8 warps; fp32 rows, whose vectors take twice
    the registers, twice the warps for 512 < d <= 4096)."""
    nv = d // 8
    for limit, vpt, wpr in _WIDTHS[dtype]:
        if nv <= limit:
            return vpt, wpr
    raise ValueError(f"norm kernels take d <= {MAX_D}, got {d}")


class NormFwdPlan(NamedTuple):
    threads: int      # a block: threads // (32 WPR) rows at a time
    blocks: int       # grid-stride over the rows beyond blocks x rows
    early: bool       # the scale loaded before the first row, not after each row's sums


class NormBwdPlan(NamedTuple):
    blocks: int       # at most the co-resident ones; partial rows of the column sums


def _norm_fwd_plan(n: int, d: int, sms: int, dtype=torch.bfloat16) -> NormFwdPlan:
    """Few rows (at most _FWD_FEW_ROWS_PER_SM an SM) are latency: the scale
    loaded early, and small blocks (one row group, at least
    _FWD_MIN_THREADS threads) that spread the rows over the SMs. Many rows
    are bytes: the scale after each row's sums, at the registers and in
    the 256-thread blocks of the design before the plan. Blocks enough for
    every row, capped at _FWD_BLOCKS_PER_SM an SM (they then walk the
    rows). The rows' dtype sets the row group (`_norm_width`)."""
    tpr = 32 * _norm_width(d, dtype)[1]
    few = n <= _FWD_FEW_ROWS_PER_SM * sms
    threads = max(_FWD_MIN_THREADS, tpr) if few else _THREADS
    return NormFwdPlan(threads, min(-(-n // (threads // tpr)), _FWD_BLOCKS_PER_SM * sms), few)


def _bwd_resident(d: int, sums: bool, dtype=torch.bfloat16) -> int:
    """Co-resident backward blocks an SM (csrc/layernorm.cu bwd_min_blocks,
    the kernel's __launch_bounds__): with sums, one at VPT 4 or fp32."""
    wide = sums and (_norm_width(d, dtype)[0] == 4 or dtype == torch.float32)
    return _BWD_WIDE_BLOCKS_PER_SM if wide else _BWD_BLOCKS_PER_SM


def _norm_bwd_plan(n: int, d: int, sms: int, sums: bool = True,
                   dtype=torch.bfloat16) -> NormBwdPlan:
    """A persistent grid: as many 256-thread blocks as the rows fill, at
    most the co-resident ones. With sums and more than one block,
    norm_colsum_kernel follows."""
    rpb = _THREADS // (32 * _norm_width(d, dtype)[1])
    return NormBwdPlan(min(-(-n // rpb), _bwd_resident(d, sums, dtype) * sms))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _fwd_cuda(what, x2, scale, bias, eps, rms, plan=None):
    _check(what, x2, scale, bias)
    x2, scale = _build.aligned16(x2), _build.aligned16(scale)
    bias = None if bias is None else _build.aligned16(bias)
    n, d = x2.shape
    y = torch.empty_like(x2)
    mean = None if rms else torch.empty(n, dtype=torch.float32, device=x2.device)
    rstd = torch.empty(n, dtype=torch.float32, device=x2.device)
    if n == 0:
        return y, mean, rstd
    plan = plan or _norm_fwd_plan(n, d, _build.sm_count(x2.device.index or 0), x2.dtype)
    rc = _lib().simlingo_norm_fwd(
        x2.data_ptr(), scale.data_ptr(), None if bias is None else bias.data_ptr(),
        y.data_ptr(), None if mean is None else mean.data_ptr(), rstd.data_ptr(),
        n, d, ctypes.c_float(float(eps)), int(rms),
        int(scale.dtype == torch.bfloat16), int(x2.dtype == torch.float32), plan.threads,
        plan.blocks, int(plan.early), _stream(x2))
    _build.check(rc, what)
    return y, mean, rstd


def _bwd_cuda(what, x2, scale, mean, rstd, dy2, need_dscale, need_dbias, rms, plan=None):
    _check(what, x2, scale)
    if dy2.dtype != x2.dtype or dy2.shape != x2.shape:
        raise ValueError(f"{what}: dy must be {x2.dtype} {tuple(x2.shape)}, got "
                         f"{dy2.dtype} {tuple(dy2.shape)}")
    x2, dy2, scale = _build.aligned16(x2), _build.aligned16(dy2), _build.aligned16(scale)
    rstd = rstd.float().contiguous()
    mean = None if rms else mean.float().contiguous()
    n, d = x2.shape
    dev = x2.device
    dx = torch.empty_like(x2)
    make = torch.zeros if n == 0 else torch.empty
    dscale = make(d, dtype=scale.dtype, device=dev) if need_dscale else None
    dbias = make(d, dtype=scale.dtype, device=dev) if need_dbias else None
    if n == 0:
        return dx, dscale, dbias
    plan = plan or _norm_bwd_plan(n, d, _build.sm_count(dev.index or 0),
                                  sums=need_dscale or need_dbias, dtype=x2.dtype)
    part_s = (torch.empty((plan.blocks, d), dtype=torch.float32, device=dev)
              if need_dscale else None)
    part_b = (torch.empty((plan.blocks, d), dtype=torch.float32, device=dev)
              if need_dbias else None)

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = _lib().simlingo_norm_bwd(
        x2.data_ptr(), dy2.data_ptr(), scale.data_ptr(), ptr(mean), rstd.data_ptr(),
        dx.data_ptr(), ptr(part_s), ptr(part_b), ptr(dscale), ptr(dbias),
        n, d, plan.blocks, int(rms),
        int(scale.dtype == torch.bfloat16), int(x2.dtype == torch.float32), _stream(x2))
    _build.check(rc, what)
    return dx, dscale, dbias


def layernorm_fwd(x2, scale, bias, eps):
    """x2 [n, d] -> (y, mean [n], rstd [n])."""
    if x2.device.type == "cpu":
        return layernorm_fwd_plain(x2, scale, bias, eps)
    out = _fwd_cuda("layernorm_fwd", x2, scale, bias, eps, rms=False)
    _build.count_launch(layernorm_fwd, x2.dtype)
    return out


def rmsnorm_fwd(x2, scale, eps):
    """x2 [n, d] -> (y, rstd [n])."""
    if x2.device.type == "cpu":
        return rmsnorm_fwd_plain(x2, scale, eps)
    y, _, rstd = _fwd_cuda("rmsnorm_fwd", x2, scale, None, eps, rms=True)
    _build.count_launch(rmsnorm_fwd, x2.dtype)
    return y, rstd


def layernorm_bwd(x2, scale, mean, rstd, dy2, need_dscale=True, need_dbias=True):
    """(dx, dscale or None, dbias or None)."""
    if x2.device.type == "cpu":
        return layernorm_bwd_plain(x2, scale, mean, rstd, dy2, need_dscale, need_dbias)
    out = _bwd_cuda("layernorm_bwd", x2, scale, mean, rstd, dy2, need_dscale,
                    need_dbias, rms=False)
    _build.count_launch(layernorm_bwd, x2.dtype)
    return out


def rmsnorm_bwd(x2, scale, rstd, dy2, need_dscale=True):
    """(dx, dscale or None)."""
    if x2.device.type == "cpu":
        return rmsnorm_bwd_plain(x2, scale, rstd, dy2, need_dscale)
    dx, dscale, _ = _bwd_cuda("rmsnorm_bwd", x2, scale, None, rstd, dy2, need_dscale,
                              False, rms=True)
    _build.count_launch(rmsnorm_bwd, x2.dtype)
    return dx, dscale


for _fn in (layernorm_fwd, rmsnorm_fwd, layernorm_bwd, rmsnorm_bwd):
    _fn.launches = 0
    _fn.launches_fp32 = 0


def _lib():
    lib = _build.load("layernorm")
    if lib.simlingo_norm_fwd.argtypes is None:
        geometry = (ctypes.c_int * 5)()
        lib.simlingo_norm_geometry(geometry)
        if tuple(geometry) != _geometry():
            raise RuntimeError(f"norm kernels: the library's geometry {tuple(geometry)} "
                               f"differs from the plans' {_geometry()}")
        lib.simlingo_norm_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_float]
            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.simlingo_norm_fwd.restype = ctypes.c_int
        lib.simlingo_norm_bwd.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.simlingo_norm_bwd.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, eps: float):
        x2 = x.reshape(-1, x.shape[-1])
        y, mean, rstd = layernorm_fwd(x2, scale, bias, eps)
        ctx.save_for_backward(x2, scale, mean, rstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale, mean, rstd = ctx.saved_tensors
        dx, dscale, dbias = layernorm_bwd(x2, scale, mean, rstd,
                                          dy.reshape(x2.shape),
                                          ctx.needs_input_grad[1],
                                          ctx.needs_input_grad[2])
        return dx.view(dy.shape), dscale, dbias, None


class _RMSNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, eps: float):
        x2 = x.reshape(-1, x.shape[-1])
        y, rstd = rmsnorm_fwd(x2, scale, eps)
        ctx.save_for_backward(x2, scale, rstd)
        return y.view(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2, scale, rstd = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x2, scale, rstd, dy.reshape(x2.shape),
                                 ctx.needs_input_grad[1])
        return dx.view(dy.shape), dscale, None


def layernorm_fused(x, scale, bias, eps: float = 1e-6):
    """LayerNorm over the last axis of x [..., d]."""
    return _LayerNorm.apply(x, scale, bias, eps)


def rmsnorm_fused(x, scale, eps: float = 1e-6):
    """RMSNorm over the last axis of x [..., d]."""
    return _RMSNorm.apply(x, scale, eps)
