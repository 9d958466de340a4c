"""w8a16 (int8-weight, bf16-activation) matmul, differentiable in x; and
the w4a16 product of the int4 serving path (plain PyTorch, at the end).

Counterpart of `simlingo_tpu/kernels/quantized_matmul.py`: the forward
`_kernel` (:49, reached via `_int8_matmul_impl` :302) and the activation
VJP `_int8_matmul_bwd` (:81) of the `int8_matmul` custom_vjp (:58-101).
The port keeps ONE weight layout for every int8 product: torch's [N, K]
(out, in) row-major, so the linears and the tied [V, H] LM head (the JAX
`transpose_rhs=True` case) take the same kernels. Quantization is
symmetric per output channel:

    w_q[n, k] = round(w[n, k] / scale[n]),  scale[n] = max_k |w[n, k]| / 127

    y  = int8_matmul(x, w_q, scale):  y[m, n] = sum_k x[m, k] w_q[n, k] scale[n]
    dx = int8_matmul_dx(g, w_q, scale): dx[m, k] = sum_n bf16(g[m, n] scale[n]) w_q[n, k]

w_q and scale are frozen base weights: they get no gradient (JAX returns
float0 and zeros, :96-97). The autograd Function saves only w_q and
scale, never a dequantized copy, so no bf16 copy of a frozen layer lives
from forward to backward (JAX's optimisation-barrier comment, :88-93).
On a CUDA tensor both products launch the hand-written kernels
(`csrc/int8_matmul.cu`): the bf16 build for bf16 x or g, the fp32 build
(counted also in `launches_fp32`) for fp32 x or g, with the output in the
activation's dtype; any other dtype raises. Both fp32 products at M >= 2
run on the tensor cores with split operands (`csrc/f32_tc_tile.cuh`: x,
or g * scale rounded once in fp32, as big + small in TF32, the int8 codes
exact in TF32, two products a step), which keeps fp32 accuracy; the M = 1
GEMV uses fp32 FMA. On a CPU tensor they run their plain versions, which
compute in fp32, or in fp64 for fp64 inputs (the card's references for
the fp32 build). The scale may be fp32 or bf16 (the training step stores frozen
leaves in bf16, as JAX does); the kernels multiply by it widened to fp32,
the value JAX multiplies by. The forward kernel reads a bf16 scale itself;
the activation gradient's wrapper widens it first. A K that is not a
multiple of 16 (and, for the gradient, an odd N) is zero-padded in the
wrapper (`_pad_operands`); no path shape takes a copy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.kernels import _build


def quantize_weight(w: torch.Tensor, axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [N, K] -> (w_q int8 [N, K], scale f32 [N]) (axis=0: per row).

    axis=1 keeps one scale per column instead. Bit-identical to the JAX
    quantize_weight: fp32 division, round half to even, clip to +-127."""
    w = w.float()
    amax = w.abs().amax(dim=1 - axis)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    sc = scale[:, None] if axis == 0 else scale[None, :]
    w_q = torch.clamp(torch.round(w / sc), -127, 127).to(torch.int8)
    return w_q, scale


def int8_matmul_reference(x: torch.Tensor, w_q: torch.Tensor,
                          scale: torch.Tensor, abs_terms: bool = False
                          ) -> torch.Tensor:
    """Plain version: fp32 product of x and the int8 codes (fp64 for fp64
    x), scaled per output channel, cast back to x's dtype. With
    `abs_terms`, returns instead the sums of |term| (|x| |w_q| |scale|),
    which bound the error of summing in another order (at fp32,
    fp32_unit(K) times them)."""
    xw = _build.wide(x)
    if abs_terms:
        return (xw.abs() @ w_q.to(xw.dtype).abs().t()) * scale.to(xw.dtype).abs()
    acc = xw @ w_q.to(xw.dtype).t()
    return (acc * scale.to(xw.dtype)).to(x.dtype)


def int8_matmul_dx_reference(g: torch.Tensor, w_q: torch.Tensor,
                             scale: torch.Tensor, abs_terms: bool = False
                             ) -> torch.Tensor:
    """Plain version of the activation gradient: g * scale rounded to g's
    dtype (the kernel's and JAX's rounding point, :86), then an fp32
    product with the int8 codes (fp64 for fp64 g), cast to g's dtype. With
    `abs_terms`, returns instead the sums of |term| (|g * scale| |w_q|),
    which bound the error of summing in another order (at fp32,
    fp32_unit(N) times them)."""
    gw = _build.wide(g)
    gs = _build.wide((gw * scale.to(gw.dtype)).to(g.dtype))
    if abs_terms:
        return gs.abs() @ w_q.to(gs.dtype).abs()
    return (gs @ w_q.to(gs.dtype)).to(g.dtype)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] * w_q[n, k] * scale[n].

    x [..., K] (bf16 or fp32 on the GPU), w_q int8 [N, K], scale f32 or
    bf16 [N]; y in x's dtype.
    Records an autograd node only when x needs a gradient (training);
    serving calls the forward kernel directly."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Int8Matmul.apply(x, w_q, scale)
    return _int8_matmul_fwd(x, w_q, scale)


def int8_matmul_dx(g: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """dx[..., k] = sum_n rnd(g[..., n] * scale[n]) * w_q[n, k], rnd the
    rounding to g's dtype.

    g [..., N] (bf16 or fp32 on the GPU), w_q int8 [N, K], scale f32 or
    bf16 [N]; dx in g's dtype."""
    if g.device.type == "cpu":
        return int8_matmul_dx_reference(g, w_q, scale)
    return _int8_matmul_dx_cuda(g, w_q, scale)


class _Int8Matmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(w_q, scale)
        return _int8_matmul_fwd(x, w_q, scale)

    @staticmethod
    def backward(ctx, g):
        w_q, scale = ctx.saved_tensors
        dx = int8_matmul_dx(g, w_q, scale) if ctx.needs_input_grad[0] else None
        return dx, None, None


def _int8_matmul_fwd(x, w_q, scale):
    if x.device.type == "cpu":
        return int8_matmul_reference(x, w_q, scale)
    return _int8_matmul_cuda(x, w_q, scale)


DTYPES = (torch.bfloat16, torch.float32)   # the kernels' builds (activations)


def _check(what, a, w_q, scale, width):
    """Checks shared by both kernels. `a` is the activation (x) or the
    cotangent (g), `width` its last dim."""
    N = w_q.shape[0]
    if a.dtype not in DTYPES:
        raise TypeError(f"{what} kernel takes bf16 or fp32 activations, got {a.dtype}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or not w_q.is_contiguous():
        raise TypeError(f"{what} kernel takes a contiguous int8 [N, K] weight")
    if scale.dtype not in (torch.float32, torch.bfloat16) or scale.shape != (N,):
        raise TypeError(f"{what} kernel takes a float32 or bfloat16 [N] scale")
    if not (a.device == w_q.device == scale.device):
        raise ValueError(f"{what}: tensors on different devices")
    if a.shape[-1] != width:
        raise ValueError(f"{what} kernel needs a [..., {width}] operand; got "
                         f"{tuple(a.shape)}, w_q {tuple(w_q.shape)}")
    if w_q.data_ptr() % 16:
        raise ValueError(f"{what} kernel needs a 16-byte aligned weight")


# The forward kernels' geometry; `_lib` refuses a library that reports
# another (simlingo_int8_matmul_geometry). Per variant: output tile (rows,
# columns), reduction step (K columns), blocks an SM that a split fills --
# gemm_kernel's resident blocks; 2 of gemm64_kernel's 3, past which more
# segments measured slower (PERF.md).
_FWD_SMALL = ((16, 64), 64, 8)       # gemm_kernel, 2 <= M <= _FWD_SMALL_M
_FWD_LARGE = ((64, 128), 32, 2)      # gemm64_kernel, M > _FWD_SMALL_M
_FWD_CLUSTER = 8                     # most blocks in a cluster (portable)
_FWD_SMALL_M = 48
# The GEMV (M = 1): most warps a block, the rows a warp its instantiations
# take, K columns a 16-byte load of codes (the library reports the first,
# the largest of the second and the third); then the plan's warps an SM:
# the row groups should give at least so many before rows a warp are cut,
# and one wave of blocks, which walk the row groups, holds at most so many
# (`chip_smoke.py --int8-sweep` measured both, PERF.md).
_GEMV_WARPS = 16
_GEMV_ROWS = (2, 4, 8)
_GEMV_CHUNK = 16
_GEMV_SM_WARPS = 32


def _fwd_geometry(M: int):
    """(tile, step, blocks an SM a split fills) of the variant that takes M."""
    return _FWD_SMALL if M <= _FWD_SMALL_M else _FWD_LARGE


def _fwd_plan(M: int, N: int, K: int, sms: int):
    """Grid of gemm_kernel (M >= 2; M = 1 takes the GEMV): (tile, S
    segments, seg K columns).

    The reduction (K) splits into S segments of `seg` columns, each a whole
    number of steps (the last one ragged), and the S blocks of an output
    tile form one cluster that sums their partials in shared memory. S = 1
    where the output tiles alone give 2 * sms blocks or more; below that, S
    is the largest count, at most _FWD_CLUSTER, whose blocks the SMs take
    at once (the variant's blocks an SM), so that no block waits."""
    tile, step, fill = _fwd_geometry(M)
    tiles = -(-M // tile[0]) * -(-N // tile[1])
    steps = max(1, -(-K // step))
    S = 1 if tiles >= 2 * sms else max(1, min(steps, _FWD_CLUSTER, fill * sms // tiles))
    per = -(-steps // S)
    return tile, -(-steps // per), per * step


class GemvPlan(NamedTuple):
    """gemv_kernel's grid: `rows` a warp, `warps` K slices a block, `blocks`
    row-group blocks, which walk the row groups grid-stride."""
    rows: int
    warps: int
    blocks: int


@functools.lru_cache(maxsize=256)
def _gemv_plan(N: int, K: int, sms: int) -> GemvPlan:
    """Grid of gemv_kernel (M = 1).

    K is cut into `warps` slices of whole 16-column chunks, as few as give
    each lane at most one chunk a row (warps >= C / 32 of the C = K / 16
    chunks: 2 at K = 896, 10 at 4864), at most _GEMV_WARPS (past K = 8192
    the lanes loop over their chunks). The rows a warp are the most whose
    row groups still give _GEMV_SM_WARPS warps an SM, and at least 2 (each
    lane holds `rows` 16-byte loads in flight; 2 at every linear, 8 at the
    tied head). The blocks walk the row groups in as few rounds as one wave
    of _GEMV_SM_WARPS warps an SM allows, the groups spread evenly over
    them (gate,up and down 2 rounds, the tied head 9)."""
    warps = min(_GEMV_WARPS, -(-max(1, K // _GEMV_CHUNK) // 32))
    rows = next((r for r in reversed(_GEMV_ROWS)
                 if -(-N // r) * warps >= _GEMV_SM_WARPS * sms), _GEMV_ROWS[0])
    groups = -(-N // rows)
    rounds = -(-groups // max(1, _GEMV_SM_WARPS // warps * sms))
    return GemvPlan(rows, warps, -(-groups // rounds))


# The fp32 products' geometry (simlingo_int8_split_geometry): output tile
# (rows, columns), reduction step, most segments of a split, blocks an SM,
# stages of its cp.async ring.
_SPLIT_TILE = (128, 128)
_SPLIT_STEP = 32
_SPLIT_MAX = 16
_SPLIT_RESIDENT = 1
_SPLIT_STAGES = 4


@functools.lru_cache(maxsize=256)
def _split_plan(M: int, N: int, K: int, sms: int):
    """Grid of gemm_split_kernel (fp32 x, M >= 2) and of dx_split_kernel
    (fp32 g, called with its own (M, K, N): dx [M, K] over N): (S
    segments, seg reduction columns). S = 1 where the 128 x 128 tiles
    alone give two waves of _SPLIT_RESIDENT blocks an SM or more (the
    training rows' linears but k,v; the tied head's forward). Below that,
    the reduction is cut into at most _SPLIT_MAX segments of whole
    32-column steps, the count with the shortest critical path: its waves
    times a block's steps, each block also waiting _SPLIT_STAGES - 1 steps
    for its ring to fill; the fewest among equals (training k,v: 38 tiles,
    S = 3 of 10 steps in one wave; serving's gate,up at M = 640: S = 2;
    the head's dx: 14 tiles, S = 9 of 527 steps in one wave). Each block
    then writes an fp32 partial that f32_reduce_kernel sums in order (the
    forward's times the scale)."""
    tiles = -(-M // _SPLIT_TILE[0]) * -(-N // _SPLIT_TILE[1])
    steps = max(1, -(-K // _SPLIT_STEP))
    slots = _SPLIT_RESIDENT * sms

    def path(s):                        # s segments of whole steps: (waves x steps, s)
        per = -(-steps // s)
        return -(-tiles * s // slots) * (per + _SPLIT_STAGES - 1), s
    S = 1
    if tiles < 2 * slots:
        whole = {-(-steps // -(-steps // s)) for s in range(1, min(steps, _SPLIT_MAX) + 1)}
        S = min(whole, key=path)
    per = -(-steps // S)
    return -(-steps // per), per * _SPLIT_STEP


def _pad_operands(a, w_q, scale, grad, even_n=False):
    """a, w_q [N, K] and scale [N] with K zero-padded to a multiple of 16:
    in the forward (a = x [M, K]) a's columns too; in the gradient (`grad`:
    a = g [M, N]) only w_q's, whose padded dx columns the caller cuts off,
    and with `even_n` N to an even count (a's columns, w_q's rows, scale's
    entries). Zeros add nothing to any sum; only a shape that needs it
    takes a copy."""
    pk = -w_q.shape[1] % 16
    pn = w_q.shape[0] % 2 if even_n else 0
    if pk or pn:
        w_q = F.pad(w_q, (0, pk, 0, pn))
    if grad and pn:
        a, scale = F.pad(a, (0, pn)), F.pad(scale, (0, pn))
    elif not grad and pk:
        a = F.pad(a, (0, pk))
    return a, w_q, scale


def _int8_matmul_cuda(x, w_q, scale):
    N, K = w_q.shape
    _check("int8_matmul", x, w_q, scale, K)
    lead = x.shape[:-1]
    fp32 = x.dtype == torch.float32
    x2, w_q, scale = _pad_operands(x.reshape(-1, K), w_q, scale.contiguous(), grad=False)
    x2 = x2.contiguous()
    Kp = w_q.shape[1]
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return out.reshape(*lead, N)
    if x2.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs 16-byte aligned operands")
    sms = _build.sm_count(x.device.index or 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    bf16_scale = int(scale.dtype == torch.bfloat16)
    if M == 1:
        rc = _lib().simlingo_int8_gemv(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            N, Kp, bf16_scale, int(fp32), *_gemv_plan(N, Kp, sms), stream)
    elif fp32:
        S, seg = _split_plan(M, N, Kp, sms)
        part = torch.empty((S, M, N), dtype=torch.float32, device=x.device) if S > 1 else None
        rc = _lib().simlingo_int8_matmul_f32(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
            None if part is None else part.data_ptr(), out.data_ptr(),
            M, N, Kp, bf16_scale, S, seg, stream)
    else:
        _, S, seg = _fwd_plan(M, N, Kp, sms)
        rc = _lib().simlingo_int8_matmul(
            x2.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
            M, N, Kp, bf16_scale, S, seg // _fwd_geometry(M)[1], stream)
    _build.check(rc, "int8_matmul")
    _build.count_launch(int8_matmul, x.dtype)
    return out.reshape(*lead, N)


# dx_kernel's geometry; `_lib` refuses a library that reports another
# (simlingo_int8_matmul_dx_geometry), so the plan and the kernel agree.
_DX_TILE = (64, 128)    # output tile (rows, columns)
_DX_STEP = 32           # reduction step: weight rows per stage
_DX_RESIDENT = 3        # blocks an SM holds at once


def _dx_plan(M: int, N: int, K: int, sms: int):
    """Grid of dx_kernel: (tile, S segments, seg rows).

    The reduction (N) splits into S segments of `seg` rows, each a whole
    number of steps (the last one ragged). S = 1 where the output tiles
    alone give 2 * sms blocks or more (every linear of the training path);
    below that, S is the largest count whose blocks fit in one wave of
    resident blocks, tiles * S <= _DX_RESIDENT * sms (the tied head: 21
    tiles, S = 18, 378 blocks), so that no block waits for a second wave."""
    bm, bn = _DX_TILE
    tiles = -(-M // bm) * -(-K // bn)
    steps = max(1, -(-N // _DX_STEP))
    S = 1 if tiles >= 2 * sms else max(1, min(steps, _DX_RESIDENT * sms // tiles))
    per = -(-steps // S)
    return _DX_TILE, -(-steps // per), per * _DX_STEP


def _int8_matmul_dx_cuda(g, w_q, scale):
    N, K = w_q.shape
    _check("int8_matmul_dx", g, w_q, scale, N)
    lead = g.shape[:-1]
    fp32 = g.dtype == torch.float32
    # the bf16 kernel copies g rows 4 bytes at a time: N even
    g2, w_q, scale = _pad_operands(g.reshape(-1, N), w_q, _build.aligned16(scale.float()),
                                   grad=True, even_n=not fp32)
    g2 = g2.contiguous()
    if g2.data_ptr() % 4:
        g2 = g2.clone()
    Np, Kp = w_q.shape
    M = g2.shape[0]
    out = torch.empty((M, Kp), dtype=g.dtype, device=g.device)
    if M > 0:
        sms = _build.sm_count(g.device.index or 0)
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if fp32:
            S, seg = _split_plan(M, Kp, Np, sms)
            part = (torch.empty((S, M, Kp), dtype=torch.float32, device=g.device)
                    if S > 1 else None)
            rc = _lib().simlingo_int8_matmul_dx_f32(
                g2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                None if part is None else part.data_ptr(), out.data_ptr(),
                M, Np, Kp, Np, _dx_copy_bytes(Np, g2.data_ptr()), S, seg, stream)
        else:
            _, S, seg = _dx_plan(M, Np, Kp, sms)
            part = (torch.empty((S, M, Kp), dtype=torch.float32, device=g.device)
                    if S > 1 else None)
            # 16-byte copies of g rows where every row start is 16-byte
            # aligned; the vocabulary width (151674) takes the 4-byte copies,
            # measured faster than one zero-padded copy of g and 16-byte
            # copies (PERF.md)
            vec16 = int(Np % 8 == 0 and g2.data_ptr() % 16 == 0)
            rc = _lib().simlingo_int8_matmul_dx(
                g2.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                None if part is None else part.data_ptr(), out.data_ptr(),
                M, Np, Kp, vec16, S, seg // _DX_STEP, stream)
        _build.check(rc, "int8_matmul_dx")
        _build.count_launch(int8_matmul_dx, g.dtype)
    return (out if Kp == K else out[:, :K].contiguous()).reshape(*lead, K)


def _dx_copy_bytes(ld: int, ptr: int) -> int:
    """Bytes a copy of fp32 g's rows (ld floats apart, from address ptr) in
    dx_split_kernel: 16 where every row starts 16-byte aligned, else 8 (the
    vocabulary's 151674) or 4 (an odd N); `chip_smoke.py --int8-sweep`
    times them against one zero-padded copy of g with 16-byte copies."""
    return next(v for v in (16, 8, 4) if ld % (v // 4) == 0 and ptr % v == 0)


int8_matmul.launches = 0
int8_matmul.launches_fp32 = 0            # of them, the fp32 build's
int8_matmul_dx.launches = 0
int8_matmul_dx.launches_fp32 = 0


def _fwd_lib_geometry():
    """The tuple simlingo_int8_matmul_geometry must report for the plans."""
    return (*_FWD_SMALL[0], *_FWD_SMALL[1:], *_FWD_LARGE[0], *_FWD_LARGE[1:],
            _FWD_CLUSTER, _FWD_SMALL_M, _GEMV_WARPS, max(_GEMV_ROWS), _GEMV_CHUNK)


def _lib():
    lib = _build.load("int8_matmul")
    if lib.simlingo_int8_matmul.argtypes is None:
        geometry = (ctypes.c_int * 13)()
        lib.simlingo_int8_matmul_geometry(geometry)
        want = _fwd_lib_geometry()
        if tuple(geometry) != want:
            raise RuntimeError(
                f"int8_matmul: the library's geometry {tuple(geometry)} differs "
                f"from the plan's {want}")
        geometry = (ctypes.c_int * 4)()
        lib.simlingo_int8_matmul_dx_geometry(geometry)
        if tuple(geometry) != (*_DX_TILE, _DX_STEP, _DX_RESIDENT):
            raise RuntimeError(
                f"int8_matmul_dx: the library's tile, step and resident blocks "
                f"{tuple(geometry)} differ from the plan's "
                f"{(*_DX_TILE, _DX_STEP, _DX_RESIDENT)}")
        geometry = (ctypes.c_int * 6)()
        lib.simlingo_int8_split_geometry(geometry)
        want = (*_SPLIT_TILE, _SPLIT_STEP, _SPLIT_MAX, _SPLIT_RESIDENT, _SPLIT_STAGES)
        if tuple(geometry) != want:
            raise RuntimeError(
                f"int8_matmul: the library's split tile, step, most segments, blocks "
                f"an SM and stages {tuple(geometry)} differ from the plan's {want}")
        lib.simlingo_int8_matmul.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.simlingo_int8_matmul.restype = ctypes.c_int
        lib.simlingo_int8_matmul_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.simlingo_int8_matmul_f32.restype = ctypes.c_int
        lib.simlingo_int8_matmul_dx_f32.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_longlong]
            + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        lib.simlingo_int8_matmul_dx_f32.restype = ctypes.c_int
        lib.simlingo_int8_gemv.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        lib.simlingo_int8_gemv.restype = ctypes.c_int
        lib.simlingo_int8_matmul_dx.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.simlingo_int8_matmul_dx.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# w4a16: int4 codes with group-wise scales (serving), plain PyTorch
# ---------------------------------------------------------------------------
#
# Counterpart of `simlingo_tpu/kernels/quantized_matmul.py:104-296`, which
# computes int4 in XLA (grouped dots), not in a Pallas kernel; so does the
# port, with no hand kernel. One layout, as for int8: the codes of w [N, K]
# are nibble-packed along K into int8 [N, K // 2] (even k in the low
# nibble) with one fp32 scale a (row, group of `group` columns), [N, G].
# That is JAX's `transpose_rhs` layout; a JAX linear's [K // 2, N] codes
# and [G, N] scales are its transpose (`core/from_jax.py`), byte for byte.

INT4_GROUP = 128
INT4_GROUPED_MAX_M = 64     # above: one dense product over a dequantized copy


def _every_other(t: torch.Tensor, dim: int, start: int) -> torch.Tensor:
    index = [slice(None)] * t.dim()
    index[dim] = slice(start, None, 2)
    return t[tuple(index)]


def pack_int4(w_int: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """int4 codes (any integer dtype, values in [-8, 7]) -> packed int8 with
    half the extent along `dim`: even index -> low nibble, odd -> high."""
    w = w_int.to(torch.int8)
    dim = dim % w.dim()
    if w.shape[dim] % 2:
        raise ValueError("pack_int4: the packed dim's extent must be even")
    lo, hi = _every_other(w, dim, 0), _every_other(w, dim, 1)
    return ((hi << 4) | (lo & 0xF)).to(torch.int8)


def unpack_int4(p: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Packed int8 -> int8 codes interleaved along `dim` (inverse of
    pack_int4); the arithmetic right shifts sign-extend."""
    dim = dim % p.dim()
    lo = (p << 4) >> 4
    hi = p >> 4
    st = torch.stack([lo, hi], dim=dim + 1)
    return st.reshape(*p.shape[:dim], p.shape[dim] * 2, *p.shape[dim + 1:])


def quantize_weight4(w: torch.Tensor, group: int = INT4_GROUP
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """w [N, K] -> (w_q packed int8 [N, K // 2], scale f32 [N, K // group]).

    Symmetric round to nearest (half to even) onto [-7, 7] a (row, group),
    scale = max(amax, 1e-8) / 7 in fp32: JAX's quantize_weight4 bit for bit
    (its axis=1 result transposed, its axis=0 result as it is)."""
    N, K = w.shape
    if K % group or group % 2:
        raise ValueError(f"quantize_weight4: K {K} must be a multiple of an "
                         f"even group, got {group}")
    wg = w.float().reshape(N, K // group, group)
    # a divisor on the device: CUDA turns division by a host scalar into a
    # product with its reciprocal, which can differ from JAX's quotient
    seven = torch.tensor(7.0, device=w.device)
    scale = torch.clamp(wg.abs().amax(dim=2), min=1e-8) / seven
    codes = torch.clamp(torch.round(wg / scale[:, :, None]), -7, 7)
    return pack_int4(codes.reshape(N, K), dim=1), scale


def dequantize_weight4(w_q: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """(w_q [N, K // 2], scale [N, G]) -> the dense weight [N, K] in
    `dtype`, scaled in fp32 first."""
    w = unpack_int4(w_q, dim=1).float()
    N, K = w.shape
    G = scale.shape[1]
    return (w.reshape(N, G, K // G) * scale.float()[:, :, None]).reshape(N, K).to(dtype)


def int4_matmul(x: torch.Tensor, w_q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y[..., n] = sum_k x[..., k] dequant(w_q, scale)[n, k], in x's dtype.

    At most INT4_GROUPED_MAX_M rows (decode, verify, the queries): one
    product a group, each partial sum [G, M, N] in fp32 and scaled there,
    then summed over the groups (JAX's `preferred_element_type` dot); more
    rows: one product over the weight dequantized to x's dtype. Like
    int8_matmul, differentiable in x only (frozen weights)."""
    if x.requires_grad and torch.is_grad_enabled():
        return _Int4Matmul.apply(x, w_q, scale)
    return _int4_matmul_fwd(x, w_q, scale)


def _int4_matmul_fwd(x, w_q, scale):
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    N, G = scale.shape
    if M > INT4_GROUPED_MAX_M:
        y = F.linear(x2, dequantize_weight4(w_q, scale, x.dtype))
    else:
        k = K // G
        xg = x2.float().reshape(M, G, k).transpose(0, 1)                   # [G, M, k]
        wg = unpack_int4(w_q, dim=1).float().reshape(N, G, k).permute(1, 2, 0)  # [G, k, N]
        y = (torch.bmm(xg, wg) * scale.float().t()[:, None, :]).sum(0)
    return y.to(x.dtype).reshape(*lead, N)


def int4_matmul_dx(g: torch.Tensor, w_q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """dx[..., k] = sum_n g[..., n] dequant(w_q, scale)[n, k] in fp32, cast
    to g's dtype (JAX's `_int4_matmul_bwd` :274-296): at most
    INT4_GROUPED_MAX_M rows, the scale folded into a per-group cotangent
    and one product a group; more, a product over the fp32 dequantized
    weight."""
    lead, N = g.shape[:-1], g.shape[-1]
    g2 = g.reshape(-1, N).float()
    M = g2.shape[0]
    G, K = scale.shape[1], w_q.shape[1] * 2
    if M > INT4_GROUPED_MAX_M:
        dx = g2 @ dequantize_weight4(w_q, scale, torch.float32)
    else:
        gs = g2[None] * scale.float().t()[:, None, :]                       # [G, M, N]
        wv = unpack_int4(w_q, dim=1).float().reshape(N, G, K // G).transpose(0, 1)
        dx = torch.bmm(gs, wv).transpose(0, 1).reshape(M, K)
    return dx.to(g.dtype).reshape(*lead, K)


class _Int4Matmul(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w_q, scale):
        ctx.save_for_backward(w_q, scale)
        return _int4_matmul_fwd(x, w_q, scale)

    @staticmethod
    def backward(ctx, g):
        w_q, scale = ctx.saved_tensors
        dx = int4_matmul_dx(g, w_q, scale) if ctx.needs_input_grad[0] else None
        return dx, None, None
