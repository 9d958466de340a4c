"""Softmax cross-entropy over the tied LM head, with no logits in memory.

Counterpart of `simlingo_tpu/kernels/fused_ce.py`: `fused_ce` (:178), a
custom VJP over `_fwd_kernel` (:55) and `_bwd_kernel` (:85).
`models/adaptors.py:language_loss_gathered` routes through it when
SIMLINGO_CE_IMPL is pallas or pallas_dw (`core/gates.py`) and the head is
the tied [V, H] embedding.

    fused_ce(h2 [N, H], labels [N], w [V, H], compute_dw) -> ce [N] fp32
    ce = logz - gold, logz = logsumexp(h2 w^T), gold = the label's logit

A row whose label is outside [0, V) gets a finite logz and gold 0; the
caller masks it. The backward recomputes the logits from the saved logz:
    dlogits = ((exp(logits - logz) - onehot) g), rounded to w's dtype
    dh = dlogits w          (in h's dtype)
    dW = dlogits^T h        (fp32 sums, in w's dtype; compute_dw only)
With compute_dw False the gradient of w is zeros (JAX `_fused_ce_bwd`
:207-210), or None where autograd does not ask for it. With compute_dw
True, dW is computed where autograd asks for it.

On a CUDA tensor `fused_ce_fwd` / `fused_ce_bwd` launch `csrc/fused_ce.cu`:
its bf16 build for bf16 h and w, its fp32 build (fp32 FMA products, no
tensor cores; counted also in `launches_fp32`) for fp32 h and w; any other
dtype, or h and w of two dtypes, raises. A width H that is not a multiple
of 32 is zero-padded to one (`_pad_width`: zero columns add nothing to a
logit, and their dh / dW columns are cut off); the path's H = 896 takes no
copy. On a CPU tensor they run their plain versions. Labels may come as
any integer type: the wrapper hands the kernel int64.

The backward on the card is a scratch and two tiled products (`_bwd_plan`
sizes them; the same grids at both dtypes): dlogits is written once, in
w's dtype (582.5 MB at fp32 at the training shape), to dl [N, Vpad]
(Vpad = 128 ceil(V / 128), zero past V); dh = dl w goes per vocabulary
segment (S segments of whole 128-column steps) into fp32 partials
[S, N, H], summed in segment order; dW = dl^T h. `ce_dlogits_reference`,
`ce_dh_from_scratch_reference` and `ce_dw_from_scratch_reference` are those
passes in plain PyTorch. The plain versions compute in fp32, or in fp64 for
fp64 inputs (the card's references for the fp32 build).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from simlingo_tpu_torch.kernels import _build

DTYPES = (torch.bfloat16, torch.float32)   # the kernels' builds
WIDTH_STEP = 32                           # H is zero-padded to a multiple of it
_FWD_TILE = 128                           # vocabulary columns per forward block
# csrc/fused_ce.cu's backward geometry (simlingo_fused_ce_bwd_geometry):
_VSTEP = 128                              # vocabulary columns a dlogits tile, a segment step
_DH_TILE = (128, 128)                     # product tile: rows, columns
_DH_RESIDENT = 2                          # product blocks an SM
_DH_MAX_SEGMENTS = 16                     # cap on S: fp32 partials [S, N, H]


# ---------------------------------------------------------------------------
# plain versions (fp32 math, the kernels' rounding points)
# ---------------------------------------------------------------------------

def _logits(h2, w):
    return _build.wide(h2) @ _build.wide(w).t()


def fused_ce_fwd_plain(h2, labels, w, abs_terms=False):
    """(logz [N], ce [N]) fp32 (fp64 for fp64 inputs). With `abs_terms`,
    returns instead the sums of |h| |w| that a logit's rounding scales
    with, as (logz's: sum_v p_v sum_k |h_k| |w_vk|, ce's: that plus the
    gold logit's): the fp32 rounding of ce is at most fp32_unit(H) times
    them plus the sum of V exponentials' fp32_unit(V)."""
    V = w.shape[0]
    logits = _logits(h2, w)
    logz = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    ok = (labels >= 0) & (labels < V)
    at = labels.clamp(0, V - 1)[:, None]
    zero = torch.zeros((), dtype=logz.dtype, device=h2.device)
    if abs_terms:
        a = _build.wide(h2).abs() @ _build.wide(w).abs().t()
        lz_terms = (torch.softmax(logits, dim=-1) * a).sum(-1)
        return lz_terms, lz_terms + torch.where(ok, a.gather(1, at)[:, 0], zero)
    gold = logits.gather(1, at)[:, 0]
    return logz, logz - torch.where(ok, gold, zero)


def _dlogits_plain(h2, labels, w, logz, g):
    V = w.shape[0]
    p = torch.exp(_logits(h2, w) - logz[:, None])
    onehot = labels.long()[:, None] == torch.arange(V, device=h2.device)[None]
    return (p - onehot.to(p.dtype)) * _build.wide(g)[:, None]


def fused_ce_bwd_plain(h2, labels, w, logz, g, compute_dw, abs_terms=False):
    """(dh in h's dtype, dW in w's dtype or None). dlogits is rounded to
    w's dtype before both products, as the kernels do. With `abs_terms`,
    returns instead |dlogits| |w| and |dlogits|^T |h| (fp32, or fp64 for
    fp64 inputs): the sums of |term| that bound the kernel's rounding error
    (at fp32, fp32_unit(H + V) and fp32_unit(H + N) times them)."""
    dl = _build.wide(_dlogits_plain(h2, labels, w, logz, g).to(w.dtype))
    hf, wf = _build.wide(h2), _build.wide(w)
    if abs_terms:
        dl, hf, wf = dl.abs(), hf.abs(), wf.abs()
    dh = dl @ wf
    dw = dl.t() @ hf if compute_dw else None
    if abs_terms:
        return dh, dw
    return dh.to(h2.dtype), None if dw is None else dw.to(w.dtype)


class BwdPlan(NamedTuple):
    vpad: int                      # scratch row length: 128 ceil(V / 128)
    scratch_shape: Tuple[int, int]     # dl [N, vpad], w's dtype
    scratch_bytes: int
    dlogits_blocks: int            # (128 rows, 128 columns) tiles of dl
    S: int                         # vocabulary segments of the dh product
    seg_steps: int                 # 128-column steps a segment (the last may be short)
    segments: Tuple[Tuple[int, int], ...]    # [c0, c1) columns of dl per segment
    part_shape: Tuple[int, int, int]     # fp32 partials of dh [S, N, H]
    dh_blocks: int                 # (128 x 128 tile of dh, segment)
    dw_blocks: int                 # (128 vocabulary rows, 128 columns of H)


def _wave_fill(blocks: int, slots: int) -> float:
    """The share of `ceil(blocks / slots)` waves of `slots` blocks that
    `blocks` blocks fill."""
    return blocks / (-(-blocks // slots) * slots)


def _segments(steps: int, S: int):
    """(S, steps a segment) for at most S segments of whole steps, none
    empty."""
    per = -(-steps // S)
    return -(-steps // per), per


def _bwd_plan(N: int, H: int, V: int, sms: int, dtype=torch.bfloat16) -> BwdPlan:
    """The backward's scratch (dl in w's dtype, `dtype`) and grids, the
    same grids at both dtypes. dh's reduction (the vocabulary)
    is cut into S segments of whole 128-column steps, the segment the
    grid's slowest axis, so the tiles of one segment (fewer than a wave of
    _DH_RESIDENT blocks an SM) run together. Where the tiles alone fill a
    wave, S = 1; else S <= _DH_MAX_SEGMENTS fills its last wave best, the
    fewest segments among equals (the training shape: 56 tiles, S = 14,
    784 blocks, 2.97 waves of 264; `chip_smoke.py --ce-sweep`)."""
    bm, bn = _DH_TILE
    vpad = _VSTEP * -(-V // _VSTEP)
    steps = vpad // _VSTEP
    tiles = -(-N // bm) * -(-H // bn)
    slots = _DH_RESIDENT * sms
    S = 1
    if tiles < slots:
        S = max((_segments(steps, s)[0] for s in range(1, min(steps, _DH_MAX_SEGMENTS) + 1)),
                key=lambda s: (_wave_fill(tiles * s, slots), -s))
    S, per = _segments(steps, S)
    segments = tuple((s * per * _VSTEP, min(steps, (s + 1) * per) * _VSTEP)
                     for s in range(S))
    return BwdPlan(vpad=vpad, scratch_shape=(N, vpad),
                   scratch_bytes=dtype.itemsize * N * vpad,
                   dlogits_blocks=-(-N // _FWD_TILE) * steps, S=S, seg_steps=per,
                   segments=segments, part_shape=(S, N, H), dh_blocks=tiles * S,
                   dw_blocks=-(-H // bn) * (vpad // bm))


def ce_dlogits_reference(h2, labels, w, logz, g, plan):
    """The first pass, plain: dl [N, vpad] in w's dtype, dlogits rounded
    where the kernel rounds it, 0 in the columns past V."""
    N, V = h2.shape[0], w.shape[0]
    dl = torch.zeros(plan.scratch_shape, dtype=w.dtype, device=h2.device)
    dl[:, :V] = _dlogits_plain(h2, labels, w, logz, g).to(w.dtype)
    return dl


def ce_dh_from_scratch_reference(dl, w, plan, abs_terms=False):
    """The second pass, plain: fp32 partials dl[:, seg] w[seg] per segment
    (w zero past V, as the kernel zero-fills it), summed in segment order;
    fp32 [N, H], fp64 for fp64 inputs (|dl| |w| with `abs_terms`)."""
    V, H = w.shape
    dlf = _build.wide(dl)
    wf = torch.zeros((plan.vpad, H), dtype=dlf.dtype, device=w.device)
    wf[:V] = _build.wide(w)
    if abs_terms:
        dlf, wf = dlf.abs(), wf.abs()
    out = None
    for c0, c1 in plan.segments:
        part = dlf[:, c0:c1] @ wf[c0:c1]
        out = part if out is None else out + part
    return out


def ce_dw_from_scratch_reference(dl, h2, V, abs_terms=False):
    """The dW pass, plain: dl[:, :V]^T h, fp32 [V, H] (|dl|^T |h| with
    `abs_terms`); the columns of dl past V are never read."""
    dlf, hf = _build.wide(dl[:, :V]), _build.wide(h2)
    if abs_terms:
        dlf, hf = dlf.abs(), hf.abs()
    return dlf.t() @ hf


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(what, h2, labels, w):
    for name, x in (("h2", h2), ("w", w)):
        if x.dtype not in DTYPES:
            raise TypeError(f"{what} kernel takes bf16 or fp32 {name}, got {x.dtype}")
    if h2.dtype != w.dtype:
        raise TypeError(f"{what} kernel takes h2 and w of one dtype, got {h2.dtype} "
                        f"and {w.dtype}")
    if h2.dim() != 2 or w.dim() != 2 or h2.shape[1] != w.shape[1] \
            or labels.shape != h2.shape[:1]:
        raise ValueError(f"{what}: shapes h2 {tuple(h2.shape)}, labels "
                         f"{tuple(labels.shape)}, w {tuple(w.shape)}")


def _pad_width(h2, w):
    """h2 and w with H zero-padded to a multiple of WIDTH_STEP, each 16-byte
    aligned; the same tensors (or aligned copies) where H is one already."""
    H = h2.shape[1]
    pad = -H % WIDTH_STEP
    if pad:
        h2, w = (torch.nn.functional.pad(x, (0, pad)) for x in (h2, w))
    return _build.aligned16(h2), _build.aligned16(w)


def fused_ce_fwd(h2, labels, w):
    """(logz [N], ce [N]) fp32."""
    if h2.device.type == "cpu":
        return fused_ce_fwd_plain(h2, labels, w)
    _check("fused_ce_fwd", h2, labels, w)
    fp32 = h2.dtype == torch.float32
    h2, w = _pad_width(h2, w)
    labels = labels.to(torch.int64).contiguous()
    N, H = h2.shape
    V = w.shape[0]
    dev = h2.device
    logz = torch.empty(N, dtype=torch.float32, device=dev)
    ce = torch.empty(N, dtype=torch.float32, device=dev)
    if N == 0:
        return logz, ce
    nvt = -(-V // _FWD_TILE)
    part = torch.empty((2, nvt, N), dtype=torch.float32, device=dev)
    gold = torch.empty(N, dtype=torch.float32, device=dev)
    rc = _lib().simlingo_fused_ce_fwd(
        h2.data_ptr(), w.data_ptr(), labels.data_ptr(), part[0].data_ptr(),
        part[1].data_ptr(), gold.data_ptr(), logz.data_ptr(), ce.data_ptr(),
        N, H, V, int(fp32), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_ce_fwd")
    _build.count_launch(fused_ce_fwd, h2.dtype)
    return logz, ce


def fused_ce_bwd(h2, labels, w, logz, g, compute_dw, return_scratch=False):
    """(dh [N, H] in h's dtype, dW [V, H] in w's dtype or None); with
    `return_scratch` (CUDA only) also the dlogits scratch dl [N, Vpad]."""
    if h2.device.type == "cpu":
        if return_scratch:
            raise ValueError("fused_ce_bwd: the scratch exists on the card only")
        return fused_ce_bwd_plain(h2, labels, w, logz, g, compute_dw)
    _check("fused_ce_bwd", h2, labels, w)
    fp32 = h2.dtype == torch.float32
    width = h2.shape[1]
    h2, w = _pad_width(h2, w)
    labels = labels.to(torch.int64).contiguous()
    logz = logz.float().contiguous()
    g = g.float().contiguous()
    N, H = h2.shape
    V = w.shape[0]
    dev = h2.device
    dh = torch.empty_like(h2)
    dw = torch.empty_like(w) if compute_dw else None
    dl = None
    if N == 0:
        dw = None if dw is None else dw.zero_()
    else:
        plan = _bwd_plan(N, H, V, _build.sm_count(dev.index or 0), w.dtype)
        dl = torch.empty(plan.scratch_shape, dtype=w.dtype, device=dev)
        part = torch.empty(plan.part_shape, dtype=torch.float32, device=dev)
        rc = _lib().simlingo_fused_ce_bwd(
            h2.data_ptr(), w.data_ptr(), labels.data_ptr(), logz.data_ptr(), g.data_ptr(),
            dl.data_ptr(), part.data_ptr(), dh.data_ptr(),
            None if dw is None else dw.data_ptr(), N, H, V, plan.S, plan.seg_steps,
            int(fp32), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(rc, "fused_ce_bwd")
        _build.count_launch(fused_ce_bwd, h2.dtype)
    if H != width:
        dh = dh[:, :width].contiguous()
        dw = None if dw is None else dw[:, :width].contiguous()
    return (dh, dw, dl) if return_scratch else (dh, dw)


fused_ce_fwd.launches = 0
fused_ce_fwd.launches_fp32 = 0           # of them, the fp32 build's
fused_ce_bwd.launches = 0
fused_ce_bwd.launches_fp32 = 0


def _lib():
    lib = _build.load("fused_ce")
    if lib.simlingo_fused_ce_fwd.argtypes is None:
        lib.simlingo_fused_ce_fwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        lib.simlingo_fused_ce_fwd.restype = ctypes.c_int
        lib.simlingo_fused_ce_bwd.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.simlingo_fused_ce_bwd.restype = ctypes.c_int
        lib.simlingo_fused_ce_bwd_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.simlingo_fused_ce_bwd_geometry.restype = None
        geometry = (ctypes.c_int * 4)()
        lib.simlingo_fused_ce_bwd_geometry(geometry)
        want = (_VSTEP, *_DH_TILE, _DH_RESIDENT)
        if tuple(geometry) != want:
            raise RuntimeError(f"fused_ce_bwd: the library's geometry {tuple(geometry)} "
                               f"differs from the plan's {want}")
    return lib


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class _FusedCE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h2, labels, w, compute_dw: bool):
        logz, ce = fused_ce_fwd(h2, labels, w)
        ctx.save_for_backward(h2, labels, w, logz)
        ctx.compute_dw = compute_dw
        return ce

    @staticmethod
    def backward(ctx, g):
        h2, labels, w, logz = ctx.saved_tensors
        want_w = ctx.needs_input_grad[2]
        dh, dw = fused_ce_bwd(h2, labels, w, logz, g, ctx.compute_dw and want_w)
        if dw is None and want_w:
            dw = torch.zeros_like(w)         # the frozen tied head: no dW
        return dh, None, dw, None


def fused_ce(h2, labels, w, compute_dw: bool = False):
    """Per-row CE of h2 [N, H] against the tied head w [V, H]: ce [N] fp32."""
    return _FusedCE.apply(h2, labels, w, compute_dw)
