"""Flash attention with slot-order causality and key validity.

Counterpart of `simlingo_tpu/kernels/flash_attention.py`. Forward:
`csrc/flash_attn_fwd.cu` covers the three Pallas forward kernels --
`_fwd_kernel_gqa` (:308, the LLM), `_fwd_kernel_pair` (:786, the ViT read
from the flat projection output) and `_fwd_kernel` (:114, plain MHA) -- on
two paths that `_fwd_plan` chooses between: the tiled path (blocks of 64
query rows of one head) and, for a small T x group, the split path (a
GQA group's heads packed into one block's rows as `_fwd_kernel_gqa` packs
them, the keys cut into splits whose partials a thread-block cluster merges
in split order; `attention_split_reference` is its plain version). Where
a row can see fewer than 64 keys by position (`_fwd_remainder`), the
kernel's second build also takes P's bf16 remainder into the product with
V on the tiles of rows whose weights sum to under 64, so such rows carry
no rounding of their weights; elsewhere it is the one-pass loop.
Backward (training): `csrc/flash_attn_bwd.cu` covers `_bwd_kernel_gqa`
(:382), `_bwd_kernel_pair` (:869) and `_bwd_kernel` (:205) the same way,
from the output and the forward's base-2 log-sum-exp (`attention_train`).
Its dK/dV kernel writes the bf16 dS once to a scratch of key-major tiles and
its dQ kernel is the tiled product scale dS K (`_bwd_plan` sizes the scratch;
`attention_ds_reference` and `attention_dq_from_ds_reference` are the two
passes in plain PyTorch).

Semantics (as `attention_reference` in the JAX package, :71-107):
  * q [B, T, HQ, D], k/v [B, S, HK, D]; query head h reads kv head
    h // (HQ // HK) (heads are kv-major);
  * causal masking is slot-order: query row i sits at slot i + q_offset and
    sees key slots <= that; q_offset None means S - T;
  * kv_valid [B, S] bool masks keys; a row with no visible valid key
    returns 0.

Head dims: both CUDA files are built at D = 16, 32, 64 and 128
(`HEAD_DIMS`; JAX's kernels read D from the shapes). Any other D <= 128 is
zero-padded to the next of these (`_instance_dim`) before the launch, with
the scale kept at the true D ** -0.5: zero q and k columns add nothing to
q k^T, zero v and dO columns nothing to dO v^T or rowsum(dO o), and the
padded output and gradient columns are cut off, so the result is that of
D. No configuration of the repo takes that route (the CLIP tower and the
LLMs use 64, SimLingo-Base's LLaMA variants past `tiny` 128, the test
configurations 16 and 32). D > 128 raises on a CUDA tensor.

On a CUDA tensor `attention` launches the kernel (bf16, or fp32 for
training at precision=fp32: the fp32 builds of both files, tiled path
only, fp32 products; any other dtype raises); on a CPU tensor it runs
`attention_reference`. `attention_train` does the same for
the forward and, in its backward, launches `flash_attn_bwd` on CUDA tensors
and runs `attention_bwd_reference` on CPU tensors. `attention_autograd`
hands the LLM's slabs to the ring under sequence parallelism
(`parallel/sequence.py`), which launches both kernels a chunk.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from simlingo_tpu_torch.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634


def _w(x):
    """x in the plain versions' working type: fp32, or fp64 for fp64 inputs
    (a reference that holds an fp32 kernel to its own rounding)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        kv_valid: Optional[torch.Tensor], causal: bool,
                        scale: Optional[float] = None,
                        q_offset: Optional[int] = None) -> torch.Tensor:
    """Plain version in fp32 (fp64 for fp64 inputs): masked softmax(scale *
    q k^T) v."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    group = HQ // HK
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = S - T
    qf = _w(q) * scale
    kf = _w(k).repeat_interleave(group, dim=2)
    vf = _w(v).repeat_interleave(group, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", qf, kf)
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if causal:
        q_slot = torch.arange(T, device=q.device)[:, None] + q_offset
        kv_slot = torch.arange(S, device=q.device)[None, :]
        mask = mask & (kv_slot <= q_slot)[None, None]
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / torch.clamp(l, min=1e-30)
    out = torch.einsum("bhts,bshd->bthd", p, vf)
    any_valid = mask.any(dim=-1)                          # [B, H|1, T]
    out = out * any_valid.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
              scale: Optional[float] = None,
              q_offset: Optional[int] = None) -> torch.Tensor:
    """[B, T, HQ, D] x [B, S, HK, D] -> [B, T, HQ, D]."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, kv_valid, causal, scale, q_offset)
    return flash_attn_fwd(q, k, v, kv_valid, causal, scale, q_offset)


# The head dims both CUDA files are built at; others up to the last are
# zero-padded to the next of these.
HEAD_DIMS = (16, 32, 64, 128)


def _instance_dim(D):
    """The built head dim a launch at head dim D uses: D itself, or the
    next one up, to which the wrapper zero-pads. Raises past 128."""
    for d in HEAD_DIMS:
        if D <= d:
            return d
    raise ValueError(f"flash attention kernels take head_dim up to {HEAD_DIMS[-1]}, got {D}")


def _pad_d(x, d):
    """x [..., D] zero-padded to [..., d] (a contiguous copy), or x where D == d."""
    return x if x.shape[-1] == d else F.pad(x, (0, d - x.shape[-1]))


# The forward's geometry at every D: keys a tile, query rows a block, the
# largest cluster of splits; the dynamic shared memory a block is
# `_fwd_smem_bytes`. `_lib` refuses a library that reports others
# (simlingo_flash_attn_fwd_geometry, at each D and dtype).
_FWD_GEOMETRY = (64, 64, 8)
_FWD_TILE, _FWD_ROWS = _FWD_GEOMETRY[:2]
# the dtypes the kernels take; fp32 has the tiled path only
DTYPES = (torch.bfloat16, torch.float32)


def _fwd_smem_bytes(d, dtype=torch.bfloat16):
    """The forward's dynamic shared memory a block at built head dim d.
    bf16: the cp.async ring, 3 stages of a K and a V tile, rows padded by 8
    (55,296 bytes at d = 64). fp32: Q, a 2-stage ring of K and V tiles
    (rows of d + 4 floats) and P [64][68] (104,448 bytes at d = 64, 186,368
    at d = 128; 3 stages would pass the 232,448 a block may have at 128)."""
    if dtype == torch.float32:
        return (_FWD_ROWS * (d + 4) + 2 * 2 * _FWD_TILE * (d + 4)
                + _FWD_ROWS * (_FWD_TILE + 4)) * 4
    return 3 * 2 * _FWD_TILE * (d + 8) * 2
# The split path takes a GQA group whose packed rows (group x T) number at
# most this many: decode 7, verify 112, the queries 210 (Qwen2-0.5B, group
# 7). Against the 770-key cache it beat the tiled path up to T = 256 (1792
# packed rows) and lost at the prefill's 4480 (`chip_smoke.py --attn-sweep`).
SPLIT_MAX_ROWS = 1792
# At most this many splits (one cluster) a row block: the portable cluster size.
SPLIT_MAX = _FWD_GEOMETRY[2]


class FwdPlan(NamedTuple):
    path: str                 # "split" or "tiled"
    rows: int                 # rows a (kv head | query head, batch) walks: group * T or T
    row_blocks: int           # blocks of _FWD_ROWS of those rows
    splits: int               # split path: blocks (one cluster) a row block; tiled: 0
    tiles_per_split: int      # key tiles of _FWD_TILE keys a split
    kv_end: int               # keys [0, kv_end) some row may see
    key_ranges: tuple         # each split's keys [lo, hi), clipped to kv_end; tiled: one range
    grid: tuple               # the launch's (x, y, z)
    remainder: bool           # the kernel's build with P's remainder (`_fwd_remainder`)
    head_dim: int             # the built head dim launched (`_instance_dim`)
    smem_bytes: int           # dynamic shared memory a block
    dtype: torch.dtype = torch.bfloat16   # the operands' (and the build's)


@functools.lru_cache(maxsize=256)
def _fwd_launch(B, T, S, HQ, HK, sms=132, split_rows=SPLIT_MAX_ROWS, max_splits=SPLIT_MAX,
                dtype=torch.bfloat16):
    """(splits, key tiles a split) of `flash_attn_fwd`, from the shapes
    alone (the grid does not depend on q_offset); 0 splits is the tiled
    path. The split path cuts the key tiles of S into at most `max_splits`
    runs of equal length, fewer where its blocks would pass one an SM; it
    is taken where a group's packed rows group x T are at most
    `split_rows` and at least two splits fit (the ViT's 1025 rows of 32
    heads fill the card with one). fp32 takes the tiled path at every T:
    the split path serves decode, which runs bf16 only (a plan rule, not
    a fallback)."""
    if not 1 <= max_splits <= SPLIT_MAX:
        raise ValueError(f"flash_attn_fwd: max_splits {max_splits} not in [1, {SPLIT_MAX}]")
    if dtype == torch.float32:
        return 0, 0
    n_kt = max(1, -(-S // _FWD_TILE))
    fit = sms // (-(-(HQ // HK) * T // _FWD_ROWS) * B * HK)      # splits of one block an SM
    if (HQ // HK) * T > split_rows or fit < 2 <= n_kt:
        return 0, 0
    splits = max(1, min(max_splits, n_kt, fit))
    tps = -(-n_kt // splits)
    return -(-n_kt // tps), tps


def _fwd_remainder(S, causal, q_offset):
    """Whether `flash_attn_fwd` launches the kernel's build that adds P's
    bf16 remainder on the tiles of few-key rows: where a row can see fewer
    than one tile of keys by position (causal from a slot under
    _FWD_TILE - 1, or S under a tile). A key mask is not counted: such
    rows keep the one-pass bf16 P of the TPU kernel (`p.astype`)."""
    return (min(S, q_offset + 1) if causal else S) < _FWD_TILE


def _fwd_plan(B, T, S, HQ, HK, causal, q_offset, sms=132, split_rows=SPLIT_MAX_ROWS,
              max_splits=SPLIT_MAX, D=64, dtype=torch.bfloat16):
    """The blocks of `flash_attn_fwd` and the keys each split attends to
    (`_fwd_launch`), at head dim D and the operands' dtype. The tiles and
    the grid do not depend on D; the built head dim and the shared memory
    a block do. fp32: the tiled path, no remainder build (P is fp32)."""
    splits, tps = _fwd_launch(B, T, S, HQ, HK, sms, split_rows, max_splits, dtype)
    kv_end = max(0, min(S, q_offset + T)) if causal else S
    few = dtype != torch.float32 and _fwd_remainder(S, causal, q_offset)
    d = _instance_dim(D)
    if splits:
        rows = (HQ // HK) * T
        span = tps * _FWD_TILE
        ranges = tuple((min(s * span, kv_end), min((s + 1) * span, kv_end))
                       for s in range(splits))
        grid = (splits, -(-rows // _FWD_ROWS), B * HK)
        return FwdPlan("split", rows, grid[1], splits, tps, kv_end, ranges, grid, few,
                       d, _fwd_smem_bytes(d), dtype)
    grid = (-(-T // _FWD_ROWS), HQ, B)
    return FwdPlan("tiled", T, grid[0], 0, 0, kv_end, ((0, kv_end),), grid, few,
                   d, _fwd_smem_bytes(d, dtype), dtype)


def _packed_rows(group, T):
    """(head in group, t) of each packed row r of the split path: r // T,
    r % T, as `_fwd_kernel_gqa` reshapes [G, bq, D] to G * bq rows."""
    r = torch.arange(group * T)
    return r // T, r % T


def attention_split_reference(q, k, v, kv_valid, causal, scale=None, q_offset=None,
                              return_lse=False, plan=None):
    """Plain version of the split path in fp32: each GQA group's heads
    packed into rows (`_packed_rows`), a partial (m, l, O) of every row
    over each split's keys (`_fwd_plan`'s key ranges; base 2, m = -inf and
    l = 0 where the split shows the row no key), merged in split order.
    A row that sees no valid key gives 0 (and lse -inf)."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    G = HQ // HK
    scale, q_offset = _defaults(q, k, scale, q_offset)
    if plan is None:
        plan = _fwd_plan(B, T, S, HQ, HK, bool(causal), q_offset, split_rows=G * T)
    hg, t = (x.to(q.device) for x in _packed_rows(G, T))
    heads = torch.arange(HK, device=q.device)[:, None] * G + hg[None]        # [HK, R]
    tt = t[None].expand_as(heads)
    qp = q.float()[:, tt, heads]                                             # [B, HK, R, D]
    x = torch.einsum("bkrd,bskd->bkrs", qp * scale, k.float()) * LOG2E
    mask = torch.ones((B, 1, G * T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (torch.arange(S, device=q.device)[None, :] <= (t + q_offset)[:, None])
    if kv_valid is not None:
        mask = mask & kv_valid.bool().expand(B, S)[:, None, None, :]
    x = x.masked_fill(~mask, float("-inf"))
    vf = v.float()
    inf = torch.tensor(float("-inf"), device=q.device)
    parts = []
    for lo, hi in plan.key_ranges:
        xs = x[..., lo:hi]
        m = xs.amax(-1) if hi > lo else inf.expand(x.shape[:-1])
        p = torch.exp2(xs - torch.where(m == inf, 0.0, m)[..., None])
        parts.append((m, p.sum(-1), torch.einsum("bkrs,bskd->bkrd", p, vf[:, lo:hi])))
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    L = torch.zeros_like(M)
    O = torch.zeros(qp.shape, device=q.device)
    for m, l, o in parts:                                  # split order 0..n-1
        w = torch.where(m == inf, 0.0, torch.exp2(m - torch.where(M == inf, 0.0, M)))
        L = L + l * w
        O = O + o * w[..., None]
    seen = L > 0
    out = torch.zeros((B, T, HQ, D), device=q.device)
    out[:, tt, heads] = torch.where(seen[..., None], O / L.clamp(min=1e-30)[..., None], 0.0)
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.full((B, HQ, T), float("-inf"), device=q.device)
    lse[:, heads, tt] = torch.where(seen, M + torch.log2(L.clamp(min=1e-30)), inf)
    return out, lse


def _check_dtypes(what, tensors):
    """The operands' one dtype: bf16 or fp32, the same for all."""
    dtype = tensors[0][1].dtype
    for name, x in tensors:
        if x.dtype not in DTYPES or x.dtype != dtype:
            raise TypeError(f"{what} kernel takes bf16 or fp32 (all operands alike), "
                            f"{name} is {x.dtype} ({tensors[0][0]} {dtype})")
    return dtype


def _check_bthd(name, x, D):
    if x.dim() != 4 or x.shape[-1] != D or x.stride(-1) != 1:
        raise ValueError(f"flash_attn_fwd: {name} must be [B, L, H, {D}] with "
                         f"unit stride in D, got {tuple(x.shape)} / {x.stride()}")


def flash_attn_fwd(q, k, v, kv_valid=None, causal=True, scale=None,
                   q_offset=None, return_lse=False, split_rows=SPLIT_MAX_ROWS,
                   max_splits=SPLIT_MAX):
    """Launch the CUDA kernel of the path `_fwd_plan` chooses (one launch
    a call; sweeps and tests force another through its knobs `split_rows`
    and `max_splits`, so the plan always fits these shapes). q/k/v may be
    strided views (e.g. heads of a [B, T, H*D] projection, or a KV cache);
    no copy is made at a built head dim (`HEAD_DIMS`), and any other D <=
    128 is zero-padded to the next one. bf16 or fp32 operands (fp32: the
    fp32 build, tiled path); the output in their dtype. With `return_lse`
    also returns the base-2 log-sum-exp [B, HQ, T] fp32 of the scaled
    logits (-inf where a row sees no valid key)."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    d = _instance_dim(D)
    dtype = _check_dtypes("flash_attn_fwd", (("q", q), ("k", k), ("v", v)))
    fp32 = dtype == torch.float32
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_bthd(name, x, D)
    if k.shape != v.shape or k.shape[0] != B or HQ % HK:
        raise ValueError(f"flash_attn_fwd: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    q, k, v = (_pad_d(x, d) for x in (q, k, v))
    # k/v tiles are read 16 bytes at a time
    per16 = 16 // k.element_size()
    for name, x in (("k", k), ("v", v)):
        if x.data_ptr() % 16 or any(s % per16 for s in x.stride()[:3]):
            raise ValueError(f"flash_attn_fwd: {name} rows must be 16-byte aligned")
    if q.data_ptr() % 4 or (not fp32 and any(s % 2 for s in q.stride()[:3])):
        raise ValueError("flash_attn_fwd: q rows must be 4-byte aligned")
    if scale is None:
        scale = D ** -0.5
    if q_offset is None:
        q_offset = S - T
    valid_ptr = None
    if kv_valid is not None:
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8)
        kv_valid = kv_valid.expand(B, S).contiguous()
        valid_ptr = kv_valid.data_ptr()
    out = torch.empty((B, T, HQ, d), dtype=dtype, device=q.device)
    lse = (torch.empty((B, HQ, T), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if B * T == 0:
        out = out[..., :D]
        return (out, lse) if return_lse else out
    splits, tps = _fwd_launch(B, T, S, HQ, HK, _build.sm_count(q.device.index or 0),
                              split_rows, max_splits, dtype)
    few = not fp32 and _fwd_remainder(S, bool(causal), int(q_offset))
    lib = _lib()
    rc = lib.simlingo_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, out.data_ptr(),
        lse.data_ptr() if return_lse else None, B, T, S, HQ, HK,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(q_offset), ctypes.c_float(float(scale)),
        splits, tps, int(few), int(fp32), d,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn_fwd")
    flash_attn_fwd.launches += 1
    flash_attn_fwd.launches_by_dim[d] = flash_attn_fwd.launches_by_dim.get(d, 0) + 1
    if fp32:
        flash_attn_fwd.launches_fp32 += 1
    out = out[..., :D] if d != D else out
    return (out, lse) if return_lse else out


flash_attn_fwd.launches = 0
flash_attn_fwd.launches_by_dim = {}      # built head dim -> launches
flash_attn_fwd.launches_fp32 = 0         # of them, the fp32 build's


def _lib():
    lib = _build.load("flash_attn_fwd")
    fn = lib.simlingo_flash_attn_fwd
    if fn.argtypes is None:
        for d in HEAD_DIMS:
            for dtype in DTYPES:
                geometry = (ctypes.c_int * 4)()
                rc = lib.simlingo_flash_attn_fwd_geometry(d, int(dtype == torch.float32),
                                                          geometry)
                want = (*_FWD_GEOMETRY, _fwd_smem_bytes(d, dtype))
                if rc != 0 or tuple(geometry) != want:
                    raise RuntimeError(f"flash_attn_fwd: the library's {dtype} geometry at "
                                       f"D = {d} {tuple(geometry)} (rc {rc}) differs from "
                                       f"the plan's {want}")
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# ---------------------------------------------------------------------------
# Training: lse, the backward, and the autograd Function
# ---------------------------------------------------------------------------

def _scaled_logits(q, k, kv_valid, causal, scale, q_offset):
    """scale * q k^T [B, HQ, T, S] (fp32; fp64 for fp64 inputs) and the
    visibility mask."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    kf = _w(k).repeat_interleave(HQ // HK, dim=2)
    logits = torch.einsum("bthd,bshd->bhts", _w(q) * scale, kf)
    mask = torch.ones((B, 1, T, S), dtype=torch.bool, device=q.device)
    if causal:
        q_slot = torch.arange(T, device=q.device)[:, None] + q_offset
        mask = mask & (torch.arange(S, device=q.device)[None, :] <= q_slot)
    if kv_valid is not None:
        mask = mask & kv_valid.bool()[:, None, None, :]
    return logits, mask


def _defaults(q, k, scale, q_offset):
    return (q.shape[-1] ** -0.5 if scale is None else scale,
            k.shape[1] - q.shape[1] if q_offset is None else q_offset)


def attention_lse_reference(q, k, kv_valid, causal, scale=None, q_offset=None):
    """Plain version of the forward's lse: base-2 log-sum-exp [B, HQ, T]
    fp32 over the visible keys of each row, -inf where there are none."""
    scale, q_offset = _defaults(q, k, scale, q_offset)
    logits, mask = _scaled_logits(q, k, kv_valid, causal, scale, q_offset)
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.logsumexp(logits, dim=-1) * LOG2E


def _probs_and_ds(q, k, v, kv_valid, o, dout, lse, causal, scale, q_offset,
                  abs_terms=False):
    """The backward's P and dS [B, HQ, T, S] fp32 (fp64 for fp64 inputs):
    P = exp2(s * log2(e) -
    lse) on visible pairs (0 where lse = -inf), delta = rowsum(dO * O), dS =
    P (dO V^T - delta); with `abs_terms`, P (|dO| |V|^T + |delta|) in
    place of dS, the sum of |term| of each of its elements."""
    group = q.shape[2] // k.shape[2]
    logits, mask = _scaled_logits(q, k, kv_valid, causal, scale, q_offset)
    lse = torch.where(lse == float("-inf"), float("inf"), lse.to(logits.dtype))
    p = torch.where(mask, torch.exp2(logits * LOG2E - lse[..., None]),
                    torch.zeros((), device=q.device))
    do = _w(dout)
    vf = _w(v).repeat_interleave(group, dim=2)
    delta = (do * _w(o)).sum(-1).transpose(1, 2)                # [B, HQ, T]
    if abs_terms:
        return p, p * (torch.einsum("bthd,bshd->bhts", do.abs(), vf.abs())
                       + delta.abs()[..., None])
    return p, p * (torch.einsum("bthd,bshd->bhts", do, vf) - delta[..., None])


def attention_bwd_reference(q, k, v, kv_valid, o, dout, lse, causal,
                            scale=None, q_offset=None, abs_terms=False):
    """Plain version of `flash_attn_bwd`, the kernel's algorithm in fp32
    (fp64 for fp64 inputs; `_probs_and_ds`); returns (dq, dk, dv) in that
    type with dk/dv summed over
    each kv head's query-head group. Rows with lse = -inf give 0.
    With `abs_terms`, returns instead the sum of |term| of each gradient
    element (|dS| |K|, |dS| |Q|, P |dO|): the kernel rounds dS and P to
    bf16 before these products, so its error is within 2^-8 of that sum
    (plus the rounding of its bf16 output)."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    group = HQ // HK
    scale, q_offset = _defaults(q, k, scale, q_offset)
    p, ds = _probs_and_ds(q, k, v, kv_valid, o, dout, lse, causal, scale, q_offset)
    do = _w(dout)
    kf = _w(k).repeat_interleave(group, dim=2)
    if abs_terms:
        ds, kf, q, do = ds.abs(), kf.abs(), q.abs(), do.abs()
    dq = scale * torch.einsum("bhts,bshd->bthd", ds, kf)
    dk = scale * torch.einsum("bhts,bthd->bshd", ds, _w(q))
    dv = torch.einsum("bhts,bthd->bshd", p, do)
    return (dq, dk.view(B, S, HK, group, D).sum(3),
            dv.view(B, S, HK, group, D).sum(3))


def attention_bwd_bound(q, k, v, kv_valid, o, dout, lse, causal, ref, scale=None,
                        q_offset=None, u=2.0 ** -8, rms_slack=1e-5):
    """Per gradient element, the bf16 rounding bound of `flash_attn_bwd`'s
    (dq, dk, dv) about `ref` (`attention_bwd_reference` on the same
    inputs): 2^-8 (sum |terms| + |ref|) + 1e-5 rms(ref), with dS's terms
    P (|dO| |V| + |delta|) in place of |dS|. The kernel rounds P and dS to
    bf16 before its products and rounds its output; dS = P (dP - delta),
    where dP and delta nearly cancel, also carries their fp32 error, ~D
    2^-24 of those terms, which |dS| (`abs_terms=True`) does not count.
    `u` (one unit, or one a gradient) and `rms_slack` give the same bound's
    form for another arithmetic (the fp32 build's)."""
    B, T, HQ, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    scale, q_offset = _defaults(q, k, scale, q_offset)
    p, t = _probs_and_ds(q, k, v, kv_valid, o, dout, lse, causal, scale, q_offset,
                         abs_terms=True)
    kf = _w(k).abs().repeat_interleave(HQ // HK, dim=2)
    mags = (scale * torch.einsum("bhts,bshd->bthd", t, kf),
            (scale * torch.einsum("bhts,bthd->bshd", t, _w(q).abs()))
            .view(B, S, HK, HQ // HK, D).sum(3),
            torch.einsum("bhts,bthd->bshd", p, _w(dout).abs())
            .view(B, S, HK, HQ // HK, D).sum(3))
    units = u if isinstance(u, (tuple, list)) else (u, u, u)
    return [un * (m + r.abs()) + rms_slack * float(r.square().mean().sqrt())
            for un, m, r in zip(units, mags, ref)]


# The backward's tiles (query rows, keys) and the resident blocks an SM of
# the dK/dV kernel's capped instantiation, which exists at D <= 64 only (at
# 128 its 168-register cap would spill the dK / dV accumulators);
# `_bwd_lib` refuses a library that reports others
# (simlingo_flash_attn_bwd_geometry, with `_bwd_geometry`).
_BWD_TILE = (64, 64)
_DKDV_BLOCKS = 3
# The dQ kernel keeps one flag a key tile in shared memory, beside its tiles.
_BWD_MAX_KEY_TILES = 8192


def _bwd_geometry(d, dtype=torch.bfloat16):
    """What the backward library reports at built head dim d: (query rows,
    keys) a tile, the capped dK/dV build's blocks an SM (0: none), the
    query rows of one dK/dV register pass, and the dK/dV kernel's dynamic
    shared memory. bf16: S^T and dP^T are held for 32 rows at a time at d
    = 128, where dK and dV take 128 registers a thread; the shared memory
    holds K, V; Q and dO double-buffered, rows padded by 8; the warps' dS^T
    rows; lse and delta. fp32: no capped build, all 64 rows a pass (in
    register tiles of 4 keys x 8 or 4 rows a thread); K, V, Q and dO rows
    of d + 4 floats, P^T and dS^T [64][68], lse and delta."""
    bq, bkv = _BWD_TILE
    if dtype == torch.float32:
        return (bq, bkv, 0, bq, (4 * bkv * (d + 4) + 2 * bkv * (bq + 4) + 2 * bq) * 4)
    smem = (2 * bkv * (d + 8) + 4 * bq * (d + 8) + 4 * 16 * (bq + 8)) * 2 + 4 * bq * 4
    return (bq, bkv, _DKDV_BLOCKS if d <= 64 else 0, 64 if d <= 64 else 32, smem)


def _pair_live(qt, kt, T, causal, q_offset):
    """`pair_live` of csrc/flash_attn_bwd.cu for a key tile that holds a
    valid key: the first key of tile kt is visible to the last row of
    query tile qt (slot-order causality), or the attention is not causal."""
    bq, bkv = _BWD_TILE
    return not causal or kt * bkv <= q_offset + min(qt * bq + bq - 1, T - 1)


class BwdPlan(NamedTuple):
    n_qt: int                 # query tiles of _BWD_TILE[0] rows
    n_kt: int                 # key tiles of _BWD_TILE[1] keys
    ds_shape: tuple           # (B, HQ, n_kt, n_qt, keys, rows): the dS^T scratch
    ds_bytes: int
    written: frozenset        # (query tile, key tile) pairs the dK/dV kernel writes
    read: frozenset           # ... and those the dQ kernel reads
    head_dim: int             # the built head dim launched (`_instance_dim`)
    query_pass: int           # query rows of a dK/dV register pass
    dkdv_smem: int            # the dK/dV kernel's dynamic shared memory a block
    ds_dtype: torch.dtype = torch.bfloat16   # the scratch's: the operands' dtype


@functools.lru_cache(maxsize=64)
def _bwd_plan(B, T, S, HQ, HK, causal, q_offset, D=64, dtype=torch.bfloat16):
    """The scratch and the tile pairs of `flash_attn_bwd` at head dim D and
    the operands' dtype (the pairs do not depend on either; the scratch
    holds dS in that dtype, as JAX keeps dS in the operand dtype).

    The dK/dV kernel of key tile kt walks the query tiles from the first
    whose pair is live to the last, writing dS^T for each; the dQ kernel of
    query tile qt walks the key tiles whose pair is live. A key tile
    without a valid key (`_live_key_tiles`, the prep kernel's flags) drops
    out of both for its batch row, and its dK, dV are 0. The scratch holds
    one key-major tile [keys][rows] a pair, contiguous, in the order [B,
    HQ, key tile, query tile]; a written tile is written whole (keys past S
    and rows past T as 0)."""
    bq, bkv = _BWD_TILE
    n_qt, n_kt = -(-T // bq), -(-S // bkv)
    written = set()
    for kt in range(n_kt):
        qt_lo = 0
        while qt_lo < n_qt and not _pair_live(qt_lo, kt, T, causal, q_offset):
            qt_lo += 1
        written.update((qt, kt) for qt in range(qt_lo, n_qt))
    read = {(qt, kt) for qt in range(n_qt) for kt in range(n_kt)
            if _pair_live(qt, kt, T, causal, q_offset)}
    shape = (B, HQ, n_kt, n_qt, bkv, bq)
    d = _instance_dim(D)
    _, _, _, query_pass, smem = _bwd_geometry(d, dtype)
    elem = 4 if dtype == torch.float32 else 2
    return BwdPlan(n_qt, n_kt, shape, elem * B * HQ * n_kt * bkv * n_qt * bq,
                   frozenset(written), frozenset(read), d, query_pass, smem, dtype)


def _dkdv_blocks(B, S, HK, sms, D=64, dtype=torch.bfloat16):
    """The dK/dV kernel's instantiation: _DKDV_BLOCKS resident blocks an SM
    (registers capped) where its grid of (key tile, kv head, batch) blocks
    fills that many on every SM (the ViT's 3264) and head dim D has that
    build (bf16, D <= 64), else 1: ptxas's own register count (2 blocks an
    SM at D = 64: the LLM's 156 blocks fill fewer)."""
    blocks = B * HK * -(-S // _BWD_TILE[1])
    capped = _bwd_geometry(_instance_dim(D), dtype)[2]
    return capped if capped and blocks >= capped * sms else 1


def _live_key_tiles(kv_valid, B, S, device=None):
    """[B, n_kt] bool: the key tiles that hold a valid key (all of them
    without kv_valid), as the prep kernel flags them."""
    n_kt, bkv = -(-S // _BWD_TILE[1]), _BWD_TILE[1]
    if kv_valid is None:
        return torch.ones(B, n_kt, dtype=torch.bool, device=device)
    v = torch.zeros(B, n_kt * bkv, dtype=torch.bool, device=kv_valid.device)
    v[:, :S] = kv_valid.bool().expand(B, S)
    return v.view(B, n_kt, bkv).any(-1)


def _pair_mask(pairs, plan, live):
    """[B, 1, n_kt, n_qt, 1, 1] bool, broadcast against the scratch: the
    tiles of `pairs` with a live key tile."""
    tiles = torch.zeros(plan.n_kt, plan.n_qt, dtype=torch.bool)
    for qt, kt in pairs:
        tiles[kt, qt] = True
    tiles = tiles.to(live.device)[None] & live[:, :, None]          # [B, n_kt, n_qt]
    return tiles[:, None, :, :, None, None]


def _ds_matrix(ds):
    """The scratch's tiles [B, HQ, n_kt, n_qt, keys, rows] as one key-major
    matrix [B, HQ, S_pad, T_pad]."""
    B, HQ, n_kt, n_qt, bkv, bq = ds.shape
    return ds.permute(0, 1, 2, 4, 3, 5).reshape(B, HQ, n_kt * bkv, n_qt * bq)


def attention_ds_reference(q, k, v, kv_valid, o, dout, lse, causal,
                           scale=None, q_offset=None, abs_terms=False):
    """Plain first pass of `flash_attn_bwd`: dS^T fp32 in the scratch
    layout its dK/dV kernel writes (`_bwd_plan`: key-major tiles), 0 past S
    and T (the bf16 kernel rounds it to bf16; the fp32 one keeps it). With
    `abs_terms`, the sum of
    |term| of each element instead (`_probs_and_ds`)."""
    B, T, HQ, _ = q.shape
    _, S, HK, _ = k.shape
    scale, q_offset = _defaults(q, k, scale, q_offset)
    _, ds = _probs_and_ds(q, k, v, kv_valid, o, dout, lse, causal, scale, q_offset,
                          abs_terms)
    plan = _bwd_plan(B, T, S, HQ, HK, bool(causal), q_offset)
    bq, bkv = _BWD_TILE
    out = torch.zeros((B, HQ, plan.n_kt * bkv, plan.n_qt * bq), dtype=ds.dtype,
                      device=q.device)
    out[:, :, :S, :T] = ds.transpose(2, 3)
    return out.view(B, HQ, plan.n_kt, bkv, plan.n_qt, bq).permute(0, 1, 2, 4, 3, 5).contiguous()


def attention_dq_from_ds_reference(ds, k, kv_valid, T, causal, scale=None,
                                   q_offset=None, abs_terms=False):
    """Plain second pass of `flash_attn_bwd`: dq [B, T, HQ, D] fp32 =
    scale sum_s dS[b, h, t, s] K[b, s, h // group] from the dS^T scratch
    (`_bwd_plan`), reading only the tile pairs the dQ kernel reads
    (whatever lies elsewhere, NaN included, never reaches dq).
    With `abs_terms`, the sum of |term| of each element."""
    B, HQ = ds.shape[:2]
    _, S, HK, D = k.shape
    scale = D ** -0.5 if scale is None else scale
    q_offset = S - T if q_offset is None else q_offset
    plan = _bwd_plan(B, T, S, HQ, HK, bool(causal), q_offset)
    read = _pair_mask(plan.read, plan, _live_key_tiles(kv_valid, B, S, ds.device))
    dst = _ds_matrix(torch.where(read, _w(ds), torch.zeros((), device=ds.device)))
    dst = dst[:, :, :S, :T]
    kf = _w(k).repeat_interleave(HQ // HK, dim=2)
    if abs_terms:
        dst, kf = dst.abs(), kf.abs()
    return scale * torch.einsum("bhst,bshd->bthd", dst, kf)


def _aligned16(name, x):
    if x.data_ptr() % 16 or any(s % (16 // x.element_size()) for s in x.stride()[:3]):
        raise ValueError(f"flash_attn_bwd: {name} rows must be 16-byte aligned")


def flash_attn_bwd(q, k, v, kv_valid, o, dout, lse, causal=True, scale=None,
                   q_offset=None, return_ds=False, out_dtype=None):
    """Launch the CUDA backward: (dq [B,T,HQ,D], dk, dv [B,S,HK,D]) in
    `out_dtype` (None: the operands' dtype). bf16 operands: bf16
    gradients, or fp32 for partials that a caller sums before it rounds
    (the ring of `parallel/sequence.py`: the same kernels, storing their
    fp32 accumulators unrounded). fp32 operands: the fp32 build, fp32
    gradients. q/k/v may be strided views as in the forward; o and dout are
    made contiguous; lse is the forward's [B, HQ, T] fp32. With
    `return_ds`, also the dS^T scratch in the operands' dtype (`_bwd_plan`;
    only the pairs it writes for live key tiles hold values)."""
    B, T, HQ, D = q.shape
    _, S, HK, _ = k.shape
    d = _instance_dim(D)
    dtype = _check_dtypes("flash_attn_bwd", (("q", q), ("k", k), ("v", v), ("o", o),
                                             ("dout", dout)))
    fp32 = dtype == torch.float32
    out_dtype = dtype if out_dtype is None else out_dtype
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_bthd(name, x, D)
    if k.shape != v.shape or k.shape[0] != B or HQ % HK or o.shape != q.shape \
            or dout.shape != q.shape or lse.shape != (B, HQ, T):
        raise ValueError(f"flash_attn_bwd: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, o {tuple(o.shape)}, dout "
                         f"{tuple(dout.shape)}, lse {tuple(lse.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attn_bwd takes an fp32 lse, got {lse.dtype}")
    if out_dtype not in (torch.bfloat16, torch.float32) or (fp32 and out_dtype != dtype):
        raise TypeError(f"flash_attn_bwd writes bf16 or fp32 gradients of bf16 operands, "
                        f"fp32 ones of fp32 operands; not {out_dtype} of {dtype}")
    scale, q_offset = _defaults(q, k, scale, q_offset)
    q, k, v = (_pad_d(x, d) for x in (q, k, v))
    for name, x in (("q", q), ("k", k), ("v", v)):
        _aligned16(name, x)
    o, dout = (_build.aligned16(_pad_d(x, d)) for x in (o, dout))
    lse = lse.contiguous()
    valid_ptr = None
    if kv_valid is not None:
        kv_valid = kv_valid.to(device=q.device, dtype=torch.uint8)
        kv_valid = kv_valid.expand(B, S).contiguous()
        valid_ptr = kv_valid.data_ptr()
    plan = _bwd_plan(B, T, S, HQ, HK, bool(causal), int(q_offset), D, dtype)
    if plan.n_kt > _BWD_MAX_KEY_TILES:
        raise ValueError(f"flash_attn_bwd kernel takes at most "
                         f"{_BWD_MAX_KEY_TILES * _BWD_TILE[1]} keys, got {S}")
    dq = torch.empty((B, T, HQ, d), dtype=out_dtype, device=q.device)
    dk = torch.empty((B, S, HK, d), dtype=out_dtype, device=q.device)
    dv = torch.empty((B, S, HK, d), dtype=out_dtype, device=q.device)
    ds = torch.empty(plan.ds_shape, dtype=dtype, device=q.device)
    if B * T * S == 0:
        grads = tuple(g.zero_()[..., :D] for g in (dq, dk, dv))
        return (*grads, ds) if return_ds else grads
    delta = torch.empty((B, HQ, T), dtype=torch.float32, device=q.device)
    live = (torch.empty((B, plan.n_kt), dtype=torch.uint8, device=q.device)
            if kv_valid is not None else None)
    rc = _bwd_lib().simlingo_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_ptr, o.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        live.data_ptr() if live is not None else None, ds.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, T, S, HQ, HK,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        int(bool(causal)), int(q_offset), ctypes.c_float(float(scale)),
        _dkdv_blocks(B, S, HK, _build.sm_count(q.device.index or 0), D, dtype), d,
        int(out_dtype == torch.float32), int(fp32),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attn_bwd")
    flash_attn_bwd.launches += 1
    flash_attn_bwd.launches_by_dim[d] = flash_attn_bwd.launches_by_dim.get(d, 0) + 1
    if fp32:
        flash_attn_bwd.launches_fp32 += 1
    if d != D:
        dq, dk, dv = (g[..., :D] for g in (dq, dk, dv))
    return (dq, dk, dv, ds) if return_ds else (dq, dk, dv)


flash_attn_bwd.launches = 0
flash_attn_bwd.launches_by_dim = {}      # built head dim -> launches
flash_attn_bwd.launches_fp32 = 0         # of them, the fp32 build's


def _bwd_lib():
    lib = _build.load("flash_attn_bwd")
    fn = lib.simlingo_flash_attn_bwd
    if fn.argtypes is None:
        for d in HEAD_DIMS:
            for dtype in DTYPES:
                geometry = (ctypes.c_int * 5)()
                rc = lib.simlingo_flash_attn_bwd_geometry(d, int(dtype == torch.float32),
                                                          geometry)
                if rc != 0 or tuple(geometry) != _bwd_geometry(d, dtype):
                    raise RuntimeError(f"flash_attn_bwd: the library's {dtype} geometry at "
                                       f"D = {d} {tuple(geometry)} (rc {rc}) differs from "
                                       f"the plan's {_bwd_geometry(d, dtype)}")
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_longlong] * 9
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


class _AttentionTrain(torch.autograd.Function):
    """Flash attention whose forward saves (q, k, v, o, lse) and whose
    backward recomputes P from the lse -- the JAX `_flash_gqa` /
    `_flash_lm` custom VJPs."""

    @staticmethod
    def forward(ctx, q, k, v, kv_valid, causal, scale, q_offset):
        if q.device.type == "cpu":
            out = attention_reference(q, k, v, kv_valid, causal, scale, q_offset)
            lse = attention_lse_reference(q, k, kv_valid, causal, scale, q_offset)
        else:
            out, lse = flash_attn_fwd(q, k, v, kv_valid, causal, scale,
                                      q_offset, return_lse=True)
        ctx.save_for_backward(q, k, v, kv_valid, out, lse)
        ctx.args = (causal, scale, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_valid, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            grads = attention_bwd_reference(q, k, v, kv_valid, out, dout, lse,
                                            *ctx.args)
            grads = [g.to(x.dtype) for g, x in zip(grads, (q, k, v))]
        else:
            grads = flash_attn_bwd(q, k, v, kv_valid, out, dout, lse, *ctx.args)
        return (*grads, None, None, None, None)


def attention_train(q, k, v, kv_valid=None, causal=True, scale=None,
                    q_offset=None):
    """`attention` with a backward: [B, T, HQ, D] x [B, S, HK, D]."""
    return _AttentionTrain.apply(q, k, v, kv_valid, causal, scale, q_offset)


def attention_autograd(q, k, v, kv_valid=None, causal=True, scale=None,
                       q_offset=None):
    """`attention_train` when autograd records through q/k/v (training),
    else the serving `attention` (no lse written, nothing saved). Under
    sequence parallelism, a self-attention call of the LLM's slab without
    q_offset runs as the ring instead (`parallel/sequence.py`; JAX's
    dispatch, `simlingo_tpu/kernels/flash_attention.py:1329-1345`)."""
    from simlingo_tpu_torch.parallel import sequence
    if sequence.routes(q, k, q_offset):
        return sequence.ring_attention(q, k, v, kv_valid, causal, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return attention_train(q, k, v, kv_valid, causal, scale, q_offset)
    return attention(q, k, v, kv_valid, causal, scale, q_offset)
