"""Sequence parallelism: ring attention over the mesh's sp group.

Counterpart of `simlingo_tpu/parallel/sequence.py`. The LLM's sequence is
cut into sp contiguous slabs: rank i of the sp group holds positions
[i * T / sp, (i + 1) * T / sp) of every row (`models/simlingo.py` cuts
them). Every op of a decoder layer but attention works on its slab alone;
attention runs as a ring: each rank keeps its queries and passes its
chunk of keys, values and key validity to the next rank, sp - 1 times,
folding in one chunk a step. Under causal attention the chunk of a later
rank is fully masked and skipped, as JAX's `lax.cond` skips it (:173-177);
the pass still runs, so the ring stays full.

  * Forward (`_Ring`): on a CUDA tensor each step launches the hand
    attention kernel with its base-2 log-sum-exp
    (`flash_attn_fwd(..., return_lse=True)`): the diagonal chunk causal,
    an earlier rank's not. The chunks' outputs merge in fp32 by their lse;
    a row that sees no valid key has lse -inf and output 0, as
    `attention_reference` gives it, and the merge of two -inf makes no
    NaN. On a CPU tensor the plain version runs: JAX's `_chunk_update`
    recurrence (:107-136) in fp32 over the same chunks.
  * Backward: per chunk, `chunk_grads`: `flash_attn_bwd` (CPU:
    `attention_bwd_reference`) against the ring's global output and lse,
    so delta and P are the whole row's. On a CUDA tensor the kernels hand
    back fp32 partials (`out_dtype=torch.float32`, unrounded), so each
    gradient is rounded once, after the sum, as a single kernel rounds its
    own; JAX differentiates its fp32 recurrence. dQ accumulates in fp32 on
    its rank; each chunk's dK / dV accumulate in fp32 as they travel the
    ring, which brings them back to the chunk's owner after sp passes.

`enable(mesh)` (the trainer, or the `sequence_parallel` context in tests)
makes the context; `kernels/flash_attention.attention_autograd` routes a
call to `ring_attention` when the context is set, the call is inside the
LLM's slab region (`slab_region`, entered by each decoder layer of
`qwen2.forward` given a slab, so that a recompute in the backward, by
remat or the pipeline, routes too), it is self-attention (T == S) and it
has no q_offset: KV-cached
prefill and decode never route. JAX routes on the global T % sp == 0;
the port makes that check where the sequence is cut (`slab_of`), and a
sequence that does not divide runs unsharded on every sp rank, which the
trainer refuses after its first step (`trace_count` 0). Differences from
JAX by design: the port shards the sequence in the LLM only (a ViT whose
token count divides sp runs unsharded on every sp rank, which gives JAX's
numbers; the 1025-token ViT never routes in JAX either), and it has no
`SIMLINGO_SP_ATTN` escape hatch (JAX :1336-1340), which computes
attention on a replicated sequence.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from simlingo_tpu_torch.kernels import flash_attention as FA

NEG_INF = -1e30

# Set by the trainer (or `sequence_parallel`) before the step runs; "slab"
# is set while the LLM runs on a slab (`slab_region`)
_STATE = {"mesh": None, "axis": None, "trace_count": 0, "slab": False}


def trace_count() -> int:
    """How many attention calls ran as a ring since enable() (lets callers
    assert sp engaged rather than falling back on an indivisible
    sequence)."""
    return _STATE["trace_count"]


def enable(mesh, axis: str = "sp") -> None:
    """Route eligible attention calls through the ring over `axis`; a no-op
    (disable) where the mesh's axis has size 1."""
    if mesh.shape.get(axis, 1) > 1:
        _STATE.update(mesh=mesh, axis=axis, trace_count=0, slab=False)
    else:
        disable()


def disable() -> None:
    _STATE["mesh"] = _STATE["axis"] = None
    _STATE["slab"] = False


def active_axis():
    """(mesh, axis, size) when sequence parallelism is enabled, else None."""
    mesh, axis = _STATE["mesh"], _STATE["axis"]
    if mesh is None:
        return None
    return mesh, axis, mesh.shape[axis]


@contextlib.contextmanager
def sequence_parallel(mesh, axis: str = "sp"):
    prev = dict(_STATE)
    enable(mesh, axis)
    try:
        yield
    finally:
        _STATE.update(prev)


def slab_of(T: int) -> Optional[Tuple[int, int]]:
    """(this rank's index, sp) where the context is set and a sequence of T
    positions divides over sp, else None."""
    st = active_axis()
    if st is None or T % st[2]:
        return None
    comm = st[0].comm[st[1]]
    return comm.rank, comm.size


@contextlib.contextmanager
def slab_region():
    """The LLM's forward on a slab: attention calls inside may route."""
    prev = _STATE["slab"]
    _STATE["slab"] = True
    try:
        yield
    finally:
        _STATE["slab"] = prev


def routes(q: torch.Tensor, k: torch.Tensor, q_offset) -> bool:
    """Whether `attention_autograd` sends this call to the ring."""
    return (_STATE["mesh"] is not None and _STATE["slab"] and q_offset is None
            and q.dim() == 4 and q.shape[1] == k.shape[1])


# ---------------------------------------------------------------------------
# One chunk: the kernels on CUDA tensors, the plain recurrence on CPU ones
# ---------------------------------------------------------------------------

def _chunk_update(acc, m, l, q32, k, v, mask):
    """JAX's `_chunk_update` (:107-136): fold one chunk into the fp32
    online-softmax state. q32 [B, HQ, Tl, D] (scale folded in), k / v [B,
    S, HK, D], mask [B, 1, Tl, S]; natural-log m, l."""
    B, HQ, Tl, D = q32.shape
    HK = k.shape[2]
    g = HQ // HK
    qg = q32.reshape(B, HK, g, Tl, D)
    logits = torch.einsum("bkgtd,bskd->bkgts", qg, k.float()).reshape(B, HQ, Tl, k.shape[1])
    logits = torch.where(mask, logits, torch.full((), NEG_INF))
    m_new = torch.maximum(m, logits.amax(dim=-1))
    p = torch.where(mask, torch.exp(logits - m_new[..., None]), torch.zeros(()))
    corr = torch.exp(m - m_new)
    pv = torch.einsum("bkgts,bskd->bkgtd", p.reshape(B, HK, g, Tl, -1),
                      v.float()).reshape(B, HQ, Tl, D)
    return acc * corr[..., None] + pv, m_new, l * corr + p.sum(dim=-1)


def _mask(valid, Tl, diag):
    """[B, 1, Tl, S] visibility of a chunk: its valid keys, and under the
    causal diagonal the keys at or before each query."""
    mask = valid.bool()[:, None, None, :]
    if diag:
        t = torch.arange(Tl, device=valid.device)
        mask = mask & (t[None, :] <= t[:, None])[None, None]
    return mask


def _merge(o, lse, o_c, lse_c):
    """Two partial attentions [B, Tl, HQ, D] fp32 with base-2 lse [B, HQ,
    Tl] -> their union. A row -inf in both stays -inf with output 0."""
    m = torch.maximum(lse, lse_c)
    m0 = torch.where(m == float("-inf"), torch.zeros((), device=m.device), m)
    w, w_c = torch.exp2(lse - m0), torch.exp2(lse_c - m0)
    s = w + w_c
    seen = s > 0
    new_lse = torch.where(seen, m0 + torch.log2(torch.where(seen, s, 1.0)),
                          torch.full((), float("-inf"), device=m.device))
    scale = torch.where(seen, 1.0 / torch.where(seen, s, 1.0), 0.0)
    t = lambda x: (x * scale).transpose(1, 2)[..., None]    # [B, Tl, HQ, 1]
    return o * t(w) + o_c.float() * t(w_c), new_lse


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------

def chunk_grads(q, kc, vc, vac, o, dout, lse, diag, scale=None):
    """One chunk's backward against the ring's global o / lse: (dq, dk, dv)
    partials in fp32, unrounded (CUDA: `flash_attn_bwd(..., out_dtype=
    torch.float32)`; CPU: `attention_bwd_reference`). The ring sums them
    and rounds each gradient once."""
    if q.is_cuda:
        return FA.flash_attn_bwd(q, kc, vc, vac, o, dout, lse, diag, scale, None,
                                 out_dtype=torch.float32)
    return [g.float() for g in FA.attention_bwd_reference(q, kc, vc, vac, o, dout, lse, diag,
                                                          scale, None)]


def _pack(*xs):
    """One flat buffer of xs (a single pass of the ring), and their shapes."""
    dt = xs[0].dtype
    return torch.cat([x.reshape(-1).to(dt) for x in xs]), [x.shape for x in xs]


def _unpack(buf, shapes, dtypes):
    out, off = [], 0
    for shape, dt in zip(shapes, dtypes):
        n = 1
        for d in shape:
            n *= d
        out.append(buf[off:off + n].view(shape).to(dt))
        off += n
    return out


class _Ring(torch.autograd.Function):
    """Ring attention of this rank's query slab against every rank's key
    slab (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, valid, causal, scale, comm):
        n, i = comm.size, comm.rank
        B, Tl, HQ, D = q.shape
        cuda = q.device.type == "cuda"
        kc, vc, vac = k, v, valid
        if cuda:
            o = torch.zeros((B, Tl, HQ, D), dtype=torch.float32, device=q.device)
            lse = torch.full((B, HQ, Tl), float("-inf"), device=q.device)
        else:
            q32 = q.float().transpose(1, 2) * scale
            acc = torch.zeros((B, HQ, Tl, D))
            m = torch.full((B, HQ, Tl), NEG_INF)
            l = torch.zeros((B, HQ, Tl))
        for s in range(n):
            src = (i - s) % n
            if not (causal and src > i):
                diag = causal and src == i
                if cuda:
                    o_c, lse_c = FA.flash_attn_fwd(q, kc, vc, vac, diag, scale, None,
                                                   return_lse=True)
                    o, lse = _merge(o, lse, o_c, lse_c)
                else:
                    acc, m, l = _chunk_update(acc, m, l, q32, kc, vc, _mask(vac, Tl, diag))
            if s < n - 1:
                buf, shapes = _pack(kc, vc, vac)
                kc, vc, vac = _unpack(comm.sendrecv(buf, (i + 1) % n, (i - 1) % n), shapes,
                                      (k.dtype, v.dtype, valid.dtype))
        if not cuda:
            seen = l > 0
            o = torch.where(seen[..., None], acc / torch.clamp(l, min=1e-30)[..., None],
                            0.0).transpose(1, 2)
            lse = torch.where(seen, (m + torch.log(torch.where(seen, l, 1.0))) * FA.LOG2E,
                              float("-inf"))
        o = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, valid, o, lse)
        ctx.args = (causal, scale, comm)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, valid, o, lse = ctx.saved_tensors
        causal, scale, comm = ctx.args
        n, i = comm.size, comm.rank
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        kc, vc, vac = k, v, valid
        dout = dout.contiguous()
        for s in range(n):
            src = (i - s) % n
            if not (causal and src > i):
                g = chunk_grads(q, kc, vc, vac, o, dout, lse, causal and src == i, scale)
                dq += g[0]
                dk += g[1]
                dv += g[2]
            # the chunk and its dK / dV partials move on; the last pass
            # brings the partials home
            if s < n - 1:
                buf, shapes = _pack(dk, dv, kc, vc, vac)
                dk, dv, kc, vc, vac = _unpack(
                    comm.sendrecv(buf, (i + 1) % n, (i - 1) % n), shapes,
                    (torch.float32, torch.float32, k.dtype, v.dtype, valid.dtype))
            else:
                buf, shapes = _pack(dk, dv)
                dk, dv = _unpack(comm.sendrecv(buf, (i + 1) % n, (i - 1) % n), shapes,
                                 (torch.float32, torch.float32))
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None, causal: bool = True,
                   scale: Optional[float] = None, comm=None) -> torch.Tensor:
    """Self-attention of this rank's slabs q [B, Tl, HQ, D], k / v [B, Tl,
    HK, D], kv_valid [B, Tl], over the sp group `comm` (default: the
    context's): the rank's rows of `attention_reference` on the whole
    sequence."""
    if comm is None:
        st = active_axis()
        if st is None:
            raise RuntimeError("ring_attention: no sp context; pass comm")
        comm = st[0].comm[st[1]]
    B, Tl = q.shape[:2]
    if k.shape[1] != Tl or v.shape[1] != Tl:
        raise ValueError("ring_attention: self-attention only (T == S)")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if kv_valid is None:
        kv_valid = torch.ones((B, Tl), dtype=torch.uint8, device=q.device)
    valid = kv_valid.to(torch.uint8).expand(B, Tl).contiguous()
    _STATE["trace_count"] += 1
    return _Ring.apply(q, k, v, valid, causal, float(scale), comm)
