"""A plain PyTorch model of the split-fp32 tile product, for the tests.

`csrc/f32_tc_tile.cuh` computes fp32 products on the tensor cores: each
fp32 operand element a is cut into big = rna_tf32(a) and small =
rna_tf32(a - big), and a step of the reduction sums small_a big_b +
big_a small_b + big_a big_b (the two products against int8 codes, which are
exact in TF32) into a step accumulator that is added, in fp32, to the
tile's. This module repeats that arithmetic in PyTorch: every product of
two TF32 values is exact in fp32, so the model differs from the kernel only
in the order of its fp32 sums. The kernels' wrappers do not use it (on the
CPU they run their plain versions); the CPU tests hold it to fp64 within
the card's fp32 bounds and to JAX's kernels, and chip_smoke.py rounds the
operands of its TF32 plain versions with `tf32_round`.
"""

from __future__ import annotations

import torch

STEP = 32            # the tile's k-step (csrc/f32_tc_tile.cuh BK)
TF32_DROP = 13       # mantissa bits TF32 drops of fp32's 23


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 x rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero (`cvt.rna.tf32.f32`): the low 13 mantissa bits cleared after
    adding half of their range to the magnitude. inf stays inf."""
    bits = x.float().contiguous().view(torch.int32)
    half = 1 << (TF32_DROP - 1)
    return ((bits + half) & -(1 << TF32_DROP)).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(big, small), both TF32, with big + small = x within 2^-22 |x|."""
    big = tf32_round(x)
    return big, tf32_round(x.float() - big)


def split_product(a: torch.Tensor, b: torch.Tensor, exact_b: bool = False,
                  step: int = STEP) -> torch.Tensor:
    """a [M, K] b [N, K]^T in fp32 as the split tile sums it: per k-step,
    small_a big_b + big_a small_b + big_a big_b (without the middle term
    where `exact_b`: b's values are exact in TF32, int8 codes) into a step
    sum, added to the running fp32 sum."""
    ab, as_ = split_tf32(a)
    if exact_b:
        bb = b.float()
        if not torch.equal(tf32_round(bb), bb):
            raise ValueError("split_product: exact_b, but b is not exact in TF32")
        bs = None
    else:
        bb, bs = split_tf32(b)
    acc = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32, device=a.device)
    for k in range(0, a.shape[1], step):
        sl = slice(k, k + step)
        part = as_[:, sl] @ bb[:, sl].t()
        if bs is not None:
            part = part + ab[:, sl] @ bs[:, sl].t()
        acc = acc + (part + ab[:, sl] @ bb[:, sl].t())
    return acc


def int8_forward_model(x, w_q, scale):
    """The fp32 int8 forward (gemm_split_kernel): y = (x w_q^T, two split
    products a step) times the scale widened to fp32."""
    return split_product(x.float(), w_q.float(), exact_b=True) * scale.float()


def int8_dx_model(g, w_q, scale):
    """The fp32 int8 activation gradient (dx_split_kernel): gs = g * scale
    rounded once in fp32 (JAX's gs), then dx = gs w_q, two split products
    a step (gs split, the codes exact)."""
    gs = g.float() * scale.float()
    return split_product(gs, w_q.float().t(), exact_b=True)


def _merge(M, L, m, l):
    """ce_fwd_finalize_kernel's merge of a tile's (max, sum) into a row's:
    an all-masked tile (m = -inf) is skipped."""
    keep = m == float("-inf")
    up = m > M
    L_up = L * torch.exp(M - m) + l
    L_dn = L + l * torch.exp(m - M)
    return (torch.where(keep, M, torch.where(up, m, M)),
            torch.where(keep, L, torch.where(up, L_up, L_dn)))


def ce_fwd_model(h2, labels, w, tile=128, slices=8):
    """The fp32 fused-CE forward (ce_fwd_split_kernel + ce_fwd_finalize_kernel):
    (logz [N], ce [N]). The logits by the split tile; per `tile`-column
    tile the max over the columns below V and the sum of exp(logit - max);
    the tiles merged as the finalize merges them (tile j into slice j %
    `slices` in order, then slices 1.. into slice 0); logz = max + log sum,
    ce = logz - the label's logit (0 for a label outside [0, V))."""
    N, V = h2.shape[0], w.shape[0]
    logits = split_product(h2.float(), w.float())
    inf = torch.full((N,), float("-inf"), device=h2.device)
    zero = torch.zeros(N, device=h2.device)
    acc = [(inf, zero) for _ in range(slices)]
    for j, v0 in enumerate(range(0, V, tile)):
        t = logits[:, v0:v0 + tile]
        m = t.max(dim=1).values
        l = torch.exp(t - m[:, None]).sum(dim=1)
        acc[j % slices] = _merge(*acc[j % slices], m, l)
    M, L = acc[0]
    for Mi, Li in acc[1:]:
        M, L = _merge(M, L, Mi, Li)
    logz = M + torch.log(L)
    labels = labels.long()
    ok = (labels >= 0) & (labels < V)
    gold = logits.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    return logz, logz - torch.where(ok, gold, zero)


def ce_bwd_model(h2, labels, w, logz, g, segments, compute_dw=True):
    """The fp32 fused-CE backward's three passes (ce_dlogits_split_kernel,
    ce_dh_split_kernel + f32_reduce_kernel, ce_dw_split_kernel): (dl [N,
    vpad], dh [N, H], dW [V, H] or None). `segments` are the plan's [c0,
    c1) vocabulary columns of dh's partials, summed in order."""
    N, V = h2.shape[0], w.shape[0]
    vpad = segments[-1][1]
    logits = split_product(h2, w)
    onehot = labels.long()[:, None] == torch.arange(V, device=h2.device)[None]
    dl = torch.zeros(N, vpad, dtype=torch.float32, device=h2.device)
    dl[:, :V] = (torch.exp(logits - logz.float()[:, None]) - onehot.float()) * g.float()[:, None]
    wt = torch.zeros(vpad, w.shape[1], dtype=torch.float32, device=w.device)
    wt[:V] = w.float()
    dh = None
    for c0, c1 in segments:
        part = split_product(dl[:, c0:c1], wt[c0:c1].t())
        dh = part if dh is None else dh + part
    dw = split_product(dl[:, :V].t(), h2.float().t()) if compute_dw else None
    return dl, dh, dw
