"""The CUDA kernels of simlingo_tpu_torch against their plain versions.

Marked `cuda`: they skip without an NVIDIA GPU. This file imports no JAX,
so it also runs on a GPU machine without it (the tests/ conftest imports
JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

bf16 kernels against the plain fp32 math on the same bf16 inputs, at
rtol = 2e-2 and an atol of 2e-2 for int8_matmul (outputs of rms ~0.6) and
2e-3 for attention over 77-129 keys (outputs of rms ~0.1); 4e-3 where causal
rows see as few as one key: the kernel rounds each probability to bf16
(2^-9 relative) before it weights a value of |v| up to ~4. The backward
kernel's gradients are held at |err| <= 3e-2 rms(ref) + 2e-2 |ref|: it
rounds P and dS to bf16 before the products, and each gradient sums
over up to T terms. The dropout kernel equals its plain version bit for
bit. The norm kernels' bf16 outputs (y, dx) are held to one bf16 spacing
of the plain version's (2^-7 |ref| + 1e-5 rms): both round the same fp32
math, summed in another order; their parameter gradients to 2^-7 |ref|
plus 1e-5 of the sum of |terms| over the rows. The fused CE's ce to
2e-3 + 1e-5 |ref| (fp32 accumulation over H products), its dh and dW to
2^-7 (sum |terms| + |ref|): kernel and plain version round dlogits to
bf16 at the same point, so a flip is at most one bf16 spacing.
"""

import pytest
import torch

from simlingo_tpu_torch.kernels import dropout as TD
from simlingo_tpu_torch.kernels import flash_attention as TFA
from simlingo_tpu_torch.kernels import fused_ce as TCE
from simlingo_tpu_torch.kernels import layernorm as TLN
from simlingo_tpu_torch.kernels import quantized_matmul as TQM


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,HQ,HK,causal,q_offset", [
    (70, 90, 14, 2, True, 0), (1, 90, 14, 2, True, 60),
    (129, 129, 4, 4, False, None)])
def test_flash_attn_fwd_kernel_matches_plain(gpu, T, S, HQ, HK, causal, q_offset):
    g = torch.Generator(device=gpu).manual_seed(0)
    q = torch.randn(2, T, HQ, 64, generator=g, device=gpu).bfloat16()
    k = torch.randn(2, S, HK, 64, generator=g, device=gpu).bfloat16()
    v = torch.randn(2, S, HK, 64, generator=g, device=gpu).bfloat16()
    valid = torch.ones(2, S, dtype=torch.bool, device=gpu)
    valid[0, :9] = False
    before = TFA.flash_attn_fwd.launches
    out = TFA.attention(q, k, v, valid, causal=causal, q_offset=q_offset)
    assert TFA.flash_attn_fwd.launches == before + 1
    ref = TFA.attention_reference(q.float(), k.float(), v.float(), valid,
                                  causal, None, q_offset)
    torch.testing.assert_close(out.float(), ref, atol=4e-3 if causal else 2e-3,
                               rtol=2e-2)


@pytest.mark.cuda
def test_flash_attn_fwd_reads_strided_head_views(gpu):
    """ViT layout: q/k/v are [B, T, H, 64] views of one [B, T, 3*H*64]
    projection, read in place."""
    g = torch.Generator(device=gpu).manual_seed(2)
    qkv = torch.randn(2, 77, 3 * 4 * 64, generator=g, device=gpu).bfloat16()
    q, k, v = (qkv[..., i * 256:(i + 1) * 256].view(2, 77, 4, 64) for i in range(3))
    out = TFA.attention(q, k, v, None, causal=False)
    ref = TFA.attention_reference(q.float(), k.float(), v.float(), None, False)
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=2e-2)


@pytest.mark.cuda
# M = 1: the GEMV; 2..48: the 16-row tiles; above: the 64-row tiles
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 16, 30, 48, 49, 200])
def test_int8_matmul_kernel_matches_plain(gpu, M):
    g = torch.Generator(device=gpu).manual_seed(1)
    x = torch.randn(M, 896, generator=g, device=gpu).bfloat16()
    w_q, scale = TQM.quantize_weight(
        torch.randn(300, 896, generator=g, device=gpu) * 0.02)
    before = TQM.int8_matmul.launches
    out = TQM.int8_matmul(x, w_q, scale)
    assert TQM.int8_matmul.launches == before + 1
    ref = TQM.int8_matmul_reference(x.float(), w_q, scale)
    torch.testing.assert_close(out.float(), ref, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(gpu):
    q = torch.randn(1, 4, 2, 32, device=gpu).bfloat16()
    with pytest.raises(ValueError, match="head_dim 64"):
        TFA.attention(q, q, q)
    x = torch.randn(2, 24, device=gpu).bfloat16()
    w_q, scale = TQM.quantize_weight(torch.randn(8, 24, device=gpu))
    with pytest.raises(ValueError, match="K % 16"):
        TQM.int8_matmul(x, w_q, scale)


def _close_to_rms(got, ref, name):
    ref = ref.float()
    rms = float(ref.square().mean().sqrt())
    bad = (got.float() - ref).abs() > 3e-2 * rms + 2e-2 * ref.abs()
    assert not bool(bad.any()), (name, float((got.float() - ref).abs().max()), rms)


@pytest.mark.cuda
@pytest.mark.parametrize("T,HQ,HK,causal,strided", [
    (150, 14, 2, True, False), (130, 4, 4, False, True), (64, 2, 1, True, False)])
def test_flash_attn_bwd_kernel_matches_plain(gpu, T, HQ, HK, causal, strided):
    g = torch.Generator(device=gpu).manual_seed(3)
    B, D = 2, 64
    if strided:       # ViT: heads are views of one [B, T, 3*H*D] projection
        qkv = torch.randn(B, T, 3 * HQ * D, generator=g, device=gpu).bfloat16()
        q, k, v = (qkv[..., i * HQ * D:(i + 1) * HQ * D].view(B, T, HQ, D)
                   for i in range(3))
        valid = None
    else:
        q = torch.randn(B, T, HQ, D, generator=g, device=gpu).bfloat16()
        k, v = (torch.randn(B, T, HK, D, generator=g, device=gpu).bfloat16()
                for _ in range(2))
        valid = torch.ones(B, T, dtype=torch.bool, device=gpu)
        valid[0, :7] = False                   # rows with no visible key
        valid[1, T - 40:] = False              # right padding: skipped key tiles
    dout = torch.randn(B, T, HQ, D, generator=g, device=gpu).bfloat16()
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, causal, None, None, return_lse=True)
    want_lse = TFA.attention_lse_reference(q.float(), k.float(), valid, causal)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-2, rtol=1e-3)
    before = TFA.flash_attn_bwd.launches
    got = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal)
    torch.cuda.synchronize()
    assert TFA.flash_attn_bwd.launches == before + 1
    ref = TFA.attention_bwd_reference(q.float(), k.float(), v.float(), valid,
                                      out.float(), dout.float(), want_lse, causal)
    for a, b, name in zip(got, ref, "qkv"):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _close_to_rms(a, b, name)
    if valid is not None and causal:           # rows 0..6 of sample 0 see nothing
        assert float(got[0][0, :7].abs().max()) == 0.0


@pytest.mark.cuda
def test_attention_train_launches_both_kernels(gpu):
    g = torch.Generator(device=gpu).manual_seed(4)
    q = torch.randn(1, 70, 4, 64, generator=g, device=gpu).bfloat16().requires_grad_(True)
    k = torch.randn(1, 70, 2, 64, generator=g, device=gpu).bfloat16().requires_grad_(True)
    v = torch.randn(1, 70, 2, 64, generator=g, device=gpu).bfloat16().requires_grad_(True)
    f0, b0 = TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches
    out = TFA.attention_autograd(q, k, v, None, causal=True)
    out.float().square().sum().backward()
    assert (TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches) == (f0 + 1, b0 + 1)
    assert all(x.grad is not None and torch.isfinite(x.grad).all() for x in (q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("numel,offset", [(6 * 798 * 896, 0), (1003, 0), (4099, 3)])
def test_dropout_kernel_bit_identical_to_plain(gpu, numel, offset):
    g = torch.Generator(device=gpu).manual_seed(5)
    x = torch.randn(numel + offset, generator=g, device=gpu).bfloat16()[offset:]
    seed = 0x1234_5678_9ABC_DEF0
    before = TD.dropout.launches
    out = TD.dropout(x, seed, 0.1)
    assert TD.dropout.launches == before + 1
    assert torch.equal(out, TD.dropout_plain(x, seed, 0.1))
    keep = TD.keep_mask(numel, seed, 0.1, gpu)
    assert torch.equal(TD.dropout(torch.ones_like(x), seed, 0.1) != 0, keep)
    if numel > 10 ** 6:
        assert abs(float(keep.float().mean()) - 0.9) < 0.002
    assert torch.equal(TD.dropout(x, seed, 0.0), x)


def _within(got, ref, tol, name):
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= tol).all()), (name, float(diff.max()), float((diff / tol).max()))


def _bf16_spacing_tol(ref):
    ref = ref.float()
    return 2.0 ** -7 * ref.abs() + 1e-5 * float(ref.square().mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 896), (777, 1024), (33, 4096), (5, 128), (300, 2048)])
@pytest.mark.parametrize("scale_dtype", [torch.bfloat16, torch.float32])
def test_norm_kernels_match_plain(gpu, n, d, scale_dtype):
    g = torch.Generator(device=gpu).manual_seed(6)
    x = (3 * torch.randn(n, d, generator=g, device=gpu) + 0.5).bfloat16()
    dy = torch.randn(n, d, generator=g, device=gpu).bfloat16()
    scale = (torch.randn(d, generator=g, device=gpu) + 1).to(scale_dtype)
    bias = torch.randn(d, generator=g, device=gpu).to(scale_dtype)
    counts = [f.launches for f in (TLN.layernorm_fwd, TLN.layernorm_bwd,
                                   TLN.rmsnorm_fwd, TLN.rmsnorm_bwd)]
    y, mean, rstd = TLN.layernorm_fwd(x, scale, bias, 1e-6)
    ry, rmean, rrstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    _within(y, ry, _bf16_spacing_tol(ry), "ln y")
    torch.testing.assert_close(mean, rmean, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rrstd, atol=0, rtol=1e-5)
    got = TLN.layernorm_bwd(x, scale, rmean, rrstd, dy)
    ref = TLN.layernorm_bwd_plain(x, scale, rmean, rrstd, dy)
    xhat = (x.float() - rmean[:, None]) * rrstd[:, None]
    terms = ((dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0))
    _within(got[0], ref[0], _bf16_spacing_tol(ref[0]), "ln dx")
    for a, b, t, name in zip(got[1:], ref[1:], terms, ("dscale", "dbias")):
        assert a.dtype == scale_dtype
        _within(a, b, 2.0 ** -7 * b.float().abs() + 1e-5 * t, name)
    y, rstd = TLN.rmsnorm_fwd(x, scale, 1e-6)
    ry, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    _within(y, ry, _bf16_spacing_tol(ry), "rms y")
    dx, dscale = TLN.rmsnorm_bwd(x, scale, rrstd, dy)
    rdx, rdscale = TLN.rmsnorm_bwd_plain(x, scale, rrstd, dy)
    _within(dx, rdx, _bf16_spacing_tol(rdx), "rms dx")
    xhat = x.float() * rrstd[:, None]
    _within(dscale, rdscale, 2.0 ** -7 * rdscale.float().abs()
            + 1e-5 * (dy.float() * xhat).abs().sum(0), "rms dscale")
    frozen = TLN.rmsnorm_bwd(x, scale, rrstd, dy, need_dscale=False)
    assert frozen[1] is None and torch.equal(frozen[0], dx)
    assert [f.launches for f in (TLN.layernorm_fwd, TLN.layernorm_bwd, TLN.rmsnorm_fwd,
                                 TLN.rmsnorm_bwd)] == [c + k for c, k in zip(counts, (1, 1, 1, 2))]


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(100, 128, 1111), (960, 896, 5003), (7, 64, 300)])
def test_fused_ce_kernels_match_plain(gpu, N, H, V):
    g = torch.Generator(device=gpu).manual_seed(7)
    h = torch.randn(N, H, generator=g, device=gpu).bfloat16()
    w = (0.02 * torch.randn(V, H, generator=g, device=gpu)).bfloat16()
    labels = torch.randint(0, V, (N,), generator=g, device=gpu)
    labels[0], labels[-1] = -100, V
    cot = torch.rand(N, generator=g, device=gpu)
    f0, b0 = TCE.fused_ce_fwd.launches, TCE.fused_ce_bwd.launches
    logz, ce = TCE.fused_ce_fwd(h, labels, w)
    rlogz, rce = TCE.fused_ce_fwd_plain(h, labels, w)
    _within(ce, rce, 2e-3 + 1e-5 * rce.abs(), "ce")
    _within(logz, rlogz, 2e-3 + 1e-5 * rlogz.abs(), "logz")
    dh, dw = TCE.fused_ce_bwd(h, labels, w, rlogz, cot, True)
    rdh, rdw = TCE.fused_ce_bwd_plain(h, labels, w, rlogz, cot, True)
    mdh, mdw = TCE.fused_ce_bwd_plain(h, labels, w, rlogz, cot, True, abs_terms=True)
    for a, b, m, name in ((dh, rdh, mdh, "dh"), (dw, rdw, mdw, "dw")):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        tol = 2.0 ** -7 * (m + b.float().abs()) + 1e-6 * float(b.float().square().mean().sqrt())
        _within(a, b, tol, name)
    dh_only, none = TCE.fused_ce_bwd(h, labels, w, rlogz, cot, False)
    assert none is None and torch.equal(dh_only, dh)
    assert (TCE.fused_ce_fwd.launches, TCE.fused_ce_bwd.launches) == (f0 + 1, b0 + 2)


@pytest.mark.cuda
def test_fused_kernels_launch_under_autograd(gpu):
    g = torch.Generator(device=gpu).manual_seed(8)
    x = torch.randn(3, 50, 896, generator=g, device=gpu).bfloat16().requires_grad_(True)
    scale = torch.ones(896, device=gpu, requires_grad=True)
    w = (0.02 * torch.randn(1000, 896, generator=g, device=gpu)).bfloat16()
    labels = torch.randint(0, 1000, (150,), generator=g, device=gpu)
    counts = [f.launches for f in (TLN.rmsnorm_fwd, TLN.rmsnorm_bwd,
                                   TCE.fused_ce_fwd, TCE.fused_ce_bwd)]
    y = TLN.rmsnorm_fused(x, scale.bfloat16(), 1e-6)
    TCE.fused_ce(y.reshape(150, 896), labels, w).sum().backward()
    assert [f.launches for f in (TLN.rmsnorm_fwd, TLN.rmsnorm_bwd, TCE.fused_ce_fwd,
                                 TCE.fused_ce_bwd)] == [c + 1 for c in counts]
    assert torch.isfinite(x.grad.float()).all() and scale.grad.dtype == torch.float32


@pytest.mark.cuda
def test_fused_kernels_refuse_what_they_do_not_take(gpu):
    x = torch.randn(4, 64, device=gpu)
    scale = torch.ones(64, device=gpu)
    with pytest.raises(TypeError, match="bf16"):
        TLN.layernorm_fwd(x, scale, scale, 1e-6)                 # fp32 x
    with pytest.raises(ValueError, match="d % 8"):
        TLN.rmsnorm_fwd(torch.randn(4, 60, device=gpu).bfloat16(),
                        torch.ones(60, device=gpu), 1e-6)
    with pytest.raises(TypeError, match="scale"):
        TLN.rmsnorm_fwd(x.bfloat16(), scale.half(), 1e-6)
    h = torch.randn(8, 96, device=gpu).bfloat16()
    w = torch.randn(50, 96, device=gpu).bfloat16()
    labels = torch.zeros(8, dtype=torch.long, device=gpu)
    with pytest.raises(TypeError, match="bf16"):
        TCE.fused_ce_fwd(h.float(), labels, w)
    with pytest.raises(ValueError, match="H in"):
        TCE.fused_ce_bwd(h, labels, w, torch.zeros(8, device=gpu),
                         torch.ones(8, device=gpu), False)
    with pytest.raises(ValueError, match="H % 32"):
        TCE.fused_ce_fwd(h[:, :80], labels, w[:, :80])
