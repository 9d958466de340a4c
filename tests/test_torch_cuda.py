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
bf16 at the same point, so a flip is at most one bf16 spacing. The int8
activation gradient to one bf16 spacing of |ref| plus 2^-20 sqrt(N) of
the sum of |terms| (see _dx_tol); the int8 forward's split reduction to
half a spacing of the fp32 |ref| plus 2^-20 sqrt(K) of the sum of |terms|
(see _fwd_tol).
"""

import pytest
import torch

from simlingo_tpu_torch.kernels import _build
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


def _serving_attention(gpu, T, q_offset, seed=5):
    """Qwen2-0.5B's serving attention: q [1, T, 14, 64] against the
    770-key cache [1, 770, 2, 64], the first 40 keys invalid (padding)."""
    g = torch.Generator(device=gpu).manual_seed(seed)
    q = torch.randn(1, T, 14, 64, generator=g, device=gpu).bfloat16()
    k, v = (torch.randn(1, 770, 2, 64, generator=g, device=gpu).bfloat16() for _ in range(2))
    valid = torch.ones(1, 770, dtype=torch.bool, device=gpu)
    valid[:, :40] = False
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("T,q_offset", [(1, 700), (16, 690), (30, 740), (1, 20), (16, 0)])
def test_flash_attn_fwd_split_path_matches_plain(gpu, T, q_offset):
    """Decode, verify and the queries take the split path, one launch a
    call; out and lse against the plain version, the split path's plain
    mirror included; rows that see no key (q_offset 20 and 0 put every
    slot in the padding) give exact zeros and lse -inf."""
    q, k, v, valid = _serving_attention(gpu, T, q_offset)
    plan = TFA._fwd_plan(1, T, 770, 14, 2, True, q_offset)
    assert plan.path == "split" and plan.splits == 7
    before = TFA.flash_attn_fwd.launches
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, True, None, q_offset, return_lse=True)
    torch.cuda.synchronize()
    assert TFA.flash_attn_fwd.launches == before + 1
    args = (q.float(), k.float(), v.float(), valid, True, None, q_offset)
    ref = TFA.attention_reference(*args)
    split_out, split_lse = TFA.attention_split_reference(*args, return_lse=True)
    torch.testing.assert_close(split_out, ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(out.float(), ref, atol=4e-3, rtol=2e-2)
    want_lse = TFA.attention_lse_reference(q.float(), k.float(), valid, True, None, q_offset)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite) and torch.equal(torch.isfinite(split_lse), finite)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-2, rtol=1e-3)
    empty = ~finite.transpose(1, 2)                           # [B, T, HQ]
    if bool(empty.any()):
        assert float(out[empty].float().abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("T,q_offset", [(1, 700), (16, 690), (30, 740)])
def test_flash_attn_fwd_split_path_is_bit_identical_across_calls(gpu, T, q_offset):
    """The clusters merge their partials in split order, no atomics."""
    q, k, v, valid = _serving_attention(gpu, T, q_offset, seed=6)
    first = TFA.flash_attn_fwd(q, k, v, valid, True, None, q_offset, return_lse=True)
    second = TFA.flash_attn_fwd(q, k, v, valid, True, None, q_offset, return_lse=True)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


@pytest.mark.cuda
@pytest.mark.parametrize("path,max_splits", [
    ("tiled", 8), ("split", 8), ("split", 4), ("split", 1)])
def test_flash_attn_fwd_forced_plans_match_plain(gpu, path, max_splits):
    """Both kernels at a ragged GQA case: T = 37, S = 300 (5 tiles, the last
    44 keys), causal with q_offset S - T, invalid keys at both ends of one
    batch row; splits of 1, 2 and 5 tiles."""
    g = torch.Generator(device=gpu).manual_seed(7)
    B, T, S, HQ, HK = 2, 37, 300, 8, 2
    q = torch.randn(B, T, HQ, 64, generator=g, device=gpu).bfloat16()
    k, v = (torch.randn(B, S, HK, 64, generator=g, device=gpu).bfloat16() for _ in range(2))
    valid = torch.ones(B, S, dtype=torch.bool, device=gpu)
    valid[1, :70] = False
    valid[1, 290:] = False
    split_rows = 0 if path == "tiled" else 1 << 30
    plan = TFA._fwd_plan(B, T, S, HQ, HK, True, S - T, split_rows=split_rows,
                         max_splits=max_splits)
    assert plan.path == path
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, True, None, None, return_lse=True,
                                  split_rows=split_rows, max_splits=max_splits)
    ref = TFA.attention_reference(q.float(), k.float(), v.float(), valid, True)
    torch.testing.assert_close(out.float(), ref, atol=4e-3, rtol=2e-2)
    want_lse = TFA.attention_lse_reference(q.float(), k.float(), valid, True)
    torch.testing.assert_close(lse, want_lse, atol=1e-2, rtol=1e-3)


@pytest.mark.cuda
def test_flash_attn_fwd_vit_views_on_the_tiled_loop(gpu):
    """The ViT at serving width: [2, 1025, 16, 64] views of one projection
    on the tiled path's ring loop; the last row block holds one row (three
    of its warps compute nothing) and the last key tile one key."""
    plan = TFA._fwd_plan(2, 1025, 1025, 16, 16, False, 0)
    assert plan.path == "tiled" and plan.grid == (17, 16, 2)
    g = torch.Generator(device=gpu).manual_seed(8)
    qkv = torch.randn(2, 1025, 3 * 16 * 64, generator=g, device=gpu).bfloat16()
    q, k, v = (qkv[..., i * 1024:(i + 1) * 1024].view(2, 1025, 16, 64) for i in range(3))
    out, lse = TFA.flash_attn_fwd(q, k, v, None, False, return_lse=True)
    ref = TFA.attention_reference(q.float(), k.float(), v.float(), None, False)
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(lse, TFA.attention_lse_reference(q.float(), k.float(), None, False),
                               atol=1e-2, rtol=1e-3)


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


def _fwd_tol(x, w_q, scale, ref):
    """The int8 forward against its plain version in fp32: the kernel rounds
    its fp32 sum times the scale once to bf16 (2^-8 |ref|) and sums in
    another order, reduction segments included: 2^-20 sqrt(K) of the sum of
    |terms| (a random walk of K roundings of 2^-24, with a margin of 16)."""
    terms = TQM.int8_matmul_reference(x.float(), w_q, scale, abs_terms=True)
    ref = ref.float()
    return (2.0 ** -8 * ref.abs() + 2.0 ** -20 * w_q.shape[1] ** 0.5 * terms
            + 1e-6 * float(ref.square().mean().sqrt()))


@pytest.mark.cuda
# 16-row tiles with the reduction split into 8 segments, the last one short;
# K = 4880 ends 16 columns into its last step; 64-row tiles in a cluster of
# the plan's largest S; bf16 scales (the training step's frozen cast) at the
# GEMV, prefill and training rows; N = 130 and 131: bf16 pairs and single
# stores at the ragged columns
@pytest.mark.parametrize("M,N,K,scale_dtype", [
    (16, 896, 4864, torch.float32), (30, 896, 4880, torch.float32),
    (64, 128, 1024, torch.float32), (1, 896, 896, torch.bfloat16),
    (640, 896, 4864, torch.bfloat16), (4788, 128, 896, torch.bfloat16),
    (200, 130, 896, torch.bfloat16), (5, 131, 64, torch.float32)])
def test_int8_matmul_split_reduction_is_right_and_bit_identical(gpu, M, N, K, scale_dtype):
    if M > 1:
        _, S, seg = TQM._fwd_plan(M, N, K, _build.sm_count(gpu.index or 0))
        if (M, K) == (16, 4864):
            assert S > 1 and K - (S - 1) * seg < seg
        if K == 4880:
            assert S > 1 and K % 64
        if (M, N) == (64, 128):
            assert S == TQM._FWD_CLUSTER
    g = torch.Generator(device=gpu).manual_seed(12)
    x = torch.randn(M, K, generator=g, device=gpu).bfloat16()
    w_q, scale = TQM.quantize_weight(torch.randn(N, K, generator=g, device=gpu) * 0.02)
    scale = scale.to(scale_dtype)
    before = TQM.int8_matmul.launches
    out = TQM.int8_matmul(x, w_q, scale)
    again = TQM.int8_matmul(x, w_q, scale)
    assert TQM.int8_matmul.launches == before + 2
    assert torch.equal(out, again)
    ref = TQM.int8_matmul_reference(x.float(), w_q, scale)
    _within(out, ref, _fwd_tol(x, w_q, scale, ref), "int8_matmul")


@pytest.mark.cuda
# M = 1, the GEMV, on its plan: the decode shapes of the serving path (q,o;
# k,v; gate,up; down; the tied head, whose blocks walk 9 row groups each)
# and ragged ones (one row, a row group cut at N, K of one and of three
# chunks, K = 4880); K past 512 x 16, where the lanes loop over the chunks
# of their slice: K = 8208 (slices of 32 and 33 chunks: every warp of a
# block loops), 16384 (2 chunks a lane), 81920 (10)
@pytest.mark.parametrize("scale_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,K", [(896, 896), (128, 896), (4864, 896), (896, 4864),
                                 (151674, 896)]
                         + [(N, K) for N in (1, 7, 129, 151674) for K in (16, 48, 4880)]
                         + [(3, 8208), (100, 16384), (3, 81920)])
def test_int8_gemv_is_right_and_bit_identical(gpu, N, K, scale_dtype):
    g = torch.Generator(device=gpu).manual_seed(13)
    x = torch.randn(1, K, generator=g, device=gpu).bfloat16()
    w_q, scale = TQM.quantize_weight(torch.randn(N, K, generator=g, device=gpu) * 0.02)
    scale = scale.to(scale_dtype)
    before = TQM.int8_matmul.launches
    out = TQM.int8_matmul(x, w_q, scale)
    assert TQM.int8_matmul.launches == before + 1
    again = TQM.int8_matmul(x, w_q, scale)
    assert TQM.int8_matmul.launches == before + 2
    assert torch.equal(out, again)
    ref = TQM.int8_matmul_reference(x.float(), w_q, scale)
    _within(out, ref, _fwd_tol(x, w_q, scale, ref), "int8_matmul")


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(gpu):
    q = torch.randn(1, 4, 2, 32, device=gpu).bfloat16()
    with pytest.raises(ValueError, match="head_dim 64"):
        TFA.attention(q, q, q)
    x = torch.randn(2, 24, device=gpu).bfloat16()
    w_q, scale = TQM.quantize_weight(torch.randn(8, 24, device=gpu))
    with pytest.raises(ValueError, match="K % 16"):
        TQM.int8_matmul(x, w_q, scale)


def _dx_tol(g, w_q, scale, ref):
    """The int8 activation gradient: kernel and plain version round g *
    scale to bf16 identically, then sum in fp32 in another order and round
    dx once: one bf16 spacing of |ref|, plus 2^-20 sqrt(N) of the sum of
    |terms| for the order (a random walk of N roundings of 2^-24, with a
    margin of 16)."""
    terms = TQM.int8_matmul_dx_reference(g, w_q, scale, abs_terms=True)
    ref = ref.float()
    return (2.0 ** -7 * ref.abs() + 2.0 ** -20 * w_q.shape[0] ** 0.5 * terms
            + 1e-6 * float(ref.square().mean().sqrt()))


@pytest.mark.cuda
# N = 304: 16-byte copies of g rows; N = 130: 4-byte copies, a ragged tail;
# a bf16 scale (the training step's frozen cast)
@pytest.mark.parametrize("M,N,K,scale_dtype", [
    (200, 304, 896, torch.float32), (77, 130, 64, torch.float32),
    (4788, 128, 896, torch.bfloat16)])
def test_int8_matmul_gives_x_its_gradient_through_the_dx_kernel(gpu, M, N, K, scale_dtype):
    """C1: on a CUDA tensor that needs a gradient, the output carries an
    autograd node and x.grad comes from the int8_matmul_dx kernel."""
    g = torch.Generator(device=gpu).manual_seed(9)
    x = torch.randn(M, K, generator=g, device=gpu).bfloat16().requires_grad_(True)
    w_q, scale = TQM.quantize_weight(torch.randn(N, K, generator=g, device=gpu) * 0.02)
    scale = scale.to(scale_dtype)
    cot = torch.randn(M, N, generator=g, device=gpu).bfloat16()
    f0, b0 = TQM.int8_matmul.launches, TQM.int8_matmul_dx.launches
    y = TQM.int8_matmul(x, w_q, scale)
    assert y.grad_fn is not None
    torch.testing.assert_close(y.float(), TQM.int8_matmul_reference(x.float(), w_q, scale),
                               atol=2e-2, rtol=2e-2)
    y.backward(cot)
    assert (TQM.int8_matmul.launches, TQM.int8_matmul_dx.launches) == (f0 + 1, b0 + 1)
    assert x.grad is not None and x.grad.dtype == torch.bfloat16
    ref = TQM.int8_matmul_dx_reference(cot, w_q, scale)
    _within(x.grad, ref, _dx_tol(cot, w_q, scale, ref), "dx")
    with torch.no_grad():                              # serving: no graph
        assert TQM.int8_matmul(x, w_q, scale).grad_fn is None


@pytest.mark.cuda
def test_int8_matmul_dx_kernel_at_the_vocabulary_width(gpu):
    """The tied head's dx: g rows of 151674 bf16 are 4-byte aligned only,
    and the reduction ends 26 rows into its last step of 32."""
    g = torch.Generator(device=gpu).manual_seed(10)
    V, H = 151674, 896
    w_q, scale = TQM.quantize_weight(torch.randn(V, H, generator=g, device=gpu) * 0.02)
    cot = (1e-3 * torch.randn(40, V, generator=g, device=gpu)).bfloat16()
    before = TQM.int8_matmul_dx.launches
    dx = TQM.int8_matmul_dx(cot, w_q, scale.bfloat16())
    assert TQM.int8_matmul_dx.launches == before + 1
    ref = TQM.int8_matmul_dx_reference(cot, w_q, scale.bfloat16())
    _within(dx, ref, _dx_tol(cot, w_q, scale.bfloat16(), ref), "head dx")
    view = torch.empty(40 * V + 1, device=gpu, dtype=torch.bfloat16)[1:].view(40, V)
    view.copy_(cot)                                    # a 2-byte aligned start
    assert torch.equal(TQM.int8_matmul_dx(view, w_q, scale.bfloat16()), dx)


@pytest.mark.cuda
# the reduction split into S > 1 segments: a small shape; the tied head's;
# a ragged last segment (N = 20010 ends 10 rows into its last step)
@pytest.mark.parametrize("M,N,K", [(16, 20000, 64), (192, 151674, 896), (77, 20010, 128)])
def test_int8_matmul_dx_split_reduction_is_right_and_bit_identical(gpu, M, N, K):
    _, S, seg = TQM._dx_plan(M, N, K, _build.sm_count(gpu.index or 0))
    assert S > 1
    if N == 20010:
        assert N - (S - 1) * seg < seg and N % TQM._DX_STEP
    g = torch.Generator(device=gpu).manual_seed(11)
    w_q, scale = TQM.quantize_weight(torch.randn(N, K, generator=g, device=gpu) * 0.02)
    cot = torch.randn(M, N, generator=g, device=gpu).bfloat16()
    before = TQM.int8_matmul_dx.launches
    dx = TQM.int8_matmul_dx(cot, w_q, scale)
    again = TQM.int8_matmul_dx(cot, w_q, scale)
    assert TQM.int8_matmul_dx.launches == before + 2
    assert torch.equal(dx, again)
    ref = TQM.int8_matmul_dx_reference(cot, w_q, scale)
    _within(dx, ref, _dx_tol(cot, w_q, scale, ref), "split dx")


@pytest.mark.cuda
def test_int8_matmul_dx_refuses_what_it_does_not_take(gpu):
    w_q, scale = TQM.quantize_weight(torch.randn(33, 64, device=gpu))
    with pytest.raises(ValueError, match="even N"):
        TQM.int8_matmul_dx(torch.randn(4, 33, device=gpu).bfloat16(), w_q, scale)
    w_q, scale = TQM.quantize_weight(torch.randn(32, 64, device=gpu))
    with pytest.raises(TypeError, match="scale"):
        TQM.int8_matmul_dx(torch.randn(4, 32, device=gpu).bfloat16(), w_q, scale.half())
    with pytest.raises(TypeError, match="bf16"):
        TQM.int8_matmul_dx(torch.randn(4, 32, device=gpu), w_q, scale)
    with pytest.raises(ValueError, match="K % 16"):
        TQM.int8_matmul_dx(torch.randn(4, 33, device=gpu).bfloat16(), w_q, scale)


def _close_to_rms(got, ref, name):
    ref = ref.float()
    rms = float(ref.square().mean().sqrt())
    bad = (got.float() - ref).abs() > 3e-2 * rms + 2e-2 * ref.abs()
    assert not bool(bad.any()), (name, float((got.float() - ref).abs().max()), rms)


def _bwd_inputs(gpu, B, T, S, HQ, HK, strided, pad_left, seed=3):
    g = torch.Generator(device=gpu).manual_seed(seed)
    D = 64
    if strided:       # ViT: heads are views of one [B, T, 3*H*D] projection
        qkv = torch.randn(B, T, 3 * HQ * D, generator=g, device=gpu).bfloat16()
        q, k, v = (qkv[..., i * HQ * D:(i + 1) * HQ * D].view(B, T, HQ, D)
                   for i in range(3))
        valid = None
    else:
        q = torch.randn(B, T, HQ, D, generator=g, device=gpu).bfloat16()
        k, v = (torch.randn(B, S, HK, D, generator=g, device=gpu).bfloat16()
                for _ in range(2))
        valid = torch.ones(B, S, dtype=torch.bool, device=gpu)
        valid[0, :pad_left] = False            # rows with no visible key
        valid[1, S - 40:] = False              # right padding: skipped key tiles
    dout = torch.randn(B, T, HQ, D, generator=g, device=gpu).bfloat16()
    return q, k, v, valid, dout


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,HQ,HK,causal,strided,pad_left", [
    (150, 150, 14, 2, True, False, 7), (130, 130, 4, 4, False, True, 0),
    (64, 64, 2, 1, True, False, 7),
    (150, 150, 14, 2, True, False, 70),        # key tile 0 of sample 0: no valid key
    (100, 170, 4, 2, True, False, 7),          # q_offset = S - T = 70, T % 64 != 0
    (832, 832, 16, 16, False, True, 0)])       # 416 dK/dV blocks: the 3-an-SM instantiation
def test_flash_attn_bwd_kernel_matches_plain(gpu, T, S, HQ, HK, causal, strided, pad_left):
    B = 2
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    assert TFA._dkdv_blocks(B, S, HK, sms) == (3 if B * HK * -(-S // 64) >= 3 * sms else 1)
    q, k, v, valid, dout = _bwd_inputs(gpu, B, T, S, HQ, HK, strided, pad_left)
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, causal, None, None, return_lse=True)
    want_lse = TFA.attention_lse_reference(q.float(), k.float(), valid, causal)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-2, rtol=1e-3)
    before = TFA.flash_attn_bwd.launches
    *got, ds = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, return_ds=True)
    torch.cuda.synchronize()
    assert TFA.flash_attn_bwd.launches == before + 1
    args = (q.float(), k.float(), v.float(), valid, out.float(), dout.float(), want_lse,
            causal)
    ref = TFA.attention_bwd_reference(*args)
    for a, b, name in zip(got, ref, "qkv"):
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        _close_to_rms(a, b, name)
    # the scratch on the pairs the dK/dV kernel writes: the plain first pass
    # rounded once to bf16 (P and dS from the same lse)
    plan = TFA._bwd_plan(B, T, S, HQ, HK, causal, S - T)
    written = TFA._pair_mask(plan.written, plan, TFA._live_key_tiles(valid, B, S, gpu))
    want = TFA.attention_ds_reference(*args)
    terms = TFA.attention_ds_reference(*args, abs_terms=True)
    tol = 2.0 ** -8 * (terms + want.abs()) + 1e-5 * float(want.square().mean().sqrt())
    assert bool(((ds.float() - want).abs() <= tol)[written.expand_as(ds)].all())
    empty = ~finite.transpose(1, 2)            # [B, T, HQ]: rows that see no valid key
    if bool(empty.any()):                      # (q_offset 0 with a left pad leaves some)
        assert float(got[0][empty].abs().max()) == 0.0


@pytest.mark.cuda
def test_flash_attn_bwd_is_bit_identical_across_calls(gpu):
    """No atomics: two calls give the same bits in dq, dk and dv."""
    q, k, v, valid, dout = _bwd_inputs(gpu, 3, 300, 300, 14, 2, False, 70, seed=8)
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, True, None, None, return_lse=True)
    first = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, True)
    second = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, True)
    for a, b, name in zip(first, second, "qkv"):
        assert torch.equal(a, b), name


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


def _norm_case(gpu, n, d, seed=7):
    g = torch.Generator(device=gpu).manual_seed(seed)
    x = (3 * torch.randn(n, d, generator=g, device=gpu) + 0.5).bfloat16()
    dy = torch.randn(n, d, generator=g, device=gpu).bfloat16()
    scale = (torch.randn(d, generator=g, device=gpu) + 1).bfloat16()
    bias = torch.randn(d, generator=g, device=gpu).bfloat16()
    return x, dy, scale, bias


def _norm_bwd_within(got, x, dy, scale, mean, rstd, rms):
    """The backward's outputs against the plain version (the tolerances of
    test_norm_kernels_match_plain)."""
    if rms:
        ref = TLN.rmsnorm_bwd_plain(x, scale, rstd, dy, got[1] is not None)
        xhat = x.float() * rstd[:, None]
    else:
        ref = TLN.layernorm_bwd_plain(x, scale, mean, rstd, dy, got[1] is not None,
                                      got[2] is not None)
        xhat = (x.float() - mean[:, None]) * rstd[:, None]
    _within(got[0], ref[0], _bf16_spacing_tol(ref[0]), "dx")
    terms = ((dy.float() * xhat).abs().sum(0), dy.float().abs().sum(0))
    for a, b, t, name in zip(got[1:], ref[1:], terms, ("dscale", "dbias")):
        assert (a is None) == (b is None), name
        if a is not None:
            _within(a, b, 2.0 ** -7 * b.float().abs() + 1e-5 * t, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4788, 896), (12300, 1024), (3072, 4096), (640, 896),
                                 (1, 896), (2050, 1024), (777, 8192)])
def test_norm_backward_is_bit_identical_across_calls(gpu, n, d):
    """No atomics: both modes give the same bits call after call."""
    x, dy, scale, bias = _norm_case(gpu, n, d)
    _, mean, rstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    _, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    for call in (lambda: TLN.layernorm_bwd(x, scale, mean, rstd, dy),
                 lambda: TLN.rmsnorm_bwd(x, scale, rrstd, dy),
                 lambda: TLN.rmsnorm_bwd(x, scale, rrstd, dy, need_dscale=False)):
        a, b = call(), call()
        assert all((u is None and v is None) or torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 13, 300])
def test_norm_kernels_at_the_widest_row(gpu, n):
    """d = 8192: eight warps a row; the backward's shared memory (two
    [1, 8192] fp32 slots) is above the 48 KB default."""
    x, dy, scale, bias = _norm_case(gpu, n, 8192)
    y, mean, rstd = TLN.layernorm_fwd(x, scale, bias, 1e-6)
    ry, rmean, rrstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    _within(y, ry, _bf16_spacing_tol(ry), "ln y")
    _norm_bwd_within(TLN.layernorm_bwd(x, scale, rmean, rrstd, dy), x, dy, scale, rmean,
                     rrstd, rms=False)
    y, rstd = TLN.rmsnorm_fwd(x, scale, 1e-6)
    ry, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    _within(y, ry, _bf16_spacing_tol(ry), "rms y")
    _norm_bwd_within(TLN.rmsnorm_bwd(x, scale, rrstd, dy), x, dy, scale, None, rrstd,
                     rms=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4789, 896), (12301, 1024), (3071, 4096), (641, 896),
                                 (2051, 1024), (513, 4096), (17, 896), (31, 896)])
def test_norm_kernels_at_rows_off_the_plans_multiple(gpu, n, d):
    """Rows that are no multiple of a block's rows or of the persistent
    grid's: the last rows of the walk, in both modes and both directions."""
    x, dy, scale, bias = _norm_case(gpu, n, d)
    y, mean, rstd = TLN.layernorm_fwd(x, scale, bias, 1e-6)
    ry, rmean, rrstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    _within(y, ry, _bf16_spacing_tol(ry), "ln y")
    _norm_bwd_within(TLN.layernorm_bwd(x, scale, rmean, rrstd, dy), x, dy, scale, rmean,
                     rrstd, rms=False)
    y, rstd = TLN.rmsnorm_fwd(x, scale, 1e-6)
    ry, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    _within(y, ry, _bf16_spacing_tol(ry), "rms y")
    for need in (True, False):
        _norm_bwd_within(TLN.rmsnorm_bwd(x, scale, rrstd, dy, need_dscale=need), x, dy,
                         scale, None, rrstd, rms=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4788, 896), (640, 896), (1, 896), (12300, 1024),
                                 (3072, 4096)])
def test_norm_backward_frozen_and_summed_modes_agree(gpu, n, d):
    """The frozen scale's dx-only launch gives the dx of the launch with
    sums, bit for bit; the LayerNorm's gradients one at a time equal
    those of both together."""
    x, dy, scale, bias = _norm_case(gpu, n, d)
    _, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    dx, dscale = TLN.rmsnorm_bwd(x, scale, rrstd, dy)
    frozen = TLN.rmsnorm_bwd(x, scale, rrstd, dy, need_dscale=False)
    assert frozen[1] is None and torch.equal(frozen[0], dx)
    _norm_bwd_within((dx, dscale), x, dy, scale, None, rrstd, rms=True)
    _, mean, rstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    both = TLN.layernorm_bwd(x, scale, mean, rstd, dy)
    _norm_bwd_within(both, x, dy, scale, mean, rstd, rms=False)
    only_s = TLN.layernorm_bwd(x, scale, mean, rstd, dy, need_dbias=False)
    only_b = TLN.layernorm_bwd(x, scale, mean, rstd, dy, need_dscale=False)
    none = TLN.layernorm_bwd(x, scale, mean, rstd, dy, need_dscale=False, need_dbias=False)
    assert only_s[2] is None and torch.equal(only_s[1], both[1])
    assert only_b[1] is None and torch.equal(only_b[2], both[2])
    assert none[1] is None and none[2] is None
    for got in (only_s, only_b, none):
        assert torch.equal(got[0], both[0])


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(4788, 896), (12300, 1024), (640, 896)])
def test_norm_backward_replays_in_a_cuda_graph(gpu, n, d):
    """A captured CUDA graph of the backward, replayed twice, gives the
    eager call's bits: the column sums' launch needs no reset between
    replays."""
    x, dy, scale, bias = _norm_case(gpu, n, d)
    _, mean, rstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    _, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    calls = (lambda: TLN.layernorm_bwd(x, scale, mean, rstd, dy),
             lambda: TLN.rmsnorm_bwd(x, scale, rrstd, dy),
             lambda: TLN.rmsnorm_bwd(x, scale, rrstd, dy, need_dscale=False))
    for call in calls:
        eager = call()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = call()
        for _ in range(2):
            for t in out:
                if t is not None:
                    t.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert all((u is None and v is None) or torch.equal(u, v)
                       for u, v in zip(out, eager))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(100, 128, 1111), (960, 896, 5003), (7, 64, 300),
                                   (130, 896, 40961)])
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
    # no atomics: the same bits on every call (V = 40961 splits unevenly
    # across the dh segments)
    dh2, dw2 = TCE.fused_ce_bwd(h, labels, w, rlogz, cot, True)
    assert torch.equal(dh2, dh) and torch.equal(dw2, dw)


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
