"""The CUDA kernels of simlingo_tpu_torch against their plain versions.

Marked `cuda`: they skip without an NVIDIA GPU. This file imports no JAX,
so it also runs on a GPU machine without it (the tests/ conftest imports
JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

bf16 kernels against the plain fp32 math on the same bf16 inputs, at
rtol = 2e-2 and an atol of 2e-2 for int8_matmul (outputs of rms ~0.6) and
2e-3 for attention over 77-129 keys (outputs of rms ~0.1); 4e-3 where causal
rows see as few as one key: the kernel rounds each probability to bf16
(2^-9 relative) before it weights a value of |v| up to ~4; at
SimLingo-Base's shapes 2e-3 all the same, where the causal rows take the
kernel's build with P's remainder (`_fwd_remainder`). The backward
kernel's gradients are held at |err| <= 3e-2 rms(ref) + 2e-2 |ref|: it
rounds P and dS to bf16 before the products, and each gradient sums
over up to T terms; at SimLingo-Base's shapes, with rows that see one
to a few keys, at the rounding bound of `chip_smoke.py` instead, 2^-8
(sum |terms| + |ref|). The dropout kernel equals its plain version bit for
bit, at a rank's blocks of a multi-GPU step too (dp rows, tp columns, sp
slabs), where its mask is the one-process mask cut to the block, and
in a fused LoRA group, one launch for the group's input and two in its
backward. The ring
of sequence parallelism (its ranks on threads) launches both attention
kernels a chunk; its output agrees with its plain recurrence at the
forward's tolerance above, its gradients (sums of fp32 chunk partials,
rounded once) with the whole sequence's plain backward within the
single kernel's rounding bound over the whole sequence's terms; the fp32
partials round to the bf16 instance's output. The norm kernels' bf16 outputs (y, dx) are held to one bf16 spacing
of the plain version's (2^-7 |ref| + 1e-5 rms): both round the same fp32
math, summed in another order; their parameter gradients to 2^-7 |ref|
plus 1e-5 of the sum of |terms| over the rows. The fused CE's ce to
2e-3 + 1e-5 |ref| (fp32 accumulation over H products), its dh and dW to
2^-7 (sum |terms| + |ref|): kernel and plain version round dlogits to
bf16 at the same point, so a flip is at most one bf16 spacing. The int8
activation gradient to one bf16 spacing of |ref| plus 2^-20 sqrt(N) of
the sum of |terms| (see _dx_tol); the int8 forward's split reduction to
half a spacing of the fp32 |ref| plus 2^-20 sqrt(K) of the sum of |terms|
(see _fwd_tol). The attention kernels also at the other head dims they
are built at (16, 32, 128) and at two they zero-pad (48, 80), and the
refusal of one past 128. The fp32 builds of the fused CE and the int8
products are held to their plain versions in fp64 within chip_smoke.py's
fp32 bounds (2^-22 sqrt(n) of the sum of |terms| and |ref|), the split
builds (the CE backward pass by pass, the int8 forward at ragged and split
shapes) the same way, both split builds of this kind the same bits on two
calls at ragged and unaligned shapes, and the CE forward's gold logit the
bits the backward recomputes; and the bf16
builds at widths the wrappers zero-pad (H 100, K 100, N 101) to the bf16
bounds above. The int4 product (plain PyTorch) on the GPU
against its CPU fp32 path to 2^-8 (|ref| + sum|terms|), and
`chip_smoke.py`'s phase-3 int4 agent and remat steps.
"""

import importlib.util
from pathlib import Path

import numpy as np
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
    (129, 129, 4, 4, False, None),
    (150, 150, 7, 1, True, None), (129, 129, 8, 8, False, None)])     # tp = 2's heads
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


def _chip_smoke():
    """chip_smoke.py, loaded by path (it imports torch only when run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


# the offline evaluation's first QA batch on chip_smoke.py's validation
# route (its eval_prompt_valid: 8 prompts left-padded to 768 slots), then
# 100 generated slots and the 30 queries
SMOKE = _chip_smoke()
EVAL_T = SMOKE.EVAL_PROMPT_LEN
EVAL_S = EVAL_T + SMOKE.EVAL_NEW_TOKENS + SMOKE.EVAL_QUERIES


@pytest.mark.cuda
@pytest.mark.parametrize("T,q_offset,after_prompt,path", [
    (EVAL_T, 0, 0, "tiled"), (1, EVAL_T + 99, 100, "split"), (30, EVAL_T + 100, 130, "split")],
    ids=["prefill", "decode", "queries"])
def test_flash_attn_fwd_at_the_eval_shapes(gpu, T, q_offset, after_prompt, path):
    """Batch 8 with left-padded key validity: the prefill (rows at the start
    of a prompt see one key), the last decode step and the queries; out and
    lse against the plain version, bit-identical across two calls."""
    g = torch.Generator(device=gpu).manual_seed(8)
    prompt_valid = torch.from_numpy(SMOKE.eval_prompt_valid(np)).to(gpu)
    B = prompt_valid.shape[0]
    q = torch.randn(B, T, 14, 64, generator=g, device=gpu).bfloat16()
    k, v = (torch.randn(B, EVAL_S, 2, 64, generator=g, device=gpu).bfloat16() for _ in range(2))
    valid = torch.zeros(B, EVAL_S, dtype=torch.bool, device=gpu)
    valid[:, :EVAL_T] = prompt_valid
    valid[:, EVAL_T:EVAL_T + after_prompt] = True
    assert TFA._fwd_plan(B, T, EVAL_S, 14, 2, True, q_offset).path == path
    before = TFA.flash_attn_fwd.launches
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, True, None, q_offset, return_lse=True)
    again = TFA.flash_attn_fwd(q, k, v, valid, True, None, q_offset, return_lse=True)
    torch.cuda.synchronize()
    assert TFA.flash_attn_fwd.launches == before + 2
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    ref = TFA.attention_reference(q.float(), k.float(), v.float(), valid, True, None, q_offset)
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=2e-2)
    want_lse = TFA.attention_lse_reference(q.float(), k.float(), valid, True, None, q_offset)
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    torch.testing.assert_close(lse[finite], want_lse[finite], atol=1e-2, rtol=1e-3)


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
@pytest.mark.parametrize("B", [2, 16], ids=["serving", "eval"])
def test_flash_attn_fwd_vit_views_on_the_tiled_loop(gpu, B):
    """The ViT: [B, 1025, 16, 64] views of one projection (B = 2 tiles when
    serving, 16 for the offline evaluation's batch of 8) on the tiled
    path's ring loop; the last row block holds one row (three of its warps
    compute nothing) and the last key tile one key."""
    plan = TFA._fwd_plan(B, 1025, 1025, 16, 16, False, 0)
    assert plan.path == "tiled" and plan.grid == (17, 16, B)
    g = torch.Generator(device=gpu).manual_seed(8)
    qkv = torch.randn(B, 1025, 3 * 16 * 64, generator=g, device=gpu).bfloat16()
    q, k, v = (qkv[..., i * 1024:(i + 1) * 1024].view(B, 1025, 16, 64) for i in range(3))
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
    q = torch.randn(1, 4, 2, 160, device=gpu).bfloat16()
    with pytest.raises(ValueError, match="head_dim up to 128"):
        TFA.attention(q, q, q)
    lse = torch.zeros(1, 2, 4, device=gpu)
    with pytest.raises(ValueError, match="head_dim up to 128"):
        TFA.flash_attn_bwd(q, q, q, None, q, q, lse)
    x = torch.randn(2, 24, device=gpu).half()        # K 24 is zero-padded; fp16 is not taken
    w_q, scale = TQM.quantize_weight(torch.randn(8, 24, device=gpu))
    with pytest.raises(TypeError, match="bf16 or fp32"):
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
    (4788, 128, 896, torch.bfloat16),
    # a tp = 2 rank's q, k / v and o of the int8 base
    (4788, 448, 896, torch.bfloat16), (4788, 64, 896, torch.bfloat16),
    (4788, 896, 448, torch.bfloat16)])
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
    # an odd N and a K off 16 are zero-padded (test_bf16_kernels_take_padded_widths),
    # fp32 g takes the fp32 build (test_fp32_int8_matmul_dx_matches_plain)
    w_q, scale = TQM.quantize_weight(torch.randn(32, 64, device=gpu))
    with pytest.raises(TypeError, match="scale"):
        TQM.int8_matmul_dx(torch.randn(4, 32, device=gpu).bfloat16(), w_q, scale.half())
    with pytest.raises(TypeError, match="bf16 or fp32"):
        TQM.int8_matmul_dx(torch.randn(4, 32, device=gpu).half(), w_q, scale)
    with pytest.raises(ValueError, match="operand"):
        TQM.int8_matmul_dx(torch.randn(4, 33, device=gpu).bfloat16(), w_q, scale)


def _close_to_rms(got, ref, name):
    ref = ref.float()
    rms = float(ref.square().mean().sqrt())
    bad = (got.float() - ref).abs() > 3e-2 * rms + 2e-2 * ref.abs()
    assert not bool(bad.any()), (name, float((got.float() - ref).abs().max()), rms)


def _bwd_inputs(gpu, B, T, S, HQ, HK, strided, pad_left, seed=3, D=64):
    g = torch.Generator(device=gpu).manual_seed(seed)
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
    (832, 832, 16, 16, False, True, 0),        # 416 dK/dV blocks: the 3-an-SM instantiation
    (150, 150, 7, 1, True, False, 7),          # tp = 2: Qwen2's 7 query heads over 1 kv head
    (130, 130, 8, 8, False, True, 0)])         # tp = 2: 8 of the ViT's 16 heads
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
@pytest.mark.parametrize("B,T,H,causal", [
    (32, 577, 16, False),                      # CLIP at batch 16: 577 = 9 x 64 + 1
    (16, 333, 8, True),                        # the tiny LLaMA: 333 = 5 x 64 + 13
    (2, 577, 16, False), (3, 333, 8, True)])   # the same tails, dK/dV at 1 block an SM
def test_attention_at_the_base_shapes(gpu, B, T, H, causal):
    """Group 1 without a key mask (SimLingo-Base): the forward and its lse,
    the backward (ragged last tiles in the forward and in the dS^T
    scratch), both bit-identical across calls, through `attention_train`."""
    sms = torch.cuda.get_device_properties(gpu).multi_processor_count
    assert TFA._dkdv_blocks(B, T, H, sms) == (3 if B * H * -(-T // 64) >= 3 * sms else 1)
    q, k, v, _, dout = _bwd_inputs(gpu, B, T, T, H, H, False, 0, seed=11)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches
    out = TFA.attention_train(*leaves, None, causal)
    got = torch.autograd.grad(out, leaves, dout)
    assert (TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches) == (f0 + 1, b0 + 1)
    args = (q.float(), k.float(), v.float(), None)
    # phase 2's tolerance: causal rows from slot 0 take P's remainder
    assert TFA._fwd_plan(B, T, T, H, H, causal, 0, sms=sms).remainder == causal
    torch.testing.assert_close(out.detach().float(), TFA.attention_reference(*args, causal),
                               atol=2e-3, rtol=2e-2)
    again, lse = TFA.flash_attn_fwd(q, k, v, None, causal, None, None, return_lse=True)
    assert torch.equal(again, out)
    torch.testing.assert_close(lse, TFA.attention_lse_reference(q.float(), k.float(), None,
                                                                causal), atol=1e-2, rtol=1e-3)
    # the backward at the rounding bound of chip_smoke.py's phase 2: it
    # rounds P and dS to bf16 (2^-8) before its products and its output
    bwd_args = (*args, out.detach().float(), dout.float(), lse, causal)
    ref = TFA.attention_bwd_reference(*bwd_args)
    mag = TFA.attention_bwd_reference(*bwd_args, abs_terms=True)
    for a, b, m, name in zip(got, ref, mag, "qkv"):
        tol = 2.0 ** -8 * (m + b.abs()) + 1e-5 * float(b.square().mean().sqrt())
        _within(a, b, tol, f"d{name}")
    second = TFA.flash_attn_bwd(q, k, v, None, out, dout, lse, causal)
    assert all(torch.equal(a, b) for a, b in zip(got, second))


@pytest.mark.cuda
@pytest.mark.parametrize("D,B,T,HQ,HK,causal", [
    (128, 16, 333, 16, 16, True),              # SimLingo-Base's LLaMA `large`
    (128, 2, 150, 16, 2, True),                # GQA at 128
    (16, 4, 17, 4, 4, False), (16, 2, 43, 2, 2, True),       # JAX's tiny() CLIP, LLaMA
    (32, 4, 17, 4, 4, False), (32, 2, 128, 8, 2, True),      # presets.small_shardable
    (48, 2, 70, 4, 4, False), (80, 2, 100, 4, 2, True)])     # zero-padded to 64 / 128
def test_attention_at_every_head_dim(gpu, D, B, T, HQ, HK, causal):
    """The forward and the backward through `attention_train` at a head dim
    other than 64 (built, or zero-padded to the next built one): one launch
    each, against the plain versions, both bit-identical across calls. The
    forward at this file's atol; the dS^T scratch and the gradients at the
    bf16 rounding bound of dS's terms (`attention_bwd_bound`)."""
    q, k, v, _, dout = _bwd_inputs(gpu, B, T, T, HQ, HK, False, 0, seed=D, D=D)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    f0, b0 = TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches
    out = TFA.attention_train(*leaves, None, causal)
    got = torch.autograd.grad(out, leaves, dout)
    assert (TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches) == (f0 + 1, b0 + 1)
    assert out.shape == (B, T, HQ, D) and all(g.shape == x.shape for g, x in zip(got, leaves))
    args = (q.float(), k.float(), v.float(), None)
    torch.testing.assert_close(out.detach().float(), TFA.attention_reference(*args, causal),
                               atol=4e-3 if causal else 2e-3, rtol=2e-2)
    again, lse = TFA.flash_attn_fwd(q, k, v, None, causal, None, None, return_lse=True)
    assert torch.equal(again, out)
    torch.testing.assert_close(lse, TFA.attention_lse_reference(q.float(), k.float(), None,
                                                                causal), atol=1e-2, rtol=1e-3)
    bwd_args = (*args, out.detach().float(), dout.float(), lse, causal)
    ref = TFA.attention_bwd_reference(*bwd_args)
    for a, b, tol, name in zip(got, ref, TFA.attention_bwd_bound(*bwd_args, ref), "qkv"):
        _within(a, b, tol, f"d{name}")
    *second, ds = TFA.flash_attn_bwd(q, k, v, None, out, dout, lse, causal, return_ds=True)
    assert all(torch.equal(a, b) for a, b in zip(got, second))
    plan = TFA._bwd_plan(B, T, T, HQ, HK, causal, 0, D)
    written = TFA._pair_mask(plan.written, plan, TFA._live_key_tiles(None, B, T, gpu))
    want = TFA.attention_ds_reference(*bwd_args)
    terms = TFA.attention_ds_reference(*bwd_args, abs_terms=True)
    tol = 2.0 ** -8 * (terms + want.abs()) + 1e-5 * float(want.square().mean().sqrt())
    assert bool(((ds.float() - want).abs() <= tol)[written.expand_as(ds)].all())


@pytest.mark.cuda
@pytest.mark.parametrize("HK,max_splits", [(16, 8), (16, 2), (2, 8)])
def test_flash_attn_fwd_split_path_at_head_dim_128(gpu, HK, max_splits):
    """16 query rows against 333 keys at D = 128 take the split path; its
    merge at several split counts against the plain version."""
    g = torch.Generator(device=gpu).manual_seed(HK + max_splits)
    q = torch.randn(2, 16, 16, 128, generator=g, device=gpu).bfloat16()
    k, v = (torch.randn(2, 333, HK, 128, generator=g, device=gpu).bfloat16() for _ in range(2))
    valid = torch.ones(2, 333, dtype=torch.bool, device=gpu)
    valid[:, :10] = False
    plan = TFA._fwd_plan(2, 16, 333, 16, HK, True, 317, split_rows=1 << 30,
                         max_splits=max_splits, D=128)
    assert plan.path == "split" and plan.head_dim == 128
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, True, None, 317, return_lse=True,
                                  split_rows=1 << 30, max_splits=max_splits)
    ref = TFA.attention_reference(q.float(), k.float(), v.float(), valid, True, None, 317)
    torch.testing.assert_close(out.float(), ref, atol=2e-3, rtol=2e-2)
    torch.testing.assert_close(lse, TFA.attention_lse_reference(
        q.float(), k.float(), valid, True, None, 317), atol=1e-2, rtol=1e-3)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [
    ((3, 798, 896), (3 * 798, 0, 896)),        # dp = 2's second rank: its rows
    ((6, 16, 448), (0, 448, 896)),             # tp = 2's second rank at o's input
    ((4, 10, 2432), (40, 2432, 4864)),         # dp and tp at down's input
    ((5, 7, 24), (7, 8, 40))])                 # a column block of 3 groups of 8
def test_dropout_kernel_blocks_are_the_one_process_mask(gpu, shape, block):
    g = torch.Generator(device=gpu).manual_seed(6)
    x = torch.randn(shape, generator=g, device=gpu).bfloat16()
    seed = 0x1234_5678_9ABC_DEF0
    before = TD.dropout.launches
    out = TD.dropout(x, seed, 0.1, block)
    assert TD.dropout.launches == before + 1
    assert torch.equal(out, TD.dropout_plain(x, seed, 0.1, block))
    row0, col0, width = block
    rows = x.numel() // shape[-1]
    whole = TD.keep_mask((row0 + rows) * width, seed, 0.1, gpu).view(-1, width)
    keep = TD.dropout(torch.ones_like(x), seed, 0.1, block) != 0
    assert torch.equal(keep.reshape(rows, -1), whole[row0:, col0:col0 + shape[-1]])
    assert torch.equal(TD.dropout(x, seed, 0.0, block), x)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [
    ((6, 399, 896), (0, 0, 896, 399, 798)),           # sp = 2's first slab
    ((6, 399, 4864), (399, 0, 4864, 399, 798)),       # its second, at down's input
    ((3, 16, 448), (3 * 64 + 16, 448, 896, 16, 64)),  # dp, tp and sp = 4's second slab
    ((2, 5, 16), (5, 0, 16, 5, 10))])                 # odd segments
def test_dropout_kernel_segments_are_the_one_process_mask(gpu, shape, block):
    """A rank's sequence slab (`block` + (seg, stride)): the kernel equals
    its plain version, and its mask is the one-process mask at the slab's
    rows."""
    g = torch.Generator(device=gpu).manual_seed(7)
    x = torch.randn(shape, generator=g, device=gpu).bfloat16()
    seed = 0x1234_5678_9ABC_DEF0
    before = TD.dropout.launches
    out = TD.dropout(x, seed, 0.1, block)
    assert TD.dropout.launches == before + 1
    assert torch.equal(out, TD.dropout_plain(x, seed, 0.1, block))
    row0, col0, width, seg, stride = block
    r = torch.arange(x.numel() // shape[-1], device=gpu)
    rows = row0 + (r // seg) * stride + r % seg
    whole = TD.keep_mask((int(rows.max()) + 1) * width, seed, 0.1, gpu).view(-1, width)
    keep = TD.dropout(torch.ones_like(x), seed, 0.1, block) != 0
    assert torch.equal(keep.reshape(len(r), -1), whole[rows, col0:col0 + shape[-1]])


@pytest.mark.cuda
def test_fused_lora_group_drops_its_input_once(gpu, monkeypatch):
    """The q / k / v group of SIMLINGO_LORA_FUSED=1 (`qwen2._LoraGroupDelta`)
    at the training path's [6, 798, 896]: one dropout launch in the
    forward and two in the backward (the regenerated mask, dx), each equal
    to `dropout_plain` of its input bit for bit, the backward's mask the
    forward's."""
    from simlingo_tpu_torch.models import qwen2 as TQ
    g = torch.Generator(device=gpu).manual_seed(8)
    x = torch.randn(6, 798, 896, generator=g, device=gpu).bfloat16().requires_grad_(True)
    outs = (896, 128, 128)                       # q, k, v of Qwen2-0.5B, LoRA r 32
    a = [(torch.randn(32, 896, generator=g, device=gpu) * 0.03).bfloat16().requires_grad_(True)
         for _ in outs]
    b = [(torch.randn(n, 32, generator=g, device=gpu) * 0.03).bfloat16().requires_grad_(True)
         for n in outs]
    seed, rate = 0x0F1E_2D3C_4B5A_6978, 0.1
    calls = []
    monkeypatch.setattr(TQ, "dropout", lambda t, *args: calls.append(
        (t.detach().clone(), args, TD.dropout(t, *args))) or calls[-1][2])
    before = TD.dropout.launches
    deltas = TQ._LoraGroupDelta.apply(x, seed, rate, None, *a, *b)
    assert TD.dropout.launches == before + 1 and len(deltas) == 3
    sum((d.float() * (i + 1)).sum() for i, d in enumerate(deltas)).backward()
    assert TD.dropout.launches == before + 3 and len(calls) == 3
    for inp, args, out in calls:
        assert args == (seed, rate, None)
        assert torch.equal(out, TD.dropout_plain(inp, seed, rate))
    assert torch.equal(calls[1][2], calls[0][2])            # the mask regenerated
    assert x.grad is not None and all(t.grad is not None for t in a + b)


def _ring_inputs(gpu, B, slab, HQ, HK, n, seed=9, D=64):
    g = torch.Generator(device=gpu).manual_seed(seed)
    T = slab * n
    q = torch.randn(B, T, HQ, D, generator=g, device=gpu).bfloat16()
    k, v = (torch.randn(B, T, HK, D, generator=g, device=gpu).bfloat16() for _ in range(2))
    dout = torch.randn(B, T, HQ, D, generator=g, device=gpu).bfloat16()
    lengths = torch.tensor([T - 7 * b for b in range(B)], device=gpu)
    valid = torch.arange(T, device=gpu)[None, :] < lengths[:, None]     # right-padded rows
    return q, k, v, valid, dout


@pytest.mark.cuda
@pytest.mark.parametrize("B,slab,HQ,HK,n,causal", [
    (2, 64, 4, 2, 2, True), (2, 64, 4, 2, 2, False), (2, 70, 4, 2, 3, True),
    (6, 399, 14, 2, 2, True)], ids=["small", "small_noncausal", "sp3", "chunk"])
def test_ring_attention_kernels_match_the_plain_recurrence(gpu, B, slab, HQ, HK, n, causal):
    """`parallel/sequence.py`'s ring, its n ranks on threads of this process:
    on CUDA tensors every chunk launches the attention kernels (rank i of a
    causal ring folds i + 1 chunks, forward and backward), and the output
    and gradients agree with the ring on fp32 CPU copies, the plain
    recurrence (JAX's `_chunk_update`; the output) and
    `attention_bwd_reference` of the whole sequence fed the ring's own o
    and lse (the gradients). Each chunk's backward hands back fp32
    partials (`out_dtype=torch.float32`) and the ring rounds their sum once,
    so the sum is held to the single kernel's rounding bound
    (`attention_bwd_bound`) over the whole sequence's terms."""
    spec = importlib.util.spec_from_file_location(
        "torch_ranks", Path(__file__).resolve().parent / "torch_ranks.py")
    R = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(R)
    q, k, v, valid, dout = _ring_inputs(gpu, B, slab, HQ, HK, n)

    def cut(x):
        return list(x.chunk(n, 1))
    f0, b0 = TFA.flash_attn_fwd.launches, TFA.flash_attn_bwd.launches
    got = R.ring_threads(cut(q), cut(k), cut(v), cut(valid), cut(dout), causal)
    torch.cuda.synchronize()
    chunks = n * (n + 1) // 2 if causal else n * n
    assert TFA.flash_attn_fwd.launches - f0 == chunks
    assert TFA.flash_attn_bwd.launches - b0 == chunks
    cpu = [x.float().cpu() for x in (q, k, v, dout)]
    want = R.ring_threads(cut(cpu[0]), cut(cpu[1]), cut(cpu[2]), cut(valid.cpu()),
                          cut(cpu[3]), causal)
    o = torch.cat([r[0] for r in got], 1)
    o_ref = torch.cat([r[0] for r in want], 1)
    assert bool(((o.float().cpu() - o_ref).abs() <= 2e-3 + 2e-2 * o_ref.abs()).all())
    assert torch.allclose(o_ref, TFA.attention_reference(*cpu[:3], valid.cpu(), causal),
                          atol=1e-5)
    lse = torch.cat([r[2] for r in got], 2)
    args = (q.float(), k.float(), v.float(), valid, o.float(), dout.float(), lse, causal)
    ref = TFA.attention_bwd_reference(*args)
    bounds = TFA.attention_bwd_bound(*args, ref)
    for j, (tol, name) in enumerate(zip(bounds, ("dq", "dk", "dv"))):
        _within(torch.cat([r[1][j] for r in got], 1), ref[j], tol, name)


@pytest.mark.cuda
@pytest.mark.parametrize("D,B,T,S,HQ,HK,causal,strided", [
    (64, 2, 150, 150, 14, 2, True, False),     # the LLM's GQA, key validity
    (64, 6, 399, 399, 14, 2, False, False),    # a ring's earlier chunk
    (64, 2, 832, 832, 16, 16, False, True),    # the 3-an-SM dK/dV instance (ViT views)
    (128, 2, 150, 150, 16, 2, True, False), (32, 2, 128, 128, 8, 2, True, False),
    (16, 4, 17, 17, 4, 4, False, False)])
def test_bwd_fp32_partials_round_to_the_bf16_instance(gpu, D, B, T, S, HQ, HK, causal,
                                                      strided):
    """`flash_attn_bwd(out_dtype=torch.float32)` stores the same
    accumulators (times the scale) unrounded: rounded to bf16 they are the
    bf16 instance's output bit for bit, one launch each."""
    q, k, v, valid, dout = _bwd_inputs(gpu, B, T, S, HQ, HK, strided, 7, D=D)
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, causal, None, None, return_lse=True)
    before = TFA.flash_attn_bwd.launches
    bf = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal)
    f32 = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert TFA.flash_attn_bwd.launches == before + 2
    for a, b, name in zip(f32, bf, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32 and b.dtype == torch.bfloat16 and a.shape == b.shape
        assert torch.equal(a.bfloat16(), b), (name, float((a - b.float()).abs().max()))


@pytest.mark.cuda
def test_dropout_kernel_refuses_blocks_it_cannot_place(gpu):
    """A block whose threads' 8 elements would not start at a multiple of 4
    of the index raises (no quiet fallback)."""
    x = torch.ones(4, 12, device=gpu, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="cols % 8"):
        TD.dropout(x, 1, 0.1, (0, 12, 24))              # 12 columns: not whole groups of 8
    with pytest.raises(ValueError, match="% 4"):
        TD.dropout(torch.ones(4, 10, device=gpu, dtype=torch.bfloat16), 1, 0.1, (1, 0, 10))


def _within(got, ref, tol, name):
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= tol).all()), (name, float(diff.max()), float((diff / tol).max()))


def _bf16_spacing_tol(ref):
    ref = ref.float()
    return 2.0 ** -7 * ref.abs() + 1e-5 * float(ref.square().mean().sqrt())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 896), (777, 1024), (33, 4096), (5, 128), (300, 2048),
                                 (5328, 512), (18464, 1024)])    # SimLingo-Base's rows
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
                                 (1, 896), (2050, 1024), (777, 8192), (5328, 512),
                                 (18464, 1024)])
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
        TLN.layernorm_fwd(x.half(), scale, scale, 1e-6)          # fp16 x (fp32 has a build)
    with pytest.raises(ValueError, match="d % 8"):
        TLN.rmsnorm_fwd(torch.randn(4, 60, device=gpu).bfloat16(),
                        torch.ones(60, device=gpu), 1e-6)
    with pytest.raises(TypeError, match="scale"):
        TLN.rmsnorm_fwd(x.bfloat16(), scale.half(), 1e-6)
    h = torch.randn(8, 96, device=gpu).bfloat16()
    w = torch.randn(50, 96, device=gpu).bfloat16()
    labels = torch.zeros(8, dtype=torch.long, device=gpu)
    # any H is zero-padded and fp32 has a build; mixed dtypes, fp16 and
    # mismatched shapes are refused
    with pytest.raises(TypeError, match="one dtype"):
        TCE.fused_ce_fwd(h.float(), labels, w)
    with pytest.raises(TypeError, match="bf16 or fp32"):
        TCE.fused_ce_bwd(h.half(), labels, w.half(), torch.zeros(8, device=gpu),
                         torch.ones(8, device=gpu), False)
    with pytest.raises(ValueError, match="shapes"):
        TCE.fused_ce_fwd(h[:, :80], labels[:4], w[:, :80])


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 16, 30, 65, 640])
def test_int4_matmul_on_the_gpu_matches_the_cpu_path(gpu, M):
    """The int4 product (plain PyTorch) in bf16 on the GPU against its CPU
    fp32 path, forward and activation gradient, both branches: within
    2^-8 (|ref| + sum|terms|); the GPU quantizes to the CPU's codes."""
    g = torch.Generator().manual_seed(M)
    K, N = 896, 1152
    w = torch.randn(N, K, generator=g) * 0.02
    w_q, scale = TQM.quantize_weight4(w)
    w_q_gpu, scale_gpu = TQM.quantize_weight4(w.to(gpu))
    assert torch.equal(w_q_gpu.cpu(), w_q) and torch.equal(scale_gpu.cpu(), scale)
    x = torch.randn(M, K, generator=g).bfloat16()
    dy = torch.randn(M, N, generator=g).bfloat16()
    xg = x.to(gpu).requires_grad_(True)
    y = TQM.int4_matmul(xg, w_q_gpu, scale_gpu)
    y.backward(dy.to(gpu))
    xc = x.float().requires_grad_(True)
    ref = TQM.int4_matmul(xc, w_q, scale)
    ref.backward(dy.float())
    wd = TQM.dequantize_weight4(w_q, scale, torch.float32).abs()
    for got, want, terms in ((y.detach(), ref.detach(), x.float().abs() @ wd.t()),
                             (xg.grad, xc.grad, dy.float().abs() @ wd)):
        assert got.dtype == torch.bfloat16
        err = (got.float().cpu() - want).abs()
        assert bool((err <= 2.0 ** -8 * (want.abs() + terms) + 1e-6).all()), float(err.max())


@pytest.mark.cuda
def test_small_int4_agent_on_the_gpu_agrees_with_the_cpu(gpu):
    """chip_smoke.py phase 3's int4 case: drive_only waypoints of the small
    int4 agent, GPU bf16 against CPU fp32."""
    assert _chip_smoke().small_int4_agreement(torch, gpu)


@pytest.mark.cuda
def test_microsim_tick_of_the_tiny_model_on_the_gpu_agrees_with_the_cpu(gpu):
    """One tick of `sim/runner.run_route` on MicroBench's accident route
    with `sim/suite.load_model_agent`'s tiny model: bf16 on the GPU
    (through the attention and int8 kernels) against fp32 on the CPU. The
    same camera frame; the waypoints within the serving tolerance of
    chip_smoke.py's phase 3 (0.05 max|ref|); the same record status."""
    from simlingo_tpu_torch.sim import runner, suite
    spec = next(s for s in suite.MICROBENCH if s["route_id"] == "micro_02_accident")
    outs = []
    for device in ("cpu", gpu):
        agent = suite.load_model_agent(None, tiny=True, device=device)
        seen, inner = [], agent.run_step

        def step(frame, inner=inner, seen=seen):
            seen.append((frame.rgb, inner(frame)))
            return seen[-1][1]
        agent.run_step = step
        before = (TFA.flash_attn_fwd.launches, TQM.int8_matmul.launches)
        rec = runner.run_route(spec, runner.model_factory(agent), max_steps=1)
        torch.cuda.synchronize()
        launched = (TFA.flash_attn_fwd.launches - before[0],
                    TQM.int8_matmul.launches - before[1])
        outs.append((seen, rec, launched))
    (cpu_seen, cpu_rec, cpu_n), (gpu_seen, gpu_rec, gpu_n) = outs
    assert cpu_n == (0, 0) and min(gpu_n) > 0
    assert len(cpu_seen) == len(gpu_seen) == 1
    (frame, ref), (frame_g, got) = cpu_seen[0], gpu_seen[0]
    assert np.array_equal(frame, frame_g)
    scale = max(float(np.abs(ref["route"]).max()), float(np.abs(ref["speed_wps"]).max()))
    for key in ("route", "speed_wps"):
        assert np.isfinite(got[key]).all()
        assert float(np.abs(got[key] - ref[key]).max()) <= 0.05 * scale, key
    assert gpu_rec["status"] == cpu_rec["status"]


@pytest.mark.cuda
def test_remat_step_on_the_gpu_equals_remat_off(gpu):
    """chip_smoke.py phase 3's remat steps (LoRA dropout 0.1): the losses
    of each mode equal the remat-off step's on the GPU, the grad norm to
    1e-3 relative."""
    runs = _chip_smoke().small_remat_steps(torch, gpu)
    ref = runs[(False, False)]
    assert len(runs) == 3
    for mode, got in runs.items():
        for key in ref:
            if key != "grad_norm":
                assert got[key] == ref[key], (mode, key)
        assert got["grad_norm"] == pytest.approx(ref["grad_norm"], rel=1e-3), mode


@pytest.mark.cuda
def test_replay_of_a_collected_route_on_the_gpu(gpu, tmp_path):
    """`agent/replay.replay_route` of a route the port's expert collected
    (2 saved frames), through `sim/suite.load_model_agent`'s tiny model
    (int8 LLM, drive-only, as JAX's `load_model_agent` builds it): each
    frame's launches on the GPU exactly as `chip_smoke.serve_launches`
    reckons a drive-only frame (the ViT's layers, one LLM pass, no head);
    each frame's waypoints within 0.05 max|ref| of the CPU's in fp32, as
    the microsim tick above; the expert's recorded controls beside. (The
    default agent's CoT frames are replayed at full width by
    `chip_smoke.py` phase 10b.)"""
    from simlingo_tpu_torch.agent.replay import replay_route
    from simlingo_tpu_torch.sim import runner, suite
    spec = {"town": "straight", "start_s": 5.0, "end_s": 60.0, "route_id": "replay"}
    rec = runner.run_route(spec, runner.expert_factory(save_root=str(tmp_path), seed=0),
                           max_steps=10)
    route = tmp_path / "route_000"
    assert rec["meta"]["duration_game"] == 0.5 and len(list((route / "rgb").iterdir())) == 2
    cs = _chip_smoke()
    outs = {}
    for device in ("cpu", gpu):
        agent = suite.load_model_agent(None, tiny=True, device=device)
        agent.cfg.initial_frames_delay = 0
        per, inner = [], agent.run_step

        def step(frame, inner=inner, per=per):
            before = (TFA.flash_attn_fwd.launches, TQM.int8_matmul.launches)
            out = inner(frame)
            torch.cuda.synchronize()
            per.append({"flash_attn_fwd": TFA.flash_attn_fwd.launches - before[0],
                        "int8_matmul": TQM.int8_matmul.launches - before[1]})
            return out
        agent.run_step = step
        assert not agent.cfg.use_cot and agent.cfg.int8_llm
        outs[str(device)] = (replay_route(agent, str(route)), per, agent.model_cfg)
    (cpu_out, cpu_per, _), (gpu_out, gpu_per, m) = outs["cpu"], outs[str(gpu)]
    assert [o["frame"] for o in gpu_out] == [o["frame"] for o in cpu_out] == [0, 1]
    assert cpu_per == [{"flash_attn_fwd": 0, "int8_matmul": 0}] * 2
    assert gpu_per == [cs.serve_launches(m, None)] * 2
    for ref, got in zip(cpu_out, gpu_out):
        scale = max(float(np.abs(ref["route"]).max()), float(np.abs(ref["speed_wps"]).max()))
        for key in ("route", "speed_wps"):
            assert np.isfinite(got[key]).all()
            assert float(np.abs(got[key] - ref[key]).max()) <= 0.05 * scale, key
        assert got["expert"] == ref["expert"] and got["expert"]["throttle"] is not None


@pytest.mark.cuda
def test_labelled_training_step_and_loop_tick_on_the_gpu(gpu, tmp_path):
    """The collect-label-train-drive loop at tiny size: a synthesized route
    labelled by `collect_dataset_torch.run_label_generation` (commentary,
    VQA, dreamer, the buckets), one step of configs/simlingo.yaml with
    language, the dreamer mix and the buckets on, from one init: bf16 on
    the GPU (attention kernels launched) against fp32 on the CPU (none),
    the losses within 2e-2 and the grad norm within 5e-2, as chip_smoke.py
    phase 3 holds its small step. Then each trained model through
    `save_hf_checkpoint` / `load_hf_checkpoint` drives one microsim tick,
    the GPU's waypoints within 0.05 max|ref| of the CPU's."""
    from simlingo_tpu_torch.agent.agent import LingoAgent
    from simlingo_tpu_torch.agent.config import AgentConfig
    from simlingo_tpu_torch.core import checkpoint as ckpt
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.data.synthetic import synthesize_route
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig
    from simlingo_tpu_torch.sim import runner
    from simlingo_tpu_torch.train import train_step as ts
    from simlingo_tpu_torch.train import trainer
    spec = importlib.util.spec_from_file_location(
        "collect_dataset_torch", Path(__file__).resolve().parents[1] / "collect_dataset_torch.py")
    CDT = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CDT)
    synthesize_route(str(tmp_path), "v1/b0/routes_training/Town12_cuda", n_frames=40)
    labels = CDT.run_label_generation(str(tmp_path))
    assert sum(labels["buckets"].values()) > 0
    tok = SimLingoTokenizer()
    model = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                      image_size=56, patch_size=14, projector_out=32),
        llm=Qwen2Config(vocab_size=tok.tk.vocab_size + 8, hidden_size=32, num_layers=1,
                        num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False)
    runs = {}
    for device, precision in (("cpu", "fp32"), (gpu, "bf16")):
        cfg = compose("configs/simlingo.yaml", [
            f"data.data_root={tmp_path}", f"data.bucket_path={tmp_path}/bucketsv2_simlingo",
            "data.base.use_town13=false", "max_steps=1", "output_dir=", "seed=3",
            f"precision={precision}", "data.batch_size=2", "data.num_workers=2",
            "data.base.image_size=56", "val_every_n_epochs=0", "visualise_every_n_steps=0"])
        cfg.model = model
        params = ts.map_leaves(lambda _, x: x.to(device), simlingo.init_params(
            model, torch.Generator().manual_seed(0), device="cpu"))
        before = TFA.flash_attn_fwd.launches
        out = trainer.train(cfg, params=params, device=device)
        runs[str(device)] = (out, TFA.flash_attn_fwd.launches - before)
    (ref, cpu_n), (got, gpu_n) = runs["cpu"], runs[str(gpu)]
    assert cpu_n == 0 and gpu_n > 0
    for key in ("loss", "language_loss", "route_loss", "speed_wps_loss", "grad_norm"):
        want, have = ref["records"][0][key], got["records"][0][key]
        assert np.isfinite(have) and abs(have - want) <= (
            5e-2 if key == "grad_norm" else 2e-2) * abs(want), (key, have, want)
    assert ref["records"][0]["language_loss"] > 0
    drive = {"town": "straight", "start_s": 5.0, "end_s": 60.0, "route_id": "loop"}
    outs = {}
    for device, dtype in (("cpu", torch.float32), (gpu, torch.bfloat16)):
        path = ckpt.save_hf_checkpoint(str(tmp_path / f"{device}.pt"),
                                       runs[str(device)][0]["state"].params, model)
        agent = LingoAgent(ckpt.load_hf_checkpoint(path, model), model,
                           AgentConfig(use_cot=False, initial_frames_delay=0), tokenizer=tok,
                           max_prompt_len=256, compute_dtype=dtype, device=device)
        seen, inner = [], agent.run_step

        def step(frame, inner=inner, seen=seen):
            seen.append(inner(frame))
            return seen[-1]
        agent.run_step = step
        runner.run_route(drive, runner.model_factory(agent), max_steps=1)
        outs[str(device)] = seen
    (ref_out,), (got_out,) = outs["cpu"], outs[str(gpu)]
    scale = max(float(np.abs(ref_out["route"]).max()), float(np.abs(ref_out["speed_wps"]).max()))
    for key in ("route", "speed_wps"):
        assert np.isfinite(got_out[key]).all()
        assert float(np.abs(got_out[key] - ref_out[key]).max()) <= 0.05 * scale, key


# ---------------------------------------------------------------------------
# the fp32 builds (training at precision=fp32)
# ---------------------------------------------------------------------------
# Attention: fp32 FMA kernels against the plain version evaluated in fp64
# on the same fp32 inputs, within the fp32 form of the rounding bounds that
# chip_smoke.py holds phase 2 to (`attention_fwd_bound_fp32`,
# `attention_bwd_bound` at `fp32_unit`; a TF32 product exceeds them).
# Norms: the fp32 form of their bound, 2^-22 sqrt(d) (|ref| + rms(ref)) for
# y and dx, 2^-22 sqrt(n) sum|terms| + 2^-23 |ref| for the parameter sums.
# Dropout: bit-equal, its mask the bf16 instance's.


@pytest.mark.cuda
@pytest.mark.parametrize("D,B,T,S,HQ,HK,causal,q_offset,pad_left,strided", [
    (64, 2, 150, 150, 14, 2, True, None, 7, False),      # the LLM: GQA, ragged T, a left pad
    (64, 2, 130, 130, 4, 4, False, None, 0, True),       # the ViT: strided views
    (64, 1, 30, 770, 14, 2, True, 740, 40, False),       # the queries: a q offset, masks
    (16, 2, 43, 43, 2, 2, True, None, 0, False),         # JAX's tiny()
    (32, 2, 128, 128, 8, 2, True, None, 8, False),       # small_shardable's LLM
    (128, 2, 100, 100, 16, 2, True, None, 5, False),     # the LLaMA `large`'s head dim
    (48, 1, 70, 70, 2, 2, False, None, 0, False),        # zero-padded to the 64 build
    (64, 2, 150, 150, 4, 2, True, None, 70, False)])     # a key tile without a valid key
def test_fp32_attention_kernels_match_plain(gpu, D, B, T, S, HQ, HK, causal, q_offset,
                                            pad_left, strided):
    smoke = _chip_smoke()
    g = torch.Generator(device=gpu).manual_seed(D + T)
    if strided:
        qkv = torch.randn(B, T, 3 * HQ * D, generator=g, device=gpu)
        q, k, v = (qkv[..., i * HQ * D:(i + 1) * HQ * D].view(B, T, HQ, D) for i in range(3))
        valid = None
    else:
        q = torch.randn(B, T, HQ, D, generator=g, device=gpu)
        k, v = (torch.randn(B, S, HK, D, generator=g, device=gpu) for _ in range(2))
        valid = torch.ones(B, S, dtype=torch.bool, device=gpu)
        valid[0, :pad_left] = False
    dout = torch.randn(B, T, HQ, D, generator=g, device=gpu)
    n32 = (TFA.flash_attn_fwd.launches_fp32, TFA.flash_attn_bwd.launches_fp32)
    out, lse = TFA.flash_attn_fwd(q, k, v, valid, causal, None, q_offset, return_lse=True)
    f64 = [x.double() for x in (q, k, v)]
    ref = TFA.attention_reference(*f64, valid, causal, None, q_offset)
    tol = smoke.attention_fwd_bound_fp32(torch, TFA, *f64, valid, causal, q_offset, ref)
    assert out.dtype == torch.float32 and smoke._err_over_tol(out, ref, tol)[1] <= 1.0
    ref_lse = TFA.attention_lse_reference(f64[0], f64[1], valid, causal, None, q_offset)
    fin = torch.isfinite(ref_lse)
    assert torch.equal(torch.isfinite(lse), fin)
    assert float(((lse.double() - ref_lse).abs() / (1 + ref_lse.abs()))[fin].max()) <= \
        smoke.fp32_unit(S + D)
    *got, ds = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, None, q_offset,
                                  return_ds=True)
    again = TFA.flash_attn_bwd(q, k, v, valid, out, dout, lse, causal, None, q_offset)
    torch.cuda.synchronize()
    assert (TFA.flash_attn_fwd.launches_fp32, TFA.flash_attn_bwd.launches_fp32) == (
        n32[0] + 1, n32[1] + 2)
    assert all(torch.equal(a, b) for a, b in zip(got, again))     # no atomics
    args = (*f64, valid, out.double(), dout.double(), lse, causal, None, q_offset)
    refs = TFA.attention_bwd_reference(*args)
    units = (smoke.fp32_unit(S + D),) + (smoke.fp32_unit(T * HQ // HK + D),) * 2
    tols = TFA.attention_bwd_bound(*args[:8], refs, None, q_offset, u=units, rms_slack=1e-6)
    for a, b, t, name in zip(got, refs, tols, ("dq", "dk", "dv")):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert smoke._err_over_tol(a, b, t)[1] <= 1.0, name
    off = S - T if q_offset is None else q_offset
    plan = TFA._bwd_plan(B, T, S, HQ, HK, causal, off, D, torch.float32)
    assert ds.dtype == torch.float32 and ds.shape == plan.ds_shape
    dq = TFA.attention_dq_from_ds_reference(ds.double(), f64[1], valid, T, causal, None,
                                            q_offset)
    terms = TFA.attention_dq_from_ds_reference(ds.double(), f64[1], valid, T, causal, None,
                                               q_offset, abs_terms=True)
    assert smoke._err_over_tol(got[0], dq, smoke.fp32_unit(S) * (terms + dq.abs()) + 1e-9)[1] \
        <= 1.0


@pytest.mark.cuda
def test_fp32_attention_autograd_launches_the_fp32_builds(gpu):
    """attention_train on fp32 tensors: both fp32 builds, fp32 gradients."""
    g = torch.Generator(device=gpu).manual_seed(2)
    q, k, v = (torch.randn(2, 70, 4, 64, generator=g, device=gpu).requires_grad_(True)
               for _ in range(3))
    n = (TFA.flash_attn_fwd.launches_fp32, TFA.flash_attn_bwd.launches_fp32)
    TFA.attention_autograd(q, k, v, None, True).square().sum().backward()
    assert (TFA.flash_attn_fwd.launches_fp32, TFA.flash_attn_bwd.launches_fp32) == (
        n[0] + 1, n[1] + 1)
    assert all(x.grad.dtype == torch.float32 for x in (q, k, v))
    with pytest.raises(TypeError, match="bf16 or fp32"):
        TFA.flash_attn_fwd(q.detach(), k.detach().bfloat16(), v.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("shape,block", [((6, 798, 896), None), ((1003,), None),
                                         ((3, 798, 896), (3 * 798, 0, 896)),
                                         ((6, 798, 448), (0, 448, 896)),
                                         ((6, 399, 896), (399, 0, 896, 399, 798))])
def test_fp32_dropout_is_bit_identical_to_plain_with_the_bf16_mask(gpu, shape, block):
    g = torch.Generator(device=gpu).manual_seed(9)
    x = torch.randn(shape, generator=g, device=gpu) + 5.0          # no zeros
    n32 = TD.dropout.launches_fp32
    out = TD.dropout(x, 0x1234567, 0.1, block)
    out16 = TD.dropout(x.bfloat16(), 0x1234567, 0.1, block)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and TD.dropout.launches_fp32 == n32 + 1
    assert torch.equal(out, TD.dropout_plain(x, 0x1234567, 0.1, block))
    assert torch.equal(out != 0, out16 != 0)
    assert torch.equal(out[out != 0], x[out != 0] * TD.inv_keep(0.1))


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 896), (4788, 896), (777, 1024), (3072, 4096), (5, 128),
                                 (300, 2048), (13, 8192), (12300, 1024)])
def test_fp32_norm_kernels_match_plain(gpu, n, d):
    g = torch.Generator(device=gpu).manual_seed(n + d)
    x = 2 * torch.randn(n, d, generator=g, device=gpu) + 0.3
    dy = torch.randn(n, d, generator=g, device=gpu)
    scale = 1 + 0.1 * torch.randn(d, generator=g, device=gpu)
    bias = 0.1 * torch.randn(d, generator=g, device=gpu)
    row = 2.0 ** -22 * d ** 0.5

    def rows_tol(r):
        return row * (r.abs() + float(r.square().mean().sqrt()))
    n32 = [f.launches_fp32 for f in (TLN.layernorm_fwd, TLN.layernorm_bwd, TLN.rmsnorm_fwd,
                                     TLN.rmsnorm_bwd)]
    y, mean, rstd = TLN.layernorm_fwd(x, scale, bias, 1e-6)
    ry, rmean, rrstd = TLN.layernorm_fwd_plain(x, scale, bias, 1e-6)
    assert y.dtype == torch.float32
    _within(y, ry, rows_tol(ry), "ln y")
    got = TLN.layernorm_bwd(x, scale, rmean, rrstd, dy)
    again = TLN.layernorm_bwd(x, scale, rmean, rrstd, dy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = TLN.layernorm_bwd_plain(x, scale, rmean, rrstd, dy)
    xhat = (x - rmean[:, None]) * rrstd[:, None]
    _within(got[0], ref[0], rows_tol(ref[0]), "ln dx")
    for a, b, t, name in zip(got[1:], ref[1:], ((dy * xhat).abs().sum(0), dy.abs().sum(0)),
                             ("dscale", "dbias")):
        _within(a, b, 2.0 ** -22 * n ** 0.5 * t + 2.0 ** -23 * b.abs(), name)
    y, rstd = TLN.rmsnorm_fwd(x, scale, 1e-6)
    ry, rrstd = TLN.rmsnorm_fwd_plain(x, scale, 1e-6)
    _within(y, ry, rows_tol(ry), "rms y")
    dx, dscale = TLN.rmsnorm_bwd(x, scale, rrstd, dy)
    rdx, rdscale = TLN.rmsnorm_bwd_plain(x, scale, rrstd, dy)
    _within(dx, rdx, rows_tol(rdx), "rms dx")
    _within(dscale, rdscale, 2.0 ** -22 * n ** 0.5 * (dy * x * rrstd[:, None]).abs().sum(0)
            + 2.0 ** -23 * rdscale.abs(), "rms dscale")
    frozen = TLN.rmsnorm_bwd(x, scale, rrstd, dy, need_dscale=False)
    assert frozen[1] is None and torch.equal(frozen[0], dx)
    assert [f.launches_fp32 for f in (TLN.layernorm_fwd, TLN.layernorm_bwd, TLN.rmsnorm_fwd,
                                      TLN.rmsnorm_bwd)] == [c + k for c, k in
                                                             zip(n32, (1, 2, 1, 2))]


def _fp32_unit(n):
    """chip_smoke.py's `fp32_unit`: a sum of n fp32 products, 2^-22 sqrt(n)."""
    return 2.0 ** -22 * n ** 0.5


def _within64(got, ref, tol, name):
    diff = (got.double() - ref.double()).abs()
    assert bool((diff <= tol).all()), (name, float(diff.max()), float((diff / tol).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V,compute_dw", [(100, 128, 1111, True), (300, 896, 5000, False),
                                              (37, 100, 1111, True), (129, 64, 257, True),
                                              (101, 896, 151674, False),
                                              (101, 100, 20001, False)])
def test_fp32_fused_ce_matches_plain(gpu, N, H, V, compute_dw):
    """The fused CE's fp32 build (H 100 zero-padded to 128; N 101 off the
    tile, the head's vocabulary and an odd one) against the
    plain versions in fp64 on the same fp32 inputs, within chip_smoke.py's
    fp32 bounds: ce fp32_unit(H) (|h| |w| sums) + fp32_unit(V) + 2^-22
    |ref|; dh fp32_unit(H + V), dW fp32_unit(H + N) of (sum |terms| +
    |ref|); bit-identical across two calls, counted in launches_fp32."""
    g_ = torch.Generator(device=gpu).manual_seed(N + V)
    h = torch.randn(N, H, generator=g_, device=gpu)
    w = 0.05 * torch.randn(V, H, generator=g_, device=gpu)
    labels = torch.randint(0, V, (N,), generator=g_, device=gpu)
    labels[0], labels[-1] = -100, V
    g = torch.rand(N, generator=g_, device=gpu) / N
    n32 = (TCE.fused_ce_fwd.launches_fp32, TCE.fused_ce_bwd.launches_fp32)
    logz, ce = TCE.fused_ce_fwd(h, labels, w)
    h64, w64 = h.double(), w.double()
    rlogz, rce = TCE.fused_ce_fwd_plain(h64, labels, w64)
    lz_terms, ce_terms = TCE.fused_ce_fwd_plain(h64, labels, w64, abs_terms=True)
    for got, ref, terms, name in ((ce, rce, ce_terms, "ce"), (logz, rlogz, lz_terms, "logz")):
        assert got.dtype == torch.float32
        _within64(got, ref, _fp32_unit(H) * terms + _fp32_unit(V) + 2.0 ** -22 * ref.abs(), name)
    dh, dw = TCE.fused_ce_bwd(h, labels, w, logz, g, compute_dw)
    again = TCE.fused_ce_bwd(h, labels, w, logz, g, compute_dw)
    torch.cuda.synchronize()
    assert torch.equal(dh, again[0]) and (dw is None or torch.equal(dw, again[1]))
    args = (h64, labels, w64, logz.double(), g.double(), compute_dw)
    rdh, rdw = TCE.fused_ce_bwd_plain(*args)
    mdh, mdw = TCE.fused_ce_bwd_plain(*args, abs_terms=True)
    assert dh.dtype == torch.float32 and dh.shape == (N, H)
    _within64(dh, rdh, _fp32_unit(H + V) * (mdh + rdh.abs()) + 1e-12, "dh")
    if compute_dw:
        assert dw.dtype == torch.float32 and dw.shape == (V, H)
        _within64(dw, rdw, _fp32_unit(H + N) * (mdw + rdw.abs()) + 1e-12, "dW")
    else:
        assert dw is None
    assert (TCE.fused_ce_fwd.launches_fp32, TCE.fused_ce_bwd.launches_fp32) == (
        n32[0] + 1, n32[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,scale", [(1, 896, 4864, "fp32"), (16, 896, 896, "fp32"),
                                         (300, 4864, 896, "bf16"), (192, 896, 20000, "bf16"),
                                         (30, 100, 96, "fp32"), (1, 100, 96, "bf16")])
def test_fp32_int8_matmul_matches_plain(gpu, M, K, N, scale):
    """int8_matmul's fp32 build (the GEMV at M = 1, else the fp32 tile
    product, split where the tiles are few; K 100 zero-padded to 112)
    against the plain version in fp64 on the same fp32 x, within
    fp32_unit(K) (sum |terms| + |ref|); bit-identical, counted."""
    g_ = torch.Generator(device=gpu).manual_seed(M + K + N)
    x = torch.randn(M, K, generator=g_, device=gpu)
    w_q, s = TQM.quantize_weight(0.02 * torch.randn(N, K, generator=g_, device=gpu))
    s = s.bfloat16() if scale == "bf16" else s
    n32 = TQM.int8_matmul.launches_fp32
    y = TQM.int8_matmul(x, w_q, s)
    again = TQM.int8_matmul(x, w_q, s)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (M, N) and torch.equal(y, again)
    ref = TQM.int8_matmul_reference(x.double(), w_q, s)
    terms = TQM.int8_matmul_reference(x.double(), w_q, s, abs_terms=True)
    _within64(y, ref, _fp32_unit(K) * (terms + ref.abs()) + 1e-12, "y")
    assert TQM.int8_matmul.launches_fp32 == n32 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("M,N,K", [(300, 896, 4864), (192, 20001, 896), (640, 101, 100),
                                   (4, 4864, 896), (192, 151674, 896), (101, 4098, 112),
                                   (130, 101, 896)])
def test_fp32_int8_matmul_dx_matches_plain(gpu, M, N, K):
    """int8_matmul_dx's split fp32 build (odd N copied 4 bytes at a time,
    the head's N 151674 and N 4098 8 bytes, K 100 zero-padded; the head's
    reduction in 9 segments) against the plain version in fp64 on the same fp32 g and
    a bf16 scale, within fp32_unit(N) (sum |terms| + |ref|); bit-identical,
    counted."""
    g_ = torch.Generator(device=gpu).manual_seed(M + N + K)
    g = torch.randn(M, N, generator=g_, device=gpu)
    w_q, s = TQM.quantize_weight(0.02 * torch.randn(N, K, generator=g_, device=gpu))
    s = s.bfloat16()
    n32 = TQM.int8_matmul_dx.launches_fp32
    dx = TQM.int8_matmul_dx(g, w_q, s)
    again = TQM.int8_matmul_dx(g, w_q, s)
    torch.cuda.synchronize()
    assert dx.dtype == torch.float32 and dx.shape == (M, K) and torch.equal(dx, again)
    ref = TQM.int8_matmul_dx_reference(g.double(), w_q, s)
    terms = TQM.int8_matmul_dx_reference(g.double(), w_q, s, abs_terms=True)
    _within64(dx, ref, _fp32_unit(N) * (terms + ref.abs()) + 1e-12, "dx")
    assert TQM.int8_matmul_dx.launches_fp32 == n32 + 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ce_101_100_1111", "ce_960_896_151674", "dx_101_4097_112",
                                  "dx_192_151674_896", "dx_640_101_100", "dx_300_896_4864"])
def test_fp32_split_builds_give_the_same_bits_twice(gpu, case):
    """The split CE forward (ce and logz) and the split int8 gradient at
    ragged and unaligned shapes (N 101 off the tile, H 100 padded, the
    training shape; g rows 4-, 8- and 16-byte aligned) give the same bits
    on two calls."""
    what, *dims = case.split("_")
    a, b, c = map(int, dims)
    g_ = torch.Generator(device=gpu).manual_seed(a + b + c)
    if what == "ce":
        h = torch.randn(a, b, generator=g_, device=gpu)
        w = 0.02 * torch.randn(c, b, generator=g_, device=gpu)
        labels = torch.randint(0, c, (a,), generator=g_, device=gpu)
        outs = [TCE.fused_ce_fwd(h, labels, w) for _ in range(2)]
    else:
        g = torch.randn(a, b, generator=g_, device=gpu)
        w_q, s = TQM.quantize_weight(0.02 * torch.randn(b, c, generator=g_, device=gpu))
        outs = [(TQM.int8_matmul_dx(g, w_q, s.bfloat16()),) for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(101, 100, 1111), (960, 896, 151674)])
def test_fp32_ce_forward_gold_logit_is_the_backwards(gpu, N, H, V):
    """The label's logit the split CE forward keeps (ce = logz - gold) and
    the one ce_dlogits_split_kernel recomputes from the same logz have the
    same bits: with g = 1 the scratch holds exp(gold - logz) - 1 at the
    label's column, and gold - logz = -ce exactly in fp32."""
    g_ = torch.Generator(device=gpu).manual_seed(N + V)
    h = torch.randn(N, H, generator=g_, device=gpu)
    w = 0.02 * torch.randn(V, H, generator=g_, device=gpu)
    labels = torch.randint(0, V, (N,), generator=g_, device=gpu)
    labels[0], labels[-1] = -100, V
    logz, ce = TCE.fused_ce_fwd(h, labels, w)
    _, _, dl = TCE.fused_ce_bwd(h, labels, w, logz, torch.ones(N, device=gpu), False,
                                return_scratch=True)
    torch.cuda.synchronize()
    ok = (labels >= 0) & (labels < V)
    at = dl.gather(1, labels.clamp(0, V - 1)[:, None])[:, 0]
    assert torch.equal(at[ok], (torch.exp(-ce) - 1.0)[ok])


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,V", [(100, 128, 1111), (37, 100, 1111), (129, 64, 257),
                                   (300, 896, 5000)])
def test_split_fp32_ce_backward_pass_by_pass(gpu, N, H, V):
    """The fused CE's split backward (ce_dlogits_split_kernel,
    ce_dh_split_kernel + f32_reduce_kernel, ce_dw_split_kernel; H 100
    zero-padded to 128) pass by pass against fp64 on the same fp32 inputs,
    within chip_smoke.py's fp32 bounds: its dlogits scratch within
    fp32_unit(H) (|ref| + g p A) and exactly 0 past V, dh and dW within
    fp32_unit(V) / fp32_unit(N) of the plain products of its own scratch;
    scratch, dh and dW the same bits on two calls; counted in
    launches_fp32."""
    g_ = torch.Generator(device=gpu).manual_seed(3 * N + V)
    h = torch.randn(N, H, generator=g_, device=gpu)
    w = 0.02 * torch.randn(V, H, generator=g_, device=gpu)
    labels = torch.randint(0, V, (N,), generator=g_, device=gpu)
    labels[0], labels[-1] = -100, V
    g = torch.rand(N, generator=g_, device=gpu) / N
    logz, _ = TCE.fused_ce_fwd_plain(h, labels, w)
    n32 = TCE.fused_ce_bwd.launches_fp32
    dh, dw, dl = TCE.fused_ce_bwd(h, labels, w, logz, g, True, return_scratch=True)
    again = TCE.fused_ce_bwd(h, labels, w, logz, g, True, return_scratch=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((dh, dw, dl), again))
    assert TCE.fused_ce_bwd.launches_fp32 == n32 + 2
    assert dl.dtype == dh.dtype == dw.dtype == torch.float32 and dh.shape == (N, H)
    plan = TCE._bwd_plan(N, -(-H // TCE.WIDTH_STEP) * TCE.WIDTH_STEP, V,
                         _build.sm_count(gpu.index or 0), torch.float32)
    assert dl.shape == plan.scratch_shape and int(torch.count_nonzero(dl[:, V:])) == 0
    h64, w64, lz64, g64 = h.double(), w.double(), logz.double(), g.double()
    ref = TCE.ce_dlogits_reference(h64, labels, w64, lz64, g64, plan)[:, :V]
    pa = torch.exp(h64 @ w64.t() - lz64[:, None]) * (h64.abs() @ w64.abs().t()) * g64[:, None]
    _within64(dl[:, :V], ref, _fp32_unit(H) * (ref.abs() + pa) + 1e-30, "dlogits")
    dl64 = dl.double()
    for got, want, terms, n, name in (
            (dh, TCE.ce_dh_from_scratch_reference(dl64, w64, plan),
             TCE.ce_dh_from_scratch_reference(dl64, w64, plan, abs_terms=True), V, "dh"),
            (dw, TCE.ce_dw_from_scratch_reference(dl64, h64, V),
             TCE.ce_dw_from_scratch_reference(dl64, h64, V, abs_terms=True), N, "dW")):
        rms = float(want.square().mean().sqrt())
        _within64(got, want, _fp32_unit(n) * (terms + want.abs()) + 1e-6 * rms, name)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,scale", [(130, 100, 101, "bf16"), (2, 4864, 33, "fp32"),
                                         (640, 4864, 896, "fp32"), (300, 896, 129, "bf16"),
                                         (4788, 896, 128, "bf16")])
def test_split_int8_forward_at_ragged_and_split_shapes(gpu, M, K, N, scale):
    """int8_matmul's split fp32 forward (gemm_split_kernel; K 100
    zero-padded to 112, N off the tile, and `_split_plan`'s splits: S 7 at
    M 640, S 3 at the training k,v) against the plain version in fp64 on
    the same fp32 x, within fp32_unit(K) (sum |terms| + |ref|) + 1e-6
    rms(ref); the same bits on two calls; counted."""
    g_ = torch.Generator(device=gpu).manual_seed(M * N + K)
    x = torch.randn(M, K, generator=g_, device=gpu)
    w_q, s = TQM.quantize_weight(0.02 * torch.randn(N, K, generator=g_, device=gpu))
    s = s.bfloat16() if scale == "bf16" else s
    n32 = TQM.int8_matmul.launches_fp32
    y = TQM.int8_matmul(x, w_q, s)
    again = TQM.int8_matmul(x, w_q, s)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == (M, N) and torch.equal(y, again)
    assert TQM.int8_matmul.launches_fp32 == n32 + 2
    ref = TQM.int8_matmul_reference(x.double(), w_q, s)
    terms = TQM.int8_matmul_reference(x.double(), w_q, s, abs_terms=True)
    rms = float(ref.square().mean().sqrt())
    _within64(y, ref, _fp32_unit(K) * (terms + ref.abs()) + 1e-6 * rms, "y")


@pytest.mark.cuda
def test_bf16_kernels_take_padded_widths(gpu):
    """The bf16 builds at widths they are not built for, zero-padded by the
    wrappers: the fused CE at H 100 (to 128), the int8 forward at K 100 (to
    112), its gradient at N 101 and K 100 (to 102 and 112), each against
    its plain version on the same bf16 inputs at the bf16 bounds above."""
    g_ = torch.Generator(device=gpu).manual_seed(7)
    h = torch.randn(60, 100, generator=g_, device=gpu).bfloat16()
    w = (0.05 * torch.randn(1111, 100, generator=g_, device=gpu)).bfloat16()
    labels = torch.randint(0, 1111, (60,), generator=g_, device=gpu)
    g = torch.rand(60, generator=g_, device=gpu) / 60
    logz, ce = TCE.fused_ce_fwd(h, labels, w)
    rlogz, rce = TCE.fused_ce_fwd_plain(h, labels, w)
    _within(ce, rce, 2e-3 + 1e-5 * rce.abs(), "ce H 100")
    dh, dw = TCE.fused_ce_bwd(h, labels, w, rlogz, g, True)
    assert dh.shape == (60, 100) and dw.shape == (1111, 100) and dh.dtype == torch.bfloat16
    for got, ref, terms, name in zip((dh, dw), TCE.fused_ce_bwd_plain(h, labels, w, rlogz, g, True),
                                     TCE.fused_ce_bwd_plain(h, labels, w, rlogz, g, True,
                                                            abs_terms=True), ("dh", "dW")):
        _within(got, ref, 2.0 ** -7 * (terms + ref.float().abs()) + 1e-6, f"{name} H 100")
    x = torch.randn(40, 100, generator=g_, device=gpu).bfloat16()
    w_q, s = TQM.quantize_weight(0.02 * torch.randn(101, 100, generator=g_, device=gpu))
    y = TQM.int8_matmul(x, w_q, s)
    ref = TQM.int8_matmul_reference(x.float(), w_q, s)
    assert y.shape == (40, 101) and y.dtype == torch.bfloat16
    _within(y, ref, _fwd_tol(x, w_q, s, ref), "y K 100")
    gy = torch.randn(40, 101, generator=g_, device=gpu).bfloat16()
    dx = TQM.int8_matmul_dx(gy, w_q, s)
    ref = TQM.int8_matmul_dx_reference(gy, w_q, s)
    assert dx.shape == (40, 100) and dx.dtype == torch.bfloat16
    _within(dx, ref, _dx_tol(gy, w_q, s, ref), "dx N 101 K 100")


@pytest.mark.cuda
def test_small_training_step_at_fp32_on_the_gpu_agrees_with_the_cpu(gpu):
    """chip_smoke.py phase 3's fp32 steps: the small step on the card's fp32
    kernels against the CPU's fp32 plain step, gates off, with the LN gate,
    with both gates (the fused CE) and on the int8 base, losses and grad
    norm within 1e-4 relative, every launch an fp32 instance's."""
    smoke = _chip_smoke()
    assert smoke.fp32_small_agreements(torch, gpu)


@pytest.mark.cuda
def test_labelled_training_step_at_fp32_on_the_gpu_agrees_with_the_cpu(gpu, tmp_path):
    """The labelled step of `test_labelled_training_step_and_loop_tick_on_the_gpu`
    at precision=fp32 on the card (the fp32 attention and dropout builds,
    TF32 off for the run) beside its CPU fp32 run, at 1e-4 relative."""
    from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
    from simlingo_tpu_torch.data.synthetic import synthesize_route
    from simlingo_tpu_torch.models import simlingo
    from simlingo_tpu_torch.models.qwen2 import Qwen2Config
    from simlingo_tpu_torch.models.vit import ViTConfig
    from simlingo_tpu_torch.core.config import compose
    from simlingo_tpu_torch.train import train_step as ts
    from simlingo_tpu_torch.train import trainer
    spec = importlib.util.spec_from_file_location(
        "collect_dataset_torch", Path(__file__).resolve().parents[1] / "collect_dataset_torch.py")
    CDT = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CDT)
    synthesize_route(str(tmp_path), "v1/b0/routes_training/Town12_cuda", n_frames=40)
    assert sum(CDT.run_label_generation(str(tmp_path))["buckets"].values()) > 0
    tok = SimLingoTokenizer()
    model = simlingo.SimLingoConfig(
        vit=ViTConfig(hidden_size=32, num_layers=1, num_heads=2, intermediate_size=64,
                      image_size=56, patch_size=14, projector_out=32),
        llm=Qwen2Config(vocab_size=tok.tk.vocab_size + 8, hidden_size=32, num_layers=1,
                        num_heads=2, num_kv_heads=1, head_dim=16, intermediate_size=64),
        img_context_token_id=tok.img_context_id, remat_vision=False, remat_llm=False)
    runs = {}
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    for device in ("cpu", gpu):
        cfg = compose("configs/simlingo.yaml", [
            f"data.data_root={tmp_path}", f"data.bucket_path={tmp_path}/bucketsv2_simlingo",
            "data.base.use_town13=false", "max_steps=1", "output_dir=", "seed=3",
            "precision=fp32", "data.batch_size=2", "data.num_workers=2",
            "data.base.image_size=56", "val_every_n_epochs=0", "visualise_every_n_steps=0"])
        cfg.model = model
        params = ts.map_leaves(lambda _, x: x.to(device), simlingo.init_params(
            model, torch.Generator().manual_seed(0), device="cpu"))
        before = TFA.flash_attn_fwd.launches_fp32
        out = trainer.train(cfg, params=params, device=device)
        runs[str(device)] = (out, TFA.flash_attn_fwd.launches_fp32 - before)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == tf32
    (ref, cpu_n), (got, gpu_n) = runs["cpu"], runs[str(gpu)]
    assert cpu_n == 0 and gpu_n > 0
    for key in ("loss", "language_loss", "route_loss", "speed_wps_loss", "grad_norm"):
        want, have = ref["records"][0][key], got["records"][0][key]
        assert np.isfinite(have) and abs(have - want) <= 1e-4 * abs(want), (key, have, want)
