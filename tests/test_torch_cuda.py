"""The CUDA kernels of simlingo_tpu_torch against their plain versions.

Marked `cuda`: they skip without an NVIDIA GPU. This file imports no JAX,
so it also runs on a GPU machine without it (the tests/ conftest imports
JAX; skip it there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

bf16 kernels against the plain fp32 math on the same bf16 inputs, at
rtol = 2e-2 and an atol of 2e-2 for int8_matmul (outputs of rms ~0.6) and
2e-3 for attention over 77-129 keys (outputs of rms ~0.1); 4e-3 where causal
rows see as few as one key: the kernel rounds each probability to bf16
(2^-9 relative) before it weights a value of |v| up to ~4.
"""

import pytest
import torch

from simlingo_tpu_torch.kernels import flash_attention as TFA
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
