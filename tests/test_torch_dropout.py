"""LoRA dropout of simlingo_tpu_torch (kernels/dropout.py, models/qwen2.py).

The port's stream (Philox4x32-10 keyed by the seed) differs from the TPU's
hardware bits and from JAX's CPU threefry, so dropout is held to its
semantics -- those of tests/test_dropout_kernel.py: scaling, keep rate,
determinism per seed, the same mask in the backward, identity at p = 0 --
and the Philox rendering to Random123's known-answer vectors. The two
LoRA-dropout autograd Functions are held against plain autograd through
an explicit `dropout_plain` mask with the same seed. The CUDA kernel is
held bit for bit against `dropout_plain` in test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simlingo_tpu_torch.kernels import dropout as TD
from simlingo_tpu_torch.models import qwen2 as tq

M = 0xFFFFFFFF


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((M, M, M, M), (M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    words = TD.philox4x32(tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
    assert tuple(int(w) for w in words) == want


def test_keep_mask_is_philox_of_the_flat_index():
    seed = (0x299F31D0 << 32) | 0xA4093822
    idx = torch.arange(40, dtype=torch.int64)
    ctr = idx >> 2
    zero = torch.zeros_like(ctr)
    words = TD.philox4x32((ctr, zero, zero, zero), (0xA4093822, 0x299F31D0))
    bits = torch.stack(words, 1)[idx, idx & 3]
    thr = TD.threshold(0.3)
    assert thr == round(0.3 * 2 ** 32)
    assert torch.equal(TD.keep_mask(40, seed, 0.3), bits >= thr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_statistics_and_scaling(dtype):
    x = torch.ones(1000, 896, dtype=dtype)
    out = TD.dropout(x, 3, 0.1)
    kept = out != 0
    assert out.dtype == dtype and out.shape == x.shape
    want = torch.tensor(1 / 0.9, dtype=torch.float32).to(dtype)
    assert torch.equal(out[kept], want.expand(int(kept.sum())))
    assert abs(1 - float(kept.float().mean()) - 0.1) < 0.002


def test_dropout_deterministic_per_seed_and_identity_at_zero():
    x = torch.from_numpy(np.random.RandomState(0).randn(64, 128).astype(np.float32))
    a, b, c = TD.dropout(x, 1, 0.2), TD.dropout(x, 1, 0.2), TD.dropout(x, 2, 0.2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    # the high seed word is part of the key
    assert not torch.equal(a, TD.dropout(x, 1 + (1 << 32), 0.2))
    assert torch.equal(TD.dropout(x, 5, 0.0), x)


def test_hw_dropout_backward_uses_the_same_mask():
    x = torch.from_numpy(np.random.RandomState(0).randn(32, 256).astype(np.float32))
    x.requires_grad_(True)
    out = TD.hw_dropout(x, 7, 0.1)
    (dx,) = torch.autograd.grad(out, x, torch.ones_like(out))
    torch.testing.assert_close(dx, (out.detach() != 0).float() / 0.9, rtol=1e-6, atol=0)


def _lora_inputs(seed=0, B=2, T=5, din=24, dout=16, r=4):
    rng = np.random.RandomState(seed)
    t = [torch.from_numpy(rng.randn(*s).astype(np.float32)).requires_grad_(True)
         for s in ((B, T, din), (B, T, din), (r, din), (dout, r), (B, T, dout))]
    return t


def test_lora_drop_delta_matches_autograd_with_explicit_mask():
    x, _, a, b, g = _lora_inputs()
    seed, rate = 11, 0.25
    got = tq._LoraDropDelta.apply(x, a, b, seed, rate)
    keep = TD.keep_mask(x.numel(), seed, rate).view(x.shape)
    want = F.linear(F.linear(torch.where(keep, x * TD.inv_keep(rate), 0.0), a), b)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for gg, ww in zip(torch.autograd.grad(got, (x, a, b), g),
                      torch.autograd.grad(want, (x, a, b), g)):
        torch.testing.assert_close(gg, ww, rtol=1e-5, atol=1e-5)


def test_lora_drop_delta_glu_matches_autograd_with_explicit_mask():
    xg, xu, a, b, g = _lora_inputs(seed=1)
    seed, rate = 12, 0.25
    got = tq._LoraDropDeltaGLU.apply(xg, xu, a, b, seed, rate)
    h = F.silu(xg) * xu
    keep = TD.keep_mask(h.numel(), seed, rate).view(h.shape)
    want = F.linear(F.linear(torch.where(keep, h * TD.inv_keep(rate), 0.0), a), b)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    for gg, ww in zip(torch.autograd.grad(got, (xg, xu, a, b), g),
                      torch.autograd.grad(want, (xg, xu, a, b), g)):
        torch.testing.assert_close(gg, ww, rtol=1e-5, atol=1e-5)


def test_layer_seeds_are_distinct_and_deterministic():
    s = [tq.layer_seeds(7, i) for i in range(24)] + [tq.layer_seeds(8, 0)]
    flat = [v for d in s for v in d.values()]
    assert len(set(flat)) == len(flat) == 25 * 7
    assert all(0 <= v < 2 ** 64 for v in flat)
    assert tq.layer_seeds(7, 3) == s[3]
    assert list(s[0]) == list(tq.LORA_TARGETS)


def test_qwen2_lora_dropout_forward_is_seeded():
    """With a seed the training forward drops LoRA inputs (output differs
    from the seedless forward, equal for equal seeds); the mask lands in
    the gradients as well."""
    cfg = dataclasses.replace(tq.Qwen2Config.tiny(), lora_r=4, lora_alpha=8,
                              lora_dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    p = tq.init_params(gen, cfg)
    lora = tq.init_lora_params(gen, cfg)
    for layer in lora["layers"].values():
        for ab in layer.values():
            ab["b"].add_(0.05)
            ab["a"].requires_grad_(True)
    x = torch.randn(2, 9, cfg.hidden_size, generator=gen)
    pos = torch.arange(9).expand(2, 9)

    def run(seed):
        out, _ = tq.forward(p, x, cfg, pos, lora_params=lora, dropout_seed=seed)
        grad = torch.autograd.grad(out.square().sum(), lora["layers"]["0"]["q"]["a"])
        return out.detach(), grad[0]
    (o1, g1), (o2, g2), (o3, g3), (o0, g0) = run(5), run(5), run(6), run(None)
    assert torch.equal(o1, o2) and torch.equal(g1, g2)
    assert not torch.allclose(o1, o3) and not torch.allclose(o1, o0)
    assert not torch.allclose(g1, g3)
