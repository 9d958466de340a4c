"""kernels/layernorm.py (plain versions, CPU) against the JAX Pallas norms.

The same numpy inputs go through JAX's `layernorm_fused` / `rmsnorm_fused`
(Pallas in interpret mode, as tests/test_layernorm_kernel.py runs them)
and the port's `layernorm_fused` / `rmsnorm_fused` on CPU tensors, in fp32,
at odd row counts. Tolerances: 1e-5 for outputs (fp32 against fp32, the
sums taken in another order) and 1e-4 relative to the largest element for
gradients (dscale / dbias sum over all rows).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.kernels.layernorm import layernorm_fused as jln
from simlingo_tpu.kernels.layernorm import rmsnorm_fused as jrms
from simlingo_tpu_torch.kernels import layernorm as TL
from simlingo_tpu_torch.models import layers as L

VAL = dict(rtol=1e-5, atol=1e-5)


def _grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=name)


def _data(shape, seed):
    rs = np.random.RandomState(seed)
    d = shape[-1]
    return (3.0 * rs.randn(*shape).astype(np.float32) + 0.5,
            (rs.randn(d) + 1.0).astype(np.float32),
            rs.randn(d).astype(np.float32),
            rs.randn(*shape).astype(np.float32))


@pytest.mark.parametrize("shape,eps", [((7, 64), 1e-6), ((3, 37, 128), 1e-5),
                                       ((2, 129, 96), 1e-6)])
def test_layernorm_matches_jax(shape, eps):
    x, scale, bias, dy = _data(shape, 0)
    want, vjp = jax.vjp(lambda a, s, b: jln(a, s, b, eps), x, scale, bias)
    wdx, wds, wdb = vjp(dy)
    tx, ts_, tb = (torch.tensor(a, requires_grad=True) for a in (x, scale, bias))
    y = TL.layernorm_fused(tx, ts_, tb, eps)
    y.backward(torch.tensor(dy))
    assert y.shape == shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **VAL)
    for got, w, name in ((tx.grad, wdx, "dx"), (ts_.grad, wds, "dscale"),
                         (tb.grad, wdb, "dbias")):
        _grad_close(got.numpy(), w, name)


@pytest.mark.parametrize("shape,eps", [((7, 64), 1e-6), ((3, 37, 128), 1e-6),
                                       ((5, 896), 1e-6)])
def test_rmsnorm_matches_jax(shape, eps):
    x, scale, _, dy = _data(shape, 1)
    want, vjp = jax.vjp(lambda a, s: jrms(a, s, eps), x, scale)
    wdx, wds = vjp(dy)
    tx, ts_ = (torch.tensor(a, requires_grad=True) for a in (x, scale))
    y = TL.rmsnorm_fused(tx, ts_, eps)
    y.backward(torch.tensor(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), **VAL)
    _grad_close(tx.grad.numpy(), wdx, "dx")
    _grad_close(ts_.grad.numpy(), wds, "dscale")


def test_stats_and_frozen_scale():
    """The forward's saved statistics, and a frozen scale: dx unchanged,
    no dscale computed (JAX computes and discards it)."""
    x, scale, bias, dy = _data((9, 64), 2)
    tx = torch.tensor(x)
    _, mean, rstd = TL.layernorm_fwd(tx, torch.tensor(scale), torch.tensor(bias), 1e-6)
    np.testing.assert_allclose(mean.numpy(), x.mean(-1), **VAL)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(x.var(-1) + 1e-6), rtol=1e-5)
    _, rstd = TL.rmsnorm_fwd(tx, torch.tensor(scale), 1e-6)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt((x * x).mean(-1) + 1e-6),
                               rtol=1e-5)
    dx_all = TL.rmsnorm_bwd(tx, torch.tensor(scale), rstd, torch.tensor(dy))
    dx_frozen = TL.rmsnorm_bwd(tx, torch.tensor(scale), rstd, torch.tensor(dy),
                               need_dscale=False)
    assert dx_frozen[1] is None and torch.equal(dx_all[0], dx_frozen[0])
    xg = torch.tensor(x, requires_grad=True)
    TL.rmsnorm_fused(xg, torch.tensor(scale), 1e-6).backward(torch.tensor(dy))
    assert torch.equal(xg.grad, dx_all[0])


def test_dtypes_follow_x_and_scale():
    """bf16 x with an fp32 scale (the frozen bf16 / trainable fp32 mix):
    y and dx in x's dtype, dscale and dbias in the scale's dtype."""
    x, scale, bias, dy = _data((2, 11, 64), 3)
    tx = torch.tensor(x).bfloat16().requires_grad_(True)
    ts_ = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias).bfloat16().requires_grad_(True)
    y = TL.layernorm_fused(tx, ts_.bfloat16(), tb, 1e-6)
    y.float().backward(torch.tensor(dy))
    assert y.dtype == tx.grad.dtype == tb.grad.dtype == torch.bfloat16
    assert ts_.grad.dtype == torch.float32
    ref = L.layernorm({"scale": ts_.bfloat16(), "bias": tb}, tx, 1e-6)
    torch.testing.assert_close(y, ref, atol=0, rtol=2 ** -7)   # one bf16 ulp


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_layers_route_through_the_gate(monkeypatch, norm):
    x, scale, bias, _ = _data((4, 64), 4)
    p = {"scale": torch.tensor(scale), "bias": torch.tensor(bias)}
    calls = []
    real = getattr(TL, f"{norm}_fused")
    monkeypatch.setattr(L.fused_norm, f"{norm}_fused",
                        lambda *a: calls.append(1) or real(*a))
    fn = getattr(L, norm)
    args = (p, torch.tensor(x), 1e-6) if norm == "layernorm" else (
        {"scale": p["scale"]}, torch.tensor(x), 1e-6)
    monkeypatch.delenv("SIMLINGO_LN_IMPL", raising=False)
    default = fn(*args)
    assert calls == []
    monkeypatch.setenv("SIMLINGO_LN_IMPL", "pallas")
    gated = fn(*args)
    assert calls == [1]
    np.testing.assert_allclose(gated.numpy(), default.numpy(), **VAL)
