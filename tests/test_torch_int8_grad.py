"""The port's int8_matmul gradient against the JAX custom_vjp (CPU).

`int8_matmul` of both packages differentiates in the activation only:
dx = bf16(g * scale) through the transposed int8 weight
(`simlingo_tpu/kernels/quantized_matmul.py:_int8_matmul_bwd`). Compared,
with inputs made by numpy from a seed:
  * the plain `int8_matmul_dx_reference` and the autograd Function's CPU
    backward against `jax.vjp` of the JAX `int8_matmul`, in both
    orientations (a linear, whose JAX weight is [K, N], bridged by a
    transpose; the tied [V, H] head, JAX `transpose_rhs=True`), at M in
    each JAX branch (<= 64 and > 2048 take the XLA dot, 65-2048 the Pallas
    kernel in interpret mode); fp32 at atol/rtol 2e-4, bf16 within one
    bf16 spacing (both round g * scale at the same point and sum in fp32,
    in another order);
  * a bf16 scale (the training step's frozen-leaf cast) against JAX with
    the scale cast to bf16;
  * a JAX-initialised tiny model with an int8 base LLM, LoRA r=4, dropout
    0: `forward_loss`, the trainable gradients and three AdamW/OneCycle
    steps at 2e-4 (the comparisons of test_torch_train.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.core.quantize import quantize_llm as jquantize_llm
from simlingo_tpu.kernels import quantized_matmul as JQM
from simlingo_tpu_torch.kernels import quantized_matmul as TQM
from tests.test_torch_train import (_check_forward_loss, _check_three_train_steps,
                                    _check_trainable_grads)

TOL = dict(atol=2e-4, rtol=2e-4)
K, N, V = 64, 96, 130          # V: even, not a multiple of 8, as the vocabulary


def _operands(orient, M, seed):
    """numpy (x [M, K], g [M, N or V], JAX w_q, JAX scale, port w_q)."""
    rng = np.random.RandomState(seed)
    if orient == "linear":            # JAX [K, N], per-column scales
        jw, js = JQM.quantize_weight(jnp.asarray(0.05 * rng.randn(K, N), jnp.float32), 1)
        tw = np.asarray(jw).T
    else:                             # the tied head: [V, H], per-row scales
        jw, js = JQM.quantize_weight(jnp.asarray(0.05 * rng.randn(V, K), jnp.float32), 0)
        tw = np.asarray(jw)
    n_out = tw.shape[0]
    x = rng.randn(M, K).astype(np.float32)
    g = rng.randn(M, n_out).astype(np.float32)
    return x, g, jw, js, np.array(tw, order="C")


def _jax_vjp(x, g, jw, js, orient, dtype):
    f = jax.jit(lambda x_: JQM.int8_matmul(x_, jw, js, orient == "head"))  # traced anew
    y, vjp = jax.vjp(f, jnp.asarray(x, dtype))
    (dx,) = vjp(jnp.asarray(g, dtype))
    return np.asarray(y.astype(jnp.float32)), np.asarray(dx.astype(jnp.float32))


def _assert_one_spacing(got, want, what):
    """|got - want| <= one bf16 spacing of |want| (2^-7 |want|), plus 1e-6
    of max |want| where the value is near zero."""
    got, want = got.float().numpy(), np.asarray(want)
    tol = 2.0 ** -7 * np.abs(want) + 1e-6 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (what, float(np.abs(got - want).max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M", [48, 200, 2100])       # XLA dot / Pallas / XLA dot
@pytest.mark.parametrize("orient", ["linear", "head"])
def test_dx_matches_jax_vjp(monkeypatch, orient, M, dtype):
    x, g, jw, js, tw = _operands(orient, M, seed=M)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    calls = []
    real = JQM.pl.pallas_call
    monkeypatch.setattr(JQM.pl, "pallas_call", lambda *a, **k: calls.append(1) or real(*a, **k))
    jy, jdx = _jax_vjp(x, g, jw, js, orient, jdt)
    assert (len(calls) >= 2) == (64 < M <= 2048)           # forward and VJP traced
    w_q, scale = torch.from_numpy(tw), torch.from_numpy(np.array(js))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    gt = torch.from_numpy(g).to(tdt)
    y = TQM.int8_matmul(xt, w_q, scale)
    y.backward(gt)
    plain = TQM.int8_matmul_dx_reference(gt, w_q, scale)
    assert xt.grad.dtype == tdt and xt.grad.shape == (M, K)
    for what, got, want in (("y", y.detach(), jy), ("dx plain", plain, jdx),
                            ("x.grad", xt.grad, jdx)):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), want, err_msg=what, **TOL)
        else:
            _assert_one_spacing(got, want, what)
    assert TQM.int8_matmul.launches == TQM.int8_matmul_dx.launches == 0


def test_bf16_scale_matches_jax_with_the_scale_cast():
    """The training step stores the frozen scale in bf16; both packages
    widen it to fp32 where they multiply."""
    for orient in ("linear", "head"):
        x, g, jw, js, tw = _operands(orient, 200, seed=7)
        js16 = js.astype(jnp.bfloat16)
        jy, jdx = _jax_vjp(x, g, jw, js16, orient, jnp.float32)
        scale = torch.from_numpy(np.array(js16.astype(jnp.float32))).bfloat16()
        xt = torch.from_numpy(x).requires_grad_(True)
        y = TQM.int8_matmul(xt, torch.from_numpy(tw), scale)
        y.backward(torch.from_numpy(g))
        np.testing.assert_allclose(y.detach().numpy(), jy, err_msg=orient, **TOL)
        np.testing.assert_allclose(xt.grad.numpy(), jdx, err_msg=orient, **TOL)
        dx = TQM.int8_matmul_dx(torch.from_numpy(g), torch.from_numpy(tw), scale)
        np.testing.assert_allclose(dx.numpy(), jdx, err_msg=orient, **TOL)


def test_autograd_saves_only_the_int8_weight_and_scale():
    x, g, _, js, tw = _operands("linear", 8, seed=1)
    w_q, scale = torch.from_numpy(tw), torch.from_numpy(np.array(js))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TQM.int8_matmul(xt, w_q, scale)
    saved = y.grad_fn.saved_tensors
    assert [t.data_ptr() for t in saved] == [w_q.data_ptr(), scale.data_ptr()]
    # serving: no graph when x needs no gradient, or under no_grad
    assert TQM.int8_matmul(xt.detach(), w_q, scale).grad_fn is None
    with torch.no_grad():
        assert TQM.int8_matmul(xt, w_q, scale).grad_fn is None


@pytest.fixture(scope="module")
def setup_int8():
    from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
    from simlingo_tpu.models import simlingo as jsim
    base = jsim.SimLingoConfig.tiny()
    jcfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, lora_r=4, lora_alpha=8, lora_dropout=0.0))
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02, params["lora"])
    params["llm"] = jquantize_llm(params["llm"])
    ex = jsynthetic(jcfg, batch=2, seq_len=96, num_patches=1, seed=3)
    return jcfg, params, ex


@pytest.mark.parametrize("check", ["forward_loss", "grads", "steps"])
def test_int8_base_training_tracks_jax(setup_int8, check):
    jcfg, params, _ = setup_int8
    assert params["llm"]["embed"]["w_q"].dtype == jnp.int8
    assert params["llm"]["layers"]["0"]["mlp"]["down"]["w_q"].dtype == jnp.int8
    if check == "forward_loss":
        _check_forward_loss(setup_int8, 160)
    elif check == "grads":
        _check_trainable_grads(setup_int8)
    else:
        _check_three_train_steps(setup_int8)
