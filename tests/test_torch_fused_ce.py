"""kernels/fused_ce.py (plain versions, CPU) against the JAX Pallas fused CE.

The same numpy inputs (N=24, H=64, V=1111: V is not a multiple of any
tile) go through JAX's `fused_ce` (Pallas in interpret mode, as
tests/test_fused_ce.py runs it) and the port's `fused_ce` on CPU tensors,
in fp32. Compared: ce at 1e-5, dh and dW at 1e-4 relative to the largest
element (sums over V and N terms), the zero head gradient exactly. Also:
`language_loss_gathered` routing under SIMLINGO_CE_IMPL, and
`make_train_step` refusing a trainable tied embedding under `pallas`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.kernels.fused_ce import fused_ce as jfused_ce
from simlingo_tpu.models import adaptors as JA
from simlingo_tpu_torch.kernels import fused_ce as TC
from simlingo_tpu_torch.models import adaptors as TA
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.train import train_step as tts

N, H, V = 24, 64, 1111


def _grad_close(got, want, name):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                               err_msg=name)


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    h = rs.randn(N, H).astype(np.float32)
    w = (0.3 * rs.randn(V, H)).astype(np.float32)
    labels = rs.randint(0, V, N)
    # out of range: JAX's gold is 0 only for labels past its padded vocab
    # tile (a label in [V, pad) meets a -inf pad column there)
    labels[3], labels[7] = -1, V + 10 ** 6
    g = np.linspace(0.2, 1.7, N).astype(np.float32)   # non-uniform cotangent
    return h, labels, w, g


@pytest.mark.parametrize("compute_dw", [False, True])
def test_fused_ce_matches_jax(data, compute_dw):
    h, labels, w, g = data
    want, vjp = jax.vjp(lambda a, b: jfused_ce(a, jnp.asarray(labels), b, compute_dw),
                        h, w)
    wdh, wdw = vjp(g)
    th, tw = torch.tensor(h, requires_grad=True), torch.tensor(w, requires_grad=True)
    ce = TC.fused_ce(th, torch.tensor(labels), tw, compute_dw)
    ce.backward(torch.tensor(g))
    assert ce.dtype == torch.float32 and bool(torch.isfinite(ce).all())
    np.testing.assert_allclose(ce.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    _grad_close(th.grad.numpy(), wdh, "dh")
    if compute_dw:
        _grad_close(tw.grad.numpy(), wdw, "dw")
    else:                         # the frozen tied head: exactly zero, both sides
        assert float(np.abs(np.asarray(wdw)).max()) == 0.0
        assert tw.grad is not None and float(tw.grad.abs().max()) == 0.0


def test_plain_versions_and_head_without_grad(data):
    """The plain forward against a full-logits CE; a head that autograd
    does not ask about gets no gradient computed; ce of an out-of-range
    label is its logz."""
    h, labels, w, g = data
    th, tl, tw = torch.tensor(h), torch.tensor(labels), torch.tensor(w)
    logz, ce = TC.fused_ce_fwd_plain(th, tl, tw)
    logits = th @ tw.t()
    np.testing.assert_allclose(logz.numpy(), torch.logsumexp(logits, -1).numpy(), rtol=1e-6)
    ok = (tl >= 0) & (tl < V)
    ref = torch.nn.functional.cross_entropy(logits[ok], tl[ok], reduction="none")
    np.testing.assert_allclose(ce[ok].numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(ce[~ok], logz[~ok])
    hg = th.clone().requires_grad_(True)
    TC.fused_ce(hg, tl, tw, True).backward(torch.tensor(g))     # w: no grad asked
    dh, dw = TC.fused_ce_bwd_plain(th, tl, tw, logz, torch.tensor(g), False)
    assert dw is None and torch.allclose(hg.grad, dh)


def test_language_loss_routes_under_the_gate(data, monkeypatch):
    h, labels, w, _ = data
    B, A = 2, N // 2
    hg = h.reshape(B, A, H)
    lab = np.clip(labels, 0, V - 1).reshape(B, A)
    valid = np.arange(A)[None, :] < np.array([[A], [A - 5]])
    head = w

    def jax_loss():
        out = JA.language_loss_gathered(
            jnp.asarray(hg), jnp.asarray(lab), jnp.asarray(valid),
            lambda x: x @ jnp.asarray(head).T, chunk=4, head_w=jnp.asarray(head))
        return np.asarray(out["language_loss"][0])

    def port_loss():
        out = TA.language_loss_gathered(
            torch.tensor(hg), torch.tensor(lab), torch.tensor(valid),
            lambda x: x @ torch.tensor(head).t(), chunk=4, head_w=torch.tensor(head))
        ce, v = out["language_loss"]
        assert torch.equal(v, torch.tensor(valid))
        return ce.numpy()

    calls = []
    real = TA.fused_ce
    monkeypatch.setattr(TA, "fused_ce", lambda *a: calls.append(a[3]) or real(*a))
    monkeypatch.delenv("SIMLINGO_CE_IMPL", raising=False)
    chunked = port_loss()
    np.testing.assert_allclose(chunked, jax_loss(), rtol=1e-5, atol=1e-5)
    assert calls == []
    for impl in ("pallas", "pallas_dw"):
        monkeypatch.setenv("SIMLINGO_CE_IMPL", impl)
        got = port_loss()
        np.testing.assert_allclose(got, jax_loss(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, chunked, rtol=1e-5, atol=1e-5)
        assert float(np.abs(got[~valid]).max()) == 0.0      # masked with `valid`
    assert calls == [False, True]


def test_make_train_step_refuses_a_trainable_embedding(monkeypatch):
    cfg = tsim.SimLingoConfig.tiny()
    opt = tts.OptimizerConfig()
    every = lambda path: True                                  # noqa: E731
    monkeypatch.setenv("SIMLINGO_CE_IMPL", "pallas")
    with pytest.raises(ValueError, match="FROZEN llm/embed"):
        tts.make_train_step(cfg, opt, torch.float32, trainable_fn=every)
    assert callable(tts.make_train_step(cfg, opt, torch.float32))   # production
    monkeypatch.setenv("SIMLINGO_CE_IMPL", "pallas_dw")
    assert callable(tts.make_train_step(cfg, opt, torch.float32, trainable_fn=every))
    monkeypatch.setenv("SIMLINGO_CE_IMPL", "xla")
    assert callable(tts.make_train_step(cfg, opt, torch.float32, trainable_fn=every))
