"""Fused LoRA groups (SIMLINGO_LORA_FUSED=1) in the port against JAX's
(`simlingo_tpu/models/qwen2.py` `_fused_lora_delta`) and against the
port's own unfused path (CPU, fp32).

The tiny Qwen2 of `tests/test_lora_fused.py` (r=8, alpha 16), its adapters
random. With the gate on in both packages: the forward and the
dropout-off gradients (of sum(out * w), w fixed and random: the final
RMSNorm makes sum(out^2) a constant) equal JAX's fused path and the
port's unfused one at 2e-4 (gradients against 2e-4 of each leaf's max).
With dropout 0.1 each group's outputs and gradients equal an eager
autograd formula in which
q / k / v, or gate / up, share the one `dropout_plain` mask of the group's
first seed; a layer drops its input four times in the forward (q's, o's,
gate's and down's seeds), where the gate off drops it seven times; the
recompute of remat draws the same masks, and a sequence slab's group mask
is the whole sequence's at the slab's rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simlingo_tpu.models import qwen2 as jq
from simlingo_tpu_torch.core import gates
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.kernels import dropout as DO
from simlingo_tpu_torch.models import qwen2 as tq

TOL = 2e-4
SEED = 1234


@pytest.fixture(scope="module")
def setup():
    cfg = jq.Qwen2Config(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                         num_kv_heads=2, head_dim=16, intermediate_size=128, lora_r=8,
                         lora_alpha=16, lora_dropout=0.1)
    params = jq.init_params(jax.random.PRNGKey(0), cfg)
    lora = jq.init_lora_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(2)
    lora = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.randn(*x.shape).astype(np.float32) * 0.1), lora)
    x = np.random.RandomState(3).randn(2, 16, 64).astype(np.float32)
    w = np.random.RandomState(4).randn(2, 16, 64).astype(np.float32)
    pos = np.broadcast_to(np.arange(16), (2, 16)).astype(np.int32)
    tcfg = tq.Qwen2Config(**{f.name: getattr(cfg, f.name)
                             for f in dataclasses.fields(tq.Qwen2Config)})
    return dict(cfg=cfg, tcfg=tcfg, params=params, lora=lora, x=x, pos=pos, w=w)


def _port(setup):
    return (params_from_jax(setup["params"], device="cpu"),
            params_from_jax(setup["lora"], device="cpu"),
            torch.from_numpy(setup["x"]), torch.from_numpy(setup["pos"]).long())


def _port_out_and_grads(setup, grads):
    """The port's forward (dropout off) and, with `grads`, the gradients of
    sum(out * w) to every LoRA factor and to the input."""
    params, lora, x, pos = _port(setup)
    leaves = tq.flatten(lora)
    for t in leaves.values():
        t.requires_grad_(grads)
    x.requires_grad_(grads)
    with torch.set_grad_enabled(grads):
        out, _ = tq.forward(params, x, setup["tcfg"], pos, lora_params=lora)
        if not grads:
            return out.numpy(), None
        (out * torch.from_numpy(setup["w"])).sum().backward()
    return out.detach().numpy(), dict({p: t.grad.numpy() for p, t in leaves.items()},
                                      x=x.grad.numpy())


def _jax_out_and_grads(setup):
    cfg, params, pos = setup["cfg"], setup["params"], jnp.asarray(setup["pos"])

    def loss(lp, x):
        out, _ = jq.forward(params, x, cfg, pos, lora_params=lp)
        return jnp.sum(out * setup["w"]), out

    (_, out), (gl, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        setup["lora"], jnp.asarray(setup["x"]))
    flat = tq.flatten(params_from_jax(jax.device_get(gl), device="cpu"))
    return np.asarray(out), dict({p: t.numpy() for p, t in flat.items()}, x=np.asarray(gx))


def _close_grads(got, want, what):
    assert set(got) == set(want)
    for path, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-8)
        np.testing.assert_allclose(got[path] / scale, w / scale, rtol=TOL, atol=TOL,
                                   err_msg=f"{what}: {path}")


@pytest.mark.parametrize("check", ["forward", "grads"])
def test_fused_matches_jax_fused_and_the_port_unfused(setup, monkeypatch, check):
    grads = check == "grads"
    monkeypatch.setenv("SIMLINGO_LORA_FUSED", "0")
    plain_out, plain_g = _port_out_and_grads(setup, grads)
    monkeypatch.setenv("SIMLINGO_LORA_FUSED", "1")
    assert gates.lora_fused() and gates.resolved()["lora_fused"] == "1"
    calls = []
    real = tq._lora_group
    monkeypatch.setattr(tq, "_lora_group", lambda *a, **k: calls.append(a[2]) or real(*a, **k))
    out, g = _port_out_and_grads(setup, grads)
    assert calls == [("q", "k", "v"), ("gate", "up")] * setup["cfg"].num_layers
    jout, jg = _jax_out_and_grads(setup)
    np.testing.assert_allclose(out, jout, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(out, plain_out, rtol=TOL, atol=TOL)
    if grads:
        _close_grads(g, jg, "JAX fused")
        _close_grads(g, plain_g, "port unfused")


@pytest.mark.parametrize("names", [("q", "k", "v"), ("gate", "up")])
def test_dropout_group_shares_one_mask(setup, names):
    """`_lora_group` with dropout 0.1 against eager autograd over the one
    `dropout_plain` mask of the group's seed (layer 0's seeds[names[0]]),
    outputs and every gradient."""
    params, lora, _, _ = _port(setup)
    cfg = setup["tcfg"]
    grp = "attn" if names[0] == "q" else "mlp"
    p, lo = params["layers"]["0"][grp], lora["layers"]["0"]
    seed = tq.layer_seeds(SEED, 0)[names[0]]
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(2, 16, 64, generator=gen)
    cot = {n: torch.randn(2, 16, p[n]["w"].shape[0], generator=gen) for n in names}

    def run(fn):
        xs = x.clone().requires_grad_(True)
        facs = {n: {k: lo[n][k].clone().requires_grad_(True) for k in ("a", "b")}
                for n in names}
        outs = fn(xs, facs)
        sum((o * cot[n]).sum() for n, o in zip(names, outs)).backward()
        return ([o.detach() for o in outs],
                [xs.grad] + [facs[n][k].grad for n in names for k in ("a", "b")])

    def eager(xs, facs):
        xl = DO.dropout_plain(xs, seed, cfg.lora_dropout)      # one mask for the group
        scale = cfg.lora_alpha / cfg.lora_r
        return [F.linear(xs, p[n]["w"], p[n].get("b"))
                + scale * F.linear(F.linear(xl, facs[n]["a"]), facs[n]["b"]) for n in names]

    got = run(lambda xs, facs: tq._lora_group(p, facs, names, xs, cfg, seed))
    want = run(eager)
    assert abs(float(want[0][0].sum()) - float(run(
        lambda xs, facs: tq._lora_group(p, facs, names, xs, cfg, None))[0][0].sum())) > 1e-4
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        scale = max(float(b.abs().max()), 1e-8)
        np.testing.assert_allclose((a / scale).numpy(), (b / scale).numpy(), rtol=TOL,
                                   atol=TOL)


def test_a_layer_drops_four_times_with_the_gate(setup, monkeypatch):
    """A forward and backward with dropout 0.1 drops the input of each
    group and of o and down: 4 x 3 calls a layer with the gate on (seeds q,
    o, gate, down), 7 x 3 with it off."""
    params, lora, x, pos = _port(setup)
    cfg = setup["tcfg"]
    for t in tq.flatten(lora).values():
        t.requires_grad_(True)
    seeds = {}
    real = tq.dropout
    monkeypatch.setattr(tq, "dropout", lambda t, s, *a: seeds.setdefault(s, []).append(
        tuple(t.shape)) or real(t, s, *a))
    counts = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("SIMLINGO_LORA_FUSED", fused)
        seeds.clear()
        out, _ = tq.forward(params, x, cfg, pos, lora_params=lora, dropout_seed=SEED)
        out.sum().backward()
        counts[fused] = sum(len(v) for v in seeds.values())
        if fused == "1":
            want = {tq.layer_seeds(SEED, i)[n] for i in range(cfg.num_layers)
                    for n in ("q", "o", "gate", "down")}
            assert set(seeds) == want and all(len(v) == 3 for v in seeds.values())
    assert counts == {"0": 7 * 3 * cfg.num_layers, "1": 4 * 3 * cfg.num_layers}


@pytest.mark.parametrize("mode", ["remat", "slabs"])
def test_group_masks_hold_under_remat_and_sequence_slabs(setup, monkeypatch, mode):
    """With the gate on and dropout 0.1: "remat", the checkpointed layers'
    loss and LoRA gradients equal remat off's at 1e-6 (the recompute draws
    the groups' masks again, 4 x 4 dropouts a layer); "slabs", each half of
    the sequence, placed as sequence parallelism places a slab (`rows` =
    (first row, T / 2, T)), gives the whole sequence's q / k / v deltas at
    its positions: the group's mask is the one-process mask of its rows."""
    params, lora, x, pos = _port(setup)
    cfg = setup["tcfg"]
    monkeypatch.setenv("SIMLINGO_LORA_FUSED", "1")
    if mode == "slabs":
        p, lo = params["layers"]["0"]["attn"], lora["layers"]["0"]
        seed = tq.layer_seeds(SEED, 0)["q"]
        with torch.no_grad():
            whole = tq._lora_group(p, lo, ("q", "k", "v"), x, cfg, seed)
            B, T = x.shape[:2]
            for i in range(2):
                cut = slice(i * T // 2, (i + 1) * T // 2)
                half = tq._lora_group(p, lo, ("q", "k", "v"), x[:, cut].contiguous(), cfg, seed,
                                      rows=(i * T // 2, T // 2, T))
                for h, w in zip(half, whole):
                    torch.testing.assert_close(h, w[:, cut], rtol=1e-6, atol=1e-6)
        return
    calls = []
    real = tq.dropout
    monkeypatch.setattr(tq, "dropout", lambda *a: calls.append(a[1]) or real(*a))
    got = []
    for remat in (False, True):
        leaves = tq.flatten(lora)
        for t in leaves.values():
            t.grad = None
            t.requires_grad_(True)
        calls.clear()
        out, _ = tq.forward(params, x, cfg, pos, lora_params=lora, dropout_seed=SEED,
                            remat=remat)
        (out * torch.from_numpy(setup["w"])).sum().backward()
        got.append((out.detach(), {p: t.grad.clone() for p, t in leaves.items()}, len(calls)))
    torch.testing.assert_close(got[1][0], got[0][0], rtol=1e-6, atol=1e-6)
    for path, g in got[0][1].items():
        torch.testing.assert_close(got[1][1][path], g, rtol=1e-6, atol=1e-6, msg=path)
    assert (got[0][2], got[1][2]) == (4 * 3 * cfg.num_layers, 4 * 4 * cfg.num_layers)
