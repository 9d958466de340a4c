"""simlingo_tpu_torch model modules against the JAX package (CPU, fp32).

Same weights (the JAX `init_params`, carried across by core/from_jax) and
the same inputs (numpy seeds) through both packages; comparisons at the
package's parity tolerance, atol = rtol = 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.data import image_pipe as jpipe
from simlingo_tpu.data.synthetic import synthetic_example
from simlingo_tpu.models import qwen2 as jq
from simlingo_tpu.models import vit as jvit
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data import image_pipe as tpipe
from simlingo_tpu_torch.models import qwen2 as tq
from simlingo_tpu_torch.models import vit as tvit

TOL = dict(atol=2e-4, rtol=2e-4)


def _tcfg(jcfg, tcls):
    """The port's config dataclass with the JAX config's field values."""
    names = {f.name for f in dataclasses.fields(tcls)}
    return tcls(**{k: v for k, v in dataclasses.asdict(jcfg).items() if k in names})


@pytest.mark.parametrize("wide_heads", [False, True])   # hd=16 / hd=64 branch
def test_vit_extract_features(wide_heads):
    jcfg = jvit.ViTConfig.tiny()
    if wide_heads:
        jcfg = dataclasses.replace(jcfg, hidden_size=128, num_heads=2)
    params = jax.jit(jvit.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    # non-trivial cls / position embeddings
    params["cls_token"] = params["cls_token"] + 0.1
    params["pos_embed"] = params["pos_embed"] + 0.01 * jnp.arange(
        params["pos_embed"].size, dtype=jnp.float32).reshape(
            params["pos_embed"].shape) / params["pos_embed"].size
    imgs = np.random.RandomState(0).randn(2, 56, 56, 3).astype(np.float32)
    ref = np.asarray(jax.jit(jvit.extract_features, static_argnums=2)(
        params, jnp.asarray(imgs), jcfg))
    out = tvit.extract_features(params_from_jax(params, device="cpu"),
                                torch.from_numpy(imgs),
                                _tcfg(jcfg, tvit.ViTConfig))
    assert out.shape == ref.shape == (2, jcfg.tokens_per_patch_image, 64)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.fixture(scope="module")
def qwen():
    """(JAX config with LoRA r=4, JAX params, embeds, valid, positions).
    The LoRA rank only adds the adapters' shapes: the base weights serve
    the tests without LoRA."""
    jcfg = dataclasses.replace(jq.Qwen2Config.tiny(), lora_r=4, lora_alpha=8)
    params = jax.jit(jq.init_params, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    rng = np.random.RandomState(3)
    B, T = 2, 12
    embeds = rng.randn(B, T, jcfg.hidden_size).astype(np.float32)
    valid = np.ones((B, T), bool)
    valid[1, 9:] = False                                  # right padding
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T)).copy()
    return jcfg, params, embeds, valid, pos


def test_qwen2_forward_matches_jax(qwen):
    jcfg, params, embeds, valid, pos = qwen
    ref, _ = jax.jit(jq.forward, static_argnums=2)(
        params, jnp.asarray(embeds), jcfg, jnp.asarray(pos), jnp.asarray(valid))
    out, _ = tq.forward(params_from_jax(params, device="cpu"),
                        torch.from_numpy(embeds), _tcfg(jcfg, tq.Qwen2Config),
                        torch.from_numpy(pos).long(), torch.from_numpy(valid))
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], **TOL)


def test_qwen2_cached_prefill_decode_equals_full_forward(qwen):
    """Prefill T0 tokens into the cache, decode the rest one at a time: the
    hidden states equal the cache-free forward (and JAX's)."""
    jcfg, params, embeds, _, pos = qwen
    cfg = _tcfg(jcfg, tq.Qwen2Config)
    p = params_from_jax(params, device="cpu")
    x = torch.from_numpy(embeds)
    B, T, _ = x.shape
    full, _ = tq.forward(p, x, cfg, torch.from_numpy(pos).long())
    T0 = 8
    cache = tq.init_cache(cfg, B, T, dtype=torch.float32)
    kv_valid = torch.zeros(B, T, dtype=torch.bool)
    kv_valid[:, :T0] = True
    h0, cache = tq.forward(p, x[:, :T0], cfg, torch.from_numpy(pos[:, :T0]).long(),
                           kv_valid=kv_valid, cache=cache)
    steps = [h0]
    for t in range(T0, T):
        kv_valid[:, t] = True
        h, cache = tq.forward(p, x[:, t:t + 1], cfg,
                              torch.from_numpy(pos[:, t:t + 1]).long(),
                              kv_valid=kv_valid, cache=cache)
        steps.append(h)
    assert cache["index"] == T
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(), full.numpy(), **TOL)
    ref, _ = jax.jit(jq.forward, static_argnums=2)(
        params, jnp.asarray(embeds), jcfg, jnp.asarray(pos))
    np.testing.assert_allclose(full.numpy(), np.asarray(ref), **TOL)


def test_qwen2_lora_forward_and_merge_match_jax(qwen):
    jcfg, params, embeds, valid, pos = qwen
    lora = jq.init_lora_params(jax.random.PRNGKey(4), jcfg)
    lora = jax.tree_util.tree_map(lambda a: a + 0.02, lora)   # nonzero B
    cfg = _tcfg(jcfg, tq.Qwen2Config)
    p, tl = (params_from_jax(t, device="cpu") for t in (params, lora))
    args = (torch.from_numpy(embeds), cfg, torch.from_numpy(pos).long(),
            torch.from_numpy(valid))
    ref, _ = jax.jit(lambda p, lp: jq.forward(
        p, jnp.asarray(embeds), jcfg, jnp.asarray(pos), jnp.asarray(valid),
        lora_params=lp))(params, lora)
    out, _ = tq.forward(p, *args, lora_params=tl)
    merged, _ = tq.forward(tq.merge_lora(p, tl, cfg), *args)
    np.testing.assert_allclose(out.numpy()[valid], np.asarray(ref)[valid], **TOL)
    np.testing.assert_allclose(merged.numpy()[valid], np.asarray(ref)[valid], **TOL)
    jm = params_from_jax(jax.jit(jq.merge_lora, static_argnums=2)(params, lora, jcfg),
                         device="cpu")
    tm = tq.merge_lora(p, tl, cfg)
    np.testing.assert_allclose(tm["layers"]["1"]["mlp"]["down"]["w"].numpy(),
                               jm["layers"]["1"]["mlp"]["down"]["w"].numpy(),
                               atol=1e-6)
    # and logits through the tied head
    h = torch.from_numpy(embeds[:, :3])
    np.testing.assert_allclose(
        tq.logits_from_hidden(p, h, cfg).numpy(),
        np.asarray(jax.jit(jq.logits_from_hidden, static_argnums=2)(
            params, jnp.asarray(embeds[:, :3]), jcfg)),
        **TOL)


def test_preprocess_device_matches_jax_cubic_resize():
    """Against jax.image.resize(method="cubic"), which antialiases the
    1024 -> 896 width downscale. Tolerance 2e-5 on normalized values of
    magnitude ~3: the two differ only by fp32 rounding (the resampling
    weights are the same formula, the contraction order differs)."""
    frames = np.random.RandomState(0).randint(0, 256, (1, 512, 1024, 3), np.uint8)
    assert jpipe.device_grid_for(1024, 512) == tpipe.device_grid_for(1024, 512) == (2, 1)
    ref = np.asarray(jpipe.preprocess_device(jnp.asarray(frames), 448, grid=(2, 1)))
    out = tpipe.preprocess_device(torch.from_numpy(frames), 448, grid=(2, 1))
    assert out.shape == ref.shape == (1, 2, 448, 448, 3)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5, rtol=0)


def _leaf_grads_close(got, want, name):
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=max(2e-4 * np.abs(want).max(), 1e-8),
                               err_msg=name)


def test_qwen2_training_grads_match_jax(qwen):
    """The training forward (attention_train, LoRA without dropout): the
    gradients of LoRA factors and input embeddings equal jax.grad's."""
    jcfg, params, embeds, valid, pos = qwen
    lora = jax.tree_util.tree_map(lambda a: a + 0.02,
                                  jq.init_lora_params(jax.random.PRNGKey(5), jcfg))
    cot = np.random.RandomState(6).randn(*embeds.shape).astype(np.float32) * valid[..., None]

    def jloss(lp, x):
        out, _ = jq.forward(params, x, jcfg, jnp.asarray(pos), jnp.asarray(valid),
                            lora_params=lp)
        return (out * cot).sum()
    want_lora, want_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(lora, jnp.asarray(embeds))
    tl = params_from_jax(lora, device="cpu")
    leaves = [ab[k].requires_grad_(True) for layer in tl["layers"].values()
              for ab in layer.values() for k in ("a", "b")]
    x = torch.from_numpy(embeds).requires_grad_(True)
    out, _ = tq.forward(params_from_jax(params, device="cpu"), x,
                        _tcfg(jcfg, tq.Qwen2Config), torch.from_numpy(pos).long(),
                        torch.from_numpy(valid), lora_params=tl)
    (out * torch.from_numpy(cot)).sum().backward()
    _leaf_grads_close(x.grad.numpy(), np.asarray(want_x), "embeds")
    wl = params_from_jax(want_lora, device="cpu")
    for i, layer in tl["layers"].items():
        for name, ab in layer.items():
            for k in ("a", "b"):
                _leaf_grads_close(ab[k].grad.numpy(), wl["layers"][i][name][k].numpy(),
                                  f"{i}/{name}/{k}")
    assert len(leaves) == 2 * 7 * jcfg.num_layers


def test_vit_training_grads_match_jax():
    """InternViT at head_dim 64 (the JAX bt_hd branch): the gradients of
    every vision leaf through attention_train equal jax.grad's."""
    jcfg = dataclasses.replace(jvit.ViTConfig.tiny(), hidden_size=128, num_heads=2,
                               gelu_approximate=True)
    params = jax.jit(jvit.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    imgs = np.random.RandomState(2).randn(2, 56, 56, 3).astype(np.float32)
    cot = np.random.RandomState(3).randn(2, jcfg.tokens_per_patch_image,
                                         64).astype(np.float32)

    def jloss(p):
        return (jvit.extract_features(p, jnp.asarray(imgs), jcfg) * cot).sum()
    want = jax.jit(jax.grad(jloss))(params)
    tp = params_from_jax(params, device="cpu")
    out = tvit.extract_features(_requires_grad(tp), torch.from_numpy(imgs),
                                _tcfg(jcfg, tvit.ViTConfig))
    (out * torch.from_numpy(cot)).sum().backward()
    flat_w = _flat(params_from_jax(want, device="cpu"))
    for path, x in _flat(tp).items():
        _leaf_grads_close(x.grad.numpy(), flat_w[path].numpy(), path)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _requires_grad(tree):
    for x in _flat(tree).values():
        x.requires_grad_(True)
    return tree
