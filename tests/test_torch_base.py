"""SimLingo-Base (CarLLaVA) in simlingo_tpu_torch against the JAX package
(CPU, fp32).

The tiny configuration (CLIP 64 wide, 3 layers of which 2 run; the
`debug` LLaMA), initialised by JAX and bridged with `params_from_jax`.
Compared at 2e-4: `clip_vit.encode` and `llava_features`, the forward's
waypoints, `forward_loss`'s losses and every gradient; three steps of the
two-group step against the optax chain of `train_base.py:53-67` rebuilt
here (losses, parameters and both Adam moments: a single clip over the
whole tree scales the moments of one group by another factor); the plain
attention and its backward against JAX's Pallas `_fwd_kernel` /
`_bwd_kernel` (group 1, interpret mode) at 1e-4; `base_batch` against
`train_base.py`'s own draws; the kernels' plans at the full-width shapes
(CLIP [32, 577, 16, 64], LLaMA [16, 333, 8, 64], LayerNorm [18464,
1024], RMSNorm [5328, 512]); and `train_base_torch.py` on the CPU.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from simlingo_tpu.kernels import flash_attention as JFA
from simlingo_tpu.models import clip_vit as jclip
from simlingo_tpu.models import resnet as jresnet
from simlingo_tpu.models import simlingo_base as jbase
from simlingo_tpu.parallel.mesh import _path_str
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core import presets
from simlingo_tpu_torch.core.config import compose_base
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.synthetic import base_batch
from simlingo_tpu_torch.kernels import flash_attention as TFA
from simlingo_tpu_torch.kernels import layernorm as TLN
from simlingo_tpu_torch.models import clip_vit as tclip
from simlingo_tpu_torch.models import llama as tllama
from simlingo_tpu_torch.models import resnet as tresnet
from simlingo_tpu_torch.models import simlingo_base as tbase
from simlingo_tpu_torch.train import base_step
from simlingo_tpu_torch.train import train_step as tts

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=2e-4, rtol=2e-4)
SMS = 132


def _close(got, want, err_msg="", **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               err_msg=err_msg, **(tol or TOL))


@pytest.fixture(scope="module")
def setup():
    jcfg = jbase.SimLingoBaseConfig.tiny()
    params = jax.jit(jbase.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    rng = np.random.RandomState(3)
    batches = [tuple(x.numpy() for x in base_batch(rng, 2, jcfg.clip.image_size,
                                                   device="cpu"))
               for _ in range(3)]
    return jcfg, params, batches


def _torch(batch):
    return tuple(torch.from_numpy(x) for x in batch)


# ---------------------------------------------------------------------------
# attention: group 1, the path of `_fwd_kernel` :114 and `_bwd_kernel` :205
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,causal", [(37, False), (45, True)])
def test_attention_group_one_matches_pallas_fwd_and_bwd(T, causal):
    rng = np.random.RandomState(T)
    q, k, v, dout = (rng.randn(2, T, 2, 64).astype(np.float32) for _ in range(4))

    def jfwd(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, None, causal=causal, layout="bthd")
    want, vjp = jax.vjp(jfwd, *(jnp.asarray(x) for x in (q, k, v)))
    want_grads = vjp(jnp.asarray(dout))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, dout))
    out = TFA.attention_reference(tq, tk, tv, None, causal)
    _close(out, want, atol=1e-4, rtol=1e-4)
    lse = TFA.attention_lse_reference(tq, tk, None, causal)
    got = TFA.attention_bwd_reference(tq, tk, tv, None, out, tdo, lse, causal)
    for g, w, name in zip(got, want_grads, "qkv"):
        _close(g, w, f"d{name}", atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_params_tree_and_config_match_jax(setup):
    jcfg, params, _ = setup
    tp = params_from_jax(params, device="cpu")
    own = tbase.init_params(tbase.SimLingoBaseConfig.tiny(), torch.Generator().manual_seed(0),
                            device="cpu")
    shapes = {p: tuple(x.shape) for p, x in tts.flatten(tp).items()}
    assert shapes == {p: tuple(x.shape) for p, x in tts.flatten(own).items()}
    assert shapes["vision/patch_embed/w"] == (64, 14 * 14 * 3)       # transposed
    assert shapes["llm/embed/w"] == (1, 32) and shapes["image_newline"] == (96,)
    np.testing.assert_array_equal(tp["vision"]["pos_embed"].numpy(),
                                  np.asarray(params["vision"]["pos_embed"]))
    full = tbase.SimLingoBaseConfig()
    assert dataclasses.asdict(full.llm) == dataclasses.asdict(jbase.SimLingoBaseConfig().llm)
    assert (full.llm.head_dim, full.llm.num_kv_heads, full.clip.layers_run) == (64, 8, 23)
    assert tbase.SimLingoBaseConfig(encoder="resnet").resnet == tresnet.ResNetConfig()
    with pytest.raises(ValueError, match="encoder"):
        tbase.SimLingoBaseConfig(encoder="vit")


@pytest.mark.parametrize("variant", sorted(tllama.CONFIGS))
def test_every_llama_variant_matches_jax(variant):
    """Each LLaMA variant is JAX's, at a head dim the attention kernels are
    built at (16 for `debug`, 64 for `tiny`, 128 past it)."""
    got = tbase.SimLingoBaseConfig(llm_variant=variant).llm
    assert dataclasses.asdict(got) == dataclasses.asdict(
        jbase.SimLingoBaseConfig(llm_variant=variant).llm)
    assert got.head_dim in TFA.HEAD_DIMS


def test_clip_encode_and_llava_features_match_jax(setup):
    jcfg, params, batches = setup
    px = batches[0][0]
    vp = params["vision"]
    tp = params_from_jax(vp, device="cpu")
    images = px.reshape((-1,) + px.shape[2:])
    _close(tclip.encode(tp, torch.from_numpy(images), tbase.SimLingoBaseConfig.tiny().clip),
           jclip.encode(vp, jnp.asarray(images), jcfg.clip))
    newline = params["image_newline"]
    got = tclip.llava_features(tp, torch.from_numpy(px), tbase.SimLingoBaseConfig.tiny().clip,
                               torch.from_numpy(np.array(newline)))
    want = jclip.llava_features(vp, jnp.asarray(px), jcfg.clip, newline)
    assert got.shape == want.shape == (2, 2 * 5, 96)
    _close(got, want)


def test_forward_waypoints_match_jax(setup):
    jcfg, params, batches = setup
    px, speed, tps = batches[0][:3]
    want = jax.jit(lambda p, *a: jbase.forward(p, *a, jcfg))(params, px, speed, tps)
    got = tbase.forward(params_from_jax(params, device="cpu"),
                        *_torch((px, speed, tps)), tbase.SimLingoBaseConfig.tiny())
    assert set(got) == set(want) == {"route", "speed_wps"}
    for key in want:
        _close(got[key], want[key], key)


def _jax_loss(jcfg):
    def loss_fn(p, px, speed, tps, wps, route):
        out, _ = jbase.forward_loss(p, px, speed, tps, wps, route, jcfg)
        return out.loss, out.loss_averages
    return loss_fn


def test_forward_loss_and_every_gradient_match_jax(setup):
    jcfg, params, batches = setup
    (ref_loss, ref_avg), ref_grads = jax.jit(jax.value_and_grad(
        _jax_loss(jcfg), has_aux=True))(params, *batches[0])
    tp = tts.map_leaves(lambda _, x: x.requires_grad_(True),
                        params_from_jax(params, device="cpu"))
    out, preds = tbase.forward_loss(tp, *_torch(batches[0]), tbase.SimLingoBaseConfig.tiny())
    assert set(out.loss_averages) == set(ref_avg) == {"route_loss", "speed_wps_loss"}
    for key, want in ref_avg.items():
        _close(out.loss_averages[key], want, key)
    _close(out.loss, ref_loss)
    assert preds["route"].shape == (2, 20, 2)
    out.loss.backward()
    want = tts.flatten(params_from_jax(ref_grads, device="cpu"))
    leaves = tts.flatten(tp)
    assert set(leaves) == set(want)
    unused = {p for p in leaves if p.startswith("vision/layers/2/") or p == "llm/embed/w"}
    for path, x in leaves.items():
        w = want[path].numpy()
        if path in unused:                 # past the feature layer / the removed vocabulary
            assert x.grad is None and not w.any(), path
            continue
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=2e-4,
                                   atol=max(2e-4 * np.abs(w).max(), 1e-8), err_msg=path)


# ---------------------------------------------------------------------------
# the two-group step
# ---------------------------------------------------------------------------

def _optax_chain(params, opt_cfg):
    """`train_base.py:53-67`: vision at lr x 0.1 and the rest, each a
    masked `make_optimizer` (clip inside)."""
    def lr_mask(vision):
        return jax.tree_util.tree_map_with_path(
            lambda p, _: _path_str(p).startswith("vision") == vision, params)
    vision_cfg = dataclasses.replace(opt_cfg, lr=opt_cfg.lr * 0.1)
    return optax.chain(optax.masked(jts.make_optimizer(vision_cfg), lr_mask(True)),
                       optax.masked(jts.make_optimizer(opt_cfg), lr_mask(False)))


def _adam_moments(opt_state):
    """{path: (mu, nu)} over both masked Adam states."""
    out = {}
    for st in jax.tree_util.tree_leaves(
            opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if not isinstance(st, optax.ScaleByAdamState):
            continue
        mu, _ = jax.tree_util.tree_flatten_with_path(st.mu)
        nu = dict(jax.tree_util.tree_flatten_with_path(st.nu)[0])
        for path, m in mu:
            out[_path_str(path)] = (m, nu[path])
    return out


def _bridged(flat_jax, params):
    """{path: array} in the JAX layout -> the port's layout (linears
    transposed), through the bridge."""
    tree = {}
    for path, x in flat_jax.items():
        node = tree
        *parents, last = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = np.asarray(x)
    return tts.flatten(params_from_jax(tree, device="cpu"))


def test_three_base_steps_track_the_optax_chain(setup):
    jcfg, params, batches = setup
    opt_cfg = dict(lr=1e-3, total_steps=10, grad_clip=1.0)
    opt = _optax_chain(params, jts.OptimizerConfig(**opt_cfg))
    loss_fn = _jax_loss(jcfg)

    @jax.jit
    def jstep(p, o, *batch):
        (loss, avg), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, *batch)
        updates, o = opt.update(grads, o, p)
        norms = [optax.global_norm({k: v for k, v in grads.items() if (k == "vision") == vis})
                 for vis in (True, False)]
        return optax.apply_updates(p, updates), o, dict(avg, loss=loss), norms

    jp, jo = params, opt.init(params)
    state = base_step.init_base_state(params_from_jax(params, device="cpu"),
                                      tts.OptimizerConfig(**opt_cfg))
    step = base_step.make_base_train_step(tbase.SimLingoBaseConfig.tiny(),
                                          tts.OptimizerConfig(**opt_cfg),
                                          compute_dtype=torch.float32)
    start = {p: x.detach().clone() for p, x in tts.flatten(state.params).items()}
    for batch in batches:
        jp, jo, jm, norms = jstep(jp, jo, *batch)
        m = step(state, _torch(batch))
        for key in ("loss", "route_loss", "speed_wps_loss"):
            _close(m[key], jm[key], key)
        _close(m["grad_norm_vision"], norms[0])
        _close(m["grad_norm_rest"], norms[1])
        # both groups clipped, by factors a shared clip would not give
        assert min(float(n) for n in norms) > opt_cfg["grad_clip"]
        assert abs(float(norms[0]) / float(norms[1]) - 1) > 0.2
    want = tts.flatten(params_from_jax(jp, device="cpu"))
    moved = {"vision": 0.0, "rest": 0.0}
    for path, x in tts.flatten(state.params).items():
        assert x.dtype == torch.float32, path
        _close(x, want[path].numpy(), path)
        group = base_step.group_of(path)
        moved[group] = max(moved[group], float((x.detach() - start[path]).abs().max()))
    assert moved["rest"] > 1e-3 and 1e-4 < moved["vision"] < 1e-3, moved   # lr x 0.1
    moments = _adam_moments(jo)
    mus = _bridged({p: m for p, (m, _) in moments.items()}, params)
    nus = _bridged({p: n for p, (_, n) in moments.items()}, params)
    leaves = tts.flatten(state.params)
    assert set(mus) == set(leaves)
    # the floors: the key bias's gradient is identically zero (softmax
    # ignores a shift shared by all keys); both sides hold rounding noise of
    # ~1e-11 there, against moments of ~1e-4 (mu) and ~1e-8 (nu) elsewhere
    for path, x in leaves.items():
        st = state.optimizer.state[x]
        w_mu, w_nu = mus[path].numpy(), nus[path].numpy()
        np.testing.assert_allclose(st["exp_avg"].numpy(), w_mu, rtol=2e-4,
                                   atol=max(2e-4 * np.abs(w_mu).max(), 1e-10), err_msg=path)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), w_nu, rtol=2e-4,
                                   atol=max(2e-4 * np.abs(w_nu).max(), 1e-18), err_msg=path)


# ---------------------------------------------------------------------------
# the ResNet encoder (encoder="resnet"): ResNet-18 16 wide, 48-wide tokens
# (so `language_projection` to the debug LLaMA's 32), 64-pixel tiles: 2 x 2
# tokens a tile, 8 + 33 = 41 tokens
# ---------------------------------------------------------------------------

RESNET_TILE = 64


def _resnet_cfgs():
    return (jbase.SimLingoBaseConfig(llm_variant="debug", encoder="resnet",
                                     resnet=jresnet.ResNetConfig(width=16, token_size=48)),
            tbase.SimLingoBaseConfig(llm_variant="debug", encoder="resnet",
                                     resnet=tresnet.ResNetConfig(width=16, token_size=48)))


@pytest.fixture(scope="module")
def resnet_setup():
    """(JAX config, port config, JAX params with running statistics away
    from 0 / 1, three batches)."""
    jcfg, tcfg = _resnet_cfgs()
    params = jax.jit(jbase.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    rng = np.random.RandomState(5)
    params["bn_state"] = jax.tree_util.tree_map(
        lambda x: x + 0.3 * np.abs(rng.randn(*x.shape)).astype(np.float32), params["bn_state"])
    batches = [tuple(x.numpy() for x in base_batch(rng, 2, RESNET_TILE, device="cpu"))
               for _ in range(3)]
    return jcfg, tcfg, params, batches


def test_resnet_params_tree_matches_jax(resnet_setup):
    _, tcfg, params, _ = resnet_setup
    tp = tts.flatten(params_from_jax(params, device="cpu"))
    own = tts.flatten(tbase.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu"))
    assert {p: tuple(x.shape) for p, x in tp.items()} == \
        {p: tuple(x.shape) for p, x in own.items()}
    assert tp["vision/stem/conv"].shape == (16, 3, 7, 7)                # [out, in, kh, kw]
    assert tp["language_projection/w"].shape == (32, 48)
    assert tp["bn_state/stages/3/0/down_bn/var"].shape == (128,)
    assert not any(p.startswith(("image_newline", "temporal", "camera")) for p in own)
    assert {base_step.group_of(p) for p in own if p.startswith("bn_state/")} == {"rest"}


def test_resnet_forward_waypoints_match_jax(resnet_setup):
    jcfg, tcfg, params, batches = resnet_setup
    px, speed, tps = batches[0][:3]
    want = jax.jit(lambda p, *a: jbase.forward(p, *a, jcfg))(params, px, speed, tps)
    vis = tbase.vision_tokens(params_from_jax(params, device="cpu"), torch.from_numpy(px), tcfg)
    assert vis.shape == (2, 2 * 2 * 2, 32)
    got = tbase.forward(params_from_jax(params, device="cpu"), *_torch((px, speed, tps)), tcfg)
    for key in want:
        _close(got[key], want[key], key)


def test_resnet_forward_loss_and_every_gradient_match_jax(resnet_setup):
    """Every leaf's gradient, `bn_state`'s included: the encoder reads the
    running statistics in evaluation mode, so both frameworks differentiate
    them."""
    jcfg, tcfg, params, batches = resnet_setup
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(
        _jax_loss(jcfg), has_aux=True))(params, *batches[0])
    tp = tts.map_leaves(lambda _, x: x.requires_grad_(True),
                        params_from_jax(params, device="cpu"))
    out, _ = tbase.forward_loss(tp, *_torch(batches[0]), tcfg)
    _close(out.loss, ref_loss)
    out.loss.backward()
    want = tts.flatten(params_from_jax(ref_grads, device="cpu"))
    bn_grads = 0.0
    for path, x in tts.flatten(tp).items():
        w = want[path].numpy()
        if path == "llm/embed/w":              # the removed vocabulary
            assert x.grad is None and not w.any()
            continue
        np.testing.assert_allclose(x.grad.numpy(), w, rtol=2e-4,
                                   atol=max(2e-4 * np.abs(w).max(), 1e-8), err_msg=path)
        if path.startswith("bn_state/"):
            bn_grads = max(bn_grads, float(np.abs(w).max()))
    assert bn_grads > 1e-4


def test_three_resnet_base_steps_track_the_optax_chain(resnet_setup):
    """Three two-group steps against `train_base.py`'s optax chain: after
    each, the losses and every leaf -- the running statistics, which AdamW
    moves by their gradients and decays, included -- at 2e-4."""
    jcfg, tcfg, params, batches = resnet_setup
    opt_cfg = dict(lr=1e-3, total_steps=10, grad_clip=1.0)
    opt = _optax_chain(params, jts.OptimizerConfig(**opt_cfg))
    loss_fn = _jax_loss(jcfg)

    @jax.jit
    def jstep(p, o, *batch):
        (loss, avg), grads = jax.value_and_grad(loss_fn, has_aux=True)(p, *batch)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), o, dict(avg, loss=loss)

    jp, jo = params, opt.init(params)
    state = base_step.init_base_state(params_from_jax(params, device="cpu"),
                                      tts.OptimizerConfig(**opt_cfg))
    step = base_step.make_base_train_step(tcfg, tts.OptimizerConfig(**opt_cfg),
                                          compute_dtype=torch.float32)
    start = {p: x.detach().clone() for p, x in tts.flatten(state.params).items()}
    for batch in batches:
        jp, jo, jm = jstep(jp, jo, *batch)
        m = step(state, _torch(batch))
        for key in ("loss", "route_loss", "speed_wps_loss"):
            _close(m[key], jm[key], key)
        want = tts.flatten(params_from_jax(jp, device="cpu"))
        for path, x in tts.flatten(state.params).items():
            _close(x, want[path].numpy(), path)
    moved = max(float((x.detach() - start[p]).abs().max())
                for p, x in tts.flatten(state.params).items() if p.startswith("bn_state/"))
    assert moved > 1e-3                      # lr 1e-3: Adam steps, not the decay alone


def test_group_of_is_the_vision_prefix():
    assert base_step.group_of("vision/layers/0/attn/q/w") == "vision"
    for path in ("image_newline", "temporal_encoding", "camera_encoding",
                 "language_projection/w", "llm/layers/0/ln1/scale", "adaptors/speed_queries"):
        assert base_step.group_of(path) == "rest"


# ---------------------------------------------------------------------------
# data, presets and the entry point
# ---------------------------------------------------------------------------

def _train_base_draws(rng, B, S):
    """The batch lines of `train_base.py`'s loop, run as written there."""
    src = (ROOT / "train_base.py").read_text()
    body = src[src.index("for it in range(total_steps):"):src.index("params, opt_state, metrics")]
    lines = [ln.strip() for ln in body.splitlines() if "= jnp.asarray(" in ln]
    assert [ln.split(" =")[0] for ln in lines] == ["px", "speed", "tps", "wps", "route"]
    scope = dict(rng=rng, B=B, S=S, np=np, jnp=np)
    for ln in lines:
        exec(ln, scope)
    return [scope[n] for n in ("px", "speed", "tps", "wps", "route")]


def test_base_batch_equals_train_base_draws():
    a, b = np.random.RandomState(42), np.random.RandomState(42)
    for _ in range(2):                   # consecutive batches too
        want = _train_base_draws(a, 3, 28)
        got = base_batch(b, 3, 28, device="cpu")
        for w, g in zip(want, got):
            assert g.dtype == torch.float32
            np.testing.assert_array_equal(g.numpy(), w)


def test_preset_is_the_yaml_overlay():
    text = (ROOT / "configs" / "simlingo_base.yaml").read_text()
    yaml = dict(re.findall(r"^\s*(seed|lr|pct_start|grad_clip|batch_size): ([\d.e+-]+)$",
                           text, re.M))
    cfg = presets.simlingo_base()
    assert (cfg.seed, cfg.optimizer.lr, cfg.optimizer.pct_start, cfg.optimizer.grad_clip,
            cfg.data.batch_size) == (int(yaml["seed"]), float(yaml["lr"]),
                                     float(yaml["pct_start"]), float(yaml["grad_clip"]),
                                     int(yaml["batch_size"]))
    assert cfg.model == tbase.SimLingoBaseConfig() and base_step.VISION_LR_SCALE == 0.1
    assert cfg == compose_base("configs/simlingo_base.yaml")
    assert (cfg.name, cfg.max_epochs) == ("simlingo_base", 30)
    # without the experiment: TrainConfig()'s defaults, as train_base.py:40
    plain = compose_base(["max_steps=2", "optimizer.lr=0.5"])
    assert plain.optimizer.lr == 0.5 and plain.max_steps == 2
    assert (plain.data.batch_size, plain.optimizer.grad_clip) == (6, 0.3)


@pytest.mark.parametrize("experiment", [None, "configs/simlingo_base.yaml"])
def test_compose_base_matches_train_base_compose(experiment):
    """`train_base.py:40` composes JAX's TrainConfig; compose_base gives the
    same value on every field both configs have (the model apart: the
    base stack's), without and with the experiment."""
    from simlingo_tpu.core.config import compose as jcompose
    from simlingo_tpu.core.config import to_dict as jto_dict
    from simlingo_tpu_torch.core.config import to_dict
    from tests.test_torch_trainer_disk import _flat
    ov = ["max_steps=3", "seed=7"]
    j = _flat(jto_dict(jcompose(experiment, ov)))
    t = _flat(to_dict(compose_base(experiment, ov)))
    shared = {k for k in set(j) & set(t) if not k.startswith("model.")}
    assert {"seed", "name", "output_dir", "max_epochs", "max_steps", "precision",
            "data.batch_size", "optimizer.lr", "optimizer.grad_clip",
            "data.base.use_qa"} <= shared
    norm = lambda v: list(v) if isinstance(v, tuple) else v      # noqa: E731
    assert {k: (j[k], t[k]) for k in shared if norm(j[k]) != norm(t[k])} == {}
    want = (16, 1e-4, 1.0) if experiment else (6, 3e-5, 0.3)
    cfg = compose_base(experiment, ov)
    assert (cfg.data.batch_size, cfg.optimizer.lr, cfg.optimizer.grad_clip) == want


# (name, B, T, HQ, causal, scratch bytes)
PATH_ATTENTION = [("clip", 32, 577, 16, False, 419_430_400),
                  ("base_llm", 16, 333, 8, True, 37_748_736)]


@pytest.mark.parametrize("name,B,T,H,causal,ds_bytes", PATH_ATTENTION)
def test_attention_plans_at_the_full_width_shapes(name, B, T, H, causal, ds_bytes):
    fwd = TFA._fwd_plan(B, T, T, H, H, causal, 0, sms=SMS)
    assert fwd.path == "tiled" and fwd.grid == (-(-T // 64), H, B) and fwd.kv_end == T
    assert fwd.remainder == causal          # the LLaMA's first rows see 1-63 keys
    bwd = TFA._bwd_plan(B, T, T, H, H, causal, 0)
    assert bwd.ds_bytes == ds_bytes and bwd.ds_shape[2:4] == (-(-T // 64), -(-T // 64))
    n = -(-T // 64)
    assert len(bwd.written) == (n * (n + 1) // 2 if causal else n * n)
    assert TFA._dkdv_blocks(B, T, H, SMS) == 3


@pytest.mark.parametrize("n,d,fwd,bwd,dx_only", [
    (18464, 1024, (256, 2308, False), (132,), (264,)),     # CLIP LayerNorm, 32 x 577
    (5328, 512, (256, 666, False), (264,), (264,))])       # LLaMA RMSNorm, 16 x 333
def test_norm_plans_at_the_full_width_shapes(n, d, fwd, bwd, dx_only):
    assert tuple(TLN._norm_fwd_plan(n, d, SMS)) == fwd
    assert tuple(TLN._norm_bwd_plan(n, d, SMS, sums=True)) == bwd
    assert tuple(TLN._norm_bwd_plan(n, d, SMS, sums=False)) == dx_only


def test_train_base_torch_runs_on_cpu_and_refuses_cuda_without_gpu(tmp_path):
    """The CLI as train_base.py runs: TrainConfig()'s defaults, and the run
    directory outputs/<name>_base with config.json and the final
    checkpoint, in the working directory."""
    run = [sys.executable, str(ROOT / "train_base_torch.py"), "--synthetic", "--tiny"]
    res = subprocess.run(run + ["--device", "cpu", "max_steps=2", "data.batch_size=2"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert re.search(r"^step 1/2 loss=\d+\.\d{4}", res.stdout, re.M), res.stdout
    assert "step 2/2 loss=" in res.stdout and "done: checkpoint" in res.stdout
    run_dir = tmp_path / "outputs" / "simlingo_tpu_base"
    config = json.loads((run_dir / "config.json").read_text())
    assert (config["optimizer"]["lr"], config["optimizer"]["grad_clip"]) == (3e-5, 0.3)
    assert os.listdir(run_dir / "checkpoints") == ["step_00000002"]
    if not torch.cuda.is_available():
        res = subprocess.run(run + ["max_steps=1", "output_dir="], cwd=tmp_path,
                             capture_output=True, text=True, timeout=240)
        assert res.returncode != 0 and "no CUDA GPU" in res.stderr
