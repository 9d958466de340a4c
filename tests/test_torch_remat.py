"""Remat in the port (`remat_vision` False / True / "mlp", `remat_llm`)
against its own remat-off run and against JAX's same mode (CPU, fp32).

`SimLingoConfig.tiny()` with LoRA r=4 (B made nonzero), weights from JAX's
`init_params`. Remat changes when values are computed, not what: the
port's loss and every gradient under each mode equal its remat-off run's
at 1e-6 (the counterpart of `tests/test_simlingo_model.py:134`), and JAX's
same mode at 2e-4; three `make_train_step` steps with remat on track
JAX's; with LoRA dropout 0.1 the recomputed layers draw the same masks.
What each mode keeps for the backward is counted through
`saved_tensors_hooks` (plus the tensors a checkpoint region holds as its
inputs), and the hand kernels' calls a step are held to the reckoning
that `chip_smoke.py` holds the card to (`train_launches_per_step`). The C3 repair: the composed
`configs/simlingo.yaml` model equals JAX's field by field.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from simlingo_tpu.core.config import compose as jcompose
from simlingo_tpu.core.config import to_dict as jto_dict
from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core import presets
from simlingo_tpu_torch.core.config import compose, to_dict
from simlingo_tpu_torch.core.from_jax import example_from_jax, params_from_jax
from simlingo_tpu_torch.kernels import flash_attention as TFA
from simlingo_tpu_torch.models import qwen2 as tq
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.models import vit as tvit
from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.vit import ViTConfig
from simlingo_tpu_torch.train import train_step as tts

TOL = dict(atol=2e-4, rtol=2e-4)
SAME = dict(atol=1e-6, rtol=1e-6)
MODES = [(rv, rl) for rv in (False, True, "mlp") for rl in (False, True)]


def _port_cfg(jcfg) -> tsim.SimLingoConfig:
    def conv(obj, cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})
    top = {f.name for f in dataclasses.fields(tsim.SimLingoConfig)} - {"vit", "llm"}
    return tsim.SimLingoConfig(vit=conv(jcfg.vit, ViTConfig), llm=conv(jcfg.llm, Qwen2Config),
                               **{k: getattr(jcfg, k) for k in top})


@pytest.fixture(scope="module")
def setup():
    base = jsim.SimLingoConfig.tiny()
    assert (base.remat_vision, base.remat_llm) == (False, False)
    assert (tsim.SimLingoConfig.tiny().remat_vision, tsim.SimLingoConfig.tiny().remat_llm) \
        == (False, False)
    jcfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, lora_r=4, lora_alpha=8, lora_dropout=0.0))
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02, params["lora"])
    ex = jsynthetic(jcfg, batch=2, seq_len=96, num_patches=2, seed=3)
    return jcfg, params, ex


def _mode(cfg, rv, rl):
    return dataclasses.replace(cfg, remat_vision=rv, remat_llm=rl)


def _port_loss_and_grads(cfg, params, ex, dropout_seed=None, trainable=lambda p: True):
    tp = params_from_jax(params, device="cpu")
    leaves = {p: x.requires_grad_(True) for p, x in tts.flatten(tp).items() if trainable(p)}
    out, _ = tsim.forward_loss(tp, example_from_jax(ex, device="cpu"), cfg,
                               dropout_seed=dropout_seed)
    out.loss.backward()
    return out.loss.item(), {p: x.grad for p, x in leaves.items()}


@pytest.mark.parametrize("rv,rl", MODES[1:])
def test_remat_modes_grad_identical(setup, rv, rl):
    """Every mode's loss and gradients (every leaf, the base LLM's too)
    equal the port's remat-off run at 1e-6."""
    jcfg, params, ex = setup
    cfg = _port_cfg(jcfg)
    l0, g0 = _port_loss_and_grads(cfg, params, ex)
    l1, g1 = _port_loss_and_grads(_mode(cfg, rv, rl), params, ex)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    assert g0.keys() == g1.keys() and any(p.startswith("vision/layers") for p in g0)
    for path, g in g0.items():
        np.testing.assert_allclose(g1[path].numpy(), g.numpy(), err_msg=path, **SAME)


@pytest.mark.parametrize("rv,rl", MODES)
def test_remat_mode_matches_jax(setup, rv, rl):
    """The port's mode against JAX's same mode (its attention as its own
    CPU tests run it): loss and the trainable gradients at 2e-4."""
    jcfg, params, ex = setup
    jcfg = _mode(jcfg, rv, rl)

    def loss_fn(trainable):
        out, _ = jsim.forward_loss(dict(trainable, llm=params["llm"]), ex, jcfg,
                                   compute_dtype=jnp.float32)
        return out.loss
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(
        {k: v for k, v in params.items() if k != "llm"})
    loss, grads = _port_loss_and_grads(_port_cfg(jcfg), params, ex,
                                       trainable=tts.production_trainable)
    np.testing.assert_allclose(loss, float(ref_loss), **TOL)
    want = tts.flatten(params_from_jax(ref_grads, device="cpu"))
    assert want.keys() == grads.keys()
    for path, g in grads.items():
        w = want[path].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-4,
                                   atol=max(2e-4 * np.abs(w).max(), 1e-8), err_msg=path)


def test_three_remat_train_steps_track_jax(setup):
    """JAX's default remat (both towers) through three AdamW / OneCycle
    steps: the losses, grad norms and every parameter at 2e-4."""
    jcfg, params, ex = setup
    jcfg = _mode(jcfg, True, True)
    opt_cfg = dict(lr=1e-3, total_steps=10, grad_clip=0.3)
    mask = jts.trainable_mask(params, jts.production_trainable)
    opt = jts.make_optimizer(jts.OptimizerConfig(**opt_cfg))
    jstate = jts.init_train_state(params, opt, trainable_mask_tree=mask)
    jstep = jts.make_train_step(jcfg, opt, compute_dtype=jnp.float32, donate=False,
                                trainable_mask_tree=mask)
    state = tts.init_train_state(params_from_jax(params, device="cpu"),
                                 tts.OptimizerConfig(**opt_cfg))
    step = tts.make_train_step(_port_cfg(jcfg), tts.OptimizerConfig(**opt_cfg),
                               compute_dtype=torch.float32)
    batch = example_from_jax(ex, device="cpu")
    for i in range(3):
        jstate, jm = jstep(jstate, ex, jax.random.PRNGKey(i))
        m = step(state, batch, i)
        for key in ("loss", "grad_norm", "language_loss", "route_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **TOL)
    want = tts.flatten(params_from_jax(jstate["params"], device="cpu"))
    for path, x in tts.flatten(state.params).items():
        np.testing.assert_allclose(x.detach().float().numpy(), want[path].float().numpy(),
                                   err_msg=path, **TOL)


def _chip_smoke():
    """chip_smoke.py, loaded by path (it imports torch only when run)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


class _Calls:
    """Counts the plain versions' calls of the hand kernels' wrappers:
    the attention forward and backward (training) and LoRA dropout."""

    def __init__(self, monkeypatch):
        self.n = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "dropout": 0}
        for module, name, key in ((TFA, "attention_lse_reference", "flash_attn_fwd"),
                                  (TFA, "attention_bwd_reference", "flash_attn_bwd"),
                                  (tq, "dropout", "dropout")):
            real = getattr(module, name)

            def counted(*a, _real=real, _key=key, **kw):
                self.n[_key] += 1
                return _real(*a, **kw)
            monkeypatch.setattr(module, name, counted)


@pytest.mark.parametrize("rv,rl", MODES)
def test_lora_dropout_masks_are_redrawn_under_recompute(setup, monkeypatch, rv, rl):
    """LoRA dropout 0.1: every mode's loss and gradients equal remat off's
    (so each recomputed layer draws the masks the forward drew), and the
    kernels' calls a step are those `chip_smoke.py` reckons: the attention
    forward twice for a ViT layer under remat True and an LLM layer under
    remat_llm, the backward once a layer, seven dropouts a recomputed LLM
    layer on top of the three a LoRA adapter takes."""
    jcfg, params, ex = setup
    cfg = _mode(_port_cfg(jcfg), False, False)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, lora_dropout=0.1))
    l0, g0 = _port_loss_and_grads(cfg, params, ex, dropout_seed=77)
    l_nodrop, _ = _port_loss_and_grads(cfg, params, ex)
    assert l_nodrop != l0                       # dropout was drawn
    calls = _Calls(monkeypatch)
    l1, g1 = _port_loss_and_grads(_mode(cfg, rv, rl), params, ex, dropout_seed=77)
    assert abs(l1 - l0) <= 1e-6 * abs(l0)
    for path, g in g0.items():
        np.testing.assert_allclose(g1[path].numpy(), g.numpy(), err_msg=path, **SAME)
    V, L = cfg.vit.num_layers, cfg.llm.num_layers
    assert calls.n == {"flash_attn_fwd": V * (2 if rv is True else 1) + L * (2 if rl else 1),
                       "flash_attn_bwd": V + L, "dropout": 7 * L * (4 if rl else 3)}
    assert calls.n == _chip_smoke().train_launches_per_step(_mode(cfg, rv, rl))


def _saved(cfg, params, ex, monkeypatch):
    """What the step keeps for the backward: every tensor autograd saves
    outside a checkpoint region, and every tensor a region takes as an
    input (which it holds); the parameters left out. Returns (bytes, the
    saved tensors)."""
    tp = params_from_jax(params, device="cpu")
    flat = tts.flatten(tp)
    for x in flat.values():
        x.requires_grad_(True)
    param_storages = {x.untyped_storage().data_ptr() for x in flat.values()}
    kept, tensors = {}, []

    def keep(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in param_storages:
            kept[ptr] = t.untyped_storage().nbytes()
            tensors.append(t)

    for module in (tvit, tq):
        real = module.checkpoint

        def held(fn, *args, _real=real, **kw):
            for a in args:
                if isinstance(a, torch.Tensor):
                    keep(a)
            return _real(fn, *args, **kw)
        monkeypatch.setattr(module, "checkpoint", held)

    def pack(t):
        keep(t)
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out, _ = tsim.forward_loss(tp, example_from_jax(ex, device="cpu"), cfg)
    out.loss.backward()
    return sum(kept.values()), tensors


def test_each_mode_keeps_fewer_bytes(setup, monkeypatch):
    """Remat off keeps the most; "mlp" less, True (the ViT's input and
    attention output a layer) less again; remat_llm lowers each. "mlp"
    keeps no GELU output: of the ViT MLP hiddens it keeps one a layer,
    the pre-GELU one, where remat off keeps both."""
    jcfg, params, ex = setup
    cfg = _port_cfg(jcfg)
    saved = {m: _saved(_mode(cfg, *m), params, ex, monkeypatch) for m in MODES}
    nbytes = {m: s[0] for m, s in saved.items()}
    for rl in (False, True):
        assert nbytes[(False, rl)] > nbytes[("mlp", rl)] > nbytes[(True, rl)], nbytes
    for rv in (False, True, "mlp"):
        assert nbytes[(rv, False)] > nbytes[(rv, True)], nbytes
    # the ViT MLP's [tiles, T, intermediate] hiddens (linear saves a 2-D view)
    numel = ex.driving_input.pixel_values.shape[0] * ex.driving_input.pixel_values.shape[1] \
        * (cfg.vit.num_patches + 1) * cfg.vit.intermediate_size
    hidden = lambda ts: [t for t in ts if t.numel() == numel
                         and t.shape[-1] == cfg.vit.intermediate_size]
    off, mlp = hidden(saved[(False, False)][1]), hidden(saved[("mlp", False)][1])
    assert len(off) == 2 * cfg.vit.num_layers and len(mlp) == cfg.vit.num_layers

    def gelu_outputs(ts):
        return [a for a in ts if any(torch.equal(a.reshape(-1), F.gelu(b).reshape(-1))
                                     for b in ts if b is not a)]
    assert len(gelu_outputs(off)) == cfg.vit.num_layers and not gelu_outputs(mlp)


def test_compose_trains_jax_default_model():
    """C3: `compose("configs/simlingo.yaml")`'s model is JAX's composed
    model field by field -- SimLingoConfig(): remat on in both towers, no
    LoRA, the exact GELU -- and the remat keys compose as JAX's do."""
    for ov in ([], ["model.remat_vision=false", "model.remat_llm=0"]):
        t = to_dict(compose("configs/simlingo.yaml", ov).model)
        j = jto_dict(jcompose("configs/simlingo.yaml", ov).model)
        assert t == j, {k: (t.get(k), j.get(k)) for k in set(t) | set(j) if t.get(k) != j.get(k)}
    m = compose("configs/simlingo.yaml").model
    assert (m.remat_vision, m.remat_llm, m.llm.lora_r, m.vit.gelu_approximate) == \
        (True, True, 0, False)
    assert compose(["model.remat_llm=false"]).model.remat_llm is False
    p = presets.internvl2_1b(lora=True)
    assert (p.remat_vision, p.remat_llm, p.llm.lora_r) == (True, True, 32)
