"""simlingo_tpu_torch training path against the JAX package (CPU, fp32).

One JAX-initialised tiny model with LoRA r=4 (B made nonzero so every
adapter has a gradient) and dropout 0 -- the two packages draw different
dropout streams, so the whole-step parity runs without it; dropout itself
is tested in test_torch_dropout.py. Compared: the synthetic batch (exact),
the bridged LoRA tree, `forward_loss` (per-key losses and total at 2e-4),
the trainable gradients (rtol 2e-4, atol 2e-4 max|g| per leaf), the
OneCycle schedule, and three AdamW/OneCycle steps of `make_train_step`
(params at 2e-4); the last three again with both fused-kernel gates on,
and again with the fused LoRA groups (SIMLINGO_LORA_FUSED=1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import example_from_jax, params_from_jax
from simlingo_tpu_torch.data.synthetic import synthetic_example
from simlingo_tpu_torch.models import adaptors as TA
from simlingo_tpu_torch.models import layers as TL
from simlingo_tpu_torch.models import qwen2 as TQ
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.vit import ViTConfig
from simlingo_tpu_torch.train import train_step as tts
from simlingo_tpu_torch.train import trainer

TOL = dict(atol=2e-4, rtol=2e-4)


def _port_cfg(jcfg) -> tsim.SimLingoConfig:
    def conv(obj, cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})
    top = {f.name for f in dataclasses.fields(tsim.SimLingoConfig)} - {"vit", "llm"}
    return tsim.SimLingoConfig(vit=conv(jcfg.vit, ViTConfig),
                               llm=conv(jcfg.llm, Qwen2Config),
                               **{k: getattr(jcfg, k) for k in top})


@pytest.fixture(scope="module")
def setup():
    base = jsim.SimLingoConfig.tiny()
    jcfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, lora_r=4, lora_alpha=8, lora_dropout=0.0))
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02, params["lora"])
    ex = jsynthetic(jcfg, batch=2, seq_len=96, num_patches=1, seed=3)
    return jcfg, params, ex


def _loss_and_grads_jax(jcfg, params, ex):
    """Loss and the gradients of the trainable partition (everything but
    the frozen base LLM, whose leaves may be int8 and take no gradient)."""
    def loss_fn(trainable):
        out, _ = jsim.forward_loss(dict(trainable, llm=params["llm"]), ex, jcfg,
                                   compute_dtype=jnp.float32)
        return out.loss, out.loss_averages
    trainable = {k: v for k, v in params.items() if k != "llm"}
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(trainable)


def test_synthetic_example_identical_to_jax(setup):
    jcfg, _, _ = setup
    for left_pad in (False, True):
        ref = jsynthetic(jcfg, batch=3, seq_len=96, num_patches=2, seed=5,
                         left_pad=left_pad)
        got = synthetic_example(_port_cfg(jcfg), batch=3, seq_len=96, num_patches=2,
                                seed=5, left_pad=left_pad, device="cpu")
        di, gi = ref.driving_input, got.driving_input
        pairs = [(di.pixel_values, gi.pixel_values), (di.vehicle_speed, gi.vehicle_speed),
                 (di.target_point, gi.target_point)]
        pairs += [(getattr(di.prompt, f), getattr(gi.prompt, f))
                  for f in ("ids", "valid", "loss_mask", "ph_slots", "ph_coords")]
        pairs += [(getattr(ref.driving_label, f), getattr(got.driving_label, f))
                  for f in ("waypoints", "path", "waypoints_1d")]
        for want, have in pairs:
            np.testing.assert_array_equal(have.numpy(), np.asarray(want))


def test_params_from_jax_carries_the_lora_tree(setup):
    jcfg, params, _ = setup
    tp = params_from_jax(params, device="cpu")
    assert set(tp) == {"vision", "llm", "adaptors", "wp_encoder", "lora"}
    for i, layer in params["lora"]["layers"].items():
        assert set(layer) == {"q", "k", "v", "o", "gate", "up", "down"}
        for name, ab in layer.items():
            got = tp["lora"]["layers"][i][name]
            np.testing.assert_array_equal(got["a"].numpy(), np.asarray(ab["a"]).T)
            np.testing.assert_array_equal(got["b"].numpy(), np.asarray(ab["b"]).T)
    # peft layout: A [r, in], B [out, r]
    assert tp["lora"]["layers"]["0"]["down"]["a"].shape == (4, jcfg.llm.intermediate_size)
    assert tp["lora"]["layers"]["0"]["q"]["b"].shape == (64, 4)
    # and the port's own init has the same tree and shapes
    own = tsim.init_params(_port_cfg(jcfg), torch.Generator().manual_seed(0), device="cpu")
    shapes = {p: tuple(x.shape) for p, x in tts.flatten(own).items()}
    assert shapes == {p: tuple(x.shape) for p, x in tts.flatten(tp).items()}
    assert all(float(x.abs().max()) == 0 for p, x in tts.flatten(own["lora"]).items()
               if p.endswith("/b"))


@pytest.mark.parametrize("max_answer_len", [160, 0])   # gathered (5 chunks) / full CE
def test_forward_loss_matches_jax(setup, max_answer_len):
    _check_forward_loss(setup, max_answer_len)


def _check_forward_loss(setup, max_answer_len):
    jcfg, params, ex = setup
    jcfg = dataclasses.replace(jcfg, max_answer_len=max_answer_len)
    ref, _ = jax.jit(lambda p: jsim.forward_loss(p, ex, jcfg,
                                                 compute_dtype=jnp.float32))(params)
    out, preds = tsim.forward_loss(params_from_jax(params, device="cpu"),
                                   example_from_jax(ex, device="cpu"), _port_cfg(jcfg))
    assert set(out.loss_averages) == set(ref.loss_averages) == {
        "language_loss", "route_loss", "speed_wps_loss"}
    for key, want in ref.loss_averages.items():
        np.testing.assert_allclose(float(out.loss_averages[key]), float(want),
                                   err_msg=key, **TOL)
        assert int(out.loss_counts[key]) == int(ref.loss_counts[key])
    np.testing.assert_allclose(float(out.loss), float(ref.loss), **TOL)
    assert preds["route"].shape == (2, 20, 2)


def test_trainable_grads_match_jax(setup):
    _check_trainable_grads(setup)


def _check_trainable_grads(setup):
    jcfg, params, ex = setup
    (ref_loss, _), ref_grads = _loss_and_grads_jax(jcfg, params, ex)
    tp = params_from_jax(params, device="cpu")
    leaves = {p: x.requires_grad_(True) for p, x in tts.flatten(tp).items()
              if tts.production_trainable(p)}
    out, _ = tsim.forward_loss(tp, example_from_jax(ex, device="cpu"), _port_cfg(jcfg))
    out.loss.backward()
    np.testing.assert_allclose(out.loss.item(), float(ref_loss), **TOL)
    want = tts.flatten(params_from_jax(ref_grads, device="cpu"))
    assert any(p.startswith("lora/") for p in leaves) and any(
        p.startswith("vision/") for p in leaves)
    for path, x in leaves.items():
        g, w = x.grad.numpy(), want[path].numpy()
        # the floor: the ViT key bias has an identically zero gradient
        # (softmax ignores a shift shared by all keys); both sides hold
        # rounding noise of ~1e-10 there
        np.testing.assert_allclose(g, w, rtol=2e-4,
                                   atol=max(2e-4 * np.abs(w).max(), 1e-8),
                                   err_msg=path)


def test_onecycle_matches_optax():
    for total, pct in ((1000, 0.05), (10, 0.05), (3, 0.5)):
        cfg = tts.OptimizerConfig(lr=3e-5, total_steps=total, pct_start=pct)
        ref = jts.onecycle_schedule(jts.OptimizerConfig(lr=3e-5, total_steps=total,
                                                        pct_start=pct))
        ours = tts.onecycle_schedule(cfg)
        warmup = max(1, int(round(total * pct)))
        for step in (0, 1, warmup, warmup + 1, total // 2, total, total + 5):
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6,
                                       err_msg=f"total {total} step {step}")


def test_three_train_steps_track_jax(setup):
    _check_three_train_steps(setup)


def _check_three_train_steps(setup):
    jcfg, params, ex = setup
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
    start = {p: x.detach().clone() for p, x in state.trainable.items()}
    for i in range(3):
        jstate, jm = jstep(jstate, ex, jax.random.PRNGKey(i))
        m = step(state, batch, i)
        for key in ("loss", "grad_norm", "language_loss", "route_loss"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **TOL)
    assert float(jm["grad_norm"]) > 0.3          # the clip was active
    want = tts.flatten(params_from_jax(jstate["params"], device="cpu"))
    moved = 0.0
    for path, x in tts.flatten(state.params).items():
        assert x.dtype == want[path].dtype, path  # frozen bf16, trainable fp32
        np.testing.assert_allclose(x.detach().float().numpy(),
                                   want[path].float().numpy(), err_msg=path, **TOL)
        if path in start:
            moved = max(moved, float((x.detach() - start[path]).abs().max()))
    assert moved > 1e-3, moved                   # the updates were applied


GATED_CASES = [(check, gate) for gate in ("kernels", "lora_fused")
               for check in ("forward_loss", "grads", "steps")]


@pytest.mark.parametrize("check,gate", GATED_CASES,
                         ids=[c if g == "kernels" else f"{c}-{g}" for c, g in GATED_CASES])
def test_gated_slice_tracks_jax(setup, monkeypatch, check, gate):
    """The same comparisons with a gate set in both packages. "kernels":
    SIMLINGO_CE_IMPL=pallas and SIMLINGO_LN_IMPL=pallas, where JAX runs
    its Pallas kernels (interpret mode) and the port the plain versions of
    its kernels. "lora_fused": SIMLINGO_LORA_FUSED=1, where both run the
    q / k / v and gate / up adapters as groups (JAX's `_fused_lora_delta`,
    the port's `_lora_group`)."""
    calls = []
    if gate == "kernels":
        monkeypatch.setenv("SIMLINGO_CE_IMPL", "pallas")
        monkeypatch.setenv("SIMLINGO_LN_IMPL", "pallas")
        hooks = ((TL.fused_norm, "layernorm_fused"), (TL.fused_norm, "rmsnorm_fused"),
                 (TA, "fused_ce"))
    else:
        monkeypatch.setenv("SIMLINGO_LORA_FUSED", "1")
        hooks = ((TQ, "_lora_group"),)
    for module, name in hooks:
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _n=name, _f=real:
                            calls.append(_n) or _f(*a))
    if check == "forward_loss":
        _check_forward_loss(setup, 160)
    elif check == "grads":
        _check_trainable_grads(setup)
    else:
        _check_three_train_steps(setup)
    assert {name for _, name in hooks} <= set(calls)


def test_trainer_runs_synthetic_overrides_on_cpu(setup, capsys):
    jcfg, _, _ = setup
    cfg = compose(["max_steps=2", "data.batch_size=2", "data.max_text_len=96",
                   "precision=fp32", "seed=7", "output_dir="])
    assert (cfg.max_steps, cfg.data.batch_size, cfg.seed) == (2, 2, 7)
    # JAX's default model (SimLingoConfig(): remat on, no LoRA, exact GELU)
    assert cfg.model == tsim.SimLingoConfig() and cfg.model.llm.lora_r == 0
    cfg.model = dataclasses.replace(_port_cfg(jcfg), llm=dataclasses.replace(
        _port_cfg(jcfg).llm, lora_dropout=0.1))
    res = trainer.train(cfg, make_synthetic=True, device="cpu")
    recs = res["records"]
    assert [r["step"] for r in recs] == [1, 2]
    assert all(np.isfinite([r["loss"], r["grad_norm"]]).all() for r in recs)
    assert "step 2/2 loss=" in capsys.readouterr().out
    with pytest.raises(KeyError):
        compose(["data.no_such_key=1"])
