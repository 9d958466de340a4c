"""The port's checkpoints and HF / torch weight import (CPU).

`load_hf_checkpoint` on the raw-InternVL2, the trained-SimLingo (peft
LoRA merged) and the unmerged-LoRA layouts -- state dicts built in code as
`tests/test_hf_checkpoint.py` builds them, as `.pt` and as `.safetensors`
-- equals `params_from_jax` of JAX's `load_hf_checkpoint`: exactly for
copied leaves, to 1e-6 for merged ones. The `.safetensors` reader equals
the `safetensors` package. Saves are atomic (a partial directory is never
listed), keep-N holds, async saves land, a restore gives back the state,
and a failed final save keeps the trained state and reports it.
"""

import json
import os

import pytest
import torch

from simlingo_tpu.core import checkpoint as jckpt
from simlingo_tpu_torch.core import checkpoint as ckpt
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.train import train_step as tts
from simlingo_tpu_torch.train import trainer as TT
from tests.test_hf_checkpoint import (_make_llm_state_dict,
                                      _make_remote_code_state_dict,
                                      _make_trained_sd, _tiny_cfg)
from tests.test_torch_train import _port_cfg


def _state_dict(layout):
    cfg = _tiny_cfg()
    torch.manual_seed(0)
    if layout == "raw_internvl2":
        return cfg, {**_make_remote_code_state_dict(cfg), **_make_llm_state_dict(cfg)}
    sd, _ = _make_trained_sd(cfg, lora_b_zero=False)
    return cfg, sd


def _merged_paths(sd):
    """The port paths of leaves that a LoRA merge changes."""
    out = set()
    for k in sd:
        if ".lora_A." in k:
            layer = k.split("layers.")[1].split(".")[0]
            proj = k.split(".lora_A.")[0].rsplit(".", 1)[1].replace("_proj", "")
            out.add(f"llm/layers/{layer}/attn/{proj}/w")
    return out


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
@pytest.mark.parametrize("layout,merge", [("raw_internvl2", True), ("simlingo_lora", True),
                                          ("simlingo_lora", False)])
def test_hf_import_matches_jax(tmp_path, layout, merge, fmt):
    jcfg, sd = _state_dict(layout)
    if fmt == "pt":
        path = str(tmp_path / "pytorch_model.pt")
        torch.save(sd, path)
    else:
        from safetensors.torch import save_file
        path = str(tmp_path)
        save_file({k: v.contiguous() for k, v in sd.items()},
                  str(tmp_path / "model.safetensors"))
    ref = tts.flatten(params_from_jax(jckpt.load_hf_checkpoint(
        path, jcfg, lora_merge=merge, lora_alpha=8.0, lora_r=2), device="cpu"))
    got = tts.flatten(ckpt.load_hf_checkpoint(path, _port_cfg(jcfg), lora_merge=merge,
                                              lora_alpha=8.0, lora_r=2))
    assert set(got) == set(ref)
    merged = _merged_paths(sd) if merge else set()
    assert merged or layout == "raw_internvl2" or not merge
    for p, want in ref.items():
        assert got[p].dtype == torch.float32 and got[p].shape == want.shape, p
        if p in merged:
            torch.testing.assert_close(got[p], want, rtol=0, atol=1e-6)
        else:
            assert torch.equal(got[p], want), p
    if layout == "simlingo_lora" and not merge:
        assert "lora/layers/0/q/a" in got and got["lora/layers/0/q/a"].shape == (2, 48)
    # a transposed (here: untransposed torch-layout) linear is the file's tensor
    key = ("vision_model.model." if layout != "raw_internvl2" else "") + \
        "vision_model.encoder.layers.1.attn.proj.weight"
    assert torch.equal(got["vision/layers/1/attn/o/w"], sd[key].float())


def test_safetensors_reader_matches_package(tmp_path):
    from safetensors.torch import load_file, save_file
    g = torch.Generator().manual_seed(1)
    sd = {"f32": torch.randn(3, 5, generator=g), "bf16": torch.randn(7, generator=g).bfloat16(),
          "f16": torch.randn(2, 3, generator=g).half(), "i64": torch.arange(5),
          "i8": torch.arange(-3, 4, dtype=torch.int8), "u8": torch.arange(3, dtype=torch.uint8),
          "b": torch.tensor([True, False, True]), "scalar": torch.tensor(2.5),
          "empty": torch.zeros(0, 4)}
    path = str(tmp_path / "x.safetensors")
    save_file(sd, path, metadata={"format": "pt"})
    ref, got = load_file(path), ckpt.read_safetensors(path)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
        assert torch.equal(got[k], ref[k]), k


def _tiny_state(seed=0):
    cfg = tsim.SimLingoConfig.tiny()
    params = tsim.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu")
    state = tts.init_train_state(params, tts.OptimizerConfig(total_steps=10))
    return cfg, state


def _take_step(cfg, state):
    from simlingo_tpu_torch.data.synthetic import synthetic_example
    step = tts.make_train_step(cfg, tts.OptimizerConfig(total_steps=10), torch.float32)
    step(state, synthetic_example(cfg, batch=1, seq_len=96, num_patches=1, device="cpu"), 0)


def test_save_restore_atomic_keep_and_async(tmp_path):
    cfg, state = _tiny_state()
    _take_step(cfg, state)
    d = str(tmp_path / "ckpts")
    os.makedirs(os.path.join(d, "step_00000009.tmp-1"))     # a write cut off
    assert ckpt.latest_checkpoint(d) is None
    for s in (1, 2, 3):
        ckpt.save_checkpoint(d, state, s, keep=2)
    assert sorted(x for x in os.listdir(d) if "tmp" not in x) == ["step_00000002",
                                                                  "step_00000003"]
    _take_step(cfg, state)
    ckpt.save_checkpoint(d, state, 4, keep=2, block=False)
    ckpt.wait_for_checkpoints()
    assert ckpt.latest_checkpoint(d).endswith("step_00000004")
    assert not any(x.startswith("step_00000004.tmp") for x in os.listdir(d))
    _, other = _tiny_state(seed=1)
    ckpt.restore_checkpoint(ckpt.latest_checkpoint(d), other)
    assert other.step == state.step == 2
    for p, x in tts.flatten(state.params).items():
        y = tts.flatten(other.params)[p]
        assert x.dtype == y.dtype and torch.equal(x, y), p
    so, oo = state.optimizer.state_dict(), other.optimizer.state_dict()
    for i in so["state"]:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(so["state"][i][k], oo["state"][i][k])
    # the restored optimizer steps its own leaves (not the saved copies)
    _take_step(cfg, state)
    _take_step(cfg, other)
    for p, x in state.trainable.items():
        assert torch.equal(x, other.trainable[p]), p


def test_final_save_after_a_finished_async_write_keeps_n(tmp_path):
    """The trainer's final save of the step an async save already wrote:
    keep-N holds whether or not that write had finished first."""
    _, state = _tiny_state()
    d = str(tmp_path / "ckpts")
    for s in (1, 2):
        ckpt.save_checkpoint(d, state, s, keep=2)
    ckpt.save_checkpoint(d, state, 3, keep=2, block=False)
    ckpt.wait_for_checkpoints()                  # the write landed first
    ckpt.save_checkpoint(d, state, 3, keep=2)    # the final save collides
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]


def test_async_error_surfaces(tmp_path, monkeypatch):
    _, state = _tiny_state()
    d = str(tmp_path / "ckpts")

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.torch, "save", boom)
    ckpt.save_checkpoint(d, state, 1, block=False)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait_for_checkpoints()
    assert ckpt.latest_checkpoint(d) is None and os.listdir(d) == []


def test_failed_final_save_keeps_the_state(tmp_path, monkeypatch, capsys):
    cfg = compose(["max_steps=2", "data.batch_size=1", "data.max_text_len=96",
                   "precision=fp32", f"output_dir={tmp_path}", "seed=3"])
    cfg.model = tsim.SimLingoConfig.tiny()
    ref = TT.train(cfg, make_synthetic=True, device="cpu")["state"]

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(TT.ckpt, "save_checkpoint", boom)
    out = TT.train(cfg, make_synthetic=True, device="cpu")
    assert "disk full" in out["metrics"]["final_checkpoint_error"]
    assert "final checkpoint save failed" in capsys.readouterr().out
    assert out["state"].step == 2
    for p, x in tts.flatten(ref.params).items():
        assert torch.equal(x, tts.flatten(out["state"].params)[p]), p


def test_train_base_saves_its_final_state(tmp_path):
    """`train_base` shares the save and restore: its config.json and final
    two-group state land in <output_dir>/<name>_base (`train_base.py:89-92,
    108-109`), and the state restores."""
    from simlingo_tpu_torch.core.config import compose_base
    from simlingo_tpu_torch.models import simlingo_base
    from simlingo_tpu_torch.train import base_step
    cfg = compose_base(["max_steps=1", "data.batch_size=1", "precision=fp32",
                        f"output_dir={tmp_path}"])
    cfg.model = simlingo_base.SimLingoBaseConfig.tiny()
    state = TT.train_base(cfg, device="cpu")["state"]
    run_dir = tmp_path / f"{cfg.name}_base"
    with open(run_dir / "config.json") as f:
        assert json.load(f)["data"]["batch_size"] == 1
    path = ckpt.latest_checkpoint(str(run_dir / "checkpoints"))
    assert path.endswith("step_00000001")
    fresh = base_step.init_base_state(simlingo_base.init_params(
        cfg.model, torch.Generator().manual_seed(9), device="cpu"), cfg.optimizer)
    ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 1
    for p, x in tts.flatten(state.params).items():
        assert torch.equal(x, tts.flatten(fresh.params)[p]), p


def test_native_converters_match_jax():
    """The transformers-native InternVL names (`vit_from_torch_native`,
    `projector_from_torch_native`): the port's tree equals
    `params_from_jax` of JAX's conversion."""
    from simlingo_tpu.core import hf_convert as JC
    from simlingo_tpu_torch.core import hf_convert as TC
    jcfg = _tiny_cfg()
    H, I, n = jcfg.vit.hidden_size, jcfg.vit.intermediate_size, jcfg.vit.num_patches + 1
    g = torch.Generator().manual_seed(4)
    t = lambda *s: torch.randn(*s, generator=g)
    sd = {"embeddings.patch_embeddings.projection.weight": t(H, 3, 14, 14),
          "embeddings.patch_embeddings.projection.bias": t(H),
          "embeddings.cls_token": t(1, 1, H), "embeddings.position_embeddings": t(1, n, H)}
    for i in range(jcfg.vit.num_layers):
        lp = f"encoder.layer.{i}."
        for name in ("layernorm_before", "layernorm_after"):
            sd[lp + name + ".weight"], sd[lp + name + ".bias"] = t(H), t(H)
        for name in ("q_proj", "k_proj", "v_proj", "projection_layer"):
            sd[lp + f"attention.{name}.weight"], sd[lp + f"attention.{name}.bias"] = t(H, H), t(H)
        sd[lp + "lambda_1"], sd[lp + "lambda_2"] = t(H), t(H)
        sd[lp + "mlp.fc1.weight"], sd[lp + "mlp.fc1.bias"] = t(I, H), t(I)
        sd[lp + "mlp.fc2.weight"], sd[lp + "mlp.fc2.bias"] = t(H, I), t(H)
    P, O = 4 * H, jcfg.vit.projector_out
    pp = "multi_modal_projector."
    sd.update({pp + "layer_norm.weight": t(P), pp + "layer_norm.bias": t(P),
               pp + "linear_1.weight": t(O, P), pp + "linear_1.bias": t(O),
               pp + "linear_2.weight": t(O, O), pp + "linear_2.bias": t(O)})
    for jfn, tfn, args in ((JC.vit_from_torch_native, TC.vit_from_torch_native, (jcfg.vit,)),
                           (JC.projector_from_torch_native, TC.projector_from_torch_native, ())):
        ref = tts.flatten(params_from_jax(jfn(sd, *args), device="cpu"))
        got = tts.flatten(tfn(sd, *args))
        assert set(got) == set(ref)
        for p, want in ref.items():
            assert torch.equal(got[p], want), p
