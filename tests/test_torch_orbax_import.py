"""`convert_orbax_torch.py`: a JAX training checkpoint (orbax) into the port.

On the CPU in fp32, dropout 0, on the tiny config the training parity
tests share (`tests/test_torch_train.py`: LoRA r=4, its B nonzero). JAX's
train step runs 3 times straight; separately, 2 JAX steps are saved with
JAX's own `save_checkpoint`, converted, restored by the port's
`restore_checkpoint` into a train state of the port's own (randomly
initialised) model, and the port's `train_step` takes the third step on the
same batch: the loss, the grad norm and every updated parameter equal
JAX's third step at 2e-4 (`tests/test_model_parity.py:60`), and the
restored AdamW moments equal JAX's `mu` / `nu` exactly. A params-only save
gives JAX's forward at 2e-4; a save whose optimizer chain has another
layout gives the parameters and the step only, and says so; a config whose
model differs from the save's is refused.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import convert_orbax_torch as C
from simlingo_tpu.core import checkpoint as jckpt
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core import checkpoint as tckpt
from simlingo_tpu_torch.core.config import TrainConfig, to_dict
from simlingo_tpu_torch.core.from_jax import example_from_jax, params_from_jax
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.train import train_step as tts
from tests.test_torch_train import TOL, _port_cfg
from tests.test_torch_train import setup  # noqa: F401  (the shared fixture)

OPT = dict(lr=1e-3, total_steps=10, grad_clip=0.3)


def _port_config(jcfg) -> TrainConfig:
    return TrainConfig(model=_port_cfg(jcfg), optimizer=tts.OptimizerConfig(**OPT))


def _port_state(jcfg, optimizer=True):
    """A train state of the port's own model, its weights drawn afresh (the
    restore must overwrite every one)."""
    params = tsim.init_params(_port_cfg(jcfg), torch.Generator().manual_seed(123), device="cpu")
    state = tts.init_train_state(params, tts.OptimizerConfig(**OPT))
    if not optimizer:
        state.optimizer = None
    return state


@pytest.fixture(scope="module")
def jax_run(setup, tmp_path_factory):  # noqa: F811
    jcfg, params, ex = setup
    mask = jts.trainable_mask(params, jts.production_trainable)
    opt = jts.make_optimizer(jts.OptimizerConfig(**OPT))
    jstep = jts.make_train_step(jcfg, opt, compute_dtype=jnp.float32, donate=False,
                                trainable_mask_tree=mask)
    # three steps straight
    state = jts.init_train_state(params, opt, trainable_mask_tree=mask)
    for i in range(3):
        state, metrics = jstep(state, ex, jax.random.PRNGKey(i))
    # separately: two steps, saved by JAX
    saved = jts.init_train_state(params, opt, trainable_mask_tree=mask)
    for i in range(2):
        saved, _ = jstep(saved, ex, jax.random.PRNGKey(i))
    root = tmp_path_factory.mktemp("orbax")
    jckpt.save_checkpoint(str(root / "jax"), saved, 2)
    return dict(cfg=jcfg, ex=ex, final=state, metrics=metrics, saved=saved, root=root)


def test_converted_save_takes_jaxs_third_step(jax_run):
    jcfg, root = jax_run["cfg"], jax_run["root"]
    out, with_opt = C.convert(str(root / "jax"), str(root / "port"), _port_config(jcfg))
    assert with_opt and out == str(root / "port" / "step_00000002")
    assert sorted(os.listdir(out)) == ["meta.json", "optimizer.pt", "params.pt"]
    state = tckpt.restore_checkpoint(tckpt.latest_checkpoint(str(root / "port")),
                                     _port_state(jcfg))
    assert state.step == 2
    # the moments sit on their own leaves: equal to JAX's mu / nu
    adam = jax_run["saved"]["opt_state"][1][0]
    mu = tts.flatten(params_from_jax(C._prune(jax.tree_util.tree_map(
        np.asarray, adam.mu)), device="cpu"))
    nu = tts.flatten(params_from_jax(C._prune(jax.tree_util.tree_map(
        np.asarray, adam.nu)), device="cpu"))
    assert set(mu) == set(state.trainable)
    for path, x in state.trainable.items():
        st = state.optimizer.state[x]
        assert float(st["step"]) == 2.0
        torch.testing.assert_close(st["exp_avg"], mu[path], rtol=0, atol=0)
        torch.testing.assert_close(st["exp_avg_sq"], nu[path], rtol=0, atol=0)
    # the third step
    step = tts.make_train_step(_port_cfg(jcfg), tts.OptimizerConfig(**OPT),
                               compute_dtype=torch.float32)
    m = step(state, example_from_jax(jax_run["ex"], device="cpu"), 2)
    jm = jax_run["metrics"]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), err_msg=key, **TOL)
    assert float(jm["grad_norm"]) > 0.3          # the clip was active
    want = tts.flatten(params_from_jax(jax_run["final"]["params"], device="cpu"))
    saved = tts.flatten(params_from_jax(jax_run["saved"]["params"], device="cpu"))
    got = tts.flatten(state.params)
    assert set(got) == set(want)
    moved = 0.0
    for path, x in got.items():
        assert x.dtype == want[path].dtype, path  # frozen bf16, trainable fp32
        np.testing.assert_allclose(x.detach().float().numpy(), want[path].float().numpy(),
                                   err_msg=path, **TOL)
        moved = max(moved, float((want[path].float() - saved[path].float()).abs().max()))
    assert moved > 1e-4, moved                    # the third step moved the weights


def _forward(jcfg, jparams, tparams, ex):
    jout, jpred = jax.jit(lambda p, b: jsim.forward_loss(
        jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), p), b, jcfg,
        compute_dtype=jnp.float32))(jparams, ex)
    tout, tpred = tsim.forward_loss(tts.cast_for_compute(tparams, torch.float32),
                                    example_from_jax(ex, device="cpu"), _port_cfg(jcfg),
                                    compute_dtype=torch.float32)
    return (jout, jpred), (tout, tpred)


def test_params_only_save_gives_jaxs_forward(jax_run, capsys):
    jcfg, root = jax_run["cfg"], jax_run["root"]
    saved = jax_run["saved"]
    jckpt.save_checkpoint(str(root / "jax_params"), {"params": saved["params"],
                                                      "step": saved["step"]}, 2)
    cfg_file = root / "tiny.json"
    cfg_file.write_text(json.dumps(to_dict(_port_config(jcfg))))
    assert C.main([str(root / "jax_params" / "step_00000002"), str(root / "port_params"),
                   "--experiment", str(cfg_file)]) == 0
    said = capsys.readouterr().out
    assert "parameters and step only" in said and "no optimizer.pt" in said
    out = root / "port_params" / "step_00000002"
    assert sorted(os.listdir(out)) == ["meta.json", "params.pt"]
    state = tckpt.restore_checkpoint(str(out), _port_state(jcfg, optimizer=False))
    assert state.step == 2
    with torch.no_grad():
        (jout, jpred), (tout, tpred) = _forward(jcfg, saved["params"], state.params,
                                                jax_run["ex"])
    np.testing.assert_allclose(float(tout.loss), float(jout.loss), **TOL)
    for key in jout.loss_averages:
        np.testing.assert_allclose(float(tout.loss_averages[key]),
                                   float(jout.loss_averages[key]), err_msg=key, **TOL)
    for key in ("route", "speed_wps"):
        np.testing.assert_allclose(tpred[key].numpy(), np.asarray(jpred[key]),
                                   err_msg=key, **TOL)
    # a resume refuses it: there is no optimizer state to load
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(out), _port_state(jcfg))


def test_another_optimizer_layout_converts_the_parameters_only(jax_run):
    """A chain that is not make_optimizer's (here SGD with momentum) is not
    read as AdamW: the parameters and the step, no optimizer.pt."""
    jcfg, root = jax_run["cfg"], jax_run["root"]
    saved = jax_run["saved"]
    trainable, _ = jts.partition_params(saved["params"], jts.trainable_mask(
        saved["params"], jts.production_trainable))
    sgd = optax.chain(optax.clip_by_global_norm(0.3), optax.sgd(1e-3, momentum=0.9))
    jckpt.save_checkpoint(str(root / "jax_sgd"), {"params": saved["params"],
                                                   "opt_state": sgd.init(trainable),
                                                   "step": saved["step"]}, 2)
    assert C.adam_state(C.restore_orbax(str(root / "jax_sgd" / "step_00000002"))
                        ["opt_state"]) is None
    out, with_opt = C.convert(str(root / "jax_sgd"), str(root / "port_sgd"),
                              _port_config(jcfg))
    assert not with_opt
    assert sorted(os.listdir(out)) == ["meta.json", "params.pt"]
    got = torch.load(os.path.join(out, "params.pt"), weights_only=True)
    want = tts.flatten(params_from_jax(saved["params"], device="cpu"))
    assert list(got) == list(tts.flatten(_port_state(jcfg).params))   # the port's order
    for path, x in want.items():
        assert got[path].dtype == x.dtype
        assert torch.equal(got[path], x), path


def test_a_config_of_another_model_is_refused(jax_run):
    root = jax_run["root"]
    other = dataclasses.replace(jax_run["cfg"], llm=dataclasses.replace(
        jax_run["cfg"].llm, lora_r=0))
    with pytest.raises(ValueError, match="not those of the config's model"):
        C.convert(str(root / "jax"), str(root / "port_other"), _port_config(other))
    with pytest.raises(ValueError, match="not those of the config's model"):
        C.convert(str(root / "jax"), str(root / "port_default"), TrainConfig())
    assert not os.path.exists(root / "port_other")


def test_cli_converts_with_the_jax_package_blocked(jax_run):
    """The script as a user runs it, in a process where no module of the
    JAX package can be imported (orbax and jax can): the same files as the
    in-process conversion."""
    import subprocess
    import sys
    import textwrap
    from pathlib import Path
    jcfg, root = jax_run["cfg"], jax_run["root"]
    cfg_file = root / "tiny_cli.json"
    cfg_file.write_text(json.dumps(to_dict(_port_config(jcfg))))
    repo = Path(__file__).resolve().parents[1]
    script = textwrap.dedent("""
        import runpy, sys

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name == "simlingo_tpu" or name.startswith("simlingo_tpu."):
                    raise ImportError(f"blocked import: {name}")
                return None

        sys.meta_path.insert(0, Block())
        sys.argv = ["convert_orbax_torch.py"] + sys.argv[1:]
        try:
            runpy.run_path("convert_orbax_torch.py", run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
        assert not any(m == "simlingo_tpu" or m.startswith("simlingo_tpu.")
                       for m in sys.modules)
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", script, str(root / "jax"),
                          str(root / "port_cli"), "--experiment", str(cfg_file)],
                         cwd=repo, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stdout + res.stderr
    assert "parameters, AdamW state and step" in res.stdout and \
        res.stdout.strip().endswith("ok"), res.stdout
    cli = root / "port_cli" / "step_00000002"
    ref = root / "port_ref"
    C.convert(str(root / "jax"), str(ref), _port_config(jcfg))
    for name in ("params.pt", "optimizer.pt"):
        a = torch.load(cli / name, weights_only=True)
        b = torch.load(ref / "step_00000002" / name, weights_only=True)
        if name == "params.pt":
            assert list(a) == list(b)
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert a["param_groups"] == b["param_groups"]
            assert all(torch.equal(a["state"][i][k], b["state"][i][k])
                       for i in b["state"] for k in b["state"][i])
    assert json.loads((cli / "meta.json").read_text()) == {"step": 2}
