"""The ResNet encoder of SimLingo-Base in simlingo_tpu_torch against the
JAX package (CPU, fp32).

`resnet.encode` at depth 18 and 34 (width 16, 32-wide tokens) on the
JAX `init_params`' weights, bridged by `params_from_jax` (HWIO conv
kernels to [out, in, kh, kw]): the tokens and the new running statistics
in training and in evaluation, on an even input and an odd one (70 x 134,
whose "SAME" padding is asymmetric at every stride-2 layer), at 2e-4;
the padding amounts themselves; the bridged tree; and a two-group base
state with `bn_state` saved and restored bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.models import resnet as jresnet
from simlingo_tpu_torch.core import checkpoint as ckpt
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.synthetic import base_batch
from simlingo_tpu_torch.models import resnet as tresnet
from simlingo_tpu_torch.models import simlingo_base as tbase
from simlingo_tpu_torch.train import base_step
from simlingo_tpu_torch.train import train_step as tts

TOL = dict(atol=2e-4, rtol=2e-4)


def _configs(depth):
    return (jresnet.ResNetConfig(depth=depth, width=16, token_size=32),
            tresnet.ResNetConfig(depth=depth, width=16, token_size=32))


@pytest.fixture(scope="module", params=[18, 34])
def nets(request):
    """(depth, JAX config, port config, JAX params, JAX bn_state) with
    running statistics away from their initial 0 / 1."""
    jcfg, tcfg = _configs(request.param)
    params, state = jax.jit(jresnet.init_params, static_argnums=1)(
        jax.random.PRNGKey(request.param), jcfg)
    rng = np.random.RandomState(request.param)
    state = jax.tree_util.tree_map(
        lambda x: x + np.abs(rng.randn(*x.shape)).astype(np.float32) * 0.3, state)
    return request.param, jcfg, tcfg, params, state


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 128, 3), (2, 70, 134, 3)])
def test_encode_matches_jax(nets, shape, training):
    depth, jcfg, tcfg, params, state = nets
    images = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want, want_state = jax.jit(jresnet.encode, static_argnums=(3, 4))(
        params, state, jnp.asarray(images), jcfg, training)
    got, got_state = tresnet.encode(params_from_jax(params, device="cpu"),
                                    params_from_jax(state, device="cpu"),
                                    torch.from_numpy(images), tcfg, training)
    h, w = -(-shape[1] // 32), -(-shape[2] // 32)
    assert got.shape == want.shape == (2, h * w, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_flat = tts.flatten(params_from_jax(want_state, device="cpu"))
    got_flat = tts.flatten(got_state)
    assert set(got_flat) == set(want_flat)
    for path, x in got_flat.items():
        np.testing.assert_allclose(x.numpy(), want_flat[path].numpy(), err_msg=path, **TOL)
    start = tts.flatten(params_from_jax(state, device="cpu"))
    moved = max(float((x - start[p]).abs().max()) for p, x in got_flat.items())
    assert (moved > 1e-3) == training          # evaluation keeps the statistics


@pytest.mark.parametrize("n,k,stride,pad", [
    (336, 7, 2, (2, 3)),        # the stem on a 336 tile
    (168, 3, 2, (0, 1)),        # the max-pool / a stride-2 conv on an even size
    (35, 3, 2, (1, 1)),         # ... on an odd one
    (84, 3, 1, (1, 1)),         # a stride-1 conv
    (84, 1, 2, (0, 0))])        # a downsampling 1x1 conv
def test_same_padding_is_xla_s(n, k, stride, pad):
    assert tresnet._same_pad(n, k, stride) == pad
    x = np.random.RandomState(n).randn(1, n, n, 1).astype(np.float32)
    w = np.random.RandomState(k).randn(k, k, 1, 1).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride),
                                        "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = tresnet.conv(torch.from_numpy(w).permute(3, 2, 0, 1),
                       torch.from_numpy(x).permute(0, 3, 1, 2), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), **TOL)


def test_max_pool_pads_with_minus_infinity():
    x = -np.abs(np.random.RandomState(0).randn(1, 6, 7, 2)).astype(np.float32) - 1
    want = jax.lax.reduce_window(jnp.asarray(x), -jnp.inf, jax.lax.max, (1, 3, 3, 1),
                                 (1, 2, 2, 1), "SAME")
    got = tresnet.max_pool(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_from_jax_turns_conv_kernels_and_keeps_bn_state():
    jcfg, tcfg = _configs(18)
    params, state = jresnet.init_params(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(params, device="cpu")
    own, own_state = tresnet.init_params(tcfg, torch.Generator().manual_seed(0))
    assert ({p: tuple(x.shape) for p, x in tts.flatten(tp).items()}
            == {p: tuple(x.shape) for p, x in tts.flatten(own).items()})
    stem = np.asarray(params["stem"]["conv"])                       # [7, 7, 3, 16] HWIO
    assert tuple(tp["stem"]["conv"].shape) == (16, 3, 7, 7)
    np.testing.assert_array_equal(tp["stem"]["conv"].numpy(), stem.transpose(3, 2, 0, 1))
    assert tuple(tp["stages"]["1"]["0"]["down_conv"].shape) == (32, 16, 1, 1)
    assert tuple(tp["proj"]["w"].shape) == (32, 128)                 # a linear, [out, in]
    ts_ = params_from_jax(state, device="cpu")
    assert set(tts.flatten(ts_)) == set(tts.flatten(own_state))
    for path, x in tts.flatten(ts_).items():
        assert x.dtype == torch.float32
        np.testing.assert_array_equal(x.numpy(), tts.flatten(own_state)[path].numpy())


def test_a_base_state_with_bn_state_saves_and_restores_bit_for_bit(tmp_path):
    cfg = tbase.SimLingoBaseConfig(llm_variant="debug", encoder="resnet",
                                   resnet=tresnet.ResNetConfig(width=16, token_size=32))
    opt = tts.OptimizerConfig(lr=1e-3, total_steps=10, grad_clip=1.0)

    def fresh(seed):
        return base_step.init_base_state(
            tbase.init_params(cfg, torch.Generator().manual_seed(seed), device="cpu"), opt)
    state = fresh(0)
    step = base_step.make_base_train_step(cfg, opt, compute_dtype=torch.float32)
    step(state, base_batch(np.random.RandomState(0), 2, 64, device="cpu"))
    path = ckpt.save_checkpoint(str(tmp_path), state, state.step)
    back = ckpt.restore_checkpoint(path, fresh(1))
    assert back.step == 1 and any(p.startswith("bn_state/") for p in tts.flatten(back.params))
    for (p, x), y in zip(tts.flatten(state.params).items(), tts.flatten(back.params).values()):
        assert torch.equal(x, y), p
    for x, y in zip(tts.flatten(state.params).values(), tts.flatten(back.params).values()):
        for k, v in state.optimizer.state[x].items():
            assert torch.equal(v, back.optimizer.state[y][k]), k
