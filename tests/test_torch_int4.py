"""The port's int4 serving path (w4a16, group-wise scales) against JAX's.

CPU, fp32. `quantize_weight4`'s codes and scales bit for bit (JAX's
linear layout [K // 2, N] / [G, N] transposed into the port's one layout
[N, K // 2] / [N, G]; JAX's table layout as it is), the nibble packing,
`int4_matmul` and its activation gradient in both of JAX's branches
(M <= 64 grouped, M > 64 dense) and both of its layouts at 2e-4, the int4
embedding gather, `quantize_llm(bits=4)` and `quantize_for_inference`
through the bridge, and a `LingoAgent` with `int4_llm=True` on a small
model whose LLM widths are multiples of 128: the same tokens as JAX's
agent, waypoints within 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.agent import agent as jagent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.core import quantize as JQ
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.kernels import quantized_matmul as JQM
from simlingo_tpu.models import layers as jL
from simlingo_tpu.models import qwen2 as jq
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu_torch.agent import agent as tagent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.core import quantize as TQ
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.kernels import quantized_matmul as TQM
from simlingo_tpu_torch.models import layers as tL
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.vit import ViTConfig

TOL = dict(atol=2e-4, rtol=2e-4)
# the LLM of presets.small_shardable: every reduction width a multiple of 128
LLM = dict(hidden_size=256, num_layers=2, num_heads=8, num_kv_heads=2, head_dim=32,
           intermediate_size=512)
VIT = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
           image_size=448, patch_size=56, projector_out=256)


def _weight(shape, seed=0):
    w = np.random.RandomState(seed).randn(*shape).astype(np.float32) * 0.05
    w[1] = 0.0                                   # a row at the 1e-8 floor
    return w


@pytest.mark.parametrize("group", [32, 128])
@pytest.mark.parametrize("jax_axis", [1, 0])
def test_quantize_weight4_matches_jax_bit_for_bit(group, jax_axis):
    """axis=1 (a linear, [K, N]) transposed; axis=0 (a table, [V, H]) as is."""
    w = _weight((256, 384))                      # [K, N] or [V, H]
    jw_q, jscale = JQM.quantize_weight4(jnp.asarray(w), axis=jax_axis, group=group)
    jw_q, jscale = np.asarray(jw_q), np.asarray(jscale)
    if jax_axis == 1:
        jw_q, jscale, w = jw_q.T, jscale.T, w.T
    tw_q, tscale = TQM.quantize_weight4(torch.from_numpy(np.ascontiguousarray(w)), group)
    assert tw_q.dtype == torch.int8 and tscale.dtype == torch.float32
    np.testing.assert_array_equal(tw_q.numpy(), jw_q)
    np.testing.assert_array_equal(tscale.numpy(), jscale)


@pytest.mark.parametrize("shape,dim", [((6, 10), 1), ((6, 10), 0), ((4, 3, 8), -1)])
def test_pack_unpack_round_trip_and_jax_bytes(shape, dim):
    codes = np.random.RandomState(1).randint(-8, 8, shape).astype(np.int8)
    packed = TQM.pack_int4(torch.from_numpy(codes), dim)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(JQM.pack_int4(codes, dim)))
    np.testing.assert_array_equal(TQM.unpack_int4(packed, dim).numpy(), codes)


def _jax_int4(M, K, N, transpose_rhs, seed):
    """x [M, K] and a JAX-quantized weight in the given layout, with the
    port's operands."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    if transpose_rhs:                            # a table [V=N, H=K]
        jw_q, js = JQM.quantize_weight4(jnp.asarray(_weight((N, K), seed)), axis=0)
        tw_q, ts = torch.from_numpy(np.array(jw_q)), torch.from_numpy(np.array(js))
    else:                                        # a linear [K, N]
        jw_q, js = JQM.quantize_weight4(jnp.asarray(_weight((K, N), seed)), axis=1)
        tw_q = torch.from_numpy(np.ascontiguousarray(np.asarray(jw_q).T))
        ts = torch.from_numpy(np.ascontiguousarray(np.asarray(js).T))
    return x, jw_q, js, tw_q, ts


@pytest.mark.parametrize("M", [1, 16, 64, 65, 200])
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_int4_matmul_forward_and_dx_match_jax(M, transpose_rhs):
    K, N = 384, 160
    x, jw_q, js, tw_q, ts = _jax_int4(M, K, N, transpose_rhs, seed=M)
    g = np.random.RandomState(M + 7).randn(M, N).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: JQM.int4_matmul(a, jw_q, js, transpose_rhs), jnp.asarray(x))
    dx_j, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y_t = TQM.int4_matmul(xt, tw_q, ts)
    y_t.backward(torch.from_numpy(g))
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(dx_j), **TOL)
    # the grouped branch sums fp32 partials: it equals the dense product of
    # the dequantized weight, the M > 64 branch, to fp32 rounding
    dense = torch.from_numpy(x) @ TQM.dequantize_weight4(tw_q, ts, torch.float32).t()
    np.testing.assert_allclose(y_t.detach().numpy(), dense.numpy(), **TOL)


def test_int4_embed_gather_matches_jax():
    w = _weight((300, 256))
    jp = JQ.quantize_embedding({"w": jnp.asarray(w)}, bits=4)
    ids = np.array([[0, 5, 299, 301, -2], [1, 1, 128, 7, 42]], np.int32)
    ref = np.asarray(jL.embed(jp, jnp.asarray(ids)))
    tp = params_from_jax({"embed": jp}, device="cpu")["embed"]
    assert tp["w_q"].shape == (300, 128) and tp["scale"].shape == (300, 2)
    got = tL.embed(tp, torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _walk_equal(a, b, path=""):
    assert a.keys() == b.keys(), path
    for key in a:
        if isinstance(a[key], dict):
            _walk_equal(a[key], b[key], f"{path}/{key}")
        else:
            assert a[key].dtype == b[key].dtype, f"{path}/{key}"
            assert torch.equal(a[key], b[key]), f"{path}/{key}"


def test_quantize_llm_int4_through_the_bridge():
    """params_from_jax(JAX quantize_llm(bits=4)) == the port's quantize_llm
    of params_from_jax(the float tree), leaf for leaf, at group 128."""
    cfg = JQwen2Config(vocab_size=300, **LLM)
    llm = jax.jit(jq.init_params, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    want = params_from_jax(JQ.quantize_llm(llm, bits=4), device="cpu")
    got = TQ.quantize_llm(params_from_jax(llm, device="cpu"), bits=4)
    _walk_equal(got, want)
    down = got["layers"]["1"]["mlp"]["down"]
    assert down["w_q"].shape == (256, 256) and down["scale"].shape == (256, 4)


def test_quantize_for_inference_matches_jax():
    """LoRA merged with the LLM's config, then int4; vision untouched."""
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(**VIT), llm=JQwen2Config(vocab_size=300, lora_r=4, lora_alpha=8, **LLM),
        img_context_token_id=260, remat_vision=False, remat_llm=False)
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(2), jcfg)
    params = dict(params, lora=jax.tree_util.tree_map(lambda a: a + 0.01, params["lora"]))
    want = params_from_jax(JQ.quantize_for_inference(params, jcfg.llm, bits=4), device="cpu")
    tllm = Qwen2Config(vocab_size=300, lora_r=4, lora_alpha=8, **LLM)
    got = TQ.quantize_for_inference(params_from_jax(params, device="cpu"), tllm, bits=4)
    assert "lora" not in got and got["vision"].keys() == want["vision"].keys()
    _walk_equal(got["llm"], want["llm"])


def _frames():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (512, 1024, 3), np.uint8)
    return [dict(rgb=rgb, speed=3.0, target_point=np.array([8.0, 0.3]),
                 next_target_point=np.array([16.0, 1.0])),
            dict(rgb=rgb[:, ::-1].copy(), speed=3.4, target_point=np.array([7.5, 0.2]),
                 next_target_point=np.array([15.0, 0.8]))]


def test_int4_agent_run_step_matches_jax():
    """`AgentConfig(int4_llm=True)` (CoT, speculative after the first
    frame) on a small model: the same language tokens as JAX's agent,
    waypoints within 2e-4, the same controls, frame by frame."""
    agent = dict(use_cot=True, int4_llm=True, max_new_tokens=8, spec_k=4,
                 initial_frames_delay=0, jpeg_roundtrip=False, warmup_compile=False)
    vocab = JTokenizer().tk.vocab_size + 8
    img_id = JTokenizer().img_context_id
    jcfg = jsim.SimLingoConfig(vit=JViTConfig(**VIT), llm=JQwen2Config(vocab_size=vocab, **LLM),
                               img_context_token_id=img_id, remat_vision=False,
                               remat_llm=False)
    tcfg = tsim.SimLingoConfig(vit=ViTConfig(**VIT), llm=Qwen2Config(vocab_size=vocab, **LLM),
                               img_context_token_id=img_id)
    jparams = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    ja = jagent.LingoAgent(jparams, jcfg, JAgentConfig(**agent), tokenizer=JTokenizer(),
                           max_prompt_len=256, compute_dtype=jnp.float32)
    ta = tagent.LingoAgent(params_from_jax(jparams, device="cpu"), tcfg, AgentConfig(**agent),
                           tokenizer=SimLingoTokenizer(), max_prompt_len=256,
                           compute_dtype=torch.float32, device="cpu")
    q = ta.params["llm"]["layers"]["0"]["attn"]["q"]
    assert q["w_q"].shape == (256, 128) and q["scale"].shape == (256, 2)
    assert ta.params["llm"]["embed"]["scale"].shape == (vocab, 2)
    for f in _frames():
        rj = ja.run_step(jagent.AgentFrame(**f))
        rt = ta.run_step(tagent.AgentFrame(**f))
        assert rt["language_tokens"] == rj["language_tokens"]
        assert len(rt["language_tokens"]) == 8
        np.testing.assert_allclose(rt["route"], rj["route"], **TOL)
        np.testing.assert_allclose(rt["speed_wps"], rj["speed_wps"], **TOL)
        for key in ("steer", "throttle", "brake"):
            assert rt[key] == pytest.approx(rj[key], abs=1e-3), key
    assert ta.spec_stats == ja.spec_stats and len(ta.spec_stats) == 1
