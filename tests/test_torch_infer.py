"""simlingo_tpu_torch serving path against the JAX package (CPU, fp32).

One set of JAX-initialised weights (the agent config of tests/test_agent.py,
carried across by core/from_jax) serves every test here:
- `build_text_embeddings`, greedy `generate_and_drive`, speculative
  `generate_and_drive_spec` and `drive_only` on synthetic batches;
- `LingoAgent.run_step` (CoT, int8 LLM, speculative after the first frame)
  on the same two camera frames.
Tokens must be identical; hidden states and waypoints agree within
atol = rtol = 2e-4; controls within 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.agent import agent as jagent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.data.synthetic import synthetic_example
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.infer import runner as jrun
from simlingo_tpu.infer import speculative as jspec
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu_torch.agent import agent as tagent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.core.from_jax import (input_from_jax, label_from_jax,
                                              params_from_jax)
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.infer import runner as trun
from simlingo_tpu_torch.infer import speculative as tspec
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.vit import ViTConfig

TOL = dict(atol=2e-4, rtol=2e-4)
VIT = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
           image_size=448, patch_size=56, projector_out=64)
AGENT = dict(use_cot=True, max_new_tokens=8, spec_k=4, initial_frames_delay=0,
             jpeg_roundtrip=False, warmup_compile=False)
# the draft tables are traced arguments: both draft cases share one compile
JAX_SPEC = jax.jit(jspec.generate_and_drive_spec, static_argnums=(2, 3),
                   static_argnames=("spec_k", "compute_dtype", "return_stats"))


@pytest.fixture(scope="module")
def setup():
    """(JAX config, JAX params, the port's config, the port's params)."""
    vocab = JTokenizer().tk.vocab_size + 8
    img_id = JTokenizer().img_context_id
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(**VIT), llm=JQwen2Config.tiny(vocab_size=vocab),
        img_context_token_id=img_id, remat_vision=False, remat_llm=False)
    tcfg = tsim.SimLingoConfig(vit=ViTConfig(**VIT),
                               llm=Qwen2Config.tiny(vocab_size=vocab),
                               img_context_token_id=img_id)
    params = jax.jit(jsim.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg)
    return jcfg, params, tcfg, params_from_jax(params, device="cpu")


def _example(jcfg, batch, seed):
    ex = synthetic_example(jcfg, batch=batch, seq_len=80, num_patches=1,
                           seed=seed, left_pad=True)
    return ex.driving_input, input_from_jax(ex.driving_input, device="cpu")


def _assert_same(out_t, out_j):
    np.testing.assert_array_equal(out_t.language_tokens.numpy(),
                                  np.asarray(out_j.language_tokens))
    np.testing.assert_array_equal(out_t.language_lengths.numpy(),
                                  np.asarray(out_j.language_lengths))
    np.testing.assert_allclose(out_t.route.numpy(), np.asarray(out_j.route), **TOL)
    np.testing.assert_allclose(out_t.speed_wps.numpy(),
                               np.asarray(out_j.speed_wps), **TOL)


def test_build_text_embeddings_matches_jax(setup):
    jcfg, jparams, tcfg, tparams = setup
    ex = synthetic_example(jcfg, batch=2, seq_len=80, num_patches=2, seed=5,
                           left_pad=True)
    di = ex.driving_input
    ref = np.asarray(jax.jit(jsim.build_text_embeddings, static_argnums=3)(
        jparams, di.prompt_inference, di.pixel_values, jcfg))
    out = tsim.build_text_embeddings(
        tparams, label_from_jax(di.prompt_inference, device="cpu"),
        torch.from_numpy(np.array(di.pixel_values)), tcfg)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("eos", [3, -1])
def test_generate_and_drive_matches_jax(setup, eos):
    jcfg, jparams, tcfg, tparams = setup
    jdi, tdi = _example(jcfg, batch=2, seed=7)
    if eos == 3:       # make row 0 stop early: eos = its second greedy token
        free = trun.generate_and_drive(
            tparams, tdi, tcfg,
            trun.GenerateConfig(max_new_tokens=6, eos_token_id=-1,
                                cache_dtype=torch.float32),
            compute_dtype=torch.float32)
        eos = int(free.language_tokens[0, 1])
    jgen = jrun.GenerateConfig(max_new_tokens=6, eos_token_id=eos,
                               cache_dtype=jnp.float32)
    out_j = jax.jit(lambda p, d: jrun.generate_and_drive(
        p, d, jcfg, jgen, compute_dtype=jnp.float32))(jparams, jdi)
    out_t = trun.generate_and_drive(
        tparams, tdi, tcfg,
        trun.GenerateConfig(max_new_tokens=6, eos_token_id=eos,
                            cache_dtype=torch.float32),
        compute_dtype=torch.float32)
    _assert_same(out_t, out_j)


@pytest.mark.parametrize("draft", ["garbage", "oracle"])
def test_generate_and_drive_spec_matches_jax_and_greedy(setup, draft):
    jcfg, jparams, tcfg, tparams = setup
    V = tcfg.llm.vocab_size
    jdi, tdi = _example(jcfg, batch=1, seed=11)
    tgen = trun.GenerateConfig(max_new_tokens=10, eos_token_id=-1,
                               cache_dtype=torch.float32)
    greedy = trun.generate_and_drive(tparams, tdi, tcfg, tgen,
                                     compute_dtype=torch.float32)
    if draft == "garbage":
        rng = np.random.RandomState(0)
        seqs = [rng.randint(0, V, size=50).tolist() for _ in range(4)]
    else:
        seqs = [greedy.language_tokens[0].tolist()]
    tables = tspec.build_draft_tables(seqs, V)
    jtables = jspec.build_draft_tables(seqs, V)
    for key in tables:
        np.testing.assert_array_equal(tables[key], jtables[key])
    out_t, st_t = tspec.generate_and_drive_spec(
        tparams, tdi, tcfg, tgen, tables, spec_k=4, compute_dtype=torch.float32,
        return_stats=True)
    jgen = jrun.GenerateConfig(max_new_tokens=10, eos_token_id=-1,
                               cache_dtype=jnp.float32)
    out_j, st_j = JAX_SPEC(jparams, jdi, jcfg, jgen,
                           {k: jnp.asarray(v) for k, v in jtables.items()},
                           spec_k=4, compute_dtype=jnp.float32, return_stats=True)
    _assert_same(out_t, out_j)
    assert st_t == {"rounds": int(st_j["rounds"]), "gen_len": int(st_j["gen_len"])}
    np.testing.assert_array_equal(out_t.language_tokens.numpy(),
                                  greedy.language_tokens.numpy())
    if draft == "oracle":       # perfect drafts: ceil(9 / 4) rounds
        assert st_t["rounds"] == 3, st_t


def test_propose_chains_bigram_then_unigram():
    a, b, c, x, y = 5, 6, 7, 8, 9
    tables = tspec.build_draft_tables([[a, b, c]] * 3 + [[x, b, y]] * 2, 16,
                                      table_bits=8)
    assert tspec.propose(tables, a, b, 1) == [c]
    assert tspec.propose(tables, x, b, 1) == [y]
    assert tspec.propose(tables, a, b, 2) == [c, 15]      # then the sentinel


def test_drive_only_matches_jax(setup):
    jcfg, jparams, tcfg, tparams = setup
    ex = synthetic_example(jcfg, batch=2, seq_len=80, num_patches=1, seed=3)
    out_j = jax.jit(lambda p, d: jrun.drive_only(
        p, d, jcfg, compute_dtype=jnp.float32))(jparams, ex.driving_input)
    out_t = trun.drive_only(tparams, input_from_jax(ex.driving_input, device="cpu"),
                            tcfg, compute_dtype=torch.float32)
    assert out_t.route.shape == (2, 20, 2)
    _assert_same(out_t, out_j)


def _frames():
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 255, (512, 1024, 3), np.uint8)
    return [dict(rgb=rgb, speed=3.0, target_point=np.array([8.0, 0.3]),
                 next_target_point=np.array([16.0, 1.0])),
            dict(rgb=rgb[:, ::-1].copy(), speed=3.4,
                 target_point=np.array([7.5, 0.2]),
                 next_target_point=np.array([15.0, 0.8]))]


def test_agent_run_step_matches_jax(setup):
    """The default serving configuration (CoT, int8 LLM, speculative CoT
    after the first frame): identical language tokens, waypoints within
    TOL and the same controls, frame by frame."""
    jcfg, jparams, tcfg, _ = setup
    ja = jagent.LingoAgent(jparams, jcfg, JAgentConfig(**AGENT), tokenizer=JTokenizer(),
                           max_prompt_len=256, compute_dtype=jnp.float32)
    ta = tagent.LingoAgent(params_from_jax(jparams, device="cpu"), tcfg,
                           AgentConfig(**AGENT), tokenizer=SimLingoTokenizer(),
                           max_prompt_len=256, compute_dtype=torch.float32,
                           device="cpu")
    for f in _frames():
        rj = ja.run_step(jagent.AgentFrame(**f))
        rt = ta.run_step(tagent.AgentFrame(**f))
        assert rt["language_tokens"] == rj["language_tokens"]
        assert len(rt["language_tokens"]) == 8
        np.testing.assert_allclose(rt["route"], rj["route"], **TOL)
        np.testing.assert_allclose(rt["speed_wps"], rj["speed_wps"], **TOL)
        for key in ("steer", "throttle", "brake"):
            assert rt[key] == pytest.approx(rj[key], abs=1e-3), key
    # frame 1 plain greedy, frame 2 speculative, in both packages
    assert ta.spec_stats == ja.spec_stats and len(ta.spec_stats) == 1
