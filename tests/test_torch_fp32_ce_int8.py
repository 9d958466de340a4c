"""The fused CE and the int8 products at fp32, on the CPU.

At precision=fp32 JAX runs its fused CE (`simlingo_tpu/kernels/fused_ce.py`)
and its w8a16 product (`quantized_matmul.py`) in their operands' dtype, fp32;
the port's CUDA wrappers take fp32 through fp32 builds of
`csrc/fused_ce.cu` and `csrc/int8_matmul.cu`. Here, with no card, the same
seeded numpy inputs go through JAX's Pallas kernels in interpret mode (or
its XLA branch, where JAX takes it) and the port's plain versions at fp32
(what a wrapper runs on a CPU tensor), at 1e-5:

* the fused CE's ce, dh and, with compute_dw, dW, at a ragged vocabulary
  with labels outside [0, V);
* the int8 forward in each of JAX's branches (M 8: XLA; M 128: Pallas),
  with fp32 and bf16 scales, and the activation gradient against JAX's VJP;
* the wrappers' zero-padding of other widths (H 100 for the CE; K 100 and
  an odd N for the int8 products) against JAX at the unpadded width.

Then the CE backward's fp32 scratch plan (the fp32 int8 products' split
plan is held in tests/test_torch_fp32_split.py) and the whole slice: one `trainer.train` step at precision=fp32 with both
kernel gates, and one on the int8 base, each held to JAX's fp32 step at
2e-4; the tiny LingoAgent at compute_dtype float32 on its int8 LLM against
JAX's, tokens equal and waypoints at 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.agent import agent as jagent
from simlingo_tpu.agent.config import AgentConfig as JAgentConfig
from simlingo_tpu.core.quantize import quantize_llm as jquantize_llm
from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
from simlingo_tpu.data.tokenizer import SimLingoTokenizer as JTokenizer
from simlingo_tpu.kernels import quantized_matmul as JQM
from simlingo_tpu.kernels.fused_ce import fused_ce as jfused_ce
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.models.qwen2 import Qwen2Config as JQwen2Config
from simlingo_tpu.models.vit import ViTConfig as JViTConfig
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.agent import agent as tagent
from simlingo_tpu_torch.agent.config import AgentConfig
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.data.tokenizer import SimLingoTokenizer
from simlingo_tpu_torch.kernels import fused_ce as TC
from simlingo_tpu_torch.kernels import quantized_matmul as TQM
from simlingo_tpu_torch.models import adaptors as TA
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.vit import ViTConfig
from simlingo_tpu_torch.train import trainer

TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=2e-4, rtol=2e-4)


# ---------------------------------------------------------------------------
# the fused CE
# ---------------------------------------------------------------------------

def _ce_inputs(N, H, V, seed):
    rs = np.random.RandomState(seed)
    h = rs.randn(N, H).astype(np.float32)
    w = (0.3 * rs.randn(V, H)).astype(np.float32)
    labels = rs.randint(0, V, N)
    labels[3], labels[7] = -1, V + 10 ** 6       # outside [0, V): gold 0 in both
    g = np.linspace(0.2, 1.7, N).astype(np.float32)
    return h, labels, w, g


def _jax_ce(h, labels, w, g, compute_dw):
    ce, vjp = jax.vjp(lambda a, b: jfused_ce(a, jnp.asarray(labels), b, compute_dw),
                      jnp.asarray(h), jnp.asarray(w))
    dh, dw = vjp(jnp.asarray(g))
    return np.asarray(ce), np.asarray(dh), np.asarray(dw)


@pytest.mark.parametrize("compute_dw", [False, True], ids=["dh", "dh_dw"])
def test_fused_ce_at_fp32_matches_jax_pallas(compute_dw):
    """ce, dh and dW of the port's fp32 plain versions (through the
    autograd Function) against JAX's Pallas forward and backward in
    interpret mode: N 37, H 96, V 1111."""
    h, labels, w, g = _ce_inputs(37, 96, 1111, seed=0)
    jce, jdh, jdw = _jax_ce(h, labels, w, g, compute_dw)
    th = torch.tensor(h, requires_grad=True)
    tw = torch.tensor(w, requires_grad=True)
    ce = TC.fused_ce(th, torch.tensor(labels), tw, compute_dw)
    ce.backward(torch.tensor(g))
    assert ce.dtype == th.grad.dtype == tw.grad.dtype == torch.float32
    np.testing.assert_allclose(ce.detach().numpy(), jce, **TOL)
    np.testing.assert_allclose(th.grad.numpy(), jdh, **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), jdw, **TOL)
    if not compute_dw:
        assert float(np.abs(jdw).max()) == 0.0 == float(tw.grad.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_fused_ce_pads_a_width_of_100_as_jax_computes_it(dtype):
    """H 100 is zero-padded to 128 (`_pad_width`, what the CUDA wrappers
    launch with); the plain versions on the padded operands, cut back to
    100 columns, against JAX at H 100 (fp32 at 1e-5; bf16 operands as
    JAX's bf16 Pallas kernels round them, within a bf16 spacing)."""
    h, labels, w, g = _ce_inputs(37, 100, 1111, seed=1)
    th, tw = torch.tensor(h).to(dtype), torch.tensor(w).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jce, jdh, jdw = _jax_ce(jnp.asarray(th.float().numpy(), jdt), labels,
                            jnp.asarray(tw.float().numpy(), jdt), g, True)
    ph, pw = TC._pad_width(th, tw)
    assert ph.shape == (37, 128) and pw.shape == (1111, 128)
    assert float(ph[:, 100:].abs().max()) == 0.0 == float(pw[:, 100:].abs().max())
    tl = torch.tensor(labels)
    logz, ce = TC.fused_ce_fwd_plain(ph, tl, pw)
    dh, dw = TC.fused_ce_bwd_plain(ph, tl, pw, logz, torch.tensor(g), True)
    assert dh.dtype == dw.dtype == dtype
    got = [ce.numpy(), dh[:, :100].float().numpy(), dw[:, :100].float().numpy()]
    for a, b in zip(got, (jce, jdh, jdw)):
        b = np.asarray(b, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, **TOL)
        else:
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=2.0 ** -7 * np.abs(b).max())
    # the path's width takes no copy
    h896, w896 = torch.zeros(4, 896), torch.zeros(8, 896)
    assert all(a is b for a, b in zip(TC._pad_width(h896, w896), (h896, w896)))


def test_ce_bwd_plan_sizes_an_fp32_scratch_and_keeps_bf16s():
    """At the training shape the fp32 scratch dl [960, 151680] is 582.5 MB,
    twice bf16's, on the same segments and grids; bf16's plan is as it
    was (S 14 segments of 85 steps)."""
    f32 = TC._bwd_plan(960, 896, 151674, 132, torch.float32)
    bf16 = TC._bwd_plan(960, 896, 151674, 132)
    assert f32.scratch_bytes == 4 * 960 * 151680 == 582_451_200
    assert bf16.scratch_bytes == 291_225_600
    assert f32._replace(scratch_bytes=0) == bf16._replace(scratch_bytes=0)
    assert (bf16.S, bf16.seg_steps, bf16.dh_blocks, bf16.dw_blocks) == (14, 85, 784, 8295)


# ---------------------------------------------------------------------------
# the int8 products
# ---------------------------------------------------------------------------

def _int8_operands(M, K, N, seed):
    """numpy x [M, K] and g [M, N]; JAX's [K, N] codes and column scales;
    the port's [N, K] codes."""
    rng = np.random.RandomState(seed)
    jw, js = JQM.quantize_weight(jnp.asarray(0.05 * rng.randn(K, N), jnp.float32), 1)
    x = rng.randn(M, K).astype(np.float32)
    g = rng.randn(M, N).astype(np.float32)
    return x, g, jw, js, np.array(np.asarray(jw).T, order="C")


def _jax_int8(x, g, jw, js, monkeypatch=None):
    """(y, dx) of JAX's int8_matmul at fp32, and how many Pallas calls it traced."""
    calls = []
    if monkeypatch is not None:
        real = JQM.pl.pallas_call
        monkeypatch.setattr(JQM.pl, "pallas_call",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    f = jax.jit(lambda x_: JQM.int8_matmul(x_, jw, js))
    y, vjp = jax.vjp(f, jnp.asarray(x))
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(y), np.asarray(dx), len(calls)


@pytest.mark.parametrize("scale", ["fp32", "bf16"])
@pytest.mark.parametrize("M", [8, 128], ids=["xla_M8", "pallas_M128"])
def test_int8_at_fp32_matches_jax(monkeypatch, M, scale):
    """The forward (fp32 x) and the activation gradient (fp32 g) of the
    port against JAX's int8_matmul and its VJP at fp32, in JAX's XLA
    branch (M 8) and its Pallas kernel (M 128), with an fp32 and a bf16
    scale (the training step's frozen cast)."""
    x, g, jw, js, tw = _int8_operands(M, 96, 130, seed=M)
    if scale == "bf16":
        js = js.astype(jnp.bfloat16)
    jy, jdx, pallas = _jax_int8(x, g, jw, js, monkeypatch)
    assert (pallas >= 2) == (M == 128)             # forward and VJP through Pallas
    ts = torch.from_numpy(np.array(js.astype(jnp.float32)))
    ts = ts.bfloat16() if scale == "bf16" else ts
    xt = torch.from_numpy(x).requires_grad_(True)
    y = TQM.int8_matmul(xt, torch.from_numpy(tw), ts)
    y.backward(torch.from_numpy(g))
    dx = TQM.int8_matmul_dx(torch.from_numpy(g), torch.from_numpy(tw), ts)
    assert y.dtype == xt.grad.dtype == dx.dtype == torch.float32
    np.testing.assert_allclose(y.detach().numpy(), jy, **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), jdx, **TOL)
    np.testing.assert_allclose(dx.numpy(), jdx, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_int8_pads_k_100_and_an_odd_n_as_jax_computes_them(dtype):
    """K 100 is zero-padded to 112 and, for the bf16 gradient, N 101 to 102
    (`_pad_operands`, what the CUDA wrappers launch with); the plain
    versions on the padded operands, cut back, against JAX at K 100, N 101
    (fp32 at 1e-5; bf16 within a bf16 spacing)."""
    x, g, jw, js, tw = _int8_operands(40, 100, 101, seed=3)
    xt, gt = torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jy, jdx, _ = _jax_int8(jnp.asarray(xt.float().numpy(), jdt), jnp.asarray(
        gt.float().numpy(), jdt), jw, js)
    w_q, scale = torch.from_numpy(tw), torch.from_numpy(np.array(js))
    px, pw, ps = TQM._pad_operands(xt, w_q, scale, grad=False)
    assert px.shape == (40, 112) and pw.shape == (101, 112) and ps is scale
    y = TQM.int8_matmul_reference(px, pw, ps)
    pg, pw, ps = TQM._pad_operands(gt, w_q, scale.float(), grad=True,
                                   even_n=dtype == torch.bfloat16)
    assert pw.shape == ((102 if dtype == torch.bfloat16 else 101), 112) and pg.shape[1] == ps.shape[0]
    dx = TQM.int8_matmul_dx_reference(pg, pw, ps)[:, :100]
    for a, b in ((y, jy), (dx, jdx)):
        a, b = a.float().numpy(), np.asarray(b, np.float32)
        if dtype == torch.float32:
            np.testing.assert_allclose(a, b, **TOL)
        else:
            np.testing.assert_allclose(a, b, rtol=2.0 ** -7, atol=2.0 ** -7 * np.abs(b).max())
    # the path's shapes take no copy
    x896, w896 = torch.zeros(3, 896), torch.zeros(4864, 896, dtype=torch.int8)
    s896 = torch.ones(4864)
    assert all(a is b for a, b in zip(TQM._pad_operands(x896, w896, s896, grad=False),
                                      (x896, w896, s896)))


# ---------------------------------------------------------------------------
# the whole slice against JAX
# ---------------------------------------------------------------------------

def _tiny_port_cfg(jcfg):
    def conv(obj, cls):
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in dataclasses.asdict(obj).items() if k in names})
    top = {f.name for f in dataclasses.fields(tsim.SimLingoConfig)} - {"vit", "llm"}
    return tsim.SimLingoConfig(vit=conv(jcfg.vit, ViTConfig), llm=conv(jcfg.llm, Qwen2Config),
                               **{k: getattr(jcfg, k) for k in top})


@pytest.fixture(scope="module")
def tiny():
    base = jsim.SimLingoConfig.tiny()
    jcfg = dataclasses.replace(base, llm=dataclasses.replace(
        base.llm, lora_r=4, lora_alpha=8, lora_dropout=0.0))
    params = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    params["lora"] = jax.tree_util.tree_map(lambda x: x + 0.02, params["lora"])
    return jcfg, params


def _train_one_fp32_step(jcfg, params):
    """(the port's `trainer.train` record of one precision=fp32 step, JAX's
    fp32 step's metrics) on the same params and synthetic batch."""
    cfg = compose(["max_steps=1", "data.batch_size=2", "data.max_text_len=96",
                   "precision=fp32", "seed=0", "output_dir="])
    cfg.model = _tiny_port_cfg(jcfg)
    res = trainer.train(cfg, make_synthetic=True, params=params_from_jax(params, device="cpu"),
                        device="cpu")
    opt = jts.make_optimizer(jts.OptimizerConfig(**dataclasses.asdict(cfg.optimizer)))
    mask = jts.trainable_mask(params, jts.production_trainable)
    jstate = jts.init_train_state(params, opt, trainable_mask_tree=mask)
    jstep = jts.make_train_step(jcfg, opt, compute_dtype=jnp.float32, donate=False,
                                trainable_mask_tree=mask)
    _, jm = jstep(jstate, jsynthetic(jcfg, batch=2, seq_len=96, num_patches=2),
                  jax.random.PRNGKey(0))
    return res["records"][0], jm


def _dtypes_of(module, name, monkeypatch, arg=0):
    """Record the dtype of argument `arg` of each call of module.name."""
    seen = []
    real = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: seen.append(a[arg].dtype) or real(*a, **k))
    return seen


def test_trainer_at_fp32_with_both_gates_tracks_jax(tiny, monkeypatch):
    """`trainer.train` at precision=fp32 with SIMLINGO_CE_IMPL=pallas and
    SIMLINGO_LN_IMPL=pallas: the loss through the fused CE at fp32, one
    step against JAX's fp32 step with the same gates (its Pallas CE and
    norms in interpret mode), at 2e-4."""
    monkeypatch.setenv("SIMLINGO_CE_IMPL", "pallas")
    monkeypatch.setenv("SIMLINGO_LN_IMPL", "pallas")
    ce_calls = _dtypes_of(TA, "fused_ce", monkeypatch)
    rec, jm = _train_one_fp32_step(*tiny)
    assert ce_calls and set(ce_calls) == {torch.float32}
    for key in ("loss", "grad_norm", "language_loss", "route_loss"):
        np.testing.assert_allclose(rec[key], float(jm[key]), err_msg=key, **STEP_TOL)


def test_trainer_at_fp32_on_the_int8_base_tracks_jax(tiny, monkeypatch):
    """`trainer.train` at precision=fp32 on an int8 base LLM (JAX's
    quantize_llm, bridged): every frozen linear and the tied head through
    int8_matmul with fp32 activations and its fp32 gradient, one step
    against JAX's fp32 step on the same int8 params, at 2e-4."""
    monkeypatch.delenv("SIMLINGO_CE_IMPL", raising=False)
    monkeypatch.delenv("SIMLINGO_LN_IMPL", raising=False)
    jcfg, params = tiny
    params = dict(params, llm=jquantize_llm(params["llm"]))
    fwd = _dtypes_of(TQM, "int8_matmul_reference", monkeypatch)
    bwd = _dtypes_of(TQM, "int8_matmul_dx_reference", monkeypatch)
    rec, jm = _train_one_fp32_step(jcfg, params)
    assert fwd and bwd and set(fwd) == set(bwd) == {torch.float32}
    for key in ("loss", "grad_norm", "language_loss", "route_loss"):
        np.testing.assert_allclose(rec[key], float(jm[key]), err_msg=key, **STEP_TOL)


VIT = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
           image_size=448, patch_size=56, projector_out=64)
AGENT = dict(use_cot=True, max_new_tokens=8, spec_k=4, initial_frames_delay=0,
             jpeg_roundtrip=False, warmup_compile=False)


def test_fp32_agent_on_its_int8_llm_matches_jax(monkeypatch):
    """The tiny LingoAgent at compute_dtype float32 with the default int8
    LLM (CoT; speculative after the first frame) against JAX's
    LingoAgent(compute_dtype=jnp.float32) on the same weights and frames:
    language tokens equal, waypoints at 2e-4; every int8 product of the
    port's has fp32 activations."""
    vocab = JTokenizer().tk.vocab_size + 8
    img_id = JTokenizer().img_context_id
    jcfg = jsim.SimLingoConfig(
        vit=JViTConfig(**VIT), llm=JQwen2Config.tiny(vocab_size=vocab),
        img_context_token_id=img_id, remat_vision=False, remat_llm=False)
    tcfg = tsim.SimLingoConfig(vit=ViTConfig(**VIT), llm=Qwen2Config.tiny(vocab_size=vocab),
                               img_context_token_id=img_id)
    jparams = jax.jit(jsim.init_params, static_argnums=1)(jax.random.PRNGKey(1), jcfg)
    assert AgentConfig(**AGENT).int8_llm
    ja = jagent.LingoAgent(jparams, jcfg, JAgentConfig(**AGENT), tokenizer=JTokenizer(),
                           max_prompt_len=256, compute_dtype=jnp.float32)
    ta = tagent.LingoAgent(params_from_jax(jparams, device="cpu"), tcfg, AgentConfig(**AGENT),
                           tokenizer=SimLingoTokenizer(), max_prompt_len=256,
                           compute_dtype=torch.float32, device="cpu")
    seen = _dtypes_of(TQM, "int8_matmul_reference", monkeypatch)
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 255, (512, 1024, 3), np.uint8)
    for i, f in enumerate((dict(rgb=rgb, speed=2.0, target_point=np.array([9.0, -0.4]),
                                next_target_point=np.array([18.0, -1.0])),
                           dict(rgb=rgb[::-1].copy(), speed=2.5,
                                target_point=np.array([8.5, -0.2]),
                                next_target_point=np.array([17.0, -0.6])))):
        rj = ja.run_step(jagent.AgentFrame(**f))
        rt = ta.run_step(tagent.AgentFrame(**f))
        assert rt["language_tokens"] == rj["language_tokens"], i
        np.testing.assert_allclose(rt["route"], rj["route"], **STEP_TOL)
        np.testing.assert_allclose(rt["speed_wps"], rj["speed_wps"], **STEP_TOL)
    assert seen and set(seen) == {torch.float32}
    assert ta.spec_stats == ja.spec_stats and len(ta.spec_stats) == 1
