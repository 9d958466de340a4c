"""The fp32 path of the port's kernels (training at precision=fp32), on the CPU.

JAX trains at fp32 through its Pallas kernels, which work in their
operands' dtype; the port's CUDA wrappers take fp32 through fp32 builds of
the attention, dropout and norm kernels. Here, with no card, the same
seeded numpy inputs go through JAX's Pallas kernels in interpret mode and
the port's fp32 plain versions (what a wrapper runs on a CPU tensor), at
1e-5:

* the attention forward with its base-2 lse through each of JAX's three
  forward kernels (`_fwd_kernel_pair`, `_fwd_kernel_gqa`, `_fwd_kernel`),
  causal with a q offset and key masks; the backward (jax.vjp) and the two
  passes of the port's scratch (`attention_ds_reference`, then
  `attention_dq_from_ds_reference` over an fp32 scratch whose unwritten
  pairs hold NaN);
* dropout's kept values at fp32 (x / (1 - rate) in fp32; the streams
  differ by design) and its mask, equal at fp32 and bf16 for one seed;
* LayerNorm and RMSNorm forward and backward.

Then the fp32 plans and geometry (shared memory at each head dim, the fp32
dS^T scratch, bf16's plans unchanged), the kernels' calls in a training
step at fp32 and at bf16 against chip_smoke.py's `train_launches_per_step`,
and the whole slice: one `trainer.train` step at precision=fp32 with the
LN gate, held to JAX's fp32 gated step at 2e-4.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.data.synthetic import synthetic_example as jsynthetic
from simlingo_tpu.kernels import dropout as JD
from simlingo_tpu.kernels import flash_attention as JFA
from simlingo_tpu.kernels.layernorm import layernorm_fused as jln
from simlingo_tpu.kernels.layernorm import rmsnorm_fused as jrms
from simlingo_tpu.models import simlingo as jsim
from simlingo_tpu.train import train_step as jts
from simlingo_tpu_torch.core.config import compose
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.kernels import dropout as TD
from simlingo_tpu_torch.kernels import flash_attention as TFA
from simlingo_tpu_torch.kernels import layernorm as TL
from simlingo_tpu_torch.models import simlingo as tsim
from simlingo_tpu_torch.models.qwen2 import Qwen2Config
from simlingo_tpu_torch.models.vit import ViTConfig
from simlingo_tpu_torch.train import train_step as tts
from simlingo_tpu_torch.train import trainer

TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = Path(__file__).resolve().parents[1]


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _inputs(seed, B, T, S, HQ, HK, D):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, HQ, D).astype(np.float32)
    k, v = (rng.randn(B, S, HK, D).astype(np.float32) for _ in range(2))
    return q, k, v, rng.randn(B, T, HQ, D).astype(np.float32)


def _ceil128(n):
    return -(-n // 128) * 128


def _jax_fwd(q, k, v, valid, causal, q_offset, pair=False):
    """JAX's Pallas forward in interpret mode with its lse: the kernel that
    `flash_attention` dispatches to (one query block and one key block at
    these sizes), called through its `_*_fwd_impl` so the lse comes back.
    Returns (out [B, T, HQ, D], base-2 lse [B, HQ, T]) as numpy."""
    B, T, HQ, D = q.shape
    S, HK = k.shape[1], k.shape[2]
    G = HQ // HK
    bq, bk = _ceil128(T), _ceil128(S)
    q_off = jnp.full((1, 1), q_offset, jnp.int32)
    kv = np.ones((B, S), np.int32) if valid is None else valid.astype(np.int32)
    kv = JFA._pad_to(jnp.asarray(kv), 1, bk)[:, None, :]
    scale = D ** -0.5
    if pair:                                   # flat [B, T, H * D], two heads a block
        qt, kt, vt = (JFA._pad_to(jnp.asarray(x.reshape(x.shape[0], x.shape[1], -1)), 1, b)
                      for x, b in ((q, bq), (k, bk), (v, bk)))
        out, lse = JFA._flash_lm_fwd_impl(qt, kt, vt, kv, q_off, HQ, causal, scale, bq, bk)
        out = np.asarray(out)[:, :T].reshape(B, T, HQ, D)
        return out, np.asarray(lse)[:, :, 0, :T]
    qt, kt, vt = (JFA._pad_to(jnp.asarray(x.transpose(0, 2, 1, 3)), 2, b)
                  for x, b in ((q, bq), (k, bk), (v, bk)))
    if G > 1:
        out, lse = JFA._flash_gqa_fwd_impl(qt.reshape(B, HK, G, bq, D), kt, vt, kv, q_off,
                                           causal, scale, bq, bk)
        out = np.asarray(out).reshape(B, HQ, bq, D)
        lse = np.asarray(lse)[:, :, 0].reshape(B, HK, G, bq).reshape(B, HQ, bq)
    else:
        out, lse = JFA._flash_fwd_impl(qt, kt, vt, kv, q_off, causal, scale, bq, bk)
        out, lse = np.asarray(out), np.asarray(lse)[:, :, 0]
    return out[:, :, :T].transpose(0, 2, 1, 3), lse[:, :, :T]


def _seen(T, S, valid, causal, q_offset):
    """[B, T] bool: rows that see a valid key (JAX leaves the others' output
    unspecified; the port gives 0 and lse -inf)."""
    mask = np.ones((T, S), bool)
    if causal:
        mask &= np.arange(S)[None, :] <= np.arange(T)[:, None] + q_offset
    return (mask[None] & valid[:, None, :]).any(-1)


# (name, B, T, S, HQ, HK, D, causal, q_offset, masked): pair = the ViT's
# `_fwd_kernel_pair` (flat heads, non-causal), gqa = the LLM's, one = group 1
FWD_CASES = [("pair", 2, 77, 77, 4, 4, 64, False, 0, False),
             ("gqa_offset_masked", 2, 40, 100, 4, 2, 32, True, 60, True),
             ("gqa_train", 2, 96, 96, 6, 2, 16, True, 0, True),
             ("one_offset_masked", 1, 33, 70, 2, 2, 128, True, 37, True)]


@pytest.mark.parametrize("name,B,T,S,HQ,HK,D,causal,q_offset,masked", FWD_CASES,
                         ids=[c[0] for c in FWD_CASES])
def test_fp32_attention_forward_and_lse_match_pallas(name, B, T, S, HQ, HK, D, causal,
                                                     q_offset, masked):
    q, k, v, _ = _inputs(len(name), B, T, S, HQ, HK, D)
    valid = np.ones((B, S), bool)
    if masked:
        valid[0, :5] = False
        valid[-1, S - 7:] = False
    want, want_lse = _jax_fwd(q, k, v, valid, causal, q_offset, pair=name == "pair")
    tv = _t(valid) if masked else None
    out = TFA.attention_reference(_t(q), _t(k), _t(v), tv, causal, None, q_offset)
    lse = TFA.attention_lse_reference(_t(q), _t(k), tv, causal, None, q_offset)
    assert out.dtype == torch.float32
    seen = _seen(T, S, valid, causal, q_offset)
    np.testing.assert_allclose(out.numpy()[seen], want[seen], **TOL)
    np.testing.assert_allclose(lse.numpy().transpose(0, 2, 1)[seen],
                               want_lse.transpose(0, 2, 1)[seen], **TOL)
    assert (out.numpy()[~seen] == 0).all()
    assert np.isneginf(lse.numpy().transpose(0, 2, 1)[~seen]).all()


def _jax_vjp(q, k, v, valid, causal, g, pair=False):
    H = q.shape[2]
    if pair:
        def f(q_, k_, v_):
            flat = (x.reshape(x.shape[0], x.shape[1], -1) for x in (q_, k_, v_))
            return JFA.flash_attention(*flat, None, causal=causal, layout="bt_hd",
                                       num_heads=H).reshape(q_.shape)
    else:
        def f(q_, k_, v_):
            return JFA.flash_attention(q_, k_, v_, jnp.asarray(valid), causal=causal)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


# (name, B, T, HQ, HK, D, causal, pad_left): the backward's self-attention
# shapes (the training path's: T == S, slot 0 first)
BWD_CASES = [("pair", 2, 70, 4, 4, 64, False, 0), ("gqa", 2, 96, 4, 2, 32, True, 5),
             ("gqa_empty_tile", 2, 150, 4, 2, 16, True, 70), ("one", 1, 45, 2, 2, 128, True, 3)]


def _bwd_case(name, B, T, HQ, HK, D, causal, pad_left):
    q, k, v, g = _inputs(len(name) + 7, B, T, T, HQ, HK, D)
    valid = np.ones((B, T), bool)
    valid[0, :pad_left] = False
    seen = _seen(T, T, valid, causal, 0)
    g = g * seen[:, :, None, None]          # JAX is exact only where a row sees a key
    return q, k, v, g, valid, seen


@pytest.mark.parametrize("name,B,T,HQ,HK,D,causal,pad_left", BWD_CASES,
                         ids=[c[0] for c in BWD_CASES])
def test_fp32_attention_backward_and_its_two_passes_match_pallas(name, B, T, HQ, HK, D,
                                                                 causal, pad_left):
    q, k, v, g, valid, seen = _bwd_case(name, B, T, HQ, HK, D, causal, pad_left)
    want = _jax_vjp(q, k, v, valid, causal, g, pair=name == "pair")
    tq, tk, tv, tg, tvalid = (_t(x) for x in (q, k, v, g, valid))
    out = TFA.attention_reference(tq, tk, tv, tvalid, causal)
    lse = TFA.attention_lse_reference(tq, tk, tvalid, causal)
    got = TFA.attention_bwd_reference(tq, tk, tv, tvalid, out, tg, lse, causal)
    for x, w, what in zip(got, want, ("dq", "dk", "dv")):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), w, err_msg=what, **TOL)
    # the two passes over an fp32 scratch, the pairs the dK/dV kernel does
    # not write holding NaN (never read)
    plan = TFA._bwd_plan(B, T, T, HQ, HK, causal, 0, D, torch.float32)
    assert plan.ds_dtype == torch.float32 and plan.ds_bytes == 4 * np.prod(plan.ds_shape)
    ds = TFA.attention_ds_reference(tq, tk, tv, tvalid, out, tg, lse, causal)
    written = TFA._pair_mask(plan.written, plan, TFA._live_key_tiles(tvalid, B, T))
    ds = torch.where(written, ds, torch.full((), float("nan")))
    assert ds.dtype == torch.float32 and ds.shape == plan.ds_shape
    dq = TFA.attention_dq_from_ds_reference(ds, tk, tvalid, T, causal)
    np.testing.assert_allclose(dq.numpy(), want[0], **TOL)
    assert float(dq[torch.from_numpy(~seen)].abs().sum()) == 0.0


def test_fp32_dropout_keeps_values_as_jax_does():
    """JAX's dropout (interpret) keeps x * (1 / (1 - rate)) in x's dtype;
    the port's fp32 plain version keeps the same fp32 products (its mask is
    Philox's, JAX's threefry's: the kept values are compared where each
    keeps)."""
    rate = 0.1
    x = np.random.RandomState(5).randn(4, 96, 128).astype(np.float32)
    want = np.asarray(JD.hw_dropout(jnp.asarray(x), jnp.asarray([11], jnp.int32), rate))
    got = TD.dropout_plain(_t(x), 11, rate).numpy()
    assert got.dtype == np.float32 and want.dtype == np.float32
    for out in (want, got):
        kept = out != 0
        assert 0.88 < kept.mean() < 0.92
        np.testing.assert_array_equal(out[kept], (_t(x[kept]) * TD.inv_keep(rate)).numpy())


@pytest.mark.parametrize("shape,block", [((6, 40, 96), None), ((1003,), None),
                                         ((4, 24, 16), (2, 8, 48)),
                                         ((2, 6, 16), (3, 0, 16, 3, 12))])
def test_fp32_dropout_mask_equals_the_bf16_mask(shape, block):
    """One seed, one mask: the mask is Philox of the flat index, whatever
    the element type (the CUDA kernel's fp32 and bf16 instances share it)."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(3)) + 4.0   # no zeros
    keep32 = TD.dropout_plain(x, 0xC0FFEE, 0.3, block) != 0
    keep16 = TD.dropout_plain(x.bfloat16(), 0xC0FFEE, 0.3, block) != 0
    assert torch.equal(keep32, keep16)
    want = TD.keep_mask(x.numel(), 0xC0FFEE, 0.3, "cpu", block, shape[-1]).view(shape)
    assert torch.equal(keep32, want)
    out = TD.dropout(x, 0xC0FFEE, 0.3, block)
    assert out.dtype == torch.float32
    assert torch.equal(out[keep32], x[keep32] * TD.inv_keep(0.3))


@pytest.mark.parametrize("fam,shape", [("layernorm", (7, 1024)), ("layernorm", (3, 37, 128)),
                                       ("rmsnorm", (5, 896)), ("rmsnorm", (2, 33, 64))])
def test_fp32_norms_forward_and_backward_match_pallas(fam, shape):
    rs = np.random.RandomState(len(shape) + shape[-1])
    d = shape[-1]
    x = (2 * rs.randn(*shape) + 0.3).astype(np.float32)
    scale = (1 + 0.1 * rs.randn(d)).astype(np.float32)
    bias = (0.1 * rs.randn(d)).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    ln = fam == "layernorm"
    if ln:
        want, vjp = jax.vjp(lambda a, s, b: jln(a, s, b, 1e-6), x, scale, bias)
    else:
        want, vjp = jax.vjp(lambda a, s: jrms(a, s, 1e-6), x, scale)
    wgrads = vjp(dy)
    x2 = _t(x).reshape(-1, d)
    if ln:
        y, mean, rstd = TL.layernorm_fwd(x2, _t(scale), _t(bias), 1e-6)
        grads = TL.layernorm_bwd(x2, _t(scale), mean, rstd, _t(dy).reshape(-1, d))
    else:
        y, rstd = TL.rmsnorm_fwd(x2, _t(scale), 1e-6)
        grads = TL.rmsnorm_bwd(x2, _t(scale), rstd, _t(dy).reshape(-1, d))
    assert y.dtype == torch.float32 and grads[0].dtype == torch.float32
    np.testing.assert_allclose(y.reshape(shape).numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(grads[0].reshape(shape).numpy(), np.asarray(wgrads[0]), **TOL)
    for got, w in zip(grads[1:], wgrads[1:]):       # sums over the rows
        w = np.asarray(w)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


# ---------------------------------------------------------------------------
# plans and geometry at fp32
# ---------------------------------------------------------------------------

# the largest dynamic shared memory a block can opt into on an H100
SMEM_LIMIT = 232_448


@pytest.mark.parametrize("D", TFA.HEAD_DIMS)
def test_fp32_forward_shared_memory_fits_at_every_head_dim(D):
    """Q, a 2-stage K/V ring (rows of D + 4 floats) and P [64][68]."""
    smem = TFA._fwd_smem_bytes(D, torch.float32)
    assert smem == 4 * (64 * (D + 4) + 2 * 2 * 64 * (D + 4) + 64 * 68) <= SMEM_LIMIT
    assert TFA._fwd_smem_bytes(D) == 3 * 2 * 64 * (D + 8) * 2       # bf16: unchanged
    assert TFA._bwd_geometry(D, torch.float32)[4] <= SMEM_LIMIT
    assert {64: 104_448, 128: 186_368}.get(D, smem) == smem


@pytest.mark.parametrize("T,S,q_offset", [(1, 770, 700), (16, 770, 690), (30, 770, 740),
                                          (640, 770, 0), (1025, 1025, 0)])
def test_fp32_forward_plan_is_the_tiled_path(T, S, q_offset):
    """fp32 takes the tiled path at every T (the split path serves bf16
    decode), with no remainder build; bf16 keeps its plan."""
    plan = TFA._fwd_plan(1, T, S, 14, 2, True, q_offset, D=64, dtype=torch.float32)
    assert plan.path == "tiled" and not plan.remainder and plan.dtype == torch.float32
    assert plan.grid == (-(-T // 64), 14, 1) and plan.smem_bytes == 104_448
    bf16 = TFA._fwd_plan(1, T, S, 14, 2, True, q_offset, D=64)
    assert bf16.smem_bytes == 55_296 and bf16.dtype == torch.bfloat16
    assert bf16.path == ("split" if T <= 128 else "tiled")


@pytest.mark.parametrize("name,args,fp32_bytes", [
    ("vit", (12, 1025, 1025, 16, 16, False, 0), 909_115_392),
    ("llm", (6, 798, 798, 14, 2, True, 0), 232_587_264),
    ("tiny", (2, 43, 43, 2, 2, True, 0), 4 * 2 * 2 * 64 * 64)])
def test_fp32_backward_scratch_at_the_training_shapes(name, args, fp32_bytes):
    """The fp32 dS^T scratch is twice the bf16 one, the same pairs."""
    f32 = TFA._bwd_plan(*args, 64, torch.float32)
    bf16 = TFA._bwd_plan(*args)
    assert f32.ds_bytes == fp32_bytes == 2 * bf16.ds_bytes
    assert (f32.ds_dtype, bf16.ds_dtype) == (torch.float32, torch.bfloat16)
    assert f32.written == bf16.written and f32.read == bf16.read
    assert f32.ds_shape == bf16.ds_shape and f32.query_pass == 64
    assert TFA._dkdv_blocks(args[0], args[2], args[4], 132, 64, torch.float32) == 1
    assert bf16.dkdv_smem == TFA._bwd_geometry(64)[4] == 65_536


def test_fp32_norm_plans_take_twice_the_warps_past_512():
    """fp32 rows of d > 512 take twice bf16's warps a row (a thread's
    vectors hold the registers bf16's do), so fewer rows a block."""
    for d in (896, 1024, 4096):
        v16, w16 = TL._norm_width(d)
        v32, w32 = TL._norm_width(d, torch.float32)
        assert v32 * w32 == v16 * w16 and w32 == min(2 * w16, 8)
        f = TL._norm_fwd_plan(12300, d, 132, torch.float32)
        assert f.threads == 256 and f.blocks == min(-(-12300 // (256 // (32 * w32))), 64 * 132)
        assert TL._norm_bwd_plan(12300, d, 132, True, torch.float32).blocks == 132
    assert TL._norm_width(512, torch.float32) == TL._norm_width(512)


# ---------------------------------------------------------------------------
# the kernels' calls in a step, and the whole slice against JAX
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_step_calls_the_kernels_as_chip_smoke_reckons_at_both_precisions(tiny, monkeypatch,
                                                                         dtype):
    """A CPU step of the tiny LoRA model (dropout on) calls the attention
    forward with lse, its backward and dropout exactly as many times as
    `train_launches_per_step` reckons for the model, at fp32 and at bf16:
    on the card each call is one launch, of the fp32 or the bf16 build."""
    jcfg, params = tiny
    cfg = _tiny_port_cfg(jcfg)
    cfg = dataclasses.replace(cfg, llm=dataclasses.replace(cfg.llm, lora_dropout=0.1))
    calls = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "dropout": 0}
    for module, fn, key in ((TFA, "attention_lse_reference", "flash_attn_fwd"),
                            (TFA, "attention_bwd_reference", "flash_attn_bwd"),
                            (TD, "dropout_plain", "dropout")):
        real = getattr(module, fn)
        monkeypatch.setattr(module, fn, lambda *a, _f=real, _k=key, **kw:
                            calls.__setitem__(_k, calls[_k] + 1) or _f(*a, **kw))
    opt = tts.OptimizerConfig(lr=1e-3, total_steps=10)
    state = tts.init_train_state(params_from_jax(params, device="cpu"), opt)
    batch = jsynthetic(jcfg, batch=2, seq_len=96, num_patches=1, seed=3)
    from simlingo_tpu_torch.core.from_jax import example_from_jax
    step = tts.make_train_step(cfg, opt, compute_dtype=dtype)
    m = step(state, example_from_jax(batch, device="cpu"), 5)
    assert np.isfinite(float(m["loss"]))
    assert calls == _chip_smoke().train_launches_per_step(cfg)


def test_trainer_at_fp32_with_the_ln_gate_tracks_jax(tiny, monkeypatch):
    """The whole slice: `trainer.train` (what train_torch.py runs) on the
    synthetic batch at precision=fp32 with SIMLINGO_LN_IMPL=pallas, one
    step, against JAX's fp32 step with the same gate (its Pallas norms in
    interpret mode) on the same params and batch, at 2e-4."""
    monkeypatch.setenv("SIMLINGO_LN_IMPL", "pallas")
    jcfg, params = tiny
    cfg = compose(["max_steps=1", "data.batch_size=2", "data.max_text_len=96",
                   "precision=fp32", "seed=0", "output_dir="])
    cfg.model = _tiny_port_cfg(jcfg)
    hooks = []
    real = TL.layernorm_fused
    monkeypatch.setattr(TL, "layernorm_fused", lambda *a: hooks.append(1) or real(*a))
    res = trainer.train(cfg, make_synthetic=True, params=params_from_jax(params, device="cpu"),
                        device="cpu")
    assert hooks, "the LN gate did not route the norms through kernels/layernorm.py"
    opt = jts.make_optimizer(jts.OptimizerConfig(**dataclasses.asdict(cfg.optimizer)))
    mask = jts.trainable_mask(params, jts.production_trainable)
    jstate = jts.init_train_state(params, opt, trainable_mask_tree=mask)
    jstep = jts.make_train_step(jcfg, opt, compute_dtype=jnp.float32, donate=False,
                                trainable_mask_tree=mask)
    ex = jsynthetic(jcfg, batch=2, seq_len=96, num_patches=2)
    _, jm = jstep(jstate, ex, jax.random.PRNGKey(0))
    rec = res["records"][0]
    for key in ("loss", "grad_norm", "language_loss", "route_loss"):
        np.testing.assert_allclose(rec[key], float(jm[key]), atol=2e-4, rtol=2e-4,
                                   err_msg=key)
