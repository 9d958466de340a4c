"""simlingo_tpu_torch kernel modules against the JAX package.

Plain versions (CPU) against the JAX functions: flash attention against
the Pallas kernel in interpret mode and against `attention_reference`;
the w8a16 matmul against JAX `int8_matmul` on both of its paths; the int8
quantizers bit for bit. Inputs come from numpy seeds; comparisons are fp32
at the package's parity tolerance (atol = rtol = 2e-4). The CUDA kernels
themselves are held against the plain versions in test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.core import quantize as JQ
from simlingo_tpu.kernels import flash_attention as JFA
from simlingo_tpu.kernels import quantized_matmul as JQM
from simlingo_tpu.models import qwen2 as jq
from simlingo_tpu_torch.core import quantize as TQ
from simlingo_tpu_torch.core.from_jax import params_from_jax
from simlingo_tpu_torch.kernels import flash_attention as TFA
from simlingo_tpu_torch.kernels import quantized_matmul as TQM

TOL = dict(atol=2e-4, rtol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x))


def _gqa_inputs(seed=0, B=2, T=20, S=40, HQ=4, HK=2, D=16):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, HQ, D).astype(np.float32)
    k = rng.randn(B, S, HK, D).astype(np.float32)
    v = rng.randn(B, S, HK, D).astype(np.float32)
    valid = np.ones((B, S), bool)
    valid[0, :7] = False                    # left padding
    valid[1, :3] = False
    return q, k, v, valid


def _visible_rows(valid, T, S, q_offset):
    """[B, T] rows that see at least one valid key under slot causality."""
    keys = np.arange(S)[None, :] <= np.arange(T)[:, None] + q_offset
    return (keys[None] & valid[:, None, :]).any(-1)


def test_attention_plain_matches_pallas_gqa_causal_offset():
    q, k, v, valid = _gqa_inputs()
    q_offset = 2
    ref = np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        causal=True, q_offset=q_offset))
    out = TFA.attention(_t(q), _t(k), _t(v), _t(valid), causal=True,
                        q_offset=q_offset).numpy()
    rows = _visible_rows(valid, q.shape[1], k.shape[1], q_offset)
    assert (~rows).any()          # the left pad leaves rows with no key
    np.testing.assert_allclose(out[rows], ref[rows], **TOL)


def test_attention_plain_matches_pallas_bt_hd_layout():
    rng = np.random.RandomState(1)
    B, T, H, D = 1, 24, 2, 64
    q, k, v = (rng.randn(B, T, H * D).astype(np.float32) for _ in range(3))
    ref = np.asarray(JFA.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None, causal=False,
        layout="bt_hd", num_heads=H, scale=D ** -0.5))
    out = TFA.attention(*(_t(x).view(B, T, H, D) for x in (q, k, v)), None,
                        causal=False, scale=D ** -0.5).reshape(B, T, H * D)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("causal,q_offset", [(True, None), (True, 2),
                                             (False, None)])
def test_attention_plain_matches_reference_all_rows(causal, q_offset):
    """Every row, fully masked ones included (they must be exactly 0)."""
    q, k, v, valid = _gqa_inputs(seed=2)
    ref = np.asarray(JFA.attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        causal=causal, q_offset=q_offset))
    out = TFA.attention(_t(q), _t(k), _t(v), _t(valid), causal=causal,
                        q_offset=q_offset).numpy()
    np.testing.assert_allclose(out, ref, **TOL)
    if causal and q_offset is not None:
        rows = _visible_rows(valid, q.shape[1], k.shape[1], q_offset)
        assert (out[~rows] == 0).all()


@pytest.mark.parametrize("M", [100, 1])           # Pallas path, XLA dot path
@pytest.mark.parametrize("transpose_rhs", [False, True])
def test_int8_matmul_plain_matches_jax(M, transpose_rhs):
    rng = np.random.RandomState(3)
    K, N = 96, 200
    x = rng.randn(M, K).astype(np.float32)
    if transpose_rhs:               # tied-head orientation: w [N, K], per row
        w = rng.randn(N, K).astype(np.float32) * 0.05
        jw_q, jscale = JQM.quantize_weight(jnp.asarray(w), axis=0)
        tw_q = _t(jw_q)
    else:                           # linear orientation: w [K, N], per column
        w = rng.randn(K, N).astype(np.float32) * 0.05
        jw_q, jscale = JQM.quantize_weight(jnp.asarray(w), axis=1)
        tw_q = _t(jw_q).t().contiguous()
    ref = np.asarray(JQM.int8_matmul(jnp.asarray(x), jw_q, jscale,
                                     transpose_rhs=transpose_rhs, block_n=128))
    out = TQM.int8_matmul(_t(x), tw_q, _t(jscale)).numpy()
    np.testing.assert_allclose(out, ref, **TOL)


@pytest.mark.parametrize("axis", [0, 1])
def test_quantize_weight_bit_identical(axis):
    rng = np.random.RandomState(4)
    w = rng.randn(64, 48).astype(np.float32) * 0.1
    w[3] = 0.0                                         # the 1e-8 floor
    w[:, 5] = 0.0
    jw_q, jscale = JQM.quantize_weight(jnp.asarray(w), axis=axis)
    tw_q, tscale = TQM.quantize_weight(_t(w), axis=axis)
    np.testing.assert_array_equal(tw_q.numpy(), np.asarray(jw_q))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


def test_quantize_llm_bit_identical_through_bridge():
    """Port-quantizing the bridged fp tree == bridging the JAX-quantized
    tree, leaf for leaf (int8 codes in the port's [N, K] layout)."""
    llm = jax.jit(jq.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jq.Qwen2Config.tiny())
    want = params_from_jax(JQ.quantize_llm(llm), device="cpu")
    got = TQ.quantize_llm(params_from_jax(llm, device="cpu"))

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for key in a:
            if isinstance(a[key], dict):
                walk(a[key], b[key], f"{path}/{key}")
            else:
                assert a[key].dtype == b[key].dtype, f"{path}/{key}"
                assert torch.equal(a[key], b[key]), f"{path}/{key}"
    walk(got, want)
    assert got["layers"]["0"]["mlp"]["gate"]["w_q"].shape == (128, 64)  # [N, K]
    with pytest.raises(NotImplementedError, match="A8"):
        TQ.quantize_llm(params_from_jax(llm, device="cpu"), bits=4)


# ---------------------------------------------------------------------------
# The backward (training): attention_bwd_reference, the plain version of
# flash_attn_bwd, at fp32 atol = rtol = 1e-4
# ---------------------------------------------------------------------------

BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def _bwd_case(seed, B, T, HQ, HK, D, pad_left):
    q, k, v, _ = _gqa_inputs(seed, B, T, T, HQ, HK, D)
    valid = np.ones((B, T), bool)
    valid[0, :pad_left] = False               # rows 0..pad_left-1 see no key
    valid[-1, T - 11:] = False                # right padding
    g = np.random.RandomState(seed + 1).randn(B, T, HQ, D).astype(np.float32)
    return q, k, v, valid, g


@pytest.mark.parametrize("causal", [True, False])
def test_attention_bwd_reference_matches_torch_autograd(causal):
    q, k, v, valid, g = _bwd_case(5, 2, 40, 4, 2, 16, pad_left=6)
    tq_, tk, tv = (_t(x).double().requires_grad_(True) for x in (q, k, v))
    out = TFA.attention_reference(tq_, tk, tv, _t(valid), causal)
    want = torch.autograd.grad(out, (tq_, tk, tv), _t(g).double())
    lse = TFA.attention_lse_reference(_t(q), _t(k), _t(valid), causal)
    got = TFA.attention_bwd_reference(_t(q), _t(k), _t(v), _t(valid),
                                      out.detach().float(), _t(g), lse, causal)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **BWD_TOL)
    # and through the autograd Function
    xs = [_t(x).requires_grad_(True) for x in (q, k, v)]
    fn = torch.autograd.grad(TFA.attention_train(*xs, _t(valid), causal),
                             xs, _t(g))
    for a, b, name in zip(fn, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **BWD_TOL)


def test_attention_bwd_reference_matches_pallas_gqa():
    """The Pallas `_bwd_kernel_gqa` path (HQ=4 over HK=2, causal, invalid
    keys at both ends), in interpret mode through jax.vjp; rows that see no
    valid key get a zero cotangent on the JAX side (its kernel is exact
    only for those)."""
    B, T, HQ, HK, D = 2, 96, 4, 2, 64
    q, k, v, valid, g = _bwd_case(7, B, T, HQ, HK, D, pad_left=5)
    g = g * _visible_rows(valid, T, T, 0)[:, :, None, None]
    out, vjp = jax.vjp(lambda q_, k_, v_: JFA.flash_attention(
        q_, k_, v_, jnp.asarray(valid), causal=True), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    lse = TFA.attention_lse_reference(_t(q), _t(k), _t(valid), True)
    got = TFA.attention_bwd_reference(_t(q), _t(k), _t(v), _t(valid),
                                      _t(np.asarray(out)), _t(g), lse, True)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name, **BWD_TOL)


def test_attention_bwd_reference_matches_pallas_bt_hd_pair():
    """The Pallas `_bwd_kernel_pair` path: flat [B, T, H*D] with 4 heads,
    non-causal; the port reads [B, T, H, D] views of the same arrays."""
    B, T, H, D = 2, 80, 4, 64
    rng = np.random.RandomState(9)
    q, k, v, g = (rng.randn(B, T, H * D).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda q_, k_, v_: JFA.flash_attention(
        q_, k_, v_, None, causal=False, layout="bt_hd", num_heads=H),
        *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    tq_, tk, tv, tg = (_t(x).view(B, T, H, D) for x in (q, k, v, g))
    out = TFA.attention_reference(tq_, tk, tv, None, False)
    lse = TFA.attention_lse_reference(tq_, tk, None, False)
    got = TFA.attention_bwd_reference(tq_, tk, tv, None, out, tg, lse, False)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.reshape(B, T, H * D).numpy(), np.asarray(b),
                                   err_msg=name, **BWD_TOL)
