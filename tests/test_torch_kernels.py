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
