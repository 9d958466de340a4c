"""The flash-attention backward's scratch plan and its two passes, on the CPU.

`flash_attn_bwd`'s dK/dV kernel writes the bf16 dS^T of each live (query
tile, key tile) pair to a scratch of key-major tiles, and its dQ kernel reads those
pairs back for dq = scale dS K. `_bwd_plan` is plain Python, so the pairs
and the scratch size are held here: every pair the dQ kernel reads is one
the dK/dV kernel writes, and the pairs are exactly those in which some
(row, key) is visible. The two passes in plain PyTorch
(`attention_ds_reference`, then `attention_dq_from_ds_reference` over a
scratch whose unwritten pairs hold NaN) must give the dq of `jax.vjp` of
the JAX package's `flash_attention` (Pallas, interpret mode) at 1e-4, and
exact zeros in rows that see no valid key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.kernels import flash_attention as JFA
from simlingo_tpu_torch.kernels import flash_attention as TFA

TOL = dict(atol=1e-4, rtol=1e-4)
BQ, BKV = TFA._BWD_TILE


def _visible_pairs(T, S, causal, q_offset):
    """(query tile, key tile) pairs holding a (row, key) the row sees, from
    the element mask."""
    n_qt, n_kt = -(-T // BQ), -(-S // BKV)
    mask = np.zeros((n_qt * BQ, n_kt * BKV), bool)
    mask[:T, :S] = True
    if causal:
        mask[:T, :S] &= np.arange(S)[None, :] <= np.arange(T)[:, None] + q_offset
    tiles = mask.reshape(n_qt, BQ, n_kt, BKV).any((1, 3))
    return {(int(qt), int(kt)) for qt, kt in zip(*np.nonzero(tiles))}


@pytest.mark.parametrize("T,S", [(1, 1), (1, 770), (63, 63), (64, 64), (65, 200),
                                 (798, 798), (1025, 1025)])
@pytest.mark.parametrize("causal,offset", [(True, "zero"), (True, "S-T"), (False, "zero")])
def test_pairs_read_are_written_and_are_the_visible_ones(T, S, causal, offset):
    q_offset = 0 if offset == "zero" else S - T
    plan = TFA._bwd_plan(2, T, S, 4, 2, causal, q_offset)
    assert plan.read <= plan.written
    assert plan.read == plan.written == _visible_pairs(T, S, causal, q_offset)
    assert plan.ds_shape == (2, 4, plan.n_kt, plan.n_qt, BKV, BQ)
    assert plan.n_kt * BKV >= S > (plan.n_kt - 1) * BKV
    assert plan.n_qt * BQ >= T > (plan.n_qt - 1) * BQ


@pytest.mark.parametrize("name,args,nbytes,pairs", [
    ("vit", (12, 1025, 1025, 16, 16, False, 0), 454_557_696, 17 * 17),
    ("llm", (6, 798, 798, 14, 2, True, 0), 116_293_632, 91)])
def test_scratch_at_the_training_shapes(name, args, nbytes, pairs):
    plan = TFA._bwd_plan(*args)
    B, T, S, HQ = args[:4]
    assert plan.ds_bytes == nbytes == 2 * B * HQ * -(-S // 64) * 64 * -(-T // 64) * 64
    assert len(plan.written) == len(plan.read) == pairs


def test_a_key_tile_without_a_valid_key_drops_out_of_every_pair():
    B, S = 3, 200
    valid = torch.ones(B, S, dtype=torch.bool)
    valid[0, :64] = False                     # tile 0 of row 0: no valid key
    valid[1, 70:] = False                     # tiles 2, 3 of row 1 (keys 128-199)
    valid[2, 130:191] = False                 # keys 191-199 keep tile 2 of row 2 live
    live = TFA._live_key_tiles(valid, B, S)
    assert live.tolist() == [[False, True, True, True], [True, True, False, False],
                             [True, True, True, True]]
    plan = TFA._bwd_plan(B, S, S, 2, 2, True, 0)
    mask = TFA._pair_mask(plan.read, plan, live)
    assert mask.shape == (B, 1, 4, 4, 1, 1)
    tiles = mask[:, 0, :, :, 0, 0]                        # [B, key tile, query tile]
    assert not tiles[0, 0].any() and not tiles[1, 2:].any()
    causal_pairs = torch.tensor([[kt <= qt for qt in range(4)] for kt in range(4)])
    assert torch.equal(tiles[2], causal_pairs)            # all live: the causal pairs
    assert torch.equal(tiles[0], causal_pairs & live[0][:, None])
    assert torch.equal(tiles[1], causal_pairs & live[1][:, None])


def test_the_scratch_holds_key_major_tiles():
    """Element (key s, row t) of head (b, h) sits in tile (s // 64, t // 64)
    at [s % 64][t % 64]; `_ds_matrix` undoes the tiling."""
    B, T, S, H = 1, 70, 130, 2
    rng = np.random.RandomState(3)
    q, k, v, g = (_t(rng.randn(B, L, H, 64).astype(np.float32))
                  for L in (T, S, S, T))
    out = TFA.attention_reference(q, k, v, None, False)
    lse = TFA.attention_lse_reference(q, k, None, False)
    ds = TFA.attention_ds_reference(q, k, v, None, out, g, lse, False)
    assert ds.shape == TFA._bwd_plan(B, T, S, H, H, False, S - T).ds_shape == (1, 2, 3, 2, 64, 64)
    _, want = TFA._probs_and_ds(q, k, v, None, out, g, lse, False, 64 ** -0.5, S - T)
    s_, t_ = 100, 65
    assert float(ds[0, 1, s_ // 64, t_ // 64, s_ % 64, t_ % 64]) == float(want[0, 1, t_, s_])
    mat = TFA._ds_matrix(ds)
    assert torch.equal(mat[:, :, :S, :T], want.transpose(2, 3))
    assert not mat[:, :, S:].any() and not mat[:, :, :, T:].any()


def _two_pass_dq(q, k, v, valid, out, g, causal, q_offset=None):
    """The two plain passes over a scratch whose unwritten pairs hold NaN."""
    B, T, HQ, _ = q.shape
    _, S, HK, _ = k.shape
    off = S - T if q_offset is None else q_offset
    lse = TFA.attention_lse_reference(q, k, valid, causal, q_offset=off)
    ds = TFA.attention_ds_reference(q, k, v, valid, out, g, lse, causal, q_offset=off)
    plan = TFA._bwd_plan(B, T, S, HQ, HK, causal, off)
    written = TFA._pair_mask(plan.written, plan, TFA._live_key_tiles(valid, B, S))
    ds = torch.where(written, ds, torch.tensor(float("nan")))
    dq = TFA.attention_dq_from_ds_reference(ds, k, valid, T, causal, q_offset=off)
    assert torch.isfinite(dq).all()
    return dq


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("T,pad_left", [(96, 5), (150, 70)])
def test_two_pass_dq_matches_pallas_gqa(T, pad_left):
    """The Pallas `_bwd_kernel_gqa` path through jax.vjp (HQ=4 over HK=2,
    causal, invalid keys at both ends; pad_left 70 leaves row 0's first key
    tile without a valid key). Rows that see no valid key get a zero
    cotangent on the JAX side (its kernel is exact only for those) and
    exact zeros from the port."""
    B, HQ, HK, D = 2, 4, 2, 64
    rng = np.random.RandomState(7)
    q = rng.randn(B, T, HQ, D).astype(np.float32)
    k, v = (rng.randn(B, T, HK, D).astype(np.float32) for _ in range(2))
    valid = np.ones((B, T), bool)
    valid[0, :pad_left] = False
    valid[-1, T - 11:] = False
    rows = (valid[:, None, :] & (np.arange(T)[None, :] <= np.arange(T)[:, None])).any(-1)
    assert (~rows).any()
    g = rng.randn(B, T, HQ, D).astype(np.float32) * rows[:, :, None, None]
    out, vjp = jax.vjp(lambda q_, k_, v_: JFA.flash_attention(
        q_, k_, v_, jnp.asarray(valid), causal=True), *map(jnp.asarray, (q, k, v)))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    dq = _two_pass_dq(_t(q), _t(k), _t(v), _t(valid), _t(np.asarray(out)), _t(g), True)
    np.testing.assert_allclose(dq.numpy(), want, **TOL)
    assert float(dq[torch.from_numpy(~rows)].abs().max()) == 0.0


def test_two_pass_dq_matches_pallas_bt_hd_pair():
    """The Pallas `_bwd_kernel_pair` path: flat [B, T, H*D] with 4 heads,
    non-causal, a ragged last tile; the port reads [B, T, H, D] views."""
    B, T, H, D = 2, 80, 4, 64
    rng = np.random.RandomState(9)
    q, k, v, g = (rng.randn(B, T, H * D).astype(np.float32) for _ in range(4))
    _, vjp = jax.vjp(lambda q_, k_, v_: JFA.flash_attention(
        q_, k_, v_, None, causal=False, layout="bt_hd", num_heads=H),
        *map(jnp.asarray, (q, k, v)))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    tq, tk, tv, tg = (_t(x).view(B, T, H, D) for x in (q, k, v, g))
    out = TFA.attention_reference(tq, tk, tv, None, False)
    dq = _two_pass_dq(tq, tk, tv, None, out, tg, False)
    np.testing.assert_allclose(dq.reshape(B, T, H * D).numpy(), want, **TOL)


# (D, built head dim, query rows of a dK/dV register pass, the capped
# dK/dV build's blocks an SM (0: none), the dK/dV kernel's shared memory)
HEAD_DIM_PLANS = [(16, 16, 64, 3, 28_672), (32, 32, 64, 3, 40_960), (64, 64, 64, 3, 65_536),
                  (128, 128, 32, 0, 114_688),
                  (8, 16, 64, 3, 28_672), (48, 64, 64, 3, 65_536), (80, 128, 32, 0, 114_688)]


@pytest.mark.parametrize("D,built,query_pass,capped,smem", HEAD_DIM_PLANS)
def test_the_plan_at_every_head_dim(D, built, query_pass, capped, smem):
    """The scratch and its pairs do not depend on D (the plan at D = 64 is
    the one of a call that names no D); a D without its own build takes the
    next one up, zero-padded; at D = 128 S^T and dP^T are held 32 query rows
    at a time and there is no capped build."""
    args = (6, 798, 798, 14, 2, True, 0)
    plan, today = TFA._bwd_plan(*args, D), TFA._bwd_plan(*args)
    assert plan[:6] == today[:6] and plan.ds_bytes == 116_293_632
    assert (today.head_dim, today.query_pass, today.dkdv_smem) == (64, 64, 65_536)
    assert (plan.head_dim, plan.query_pass, plan.dkdv_smem) == (built, query_pass, smem)
    assert TFA._bwd_geometry(built) == (BQ, BKV, capped, query_pass, smem)
    # the capped build where it exists and the grid fills 3 blocks an SM (the ViT's 3264)
    assert TFA._dkdv_blocks(12, 1025, 16, 132, D) == (3 if capped else 1)
    assert TFA._dkdv_blocks(6, 798, 2, 132, D) == 1


def test_a_head_dim_past_128_is_refused():
    with pytest.raises(ValueError, match="head_dim up to 128"):
        TFA._bwd_plan(1, 16, 16, 2, 2, True, 0, 160)
    with pytest.raises(ValueError, match="head_dim up to 128"):
        TFA._fwd_plan(1, 16, 16, 2, 2, True, 0, D=160)


@pytest.mark.parametrize("causal", [False, True])
def test_zero_padding_to_the_built_head_dim_is_exact(causal):
    """The wrapper's route for a D without its own build: q, k, v, o and
    dout zero-padded to the next built head dim, the scale kept at D ** -0.5,
    the padded columns cut off. In the plain versions (fp32) the forward,
    the lse and the three gradients are those of D."""
    D, d = 40, TFA._instance_dim(40)
    assert d == 64
    rng = np.random.RandomState(D)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 37, 4, D).astype(np.float32)) for _ in range(4))
    k, v = k[:, :, :2], v[:, :, :2]
    out = TFA.attention_reference(q, k, v, None, causal)
    lse = TFA.attention_lse_reference(q, k, None, causal)
    grads = TFA.attention_bwd_reference(q, k, v, None, out, do, lse, causal)
    qp, kp, vp, op, dop = (TFA._pad_d(x, d) for x in (q, k, v, out, do))
    assert qp.shape[-1] == d and not qp[..., D:].any()
    np.testing.assert_allclose(
        TFA.attention_reference(qp, kp, vp, None, causal, D ** -0.5)[..., :D].numpy(),
        out.numpy(), atol=1e-6, rtol=1e-6)
    lse_p = TFA.attention_lse_reference(qp, kp, None, causal, D ** -0.5)
    np.testing.assert_allclose(lse_p.numpy(), lse.numpy(), atol=1e-6, rtol=1e-6)
    for g, gp in zip(grads, TFA.attention_bwd_reference(qp, kp, vp, None, op, dop, lse_p,
                                                        causal, D ** -0.5)):
        assert not gp[..., D:].any()
        np.testing.assert_allclose(gp[..., :D].numpy(), g.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("causal,D", [(True, 64), (False, 16)])
def test_the_backward_bound_holds_dS_terms_and_the_output_rounding(causal, D):
    """`attention_bwd_bound`, the rounding bound every backward check on the
    card shares, is at least the |dS|-terms bound (|dS| <= P (|dO| |V| +
    |delta|)) and holds the plain gradients rounded to bf16."""
    g = torch.Generator().manual_seed(D)
    B, T, HQ, HK = 2, 70, 4, 2
    q = torch.randn(B, T, HQ, D, generator=g)
    k, v = (torch.randn(B, T, HK, D, generator=g) for _ in range(2))
    dout = torch.randn(B, T, HQ, D, generator=g)
    valid = torch.ones(B, T, dtype=torch.bool)
    valid[0, :5] = False
    o = TFA.attention_reference(q, k, v, valid, causal)
    lse = TFA.attention_lse_reference(q, k, valid, causal)
    args = (q, k, v, valid, o, dout, lse, causal)
    ref = TFA.attention_bwd_reference(*args)
    bounds = TFA.attention_bwd_bound(*args, ref)
    for r, m, t in zip(ref, TFA.attention_bwd_reference(*args, abs_terms=True), bounds):
        rms = float(r.square().mean().sqrt())
        assert bool((t >= 2.0 ** -8 * (m + r.abs()) + 1e-5 * rms).all())
        assert bool(((r.bfloat16().float() - r).abs() <= t).all())
