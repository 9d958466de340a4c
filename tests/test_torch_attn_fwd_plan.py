"""The attention forward's plan and its split path, on the CPU.

`flash_attn_fwd` takes one of two paths, chosen by `_fwd_plan` (plain
Python, so it is held here): the tiled path (blocks of 64 query rows of one
head) and, where a GQA group's packed rows (group x T) are few, the
split path: the group's heads packed into one block's rows as the Pallas
`_fwd_kernel_gqa` packs them, the keys cut into splits of whole 64-key
tiles, and the partial (m, l, O) of every split merged in split order.
Held here: the splits' key ranges partition [0, kv_end) in whole tiles and
the grid does not depend on q_offset; each packed row is one (head, t); the
row blocks cover every row; the path is the one the threshold names. The
split path in plain PyTorch (`attention_split_reference`) must give the
output of the JAX package's `flash_attention` (Pallas, interpret mode) and
of `attention_reference` at fp32 1e-4, exact zeros and lse -inf in rows
that see no valid key, and no NaN from a split that sees none.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.kernels import flash_attention as JFA
from simlingo_tpu_torch.kernels import flash_attention as TFA

TOL = dict(atol=1e-4, rtol=1e-4)
TILE = TFA._FWD_TILE

# (name, B, T, S, HQ, HK, causal, q_offset)
SHAPES = [
    ("decode", 1, 1, 770, 14, 2, True, 700),
    ("verify", 1, 16, 770, 14, 2, True, 690),
    ("queries", 1, 30, 770, 14, 2, True, 740),
    ("prefill", 1, 640, 770, 14, 2, True, 0),
    ("drive_only", 1, 670, 670, 14, 2, True, 0),
    ("vit", 2, 1025, 1025, 16, 16, False, 0),
    ("vit_train", 12, 1025, 1025, 16, 16, False, 0),
    ("llm_train", 6, 798, 798, 14, 2, True, 0),
    ("T1_S1", 1, 1, 1, 2, 1, True, 0),
    ("S_ragged", 2, 5, 100, 4, 2, True, 95),
    ("q_offset_0", 1, 16, 770, 14, 2, True, 0),
    ("long_cache", 1, 1, 2000, 14, 2, True, 1999),
    ("cache_1100", 1, 16, 1100, 14, 2, True, 1084),
]


@pytest.mark.parametrize("name,B,T,S,HQ,HK,causal,q_offset", SHAPES)
def test_splits_partition_the_visible_keys_in_whole_tiles(name, B, T, S, HQ, HK, causal,
                                                          q_offset):
    plan = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset)
    assert plan.kv_end == (min(S, q_offset + T) if causal else S)
    ranges = plan.key_ranges
    assert ranges[0][0] == 0 and ranges[-1][1] == plan.kv_end
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:]):
        assert hi == nlo                                   # no gap, no overlap
    for lo, hi in ranges:
        assert lo <= hi
        assert lo % TILE == 0 or lo == plan.kv_end         # whole tiles
        assert hi % TILE == 0 or hi == plan.kv_end
    if plan.path == "split":
        n_kt = -(-S // TILE)
        assert 1 <= plan.splits <= TFA.SPLIT_MAX and len(ranges) == plan.splits
        assert plan.splits * plan.tiles_per_split >= n_kt > (plan.splits - 1) * plan.tiles_per_split
        for s, (lo, hi) in enumerate(ranges):               # split s: its own tiles
            assert lo == min(s * plan.tiles_per_split * TILE, plan.kv_end)
            assert hi - lo <= plan.tiles_per_split * TILE
    else:
        assert plan.splits == 0 and ranges == ((0, plan.kv_end),)


@pytest.mark.parametrize("name,B,T,S,HQ,HK,causal,q_offset", SHAPES)
def test_the_grid_depends_on_S_and_not_on_q_offset(name, B, T, S, HQ, HK, causal, q_offset):
    a = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset)
    b = TFA._fwd_plan(B, T, S, HQ, HK, causal, max(0, q_offset - 300))
    assert (a.path, a.splits, a.tiles_per_split, a.grid) == \
        (b.path, b.splits, b.tiles_per_split, b.grid)
    if a.path == "split":
        assert a.grid == (a.splits, a.row_blocks, B * HK)
    else:
        assert a.grid == (a.row_blocks, HQ, B)


# the shapes whose rows can see fewer than one tile of keys by position
FEW_KEYS = {"prefill", "drive_only", "llm_train", "T1_S1", "q_offset_0"}


@pytest.mark.parametrize("name,B,T,S,HQ,HK,causal,q_offset", SHAPES)
def test_the_remainder_build_only_where_a_row_sees_under_a_tile(name, B, T, S, HQ, HK,
                                                                causal, q_offset):
    plan = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset)
    t = np.arange(T)
    seen = np.minimum(S, np.maximum(0, q_offset + t + 1)) if causal else np.full(T, S)
    assert plan.remainder == bool(seen.min() < TILE) == (name in FEW_KEYS)


@pytest.mark.parametrize("name,B,T,S,HQ,HK,causal,q_offset", SHAPES)
def test_row_blocks_cover_every_row(name, B, T, S, HQ, HK, causal, q_offset):
    plan = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset)
    rows_a_block = TFA._FWD_ROWS
    assert plan.rows == ((HQ // HK) * T if plan.path == "split" else T)
    assert plan.row_blocks * rows_a_block >= plan.rows > (plan.row_blocks - 1) * rows_a_block


@pytest.mark.parametrize("group,T", [(7, 1), (7, 16), (7, 30), (1, 5), (4, 37)])
def test_each_packed_row_is_one_head_and_t(group, T):
    hg, t = TFA._packed_rows(group, T)
    pairs = list(zip(hg.tolist(), t.tolist()))
    assert len(pairs) == group * T
    assert set(pairs) == {(h, i) for h in range(group) for i in range(T)}
    assert pairs == sorted(pairs)                          # head-major, as _fwd_kernel_gqa


@pytest.mark.parametrize("name,B,T,S,HQ,HK,causal,q_offset,path", [
    ("decode", 1, 1, 770, 14, 2, True, 700, "split"),
    ("verify", 1, 16, 770, 14, 2, True, 690, "split"),
    ("queries", 1, 30, 770, 14, 2, True, 740, "split"),
    ("group_at_the_threshold", 1, 256, 770, 14, 2, True, 500, "split"),
    ("group_past_the_threshold", 1, 257, 770, 14, 2, True, 500, "tiled"),
    ("prefill", 1, 640, 770, 14, 2, True, 0, "tiled"),
    ("vit", 2, 1025, 1025, 16, 16, False, 0, "tiled"),
    ("llm_train", 6, 798, 798, 14, 2, True, 0, "tiled")])
def test_the_path_is_the_one_the_threshold_names(name, B, T, S, HQ, HK, causal, q_offset, path):
    plan = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset, sms=132)
    assert plan.path == path
    blocks_a_split = -(-(HQ // HK) * T // TFA._FWD_ROWS) * B * HK
    assert (plan.path == "split") == ((HQ // HK) * T <= TFA.SPLIT_MAX_ROWS
                                      and 2 * blocks_a_split <= 132)


@pytest.mark.parametrize("T,splits,tiles", [(1, 7, 2), (16, 7, 2), (30, 7, 2), (64, 7, 2),
                                             (128, 4, 4), (256, 2, 7)])
def test_serving_splits_fill_one_block_an_sm_at_most(T, splits, tiles):
    """The 13 key tiles of the 770-key cache: at most SPLIT_MAX splits, and
    no more than leave one block an SM."""
    plan = TFA._fwd_plan(1, T, 770, 14, 2, True, 770 - T, sms=132)
    assert (plan.splits, plan.tiles_per_split) == (splits, tiles)
    assert plan.splits * plan.row_blocks * 2 <= 132


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(B, T, S, HQ, HK, seed, invalid=()):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, T, HQ, 64).astype(np.float32)
    k, v = (rng.randn(B, S, HK, 64).astype(np.float32) for _ in range(2))
    valid = np.ones((B, S), bool)
    for b, lo, hi in invalid:
        valid[b, lo:hi] = False
    return q, k, v, valid


def _rows_seen(valid, T, S, causal, q_offset):
    """[B, T] bool: the rows that see a valid key."""
    vis = valid[:, None, :].repeat(T, 1)
    if causal:
        vis = vis & (np.arange(S)[None, :] <= np.arange(T)[:, None] + q_offset)[None]
    return vis.any(-1)


@pytest.mark.parametrize("B,T,S,HQ,HK,causal,q_offset,invalid,max_splits", [
    (1, 1, 200, 4, 2, True, 150, [(0, 0, 30)], 8),           # decode: 4 one-tile splits
    (1, 16, 200, 4, 2, True, 130, [(0, 0, 30)], 2),           # verify: 2 splits of 2 tiles
    (1, 30, 260, 14, 2, True, 230, [(0, 0, 40), (0, 200, 230)], 8),   # the queries
    (2, 7, 100, 4, 2, True, 93, [(1, 0, 70)], 1),             # S ragged, one split
    (2, 5, 130, 2, 2, False, 0, [(0, 64, 128)], 8),          # a split (tile 1) with no valid key
    (1, 12, 140, 4, 2, True, 0, [(0, 0, 5)], 8),             # q_offset 0: early rows see none
])
def test_split_reference_matches_pallas_gqa_and_plain(B, T, S, HQ, HK, causal, q_offset,
                                                      invalid, max_splits):
    q, k, v, valid = _inputs(B, T, S, HQ, HK, seed=T + S, invalid=invalid)
    want = np.asarray(JFA.flash_attention(*map(jnp.asarray, (q, k, v, valid)), causal=causal,
                                          q_offset=q_offset))
    plan = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset, split_rows=1 << 30,
                         max_splits=max_splits)
    args = (_t(q), _t(k), _t(v), _t(valid), causal, None, q_offset)
    out, lse = TFA.attention_split_reference(*args, return_lse=True, plan=plan)
    assert torch.isfinite(out).all() and not torch.isnan(lse).any()
    seen = _rows_seen(valid, T, S, causal, q_offset)                  # [B, T]
    np.testing.assert_allclose(out.numpy()[seen], want[seen], **TOL)
    np.testing.assert_allclose(out.numpy(), TFA.attention_reference(*args).numpy(), **TOL)
    want_lse = TFA.attention_lse_reference(*args[:2], args[3], causal, None, q_offset)
    assert torch.equal(torch.isfinite(lse), torch.isfinite(want_lse))
    fin = torch.isfinite(want_lse)
    np.testing.assert_allclose(lse[fin].numpy(), want_lse[fin].numpy(), **TOL)
    assert float(out.numpy()[~seen].__abs__().max(initial=0.0)) == 0.0
    assert bool((lse.transpose(1, 2)[torch.from_numpy(~seen)] == float("-inf")).all())


def test_split_reference_matches_pallas_bt_hd_pair():
    """The Pallas `_fwd_kernel_pair` path: flat [B, T, H*D] with 4 heads,
    non-causal (the ViT); the port reads [B, T, H, D] views."""
    B, T, H = 2, 80, 4
    rng = np.random.RandomState(11)
    q, k, v = (rng.randn(B, T, H * 64).astype(np.float32) for _ in range(3))
    want = np.asarray(JFA.flash_attention(*map(jnp.asarray, (q, k, v)), None, causal=False,
                                          layout="bt_hd", num_heads=H))
    tq, tk, tv = (_t(x).view(B, T, H, 64) for x in (q, k, v))
    plan = TFA._fwd_plan(B, T, T, H, H, False, 0, split_rows=1 << 30)
    out = TFA.attention_split_reference(tq, tk, tv, None, False, plan=plan)
    np.testing.assert_allclose(out.reshape(B, T, H * 64).numpy(), want, **TOL)


@pytest.mark.parametrize("max_splits", [1, 2, 3, 8])
def test_the_merge_does_not_depend_on_the_split_count(max_splits):
    q, k, v, valid = _inputs(1, 9, 330, 6, 2, seed=4, invalid=[(0, 0, 20), (0, 300, 330)])
    args = (_t(q), _t(k), _t(v), _t(valid), True, None, 321)
    plan = TFA._fwd_plan(1, 9, 330, 6, 2, True, 321, split_rows=1 << 30, max_splits=max_splits)
    assert plan.splits == min(max_splits, 6) or plan.tiles_per_split > 1
    out, lse = TFA.attention_split_reference(*args, return_lse=True, plan=plan)
    np.testing.assert_allclose(out.numpy(), TFA.attention_reference(*args).numpy(), **TOL)
    np.testing.assert_allclose(lse.numpy(), TFA.attention_lse_reference(
        *args[:2], args[3], True, None, 321).numpy(), **TOL)


def test_no_valid_key_gives_zeros_and_minus_infinity():
    q, k, v, _ = _inputs(2, 4, 150, 4, 2, seed=5)
    valid = torch.zeros(2, 150, dtype=torch.bool)
    out, lse = TFA.attention_split_reference(_t(q), _t(k), _t(v), valid, True, q_offset=146,
                                             return_lse=True)
    assert float(out.abs().max()) == 0.0
    assert bool((lse == float("-inf")).all())


def test_a_split_past_the_last_visible_key_merges_as_nothing():
    """Decode early in the cache: q_offset 70 leaves splits 1..6 (of two
    tiles each) of the 770-key cache with no visible key (empty key
    ranges)."""
    q, k, v, valid = _inputs(1, 1, 770, 14, 2, seed=6, invalid=[(0, 0, 40)])
    plan = TFA._fwd_plan(1, 1, 770, 14, 2, True, 70)
    assert plan.path == "split" and plan.key_ranges == ((0, 71),) + ((71, 71),) * 6
    args = (_t(q), _t(k), _t(v), _t(valid), True, None, 70)
    out, lse = TFA.attention_split_reference(*args, return_lse=True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out.numpy(), TFA.attention_reference(*args).numpy(), **TOL)


@pytest.mark.parametrize("max_splits", [0, TFA.SPLIT_MAX + 1])
def test_the_plan_refuses_split_counts_outside_one_portable_cluster(max_splits):
    """The split kernel's cluster is at most the portable 8 blocks; the
    wrapper takes only the plan's knobs, so a plan cannot outgrow it."""
    assert TFA.SPLIT_MAX == TFA._FWD_GEOMETRY[2] == 8
    with pytest.raises(ValueError):
        TFA._fwd_plan(1, 1, 770, 14, 2, True, 769, split_rows=1 << 30, max_splits=max_splits)


@pytest.mark.parametrize("D,built", [(16, 16), (32, 32), (64, 64), (128, 128), (8, 16),
                                     (48, 64), (80, 128), (112, 128)])
@pytest.mark.parametrize("name,B,T,S,HQ,HK,causal,q_offset",
                         [c for c in SHAPES if c[0] in ("decode", "prefill", "vit", "llm_train")])
def test_the_plan_at_every_head_dim(name, B, T, S, HQ, HK, causal, q_offset, D, built):
    """The path, the splits and the grid do not depend on D (the plan at D
    = 64 is the one of a call that names no D); a D without its own build
    takes the next one up, zero-padded, with its 3-stage K/V ring."""
    today = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset)
    plan = TFA._fwd_plan(B, T, S, HQ, HK, causal, q_offset, D=D)
    assert plan[:9] == today[:9]
    assert (today.head_dim, today.smem_bytes) == (64, 55_296)
    assert (plan.head_dim, plan.smem_bytes) == (built, 3 * 2 * TILE * (built + 8) * 2)
    assert TFA._instance_dim(D) == built in TFA.HEAD_DIMS
