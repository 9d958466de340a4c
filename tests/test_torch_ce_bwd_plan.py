"""The fused cross-entropy backward's plan and its passes, on the CPU.

On the card `fused_ce_bwd` writes dlogits once to a scratch dl [N, Vpad]
(Vpad = 128 ceil(V / 128), zero past V), sums dh = dl w over S vocabulary
segments of whole 128-column steps into fp32 partials taken in segment
order, and with dW computes dl^T h. `_bwd_plan` is plain Python, so the
segments, the grids and the scratch size are held here. The passes in
plain PyTorch (`ce_dlogits_reference`, then `ce_dh_from_scratch_reference`
and `ce_dw_from_scratch_reference`) must give `fused_ce_bwd_plain`'s dh and
dW at fp32 2e-4 (relative to the largest element: sums over V or N terms
in another order), reading no scratch column that the plan does not write
(a scratch poisoned with NaN elsewhere), and JAX's `fused_ce` VJP (Pallas,
interpret mode) at the tolerance of tests/test_torch_fused_ce.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.kernels.fused_ce import fused_ce as jfused_ce
from simlingo_tpu_torch.kernels import fused_ce as TC

SMS = 132                        # streaming multiprocessors of an H100 SXM
STEP = TC._VSTEP


def _inputs(N, H, V, seed=0):
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randn(N, H).astype(np.float32))
    w = torch.from_numpy((0.3 * rs.randn(V, H)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, V, N))
    labels[0] = -100                                    # masked rows: any label
    g = torch.from_numpy(np.linspace(0.2, 1.7, N).astype(np.float32))
    logz, _ = TC.fused_ce_fwd_plain(h, labels, w)
    return h, labels, w, logz, g


def _close(got, want, name):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-4 * float(want.abs().max()), err_msg=name)


@pytest.mark.parametrize("N,H,V", [(1, 64, 1), (7, 64, 300), (100, 128, 1111),
                                   (130, 896, 40961), (960, 896, 5003),
                                   (960, 896, 151674), (4788, 896, 151674),
                                   (3, 512, 128 * 1185)])
def test_segments_are_whole_steps_that_cover_the_vocabulary(N, H, V):
    plan = TC._bwd_plan(N, H, V, SMS)
    assert plan.vpad % STEP == 0 and plan.vpad - STEP < V <= plan.vpad
    assert plan.segments[0][0] == 0 and plan.segments[-1][1] == plan.vpad
    for (a0, a1), (b0, _) in zip(plan.segments, plan.segments[1:]):
        assert a1 == b0                                 # no gap, no overlap
    for c0, c1 in plan.segments:
        assert c0 % STEP == 0 and c1 % STEP == 0 and c1 > c0     # none empty
        assert c1 - c0 <= plan.seg_steps * STEP
    assert len(plan.segments) == plan.S and plan.part_shape == (plan.S, N, H)
    assert plan.scratch_shape == (N, plan.vpad)
    assert plan.dlogits_blocks == -(-N // 128) * (plan.vpad // STEP)
    assert plan.dw_blocks == -(-H // 128) * (plan.vpad // 128)


@pytest.mark.parametrize("N,H,V", [(7, 64, 300), (100, 128, 1111), (130, 896, 40961),
                                   (960, 896, 151674), (4788, 896, 151674)])
@pytest.mark.parametrize("sms", [SMS, 114])
def test_each_segment_fits_one_wave_and_the_last_wave_is_filled_best(N, H, V, sms):
    """A segment's tiles fit one wave of resident blocks (they run together
    and share the segment's rows in L2); split only where the tiles alone
    leave the wave short, and then into the S <= 16 that fills the last
    wave best."""
    plan = TC._bwd_plan(N, H, V, sms)
    slots, steps = TC._DH_RESIDENT * sms, plan.vpad // STEP
    tiles = -(-N // 128) * -(-H // 128)
    assert plan.dh_blocks == tiles * plan.S and 1 <= plan.S <= TC._DH_MAX_SEGMENTS
    if tiles >= slots:
        assert plan.S == 1
        return
    fill = TC._wave_fill(plan.dh_blocks, slots)
    for s in range(1, min(steps, TC._DH_MAX_SEGMENTS) + 1):
        assert TC._wave_fill(tiles * TC._segments(steps, s)[0], slots) <= fill


def test_the_training_shape():
    plan = TC._bwd_plan(960, 896, 151674, SMS)
    assert plan.vpad == 151680 and plan.scratch_bytes == 291_225_600
    assert (plan.S, plan.seg_steps, plan.dh_blocks) == (14, 85, 784)   # 2.97 waves of 264
    assert plan.part_shape == (14, 960, 896) and plan.dlogits_blocks == 8 * 1185


@pytest.mark.parametrize("compute_dw", [False, True])
@pytest.mark.parametrize("V", [300, 1111, 5003])
@pytest.mark.parametrize("N", [7, 100, 960])
def test_two_pass_mirror_matches_the_plain_backward(N, V, compute_dw):
    H = 64
    h, labels, w, logz, g = _inputs(N, H, V, seed=N + V)
    plan = TC._bwd_plan(N, H, V, SMS)
    dl = TC.ce_dlogits_reference(h, labels, w, logz, g, plan)
    assert dl.shape == plan.scratch_shape and not dl[:, V:].any()
    want_dh, want_dw = TC.fused_ce_bwd_plain(h, labels, w, logz, g, compute_dw)
    _close(TC.ce_dh_from_scratch_reference(dl, w, plan), want_dh, "dh")
    if compute_dw:
        _close(TC.ce_dw_from_scratch_reference(dl, h, V), want_dw, "dw")
    else:
        assert want_dw is None


@pytest.mark.parametrize("N,V", [(7, 300), (100, 1111), (130, 40961)])
def test_unwritten_scratch_does_not_reach_dh_or_dw(N, V):
    """A scratch of NaN, in which the mirror writes the plan's dlogits
    tiles, rows < N, vocabulary tiles 0 .. Vpad / 128 - 1, a tile at a time:
    every column the dh segments read was written (the pad columns as 0),
    and dW reads only the columns below V."""
    H = 64
    h, labels, w, logz, g = _inputs(N, H, V, seed=1)
    plan = TC._bwd_plan(N, H, V, SMS)
    full = TC.ce_dlogits_reference(h, labels, w, logz, g, plan)
    dl = torch.full((N, plan.vpad + STEP), float("nan"))       # one tile past Vpad too
    for t in range(plan.dlogits_blocks // -(-N // 128)):
        dl[:, t * STEP:(t + 1) * STEP] = full[:, t * STEP:(t + 1) * STEP]
    assert torch.isnan(dl[:, plan.vpad:]).all()
    dh = TC.ce_dh_from_scratch_reference(dl[:, :plan.vpad], w, plan)
    dw = TC.ce_dw_from_scratch_reference(dl, h, V)
    assert torch.isfinite(dh).all() and torch.isfinite(dw).all()
    want_dh, want_dw = TC.fused_ce_bwd_plain(h, labels, w, logz, g, True)
    _close(dh, want_dh, "dh")
    _close(dw, want_dw, "dw")
    poisoned = full.clone()
    poisoned[:, V:] = float("nan")             # pad columns left unwritten: dh sees them
    assert torch.isnan(TC.ce_dh_from_scratch_reference(poisoned, w, plan)).any() == (V < plan.vpad)


@pytest.mark.parametrize("compute_dw", [False, True])
def test_two_pass_mirror_matches_jax(compute_dw):
    """The passes against jax.vjp of JAX's fused_ce (Pallas, interpret
    mode), at tests/test_torch_fused_ce.py's tolerance."""
    N, H, V = 40, 64, 1111
    h, labels, w, _, g = _inputs(N, H, V, seed=5)
    labels[0] = 3                                       # in range on both sides
    _, vjp = jax.vjp(lambda a, b: jfused_ce(a, jnp.asarray(labels.numpy()), b, compute_dw),
                     jnp.asarray(h.numpy()), jnp.asarray(w.numpy()))
    wdh, wdw = vjp(jnp.asarray(g.numpy()))
    logz, _ = TC.fused_ce_fwd_plain(h, labels, w)
    plan = TC._bwd_plan(N, H, V, SMS)
    dl = TC.ce_dlogits_reference(h, labels, w, logz, g, plan)
    for got, want in ((TC.ce_dh_from_scratch_reference(dl, w, plan), wdh),
                      (TC.ce_dw_from_scratch_reference(dl, h, V), wdw)):
        if not compute_dw and want is wdw:
            assert float(np.abs(np.asarray(wdw)).max()) == 0.0
            continue
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
