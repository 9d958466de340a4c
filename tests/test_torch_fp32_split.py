"""The split-fp32 tile product, on the CPU.

The fp32 builds of the fused CE (forward and backward) and of the w8a16
products (forward and activation gradient) run on the tensor cores with
split operands (`csrc/f32_tc_tile.cuh`): each fp32 element is big + small
in TF32, and a step sums three products (two against int8 codes, exact in
TF32) before an fp32 add. With no card here, the arithmetic is held
through its plain PyTorch model (`simlingo_tpu_torch/kernels/split_model.py`):

* the split itself: TF32 rounding keeps 11 significant bits, big + small
  rebuilds an fp32 value within 2^-22 of it over the normal range, every
  int8 code splits with small 0;
* the modelled products of the CE (the forward's ce and logz; the
  backward's dlogits, dh, dW) and of the int8 forward and gradient against
  fp64 within chip_smoke.py's fp32 bounds (which one TF32 product
  exceeds), at ragged shapes;
* the modelled products' errors at most chip_smoke.py's SPLIT_VS_TF32 of
  one TF32 product's, which tells the split from a build that dropped its
  small terms at shapes where the fp32 bounds pass both;
* the modelled products against JAX's `fused_ce` (Pallas, interpret mode)
  and `int8_matmul` and its VJP at fp32 on the same seeded numpy inputs, at
  the 1e-5 of tests/test_torch_fp32_ce_int8.py;
* the split products' plan (`_split_plan`) and the geometry the wrappers
  check, against the CUDA sources' constants.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simlingo_tpu.kernels import quantized_matmul as JQM
from simlingo_tpu.kernels.fused_ce import fused_ce as jfused_ce
from simlingo_tpu_torch.kernels import fused_ce as TC
from simlingo_tpu_torch.kernels import quantized_matmul as TQM
from simlingo_tpu_torch.kernels import split_model as SM

ROOT = Path(TQM.__file__).resolve().parents[2]
CSRC = ROOT / "simlingo_tpu_torch" / "csrc"
TOL = dict(atol=1e-5, rtol=1e-5)


def _smoke():
    """chip_smoke.py, loaded by path (it imports torch only when run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def _normal_values(lo, hi, n=20000, seed=0):
    """fp32 values of both signs with exponents in [lo, hi)."""
    rs = np.random.RandomState(seed)
    mant = rs.uniform(1.0, 2.0, n)
    exp = rs.randint(lo, hi, n)
    sign = np.where(rs.rand(n) < 0.5, -1.0, 1.0)
    return torch.from_numpy((sign * mant * 2.0 ** exp).astype(np.float32))


# exponent ranges of fp32's normal values, down to where small (2^-11 x)
# would leave the normal range and short of where big would round to inf
EXPONENTS = [(-100, -60), (-60, -20), (-20, 0), (0, 20), (20, 60), (60, 127)]


@pytest.mark.parametrize("lo,hi", EXPONENTS)
def test_tf32_round_keeps_11_significant_bits(lo, hi):
    """big = rna_tf32(x) has its low 13 mantissa bits zero and lies within
    half a TF32 spacing of x, 2^-11 |x|; a tie rounds away from zero."""
    x = _normal_values(lo, hi, seed=lo + 200)
    big = SM.tf32_round(x)
    assert int((big.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((big.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all())
    assert torch.equal(torch.sign(big), torch.sign(x))
    ties = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11])
    assert SM.tf32_round(ties).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10),
                                            1.0 + 2.0 ** -9]


@pytest.mark.parametrize("lo,hi", EXPONENTS)
def test_split_rebuilds_fp32_within_2_to_the_minus_22(lo, hi):
    """big + small = x within 2^-22 |x| (in fp64), small within 2^-11 |x|,
    both TF32: the two parts keep about 22 of fp32's 24 bits."""
    x = _normal_values(lo, hi, seed=lo + 300)
    big, small = SM.split_tf32(x)
    assert torch.equal(SM.tf32_round(small), small)
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all()), float((err / x.double().abs()).max())
    assert bool((small.double().abs() <= 2.0 ** -11 * x.double().abs()).all())


def test_every_int8_code_splits_with_small_zero():
    """Every int8 code is exact in TF32: big is the code, small 0, so the
    int8 forward's weight needs one term, not two."""
    codes = torch.arange(-128, 128, dtype=torch.float32)
    big, small = SM.split_tf32(codes)
    assert torch.equal(big, codes) and int(torch.count_nonzero(small)) == 0
    w = torch.arange(-127, 128, dtype=torch.int8).reshape(15, 17)
    x = torch.randn(3, 17, generator=torch.Generator().manual_seed(0))
    assert torch.equal(SM.split_product(x, w.float(), exact_b=True),
                       SM.split_product(x, w.float()))
    with pytest.raises(ValueError, match="exact"):
        SM.split_product(x, 0.3 * w.float(), exact_b=True)


# ---------------------------------------------------------------------------
# the modelled products against fp64, within the card's fp32 bounds
# ---------------------------------------------------------------------------

def _ce_inputs(N, H, V, seed):
    """chip_smoke.py run_fp32_ce_checks' inputs, from numpy: h ~ N(0, 1),
    the head 0.02 N(0, 1), labels with two outside [0, V), g a masked
    mean's cotangent."""
    rs = np.random.RandomState(seed)
    h = torch.from_numpy(rs.randn(N, H).astype(np.float32))
    w = torch.from_numpy((0.02 * rs.randn(V, H)).astype(np.float32))
    labels = torch.from_numpy(rs.randint(0, V, N))
    labels[0], labels[-1] = -100, V
    g = torch.from_numpy(((rs.rand(N) < 0.8) / (0.8 * N)).astype(np.float32))
    return h, labels, w, g


def _ratio(got, ref, tol):
    return float(((got.double() - ref.double()).abs() / tol).max())


CE_SHAPES = [(100, 128, 1111), (37, 96, 300), (129, 64, 257)]


@pytest.mark.parametrize("N,H,V", CE_SHAPES)
def test_modelled_ce_backward_is_within_the_fp32_bounds(N, H, V):
    """The model of the split CE backward against fp64 on the same fp32
    inputs, at chip_smoke.py's bounds: the dlogits scratch within
    fp32_unit(H) (|ref| + g p A) and 0 past V; dh within fp32_unit(H + V),
    dW within fp32_unit(H + N) of (sum |terms| + |ref|) + 1e-6 rms(ref),
    each on the plan's segments (S > 1 here); and dh, dW of the model's own
    scratch within fp32_unit(V) / fp32_unit(N), pass by pass."""
    h, labels, w, g = _ce_inputs(N, H, V, seed=N + V)
    unit = SMOKE.fp32_unit
    logz, _ = TC.fused_ce_fwd_plain(h, labels, w)
    plan = TC._bwd_plan(N, H, V, 4, torch.float32)
    assert plan.S > 1
    dl, dh, dw = SM.ce_bwd_model(h, labels, w, logz, g, plan.segments)
    h64, w64, g64 = h.double(), w.double(), g.double()
    args64 = (h64, labels, w64, logz.double(), g64)
    ref_dl = TC.ce_dlogits_reference(*args64, plan)
    pa = (torch.exp(h64 @ w64.t() - args64[3][:, None]) * (h64.abs() @ w64.abs().t())
          * g64.abs()[:, None])
    assert _ratio(dl[:, :V], ref_dl[:, :V], unit(H) * (ref_dl[:, :V].abs() + pa) + 1e-30) <= 1.0
    assert int(torch.count_nonzero(dl[:, V:])) == 0
    rdh, rdw = TC.fused_ce_bwd_plain(*args64, True)
    mdh, mdw = TC.fused_ce_bwd_plain(*args64, True, abs_terms=True)
    for got, ref, terms, n in ((dh, rdh, mdh, H + V), (dw, rdw, mdw, H + N)):
        tol = unit(n) * (terms + ref.abs()) + 1e-6 * float(ref.square().mean().sqrt())
        assert _ratio(got, ref, tol) <= 1.0
    dl64 = dl.double()
    want = TC.ce_dh_from_scratch_reference(dl64, w64, plan)
    terms = TC.ce_dh_from_scratch_reference(dl64, w64, plan, abs_terms=True)
    assert _ratio(dh, want, unit(V) * (terms + want.abs()) + 1e-6 * float(
        want.square().mean().sqrt())) <= 1.0
    want = TC.ce_dw_from_scratch_reference(dl64, h64, V)
    terms = TC.ce_dw_from_scratch_reference(dl64, h64, V, abs_terms=True)
    assert _ratio(dw, want, unit(N) * (terms + want.abs()) + 1e-6 * float(
        want.square().mean().sqrt())) <= 1.0


INT8_SHAPES = [(40, 112, 101), (64, 896, 96), (5, 4864, 33)]      # (M, K, N)


@pytest.mark.parametrize("scale", ["fp32", "bf16"])
@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_modelled_int8_forward_is_within_the_fp32_bound(M, K, N, scale):
    """The model of the split int8 forward (x split, the codes exact: two
    products a step) against fp64 on the same fp32 x, within chip_smoke.py's
    fp32_unit(K) (sum |terms| + |ref|) + 1e-6 rms(ref); K 112 is K 100
    zero-padded, as the wrapper launches it. One TF32 product (x rounded
    once) exceeds the bound at K <= 896 (at 4864 the bound's sum of
    |terms| has grown past TF32's error)."""
    rs = np.random.RandomState(M + K + N)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32))
    if K == 112:
        x[:, 100:] = 0.0
    w_q, s = TQM.quantize_weight(torch.from_numpy((0.02 * rs.randn(N, K)).astype(np.float32)))
    s = s.bfloat16() if scale == "bf16" else s
    ref = TQM.int8_matmul_reference(x.double(), w_q, s)
    terms = TQM.int8_matmul_reference(x.double(), w_q, s, abs_terms=True)
    tol = SMOKE.fp32_unit(K) * (terms + ref.abs()) + 1e-6 * float(ref.square().mean().sqrt())
    assert _ratio(SM.int8_forward_model(x, w_q, s), ref, tol) <= 1.0
    one_tf32 = (SM.tf32_round(x) @ w_q.float().t()) * s.float()
    assert K > 896 or _ratio(one_tf32, ref, tol) > 1.0


def _dx_inputs(M, K, N, seed):
    """g [M, N] ~ N(0, 1) and a [N, K] int8 weight with a bf16 scale (the
    training step's frozen cast), K 112 as K 100 zero-padded."""
    rs = np.random.RandomState(seed)
    g = torch.from_numpy(rs.randn(M, N).astype(np.float32))
    w = torch.from_numpy((0.02 * rs.randn(N, K)).astype(np.float32))
    if K == 112:
        w[:, 100:] = 0.0
    w_q, s = TQM.quantize_weight(w)
    return g, w_q, s.bfloat16()


def _dx_tol(g, w_q, s):
    """chip_smoke.py's fp32 bound of the gradient: fp32_unit(N) (sum |terms|
    + |ref|) + 1e-6 rms(ref), about the fp64 plain version; and that ref."""
    ref = TQM.int8_matmul_dx_reference(g.double(), w_q, s)
    terms = TQM.int8_matmul_dx_reference(g.double(), w_q, s, abs_terms=True)
    return ref, (SMOKE.fp32_unit(w_q.shape[0]) * (terms + ref.abs())
                 + 1e-6 * float(ref.square().mean().sqrt()))


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_modelled_int8_dx_is_within_the_fp32_bound(M, K, N):
    """The model of the split int8 gradient (g * scale rounded once in
    fp32, then split; the codes exact: two products a step) against fp64
    on the same fp32 g, within chip_smoke.py's fp32_unit(N) bound, where
    one TF32 product (g * scale rounded to TF32 once) exceeds it."""
    g, w_q, s = _dx_inputs(M, K, N, seed=M + K + N + 2)
    ref, tol = _dx_tol(g, w_q, s)
    assert _ratio(SM.int8_dx_model(g, w_q, s), ref, tol) <= 1.0
    assert _ratio(SMOKE.int8_dx_tf32(g, w_q, s), ref, tol) > 1.0


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_modelled_int8_dx_sits_far_below_one_tf32_product(M, K, N):
    """chip_smoke.py's SPLIT_VS_TF32 test at the int8 gradient: the split
    model's err/tol against fp64, at the fp32 bound, is at most 1/16 of the
    TF32 plain version's (g * scale rounded to TF32 once, as the card's
    control computes it)."""
    g, w_q, s = _dx_inputs(M, K, N, seed=M + K + N + 3)
    ref, tol = _dx_tol(g, w_q, s)
    split = _ratio(SM.int8_dx_model(g, w_q, s), ref, tol)
    one = _ratio(SMOKE.int8_dx_tf32(g, w_q, s), ref, tol)
    assert split <= SMOKE.SPLIT_VS_TF32 * one, (split, one)


def _ce_fwd_tol(h, labels, w):
    """chip_smoke.py's fp32 bounds of ce and logz about the fp64 plain
    version: fp32_unit(H) times their |h| |w| sums + fp32_unit(V) +
    2^-22 |ref|; (ref ce, ref logz, ce's tol, logz's tol)."""
    N, H = h.shape
    V = w.shape[0]
    h64, w64 = h.double(), w.double()
    rlogz, rce = TC.fused_ce_fwd_plain(h64, labels, w64)
    lz_terms, ce_terms = TC.fused_ce_fwd_plain(h64, labels, w64, abs_terms=True)

    def tol(ref, terms):
        return SMOKE.fp32_unit(H) * terms + SMOKE.fp32_unit(V) + 2.0 ** -22 * ref.abs()
    return rce, rlogz, tol(rce, ce_terms), tol(rlogz, lz_terms)


@pytest.mark.parametrize("N,H,V", CE_SHAPES)
def test_modelled_ce_forward_is_within_the_fp32_bounds(N, H, V):
    """The model of the split CE forward (the split logits, each 128-column
    tile's max and sum, merged as ce_fwd_finalize_kernel merges them)
    against fp64 on the same fp32 inputs, ce and logz within chip_smoke.py's
    fp32 bounds; its gold logits are the backward model's logits, bit for
    bit (the kernels share one logits routine)."""
    h, labels, w, _ = _ce_inputs(N, H, V, seed=N + V + 2)
    logz, ce = SM.ce_fwd_model(h, labels, w)
    rce, rlogz, ce_tol, lz_tol = _ce_fwd_tol(h, labels, w)
    assert _ratio(ce, rce, ce_tol) <= 1.0 and _ratio(logz, rlogz, lz_tol) <= 1.0
    ok = (labels >= 0) & (labels < V)
    dl, _, _ = SM.ce_bwd_model(h, labels, w, logz, torch.ones(N), ((0, 128 * -(-V // 128)),),
                               compute_dw=False)
    at = labels.clamp(0, V - 1)[:, None]
    assert torch.equal(dl.gather(1, at)[:, 0][ok], (torch.exp(-ce) - 1.0)[ok])


@pytest.mark.parametrize("N,H,V", CE_SHAPES)
def test_modelled_ce_forward_sits_far_below_one_tf32_product(N, H, V):
    """chip_smoke.py's SPLIT_VS_TF32 test at the CE forward: the split
    model's ce and logz, each at its fp32 bound against fp64, read at most
    1/16 of the TF32 plain version's (h and w rounded to TF32 once, as the
    card's control computes it)."""
    h, labels, w, _ = _ce_inputs(N, H, V, seed=N + V + 3)
    logz, ce = SM.ce_fwd_model(h, labels, w)
    rce, rlogz, ce_tol, lz_tol = _ce_fwd_tol(h, labels, w)
    one_lz, one_ce = TC.fused_ce_fwd_plain(SM.tf32_round(h), labels, SM.tf32_round(w))
    split = max(_ratio(ce, rce, ce_tol), _ratio(logz, rlogz, lz_tol))
    one = max(_ratio(one_ce, rce, ce_tol), _ratio(one_lz, rlogz, lz_tol))
    assert split <= SMOKE.SPLIT_VS_TF32 * one, (split, one)


@pytest.mark.parametrize("M,K,N", INT8_SHAPES)
def test_modelled_int8_forward_sits_far_below_one_tf32_product(M, K, N):
    """chip_smoke.py's SPLIT_VS_TF32 test at the int8 forward: the split
    model's err/tol against fp64, at the fp32 bound, is at most 1/16 of the
    TF32 plain version's (x rounded to TF32 once, as the card's control
    computes it), at K 4864 too, where the bound alone passes both."""
    rs = np.random.RandomState(M + K + N + 1)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32))
    w_q, s = TQM.quantize_weight(torch.from_numpy((0.02 * rs.randn(N, K)).astype(np.float32)))
    ref = TQM.int8_matmul_reference(x.double(), w_q, s)
    terms = TQM.int8_matmul_reference(x.double(), w_q, s, abs_terms=True)
    tol = SMOKE.fp32_unit(K) * (terms + ref.abs()) + 1e-6 * float(ref.square().mean().sqrt())
    split = _ratio(SM.int8_forward_model(x, w_q, s), ref, tol)
    one = _ratio(TQM.int8_matmul_reference(SM.tf32_round(x), w_q, s), ref, tol)
    assert split <= SMOKE.SPLIT_VS_TF32 * one, (split, one)


@pytest.mark.parametrize("N,H,V", CE_SHAPES)
def test_modelled_ce_backward_sits_far_below_one_tf32_product(N, H, V):
    """chip_smoke.py's SPLIT_VS_TF32 test at the CE backward: the split
    model's dlogits, dh and dW, each at its fp32 bound against fp64, read at
    most 1/16 of the TF32 plain version's, whose three products are one
    TF32 product each (operands rounded once, as the card's control)."""
    h, labels, w, g = _ce_inputs(N, H, V, seed=N + V + 1)
    unit = SMOKE.fp32_unit
    logz, _ = TC.fused_ce_fwd_plain(h, labels, w)
    plan = TC._bwd_plan(N, H, V, 4, torch.float32)
    dl, dh, dw = SM.ce_bwd_model(h, labels, w, logz, g, plan.segments)
    h64, w64, g64 = h.double(), w.double(), g.double()
    args64 = (h64, labels, w64, logz.double(), g64)
    ref_dl = TC.ce_dlogits_reference(*args64, plan)[:, :V]
    pa = (torch.exp(h64 @ w64.t() - args64[3][:, None]) * (h64.abs() @ w64.abs().t())
          * g64.abs()[:, None])
    rdh, rdw = TC.fused_ce_bwd_plain(*args64, True)
    mdh, mdw = TC.fused_ce_bwd_plain(*args64, True, abs_terms=True)
    hr, wr = SM.tf32_round(h), SM.tf32_round(w)
    one_dl = TC.ce_dlogits_reference(hr, labels, wr, logz, g, plan)
    dlr = SM.tf32_round(one_dl)

    def rms(x):
        return float(x.square().mean().sqrt())
    for got, one, ref, tol in (
            (dl[:, :V], one_dl[:, :V], ref_dl, unit(H) * (ref_dl.abs() + pa) + 1e-30),
            (dh, TC.ce_dh_from_scratch_reference(dlr, wr, plan), rdh,
             unit(H + V) * (mdh + rdh.abs()) + 1e-6 * rms(rdh)),
            (dw, TC.ce_dw_from_scratch_reference(dlr, hr, V), rdw,
             unit(H + N) * (mdw + rdw.abs()) + 1e-6 * rms(rdw))):
        split, single = _ratio(got, ref, tol), _ratio(one, ref, tol)
        assert split <= SMOKE.SPLIT_VS_TF32 * single, (split, single)


# ---------------------------------------------------------------------------
# the modelled products against JAX at fp32
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,H,V", [(37, 96, 1111), (100, 128, 1111)])
def test_modelled_ce_backward_matches_jax_pallas(N, H, V):
    """dh and dW of the split model against JAX's fused_ce VJP (Pallas in
    interpret mode) at fp32 on the same numpy inputs, at 1e-5; the model
    starts from the port's plain logz."""
    rs = np.random.RandomState(N)
    h = rs.randn(N, H).astype(np.float32)
    w = (0.3 * rs.randn(V, H)).astype(np.float32)
    labels = rs.randint(0, V, N)
    labels[3], labels[7] = -1, V + 10 ** 6
    g = np.linspace(0.2, 1.7, N).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b: jfused_ce(a, jnp.asarray(labels), b, True),
                     jnp.asarray(h), jnp.asarray(w))
    jdh, jdw = (np.asarray(t) for t in vjp(jnp.asarray(g)))
    th, tw, tl = torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(labels)
    logz, _ = TC.fused_ce_fwd_plain(th, tl, tw)
    plan = TC._bwd_plan(N, H, V, 132, torch.float32)
    _, dh, dw = SM.ce_bwd_model(th, tl, tw, logz, torch.from_numpy(g), plan.segments)
    np.testing.assert_allclose(dh.numpy(), jdh, **TOL)
    np.testing.assert_allclose(dw.numpy(), jdw, **TOL)


@pytest.mark.parametrize("N,H,V", [(37, 96, 1111), (100, 128, 1111)])
def test_modelled_ce_forward_matches_jax_pallas(N, H, V):
    """ce of the split forward model against JAX's fused_ce forward (Pallas
    in interpret mode) at fp32 on the same numpy inputs, labels outside
    [0, V) included, at 1e-5."""
    rs = np.random.RandomState(N + 1)
    h = rs.randn(N, H).astype(np.float32)
    w = (0.3 * rs.randn(V, H)).astype(np.float32)
    labels = rs.randint(0, V, N)
    labels[3], labels[7] = -1, V + 10 ** 6
    jce = np.asarray(jfused_ce(jnp.asarray(h), jnp.asarray(labels), jnp.asarray(w), False))
    _, ce = SM.ce_fwd_model(torch.from_numpy(h), torch.from_numpy(labels), torch.from_numpy(w))
    np.testing.assert_allclose(ce.numpy(), jce, **TOL)


@pytest.mark.parametrize("scale", ["fp32", "bf16"])
def test_modelled_int8_dx_matches_jax(scale):
    """The split model of the int8 gradient against the VJP of JAX's
    int8_matmul at fp32 (its Pallas kernel at M 128, interpret mode) on
    the same numpy g, with an fp32 and a bf16 scale, at 1e-5."""
    rng = np.random.RandomState(7)
    jw, js = JQM.quantize_weight(jnp.asarray(0.05 * rng.randn(96, 130), jnp.float32), 1)
    if scale == "bf16":
        js = js.astype(jnp.bfloat16)
    x = rng.randn(128, 96).astype(np.float32)
    g = rng.randn(128, 130).astype(np.float32)
    _, vjp = jax.vjp(jax.jit(lambda x_: JQM.int8_matmul(x_, jw, js)), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(g))
    ts = torch.from_numpy(np.array(js.astype(jnp.float32)))
    ts = ts.bfloat16() if scale == "bf16" else ts
    w_q = torch.from_numpy(np.array(np.asarray(jw).T, order="C"))
    dx = SM.int8_dx_model(torch.from_numpy(g), w_q, ts)
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), **TOL)


@pytest.mark.parametrize("scale", ["fp32", "bf16"])
@pytest.mark.parametrize("M", [8, 128], ids=["xla_M8", "pallas_M128"])
def test_modelled_int8_forward_matches_jax(M, scale):
    """The split model of the int8 forward against JAX's int8_matmul at fp32
    (XLA at M 8, its Pallas kernel at M 128) on the same numpy x, with an
    fp32 and a bf16 scale, at 1e-5."""
    rng = np.random.RandomState(M + 1)
    jw, js = JQM.quantize_weight(jnp.asarray(0.05 * rng.randn(96, 130), jnp.float32), 1)
    if scale == "bf16":
        js = js.astype(jnp.bfloat16)
    x = rng.randn(M, 96).astype(np.float32)
    jy = np.asarray(jax.jit(lambda x_: JQM.int8_matmul(x_, jw, js))(jnp.asarray(x)))
    ts = torch.from_numpy(np.array(js.astype(jnp.float32)))
    ts = ts.bfloat16() if scale == "bf16" else ts
    w_q = torch.from_numpy(np.array(np.asarray(jw).T, order="C"))
    y = SM.int8_forward_model(torch.from_numpy(x), w_q, ts)
    np.testing.assert_allclose(y.numpy(), jy, **TOL)


# ---------------------------------------------------------------------------
# plans and geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M,N,K,want", [
    (4788, 896, 896, (1, 896)), (4788, 128, 896, (3, 320)), (4788, 4864, 896, (1, 896)),
    (4788, 896, 4864, (1, 4864)), (192, 151674, 896, (1, 896)),          # training
    (640, 4864, 896, (2, 448)), (640, 896, 4864, (7, 704)), (640, 896, 896, (3, 320)),
    (16, 4864, 896, (3, 320)), (16, 896, 896, (14, 64)), (16, 896, 4864, (16, 320)),
    (30, 128, 896, (14, 64)), (16, 151674, 896, (1, 896)), (640, 896, 112, (2, 64)),
    (2, 7, 16, (1, 32)),
    # the gradient's (dx [M, K] over N, taken as (M, K, N)): the training
    # path's rows, the head's 14 tiles over 151674 (9 segments, one wave),
    # serving's and ragged ones
    (4788, 896, 896, (1, 896)), (4788, 128, 896, (3, 320)), (4788, 4864, 896, (1, 896)),
    (4788, 896, 4864, (1, 4864)), (192, 151674, 896, (1, 896)),
    (192, 896, 151674, (9, 16864)), (16, 896, 4864, (16, 320)), (640, 4864, 896, (2, 448)),
    (30, 128, 896, (14, 64)), (5, 7, 3, (1, 32))])
def test_split_plan_splits_the_reduction_where_the_tiles_leave_sms_idle(M, N, K, want):
    """`_split_plan` at the paths' shapes, the forward's (M, N, K) and the
    gradient's (M, K, N): one segment where the 128 x 128 tiles give two
    waves of one block an SM; below that at most 16 segments of whole
    32-column steps covering the reduction, none empty, whose critical
    path (waves x (a block's steps + the ring's 3-step fill)) no other
    count beats."""
    S, seg = TQM._split_plan(M, N, K, 132)
    assert (S, seg) == want
    tiles = -(-M // 128) * -(-N // 128)
    assert seg % 32 == 0 and 1 <= S <= 16 and (S - 1) * seg < K <= S * seg
    steps = -(-K // 32)

    def path(s):
        per = -(-steps // s)
        return -(-tiles * -(-steps // per) // 132) * (per + 3)
    if tiles < 264:
        assert all(path(S) <= path(s) for s in range(1, 17))


@pytest.mark.parametrize("ld,ptr,want", [
    (896, 0, 16), (128, 4096, 16), (4864, 256, 16),          # the training rows
    (151674, 0, 8), (4098, 512, 8),                          # the vocabulary: rows 8-byte aligned
    (101, 0, 4), (4097, 64, 4), (896, 8, 8), (896, 4, 4)])   # odd N; a start off 16 bytes
def test_dx_copy_bytes_follow_the_rows_alignment(ld, ptr, want):
    """dx_split_kernel copies g's rows 16 bytes at a time where every row
    starts 16-byte aligned (ld a multiple of 4 floats, g aligned), else 8
    or 4: the widest copy that divides both ld's bytes and g's address."""
    assert TQM._dx_copy_bytes(ld, ptr) == want
    assert (4 * ld) % want == 0 and ptr % want == 0


def _constants(path, names):
    text = path.read_text()
    return {n: int(re.search(rf"\b{n} = (\d+)", text).group(1)) for n in names}


def test_split_geometry_matches_the_sources():
    """The geometry the wrappers check the libraries against (the int8
    forward's `_SPLIT_*`, the CE backward's `_SPLIT_GEOMETRY`) is the split
    tile's in csrc/f32_tc_tile.cuh, and both libraries report it from those
    constants; the CE's fp32 products keep the bf16 grids' tile."""
    tile = _constants(CSRC / "f32_tc_tile.cuh", ("BM", "BN", "BK", "STAGES", "THREADS"))
    assert (tile["BM"], tile["BN"]) == TQM._SPLIT_TILE == TC._DH_TILE
    assert tile["BK"] == TQM._SPLIT_STEP == TC._SPLIT_GEOMETRY[2] == SM.STEP
    assert TC._SPLIT_GEOMETRY == (*TC._DH_TILE, tile["BK"], 1) and TC._VSTEP % tile["BK"] == 0
    assert TQM._SPLIT_RESIDENT == 1 and TQM._SPLIT_STAGES == tile["STAGES"]
    int8 = (CSRC / "int8_matmul.cu").read_text()
    assert _constants(CSRC / "int8_matmul.cu", ("F32_SPLIT_MAX",))["F32_SPLIT_MAX"] == \
        TQM._SPLIT_MAX
    body = re.search(r"simlingo_int8_split_geometry\(int\* out\) \{(.*?)\n\}", int8, re.S).group(1)
    assert re.findall(r"out\[(\d)\] = ([\w:]+);", body) == [
        ("0", "tc::BM"), ("1", "tc::BN"), ("2", "tc::BK"), ("3", "F32_SPLIT_MAX"), ("4", "1"),
        ("5", "tc::STAGES")]
    ce = (CSRC / "fused_ce.cu").read_text()
    body = re.search(r"simlingo_fused_ce_bwd_split_geometry\(int\* out\) \{(.*?)\n\}", ce,
                     re.S).group(1)
    assert re.findall(r"out\[(\d)\] = ([\w:]+);", body) == [
        ("0", "tc::BM"), ("1", "tc::BN"), ("2", "tc::BK"), ("3", "1")]


def test_fp32_ce_plan_keeps_the_bf16_grids_at_one_block_an_sm():
    """The CE's split build runs the bf16 plan's grids at one block an SM:
    at the training shape S = 14 segments, 784 dh blocks, fill the last of
    6 waves of 132 as well as the bf16 build's 3 waves of 264."""
    plan = TC._bwd_plan(960, 896, 151674, 132, torch.float32)
    assert (plan.S, plan.dh_blocks) == (14, 784)
    assert TC._wave_fill(plan.dh_blocks, 132) == TC._wave_fill(plan.dh_blocks, 264) > 0.98
