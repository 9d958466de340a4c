"""The launch plans of the norm kernels (`_norm_fwd_plan`, `_norm_bwd_plan`).

`norm_fwd_kernel` takes `threads` a block, `threads // (32 WPR)` rows at
a time, and its blocks walk the rows grid-stride. `norm_bwd_kernel` is a
persistent grid of 256-thread blocks, at most the co-resident ones,
walking the rows the same way; with sums, each block writes one partial
row, and block b of the column-sum launch adds columns [b d / G, (b + 1)
d / G) over the G partial rows. The plans are plain Python, so they are held
here on the CPU for an H100's 132 SMs, at the path's rows (the serving
rows 1 / 16 / 30 / 640 / 2050, the training rows 4788 / 12300) and
widths, with the sweep's forced plans (`chip_smoke.py --norm-sweep`) and
the source's constants.
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

from simlingo_tpu_torch.kernels import layernorm as TLN

SMS = 132
ROWS = (0, 1, 16, 30, 640, 2050, 4788, 12300)
WIDTHS = (128, 896, 1024, 4096, 8192)
CASES = [(n, d) for n in ROWS for d in WIDTHS]
SUMS = (True, False)
ROOT = Path(TLN.__file__).resolve().parents[2]
SOURCE = ROOT / "simlingo_tpu_torch" / "csrc" / "layernorm.cu"


def _smoke():
    """chip_smoke.py, loaded by path (it imports torch only when run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _walk(n, rows_a_block, blocks):
    """The rows each block handles, as the kernels walk them: groups b,
    b + blocks, ... of `rows_a_block` rows, cut at n."""
    return [[r for base in range(b * rows_a_block, n, blocks * rows_a_block)
             for r in range(base, min(n, base + rows_a_block))]
            for b in range(blocks)]


def _fwd_rows(n, d, plan):
    return _walk(n, plan.threads // (32 * TLN._norm_width(d)[1]), plan.blocks)


def _bwd_rows(n, d, plan):
    return _walk(n, TLN._THREADS // (32 * TLN._norm_width(d)[1]), plan.blocks)


def _check_rows(n, walked):
    rows = [r for block in walked for r in block]
    assert sorted(rows) == list(range(n))                  # every row, once
    assert all(block for block in walked)                  # no idle block


def _check_fwd(n, d, plan, sms=SMS):
    tpr = 32 * TLN._norm_width(d)[1]
    assert tpr <= plan.threads <= TLN._THREADS and plan.threads % tpr == 0
    assert plan.blocks <= TLN._FWD_BLOCKS_PER_SM * sms
    _check_rows(n, _fwd_rows(n, d, plan))


def _check_bwd(n, d, plan, sums, sms=SMS):
    # a persistent grid: at most the co-resident blocks
    assert plan.blocks <= TLN._bwd_resident(d, sums) * sms
    _check_rows(n, _bwd_rows(n, d, plan))
    if n:
        _check_slices(d, plan.blocks)


def _colsum_slices(d, blocks):
    """The columns [lo, hi) whose sums over the partial rows block b of
    norm_colsum_kernel computes (csrc/layernorm.cu column_sums)."""
    return [(b * d // blocks, (b + 1) * d // blocks) for b in range(blocks)]


def _check_slices(d, blocks):
    slices = _colsum_slices(d, blocks)
    assert len(slices) == blocks
    assert slices[0][0] == 0 and slices[-1][1] == d        # they cover [0, d)
    for (_, hi), (lo, _) in zip(slices, slices[1:]):
        assert hi == lo                                    # disjoint, in order
    assert all(lo <= hi for lo, hi in slices)


@pytest.mark.parametrize("n,d", CASES)
def test_the_forward_plan_covers_every_row_once(n, d):
    _check_fwd(n, d, TLN._norm_fwd_plan(n, d, SMS))


@pytest.mark.parametrize("sums", SUMS)
@pytest.mark.parametrize("n,d", CASES)
def test_the_backward_plan_covers_every_row_once_on_resident_blocks(n, d, sums):
    _check_bwd(n, d, TLN._norm_bwd_plan(n, d, SMS, sums=sums), sums)


@pytest.mark.parametrize("blocks", [1, 2, 3, 80, 131, 132, 264, 1000])
@pytest.mark.parametrize("d", WIDTHS)
def test_the_column_sums_cover_the_row_once_in_order(d, blocks):
    _check_slices(d, blocks)


@pytest.mark.parametrize("n,d", CASES)
def test_forced_plans_cover_the_rows_and_columns(n, d):
    """Every plan `chip_smoke.py --norm-sweep` launches, the plans' own
    among them."""
    smoke = _smoke()
    for sums in SUMS:
        fwd, bwd = smoke.norm_forced_plans(n, d, SMS, sums)
        assert TLN._norm_fwd_plan(n, d, SMS) in fwd
        assert TLN._norm_bwd_plan(n, d, SMS, sums=sums) in bwd
        for plan in fwd:
            _check_fwd(n, d, plan)
        for plan in bwd:
            _check_bwd(n, d, plan, sums)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("n,d", CASES)
def test_the_forward_spreads_few_rows_and_loads_their_scale_early(sms, n, d):
    """At most _FWD_FEW_ROWS_PER_SM rows an SM: one row group a block (at
    least _FWD_MIN_THREADS threads) and the scale early; more: 256-thread
    blocks and the scale after each row's sums."""
    plan = TLN._norm_fwd_plan(n, d, sms)
    few = n <= TLN._FWD_FEW_ROWS_PER_SM * sms
    assert plan.early == few
    tpr = 32 * TLN._norm_width(d)[1]
    assert plan.threads == (max(TLN._FWD_MIN_THREADS, tpr) if few else TLN._THREADS)
    _check_fwd(n, d, plan, sms)


# (rows, width) -> the forward's (threads, blocks, early), the backward's
# (blocks,) with sums and dx only, at 132 SMs
EXPECTED = {
    (1, 896): ((64, 1, True), (1,), (1,)),
    (16, 896): ((64, 8, True), (2,), (2,)),
    (30, 896): ((64, 15, True), (4,), (4,)),
    (640, 896): ((64, 320, True), (80,), (80,)),
    (4788, 896): ((256, 599, False), (132,), (264,)),
    (512, 4096): ((128, 512, True), (132,), (256,)),
    (2050, 1024): ((256, 257, False), (132,), (257,)),
    (12300, 1024): ((256, 1538, False), (132,), (264,)),
    (3072, 4096): ((256, 1536, False), (132,), (264,)),
}


@pytest.mark.parametrize("n,d", sorted(EXPECTED))
def test_the_path_rows_plan(n, d):
    fwd, bwd, dx_only = EXPECTED[(n, d)]
    assert tuple(TLN._norm_fwd_plan(n, d, SMS)) == fwd
    assert tuple(TLN._norm_bwd_plan(n, d, SMS, sums=True)) == bwd
    assert tuple(TLN._norm_bwd_plan(n, d, SMS, sums=False)) == dx_only


def _source_constants():
    text = SOURCE.read_text()
    consts = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):     # "A = 1, B = 2"
        for name, value in re.findall(r"(\w+) = (\d+)(?=\s*(?:,|$))", decl):
            consts[name] = int(value)
    body = re.search(r"simlingo_norm_geometry\(int\* out\) \{\s*"
                     r"const int g\[(\d+)\] = \{([^}]*)\}", text)
    names = [n.strip() for n in body.group(2).split(",")]
    assert len(names) == int(body.group(1))
    return consts, names


def test_the_library_reports_the_plans_geometry():
    """_lib refuses a library whose simlingo_norm_geometry differs from
    `_geometry()`: the source's constants, in the order it reports them,
    are the plans' own."""
    consts, names = _source_constants()
    assert tuple(consts[n] for n in names) == TLN._geometry()
    assert consts["THREADS"] == TLN._THREADS and consts["MAX_D"] == TLN.MAX_D


def test_the_width_table_is_the_sources():
    """(VPT, WPR) by row width: csrc/layernorm.cu's dispatch, line by line,
    for bf16 rows (SIMLINGO_NORM_DISPATCH) and fp32 rows
    (SIMLINGO_NORM_DISPATCH_F32)."""
    text = SOURCE.read_text()
    for macro, dtype in (("SIMLINGO_NORM_DISPATCH", torch.bfloat16),
                         ("SIMLINGO_NORM_DISPATCH_F32", torch.float32)):
        body = re.search(rf"#define {macro}\(EXPR\)(.*?)while \(0\)", text, re.S).group(1)
        rows = re.findall(r"if \(nv <= (\d+)\) \{ constexpr int VPT_ = (\d+), WPR_ = (\d+);",
                          body)
        assert len(rows) == 6
        for limit, vpt, wpr in rows:
            for nv in (int(limit), max(1, int(limit) // 2 + 1)):
                assert TLN._norm_width(8 * nv, dtype) == (int(vpt), int(wpr))
        with pytest.raises(ValueError):
            TLN._norm_width(TLN.MAX_D + 8, dtype)


def test_the_backward_occupancy_is_the_sources():
    """_bwd_resident mirrors bwd_min_blocks, the kernel's __launch_bounds__
    (wide with sums at the wide VPT, and with sums on fp32 rows)."""
    body = re.search(r"bwd_min_blocks\(int vpt, bool sums, bool fp32\) \{\s*"
                     r"return \(sums && \(vpt == (\d+) \|\| fp32\)\) \? (\w+) : (\w+);",
                     SOURCE.read_text())
    assert body is not None
    consts, _ = _source_constants()
    wide_vpt, wide, narrow = int(body.group(1)), consts[body.group(2)], consts[body.group(3)]
    for dtype in (torch.bfloat16, torch.float32):
        fp32 = dtype == torch.float32
        for d in WIDTHS:
            vpt = TLN._norm_width(d, dtype)[0]
            for sums in SUMS:
                want = wide if (sums and (vpt == wide_vpt or fp32)) else narrow
                assert TLN._bwd_resident(d, sums, dtype) == want
