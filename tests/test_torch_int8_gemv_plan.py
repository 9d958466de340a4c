"""The grid plan of the w8a16 GEMV (`_gemv_plan`, M = 1).

`int8_matmul` at M = 1 launches gemv_kernel: a warp owns `rows` weight
rows and one of the `warps` slices of K (whole 16-column chunks), the
warps of a block sum their slices in shared memory, and the blocks walk
the row groups grid-stride. The plan is plain Python, so it is held here
on the CPU for an H100's 132 SMs: at the five decode shapes of the serving
path (q,o; k,v; gate,up; down; the tied head), ragged ones, and K past
512 x 16 columns, where the lanes loop over their chunks (K = 8208: slices
of 32 and 33 chunks).
"""

import importlib.util
import re
from pathlib import Path

import pytest

from simlingo_tpu_torch.kernels import quantized_matmul as TQM

SMS = 132
PATH = [(896, 896), (128, 896), (4864, 896), (896, 4864), (151674, 896)]   # (N, K)
RAGGED = [(N, K) for N in (1, 7, 129, 151674) for K in (16, 48, 4880)]
LONG = [(3, 8208), (100, 16384), (3, 81920)]
ALL = PATH + RAGGED + LONG
ROOT = Path(TQM.__file__).resolve().parents[2]
SOURCE = ROOT / "simlingo_tpu_torch" / "csrc" / "int8_matmul.cu"


def _smoke():
    """chip_smoke.py, loaded by path (it imports torch only when run)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _segments(K, plan):
    """The K columns [lo, hi) of slice p = 0..P-1 in order (warp p), as
    gemv_kernel cuts them: slice p is chunks [p C / P, (p + 1) C / P) of
    the C = K / 16, P = warps."""
    C, P = K // TQM._GEMV_CHUNK, plan.warps
    return [(p * C // P * TQM._GEMV_CHUNK, (p + 1) * C // P * TQM._GEMV_CHUNK)
            for p in range(P)]


def _rows(N, plan):
    """The rows each block computes, as gemv_kernel walks them: row groups
    b, b + blocks, ... of `rows` rows, cut at N."""
    groups = -(-N // plan.rows)
    return [[n for g in range(b, groups, plan.blocks)
             for n in range(g * plan.rows, min(N, (g + 1) * plan.rows))]
            for b in range(plan.blocks)]


def _check_covers(N, K, plan):
    rows = [n for block in _rows(N, plan) for n in block]
    assert sorted(rows) == list(range(N))                   # every row, once
    assert all(block for block in _rows(N, plan))  # no idle block
    segs = _segments(K, plan)
    assert len(segs) == plan.warps
    assert segs[0][0] == 0 and segs[-1][1] == K             # they cover [0, K)
    for (_, hi), (lo, _) in zip(segs, segs[1:]):
        assert hi == lo                                     # disjoint, in order
    for lo, hi in segs:
        assert lo < hi                                      # none empty
        assert lo % TQM._GEMV_CHUNK == 0 and hi % TQM._GEMV_CHUNK == 0   # whole chunks


@pytest.mark.parametrize("N,K", ALL)
def test_every_row_once_and_the_slices_cover_the_reduction(N, K):
    _check_covers(N, K, TQM._gemv_plan(N, K, SMS))


@pytest.mark.parametrize("N,K", ALL)
def test_forced_plans_cover_rows_and_reduction(N, K):
    """Every plan `chip_smoke.py --int8-sweep` launches, the plan's own
    among them."""
    plans = _smoke().gemv_forced_plans(N, K, SMS)
    assert TQM._gemv_plan(N, K, SMS) in plans
    for plan in plans:
        _check_covers(N, K, plan)


@pytest.mark.parametrize("N,K", ALL)
def test_the_grid_fits_the_kernel_and_one_wave(N, K):
    plan = TQM._gemv_plan(N, K, SMS)
    assert plan.rows in TQM._GEMV_ROWS
    assert 1 <= plan.warps <= TQM._GEMV_WARPS
    groups = -(-N // plan.rows)
    assert 1 <= plan.blocks <= groups
    # at most one resident wave of _GEMV_SM_WARPS warps an SM
    assert plan.blocks * plan.warps <= TQM._GEMV_SM_WARPS * SMS


@pytest.mark.parametrize("N,K", ALL)
def test_each_lane_takes_one_chunk_a_row(N, K):
    """As few slices as give each lane one 16-byte load a row; where a
    block's warps cannot, all of them, and the lanes loop (gemv_kernel
    takes its branch from C and the warps alone: C <= 32 warps)."""
    plan = TQM._gemv_plan(N, K, SMS)
    C = K // TQM._GEMV_CHUNK
    longest = max(hi - lo for lo, hi in _segments(K, plan))
    need = -(-C // 32)
    assert plan.warps == min(need, TQM._GEMV_WARPS)
    one_chunk = C <= 32 * plan.warps
    assert one_chunk == (longest <= 32 * TQM._GEMV_CHUNK)    # the branch, one for the block
    assert one_chunk == (need <= TQM._GEMV_WARPS)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("N,K", PATH)
def test_the_rows_follow_the_card(sms, N, K):
    plan = TQM._gemv_plan(N, K, sms)
    warps = lambda r: -(-N // r) * plan.warps               # noqa: E731
    if plan.rows != TQM._GEMV_ROWS[0]:
        assert warps(plan.rows) >= TQM._GEMV_SM_WARPS * sms
    bigger = [r for r in TQM._GEMV_ROWS if r > plan.rows]
    assert all(warps(r) < TQM._GEMV_SM_WARPS * sms for r in bigger)


# (N, K) -> (rows, warps, blocks) at 132 SMs
EXPECTED = {
    (896, 896): (2, 2, 448), (128, 896): (2, 2, 64),
    (4864, 896): (2, 2, 1216), (896, 4864): (2, 10, 224),
    (151674, 896): (8, 2, 2107),
}


@pytest.mark.parametrize("N,K", sorted(EXPECTED))
def test_the_path_shapes_plan(N, K):
    assert tuple(TQM._gemv_plan(N, K, SMS)) == EXPECTED[(N, K)]


def _source_constants():
    text = SOURCE.read_text()
    consts = {}
    for decl in re.findall(r"constexpr int ([^;]+);", text):     # "A = 1, B = 2"
        for name, value in re.findall(r"(\w+) = (\d+)(?=\s*(?:,|$))", decl):
            consts[name] = int(value)
    body = re.search(r"simlingo_int8_matmul_geometry\(int\* out\) \{\s*"
                     r"const int g\[(\d+)\] = \{([^}]*)\}", text)
    names = [n.strip() for n in body.group(2).split(",")]
    assert len(names) == int(body.group(1))
    return consts, names


def test_the_library_reports_the_plans_geometry():
    """_lib refuses a library whose simlingo_int8_matmul_geometry differs
    from `_fwd_lib_geometry()`: the source's constants, in the order it
    reports them, are the plans' own."""
    consts, names = _source_constants()
    assert tuple(consts[n] for n in names) == TQM._fwd_lib_geometry()
    assert TQM._fwd_lib_geometry()[-3:] == (TQM._GEMV_WARPS, max(TQM._GEMV_ROWS),
                                            TQM._GEMV_CHUNK)


def test_the_kernel_is_instantiated_for_every_row_count():
    text = SOURCE.read_text()
    cases = [int(a) for a, b in re.findall(r"case (\d+): gemv_kernel<(\d+), ST>", text)
             if a == b]
    assert tuple(cases) == TQM._GEMV_ROWS
    assert max(TQM._GEMV_ROWS) == _source_constants()[0]["GEMV_MAX_ROWS"]
