"""The grid plan of the int8 activation-gradient kernel (`_dx_plan`).

`int8_matmul_dx` launches dx_kernel on 64 x 128 output tiles and splits the
reduction (N, the weight's rows) into S segments when the tiles alone do
not fill the card. The plan is plain Python, so it is held here on the CPU
for an H100's 132 SMs: at the five shapes of the int8-base training path
(the linears at 6 x 798 rows, the tied head per 32-position CE chunk) and
at ragged ones.
"""

import pytest

from simlingo_tpu_torch.kernels import quantized_matmul as TQM

SMS = 132

PATH_SHAPES = [                  # (M, N, K): g [M, N] through w_q [N, K]
    (4788, 896, 896),            # q, o
    (4788, 128, 896),            # k, v
    (4788, 4864, 896),           # gate, up
    (4788, 896, 4864),           # down
    (192, 151674, 896),          # the tied head
]
RAGGED = [(5, 130, 16), (16, 20000, 64), (77, 20010, 128), (40, 151674, 896),
          (1, 2, 16), (300, 1000, 256), (64, 33, 128)]


def _tiles(M, K, tile):
    return -(-M // tile[0]) * -(-K // tile[1])


@pytest.mark.parametrize("M,N,K", PATH_SHAPES + RAGGED)
def test_segments_are_whole_steps_that_cover_the_reduction(M, N, K):
    tile, S, seg = TQM._dx_plan(M, N, K, SMS)
    assert tile == TQM._DX_TILE and S >= 1
    assert seg > 0 and seg % TQM._DX_STEP == 0             # whole steps
    bounds = [(s * seg, min((s + 1) * seg, N)) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == N        # they cover [0, N)
    for (_, hi), (lo, _) in zip(bounds, bounds[1:]):
        assert hi == lo                                    # disjoint, in order
    assert all(lo < hi for lo, hi in bounds)               # none empty
    assert 0 < N - (S - 1) * seg <= seg                    # only the last is short
    assert S <= -(-N // TQM._DX_STEP)
    blocks = _tiles(M, K, tile) * S
    assert blocks <= max(_tiles(M, K, tile), TQM._DX_RESIDENT * SMS)   # one wave


@pytest.mark.parametrize("M,N,K", PATH_SHAPES + RAGGED)
def test_no_split_where_the_tiles_alone_fill_the_card(M, N, K):
    tile, S, _ = TQM._dx_plan(M, N, K, SMS)
    if _tiles(M, K, tile) >= 2 * SMS:
        assert S == 1


@pytest.mark.parametrize("M,N,K", PATH_SHAPES[:4])
def test_the_linears_are_not_split(M, N, K):
    tile, S, seg = TQM._dx_plan(M, N, K, SMS)
    assert S == 1 and seg >= N and _tiles(M, K, tile) >= 2 * SMS


def test_the_head_fills_the_card():
    M, N, K = PATH_SHAPES[4]
    tile, S, seg = TQM._dx_plan(M, N, K, SMS)
    assert _tiles(M, K, tile) * S >= 2 * SMS
    assert (tile, S, _tiles(M, K, tile) * S) == ((64, 128), 18, 378)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
def test_the_plan_follows_the_card(sms):
    M, N, K = PATH_SHAPES[4]
    tile, S, _ = TQM._dx_plan(M, N, K, sms)
    tiles = _tiles(M, K, tile)
    assert tiles * S <= max(tiles, TQM._DX_RESIDENT * sms)
    assert tiles * (S + 1) > TQM._DX_RESIDENT * sms          # the largest that fits
