"""The grid plan of the w8a16 forward kernel (`_fwd_plan`).

`int8_matmul` launches gemm_kernel (M >= 2) on 16-row tiles up to M = 48
and 64-row tiles above, and splits the reduction (K) into S segments, the
S blocks of an output tile forming one thread-block cluster, when the tiles
alone do not fill the card. The plan is plain Python, so it is held here on
the CPU for an H100's 132 SMs: at every shape of the serving path (verify
16, queries 30, prefill 640), the int8-base training rows (the linears at
6 x 798 rows, the tied head per 32-position CE chunk) and ragged shapes.
"""

import pytest

from simlingo_tpu_torch.kernels import quantized_matmul as TQM

SMS = 132

LINEARS = [(896, 896), (128, 896), (4864, 896), (896, 4864)]   # (N, K): q,o; k,v; gate,up; down
PATH_SHAPES = ([(M, N, K) for (N, K) in LINEARS for M in (16, 30, 640, 4788)]
               + [(M, 151674, 896) for M in (16, 192)])            # (M, N, K): x [M, K] . w_q [N, K]^T
RAGGED = [(2, 896, 4880), (47, 130, 896), (48, 130, 4864), (49, 130, 4864),
          (49, 896, 912), (5, 131, 64), (2, 64, 16), (300, 1000, 272), (64, 128, 1024)]
ALL = PATH_SHAPES + RAGGED


def _tiles(M, N, tile):
    return -(-M // tile[0]) * -(-N // tile[1])


@pytest.mark.parametrize("M,N,K", ALL)
def test_segments_are_whole_steps_that_cover_the_reduction(M, N, K):
    tile, S, seg = TQM._fwd_plan(M, N, K, SMS)
    step = TQM._fwd_geometry(M)[1]
    assert seg > 0 and seg % step == 0                      # whole steps
    bounds = [(s * seg, min((s + 1) * seg, K)) for s in range(S)]
    assert bounds[0][0] == 0 and bounds[-1][1] == K         # they cover [0, K)
    for (_, hi), (lo, _) in zip(bounds, bounds[1:]):
        assert hi == lo                                     # disjoint, in order
    assert all(lo < hi for lo, hi in bounds)                # none empty
    assert 0 < K - (S - 1) * seg <= seg                     # only the last is short


@pytest.mark.parametrize("M,N,K", ALL)
def test_clusters_fit_the_cap_and_the_card(M, N, K):
    tile, S, _ = TQM._fwd_plan(M, N, K, SMS)
    assert 1 <= S <= TQM._FWD_CLUSTER
    fill = TQM._fwd_geometry(M)[2]                 # blocks an SM that a split fills
    assert _tiles(M, N, tile) * S <= max(_tiles(M, N, tile), fill * SMS)


@pytest.mark.parametrize("M,N,K", ALL)
def test_no_split_where_the_tiles_alone_fill_the_card(M, N, K):
    tile, S, _ = TQM._fwd_plan(M, N, K, SMS)
    if _tiles(M, N, tile) >= 2 * SMS:
        assert S == 1


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("M,N,K", [(16, 896, 4864), (30, 4864, 896), (640, 896, 4864),
                                   (640, 128, 896), (4788, 128, 896)])
def test_the_plan_follows_the_card(sms, M, N, K):
    tile, S, seg = TQM._fwd_plan(M, N, K, sms)
    step, fill = TQM._fwd_geometry(M)[1:]
    tiles = _tiles(M, N, tile)
    if tiles >= 2 * sms:
        assert S == 1
        return
    cap = min(TQM._FWD_CLUSTER, fill * sms // tiles)
    assert tiles * S <= max(tiles, fill * sms) and S <= max(cap, 1)
    per = seg // step
    if per > 1:                   # the largest: one step less a segment is too many
        assert -(-(-(-K // step)) // (per - 1)) > cap


@pytest.mark.parametrize("M", [2, 47, 48, 49, 50])
def test_the_tile_switches_at_48_rows(M):
    tile, _, _ = TQM._fwd_plan(M, 896, 896, SMS)
    assert tile == (TQM._FWD_SMALL if M <= 48 else TQM._FWD_LARGE)[0]
    assert tile[0] == (16 if M <= 48 else 64)


# (M, N, K) -> (tile, S) at 132 SMs: the clusters at verify, queries and
# prefill (at most 2 blocks an SM for the 64-row tiles), none at the
# training rows but k,v's, none at the head
EXPECTED = {
    (16, 896, 896): ((16, 64), 7), (30, 896, 896): ((16, 64), 7),
    (640, 896, 896): ((64, 128), 3), (4788, 896, 896): ((64, 128), 1),
    (16, 128, 896): ((16, 64), 7), (640, 128, 896): ((64, 128), 7),
    (4788, 128, 896): ((64, 128), 3),
    (16, 4864, 896): ((16, 64), 7), (30, 4864, 896): ((16, 64), 5),
    (640, 4864, 896): ((64, 128), 1), (4788, 4864, 896): ((64, 128), 1),
    (16, 896, 4864): ((16, 64), 8), (30, 896, 4864): ((16, 64), 8),
    (640, 896, 4864): ((64, 128), 3), (4788, 896, 4864): ((64, 128), 1),
    (16, 151674, 896): ((16, 64), 1), (192, 151674, 896): ((64, 128), 1),
}


@pytest.mark.parametrize("M,N,K", sorted(EXPECTED))
def test_the_path_shapes_plan(M, N, K):
    tile, S, _ = TQM._fwd_plan(M, N, K, SMS)
    assert (tile, S) == EXPECTED[(M, N, K)]
