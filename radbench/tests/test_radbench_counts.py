"""The frozen counting arithmetic against hand counts."""
import pytest

from radbench import counts


def test_mlp_flops_by_hand():
    # 3 -> 4 -> 2: 12 + 8 multiply-adds a row
    assert counts.mlp_flops([3, 4, 2], 5) == 2 * 5 * 20


def test_lw_work_by_hand():
    dims = [3, 4, 4]  # a "both" net of 2 g-points
    flops, nbytes = counts.lw_work(ncol=2, nlay=3, dims=dims, nband=1)
    cells = 6
    assert flops == 2 * cells * (12 + 16) + 40 * cells * 2
    params = (12 + 4) + (16 + 4) + 2 * 4
    floats = cells * 5 + 2 * 4 + 2 * 3 + params + 196 + 2 * 2 * 4
    assert nbytes == 4 * floats
    f2, b2 = counts.lw_work(2, 3, dims, 1, clouds=(2, 1, 3))
    assert f2 - flops == 1 * 2 * 3 + (14 * 3 + 3 * 3) * 1
    assert b2 - nbytes == 4 * 4 * cells


def test_sw_work_by_hand():
    flops, _ = counts.sw_work(ncol=1, nlay=2, dims_abs=[2, 3, 5], dims_ray=[2, 3, 5], nband=2,
                              clouds=(1, 0, 1))
    assert flops == 2 * (2 * 2 * 21) + 110 * 2 * 5 + 16 * 5 * 1 + (18 * 1 + 9 * 1) * 2


def test_least_seconds_takes_the_slower_bound():
    assert counts.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert counts.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert counts.least_seconds(67e12, 2 * 3.35e12) == pytest.approx(2.0)
