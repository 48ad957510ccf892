"""The work counts of benchmark/work at the cells' shapes against values
worked out by hand."""

import pytest

from benchmark.work import b1, b2, step


def test_b1_at_262144_points_6x80_five_streams():
    # 2 N S (3*80 + 5*80*80 + 80) = 2 * 262144 * 5 * 32320
    n_bytes, n_ops = b1.work(262_144, 6, 80, 3, 2, 5)
    assert n_ops == 84_724_940_800
    assert n_ops == pytest.approx(8.47e10, rel=1e-3)
    n_par = 3 * 80 + 80 + 5 * (6400 + 80) + 80 + 1
    assert n_bytes == 4 * (262_144 * 7 + n_par)


@pytest.mark.parametrize("n, depth, width, d, s, ops", [
    # the flagship's batch: 2 N S (2*3*80 + 3*5*6400 + 2*80)
    (46_000, 6, 80, 2, 5, 2 * 46_000 * 5 * (480 + 96_000 + 160)),
    # poisson_3d's cell batch: 2 N S (2*3*64 + 3*4*4096 + 2*64)
    (230_400, 5, 64, 3, 7, 2 * 230_400 * 7 * (384 + 49_152 + 128)),
])
def test_b2_counts(n, depth, width, d, s, ops):
    assert b2.work(n, depth, width, 3, d, s)[1] == ops


def test_b2_at_46000_matches_the_kernel_table():
    # PERF.md's kernel table gives it to three digits: 4.45e10
    assert round(b2.work(46_000, 6, 80, 3, 2, 5)[1], -8) == 4.45e10


def test_step_is_b1_plus_b2():
    args = (184_000, 6, 80, 3, 2, 5)
    assert step.operations(*args) == b1.work(*args)[1] + b2.work(*args)[1]
