"""K8's field ILU(0) sweep pair as a line pipeline (``csrc/field_sweep.cuh``),
replayed on the CPU (``ops/ilu.py::line_sweep_replay``): each warp's lanes
and slots step by step, the values passed lane to lane and through the
warps' edge lines, the entries read from ``StructuredILU0.line_tables`` by
the kernel's indexing and every edge rule of the kernel's.

The replay asserts that every row is computed once and that every value a
row reads was computed before it and is the column the plain sweep
(``StructuredILU0.plain``, the twin the kernel is held to on the card) reads
at that level, or the rule's zero; here its result equals the plain sweep's
bit for bit on square and oblong fields, one warp and several, one line a
lane and several, with signed zeros in the right-hand side. The kernel
itself runs only on the card (``tests/test_torch_kernels.py``, marker
``cuda``)."""

import numpy as np
import pytest
import torch

from perphil_tpu_torch.mesh import create_mesh
from perphil_tpu_torch.ops.ilu import LINE_SLOTS, StructuredILU0, build_field_system, line_plan, line_sweep_replay

CASES = [  # cells (x, y), lines a lane: warps = ceil((y + 1) / (32 slots))
    ((4, 4), 1),     # the narrowest field the pipeline takes (5 nodes a line)
    ((16, 16), 1),   # one warp
    ((40, 40), 1),   # two warps, 41 lines: not a multiple of 32
    ((64, 64), 1),   # three warps
    ((40, 40), 2),   # one warp, two lines a lane (lane 31 hands on to lane 0)
    ((70, 70), 3),   # one warp, three lines a lane
    ((70, 70), 2),   # two warps of two lines a lane
    ((9, 40), 1),    # oblong: short lines
    ((40, 6), 1),    # oblong: few lines
]


def _ilu(cells, k=1.3):
    return StructuredILU0(build_field_system(create_mesh(*cells), k, 0.7, 1.1), "cpu")


@pytest.mark.parametrize("cells,slots", CASES, ids=[f"{c[0]}x{c[1]}-{s}" for c, s in CASES])
def test_replay_is_the_plain_sweep(cells, slots):
    ilu = _ilu(cells)
    rng = np.random.default_rng(sum(cells) + slots)
    r = rng.standard_normal(ilu.nrows)
    r[::5] = -0.0
    r[1::7] = 0.0
    got = line_sweep_replay(ilu, r, slots)
    want = ilu.plain(torch.tensor(r)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_zero_right_hand_side_keeps_the_twins_signs():
    """All-zero rows: every difference is of zeros, so the signs of the
    products (which the rules' zeros and the neighbours' values decide)
    carry through; a negative-zero right-hand side on a line's ends."""
    ilu = _ilu((20, 12), k=2.0)
    r = np.zeros(ilu.nrows)
    r.reshape(13, 21)[:, 0] = -0.0
    r.reshape(13, 21)[:, -1] = -0.0
    r.reshape(13, 21)[6, 10] = -3.0
    got = line_sweep_replay(ilu, r)
    want = ilu.plain(torch.tensor(r)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_line_div_is_the_ieee_quotient():
    """The pipeline's divide (reciprocal, then two FMAs; ``line_div``)
    equals ``acc / d`` bit for bit: random quotients over wide exponent
    ranges, divisors with all-ones and power-of-two significands, signed
    zeros, and every diagonal of a field's factor."""
    from perphil_tpu_torch.ops.ilu import line_div

    rng = np.random.default_rng(7)
    diag = _ilu((24, 20)).factors.numpy()[_ilu((24, 20)).center]
    divisors = np.concatenate([
        np.abs(rng.standard_normal(300)) * 2.0 ** rng.integers(-40, 40, 300),
        np.nextafter(2.0, 0.0) * 2.0 ** rng.integers(-8, 8, 50),
        2.0 ** rng.integers(-8, 8, 50),
        1.0 + 2.0**-52 * rng.integers(1, 1000, 50),
        -np.abs(rng.standard_normal(50)),
        diag,
    ])
    for d in divisors:
        accs = rng.standard_normal(6) * 2.0 ** rng.integers(-60, 60, 6)
        for acc in list(accs) + [0.0, -0.0]:
            want = np.float64(acc) / np.float64(d)
            got = line_div(np.float64(acc), np.float64(d), np.float64(1.0) / np.float64(d))
            assert np.float64(got).view(np.int64) == want.view(np.int64), (acc, d)


def test_line_tables_are_the_factor():
    """The tables by row hold ``factors``' own entries: each row's lower
    offsets in stored order, its upper offsets, the diagonal and its
    reciprocal."""
    ilu = _ilu((8, 6))
    lower, upper = (t.numpy().reshape(ilu.nrows, -1) for t in ilu.line_tables())
    fac = ilu.factors.numpy()
    assert np.array_equal(lower, fac[list(ilu.lower)].T)
    assert np.array_equal(upper[:, :4], fac[list(ilu.upper)].T)
    assert np.array_equal(upper[:, 4], fac[ilu.center])
    assert np.array_equal(upper[:, 5], 1.0 / fac[ilu.center])  # the reciprocal the kernel's divide takes
    assert line_plan(ilu.node_shape) is not None and LINE_SLOTS == 1
