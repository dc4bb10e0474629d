"""The fused GMRES kernel's reduction tree and launch geometry, on the CPU.

``tree_sum_cluster`` sums as the kernel does on a thread block cluster (each
value owned by one thread of one block, the tree over the thread's leaves,
the warp, the block's warps, the blocks); it must equal ``tree_sum``, the
twin's halving tree, bit for bit, signs of zeros included.
``launch_geometry`` mirrors the launcher's choice of blocks and leaves."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from perphil_tpu_torch.ops.fused_gmres import (
    EF64_MAX_DOF, MAX_BLOCKS, MAX_LEAVES, LaunchGeometry, launch_geometry,
)
from perphil_tpu_torch.ops.krylov import tree_sum, tree_sum_cluster

# 2D N=4, 8, 16, 64, tet nx=16, and a length just over a power of two
LENGTHS = [34, 162, 578, 8450, 9826, 4097]
BLOCKS = [1, 2, 8, 16]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return np.array_equal(a.numpy().view(np.int64), b.numpy().view(np.int64))


def _vector(kind: str, size: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if kind == "normal":
        v = rng.standard_normal(size)
    elif kind == "wide":  # mixed signs over sixteen decades: every add rounds
        v = rng.standard_normal(size) * 10.0 ** rng.integers(-8, 8, size)
    elif kind == "sparse":  # mostly zeros of both signs
        v = np.where(rng.random(size) < 0.8, 0.0, rng.standard_normal(size))
        v = np.where(rng.random(size) < 0.5, -v, v)
    elif kind == "negzero":
        v = np.full(size, -0.0)
    else:
        v = np.zeros(size)
    return torch.tensor(v, dtype=torch.float64)


@pytest.mark.parametrize("kind", ["normal", "wide", "sparse", "negzero", "zero"])
@pytest.mark.parametrize("blocks", BLOCKS)
@pytest.mark.parametrize("size", LENGTHS)
def test_cluster_tree_equals_tree_sum(size, blocks, kind):
    """The blocks asked for, cut to what the launcher would take for this
    length (one block up to 512 values)."""
    p = _vector(kind, size, seed=size + blocks)
    taken = min(blocks, launch_geometry(size).blocks)
    assert _same_bits(tree_sum_cluster(p, taken), tree_sum(p))


def test_padding_adds_are_kept():
    """A sum of -0.0 leaves is -0.0 only where no padding leaf joins it:
    dropping the padding's additions would flip the sign here."""
    full = torch.full((512,), -0.0, dtype=torch.float64)
    assert np.signbit(tree_sum(full).item()) and np.signbit(tree_sum_cluster(full, 1).item())
    short = torch.full((300,), -0.0, dtype=torch.float64)
    assert not np.signbit(tree_sum(short).item())
    assert not np.signbit(tree_sum_cluster(short, 1).item())
    long = torch.full((8450,), -0.0, dtype=torch.float64)
    assert _same_bits(tree_sum_cluster(long, 16), tree_sum(long))


@settings(max_examples=60, deadline=None)
@given(
    size=st.integers(min_value=1, max_value=16384),
    log_blocks=st.integers(min_value=0, max_value=4),
    seed=st.integers(min_value=0, max_value=2**31),
    scale=st.sampled_from([0.0, 1.0, 1e-300, 1e300]),
)
def test_cluster_tree_equals_tree_sum_property(size, log_blocks, seed, scale):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(size) * scale
    v[rng.random(size) < 0.1] = -0.0
    p = torch.tensor(v, dtype=torch.float64)
    taken = min(1 << log_blocks, launch_geometry(size).blocks)
    got, ref = tree_sum_cluster(p, taken), tree_sum(p)
    if size < 512 and size & (size - 1) == 0:
        # the one difference: tree_sum pads a power of two no further, the
        # kernel pads it to its 512 threads, so a total of -0.0 turns +0.0
        assert got.item() == ref.item()
    else:
        assert _same_bits(got, ref)


def test_cluster_tree_rejects_bad_geometry():
    p = torch.zeros(600, dtype=torch.float64)
    with pytest.raises(ValueError):
        tree_sum_cluster(p, 4)  # 2048 threads for 1024 leaves
    with pytest.raises(ValueError):
        tree_sum_cluster(p, 3)
    with pytest.raises(ValueError):
        tree_sum_cluster(p.reshape(2, 300), 1)


GEOMETRIES = [
    # values, (blocks, leaves)
    (1, (1, 1)),
    (2 * 9 * 9, (1, 1)),  # 2D N=8, K5
    (EF64_MAX_DOF, (1, 1)),  # K5's largest system: one block
    (EF64_MAX_DOF + 1, (2, 1)),
    (2 * 17 * 17, (2, 1)),  # 2D N=16
    (2 * 33 * 33, (8, 1)),  # 2D N=32
    (2 * 65 * 65, (16, 2)),  # 2D N=64
    (2 * 17 ** 3, (16, 2)),  # tet nx=16
    (2 * 126 * 126, (16, 4)),  # 2D 125 cells: the TPU gate's last 2D mesh
    (2 * 127 * 127, (16, 4)),  # 2D 126 cells: beyond that gate, the same geometry rule
    (2 * 30 ** 3, (16, 8)),  # tet nx=29, the TPU gate's largest 3D system of pc none
    (2 * 129 * 129, (16, 8)),  # 2D N=128
    (2 * 33 ** 3, (16, 16)),  # tet nx=32
    (2 * 257 * 257, (16, MAX_LEAVES)),  # 2D N=256
    (2 * 41 ** 3, (16, MAX_LEAVES)),  # tet nx=40
    (16 * 512 * MAX_LEAVES, (16, MAX_LEAVES)),
]


@pytest.mark.parametrize("values,expected", GEOMETRIES, ids=[str(g[0]) for g in GEOMETRIES])
def test_launch_geometry(values, expected):
    geo = launch_geometry(values)
    assert geo == LaunchGeometry(*expected)
    assert geo.blocks <= MAX_BLOCKS and 512 * geo.blocks * geo.leaves >= values


@pytest.mark.parametrize(
    "values,blocks", [(512, 1), (513, 2), (1024, 2), (1025, 4), (2048, 4), (2049, 8), (4096, 8), (4097, 16)]
)
def test_launch_geometry_block_thresholds(values, blocks):
    """The block count doubles with the padded length up to 16: one leaf a
    thread until then."""
    assert launch_geometry(values) == (blocks, 1)


def test_launch_geometry_limits():
    with pytest.raises(ValueError):
        launch_geometry(16 * 512 * MAX_LEAVES + 1)
    with pytest.raises(ValueError):
        launch_geometry(0)
