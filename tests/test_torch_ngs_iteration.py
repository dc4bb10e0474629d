"""The blocked Picard iteration with no host round trip
(``ops/fused_ngs.py::NgsSweep``, ``blocked_ngs``; the kernels
``csrc/ngs_colour_halo.cu``) on the CPU: the batched loop (``every``
iterations between read-backs, the stop test in the state) against the
first blocked loop (``blocked_ngs_loop``: a norm read back every iteration)
in count, norms and bits; the plain norm against ``blocked_norm`` and the
norm kernel's tree order against ``krylov.tree_sum``, and its layout
(the squares in natural order, the tree's leaves, the CTA's one-barrier
tree with shuffles, the per-block one-warp tail, the blocks in order)
replayed step by step against it; the blocked solve
against the single-device twin and the JAX package; each colour's rows
split once into the straight and the general path; the kernels' reads and
writes through the blocks' table, replayed in numpy, against the twin; the
world-of-one route; and two rank worlds started at once (their rendezvous
ports held from choice to use). The kernels themselves are held to these
twins on the card in ``tests/test_torch_kernels.py``."""

import math
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import perphil_tpu.mesh.structured as jmesh
import perphil_tpu.solvers.parameters as jsp
from perphil_tpu.forms import create_function_spaces as jspaces_of, mixed_space as jmixed
from perphil_tpu.models.dpp import DPPParameters as JParams
from perphil_tpu.ops.assembly import DirichletBC as JBC
from perphil_tpu.solvers import solve_dpp_nonlinear as jsolve_nonlinear
from perphil_tpu.utils import manufactured_solutions as jms

import perphil_tpu_torch.solvers.parameters as sp
from perphil_tpu_torch.interop import from_numpy_state
from perphil_tpu_torch.ops.assembly import DPPOperator, bc_values_per_field
from perphil_tpu_torch.ops.fused_ngs import (
    DONE,
    F0,
    FN,
    ITS,
    MAX_IT,
    NORM_THREADS,
    PART_WORDS,
    RTOL,
    ATOL,
    TOL,
    FusedNGSSolver,
    NgsBlock,
    NgsSweep,
    blocked_ngs,
    blocked_ngs_loop,
    blocked_norm,
    norm_geometry,
    norm_replay,
    tree_sum_norm,
)
from perphil_tpu_torch.ops import fused_ngs
from perphil_tpu_torch.ops.ilu import ColoredNGSSweeper
from perphil_tpu_torch.ops.krylov import tree_sum
from perphil_tpu_torch.parallel.transpose import LoopbackBlocks
from perphil_tpu_torch.solvers.solver import _freeze, ngs_on_one_rank_whole
from perphil_tpu_torch.tools.dryrun import spawn_world

MESHES = [(2,), (4,), (2, 2)]
EVERY = [1, 3, 16]


def _manufactured(n):
    mesh = jmesh.StructuredMesh(cells=(n, n), element="quad")
    _, p1, _, p2 = jms.exact_expressions(mesh, JParams())
    coords = [jnp.asarray(c) for c in mesh.coordinates()]
    return np.asarray(p1(*coords)), np.asarray(p2(*coords))


_PROBLEMS = {}


def _problem(n):
    """The Picard problem at 2D N=n on the manufactured boundary data (the
    JAX package's values): the port's space, sweeper, b and x0."""
    if n not in _PROBLEMS:
        g1, g2 = _manufactured(n)
        state = from_numpy_state({}, (n, n), "quad", g1, g2, device="cpu")
        op = DPPOperator(state.W, state.params)
        sw = ColoredNGSSweeper(state.W.mesh, state.params, "cpu")
        g = torch.stack(bc_values_per_field(state.W, state.bcs))
        b = torch.stack(op.lifted_rhs(g[0], g[1]))
        x0 = torch.where(op._mask_arrays[0], g, 0.0)
        _PROBLEMS[n] = (state, op, sw, b, x0, (g1, g2))
    return _PROBLEMS[n]


def _both_loops(n, ms, every, rtol, atol, max_it, remote=False):
    _, _, sw, b, x0, _ = _problem(n)
    L = LoopbackBlocks(ms)
    parts = {c: NgsBlock(sw, sw.mesh.node_shape, ms, c) for c in L.coords}
    first = blocked_ngs_loop(L, parts, L.cut(b, lead=1), L.cut(x0, lead=1), rtol, atol, max_it)
    sweep = NgsSweep(sw, sw.mesh.node_shape, L, remote=remote)
    got = blocked_ngs(sweep, L.cut(b, lead=1), L.cut(x0, lead=1), rtol, atol, max_it, every=every)
    return L, first, got, sweep


def _same(L, first, got):
    assert got.iterations == first.iterations
    assert got.residual_norm == first.residual_norm and got.initial_norm == first.initial_norm
    assert torch.equal(L.join(got.x), L.join(first.x))


@pytest.mark.parametrize("every", EVERY)
@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_batched_loop_equals_first_loop(ms, every):
    """``every`` iterations between read-backs, the stop test in the state:
    the first blocked loop's count (49 at 2D N=7), norms and iterate bit
    for bit, with the neighbours read in place and through the exchange
    buffers (``remote``)."""
    for remote in (False, True):
        L, first, got, _ = _both_loops(7, ms, every, 1e-8, 1e-12, 50000, remote)
        assert first.iterations == 49
        _same(L, first, got)


@pytest.mark.parametrize("ms", [(2,), (2, 2)], ids=str)
@pytest.mark.parametrize("case", ["converged-at-a-multiple", "max_it", "f0-within-tol"])
def test_batched_stop(case, ms):
    """The stop where it falls: convergence at a multiple of ``every`` (2D
    N=4: 16 iterations, read back every 8 and 16), the cap ``max_it`` (10,
    read back every 3 and 16: the iterations queued past it change
    nothing), and a first norm within the tolerance (no iteration, x0
    returned bit for bit)."""
    if case == "converged-at-a-multiple":
        runs = [(4, every, 1e-8, 1e-50, 50) for every in (8, 16)]
    elif case == "max_it":
        runs = [(7, every, 1e-8, 1e-12, 10) for every in (3, 16)]
    else:
        runs = [(7, every, 1e-8, 1e300, 50) for every in (1, 16)]
    for n, every, rtol, atol, max_it in runs:
        L, first, got, sweep = _both_loops(n, ms, every, rtol, atol, max_it)
        _same(L, first, got)
        state = sweep.state
        assert state[DONE] == 1.0 and state[ITS] == got.iterations and state[MAX_IT] == max_it
        assert state[RTOL] == rtol and state[ATOL] == atol
        if case == "converged-at-a-multiple":
            assert got.iterations == 16 and got.iterations % every == 0 and got.residual_norm <= state[TOL]
        elif case == "max_it":
            assert got.iterations == max_it and got.residual_norm > state[TOL]
        else:
            assert got.iterations == 0 and got.residual_norm == got.initial_norm == state[F0]
            assert torch.equal(L.join(got.x), _problem(n)[4])


@pytest.mark.parametrize("ms", MESHES, ids=str)
def test_plain_norm_equals_blocked_norm(ms):
    """The sweep's norm (each block's tree, the blocks in coordinate order,
    the correctly rounded root) equals ``blocked_norm`` of the residuals
    bit for bit, and its residuals equal the twin's on the received
    planes; the norm kernel's tree order (``tree_sum_norm``) is
    ``tree_sum``'s."""
    _, _, sw, _, _, _ = _problem(15)
    rng = np.random.default_rng(len(ms))
    x, b = (torch.as_tensor(rng.standard_normal((2,) + sw.mesh.node_shape)) for _ in range(2))
    L = LoopbackBlocks(ms)
    sweep = NgsSweep(sw, sw.mesh.node_shape, L)
    sweep.reset(0.0, 0.0, 1)
    xs, bs = L.cut(x, lead=1), L.cut(b, lead=1)
    sweep.load(bs, xs)
    r = {c: torch.empty_like(v) for c, v in xs.items()}
    sweep.norm(init=True, residuals=r)
    planes = L.planes(xs)
    want = {c: sweep.parts[c].residual(xs[c], bs[c], planes[c]) for c in L.coords}
    assert all(torch.equal(r[c], want[c]) for c in L.coords)
    assert float(sweep.state[FN]) == blocked_norm(L)(want) == float(sweep.state[F0])
    for n in (1, 7, 256, 300, 1024, 4097, 33282, 70000):
        v = torch.as_tensor(rng.standard_normal(n)) ** 2
        ctas, leaves = norm_geometry(n)
        assert ctas * leaves * NORM_THREADS >= n and leaves & (leaves - 1) == 0
        assert torch.equal(tree_sum_norm(v, ctas, leaves), tree_sum(v))


@pytest.mark.parametrize("leaves", [1, 2])
@pytest.mark.parametrize("ms", [(1,), (2,), (4,), (8,), (2, 2)], ids=str)
@pytest.mark.parametrize("n", [4, 5, 64, 128])
def test_norm_replay_equals_tree_sum(n, ms, leaves, monkeypatch):
    """The norm kernel's layout replayed step by step (``norm_replay``: each
    block's squares in natural order, a tree thread's leaves, the CTA's
    tree after one barrier with the lane levels as shuffles, the block's
    one-warp tail over its CTAs' partials zero-padded to 256, the blocks in
    coordinate order) on the blocks of 2D N=n (n + 1 nodes a side,
    phantom-padded to the layout) at ``NORM_LEAVES`` 1 and 2: bit for bit
    :func:`krylov.tree_sum` of each block, the sums added in order. The
    squares spread over 2^-26 ... 2^27, so that an addition made in another
    order shows in the bits; once over every leaf, once over the leaves of
    each block's first tree CTA alone (its tree then carries the whole sum)
    and once over each CTA's thread 0 alone (the tail does)."""
    monkeypatch.setattr(fused_ngs, "NORM_LEAVES", leaves)
    shape = [n + 1 + (-(n + 1)) % m for m in ms] + [n + 1] * (2 - len(ms))
    ly, lx = shape[0] // ms[0], shape[1] // (ms[1] if len(ms) > 1 else 1)
    size = 2 * ly * lx
    rng = np.random.default_rng(n * 100 + len(ms) * 10 + leaves)
    ctas, k = norm_geometry(size)
    assert ctas * k * NORM_THREADS >= size and ctas <= NORM_THREADS and k & (k - 1) == 0
    e = np.arange(size)
    for sel in (e >= 0, e % ctas == 0, (e // ctas) % NORM_THREADS == 0):
        squares = [torch.as_tensor(np.where(sel, np.ldexp(1.0 + rng.random(size), rng.integers(-26, 27, size)), 0.0))
                   for _ in range(int(np.prod(ms)))]
        want = tree_sum(squares[0])
        for sq in squares[1:]:
            want = want + tree_sum(sq)
        assert torch.equal(norm_replay(squares, ctas, k), want)
        assert torch.equal(tree_sum_norm(squares[0], ctas, k), tree_sum(squares[0]))


@pytest.mark.parametrize("ms", MESHES + [(1,)], ids=str)
def test_blocked_solve_meets_single_device_and_jax(ms):
    """The blocked Picard solve at 2D N=15 (PICARD_LU_SOLVER_PARAMS'
    tolerances): the single-device twin's count and iterate bit for bit,
    the JAX package's count, its fields within 1e-12 relative (the same
    trajectory, 1.6e-16 apart), its final norm within 1e-6 relative (the
    packages sum the norms in other orders, and a final norm keeps only
    ~eps / rtol of its bits)."""
    n = 15
    state, op, sw, b, x0, (g1, g2) = _problem(n)
    rtol = float(sp.PICARD_LU_SOLVER_PARAMS["snes_rtol"])
    atol = float(sp.PICARD_LU_SOLVER_PARAMS["snes_atol"])
    max_it = int(sp.PICARD_LU_SOLVER_PARAMS["snes_max_it"])
    single = FusedNGSSolver(op, sw, rtol, atol, max_it).plain(b, x0)
    L = LoopbackBlocks(ms)
    got = blocked_ngs(NgsSweep(sw, sw.mesh.node_shape, L), L.cut(b, lead=1), L.cut(x0, lead=1), rtol, atol, max_it)
    jmesh_ = jmesh.StructuredMesh(cells=(n, n), element="quad")
    jW = jmixed(jspaces_of(jmesh_)[1])
    jbcs = [JBC(jW.sub(0), jnp.asarray(g1)), JBC(jW.sub(1), jnp.asarray(g2))]
    ref = jsolve_nonlinear(jW, JParams(), jbcs, solver_parameters=jsp.PICARD_LU_SOLVER_PARAMS)
    assert got.iterations == single.iterations == ref.iteration_number
    x = L.join(got.x)
    assert torch.equal(x, single.x)
    for f in range(2):
        want = np.asarray(ref.solution.data[f])
        assert np.abs(x[f].numpy() - want).max() <= 1e-12 * np.abs(want).max()
    assert abs(got.residual_norm - ref.residual_error) <= 1e-6 * abs(ref.residual_error)


@pytest.mark.parametrize("ms", MESHES + [(4, 2), (1,)], ids=str)
def test_rows_split_once(ms):
    """Each colour's list holds every row of the colour in every block
    exactly once, its straight part first: those rows' 18 taps lie in the
    block and none on the boundary; the general part is the rest of the
    colour (boundary rows among them)."""
    _, _, sw, _, _, _ = _problem(15)
    L = LoopbackBlocks(ms)
    sweep = NgsSweep(sw, sw.mesh.node_shape, L)
    spans, codes = sweep.row_lists()
    assert spans[0][0] == 0 and spans[-1][2] == codes.size
    ny, nx = sw.mesh.node_shape
    for colour, (start, edge, end) in enumerate(spans):
        assert start <= edge <= end and (colour == 0 or spans[colour - 1][2] == start)
        seen = set()
        for k in range(start, end):
            code = int(codes[k])
            p, f, j, i = code >> 27, (code >> 26) & 1, (code >> 13) & 8191, code & 8191
            c = L.coords[p]
            part = sweep.parts[c]
            assert part.colors[f, j, i] == colour and (p, f, j, i) not in seen
            seen.add((p, f, j, i))
            gj, gi = j + part.offsets[0], i + part.offsets[1]
            _, ly, lx = part.shape
            straight = 1 <= j <= ly - 2 and 1 <= i <= lx - 2 and 2 <= gj <= ny - 3 and 2 <= gi <= nx - 3
            assert straight == (k < edge)
        assert len(seen) == sum(int((sweep.parts[c].colors == colour).sum()) for c in L.coords)


# -- the kernels' reads and writes, replayed in numpy through the table ----

class _Memory:
    """The sweep's CPU buffers by address: what the kernels' pointers in the
    table reach."""

    def __init__(self, sweep):
        bufs = [t for c in sweep.coords for t in (sweep.x[c], sweep.b[c], *sweep.send[c].values(),
                                                   *sweep.recv[c].values())]
        self.spans = [(t.data_ptr(), t.data_ptr() + 8 * t.numel(), t.view(-1).numpy()) for t in bufs]

    def at(self, addr):
        for lo, hi, arr in self.spans:
            if lo <= addr < hi:
                return arr, (addr - lo) // 8
        raise AssertionError(f"address {addr:#x} is in no buffer")

    def load(self, addr):
        arr, k = self.at(addr)
        return float(arr[k])

    def store(self, addr, v):
        arr, k = self.at(addr)
        arr[k] = v


def _kernel_residual(mem, w, cw, f, j, i, ny, nx, straight):
    """``row_residual`` / the step's straight path, by their loads."""
    ly, lx, oy, ox = (int(v) for v in w[74:78])
    n = ly * lx
    e = f * n + j * lx + i
    x, b = int(w[0]), int(w[1])
    gj, gi = oy + j, ox + i
    bd = lambda y, z: y <= 0 or y >= ny - 1 or z <= 0 or z >= nx - 1  # noqa: E731
    if bd(gj, gi):
        return mem.load(b + 8 * e) - mem.load(x + 8 * e), True
    acc = 0.0
    for q in range(18):
        g, dy, dx = q // 9, (q % 9) // 3 - 1, q % 3 - 1
        jj, ii = j + dy, i + dx
        if straight:
            u = mem.load(x + 8 * ((g * ly + jj) * lx + ii))
        elif bd(gj + dy, gi + dx):
            u = 0.0
        else:
            sy = 0 if jj < 0 else (2 if jj >= ly else 1)
            sx = 0 if ii < 0 else (2 if ii >= lx else 1)
            d = sy * 3 + sx
            if d == 4:
                u = mem.load(x + 8 * ((g * ly + jj) * lx + ii))
            else:
                ptr, fs, rs, cs = (int(v) for v in w[2 + 4 * d:6 + 4 * d])
                assert ptr, "a tap off the grid's boundary with no source"
                u = mem.load(ptr + 8 * (g * fs + jj * rs + ii * cs))
        acc = acc + cw[f][q] * u
    return mem.load(b + 8 * e) - acc, False


def _replay_step(sweep, mem, words, colour):
    """``ngs_colour_step_kernel`` on every row of the colour, in numpy."""
    start, edge, end = sweep.spans[colour]
    _, codes = sweep.row_lists()
    cw = sweep.weights[:36].reshape(2, 18)
    ny, nx = sweep.n_phys
    for t in range(start, end):
        code = int(codes[t])
        p, f, j, i = code >> 27, (code >> 26) & 1, (code >> 13) & 8191, code & 8191
        w = words[p]
        ly, lx = int(w[74]), int(w[75])
        e = f * ly * lx + j * lx + i
        xv = mem.load(int(w[0]) + 8 * e)
        r, bd = _kernel_residual(mem, w, cw, f, j, i, ny, nx, t < edge)
        xn = xv + r / (1.0 if bd else float(sweep.weights[36 + f]))
        mem.store(int(w[0]) + 8 * e, xn)
        if t < edge:
            continue
        for d in range(9):
            ptr, fs, rs, cs = (int(v) for v in w[38 + 4 * d:42 + 4 * d])
            if d == 4 or not ptr:
                continue
            sy, sx = d // 3 - 1, d % 3 - 1
            if (sy < 0 and j != 0) or (sy > 0 and j != ly - 1) or (sx < 0 and i != 0) or (sx > 0 and i != lx - 1):
                continue
            mem.store(ptr + 8 * (f * fs + j * rs + i * cs), xn)


def _replay_norm(sweep, mem, words):
    """The norm kernels' sum of squares over every block, in their order:
    the rows stage's squares in natural order (``row_residual``'s loads; a
    row with every tap in the block reads the same values), then the tree
    and tail (``norm_replay``) at the table's geometry."""
    cw = sweep.weights[:36].reshape(2, 18)
    ny, nx = sweep.n_phys
    squares = []
    for w in words:
        ly, lx = int(w[74]), int(w[75])
        sq = []
        for e in range(2 * ly * lx):
            f, rem = divmod(e, ly * lx)
            r, _ = _kernel_residual(mem, w, cw, f, rem // lx, rem % lx, ny, nx, False)
            sq.append(r * r)
        squares.append(torch.tensor(sq, dtype=torch.float64))
    ctas, leaves = int(words[0][79]), int(words[0][80])
    assert all((int(w[79]), int(w[80])) == (ctas, leaves) for w in words)
    return math.sqrt(float(norm_replay(squares, ctas, leaves)))


@pytest.mark.parametrize("remote", [False, True], ids=["in-place", "buffers"])
@pytest.mark.parametrize("ms", [(2,), (2, 2)], ids=str)
def test_kernel_table_replayed_equals_twin(ms, remote):
    """A sweep of every colour and the norm, replayed in numpy as the
    kernels read and write through the blocks' table (:data:`PART_WORDS`
    words a block: x, b, each direction's ghost source and send buffer,
    the norm's CTAs) and the packed row lists, with the neighbours' x read
    in place or through the exchange buffers: the twin's iterate and norm
    bit for bit."""
    _, _, sw, _, _, _ = _problem(7)
    rng = np.random.default_rng(7)
    x, b = (torch.as_tensor(rng.standard_normal((2,) + sw.mesh.node_shape)) for _ in range(2))
    L = LoopbackBlocks(ms)
    runs = {}
    for how in ("twin", "replay"):
        sweep = NgsSweep(sw, sw.mesh.node_shape, L, remote=remote)
        sweep.reset(0.0, 0.0, 10)
        sweep.load(L.cut(b, lead=1), L.cut(x, lead=1))
        words = sweep.table_words()
        assert words.shape == (len(L.coords), PART_WORDS)
        mem = _Memory(sweep)
        for colour in range(sw.ncolors):
            if how == "twin":
                sweep.step(colour)
            else:
                _replay_step(sweep, mem, words, colour)
                sweep._exchange()
        if how == "twin":
            sweep.norm(init=True)
            fn = float(sweep.state[FN])
        else:
            fn = _replay_norm(sweep, mem, words)
        runs[how] = (L.join(sweep.x), fn)
    assert torch.equal(runs["twin"][0], runs["replay"][0]) and runs["twin"][1] == runs["replay"][1]


def test_world_of_one_route():
    """The sharded Picard ngs on one rank takes the single-device solve
    where the fused kernel's plan places the grid; with peers, with
    another SNES type, or beyond the plan (2D N=300) the blocked one."""
    W = _problem(7)[0].W
    frozen = _freeze(sp.PICARD_LU_SOLVER_PARAMS)
    assert ngs_on_one_rank_whole(W, frozen, 1)
    assert not ngs_on_one_rank_whole(W, frozen, 2)
    assert not ngs_on_one_rank_whole(W, _freeze({**sp.PICARD_LU_SOLVER_PARAMS, "snes_type": "block_gs"}), 1)
    big = from_numpy_state({}, (300, 300), "quad", np.zeros((301, 301)), np.zeros((301, 301)), device="cpu").W
    assert not ngs_on_one_rank_whole(big, frozen, 1)


def test_two_worlds_at_once():
    """Two 2-rank gloo worlds started at the same moment both come up and
    finish: each world's rendezvous store is its launcher's, bound to a
    port the system picks and held until the ranks end."""
    out, errors = [None, None], []

    def run(k):
        try:
            out[k] = spawn_world(2, "batch", {"device": "cpu", "tasks": []}, timeout=300.0)
        except Exception as err:  # noqa: BLE001 - reported below
            errors.append(err)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert out == [[[], []], [[], []]]
