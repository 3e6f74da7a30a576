"""K7 (``ops/cuda/row_copy.py``): rows of many tensors gathered from a pool
and scattered back into it, one call each.

On the CPU the plain versions against a loop over the rows: a gather of rows
in any order, padding rows (``~row``) gathered from their row, a scatter
that skips the padding rows (left bit for bit), sources whose rows lie
strided (a slice of a longer tensor), and the refusals.  On the card (marked
``cuda``) the kernel against the plain versions bit for bit: fp32, int32 and
bf16 leaves whose rows are 16-byte multiples, 4-byte multiples and neither,
empty rows, the most tensors one launch takes, a row outside the pool
skipped, and a graph that replays it.  Imports no JAX: ``python -m pytest
--noconftest -q -m cuda tests/test_torch_row_copy.py``.
"""

import pytest
import torch

from cleanumamba_tpu_torch.ops.cuda.row_copy import (
    MAX_SEGMENTS,
    gather_rows,
    gather_rows_ref,
    scatter_rows,
    scatter_rows_ref,
)

SHAPES = [((6, 3), torch.float32), ((6, 4, 5), torch.float32), ((6,), torch.int32),
          ((6, 2, 7), torch.bfloat16), ((6, 0, 4), torch.float32), ((6, 64, 8), torch.float32)]


def _leaves(g, device, shapes=SHAPES, rows=None):
    out = []
    for shape, dtype in shapes:
        shape = shape if rows is None else (rows, *shape[1:])
        if dtype.is_floating_point:
            out.append(torch.randn(shape, generator=g).to(dtype).to(device))
        else:
            out.append(torch.randint(-1000, 1000, shape, generator=g, dtype=dtype).to(device))
    return out


def _loop(dsts, srcs, rows, scatter):
    for i, r in enumerate(int(r) for r in rows):
        if scatter and r < 0:
            continue
        r = r if r >= 0 else ~r
        for d, s in zip(dsts, srcs):
            if scatter:
                d[r] = s[i]
            else:
                d[i] = s[r]


# (rows, scatter): a row of the pool as its index, a padding row as ~row
CASES = {
    "gather": ([4, 1, 5], False),
    "gather, padding rows": ([~3, 0, ~5, 2], False),
    "scatter, padding rows": ([2, ~0, 5], True),
    "scatter, one row": ([4], True),
}


def _case(name, g, device, shapes=SHAPES):
    rows, scatter = CASES[name]
    pool = _leaves(g, device, shapes)
    part = _leaves(g, device, shapes, rows=len(rows))
    dsts, srcs = (pool, part) if scatter else (part, pool)
    return torch.tensor(rows, device=device), scatter, dsts, srcs


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_copies_the_rows_it_names(name):
    rows, scatter, dsts, srcs = _case(name, torch.Generator().manual_seed(0), "cpu")
    want = [d.clone() for d in dsts]
    _loop(want, srcs, rows, scatter)
    (scatter_rows if scatter else gather_rows)(dsts, srcs, rows)
    assert all(torch.equal(d, w) for d, w in zip(dsts, want))


def test_strided_source_rows_and_refusals():
    g = torch.Generator().manual_seed(1)
    long = torch.randn((4, 9, 3), generator=g)
    src = long[:, 2:, :]  # each row contiguous, rows 27 values apart
    dst = torch.zeros((4, 7, 3))
    gather_rows([dst], [src], torch.tensor([3, 2, 1, 0]))
    assert torch.equal(dst, src.flip(0))
    with pytest.raises(ValueError, match="pair 0"):
        gather_rows([torch.zeros(4, 2)], [torch.zeros(4, 3)], torch.arange(4))
    with pytest.raises(ValueError, match="int64"):
        gather_rows([dst], [src], torch.tensor([0, 1, 2, 3], dtype=torch.int32))
    with pytest.raises(ValueError, match="rows of a pool"):
        scatter_rows([dst], [src], torch.arange(3))  # 4 rows of source for 3 indices
    with pytest.raises(ValueError, match="rows of a pool"):
        gather_rows([dst, torch.zeros(4, 1)], [src, torch.zeros(5, 1)], torch.arange(4))
    many = [torch.zeros(4, 1)] * (MAX_SEGMENTS + 1)
    with pytest.raises(ValueError, match="a launch takes"):
        gather_rows(many, many, torch.arange(4))
    with pytest.raises(IndexError):  # a row outside the pool
        gather_rows([dst], [src], torch.tensor([0, 1, 2, 4]))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K7 has no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_plain_version_on_the_card(card, name):
    g = torch.Generator().manual_seed(2)
    shapes = (SHAPES * 16)[:MAX_SEGMENTS]  # the most pairs one launch takes
    rows, scatter, dsts, srcs = _case(name, g, card, shapes)
    if scatter:  # sources whose rows lie strided
        srcs = [torch.cat([s, s], 1)[:, :s.shape[1]] if s.ndim > 1 else s for s in srcs]
    want = [d.clone() for d in dsts]
    (scatter_rows_ref if scatter else gather_rows_ref)(want, srcs, rows)
    fn = scatter_rows if scatter else gather_rows
    n0 = fn.launches
    fn(dsts, srcs, rows)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert all(torch.equal(d, w) for d, w in zip(dsts, want))
    # a row outside the pool is skipped: the other rows as before
    fn(dsts, srcs, torch.where(rows == rows[0], 99, rows))
    torch.cuda.synchronize()
    assert all(torch.equal(d, w) for d, w in zip(dsts, want))


@pytest.mark.cuda
def test_kernel_replays_in_a_graph(card):
    g = torch.Generator().manual_seed(3)
    pool = _leaves(g, card)
    rows = torch.tensor([5, 2], device=card)
    got = [p.new_empty((2, *p.shape[1:])) for p in pool]
    side = torch.cuda.Stream(card)
    side.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(side):
        gather_rows(got, pool, rows)
    torch.cuda.current_stream(card).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gather_rows(got, pool, rows)
    for r in ([1, 0], [3, ~4]):
        rows.copy_(torch.tensor(r))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(x, p[[1, 0] if r[0] == 1 else [3, 4]]) for x, p in zip(got, pool))
