"""The word tables' row gather (blp_tpu_torch/ops/row_gather.py) on the CPU.

The op's CPU path is autograd of `table[ids]`, as before: its rows and its
gradient equal those of plain indexing bit for bit at the BOW, DKRL and BERT
shapes, and the three word-table call sites go through it. `segment_sum_plain`
(the card kernel's order: chunks of CHUNK sorted positions, then each
crossing run's partials in chunk order) is held to a float64 sum of the same
contributions within the bound of recursive f32 summation, (CHUNK + the
run's chunk count) * 2^-24 * sum |g| per element, and to autograd's
gradient exactly where every partial sum is an integer of f32 (exact).
Torch is pinned to one thread: the CPU's index backward adds in an order
that follows the thread count."""

import numpy as np
import pytest
import torch

from blp_tpu_torch.models import bert, encoders
from blp_tpu_torch.ops import row_gather
from blp_tpu_torch.ops.row_gather import CHUNK, gather_rows, segment_sum_plain


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _padded_ids(rng, shape, vocab, lo, special=()):
    """Descriptions of `shape` (..., L): lengths uniform in [lo, L], ids in
    [1, vocab), the first and last real token `special` where given, 0 past
    each length."""
    L = shape[-1]
    ids = rng.integers(1, vocab, shape)
    lengths = rng.integers(lo, L + 1, shape[:-1])
    if special:
        ids[..., 0] = special[0]
        np.put_along_axis(ids, (lengths - 1)[..., None], special[1], axis=-1)
    ids[np.arange(L) >= lengths[..., None]] = 0
    return torch.from_numpy(ids)


# (name, vocab rows, width, ids shape, shortest description, [CLS] [SEP])
SHAPES = [("bow-glove", 4001, 300, (16, 2, 64), 8, ()),
          ("dkrl-glove", 4001, 300, (16, 2, 64), 8, ()),
          ("bert", 2899, 768, (32, 64), 8, (101, 102))]


@pytest.mark.parametrize("name,vocab,width,shape,lo,special", SHAPES)
def test_cpu_path_is_autograd_of_indexing(name, vocab, width, shape, lo, special):
    rng = np.random.default_rng(len(name))
    table = torch.from_numpy(rng.standard_normal((vocab, width)).astype(np.float32))
    ids = _padded_ids(rng, shape, vocab, lo, special)
    g = torch.from_numpy(rng.standard_normal(shape + (width,)).astype(np.float32))
    a = table.clone().requires_grad_()
    b = table.clone().requires_grad_()
    rows_a = gather_rows(a, ids)
    rows_b = b[ids.long()]
    assert type(rows_a.grad_fn) is type(rows_b.grad_fn)
    assert torch.equal(rows_a, rows_b)
    (ga,) = torch.autograd.grad(rows_a, a, g)
    (gb,) = torch.autograd.grad(rows_b, b, g)
    assert torch.equal(ga, gb)
    with torch.no_grad():
        assert torch.equal(gather_rows(a, ids.to(torch.int32)), rows_b)


def _count_calls(monkeypatch, module):
    calls = []

    def counted(table, ids):
        calls.append(tuple(ids.shape))
        return row_gather.gather_rows(table, ids)

    monkeypatch.setattr(module, "gather_rows", counted)
    return calls


def test_word_table_call_sites_gather_through_the_op(monkeypatch):
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((50, 12)).astype(np.float32))
    ids = _padded_ids(rng, (5, 16), 50, 4)
    mask = (ids > 0).to(torch.float32)
    calls = _count_calls(monkeypatch, encoders)
    encoders.bow_encode(table, ids, mask)
    encoders.dkrl_encode(encoders.init_dkrl_params(torch.Generator().manual_seed(0), 12, 8),
                         table, ids, mask)
    assert calls == [(5, 16), (5, 16)]

    cfg = bert.BertConfig.tiny()
    params = bert.init_bert_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    calls = _count_calls(monkeypatch, bert)
    tok = _padded_ids(rng, (4, 8), cfg.vocab_size, 2, (1, 2))
    bert.embed_inputs(params, tok, (tok > 0).to(torch.float32), cfg)
    assert calls == [(4, 8)]


def _reference(g, ids, num_rows):
    E = g.shape[-1]
    exact = torch.zeros((num_rows, E), dtype=torch.float64).index_add_(
        0, ids.reshape(-1).long(), g.reshape(-1, E).double())
    mass = torch.zeros((num_rows, E), dtype=torch.float64).index_add_(
        0, ids.reshape(-1).long(), g.reshape(-1, E).double().abs())
    return exact, mass


C = CHUNK
SUM_CASES = {
    "one id": (torch.full((5 * C + 3,), 7), 11, 16),
    "chunk boundaries": (torch.cat([torch.full((C,), 2), torch.full((C + 1,), 5),
                                    torch.full((C - 1,), 6), torch.tensor([8]),
                                    torch.full((2 * C,), 9)]), 12, 24),
    "last row": (torch.tensor([3] * 5 + [9] * (3 * C)), 10, 8),
    "runs of 1": (torch.randperm(3000, generator=torch.Generator().manual_seed(1)), 4000, 20),
    "padded descriptions": (None, 400, 36),
}


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_segment_sum_plain_within_f32_summation_bound(case):
    ids, num_rows, width = SUM_CASES[case]
    rng = np.random.default_rng(3)
    if ids is None:
        ids = _padded_ids(rng, (40, 64), num_rows, 4)
    g = torch.from_numpy(rng.standard_normal(tuple(ids.shape) + (width,)).astype(np.float32))
    got = segment_sum_plain(g, ids, num_rows)
    exact, mass = _reference(g, ids, num_rows)
    counts = torch.bincount(ids.reshape(-1).long(), minlength=num_rows)
    chain = C + 1 + (counts + C - 1) // C
    bound = chain[:, None].double() * 2.0 ** -24 * mass
    assert ((got.double() - exact).abs() <= bound).all()
    assert (got[counts == 0] == 0).all()
    assert got.dtype == torch.float32 and got.shape == (num_rows, width)


@pytest.mark.parametrize("case", list(SUM_CASES))
def test_segment_sum_plain_equals_autograd_on_exact_sums(case):
    """Small integers sum exactly in f32 in any order, so the kernel's order
    and autograd's index backward must agree bit for bit."""
    ids, num_rows, width = SUM_CASES[case]
    rng = np.random.default_rng(4)
    if ids is None:
        ids = _padded_ids(rng, (40, 64), num_rows, 4)
    g = torch.from_numpy(rng.integers(-8, 9, tuple(ids.shape) + (width,)).astype(np.float32))
    table = torch.zeros((num_rows, width), requires_grad=True)
    (want,) = torch.autograd.grad(table[ids.long()], table, g)
    assert torch.equal(segment_sum_plain(g, ids, num_rows), want)


def test_segment_sum_plain_adds_each_run_in_chunk_order():
    """A run over three chunks: 2^24 then 2C + 4 ones. Added one at a time,
    every 1 rounds away against 2^24; the kernel's order adds the ones of
    each later chunk first, so they count: 2^24 + C, then + 5, rounded to
    even."""
    n = 2 * C + 5
    g = torch.ones((n, 1))
    g[0, 0] = 2.0 ** 24
    got = segment_sum_plain(g, torch.zeros(n, dtype=torch.long), 1)
    want = (torch.tensor(2.0 ** 24) + float(C)) + 5.0
    assert got[0, 0] == want == 2.0 ** 24 + C + 4
