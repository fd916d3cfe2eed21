"""The port's CUDA kernels on the card, held against their plain PyTorch
versions at small and ragged shapes, and the slice's entry points on the
card held against the same calls on the CPU.

Marked `cuda`: each test skips on a machine without CUDA (decided in a
fixture, not at import). On a machine with the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX for the TPU package's
tests; this file imports neither JAX nor blp_tpu.)

Tolerances: K1 counts are integers, compared exactly (the kernel and its
plain version add in the same fixed fp32 order). K2 outputs are bf16 with
products summed in another order: rtol = atol = 2e-2, the bf16 noise class.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from blp_tpu_torch import evaluation
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.ops import packed_attention, transe_rank

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA is not available here)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _k1_inputs(rng, q, n_rows, d, kind):
    if kind == "integer":   # many exact ties
        table = rng.integers(-2, 3, (n_rows, d)).astype(np.float32)
        u = rng.integers(-1, 2, (q, d)).astype(np.float32)
    else:
        table = rng.standard_normal((n_rows, d)).astype(np.float32)
        table /= np.linalg.norm(table, axis=1, keepdims=True)
        u = 0.3 * rng.standard_normal((q, d)).astype(np.float32)
    pos = rng.integers(0, n_rows, q)
    table[rng.integers(0, n_rows, min(q, 8))] = table[pos[:min(q, 8)]]
    return torch.from_numpy(table), torch.from_numpy(u), torch.from_numpy(pos)


@pytest.mark.parametrize("q,n_rows,num_valid,d,kind", [
    (128, 4096, 4000, 128, "normal"),
    (6, 1000, 1000, 40, "normal"),      # ragged tile, d not a multiple of 32
    (130, 777, 700, 16, "integer"),     # two query groups, many ties
    (1, 63, 63, 33, "integer"),
])
def test_k1_kernel_counts_equal_plain(q, n_rows, num_valid, d, kind):
    rng = np.random.default_rng(q + n_rows + d)
    table, u, pos = _k1_inputs(rng, q, n_rows, d, kind)
    r = transe_rank._seq_abs_scores(table[pos][:, None, :], u)
    want = transe_rank.raw_counts_plain(table, u, r, pos, num_valid)
    before = transe_rank.launches
    got = transe_rank.raw_counts(table.cuda(), u.cuda(), r.cuda(), pos.cuda(),
                                 num_valid)
    torch.cuda.synchronize()
    assert transe_rank.launches == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_k1_bidir_entry_point_card_equals_cpu():
    rng = np.random.default_rng(4)
    b, n, d = 8, 3000, 64
    table = rng.standard_normal((n, d)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    hp, tp = rng.integers(0, n, b), rng.integers(0, n, b)
    rel = 0.2 * rng.standard_normal((b, d)).astype(np.float32)
    hf = rng.integers(-1, n, (b, 5)).astype(np.int32)
    tf = rng.integers(-1, n, (b, 5)).astype(np.int32)
    args = [torch.from_numpy(a) for a in
            (table, table[hp], table[tp], rel, np.zeros((b, 1), np.float32),
             np.zeros((b, 1), np.float32), hp, tp, hf, tf)]
    want = transe_rank.transe_tiled_rank_counts_bidir(*args, n - 10)
    got = transe_rank.transe_tiled_rank_counts_bidir(
        *(a.cuda() for a in args), n - 10)
    for k in want:
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=0, atol=0,
                                   msg=k)


def _k2_inputs(b, nh, nseg, seg, hd, seed):
    g = torch.Generator().manual_seed(seed)
    sp = nseg * seg
    q, k, v = (torch.randn((b, nh, sp, hd), generator=g).to(torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(1, seg + 1, (b, nseg), generator=g)
    mask = (torch.arange(seg)[None, None] < lens[:, :, None]).reshape(b, sp)
    return q, k, v, mask.float()


@pytest.mark.parametrize("b,nh,nseg,seg,hd", [
    (4, 12, 4, 32, 64),     # the BERT-base packed row
    (3, 4, 2, 32, 16),      # pack 2
    (2, 3, 1, 16, 32),      # no packing
    (2, 2, 4, 8, 128),
    (2, 3, 3, 8, 8),        # Sp 24, hd 8: both padded to the fragment size
    (2, 2, 4, 10, 12),      # hd not a multiple of 8: scalar staging
    (1, 2, 1, 5, 24),
    (1, 1, 2, 7, 9),        # odd hd: scalar stores
])
def test_k2_kernel_matches_plain(b, nh, nseg, seg, hd):
    q, k, v, mask = _k2_inputs(b, nh, nseg, seg, hd, seed=b * nh + hd)
    mask[0, :seg] = 0.0     # one segment with no real key
    scale = 1.0 / math.sqrt(hd)
    want = packed_attention.block_diag_attention(q, k, v, mask, seg=seg,
                                                 scale=scale)
    before = packed_attention.launches
    got = packed_attention.block_diag_attention(
        q.cuda(), k.cuda(), v.cuda(), mask.cuda(), seg=seg, scale=scale)
    torch.cuda.synchronize()
    assert packed_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_k2_refuses_rows_beyond_shared_memory():
    q = torch.zeros((1, 2, 192, 64), dtype=torch.bfloat16, device="cuda")
    before = packed_attention.launches
    with pytest.raises(ValueError, match="shared memory"):
        packed_attention.block_diag_attention(
            q, q, q, torch.ones((1, 192), device="cuda"), seg=64, scale=1.0)
    assert packed_attention.launches == before


def _model(compute_dtype, fused):
    enc = bert.BertConfig.tiny(hidden_size=64, num_heads=4,
                               intermediate_size=128,
                               compute_dtype=compute_dtype,
                               fused_attention=fused)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=3, encoder=enc)
    params = blp.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, params


def test_fused_encode_on_card_close_to_fp32_cpu():
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, (16, 32))
    mask = (np.arange(32)[None] < rng.integers(2, 33, 16)[:, None]).astype(
        np.float32)
    cfg32, params = _model(torch.float32, False)
    want = blp.encode(blp.encode_view(params, cfg32), cfg32, ids, mask,
                      device="cpu")
    cfg16 = dataclasses.replace(cfg32, encoder=dataclasses.replace(
        cfg32.encoder, compute_dtype=torch.bfloat16, fused_attention=True))
    params_c = blp.to_device(params, "cuda")
    before = packed_attention.launches
    got = blp.encode(blp.encode_view(params_c, cfg16), cfg16, ids, mask,
                     device="cuda")
    assert packed_attention.launches == before + cfg16.encoder.num_layers
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-2)


def test_eval_on_card_equals_cpu_on_one_table():
    rng = np.random.default_rng(1)
    n, d, b = 300, 16, 8
    table = rng.standard_normal((n, d)).astype(np.float32)
    table /= np.linalg.norm(table, axis=1, keepdims=True)
    trip = np.stack([rng.integers(0, n, 3 * b), rng.integers(0, n, 3 * b),
                     rng.integers(0, 3, 3 * b)], axis=1)
    cfg = blp.ModelConfig(model="transductive", rel_model="transe", dim=d,
                          num_relations=3, num_entities=n)
    rel = torch.from_numpy(0.1 * rng.standard_normal((3, d)).astype(np.float32))
    kw =dict(batch_size=b, filter_index=FilterIndex(trip), ent_emb=table)
    want = evaluation.eval_link_prediction({"rel_emb": rel}, cfg, trip, None,
                                           np.arange(n), device="cpu", **kw)
    before = transe_rank.launches
    got = evaluation.eval_link_prediction({"rel_emb": rel.cuda()}, cfg, trip,
                                          None, np.arange(n), device="cuda",
                                          **kw)
    assert transe_rank.launches == before + 3
    assert got.scalars("x") == want.scalars("x")
