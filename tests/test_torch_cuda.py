"""The port's CUDA kernels on the card, held against their plain PyTorch
versions at small and ragged shapes, and the slice's entry points on the
card held against the same calls on the CPU.

Marked `cuda`: each test skips on a machine without CUDA (decided in a
fixture, not at import). On a machine with the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up JAX for the TPU package's
tests; this file imports neither JAX nor blp_tpu.)

Tolerances: K1 counts are integers, compared exactly (both of the kernel's
variants and its plain version add in the same fixed fp32 order). K2 outputs are bf16 with
products summed in another order: rtol = atol = 2e-2, the bf16 noise class.
K3 scores are fp32 sums in another order: rtol = atol = 1e-5; its
backward kernel forms the plain backward's products and adds them in its
fixed order, so it is bit-identical across calls and to
sddmm_scores_backward_plain on the CPU, and within rtol 1e-5, atol 1e-6 of
autograd through the plain formulation (another order). The
training step on the card holds the CPU's loss within rtol 1e-5 and its
gradients within rtol 1e-4, atol 1e-6 (fp32, dropout 0, the same injected
negatives; cuBLAS sums in another order). F1 and F2 (the layer's fused
chains): bf16 outputs and dh within one bf16 ulp of the plain version on the
card (F2's outputs and ds plus 1e-5 of the largest, for the f32 order of its
row sums), f32 ones within rtol 1e-5, db, dscale and dbias within rtol 1e-4
(atol 1e-4 of the largest) and identical across calls. F3 (the attention
softmax chain): y and dl within one bf16 ulp plus 1e-5 of the largest of the
plain chain and its autograd VJP (f32: rtol 1e-5, atol 1e-5 of the largest),
for the kernel's order of the row sums and its reciprocal of the sum where
torch divides; a bf16 y with dropout within two ulps (the dropout's second
rounding of a probability one ulp apart); identical across calls. The
dropout masks that F3, F2 and the site kernel evaluate in registers equal
the plain generator's (ops/dropout_rng.py) bit for bit, forward and
backward, and so do s = x + drop(r) and dr = drop(ds): both are torch's
CUDA ops (a division by a Python number multiplies by its f32 reciprocal,
as the kernels do).
"""

import ctypes
import dataclasses
import math
import os
import subprocess

import numpy as np
import pytest
import torch

from blp_tpu_torch import checkpoint, evaluation, training
from blp_tpu_torch.data import sampling
from blp_tpu_torch.data.filtering import FilterIndex
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.ops import (_cuda, attn_softmax, dropout_rng, fused_layer,
                               packed_attention, row_gather, sddmm, transe_rank)

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


@pytest.mark.parametrize("q,n_rows,num_valid,d,kind,offset,tp_past", [
    (128, 4096, 4000, 128, "normal", 0, False),
    (6, 1000, 1000, 40, "normal", 0, False),     # ragged tile, d % 32 != 0
    (130, 777, 700, 16, "integer", 0, False),    # two query groups, many ties
    (1, 63, 63, 33, "integer", 0, False),        # d % 4 != 0: scalar
    (128, 5000, 4990, 300, "normal", 0, False),  # the word models' widths:
    (128, 5000, 4990, 768, "normal", 0, False),  # GloVe (a 12-dim last chunk), BERT
    (64, 2000, 1900, 64, "integer", 0, False),
    (256, 3000, 2999, 32, "integer", 0, False),  # two full query groups
    (1, 500, 500, 128, "normal", 0, True),
    (130, 1500, 1200, 300, "normal", 0, True),   # true rows at or past num_valid
    (256, 2500, 2400, 768, "integer", 0, True),
    (6, 700, 650, 33, "normal", 0, True),        # scalar, true rows past num_valid
    (128, 4096, 4000, 128, "normal", 1, False),  # a table view 4 bytes off: scalar
    (64, 300, 300, 16, "integer", 1, True),
])
def test_k1_kernel_counts_equal_plain(q, n_rows, num_valid, d, kind, offset,
                                      tp_past):
    rng = np.random.default_rng(q + n_rows + d + offset)
    table, u, pos = _k1_inputs(rng, q, n_rows, d, kind)
    if tp_past:   # half the true rows at or past num_valid (some past n_rows)
        half = max(1, q // 2)
        pos[:half] = num_valid + torch.arange(half) % (n_rows - num_valid + 3)
    r = transe_rank._seq_abs_scores(table[pos.clamp(max=n_rows - 1)][:, None, :], u)
    want = transe_rank.raw_counts_plain(table, u, r, pos, num_valid)
    buf = torch.zeros(n_rows * d + 4, device="cuda")
    table_c = buf[offset:offset + n_rows * d].view(n_rows, d)
    table_c.copy_(table)
    u_c = u.cuda()
    variant = "scalar" if d % 4 or offset else "tma"
    assert transe_rank.variant(n_rows, d, table_c.data_ptr(), u_c.data_ptr()) == variant
    before = (transe_rank.launches, transe_rank.launches_by_variant[variant, d])
    got = transe_rank.raw_counts(table_c, u_c, r.cuda(), pos.cuda(), num_valid)
    torch.cuda.synchronize()
    assert (transe_rank.launches, transe_rank.launches_by_variant[variant, d]) == (
        before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


def test_k1_no_live_column_launches_nothing():
    """num_valid 0 (or an empty table): zero counts, and no launch (a tensor
    map of 0 rows cannot be made)."""
    table = torch.randn((50, 16), device="cuda")
    u = torch.randn((3, 16), device="cuda")
    r = torch.ones((3, 1), device="cuda")
    pos = torch.zeros(3, dtype=torch.int64, device="cuda")
    before = transe_rank.launches
    for t, nv in ((table, 0), (table[:0], 10)):
        assert transe_rank.raw_counts(t, u, r, pos, nv).tolist() == [[0] * 3, [0] * 3]
    assert transe_rank.launches == before


def test_k1_variant_rule_equals_the_kernels():
    """ops/transe_rank.py `variant` and csrc/transe_rank.cu `pick_variant`
    agree on widths, row counts and alignments (addresses are not read)."""
    import ctypes

    from blp_tpu_torch.ops import _cuda

    fn = _cuda.load("transe_rank").transe_rank_variant
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    base = 1 << 20
    for n_rows in (1, 4_800_000, 2 ** 30 - 1, 2 ** 30):
        for d in (2, 4, 16, 33, 40, 128, 300, 768):
            for t_off in (0, 4, 8, 16):
                for u_off in (0, 4, 32):
                    want = transe_rank.variant(n_rows, d, base + t_off, base + u_off)
                    got = transe_rank.VARIANTS[fn(n_rows, d, base + t_off, base + u_off)]
                    assert got == want, (n_rows, d, t_off, u_off)


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
    (1, 12, 4, 32, 64),     # B 1 and 2: fewer pairs than SMs
    (2, 12, 4, 32, 64),
    (23, 12, 4, 32, 64),    # 276 pairs: not a multiple of the grid
    (1, 2, 6, 32, 64),      # Sp 192
    (2, 4, 6, 32, 64),
    (2, 3, 3, 32, 64),      # Sp 96: the whole-row range is three chunks
    (2, 2, 8, 3, 64),       # seg 3: a 16-row tile spans six segments
    (2, 2, 4, 32, 128),     # hd 128 at Sp 128: two blocks per SM
    (1, 2, 16, 32, 64),     # Sp 512, BERT's positions
    (1, 2, 37, 16, 64),     # Sp 592, the longest row a block holds at hd 64
    (4, 12, 2, 64, 64),     # the Wikidata5M keys' packed row: max_len 64, pack 2
    (3, 2, 2, 64, 16),
    (2, 2, 1, 64, 64),      # seg 64 unpacked
    (2, 3, 3, 64, 64),      # Sp 192 in 64-token segments
    (5, 2, 2, 64, 128),
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


def test_k2_empty_segments_at_the_main_path_shape():
    """Segments with no real key take the whole-row path: a fully masked
    packed row, and empty tail segments as in a padded final batch."""
    q, k, v, mask = _k2_inputs(16, 12, 4, 32, 64, seed=3)
    mask[0] = 0.0
    mask[5, 64:] = 0.0
    mask[9, 96:] = 0.0
    mask[12, :32] = 0.0
    mask[12, 64:96] = 0.0
    want = packed_attention.block_diag_attention(q, k, v, mask, seg=32,
                                                 scale=0.125)
    got = packed_attention.block_diag_attention(
        q.cuda(), k.cuda(), v.cuda(), mask.cuda(), seg=32, scale=0.125)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_k2_seg64_rows_ending_in_empty_segments():
    """At seg 64 a warp's 16 rows lie in one segment whose 64 keys run in two
    32-key chunks; rows whose segment has no real key (a padded final
    batch's empty tail, an empty first segment, a fully masked row) run
    against all 128 keys."""
    q, k, v, mask = _k2_inputs(16, 12, 2, 64, 64, seed=64)
    mask[0] = 0.0
    mask[3, 64:] = 0.0
    mask[7, 64:] = 0.0
    mask[11, :64] = 0.0
    mask[15, 1:64] = 0.0    # a segment with one real key
    want = packed_attention.block_diag_attention(q, k, v, mask, seg=64,
                                                 scale=0.125)
    got = packed_attention.block_diag_attention(
        q.cuda(), k.cuda(), v.cuda(), mask.cuda(), seg=64, scale=0.125)
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=2e-2,
                               atol=2e-2)


def test_k2_seg64_at_the_w5m_phase1_chunk():
    """The Wikidata5M phase-1 chunk: emb_batch_size 12,288 at max_len 64 is
    6,144 packed rows of 2 segments (12 heads, hd 64), about 1 row in 8
    ending in an empty segment; held to the plain version on the card."""
    b, nh, sp, hd = 6144, 12, 128, 64
    g = torch.Generator(device="cuda").manual_seed(6144)
    q, k, v = (torch.randn((b, nh, sp, hd), generator=g, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.randint(1, 65, (b, 2), generator=g, device="cuda")
    lens[torch.randint(0, 8, (b,), generator=g, device="cuda") == 0, 1] = 0
    mask = (torch.arange(64, device="cuda")[None, None] < lens[:, :, None])
    mask = mask.reshape(b, sp).float()
    before = packed_attention.launches
    got = packed_attention.block_diag_attention(q, k, v, mask, seg=64,
                                                scale=0.125)
    assert packed_attention.launches == before + 1
    for lo in range(0, b, 1024):   # the plain version a slice at a time
        sl = slice(lo, lo + 1024)
        want = packed_attention.block_diag_attention_plain(
            q[sl], k[sl], v[sl], mask[sl], seg=64, scale=0.125)
        torch.testing.assert_close(got[sl].float(), want.float(), rtol=2e-2,
                                   atol=2e-2)


def test_k2_refuses_misaligned_inputs():
    buf = torch.zeros(2 * 4 * 32 * 64 + 1, dtype=torch.bfloat16, device="cuda")
    q = buf[1:].view(1, 2, 4 * 32, 64)
    before = packed_attention.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        packed_attention.block_diag_attention(
            q, q, q, torch.ones((1, 128), device="cuda"), seg=32, scale=1.0)
    assert packed_attention.launches == before


@pytest.mark.parametrize("sp,hd,match", [(608, 64, "shared memory"),
                                         (32, 136, "head dim")])
def test_k2_refuses_shapes_beyond_its_limits(sp, hd, match):
    q = torch.zeros((1, 2, sp, hd), dtype=torch.bfloat16, device="cuda")
    before = packed_attention.launches
    with pytest.raises(ValueError, match=match):
        packed_attention.block_diag_attention(
            q, q, q, torch.ones((1, sp), device="cuda"), seg=32, scale=1.0)
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


K3_MODELS = ["transe", "distmult", "complex", "simple"]


def _k3_indices(g, b, k, kind):
    """(B, K, 2) int32 corruption indices: the sampler's (one own slot in
    every task), or arbitrary ones in [0, 2B) with one row hit by many tasks
    on both sides and the own slots swapped or doubled."""
    if kind == "sampler":
        return sampling.sample_negative_indices(g, b, k, device="cpu")
    neg = torch.randint(0, 2 * b, (b, k, 2), generator=g, dtype=torch.int32)
    own = 2 * torch.arange(b, dtype=torch.int32)
    neg[:, 0::3] = 0                                  # a hot row, both sides
    if k > 1:
        neg[:, 1, 0], neg[:, 1, 1] = own + 1, own     # own slots, swapped
    if k > 2:
        neg[:, 2, 0], neg[:, 2, 1] = own, own         # the own head twice
    return neg


@pytest.mark.parametrize("rel_model", K3_MODELS)
@pytest.mark.parametrize("b,k,d,kind,offset", [
    (1, 4, 128, "arbitrary", 0),     # B 1: a single edge row
    (2, 64, 128, "sampler", 0),
    (23, 64, 128, "sampler", 0),     # 207 warps: not a multiple of a block
    (1024, 64, 128, "sampler", 0),   # the Wikidata5M batch
    (23, 7, 128, "arbitrary", 0),
    (16, 0, 128, "arbitrary", 0),    # K 0: the positive pair only
    (9, 5, 64, "sampler", 1),        # ent 4 bytes off 16: scalar loads
    (9, 5, 64, "sampler", 2),        # ent 8 bytes off 16: float2 loads
])
def test_k3_forward_matches_plain(rel_model, b, k, d, kind, offset):
    g = torch.Generator().manual_seed(b + k + d + offset)
    buf = torch.randn(2 * b * d + offset, generator=g)
    ent = buf[offset:].view(2 * b, d)
    rel = torch.randn((b, d), generator=g)
    neg = _k3_indices(g, b, k, kind)
    want_pos, want_neg = sddmm.sddmm_scores_plain(ent, rel, neg, rel_model)
    before = sddmm.launches
    pos, negs = sddmm.sddmm_scores(buf.cuda()[offset:].view(2 * b, d),
                                   rel.cuda(), neg.cuda(), rel_model)
    torch.cuda.synchronize()
    assert sddmm.launches == before + 1
    assert pos.shape == (b, 1) and negs.shape == (b, k)
    torch.testing.assert_close(pos.cpu(), want_pos, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(negs.cpu(), want_neg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("rel_model", K3_MODELS)
@pytest.mark.parametrize("b,k,d", [(64, 64, 128), (5, 3, 16), (7, 9, 300),
                                   (4, 2, 34), (3, 4, 1024)])
def test_k3_kernel_matches_plain_and_gradients_identical(rel_model, b, k, d):
    g = torch.Generator().manual_seed(b + k + d)
    ent = torch.randn((2 * b, d), generator=g)
    rel = torch.randn((b, d), generator=g)
    neg = sampling.sample_negative_indices(torch.Generator().manual_seed(d),
                                           b, k, device="cpu")
    want_pos, want_neg = sddmm.sddmm_scores_plain(ent, rel, neg, rel_model)
    before = sddmm.launches
    e = ent.cuda().requires_grad_()
    r = rel.cuda().requires_grad_()
    pos, negs = sddmm.sddmm_scores(e, r, neg.cuda(), rel_model)
    torch.cuda.synchronize()
    assert sddmm.launches == before + 1
    torch.testing.assert_close(pos.detach().cpu(), want_pos, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(negs.detach().cpu(), want_neg, rtol=1e-5, atol=1e-5)
    before = sddmm.backward_launches
    loss = torch.relu(1 - pos + negs).mean()
    grads = [torch.autograd.grad(loss, (e, r), retain_graph=True)
             for _ in range(2)]
    assert sddmm.backward_launches == before + 2
    e2 = ent.cuda().requires_grad_()
    r2 = rel.cuda().requires_grad_()
    p2, n2 = sddmm.sddmm_scores_plain(e2, r2, neg.cuda(), rel_model)
    assert torch.equal(torch.relu(1 - pos + negs) > 0,
                       torch.relu(1 - p2 + n2) > 0)
    torch.relu(1 - p2 + n2).mean().backward()
    for once, twice, autograd in zip(grads[0], grads[1], (e2.grad, r2.grad)):
        assert torch.equal(once, twice)
        torch.testing.assert_close(once, autograd, rtol=1e-5, atol=1e-6)


def _k3_cotangents(g, b, k):
    """Cotangents of the size a mean margin loss gives, about 1 / (B·K)."""
    scale = 1.0 / (b * max(k, 1))
    return (scale * torch.randn((b, 1), generator=g),
            scale * torch.randn((b, k), generator=g))


@pytest.mark.parametrize("rel_model", K3_MODELS)
@pytest.mark.parametrize("b,k,d,kind,offset", [
    (1, 4, 128, "arbitrary", 0),
    (2, 64, 128, "sampler", 0),
    (23, 64, 128, "sampler", 0),
    (1024, 64, 128, "sampler", 0),
    (23, 7, 128, "arbitrary", 0),    # a hot row: 3 tasks in 7, both sides
    (16, 0, 128, "arbitrary", 0),
    (9, 5, 64, "sampler", 1),        # ent 4 bytes off 16: scalar loads
    (9, 5, 64, "sampler", 2),        # ent 8 bytes off 16: float2 loads
    (5, 3, 300, "sampler", 0),       # 75 chunks: 3 of 4 register chunks used
])
def test_k3_backward_matches_plain(rel_model, b, k, d, kind, offset):
    """The backward kernel against the plain backward on the CPU (the same
    products added in the same order: identical bits) and against autograd
    through the plain formulation (rtol 1e-5, atol 1e-6); two calls give
    the same bits."""
    g = torch.Generator().manual_seed(b + k + d + offset)
    buf = torch.randn(2 * b * d + offset, generator=g)
    ent = buf[offset:].view(2 * b, d)
    rel = torch.randn((b, d), generator=g)
    neg = _k3_indices(g, b, k, kind)
    g_pos, g_neg = _k3_cotangents(g, b, k)
    want = sddmm.sddmm_scores_backward_plain(ent, rel, neg, g_pos, g_neg,
                                             rel_model)
    e = ent.clone().requires_grad_()
    r = rel.clone().requires_grad_()
    auto = torch.autograd.grad(sddmm.sddmm_scores_plain(e, r, neg, rel_model),
                               (e, r), (g_pos, g_neg))
    ent_c = buf.cuda()[offset:].view(2 * b, d).requires_grad_()
    rel_c = rel.cuda().requires_grad_()
    pos, negs = sddmm.sddmm_scores(ent_c, rel_c, neg.cuda(), rel_model)
    before = sddmm.backward_launches
    got = [torch.autograd.grad((pos, negs), (ent_c, rel_c),
                               (g_pos.cuda(), g_neg.cuda()), retain_graph=True)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert sddmm.backward_launches == before + 2
    for once, twice, w, a in zip(got[0], got[1], want, auto):
        assert torch.equal(once, twice)
        assert torch.equal(once.cpu(), w)
        torch.testing.assert_close(once.cpu(), a, rtol=1e-5, atol=1e-6)


def _train_setup(sddmm_pallas, b=8, k=4, seq=8):
    enc = bert.BertConfig.tiny(hidden_dropout=0.0, attention_dropout=0.0)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=3, encoder=enc, sddmm_pallas=sddmm_pallas)
    params = training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"text_tok": torch.from_numpy(rng.integers(1, 128, (b, 2, seq))),
             "text_mask": torch.ones((b, 2, seq)),
             "rels": torch.from_numpy(rng.integers(0, 3, b)),
             "neg_idx": sampling.sample_negative_indices(
                 torch.Generator().manual_seed(1), b, k, device="cpu")}
    return cfg, params, batch


@pytest.mark.parametrize("sddmm_pallas", [True, False])
def test_train_step_on_card_matches_cpu(sddmm_pallas):
    cfg, params, batch = _train_setup(sddmm_pallas)
    loss_c, g_c = training.value_and_grad(params, cfg, batch, dropout_seed=3)
    before = (sddmm.launches, row_gather.launches)
    loss_g, g_g = training.value_and_grad(
        blp.to_device(params, "cuda"), cfg,
        {k: v.cuda() for k, v in batch.items()}, dropout_seed=3)
    assert sddmm.launches == before[0] + int(sddmm_pallas)
    assert row_gather.launches == before[1] + 1     # the word table's backward
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for x, y in zip(checkpoint.tree_leaves(g_g), checkpoint.tree_leaves(g_c)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-6)


def test_make_train_step_defaults_to_cuda():
    cfg, params, batch = _train_setup(True)
    del batch["neg_idx"]
    opt = training.make_optimizer(1e-3, 10)
    params = blp.to_device(params, "cuda")
    state = opt.init(params)
    step = training.make_train_step(cfg, opt, batch_size=8, num_negatives=4)
    before = sddmm.launches
    params, state, loss = step(params, state, (0, 0),
                               {k: v.cuda() for k, v in batch.items()})
    assert loss.is_cuda and loss.dim() == 0 and torch.isfinite(loss)
    assert sddmm.launches == before + 1
    assert int(state[0][0]) == 1


def test_remat_gradients_equal_on_card_with_dropout():
    enc = bert.BertConfig.tiny(num_layers=3, compute_dtype=torch.bfloat16)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=3, encoder=enc, sddmm_pallas=True)
    _, params, batch = _train_setup(True)
    params = blp.to_device(training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")), "cuda")
    batch = {k: v.cuda() for k, v in batch.items()}
    results = []
    for remat in (False, 2):
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, remat=remat))
        results.append(training.value_and_grad(params, c, batch, dropout_seed=5))
    assert torch.equal(results[0][0], results[1][0])
    for x, y in zip(checkpoint.tree_leaves(results[0][1]),
                    checkpoint.tree_leaves(results[1][1])):
        assert torch.equal(x, y)


def test_k3_width_limits_equal_the_kernels():
    from blp_tpu_torch.ops import _cuda

    lib = _cuda.load("sddmm")
    for v in (1, 2, 4):
        assert lib.sddmm_max_units(v) == sddmm.max_units(v)


@pytest.mark.parametrize("d,offset,rel_model,limit", [
    (257, 0, "transe", 256), (514, 0, "distmult", 512),
    (516, 1, "transe", 256), (1028, 2, "transe", 512),
])
def test_k3_too_wide_raises_value_error_on_card(d, offset, rel_model, limit):
    """Widths the launch would refuse raise the named ValueError before
    any launch, forward and backward (not a CUDA error)."""
    b, k = 2, 3
    buf = torch.randn(2 * b * d + offset, device="cuda")
    ent = buf[offset:].view(2 * b, d)
    rel = torch.randn((b, d), device="cuda")
    neg = sampling.sample_negative_indices(torch.Generator().manual_seed(0),
                                           b, k, device="cpu").cuda()
    before = sddmm.launches
    with pytest.raises(ValueError, match=f"at most {limit} units"):
        sddmm.sddmm_scores(ent, rel, neg, rel_model)
    with pytest.raises(ValueError, match=f"at most {limit} units"):
        sddmm._sddmm_backward_kernel(ent, rel, neg, torch.ones((b, 1), device="cuda"),
                                     torch.ones((b, k), device="cuda"), rel_model)
    assert sddmm.launches == before


@pytest.mark.parametrize("model", ["bert-bow", "bert-dkrl", "glove-bow", "glove-dkrl"])
def test_word_model_train_pass_on_card_matches_cpu(model):
    """The word models' training pass with K3 on the card against the same
    pass on the CPU (fp32, the same injected negatives): loss within rtol
    1e-5, gradients within rtol 1e-4, atol 1e-6."""
    cfg = blp.ModelConfig(model=model, rel_model="transe", dim=16, num_relations=3,
                          emb_dim=300 if model.startswith("glove") else 768,
                          vocab_size=200, regularizer=1e-2, sddmm_pallas=True)
    params = blp.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    b, k, seq = 8, 4, 16
    lens = rng.integers(1, seq + 1, (b, 2))
    mask = (np.arange(seq) < lens[..., None]).astype(np.float32)
    batch = {"text_tok": torch.from_numpy(rng.integers(1, 200, (b, 2, seq)) * mask.astype(np.int64)),
             "text_mask": torch.from_numpy(mask),
             "rels": torch.from_numpy(rng.integers(0, 3, b)),
             "neg_idx": sampling.sample_negative_indices(
                 torch.Generator().manual_seed(1), b, k, device="cpu")}
    loss_c, g_c = training.value_and_grad(params, cfg, batch, dropout_seed=0)
    before = (sddmm.launches, sddmm.backward_launches, row_gather.launches)
    loss_g, g_g = training.value_and_grad(
        blp.to_device(params, "cuda"), cfg,
        {k_: v.cuda() for k_, v in batch.items()}, dropout_seed=0)
    torch.cuda.synchronize()
    assert (sddmm.launches, sddmm.backward_launches, row_gather.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    torch.testing.assert_close(loss_g.cpu(), loss_c, rtol=1e-5, atol=0)
    for x, y in zip(checkpoint.tree_leaves(g_g), checkpoint.tree_leaves(g_c)):
        torch.testing.assert_close(x.cpu(), y, rtol=1e-4, atol=1e-6)


# -- the multi-device paths: 2 gloo ranks sharing the card ----------------------

def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(_numpy_tree(v) for v in tree)
    return tree.cpu().numpy()


@pytest.mark.parametrize("remat", ["dots", "names"])
def test_remat_policies_equal_on_card_with_dropout(remat):
    enc = bert.BertConfig.tiny(num_layers=3, compute_dtype=torch.bfloat16)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=3, encoder=enc, sddmm_pallas=True)
    _, _, batch = _train_setup(True)
    params = blp.to_device(training.unstack_params(blp.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu")), "cuda")
    batch = {k: v.cuda() for k, v in batch.items()}
    results = []
    for r in (False, remat):
        c = dataclasses.replace(cfg, encoder=dataclasses.replace(enc, remat=r))
        results.append(training.value_and_grad(params, c, batch, dropout_seed=5))
    assert torch.equal(results[0][0], results[1][0])
    for x, y in zip(checkpoint.tree_leaves(results[0][1]),
                    checkpoint.tree_leaves(results[1][1])):
        assert torch.equal(x, y)


def _mesh_setup():
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=3, sddmm_pallas=True,
                          encoder=bert.BertConfig.tiny(num_layers=4))
    params = blp.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    b = 16
    batch = {"text_tok": rng.integers(1, 128, (b, 2, 16)).astype(np.int32),
             "text_mask": np.ones((b, 2, 16), np.float32),
             "rels": rng.integers(0, 3, b).astype(np.int32)}
    neg = sampling.sample_negative_indices(torch.Generator().manual_seed(1), b,
                                           8, "cpu").numpy()
    return cfg, params, batch, neg


def test_parallel_and_pipeline_grads_on_card_two_ranks(tmp_path):
    """DP 2 x 1, TP 1 x 2 and PP 1 x 2 (2 microbatches) on two ranks sharing
    the card: loss within rtol 1e-5 and gradients within rtol 2e-5, atol
    2e-6 of one process on the card (dropout on; the ranks draw their slices
    of the one-device masks; K3 scores the global batch)."""
    import torch_dist_workers as workers

    cfg, params, batch, neg = _mesh_setup()
    live = blp.to_device(training.unstack_params(params), "cuda")
    tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    tb["neg_idx"] = torch.from_numpy(neg).cuda()
    loss, grads = training.value_and_grad(live, cfg, tb, dropout_seed=3)
    want = workers.numpy_tree(training.restack_params(grads))
    tree = _numpy_tree(params)
    common = dict(cfg=cfg, params=tree, batch=batch, neg=neg, device="cuda:0")
    dp_tp = workers.run_world(workers.parallel_steps, 2, tmp_path,
                              [dict(common, mesh=(2, 1)), dict(common, mesh=(1, 2))],
                              device="cuda:0")
    pp = workers.run_world(workers.pipeline_runs, 2, tmp_path,
                           [dict(common, mesh=(1, 2), micro=2, dropout_seed=3)],
                           device="cuda:0")
    # parallel_steps' injected-negatives case runs at dropout seed 0
    loss0, grads0 = training.value_and_grad(live, cfg, tb, dropout_seed=0)
    want0 = workers.numpy_tree(training.restack_params(grads0))
    for got, w, l in [(r[0], want0, loss0) for r in dp_tp] + \
                     [(r[1], want0, loss0) for r in dp_tp] + \
                     [(r[0], want, loss) for r in pp]:
        assert np.isclose(got["loss"], float(l), rtol=1e-5)
        for g, x in zip(got["grads"], w):
            np.testing.assert_allclose(g, x, rtol=2e-5, atol=2e-6)


def test_sharded_eval_on_card_two_ranks_takes_tma(tmp_path):
    """The candidate-sharded evaluation on two ranks sharing the card: the
    same metrics as one process, bit for bit, with every K1 launch on its
    "tma" variant (each rank's block is an allocation of its own)."""
    import torch_dist_workers as workers
    from blp_tpu_torch.data.datasets import GraphData, TextGraphData
    from blp_tpu_torch.data.synth import write_synth_dataset
    from blp_tpu_torch.data.tokenizers import WordPieceTokenizer

    d = write_synth_dataset(str(tmp_path / "synth"), num_entities=300,
                            num_relations=4, num_triples=900, seed=2)
    train = TextGraphData.load(f"{d}/ind-train.tsv", max_len=16,
                               tokenizer=WordPieceTokenizer(f"{d}/vocab.txt"),
                               write_maps=True)
    dev = GraphData.load(f"{d}/ind-dev.tsv")
    test = GraphData.load(f"{d}/ind-test.tsv")
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=len(train.rel_ids),
                          encoder=bert.BertConfig.tiny(vocab_size=30000))
    params = blp.init_params(cfg, torch.Generator().manual_seed(4), device="cpu")
    kw = dict(batch_size=8, emb_batch_size=64, tile=256)
    ranks = workers.run_world(
        workers.mesh_evals, 2, tmp_path, d,
        [((2, 1), cfg, _numpy_tree(params), dict(kw, device="cuda:0"))],
        device="cuda:0")
    entities = np.unique(np.concatenate([train.entities, dev.entities]))
    one = evaluation.eval_link_prediction(
        blp.to_device(params, "cuda"), cfg, dev.triples, train, entities,
        filter_index=FilterIndex(np.concatenate([train.triples, dev.triples,
                                                 test.triples])),
        ent_emb=torch.from_numpy(ranks[0][0]["table"]).cuda(), device="cuda",
        **kw)
    for r in ranks:
        assert r[0]["scalars"] == one.scalars("x")
        assert r[0]["k1_by_variant"] and all(
            v == "tma" for v, _ in r[0]["k1_by_variant"])


def test_prefetched_entity_table_bit_equal_to_inline_on_card(tmp_path):
    """Phase 1 with the prefetch thread (pinned, non-blocking copies on the
    caller's stream) gives the table of the same chunks encoded in line, bit
    for bit, through K2 in bf16; also on a side stream of the caller's."""
    from blp_tpu_torch.data.datasets import TextGraphData
    from blp_tpu_torch.data.synth import write_synth_dataset
    from blp_tpu_torch.data.tokenizers import WordPieceTokenizer

    d = write_synth_dataset(str(tmp_path / "synth"), num_entities=300,
                            num_relations=4, num_triples=600, seed=6)
    data = TextGraphData.load(f"{d}/ind-train.tsv", max_len=32,
                              tokenizer=WordPieceTokenizer(f"{d}/vocab.txt"),
                              write_maps=True)
    enc_cfg = bert.BertConfig.tiny(hidden_size=64, num_heads=4,
                                   intermediate_size=128, vocab_size=30000,
                                   compute_dtype=torch.bfloat16,
                                   fused_attention=True)
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=16,
                          num_relations=3, encoder=enc_cfg)
    params = blp.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cuda")
    enc = blp.encode_view(params, cfg)

    def encode_batch(tok, mask):
        return blp.encode(enc, cfg, tok, mask, device="cuda")

    ents = np.arange(len(data.ent_ids))
    inline = []
    for start in range(0, len(ents), 64):
        ids = ents[start:start + 64]
        tok, mask = data.get_entity_descriptions(ids)
        pad = 64 - len(ids)
        tok, mask = np.pad(tok, ((0, pad), (0, 0))), np.pad(mask, ((0, pad), (0, 0)))
        mask[len(ids):, 0] = 1.0
        inline.append(encode_batch(tok, mask)[:len(ids)])
    inline = torch.cat(inline)
    before = packed_attention.launches
    table = evaluation.build_entity_table(
        encode_batch, data, ents, emb_batch_size=64, dim=16, device="cuda",
        chunk_multiple=4)
    assert packed_attention.launches > before
    assert torch.equal(table[:len(ents)], inline)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        on_side = evaluation.build_entity_table(
            encode_batch, data, ents, emb_batch_size=64, dim=16,
            device="cuda", chunk_multiple=4)
    side.synchronize()
    assert torch.equal(on_side, table)


def test_device_memory_stats_reads_the_allocator():
    from blp_tpu_torch import profiling

    torch.cuda.reset_peak_memory_stats()
    x = torch.empty((1 << 20,), device="cuda")
    stats = profiling.device_memory_stats()
    assert len(stats) == torch.cuda.device_count()
    s0 = stats[0]
    assert s0["device"] == "cuda:0"
    assert s0["allocated_bytes.all.peak"] == torch.cuda.max_memory_allocated()
    assert s0["allocated_bytes.all.current"] >= x.numel() * 4
    assert 0 < s0["free_bytes"] <= s0["total_bytes"]
    (one,) = profiling.device_memory_stats("cuda:0")
    assert one["device"] == "cuda:0" and set(one) == set(s0)


def test_rank_bench_on_the_card_counts_as_the_plain_stream():
    """The rank_bench tool at 262,144 candidates (B 64, d 128): K1's counts
    and the plain stream's differ nowhere by more than the candidates
    within the fp32 rounding band of the pivot (the two add in other
    orders, so near-ties may land on either side)."""
    from blp_tpu_torch.tools import rank_bench

    before = transe_rank.launches
    res = rank_bench.main(["--n", "262144", "--reps", "1"])
    assert res["beyond_rounding_band"] == 0 and res["n"] == 262144
    assert transe_rank.launches - before == 2
    assert res["device"] == torch.cuda.get_device_name(0)


def test_serving_bench_top10_on_the_card_equals_the_cpu():
    """The serving_bench tool's server at 100,000 candidates: the same top-10
    ids on the card as on the CPU, scores within 1e-4, for batches 1, 8 and
    64."""
    from blp_tpu_torch.tools import serving_bench

    args = serving_bench.parse_args(["--n", "100000"])
    table, queries = serving_bench.draw_inputs(args.n, args.d, args.batches)
    answers = []
    for device in ("cuda", "cpu"):
        srv = serving_bench.make_server(args, None, device)
        srv.set_candidates(table, np.arange(args.n))
        answers.append([srv.predict_tails(head_emb=emb, rels=rels, k=args.k)
                        for _, emb, rels in queries])
    for (s_gpu, i_gpu), (s_cpu, i_cpu) in zip(*answers):
        np.testing.assert_array_equal(i_gpu, i_cpu)
        np.testing.assert_allclose(s_gpu, s_cpu, rtol=1e-4, atol=1e-4)


DT = {"bf16": torch.bfloat16, "f32": torch.float32}


def _within_ulp(got, want, atol=0.0, ulps=1):
    w = want.float()
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - 8)
    return bool(((got.float() - w).abs() <= ulps * ulp + atol).all())


def _close(got, want, rows_summed=False, ulps=1):
    top = want.float().abs().max().item() if want.numel() else 0.0
    if got.dtype == torch.bfloat16:
        return _within_ulp(got, want, 1e-5 * top if rows_summed else 0.0, ulps)
    return torch.allclose(got, want, rtol=1e-5, atol=1e-5 * top)


def _sum_close(got, want):
    return torch.allclose(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


def _f1_case(act, h_dt, out_dt, rows, w, bias=True, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = (2.5 * torch.randn((rows, w), generator=g, device="cuda")).to(DT[h_dt])
    b = 0.5 * torch.randn(w, generator=g, device="cuda") if bias else None
    gy = torch.randn((rows, w), generator=g, device="cuda").to(DT[out_dt])
    out = []
    for fn in (fused_layer.bias_act, fused_layer.bias_act_plain):
        hh = h.detach().requires_grad_()
        bb = None if b is None else b.detach().requires_grad_()
        y = fn(hh, bb, act, DT[out_dt])
        out.append((y, *torch.autograd.grad(y, [t for t in (hh, bb) if t is not None], gy)))
    return out


@pytest.mark.parametrize("w", [32, 64, 768, 3072])
@pytest.mark.parametrize("h_dt,out_dt", [("bf16", "bf16"), ("f32", "f32"),
                                         ("f32", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("act", ["none", "erf", "poly"])
def test_f1_kernel_matches_plain(act, h_dt, out_dt, w):
    """997 rows (no multiple of a block or a row chunk)."""
    before = (fused_layer.bias_act_launches, fused_layer.bias_act_backward_launches)
    (y, dh, db), (y_p, dh_p, db_p) = _f1_case(act, h_dt, out_dt, 997, w)
    assert (fused_layer.bias_act_launches, fused_layer.bias_act_backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == DT[out_dt] and dh.dtype == DT[h_dt] and db.dtype == torch.float32
    assert _close(y, y_p) and _close(dh, dh_p) and _sum_close(db, db_p)


@pytest.mark.parametrize("rows,w,act", [(1, 768, "poly"), (37, 3072, "erf"),
                                        (20_000, 3072, "poly"), (131_072, 768, "none")])
def test_f1_kernel_matches_plain_at_other_row_counts(rows, w, act):
    (y, dh, db), (y_p, dh_p, db_p) = _f1_case(act, "bf16", "bf16", rows, w, seed=1)
    assert _close(y, y_p) and _close(dh, dh_p) and _sum_close(db, db_p)


@pytest.mark.parametrize("act", ["none", "erf", "poly"])
def test_f1_kernel_without_bias_matches_plain(act):
    """No bias, no db."""
    (y, dh), (y_p, dh_p) = _f1_case(act, "bf16", "bf16", 997, 3072, bias=False)
    assert _close(y, y_p) and _close(dh, dh_p)


@pytest.mark.parametrize("with_db", [True, False])
def test_f1_none_backward_returns_g(with_db):
    """"none" with h in g's dtype: dh is g itself; the kernel runs only to
    sum db, and not at all without it."""
    g = torch.Generator(device="cuda").manual_seed(4)
    gy = torch.randn((997, 768), generator=g, device="cuda").to(torch.bfloat16)
    before = fused_layer.bias_act_backward_launches
    dh, db = fused_layer._bias_act_backward_kernel(gy, None, None, "none",
                                                    torch.bfloat16, with_db)
    assert dh is gy
    assert fused_layer.bias_act_backward_launches == before + int(with_db)
    if with_db:
        assert _sum_close(db, gy.float().sum(0))
    else:
        assert db is None


def _f1_heads_case(B, S, nh, hd, cotangent, seed=0, calls=1):
    """F1 head-major ("none", bf16, the q/k/v projection's) and its plain
    version: [y, dh, db] per call of the Function (calls backward passes),
    and the plain version's. cotangent "k": g held as (B, nh, hd, S), as
    q k^T's backward leaves k's."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn((B, S, nh * hd), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(nh * hd, generator=g, device="cuda")
    if cotangent == "k":
        gy = torch.randn((B, nh, hd, S), generator=g, device="cuda").to(
            torch.bfloat16).transpose(-1, -2)
    else:
        gy = torch.randn((B, nh, S, hd), generator=g, device="cuda").to(torch.bfloat16)
    out = []
    for fn in (fused_layer.bias_act, fused_layer.bias_act_plain):
        hh, bb = h.detach().requires_grad_(), b.detach().requires_grad_()
        y = fn(hh, bb, "none", torch.bfloat16, head_dim=hd)
        out.append([y, *(g_ for _ in range(calls) for g_ in
                         torch.autograd.grad(y, (hh, bb), gy, retain_graph=True))])
    return out


#: (B, S, heads, head width): 997 rows either way, 1 row, 20,000 rows, and
#: the W5M train step's 1,024 packed rows of 128.
F1_HEAD_SHAPES = [(1, 997, 12, 64), (997, 1, 12, 64), (1, 1, 12, 64),
                  (250, 80, 12, 64), (1024, 128, 12, 64), (4, 24, 3, 8)]


@pytest.mark.parametrize("cotangent", ["contiguous", "k"])
@pytest.mark.parametrize("shape", F1_HEAD_SHAPES)
def test_f1_head_major_matches_plain(shape, cotangent):
    """y (B, nh, S, hd) and dh bit-equal to the plain version's, db within
    rtol 1e-4; one forward and one backward launch, no copy of g in
    between (k's layout read as it is when S is a multiple of 8)."""
    B, S, nh, hd = shape
    before = dict(fused_layer.launches_by_variant)
    (y, dh, db), (y_p, dh_p, db_p) = _f1_heads_case(B, S, nh, hd, cotangent)
    assert y.shape == (B, nh, S, hd) and y.is_contiguous()
    assert torch.equal(y, y_p) and torch.equal(dh, dh_p) and _sum_close(db, db_p)
    layout = "heads_t" if cotangent == "k" and S % 8 == 0 else "heads"
    added = {k: v - before.get(k, 0) for k, v in fused_layer.launches_by_variant.items()
             if v != before.get(k, 0)}
    assert added == {("bias_act", "none bf16->bf16 heads"): 1,
                     ("bias_act backward", f"none bf16->bf16 {layout}"): 1}


@pytest.mark.parametrize("cotangent", ["contiguous", "k", "rows"])
def test_f1_db_identical_across_calls(cotangent):
    """The one-launch db (ticket counter, partials added by the last block)
    gives the same bits on every call."""
    if cotangent == "rows":
        first, again = (_f1_case("none", "bf16", "bf16", 131_072, 768, seed=5)[0]
                        for _ in range(2))
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        return
    got, _ = _f1_heads_case(1024, 128, 12, 64, cotangent, seed=5, calls=2)
    assert torch.equal(got[1], got[3]) and torch.equal(got[2], got[4])


@pytest.mark.parametrize("shape", [(1024, 128, 12, 64), (4, 24, 3, 8)])
def test_f1_head_major_db_does_not_depend_on_the_cotangent_layout(shape):
    """The same cotangent, contiguous or held as (B, nh, hd, S) (the layouts
    q k^T's backward and a "names" remat tag may hand over), gives the same
    dh and db bits: a row lane adds its rows in the same order either way."""
    B, S, nh, hd = shape
    g = torch.Generator(device="cuda").manual_seed(7)
    gy = torch.randn((B, nh, S, hd), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn(nh * hd, generator=g, device="cuda")
    strided = gy.transpose(-1, -2).contiguous().transpose(-1, -2)
    assert fused_layer._g_layout(strided, hd)[0] == "heads_t"
    got = [fused_layer._bias_act_backward_kernel(t, None, b, "none", torch.bfloat16,
                                                 True, head_dim=hd)
           for t in (gy, strided)]
    assert torch.equal(got[0][0], got[1][0]) and torch.equal(got[0][1], got[1][1])


@pytest.mark.parametrize("act", ["erf", "poly"])
@pytest.mark.parametrize("rows", [997, 131_072])
def test_f1_db_same_bits_when_a_remat_policy_splits_the_chain(act, rows):
    """The "names" policy runs ffn_in's F1 as "none" with the bias, then the
    activation without it: its db (the "none" backward of the activation's
    dh) has the same bits as the fused call's."""
    bf = torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(8)
    h = (2.5 * torch.randn((rows, 3072), generator=g, device="cuda")).to(bf)
    b = 0.5 * torch.randn(3072, generator=g, device="cuda")
    gy = torch.randn((rows, 3072), generator=g, device="cuda").to(bf)
    kern = fused_layer._bias_act_backward_kernel
    dh, db = kern(gy, h, b, act, bf, True)
    pre = fused_layer.bias_act(h, b, "none", bf)
    dpre, _ = kern(gy, pre, None, act, bf, False)
    dh2, db2 = kern(dpre, None, b, "none", bf, True)
    assert torch.equal(dh, dpre) and dh2 is dpre and torch.equal(db, db2)


def test_f1_back_to_back_row_counts_each_give_their_own():
    """Backward calls of different row counts and widths queued one after
    another, without a synchronisation, give what each gives alone: each
    launch leaves its column tiles' tickets at 0 for the next."""
    cases = [(997, 768, "none"), (20_000, 3072, "poly"), (1, 768, "none"),
             (131_072, 768, "none"), (37, 3072, "erf")]
    g = torch.Generator(device="cuda").manual_seed(6)
    ins = [((2.5 * torch.randn((r, w), generator=g, device="cuda")).to(torch.bfloat16),
            torch.randn(w, generator=g, device="cuda"),
            torch.randn((r, w), generator=g, device="cuda").to(torch.bfloat16), act)
           for r, w, act in cases]
    alone = []
    for h, b, gy, act in ins:
        alone.append(fused_layer._bias_act_backward_kernel(gy, h, b, act,
                                                           torch.bfloat16, True))
        torch.cuda.synchronize()
    queued = [fused_layer._bias_act_backward_kernel(gy, h, b, act, torch.bfloat16, True)
              for h, b, gy, act in ins]
    torch.cuda.synchronize()
    for (dh_a, db_a), (dh_q, db_q) in zip(alone, queued):
        assert torch.equal(dh_a, dh_q) and torch.equal(db_a, db_q)
    assert all(int(t.abs().sum()) == 0 for (kind, *_), t in fused_layer._tickets.items()
               if kind == "f1")


def test_f1_backward_refuses_a_ticket_buffer_too_short_for_its_tiles():
    """F1's backward takes a ticket a 64-column tile from a buffer passed
    with its length: one too short is refused before the launch, not
    overrun."""
    rows, w, bf = 256, 768, torch.bfloat16
    g = torch.randn((rows, w), device="cuda").to(bf)
    partial, db = torch.empty((1, w), device="cuda"), torch.zeros(w, device="cuda")
    tickets = torch.zeros(w // fused_layer.F1_TILE_COLS, dtype=torch.int32,
                          device="cuda")
    entry = fused_layer._bound("bias_act_backward")

    def call(n_tickets):
        return entry(g.data_ptr(), None, None, None, partial.data_ptr(), db.data_ptr(),
                     tickets.data_ptr(), rows, w, fused_layer._dtype_id(bf, "h"),
                     fused_layer._dtype_id(bf, "g"), fused_layer.ACTS["none"], rows, 1,
                     fused_layer.G_LAYOUTS["rows"], 0, 0, n_tickets,
                     fused_layer._stream(g.device))

    assert call(tickets.numel() - 1) != 0
    torch.cuda.synchronize()
    assert int(db.abs().sum()) == 0 and int(tickets.abs().sum()) == 0
    assert call(tickets.numel()) == 0
    torch.cuda.synchronize()
    assert _sum_close(db, g.float().sum(0)) and int(tickets.abs().sum()) == 0


def test_f1_head_major_refuses_a_head_width_not_a_multiple_of_8():
    h = torch.zeros((2, 4, 36), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_layer.bias_act(h, None, "none", torch.bfloat16, head_dim=12)
    with pytest.raises(ValueError, match="act 'none'"):
        fused_layer.bias_act(torch.zeros((2, 4, 64), dtype=torch.bfloat16,
                                         device="cuda"), None, "poly",
                             torch.bfloat16, head_dim=16)
    g = torch.zeros((2, 3, 4, 12), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_layer._bias_act_backward_kernel(g, None, None, "none", torch.bfloat16,
                                              True, head_dim=12)


def _f2_case(with_r, x_dt, out_dt, rows, w, seed=0, calls=1):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.0 + torch.randn((rows, w), generator=g, device="cuda")).to(DT[x_dt])
    r = (0.5 * torch.randn((rows, w), generator=g, device="cuda")).to(DT[x_dt])
    scale = 1.0 + 0.1 * torch.randn(w, generator=g, device="cuda")
    bias = 0.1 * torch.randn(w, generator=g, device="cuda")
    gy = torch.randn((rows, w), generator=g, device="cuda").to(DT[out_dt])
    out = []
    for fn in (fused_layer.add_layer_norm, fused_layer.add_layer_norm_plain):
        ins = [t.detach().requires_grad_() for t in (x, r, scale, bias)]
        if not with_r:
            del ins[1]
        y = fn(ins[0], ins[1] if with_r else None, ins[-2], ins[-1], 1e-12, DT[out_dt])
        out.append([y, *(g_ for _ in range(calls) for g_ in
                         torch.autograd.grad(y, ins, gy, retain_graph=True))])
    return out


@pytest.mark.parametrize("w", [32, 64, 512, 768, 1024, 2048, 3072, 4096])
@pytest.mark.parametrize("x_dt,out_dt", [("bf16", "bf16"), ("f32", "f32"),
                                         ("f32", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("with_r", [True, False])
def test_f2_kernel_matches_plain(with_r, x_dt, out_dt, w):
    before = (fused_layer.add_layer_norm_launches,
              fused_layer.add_layer_norm_backward_launches)
    got, want = _f2_case(with_r, x_dt, out_dt, 997, w)
    assert (fused_layer.add_layer_norm_launches,
            fused_layer.add_layer_norm_backward_launches) == (before[0] + 1, before[1] + 1)
    assert got[0].dtype == DT[out_dt]
    assert _close(got[0], want[0], rows_summed=True)
    for a, b in zip(got[1:-2], want[1:-2]):        # dx (and dr)
        assert a.dtype == DT[x_dt] and _close(a, b, rows_summed=True)
    assert _sum_close(got[-2], want[-2]) and _sum_close(got[-1], want[-1])


def test_f2_kernel_with_mixed_dtypes_matches_plain():
    """x bf16 + r f32 (mixed_precision_train off): the sum in f32."""
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((997, 768), generator=g, device="cuda").to(torch.bfloat16)
    r = torch.randn((997, 768), generator=g, device="cuda")
    scale, bias = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
    gy = torch.randn((997, 768), generator=g, device="cuda").to(torch.bfloat16)
    res = []
    for fn in (fused_layer.add_layer_norm, fused_layer.add_layer_norm_plain):
        xx, rr = x.detach().requires_grad_(), r.detach().requires_grad_()
        y = fn(xx, rr, scale, bias, 1e-12, torch.bfloat16)
        res.append((y, *torch.autograd.grad(y, (xx, rr), gy)))
    for a, b in zip(*res):
        assert a.dtype == b.dtype and _close(a, b, rows_summed=True)


def test_fused_reductions_identical_across_calls():
    """db, dscale and dbias (and the row gradients) are the same bits on
    every call: fixed row chunks, no atomics."""
    first, again = (_f1_case("poly", "bf16", "bf16", 50_000, 3072, seed=2)[0]
                    for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    got, _ = _f2_case(True, "bf16", "bf16", 50_000, 768, seed=2, calls=2)
    first, second = got[1:5], got[5:]
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_layer_refuses_what_its_kernels_do_not_take():
    buf = torch.zeros(64 * 32 + 1, dtype=torch.bfloat16, device="cuda")
    off = buf[1:].view(64, 32)                  # 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_layer.bias_act(off, None, "poly", torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fused_layer.add_layer_norm(off, None, torch.ones(32, device="cuda"),
                                   torch.zeros(32, device="cuda"), 1e-12, None)
    with pytest.raises(ValueError, match="multiple of 8"):
        fused_layer.bias_act(torch.zeros(4, 12, device="cuda"), None, "none")
    with pytest.raises(ValueError, match="above 4096"):
        fused_layer.add_layer_norm(torch.zeros(4, 4104, device="cuda"), None,
                                   torch.ones(4104, device="cuda"),
                                   torch.zeros(4104, device="cuda"), 1e-12, None)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_layer.bias_act(torch.zeros(4, 16, device="cuda", dtype=torch.float16),
                             None, "none")


def _layer_saved_bytes(device):
    """Bytes of the distinct storages one BERT-base-width bf16 training
    layer saves at 4 x 128 tokens (weights and their casts left out), as
    tests/test_torch_fused_layer.py counts them on the CPU."""
    H, I, B, S = 768, 3072, 4, 128
    cfg = bert.BertConfig(num_layers=1, compute_dtype=torch.bfloat16,
                          fast_train=True, dropout_bits=8)
    params = bert.unstack_layers(bert.init_bert_params(
        cfg, torch.Generator().manual_seed(0)))
    lp = {k: v.to(device).requires_grad_() for k, v in params["layers"][0].items()}
    x = torch.randn((B, S, H), generator=torch.Generator().manual_seed(5)).to(
        device, torch.bfloat16).requires_grad_()
    storages = {}

    def pack(t):
        if tuple(t.shape) not in {(H, H), (H, I), (I, H)}:
            storages[t.untyped_storage().data_ptr()] = (
                t.untyped_storage().nbytes(), t.dtype, tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        bert._encoder_layer(cfg, x, torch.zeros(B, 1, 1, S, device=device), lp,
                            seeds=(1, 2, 3), rate=0.1)
    return sorted(storages.values(), key=str)


def test_w5m_layer_saves_on_the_card_what_it_saves_on_the_cpu():
    card, cpu = _layer_saved_bytes("cuda"), _layer_saved_bytes("cpu")
    assert card == cpu
    assert sum(n for n, _, _ in card) / 512 <= 32e3


def test_f2_backward_matches_plain_at_the_w5m_shape():
    """The W5M train step's 131,072 rows x 768: ds, dscale and dbias against
    the plain LayerNorm's VJP."""
    got, want = _f2_case(True, "bf16", "bf16", 131_072, 768, seed=5)
    for a, b in zip(got[1:3], want[1:3]):
        assert _close(a, b, rows_summed=True)
    assert _sum_close(got[-2], want[-2]) and _sum_close(got[-1], want[-1])


def _f3_inputs(b, nh, sq, sk, l_dt, out_dt, seg=None, seed=0):
    """Logits, the layer's bias (packed: block-diagonal over segments of
    `seg`, (b, 1, sq, sk); else (b, 1, 1, sk)) over a key mask with row 0's
    keys all masked, and a cotangent."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    l = (4.0 * torch.randn((b, nh, sq, sk), generator=g, device="cuda")).to(DT[l_dt])
    keys = torch.rand((b, sk), generator=g, device="cuda") > 0.25
    keys[0] = False
    if seg is None:
        bias = ((~keys).float() * -10000.0)[:, None, None, :]
    else:
        iq = torch.arange(sq, device="cuda") // seg
        ik = torch.arange(sk, device="cuda") // seg
        bias = torch.where((iq[:, None] == ik[None, :])[None] & keys[:, None, :],
                           0.0, -10000.0)[:, None]
    gy = torch.randn((b, nh, sq, sk), generator=g, device="cuda").to(DT[out_dt])
    return l, bias, gy


def _f3_case(l, bias, gy, out_dt, round_logits=False, dropout=None, calls=1):
    """[y, dl...] of the kernel and of the plain chain (dl calls times for
    the kernel; no dl for round_logits)."""
    out = []
    for fn, n in ((attn_softmax.attn_softmax, calls), (attn_softmax.attn_softmax_plain, 1)):
        ll = l.detach().requires_grad_(not round_logits)
        with torch.set_grad_enabled(not round_logits):
            y = fn(ll, bias, 8.0, DT[out_dt], round_logits, dropout)
        grads = [] if round_logits else [
            torch.autograd.grad(y, ll, gy, retain_graph=True)[0] for _ in range(n)]
        out.append([y.detach(), *grads])
    return out


@pytest.mark.parametrize("seg", [None, 16])
@pytest.mark.parametrize("nbits", [8, 16, 32, None])
@pytest.mark.parametrize("l_dt,out_dt", [("bf16", "bf16"), ("bf16", "f32"),
                                         ("f32", "f32")])
def test_f3_kernel_matches_plain(l_dt, out_dt, nbits, seg):
    before = (attn_softmax.launches, attn_softmax.backward_launches)
    l, bias, gy = _f3_inputs(5, 3, 128, 128, l_dt, out_dt, seg, seed=1)
    drop = None if nbits is None else (11, 0.1, nbits, None)
    (y, dl), (y_p, dl_p) = _f3_case(l, bias, gy, out_dt, dropout=drop)
    assert (attn_softmax.launches, attn_softmax.backward_launches) == (
        before[0] + 1, before[1] + 1)
    assert y.dtype == DT[out_dt] and dl.dtype == DT[l_dt]
    assert _close(y, y_p, rows_summed=True, ulps=1 if drop is None else 2)
    assert _close(dl, dl_p, rows_summed=True)
    assert torch.isfinite(y[0]).all() and torch.isfinite(dl[0]).all()


@pytest.mark.parametrize("sk", [1, 7, 33, 64, 100, 200, 512, 777, 1024])
def test_f3_kernel_matches_plain_at_every_row_length(sk):
    """Each register count a lane (1 to 32 keys) and ragged rows, with the
    queries fewer than the keys."""
    l, bias, gy = _f3_inputs(3, 2, 5, sk, "bf16", "bf16", seed=2)
    (y, dl), (y_p, dl_p) = _f3_case(l, bias, gy, "bf16", dropout=(3, 0.1, 8, None))
    assert _close(y, y_p, rows_summed=True, ulps=2) and _close(dl, dl_p, rows_summed=True)
    (y,), (y_p,) = _f3_case(l, bias, gy, "bf16", round_logits=True)
    assert _close(y, y_p, rows_summed=True)


@pytest.mark.parametrize("seg", [None, 32])
def test_f3_inference_variant_matches_plain(seg):
    l, bias, gy = _f3_inputs(9, 12, 128, 128, "bf16", "bf16", seg, seed=3)
    (y,), (y_p,) = _f3_case(l, bias, gy, "bf16", round_logits=True)
    assert y.dtype == torch.bfloat16 and _close(y, y_p, rows_summed=True)


def test_f3_in_a_dropout_block_matches_plain():
    """A rank's block of the one-device site (rows 2-4, heads 4-7 of 12)."""
    l, bias, gy = _f3_inputs(3, 4, 64, 64, "bf16", "bf16", 32, seed=4)
    block = ((8, 12, 64, 64), (2, 4, 0, 0))
    (y, dl), (y_p, dl_p) = _f3_case(l, bias, gy, "bf16", dropout=(5, 0.1, 8, block))
    assert _close(y, y_p, rows_summed=True, ulps=2) and _close(dl, dl_p, rows_summed=True)


def test_f3_matches_plain_at_the_w5m_shapes():
    """The training variant at the W5M train step's 1,024 packed rows (two
    64-token segments, 8-bit masks), identical across two backward calls;
    the inference variant at the W5M encode chunk's 6,144 rows."""
    l, bias, gy = _f3_inputs(1024, 12, 128, 128, "bf16", "bf16", 64, seed=5)
    (y, dl, dl2), (y_p, dl_p) = _f3_case(l, bias, gy, "bf16",
                                         dropout=(6, 0.1, 8, None), calls=2)
    assert torch.equal(dl, dl2)
    assert _close(y, y_p, rows_summed=True, ulps=2) and _close(dl, dl_p, rows_summed=True)
    del l, bias, gy, y, dl, dl2, y_p, dl_p
    l, bias, gy = _f3_inputs(6144, 12, 128, 128, "bf16", "bf16", 64, seed=6)
    with torch.no_grad():
        y = attn_softmax.attn_softmax(l, bias, 8.0, torch.bfloat16, True)
        y_p = attn_softmax.attn_softmax_plain(l, bias, 8.0, torch.bfloat16, True)
    assert _close(y, y_p, rows_summed=True)


def test_f3_one_key_chunks_match_plain_at_sk_128():
    """Logits in a view 2 bytes past an aligned address take the kernel's
    one-key-a-chunk path (Sk 128 takes four-key chunks otherwise)."""
    l, bias, gy = _f3_inputs(5, 3, 128, 128, "bf16", "bf16", 16, seed=9)
    buf = torch.empty(l.numel() + 1, dtype=l.dtype, device="cuda")
    off = buf[1:].view(l.shape)
    off.copy_(l)
    (y, dl), (y_p, dl_p) = _f3_case(off, bias, gy, "bf16", dropout=(12, 0.1, 8, None))
    assert _close(y, y_p, rows_summed=True, ulps=2) and _close(dl, dl_p, rows_summed=True)


def test_f3_identical_across_calls():
    l, bias, gy = _f3_inputs(64, 12, 128, 128, "bf16", "bf16", 64, seed=7)
    first, again = (_f3_case(l, bias, gy, "bf16", dropout=(8, 0.1, 8, None))[0]
                    for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_f3_refuses_what_its_kernel_does_not_take():
    l = torch.zeros(1, 1, 2, 8, device="cuda")
    with pytest.raises(TypeError, match="bf16->bf16"):
        attn_softmax.attn_softmax(l, torch.zeros(1, 1, 1, 8, device="cuda"), 8.0,
                                  torch.bfloat16)
    with pytest.raises(ValueError, match="above 1024"):
        attn_softmax.attn_softmax(torch.zeros(1, 1, 2, 1025, device="cuda"),
                                  torch.zeros(1, 1, 1, 1025, device="cuda"), 8.0,
                                  torch.float32)
    with pytest.raises(ValueError, match="training variant"):
        ll = l.to(torch.bfloat16).requires_grad_()
        y = attn_softmax.attn_softmax(ll, torch.zeros(1, 1, 1, 8, device="cuda"),
                                      8.0, torch.bfloat16, True)
        y.sum().backward()


def _f3_designs(before):
    """The F3 variants launched since `before` (a copy of the counter)."""
    now = fused_layer.launches_by_variant
    return {k: now[k] - before.get(k, 0) for k in now
            if k[0].startswith("attn_softmax") and now[k] != before.get(k, 0)}


#: The tile design's edges: (batch, heads, queries, keys, segment (None: the
#: (B, 1, 1, S) bias), dropout bits). 67 x 8 tiles of 16 queries are more
#: than the grid's resident blocks (3 an SM on an H100) and not a multiple of
#: them, so the persistent walk wraps the ring; 100 and 5 queries leave a
#: partial last tile; one head and twelve; 64 and 256 keys take 8 and 32
#: lanes a row.
F3_TILE_EDGES = ((67, 2, 128, 128, 64, 8), (67, 2, 128, 128, None, 32),
                 (3, 12, 100, 128, 32, 8), (4, 1, 5, 128, None, 16),
                 (2, 12, 128, 128, 64, None), (5, 3, 37, 64, 16, 8),
                 (3, 2, 19, 256, 128, 32))


@pytest.mark.parametrize("b,nh,sq,sk,seg,nbits", F3_TILE_EDGES)
def test_f3_tile_edges_match_plain(b, nh, sq, sk, seg, nbits):
    """The tile design against the plain chain at its own edges, forward and
    backward, dl identical across two calls; every launch took it."""
    l, bias, gy = _f3_inputs(b, nh, sq, sk, "bf16", "bf16", seg, seed=20 + sq)
    drop = None if nbits is None else (13, 0.1, nbits, None)
    before = dict(fused_layer.launches_by_variant)
    (y, dl, dl2), (y_p, dl_p) = _f3_case(l, bias, gy, "bf16", dropout=drop, calls=2)
    kinds = _f3_designs(before)
    assert kinds and all(v.startswith("tile ") for _, v in kinds), kinds
    assert torch.equal(dl, dl2)
    assert _close(y, y_p, rows_summed=True, ulps=1 if drop is None else 2)
    assert _close(dl, dl_p, rows_summed=True)


@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_f3_tile_masks_in_a_tensor_parallel_block(nbits):
    """Heads 6-11 of a 12-head site, rows 64-127 of 128, at Sk 128 through
    the tile design: the masks read from y and dl (zero logits, a unit
    cotangent; see test_f3_masks_equal_the_plain_generator) equal the plain
    generator's."""
    b, nh, sq, sk = 64, 6, 128, 128
    block = ((128, 12, sq, sk), (64, 6, 0, 0))
    drop = (0x5EED16, 0.5, nbits, block)
    l = torch.zeros((b, nh, sq, sk), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    bias = torch.zeros((b, 1, sq, sk), device="cuda")
    before = dict(fused_layer.launches_by_variant)
    y = attn_softmax.attn_softmax(l, bias, 8.0, torch.bfloat16, dropout=drop)
    dl, = torch.autograd.grad(y, l, torch.ones_like(y))
    kinds = _f3_designs(before)
    assert len(kinds) == 2 and all(v.startswith("tile ") for _, v in kinds), kinds
    keep = dropout_rng.site_keep(drop[0], 0.5, nbits, l.shape, block, "cuda")[0]
    assert 0 < keep.sum() < keep.numel()
    assert torch.equal(y != 0, keep)
    assert torch.equal(dl.float() > 0, keep) and not bool((dl == 0).any())


def test_f3_layer_biases_take_the_tile_design():
    """Both of the layer's bias layouts at Sk 128 (packed (B, 1, S, S), and
    (B, 1, 1, S)) take the tile design; a bias with a head axis takes the
    row design, and both agree with the plain chain."""
    for seg, heads_axis in ((64, False), (None, False), (64, True)):
        l, bias, gy = _f3_inputs(6, 4, 128, 128, "bf16", "bf16", seg, seed=30)
        if heads_axis:
            bias = bias.expand(6, 4, 128, 128).contiguous()
        before = dict(fused_layer.launches_by_variant)
        (y, dl), (y_p, dl_p) = _f3_case(l, bias, gy, "bf16", dropout=(14, 0.1, 8, None))
        want = "row " if heads_axis else "tile "
        kinds = _f3_designs(before)
        assert len(kinds) == 2 and all(v.startswith(want) for _, v in kinds), kinds
        assert _close(y, y_p, rows_summed=True, ulps=2) and _close(dl, dl_p, rows_summed=True)


# -- the dropout masks evaluated inside the kernels -----------------------------

#: (whole shape, start) blocks of a (3, 5, S, S) attention tensor: none, a
#: rank's rows, and rows and heads under tensor parallelism.
F3_BLOCKS = (None, ((11, 5), (7, 0)), ((4, 12), (1, 5)))


def _f3_block(blk, sq, sk):
    return None if blk is None else ((*blk[0], sq, sk), (*blk[1], 0, 0))


@pytest.mark.parametrize("blk", F3_BLOCKS)
@pytest.mark.parametrize("sk", [128, 100, 40, 33])
@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_f3_masks_equal_the_plain_generator(nbits, sk, blk):
    """Uniform probabilities (zero logits and bias: p = 1/Sk) and a unit
    cotangent make the mask readable from both outputs: y != 0 where kept;
    dl = p (gd - mean gd) / scale is above 0 where kept and below where
    dropped (rate 0.5: no row keeps every key). Odd row and query counts;
    Sk 128, 100 and 40 take four-key chunks (128 shares each call among
    its lanes at 8 and 16 bits, 40 at 16), 33 one key a chunk."""
    b, nh, sq = 3, 5, 7
    block = _f3_block(blk, sq, sk)
    drop = (0xDEADBEEF12345, 0.5, nbits, block)
    l = torch.zeros((b, nh, sq, sk), device="cuda", dtype=torch.bfloat16,
                    requires_grad=True)
    bias = torch.zeros((b, 1, 1, sk), device="cuda")
    before = (attn_softmax.launches, attn_softmax.backward_launches)
    y = attn_softmax.attn_softmax(l, bias, 8.0, torch.float32, dropout=drop)
    dl, = torch.autograd.grad(y, l, torch.ones_like(y))
    assert (attn_softmax.launches, attn_softmax.backward_launches) == (
        before[0] + 1, before[1] + 1)
    keep = dropout_rng.site_keep(drop[0], 0.5, nbits, l.shape, block, "cuda")[0]
    assert 0 < keep.sum() < keep.numel()
    assert torch.equal(y != 0, keep)
    assert torch.equal(dl.float() > 0, keep) and not bool((dl == 0).any())
    y_p = attn_softmax.attn_softmax_plain(l.detach(), bias, 8.0, torch.float32,
                                          dropout=drop)
    assert torch.equal(y, y_p)


def _f2_dropout_case(x_dt, rows, w, nbits, block, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.0 + torch.randn((rows, 1, w), generator=g, device="cuda")).to(x_dt)
    r = (0.5 * torch.randn((rows, 1, w), generator=g, device="cuda")).to(x_dt)
    scale = 1.0 + 0.1 * torch.randn(w, generator=g, device="cuda")
    bias = 0.1 * torch.randn(w, generator=g, device="cuda")
    gy = torch.randn((rows, 1, w), generator=g, device="cuda").to(x_dt)
    return x, r, scale, bias, gy, (0x5EED0F5175 + seed, 0.1, nbits, block)


@pytest.mark.parametrize("offset", [None, 999])
@pytest.mark.parametrize("x_dt", ["bf16", "f32"])
@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_f2_dropout_equals_the_plain_chain(nbits, x_dt, offset):
    """997 rows of a (B, 1, 768) site (or rows 999.. of a larger one): the
    sum s = x + drop(r) and dr = drop(ds) bit-equal to the plain chain on
    the kernel's ds; y, ds, dscale and dbias within F2's tolerances."""
    rows, w = 997, 768
    block = None if offset is None else ((offset + rows + 3, 1, w), (offset, 0, 0))
    x, r, scale, bias, gy, drop = _f2_dropout_case(DT[x_dt], rows, w, nbits, block, 1)
    y, s, mean, rstd = fused_layer._add_layer_norm_kernel(x, r, scale, bias, 1e-12,
                                                          DT[x_dt], drop)
    r_drop = fused_layer.site_dropout_plain(r, drop)
    assert torch.equal(s, x + r_drop)
    y_p = fused_layer.add_layer_norm_plain(x, r, scale, bias, 1e-12, DT[x_dt], drop)
    assert _close(y, y_p, rows_summed=True)
    ds, dr, dscale, dbias = fused_layer._add_layer_norm_backward_kernel(
        gy, s, mean, rstd, scale, drop)
    assert torch.equal(dr, fused_layer.site_dropout_plain(ds, drop))
    ins = [t.detach().requires_grad_() for t in (x, r, scale, bias)]
    want = torch.autograd.grad(fused_layer.add_layer_norm_plain(
        *ins, 1e-12, DT[x_dt], drop), ins, gy)
    assert _close(ds, want[0], rows_summed=True)
    assert _sum_close(dscale, want[2]) and _sum_close(dbias, want[3])
    keep = dropout_rng.site_keep(drop[0], 0.1, nbits, r.shape, block, "cuda")[0]
    assert torch.equal(dr == 0, ~keep | (ds == 0))


def test_f2_dropout_function_matches_plain_and_counts():
    """The Function: x + drop(r) forward and backward against autograd of
    the plain chain, one launch each way, dx = ds and dr = drop(ds)."""
    x, r, scale, bias, gy, drop = _f2_dropout_case(torch.bfloat16, 513, 768, 8,
                                                   None, 2)
    before = (fused_layer.add_layer_norm_launches,
              fused_layer.add_layer_norm_backward_launches)
    res = []
    for fn in (fused_layer.add_layer_norm, fused_layer.add_layer_norm_plain):
        ins = [t.detach().requires_grad_() for t in (x, r, scale, bias)]
        y = fn(*ins, 1e-12, torch.bfloat16, drop)
        res.append((y, *torch.autograd.grad(y, ins, gy)))
    assert (fused_layer.add_layer_norm_launches,
            fused_layer.add_layer_norm_backward_launches) == (before[0] + 1,
                                                              before[1] + 1)
    (y, dx, dr, dsc, dbi), (y_p, dx_p, dr_p, dsc_p, dbi_p) = res
    assert _close(y, y_p, rows_summed=True) and _close(dx, dx_p, rows_summed=True)
    assert torch.equal(dr, fused_layer.site_dropout_plain(dx, drop))
    assert _sum_close(dsc, dsc_p) and _sum_close(dbi, dbi_p)


def _f2_forward_check(x, r, scale, bias, out_dt, dropout=None, keep_sum=True):
    """F2's forward kernel against the plain version: s bit-equal to x +
    drop(r) (torch's CUDA ops, the plain generator's mask), y within F2's
    tolerance, mean and rstd within f32 rounding of the plain statistics."""
    y, s, mean, rstd = fused_layer._add_layer_norm_kernel(
        x, r, scale, bias, 1e-12, out_dt, dropout, keep_sum)
    want_s = x if r is None else x + (r if dropout is None else
                                      fused_layer.site_dropout_plain(r, dropout))
    if r is not None and keep_sum:
        assert torch.equal(s, want_s)
    elif r is not None:
        assert s is None
    y_p, mu_p, rs_p = fused_layer._layer_norm_stats(want_s, scale, bias, 1e-12, out_dt)
    assert y.dtype == out_dt and _close(y, y_p, rows_summed=True)
    assert torch.allclose(mean, mu_p, rtol=1e-5, atol=1e-6 * want_s.float().abs().max().item())
    assert torch.allclose(rstd, rs_p, rtol=1e-4)


def _f2_rows(rows, w, x_dt, seed, r_dt=None):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (1.0 + torch.randn((rows, w), generator=g, device="cuda")).to(x_dt)
    r = (0.5 * torch.randn((rows, w), generator=g, device="cuda")).to(r_dt or x_dt)
    scale = 1.0 + 0.1 * torch.randn(w, generator=g, device="cuda")
    bias = 0.1 * torch.randn(w, generator=g, device="cuda")
    return x, r, scale, bias


#: Rows of F2's slab edges: one row, fewer than a slab's 8, one slab, a slab
#: and one, and 6,341 rows, whose last slab is partial.
F2_SLAB_ROWS = [1, 5, 8, 9, 6341]


@pytest.mark.parametrize("w", [8, 24, 768, 1024, 4096])
@pytest.mark.parametrize("rows", F2_SLAB_ROWS)
def test_f2_slab_edges_match_plain(rows, w):
    """The slab design at ragged row counts and at widths from one vector to
    the 4,096 limit."""
    before = dict(fused_layer.launches_by_variant)
    x, r, scale, bias = _f2_rows(rows, w, torch.bfloat16, rows + w)
    _f2_forward_check(x, r, scale, bias, torch.bfloat16)
    key = ("add_layer_norm", f"slab x+r bf16->bf16 w{w}")
    assert fused_layer.launches_by_variant[key] == before.get(key, 0) + 1


@pytest.mark.parametrize("w", [24, 768, 2048, 4096])
@pytest.mark.parametrize("x_dt,out_dt", [("bf16", "bf16"), ("f32", "f32"),
                                         ("f32", "bf16"), ("bf16", "f32")])
@pytest.mark.parametrize("with_r", [True, False])
def test_f2_slab_without_the_sum_matches_plain(with_r, x_dt, out_dt, w):
    """x + r with the sum not written (an encode), and LN of x alone (the
    f32 embedding sum), at 37 rows, mean and rstd included; f32 rows of x
    and r of 4,096 take 6 rows a block (8 do not fit its shared memory)."""
    x, r, scale, bias = _f2_rows(37, w, DT[x_dt], 7)
    _f2_forward_check(x, r if with_r else None, scale, bias, DT[out_dt], keep_sum=False)


@pytest.mark.parametrize("offset", [0, 1, 999])
@pytest.mark.parametrize("w", [24, 264, 520, 768])
@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_f2_slab_masks_equal_the_plain_generator(nbits, w, offset):
    """s = x + drop(r) bit-equal to the plain generator's mask on a block of
    whole rows of a larger site. At 8 bits the lane pairs share a Philox
    call where a row starts on one (its flat index a multiple of 16: every
    row at w 768; every other row at w 24, 264 and 520, which give a lane
    one, two and three vectors); the other rows take a call a lane."""
    rows = 41
    x, r, scale, bias = _f2_rows(rows, w, torch.bfloat16, nbits + w + offset)
    drop = (0xF2 + offset, 0.1, nbits, ((offset + rows + 3, w), (offset, 0)))
    _f2_forward_check(x, r, scale, bias, torch.bfloat16, drop)


def test_f2_backward_zeroes_no_buffer(monkeypatch):
    """F2's backward allocates dscale and dbias empty when there are rows
    (its launch writes every column, and each launch carries its state
    words on for the next), so no torch.zeros and no memset launch; its
    sums equal the plain ones and two calls give the same bits."""
    x, r, scale, bias = _f2_rows(4097, 768, torch.bfloat16, 3)
    _, s, mean, rstd = fused_layer._add_layer_norm_kernel(x, r, scale, bias, 1e-12,
                                                          torch.bfloat16)
    gy = torch.randn_like(x)
    first = fused_layer._add_layer_norm_backward_kernel(gy, s, mean, rstd, scale)

    def no_zeros(*args, **kwargs):
        raise AssertionError("F2's backward zeroed a buffer")

    monkeypatch.setattr(torch, "zeros", no_zeros)
    again = fused_layer._add_layer_norm_backward_kernel(gy, s, mean, rstd, scale)
    monkeypatch.undo()
    assert all(torch.equal(a, b) for a, b in zip(first, again) if a is not None)
    want = [t.float().sum(0) for t in (gy.float() * (s.float() - mean) * rstd, gy)]
    assert _sum_close(again[2], want[0]) and _sum_close(again[3], want[1])


def _f2_sums_in_order(g, s, mean, rstd):
    """dscale and dbias in the order F2's backward documents, one f32
    elementwise add a step: each chunk (fused_layer.chunk_rows) adds its
    rows warp by warp (warp k: rows k, k + 8, ... of the chunk, in order),
    then its 8 warp sums in warp order into the chunk's partial row; each
    column adds the chunk partials in 32 strided streams (chunks y, y + 32,
    ..., in order), then the 32 stream sums in order. Padding rows and
    chunks are zeros: adding 0.0 to a sum that starts at +0.0 keeps its
    bits."""
    rows, w = s.shape
    chunk = fused_layer.chunk_rows(rows)
    n_chunks = -(-rows // chunk)
    xhat = (s.float() - mean.reshape(rows, 1)) * rstd.reshape(rows, 1)
    terms = torch.cat([g.float() * xhat, g.float()], dim=1)           # (rows, 2w)
    pad = -(-chunk // 8) * 8
    per_chunk = torch.zeros((n_chunks, pad, 2 * w), device=s.device)
    for c in range(n_chunks):
        part = terms[c * chunk:(c + 1) * chunk]
        per_chunk[c, :part.shape[0]] = part
    per_chunk = per_chunk.view(n_chunks, pad // 8, 8, 2 * w)
    warps = torch.zeros((n_chunks, 8, 2 * w), device=s.device)
    for i in range(pad // 8):
        warps += per_chunk[:, i]
    partial = torch.zeros((n_chunks, 2 * w), device=s.device)
    for k in range(8):
        partial += warps[:, k]
    rounds = -(-n_chunks // 32)
    padded = torch.zeros((rounds * 32, 2 * w), device=s.device)
    padded[:n_chunks] = partial
    streams = torch.zeros((32, 2 * w), device=s.device)
    for i in range(rounds):
        streams += padded[i * 32:(i + 1) * 32]
    total = streams[0].clone()
    for k in range(1, 32):
        total += streams[k]
    return total[:w], total[w:]


def _f2_backward_inputs(rows, w, s_dt, g_dt, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    s = (1.0 + torch.randn((rows, w), generator=g, device="cuda")).to(s_dt)
    mean = s.float().mean(-1, keepdim=True)
    rstd = torch.rsqrt(s.float().var(-1, unbiased=False, keepdim=True) + 1e-12)
    scale = 1.0 + 0.1 * torch.randn(w, generator=g, device="cuda")
    gy = torch.randn((rows, w), generator=g, device="cuda").to(g_dt)
    return gy, s, mean, rstd, scale


@pytest.mark.parametrize("rows,w,s_dt,nbits", [
    (131_072, 768, "bf16", 8),      # the W5M train step: 1,024 chunks of 128
    (131_072, 768, "bf16", 32),
    (131_072, 768, "bf16", None),
    (131_072, 768, "f32", None),    # the embedding LayerNorm (f32 sum, bf16 g)
    (20, 768, "bf16", 8),           # one chunk, fewer rows than its 8 warps' 32
    (1_001, 768, "bf16", 32),       # not a multiple of 8: a partial last chunk
    (131_073, 768, "bf16", None),   # chunks of 129 rows, 1,017 of them
    (5_003, 1024, "bf16", 8),
    (3_001, 4096, "bf16", None),    # 16 vectors a lane
    (3_001, 4096, "f32", 32),
])
def test_f2_backward_sums_follow_the_documented_order(rows, w, s_dt, nbits):
    """dscale and dbias bit-equal to a torch evaluation of the order the
    kernel documents, whatever the grid, the card or the blocks' order; one
    launch each call."""
    g_dt = torch.bfloat16
    gy, s, mean, rstd, scale = _f2_backward_inputs(rows, w, DT[s_dt], g_dt, rows + w)
    drop = None if nbits is None else (0xF2B + rows, 0.1, nbits, None)
    before = fused_layer.add_layer_norm_backward_launches
    ds, dr, dscale, dbias = fused_layer._add_layer_norm_backward_kernel(
        gy, s, mean, rstd, scale, drop)
    assert fused_layer.add_layer_norm_backward_launches == before + 1
    want_scale, want_bias = _f2_sums_in_order(gy, s, mean, rstd)
    assert torch.equal(dscale, want_scale) and torch.equal(dbias, want_bias)
    assert dr is None if drop is None else torch.equal(
        dr, fused_layer.site_dropout_plain(ds, drop))


def test_f2_backward_same_bits_back_to_back_and_on_two_streams():
    """Two calls back to back, and two calls on two streams at once (each
    stream its own ticket buffer), give the same bits of ds, dr, dscale and
    dbias."""
    gy, s, mean, rstd, scale = _f2_backward_inputs(131_072, 768, torch.bfloat16,
                                                   torch.bfloat16, 11)
    drop = (0xB0B, 0.1, 8, None)
    call = lambda: fused_layer._add_layer_norm_backward_kernel(  # noqa: E731
        gy, s, mean, rstd, scale, drop)
    first, second = call(), call()
    streams = [torch.cuda.Stream() for _ in range(2)]
    torch.cuda.synchronize()
    outs = []
    for st in streams:
        with torch.cuda.stream(st):
            outs.append(call())
    torch.cuda.synchronize()
    for other in (second, *outs):
        assert all(torch.equal(a, b) for a, b in zip(first, other))


def test_f2_backward_refuses_a_short_state_buffer():
    """The C entry refuses a state buffer shorter than its two words (or
    none): cudaErrorInvalidValue, and nothing launched. A launch leaves the
    two words equal (the blocks arrived, and that count for the next
    launch)."""
    gy, s, mean, rstd, scale = _f2_backward_inputs(64, 768, torch.bfloat16,
                                                   torch.bfloat16, 12)
    ds = torch.empty_like(s)
    partial = torch.empty((2, 2 * 768), device="cuda")
    dsb = torch.full((2 * 768,), 7.0, device="cuda")
    state = torch.zeros(2, dtype=torch.int32, device="cuda")
    entry = fused_layer._bound("add_layer_norm_backward")

    def launch(state_ptr, n_state):
        return entry(gy.data_ptr(), s.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                     scale.data_ptr(), ds.data_ptr(), None, partial.data_ptr(),
                     dsb.data_ptr(), state_ptr, 64, 768, 1, 1, 32, n_state,
                     *fused_layer._drop_args(None, s.shape),
                     torch.cuda.current_stream().cuda_stream)

    assert launch(state.data_ptr(), 1) == 1 and launch(None, 2) == 1
    torch.cuda.synchronize()
    assert bool((dsb == 7.0).all())
    assert launch(state.data_ptr(), 2) == 0
    torch.cuda.synchronize()
    assert not bool((dsb == 7.0).any())
    assert int(state[0]) == int(state[1]) > 0


@pytest.mark.parametrize("offset", [None, 24])
@pytest.mark.parametrize("dt", ["bf16", "f32"])
@pytest.mark.parametrize("nbits", [8, 16, 32])
def test_site_kernel_equals_the_plain_dropout(nbits, dt, offset):
    """drop(x) and its backward drop(g) bit-equal to the plain version, at
    an odd row count, on the whole site or a block of its rows."""
    shape = (37, 12, 64)
    block = None if offset is None else ((100, 12, 64), (offset, 0, 0))
    drop = (77, 0.25, nbits, block)
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(shape, generator=g, device="cuda").to(DT[dt]).requires_grad_()
    gy = torch.randn(shape, generator=g, device="cuda").to(DT[dt])
    before = fused_layer.site_dropout_launches
    y = bert._rng_dropout(x, 77, 0.25, nbits, block)
    dx, = torch.autograd.grad(y, x, gy)
    assert fused_layer.site_dropout_launches == before + 2
    assert torch.equal(y, fused_layer.site_dropout_plain(x.detach(), drop))
    assert torch.equal(dx, fused_layer.site_dropout_plain(gy, drop))
    keep = dropout_rng.site_keep(77, 0.25, nbits, shape, block, "cuda")[0]
    assert torch.equal(y != 0, keep & (x != 0))


def test_training_layer_draws_no_mask_with_torch():
    """A bf16 training layer, forward and backward (dropout on at the
    attention and both hidden sites): torch.profiler shows no RNG kernel
    and no `where`; F2, F3 and their backwards carry the masks (F3 at Sk
    128 in its tile design)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = bert.BertConfig(num_layers=1, compute_dtype=torch.bfloat16,
                          dropout_bits=8)
    lp = {k: v.cuda().requires_grad_() for k, v in bert.unstack_layers(
        bert.init_bert_params(cfg, torch.Generator().manual_seed(0)))["layers"][0].items()}
    x = torch.randn((4, 128, 768), device="cuda").to(torch.bfloat16).requires_grad_()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        y = bert._encoder_layer(cfg, x, torch.zeros(4, 1, 1, 128, device="cuda"), lp,
                                seeds=(1, 2, 3), rate=0.1)
        y.float().sum().backward()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "distribution" in n or "randint" in n
                or "where" in n], names
    assert any("add_ln_fwd" in n for n in names) and any("attn_softmax_tile_bwd" in n
                                                          for n in names)


_PHILOX_CHECK = r"""
#include <curand_kernel.h>
#include "dropout_rng.cuh"
__global__ void both(const unsigned* in, unsigned* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned* c = in + 6 * i;
  const uint4 a = dropout_rng::philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]), c[4], c[5]);
  const uint4 b = curand_Philox4x32_10(make_uint4(c[0], c[1], c[2], c[3]),
                                       make_uint2(c[4], c[5]));
  unsigned* o = out + 8 * i;
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
extern "C" int run(const void* in, void* out, int n) {
  both<<<(n + 127) / 128, 128>>>((const unsigned*)in, (unsigned*)out, n);
  return (int)cudaDeviceSynchronize();
}
"""


def test_device_philox_equals_curand(tmp_path):
    """The kernels' Philox4x32-10 (csrc/dropout_rng.cuh) against the
    toolkit's curand_Philox4x32_10 on random counters and keys, and the
    plain version against both: a test-only cross-check."""
    nvcc = _cuda._nvcc()
    cuda_home = os.path.dirname(os.path.dirname(os.path.realpath(nvcc)))
    header = os.path.join(cuda_home, "include", "curand_philox4x32_x.h")
    if not os.path.exists(header):
        pytest.skip(f"no {header} in this toolkit")
    src = tmp_path / "philox_check.cu"
    src.write_text(_PHILOX_CHECK)
    lib = tmp_path / "philox_check.so"
    subprocess.run([nvcc, *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC_DIR), "-o",
                    str(lib), str(src)], check=True, capture_output=True, timeout=600)
    run = ctypes.CDLL(str(lib)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    n = 4096
    words = torch.from_numpy(np.random.default_rng(0).integers(
        0, 1 << 32, (n, 6), dtype=np.uint64).astype(np.int64))
    words[0] = 0
    inp = words.to(torch.int32).cuda()                 # the same 32 bits
    out = torch.empty((n, 8), dtype=torch.int32, device="cuda")
    assert run(inp.data_ptr(), out.data_ptr(), n) == 0
    got = out.cpu().to(torch.int64) & 0xFFFFFFFF
    assert torch.equal(got[:, :4], got[:, 4:])
    plain = torch.stack(dropout_rng.philox4x32(
        tuple(words[:, i] for i in range(4)), (0, 0)), dim=-1)
    assert torch.equal(plain[0], got[0, :4])            # key 0
    for i in range(0, n, 512):                         # the plain version a key at a time
        row = words[i]
        want = dropout_rng.philox4x32(tuple(row[j:j + 1] for j in range(4)),
                                      (int(row[4]), int(row[5])))
        assert [int(w) for w in want] == got[i, :4].tolist()


# -- the word tables' gather backward (index_put_segsum) ------------------------
#
# Tolerance against a float64 sum of the same contributions: the bound of
# recursive f32 summation for the kernel's longest chain, (CHUNK + 1 + the
# row's chunk count) * 2^-24 * sum |g| per element (each piece is a sequential
# sum of at most CHUNK rows, each run a sequential sum of its pieces). The
# kernel adds in `segment_sum_plain`'s order, which CUDA's elementwise adds
# reproduce, so the two are also held equal bit for bit.

def _zipf_ids(rng, n, first_id, ranks, exponent=1.0):
    w = np.arange(1, ranks + 1, dtype=np.float64) ** -exponent
    cdf = np.cumsum(w) / w.sum()
    return first_id + np.minimum(np.searchsorted(cdf, rng.random(n)), ranks - 1)


def _cell_ids(rng, vocab, special=(), descriptions=2048, L=64):
    """The train cells' positions: 2,048 descriptions of 64, 80% at the cap
    and the rest 8..63 long (so ~9% of the positions are padding, id 0),
    Zipf ids; with `special`, [CLS] first and [SEP] last in every row."""
    lengths = np.where(rng.random(descriptions) < 0.8, L,
                       rng.integers(8, L, descriptions))
    ids = _zipf_ids(rng, descriptions * L, 1 + 3 * bool(special), vocab - 4).reshape(
        descriptions, L)
    if special:
        ids[:, 0] = special[0]
        ids[np.arange(descriptions), lengths - 1] = special[1]
    ids[np.arange(L) >= lengths[:, None]] = 0
    return torch.from_numpy(ids)


def _boundary_ids():
    c = row_gather.CHUNK
    return torch.cat([torch.full((c,), 2), torch.full((c + 1,), 5),     # ends on a
                      torch.full((c - 1,), 6), torch.tensor([8]),       # boundary, one
                      torch.full((2 * c,), 9)])                         # past it


SEGSUM_CASES = {
    # name: (ids, rows, width, offset of g's first element in floats)
    "one id, 131,072 positions": (lambda rng: torch.zeros(131072, dtype=torch.long), 5, 300, 0),
    "cells' mix, BERT": (lambda rng: _cell_ids(rng, 28996, (101, 102)), 28996, 768, 0),
    "cells' mix, GloVe": (lambda rng: _cell_ids(rng, 400001), 400001, 300, 0),
    "chunk boundaries": (lambda rng: _boundary_ids(), 12, 300, 0),
    "chunk boundaries, scalar loads": (lambda rng: _boundary_ids(), 12, 300, 1),
    "chunk boundaries, two slabs": (lambda rng: _boundary_ids(), 12, 1100, 0),
    "last row": (lambda rng: torch.tensor([3] * 5 + [999] * 300), 1000, 768, 0),
    "runs of 1": (lambda rng: torch.from_numpy(rng.permutation(50000)), 60000, 300, 0),
}


@pytest.mark.parametrize("case", list(SEGSUM_CASES))
def test_segsum_kernel_matches_float64_and_its_order(case):
    make, rows, width, offset = SEGSUM_CASES[case]
    rng = np.random.default_rng(len(case))
    ids = make(rng).cuda()
    n = ids.numel()
    buf = torch.randn(n * width + offset, device="cuda")
    g = buf[offset:].view(tuple(ids.shape) + (width,))
    before = row_gather.launches
    got = [row_gather.segment_sum(g, ids, rows) for _ in range(2)]
    torch.cuda.synchronize()
    assert row_gather.launches == before + 2
    assert torch.equal(got[0], got[1])
    assert torch.equal(got[0], row_gather.segment_sum_plain(g, ids, rows))
    flat, g64 = ids.reshape(-1), g.reshape(-1, width).double()
    exact = torch.zeros((rows, width), dtype=torch.float64, device="cuda")
    exact.index_add_(0, flat, g64)
    mass = torch.zeros_like(exact).index_add_(0, flat, g64.abs())
    counts = torch.bincount(flat, minlength=rows)
    chain = row_gather.CHUNK + 1 + (counts + row_gather.CHUNK - 1) // row_gather.CHUNK
    bound = chain[:, None].double() * 2.0 ** -24 * mass
    assert ((got[0].double() - exact).abs() <= bound).all()
    assert (got[0][counts == 0] == 0).all()


def test_segsum_chunk_equals_the_kernels():
    assert _cuda.load("row_gather").index_put_segsum_chunk() == row_gather.CHUNK


def test_gather_rows_backward_is_the_kernel_on_card():
    rng = np.random.default_rng(0)
    ids = _cell_ids(rng, 1000, (101, 102), descriptions=64).cuda()
    table = torch.randn((1000, 300), device="cuda", requires_grad=True)
    g = torch.randn(tuple(ids.shape) + (300,), device="cuda")
    before = row_gather.launches
    rows = row_gather.gather_rows(table, ids)
    assert torch.equal(rows, table.detach()[ids])
    (grad,) = torch.autograd.grad(rows, table, g)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 1
    assert torch.equal(grad, row_gather.segment_sum_plain(g, ids, 1000))
    with torch.no_grad():
        assert torch.equal(row_gather.gather_rows(table, ids), rows)
    assert row_gather.launches == before + 1


def test_gather_rows_backward_refuses_bf16_on_card():
    table = torch.randn((50, 16), device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
    rows = row_gather.gather_rows(table, torch.tensor([[1, 1, 0]], device="cuda"))
    with pytest.raises(TypeError, match="float32"):
        torch.autograd.grad(rows.float().sum(), table)
