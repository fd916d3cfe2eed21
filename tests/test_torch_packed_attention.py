"""K2 port (blp_tpu_torch/ops/packed_attention.py): the plain version
against the JAX package's Pallas block-diagonal attention in interpret mode,
over the same (nh, hd) x packing grid as tests/test_pallas_attention.py.
Tolerance 2e-2: bf16 outputs, products accumulated in another order (the
bf16 noise class)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from blp_tpu.ops import pallas_attention
from blp_tpu_torch.ops import packed_attention


def _inputs(nh, hd, nseg, seg, B=6):
    sp = nseg * seg
    rng = np.random.default_rng(nh * 100 + sp)
    q, k, v = (np.asarray(jnp.asarray(rng.standard_normal((B, nh, sp, hd)),
                                      jnp.bfloat16)) for _ in range(3))
    lengths = rng.integers(1, seg + 1, (B, nseg))
    key_mask = (np.arange(seg)[None, None, :] < lengths[:, :, None])
    return q, k, v, key_mask.reshape(B, sp).astype(np.float32)


def _bf16_torch(a):
    return torch.from_numpy(np.asarray(a).view(np.uint16).copy()).view(
        torch.bfloat16)


@pytest.mark.parametrize("nh,hd", [(4, 8), (3, 16), (12, 64)])
@pytest.mark.parametrize("packs", [(1, 16), (4, 8)])  # (segments, seg_len)
def test_plain_matches_pallas_interpret(nh, hd, packs):
    nseg, seg = packs
    q, k, v, key_mask = _inputs(nh, hd, nseg, seg)
    scale = 1.0 / math.sqrt(hd)
    want = pallas_attention.block_diag_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_mask),
        seg=seg, scale=scale, interpret=True)
    before = packed_attention.launches
    got = packed_attention.block_diag_attention(
        _bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
        torch.from_numpy(key_mask), seg=seg, scale=scale)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (q.shape[0], nseg * seg, nh * hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
    # The CPU route never touches the kernel.
    assert packed_attention.launches == before == 0


def test_fully_masked_segment_matches():
    """A segment with no real key: its rows soften over the whole packed
    row, as in the TPU kernel."""
    q, k, v, key_mask = _inputs(4, 8, 4, 8)
    key_mask[0, 8:16] = 0.0
    want = pallas_attention.block_diag_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(key_mask),
        seg=8, scale=0.25, interpret=True)
    got = packed_attention.block_diag_attention(
        _bf16_torch(q), _bf16_torch(k), _bf16_torch(v),
        torch.from_numpy(key_mask), seg=8, scale=0.25)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_indivisible_segment_raises():
    q = torch.zeros((2, 4, 24, 8), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not divisible"):
        packed_attention.block_diag_attention(q, q, q, torch.ones((2, 24)),
                                              seg=7, scale=1.0)
