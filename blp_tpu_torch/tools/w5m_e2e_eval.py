"""Wikidata5M-scale evaluation on one card: the real evaluator at 4.8M
candidates.

The port's counterpart of the TPU package's `tools/w5m_e2e_eval.py`, with
its flags, defaults and JSON keys. It runs `evaluation.eval_link_prediction`
at Wikidata5M's dimensions (4.8M candidate entities, a BERT-base bf16
encoder, 822 relations) on synthetic descriptions and triples, filtered as
the large-dataset mode filters (an index over the evaluated split alone):
phase 1 (`evaluation.build_entity_table`, every candidate encoded) timed
apart from the ranking, whose TransE counts run on K1.

    python -m blp_tpu_torch.tools.w5m_e2e_eval --n 4800000 --triples 5000
    python -m blp_tpu_torch.tools.w5m_e2e_eval --tiny --cpu --n 2000

On the card the BERT-base encoder runs its attention through K2 (the
packed attention kernel); on the CPU, through the plain attention. The
synthetic inputs come from numpy (seed 0) and equal the TPU tool's bit for
bit; the random weights come from a torch generator (seed 0). Prints one
JSON line; on the card it adds the card's name, power limit and peak memory.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

W5M_RELATIONS = 822   # Wikidata5M's relation count


class SynthTextStore:
    """Minimal stand-in for TextGraphData: a packed (N, L) token matrix,
    each row zero past its random length (8 to L tokens)."""

    def __init__(self, n: int, max_len: int, vocab: int, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.max_len = max_len
        self.tok = rng.integers(1, vocab, (n, max_len), dtype=np.int32)
        self.lengths = rng.integers(8, max_len + 1, n).astype(np.int32)
        col = np.arange(max_len, dtype=np.int32)[None, :]
        self.tok *= (col < self.lengths[:, None])

    def get_entity_descriptions(self, ids: np.ndarray):
        tok = self.tok[ids]
        mask = (tok > 0).astype(np.float32)
        return tok, mask


def synth_triples(n: int, t: int, rng: np.random.Generator) -> np.ndarray:
    """(t, 3) [head, tail, rel] triples over n entities, drawn after the
    text store as the TPU tool draws them."""
    return np.stack([rng.integers(0, n, t), rng.integers(0, n, t),
                     rng.integers(0, W5M_RELATIONS, t)], axis=1).astype(np.int64)


def parse_args(argv: list[str] | None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4_800_000)
    ap.add_argument("--triples", type=int, default=5_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--max-len", type=int, default=32)
    ap.add_argument("--rel-model", default="transe")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--emb-batch", type=int, default=2048)
    ap.add_argument("--tile", type=int, default=65536)
    ap.add_argument("--tiny", action="store_true",
                    help="tiny encoder (CPU smoke test of this tool)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (device=cpu); the default is cuda")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None, params: dict | None = None) -> dict:
    """Run the evaluation and print its JSON line. `params`: the model's
    parameters (a tree of tensors in the TPU package's layout, such as
    `blp.params_from_jax` gives); random from seed 0 when omitted."""
    args = parse_args(argv)

    import torch

    from blp_tpu_torch import evaluation
    from blp_tpu_torch.data.filtering import FilterIndex
    from blp_tpu_torch.models import bert, blp
    from blp_tpu_torch.utils import card_stats, get_logger, resolve_device

    log = get_logger()
    device = resolve_device("cpu" if args.cpu else None)
    N, T = args.n, args.triples
    rng = np.random.default_rng(0)

    enc = (bert.BertConfig.tiny(vocab_size=1024) if args.tiny
           else bert.BertConfig(compute_dtype=torch.bfloat16,
                                fused_attention=device.type == "cuda"))
    cfg = blp.ModelConfig(model="blp", rel_model=args.rel_model,
                          loss_fn="margin", dim=args.dim,
                          num_relations=W5M_RELATIONS, encoder=enc)
    params = (blp.init_params(cfg, torch.Generator().manual_seed(0), device)
              if params is None else blp.to_device(params, device))

    t0 = time.time()
    text = SynthTextStore(N, args.max_len, cfg.encoder.vocab_size)
    entities = np.arange(N, dtype=np.int64)
    triples = synth_triples(N, T, rng)
    t_data = time.time() - t0
    log.info(f"synthetic data ready in {t_data:.1f}s "
             f"(text matrix {text.tok.nbytes / 1e9:.2f} GB)")

    # Large-dataset mode: filter index over the eval split only.
    filter_index = FilterIndex(triples)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    view = blp.encode_view(params, cfg)
    t0 = time.time()
    ent_emb = evaluation.build_entity_table(
        lambda tok, mask: blp.encode(view, cfg, tok, mask, device=device),
        text, entities, emb_batch_size=args.emb_batch, dim=cfg.entity_dim,
        device=device, pad_to=args.tile, log=log)
    sync()
    t_encode = time.time() - t0

    t0 = time.time()
    res = evaluation.eval_link_prediction(
        params, cfg, triples, text, entities, batch_size=args.batch,
        emb_batch_size=args.emb_batch, tile=args.tile,
        filter_index=filter_index, ent_emb=ent_emb, device=device, log=log)
    sync()
    t_rank = time.time() - t0

    out = {
        "metric": "w5m_e2e_eval_seconds",
        "n_candidates": N, "n_triples": T,
        "rel_model": args.rel_model,
        "value": round(t_encode + t_rank, 1), "unit": "s",
        "encode_seconds": round(t_encode, 1),
        "rank_seconds": round(t_rank, 1),
        "mrr_filt": res.mrr_filt,
        "entities_per_s": round(N / t_encode, 1),
        "max_len": args.max_len,
        "fused_attention": cfg.encoder.fused_attention,
    }
    out.update(card_stats(device))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
