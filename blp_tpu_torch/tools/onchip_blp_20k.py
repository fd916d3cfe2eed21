"""Learning check on the card: a 20k-entity typed graph, BERT-base from
random weights, filtered test MRR after a few epochs.

The port's counterpart of the TPU package's `tools/onchip_blp_20k.py`, with
the same graph and keys, run through `blp_tpu_torch.train.link_prediction`:
20,000 entities with 2,000 types of about 10 members (the type word leads
each description, relations link fixed type pairs), 60,000 triples, seed 20;
BERT-base in bf16, TransE, margin loss, B 128, L 16, 64 negatives, lr 1e-4
with linear warmup. Perfect type knowledge alone gives filtered MRR about
H(10)/10 = 0.29 and chance about 0.0005, so an encoder that learns to read
the type word lands well above chance.

    python -m blp_tpu_torch.tools.onchip_blp_20k --epochs 8 --out build/blp20k

Prints one JSON line: the run's raw and filtered test MRR, its wall time and
the card it ran on.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv: list[str] | None = None) -> dict:
    import torch

    from blp_tpu_torch.config import ExperimentConfig
    from blp_tpu_torch.data.synth import write_synth_dataset
    from blp_tpu_torch.train import link_prediction

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join("build", "blp20k"))
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--entities", type=int, default=20_000)
    p.add_argument("--types", type=int, default=2_000)
    p.add_argument("--triples", type=int, default=60_000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--device", default="cuda")
    p.add_argument("--run-id", default="blp20k")
    args = p.parse_args(argv)

    d = os.path.join(args.out, "data", "typed20k")
    if not os.path.exists(os.path.join(d, "ind-train.tsv")):
        t0 = time.time()
        write_synth_dataset(
            d, num_entities=args.entities, num_relations=args.types,
            num_triples=args.triples, num_types=args.types,
            distinct_type_pairs=True, desc_words=(1, 3), inductive_frac=0.1,
            seed=20)
        print(f"dataset written in {time.time() - t0:.0f}s", flush=True)

    cfg = ExperimentConfig(
        dataset="typed20k", data_dir=os.path.join(args.out, "data"),
        out_dir=os.path.join(args.out, "run"), inductive=True, model="blp",
        rel_model="transe", loss_fn="margin", dim=128, max_len=16,
        num_negatives=64, lr=1e-4, use_scheduler=True, batch_size=args.batch,
        emb_batch_size=2048, eval_batch_size=64, max_epochs=args.epochs,
        eval_every=max(args.epochs // 2, 1), tile=20_480, bf16=True,
        run_id=args.run_id, resume="auto", seed=0, device=args.device)
    t0 = time.time()
    r = link_prediction(cfg)
    r["wall_s"] = round(time.time() - t0, 1)
    r["epochs"] = args.epochs
    r["type_ceiling_mrr"] = 0.293  # H(10)/10
    if torch.cuda.is_available() and args.device != "cpu":
        r["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
