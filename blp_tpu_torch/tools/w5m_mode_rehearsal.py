"""Wikidata5M-mode rehearsal with a quality bar: a 300k-entity typed graph
through `link_prediction large_dataset=True`, BERT-base from random weights,
and a bar on the filtered test MRR.

The port's counterpart of the TPU package's `tools/w5m_mode_rehearsal.py`,
with its flags, defaults, keys and JSON line. The 20k learning check
(`onchip_blp_20k`) runs the small-dataset path; this one runs the same
typed-graph task at 15x its scale through the path the real Wikidata5M
scripts take (`large_dataset=True`: no global filter graph, no train-sample
evaluation, each split filtered by its own triples, the best checkpoint
reloaded before the final evaluation), with the text cache on and
`resume="auto"`, so a run cut short continues from its state file.

The task (data/synth.py, numpy seed 31, as the TPU tool's): 10,000 types
of about 30 members, the type word leading each description, relation r
linking one fixed (head type, tail type) pair; 3% of the entities held out.
Perfect type knowledge alone gives raw MRR about H(30)/30 = 0.133 against a
type-blind candidate set, chance about ln(N)/N. The bar (filtered test MRR
>= 0.05) needs an encoder that reads the type words.

    python -m blp_tpu_torch.tools.w5m_mode_rehearsal --epochs 4 --out build/w5m_mode

Prints the run's result as one JSON line (with its wall seconds, the type
ceiling and the bar), then PASS; exits non-zero below the bar.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_args(argv: list[str] | None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join("build", "w5m_mode"))
    p.add_argument("--epochs", type=int, default=4)
    p.add_argument("--entities", type=int, default=300_000)
    p.add_argument("--types", type=int, default=10_000)
    p.add_argument("--triples", type=int, default=900_000)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--run-id", default="w5m-mode")
    p.add_argument("--bar", type=float, default=0.05,
                   help="filtered test-MRR assertion bar (0 disables)")
    p.add_argument("--inductive-frac", type=float, default=0.03)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (device=cpu); the default is cuda")
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> dict:
    from blp_tpu_torch.config import ExperimentConfig
    from blp_tpu_torch.data.synth import write_synth_dataset
    from blp_tpu_torch.train import link_prediction

    args = parse_args(argv)
    d = os.path.join(args.out, "data",
                     f"typed{args.entities // 1000}k-t{args.types // 1000}k"
                     f"-f{args.inductive_frac:g}")
    if not os.path.exists(os.path.join(d, "ind-train.tsv")):
        t0 = time.time()
        write_synth_dataset(
            d, num_entities=args.entities, num_relations=args.types,
            num_triples=args.triples, num_types=args.types,
            distinct_type_pairs=True, desc_words=(1, 3),
            inductive_frac=args.inductive_frac, seed=31)
        print(f"dataset written in {time.time() - t0:.0f}s", flush=True)

    cfg = ExperimentConfig(
        dataset=os.path.basename(d), data_dir=os.path.join(args.out, "data"),
        out_dir=os.path.join(args.out, "run"), inductive=True, model="blp",
        rel_model="transe", loss_fn="margin", dim=128, max_len=16,
        num_negatives=64, lr=args.lr, use_scheduler=True, batch_size=args.batch,
        emb_batch_size=2048, eval_batch_size=64, max_epochs=args.epochs,
        eval_every=1, tile=65536, bf16=True, remat=True,
        large_dataset=True, use_cached_text=True,
        run_id=args.run_id, resume="auto", seed=0,
        device="cpu" if args.cpu else "cuda")
    t0 = time.time()
    r = link_prediction(cfg)
    r["wall_s"] = round(time.time() - t0, 1)
    members = args.entities / args.types
    r["type_ceiling_mrr"] = round(
        sum(1.0 / k for k in range(1, int(members) + 1)) / members, 4)  # H(M)/M
    r["bar"] = args.bar
    print(json.dumps(r), flush=True)
    if args.bar > 0:
        if not r["test_mrr_filt"] >= args.bar:
            raise SystemExit(
                f"large_dataset-mode quality regression: filtered test MRR "
                f"{r['test_mrr_filt']:.4f} < bar {args.bar}")
        print(f"PASS: filtered test MRR {r['test_mrr_filt']:.4f} >= {args.bar}",
              flush=True)
    return r


if __name__ == "__main__":
    main()
