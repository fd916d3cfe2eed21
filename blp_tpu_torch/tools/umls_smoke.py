"""UMLS-scale smoke run: the reference's one published wall-clock claim.

The port's counterpart of the TPU package's `tools/umls_smoke.py`, with its
flags, run and JSON keys. The reference (dfdazac/blp) states that its UMLS
smoke test (bert-bow + TransE, 5 epochs, its scripts/test-umls.sh) takes
"less than 1 minute on GPU" (its README.md:72). This runs the same workload
shape end to end through `link_prediction`: a UMLS-sized synthetic graph
(135 entities, 46 relations, 5,216 triples; numpy seed 1, as the TPU tool's),
5 training epochs with their evaluations, the final filtered valid and test
evaluations and the embedding export.

    python -m blp_tpu_torch.tools.umls_smoke --out build/umls_smoke
    python -m blp_tpu_torch.tools.umls_smoke --epochs 1 --cpu

Prints one JSON line: the wall seconds of `link_prediction` (the dataset
written before the clock starts) beside the reference's claim.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def main(argv: list[str] | None = None) -> dict:
    from blp_tpu_torch.config import ExperimentConfig
    from blp_tpu_torch.data.synth import write_synth_dataset
    from blp_tpu_torch.train import link_prediction

    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join("build", "umls_smoke"))
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (device=cpu); the default is cuda")
    args = p.parse_args(argv)

    d = os.path.join(args.out, "data", "umls-like")
    if not os.path.exists(os.path.join(d, "ind-train.tsv")):
        write_synth_dataset(d, num_entities=135, num_relations=46,
                            num_triples=5216, seed=1)

    t0 = time.time()
    r = link_prediction(ExperimentConfig(
        dataset="umls-like", data_dir=os.path.join(args.out, "data"),
        out_dir=os.path.join(args.out, "run"), inductive=True, model="bert-bow",
        rel_model="transe", loss_fn="margin", max_len=32, num_negatives=32,
        lr=2e-5, batch_size=64, emb_batch_size=512, eval_batch_size=64,
        max_epochs=args.epochs, run_id="umls-smoke", seed=0,
        device="cpu" if args.cpu else "cuda"))
    wall = time.time() - t0
    out = {"metric": "umls_smoke_seconds", "value": round(wall, 1),
           "unit": "s", "reference_claim": "<60 s on unspecified GPU",
           "test_mrr_filt": r["test_mrr_filt"]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
