#!/usr/bin/env python3
"""chip_smoke.py's multi-rank checks with every rank on its own card.

    python3 mesh_probe.py [--ranks 4]

Needs --ranks cards on one host. Builds the kernels, writes the 4,096-entity
synthetic graph and runs (b)-(d) of chip_smoke.py's phase 9 with
device=cuda, so each rank takes cuda:LOCAL_RANK and the world uses NCCL: the
Wikidata5M-scale rank pass split into --ranks blocks (counts bit-equal to
one process, every K1 launch "tma"), the sharded evaluation with K2 in each
rank's encode, one fp32 BERT-base step under DP ranks x 1, TP 1 x ranks and
PP 1 x ranks (loss and gradients against one process), and link_prediction
under torch.distributed.run. chip_smoke.py runs the same checks with 2 ranks
on one card (gloo). Ends with one JSON line of its numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import torch

import chip_smoke as cs
from blp_tpu_torch.data.synth import write_synth_dataset
from blp_tpu_torch.ops import _cuda


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available() or torch.cuda.device_count() < args.ranks:
        print(f"mesh_probe: needs {args.ranks} CUDA devices", file=sys.stderr)
        return 2
    cs.log(f"card: {cs.card_line()}; {torch.cuda.device_count()} devices")
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda.build_all()
    shutil.rmtree(cs.WORK_DIR, ignore_errors=True)
    data_dir = write_synth_dataset(os.path.join(cs.WORK_DIR, "synth4096"),
                                   num_entities=4096, num_relations=12,
                                   num_triples=8000, seed=0)
    cfg, params = cs.make_model(12)
    del params
    stats, launches, k1 = cs.mesh_ranks(data_dir, cfg, args.ranks, "cuda")
    cs.require(all(launches.get(k, 0) > 0 for k in ("K1", "K2", "K3",
                                                      "K3 backward")),
               f"a kernel of the multi-rank paths was never launched: {launches}")
    stats.update(cs.mesh_cli(data_dir, args.ranks, "cuda"))
    shutil.rmtree(cs.WORK_DIR, ignore_errors=True)
    print(json.dumps({"ranks": args.ranks, "launches": dict(launches),
                      "k1_by_variant": {f"{v}/{d}": n for (v, d), n in k1.items()},
                      "stats": stats}, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
