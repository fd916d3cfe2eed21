"""Write the port's launcher scripts: one `python -m blp_tpu_torch.train`
command for every published configuration.

The port's counterpart of the TPU package's `tools/gen_scripts.py`: the same
matrix of datasets (WN18RR, FB15k-237, Wikidata5M), models (BLP with each
relation model, and the four word models), pretrained-evaluation variants
and the UMLS smoke test, with the same keys and values; only the module
the scripts run differs. The repository's `scripts/` holds the TPU
package's launchers, so this tool writes only into the directory it is
given.

    python -m blp_tpu_torch.tools.gen_scripts build/torch_scripts

A generated script runs on cuda (the command's default device).
"""

from __future__ import annotations

import argparse
import os
import stat

MODULE = "blp_tpu_torch"

DATASETS = {
    # dataset: (max_len, batch_size, emb_batch_size, eval_batch_size,
    #           blp_epochs, word_epochs, blp_lr, large)
    "WN18RR": (32, 64, 512, 64, 40, 80, "2e-5", False),
    "FB15k-237": (32, 64, 512, 64, 40, 80, "2e-5", False),
    "Wikidata5M": (64, 1024, 12288, 64, 5, 5, "5e-5", True),
}

BLP_REL_MODELS = ("transe", "distmult", "complex", "simple")
WORD_MODELS = {
    # model: (lr, use_scheduler)
    "glove-bow": ("1e-3", False),
    "bert-bow": ("1e-4", False),
    "glove-dkrl": ("1e-4", False),
    "bert-dkrl": ("1e-4", False),
}

UMLS_PREAMBLE = f"""\
# UMLS itself is not redistributable; when data/umls is absent, synthesize a
# UMLS-scale stand-in (135 entities, 46 relations, typed => learnable) so the
# smoke test runs out of the box with no downloads.
[ -d data/umls ] || python -c "from {MODULE}.data.synth import \\
write_synth_dataset as w; w('data/umls', num_entities=135, num_relations=46, \\
num_triples=5200, num_types=8, seed=0)"

"""


def emit(path: str, args: dict, preamble: str = ""):
    lines = [f"{k}={v} \\" for k, v in args.items()]
    lines[-1] = lines[-1][:-2]
    with open(path, "w") as f:
        f.write("#!/bin/bash\n\n" + preamble +
                f"python -m {MODULE}.train link_prediction with \\\n" +
                "\n".join(lines) + "\n")
    os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP)


def base_args(dataset, model, rel_model, lr, max_epochs, use_scheduler,
              regularizer):
    ml, bs, ebs, evbs, _, _, _, large = DATASETS[dataset]
    return {
        "dataset": f"'{dataset}'",
        "inductive": True,
        "dim": 128,
        "model": f"'{model}'",
        "rel_model": f"'{rel_model}'",
        "loss_fn": "'margin'",
        "encoder_name": "'bert-base-cased'",
        "regularizer": regularizer,
        "max_len": ml,
        "num_negatives": 64,
        "lr": lr,
        "use_scheduler": use_scheduler,
        "batch_size": bs,
        "emb_batch_size": ebs,
        "eval_batch_size": evbs,
        "max_epochs": max_epochs,
        "checkpoint": "None",
        "use_cached_text": False,
        "large_dataset": large,
        "bf16": model == "blp",
        # Wikidata5M's B 1,024 x L 64 BLP step keeps the activations of 8 of
        # its 12 layers out of memory (partial remat): 30.85 GiB at its peak
        # on an H100 80GB (PERF.md §5).
        **({"remat": 8} if large and model == "blp" else {}),
    }


def write_all(out_dir: str) -> list[str]:
    """Write every launcher into out_dir; returns their names in order."""
    os.makedirs(out_dir, exist_ok=True)
    names = []

    for dataset, (ml, bs, ebs, evbs, blp_ep, word_ep, blp_lr, large) in \
            DATASETS.items():
        ds_slug = dataset.lower().replace("-", "")
        for rel in BLP_REL_MODELS:
            args = base_args(dataset, "blp", rel, blp_lr, blp_ep, True, 0)
            name = f"blp-{rel}-{ds_slug}.sh"
            emit(os.path.join(out_dir, name), args)
            names.append(name)
            # Pretrained-evaluation variant (reference: *-pretrained.sh;
            # max_epochs=0 evaluates a checkpoint).
            p = dict(args)
            p["max_epochs"] = 0
            p["checkpoint"] = f"'output/model-blp-{rel}-{ds_slug}.npz'"
            p["use_cached_text"] = True
            pname = f"blp-{rel}-{ds_slug}-pretrained.sh"
            emit(os.path.join(out_dir, pname), p)
            names.append(pname)
        for model, (lr, sched) in WORD_MODELS.items():
            args = base_args(dataset, model, "transe", lr, word_ep, sched,
                             "1e-2")
            name = f"{model}-{ds_slug}.sh"
            emit(os.path.join(out_dir, name), args)
            names.append(name)
            if model.endswith("bow"):
                # The reference ships pretrained-evaluation variants of the
                # BOW models too (e.g. its scripts/bert-bow-wn18rr-pretrained.sh).
                p = dict(args)
                p["max_epochs"] = 0
                p["checkpoint"] = f"'output/model-{model}-{ds_slug}.npz'"
                p["use_cached_text"] = True
                pname = f"{model}-{ds_slug}-pretrained.sh"
                emit(os.path.join(out_dir, pname), p)
                names.append(pname)

    # UMLS smoke test (reference: scripts/test-umls.sh, "<1 min on GPU").
    args = base_args("WN18RR", "bert-bow", "transe", "1e-3", 5, False, "1e-2")
    args.update({"dataset": "'umls'", "inductive": False, "large_dataset": False,
                 "bf16": False})
    emit(os.path.join(out_dir, "test-umls.sh"), args, preamble=UMLS_PREAMBLE)
    names.append("test-umls.sh")
    return names


def main(argv: list[str] | None = None) -> list[str]:
    p = argparse.ArgumentParser()
    p.add_argument("out_dir", help="directory to write the scripts into")
    out_dir = p.parse_args(argv).out_dir
    names = write_all(out_dir)
    print(f"Wrote {len(names)} scripts to {out_dir}/")
    return names


if __name__ == "__main__":
    main()
