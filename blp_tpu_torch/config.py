"""Experiment configuration + sacred-style CLI overrides (copy of
blp_tpu/config.py for the PyTorch port).

The reference uses sacred (`@ex.config` in train.py:35-55, CLI form
`python train.py link_prediction with key=value ...`). This module provides
the same ergonomics without the dependency: a typed dataclass of defaults and
a `with k=v` parser, so the reference's 48 launcher scripts translate 1:1.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass
class ExperimentConfig:
    """The TPU package's experiment keys, so its command lines parse here
    unchanged, plus `device`."""

    # Reference defaults (train.py:35-55).
    dataset: str = "umls"
    inductive: bool = True
    dim: int = 128
    model: str = "blp"              # blp | bert-bow | bert-dkrl | glove-bow | glove-dkrl | transductive
    rel_model: str = "transe"
    loss_fn: str = "margin"
    encoder_name: str = "bert-base-cased"
    regularizer: float = 0.0
    max_len: int = 32
    num_negatives: int = 64
    lr: float = 2e-5
    use_scheduler: bool = True
    batch_size: int = 64
    emb_batch_size: int = 2048          # entities per phase-1 encode chunk
    eval_batch_size: int = 64
    max_epochs: int = 40
    checkpoint: str | None = None
    use_cached_text: bool = False
    resume: str | None = None           # train_state-*.npz to continue mid-run
    stop_after_epochs: int | None = None

    data_dir: str = "data"
    out_dir: str = "output"
    run_id: str | None = None
    seed: int = 0
    vocab_file: str | None = None       # WordPiece vocab (offline); default <dataset>/vocab.txt
    glove_file: str | None = None       # GloVe tensor .pt for glove-* models
    hf_weights: str | None = None       # local HF BertModel state dict (.pt/.bin) for model=blp
    bf16: bool = False                  # bfloat16 encoder compute
    remat: bool | int | str = False     # BertConfig.remat: k, True, "dots", "names"
    fast_train: bool = False            # BertConfig.fast_train (training)
    dropout_bits: int = 32              # BertConfig.dropout_bits (training)
    adam_bf16_mu: bool = False          # bfloat16 Adam first moment (training)
    tile: int = 65536                   # ranking tile width (candidates per streamed block)
    eval_every: int = 1                 # epochs between validation evals
    large_dataset: bool = False         # Wikidata5M mode: no global filter graph
    num_data_shards: int = 1            # mesh: data x model, or data x pipe
    num_model_shards: int = 1
    num_pipe_shards: int = 1
    num_microbatches: int = 4           # GPipe microbatches (num_pipe_shards > 1)
    log_every_frac: float = 0.05        # batch-loss logging interval
    coordinator_address: str | None = None  # multi-host: host:port of rank 0
    num_processes: int | None = None
    process_id: int | None = None
    multihost_data: bool = False        # each rank reads only its batch rows
    device: str = "cuda"                # "cpu" runs the plain PyTorch paths

    @property
    def dataset_dir(self) -> str:
        return f"{self.data_dir}/{self.dataset}"

    def triples_file(self, split: str) -> str:
        prefix = "ind-" if self.inductive and self.model != "transductive" else ""
        return f"{self.dataset_dir}/{prefix}{split}.tsv"


# "1"/"0" deliberately NOT mapped to bools: remat takes an int layer count
# (remat=1 must mean partial remat of one layer, not True), and a bare 1/0
# for a genuine bool field still behaves correctly as a truthy/falsy int.
_BOOL = {"true": True, "false": False, "yes": True, "no": False}


def _coerce(value: str, field_type: Any):
    if value.lower() in ("none", "null"):
        return None
    # PEP-563 (from __future__ import annotations) leaves field types as
    # STRINGS, so match both live types and annotation text ("bool",
    # "bool | int", "bool = False" unions).
    is_boolish = (
        field_type is bool
        or (isinstance(field_type, str) and "bool" in field_type)
        or bool in getattr(field_type, "__args__", ()))
    if is_boolish and value.lower() in _BOOL:
        return _BOOL[value.lower()]
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value


def parse_overrides(argv: list[str], config: ExperimentConfig | None = None) -> ExperimentConfig:
    """Parse `with key=value ...` CLI segments into a config.

    Accepts both `with k=v` (sacred style) and bare `k=v` arguments.
    Unknown keys raise — typos should not be silent.
    """
    cfg = config or ExperimentConfig()
    fields = {f.name: f for f in dataclasses.fields(cfg)}
    args = [a for a in argv if a != "with"]
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"Expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        if key not in fields:
            raise ValueError(f"Unknown config key {key!r}. Valid keys: "
                             f"{', '.join(sorted(fields))}")
        setattr(cfg, key, _coerce(value, fields[key].type))
    return cfg
