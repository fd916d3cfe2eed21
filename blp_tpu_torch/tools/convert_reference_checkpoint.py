"""Convert a reference (dfdazac/blp) PyTorch checkpoint to a blp_tpu_torch
one (the port's copy of tools/convert_reference_checkpoint.py).

The reference releases trained weights as `torch.save(model.state_dict())`
of its PyTorch modules (reference train.py:340; README "Using pretrained
models"). This tool maps those state dicts onto the port's parameter tree
and writes a `model-*.npz` that `checkpoint=` loads, so a user of the
reference evaluates an existing checkpoint without retraining:

    python -m blp_tpu_torch.tools.convert_reference_checkpoint \\
        --model blp --input model.pt --output output/model-blp.npz
    python -m blp_tpu_torch.train link_prediction with model=blp \\
        max_epochs=0 checkpoint=output/model-blp.npz ...

State-dict layouts handled (reference models.py):
  blp          rel_emb.weight, encoder.<HF BertModel ...>, enc_linear.weight
               (models.py:96-111; enc_linear is (dim, hidden) -> transposed)
  *-bow        rel_emb.weight, embeddings.weight          (models.py:114-155)
  *-dkrl       + conv1/conv2 Conv1d (out, in, 2) -> stacked (2*in, out)
               matmul form used by encoders.dkrl_encode   (models.py:158-204)
  transductive rel_emb.weight, ent_emb.weight             (models.py:207-219)

A leading `module.` prefix (torch.nn.DataParallel wrapping, reference
train.py:329-330) is stripped. The file is the format of checkpoint.py, so
the TPU package loads it too.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from blp_tpu_torch import checkpoint as ckpt
from blp_tpu_torch.models import bert


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float32).contiguous()
    return torch.as_tensor(np.asarray(t, np.float32))


def _strip_module(sd: dict) -> dict:
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in sd.items()}


def _conv1d_to_matmul(w) -> torch.Tensor:
    """torch Conv1d weight (out, in, k=2) -> (2*in, out) for the
    shifted-concat matmul formulation of encoders.dkrl_encode."""
    w = _f32(w)
    return torch.cat([w[:, :, 0].T, w[:, :, 1].T], dim=0).contiguous()


def convert_state_dict(sd: dict, model: str) -> dict:
    """Reference state dict -> the port's parameter tree (float32 CPU
    tensors)."""
    sd = _strip_module(sd)
    params: dict = {"rel_emb": _f32(sd["rel_emb.weight"])}

    if model == "blp":
        hf_sd = {k[len("encoder."):]: v for k, v in sd.items()
                 if k.startswith("encoder.")}
        hidden = _f32(sd["enc_linear.weight"]).shape[1]
        n_layers = 1 + max(int(k.split(".")[2]) for k in hf_sd
                           if k.startswith("encoder.layer."))
        cfg = bert.BertConfig(
            vocab_size=hf_sd["embeddings.word_embeddings.weight"].shape[0],
            hidden_size=hidden, num_layers=n_layers,
            num_heads=max(hidden // 64, 1),  # BERT convention: head_dim 64
            intermediate_size=hf_sd[
                "encoder.layer.0.intermediate.dense.weight"].shape[0],
            max_position_embeddings=hf_sd[
                "embeddings.position_embeddings.weight"].shape[0])
        params["bert"] = bert.params_from_hf_state_dict(hf_sd, cfg)
        params["proj"] = _f32(sd["enc_linear.weight"]).T.contiguous()  # (hidden, dim)
    elif model.endswith("bow"):
        params["word_emb"] = _f32(sd["embeddings.weight"])
    elif model.endswith("dkrl"):
        params["word_emb"] = _f32(sd["embeddings.weight"])
        params["dkrl"] = {
            "conv1_w": _conv1d_to_matmul(sd["conv1.weight"]),
            "conv1_b": _f32(sd["conv1.bias"]),
            "conv2_w": _conv1d_to_matmul(sd["conv2.weight"]),
            "conv2_b": _f32(sd["conv2.bias"]),
        }
    elif model == "transductive":
        params["ent_emb"] = _f32(sd["ent_emb.weight"])
    else:
        raise ValueError(f"unknown model {model!r}")
    return params


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--model", required=True,
                    choices=["blp", "bert-bow", "bert-dkrl", "glove-bow",
                             "glove-dkrl", "transductive"])
    ap.add_argument("--input", required=True, help="reference .pt state dict")
    ap.add_argument("--output", required=True, help="blp_tpu_torch .npz checkpoint")
    args = ap.parse_args(argv)

    sd = torch.load(args.input, map_location="cpu", weights_only=False)
    if not isinstance(sd, dict) or "rel_emb.weight" not in _strip_module(sd):
        raise ValueError(f"{args.input} is not a reference BLP state dict")
    params = convert_state_dict(sd, args.model)
    ckpt.save_pytree(args.output, params,
                     metadata={"source": args.input, "model": args.model,
                               "converted_from": "dfdazac/blp state_dict"})
    shapes = {k: tuple(v.shape) for k, v in params.items()
              if not isinstance(v, dict)}
    print(json.dumps({"output": args.output, "model": args.model,
                      "top_level": sorted(params), "shapes": str(shapes)}))


if __name__ == "__main__":
    main()
