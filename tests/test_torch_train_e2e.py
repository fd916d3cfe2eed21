"""The slice as a whole: the port's `link_prediction` command
(blp_tpu_torch/train.py) end to end on the CPU on a small synthetic graph,
its resume, and its state files crossing to and from the JAX package
(blp_tpu/checkpoint.py with JAX's own (params, optimizer.init(params))
template)."""

import json
import os

import jax
import numpy as np
import pytest

from blp_tpu import checkpoint as j_ckpt
from blp_tpu import train as j_train
from blp_tpu import training as j_training
from blp_tpu.config import ExperimentConfig as JExperimentConfig
from blp_tpu_torch import checkpoint as t_ckpt
from blp_tpu_torch import train as t_train
from blp_tpu_torch.data.synth import write_synth_dataset

ARGS = dict(dataset="synth", model="blp", rel_model="transe",
            encoder_name="tiny", dim=16, max_len=16, num_negatives=8,
            batch_size=16, emb_batch_size=16, eval_batch_size=8, lr=1e-3,
            tile=16, seed=0)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_e2e")
    write_synth_dataset(str(root / "data" / "synth"), num_entities=40,
                        num_relations=4, num_triples=160, seed=11)
    return root


def _argv(workdir, **kw):
    args = {**ARGS, "data_dir": str(workdir / "data"),
            "out_dir": str(workdir / "output"), "device": "cpu", **kw}
    return ["link_prediction", "with"] + [f"{k}={v}" for k, v in args.items()]


def _run(workdir, capsys, **kw):
    assert t_train.main(_argv(workdir, **kw)) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _metrics(workdir, run_id):
    path = workdir / "output" / f"metrics-{run_id}.jsonl"
    return [json.loads(line) for line in open(path)]


def test_one_epoch_writes_the_four_artifacts(workdir, capsys):
    result = _run(workdir, capsys, run_id="e2e", max_epochs=1)
    out = workdir / "output"
    for name in ("metrics-e2e.jsonl", "model-e2e.npz", "train_state-e2e.npz",
                 "ent_emb-e2e.npz"):
        assert os.path.exists(out / name), name
    assert result["test_mrr"] > 0 and np.isfinite(result["test_mrr_filt"])
    keys = set().union(*(row.keys() for row in _metrics(workdir, "e2e")))
    assert {"batch_loss", "train_loss", "valid_mrr", "test_mrr_filt"} <= keys
    emb = np.load(out / "ent_emb-e2e.npz")
    assert emb["ent_emb"].shape == (len(emb["entities"]), 16)
    meta = t_ckpt.peek_metadata(str(out / "train_state-e2e.npz"))
    assert meta["layout"] == "stacked" and meta["epoch"] == 1


def test_resume_auto_continues_at_epoch_two(workdir, capsys):
    _run(workdir, capsys, run_id="resume", max_epochs=1)
    _run(workdir, capsys, run_id="resume", max_epochs=2, resume="auto")
    epochs = [row["step"] for row in _metrics(workdir, "resume")
              if "train_loss" in row]
    assert epochs == [1, 2]   # the second run trained epoch 2 only
    meta = t_ckpt.peek_metadata(str(workdir / "output" / "train_state-resume.npz"))
    assert meta["epoch"] == 2


def _jax_state_template(workdir):
    """JAX's own (params, optimizer.init(params)) for the same run."""
    cfg = JExperimentConfig(**{**ARGS, "data_dir": str(workdir / "data"),
                               "max_epochs": 1})
    tok = j_train.make_tokenizer(cfg)
    from blp_tpu.data.datasets import GraphData

    train = GraphData.load(cfg.triples_file("train"))
    mcfg = j_train.make_model_config(cfg, tok, len(train.rel_ids),
                                     len(train.ent_ids))
    params = j_train.init_model_params(cfg, mcfg, jax.random.key(0))
    opt = j_training.make_optimizer(cfg.lr, 10, cfg.use_scheduler)
    return params, opt.init(params)


def test_state_files_cross_between_packages(workdir, capsys):
    _run(workdir, capsys, run_id="cross", max_epochs=1)
    port_file = str(workdir / "output" / "train_state-cross.npz")
    tmpl = _jax_state_template(workdir)
    (jp, js), meta = j_ckpt.load_pytree(port_file, template=tmpl)
    assert int(js[0].count) > 0 and int(js[1].count) == int(js[0].count)
    port_tree, _ = t_ckpt.load_pytree(port_file)
    for a, b in zip(jax.tree.leaves((jp, js)), t_ckpt.tree_leaves(port_tree)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # The JAX package writes it back; the port resumes from that file.
    jax_file = str(workdir / "output" / "jax_state.npz")
    j_ckpt.save_pytree(jax_file, (jp, js), meta)
    _run(workdir, capsys, run_id="from-jax", max_epochs=2, resume=jax_file)
    epochs = [row["step"] for row in _metrics(workdir, "from-jax")
              if "train_loss" in row]
    assert epochs == [2]


@pytest.mark.parametrize("key,value,match", [
    ("num_data_shards", 2, r"\(2 ranks\) != world size 1"),
    ("num_model_shards", 2, r"\(2 ranks\) != world size 1"),
    ("num_pipe_shards", 2, r"\(2 ranks\) != world size 1"),
    ("coordinator_address", "localhost:1234", "num_processes and process_id")])
def test_mesh_and_multihost_keys_raise(workdir, key, value, match):
    # The mesh keys run over a world of that size
    # (tests/test_torch_train_parallel_e2e.py); one process is not one, and
    # the multi-host keys need the world's size and this process's rank.
    with pytest.raises(ValueError, match=match):
        t_train.main(_argv(workdir, run_id="x", **{key: value}))


def test_node_classification_raises_and_unknown_command_is_usage(workdir):
    # Without an embedding export for the named run there is nothing to
    # classify (tests/test_torch_linear_model.py runs it on a real export).
    with pytest.raises(FileNotFoundError, match="no embedding export"):
        t_train.main(["node_classification", "with", "device=cpu",
                      f"out_dir={workdir / 'output'}", "checkpoint=missing"])
    assert t_train.main(["nope"]) == 2
