"""Resume from marker-less (legacy) state files in the port
(blp_tpu_torch/train.py `load_train_state`): a JAX `link_prediction` run
with the tiny encoder stops after one epoch; its state file is copied
without the layout marker, once stacked and once unstacked; the port loads
each to the file's state, bit for bit, and resumes each for epoch 2. Also
the num_layers == 1 case, where only the leaf shapes tell the layouts
apart, a file that matches neither layout, and a bfloat16 leaf stored
without a dtype record."""

import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from blp_tpu import checkpoint as j_ckpt
from blp_tpu import train as j_train
from blp_tpu import training as j_training
from blp_tpu.config import ExperimentConfig as JExperimentConfig
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu_torch import checkpoint as t_ckpt
from blp_tpu_torch import train as t_train
from blp_tpu_torch import training as t_training
from blp_tpu_torch.config import ExperimentConfig
from blp_tpu_torch.data.datasets import GraphData
from blp_tpu_torch.data.synth import write_synth_dataset
from blp_tpu_torch.models import bert as t_bert
from blp_tpu_torch.models import blp as t_blp

ARGS = dict(dataset="synth", model="blp", rel_model="transe",
            encoder_name="tiny", dim=16, max_len=16, num_negatives=8,
            batch_size=16, emb_batch_size=16, eval_batch_size=8, lr=1e-3,
            tile=16, seed=0, max_epochs=2)


@pytest.fixture(scope="module")
def legacy(tmp_path_factory):
    """The JAX run's state file and its two marker-less copies."""
    root = tmp_path_factory.mktemp("legacy")
    write_synth_dataset(str(root / "data" / "synth"), num_entities=40,
                        num_relations=4, num_triples=160, seed=11)
    out = root / "output"
    j_train.link_prediction(JExperimentConfig(
        **ARGS, data_dir=str(root / "data"), out_dir=str(out), run_id="jax",
        stop_after_epochs=1))
    state = str(out / "train_state-jax.npz")
    tree, meta = j_ckpt.load_pytree(state)
    assert meta.pop("layout") == "stacked"
    files = {"stacked": str(out / "legacy-stacked.npz"),
             "unstacked": str(out / "legacy-unstacked.npz")}
    j_ckpt.save_pytree(files["stacked"], tree, meta)
    j_ckpt.save_pytree(files["unstacked"],
                       (j_training.unstack_params(tree[0]),
                        j_training.unstack_opt_state(tree[1])), meta)
    return root, state, files


def _port_template(root):
    """The port's stacked params template and optimizer for the run."""
    cfg = ExperimentConfig(**ARGS, data_dir=str(root / "data"), device="cpu")
    tok = t_train.make_tokenizer(cfg)
    train = GraphData.load(cfg.triples_file("train"))
    mcfg = t_train.make_model_config(cfg, tok, len(train.rel_ids),
                                     len(train.ent_ids))
    params = t_blp.to_device(t_train.init_model_params(cfg, mcfg, 0, "cpu"),
                             "meta")
    steps = -(-train.num_triples // cfg.batch_size) * cfg.max_epochs
    return params, t_training.make_optimizer(cfg.lr, steps)


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_legacy_file_loads_to_the_file_state(legacy, layout):
    root, state, files = legacy
    assert "layout" not in t_ckpt.peek_metadata(files[layout])
    assert t_ckpt.peek_leaf_shapes(files[layout]) == j_ckpt.peek_leaf_shapes(
        files[layout])
    tmpl, opt = _port_template(root)
    (params, opt_state), meta = t_train.load_train_state(files[layout], tmpl, opt)
    assert meta["epoch"] == 1
    want = jax.tree.leaves(j_ckpt.load_pytree(state)[0])
    got = t_ckpt.tree_leaves((params, opt_state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu" and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # Layers come back stacked, as the marked files are.
    assert not isinstance(params["bert"]["layers"], (tuple, list))


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_port_resumes_legacy_file_at_epoch_two(legacy, layout, capsys):
    root, _, files = legacy
    run_id = f"port-{layout}"
    args = {**ARGS, "data_dir": str(root / "data"),
            "out_dir": str(root / "output"), "device": "cpu",
            "run_id": run_id, "resume": files[layout]}
    assert t_train.main(["link_prediction", "with"]
                        + [f"{k}={v}" for k, v in args.items()]) == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(result["test_mrr_filt"])
    rows = [json.loads(line) for line in
            open(root / "output" / f"metrics-{run_id}.jsonl")]
    assert [r["step"] for r in rows if "train_loss" in r] == [2]
    meta = t_ckpt.peek_metadata(str(root / "output" / f"train_state-{run_id}.npz"))
    assert meta["epoch"] == 2 and meta["layout"] == "stacked"


def _one_layer_files(tmp_path):
    """A 1-layer JAX model's (params, Adam state) written stacked and
    unstacked, without markers: equal leaf counts, different shapes."""
    cfg = j_blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                            dim=8, num_relations=3,
                            encoder=j_bert.BertConfig.tiny(num_layers=1))
    params = j_blp.init_params(jax.random.key(0), cfg)
    state = j_training.make_optimizer(1e-3, 10).init(params)
    stacked = (params, state)
    unstacked = (j_training.unstack_params(params),
                 j_training.unstack_opt_state(state))
    assert len(jax.tree.leaves(stacked)) == len(jax.tree.leaves(unstacked))
    files = {}
    for name, tree in (("stacked", stacked), ("unstacked", unstacked)):
        files[name] = str(tmp_path / f"{name}.npz")
        j_ckpt.save_pytree(files[name], tree, {"epoch": 3})
    t_cfg = t_blp.ModelConfig(model="blp", rel_model="transe", dim=8,
                              num_relations=3,
                              encoder=t_bert.BertConfig.tiny(num_layers=1))
    tmpl = t_blp.init_params(t_cfg, torch.Generator().manual_seed(0),
                             device="meta")
    return stacked, files, tmpl


@pytest.mark.parametrize("layout", ["stacked", "unstacked"])
def test_single_layer_layouts_classify_by_shape(tmp_path, layout):
    stacked, files, tmpl = _one_layer_files(tmp_path)
    opt = t_training.make_optimizer(1e-3, 10)
    (params, opt_state), meta = t_train.load_train_state(files[layout], tmpl, opt)
    assert meta["epoch"] == 3
    for g, w in zip(t_ckpt.tree_leaves((params, opt_state)),
                    jax.tree.leaves(stacked)):
        assert tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_file_of_another_model_names_both_layouts(tmp_path):
    _, files, _ = _one_layer_files(tmp_path)
    t_cfg = t_blp.ModelConfig(model="blp", rel_model="transe", dim=8,
                              num_relations=3,
                              encoder=t_bert.BertConfig.tiny(num_layers=2))
    tmpl = t_blp.init_params(t_cfg, torch.Generator().manual_seed(0),
                             device="meta")
    with pytest.raises(ValueError, match=r"matches neither state layout.*"
                                         r"unstacked: \d+ leaves.*stacked: \d+ "
                                         r"leaves, leaf 5 \(2, 32\) where the "
                                         r"file has \(1, 32\)"):
        t_train.load_train_state(files["stacked"], tmpl,
                                 t_training.make_optimizer(1e-3, 10))


def test_bf16_leaf_without_dtype_record_loads_through_the_template(tmp_path):
    """A legacy file has no __leaf_dtypes__: its bfloat16 leaves read back
    as 2-byte void arrays and take the template leaf's dtype, as JAX's
    _restore_dtypes does; through a template leaf of another item size
    they raise."""
    mu = np.random.default_rng(0).standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    count = np.asarray(7, np.int32)
    path = str(tmp_path / "legacy-bf16.npz")
    np.savez(path, __metadata__=json.dumps({"epoch": 1}),
             __structure__="null", leaf_00000=count, leaf_00001=mu)
    with np.load(path) as data:
        assert data["leaf_00001"].dtype == np.dtype("V2")
    tmpl = (torch.empty((), dtype=torch.int32, device="meta"),
            torch.empty((3, 5), dtype=torch.bfloat16, device="meta"))
    (c, m), _ = t_ckpt.load_pytree(path, template=tmpl)
    assert c.dtype == torch.int32 and c.shape == () and int(c) == 7
    assert m.dtype == torch.bfloat16
    np.testing.assert_array_equal(m.view(torch.uint16).numpy(),
                                  mu.view(np.uint16))
    (j_c, j_m), _ = j_ckpt.load_pytree(path, template=(count, mu))
    np.testing.assert_array_equal(m.float().numpy(), j_m.astype(np.float32))
    with pytest.raises(ValueError, match="cannot restore a leaf stored as"):
        t_ckpt.load_pytree(path, template=(tmpl[0], torch.empty(
            (3, 5), dtype=torch.float32, device="meta")))
