"""The port's `link_prediction` over a mesh (blp_tpu_torch/train.py with
parallel/*), mirroring tests/test_train_parallel_e2e.py: a world of 2 gloo
CPU ranks trains with num_data_shards=2, num_model_shards=2 and
num_pipe_shards=2 for the first of two epochs, its loss within rtol 1e-5 of
the one-process run of the same seed (the step's tolerance; dropout is on,
and the ranks draw the one-device masks); rank 0's checkpoint resumes on one
process for the second epoch, and a state written by one process resumes
under tensor parallelism, each within the same tolerance of the
one-process second epoch; a run stopped after an epoch and resumed on the
same mesh equals a straight run (parameters within rtol 1e-6, atol 1e-7, as
JAX's test); a mesh whose size is not the world's raises naming both. In one process: the per-host data path
(multihost_data=True) gives the plain path's losses, and the mesh keys that
exclude each other raise as JAX's do."""

import json

import numpy as np
import pytest

import torch_dist_workers as workers
from blp_tpu_torch import checkpoint as t_ckpt
from blp_tpu_torch import train as t_train
from blp_tpu_torch.config import ExperimentConfig
from blp_tpu_torch.data.synth import write_synth_dataset


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("pe2e")
    write_synth_dataset(str(root / "data" / "synth"), num_entities=36,
                        num_relations=3, num_triples=140, seed=13)
    return root


def _cfg(workdir, **kw):
    base = dict(
        dataset="synth", data_dir=str(workdir / "data"),
        out_dir=str(workdir / "output"), model="blp", rel_model="transe",
        encoder_name="tiny", dim=16, max_len=16, num_negatives=8,
        batch_size=16, emb_batch_size=16, eval_batch_size=8, max_epochs=1,
        lr=1e-3, tile=8, seed=5, device="cpu")
    base.update(kw)
    return ExperimentConfig(**base)


def _losses(workdir, run_id):
    path = workdir / "output" / f"metrics-{run_id}.jsonl"
    rows = [json.loads(line) for line in open(path)]
    return {r["step"]: r["train_loss"] for r in rows if "train_loss" in r}


MESH_RUNS = {"dp": dict(num_data_shards=2),
             "tp": dict(num_model_shards=2),
             "pp": dict(num_pipe_shards=2, num_microbatches=2)}


@pytest.fixture(scope="module")
def world(workdir, tmp_path_factory):
    """The mesh runs, in one world of two ranks."""
    configs = [_cfg(workdir, run_id=k, max_epochs=2, stop_after_epochs=1, **kw)
               for k, kw in MESH_RUNS.items()]
    configs += [
        _cfg(workdir, run_id="mesh-full", max_epochs=2, **MESH_RUNS["dp"]),
        _cfg(workdir, run_id="mesh-half", max_epochs=2, stop_after_epochs=1,
             **MESH_RUNS["dp"]),
        _cfg(workdir, run_id="mesh-res", max_epochs=2, **MESH_RUNS["dp"],
             resume=str(workdir / "output" / "train_state-mesh-half.npz")),
        _cfg(workdir, run_id="bad", num_data_shards=4),
    ]
    # A state written by one process, resumed under TP on the mesh.
    t_train.link_prediction(_cfg(workdir, run_id="one-half", max_epochs=2,
                                 stop_after_epochs=1))
    configs.append(_cfg(workdir, run_id="one-res", max_epochs=2,
                        resume=str(workdir / "output" / "train_state-one-half.npz"),
                        **MESH_RUNS["tp"]))
    ranks = workers.run_world(workers.link_prediction_runs, 2,
                              tmp_path_factory.mktemp("cli"), configs, ("bad",))
    return {c.run_id: [r[i] for r in ranks] for i, c in enumerate(configs)}


@pytest.fixture(scope="module")
def single(workdir):
    """Two epochs on one process: {epoch: loss}."""
    t_train.link_prediction(_cfg(workdir, run_id="single", max_epochs=2))
    return _losses(workdir, "single")


@pytest.mark.parametrize("run", list(MESH_RUNS))
def test_mesh_driver_matches_one_process(workdir, world, single, run):
    got = _losses(workdir, run)
    assert list(got) == [1]
    assert np.isclose(got[1], single[1], rtol=1e-5), (got, single)
    a, b = world[run]
    assert a == b and a["test_mrr"] > 0


@pytest.mark.parametrize("run", list(MESH_RUNS))
def test_mesh_checkpoint_resumes_on_one_process(workdir, world, single, run):
    """Rank 0 wrote the one-device format: one process continues it to the
    second epoch, whose loss is the one-process run's."""
    two = single
    meta = t_ckpt.peek_metadata(str(workdir / "output" / f"train_state-{run}.npz"))
    assert meta["layout"] == "stacked" and meta["epoch"] == 1
    t_train.link_prediction(_cfg(workdir, run_id=run, max_epochs=2,
                                 resume="auto"))
    got = _losses(workdir, run)
    assert np.isclose(got[2], two[2], rtol=1e-5), (got, two)


def test_resume_under_mesh_equals_straight_run(workdir, world):
    """Stopped after one epoch and resumed on the same mesh: the second
    epoch, the test MRR and the state equal a straight run's."""
    full, res = _losses(workdir, "mesh-full"), _losses(workdir, "mesh-res")
    assert list(res) == [2]
    assert np.isclose(res[2], full[2], rtol=1e-6)
    assert np.isclose(world["mesh-res"][0]["test_mrr"],
                      world["mesh-full"][0]["test_mrr"], atol=1e-6)
    p_full, _ = t_ckpt.load_pytree(str(workdir / "output" / "train_state-mesh-full.npz"))
    p_res, _ = t_ckpt.load_pytree(str(workdir / "output" / "train_state-mesh-res.npz"))
    for a, b in zip(t_ckpt.tree_leaves(p_full), t_ckpt.tree_leaves(p_res)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_one_process_state_resumes_on_the_mesh(workdir, world, single):
    two = single
    got = _losses(workdir, "one-res")
    assert list(got) == [2] and np.isclose(got[2], two[2], rtol=1e-5)


def test_mesh_size_must_equal_world_size(world):
    for rank in world["bad"]:
        assert "(4 ranks) != world size 2" in rank["error"]


def test_multihost_data_path_matches_plain(workdir):
    kw = dict(model="bert-bow", rel_model="transe", max_epochs=2)
    r_plain = t_train.link_prediction(_cfg(workdir, run_id="mh-plain", **kw))
    r_mh = t_train.link_prediction(_cfg(workdir, run_id="mh-local",
                                        multihost_data=True, **kw))
    assert _losses(workdir, "mh-local") == _losses(workdir, "mh-plain")
    assert r_mh["test_mrr"] == r_plain["test_mrr"]
    assert r_mh["test_mrr_filt"] == r_plain["test_mrr_filt"]


def test_pipe_and_model_shards_mutually_exclusive(workdir):
    with pytest.raises(ValueError, match="mutually exclusive"):
        t_train.link_prediction(_cfg(workdir, run_id="pp-tp", num_pipe_shards=2,
                                     num_model_shards=2))


def test_pipe_requires_blp_model(workdir):
    with pytest.raises(ValueError, match="model='blp'"):
        t_train.link_prediction(_cfg(workdir, run_id="pp-bow", model="bert-bow",
                                     num_pipe_shards=2))
