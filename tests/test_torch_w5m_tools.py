"""The port's Wikidata5M and UMLS tools (blp_tpu_torch/tools/) against the
TPU package's (tools/*.py), on the CPU at tiny sizes: the same synthetic
inputs bit for bit, the same flags and JSON keys, and for w5m_e2e_eval the
same filtered MRR from the same weights; gen_scripts' launchers equal the
TPU package's with the module name swapped, and every key of every script
parses to the value the TPU package's parser gives."""

import dataclasses
import filecmp
import importlib.util
import json
import os
import shlex
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from blp_tpu.config import parse_overrides as j_parse_overrides
from blp_tpu.data.synth import write_synth_dataset as j_write_synth_dataset
from blp_tpu.models import bert as j_bert
from blp_tpu.models import blp as j_blp
from blp_tpu_torch import train
from blp_tpu_torch.config import parse_overrides as t_parse_overrides
from blp_tpu_torch.models import blp as t_blp
from blp_tpu_torch.tools import (gen_scripts, umls_smoke, w5m_e2e_eval,
                                 w5m_mode_rehearsal, w5m_scale_check)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread for the module: torch's intra-op threads, one per
    core in each of several test workers on one machine, oversubscribe its
    cores and slow this module's runs several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name: str):
    """The TPU package's tools/<name>.py as a module (it is no package)."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _run_jax_main(monkeypatch, capsys, module, argv: list[str]) -> dict:
    monkeypatch.setattr(sys, "argv", [module.__file__, *argv])
    module.main()
    return _last_json(capsys.readouterr().out)


def test_synth_text_store_is_the_jax_tools(capsys):
    jax_tool = _jax_tool("w5m_e2e_eval")
    for n, max_len in ((1000, 64), (257, 32)):
        got = w5m_e2e_eval.SynthTextStore(n, max_len, 1024)
        want = jax_tool.SynthTextStore(n, max_len, 1024)
        np.testing.assert_array_equal(got.tok, want.tok)
        np.testing.assert_array_equal(got.lengths, want.lengths)
        ids = np.arange(0, n, 7)
        for a, b in zip(got.get_entity_descriptions(ids),
                        want.get_entity_descriptions(ids)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_e2e_eval_tiny_gives_the_jax_tools_mrr(monkeypatch, capsys):
    argv = ["--tiny", "--cpu", "--n", "1000", "--triples", "60", "--tile",
            "256", "--emb-batch", "256"]
    want = _run_jax_main(monkeypatch, capsys, _jax_tool("w5m_e2e_eval"), argv)
    # The TPU tool's weights: its tiny config, initialised from key 0.
    cfg = j_blp.ModelConfig(model="blp", rel_model="transe", loss_fn="margin",
                            dim=128, num_relations=822,
                            encoder=j_bert.BertConfig.tiny(vocab_size=1024))
    params = t_blp.params_from_jax(jax.tree.map(
        np.asarray, j_blp.init_params(jax.random.key(0), cfg)))
    got = w5m_e2e_eval.main(argv, params=params)
    assert set(want) <= set(got)
    assert got["n_candidates"] == 1000 and got["n_triples"] == 60
    assert got["mrr_filt"] == want["mrr_filt"]
    assert 0 < got["mrr_filt"] < 1


def test_scale_check_keys_and_bidir_agreement(monkeypatch, capsys):
    argv = ["--n", "5000", "--tile", "1024", "--batch", "8", "--bidir", "--cpu"]
    want = _run_jax_main(monkeypatch, capsys, _jax_tool("w5m_scale_check"), argv)
    got = w5m_scale_check.main(argv)
    assert set(got) == set(want)
    for key in ("n_candidates", "batch", "tile", "table_gb"):
        assert got[key] == want[key]
    assert got["fused_vs_two_pass_count_mismatches"] == 0
    assert got["rank_pass_s"] > 0


def test_umls_smoke_writes_the_jax_tools_graph_and_keys(tmp_path, capsys,
                                                       monkeypatch):
    got = umls_smoke.main(["--out", str(tmp_path / "port"), "--epochs", "1",
                           "--cpu"])
    assert _last_json(capsys.readouterr().out) == got
    want_dir = j_write_synth_dataset(str(tmp_path / "jax"), num_entities=135,
                                     num_relations=46, num_triples=5216, seed=1)
    port_dir = tmp_path / "port" / "data" / "umls-like"
    names = sorted(f for f in os.listdir(want_dir))
    _, mismatch, errors = filecmp.cmpfiles(want_dir, port_dir, names,
                                           shallow=False)
    assert mismatch == errors == []
    assert set(got) == {"metric", "value", "unit", "reference_claim",
                        "test_mrr_filt"}
    assert got["metric"] == "umls_smoke_seconds" and got["value"] > 0
    assert 0 < got["test_mrr_filt"] < 1
    rows = [json.loads(line) for line in
            open(tmp_path / "port" / "run" / "metrics-umls-smoke.jsonl")]
    config = next(r["config"] for r in rows if "config" in r)
    # The config row holds each value's repr.
    assert config["model"] == "'bert-bow'" and config["device"] == "'cpu'"


REHEARSAL = ["--cpu", "--entities", "600", "--types", "20", "--triples",
             "2400", "--inductive-frac", "0.1"]


def test_rehearsal_runs_the_mode_and_resumes(tmp_path, capsys, monkeypatch):
    # The tool's BERT-base encoder, swapped for the tiny one at this size.
    full = train.link_prediction
    monkeypatch.setattr(train, "link_prediction", lambda cfg: full(
        dataclasses.replace(cfg, encoder_name="tiny")))
    out = tmp_path / "reh"
    argv = REHEARSAL + ["--out", str(out), "--bar", "0"]
    first = w5m_mode_rehearsal.main(argv + ["--epochs", "1"])
    # The graph is the TPU tool's (numpy seed 31).
    want = j_write_synth_dataset(
        str(tmp_path / "jax"), num_entities=600, num_relations=20,
        num_triples=2400, num_types=20, distinct_type_pairs=True,
        desc_words=(1, 3), inductive_frac=0.1, seed=31)
    port = out / "data" / "typed0k-t0k-f0.1"
    names = sorted(os.listdir(want))
    _, mismatch, errors = filecmp.cmpfiles(want, port, names, shallow=False)
    assert mismatch == errors == []
    # resume="auto": a second call with more epochs trains epoch 2 only.
    second = w5m_mode_rehearsal.main(argv + ["--epochs", "2"])
    assert {"test_mrr", "test_mrr_filt", "wall_s", "type_ceiling_mrr",
            "bar", "run_id", "checkpoint"} <= set(second)
    assert second["type_ceiling_mrr"] == 0.1332 and first["bar"] == 0.0
    rows = [json.loads(line) for line in
            open(out / "run" / "metrics-w5m-mode.jsonl")]
    assert [r["step"] for r in rows if "train_loss" in r] == [1, 2]
    assert not [k for r in rows for k in r if k.startswith("train_mrr")]
    configs = [r["config"] for r in rows if "config" in r]
    assert len(configs) == 2 and all(
        (c["large_dataset"], c["use_cached_text"], c["resume"])
        == ("True", "True", "'auto'") for c in configs)
    # Below the bar the tool exits non-zero.
    capsys.readouterr()
    with pytest.raises(SystemExit, match="quality regression"):
        w5m_mode_rehearsal.main(REHEARSAL + ["--out", str(out), "--epochs", "2",
                                             "--bar", "1.0"])


def _script_keys(path: str) -> list[str]:
    """The `key=value` words of a launcher's python command, as the shell
    splits them."""
    text = open(path).read()
    command = text[text.index("python -m "):].replace("\\\n", " ")
    words = shlex.split(command)
    assert words[:5] in (["python", "-m", m, "link_prediction", "with"]
                         for m in ("blp_tpu.train", "blp_tpu_torch.train"))
    return words[5:]


def test_gen_scripts_matches_jax_with_the_module_swapped(tmp_path):
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                        "gen_scripts.py"),
                           str(jax_dir)], capture_output=True, text=True,
                          timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    names = gen_scripts.main([str(port_dir)])
    assert sorted(names) == sorted(os.listdir(jax_dir))
    assert len(names) == 43
    for name in names:
        port_text = (port_dir / name).read_text()
        assert "python -m blp_tpu_torch.train link_prediction" in port_text
        assert port_text.replace("blp_tpu_torch", "blp_tpu") == (
            jax_dir / name).read_text(), name
        assert os.access(port_dir / name, os.X_OK)

        words = _script_keys(str(port_dir / name))
        assert words == _script_keys(str(jax_dir / name))
        want = dataclasses.asdict(j_parse_overrides(words))
        got = dataclasses.asdict(t_parse_overrides(words))
        for word in words:
            key = word.split("=", 1)[0]
            assert got[key] == want[key] and type(got[key]) is type(want[key]), (
                name, key)
        assert got["device"] == "cuda"


def test_gen_scripts_needs_a_directory(capsys):
    with pytest.raises(SystemExit):
        gen_scripts.main([])
