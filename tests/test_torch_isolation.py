"""The port stands alone: every blp_tpu_torch module (tools included),
chip_smoke.py and the kernel probes import with JAX and scikit-learn blocked
and load nothing of blp_tpu; and an entry point
called without `device` runs on CUDA or raises — never silently on the
CPU."""

import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from blp_tpu_torch import (evaluation, linear_model, profiling, retrieval,
                           serve, train, training)
from blp_tpu_torch.config import ExperimentConfig
from blp_tpu_torch.data import sampling
from blp_tpu_torch.models import bert, blp
from blp_tpu_torch.parallel import mesh as mesh_lib
from blp_tpu_torch.parallel import pipeline
from blp_tpu_torch.utils import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, json, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now fails
sys.modules["sklearn"] = None      # the port does not depend on scikit-learn
import blp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(blp_tpu_torch.__path__,
                                                "blp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke, f3_probe, k1_probe, k2_probe, mesh_probe, word_grad_probe
leaked = sorted(m for m in sys.modules
                if m == "blp_tpu" or m.startswith(("blp_tpu.", "jax.", "jaxlib")))
print(json.dumps({"names": names, "leaked": leaked}))
"""

#: The multi-device modules (parallel/*), among the modules imported above.
PARALLEL = {f"blp_tpu_torch.parallel.{m}" for m in
            ("comm", "mesh", "multihost", "train_parallel", "eval_parallel",
             "pipeline")}
#: The modules that complete the port: profiling, the native packer, the
#: split tooling and the reference-checkpoint converter.
COMPLETING = {"blp_tpu_torch.profiling", "blp_tpu_torch.native",
              "blp_tpu_torch.data.splits",
              "blp_tpu_torch.tools.convert_reference_checkpoint"}
#: The Wikidata5M and UMLS tools and the launcher generator.
W5M_TOOLS = {f"blp_tpu_torch.tools.{m}" for m in
             ("w5m_e2e_eval", "w5m_scale_check", "w5m_mode_rehearsal",
              "umls_smoke", "gen_scripts")}

#: The kernels' wrappers, the layer's fused chains (F1, F2, F3) among them.
KERNEL_OPS = {f"blp_tpu_torch.ops.{m}" for m in
              ("transe_rank", "packed_attention", "sddmm", "fused_layer",
               "attn_softmax")}


def test_port_imports_without_jax_or_blp_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    found = json.loads(out.stdout.strip().splitlines()[-1])
    assert len(found["names"]) >= 45
    assert PARALLEL <= set(found["names"])
    assert COMPLETING <= set(found["names"])
    assert W5M_TOOLS <= set(found["names"])
    assert KERNEL_OPS <= set(found["names"])
    assert found["leaked"] == []


def _tiny():
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=8,
                          num_relations=2, encoder=bert.BertConfig.tiny())
    return cfg, blp.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("entry", ["LinkPredictor", "encode",
                                   "eval_link_prediction", "init_params",
                                   "make_train_step", "link_prediction",
                                   "sample_negative_indices",
                                   "node_classification", "LogisticRegression",
                                   "rerank", "device_memory_stats"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    cfg, params = _tiny()
    calls = {
        "LinkPredictor": lambda: serve.LinkPredictor(params=params, cfg=cfg),
        "encode": lambda: blp.encode(params, cfg, np.ones((4, 8), np.int64), None),
        "eval_link_prediction": lambda: evaluation.eval_link_prediction(
            params, cfg, np.zeros((1, 3), np.int64), None, np.arange(4)),
        "init_params": lambda: blp.init_params(cfg, torch.Generator()),
        "make_train_step": lambda: training.make_train_step(
            cfg, training.make_optimizer(1e-3, 10), batch_size=4,
            num_negatives=2),
        "link_prediction": lambda: train.link_prediction(
            ExperimentConfig(out_dir=str(tmp_path))),
        "sample_negative_indices": lambda: sampling.sample_negative_indices(
            torch.Generator(), 4, 2),
        "node_classification": lambda: train.node_classification(
            ExperimentConfig(out_dir=str(tmp_path))),
        "LogisticRegression": lambda: linear_model.LogisticRegression().fit(
            np.eye(2), np.arange(2)),
        "rerank": lambda: retrieval.rerank(retrieval.RetrievalConfig(
            out_dir=str(tmp_path))),
        "device_memory_stats": lambda: profiling.device_memory_stats(),
    }
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()


@pytest.mark.parametrize("fn", [mesh_lib.make_mesh, pipeline.make_pipeline_mesh,
                                pipeline.make_pipeline_train_step])
def test_parallel_mesh_functions_default_to_cuda(fn):
    """The mesh and pipeline functions take device=None, which
    resolve_device turns into cuda; without a card a mesh built with no
    device raises rather than running on the CPU."""
    assert inspect.signature(fn).parameters["device"].default is None
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(inspect.signature(fn).parameters["device"].default)
    if fn is not pipeline.make_pipeline_train_step:   # that one needs a mesh
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(1, 1)   # a one-rank mesh in this one-process world
