"""The port stands alone: every blp_tpu_torch module and chip_smoke.py
import with JAX blocked and load nothing of blp_tpu; and an entry point
called without `device` runs on CUDA or raises — never silently on the
CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from blp_tpu_torch import evaluation, serve
from blp_tpu_torch.models import bert, blp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now fails
import blp_tpu_torch
names = [m.name for m in pkgutil.walk_packages(blp_tpu_torch.__path__,
                                                "blp_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m == "blp_tpu" or m.startswith(("blp_tpu.", "jax.", "jaxlib")))
print(len(names), leaked)
"""


def test_port_imports_without_jax_or_blp_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    count, leaked = out.stdout.split(" ", 1)
    assert int(count) >= 15
    assert leaked.strip() == "[]"


def _tiny():
    cfg = blp.ModelConfig(model="blp", rel_model="transe", dim=8,
                          num_relations=2, encoder=bert.BertConfig.tiny())
    return cfg, blp.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")


@pytest.mark.parametrize("entry", ["LinkPredictor", "encode",
                                   "eval_link_prediction", "init_params"])
def test_entry_points_default_to_cuda(entry):
    cfg, params = _tiny()
    calls = {
        "LinkPredictor": lambda: serve.LinkPredictor(params=params, cfg=cfg),
        "encode": lambda: blp.encode(params, cfg, np.ones((4, 8), np.int64), None),
        "eval_link_prediction": lambda: evaluation.eval_link_prediction(
            params, cfg, np.zeros((1, 3), np.int64), None, np.arange(4)),
        "init_params": lambda: blp.init_params(cfg, torch.Generator()),
    }
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[entry]()
