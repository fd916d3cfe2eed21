"""Nothing of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port. Names are compared by their
top-level part, whole: `blp_tpu_torch` begins with `blp_tpu` and is not it."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from benchmark import spec

BENCH_DIR = spec.ROOT / "benchmark"
REFERENCE = ("models",)


def _top_level_imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_whole_names():
    assert spec.forbidden_loaded(["blp_tpu_torch", "blp_tpu_torch.ops"]) == []
    assert spec.forbidden_loaded(["blp_tpu.models", "jaxlib.xla"]) == ["blp_tpu", "jaxlib"]
    assert spec.forbidden_loaded(["jax_like", "flaxen"]) == []


def test_sources_import_no_jax():
    for path in BENCH_DIR.rglob("*.py"):
        found = spec.forbidden_loaded(_top_level_imports(path))
        assert not found, f"{path} imports {found}"


def test_reference_imports_nothing_of_the_port():
    for sub in REFERENCE:
        for path in (BENCH_DIR / sub).rglob("*.py"):
            assert "blp_tpu_torch" not in _top_level_imports(path), path


_PROBE = """
import importlib, json, pkgutil, sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None             # an import of them fails
import benchmark
names = [m.name for m in pkgutil.walk_packages(benchmark.__path__, "benchmark.")
         if ".tests" not in m.name and m.name != "benchmark.tests"]
for name in names:
    importlib.import_module(name)
loaded = [m for m in sys.modules if sys.modules[m] is not None]
print(json.dumps({"names": names, "loaded": loaded}))
"""

_REFERENCE_PROBE = """
import json, sys
import benchmark.models.bert, benchmark.models.dkrl, benchmark.models.common
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] == "blp_tpu_torch")))
"""


def _probe(code: str):
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_every_module_loads_without_jax():
    got = _probe(_PROBE)
    assert "benchmark.run" in got["names"] and "benchmark.drivers.train" in got["names"]
    assert spec.forbidden_loaded(got["loaded"]) == []


def test_reference_loads_nothing_of_the_port():
    assert _probe(_REFERENCE_PROBE) == []
