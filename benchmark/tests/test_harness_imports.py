"""No module that a run loads, and no import of the harness's sources,
has the top-level name ``jax``, ``jaxlib``, ``flax`` or that of the JAX
package (compared as whole names: the port's name begins with it)."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
from conftest import BENCH, harness, spec


def _sources():
    for root, _, names in os.walk(BENCH):
        for f in names:
            if f.endswith(".py"):
                yield os.path.join(root, f)


def test_no_source_of_the_benchmark_imports_jax():
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, \
                    (path, name)


def test_the_whole_name_is_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "uniprot_kmer_based_clustering_tpu_torch_x",
                        sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "uniprot_kmer_based_clustering_tpu.io", sys)
    assert harness.forbidden_modules() == ["uniprot_kmer_based_clustering_tpu"]


@pytest.mark.parametrize("workload", [w["name"] for w in spec()["workloads"]])
def test_a_run_loads_no_jax(workload, tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {os.path.join(BENCH, 'tests')!r})
import conftest
conftest.harness.CACHE_DIR = {str(tmp_path)!r}
result, _, _ = conftest.run_cpu({workload!r}, traced=True)
print(json.dumps([result["correct"], sorted({{m.split(".")[0] for m in sys.modules}})]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, tops = json.loads(out.stdout.splitlines()[-1])
    assert correct
    assert "uniprot_kmer_based_clustering_tpu_torch" in tops
    assert not set(tops) & set(harness.FORBIDDEN_MODULES)
