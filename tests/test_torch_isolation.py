"""PyTorch port isolation: `repro_torch` and `chip_smoke.py` never import JAX
or the reference package, and `chip_smoke.py` refuses to run without a
card or without the rest of the repository."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_cpu_forward_leaves_jax_unloaded():
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.core.graph import BucketLadder\n"
        "from repro_torch.core.models import GNNConfig\n"
        "from repro_torch.data.graphs import planetoid_like\n"
        "from repro_torch.runtime.gnn_server import GraphServe, "
        "GraphServeConfig\n"
        "eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128,)), "
        "batch_slots=2), device='cpu')\n"
        "eng.register_model('gcn', GNNConfig(kind='gcn', in_feats=16, "
        "hidden=8, num_classes=3), fusion='layer')\n"
        "eng.warmup()\n"
        "eng.submit(planetoid_like(num_nodes=50, num_edges=120, num_feats=16,"
        " num_classes=3, train_per_class=2), model='gcn')\n"
        "assert eng.run()[0].preds.shape == (50,)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_chip_smoke_fails_without_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
