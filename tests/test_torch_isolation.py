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


def test_port_file_list_covers_every_slice():
    # the modules each slice added are scanned, the numpy-only ones too
    names = {str(p.relative_to(ROOT / "src" / "repro_torch"))
             for p in PORT_FILES[:-1]}
    assert {"core/masks.py", "core/effop.py", "core/sparsity.py",
            "core/quant.py", "kernels/gat_attention.py",
            "kernels/sage_max.py", "kernels/fused_layers.py",
            "kernels/flash_attention.py", "runtime/gnn_server.py",
            "runtime/server.py", "runtime/ewma.py", "runtime/slo.py",
            "runtime/scheduler.py", "core/partition.py", "dist/compress.py",
            "launch/serve.py", "configs/smollm_135m.py",
            "nn/config.py", "nn/common.py", "nn/mlp.py", "nn/attention.py",
            "nn/transformer.py", "nn/lm.py", "optim/adamw.py",
            "examples/quickstart.py", "examples/quality_tiers.py",
            "nn/moe.py", "nn/ssm.py", "configs/olmoe_1b_7b.py",
            "configs/mamba2_2p7b.py", "configs/jamba_v0p1_52b.py",
            "configs/llama4_scout_17b_a16e.py", "nn/layerwise.py",
            "nn/encdec.py", "nn/multimodal.py", "configs/whisper_base.py",
            "configs/phi3_vision_4p2b.py", "data/synthetic.py",
            "ckpt/checkpoint.py", "runtime/trainer.py", "launch/train.py",
            "examples/train_lm.py", "examples/serve_llm.py",
            "examples/dynamic_graph_serving.py",
            "examples/sparse_serving.py",
            "examples/async_pipeline.py", "launch/mesh.py",
            "dist/sharding.py", "launch/shard_serve.py"} <= names


def test_mesh_rank_program_imports_no_jax_and_no_reference():
    """The rank processes of tests/test_torch_mesh.py run without JAX."""
    path = ROOT / "tests" / "torch_mesh_rank.py"
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"tests/torch_mesh_rank.py imports {bad}"


def test_mesh_modules_load_no_jax():
    """Importing the mesh, the distribution rules and the per-rank entry
    point loads no JAX or reference module."""
    code = ("import sys\n"
            "import repro_torch.launch.mesh, repro_torch.dist.sharding\n"
            "import repro_torch.launch.shard_serve\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], env=_env(), check=True,
                   timeout=120)


def _serve_on_cpu_without_jax(kind, aggregator="mean"):
    """Serve one model of `kind` on the CPU, fp32 fused and int8 unfused,
    in a fresh process; assert that no JAX or reference module loaded."""
    code = (
        "import sys, numpy as np, torch\n"
        "from repro_torch.core.graph import BucketLadder\n"
        "from repro_torch.core.models import GNNConfig\n"
        "from repro_torch.data.graphs import planetoid_like\n"
        "from repro_torch.runtime.gnn_server import GraphServe, "
        "GraphServeConfig\n"
        "eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128,)), "
        "batch_slots=2), device='cpu')\n"
        f"eng.register_model('m', GNNConfig(kind='{kind}', in_feats=16, "
        f"hidden=8, num_classes=3, heads=2, aggregator='{aggregator}'), "
        "tiers=('fp32', 'int8'), fusion='layer')\n"
        "eng.warmup()\n"
        "g = planetoid_like(num_nodes=50, num_edges=120, num_feats=16, "
        "num_classes=3, train_per_class=2)\n"
        "eng.calibrate('m', g)\n"
        "eng.submit(g, model='m')\n"
        "eng.submit(g, model='m', tier='int8', fusion='none')\n"
        "assert [r.preds.shape for r in eng.run()] == [(50,)] * 2\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cpu_forward_leaves_jax_unloaded():
    _serve_on_cpu_without_jax("gcn")


def test_cpu_gat_forward_leaves_jax_unloaded():
    _serve_on_cpu_without_jax("gat")


@pytest.mark.parametrize("aggregator", ["mean", "max"])
def test_cpu_sage_forward_leaves_jax_unloaded(aggregator):
    _serve_on_cpu_without_jax("sage", aggregator)


def test_cpu_pipeline_leaves_jax_unloaded():
    """The threaded scheduler with an SLO governor, deadlines and a
    tolerance on the CPU, in a fresh process: it serves and loads no JAX
    or reference module."""
    code = (
        "import sys\n"
        "from repro_torch.core.graph import BucketLadder\n"
        "from repro_torch.core.models import GNNConfig\n"
        "from repro_torch.data.graphs import planetoid_like\n"
        "from repro_torch.runtime.gnn_server import GraphServe, "
        "GraphServeConfig\n"
        "from repro_torch.runtime.scheduler import PipelineConfig\n"
        "from repro_torch.runtime.slo import SLOConfig\n"
        "eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128,)), "
        "batch_slots=2), slo=SLOConfig(), device='cpu')\n"
        "eng.register_model('m', GNNConfig(kind='gcn', in_feats=16, "
        "hidden=8, num_classes=3), tiers=('fp32', 'int8'))\n"
        "eng.warmup()\n"
        "g = planetoid_like(num_nodes=50, num_edges=120, num_feats=16, "
        "num_classes=3, train_per_class=2)\n"
        "eng.calibrate('m', g)\n"
        "with eng.scheduler(PipelineConfig(host_workers=2)) as s:\n"
        "    s.submit(g, model='m', deadline_ms=6e4)\n"
        "    s.submit(g, model='m', tolerance=100.0)\n"
        "    out = s.drain(timeout=60)\n"
        "assert [r.preds.shape for r in out] == [(50,)] * 2\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cpu_sharded_serving_leaves_jax_unloaded():
    """A graph past the top bucket, auto-sharded on the int8 wire, queried
    before and after an edge delta (two versions, one dispatch of two
    replica rows), on the CPU in a fresh process: it serves and loads no
    JAX or reference module."""
    code = (
        "import sys\n"
        "from repro_torch.core.graph import BucketLadder\n"
        "from repro_torch.core.models import GNNConfig\n"
        "from repro_torch.data.graphs import clustered_like\n"
        "from repro_torch.runtime.gnn_server import GraphServe, "
        "GraphServeConfig\n"
        "eng = GraphServe(GraphServeConfig(ladder=BucketLadder((128,)), "
        "shard_counts=(2, 4), replica_groups=2), device='cpu')\n"
        "eng.register_model('m', GNNConfig(kind='gcn', in_feats=16, "
        "hidden=8, num_classes=3))\n"
        "eng.warmup()\n"
        "g = clustered_like(num_nodes=200, num_feats=16, num_classes=3, "
        "cross_frac=0.1)\n"
        "gid = eng.attach(g, model='m')\n"
        "eng.query(gid)\n"
        "eng.update_delta(gid, add_edges=[(0, 199)])\n"
        "eng.query(gid)\n"
        "assert [r.preds.shape for r in eng.run()] == [(200,)] * 2\n"
        "assert eng.summary()['sharded_batches'] == 1\n"
        "eng.assert_warm()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_cpu_lm_serve_leaves_jax_unloaded():
    """The LM entry point on a reduced smollm, on the CPU, in a fresh
    process: it serves and loads no JAX or reference module."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "serve.main(['--arch', 'smollm-135m', '--reduced', '--requests', "
        "'3', '--max-new', '3', '--buckets', '16', '32', '--max-len', "
        "'40', '--device', 'cpu'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert '"tokens_out": 9' in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-2.7b",
                                  "jamba-v0.1-52b"])
def test_cpu_moe_ssm_serve_leaves_jax_unloaded(arch):
    """The LM entry point on a reduced MoE, SSM and hybrid model, on the
    CPU, in a fresh process: it serves and loads no JAX or reference
    module."""
    code = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        f"serve.main(['--arch', '{arch}', '--reduced', '--requests', "
        "'3', '--max-new', '3', '--buckets', '16', '32', '--max-len', "
        "'40', '--device', 'cpu'])\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert '"tokens_out": 9' in out.stdout
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
