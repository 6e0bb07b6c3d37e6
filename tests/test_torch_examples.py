"""The port's serving examples (`src/repro_torch/examples/`): `serve_llm`,
`dynamic_graph_serving`, `sparse_serving` and `async_pipeline`, each run
in a subprocess with `--device cpu` at the reference's default sizes, as
a user runs them. Each must exit 0 (its own assertions hold) and print
the reference script's lines.

`serve_llm` is also run with the weights the reference's `Server` draws
(`lm_init(PRNGKey(0))` of the reduced config, handed over through
`bridge.lm_params_from_jax` and a stand-in for `Server`'s init) beside the
reference's own `examples/serve_llm.py` with the same `--arch`,
`--requests` and `--max-new`: the prompts, the printed output tokens and
`compiled_blobs` must be equal (fp32 reduced configs; the LM slice's
parity bar is 1e-4, and greedy tokens equal). `sparse_serving`'s densities
are held against the reference's `block_stats` of the same graphs.

The subprocesses start together, two threads each, and the tests read
their results: about 10-20 s on the CPU.
"""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as RARCHS
from repro.configs import reduced as rreduced
from repro.core import graph as rg
from repro.core import sparsity as rsp
from repro.data.graphs import clustered_like
from repro.nn import lm as rlm
from repro.nn.common import Param
from repro_torch import bridge

ROOT = Path(__file__).resolve().parent.parent
LLM_ARGS = ["--arch", "qwen3-4b", "--requests", "12", "--max-new", "8"]
TIMEOUT_S = 400
# serve_llm with the reference Server's weights: the stand-in init hands
# the saved LMParams to every Server the script makes
WITH_WEIGHTS = """
import sys, torch
from repro_torch.examples import serve_llm
from repro_torch.runtime import server
params = torch.load(sys.argv[1], weights_only=False)
init = server.Server.__init__
server.Server.__init__ = lambda self, cfg, sc, **kw: init(
    self, cfg, sc, params=params, **kw)
serve_llm.main(sys.argv[2:])
"""
SWEEP = [("dense-ish", 0.50, 0.30), ("medium", 0.10, 0.05),
         ("sparse", 0.03, 0.0), ("very sparse", 0.01, 0.0)]


def _numpy_tree(node):
    """The reference's LMParams with numpy leaves, named tuples as
    dicts, in the layout `bridge.lm_params_from_jax` reads."""
    if node is None:
        return None
    if isinstance(node, Param):
        return np.asarray(node.value)
    if isinstance(node, dict):
        return {k: _numpy_tree(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_numpy_tree(v) for v in node]
    if hasattr(node, "_asdict"):
        return {k: _numpy_tree(v) for k, v in node._asdict().items()}
    return np.asarray(node)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{name: (exit code, stdout, stderr)} of every script, run at once."""
    weights = tmp_path_factory.mktemp("examples") / "serve_llm_params.pt"
    cfg = rreduced(RARCHS[LLM_ARGS[1]])
    torch.save(bridge.lm_params_from_jax(_numpy_tree(
        rlm.lm_init(jax.random.PRNGKey(0), cfg)), device="cpu"), weights)
    # two threads each: the five scripts run at once beside other workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    port = [sys.executable, "-m"]
    cmds = {
        "serve_llm": port + ["repro_torch.examples.serve_llm", *LLM_ARGS],
        "serve_llm, reference weights": [
            sys.executable, "-c", WITH_WEIGHTS, str(weights), *LLM_ARGS],
        "reference serve_llm": [sys.executable,
                                str(ROOT / "examples" / "serve_llm.py"),
                                *LLM_ARGS],
        **{name: port + [f"repro_torch.examples.{name}"]
           for name in ("dynamic_graph_serving", "sparse_serving",
                        "async_pipeline")}}
    procs = {}
    try:
        for name, cmd in cmds.items():
            if not name.startswith("reference"):
                cmd = cmd + ["--device", "cpu"]
            procs[name] = subprocess.Popen(
                cmd, cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE)
        out = {}
        for name, p in procs.items():
            so, se = p.communicate(timeout=TIMEOUT_S)
            out[name] = (p.returncode, so, se)
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


def _ok(runs, name):
    rc, so, se = runs[name]
    assert rc == 0, f"{name} exited {rc}:\n{so[-2000:]}\n{se[-4000:]}"
    return so


def _summary(text):
    """The server's summary JSON (printed with indent=2)."""
    return json.loads(text[text.index("{\n"):text.index("\n}") + 2])


def _tokens(text):
    return re.findall(r"^request (\d+): output tokens (\[.*\])$", text,
                      flags=re.M)


def test_serve_llm_serves_and_holds_its_assertion(runs):
    so = _ok(runs, "serve_llm")
    assert so.startswith("serving reduced qwen3-4b: buckets=(32, 64, 128) "
                         "slots=4 mode=continuous\n")
    assert len(re.findall(r"^  submitted request \d+: prompt_len=\d+$", so,
                          flags=re.M)) == 12
    s = _summary(so)
    assert s["requests"] == 12 and s["tokens_out"] == 12 * 8
    assert s["compiled_blobs"] <= 3 + 1
    toks = _tokens(so)
    assert [int(u) for u, _ in toks] == [0, 1, 2]
    for _, t in toks:
        t = json.loads(t)
        assert len(t) == 8 and all(0 <= x < 512 for x in t)


def test_serve_llm_prints_the_reference_tokens(runs):
    """With the reference Server's weights, the port's script prints what
    `examples/serve_llm.py` prints: prompts, tokens, compiled_blobs."""
    got, want = (_ok(runs, "serve_llm, reference weights"),
                 _ok(runs, "reference serve_llm"))

    def prompts(text):
        return re.findall(r"^  submitted request .*$", text, flags=re.M)
    assert prompts(got) == prompts(want) and len(prompts(got)) == 12
    assert _tokens(got) == _tokens(want) and len(_tokens(got)) == 3
    g, w = _summary(got), _summary(want)
    for k in ("compiled_blobs", "requests", "prefills", "decode_steps",
              "tokens_out"):
        assert g[k] == w[k], k


def test_dynamic_graph_serving_stays_recompile_free(runs):
    so = _ok(runs, "dynamic_graph_serving")
    assert re.search(r"^NodePad bucket: 2560 \(graph starts at 2000 nodes, "
                     r"\d+ blobs warm\)$", so, flags=re.M)
    steps = re.findall(r"^step (\d+): (\d+) nodes, \d+ edges \| host .* "
                       r"rebucketed: (\w+), blobs: (\d+)$", so, flags=re.M)
    assert [int(s[0]) for s in steps] == list(range(10))
    assert [int(s[1]) for s in steps] == [2000 + 20 * (i + 1)
                                          for i in range(10)]
    assert {s[2] for s in steps} == {"False"}
    assert len({s[3] for s in steps}) == 1          # no new plan
    assert re.search(r"^10 graph updates in [\d.]+s, compiled EXACTLY \d+ "
                     r"blob\(s\), 0 rebucket\(s\), p50 [\d.]+ ms", so,
                     flags=re.M)


def test_sparse_serving_flips_backend_with_the_reference_densities(runs):
    so = _ok(runs, "sparse_serving")
    assert re.search(r"^warm: \d+ compiled blobs \(both backends "
                     r"pre-traced\), bucket budget grasp_max_nnz\(1024\) = "
                     r"%d$" % rsp.grasp_max_nnz(1024), so, flags=re.M)
    rows = re.findall(r"^ *(dense-ish|medium|sparse|very sparse) +([\d.]+) "
                      r"+([\d.]+) +[\d.]+us +[\d.]+us +(dense|grasp)", so,
                      flags=re.M)
    assert [r[0] for r in rows] == [s[0] for s in SWEEP]
    n, ladder = 896, rg.BucketLadder(buckets=(1024,))
    for (name, within, cross), (_, elem, block, _) in zip(SWEEP, rows):
        g = clustered_like(num_nodes=n, num_feats=16, num_classes=5,
                           within_density=within, cross_frac=cross, seed=3)
        st = rsp.block_stats(ladder.pad(g).norm_adj)
        assert elem == f"{g.num_edges / n ** 2:.4f}", name
        assert block == f"{st['block_density']:.2f}", name
    assert {r[3] for r in rows} == {"dense", "grasp"}
    assert re.search(r"^agg_backends=\{'gcn': 'auto'\} grasp_batches=[1-9]",
                     so, flags=re.M)


def test_async_pipeline_completes_every_request(runs):
    so = _ok(runs, "async_pipeline")
    assert re.search(r"^sync  run\(\): +[\d.]+ req/s  device_idle=[\d.]+  "
                     r"occupancy=[\d.]+$", so, flags=re.M)
    assert re.search(r"^async pipe : +[\d.]+ req/s .*\(host workers=2, "
                     r"window=25.0ms\)$", so, flags=re.M)
    assert re.search(r"x async vs sync; 16 requests completed, blocked=0 "
                     r"rejected=0$", so, flags=re.M)
