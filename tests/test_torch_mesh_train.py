"""PyTorch port, the LM on a mesh of ranks: `make_train_step(mesh=)`
(`runtime/trainer.py`), the model's gather hook (`nn/lm.py`,
`nn/transformer.py`, `dist/sharding.Placement`), checkpoints saved on one
mesh and restored on another (`ckpt/checkpoint.py`), prefill and decode
on a mesh, and `launch/train.py --mesh`, held against the single-process
port and the reference's `make_train_step(mesh=None)`.

The ranks run as subprocesses on gloo and the CPU, one thread each
(`tests/torch_mesh_lm_rank.py`, `python -m repro_torch.launch.train`),
started by `spawn_local` under a timeout that kills them all; the world
of 4 runs once per module (the fixture) and the cases read its results.
The rank processes import no JAX.

Weights: the reduced smollm-135m (heads, ff and vocab split over
"model") and olmoe-1b-7b (its 8 experts split over "model"), numpy
draws on the reference's tree shapes (`test_torch_lm_training._weights`),
written as a checkpoint the ranks read. Batches: `TokenStream`, 8 rows of
32 tokens in 2 microbatches, so a data rank's rows of a microbatch are
one whole MoE group of 64 tokens, as in the single-process step.

Tolerances:
  * bit for bit: the first loss on (1, 2), where every rank computes the
    same rows as one process does from assembled (exact) weights; every
    rank of a mesh reports the same losses; a restore's blocks against
    `local_block` of the saved arrays; a run resumed on the mesh that
    wrote the checkpoint against the uninterrupted run; greedy tokens;
  * MESH_TOL, rtol 1e-5, atol 1e-6: the losses of 3 steps on every mesh
    against the single-process port. A data split sums the loss and the
    gradient over ranks in another order than one process does;
  * the parameters after 3 steps: against the single-process port within
    MESH_PARAM_TOL, rtol 1e-5, atol 1e-6, at all but one entry in
    10,000 (MESH_PARAM_OUTLIERS), and every entry within 2 lr a step
    (ADAM_BOUND): where a data split puts a gradient entry near 0, its
    rounding moves AdamW's step, which divides the entry by its own root
    mean square (on a (2, 1) mesh one entry of the reduced smollm's
    32,768 wq entries lands 3.3e-6 from the single-process port's);
    against the reference's
    single-device step within TRAIN_TOL (rtol 1e-3, atol 2e-5), the bar
    `test_torch_lm_training.py` holds the single-process port to, or
    where an entry of the single-process port is further from the
    reference than that, no further than it plus MESH_PARAM_TOL. The
    reference's rtol 1e-5 / atol 1e-6 does not hold against XLA: its and
    ATen's CPU dots sum in other orders, and AdamW divides each gradient
    entry by its own root mean square, so an entry near 0 moves by up to
    lr a step whatever its rounding (one entry of 65,536 of the reduced
    smollm's w_out after 3 steps: 1.1e-4 from the reference, as the
    single-process port is).
"""
import concurrent.futures
import json
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import TokenStream as RTokenStream
from repro.optim.adamw import adamw_init as radamw_init
from repro.runtime import trainer as rtrainer
from repro_torch import bridge
from repro_torch.ckpt import restore_checkpoint, tree_items
from repro_torch.ckpt.checkpoint import save_checkpoint
from repro_torch.dist.sharding import local_block
from repro_torch.launch import shard_serve as ss
from repro_torch.launch import train as tlaunch
from repro_torch.nn import lm as tlm
from repro_torch.runtime import trainer as ttrainer

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import test_torch_lm_training as lmt  # noqa: E402
import torch_mesh_lm_rank as mr  # noqa: E402

MESH_TOL = dict(rtol=1e-5, atol=1e-6)
MESH_PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
MESH_PARAM_OUTLIERS = 1e-4
ADAM_BOUND = 2 * mr.TC["steps"] * mr.TC["lr"]
TRAIN_TOL = dict(rtol=1e-3, atol=2e-5)
SPAWN_TIMEOUT_S = 150
RANK_SCRIPT = str(HERE / "torch_mesh_lm_rank.py")
MESH_NAMES = [mr.name(s) for s in mr.MESHES]


class one_thread:
    def __enter__(self):
        self.n = torch.get_num_threads()
        torch.set_num_threads(1)

    def __exit__(self, *exc):
        torch.set_num_threads(self.n)


def _batches(cfg):
    stream = RTokenStream(vocab_size=cfg.vocab_size,
                          seq_len=mr.TC["seq_len"],
                          global_batch=mr.TC["global_batch"], seed=0)
    return [stream.batch_at(s) for s in range(mr.TC["steps"])]


def _reference_run(rcfg, rparams):
    """The reference's make_train_step(mesh=None), jitted: 3 steps."""
    tc = rtrainer.TrainConfig(**mr.TC)
    step = rtrainer.make_train_step(rcfg, tc)
    params, opt = rparams, radamw_init(rparams)
    losses = []
    for i, b in enumerate(_batches(rcfg)):
        params, opt, m = step(params, opt, {k: jnp.asarray(v)
                                            for k, v in b.items()},
                              jnp.asarray(i))
        losses.append(float(m["loss"]))
    return losses, dict(tree_items(lmt._numpy_tree(params)))


def _port_run(cfg, params):
    """The single-process port's make_train_step: 3 steps, one thread."""
    tc = ttrainer.TrainConfig(**mr.TC)
    step = ttrainer.make_train_step(cfg, tc)
    opt = ttrainer.init_opt_state(params)
    losses = []
    with one_thread():
        for i, b in enumerate(_batches(cfg)):
            params, opt, m = step(params, opt, lmt._t(b), torch.tensor(i))
            losses.append(float(m["loss"]))
    return losses, dict(tree_items(bridge.params_to_numpy(params)))


LAUNCH_ARGS = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
               "--steps", "2", "--batch", "4", "--seq", "32", "--lr", "1e-3",
               "--mesh", "1x2", "--backend", "gloo"]


@pytest.fixture(scope="module")
def world():
    """The 4 ranks' results, 2 ranks of `launch/train.py --mesh 1x2`, and
    the references on the same weights, computed while the ranks run."""
    with tempfile.TemporaryDirectory() as tmp, \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        root = Path(tmp)
        weights = {}
        for arch in mr.ARCHS:
            _, cfg, _, weights[arch] = lmt._weights(arch)
            assert cfg == mr.config(arch)
            save_checkpoint(str(root / "init" / arch), 0, weights[arch])
        ranks = pool.submit(ss.spawn_local, 4, ["--dir", tmp],
                            SPAWN_TIMEOUT_S, program=(RANK_SCRIPT,))
        launched = pool.submit(ss.spawn_local, 2, LAUNCH_ARGS,
                               SPAWN_TIMEOUT_S,
                               program=("-m", "repro_torch.launch.train"))
        refs, ports = {}, {}
        for arch in mr.ARCHS:
            rcfg, cfg, rparams, _ = lmt._weights(arch)
            refs[arch] = _reference_run(rcfg, rparams)
            ports[arch] = _port_run(cfg, weights[arch])
        outs = [ss.last_json(o) for o in ranks.result()]
        launch = [ss.last_json(o) for o in launched.result()]
        trained = {}
        for shape in mr.MESHES:
            for arch in mr.ARCHS:
                tree = restore_checkpoint(str(root / mr.name(shape) / arch),
                                          weights[arch])[1]
                trained[(mr.name(shape), arch)] = dict(
                    tree_items(bridge.params_to_numpy(tree)))
        saved = {src: restore_checkpoint(
            str(root / f"resume-{src}"),
            {"params": weights["smollm-135m"]}, step=2)[1]
            for src in ("2x1", "1x2")}
        blocks = {(src, r): dict(np.load(root / f"blocks-{src}-r{r}.npz"))
                  for src in ("2x1", "1x2") for r in (0, 1)}
        yield dict(outs=outs, refs=refs, ports=ports, trained=trained,
                   saved=saved, blocks=blocks, weights=weights,
                   launch=launch)


def _ranks(world, mesh_name):
    n = int(np.prod([int(v) for v in mesh_name.split("x")]))
    return world["outs"][:n]


@pytest.mark.parametrize("arch", mr.ARCHS)
def test_first_loss_on_one_data_rank_is_bit_equal(world, arch):
    """(1, 2): each rank computes all rows from exact assembled weights."""
    want = world["ports"][arch][0][0]
    for o in _ranks(world, "1x2"):
        assert o["train"][f"1x2/{arch}"]["losses"][0][1] == want


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", mr.ARCHS)
def test_losses_match_the_single_process_port(world, mesh_name, arch):
    outs = _ranks(world, mesh_name)
    got = [[l for _, l in o["train"][f"{mesh_name}/{arch}"]["losses"]]
           for o in outs]
    assert all(g == got[0] for g in got)          # every rank alike
    np.testing.assert_allclose(got[0], world["ports"][arch][0], **MESH_TOL)
    np.testing.assert_allclose(got[0], world["refs"][arch][0],
                               **lmt.LOSS_TOL)


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
@pytest.mark.parametrize("arch", mr.ARCHS)
def test_parameters_after_three_steps(world, mesh_name, arch):
    got = world["trained"][(mesh_name, arch)]
    port = world["ports"][arch][1]
    ref = world["refs"][arch][1]
    assert got.keys() == port.keys() == ref.keys()
    for key in got:
        close = np.isclose(got[key], port[key], **MESH_PARAM_TOL)
        assert close.mean() >= 1 - MESH_PARAM_OUTLIERS, (key, (~close).sum())
        assert np.abs(got[key] - port[key]).max() <= ADAM_BOUND, key
        # no further from the reference than TRAIN_TOL, or than the
        # single-process port is, plus MESH_PARAM_TOL
        off = np.abs(got[key] - ref[key])
        bar = np.maximum(
            TRAIN_TOL["atol"] + TRAIN_TOL["rtol"] * np.abs(ref[key]),
            np.abs(port[key] - ref[key]) + MESH_PARAM_TOL["atol"]
            + MESH_PARAM_TOL["rtol"] * np.abs(port[key]))
        assert (off <= bar).all(), (key, float((off - bar).max()))


@pytest.mark.parametrize("mesh_name", MESH_NAMES)
def test_ranks_hold_their_blocks_only(world, mesh_name):
    """A rank's parameter bytes shrink with the model axis: heads, ff and
    vocab split in two on (1, 2) and (2, 2), nothing on (2, 1)."""
    full = sum(t.numel() * 4 for _, t in tree_items(
        world["weights"]["smollm-135m"]))
    for o in _ranks(world, mesh_name):
        got = o["train"][f"{mesh_name}/smollm-135m"]["param_block_bytes"]
        if mesh_name == "2x1":
            assert got == full
        else:
            assert full / 2 < got < full


@pytest.mark.parametrize("src", ["2x1", "1x2"])
@pytest.mark.parametrize("rank", [0, 1])
def test_restored_blocks_are_local_blocks_of_the_saved_arrays(world, src,
                                                              rank):
    """Saved on `src`, restored on (1, 2): bit for bit."""
    place = ttrainer.lm_placement(mr.config("smollm-135m"),
                                  _Coords({"data": 1, "model": 2},
                                          {"data": 0, "model": rank}))
    saved = dict(tree_items(world["saved"][src]))
    specs = dict(tree_items({"params": place.specs},
                            is_leaf=lambda n: type(n) is tuple))
    got = world["blocks"][(src, rank)]
    assert len(got) == len(saved)
    for key, full in saved.items():
        want = local_block(full, specs[key], place.mesh).numpy()
        assert np.array_equal(got[key.replace("/", "|")], want), key


class _Coords:
    """Just enough mesh for the specs and `local_block`."""

    def __init__(self, shape, coords):
        self.shape, self.coords = shape, coords
        self.axis_names = tuple(shape)


def test_resume_on_the_same_mesh_is_bit_equal(world):
    for o in _ranks(world, "1x2"):
        r = o["resume"]["1x2"]
        assert r["start"] == 2
        assert r["losses"] == o["train"]["1x2/smollm-135m"]["losses"][2:]


def test_resume_on_another_mesh_continues_the_run(world):
    """Saved on (2, 1) after 2 steps, the third step on (1, 2)."""
    for o in _ranks(world, "1x2"):
        r = o["resume"]["2x1"]
        assert r["start"] == 2 and [s for s, _ in r["losses"]] == [2]
        np.testing.assert_allclose(
            r["losses"][0][1], world["ports"]["smollm-135m"][0][2],
            **MESH_TOL)


def test_prefill_and_decode_on_a_mesh_give_the_single_process_tokens(world):
    cfg = mr.config("smollm-135m")
    with one_thread(), torch.no_grad():
        want = tlm.greedy_generate(world["weights"]["smollm-135m"], cfg,
                                   mr.prompt(cfg), steps=mr.PROMPT["steps"],
                                   max_len=mr.PROMPT["max_len"])
    for o in _ranks(world, "1x2"):
        assert o["serve"] == want.tolist()


def test_launch_train_on_a_mesh(world):
    """`launch/train.py --mesh 1x2` on two ranks: each prints one JSON
    line; the first loss equals the single-process Trainer's bit for bit
    (the same seed's weights), the rest within MESH_TOL."""
    tc = ttrainer.TrainConfig(steps=2, seq_len=32, global_batch=4, lr=1e-3)
    with one_thread():
        tr = ttrainer.Trainer(mr.config("smollm-135m"), tc, device="cpu")
        tr.run()
    want = [r.loss for r in tr.history]
    for o in world["launch"]:
        assert o["mesh"] == {"data": 1, "model": 2}
        assert [s for s, _ in o["losses"]] == [0, 1]
        got = [l for _, l in o["losses"]]
        assert got[0] == want[0]
        np.testing.assert_allclose(got, want, **MESH_TOL)
        assert o["allreduce_calls"] > 0 and len(o["step_ms"]) == 2


def test_no_mesh_loss_and_gradients_are_unchanged():
    """Without `place` lm_loss is the composition it was: lm_hidden, then
    chunked_xent over the token positions, plus the MoE aux loss; the
    loss and every gradient bit for bit."""
    for arch in mr.ARCHS:
        _, cfg, _, tp = lmt._weights(arch)
        batch = lmt._t(lmt._batch(cfg))
        keys = [k for k, _ in tree_items(tp)]

        def grads(fn):
            leaves = [t.detach().clone().requires_grad_(True)
                      for _, t in tree_items(tp)]
            p = bridge_replace(tp, dict(zip(keys, leaves)))
            loss = fn(p)
            return loss, torch.autograd.grad(loss, leaves)

        def before(p):
            h, aux, plen = tlm.lm_hidden(p, cfg, batch["tokens"])
            return tlm.chunked_xent(p, cfg, h[:, plen:], batch["labels"],
                                    batch["mask"]) + aux
        l0, g0 = grads(lambda p: tlm.lm_loss(p, cfg, batch)[0])
        l1, g1 = grads(before)
        assert l0.item() == l1.item()
        for k, a, b in zip(keys, g0, g1):
            assert torch.equal(a, b), k


def bridge_replace(tree, leaves):
    from repro_torch.ckpt import tree_replace
    return tree_replace(tree, leaves)


def test_mesh_argument_parses():
    assert tlaunch.mesh_shape("2x4") == (2, 4)
    assert json.loads(json.dumps(mr.TC))["microbatches"] == 2
