"""LM training runtime: a microbatched trainer with fault tolerance.

Port of the reference's `runtime/trainer.py` on one device:

  * MICROBATCHING — the global batch is split into `microbatches` slices
    of consecutive rows; each slice's gradients are summed in slice order
    and the sum divided by the count, as the reference's scan does.
  * FAULT TOLERANCE — steps run under a supervisor loop: any exception
    restores the latest checkpoint and rewinds the data stream
    (`TokenStream.batch_at(step)` is a pure function of the step). A
    failure injector is wired for tests and drills.
  * STRAGGLER MITIGATION — each step's wall time against the bias-corrected
    EWMA of the earlier ones (`runtime/ewma.StragglerGate`); a step slower
    than `straggler_factor` x the baseline is flagged.

Parameters are float32 leaves (`lm_init(dtype=None)`, or the bridge's
`lm_params_from_jax`); the forward casts them to `cfg.dtype` at use, as the
reference's forward casts its Params. On the card the attention of every
layer and its gradient run through the `flash_attention` kernels.

On a mesh of ranks (`make_train_step(cfg, tc, mesh=)`, the counterpart of
the reference's pjit branch) each rank holds its `local_block` of every
parameter and of AdamW's m and v (`lm_placement`), and takes its rows of
each microbatch (the reference's slice of consecutive global rows, split
over the data axes). The loss and the gradient blocks come through the
model's gather hook (`dist.sharding.Placement`), the gradient blocks are
summed over the data axes with one `all_reduce` a leaf, the global norm
for clipping is the sum of squares of every full leaf (each distinct
block counted by one rank, summed over the mesh), and AdamW runs on the
blocks. `Trainer` stays on one device, as the reference's does; the
launcher (`launch/train.py --mesh`) drives a mesh, one process a rank.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager, tree_items, tree_replace
from repro_torch.data.synthetic import TokenStream
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.dist.compress import psum
from repro_torch.dist.sharding import (Placement, mesh_batch_axes,
                                       optimizer_specs, param_specs)
from repro_torch.nn import lm
from repro_torch.nn.common import is_axes
from repro_torch.nn.config import ArchConfig
from repro_torch.optim.adamw import (adamw_init, adamw_update,
                                     clip_by_global_norm,
                                     linear_warmup_cosine, sum_of_squares)
from repro_torch.runtime.ewma import StragglerGate


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    lr: float = 3e-4
    warmup_steps: int = 20
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    ckpt_keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


def _leaves(tree: Any) -> List[torch.Tensor]:
    return [t for _, t in tree_items(tree)]


def _like(tree: Any, values: List[torch.Tensor]) -> Any:
    """`tree` with its leaves, in `tree_items` order, replaced by
    `values`."""
    return tree_replace(tree, {k: v for (k, _), v in
                               zip(tree_items(tree), values)})


def init_opt_state(params: Any) -> Dict[str, Any]:
    """AdamW's state in the parameters' tree: m and v zero, count 0."""
    state = adamw_init(_leaves(params))
    return {"m": _like(params, state["m"]), "v": _like(params, state["v"]),
            "count": state["count"]}


def lm_placement(cfg: ArchConfig, mesh) -> Placement:
    """The LM's parameters placed on `mesh` by their logical axes
    (`lm.lm_axes`): specs from the shapes alone (`lm_init` on the meta
    device), so they hold for the float32 masters and the serving
    copies."""
    shapes = lm.lm_init(cfg, device="meta")
    return Placement(mesh, param_specs(lm.lm_axes(cfg), shapes, mesh))


def train_state_specs(place: Placement) -> Dict[str, Any]:
    """The specs of `{"params", "opt", "step"}`, the state a mesh run
    checkpoints."""
    return {"params": place.specs, "opt": optimizer_specs(place.specs),
            "step": ()}


def _leaf_specs(place: Placement) -> List[Tuple]:
    """The parameters' specs in `tree_items` order."""
    return [s for _, s in tree_items(place.specs, is_leaf=is_axes)]


def _split_axes(spec) -> set:
    return {a for e in spec if e is not None
            for a in ((e,) if isinstance(e, str) else e)}


def _data_reduce(grads: List[torch.Tensor], place: Placement
                 ) -> List[torch.Tensor]:
    """Each gradient block summed over the data axes of more than one
    rank that its spec does not split (one all_reduce a leaf; those it
    splits were summed by the gather's backward)."""
    out = []
    for g, spec in zip(grads, _leaf_specs(place)):
        axes = [a for a in mesh_batch_axes(place.mesh)
                if a not in _split_axes(spec) and place.mesh.shape[a] > 1]
        out.append(psum(g, place.mesh.group(*axes)) if axes else g)
    return out


def _global_norm(grads: List[torch.Tensor], place: Placement
                 ) -> torch.Tensor:
    """The norm of the full gradient from the blocks: a block is counted
    by the rank whose coordinates on the axes its spec does not split
    are 0, and the mesh sums the counts."""
    mesh = place.mesh
    mine = [g for g, spec in zip(grads, _leaf_specs(place))
            if not any(mesh.coords[a] for a in mesh.axis_names
                       if a not in _split_axes(spec))]
    total = (sum_of_squares(mine) if mine else
             torch.zeros((), device=grads[0].device))
    if math.prod(mesh.shape.values()) > 1:
        total = psum(total, mesh.group(*mesh.axis_names))
    return torch.sqrt(total)


def loss_and_grads(cfg: ArchConfig, params: Any, batch: Dict[str, Any],
                   microbatches: int = 1, place: Optional[Placement] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, gradients in `tree_items` order) of `lm.lm_loss`: with
    `microbatches` > 1 the batch's rows are cut into that many slices of
    consecutive rows, each slice's gradients summed in slice order and
    the sums (and the losses) divided by the count, as the reference's
    scan does. With `place`, `params` are this rank's blocks and `batch`
    the global batch: each slice's rows are split over the data axes
    (a slice that does not divide is computed whole by every data rank,
    each a share), and the loss and the gradient blocks are summed over
    the data group."""
    def one(mb):
        if place is not None:
            mb = place.rows(mb)
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        loss, _ = lm.lm_loss(_like(params, leaves), cfg, mb, place=place)
        return loss.detach(), list(torch.autograd.grad(loss, leaves))

    loss, grads = _micro(one, batch, microbatches)
    if place is not None:
        loss, grads = place.data_sum(loss), _data_reduce(grads, place)
    return loss, grads


def _micro(one: Callable, batch: Dict[str, Any], microbatches: int):
    if microbatches == 1:
        return one(batch)
    rows = batch["tokens"].shape[0]
    if rows % microbatches:
        raise ValueError(f"batch of {rows} rows does not split into "
                         f"{microbatches} microbatches")
    m = rows // microbatches
    gsum = lsum = None
    for i in range(microbatches):
        loss, grads = one({k: v[i * m:(i + 1) * m] for k, v in batch.items()})
        gsum = grads if gsum is None else [a + g for a, g in zip(gsum, grads)]
        lsum = loss if lsum is None else lsum + loss
    return lsum / microbatches, [g / microbatches for g in gsum]


def make_train_step(cfg: ArchConfig, tc: TrainConfig,
                    mesh=None) -> Callable:
    """(params, opt, batch, step) -> (params, opt, metrics), metrics
    {"loss", "grad_norm", "lr"}: `loss_and_grads` over `tc.microbatches`
    slices, the gradients clipped to `tc.clip_norm` by global norm, and
    one AdamW update at the warmup-cosine rate. A warmup as long as the
    run (a smoke run that cuts the steps but keeps the default warmup)
    takes a quarter of the steps, as in the reference. With `mesh`:
    params and opt are this rank's blocks (`lm_placement`), batch the
    global batch (see the module docstring)."""
    warmup = (tc.warmup_steps if tc.warmup_steps < tc.steps
              else max(1, tc.steps // 4))
    place = None if mesh is None else lm_placement(cfg, mesh)

    def step_fn(params, opt, batch, step):
        loss, grads = loss_and_grads(cfg, params, batch, tc.microbatches,
                                     place)
        gnorm = None if place is None else _global_norm(grads, place)
        grads, gnorm = clip_by_global_norm(grads, tc.clip_norm, gnorm=gnorm)
        lr = linear_warmup_cosine(step, base_lr=tc.lr, warmup_steps=warmup,
                                  total_steps=tc.steps)
        with torch.no_grad():
            new_p, state = adamw_update(
                _leaves(params), grads,
                {"m": _leaves(opt["m"]), "v": _leaves(opt["v"]),
                 "count": opt["count"]},
                lr=lr, weight_decay=tc.weight_decay)
        new_opt = {"m": _like(params, state["m"]),
                   "v": _like(params, state["v"]), "count": state["count"]}
        return (_like(params, new_p), new_opt,
                {"loss": loss, "grad_norm": gnorm, "lr": lr})

    return step_fn


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    wall_s: float
    straggler: bool


class Trainer:
    """Supervised training loop with restart-on-failure, on `device` (the
    card when None; raises without one)."""

    def __init__(self, cfg: ArchConfig, tc: TrainConfig, *,
                 params: Optional[lm.LMParams] = None,
                 failure_injector: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.tc = tc
        self.device = resolve_device(device)
        self.params = (self._init_params() if params is None else
                       _like(params, [t.to(self.device)
                                      for t in _leaves(params)]))
        self.opt = init_opt_state(self.params)
        self.step = 0
        self.stream = TokenStream(vocab_size=cfg.vocab_size,
                                  seq_len=tc.seq_len,
                                  global_batch=tc.global_batch, seed=tc.seed)
        self.train_step = make_train_step(cfg, tc)
        self.ckpt = (CheckpointManager(tc.ckpt_dir, keep=tc.ckpt_keep,
                                       every=tc.ckpt_every)
                     if tc.ckpt_dir else None)
        self.failure_injector = failure_injector
        self.history: List[StepRecord] = []
        self.restarts = 0
        self._straggler = StragglerGate(tc.straggler_factor, alpha=0.1)

    def _init_params(self) -> lm.LMParams:
        """The port's own float32 init from `tc.seed` (the reference's
        `jax.random` draws differ)."""
        return lm.lm_init(self.cfg, seed=self.tc.seed, device=self.device)

    # -- fault-tolerance plumbing ------------------------------------------
    def _state_tree(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt,
                "step": torch.tensor(self.step, dtype=torch.int32)}

    def _save(self, force: bool = False) -> None:
        if self.ckpt:
            self.ckpt.maybe_save(self.step, self._state_tree(), force=force)

    def _restore(self) -> None:
        if not self.ckpt:
            raise                # re-raise the failure: nothing to restore
        restored_step, tree = self.ckpt.restore_latest(self._state_tree())
        if restored_step is None:            # no checkpoint yet: step 0
            self.params = self._init_params()
            self.opt = init_opt_state(self.params)
            self.step = 0
        else:
            self.params, self.opt = tree["params"], tree["opt"]
            self.step = int(tree["step"])
        self.restarts += 1

    # -- main loop -----------------------------------------------------------
    def run(self, *, max_failures: int = 3) -> List[StepRecord]:
        failures = 0
        while self.step < self.tc.steps:
            try:
                self._run_until_done()
                break
            except Exception:
                failures += 1
                if failures > max_failures:
                    raise
                self._restore()
        if self.ckpt:
            self._save(force=True)
            self.ckpt.wait()
        return self.history

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """The stream's batch of `step` on the trainer's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in self.stream.batch_at(step).items()}

    def _run_until_done(self) -> None:
        while self.step < self.tc.steps:
            if self.failure_injector is not None:
                self.failure_injector(self.step)
            batch = self.batch_at(self.step)
            t0 = time.perf_counter()
            self.params, self.opt, metrics = self.train_step(
                self.params, self.opt, batch, torch.tensor(self.step))
            loss = float(metrics["loss"])     # waits for the step's kernels
            wall = time.perf_counter() - t0
            straggler = self._straggler.check(wall)
            self.history.append(StepRecord(self.step, loss, wall, straggler))
            self.step += 1
            self._save()

    # -- metrics -------------------------------------------------------------
    def summary(self) -> Dict[str, Any]:
        losses = [r.loss for r in self.history]
        return {
            "steps": self.step,
            "restarts": self.restarts,
            "first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "stragglers": sum(r.straggler for r in self.history),
            "mean_step_s": float(np.mean([r.wall_s for r in self.history]))
            if self.history else None,
        }
