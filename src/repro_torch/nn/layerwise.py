"""Hold a model's attention kernel against its plain version, layer by
layer.

A bf16 step of difference in an attention output can flip a token's
top-k experts in the next MoE layer, and a flipped route changes that
token's output by far more than rounding does; over a whole model the two
paths then drift apart for reasons that say nothing of the kernel. So
`compare_attention_paths` runs the model one layer at a time from the
kernel path's input, and runs each attention layer three times on that
same input: through `kops.flash_attention` (on the card, the kernel),
through the plain `flash_attention_ref` in the compute dtype, and through
the plain version in float32 rounded once to the compute dtype ("exact",
the control: the closest any attention in that dtype can come).

Compared, per layer: the mixer branch (x plus attention, before any
router), kernel against plain; for a MoE layer the routes, kernel against
plain and, as the control, exact against plain; and the layer's output,
kernel against plain, over the tokens whose expert sets and kept
assignments both agree (a token can be dropped at an expert's capacity in
one path and kept in the other when an earlier token's route flipped).
An SSM layer has no attention: it runs once.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch

from repro_torch.kernels import ref as kref

from . import lm
from . import transformer as tfm
from .config import ArchConfig
from .moe import MoEParams, routes


@dataclasses.dataclass
class LayerDiff:
    layer: int                # index in the whole stack
    kind: str                 # 'attn', 'attn_local' or 'ssm'
    moe: bool
    tokens: int
    mixer_diff: float         # max |kernel - plain| of x + mixer branch
    mixer_max: float          # max |plain| of the same
    routes_agree: int         # tokens whose expert sets agree, kernel vs
                              # plain (all tokens without a MoE)
    control_agree: int        # the same, exact vs plain
    kept_agree: int           # tokens whose expert sets and kept
                              # assignments agree, kernel vs plain
    max_abs_diff: float       # of the layer's output over those tokens
    max_abs_out: float        # of the plain path's output


def exact_attention(q, k, v, **kw):
    """The plain attention in float32, rounded once to the operands'
    dtype: the closest any attention in that dtype can come."""
    return kref.flash_attention_ref(q.float(), k.float(), v.float(),
                                    **kw).to(q.dtype)


def _routes(p, cfg: ArchConfig, r: torch.Tensor):
    """(sorted expert sets (T, k), the experts that kept each token (T,
    E)) of the MoE branch on the residual r."""
    idx, kept = routes(p["mlp"], cfg, tfm.apply_norm(p["pre_mlp_norm"], cfg,
                                                     r))
    return idx.sort(-1).values, kept


def compare_attention_paths(params: lm.LMParams, cfg: ArchConfig,
                            tokens: torch.Tensor) -> List[LayerDiff]:
    """Every layer of `params` over `tokens` (B, S) as above; the next
    layer takes the kernel path's output."""
    out: List[LayerDiff] = []
    with torch.inference_mode():
        x = lm.embed_tokens(params, cfg, tokens)
        positions = torch.arange(x.shape[1], device=x.device)
        n = x.shape[0] * x.shape[1]
        for blk in range(cfg.num_superblocks):
            layer = tfm.slice_block(params.stack, blk)
            for pos, kind in enumerate(cfg.superblock):
                p = layer[pos]
                paths = {"kernel": None}
                if kind.startswith("attn"):
                    paths.update(plain=kref.flash_attention_ref,
                                 exact=exact_attention)
                res = {name: tfm.mixer_residual(p, cfg, x, kind=kind,
                                                positions=positions,
                                                attention=fn)
                       for name, fn in paths.items()}
                for name in ("plain", "exact"):
                    res.setdefault(name, res["kernel"])
                every = torch.ones(n, dtype=torch.bool, device=x.device)
                agree = control = kept = every
                moe = isinstance(p.get("mlp"), MoEParams)
                if moe:
                    (ks, kk), (ps, pk), (es, _) = (
                        _routes(p, cfg, res[name])
                        for name in ("kernel", "plain", "exact"))
                    agree = (ks == ps).all(-1)
                    control = (es == ps).all(-1)
                    kept = agree & (kk == pk).all(-1)
                y = {name: tfm.mlp_residual(p, cfg, res[name])[0]
                     for name in ("kernel", "plain")}
                diff = (y["kernel"] - y["plain"]).float().flatten(0, 1)
                out.append(LayerDiff(
                    layer=blk * len(cfg.superblock) + pos, kind=kind,
                    moe=moe, tokens=n,
                    mixer_diff=float((res["kernel"] - res["plain"]).float()
                                     .abs().max()),
                    mixer_max=float(res["plain"].float().abs().max()),
                    routes_agree=int(agree.sum()),
                    control_agree=int(control.sum()),
                    kept_agree=int(kept.sum()),
                    max_abs_diff=float(diff[kept].abs().max())
                    if bool(kept.any()) else 0.0,
                    max_abs_out=float(y["plain"].float().abs().max())))
                x = y["kernel"]
    return out
