"""The H100 pricer of the dry run's cells: three per-rank time terms and
what they say.

Port of the reference's `launch/roofline.py`. Per (arch x shape x mesh)
cell, from one rank's run of the step on meta tensors (`launch/dryrun.py`):

  compute    = operations (per rank)       / PEAK_BF16
  memory     = bytes moved (per rank)      / HBM_BW
  collective = bytes on the wire (per rank) / DEVICE_LINK_BYTES_PER_S

The rates are `core/costs.py`'s, for one NVIDIA H100 SXM at its 700 W
limit: the dense bf16 tensor-core peak, HBM3, and one direction of NVLink
4. Every collective is priced at the NVLink rate; a 16-wide "model" axis
spans two 8-card NVLink domains and the "pod" axis crosses hosts, so the
collective term is a floor. Operations come from
`torch.utils.flop_counter.FlopCounterMode` with the attention counted by
the kernel's own formula; bytes are what each eager operation reads and
writes (no fusion), with the attention kernel's own bytes; the wire
bytes are the ring price (`dist.compress.ring_psum_nbytes`) of every
buffer the step handed to all_reduce. The reference's HLO parse has no
counterpart: the step's own collectives are recorded.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from repro_torch.core.costs import DEVICE_LINK_BYTES_PER_S, HBM_BW, PEAK_BF16


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: float
    coll_breakdown: Dict[str, float]
    model_flops: float = 0.0            # 6 N D (train) / 2 N D (inference)
    n_devices: int = 256
    argument_bytes: Optional[int] = None
    temp_bytes: Optional[int] = None    # meta tensors cannot measure it

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_BF16

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_device / DEVICE_LINK_BYTES_PER_S

    @property
    def bottleneck(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / (the step's operations x ranks): remat and
        redundant compute show here."""
        total = self.flops_per_device * self.n_devices
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """The useful compute's time at peak over the bound's time."""
        t_useful = self.model_flops / (self.n_devices * PEAK_BF16)
        return t_useful / self.t_bound if self.t_bound else 0.0

    def row(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "flops_per_dev": self.flops_per_device,
            "bytes_per_dev": self.bytes_per_device,
            "coll_bytes_per_dev": self.coll_bytes_per_device,
            "flops_total": self.flops_per_device * self.n_devices,
            "useful_fraction": self.useful_flops_fraction,
            "roofline_fraction": self.roofline_fraction,
            "coll_breakdown": self.coll_breakdown,
            "arg_bytes_per_dev": self.argument_bytes,
            "temp_bytes_per_dev": self.temp_bytes,
        }


def model_flops_estimate(cfg, shape) -> float:
    """6 N D for training, 2 N D otherwise (MoE: N active), D the tokens
    the step processes; a decode step adds the attention's reads of the
    cache. The reference's formula."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    attn_read = 0.0
    if not cfg.attention_free:
        n_attn = sum(1 for k in cfg.superblock if k.startswith("attn"))
        n_attn *= cfg.num_superblocks
        # 2 (q k^T) + 2 (P v) operations per cached key element per head
        attn_read = (4.0 * shape.global_batch * shape.seq_len
                     * cfg.num_heads * cfg.head_dim_ * n_attn)
    return 2.0 * n * shape.global_batch + attn_read


def fmt_seconds(t: float) -> str:
    if t >= 1.0:
        return f"{t:.2f}s"
    if t >= 1e-3:
        return f"{t * 1e3:.2f}ms"
    return f"{t * 1e6:.1f}us"


def render_table(rows: List[Dict[str, Any]]) -> str:
    hdr = (f"{'arch':24s} {'shape':12s} {'mesh':7s} {'args/dev':>9s} "
           f"{'t_comp':>9s} {'t_mem':>9s} {'t_coll':>9s} {'bound':>10s} "
           f"{'useful':>7s} {'roofline':>8s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:7s} "
                         f"{r.get('status')}: "
                         f"{r.get('reason', r.get('error', ''))[:60]}")
            continue
        lines.append(
            f"{r['arch']:24s} {r['shape']:12s} {r['mesh']:7s} "
            f"{r['arg_bytes_per_dev'] / 1e9:>7.2f}GB "
            f"{fmt_seconds(r['t_compute_s']):>9s} "
            f"{fmt_seconds(r['t_memory_s']):>9s} "
            f"{fmt_seconds(r['t_collective_s']):>9s} "
            f"{r['bottleneck']:>10s} {r['useful_fraction']:>7.2%} "
            f"{r['roofline_fraction']:>8.2%}")
    return "\n".join(lines)
