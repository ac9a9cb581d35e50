"""Three-term roofline model from the dry run's traced step (counterpart
of ``repro.analysis.roofline``).

Per (arch x shape x mesh) cell, per device:

  compute term    = flops per device      / PEAK_FLOPS
  memory term     = HBM bytes per device  / HBM_BW
  collective term = wire bytes per device / LINK_BW

The per-device counts come from ``analysis/step_stats.py``, which counts
the traced step on each device's local shards.

Hardware constants: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity, at the full 700 W limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3,
and NVLink 4 at 900 GB/s both ways, so 450 GB/s each way. NVLink joins
the 8 GPUs of one node; a (16, 16) or (2, 16, 16) mesh spans nodes, and
its traffic between nodes runs over the network, which is slower. So
``t_collective`` here is a bound at NVLink's rate, a lower bound on the
collective time of such a mesh. The reference's single link term is
kept as it is: no term for the network between nodes is added.

The reference's ``parse_collectives`` reads the collectives of XLA's HLO
text. Nothing in the port produces HLO: the collectives are counted on
the traced step itself (``step_stats.StepStats.collectives``), so it is
not ported.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

PEAK_FLOPS = 989e12      # bf16 per GPU, dense
HBM_BW = 3.35e12         # bytes/s per GPU
LINK_BW = 450e9          # bytes/s per GPU, NVLink 4, one way


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_wire_bytes: float
    collectives: Dict[str, Dict[str, float]]
    model_flops_total: float            # 6*N*D (or 6*N_active*D for MoE)
    memory_per_device: Optional[dict] = None

    # ---- the three terms (seconds per step, per device)
    @property
    def t_compute(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.collective_wire_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound(self) -> float:
        """Perfect-overlap bound: max of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced flops (remat and redundancy waste)."""
        traced_total = self.flops_per_device * self.chips
        return self.model_flops_total / traced_total if traced_total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        t = self.step_time_lower_bound
        if t <= 0:
            return 0.0
        return (self.model_flops_total / self.chips / t) / PEAK_FLOPS

    def to_json(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_wire_bytes": self.collective_wire_bytes,
            "collectives": self.collectives,
            "model_flops_total": self.model_flops_total,
            "memory_per_device": self.memory_per_device,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
        }


def model_flops(arch, shape, n_params: int, n_active: Optional[int] = None
                ) -> float:
    """6*N*D for training; 2*N*D for a forward pass; decode D = batch
    tokens (one token per sequence per step)."""
    n = n_active if n_active is not None else n_params
    if shape.mode == "train":
        return 6.0 * n * shape.tokens
    if shape.mode == "prefill":
        return 2.0 * n * shape.tokens
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def count_total_and_active_params(cfg) -> Tuple[int, int]:
    """(total, active) parameter counts over the model's spec tree;
    active discounts routed experts by top_k / num_experts (MODEL_FLOPS
    uses active for MoE). Nothing is allocated."""
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model_zoo import build_model

    total = expert = 0
    for _, leaf in tree_leaves(build_model(cfg).spec_tree()):
        sz = math.prod(leaf.shape)
        total += sz
        if "expert" in leaf.logical:
            expert += sz
    if cfg.moe is None:
        return total, total
    frac = cfg.moe.top_k / cfg.moe.num_experts
    return total, int(total - expert + expert * frac)
