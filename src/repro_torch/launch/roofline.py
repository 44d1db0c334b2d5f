"""Roofline terms of a dry-run cell: the counterpart of the JAX package's
``launch/roofline.py``, with the same arithmetic and NVIDIA H100 constants.

Per (arch × shape × mesh):

    compute_s    = FLOPs_total      / (chips × peak FLOP/s of the dtype)
    memory_s     = HBM_bytes_total  / (chips × HBM B/s)
    collective_s = wire_bytes_per_device / link B/s

FLOPs and bytes are the trip-exact global counts of
:mod:`repro_torch.launch.flop_cost`; collective wire bytes are per-device
(:mod:`repro_torch.launch.comm_stats` records each rank's shard bytes), so
per-device seconds fall out directly.

MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) per trained token;
2·N_active per prefill/decode token. ``useful_ratio`` = MODEL_FLOPS / total
traced FLOPs — it flags remat/causal/padding waste. ``peak_fraction`` =
useful FLOP/s at the dominant-term step time over the peak.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["HW", "RooflineReport", "analyze", "model_flops_for_cell"]


@dataclasses.dataclass(frozen=True)
class HW:
    """One device's datasheet limits. The defaults are the NVIDIA H100
    SXM5's (the card ``nvidia-smi`` names NVIDIA H100 80GB HBM3, 700.00 W
    power limit): dense tensor-core peak for 16-bit inputs, the fp32
    (non-tensor-core) peak, HBM3 bandwidth, and one 400 Gb/s NDR port per
    GPU — the 16-wide ``model`` axis spans two 8-GPU NVLink domains, so
    its collectives cross the network."""
    peak_flops: float = 989.4e12        # bf16 / fp16 dense, FLOP/s
    peak_flops_fp32: float = 66.9e12    # fp32, FLOP/s
    hbm_bw: float = 3.35e12             # B/s per device
    link_bw: float = 50e9               # B/s per device (one NDR port)
    name: str = "NVIDIA H100 80GB HBM3, 700.00 W (SXM5 datasheet)"

    def peak_for(self, dtype=None) -> float:
        """The peak for computation in ``dtype`` (16-bit by default)."""
        if dtype in (torch.float32, torch.float64):
            return self.peak_flops_fp32
        return self.peak_flops


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # trip-exact counts (FLOPs and bytes are global → /chips)
    flops_total: float
    bytes_total: float
    coll_wire_bytes_per_device: float
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float
    useful_ratio: float
    peak_fraction: float
    # the reference's compiler cost analysis (none in an eager port: 0)
    xla_flops_per_device: float
    xla_bytes_per_device: float
    memory_stats: dict
    collectives: dict
    notes: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def model_flops_for_cell(cfg, shape) -> float:
    """Analytic useful FLOPs for one step of this cell."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        return 2.0 * n_active * tokens
    return 2.0 * n_active * shape.global_batch      # decode: 1 new token/seq


def analyze(arch: str, shape, mesh_name: str, chips: int, cost: dict,
            memory_stats: dict, collectives: dict, cfg, flop_stats: dict,
            hw: HW = HW(), notes: str = "", dtype=None) -> RooflineReport:
    """``cost``: a compiler's per-device cost analysis, if any ({} here);
    ``collectives``: :func:`~repro_torch.launch.comm_stats.
    collective_stats` output; ``flop_stats``: :func:`~repro_torch.launch.
    flop_cost.trace_cost` output; ``dtype``: the computation's dtype,
    which picks the peak."""
    xla_flops_dev = float(cost.get("flops", 0.0))
    xla_bytes_dev = float(cost.get("bytes accessed", 0.0))
    flops_total = float(flop_stats["flops"])
    wire_dev = float(collectives["_total"]["wire_bytes"])
    bytes_total = float(flop_stats["bytes"])    # fusion-modelled
    peak = hw.peak_for(dtype)

    compute_s = flops_total / (chips * peak)
    memory_s = bytes_total / (chips * hw.hbm_bw)
    collective_s = wire_dev / hw.link_bw            # already per-device
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    bottleneck = max(terms, key=terms.get)

    mflops = model_flops_for_cell(cfg, shape)
    useful = mflops / flops_total if flops_total else 0.0
    step_s = max(terms.values()) or 1e-30
    peak_fraction = (mflops / chips / step_s) / peak

    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        flops_total=flops_total, bytes_total=bytes_total,
        coll_wire_bytes_per_device=wire_dev,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=mflops, useful_ratio=useful,
        peak_fraction=peak_fraction,
        xla_flops_per_device=xla_flops_dev,
        xla_bytes_per_device=xla_bytes_dev,
        memory_stats=memory_stats,
        collectives=dict(collectives),
        notes=notes)
