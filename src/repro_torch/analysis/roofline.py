"""Three-term roofline of one rank's step, with the H100's ceilings: the
counterpart of the JAX package's ``analysis/roofline.py``.

No TPU constant is carried over.  Ceilings, for an NVIDIA H100 80GB
HBM3 (SXM) at its 700 W power limit:

  PEAK_FLOPS  bf16 dense tensor-core rate, MEASURED: ``chip_smoke.py``
              phase 27's 8192³ bf16 ``torch.mm`` under CUDA events read
              738.2, 770.1 and 798.0 TFLOP/s in three calls; the highest
  HBM_BW      MEASURED: ``chip_smoke.py`` phase 2's device-to-device
              copy rate (read + write counted) read 2993.3, 3005.4 and
              3023.8 GB/s in three runs of the script; the highest
  NVLINK_BW   450 GB/s a direction a card (NVLink 4, 900 GB/s both
              ways): NVIDIA's data sheet, NOT MEASURED (the card machine
              holds one card)
  NIC_BW      50 GB/s a card (one 400 Gb/s ConnectX-7 NIC a card): the
              data sheet, NOT MEASURED

  compute    = FLOPs  / PEAK_FLOPS
  memory     = bytes  / HBM_BW
  collective = NVLink bytes / NVLINK_BW + NIC bytes / NIC_BW

A group of at most ``NODE_RANKS`` (8) consecutive ranks talks over
NVLink; a larger group, or one that crosses pods, over the NICs
(``analysis/collectives.py``).  ``dcn_s`` is the pod-crossing part at
the NIC rate.  The data sheet's figures for the measured two: 989
TFLOP/s bf16 dense and 3.35 TB/s.  So ``ideal_s`` and
``roofline_fraction`` are against what a library call reaches on this
card, not its data-sheet peak: a compute-bound cell's share reads up to
989 / 798 = 1.24 times, a memory-bound one's 3350 / 3023.8 = 1.11
times, what it would against the data sheet.

MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE) for train cells
(2·N·D for prefill; decode uses 2·N·B per step fwd), as in the JAX
package.  The ratio MODEL_FLOPS / counted FLOPs exposes remat, dispatch
and rectangle waste.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ArchConfig, ShapeConfig

#: the card the measured ceilings come from
CARD = "NVIDIA H100 80GB HBM3, 700.00 W power limit"
PEAK_FLOPS = 798.0e12    # bf16 dense, chip_smoke.py phase 27, measured
HBM_BW = 3023.8e9        # B/s, chip_smoke.py phase 2, measured
NVLINK_BW = 450e9        # B/s a direction a card, data sheet, not measured
NIC_BW = 50e9            # B/s a card, data sheet, not measured


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Useful FLOPs per step: 6·N_active·tokens (train) etc."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def model_bytes(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Minimum HBM bytes per step.  Decode is weight-read-bound: every
    active param (bf16) must be read once per step regardless of batch —
    the bandwidth floor that MODEL_FLOPS alone misses at batch ≤ 128."""
    if shape.kind != "decode":
        return 0.0
    return 2.0 * cfg.active_param_count()


@dataclass
class Roofline:
    """All byte/flop inputs are PER-RANK; ``model_flops_`` is global and
    normalized by ``chips``.  ``nic_bytes`` is the part of
    ``coll_bytes`` charged at the NIC rate."""

    flops: float
    hbm_bytes: float
    coll_bytes: float
    dcn_bytes: float
    chips: int
    model_flops_: float
    model_bytes_: float = 0.0
    nic_bytes: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return ((self.coll_bytes - self.nic_bytes) / NVLINK_BW
                + self.nic_bytes / NIC_BW)

    @property
    def dcn_s(self) -> float:
        return self.dcn_bytes / NIC_BW

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Optimistic no-overlap-free bound: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        per_chip_model = self.model_flops_ / self.chips
        return per_chip_model / self.flops if self.flops else 0.0

    @property
    def ideal_s(self) -> float:
        """Best achievable step time: useful FLOPs at peak, or the
        weight-read bandwidth floor (decode), whichever binds."""
        return max(
            self.model_flops_ / (self.chips * PEAK_FLOPS),
            self.model_bytes_ / (self.chips * HBM_BW),
        )

    @property
    def roofline_fraction(self) -> float:
        """ideal_s / step_time — the score to climb."""
        return self.ideal_s / self.step_time_s if self.step_time_s else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "nic_bytes": self.nic_bytes,
            "dcn_bytes": self.dcn_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops_,
            "model_bytes": self.model_bytes_,
            "ideal_s": self.ideal_s,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dcn_s": self.dcn_s,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "step_time_s": self.step_time_s,
            "ceilings": {"card": CARD, "peak_flops": PEAK_FLOPS,
                         "hbm_bw": HBM_BW, "nvlink_bw": NVLINK_BW,
                         "nic_bw": NIC_BW},
        }


def from_counts(cost, coll, chips: int, cfg: ArchConfig,
                shape: ShapeConfig) -> Roofline:
    """The roofline of a rank's counted step: ``cost`` from
    ``analysis/op_cost.py``, ``coll`` the recorded collectives'
    :class:`~repro_torch.analysis.collectives.CollectiveStats`."""
    return Roofline(
        flops=float(cost.flops),
        hbm_bytes=float(cost.bytes_),
        coll_bytes=float(coll.total_bytes),
        dcn_bytes=float(coll.dcn_bytes),
        chips=chips,
        model_flops_=model_flops(cfg, shape),
        model_bytes_=model_bytes(cfg, shape),
        nic_bytes=float(coll.nic_bytes),
    )
