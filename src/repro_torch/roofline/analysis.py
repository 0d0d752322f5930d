"""Three-term roofline of one rank's step.

Port of ``repro.roofline.analysis``:

  compute  = FLOPs_per_device / peak_FLOP/s
  memory   = bytes_per_device / HBM_bw
  collect. = per-device collective bytes / link_bw

over the H100's constants (``roofline.hw``). The reference reads the FLOPs
and bytes off XLA's compiled HLO and parses the collectives out of its text
(``collective_bytes_from_hlo``). The port has no compiler: its model runs
eagerly and writes every collective out (``models.pshard``), so it counts
them where they run, and ``collective_bytes`` maps those counts to the
reference's kind names under the reference's conventions: an all-gather
counts the result (D blocks), a reduce-scatter the operand, an all-reduce
twice the payload (a ring's reduce-scatter and all-gather). The FLOPs and
bytes come from ``roofline.op_cost``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.roofline import hw

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# models/pshard.py's counter kinds -> the reference's HLO kind names
PSHARD_KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
                "reduce_scatter": "reduce-scatter"}


def collective_bytes(counts: Dict[str, Dict[str, int]]) -> Dict[str, int]:
    """Per-device bytes moved by each collective kind, from
    ``pshard.counts()`` ({kind: {"calls", "bytes"}}), keyed as the
    reference's ``collective_bytes_from_hlo`` keys them. pshard already
    counts by the reference's conventions: an all-gather the D blocks it
    fills, a psum (the port's all-reduce: an all-to-all of the blocks, the
    rank-order sum, an all-gather) two payloads, a reduce-scatter the
    blocks it receives, the operand's size."""
    out = {k: 0 for k in KINDS}
    for kind, c in counts.items():
        if kind not in PSHARD_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        out[PSHARD_KINDS[kind]] += int(c["bytes"])
    return out


def roofline_terms(
    flops_per_device: float,
    bytes_per_device: float,
    collective_bytes: Dict[str, int],
) -> Dict:
    coll_total = sum(collective_bytes.values())
    t_compute = flops_per_device / hw.PEAK_FLOPS_BF16
    t_memory = bytes_per_device / hw.HBM_BW
    t_coll = coll_total / hw.LINK_BW
    terms = {"compute_s": t_compute, "memory_s": t_memory, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    total = sum(terms.values())
    return {
        **terms,
        "dominant": dominant,
        "collective_bytes": collective_bytes,
        "collective_bytes_total": coll_total,
        # fraction of a perfectly-overlapped step spent on the dominant term
        "dominant_fraction": bound / total if total > 0 else 0.0,
    }


def model_flops(param_count: int, tokens: int, mode: str = "train") -> float:
    """6·N·D for training, 2·N·D for inference forward (per global step)."""
    mult = 6 if mode == "train" else 2
    return mult * param_count * tokens
