"""Roofline terms on one NVIDIA H100 SXM (port of ``repro/core/roofline.py``).

Three terms per (arch x shape x mesh) cell, in seconds, per rank:

    compute    = FLOPs / peak       by operand type: 989 TFLOP/s bf16 dense,
                                    1,979 TOP/s int8 dense, 67 TFLOP/s f32
    memory     = HBM bytes / 3.35 TB/s (HBM3)
    collective = bytes moved / link: 450 GB/s NVLink a direction inside a node
                 of 8 ranks, 50 GB/s (one 400 Gb/s NIC a GPU) across nodes

The constants are the H100 SXM datasheet's, the same figures ``PERF.md``
bounds each kernel with.  Ranks map to nodes row-major: node = rank // 8
in the mesh's order, so a group whose ranks span two nodes runs its ring
over the network.

The reference reads its FLOPs and bytes from XLA's ``cost_analysis`` and
its collectives from the optimized HLO text.  Torch has neither: the
planner (``launch/dryrun.py``) counts FLOPs and bytes from a trace of
the port's step on ``meta``, and :func:`collective_bytes` reads
collective records (kind, result bytes on a rank, the group) that the
port's collectives log (``collectives.log``) instead of HLO lines.
``cpu_bf16_inflation_bytes`` has no torch meaning: it corrected XLA:CPU's
float-normalized buffers, and nothing here is compiled for the CPU.
``analyze(compiled)`` has none either: there is no compiled artifact to
read; :class:`Roofline` is built from the planner's counts.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
PEAK_INT8_OPS = 1979e12      # int8 dense, tensor cores
PEAK_F32_FLOPS = 67e12       # f32, CUDA cores (TF32 off)
PEAKS = {"bf16": PEAK_FLOPS, "int8": PEAK_INT8_OPS, "f32": PEAK_F32_FLOPS}
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s a direction, inside a node
NET_BW = 50e9                # bytes/s a GPU, across nodes
GPUS_PER_NODE = 8
CARD_BYTES = 80e9            # one H100's device memory

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")


def crosses_nodes(ranks) -> bool:
    """Whether a group's global ranks sit on more than one node."""
    return len({r // GPUS_PER_NODE for r in ranks}) > 1


def collective_bytes(records) -> dict:
    """Bytes a rank moves over the interconnect, per collective kind.

    ``records``: (kind, result bytes on the rank, group) each, the group
    its global ranks or just its size (then taken as one node's).  Ring
    models (R the result's bytes on a rank, n the group's size), as the
    reference's:
      all-gather:          R * (n-1)/n      received
      all-reduce:          2R * (n-1)/n     (reduce-scatter + all-gather)
      reduce-scatter:      R * (n-1)        (input = n*R, each rank sends)
      all-to-all:          R * (n-1)/n
      collective-permute:  R
    ``"cross_node"`` holds the part of ``"total"`` whose groups span nodes."""
    out = {k: 0.0 for k in _COLLECTIVES}
    counts = {k: 0 for k in _COLLECTIVES}
    cross = 0.0
    for kind, r, group in records:
        if kind not in out:
            raise ValueError(f"unknown collective kind {kind!r}")
        n = group if isinstance(group, int) else len(group)
        if n <= 1:
            continue
        if kind == "all-gather":
            b = r * (n - 1) / n
        elif kind == "all-reduce":
            b = 2 * r * (n - 1) / n
        elif kind == "reduce-scatter":
            b = r * (n - 1)
        elif kind == "all-to-all":
            b = r * (n - 1) / n
        else:  # collective-permute
            b = r
        out[kind] += b
        counts[kind] += 1
        if not isinstance(group, int) and crosses_nodes(group):
            cross += b
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["cross_node"] = cross
    out["counts"] = counts
    return out


@dataclass
class Roofline:
    flops: float                 # per rank
    hbm_bytes: float             # per rank
    coll_bytes: float            # per rank
    coll_detail: dict
    peak_memory_bytes: float     # per rank
    # FLOPs by operand type ("bf16", "int8", "f32"); None: all at the bf16 peak
    flops_by_type: dict | None = field(default=None)
    coll_cross_bytes: float = 0.0    # the part of coll_bytes that crosses nodes

    @property
    def compute_s(self) -> float:
        if self.flops_by_type is None:
            return self.flops / PEAK_FLOPS
        return sum(v / PEAKS[k] for k, v in self.flops_by_type.items())

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        inside = self.coll_bytes - self.coll_cross_bytes
        return inside / NVLINK_BW + self.coll_cross_bytes / NET_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        """Perfect-overlap execution model: max of the three engines."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def roofline_fraction(self) -> float:
        """Fraction of the time the bound engine does useful work if the
        other two were free — compute_s / total under perfect overlap."""
        return self.compute_s / max(self.total_s, 1e-30)

    def as_dict(self) -> dict:
        return {
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction(),
            "peak_memory_gb": self.peak_memory_bytes / 1e9,
            "collectives": {k: v for k, v in self.coll_detail.items()
                            if k != "counts"},
            "collective_counts": self.coll_detail.get("counts", {}),
        }


def model_flops(cfg, shape) -> float:
    """6 * N_active * D (train) or 2 * N_active * D (inference), global."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * n * tokens
