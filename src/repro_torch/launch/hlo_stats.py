"""Collective-traffic accounting for the roofline, from a traced program.

The reference parses the per-device HLO for its collectives.  Here a
``hlo_costs.trace`` records each c10d functional collective a rank issues
(its kind, output bytes, dtype and group), DTensor's redistributions and the
explicit ones alike, and :func:`collective_stats` folds them with the
reference's ring factors into per-rank *link bytes*: an all-reduce of N
bytes over a group of g moves 2N(g-1)/g per rank, and so on.

An eager trace has no loop whose trip count would multiply a body's
collectives: every layer's collectives are recorded as they run.  So the
counterpart of the reference's ``while_trip_counts`` is :func:`layer_loops`,
the layer loops the model ran and their counts.

:func:`collective_seconds` turns the records into the roofline's collective
term over the links of an NVIDIA H100 SXM node (``dryrun``'s constants): a
group inside one 8-GPU node rides NVLink, a group that spans nodes one NDR
InfiniBand port a GPU.
"""
from __future__ import annotations

from collections import defaultdict

GPUS_PER_NODE = 8  # an HGX H100 node


def _link_bytes(kind: str, out_bytes: int, g: int) -> float:
    """Per-rank bytes over the links (ring implementations)."""
    if g <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if kind == "all-gather":
        return out_bytes * (g - 1) / g
    if kind == "reduce-scatter":
        return out_bytes * (g - 1)
    if kind == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


def _records(trace_or_records) -> list[dict]:
    return trace_or_records if isinstance(trace_or_records, list) else trace_or_records.collectives


def collective_stats(trace_or_records) -> dict:
    """The reference's dict (bytes_by_kind, counts, total_bytes, f32_bytes,
    lp_bytes, tpu_adjusted_bytes) of a trace's collectives, per rank.  Each
    record carries its real dtype; ``tpu_adjusted_bytes`` keeps the
    reference's what-if (float32 traffic sent as bf16) under its name."""
    import torch

    acc: dict = defaultdict(float)
    counts: dict = defaultdict(int)
    for r in _records(trace_or_records):
        lb = _link_bytes(r["kind"], r["bytes"], r["group_size"])
        acc[r["kind"]] += lb
        acc["@f32" if r["dtype"] in (torch.float32, torch.float64) else "@lp"] += lb
        counts[r["kind"]] += 1
    bytes_by_kind = {k: int(v) for k, v in acc.items() if not k.startswith("@")}
    f32_bytes, lp_bytes = int(acc.get("@f32", 0)), int(acc.get("@lp", 0))
    return {
        "bytes_by_kind": bytes_by_kind,
        "counts": dict(counts),
        "total_bytes": int(sum(bytes_by_kind.values())),
        "f32_bytes": f32_bytes,
        "lp_bytes": lp_bytes,
        "tpu_adjusted_bytes": int(f32_bytes / 2 + lp_bytes),
    }


def spans_nodes(ranks, per_node: int = GPUS_PER_NODE) -> bool:
    return len({r // per_node for r in ranks}) > 1


def collective_seconds(trace_or_records, intra_bw: float, inter_bw: float) -> float:
    """Seconds of link time a rank spends in its collectives: each one's
    link bytes over ``intra_bw`` (its group inside one node) or ``inter_bw``
    (a group across nodes)."""
    t = 0.0
    for r in _records(trace_or_records):
        bw = inter_bw if spans_nodes(r["ranks"]) else intra_bw
        t += _link_bytes(r["kind"], r["bytes"], r["group_size"]) / bw
    return t


def layer_loops(trace) -> list[dict]:
    """The layer (and loss-chunk) loops the traced program ran, in order:
    [{"loop": name, "trips": n}, ...] (a forward and its recompute each note
    theirs)."""
    return [{"loop": name, "trips": n} for name, n in trace.loops]
