"""Each span's device-stream and host time in one traced run of a benchmark cell.

    python3 tools/span_table.py --workload lm_stack.descent --seed 7 [--out spans.json]

Runs the cell's traced run (``chipbench/run.py ... --trace 1``, its result
line printed as usual) in this process on the card, then reads the program's
span table (``repro_torch.instrument.spans``).  For each span name: its
count, and its stream and host ms per unit of work, an epoch
(``popsim.epoch``) or a request (``popsim.log_metrics``).  For each parent
name: its children's stream time over its own, lowest and highest over its
records, and the largest share of one child.  ``epoch_stream_over_window``
is every epoch's stream time over the traced window.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import io
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def summary(records: list, window_s: float | None) -> dict:
    """The table's sums by name, per unit of work, and how children fill parents."""
    names = collections.Counter(r.name for r in records)
    unit = "popsim.epoch" if names["popsim.epoch"] else "popsim.log_metrics"
    n = names[unit]
    by = {}
    for name in names:
        rs = [r for r in records if r.name == name]
        stream = None if any(r.stream_s is None for r in rs) else sum(r.stream_s for r in rs)
        by[name] = {"count": len(rs), "host_ms_per": 1e3 * sum(r.host_s for r in rs) / n,
                    "stream_ms_per": None if stream is None else 1e3 * stream / n}
    ids = {r.id: r for r in records}
    kids = collections.defaultdict(list)
    for r in records:
        if r.parent in ids:
            kids[r.parent].append(r)
    fill = {}
    for pid, cs in kids.items():
        p = ids[pid]
        if p.stream_s is None or not p.stream_s or any(c.stream_s is None for c in cs):
            continue
        share = sum(c.stream_s for c in cs) / p.stream_s
        largest = max(c.stream_s for c in cs) / p.stream_s
        f = fill.setdefault(p.name, {"children": sorted({c.name for c in cs}), "low": share, "high": share,
                                     "largest_child": largest})
        f["low"], f["high"] = min(f["low"], share), max(f["high"], share)
        f["largest_child"] = max(f["largest_child"], largest)
    out = {"unit": unit, "units": n, "spans": by, "children_over_parent": fill}
    epochs = by.get("popsim.epoch", {}).get("stream_ms_per")
    if epochs is not None and window_s:
        out["epoch_stream_over_window"] = epochs * n / 1e3 / window_s
    return out


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="tools/span_table.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", type=pathlib.Path)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chipbench.harness import bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--workload", args.workload, "--seed", str(args.seed), "--seconds", "1", "--trace", "1"],
                        root=ROOT, t0=time.perf_counter())
    result = buf.getvalue().strip().splitlines()
    print("\n".join(result))
    if rc != 0:
        return rc
    from repro_torch import instrument

    line = json.loads(result[-1])
    out = dict(workload=args.workload, seed=args.seed, device=line["device"],
               **summary(instrument.spans(), line["device"].get("window_s")))
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
