"""Merge a gang's flight dumps into one pod timeline (the merge mode of
the reference's scripts/pod_trace.py):

    python -m paddle_tpu_torch.observability.pod_trace <dump_dir> \
        [--out DIR] [--top-k N] [--anchor-us T]

`dump_dir` is the gang's shared FLAGS_flight_dump_dir or a pod dump dir
the launcher collected (`--collect-dumps`). It writes `pod_trace.json`
(one Perfetto timeline: a lane per rank, flow arrows between equal
collective keys) and `straggler_report.json` to `--out` (default
`<dump_dir>/pod`), and prints the per-rank scores and the slowest
collectives by arrival skew. A `heartbeats.json` beside the dumps (the
launcher writes one) adds the supervisor's heartbeats and rendezvous
anchor.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import podscope


def merge(dump_dir: str, out_dir: str, top_k: int = 10,
          anchor_us=None, quiet: bool = False) -> dict:
    """Write the pod artifacts of the dumps in `dump_dir` to `out_dir`;
    returns `podscope.write_pod_dump`'s result."""
    dumps = podscope.find_rank_dumps(dump_dir)
    if not dumps:
        raise SystemExit(f"no flight dumps found in {dump_dir}")
    heartbeats = None
    hb_path = os.path.join(dump_dir, "heartbeats.json")
    if os.path.exists(hb_path):
        try:
            with open(hb_path) as f:
                meta = json.load(f)
            heartbeats = {int(r): v
                          for r, v in (meta.get("heartbeats") or {}).items()}
            if anchor_us is None:
                anchor_us = meta.get("anchor_us")
        except (OSError, ValueError):
            pass
    res = podscope.write_pod_dump(dumps, out_dir, heartbeats=heartbeats,
                                  anchor_us=anchor_us, top_k=top_k)
    if not quiet:
        with open(res["report"]) as f:
            report = json.load(f)
        print(f"merged {len(dumps)} rank dump(s) (ranks "
              f"{res['meta']['ranks']}) -> {res['trace']}")
        print(f"cross-rank collective flow pairs: "
              f"{res['meta']['flow_pairs']}")
        print(f"straggler report: {res['report']}")
        for r, info in report["ranks"].items():
            print(f"  rank {r}: score {info['straggler_score']:.3f} "
                  f"(last@{info['collectives_last']} collectives, "
                  f"last step {info['last_step']}, "
                  f"mean step {info['mean_step_ms']} ms)")
        suspect = report["suspect"]
        print(f"suspect: {'none' if suspect is None else f'rank {suspect}'}"
              f"  step-time spread "
              f"{report['summary']['step_time_spread_ms']} ms, "
              f"collective stall fraction "
              f"{report['summary']['collective_stall_fraction']}")
        print("\nslowest collectives by stall:")
        print(podscope.format_stall_table(
            podscope.collective_telemetry(dumps), top_k))
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser("paddle_tpu_torch.observability.pod_trace")
    p.add_argument("dump_dir",
                   help="directory of per-rank flight dumps (the gang's "
                        "shared FLAGS_flight_dump_dir or a collected pod "
                        "dump dir)")
    p.add_argument("--out", default=None,
                   help="output dir for pod_trace.json and "
                        "straggler_report.json (default: <dump_dir>/pod)")
    p.add_argument("--top-k", type=int, default=10,
                   help="rows in the slowest-collectives-by-stall table")
    p.add_argument("--anchor-us", type=float, default=None,
                   help="wall-clock t0 (us) to re-zero the merged timeline "
                        "at (default: the supervisor's rendezvous anchor, "
                        "else the earliest event)")
    args = p.parse_args(argv)
    merge(args.dump_dir, args.out or os.path.join(args.dump_dir, "pod"),
          top_k=args.top_k, anchor_us=args.anchor_us)
    return 0


if __name__ == "__main__":
    sys.exit(main())
