"""``repro_torch`` command-line entry points (``python -m repro_torch ...``,
or the ``repro-torch`` script); the counterpart of the JAX package's
``repro`` CLI, with the same commands and exit codes.

Command families:

    store verify <store-dir>     audit a block store's shards against the
                                 manifest's ingest-time checksums (exit 0
                                 clean, 1 corrupt/missing, 2 unverifiable)

    obs merge <out> <in...>      merge Chrome trace files (e.g. one per run
                                 or host) into one multi-lane trace,
                                 schema-validated
    obs report <BENCH_obs.json>  per-kind calibration ratios, overhead
                                 gates, and the fleet straggler digest
    obs top <url>                `top`-style live frames from a PMVServer
                                 telemetry endpoint

Kept tiny and dependency-light: the CLI imports the store / obs layers
lazily, so ``--help`` never pays the torch import.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

__all__ = ["main"]


def _cmd_store_verify(args) -> int:
    from repro_torch.store.verify import verify_store

    report = verify_store(args.store_dir)
    print(report.summary())
    if report.skipped:
        return 2
    return 0 if report.ok else 1


def _cmd_obs_merge(args) -> int:
    from repro_torch.obs.fleet import merge_trace_docs
    from repro_torch.obs.trace import validate_chrome_trace

    docs = []
    for path in args.traces:
        with open(path) as f:
            docs.append(json.load(f))
    merged = merge_trace_docs(docs, labels=args.labels)
    validate_chrome_trace(merged)
    with open(args.out, "w") as f:
        json.dump(merged, f)
    events = [e for e in merged["traceEvents"] if e.get("ph") != "M"]
    lanes = {(e["pid"], e["tid"]) for e in events}
    print(f"merged {len(args.traces)} trace(s) -> {args.out}: "
          f"{len(events)} events across {len(lanes)} lanes")
    return 0


def _cmd_obs_report(args) -> int:
    from repro_torch.obs.report import format_calibration

    with open(args.bench) as f:
        doc = json.load(f)
    print(format_calibration(doc))
    return 0


def _cmd_obs_top(args) -> int:
    from urllib.request import urlopen

    from repro_torch.obs.live import format_top

    url = args.url.rstrip("/") + "/metrics.json"
    for i in range(args.count):
        if i:
            time.sleep(args.interval)
        with urlopen(url) as resp:
            snapshot = json.load(resp)
        print(format_top(snapshot))
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="repro_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    store = sub.add_parser("store", help="block-store maintenance")
    store_sub = store.add_subparsers(dest="store_command", required=True)

    verify = store_sub.add_parser(
        "verify", help="audit every shard against the manifest checksums")
    verify.add_argument("store_dir", help="ingested block-store directory")
    verify.set_defaults(fn=_cmd_store_verify)

    obs = sub.add_parser("obs", help="observability: traces, reports, live")
    obs_sub = obs.add_subparsers(dest="obs_command", required=True)

    merge = obs_sub.add_parser(
        "merge", help="merge Chrome trace files into one multi-lane trace")
    merge.add_argument("out", help="merged trace output path")
    merge.add_argument("traces", nargs="+", help="input trace.json files")
    merge.add_argument("--labels", nargs="*", default=None,
                       help="one lane-prefix label per input (default: "
                            "trace0, trace1, ...)")
    merge.set_defaults(fn=_cmd_obs_merge)

    report = obs_sub.add_parser(
        "report", help="print the calibration/fleet digest of a BENCH_obs.json")
    report.add_argument("bench", help="BENCH_obs.json path")
    report.set_defaults(fn=_cmd_obs_report)

    top = obs_sub.add_parser(
        "top", help="live text dashboard from a telemetry endpoint")
    top.add_argument("url", help="base URL of PMVServer telemetry "
                                 "(server.telemetry.url)")
    top.add_argument("--count", type=int, default=1,
                     help="frames to print (default 1)")
    top.add_argument("--interval", type=float, default=2.0,
                     help="seconds between frames (default 2)")
    top.set_defaults(fn=_cmd_obs_top)

    return parser


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
