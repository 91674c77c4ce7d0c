"""CLI: ``python -m splink_tpu_torch.analysis [--audit] [--perf-audit]
[--num-audit] [--device cpu] [--json]``.

Exit codes: 0 clean, 1 findings, 2 usage error. Every audit runs on
``cuda`` unless ``--device`` names another device, and gates against the
committed baselines of that device's tier. Paths to lint, the shard audit
and the thread audit belong to layers the port has not yet ported: asking
for them exits 2 with a message naming the ROADMAP item that will.
"""

from __future__ import annotations

import argparse
import sys

from .findings import Report

# what asking for an unported layer says (ROADMAP.md, Queue 1)
_NOT_PORTED = {
    "paths": "linting paths needs the static layers (the lint engine and its "
             "rules, numlint, threadlint), which ROADMAP Queue 1 item 12b ports",
    "--thread-audit": "--thread-audit is threadlint's, which ROADMAP Queue 1 item 12b "
                      "ports",
    "--shard-audit": "--shard-audit needs the multi-GPU mesh, which ROADMAP Queue 1 "
                     "item 7 ports",
}


def _names(value):
    return [k.strip() for k in value.split(",") if k.strip()] if value else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m splink_tpu_torch.analysis",
        description="the measured analysis layers: trace audit, perf audit, num audit",
    )
    parser.add_argument("paths", nargs="*", help=argparse.SUPPRESS)
    parser.add_argument("--json", action="store_true", help="machine-readable JSON output")
    parser.add_argument("--audit", action="store_true",
                        help="run the trace audit over the kernel registry")
    parser.add_argument("--perf-audit", action="store_true",
                        help="run the perf audit against this tier's perf_baselines.json")
    parser.add_argument("--num-audit", action="store_true",
                        help="run the numerics audit against this tier's num_baselines.json")
    parser.add_argument("--kernels",
                        help="comma-separated kernel names for every requested audit "
                             "(default: all)")
    parser.add_argument("--update-perf-baselines", action="store_true",
                        help="re-measure the perf plan and rewrite this tier's block of "
                             "perf_baselines.json (implies --perf-audit)")
    parser.add_argument("--update-num-baselines", action="store_true",
                        help="re-measure the ulp budgets and rewrite this tier's block of "
                             "num_baselines.json (implies --num-audit)")
    parser.add_argument("--list-perf-kernels", action="store_true",
                        help="print the perf-audit plan without measuring anything")
    parser.add_argument("--device", default=None,
                        help="the device the audits run on (default: cuda)")
    parser.add_argument("--shard-audit", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--thread-audit", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    for flag, asked in (("paths", bool(args.paths)),
                        ("--thread-audit", args.thread_audit),
                        ("--shard-audit", args.shard_audit)):
        if asked:
            print(f"error: not ported to splink_tpu_torch yet: {_NOT_PORTED[flag]}",
                  file=sys.stderr)
            return 2

    if args.list_perf_kernels:
        from .perf_audit import format_plan, perf_plan

        try:
            print(format_plan(perf_plan(_names(args.kernels))))
        except KeyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    perf = args.perf_audit or args.update_perf_baselines
    num = args.num_audit or args.update_num_baselines
    if not (args.audit or perf or num):
        parser.print_usage(sys.stderr)
        print("error: give at least one of --audit / --perf-audit / --num-audit",
              file=sys.stderr)
        return 2
    kernels = _names(args.kernels)
    report = Report()
    try:
        if args.audit:
            from .trace_audit import run_audit

            findings, report.kernels_audited = run_audit(kernels, args.device)
            report.extend(findings)
        if num:
            from .num_audit import current_tier, run_num_audit
            from .num_audit import update_baselines as update_num

            if args.update_num_baselines:
                new = update_num(kernels, device=args.device)
                tier = current_tier(args.device)
                print(f"wrote ulp budgets for {len(new['tiers'][tier]['kernels'])} "
                      f"kernel(s) on tier '{tier}'", file=sys.stderr)
            findings, report.num_kernels_audited = run_num_audit(kernels, device=args.device)
            report.extend(findings)
        if perf:
            from .perf_audit import current_tier, perf_plan, run_perf_audit
            from .perf_audit import update_baselines as update_perf

            tier = current_tier(args.device)
            if args.update_perf_baselines:
                new = update_perf(kernels, device=args.device)
                print(f"wrote perf baselines for {len(new['tiers'][tier]['kernels'])} "
                      f"kernel(s) on tier '{tier}'", file=sys.stderr)
                # the cells just measured ARE the new baselines
                report.perf_shapes_audited = len(perf_plan(kernels, tier))
            else:
                findings, report.perf_shapes_audited = run_perf_audit(
                    kernels, device=args.device)
                report.extend(findings)
    except KeyError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    print(report.format_json() if args.json else report.format_text())
    return 0 if report.clean else 1


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `... | head` closed the pipe: not an error
        sys.exit(0)
