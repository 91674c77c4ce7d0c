"""CLI: ``python -m splink_tpu_torch.analysis [paths...] [--rules ...]
[--audit] [--shard-audit] [--perf-audit] [--num-audit] [--thread-audit]
[--kernels ...] [--audit-kernels ...] [--shard-kernels ...]
[--perf-kernels ...] [--num-kernels ...] [--device cpu] [--json]``.

Exit codes: 0 clean, 1 findings, 2 usage error. Paths are linted by
:mod:`.torchlint` and then by :mod:`.numlint` (pure ``ast``: no device);
an explicit ``--rules`` list is split between them by the ``NL`` prefix.
The thread audit (:mod:`.threadlint`, ``--thread-audit`` /
``--thread-classes`` / ``--lock-graph``) is pure ``ast`` too. Every other
audit runs on ``cuda`` unless ``--device`` names another device, and gates
against the committed baselines of that device's tier. Each audit's own
``--*-kernels`` list narrows that audit and implies it; ``--kernels`` is the
list for every requested audit that has no list of its own.
"""

from __future__ import annotations

import argparse
import sys

from .findings import Report


def _names(value):
    return [k.strip() for k in value.split(",") if k.strip()] if value else None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m splink_tpu_torch.analysis",
        description="torchlint and numlint over paths, the thread audit, and the "
                    "measured analysis layers: trace audit, shard audit, perf audit, "
                    "num audit",
    )
    parser.add_argument("paths", nargs="*", help="files or directories to lint")
    parser.add_argument("--json", action="store_true", help="machine-readable JSON output")
    parser.add_argument("--rules", help="comma-separated rule ids to run (default: all)")
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    parser.add_argument("--audit", action="store_true",
                        help="run the trace audit over the kernel registry")
    parser.add_argument("--audit-kernels",
                        help="comma-separated kernel names to audit (implies --audit)")
    parser.add_argument("--shard-audit", action="store_true",
                        help="run the partition audit of the sharded kernels against this "
                             "tier's shard_baselines.json")
    parser.add_argument("--shard-kernels",
                        help="comma-separated shard kernel names (implies --shard-audit)")
    parser.add_argument("--update-baselines", action="store_true",
                        help="re-measure the shard registry and rewrite this tier's block "
                             "of shard_baselines.json (implies --shard-audit)")
    parser.add_argument("--perf-audit", action="store_true",
                        help="run the perf audit against this tier's perf_baselines.json")
    parser.add_argument("--perf-kernels",
                        help="comma-separated kernel names to perf-audit (implies "
                             "--perf-audit)")
    parser.add_argument("--num-audit", action="store_true",
                        help="run the numerics audit against this tier's num_baselines.json")
    parser.add_argument("--num-kernels",
                        help="comma-separated kernel names to numerics-audit (implies "
                             "--num-audit)")
    parser.add_argument("--kernels",
                        help="comma-separated kernel names for every requested audit "
                             "without its own --*-kernels list, shard kernels included "
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
    parser.add_argument("--thread-audit", action="store_true",
                        help="run the concurrency audit over the registered serve and obs "
                             "classes (pure AST, no device)")
    parser.add_argument("--thread-classes",
                        help="comma-separated class names to thread-audit (implies "
                             "--thread-audit)")
    parser.add_argument("--lock-graph", metavar="PATH",
                        help="write the static lock-order graph as JSON (implies "
                             "--thread-audit)")
    args = parser.parse_args(argv)

    if args.list_rules:
        from .numlint import NL_RULES
        from .rules import RULES
        from .threadlint import TL_RULES

        for spec in sorted(RULES.values(), key=lambda s: s.id):
            print(f"{spec.id}  {spec.title}\n       {spec.doc}")
        for catalog in (TL_RULES, NL_RULES):
            for rule_id, (title, doc) in sorted(catalog.items()):
                print(f"{rule_id}  {title}\n       {doc}")
        return 0

    kernels = _names(args.kernels)
    # an audit's own list narrows it and implies it; --kernels fills the rest
    audit_kernels = _names(args.audit_kernels) or kernels
    shard_kernels = _names(args.shard_kernels) or kernels
    perf_kernels = _names(args.perf_kernels) or kernels
    num_kernels = _names(args.num_kernels) or kernels

    if args.list_perf_kernels:
        from .perf_audit import format_plan, perf_plan

        try:
            print(format_plan(perf_plan(perf_kernels)))
        except KeyError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        return 0

    audit = args.audit or args.audit_kernels
    perf = args.perf_audit or args.perf_kernels or args.update_perf_baselines
    num = args.num_audit or args.num_kernels or args.update_num_baselines
    shard = args.shard_audit or args.shard_kernels or args.update_baselines
    thread = args.thread_audit or args.thread_classes or args.lock_graph
    if not (args.paths or audit or shard or perf or num or thread):
        parser.print_usage(sys.stderr)
        print("error: give at least one of: a path to lint, --audit, --shard-audit, "
              "--perf-audit, --num-audit, --thread-audit", file=sys.stderr)
        return 2
    report = Report()
    rules = _names(args.rules)
    # NL rules are numlint's, every other id torchlint's; each engine rejects
    # ids it does not know, so an explicit list is split by the prefix
    nl_rules = tl_rules = None
    if rules is not None:
        nl_rules = [r for r in rules if r.upper().startswith("NL")]
        tl_rules = [r for r in rules if not r.upper().startswith("NL")]
    try:
        if args.paths:
            from .numlint import numlint_paths
            from .torchlint import lint_paths

            report = lint_paths(args.paths, tl_rules)
            # the same files, a second rule set: files_checked already counts them
            report.extend(numlint_paths(args.paths, nl_rules).findings)
        if thread:
            from .threadlint import run_thread_audit, write_lock_graph

            findings, report.thread_classes_audited, graph = run_thread_audit(
                _names(args.thread_classes))
            report.extend(findings)
            if args.lock_graph:
                write_lock_graph(args.lock_graph, graph)
                print(f"wrote lock graph to {args.lock_graph}", file=sys.stderr)
    except (FileNotFoundError, KeyError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        if audit:
            from .trace_audit import run_audit

            findings, report.kernels_audited = run_audit(audit_kernels, args.device)
            report.extend(findings)
        if shard:
            from .perf_audit import current_tier
            from .shard_audit import run_shard_audit
            from .shard_audit import update_baselines as update_shard

            if args.update_baselines:
                new = update_shard(shard_kernels, device=args.device)
                tier = current_tier(args.device)
                print(f"wrote shard baselines for {len(new['tiers'][tier]['kernels'])} "
                      f"kernel(s) on tier '{tier}'", file=sys.stderr)
            findings, report.shard_kernels_audited = run_shard_audit(
                shard_kernels, device=args.device)
            report.extend(findings)
        if num:
            from .num_audit import current_tier, run_num_audit
            from .num_audit import update_baselines as update_num

            if args.update_num_baselines:
                new = update_num(num_kernels, device=args.device)
                tier = current_tier(args.device)
                print(f"wrote ulp budgets for {len(new['tiers'][tier]['kernels'])} "
                      f"kernel(s) on tier '{tier}'", file=sys.stderr)
            findings, report.num_kernels_audited = run_num_audit(num_kernels, device=args.device)
            report.extend(findings)
        if perf:
            from .perf_audit import current_tier, perf_plan, run_perf_audit
            from .perf_audit import update_baselines as update_perf

            tier = current_tier(args.device)
            if args.update_perf_baselines:
                new = update_perf(perf_kernels, device=args.device)
                print(f"wrote perf baselines for {len(new['tiers'][tier]['kernels'])} "
                      f"kernel(s) on tier '{tier}'", file=sys.stderr)
                # the cells just measured ARE the new baselines
                report.perf_shapes_audited = len(perf_plan(perf_kernels, tier))
            else:
                findings, report.perf_shapes_audited = run_perf_audit(
                    perf_kernels, device=args.device)
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
