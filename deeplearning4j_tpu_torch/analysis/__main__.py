"""dl4j-lint CLI for the port: ``python -m deeplearning4j_tpu_torch.analysis``.

Usage:
    python -m deeplearning4j_tpu_torch.analysis              # whole port
    python -m deeplearning4j_tpu_torch.analysis --select bare-counter deeplearning4j_tpu_torch
    python -m deeplearning4j_tpu_torch.analysis --list-rules
    python -m deeplearning4j_tpu_torch.analysis --update-baseline

Exit status: 0 when no NEW findings (inline-suppressed and baselined
findings do not fail the run), 1 otherwise, 2 for a usage error. The
shipped baseline is empty. Port of ``scripts/dl4j_lint.py``, which stays
the reference package's linter.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

from deeplearning4j_tpu_torch.analysis import baseline as baseline_mod
from deeplearning4j_tpu_torch.analysis.engine import (
    LintConfig,
    REPO_ROOT,
    default_scan_paths,
    iter_py_files,
    run_lint,
)
from deeplearning4j_tpu_torch.analysis.rules import ALL_RULES


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("paths", nargs="*",
                        help="files/dirs to lint (default: "
                             "deeplearning4j_tpu_torch/ and the port's "
                             "tests)")
    parser.add_argument("--select", action="append", default=None,
                        metavar="RULE",
                        help="run only these rule ids (repeatable / "
                             "comma-separated)")
    parser.add_argument("--baseline", default=baseline_mod.DEFAULT_BASELINE,
                        help="baseline file (default: "
                             ".dl4j-lint-torch-baseline.json at the repo "
                             "root)")
    parser.add_argument("--no-baseline", action="store_true",
                        help="ignore the baseline: report every finding")
    parser.add_argument("--update-baseline", action="store_true",
                        help="snapshot current findings into the baseline "
                             "and exit 0")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="summary line only")
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in ALL_RULES:
            print(f"{rule.id:24s} {rule.doc}")
        print(f"{'suppression-missing-reason':24s} a "
              "'# dl4j-lint: disable=' comment without a '-- reason' "
              "tail (inert suppressions are findings)")
        return 0

    select = None
    if args.select:
        select = [r.strip() for chunk in args.select
                  for r in chunk.split(",") if r.strip()]
        if not select:
            # `--select ""` (e.g. an unset shell variable) must not turn
            # the gate vacuous by matching zero rules
            print("dl4j-lint: --select given but names no rules",
                  file=sys.stderr)
            return 2
        known = {r.id for r in ALL_RULES} | {"suppression-missing-reason"}
        unknown = sorted(set(select) - known)
        if unknown:
            print(f"dl4j-lint: unknown rule(s) {unknown}; "
                  f"known: {sorted(known)}", file=sys.stderr)
            return 2

    paths = args.paths or None
    if paths:
        # a typo'd or wrong path must not turn the gate vacuous: an
        # explicit argument that exists but yields zero Python files is
        # as dead as one that does not exist
        missing = [p for p in paths if not os.path.exists(p)]
        if missing:
            print(f"dl4j-lint: path(s) do not exist: {missing}",
                  file=sys.stderr)
            return 2
        if not any(True for _ in iter_py_files(paths)):
            print(f"dl4j-lint: no Python files under {paths} — "
                  "nothing was checked", file=sys.stderr)
            return 2
    findings = run_lint(paths=paths, select=select, config=LintConfig())
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    if args.update_baseline:
        preserve = ()
        if select or args.paths:
            # a narrowed run sees only a slice of the findings: replace
            # just that slice (rules run x paths scanned) and preserve
            # every other baselined entry, instead of silently dropping
            # them in a whole-file overwrite
            scan_paths = paths or default_scan_paths(REPO_ROOT)
            scanned = {os.path.relpath(p, REPO_ROOT).replace(os.sep, "/")
                       for p in iter_py_files(scan_paths)}
            sel = set(select) if select else None
            preserve = [
                e for e in baseline_mod.load_baseline(args.baseline).values()
                if (sel is not None and e.get("rule") not in sel)
                or e.get("path") not in scanned]
        n = baseline_mod.save_baseline(findings, path=args.baseline,
                                       preserve=preserve)
        print(f"dl4j-lint: baseline updated with {n} entr"
              f"{'y' if n == 1 else 'ies'} -> {args.baseline}")
        return 0

    known = ({} if args.no_baseline
             else baseline_mod.load_baseline(args.baseline))
    new, baselined = baseline_mod.partition_findings(findings, known)

    if new and not args.quiet:
        for f in new:
            print(f.format(), file=sys.stderr)
    by_rule = Counter(f.rule for f in new)
    summary = ", ".join(f"{r}={n}" for r, n in sorted(by_rule.items()))
    if new:
        print(f"dl4j-lint: {len(new)} new finding"
              f"{'' if len(new) == 1 else 's'} ({summary})"
              + (f"; {len(baselined)} baselined" if baselined else ""),
              file=sys.stderr)
        return 1
    n_rules = len(select) if select else len(list(ALL_RULES))
    print("dl4j-lint: OK"
          + (f" ({len(baselined)} baselined finding(s) unchanged)"
             if baselined else
             f" ({n_rules} rule{'' if n_rules == 1 else 's'} clean)"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
