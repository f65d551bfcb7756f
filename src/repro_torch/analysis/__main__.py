"""CLI: ``python -m repro_torch.analysis [--format json] [paths...]``.

Exit status: 0 when every finding is baselined (or none), 1 when fresh
findings exist, 2 on usage errors.  The rules are documented in
``docs/analysis.md``; ``--package repro`` runs them over the reference's
layout (the lint fixtures), ``repro_torch`` (the default) over the port.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .engine import (DEFAULT_BASELINE_NAME, FAMILIES, analyze_paths,
                     find_repo_root, split_baselined)
from .findings import load_baseline, write_baseline
from .trees import CLI, DEFAULT_PACKAGE, TREES


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog=CLI,
        description="the port's lint: architecture/determinism "
                    "analysis over the repo's AST and import graph.  "
                    "There is no --write-schema-table: the schema "
                    "table in docs/benchmarks.md is the reference's to "
                    "write (python -m repro.analysis "
                    "--write-schema-table); B601 holds the port's "
                    "db_bench rows to it.")
    parser.add_argument("paths", nargs="*",
                        help="files/directories to analyze, relative to "
                             "--root (default: src/<package>)")
    parser.add_argument("--package", choices=tuple(TREES),
                        default=DEFAULT_PACKAGE,
                        help="the layout the path-scoped rules read "
                             "(repro: the reference's, for its lint "
                             "fixtures)")
    parser.add_argument("--root", type=Path, default=None,
                        help="analysis root (default: the enclosing "
                             "repo)")
    parser.add_argument("--format", choices=("text", "json", "github"),
                        default="text",
                        help="'github' emits ::error annotations for "
                             "GitHub Actions")
    parser.add_argument("--explain", metavar="RULE", default=None,
                        help="print the catalog entry for one rule id "
                             "(e.g. U501) and exit")
    parser.add_argument("--rules", default=None, metavar="FAM[,FAM...]",
                        help=f"rule families to run (default: all of "
                             f"{', '.join(FAMILIES)})")
    parser.add_argument("--baseline", type=Path, default=None,
                        help=f"baseline file (default: "
                             f"<root>/{DEFAULT_BASELINE_NAME})")
    parser.add_argument("--no-baseline", action="store_true",
                        help="report baselined findings too")
    parser.add_argument("--write-baseline", action="store_true",
                        help="accept all current findings into the "
                             "baseline file and exit 0")
    parser.add_argument("--write-contract-table", action="store_true",
                        help="regenerate the contract table in "
                             "src/<package>/core/policies/base.py, then "
                             "exit")
    args = parser.parse_args(argv)

    if args.explain:
        from .catalog import CATALOG, explain
        text = explain(args.explain)
        if text is None:
            parser.error(f"unknown rule {args.explain!r} (registered: "
                         f"{', '.join(sorted(CATALOG))})")
        print(text)
        return 0

    root = (args.root or find_repo_root()).resolve()
    tree = TREES[args.package]
    if args.write_contract_table:
        from .contracts import write_contract_table
        base_path = root / tree.base_rel
        if not base_path.exists():
            parser.error(f"no {tree.base_rel} under {root}")
        changed = write_contract_table(base_path, tree.table_cli)
        print(f"{base_path}: "
              + ("contract table rewritten" if changed
                 else "contract table already up to date"))
        return 0

    families = None
    if args.rules:
        families = tuple(f.strip() for f in args.rules.split(",")
                         if f.strip())
    paths = [root / p for p in args.paths] if args.paths else None
    try:
        findings = analyze_paths(root, paths, families, args.package)
    except ValueError as e:
        parser.error(str(e))

    baseline_path = args.baseline or (root / DEFAULT_BASELINE_NAME)
    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f"{baseline_path}: {len(findings)} finding(s) baselined")
        return 0

    baseline = load_baseline(baseline_path)
    fresh, known = split_baselined(findings, baseline)
    shown = findings if args.no_baseline else fresh

    if args.format == "github":
        # GitHub Actions workflow annotations: one ::error per fresh
        # finding, anchored at the file/line the web UI will show
        for f in fresh:
            msg = f"{f.rule} {f.message} (hint: {f.hint})"
            msg = msg.replace("%", "%25").replace("\r", "%0D") \
                     .replace("\n", "%0A")
            print(f"::error file={f.path},line={f.line},"
                  f"title=repro-torch-lint {f.rule}::{msg}")
        print(("FAIL: " if fresh else "OK: ")
              + f"{len(fresh)} finding(s)"
              + (f" ({len(known)} baselined)" if known else ""))
    elif args.format == "json":
        print(json.dumps({
            "root": str(root),
            "families": list(families or FAMILIES),
            "fresh": [f.to_dict() for f in fresh],
            "baselined": [f.to_dict() for f in known],
            "exit": 1 if fresh else 0,
        }, indent=2))
    else:
        for f in shown:
            print(f.format())
        tail = f"{len(fresh)} finding(s)"
        if known:
            tail += f" ({len(known)} baselined)"
        print(("FAIL: " if fresh else "OK: ") + tail)
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
