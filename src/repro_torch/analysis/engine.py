"""Rule dispatch: load modules under a root, run the rule families,
apply inline suppressions and the baseline.

The root is configurable (``--root``) so the lint fixtures — a
miniature tree replicating the reference's ``src/repro`` layout under
``tests/data/lint_fixtures/`` — exercise every rule against a fake
"repo" with the exact same path-scoping logic the real one gets; the
``package`` argument picks that layout's row of :data:`.trees.TREES`
(default: the port's, ``src/repro_torch``).
"""

from __future__ import annotations

from pathlib import Path

from . import contracts, determinism, layering, schemas, units
from .astutil import Module, load_modules
from .findings import Baseline, Finding
from .trees import tree as get_tree

FAMILIES = ("layering", "determinism", "contracts", "units", "schemas")
DEFAULT_BASELINE_NAME = ".repro-torch-lint-baseline.json"


def find_repo_root(start: Path | None = None) -> Path:
    """Nearest ancestor holding a ``pyproject.toml`` or ``.git`` —
    starting from this package (editable installs put it inside the
    repo), falling back to the working directory."""
    candidates = [Path(__file__).resolve(), (start or Path.cwd()).resolve()]
    for origin in candidates:
        node = origin if origin.is_dir() else origin.parent
        while True:
            if (node / "pyproject.toml").exists() or (node / ".git").exists():
                return node
            if node.parent == node:
                break
            node = node.parent
    return Path.cwd()


def analyze_paths(root: Path, paths: list[Path] | None = None,
                  families: tuple[str, ...] | None = None,
                  package: str | None = None) -> list[Finding]:
    """Run the selected rule families over ``paths`` (default: the
    package's ``src/<package>``) relative to ``root``.  Returns findings
    sorted by location; inline ``# lint-ok`` suppressions already
    applied, the baseline NOT applied (callers decide)."""
    root = Path(root).resolve()
    tree = get_tree(package)
    if paths is None:
        paths = [root / p for p in tree.default_paths
                 if (root / p).exists()] or [root]
    families = tuple(families or FAMILIES)
    unknown = set(families) - set(FAMILIES)
    if unknown:
        raise ValueError(f"unknown rule families: {sorted(unknown)} "
                         f"(choose from {FAMILIES})")
    modules = load_modules(root, [Path(p) for p in paths])
    by_rel = {m.rel: m for m in modules}

    findings: list[Finding] = []
    if "layering" in families:
        findings += layering.check(modules, tree)
    if "determinism" in families:
        findings += determinism.check(modules)
    if "contracts" in families:
        findings += contracts.check(
            [m for m in modules if m.rel.startswith(tree.policy_dir)],
            tree.table_cli)
    if "units" in families:
        findings += units.check(modules)
    if "schemas" in families:
        # root-scoped: diffs the fixed emitter/doc/JSON inputs below
        # the root regardless of the selected paths
        findings += schemas.check(root, tree)

    findings = [f for f in findings
                if not _suppressed(by_rel, f)]
    return sorted(set(findings), key=lambda f: (f.path, f.line, f.rule))


def _suppressed(by_rel: dict[str, Module], f: Finding) -> bool:
    mod = by_rel.get(f.path)
    return mod is not None and mod.suppressed(f.line, f.rule)


def analyze_repo(families: tuple[str, ...] | None = None,
                 root: Path | None = None,
                 apply_baseline: bool = True) -> list[Finding]:
    """Analyze the port in the repo this package lives in, against its
    baseline."""
    from .findings import load_baseline
    root = Path(root) if root else find_repo_root()
    findings = analyze_paths(root, families=families)
    if apply_baseline:
        baseline = load_baseline(root / DEFAULT_BASELINE_NAME)
        findings = [f for f in findings if not baseline.covers(f)]
    return findings


def split_baselined(findings: list[Finding], baseline: Baseline
                    ) -> tuple[list[Finding], list[Finding]]:
    fresh = [f for f in findings if not baseline.covers(f)]
    known = [f for f in findings if baseline.covers(f)]
    return fresh, known
