"""Shared AST plumbing: module loading, import resolution, docstring and
suppression-comment bookkeeping.

Everything here is pure stdlib on purpose — the analyzer must be
importable (and runnable in CI) without the simulation stack, and the
import-graph rule itself requires this package to stay leaf-like.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Module:
    """One parsed source file under the analysis root."""

    path: Path                 # absolute
    rel: str                   # posix path relative to the root
    name: str                  # dotted module name ("repro.core.sim")
    is_package: bool           # True for __init__.py
    tree: ast.Module
    lines: list[str]           # source lines (1-based access via line(n))
    doc_lines: set[int] = field(default_factory=set)

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        """Inline suppression: ``# lint-ok`` or ``# lint-ok: D203,L104``
        on the offending line."""
        text = self.line(lineno)
        if "# lint-ok" not in text:
            return False
        tag = text.split("# lint-ok", 1)[1].strip()
        if not tag.startswith(":"):
            return True                      # bare `# lint-ok`: all rules
        listed = {r.strip() for r in tag[1:].split(",")}
        return rule in listed


def module_name(rel: str) -> tuple[str, bool]:
    """Dotted module name for a root-relative posix path.

    A leading ``src/`` is dropped (the repo uses a src layout and the
    fixture trees replicate it), so ``src/repro_torch/core/sim.py`` →
    ``repro_torch.core.sim``; ``__init__.py`` names its package.
    """
    parts = rel.split("/")
    if parts[0] == "src":
        parts = parts[1:]
    assert parts and parts[-1].endswith(".py")
    parts[-1] = parts[-1][:-3]
    is_package = parts[-1] == "__init__"
    if is_package:
        parts = parts[:-1]
    return ".".join(parts), is_package


def iter_py_files(root: Path, paths: list[Path]) -> list[Path]:
    files: set[Path] = set()
    for p in paths:
        p = p if p.is_absolute() else root / p
        if p.is_dir():
            files.update(f for f in p.rglob("*.py"))
        elif p.suffix == ".py":
            files.add(p)
    return sorted(files)


def load_modules(root: Path, paths: list[Path]) -> list[Module]:
    modules = []
    for f in iter_py_files(root, paths):
        rel = f.relative_to(root).as_posix()
        source = f.read_text()
        tree = ast.parse(source, filename=str(f))
        name, is_package = module_name(rel)
        mod = Module(path=f, rel=rel, name=name, is_package=is_package,
                     tree=tree, lines=source.splitlines())
        mod.doc_lines = docstring_lines(tree)
        modules.append(mod)
    return modules


def docstring_lines(tree: ast.Module) -> set[int]:
    """Line numbers covered by module/class/function docstrings."""
    covered: set[int] = set()
    for node in ast.walk(tree):
        if not isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef)):
            continue
        body = getattr(node, "body", [])
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            doc = body[0].value
            covered.update(range(doc.lineno, (doc.end_lineno or doc.lineno)
                                 + 1))
    return covered


def dotted(node: ast.AST) -> str | None:
    """Render ``a.b.c`` attribute chains; None for anything else."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_type_checking_guard(test: ast.AST) -> bool:
    name = dotted(test)
    return name in ("TYPE_CHECKING", "typing.TYPE_CHECKING")


@dataclass(frozen=True)
class ImportEdge:
    """One import statement target, resolved to a dotted module path.

    For ``from X import a, b`` the edge target is ``X`` and ``names``
    carries ``(a, b)`` — callers who care whether ``X.a`` is itself a
    module resolve that against the scanned-module set.
    """

    target: str
    lineno: int
    names: tuple[str, ...] = ()
    top_level: bool = True


def resolve_relative(mod: Module, level: int, suffix: str | None) -> str:
    """Resolve a ``from ...X import Y`` target to an absolute dotted path."""
    parts = mod.name.split(".")
    # parent package of the importing module:
    pkg = parts if mod.is_package else parts[:-1]
    drop = level - 1
    base = pkg[:len(pkg) - drop] if drop else pkg
    if suffix:
        base = base + suffix.split(".")
    return ".".join(base)


def import_edges(mod: Module, include_nested: bool = False
                 ) -> list[ImportEdge]:
    """Import targets of a module.

    By default only *top-level* imports count (the ones that execute at
    import time and can create cycles): statements in the module body,
    descending through ``if``/``try`` but skipping ``if TYPE_CHECKING:``
    bodies.  With ``include_nested`` every import anywhere in the file is
    returned (used by the "never import X" rules, where hiding the
    import inside a function is still a violation).
    """
    edges: list[ImportEdge] = []

    def visit(stmts, top: bool) -> None:
        for st in stmts:
            if isinstance(st, ast.Import):
                for alias in st.names:
                    edges.append(ImportEdge(alias.name, st.lineno,
                                            top_level=top))
            elif isinstance(st, ast.ImportFrom):
                if st.module is None and st.level == 0:
                    continue
                if st.level:
                    target = resolve_relative(mod, st.level, st.module)
                else:
                    target = st.module
                edges.append(ImportEdge(
                    target, st.lineno,
                    tuple(a.name for a in st.names), top_level=top))
            elif isinstance(st, ast.If):
                if _is_type_checking_guard(st.test):
                    if include_nested:
                        visit(st.body, False)
                else:
                    visit(st.body, top)
                visit(st.orelse, top)
            elif isinstance(st, ast.Try):
                visit(st.body, top)
                for h in st.handlers:
                    visit(h.body, top)
                visit(st.orelse, top)
                visit(st.finalbody, top)
            elif isinstance(st, (ast.With, ast.For, ast.While)):
                visit(st.body, top)
                visit(getattr(st, "orelse", []), top)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                if include_nested:
                    visit(st.body, False)
    visit(mod.tree.body, True)
    return edges if include_nested else [e for e in edges if e.top_level]
