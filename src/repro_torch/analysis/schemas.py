"""Bench-schema rules (B6xx): one source of truth for bench-row shapes.

Every BENCH row exists in three places: the emitter dict literal (the
port's ``bench_kv/db_bench.py``), the reference's generated schema
table in ``docs/benchmarks.md``, and the checked-in
``BENCH_dbbench.json``, whose rows the port's must equal.  This module
*extracts* the schema from the emitters (per bench family: ordered key
set, per-key unit via ``units.py`` inference + name suffixes) and diffs
it three ways:

* **B601** — the port's db_bench families differ from the db_bench rows
  of the generated table in ``docs/benchmarks.md`` (between the
  ``bench-schema-start``/``end`` markers) by family, key set or units;
  the emitter column is not compared, since it names the reference's
  file.  That table is the reference's to write
  (``python -m repro.analysis --write-schema-table``); the port's CLI
  offers no writer.  Under the ``repro`` layout (:mod:`.trees`) B601
  diffs the whole table verbatim, as the reference does.
* **B602** — the checked-in ``BENCH_dbbench.json`` disagrees with the
  emitters: rows with missing/extra keys, families no emitter
  produces, emitters no row exercises, or non-numeric values under a
  dimensioned key.
* **B603** — the same key name carries two different units in two
  families (``stall_s`` seconds here, milliseconds there).

Extraction understands the emitter idioms in this repo: dict literals
with a ``"bench"`` key; ``row["k"] = ...`` augmentation;
``row.update({...})`` (optional keys) and ``row.update(call())``
(*open* schema — dynamic payload, extra keys allowed);
parameterized families (``_sweep_row``'s ``bench`` parameter, one
concrete variant per distinct call-site value, caller-side key adds
attached to the right variant); and ``ROWS.append({...})`` in the
reference's ``benchmarks/common.py`` (the ``run_csv`` family, read under
the ``repro`` layout only).

Unlike the path-scoped families, this one is **root-scoped**: it
always loads the fixed emitter/doc/JSON inputs below the analysis
root (skipping whichever are absent, so fixture trees work), no matter
which paths were selected.  The same extraction backs the runtime
check: ``paranoid_validate_rows()`` is called from db_bench when
``REPRO_PARANOID_CHECKS=1``.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path

from . import units
from .astutil import Module, load_modules
from .findings import Finding
from .trees import CLI, Tree, tree as get_tree

FAMILY = "schemas"

DOC_REL = "docs/benchmarks.md"
JSON_REL = "BENCH_dbbench.json"
TABLE_START = "<!-- bench-schema-start -->"
TABLE_END = "<!-- bench-schema-end -->"
#: family name for benchmarks/common.py's ``ROWS.append({...})`` rows
CSV_FAMILY = "run_csv"


@dataclass
class Variant:
    """One emitted row shape: a bench family as one dict literal sees it."""

    family: str
    path: str                                # emitter module, root-relative
    line: int                                # the dict literal
    keys: dict[str, str | None]              # required, in literal order
    optional: dict[str, str | None] = field(default_factory=dict)
    open: bool = False                       # dynamic update(): subset match

    def unit_of(self, key: str) -> str | None:
        return self.keys.get(key) or self.optional.get(key)

    def all_keys(self) -> dict[str, str | None]:
        merged = dict(self.keys)
        for k, u in self.optional.items():
            merged.setdefault(k, u)
        return merged

    def matches(self, row_keys: set[str]) -> bool:
        if not row_keys >= set(self.keys):
            return False
        return self.open or row_keys <= set(self.keys) | set(self.optional)


def _finding(rule: str, path: str, line: int, message: str, hint: str,
             snippet: str = "") -> Finding:
    return Finding(rule=rule, family=FAMILY, path=path, line=line,
                   message=message, hint=hint, snippet=snippet)


# --------------------------------------------------------------------------
# extraction

def _str_keys(node: ast.Dict) -> list[str | None]:
    return [k.value if isinstance(k, ast.Constant)
            and isinstance(k.value, str) else None for k in node.keys]


def _enclosing_functions(tree: ast.Module) -> list[ast.FunctionDef]:
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _param_default(fn: ast.FunctionDef, name: str) -> str | None:
    """String default of parameter ``name``, if any."""
    a = fn.args
    pos = list(a.posonlyargs) + list(a.args)
    for arg, dflt in zip(pos[len(pos) - len(a.defaults):], a.defaults):
        if arg.arg == name and isinstance(dflt, ast.Constant) \
                and isinstance(dflt.value, str):
            return dflt.value
    for arg, dflt in zip(a.kwonlyargs, a.kw_defaults):
        if arg.arg == name and isinstance(dflt, ast.Constant) \
                and isinstance(dflt.value, str):
            return dflt.value
    return None


def _key_units(mod: Module, fn: ast.FunctionDef | None,
               node: ast.Dict) -> dict[str, str | None]:
    """Effective unit per key: the name-declared unit (suffix/registry)
    first, the value-inferred unit as fallback."""
    inferred = units.dict_key_units(mod, fn, node)
    out: dict[str, str | None] = {}
    for key in _str_keys(node):
        if key is None:
            continue
        out[key] = units.name_unit(key) or inferred.get(key)
    return out


@dataclass
class _Template:
    """A dict literal whose ``"bench"`` value is a function parameter."""

    fn_name: str
    param: str
    default: str | None
    skeleton: Variant
    #: family → caller-side additions {key: (unit, conditional)}
    call_adds: dict[str, dict[str, tuple[str | None, bool]]] \
        = field(default_factory=dict)
    families: set[str] = field(default_factory=set)


class _ModuleExtractor:
    """Per-module pass: concrete variants, templates, template calls."""

    def __init__(self, mod: Module):
        self.mod = mod
        self.variants: list[Variant] = []
        self.templates: dict[str, _Template] = {}   # by fn name
        #: (callee, family-or-None, additions {key: (unit, cond)})
        self.calls: list[tuple[str, str | None,
                               dict[str, tuple[str | None, bool]]]] = []

    def run(self) -> None:
        self._scan_fn(None, self.mod.tree.body)
        for fn in _enclosing_functions(self.mod.tree):
            self._scan_fn(fn, fn.body)

    # -- one scope ---------------------------------------------------------
    def _scan_fn(self, fn: ast.FunctionDef | None,
                 body: list[ast.stmt]) -> None:
        # all bench-dicts in this scope (excluding nested defs)
        dicts = self._bench_dicts(body)
        bound: dict[str, Variant] = {}       # var name → its variant
        #: var → (callee, bench-kwarg, caller-side key additions) for
        #: ``row = _sweep_row(...); row["engine"] = ...`` idioms
        pending: dict[str, tuple[str, str | None,
                                 dict[str, tuple[str | None, bool]]]] = {}
        made: dict[int, Variant] = {}
        #: bench-less dicts bound to a name become variants only if the
        #: name later reaches ``ROWS.append`` (``row = {...}`` idiom)
        provisional: set[int] = set()

        for node in dicts:
            v = self._variant_of(fn, node)
            if v is not None:
                made[id(node)] = v
                self.variants.append(v)

        def visit(stmts: list[ast.stmt], cond: bool) -> None:
            for st in stmts:
                if isinstance(st, ast.Assign) and len(st.targets) == 1:
                    tgt, val = st.targets[0], st.value
                    if isinstance(tgt, ast.Name):
                        if id(val) in made:
                            bound[tgt.id] = made[id(val)]
                        elif isinstance(val, ast.Dict) \
                                and "bench" not in _str_keys(val):
                            v = Variant(family=CSV_FAMILY,
                                        path=self.mod.rel, line=val.lineno,
                                        keys=_key_units(self.mod, fn, val))
                            bound[tgt.id] = v
                            provisional.add(id(v))
                        elif isinstance(val, ast.Call):
                            callee = self._callee(val)
                            if callee:
                                pending[tgt.id] = (
                                    callee, self._call_family(val), {})
                    elif isinstance(tgt, ast.Subscript) \
                            and isinstance(tgt.value, ast.Name):
                        self._add_key(fn, bound, pending, tgt.value.id,
                                      tgt.slice, st.value, cond)
                elif isinstance(st, ast.Expr) \
                        and isinstance(st.value, ast.Call):
                    call = st.value
                    if isinstance(call.func, ast.Attribute) \
                            and call.func.attr == "append" \
                            and isinstance(call.func.value, ast.Name) \
                            and call.func.value.id == "ROWS" \
                            and call.args \
                            and isinstance(call.args[0], ast.Name) \
                            and call.args[0].id in bound:
                        v = bound[call.args[0].id]
                        if id(v) in provisional:
                            provisional.discard(id(v))
                            self.variants.append(v)
                    self._update_stmt(fn, bound, call)
                for sub, subcond in self._sub_bodies(st):
                    visit(sub, cond or subcond)

        visit(body, False)
        self.calls.extend(pending.values())

    def _sub_bodies(self, st: ast.stmt):
        if isinstance(st, (ast.If, ast.For, ast.While)):
            yield st.body, True
            yield st.orelse, True
        elif isinstance(st, ast.With):
            yield st.body, False
        elif isinstance(st, ast.Try):
            yield st.body, False
            for h in st.handlers:
                yield h.body, True
            yield st.orelse, True
            yield st.finalbody, True

    def _bench_dicts(self, body: list[ast.stmt]) -> list[ast.Dict]:
        found: list[ast.Dict] = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef, ast.ClassDef)):
                    continue
                if isinstance(child, ast.Dict) \
                        and "bench" in _str_keys(child):
                    found.append(child)
                if isinstance(child, ast.Call) \
                        and isinstance(child.func, ast.Attribute) \
                        and child.func.attr == "append" \
                        and isinstance(child.func.value, ast.Name) \
                        and child.func.value.id == "ROWS" \
                        and child.args \
                        and isinstance(child.args[0], ast.Dict):
                    found.append(child.args[0])
                walk(child)

        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue           # separate scopes: run() visits defs
            walk(st)
        # a ROWS.append dict may also carry a "bench" key; dedupe
        seen: set[int] = set()
        uniq = []
        for d in found:
            if id(d) not in seen:
                seen.add(id(d))
                uniq.append(d)
        return uniq

    def _variant_of(self, fn: ast.FunctionDef | None,
                    node: ast.Dict) -> Variant | None:
        keys = _str_keys(node)
        key_units = _key_units(self.mod, fn, node)
        if "bench" not in keys:                  # ROWS.append literal
            return Variant(family=CSV_FAMILY, path=self.mod.rel,
                           line=node.lineno, keys=key_units)
        bench_val = node.values[keys.index("bench")]
        if isinstance(bench_val, ast.Constant) \
                and isinstance(bench_val.value, str):
            return Variant(family=bench_val.value, path=self.mod.rel,
                           line=node.lineno, keys=key_units)
        if isinstance(bench_val, ast.Name) and fn is not None:
            default = _param_default(fn, bench_val.id)
            if default is not None:
                skel = Variant(family=default, path=self.mod.rel,
                               line=node.lineno, keys=key_units)
                self.templates[fn.name] = _Template(
                    fn_name=fn.name, param=bench_val.id,
                    default=default, skeleton=skel)
                return None                      # realized per call site
        # dynamic family we can't resolve: skip rather than guess
        return None

    def _callee(self, call: ast.Call) -> str | None:
        if isinstance(call.func, ast.Name):
            return call.func.id
        if isinstance(call.func, ast.Attribute):
            return call.func.attr
        return None

    def _call_family(self, call: ast.Call) -> str | None:
        for kw in call.keywords:
            if kw.arg == "bench" and isinstance(kw.value, ast.Constant) \
                    and isinstance(kw.value.value, str):
                return kw.value.value
        return None

    def _add_key(self, fn, bound, pending, var: str, slice_node: ast.AST,
                 value: ast.AST, cond: bool) -> None:
        if not (isinstance(slice_node, ast.Constant)
                and isinstance(slice_node.value, str)):
            return
        key = slice_node.value
        unit = units.name_unit(key)
        if var in bound:
            v = bound[var]
            (v.optional if cond else v.keys).setdefault(key, unit)
        elif var in pending:
            pending[var][2].setdefault(key, (unit, cond))

    def _update_stmt(self, fn, bound, call: ast.Call) -> None:
        """``var.update({...})`` → optional keys; dynamic arg → open."""
        if not (isinstance(call.func, ast.Attribute)
                and call.func.attr == "update"
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id in bound and call.args):
            return
        v = bound[call.func.value.id]
        arg = call.args[0]
        if isinstance(arg, ast.Dict):
            for key, unit in _key_units(self.mod, fn, arg).items():
                if key not in v.keys:
                    v.optional.setdefault(key, unit)
        else:
            v.open = True


def extract_variants(root: Path, tree: Tree | None = None
                     ) -> list[Variant]:
    """All emitted row shapes below ``root`` (families realized from
    templates and call sites across the tree's emitter modules)."""
    root = Path(root).resolve()
    tree = tree or get_tree()
    paths = [root / rel for rel in tree.emitter_rels
             if (root / rel).exists()]
    if not paths:
        return []
    mods = load_modules(root, paths)
    extractors = [_ModuleExtractor(m) for m in mods]
    templates: dict[str, _Template] = {}
    for ex in extractors:
        ex.run()
        templates.update(ex.templates)

    # every template call anywhere in the emitter set realizes a family
    calls: list[tuple[str, str | None,
                      dict[str, tuple[str | None, bool]]]] = []
    for ex in extractors:
        calls.extend(ex.calls)
        for mod_call in ast.walk(ex.mod.tree):
            if isinstance(mod_call, ast.Call):
                callee = ex._callee(mod_call)
                if callee in templates:
                    calls.append((callee,
                                  ex._call_family(mod_call), {}))

    variants = [v for ex in extractors for v in ex.variants]
    for tpl in templates.values():
        fams: dict[str, dict[str, tuple[str | None, bool]]] = {}
        for callee, fam, adds in calls:
            if callee != tpl.fn_name:
                continue
            family = fam or tpl.default
            if family is None:
                continue
            merged = fams.setdefault(family, {})
            for k, (u, cond) in adds.items():
                merged.setdefault(k, (u, cond))
        if not fams and tpl.default:
            fams[tpl.default] = {}
        for family, adds in fams.items():
            v = Variant(family=family, path=tpl.skeleton.path,
                        line=tpl.skeleton.line,
                        keys=dict(tpl.skeleton.keys),
                        optional=dict(tpl.skeleton.optional),
                        open=tpl.skeleton.open)
            for k, (u, _cond) in adds.items():
                v.optional.setdefault(k, u)
            variants.append(v)
    variants.sort(key=lambda v: (v.family, v.path, v.line))
    return variants


# --------------------------------------------------------------------------
# B601: the generated schema table in docs/benchmarks.md

def _render_keys(v: Variant) -> str:
    parts = []
    for k, u in v.keys.items():
        parts.append(f"`{k}`:{u or '?'}")
    for k, u in v.optional.items():
        if k not in v.keys:
            parts.append(f"+`{k}`:{u or '?'}")
    if v.open:
        parts.append("…")
    return ", ".join(parts)


def generate_schema_table(variants: list[Variant]) -> str:
    """Deterministic markdown for the doc block; both the B601 check and
    ``--write-schema-table`` call this, so they cannot drift."""
    lines = [
        TABLE_START,
        "",
        "*Generated by `python -m repro.analysis --write-schema-table` — "
        "do not edit by hand (B601 fails CI on drift).  Units: s, ms, "
        "bytes, MB, ops, ops/s, bytes/s, 1 (dimensionless), ? (untyped); "
        "`+key` is optional, `…` marks an open schema (dynamic "
        "`update()` payload).*",
        "",
        "| bench family | emitter | emitted keys |",
        "|---|---|---|",
    ]
    for v in variants:
        lines.append(f"| `{v.family}` | `{v.path}:{v.line}` "
                     f"| {_render_keys(v)} |")
    lines += ["", TABLE_END]
    return "\n".join(lines)


def _current_doc_block(text: str) -> tuple[str, int] | None:
    lines = text.splitlines()
    start = end = None
    for i, ln in enumerate(lines):
        if TABLE_START in ln and start is None:
            start = i
        elif TABLE_END in ln and start is not None:
            end = i
            break
    if start is None or end is None:
        return None
    return "\n".join(lines[start:end + 1]), start + 1


def _doc_rows(block: str, emitters: tuple[str, ...]
              ) -> dict[str, list[frozenset[str]]]:
    """family -> key sets (``key:unit`` tokens, ``+`` and ``…`` kept) of
    the table's rows whose emitter file is one of ``emitters``."""
    out: dict[str, list[frozenset[str]]] = {}
    for ln in block.splitlines():
        cells = [c.strip() for c in ln.strip().strip("|").split("|")]
        if len(cells) != 3 or not cells[0].startswith("`"):
            continue
        family = cells[0].strip("`")
        emitter = cells[1].strip("`").rsplit(":", 1)[0]
        if emitter in emitters:
            out.setdefault(family, []).append(
                frozenset(cells[2].split(", ")))
    return out


def _check_doc_families(block: str, lineno: int, variants: list[Variant],
                        emitters: tuple[str, ...]) -> list[Finding]:
    """B601 for the port: each family's key sets and units equal the
    table's rows for ``emitters``, whatever file and line they name."""
    want = _doc_rows(block, emitters)
    got: dict[str, list[frozenset[str]]] = {}
    for v in variants:
        got.setdefault(v.family, []).append(
            frozenset(_render_keys(v).split(", ")))
    findings = []
    for family in sorted(set(want) | set(got)):
        w = sorted(sorted(k) for k in want.get(family, []))
        g = sorted(sorted(k) for k in got.get(family, []))
        if w == g:
            continue
        wk = frozenset().union(*want.get(family, [frozenset()]))
        gk = frozenset().union(*got.get(family, [frozenset()]))
        findings.append(_finding(
            "B601", DOC_REL, lineno,
            f'family "{family}": the port emits {len(g)} variant(s), the '
            f"table has {len(w)}; keys only the port's: "
            f"{sorted(gk - wk)}; only the table's: {sorted(wk - gk)}",
            "fix the port's emitter: the table is the reference's "
            "(`python -m repro.analysis --write-schema-table` writes "
            "it)", snippet=f"{TABLE_START}:{family}"))
    return findings


def check_schema_table(root: Path, variants: list[Variant],
                       tree: Tree | None = None) -> list[Finding]:
    tree = tree or get_tree()
    doc = Path(root) / DOC_REL
    if not doc.exists():
        return []
    text = doc.read_text()
    block = _current_doc_block(text)
    hint = "run `python -m repro.analysis --write-schema-table`"
    if block is None:
        return [_finding("B601", DOC_REL, 1,
                         f"{DOC_REL} has no generated schema table "
                         f"({TABLE_START!r} marker missing)", hint)]
    current, lineno = block
    if tree.doc_emitters is not None:
        return _check_doc_families(current, lineno, variants,
                                   tree.doc_emitters)

    def norm(t: str) -> list[str]:
        return [ln.rstrip() for ln in t.splitlines()]

    if norm(current) != norm(generate_schema_table(variants)):
        return [_finding(
            "B601", DOC_REL, lineno,
            "schema table is out of date with the emitter dict literals",
            hint, snippet=TABLE_START)]
    return []


# --------------------------------------------------------------------------
# B602: the checked-in JSON vs the emitters

_DIMENSIONED = set(units.UNITS) - {units.DIMENSIONLESS}


def _closest(variants: list[Variant], row_keys: set[str]) -> Variant:
    return min(variants,
               key=lambda v: len(row_keys ^ set(v.all_keys())))


def check_json(root: Path, variants: list[Variant],
               tree: Tree | None = None) -> list[Finding]:
    tree = tree or get_tree()
    path = Path(root) / JSON_REL
    if not path.exists():
        return []
    db_bench = f"python -m {tree.package}.bench_kv.db_bench"
    try:
        rows = json.loads(path.read_text())
    except ValueError as e:
        return [_finding("B602", JSON_REL, 1,
                         f"{JSON_REL} is not valid JSON: {e}",
                         f"regenerate with `{db_bench} --json "
                         f"BENCH_dbbench.json`")]
    if not isinstance(rows, list):
        return []
    by_family: dict[str, list[Variant]] = {}
    for v in variants:
        by_family.setdefault(v.family, []).append(v)

    findings: list[Finding] = []
    seen_shape: set[tuple] = set()
    seen_type: set[tuple] = set()
    row_families: set[str] = set()
    if tree.doc_emitters is None:
        hint = (f"regenerate BENCH_dbbench.json (`{db_bench} --json "
                f"BENCH_dbbench.json`) or fix the emitter")
    else:
        hint = ("fix the port's emitter: BENCH_dbbench.json holds the "
                "rows the port's must equal")
    for row in rows:
        if not isinstance(row, dict) or "bench" not in row:
            continue
        family = row["bench"]
        row_families.add(family)
        fam_variants = by_family.get(family)
        if not fam_variants:
            if ("nofam", family) not in seen_shape:
                seen_shape.add(("nofam", family))
                findings.append(_finding(
                    "B602", JSON_REL, 1,
                    f'{JSON_REL} has rows for bench family "{family}" '
                    f"that no emitter produces", hint))
            continue
        errors = validate_row(row, fam_variants)
        if errors:
            best = _closest(fam_variants, set(row))
            for err in errors:
                kind = (family, err)
                if kind in seen_shape:
                    continue
                seen_shape.add(kind)
                findings.append(_finding(
                    "B602", best.path, best.line,
                    f'family "{family}" rows in {JSON_REL}: {err}',
                    hint, snippet=f"{family}:{err}"))
        else:
            v = next(v for v in fam_variants if v.matches(set(row)))
            for key, unit in v.all_keys().items():
                if unit in _DIMENSIONED and key in row \
                        and not isinstance(row[key], (int, float)):
                    kind = (family, key, "type")
                    if kind in seen_type:
                        continue
                    seen_type.add(kind)
                    findings.append(_finding(
                        "B602", v.path, v.line,
                        f'family "{family}" key "{key}" is {unit} but '
                        f"{JSON_REL} holds "
                        f"{type(row[key]).__name__} values",
                        hint, snippet=f"{family}:{key}:type"))
    # db_bench emitters never exercised by the checked-in rows
    if row_families:
        for v in variants:
            if v.path.endswith("db_bench.py") \
                    and v.family not in row_families:
                findings.append(_finding(
                    "B602", v.path, v.line,
                    f'emitter family "{v.family}" has no rows in '
                    f"{JSON_REL}", hint,
                    snippet=f"{v.family}:norows"))
    return findings


def validate_row(row: dict, variants: list[Variant]) -> list[str]:
    """Shape errors of one row against a family's variants (empty =
    valid).  The runtime paranoid check in the emitters calls this."""
    row_keys = set(row)
    if any(v.matches(row_keys) for v in variants):
        return []
    best = _closest(variants, row_keys)
    missing = sorted(set(best.keys) - row_keys)
    extra = sorted(row_keys - set(best.all_keys()))
    errors = []
    if missing:
        errors.append(f"missing key(s) {missing} "
                      f"(vs {best.path}:{best.line})")
    if extra and not best.open:
        errors.append(f"extra key(s) {extra} "
                      f"(vs {best.path}:{best.line})")
    if not errors:
        errors.append(f"does not match any emitter variant "
                      f"(closest: {best.path}:{best.line})")
    return errors


# --------------------------------------------------------------------------
# B603: cross-family unit consistency

def check_cross_family(variants: list[Variant]) -> list[Finding]:
    seen: dict[str, tuple[str, Variant]] = {}   # key → (unit, first site)
    findings: list[Finding] = []
    for v in variants:
        for key, unit in v.all_keys().items():
            if unit is None:
                continue
            prev = seen.get(key)
            if prev is None:
                seen[key] = (unit, v)
            elif prev[0] != unit:
                pu, pv = prev
                findings.append(_finding(
                    "B603", v.path, v.line,
                    f'key "{key}" is {unit} in family "{v.family}" but '
                    f'{pu} in family "{pv.family}" '
                    f"({pv.path}:{pv.line})",
                    "one key name, one unit: rename one side or convert",
                    snippet=f"{key}:{v.family}"))
    return findings


# --------------------------------------------------------------------------
# entry points

def check(root: Path, tree: Tree | None = None) -> list[Finding]:
    root = Path(root).resolve()
    tree = tree or get_tree()
    variants = extract_variants(root, tree)
    if not variants:
        return []
    findings = (check_schema_table(root, variants, tree)
                + check_json(root, variants, tree)
                + check_cross_family(variants))
    # apply inline suppressions against the emitter sources
    mods = {m.rel: m for m in load_modules(
        root, [root / rel for rel in tree.emitter_rels
               if (root / rel).exists()])}
    out = []
    for f in findings:
        mod = mods.get(f.path)
        if mod is not None and mod.suppressed(f.line, f.rule):
            continue
        out.append(f)
    return out


# -- runtime validation (REPRO_PARANOID_CHECKS) ----------------------------
_SCHEMA_CACHE: dict[tuple[str, str], dict[str, list[Variant]]] = {}


def load_schemas(root: Path | None = None, tree: Tree | None = None
                 ) -> dict[str, list[Variant]]:
    """family → variants, extracted once per (root, tree) and cached
    (db_bench calls this on every row when paranoid checks are on)."""
    from .engine import find_repo_root
    root = Path(root) if root else find_repo_root()
    tree = tree or get_tree()
    key = (str(root), tree.package)
    if key not in _SCHEMA_CACHE:
        by_family: dict[str, list[Variant]] = {}
        for v in extract_variants(root, tree):
            by_family.setdefault(v.family, []).append(v)
        _SCHEMA_CACHE[key] = by_family
    return _SCHEMA_CACHE[key]


def paranoid_validate_rows(rows: list[dict], family: str | None = None,
                           root: Path | None = None) -> None:
    """Validate every row against its extracted schema when
    ``REPRO_PARANOID_CHECKS=1`` — a drifting emitter then fails the
    smoke run itself, not just the linter.  No-op otherwise."""
    import os
    if os.environ.get("REPRO_PARANOID_CHECKS", "0") != "1":
        return
    for row in rows:
        if isinstance(row, dict):
            validate_emitted_row(row, family=family, root=root)


def validate_emitted_row(row: dict, family: str | None = None,
                         root: Path | None = None) -> None:
    """Raise ``ValueError`` when ``row`` does not match its family's
    extracted schema.  No-op when the family is unknown to the
    extractor (so ad-hoc rows stay possible)."""
    schemas = load_schemas(root)
    fam = family if family is not None else row.get("bench")
    variants = schemas.get(fam)
    if not variants:
        return
    errors = validate_row(row, variants)
    if errors:
        raise ValueError(
            f"bench row for family {fam!r} drifted from the emitter "
            f"schema: {'; '.join(errors)} — rerun `{CLI} --rules "
            f"schemas`")
