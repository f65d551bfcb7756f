"""Policy-contract rules (C3xx) and the generated contract table.

``CompactionPolicy`` is duck-typed: the engine calls hooks by name with
positional arguments, so a misspelt override or a drifted signature is a
*silent* behaviour change (the base default runs instead).  These rules
make the contract load-bearing:

* **C301** — an override's signature is incompatible with the base
  hook's (the engine calls positionally: the base's parameter names
  must survive as a prefix, and any extra parameters need defaults).
* **C302** — a public method on a policy class is not part of the hook
  set (almost always a typo'd override; helpers belong under a leading
  underscore).
* **C303** — a registered policy misses a required member: the
  ``default_config`` override or a non-empty ``name`` literal.
* **C304** — the contract table in ``base.py``'s class docstring does
  not match the hooks/primitives actually declared (regenerate with
  ``python -m repro_torch.analysis --write-contract-table``).

The table generator lives here too, so the checker and the generator
cannot disagree.  The table's header names the CLI of the tree it sits
in (:mod:`.trees`), so the port's rules also pass the reference's
``base.py``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path

from .astutil import Module
from .findings import Finding
from .layering import parse_contract_surface
from .trees import CLI, tree as get_tree

FAMILY = "contracts"

BASE_CLASS = "CompactionPolicy"
TABLE_START = ".. contract-table-start"
TABLE_END = ".. contract-table-end"

#: class attributes (not hooks) a policy may override
_ATTR_OVERRIDES = ("name", "tiering_l0", "soft_limit_factor")
_REQUIRED_HOOKS = ("default_config",)


def _finding(rule: str, mod: Module, lineno: int, message: str,
             hint: str) -> Finding:
    return Finding(rule=rule, family=FAMILY, path=mod.rel, line=lineno,
                   message=message, hint=hint, snippet=mod.line(lineno))


# --------------------------------------------------------------------------
# base.py introspection

@dataclass
class Hook:
    name: str
    args: tuple[str, ...]      # positional parameter names, minus self
    has_vararg: bool
    has_kwarg: bool
    defaults: int              # how many trailing args have defaults
    required: bool             # body is `raise NotImplementedError`
    lineno: int

    def signature(self) -> str:
        parts = list(self.args)
        if self.has_vararg:
            parts.append("*args")
        if self.has_kwarg:
            parts.append("**kw")
        return f"{self.name}({', '.join(parts)})"


def _hook_of(fn: ast.FunctionDef) -> Hook:
    args = tuple(a.arg for a in (list(fn.args.posonlyargs)
                                 + list(fn.args.args)))
    if args and args[0] == "self":
        args = args[1:]
    body = [st for st in fn.body
            if not (isinstance(st, ast.Expr)
                    and isinstance(st.value, ast.Constant))]
    required = (len(body) == 1 and isinstance(body[0], ast.Raise)
                and "NotImplementedError" in ast.dump(body[0]))
    return Hook(name=fn.name, args=args,
                has_vararg=fn.args.vararg is not None,
                has_kwarg=fn.args.kwarg is not None,
                defaults=len(fn.args.defaults), required=required,
                lineno=fn.lineno)


def base_hooks(base_mod: Module) -> dict[str, Hook]:
    cls = _class_def(base_mod, BASE_CLASS)
    if cls is None:
        return {}
    return {st.name: _hook_of(st) for st in cls.body
            if isinstance(st, ast.FunctionDef)
            and not st.name.startswith("__")}


def _class_def(mod: Module, name: str) -> ast.ClassDef | None:
    for node in mod.tree.body:
        if isinstance(node, ast.ClassDef) and node.name == name:
            return node
    return None


# --------------------------------------------------------------------------
# policy classes and the registry

@dataclass
class PolicyClass:
    mod: Module
    node: ast.ClassDef
    bases: tuple[str, ...]


def _policy_classes(policy_mods: list[Module]) -> dict[str, PolicyClass]:
    """Every class in the policies package that descends (transitively,
    within the package) from ``CompactionPolicy``."""
    all_classes: dict[str, PolicyClass] = {}
    for mod in policy_mods:
        for node in mod.tree.body:
            if isinstance(node, ast.ClassDef):
                bases = tuple(b.id for b in node.bases
                              if isinstance(b, ast.Name))
                all_classes[node.name] = PolicyClass(mod, node, bases)

    def descends(name: str, seen: frozenset = frozenset()) -> bool:
        if name == BASE_CLASS:
            return True
        pc = all_classes.get(name)
        if pc is None or name in seen:
            return False
        return any(descends(b, seen | {name}) for b in pc.bases)

    return {n: pc for n, pc in all_classes.items()
            if n != BASE_CLASS and descends(n)}


def _registered_class_names(policy_mods: list[Module]) -> dict[str, Module]:
    """Class names passed to ``register(Cls())`` / ``registry.register``."""
    registered: dict[str, Module] = {}
    for mod in policy_mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = (node.func.id if isinstance(node.func, ast.Name)
                     else node.func.attr
                     if isinstance(node.func, ast.Attribute) else "")
            if fname != "register" or not node.args:
                continue
            arg = node.args[0]
            if (isinstance(arg, ast.Call)
                    and isinstance(arg.func, ast.Name)):
                registered[arg.func.id] = mod
    return registered


def _mro_chain(name: str, classes: dict[str, PolicyClass]) -> list[PolicyClass]:
    chain: list[PolicyClass] = []
    seen: set[str] = set()
    frontier = [name]
    while frontier:
        cur = frontier.pop(0)
        if cur in seen or cur not in classes:
            continue
        seen.add(cur)
        chain.append(classes[cur])
        frontier.extend(classes[cur].bases)
    return chain


# --------------------------------------------------------------------------
# the rules

def _check_signature(hook: Hook, override: Hook) -> str | None:
    """C301 core: why is ``override`` incompatible with ``hook``?"""
    base_args = hook.args
    ov_args = override.args
    if override.has_vararg and base_args[:len(ov_args)] == ov_args:
        return None
    if ov_args[:len(base_args)] != base_args:
        if len(ov_args) < len(base_args) and not override.has_vararg:
            return (f"drops base parameters: base takes "
                    f"({', '.join(base_args)})")
        return (f"renames/reorders base parameters: base takes "
                f"({', '.join(base_args)}), override takes "
                f"({', '.join(ov_args)})")
    extras = ov_args[len(base_args):]
    undefaulted = len(ov_args) - override.defaults
    bad = [a for i, a in enumerate(ov_args)
           if a in extras and i < undefaulted]
    if bad:
        return (f"extra parameter(s) without defaults: "
                f"{', '.join(bad)} (the engine calls hooks "
                f"positionally with the base arity)")
    return None


def check(policy_mods: list[Module], table_cli: str | None = None
          ) -> list[Finding]:
    base_mod = next((m for m in policy_mods
                     if m.rel.endswith("/base.py")), None)
    if base_mod is None:
        return []
    hooks = base_hooks(base_mod)
    classes = _policy_classes(policy_mods)
    registered = _registered_class_names(policy_mods)
    findings: list[Finding] = []

    for cname in sorted(classes):
        pc = classes[cname]
        for st in pc.node.body:
            if not isinstance(st, ast.FunctionDef) \
                    or st.name.startswith("__"):
                continue
            override = _hook_of(st)
            hook = hooks.get(st.name)
            if hook is not None:
                why = _check_signature(hook, override)
                if why:
                    findings.append(_finding(
                        "C301", pc.mod, st.lineno,
                        f"{cname}.{st.name} signature incompatible "
                        f"with the base hook: {why}",
                        f"match base: {hook.signature()}"))
            elif not st.name.startswith("_"):
                findings.append(_finding(
                    "C302", pc.mod, st.lineno,
                    f"{cname}.{st.name} is not a CompactionPolicy "
                    f"hook",
                    "typo'd override? prefix private helpers with "
                    "'_'; extend the contract in base.py if this is "
                    "a new hook"))

    for cname in sorted(registered):
        if cname not in classes:
            continue
        chain = _mro_chain(cname, classes)
        mod = registered[cname]
        lineno = classes[cname].node.lineno
        has_required = {h: False for h in _REQUIRED_HOOKS}
        has_name = False
        for pc in chain:
            for st in pc.node.body:
                if isinstance(st, ast.FunctionDef) \
                        and st.name in has_required:
                    has_required[st.name] = True
                if (isinstance(st, ast.Assign)
                        and len(st.targets) == 1
                        and isinstance(st.targets[0], ast.Name)
                        and st.targets[0].id == "name"
                        and isinstance(st.value, ast.Constant)
                        and st.value.value):
                    has_name = True
        for h, ok in has_required.items():
            if not ok:
                findings.append(_finding(
                    "C303", mod, lineno,
                    f"registered policy {cname} never overrides "
                    f"required hook {h}()",
                    f"implement {h}() (the base raises "
                    f"NotImplementedError)"))
        if not has_name:
            findings.append(_finding(
                "C303", mod, lineno,
                f"registered policy {cname} has no non-empty `name` "
                f"class attribute",
                "the registry keys policies by `name`"))

    findings += check_contract_table(base_mod, table_cli)
    return findings


# --------------------------------------------------------------------------
# C304: the generated contract table

def generate_contract_table(base_mod: Module, indent: str = "    ",
                            table_cli: str | None = None) -> str:
    """Render the contract table from ``base.py``'s actual declarations.

    Deterministic text; both the C304 check and
    ``--write-contract-table`` call this, so they cannot drift.
    ``table_cli`` is the CLI the header names (default: the port's).
    """
    table_cli = table_cli or get_tree().table_cli
    hooks = base_hooks(base_mod)
    surface = parse_contract_surface(base_mod)
    lines: list[str] = [TABLE_START, ""]
    lines.append("Hook surface (generated; regenerate with "
                 f"``{table_cli} --write-contract-table``):")
    lines.append("")
    public = [h for n, h in hooks.items() if not n.startswith("_")]
    shared = [h for n, h in hooks.items() if n.startswith("_")]
    width = max((len(h.signature()) for h in public + shared), default=0)
    for h in sorted(public, key=lambda h: h.lineno):
        kind = "required" if h.required else "default provided"
        lines.append(f"{h.signature():<{width}}  [{kind}]")
    for h in sorted(shared, key=lambda h: h.lineno):
        lines.append(f"{h.signature():<{width}}  [shared L0 body]")
    if surface is not None:
        lines.append("")
        lines.append("mechanism primitives (the only tree mutators "
                     "policies may call):")
        lines.append("  " + ", ".join(surface.primitives))
        lines.append("read-only index queries:")
        lines.append("  " + ", ".join(surface.index_queries))
        lines.append("index mutators owned by the shared L0 bodies:")
        lines.append("  " + ", ".join(surface.l0_index_mutators))
    lines.append("")
    lines.append(TABLE_END)
    return "\n".join(indent + ln if ln else "" for ln in lines)


def _current_table_block(source: str) -> tuple[str, int] | None:
    """The table text currently in the file and its start line (1-based)."""
    lines = source.splitlines()
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


def check_contract_table(base_mod: Module, table_cli: str | None = None
                         ) -> list[Finding]:
    source = "\n".join(base_mod.lines)
    block = _current_table_block(source)
    expected = generate_contract_table(base_mod, table_cli=table_cli)
    if block is None:
        return [_finding(
            "C304", base_mod, 1,
            "base.py has no generated contract table "
            f"({TABLE_START!r} marker missing)",
            f"run `{CLI} --write-contract-table`")]
    current, lineno = block

    def norm(text: str) -> list[str]:
        return [ln.rstrip() for ln in text.splitlines()]

    if norm(current) != norm(expected):
        return [_finding(
            "C304", base_mod, lineno,
            "contract table is out of date with the declared hooks/"
            "primitives",
            f"run `{CLI} --write-contract-table`")]
    return []


def write_contract_table(base_path: Path, table_cli: str | None = None
                         ) -> bool:
    """Rewrite the table block in ``base.py`` in place.  Returns True if
    the file changed."""
    from .astutil import load_modules
    root = base_path.parent
    [mod] = load_modules(root, [base_path])
    source = base_path.read_text()
    expected = generate_contract_table(mod, table_cli=table_cli)
    block = _current_table_block(source)
    if block is None:
        raise SystemExit(
            f"{base_path}: no {TABLE_START!r}/{TABLE_END!r} markers to "
            f"rewrite between")
    current, _ = block
    if current == expected:
        return False
    new_source = source.replace(current, expected, 1)
    base_path.write_text(new_source)
    return True
