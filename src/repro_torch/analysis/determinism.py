"""Determinism rules (D2xx): the hazards bit-identical replay dies on.

The fleet-vs-serial parity gate and the byte-identical read-replay
captures only hold if every run of the same op stream takes the same
path.  These rules flag the classic ways Python code silently stops
being a pure function of its inputs:

* **D201** — wall-clock reads: ``time.time`` / ``time.time_ns`` /
  ``datetime.now`` / ``utcnow`` / ``today``.  ``time.perf_counter`` is
  allowed by convention, but only for *measure-and-report* timing
  (``wall_clock_s``) that never feeds back into simulated state.
* **D202** — process-global RNG: bare ``random.*`` and legacy
  ``np.random.*`` (anything that is not the explicit-``Generator`` API:
  ``default_rng`` / ``SeedSequence`` / ``Generator`` / bit generators).
* **D203** — ordered iteration over a ``set`` (``for``/comprehension/
  ``list()``/``tuple()``/``enumerate()``/``iter()``/``.join()`` over a
  set expression or a same-scope set alias).  Order-insensitive
  consumers (``sorted``, ``len``, ``min``, ``max``, ``any``, ``all``,
  set algebra, membership) are fine.
* **D204** — identity-keyed ordering: ``sorted``/``min``/``max``/
  ``.sort`` with ``key=id`` (ids vary run to run).
* **D205** — float reduction over an unordered container: ``sum()`` /
  ``functools.reduce`` over a set source (float addition is not
  associative; ``math.fsum`` is exempt because its result is
  order-independent).
"""

from __future__ import annotations

import ast

from .astutil import Module, dotted
from .findings import Finding

FAMILY = "determinism"

_WALL_CLOCK = {
    "time.time", "time.time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
    "datetime.datetime.today", "datetime.date.today",
}
_NP_RANDOM_OK = {"default_rng", "Generator", "SeedSequence", "PCG64",
                 "Philox", "SFC64", "MT19937", "BitGenerator"}
_ORDER_SENSITIVE_WRAPPERS = {"list", "tuple", "enumerate", "iter"}


def _finding(rule: str, mod: Module, lineno: int, message: str,
             hint: str) -> Finding:
    return Finding(rule=rule, family=FAMILY, path=mod.rel, line=lineno,
                   message=message, hint=hint, snippet=mod.line(lineno))


def _import_aliases(tree: ast.Module) -> dict[str, str]:
    """Map local names to the dotted path they are bound to, for every
    import anywhere in the module (``np`` → ``numpy``, a from-imported
    ``time`` → ``time.time``, ...)."""
    aliases: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{node.module}.{a.name}"
    return aliases


def _resolve(node: ast.AST, aliases: dict[str, str]) -> str | None:
    """Dotted path of a call target with its root import-alias expanded."""
    path = dotted(node)
    if path is None:
        return None
    head, _, rest = path.partition(".")
    full_head = aliases.get(head, head)
    return f"{full_head}.{rest}" if rest else full_head


class _SetTracker:
    """Set-valued expressions and their same-scope name aliases."""

    def __init__(self) -> None:
        self.names: set[str] = set()

    def is_set_expr(self, node: ast.AST) -> bool:
        if isinstance(node, (ast.Set, ast.SetComp)):
            return True
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id in ("set", "frozenset")):
            return True
        if (isinstance(node, ast.BinOp)
                and isinstance(node.op, (ast.BitAnd, ast.BitOr, ast.Sub,
                                         ast.BitXor))
                and (self.is_set_expr(node.left)
                     or self.is_set_expr(node.right))):
            return True          # set algebra stays a set
        return (isinstance(node, ast.Name) and node.id in self.names)

    def note_assign(self, node: ast.Assign) -> None:
        if (len(node.targets) == 1 and isinstance(node.targets[0], ast.Name)):
            if self.is_set_expr(node.value):
                self.names.add(node.targets[0].id)
            else:
                self.names.discard(node.targets[0].id)


def check(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        findings.extend(_check_module(mod))
    return findings


def _check_module(mod: Module) -> list[Finding]:
    findings: list[Finding] = []
    aliases = _import_aliases(mod.tree)
    sets = _SetTracker()

    def flag(rule, node, message, hint):
        findings.append(_finding(rule, mod, node.lineno, message, hint))

    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Assign):
            sets.note_assign(node)
        if isinstance(node, ast.Call):
            target = _resolve(node.func, aliases)
            if target in _WALL_CLOCK:
                flag("D201", node,
                     f"wall-clock read ({target}())",
                     "wall time breaks replay determinism: use a "
                     "monotonic counter for identity, time.perf_counter "
                     "for measure-only timing")
            elif target and target.startswith("random."):
                flag("D202", node,
                     f"process-global RNG ({target}())",
                     "draw from an explicitly seeded "
                     "np.random.default_rng(seed) passed in by the "
                     "caller")
            elif (target and target.startswith("numpy.random.")
                    and target.split(".")[2] not in _NP_RANDOM_OK):
                flag("D202", node,
                     f"legacy global numpy RNG ({target}())",
                     "use the Generator API: "
                     "np.random.default_rng(seed)")
            # D203: order-sensitive wrappers over a set
            if (isinstance(node.func, ast.Name)
                    and node.func.id in _ORDER_SENSITIVE_WRAPPERS
                    and node.args and sets.is_set_expr(node.args[0])):
                flag("D203", node,
                     f"{node.func.id}() over a set fixes an arbitrary "
                     f"order",
                     "sort first (sorted(s)) or keep an ordered "
                     "container")
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "join"
                    and node.args and sets.is_set_expr(node.args[0])):
                flag("D203", node,
                     "str.join over a set fixes an arbitrary order",
                     "join sorted(s) instead")
            # D204: identity-keyed ordering
            fn_name = (node.func.id if isinstance(node.func, ast.Name)
                       else node.func.attr
                       if isinstance(node.func, ast.Attribute) else "")
            if fn_name in ("sorted", "min", "max", "sort"):
                for kw in node.keywords:
                    if (kw.arg == "key" and isinstance(kw.value, ast.Name)
                            and kw.value.id == "id"):
                        flag("D204", node,
                             f"{fn_name}(..., key=id) orders by object "
                             f"identity",
                             "object ids vary per run: key on a stable "
                             "field (uid, name, tuple)")
            # D205: float reduction over an unordered source
            if isinstance(node.func, ast.Name) and node.func.id == "sum" \
                    and node.args:
                src = node.args[0]
                unordered = sets.is_set_expr(src)
                if isinstance(src, (ast.GeneratorExp, ast.ListComp)) \
                        and src.generators:
                    unordered = sets.is_set_expr(src.generators[0].iter)
                if unordered:
                    flag("D205", node,
                         "sum() over a set: float addition order is "
                         "unspecified",
                         "sum over sorted(s) (or use math.fsum, which "
                         "is order-independent)")
            if (_resolve(node.func, aliases) == "functools.reduce"
                    and len(node.args) >= 2
                    and sets.is_set_expr(node.args[1])):
                flag("D205", node,
                     "functools.reduce over a set: fold order is "
                     "unspecified",
                     "reduce over sorted(s)")
        elif isinstance(node, ast.For) and sets.is_set_expr(node.iter):
            flag("D203", node,
                 "for-loop over a set iterates in arbitrary order",
                 "iterate sorted(s), or restructure so order cannot "
                 "matter")
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.DictComp)):
            for gen in node.generators:
                if sets.is_set_expr(gen.iter):
                    flag("D203", node,
                         "comprehension over a set produces an "
                         "arbitrary order",
                         "iterate sorted(s) (a SetComp result would be "
                         "fine; ordered outputs are not)")
    return findings
