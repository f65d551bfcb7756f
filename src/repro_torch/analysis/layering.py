"""Layering rules (L1xx): the mechanism/policy split, mechanically.

The split is load-bearing: the parity gates assume the engine's
behaviour is a pure function of ``(cfg, policy object)``, so the engine
must never special-case a policy, and a policy must never reach past the
contract surface ``base.py`` declares.  These rules replace the old
``grep``-based purity test.

Rules:

* **L101** — ``core/lsm.py`` / ``sim.py`` / ``fleet.py`` import a
  concrete policy module (anything under ``<package>.core.policies``
  other than the package itself, whose registry is the sanctioned
  entry).
* **L102** — a mechanism file branches on a policy identity: a string
  constant equal to a registered policy name outside a docstring, or a
  ``Policy.<member>`` legacy-enum access.
* **L103** — a policy calls a tree/index method outside the contract
  surface (``MECHANISM_PRIMITIVES`` / ``INDEX_QUERIES`` in ``base.py``).
* **L104** — a policy mutates engine structure directly
  (``tree.levels`` / ``tree.index`` / tree attributes), outside the two
  shared L0 bodies in ``base.py`` that own L0 by contract.
* **L105** — ``kernels/*`` imports ``<package>.core`` (kernels are the
  bottom layer; the engine calls them, never the reverse).
* **L106** — the top-level import graph has a cycle.

The paths and package names come from :mod:`.trees` (the port's by
default).
"""

from __future__ import annotations

import ast

from .astutil import Module, dotted, import_edges
from .findings import Finding
from .trees import Tree, tree as get_tree

FAMILY = "layering"

#: counter ledgers a policy may bump freely (``tree.stats.x += 1``)
_STATS_ATTRS = ("stats",)
#: the two shared L0 strategy bodies in ``base.py`` that own L0
L0_BODIES = ("_tiering_l0", "_incremental_l0")


def _finding(rule: str, mod: Module, lineno: int, message: str,
             hint: str) -> Finding:
    return Finding(rule=rule, family=FAMILY, path=mod.rel, line=lineno,
                   message=message, hint=hint,
                   snippet=mod.line(lineno))


# --------------------------------------------------------------------------
# contract surface, parsed from base.py (single source for rule + table)

class ContractSurface:
    """The tree/index API policies may use, as declared in ``base.py``."""

    def __init__(self, primitives: tuple[str, ...],
                 index_queries: tuple[str, ...],
                 l0_index_mutators: tuple[str, ...]):
        self.primitives = primitives
        self.index_queries = index_queries
        self.l0_index_mutators = l0_index_mutators


def parse_contract_surface(base_mod: Module) -> ContractSurface | None:
    tuples: dict[str, tuple[str, ...]] = {}
    for node in base_mod.tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            name = node.targets[0].id
            if name in ("MECHANISM_PRIMITIVES", "INDEX_QUERIES",
                        "L0_INDEX_MUTATORS"):
                try:
                    value = ast.literal_eval(node.value)
                except ValueError:
                    continue
                tuples[name] = tuple(value)
    if "MECHANISM_PRIMITIVES" not in tuples:
        return None
    return ContractSurface(tuples["MECHANISM_PRIMITIVES"],
                           tuples.get("INDEX_QUERIES", ()),
                           tuples.get("L0_INDEX_MUTATORS", ()))


def registered_policy_names(policy_mods: list[Module]) -> set[str]:
    """Policy registry keys, read statically: every ``name = "..."``
    class attribute on a class in the policies package."""
    names: set[str] = set()
    for mod in policy_mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            for st in node.body:
                if (isinstance(st, ast.Assign) and len(st.targets) == 1
                        and isinstance(st.targets[0], ast.Name)
                        and st.targets[0].id == "name"
                        and isinstance(st.value, ast.Constant)
                        and isinstance(st.value.value, str)
                        and st.value.value):
                    names.add(st.value.value)
    return names


# --------------------------------------------------------------------------
# L101 / L102: the mechanism must not know the policies

def check_mechanism(mech_mods: list[Module], scanned: set[str],
                    policy_names: set[str], policy_pkg: str
                    ) -> list[Finding]:
    findings: list[Finding] = []
    for mod in mech_mods:
        for edge in import_edges(mod, include_nested=True):
            targets = [edge.target]
            # `from pkg import x` imports module pkg.x when x is one
            targets += [f"{edge.target}.{n}" for n in edge.names
                        if f"{edge.target}.{n}" in scanned]
            for t in targets:
                if t.startswith(policy_pkg + ".") and t != policy_pkg:
                    findings.append(_finding(
                        "L101", mod, edge.lineno,
                        f"mechanism file imports concrete policy module "
                        f"{t!r}",
                        "resolve policies only through the registry "
                        "(`from .policies import get_policy`)"))
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value in policy_names
                    and node.lineno not in mod.doc_lines):
                findings.append(_finding(
                    "L102", mod, node.lineno,
                    f"mechanism file references policy name "
                    f"{node.value!r}",
                    "the engine must be policy-agnostic: route the "
                    "decision through a CompactionPolicy hook"))
            elif (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id == "Policy"):
                findings.append(_finding(
                    "L102", mod, node.lineno,
                    f"mechanism file branches on legacy Policy enum "
                    f"(Policy.{node.attr})",
                    "replace the enum branch with a CompactionPolicy "
                    "hook"))
    return findings


# --------------------------------------------------------------------------
# L103 / L104: policies stay behind the contract surface

_MUTATING_LIST_METHODS = ("append", "clear", "extend", "insert", "pop",
                          "remove", "reverse", "sort")


def _tree_params(fn: ast.FunctionDef) -> set[str]:
    """Parameter names that carry the live LSMTree."""
    names: set[str] = set()
    for arg in (list(fn.args.posonlyargs) + list(fn.args.args)
                + list(fn.args.kwonlyargs)):
        ann = arg.annotation
        ann_s = ""
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            ann_s = ann.value
        elif ann is not None:
            ann_s = ast.unparse(ann)
        if arg.arg == "tree" or "LSMTree" in ann_s:
            names.add(arg.arg)
    return names


def _root_of(node: ast.AST) -> ast.AST:
    """Peel Attribute/Subscript chains down to their base expression."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node


def check_policy_purity(policy_mods: list[Module],
                        surface: ContractSurface) -> list[Finding]:
    findings: list[Finding] = []
    for mod in policy_mods:
        in_base = mod.rel.endswith("/base.py")
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            trees = _tree_params(fn)
            if not trees:
                continue
            l0_body = in_base and fn.name in L0_BODIES
            findings.extend(_check_policy_fn(mod, fn, trees, surface,
                                             l0_body))
    return findings


def _check_policy_fn(mod: Module, fn: ast.FunctionDef, trees: set[str],
                     surface: ContractSurface,
                     l0_body: bool) -> list[Finding]:
    findings: list[Finding] = []
    # aliases of engine-owned structure (`l0 = tree.levels[0]`)
    aliases: set[str] = set()

    def is_tree(node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in trees

    def is_tree_attr(node: ast.AST, attr: str) -> bool:
        return (isinstance(node, ast.Attribute) and node.attr == attr
                and is_tree(node.value))

    def structural_expr(node: ast.AST) -> bool:
        """Does this expression reach into tree.levels / tree.index?"""
        root = _root_of(node)
        if isinstance(root, ast.Name) and root.id in aliases:
            return True
        probe = node
        while isinstance(probe, (ast.Attribute, ast.Subscript)):
            if is_tree_attr(probe, "levels") or is_tree_attr(probe,
                                                             "index"):
                return True
            probe = probe.value
        return False

    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            # record structure aliases before judging the targets
            if (len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                    and structural_expr(node.value)):
                aliases.add(node.targets[0].id)
        if isinstance(node, ast.Call):
            func = node.func
            if not isinstance(func, ast.Attribute):
                continue
            owner = func.value
            if is_tree(owner):
                if func.attr not in surface.primitives:
                    findings.append(_finding(
                        "L103", mod, node.lineno,
                        f"policy calls non-contract tree method "
                        f"tree.{func.attr}()",
                        "use only the mechanism primitives listed in "
                        "base.py's contract table, or extend the "
                        "contract deliberately"))
            elif is_tree_attr(owner, "index"):
                if func.attr in surface.index_queries:
                    pass
                elif func.attr in surface.l0_index_mutators and l0_body:
                    pass
                elif func.attr in surface.l0_index_mutators:
                    findings.append(_finding(
                        "L104", mod, node.lineno,
                        f"policy mutates the LevelIndex "
                        f"(tree.index.{func.attr}()) outside the shared "
                        f"L0 bodies",
                        "L0 index ownership belongs to base.py's "
                        "_tiering_l0/_incremental_l0 only"))
                else:
                    findings.append(_finding(
                        "L103", mod, node.lineno,
                        f"policy calls non-contract index method "
                        f"tree.index.{func.attr}()",
                        "only the read-only INDEX_QUERIES in base.py's "
                        "contract table are policy-visible"))
            elif (isinstance(owner, ast.Name) and owner.id in aliases
                    and func.attr in _MUTATING_LIST_METHODS
                    and not l0_body):
                findings.append(_finding(
                    "L104", mod, node.lineno,
                    f"policy mutates engine structure through alias "
                    f"{owner.id!r} ({owner.id}.{func.attr}())",
                    "structure changes must go through the mechanism "
                    "primitives (merge_down/replace_in_level/...)"))
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(node, ast.AugAssign)
                       else node.targets)
            for tgt in targets:
                if isinstance(tgt, ast.Name):
                    continue      # rebinding a local is never a mutation
                # counters on the stats ledger are fair game
                probe = tgt
                while isinstance(probe, (ast.Attribute, ast.Subscript)):
                    if (isinstance(probe, ast.Attribute)
                            and probe.attr in _STATS_ATTRS
                            and is_tree(probe.value)):
                        break
                    probe = probe.value
                else:
                    probe = None
                if probe is not None:
                    continue
                direct_attr = (isinstance(tgt, ast.Attribute)
                               and is_tree(tgt.value))
                if (structural_expr(tgt) or direct_attr) and not l0_body:
                    findings.append(_finding(
                        "L104", mod, node.lineno,
                        "policy writes engine structure directly "
                        f"({ast.unparse(tgt)})",
                        "mutate only through the mechanism primitives; "
                        "L0 ownership lives in base.py's shared L0 "
                        "bodies"))
    return findings


# --------------------------------------------------------------------------
# L105: kernels never import core

def check_kernels(kernel_mods: list[Module], core_pkg: str
                  ) -> list[Finding]:
    findings = []
    for mod in kernel_mods:
        for edge in import_edges(mod, include_nested=True):
            if (edge.target == core_pkg
                    or edge.target.startswith(core_pkg + ".")):
                findings.append(_finding(
                    "L105", mod, edge.lineno,
                    f"kernel module imports {edge.target!r}",
                    "kernels are the bottom layer: hoist shared types "
                    "out of core, or pass plain arrays in"))
    return findings


# --------------------------------------------------------------------------
# L106: acyclic import graph

def check_import_cycles(modules: list[Module]) -> list[Finding]:
    by_name = {m.name: m for m in modules}
    graph: dict[str, set[str]] = {m.name: set() for m in modules}
    edge_line: dict[tuple[str, str], int] = {}
    for mod in modules:
        for edge in import_edges(mod):
            targets = []
            if edge.target in by_name:
                targets.append(edge.target)
            targets += [f"{edge.target}.{n}" for n in edge.names
                        if f"{edge.target}.{n}" in by_name]
            for t in targets:
                if t == mod.name:
                    continue
                # an ancestor package is always mid-initialization when
                # a submodule imports from it (`from . import x`) — the
                # interpreter tolerates that, so it is not a cycle edge;
                # the resolved submodule targets still are.
                if mod.name.startswith(t + "."):
                    continue
                graph[mod.name].add(t)
                edge_line.setdefault((mod.name, t), edge.lineno)

    sccs = _tarjan(graph)
    findings = []
    for scc in sccs:
        if len(scc) < 2:
            continue
        members = sorted(scc)
        anchor = by_name[members[0]]
        in_scc = set(scc)
        lineno = min((edge_line[(members[0], t)]
                      for t in graph[members[0]] if t in in_scc),
                     default=1)
        findings.append(_finding(
            "L106", anchor, lineno,
            "import cycle: " + " -> ".join(members + [members[0]]),
            "break the cycle with a TYPE_CHECKING-only import, a "
            "function-scoped import, or by moving the shared type down "
            "a layer"))
    return findings


def _tarjan(graph: dict[str, set[str]]) -> list[list[str]]:
    index: dict[str, int] = {}
    low: dict[str, int] = {}
    on_stack: dict[str, bool] = {}
    stack: list[str] = []
    sccs: list[list[str]] = []
    counter = [0]

    def strongconnect(v: str) -> None:
        # iterative Tarjan: (node, iterator) frames
        work = [(v, iter(sorted(graph[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on_stack[v] = True
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack[w] = True
                    work.append((w, iter(sorted(graph[w]))))
                    advanced = True
                    break
                elif on_stack.get(w):
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(scc)
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])

    for v in sorted(graph):
        if v not in index:
            strongconnect(v)
    return sccs


# --------------------------------------------------------------------------

def check(modules: list[Module], tree: Tree | None = None
          ) -> list[Finding]:
    """Run every layering rule over one scanned module set."""
    tree = tree or get_tree()
    scanned = {m.name for m in modules}
    mech = [m for m in modules if m.rel in tree.mech_rels]
    policies = [m for m in modules if m.rel.startswith(tree.policy_dir)]
    kernels = [m for m in modules if m.rel.startswith(tree.kernels_dir)]
    base = next((m for m in policies if m.rel.endswith("/base.py")), None)

    findings: list[Finding] = []
    policy_names = registered_policy_names(policies)
    findings += check_mechanism(mech, scanned, policy_names,
                                tree.policy_pkg)
    if base is not None:
        surface = parse_contract_surface(base)
        if surface is not None:
            findings += check_policy_purity(policies, surface)
    findings += check_kernels(kernels, tree.core_pkg)
    findings += check_import_cycles(modules)
    return findings
