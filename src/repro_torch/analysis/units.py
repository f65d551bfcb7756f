"""Unit-dimension rules (U5xx): a dataflow pass over physical quantities.

The paper's headline numbers are dimensioned — P99 latency (s vs ms),
I/O amplification (dimensionless), offered load (ops/s) — and the repo
moves them across four layers guarded only by naming conventions
(``p99_ms``, ``stall_total_s``, ``*_bytes``).  This pass makes the
convention load-bearing: it infers a unit for every expression from

* **name suffixes** — ``_s``, ``_ms``, ``_bytes``, ``_mb``, ``_ops``,
  ``_ops_s``/``_ops_per_s``, ``_bytes_per_s``, ``_amp``/``_frac``/
  ``_ratio``/``_pct`` (dimensionless);
* **the registry** — a small explicit table for unsuffixed hot-path
  names (``latency``, ``arrivals``, ``service`` are seconds arrays in
  ``sim.py``/``fleet.py``; ``busy`` is a dimensionless count;
  ``throughput`` is ops/s; ``pct()``/``perf_counter()`` return
  seconds) — the registry contract is documented in
  ``docs/analysis.md``;
* **function signatures** — a function named with a unit suffix returns
  that unit (``sst_bytes(...)`` → bytes), parameters carry their
  name-derived units into the body;

and walks each function body sequentially (alias tracking in the style
of ``determinism.py``), propagating units through arithmetic,
``round``/``float``/numpy passthroughs, subscripts and attributes.
Inference is *conservative*: anything not provably dimensioned is
UNKNOWN and combines freely — the rules only fire when both sides are
known and contradictory.

* **U501** — mixed-unit ``+``/``-``/comparison (seconds vs ms, ...).
* **U502** — an assignment / return / dict entry whose target name ends
  in a unit suffix receives a value of a *different* known unit without
  a recognized conversion factor (``* 1e3``, ``/ 1e6``,
  ``round(x * 1e3, 3)``).
* **U503** — a conversion factor applied to an already-converted value
  (``ms * 1e3``, ``mb / 1e6``): double conversion.
* **U504** — an unsuffixed key in a bench-row dict (a dict literal with
  a ``"bench"`` key) carries a value with a known dimension — the key
  name must state the unit the JSON row readers will assume.

``# lint-ok`` suppression and the churn-stable fingerprint/baseline
machinery apply as for every other family.
"""

from __future__ import annotations

import ast

from .astutil import Module, dotted
from .findings import Finding

FAMILY = "units"

# -- the dimension lattice -------------------------------------------------
SECONDS = "s"
MILLISECONDS = "ms"
BYTES = "bytes"
MEGABYTES = "MB"
OPS = "ops"
OPS_PER_S = "ops/s"
BYTES_PER_S = "bytes/s"
DIMENSIONLESS = "1"
#: every known unit, in display order (docs table + --explain)
UNITS = (SECONDS, MILLISECONDS, BYTES, MEGABYTES, OPS, OPS_PER_S,
         BYTES_PER_S, DIMENSIONLESS)
UNKNOWN = None

# -- name suffixes ---------------------------------------------------------
#: ordered: first match wins (``_ops_s`` must beat ``_s``)
_SUFFIXES: tuple[tuple[tuple[str, ...], str], ...] = (
    (("_ops_per_s", "_ops_s", "ops_per_s"), OPS_PER_S),
    (("_bytes_per_s", "bytes_per_s", "_bps"), BYTES_PER_S),
    (("_ms",), MILLISECONDS),
    (("_s",), SECONDS),
    (("_mb",), MEGABYTES),
    (("_bytes",), BYTES),
    (("_ops",), OPS),
    (("_amp", "_frac", "_ratio", "_pct", "_share"), DIMENSIONLESS),
)

#: whole (or terminal-``_``-segment) names with a fixed unit — the
#: explicit registry for unsuffixed hot-path quantities.  Kept small on
#: purpose; the contract is documented in docs/analysis.md and changes
#: here must be mirrored there (the check_links.py drift check covers
#: the rule ids, the registry rides in the U5xx section).
NAME_REGISTRY: dict[str, str] = {
    "latency": SECONDS,       # SimResult.latency / per-op sojourn arrays
    "arrivals": SECONDS,      # arrival timestamp arrays
    "service": SECONDS,       # per-op service-demand arrays
    "departures": SECONDS,
    "makespan": SECONDS,
    "wall": SECONDS,          # perf_counter deltas in the emitters
    "busy": DIMENSIONLESS,    # busy-server count (sim.py BUSY_ALPHA path)
    "throughput": OPS_PER_S,
    "ops": OPS,               # bench-row op counts ("ops": n_ops)
    # sweep-executor phase timing (core/sweeps.py PointTiming): the
    # ``_s`` suffix already resolves these, but the executor's bench-row
    # contract is pinned here explicitly so renames surface as registry
    # drift, not silent unit loss.
    "structural_s": SECONDS,      # phase A (structural replay) wall
    "temporal_s": SECONDS,        # per-schedule temporal-pass wall
    "lindley_s": SECONDS,         # per-schedule Lindley-scan wall
    "finalize_s": SECONDS,        # per-schedule finalize wall
    "executor_wall_s": SECONDS,   # perf_trajectory: executor wall-clock
    "serial_equiv_s": SECONDS,    # perf_trajectory: summed task compute
}

#: callables whose *return* unit is fixed (matched on the terminal
#: attribute/name of the callee)
CALL_REGISTRY: dict[str, str] = {
    "perf_counter": SECONDS,  # time.perf_counter() — measuring, not logic
    "pct": SECONDS,           # SimResult.pct(q): latency percentile
}

#: callables transparent to units: unit(f(x)) == unit(x); for the
#: variadic ones (min/max/...) the argument units are joined
_PASSTHROUGH_CALLS = {
    "round", "float", "int", "abs", "sorted", "sum", "min", "max",
    "percentile", "quantile", "mean", "median", "cumsum", "asarray",
    "ascontiguousarray", "maximum", "minimum", "accumulate", "where",
    "concatenate", "stack", "hstack", "clip", "nan_to_num", "array",
}
#: zero-argument-ish methods transparent to units (x.astype(...), x.copy())
_PASSTHROUGH_METHODS = {
    "astype", "copy", "mean", "sum", "max", "min", "item", "tolist",
    "ravel", "reshape", "squeeze", "round", "clip", "cumsum", "take",
}

# -- conversion constants --------------------------------------------------
_KILO = "KILO"       # 1e3 / 1000
_MILLI = "MILLI"     # 1e-3
_MEGA = "MEGA"       # 1e6 / 1_000_000 / (1 << 20)
_SCALAR = "SCALAR"   # any other numeric literal

#: unit × constant → unit for ``*``; the string "U503" flags a double
#: conversion instead of producing a unit
_MUL_CONV: dict[tuple[str, str], str] = {
    (SECONDS, _KILO): MILLISECONDS,
    (MILLISECONDS, _MILLI): SECONDS,
    (MILLISECONDS, _KILO): "U503",
    (MEGABYTES, _MEGA): BYTES,
    (BYTES, _MEGA): "U503",
}
#: unit × constant → unit for ``/``
_DIV_CONV: dict[tuple[str, str], str] = {
    (MILLISECONDS, _KILO): SECONDS,
    (BYTES, _MEGA): MEGABYTES,
    (MEGABYTES, _MEGA): "U503",
    (SECONDS, _MILLI): MILLISECONDS,
}
#: unit × unit → unit for ``*`` (symmetric; dimensionless handled apart)
_MUL_UNITS: dict[tuple[str, str], str] = {
    (SECONDS, OPS_PER_S): OPS,
    (SECONDS, BYTES_PER_S): BYTES,
}
#: unit / unit → unit
_DIV_UNITS: dict[tuple[str, str], str] = {
    (OPS, SECONDS): OPS_PER_S,
    (BYTES, SECONDS): BYTES_PER_S,
    (OPS, OPS_PER_S): SECONDS,
    (BYTES, BYTES_PER_S): SECONDS,
}


def suffix_unit(name: str | None) -> str | None:
    """Unit implied by a name's suffix, or None."""
    if not name:
        return UNKNOWN
    low = name.lower()
    for suffixes, unit in _SUFFIXES:
        for suf in suffixes:
            if low.endswith(suf):
                return unit
    return UNKNOWN


def name_unit(name: str | None) -> str | None:
    """Unit of a bare name: suffix first, then the registry (matched on
    the whole name and on its terminal ``_`` segment, so ``run_arrivals``
    and ``res.latency`` both resolve)."""
    if not name:
        return UNKNOWN
    u = suffix_unit(name)
    if u is not UNKNOWN:
        return u
    if name in NAME_REGISTRY:
        return NAME_REGISTRY[name]
    tail = name.rsplit("_", 1)[-1]
    return NAME_REGISTRY.get(tail, UNKNOWN)


def _const_value(node: ast.AST) -> float | None:
    """Numeric value of a literal expression (1e3, 1000, 1 << 20, -1)."""
    try:
        v = ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError, MemoryError):
        return None
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def _const_class(node: ast.AST) -> str | None:
    v = _const_value(node)
    if v is None:
        return None
    if v in (1e3,):
        return _KILO
    if v in (1e-3,):
        return _MILLI
    if v in (1e6, float(1 << 20)):
        return _MEGA
    return _SCALAR


def _join(units: list[str | None]) -> str | None:
    """Least upper bound of element units: all known-and-equal → that
    unit (unknowns are optimistic and don't poison the join)."""
    known = {u for u in units if u is not UNKNOWN}
    if len(known) == 1:
        return known.pop()
    return UNKNOWN


def _callee_tail(func: ast.AST) -> str | None:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


class UnitEvaluator:
    """Per-module unit inference + U5xx flagging.

    One instance per module; ``run()`` walks the module body and every
    function def as an independent sequential scope.  Pass
    ``collect=False`` to reuse the inference without emitting findings
    (``schemas.py`` does, for per-key units of bench-row dicts).
    """

    def __init__(self, mod: Module, collect: bool = True):
        self.mod = mod
        self.collect = collect
        self.findings: list[Finding] = []

    # -- findings ----------------------------------------------------------
    def _flag(self, rule: str, node: ast.AST, message: str,
              hint: str) -> None:
        if not self.collect:
            return
        lineno = getattr(node, "lineno", 1)
        self.findings.append(Finding(
            rule=rule, family=FAMILY, path=self.mod.rel, line=lineno,
            message=message, hint=hint, snippet=self.mod.line(lineno)))

    # -- scopes ------------------------------------------------------------
    def run(self) -> list[Finding]:
        self._walk_body(self.mod.tree.body, env={}, fn_unit=UNKNOWN)
        for fn in self._functions(self.mod.tree):
            self.function_env(fn)
        return self.findings

    def _functions(self, tree: ast.AST) -> list[ast.FunctionDef]:
        fns = []
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fns.append(node)
        return fns

    def function_env(self, fn: ast.FunctionDef) -> dict[str, str]:
        """Sequentially walk one function body; returns the final
        name → unit environment (used by schemas.py)."""
        env: dict[str, str] = {}
        a = fn.args
        for arg in (list(a.posonlyargs) + list(a.args)
                    + list(a.kwonlyargs)):
            u = name_unit(arg.arg)
            if u is not UNKNOWN:
                env[arg.arg] = u
        ret = name_unit(fn.name)
        self._walk_body(fn.body, env, fn_unit=ret, fn_name=fn.name)
        return env

    # -- statements --------------------------------------------------------
    def _walk_body(self, stmts: list[ast.stmt], env: dict[str, str],
                   fn_unit: str | None, fn_name: str = "") -> None:
        for st in stmts:
            self._statement(st, env, fn_unit, fn_name)

    def _statement(self, st: ast.stmt, env: dict[str, str],
                   fn_unit: str | None, fn_name: str) -> None:
        if isinstance(st, ast.Assign):
            v = self.infer(st.value, env)
            for tgt in st.targets:
                self._bind(tgt, st.value, v, env)
        elif isinstance(st, ast.AnnAssign) and st.value is not None:
            v = self.infer(st.value, env)
            self._bind(st.target, st.value, v, env)
        elif isinstance(st, ast.AugAssign):
            t = self._target_unit(st.target, env)
            v = self.infer(st.value, env)
            if isinstance(st.op, (ast.Add, ast.Sub)) and t and v \
                    and t != v and DIMENSIONLESS not in (t, v):
                self._flag("U501", st,
                           f"augmented {self._opname(st.op)} mixes units: "
                           f"target is {t}, value is {v}",
                           "convert explicitly (* 1e3 for s→ms, / 1e6 "
                           "for bytes→MB) or fix the name")
        elif isinstance(st, ast.Return):
            if st.value is not None:
                v = self.infer(st.value, env)
                if fn_unit and v and fn_unit != v \
                        and DIMENSIONLESS not in (fn_unit, v):
                    self._flag(
                        "U502", st,
                        f"{fn_name}() is named as {fn_unit} but returns "
                        f"{v}",
                        "apply the conversion at the return site or "
                        "rename the function")
        elif isinstance(st, ast.For):
            it = self.infer(st.iter, env)
            if isinstance(st.target, ast.Name) and it is not UNKNOWN:
                env[st.target.id] = it       # element of a typed array
            self._walk_body(st.body, env, fn_unit, fn_name)
            self._walk_body(st.orelse, env, fn_unit, fn_name)
        elif isinstance(st, (ast.While,)):
            self.infer(st.test, env)
            self._walk_body(st.body, env, fn_unit, fn_name)
            self._walk_body(st.orelse, env, fn_unit, fn_name)
        elif isinstance(st, ast.If):
            self.infer(st.test, env)
            self._walk_body(st.body, env, fn_unit, fn_name)
            self._walk_body(st.orelse, env, fn_unit, fn_name)
        elif isinstance(st, ast.With):
            for item in st.items:
                self.infer(item.context_expr, env)
            self._walk_body(st.body, env, fn_unit, fn_name)
        elif isinstance(st, ast.Try):
            self._walk_body(st.body, env, fn_unit, fn_name)
            for h in st.handlers:
                self._walk_body(h.body, env, fn_unit, fn_name)
            self._walk_body(st.orelse, env, fn_unit, fn_name)
            self._walk_body(st.finalbody, env, fn_unit, fn_name)
        elif isinstance(st, ast.Expr):
            self.infer(st.value, env)
        # FunctionDef/ClassDef bodies are separate scopes (run() visits
        # every def); other statements carry no unit information.

    def _bind(self, tgt: ast.AST, value_node: ast.AST,
              v: str | None, env: dict[str, str]) -> None:
        """Record a binding and run the U502 contradiction check."""
        if isinstance(tgt, ast.Name):
            t = name_unit(tgt.id)
            self._check_assign(tgt.id, t, value_node, v, tgt)
            env[tgt.id] = v if v is not UNKNOWN else (t or UNKNOWN)
        elif isinstance(tgt, ast.Attribute):
            t = name_unit(tgt.attr)
            self._check_assign(tgt.attr, t, value_node, v, tgt)
        elif isinstance(tgt, ast.Subscript):
            key = tgt.slice
            if isinstance(key, ast.Constant) and isinstance(key.value, str):
                t = suffix_unit(key.value)
                self._check_assign(f"[{key.value!r}]", t, value_node, v,
                                   tgt)
            else:
                t = self._target_unit(tgt, env)
                if t and v and t != v and DIMENSIONLESS not in (t, v):
                    self._flag("U501", tgt,
                               f"stores {v} into a {t} array",
                               "convert explicitly or fix the name")
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            elts = getattr(value_node, "elts", None) \
                if isinstance(value_node, (ast.Tuple, ast.List)) else None
            for i, sub in enumerate(tgt.elts):
                if elts is not None and i < len(elts):
                    self._bind(sub, elts[i],
                               self.infer(elts[i], env), env)
                elif isinstance(sub, ast.Name):
                    env.pop(sub.id, None)

    def _check_assign(self, tname: str, t: str | None,
                      value_node: ast.AST, v: str | None,
                      at: ast.AST) -> None:
        if t and v and t != v and DIMENSIONLESS not in (t, v):
            self._flag("U502", at,
                       f"{tname} is named as {t} but receives {v}",
                       "apply the conversion at the assignment "
                       "(* 1e3 for s→ms, / 1e6 for bytes→MB) or "
                       "rename the target")

    def _target_unit(self, tgt: ast.AST, env: dict[str, str]
                     ) -> str | None:
        if isinstance(tgt, ast.Name):
            return env.get(tgt.id) or name_unit(tgt.id)
        if isinstance(tgt, ast.Attribute):
            return name_unit(tgt.attr)
        if isinstance(tgt, ast.Subscript):
            return self._target_unit(tgt.value, env)
        return UNKNOWN

    # -- expressions -------------------------------------------------------
    def infer(self, node: ast.AST, env: dict[str, str]) -> str | None:
        """Unit of an expression; flags U501/U503/U504 as it walks."""
        if isinstance(node, ast.Name):
            u = env.get(node.id)
            return u if u is not UNKNOWN and u is not None \
                else name_unit(node.id)
        if isinstance(node, ast.Attribute):
            self.infer(node.value, env)
            return name_unit(node.attr)
        if isinstance(node, ast.Subscript):
            self.infer(node.slice, env)
            return self.infer(node.value, env)
        if isinstance(node, ast.Constant):
            return UNKNOWN       # bare literals are unitless (0.0 inits)
        if isinstance(node, ast.Call):
            return self._infer_call(node, env)
        if isinstance(node, ast.BinOp):
            return self._infer_binop(node, env)
        if isinstance(node, ast.Compare):
            return self._infer_compare(node, env)
        if isinstance(node, ast.BoolOp):
            return _join([self.infer(v, env) for v in node.values])
        if isinstance(node, ast.UnaryOp):
            return self.infer(node.operand, env)
        if isinstance(node, ast.IfExp):
            self.infer(node.test, env)
            return _join([self.infer(node.body, env),
                          self.infer(node.orelse, env)])
        if isinstance(node, (ast.List, ast.Tuple, ast.Set)):
            return _join([self.infer(e, env) for e in node.elts])
        if isinstance(node, ast.Dict):
            self._infer_dict(node, env)
            return UNKNOWN
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            for gen in node.generators:
                self.infer(gen.iter, env)
            # the comprehension carries its element's unit
            # ([c.critical_path_s for c in chains] is a seconds array)
            return self.infer(node.elt, env)
        if isinstance(node, ast.DictComp):
            for gen in node.generators:
                self.infer(gen.iter, env)
            self.infer(node.key, env)
            self.infer(node.value, env)
            return UNKNOWN
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    self.infer(v.value, env)
            return UNKNOWN
        if isinstance(node, ast.Starred):
            return self.infer(node.value, env)
        if isinstance(node, ast.Lambda):
            self.infer(node.body, {})
            return UNKNOWN
        if isinstance(node, ast.Slice):
            for part in (node.lower, node.upper, node.step):
                if part is not None:
                    self.infer(part, env)
            return UNKNOWN
        if isinstance(node, ast.NamedExpr):
            v = self.infer(node.value, env)
            self._bind(node.target, node.value, v, env)
            return v
        return UNKNOWN

    def _infer_call(self, node: ast.Call, env: dict[str, str]
                    ) -> str | None:
        arg_units = [self.infer(a, env) for a in node.args]
        for kw in node.keywords:
            self.infer(kw.value, env)
        tail = _callee_tail(node.func)
        if isinstance(node.func, ast.Attribute):
            self.infer(node.func.value, env)
        if tail in CALL_REGISTRY:
            return CALL_REGISTRY[tail]
        if tail in _PASSTHROUGH_CALLS:
            real = [u for n, u in zip(node.args, arg_units)
                    if not (isinstance(n, ast.Constant))]
            if len(node.args) == 1 and isinstance(node.args[0],
                                                  (ast.List, ast.Tuple)):
                return arg_units[0]   # np.concatenate([a, b])
            if real:
                return _join(real)
            return arg_units[0] if arg_units else UNKNOWN
        if tail in _PASSTHROUGH_METHODS \
                and isinstance(node.func, ast.Attribute):
            return self.infer(node.func.value, env)
        u = suffix_unit(tail)    # function-name suffix → return unit
        if u is not UNKNOWN:
            return u
        return UNKNOWN

    def _opname(self, op: ast.operator | ast.cmpop) -> str:
        return {"Add": "+", "Sub": "-", "Lt": "<", "LtE": "<=",
                "Gt": ">", "GtE": ">=", "Eq": "==", "NotEq": "!=",
                }.get(type(op).__name__, type(op).__name__)

    def _infer_binop(self, node: ast.BinOp, env: dict[str, str]
                     ) -> str | None:
        left = self.infer(node.left, env)
        right = self.infer(node.right, env)
        lc = _const_class(node.left)
        rc = _const_class(node.right)

        if isinstance(node.op, (ast.Add, ast.Sub)):
            if left and right and left != right \
                    and DIMENSIONLESS not in (left, right):
                self._flag(
                    "U501", node,
                    f"{self._opname(node.op)} mixes {left} and {right}",
                    "convert one side explicitly (* 1e3 for s→ms, "
                    "/ 1e6 for bytes→MB) before combining")
                return UNKNOWN
            return _join([left, right])

        if isinstance(node.op, ast.Mult):
            for unit, const in ((left, rc), (right, lc)):
                if unit and const:
                    out = _MUL_CONV.get((unit, const))
                    if out == "U503":
                        self._flag(
                            "U503", node,
                            f"conversion factor applied to an already-"
                            f"converted value ({unit} * {const.lower()})",
                            "the value is already in the target unit; "
                            "drop the factor")
                        return UNKNOWN
                    if out:
                        return out
                    if const == _SCALAR:
                        return unit
                    return UNKNOWN
            if left and right:
                if DIMENSIONLESS in (left, right):
                    return right if left == DIMENSIONLESS else left
                out = _MUL_UNITS.get((left, right)) \
                    or _MUL_UNITS.get((right, left))
                return out or UNKNOWN
            return UNKNOWN

        if isinstance(node.op, ast.Div):
            if left and rc:
                out = _DIV_CONV.get((left, rc))
                if out == "U503":
                    self._flag(
                        "U503", node,
                        f"conversion factor applied to an already-"
                        f"converted value ({left} / {rc.lower()})",
                        "the value is already in the target unit; "
                        "drop the factor")
                    return UNKNOWN
                if out:
                    return out
                if rc == _SCALAR:
                    return left
                return UNKNOWN
            if left and right:
                if left == right:
                    return DIMENSIONLESS
                if right == DIMENSIONLESS:
                    return left
                return _DIV_UNITS.get((left, right)) or UNKNOWN
            return UNKNOWN

        return UNKNOWN     # //, %, **, <<, ... carry no unit meaning here

    def _infer_compare(self, node: ast.Compare, env: dict[str, str]
                       ) -> str | None:
        units = [self.infer(node.left, env)]
        for op, comp in zip(node.ops, node.comparators):
            u = self.infer(comp, env)
            if isinstance(op, (ast.Lt, ast.LtE, ast.Gt, ast.GtE,
                               ast.Eq, ast.NotEq)):
                prev = units[-1]
                if prev and u and prev != u \
                        and DIMENSIONLESS not in (prev, u):
                    self._flag(
                        "U501", node,
                        f"comparison {self._opname(op)} mixes {prev} "
                        f"and {u}",
                        "convert one side explicitly before comparing")
            units.append(u)
        return UNKNOWN

    # -- bench-row dicts (U502 on suffixed keys, U504 on unsuffixed) -------
    def _infer_dict(self, node: ast.Dict, env: dict[str, str]) -> None:
        keys = [k.value if isinstance(k, ast.Constant)
                and isinstance(k.value, str) else None
                for k in node.keys]
        is_bench_row = "bench" in keys
        for key, vnode in zip(keys, node.values):
            v = self.infer(vnode, env)
            if key is None:
                continue
            t = name_unit(key)
            if t is not UNKNOWN:
                self._check_assign(f'"{key}"', t, vnode, v, vnode)
            elif is_bench_row and v not in (UNKNOWN, DIMENSIONLESS):
                self._flag(
                    "U504", vnode,
                    f'bench-row key "{key}" carries a {v} value but '
                    f"does not name the unit",
                    f'suffix the key ("{key}_{v.replace("/", "_per_")}"'
                    f") so JSON consumers know the unit")


def dict_key_units(mod: Module, fn: ast.FunctionDef | None,
                   node: ast.Dict) -> dict[str, str | None]:
    """Per-key inferred units of one dict literal (for ``schemas.py``).

    Runs the silent evaluator over the enclosing function to build the
    alias environment, then infers each value expression.
    """
    ev = UnitEvaluator(mod, collect=False)
    env = ev.function_env(fn) if fn is not None else {}
    out: dict[str, str | None] = {}
    for k, vnode in zip(node.keys, node.values):
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            out[k.value] = ev.infer(vnode, env)
    return out


def check(modules: list[Module]) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        findings += UnitEvaluator(mod).run()
    return findings
