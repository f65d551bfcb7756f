"""The machine-readable rule catalog: every registered rule id with its
family, fires-when description, and fix hint.

The ids are the reference's (``docs/analysis.md`` documents them);
hints name the port's CLI.  ``python -m repro_torch.analysis --explain
RULE`` prints an entry.

The S4xx sanitizer rules are runtime invariants (no fixture marker, no
baseline fingerprints) but they are registered here so ``--explain``
and the doc check cover them too.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Rule:
    id: str
    family: str
    fires_when: str
    hint: str
    runtime: bool = False      # S4xx: enforced by the DES sanitizer


_R = Rule

CATALOG: dict[str, Rule] = {r.id: r for r in (
    # -- layering (L1xx) ---------------------------------------------------
    _R("L101", "layering",
       "a mechanism file imports a concrete policy module",
       "route through the registry (get_policy)"),
    _R("L102", "layering",
       "a mechanism file branches on a policy name string or Policy "
       "enum member",
       "add a hook to CompactionPolicy instead"),
    _R("L103", "layering",
       "a policy calls a tree/index method outside the contract surface",
       "use a MECHANISM_PRIMITIVES / INDEX_QUERIES entry, or widen the "
       "contract in base.py"),
    _R("L104", "layering",
       "a policy mutates engine structure directly",
       "mutate via replace_in_level / the shared _tiering_l0 / "
       "_incremental_l0 bodies"),
    _R("L105", "layering",
       "a kernels module imports the package's core",
       "kernels are the substrate; pass arrays in, keep the dependency "
       "one-way"),
    _R("L106", "layering",
       "an import cycle among the package's modules",
       "break the cycle (e.g. a leaf module with no package imports)"),
    # -- determinism (D2xx) ------------------------------------------------
    _R("D201", "determinism",
       "wall clock in logic (time.time, datetime.now, ...)",
       "derive names/ids from counters or seeds; time.perf_counter is "
       "fine for measuring wall time"),
    _R("D202", "determinism",
       "global RNG (np.random.rand, random.random, ...)",
       "thread an explicit np.random.default_rng(seed)"),
    _R("D203", "determinism",
       "ordered iteration over a set/frozenset",
       "iterate sorted(s)"),
    _R("D204", "determinism",
       "sorted/min/max/.sort with key=id",
       "sort by a stable field (uid, name)"),
    _R("D205", "determinism",
       "sum/functools.reduce over a set (float addition is not "
       "associative)",
       "sum(sorted(s)) or accumulate in insertion order"),
    # -- contracts (C3xx) --------------------------------------------------
    _R("C301", "contracts",
       "an override's signature is incompatible with the "
       "CompactionPolicy hook (base args must be a prefix; extras need "
       "defaults)",
       "match the base hook; add keyword defaults for policy-specific "
       "knobs"),
    _R("C302", "contracts",
       "a policy class grows a public method that is not a base hook",
       "prefix with '_', or promote it to a base hook"),
    _R("C303", "contracts",
       "a registered policy is missing name or a default_config "
       "override",
       "every registry entry must be constructible from "
       "default_config(scale)"),
    _R("C304", "contracts",
       "the generated contract table in base.py's docstring is stale",
       "python -m repro_torch.analysis --write-contract-table"),
    # -- sanitizer (S4xx, runtime) -----------------------------------------
    _R("S401", "sanitizer",
       "per-tree event times decrease during a run (REPRO_SANITIZE=1)",
       "event heap corruption: audit the push site the traceback names",
       runtime=True),
    _R("S402", "sanitizer",
       "a chain child starts before its parent_job finishes",
       "audit chain dependency wiring (deps / parent_job)",
       runtime=True),
    _R("S403", "sanitizer",
       "overlapping occupancy of a (tree, level) compaction slot",
       "audit SlotPool.schedule bookkeeping for that level",
       runtime=True),
    _R("S404", "sanitizer",
       "stall-gate queries per tree go back in time",
       "audit the stall-gate pruning order",
       runtime=True),
    # -- units (U5xx) ------------------------------------------------------
    _R("U501", "units",
       "+/-/comparison mixes two known units (seconds vs ms, bytes vs "
       "MB, ...)",
       "convert one side explicitly (* 1e3 for s→ms, / 1e6 for "
       "bytes→MB) before combining"),
    _R("U502", "units",
       "an assignment/return/dict entry whose target name carries a "
       "unit suffix receives a different known unit with no conversion "
       "factor",
       "apply the conversion at the site (* 1e3, / 1e6, round(x * 1e3, "
       "...)) or rename the target"),
    _R("U503", "units",
       "a conversion factor is applied to an already-converted value "
       "(ms * 1e3, MB / 1e6)",
       "the value is already in the target unit; drop the factor"),
    _R("U504", "units",
       "an unsuffixed key in a bench-row dict carries a value with a "
       "known dimension",
       "suffix the key (_s, _ms, _bytes, _mb, _ops_s) so JSON "
       "consumers know the unit"),
    # -- schemas (B6xx) ----------------------------------------------------
    _R("B601", "schemas",
       "the generated schema table in docs/benchmarks.md is stale or "
       "missing; for the port, its db_bench families, key sets and "
       "units differ from the port's emitter's",
       "fix the port's emitter (python -m repro_torch.analysis --rules "
       "schemas); the table itself is the reference's to write"),
    _R("B602", "schemas",
       "BENCH_dbbench.json disagrees with the emitter dict literals "
       "(missing/extra/mistyped keys, orphan families)",
       "fix the emitter (python -m repro_torch.analysis --rules "
       "schemas names the drift)"),
    _R("B603", "schemas",
       "the same key name carries two different units in two bench "
       "families",
       "one key name, one unit: rename one side or convert"),
)}

#: rules with `# expect-lint` fixtures (everything the AST pass emits)
STATIC_RULES: tuple[str, ...] = tuple(
    r.id for r in CATALOG.values() if not r.runtime)
RUNTIME_RULES: tuple[str, ...] = tuple(
    r.id for r in CATALOG.values() if r.runtime)


def explain(rule_id: str) -> str | None:
    """The --explain text for one rule id (None when unregistered)."""
    r = CATALOG.get(rule_id.upper())
    if r is None:
        return None
    kind = "runtime invariant" if r.runtime else "static rule"
    return (f"{r.id} [{r.family}] ({kind})\n"
            f"  fires when: {r.fires_when}\n"
            f"  fix hint:   {r.hint}")
