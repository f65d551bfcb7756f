"""The port's static and runtime analysis.

Static: the reference's lint families, run over ``src/repro_torch`` with
the same rule ids (``docs/analysis.md``) and the port's own paths
(:mod:`.trees`, the one table of what the rules read):

* :mod:`.layering` (L1xx) — the mechanism (``core/lsm.py`` / ``sim.py``
  / ``fleet.py``) never imports or branches on a concrete policy;
  policies touch the tree only through ``base.py``'s contract surface;
  ``kernels/`` never imports ``core``; the import graph is acyclic.
* :mod:`.determinism` (D2xx) — wall clock, global RNG, set-iteration
  order, identity-keyed sorts and float reductions over sets.
* :mod:`.contracts` (C3xx) — policies implement the hook set with
  compatible signatures; ``base.py``'s generated contract table is
  current.
* :mod:`.units` (U5xx) — a dimension-lattice dataflow pass over the
  unit-suffix naming convention.
* :mod:`.schemas` (B6xx) — the port's db_bench row shapes, extracted
  statically, against the reference's generated table in
  ``docs/benchmarks.md`` (by family, keys and units), the committed
  ``BENCH_dbbench.json`` and each other; the same schemas gate row
  emission at runtime under ``REPRO_PARANOID_CHECKS=1``.

Runtime: :mod:`.sanitizer`, the DES schedule sanitizer
(``REPRO_SANITIZE=1``).

CLI: ``python -m repro_torch.analysis [--format json|github] [--explain
RULE] [--package repro_torch|repro] [paths...]`` — exits non-zero on any
finding not covered by the port's baseline
(``.repro-torch-lint-baseline.json``, kept empty).
"""

from .catalog import CATALOG, RUNTIME_RULES, STATIC_RULES, explain
from .engine import (DEFAULT_BASELINE_NAME, FAMILIES, analyze_paths,
                     analyze_repo, find_repo_root)
from .findings import Finding, load_baseline, write_baseline
from .sanitizer import (ENV_VAR, ScheduleSanitizer, ScheduleSanitizerError,
                        maybe_sanitizer)
from .schemas import (load_schemas, paranoid_validate_rows,
                      validate_emitted_row)
from .trees import TREES

__all__ = [
    "CATALOG",
    "DEFAULT_BASELINE_NAME",
    "ENV_VAR",
    "FAMILIES",
    "Finding",
    "RUNTIME_RULES",
    "STATIC_RULES",
    "ScheduleSanitizer",
    "ScheduleSanitizerError",
    "TREES",
    "analyze_paths",
    "analyze_repo",
    "explain",
    "find_repo_root",
    "load_baseline",
    "load_schemas",
    "maybe_sanitizer",
    "paranoid_validate_rows",
    "validate_emitted_row",
    "write_baseline",
]
