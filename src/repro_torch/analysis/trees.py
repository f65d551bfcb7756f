"""The one table of the paths and packages the lint rules read.

The rules are the same for both trees; only what they read differs, and
it differs here and nowhere else.  :data:`TREES` is keyed by package:

* ``repro_torch`` (the default) — the port.  The schema family extracts
  the port's ``bench_kv/db_bench.py`` alone, and B601 holds its variants
  to the db_bench rows of the reference's generated table in
  ``docs/benchmarks.md`` by family, key set and units, ignoring the
  emitter column (that doc is the reference's to write).
* ``repro`` — the reference's layout, so that the port's rules can run
  over the reference's fixture tree (``tests/data/lint_fixtures/``) and
  over ``src/repro`` and be held to the reference's own findings.  B601
  then diffs the whole generated table, emitter column included, as the
  reference does.
"""

from __future__ import annotations

from dataclasses import dataclass

#: the CLI that hints name
CLI = "python -m repro_torch.analysis"
DEFAULT_PACKAGE = "repro_torch"


@dataclass(frozen=True)
class Tree:
    """What the path-scoped rules read under one analysis root."""

    package: str
    #: the emitter files the schema family extracts (missing ones skip)
    emitter_rels: tuple[str, ...]
    #: emitters whose rows of the doc's generated table B601 compares by
    #: family, keys and units; None: the whole table, verbatim
    doc_emitters: tuple[str, ...] | None
    #: the CLI the generated contract table's header names
    table_cli: str

    @property
    def src(self) -> str:
        return f"src/{self.package}"

    @property
    def mech_rels(self) -> tuple[str, ...]:
        return tuple(f"{self.src}/core/{m}.py" for m in ("lsm", "sim",
                                                          "fleet"))

    @property
    def policy_pkg(self) -> str:
        return f"{self.package}.core.policies"

    @property
    def policy_dir(self) -> str:
        return f"{self.src}/core/policies/"

    @property
    def kernels_dir(self) -> str:
        return f"{self.src}/kernels/"

    @property
    def core_pkg(self) -> str:
        return f"{self.package}.core"

    @property
    def base_rel(self) -> str:
        """``--write-contract-table``'s file."""
        return f"{self.policy_dir}base.py"

    @property
    def default_paths(self) -> tuple[str, ...]:
        return (self.src,)


TREES: dict[str, Tree] = {
    "repro_torch": Tree(
        package="repro_torch",
        emitter_rels=("src/repro_torch/bench_kv/db_bench.py",),
        doc_emitters=("src/repro/bench_kv/db_bench.py",),
        table_cli=CLI),
    "repro": Tree(
        package="repro",
        emitter_rels=("src/repro/bench_kv/db_bench.py",
                      "benchmarks/common.py"),
        doc_emitters=None,
        table_cli="python -m repro.analysis"),
}


def tree(package: str | None = None) -> Tree:
    name = package or DEFAULT_PACKAGE
    if name not in TREES:
        raise ValueError(f"unknown package {name!r} (choose from "
                         f"{', '.join(TREES)})")
    return TREES[name]
