"""Findings and the baseline file (``.repro-torch-lint-baseline.json``).

A :class:`Finding` is one rule violation at one source location; its
``fingerprint`` is stable under unrelated line churn (rule id + path +
a hash of the offending line's text), which is what makes a checked-in
baseline practical: old debt stays suppressed while the gate is strict
on new code.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import asdict, dataclass, field
from pathlib import Path

BASELINE_VERSION = 1


@dataclass(frozen=True)
class Finding:
    """One rule violation: where, what, and how to fix it."""

    rule: str          # e.g. "D201"
    family: str        # "layering" | "determinism" | "contracts"
    path: str          # posix path relative to the analysis root
    line: int          # 1-based
    message: str       # what is wrong
    hint: str          # how to fix it
    snippet: str = ""  # the offending source line (fingerprint input)

    def fingerprint(self) -> str:
        digest = hashlib.sha1(self.snippet.strip().encode()).hexdigest()
        return f"{self.rule}:{self.path}:{digest[:12]}"

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} {self.message}"
                f"\n    hint: {self.hint}")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d


@dataclass
class Baseline:
    """The set of known, accepted findings (see ``docs/analysis.md``)."""

    fingerprints: set[str] = field(default_factory=set)

    def covers(self, finding: Finding) -> bool:
        return finding.fingerprint() in self.fingerprints


def load_baseline(path: Path | str) -> Baseline:
    path = Path(path)
    if not path.exists():
        return Baseline()
    data = json.loads(path.read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline version in {path}: "
                         f"{data.get('version')!r}")
    return Baseline({e["fingerprint"] for e in data.get("findings", [])})


def write_baseline(path: Path | str, findings: list[Finding]) -> None:
    entries = sorted(
        ({"fingerprint": f.fingerprint(), "rule": f.rule, "path": f.path,
          "note": f.message} for f in findings),
        key=lambda e: (e["path"], e["fingerprint"]))
    payload = {
        "version": BASELINE_VERSION,
        "comment": "Accepted findings of the port's lint; regenerate "
                   "with `python -m repro_torch.analysis "
                   "--write-baseline`. Keep empty: fix a finding, or "
                   "suppress a false positive inline with "
                   "`# lint-ok: RULE` and a reason.",
        "findings": entries,
    }
    Path(path).write_text(json.dumps(payload, indent=2) + "\n")
