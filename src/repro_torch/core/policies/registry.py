"""Name -> CompactionPolicy registry (the policy resolution surface).

The mechanism, the DES and the harnesses resolve policies through
:func:`get`; registering a new policy makes it resolve everywhere by name.
"""

from __future__ import annotations

from .base import CompactionPolicy

_REGISTRY: dict[str, CompactionPolicy] = {}


def register(policy: CompactionPolicy) -> CompactionPolicy:
    """Register a policy instance under ``policy.name``; returns it."""
    if not policy.name:
        raise ValueError("policy must set a non-empty .name")
    if policy.name in _REGISTRY:
        raise ValueError(f"compaction policy {policy.name!r} is already "
                         f"registered (by {type(_REGISTRY[policy.name]).__name__})")
    _REGISTRY[policy.name] = policy
    return policy


def get(name) -> CompactionPolicy:
    """Resolve a policy by registry name (a str, or anything carrying the
    name as ``.value``, such as a ``Policy`` member)."""
    key = getattr(name, "value", name)
    try:
        return _REGISTRY[key]
    except KeyError:
        raise KeyError(
            f"unknown compaction policy {key!r}; registered policies: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def names() -> list[str]:
    """Registered policy names, in registration (canonical bench) order."""
    return list(_REGISTRY)


def default_configs(scale: int = 1 << 20) -> dict:
    """``{name: policy.default_config(scale)}`` for every registered policy."""
    return {n: p.default_config(scale) for n, p in _REGISTRY.items()}


def resolve_names(spec: str) -> list[str]:
    """A CLI policy list: ``"all"`` is every registered name, else a
    comma-separated (whitespace-tolerant) list checked by :func:`get`."""
    if spec == "all":
        return names()
    return [get(p.strip()).name for p in spec.split(",")]
