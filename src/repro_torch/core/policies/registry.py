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


def get(name: str) -> CompactionPolicy:
    """Resolve a policy by registry name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown compaction policy {name!r}; registered policies: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def names() -> list[str]:
    """Registered policy names, in registration (canonical bench) order."""
    return list(_REGISTRY)
