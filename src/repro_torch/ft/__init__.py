"""Fault tolerance of the port: the counterpart of ``repro/ft``."""

from .watchdog import FailureInjector, InjectedFailure, StepWatchdog

__all__ = ["FailureInjector", "InjectedFailure", "StepWatchdog"]
