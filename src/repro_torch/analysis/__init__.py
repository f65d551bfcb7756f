"""Runtime analysis of the port: the DES schedule sanitizer
(:mod:`repro_torch.analysis.sanitizer`, ``REPRO_SANITIZE=1``)."""

from .sanitizer import (ENV_VAR, ScheduleSanitizer, ScheduleSanitizerError,
                        maybe_sanitizer)

__all__ = ["ENV_VAR", "ScheduleSanitizer", "ScheduleSanitizerError",
           "maybe_sanitizer"]
