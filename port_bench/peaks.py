"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit) and the roofline arithmetic, copied
from ``chip_smoke.roofline`` so that the yardstick stays with the benchmark.
A share read against these peaks is reported with the card's power limit
beside it (``device.power_limit`` in the result line)."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate
BF16_FLOP_S = 989e12           # H100 SXM dense bf16 tensor-core rate


def bound_s(nbytes: float, flops: float = 0.0) -> tuple[float, str]:
    """(least seconds, what sets it): bytes at 3.35 TB/s or bf16
    operations at 989 TFLOP/s, whichever takes longer."""
    b_s, f_s = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_S
    return (b_s, "bytes") if b_s >= f_s else (f_s, "operations")


def roofline_pct(nbytes: float, device_s: float,
                 flops: float = 0.0) -> float | None:
    """The share of its roofline that work of ``nbytes`` and ``flops``
    reached in ``device_s`` seconds of kernel time, in percent; None when
    no kernel time was read (never 0)."""
    if device_s <= 0.0 or nbytes + flops <= 0.0:
        return None
    return 100.0 * bound_s(nbytes, flops)[0] / device_s
