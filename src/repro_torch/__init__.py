"""PyTorch/CUDA port of the vLSM reproduction (``src/repro`` is the JAX
reference).

The store and its discrete-event simulator run with their arrays on a torch
``compute_device`` (``"cuda"`` by default; ``"cpu"`` only when asked for),
and the three kernels of the main path — merge_path, overlap_scan and
lindley_scan — are hand-written CUDA for Hopper (``csrc/``), built at first
use into ``build/repro_torch/``.
"""
