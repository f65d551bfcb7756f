"""Build and load the hand-written Hopper kernels (``src/repro_torch/csrc``).

Each ``csrc/<name>.cu`` has a plain C interface.  It is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``build/repro_torch/`` at the root of the checkout, named by a hash
of its source and of the shared headers (``csrc/*.cuh``) so an edited
kernel or header is rebuilt, and loaded with ``ctypes``.
Nothing is built when a module is imported: the first launch builds what
it needs, and :func:`build` compiles a set of kernels in parallel (one
``nvcc`` process per source, all started together).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("merge_path", "overlap_scan", "lindley_scan", "flash_attention",
           "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
           "paged_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict[str, ctypes._CFuncPtr] = {}
#: ``nvcc -Xptxas -v`` report (registers, shared memory, spills) per kernel
#: built by this process.
ptxas_reports: dict[str, str] = {}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    """The library of ``<name>.cu``, named by a hash of that source and of
    every header in ``csrc/`` (``*.cuh``), so that an edited header too
    rebuilds the kernels."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode())
        digest.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names: tuple[str, ...] = KERNELS) -> None:
    """Compile every library of ``names`` that is not built yet, one nvcc
    per source, all running at once; raises with the compiler's output if
    any of them fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        ptxas_reports[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, fn_name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C entry ``fn_name`` of kernel library ``name`` (built on first
    use), returning the ``cudaError_t`` of its launches as an int."""
    fn = _entries.get(fn_name)
    if fn is None:
        lib = _loaded.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[fn_name] = fn
    return fn


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
