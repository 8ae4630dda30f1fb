"""Builds the port's CUDA kernels from `ray_tpu_torch/csrc/` at first use.

Each source compiles with nvcc into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), and is loaded
with ctypes. Libraries go to `build/ray_tpu_torch/` beside the package,
named by a hash of the sources and flags, so an edited source is never
served a stale library. Nothing here runs at import.

Every build is reported to the compile watch (`compile_watch.report_build`):
a record under ``kernel.<name>`` with nvcc's wall time, and the build's
seconds credited to the instrumented program that needed the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

from .._private import compile_watch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"

#: Kernel name -> source file in CSRC.
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "flash_fwd_any": "flash_fwd_any.cu",
           "flash_bwd_any": "flash_bwd_any.cu"}
#: Kernel name -> nvcc flags of its own. The paged decode source is built
#: once a (dtype, head_dim), so a process builds only what it runs.
DEFINES = {f"paged_decode_{t}_d{d}": (f"-DRTT_PAGED_{t.upper()}",
                                      f"-DRTT_PAGED_D={d}")
           for t in ("bf16", "f16", "f32") for d in (64, 128, 256)}
SOURCES.update(dict.fromkeys(DEFINES, "paged_decode.cu"))

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(
        " ".join(NVCC_FLAGS + DEFINES.get(name, ())).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names=tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all started together. Returns ptxas's report (registers,
    shared memory, spills) by kernel for the ones compiled now; raises
    with nvcc's output if one fails. Each compile's wall time, from the
    start to its own nvcc's exit, goes to the compile watch."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        started = {}
        for name in names:
            target = library_path(name)
            if target.exists():
                continue
            tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
            log = tmp.with_suffix(".log")
            cmd = [_nvcc(), *NVCC_FLAGS, *DEFINES.get(name, ()), "-o",
                   str(tmp), str(CSRC / SOURCES[name])]
            with open(log, "w") as out:
                proc = subprocess.Popen(cmd, stdout=out,
                                        stderr=subprocess.STDOUT)
            started[name] = (proc, tmp, target, log)
        # Build-once gate: holding _lock across the builds IS the
        # serialization (a concurrent loader waits for these libraries).
        seconds = {}
        while len(seconds) < len(started):
            for name, (proc, *_rest) in started.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.perf_counter() - t0
            if len(seconds) < len(started):
                time.sleep(0.01)  # rt: noqa[RT203] — build-once gate: holding _lock across nvcc IS the serialization
        reports = {}
        failures = []
        for name, (proc, tmp, target, log) in started.items():
            output = log.read_text(errors="replace")
            log.unlink()
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {SOURCES[name]}:\n{output}")
                continue
            os.replace(tmp, target)
            reports[name] = output
        if reports:
            compile_watch.report_build(
                {name: seconds[name] for name in reports},
                time.perf_counter() - t0)
        if failures:
            raise RuntimeError("\n".join(failures))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
    return lib
