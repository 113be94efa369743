"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes plain C functions and compiles on its own
with ``nvcc -gencode arch=compute_90a,code=sm_90a -shared`` into
``build/kernels/<name>-<hash>.so`` under the repository root, where the
hash is that of the source, so an edited source never loads a stale
library. Nothing here runs at import time: the package imports on
machines without ``nvcc``.

Every wrapper calls its entry points through ``launch``, the one place
that passes the stream, checks the return and counts the call.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# per-kernel build record: {"seconds", "ptxas"} (empty when loaded from disk)
BUILD_LOG: Dict[str, dict] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# successful calls of each C entry point, by its name, since the process
# started (the count a run reads to show that its path reached a kernel);
# a call of ``ssd_forward`` runs four kernels and counts once, a call of
# any other entry runs one
LAUNCHES: Counter = Counter()
# the kernels a prefill may reach, built together at the first of them
# (one nvcc each, in parallel), so that only a first run waits, and once
PREFILL = ("flash_attention", "ssd", "rmsnorm")
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build(names: Iterable[str]) -> None:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together. Raises on any compile error."""
    with _lock:
        pending = [n for n in names if not _lib_path(n).exists()]
        started = {n: (_start(n), time.perf_counter()) for n in pending}
        errors = []
        for n, ((out, tmp, proc), t0) in started.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {n}.cu:\n{log}")
                continue
            os.replace(tmp, out)
            ptxas = [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
            BUILD_LOG[n] = {"seconds": time.perf_counter() - t0,
                            "ptxas": ptxas}
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be (with
    the rest of ``PREFILL`` where it is one of them)."""
    lib = _libs.get(name)
    if lib is None:
        build(PREFILL if name in PREFILL else [name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(str(_lib_path(name)))
    return lib


def launch(lib: str, entry: str, argtypes: Sequence, device, *args) -> None:
    """Call the C function ``entry`` of kernel ``lib`` (loaded, and built,
    if need be; ``argtypes`` its signature, the stream last, set at the
    first call) on ``device`` with ``args`` and that device's current
    stream. Raises a RuntimeError naming the entry on a non-zero
    ``cudaError``; counts the call in ``LAUNCHES`` where it succeeds."""
    fn = getattr(load(lib), entry)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry}: kernel launch failed: cudaError {err}")
    LAUNCHES[entry] += 1
