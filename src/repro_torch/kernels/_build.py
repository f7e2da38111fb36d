"""Build and load the port's CUDA C++ kernels (``repro_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` on its own into a shared library with
a plain C interface, for Hopper only (``sm_90a``), and loaded with
``ctypes``.  Libraries land in ``build/kernels/`` at the root of the
checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so a build is reused until one of them
changes.  Nothing here runs at import: the first
launch builds what it needs, and ``build()`` builds every source at once,
one ``nvcc`` process per source, all started together.

If ``nvcc`` is missing or a build fails this raises; nothing is
substituted for a kernel.

The C entries launch on the CURRENT device, on the stream they are
given, so ``entry`` returns a launcher that takes the tensors' device
first and makes it current around the call: a tensor on ``cuda:1`` is
never launched on device 0's context (peers as processes run one card
each).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_TIMEOUT_S = 600

_ENTRIES: dict = {}   # (library, entry) -> ctypes function, once loaded


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found (on PATH or /usr/local/cuda/bin): "
                           "the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    """Where source ``csrc/<name>.cu`` builds to (content-addressed: the
    source, every shared header ``csrc/*.cuh`` and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict:
    """Compile ``csrc/<name>.cu`` for each name (all sources when None)
    that has no current build, in parallel.  Returns {name: library
    path}; ``<path>.log`` beside each holds nvcc's ``-Xptxas=-v`` report
    (registers, shared memory, spills)."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp)
        failures = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            todo[n].with_suffix(".so.log").write_text(out)
            if proc.returncode != 0:
                failures.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{out}")
            else:
                os.replace(tmp, todo[n])
    finally:
        for proc, tmp in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return paths


def _on_device(fn, device, *args) -> int:
    with torch.cuda.device(device):
        return fn(*args)


def entry(name: str, symbol: str, argtypes):
    """The C function ``symbol`` of library ``name``, built and loaded on
    first use, with its ``argtypes`` declared and an int return (the
    ``cudaError_t`` of the launch), as ``launch(device, *args)``: the
    call runs with ``device`` current."""
    fn = _ENTRIES.get((name, symbol))
    if fn is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _ENTRIES[(name, symbol)] = fn
    return functools.partial(_on_device, fn)
