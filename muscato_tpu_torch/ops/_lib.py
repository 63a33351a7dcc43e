"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by hand with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface that is loaded with ``ctypes``:
that builds in seconds, where an extension that includes PyTorch's headers
takes minutes.  The library lands in ``build/muscato_tpu_torch/<hash>/`` at
the repository root, keyed on a hash of the sources and flags, on first
use: importing this module compiles nothing.

Each C launcher takes raw device pointers and the stream of PyTorch's
current CUDA stream, launches without synchronising, and returns
``cudaGetLastError()``; ``launch`` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "muscato_tpu_torch")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint
# name -> argtypes of each extern "C" launcher or query (all return a
# cudaError_t).
_SIGNATURES = {
    "muscato_sorted_join": (_P, _I64, _P, _I64, _P, _P, _P),
    "muscato_expand_owners": (_P, _P, _P, _I64, _I64, _P, _P, _P),
    "muscato_expand_owners_sub": (_P, _P, _P, _I64, _I64, _P, _P, _P),
    "muscato_monotone_gather": (_P, _I64, _P, _I64, _P, _P),
    "muscato_monotone_gather_rows": (_P, _I64, _I, _P, _I64, _P, _P),
    "muscato_window_queries": (
        _P, _P, _I64, _I, _P, _I, _I, _I, _U, _U, _I, _P, _P, _P, _P,
    ),
    "muscato_verify_diagonals": (
        _P, _P, _I64, _P, _I, _P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _I, _I,
        _P, _P, _P, _P,
    ),
    "muscato_verify_tile": (_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I64)),
    "muscato_verify_pairs_tile": (_I, ctypes.POINTER(_I), ctypes.POINTER(_I64)),
    "muscato_verify_pairs": (
        _P, _P, _I64, _P, _I, _P, _I, _I, _P, _I, _I, _P, _P, _I, _P, _I, _I, _P, _I, _I,
        _I, _I, _P, _P, _P, _P, _P,
    ),
    "muscato_direct_probe": (_P, _P, _P, _I64, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "muscato_binary_probe": (
        _P, _P, _P, _I64, _P, _P, _I64, _P, _I, _I, _I, _I, _P, _P, _P,
    ),
}


@dataclass
class Kernels:
    lib: ctypes.CDLL
    path: str
    build_s: float  # compile time of this process's build; 0.0 if cached
    log: str  # nvcc's output (-Xptxas -v: registers, shared memory, spills)


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built here")


def _digest(srcs: list[str], flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of the flags, the sources and the headers they include."""
    h = hashlib.sha256(" ".join(flags).encode())
    for path in srcs + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    """Run the commands concurrently; raise with their output if any
    fails, else return their joined output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def _build(flags: tuple[str, ...] = NVCC_FLAGS,
           srcs: list[str] | None = None) -> tuple[str, float, str]:
    """Build the library of ``srcs`` (default: every source) with ``flags``
    (or find it built); returns its path, the compile time (0.0 if cached)
    and nvcc's output."""
    srcs = sources() if srcs is None else srcs
    out_dir = os.path.join(BUILD_ROOT, _digest(srcs, flags))
    out = os.path.join(out_dir, "libmuscato_kernels.so")
    if os.path.exists(out):
        return out, 0.0, ""
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    # Compile into a private directory and link to a private name, then
    # rename: a concurrent builder never sees a half-written library.
    work = tempfile.mkdtemp(dir=out_dir)
    t0 = time.perf_counter()
    try:
        objs = [
            os.path.join(work, os.path.basename(src) + ".o") for src in srcs
        ]
        log = _run_all([
            [nvcc, *flags, "-c", "-o", obj, src] for obj, src in zip(objs, srcs)
        ])
        lib = os.path.join(work, "lib.so")
        log += _run_all([[nvcc, *flags[:2], "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out, time.perf_counter() - t0, log


def load(path: str) -> ctypes.CDLL:
    """Load a built library with the signatures of the launchers it has
    set (a library built from some of the sources lacks the others)."""
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def kernels() -> Kernels:
    """The loaded kernel library, built on first call."""
    path, build_s, log = _build()
    return Kernels(lib=load(path), path=path, build_s=build_s, log=log)


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs its
    plain twin).  False when every tensor is on one CUDA device, checked
    for what the kernel takes.  Anything else raises: a tensor that is not
    on the CPU never reaches a plain twin."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(
                f"{name}: tensors must all be on the CPU or all on one CUDA "
                f"device, got {[str(x.device) for x in tensors]}"
            )
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32 tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return False


@functools.lru_cache(maxsize=None)
def _launcher(lib: ctypes.CDLL, name: str):
    """Launcher ``muscato_<name>`` of ``lib``, looked up once."""
    return getattr(lib, "muscato_" + name)


def launch(name: str, like: torch.Tensor, *args, lib: ctypes.CDLL | None = None) -> None:
    """Call launcher ``muscato_<name>`` of ``lib`` (default: the kernel
    library) on ``like``'s device and current stream; raise if the launch
    was refused.  The device is switched only when it is not current."""
    fn = _launcher(lib or kernels().lib, name)
    dev = like.device
    if dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed (cudaError {rc})")
