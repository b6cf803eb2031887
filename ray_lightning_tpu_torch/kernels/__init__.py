"""Build, load and launch the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into a
shared library of its own with a plain C interface, under
``build/torch_kernels/`` at the root of the checkout, at first use, and
again when the source or a shared header (``csrc/*.cuh``) is newer. The
library loads with ``ctypes``; every pointer and the stream pass as
``ctypes.c_void_p``. Each C entry point launches on PyTorch's current stream
and returns ``cudaGetLastError()``; :meth:`CudaKernel.launch` raises when it
is not 0. A failed build raises with nvcc's output: nothing falls back.

Nothing here builds or loads at import time (the CPU tests import every
module, and the CPU has no nvcc).
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# dtype codes shared by every C entry point
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
KERNELS: List["CudaKernel"] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (neither on PATH nor at /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source on the machine with the card"
    )


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}.so"


def _stale(source: str) -> bool:
    """The library is missing, or older than its source or than any shared
    header (``csrc/*.cuh``) the sources may include."""
    lib = library_path(source)
    if not lib.exists():
        return True
    inputs = [CSRC_DIR / source, *CSRC_DIR.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in inputs)


def build(sources: Optional[Iterable[str]] = None) -> List[Path]:
    """Compile the given ``csrc`` sources (default: all of them) whose
    library is missing or stale (``_stale``), one nvcc process per source, all
    started together. Raises ``RuntimeError`` with the compiler's output if
    any build fails. Returns the library paths."""
    names = sorted(
        p.name for p in CSRC_DIR.glob("*.cu")
    ) if sources is None else list(sources)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        if not _stale(name):
            continue
        # unique temporary name, renamed into place: concurrent builders
        # never load a half-written library
        tmp = library_path(name).with_suffix(f".so.tmp{os.getpid()}")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((name, tmp, proc))
    failures = []
    for name, tmp, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name} (nvcc exit {proc.returncode}):\n{output}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return [library_path(n) for n in names]


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_PTXAS_REGS = re.compile(r"Used (\d+) registers")


def resource_usage(source: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of every kernel in ``csrc/<source>``, as
    ``nvcc -Xptxas -v`` reports them (a cubin compiled under the build
    directory with the library's flags, not linked), by mangled kernel name:
    ``{"registers": n, "spill_stores": bytes, "spill_loads": bytes}``.
    Raises ``RuntimeError`` with the compiler's output if the compile fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cubin = BUILD_DIR / f"{Path(source).stem}.ptxas.cubin"
    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    proc = subprocess.run(
        [_nvcc(), *flags, "-Xptxas", "-v", "--cubin", "-o", str(cubin),
         str(CSRC_DIR / source)],
        capture_output=True, text=True,
    )
    output = proc.stdout + proc.stderr
    cubin.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v {source} failed:\n{output}")
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in output.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            name = m.group(1)
            usage[name] = {"registers": 0, "spill_stores": 0, "spill_loads": 0}
            continue
        if name is None:
            continue
        m = _PTXAS_SPILLS.search(line)
        if m:
            usage[name]["spill_stores"] = int(m.group(1))
            usage[name]["spill_loads"] = int(m.group(2))
        m = _PTXAS_REGS.search(line)
        if m:
            usage[name]["registers"] = int(m.group(1))
    return usage


def load_library(source: str) -> ctypes.CDLL:
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            build([source])
            lib = ctypes.CDLL(str(library_path(source)))
            _LIBS[source] = lib
        return lib


class CudaKernel:
    """Handle of one C entry point: loads its library at first launch,
    checks the launch, and counts successful launches in ``launches`` (a
    plain int that the main path's runs read and reset)."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        KERNELS.append(self)

    def load(self) -> None:
        """Build (when stale) and load the kernel's library now, launching
        nothing: a caller that must not pay the build or the ``dlopen`` at
        its first launch calls this ahead. Thread-safe (``load_library``'s
        lock)."""
        if self._fn is None:
            self._load()

    def _load(self):
        fn = getattr(load_library(self.source), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args) -> None:
        fn = self._fn or self._load()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(
                f"CUDA kernel {self.name} ({self.symbol}) failed to launch: "
                f"cudaError {err}"
            )
        self.launches += 1


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{name}: kernel inputs must all lie on one CUDA device, got "
                f"{[str(x.device) for x in tensors]}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name}: kernel inputs must be contiguous")


def refuse_untracked_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel writes its outputs through a raw pointer, so autograd never
    sees it: called with grad mode on and an input that requires grad, it
    would return a result with no gradient path and ``backward()`` would
    quietly give wrong gradients. Raise instead; the ops' autograd Functions
    call the kernels with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel is invisible to autograd and an input "
            "requires grad; call the op through its autograd Function "
            "(ops.attention.attention, ops.rmsnorm.rmsnorm) or under "
            "torch.no_grad()"
        )


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise TypeError(
            f"{name}: dtype {dtype} is not supported by the kernel "
            "(float32 or bfloat16)"
        )
    return DTYPE_CODES[dtype]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def launch_counts() -> Dict[str, int]:
    """Launch count of every kernel of the port, by kernel name."""
    _register_all()
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    _register_all()
    for k in KERNELS:
        k.launches = 0


def _register_all() -> None:
    # the kernels register when their op modules are imported
    from ray_lightning_tpu_torch.ops import (  # noqa: F401
        attention,
        paged_attention,
        rmsnorm,
    )
