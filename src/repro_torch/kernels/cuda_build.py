"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``.cu`` file becomes its own shared library with a plain C entry point
(no PyTorch headers, so a build takes seconds). Libraries go to
``kernels/_build/`` (listed in .gitignore), named by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.
``build`` starts one nvcc per source, all at once.

Nothing here runs when the module is imported: a kernel is built at its
first launch, or when a caller asks for ``build``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
from typing import Sequence

import torch

CSRC = pathlib.Path(__file__).with_name("csrc")
BUILD_DIR = pathlib.Path(__file__).with_name("_build")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")
KERNEL_SOURCES = ("approx_conv.cu", "approx_matmul.cu", "bitexact_emulator.cu",
                  "am_surrogate_matmul.cu")


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    if shutil.which("nvcc"):
        cands.append(shutil.which("nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "cannot be built")


def library_path(source: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh") and (f.name == source or f.suffix == ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


@dataclasses.dataclass
class BuildResult:
    source: str
    path: pathlib.Path
    seconds: float  # 0.0 when an up-to-date library was reused
    log: str  # nvcc's output, including ptxas' register report


def build(sources: Sequence[str] = KERNEL_SOURCES) -> dict[str, BuildResult]:
    """Compile each source into its own library, one nvcc per source, all
    started together; waits for every one and raises if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    results: dict[str, BuildResult] = {}
    running = []
    for src in sources:
        path = library_path(src)
        if path.exists():
            results[src] = BuildResult(src, path, 0.0, "")
            continue
        tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((src, proc, time.perf_counter(), tmp, path))
    failed = []
    for src, proc, t0, tmp, path in running:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(tmp, path)
        results[src] = BuildResult(src, path, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


class CudaKernel:
    """One C entry point of a built source, with its launch count.

    ``launch`` calls the entry point, which launches the kernel on the given
    stream and returns ``cudaGetLastError()``; a non-zero code raises. The
    count goes up by one for each launch and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib = None
        self._fn = None

    def _entry(self):
        if self._fn is None:
            self._lib = ctypes.CDLL(str(build([self.source])[self.source].path))
            fn = getattr(self._lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._entry()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {rc} at launch")
        self.launches += 1


def stream_of(t: torch.Tensor) -> int:
    """PyTorch's current stream on the tensor's device, as a pointer int."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor lies on one CUDA device and is contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
