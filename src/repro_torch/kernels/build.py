"""Build a kernel's CUDA source into a shared library and load it with ctypes.

Every Hopper kernel of the port is a ``csrc/*.cu`` file with a plain C
interface. ``CudaLibrary(src, declare)`` compiles it with ``nvcc`` for
``sm_90a`` at first use, into a git-ignored ``build/`` directory beside the
kernel's ``csrc/``, under a file name that carries a hash of the source and
the flags (an edited source builds anew). The compiler writes a temporary
file that is renamed into place atomically, so processes that build at the
same time never load a half-written library. ``load()`` builds and opens the
library once per process, under a lock, and declares its functions'
ctypes signatures. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

import torch

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")
    return path


def require_sm90(t: torch.Tensor, kernel: str) -> None:
    """The libraries hold ``sm_90a`` code only: refuse a CPU tensor or
    another card before anything is launched."""
    if t.device.type != "cuda":
        raise ValueError(f"the {kernel} CUDA kernel needs CUDA tensors, got {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"the {kernel} kernel is built for sm_90a; "
            f"{torch.cuda.get_device_name(t.device)} is sm_{cap[0]}{cap[1]}"
        )


class CudaLibrary:
    """One ``csrc/*.cu`` source, built and loaded on first use."""

    def __init__(self, src: Path, declare: Callable[[ctypes.CDLL], None]):
        self.src = Path(src)
        self.build_dir = self.src.parent.parent / "build"
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    @property
    def loaded(self) -> bool:
        return self._lib is not None

    def build(self) -> Path:
        """Compile the source (once per source version) and return the
        library's path."""
        code = self.src.read_bytes()
        digest = hashlib.sha1(code + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
        out = self.build_dir / f"lib{self.src.stem}_{digest}.so"
        if out.exists():
            return out
        self.build_dir.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.src)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib
