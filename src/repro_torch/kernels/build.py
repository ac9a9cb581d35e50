"""Build the port's CUDA kernels with ``nvcc`` and bind them with ctypes.

Each ``csrc/*.cu`` file has a plain C interface and compiles on its own
into a shared library for ``sm_90a`` (Hopper). Libraries go to
``build/repro_torch/`` at the root of the checkout (git-ignored), named
by a digest of the source and the flags, so an edited source rebuilds
and an unchanged one is reused. The first launch of a kernel builds it;
:func:`build` compiles several sources at once, one ``nvcc`` each, all
started together.

Nothing here runs at import time: the CPU tests import every module and
this machine-independent code must not look for a compiler until a
kernel is launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built on the machine with the card")
    return found


def library_path(source: str) -> Path:
    """Where ``csrc/<source>`` builds to: digest of source text + flags."""
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}-{digest[:16]}.so"


def build(sources: Sequence[str]) -> Dict[str, Path]:
    """Compile every source that has no library yet, all in parallel.
    Returns ``{source: library path}``. Raises with the compiler's
    output if any build fails. ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {s: library_path(s) for s in sources}
    procs = []
    for src, lib in paths.items():
        if lib.is_file():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed: List[str] = []
    for src, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_name(lib.name + ".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log.decode(errors='replace')}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)   # atomic: a reader never sees a partial .so
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


class CudaKernel:
    """One C entry point of one ``csrc`` library, loaded at first launch.

    ``launches`` counts successful launches of this kernel and is
    touched nowhere else: a run can show that its main path went through
    the kernel by zeroing it first and reading it after.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._fn = None

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, self.symbol.replace("_launch", "_error_string"))
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn, self._err = lib, fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if it reports a CUDA error."""
        code = self.load()(*args)
        if code != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {code} "
                f"({self._err(code).decode(errors='replace')})")
        self.launches += 1
