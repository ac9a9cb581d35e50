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
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelError(RuntimeError):
    """A kernel of the port could not be built or launched, or reported
    an error word from the card. The serving engine never retries it: a
    round that fails this way leaves ``SlotServeEngine.step`` at once."""


def is_device_error(exc: BaseException) -> bool:
    """Whether ``exc`` comes from the card or the kernel layer rather than
    from the host logic around it: a :class:`KernelError`, or an error
    torch raises for the CUDA runtime (out of memory, a device-side
    assert, a failed launch) — torch reports those as ``RuntimeError``s
    whose text names CUDA, or as its accelerator error type."""
    if isinstance(exc, KernelError):
        return True
    types = tuple(t for t in (getattr(torch.cuda, "OutOfMemoryError", None),
                              getattr(torch.cuda, "CudaError", None),
                              getattr(torch, "AcceleratorError", None))
                  if isinstance(t, type))
    if types and isinstance(exc, types):
        return True
    text = str(exc)
    return isinstance(exc, RuntimeError) and any(
        key in text for key in ("CUDA error", "CUDA out of memory",
                                "CUBLAS_STATUS", "cuDNN error",
                                "device-side assert"))


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then
    ``/usr/local/cuda/bin/nvcc``, then ``nvcc`` on the PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and Path(home, "bin", "nvcc").is_file():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise KernelError("nvcc not found (set CUDA_HOME); the CUDA "
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
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    return paths


class CudaKernel:
    """One C entry point of one ``csrc`` library, loaded at first launch.

    ``launches`` counts successful launches of this kernel and is
    touched nowhere else: a run can show that its main path went through
    the kernel by zeroing it first and reading it after.

    A library may also export ``<name>_plan`` (``plan_argtypes``): one
    whole planning call on a stream — packed inputs copied in from
    pinned host memory, one launch, packed outputs copied back, one
    synchronise. :meth:`plan` calls it and counts its launch.

    Kernels that wait on each other (the lock, the barrier's master)
    carry a poll budget and report its expiry in an error word on the
    device. :meth:`check_word` reads it after a launch and raises;
    a timing loop, which must not synchronise inside its timed window,
    passes ``check=False`` and calls :meth:`check_pending` after it.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 plan_argtypes: Optional[Sequence] = None):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.plan_argtypes = plan_argtypes
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None
        self._fn = None
        self._plan = None
        self._pending: list = []

    def _entry(self, lib, suffix: str, argtypes, restype=ctypes.c_int):
        fn = getattr(lib, self.symbol.replace("_launch", suffix))
        fn.argtypes = list(argtypes)
        fn.restype = restype
        return fn

    def load(self):
        if self._fn is None:
            lib = ctypes.CDLL(str(build([self.source])[self.source]))
            self._err = self._entry(lib, "_error_string", [ctypes.c_int],
                                    ctypes.c_char_p)
            if self.plan_argtypes is not None:
                self._plan = self._entry(lib, "_plan", self.plan_argtypes)
            self._lib = lib
            self._fn = self._entry(lib, "_launch", self.argtypes)
        return self._fn

    def _call(self, fn, name: str, args) -> None:
        code = fn(*args)
        if code != 0:
            raise KernelError(
                f"{name}: CUDA error {code} "
                f"({self._err(code).decode(errors='replace')})")
        self.launches += 1

    def launch(self, *args) -> None:
        """Call the C entry point; raise if it reports a CUDA error."""
        self._call(self.load(), self.symbol, args)

    def plan(self, *args) -> None:
        """Call the ``<name>_plan`` entry (see the class docstring);
        raise if it reports a CUDA error."""
        self.load()
        self._call(self._plan, self.symbol.replace("_launch", "_plan"),
                   args)

    def check_word(self, word, what: str, check: bool = True) -> None:
        """Raise if the device error word ``word`` (a one-element tensor)
        is set; with ``check=False`` keep it for :meth:`check_pending`."""
        self._pending.append((word, what))
        if check:
            self.check_pending()

    def check_pending(self) -> None:
        """Read every error word kept since the last check; raise on the
        first that is set."""
        pending, self._pending = self._pending, []
        for word, what in pending:
            if int(word.item()) != 0:
                raise KernelError(f"{self.symbol}: {what}")


class PlanStaging:
    """The reused buffers of one planning window on one CUDA device, for
    a kernel's ``<name>_plan`` entry: packed int32 inputs in pinned host
    memory and on the card, packed int32 outputs on the card and in
    pinned host memory. Float values go in and out as their bits."""

    def __init__(self, device, n_in: int, n_out: int):
        self.index = (device.index if device.index is not None
                      else torch.cuda.current_device())
        dev, i32 = torch.device("cuda", self.index), torch.int32
        self._tensors = (torch.empty(n_in, dtype=i32, pin_memory=True),
                         torch.empty(n_in, dtype=i32, device=dev),
                         torch.empty(n_out, dtype=i32, device=dev),
                         torch.empty(n_out, dtype=i32, pin_memory=True))
        self._host_in = self._tensors[0].numpy()
        self._host_out = self._tensors[3].numpy()
        self._ptrs = [t.data_ptr() for t in self._tensors]
        self._lock = threading.Lock()

    def run(self, kernel: CudaKernel, parts, *scalars):
        """One whole plan through ``kernel.plan`` on the device's current
        stream: ``parts`` (int32 or float32 arrays) packed end to end
        into the pinned input, copy in, launch, copy out, synchronise.
        Returns a copy of the packed int32 output. The buffers are held
        for the whole call, so several threads may plan at once."""
        with self._lock:
            at = 0
            for part in parts:
                part = np.asarray(part)
                self._host_in[at:at + part.shape[0]] = part.view(np.int32)
                at += part.shape[0]
            with torch.cuda.device(self.index):
                kernel.plan(*self._ptrs, *scalars,
                            torch.cuda.current_stream(self.index).cuda_stream)
            return self._host_out.copy()
