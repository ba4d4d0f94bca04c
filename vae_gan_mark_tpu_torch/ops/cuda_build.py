"""Building and loading the port's CUDA kernels.

Each kernel is one ``csrc/*.cu`` file with a plain C interface: its entry
points take device pointers, sizes and a stream, launch on that stream and
return a ``cudaError_t`` (0 on success); one more function maps an error
code to its message.

* ``build_all(sources)`` compiles every source that has no build yet with
  ``nvcc`` for ``sm_90a`` into ``_build/`` (git-ignored), one ``nvcc`` per
  source, all started at once. A build is named by a hash of its source and
  of the headers beside it (``csrc/*.cuh``), so an edited source or header
  is rebuilt. ``-Xptxas -v`` makes the compiler's output
  carry each kernel's registers, shared memory and spills.
* ``CudaKernel`` loads one build with ``ctypes`` at first use, declares its
  functions' signatures, launches them, raises when a launch fails and
  counts the launches that succeeded; ``query`` calls a function that
  launches nothing and returns an int through its last argument.
* One device per process: a source keeps host state in statics that it
  sets once per process (``csrc/gru_fwd.cu:set_smem_once``: the
  shared-memory attribute, which CUDA holds per device; the occupancy
  reading that picks the GRU forward's tile rows). So each kernel object
  serves the first device it is used on (``claim``) and raises for
  another; a data-parallel run has one process per card
  (``parallel/distributed.py``). A source with no such state
  (``csrc/resize_bilinear.cu``) claims no device.
* ``launch_counts()`` / ``add_launches()`` read and move every kernel's
  count at once: a CUDA graph (``train/graphs.py``) records what its
  capture launched and adds that at each replay, since a replay runs no
  Python.

Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

PTR, INT = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the port's kernels need the CUDA "
                       "toolkit")


def library_path(source: Path) -> Path:
    """The build of ``source``, named by a hash of it and of every header
    beside it (``*.cuh``), so that an edited header is rebuilt too."""
    digest = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    return BUILD_DIR / f"lib{source.stem}_{digest.hexdigest()[:16]}.so"


def build_all(sources: Iterable[Path]) -> Dict[Path, Tuple[Path, str]]:
    """Compile each source unless a build of that exact source exists.

    Returns {source: (library path, compiler output)}; the output is empty
    for a source that was not compiled. A source named twice (two kernel
    objects of one library) is compiled once. Raises if any compile fails,
    after every ``nvcc`` started here has ended."""
    results: Dict[Path, Tuple[Path, str]] = {}
    started, failures = [], []
    try:
        for source in dict.fromkeys(sources):
            lib = library_path(source)
            if lib.exists():
                results[source] = (lib, "")
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            started.append((source, lib, tmp, cmd, proc))
        for source, lib, tmp, cmd, proc in started:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"nvcc failed ({proc.returncode}):\n"
                                f"{' '.join(cmd)}\n{out}")
                continue
            os.replace(tmp, lib)
            results[source] = (lib, out)
    finally:
        for *_, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("\n".join(failures))
    return results


_KERNELS: List["CudaKernel"] = []


def launch_counts() -> Dict["CudaKernel", int]:
    """Every kernel object's launch count."""
    return {k: k.launches for k in _KERNELS}


def add_launches(counts: Dict["CudaKernel", int]) -> None:
    """Add ``counts[k]`` to kernel ``k``'s launch count, for each ``k``."""
    for kernel, n in counts.items():
        kernel.launches += n


class CudaKernel:
    """One kernel library: its source under ``csrc/``, the C functions it
    exports with their ``ctypes`` argument types, and a launch count."""

    def __init__(self, source_name: str, functions: Dict[str, List],
                 error_function: str):
        _KERNELS.append(self)
        self.source = CSRC / source_name
        self.functions = functions
        self.error_function = error_function
        self.launches = 0
        self.device_index: Optional[int] = None
        self._lib: Optional[ctypes.CDLL] = None

    def claim(self, device_index: int) -> None:
        """Bind this kernel to CUDA device ``device_index`` at its first
        use; raise for any other device later."""
        if self.device_index is None:
            self.device_index = device_index
        elif device_index != self.device_index:
            raise RuntimeError(
                f"{self.source.name} serves cuda:{self.device_index} in this "
                f"process and was given cuda:{device_index}: its host state "
                "holds for one device, so use one process per card")

    def build(self) -> Tuple[Path, str]:
        return build_all([self.source])[self.source]

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            path, _ = self.build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err_fn = getattr(lib, self.error_function)
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, name: str, *args, what: str = "") -> None:
        """Call the C function ``name``; raise if it reports an error, else
        count one launch."""
        lib = self.load()
        err = getattr(lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: {self._message(err)} "
                               f"({what})")
        self.launches += 1

    def query(self, name: str, *args) -> int:
        """Call the C function ``name`` with ``args`` and a pointer to an
        int as its last argument; raise if it reports an error, else return
        the int. Counts no launch."""
        lib = self.load()
        value = ctypes.c_int(0)
        err = getattr(lib, name)(*args, ctypes.byref(value))
        if err != 0:
            raise RuntimeError(f"{name} failed: {self._message(err)}")
        return value.value

    def _message(self, err: int) -> str:
        return getattr(self.load(), self.error_function)(err).decode()
