"""GRU recurrence: the hand-written Hopper kernel, its build, and its plain
PyTorch version.

``gru_recurrence(x_proj, w_hh, b_hh, reverse)`` maps time-major input
projections (L, B, 3H) = x @ W_ih^T + b_ih to every hidden state (L, B, H),
from h0 = 0, with torch's gate order (r, z, n) and ``b_hn`` inside
``r * (...)``. It is the port of the JAX package's Pallas kernel
(``ops/pallas/gru.py:pallas_gru_layer``); ``reverse`` runs right to left and
returns outputs in input order.

* A tensor on the CPU goes to ``gru_recurrence_plain``, a Python loop over t.
* A CUDA tensor goes to the kernel in ``csrc/gru_fwd.cu`` or raises. The
  kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
  ``_build/`` (rebuilt when the source's hash changes) and loaded with
  ``ctypes``. Each launch adds one to ``KERNEL.launches``.

Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "gru_fwd.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: the GRU kernel needs the CUDA toolkit")


def build() -> tuple[Path, str]:
    """Compile ``csrc/gru_fwd.cu`` unless a build of this exact source
    exists. Returns the library's path and the compiler's output (empty
    when nothing was compiled)."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libgru_fwd_{digest}.so"
    if lib.exists():
        return lib, ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib, proc.stdout + proc.stderr


class CudaGRU:
    """The loaded kernel library and its launch count."""

    def __init__(self):
        self.launches = 0
        self._lib: Optional[ctypes.CDLL] = None

    def load(self) -> ctypes.CDLL:
        if self._lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            lib.gru_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]
            lib.gru_forward.restype = ctypes.c_int
            lib.gru_error_string.argtypes = [ctypes.c_int]
            lib.gru_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def __call__(self, x_proj: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor, reverse: bool) -> torch.Tensor:
        if x_proj.device.type != "cuda":
            raise ValueError(f"the GRU kernel takes CUDA tensors, got "
                             f"{x_proj.device}")
        length, batch, h3 = x_proj.shape
        hidden = h3 // 3
        lib = self.load()
        out = torch.empty((length, batch, hidden), dtype=torch.float32,
                          device=x_proj.device)
        with torch.cuda.device(x_proj.device):
            stream = torch.cuda.current_stream(x_proj.device).cuda_stream
            err = lib.gru_forward(x_proj.data_ptr(), w_hh.data_ptr(),
                                  b_hh.data_ptr(), out.data_ptr(), length,
                                  batch, hidden, int(reverse), stream)
        if err != 0:
            msg = lib.gru_error_string(err).decode()
            raise RuntimeError(f"gru_forward launch failed: {msg} (L={length}"
                               f", B={batch}, H={hidden})")
        self.launches += 1
        return out


KERNEL = CudaGRU()


def _check(x_proj: torch.Tensor, w_hh: torch.Tensor,
           b_hh: torch.Tensor) -> None:
    if x_proj.dim() != 3 or x_proj.shape[2] % 3:
        raise ValueError(f"x_proj must be (L, B, 3H), got {tuple(x_proj.shape)}")
    hidden = x_proj.shape[2] // 3
    if tuple(w_hh.shape) != (3 * hidden, hidden) or \
            tuple(b_hh.shape) != (3 * hidden,):
        raise ValueError(f"w_hh must be (3H, H) and b_hh (3H,) for H={hidden}"
                         f", got {tuple(w_hh.shape)} and {tuple(b_hh.shape)}")
    for name, t in (("x_proj", x_proj), ("w_hh", w_hh), ("b_hh", b_hh)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != x_proj.device:
            raise ValueError(f"{name} is on {t.device}, x_proj on "
                             f"{x_proj.device}")


def gru_recurrence(x_proj: torch.Tensor, w_hh: torch.Tensor,
                   b_hh: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """(L, B, 3H) input projections -> (L, B, H) hidden states, float32.

    ``w_hh`` is torch's ``weight_hh`` (3H, H), ``b_hh`` is (3H,)."""
    _check(x_proj, w_hh, b_hh)
    if x_proj.device.type == "cpu":
        return gru_recurrence_plain(x_proj, w_hh, b_hh, reverse)
    if x_proj.device.type != "cuda":
        raise RuntimeError(f"no GRU kernel for device {x_proj.device}")
    return KERNEL(x_proj.contiguous(), w_hh.contiguous(), b_hh.contiguous(),
                  reverse)


def gru_recurrence_plain(x_proj: torch.Tensor, w_hh: torch.Tensor,
                         b_hh: torch.Tensor,
                         reverse: bool = False) -> torch.Tensor:
    """The kernel's function as a Python loop over t (the JAX scan path's
    gate math, ``ops/rnn.py:GRULayer``)."""
    length, batch, h3 = x_proj.shape
    hidden = h3 // 3
    h = x_proj.new_zeros((batch, hidden))
    out = x_proj.new_empty((length, batch, hidden))
    for t in (range(length - 1, -1, -1) if reverse else range(length)):
        hp = torch.matmul(h, w_hh.t()) + b_hh
        xr, xz, xn = x_proj[t].split(hidden, dim=1)
        hr, hz, hn = hp.split(hidden, dim=1)
        r = torch.sigmoid(xr + hr)
        z = torch.sigmoid(xz + hz)
        n = torch.tanh(xn + r * hn)
        h = (1.0 - z) * n + z * h
        out[t] = h
    return out
