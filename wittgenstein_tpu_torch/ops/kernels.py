"""Build and bind the hand-written CUDA kernels (ops/csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface and loaded with ctypes: seconds per build, against
minutes for an extension that includes PyTorch's headers.  The build runs
at first use, from the sources in this checkout, into `ops/_build/` (git
ignores it); the library name carries a digest of the source, so an edited
kernel is rebuilt and never served stale.  `build_all()` starts one nvcc per
source together and waits for all of them.

Every wrapper checks device, dtype, shape and contiguity, launches on
PyTorch's current stream, raises if the C side reports a CUDA error, and
adds one to its kernel's `launches` count — the count a run reads to show
that it went through the kernel.  A failed build, a failed launch or a
missing GPU raises; nothing here falls back to the plain versions in
ops/bitops.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def nvcc_path() -> str:
    """nvcc from CUDA_HOME, then PATH, then the toolkit's default prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaKernel:
    """One kernel: its source, its C entry point, its build and its count."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.symbol = f"witt_{name}"
        self.replaces = replaces
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def lib_path(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:16]
        return BUILD_DIR / f"lib{self.name}_{digest}.so"

    def start_build(self):
        """Start nvcc for this kernel unless its library is already built;
        returns (Popen, tmp_path, lib_path) or None."""
        lib = self.lib_path()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [
            nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp, str(self.source),
        ]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp, lib

    def finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp, lib = started
        out, _ = proc.communicate()
        self.build_log = out
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, lib)

    def fn(self):
        """The bound C function, building the library first if needed."""
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.lib_path()))
            f = getattr(lib, self.symbol)
            f.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                ctypes.c_int, ctypes.c_void_p,
            ]
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn


POPCOUNT = CudaKernel(
    "popcount_words",
    "popcount_words.cu",
    "wittgenstein_tpu/ops/bitops_pallas.py:80 popcount_words_pallas",
)
LOWEST_SET_BIT = CudaKernel(
    "lowest_set_bit",
    "lowest_set_bit.cu",
    "wittgenstein_tpu/ops/bitops_pallas.py:162 lowest_set_bit_pallas",
)
PACK_BOOL_WORDS = CudaKernel(
    "pack_bool_words",
    "pack_bool_words.cu",
    "wittgenstein_tpu/ops/bitops_pallas.py:110 pack_bool_words_pallas",
)
KERNELS = (POPCOUNT, LOWEST_SET_BIT, PACK_BOOL_WORDS)


def build_all() -> None:
    """Build every kernel's library, one nvcc per source, all at once."""
    started = [(k, k.start_build()) for k in KERNELS]
    errors = []
    for k, s in started:
        try:
            k.finish_build(s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS:
        k.fn()


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def _check_operand(kernel: CudaKernel, x: torch.Tensor, dtype: torch.dtype) -> None:
    """Device, dtype and shape checks shared by every wrapper."""
    if not x.is_cuda:
        raise RuntimeError(f"{kernel.name}: tensor is on {x.device}, not CUDA")
    if x.dtype != dtype:
        raise TypeError(f"{kernel.name}: operand must be {dtype}, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1:
        raise ValueError(f"{kernel.name}: need a non-empty last axis, got {tuple(x.shape)}")
    if x.device.index != torch.cuda.current_device():
        raise RuntimeError(
            f"{kernel.name}: tensor on {x.device}, current device is "
            f"cuda:{torch.cuda.current_device()}"
        )
    if x.shape[-1] > 2**31 - 1:
        raise ValueError(f"{kernel.name}: last axis {x.shape[-1]} too wide")


def _launch(kernel: CudaKernel, x: torch.Tensor, out: torch.Tensor, m: int) -> torch.Tensor:
    """Launch `kernel` over the m rows of x into out on the current stream."""
    if m == 0:
        return out
    # broadcast or strided operands become dense rows before the launch
    x = x.contiguous()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = kernel.fn()(x.data_ptr(), out.data_ptr(), m, x.shape[-1], stream)
    if err != 0:
        raise RuntimeError(f"{kernel.name}: CUDA launch failed with error {err}")
    kernel.launches += 1
    return out


def _launch_rows(kernel: CudaKernel, words: torch.Tensor) -> torch.Tensor:
    """Run a row kernel ([..., w] int32 words -> [...] int32) on the card."""
    _check_operand(kernel, words, torch.int32)
    out = torch.empty(words.shape[:-1], dtype=torch.int32, device=words.device)
    return _launch(kernel, words, out, out.numel())


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: total set bits of each row of [..., w] int32 words."""
    return _launch_rows(POPCOUNT, words)


def lowest_set_bit(words: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: lowest set bit of each row of [..., w] int32 words."""
    return _launch_rows(LOWEST_SET_BIT, words)


def pack_bool_words(bits: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: [..., W] bool -> [..., ceil(W/32)] int32 words (torch
    bool is one byte, which the kernel reads as uint8)."""
    _check_operand(PACK_BOOL_WORDS, bits, torch.bool)
    lead, w = bits.shape[:-1], bits.shape[-1]
    out = torch.empty(lead + ((w + 31) // 32,), dtype=torch.int32, device=bits.device)
    return _launch(PACK_BOOL_WORDS, bits, out, out.numel() // out.shape[-1])
