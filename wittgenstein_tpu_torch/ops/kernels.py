"""Build and bind the hand-written CUDA kernels (ops/csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with a
plain C interface and loaded with ctypes: seconds per build, against
minutes for an extension that includes PyTorch's headers.  The build runs
at first use, from the sources in this checkout, into `ops/_build/` (git
ignores it); the library name carries a digest of the source and the
shared headers, so an edited kernel is rebuilt and never served stale.
`build_all()` starts one nvcc per source together and waits for all of
them.  A library holds one or more entry points (`CudaKernel`), each a form
of the source's kernel with its own wrapper and its own `launches` count.

Every wrapper checks device, dtype and shape, launches on PyTorch's
current stream, raises if the C side reports a CUDA error, and adds one to
its kernel's `launches` count — the count a run reads to show that it
went through the kernel.  The one-operand forms take dense rows (a
broadcast or strided operand is made contiguous first); the two-operand
forms read broadcast and sliced operands in place through a row map of
strides.  A failed build, a failed launch or a missing GPU raises;
nothing here falls back to the plain versions in ops/bitops.py.
"""

from __future__ import annotations

import ctypes
import functools
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


_NVCC_VERSION = []  # the `nvcc --version` text, read once per process


def nvcc_version() -> str:
    """`nvcc --version`'s output, read at the first build or load that
    needs it and kept for the process."""
    if not _NVCC_VERSION:
        _NVCC_VERSION.append(subprocess.run(
            [nvcc_path(), "--version"], capture_output=True, text=True, check=True
        ).stdout)
    return _NVCC_VERSION[0]


class CudaLibrary:
    """One source file built into one shared library."""

    def __init__(self, source: str):
        self.source = CSRC / source
        self.build_log = ""
        self.builds = 0  # nvcc runs this process finished for this library
        self.loads = 0  # times this process loaded it
        self._lib = None

    def lib_path(self) -> Path:
        # the digest covers the shared headers too, so editing one
        # rebuilds every library that includes it, and the flags and the
        # toolkit, so a library is never loaded for another target or
        # from another compiler
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(repr(tuple(ARCH_FLAGS)).encode())
        h.update(nvcc_version().encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:16]}.so"

    def start_build(self):
        """Start nvcc for this library unless it is already built;
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
        self.builds += 1

    def lib(self):
        """The loaded library, building it first if needed."""
        if self._lib is None:
            self.finish_build(self.start_build())
            self._lib = ctypes.CDLL(str(self.lib_path()))
            self.loads += 1
        return self._lib


class CudaKernel:
    """One C entry point of a library, with its own launch count."""

    def __init__(self, name: str, library: CudaLibrary, argtypes, replaces: str):
        self.name = name
        self.library = library
        self.symbol = f"witt_{name}"
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def source(self) -> Path:
        return self.library.source

    def fn(self):
        """The bound C function, building the library first if needed."""
        if self._fn is None:
            f = getattr(self.library.lib(), self.symbol)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def call(self, *args) -> None:
        """Launch on PyTorch's current stream; raise on a CUDA error."""
        stream = torch.cuda.current_stream().cuda_stream
        err = self.fn()(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.name}: CUDA launch failed with error {err}")
        self.launches += 1


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
POPCOUNT_LIB = CudaLibrary("popcount_words.cu")
LOWEST_LIB = CudaLibrary("lowest_set_bit.cu")
PACK_LIB = CudaLibrary("pack_bool_words.cu")
LIBRARIES = (POPCOUNT_LIB, LOWEST_LIB, PACK_LIB)
_POPCOUNT_TPU = "wittgenstein_tpu/ops/bitops_pallas.py:80 popcount_words_pallas"
_LOWEST_TPU = "wittgenstein_tpu/ops/bitops_pallas.py:162 lowest_set_bit_pallas"
_PACK_TPU = "wittgenstein_tpu/ops/bitops_pallas.py:110 pack_bool_words_pallas"

# (words, out, m, w, stream)
POPCOUNT = CudaKernel("popcount_words", POPCOUNT_LIB, [_P, _P, _L, _I, _P], _POPCOUNT_TPU)
# (a, b, out, row map, w, op, stream)
POPCOUNT_BINOP = CudaKernel(
    "popcount_binop", POPCOUNT_LIB, [_P, _P, _P, _P, _I, _I, _P], _POPCOUNT_TPU
)
# (sig, inc, ind, agg, s, card, wind, aggi, m, k, w, stream)
CAND_SCORE = CudaKernel(
    "cand_score", POPCOUNT_LIB, [_P] * 8 + [_L, _I, _I, _P], _POPCOUNT_TPU
)
# (words, out, m, w, stream)
LOWEST_SET_BIT = CudaKernel("lowest_set_bit", LOWEST_LIB, [_P, _P, _L, _I, _P], _LOWEST_TPU)
# (a, b, has, lowest, row map, w, stream)
LOWEST_SET_BIT_ANDNOT = CudaKernel(
    "lowest_set_bit_andnot", LOWEST_LIB, [_P, _P, _P, _P, _P, _I, _P], _LOWEST_TPU
)
# (bits, out, m, w, stream)
PACK_BOOL_WORDS = CudaKernel("pack_bool_words", PACK_LIB, [_P, _P, _L, _I, _P], _PACK_TPU)
# (fill, out, m, w, shift, stream)
PACK_OCCUPIED = CudaKernel("pack_occupied", PACK_LIB, [_P, _P, _L, _I, _I, _P], _PACK_TPU)
KERNELS = (POPCOUNT, POPCOUNT_BINOP, CAND_SCORE, LOWEST_SET_BIT, LOWEST_SET_BIT_ANDNOT,
           PACK_BOOL_WORDS, PACK_OCCUPIED)


def build_all() -> None:
    """Build every library, one nvcc per source, all at once."""
    started = [(lib, lib.start_build()) for lib in LIBRARIES]
    errors = []
    for lib, st in started:
        try:
            lib.finish_build(st)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    for k in KERNELS:
        k.fn()


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


MAX_RANK = 6  # kMaxRank in csrc/rows.cuh
MAX_ROWS = 2**31 - 1  # rows are indexed in 32 bits on the card
OPS = {"and": 1, "or": 2, "andnot": 3}  # OP_AND, OP_OR, OP_ANDNOT in rows.cuh


def row_map(lead, *strides) -> list:
    """The packed row map of rows.cuh for operands over the broadcast
    leading shape `lead`, given each operand's row strides in words (0
    where it broadcasts): [m, rank, shape[6], sa[6], sb[6]].  Dims of size
    1 are dropped, and adjacent dims merge wherever every operand steps
    through the pair as through one dim; a single dim left is rank 0."""
    dims = []
    for i, n in enumerate(lead):
        if n == 1:
            continue
        st = tuple(s[i] for s in strides)
        if dims and all(outer == inner * n for outer, inner in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > MAX_RANK:
        raise ValueError(f"row map: {len(dims)} leading dims after merging, at most {MAX_RANK}")
    pad = [0] * (MAX_RANK - len(dims))
    cols = [[st[j] if j < len(st) else 0 for _, st in dims] + pad for j in range(2)]
    m = 1
    for n in lead:
        m *= n
    # one dim left: rank 0, row r at r * stride with no division
    rank = len(dims) if len(dims) > 1 else 0
    return [m, rank, *([n for n, _ in dims] + [1] * len(pad)), *cols[0], *cols[1]]


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


def _check_rows(kernel: CudaKernel, m: int) -> None:
    if m > MAX_ROWS:
        raise ValueError(f"{kernel.name}: {m} rows, at most {MAX_ROWS}")


def _launch(
    kernel: CudaKernel, x: torch.Tensor, out: torch.Tensor, m: int, *extra
) -> torch.Tensor:
    """Launch a one-operand `kernel` over the m rows of x into out; `extra`
    follows the row width in the C call."""
    _check_rows(kernel, m)
    if m == 0:
        return out
    # broadcast or strided operands of the one-operand forms become dense
    # rows before the launch
    x = x.contiguous()
    kernel.call(x.data_ptr(), out.data_ptr(), m, x.shape[-1], *extra)
    return out


def _launch_rows(kernel: CudaKernel, words: torch.Tensor) -> torch.Tensor:
    """Run a row kernel ([..., w] int32 words -> [...] int32) on the card."""
    _check_operand(kernel, words, torch.int32)
    out = torch.empty(words.shape[:-1], dtype=torch.int32, device=words.device)
    return _launch(kernel, words, out, out.numel())


def _rows_of(kernel: CudaKernel, x: torch.Tensor, lead, w: int) -> torch.Tensor:
    """x viewed over lead + (w,) without a copy (stride 0 where it
    broadcasts); only a word axis that is not contiguous is copied."""
    _check_operand(kernel, x, torch.int32)
    if x.shape[-1] != w:
        raise ValueError(f"{kernel.name}: rows of {x.shape[-1]} and {w} words")
    x = x.expand(tuple(lead) + (w,))
    return x if w == 1 or x.stride(-1) == 1 else x.contiguous()


def _broadcast(s1, s2) -> tuple:
    """torch's broadcast of two shapes (torch.broadcast_shapes costs tens
    of µs a call on the host, which the per-tick launch loop pays)."""
    n = max(len(s1), len(s2))
    out = []
    for x, y in zip((1,) * (n - len(s1)) + tuple(s1), (1,) * (n - len(s2)) + tuple(s2)):
        if x != y and 1 not in (x, y):
            raise ValueError(f"shapes {tuple(s1)} and {tuple(s2)} do not broadcast")
        out.append(y if x == 1 else x)
    return tuple(out)


@functools.lru_cache(maxsize=1024)
def _packed_map(lead: tuple, sa: tuple, sb: tuple):
    """row_map as the ctypes int64 array the C side reads; a tick asks for
    the same few maps every time, so they are built once."""
    packed = row_map(lead, sa, sb)
    return packed[0], (ctypes.c_longlong * len(packed))(*packed)


def _pair(kernel: CudaKernel, a: torch.Tensor, b: torch.Tensor):
    """Two word operands over their broadcast leading shape: (a, b, lead,
    w, packed row map)."""
    lead = _broadcast(a.shape[:-1], b.shape[:-1])
    w = a.shape[-1]
    a, b = _rows_of(kernel, a, lead, w), _rows_of(kernel, b, lead, w)
    m, packed = _packed_map(lead, a.stride()[:-1], b.stride()[:-1])
    _check_rows(kernel, m)
    return a, b, lead, w, packed


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: total set bits of each row of [..., w] int32 words."""
    return _launch_rows(POPCOUNT, words)


def popcount_binop(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """CUDA kernel: popcount_words(a op b) for op in OPS ("andnot" is
    a & ~b) without forming a op b; a and b broadcast over their leading
    axes and are read in place."""
    if op not in OPS:
        raise ValueError(f"popcount_binop: op {op!r} not in {sorted(OPS)}")
    a, b, lead, w, packed = _pair(POPCOUNT_BINOP, a, b)
    out = torch.empty(lead, dtype=torch.int32, device=a.device)
    if out.numel():
        POPCOUNT_BINOP.call(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), ctypes.addressof(packed), w, OPS[op]
        )
    return out


def cand_score(sig, inc, ind, agg=None):
    """CUDA kernel: Handel's candidate score in one pass.  sig [..., K, w]
    candidate rows; inc, ind, agg [..., w] node rows that broadcast over
    K.  Returns [..., K] int32 (s, card, wind, aggi) as
    bitops.cand_score_plain defines them; aggi is None without agg."""
    _check_operand(CAND_SCORE, sig, torch.int32)
    if sig.dim() < 2:
        raise ValueError(f"cand_score: sig needs [..., K, w], got {tuple(sig.shape)}")
    lead, k, w = sig.shape[:-2], sig.shape[-2], sig.shape[-1]
    sig = sig.contiguous()
    nodes = [
        None if x is None else _rows_of(CAND_SCORE, x, lead, w).contiguous()
        for x in (inc, ind, agg)
    ]
    outs = [torch.empty(lead + (k,), dtype=torch.int32, device=sig.device) for _ in range(4)]
    if agg is None:
        outs[3] = None
    m = outs[0].numel() // k if k else 0
    _check_rows(CAND_SCORE, m * k)
    if m and k:
        CAND_SCORE.call(
            sig.data_ptr(), *(None if x is None else x.data_ptr() for x in nodes),
            *(None if o is None else o.data_ptr() for o in outs), m, k, w,
        )
    return tuple(outs)


def lowest_set_bit(words: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: lowest set bit of each row of [..., w] int32 words."""
    return _launch_rows(LOWEST_SET_BIT, words)


def lowest_set_bit_andnot(a: torch.Tensor, b: torch.Tensor):
    """CUDA kernel: (has, lowest) of each row of a & ~b without forming
    it — has [...] bool, lowest [...] int32 (32 for an empty row); a and b
    broadcast over their leading axes and are read in place."""
    a, b, lead, w, packed = _pair(LOWEST_SET_BIT_ANDNOT, a, b)
    has = torch.empty(lead, dtype=torch.bool, device=a.device)
    low = torch.empty(lead, dtype=torch.int32, device=a.device)
    if low.numel():
        LOWEST_SET_BIT_ANDNOT.call(
            a.data_ptr(), b.data_ptr(), has.data_ptr(), low.data_ptr(),
            ctypes.addressof(packed), w,
        )
    return has, low


def _packed_out(x: torch.Tensor) -> torch.Tensor:
    """The [..., ceil(W/32)] int32 words of a [..., W] operand."""
    return torch.empty(x.shape[:-1] + ((x.shape[-1] + 31) // 32,), dtype=torch.int32,
                       device=x.device)


def pack_bool_words(bits: torch.Tensor) -> torch.Tensor:
    """CUDA kernel: [..., W] bool -> [..., ceil(W/32)] int32 words (torch
    bool is one byte, which the kernel reads as uint8)."""
    _check_operand(PACK_BOOL_WORDS, bits, torch.bool)
    out = _packed_out(bits)
    return _launch(PACK_BOOL_WORDS, bits, out, out.numel() // out.shape[-1])


def pack_occupied(fill: torch.Tensor, shift: int) -> torch.Tensor:
    """CUDA kernel: pack_bool_words(roll(fill > 0, -shift, -1)) of an int32
    [..., W] fill in one pass, without the bool or rolled copies; shift
    is a host int, taken mod W."""
    _check_operand(PACK_OCCUPIED, fill, torch.int32)
    out = _packed_out(fill)
    return _launch(PACK_OCCUPIED, fill, out, out.numel() // out.shape[-1],
                   int(shift) % fill.shape[-1])
