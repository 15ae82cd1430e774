"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` into ``lib<name>-<hash>.so`` for ``sm_90a``; the hash covers the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
kernel is rebuilt and a built one is reused.  All missing libraries are compiled together, one ``nvcc`` process
per source, at the first call that needs any of them.  The output goes
under ``kernels/_build/`` beside the sources, which ``.gitignore`` lists.
A failed build raises :class:`BuildError` with the compiler's output;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"

COMMON_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: source stem -> extra nvcc flags.  quantize.cu, select_slots.cu (K6's
#: codes) and qr_pack.cu must not contract ``scaled - lo`` into an FMA (the
#: Q_r rounding compares its bits); rglru_scan.cu keeps the plain
#: version's ``a*h + gx`` and its backward's operation order (K11 and its
#: backward are bit-equal to them).
SOURCES: Dict[str, tuple] = {
    "topk_compress": (),
    "quantize": ("--fmad=false",),
    "select_slots": ("--fmad=false",),
    "qr_pack": ("--fmad=false",),
    "pack_codes": (),
    "rglru_scan": ("--fmad=false",),
    "wkv6": (),
    "wkv6_bwd": (),
    "flash_attention": (),
    "flash_attention_sm90": (),
}

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


class KernelError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def build_dir() -> Path:
    return Path(__file__).resolve().parent / "_build"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found (looked in $CUDA_HOME/bin and PATH)")
    return found


def _flags(name: str) -> tuple:
    return COMMON_FLAGS + SOURCES[name]


def library_path(name: str) -> Path:
    # the headers (csrc/*.cuh) are part of every source's hash
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build_all() -> Dict[str, Path]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: library path}``.  Each compile writes a private
    temporary file and renames it into place, so concurrent builds never
    see a partial library.  The compiler's output (``-Xptxas=-v``: each
    kernel's registers and shared memory) is kept beside the library as
    ``<library>.log``.
    """
    out = build_dir()
    out.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in SOURCES}
    todo = {name: p for name, p in paths.items() if not p.is_file()}
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, path)
    failed = []
    for name, (proc, tmp, path) in procs.items():
        log, _ = proc.communicate()
        text = log.decode(errors="replace")
        path.with_suffix(".so.log").write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, path)
    if failed:
        raise BuildError("nvcc failed:\n" + "\n".join(failed))
    return paths


def cuobjdump_path():
    """``cuobjdump`` beside ``nvcc``, or on ``PATH``; None if neither."""
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "cuobjdump"
    return str(cand) if cand.is_file() else shutil.which("cuobjdump")


#: SASS opcodes of the integer pipes, for counting a kernel's integer
#: operations (the keyed K4's threefry)
INT_OPCODES = ("IADD3", "LOP3", "SHF", "IMAD", "LEA", "ISETP", "SEL", "PRMT",
               "IMNMX", "IABS", "POPC", "FLO", "BMSK", "SGXT", "SHL", "SHR")


def sass_counts(name: str, opcodes, match: tuple = ()) -> Dict[str, int]:
    """How many instructions of each SASS opcode (``HGMMA``, ``UTMALDG``,
    ...) the built library for ``csrc/<name>.cu`` holds, by ``cuobjdump
    -sass``, in the kernels whose (mangled) names hold every string of
    ``match`` (all kernels if it is empty); builds it first if needed.
    Raises :class:`BuildError` when ``cuobjdump`` is missing."""
    tool = cuobjdump_path()
    if tool is None:
        raise BuildError("cuobjdump not found (looked in $CUDA_HOME/bin and "
                         "PATH)")
    sass = subprocess.run([tool, "-sass", str(build_all()[name])],
                          capture_output=True, text=True, check=True).stdout
    ops, keep = [], not match
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :", 1)[1].strip()
            keep = all(m in fn for m in match)
        elif keep and "*/" in ln and ln.lstrip().startswith("/*"):
            w = ln.split("*/", 1)[1].split()
            ops.append(w[1] if w and w[0].startswith("@") and len(w) > 1
                       else (w[0] if w else ""))
    return {op: sum(1 for o in ops if o.split(".")[0] == op)
            for op in opcodes}


def ptxas_log(name: str) -> str:
    """What ``-Xptxas=-v`` logged for ``csrc/<name>.cu`` (registers,
    shared memory, spills per kernel)."""
    return build_all()[name].with_suffix(".so.log").read_text()


def load(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``bind`` declares the library's ``argtypes``/``restype`` once, when it
    is first loaded.
    """
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[name]))
            bind(lib)
            _LIBS[name] = lib
    return lib


def on_cpu(x: torch.Tensor) -> bool:
    """Dispatch by tensor device: True for a CPU tensor (the plain
    version runs), False for a CUDA tensor (the kernel runs); any other
    device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def cuda_rows(x: torch.Tensor) -> torch.Tensor:
    """Validate a CUDA ``(rows, n)`` float32 or bfloat16 input; returns it
    as contiguous float32 (``x`` itself when it already is)."""
    if x.dim() != 2:
        raise ValueError(f"expects (rows, n) input, got shape {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"expects float32 or bfloat16, got {x.dtype}")
    if not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"rows must be in [1, 65535], got {x.shape[0]}")
    if x.dtype == torch.float32 and x.is_contiguous():
        return x
    return x.to(torch.float32).contiguous()


def cuda_codes(t: torch.Tensor) -> torch.Tensor:
    """Validate a CUDA ``(rows, m)`` int32 input (uint32 codes or words in
    int32 containers); returns it contiguous."""
    if t.dim() != 2:
        raise ValueError(f"expects (rows, m) input, got shape {tuple(t.shape)}")
    if t.dtype != torch.int32:
        raise TypeError(f"expects int32 containers, got {t.dtype}")
    if not 1 <= t.shape[0] <= 65535:
        raise ValueError(f"rows must be in [1, 65535], got {t.shape[0]}")
    return t.contiguous()


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> torch.Tensor:
    """Check a kernel operand's dtype, shape and device; returns it
    contiguous."""
    if t.dtype != dtype or t.shape != shape or t.device != device:
        raise ValueError(f"{name} must be a {dtype} {tuple(shape)} tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")
    return t if t.is_contiguous() else t.contiguous()


#: Rows of host key words a keyed kernel takes in its launch parameters
#: (``kKeysByValue`` in ``csrc/threefry.cuh``).
KEYS_BY_VALUE = 32


def key_args(keys: torch.Tensor, rows: int, device: torch.device) -> tuple:
    """``(keys, device pointer, host pointer)`` for a keyed kernel's C
    entry (``threefry_keys`` in ``csrc/threefry.cuh``).  ``keys`` is the
    ``(rows, 2)`` int64 key data holding uint32 words.  Up to
    ``KEYS_BY_VALUE`` rows on the host go by host pointer and travel in the
    launch's parameters, so the call is one device operation; more rows, or
    keys elsewhere, take one copy to ``device``.  The returned tensor must
    outlive the launch."""
    if keys.dtype != torch.int64 or tuple(keys.shape) != (rows, 2):
        raise ValueError(f"keys must be int64 ({rows}, 2) key data, got "
                         f"{keys.dtype} {tuple(keys.shape)}")
    if keys.device.type == "cpu" and rows <= KEYS_BY_VALUE:
        keys = keys.contiguous()
        return keys, None, keys.data_ptr()
    keys = keys.to(device).contiguous()
    return keys, keys.data_ptr(), None


def stream_ptr() -> int:
    """The current device's current CUDA stream, as a raw handle.  (The
    raw getter takes about 0.1 us where ``torch.cuda.current_stream()``,
    which builds a Stream object, takes about 5 us: at K3's main shape that
    is a third of the call.)"""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def check(code: int, what: str, lib: ctypes.CDLL, errfn: str) -> None:
    if code != 0:
        msg = getattr(lib, errfn)(code).decode(errors="replace")
        raise KernelError(f"{what} failed with CUDA error {code}: {msg}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
