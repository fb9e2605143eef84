"""Build the package's CUDA kernels with ``nvcc`` at first use.

Each source under a kernel's ``csrc/`` compiles, on its own, to a shared
library with a plain C interface in ``build/repro_torch/`` at the repository
root, for ``sm_90a`` (Hopper).  The sources include the shared headers of
``kernels/csrc/`` (``-I``).  The library's file name carries a hash of its
source, of every shared header and of the flags, so an edited source or
header rebuilds and an unchanged one is reused.  ``build_all`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import: the CPU tests import every module of the
package on machines without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

_PKG = Path(__file__).resolve().parent
#: build directory at the repository root (listed in .gitignore)
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"

#: every CUDA source of the package, by library name
SOURCES: Dict[str, Path] = {
    "block_spgemm": _PKG / "masked_matmul" / "csrc" / "block_spgemm.cu",
    "block_spgemm_sm90": _PKG / "masked_matmul" / "csrc"
                         / "block_spgemm_sm90.cu",
    "masked_matmul": _PKG / "masked_matmul" / "csrc" / "masked_matmul.cu",
    "masked_matmul_sm90": _PKG / "masked_matmul" / "csrc"
                          / "masked_matmul_sm90.cu",
    "flash_mask": _PKG / "flash_mask" / "csrc" / "flash_mask.cu",
    "flash_mask_sm90": _PKG / "flash_mask" / "csrc" / "flash_mask_sm90.cu",
    "flash_mask_f32_sm90": _PKG / "flash_mask" / "csrc"
                           / "flash_mask_f32_sm90.cu",
}

#: headers every source may include (``mma.cuh``: mma.sync and cp.async
#: primitives; ``sm90.cuh``: TMA, mbarrier, wgmma, setmaxnreg and the
#: tensor maps' encoder)
INCLUDE_DIR = _PKG / "csrc"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-I", str(INCLUDE_DIR))

#: ptxas report (registers, shared memory, spills) of each library built
#: by this process
PTXAS_LOG: Dict[str, str] = {}

_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cuda.exists():
        return str(cuda)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lives once built."""
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(p for p in INCLUDE_DIR.rglob("*") if p.is_file()):
        h.update(str(header.relative_to(INCLUDE_DIR)).encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def _start(name: str):
    out = library_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: Path, out: Path) -> Path:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {SOURCES[name]}:\n{log}")
    os.replace(tmp, out)        # atomic: a concurrent build never sees half
    PTXAS_LOG[name] = log
    return out


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Build every listed source (default: all) that is not built yet, one
    ``nvcc`` per source, all started together.  Returns name -> path."""
    names = list(SOURCES) if names is None else names
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        paths = {name: library_path(name) for name in names}
        todo = [name for name in names if not paths[name].exists()]
        started = {name: _start(name) for name in todo}
        errors = []
        for name, (proc, tmp, out) in started.items():
            try:      # wait for every nvcc before reporting a failure
                _finish(name, proc, tmp, out)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return paths


def build(name: str) -> Path:
    """Path of the built library of source ``name`` (building it first)."""
    return build_all([name])[name]


#: C entry points loaded by this process, by (library name, symbol)
_FUNCTIONS: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def load(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of source ``name``'s library, built and
    loaded at first use, with ``argtypes`` set.  Every entry point of the
    package returns a ``cudaError_t`` as an int."""
    fn = _FUNCTIONS.get((name, symbol))
    if fn is None:
        fn = getattr(ctypes.CDLL(str(build(name))), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCTIONS[(name, symbol)] = fn
    return fn


#: what the ``*_info`` entry points report about one kernel instance
INFO_FIELDS = ("threads", "smem_bytes", "registers", "local_bytes",
               "ctas_per_sm")


def kernel_info(name: str, symbol: str, *args: int) -> Dict[str, int]:
    """Threads per CTA, dynamic shared memory, registers and local (spill)
    bytes per thread, and resident CTAs per SM of the kernel instance that
    the C entry point ``symbol(*args, int info[5])`` of source ``name``
    reports, on the current CUDA device."""
    fn = load(name, symbol, [ctypes.c_int] * len(args) + [ctypes.c_void_p])
    info = (ctypes.c_int * len(INFO_FIELDS))()
    err = fn(*args, ctypes.addressof(info))
    if err != 0:
        raise RuntimeError(f"{symbol}{args} failed: CUDA error {err}")
    return dict(zip(INFO_FIELDS, info))
