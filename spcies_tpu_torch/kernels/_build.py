"""Build and bind the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` is compiled by `nvcc` for sm_90a into a shared
library with a plain C interface and loaded with ctypes. The build runs at
the first launch, never at import, into `spcies_tpu_torch/_build/` (listed
in .gitignore), and is cached there by a hash of the source, of every
header under csrc/ it includes (csrc/tile_product.cuh) and of the flags: a
changed source or header builds anew, an unchanged one loads the library
built before.

A source that holds a wide build (K2-K7: its text names WIDE_PART) is
compiled as two translation units, -DWIDE_PART=0 (the narrow builds: the
source as it was before its wide build) and -DWIDE_PART=1 (the wide build
alone), by two nvcc at once, and the two objects are linked into the one
library: the narrow builds are compiled from exactly the text they had, so
the compiler cannot place their code otherwise for the wide build's sake.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
# where `<name>.cu` is read from; a timing script may point it elsewhere
CSRC = _PKG / "csrc"
# where a header is looked for when it is not beside its source
INCLUDE = _PKG / "csrc"
_INCLUDE_RE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC",
              # no contraction of separate multiply and add: the
              # element-wise arithmetic then rounds as PyTorch's does
              "-fmad=false", "-Xptxas", "-v")

# name -> (ctypes.CDLL, build record); one entry per loaded library
_LOADED: dict[str, tuple[ctypes.CDLL, dict]] = {}


def _nvcc() -> str:
    # PyTorch's own search: $CUDA_HOME, $CUDA_PATH, nvcc on PATH, the
    # toolkit's default install directory
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else ""
    if not os.path.isfile(nvcc):
        nvcc = shutil.which("nvcc") or ""
    if not nvcc:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels are built from csrc/ at their first "
                           "launch")
    return nvcc


def included_files(path: Path) -> list[Path]:
    """`path` and every file it includes with quotes, directly or through
    another, each looked for beside the including file and then under
    INCLUDE; in the order met."""
    found: list[Path] = []
    todo = [path]
    while todo:
        f = todo.pop()
        if f in found:
            continue
        found.append(f)
        for inc in _INCLUDE_RE.findall(f.read_text()):
            for d in (f.parent, INCLUDE):
                if (d / inc).is_file():
                    todo.append((d / inc).resolve())
                    break
            else:
                raise FileNotFoundError(f"{f} includes {inc!r}, which is "
                                        f"neither beside it nor in {INCLUDE}")
    return found


def source_digest(name: str, csrc: Path | None = None) -> str:
    """Hash of a kernel's source (in `csrc`, CSRC when left out), the
    headers it includes and the build flags."""
    h = hashlib.sha256()
    for f in included_files(((csrc or CSRC) / f"{name}.cu").resolve()):
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(name: str, csrc: Path | None = None) -> tuple[Path, dict]:
    """Compile <name>.cu of `csrc` (CSRC when left out) unless a library of
    the same digest exists. Returns the library's path and a record of the
    build (seconds, the compiler's resource report)."""
    csrc = csrc or CSRC
    lib = BUILD_DIR / f"lib{name}-{source_digest(name, csrc)}.so"
    if lib.exists():
        return lib, dict(seconds=0.0, cached=True, log="")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}.so")
    src = csrc / f"{name}.cu"
    inc = ["-I", str(csrc), "-I", str(INCLUDE)]
    t0 = time.perf_counter()
    if "WIDE_PART" not in src.read_text():
        procs = [_run([_nvcc(), *NVCC_FLAGS, *inc, "-o", str(tmp), str(src)],
                      name)]
    else:
        # the narrow and the wide translation units at once, then one link
        objs = [tmp.with_suffix(f".part{part}.o") for part in (0, 1)]
        compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
        cmds = [[_nvcc(), *compile_flags, "-c", f"-DWIDE_PART={part}", *inc,
                 "-o", str(obj), str(src)] for part, obj in enumerate(objs)]
        with ThreadPoolExecutor(len(cmds)) as pool:
            procs = list(pool.map(lambda cmd: _run(cmd, name), cmds))
        procs.append(_run([_nvcc(), "-shared", "-o", str(tmp),
                           *map(str, objs)], name))
        for obj in objs:
            obj.unlink()
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    return lib, dict(seconds=seconds, cached=False,
                     log="\n".join((p.stdout + p.stderr).strip()
                                   for p in procs))


def _run(cmd: list[str], name: str) -> subprocess.CompletedProcess:
    """Run one nvcc command; raise with its errors if it fails."""
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {name}:\n{proc.stderr}")
    return proc


def load_kernel(name: str, symbol: str, argtypes):
    """The C entry point `symbol` of csrc/<name>.cu, built on first use,
    with its argument types set; it returns a cudaError_t as int."""
    if name not in _LOADED:
        path, record = build(name)
        _LOADED[name] = (ctypes.CDLL(str(path)), record)
    fn = getattr(_LOADED[name][0], symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def build_record(name: str) -> dict | None:
    """The build record of a loaded library (None before its first use)."""
    return _LOADED[name][1] if name in _LOADED else None
