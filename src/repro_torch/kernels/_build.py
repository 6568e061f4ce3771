"""Build and load the port's CUDA kernels (``csrc/*.cu``) with ``nvcc``.

Each source is compiled to an object by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with a
plain C interface, loaded through ``ctypes``.  The library lands in the
build directory, by default the repository's git-ignored ``build/kernels/``
(``set_build_dir`` moves it: a server's persistent cache directory, so a
restarted server loads the built library instead of running ``nvcc``),
under a name derived from the sources' content hash, so an edited source is
never served a stale build.  Nothing here runs at import time: the first
kernel launch builds.
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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C entry points and their argument types (every pointer and the stream as
# c_void_p, so ctypes never truncates them to 32 bits)
SIGNATURES = {
    "repro_peel_round": [_P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         _I, _P],
    "repro_segment_sum_i32": [_P, _P, _LL, _I, _I, _P, _P],
    "repro_segment_sum_f32": [_P, _P, _LL, _I, _I, _P, _P],
    "repro_tricount": [_P, _LL, _I, _P, _P, _P, _P, _P],
    "repro_flash_attention": [_P, _P, _P, _P] + [_I] * 8 + [_LL] * 12 + [_P],
}


def set_build_dir(path) -> Path:
    """Build into, and load from, ``path`` from now on.  A library this
    process has already loaded stays loaded; the directory applies to the
    next build or load (a fresh process)."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    return BUILD_DIR


def sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (PATH or /usr/local/cuda/bin)")


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"librepro_kernels-{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` (one nvcc each, in parallel) and link."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
            objs.append(str(obj))
        failed = []
        for src, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
            elif verbose:
                print(f"[nvcc {src.name}]\n{log.strip()}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o",
                               str(tmp_lib)], capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}"
                               f"{link.stderr}")
        os.replace(tmp_lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use, then cached)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise when a C entry point reports a CUDA error (launch refused...)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA error {status} at launch")
