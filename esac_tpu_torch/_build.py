"""Build the CUDA kernels at first use and load them with ``ctypes``.

Each ``csrc/*.cu`` compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface (no PyTorch headers,
so a build takes seconds).  Libraries land in ``esac_tpu_torch/build/``
(listed in ``.gitignore``), named by a hash of their source and flags, so a
changed source rebuilds and an unchanged one loads from the previous build.
All sources compile in parallel, one ``nvcc`` each.  Nothing runs at
import: the CPU tests import every module of the package.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (pathlib.Path(cand) / "bin" / "nvcc").exists():
            return str(pathlib.Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                           "with the CUDA toolkit")
    return found


def _target(src: pathlib.Path) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` not built yet, all ``nvcc`` processes
    started together.  Returns {source stem: library path}; each library's
    ptxas report (registers, shared memory, spills) is written beside it
    as ``<library>.log``.  Raises with the compiler output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {src.stem: (src, _target(src)) for src in sorted(CSRC.glob("*.cu"))}
    procs = []
    for src, out in targets.values():
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".so.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{out.name}:\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a racing process sees all or nothing
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {stem: out for stem, (_, out) in targets.items()}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = _libs[stem] = ctypes.CDLL(str(build_all()[stem]))
        return lib
