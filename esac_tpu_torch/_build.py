"""Build the CUDA kernels and the C++ host backend at first use and load
them with ``ctypes``.

Each ``csrc/*.cu`` compiles with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into its own shared library with a plain C interface (no PyTorch headers,
so a build takes seconds).  The C++ hypothesis loop of ``--backend cpp``,
``esac_cpp/esac.cpp``, compiles with ``g++`` and the flags of the JAX
package's binding (:data:`GXX_FLAGS`).  Libraries land in
``esac_tpu_torch/build/`` (listed in ``.gitignore``), named by a hash of
their source and flags, so a changed source rebuilds and an unchanged one
loads from the previous build; each is written under a temporary name and
moved into place with ``os.replace``, so processes building at once never
load a half-written file.  All CUDA sources compile in parallel, one
``nvcc`` each.  Nothing runs at import: the CPU tests import every module
of the package.
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
HOST_SRC = pathlib.Path(__file__).resolve().parent.parent / "esac_cpp" / "esac.cpp"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-fopenmp")
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


def _host_target(src: pathlib.Path) -> pathlib.Path:
    """The library's path: a hash of the source, the flags and what
    ``-march=native`` means on this machine (a build copied to another
    machine, whose CPU may lack an instruction it uses, is not loaded
    there)."""
    native = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True)
    if native.returncode != 0:
        raise RuntimeError(f"g++ -march=native -Q --help=target failed:\n{native.stderr}")
    digest = hashlib.sha256(src.read_bytes() + " ".join(GXX_FLAGS).encode()
                            + native.stdout.encode())
    return BUILD_DIR / f"{src.stem}-host-{digest.hexdigest()[:16]}.so"


def build_host(src: pathlib.Path = HOST_SRC) -> pathlib.Path:
    """Compile the C++ host source with ``g++`` and :data:`GXX_FLAGS` unless
    built already; returns the library's path.  Raises with the compiler's
    output on failure (``g++`` missing included)."""
    if shutil.which("g++") is None:
        raise RuntimeError("g++ not found: the C++ backend builds with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _host_target(src)
    if out.exists():
        return out
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    res = subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {src}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)  # atomic: a racing process sees all or nothing
    return out


def load_host() -> ctypes.CDLL:
    """The loaded C++ host backend (built on first use)."""
    with _lock:
        lib = _libs.get("host")
        if lib is None:
            lib = _libs["host"] = ctypes.CDLL(str(build_host()))
        return lib
