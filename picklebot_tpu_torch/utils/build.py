"""Build the port's CUDA and host C++ sources into shared libraries, at
first use.

Each ``csrc/<name>.cu`` compiles on its own with ``nvcc`` into
``picklebot_tpu_torch/_build/<name>-<hash>.so`` (a directory git ignores),
where the hash covers the source and the flags, so an edited source
rebuilds and an unchanged one loads from the cache. The libraries have a
plain C interface and load with ``ctypes``: no PyTorch headers, so a build
takes seconds. ``build_all`` starts one ``nvcc`` per source at once.

``build_host`` is the host compiler's path beside it: a C++ source of the
data pipeline (``data/native_src/*.cpp``) through ``g++`` into the same
directory under the same naming. Both write under a temporary name and
rename, so processes that build one library at once (test workers) are
harmless to each other.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME): the port's kernels build with it")


def _hashed(src: Path, flags, host: str = "") -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()
                            + host.encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    return _hashed(CSRC / f"{name}.cu", NVCC_FLAGS)


def host_library_path(src: Path, flags) -> Path:
    """Where ``build_host(src, flags)`` puts its library. The hash also
    covers the host (its name and architecture): a library built with
    ``-march=native``, or linked against one machine's shared libraries,
    is not taken for another machine's when a tree is copied."""
    return _hashed(Path(src), flags,
                   f"{platform.node()}/{platform.machine()}")


def build_host(src: Path, flags) -> Path:
    """Compile the C++ source ``src`` with ``g++ <flags>`` (compile and
    link flags, ``-shared`` among them) into ``_build/<stem>-<hash>.so``
    unless it is there. Raises RuntimeError with the compiler's output if
    the build fails."""
    out = host_library_path(src, flags)
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the port's host libraries "
                           f"({Path(src).name}) build with it")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    flags = list(flags)
    # link libraries (-l...) follow the source, as the linker reads them
    libs = [f for f in flags if f.startswith("-l")]
    cmd = [cxx, *[f for f in flags if not f.startswith("-l")], "-o",
           str(tmp), str(src), *libs]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(src).name} (g++ exit {proc.returncode}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)    # atomic: a concurrent build is harmless
    return out


def build_all(names: Iterable[str] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of csrc/) that is not
    cached, one nvcc process each, all started together. Returns
    {name: library path}. Raises with nvcc's output if any build fails.
    Writes ptxas's register and shared-memory report next to each
    library as ``<lib>.log``."""
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None \
        else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n) for n in names}
    procs = {}
    for n, out in paths.items():
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        paths[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])   # atomic: a concurrent build is harmless
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load_library(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it if needed."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _LOADED[name]
