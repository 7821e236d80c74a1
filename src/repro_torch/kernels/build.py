"""Build a CUDA source into a shared library with ``nvcc`` and load it.

Each kernel is a ``.cu`` file with a plain C entry point, compiled for
Hopper (``sm_90a``) at first use into ``build/kernels/`` at the repository
root, cached by a hash of the source, the headers beside it that it
includes, and the flags, and loaded with ``ctypes``.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class BuildInfo:
    """What one :func:`load` did: the library path, whether it compiled in
    this process, the compile seconds and the ``ptxas -v`` output (kept
    beside a cached library, so it is there when another process built
    it)."""
    path: Path
    compiled: bool
    seconds: float
    log: str


_LOADED: Dict[Path, ctypes.CDLL] = {}
BUILDS: Dict[str, BuildInfo] = {}


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``$CUDA_HOME/bin`` or the default
    toolkit location; raises naming what is missing."""
    hit = shutil.which("nvcc")
    if hit:
        return hit
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"),
                 "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found on PATH nor under $CUDA_HOME/bin: the "
                       "CUDA toolkit is needed to build the port's kernels")


def _local_includes(source: Path) -> List[Path]:
    """The headers ``source`` includes with quotes, from its directory."""
    names = re.findall(r'^\s*#\s*include\s+"([^"]+)"', source.read_text(),
                       flags=re.M)
    return [source.parent / nm for nm in names]


def load(source: Path, name: Optional[str] = None) -> ctypes.CDLL:
    """Compile ``source`` (once per hash of it, the headers it includes
    with quotes and the flags) and return the library."""
    source = Path(source)
    name = name or source.stem
    content = b"".join(f.read_bytes()
                       for f in [source] + _local_includes(source))
    digest = hashlib.sha256(content +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{name}-{digest}.so"
    if lib_path in _LOADED:
        return _LOADED[lib_path]
    compiled, seconds, log = False, 0.0, ""
    if not lib_path.is_file():
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, str(source)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed on {source.name} "
                               f"(exit {proc.returncode}):\n{log}")
        lib_path.with_suffix(".log").write_text(log)
        os.replace(tmp, lib_path)        # atomic: concurrent builds agree
        compiled = True
    elif lib_path.with_suffix(".log").is_file():
        log = lib_path.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(lib_path))
    _LOADED[lib_path] = lib
    BUILDS[name] = BuildInfo(lib_path, compiled, seconds, log)
    return lib
