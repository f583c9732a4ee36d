"""Build the hand-written CUDA kernels under ``csrc/`` at first use.

Route: ``nvcc`` into a shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds, not minutes):

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared \
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The output name carries a hash of the sources and flags, so an edited kernel
is rebuilt and a built one is reused. The build directory
(``evoke_tpu_torch/_build/``) is git-ignored. ``nvcc`` is looked up on PATH,
then under ``$CUDA_HOME/bin`` and ``/usr/local/cuda/bin``; its absence, or a
failed build, raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root:
            cands.append(os.path.join(root, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built on the card's machine at first use")


def library_path(name: str, defines: Sequence[str] = ()) -> Path:
    """The hashed .so path for ``csrc/<name>.cu`` (sources + headers + flags)."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join([*NVCC_FLAGS, *defines]).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(name: str, defines: Sequence[str] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` unless its hashed library exists. The
    compiler's ``-Xptxas -v`` report lands beside it as ``<so>.log``.
    ``defines`` are ``-D`` flags of a measuring build (none on the main path)."""
    so = library_path(name, defines)
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, *defines, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (rc {res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    so.with_name(so.name + ".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, so)
    return so


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Build several sources at once: one nvcc process per source."""
    names = list(names)
    with ThreadPoolExecutor(max(len(names), 1)) as pool:
        return dict(zip(names, pool.map(build, names)))


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu`` (each kernel module binds
    it once per process)."""
    return ctypes.CDLL(str(build(name)))
