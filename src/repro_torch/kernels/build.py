"""Builds the port's CUDA kernels from ``src/repro_torch/csrc`` at first use.

Each source compiles with ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), loaded with
``ctypes``. Libraries are cached under ``src/repro_torch/_build`` (listed
in ``.gitignore``) by a hash of the source, the shared headers and the
flags, so a rebuilt source never loads a stale library. ``build_all`` starts one ``nvcc`` per
source at once and waits for all of them.

Nothing here runs at import: this module imports on machines without
``nvcc`` or a GPU, and only a launch on a CUDA tensor reaches ``library``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
SOURCES = {"event_topk": CSRC / "event_topk.cu",
           "fedavg_reduce": CSRC / "fedavg_reduce.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
           "flash_decode": CSRC / "flash_decode.cu",
           "aoi_topk": CSRC / "aoi_topk.cu",
           "ssd_scan": CSRC / "ssd_scan.cu",
           "ssd_scan_bwd": CSRC / "ssd_scan_bwd.cu"}
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: Dict[str, ctypes.CDLL] = {}
# what ptxas reported for each library built in this process
ptxas_log: Dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the
    toolkit's default location, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of repro_torch "
            "are built from source at first use"
        )
    return found


def _target(name: str) -> Path:
    """The library's path, named by a hash of the source, the shared
    headers of ``csrc`` and the flags."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile every named source that has no cached library, all in
    parallel; raise with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = out[name] = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        ptxas_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, target)  # atomic: a reader never sees half a file
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib
