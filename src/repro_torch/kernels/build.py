"""Build the CUDA sources under ``csrc/`` with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` becomes ``build/kernels/<name>-<hash>.so`` in the
repository, keyed on a hash of the sources and flags so a changed ``.cu``
rebuilds, and is loaded with ``ctypes``. The sources have a plain C
interface and include no PyTorch header, so a build takes seconds.
``build_all`` starts one ``nvcc`` per source, all at once.

Every launcher also takes from here what it asks of a tensor before it
passes a pointer (``on_card``, ``check_tensor``).

Nothing is built or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
CUDA_BIN = "/usr/local/cuda/bin"   # the toolkit's default location


@dataclasses.dataclass
class Built:
    """A compiled kernel library and what its build reported."""

    name: str
    path: Path
    lib: ctypes.CDLL
    seconds: float            # 0.0 when the library was already built
    ptxas: List[str]          # the "-Xptxas -v" register/spill/smem lines


_LOADED: Dict[str, Built] = {}


def find_nvcc() -> str:
    """nvcc on PATH, else in the CUDA toolkit's default location."""
    search = os.pathsep.join([os.environ.get("PATH", ""), CUDA_BIN])
    nvcc = shutil.which("nvcc", path=search)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found on PATH or in /usr/local/cuda/bin: the CUDA "
            "kernels are built from src/repro_torch/kernels/csrc at first use "
            "and need the CUDA toolkit")
    return nvcc


def _source(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no kernel source {src}")
    return src


def _library_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update(_source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> List[str]:
    return [ln.strip() for ln in log.splitlines()
            if "ptxas" in ln or "spill" in ln]


def _start(name: str, nvcc: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``name`` unless its library is already built."""
    path = _library_path(name)
    if path.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    return subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_source(name))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: Optional[subprocess.Popen], t0: float) -> Built:
    path = _library_path(name)
    log_path = path.with_suffix(".log")
    seconds = 0.0
    if proc is not None:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {_source(name)} "
                               f"(exit {proc.returncode}):\n{log}")
        log_path.write_text(log)
        os.replace(tmp, path)   # atomic: a concurrent loader sees all or none
    log = log_path.read_text() if log_path.exists() else ""
    return Built(name=name, path=path, lib=ctypes.CDLL(str(path)),
                 seconds=seconds, ptxas=_ptxas_lines(log))


def load(name: str) -> Built:
    """The built library for ``csrc/<name>.cu``, compiling it if needed."""
    if name not in _LOADED:
        t0 = time.perf_counter()
        proc = _start(name, find_nvcc())
        _LOADED[name] = _finish(name, proc, t0)
    return _LOADED[name]


def build_all() -> Dict[str, Built]:
    """Build every ``csrc/*.cu`` with one nvcc each, all started together."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    pending = [n for n in names if n not in _LOADED]
    if pending:
        nvcc = find_nvcc()
        t0 = time.perf_counter()
        procs = {n: _start(n, nvcc) for n in pending}
        try:
            for n in pending:
                _LOADED[n] = _finish(n, procs[n], t0)
        finally:
            for proc in procs.values():   # one build failed: stop the rest
                if proc is not None and proc.poll() is None:
                    proc.kill()
                    proc.wait()
    return {n: _LOADED[n] for n in names}


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes a kernel's route: a CUDA tensor, or a fake one
    (``FakeTensorMode``), the dry run's shape-only stand-in for a CUDA
    tensor on any build of torch."""
    return t.device.type == "cuda" or isinstance(t, FakeTensor)


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
                 device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``: what every launcher checks before it passes a pointer."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
