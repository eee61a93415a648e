"""Build and load the hand-written CUDA kernels in ``tpu_gpad_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, under
``tpu_gpad_torch/_build/`` (git-ignored). The library is named by a hash of
its source and the shared ``csrc/*.cuh`` headers, so an edited source
rebuilds, and is loaded with ``ctypes``.
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from tpu_gpad_torch.tracing import span

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# Per library: seconds spent in nvcc (0.0 when an existing build was
# loaded) and nvcc's ptxas report (registers, shared memory, spills).
BUILD_SECONDS: dict[str, float] = {}
BUILD_LOG: dict[str, str] = {}


def _nvcc() -> str:
    """The nvcc binary: $CUDA_HOME/bin/nvcc (PyTorch's lookup), else PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels of tpu_gpad_torch are compiled at first use"
        )
    return found


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library.
    ``defines`` are preprocessor macros (e.g. a profiling build); each set
    builds a library of its own."""
    return load_all([name], defines)[0]


def load_all(names, defines: tuple = ()) -> list[ctypes.CDLL]:
    """Compile every named source that needs it, one ``nvcc`` each, all
    started together, then load them in order."""
    suffix = "".join(f"+{d}" for d in defines)
    keys = [name + suffix for name in names]
    if any(key not in _LIBS for key in keys):  # not on every launch
        with span("build"):
            _build(names, keys, defines, suffix)
    return [_LIBS[key] for key in keys]


def _build(names, keys, defines: tuple, suffix: str) -> None:
    """Compile the sources whose build is missing, load every library."""
    pending = []
    for name, key in zip(names, keys):
        if key in _LIBS:
            continue
        src = CSRC / f"{name}.cu"
        # the shared headers count too: an edited header rebuilds
        digest = hashlib.sha256(b"".join(
            p.read_bytes() for p in [src, *sorted(CSRC.glob("*.cuh"))]
        ) + suffix.encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}-{digest}.so"
        BUILD_SECONDS[key] = 0.0
        if not out.exists():
            BUILD_DIR.mkdir(exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines),
                   "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            pending.append((key, src, out, tmp, proc, time.perf_counter()))
        else:
            _LIBS[key] = ctypes.CDLL(str(out))
    # wait for every nvcc before raising for any, so none outlives the call
    errs = [proc.communicate()[1] for *_, proc, _ in pending]
    for (key, src, out, tmp, proc, t0), err in zip(pending, errs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {src.name} (rc {proc.returncode}):\n{err}"
            )
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        BUILD_SECONDS[key] = time.perf_counter() - t0
        BUILD_LOG[key] = err
        _LIBS[key] = ctypes.CDLL(str(out))
