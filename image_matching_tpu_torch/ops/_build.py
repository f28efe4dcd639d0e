"""Build and load the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into its own shared library, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds). Libraries land in `build/kernels/`
at the repository root, named by a hash of the source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source or header is
rebuilt and an unchanged one is reused.

Nothing here runs at import: the first wrapper that launches a kernel
calls `library(name)`, which builds on demand. `build_all()` compiles
every source at once, one `nvcc` process each, and returns the
compiler's `-Xptxas -v` report (registers, shared memory, spills).

Every wrapper counts its launches in `LAUNCHES` (one per call that
launches its kernel on the card; plain CPU calls do not count).
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNELS = ("entry_conv", "attention", "attention_bwd", "attention_bwd_chunked", "sinkhorn", "s2d_entry_conv", "realign",
           "lds_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

LAUNCHES: collections.Counter = collections.Counter()

_libraries: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(name: str) -> Path:
    """The library of `name`, named by a hash of its source, every shared
    header of `csrc/` (which a source may include) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start one nvcc process for `name`; if it is built, return its path."""
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    """Wait for the build (if one was started); return nvcc's report, which
    is kept beside the library."""
    if isinstance(started, Path):
        return started.with_suffix(".log").read_text()
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return log


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every kernel in parallel; returns {name: nvcc report}."""
    started = {n: _start(n) for n in names}
    return {n: _finish(n, s) for n, s in started.items()}


def library(name: str) -> ctypes.CDLL:
    lib = _libraries.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(_target(name)))
        _libraries[name] = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
