"""What the hand-written CUDA kernels' wrappers share: building a ``csrc``
source into a library, the current stream as a handle, the launch's error
code, and the wrappers' launch counters.

- :func:`build` compiles a ``.cu`` file with ``nvcc`` into ``build/kernels/``
  at the root of the checkout, named by the hash of the source (so an edit
  rebuilds), unless it is built already; the wrappers load the library with
  ``ctypes`` at first use. Nothing is built at module import.
- Each wrapper counts its launches as plain integers on itself, one for each
  element type: ``.launches`` (f32) and ``.launches_bf16``. A host counter
  moves only when the wrapper runs, so a CUDA graph counts its kernels at
  capture, where none runs: ``train/graph.py`` reads the counters of the
  wrappers it names with :func:`launch_counts`, takes the captured launches
  back out with :func:`add_launches` and adds them again for each replay.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# -Xptxas -v: the compiler output reports each kernel's registers and spills
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def build(source: Path, stem: str) -> tuple[Path, str]:
    """Compile ``source`` into ``libwtpse_<stem>_<hash>.so`` unless a library
    of the same source is already built. Returns the library's path and the
    compiler's output (empty when nothing was compiled)."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libwtpse_{stem}_{digest}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees half a file
    return lib, proc.stdout + proc.stderr


def raw_stream(device_index: int) -> int:
    """The current stream of a CUDA device as a ``cudaStream_t`` handle. The
    accessor that torch's own generated kernel launchers use: it builds no
    ``torch.cuda.Stream`` object, which costs microseconds a call."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def count(fn, dtype: torch.dtype) -> None:
    """One launch of wrapper ``fn`` for an input of ``dtype``."""
    if dtype == torch.bfloat16:
        fn.launches_bf16 += 1
    else:
        fn.launches += 1


def launch_counts(wrappers) -> dict[tuple[str, str], int]:
    """Every launch counter of ``wrappers``, keyed by (wrapper, counter
    name)."""
    return {(fn.__name__, attr): getattr(fn, attr)
            for fn in wrappers for attr in ("launches", "launches_bf16")}


def add_launches(counts: dict[tuple[str, str], int], times: int, wrappers) -> None:
    """Add ``times`` x ``counts`` (keyed as :func:`launch_counts`) to the
    counters of ``wrappers``: the launches of a captured graph, once for each
    replay."""
    by_name = {fn.__name__: fn for fn in wrappers}
    for (name, attr), n in counts.items():
        fn = by_name[name]
        setattr(fn, attr, getattr(fn, attr) + n * times)
