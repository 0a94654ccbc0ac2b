"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with nvcc for sm_90a into its own shared
library with a plain C interface, loaded through ctypes. A library is
keyed by a hash of its source and the flags, so the first use after a
change rebuilds it and later uses load it as built. The libraries go to
``build/kernels/`` at the repository root.

``LAUNCHES`` counts kernel launches: each wrapper adds one where it
launches its kernel (``count_launch``), and nowhere else. A launch made
while a CUDA graph is captured does not run then: it counts in the
capture's tally (``capturing``), and runs, and counts, each time the graph
is replayed (``add_replay``). So the counters equal what ran on the card.
Threads (a fleet router polling its replicas from a thread pool) count
apart: a capture's tally takes only the launches of the thread that
captures, and captures take turns (``CAPTURE_LOCK``).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Iterator, List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_attention", "sparse_gather", "decode_attention",
           "relu_ffn", "nmce_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: Dict[str, int] = {"paged_attention": 0, "sparse_gather_matvec": 0,
                            "decode_attention": 0, "relu_ffn": 0,
                            "nmce_matmul": 0}
_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()
CAPTURE_LOCK = threading.Lock()          # held by every graph capture


class _Captures(threading.local):
    """This thread's open captures' tallies."""

    def __init__(self):
        self.open: List[Dict[str, int]] = []


_CAPTURES = _Captures()


def count_launch(name: str) -> None:
    """Count one launch of kernel ``name``: in LAUNCHES, or in the tally
    of the CUDA graph this thread is capturing."""
    open_ = _CAPTURES.open
    with _COUNT_LOCK:
        (open_[-1] if open_ else LAUNCHES)[name] += 1


@contextlib.contextmanager
def capturing() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: yields the tally of the launches the
    graph holds, which LAUNCHES does not count."""
    tally = dict.fromkeys(LAUNCHES, 0)
    _CAPTURES.open.append(tally)
    try:
        yield tally
    finally:
        _CAPTURES.open.pop()


def add_replay(tally: Dict[str, int], replays: int) -> None:
    """Count the launches of ``replays`` replays of a graph whose capture
    tallied ``tally``."""
    with _COUNT_LOCK:
        for name, n in tally.items():
            LAUNCHES[name] += n * replays


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH): the CUDA "
                           "kernels build on a machine with the toolkit")
    return found


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for its current
    source and flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> str:
    """Compile every named source whose library is missing: one nvcc per
    source, all started together. Returns nvcc's diagnostics (the
    ``-Xptxas=-v`` register and shared-memory report); raises with nvcc's
    stderr when a build fails."""
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs.append((name, tmp, out,
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True)))
    logs, errors = [], []
    for name, tmp, out, proc in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)     # atomic: a reader never sees half a file
        logs.append(f"{name}.cu:\n{stdout}{stderr}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return "\n".join(logs)


@functools.cache
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``, read once: the
    kernels' wrappers size their grids by it on every call."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
    return lib
