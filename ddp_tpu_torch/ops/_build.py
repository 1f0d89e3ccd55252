"""Build the port's CUDA sources into shared libraries, at first use.

Each ``ops/csrc/*.cu`` file has a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers, so a build takes seconds) into
``ops/_build/<stem>-<hash>.so``, keyed by a hash of the source, the
headers beside it (``csrc/*.cuh``) and the flags: an edited source or
header builds anew, an unchanged one is loaded as it is. ``build``
starts one ``nvcc`` per missing library, all at once, and waits for them
together. nvcc's output, ptxas's register, shared-memory and spill
report included (``-Xptxas -v``), is kept beside each library as
``<stem>-<hash>.log``; :func:`ptxas_report` reads it. A source being
built in one thread is waited for by any other thread of the process that
builds or loads it. The build directory is listed in ``.gitignore``;
nothing here runs at import time, because the CPU test host has no
``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("flash_decode.cu", "flash_attn.cu")
# One lock a source: a build in flight is waited for, never started twice
# (the temporary names are per process).
_LOCKS = {s: threading.Lock() for s in SOURCES}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then /usr/local/cuda, then
    ``PATH``. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
        "and PATH): the CUDA kernels build only where the CUDA toolkit "
        "is installed"
    )


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def log_path(source: str) -> Path:
    """nvcc's output for the library of ``csrc/<source>``."""
    return library_path(source).with_suffix(".log")


def build(sources=SOURCES) -> dict[str, float]:
    """Compile every missing library in parallel → {source: seconds}
    (0.0 for one already built). Raises with nvcc's output on failure."""
    locks = [_LOCKS.setdefault(s, threading.Lock()) for s in sorted(sources)]
    for lock in locks:
        lock.acquire()
    try:
        return _compile(sources)
    finally:
        for lock in locks:
            lock.release()


def _compile(sources) -> dict[str, float]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources if not library_path(s).is_file()]
    seconds = {s: 0.0 for s in sources}
    if not todo:
        return seconds
    nvcc = find_nvcc()
    procs = []
    t0 = time.perf_counter()
    for src in todo:
        out = library_path(src)
        # A private temporary name, renamed into place when complete:
        # two processes building at once never load a torn library.
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        seconds[src] = time.perf_counter() - t0
        text = log.decode(errors="replace")
        if proc.returncode:
            failures.append(f"{src}:\n{text}")
            tmp.unlink(missing_ok=True)
        else:
            log_path(src).write_text(text)
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("nvcc failed\n" + "\n".join(failures))
    return seconds


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, built first if needed."""
    build((source,))
    return ctypes.CDLL(str(library_path(source)))


_ENTRY = re.compile(r"Compiling entry function '(\S+)' for")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(text: str) -> list[dict]:
    """ptxas's ``-v`` report → one dict per kernel entry: its (mangled)
    name, registers, static shared memory, stack frame and spill bytes."""
    rows, cur = [], None
    for line in text.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"kernel": m.group(1), "registers": None, "smem": 0,
                   "stack": 0, "spill_stores": 0, "spill_loads": 0}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["stack"], cur["spill_stores"], cur["spill_loads"] = (
                int(g) for g in m.groups())
        m = _USED.search(line)
        if m:
            cur["registers"] = int(m.group(1))
            m = _SMEM.search(line)
            cur["smem"] = int(m.group(1)) if m else 0
    return rows


def ptxas_report(source: str) -> list[dict]:
    """:func:`parse_ptxas` of the kept build log of ``csrc/<source>``
    (empty when the library was built without one)."""
    path = log_path(source)
    return parse_ptxas(path.read_text()) if path.is_file() else []
