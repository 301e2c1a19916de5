"""Build the port's CUDA sources into shared libraries with a plain C
interface, and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper (``sm_90a``) into
``_build/lib<name>-<hash>.so`` at its first use in a process; the hash
covers the source and the flags, so an edited source never loads a
stale library.  A build that fails raises with nvcc's output: nothing
falls back to another path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: where the CUDA toolkit installs nvcc when it is not on PATH
_NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: str
    #: nvcc's output for the build: the ``-Xptxas -v`` lines give each
    #: kernel's registers, shared memory and spills
    log: str
    seconds: float


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists(_NVCC_DEFAULT):
        return _NVCC_DEFAULT
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       f"{CSRC_DIR} with the CUDA toolkit's nvcc")


@functools.cache
def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless this source and flag set is
    already built; returns the library path and the build log."""
    import time

    src = os.path.join(CSRC_DIR, name + ".cu")
    with open(src, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()
                                ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")
    log_path = out + ".log"
    if os.path.exists(out) and os.path.exists(log_path):
        with open(log_path, encoding="utf-8") as fh:
            return Built(name, out, fh.read(), 0.0)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                           f"{src}:\n{log}")
    with open(log_path, "w", encoding="utf-8") as fh:
        fh.write(log)
    # atomic publish: a concurrent process sees the old state or the
    # whole library, never a half-written one
    os.replace(tmp, out)
    return Built(name, out, log, seconds)


def sass_census(name: str) -> dict:
    """Static instruction count of the built library's SASS by opcode
    (``cuobjdump -sass``; the opcode without its modifiers), plus the
    length of the straight-line block from the first load of a
    ``__constant__`` table entry (``c[0x3]``) to the first global
    atomic -- for mask_md5, the unrolled MD5 steps and the compare."""
    import collections
    import re

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", build(name).path],
                         capture_output=True, text=True, check=True).stdout
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)")
    lines = [ln for ln in out.splitlines() if instr.search(ln)]
    ops = [instr.search(ln).group(1) for ln in lines]
    start = next((i for i, ln in enumerate(lines) if "c[0x3]" in ln), None)
    end = next((i for i, ln in enumerate(lines) if "ATOMG" in ln), None)
    block = (end - start + 1) if start is not None and end is not None \
        else None
    return {"total": len(ops),
            "by_opcode": dict(collections.Counter(ops).most_common()),
            "constant_to_atomic_block": block}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(build(name).path)
