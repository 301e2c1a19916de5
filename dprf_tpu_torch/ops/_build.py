"""Build the port's CUDA sources into shared libraries with a plain C
interface, and load them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for Hopper (``sm_90a``) into
``_build/lib<name>-<hash>.so`` at its first use in a process; the hash
covers the source, every ``csrc/`` file it includes and the flags, so
an edited source or header never loads a stale library.  A build that fails raises with nvcc's output: nothing
falls back to another path.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import re
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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def source_files(src: str) -> list[str]:
    """``src`` and every file it includes with ``#include "..."``,
    transitively, resolved against the including file's directory."""
    seen: list[str] = []
    todo = [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        with open(path, "rb") as fh:
            for inc in _INCLUDE.findall(fh.read()):
                todo.append(os.path.join(os.path.dirname(path),
                                         inc.decode()))
    return seen


def source_hash(src: str) -> str:
    """Hash of the source, its included files and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(src):
        with open(path, "rb") as fh:
            h.update(os.path.relpath(path, CSRC_DIR).encode() + b"\0"
                     + fh.read())
    return h.hexdigest()[:16]


@functools.cache
def build(name: str) -> Built:
    """Compile ``csrc/<name>.cu`` unless this source and flag set is
    already built; returns the library path and the build log."""
    import time

    src = os.path.join(CSRC_DIR, name + ".cu")
    digest = source_hash(src)
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
    """Static SASS instruction count of each kernel in the built
    library (``cuobjdump -sass``), by function: its total and its ten
    commonest opcodes (without modifiers)."""
    import collections

    cuobjdump = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", build(name).path],
                         capture_output=True, text=True, check=True).stdout
    instr = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)")
    funcs: dict = {}
    ops: list = []
    for line in out.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            ops = funcs.setdefault(head.group(1), [])
            continue
        m = instr.search(line)
        if m:
            ops.append(m.group(1))
    return {f: {"total": len(o),
                "by_opcode": dict(collections.Counter(o).most_common(10))}
            for f, o in funcs.items()}


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, loaded once per process."""
    return ctypes.CDLL(build(name).path)
