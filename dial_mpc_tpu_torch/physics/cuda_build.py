"""Build one CUDA source of ``csrc/`` into a shared library, once.

The kernels of this package are hand-written C++ in ``csrc/`` with a plain C
interface; each is compiled by ``nvcc`` for ``sm_90a`` at first use, together
with the small header of constants its wrapper generates, and loaded with
``ctypes``. Libraries are cached in the build directory under a hash of the
sources, the generated headers and the compiler flags.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_REPO_ROOT = os.path.dirname(os.path.dirname(CSRC))
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class BuiltLibrary:
    path: str  # the shared library
    seconds: float  # nvcc's run time, 0.0 when the library was cached
    log: str  # the command line and what nvcc and ptxas printed


def build_root() -> str:
    return os.environ.get("DIAL_MPC_BUILD_DIR", os.path.join(_REPO_ROOT, "build"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found; the CUDA kernels cannot be built")
    return nvcc


def ptxas_entries(log: str) -> dict:
    """Registers, stack, spills and static shared memory of each kernel entry
    (mangled name -> dict of ints) from a build log of ``-Xptxas -v``."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            sm = re.search(r"(\d+) bytes smem", line)
            cur.update(registers=int(m.group(1)), static_smem=int(sm.group(1)) if sm else 0)
            cur = None
    return out


def build_library(name: str, source: str, includes: tuple, generated: dict,
                  defines: dict | None = None) -> BuiltLibrary:
    """Compile ``csrc/<source>`` into ``lib<name>.so`` unless it is cached.

    ``includes`` names the files of ``csrc/`` the source includes (they enter
    the cache key); ``generated`` maps header file names to their text and is
    written into the library's own build directory, which is on the include
    path ahead of ``csrc/``; ``defines`` become ``-D`` flags.
    """
    flags = [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))]
    h = hashlib.sha256()
    for fname in sorted(generated):
        h.update(fname.encode() + b"\0" + generated[fname].encode())
    for fname in (source, *includes):
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    out_dir = os.path.join(build_root(), name, h.hexdigest()[:16])
    so_path = os.path.join(out_dir, f"lib{name}.so")
    log_path = os.path.join(out_dir, "build.log")
    seconds = 0.0
    if not os.path.exists(so_path):
        os.makedirs(out_dir, exist_ok=True)
        for fname, text in generated.items():
            with open(os.path.join(out_dir, fname), "w") as f:
                f.write(text)
        tmp = f"{so_path}.tmp{os.getpid()}_{threading.get_ident()}"
        cmd = [
            find_nvcc(), *flags, "-I", out_dir, "-I", CSRC,
            "-o", tmp, os.path.join(CSRC, source),
        ]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = " ".join(cmd) + "\n" + proc.stdout + proc.stderr
        with open(log_path, "w") as f:
            f.write(log)
        if proc.returncode != 0:
            raise RuntimeError(f"{source}: nvcc failed\n{log[-8000:]}")
        os.replace(tmp, so_path)
    with open(log_path) as f:
        log = f.read()
    return BuiltLibrary(so_path, seconds, log)
