"""Build the port's CUDA sources with ``nvcc`` at first use and load them
through ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with
a plain C interface (no PyTorch headers: a build takes seconds, not
minutes); :func:`build_all` runs one nvcc per source, all at once. The
library lands in ``edl_tpu_torch/_build/`` (gitignored) under a name
that carries the hash of the source, the shared ``csrc/*.cuh`` headers
and the flags, so an edited source or header rebuilds and an unchanged
one loads the cached library.
A failed build raises with nvcc's own error output; a good one keeps
ptxas's report (registers, spills and wgmma serialization warnings per
kernel, ``-Xptxas -v``) beside the library, read by :func:`ptxas_info`.
Only the sources in this package are ever compiled.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS: List[str] = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
    # the static CUDA runtime, through which flash_fwd.cu reaches the
    # driver's cuTensorMapEncodeTiled (cudaGetDriverEntryPointByVersion):
    # no -lcuda at build time
    "-cudart", "static",
]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else under ``$CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to for its current content (and
    that of every shared header)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(
            glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path. The output is renamed into place, so a
    concurrent or interrupted build never leaves a torn library."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(CSRC, f"{name}.cu")]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu (rc {res.returncode}):\n"
                f"{' '.join(cmd)}\n{res.stderr}{res.stdout}"
            )
        with open(out[:-3] + ".ptxas.txt", "w") as f:
            f.write(res.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _kernel_name(mangled: str) -> str:
    """``flash_bwd_dkv<128,1>`` for the mangled name of
    ``flash_bwd_dkv_kernel<128, true>``; other names as they are."""
    k = re.search(r"(\w+)_kernelI((?:Li\d+E|Lb[01]E)+)", mangled)
    if not k:
        return mangled
    # the mangled name is <namespace hash><length><name>: the kernel's
    # name follows the last digit (it has none itself)
    return (re.sub(r"^.*\d", "", k.group(1)) + "<"
            + ",".join(re.findall(r"L[ib](\d+)E", k.group(2))) + ">")


def ptxas_info(name: str) -> Dict[str, Dict[str, int]]:
    """Registers a thread, spill bytes (stores + loads) and whether ptxas
    serialized its wgmma (warnings C7510-C7520, "Potential Performance
    Loss: wgmma.mma_async instructions are serialized ...") for every
    kernel of the built ``csrc/<name>.cu``, from ptxas's report; kernels
    are named ``<function><template args>``, e.g. ``flash_bwd_dkv<128,1>``."""
    with open(library_path(name)[:-3] + ".ptxas.txt") as f:
        lines = f.read().splitlines()
    info: Dict[str, Dict[str, int]] = {}

    def entry(kernel):
        return info.setdefault(kernel, {"registers": 0, "spill_bytes": 0,
                                        "wgmma_serialized": False})

    kernel = None
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            kernel = _kernel_name(m.group(1))
            entry(kernel)
            continue
        m = re.search(r"\(C75(\d\d)\)", line)
        if m and 10 <= int(m.group(1)) <= 20:
            # the warning names its function; else it is the current one
            named = re.search(r"function '(\S+?)'", line)
            owner = _kernel_name(named.group(1)) if named else kernel
            if owner:
                entry(owner)["wgmma_serialized"] = True
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and kernel:
            entry(kernel)["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel:
            entry(kernel)["registers"] = int(m.group(1))
    return info


def build_all(names: Sequence[str]) -> List[str]:
    """:func:`build` every source in ``names`` at once, one nvcc process
    each; returns the library paths in order."""
    with ThreadPoolExecutor(max(1, len(names))) as pool:
        return list(pool.map(build, names))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build(name))
        return lib
