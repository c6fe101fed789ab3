"""Build and load of the package's CUDA kernels, and their launch counts.

Each source under ``reductive_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes``.  The build happens at first use, from the sources in the
package and nothing else, into ``reductive_tpu_torch/_build/``; a library's
file name carries a hash of its source and of every header (``*.cuh``) beside
it, so an edited source or header rebuilds.
Nothing here runs when the package is imported: a machine without ``nvcc``
or a GPU imports every module and only fails when a kernel is asked for.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = [
    "SOURCES", "build_all", "library", "launch", "query", "launch_counts", "reset_launch_counts",
]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

SOURCES = ("encode", "decode", "adc", "stats", "probe")

_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# C entry -> (source, argtypes[, restype]; c_int unless given).  Every pointer
# and the stream is c_void_p: without argtypes ctypes would pass them as
# 32-bit ints.
_ENTRIES = {
    "rt_encode": ("encode", (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P)),
    "rt_encode_bf16": ("encode", (_P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _P)),
    "rt_encode_verify": ("encode", (_P, _P, _P, _P, _P, _F, _P, _L, _I, _I, _I, _I, _I, _P)),
    "rt_decode_prepare": ("decode", (_P, _I, _P, _P, _P, _I, _I, _I, _P)),
    "rt_decode": ("decode", (_P, _I, _I, _P, _P, _L, _I, _I, _I, _I, _I, _P)),
    "rt_decode_int8": ("decode", (_P, _I, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P)),
    "rt_adc": ("adc", (_P, _P, _I, _I, _P, _L, _I, _I, _I, _I, _I, _I, _I, _L, _I, _I, _P)),
    "rt_adc_int8": ("adc", (_P, _P, _P, _P, _I, _I, _P, _L, _I, _I, _I, _I, _I, _P)),
    "rt_assign_stats": ("stats", (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P)),
    "rt_assign_stats_bf16": ("stats", (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _P)),
    "rt_assign_stats_verify": (
        "stats", (_P, _P, _P, _P, _P, _P, _P, _F, _P, _P, _L, _I, _I, _I, _I, _P)),
    "rt_assign_stats_wide": (
        "stats", (_P, _P, _P, _P, _P, _F, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P)),
    "rt_assign_stats_wide_scratch": ("stats", (_L, _I, _I, _I), _L),
    "rt_cell_stats": ("stats", (_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _P)),
    "rt_cell_stats_scratch": ("stats", (_L, _I, _I, _I), _L),
    "rt_probe_wgmma_tf32": ("probe", (_P, _P, _P, _P, _I, _I, _P)),
}

_libs: dict[str, ctypes.CDLL] = {}
_counts: collections.Counter = collections.Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (looked on PATH, in CUDA_HOME, CUDA_PATH and /usr/local/cuda): "
        "the CUDA kernels of reductive_tpu_torch are compiled at first use"
    )


def _target(name: str, csrc: Path | None = None) -> tuple[Path, Path]:
    """The source of one library and the file it is built into.  The file's
    name hashes the source, every ``*.cuh`` under ``csrc`` (a source may
    include any of them) and the compiler's flags."""
    csrc = _CSRC if csrc is None else csrc
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return src, _BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str, verbose: bool):
    """Start ``nvcc`` for one source unless its library is already built.
    Returns ``(name, lib_path, tmp_path, process or None)``."""
    src, lib = _target(name)
    if lib.exists():
        return name, lib, None, None
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-I", str(_CSRC), *(("-Xptxas", "-v") if verbose else ()),
           "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, lib, tmp, proc


def _finish_build(job) -> str:
    name, lib, tmp, proc = job
    if proc is None:
        return ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, lib)  # atomic: a concurrent process sees a whole file or none
    return out


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel source, one ``nvcc`` each, all started together.
    Returns the compiler's output by source (empty when already built).
    Raises ``RuntimeError`` with ``nvcc``'s output if a build fails."""
    jobs = [_start_build(name, verbose) for name in SOURCES]
    errors, outputs = [], {}
    for job in jobs:  # wait for every process before raising
        try:
            outputs[job[0]] = _finish_build(job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return outputs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if need be."""
    lib = _libs.get(name)
    if lib is None:
        _finish_build(_start_build(name, False))
        path = _target(name)[1]
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f"cannot load {path}: {e}") from e
        for entry, (source, argtypes, *restype) in _ENTRIES.items():
            if source == name:
                fn = getattr(lib, entry)
                fn.argtypes = list(argtypes)
                fn.restype = restype[0] if restype else ctypes.c_int
        _libs[name] = lib
    return lib


def launch(entry: str, counter: str | tuple[str, ...] | None, *args) -> None:
    """Call one C entry (which launches its kernel on the stream it is given
    and returns ``cudaGetLastError()``), raise if that is not 0, and add one
    to the kernel's launch count (a tuple: to each kernel the entry launches;
    ``counter=None``: a probe, or the table a kernel gathers from, built by
    its own launch; nothing is counted).  This is the only place a count
    grows."""
    rc = query(entry, *args)
    if rc != 0:
        raise RuntimeError(
            f"{entry} failed to launch: "
            + ("shape not taken by the kernel" if rc < 0 else f"CUDA error {rc}")
        )
    for name in (counter,) if isinstance(counter, str) else counter or ():
        _counts[name] += 1


def query(entry: str, *args):
    """Call one C entry and return what it returns."""
    return getattr(library(_ENTRIES[entry][0]), entry)(*args)


def launch_counts() -> dict[str, int]:
    """Launches of each kernel since the last reset, by kernel name."""
    return dict(_counts)


def reset_launch_counts() -> None:
    _counts.clear()
