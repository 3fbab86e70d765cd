"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes``: no PyTorch headers, so a build takes
seconds.  Libraries land in ``build/repro_torch/`` at the repository root
(ignored by git), named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source or header rebuilds and
an unchanged one is reused.  All missing libraries of
one :func:`build_all` call compile in parallel, one ``nvcc`` per source.

Nothing here runs at import: the first CUDA launch of a wrapper calls
:func:`load`, and a failed build raises.  The CPU path never reaches this
module's compiler calls.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
#: the toolkit's conventional location, used when ``nvcc`` is not on PATH
CUDA_NVCC = Path("/usr/local/cuda/bin/nvcc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry points of each source: name -> argtypes (pointers and the
#: stream as c_void_p, so 64-bit addresses are never truncated)
SIGNATURES: Dict[str, Dict[str, List]] = {
    "conv2d_shard": {
        "conv2d_shard_dense_f32": [_P] * 4 + [_I] * 10 + [_L] * 6
        + [_I] * 5 + [_P],
        "conv2d_shard_dw_f32": [_P, _P, _P] + [_I] * 9 + [_L] * 5 + [_P],
    },
    "matmul_tiled": {
        "matmul_tiled_f32": [_P] * 4 + [_I] * 3 + [_L] * 3 + [_I] * 5
        + [_P],
    },
    "flash_decode_paged": {
        "flash_decode_paged_f32": [_P] * 5 + [_I] * 6 + [_P] + [_I] * 5
        + [_F, _P],
        "flash_decode_paged_bf16": [_P] * 5 + [_I] * 6 + [_P] + [_I] * 5
        + [_F, _P],
        "flash_decode_paged_occupancy": [_I] * 5 + [_P],
        "flash_decode_paged_occupancy_bf16": [_I] * 5 + [_P],
    },
    "flash_attention": {
        "flash_attention_f32": [_P] * 5 + [_I] * 7 + [_F, _P],
        "flash_attention_bf16": [_P] * 5 + [_I] * 7 + [_F, _P],
        "flash_attention_occupancy": [_I] * 6 + [_P],
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler; raises when the toolkit is missing."""
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_NVCC.exists():
        return str(CUDA_NVCC)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine that has the GPU")


def lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives for this source, the
    shared headers ``csrc/*.cuh`` and the flags: editing any of them
    rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, all started together.  The compiler's
    output (``-Xptxas=-v``: registers, shared memory, spills) is kept
    beside each library as ``.log``.  Raises ``RuntimeError`` naming the
    compiler output when any build fails."""
    names = list(SIGNATURES if names is None else names)
    paths = {n: lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, p in todo.items():
        tmp = p.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        todo[n].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[n])   # atomic: readers never see a stub
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, with
    ``argtypes``/``restype`` declared for every entry point."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name])[name]))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LOADED[name] = lib
    return lib
