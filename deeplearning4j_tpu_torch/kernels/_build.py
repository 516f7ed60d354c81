"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.
Libraries land in ``build/dl4j_torch_kernels/`` beside the package
(``$DL4J_TORCH_BUILD_DIR`` overrides), named by a hash of their source,
of every ``csrc/*.cuh`` it includes (``#include "x.cuh"``, followed
through headers) and of the nvcc flags, so an edited kernel, header or
flag is never served from a stale build. A missing ``nvcc`` or a failed
build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parents[1]
SRC_DIR = PKG_DIR / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+\.cuh)"', re.M)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("DL4J_TORCH_BUILD_DIR")
    return Path(env) if env else PKG_DIR.parent / "build" / "dl4j_torch_kernels"


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels are built from csrc/ at first use")


def _sources(name: str) -> List[Path]:
    """``csrc/<name>.cu`` and every ``csrc`` header it includes, directly
    or through another header, in a fixed order."""
    seen, todo = [], [SRC_DIR / f"{name}.cu"]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.append(path)
        todo.extend(SRC_DIR / inc.decode()
                    for inc in _INCLUDE.findall(path.read_bytes())
                    if (SRC_DIR / inc.decode()).exists())
    return [seen[0], *sorted(seen[1:])]


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes() + b"\0")
    h.update("\0".join(NVCC_FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:12]}.so"


def _nvcc_cmd(name: str, out: Path, src: Optional[Path] = None):
    """nvcc's command for ``csrc/<name>.cu`` or, where given, for ``src``,
    an edited copy of it elsewhere (its ``csrc`` headers found through
    ``-I``)."""
    inc = [] if src is None else [f"-I{SRC_DIR}"]
    return [nvcc_path(), *NVCC_FLAGS, *inc, "-o", str(out),
            str(SRC_DIR / f"{name}.cu" if src is None else src)]


def compile_sources(jobs: Dict[str, Tuple[str, Optional[Path], Path]],
                    verbose: bool = False) -> Dict[str, str]:
    """One ``nvcc`` per job, all started together. A job (key → (source
    name, edited copy or None, library)) builds into a temporary file
    that becomes the library once nvcc succeeds; ``verbose`` adds
    ``-Xptxas=-v``. Returns key → the compiler's output. Raises with the
    output of every build that failed."""
    procs = {}
    for key, (name, src, out) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _nvcc_cmd(name, tmp, src)
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for key, (proc, tmp, out) in procs.items():
        logs[key], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {key} (rc {proc.returncode})\n"
                          f"{logs[key]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, Path]:
    """Compile every named source that has no current build, one
    ``nvcc`` per source, all started together. Returns name → library
    path. Raises with the compiler's output if any build fails."""
    names = list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    logs = compile_sources({n: (n, None, out) for n, out in targets.items()
                            if not out.exists()}, verbose)
    for n, log in logs.items():
        if verbose and log.strip():
            print(f"--- nvcc {n}.cu\n{log.rstrip()}")
    return targets


def use(name: str, path: Path) -> ctypes.CDLL:
    """Serve ``csrc/<name>.cu``'s kernels from the library at ``path`` (a
    build of an edited copy, :func:`compile_sources`) from now on."""
    with _lock:
        _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            import torch
            if not torch.cuda.is_available():
                raise RuntimeError(f"kernel {name!r} needs a CUDA device")
            path = build([name])[name]
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib


def check(rc: int, name: str):
    """Raise on a non-zero ``cudaError_t`` returned by a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
