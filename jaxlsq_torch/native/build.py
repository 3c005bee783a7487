"""Compile-and-load of the host C++ libraries (port of ``jaxlsq/native/build.py``
and the loader's build in ``jaxlsq/native/loader.py``).

Each source (``lsq_ref.cpp``: the numeric oracle; ``loader.cpp``: the shard
loader) is built with ``g++`` into ``jaxlsq_torch/_build/`` (not tracked by
git) at first use, under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library never loads.
``lsq_ref.cpp`` is built with OpenMP where the toolchain has it (a compile
probe, as the JAX package's build).  A failed build raises with the
compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List

__all__ = ["build_library", "load_library", "is_available"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_OUT = os.path.join(os.path.dirname(_HERE), "_build")
# name -> (source, flags beside -O3 -shared -fPIC -std=c++17, ABI version)
_LIBS = {"lsqref": ("lsq_ref.cpp", [], ("lsq_native_abi_version", 1)),
         "jlloader": ("loader.cpp", ["-pthread"], ("jl_loader_abi_version", 1))}
_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _openmp() -> List[str]:
    probe = subprocess.run(["g++", "-fopenmp", "-E", "-x", "c++", os.devnull, "-o",
                            os.devnull], capture_output=True)
    return ["-fopenmp"] if probe.returncode == 0 else []


def build_library(name: str = "lsqref") -> str:
    """Compile the ``name`` library (``'lsqref'`` or ``'jlloader'``) if it is
    not built yet; returns the path of the ``.so``."""
    src_name, extra, _ = _LIBS[name]
    src = os.path.join(_HERE, src_name)
    flags = ["-O3", "-shared", "-fPIC", "-std=c++17"] + extra
    if name == "lsqref":
        flags += _openmp()
    h = hashlib.sha256(" ".join(flags).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out = os.path.join(_OUT, f"lib{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(_OUT, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = ["g++", *flags, src, "-o", tmp]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, out)  # another process building the same name writes the same file
    return out


def load_library(name: str = "lsqref") -> ctypes.CDLL:
    """Build (if needed) and load the ``name`` library; the handle is kept."""
    with _lock:
        if name not in _loaded:
            lib = ctypes.CDLL(build_library(name))
            abi_fn, abi = _LIBS[name][2]
            got = getattr(lib, abi_fn)()
            if got != abi:
                raise RuntimeError(f"native library {name}: ABI {got}, expected {abi}")
            _loaded[name] = lib
        return _loaded[name]


def is_available(name: str = "lsqref") -> bool:
    """Whether the library builds and loads here (a build error is raised by
    :func:`load_library`; this only asks)."""
    try:
        load_library(name)
        return True
    except (RuntimeError, OSError):
        return False
