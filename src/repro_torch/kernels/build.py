"""Build the port's CUDA sources into shared libraries and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` inside the
package (the hash is the source's content, so an edited source rebuilds).
Libraries are loaded with ``ctypes``, each C entry's ``argtypes`` and
``restype`` set from its prototype in the source's ``extern "C"`` block
(`entries`): the source is the only statement of a signature.  Nothing is
built when a module is imported: the first launch of a kernel builds it,
and ``build_all`` builds every source at once, one ``nvcc`` process each,
all started together.
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
from typing import Dict, List, Sequence, Tuple

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD = PKG / "build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}

# C parameter types as ctypes passes them (any pointer is a c_void_p), and
# the return types an entry may have
_ARG_TYPES = {"int": ctypes.c_int, "unsigned": ctypes.c_uint,
              "long long": ctypes.c_longlong, "float": ctypes.c_float}
_RETURN_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
                 "const char*": ctypes.c_char_p}
_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_PROTOTYPE = re.compile(r"\s*(.*?)\s*\b(\w+)\s*\((.*)\)\s*", re.S)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to (content-addressed)."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(ARCH_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build_all(names: Sequence[str]) -> Dict[str, Path]:
    """Build every named source that is not built yet, one ``nvcc`` each,
    all in parallel.  The compiler's ``-Xptxas -v`` report lands beside
    each library as ``<lib>.log``.  Raises with the compiler's output when
    any build fails."""
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {n: library_path(n) for n in names}
    procs = []
    for name, lib in out.items():
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, proc in procs:
        log, _ = proc.communicate()
        lib.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)       # atomic: a concurrent build is safe
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def _c_type(name: str, entry: str, spelled: str, table: dict):
    got = table.get(spelled)
    if got is None:
        raise ValueError(f"csrc/{name}.cu: {entry} has a {spelled!r}, which "
                         f"maps to no ctypes type")
    return got


def entries(name: str) -> Dict[str, Tuple[object, List[object]]]:
    """The C entries of ``csrc/<name>.cu``: each function of its
    ``extern "C"`` block, by name, as (restype, argtypes).  Any pointer
    passes as ``c_void_p``; ``int``, ``unsigned``, ``long long`` and
    ``float`` as their ctypes; an entry returns ``int``, ``long long`` or
    ``const char*``.  Raises ``ValueError`` naming the source and the entry
    on any other type.  Reads the text only."""
    text = _COMMENT.sub(" ", (CSRC / f"{name}.cu").read_text())
    at = text.find('extern "C"')
    if at < 0:
        raise ValueError(f"csrc/{name}.cu has no extern \"C\" block")
    out, head, depth = {}, [], 0
    for ch in text[text.index("{", at) + 1:]:
        if depth:                       # inside a function's body
            depth += (ch == "{") - (ch == "}")
        elif ch == "}":                 # the block's end
            break
        elif ch in "{;":                # a definition's or declaration's head
            got = _PROTOTYPE.fullmatch("".join(head))
            if got is None:
                raise ValueError(f"csrc/{name}.cu: no C prototype in "
                                 f"{''.join(head).strip()!r}")
            ret, entry, params = got.groups()
            argtypes = []
            for param in filter(None, (p.strip() for p in params.split(","))):
                if "*" in param:
                    argtypes.append(ctypes.c_void_p)
                elif param != "void":
                    words = [w for w in param.split() if w != "const"]
                    argtypes.append(_c_type(name, entry, " ".join(words[:-1]),
                                            _ARG_TYPES))
            ret = re.sub(r"\s*\*", "*", " ".join(ret.split()))
            out[entry] = (_c_type(name, entry, ret, _RETURN_TYPES), argtypes)
            head, depth = [], int(ch == "{")
        else:
            head.append(ch)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use, every
    C entry's signature set from the source (`entries`)."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            signatures = entries(name)
            lib = ctypes.CDLL(str(build_all([name])[name]))
            for entry, (restype, argtypes) in signatures.items():
                fn = getattr(lib, entry)
                fn.restype, fn.argtypes = restype, argtypes
            _loaded[name] = lib
        return lib
