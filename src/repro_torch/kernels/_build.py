"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` becomes ``_build/<name>-<hash>.so``, a shared
library with a plain C interface, loaded with ``ctypes``.  The hash covers
the source and the flags, so an edited source is rebuilt and a stale
library is never loaded.  ``build`` starts one ``nvcc`` per missing
library, all at once, and waits for all of them.

Nothing here runs at import time, so the package imports on a machine
without CUDA.  A failed build raises; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

#: every kernel source of the package, by library name
SOURCES = ("bitplane", "jacobi_mars", "kvpack", "flash_attention",
           "flash_attention_sm90")

#: sm_90a keeps Hopper-only instructions available; no --use_fast_math, so
#: float division stays IEEE (the jacobi update divides by 3, the KV
#: quantizer by qmax and by the row scale)
NVCC_FLAGS = ("-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-gencode", "arch=compute_90a,code=sm_90a", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME
    for home in (os.environ.get("CUDA_HOME"), CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; return each compiler log.

    The log holds ``ptxas -v``'s registers and shared memory per kernel.
    Raises ``RuntimeError`` naming each source that failed to compile.
    """
    names = tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode == 0:
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(logs[name])
        else:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{logs[name]}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for name in names:
        if name not in logs:
            log = lib_path(name).with_suffix(".log")
            logs[name] = log.read_text() if log.exists() else ""
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    lib = _libs.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build([name])
        lib = _libs[name] = ctypes.CDLL(str(lib_path(name)))
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (refused or failed launch)."""
    if err != 0:
        msg = lib.kernel_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err}: {msg}")


def ptxas_by_kernel(log: str) -> dict:
    """ptxas -v's registers, static shared memory, stack and spill bytes for
    each entry function."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name and "spill stores" in ln:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", ln)]
            out[name].update(stack_bytes=nums[0], spill_store_bytes=nums[1],
                             spill_load_bytes=nums[2])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(re.search(r"Used (\d+) registers", ln).group(1))
            m = re.search(r"(\d+) bytes smem", ln)
            out[name]["static_smem_bytes"] = int(m.group(1)) if m else 0
    return out


def sass_opcodes(lib: Path) -> dict:
    """Static SASS of each kernel of a library: its instruction count, and
    the count of each opcode (the part before the first dot)."""
    cuobjdump = Path(nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            out[fn] = {"instructions": 0, "by_opcode": {}}
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", ln)
        if fn is not None and m:
            op = m.group(1)
            out[fn]["instructions"] += 1
            out[fn]["by_opcode"][op] = out[fn]["by_opcode"].get(op, 0) + 1
    return out

