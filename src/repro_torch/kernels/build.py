"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (``nvcc -gencode arch=compute_90a,code=sm_90a``), in
``src/repro_torch/_build/`` (listed in ``.gitignore``). A library is named
after a hash of its source, of every shared header ``csrc/*.cuh`` and of
the flags, so an edited source or header rebuilds and an unchanged one is
reused. Nothing is built on import: the first call that
needs a library builds it, and ``build_all`` builds every source at once
with one nvcc process each, all started together.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("seq_policy_matmul", "nm_seq_policy_matmul", "nm_expand_seq",
           "sort_matmul", "sorted_stream", "nm_sort_matmul", "nm_expand_sort",
           "nm_expand_pass2", "quant_matmul")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
# name -> {"seconds": wall time of its nvcc, "log": nvcc's output}
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or CUDA_HOME set)")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every named source not built yet, in parallel; raise with
    nvcc's output if one fails. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    todo = [n for n, t in targets.items() if not t.exists()]
    if todo:
        nvcc = _nvcc()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            tmp = targets[n].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            BUILD_INFO[n] = {"seconds": time.perf_counter() - t0, "log": log}
            if proc.returncode != 0:
                failed.append(f"--- {n} (exit {proc.returncode})\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                tmp.replace(targets[n])  # atomic: no half-written library
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def kernel_label(mangled: str) -> str:
    """``name<args>`` of a mangled kernel name: its integer, bool and class
    template arguments (``mma_kernel<1,KnRows,WholeK>``,
    ``nm_sums_few_rows_kernel<4,true>``)."""
    found = re.search(r"\d([a-z][a-z_]*_kernel)(?:I(.*?)EEv)?", mangled)
    if not found:
        return mangled
    args = [i or ("true" if b == "1" else "false" if b else c)
            for i, b, c in re.findall(r"Li(\d+)E|Lb([01])E|\d([A-Z]\w*?)E",
                                      found[2] or "")]
    return f"{found[1]}<{','.join(args)}>" if args else found[1]


def register_report(log: str) -> list[tuple[str, str, str]]:
    """(kernel label, registers, spill stores/loads) for each entry
    function in nvcc's ``-Xptxas -v`` output."""
    rows, kernel = [], None
    for line in log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            kernel = kernel_label(entry[1])
            spilled = "?"
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and kernel:
            spilled = f"{spill[1]}/{spill[2]}"
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            rows.append((kernel, regs[1], spilled))
            kernel = None
    return rows


def sass_opcodes(name: str, label: str) -> dict[str, int]:
    """How often each SASS opcode (with its modifiers, e.g.
    ``VIMNMX.S16x2``) occurs in the kernel of ``csrc/<name>.cu`` whose
    ``kernel_label`` is ``label``, by ``cuobjdump -sass`` of the built
    library; empty where the kernel is not found."""
    tool = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build_all((name,))[name])],
                          capture_output=True, text=True, check=True).stdout
    counts: dict[str, int] = {}
    inside = False
    for line in sass.splitlines():
        func = re.search(r"Function : (\w+)", line)
        if func:
            inside = kernel_label(func[1]) == label
            continue
        op = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                       line)
        if inside and op:
            counts[op[1]] = counts.get(op[1], 0) + 1
    return counts


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        _LIBS[name] = lib
    return lib
