#!/usr/bin/env python3
"""Same-call A/B of the wide kernels' mainloop (``csrc/int8_mma.cuh``).

    python3 scripts/int8_mma_ab.py [--variants base,no_build,...]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is a copy of ``src/repro_torch/csrc`` with a few lines
replaced, built with the port's nvcc flags into
``src/repro_torch/_build/ab/<variant>/`` (all variants compile in
parallel). Then rows 1 (``seq_policy_matmul`` under ``wide``), 3
(``quant_matmul``) and 4 (``nm_spmm``, 8:16 slabs) of every variant are
timed by ``chip_smoke.time_launches`` at the 7 qwen2-1.5b projection
sites at M = 4, 64 and 128, the variants in order and then in reverse
order, and the mean of the two passes is printed summed over the sites
(ms). ``no_build`` skips row 4's build of its weight tile, so its row 4
results are wrong: it times the copies and the mmas alone.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "src" / "repro_torch" / "_build" / "ab"

# variant -> {file: [(text, replacement)]}
VARIANTS = {
    "base": {},
    "no_build": {"quant_matmul.cu": [(
        "    const int m_group = 1 << lm;\n",
        "    if (n0 >= 0) return;  // no build: timing only\n"
        "    const int m_group = 1 << lm;\n")]},
    "stages4": {"int8_mma.cuh": [(
        "kStages = MT == 1 ? 3 : 4;", "kStages = 4;")]},
    "wave_uncapped": {"int8_mma.cuh": [(
        "std::min(resident_blocks<MT, W>(smem), MT == 1 ? 4 : 2)",
        "resident_blocks<MT, W>(smem)")]},
}


def build_variants(names):
    """Compile quant_matmul.cu and seq_policy_matmul.cu of each variant;
    returns {(variant, source): ctypes.CDLL}."""
    from repro_torch.kernels import build

    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name in names:
        tree = OUT / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(CSRC, tree)
        for fname, pairs in VARIANTS[name].items():
            text = (tree / fname).read_text()
            for old, new in pairs:
                if old not in text:
                    raise SystemExit(f"{name}: {fname} has no {old!r}")
                text = text.replace(old, new)
            (tree / fname).write_text(text)
        for src in ("quant_matmul", "seq_policy_matmul"):
            procs[(name, src)] = subprocess.Popen(
                [build._nvcc(), *flags, "-o", str(tree / f"lib{src}.so"),
                 str(tree / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {src}:\n{log}")
        libs[(name, src)] = ctypes.CDLL(str(OUT / name / f"lib{src}.so"))
    return libs


def c_fn(lib, symbol, n_ptrs, n_ints):
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    names = ap.parse_args().variants.split(",")
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("int8_mma_ab: no CUDA device", file=sys.stderr)
        return 2
    libs = build_variants(names)
    print(cs.card_line(), flush=True)
    stream = torch.cuda.current_stream().cuda_stream
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    sites = {site: cs.nm_operands(torch, 128, n, k, 15)
             for site, (n, k) in cs.SITES.items()}
    total = {}
    for order in (names, names[::-1]):
        for name in order:
            row1 = c_fn(libs[(name, "seq_policy_matmul")],
                        "pqs_seq_policy_matmul", 3, 7)
            row3 = c_fn(libs[(name, "quant_matmul")], "pqs_quant_matmul",
                        3, 3)
            row4 = c_fn(libs[(name, "quant_matmul")], "pqs_nm_spmm", 4, 6)
            for site, (n, k) in cs.SITES.items():
                x, w_nk, vals, idx = sites[site]
                w_kn = w_nk.t().contiguous()
                g = vals.shape[1]
                for m in (4, 64, 128):
                    xm = x[:m]
                    out = torch.empty((m, n), dtype=torch.int32,
                                      device="cuda")
                    calls = {
                        "row 1 wide": lambda: row1(
                            xm.data_ptr(), w_nk.data_ptr(), out.data_ptr(),
                            m, n, k, 0, 16, 1, 256, stream),
                        "row 3": lambda: row3(
                            xm.data_ptr(), w_kn.data_ptr(), out.data_ptr(),
                            m, n, k, stream),
                        "row 4": lambda: row4(
                            xm.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                            out.data_ptr(), m, n, k, g, cs.N_KEEP,
                            cs.M_GROUP, stream),
                    }
                    for kernel, fn in calls.items():
                        ms = cs.time_launches(torch, fn, 10, flush_buf)
                        key = (kernel, m, name)
                        total[key] = total.get(key, 0.0) + ms / 2
    for kernel in ("row 1 wide", "row 3", "row 4"):
        for m in (4, 64, 128):
            cells = "  ".join(f"{name} {total[(kernel, m, name)]:.4f}"
                              for name in names)
            print(f"{kernel:10s} M={m:3d} ms over the 7 sites: {cells}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
