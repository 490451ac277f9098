#!/usr/bin/env python3
"""Same-call A/B of the wide kernels (``csrc/int8_mma.cuh`` and the
TMA-fed body of ``csrc/quant_matmul.cu``) and of row 6's sort tile
(``csrc/nm_seq_policy_matmul.cu``).

    python3 scripts/int8_mma_ab.py [--variants base,tma_mma_sync,...]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is a copy of ``src/repro_torch/csrc`` with a few lines
replaced, built with the port's nvcc flags into
``src/repro_torch/_build/ab/<variant>/`` (all variants compile in
parallel). Then rows 1 (``seq_policy_matmul`` under ``wide``), 3
(``quant_matmul`` on its TMA-fed body, and on its KnRows body as ``row 3
kn_rows``), 4 (``nm_spmm``, 8:16 slabs) and 6
(``nm_gather_seq_policy_matmul``, 8:16 slabs, ``sorted_tiled_seq`` at
k_tile 256, one round, acc_bits 16) of every variant are timed by
``chip_smoke.time_launches`` at the 7 qwen2-1.5b projection sites at M =
4, 64 and 128, every variant loaded into this one process (each build's
kernels and their set-up have internal linkage, so the builds stay
apart), the variants in order and then in reverse order; the mean of the
two passes is printed summed over the sites (ms). Rows 3 and 6 of each
variant are first checked equal to their plain versions at the 7 sites
(row 3 at M = 1, 5, 17 and 200, row 6 at M = 1 and 5). ``no_build`` skips
row 4's build of its weight tile, so its row 4 results are wrong: it
times the copies and the mmas alone.
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
SOURCES = ("quant_matmul", "seq_policy_matmul", "nm_seq_policy_matmul")
MS = (4, 64, 128)
KERNELS = ("row 1 wide", "row 3", "row 3 kn_rows", "row 4", "row 6")
# row 6's policy (sorted_matmul.SEQ_POLICIES: sorted_tiled_seq), acc_bits,
# rounds and k_tile
ROW6 = dict(policy=3, acc_bits=16, rounds=1, k_tile=256)

# The TMA-fed body's consumer loop on mma.sync m16n8k32 (the same swapped
# operands; x's fragments by ldmatrix) in place of its wgmma loop.
MMA_SYNC_LOOP = r"""    for (int i = 0; i < slabs; ++i) {
      const int st = i % kStages;
      mbar_wait(&full[st], (i / kStages) & 1);
      const uint8_t* w = ring + st * Tile<MN>::kStage;
      const uint8_t* xs = w + kWBytes;
#pragma unroll
      for (int s = 0; s < kBK / 32; ++s) {
        uint32_t a[2][4];
        build_a(a, w, 32 * s, col, t);
        // ldmatrix lanes 8 i .. 8 i + 7 address matrix i: rows 8 (j +
        // i / 2) + (lane & 7) at byte 32 s + 16 (i & 1)
        const int row = lane & 7, kb = 32 * s + 16 * ((lane >> 3) & 1);
#pragma unroll
        for (int j = 0; j < MN / 8; j += 2) {
          if constexpr (MN == 8) {
            uint32_t b[2];
            asm volatile(
                "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                : "=r"(b[0]), "=r"(b[1])
                : "r"(mma8::smem_addr(xs + swz(row, kb))));
#pragma unroll
            for (int tile = 0; tile < 2; ++tile)
              mma8::mma_s8(acc[tile][0], a[tile], b[0], b[1]);
          } else {
            uint32_t b[4];
            mma8::ldmatrix_x4(b, xs + swz(8 * (j + (lane >> 4)) + row, kb));
#pragma unroll
            for (int tile = 0; tile < 2; ++tile) {
              mma8::mma_s8(acc[tile][j], a[tile], b[0], b[1]);
              mma8::mma_s8(acc[tile][j + 1], a[tile], b[2], b[3]);
            }
          }
        }
      }
      mbar_arrive(&empty[st]);
    }
"""

# Row 6's sort tiles of 32 to 256 slots on 16 lanes of E = S / 16, two
# tiles a warp step (10 shuffle stages a sort of 128 keys), in place of
# 32 lanes of E = S / 32 (one tile a step, 15 stages).
GATHER_LT16 = """  const GatherLaunch fn{a, tile_len};
  switch (pqs::next_pow2(tile_len)) {
    case 32: fn.operator()<2, 16>(); break;
    case 64: fn.operator()<4, 16>(); break;
    case 128: fn.operator()<8, 16>(); break;
    case 256: fn.operator()<16, 16>(); break;
    default: return pqs::dispatch_tile(pqs::next_pow2(tile_len), fn);
  }
  return cudaGetLastError();
"""

# variant -> {file: [(text or (first line, last line), replacement)]}
VARIANTS = {
    "base": {},
    # the TMA-fed body's tensor-core instruction, its x rows above 32 and
    # its cluster of K splits (quant_matmul.cu's consumer loop, kMaxRows,
    # kMaxSplits)
    "tma_mma_sync": {"quant_matmul.cu": [(
        ("    // stage i + 1's A fragments are built while stage i's wgmmas",
         "      mbar_arrive(&empty[(i + 1) % kStages]);\n    }\n"),
        MMA_SYNC_LOOP)]},
    "rows64": {"quant_matmul.cu": [(
        "constexpr int kMaxRows = 128;", "constexpr int kMaxRows = 64;")]},
    "cluster16": {"quant_matmul.cu": [
        ("constexpr int kMaxSplits = 8;", "constexpr int kMaxSplits = 16;"),
        ("    if (err != cudaSuccess) return err;\n    configured = true;\n",
         "    if (err == cudaSuccess)\n"
         "      err = cudaFuncSetAttribute(\n"
         "          kn_tma_kernel<MN, true>,\n"
         "          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
         "    if (err != cudaSuccess) return err;\n    configured = true;\n")]},
    # the int8 mainloop (rows 1, 3 kn_rows, 4)
    "no_build": {"nm_chunks.cuh": [(
        "    const int m_group = 1 << lm;\n",
        "    if (n0 >= 0) return;  // no build: timing only\n"
        "    const int m_group = 1 << lm;\n")]},
    # row 6's tile shape (nm_seq_policy_matmul.cu's gather entry point)
    "gather_lt16": {"nm_seq_policy_matmul.cu": [(
        "  return pqs::dispatch_tile(pqs::next_pow2(tile_len),\n"
        "                            GatherLaunch{a, tile_len});\n",
        GATHER_LT16)]},
    "stages4": {"int8_mma.cuh": [(
        "kStages = MT == 1 ? 3 : 4;", "kStages = 4;")]},
    "wave_uncapped": {"int8_mma.cuh": [(
        "std::min(resident_blocks<MT, W, E>(smem), MT == 1 ? 4 : 2)",
        "resident_blocks<MT, W, E>(smem)")]},
}


def build_variants(names, variants=None, sources=SOURCES, out=OUT):
    """Compile the ``sources`` of each variant (``variants``, default
    ``VARIANTS``) into ``out``/<variant>, all in parallel."""
    from repro_torch.kernels import build

    variants = VARIANTS if variants is None else variants
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name in names:
        tree = out / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(CSRC, tree)
        for fname, pairs in variants[name].items():
            text = (tree / fname).read_text()
            for old, new in pairs:
                if isinstance(old, tuple):  # the lines first .. last
                    first, last = old
                    at = text.find(first)
                    end = text.find(last, at)
                    if at < 0 or end < 0:
                        raise SystemExit(f"{name}: {fname} has no {old!r}")
                    old = text[at:end + len(last)]
                if old not in text:
                    raise SystemExit(f"{name}: {fname} has no {old!r}")
                text = text.replace(old, new)
            (tree / fname).write_text(text)
        for src in sources:
            procs[(name, src)] = subprocess.Popen(
                [build._nvcc(), *flags, "-o", str(tree / f"lib{src}.so"),
                 str(tree / f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, src), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name} {src}:\n{log}")


def c_fn(lib, symbol, n_ptrs, n_ints):
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [
        ctypes.c_void_p]
    return fn


def load_variant(torch, cs, qm, nm, name):
    """A variant's (row1, run3, row4, run6) entry points, rows 3 and 6
    checked equal to their plain versions first."""
    libs = {src: ctypes.CDLL(str(OUT / name / f"lib{src}.so"))
            for src in SOURCES}
    row1 = c_fn(libs["seq_policy_matmul"], "pqs_seq_policy_matmul", 3, 7)
    row3 = c_fn(libs["quant_matmul"], "pqs_quant_matmul", 3, 4)
    row4 = c_fn(libs["quant_matmul"], "pqs_nm_spmm", 4, 6)
    row6 = c_fn(libs["nm_seq_policy_matmul"],
                "pqs_nm_gather_seq_policy_matmul", 4, 10)

    def run3(x, w, out, body):
        (m, k), n = x.shape, w.shape[1]
        if row3(x.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, k, body,
                torch.cuda.current_stream().cuda_stream):
            raise SystemExit(f"{name}: pqs_quant_matmul failed")
        return out

    def run6(x, vals, idx, out):
        (m, k), (n, g, n_keep) = x.shape, vals.shape
        if row6(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                out.data_ptr(), m, n, k, g, n_keep, cs.M_GROUP,
                *ROW6.values(), torch.cuda.current_stream().cuda_stream):
            raise SystemExit(f"{name}: pqs_nm_gather_seq_policy_matmul "
                             "failed")
        return out

    for site, (n, k) in cs.SITES.items():
        for m in (1, 5, 17, 200):
            x, wt = cs.operands(torch, m, n, k, m + n)
            w = wt.t().contiguous()
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            if not torch.equal(run3(x, w, out, 1), qm.quant_matmul_ref(x, w)):
                raise SystemExit(f"{name}: row 3 wrong at {site} M={m}")
        for m in (1, 5):
            x, _, vals, idx = cs.nm_operands(torch, m, n, k, m + n)
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            want = nm.nm_gather_seq_policy_matmul_ref(
                x, vals, idx, m_group=cs.M_GROUP, policy="sorted_tiled_seq",
                acc_bits=ROW6["acc_bits"], rounds=ROW6["rounds"],
                k_tile=ROW6["k_tile"])
            if not torch.equal(run6(x, vals, idx, out), want):
                raise SystemExit(f"{name}: row 6 wrong at {site} M={m}")
    return row1, run3, row4, run6


def time_variant(torch, cs, fns, flush_buf):
    """One variant's ms over the 7 sites, {"kernel M=m": ms}."""
    row1, run3, row4, run6 = fns
    stream = torch.cuda.current_stream().cuda_stream
    total = {}
    for site, (n, k) in cs.SITES.items():
        x, w_nk, vals, idx = cs.nm_operands(torch, 128, n, k, 15)
        w_kn = w_nk.t().contiguous()
        g = vals.shape[1]
        for m in MS:
            xm = x[:m]
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            calls = {
                "row 1 wide": lambda: row1(
                    xm.data_ptr(), w_nk.data_ptr(), out.data_ptr(), m, n, k,
                    0, 16, 1, 256, stream),
                "row 3": lambda: run3(xm, w_kn, out, 1),
                "row 3 kn_rows": lambda: run3(xm, w_kn, out, 0),
                "row 4": lambda: row4(
                    xm.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                    out.data_ptr(), m, n, k, g, cs.N_KEEP, cs.M_GROUP,
                    stream),
                "row 6": lambda: run6(xm, vals, idx, out),
            }
            for kernel, fn in calls.items():
                key = f"{kernel} M={m}"
                total[key] = total.get(key, 0.0) + cs.time_launches(
                    torch, fn, 10, flush_buf)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import quant_matmul as qm

    if not torch.cuda.is_available():
        print("int8_mma_ab: no CUDA device", file=sys.stderr)
        return 2
    build_variants(names)
    print(cs.card_line(), flush=True)
    fns = {name: load_variant(torch, cs, qm, nm, name) for name in names}
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    total = {}
    for name in names + names[::-1]:
        for key, ms in time_variant(torch, cs, fns[name], flush_buf).items():
            total[(key, name)] = total.get((key, name), 0.0) + ms / 2
    for kernel in KERNELS:
        for m in MS:
            cells = "  ".join(f"{name} {total[(f'{kernel} M={m}', name)]:.4f}"
                              for name in names)
            print(f"{kernel:14s} M={m:3d} ms over the 7 sites: {cells}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
