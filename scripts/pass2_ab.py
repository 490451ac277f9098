#!/usr/bin/env python3
"""Same-call A/B of pass 2 of the two-pass `sorted_tiled`: the dense kernel
(row 12, ``csrc/sorted_stream.cu``) and its gather twin (row 14,
``csrc/nm_sort_matmul.cu``), both on the block body of ``csrc/pass2.cuh``.

    python3 scripts/pass2_ab.py [--variants base,lt16,...]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is a copy of ``src/repro_torch/csrc`` with a few lines
replaced (``scripts/int8_mma_ab.build_variants``), built with the port's
nvcc flags into ``src/repro_torch/_build/pass2_ab/<variant>/``, all in
parallel. Each variant's rows 12 and 14 are first checked equal to their
plain versions (M 1 and 5, K 1000 and 8960, rounds 0 to 2), then timed by
``chip_smoke.time_launches`` at qwen2-1.5b's w_out (N 1536, K 8960, k_tile
256, acc_bits 16, one round) at M = 4 and 128: row 12 on a random weight
and on the weight as served (8:16-pruned, stored dense), row 14 on its
8:16 slabs; the variants in order and then in reverse order, the mean of
the two passes printed (ms).
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

OUT = ROOT / "src" / "repro_torch" / "_build" / "pass2_ab"
SOURCES = ("sorted_stream", "nm_sort_matmul")
KERNELS = ("row 12", "row 12 [8:16]", "row 14")
KT = 256

LANES = ("constexpr int kPairLanes = 16;", "constexpr int kPairLanes = {};")
# the most warps a block: row 12's (8 shipped), row 14's (16 shipped)
WARPS = {"sorted_stream.cu": "constexpr int kPairWarps = 8;",
         "nm_sort_matmul.cu": "constexpr int kRowsPairWarps = 16;"}


def lanes(n):
    """A sort tile on n lanes, 32 / n pair slots a warp step (both rows;
    16 shipped)."""
    return {src: [(LANES[0], LANES[1].format(n))]
            for src in ("sorted_stream.cu", "nm_sort_matmul.cu")}


def warps(src, n):
    """At most n warps a block in ``src``."""
    old = WARPS[src]
    return {src: [(old, old[:old.rindex("=") + 1] + f" {n};")]}


VARIANTS = {
    "base": {},
    "lt32": lanes(32),
    "lt8": lanes(8),
    "r12_warps16": warps("sorted_stream.cu", 16),
    "r14_warps8": warps("nm_sort_matmul.cu", 8),
    # row 12 asks one block an SM of the register allocator, as row 14
    # does; row 14 leaves it its own target, as row 12 does
    "r12_min_blocks1": {"sorted_stream.cu": [(
        "__launch_bounds__(32 * kPairWarps)",
        "__launch_bounds__(32 * kPairWarps, 1)")]},
    "r14_own_bounds": {"nm_sort_matmul.cu": [(
        "__launch_bounds__(32 * kRowsPairWarps, 1)",
        "__launch_bounds__(32 * kRowsPairWarps)")]},
    # the directions of pqs::pairwise_round2 (a select a compare-exchange
    # where a level's direction follows the lane), not folded into the keys
    "unfolded": {"pass2.cuh": [(
        "  for (int rd = 0; rd < rounds; ++rd) pairwise_round_folded<E, LT>"
        "(v, l);",
        "  for (int rd = 0; rd < rounds; ++rd) pqs::pairwise_round2<E, LT>"
        "(v, l);")]},
    # the saturating adds and the pair round without add-then-max
    "no_addmax": {"pass2.cuh": [
        ("    out[r] = __viaddmax_s16x2(v[r], m, m);",
         "    out[r] = pqs::add2(pqs::max2(v[r], 0u), m);"),
        (("  return Clamp{f.c + v, min(__viaddmax_s32(f.lo, v, qmin), qmax),",
          "               min(__viaddmax_s32(f.hi, v, qmin), qmax)};"),
         "  return pqs::clamp_then(f, pqs::clamp_step(v, qmin, qmax));"),
        (("  const int lo = __viaddmax_s32(f.lo, g.c, g.lo);",
          "  return Clamp{f.c + g.c, min(lo, hi), hi};"),
         "  return pqs::clamp_then(f, g);")]},
    # row 12 sorts every tile on the network of k_tile keys
    "dense_net": {"sorted_stream.cu": [(
        "pass2::block_rows<E, LT, true>(",
        "pass2::block_rows<E, LT, false>(")]},
}


def print_registers(names):
    """Registers and local memory of each variant's pass-2 kernels
    (``cuobjdump -res-usage``)."""
    import re
    import subprocess

    from repro_torch.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    for name in names:
        for src in SOURCES:
            out = subprocess.run(
                [str(tool), "-res-usage", str(OUT / name / f"lib{src}.so")],
                capture_output=True, text=True).stdout
            kernel = None
            for line in out.splitlines():
                func = re.search(r"Function (\w+):", line)
                if func:
                    kernel = build.kernel_label(func[1])
                    continue
                use = re.search(r"REG:(\d+).*?STACK:(\d+).*?LOCAL:(\d+)",
                                line)
                if use and kernel and "paired_rows" in kernel and (
                        use[2] != "0" or ",16>" in kernel):
                    print(f"  {name}: {kernel} {use[1]} registers, stack "
                          f"{use[2]}, local {use[3]} bytes", flush=True)


def load_variant(torch, cs, ss, name):
    """A variant's {kernel: callable(x, w or (vals, idx), perm)}, each
    checked equal to its plain version first."""
    from int8_mma_ab import c_fn
    from repro_torch.core.sorted_accum import pair_permutation

    libs = {src: ctypes.CDLL(str(OUT / name / f"lib{src}.so"))
            for src in SOURCES}
    dense = c_fn(libs["sorted_stream"], "pqs_paired_accum", 4, 7)
    gather = c_fn(libs["nm_sort_matmul"], "pqs_nm_gather_paired_accum", 5,
                  10)
    stream = torch.cuda.current_stream().cuda_stream

    def row12(x, w, perm, rounds=1):
        (m, k), n = x.shape, w.shape[0]
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        kp = k + (-k) % KT
        if dense(x.data_ptr(), w.data_ptr(), perm.data_ptr(), out.data_ptr(),
                 m, n, k, kp, 16, rounds, KT, stream):
            raise SystemExit(f"{name}: row 12 launch failed")
        return out

    def row14(x, slabs, perm, rounds=1):
        vals, idx = slabs
        (m, k), (n, g, n_keep) = x.shape, vals.shape
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        kp = g * cs.M_GROUP + (-g * cs.M_GROUP) % KT
        if gather(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                  perm.data_ptr(), out.data_ptr(), m, n, k, g, n_keep,
                  cs.M_GROUP, kp, 16, rounds, KT, stream):
            raise SystemExit(f"{name}: row 14 launch failed")
        return out

    for k in (1000, 8960):
        for m in (1, 5):
            x, w, vals, idx = cs.nm_operands(torch, m, 45, k, m + k)
            kp = k + (-k) % KT
            for weight in (w, cs.operands(torch, m, 45, k, k)[1]):
                perm = pair_permutation(ss.tile_sums_matmul(
                    x, weight, k_tile=KT, kp=kp)).to(torch.int32)
                for rounds in (0, 1, 2):
                    want = ss.paired_accum_matmul_ref(
                        x, weight, perm, acc_bits=16, k_tile=KT,
                        rounds=rounds, kp=kp)
                    if not torch.equal(row12(x, weight, perm, rounds), want):
                        raise SystemExit(f"{name}: row 12 wrong at K={k} "
                                         f"M={m} rounds={rounds}")
            perm = pair_permutation(ss.nm_gather_tile_sums(
                x, vals, idx, k_tile=KT, m_group=cs.M_GROUP)).to(torch.int32)
            for rounds in (0, 1, 2):
                want = ss.nm_gather_paired_accum_matmul_ref(
                    x, vals, idx, perm, m_group=cs.M_GROUP, acc_bits=16,
                    k_tile=KT, rounds=rounds)
                if not torch.equal(row14(x, (vals, idx), perm, rounds), want):
                    raise SystemExit(f"{name}: row 14 wrong at K={k} M={m} "
                                     f"rounds={rounds}")
    return {"row 12": row12, "row 12 [8:16]": row12, "row 14": row14}


def operands(torch, cs, ss, m):
    """w_out's operands at M = m for each kernel: (x, weight, perm)."""
    from repro_torch.core.sorted_accum import pair_permutation

    n, k = cs.SITES["w_out"]
    x, wp, vals, idx = cs.nm_operands(torch, m, n, k, 13)
    w = cs.operands(torch, m, n, k, 11)[1]
    out = {}
    for key, weight in (("row 12", w), ("row 12 [8:16]", wp)):
        out[key] = (x, weight, pair_permutation(ss.tile_sums_matmul(
            x, weight, k_tile=KT)).to(torch.int32))
    out["row 14"] = (x, (vals, idx), pair_permutation(ss.nm_gather_tile_sums(
        x, vals, idx, k_tile=KT, m_group=cs.M_GROUP)).to(torch.int32))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    import torch

    import chip_smoke as cs
    from int8_mma_ab import build_variants
    from repro_torch.kernels import sorted_stream as ss

    if not torch.cuda.is_available():
        print("pass2_ab: no CUDA device", file=sys.stderr)
        return 2
    build_variants(names, VARIANTS, SOURCES, OUT)
    print(cs.card_line(), flush=True)
    print_registers(names)
    fns = {name: load_variant(torch, cs, ss, name) for name in names}
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    ops = {m: operands(torch, cs, ss, m) for m in (4, 128)}
    total = {}
    for name in names + names[::-1]:
        for m, cases in ops.items():
            for kernel, (x, weight, perm) in cases.items():
                ms = cs.time_launches(
                    torch, lambda: fns[name][kernel](x, weight, perm), 10,
                    flush_buf)
                key = (kernel, m, name)
                total[key] = total.get(key, 0.0) + ms / 2
    for m in ops:
        for kernel in KERNELS:
            cells = "  ".join(f"{name} {total[(kernel, m, name)]:.4f}"
                              for name in names)
            print(f"{kernel:14s} ms at M={m:3d}: {cells}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
