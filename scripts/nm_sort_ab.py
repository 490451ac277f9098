#!/usr/bin/env python3
"""Same-call A/B of the one-pass gather kernel of the N:M global-sort
policies (row 8, ``csrc/nm_sort_matmul.cu``) and the expand twin's pass 2
(row 13, ``csrc/nm_expand_pass2.cu``).

    python3 scripts/nm_sort_ab.py [--variants base,p2_nolb,...]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is a copy of ``src/repro_torch/csrc`` with a few lines
replaced (``scripts/int8_mma_ab.build_variants``), built with the port's
nvcc flags into ``src/repro_torch/_build/nm_ab/<variant>/``, all in
parallel. Each variant's row 8 (both policies) and row 13 are first
checked equal to their plain versions on canonical 8:16 slabs, then timed
by ``chip_smoke.time_launches`` at decode (M = 4, acc_bits 16, one round,
k_tile 256): row 8 summed over qwen2-1.5b's six K = 1536 sites, row 13 at
w_out, beside row 14 (the gather pass 2) at w_out; the variants in order
and then in reverse order, the mean of the two passes printed (ms).
``p2_nomerge`` skips the merge of slots that name one position, so it is
right on canonical slabs only: it times the merge's cost.
``p2_loadscan`` reads each slot's group from device memory instead of
from its warp mates.
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

OUT = ROOT / "src" / "repro_torch" / "_build" / "nm_ab"
SOURCES = ("nm_sort_matmul", "nm_expand_pass2")
KERNELS = ("row 8 sorted_tiled", "row 8 sorted", "row 13", "row 14")

VARIANTS = {
    "base": {},
    # row 13: the block's register budget left to the compiler
    "p2_nolb": {"nm_expand_pass2.cu": [(
        "__global__ void __launch_bounds__(32 * kPassTwoWarps)\n"
        "    nm_expand_paired_kernel(",
        "__global__ void\n    nm_expand_paired_kernel(")]},
    # row 13: 2 rows of x a block, up to 8 warps an output
    "p2_rows2": {"nm_expand_pass2.cu": [(
        "constexpr int kRows = 4;", "constexpr int kRows = 2;")]},
    # row 13: no merge of slots at one position (canonical slabs only)
    "p2_nomerge": {"nm_expand_pass2.cu": [(
        ("    for (int i = 0; i < n_keep; ++i) {\n      const int2 s = at(i);",
         "        sum += s.y;\n      }\n    }\n"),
        "    sum = at(q - g * n_keep).y;\n")]},
    # row 13: each slot's group read from device memory, not its mates
    "p2_loadscan": {"nm_expand_pass2.cu": [(
        "  if (32 % n_keep == 0) {", "  if (false) {")]},
    # row 8: 2 rows of x a block
    "r8_rows2": {"nm_sort_matmul.cu": [(
        "constexpr int kRows = 4;", "constexpr int kRows = 2;")]},
}


def load_variant(torch, cs, nm, ss, name):
    """A variant's {kernel: callable(x, vals, idx, perm)} at the decode
    settings, each checked equal to its plain version first."""
    from int8_mma_ab import c_fn

    libs = {src: ctypes.CDLL(str(OUT / name / f"lib{src}.so"))
            for src in SOURCES}
    sort = c_fn(libs["nm_sort_matmul"], "pqs_nm_gather_sort_matmul", 4, 11)
    pass2 = c_fn(libs["nm_sort_matmul"], "pqs_nm_gather_paired_accum", 5, 10)
    expand2 = c_fn(libs["nm_expand_pass2"], "pqs_nm_expand_paired_accum", 5,
                   10)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, policy=None):
        def run(x, vals, idx, perm):
            (m, k), (n, g, n_keep) = x.shape, vals.shape
            out = torch.empty((m, n), dtype=torch.int32, device="cuda")
            if policy is None:
                kp = g * cs.M_GROUP + (-g * cs.M_GROUP) % 256
                err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                         perm.data_ptr(), out.data_ptr(), m, n, k, g, n_keep,
                         cs.M_GROUP, kp, 16, 1, 256, stream)
            else:
                kp = 1 << (g * cs.M_GROUP - 1).bit_length() \
                    if policy == 0 else g * cs.M_GROUP
                err = fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(),
                         out.data_ptr(), m, n, k, g, n_keep, cs.M_GROUP, kp,
                         policy, 16, 1, 256, stream)
            if err:
                raise SystemExit(f"{name}: launch failed ({err})")
            return out
        return run

    fns = {"row 8 sorted_tiled": call(sort, 1), "row 8 sorted": call(sort, 0),
           "row 13": call(expand2), "row 14": call(pass2)}
    from repro_torch.core.sorted_accum import pair_permutation

    kw = dict(m_group=cs.M_GROUP, acc_bits=16, rounds=1)
    for site, (n, k) in cs.SITES.items():
        for m in (1, 5):
            x, _, vals, idx = cs.nm_operands(torch, m, n, k, m + n + k)
            perm = pair_permutation(ss.nm_gather_tile_sums_ref(
                x, vals, idx, k_tile=256, m_group=cs.M_GROUP)).to(torch.int32)
            want = {
                "row 8 sorted_tiled": nm.nm_gather_sort_matmul_ref(
                    x, vals, idx, policy="sorted_tiled", k_tile=256, **kw),
                "row 8 sorted": nm.nm_gather_sort_matmul_ref(
                    x, vals, idx, policy="sorted", **kw),
                "row 13": ss.nm_paired_accum_matmul_ref(
                    x, vals, idx, perm, k_tile=256, **kw),
                "row 14": ss.nm_gather_paired_accum_matmul_ref(
                    x, vals, idx, perm, k_tile=256, **kw)}
            for kernel, fn in fns.items():
                if not torch.equal(fn(x, vals, idx, perm), want[kernel]):
                    raise SystemExit(f"{name}: {kernel} wrong at {site} "
                                     f"M={m}")
    return fns


def time_variant(torch, cs, ss, fns, flush_buf):
    """One variant's ms: row 8 over the six K = 1536 sites, rows 13 and 14
    at w_out, M = 4."""
    from repro_torch.core.sorted_accum import pair_permutation

    total = dict.fromkeys(KERNELS, 0.0)
    for site, (n, k) in cs.SITES.items():
        x, _, vals, idx = cs.nm_operands(torch, 4, n, k, 13)
        perm = pair_permutation(ss.nm_gather_tile_sums(
            x, vals, idx, k_tile=256, m_group=cs.M_GROUP)).to(torch.int32)
        kernels = KERNELS[2:] if k > 4096 else KERNELS[:2]
        for kernel in kernels:
            total[kernel] += cs.time_launches(
                torch, lambda: fns[kernel](x, vals, idx, perm), 10,
                flush_buf)
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    import torch

    import chip_smoke as cs
    from int8_mma_ab import build_variants
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import sorted_stream as ss

    if not torch.cuda.is_available():
        print("nm_sort_ab: no CUDA device", file=sys.stderr)
        return 2
    build_variants(names, VARIANTS, SOURCES, OUT)
    print(cs.card_line(), flush=True)
    fns = {name: load_variant(torch, cs, nm, ss, name) for name in names}
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    total = {}
    for name in names + names[::-1]:
        for key, ms in time_variant(torch, cs, ss, fns[name],
                                    flush_buf).items():
            total[(key, name)] = total.get((key, name), 0.0) + ms / 2
    for kernel in KERNELS:
        cells = "  ".join(f"{name} {total[(kernel, name)]:.4f}"
                          for name in names)
        print(f"{kernel:18s} ms at M=4: {cells}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
