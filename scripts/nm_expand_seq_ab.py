#!/usr/bin/env python3
"""Same-call A/B of row 5, the expand kernel of the K-streaming policies on
N:M slabs (``nm_seq_policy_matmul``, ``csrc/nm_expand_seq.cu``).

    python3 scripts/nm_expand_seq_ab.py [--variants base,dense_tiles,...]

Run from the repository root on a machine with one CUDA card and nvcc.
Each variant is a copy of ``src/repro_torch/csrc`` with a few lines
replaced (``scripts/int8_mma_ab.build_variants``), built with the port's
nvcc flags into ``src/repro_torch/_build/expand_seq_ab/<variant>/``, all
in parallel. Each variant's row 5 is first checked equal to its plain
version (M 5 at wk, wq and w_out, under ``sorted_tiled_seq`` and
``clip``), then timed by ``chip_smoke.time_launches`` at qwen2-1.5b's 7
projection sites (8:16 slabs, acc_bits 16, k_tile 256, one round) at M = 4
and 128 under both policies; the variants in order and then in reverse
order, the mean of the two passes printed summed over the sites (ms).
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

OUT = ROOT / "src" / "repro_torch" / "_build" / "expand_seq_ab"
SOURCES = ("nm_expand_seq",)
# the policies timed, by their number in the C entry point
POLICIES = {"sorted_tiled_seq": 3, "clip": 1}
SRC = "nm_expand_seq.cu"

VARIANTS = {
    "base": {},
    # every tile taken on its dense positions, not its listed nonzero ones
    "dense_tiles": {SRC: [(
        "  const bool compact = keys < tile;",
        "  const bool compact = false;")]},
    # pqs_accum.cuh's network, its directions a select where they follow
    # the lane
    "unfolded": {SRC: [(
        "              pass2::pairwise_round_folded<E, LT>(v, l);",
        "              pqs::pairwise_round2<E, LT>(v, l);")]},
    # the saturating adds without add-then-max
    "no_addmax": {SRC: [
        ("            lo = pass2::then_step(lo, pqs::lo16(v[r]), qmin, qmax);\n"
         "            hi = pass2::then_step(hi, pqs::hi16(v[r]), qmin, qmax);",
         "            lo = pqs::clamp_then(lo, pqs::clamp_step(pqs::lo16(v[r]),"
         " qmin, qmax));\n"
         "            hi = pqs::clamp_then(hi, pqs::clamp_step(pqs::hi16(v[r]),"
         " qmin, qmax));"),
        ("          f[2 * h] = pass2::then(f[2 * h], pass2::lanes_then(lo, "
         "lane));\n"
         "          f[2 * h + 1] =\n"
         "              pass2::then(f[2 * h + 1], pass2::lanes_then(hi, "
         "lane));",
         "          f[2 * h] = pqs::clamp_then(f[2 * h], pqs::warp_compose(lo, "
         "lane));\n"
         "          f[2 * h + 1] = pqs::clamp_then(f[2 * h + 1], "
         "pqs::warp_compose(hi, lane));")]},
    # half the shared memory a window: more windows, more blocks an SM
    "bytes28k": {SRC: [("constexpr int kExpandBytes = 56 * 1024;",
                        "constexpr int kExpandBytes = 28 * 1024;")]},
    # 4 blocks an SM asked of the register allocator (64 registers)
    "min_blocks4": {SRC: [(
        "__global__ void __launch_bounds__(32 * kExpandWarps)\n"
        "    nm_expand_kernel(",
        "__global__ void __launch_bounds__(32 * kExpandWarps, 4)\n"
        "    nm_expand_kernel(")]},
}


def print_registers(names):
    """Registers and local memory of each variant's expand kernels at the
    timed shapes (``cuobjdump -res-usage``)."""
    from repro_torch.kernels import build

    tool = Path(build._nvcc()).parent / "cuobjdump"
    for name in names:
        out = subprocess.run(
            [str(tool), "-res-usage", str(OUT / name / f"lib{SOURCES[0]}.so")],
            capture_output=True, text=True).stdout
        kernel = None
        for line in out.splitlines():
            func = re.search(r"Function (\w+):", line)
            if func:
                kernel = build.kernel_label(func[1])
                continue
            use = re.search(r"REG:(\d+).*?STACK:(\d+).*?LOCAL:(\d+)", line)
            if use and kernel in ("nm_expand_kernel<4,32>",
                                  "nm_expand_kernel<8,32>"):
                print(f"  {name}: {kernel} {use[1]} registers, stack "
                      f"{use[2]}, local {use[3]} bytes", flush=True)


def load_variant(torch, cs, nm, name):
    """A variant's row 5 as callable(x, vals, idx, policy), checked equal
    to the plain version first."""
    from int8_mma_ab import c_fn

    lib = ctypes.CDLL(str(OUT / name / f"lib{SOURCES[0]}.so"))
    fn = c_fn(lib, "pqs_nm_seq_policy_matmul", 4, 10)
    stream = torch.cuda.current_stream().cuda_stream

    def row5(x, vals, idx, policy):
        (m, k), (n, g, n_keep) = x.shape, vals.shape
        out = torch.empty((m, n), dtype=torch.int32, device="cuda")
        if fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), out.data_ptr(),
              m, n, k, g, n_keep, cs.M_GROUP, POLICIES[policy], 16, 1,
              256, stream):
            raise SystemExit(f"{name}: pqs_nm_seq_policy_matmul failed")
        return out

    for site in ("wk", "wq", "w_out"):
        n, k = cs.SITES[site]
        x, _, vals, idx = cs.nm_operands(torch, 5, n, k, n + k)
        for policy in POLICIES:
            want = nm.nm_seq_policy_matmul_ref(
                x, vals, idx, m_group=cs.M_GROUP, policy=policy, acc_bits=16,
                rounds=1, k_tile=256)
            if not torch.equal(row5(x, vals, idx, policy), want):
                raise SystemExit(f"{name}: row 5 wrong at {site} {policy}")
    return row5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    names = args.variants.split(",")
    import torch

    import chip_smoke as cs
    from int8_mma_ab import build_variants
    from repro_torch.kernels import nm_spmm as nm

    if not torch.cuda.is_available():
        print("nm_expand_seq_ab: no CUDA device", file=sys.stderr)
        return 2
    build_variants(names, VARIANTS, SOURCES, OUT)
    print(cs.card_line(), flush=True)
    print_registers(names)
    fns = {name: load_variant(torch, cs, nm, name) for name in names}
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    ops = {site: cs.nm_operands(torch, 128, n, k, 9)
           for site, (n, k) in cs.SITES.items()}
    total = {}
    for name in names + names[::-1]:
        for x128, _, vals, idx in ops.values():
            for m in (4, 128):
                x = x128[:m].contiguous()
                for policy in POLICIES:
                    ms = cs.time_launches(
                        torch, lambda: fns[name](x, vals, idx, policy), 10,
                        flush_buf)
                    key = (policy, m, name)
                    total[key] = total.get(key, 0.0) + ms / 2
    for policy in POLICIES:
        for m in (4, 128):
            cells = "  ".join(f"{name} {total[(policy, m, name)]:.4f}"
                              for name in names)
            print(f"row 5 {policy:16s} M={m:3d} ms over the 7 sites: "
                  f"{cells}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
