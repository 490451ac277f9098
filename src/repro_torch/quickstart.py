"""PQS quickstart on PyTorch: the paper's idea end to end, the port of
``examples/quickstart.py``.

1. Quantize a weight/activation pair to int8 (paper section 2.1).
2. Show a transient overflow: the exact dot product fits a 16-bit
   register, but natural-order accumulation leaves its range.
3. Fix it with the sorted dot product (paper Alg. 1): no extra bits.
4. Do the same at matmul scale with the sorted and clip kernels, held
   against the wide result of ``quant_matmul``.
5. Run an N:M-compressed wide matmul (``nm_spmm``) against the dense one
   on the pruned weight.

    python -m repro_torch.quickstart [--device cpu]

The inputs are drawn from ``numpy.random.default_rng(0)`` in the JAX
example's order, so both print the same numbers; the kernels run on the
card unless the caller asks for the CPU, where the wrappers take their
plain versions. ``main`` prints the JAX example's lines, in its order,
naming the device where the JAX example says "interpret mode", and
returns every number it printed; ``run`` also returns the matmuls'
operands and results, for holding the kernels against their plain
versions element by element.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.overflow import census
from repro_torch.core.pruning import nm_prune_mask
from repro_torch.core.quant import activation_qparams, quantize, weight_qparams
from repro_torch.core.sorted_accum import monotone_accumulate, sorted_order
from repro_torch.kernels import ops

ACC = 16  # the register of steps 2-3
MATMUL_ACC = 18  # the register of step 4


def _pct(hit: torch.Tensor, fits: torch.Tensor) -> float:
    """Percent of the in-range outputs that ``hit``, from integer counts
    on the host (numpy's mean of a bool array, bit for bit, whatever the
    device's reduction order)."""
    return 100 * (int(hit[fits].sum()) / int(fits.sum()))


def run(device=None) -> tuple[dict, dict]:
    """The quickstart on ``device``: prints its lines and returns (the
    printed numbers, {name: tensor} of steps 4 and 5's operands and
    results on the device)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)  # seed 0 gives a transient case at 16 bits

    def tensor(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(dtype).to(dev)

    # --- 1. quantize -------------------------------------------------------
    w = tensor(rng.normal(size=(256,)), torch.float32)
    x = tensor(np.abs(rng.normal(size=(256,))), torch.float32)  # post-ReLU
    wq = quantize(w, weight_qparams(w, 8))
    xq = quantize(x, activation_qparams(x.min(), x.max(), 8))
    prods = (wq * xq)[None, :]
    exact = int(prods.sum())
    print(f"dot length K={prods.shape[-1]}, exact sum = {exact}")

    # --- 2. transient overflow with a 16-bit accumulator -------------------
    c = census(prods, ACC)
    nat, ovf_nat = monotone_accumulate(prods, ACC, saturate=True)
    print(f"natural order @ {ACC}b: value {int(nat[0])} "
          f"(overflowed={bool(ovf_nat[0])}, transient={int(c.n_transient)})")

    # --- 3. sorted dot product fixes it ------------------------------------
    srt, ovf_srt = monotone_accumulate(sorted_order(prods, 1), ACC,
                                       saturate=True)
    print(f"sorted order  @ {ACC}b: value {int(srt[0])} "
          f"(overflowed={bool(ovf_srt[0])}) — exact: {int(srt[0]) == exact}")

    # --- 4. matmul scale: sorted and clip kernels vs the wide kernel -------
    X = tensor(rng.integers(0, 127, (32, 512)), torch.int8)
    W = tensor(rng.integers(-127, 127, (64, 512)), torch.int8)
    wide = ops.quant_matmul(X, W.t().contiguous())
    srtk = ops.sorted_matmul(X, W, acc_bits=MATMUL_ACC, bk=256)
    clpk = ops.clip_matmul(X, W, acc_bits=MATMUL_ACC, bk=256)
    fits = wide.abs() < 2 ** (MATMUL_ACC - 1)
    sorted_pct, clip_pct = _pct(srtk == wide, fits), _pct(clpk == wide, fits)
    print(f"\nmatmul 32x512x64 @ {MATMUL_ACC}-bit accumulator "
          f"(kernel, {dev.type}):")
    print(f"  sorted kernel exact on {sorted_pct:.2f}% of in-range outputs")
    print(f"  clip   kernel exact on {clip_pct:.2f}%")

    # --- 5. N:M pruning shortens the dot (fights persistent overflow) ------
    mask = nm_prune_mask(W.to(torch.float32), 4, 16)
    Wp = (W * mask).to(torch.int8)
    vals, idx = ops.compress_nm_weights(Wp, 4, 16)
    out = ops.nm_spmm(X, vals, idx, m_group=16)
    dense = ops.quant_matmul(X, Wp.t().contiguous())
    same = bool(torch.equal(out, dense))
    print(f"\n4:16-pruned compressed matmul == dense-on-pruned: {same}")
    print("weight bytes vs dense int8: "
          f"{vals.numel() + idx.numel()}/{Wp.numel()} "
          "(values+int32 idx; int8-packable)")
    numbers = dict(
        k=prods.shape[-1], exact_sum=exact, natural_value=int(nat[0]),
        natural_overflowed=bool(ovf_nat[0]),
        n_transient=int(c.n_transient), sorted_value=int(srt[0]),
        sorted_overflowed=bool(ovf_srt[0]),
        sorted_exact=int(srt[0]) == exact, sorted_kernel_pct=sorted_pct,
        clip_kernel_pct=clip_pct, compressed_equals_dense=same,
        compressed_elems=vals.numel() + idx.numel(), dense_elems=Wp.numel())
    return numbers, dict(x=X, w=W, wide=wide, sorted=srtk, clip=clpk,
                         pruned=Wp, values=vals, indices=idx, nm_spmm=out,
                         dense_on_pruned=dense)


def main(device=None) -> dict:
    """The quickstart on ``device`` (default: the CUDA card): prints its
    lines and returns the numbers it printed."""
    return run(device)[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
