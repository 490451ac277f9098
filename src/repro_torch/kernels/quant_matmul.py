"""The wide int8 matmul for Hopper: ``quant_matmul``.

Port of ``repro/kernels/quant_matmul.py``: the conventional quantized
matmul PQS improves on. x (M, K) int8 times w (K, N) int8 (the weight
stored in-by-out, as ``QTensor.values``, unlike the (N, K) weights of the
policy kernels) into an exact (M, N) int32 sum, wrapping as an int32
``dot_general`` does.

``quant_matmul`` launches its hand-written CUDA kernel
(``csrc/quant_matmul.cu``, int8 tensor cores; its header says how it is
built and what bounds it) on CUDA tensors, counting the launch in
``.launches`` (and in ``.body_launches`` under its body's name), and takes
its plain version (``quant_matmul_ref``) only for tensors on the CPU. Two
bodies, named by ``quant_matmul_body`` from the shapes and alignment
alone: ``"tma"``, fed by the Tensor Memory Accelerator, where TMA takes
the operands (N and K multiples of 16, both 16-byte aligned), else
``"kn_rows"``, the (K, N) loader of the int8 mainloop. Both mask ragged M,
N and K themselves, so nothing is padded.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.sorted_matmul import (
    card_operands,
    lib_fn,
    on_cpu,
    seq_policy_matmul_ref,
    stream_of,
)


BODIES = ("kn_rows", "tma")  # the C entry point's body codes 0, 1
TMA_ALIGN = 16  # bytes: TMA's row strides and base addresses


def quant_matmul_body(n: int, k: int, x_ptr: int, w_ptr: int) -> str:
    """The CUDA body ``quant_matmul`` launches for w (K, N) at address
    ``w_ptr`` and x (M, K) at ``x_ptr``: ``"tma"`` where N and K are
    multiples of 16 and both addresses 16-byte aligned (a tensor map's row
    strides and base), else ``"kn_rows"``."""
    aligned = all(v % TMA_ALIGN == 0 for v in (n, k, x_ptr, w_ptr))
    return "tma" if aligned and k > 0 else "kn_rows"


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")


def quant_matmul_ref(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version (any device): the ``wide`` policy's row-chunked
    broadcast multiply and int32 sum on wᵀ (no ``torch.matmul``, which
    refuses int32 on CUDA, and no ``torch._int_mm``, which refuses
    M <= 16)."""
    _check(x, w)
    return seq_policy_matmul_ref(x, w.t(), policy="wide")


def quant_matmul(
    x: torch.Tensor,  # (M, K) int8, or int32 carrying int8 values
    w: torch.Tensor,  # (K, N) int8 weights, in-by-out
    *,
    body: str | None = None,
) -> torch.Tensor:
    """(M, N) int32 exact sums: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. Any M, N, K. ``body`` names the CUDA
    body (default ``quant_matmul_body``'s choice; ``"tma"`` on operands it
    does not take raises)."""
    _check(x, w)
    if on_cpu(x, w):
        return quant_matmul_ref(x, w)
    x8, w8 = card_operands("quant_matmul", x, w)
    m, k = x8.shape
    n = w8.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=x8.device)
    if m == 0 or n == 0:
        return out
    if k == 0:
        return out.zero_()
    chosen = quant_matmul_body(n, k, x8.data_ptr(), w8.data_ptr())
    body = chosen if body is None else body
    if body not in BODIES or (body == "tma" and chosen != "tma"):
        raise ValueError(f"quant_matmul body {body!r} does not take these "
                         f"operands (N={n}, K={k}, x at {x8.data_ptr()}, w "
                         f"at {w8.data_ptr()}); {chosen!r} does")
    fn = lib_fn("quant_matmul", "pqs_quant_matmul", 3, 4)
    err = fn(x8.data_ptr(), w8.data_ptr(), out.data_ptr(), m, n, k,
             BODIES.index(body), stream_of(x8))
    if err != 0:
        raise RuntimeError(f"quant_matmul launch failed: CUDA error {err}")
    quant_matmul.launches += 1
    quant_matmul.body_launches[body] += 1
    return out


quant_matmul.launches = 0
quant_matmul.body_launches = dict.fromkeys(BODIES, 0)
