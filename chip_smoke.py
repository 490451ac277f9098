#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of PQS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0]

Run from the repository root; it needs one CUDA card and nvcc, and
imports nothing of JAX or of the JAX package. Phases:

1. the card (nvidia-smi name and power limit); build every CUDA kernel
   of the port from ``src/repro_torch/csrc`` (one nvcc each, in parallel)
   and print each kernel's registers and spills, and the SASS opcodes of
   the packed int16x2 sort;
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the qwen2-1.5b projection shapes (seeded int8, near-extreme rows so
   a 16-bit register saturates), every policy, rounds 1 and 2: the dense
   ``seq_policy_matmul`` (``wide``, the tensor-core mainloop, also at
   M = 128 with the int8 extremes at the corners and equal to
   ``quant_matmul`` on the transposed weight; ``sorted_tiled_seq``, the
   packed sort, at k_tile 1 to 1024, rounds 1 to 3, acc_bits 2, 16 and
   30 and M 1, 3, 4, 5, with ``clip`` and ``wrap``), and the N:M
   ``nm_gather_seq_policy_matmul`` and
   ``nm_seq_policy_matmul`` on 8:16 slabs (plus ragged 3:16 and 2:4
   cases, n_keep = m, and shapes that split the gather's tiles over 1, 2,
   4 and 8 warps an output and stage x in several windows,
   ``NM_SPLIT_CASES``), which must also equal the dense kernel on the
   decompressed weight, and on non-canonical slabs their plain versions;
   and the global-sort kernels ``sort_matmul``,
   ``tile_sums_matmul``, ``paired_accum_matmul`` and
   ``chunked_sort_matmul`` (with tied tile sums), the one-pass kernel
   equal to the two-pass pipeline; pass 1's two kernels on their own
   (``phase_pass1_kernels``: ``tile_sums_matmul`` on both bodies, the int8
   mainloop and the small-tile one, and ``nm_gather_tile_sums`` and
   ``nm_tile_sums_matmul`` on the few-rows and many-rows bodies they share
   (and the latter's one-warp body at k_tile 2048), at M 1, 4, 5, 64, 128,
   K 1000 and 1001, k_tile 16 to 1024, 8:16 and 2:4 slabs, non-canonical
   slabs and an index outside its group, which the gather reads and the
   expand drops, the int8 extremes at k_tile 1024); rows 4 and 5 on slabs
   whose slots name one position twice with a sum past int8
   (``phase_duplicate_slots``: the smallest case, M = 2, K = 16, must give
   (254, 32258), and row 5 under every policy on its int32 route); and
   their N:M gather
   twins
   ``nm_gather_sort_matmul``, ``nm_gather_tile_sums``,
   ``nm_gather_paired_accum_matmul`` and ``nm_gather_chunked_sort_matmul``
   and their expand twins ``nm_sort_matmul``, ``nm_tile_sums_matmul``,
   ``nm_paired_accum_matmul`` and ``nm_chunked_sort_matmul`` on 8:16 slabs
   (plus ragged 3:16 and 2:4, and 16:16), which must also equal the dense
   global-sort kernels on the decompressed weight (and expand the
   gather); the gather kernels (rows 6, 8, 11, 14, 17) on slabs whose
   gathered positions lie before x's row (``phase_gather_faults``: a
   position in [-kp, 0) wraps within x's row padded to kp, G * m for row
   6, one below is a zero product); the register-resident `sorted` body
   of the dense, gather and
   expand kernels in every regime of its shape (``phase_sorted_regimes``:
   kp 32 to 65536, M = 3, rounds 1 to 3, acc_bits 2, 16 and 30, keys at
   -16256 and 16384, outputs of one sign, an all-zero row; and the expand
   kernel's int32 route, slabs whose slots name one position three
   times, at each kp);
   ``auto`` must launch the expand twins for a site of fewer than
   ``GATHER_MIN_G`` groups and for 16:16 (dense-as-sparse) slabs; and the
   wide ``quant_matmul`` (w (K, N)), ``seq_policy_matmul`` under ``wide``
   (at operands 0, 1 and 4 bytes off alignment) and ``nm_spmm`` at edge
   shapes (M 1, 4, 17, 128, ragged N and K, K = 8960, int8 extremes;
   8:16, 4:16, 2:8, 16:16 and padded slots; non-canonical slabs on which
   it and its plain version agree), ``nm_spmm`` and the ``wide`` policy
   also equal to ``quant_matmul``; and ``quant_matmul`` on each of its
   bodies (``phase_quant_matmul_bodies``: the TMA-fed one where
   ``quant_matmul_body`` names it and the KnRows one everywhere, M 1 to
   200, ragged N and K, operands 0, 1 and 4 bytes off alignment, the int8
   extremes and the int32 wrap);
2c. the overflow census of ``pqs_dot(with_census=True)`` on the card at
   layer 0's 7 site shapes (``phase_census``): equal to the CPU's census
   of the same int8 tensors, compressed (gather and expand) equal to
   dense, M = 128 equal to its 4-row chunks and to one chunk, the output
   unchanged by the census;
3. serve full-width qwen2-1.5b (28 layers, random seeded weights, 8:16
   pruned int8, sorted_tiled_seq at 16 bits, k_tile 256) through
   ``ServingEngine`` from dense int8 storage: 4 greedy requests, 16 new
   tokens each; the launch counts show every integer projection went
   through the dense kernel; then a profiler window of two more decode
   steps (device time by kernel, the port's own kernels summed, host time
   by operator) and the time of the tied head's dequantize;
3b. the same model served from N:M compressed storage
   (``nm_compress_tree``): every projection through the gather kernel,
   none through the dense one, and the same tokens as phase 3;
3c. the model of phase 3 cut to ``SORT_SERVE_LAYERS`` (14) layers, served
   under ``sorted_tiled``: 84 ``sort_matmul``, 14 ``tile_sums_matmul`` and
   14 ``paired_accum_matmul`` launches a step (one-pass at K = 1536,
   two-pass at w_out's K = 8960);
3d. and under ``sorted``: 84 ``sort_matmul`` and 14
   ``chunked_sort_matmul`` launches a step;
3e. the compressed 14-layer model under ``sorted_tiled``: 84
   ``nm_gather_sort_matmul``, 14 ``nm_gather_tile_sums`` and 14
   ``nm_gather_paired_accum_matmul`` launches a step, the tokens of 3c;
3f. and under ``sorted``: 84 ``nm_gather_sort_matmul`` and 14
   ``nm_gather_chunked_sort_matmul`` launches a step, the tokens of 3d;
3g. the compressed 14-layer model with ``nm_impl="expand"`` under
   ``sorted_tiled``: 84 ``nm_sort_matmul``, 14 ``nm_tile_sums_matmul`` and
   14 ``nm_paired_accum_matmul`` launches a step, no gather kernel, the
   tokens of 3c (and so of 3e);
3h. and under ``sorted``: 84 ``nm_sort_matmul`` and 14
   ``nm_chunked_sort_matmul`` launches a step, the tokens of 3d and 3f;
3j. the compressed model with ``nm_impl="expand"`` under
   ``sorted_tiled_seq``: 196 ``nm_seq_policy_matmul`` launches a step (row
   5), no other kernel, the tokens of 3 and 3b;
3k. the compressed model under ``wide`` (``auto`` takes the expand
   kernel, as it does for every compressed matmul ``pqs_dot(certified=
   True)`` makes ``wide``): 196 ``nm_seq_policy_matmul`` launches a step;
3l. the dense model calibrated on one seeded batch (``calibrate``) and
   served under ``CensusWatch(threshold=0.01, window=4)``: each window's
   per-site rates and the degrades printed; a degraded site reads rate
   0.0 in every later window and launches row 1's ``wide`` kernel from
   the next step, the others keep ``sorted_tiled_seq``; then the
   census's device time at decode (busy with it less busy without);
3m. the same from compressed storage (row 6; degraded sites row 5's
   ``wide``): the events, window totals and tokens of 3l;
3n. the dense model's layers enforced to a 16-bit register
   (``enforce_acc_bounds``) and certified (``certify_params``, every
   projection site safe at 16 bits), served with the certificate and a
   ``CensusWatch``: no site reaches the monitor, 196 row-1 ``wide``
   launches a step; served uncertified with the census: 0 events, the
   same tokens, one 28-layer decode's logits bit for bit; tampered
   weights refused at construction;
3i. one 28-layer decode's logits bit for bit within each group: 3 / 3b /
   3j, 3c / 3e / 3g, 3d / 3f / 3h, and dense ``wide`` / 3k;
4. the same engine at 1 layer, full width: the dense kernel and its
   plain version, and the compressed weights through the gather and the
   expand kernel (the expand kernel's path), give identical tokens (4
   new ones to prompts of 5-8 tokens, ``parity_requests``; 16 to the
   prompts of phase 3 until phase 9 joined) and decode logits;
4b. at 1 layer (``PARITY_LAYERS``; 2 until the paper phases joined the
   run) under ``sorted_tiled`` and ``sorted``: the dense kernels,
   their plain versions and the compressed weights through the expand
   kernels give identical tokens (2 new ones, to the prompts of phase 4
   since phase 9 joined; 4 until phase 8 joined) and decode logits;
4c. the torch quickstart (``repro_torch.quickstart.run``) on the card:
   it launches ``quant_matmul`` (on its TMA-fed body), ``nm_spmm`` and
   ``seq_policy_matmul``,
   prints what it prints on the CPU, and each of its matmuls' results
   equals the plain version's on the same inputs, element by element;
4d. ``quant_matmul`` on the ``QTensor.values`` and ``nm_spmm`` on the
   ``SparseQTensor`` slabs of layer 0's 7 full-width sites at M = 4 and
   128, against their plain versions, ``seq_policy_matmul`` under
   ``wide`` and each other;
5. kernel times at the decode shapes (CUDA events, L2 flushed before
   each launch, the device kept busy while the host enqueues the
   launch), beside the plain versions, ``torch._int_mm`` (and a
   float32 ``bmm`` for the tile sums) and, for the N:M kernels, the
   dense kernel on the same dot (the decompressed weight) and, for the
   expand kernels, the gather kernels; ``seq_policy_matmul`` under
   ``wide`` at the 7 sites at M = 4, 64 and 128 beside ``torch._int_mm``;
   the gather and expand one-pass
   kernels at 4, 8 and 16 groups (``GATHER_MIN_G``); the N:M K-streaming
   kernels at M = 4 and 128, the gather under ``sorted_tiled_seq`` and the
   expand (row 5) under every policy, its ``wide`` beside ``torch._int_mm``
   on the decompressed weight (``phase_nm_timing``); the `sorted` rows 15,
   16 and 17 at every kp from 4096 to 65536 (``phase_sorted_kp_timing``);
   and ``quant_matmul``
   and ``nm_spmm`` at the 7 site shapes at M = 4 and 128 beside
   ``torch._int_mm`` with the weight stored (N, K) and as the kernel's
   (K, N), ``quant_matmul`` on its TMA-fed body; pass 1
   (``tile_sums_matmul``, ``nm_tile_sums_matmul``, ``nm_gather_tile_sums``)
   at w_out at M = 4 and 128 beside a float32 ``bmm`` at the same M,
   checked equal first; the one-pass `sorted` kernels (rows 2, 7, 8) also
   at M = 128 at the six K = 1536 sites; pass 2 (rows 12, 13 and 14) also
   at M = 128 at w_out, row 12 also on the weight as served (8:16-pruned,
   stored dense) at both M; and, with ``--baseline-csrc
   DIR`` (another tree's ``src/repro_torch/csrc``, built beside the
   port's), that tree's rows 1 (``wide``) and 2-17, each timed in turns
   with the new one in the same call (``old_ms``), equal results checked
   first.

6a. the paper nets at their published widths on ``synth_mnist(n=4096)``
   (``phase_paper_nets``): mlp1 and mlp2 under P->Q, mlp2 under Q->P, at
   w5a5 and in the A2Q regime at a 16-bit register, the convnet under
   P->Q (8:16, 8-bit unless named); each frozen and run through
   ``evaluate_int`` (rows 1 and 2: ``sorted`` and ``sorted_tiled``
   through ``sort_matmul``, ``clip`` and ``wide`` through
   ``seq_policy_matmul``, one launch a 128-row chunk, K = 36 to 784) and
   ``overflow_profile`` at registers of 12, 14, 16 and 20 bits: every
   integer dot equal to its plain version, the card's census equal to
   the CPU's, the census never rising with the register, the MLPs above
   0.8 in float32 (not the A2Q net, at chance at 16 bits as in the JAX
   package), ``wide`` within 0.08 of float32; each net's Fig-2 table
   printed, and rows 1 and 2 timed at mlp2's hidden layer (M = 128 and
   512) beside their plain versions and bound;
6b. ``a2q_finetune`` for 2 AdamW steps on qwen2-1.5b at full width and 2
   layers (every QAT site reporting its census each step), then
   ``quantize_and_certify(acc_bits=16)``: the certificate verifies and
   every site is safe at 16 bits or fewer;
7a. gemma3-12b at its published widths, cut to 6 layers (one whole
   period: 5 sliding-window layers, then a global one), random seeded
   weights, 8:16-pruned int8, served on 4 slots under
   ``sorted_tiled_seq`` from dense storage (row 1) and compressed storage
   (row 6): three prompts of 20-32 tokens with 16 new tokens, and one of
   1000 with 40, so that decode passes position 1024 and every local
   layer's ring wraps. 42 launches a step of the storage's kernel and no
   other; the local layers' caches hold 1024 slots, the global one
   ``max_len``; every ``pqs_dot`` of the served prefill (4096 rows of x)
   equal to its plain version on its first and last 2 rows; the same
   tokens and one decode's logits bit for bit from both storages; every
   ``pqs_dot`` of one decode step at layers 0 and 5 equal to its plain
   version; a 2-step profile of each and the tied head's dequantize
   (262144 x 3840);
7b. qwen3-32b at full width and 1 layer: its untied head runs through row
   1 at N = 151936, K = 5120 (8 launches a step); the head's dot equals
   its plain version on its first and last 2048 outputs, and is timed
   alone beside its bound;
7c. command-r-35b at full width and 1 layer (layer norm, tied vocab
   256000): 7 launches a step, layer 0's dots equal their plain versions
   on their first and last 1024 outputs, the tied head's dequantize;
8a. granite-moe-3b at its published widths (40 experts, top-8, expert
   d_ff 512), cut to 4 layers, dense (row 1) and compressed (row 6): 16
   launches a step (the attention; the experts are float einsums on the
   dequantized stack), the same tokens and logits from both storages,
   the prefill's and one decode's dots at layers 0 and 3 equal to plain,
   layer 0's ``moe_ffn`` against the dropless ``moe_ffn_dense`` on the
   card; the experts' bytes and dequantize ms a layer; rows 1 and 6 timed
   at its 4 sites;
8b. mamba2-2.7b at its published widths, cut to 4 layers, dense and
   compressed, with a 1000-token prompt (a 4096-row prefill of 4 SSD
   chunks of 256): 8 launches a step (in_proj N = 10576, out_proj),
   per-layer ``ssd`` / ``conv`` caches, the same tokens and logits, the
   dots held against plain, and layer 0's chunked ``mamba_forward`` over
   the long prompt against 1000 ``mamba_step`` calls; rows 1 and 6 timed
   at its 2 sites;
9a. jamba-v0.1-52b at its published widths (16 experts top-2 of d_ff
   14336, Mamba2 d_inner 8192, tied vocab 65536), cut to 5 layers, which
   hold each layer kind of the published pattern (Mamba2 + MLP, Mamba2 +
   MoE, attention + MLP), dense and compressed: the launches a step that
   the layer kinds give (21), per-layer caches of each kind, the same
   tokens and logits, one decode's dots at layers 0 and 4 and the
   prefill's at layer 4 equal to plain; the experts' and the tied head's
   dequantize ms; rows 1 and 6 timed at its 6 site shapes;
9b. whisper-medium at its published widths and depth (24 + 24 layers):
   the engine on its zero-encoder cross K/V (192 launches a step, the
   same tokens from both storages), then the model bundle inside
   ``integer_lin``: ``encode`` 4 clips of 1500 seeded frames, the cross
   K/V, a prefill and 2 decodes, each pass's launches counted, the
   encoder's dots at layers 0 and 23 on the first and last 4 frames and
   one decode step's at layers 0 and 23 equal to plain, the logits bit
   for bit across storages; rows 1 and 6 timed at its 3 site shapes;
9c. qwen2-vl-72b at its published widths (M-RoPE (16, 24, 24), untied
   head 152064), cut to 2 layers, through the model bundle (embedding
   inputs): ``forward`` on 4 x 96 embeddings at distinct t / h / w
   streams (an 8 x 8 image grid, then text), a prefill of 4 x 32 and 4
   decodes, dense and compressed: 15 launches a pass, the forward's dots
   of layers 0 and 1 on the first and last row and a decode's head
   equal to plain, the logits bit for bit across storages; rows 1 and 6
   timed at 3 of its site shapes (wq, w_gate and the head).

Each phase's line ends with the device memory still held and its peak.
The last six lines are a JSON ``guardrails``
record (the s a decode
step and the prefill s of 3, 3k and 3l-3n, the census's device ms, the
host s of certification), the JSON ``paper`` record (6a's training,
evaluation and census times and 6b's step times, peak memory and
certification), the JSON ``families`` record (7a-9c's s a decode step,
prefill s, 2-step profiles, head and experts times), the JSON ``kernels``
record,
the card's name and power limit, and ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero without that last line. ``--only 2c,3l`` runs just the
phases named after the build (a partial run prints no record).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
# lane-instructions a second: 132 SMs, 4 schedulers issuing a warp (32
# lanes) a clock each, 1.98 GHz (the H100 SXM's boost clock)
LANE_INSTR_PER_S = 132 * 4 * 32 * 1.98e9
# (N, K) of the qwen2-1.5b projections: wq/wo, wk/wv, w_gate/w_up, w_out
SITES = {"wq": (1536, 1536), "wk": (256, 1536), "wv": (256, 1536),
         "wo": (1536, 1536), "w_gate": (8960, 1536), "w_up": (8960, 1536),
         "w_out": (1536, 8960)}
SHAPES = sorted(set(SITES.values()))
N_KEEP, M_GROUP = 8, 16


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def operands(torch, m, n, k, seed):
    """Seeded int8 x (m, k), w (n, k) on the card; the first rows are
    all-positive extremes so every register saturates there."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, device="cuda",
                      dtype=torch.int8)
    x[0] = 127
    w[0] = 127
    return x, w


def prune(torch, w, n_keep=N_KEEP, m_group=M_GROUP):
    """(N, K) w pruned n_keep:m_group, and its compressed slabs: the dense
    pruned w, values, indices."""
    from repro_torch.core.pruning import nm_compress, nm_prune_mask

    k = w.shape[1]
    wp = torch.nn.functional.pad(w, (0, (-k) % m_group)).float()
    w = (wp * nm_prune_mask(wp, n_keep, m_group))[:, :k].to(torch.int8)
    vals, idx = nm_compress(w, n_keep, m_group)
    return w, vals.contiguous(), idx.contiguous()


def nm_operands(torch, m, n, k, seed, n_keep=N_KEEP, m_group=M_GROUP,
                tied=False):
    """``operands`` with the weight pruned n_keep:m_group and compressed:
    x, the dense pruned w, values, indices. ``tied``: tied tile sums as
    ``sort_operands`` makes them (the repeated tile where 256 divides
    K), set before pruning."""
    if tied and k % 256 == 0:
        x, w = sort_operands(torch, m, n, k, seed)
    else:
        x, w = operands(torch, m, n, k, seed)
        if tied:
            x[1] = 0
    return (x, *prune(torch, w, n_keep, m_group))


def corner_extremes(x, w):
    """Row 0 of x and of w (N, K) all -128 and their last rows all 127,
    in place: the int8 extremes at the corners of the output."""
    x[0], w[0] = -128, -128
    if x.shape[0] > 1:
        x[-1] = 127
    if w.shape[0] > 1:
        w[-1] = 127
    return x, w


def phase_kernels(torch, sm, qm, seed):
    """Kernel vs plain version, bit-exact: every policy at the site shapes
    at M = 4 and a ragged one, ``sorted_tiled_seq`` at M = 64; ``wide`` (the tensor-core mainloop)
    also at M = 128 with the int8 extremes at the corners, equal to row 3
    on the transposed weight; ``sorted_tiled_seq`` (the packed int16x2
    sort) at k_tile 1 to 1024, rounds 1 to 3, acc_bits 2, 16 and 30 and
    M 1, 3, 4, 5 (odd M leaves a packed half zero), K not a multiple of a
    chunk, extremes at the corners, and ``clip`` and ``wrap`` at the same
    M and acc_bits. Returns the max |difference|."""
    cases = [(m, n, k) for (n, k) in SHAPES for m in (4, 64)] + [(5, 70, 300)]
    worst = 0

    def check(x, w, **kw):
        nonlocal worst
        got = sm.seq_policy_matmul(x, w, **kw)
        want = sm.seq_policy_matmul_ref(x, w, **kw)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        return got, want, err

    for i, (m, n, k) in enumerate(cases):
        x, w = operands(torch, m, n, k, seed + i)
        # the plain versions add one product a step: at M = 64 the sites
        # take the serving policy only (every policy runs at M = 4)
        for policy in ("sorted_tiled_seq",) if m == 64 else sm.SEQ_POLICIES:
            for rounds in ((1, 2) if policy == "sorted_tiled_seq" and m < 64
                           else (1,)):
                _, want, err = check(x, w, policy=policy, acc_bits=16,
                                     rounds=rounds, k_tile=256)
                # share of outputs at or past the 16-bit register's edge
                edge = float((want.abs() >= 32767).float().mean())
                print(f"  kernel/plain M={m:3d} N={n:5d} K={k:5d} "
                      f"{policy:16s} rounds={rounds} max|diff|={err} "
                      f"at-16-bit-edge={edge:.3f}", flush=True)
    row3 = 0
    for i, (n, k) in enumerate(SHAPES):
        for m in (4, 64, 128):
            x, w = corner_extremes(*operands(torch, m, n, k, seed + 20 + i))
            got, _, err = check(x, w, policy="wide")
            cross = int((got.long() - qm.quant_matmul(
                x, w.t().contiguous()).long()).abs().max())
            row3 = max(row3, cross, abs(int(got[0, 0]) - 128 * 128 * k))
            print(f"  wide (corners) M={m:3d} N={n:5d} K={k:5d} "
                  f"max|diff| plain={err} row 3 on wT={cross}", flush=True)
    for m in (1, 3, 4, 5):
        x, w = corner_extremes(*operands(torch, m, 37, 1100, seed + 30 + m))
        errs = []
        for k_tile in (1, 8, 32, 256, 1024):
            for rounds in (1, 2, 3):
                for acc_bits in (2, 16, 30):
                    errs.append(check(x, w, policy="sorted_tiled_seq",
                                      acc_bits=acc_bits, rounds=rounds,
                                      k_tile=k_tile)[2])
        for policy in ("clip", "wrap"):
            for acc_bits in (2, 16, 30):
                errs.append(check(x, w, policy=policy,
                                  acc_bits=acc_bits)[2])
        print(f"  packed sort M={m} N=37 K=1100 (corners): k_tile 1-1024 "
              f"x rounds 1-3 x acc_bits 2/16/30, and clip, wrap: "
              f"max|diff| {max(errs)} over {len(errs)} cases", flush=True)
    if worst or row3:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max |diff| {worst}) or wide with row 3 "
                             f"({row3})")
    return worst


# (M, N, K, n_keep, m_group) that put row 6's tiles on 1, 2, 4 and 8 warps
# an output, stage x in several windows (K = 65536), keep every slot (n_keep
# = m) or take one output
NM_SPLIT_CASES = ((1, 1, 16, 8, 16), (8, 1536, 1536, 8, 16),
                  (12, 1536, 1536, 8, 16), (128, 1536, 1536, 8, 16),
                  (17, 70, 4000, 16, 16), (1, 70, 65536, 4, 16))


def phase_nm_kernels(torch, sm, nm, seed):
    """Both N:M kernels vs the plain version, bit-exact, and vs the
    dense kernel on the decompressed weight; at the sites, at edge shapes
    and at shapes that reach each split of row 6's tiles over warps
    (``NM_SPLIT_CASES``; from 8 rows of x under ``sorted_tiled_seq``
    only, the policy whose tiles they split, one round); and on
    non-canonical slabs
    (``non_canonical``:
    unsorted indices, two slots at one position) against their own plain
    versions only. On canonical slabs the two plain versions give the same
    result (``tests/test_torch_nm.py``; here once at K = 8960, under each
    policy), so both kernels are held against the gather's, which adds
    only the kept products (the expand's adds every position: at K = 65536
    it took most of this phase). Returns the max |difference| of each
    kernel against its plain version."""
    cases = [(4, n, k, N_KEEP, M_GROUP) for (n, k) in SHAPES] + [
        (64, 256, 1536, N_KEEP, M_GROUP), (5, 70, 300, 3, 16),
        (5, 70, 300, 2, 4), *NM_SPLIT_CASES]
    kernels = {"nm_gather_seq_policy_matmul": (
        nm.nm_gather_seq_policy_matmul, nm.nm_gather_seq_policy_matmul_ref),
        "nm_seq_policy_matmul": (nm.nm_seq_policy_matmul,
                                 nm.nm_seq_policy_matmul_ref)}
    worst = dict.fromkeys(kernels, 0)
    cross = plains = 0
    for i, (m, n, k, n_keep, m_group) in enumerate(cases):
        x, w, vals, idx = nm_operands(torch, m, n, k, seed + 50 + i, n_keep,
                                      m_group)
        # the plain versions of the split cases of 8 rows or more run
        # only the policy whose tiles they split, one round
        split = (m, n, k, n_keep, m_group) in NM_SPLIT_CASES and m >= 8
        for policy in ("sorted_tiled_seq",) if split else sm.SEQ_POLICIES:
            for rounds in ((1, 2) if policy == "sorted_tiled_seq"
                           and not split else (1,)):
                kw = dict(policy=policy, acc_bits=16, rounds=rounds,
                          k_tile=256)
                dense = sm.seq_policy_matmul(x, w, **kw)
                want = nm.nm_gather_seq_policy_matmul_ref(
                    x, vals, idx, m_group=m_group, **kw)
                errs = []
                for name, (kernel, _) in kernels.items():
                    got = kernel(x, vals, idx, m_group=m_group, **kw)
                    torch.cuda.synchronize()
                    err = int((got.long() - want.long()).abs().max())
                    worst[name] = max(worst[name], err)
                    cross = max(cross, int((got.long() - dense.long())
                                           .abs().max()))
                    errs.append(err)
                if (m, n, k) == (4, 1536, 8960):  # the two plain versions
                    own = nm.nm_seq_policy_matmul_ref(x, vals, idx,
                                                      m_group=m_group, **kw)
                    plains = max(plains, int((own.long() - want.long())
                                             .abs().max()))
                print(f"  nm kernels/plain M={m:3d} N={n:5d} K={k:5d} "
                      f"{n_keep}:{m_group} {policy:16s} rounds={rounds} "
                      f"max|diff| gather={errs[0]} expand={errs[1]}; "
                      f"vs dense kernel {cross}"
                      + (f"; expand's plain vs gather's {plains}"
                         if (m, n, k) == (4, 1536, 8960) else ""),
                      flush=True)
        if (m, n, k) not in ((4, 1536, 8960), (5, 70, 300), (1, 70, 65536)):
            continue
        nv, ni = non_canonical(torch, vals, idx)
        for policy in sm.SEQ_POLICIES:
            kw = dict(policy=policy, acc_bits=16, rounds=2, k_tile=256)
            errs = []
            for name, (kernel, plain) in kernels.items():
                got = kernel(x, nv, ni, m_group=m_group, **kw)
                want = plain(x, nv, ni, m_group=m_group, **kw)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                worst[name] = max(worst[name], err)
                errs.append(err)
            print(f"  nm kernels/plain, non-canonical slabs M={m:3d} "
                  f"N={n:5d} K={k:5d} {n_keep}:{m_group} {policy:16s} "
                  f"max|diff| gather={errs[0]} expand={errs[1]}",
                  flush=True)
    if any(worst.values()) or cross or plains:
        raise AssertionError(f"N:M kernels disagree: {worst}, vs dense "
                             f"{cross}; the plain versions {plains}")
    return worst


# (M, K, N) edge shapes of the wide kernels (rows 3 and 4): decode and
# prefill M, ragged N and K (no multiple of 8, 16 or 32), K = 8960, and
# the quickstart's matmul
WIDE_EDGES = ((1, 1536, 256), (4, 8960, 1536), (17, 300, 70),
              (128, 1536, 8960), (4, 33, 129), (128, 77, 5), (32, 512, 64))
WIDE_SLABS = ((8, 16), (4, 16), (2, 8), (16, 16))  # (n_keep, m_group)


def offset_copy(torch, t, offset):
    """A contiguous copy of int8 ``t`` starting ``offset`` bytes into its
    allocation (no 16- or 4-byte alignment for an odd offset)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    out = buf[offset:].view(t.shape)
    out.copy_(t)
    return out


def phase_wide_kernels(torch, sm, qm, nm, seed):
    """Rows 3 (``quant_matmul``, w (K, N)), 1 under ``wide`` (w (N, K)) and
    4 (``nm_spmm``) against their plain versions, bit-exact, at
    ``WIDE_EDGES`` with the int8 extremes at a corner (row 0 of x and
    column 0 of w all -128, the last ones all 127); row 1 also equal to
    row 3, and through each copy width of its ring (operands 0, 1 and 4
    bytes off 16-byte alignment); row 4 on 8:16, 4:16, 2:8 and 16:16
    slabs, and on slabs whose padded (0, 0) slots follow a kept value at
    position 0, each equal to row 3 on the decompressed weight, and on
    non-canonical slabs where it and its plain version agree (indices >=
    m_group or negative, dropped; two nonzero slots at one position whose
    sum stays inside int8). Returns the max |difference| of each kernel
    against its plain version."""
    from repro_torch.core.pruning import nm_decompress

    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    worst = {"quant_matmul": 0, "nm_spmm": 0, "seq_policy_matmul": 0}
    cross = corner = 0
    for i, (m, k, n) in enumerate(WIDE_EDGES):
        x, wt = operands(torch, m, n, k, seed + 300 + i)
        w = wt.t().contiguous()
        x[0], w[:, 0] = -128, -128
        if m > 1:
            x[-1] = 127
        if n > 1:
            w[:, -1] = 127
        got = qm.quant_matmul(x, w)
        err = diff(got, qm.quant_matmul_ref(x, w))
        worst["quant_matmul"] = max(worst["quant_matmul"], err)
        corner = max(corner, abs(int(got[0, 0]) - 128 * 128 * k))
        wide = []
        for offset in (0, 1, 4):
            xo = offset_copy(torch, x, offset)
            wo = offset_copy(torch, w.t().contiguous(), 2 * offset)
            row1 = sm.seq_policy_matmul(xo, wo, policy="wide")
            wide.append(diff(row1, sm.seq_policy_matmul_ref(
                xo, wo, policy="wide")))
            cross = max(cross, diff(row1, got))
        worst["seq_policy_matmul"] = max(worst["seq_policy_matmul"], *wide)
        errs = []
        for j, (n_keep, m_group) in enumerate(WIDE_SLABS):
            xs, ws, vals, idx = nm_operands(torch, m, n, k, seed + 310 + j,
                                            n_keep, m_group)
            got = nm.nm_spmm(xs, vals, idx, m_group=m_group)
            errs.append(diff(got, nm.nm_spmm_ref(xs, vals, idx,
                                                 m_group=m_group)))
            cross = max(cross, diff(got, qm.quant_matmul(
                xs, ws.t().contiguous())))
        worst["nm_spmm"] = max(worst["nm_spmm"], *errs)
        print(f"  wide kernels/plain M={m:3d} N={n:5d} K={k:5d} max|diff| "
              f"quant_matmul={err} wide policy at offsets 0/1/4={wide} "
              f"nm_spmm at "
              f"{'/'.join(f'{a}:{b}' for a, b in WIDE_SLABS)}={errs}; "
              f"wide policy and nm_spmm vs quant_matmul {cross}",
              flush=True)
    x, _, vals, idx = nm_operands(torch, 4, 1536, 1536, seed + 320)
    vals[:, :, 1:] = 0  # padded slots (0, 0) behind a kept value at 0
    idx.zero_()
    vals[:, :, 0] = -128
    dense = nm_decompress(vals, idx, M_GROUP)
    got = nm.nm_spmm(x, vals, idx, m_group=M_GROUP)
    pad = diff(got, nm.nm_spmm_ref(x, vals, idx, m_group=M_GROUP))
    worst["nm_spmm"] = max(worst["nm_spmm"], pad)
    cross = max(cross, diff(got, qm.quant_matmul(x, dense.t().contiguous())))
    kept = bool((dense[:, ::M_GROUP] == -128).all())
    print(f"  nm_spmm on padded slots: max|diff| {pad}, vs quant_matmul "
          f"{cross}, kept values at position 0 intact {kept}", flush=True)
    odd = []
    for j, (n_keep, m_group) in enumerate(WIDE_SLABS + ((3, 12), (8, 32))):
        x, _, vals, idx = nm_operands(torch, 17, 70, 300, seed + 330 + j,
                                      n_keep, m_group)
        vals[:, 2::3, :2] = (vals[:, 2::3, :2].to(torch.int32) // 3).to(
            torch.int8)  # slot 1 joins slot 0's position, inside int8
        idx[:, 2::3, 1] = idx[:, 2::3, 0]
        bad, dropped = idx.clone(), vals.clone()
        bad[:, 0::3, -1], dropped[:, 0::3, -1] = m_group, 0
        bad[:, 1::3, -1], dropped[:, 1::3, -1] = -1, 0
        odd.append(diff(nm.nm_spmm(x, vals, bad, m_group=m_group),
                        nm.nm_spmm_ref(x, dropped, idx, m_group=m_group)))
    worst["nm_spmm"] = max(worst["nm_spmm"], *odd)
    print(f"  nm_spmm on non-canonical slabs (dropped indices, summed "
          f"duplicates) at {'/'.join(f'{a}:{b}' for a, b in WIDE_SLABS)}"
          f"/3:12/8:32: max|diff| {odd}", flush=True)
    if any(worst.values()) or cross or corner or not kept:
        raise AssertionError(f"wide kernels disagree: {worst}, vs "
                             f"quant_matmul {cross}, corner off by {corner}, "
                             f"kept {kept}")
    return worst


def smallest_duplicate(torch, device="cuda"):
    """M = 2, K = 16, one 2:16 group whose two slots both name position 0
    with value 127, x[:, 0] = (1, 127): the expanded weight is 254 (past
    int8), the products 254 and 32258 (a byte would wrap them to -2 and
    -254). Returns x, vals, idx."""
    x = torch.zeros((2, 16), dtype=torch.int8, device=device)
    x[:, 0] = torch.tensor([1, 127], dtype=torch.int8)
    vals = torch.full((1, 1, 2), 127, dtype=torch.int8, device=device)
    idx = torch.zeros((1, 1, 2), dtype=torch.int32, device=device)
    return x, vals, idx


def stacked_slabs(torch, vals, idx):
    """Slabs whose slots name one position twice with a sum past int8: in
    every third group slots 0 and 1 both at slot 0's position with value
    127 (a weight of 254), in every seventh both -128 (-256)."""
    vals, idx = vals.clone(), idx.clone()
    idx[:, ::3, 1] = idx[:, ::3, 0]
    vals[:, ::3, :2] = 127
    idx[:, ::7, 1] = idx[:, ::7, 0]
    vals[:, ::7, :2] = -128
    return vals, idx


# (M, N, K) of row 5's int32 route: decode at a site's shape, K past the
# expand kernel's staged window, a prefill cohort, a block of 4 groups of 4
# rows
DUPLICATE_CASES = ((4, 256, 1536), (5, 70, 8960), (128, 70, 300),
                   (13, 70, 200))


def phase_duplicate_slots(torch, sm, nm, seed):
    """Rows 4 (``nm_spmm``) and 5 (``nm_seq_policy_matmul``) on slabs whose
    slots name one position twice, their sum past int8 (the expanded
    weight 254 or -256): the smallest case (``smallest_duplicate``) must give
    the plain version's (254, 32258) under ``nm_spmm`` and row 5's ``wide``
    (the tile's bytes would wrap it to (-2, -254)); then at
    ``DUPLICATE_CASES`` row 4 on ``WIDE_SLABS`` and row 5 under every
    policy (``sorted_tiled_seq`` at rounds 0 to 3 with acc_bits 2, 16 and
    30, ``clip`` and ``wrap`` at 2 and 30, ``wide``), each on its int32
    route, against the plain version. Returns the max |difference| of
    each kernel."""
    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    worst = {"nm_spmm": 0, "nm_seq_policy_matmul": 0}
    x, vals, idx = smallest_duplicate(torch)
    smallest = {name: fn(x, vals, idx, m_group=16).flatten().tolist()
                for name, fn in (
                    ("nm_spmm", nm.nm_spmm),
                    ("nm_seq_policy_matmul", lambda *a, **kw:
                     nm.nm_seq_policy_matmul(*a, policy="wide", **kw)))}
    print(f"  smallest duplicate case (254 at position 0, x = 1 and 127): "
          f"{smallest}, want [254, 32258] each", flush=True)
    for name, got in smallest.items():
        worst[name] = max(worst[name], *(abs(a - b) for a, b in zip(
            got, (254, 32258))))
    runs = [("sorted_tiled_seq", r, b) for r in range(4) for b in (2, 16, 30)]
    runs += [(p, 1, b) for p in ("clip", "wrap") for b in (2, 30)]
    runs += [("wide", 1, 16)]
    for i, (m, n, k) in enumerate(DUPLICATE_CASES):
        errs = []
        for j, (n_keep, m_group) in enumerate(WIDE_SLABS):
            x, _, vals, idx = nm_operands(torch, m, n, k, seed + 340 + i + j,
                                          n_keep, m_group)
            sv, si = stacked_slabs(torch, vals, idx)
            errs.append(diff(nm.nm_spmm(x, sv, si, m_group=m_group),
                             nm.nm_spmm_ref(x, sv, si, m_group=m_group)))
        worst["nm_spmm"] = max(worst["nm_spmm"], *errs)
        x, _, vals, idx = nm_operands(torch, m, n, k, seed + 350 + i)
        sv, si = stacked_slabs(torch, vals, idx)
        seq = []
        for policy, rounds, acc_bits in runs:
            kw = dict(m_group=M_GROUP, policy=policy, acc_bits=acc_bits,
                      rounds=rounds, k_tile=256)
            seq.append(diff(nm.nm_seq_policy_matmul(x, sv, si, **kw),
                            nm.nm_seq_policy_matmul_ref(x, sv, si, **kw)))
        worst["nm_seq_policy_matmul"] = max(worst["nm_seq_policy_matmul"],
                                            *seq)
        print(f"  duplicate slots past int8 M={m:3d} N={n:4d} K={k:5d}: "
              f"nm_spmm at {'/'.join(f'{a}:{b}' for a, b in WIDE_SLABS)} "
              f"max|diff| {errs}; nm_seq_policy_matmul over {len(runs)} "
              f"policy runs max|diff| {max(seq)}", flush=True)
    if any(worst.values()):
        raise AssertionError(f"duplicate slots past int8: {worst}")
    return worst


# Row 3's bodies (quant_matmul_body): M at decode, around the 8-, 16- and
# 32-row instructions and above 128; (K, N) TMA can take and ragged ones
# it cannot; operands 0, 1 and 4 bytes off alignment (the TMA body only
# at 0)
QM_MS = (1, 4, 5, 16, 17, 64, 128, 200)
QM_SHAPES = ((1536, 256), (272, 144), (300, 70), (33, 129))
QM_WRAP_K = 131088  # 16384 K > 2^31: the all -128 sum wraps


def phase_quant_matmul_bodies(torch, sm, qm, seed):
    """Row 3 on each of its bodies against its plain version, bit for bit:
    at ``QM_MS`` x ``QM_SHAPES`` x offsets 0, 1 and 4 (x and w copied that
    many bytes off 16-byte alignment), the int8 extremes at the corners;
    the TMA body where ``quant_matmul_body`` names it (aligned operands, N
    and K multiples of 16), the KnRows body everywhere, and the default
    call on the body the choice function names (``body_launches``); each
    also equal to ``seq_policy_matmul`` under ``wide`` on wᵀ. Then the
    int32 wrap (K = 131088, all -128: the sum passes 2^31) on both bodies.
    Returns the max |difference| against the plain version."""
    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    worst = cross = 0
    chosen = set()
    for i, (m, (k, n), offset) in enumerate(
            (m, s, o) for m in QM_MS for s in QM_SHAPES for o in (0, 1, 4)):
        x, wt = operands(torch, m, n, k, seed + 600 + i)
        w = wt.t().contiguous()
        x[0], w[:, 0] = -128, -128
        if m > 1:
            x[-1] = 127
        if n > 1:
            w[:, -1] = 127
        x, w = offset_copy(torch, x, offset), offset_copy(torch, w, offset)
        want = qm.quant_matmul_ref(x, w)
        body = qm.quant_matmul_body(n, k, x.data_ptr(), w.data_ptr())
        before = dict(qm.quant_matmul.body_launches)
        errs = {"default": diff(qm.quant_matmul(x, w), want)}
        if qm.quant_matmul.body_launches[body] != before[body] + 1:
            raise AssertionError(f"quant_matmul at M={m} K={k} N={n} "
                                 f"offset {offset} did not run {body}")
        chosen.add(body)
        for b in ({"kn_rows", body}):
            errs[b] = diff(qm.quant_matmul(x, w, body=b), want)
        cross = max(cross, diff(sm.seq_policy_matmul(
            x, w.t().contiguous(), policy="wide"), want))
        worst = max(worst, *errs.values())
        if offset == 0 and m in (1, 17, 200):
            print(f"  quant_matmul bodies M={m:3d} K={k:5d} N={n:4d}: "
                  f"chosen {body}, max|diff| {errs}", flush=True)
    x = torch.full((3, QM_WRAP_K), -128, dtype=torch.int8, device="cuda")
    w = torch.full((QM_WRAP_K, 32), -128, dtype=torch.int8, device="cuda")
    want = qm.quant_matmul_ref(x, w)
    wrap = (128 * 128 * QM_WRAP_K + (1 << 31)) % (1 << 32) - (1 << 31)
    errs = {b: diff(qm.quant_matmul(x, w, body=b), want)
            for b in qm.BODIES}
    worst = max(worst, *errs.values(), abs(int(want[0, 0]) - wrap))
    print(f"  quant_matmul int32 wrap at K={QM_WRAP_K}: {int(want[0, 0])} "
          f"(wrapped {wrap}), bodies {errs}; bodies chosen {chosen}; vs the "
          f"wide policy {cross}", flush=True)
    if worst or cross or chosen != set(qm.BODIES):
        raise AssertionError(f"quant_matmul bodies disagree: {worst}, vs "
                             f"wide {cross}, chosen {chosen}")
    return worst


def prompts(n, seed, vocab):
    import numpy as np

    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=int(r.integers(20, 33))).astype(
        np.int32) for _ in range(n)]


def model_params(cfg, seed, compressed):
    """The model and its 8:16 pruned int8 params, dense or compressed."""
    from repro_torch.core.qtensor import nm_compress_tree, quantize_tree
    from repro_torch.models.model import build_model

    model = build_model(cfg)
    params = quantize_tree(model.init(seed), bits=8, n_keep=N_KEEP,
                           m=M_GROUP)
    if compressed:
        params = nm_compress_tree(params, N_KEEP, M_GROUP)
    return model, params


def serve(torch, cfg, seed, backend=None, new_tokens=16, compressed=False,
          nm_impl=None, policy="sorted_tiled_seq", built=None, reqs=None,
          max_len=128, first=None):
    """Serve greedy requests on 4 slots under ``policy``: ``reqs`` (by
    default 4 prompts of 20-32 tokens, ``new_tokens`` each) on ``built``
    = (model, params) (by default ``cfg`` built, quantized and, when
    ``compressed``, compressed), with the context ``first`` entered around
    step 1. Returns (requests, engine, seconds of step 1 (admission,
    prefill, first decode), seconds of the later decode steps)."""
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.serving import Request, ServingEngine

    model, params = built or model_params(cfg, seed, compressed)
    torch.cuda.empty_cache()
    eng = ServingEngine(model, params, num_slots=4, max_len=max_len,
                        int_lin=IntegerLinConfig(policy=policy,
                                                 backend=backend,
                                                 nm_impl=nm_impl))
    reqs = reqs or [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
                    for i, p in enumerate(prompts(4, seed, cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with first or contextlib.nullcontext():
        eng.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    while eng.step():
        pass
    torch.cuda.synchronize()
    return reqs, eng, t1 - t0, time.perf_counter() - t1


def reset(counters):
    for fn in counters.values():
        fn.launches = 0
        if hasattr(fn, "policy_launches"):
            fn.policy_launches = dict.fromkeys(fn.policy_launches, 0)


def check_served(counters, eng, reqs, vocab, need_per_step):
    """The gate of a counted serve: each kernel of ``need_per_step``
    launched that many times a step and every other kernel never; every
    request done with its new tokens, all in the vocabulary. Returns the
    launches by kernel that ran and the engine's steps."""
    steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    for r in reqs:
        if not r.done or len(r.output) != r.max_new_tokens or not all(
                0 <= t < vocab for t in r.output):
            raise AssertionError(f"request {r.uid} incomplete or out of "
                                 f"range: {r.output}")
    launches = {name: fn.launches for name, fn in counters.items()
                if fn.launches}
    need = {name: per * steps for name, per in need_per_step.items() if per}
    if launches != need:
        raise AssertionError(f"launches {launches} != {need}, the others 0")
    return launches, steps


def phase_serve(torch, counters, cfg, seed, expect, compressed=False,
                policy="sorted_tiled_seq", want_tokens=None, nm_impl=None):
    """Serve the full-width model (dense or compressed storage, through
    the ``nm_impl`` kernels) under ``policy`` with every launch count set
    to 0 just before and read just after. ``expect`` maps each kernel of
    the path to its launches per layer and step; every other kernel must
    launch 0 times (and the tokens must equal ``want_tokens`` when given).
    Returns (launches by kernel, decode steps, tokens, the s a decode step
    and the prefill s)."""
    reset(counters)
    reqs, eng, t_first, t_rest = serve(torch, cfg, seed,
                                       compressed=compressed, policy=policy,
                                       nm_impl=nm_impl)
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    need = {name: per * cfg.num_layers * steps
            for name, per in expect.items()}
    decode_steps = eng.stats["decode_steps"]
    per_step = t_rest / max(decode_steps - 1, 1)
    tokens = sum(len(r.output) for r in reqs)
    print(f"  served {len(reqs)} requests, {tokens} tokens from "
          f"{'compressed' if compressed else 'dense'} storage "
          f"(nm_impl {nm_impl}) under {policy}: prefill steps "
          f"{eng.stats['prefill_steps']}, decode steps {decode_steps}",
          flush=True)
    print(f"  step 1 (prefill + first decode) {t_first:.3f} s; later decode "
          f"{t_rest:.3f} s over {decode_steps - 1} steps = {per_step:.4f} "
          f"s/step; prefill alone ~ {t_first - per_step:.3f} s", flush=True)
    print(f"  decode throughput {4 * (decode_steps - 1) / t_rest:.2f} "
          f"tokens/s (4 slots); end to end {tokens / (t_first + t_rest):.2f}"
          f" generated tokens/s", flush=True)
    per = {name: n / steps for name, n in launches.items() if n}
    print(f"  launches {launches}; need {need} (per layer and step "
          f"{expect} x {cfg.num_layers} layers x {steps} steps), the "
          f"others 0; per step {per}", flush=True)
    check_served(counters, eng, reqs, cfg.vocab_size,
                 {name: per * cfg.num_layers for name, per in expect.items()})
    outputs = [r.output for r in reqs]
    print(f"  request 0 tokens {outputs[0]}", flush=True)
    if want_tokens is not None:
        if outputs != want_tokens:
            raise AssertionError(f"compressed tokens {outputs} differ from "
                                 f"the dense tokens {want_tokens}")
        print("  tokens identical to the dense storage's", flush=True)
    profile_decode(torch, eng, cfg.vocab_size)
    return launches, decode_steps, outputs, dict(per_step=per_step,
                                                 prefill=t_first - per_step)


def profile_decode(torch, eng, vocab, span=None):
    """``profile_steps`` over two decode steps of the served model (after
    the counted run: 4 new requests admitted and prefilled first), and the
    tied head's dequantize alone. Returns the profile's record and the
    head's ms."""
    from repro_torch.serving import Request

    for i, p in enumerate(prompts(4, 1, vocab)):
        eng.submit(Request(uid=100 + i, prompt=p, max_new_tokens=4))
    eng.step()  # admission, prefill and the first decode
    torch.cuda.synchronize()
    out = profile_steps(torch, lambda: (eng.step(), eng.step()), span)
    out["head_dequantize_ms"] = table_dequantize_ms(torch,
                                                    eng.params["embed"])
    while eng.step():
        pass
    return out


def profile_steps(torch, run, span=None):
    """Device time by kernel and host time by operator over ``run`` (two
    decode steps), the device's busy share of the wall. Returns the wall,
    device busy and PQS kernel ms, the ``cudaLaunchKernel`` calls, and the
    ms that the ``record_function`` range ``span`` covers on the device's
    timeline."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # kernel rows only: operator rows repeat their kernels' device time,
    # and a record_function range also leaves a device-side row, its
    # extent on the device's timeline
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA and e.key != span),
                    key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in events) / 1e3
    print(f"  profile of 2 decode steps ({len(events)} kernel names): wall "
          f"{wall_ms:.1f} ms, device busy "
          f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for e in events[:10]:
        if dev_us(e) <= 0:
            break
        print(f"    {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}",
              flush=True)
    # the port's own kernels: the *_kernel names of csrc/ (PyTorch has
    # anonymous namespaces too)
    from repro_torch.kernels import build

    ours = {k for f in build.CSRC.glob("*.cu*")
            for k in re.findall(r"\b(\w+_kernel)\b", f.read_text())}

    def name(e):  # without namespaces (mma8::, nmsums::, kn::, anonymous)
        key = re.sub(r"(\(anonymous namespace\)|\b\w+)::", "", e.key)
        return key.split("(")[0].replace("void ", "")

    pqs = [e for e in events if name(e).split("<")[0] in ours]
    pqs_ms = sum(dev_us(e) for e in pqs) / 1e3
    print(f"  PQS kernels: {pqs_ms:.3f} ms device "
          f"time in {sum(e.count for e in pqs)} launches: " + "; ".join(
              f"{name(e)} {dev_us(e) / 1e3:.3f} ms x{e.count}" for e in pqs),
          flush=True)
    # the host side: operators and CUDA runtime calls by self CPU time
    # (inflated by the profiler's own cost per operator)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    launch_calls = sum(e.count for e in host if e.key == "cudaLaunchKernel")
    print(f"  host: {sum(e.count for e in host)} calls, "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms self "
          f"CPU time, {launch_calls} cudaLaunchKernel; the largest:",
          flush=True)
    for e in host[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    span_ms = None
    if span is not None:
        rows = [e for e in prof.key_averages()
                if e.key == span and e.device_type == DeviceType.CUDA]
        span_ms = sum(dev_us(e) for e in rows) / 1e3
        print(f"  span {span}: {sum(e.count for e in rows)} ranges, "
              f"{span_ms:.3f} ms from their first kernel's start to their "
              "last one's end on the device", flush=True)
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, pqs_ms=pqs_ms,
                span_ms=span_ms, launch_calls=launch_calls)




def table_dequantize_ms(torch, emb):
    """The ms of dequantizing the embedding table to bfloat16 (the tied
    head does it every step): host clock to synchronize, mean of 3."""
    from repro_torch.core.qtensor import asarray

    asarray(emb, torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        asarray(emb, torch.bfloat16)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 3 * 1e3
    print(f"  tied head dequantize ({type(emb).__name__} "
          f"{tuple(emb.shape)}): {ms:.2f} ms (host clock to synchronize, "
          "mean of 3 after one)", flush=True)
    return ms


PARITY_NEW_TOKENS = 4  # phase 4's serves (16 until 9a-9c joined the run)


def parity_requests(cfg, seed, new_tokens):
    """4 greedy requests whose prompts are the first 5-8 tokens of
    ``prompts``: phases 4 and 4b's plain versions prefill an 8-token bucket
    (32 rows of x) instead of 32 tokens (128 rows)."""
    from repro_torch.serving import Request

    return [Request(uid=i, prompt=p[: 5 + i], max_new_tokens=new_tokens)
            for i, p in enumerate(prompts(4, seed, cfg.vocab_size))]


def phase_parity(torch, counters, cfg, seed):
    """1 layer at full width (every site of the model; the depth is cut to
    keep the plain version's serve short): the dense kernel and its plain
    version, and the compressed weights through the gather and the expand
    kernel, give the same tokens (``parity_requests``,
    ``PARITY_NEW_TOKENS`` new ones) and decode logits; the expand serve
    must launch the expand kernel at every site and the gather kernel
    never."""
    from repro_torch.core.qtensor import nm_compress_tree

    cfg1 = dataclasses.replace(cfg, num_layers=1)
    outs = {}
    for name, kw in (("cuda", dict(backend="cuda")),
                     ("torch", dict(backend="torch")),
                     ("gather", dict(compressed=True, nm_impl="gather")),
                     ("expand", dict(compressed=True, nm_impl="expand"))):
        reset(counters)
        t0 = time.perf_counter()
        reqs, eng, _, _ = serve(torch, cfg1, seed, reqs=parity_requests(
            cfg1, seed, PARITY_NEW_TOKENS), **kw)
        outs[name] = [r.output for r in reqs]
        print(f"  1-layer serve, {name}: {time.perf_counter() - t0:.1f} s; "
              f"launches {dict((k, f.launches) for k, f in counters.items())}",
              flush=True)
        if name == "expand":
            steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
            need = len(SITES) * cfg1.num_layers * steps
            expand_launches = counters["nm_seq_policy_matmul"].launches
            if expand_launches < need or counters[
                    "nm_gather_seq_policy_matmul"].launches:
                raise AssertionError(f"expand path: {expand_launches} "
                                     f"launches < {need}, or gather ran")
    if any(o != outs["cuda"] for o in outs.values()):
        raise AssertionError(f"tokens differ: {outs}")
    model, params = model_params(cfg1, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    check_logits(torch, model, cfg, seed, (
        ("cuda", params, dict(backend="cuda")),
        ("torch", params, dict(backend="torch")),
        ("gather", sparse, dict(nm_impl="gather")),
        ("expand", sparse, dict(nm_impl="expand"))))


def decode_logits(torch, model, params, cfg, seed, kw, record=False):
    """Logits of one decode after a prefill of 4 prompts' first 16 tokens
    under ``IntegerLinConfig(**kw)`` (with ``census=True`` in ``kw``: under
    a ``census_monitor``), and with ``record`` every ``pqs_dot`` call of
    the decode kept (``DotRecorder``). Returns (logits, the census totals
    or None, the recorder or None)."""
    from repro_torch.core import dispatch

    kw = dict(kw)
    mon = dispatch.CensusMonitor() if kw.pop("census", False) else None
    rec = DotRecorder(dispatch) if record else None
    toks = torch.tensor([p[:16].tolist() for p in prompts(4, seed,
                                                          cfg.vocab_size)],
                        device="cuda", dtype=torch.int32)
    caches = model.init_caches(params, 4, 32, torch.float32)
    with torch.no_grad(), dispatch.integer_lin(
            dispatch.IntegerLinConfig(**kw)), (
            dispatch.census_monitor(mon) if mon is not None
            else contextlib.nullcontext()):
        _, caches = model.prefill(params, toks, caches, torch.full(
            (4,), 16, device="cuda", dtype=torch.int32))
        with rec if rec is not None else contextlib.nullcontext():
            logits, _ = model.decode(params, toks[:, -1:], caches)
    torch.cuda.synchronize()
    return logits, None if mon is None else mon.totals(), rec


def check_logits(torch, model, cfg, seed, runs):
    """``decode_logits`` for each (name, params, IntegerLinConfig keywords)
    of ``runs`` (``census=True`` among them: the run under a
    ``census_monitor``): all must equal the first run's, and be finite.
    Returns each census-watched run's totals."""
    logits, monitors = {}, {}
    for name, p, kw in runs:
        logits[name], totals, _ = decode_logits(torch, model, p, cfg, seed,
                                                kw)
        if totals is not None:
            monitors[name] = totals
            print(f"  {name}: census (dots, events) by site {totals}",
                  flush=True)
    first = runs[0][0]
    ref = logits[first].float()
    finite = bool(torch.isfinite(ref).all())
    diffs = {name: float((lg.float() - ref).abs().max())
             for name, lg in logits.items()}
    print(f"  decode logits {tuple(ref.shape)}: max |x - {first}| = "
          f"{diffs}, finite={finite}", flush=True)
    if any(diffs.values()) or not finite:
        raise AssertionError("logits differ or are not finite")
    return monitors


def phase_logits_28(torch, cfg, seed):
    """One full-depth (28-layer) decode's logits, after a prefill of 4 x
    16 tokens, bit for bit within each group the serve phases compare by
    tokens: dense, gather (``auto``) and expand storage under
    ``sorted_tiled_seq`` (3 / 3b / 3j); dense, gather and expand under
    ``sorted_tiled`` (3c / 3e / 3g) and under ``sorted`` (3d / 3f / 3h);
    dense and compressed (``auto``: expand, row 5) under ``wide`` (3k).
    The tokens of a 28-layer serve compare about one argmax a request;
    the logits compare every value."""
    from repro_torch.core.qtensor import nm_compress_tree

    model, params = model_params(cfg, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    for policy, impls in (("sorted_tiled_seq", (None, "expand")),
                          ("sorted_tiled", (None, "expand")),
                          ("sorted", (None, "expand")),
                          ("wide", (None,))):
        t0 = time.perf_counter()
        check_logits(torch, model, cfg, seed, [
            ("dense", params, dict(policy=policy))] + [
            (f"compressed {impl or 'auto'}", sparse,
             dict(policy=policy, nm_impl=impl)) for impl in impls])
        print(f"  {policy}: {time.perf_counter() - t0:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# the serving guardrails: the overflow census, calibration, CensusWatch and
# certification
# ---------------------------------------------------------------------------

CENSUS_FIELDS = ("n_dots", "n_persistent", "n_transient", "n_any",
                 "n_combine")
WATCH = dict(threshold=0.01, window=4)


def seq_wrapper(storage, policy, k):
    """The K-streaming wrapper a site of contraction ``k`` launches under
    ``policy``: row 1 on dense storage; on compressed storage the kernel
    ``ops.resolve_nm_impl`` picks (``auto``), row 6 (gather) or row 5
    (expand, every ``wide``)."""
    from repro_torch.kernels.ops import resolve_nm_impl

    if storage == "dense":
        return "seq_policy_matmul"
    impl = resolve_nm_impl(policy, -(-k // M_GROUP), N_KEEP, M_GROUP)
    return "nm_gather_seq_policy_matmul" if impl == "gather" \
        else "nm_seq_policy_matmul"


def census_ints(c):
    return [int(getattr(c, f)) for f in CENSUS_FIELDS]


def max_diff(torch, a, b):
    torch.cuda.synchronize()
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def phase_census(torch, seed):
    """``pqs_dot(with_census=True)`` on the card at layer 0's 7 site
    shapes, on seeded near-extreme int8 rows (x[0] = w[0] = 127, so a
    16-bit register overflows) and 8:16-pruned weights: at M = 4 the
    census equals, field by field, the one of the same int8 tensors on
    the CPU (``overflow.census`` of their partial products); compressed
    (gather and expand) equals dense on the decompressed weight; at M =
    128 it equals the sum of its 4-row chunks and the census of one chunk
    of all 128 rows (the census budget lifted); ``out`` is the same with
    and without the census. Returns the largest difference (0)."""
    from repro_torch.core import dispatch
    from repro_torch.core.overflow import census, partial_products

    worst = 0
    kw = dict(policy="sorted_tiled_seq", acc_bits=16)
    for site, (n, k) in SITES.items():
        x, w, vals, idx = nm_operands(torch, 4, n, k, seed + 500)
        out, dense = dispatch.pqs_dot(x, w, with_census=True, **kw)
        worst = max(worst, max_diff(torch, out, dispatch.pqs_dot(x, w, **kw)))
        want = census_ints(dense)
        cpu = census_ints(census(partial_products(w.cpu(), x.cpu()), 16))
        nm = {}
        for impl in ("gather", "expand"):
            o, c = dispatch.pqs_dot(x, (vals, idx), storage="nm",
                                    m_group=M_GROUP, nm_impl=impl,
                                    with_census=True, **kw)
            worst = max(worst, max_diff(torch, o, out))
            nm[impl] = census_ints(c)
        x128 = operands(torch, 128, 1, k, seed + 600)[0]
        o128, c128 = dispatch.pqs_dot(x128, w, with_census=True, **kw)
        chunks = [0] * len(CENSUS_FIELDS)
        for i in range(0, 128, 4):
            o, c = dispatch.pqs_dot(x128[i : i + 4], w, with_census=True,
                                    **kw)
            worst = max(worst, max_diff(torch, o, o128[i : i + 4]))
            chunks = [a + b for a, b in zip(chunks, census_ints(c))]
        budget = dispatch._CENSUS_BUDGET
        dispatch._CENSUS_BUDGET = 1 << 40  # all 128 rows in one chunk
        try:
            whole = census_ints(dispatch.pqs_dot(x128, w, with_census=True,
                                                 **kw)[1])
        finally:
            dispatch._CENSUS_BUDGET = budget
        torch.cuda.empty_cache()
        print(f"  census {site:6s} N={n:5d} K={k:5d} ({', '.join(CENSUS_FIELDS)}"
              f"): M=4 card {want}, CPU {cpu}, gather {nm['gather']}, expand "
              f"{nm['expand']}; M=128 {census_ints(c128)}, its 4-row chunks "
              f"{chunks}, one chunk {whole}", flush=True)
        if not (want == cpu == nm["gather"] == nm["expand"]) or not (
                census_ints(c128) == chunks == whole) or not want[3]:
            raise AssertionError(f"{site}: the censuses disagree (or no "
                                 "event at M = 4)")
    if worst:
        raise AssertionError(f"outputs differ with the census: {worst}")
    return worst


def calibration_batch(cfg, seed):
    """One seeded calibration batch: 4 rows of 32 tokens."""
    import numpy as np

    r = np.random.default_rng(seed + 9)
    return {"tokens": r.integers(0, cfg.vocab_size, (4, 32)).astype(
        np.int32)}


def policy_launches(counters):
    return {name: dict(fn.policy_launches) for name, fn in counters.items()
            if hasattr(fn, "policy_launches")}


def guarded_serve(torch, counters, cfg, seed, model, params, certificate=None,
                  calibrate=True):
    """Serve 4 greedy requests of 16 new tokens under ``sorted_tiled_seq``
    at 16 bits with a ``CensusWatch(threshold=0.01, window=4)`` (and the
    certificate, when given), one engine step at a time, every launch
    count set to 0 just before. Returns what each step launched (by
    wrapper and policy), the sites degraded before it and its seconds,
    each window's drained census totals, and the engine."""
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.serving import CensusWatch, Request, ServingEngine

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    eng = ServingEngine(model, params, num_slots=4, max_len=128,
                        int_lin=IntegerLinConfig(policy="sorted_tiled_seq",
                                                 certificate=certificate),
                        census_watch=CensusWatch(**WATCH))
    built = time.perf_counter() - t0
    calibrated = None
    if calibrate:
        t0 = time.perf_counter()
        eng.calibrate([calibration_batch(cfg, seed)])
        torch.cuda.synchronize()
        calibrated = time.perf_counter() - t0
    windows = []
    drain = eng._census.drain

    def recording_drain():
        windows.append(drain())
        return windows[-1]

    eng._census.drain = recording_drain
    reset(counters)
    reqs = [Request(uid=i, prompt=p, max_new_tokens=16)
            for i, p in enumerate(prompts(4, seed, cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    steps = []
    while True:
        before = ({n: f.launches for n, f in counters.items()},
                  policy_launches(counters), set(eng._degraded),
                  eng.stats["prefill_steps"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        busy = eng.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not busy:
            break
        launches = {n: f.launches - before[0][n] for n, f in counters.items()}
        by_policy = {n: {p: v - before[1][n][p] for p, v in pol.items()
                         if v - before[1][n][p]}
                     for n, pol in policy_launches(counters).items()}
        steps.append(dict(launches=launches, by_policy=by_policy,
                          degraded=before[2], seconds=dt,
                          passes=1 + eng.stats["prefill_steps"] - before[3]))
    eng._census.drain = drain
    for r in reqs:
        if not r.done or len(r.output) != 16 or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: {r.output}")
    per_step = sum(s["seconds"] for s in steps[1:]) / max(len(steps) - 1, 1)
    print(f"  engine built in {built:.2f} s"
          + (f", calibrated on 4 x 32 tokens in {calibrated:.2f} s"
             if calibrate else "")
          + f"; {len(steps)} steps: step 1 (prefill + first decode) "
          f"{steps[0]['seconds']:.3f} s, later decode {per_step:.4f} s/step, "
          f"prefill alone ~ {steps[0]['seconds'] - per_step:.3f} s; each step "
          + " ".join(f"{s['seconds']:.3f}" for s in steps), flush=True)
    return dict(eng=eng, steps=steps, windows=windows,
                tokens=[r.output for r in reqs], per_step=per_step,
                prefill=steps[0]["seconds"] - per_step)


def check_degradation(run, storage, layers):
    """3l / 3m: every window's per-site rates and the degrades printed;
    a degraded site reads rate 0.0 in every later window; each step
    launched the narrow kernel at the undegraded sites and the ``wide``
    one at the degraded sites, 28 of each a site and pass, and nothing
    else; the other sites keep ``sorted_tiled_seq``."""
    eng = run["eng"]
    degraded = set()
    for j, totals in enumerate(run["windows"]):
        rates = {s: (e / d if d else 0.0) for s, (d, e) in totals.items()}
        print(f"  window {j + 1}: " + ", ".join(
            f"{s} {rates[s]:.4f} ({e}/{d})"
            for s, (d, e) in sorted(totals.items())), flush=True)
        if set(totals) != set(SITES):
            raise AssertionError(f"window {j + 1} sites {sorted(totals)}")
        stale = [s for s in degraded if rates[s] != 0.0]
        if stale:
            raise AssertionError(f"degraded {stale} read a rate above 0")
        degraded |= {s for s, r in rates.items()
                     if r > WATCH["threshold"]}
    for ev in eng.events:
        print(f"  event {ev}", flush=True)
    if degraded != eng._degraded or eng.stats["census_degrades"] != len(
            eng._degraded):
        raise AssertionError(f"degraded {eng._degraded}, by the rates "
                             f"{degraded}, stats {eng.stats}")
    for i, step in enumerate(run["steps"]):
        need = {}
        for site, (_, k) in SITES.items():
            policy = "wide" if site in step["degraded"] else \
                "sorted_tiled_seq"
            name = seq_wrapper(storage, policy, k)
            need.setdefault(name, {}).setdefault(policy, 0)
            need[name][policy] += layers * step["passes"]
        got = {n: p for n, p in step["by_policy"].items() if p}
        others = {n: v for n, v in step["launches"].items()
                  if v and n not in need}
        if got != need or others:
            raise AssertionError(f"step {i + 1}: launches {got} (others "
                                 f"{others}), need {need}")
    kept = [s for s in SITES if s not in eng._degraded]
    if any(eng.int_lin.policy_for(s) != "sorted_tiled_seq" for s in kept) \
            or any(eng.int_lin.policy_for(s) != "wide"
                   for s in eng._degraded):
        raise AssertionError(f"site policies {eng.int_lin.site_policies}")
    print(f"  degraded {sorted(eng._degraded)} (to wide: "
          f"{seq_wrapper(storage, 'wide', 1536)} from the step after); kept "
          f"sorted_tiled_seq: {kept}; every step's launches by policy as "
          "required", flush=True)


def census_profile(torch, eng, vocab):
    """The census's device time at decode: two profiles of 2 decode steps
    of the served engine with every site back under ``sorted_tiled_seq``
    (the degrades undone, no window checked inside them), the census on,
    its calls in a ``pqs_census`` span, then off. The census's kernels
    take the difference of the device's busy time. Returns the ms of each
    per 2 steps."""
    from torch.profiler import record_function

    from repro_torch.core import dispatch

    census = dispatch._census

    def traced(*args, **kw):
        with record_function("pqs_census"):
            return census(*args, **kw)

    int_lin, watch, monitor = eng.int_lin, eng.census_watch, eng._census
    for site in eng._degraded:
        eng.int_lin = eng.int_lin.without_site(site)
    eng.census_watch = None
    dispatch._census = traced
    try:
        on = profile_decode(torch, eng, vocab, span="pqs_census")
        eng._census = None
        off = profile_decode(torch, eng, vocab)
    finally:
        dispatch._census = census
        eng.int_lin, eng.census_watch, eng._census = int_lin, watch, monitor
    census_ms = on["busy_ms"] - off["busy_ms"]
    print(f"  census at decode, every site censused, per 2 steps: its "
          f"kernels {census_ms:.1f} ms of device time (busy "
          f"{on['busy_ms']:.1f} ms with it, {off['busy_ms']:.1f} without; "
          f"PQS kernels {on['pqs_ms']:.1f}), spread over "
          f"{on['span_ms']:.1f} ms of the device's timeline; wall "
          f"{on['wall_ms']:.1f} / {off['wall_ms']:.1f} ms", flush=True)
    return dict(census_ms=census_ms, span_ms=on["span_ms"],
                busy_on_ms=on["busy_ms"], busy_off_ms=off["busy_ms"],
                pqs_ms=on["pqs_ms"], wall_on_ms=on["wall_ms"],
                wall_off_ms=off["wall_ms"])


def phase_census_serve(torch, counters, cfg, seed, compressed, want=None):
    """3l (dense) / 3m (compressed): build the full-width model, calibrate
    it on one seeded batch, serve it under ``CensusWatch(threshold=0.01,
    window=4)``; ``check_degradation``; 3m must give the events, the
    per-window site totals (the kept-only census against 3l's dense
    census on the same pruned codes) and the tokens of 3l (``want``)."""
    model, params = model_params(cfg, seed, compressed)
    run = guarded_serve(torch, counters, cfg, seed, model, params)
    check_degradation(run, "compressed" if compressed else "dense",
                      cfg.num_layers)
    run["events"] = list(run["eng"].events)
    if want is not None:
        same = {key: run[key] == want[key]
                for key in ("windows", "tokens", "events")}
        print(f"  the same as 3l: {same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"3m differs from 3l: {same}")
    print(f"  request 0 tokens {run['tokens'][0]}", flush=True)
    run["profile"] = census_profile(torch, run["eng"], cfg.vocab_size)
    # the record keeps the degraded sites, not the engine and its weights
    run["degraded"] = sorted(run.pop("eng")._degraded)
    return run


def phase_certified(torch, counters, cfg, seed):
    """3n: the full-width dense model's layers enforced to a 16-bit
    register at 8-bit codes (``enforce_acc_bounds``; the embedding is no
    projection, and its 151,936-long rows would truncate to zero), then
    ``certify_params``: every projection site safe at 16 bits. Served
    with the certificate and a ``CensusWatch``: no site reaches the
    monitor, nothing degrades, row 1's ``wide`` runs 196 launches a step
    and nothing else. The same weights served uncertified
    under ``sorted_tiled_seq`` at 16 bits with the census: 0 events at
    every site in every window, the certified serve's tokens, and one
    28-layer decode's logits equal to the certified ones bit for bit.
    Tampered weights are refused at construction."""
    from repro_torch.core import certify
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.core.qtensor import QTensor
    from repro_torch.core.tree import LayerStack
    from repro_torch.serving import ServingEngine

    model, params = model_params(cfg, seed, compressed=False)
    t0 = time.perf_counter()
    params["layers"] = certify.enforce_acc_bounds(params["layers"], 16, 8)
    t1 = time.perf_counter()
    cert = certify.certify_params(params, 16, 8)
    t2 = time.perf_counter()
    cert.verify(params)
    t3 = time.perf_counter()
    print(cert.summary(), flush=True)
    kept = sum(int((layer[SITE_SECTION[s]][s].values != 0).sum())
               for layer in params["layers"] for s in SITES)
    total = sum(layer[SITE_SECTION[s]][s].values.numel()
                for layer in params["layers"] for s in SITES)
    print(f"  host seconds: enforce_acc_bounds {t1 - t0:.2f}, certify_params "
          f"{t2 - t1:.2f}, verify {t3 - t2:.2f}, in all {t3 - t0:.2f}; "
          f"nonzero projection codes after enforcing {kept} of {total}",
          flush=True)
    unsafe = [s for s in SITES if cert.site(s) is None
              or cert.site(s).acc_bits_safe > 16]
    if unsafe:
        raise AssertionError(f"sites not certified at 16 bits: {unsafe}")
    runs = {}
    for name, c in (("certified", cert), ("censused", None)):
        print(f"  {name} serve:", flush=True)
        run = runs[name] = guarded_serve(torch, counters, cfg, seed, model,
                                         params, certificate=c,
                                         calibrate=False)
        eng = run["eng"]
        policy = "wide" if c is not None else "sorted_tiled_seq"
        for i, step in enumerate(run["steps"]):
            need = {"seq_policy_matmul": {
                policy: len(SITES) * cfg.num_layers * step["passes"]}}
            got = {n: p for n, p in step["by_policy"].items() if p}
            others = {n: v for n, v in step["launches"].items()
                      if v and n != "seq_policy_matmul"}
            if got != need or others:
                raise AssertionError(f"{name} step {i + 1}: {got} (others "
                                     f"{others}), need {need}")
        print(f"  {name}: windows {run['windows']}; events {eng.events}; "
              f"degrades {eng.stats['census_degrades']}", flush=True)
        if c is not None:
            profile_decode(torch, eng, cfg.vocab_size)
        if eng.events or eng._degraded:
            raise AssertionError(f"{name}: a site degraded: {eng.events}")
        if c is not None and (any(run["windows"]) or eng._census.totals()
                              or eng.last_census_rates):
            raise AssertionError("a certified site reached the monitor")
        if c is None and any(set(w) != set(SITES) or any(
                e for _, e in w.values()) for w in run["windows"]):
            raise AssertionError("the censused serve read an event")
    if runs["certified"]["tokens"] != runs["censused"]["tokens"]:
        raise AssertionError("certified and censused tokens differ")
    mons = check_logits(torch, model, cfg, seed, (
        ("certified", params, dict(certificate=cert)),
        ("censused", params, dict(census=True))))
    if any(e for _, e in mons["censused"].values()):
        raise AssertionError(f"the censused logits read events: {mons}")
    lay = dict(params["layers"][0])
    mlp = dict(lay["mlp"])
    v = mlp["w_up"].values.clone()
    c = int(v.view(-1)[0])
    v.view(-1)[0] = c + 1 if c < 127 else c - 1
    mlp["w_up"] = QTensor(v, mlp["w_up"].scale)
    lay["mlp"] = mlp
    tampered = {**params, "layers": LayerStack([lay] + params["layers"][1:])}
    try:
        ServingEngine(model, tampered, num_slots=4, max_len=128,
                      int_lin=IntegerLinConfig(certificate=cert))
    except certify.CertificateError as exc:
        print(f"  tampered weights refused at construction: {exc}",
              flush=True)
    else:
        raise AssertionError("tampered weights were served")
    for run in runs.values():
        del run["eng"]  # the record keeps no engine and its weights
    return dict(runs=runs, seconds=dict(enforce=t1 - t0, certify=t2 - t1,
                                        verify=t3 - t2))


# the kernel behind each result of the quickstart's matmuls
QUICKSTART_OUTPUTS = {"wide": "quant_matmul",
                      "dense_on_pruned": "quant_matmul", "nm_spmm": "nm_spmm",
                      "sorted": "seq_policy_matmul",
                      "clip": "seq_policy_matmul"}


def phase_quickstart(torch, counters):
    """``repro_torch.quickstart.run()`` on the card, every launch count
    set to 0 just before and read just after: it must launch
    ``quant_matmul``, ``nm_spmm`` and ``seq_policy_matmul``, print and
    return what ``run(device="cpu")`` does (the plain versions), but for
    the device label, and give each matmul's result (the wide and
    dense-on-pruned products, the compressed one, the sorted and clip
    registers at 18 bits) equal element by element to the plain version's
    on the same inputs; ``quant_matmul`` on its TMA-fed body each time.
    Returns the launches and the max |difference| of each kernel's results
    against their plain versions."""
    import contextlib
    import io

    from repro_torch import quickstart

    qm = counters["quant_matmul"]
    reset(counters)
    tma = qm.body_launches["tma"]
    card_out = io.StringIO()
    with contextlib.redirect_stdout(card_out):
        on_card, card_t = quickstart.run()
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    tma = qm.body_launches["tma"] - tma
    cpu_out = io.StringIO()
    with contextlib.redirect_stdout(cpu_out):
        on_cpu, cpu_t = quickstart.run(device="cpu")
    for line in card_out.getvalue().splitlines():
        print(f"  | {line}", flush=True)
    ran = {name: n for name, n in launches.items() if n}
    inputs = all(torch.equal(card_t[k].cpu(), cpu_t[k])
                 for k in ("x", "w", "pruned", "values", "indices"))
    err = dict.fromkeys(QUICKSTART_OUTPUTS.values(), 0)
    for key, kernel in QUICKSTART_OUTPUTS.items():
        e = int((card_t[key].cpu().long() - cpu_t[key].long()).abs().max())
        err[kernel] = max(err[kernel], e)
        print(f"  {key:15s} ({kernel}) on the card vs the plain version: "
              f"max|diff| {e}", flush=True)
    print(f"  launches {ran}; same inputs {inputs}; same numbers on the "
          f"CPU: {on_card == on_cpu}", flush=True)
    same = card_out.getvalue().replace("(kernel, cuda)", "(kernel, cpu)") \
        == cpu_out.getvalue()
    if on_card != on_cpu or not same or not inputs or any(err.values()):
        raise AssertionError(f"the quickstart differs on the card: "
                             f"{on_card} against {on_cpu}, same inputs "
                             f"{inputs}, max|diff| {err}")
    if set(ran) != {"quant_matmul", "nm_spmm", "seq_policy_matmul"}:
        raise AssertionError(f"the quickstart's kernels did not launch "
                             f"(or others did): {launches}")
    if tma != launches["quant_matmul"]:  # aligned operands throughout
        raise AssertionError(f"quant_matmul ran its TMA body {tma} of "
                             f"{launches['quant_matmul']} times")
    return launches, err


# the section of each projection site in a layer's params
SITE_SECTION = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
                "w_gate": "mlp", "w_up": "mlp", "w_out": "mlp"}


def layer0_weights(cfg, seed):
    """{site: (QTensor, SparseQTensor)} of layer 0 of the model phases 3
    and 3b serve: a layer's weights are drawn before the next layer's,
    so a 1-layer build of the same seed holds them."""
    from repro_torch.core.qtensor import nm_compress_tree

    _, params = model_params(dataclasses.replace(cfg, num_layers=1), seed,
                             compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    dense, comp = params["layers"][0], sparse["layers"][0]
    return {site: (dense[sec][site], comp[sec][site])
            for site, sec in SITE_SECTION.items()}


def phase_wide_full_width(torch, sm, qm, nm, cfg, seed):
    """Rows 3 and 4 at the 7 projection sites of layer 0, at decode (M =
    4) and a prefill cohort (M = 128): row 3 on ``QTensor.values`` (K, N),
    fed as stored, equals its plain version and row 1 under ``wide`` on
    ``values_t``; row 4 on the ``SparseQTensor`` slabs equals its plain
    version and row 3 on the decompressed weight, bit for bit; row 3 on
    its TMA-fed body at every site. Returns the max |difference| of each
    kernel against its plain version."""
    from repro_torch.core.pruning import nm_decompress

    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    worst = {"quant_matmul": 0, "nm_spmm": 0}
    cross = 0
    tma = qm.quant_matmul.body_launches["tma"]
    launches = qm.quant_matmul.launches
    for site, (qt, sq) in layer0_weights(cfg, seed).items():
        k, n = qt.values.shape
        if (n, k) != SITES[site] or sq.values.shape[0] != n:
            raise AssertionError(f"{site}: shapes {tuple(qt.values.shape)}, "
                                 f"{tuple(sq.values.shape)}")
        decomp = nm_decompress(sq.values, sq.indices, sq.m_group,
                               sq.k_dim).t().contiguous()
        for m in (4, 128):
            x = operands(torch, m, 1, k, seed + 400 + m)[0]
            row3 = qm.quant_matmul(x, qt.values)
            row4 = nm.nm_spmm(x, sq.values, sq.indices, m_group=sq.m_group)
            errs = (diff(row3, qm.quant_matmul_ref(x, qt.values)),
                    diff(row4, nm.nm_spmm_ref(x, sq.values, sq.indices,
                                              m_group=sq.m_group)))
            checks = (diff(row3, sm.seq_policy_matmul(x, qt.values_t,
                                                      policy="wide")),
                      diff(row4, qm.quant_matmul(x, decomp)),
                      int(not torch.equal(decomp, qt.values)))
            worst = {key: max(worst[key], e) for key, e in zip(worst, errs)}
            cross = max(cross, *checks)
            print(f"  full width {site:6s} M={m:3d} N={n:5d} K={k:5d}: "
                  f"max|diff| vs plain quant_matmul={errs[0]} "
                  f"nm_spmm={errs[1]}; quant_matmul vs wide policy "
                  f"{checks[0]}, nm_spmm vs quant_matmul on the "
                  f"decompressed weight {checks[1]}", flush=True)
    tma = qm.quant_matmul.body_launches["tma"] - tma
    if any(worst.values()) or cross or tma != (qm.quant_matmul.launches
                                               - launches):
        raise AssertionError(f"wide kernels at full width disagree: "
                             f"{worst}, cross-checks {cross}; quant_matmul "
                             f"ran its TMA body {tma} of "
                             f"{qm.quant_matmul.launches - launches} times")
    return worst


SORT_KERNELS = ("sort_matmul", "tile_sums_matmul", "paired_accum_matmul",
                "chunked_sort_matmul")
# launches per layer and decode step of each global-sort policy at
# qwen2-1.5b: the six K = 1536 sites one-pass, w_out (K = 8960) two-pass
SORT_PATHS = {
    "sorted_tiled": {"sort_matmul": 6, "tile_sums_matmul": 1,
                     "paired_accum_matmul": 1},
    "sorted": {"sort_matmul": 6, "chunked_sort_matmul": 1},
}


def sort_operands(torch, m, n, k, seed, k_tile=256):
    """``operands`` with tied tile sums: row 1 of x all zero, and row 2 of
    x and of w one k_tile pattern repeated."""
    x, w = operands(torch, m, n, k, seed)
    x[1] = 0
    x[2] = x[2, :k_tile].repeat(k // k_tile)
    w[2] = w[2, :k_tile].repeat(k // k_tile)
    return x, w


def phase_sort_kernels(torch, sm, ss, seed):
    """The four global-sort kernels against their plain versions,
    bit-exact, at every site shape at M = 4 and at (N, K) = (256, 1536) at
    M = 64, rounds 1 and 2, with tied tile sums; and the one-pass kernel
    equal to the two-pass pipeline under both policies (K = 1536 and 8960;
    ``sorted`` over kp = 2048 and 16384, given, as on the main path, the
    unpadded operands and kp). Returns the max |difference| of each kernel
    against its plain version."""
    from repro_torch.core.sorted_accum import pair_permutation
    from repro_torch.kernels.ops import next_pow2

    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    cases = [(4, n, k) for (n, k) in SHAPES] + [(64, 256, 1536)]
    worst = dict.fromkeys(SORT_KERNELS, 0)
    cross = 0
    for i, (m, n, k) in enumerate(cases):
        x, w = sort_operands(torch, m, n, k, seed + 100 + i)
        kp = next_pow2(k)
        for rounds in (1, 2):
            kw = dict(acc_bits=16, rounds=rounds)
            tk = dict(kw, k_tile=256)
            skw = dict(kw, kp=kp)
            one = sm.sort_matmul(x, w, policy="sorted_tiled", **tk)
            sums = ss.tile_sums_matmul(x, w, k_tile=256)
            perm = pair_permutation(sums).to(torch.int32)
            two = ss.paired_accum_matmul(x, w, perm, **tk)
            ones = sm.sort_matmul(x, w, policy="sorted", **skw)
            chunked = ss.chunked_sort_matmul(x, w, **skw)
            errs = {
                "sort_matmul": max(
                    diff(one, sm.sort_matmul_ref(x, w, policy="sorted_tiled",
                                                 **tk)),
                    diff(ones, sm.sort_matmul_ref(x, w, policy="sorted",
                                                  **skw))),
                "tile_sums_matmul": diff(
                    sums, ss.tile_sums_matmul_ref(x, w, k_tile=256)),
                "paired_accum_matmul": diff(
                    two, ss.paired_accum_matmul_ref(x, w, perm, **tk)),
                "chunked_sort_matmul": diff(
                    chunked, ss.chunked_sort_matmul_ref(x, w, **skw)),
            }
            passes = max(
                diff(one, ss.stream_sort_matmul(x, w, policy="sorted_tiled",
                                                **tk)),
                diff(ones, ss.stream_sort_matmul(x, w, policy="sorted",
                                                 **skw)))
            cross = max(cross, passes)
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
            tied = float((sums[1] == sums[1, :, :1]).float().mean())
            print(f"  sort kernels/plain M={m:3d} N={n:5d} K={k:5d} "
                  f"(sorted at {kp}) rounds={rounds} max|diff| {errs}; "
                  f"one-pass vs two-pass {passes}; tied sums in row 1 "
                  f"{tied:.2f}", flush=True)
    if any(worst.values()) or cross:
        raise AssertionError(f"global-sort kernels disagree: {worst}, "
                             f"one-pass vs two-pass {cross}")
    return worst


# kp regimes of the register-resident `sorted` body (csrc/pqs_accum.cuh
# sorted_dot): padded to 64 keys, one warp, the first exchange across
# warps, w_out's 16384 and 16 warps of 64 keys a lane
# one kp or two of each regime: the register network on one warp (32, 64,
# 2048), the radix body (4096; 16384 until 9a-9c joined the run) and the
# register network on 16 warps (65536)
SORTED_KP = (32, 64, 2048, 4096, 65536)
# kp where the body also runs with no round (natural order): one of the
# radix regime (and 65536 until 9a-9c joined the run)
NO_ROUND_KP = (4096,)


def sorted_rows(torch, m, k, n, seed):
    """``operands`` whose outputs probe the `sorted` body: (0, 0) all keys
    -16256, (0, 1) all 16384, row 1 of x all zero, (2, 2) keys of one sign
    and (2, 3) of the other."""
    x, w = operands(torch, m, n, k, seed)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x[0], w[0], w[1], x[1] = -128, 127, -128, 0
    x[2] = torch.randint(1, 128, (k,), generator=g, device="cuda")
    w[2] = torch.randint(1, 128, (k,), generator=g, device="cuda")
    w[3] = torch.randint(-128, 0, (k,), generator=g, device="cuda")
    return x, w


def phase_sorted_regimes(torch, sm, nm, seed):
    """The `sorted` body of rows 2 / 15 (dense), 8 / 17 (gather) and 7 / 16
    (expand) against their plain versions, bit-exact, at every kp regime
    of its shape (``SORTED_KP``; the gather twin's kept keys number kp:
    8:16 slabs of 2 kp positions), K short of kp (the tail masked) and,
    up to 4096, K = kp, M = 3, rounds 1, 2 and 3 at acc_bits 2, 30 and 16
    (the plain versions add the stream one step at a time), and at
    ``NO_ROUND_KP`` no round at acc_bits 16, with ``sorted_rows``; and the
    expand twin on slabs whose slots name one position three times (keys
    past int16: its int32 route) at each kp, one round (and none at
    ``NO_ROUND_KP``). Returns the max |difference| of each kernel."""
    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    worst = {"sort_matmul": 0, "nm_gather_sort_matmul": 0,
             "nm_sort_matmul": 0}
    for kp in SORTED_KP:
        short = max(1, kp - kp // 4 - 3)
        for k in sorted({kp, short} if kp <= 4096 else {short}):
            x, w = sorted_rows(torch, 3, k, 5, seed + kp + k)
            x2, w2 = sorted_rows(torch, 3, 2 * k, 5, seed + kp + k)
            slabs = {"nm_gather_sort_matmul": (x2, *prune(torch, w2)[1:]),
                     "nm_sort_matmul": (x, *prune(torch, w)[1:])}
            # the plain versions add one product a step: past 4096 keys
            # the body's regimes take rounds 3 and 0 at 16 bits only (the
            # rounds and widths are the same code at every kp)
            for rounds, acc_bits in (((1, 2), (2, 30)) if kp <= 4096 else ()
                                     ) + ((3, 16),) + (
                    ((0, 16),) if kp in NO_ROUND_KP else ()):
                kw = dict(policy="sorted", acc_bits=acc_bits, rounds=rounds)
                errs = {"sort_matmul": diff(
                    sm.sort_matmul(x, w, kp=kp, **kw),
                    sm.sort_matmul_ref(x, w, kp=kp, **kw))}
                for name, args in slabs.items():
                    fn = getattr(nm, name)
                    errs[name] = diff(fn(*args, m_group=M_GROUP, **kw),
                                      plain_of(fn)(*args, m_group=M_GROUP,
                                                   **kw))
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
            print(f"  sorted body kp={kp:5d} K={k:5d} M=3 N=5 rounds "
                  + ("1-3, acc_bits 2/30/16" if kp <= 4096 else
                     "3 and 0 at acc_bits 16") + f" max|diff| {worst}",
                  flush=True)
        # the expand twin's int32 route: every slot of every other group of
        # rows 1 and 3 at position 0 with value 127, x 127 there (a weight
        # of 381 and keys of 48387, past int16)
        x, _, vals, idx = nm_operands(torch, 3, 5, kp, seed + kp, n_keep=3)
        vals[1::2, ::2], idx[1::2, ::2] = 127, 0
        x[:, ::2 * M_GROUP] = 127
        for rounds in (1, 0) if kp in NO_ROUND_KP else (1,):
            kw = dict(policy="sorted", acc_bits=30, rounds=rounds,
                      m_group=M_GROUP)
            err = diff(nm.nm_sort_matmul(x, vals, idx, **kw),
                       nm.nm_sort_matmul_ref(x, vals, idx, **kw))
            worst["nm_sort_matmul"] = max(worst["nm_sort_matmul"], err)
            print(f"  sorted body, expand past int16 keys kp={kp:5d} "
                  f"K={kp:5d} M=3 N=5 3:16 rounds {rounds} max|diff| {err}",
                  flush=True)
    if any(worst.values()):
        raise AssertionError(f"the sorted body disagrees: {worst}")
    return worst


# launches per layer and decode step of each global-sort policy on N:M
# compressed storage: every site takes gather (G = 96 and 560 >= 8 groups);
# with nm_impl="expand" the same routes through the expand twins
NM_SORT_PATHS = {
    "sorted_tiled": {"nm_gather_sort_matmul": 6, "nm_gather_tile_sums": 1,
                     "nm_gather_paired_accum_matmul": 1},
    "sorted": {"nm_gather_sort_matmul": 6,
               "nm_gather_chunked_sort_matmul": 1},
}
NM_EXPAND_PATHS = {
    "sorted_tiled": {"nm_sort_matmul": 6, "nm_tile_sums_matmul": 1,
                     "nm_paired_accum_matmul": 1},
    "sorted": {"nm_sort_matmul": 6, "nm_chunked_sort_matmul": 1},
}


def nm_families(nm, ss):
    """The N:M global-sort kernels by family: (one-pass, pass 1, pass 2,
    chunked, the two-pass entry point)."""
    return {
        "gather": (nm.nm_gather_sort_matmul, ss.nm_gather_tile_sums,
                   ss.nm_gather_paired_accum_matmul,
                   ss.nm_gather_chunked_sort_matmul,
                   ss.nm_gather_stream_sort_matmul),
        "expand": (nm.nm_sort_matmul, ss.nm_tile_sums_matmul,
                   ss.nm_paired_accum_matmul, ss.nm_chunked_sort_matmul,
                   ss.nm_stream_sort_matmul)}


def phase_nm_sort_kernels(torch, sm, ss, nm, seed):
    """The four gather global-sort kernels and their four expand twins
    against their plain versions, bit-exact, and against the dense
    global-sort kernels on the decompressed weight over the same kp, the
    expand kernels also against the gather ones, at every site shape at
    M = 4 (8:16), at (N, K) = (256, 1536) at M = 64, at ragged 3:16 and 2:4
    slabs of K = 300 and at 16:16 (dense-as-sparse) slabs of K = 1536 and
    8960, rounds 1 and 2, with tied tile sums; given, as on the main path,
    the unpadded x and slabs. The one-pass kernel equals the two-pass route
    under both policies. On these canonical slabs the two families' plain
    versions give the same results (``tests/test_torch_nm_expand_sort.py``),
    so the expand kernels are held against the gather's plain versions,
    which sort only the kept keys (the expand's own are held on
    non-canonical slabs in ``phase_sorted_regimes`` and
    ``phase_duplicate_slots``). Then ``auto_expand``. Returns the max
    |difference| of each kernel against its plain version."""
    from repro_torch.core.sorted_accum import pair_permutation
    from repro_torch.kernels.sorted_matmul import padded_k

    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    families = nm_families(nm, ss)
    cases = [(4, n, k, N_KEEP, M_GROUP) for (n, k) in SHAPES] + [
        (64, 256, 1536, N_KEEP, M_GROUP), (5, 70, 300, 3, 16),
        (5, 70, 300, 2, 4), (4, 256, 1536, 16, 16), (4, 256, 8960, 16, 16)]
    worst = {f.__name__: 0 for fns in families.values() for f in fns[:4]}
    cross = passes = twins = 0
    for i, (m, n, k, n_keep, m_group) in enumerate(cases):
        x, w, vals, idx = nm_operands(torch, m, n, k, seed + 150 + i, n_keep,
                                      m_group, tied=True)
        g = vals.shape[1]
        kt = padded_k(g * m_group, "sorted_tiled", 256)
        ks = padded_k(g * m_group, "sorted", 256)
        nk = dict(m_group=m_group)
        for rounds in (1, 2):
            kw = dict(acc_bits=16, rounds=rounds)
            tk = dict(kw, k_tile=256)
            outs, errs, plain = {}, {}, None
            for impl, (one_fn, sums_fn, two_fn, chunked_fn,
                       stream_fn) in families.items():
                sums = sums_fn(x, vals, idx, k_tile=256, **nk)
                perm = pair_permutation(sums).to(torch.int32)
                one = one_fn(x, vals, idx, policy="sorted_tiled", **tk, **nk)
                two = two_fn(x, vals, idx, perm, **tk, **nk)
                ones = one_fn(x, vals, idx, policy="sorted", **kw, **nk)
                chunked = chunked_fn(x, vals, idx, **kw, **nk)
                outs[impl] = (one, sums, two, ones, chunked)
                if plain is None:  # the gather family's plain versions
                    plain = (
                        plain_of(one_fn)(x, vals, idx, policy="sorted_tiled",
                                         **tk, **nk),
                        plain_of(one_fn)(x, vals, idx, policy="sorted", **kw,
                                         **nk),
                        plain_of(sums_fn)(x, vals, idx, k_tile=256, **nk),
                        plain_of(two_fn)(x, vals, idx, perm, **tk, **nk),
                        plain_of(chunked_fn)(x, vals, idx, **kw, **nk))
                errs[one_fn.__name__] = max(diff(one, plain[0]),
                                            diff(ones, plain[1]))
                errs[sums_fn.__name__] = diff(sums, plain[2])
                errs[two_fn.__name__] = diff(two, plain[3])
                errs[chunked_fn.__name__] = diff(chunked, plain[4])
                dense = max(
                    diff(one, sm.sort_matmul(x, w, policy="sorted_tiled",
                                             kp=kt, **tk)),
                    diff(sums, ss.tile_sums_matmul(x, w, k_tile=256, kp=kt)),
                    diff(two, ss.paired_accum_matmul(x, w, perm, kp=kt,
                                                     **tk)),
                    diff(ones, sm.sort_matmul(x, w, policy="sorted", kp=ks,
                                              **kw)),
                    diff(chunked, ss.chunked_sort_matmul(x, w, kp=ks, **kw)))
                route = max(diff(one, two), diff(ones, chunked), diff(
                    one, stream_fn(x, vals, idx, policy="sorted_tiled", **tk,
                                   **nk)))
                cross, passes = max(cross, dense), max(passes, route)
                mine = {f.__name__: errs[f.__name__]
                        for f in families[impl][:4]}
                print(f"  nm {impl} kernels/plain M={m:3d} N={n:5d} "
                      f"K={k:5d} {n_keep}:{m_group} (kp {kt} / {ks}) "
                      f"rounds={rounds} max|diff| {mine}; vs dense kernels "
                      f"{dense}; one-pass vs two-pass {route}", flush=True)
            pair = max(diff(a, b) for a, b in zip(outs["gather"],
                                                  outs["expand"]))
            twins = max(twins, pair)
            tied = float((outs["gather"][1][1] == outs["gather"][1][1, :, :1])
                         .float().mean())
            print(f"  expand vs gather kernels {pair}; tied sums in row 1 "
                  f"{tied:.2f}", flush=True)
            for name, err in errs.items():
                worst[name] = max(worst[name], err)
    auto = auto_expand(torch, sm, ss, nm, seed)
    if any(worst.values()) or cross or passes or twins or auto:
        raise AssertionError(f"N:M global-sort kernels disagree: {worst}, "
                             f"vs dense {cross}, one-pass vs two-pass "
                             f"{passes}, expand vs gather {twins}, auto "
                             f"{auto}")
    return worst


def auto_expand(torch, sm, ss, nm, seed):
    """``auto`` at G = 7 groups (K = 112, 8:16) and on 16:16 slabs (K =
    1536, one-pass, and 8960, two-pass) under both policies: the expand
    kernels of the route launch, no gather kernel does, and the result is
    the dense kernel's. Returns the max |difference|."""
    from repro_torch.kernels import ops

    expand = (nm.nm_sort_matmul, ss.nm_tile_sums_matmul,
              ss.nm_paired_accum_matmul, ss.nm_chunked_sort_matmul)
    gathers = (nm.nm_gather_sort_matmul, ss.nm_gather_tile_sums,
               ss.nm_gather_paired_accum_matmul,
               ss.nm_gather_chunked_sort_matmul)
    worst = 0
    for i, (m, n, k, n_keep) in enumerate(((4, 1536, 112, 8),
                                           (4, 256, 1536, 16),
                                           (4, 256, 8960, 16))):
        x, w, vals, idx = nm_operands(torch, m, n, k, seed + 250 + i, n_keep,
                                      16, tied=True)
        g = vals.shape[1]
        for policy in ("sorted_tiled", "sorted"):
            kp = ops.padded_k(g * 16, policy, 256)
            impl = ops.resolve_nm_impl(policy, g, n_keep, 16)
            before = [f.launches for f in expand + gathers]
            got = ops.nm_policy_matmul(x, vals, idx, m_group=16,
                                       policy=policy, k_tile=256)
            want = sm.sort_matmul(x, w, policy=policy, kp=kp, k_tile=256)
            torch.cuda.synchronize()
            ran = [f.__name__ for f, b in zip(expand + gathers, before)
                   if f.launches != b]
            err = int((got.long() - want.long()).abs().max())
            print(f"  auto at G={g} {n_keep}:16 K={k} {policy}: nm_impl "
                  f"{impl}, launched {ran}, max|diff| vs dense kernel {err}",
                  flush=True)
            if impl != "expand" or not ran or any(
                    f.__name__ in ran for f in gathers):
                raise AssertionError(f"auto at G={g}, {n_keep}:16 did not "
                                     f"launch the expand kernels: {ran}")
            worst = max(worst, err)
    return worst


# phase 2's pass-1 cases: (M, K) with K not a multiple of 64, every tile
# size, every body of each kernel (sorted_stream.tile_sums_body,
# nm_tile_sums_body, nm_expand_tile_sums_body)
PASS1_MS = (1, 4, 5, 64, 128)
PASS1_KS = (1000, 1001)
PASS1_K_TILES = (16, 32, 64, 256, 1024)
PASS1_WARP_TILE = 2048  # row 10's one-warp body, above what row 11 stages


def non_canonical(torch, vals, idx):
    """Slabs with unsorted in-group indices (each group's slots reversed)
    and, in every third group, slot 0 at the position of the last slot
    (a duplicate, both products gathered)."""
    vals, idx = vals.flip(-1).contiguous(), idx.flip(-1).contiguous()
    idx[:, 1::3, 0] = idx[:, 1::3, -1]
    return vals, idx


def negative_slabs(torch, vals, idx, width):
    """Slabs whose gathered positions lie before x's row: in every fifth
    group slot 0 at position -1 - (g % 7), which wraps within x's row of
    ``width``, and in every seventh slot 1 below -width (a zero
    product)."""
    vals, idx = vals.clone(), idx.clone()
    g = torch.arange(idx.shape[1], device=idx.device, dtype=torch.int32)
    idx[:, ::5, 0] = (-g * M_GROUP - 1 - g % 7)[::5]
    idx[:, ::7, 1] = (-g * M_GROUP - width - 3)[::7]
    vals[:, ::5, 0] = vals[:, ::5, 0].clamp(min=1)
    return vals, idx


def phase_gather_faults(torch, nm, ss, seed):
    """The gather kernels (rows 6, 8, 11, 14, 17) on slabs with positions
    before x's row (``negative_slabs``) against their plain versions,
    bit-exact: a position in [-W, 0) reads x at position + W (W the padded
    K, G * m for row 6), one below -W is a zero product, no kernel reads
    outside x. M = 4 at K = 1536 and 2048 (K = kp, so a wrapped position
    reads x), row 17 at K = 8192 (4096 kept keys, the radix body). Returns
    the max |difference| of each kernel."""
    from repro_torch.core.sorted_accum import pair_permutation
    from repro_torch.kernels.sorted_matmul import padded_k

    worst = {}

    def held(fn, *args, **kw):
        got = fn(*args, **kw)
        err = int((got.long() - plain_of(fn)(*args, **kw).long()).abs()
                  .max())
        worst[fn.__name__] = max(worst.get(fn.__name__, 0), err)
        return err

    nk = dict(m_group=M_GROUP)
    for i, (m, n, k) in enumerate(((4, 256, 1536), (4, 256, 2048),
                                   (3, 64, 8192))):
        x, _, vals, idx = nm_operands(torch, m, n, k, seed + 400 + i)
        g = vals.shape[1]
        errs = []
        if k <= 2048:
            nv, ni = negative_slabs(torch, vals, idx, g * M_GROUP)
            for policy in ("clip", "sorted_tiled_seq"):
                errs.append(held(nm.nm_gather_seq_policy_matmul, x, nv, ni,
                                 policy=policy, acc_bits=16, k_tile=256,
                                 **nk))
            kt = padded_k(g * M_GROUP, "sorted_tiled", 256)
            nv, ni = negative_slabs(torch, vals, idx, kt)
            tk = dict(acc_bits=16, rounds=1, k_tile=256, **nk)
            errs.append(held(nm.nm_gather_sort_matmul, x, nv, ni,
                             policy="sorted_tiled", **tk))
            errs.append(held(ss.nm_gather_tile_sums, x, nv, ni, k_tile=256,
                             **nk))
            perm = pair_permutation(ss.nm_gather_tile_sums(
                x, nv, ni, k_tile=256, **nk)).to(torch.int32)
            errs.append(held(ss.nm_gather_paired_accum_matmul, x, nv, ni,
                             perm, **tk))
        ks = padded_k(g * M_GROUP, "sorted", 256)
        nv, ni = negative_slabs(torch, vals, idx, ks)
        one = dict(acc_bits=16, rounds=1, **nk)
        errs.append(held(nm.nm_gather_sort_matmul, x, nv, ni,
                         policy="sorted", **one))
        errs.append(held(ss.nm_gather_chunked_sort_matmul, x, nv, ni, **one))
        print(f"  gather kernels on negative positions M={m} N={n} K={k}: "
              f"max|diff| vs plain {max(errs)}", flush=True)
    if any(worst.values()):
        raise AssertionError(f"gather kernels disagree on negative "
                             f"positions: {worst}")
    return worst


def phase_pass1_kernels(torch, ss, seed):
    """Pass 1 of ``sorted_tiled``, rows 9, 10 and 11, against their plain
    versions, equality: ``tile_sums_matmul`` at M 1, 4, 5, 64, 128, K 1000
    and 1001, k_tile 16 to 1024 (both bodies), also with a zero tile past
    K (kp + k_tile); ``nm_gather_tile_sums`` (row 11) and
    ``nm_tile_sums_matmul`` (row 10) at the same M, K and tile sizes on
    8:16 and 2:4 slabs (the bodies they share, few rows and many rows, and
    row 10 also at k_tile 2048, its one-warp body), canonical (both also
    equal to row 9 on the decompressed weight, and to each other),
    non-canonical (``non_canonical``) and with an index outside its group
    but below K, which row 11 reads where it points and row 10 drops (its
    result is the plain version's on the slabs with that slot's value 0,
    and differs from row 11's); the int8 extremes at k_tile 1024 (x all
    -128 against weight rows all -128 and all 127; 16:16 slabs), where a
    tile sum reaches 2^24. Returns the max |difference| of each kernel."""
    from repro_torch.kernels.sorted_matmul import padded_k

    def diff(a, b):
        torch.cuda.synchronize()
        return int((a.long() - b.long()).abs().max())

    names = ("tile_sums_matmul", "nm_tile_sums_matmul", "nm_gather_tile_sums")
    worst = dict.fromkeys(names, 0)
    bodies = {name: set() for name in names}
    cross = 0
    drop_differs = False
    for i, (m, k) in enumerate((m, k) for m in PASS1_MS for k in PASS1_KS):
        x, w = operands(torch, m, 70, k, seed + 300 + i)
        errs = []
        for kt in PASS1_K_TILES:
            kp = padded_k(k, "sorted_tiled", kt)
            for kpx in (kp, kp + kt):
                errs.append(diff(ss.tile_sums_matmul(x, w, k_tile=kt, kp=kpx),
                                 ss.tile_sums_matmul_ref(x, w, k_tile=kt,
                                                         kp=kpx)))
            bodies["tile_sums_matmul"].add(ss.tile_sums_body(kt, k))
        worst["tile_sums_matmul"] = max(worst["tile_sums_matmul"], *errs)
        line = [f"  pass 1 M={m:3d} K={k}: tile_sums_matmul {max(errs)}"]
        for n_keep, m_group in ((8, 16), (2, 4)):
            x, w, vals, idx = nm_operands(torch, m, 70, k, seed + 400 + i,
                                          n_keep, m_group)
            odd = idx.clone()
            odd[:, 2, 0] = m_group + 1  # group 3's position, below K
            dropped = vals.clone()
            dropped[:, 2, 0] = 0  # what row 10 makes of it
            slabs = {"canonical": (vals, idx),
                     "non-canonical": non_canonical(torch, vals, idx),
                     "outside": (vals, odd)}
            errs = {"nm_gather_tile_sums": [], "nm_tile_sums_matmul": []}
            for kt in PASS1_K_TILES + (PASS1_WARP_TILE,):
                kw = dict(k_tile=kt, m_group=m_group)
                staged = kt <= PASS1_K_TILES[-1]  # row 11 stages the tile
                for name, (v, j) in slabs.items():
                    expand = ss.nm_tile_sums_matmul(x, v, j, **kw)
                    want = ss.nm_tile_sums_matmul_ref(
                        x, dropped if name == "outside" else v,
                        idx if name == "outside" else j, **kw)
                    errs["nm_tile_sums_matmul"].append(diff(expand, want))
                    if not staged:
                        continue
                    got = ss.nm_gather_tile_sums(x, v, j, **kw)
                    errs["nm_gather_tile_sums"].append(diff(
                        got, ss.nm_gather_tile_sums_ref(x, v, j, **kw)))
                    if name == "canonical":
                        kpt = padded_k(vals.shape[1] * m_group,
                                       "sorted_tiled", kt)
                        cross = max(cross, diff(got, ss.tile_sums_matmul(
                            x, w, k_tile=kt, kp=kpt)), diff(got, expand))
                    elif name == "outside":
                        drop_differs |= not torch.equal(got, expand)
                bodies["nm_tile_sums_matmul"].add(
                    ss.nm_expand_tile_sums_body(m, kt))
            bodies["nm_gather_tile_sums"].add(ss.nm_tile_sums_body(m))
            for name, e in errs.items():
                worst[name] = max(worst[name], *e)
            line.append(f"{n_keep}:{m_group} nm_tile_sums_matmul "
                        f"{max(errs['nm_tile_sums_matmul'])} "
                        f"nm_gather_tile_sums "
                        f"{max(errs['nm_gather_tile_sums'])}")
        print("; ".join(line), flush=True)
    for m in (4, 128):
        x, w = operands(torch, m, 96, 2048, seed + 500 + m)
        x[:] = -128
        w[:48], w[48:] = -128, 127
        sums = ss.tile_sums_matmul(x, w, k_tile=1024)
        err = diff(sums, ss.tile_sums_matmul_ref(x, w, k_tile=1024))
        vals = w.reshape(96, 128, 16)
        idx = torch.arange(16, dtype=torch.int32, device="cuda").expand(
            96, 128, 16).contiguous()
        kw = dict(k_tile=1024, m_group=16)
        nm_errs = {}
        for name, call, plain in (
                ("nm_gather_tile_sums", ss.nm_gather_tile_sums,
                 ss.nm_gather_tile_sums_ref),
                ("nm_tile_sums_matmul", ss.nm_tile_sums_matmul,
                 ss.nm_tile_sums_matmul_ref)):
            got = call(x, vals, idx, **kw)
            nm_errs[name] = max(diff(got, plain(x, vals, idx, **kw)),
                                diff(got, sums))
            worst[name] = max(worst[name], nm_errs[name])
        worst["tile_sums_matmul"] = max(worst["tile_sums_matmul"], err)
        print(f"  pass 1 extremes M={m} k_tile 1024: sums in "
              f"[{int(sums.min())}, {int(sums.max())}]; tile_sums_matmul "
              f"{err}, on 16:16 slabs {nm_errs}", flush=True)
    print(f"  pass 1 bodies run: {bodies}; nm_gather_tile_sums vs "
          f"tile_sums_matmul on the decompressed weight and vs "
          f"nm_tile_sums_matmul {cross}; an index outside its group changes "
          f"row 11 against row 10: {drop_differs}", flush=True)
    if any(worst.values()) or cross or not drop_differs or bodies != {
            "tile_sums_matmul": {"mma", "small"},
            "nm_tile_sums_matmul": {"few_rows", "many_rows", "warp"},
            "nm_gather_tile_sums": {"few_rows", "many_rows"}}:
        raise AssertionError(f"pass 1 kernels disagree: {worst}, cross "
                             f"{cross}, outside index differs "
                             f"{drop_differs}, bodies {bodies}")
    return worst


# depth of phase 4b, cut from 2 to keep the run inside its time limit
PARITY_LAYERS = 1
SORT_SERVE_LAYERS = 14  # 3c-3h: half of qwen2-1.5b's 28 layers


def phase_sort_parity(torch, counters, cfg, seed, new_tokens=2):
    """``PARITY_LAYERS`` at full width under ``sorted_tiled`` and under
    ``sorted`` (one layer holds both routes: one-pass at the six K = 1536
    sites, two-pass at w_out):
    the dense kernels, their plain versions and the compressed weights
    through the expand kernels (which must launch, and no gather kernel)
    give the same tokens (``parity_requests``, 2 new ones each: the plain
    ``sorted`` path walks 16384 saturating adds in Python at w_out) and
    the same decode logits."""
    from repro_torch.core.qtensor import nm_compress_tree

    cfg2 = dataclasses.replace(cfg, num_layers=PARITY_LAYERS)
    model, params = model_params(cfg2, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    for policy in SORT_PATHS:
        outs = {}
        for name, kw in (("cuda", dict(backend="cuda")),
                         ("torch", dict(backend="torch")),
                         ("expand", dict(compressed=True, nm_impl="expand"))):
            reset(counters)
            t0 = time.perf_counter()
            reqs, _, _, _ = serve(torch, cfg2, seed, policy=policy,
                                  reqs=parity_requests(cfg2, seed,
                                                       new_tokens), **kw)
            outs[name] = [r.output for r in reqs]
            launches = {k: f.launches for k, f in counters.items()}
            print(f"  {PARITY_LAYERS}-layer serve, {policy}, {name}: "
                  f"{time.perf_counter() - t0:.1f} s; launches {launches}",
                  flush=True)
            if name == "expand" and (
                    set(k for k, n in launches.items() if n)
                    != set(NM_EXPAND_PATHS[policy])):
                raise AssertionError(f"expand path ran {launches}")
        if any(o != outs["cuda"] for o in outs.values()) or any(
                len(o) != new_tokens for o in outs["cuda"]):
            raise AssertionError(f"{policy} tokens differ: {outs}")
        print(f"  {policy}: tokens identical, request 0 {outs['cuda'][0]}",
              flush=True)
        check_logits(torch, model, cfg, seed, (
            ("cuda", params, dict(policy=policy, backend="cuda")),
            ("torch", params, dict(policy=policy, backend="torch")),
            ("expand", sparse, dict(policy=policy, nm_impl="expand"))))


# How time_launches reads ``ms``, ``plain_ms`` and ``library_ms``, named in
# every record of the ``kernels`` line.
TIMING = ("device-busy events: L2 flushed, about 1 ms device spin, CUDA "
          "events around one call, mean of 10")


def time_launches(torch, fn, iters, flush_buf):
    """Mean ms of ``fn`` over ``iters`` launches, each timed alone by CUDA
    events after the L2 cache is overwritten (the decode path finds the
    weights cold). The device spins for about a millisecond before the
    start event, so the host has enqueued ``fn``'s kernels by then: the
    time is the device's, without the wrapper's host time (a plain
    version, a host loop of many small launches, still includes it)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush_buf.add_(1)
        torch.cuda._sleep(2_000_000)  # cycles: about 1 ms
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def phase_timing(torch, sm, baseline=None):
    """Kernel, plain and library times at the decode shapes (M = 4) for
    the 7 sites of one layer under every policy (the main path's policy is
    the record); and ``wide`` (the tensor-core mainloop) at M = 4, 64 and
    128 beside its bound and ``torch._int_mm`` on the same (N, K) weight
    (at M = 32 beside the decode rows: it refuses M <= 16). Returns
    {policy: rows at M = 4} and {("wide", M): rows}."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    table = {}
    m = 4
    for policy in sm.SEQ_POLICIES:
        rows = []
        for name, (n, k) in SITES.items():
            x, w = operands(torch, m, n, k, 7)
            kw = dict(policy=policy, acc_bits=16, rounds=1, k_tile=256)
            ms = time_launches(torch, lambda: sm.seq_policy_matmul(x, w, **kw),
                               10, flush_buf)
            plain = time_launches(
                torch, lambda: sm.seq_policy_matmul_ref(x, w, **kw), 1,
                flush_buf)
            rows.append(dict(ms=ms, plain_ms=plain,
                             **bound_row(m, n, k, m * k + n * k + 4 * m * n)))
            print(f"  time {policy:16s} {name:6s} M={m} N={n:5d} K={k:5d} "
                  f"kernel {ms:.4f} ms  plain {plain:.2f} ms  bound "
                  f"{rows[-1]['bound_ms']:.5f} ms", flush=True)
        table[policy] = rows
    for m in (4, 64, 128):
        rows = []
        for name, (n, k) in SITES.items():
            x, w = operands(torch, max(m, 32), n, k, 8)
            xm = x[:m]
            timed = in_turns(torch, lambda: sm.seq_policy_matmul(
                xm, w, policy="wide"), baseline and (
                    lambda: baseline["wide"](xm, w)), flush_buf,
                f"wide {name} M={m}")
            ms = timed["ms"]
            plain = time_launches(torch, lambda: sm.seq_policy_matmul_ref(
                xm, w, policy="wide"), 1, flush_buf)
            lib = time_launches(torch, lambda: torch._int_mm(x, w.t()), 10,
                                flush_buf)
            rows.append(dict(
                **timed, plain_ms=plain,
                **({"library_ms": lib} if m == x.shape[0]
                   else {"int_mm_m32_ms": lib}),
                **bound_row(m, n, k, m * k + n * k + 4 * m * n)))
            old = (f"  old kernel {timed['old_ms']:.4f} ms"
                   if "old_ms" in timed else "")
            print(f"  time wide M={m:3d} {name:6s} N={n:5d} K={k:5d} kernel "
                  f"{ms:.4f} ms{old}  plain {plain:.2f} ms  bound "
                  f"{rows[-1]['bound_ms']:.5f} ms  _int_mm at M="
                  f"{x.shape[0]} {lib:.4f} ms", flush=True)
        table[("wide", m)] = rows
    return table


def phase_nm_timing(torch, sm, nm, baseline=None):
    """Both N:M K-streaming kernels at the 7 sites on 8:16 slabs: row 6
    (gather) under sorted_tiled_seq at decode (M = 4) and at a prefill
    cohort (M = 128); row 5 (expand) under every SEQ policy at both M.
    Beside each: the dense kernel under the same policy on the
    decompressed weight (``dense_ms``), the bound (the compressed bytes: x,
    int8 values, int32 indices and the int32 out; the operations: the kept
    products), the integer-ALU floor of the sort networks under
    sorted_tiled_seq (``cx_floor_ms``: a network of 128 keys a tile, row 6's
    kept products and row 5's listed nonzero positions), the plain version
    at decode and, for row
    5's ``wide``, ``torch._int_mm`` on the decompressed weight stored (N, K)
    (``library_ms`` at M = 128; ``int_mm_m32_ms`` at M = 32 beside decode,
    which it refuses). Given ``baseline`` (``baseline_kernels``), each
    kernel of that build too (``old_ms``), timed in turns with the new.
    Returns {(kernel, policy, M): rows}, each row with its ``site``."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    gather, expand = "nm_gather_seq_policy_matmul", "nm_seq_policy_matmul"
    runs = [(gather, nm.nm_gather_seq_policy_matmul, "sorted_tiled_seq",
             128)] + [(expand, nm.nm_seq_policy_matmul, policy, 128)
                      for policy in sm.SEQ_POLICIES]
    table = {(name, policy, m): [] for name, _, policy, _ in runs
             for m in (4, 128)}
    for site, (n, k) in SITES.items():
        x128, w, vals, idx = nm_operands(torch, 128, n, k, 9)
        kept = vals.numel()
        tiles = -(-k // 256)
        for m in (4, 128):
            x = x128[:m].contiguous()
            xl = x128[:max(m, 32)].contiguous()
            bytes_ms = (m * k + 5 * kept + 4 * m * n) / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * kept / INT8_OPS_PER_S * 1e3
            line = [f"  time nm {site:6s} M={m:3d} N={n:5d} K={k:5d}"]
            dense_of = {}  # the dense kernel under each policy
            for kname, fn, policy, length in runs:
                kw = dict(policy=policy, acc_bits=16, rounds=1, k_tile=256)
                if policy not in dense_of:
                    dense_of[policy] = time_launches(
                        torch, lambda: sm.seq_policy_matmul(x, w, **kw), 10,
                        flush_buf)
                dense = dense_of[policy]
                old = baseline and (lambda: baseline[kname](
                    x, vals, idx, m_group=M_GROUP, **kw))
                row = dict(site=site, dense_ms=dense,
                           bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                           ops_ms=ops_ms,
                           **in_turns(torch, lambda: fn(
                               x, vals, idx, m_group=M_GROUP, **kw), old,
                               flush_buf, f"{kname} {policy} {site} M={m}"))
                if policy == "sorted_tiled_seq":
                    row["cx_floor_ms"] = cx_floor_ms(m * n, length, tiles)
                if m == 4:
                    ref = plain_of(fn)
                    row["plain_ms"] = time_launches(torch, lambda: ref(
                        x, vals, idx, m_group=M_GROUP, **kw), 1, flush_buf)
                if policy == "wide":
                    lib = time_launches(torch, lambda: torch._int_mm(
                        xl, w.t()), 10, flush_buf)
                    row["library_ms" if m == xl.shape[0]
                        else "int_mm_m32_ms"] = lib
                table[(kname, policy, m)].append(row)
                line.append(
                    f"{'gather' if kname == gather else 'expand'} {policy} "
                    f"{row['ms']:.4f}" + (
                        f" (old {row['old_ms']:.4f})"
                        if "old_ms" in row else "") + (
                        f" (plain {row['plain_ms']:.2f})"
                        if "plain_ms" in row else "") + (
                        f" (_int_mm at M={xl.shape[0]} {lib:.4f})"
                        if policy == "wide" else "")
                    + f" dense {dense:.4f}")
            line.append(f"ms; bound {max(bytes_ms, ops_ms):.5f} ms")
            print("  ".join(line), flush=True)
    return table


# kp of the `sorted` body from its first cross-warp shape up (the radix
# regime, 4096 to 32768, and the register network's 65536): rows 15, 16
# and 17 timed at each over w_out's 1536 outputs at decode
SWEEP_KP = (4096, 8192, 16384, 32768, 65536)


def phase_sorted_kp_timing(torch, ss, baseline=None):
    """Rows 15 (``chunked_sort_matmul``), 16 (``nm_chunked_sort_matmul``)
    and 17 (``nm_gather_chunked_sort_matmul``) at every kp of
    ``SWEEP_KP``: M = 4, N = 1536 and K = 35 kp / 64 (w_out's share of its
    kp: 8960 at 16384), 8:16 slabs (row 17 sorts G n_keep = K / 2 kept
    keys), acc_bits 16, one round; beside the bound and, given
    ``baseline``, that build's kernels in turns (``old_ms``). Returns
    {kernel: {kp: row}}."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    out = {name: {} for name in ("chunked_sort_matmul",
                                 "nm_chunked_sort_matmul",
                                 "nm_gather_chunked_sort_matmul")}
    m, n = 4, 1536
    for kp in SWEEP_KP:
        k = 35 * kp // 64
        x, w, vals, idx = nm_operands(torch, m, n, k, 15 + kp)
        nk = dict(acc_bits=16, rounds=1, m_group=M_GROUP)
        kept = vals.numel()
        runs = (("chunked_sort_matmul", ss.chunked_sort_matmul, (x, w),
                 dict(acc_bits=16, rounds=1, kp=kp), m * k + n * k),
                ("nm_chunked_sort_matmul", ss.nm_chunked_sort_matmul,
                 (x, vals, idx), nk, m * k + 5 * kept),
                ("nm_gather_chunked_sort_matmul",
                 ss.nm_gather_chunked_sort_matmul, (x, vals, idx), nk,
                 m * k + 5 * kept))
        for name, fn, args, kw, nbytes in runs:
            old = baseline and (lambda: baseline[name](*args, **kw))
            row = dict(k=k, **bound_row(m, n, kept if "nm" in name else k,
                                        nbytes + 4 * m * n),
                       **in_turns(torch, lambda: fn(*args, **kw), old,
                                  flush_buf, f"{name} kp={kp}"))
            out[name][kp] = row
            print(f"  time {name:30s} kp={kp:5d} M={m} N={n} K={k:5d} "
                  f"kernel {row['ms']:.4f} ms" + (
                      f"  old kernel {row['old_ms']:.4f} ms"
                      if "old_ms" in row else "")
                  + f"  bound {row['bound_ms']:.5f} ms", flush=True)
    return out


def bound_row(m, n, k, nbytes):
    """Bytes and operations bounds (ms) of a dot of m x n outputs over k
    products that moves ``nbytes``."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * m * n * k / INT8_OPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms)


def cx_floor_ms(outputs, length, sorts=1):
    """The integer-ALU floor of ``outputs`` outputs that each sort
    ``sorts`` bitonic networks of ``length`` keys (a power of two): one
    lane-instruction a compare-exchange (a 16x2 max and a 16x2 min do two),
    length/2 * log2(length) (log2(length) + 1) / 2 of them a network, at
    the card's instruction rate (``LANE_INSTR_PER_S``); the pair rounds,
    the adds and the loads come on top."""
    lg = max(length, 1).bit_length() - 1
    return outputs * sorts * (length // 2) * lg * (lg + 1) // 2 \
        / LANE_INSTR_PER_S * 1e3


def phase_sort_timing(torch, sm, ss, baseline=None):
    """The global-sort kernels at the decode shapes (M = 4) of the sites
    where the main path runs them: ``sort_matmul`` at the six K = 1536
    sites under each policy, the two-pass pair and the chunked sort at
    w_out. Each kernel is given what the main path gives it: the unpadded
    operands and, for ``sorted``, kp = 2048 or 16384 (the zero tail is
    masked in the kernel). Beside each: its plain version, its bound (the
    bytes of the logical-K operands it reads and of what it writes, or
    2 M N K int8 operations over the logical K) and, for pass 1, one
    float32 ``torch.bmm`` (TF32 off; exact, since |sum| <= 256 * 16384 <
    2^24). At w_out the one-pass kernel is timed too, beside the two-pass
    path. ``sort_matmul`` under ``sorted`` and ``paired_accum_matmul`` also
    at a prefill cohort (M = 128; ``M=128``, no plain version), and
    ``paired_accum_matmul`` also on the weight as served, 8:16-pruned and
    stored dense (``[8:16]``), at both M. Given ``baseline``
    (``baseline_kernels``), rows 2, 12 and 15 of that build too
    (``old_ms``), timed in turns with the new."""
    from repro_torch.core.sorted_accum import pair_permutation
    from repro_torch.kernels.ops import next_pow2

    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    table = {name: [] for name in SORT_KERNELS + (
        "sort_matmul[sorted]", "sort_matmul[sorted] M=128",
        "paired_accum_matmul M=128", "paired_accum_matmul[8:16]",
        "paired_accum_matmul[8:16] M=128")}
    kt = 256
    for site, (n, k) in SITES.items():
        x128, w = operands(torch, 128, n, k, 11)
        x = x128[:4].contiguous()
        m = x.shape[0]
        kp = next_pow2(k)
        tk = dict(acc_bits=16, rounds=1, k_tile=kt)
        one = dict(acc_bits=16, rounds=1, kp=kp)
        # (table key, kernel, (args, kwargs), plain, bytes, library)
        runs = []
        if k <= 4096:
            runs.append(("sort_matmul", sm.sort_matmul,
                         ((x, w), dict(policy="sorted_tiled", **tk)),
                         sm.sort_matmul_ref, m * k + n * k + 4 * m * n, None))
            runs.append(("sort_matmul[sorted]", sm.sort_matmul,
                         ((x, w), dict(policy="sorted", **one)),
                         sm.sort_matmul_ref, m * k + n * k + 4 * m * n, None))
            runs.append(("sort_matmul[sorted] M=128", sm.sort_matmul,
                         ((x128, w), dict(policy="sorted", **one)), None,
                         128 * k + n * k + 4 * 128 * n, None))
        else:
            t = k // kt
            perm = pair_permutation(ss.tile_sums_matmul(x, w, k_tile=kt)).to(
                torch.int32)
            xf = x.float().reshape(m, t, kt).transpose(0, 1).contiguous()
            wf = w.float().reshape(n, t, kt).permute(1, 2, 0).contiguous()
            bmm = torch.bmm(xf, wf).permute(1, 2, 0)
            if not torch.equal(bmm.to(torch.int32),
                               ss.tile_sums_matmul(x, w, k_tile=kt)):
                raise AssertionError("float32 bmm tile sums are not exact")
            runs.append(("tile_sums_matmul", ss.tile_sums_matmul,
                         ((x, w), dict(k_tile=kt)), ss.tile_sums_matmul_ref,
                         m * k + n * k + 4 * m * n * t,
                         lambda: torch.bmm(xf, wf)))
            runs.append(("paired_accum_matmul", ss.paired_accum_matmul,
                         ((x, w, perm), tk), ss.paired_accum_matmul_ref,
                         m * k + n * k + 4 * m * n * t + 4 * m * n, None))
            # pass 2 at a prefill cohort, and on the weight as served
            # (8:16-pruned, stored dense: at most 128 nonzero products a
            # tile), at decode and at the cohort
            wp = prune(torch, w)[0]
            for key, xm, wm in (("paired_accum_matmul M=128", x128, w),
                                ("paired_accum_matmul[8:16]", x, wp),
                                ("paired_accum_matmul[8:16] M=128", x128,
                                 wp)):
                mm = xm.shape[0]
                pm = pair_permutation(ss.tile_sums_matmul(
                    xm, wm, k_tile=kt)).to(torch.int32)
                runs.append((key, ss.paired_accum_matmul, ((xm, wm, pm), tk),
                             None if mm == 128 else ss.paired_accum_matmul_ref,
                             mm * k + n * k + 4 * mm * n * t + 4 * mm * n,
                             None))
            runs.append(("chunked_sort_matmul", ss.chunked_sort_matmul,
                         ((x, w), one), ss.chunked_sort_matmul_ref,
                         m * k + n * k + 4 * m * n, None))
            for policy, pk in (("sorted_tiled", k), ("sorted", kp)):
                ms = time_launches(torch, lambda: sm.sort_matmul(
                    x, w, policy=policy, kp=pk, **tk), 10, flush_buf)
                print(f"  time sort_matmul (one-pass, for comparison) "
                      f"{policy} {site} M={m} N={n} K={k} kp={pk} "
                      f"{ms:.4f} ms", flush=True)
        for key, fn, (args, kw), plain, nbytes, lib in runs:
            old = None if not baseline or fn is ss.tile_sums_matmul else (
                lambda: baseline[fn.__name__](*args, **kw))
            outputs = args[0].shape[0] * n
            # the pruned weight's tiles sort on the 128-key network
            tile = kt // 2 if "8:16" in key else kt
            row = dict(**in_turns(torch, lambda: fn(*args, **kw), old,
                                  flush_buf, f"{key} {site}"),
                       library_ms=lib and time_launches(torch, lib, 10,
                                                        flush_buf),
                       cx_floor_ms=(cx_floor_ms(outputs, tile, -(-k // kt))
                                    if kw.get("policy") == "sorted_tiled"
                                    or fn is ss.paired_accum_matmul
                                    else cx_floor_ms(outputs, kp)
                                    if "kp" in kw else 0.0),
                       **bound_row(args[0].shape[0], n, k, nbytes))
            if plain:
                row["plain_ms"] = time_launches(
                    torch, lambda: plain(*args, **kw), 1, flush_buf)
            table[key].append(row)
            print(f"  time {key:31s} {site:6s} M={args[0].shape[0]:3d} "
                  f"N={n:5d} K={k:5d} kernel {row['ms']:.4f} ms" + (
                      f"  old kernel {row['old_ms']:.4f} ms"
                      if "old_ms" in row else "") + (
                      f"  plain {row['plain_ms']:.2f} ms" if plain else "")
                  + f"  bound {row['bound_ms']:.5f} ms" + (
                      f"  float32 bmm {row['library_ms']:.4f} ms"
                      if lib else ""), flush=True)
    return table


# the expand twin of each gather key of phase_nm_sort_timing
EXPAND_OF = {"nm_gather_sort_matmul": "nm_sort_matmul",
             "nm_gather_sort_matmul[sorted]": "nm_sort_matmul[sorted]",
             "nm_gather_sort_matmul[sorted] M=128":
                 "nm_sort_matmul[sorted] M=128",
             "nm_gather_tile_sums": "nm_tile_sums_matmul",
             "nm_gather_paired_accum_matmul": "nm_paired_accum_matmul",
             "nm_gather_paired_accum_matmul M=128":
                 "nm_paired_accum_matmul M=128",
             "nm_gather_chunked_sort_matmul": "nm_chunked_sort_matmul"}


def phase_nm_sort_timing(torch, sm, ss, nm, baseline=None):
    """The gather global-sort kernels and their expand twins at the decode
    shapes (M = 4, 8:16) of the sites where the main path runs them, beside
    the dense kernel on the decompressed weight over the same kp
    (``dense_ms``; the expand rows also beside the gather kernel,
    ``gather_ms``), their plain versions and their bound: the bytes of x,
    the int8 values, the int32 indices and of what they write (and read:
    pass 2's perm) at the logical K, or 2 M N (G n_keep) int8 operations
    over the kept products (the same function for both twins). Pass 1 also
    beside one float32 ``torch.bmm`` on the decompressed weight, as row 9.
    At w_out the one-pass kernels are timed too, beside the two-pass
    path. The one-pass kernels under ``sorted`` and pass 2 also at a
    prefill cohort (M = 128; ``M=128``, no plain version). Given ``baseline``
    (``baseline_kernels``), rows 7, 8, 13, 14, 16 and 17 of that build too
    (``old_ms``), timed in turns with the new."""
    from repro_torch.core.sorted_accum import pair_permutation
    from repro_torch.kernels.sorted_matmul import padded_k

    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    table = {name: [] for name in (*EXPAND_OF, *EXPAND_OF.values())}
    kt = 256
    twins = {"sort": (nm.nm_gather_sort_matmul, nm.nm_sort_matmul),
             "sums": (ss.nm_gather_tile_sums, ss.nm_tile_sums_matmul),
             "pass2": (ss.nm_gather_paired_accum_matmul,
                       ss.nm_paired_accum_matmul),
             "chunked": (ss.nm_gather_chunked_sort_matmul,
                         ss.nm_chunked_sort_matmul)}
    for site, (n, k) in SITES.items():
        x128, w, vals, idx = nm_operands(torch, 128, n, k, 13)
        x = x128[:4].contiguous()
        m = x.shape[0]
        kept = vals.numel()
        kpt = padded_k(k, "sorted_tiled", kt)
        kps = padded_k(k, "sorted", kt)
        tk = dict(acc_bits=16, rounds=1, k_tile=kt, m_group=M_GROUP)
        one = dict(acc_bits=16, rounds=1, m_group=M_GROUP)
        dk = dict(acc_bits=16, rounds=1, k_tile=kt)
        base = m * k + 5 * kept
        # (gather key, twins, (args, kwargs), dense call, bytes, library,
        # with a plain version)
        runs = []
        if k <= 4096:
            runs.append(("nm_gather_sort_matmul", "sort",
                         ((x, vals, idx), dict(policy="sorted_tiled", **tk)),
                         lambda: sm.sort_matmul(x, w, policy="sorted_tiled",
                                                kp=kpt, **dk),
                         base + 4 * m * n, None, True))
            runs.append(("nm_gather_sort_matmul[sorted]", "sort",
                         ((x, vals, idx), dict(policy="sorted", **one)),
                         lambda: sm.sort_matmul(x, w, policy="sorted", kp=kps,
                                                acc_bits=16),
                         base + 4 * m * n, None, True))
            runs.append(("nm_gather_sort_matmul[sorted] M=128", "sort",
                         ((x128, vals, idx), dict(policy="sorted", **one)),
                         lambda: sm.sort_matmul(x128, w, policy="sorted",
                                                kp=kps, acc_bits=16),
                         128 * k + 5 * kept + 4 * 128 * n, None, False))
        else:
            t = kpt // kt
            perm = pair_permutation(ss.nm_gather_tile_sums(
                x, vals, idx, k_tile=kt, m_group=M_GROUP)).to(torch.int32)
            xf = x.float().reshape(m, t, kt).transpose(0, 1).contiguous()
            wf = w.float().reshape(n, t, kt).permute(1, 2, 0).contiguous()
            bmm = torch.bmm(xf, wf).permute(1, 2, 0)
            if not torch.equal(bmm.to(torch.int32), ss.nm_gather_tile_sums(
                    x, vals, idx, k_tile=kt, m_group=M_GROUP)):
                raise AssertionError("float32 bmm tile sums are not exact")
            runs.append(("nm_gather_tile_sums", "sums",
                         ((x, vals, idx), dict(k_tile=kt, m_group=M_GROUP)),
                         lambda: ss.tile_sums_matmul(x, w, k_tile=kt, kp=kpt),
                         base + 4 * m * n * t, lambda: torch.bmm(xf, wf),
                         True))
            runs.append(("nm_gather_paired_accum_matmul", "pass2",
                         ((x, vals, idx, perm), tk),
                         lambda: ss.paired_accum_matmul(x, w, perm, kp=kpt,
                                                        **dk),
                         base + 4 * m * n * t + 4 * m * n, None, True))
            perm128 = pair_permutation(ss.nm_gather_tile_sums(
                x128, vals, idx, k_tile=kt, m_group=M_GROUP)).to(torch.int32)
            runs.append(("nm_gather_paired_accum_matmul M=128", "pass2",
                         ((x128, vals, idx, perm128), tk),
                         lambda: ss.paired_accum_matmul(x128, w, perm128,
                                                        kp=kpt, **dk),
                         128 * k + 5 * kept + 4 * 128 * n * t + 4 * 128 * n,
                         None, False))
            runs.append(("nm_gather_chunked_sort_matmul", "chunked",
                         ((x, vals, idx), one),
                         lambda: ss.chunked_sort_matmul(x, w, kp=kps,
                                                        acc_bits=16),
                         base + 4 * m * n, None, True))
            for policy in ("sorted_tiled", "sorted"):
                kw = tk if policy == "sorted_tiled" else one
                for fn in (nm.nm_gather_sort_matmul, nm.nm_sort_matmul):
                    ms = time_launches(torch, lambda: fn(
                        x, vals, idx, policy=policy, **kw), 10, flush_buf)
                    print(f"  time {fn.__name__} (one-pass, for comparison) "
                          f"{policy} {site} M={m} N={n} K={k} {ms:.4f} ms",
                          flush=True)
        for key, twin, (args, kw), dense, nbytes, lib, with_plain in runs:
            rows_m = args[0].shape[0]
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * rows_m * kept / INT8_OPS_PER_S * 1e3
            outputs = rows_m * n
            tiles = kpt // kt
            lp = N_KEEP * kt // M_GROUP  # a kept tile's sort length
            common = dict(
                dense_ms=time_launches(torch, dense, 10, flush_buf),
                library_ms=lib and time_launches(torch, lib, 10, flush_buf),
                bound_ms=max(bytes_ms, ops_ms), bytes_ms=bytes_ms,
                ops_ms=ops_ms)
            # the gather twin sorts the kept keys, the expand twin the
            # dense stream
            floors = {"gather": 0.0, "expand": 0.0}
            if twin in ("sort", "pass2") and (
                    twin == "pass2" or kw["policy"] == "sorted_tiled"):
                floors = {"gather": cx_floor_ms(outputs, lp, tiles),
                          "expand": cx_floor_ms(outputs, kt, tiles)}
            elif twin in ("sort", "chunked"):
                floors = {"gather": cx_floor_ms(
                    outputs, padded_k(vals.shape[1] * N_KEEP, "sorted", 1)),
                    "expand": cx_floor_ms(outputs, kps)}
            rows = {}
            for impl, fn in zip(("gather", "expand"), twins[twin]):
                old = None if not baseline or twin == "sums" else (
                    lambda: baseline[fn.__name__](*args, **kw))
                rows[impl] = dict(
                    common, cx_floor_ms=floors[impl], **in_turns(
                        torch, lambda: fn(*args, **kw), old, flush_buf,
                        f"{fn.__name__} {key} {site}"))
                if with_plain:
                    ref = plain_of(fn)
                    rows[impl]["plain_ms"] = time_launches(
                        torch, lambda: ref(*args, **kw), 1, flush_buf)
            rows["expand"]["gather_ms"] = rows["gather"]["ms"]
            table[key].append(rows["gather"])
            table[EXPAND_OF[key]].append(rows["expand"])
            for impl, row in rows.items():
                name = key if impl == "gather" else EXPAND_OF[key]
                print(f"  time {name:36s} {site:6s} M={rows_m:3d} N={n:5d} "
                      f"K={k:5d} kernel {row['ms']:.4f} ms" + (
                          f"  old kernel {row['old_ms']:.4f} ms"
                          if "old_ms" in row else "")
                      + f"  dense kernel {row['dense_ms']:.4f} ms" + (
                          f"  plain {row['plain_ms']:.2f} ms"
                          if "plain_ms" in row else "")
                      + f"  bound {row['bound_ms']:.5f} ms" + (
                          f"  float32 bmm {row['library_ms']:.4f} ms"
                          if lib else ""), flush=True)
    # the auto cut GATHER_MIN_G: both one-pass kernels at a few groups
    m = 4
    for g in (4, 8, 16):
        x, _, vals, idx = nm_operands(torch, m, 1536, g * M_GROUP, 14)
        for policy, kw in (("sorted_tiled", dict(acc_bits=16, k_tile=kt,
                                                 m_group=M_GROUP)),
                           ("sorted", dict(acc_bits=16, m_group=M_GROUP))):
            times = [time_launches(torch, lambda f=f: f(
                x, vals, idx, policy=policy, **kw), 10, flush_buf)
                for f in (nm.nm_gather_sort_matmul, nm.nm_sort_matmul)]
            print(f"  time GATHER_MIN_G cut: G={g:2d} (K={g * M_GROUP}) "
                  f"N=1536 M={m} {policy:12s} gather {times[0]:.4f} ms  "
                  f"expand {times[1]:.4f} ms", flush=True)
    return table


def plain_of(fn):
    """The plain version (``<name>_ref``) of a wrapper."""
    return getattr(sys.modules[fn.__module__], fn.__name__ + "_ref")


def baseline_kernels(torch, csrc_dir):
    """Rows 1 (``wide``) and 2-17 as another tree's ``csrc/`` builds them
    (an older commit's, for a same-call comparison): its
    ``seq_policy_matmul.cu``, ``nm_seq_policy_matmul.cu``,
    ``quant_matmul.cu``, ``sort_matmul.cu``, ``sorted_stream.cu``,
    ``nm_sort_matmul.cu``, ``nm_expand_sort.cu`` and, where it has them,
    ``nm_expand_pass2.cu`` (else its ``nm_expand_sort.cu`` holds row 13)
    and ``nm_expand_seq.cu`` (else its ``nm_seq_policy_matmul.cu`` holds
    row 5)
    compiled with the port's flags, one nvcc each in parallel, into a
    directory of ``src/repro_torch/_build/`` named after ``csrc_dir``, and
    called through the port's own wrappers with that build's library in
    place of the port's for the call (so the two trees' C entry points
    must take the same arguments, but for the expand `sorted` kernel's
    int32-route pool, which a tree without it is called without).
    Returns {kernel name: callable with the wrapper's arguments}."""
    import ctypes

    from repro_torch.kernels import build
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import sorted_matmul as sm
    from repro_torch.kernels import sorted_stream as ss

    out_dir = build.BUILD_DIR / ("baseline-" + Path(csrc_dir).resolve()
                                 .as_posix().strip("/").replace("/", "-"))
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    srcs = [src for src in build.SOURCES
            if (Path(csrc_dir) / f"{src}.cu").exists()]
    procs = {src: subprocess.Popen(
        [build._nvcc(), *flags, "-o", str(out_dir / f"lib{src}.so"),
         str(Path(csrc_dir) / f"{src}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for src in srcs}
    libs = {}
    for src, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"baseline nvcc failed for {src}:\n{log}")
        libs[src] = ctypes.CDLL(str(out_dir / f"lib{src}.so"))
    libs.setdefault("nm_expand_pass2", libs["nm_expand_sort"])
    libs.setdefault("nm_expand_seq", libs["nm_seq_policy_matmul"])

    # a tree whose expand `sorted` entry point takes no int32-route pool
    # (before the route existed) is called without one
    poolless = "void* pool" not in (Path(csrc_dir) /
                                    "nm_expand_sort.cu").read_text()

    def launch_poolless(x, values, indices, *, m_group, policy, acc_bits,
                        k_tile, rounds, kp):
        return nm.launch_slabs(
            "nm_expand_sort", "pqs_nm_expand_sort_matmul", x, values,
            indices, m_group=m_group, ints=(
                kp, sm.SORT_POLICIES.index(policy), acc_bits, rounds,
                k_tile))

    def via(source, wrapper):
        """``wrapper`` run on this build's csrc/<source>.cu."""
        def run(*args, **kwargs):
            saved = build._LIBS.get(source)
            build._LIBS[source] = libs[source]
            launch = nm.launch_nm_expand_sort
            if poolless and source == "nm_expand_sort":
                nm.launch_nm_expand_sort = launch_poolless
                ss.launch_nm_expand_sort = launch_poolless
            try:
                return wrapper(*args, **kwargs)
            finally:
                nm.launch_nm_expand_sort = ss.launch_nm_expand_sort = launch
                if saved is None:
                    del build._LIBS[source]
                else:
                    build._LIBS[source] = saved
        return run

    def wide(x, w):
        return sm.seq_policy_matmul(x, w, policy="wide")

    return {"wide": via("seq_policy_matmul", wide),
            **{f.__name__: via(src, f) for src, f in (
                ("nm_seq_policy_matmul", nm.nm_gather_seq_policy_matmul),
                ("nm_expand_seq", nm.nm_seq_policy_matmul),
                ("quant_matmul", qm.quant_matmul),
                ("quant_matmul", nm.nm_spmm),
                ("sort_matmul", sm.sort_matmul),
                ("sort_matmul", ss.chunked_sort_matmul),
                ("sorted_stream", ss.tile_sums_matmul),
                ("sorted_stream", ss.paired_accum_matmul),
                ("nm_sort_matmul", nm.nm_gather_sort_matmul),
                ("nm_sort_matmul", ss.nm_gather_tile_sums),
                ("nm_sort_matmul", ss.nm_gather_chunked_sort_matmul),
                ("nm_sort_matmul", ss.nm_gather_paired_accum_matmul),
                ("nm_expand_sort", nm.nm_sort_matmul),
                ("nm_expand_sort", ss.nm_tile_sums_matmul),
                ("nm_expand_sort", ss.nm_chunked_sort_matmul),
                ("nm_expand_pass2", ss.nm_paired_accum_matmul))}}


def in_turns(torch, new, old, flush_buf, what):
    """``ms`` of ``new`` and, given ``old`` (a baseline build's same
    kernel; its result checked equal first), ``old_ms``, timed in turns
    old, new, new, old."""
    if old is None:
        return dict(ms=time_launches(torch, new, 10, flush_buf))
    if not torch.equal(old(), new()):
        raise AssertionError(f"{what}: the baseline build disagrees")
    times = [time_launches(torch, f, 10, flush_buf)
             for f in (old, new, new, old)]
    return dict(ms=(times[1] + times[2]) / 2, old_ms=(times[0] + times[3]) / 2)


def phase_pass1_timing(torch, ss, baseline=None):
    """Rows 9, 10 and 11 at w_out (N 1536, K 8960, k_tile 256, 8:16 slabs
    for rows 10 and 11) at decode (M = 4) and at a prefill cohort (M =
    128): each kernel beside one float32 ``torch.bmm`` of the same sums at
    the same M (TF32 off; rows 10 and 11 on the decompressed weight),
    first checked equal to the kernel (exact: |sum| <= 256 * 16384 <
    2^24), its plain version, its bound (bytes: x, the weight or the int8
    values and int32 indices, and the (M, N, T) int32 output; operations:
    2 M N K, or 2 M (G n_keep) N for the kept products) and, given
    ``baseline`` (``baseline_kernels``), the same kernel of that build
    (``old_ms``, equal results checked), timed in turns old, new, new,
    old. Returns {(kernel, M): row}."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    (n, k), kt = SITES["w_out"], 256
    t = k // kt
    table = {}
    for m in (4, 128):
        x, w, vals, idx = nm_operands(torch, m, n, k, 17)
        kept = vals.numel()
        xf = x.float().reshape(m, t, kt).transpose(0, 1).contiguous()
        wf = w.float().reshape(n, t, kt).permute(1, 2, 0).contiguous()
        bmm = torch.bmm(xf, wf).permute(1, 2, 0).to(torch.int32)
        out = 4 * m * n * t
        kw = dict(k_tile=kt, m_group=M_GROUP)
        nm_bytes = m * k + 5 * kept + out
        for name, call, plain, nbytes, ops, args in (
                ("tile_sums_matmul", ss.tile_sums_matmul,
                 ss.tile_sums_matmul_ref, m * k + n * k + out, m * n * k,
                 ((x, w), dict(k_tile=kt))),
                ("nm_tile_sums_matmul", ss.nm_tile_sums_matmul,
                 ss.nm_tile_sums_matmul_ref, nm_bytes, m * kept,
                 ((x, vals, idx), kw)),
                ("nm_gather_tile_sums", ss.nm_gather_tile_sums,
                 ss.nm_gather_tile_sums_ref, nm_bytes, m * kept,
                 ((x, vals, idx), kw))):
            pos, kws = args
            got = call(*pos, **kws)
            if not (torch.equal(got, bmm) and torch.equal(got, plain(
                    *pos, **kws))):
                raise AssertionError(f"{name} at M={m}: the kernel, its "
                                     "plain version and the float32 bmm "
                                     "disagree")
            row = dict(plain_ms=time_launches(torch, lambda: plain(
                *pos, **kws), 1, flush_buf),
                library_ms=time_launches(torch, lambda: torch.bmm(xf, wf),
                                         10, flush_buf),
                bytes_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                ops_ms=2 * ops / INT8_OPS_PER_S * 1e3)
            row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
            row.update(in_turns(
                torch, lambda: call(*pos, **kws),
                baseline and (lambda: baseline[name](*pos, **kws)),
                flush_buf, f"{name} at M={m}"))
            table[(name, m)] = row
            print(f"  time pass 1 {name:20s} w_out M={m:3d} kernel "
                  f"{row['ms']:.4f} ms" + (
                      f"  old kernel {row['old_ms']:.4f} ms"
                      if "old_ms" in row else "")
                  + f"  float32 bmm {row['library_ms']:.4f} ms  plain "
                  f"{row['plain_ms']:.2f} ms  bound {row['bound_ms']:.5f} "
                  f"ms", flush=True)
    return table


def phase_wide_timing(torch, qm, nm, baseline=None):
    """Rows 3 and 4 at the 7 site shapes at decode (M = 4) and at a
    prefill cohort (M = 128); row 4 on 8:16 slabs and row 3 on their
    decompressed weight (K, N), the same dot (``dense_ms`` of row 4).
    Beside each: its plain version; its bound, the bytes of x, the
    weight (row 4: int8 values and int32 indices) and the int32 out, or
    2 M N K int8 operations (row 4: over the kept products); and
    ``torch._int_mm`` on the same dot (row 4: on the decompressed weight),
    at M = 128 and, since it refuses M <= 16, at M = 32 beside the decode
    rows: ``library_ms`` (``int_mm_m32_ms``) with the weight stored (N,
    K), the column-major B that cuBLAS takes without a transpose and the
    faster layout (the port keeps that copy as ``QTensor.values_t``), and
    ``int_mm_kn_ms`` (``int_mm_m32_kn_ms``) on the kernel's own (K, N)
    inputs. Given ``baseline`` (``baseline_kernels``), each kernel of that
    build too (``old_ms``), timed in turns with the new. Row 3 must run
    its TMA-fed body at every site (aligned operands). Returns {(kernel,
    M): rows}."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    table = {(name, m): [] for name in ("quant_matmul", "nm_spmm")
             for m in (4, 128)}
    tma = qm.quant_matmul.body_launches["tma"]
    launches = qm.quant_matmul.launches
    for site, (n, k) in SITES.items():
        x, wt, vals, idx = nm_operands(torch, 128, n, k, 15)
        w = wt.t().contiguous()  # (K, N), as QTensor.values
        kept = vals.shape[1] * vals.shape[2]  # kept products a row
        for m in (4, 128):
            xm, xl = x[:m], x[:max(m, 32)]
            lib = time_launches(torch, lambda: torch._int_mm(xl, wt.t()),
                                10, flush_buf)
            lib_kn = time_launches(torch, lambda: torch._int_mm(xl, w), 10,
                                   flush_buf)
            libs = ({"library_ms": lib, "int_mm_kn_ms": lib_kn}
                    if m == xl.shape[0] else
                    {"int_mm_m32_ms": lib, "int_mm_m32_kn_ms": lib_kn})
            row3 = dict(
                **in_turns(torch, lambda: qm.quant_matmul(xm, w),
                           baseline and (lambda: baseline["quant_matmul"](
                               xm, w)), flush_buf,
                           f"quant_matmul {site} M={m}"),
                plain_ms=time_launches(
                    torch, lambda: qm.quant_matmul_ref(xm, w), 1, flush_buf),
                **libs, **bound_row(m, n, k, m * k + k * n + 4 * m * n))
            row4 = dict(
                **in_turns(torch, lambda: nm.nm_spmm(
                    xm, vals, idx, m_group=M_GROUP),
                    baseline and (lambda: baseline["nm_spmm"](
                        xm, vals, idx, m_group=M_GROUP)), flush_buf,
                    f"nm_spmm {site} M={m}"),
                plain_ms=time_launches(torch, lambda: nm.nm_spmm_ref(
                    xm, vals, idx, m_group=M_GROUP), 1, flush_buf),
                dense_ms=row3["ms"], **libs,
                **bound_row(m, n, kept, m * k + 5 * n * kept + 4 * m * n))
            table[("quant_matmul", m)].append(row3)
            table[("nm_spmm", m)].append(row4)
            for name, row in (("quant_matmul", row3), ("nm_spmm", row4)):
                old = (f"  old kernel {row['old_ms']:.4f} ms"
                       if "old_ms" in row else "")
                print(f"  time {name:12s} {site:6s} M={m:3d} N={n:5d} "
                      f"K={k:5d} kernel {row['ms']:.4f} ms{old}  plain "
                      f"{row['plain_ms']:.2f} ms  bound "
                      f"{row['bound_ms']:.5f} ms  _int_mm at M="
                      f"{xl.shape[0]} {lib:.4f} ms (weight stored (N, K); "
                      f"(K, N) as the kernel's: {lib_kn:.4f} ms)",
                      flush=True)
    tma = qm.quant_matmul.body_launches["tma"] - tma
    if tma != qm.quant_matmul.launches - launches:
        raise AssertionError(f"quant_matmul ran its TMA body {tma} of "
                             f"{qm.quant_matmul.launches - launches} times")
    return table


def kernel_record(name, source, replaces, rows, policy="sorted_tiled_seq",
                  work="7 projection sites of one qwen2-1.5b layer at "
                       "decode (M=4), acc_bits 16, k_tile 256", **extra):
    """One entry of the ``kernels`` line: sums over the decode sites of
    ``rows``."""
    total = {key: sum(r[key] for r in rows)
             for key in ("ms", "plain_ms", "bound_ms", "bytes_ms", "ops_ms")}
    for key in ("dense_ms", "gather_ms", "int_mm_kn_ms", "int_mm_m32_ms",
                "int_mm_m32_kn_ms", "old_ms", "cx_floor_ms"):
        if all(key in r for r in rows):
            extra[key] = sum(r[key] for r in rows)
    library = [r.get("library_ms") for r in rows]
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        policy=policy, work=work, timing=TIMING,
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by="bytes" if total["bytes_ms"] >= total["ops_ms"]
        else "operations",
        # no one PyTorch call computes a sorted 16-bit register; pass 1's
        # exact sums are one float32 bmm, and rows 3 and 4's wide sums one
        # torch._int_mm on the weight stored (N, K) (the wide policy's
        # _int_mm times are printed in phase 5)
        library_ms=sum(library) if all(v is not None for v in library)
        else None, **extra)


def pass1_records(name, source, replaces, table, work):
    """The phase-5 pass-1 rows of one kernel (``phase_pass1_timing``) as
    sub-records of its ``kernels`` entry: ``by_M`` {"M=4", "M=128"}, each
    with the float32 bmm at the same M and, where a baseline build was
    timed, the old kernel's ms."""
    return {"by_M": {f"M={m}": kernel_record(
        name, source, replaces, [table[(name, m)]], policy="sorted_tiled",
        work=work.replace("decode (M=4)", f"M={m}"))
        for m in (4, 128)}}


def prefill_record(rows, work):
    """The M = 128 rows of a `sorted` one-pass kernel (no plain version):
    sums over the sites of ms, old_ms where timed, and the bound."""
    rec = {key: sum(r[key] for r in rows)
           for key in ("ms", "bound_ms", "bytes_ms", "ops_ms", "dense_ms",
                       "gather_ms", "old_ms", "cx_floor_ms", "library_ms")
           if all(r.get(key) is not None for r in rows)}
    rec["bound_by"] = ("bytes" if rec["bytes_ms"] >= rec["ops_ms"]
                       else "operations")
    return dict(work=work, timing=TIMING, **rec)


# ---------------------------------------------------------------------------
# phase 6: the paper's own path (6a) and the LM's accumulator-aware
# fine-tune (6b)
# ---------------------------------------------------------------------------

PAPER_POLICIES = ("sorted", "sorted_tiled", "clip", "wide")
PAPER_BITS = (12, 14, 16, 20)
# the census on the CPU, against the card's, at these registers (the
# CPU's product cubes take about a second a net and register)
PAPER_CPU_CENSUS_BITS = (12, 16)
# the kernel each policy of the paper path launches: row 1 or row 2
PAPER_ROW = {"sorted": "sort_matmul", "sorted_tiled": "sort_matmul",
             "clip": "seq_policy_matmul", "wide": "seq_policy_matmul"}
PAPER_LIMIT = 512  # evaluate_int / overflow_profile rows (the test set: 410)


def paper_nets(seed):
    """(name, config, PQSConfig, train_papernet keywords) of the nets 6a
    trains on synth_mnist: 8/8-bit at 8:16 under P->Q and Q->P, w5a5, the
    A2Q regime at a 16-bit register (no pruning, as
    benchmarks/pareto_accum.py trains it), and the convnet."""
    from repro_torch.configs.paper import CONVNET, MLP1, MLP2
    from repro_torch.core.pqs import PQSConfig

    pq = PQSConfig(weight_bits=8, act_bits=8, n_keep=8, m=16, order="pq")
    mlp = dict(epochs=6, prune_every=1, fp32_frac=0.67, lr=0.05, seed=seed)
    return [
        ("mlp1 P->Q", MLP1, pq, mlp),
        ("mlp2 P->Q", MLP2, pq, mlp),
        ("mlp2 Q->P", MLP2, dataclasses.replace(pq, order="qp"), mlp),
        ("mlp2 w5a5 P->Q", MLP2,
         dataclasses.replace(pq, weight_bits=5, act_bits=5), mlp),
        ("mlp2 A2Q p16", MLP2, dataclasses.replace(pq, n_keep=16),
         dict(mlp, a2q_acc_bits=16)),
        ("convnet P->Q", CONVNET, pq,
         dict(epochs=4, prune_every=1, fp32_frac=0.75, lr=0.05, seed=seed)),
    ]


class DotRecorder:
    """Inside the context every ``dispatch.pqs_dot`` call (the paper
    path's integer dots) is kept with its operands, keywords and result,
    so that each can be held against its plain version after the path
    ran; the path itself runs unchanged."""

    def __init__(self, dispatch):
        self.dispatch, self.calls = dispatch, []

    def __enter__(self):
        self.orig = self.dispatch.pqs_dot

        def call(x, w, **kw):
            out = self.orig(x, w, **kw)
            self.calls.append((x, w, kw, out))
            return out

        self.dispatch.pqs_dot = call
        return self

    def __exit__(self, *exc):
        self.dispatch.pqs_dot = self.orig

    def plain_errors(self, torch, calls=None, cols=None, rows=None):
        """(max |kernel - plain|, number of calls held): each recorded call
        (those at the indices ``calls``) against its plain version
        (``backend="torch"`` on the card, unchunked); with ``cols``, on the
        first and last ``cols`` outputs alone (a dense weight's: an output
        reads only its own weight row), with ``rows`` on the first and last
        ``rows`` rows of x alone (an output row reads only its own); the
        ends in one plain call."""

        def ends(n, k, device):
            return (slice(None) if k is None or 2 * k >= n else torch.cat([
                torch.arange(k), torch.arange(n - k, n)]).to(device))

        err, held = 0, 0
        for i in range(len(self.calls)) if calls is None else calls:
            x, w, kw, out = self.calls[i]
            x, out = x.reshape(-1, x.shape[-1]), out.reshape(-1, out.shape[-1])
            r = ends(x.shape[0], rows, x.device)
            c = ends(out.shape[-1], cols, x.device)
            plain = self.orig(x[r], w if cols is None else w[c],
                              **dict(kw, backend="torch", batch_chunk=None))
            got = out[r][:, c]
            if not torch.equal(got, plain):
                err = max(err, int((got.long() - plain.long()).abs().max()))
            held += 1
        return err, held


def phase_paper_nets(torch, counters, seed):
    """6a: train the paper nets at their published widths on the card,
    freeze them and run ``evaluate_int`` (rows 1 and 2) and
    ``overflow_profile`` at every register of ``PAPER_BITS`` under every
    policy of ``PAPER_POLICIES``. Every integer dot equals its plain
    version bit for bit, each call launches its row once a 128-row chunk
    and nothing else, the card's census equals the CPU's, the census
    never rises with the register, the MLPs pass 0.8 in float32 and
    ``wide`` stays within 0.08 of float32. Prints each net's Fig-2
    table; returns the measurements."""
    from repro_torch.core import dispatch
    from repro_torch.core import papernets as pn
    from repro_torch.data import synth_mnist

    data = synth_mnist(n=4096, seed=seed)
    _, test = data.split(0.9)
    got = {"nets": {}, "launches": {p: 0 for p in PAPER_POLICIES},
           "per_call": {}, "err": 0, "dots": 0}
    for name, cfg, pqs, kw in paper_nets(seed):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pn.train_papernet(cfg, pqs, data, device="cuda", **kw)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        net = dict(fp32=res.fp32_acc, train_s=train_s,
                   epoch_s=train_s / kw["epochs"], acc={}, eval_s={},
                   census={}, launches_per_call={})
        got["nets"][name] = net
        print(f"  {name}: trained {kw['epochs']} epochs in {train_s:.2f} s "
              f"({net['epoch_s']:.3f} s an epoch), fp32 accuracy "
              f"{res.fp32_acc:.4f}, last loss {res.history[-1][1]:.4f}",
              flush=True)
        # the A2Q regime's bar is none: at a 16-bit register the L1 bound
        # truncates nearly every weight of a 784-long row to zero, and the
        # JAX package's A2Q net stays at chance there too (paper Fig 5's
        # accuracy cost of A2Q)
        if cfg.kind != "convnet" and "a2q_acc_bits" not in kw and \
                res.fp32_acc <= 0.8:
            raise AssertionError(f"{name}: fp32 accuracy {res.fp32_acc} "
                                 "not above 0.8")
        with DotRecorder(dispatch) as rec:
            for policy in PAPER_POLICIES:
                times, calls = [], []
                for bits in PAPER_BITS:
                    first = len(rec.calls)
                    reset(counters)
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    acc = pn.evaluate_int(res.layers, cfg, pqs, test, policy,
                                          bits, limit=PAPER_LIMIT)
                    times.append(time.perf_counter() - t)
                    launched = {k: fn.launches for k, fn in counters.items()
                                if fn.launches}
                    chunks = sum(-(-c[0].shape[0] // 128)
                                 for c in rec.calls[first:])
                    row = PAPER_ROW[policy]
                    by_policy = getattr(counters[row], "policy_launches",
                                        {policy: launched.get(row, 0)})
                    if launched != {row: chunks} or \
                            by_policy[policy] != chunks:
                        raise AssertionError(
                            f"{name} {policy} {bits}: launches {launched} "
                            f"(by policy {by_policy}), want {row}: {chunks} "
                            "(one a 128-row chunk)")
                    net["acc"][(policy, bits)] = acc
                    calls.append(chunks)
                    got["launches"][policy] += chunks
                net["eval_s"][policy] = sum(times) / len(times)
                net["launches_per_call"][policy] = calls[0]
        err, n = rec.plain_errors(torch)
        got["err"] = max(got["err"], err)
        got["dots"] += n
        if err:
            raise AssertionError(f"{name}: a kernel differs from its plain "
                                 f"version by {err}")
        torch.cuda.synchronize()
        t = time.perf_counter()
        for bits in PAPER_BITS:
            c = pn.overflow_profile(res.layers, cfg, pqs, test, bits,
                                    limit=PAPER_LIMIT)
            net["census"][bits] = [int(v) for v in c[:4]]
        net["census_s"] = (time.perf_counter() - t) / len(PAPER_BITS)
        host = pn.to_device(res.layers, "cpu")
        for bits in PAPER_CPU_CENSUS_BITS:
            c = pn.overflow_profile(host, cfg, pqs, test, bits,
                                    limit=PAPER_LIMIT)
            if [int(v) for v in c[:4]] != net["census"][bits]:
                raise AssertionError(f"{name} at {bits} bits: card census "
                                     f"{net['census'][bits]} != CPU "
                                     f"{[int(v) for v in c[:4]]}")
        anys = [net["census"][b][3] for b in PAPER_BITS]
        if anys != sorted(anys, reverse=True):
            raise AssertionError(f"{name}: census rises with the register "
                                 f"{dict(zip(PAPER_BITS, anys))}")
        for bits in PAPER_BITS:
            if abs(net["acc"][("wide", bits)] - res.fp32_acc) > 0.08:
                raise AssertionError(f"{name}: wide accuracy "
                                     f"{net['acc'][('wide', bits)]} against "
                                     f"fp32 {res.fp32_acc}")
        print(f"  {name}: {n} integer dots equal their plain versions; "
              f"evaluate_int s a call {net['eval_s']}, launches a call "
              f"{net['launches_per_call']}; census "
              f"{net['census_s']:.3f} s a register, card = CPU at "
              f"{PAPER_CPU_CENSUS_BITS}", flush=True)
        print(f"  {name} Fig 2 (test set, {len(test.x)} rows): bits "
              "persistent transient clip sort sorted_tiled wide", flush=True)
        for bits in PAPER_BITS:
            _, pers, trans, _ = net["census"][bits]
            a = net["acc"]
            print(f"    {bits:>4} {pers:>10} {trans:>9} "
                  f"{a[('clip', bits)]:.4f} {a[('sorted', bits)]:.4f} "
                  f"{a[('sorted_tiled', bits)]:.4f} {a[('wide', bits)]:.4f}",
                  flush=True)
        if name == "mlp2 P->Q":
            got["timing"] = paper_timing(torch, res.layers, cfg, pqs, data)
    return got


def paper_timing(torch, layers, cfg, pqs, data):
    """Rows 1 and 2 at mlp2's hidden layer (N = K = 784), M = 128 (the
    path's chunk) and 512, on the frozen layer and the quantized training
    rows: kernel, plain version and bound; ``wide`` beside
    ``torch._int_mm`` on the same (N, K) weight."""
    from repro_torch.core import papernets as pn
    from repro_torch.core.quant import quantize
    from repro_torch.kernels import sorted_matmul as sm

    frozen = pn.freeze_net(layers, cfg, pqs)[0]
    x = torch.from_numpy(data.x[:512]).cuda()
    xq = quantize(x, frozen["x_qp"]).to(torch.int8)
    w = frozen["wq"].to(torch.int8).contiguous()
    n, k = w.shape
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    for policy in PAPER_POLICIES:
        for m in (128, 512):
            xm = xq[:m].contiguous()
            kw = dict(policy=policy, acc_bits=16, k_tile=pqs.k_tile,
                      rounds=pqs.rounds)
            if policy in sm.SORT_POLICIES:
                kp = sm.padded_k(k, policy, pqs.k_tile)
                fn = lambda: sm.sort_matmul(xm, w, kp=kp, **kw)  # noqa: E731
                ref = lambda: sm.sort_matmul_ref(  # noqa: E731
                    xm, w, kp=kp, **kw)
            else:
                fn = lambda: sm.seq_policy_matmul(xm, w, **kw)  # noqa: E731
                ref = lambda: sm.seq_policy_matmul_ref(  # noqa: E731
                    xm, w, **kw)
            if not torch.equal(fn(), ref()):
                raise AssertionError(f"{policy} M={m}: kernel != plain")
            row = dict(ms=time_launches(torch, fn, 10, flush_buf),
                       plain_ms=time_launches(torch, ref, 1, flush_buf),
                       **bound_row(m, n, k, m * k + n * k + 4 * m * n))
            row["library_ms"] = time_launches(
                torch, lambda: torch._int_mm(xm, w.t()), 10, flush_buf) \
                if policy == "wide" else None
            if policy in sm.SORT_POLICIES:
                keys = kp if policy == "sorted" else pqs.k_tile
                row["cx_floor_ms"] = cx_floor_ms(
                    m * n * (1 if policy == "sorted" else kp // keys), keys,
                    pqs.rounds)
            rows[(policy, m)] = row
            lib = (f"  _int_mm {row['library_ms']:.4f} ms"
                   if row["library_ms"] is not None else "")
            print(f"  time mlp2 hidden {policy:12s} M={m:3d} N={n} K={k} "
                  f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.2f} "
                  f"ms  bound {row['bound_ms']:.5f} ms{lib}", flush=True)
    return rows


FINETUNE_LAYERS = 2  # qwen2-1.5b at full width, depth cut from 28


def phase_finetune(torch, seed):
    """6b: ``a2q_finetune`` for 2 AdamW steps on qwen2-1.5b at full width
    and ``FINETUNE_LAYERS`` layers (seeded random weights, TokenStream
    batches of 2 x 64 tokens), then ``quantize_and_certify(acc_bits=16)``:
    every QAT site reports a census rate every step, the losses are
    finite, the certificate verifies and every site is safe at 16 bits
    or fewer. Returns the step times, the peak device memory and the
    certification time."""
    import math

    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.models.model import build_model
    from repro_torch.runtime import QATConfig, a2q_finetune, \
        quantize_and_certify

    cfg = dataclasses.replace(get_config("qwen2-1.5b"),
                              num_layers=FINETUNE_LAYERS)
    model = build_model(cfg)
    params = model.init(seed)
    stream = TokenStream(cfg.vocab_size, seq_len=64, batch_size=2, seed=seed)
    stamps = []

    def next_batch(i):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return stream.next_batch()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params, hist = a2q_finetune(model, params, next_batch, 2,
                                QATConfig(acc_bits=16))
    torch.cuda.synchronize()
    stamps.append(time.perf_counter())
    peak = torch.cuda.max_memory_allocated()
    sites = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_out"}
    for h in hist:
        if not math.isfinite(h["loss"]):
            raise AssertionError(f"step {h['step']}: loss {h['loss']}")
        if set(h["census_rates"]) != sites or any(
                d <= 0 for d, _ in h["census"].values()):
            raise AssertionError(f"step {h['step']}: census {h['census']}")
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    print(f"  fine-tune: losses {[round(h['loss'], 4) for h in hist]}, "
          f"s a step {step_s}, peak device memory {peak / 2**30:.2f} GiB; "
          f"census (dots, events) {hist[0]['census']}", flush=True)
    t = time.perf_counter()
    qparams, cert = quantize_and_certify(params, acc_bits=16)
    cert_s = time.perf_counter() - t
    cert.verify(qparams)
    safe = {s.site: s.acc_bits_safe for s in cert.sites}
    if not sites <= set(safe) or max(safe.values()) > 16:
        raise AssertionError(f"certificate sites {safe}")
    print(f"  quantize_and_certify(acc_bits=16): {cert_s:.2f} s; safe bits "
          f"by site {safe}", flush=True)
    return dict(losses=[h["loss"] for h in hist], step_s=step_s,
                peak_gib=peak / 2**30, certify_s=cert_s, safe_bits=safe,
                census=hist[0]["census"])


# ---------------------------------------------------------------------------
# phase 7: the dense decoder family at full width: gemma3-12b (7a), qwen3-32b's
# untied head (7b), command-r-35b's layer norm (7c)
# ---------------------------------------------------------------------------

GEMMA3_LAYERS = 6  # one whole period: 5 sliding-window layers, 1 global
GEMMA3_LONG = (1000, 40)  # prompt and new tokens: decode passes 1024
GEMMA3_MAX_LEN = sum(GEMMA3_LONG)
FAMILY_KERNEL = {False: "seq_policy_matmul",
                 True: "nm_gather_seq_policy_matmul"}  # by compressed
HEAD_COLS = 2048  # outputs at each end of qwen3's head held against plain
LAYER_COLS = 1024  # the same for command-r's layer 0
# rows of x at each end of a served prefill's dots held against plain (4
# until 9a-9c joined the run)
PREFILL_ROWS = 2
VLM_ROWS = 1  # the same for qwen2-vl's forward (M = 384), one at each end


def family_requests(cfg, seed, new_tokens, long=None):
    """4 greedy requests: prompts of 20-32 tokens with ``new_tokens`` new
    ones; with ``long`` = (prompt, new), the last one that long."""
    import numpy as np

    from repro_torch.serving import Request

    ps = prompts(4, seed, cfg.vocab_size)
    news = [new_tokens] * 4
    if long is not None:
        ps[3] = np.random.default_rng(seed + 1).integers(
            0, cfg.vocab_size, size=long[0]).astype(np.int32)
        news[3] = long[1]
    return [Request(uid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(ps, news))]


def family_serve(torch, counters, cfg, seed, built, reqs, max_len,
                 compressed, per_step, first=None):
    """Serve ``reqs`` on ``built`` = (model, params) on 4 slots under
    ``sorted_tiled_seq`` with every launch count set to 0 just before and
    read just after (``first`` entered around step 1): the storage's
    K-streaming kernel (row 1 dense, row 6 compressed) must launch
    ``per_step`` times a step, every other kernel never (``check_served``).
    Returns the engine, the tokens and the record: the s a decode step,
    the prefill s, the launches by kernel and the steps."""
    reset(counters)
    reqs, eng, t_first, t_rest = serve(torch, cfg, seed, built=built,
                                       reqs=reqs, max_len=max_len,
                                       first=first)
    kernel = FAMILY_KERNEL[compressed]
    launches, steps = check_served(counters, eng, reqs, cfg.vocab_size,
                                   {kernel: per_step})
    decode_steps = eng.stats["decode_steps"]
    per_decode = t_rest / max(decode_steps - 1, 1)
    print(f"  {cfg.name}, {'compressed' if compressed else 'dense'}: "
          f"{sum(len(r.output) for r in reqs)} tokens, prefill steps "
          f"{eng.stats['prefill_steps']}, decode steps {decode_steps}; step "
          f"1 (prefill + first decode) {t_first:.3f} s, later decode "
          f"{per_decode:.4f} s/step, prefill alone ~ "
          f"{t_first - per_decode:.3f} s; launches {launches} ({kernel}: "
          f"{per_step} x {steps} steps)", flush=True)
    return eng, [r.output for r in reqs], dict(
        per_step=per_decode, prefill=t_first - per_decode, launches=launches,
        steps=steps)


def held_decode(torch, model, params, cfg, seed, n_calls, what, **kw):
    """One decode step's ``pqs_dot`` calls recorded (``decode_logits``),
    there must be ``n_calls`` of them, each held against its plain version
    (``DotRecorder.plain_errors`` keywords ``kw``). Returns the
    recorder."""
    _, _, rec = decode_logits(torch, model, params, cfg, seed,
                              dict(policy="sorted_tiled_seq"), record=True)
    if len(rec.calls) != n_calls:
        raise AssertionError(f"{len(rec.calls)} pqs_dot calls != {n_calls}")
    err, n = rec.plain_errors(torch, **kw)
    print(f"  {what}: {n} dots against their plain versions, max |diff| "
          f"{err}", flush=True)
    if err:
        raise AssertionError(f"{what}: a dot differs from its plain version "
                             f"by {err}")
    return rec


def phase_gemma3(torch, counters, seed):
    """7a: gemma3-12b at its published widths, cut to ``GEMMA3_LAYERS``
    layers (one whole 5-local + 1-global period), random seeded weights,
    8:16-pruned int8, served on 4 slots under ``sorted_tiled_seq`` from
    dense storage (row 1) and from compressed storage (row 6): three
    prompts of 20-32 tokens with 16 new tokens and one of 1000 with 40,
    so that decode passes position 1024 and every local layer's ring
    wraps. Gates: 7 x 6 launches a step of the storage's kernel and no
    other; the local layers' caches hold 1024 slots, the global layer's
    ``max_len``; every ``pqs_dot`` of the served prefill at layers 0 and 5
    (4 slots x a 1024 bucket: 4096 rows of x, the far end of the kernels'
    row grid) equal to its plain version on its first and last
    ``PREFILL_ROWS`` rows; the same tokens from both storages; one
    decode's logits bit for bit across them; every ``pqs_dot`` of one
    decode step at layers 0 and 5 equal to its plain version. Returns the
    record."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.core.qtensor import nm_compress_tree
    from repro_torch.models.transformer import layer_windows

    cfg = dataclasses.replace(get_config("gemma3-12b"),
                              num_layers=GEMMA3_LAYERS)
    t0 = time.perf_counter()
    model, params = model_params(cfg, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"  init, quantize and compress: {init_s:.1f} s; windows "
          f"{layer_windows(cfg)}", flush=True)
    per_step = len(SITES) * cfg.num_layers
    layers = list(range(7)) + list(range(per_step - 7, per_step))
    out = {"init_s": init_s}
    tokens = {}
    for compressed, p in ((False, params), (True, sparse)):
        storage = "compressed" if compressed else "dense"
        rec = DotRecorder(dispatch)  # step 1: the prefill and a decode
        eng, tokens[storage], run = family_serve(
            torch, counters, cfg, seed, (model, p),
            family_requests(cfg, seed, 16, GEMMA3_LONG), GEMMA3_MAX_LEN,
            compressed, per_step, first=rec)
        shapes = [tuple(c["k"].shape) for c in eng.caches]
        pos = int(eng.caches[0]["pos"].max())
        want = [(4, 1024 if win else GEMMA3_MAX_LEN, cfg.num_kv_heads,
                 cfg.resolved_head_dim) for win in layer_windows(cfg)]
        print(f"  cache shapes {shapes}; the long request's position "
              f"{pos}", flush=True)
        if shapes != want or pos <= 1024:
            raise AssertionError(f"caches {shapes} != {want}, or position "
                                 f"{pos} did not pass 1024")
        t = time.perf_counter()
        m = [c[0].numel() // c[0].shape[-1] for c in rec.calls]
        prefill = [i for i, rows in enumerate(m) if rows > 4]
        if len(prefill) != per_step or {m[i] for i in prefill} != {4096}:
            raise AssertionError(f"step 1's dots at rows {m}: not one "
                                 f"prefill pass of {per_step} at 4096")
        err, n = rec.plain_errors(torch, rows=PREFILL_ROWS, calls=[
            prefill[i] for i in layers])
        del rec
        print(f"  the prefill's {n} dots of layers 0 and 5 (M = 4096) on "
              f"rows 0-{PREFILL_ROWS - 1} and {4096 - PREFILL_ROWS}-4095 "
              f"against their plain versions: max |diff| {err}", flush=True)
        if err:
            raise AssertionError(f"{storage}: a prefill dot differs from its "
                                 f"plain version by {err}")
        run.update(prefill_plain_held=n,
                   prefill_checks_s=time.perf_counter() - t,
                   profile=profile_decode(torch, eng, cfg.vocab_size))
        out[storage] = run
        del eng
    if tokens["compressed"] != tokens["dense"]:
        raise AssertionError(f"tokens differ: {tokens}")
    print(f"  the same tokens from both storages; request 3 (1000-token "
          f"prompt) {tokens['dense'][3]}", flush=True)
    t = time.perf_counter()
    check_logits(torch, model, cfg, seed, (
        ("dense", params, dict(policy="sorted_tiled_seq")),
        ("compressed", sparse, dict(policy="sorted_tiled_seq"))))
    for storage, p in (("dense", params), ("compressed", sparse)):
        held_decode(torch, model, p, cfg, seed, per_step,
                    f"{storage}, one decode step, layers 0 and 5",
                    calls=layers)
    out.update(plain_held=dict.fromkeys(("dense", "compressed"), len(layers)),
               checks_s=time.perf_counter() - t)
    return out


def phase_qwen3(torch, counters, sm, seed):
    """7b: qwen3-32b at full width, 1 layer: its untied head runs through
    row 1 at N = 151936, K = 5120 (8 launches a step with the layer's 7),
    4 requests of 8 new tokens from dense storage; the head's dot of one
    decode step equals its plain version on its first and last
    ``HEAD_COLS`` outputs; the head alone timed by CUDA events beside its
    bound, its plain version and ``torch._int_mm`` at M = 32. Returns the
    record."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("qwen3-32b"), num_layers=1)
    built = model_params(cfg, seed, compressed=False)
    per_step = len(SITES) + 1
    eng, _, run = family_serve(torch, counters, cfg, seed, built,
                               family_requests(cfg, seed, 8), 128, False,
                               per_step)
    del eng
    rec = held_decode(torch, *built, cfg, seed, per_step,
                      f"the head (N={cfg.vocab_size}, K={cfg.d_model}) on "
                      f"its first and last {HEAD_COLS} outputs",
                      calls=[per_step - 1], cols=HEAD_COLS)
    x, w, kw, _ = rec.calls[-1]
    if tuple(w.shape) != (cfg.vocab_size, cfg.d_model):
        raise AssertionError(f"the last dot is on {tuple(w.shape)}")
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    m, (n, k) = x2.shape[0], w.shape
    seq = dict(policy="sorted_tiled_seq", acc_bits=16, k_tile=256)
    ms = time_launches(torch, lambda: sm.seq_policy_matmul(x2, w, **seq), 10,
                       flush_buf)
    plain = time_launches(torch, lambda: sm.seq_policy_matmul_ref(
        x2, w, **seq), 1, flush_buf)
    x32 = x2.repeat(32 // m, 1)
    lib = time_launches(torch, lambda: torch._int_mm(x32, w.t()), 10,
                        flush_buf)
    head = dict(ms=ms, plain_ms=plain, int_mm_m32_ms=lib,
                **bound_row(m, n, k, m * k + n * k + 4 * m * n))
    print(f"  head alone, M={m}: kernel {ms:.4f} ms, plain {plain:.1f} ms, "
          f"bound {head['bound_ms']:.4f} ms, torch._int_mm at M=32 "
          f"{lib:.4f} ms", flush=True)
    return dict(run, head=head)


def phase_command_r(torch, counters, seed):
    """7c: command-r-35b at full width, 1 layer (layer norm, tied vocab
    256000): 4 requests of 8 new tokens from dense storage, 7 row-1
    launches a step; layer 0's 7 dots of one decode step equal their plain
    versions on their first and last ``LAYER_COLS`` outputs; the tied
    head's dequantize timed. Returns the record."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config("command-r-35b"), num_layers=1)
    built = model_params(cfg, seed, compressed=False)
    eng, _, run = family_serve(torch, counters, cfg, seed, built,
                               family_requests(cfg, seed, 8), 128, False,
                               len(SITES))
    del eng
    held_decode(torch, *built, cfg, seed, len(SITES),
                f"layer 0 on their first and last {LAYER_COLS} outputs",
                cols=LAYER_COLS)
    return dict(run, head_dequantize_ms=table_dequantize_ms(
        torch, built[1]["embed"]))


# ---------------------------------------------------------------------------
# phase 8: the MoE family (8a, granite-moe-3b) and the SSM family (8b,
# mamba2-2.7b) at their published widths
# ---------------------------------------------------------------------------

FAMILY8_LAYERS = 4  # both cut from their published depth (32, 64)
MAMBA_LONG = (1000, 40)  # a 1024 bucket: 4 SSD chunks of 256 at prefill
MOE_REL_TOL = 0.02  # moe_ffn against moe_ffn_dense in bfloat16, of max |ref|
SSD_OUT_REL_TOL = 0.02  # chunked against stepwise outputs (bfloat16)
SSD_STATE_REL_TOL = 1e-3  # and the float32 states, of max |ref|


class CallRecorder:
    """Inside the context every call of ``getattr(owner, name)`` is kept
    with its arguments; the calls run unchanged."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, []

    def __enter__(self):
        self.orig = getattr(self.owner, self.name)

        def call(*args, **kw):
            self.calls.append((args, kw))
            return self.orig(*args, **kw)

        setattr(self.owner, self.name, call)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def family_sites_timing(torch, sm, nm, sites, seed):
    """Rows 1 and 6 at a family's projection sites (name -> (N, K)) at
    decode (M = 4), ``sorted_tiled_seq`` at 16 bits, k_tile 256, 8:16:
    each kernel (mean of 10) beside its plain version (1) and bound.
    Returns {kernel: rows}."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, rounds=1, k_tile=256)
    m, out = 4, {"seq_policy_matmul": [], "nm_gather_seq_policy_matmul": []}
    for i, (site, (n, k)) in enumerate(sites.items()):
        x, w, vals, idx = nm_operands(torch, m, n, k, seed + i)
        kept = vals.numel()
        for name, fn, ref, args, nbytes, prods in (
                ("seq_policy_matmul", sm.seq_policy_matmul,
                 sm.seq_policy_matmul_ref, (x, w), n * k, n * k),
                ("nm_gather_seq_policy_matmul",
                 lambda *a, **k2: nm.nm_gather_seq_policy_matmul(
                     *a, m_group=M_GROUP, **k2),
                 lambda *a, **k2: nm.nm_gather_seq_policy_matmul_ref(
                     *a, m_group=M_GROUP, **k2),
                 (x, vals, idx), 5 * kept, kept)):
            ms = time_launches(torch, lambda: fn(*args, **kw), 10, flush_buf)
            plain = time_launches(torch, lambda: ref(*args, **kw), 1,
                                  flush_buf)
            row = dict(site=site, ms=ms, plain_ms=plain, **bound_row(
                m, n, prods // n, m * k + nbytes + 4 * m * n))
            out[name].append(row)
            print(f"  time {name} {site} M={m} N={n} K={k}: kernel {ms:.4f} "
                  f"ms, plain {plain:.2f} ms, bound {row['bound_ms']:.5f} "
                  "ms", flush=True)
    return out


def dequantize_ms(torch, leaves):
    """Host ms (to synchronize) of dequantizing ``leaves`` to bfloat16,
    mean of 3 after one."""
    from repro_torch.core.qtensor import asarray

    def run():
        for leaf in leaves:
            asarray(leaf, torch.bfloat16)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / 3 * 1e3


def family8_serves(torch, counters, cfg, seed, model, params, sparse, reqs,
                   max_len, per_step, layers, check_caches=None,
                   prefill_calls=None):
    """Serve ``reqs`` from dense (row 1) and compressed (row 6) storage
    with the launch gate of ``family_serve``; step 1's prefill dots at the
    call indices ``prefill_calls`` (by default ``layers``) held against
    plain on their first and last ``PREFILL_ROWS`` rows; a 2-step profile;
    the same tokens from both; one decode's logits bit for bit across them
    and its dots at the call indices ``layers`` equal to plain. Returns
    the records by storage."""
    from repro_torch.core import dispatch

    out, tokens = {}, {}
    for compressed, p in ((False, params), (True, sparse)):
        storage = "compressed" if compressed else "dense"
        rec = DotRecorder(dispatch)
        eng, tokens[storage], run = family_serve(
            torch, counters, cfg, seed, (model, p), reqs(), max_len,
            compressed, per_step, first=rec)
        if check_caches is not None:
            check_caches(eng)
        t = time.perf_counter()
        m = [c[0].numel() // c[0].shape[-1] for c in rec.calls]
        prefill = [i for i, rows in enumerate(m) if rows > 4]
        if len(prefill) != per_step or len({m[i] for i in prefill}) != 1:
            raise AssertionError(f"step 1's dots at rows {m}: not one "
                                 f"prefill pass of {per_step}")
        rows = m[prefill[0]]
        err, n = rec.plain_errors(torch, rows=PREFILL_ROWS, calls=[
            prefill[i] for i in (layers if prefill_calls is None
                                 else prefill_calls)])
        del rec
        print(f"  the prefill's {n} dots (M = {rows}) on rows 0-"
              f"{PREFILL_ROWS - 1} and {rows - PREFILL_ROWS}-{rows - 1} "
              f"against their plain versions: max |diff| {err}", flush=True)
        if err:
            raise AssertionError(f"{storage}: a prefill dot differs from its "
                                 f"plain version by {err}")
        run.update(prefill_rows=rows, prefill_plain_held=n,
                   prefill_checks_s=time.perf_counter() - t,
                   profile=profile_decode(torch, eng, cfg.vocab_size))
        out[storage] = run
        del eng
    if tokens["compressed"] != tokens["dense"]:
        raise AssertionError(f"tokens differ: {tokens}")
    print(f"  the same tokens from both storages; request 0 "
          f"{tokens['dense'][0]}", flush=True)
    check_logits(torch, model, cfg, seed, (
        ("dense", params, dict(policy="sorted_tiled_seq")),
        ("compressed", sparse, dict(policy="sorted_tiled_seq"))))
    for storage, p in (("dense", params), ("compressed", sparse)):
        held_decode(torch, model, p, cfg, seed, per_step,
                    f"{storage}, one decode step, layers 0 and "
                    f"{cfg.num_layers - 1}", calls=layers)
    return out


def phase_granite_moe(torch, counters, sm, nm, seed):
    """8a: granite-moe-3b at its published widths (d 1536, 24 x 64 heads,
    8 KV heads, 40 experts top-8 of d_ff 512 in every layer, tied vocab
    49155), cut to ``FAMILY8_LAYERS`` layers, random seeded weights,
    8:16-pruned int8 (the experts quantized per matrix, a scale per expert
    column; the router float), served on 4 slots under
    ``sorted_tiled_seq`` from dense storage (row 1) and compressed storage
    (row 6): 4 prompts of 20-32 tokens, 16 new each. Gates: 4 x 4
    launches a step of the storage's kernel and no other (the experts are
    float einsums on the dequantized stack, as in the JAX package); the
    same tokens from both storages and one decode's logits bit for bit;
    every ``pqs_dot`` of one decode step and of the prefill's first and
    last rows at layers 0 and 3 equal to plain; layer 0's ``moe_ffn`` on
    one decode's input: its dispatch buffer holds each token in slot 0 of
    its routed experts and zeros elsewhere, and its output is within
    ``MOE_REL_TOL`` of the dropless ``moe_ffn_dense``'s largest
    magnitude. Prints the experts' bytes and dequantize ms a layer
    (each storage) and the tied head's. Returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.core.qtensor import QTensor, asarray, nm_compress_tree
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.model import cast_for_compute

    cfg = dataclasses.replace(get_config("granite-moe-3b-a800m"),
                              num_layers=FAMILY8_LAYERS)
    t0 = time.perf_counter()
    model, params = model_params(cfg, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    experts = [layer["moe"][k] for layer in params["layers"]
               for k in ("w_gate", "w_up", "w_out")]
    codes = sum(e.values.numel() for e in experts)
    copies = sum(e.values_t.numel() for e in experts
                 if isinstance(e, QTensor) and e.values_t is not None)
    print(f"  init, quantize and compress: {init_s:.1f} s; the experts' "
          f"int8 codes {codes / 2**30:.3f} GiB, transposed copies "
          f"{copies / 2**30:.3f} GiB; embed {type(params['embed']).__name__}"
          f" in both trees", flush=True)
    if copies or not isinstance(sparse["embed"], QTensor):
        raise AssertionError("expert stacks keep a transposed copy, or the "
                             "unprunable tied table was compressed")
    per_step = 4 * cfg.num_layers
    layers = list(range(4)) + list(range(per_step - 4, per_step))
    out = {"init_s": init_s, "expert_code_bytes": codes,
           "expert_copy_bytes": copies}
    out.update(family8_serves(
        torch, counters, cfg, seed, model, params, sparse,
        lambda: family_requests(cfg, seed, 16), 64, per_step, layers))
    # layer 0's MoE on one decode's input: the grouped dispatch's buffer
    # against the routing, its output against the dropless oracle
    with CallRecorder(moe_lib, "moe_ffn") as rec:
        decode_logits(torch, model, params, cfg, seed,
                      dict(policy="sorted_tiled_seq"))
    x = next(a[1] for a, _ in rec.calls if a[1].shape[0] == 4)
    p0 = cast_for_compute(params, cfg)["layers"][0]["moe"]
    with CallRecorder(moe_lib, "_experts") as experts_in, torch.no_grad():
        got, _ = moe_lib.moe_ffn(p0, x, cfg, cfg.moe)
        want, _ = moe_lib.moe_ffn_dense(p0, x, cfg, cfg.moe)
        idx = moe_lib.route(x, asarray(p0["router"], torch.float32),
                            cfg.moe)[0]
    torch.cuda.synchronize()
    # one token a group: each of its k distinct experts takes it in slot 0
    buf = experts_in.calls[0][0][1]  # (G, E, C, d)
    expect = torch.zeros_like(buf)
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    expect[rows, idx[:, 0], 0] = x[:, 0, None]
    placed = torch.equal(buf, expect)
    diff = float((got.float() - want.float()).abs().max())
    ref = float(want.float().abs().max())
    print(f"  layer 0's moe_ffn at decode (x {tuple(x.shape)}, buffer "
          f"{tuple(buf.shape)}): each token in slot 0 of its "
          f"{cfg.moe.top_k} routed experts and zeros elsewhere {placed}; "
          f"against moe_ffn_dense max |diff| {diff:.5f} of max |ref| "
          f"{ref:.4f}", flush=True)
    if not placed or not diff <= MOE_REL_TOL * ref:
        raise AssertionError("moe_ffn's dispatch misplaces a token, or its "
                             "output differs from moe_ffn_dense")
    out.update(moe_vs_dense=dict(max_abs_diff=diff, ref_max=ref,
                                 rel_tol=MOE_REL_TOL))
    out["experts_dequantize_ms_a_layer"] = {
        storage: dequantize_ms(torch, [tree["layers"][0]["moe"][k] for k in (
            "w_gate", "w_up", "w_out")])
        for storage, tree in (("dense", params), ("compressed", sparse))}
    print(f"  the experts' dequantize a layer (40 x 3 matrices of 1536 x 512 "
          f"to bfloat16): {out['experts_dequantize_ms_a_layer']} ms",
          flush=True)
    out["head_dequantize_ms"] = table_dequantize_ms(torch, params["embed"])
    out["sites"] = family_sites_timing(torch, sm, nm, {
        "wq": (1536, 1536), "wk": (512, 1536), "wv": (512, 1536),
        "wo": (1536, 1536)}, seed)
    out["plain_held"] = len(layers)
    return out


def phase_mamba2(torch, counters, sm, nm, seed):
    """8b: mamba2-2.7b at its published widths (d 2560, d_inner 5120, 80
    heads x 64, d_state 128, conv 4, tied vocab 50280), cut to
    ``FAMILY8_LAYERS`` layers, random seeded weights, 8:16-pruned int8,
    served on 4 slots under ``sorted_tiled_seq`` from dense storage (row
    1) and compressed storage (row 6): three prompts of 20-32 tokens (16
    new) and one of 1000 (40 new), a 1024 bucket, so the prefill runs 4
    SSD chunks of 256 and decode starts from a multi-chunk state. Gates: 2
    x 4 launches a step of the storage's kernel and no other (in_proj N =
    10576, out_proj K = 5120); per-layer caches ``ssd`` (4, 80, 64, 128)
    float32 and ``conv`` (4, 3, 5376); the same tokens and one decode's
    logits bit for bit from both storages; every ``pqs_dot`` of one decode
    step at layers 0 and 3 equal to plain (all of in_proj's outputs), and
    of the prefill (M = 4096) on its first and last rows; layer 0's
    chunked ``mamba_forward`` over the 1000-token prompt against 1000
    ``mamba_step`` calls in float (the projections dequantized): outputs
    within ``SSD_OUT_REL_TOL`` and final states within
    ``SSD_STATE_REL_TOL`` of their largest magnitude, the conv rings
    equal. Returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.core.qtensor import QTensor, asarray, nm_compress_tree
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models.layers import norm
    from repro_torch.models.model import cast_for_compute
    from repro_torch.models.transformer import embed_tokens

    cfg = dataclasses.replace(get_config("mamba2-2.7b"),
                              num_layers=FAMILY8_LAYERS)
    dims = ssm_lib.ssm_dims(cfg)
    t0 = time.perf_counter()
    model, params = model_params(cfg, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"  init, quantize and compress: {init_s:.1f} s; dims {dims}",
          flush=True)
    if not isinstance(sparse["embed"], QTensor):
        raise AssertionError("the unprunable tied table was compressed")
    per_step = 2 * cfg.num_layers
    layers = [0, 1, per_step - 2, per_step - 1]
    want = [((4, dims["nheads"], cfg.ssm.head_dim, cfg.ssm.d_state),
             torch.float32), ((4, cfg.ssm.d_conv - 1, dims["d_xbc"]),
                              torch.float32)]

    def check_caches(eng):
        got = [[(tuple(c[k].shape), c[k].dtype) for k in ("ssd", "conv")]
               for c in eng.caches]
        print(f"  caches a layer {got[0]}", flush=True)
        if any(g != want for g in got) or len(got) != cfg.num_layers:
            raise AssertionError(f"caches {got} != {want} a layer")

    out = {"init_s": init_s}
    out.update(family8_serves(
        torch, counters, cfg, seed, model, params, sparse,
        lambda: family_requests(cfg, seed, 16, MAMBA_LONG), sum(MAMBA_LONG),
        per_step, layers, check_caches))
    # layer 0, chunked against stepwise, in float on the long prompt
    t = time.perf_counter()
    long = family_requests(cfg, seed, 16, MAMBA_LONG)[3].prompt
    n = len(long)
    toks = torch.zeros((1, 1024), dtype=torch.int32, device="cuda")
    toks[0, :n] = torch.from_numpy(long).to("cuda")
    cp = cast_for_compute(params, cfg)
    lp = dict(cp["layers"][0]["mamba"])
    for k in ("in_proj", "out_proj"):  # lin's float path, dequantized once
        lp[k] = asarray(lp[k], torch.bfloat16)
    with torch.no_grad():
        x = norm(embed_tokens(cp, toks, cfg), cp["layers"][0]["ln"], cfg)
        full, cache = ssm_lib.mamba_forward(
            lp, x, cfg, lengths=torch.tensor([n], device="cuda"))
        step = ssm_lib.empty_ssm_cache(cfg, 1, torch.float32, "cuda")
        outs = []
        for i in range(n):
            o, step = ssm_lib.mamba_step(lp, x[:, i : i + 1], step, cfg)
            outs.append(o)
        outs = torch.cat(outs, 1)
    torch.cuda.synchronize()
    rec = {}
    for key, a, b, tol in (("out", outs, full[:, :n], SSD_OUT_REL_TOL),
                           ("ssd", step["ssd"], cache["ssd"],
                            SSD_STATE_REL_TOL)):
        diff = float((a.float() - b.float()).abs().max())
        ref = float(b.float().abs().max())
        rec[key] = dict(max_abs_diff=diff, ref_max=ref, rel_tol=tol)
        if not diff <= tol * ref:
            raise AssertionError(f"chunked {key} differs from stepwise by "
                                 f"{diff} (max |ref| {ref})")
    ring = torch.equal(step["conv"].float(), cache["conv"].float())
    print(f"  layer 0 over the {n}-token prompt, {n // 256 + 1} chunks of "
          f"256 against {n} mamba_step calls: outputs {rec['out']}, final "
          f"state {rec['ssd']}, conv rings equal {ring}; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if not ring:
        raise AssertionError("the conv rings differ")
    out.update(chunked_vs_stepwise=rec,
               head_dequantize_ms=table_dequantize_ms(torch,
                                                      params["embed"]),
               sites=family_sites_timing(torch, sm, nm, {
                   "in_proj": (dims["d_in_proj"], cfg.d_model),
                   "out_proj": (cfg.d_model, dims["d_inner"])}, seed),
               plain_held=len(layers))
    return out


# ---------------------------------------------------------------------------
# phase 9: the rest of the model zoo at its published widths: the hybrid
# (9a, jamba), the encoder-decoder (9b, whisper) and the vlm backbone (9c,
# qwen2-vl)
# ---------------------------------------------------------------------------

JAMBA_LAYERS = 5  # of 32: layers 0-4 hold every kind of the published pattern
QWEN2_VL_LAYERS = 2  # of 80
WHISPER_FRAMES = 1500  # whisper's 30-second window
VLM_GRID = 8  # an 8 x 8 grid of image patches before the text
VLM_TEXT = 32
VLM_DECODES = 4


def pass_sites(layers, parts=("attn", "mamba", "mlp")):
    """Each layer's integer dots in one pass, in call order: the quantized
    projections of its ``parts`` (a MoE layer's experts and router are
    float, as in the JAX package)."""
    from repro_torch.core.qtensor import is_qtensor

    return [[name for part in parts if part in layer
             for name, w in layer[part].items()
             if is_qtensor(w) and w.ndim == 2] for layer in layers]


def call_indices(sites, layers):
    """The positions in a pass's call order of the dots of ``layers``."""
    starts = [sum(len(s) for s in sites[:i]) for i in range(len(sites))]
    return [starts[i] + j for i in layers for j in range(len(sites[i]))]


def storages(torch, cfg, seed):
    """(model, dense params, compressed params, init s): ``cfg`` built,
    8:16-pruned int8 (``model_params``), then ``nm_compress_tree``."""
    from repro_torch.core.qtensor import nm_compress_tree

    t0 = time.perf_counter()
    model, params = model_params(cfg, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    print(f"  init, quantize and compress: {init_s:.1f} s; device memory "
          f"held {torch.cuda.memory_allocated() / 2**30:.2f} GiB", flush=True)
    return model, params, sparse, init_s


def counted(counters, compressed, need, what):
    """The launches since the last ``reset``: the storage's K-streaming
    kernel ``need`` times, every other kernel never."""
    kernel = FAMILY_KERNEL[compressed]
    launches = {name: fn.launches for name, fn in counters.items()
                if fn.launches}
    print(f"  {what}: launches {launches} (need {need} of {kernel})",
          flush=True)
    if launches != ({kernel: need} if need else {}):
        raise AssertionError(f"{what}: launches {launches} != {need} of "
                             f"{kernel}, the others 0")
    return need


def phase_jamba(torch, counters, sm, nm, seed):
    """9a: jamba-v0.1-52b at its published widths (d 4096, 32 x 128 heads,
    8 KV heads, d_ff 14336, 16 experts top-2, Mamba2 d_inner 8192 / 128
    heads / d_state 16, tied vocab 65536), cut to ``JAMBA_LAYERS`` layers,
    which hold every layer kind of the published pattern: Mamba2 + MLP
    (0, 2), Mamba2 + MoE (1, 3), attention + MLP (4). Random seeded
    weights, 8:16-pruned int8 (the experts a matrix at a time, the router
    float), served on 4 slots under ``sorted_tiled_seq`` from dense (row
    1) and compressed storage (row 6): 4 prompts of 20-32 tokens, 16 new
    each. Gates: the launches a step the layer kinds give (2 a Mamba2
    layer, 3 an MLP, 4 the attention: 21) of the storage's kernel and no
    other; per-layer caches of the layer's kind; the same tokens and one
    decode's logits bit for bit from both storages; every ``pqs_dot`` of
    one decode step at layers 0 and 4, and of the prefill at layer 4 on
    its first and last rows, equal to plain. Prints the experts' and the
    tied head's dequantize ms. Returns the record."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    from repro_torch.models.ssm import ssm_dims

    cfg = dataclasses.replace(get_config("jamba-v0.1-52b"),
                              num_layers=JAMBA_LAYERS)
    kinds = [("attention" if hybrid.is_attn_layer(i, cfg) else "mamba")
             + (" + moe" if hybrid.is_moe_layer(i, cfg) else " + mlp")
             for i in range(cfg.num_layers)]
    model, params, sparse, init_s = storages(torch, cfg, seed)
    sites = pass_sites(params["layers"])
    per_step = sum(len(s) for s in sites)
    print(f"  layers {kinds}; dots a pass {[len(s) for s in sites]} = "
          f"{per_step}", flush=True)
    dims = ssm_dims(cfg)
    want = [{"k": (4, 64, cfg.num_kv_heads, cfg.resolved_head_dim),
             "v": (4, 64, cfg.num_kv_heads, cfg.resolved_head_dim),
             "pos": (4,)} if hybrid.is_attn_layer(i, cfg) else
            {"ssd": (4, dims["nheads"], cfg.ssm.head_dim, cfg.ssm.d_state),
             "conv": (4, cfg.ssm.d_conv - 1, dims["d_xbc"])}
            for i in range(cfg.num_layers)]

    def check_caches(eng):
        got = [{k: tuple(v.shape) for k, v in c.items()} for c in eng.caches]
        print(f"  caches by layer {got}", flush=True)
        if got != want:
            raise AssertionError(f"caches {got} != {want}")

    last = cfg.num_layers - 1
    out = {"init_s": init_s, "layer_kinds": kinds,
           "dots_per_pass": per_step}
    out.update(family8_serves(
        torch, counters, cfg, seed, model, params, sparse,
        lambda: family_requests(cfg, seed, 16), 64, per_step,
        call_indices(sites, [0, last]), check_caches,
        prefill_calls=call_indices(sites, [last])))
    moe = next(layer["moe"] for layer in params["layers"] if "moe" in layer)
    moe_c = next(layer["moe"] for layer in sparse["layers"] if "moe" in layer)
    out["experts_dequantize_ms_a_layer"] = {
        storage: dequantize_ms(torch, [tree[k] for k in (
            "w_gate", "w_up", "w_out")])
        for storage, tree in (("dense", moe), ("compressed", moe_c))}
    print(f"  the experts' dequantize a MoE layer (16 x 3 matrices of 4096 "
          f"x 14336 to bfloat16): {out['experts_dequantize_ms_a_layer']} ms",
          flush=True)
    out["head_dequantize_ms"] = {
        storage: table_dequantize_ms(torch, tree["embed"])
        for storage, tree in (("dense", params), ("compressed", sparse))}
    out["sites"] = family_sites_timing(torch, sm, nm, {
        "in_proj": (dims["d_in_proj"], cfg.d_model),
        "out_proj": (cfg.d_model, dims["d_inner"]),
        "wq": (cfg.num_heads * cfg.resolved_head_dim, cfg.d_model),
        "wk": (cfg.num_kv_heads * cfg.resolved_head_dim, cfg.d_model),
        "w_gate": (cfg.d_ff, cfg.d_model),
        "w_out": (cfg.d_model, cfg.d_ff)}, seed)
    return out


def phase_whisper(torch, counters, sm, nm, seed):
    """9b: whisper-medium at its published widths and depth (24 encoder and
    24 decoder layers, d 1024, 16 heads, d_ff 4096, vocab 51865, learned
    decoder positions), random seeded weights, 8:16-pruned int8, dense
    (row 1) and compressed storage (row 6). The engine: 4 slots, 4
    prompts of 20-32 tokens, 16 new each, its cross K/V from a zero
    encoder output of 1500 frames (as the JAX engine builds them, at
    construction, outside the integer context): the launches a step the
    decoder's layers give (self-attention 4, cross-attention wq / wo 2,
    MLP 2: 192), the same tokens from both storages. The model bundle,
    all inside ``integer_lin``: ``encode`` 4 clips of ``WHISPER_FRAMES``
    seeded frames (6 dots a layer), ``init_caches(enc_out=...)`` (the
    cross K/V: 2 unnamed dots a layer), a prefill of 4 x 16 tokens and 2
    decodes (8 a layer each), each pass's launches counted; the encoder's
    dots at layers 0 and 23 equal to plain on the first and last 4 frames,
    one decode step's at layers 0 and 23 equal to plain; the prefill's and
    both decodes' logits bit for bit from both storages. Returns the
    record."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import dispatch
    from repro_torch.models import encdec
    from repro_torch.models.model import cast_for_compute

    cfg = get_config("whisper-medium")
    model, params, sparse, init_s = storages(torch, cfg, seed)
    # a decoder step's dots: self-attention, the cross-attention's wq and
    # wo (its K / V are cached), the MLP
    layers = params["dec_layers"]
    xattn = pass_sites(layers, ("xattn",))
    step_sites = [a + [k for k in x if k in ("wq", "wo")] + m
                  for a, x, m in zip(pass_sites(layers, ("attn",)), xattn,
                                     pass_sites(layers, ("mlp",)))]
    cross = sum(k in ("wk", "wv") for x in xattn for k in x)
    enc_sites = pass_sites(params["enc_layers"], ("attn", "mlp"))
    per_step = sum(len(s) for s in step_sites)
    per_encode = sum(len(s) for s in enc_sites)
    print(f"  dots a decoder step {per_step} ({len(step_sites[0])} a layer),"
          f" an encode {per_encode}, the cross K/V {cross}", flush=True)
    out = {"init_s": init_s, "dots_per_step": per_step,
           "dots_per_encode": per_encode, "cross_kv_dots": cross}
    tokens = {}
    for compressed, p in ((False, params), (True, sparse)):
        storage = "compressed" if compressed else "dense"
        eng, tokens[storage], run = family_serve(
            torch, counters, cfg, seed, (model, p),
            family_requests(cfg, seed, 16), 64, compressed, per_step)
        shapes = {k: tuple(eng.caches[k][0]["k"].shape)
                  for k in ("self", "cross")}
        print(f"  caches a layer {shapes}", flush=True)
        if shapes["cross"] != (4, WHISPER_FRAMES, cfg.num_kv_heads,
                               cfg.resolved_head_dim):
            raise AssertionError(f"cross K/V {shapes['cross']}")
        run["profile"] = profile_decode(torch, eng, cfg.vocab_size)
        out[storage] = run
        del eng
    if tokens["compressed"] != tokens["dense"]:
        raise AssertionError(f"tokens differ: {tokens}")
    print(f"  the same tokens from both storages; request 0 "
          f"{tokens['dense'][0]}", flush=True)
    # the model bundle: encode, the cross K/V, a prefill and 2 decodes
    frames = torch.from_numpy(np.random.default_rng(seed + 3).standard_normal(
        (4, WHISPER_FRAMES, cfg.d_model)).astype(np.float32)).to("cuda")
    toks = torch.tensor([p[:16].tolist() for p in prompts(
        4, seed, cfg.vocab_size)], device="cuda", dtype=torch.int32)
    lengths = torch.full((4,), 16, device="cuda", dtype=torch.int32)
    last = cfg.num_layers - 1
    logits, bundle = {}, {}
    for compressed, p in ((False, params), (True, sparse)):
        storage = "compressed" if compressed else "dense"
        rec = {}
        with torch.no_grad(), dispatch.integer_lin(dispatch.IntegerLinConfig(
                policy="sorted_tiled_seq")):
            reset(counters)
            t0 = time.perf_counter()
            with DotRecorder(dispatch) as rec["encode"]:
                enc = encdec.encode(cast_for_compute(p, cfg), frames, cfg)
            torch.cuda.synchronize()
            t_enc = time.perf_counter() - t0
            counted(counters, compressed, per_encode, f"{storage} encode")
            reset(counters)
            caches = model.init_caches(p, 4, 32, torch.float32, enc_out=enc)
            counted(counters, compressed, cross, f"{storage} cross K/V")
            reset(counters)
            lp, caches = model.prefill(p, toks, caches, lengths)
            counted(counters, compressed, per_step, f"{storage} prefill")
            outs = [lp]
            nxt = toks[:, -1:]
            for i in range(2):
                reset(counters)
                with DotRecorder(dispatch) if i == 0 else \
                        contextlib.nullcontext() as rec[f"decode {i}"]:
                    ld, caches = model.decode(p, nxt, caches)
                counted(counters, compressed, per_step,
                        f"{storage} decode {i}")
                outs.append(ld)
                nxt = ld[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        logits[storage] = outs
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        print(f"  {storage} bundle: encode {tuple(enc.shape)} in {t_enc:.2f}"
              f" s, logits {[tuple(o.shape) for o in outs]} finite {finite}",
              flush=True)
        if not finite or tuple(enc.shape) != (4, WHISPER_FRAMES, cfg.d_model):
            raise AssertionError(f"{storage}: encoder states or logits")
        t = time.perf_counter()
        err, n = rec["encode"].plain_errors(
            torch, rows=4, calls=call_indices(enc_sites, [0, last]))
        err2, n2 = rec["decode 0"].plain_errors(
            torch, calls=call_indices(step_sites, [0, last]))
        print(f"  {storage}: the encoder's {n} dots of layers 0 and {last} "
              f"(M = {4 * WHISPER_FRAMES}) on frames 0-3 and "
              f"{4 * WHISPER_FRAMES - 4}-{4 * WHISPER_FRAMES - 1}, and one "
              f"decode step's {n2} dots of layers 0 and {last}, against "
              f"their plain versions: max |diff| {err}, {err2}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if err or err2:
            raise AssertionError(f"{storage}: a dot differs from its plain "
                                 f"version by {max(err, err2)}")
        bundle[storage] = dict(encode_s=t_enc, plain_held=n + n2,
                               launches=per_encode + cross + 3 * per_step)
        del rec, caches, enc
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(
        logits["dense"], logits["compressed"])]
    print(f"  prefill and 2 decodes' logits, dense against compressed: "
          f"max |diff| {diffs}", flush=True)
    if any(diffs):
        raise AssertionError("the storages' logits differ")
    out["bundle"] = bundle
    out["head_dequantize_ms"] = table_dequantize_ms(torch, params["embed"])
    out["sites"] = family_sites_timing(torch, sm, nm, {
        "wq": (cfg.d_model, cfg.d_model), "w_in": (cfg.d_ff, cfg.d_model),
        "w_out": (cfg.d_model, cfg.d_ff)}, seed)
    return out


def vlm_positions(torch, b):
    """(3, b, S) M-RoPE streams: ``VLM_GRID`` x ``VLM_GRID`` image patches
    (t 0, h the row, w the column), then ``VLM_TEXT`` text positions, all
    three streams at ``VLM_GRID`` + i."""
    n = VLM_GRID * VLM_GRID
    grid = torch.arange(n, device="cuda")
    img = torch.stack([torch.zeros_like(grid), grid // VLM_GRID,
                       grid % VLM_GRID])
    text = (VLM_GRID + torch.arange(VLM_TEXT, device="cuda")).expand(3, -1)
    pos = torch.cat([img, text], dim=1).to(torch.int32)
    return pos[:, None].expand(3, b, n + VLM_TEXT).contiguous()


def phase_qwen2_vl(torch, counters, sm, nm, seed):
    """9c: qwen2-vl-72b at its published widths (d 8192, 64 x 128 heads, 8
    KV heads, d_ff 29568, M-RoPE sections (16, 24, 24), untied head
    152064), cut to ``QWEN2_VL_LAYERS`` layers, random seeded weights,
    8:16-pruned int8, dense (row 1) and compressed storage (row 6). Its
    inputs are embeddings (a stubbed vision frontend; there is no table),
    so it runs through the model bundle: ``forward`` on 4 sequences of
    ``VLM_GRID``^2 image patches and ``VLM_TEXT`` text positions of seeded
    embeddings, each with distinct t / h / w streams (``vlm_positions``),
    then a prefill of 4 x 32 embeddings and ``VLM_DECODES`` decodes. Gates:
    each pass the launches the layers and the head give (7 a layer plus the
    head: 15) of the storage's kernel and no other; the forward's dots of
    layers 0 and 1 equal to plain on its first and last ``VLM_ROWS`` rows
    (a plain version at K = 29568 takes 3 s a row); one decode
    step's head equal to plain (4 rows); the forward's and the decodes'
    logits bit for bit from both storages. Returns the record."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import dispatch

    cfg = dataclasses.replace(get_config("qwen2-vl-72b"),
                              num_layers=QWEN2_VL_LAYERS)
    model, params, sparse, init_s = storages(torch, cfg, seed)
    sites = pass_sites(params["layers"])
    per_pass = sum(len(s) for s in sites) + 1  # the untied head
    r = np.random.default_rng(seed + 5)
    s = VLM_GRID * VLM_GRID + VLM_TEXT
    emb = torch.from_numpy(r.standard_normal((4, s, cfg.d_model)).astype(
        np.float32)).to("cuda")
    pos = vlm_positions(torch, 4)
    steps = torch.from_numpy(r.standard_normal(
        (4, VLM_DECODES, cfg.d_model)).astype(np.float32)).to("cuda")
    t_h_w = pos[:, 0, 60:68].tolist()
    print(f"  dots a pass {[len(x) for x in sites]} + the head = {per_pass};"
          f" forward on {tuple(emb.shape)}, streams t / h / w at positions "
          f"60-67 {t_h_w}", flush=True)
    out = {"init_s": init_s, "dots_per_pass": per_pass}
    logits = {}
    for compressed, p in ((False, params), (True, sparse)):
        storage = "compressed" if compressed else "dense"
        rec = {}
        with torch.no_grad(), dispatch.integer_lin(dispatch.IntegerLinConfig(
                policy="sorted_tiled_seq")):
            reset(counters)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with DotRecorder(dispatch) as rec["forward"]:
                lf = model.forward(p, {"embeddings": emb, "positions": pos})
            torch.cuda.synchronize()
            t_fwd = time.perf_counter() - t0
            counted(counters, compressed, per_pass, f"{storage} forward")
            caches = model.init_caches(p, 4, 64, torch.float32)
            reset(counters)
            t0 = time.perf_counter()
            lp, caches = model.prefill(p, emb[:, -VLM_TEXT:], caches,
                                       torch.full((4,), VLM_TEXT,
                                                  device="cuda",
                                                  dtype=torch.int32))
            torch.cuda.synchronize()
            t_prefill = time.perf_counter() - t0
            counted(counters, compressed, per_pass, f"{storage} prefill")
            outs, t_steps = [lf, lp], []
            for i in range(VLM_DECODES):
                reset(counters)
                t0 = time.perf_counter()
                with DotRecorder(dispatch) if i == 0 else \
                        contextlib.nullcontext() as rec[f"decode {i}"]:
                    ld, caches = model.decode(p, steps[:, i : i + 1], caches)
                torch.cuda.synchronize()
                t_steps.append(time.perf_counter() - t0)
                counted(counters, compressed, per_pass,
                        f"{storage} decode {i}")
                outs.append(ld)
            run = dict(forward_s=t_fwd, prefill=t_prefill,
                       per_step=sum(t_steps[1:]) / (VLM_DECODES - 1),
                       launches_per_pass=per_pass,
                       launches=per_pass * (2 + VLM_DECODES))
            run["profile"] = profile_steps(torch, lambda: [model.decode(
                p, steps[:, i : i + 1], caches) for i in range(2)])
        logits[storage] = outs
        finite = all(bool(torch.isfinite(o).all()) for o in outs)
        print(f"  {storage}: forward {t_fwd:.2f} s, prefill {t_prefill:.3f} "
              f"s, decode {run['per_step']:.4f} s/step; logits "
              f"{[tuple(o.shape) for o in outs]} finite {finite}", flush=True)
        if not finite:
            raise AssertionError(f"{storage}: logits not finite")
        t = time.perf_counter()
        err, n = rec["forward"].plain_errors(
            torch, rows=VLM_ROWS,
            calls=call_indices(sites, range(cfg.num_layers)))
        err2, n2 = rec["decode 0"].plain_errors(torch, calls=[per_pass - 1])
        rows = 4 * s
        print(f"  {storage}: the forward's {n} dots of layers 0 and 1 (M = "
              f"{rows}) on {VLM_ROWS} row(s) at each end, and one "
              f"decode step's head (N = {cfg.vocab_size}, M = 4), against "
              f"their plain versions: max |diff| {err}, {err2}; "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if err or err2:
            raise AssertionError(f"{storage}: a dot differs from its plain "
                                 f"version by {max(err, err2)}")
        run.update(plain_held=n + n2, plain_checks_s=time.perf_counter() - t)
        out[storage] = run
        del rec, caches
    diffs = [float((a.float() - b.float()).abs().max()) for a, b in zip(
        logits["dense"], logits["compressed"])]
    print(f"  forward, prefill and {VLM_DECODES} decodes' logits, dense "
          f"against compressed: max |diff| {diffs}", flush=True)
    if any(diffs):
        raise AssertionError("the storages' logits differ")
    # (w_out's K = 29568 is held in tests/test_torch_cuda.py; its plain
    # version takes 12 s at M = 4)
    out["sites"] = family_sites_timing(torch, sm, nm, {
        "wq": (cfg.num_heads * cfg.resolved_head_dim, cfg.d_model),
        "w_gate": (cfg.d_ff, cfg.d_model),
        "head": (cfg.vocab_size, cfg.d_model)}, seed)
    return out


def paper_records(paper, policies):
    """Row 1's or row 2's 6a sub-record: launches per evaluate_int call of
    each net under each of ``policies`` and the times at mlp2's hidden
    layer (M = 128 and 512)."""
    return {policy: {
        "launches_per_evaluate_int": {
            name: net["launches_per_call"][policy]
            for name, net in paper["nets"].items()},
        **{f"M={m}": dict(work=f"mlp2 hidden layer (N = K = 784) at M={m}, "
                               f"acc_bits 16, k_tile 256, rounds 2",
                          timing=TIMING, **paper["timing"][(policy, m)])
           for m in (128, 512)}} for policy in policies}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", default=None,
                    help="comma-separated phase tags (2, 2c, 3, 3l, ...): "
                         "run only those after the build; such a partial "
                         "run prints no result")
    ap.add_argument("--baseline-csrc", default=None,
                    help="another tree's src/repro_torch/csrc: phase 5 "
                         "also times its rows 1 (wide) and 2-17 (old_ms)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import sorted_matmul as sm
    from repro_torch.kernels import sorted_stream as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    failures = []
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[1] built {len(build.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in build.BUILD_INFO.items():
        print(f"    {name}: nvcc {info['seconds']:.1f} s", flush=True)
        for kernel, regs, spill in build.register_report(info["log"]):
            print(f"    {name}: {kernel} {regs} registers, spill stores/"
                  f"loads {spill} bytes", flush=True)
    # what the packed sorts' 16x2 max / min / add compile to: row 1's
    # tiled sort, row 6's (8:16 at k_tile 256: 128 keys a tile) and the
    # whole-K `sorted` body at kp = 2048; the radix body at kp = 16384
    # (its ballots and shared atomics); row 8's row-block kernels (a block
    # per compressed row and 4 rows of x, products decoded once) and row
    # 13's merged-slot pass 2 at the main path's shapes
    for source, label, what in (
            ("seq_policy_matmul", "sorted_seq_kernel<8,32>", "k_tile 256"),
            ("nm_seq_policy_matmul", "nm_gather_kernel<4,32>",
             "8:16, k_tile 256"),
            ("nm_expand_seq", "nm_expand_kernel<4,32>",
             "8:16, k_tile 256: a tile's 128 listed nonzero positions"),

            ("sort_matmul", "sort_sorted_kernel<32,1>", "kp 2048"),
            ("sort_matmul", "sort_sorted_kernel<32,8>", "kp 16384"),
            ("nm_sort_matmul", "nm_sort_sorted_rows_kernel<16>",
             "8:16, K 1536: 1024 kept keys"),
            ("nm_sort_matmul", "nm_sort_tiled_kernel<4,32>",
             "8:16, K 1536, k_tile 256"),
            ("nm_expand_pass2", "nm_expand_paired_kernel<4,32,true>",
             "8:16, k_tile 256, merged slots"),
            ("sorted_stream", "paired_rows_kernel<16,16>",
             "k_tile 256, sorted on the nonzero products"),
            ("nm_sort_matmul", "nm_paired_rows_kernel<8,16>",
             "8:16, k_tile 256, products decoded once")):
        try:
            ops = build.sass_opcodes(source, label)
        except (OSError, subprocess.CalledProcessError) as exc:
            print(f"[1] SASS of {label} not read: {exc}", flush=True)
            continue
        packed = {op: n for op, n in sorted(ops.items(), key=lambda o: -o[1])
                  if "16x2" in op or op.startswith(("SHFL", "PRMT", "BAR",
                                                    "SEL", "LOP3", "VOTE",
                                                    "ATOMS"))}
        print(f"[1] SASS of {label} ({what}): {sum(ops.values())} "
              f"instructions; 16x2, shuffles, byte permutes, selects, "
              f"logic, barriers, votes and shared atomics {packed}",
              flush=True)

    cfg = get_config("qwen2-1.5b")
    counters = {"seq_policy_matmul": sm.seq_policy_matmul,
                "nm_gather_seq_policy_matmul": nm.nm_gather_seq_policy_matmul,
                "nm_seq_policy_matmul": nm.nm_seq_policy_matmul,
                "sort_matmul": sm.sort_matmul,
                "tile_sums_matmul": ss.tile_sums_matmul,
                "paired_accum_matmul": ss.paired_accum_matmul,
                "chunked_sort_matmul": ss.chunked_sort_matmul,
                "nm_gather_sort_matmul": nm.nm_gather_sort_matmul,
                "nm_gather_tile_sums": ss.nm_gather_tile_sums,
                "nm_gather_paired_accum_matmul":
                    ss.nm_gather_paired_accum_matmul,
                "nm_gather_chunked_sort_matmul":
                    ss.nm_gather_chunked_sort_matmul,
                "nm_sort_matmul": nm.nm_sort_matmul,
                "nm_tile_sums_matmul": ss.nm_tile_sums_matmul,
                "nm_paired_accum_matmul": ss.nm_paired_accum_matmul,
                "nm_chunked_sort_matmul": ss.nm_chunked_sort_matmul,
                "quant_matmul": qm.quant_matmul,
                "nm_spmm": nm.nm_spmm}
    got = {}  # what each phase measured, for the kernels line

    def dense_serve():
        got["launches"], _, got["tokens"], got["serve_s"] = phase_serve(
            torch, counters, cfg, args.seed, {"seq_policy_matmul": 7})

    def nm_serve():
        got["nm_launches"] = phase_serve(
            torch, counters, cfg, args.seed,
            {"nm_gather_seq_policy_matmul": 7}, compressed=True,
            want_tokens=got.get("tokens"))[0]
        if "tokens" not in got:
            raise AssertionError("no dense tokens to compare: phase 3 failed")

    # the global-sort serves (3c-3h) at SORT_SERVE_LAYERS of qwen2's 28
    sort_cfg = dataclasses.replace(cfg, num_layers=SORT_SERVE_LAYERS)

    def sort_serve(policy):
        got[policy], _, got[policy + " tokens"], _ = phase_serve(
            torch, counters, sort_cfg, args.seed, SORT_PATHS[policy],
            policy=policy)

    def nm_sort_serve(policy):
        got["nm " + policy] = phase_serve(
            torch, counters, sort_cfg, args.seed, NM_SORT_PATHS[policy],
            compressed=True, policy=policy,
            want_tokens=got.get(policy + " tokens"))[0]
        if policy + " tokens" not in got:
            raise AssertionError(f"no dense {policy} tokens to compare: "
                                 "its dense phase failed")

    def nm_expand_serve(policy):
        gather = "nm " + policy
        got["expand " + policy] = phase_serve(
            torch, counters, sort_cfg, args.seed, NM_EXPAND_PATHS[policy],
            compressed=True, policy=policy, nm_impl="expand",
            want_tokens=got.get(policy + " tokens"))[0]
        if policy + " tokens" not in got or gather not in got:
            raise AssertionError(f"no {policy} tokens of 3c-3f to compare: "
                                 "a phase before failed")

    def nm_seq_expand_serve(policy, key):
        got[key], _, _, got[key + " s"] = phase_serve(
            torch, counters, cfg, args.seed, {"nm_seq_policy_matmul": 7},
            compressed=True, policy=policy,
            nm_impl="expand" if policy == "sorted_tiled_seq" else None,
            want_tokens=got.get("tokens") if policy == "sorted_tiled_seq"
            else None)
        if policy == "sorted_tiled_seq" and "tokens" not in got:
            raise AssertionError("no tokens of 3 / 3b to compare: phase 3 "
                                 "failed")

    def timing():
        baseline = args.baseline_csrc and baseline_kernels(
            torch, args.baseline_csrc)
        got.update(
            timing=phase_timing(torch, sm, baseline),
            nm_timing=phase_nm_timing(torch, sm, nm, baseline),
            sorted_kp=phase_sorted_kp_timing(torch, ss, baseline),
            sort_timing=phase_sort_timing(torch, sm, ss, baseline),
            nm_sort_timing=phase_nm_sort_timing(torch, sm, ss, nm, baseline),
            pass1_timing=phase_pass1_timing(torch, ss, baseline),
            wide_timing=phase_wide_timing(torch, qm, nm, baseline))

    def kernel_checks():
        for key, fn, kernel_args in (
                ("err", phase_kernels, (sm, qm)),
                ("nm_err", phase_nm_kernels, (sm, nm)),
                ("sort_err", phase_sort_kernels, (sm, ss)),
                ("nm_sort_err", phase_nm_sort_kernels, (sm, ss, nm)),
                ("pass1_err", phase_pass1_kernels, (ss,)),
                ("fault_err", phase_gather_faults, (nm, ss)),
                ("sorted_err", phase_sorted_regimes, (sm, nm)),
                ("wide_err", phase_wide_kernels, (sm, qm, nm)),
                ("dup_err", phase_duplicate_slots, (sm, nm)),
                ("qm_err", phase_quant_matmul_bodies, (sm, qm))):
            t = time.perf_counter()
            got[key] = fn(torch, *kernel_args, args.seed)
            print(f"  {fn.__name__}: {time.perf_counter() - t:.1f} s",
                  flush=True)

    def census_serve(key, compressed):
        got[key] = phase_census_serve(torch, counters, cfg, args.seed,
                                      compressed, want=got.get("3l"))
        if compressed and "3l" not in got:
            raise AssertionError("no 3l serve to compare: 3l failed")

    phases = [
        ("[2] kernel vs plain", kernel_checks),
        ("[2c] the overflow census on the card", lambda: got.update(
            census_err=phase_census(torch, args.seed))),
        ("[3] serve qwen2-1.5b", dense_serve),
        ("[3b] serve qwen2-1.5b from N:M compressed storage", nm_serve),
        ("[3c] serve qwen2-1.5b at 14 layers under sorted_tiled",
         lambda: sort_serve("sorted_tiled")),
        ("[3d] serve qwen2-1.5b at 14 layers under sorted",
         lambda: sort_serve("sorted")),
        ("[3e] serve qwen2-1.5b at 14 layers from N:M compressed storage "
         "under sorted_tiled", lambda: nm_sort_serve("sorted_tiled")),
        ("[3f] serve qwen2-1.5b at 14 layers from N:M compressed storage "
         "under sorted", lambda: nm_sort_serve("sorted")),
        ("[3g] serve qwen2-1.5b at 14 layers from N:M compressed storage "
         "with nm_impl='expand' under sorted_tiled",
         lambda: nm_expand_serve("sorted_tiled")),
        ("[3h] serve qwen2-1.5b at 14 layers from N:M compressed storage "
         "with nm_impl='expand' under sorted",
         lambda: nm_expand_serve("sorted")),
        ("[3j] serve qwen2-1.5b from N:M compressed storage with "
         "nm_impl='expand' under sorted_tiled_seq",
         lambda: nm_seq_expand_serve("sorted_tiled_seq", "expand seq")),
        ("[3k] serve qwen2-1.5b from N:M compressed storage under wide "
         "(auto: expand)", lambda: nm_seq_expand_serve("wide", "expand wide")),
        ("[3l] calibrate, then serve qwen2-1.5b under a CensusWatch",
         lambda: census_serve("3l", False)),
        ("[3m] calibrate, then serve qwen2-1.5b from N:M compressed "
         "storage under a CensusWatch", lambda: census_serve("3m", True)),
        ("[3n] enforce, certify and serve qwen2-1.5b census-free",
         lambda: got.update({"3n": phase_certified(torch, counters, cfg,
                                                   args.seed)})),
        ("[3i] 28-layer decode logits, bit for bit within 3/3b/3j, "
         "3c/3e/3g, 3d/3f/3h and dense wide/3k",
         lambda: phase_logits_28(torch, cfg, args.seed)),
        ("[4] kernel vs plain serving, dense and compressed",
         lambda: phase_parity(torch, counters, cfg, args.seed)),
        ("[4b] kernel vs plain serving, sorted_tiled and sorted, dense "
         "and expand",
         lambda: phase_sort_parity(torch, counters, cfg, args.seed)),
        ("[4c] the torch quickstart on the card", lambda: got.update(
            zip(("quickstart", "quickstart_err"),
                phase_quickstart(torch, counters)))),
        ("[4d] quant_matmul and nm_spmm at the full-width qwen2-1.5b sites",
         lambda: got.update(full_width_err=phase_wide_full_width(
             torch, sm, qm, nm, cfg, args.seed))),
        ("[5] timing", timing),
        ("[6a] the paper nets: train, freeze, evaluate_int (rows 1 and 2) "
         "and overflow_profile", lambda: got.update(
             paper=phase_paper_nets(torch, counters, args.seed))),
        ("[6b] accumulator-aware fine-tune of qwen2-1.5b at 2 layers, then "
         "quantize_and_certify", lambda: got.update(
             finetune=phase_finetune(torch, args.seed))),
        ("[7a] serve gemma3-12b at full width, 6 layers (5 sliding-window "
         "rings + 1 global), dense and compressed", lambda: got.update(
             gemma3=phase_gemma3(torch, counters, args.seed))),
        ("[7b] serve qwen3-32b at full width, 1 layer: the untied head "
         "through row 1", lambda: got.update(
             qwen3=phase_qwen3(torch, counters, sm, args.seed))),
        ("[7c] serve command-r-35b at full width, 1 layer (layer norm)",
         lambda: got.update(
             command_r=phase_command_r(torch, counters, args.seed))),
        ("[8a] serve granite-moe-3b at full width, 4 layers (40 experts, "
         "top-8), dense and compressed", lambda: got.update(
             granite=phase_granite_moe(torch, counters, sm, nm, args.seed))),
        ("[8b] serve mamba2-2.7b at full width, 4 layers (chunked SSD, conv "
         "ring), dense and compressed", lambda: got.update(
             mamba=phase_mamba2(torch, counters, sm, nm, args.seed))),
        ("[9a] serve jamba-v0.1-52b at full width, 5 layers (Mamba2 / "
         "attention / MoE interleave), dense and compressed",
         lambda: got.update(jamba=phase_jamba(torch, counters, sm, nm,
                                              args.seed))),
        ("[9b] whisper-medium at full width and depth: the engine, then "
         "encode, cross K/V, prefill and decode, dense and compressed",
         lambda: got.update(whisper=phase_whisper(torch, counters, sm, nm,
                                                  args.seed))),
        ("[9c] qwen2-vl-72b at full width, 2 layers: M-RoPE embeddings "
         "through forward, prefill and decode, dense and compressed",
         lambda: got.update(qwen2_vl=phase_qwen2_vl(torch, counters, sm, nm,
                                                    args.seed))),
    ]
    only = args.only and set(args.only.split(","))
    for title, fn in phases:
        if only and title[1:title.index("]")] not in only:
            continue
        torch.cuda.reset_peak_memory_stats()
        print(title, flush=True)
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, fail at the end
            traceback.print_exc()
            failures.append(title)
        print(f"{title} done in {time.perf_counter() - t:.1f} s; device "
              f"memory held {torch.cuda.memory_allocated() / 2**30:.2f} GiB, "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    if only:
        print(f"chip_smoke: the phases {sorted(only)} passed (a partial run: "
              "no result)", flush=True)
        return 0
    csrc = "src/repro_torch/csrc/"
    nm_timing = got["nm_timing"]
    gather, expand = "nm_gather_seq_policy_matmul", "nm_seq_policy_matmul"

    def seq_work(policy, m):
        return (f"7 projection sites of one qwen2-1.5b layer at M={m}, 8:16 "
                "compressed slabs, acc_bits 16"
                + (", the int8 tensor-core mainloop" if policy in (
                    "wide", "wrap") else "")
                + ("; library: torch._int_mm on the decompressed weight"
                   + (" (int_mm_m32_ms: at M=32, as it refuses M=4)"
                      if m == 4 else "") if policy == "wide" else ""))

    def path_launches(run, name):
        """A guarded serve's launches of ``name``, in all and by policy."""
        by_policy = {}
        for step in run["steps"]:
            for policy, n in step["by_policy"].get(name, {}).items():
                by_policy[policy] = by_policy.get(policy, 0) + n
        return sum(s["launches"][name] for s in run["steps"]), by_policy

    dense, served = "seq_policy_matmul", got["3n"]["runs"]
    paper = got["paper"]
    row1_paths = {"3 sorted_tiled_seq": got["launches"][dense],
                  "6a clip": paper["launches"]["clip"],
                  "6a wide": paper["launches"]["wide"]}
    for path, run in (("3l census-watched", got["3l"]),
                      ("3n certified", served["certified"]),
                      ("3n censused", served["censused"])):
        row1_paths[path], row1_paths[path + " by policy"] = path_launches(
            run, dense)
    gemma3, qwen3, command_r = got["gemma3"], got["qwen3"], got["command_r"]
    granite, mamba = got["granite"], got["mamba"]
    jamba, whisper, qwen2_vl = got["jamba"], got["whisper"], got["qwen2_vl"]
    for path, run in (("7a gemma3-12b, dense", gemma3["dense"]),
                      ("7b qwen3-32b", qwen3), ("7c command-r-35b",
                                                command_r),
                      ("8a granite-moe-3b, dense", granite["dense"]),
                      ("8b mamba2-2.7b, dense", mamba["dense"]),
                      ("9a jamba-v0.1-52b, dense", jamba["dense"]),
                      ("9b whisper-medium engine, dense", whisper["dense"])):
        row1_paths[path] = run["launches"][dense]
    row1_paths["9b whisper-medium bundle, dense"] = whisper["bundle"][
        "dense"]["launches"]
    row1_paths["9c qwen2-vl-72b, dense"] = qwen2_vl["dense"]["launches"]
    row5_paths = {"3j sorted_tiled_seq": got["expand seq"][expand],
                  "3k wide": got["expand wide"][expand]}
    row6_paths = {"3b sorted_tiled_seq": got["nm_launches"][gather],
                  "7a gemma3-12b, compressed":
                      gemma3["compressed"]["launches"][gather],
                  "8a granite-moe-3b, compressed":
                      granite["compressed"]["launches"][gather],
                  "8b mamba2-2.7b, compressed":
                      mamba["compressed"]["launches"][gather],
                  "9a jamba-v0.1-52b, compressed":
                      jamba["compressed"]["launches"][gather],
                  "9b whisper-medium engine, compressed":
                      whisper["compressed"]["launches"][gather],
                  "9b whisper-medium bundle, compressed":
                      whisper["bundle"]["compressed"]["launches"],
                  "9c qwen2-vl-72b, compressed":
                      qwen2_vl["compressed"]["launches"]}

    def family_sites(name):
        """Row 1's or row 6's sub-records at the sites of 8a-9c."""
        def per_step(run):
            if "launches_per_pass" in run:  # 9c's model bundle
                return run["launches_per_pass"]
            return run["launches"][name] // run["steps"]

        return {key: kernel_record(
            name, csrc + ("seq_policy_matmul.cu" if name == dense
                          else "nm_seq_policy_matmul.cu"),
            "src/repro/kernels/sorted_matmul.py:155" if name == dense
            else "src/repro/kernels/nm_spmm.py:381", run["sites"][name],
            work=f"the {len(run['sites'][name])} projection site shapes of "
                 f"{what} at decode (M=4), acc_bits 16, k_tile 256"
                 + ("" if name == dense else ", 8:16 compressed slabs"),
            launches_per_step=per_step(
                run["dense" if name == dense else "compressed"]),
            by_site={r["site"]: {k: r[k] for k in ("ms", "plain_ms",
                                                   "bound_ms")}
                     for r in run["sites"][name]})
            for key, run, what in (
                ("8a_granite_moe_3b", granite, "granite-moe-3b"),
                ("8b_mamba2_2_7b", mamba, "mamba2-2.7b"),
                ("9a_jamba_v0_1_52b", jamba, "jamba-v0.1-52b"),
                ("9b_whisper_medium", whisper, "whisper-medium"),
                ("9c_qwen2_vl_72b", qwen2_vl, "qwen2-vl-72b"))}
    for paths, name in ((row5_paths, expand), (row6_paths, gather)):
        paths["3m census-watched"], paths["3m census-watched by policy"] = \
            path_launches(got["3m"], name)

    def total(paths):
        return sum(v for k, v in paths.items() if not k.endswith("policy"))

    kernels = [
        kernel_record(
            "seq_policy_matmul", csrc + "seq_policy_matmul.cu",
            "src/repro/kernels/sorted_matmul.py:155",
            got["timing"]["sorted_tiled_seq"],
            launches=total(row1_paths), launches_by_path=row1_paths,
            max_abs_err=max(got["err"],
                            got["quickstart_err"]["seq_policy_matmul"],
                            got["wide_err"]["seq_policy_matmul"],
                            paper["err"]),
            paper=paper_records(paper, ("clip", "wide")),
            wide={f"M={m}": kernel_record(
                "seq_policy_matmul", csrc + "seq_policy_matmul.cu",
                "src/repro/kernels/sorted_matmul.py:155",
                got["timing"][("wide", m)], policy="wide",
                work=f"7 projection sites of one qwen2-1.5b layer at M={m}, "
                     "the int8 tensor-core mainloop"
                     + ("; torch._int_mm refuses M=4" if m == 4 else ""))
                for m in (4, 64, 128)},
            qwen3_head=dict(
                work="qwen3-32b's untied head (N=151936, K=5120) at decode "
                     "(M=4), acc_bits 16, k_tile 256; library: "
                     "torch._int_mm at M=32 (it refuses M=4)",
                timing=TIMING, library_ms=None,
                bound_by="bytes" if qwen3["head"]["bytes_ms"]
                >= qwen3["head"]["ops_ms"] else "operations",
                **qwen3["head"]),
            families=family_sites(dense),
            path="phases 3, 3l (degraded sites: wide) and 3n (certified: "
                 "wide), dense storage; 6a (the paper nets' clip and wide); "
                 "7a-7c (gemma3-12b, qwen3-32b with its head, "
                 "command-r-35b), 8a-8b (granite-moe-3b's attention, "
                 "mamba2-2.7b's projections) and 9a-9c (jamba-v0.1-52b, "
                 "whisper-medium's engine and model bundle, qwen2-vl-72b "
                 "with its head), dense storage"),
        kernel_record(
            "nm_gather_seq_policy_matmul", csrc + "nm_seq_policy_matmul.cu",
            "src/repro/kernels/nm_spmm.py:381",
            nm_timing[(gather, "sorted_tiled_seq", 4)],
            launches=total(row6_paths), launches_by_path=row6_paths,
            max_abs_err=max(got["nm_err"]["nm_gather_seq_policy_matmul"],
                            got["fault_err"]["nm_gather_seq_policy_matmul"]),
            by_site={r["site"]: {key: r[key] for key in (
                "ms", "old_ms", "dense_ms", "bound_ms") if key in r}
                for r in nm_timing[(gather, "sorted_tiled_seq", 4)]},
            prefill=prefill_record(
                nm_timing[(gather, "sorted_tiled_seq", 128)],
                "7 projection sites of one qwen2-1.5b layer at a prefill "
                "cohort (M=128), 8:16 compressed slabs, acc_bits 16, k_tile "
                "256"),
            families=family_sites(gather),
            path="phases 3b and 3m (the undegraded sites), 7a "
                 "(gemma3-12b), 8a-8b (granite-moe-3b, mamba2-2.7b) and "
                 "9a-9c (jamba-v0.1-52b, whisper-medium, qwen2-vl-72b), "
                 "compressed storage"),
        kernel_record(
            "nm_seq_policy_matmul", csrc + "nm_expand_seq.cu",
            "src/repro/kernels/nm_spmm.py:182",
            nm_timing[(expand, "sorted_tiled_seq", 4)],
            launches=total(row5_paths), launches_by_path=row5_paths,
            max_abs_err=max(got["nm_err"][expand], got["dup_err"][expand]),
            by_site={r["site"]: {key: r[key] for key in (
                "ms", "old_ms", "dense_ms", "bound_ms") if key in r}
                for r in nm_timing[(expand, "sorted_tiled_seq", 4)]},
            prefill=prefill_record(
                nm_timing[(expand, "sorted_tiled_seq", 128)],
                "7 projection sites of one qwen2-1.5b layer at a prefill "
                "cohort (M=128), 8:16 compressed slabs, acc_bits 16, k_tile "
                "256"),
            policies={policy: {
                "M=4": kernel_record(
                    "nm_seq_policy_matmul", csrc + "nm_expand_seq.cu",
                    "src/repro/kernels/nm_spmm.py:182",
                    nm_timing[(expand, policy, 4)], policy=policy,
                    work=seq_work(policy, 4)),
                "M=128": prefill_record(nm_timing[(expand, policy, 128)],
                                        seq_work(policy, 128))}
                for policy in ("clip", "wrap", "wide")},
            launch_note="launches counts one a call; a wrap call whose K "
                        "is split over blocks runs two kernels (the int8 "
                        "mainloop, then wrap_kernel); 3j and 3k run no wrap",
            path="phases 3j (sorted_tiled_seq, nm_impl='expand'), 3k "
                 "(wide, auto) and 3m (the degraded sites: wide, auto), "
                 "compressed storage"),
    ]
    timing = got["sort_timing"]
    tiled, srt = got["sorted_tiled"], got["sorted"]
    six = ("the 6 K=1536 sites of one qwen2-1.5b layer at decode (M=4), "
           "acc_bits 16")
    w_out = "w_out (N=1536, K=8960) of one qwen2-1.5b layer at decode " \
            "(M=4), acc_bits 16"
    kernels += [
        kernel_record(
            "sort_matmul", csrc + "sort_matmul.cu",
            "src/repro/kernels/sorted_matmul.py:204", timing["sort_matmul"],
            policy="sorted_tiled", work=six + ", k_tile 256",
            launches=tiled["sort_matmul"] + srt["sort_matmul"]
            + paper["launches"]["sorted_tiled"] + paper["launches"]["sorted"],
            launches_by_path={"sorted_tiled": tiled["sort_matmul"],
                              "sorted": srt["sort_matmul"],
                              "6a sorted_tiled":
                                  paper["launches"]["sorted_tiled"],
                              "6a sorted": paper["launches"]["sorted"]},
            max_abs_err=max(got["sort_err"]["sort_matmul"],
                            got["sorted_err"]["sort_matmul"], paper["err"]),
            paper=paper_records(paper, ("sorted_tiled", "sorted")),
            sorted_policy=kernel_record(
                "sort_matmul", csrc + "sort_matmul.cu",
                "src/repro/kernels/sorted_matmul.py:204",
                timing["sort_matmul[sorted]"], policy="sorted",
                work=six + ", sorted over kp 2048 (the tail past K "
                           "masked in the kernel)",
                prefill=prefill_record(
                    timing["sort_matmul[sorted] M=128"],
                    six.replace("decode (M=4)", "a prefill cohort (M=128)")
                    + ", sorted over kp 2048")),
            path="phases 3c and 3d (one-pass at K = 1536); 6a (the paper "
                 "nets' sorted_tiled and sorted, K = 36 to 784)"),
        kernel_record(
            "tile_sums_matmul", csrc + "sorted_stream.cu",
            "src/repro/kernels/sorted_stream.py:110",
            timing["tile_sums_matmul"], policy="sorted_tiled",
            work=w_out + ", k_tile 256",
            launches=tiled["tile_sums_matmul"],
            max_abs_err=max(got["sort_err"]["tile_sums_matmul"],
                            got["pass1_err"]["tile_sums_matmul"]),
            **pass1_records("tile_sums_matmul", csrc + "sorted_stream.cu",
                            "src/repro/kernels/sorted_stream.py:110",
                            got["pass1_timing"], w_out + ", k_tile 256"),
            path="phase 3c (two-pass pass 1 at K = 8960)"),
        kernel_record(
            "paired_accum_matmul", csrc + "sorted_stream.cu",
            "src/repro/kernels/sorted_stream.py:262",
            timing["paired_accum_matmul"], policy="sorted_tiled",
            work=w_out + ", k_tile 256",
            launches=tiled["paired_accum_matmul"],
            max_abs_err=got["sort_err"]["paired_accum_matmul"],
            prefill=prefill_record(
                timing["paired_accum_matmul M=128"],
                w_out.replace("decode (M=4)", "a prefill cohort (M=128)")
                + ", k_tile 256"),
            served_weight=kernel_record(
                "paired_accum_matmul", csrc + "sorted_stream.cu",
                "src/repro/kernels/sorted_stream.py:262",
                timing["paired_accum_matmul[8:16]"], policy="sorted_tiled",
                work=w_out + ", k_tile 256, the weight 8:16-pruned and "
                             "stored dense, as served",
                prefill=prefill_record(
                    timing["paired_accum_matmul[8:16] M=128"],
                    w_out.replace("decode (M=4)", "a prefill cohort "
                                  "(M=128)") + ", k_tile 256, 8:16-pruned")),
            path="phase 3c (two-pass pass 2 at K = 8960)"),
        kernel_record(
            "chunked_sort_matmul", csrc + "sort_matmul.cu",
            "src/repro/kernels/sorted_stream.py:372",
            timing["chunked_sort_matmul"], policy="sorted",
            work=w_out + ", sorted over kp 16384 (the tail past K "
                         "masked in the kernel)",
            launches=srt["chunked_sort_matmul"],
            max_abs_err=max(got["sort_err"]["chunked_sort_matmul"],
                            got["sorted_err"]["sort_matmul"]),
            by_kp=got["sorted_kp"]["chunked_sort_matmul"],
            path="phase 3d (two-pass at K = 8960)"),
    ]
    timing = got["nm_sort_timing"]
    tiled, srt = got["nm sorted_tiled"], got["nm sorted"]
    err = got["nm_sort_err"]
    nm8 = ", 8:16 compressed slabs"
    kernels += [
        kernel_record(
            "nm_gather_sort_matmul", csrc + "nm_sort_matmul.cu",
            "src/repro/kernels/nm_spmm.py:465",
            timing["nm_gather_sort_matmul"], policy="sorted_tiled",
            work=six + nm8 + ", k_tile 256",
            launches=tiled["nm_gather_sort_matmul"]
            + srt["nm_gather_sort_matmul"],
            launches_by_path={"sorted_tiled": tiled["nm_gather_sort_matmul"],
                              "sorted": srt["nm_gather_sort_matmul"]},
            max_abs_err=max(err["nm_gather_sort_matmul"],
                            got["sorted_err"]["nm_gather_sort_matmul"],
                            got["fault_err"]["nm_gather_sort_matmul"]),
            sorted_policy=kernel_record(
                "nm_gather_sort_matmul", csrc + "nm_sort_matmul.cu",
                "src/repro/kernels/nm_spmm.py:465",
                timing["nm_gather_sort_matmul[sorted]"], policy="sorted",
                work=six + nm8 + ", sorted over next_pow2(G n_keep) = 1024 "
                                 "kept keys",
                prefill=prefill_record(
                    timing["nm_gather_sort_matmul[sorted] M=128"],
                    six.replace("decode (M=4)", "a prefill cohort (M=128)")
                    + nm8 + ", 1024 kept keys")),
            path="phases 3e and 3f (one-pass at K = 1536)"),
        kernel_record(
            "nm_gather_tile_sums", csrc + "nm_sort_matmul.cu",
            "src/repro/kernels/sorted_stream.py:567",
            timing["nm_gather_tile_sums"], policy="sorted_tiled",
            work=w_out + nm8 + ", k_tile 256",
            launches=tiled["nm_gather_tile_sums"],
            max_abs_err=max(err["nm_gather_tile_sums"],
                            got["pass1_err"]["nm_gather_tile_sums"],
                            got["fault_err"]["nm_gather_tile_sums"]),
            **pass1_records("nm_gather_tile_sums",
                            csrc + "nm_sort_matmul.cu",
                            "src/repro/kernels/sorted_stream.py:567",
                            got["pass1_timing"],
                            w_out + nm8 + ", k_tile 256"),
            path="phase 3e (two-pass pass 1 at K = 8960)"),
        kernel_record(
            "nm_gather_paired_accum_matmul", csrc + "nm_sort_matmul.cu",
            "src/repro/kernels/sorted_stream.py:670",
            timing["nm_gather_paired_accum_matmul"], policy="sorted_tiled",
            work=w_out + nm8 + ", k_tile 256",
            launches=tiled["nm_gather_paired_accum_matmul"],
            max_abs_err=max(
                err["nm_gather_paired_accum_matmul"],
                got["fault_err"]["nm_gather_paired_accum_matmul"]),
            prefill=prefill_record(
                timing["nm_gather_paired_accum_matmul M=128"],
                w_out.replace("decode (M=4)", "a prefill cohort (M=128)")
                + nm8 + ", k_tile 256"),
            path="phase 3e (two-pass pass 2 at K = 8960)"),
        kernel_record(
            "nm_gather_chunked_sort_matmul", csrc + "nm_sort_matmul.cu",
            "src/repro/kernels/sorted_stream.py:735",
            timing["nm_gather_chunked_sort_matmul"], policy="sorted",
            work=w_out + nm8 + ", sorted over next_pow2(G n_keep) = 8192 "
                               "kept keys",
            launches=srt["nm_gather_chunked_sort_matmul"],
            max_abs_err=max(err["nm_gather_chunked_sort_matmul"],
                            got["sorted_err"]["nm_gather_sort_matmul"],
                            got["fault_err"]
                            ["nm_gather_chunked_sort_matmul"]),
            by_kp=got["sorted_kp"]["nm_gather_chunked_sort_matmul"],
            path="phase 3f (two-pass at K = 8960)"),
    ]
    tiled, srt = got["expand sorted_tiled"], got["expand sorted"]
    kernels += [
        kernel_record(
            "nm_sort_matmul", csrc + "nm_expand_sort.cu",
            "src/repro/kernels/nm_spmm.py:249",
            timing["nm_sort_matmul"], policy="sorted_tiled",
            work=six + nm8 + ", k_tile 256, each row expanded to its 1536 "
                             "dense positions",
            launches=tiled["nm_sort_matmul"] + srt["nm_sort_matmul"],
            launches_by_path={"sorted_tiled": tiled["nm_sort_matmul"],
                              "sorted": srt["nm_sort_matmul"]},
            max_abs_err=max(err["nm_sort_matmul"],
                            got["sorted_err"]["nm_sort_matmul"]),
            sorted_policy=kernel_record(
                "nm_sort_matmul", csrc + "nm_expand_sort.cu",
                "src/repro/kernels/nm_spmm.py:249",
                timing["nm_sort_matmul[sorted]"], policy="sorted",
                work=six + nm8 + ", sorted over kp 2048 expanded keys",
                prefill=prefill_record(
                    timing["nm_sort_matmul[sorted] M=128"],
                    six.replace("decode (M=4)", "a prefill cohort (M=128)")
                    + nm8 + ", kp 2048 expanded keys")),
            path="phases 3g and 3h (one-pass at K = 1536, "
                 "nm_impl='expand')"),
        kernel_record(
            "nm_tile_sums_matmul", csrc + "nm_expand_sort.cu",
            "src/repro/kernels/sorted_stream.py:164",
            timing["nm_tile_sums_matmul"], policy="sorted_tiled",
            work=w_out + nm8 + ", k_tile 256",
            launches=tiled["nm_tile_sums_matmul"],
            max_abs_err=max(err["nm_tile_sums_matmul"],
                            got["pass1_err"]["nm_tile_sums_matmul"]),
            **pass1_records("nm_tile_sums_matmul",
                            csrc + "nm_expand_sort.cu",
                            "src/repro/kernels/sorted_stream.py:164",
                            got["pass1_timing"],
                            w_out + nm8 + ", k_tile 256"),
            path="phase 3g (two-pass pass 1 at K = 8960)"),
        kernel_record(
            "nm_paired_accum_matmul", csrc + "nm_expand_pass2.cu",
            "src/repro/kernels/sorted_stream.py:305",
            timing["nm_paired_accum_matmul"], policy="sorted_tiled",
            work=w_out + nm8 + ", k_tile 256",
            launches=tiled["nm_paired_accum_matmul"],
            max_abs_err=err["nm_paired_accum_matmul"],
            prefill=prefill_record(
                timing["nm_paired_accum_matmul M=128"],
                w_out.replace("decode (M=4)", "a prefill cohort (M=128)")
                + nm8 + ", k_tile 256"),
            path="phase 3g (two-pass pass 2 at K = 8960)"),
        kernel_record(
            "nm_chunked_sort_matmul", csrc + "nm_expand_sort.cu",
            "src/repro/kernels/sorted_stream.py:431",
            timing["nm_chunked_sort_matmul"], policy="sorted",
            work=w_out + nm8 + ", sorted over kp 16384 expanded keys",
            launches=srt["nm_chunked_sort_matmul"],
            max_abs_err=max(err["nm_chunked_sort_matmul"],
                            got["sorted_err"]["nm_sort_matmul"]),
            by_kp=got["sorted_kp"]["nm_chunked_sort_matmul"],
            path="phase 3h (two-pass at K = 8960)"),
    ]
    timing, launches = got["wide_timing"], got["quickstart"]
    sites = "7 projection sites of one qwen2-1.5b layer"
    for name, replaces, weight in (
            ("quant_matmul", "src/repro/kernels/quant_matmul.py:50",
             "int8 (K, N) weights, as QTensor.values stores them"),
            ("nm_spmm", "src/repro/kernels/nm_spmm.py:113",
             "8:16 compressed slabs, expanded in shared memory")):
        kernels.append(kernel_record(
            name, csrc + "quant_matmul.cu", replaces, timing[(name, 128)],
            policy="wide", work=f"{sites} at a prefill cohort (M=128), "
                                f"{weight}",
            launches=launches[name],
            max_abs_err=max(got["wide_err"][name],
                            got["full_width_err"][name],
                            got["quickstart_err"][name],
                            got["qm_err"] if name == "quant_matmul" else 0),
            decode=kernel_record(
                name, csrc + "quant_matmul.cu", replaces, timing[(name, 4)],
                policy="wide", work=f"{sites} at decode (M=4), {weight}; "
                                    "torch._int_mm refuses M=4"),
            path="phase 4c, the torch quickstart (repro_torch.quickstart."
                 "run on the card)"))
    serve_s = {"3 sorted_tiled_seq": got["serve_s"],
               "3k wide, expand": got["expand wide s"]}
    for path, run in (("3l census-watched, dense", got["3l"]),
                      ("3m census-watched, compressed", got["3m"]),
                      ("3n certified", served["certified"]),
                      ("3n censused", served["censused"])):
        serve_s[path] = dict(per_step=run["per_step"],
                             prefill=run["prefill"])
    print(json.dumps({"guardrails": {
        "card": card, "s": serve_s,
        "census_per_2_decode_steps": {
            path: got[path]["profile"] for path in ("3l", "3m")},
        "degraded": {path: got[path]["degraded"] for path in ("3l", "3m")},
        "certify_host_s": got["3n"]["seconds"]}}))
    print(json.dumps({"paper": {
        "card": card,
        "nets": {name: {key: net[key] for key in (
            "fp32", "train_s", "epoch_s", "eval_s", "census_s",
            "launches_per_call")} | {"census": {str(b): c for b, c in
                                               net["census"].items()}}
            for name, net in paper["nets"].items()},
        "dots_held_against_plain": paper["dots"],
        "finetune": {k: v for k, v in got["finetune"].items()
                     if k != "census"}}}))
    print(json.dumps({"families": {
        "card": card,
        "7a gemma3-12b": {
            "layers": GEMMA3_LAYERS, "init_s": gemma3["init_s"],
            "checks_s": gemma3["checks_s"],
            "dots_held_against_plain": gemma3["plain_held"],
            **{storage: gemma3[storage] for storage in ("dense",
                                                        "compressed")}},
        "7b qwen3-32b": qwen3, "7c command-r-35b": command_r,
        **{name: {"layers": FAMILY8_LAYERS, **{
            k: v for k, v in run.items() if k != "sites"}}
           for name, run in (("8a granite-moe-3b", granite),
                             ("8b mamba2-2.7b", mamba))},
        "9a jamba-v0.1-52b": {"layers": JAMBA_LAYERS, **{
            k: v for k, v in jamba.items() if k != "sites"}},
        "9b whisper-medium": {k: v for k, v in whisper.items()
                              if k != "sites"},
        "9c qwen2-vl-72b": {"layers": QWEN2_VL_LAYERS, **{
            k: v for k, v in qwen2_vl.items() if k != "sites"}}}}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
