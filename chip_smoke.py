#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of PQS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0]

Run from the repository root; it needs one CUDA card and nvcc, and
imports nothing of JAX or of the JAX package. Phases:

1. the card (nvidia-smi name and power limit); build every CUDA kernel
   of the port from ``src/repro_torch/csrc`` (one nvcc each, in parallel);
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the qwen2-1.5b projection shapes (seeded int8, near-extreme rows so
   a 16-bit register saturates), every policy, rounds 1 and 2;
3. serve full-width qwen2-1.5b (28 layers, random seeded weights, 8:16
   pruned int8, sorted_tiled_seq at 16 bits, k_tile 256) through
   ``ServingEngine``: 4 greedy requests, 16 new tokens each; the launch
   counts show every integer projection went through the kernel; then a
   profiler window of two more decode steps (device time by kernel);
4. the same engine at 2 layers, full width, served once with the kernel
   and once with the plain version: identical tokens and logits;
5. kernel times at the decode shapes (CUDA events, L2 flushed before
   each launch), beside the plain version and ``torch._int_mm``.

The last three lines are a JSON ``kernels`` record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``. Any failed phase
exits non-zero without that last line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak
# (N, K) of the qwen2-1.5b projections: wq/wo, wk/wv, w_gate/w_up, w_out
SITES = {"wq": (1536, 1536), "wk": (256, 1536), "wv": (256, 1536),
         "wo": (1536, 1536), "w_gate": (8960, 1536), "w_up": (8960, 1536),
         "w_out": (1536, 8960)}
SHAPES = sorted(set(SITES.values()))


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


def phase_kernels(torch, sm, seed):
    """Kernel vs plain version, bit-exact. Returns the max |difference|."""
    cases = [(m, n, k) for (n, k) in SHAPES for m in (4, 64)] + [(5, 70, 300)]
    worst = 0
    for i, (m, n, k) in enumerate(cases):
        x, w = operands(torch, m, n, k, seed + i)
        for policy in sm.SEQ_POLICIES:
            for rounds in ((1, 2) if policy == "sorted_tiled_seq" else (1,)):
                kw = dict(policy=policy, acc_bits=16, rounds=rounds,
                          k_tile=256)
                got = sm.seq_policy_matmul(x, w, **kw)
                want = sm.seq_policy_matmul_ref(x, w, **kw)
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                # share of outputs at or past the 16-bit register's edge
                edge = float((want.abs() >= 32767).float().mean())
                worst = max(worst, err)
                print(f"  kernel/plain M={m:3d} N={n:5d} K={k:5d} "
                      f"{policy:16s} rounds={rounds} max|diff|={err} "
                      f"at-16-bit-edge={edge:.3f}", flush=True)
    if worst:
        raise AssertionError(f"kernel disagrees with its plain version "
                             f"(max |diff| {worst})")
    return worst


def prompts(n, seed, vocab):
    import numpy as np

    r = np.random.default_rng(seed)
    return [r.integers(0, vocab, size=int(r.integers(20, 33))).astype(
        np.int32) for _ in range(n)]


def serve(torch, cfg, seed, backend=None, new_tokens=16):
    """Build, quantize and serve 4 greedy requests. Returns (requests,
    engine, seconds of step 1 (admission, prefill, first decode), seconds
    of the later decode steps)."""
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.core.qtensor import quantize_tree
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine

    model = build_model(cfg)
    params = quantize_tree(model.init(seed), bits=8, n_keep=8, m=16)
    torch.cuda.empty_cache()
    eng = ServingEngine(model, params, num_slots=4, max_len=128,
                        int_lin=IntegerLinConfig(backend=backend))
    reqs = [Request(uid=i, prompt=p, max_new_tokens=new_tokens)
            for i, p in enumerate(prompts(4, seed, cfg.vocab_size))]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    while eng.step():
        pass
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return reqs, eng, t1 - t0, t2 - t1


def phase_serve(torch, sm, cfg, seed):
    sm.seq_policy_matmul.launches = 0
    reqs, eng, t_first, t_rest = serve(torch, cfg, seed)
    launches = sm.seq_policy_matmul.launches
    steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    need = len(SITES) * cfg.num_layers * steps
    decode_steps = eng.stats["decode_steps"]
    per_step = t_rest / max(decode_steps - 1, 1)
    tokens = sum(len(r.output) for r in reqs)
    print(f"  served {len(reqs)} requests, {tokens} tokens: "
          f"prefill steps {eng.stats['prefill_steps']}, decode steps "
          f"{decode_steps}", flush=True)
    print(f"  step 1 (prefill + first decode) {t_first:.3f} s; later decode "
          f"{t_rest:.3f} s over {decode_steps - 1} steps = {per_step:.4f} "
          f"s/step; prefill alone ~ {t_first - per_step:.3f} s", flush=True)
    print(f"  decode throughput {4 * (decode_steps - 1) / t_rest:.2f} "
          f"tokens/s (4 slots); end to end {tokens / (t_first + t_rest):.2f}"
          f" generated tokens/s", flush=True)
    print(f"  seq_policy_matmul launches {launches} (>= {need} = "
          f"{len(SITES)} sites x {cfg.num_layers} layers x {steps} steps)",
          flush=True)
    for r in reqs:
        if not r.done or len(r.output) != 16:
            raise AssertionError(f"request {r.uid} incomplete: {r.output}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of range")
    if launches < need:
        raise AssertionError(f"{launches} kernel launches < {need}")
    print(f"  request 0 tokens {reqs[0].output}", flush=True)
    profile_decode(torch, eng, cfg.vocab_size)
    return launches, decode_steps


def profile_decode(torch, eng, vocab):
    """Device time by kernel over two decode steps of the served model
    (after the counted run), and the device's busy share of the wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import Request

    for i, p in enumerate(prompts(4, 1, vocab)):
        eng.submit(Request(uid=100 + i, prompt=p, max_new_tokens=4))
    eng.step()  # admission, prefill and the first decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step()
        eng.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(
            e, "self_cuda_time_total", 0)

    # kernel rows only: operator rows repeat their kernels' device time
    events = sorted((e for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA),
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
    while eng.step():
        pass


def phase_parity(torch, cfg, seed):
    """2 layers at full width: kernel vs plain backend, same tokens and
    logits."""
    from repro_torch.core import dispatch

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    outs = {}
    for backend in ("cuda", "torch"):
        t0 = time.perf_counter()
        reqs, _, _, _ = serve(torch, cfg2, seed, backend=backend)
        outs[backend] = [r.output for r in reqs]
        print(f"  2-layer serve, backend={backend}: "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    if outs["cuda"] != outs["torch"]:
        raise AssertionError(f"tokens differ: {outs}")
    # logits of one decode after a prefill, both backends
    from repro_torch.core.qtensor import quantize_tree
    from repro_torch.models.model import build_model

    model = build_model(cfg2)
    params = quantize_tree(model.init(seed), bits=8, n_keep=8, m=16)
    toks = torch.tensor([p[:16].tolist() for p in prompts(4, seed,
                                                          cfg.vocab_size)],
                        device="cuda", dtype=torch.int32)
    lengths = torch.full((4,), 16, device="cuda", dtype=torch.int32)
    logits = {}
    for backend in ("cuda", "torch"):
        caches = model.init_caches(params, 4, 32, torch.float32)
        with torch.no_grad(), dispatch.integer_lin(
                dispatch.IntegerLinConfig(backend=backend)):
            _, caches = model.prefill(params, toks, caches, lengths)
            logits[backend], _ = model.decode(params, toks[:, -1:], caches)
    diff = float((logits["cuda"].float() - logits["torch"].float()).abs().max())
    finite = bool(torch.isfinite(logits["cuda"].float()).all())
    print(f"  decode logits {tuple(logits['cuda'].shape)}: max |kernel - "
          f"plain| = {diff}, finite={finite}", flush=True)
    if diff != 0.0 or not finite:
        raise AssertionError("kernel and plain logits differ or not finite")


def time_launches(torch, fn, iters, flush_buf):
    """Mean ms of ``fn`` over ``iters`` launches, each timed alone by CUDA
    events after the L2 cache is overwritten (the decode path finds the
    weights cold)."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush_buf.add_(1)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def phase_timing(torch, sm):
    """Kernel, plain and library times at the decode shapes (M = 4) for
    the 7 sites of one layer; the main path's policy is the record."""
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
            lib = None
            if policy == "wide":
                try:
                    lib = time_launches(torch, lambda: torch._int_mm(x, w.t()),
                                        10, flush_buf)
                except RuntimeError as exc:  # refused shape: report it
                    lib = f"refused: {str(exc).splitlines()[0][:100]}"
            bytes_ms = (m * k + n * k + 4 * m * n) / HBM_BYTES_PER_S * 1e3
            ops_ms = 2 * m * n * k / INT8_OPS_PER_S * 1e3
            bound = max(bytes_ms, ops_ms)
            rows.append(dict(ms=ms, plain_ms=plain, bound_ms=bound,
                             bytes_ms=bytes_ms, ops_ms=ops_ms))
            print(f"  time {policy:16s} {name:6s} M={m} N={n:5d} K={k:5d} "
                  f"kernel {ms:.4f} ms  plain {plain:.2f} ms  bound "
                  f"{bound:.5f} ms" + (f"  _int_mm {lib}" if lib else ""),
                  flush=True)
        table[policy] = rows
    # wide at a prefill-sized M, where _int_mm takes the shape
    for n, k in SHAPES:
        x, w = operands(torch, 64, n, k, 8)
        ms = time_launches(torch, lambda: sm.seq_policy_matmul(
            x, w, policy="wide"), 10, flush_buf)
        try:
            lib = f"{time_launches(torch, lambda: torch._int_mm(x, w.t()), 10, flush_buf):.4f} ms"
        except RuntimeError as exc:
            lib = f"refused: {str(exc).splitlines()[0][:100]}"
        print(f"  time wide M=64 N={n:5d} K={k:5d} kernel {ms:.4f} ms  "
              f"_int_mm {lib}", flush=True)
    return table


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import sorted_matmul as sm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    failures = []
    print(f"[1] card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.build_all()
    print(f"[1] built {len(build.SOURCES)} kernel source(s) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, info in build.BUILD_INFO.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    cfg = get_config("qwen2-1.5b")
    record = {"name": "seq_policy_matmul", "route": "cuda",
              "source": "src/repro_torch/csrc/seq_policy_matmul.cu",
              "replaces": "src/repro/kernels/sorted_matmul.py:155",
              "policy": "sorted_tiled_seq",
              "work": "7 projection sites of one qwen2-1.5b layer at decode "
                      "(M=4), acc_bits 16, k_tile 256"}
    phases = [
        ("[2] kernel vs plain", lambda: record.update(
            max_abs_err=phase_kernels(torch, sm, args.seed))),
        ("[3] serve qwen2-1.5b", lambda: record.update(
            launches=phase_serve(torch, sm, cfg, args.seed)[0])),
        ("[4] kernel vs plain serving", lambda: phase_parity(
            torch, cfg, args.seed)),
        ("[5] timing", lambda: record.update(
            timing=phase_timing(torch, sm))),
    ]
    for title, fn in phases:
        print(title, flush=True)
        t = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, fail at the end
            traceback.print_exc()
            failures.append(title)
        print(f"{title} done in {time.perf_counter() - t:.1f} s", flush=True)
    if failures:
        print(f"chip_smoke: failed phases: {failures}", file=sys.stderr)
        return 1
    rows = record.pop("timing")["sorted_tiled_seq"]
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    record.update(
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by="bytes" if total["bytes_ms"] >= total["ops_ms"]
        else "operations",
        # no one PyTorch call computes the sorted 16-bit register; the
        # wide policy's torch._int_mm times are printed in phase 5
        library_ms=None)
    print(json.dumps({"kernels": [record]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
