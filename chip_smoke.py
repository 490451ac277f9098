#!/usr/bin/env python3
"""Drive the PyTorch/H100 port of PQS on one NVIDIA card, end to end.

    python3 chip_smoke.py [--seed 0]

Run from the repository root; it needs one CUDA card and nvcc, and
imports nothing of JAX or of the JAX package. Phases:

1. the card (nvidia-smi name and power limit); build every CUDA kernel
   of the port from ``src/repro_torch/csrc`` (one nvcc each, in parallel)
   and print each kernel's registers and spills;
2. each kernel against its plain PyTorch version on the card, bit-exact,
   at the qwen2-1.5b projection shapes (seeded int8, near-extreme rows so
   a 16-bit register saturates), every policy, rounds 1 and 2: the dense
   ``seq_policy_matmul``, and the N:M ``nm_gather_seq_policy_matmul`` and
   ``nm_seq_policy_matmul`` on 8:16 slabs (plus ragged 3:16 and 2:4
   cases), which must also equal the dense kernel on the decompressed
   weight;
3. serve full-width qwen2-1.5b (28 layers, random seeded weights, 8:16
   pruned int8, sorted_tiled_seq at 16 bits, k_tile 256) through
   ``ServingEngine`` from dense int8 storage: 4 greedy requests, 16 new
   tokens each; the launch counts show every integer projection went
   through the dense kernel; then a profiler window of two more decode
   steps (device time by kernel, host time by operator) and the time of
   the tied head's dequantize;
3b. the same model served from N:M compressed storage
   (``nm_compress_tree``): every projection through the gather kernel,
   none through the dense one, and the same tokens as phase 3;
4. the same engine at 2 layers, full width: the dense kernel and its
   plain version, and the compressed weights through the gather and the
   expand kernel (the expand kernel's path), give identical tokens and
   decode logits;
5. kernel times at the decode shapes (CUDA events, L2 flushed before
   each launch), beside the plain versions, ``torch._int_mm`` and, for
   the N:M kernels, the dense kernel on the same dot.

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


def nm_operands(torch, m, n, k, seed, n_keep=N_KEEP, m_group=M_GROUP):
    """``operands`` with the weight pruned n_keep:m_group and compressed:
    x, the dense pruned w, values, indices."""
    from repro_torch.core.pruning import nm_compress, nm_prune_mask

    x, w = operands(torch, m, n, k, seed)
    kp = k + (-k) % m_group
    wp = torch.nn.functional.pad(w, (0, kp - k)).float()
    w = (wp * nm_prune_mask(wp, n_keep, m_group))[:, :k].to(torch.int8)
    vals, idx = nm_compress(w, n_keep, m_group)
    return x, w, vals.contiguous(), idx.contiguous()


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


def phase_nm_kernels(torch, sm, nm, seed):
    """Both N:M kernels vs their plain versions, bit-exact, and vs the
    dense kernel on the decompressed weight. Returns the max |difference|
    of each kernel against its plain version."""
    cases = [(4, n, k, N_KEEP, M_GROUP) for (n, k) in SHAPES] + [
        (64, 256, 1536, N_KEEP, M_GROUP), (5, 70, 300, 3, 16),
        (5, 70, 300, 2, 4)]
    kernels = {"nm_gather_seq_policy_matmul": (
        nm.nm_gather_seq_policy_matmul, nm.nm_gather_seq_policy_matmul_ref),
        "nm_seq_policy_matmul": (nm.nm_seq_policy_matmul,
                                 nm.nm_seq_policy_matmul_ref)}
    worst = dict.fromkeys(kernels, 0)
    cross = 0
    for i, (m, n, k, n_keep, m_group) in enumerate(cases):
        x, w, vals, idx = nm_operands(torch, m, n, k, seed + 50 + i, n_keep,
                                      m_group)
        for policy in sm.SEQ_POLICIES:
            for rounds in ((1, 2) if policy == "sorted_tiled_seq" else (1,)):
                kw = dict(policy=policy, acc_bits=16, rounds=rounds,
                          k_tile=256)
                dense = sm.seq_policy_matmul(x, w, **kw)
                errs = []
                for name, (kernel, plain) in kernels.items():
                    got = kernel(x, vals, idx, m_group=m_group, **kw)
                    want = plain(x, vals, idx, m_group=m_group, **kw)
                    torch.cuda.synchronize()
                    err = int((got.long() - want.long()).abs().max())
                    worst[name] = max(worst[name], err)
                    cross = max(cross, int((got.long() - dense.long())
                                           .abs().max()))
                    errs.append(err)
                print(f"  nm kernels/plain M={m:3d} N={n:5d} K={k:5d} "
                      f"{n_keep}:{m_group} {policy:16s} rounds={rounds} "
                      f"max|diff| gather={errs[0]} expand={errs[1]}; "
                      f"vs dense kernel {cross}", flush=True)
    if any(worst.values()) or cross:
        raise AssertionError(f"N:M kernels disagree: {worst}, vs dense "
                             f"{cross}")
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
          nm_impl=None):
    """Build, quantize (and compress) and serve 4 greedy requests. Returns
    (requests, engine, seconds of step 1 (admission, prefill, first
    decode), seconds of the later decode steps)."""
    from repro_torch.core.dispatch import IntegerLinConfig
    from repro_torch.serving import Request, ServingEngine

    model, params = model_params(cfg, seed, compressed)
    torch.cuda.empty_cache()
    eng = ServingEngine(model, params, num_slots=4, max_len=128,
                        int_lin=IntegerLinConfig(backend=backend,
                                                 nm_impl=nm_impl))
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


def reset(counters):
    for fn in counters.values():
        fn.launches = 0


def phase_serve(torch, counters, cfg, seed, compressed, want_tokens=None):
    """Serve the full-width model (dense or compressed storage) with every
    launch count set to 0 just before and read just after. The dense
    storage must go through ``seq_policy_matmul`` only, the compressed
    storage through ``nm_gather_seq_policy_matmul`` only (and give
    ``want_tokens``). Returns (launches by kernel, decode steps, tokens)."""
    kernel = "nm_gather_seq_policy_matmul" if compressed else \
        "seq_policy_matmul"
    reset(counters)
    reqs, eng, t_first, t_rest = serve(torch, cfg, seed,
                                       compressed=compressed)
    launches = {name: fn.launches for name, fn in counters.items()}
    steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
    need = len(SITES) * cfg.num_layers * steps
    decode_steps = eng.stats["decode_steps"]
    per_step = t_rest / max(decode_steps - 1, 1)
    tokens = sum(len(r.output) for r in reqs)
    print(f"  served {len(reqs)} requests, {tokens} tokens from "
          f"{'compressed' if compressed else 'dense'} storage: prefill "
          f"steps {eng.stats['prefill_steps']}, decode steps "
          f"{decode_steps}", flush=True)
    print(f"  step 1 (prefill + first decode) {t_first:.3f} s; later decode "
          f"{t_rest:.3f} s over {decode_steps - 1} steps = {per_step:.4f} "
          f"s/step; prefill alone ~ {t_first - per_step:.3f} s", flush=True)
    print(f"  decode throughput {4 * (decode_steps - 1) / t_rest:.2f} "
          f"tokens/s (4 slots); end to end {tokens / (t_first + t_rest):.2f}"
          f" generated tokens/s", flush=True)
    print(f"  launches {launches} (need {kernel} >= {need} = {len(SITES)} "
          f"sites x {cfg.num_layers} layers x {steps} steps, the others 0)",
          flush=True)
    for r in reqs:
        if not r.done or len(r.output) != 16:
            raise AssertionError(f"request {r.uid} incomplete: {r.output}")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token out of range")
    if launches[kernel] < need:
        raise AssertionError(f"{launches[kernel]} {kernel} launches < "
                             f"{need}")
    if any(n for name, n in launches.items() if name != kernel):
        raise AssertionError(f"another kernel ran on this path: {launches}")
    outputs = [r.output for r in reqs]
    print(f"  request 0 tokens {outputs[0]}", flush=True)
    if want_tokens is not None:
        if outputs != want_tokens:
            raise AssertionError(f"compressed tokens {outputs} differ from "
                                 f"the dense tokens {want_tokens}")
        print("  tokens identical to the dense storage's", flush=True)
    profile_decode(torch, eng, cfg.vocab_size)
    return launches, decode_steps, outputs


def profile_decode(torch, eng, vocab):
    """Device time by kernel and host time by operator over two decode
    steps of the served model (after the counted run), the device's busy
    share of the wall, and the tied head's dequantize alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.qtensor import asarray
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
    # the host side: operators and CUDA runtime calls by self CPU time
    # (inflated by the profiler's own cost per operator)
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    print(f"  host: {sum(e.count for e in host)} calls, "
          f"{sum(e.self_cpu_time_total for e in host) / 1e3:.1f} ms self "
          f"CPU time; the largest:", flush=True)
    for e in host[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}", flush=True)
    emb = eng.params["embed"]  # the tied head dequantizes it every step
    t0 = time.perf_counter()
    for _ in range(3):
        asarray(emb, torch.bfloat16)
    torch.cuda.synchronize()
    print(f"  tied head dequantize ({type(emb).__name__}): "
          f"{(time.perf_counter() - t0) / 3 * 1e3:.2f} ms (host clock to "
          f"synchronize, mean of 3)", flush=True)
    while eng.step():
        pass


def phase_parity(torch, counters, cfg, seed):
    """2 layers at full width: the dense kernel and its plain version, and
    the compressed weights through the gather and the expand kernel, give
    the same tokens and decode logits. The expand serve is that kernel's
    path: its counts are set to 0 just before and read just after. Returns
    the expand kernel's launches in it."""
    from repro_torch.core import dispatch
    from repro_torch.core.qtensor import nm_compress_tree

    cfg2 = dataclasses.replace(cfg, num_layers=2)
    outs = {}
    expand_launches = None
    for name, kw in (("cuda", dict(backend="cuda")),
                     ("torch", dict(backend="torch")),
                     ("gather", dict(compressed=True, nm_impl="gather")),
                     ("expand", dict(compressed=True, nm_impl="expand"))):
        reset(counters)
        t0 = time.perf_counter()
        reqs, eng, _, _ = serve(torch, cfg2, seed, **kw)
        outs[name] = [r.output for r in reqs]
        print(f"  2-layer serve, {name}: {time.perf_counter() - t0:.1f} s; "
              f"launches {dict((k, f.launches) for k, f in counters.items())}",
              flush=True)
        if name == "expand":
            steps = eng.stats["prefill_steps"] + eng.stats["decode_steps"]
            need = len(SITES) * cfg2.num_layers * steps
            expand_launches = counters["nm_seq_policy_matmul"].launches
            if expand_launches < need or counters[
                    "nm_gather_seq_policy_matmul"].launches:
                raise AssertionError(f"expand path: {expand_launches} "
                                     f"launches < {need}, or gather ran")
    if any(o != outs["cuda"] for o in outs.values()):
        raise AssertionError(f"tokens differ: {outs}")
    # logits of one decode after a prefill
    model, params = model_params(cfg2, seed, compressed=False)
    sparse = nm_compress_tree(params, N_KEEP, M_GROUP)
    toks = torch.tensor([p[:16].tolist() for p in prompts(4, seed,
                                                          cfg.vocab_size)],
                        device="cuda", dtype=torch.int32)
    lengths = torch.full((4,), 16, device="cuda", dtype=torch.int32)
    logits = {}
    for name, p, kw in (("cuda", params, dict(backend="cuda")),
                        ("torch", params, dict(backend="torch")),
                        ("gather", sparse, dict(nm_impl="gather")),
                        ("expand", sparse, dict(nm_impl="expand"))):
        caches = model.init_caches(p, 4, 32, torch.float32)
        with torch.no_grad(), dispatch.integer_lin(
                dispatch.IntegerLinConfig(**kw)):
            _, caches = model.prefill(p, toks, caches, lengths)
            logits[name], _ = model.decode(p, toks[:, -1:], caches)
    ref = logits["cuda"].float()
    finite = bool(torch.isfinite(ref).all())
    diffs = {name: float((lg.float() - ref).abs().max())
             for name, lg in logits.items()}
    print(f"  decode logits {tuple(ref.shape)}: max |x - dense kernel| = "
          f"{diffs}, finite={finite}", flush=True)
    if any(diffs.values()) or not finite:
        raise AssertionError("logits differ or are not finite")
    return expand_launches


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


def phase_nm_timing(torch, sm, nm):
    """Both N:M kernels at the decode shapes (M = 4) of the 7 sites, 8:16
    sorted_tiled_seq, beside their plain versions and the dense kernel on
    the decompressed weight. The bound counts the compressed bytes: x,
    int8 values, int32 indices and the int32 out; the operations are the
    kept products."""
    flush_buf = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    kw = dict(policy="sorted_tiled_seq", acc_bits=16, rounds=1, k_tile=256)
    table = {"nm_gather_seq_policy_matmul": [], "nm_seq_policy_matmul": []}
    m = 4
    for name, (n, k) in SITES.items():
        x, w, vals, idx = nm_operands(torch, m, n, k, 9)
        kept = vals.numel()
        bytes_ms = (m * k + 5 * kept + 4 * m * n) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * m * kept / INT8_OPS_PER_S * 1e3
        dense = time_launches(torch, lambda: sm.seq_policy_matmul(x, w, **kw),
                              10, flush_buf)
        line = [f"  time nm {name:6s} M={m} N={n:5d} K={k:5d}"]
        for kname, fn, ref in (
                ("nm_gather_seq_policy_matmul", nm.nm_gather_seq_policy_matmul,
                 nm.nm_gather_seq_policy_matmul_ref),
                ("nm_seq_policy_matmul", nm.nm_seq_policy_matmul,
                 nm.nm_seq_policy_matmul_ref)):
            ms = time_launches(torch, lambda: fn(x, vals, idx, m_group=M_GROUP,
                                                 **kw), 10, flush_buf)
            plain = time_launches(torch, lambda: ref(
                x, vals, idx, m_group=M_GROUP, **kw), 1, flush_buf)
            table[kname].append(dict(ms=ms, plain_ms=plain,
                                     bound_ms=max(bytes_ms, ops_ms),
                                     bytes_ms=bytes_ms, ops_ms=ops_ms))
            line.append(f"{kname.split('_seq')[0]} {ms:.4f} ms (plain "
                        f"{plain:.2f} ms)")
        line.append(f"dense kernel {dense:.4f} ms  bound "
                    f"{max(bytes_ms, ops_ms):.5f} ms")
        print("  ".join(line), flush=True)
    return table


def kernel_record(name, source, replaces, rows, **extra):
    """One entry of the ``kernels`` line: sums over the 7 decode sites."""
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        policy="sorted_tiled_seq",
        work="7 projection sites of one qwen2-1.5b layer at decode (M=4), "
             "acc_bits 16, k_tile 256",
        ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by="bytes" if total["bytes_ms"] >= total["ops_ms"]
        else "operations",
        # no one PyTorch call computes the sorted 16-bit register; the
        # wide policy's torch._int_mm times are printed in phase 5
        library_ms=None, **extra)


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
    from repro_torch.kernels import nm_spmm as nm
    from repro_torch.kernels import sorted_matmul as sm

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

    cfg = get_config("qwen2-1.5b")
    counters = {"seq_policy_matmul": sm.seq_policy_matmul,
                "nm_gather_seq_policy_matmul": nm.nm_gather_seq_policy_matmul,
                "nm_seq_policy_matmul": nm.nm_seq_policy_matmul}
    got = {}  # what each phase measured, for the kernels line

    def dense_serve():
        got["launches"], _, got["tokens"] = phase_serve(
            torch, counters, cfg, args.seed, compressed=False)

    def nm_serve():
        got["nm_launches"] = phase_serve(
            torch, counters, cfg, args.seed, compressed=True,
            want_tokens=got.get("tokens"))[0]
        if "tokens" not in got:
            raise AssertionError("no dense tokens to compare: phase 3 failed")

    phases = [
        ("[2] kernel vs plain", lambda: got.update(
            err=phase_kernels(torch, sm, args.seed),
            nm_err=phase_nm_kernels(torch, sm, nm, args.seed))),
        ("[3] serve qwen2-1.5b", dense_serve),
        ("[3b] serve qwen2-1.5b from N:M compressed storage", nm_serve),
        ("[4] kernel vs plain serving, dense and compressed", lambda:
            got.update(expand_launches=phase_parity(torch, counters, cfg,
                                                    args.seed))),
        ("[5] timing", lambda: got.update(
            timing=phase_timing(torch, sm),
            nm_timing=phase_nm_timing(torch, sm, nm))),
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
    csrc = "src/repro_torch/csrc/"
    kernels = [
        kernel_record(
            "seq_policy_matmul", csrc + "seq_policy_matmul.cu",
            "src/repro/kernels/sorted_matmul.py:155",
            got["timing"]["sorted_tiled_seq"],
            launches=got["launches"]["seq_policy_matmul"],
            max_abs_err=got["err"], path="phase 3, dense storage"),
        kernel_record(
            "nm_gather_seq_policy_matmul", csrc + "nm_seq_policy_matmul.cu",
            "src/repro/kernels/nm_spmm.py:381",
            got["nm_timing"]["nm_gather_seq_policy_matmul"],
            launches=got["nm_launches"]["nm_gather_seq_policy_matmul"],
            max_abs_err=got["nm_err"]["nm_gather_seq_policy_matmul"],
            path="phase 3b, compressed storage"),
        kernel_record(
            "nm_seq_policy_matmul", csrc + "nm_seq_policy_matmul.cu",
            "src/repro/kernels/nm_spmm.py:182",
            got["nm_timing"]["nm_seq_policy_matmul"],
            launches=got["expand_launches"],
            max_abs_err=got["nm_err"]["nm_seq_policy_matmul"],
            path="phase 4, compressed storage with nm_impl='expand' "
                 "(2 layers)"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
