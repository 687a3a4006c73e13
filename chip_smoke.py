"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device  — the card's name, count and power limit; which optional
   packages this machine has (for planning later slices);
2. build   — nvcc builds every kernel library from localai_tpu_torch/csrc
   (one process per source, all at once) and prints what ptxas reports
   (registers and spills of every kernel); a spill in B2's, B3's, B4's or
   B5's tensor-core instances fails the run;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with CUDA-event times of the kernel, the
   plain version, one PyTorch library call computing the same function
   (where one exists), and the least time the card could take (bound):
   B1 flash prefill at the admission shapes (ragged lengths, every row at
   full length, and S = 200; every output bit-identical when launched
   again and for each batch row alone), B2 ragged paged attention at
   the paged decode and chunked-prefill shapes, on fp8 pools with a
   per-head kv_scale, at G = 7, on pages of 16 and 48 rows with limits at
   split edges, and for a 4-token verify (every output bit-identical when
   launched again and for each slot alone); then B2's long-context forms,
   a hierarchical table (table pages of 128) under the sink 128 + window
   4096 skip, at llama-3.2-1b's decode shape for contexts up to 131072, a
   512-token chunk at offset 65536 and one slot at a 1,048,576-token
   limit whose pool holds only the pages it visits: hierarchical equal to
   flat and a spilled table (skipped columns at SCRATCH) equal to the hot
   one bit for bit, timed beside the same slots walked in full; B3 dequant-matmul at llama-3-8b's projection shapes
   (flat int8, grouped int8, packed int4; bf16 and f32 x; 1, 8, 16, 64 and
   256 rows; every output bit-identical when launched again, and up to 16
   rows for each row alone) and B4 int8 unembed at llama-3-8b's head and a
   ragged one (bf16 and f32 h; 1, 8, 16, 64 and 256 rows; bit-identical
   when launched again, and up to 16 bf16 rows for each row alone), with
   the time of a bf16 matmul on the dequantized weight beside them, and
   for B3 the time of the dequantize-then-matmul route at the same rows;
4. model   — a small f32 model on the card against the same model on the
   CPU (logits, 16 greedy decode steps), dense and paged (chunked prefill
   into pages, paged decode), then full-width llama-3.2-1b in bf16 with
   seeded random weights, cut to 8 of its 16 layers for phases 4-6:
   prefill logits through the kernel against the same call through plain
   attention;
5. engine  — the dense serving engine (submit → fused admission → decode
   blocks → streamed events) answers mixed requests on llama-3.2-1b
   (8 layers);
6. paged engine — the same model on a paged KV pool with chunked prefill
   (long prompts chunk, decode blocks run between chunks), then the small
   f32 model's paged engine against its dense engine;
7. quantized model — llama-3-8b at full width and depth, seeded random
   bf16 weights quantized on the card to int8 and to int4: prefill at 256
   rows (the kernels' route) and 1024 rows (the dequantize-then-matmul
   route) and 16 greedy decode steps, against the same weights through the
   dequantize-then-matmul route everywhere;
8. quantized engines — llama-3-8b int8 on a paged bf16 pool, then int4 on
   an fp8 (e4m3) pool with kv_scale 2, with phase 6's mix of prompts; then
   the small f32 model's int4 + fp8 paged engine on the card against the
   same engine on the CPU;
9. lora kernels — B5 (the ragged LoRA delta) against its plain version at
   every target projection shape of llama-3.2-1b and llama-3-8b, rank 16
   and 64, 8 adapters and a null row, 1 and 256 rows, mixed ranks, and as
   one launch per group of targets that share x at the served groups
   (1b q / k / v and gate / up at rank 32, 8b q / v at rank 16): null
   rows exact zeros, every row bit-identical to a launch on it alone, two
   launches bit-identical, nothing allocated but the outputs;
10. lora http — llama-3.2-1b (16 layers, bf16) served by the port's own
   HTTP server with 8 virtual-model tenants (PEFT adapters from a seed):
   a warm pass, then 12 concurrent chat / completion requests (half
   streamed, half greedy) to the tenants and the base, checked over HTTP
   (B5 launches = decode steps x layers x 4 groups);
   then the same 12 to a base with no tenants (the tenancy cost);
11. lora 8b int8 — llama-3-8b int8 with 4 tenants and 4 adapter-less
   requests through Engine.submit (B1, B2, B3, B4 and B5 on one path);
   then the small f32 model's paged engine with three tenants and a null
   row on the card against the same engine on the CPU;
12. graphs — the decode block as one CUDA graph per shape: the paged
   engine of phase 6 (llama-3.2-1b, 8 layers; run right after phase 6)
   and of phase 8 (llama-3-8b int4 + fp8, all 32 layers; right after
   phase 8) each serve phase 6's requests twice on fresh engines, after
   warmup(): once replaying the graphs warmup captured, once with the
   engine's graph step swapped for its eager block body. Ids (greedy and
   seeded) and kernel launch counts must be identical; the phase prints
   the graphs captured, the capture seconds, the graph pool's bytes and
   both runs' decode tok/s and host ms per step.
13. moe kernels — B3's expert form (every expert of a mixture-of-experts
   projection in one launch) against its plain version at mixtral-8x7b's
   shapes: gate / up [8, 4096, 14336] with x shared by the experts, down
   [8, 14336, 4096] with one x row per expert; flat int8, grouped int8
   and int4; bf16 and f32 x; 1, 8, 16, 64 and 256 rows; bit-identical when
   launched again and, up to 16 rows, for each row alone; times beside a
   bf16 torch.bmm on the dequantized stack and the dequantize-then-matmul
   route;
14. mixtral — mixtral-8x7b at full width and depth (32 layers), seeded
   random weights made int4 on the card layer by layer (bf16 would not
   fit): a 256-row prefill through the kernels, each of its 32 MoE layers
   held to the dequantize-then-matmul route on the same input (within 5 %
   of the layer's largest output; the two free-running prefills' logits
   and the share of tokens whose top-2 experts differ, layer by layer,
   are printed: routing is discrete, so bf16 rounding flips some tokens'
   experts and the runs part), then phase 12's graph-against-eager run on
   a paged bf16 pool with phase 6's requests (B3 = 7 x 32 = 224 launches a decode step,
   96 of them the expert form; B4 one a step; B2 32 a step), the device
   time of one decode step (a graph replay) against the weights' byte
   floor, two admissions' times, the weight bytes and the peak memory;
15. mixtral int8 — the same model in int8 at full width, 8 of its 32
   layers (cut for time), through the paged engine: the flat form;
16. moe small — a small f32 mixtral-family model's paged engine on the
   card against the same engine on the CPU, unquantized (the exact top-k
   route) and int4 (the expert form's f32 kernel);
17. long context (run right after phase 12's 1b pair) — llama-3.2-1b at
   full width and depth (16 layers, bf16) serves one 130,000-token prompt
   and 32 greedy tokens through Engine.submit, after warmup(), on the
   reference ladder's long-context engine (pages of 128, chunks of 512,
   sink 128, window 4096): first with flat tables and every page hot,
   then with table pages of 128 entries and a 2 GiB cold-page spill
   budget. The ids must be identical and pages must spill within the
   budget; the phase prints the device ms of each prefill chunk along the
   prompt, the TTFT, decode tok/s, peak memory and the pages spilled.
In 5, 6, 8, 10, 11, 12, 14, 15 and 17 the kernel launch counters, zeroed just
before each run, show that the path went through the kernels; a graph
replay counts the launches its capture recorded. Every decode block of
those runs is a graph capture or replay (the eager runs of phases 12 and
14 aside).

The last lines are the kernels' JSON record, the card's `nvidia-smi` name
and power limit, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# The card's published peaks (H100 SXM data sheet, dense): bf16 tensor-core
# rate, f32 rate outside the tensor cores, HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def log(*args) -> None:
    print(*args, flush=True)


def cuda_time_cold_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over `reps` calls by CUDA events, with the
    50 MB L2 cache flushed before each call (the serving path reads each
    layer's pages once per step, so it finds them cold). A device-side spin
    queued first lets the host enqueue the flush, the events and the call
    before the device reaches them, so host launch overhead stays out."""
    flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda._sleep(2_000_000)  # about a millisecond of device time
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def swapped(module, name: str, fn):
    """module.name replaced by fn for the duration (a reference route)."""
    orig = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


# --------------------------------------------------------------------------- #
# 1. device
# --------------------------------------------------------------------------- #

def phase_device() -> tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name} count={torch.cuda.device_count()} nvidia-smi: {smi} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    probe = {m: importlib.util.find_spec(m) is not None
             for m in ("yaml", "jinja2", "safetensors", "tokenizers", "transformers", "triton")}
    probe["ninja"] = shutil.which("ninja") is not None or importlib.util.find_spec("ninja") is not None
    log("[env-probe] " + json.dumps(probe, sort_keys=True))
    return name, smi


# --------------------------------------------------------------------------- #
# 2. build
# --------------------------------------------------------------------------- #

def _kernel_name(mangled: str) -> str:
    """`qmm_mma_kernel<2, 2, 1>` from a mangled kernel name (c++filt where the
    machine has it, else the mangled name)."""
    cxxfilt = shutil.which("c++filt")
    if not cxxfilt:
        return mangled
    full = subprocess.run([cxxfilt, mangled], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    full = full.replace("(anonymous namespace)::", "").replace("void ", "")
    return full.split("(")[0] or mangled


def _ptxas_usage(out: str) -> list[dict]:
    """Registers, spill bytes and static shared memory of every kernel in an
    `nvcc -Xptxas -v` log."""
    rows, cur = [], None
    for line in out.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"kernel": _kernel_name(m.group(1))}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return rows


def phase_build() -> dict[str, list[dict]]:
    from localai_tpu_torch import kernels

    t0 = time.monotonic()
    logs = kernels.build()
    log(f"[build] {len(logs)} librar{'y' if len(logs) == 1 else 'ies'} in "
        f"{time.monotonic() - t0:.1f}s with {kernels.nvcc_path()}")
    usage = {}
    for name, out in logs.items():
        for line in out.splitlines():
            if ("ptxas info" in line and ("Used" in line or "Compiling" in line)
                    or "spill" in line):
                log(f"[build:{name}] {line.strip()}")
        check(kernels.library_path(name).exists(), f"library {name} missing after build")
        usage[name] = _ptxas_usage(out)
    b2 = [r for r in usage["paged_attention"] if "paged_" in r["kernel"]]
    log(f"[build:paged_attention] instances: {json.dumps(b2)}")
    check(sum("paged_mma_kernel" in r["kernel"] for r in b2) == 12
          and sum("paged_scalar_kernel" in r["kernel"] for r in b2) == 4,
          f"expected 12 paged_mma_kernel and 4 paged_scalar_kernel instances, found {b2}")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0 for r in b2
              if "paged_mma_kernel" in r["kernel"]), f"a paged_mma_kernel instance spills: {b2}")
    mma = [r for r in usage["quant_matmul"] if "qmm_mma_kernel" in r["kernel"]]
    log(f"[build:quant_matmul] tensor-core instances: {json.dumps(mma)}")
    check(len(mma) == 9, f"expected 9 qmm_mma_kernel instances in the ptxas log, found {len(mma)}")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0 for r in mma),
          f"a qmm_mma_kernel instance spills: {mma}")
    b4 = [r for r in usage["quant_matmul"] if "unembed_mma_kernel" in r["kernel"]]
    log(f"[build:quant_matmul] B4 tensor-core instances: {json.dumps(b4)}")
    check(len(b4) == 3, f"expected 3 unembed_mma_kernel instances in the ptxas log, found {b4}")
    check(all(r.get("spill_stores", 1) == 0 and r.get("spill_loads", 1) == 0 for r in b4),
          f"an unembed_mma_kernel instance spills: {b4}")
    b5 = [r for r in usage["lora_matmul"] if "lora_group_kernel" in r["kernel"]]
    log(f"[build:lora_matmul] instances: {json.dumps(b5)}")
    check(len(b5) == 4, f"expected 4 lora_group_kernel instances in the ptxas log, found {b5}")
    mma5 = [r for r in b5 if "__nv_bfloat16, __nv_bfloat16" in r["kernel"]]
    check(len(mma5) == 1 and mma5[0].get("spill_stores", 1) == 0
          and mma5[0].get("spill_loads", 1) == 0,
          f"the tensor-core lora_group_kernel instance is missing or spills: {b5}")
    return usage


# --------------------------------------------------------------------------- #
# 3. kernels
# --------------------------------------------------------------------------- #

def _attention_work(B, S, H, K, D, lengths, dtype) -> tuple[float, float]:
    """(FLOPs, bytes) the flash function needs on this data: QKᵀ and PV over
    the causal pairs of each row's valid prefix; the valid rows of q, k and
    v and the lengths read once, the whole output (padded rows as zeros)
    written once."""
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    flops = 4.0 * D * H * pairs
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * (sum(lengths) * (H + 2 * K) * D + B * S * H * D) + 4 * B
    return flops, nbytes


def phase_kernels(gen: torch.Generator) -> list[dict]:
    import torch.nn.functional as F

    from localai_tpu_torch.ops.flash import flash_prefill_attention, flash_prefill_attention_plain

    # Tolerances, bf16 output: both sides round once to bf16, whose step at
    # the outputs' magnitude (|o| < 4) is at most 2^-6; f32: summation order.
    tols = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    ragged = [  # (B, S, H, K, D, dtype): llama-3.2-1b admissions, then D=128
        (1, 128, 32, 8, 64, torch.bfloat16),
        (8, 128, 32, 8, 64, torch.bfloat16),
        (1, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 128, torch.bfloat16),
        (2, 256, 32, 8, 64, torch.float32),
    ]
    # Every row of length S: the kernel, SDPA and the bound count the same
    # work (llama-3.2-1b and llama-3-8b at 8 x 2048; the 8b admission
    # bucket of 8 x 512). S = 200: the last query and kv tiles are partial.
    full = [
        (8, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 128, torch.bfloat16),
        (8, 512, 32, 8, 128, torch.bfloat16),
    ]
    partial = [
        (3, 200, 32, 8, 64, torch.bfloat16),
        (3, 200, 32, 8, 128, torch.bfloat16),
        (3, 200, 32, 8, 64, torch.float32),
    ]
    # The added rows draw from their own generator, so the later phases see
    # the inputs they always saw.
    gen_added = torch.Generator(device="cuda").manual_seed(6)
    cases = ([(sh, "ragged", gen) for sh in ragged] + [(sh, "full", gen_added) for sh in full]
             + [(sh, "ragged", gen_added) for sh in partial])
    rows = []
    for (B, S, H, K, D, dt), mode, g in cases:
        q = torch.randn(B, S, H, D, generator=g, device="cuda").to(dt)
        k = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        v = torch.randn(B, S, K, D, generator=g, device="cuda").to(dt)
        if mode == "full":
            lens = torch.full((B,), S, device="cuda", dtype=torch.int32)
        else:  # one full row, one single-token row, the rest ragged
            lens = torch.randint(1, S + 1, (B,), generator=g, device="cuda", dtype=torch.int32)
            lens[0] = S
            if B > 1:
                lens[1] = 1
        out = flash_prefill_attention(q, k, v, lens)
        torch.cuda.synchronize()
        ref = flash_prefill_attention_plain(q, k, v, lens)
        err = (out.float() - ref.float()).abs().max().item()
        host_lens = lens.tolist()
        pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(host_lens))
        # The same inputs again, and each batch row alone: the same bits
        # (no block mixes batch rows; nothing sums in a varying order).
        repeat_equal = torch.equal(out, flash_prefill_attention(q, k, v, lens))
        rows_alone_equal = all(
            torch.equal(out[b:b + 1], flash_prefill_attention(
                q[b:b + 1].contiguous(), k[b:b + 1].contiguous(), v[b:b + 1].contiguous(),
                lens[b:b + 1].contiguous()))
            for b in range(B))
        reps = 20 if S <= 256 else 5
        ms = cuda_time_ms(lambda: flash_prefill_attention(q, k, v, lens), reps)
        plain_ms = cuda_time_ms(lambda: flash_prefill_attention_plain(q, k, v, lens), max(2, reps // 4))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            reps)
        flops, nbytes = _attention_work(B, S, H, K, D, host_lens, dt)
        t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, nbytes / PEAK_BYTES * 1e3
        bound_ms = max(t_ops, t_bytes)
        row = dict(shape=[B, S, H, K, D], dtype=str(dt).replace("torch.", ""),
                   lengths=host_lens, max_abs_err=err, tol=tols[dt],
                   pad_zero=pad_zero, repeat_equal=repeat_equal,
                   rows_alone_equal=rows_alone_equal,
                   ok=(err <= tols[dt] and pad_zero and repeat_equal and rows_alone_equal
                       and bool(torch.isfinite(out).all())),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   # SDPA computes every row at full length: the same work
                   # only where every length is S.
                   library_same_work=all(n == S for n in host_lens),
                   bound_ms=bound_ms, bound_frac=bound_ms / ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"[kernel flash_prefill] {json.dumps(row)}")
        check(row["ok"], f"flash_prefill disagrees with its plain version at {row['shape']} "
                         f"{row['dtype']}: err {err} (tol {tols[dt]}), padded rows zero={pad_zero}, "
                         f"repeat bit-identical={repeat_equal}, "
                         f"rows alone bit-identical={rows_alone_equal}")
        rows.append(row)
    return rows


def _paged_work(qpos, limits, K, D, MP, page, elt, window, sink=0, swin=0,
                span=0) -> tuple[float, float]:
    """(FLOPs, bytes) the paged-partials function needs on this data: QKᵀ
    and PV over the unmasked (row, key) pairs of the rows each slot visits
    (its live rows, min(limit, MP·page); under the sink + window skip only
    the sink pages and the window's: ops/paged_flash.walk_rows); those K/V
    rows read once, the table entries of the visited pages (and with a
    hierarchical table the directory entries above them), q rows, limits
    and query positions read once, acc, m and l written once."""
    import numpy as np

    from localai_tpu_torch.ops.paged_flash import walk_rows

    B, QR = qpos.shape
    pairs = rows = entries = 0
    for b in range(B):
        n_v, sink_rows, gap = walk_rows(int(limits[b]), int(qpos[b].min()), page, MP, sink, swin)
        g = np.arange(n_v)
        g = np.where(g < sink_rows, g, g + gap)  # the real rows visited
        ok = np.ones((QR, n_v), bool)
        dist = qpos[b][:, None].astype(np.int64) - g[None, :]
        if window:
            ok &= dist < window
        if swin:
            ok &= (g[None, :] < sink) | (dist < swin)
        pairs += int(ok.sum())
        rows += n_v
        cols = np.unique(g // page)
        entries += len(cols) + (len(np.unique(cols // span)) if span else 0)
    flops = 4.0 * D * K * pairs
    nbytes = (2 * elt * rows * K * D + 4 * B * K * QR * D + 4 * entries + 4 * B
              + 4 * B * QR + 4 * B * K * QR * (D + 2))
    return flops, nbytes


def phase_paged_kernels(gen: torch.Generator) -> list[dict]:
    import numpy as np

    from localai_tpu_torch import kernels
    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops.paged_flash import (
        paged_partials_plain, paged_partials_rows, plan_for)

    # Both sides compute in f32 (pool rows widen exactly; the tensor-core
    # kernel splits q and p into bf16 hi + lo): the tolerance covers
    # summation order over up to 4096 rows and the hi / lo residue.
    tol = 2e-4
    # (name, B, G, T, K, D, page, MP, pool dtype, limits, softcap, window):
    # llama-3.2-1b paged decode (H=32, K=8: G=4 query rows per kv head) at
    # D 64 and 128, one 512-token prefill chunk at offset 1536, a small f32
    # shape with softcap and a sliding window, and the D=128 decode shape
    # (llama-3-8b's) on fp8 pools with a per-head kv_scale; then, from
    # their own generator, qwen2-7b's decode (H=28, K=4: G=7), pages of 16
    # and of 48 rows (key tiles span pages; 48-row pages put the split
    # edges, multiples of 128 rows, inside pages) with limits at a split
    # edge and one row either side, and a 4-token multi-query verify
    # (T*G = 16 rows).
    shapes = [
        ("decode", 8, 4, 1, 8, 64, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("decode", 8, 4, 1, 8, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("prefill_chunk", 1, 4, 512, 8, 64, 128, 32, torch.bfloat16, [1536], 0.0, 0),
        ("decode_softcap_window", 3, 2, 1, 2, 64, 16, 8, torch.float32, [100, 37, 0], 30.0, 40),
        ("decode_fp8", 8, 4, 1, 8, 128, 128, 32, torch.float8_e4m3fn, "ragged", 0.0, 0),
        ("decode_fp8", 8, 4, 1, 8, 128, 128, 32, torch.float8_e5m2, "ragged", 0.0, 0),
    ]
    added = [
        ("decode_g7", 8, 7, 1, 4, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("decode_page16", 8, 4, 1, 8, 64, 16, 256, torch.bfloat16,
         [4096, 0, 256, 255, 257, 1024, 1, 3000], 0.0, 0),
        ("decode_page48", 8, 4, 1, 8, 64, 48, 84, torch.bfloat16,
         [4032, 0, 384, 383, 385, 2049, 47, 3000], 0.0, 0),
        ("verify_t4", 8, 4, 4, 8, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
    ]
    gen_added = torch.Generator(device="cuda").manual_seed(8)
    sms = kernels.sm_count(torch.device("cuda"))
    rows = []
    for (name, B, G, T, K, D, page, MP, dt, limits, softcap, window), g in (
            [(sh, gen) for sh in shapes] + [(sh, gen_added) for sh in added]):
        QR = G * T
        P = B * MP + 1
        if limits == "ragged":  # one full slot, one idle slot, the rest random
            limits = torch.randint(1, MP * page + 1, (B,), generator=g, device="cuda").tolist()
            limits[0], limits[1] = MP * page, 0
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        qr = torch.randn(B, K, QR, D, generator=g, device="cuda") / D**0.5
        kp = torch.randn(P, page, K, D, generator=g, device="cuda")
        vp = torch.randn(P, page, K, D, generator=g, device="cuda")
        kv_scale = None
        if dt.itemsize == 1:  # fp8: stored = value / scale, a fixed per-head scale
            kv_scale = torch.stack([torch.linspace(0.5, 4.0, K), torch.linspace(3.0, 0.25, K)])
            kv_scale = kv_scale.cuda()
            kp, vp = kp / kv_scale[0][:, None], vp / kv_scale[1][:, None]
        kp, vp = kv_cast(kp, dt), kv_cast(vp, dt)
        # A random permutation of the pool's pages (SCRATCH, the last, unused).
        table = torch.randperm(P - 1, generator=g, device="cuda")[: B * MP]
        table = table.reshape(B, MP).to(torch.int32).contiguous()
        qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
        args = (qr, qpos, kp, vp, table, lim, softcap, window, kv_scale)
        acc, m, l = paged_partials_rows(*args)
        torch.cuda.synchronize()
        racc, rm, rl = paged_partials_plain(*args)
        live = lim > 0
        o_err = (acc / l.clamp(min=1e-30)[..., None] - racc / rl.clamp(min=1e-30)[..., None])
        o_err = o_err[live].abs().max().item()
        m_err = (m - rm)[live].abs().max().item()
        l_rel = ((l - rl)[live].abs() / rl[live]).max().item()
        idle_exact = bool((m[~live] == -1e30).all() and (l[~live] == 0).all()
                          and (acc[~live] == 0).all())
        # The same inputs again, and each slot launched alone: the same bits
        # (no float atomics; the plan does not depend on the batch).
        again = paged_partials_rows(*args)
        repeat_equal = all(torch.equal(a, b) for a, b in zip((acc, m, l), again))
        alone_equal = all(
            all(torch.equal(a[b:b + 1], x) for a, x in zip((acc, m, l), paged_partials_rows(
                qr[b:b + 1], qpos[b:b + 1], kp, vp, table[b:b + 1], lim[b:b + 1], softcap,
                window, kv_scale)))
            for b in range(B))
        plan = plan_for(qr, kp, table, sms)
        ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
        plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 3)
        flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), K, D, MP, page,
                                    dt.itemsize, window)
        nbytes += 0 if kv_scale is None else kv_scale.numel() * 4
        # bf16 / fp8 pools: the least time is the tensor cores' (K and V
        # are exact in bf16); f32 pools: the f32 rate (q rows are f32).
        rate = torch.float32 if dt == torch.float32 else torch.bfloat16
        t_ops, t_bytes = flops / PEAK_FLOPS[rate] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, B=B, H=G * K, K=K, QR=QR, D=D, page=page, MP=MP,
                   pool_dtype=str(dt).replace("torch.", ""), limits=limits, softcap=softcap,
                   window=window,
                   kv_scale=None if kv_scale is None else kv_scale.tolist(),
                   max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
                   idle_exact=idle_exact, repeat_equal=repeat_equal, alone_equal=alone_equal,
                   ok=max(o_err, m_err, l_rel) <= tol and idle_exact and repeat_equal
                   and alone_equal and bool(torch.isfinite(acc).all()),
                   plan={**plan._asdict(), "grid": [plan.splits, K * -(-QR // plan.row_tile), B]},
                   ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes), bound_frac=max(t_ops, t_bytes) / ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_basis=("FLOPs over the f32 rate (f32 pool: scalar FMAs)"
                                if rate == torch.float32 else
                                "FLOPs over the bf16 tensor-core peak (bf16 / fp8 pool)")
                   + ", bytes over HBM")
        log(f"[kernel paged_attention] {json.dumps(row)}")
        check(row["ok"], f"paged_attention disagrees with its plain version at {name} "
                         f"D={D} {row['pool_dtype']}: acc/l err {o_err}, m err {m_err}, "
                         f"l rel err {l_rel} (tol {tol}), idle exact={idle_exact}, "
                         f"repeat bit-identical={repeat_equal}, "
                         f"slots alone bit-identical={alone_equal}")
        rows.append(row)
    return rows + _long_context_kernel_rows()


def _hier_of(table: torch.Tensor, span: int, scratch: int):
    """A flat table [B, MP] as the engine's hierarchical pair: l0 row 0 the
    table page of SCRATCH entries, then each slot's table pages in order;
    l1 the directories [B, MP / span]."""
    B, MP = table.shape
    l0 = torch.cat([torch.full((1, span), scratch, dtype=torch.int32, device=table.device),
                    table.reshape(B * MP // span, span)])
    l1 = 1 + torch.arange(B * MP // span, dtype=torch.int32, device=table.device)
    return l1.reshape(B, MP // span).contiguous(), l0.contiguous()


# The long-context engine of the reference's ladder (bench.py:2099-2118):
# pages of 128, sink 128, window 4096, table pages of 128 entries.
LONG_SINK, LONG_WINDOW, LONG_SPAN = 128, 4096, 128


def _long_context_kernel_rows() -> list[dict]:
    """B2's long-context forms against the plain version, on the card:
    llama-3.2-1b's decode shape (B = 8, K = 8, G = 4, D = 64, pages of
    128) at contexts up to 131072 and a 512-token chunk at offset 65536
    (past the window), each on a hierarchical table under the sink +
    window skip; then one slot at a 1,048,576-token limit whose pool holds
    only the pages it visits and SCRATCH. Each holds the hierarchical table
    to the flat one and a spilled table (skipped columns at SCRATCH) to the
    hot one bit for bit, repeats and slots alone bit for bit, and times the
    kernel, the plain version, and the same slots walked in full without
    the skip. The bound counts the visited rows' bytes only."""
    import numpy as np

    from localai_tpu_torch import kernels
    from localai_tpu_torch.ops.paged_flash import (
        paged_partials_plain, paged_partials_rows, plan_for, walk_rows)

    tol = 2e-4  # as the other B2 rows: f32 on both sides
    g = torch.Generator(device="cuda").manual_seed(13)
    sms = kernels.sm_count(torch.device("cuda"))
    sink, swin, span = LONG_SINK, LONG_WINDOW, LONG_SPAN
    rows = []
    for name, B, T, MP, limits in (
            ("decode_128k_hier_skip", 8, 1, 1024, "ragged"),
            ("chunk_512_past_window_hier_skip", 1, 512, 1024, [65536]),
            ("decode_1m_hier_skip", 1, 1, 8192, [1 << 20])):
        K, G, D, page = 8, 4, 64, 128
        QR = G * T
        if limits == "ragged":  # one full slot, one idle slot, the rest random
            limits = torch.randint(1, MP * page + 1, (B,), generator=g, device="cuda").tolist()
            limits[0], limits[1] = MP * page, 0
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
        walks = [walk_rows(n, n, page, MP, sink, swin) for n in limits]
        million = MP * page > 131072
        if million:
            # The pool holds the pages the slot visits, then SCRATCH; every
            # other column of the table points at SCRATCH.
            n_v, sink_rows, gap = walks[0]
            cols = sorted({c // page for c in range(sink_rows)}
                          | set(range((sink_rows + gap) // page, -(-limits[0] // page))))
            P = len(cols) + 1
            table = torch.full((1, MP), P - 1, dtype=torch.int32, device="cuda")
            table[0, cols] = torch.arange(len(cols), dtype=torch.int32, device="cuda")
        else:
            P = B * MP + 1
            table = torch.randperm(P - 1, generator=g, device="cuda")[: B * MP]
            table = table.reshape(B, MP).to(torch.int32).contiguous()
        kp = torch.randn(P, page, K, D, generator=g, device="cuda").to(torch.bfloat16)
        vp = torch.randn(P, page, K, D, generator=g, device="cuda").to(torch.bfloat16)
        qr = torch.randn(B, K, QR, D, generator=g, device="cuda") / D**0.5
        hier = _hier_of(table, span, P - 1)
        spilled = table.clone()
        for b, (n_v, sink_rows, gap) in enumerate(walks):
            spilled[b, sink_rows // page:(sink_rows + gap) // page] = P - 1
        args = (qr, qpos, kp, vp, hier, lim, 0.0, 0, None, sink, swin)
        before = paged_partials_rows.launches
        acc, m, l = out = paged_partials_rows(*args)
        torch.cuda.synchronize()
        launched = paged_partials_rows.launches - before
        racc, rm, rl = paged_partials_plain(*args)
        live = lim > 0
        o_err = (acc / l.clamp(min=1e-30)[..., None] - racc / rl.clamp(min=1e-30)[..., None])
        o_err = o_err[live].abs().max().item()
        m_err = (m - rm)[live].abs().max().item()
        l_rel = ((l - rl)[live].abs() / rl[live]).max().item()

        def same(x, y):
            return all(torch.equal(a, c) for a, c in zip(x, y))

        hier_equal_flat = same(out, paged_partials_rows(qr, qpos, kp, vp, table, lim, 0.0, 0,
                                                         None, sink, swin))
        spilled_equal_hot = same(out, paged_partials_rows(
            qr, qpos, kp, vp, _hier_of(spilled, span, P - 1), lim, 0.0, 0, None, sink, swin))
        repeat_equal = same(out, paged_partials_rows(*args))
        alone_equal = all(same([a[b:b + 1] for a in out], paged_partials_rows(
            qr[b:b + 1], qpos[b:b + 1], kp, vp, (hier[0][b:b + 1], hier[1]), lim[b:b + 1],
            0.0, 0, None, sink, swin)) for b in range(B))
        plan = plan_for(qr, kp, hier, sms)
        ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
        plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 3)
        # The same slots walked in full (no skip; every row attended): what
        # a slot costs without the window. The 1M slot's pool holds too few
        # pages for that.
        full_ms = None if million else cuda_time_cold_ms(
            lambda: paged_partials_rows(qr, qpos, kp, vp, hier, lim), 20)
        flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), K, D, MP, page, 2,
                                    0, sink, swin, span)
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.bfloat16] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, form="hierarchical table + sink/window skip", B=B, H=G * K, K=K,
                   QR=QR, D=D, page=page, MP=MP, span=span, sink=sink, swin=swin, pool_pages=P,
                   pool_dtype="bfloat16", limits=limits,
                   visited_rows=[w[0] for w in walks], launches=launched,
                   max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
                   hier_equal_flat=hier_equal_flat, spilled_equal_hot=spilled_equal_hot,
                   repeat_equal=repeat_equal, alone_equal=alone_equal,
                   ok=max(o_err, m_err, l_rel) <= tol and hier_equal_flat and spilled_equal_hot
                   and repeat_equal and alone_equal and launched == 1
                   and bool(torch.isfinite(acc).all()),
                   plan={**plan._asdict(), "grid": [plan.splits, K * -(-QR // plan.row_tile), B]},
                   ms=ms, plain_ms=plain_ms, full_walk_ms=full_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes), bound_frac=max(t_ops, t_bytes) / ms,
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_basis="FLOPs over the bf16 tensor-core peak, the visited rows' bytes "
                               "over HBM")
        log(f"[kernel paged_attention long] {json.dumps(row)}")
        check(row["ok"], f"paged_attention {name}: acc/l err {o_err}, m err {m_err}, l rel err "
                         f"{l_rel} (tol {tol}), hier = flat {hier_equal_flat}, spilled = hot "
                         f"{spilled_equal_hot}, repeat {repeat_equal}, alone {alone_equal}, "
                         f"launches {launched}")
        rows.append(row)
        del kp, vp, out, acc, racc
        torch.cuda.empty_cache()
    return rows


# llama-3-8b's projections (in, out): wk / wv, wq / wo, w_gate / w_up,
# w_down; then a small ragged shape (three int4 groups, out not a multiple
# of the kernel's 128-column block).
QMM_SHAPES = [(4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096), (96, 80)]
QMM_FORMS = ("int8", "grouped_int8", "int4")


def _grouped_int8(w, group=32):
    """Group-wise symmetric int8 (GGUF q8_0's layout) over the in (-2) axis,
    leading (expert) axes kept, quantized here: the serving path's
    quantizers make the flat int8 and int4 forms only."""
    g = w.shape[-2] // group
    wg = w.float().reshape(*w.shape[:-2], g, group, w.shape[-1])
    s = torch.clamp(wg.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-9)
    return {"gq": torch.clamp(torch.round(wg / s), -127, 127).to(torch.int8), "gs": s}


def _qmm_work(form, N, n_in, n_out, x_elt) -> tuple[float, float]:
    """(FLOPs, bytes) of x [N, in] @ w: the payload, its scales (and int4
    zero points) and x read once, the output written once."""
    G = n_in // 32
    wbytes = {"int8": n_in * n_out + 4 * n_out,
              "grouped_int8": n_in * n_out + 4 * G * n_out,
              "int4": n_in * n_out // 2 + 8 * G * n_out}[form]
    return 2.0 * N * n_in * n_out, wbytes + x_elt * N * (n_in + n_out)


def _bound(flops, nbytes, dtype) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype] * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def _hold_b3(label: str, run, plain, x, bf16_mm, dequant, work, plan, **keys) -> dict:
    """One B3 row: the kernel `run(x)` against its plain version (f32 x:
    summation order only, 1e-4 x max|out|; bf16 x: both sides round the f32
    sum once to bf16, so they may differ by one bf16 step, 2^-7 of the
    value, plus that term), a second launch bit-identical and, up to 16
    rows, each row launched alone bit-identical; flushed times of the
    kernel, the plain version, `bf16_mm()` and `dequant(x)` with the kernel
    route off, and the bound of `work` = (FLOPs, bytes)."""
    dt, N = x.dtype, x.shape[0]
    out = run(x)
    torch.cuda.synchronize()
    want = plain(x)
    scale = plain(x.float()).abs().max().item()
    err = (out.float() - want.float()).abs()
    if dt == torch.float32:
        ok = err.max().item() <= 1e-4 * scale
    else:
        ok = bool((err <= 2.0**-7 * want.float().abs() + 1e-4 * scale).all())
    ok = ok and bool(torch.isfinite(out).all())
    repeat_equal = torch.equal(out, run(x))
    rows_alone_equal = (all(torch.equal(out[i:i + 1], run(x[i:i + 1])) for i in range(N))
                        if N <= 16 else None)
    ms = cuda_time_cold_ms(lambda: run(x), 20)
    plain_ms = cuda_time_cold_ms(lambda: plain(x), 3)
    bf16_ms = cuda_time_cold_ms(bf16_mm, 20)
    with _dequant_route():
        dequant_ms = cuda_time_cold_ms(lambda: dequant(x), 20)
    bound_ms, bound_by = _bound(*work, dt)
    row = dict(**keys, dtype=str(dt).replace("torch.", ""), max_abs_err=err.max().item(),
               out_max=scale, repeat_equal=repeat_equal, rows_alone_equal=rows_alone_equal,
               ok=ok and repeat_equal and rows_alone_equal is not False, ms=ms,
               plain_ms=plain_ms, bf16_ms=bf16_ms, dequant_ms=dequant_ms, bound_ms=bound_ms,
               bound_frac=bound_ms / ms, bound_by=bound_by, plan=plan)
    log(f"[kernel {label}] {json.dumps(row)}")
    check(row["ok"], f"{label} disagrees with its plain version or is not bit-identical on a "
                     f"repeat / a row alone at {row}")
    return row


def phase_quant_kernels(gen: torch.Generator) -> tuple[list[dict], list[dict]]:
    """B3 at every projection shape, form, x dtype and row count of the
    serving path, and B4 at llama-3-8b's head and a ragged one
    (_hold_unembed); each against its plain
    version, with the time of a bf16 matmul on the dequantized weight
    (`bf16_ms`: what the quantized kernel has to beat to be worth its
    bytes) and, for B3, of models/quant.matmul with the kernel route off
    (`dequant_ms`: what the engine pays at those rows without B3). Every B3
    output is bit-identical when launched again, and up to 16 rows for each
    row launched alone. No one PyTorch call takes these packed layouts, so
    there is no library time."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import qmm, qmm_plain, qmm_plan

    # f32 x: summation order only. bf16 x: both sides round the f32 sum once
    # to bf16, so they may differ by one bf16 step (2^-7 of the value).
    # The 16- and 64-row inputs draw from their own generator, so the later
    # phases see the inputs they always saw.
    gen_added = torch.Generator(device="cuda").manual_seed(7)
    b3 = []
    for n_in, n_out in QMM_SHAPES:
        w = torch.randn(n_in, n_out, generator=gen, device="cuda") * 0.02
        for form in QMM_FORMS:
            qw = {"int8": quant.quantize_tensor, "grouped_int8": _grouped_int8,
                  "int4": quant.quantize_tensor_g4}[form](w)
            w_bf16 = quant.dequantize_tensor(qw).to(torch.bfloat16)
            for dt in (torch.bfloat16, torch.float32):
                for N in (1, 8, 16, 64, 256):
                    g = gen if N in (1, 8, 256) else gen_added
                    x = torch.randn(N, n_in, generator=g, device="cuda").to(dt)
                    xb = x.to(torch.bfloat16)
                    plan = (qmm_plan(n_in, n_out, N, kernels.sm_count(x.device))._asdict()
                            if dt == torch.bfloat16 else None)
                    b3.append(_hold_b3(
                        "quant_matmul", lambda v: qmm(v, qw), lambda v: qmm_plain(v, qw), x,
                        lambda: torch.matmul(xb, w_bf16), lambda v: quant.matmul(v, qw),
                        _qmm_work(form, N, n_in, n_out, dt.itemsize), plan,
                        shape=[N, n_in, n_out], form=form))
            del qw, w_bf16
    b4 = []
    # llama-3-8b's head, then a ragged one (V not a multiple of a 16-row
    # vocab tile, D = 16 * 5: a last chunk of 16 columns) from gen_added.
    for V, D in ((128256, 4096), (1000, 80)):
        g_head = gen if V == 128256 else gen_added
        w = torch.randn(V, D, generator=g_head, device="cuda") * 0.02
        s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
        head = {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}
        head_bf16 = (head["q"].float() * s).to(torch.bfloat16)
        del w
        for dt in (torch.bfloat16, torch.float32):
            for N in (1, 8, 16, 64, 256):
                g = gen if V == 128256 and N in (1, 8, 256) else gen_added
                h = torch.randn(N, D, generator=g, device="cuda").to(dt)
                b4.append(_hold_unembed(h, head, head_bf16))
        del head, head_bf16
    return b3, b4


def _hold_unembed(h, head, head_bf16) -> dict:
    """One B4 row: the kernel against its plain version (f32 on both sides,
    exact bf16 x int8 products: summation order only, 1e-4 x max|logit|),
    a second launch bit-identical and, up to 16 bf16 rows, each row launched
    alone bit-identical; times beside a bf16 matmul on the dequantized head."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.ops.quant_matmul import qunembed, qunembed_plain, qunembed_plan

    N, D = h.shape
    V = head["q"].shape[0]
    dt = h.dtype
    out = qunembed(h, head)
    torch.cuda.synchronize()
    want = qunembed_plain(h, head)
    scale = want.abs().max().item()
    err = (out - want).abs().max().item()
    ok = err <= 1e-4 * scale and bool(torch.isfinite(out).all())
    repeat_equal = torch.equal(out, qunembed(h, head))
    rows_alone_equal = (all(torch.equal(out[i:i + 1], qunembed(h[i:i + 1], head))
                            for i in range(N)) if dt == torch.bfloat16 and N <= 16 else None)
    hb = h.to(torch.bfloat16)
    ms = cuda_time_cold_ms(lambda: qunembed(h, head), 20)
    plain_ms = cuda_time_cold_ms(lambda: qunembed_plain(h, head), 3)
    bf16_ms = cuda_time_cold_ms(
        lambda: torch.mm(hb, head_bf16.t(), out_dtype=torch.float32), 20)
    bound_ms, bound_by = _bound(2.0 * N * V * D,
                                V * D + 4 * V + dt.itemsize * N * D + 4 * N * V, dt)
    plan = (qunembed_plan(V, D, N, kernels.sm_count(h.device))._asdict()
            if dt == torch.bfloat16 else None)
    row = dict(shape=[N, V, D], dtype=str(dt).replace("torch.", ""), max_abs_err=err,
               out_max=scale, repeat_equal=repeat_equal, rows_alone_equal=rows_alone_equal,
               ok=ok and repeat_equal and rows_alone_equal is not False, ms=ms,
               plain_ms=plain_ms, bf16_ms=bf16_ms, bound_ms=bound_ms, bound_frac=bound_ms / ms,
               bound_by=bound_by, plan=plan)
    log(f"[kernel quant_unembed] {json.dumps(row)}")
    check(row["ok"], f"quant_unembed disagrees with its plain version or is not bit-identical "
                     f"on a repeat / a row alone at {row}")
    return row


# --------------------------------------------------------------------------- #
# 4. model
# --------------------------------------------------------------------------- #

def _greedy_decode(cfg, params, logits, ks, vs, lens, steps, device):
    """Greedy ids over `steps` decode steps after a prefill, one block."""
    from localai_tpu_torch.models import llama

    B = lens.shape[0]
    cache = llama.KVCache.zeros(cfg, B, int(lens.max()) + steps + 1, device=device)
    for b in range(B):
        llama.write_prefill_to_cache(cache, ks[:, b:b + 1], vs[:, b:b + 1], b)
    shape = (cfg.num_layers, B, steps, cfg.num_kv_heads, cfg.head_dim_)
    lk = torch.zeros(shape, dtype=cache.k.dtype, device=device)
    lv = torch.zeros_like(lk)
    tok, pos, ids = logits.argmax(-1), lens.to(torch.int64), []
    for step in range(steps):
        out, lk, lv = llama.decode_step_windowed(cfg, params, tok, pos, cache, lk, lv, step)
        tok = out.argmax(-1)
        ids.append(tok.tolist())
        pos = pos + 1
    return ids


def _paged_greedy(cfg, params, toks, lens, steps, device):
    """Each prompt through prefill_chunk_paged in 32-token chunks into one
    page pool (page 16, a reversed page table), then one paged decode block
    of `steps` greedy steps. Returns (prefill logits [B, V], the last step's
    logits, greedy ids)."""
    from localai_tpu_torch.models import llama

    B, page, chunk = toks.shape[0], 16, 32
    MP = -(-(int(lens.max()) + steps + 1) // page)
    pool = llama.paged_cache_zeros(cfg, B * MP + 1, page, device=device)
    table = torch.arange(B * MP, dtype=torch.int32).flip(0).reshape(B, MP).to(device)
    first = []
    for b in range(B):
        n = int(lens[b])
        for lo in range(0, n, chunk):
            m = min(chunk, n - lo)
            logits, _ = llama.prefill_chunk_paged(
                cfg, params, toks[b:b + 1, lo:lo + m].to(device), torch.tensor([m], device=device),
                torch.tensor([lo], device=device), pool, table[b:b + 1])
        first.append(logits)
    logits = torch.cat(first)
    shape = (cfg.num_layers, B, steps, cfg.num_kv_heads, cfg.head_dim_)
    lk = torch.zeros(shape, dtype=pool.k.dtype, device=device)
    lv = torch.zeros_like(lk)
    tok, pos, ids = logits.argmax(-1), lens.to(device=device, dtype=torch.int64), []
    for step in range(steps):
        out, lk, lv = llama.decode_step_windowed(cfg, params, tok, pos, pool, lk, lv, step,
                                                 ptable=table)
        tok = out.argmax(-1)
        ids.append(tok.tolist())
        pos = pos + 1
    return logits, out, ids


def phase_model(gen: torch.Generator) -> dict:
    from localai_tpu_torch.models import get_arch, llama

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 reference: full f32 products
    # (a) A small f32 model (head_dim 64, so the kernel serves it) on the
    # card against the same weights on the CPU.
    small = dataclasses.replace(get_arch("tiny"), name="tiny-d64", hidden_size=256,
                                intermediate_size=512, num_heads=4, num_kv_heads=2,
                                dtype="float32")
    p_cpu = llama.init_params(small, seed=1, device="cpu")
    p_gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    toks = torch.randint(0, small.vocab_size, (2, 64), generator=torch.Generator().manual_seed(2))
    lens = torch.tensor([64, 23])
    lg, kg, vg = llama.prefill(small, p_gpu, toks.cuda(), lens.cuda())
    lc, kc, vc = llama.prefill(small, p_cpu, toks, lens)
    small_err = (lg.cpu() - lc).abs().max().item()
    ids_gpu = _greedy_decode(small, p_gpu, lg, kg, vg, lens.cuda(), 16, "cuda")
    ids_cpu = _greedy_decode(small, p_cpu, lc, kc, vc, lens, 16, "cpu")
    log(f"[model tiny-d64 f32] card vs cpu: logits max_abs_err={small_err:.3e} "
        f"greedy ids equal over 16 steps={ids_gpu == ids_cpu}")
    # f32 on both devices; only the summation order differs.
    check(small_err < 1e-3, f"small model: card logits differ from the CPU's by {small_err}")
    check(ids_gpu == ids_cpu, "small model: greedy ids differ between card and CPU")
    # The same model's paged path: chunked prefill into pages, paged decode.
    from localai_tpu_torch.ops.paged_flash import paged_partials_rows

    before = paged_partials_rows.launches
    pl_gpu, pd_gpu, pids_gpu = _paged_greedy(small, p_gpu, toks, lens, 16, "cuda")
    card_launches = paged_partials_rows.launches - before
    pl_cpu, pd_cpu, pids_cpu = _paged_greedy(small, p_cpu, toks, lens, 16, "cpu")
    paged_err = max((pl_gpu.cpu() - pl_cpu).abs().max().item(),
                    (pd_gpu.cpu() - pd_cpu).abs().max().item())
    log(f"[model tiny-d64 f32 paged] card vs cpu: prefill_chunk_paged + paged decode logits "
        f"max_abs_err={paged_err:.3e}, greedy ids equal over 16 steps={pids_gpu == pids_cpu}, "
        f"paged kernel launches on the card={card_launches}")
    check(paged_err < 1e-3, f"small model paged path: card logits differ by {paged_err}")
    check(pids_gpu == pids_cpu, "small model paged path: greedy ids differ between card and CPU")
    check(card_launches == small.num_layers * (3 + 16),
          f"small model paged path: {card_launches} paged kernel launches")

    # (b) Full-width llama-3.2-1b, bf16, random weights: the prefill through
    # the kernel against the same call through the dense attention. The
    # earlier slices' 1b phases (this one, 5 and 6) run 8 of its 16 layers
    # to keep the whole script's time in hand; lora_http serves all 16.
    cfg = dataclasses.replace(get_arch("llama-3.2-1b"), num_layers=8)
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[model llama-3.2-1b, 8 layers] random bf16 weights in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    B, S = 2, 512
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    lens = torch.tensor([S, 300], device="cuda")
    logits, ks, vs = llama.prefill(cfg, params, toks, lens)
    from localai_tpu_torch.ops import attention

    def dense(q, k, v, length_mask, lengths=None, **kw):
        return attention.causal_prefill_attention(q, k, v, length_mask, **kw)

    with swapped(llama, "prefill_attention", dense):  # the same call through dense math
        ref, rks, rvs = llama.prefill(cfg, params, toks, lens)
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, cfg.vocab_size),
          "llama-3.2-1b prefill logits not finite / wrong shape")
    ids = _greedy_decode(cfg, params, logits, ks, vs, lens, 16, "cuda")
    ref_ids = _greedy_decode(cfg, params, ref, rks, rvs, lens, 16, "cuda")
    agree = sum(a == b for x, y in zip(ids, ref_ids) for a, b in zip(x, y)) / (16 * B)
    log(f"[model llama-3.2-1b bf16, 8 layers] kernel vs dense prefill: logits max_abs_err={err:.4f} "
        f"(max |logit| {scale:.3f}), top-1 agreement={top1:.2f}, greedy ids over 16 steps "
        f"agree {agree:.2f}; kernel-path ids row0={[x[0] for x in ids]}")
    # bf16 activations through 8 layers: the two attentions round at
    # different places; allow 5% of the largest logit.
    check(err <= 0.05 * scale, f"llama-3.2-1b prefill logits differ by {err} (max {scale})")
    return {"params": params, "cfg": cfg, "small": small, "p_small": p_gpu, "p_small_cpu": p_cpu}


# --------------------------------------------------------------------------- #
# 7. quantized model, 8. quantized engines
# --------------------------------------------------------------------------- #

def _dequant_route():
    """Every quantized product through the dequantize-then-matmul route."""
    from localai_tpu_torch.ops import quant_matmul

    stack = contextlib.ExitStack()
    stack.enter_context(swapped(quant_matmul, "dispatch_matmul", lambda x, w: None))
    stack.enter_context(swapped(quant_matmul, "dispatch_moe_mm", lambda x, w, sub: None))
    stack.enter_context(swapped(quant_matmul, "dispatch_unembed", lambda h, w: None))
    return stack


def _f32_activations(qp: dict) -> dict:
    """A quantized tree whose float leaves (embedding, norms) are f32, so
    the forward runs in f32 on the same quantized weights."""
    out = {k: (v.float() if isinstance(v, torch.Tensor) else v) for k, v in qp.items()}
    out["layers"] = {k: (v if isinstance(v, dict) else v.float()) for k, v in qp["layers"].items()}
    return out


def phase_quant_model(gen: torch.Generator) -> dict:
    """llama-3-8b with seeded random bf16 weights, quantized on the card to
    int8 and int4: prefill and greedy decode through the kernels against the
    same quantized weights through the dequantize-then-matmul route, in
    bf16 and then with f32 activations."""
    from localai_tpu_torch.models import get_arch, llama, quant

    cfg = get_arch("llama-3-8b")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[model llama-3-8b] random bf16 weights in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    out = {"cfg": cfg}
    prompts = {}
    for B, S in ((2, 128), (2, 512)):  # 256 rows: the kernels; 1024: the dequant route
        toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
        prompts[S] = (toks, torch.tensor([S, S - 37], device="cuda"))
    bf16_top1 = {S: llama.prefill(cfg, params, *prompts[S])[0].argmax(-1) for S in prompts}
    for mode in ("int8", "int4"):
        t0 = time.monotonic()
        before = torch.cuda.memory_allocated()
        qp = quant.quantize_params(cfg, params, mode)
        torch.cuda.synchronize()
        qbytes = sum(t.numel() * t.element_size()
                     for w in [*qp["layers"].values(), qp["lm_head"]] if isinstance(w, dict)
                     for t in w.values())
        log(f"[model llama-3-8b {mode}] quantized on the card in {time.monotonic() - t0:.1f}s: "
            f"matmul weights + head {qbytes / 2**30:.2f} GiB, "
            f"{(torch.cuda.memory_allocated() - before) / 2**30:.2f} GiB more allocated, "
            f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB in all")
        for S, (toks, lens) in prompts.items():
            launches = quant.matmul.dequant_calls
            logits, ks, vs = llama.prefill(cfg, qp, toks, lens)
            routed = quant.matmul.dequant_calls - launches
            with _dequant_route():
                ref, rks, rvs = llama.prefill(cfg, qp, toks, lens)
            check(bool(torch.isfinite(logits).all()) and logits.shape == (2, cfg.vocab_size),
                  f"llama-3-8b {mode} prefill logits not finite / wrong shape")
            err = (logits - ref).abs().max().item()
            scale = ref.abs().max().item()
            ids = _greedy_decode(cfg, qp, logits, ks, vs, lens, 16, "cuda")
            with _dequant_route():
                ref_ids = _greedy_decode(cfg, qp, ref, rks, rvs, lens, 16, "cuda")
            agree = sum(a == b for x, y in zip(ids, ref_ids) for a, b in zip(x, y)) / 32
            top1_bf16 = (logits.argmax(-1) == bf16_top1[S]).float().mean().item()
            row = dict(mode=mode, B=2, S=S, rows=2 * S, dequant_calls_in_prefill=routed,
                       max_abs_err=err, max_abs_logit=scale,
                       mean_abs_err=(logits - ref).abs().mean().item(),
                       top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                       greedy_agreement=agree, top1_vs_bf16=top1_bf16,
                       ids_row0=[x[0] for x in ids])
            log(f"[model llama-3-8b {mode}] kernels vs dequant route: {json.dumps(row)}")
            # Same quantized weights; the routes round bf16 activations at
            # other places (the kernels once per product, the dequant route
            # after the product and again after its bf16-rounded scale), 7
            # products per layer through 32 layers of random weights. A
            # wrong kernel errs by the logits' own size: 25% of the largest.
            check(err <= 0.25 * scale, f"llama-3-8b {mode} S={S}: logits differ by {err} "
                                       f"(max {scale})")
            check(routed == (0 if 2 * S <= 256 else 7 * cfg.num_layers),
                  f"llama-3-8b {mode} S={S}: {routed} dequant-route products")
            out.setdefault("rows", []).append(row)
            del ks, vs, rks, rvs
        # The same weights with f32 activations: the two routes then differ
        # by f32 rounding only, through all 32 layers.
        toks, lens = prompts[128]
        q32 = _f32_activations(qp)
        logits = llama.prefill(cfg32, q32, toks, lens)[0]
        with _dequant_route():
            ref = llama.prefill(cfg32, q32, toks, lens)[0]
        err, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
        top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"[model llama-3-8b {mode} f32 activations] kernels vs dequant route, S=128: "
            f"logits max_abs_err={err:.3e} (max |logit| {scale:.3f}), top-1 agreement={top1:.2f}")
        check(err <= 1e-3 * scale and top1 == 1.0,
              f"llama-3-8b {mode} f32 activations: logits differ by {err} (max {scale})")
        out.setdefault("rows", []).append(dict(mode=mode, S=128, activations="float32",
                                               max_abs_err=err, max_abs_logit=scale))
        del q32, logits, ref
        out[mode] = qp
    del params, bf16_top1
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 5. engine, 6. paged engine
# --------------------------------------------------------------------------- #

def _serve(eng, plens: list[int], max_new: int = 64, adapters=None,
           keep_ids: bool = False) -> dict:
    """Submit one request per prompt length (half greedy, half seeded top-p;
    request i with the runtime LoRA adapter adapters[i], if given) and
    stream them all; the kernel counters go to 0 just before the run and
    are read just after it. With keep_ids the result carries every
    request's token ids."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import quant_matmul
    from localai_tpu_torch.ops.flash import flash_prefill_attention
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv_group
    from localai_tpu_torch.ops.paged_flash import paged_partials_rows

    gen = torch.Generator().manual_seed(3)
    reqs = []
    for i, n in enumerate(plens):
        ids = torch.randint(0, 256, (n,), generator=gen).tolist()
        sampled = i % 2 == 1
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=max_new, ignore_eos=True,
                               temperature=0.8 if sampled else 0.0,
                               top_p=0.9 if sampled else 1.0, seed=100 + i,
                               adapter=adapters[i] if adapters else None))
    results: list = [None] * len(reqs)

    def consume(i, handle, t_submit):
        first, evs = None, []
        for ev in handle:
            if ev.kind == "token" and first is None:
                first = time.monotonic() - t_submit
            evs.append(ev)
        results[i] = (first, evs)

    # Rows of every quantized product the kernels did not take (an expert
    # product's rows counted without its expert axis).
    dequant_rows = []
    dispatch, dispatch_moe = quant_matmul.dispatch_matmul, quant_matmul.dispatch_moe_mm

    def recording(x, w):
        y = dispatch(x, w)
        if y is None:
            dequant_rows.append((quant_matmul._rows(x), x.is_floating_point()))
        return y

    def recording_moe(x, w, sub):
        y = dispatch_moe(x, w, sub)
        if y is None:
            tail = 2 if sub == quant_matmul.MOE_PER_EXPERT else 1
            dequant_rows.append((quant_matmul._rows(x, tail), x.is_floating_point()))
        return y

    # The main path's run: counts go to 0 just before, are read just after.
    flash_prefill_attention.launches = 0
    paged_partials_rows.launches = 0
    quant_matmul.qmm.launches = quant_matmul.qunembed.launches = 0
    quant_matmul.qmm_moe.launches = quant.moe_matmul.dequant_calls = 0
    quant.matmul.dequant_calls = quant.unembed_matmul.dequant_calls = 0
    lora_bgmv_group.launches = 0
    # Engine counters are read as differences over this run.
    m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
    t0 = time.monotonic()
    threads = []
    with swapped(quant_matmul, "dispatch_matmul", recording), \
            swapped(quant_matmul, "dispatch_moe_mm", recording_moe):
        for i, r in enumerate(reqs):
            h = eng.submit(r)
            th = threading.Thread(target=consume, args=(i, h, time.monotonic()))
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout=600)
    wall = time.monotonic() - t0
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "paged_attention": paged_partials_rows.launches,
                "quant_matmul": quant_matmul.qmm.launches,
                "quant_matmul_moe": quant_matmul.qmm_moe.launches,
                "quant_unembed": quant_matmul.qunembed.launches,
                "matmul_dequant_calls": quant.matmul.dequant_calls,
                "moe_dequant_calls": quant.moe_matmul.dequant_calls,
                "unembed_dequant_calls": quant.unembed_matmul.dequant_calls,
                "lora_bgmv": lora_bgmv_group.launches}
    metrics = eng.metrics()
    refs = [int(r) for r in eng._adapter_refs]
    eng.stop()
    check(all(not th.is_alive() for th in threads), "engine: a request never finished")
    completion, ttfts = 0, []
    for i, (first, evs) in enumerate(results):
        done = evs[-1]
        ntok = sum(1 for e in evs if e.kind == "token")
        check(done.kind == "done", f"request {i} ended with {done.kind}: {done.error}")
        check(sum(e.kind in ("done", "error") for e in evs) == 1,
              f"request {i}: more than one terminal event")
        check(ntok == done.completion_tokens == max_new,
              f"request {i}: {ntok} token events, {done.completion_tokens} completion tokens")
        completion += done.completion_tokens
        ttfts.append(first)
    def delta(k):
        return int(metrics[k] - m0[k])

    out = dict(requests=len(reqs), completion_tokens=completion, wall_s=wall,
               ttft_ms_p50=statistics.median(ttfts) * 1e3, ttft_ms_max=max(ttfts) * 1e3,
               decode_tok_s=(eng._decode_tokens - tok0) / (eng._decode_time - dt0),
               # Host wall time of the decode blocks, per decode step.
               decode_ms_per_step=(eng._decode_time - dt0) * 1e3
               / max(delta("decode_steps"), 1),
               e2e_tok_s=completion / wall,
               admissions=delta("admissions"),
               decode_blocks=delta("decode_blocks"),
               decode_steps=delta("decode_steps"),
               decode_graphs=int(metrics["decode_graphs"]),
               decode_graph_captures=delta("decode_graph_captures"),
               decode_graph_replays=delta("decode_graph_replays"),
               prefill_chunks=delta("prefill_chunks"),
               prefill_chunks_interleaved=delta("prefill_chunks_interleaved"),
               chunked_admits=delta("chunked_admits"),
               kv_pages_peak=int(metrics["kv_pages_peak"]),
               kv_preemptions=delta("kv_preemptions"),
               weight_bytes=int(metrics["weight_bytes"]),
               dequant_rows_min=min((r for r, _f in dequant_rows), default=None),
               dequant_small_float_calls=sum(f and r <= 256 for r, f in dequant_rows),
               adapter_refs=refs,
               adapter_metrics={k: v for k, v in metrics.items() if k.startswith("adapter")},
               launches=launches)
    if keep_ids:
        out["ids"] = [[e.token_id for e in evs if e.kind == "token"] for _f, evs in results]
    return out


def _check_graphs(label: str, out: dict) -> None:
    """Every decode block of the run went through a CUDA graph: captured at
    its shape's first block (which runs the body eagerly first) and
    replayed from then on."""
    blocks = out["decode_blocks"]
    graphs = out["decode_graph_captures"] + out["decode_graph_replays"]
    check(blocks > 0 and graphs == blocks,
          f"{label}: {blocks} decode blocks, {out['decode_graph_captures']} captures + "
          f"{out['decode_graph_replays']} replays")


def phase_engine(cfg, params) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(max_slots=8, max_seq=2048))
    out = _serve(eng, [20, 100, 300, 700, 1500, 20, 100, 300, 700, 1500])
    L, n = cfg.num_layers, out["launches"]
    check(n["flash_prefill"] == L * out["admissions"] and n["flash_prefill"] > 0,
          f"flash kernel launches {n['flash_prefill']} != {L} layers x "
          f"{out['admissions']} admissions")
    check(n["paged_attention"] == 0, "the dense engine launched the paged kernel")
    _check_graphs("dense engine", out)
    log("[engine llama-3.2-1b dense, 8 layers] " + json.dumps(out))
    return out


# 16-step blocks keep each short request decoding across several blocks, so
# chunks run between decode blocks; prompts over 512 tokens chunk.
PAGED_ENGINE = dict(max_slots=8, max_seq=4096, kv_pages=256, kv_page_size=128,
                    prefill_chunk=512, block_sizes=(16, 4, 1))
PAGED_PROMPTS = [20, 100, 300, 700, 1500, 3000, 20, 100, 300, 3500]


def phase_paged_engine(cfg, params, small, p_small) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE))
    out = _serve(eng, PAGED_PROMPTS)
    L, n = cfg.num_layers, out["launches"]
    check(n["paged_attention"] == L * (out["decode_steps"] + out["prefill_chunks"])
          and n["paged_attention"] > 0,
          f"paged kernel launches {n['paged_attention']} != {L} layers x "
          f"({out['decode_steps']} decode steps + {out['prefill_chunks']} chunks)")
    check(n["flash_prefill"] == L * out["admissions"] and n["flash_prefill"] > 0,
          f"flash kernel launches {n['flash_prefill']} != {L} layers x "
          f"{out['admissions']} single-shot admissions")
    check(out["chunked_admits"] == 4 and out["prefill_chunks"] == 2 + 3 + 6 + 7,
          f"chunked admissions {out['chunked_admits']}, chunks {out['prefill_chunks']}")
    check(out["prefill_chunks_interleaved"] > 0, "no prefill chunk ran between decode blocks")
    _check_graphs("paged engine", out)
    log("[engine llama-3.2-1b paged, 8 layers] " + json.dumps(out))

    # The small f32 model: paged + chunked engine against the dense engine.
    texts = {}
    for name, kw in (("dense", {}), ("paged", dict(kv_pages=16, kv_page_size=64,
                                                   prefill_chunk=64))):
        e = Engine(small, p_small, ByteTokenizer(small.vocab_size), device="cuda",
                   engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,), **kw))
        try:
            hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                      max_new_tokens=24, ignore_eos=True))
                  for n_, m in ((150, 7), (3, 1), (70, 3), (200, 11))]
            texts[name] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
        finally:
            e.stop()
    log(f"[engine tiny-d64 f32] paged+chunked greedy ids equal dense: "
        f"{texts['paged'] == texts['dense']}")
    check(texts["paged"] == texts["dense"], "small model: paged engine ids differ from dense")
    return out



def _check_quant_launches(label: str, L: int, out: dict, chunks=(4, 2 + 3 + 6 + 7),
                          experts: int = 0) -> None:
    """The launch identities of a quantized paged engine run; `chunks` is
    the run's (chunked admissions, prefill chunks), `experts` the model's
    experts a layer (0: a dense MLP)."""
    n = out["launches"]
    passes = out["admissions"] + out["prefill_chunks"]
    b3 = n["quant_matmul"] + n["quant_matmul_moe"]
    check(n["quant_matmul"] > 0 and b3 + n["matmul_dequant_calls"] + n["moe_dequant_calls"]
          == 7 * L * (out["decode_steps"] + passes),
          f"{label}: B3 launches {b3} + dequant-route calls {n['matmul_dequant_calls']} + "
          f"{n['moe_dequant_calls']} != 7 x {L} layers x ({out['decode_steps']} decode "
          f"steps + {passes} prefill passes)")
    # An MoE model's three expert projections a layer (every pass), a dense
    # model's none.
    moe = n["quant_matmul_moe"] + n["moe_dequant_calls"]
    check(moe == (3 * L * (out["decode_steps"] + passes) if experts else 0)
          and (n["quant_matmul_moe"] > 0) == bool(experts),
          f"{label}: {n['quant_matmul_moe']} expert-form launches + {n['moe_dequant_calls']} "
          f"dequant-route expert products for {L} layers x ({out['decode_steps']} decode "
          f"steps + {passes} passes), experts={experts}")
    check(out["dequant_small_float_calls"] == 0,
          f"{label}: {out['dequant_small_float_calls']} dequant-route calls at <= 256 rows")
    check(n["quant_unembed"] == out["decode_steps"] + out["admissions"] + out["chunked_admits"]
          and n["unembed_dequant_calls"] == 0,
          f"{label}: B4 launches {n['quant_unembed']} != {out['decode_steps']} decode steps + "
          f"{out['admissions'] + out['chunked_admits']} passes with logits")
    check(n["paged_attention"] == L * (out["decode_steps"] + out["prefill_chunks"]),
          f"{label}: B2 launches {n['paged_attention']} != {L} x ({out['decode_steps']} + "
          f"{out['prefill_chunks']})")
    check(n["flash_prefill"] == L * out["admissions"] and n["flash_prefill"] > 0,
          f"{label}: B1 launches {n['flash_prefill']} != {L} x {out['admissions']}")
    check((out["chunked_admits"], out["prefill_chunks"]) == tuple(chunks),
          f"{label}: chunked admissions {out['chunked_admits']}, chunks {out['prefill_chunks']}")


def phase_quant_engines(model: dict, small, p_small, p_small_cpu) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    cfg = model["cfg"]
    runs = {}
    for label, mode, kw in (("int8_engine", "int8", {}),
                            ("int4_fp8_engine", "int4", dict(kv_cache_dtype="fp8",
                                                             kv_scale=2.0))):
        eng = Engine(cfg, model[mode], ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE, **kw))
        out = _serve(eng, PAGED_PROMPTS)
        del eng
        log(f"[engine llama-3-8b {label}] " + json.dumps(out))
        _check_quant_launches(label, cfg.num_layers, out)
        _check_graphs(label, out)
        runs[label] = out
    torch.cuda.empty_cache()

    # The small f32 model, int4 weights on an fp8 pool with kv_scale 2:
    # kernels on the card against plain versions on the CPU.
    texts = {}
    for dev, p in (("cuda", p_small), ("cpu", p_small_cpu)):
        e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev, quantization="int4",
                   engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,),
                                           kv_pages=16, kv_page_size=64, prefill_chunk=64,
                                           kv_cache_dtype="fp8", kv_scale=2.0))
        try:
            hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                      max_new_tokens=24, ignore_eos=True))
                  for n_, m in ((150, 7), (3, 1), (70, 3), (200, 11))]
            texts[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
        finally:
            e.stop()
    log(f"[engine tiny-d64 f32 int4 fp8] card greedy ids equal the CPU's: "
        f"{texts['cuda'] == texts['cpu']}")
    check(texts["cuda"] == texts["cpu"], "small int4 + fp8 engine: card ids differ from the CPU's")
    return runs


# --------------------------------------------------------------------------- #
# 17. long context: llama-3.2-1b serving a 130,000-token prompt
# --------------------------------------------------------------------------- #

# The reference ladder's long-context engine (bench.py:2099-2118) at
# llama-3.2-1b's max_position: two slots, pages of 128, chunks of 512,
# sink 128 + window 4096; the hierarchical + spill engine adds table pages
# of 128 entries and a 2 GiB host budget for cold pages.
LONG_ENGINE = dict(max_slots=2, max_seq=131072, kv_pages=131072 // 128 + 8, kv_page_size=128,
                   prefill_chunk=512, attention_sink=LONG_SINK, attention_window=LONG_WINDOW,
                   block_sizes=(16, 4, 1))
LONG_SPILL = dict(kv_l1_span=LONG_SPAN, kv_spill_bytes=2 << 30)
LONG_PROMPT, LONG_NEW = 130_000, 32


def phase_long_context() -> dict:
    """llama-3.2-1b at full width and depth (16 layers, bf16, seeded random
    weights) serves one 130,000-token prompt and 32 greedy tokens through
    Engine.submit, first on the flat all-hot windowed engine, then on the
    hierarchical + spill one. The ids must be identical, cold pages must
    spill within the budget, and B2 must have run for every layer of every
    chunk and decode step. Prints the device ms of each chunk (from CUDA
    events around it: flat along the prompt, since each chunk walks the
    sink and the window only), the TTFT, decode tok/s and peak memory."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama

    gc.collect()  # what earlier phases left unreferenced goes first
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()  # what earlier phases still hold
    cfg = get_arch("llama-3.2-1b")
    params = llama.init_params(cfg, seed=5, device="cuda")
    runs = {}
    for label, kw in (("flat", {}), ("hier_spill", LONG_SPILL)):
        torch.cuda.reset_peak_memory_stats()
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**LONG_ENGINE, **kw))
        chunks = []
        dispatch = eng._dispatch_chunk

        def timed(st, n, with_logits=False, dispatch=dispatch, chunks=chunks):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = dispatch(st, n, with_logits)
            b.record()
            chunks.append((st["offset"], a, b))
            return out

        eng._dispatch_chunk = timed
        t0 = time.monotonic()
        eng.warmup()  # every decode-block graph captured before the request
        warm_s = time.monotonic() - t0
        chunks.clear()
        torch.cuda.synchronize()
        out = _serve(eng, [LONG_PROMPT], max_new=LONG_NEW, keep_ids=True)
        m = eng.metrics()
        torch.cuda.synchronize()
        ms = [a.elapsed_time(b) for _off, a, b in chunks]
        L, n = cfg.num_layers, out["launches"]
        check(n["paged_attention"] == L * (out["decode_steps"] + out["prefill_chunks"])
              and out["prefill_chunks"] == -(-LONG_PROMPT // 512) and n["flash_prefill"] == 0,
              f"long context {label}: B2 launches {n['paged_attention']} != {L} layers x "
              f"({out['decode_steps']} decode steps + {out['prefill_chunks']} chunks), "
              f"flash {n['flash_prefill']}")
        _check_graphs(f"long context {label}", out)
        tenth = max(1, len(ms) // 10)
        out.update(
            engine={**LONG_ENGINE, **kw}, prompt_tokens=LONG_PROMPT, warmup_s=warm_s,
            chunk_ms_first_tenth=statistics.mean(ms[:tenth]),
            chunk_ms_last_tenth=statistics.mean(ms[-tenth:]),
            chunk_ms_median=statistics.median(ms), chunk_ms_max=max(ms),
            chunk_ms_by_offset={str(off): round(x, 3) for (off, _a, _b), x in
                                list(zip(chunks, ms))[::32]},
            # This phase's peak: the weights, the engine's pool, graphs and
            # workspaces, and the run's transients (spill gathers included).
            peak_memory_bytes=torch.cuda.max_memory_allocated() - before,
            kv_pages_spilled=int(m["kv_pages_spilled"]),
            kv_spill_bytes_out=int(m["kv_spill_bytes_out"]),
            kv_spill_skips=int(m["kv_spill_skips"]))
        log(f"[long_context {label}] " + json.dumps({k: v for k, v in out.items() if k != "ids"}))
        runs[label] = out
        del eng, dispatch, timed  # the pool goes before the next engine's
        gc.collect()
        torch.cuda.empty_cache()
    flat, spl = runs["flat"], runs["hier_spill"]
    summary = {k: {label: r[k] for label, r in runs.items()} for k in (
        "ttft_ms_p50", "decode_tok_s", "chunk_ms_first_tenth", "chunk_ms_last_tenth",
        "chunk_ms_median", "chunk_ms_max", "peak_memory_bytes", "kv_pages_spilled",
        "kv_spill_bytes_out", "prefill_chunks", "decode_steps")}
    summary["ids_equal"] = flat["ids"] == spl["ids"]
    log("[long_context llama-3.2-1b, 16 layers] " + json.dumps(summary))
    check(flat["ids"] == spl["ids"],
          "long context: the hierarchical + spill engine's ids differ from the flat engine's")
    check(flat["kv_pages_spilled"] == 0 and 0 < spl["kv_pages_spilled"]
          and spl["kv_spill_bytes_out"] <= LONG_SPILL["kv_spill_bytes"],
          f"long context: spilled pages {spl['kv_pages_spilled']} "
          f"({spl['kv_spill_bytes_out']} bytes; budget {LONG_SPILL['kv_spill_bytes']})")
    for out in runs.values():
        del out["ids"]
    return {"summary": summary, **runs}


# --------------------------------------------------------------------------- #
# 12. graphs: the decode block as a CUDA graph against its eager body
# --------------------------------------------------------------------------- #

def _graph_pool_bytes(pool) -> int | None:
    """Bytes the allocator holds in one graph memory pool (its segments in
    the allocator's snapshot), or None when the snapshot does not say."""
    total, seen = 0, False
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        seen = True
        if tuple(seg["segment_pool_id"]) == tuple(pool):
            total += seg["total_size"]
    return total if seen else None


def _first_difference(a: list, b: list, block_sizes) -> str:
    """Where two requests' ids first differ: the token, and the step inside
    the decode block that drew it when blocks run the largest size."""
    for r, (x, y) in enumerate(zip(a, b)):
        for t, (u, v) in enumerate(zip(x, y)):
            if u != v:
                where = "the admission" if t == 0 else \
                    f"decode step {(t - 1) % max(block_sizes)} of a block"
                return f"request {r} token {t} ({where}): graph {u}, eager {v}"
    return "lengths differ"


def phase_graphs(label: str, cfg, params, probe=None, **kw) -> dict:
    """The same PAGED_PROMPTS requests (half greedy, half seeded top-p)
    served twice on fresh engines: once as the engine runs them (every
    decode block a CUDA graph: warmup() captures every shape, serving
    replays), and once with the engine's graph step swapped for a direct
    call of the eager block body. Ids and kernel launch counts must be
    identical. `probe(engine)`, if given, measures the graph-mode engine
    after its run; its result is the run's "probe"."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    runs = {}
    for mode in ("graph", "eager"):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE, **kw))
        with contextlib.ExitStack() as stack:
            if mode == "eager":
                stack.enter_context(swapped(eng, "_decode_block", eng._block_body))
            t0 = time.monotonic()
            eng.warmup()
            warm_s = time.monotonic() - t0
            m = eng.metrics()
            pool = None if eng._graph_pool is None else _graph_pool_bytes(eng._graph_pool)
            out = _serve(eng, PAGED_PROMPTS, keep_ids=True)
            if probe is not None and mode == "graph":
                out["probe"] = probe(eng)
        out.update(warmup_s=warm_s, graphs=int(m["decode_graphs"]),
                   capture_s=m["decode_graph_capture_s"], graph_pool_bytes=pool)
        runs[mode] = out
        del eng
        torch.cuda.empty_cache()
    g, e = runs["graph"], runs["eager"]
    summary = {
        "graphs": g["graphs"], "capture_s": g["capture_s"], "warmup_s": g["warmup_s"],
        "eager_warmup_s": e["warmup_s"], "graph_pool_bytes": g["graph_pool_bytes"],
        "decode_tok_s": {"graph": g["decode_tok_s"], "eager": e["decode_tok_s"]},
        "decode_ms_per_step": {"graph": g["decode_ms_per_step"],
                               "eager": e["decode_ms_per_step"]},
        "decode_steps": {"graph": g["decode_steps"], "eager": e["decode_steps"]},
        "ids_equal": g["ids"] == e["ids"], "launches_equal": g["launches"] == e["launches"],
        "launches": g["launches"],
    }
    log(f"[graphs {label}] " + json.dumps(summary))
    check(g["ids"] == e["ids"], f"graphs {label}: graph ids differ from the eager body's: "
                                + _first_difference(g["ids"], e["ids"],
                                                    PAGED_ENGINE["block_sizes"]))
    check(g["launches"] == e["launches"],
          f"graphs {label}: launches {g['launches']} with graphs, {e['launches']} eager")
    # Warmup captured every shape: serving only replays.
    check(g["graphs"] == 3 * len(PAGED_ENGINE["block_sizes"]) and g["decode_graph_captures"] == 0
          and g["decode_graph_replays"] == g["decode_blocks"],
          f"graphs {label}: {g['graphs']} graphs after warmup, {g['decode_graph_captures']} "
          f"captured while serving, {g['decode_graph_replays']} replays of "
          f"{g['decode_blocks']} blocks")
    check(e["graphs"] == 0 and e["decode_graph_replays"] == 0,
          f"graphs {label}: the eager run replayed graphs")
    for out in runs.values():
        del out["ids"]
    return {"summary": summary, **runs}


# --------------------------------------------------------------------------- #
# 9. lora kernels
# --------------------------------------------------------------------------- #

# Every LoRA target projection (in, out) of llama-3.2-1b, then llama-3-8b:
# wq / wo, wk / wv, w_gate / w_up, w_down.
LORA_SHAPES = [(2048, 2048), (2048, 512), (2048, 8192), (8192, 2048),
               (4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


def _lora_work(ids, NA, n_in, n_out, R, elt) -> tuple[float, float]:
    """(FLOPs, bytes) of the delta on these ids: 2·R·(in + out) per row
    with an adapter; the distinct adapters' factors, x, the ids and the
    output each moved once (null rows read no factors)."""
    return _lora_group_work(ids, NA, n_in, (n_out,), R, elt)


def _lora_group_work(ids, NA, n_in, outs, R, elt) -> tuple[float, float]:
    """(FLOPs, bytes) of a group of targets that share x: each target's
    factors read once per distinct adapter, x and the ids once for the
    group, each output written once."""
    used = {int(i) for i in ids if 0 < int(i) < NA}
    active = sum(1 for i in ids if 0 < int(i) < NA)
    N = len(ids)
    flops = sum(2.0 * R * (n_in + o) * active for o in outs)
    nbytes = elt * (sum(len(used) * R * (n_in + o) for o in outs) + N * (n_in + sum(outs))) + 4 * N
    return flops, nbytes


# bf16: both sides compute in f32 (bf16 factors widen exactly) and round once
# to bf16, so they may differ by one bf16 step (2^-7 of the value) plus a
# summation-order term of 1e-4 of the largest value.
LORA_REL_BF16, LORA_REL_SUM = 2.0**-7, 1e-4


def _hold_lora_group(x, pairs, ids) -> dict:
    """One B5 launch for targets that share x against lora_delta_plain target
    by target on the same inputs: the error within the stated tolerance,
    null rows exact zeros, the launch allocating nothing but its outputs, a
    second launch bit-identical, and each row (all of them up to 9 rows,
    else four) bit-identical to a launch on it alone."""
    from localai_tpu_torch.ops import lora_matmul as lm

    allocations = torch.cuda.memory_stats()["allocation.all.allocated"]
    outs = lm.lora_bgmv_group(x, pairs, ids)
    torch.cuda.synchronize()
    # One device allocation per output and none else (a byte count would
    # depend on how the caching allocator splits its cached blocks).
    outputs_only = (torch.cuda.memory_stats()["allocation.all.allocated"] - allocations
                    == len(outs))
    host_ids = ids.tolist()
    N = len(host_ids)
    check_rows = range(N) if N <= 9 else (0, 1, N // 2, N - 1)
    alone = {n: lm.lora_bgmv_group(x[n:n + 1], pairs, ids[n:n + 1]) for n in check_rows}
    again = lm.lora_bgmv_group(x, pairs, ids)
    errs, scales, within, null_exact, independent = [], [], True, True, True
    for t, ((a, b), out) in enumerate(zip(pairs, outs)):
        want = lm.lora_delta_plain(x, a, b, ids)
        scale = want.float().abs().max().item()
        err = (out.float() - want.float()).abs()
        within = within and bool(
            (err <= LORA_REL_BF16 * want.float().abs() + LORA_REL_SUM * scale).all()
            and torch.isfinite(out).all())
        null_exact = null_exact and all(bool((out[n] == 0).all())
                                        for n, i in enumerate(host_ids) if i == 0)
        independent = independent and all(torch.equal(out[n:n + 1], alone[n][t])
                                          for n in check_rows)
        errs.append(err.max().item())
        scales.append(scale)
    repeat_equal = all(torch.equal(o, o2) for o, o2 in zip(outs, again))
    ok = within and null_exact and independent and repeat_equal and outputs_only
    return dict(shape=[N, x.shape[1], [b.shape[2] for _, b in pairs]], rank=pairs[0][0].shape[2],
                dtype=str(x.dtype).replace("torch.", ""), ids=host_ids if N <= 9 else None,
                max_abs_err=max(errs), out_max=max(scales), null_exact=null_exact,
                rows_independent=independent, repeat_equal=repeat_equal,
                allocates_outputs_only=outputs_only, ok=ok)


def _hold_lora(x, a, b, ids) -> dict:
    """`_hold_lora_group` for one target, with its shape as [N, in, out]."""
    row = _hold_lora_group(x, [(a, b)], ids)
    row["shape"] = [row["shape"][0], row["shape"][1], row["shape"][2][0]]
    return row


# The served groups of targets that share x, one launch each: llama-3.2-1b
# {wq, wk, wv} and {w_gate, w_up} at lora_http's rank 32, llama-3-8b
# {wq, wv} at lora_8b's rank 16.
LORA_GROUPS = [("1b_qkv", 2048, (2048, 512, 512), 32), ("1b_gate_up", 2048, (8192, 8192), 32),
               ("8b_qv", 4096, (4096, 1024), 16)]


def phase_lora_kernels(gen: torch.Generator) -> tuple[list[dict], list[dict]]:
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv, lora_bgmv_group, lora_delta_plain

    dt = torch.bfloat16
    cases = [(n_in, n_out, R, 9, None) for n_in, n_out in LORA_SHAPES for R in (16, 64)]
    # lora_http's decode block: rank 32 (tenants 6-7 pad the stack), 8 slots
    # over 9 stack rows, at each llama-3.2-1b target shape.
    cases += [(n_in, n_out, 32, 8, None) for n_in, n_out in LORA_SHAPES[:4]]
    cases += [(4096, 4096, 16, 1, None), (4096, 4096, 16, 256, None), (2048, 2048, 32, 9, 8)]
    rows = []
    for n_in, n_out, R, N, small_rank in cases:
        NA = 9  # 8 adapters and the null one
        a = (torch.randn(NA, n_in, R, generator=gen, device="cuda") * 0.05).to(dt)
        b = (torch.randn(NA, R, n_out, generator=gen, device="cuda") * 0.05).to(dt)
        a[0] = 0
        b[0] = 0
        if small_rank:  # a rank-8 adapter zero-padded inside the rank-32 stack
            a[1, :, small_rank:] = 0
            b[1, small_rank:] = 0
        x = torch.randn(N, n_in, generator=gen, device="cuda").to(dt)
        if N == 9:  # 8 distinct adapters and one null row
            ids = torch.tensor([1, 2, 3, 4, 0, 5, 6, 7, 8], dtype=torch.int32, device="cuda")
        elif N == 8:  # 7 tenants and one adapter-less slot
            ids = torch.tensor([8, 1, 0, 6, 3, 2, 7, 5], dtype=torch.int32, device="cuda")
        else:
            ids = (torch.arange(N, device="cuda") % NA).to(torch.int32)
            ids[0] = 1
        row = _hold_lora(x, a, b, ids)
        host_ids = ids.tolist()
        ms = cuda_time_cold_ms(lambda: lora_bgmv(x, a, b, ids), 20)
        plain_ms = cuda_time_cold_ms(lambda: lora_delta_plain(x, a, b, ids), 3)
        # For reference only (not one call computing the same function, and
        # not a route of the port): torch.bmm twice on factors gathered
        # beforehand, in the model dtype.
        idx = ids.long()
        a_sel, b_sel = a[idx], b[idx]
        x3 = x[:, None, :]
        bmm2_ms = cuda_time_cold_ms(lambda: torch.bmm(torch.bmm(x3, a_sel), b_sel), 20)
        del a_sel, b_sel
        bound_ms, bound_by = _bound(*_lora_work(host_ids, NA, n_in, n_out, R, dt.itemsize),
                                    torch.float32)
        row.update(padded_rank=small_rank, ms=ms, plain_ms=plain_ms, bmm2_gathered_ms=bmm2_ms,
                   bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel lora_bgmv] {json.dumps(row)}")
        check(row["ok"], f"lora_bgmv disagrees with its plain version at {row}")
        rows.append(row)
        del a, b
    # A CUDA tensor B5 does not take raises (no other route serves it).
    a = torch.zeros(3, 64, 8, dtype=dt, device="cuda")
    b = torch.zeros(3, 8, 64, dtype=dt, device="cuda")
    for bad_x, bad_ids in ((torch.zeros(2, 64, dtype=torch.float16, device="cuda"),
                            torch.zeros(2, dtype=torch.int32, device="cuda")),
                           (torch.zeros(2, 64, dtype=dt, device="cuda"),
                            torch.tensor([0, 3], dtype=torch.int32))):
        try:
            lora_bgmv(bad_x, a, b, bad_ids)
        except (TypeError, ValueError) as e:
            log(f"[kernel lora_bgmv] refused as it should: {e}")
        else:
            fail("lora_bgmv took a tensor it does not support")
    # One launch per group, at the decode block of 8 slots (7 tenants and an
    # adapter-less slot), from a generator of its own so the rows above see
    # the inputs they always saw. Beside it: the same kernel launched target
    # by target, and the plain version and two bmm calls per target.
    # The timing floor: the same flushed timing of a zero_ on 8 floats, the
    # least any launch reads here (B5's rows sit a few us above it).
    z = torch.zeros(8, device="cuda")
    floor_ms = cuda_time_cold_ms(lambda: z.zero_(), 20)
    log(f"[kernel lora_bgmv] timing floor (zero_ of 8 floats): {floor_ms:.5f} ms")
    gen_group = torch.Generator(device="cuda").manual_seed(9)
    group_rows = []
    for label, n_in, outs, R in LORA_GROUPS:
        NA = 9
        pairs = []
        for n_out in outs:
            a = (torch.randn(NA, n_in, R, generator=gen_group, device="cuda") * 0.05).to(dt)
            b = (torch.randn(NA, R, n_out, generator=gen_group, device="cuda") * 0.05).to(dt)
            a[0] = 0
            b[0] = 0
            pairs.append((a, b))
        x = torch.randn(8, n_in, generator=gen_group, device="cuda").to(dt)
        ids = torch.tensor([8, 1, 0, 6, 3, 2, 7, 5], dtype=torch.int32, device="cuda")
        row = _hold_lora_group(x, pairs, ids)
        ms = cuda_time_cold_ms(lambda: lora_bgmv_group(x, pairs, ids), 20)
        per_target = [cuda_time_cold_ms(lambda a=a, b=b: lora_bgmv(x, a, b, ids), 20)
                      for a, b in pairs]
        plain_ms = cuda_time_cold_ms(
            lambda: [lora_delta_plain(x, a, b, ids) for a, b in pairs], 3)
        idx = ids.long()
        sel = [(a[idx], b[idx]) for a, b in pairs]
        x3 = x[:, None, :]
        bmm2_ms = cuda_time_cold_ms(
            lambda: [torch.bmm(torch.bmm(x3, a_sel), b_sel) for a_sel, b_sel in sel], 20)
        del sel
        bound_ms, bound_by = _bound(*_lora_group_work(ids.tolist(), NA, n_in, outs, R,
                                                      dt.itemsize), torch.float32)
        row.update(group=label, ms=ms, timing_floor_ms=floor_ms, per_target_ms=per_target,
                   per_target_ms_sum=sum(per_target), plain_ms=plain_ms,
                   bmm2_gathered_ms=bmm2_ms, bound_ms=bound_ms, bound_by=bound_by)
        log(f"[kernel lora_bgmv group] {json.dumps(row)}")
        check(row["ok"], f"lora_bgmv_group disagrees with its plain version at {row}")
        group_rows.append(row)
        del pairs
    torch.cuda.empty_cache()
    return rows, group_rows


# --------------------------------------------------------------------------- #
# 10. lora http: llama-3.2-1b tenants through the port's HTTP server
# --------------------------------------------------------------------------- #

LORA_BASE_YAML = {"name": "llama-1b", "model": "llama-3.2-1b", "context_size": 4096,
                  "max_slots": 8, "kv_pages": 256, "kv_page_size": 128,
                  "prefill_chunk": 512, "max_tokens": 64,
                  # Every id decodes to one printable character, so a random
                  # model's stream carries content (a byte tokenizer would
                  # decode ids >= 256 to nothing).
                  "tokenizer": "synthetic-bytes"}


def _write_models_dir(root: str, tenants: bool) -> None:
    """The base YAML and, with `tenants`, 8 virtual models over it whose
    PEFT adapters are written from a numpy seed: tenants 0-5 are the JAX
    bench's LoRA row (rank 16 on q_proj / v_proj, lora_alpha = r), tenants
    6-7 rank 32 on all seven projections. Factors are normal · 0.04, so a
    tenant's delta is a sizeable share of the base product."""
    import yaml

    from localai_tpu_torch.engine.weights import random_lora_adapter
    from localai_tpu_torch.models import get_arch

    with open(f"{root}/llama-1b.yaml", "w") as f:
        yaml.safe_dump(LORA_BASE_YAML, f)
    if not tenants:
        return
    cfg = get_arch(LORA_BASE_YAML["model"])
    every = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    for t in range(8):
        r, targets = (16, ("wq", "wv")) if t < 6 else (32, every)
        random_lora_adapter(cfg, f"{root}/adapters/t{t}", r, r, targets, seed=t, scale=0.04)
        with open(f"{root}/tenant{t}.yaml", "w") as f:
            yaml.safe_dump({"name": f"tenant{t}", "base_model": "llama-1b",
                            "adapter": f"adapters/t{t}", "max_tokens": 64}, f)


def _http(base: str, path: str, payload: dict, t_submit: float) -> dict:
    """POST one request; for a stream, read the SSE frames as they come.
    Returns status, the parsed body or the frames, and the client's TTFT."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            if not payload.get("stream"):
                return {"status": r.status, "body": json.loads(r.read())}
            frames, ttft = [], None
            for line in r:
                line = line.decode().strip()
                if not line.startswith("data: "):
                    continue
                frames.append(line[6:])
                if ttft is None and line[6:] != "[DONE]":
                    c = json.loads(line[6:])["choices"][0]
                    if c.get("text") or (c.get("delta") or {}).get("content"):
                        ttft = time.monotonic() - t_submit
            return {"status": r.status, "frames": frames, "ttft": ttft}
    except urllib.error.HTTPError as e:
        return {"status": e.code, "body": e.read().decode()}


def _lora_requests() -> list[tuple[str, str, dict]]:
    """The measured batch: one request per tenant and 4 to the base, chat
    and completions, half streamed, half greedy (the rest seeded top-p 0.9
    at temperature 0.8), prompts of 20-1500 tokens (the byte tokenizer: one
    token per character), 64 new tokens each. Request 8 repeats request 0's
    greedy prompt on the base."""
    import random

    rnd = random.Random(7)
    lens = [20, 100, 300, 700, 1500, 20, 100, 300, 20, 700, 1500, 300]
    out = []
    for i, n in enumerate(lens):
        model = f"tenant{i}" if i < 8 else "llama-1b"
        text = "".join(rnd.choice("abcdefghijklmnopqrstuvwxyz ") for _ in range(n))
        greedy = i % 2 == 0
        body = {"model": model, "max_tokens": 64, "ignore_eos": True, "stream": i % 4 in (1, 2),
                "temperature": 0.0 if greedy else 0.8, "top_p": 1.0 if greedy else 0.9,
                "seed": 100 + i}
        chat = i % 3 != 2
        if chat:
            body["messages"] = [{"role": "user", "content": text}]
        else:
            body["prompt"] = text
        out.append(("/v1/chat/completions" if chat else "/v1/completions", model, body))
    path0, _m, body0 = out[0]
    out[8] = (path0, "llama-1b", {**body0, "model": "llama-1b"})
    return out


def _http_batch(base: str, reqs) -> tuple[list[dict], float]:
    results: list = [None] * len(reqs)

    def run(i, path, body):
        results[i] = _http(base, path, body, time.monotonic())

    t0 = time.monotonic()
    threads = [threading.Thread(target=run, args=(i, path, body))
               for i, (path, _m, body) in enumerate(reqs)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    check(all(not th.is_alive() for th in threads), "lora_http: a request never finished")
    return results, time.monotonic() - t0


def _check_http_results(label: str, reqs, results) -> tuple[list[str], list[float]]:
    """Every response 200, every stream ends in [DONE], completion tokens =
    the tokens streamed (64). Returns each request's text and the streams'
    TTFTs."""
    texts, ttfts = [], []
    for i, ((_path, _model, body), res) in enumerate(zip(reqs, results)):
        check(res["status"] == 200, f"{label}: request {i} got HTTP {res['status']}: "
                                    f"{res.get('body')}")
        if body["stream"]:
            check(res["frames"][-1] == "[DONE]", f"{label}: stream {i} did not end in [DONE]")
            chunks = [json.loads(f) for f in res["frames"][:-1]]
            check(not any("error" in c for c in chunks), f"{label}: stream {i} errored")
            toks = [c["choices"][0] for c in chunks if c["choices"][0]["finish_reason"] is None
                    and ("text" in c["choices"][0] or "content" in c["choices"][0]["delta"])]
            if "messages" in body:  # the role chunk carries no token
                toks = toks[1:]
            usage = chunks[-1]["usage"]
            text = "".join(c.get("text") or c.get("delta", {}).get("content", "") for c in toks)
            ttfts.append(res["ttft"])
            check(usage["completion_tokens"] == len(toks) == 64,
                  f"{label}: stream {i}: {len(toks)} token chunks, usage {usage}")
        else:
            c = res["body"]["choices"][0]
            text = c["message"]["content"] if "message" in c else c["text"]
            check(res["body"]["usage"]["completion_tokens"] == 64,
                  f"{label}: request {i}: usage {res['body']['usage']}")
        texts.append(text)
    return texts, ttfts


def _start_server(root: str):
    from localai_tpu_torch.config import ApplicationConfig
    from localai_tpu_torch.server import ModelManager, OpenAIApi, Router, create_server

    app = ApplicationConfig(address="127.0.0.1", port=0, models_dir=root)
    manager = ModelManager(app, device="cuda")
    router = Router()
    OpenAIApi(manager).register(router)
    server = create_server(app, router)
    threading.Thread(target=server.serve_forever, daemon=True, name="http").start()
    return manager, server, f"http://127.0.0.1:{server.server_address[1]}"


def _hold_served_lora(eng) -> list[dict]:
    """B5 against its plain version on the served engine's own stacks, at
    the first and last layer of every key, with the decode block's shape:
    one row per slot, ids in the stack's rows (every resident tenant, then
    a block with an adapter-less slot riding the null row). x stands for
    the layer's activations (normal, bf16)."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    S, NA = eng.ecfg.max_slots, eng._lora_tree["wq"]["a"].shape[1]
    blocks = [torch.arange(1, S + 1) % NA, torch.arange(S) % NA]
    rows = []
    for key, ent in sorted(eng._lora_tree.items()):
        for li in (0, eng.cfg.num_layers - 1):
            a, b = ent["a"][li], ent["b"][li]
            for ids in blocks:
                x = torch.randn(S, a.shape[1], generator=gen, device="cuda").to(a.dtype)
                row = _hold_lora(x, a, b, ids.to(device="cuda", dtype=torch.int32))
                row.update(key=key, layer=li)
                check(row["ok"], f"lora_http: B5 on the served stacks disagrees: {row}")
                rows.append(row)
    # The two groups the decode step launches as one: q / k / v, gate / up.
    tree = eng._lora_tree
    for keys in (("wq", "wk", "wv"), ("w_gate", "w_up")):
        for li in (0, eng.cfg.num_layers - 1):
            pairs = [(tree[k]["a"][li], tree[k]["b"][li]) for k in keys]
            for ids in blocks:
                x = torch.randn(S, pairs[0][0].shape[1], generator=gen,
                                device="cuda").to(pairs[0][0].dtype)
                row = _hold_lora_group(x, pairs, ids.to(device="cuda", dtype=torch.int32))
                row.update(key="+".join(keys), layer=li)
                check(row["ok"], f"lora_http: B5 on the served group disagrees: {row}")
                rows.append(row)
    worst = max(rows, key=lambda r: r["max_abs_err"] / max(r["out_max"], 1e-30))
    log(f"[lora_http served stacks] B5 vs plain on {len(rows)} (key, layer, ids) cases, "
        f"all ok; worst relative: {json.dumps(worst)}")
    return rows


def phase_lora_http() -> dict:
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv_group

    reqs = _lora_requests()
    out = {}
    with tempfile.TemporaryDirectory() as root:
        _write_models_dir(root, tenants=True)
        manager, server, base = _start_server(root)
        try:
            # Warm pass: one short request per tenant, so every tenant is
            # promoted and the stacks hold all seven keys at rank 32.
            warm = [("/v1/completions", f"tenant{t}",
                     {"model": f"tenant{t}", "prompt": "warm up", "max_tokens": 4,
                      "temperature": 0.0}) for t in range(8)]
            results, _ = _http_batch(base, warm)
            check(all(r["status"] == 200 for r in results), f"lora_http warm pass: {results}")
            eng = manager.peek("llama-1b").engine
            stacks = {k: list(v["a"].shape) for k, v in eng._lora_tree.items()}
            check(len(stacks) == 7 and all(s[1] == 9 and s[3] == 32 for s in stacks.values()),
                  f"lora_http: stacks after the warm pass {stacks}")
            # The measured batch: counters to 0 just before, read just after.
            m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
            lora_bgmv_group.launches = 0
            results, wall = _http_batch(base, reqs)
            launches = lora_bgmv_group.launches
            m1 = eng.metrics()
            texts, ttfts = _check_http_results("lora_http", reqs, results)
            steps = int(m1["decode_steps"] - m0["decode_steps"])
            L = eng.cfg.num_layers
            # Admissions run no B5: their x is [B, S, D] (3-D), which takes
            # the gather form; prefill chunks carry no LoRA operand. Every
            # decode step runs the delta for all 8 slots (adapter-less and
            # idle slots ride id 0) on the 7 keys of every layer in 4
            # launches: {wq, wk, wv}, wo, {w_gate, w_up}, w_down.
            check(launches == steps * L * 4 and launches > 0,
                  f"lora_http: {launches} B5 launches != {steps} decode steps x {L} layers x 4")
            check(texts[0] != texts[8], "lora_http: tenant0's greedy output equals the base's")
            _check_graphs("lora_http", {k: int(m1[k] - m0[k]) for k in (
                "decode_blocks", "decode_graph_captures", "decode_graph_replays")})
            refs = [int(r) for r in eng._adapter_refs]
            check(not any(refs), f"lora_http: adapter pins left at the end: {refs}")
            dt_s = eng._decode_time - dt0
            out["tenants"] = dict(
                requests=len(reqs), wall_s=wall, ttft_ms_p50=statistics.median(ttfts) * 1e3,
                ttft_ms_max=max(ttfts) * 1e3, decode_tok_s=(eng._decode_tokens - tok0) / dt_s,
                decode_ms_per_step=dt_s / steps * 1e3, e2e_tok_s=64 * len(reqs) / wall,
                decode_steps=steps, admissions=int(m1["admissions"] - m0["admissions"]),
                prefill_chunks=int(m1["prefill_chunks"] - m0["prefill_chunks"]),
                lora_bgmv_launches=launches, adapter_refs=refs,
                adapter_metrics={k: v for k, v in m1.items() if k.startswith("adapter")},
                stacks=stacks)
            log("[lora_http llama-3.2-1b 8 tenants] " + json.dumps(out["tenants"]))
            out["kernel_rows"] = _hold_served_lora(eng)
        finally:
            server.shutdown()
            manager.shutdown()
    # The same 12 requests, all to a fresh base with no tenants registered.
    base_reqs = [(p, "llama-1b", {**b, "model": "llama-1b"}) for p, _m, b in reqs]
    with tempfile.TemporaryDirectory() as root:
        _write_models_dir(root, tenants=False)
        manager, server, base = _start_server(root)
        try:
            _http_batch(base, [("/v1/completions", "llama-1b",
                                {"model": "llama-1b", "prompt": "warm up", "max_tokens": 4})])
            eng = manager.peek("llama-1b").engine
            m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
            lora_bgmv_group.launches = 0
            results, wall = _http_batch(base, base_reqs)
            _texts, ttfts = _check_http_results("lora_http base", base_reqs, results)
            check(lora_bgmv_group.launches == 0 and eng._lora_tree is None,
                  "lora_http base: the tenant-less base ran the LoRA kernel")
            m1 = eng.metrics()
            steps = int(m1["decode_steps"] - m0["decode_steps"])
            dt_s = eng._decode_time - dt0
            out["base"] = dict(requests=len(base_reqs), wall_s=wall,
                               ttft_ms_p50=statistics.median(ttfts) * 1e3,
                               ttft_ms_max=max(ttfts) * 1e3,
                               decode_tok_s=(eng._decode_tokens - tok0) / dt_s,
                               decode_ms_per_step=dt_s / steps * 1e3,
                               e2e_tok_s=64 * len(base_reqs) / wall, decode_steps=steps)
        finally:
            server.shutdown()
            manager.shutdown()
    # Two host-clock readings, neither the kernel's cost alone. The tok/s
    # ratio (the JAX bench's lora_multi_vs_base) depends on scheduling:
    # adapter requests admit alone, so the tenant run decodes at other slot
    # occupancies and takes other step counts than the base. The ms per
    # decode step compares like with like (a step costs about the same at
    # any occupancy) but includes the host's share of each step;
    # profile_engine.py --lora gives the device time per step.
    out["lora_multi_vs_base_tok_s_scheduling_dependent"] = (
        out["tenants"]["decode_tok_s"] / out["base"]["decode_tok_s"])
    out["lora_step_ms_vs_base"] = (out["tenants"]["decode_ms_per_step"]
                                   / out["base"]["decode_ms_per_step"])
    log("[lora_http llama-3.2-1b base, no tenants] " + json.dumps(out["base"])
        + " lora_multi_vs_base (tok/s, scheduling-dependent)="
        + f"{out['lora_multi_vs_base_tok_s_scheduling_dependent']:.3f}"
        + f" decode ms/step tenants vs base={out['lora_step_ms_vs_base']:.3f}")
    torch.cuda.empty_cache()
    return out


# --------------------------------------------------------------------------- #
# 11. lora on llama-3-8b int8, and the small model card vs CPU
# --------------------------------------------------------------------------- #

def phase_lora_8b(qmodel: dict, small, p_small, p_small_cpu) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import random_lora_adapter

    cfg = qmodel["cfg"]
    L = cfg.num_layers
    with tempfile.TemporaryDirectory() as root:
        eng = Engine(cfg, qmodel["int8"], ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(**PAGED_ENGINE))
        for t in range(4):  # rank 16 on q / v / o / down: B5 at 14336 -> 4096
            eng.register_adapter(f"t{t}", random_lora_adapter(
                cfg, f"{root}/t{t}", 16, 16, ("wq", "wv", "wo", "w_down"), seed=10 + t))
        for t in range(4):  # warm pass: every tenant promoted before the run
            _text, ev = eng.generate([1, 2, 3], max_new_tokens=2, adapter=f"t{t}")
            check(ev.kind == "done", f"lora_8b warm pass: {ev}")
        # Tenants admit single-shot (1500 tokens: the dequant route);
        # adapter-less requests of 700 and 3000 tokens chunk.
        plens = [20, 300, 700, 1500, 20, 100, 700, 3000]
        out = _serve(eng, plens, adapters=["t0", "t1", "t2", "t3", None, None, None, None])
        del eng
    log("[lora_8b llama-3-8b int8, 4 tenants] " + json.dumps(out))
    _check_quant_launches("lora_8b", L, out, chunks=(2, 2 + 6))
    _check_graphs("lora_8b", out)
    n = out["launches"]
    # q / v share x (one launch), o and down one each: 3 launches a layer.
    check(n["lora_bgmv"] == out["decode_steps"] * L * 3 and n["lora_bgmv"] > 0,
          f"lora_8b: B5 launches {n['lora_bgmv']} != {out['decode_steps']} decode steps x "
          f"{L} layers x 3 launches (q + v, o, down)")
    check(not any(out["adapter_refs"]), f"lora_8b: pins left {out['adapter_refs']}")
    torch.cuda.empty_cache()

    # The small f32 model, paged, three tenants and one null row: B5 on the
    # card against the plain version on the CPU.
    texts = {}
    with tempfile.TemporaryDirectory() as root:
        dirs = [random_lora_adapter(small, f"{root}/s{t}", 8, 16,
                                    ("wq", "wv", "wo", "w_down", "w_gate")[: 2 + t], seed=20 + t,
                                    scale=0.05) for t in range(3)]
        for dev, p in (("cuda", p_small), ("cpu", p_small_cpu)):
            e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev,
                       engine_cfg=EngineConfig(max_slots=4, max_seq=256, block_sizes=(8,),
                                               kv_pages=16, kv_page_size=64))
            try:
                for t, d in enumerate(dirs):
                    e.register_adapter(f"s{t}", d)
                hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                          max_new_tokens=24, ignore_eos=True, adapter=ad))
                      for n_, m, ad in ((150, 7, "s0"), (3, 1, None), (70, 3, "s1"),
                                        (40, 11, "s2"))]
                texts[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
            finally:
                e.stop()
    log(f"[lora tiny-d64 f32 paged, 3 tenants + null] card greedy ids equal the CPU's: "
        f"{texts['cuda'] == texts['cpu']}")
    check(texts["cuda"] == texts["cpu"], "small LoRA engine: card ids differ from the CPU's")
    return out


# --------------------------------------------------------------------------- #
# 13. moe kernels: B3's expert form at mixtral-8x7b's shapes
# --------------------------------------------------------------------------- #

# (einsum, experts, in, out): gate / up with x shared by the experts, down
# with one x row per expert.
MOE_SHAPES = [("...d,edf->...ef", 8, 4096, 14336), ("...ef,efd->...ed", 8, 14336, 4096)]


def phase_moe_kernels() -> list[dict]:
    """B3's expert form held as phase 3 holds B3 (`_hold_b3`) at every
    form, x dtype and row count of the mixtral path, beside a bf16
    torch.bmm on the dequantized stack (`bf16_ms`: the matmul the quantized
    kernel has to beat) and models/quant.moe_matmul with the kernel route
    off (`dequant_ms`)."""
    from localai_tpu_torch import kernels
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import MOE_SHARED, qmm_moe, qmm_moe_plain, qmm_plan

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows = []
    for sub, E, n_in, n_out in MOE_SHAPES:
        w = torch.randn(E, n_in, n_out, generator=gen, device="cuda") * 0.02
        for form in QMM_FORMS:
            qw = {"int8": quant.quantize_tensor, "grouped_int8": _grouped_int8,
                  "int4": quant.quantize_tensor_g4}[form](w)
            w_bf16 = quant.dequantize_tensor(qw).to(torch.bfloat16)  # [E, in, out]
            for dt in (torch.bfloat16, torch.float32):
                for N in (1, 8, 16, 64, 256):
                    xshape = (N, n_in) if sub == MOE_SHARED else (N, E, n_in)
                    x = torch.randn(xshape, generator=gen, device="cuda").to(dt)
                    xb = x.to(torch.bfloat16)
                    xe = (xb.unsqueeze(0).expand(E, N, n_in) if sub == MOE_SHARED
                          else xb.transpose(0, 1))
                    # Every expert's payload and scales, x and the output, once.
                    flops, wbytes = _qmm_work(form, 1, n_in, n_out, 0)
                    work = (E * N * flops,
                            E * wbytes + dt.itemsize * (x.numel() + N * E * n_out))
                    plan = (qmm_plan(n_in, n_out, N, kernels.sm_count(x.device), E)._asdict()
                            if dt == torch.bfloat16 else None)
                    rows.append(_hold_b3(
                        "quant_matmul_moe", lambda v: qmm_moe(v, qw, sub),
                        lambda v: qmm_moe_plain(v, qw, sub), x, lambda: torch.bmm(xe, w_bf16),
                        lambda v: quant.moe_matmul(v, qw, sub), work, plan,
                        sub=sub, shape=[N, E, n_in, n_out], form=form))
            del qw, w_bf16
        del w
    torch.cuda.empty_cache()
    return rows


# --------------------------------------------------------------------------- #
# 14. mixtral int4, 15. mixtral int8, 16. the small MoE model card vs CPU
# --------------------------------------------------------------------------- #

def _moe_probe(eng) -> dict:
    """The graph-mode engine after its run: the device time of a decode
    step (one replay of the 16-step greedy block's graph over the staged
    controls, all slots idle: the attention walks no pages, every weight
    is still read) against the byte floor of the quantized weights it
    reads, and the wall time of two fused admissions (the kernels' route
    at 1 x 128 rows, the dequantize-then-matmul route at 8 x 512)."""
    eng._stage_block(np.zeros_like(eng.h_active))
    graph = eng._graph_cache[eng._block_key(16, "greedy", 0)][0]
    step_ms = cuda_time_ms(graph.replay, reps=5, warmup=1) / 16
    wbytes = sum(t.numel() * t.element_size() for w in
                 [*eng.params["layers"].values(), eng.params.get("lm_head")]
                 if isinstance(w, dict) for t in w.values())
    admit_ms = {}
    for m, bucket in ((1, 128), (8, 512)):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        eng._warm_admit(m, bucket)
        admit_ms[f"{m}x{bucket}"] = (time.monotonic() - t0) * 1e3
    return dict(device_ms_per_step=step_ms, quantized_weight_bytes=wbytes,
                byte_floor_ms=wbytes / PEAK_BYTES * 1e3, admission_ms=admit_ms)


def phase_mixtral(gen: torch.Generator) -> dict:
    """mixtral-8x7b int4 at full width and depth: the quantized random init,
    a 256-row prefill through the kernels with every MoE layer held to the
    dequantize-then-matmul route on the same input, then phase 12's
    graph-against-eager run with the MoE launch identities and the probe
    above."""
    from localai_tpu_torch.models import get_arch, llama, quant
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    cfg = get_arch("mixtral-8x7b")
    L = cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = quant.init_params_quantized(cfg, seed=0, mode="int4", device="cuda")
    torch.cuda.synchronize()
    init = dict(init_s=time.monotonic() - t0,
                allocated_gib=torch.cuda.memory_allocated() / 2**30,
                peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(f"[mixtral-8x7b int4] random weights made int4 on the card: {json.dumps(init)}")
    toks = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device="cuda")
    lens = torch.tensor([128, 91], device="cuda")
    moe_dense, route = llama._moe_dense, llama._moe_route

    def run(record):
        """The 256-row prefill, recording each MoE layer's (params, input)
        and each router call's top-k ids."""
        layers, sels = [], []

        def dense(cfg_, lp, x):
            layers.append((lp, x))
            return moe_dense(cfg_, lp, x)

        def routing(cfg_, lp, x):
            w, sel = route(cfg_, lp, x)
            sels.append(sel)
            return w, sel

        with swapped(llama, "_moe_dense", dense), swapped(llama, "_moe_route", routing):
            logits = llama.prefill(cfg, params, toks, lens)[0]
        record.update(layers=layers, sels=sels)
        return logits

    kern, deq = {}, {}
    before = (quant.matmul.dequant_calls + quant.moe_matmul.dequant_calls, qmm_moe.launches)
    logits = run(kern)
    routed = quant.matmul.dequant_calls + quant.moe_matmul.dequant_calls - before[0]
    moe_launches = qmm_moe.launches - before[1]
    with _dequant_route():
        ref = run(deq)
    check(bool(torch.isfinite(logits).all()) and logits.shape == (2, cfg.vocab_size),
          "mixtral prefill logits not finite / wrong shape")
    check(routed == 0 and moe_launches == 3 * L,
          f"mixtral int4 prefill: {routed} dequant-route products, {moe_launches} expert launches")
    # Each MoE layer on the same input through both routes (the kernels'
    # input of the free run): the routing is then the same on both sides,
    # and the layers differ by bf16 rounding only (the dequant route rounds
    # the dequantized weights and its group sums of x to bf16).
    layer_err = []
    for lp, x in kern["layers"]:
        y = moe_dense(cfg, lp, x)
        with _dequant_route():
            y_ref = moe_dense(cfg, lp, x)
        layer_err.append((y.float() - y_ref.float()).abs().max().item()
                         / y_ref.float().abs().max().item())
    # The free runs: each route feeds its own layers. Routing is discrete,
    # so once rounding flips a token's top-2 somewhere, that token's path
    # differs from there on; the logits are recorded, not held to a bound.
    live = torch.arange(128, device="cuda")[None, :] < lens[:, None]  # [2, 128]
    flips = [((a != b).any(-1) & live).float().sum().item() / live.sum().item()
             for a, b in zip(kern["sels"], deq["sels"])]
    err, scale = (logits - ref).abs().max().item(), ref.abs().max().item()
    prefill = dict(rows=256, max_abs_err=err, max_abs_logit=scale, dequant_calls=routed,
                   expert_launches=moe_launches,
                   top1_agree=(logits.argmax(-1) == ref.argmax(-1)).float().mean().item(),
                   layer_rel_err_max=max(layer_err), layer_rel_err=layer_err,
                   first_layer_routing_differs=next((i for i, f in enumerate(flips) if f), None),
                   routing_differs_share=flips)
    log(f"[mixtral-8x7b int4] 256-row prefill, kernels vs dequant route: {json.dumps(prefill)}")
    # Every layer, same input, bf16 on both sides: 5 % of the layer's
    # largest output (phase 4's bf16 bound); a wrong kernel errs by the
    # output's own size.
    check(max(layer_err) <= 0.05, f"mixtral int4: an MoE layer's kernel route differs from "
                                  f"the dequant route by {max(layer_err)} of its largest output")
    del logits, ref, kern, deq
    runs = phase_graphs("mixtral-8x7b int4 paged", cfg, params, probe=_moe_probe)
    for mode in ("graph", "eager"):
        _check_quant_launches(f"mixtral {mode}", L, runs[mode], experts=cfg.num_experts)
    _check_graphs("mixtral graph", runs["graph"])
    probe = runs["graph"]["probe"]
    summary = dict(init=init, prefill=prefill, weight_bytes=runs["graph"]["weight_bytes"],
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   b3_per_decode_step=7 * L, expert_launches_per_decode_step=3 * L, **probe,
                   decode_ms_per_step=runs["graph"]["decode_ms_per_step"],
                   decode_tok_s=runs["graph"]["decode_tok_s"],
                   ttft_ms_p50=runs["graph"]["ttft_ms_p50"])
    log(f"[mixtral-8x7b int4 paged] {json.dumps(summary)}")
    del params
    torch.cuda.empty_cache()
    return {"summary": summary, **runs}


MIXTRAL_INT8_LAYERS = 8  # of 32: the int8 run is cut for time


def phase_mixtral_int8() -> dict:
    """mixtral-8x7b int8 (the flat form) at full width, 8 of 32 layers,
    through the paged engine with phase 6's requests."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, quant

    cfg = dataclasses.replace(get_arch("mixtral-8x7b"), num_layers=MIXTRAL_INT8_LAYERS)
    params = quant.init_params_quantized(cfg, seed=1, mode="int8", device="cuda")
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(**PAGED_ENGINE))
    out = _serve(eng, PAGED_PROMPTS)
    del eng, params
    log(f"[mixtral-8x7b int8, {cfg.num_layers} layers] " + json.dumps(out))
    _check_quant_launches("mixtral int8", cfg.num_layers, out, experts=cfg.num_experts)
    _check_graphs("mixtral int8", out)
    torch.cuda.empty_cache()
    return out


def phase_moe_small() -> dict:
    """A small f32 mixtral-family model (head_dim 64, so B1 serves it), its
    paged + chunked engine on the card against the same engine on the CPU:
    unquantized experts (the exact top-k route) and int4 (B3's expert form,
    the f32 kernel). Greedy ids must be equal."""
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.models import get_arch, llama
    from localai_tpu_torch.ops.quant_matmul import qmm_moe

    small = dataclasses.replace(get_arch("tiny-moe"), name="tiny-moe-d64", hidden_size=256,
                                intermediate_size=512, num_heads=4, num_kv_heads=2,
                                dtype="float32")
    p_cpu = llama.init_params(small, seed=2, device="cpu")
    p_gpu = {k: ({n: t.cuda() for n, t in v.items()} if isinstance(v, dict) else v.cuda())
             for k, v in p_cpu.items()}
    out = {}
    for mode in ("", "int4"):
        texts = {}
        for dev, p in (("cuda", p_gpu), ("cpu", p_cpu)):
            before = qmm_moe.launches
            e = Engine(small, p, ByteTokenizer(small.vocab_size), device=dev, quantization=mode,
                       engine_cfg=EngineConfig(max_slots=2, max_seq=256, block_sizes=(8,),
                                               kv_pages=16, kv_page_size=64, prefill_chunk=64))
            try:
                hs = [e.submit(GenRequest(prompt_ids=[(j * m) % 250 + 1 for j in range(n_)],
                                          max_new_tokens=24, ignore_eos=True))
                      for n_, m in ((150, 7), (3, 1), (70, 3), (200, 11))]
                texts[dev] = [[ev.token_id for ev in h if ev.kind == "token"] for h in hs]
            finally:
                e.stop()
            if dev == "cuda":
                out[f"{mode or 'plain'}_expert_launches"] = qmm_moe.launches - before
        equal = texts["cuda"] == texts["cpu"]
        out[f"{mode or 'plain'}_ids_equal"] = equal
        log(f"[engine tiny-moe-d64 f32 {mode or 'unquantized'}] card greedy ids equal the "
            f"CPU's: {equal}")
        check(equal, f"small MoE engine {mode or 'unquantized'}: card ids differ from the CPU's")
    check(out["plain_expert_launches"] == 0 and out["int4_expert_launches"] > 0,
          f"small MoE engine: expert-form launches {out}")
    return out


def _compact(row: dict, keys) -> dict:
    return {k: row[k] for k in keys}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    t_start = time.monotonic()
    seconds = {}

    def timed(label, fn, *args, **kw):
        t0 = time.monotonic()
        out = fn(*args, **kw)
        seconds[label] = round(time.monotonic() - t0, 1)
        log(f"[phase {label}] {seconds[label]}s")
        return out

    name, smi = timed("device", phase_device)
    usage = timed("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = timed("flash_kernels", phase_kernels, gen)
    paged_rows = timed("paged_kernels", phase_paged_kernels, gen)
    b3_rows, b4_rows = timed("quant_kernels", phase_quant_kernels, gen)
    model = timed("model", phase_model, gen)
    dense = timed("engine", phase_engine, model["cfg"], model["params"])
    paged = timed("paged_engine", phase_paged_engine, model["cfg"], model["params"],
                  model["small"], model["p_small"])
    graphs_1b = timed("graphs_1b", phase_graphs, "llama-3.2-1b paged, 8 layers",
                      model["cfg"], model["params"])
    del model["params"]
    torch.cuda.empty_cache()
    long_context = timed("long_context", phase_long_context)
    qmodel = timed("quant_model", phase_quant_model, gen)
    qruns = timed("quant_engines", phase_quant_engines, qmodel, model["small"],
                  model["p_small"], model["p_small_cpu"])
    graphs_8b = timed("graphs_8b", phase_graphs, "llama-3-8b int4 + fp8 paged", qmodel["cfg"],
                      qmodel["int4"], kv_cache_dtype="fp8", kv_scale=2.0)
    lora_rows, lora_groups = timed("lora_kernels", phase_lora_kernels, gen)
    lora_http = timed("lora_http", phase_lora_http)
    lora_8b = timed("lora_8b", phase_lora_8b, qmodel, model["small"], model["p_small"],
                    model["p_small_cpu"])
    del qmodel, model
    gc.collect()
    torch.cuda.empty_cache()  # mixtral's 35 GB of int4 weights come next
    moe_rows = timed("moe_kernels", phase_moe_kernels)
    mixtral = timed("mixtral", phase_mixtral, gen)
    mixtral_int8 = timed("mixtral_int8", phase_mixtral_int8)
    moe_small = timed("moe_small", phase_moe_small)
    runs = {"dense_engine": dense, "paged_engine": paged, **qruns, "lora_8b_int8": lora_8b,
            "graphs_1b": graphs_1b["graph"], "graphs_1b_eager": graphs_1b["eager"],
            "graphs_8b": graphs_8b["graph"], "graphs_8b_eager": graphs_8b["eager"],
            "mixtral_int4": mixtral["graph"], "mixtral_int4_eager": mixtral["eager"],
            "mixtral_int8_8_layers": mixtral_int8,
            "long_context_flat": long_context["flat"],
            "long_context_hier_spill": long_context["hier_spill"]}
    by_path = {k: {path: out["launches"][k] for path, out in runs.items()}
               for k in ("flash_prefill", "paged_attention", "quant_matmul", "quant_matmul_moe",
                         "quant_unembed", "lora_bgmv")}
    by_path["lora_bgmv"]["lora_http"] = lora_http["tenants"]["lora_bgmv_launches"]
    # The main shape of B1: llama-3.2-1b's 8 x 2048 admission with every row
    # at full length, so the kernel, SDPA and the bound count the same work.
    main_row = next(r for r in rows if r["shape"] == [8, 2048, 32, 8, 64]
                    and r["dtype"] == "bfloat16" and r["library_same_work"])
    ragged_row = next(r for r in rows if r["shape"] == [8, 2048, 32, 8, 64]
                      and r["dtype"] == "bfloat16" and not r["library_same_work"])
    flash_record = {
        "name": "flash_prefill",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "localai_tpu/ops/flash.py:41",
        "tpu_kernel": "localai_tpu/ops/flash.py::_flash_kernel",
        "launches": sum(by_path["flash_prefill"].values()),
        "launches_by_path": by_path["flash_prefill"],
        "shape": main_row["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in rows if r["dtype"] == "bfloat16"),
        "tol": main_row["tol"],
        "ok": all(r["ok"] for r in rows),
        "ms": main_row["ms"],
        "kernel_ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library_same_work": main_row["library_same_work"],
        # The same shape with the engine's ragged lengths (SDPA not comparable).
        "ragged": _compact(ragged_row, ("shape", "lengths", "ms", "plain_ms", "bound_ms")),
        "shapes": rows,
    }
    # The main shape of B2: llama-3.2-1b paged decode, 8 slots, D = 64; its
    # long-context forms are the rows with a "form".
    paged_main = paged_rows[0]
    long_rows = [r for r in paged_rows if "form" in r]
    paged_record = {
        "name": "paged_attention",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/paged_attention.cu",
        "replaces": "localai_tpu/ops/paged_flash.py:78",
        "tpu_kernel": "localai_tpu/ops/paged_flash.py::_ragged_paged_kernel",
        "launches": sum(by_path["paged_attention"].values()),
        "launches_by_path": by_path["paged_attention"],
        "shape": {k: paged_main[k] for k in ("shape", "B", "H", "K", "QR", "D", "page", "MP")},
        "max_abs_err": max(r["max_abs_err"] for r in paged_rows),
        "tol": paged_main["tol"],
        "ok": all(r["ok"] for r in paged_rows),
        "ms": paged_main["ms"],
        "kernel_ms": paged_main["ms"],
        "plain_ms": paged_main["plain_ms"],
        "bound_ms": paged_main["bound_ms"],
        "bound_by": paged_main["bound_by"],
        "library_ms": None,  # no one PyTorch call computes partials over a page table
        "bound_basis": paged_main["bound_basis"],
        "repeat_equal": all(r["repeat_equal"] for r in paged_rows),
        "alone_equal": all(r["alone_equal"] for r in paged_rows),
        # ptxas: registers, spill bytes, static shared memory of each instance.
        "ptxas": [r for r in usage["paged_attention"] if "paged_" in r["kernel"]],
        # The hierarchical (l1, l0) tables and the sink + window skip: each
        # form's times against its bound, its plain version and the same
        # slots walked in full, and the 130k-token engine runs.
        "long_context": {
            "forms": [_compact(r, ("shape", "form", "B", "QR", "MP", "span", "sink", "swin",
                                   "visited_rows", "ms", "plain_ms", "full_walk_ms",
                                   "bound_ms", "bound_by", "library_ms", "max_abs_err",
                                   "hier_equal_flat", "spilled_equal_hot"))
                      for r in long_rows],
            "hier_equal_flat": all(r["hier_equal_flat"] for r in long_rows),
            "spilled_equal_hot": all(r["spilled_equal_hot"] for r in long_rows),
            "engine": long_context["summary"],
        },
        "shapes": paged_rows,
    }
    # The main shape of B3: llama-3-8b's w_gate at a decode block of 8 slots,
    # int4 weights, bf16 x.
    b3_main = next(r for r in b3_rows if r["shape"] == [8, 4096, 14336]
                   and r["form"] == "int4" and r["dtype"] == "bfloat16")
    quant_record = {
        "name": "quant_matmul",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:109",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_qmm_kernel",
        "launches": sum(by_path["quant_matmul"].values()),
        "launches_by_path": by_path["quant_matmul"],
        "shape": {"N": 8, "in": 4096, "out": 14336, "form": "int4", "dtype": "bfloat16"},
        "max_abs_err": b3_main["max_abs_err"],
        "tol": "f32 x: 1e-4 x max|out|; bf16 x: 2^-7 x |out| + 1e-4 x max|out|",
        "ok": all(r["ok"] for r in b3_rows),
        "ms": b3_main["ms"],
        "kernel_ms": b3_main["ms"],
        "plain_ms": b3_main["plain_ms"],
        "bound_ms": b3_main["bound_ms"],
        "bound_by": b3_main["bound_by"],
        "bf16_ms": b3_main["bf16_ms"],
        "dequant_ms": b3_main["dequant_ms"],
        "library_ms": None,  # no one PyTorch call takes the packed int8 / int4 layouts
        "repeat_equal": all(r["repeat_equal"] for r in b3_rows),
        "rows_alone_equal": all(r["rows_alone_equal"] is not False for r in b3_rows),
        # ptxas: registers, spill bytes, static shared memory of each instance
        # (the tensor-core instances take their ring as dynamic shared memory).
        "ptxas": [r for r in usage["quant_matmul"] if "qmm" in r["kernel"]],
        # Every shape's full row is in the log above; here the times only.
        "shapes": [_compact(r, ("shape", "form", "dtype", "ms", "bf16_ms", "dequant_ms",
                                "bound_ms"))
                   for r in b3_rows],
    }
    # The main shape of B3's expert form: mixtral-8x7b's gate at a decode
    # block of 8 slots, int4 experts, bf16 x.
    moe_main = next(r for r in moe_rows if r["shape"] == [8, 8, 4096, 14336]
                    and r["form"] == "int4" and r["dtype"] == "bfloat16")
    moe_record = {
        "name": "quant_matmul_moe",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:109",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_qmm_kernel (expert grid, "
                      "_plain_moe_mm :281)",
        "kernel": "qmm_mma_kernel<FORM, MT, NT> / qmm_kernel<float, RT, FORM> with the "
                  "expert axis (ops/quant_matmul.qmm_moe)",
        "launches": sum(by_path["quant_matmul_moe"].values()),
        "launches_by_path": {k: v for k, v in by_path["quant_matmul_moe"].items() if v},
        "shape": {"N": 8, "E": 8, "in": 4096, "out": 14336, "form": "int4",
                  "dtype": "bfloat16", "einsum": "...d,edf->...ef"},
        "max_abs_err": moe_main["max_abs_err"],
        "tol": "f32 x: 1e-4 x max|out|; bf16 x: 2^-7 x |out| + 1e-4 x max|out|",
        "ok": all(r["ok"] for r in moe_rows),
        "ms": moe_main["ms"],
        "kernel_ms": moe_main["ms"],
        "plain_ms": moe_main["plain_ms"],
        "bound_ms": moe_main["bound_ms"],
        "bound_by": moe_main["bound_by"],
        "bf16_ms": moe_main["bf16_ms"],
        "dequant_ms": moe_main["dequant_ms"],
        "library_ms": None,  # no one PyTorch call takes the packed int8 / int4 expert stacks
        "repeat_equal": all(r["repeat_equal"] for r in moe_rows),
        "rows_alone_equal": all(r["rows_alone_equal"] is not False for r in moe_rows),
        # The same nine tensor-core and six scalar instances as quant_matmul's
        # record: the expert axis is one more argument, not another instance.
        "ptxas": [r for r in usage["quant_matmul"] if "qmm" in r["kernel"]],
        "mixtral": mixtral["summary"],
        "moe_small": moe_small,
        "shapes": [_compact(r, ("sub", "shape", "form", "dtype", "ms", "bf16_ms", "dequant_ms",
                                "bound_ms"))
                   for r in moe_rows],
    }
    b4_main = next(r for r in b4_rows if r["shape"] == [8, 128256, 4096]
                   and r["dtype"] == "bfloat16")
    unembed_record = {
        "name": "quant_unembed",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/quant_matmul.cu",
        "replaces": "localai_tpu/ops/quant_matmul.py:168",
        "tpu_kernel": "localai_tpu/ops/quant_matmul.py::_unembed_kernel",
        "launches": sum(by_path["quant_unembed"].values()),
        "launches_by_path": by_path["quant_unembed"],
        "shape": {"N": 8, "V": 128256, "D": 4096, "dtype": "bfloat16"},
        "max_abs_err": b4_main["max_abs_err"],
        "tol": "1e-4 x max|logit| (f32 on both sides)",
        "ok": all(r["ok"] for r in b4_rows),
        "ms": b4_main["ms"],
        "kernel_ms": b4_main["ms"],
        "plain_ms": b4_main["plain_ms"],
        "bound_ms": b4_main["bound_ms"],
        "bound_by": b4_main["bound_by"],
        "bf16_ms": b4_main["bf16_ms"],
        "bound_frac": b4_main["bound_frac"],
        "library_ms": None,  # no one PyTorch call takes an int8 head with its scales
        # bf16 h: unembed_mma_kernel<NT> by ops/quant_matmul.qunembed_plan;
        # f32 h: the scalar unembed_kernel<RT>.
        "plan": b4_main["plan"],
        "repeat_equal": all(r["repeat_equal"] for r in b4_rows),
        "rows_independent": all(r["rows_alone_equal"] is not False for r in b4_rows),
        # ptxas: registers, spill bytes, static shared memory of each instance
        # (the tensor-core instances take h as dynamic shared memory).
        "ptxas": [r for r in usage["quant_matmul"] if "unembed" in r["kernel"]],
        "shapes": b4_rows,
    }
    # The main shape of B5: llama-3.2-1b's wq (2048 -> 2048) at rank 16 over
    # 8 slots' adapters and a null row, bf16.
    lora_main = next(r for r in lora_rows if r["shape"] == [9, 2048, 2048] and r["rank"] == 16)
    served = lora_http["kernel_rows"]
    lora_record = {
        "name": "lora_bgmv",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/lora_matmul.cu",
        "replaces": "localai_tpu/ops/lora_matmul.py:105",
        "tpu_kernel": "localai_tpu/ops/lora_matmul.py::_lora_kernel",
        # One launch of lora_group_kernel per group of 1-3 targets sharing x
        # (shrink and expand inside it, one thread-block cluster per segment
        # and target); the launches are the grouped calls.
        "kernel": "lora_group_kernel<x, factors> (ops/lora_matmul.lora_bgmv_group)",
        "launches": sum(by_path["lora_bgmv"].values()),
        "launches_by_path": {k: v for k, v in by_path["lora_bgmv"].items() if v},
        "shape": {"N": 9, "in": 2048, "out": 2048, "R": 16, "dtype": "bfloat16"},
        "max_abs_err": max(r["max_abs_err"] for r in lora_rows + lora_groups + served),
        "tol": "bf16: 2^-7 x |out| + 1e-4 x max|out| (f32 on both sides, one bf16 rounding)",
        "ok": all(r["ok"] for r in lora_rows + lora_groups + served),
        "rows_independent": all(r["rows_independent"] for r in lora_rows + lora_groups + served),
        "repeat_equal": all(r["repeat_equal"] for r in lora_rows + lora_groups + served),
        "allocates_outputs_only": all(r["allocates_outputs_only"]
                                      for r in lora_rows + lora_groups + served),
        # lora_http's own stacks (rank 32, 9 rows) at its decode block's ids.
        "served_stacks": {"cases": len(served),
                          "max_abs_err": max(r["max_abs_err"] for r in served)},
        "ms": lora_main["ms"],
        "kernel_ms": lora_main["ms"],
        "plain_ms": lora_main["plain_ms"],
        "bound_ms": lora_main["bound_ms"],
        "bound_by": lora_main["bound_by"],
        # For reference only: torch.bmm twice on factors gathered beforehand
        # (two calls, not one computing the same function).
        "bmm2_gathered_ms": lora_main["bmm2_gathered_ms"],
        # The same flushed timing of a zero_ on 8 floats: the floor under any launch.
        "timing_floor_ms": lora_groups[0]["timing_floor_ms"],
        "library_ms": None,  # no one PyTorch call computes a per-row gathered delta
        # ptxas: registers, spill bytes, static shared memory of each instance.
        "ptxas": [r for r in usage["lora_matmul"] if "lora_group_kernel" in r["kernel"]],
        "shapes": [_compact(r, ("shape", "rank", "padded_rank", "ms", "plain_ms",
                                "bmm2_gathered_ms", "bound_ms", "max_abs_err"))
                   for r in lora_rows],
        "groups": [_compact(r, ("group", "shape", "rank", "ms", "per_target_ms_sum", "plain_ms",
                                "bmm2_gathered_ms", "bound_ms", "max_abs_err"))
                   for r in lora_groups],
    }
    log(f"[phases] {json.dumps(seconds)}")
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": [flash_record, paged_record, quant_record, moe_record,
                                  unembed_record, lora_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
