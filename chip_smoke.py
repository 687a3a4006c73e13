"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device  — the card's name, count and power limit; which optional
   packages this machine has (for planning later slices);
2. build   — nvcc builds every kernel library from localai_tpu_torch/csrc
   (one process per source, all at once) and prints what ptxas reports;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with CUDA-event times of the kernel, the
   plain version, one PyTorch library call computing the same function
   (where one exists), and the least time the card could take (bound):
   B1 flash prefill at the admission shapes, B2 ragged paged attention at
   the paged decode and chunked-prefill shapes;
4. model   — a small f32 model on the card against the same model on the
   CPU (logits, 16 greedy decode steps), dense and paged (chunked prefill
   into pages, paged decode), then full-width llama-3.2-1b in bf16 with
   seeded random weights: prefill logits through the kernel against the
   same call through plain attention;
5. engine  — the dense serving engine (submit → fused admission → decode
   blocks → streamed events) answers mixed requests on llama-3.2-1b;
6. paged engine — the same model on a paged KV pool with chunked prefill
   (long prompts chunk, decode blocks run between chunks), then the small
   f32 model's paged engine against its dense engine.
In 5 and 6 the kernel launch counters, zeroed just before each run, show
that the path went through the kernels.

The last lines are the kernels' JSON record, the card's `nvidia-smi` name
and power limit, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys
import threading
import time

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

def phase_build() -> None:
    from localai_tpu_torch import kernels

    t0 = time.monotonic()
    logs = kernels.build()
    log(f"[build] {len(logs)} librar{'y' if len(logs) == 1 else 'ies'} in "
        f"{time.monotonic() - t0:.1f}s with {kernels.nvcc_path()}")
    for name, out in logs.items():
        for line in out.splitlines():
            if "ptxas info" in line and ("Used" in line or "Compiling" in line):
                log(f"[build:{name}] {line.strip()}")
        check(kernels.library_path(name).exists(), f"library {name} missing after build")


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
    shapes = [  # (B, S, H, K, D, dtype): llama-3.2-1b admissions, then D=128
        (1, 128, 32, 8, 64, torch.bfloat16),
        (8, 128, 32, 8, 64, torch.bfloat16),
        (1, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 64, torch.bfloat16),
        (8, 2048, 32, 8, 128, torch.bfloat16),
        (2, 256, 32, 8, 64, torch.float32),
    ]
    rows = []
    for B, S, H, K, D, dt in shapes:
        q = torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
        k = torch.randn(B, S, K, D, generator=gen, device="cuda").to(dt)
        v = torch.randn(B, S, K, D, generator=gen, device="cuda").to(dt)
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
        lens[0] = S  # one full row, one single-token row, the rest ragged
        if B > 1:
            lens[1] = 1
        out = flash_prefill_attention(q, k, v, lens)
        torch.cuda.synchronize()
        ref = flash_prefill_attention_plain(q, k, v, lens)
        err = (out.float() - ref.float()).abs().max().item()
        host_lens = lens.tolist()
        pad_zero = all(bool((out[b, n:] == 0).all()) for b, n in enumerate(host_lens))
        reps = 20 if S <= 256 else 5
        ms = cuda_time_ms(lambda: flash_prefill_attention(q, k, v, lens), reps)
        plain_ms = cuda_time_ms(lambda: flash_prefill_attention_plain(q, k, v, lens), max(2, reps // 4))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_time_ms(
            lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True),
            reps)
        flops, nbytes = _attention_work(B, S, H, K, D, host_lens, dt)
        t_ops, t_bytes = flops / PEAK_FLOPS[dt] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=[B, S, H, K, D], dtype=str(dt).replace("torch.", ""),
                   lengths=host_lens, max_abs_err=err, tol=tols[dt],
                   ok=err <= tols[dt] and pad_zero and bool(torch.isfinite(out).all()),
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes")
        log(f"[kernel flash_prefill] {json.dumps(row)}")
        check(row["ok"], f"flash_prefill disagrees with its plain version at {row['shape']} "
                         f"{row['dtype']}: err {err} (tol {tols[dt]}), padded rows zero={pad_zero}")
        rows.append(row)
    return rows


def _paged_work(qpos, limits, K, D, MP, page, elt, window) -> tuple[float, float]:
    """(FLOPs, bytes) the paged-partials function needs on this data: QKᵀ
    and PV over the unmasked (row, key) pairs; the live K/V rows (each
    slot's min(limit, MP·page)) read once, q rows, table, limits and query
    positions read once, acc, m and l written once."""
    import numpy as np

    B, QR = qpos.shape
    lim = np.minimum(np.maximum(limits, 0), MP * page)
    if window:
        g = np.arange(int(lim.max()) if B else 0)
        pairs = sum(int(((g[None, :] < lim[b]) & (qpos[b][:, None] - g[None, :] < window)).sum())
                    for b in range(B))
    else:
        pairs = int(QR * lim.sum())
    flops = 4.0 * D * K * pairs
    nbytes = (2 * elt * int(lim.sum()) * K * D + 4 * B * K * QR * D + 4 * B * MP + 4 * B
              + 4 * B * QR + 4 * B * K * QR * (D + 2))
    return flops, nbytes


def phase_paged_kernels(gen: torch.Generator) -> list[dict]:
    import numpy as np

    from localai_tpu_torch.ops.paged_flash import paged_partials_plain, paged_partials_rows

    # Both sides compute in f32 (bf16 pool rows widen exactly): the
    # tolerance covers summation order over up to 4096 rows.
    tol = 2e-4
    # (name, B, G, T, K, D, page, MP, pool dtype, limits, softcap, window):
    # llama-3.2-1b paged decode (H=32, K=8: G=4 query rows per kv head) at
    # D 64 and 128, one 512-token prefill chunk at offset 1536, and a small
    # f32 shape with softcap and a sliding window.
    shapes = [
        ("decode", 8, 4, 1, 8, 64, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("decode", 8, 4, 1, 8, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("prefill_chunk", 1, 4, 512, 8, 64, 128, 32, torch.bfloat16, [1536], 0.0, 0),
        ("decode_softcap_window", 3, 2, 1, 2, 64, 16, 8, torch.float32, [100, 37, 0], 30.0, 40),
    ]
    rows = []
    for name, B, G, T, K, D, page, MP, dt, limits, softcap, window in shapes:
        QR = G * T
        P = B * MP + 1
        if limits == "ragged":  # one full slot, one idle slot, the rest random
            limits = torch.randint(1, MP * page + 1, (B,), generator=gen, device="cuda").tolist()
            limits[0], limits[1] = MP * page, 0
        lim = torch.tensor(limits, dtype=torch.int32, device="cuda")
        qr = torch.randn(B, K, QR, D, generator=gen, device="cuda") / D**0.5
        kp = torch.randn(P, page, K, D, generator=gen, device="cuda").to(dt)
        vp = torch.randn(P, page, K, D, generator=gen, device="cuda").to(dt)
        # A random permutation of the pool's pages (SCRATCH, the last, unused).
        table = torch.randperm(P - 1, generator=gen, device="cuda")[: B * MP]
        table = table.reshape(B, MP).to(torch.int32).contiguous()
        qpos = (lim[:, None] + torch.arange(QR, device="cuda")[None, :] // G).to(torch.int32)
        args = (qr, qpos, kp, vp, table, lim, softcap, window)
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
        ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
        plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 3)
        elt = torch.finfo(dt).bits // 8
        flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), K, D, MP, page,
                                    elt, window)
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, B=B, H=G * K, K=K, QR=QR, D=D, page=page, MP=MP,
                   pool_dtype=str(dt).replace("torch.", ""), limits=limits, softcap=softcap,
                   window=window, max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
                   idle_exact=idle_exact,
                   ok=max(o_err, m_err, l_rel) <= tol and idle_exact
                   and bool(torch.isfinite(acc).all()),
                   ms=ms, plain_ms=plain_ms, library_ms=None,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   bound_basis="FLOPs over the f32 rate (q rows are f32), bytes over HBM")
        log(f"[kernel paged_attention] {json.dumps(row)}")
        check(row["ok"], f"paged_attention disagrees with its plain version at {name} "
                         f"D={D} {row['pool_dtype']}: acc/l err {o_err}, m err {m_err}, "
                         f"l rel err {l_rel} (tol {tol}), idle exact={idle_exact}")
        rows.append(row)
    return rows


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
    # the kernel against the same call through the dense attention.
    cfg = get_arch("llama-3.2-1b")
    t0 = time.monotonic()
    params = llama.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    log(f"[model llama-3.2-1b] random bf16 weights in {time.monotonic() - t0:.1f}s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    B, S = 2, 512
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen, device="cuda")
    lens = torch.tensor([S, 300], device="cuda")
    logits, ks, vs = llama.prefill(cfg, params, toks, lens)
    os.environ["LOCALAI_FLASH"] = "0"
    ref, rks, rvs = llama.prefill(cfg, params, toks, lens)
    del os.environ["LOCALAI_FLASH"]
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    top1 = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    check(bool(torch.isfinite(logits).all()) and logits.shape == (B, cfg.vocab_size),
          "llama-3.2-1b prefill logits not finite / wrong shape")
    ids = _greedy_decode(cfg, params, logits, ks, vs, lens, 16, "cuda")
    ref_ids = _greedy_decode(cfg, params, ref, rks, rvs, lens, 16, "cuda")
    agree = sum(a == b for x, y in zip(ids, ref_ids) for a, b in zip(x, y)) / (16 * B)
    log(f"[model llama-3.2-1b bf16] kernel vs dense prefill: logits max_abs_err={err:.4f} "
        f"(max |logit| {scale:.3f}), top-1 agreement={top1:.2f}, greedy ids over 16 steps "
        f"agree {agree:.2f}; kernel-path ids row0={[x[0] for x in ids]}")
    # bf16 activations through 16 layers: the two attentions round at
    # different places; allow 5% of the largest logit.
    check(err <= 0.05 * scale, f"llama-3.2-1b prefill logits differ by {err} (max {scale})")
    return {"params": params, "cfg": cfg, "small": small, "p_small": p_gpu}


# --------------------------------------------------------------------------- #
# 5. engine, 6. paged engine
# --------------------------------------------------------------------------- #

def _serve(eng, plens: list[int], max_new: int = 64) -> dict:
    """Submit one request per prompt length (half greedy, half seeded top-p)
    and stream them all; the kernel counters go to 0 just before the run
    and are read just after it."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.ops.flash import flash_prefill_attention
    from localai_tpu_torch.ops.paged_flash import paged_partials_rows

    gen = torch.Generator().manual_seed(3)
    reqs = []
    for i, n in enumerate(plens):
        ids = torch.randint(0, 256, (n,), generator=gen).tolist()
        sampled = i % 2 == 1
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=max_new, ignore_eos=True,
                               temperature=0.8 if sampled else 0.0,
                               top_p=0.9 if sampled else 1.0, seed=100 + i))
    results: list = [None] * len(reqs)

    def consume(i, handle, t_submit):
        first, evs = None, []
        for ev in handle:
            if ev.kind == "token" and first is None:
                first = time.monotonic() - t_submit
            evs.append(ev)
        results[i] = (first, evs)

    # The main path's run: counts go to 0 just before, are read just after.
    flash_prefill_attention.launches = 0
    paged_partials_rows.launches = 0
    t0 = time.monotonic()
    threads = []
    for i, r in enumerate(reqs):
        h = eng.submit(r)
        th = threading.Thread(target=consume, args=(i, h, time.monotonic()))
        th.start()
        threads.append(th)
    for th in threads:
        th.join(timeout=600)
    wall = time.monotonic() - t0
    launches = {"flash_prefill": flash_prefill_attention.launches,
                "paged_attention": paged_partials_rows.launches}
    metrics = eng.metrics()
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
    return dict(requests=len(reqs), completion_tokens=completion, wall_s=wall,
                ttft_ms_p50=statistics.median(ttfts) * 1e3, ttft_ms_max=max(ttfts) * 1e3,
                decode_tok_s=metrics["tokens_per_second"], e2e_tok_s=completion / wall,
                admissions=int(metrics["admissions"]),
                decode_blocks=int(metrics["decode_blocks"]),
                decode_steps=int(metrics["decode_steps"]),
                prefill_chunks=int(metrics["prefill_chunks"]),
                prefill_chunks_interleaved=int(metrics["prefill_chunks_interleaved"]),
                chunked_admits=int(metrics["chunked_admits"]),
                kv_pages_peak=int(metrics["kv_pages_peak"]),
                kv_preemptions=int(metrics["kv_preemptions"]),
                launches=launches)


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
    log("[engine llama-3.2-1b dense] " + json.dumps(out))
    return out


def phase_paged_engine(cfg, params, small, p_small) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer

    # 16-step blocks keep each short request decoding across several
    # blocks, so chunks run between decode blocks.
    ecfg = EngineConfig(max_slots=8, max_seq=4096, kv_pages=256, kv_page_size=128,
                        prefill_chunk=512, block_sizes=(16, 4, 1))
    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda", engine_cfg=ecfg)
    # Prompts over 512 tokens chunk; the short ones decode between chunks.
    out = _serve(eng, [20, 100, 300, 700, 1500, 3000, 20, 100, 300, 3500])
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
    log("[engine llama-3.2-1b paged] " + json.dumps(out))

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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    t_start = time.monotonic()
    name, smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    paged_rows = phase_paged_kernels(gen)
    model = phase_model(gen)
    dense = phase_engine(model["cfg"], model["params"])
    paged = phase_paged_engine(model["cfg"], model["params"], model["small"], model["p_small"])
    by_path = {k: {"dense_engine": dense["launches"][k], "paged_engine": paged["launches"][k]}
               for k in ("flash_prefill", "paged_attention")}
    main_row = next(r for r in rows if r["shape"] == [8, 2048, 32, 8, 64])
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
        "shapes": rows,
    }
    # The main shape of B2: llama-3.2-1b paged decode, 8 slots, D = 64.
    paged_main = paged_rows[0]
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
        "shapes": paged_rows,
    }
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": [flash_record, paged_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
