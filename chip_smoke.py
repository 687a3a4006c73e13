"""Smoke run of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Phases, each of which must pass (the script exits non-zero otherwise):

1. device  — the card's name, count and power limit; which optional
   packages this machine has (for planning later slices);
2. build   — nvcc builds every kernel library from localai_tpu_torch/csrc
   (one process per source, all at once) and prints what ptxas reports;
3. kernels — each kernel against its plain PyTorch version on the card, at
   the serving path's shapes, with CUDA-event times of the kernel, the
   plain version, one PyTorch library call computing the same function,
   and the least time the card could take (bound);
4. model   — a small f32 model on the card against the same model on the
   CPU (logits, 16 greedy decode steps), then full-width llama-3.2-1b in
   bf16 with seeded random weights: prefill logits through the kernel
   against the same call through plain attention;
5. engine  — the serving engine (submit → fused admission → decode blocks
   → streamed events) answers mixed requests on llama-3.2-1b; the kernel
   launch counters, zeroed just before, show the path went through the
   kernels.

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
    return {"params": params, "cfg": cfg}


# --------------------------------------------------------------------------- #
# 5. engine
# --------------------------------------------------------------------------- #

def phase_engine(cfg, params) -> dict:
    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.ops.flash import flash_prefill_attention

    eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                 engine_cfg=EngineConfig(max_slots=8, max_seq=2048))
    plens = [20, 100, 300, 700, 1500, 20, 100, 300, 700, 1500]
    gen = torch.Generator().manual_seed(3)
    reqs = []
    for i, n in enumerate(plens):
        ids = torch.randint(0, 256, (n,), generator=gen).tolist()
        sampled = i % 2 == 1
        reqs.append(GenRequest(prompt_ids=ids, max_new_tokens=64, ignore_eos=True,
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
    launches = flash_prefill_attention.launches
    metrics = eng.metrics()
    eng.stop()
    check(all(not th.is_alive() for th in threads), "engine: a request never finished")
    completion = 0
    ttfts = []
    for i, (first, evs) in enumerate(results):
        done = evs[-1]
        ntok = sum(1 for e in evs if e.kind == "token")
        check(done.kind == "done", f"request {i} ended with {done.kind}: {done.error}")
        check(ntok == done.completion_tokens == 64,
              f"request {i}: {ntok} token events, {done.completion_tokens} completion tokens")
        completion += done.completion_tokens
        ttfts.append(first)
    admissions = int(metrics["admissions"])
    check(launches == cfg.num_layers * admissions and launches > 0,
          f"flash kernel launches {launches} != {cfg.num_layers} layers x {admissions} admissions")
    out = dict(requests=len(reqs), completion_tokens=completion, wall_s=wall,
               ttft_ms_p50=statistics.median(ttfts) * 1e3, ttft_ms_max=max(ttfts) * 1e3,
               decode_tok_s=metrics["tokens_per_second"], e2e_tok_s=completion / wall,
               admissions=admissions, decode_blocks=int(metrics["decode_blocks"]),
               flash_launches=launches)
    log("[engine llama-3.2-1b] " + json.dumps(out))
    return out


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    t_start = time.monotonic()
    name, smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = phase_kernels(gen)
    model = phase_model(gen)
    eng = phase_engine(model["cfg"], model["params"])
    main_row = next(r for r in rows if r["shape"] == [8, 2048, 32, 8, 64])
    record = {
        "name": "flash_prefill",
        "route": "cuda",
        "source": "localai_tpu_torch/csrc/flash_prefill.cu",
        "replaces": "localai_tpu/ops/flash.py:41",
        "tpu_kernel": "localai_tpu/ops/flash.py::_flash_kernel",
        "launches": eng["flash_launches"],
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
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
