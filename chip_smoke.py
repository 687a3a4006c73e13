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
   the paged decode and chunked-prefill shapes and on fp8 pools with a
   per-head kv_scale, B3 dequant-matmul at llama-3-8b's projection shapes
   (flat int8, grouped int8, packed int4; bf16 and f32 x; 1, 8 and 256
   rows) and B4 int8 unembed at its head, with the time of a bf16 matmul
   on the dequantized weight beside them;
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
   and 64, 8 adapters and a null row, 1 and 256 rows, mixed ranks: null
   rows exact zeros, every row bit-identical to a launch on it alone;
10. lora http — llama-3.2-1b (16 layers, bf16) served by the port's own
   HTTP server with 8 virtual-model tenants (PEFT adapters from a seed):
   a warm pass, then 12 concurrent chat / completion requests (half
   streamed, half greedy) to the tenants and the base, checked over HTTP;
   then the same 12 to a base with no tenants (the tenancy cost);
11. lora 8b int8 — llama-3-8b int8 with 4 tenants and 4 adapter-less
   requests through Engine.submit (B1, B2, B3, B4 and B5 on one path);
   then the small f32 model's paged engine with three tenants and a null
   row on the card against the same engine on the CPU.
In 5, 6, 8, 10 and 11 the kernel launch counters, zeroed just before each
run, show that the path went through the kernels.

The last lines are the kernels' JSON record, the card's `nvidia-smi` name
and power limit, and the result line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
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

    from localai_tpu_torch.models.llama import kv_cast
    from localai_tpu_torch.ops.paged_flash import paged_partials_plain, paged_partials_rows

    # Both sides compute in f32 (bf16 pool rows widen exactly): the
    # tolerance covers summation order over up to 4096 rows.
    tol = 2e-4
    # (name, B, G, T, K, D, page, MP, pool dtype, limits, softcap, window):
    # llama-3.2-1b paged decode (H=32, K=8: G=4 query rows per kv head) at
    # D 64 and 128, one 512-token prefill chunk at offset 1536, a small f32
    # shape with softcap and a sliding window, and the D=128 decode shape
    # (llama-3-8b's) on fp8 pools with a per-head kv_scale.
    shapes = [
        ("decode", 8, 4, 1, 8, 64, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("decode", 8, 4, 1, 8, 128, 128, 32, torch.bfloat16, "ragged", 0.0, 0),
        ("prefill_chunk", 1, 4, 512, 8, 64, 128, 32, torch.bfloat16, [1536], 0.0, 0),
        ("decode_softcap_window", 3, 2, 1, 2, 64, 16, 8, torch.float32, [100, 37, 0], 30.0, 40),
        ("decode_fp8", 8, 4, 1, 8, 128, 128, 32, torch.float8_e4m3fn, "ragged", 0.0, 0),
        ("decode_fp8", 8, 4, 1, 8, 128, 128, 32, torch.float8_e5m2, "ragged", 0.0, 0),
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
        kp = torch.randn(P, page, K, D, generator=gen, device="cuda")
        vp = torch.randn(P, page, K, D, generator=gen, device="cuda")
        kv_scale = None
        if dt.itemsize == 1:  # fp8: stored = value / scale, a fixed per-head scale
            kv_scale = torch.stack([torch.linspace(0.5, 4.0, K), torch.linspace(3.0, 0.25, K)])
            kv_scale = kv_scale.cuda()
            kp, vp = kp / kv_scale[0][:, None], vp / kv_scale[1][:, None]
        kp, vp = kv_cast(kp, dt), kv_cast(vp, dt)
        # A random permutation of the pool's pages (SCRATCH, the last, unused).
        table = torch.randperm(P - 1, generator=gen, device="cuda")[: B * MP]
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
        ms = cuda_time_cold_ms(lambda: paged_partials_rows(*args), 20)
        plain_ms = cuda_time_cold_ms(lambda: paged_partials_plain(*args), 3)
        flops, nbytes = _paged_work(qpos.cpu().numpy(), np.asarray(limits), K, D, MP, page,
                                    dt.itemsize, window)
        nbytes += 0 if kv_scale is None else kv_scale.numel() * 4
        t_ops, t_bytes = flops / PEAK_FLOPS[torch.float32] * 1e3, nbytes / PEAK_BYTES * 1e3
        row = dict(shape=name, B=B, H=G * K, K=K, QR=QR, D=D, page=page, MP=MP,
                   pool_dtype=str(dt).replace("torch.", ""), limits=limits, softcap=softcap,
                   window=window,
                   kv_scale=None if kv_scale is None else kv_scale.tolist(),
                   max_abs_err=o_err, m_err=m_err, l_rel_err=l_rel, tol=tol,
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


# llama-3-8b's projections (in, out): wk / wv, wq / wo, w_gate / w_up,
# w_down; then a small ragged shape (three int4 groups, out not a multiple
# of the kernel's 128-column block).
QMM_SHAPES = [(4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096), (96, 80)]
QMM_FORMS = ("int8", "grouped_int8", "int4")


def _grouped_int8(w, group=32):
    """Group-wise symmetric int8 (GGUF q8_0's layout), quantized here: the
    serving path's quantizers make the flat int8 and int4 forms only."""
    g = w.shape[0] // group
    wg = w.float().reshape(g, group, w.shape[1])
    s = torch.clamp(wg.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-9)
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


def phase_quant_kernels(gen: torch.Generator) -> tuple[list[dict], list[dict]]:
    """B3 at every projection shape, form, x dtype and row count of the
    serving path, and B4 at llama-3-8b's head; each against its plain
    version, with the time of a bf16 matmul on the dequantized weight
    (`bf16_ms`: what the quantized kernel has to beat to be worth its
    bytes). No one PyTorch call takes these packed layouts, so there is no
    library time."""
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops.quant_matmul import qmm, qmm_plain, qunembed, qunembed_plain

    # f32 x: summation order only. bf16 x: both sides round the f32 sum once
    # to bf16, so they may differ by one bf16 step (2^-7 of the value).
    rel_f32, rel_bf16 = 1e-4, 2.0**-7
    b3 = []
    for n_in, n_out in QMM_SHAPES:
        w = torch.randn(n_in, n_out, generator=gen, device="cuda") * 0.02
        for form in QMM_FORMS:
            qw = {"int8": quant.quantize_tensor, "grouped_int8": _grouped_int8,
                  "int4": quant.quantize_tensor_g4}[form](w)
            w_bf16 = quant.dequantize_tensor(qw).to(torch.bfloat16)
            for dt in (torch.bfloat16, torch.float32):
                for N in (1, 8, 256):
                    x = torch.randn(N, n_in, generator=gen, device="cuda").to(dt)
                    out = qmm(x, qw)
                    torch.cuda.synchronize()
                    want = qmm_plain(x, qw)
                    scale = qmm_plain(x.float(), qw).abs().max().item()
                    err = (out.float() - want.float()).abs()
                    if dt == torch.float32:
                        ok = err.max().item() <= rel_f32 * scale
                    else:
                        ok = bool((err <= rel_bf16 * want.float().abs() + rel_f32 * scale).all())
                    ok = ok and bool(torch.isfinite(out).all())
                    xb = x.to(torch.bfloat16)
                    ms = cuda_time_cold_ms(lambda: qmm(x, qw), 20)
                    plain_ms = cuda_time_cold_ms(lambda: qmm_plain(x, qw), 3)
                    bf16_ms = cuda_time_cold_ms(lambda: torch.matmul(xb, w_bf16), 20)
                    bound_ms, bound_by = _bound(*_qmm_work(form, N, n_in, n_out, dt.itemsize),
                                                dt)
                    row = dict(shape=[N, n_in, n_out], form=form,
                               dtype=str(dt).replace("torch.", ""),
                               max_abs_err=err.max().item(), out_max=scale, ok=ok, ms=ms,
                               plain_ms=plain_ms, bf16_ms=bf16_ms, bound_ms=bound_ms,
                               bound_by=bound_by)
                    log(f"[kernel quant_matmul] {json.dumps(row)}")
                    check(ok, f"quant_matmul disagrees with its plain version at {row}")
                    b3.append(row)
            del qw, w_bf16
    b4 = []
    V, D = 128256, 4096
    w = torch.randn(V, D, generator=gen, device="cuda") * 0.02
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
    head = {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}
    head_bf16 = (head["q"].float() * s).to(torch.bfloat16)
    del w
    for dt in (torch.bfloat16, torch.float32):
        for N in (1, 8, 256):
            h = torch.randn(N, D, generator=gen, device="cuda").to(dt)
            out = qunembed(h, head)
            torch.cuda.synchronize()
            want = qunembed_plain(h, head)
            scale = want.abs().max().item()
            err = (out - want).abs().max().item()
            ok = err <= rel_f32 * scale and bool(torch.isfinite(out).all())  # f32 both sides
            hb = h.to(torch.bfloat16)
            ms = cuda_time_cold_ms(lambda: qunembed(h, head), 20)
            plain_ms = cuda_time_cold_ms(lambda: qunembed_plain(h, head), 3)
            bf16_ms = cuda_time_cold_ms(
                lambda: torch.mm(hb, head_bf16.t(), out_dtype=torch.float32), 20)
            bound_ms, bound_by = _bound(2.0 * N * V * D,
                                        V * D + 4 * V + dt.itemsize * N * D + 4 * N * V, dt)
            row = dict(shape=[N, V, D], dtype=str(dt).replace("torch.", ""), max_abs_err=err,
                       out_max=scale, ok=ok, ms=ms, plain_ms=plain_ms, bf16_ms=bf16_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            log(f"[kernel quant_unembed] {json.dumps(row)}")
            check(ok, f"quant_unembed disagrees with its plain version at {row}")
            b4.append(row)
    return b3, b4


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

def _serve(eng, plens: list[int], max_new: int = 64, adapters=None) -> dict:
    """Submit one request per prompt length (half greedy, half seeded top-p;
    request i with the runtime LoRA adapter adapters[i], if given) and
    stream them all; the kernel counters go to 0 just before the run and
    are read just after it."""
    from localai_tpu_torch.engine.engine import GenRequest
    from localai_tpu_torch.models import quant
    from localai_tpu_torch.ops import quant_matmul
    from localai_tpu_torch.ops.flash import flash_prefill_attention
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv
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

    # Rows of every quantized product the kernels did not take.
    dequant_rows = []
    dispatch = quant_matmul.dispatch_matmul

    def recording(x, w):
        y = dispatch(x, w)
        if y is None:
            dequant_rows.append((quant_matmul._rows(x), x.is_floating_point()))
        return y

    # The main path's run: counts go to 0 just before, are read just after.
    flash_prefill_attention.launches = 0
    paged_partials_rows.launches = 0
    quant_matmul.qmm.launches = quant_matmul.qunembed.launches = 0
    quant.matmul.dequant_calls = quant.unembed_matmul.dequant_calls = 0
    lora_bgmv.launches = 0
    # Engine counters are read as differences over this run.
    m0, tok0, dt0 = eng.metrics(), eng._decode_tokens, eng._decode_time
    t0 = time.monotonic()
    threads = []
    with swapped(quant_matmul, "dispatch_matmul", recording):
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
                "quant_unembed": quant_matmul.qunembed.launches,
                "matmul_dequant_calls": quant.matmul.dequant_calls,
                "unembed_dequant_calls": quant.unembed_matmul.dequant_calls,
                "lora_bgmv": lora_bgmv.launches}
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

    return dict(requests=len(reqs), completion_tokens=completion, wall_s=wall,
                ttft_ms_p50=statistics.median(ttfts) * 1e3, ttft_ms_max=max(ttfts) * 1e3,
                decode_tok_s=(eng._decode_tokens - tok0) / (eng._decode_time - dt0),
                e2e_tok_s=completion / wall,
                admissions=delta("admissions"),
                decode_blocks=delta("decode_blocks"),
                decode_steps=delta("decode_steps"),
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



def _check_quant_launches(label: str, L: int, out: dict, chunks=(4, 2 + 3 + 6 + 7)) -> None:
    """The launch identities of a quantized paged engine run; `chunks` is
    the run's (chunked admissions, prefill chunks)."""
    n = out["launches"]
    passes = out["admissions"] + out["prefill_chunks"]
    check(n["quant_matmul"] > 0 and n["quant_matmul"] + n["matmul_dequant_calls"]
          == 7 * L * (out["decode_steps"] + passes),
          f"{label}: B3 launches {n['quant_matmul']} + dequant-route calls "
          f"{n['matmul_dequant_calls']} != 7 x {L} layers x ({out['decode_steps']} decode "
          f"steps + {passes} prefill passes)")
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
    used = {int(i) for i in ids if 0 < int(i) < NA}
    active = sum(1 for i in ids if 0 < int(i) < NA)
    N = len(ids)
    flops = 2.0 * R * (n_in + n_out) * active
    nbytes = elt * (len(used) * R * (n_in + n_out) + N * (n_in + n_out)) + 4 * N
    return flops, nbytes


# bf16: both sides compute in f32 (bf16 factors widen exactly) and round once
# to bf16, so they may differ by one bf16 step (2^-7 of the value) plus a
# summation-order term of 1e-4 of the largest value.
LORA_REL_BF16, LORA_REL_SUM = 2.0**-7, 1e-4


def _hold_lora(x, a, b, ids) -> dict:
    """One B5 launch against lora_delta_plain on the same inputs: the error
    within the stated tolerance, null rows exact zeros, and each row (all of
    them up to 9 rows, else four) bit-identical to a launch on it alone."""
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv, lora_delta_plain

    out = lora_bgmv(x, a, b, ids)
    torch.cuda.synchronize()
    want = lora_delta_plain(x, a, b, ids)
    scale = want.float().abs().max().item()
    err = (out.float() - want.float()).abs()
    host_ids = ids.tolist()
    N = len(host_ids)
    null_exact = all(bool((out[n] == 0).all()) for n, i in enumerate(host_ids) if i == 0)
    check_rows = range(N) if N <= 9 else (0, 1, N // 2, N - 1)
    independent = all(torch.equal(out[n:n + 1], lora_bgmv(x[n:n + 1], a, b, ids[n:n + 1]))
                      for n in check_rows)
    ok = (bool((err <= LORA_REL_BF16 * want.float().abs() + LORA_REL_SUM * scale).all())
          and null_exact and independent and bool(torch.isfinite(out).all()))
    return dict(shape=[N, a.shape[1], b.shape[2]], rank=a.shape[2],
                dtype=str(x.dtype).replace("torch.", ""), ids=host_ids if N <= 9 else None,
                max_abs_err=err.max().item(), out_max=scale, null_exact=null_exact,
                rows_independent=independent, ok=ok)


def phase_lora_kernels(gen: torch.Generator) -> list[dict]:
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv, lora_delta_plain

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
    torch.cuda.empty_cache()
    return rows


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
    worst = max(rows, key=lambda r: r["max_abs_err"] / max(r["out_max"], 1e-30))
    log(f"[lora_http served stacks] B5 vs plain on {len(rows)} (key, layer, ids) cases, "
        f"all ok; worst relative: {json.dumps(worst)}")
    return rows


def phase_lora_http() -> dict:
    from localai_tpu_torch.ops.lora_matmul import lora_bgmv

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
            lora_bgmv.launches = 0
            results, wall = _http_batch(base, reqs)
            launches = lora_bgmv.launches
            m1 = eng.metrics()
            texts, ttfts = _check_http_results("lora_http", reqs, results)
            steps = int(m1["decode_steps"] - m0["decode_steps"])
            L = eng.cfg.num_layers
            # Admissions run no B5: their x is [B, S, D] (3-D), which takes
            # the gather form; prefill chunks carry no LoRA operand. Every
            # decode step runs the delta for all 8 slots (adapter-less and
            # idle slots ride id 0) on each of the 7 keys of every layer,
            # one wrapper call (shrink + expand) each.
            check(launches == steps * L * 7 and launches > 0,
                  f"lora_http: {launches} B5 launches != {steps} decode steps x {L} layers x 7")
            check(texts[0] != texts[8], "lora_http: tenant0's greedy output equals the base's")
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
            lora_bgmv.launches = 0
            results, wall = _http_batch(base, base_reqs)
            _texts, ttfts = _check_http_results("lora_http base", base_reqs, results)
            check(lora_bgmv.launches == 0 and eng._lora_tree is None,
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
    n = out["launches"]
    check(n["lora_bgmv"] == out["decode_steps"] * L * 4 and n["lora_bgmv"] > 0,
          f"lora_8b: B5 launches {n['lora_bgmv']} != {out['decode_steps']} decode steps x "
          f"{L} layers x 4 keys")
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


def _compact(row: dict, keys) -> dict:
    return {k: row[k] for k in keys}


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    t_start = time.monotonic()
    seconds = {}

    def timed(label, fn, *args):
        t0 = time.monotonic()
        out = fn(*args)
        seconds[label] = round(time.monotonic() - t0, 1)
        log(f"[phase {label}] {seconds[label]}s")
        return out

    name, smi = timed("device", phase_device)
    timed("build", phase_build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = timed("flash_kernels", phase_kernels, gen)
    paged_rows = timed("paged_kernels", phase_paged_kernels, gen)
    b3_rows, b4_rows = timed("quant_kernels", phase_quant_kernels, gen)
    model = timed("model", phase_model, gen)
    dense = timed("engine", phase_engine, model["cfg"], model["params"])
    paged = timed("paged_engine", phase_paged_engine, model["cfg"], model["params"],
                  model["small"], model["p_small"])
    del model["params"]
    torch.cuda.empty_cache()
    qmodel = timed("quant_model", phase_quant_model, gen)
    qruns = timed("quant_engines", phase_quant_engines, qmodel, model["small"],
                  model["p_small"], model["p_small_cpu"])
    lora_rows = timed("lora_kernels", phase_lora_kernels, gen)
    lora_http = timed("lora_http", phase_lora_http)
    lora_8b = timed("lora_8b", phase_lora_8b, qmodel, model["small"], model["p_small"],
                    model["p_small_cpu"])
    runs = {"dense_engine": dense, "paged_engine": paged, **qruns, "lora_8b_int8": lora_8b}
    by_path = {k: {path: out["launches"][k] for path, out in runs.items()}
               for k in ("flash_prefill", "paged_attention", "quant_matmul", "quant_unembed",
                         "lora_bgmv")}
    by_path["lora_bgmv"]["lora_http"] = lora_http["tenants"]["lora_bgmv_launches"]
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
        "library_ms": None,  # no one PyTorch call takes the packed int8 / int4 layouts
        # Every shape's full row is in the log above; here the times only.
        "shapes": [_compact(r, ("shape", "form", "dtype", "ms", "bf16_ms", "bound_ms"))
                   for r in b3_rows],
    }
    b4_main = next(r for r in b4_rows if r["shape"][0] == 8 and r["dtype"] == "bfloat16")
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
        "library_ms": None,  # no one PyTorch call takes an int8 head with its scales
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
        "launches": sum(by_path["lora_bgmv"].values()),
        "launches_by_path": {k: v for k, v in by_path["lora_bgmv"].items() if v},
        "shape": {"N": 9, "in": 2048, "out": 2048, "R": 16, "dtype": "bfloat16"},
        "max_abs_err": max(r["max_abs_err"] for r in lora_rows + served),
        "tol": "bf16: 2^-7 x |out| + 1e-4 x max|out| (f32 on both sides, one bf16 rounding)",
        "ok": all(r["ok"] for r in lora_rows + served),
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
        "library_ms": None,  # no one PyTorch call computes a per-row gathered delta
        "shapes": [_compact(r, ("shape", "rank", "padded_rank", "ms", "plain_ms",
                                "bmm2_gathered_ms", "bound_ms", "max_abs_err"))
                   for r in lora_rows],
    }
    log(f"[phases] {json.dumps(seconds)}")
    log(f"[done] all phases passed in {time.monotonic() - t_start:.1f}s")
    print(json.dumps({"kernels": [flash_record, paged_record, quant_record, unembed_record,
                                  lora_record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
