"""Where the serving path's time goes on the card.

    python -m localai_tpu_torch.profile_engine [--arch llama-3.2-1b]
        [--slots 8] [--prompt 500] [--steps 16] [--paged]
        [--quant int8|int4] [--kv-cache-dtype fp8|fp8_e5m2] [--lora N]

Builds the engine on random bf16 weights (quantized on the card with
`--quant`, the KV cache stored in fp8 with `--kv-cache-dtype`; e.g.
`--arch llama-3-8b --quant int4 --kv-cache-dtype fp8 --paged` profiles a
quantized paged decode step; `--lora 8` registers 8 runtime LoRA tenants,
rank 16 on q_proj / v_proj with lora_alpha = r, and gives each admitted
slot one of them, so the decode block runs the ragged LoRA kernel on every
layer) and drives its device paths
directly on this thread (no loop thread): one fused admission of `--slots`
prompts of `--prompt` tokens, then one decode block of `--steps` steps over
those slots. With `--paged` it then does the same on a paged KV pool
(page 128) and adds one 512-token prefill chunk at offset 1024 (the paged
kernel walks the 1024 resident rows). Prints, per path, the host wall time
of an unprofiled run, the summed device time of its kernels under the
profiler, the device busy share (their ratio), the device launches per
step, the kernels and host ops that take the most time, and the device
time of each of the port's own kernels (B1-B5). Needs a GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
import time

import torch


def _kernels(events) -> list:
    """The device-side entries (kernels, copies) of a key_averages() list."""
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA]


def _top(events, key: str, n: int) -> list[tuple[str, int, float]]:
    rows = [(e.key[:90], e.count, (getattr(e, key, 0.0) or 0.0) / 1e3) for e in events]
    return sorted(rows, key=lambda r: -r[2])[:n]


# Names of the port's own kernels (csrc/*.cu), listed apart from the top
# kernels so that each one's device time shows however small it is.
PORT_KERNELS = ("flash_prefill", "paged_mma_kernel", "paged_scalar_kernel", "qmm_kernel",
                "qmm_mma_kernel", "unembed_kernel", "unembed_mma_kernel", "lora_group_kernel")


def _profile(label: str, fn, steps: int = 1) -> dict:
    """Run fn three times: a warm-up (allocator, cuBLAS handles, lazy module
    loads), a timed run, and a run under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    kern = _kernels(ev)
    kern_ids = {id(e) for e in kern}
    dev_ms = sum(e.self_device_time_total for e in kern) / 1e3
    launches = sum(e.count for e in kern)
    port = [e for e in kern if any(n in e.key for n in PORT_KERNELS)]
    out = {
        "path": label,
        "wall_ms": wall_ms,
        "wall_ms_per_step": wall_ms / steps,
        "device_ms": dev_ms,
        "device_busy_share": dev_ms / wall_ms if wall_ms else 0.0,
        "device_launches_per_step": launches / steps,
        "top_kernels": _top(kern, "self_device_time_total", 12),
        "port_kernels": _top(port, "self_device_time_total", len(port)),
        "top_host_ops": _top([e for e in ev if id(e) not in kern_ids],
                             "self_cpu_time_total", 12),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama-3.2-1b")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=500)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--paged", action="store_true",
                    help="also profile a paged decode block and a 512-token chunk")
    ap.add_argument("--quant", choices=("int8", "int4"), default="",
                    help="quantize the matmul weights (and an untied head) on the card")
    ap.add_argument("--kv-cache-dtype", choices=("fp8", "fp8_e4m3", "fp8_e5m2"), default="",
                    help="store the KV cache in fp8")
    ap.add_argument("--lora", type=int, default=0,
                    help="serve N runtime LoRA tenants (rank 16 on q/v), slot i with tenant i % N")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_engine needs a CUDA device")

    from localai_tpu_torch.engine.engine import Engine, EngineConfig, GenRequest, RequestHandle
    from localai_tpu_torch.engine.tokenizer import ByteTokenizer
    from localai_tpu_torch.engine.weights import random_lora_adapter
    from localai_tpu_torch.models import get_arch
    from localai_tpu_torch.models.llama import init_params
    from localai_tpu_torch.models.quant import quantize_params

    cfg = get_arch(args.arch)
    params = init_params(cfg, seed=0, device="cuda")
    if args.quant:
        params = quantize_params(cfg, params, args.quant)
        torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(0)
    slots = list(range(args.slots))
    tmp = tempfile.TemporaryDirectory()
    tenants = [random_lora_adapter(cfg, f"{tmp.name}/t{i}", 16, 16, seed=i)
               for i in range(args.lora)]

    def make_engine(**kw):
        eng = Engine(cfg, params, ByteTokenizer(cfg.vocab_size), device="cuda",
                     engine_cfg=EngineConfig(max_slots=args.slots, max_seq=2048,
                                             block_sizes=(args.steps,),
                                             kv_cache_dtype=args.kv_cache_dtype, **kw))
        for i, d in enumerate(tenants):
            eng.register_adapter(f"t{i}", d)
        return eng

    def admitter(eng):
        bucket = eng._bucket_for(args.prompt)

        def admit():
            group = []
            for i in range(args.slots):
                ids = torch.randint(0, 256, (args.prompt,), generator=gen).tolist()
                group.append((GenRequest(prompt_ids=ids, max_new_tokens=10_000,
                                         ignore_eos=True, temperature=0.8 if i % 2 else 0.0,
                                         top_p=0.9, seed=i,
                                         adapter=f"t{i % args.lora}" if args.lora else None),
                               RequestHandle()))
            for s in slots:  # the previous run's requests give their slots back
                if eng.slots[s] is not None:
                    eng._release(s)
            eng._dispatch_admit(group, bucket, slots)
        return admit, bucket

    eng = make_engine()
    admit, bucket = admitter(eng)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "arch": cfg.name, "quant": args.quant or "bf16",
                      "kv_cache_dtype": args.kv_cache_dtype or "model",
                      "weight_bytes": eng.metrics()["weight_bytes"],
                      "slots": args.slots, "prompt": args.prompt, "bucket": bucket,
                      "steps": args.steps, "lora_tenants": args.lora}), flush=True)
    _profile(f"admission m={args.slots} bucket={bucket}", admit)
    _profile(f"decode block n={args.steps} slots={args.slots}", eng._run_block, args.steps)
    if not args.paged:
        return
    del eng
    # Pages for every slot's whole context.
    peng = make_engine(kv_pages=args.slots * 16, kv_page_size=128, prefill_chunk=512)
    padmit, _ = admitter(peng)
    padmit()
    _profile(f"paged decode block n={args.steps} slots={args.slots} page=128",
             peng._run_block, args.steps)
    peng._release(slots[-1])  # its slot and pages take the chunked admission
    ids = torch.randint(0, 256, (1536,), generator=gen).tolist()
    assert peng._chunk_start(GenRequest(prompt_ids=ids, max_new_tokens=16), RequestHandle())
    st = peng._chunkings[0]

    def chunk():
        st["offset"] = 1024
        peng._dispatch_chunk(st, 512)
    _profile("paged prefill chunk T=512 offset=1024", chunk)


if __name__ == "__main__":
    main()
