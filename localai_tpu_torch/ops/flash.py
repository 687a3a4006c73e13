"""Flash attention (causal, GQA, length-masked) for prefill.

The wrapper `flash_prefill_attention` launches the hand-written CUDA kernel
`csrc/flash_prefill.cu` for tensors on the card; it replaces the TPU kernel
localai_tpu/ops/flash.py::_flash_kernel. For tensors on the CPU it runs
`flash_prefill_attention_plain`, the same online-softmax algorithm in plain
PyTorch, which is also what the kernel is held against on the card. There
is no other route: a CUDA tensor that the kernel does not take, a failed
build or a failed launch raises.

Layout: q [B, S, H, D], k/v [B, S, K, D]; query head h reads kv head
h // (H // K). Key j is visible to query row i iff j <= i and j < lengths[b];
query rows at or past lengths[b] come out as exact zeros.
"""

from __future__ import annotations

import math

import torch

from localai_tpu_torch import kernels

NEG_INF = -1e30

# The CUDA kernel's kv tile: 64 keys, sized for Hopper's shared memory and
# registers (the TPU kernel's 256/512 tiles were sized for VMEM and do not
# carry over). The query tile (64 or 128 rows) does not change the result.
FLASH_TILE = 64
FLASH_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_block_sizes(S: int) -> tuple[int, int]:
    """(block_q, block_k) of the kernel for a length-S prefill; the plain
    version walks keys in the same blocks."""
    return min(FLASH_TILE, S), min(FLASH_TILE, S)


def flash_prefill_attention_plain(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,  # [B, S, K, D]
    lengths: torch.Tensor,  # [B] valid lengths
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: online softmax in f32 over key
    blocks of flash_block_sizes(S)[1]. Returns [B, S, H, D] in q.dtype."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    _, bk = flash_block_sizes(S)
    dev = q.device
    qf = (q.float() * (1.0 / math.sqrt(D))).reshape(B, S, K, G, D)
    kf, vf = k.float(), v.float()
    pos = torch.arange(S, device=dev)
    lens = lengths.to(device=dev, dtype=torch.int64)
    m = torch.full((B, K, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, S, D), dtype=torch.float32, device=dev)
    for k0 in range(0, S, bk):
        kv_pos = pos[k0:k0 + bk]
        s = torch.einsum("bqkgd,bskd->bkgqs", qf, kf[:, k0:k0 + bk])
        mask = (kv_pos[None, None, :] <= pos[None, :, None]) & (
            kv_pos[None, None, :] < lens[:, None, None]
        )  # [B, S, bk]
        s = torch.where(mask[:, None, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, vf[:, k0:k0 + bk]
        )
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    row_ok = (pos[None, :] < lens[:, None])[:, None, None, :, None]
    o = torch.where(row_ok, o, 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(q.dtype)


def _check_cuda_args(q, k, v, lengths, out=None) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, heads, D]")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q {tuple(q.shape)}")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv heads")
    if D not in FLASH_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel (needs {FLASH_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v must share one of {list(_DTYPE_CODE)}; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise TypeError(f"lengths must be int32 [{B}], got {lengths.dtype} {tuple(lengths.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths), ("out", out)):
        if t is None:  # out: the wrapper's own allocation, when it passes one
            continue
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        # The bf16 kernel moves q, k, v and out in 16-byte cp.async / vector
        # accesses: each must start on a 16-byte boundary.
        if name != "lengths" and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             f"(data_ptr {t.data_ptr():#x})")


def flash_prefill_attention(
    q: torch.Tensor,  # [B, S, H, D]
    k: torch.Tensor,  # [B, S, K, D]
    v: torch.Tensor,  # [B, S, K, D]
    lengths: torch.Tensor,  # [B] int32 valid lengths
) -> torch.Tensor:
    """Causal GQA flash attention. Returns [B, S, H, D] in q.dtype: the
    CUDA kernel for tensors on the card, the plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_attention: unsupported device {q.device}")
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check_cuda_args(q, k, v, lengths, out)
    B, S, H, D = q.shape
    lib = kernels.load("flash_prefill")
    with torch.cuda.device(q.device):  # the library launches on the current device
        rc = lib.flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            B, S, H, k.shape[2], D, _DTYPE_CODE[q.dtype], 1.0 / math.sqrt(D),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"flash_prefill kernel launch failed: CUDA error {rc}")
    flash_prefill_attention.launches += 1
    return out


# Launches of the CUDA kernel (the plain CPU route does not count).
flash_prefill_attention.launches = 0
