"""Ragged per-row LoRA delta for multi-tenant decode
(localai_tpu/ops/lora_matmul.py).

One engine serves many tenants: shared (possibly int8 / int4) base weights
plus per-tenant LoRA adapters applied UNMERGED beside each base product,
y = W·x + B·(A·x), with the rank-r factors of every device-resident adapter
stacked along a leading adapter axis ({"a": [NA, in, R], "b": [NA, R,
out]} per layer). Each row carries an adapter id; id 0 is the all-zero null
adapter, so adapter-less rows are exact no-ops.

Two numerics, each where the JAX package uses it:
- `lora_bgmv` (decode rows) launches the hand-written CUDA kernel of
  `csrc/lora_matmul.cu` for tensors on the card, which replaces the TPU
  kernel localai_tpu/ops/lora_matmul.py::_lora_kernel: factors and the
  rank-r intermediate in f32, the output cast to x.dtype once. For CPU
  tensors it runs `lora_delta_plain`, the kernel's function in plain
  PyTorch and its oracle on the card.
- `lora_delta_gather` (everything else: prefill rows, more than
  LORA_KERNEL_MAX_ROWS rows, a non-float x) is the JAX package's gather
  form: factors cast to x.dtype and the intermediate rounded to x.dtype
  before the second product.
In f32 the two agree; in bf16 they round at different places.

The dispatcher `lora_delta` splits by shape only. There is no other route:
a CUDA tensor the kernel does not take, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import torch

from localai_tpu_torch import kernels

# Rows above which the kernel disengages: the JAX package's
# LORA_PALLAS_MAX_ROWS, kept as the reference's split.
LORA_KERNEL_MAX_ROWS = 256
# Base-weight role per LoRA target key (column- or row-parallel), kept for
# the tensor-parallel wrapper that comes with the multi-GPU port.
LORA_PART = {
    "wq": "col", "wk": "col", "wv": "col",
    "w_gate": "col", "w_up": "col",
    "wo": "row", "w_down": "row",
}
# What csrc/lora_matmul.cu takes: ranks up to 128, in / out multiples of 8
# (16-byte rows of B), rows of A sliced 64 at a time by the shrink pass.
KERNEL_MAX_RANK = 128
_SLICE = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lora_delta_gather(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      ids: torch.Tensor) -> torch.Tensor:
    """The JAX package's `lora_delta_xla`: rows of x (leading axis) select
    their adapter's factors. x [B, ..., in]; a [NA, in, R]; b [NA, R, out];
    ids [B] int (0 = null adapter). The factors are cast to x.dtype, t = x·A
    is accumulated in f32 and rounded to x.dtype, the second product is
    accumulated in f32 and cast to x.dtype. Returns [B, ..., out]."""
    idx = ids.to(device=x.device, dtype=torch.int64)
    B, n_in = x.shape[0], x.shape[-1]
    a_sel = a[idx].to(x.dtype).float()  # [B, in, R]
    b_sel = b[idx].to(x.dtype).float()  # [B, R, out]
    t = torch.bmm(x.reshape(B, -1, n_in).float(), a_sel)  # [B, S, R]
    y = torch.bmm(t.to(x.dtype).float(), b_sel)
    return y.to(x.dtype).reshape(*x.shape[:-1], b.shape[-1])


def lora_delta_plain(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     ids: torch.Tensor) -> torch.Tensor:
    """Plain version of B5, the function the TPU kernel computes: x [N, in],
    factors in f32, t = x·A[id] in f32, t·B[id] cast to x.dtype once.
    Null-adapter rows are exact zeros. Each row is its own batched product,
    so a row's result does not depend on the other rows."""
    idx = ids.to(device=x.device, dtype=torch.int64)
    t = torch.bmm(x.float()[:, None, :], a[idx].float())  # [N, 1, R]
    y = torch.bmm(t, b[idx].float())[:, 0].to(x.dtype)  # [N, out]
    return torch.where((idx == 0)[:, None], torch.zeros((), dtype=x.dtype, device=x.device), y)


def _check_bgmv_args(x, a, b, ids) -> None:
    if x.dim() != 2:
        raise ValueError(f"lora_bgmv: x must be [rows, in], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"lora_bgmv: x must be one of {list(_DTYPE_CODE)}, got {x.dtype}")
    N, n_in = x.shape
    if N > LORA_KERNEL_MAX_ROWS:
        raise ValueError(f"lora_bgmv: {N} rows, the kernel takes at most {LORA_KERNEL_MAX_ROWS}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"lora_bgmv: factors must be a [NA, in, R], b [NA, R, out], got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.shape[1] != n_in:
        raise ValueError(f"lora_bgmv: a maps {a.shape[1]} inputs, x has {n_in}")
    if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype:
        raise TypeError(f"lora_bgmv: factors must both be one of {list(_DTYPE_CODE)}, got "
                        f"{a.dtype} and {b.dtype}")
    R, n_out = a.shape[2], b.shape[2]
    if not 1 <= R <= KERNEL_MAX_RANK:
        raise ValueError(f"lora_bgmv: rank {R}, the kernel takes 1..{KERNEL_MAX_RANK}")
    if n_in % 8 or n_out % 8:
        raise ValueError(f"lora_bgmv: in = {n_in} and out = {n_out} must be multiples of 8")
    for name, t in (("x", x), ("a", a), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"lora_bgmv: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"lora_bgmv: {name} must be contiguous")
    if b.data_ptr() % 16:  # rows of B are read 16 bytes at a time
        raise ValueError("lora_bgmv: b must be 16-byte aligned")
    if ids.dim() != 1 or ids.shape[0] != N or ids.dtype != torch.int32:
        raise ValueError(f"lora_bgmv: ids must be int32 [{N}], got {ids.dtype} "
                         f"{tuple(ids.shape)}")


def lora_bgmv(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Per-row delta B[ids[n]]·(A[ids[n]]ᵀ x[n]) → [N, out] in x.dtype: the
    CUDA kernel for tensors on the card, the plain version on the CPU.

    `ids` lies on x's device, or on the CPU: host ids are checked against
    [0, NA) here and then copied to the card. Ids already on the card are
    not checked on the host (that would wait for the device); the kernel
    writes NaN into a row whose id is outside [0, NA) and reads nothing
    for it."""
    if x.device.type == "cpu":
        return lora_delta_plain(x, a, b, ids)
    if x.device.type != "cuda":
        raise ValueError(f"lora_bgmv: unsupported device {x.device}")
    _check_bgmv_args(x, a, b, ids)
    NA = a.shape[0]
    if ids.device.type == "cpu":
        if bool(((ids < 0) | (ids >= NA)).any()):
            raise ValueError(f"lora_bgmv: adapter ids {ids.tolist()} outside [0, {NA})")
        ids = ids.to(x.device, non_blocking=True)
    elif ids.device != x.device:
        raise ValueError(f"lora_bgmv: ids are on {ids.device}, x on {x.device}")
    N, n_in = x.shape
    R, n_out = a.shape[2], b.shape[2]
    part = torch.empty((N, -(-n_in // _SLICE), R), dtype=torch.float32, device=x.device)
    out = torch.empty((N, n_out), dtype=x.dtype, device=x.device)
    lib = kernels.load("lora_matmul")
    with torch.cuda.device(x.device):  # the library launches on the current device
        rc = lib.lora_bgmv(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(), part.data_ptr(),
            out.data_ptr(), N, n_in, R, n_out, NA, _DTYPE_CODE[x.dtype], _DTYPE_CODE[a.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lora_bgmv kernel launch failed: CUDA error {rc}")
    lora_bgmv.launches += 1
    return out


# Calls that launched the CUDA kernel (each launches its shrink and expand
# passes; the plain CPU route does not count).
lora_bgmv.launches = 0


def lora_delta(x: torch.Tensor, factors: dict, ids: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta y = B[id]·(A[id]·x) for one target projection.

    factors: {"a": [NA, in, R], "b": [NA, R, out]}, one layer's slice of the
    engine's stacked adapter tensors; ids [B] int32 device-adapter rows (0 =
    none). A 2-D float x of 1..LORA_KERNEL_MAX_ROWS rows (decode) goes to
    the kernel's wrapper; anything else (prefill [B, S, in], more rows, a
    non-float x) to the gather form, exactly where the JAX package leaves
    its Pallas kernel for XLA."""
    a, b = factors["a"], factors["b"]
    if x.dim() == 2 and x.is_floating_point() and 0 < x.shape[0] <= LORA_KERNEL_MAX_ROWS:
        return lora_bgmv(x.contiguous(), a, b, ids)
    return lora_delta_gather(x, a, b, ids)
