"""Ragged per-row LoRA delta for multi-tenant decode
(localai_tpu/ops/lora_matmul.py).

One engine serves many tenants: shared (possibly int8 / int4) base weights
plus per-tenant LoRA adapters applied UNMERGED beside each base product,
y = W·x + B·(A·x), with the rank-r factors of every device-resident adapter
stacked along a leading adapter axis ({"a": [NA, in, R], "b": [NA, R,
out]} per layer). Each row carries an adapter id; id 0 is the all-zero null
adapter, so adapter-less rows are exact no-ops.

Two numerics, each where the JAX package uses it:
- `lora_bgmv_group` (decode rows) launches the hand-written CUDA kernel of
  `csrc/lora_matmul.cu` once for 1-3 targets that share x (q / k / v, or
  gate / up), which replaces the TPU kernel
  localai_tpu/ops/lora_matmul.py::_lora_kernel: factors and the rank-r
  intermediate in f32, the output cast to x.dtype once. `lora_bgmv` is its
  one-target form. For CPU tensors they run `lora_delta_plain`, the
  kernel's function in plain PyTorch and its oracle on the card.
- `lora_delta_gather` (everything else: prefill rows, more than
  LORA_KERNEL_MAX_ROWS rows, a non-float x) is the JAX package's gather
  form: factors cast to x.dtype and the intermediate rounded to x.dtype
  before the second product.
In f32 the two agree; in bf16 they round at different places.

The kernel's work is cut by `lora_plan`, a plain function of the shapes
(never of the ids, which live on the card). Shrink and expand meet inside
a thread-block cluster, through shared memory: a launch needs no
workspace, allocates nothing but its outputs and leaves no state behind.

The dispatchers `lora_delta` (one target) and `lora_deltas` (a group)
split by shape only. There is no other route: a CUDA tensor the kernel
does not take, a failed build or a failed launch raises.
"""

from __future__ import annotations

from typing import NamedTuple

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
# (16-byte rows of x and B), 1-3 targets a launch.
KERNEL_MAX_RANK = 128
KERNEL_MAX_TARGETS = 3
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The plan cuts IN and each target's OUT over a cluster of _CLUSTER blocks
# and gives a pass at most _PASS_BYTES of bf16 factors (A's rows of a
# shrink pass, B's columns of an expand pass) and at most _MAX_PASS_ROWS
# rows of IN (x's rows of a pass sit beside them in shared memory).
_CLUSTER = 16
_PASS_BYTES = 32768
_MAX_PASS_ROWS = 512


def _up16(v: int) -> int:
    return -(-v // 16) * 16


class LoraPlan(NamedTuple):
    """How B5 cuts one grouped launch (csrc/lora_matmul.cu): one cluster of
    `cluster` blocks per (segment slot, target); block c owns rows [c *
    slice_rows, (c + 1) * slice_rows) of IN and cols[t] output columns of
    target t, walked in passes of pass_rows and pass_cols. A segment is the
    rows that carry one adapter id; there are `slots` of them, min(rows,
    NA - 1) (at least one), whatever the ids turn out to be."""

    rank_pad: int     # R rounded up to 16: the shrink mma's M
    cluster: int      # blocks a cluster
    slice_rows: int   # rows of IN a block owns (a multiple of 16)
    pass_rows: int    # rows of A a shrink pass (a multiple of 16)
    cols: tuple       # output columns a block owns, per target (multiples of 16)
    pass_cols: int    # output columns an expand pass (a multiple of 16)
    slots: int        # segment slots

    def blocks(self) -> int:
        """The launch's grid: one cluster per (slot, target)."""
        return self.slots * len(self.cols) * self.cluster


def lora_plan(n_in: int, n_outs, rank: int, n_rows: int, n_adapters: int) -> LoraPlan:
    """B5's plan for x [n_rows, n_in] against the stacked factors of targets
    with output widths `n_outs`, rank `rank`, `n_adapters` stack rows (row 0
    the null adapter). The cuts of IN and OUT depend on (n_in, n_outs,
    rank) alone, so a row's sums run in the same order whatever the batch:
    a row's bits do not depend on the rows beside it."""
    if not 1 <= rank <= KERNEL_MAX_RANK:
        raise ValueError(f"lora_plan: rank {rank}, the kernel takes 1..{KERNEL_MAX_RANK}")
    rp = _up16(rank)
    c = _CLUSTER
    ir = _up16(-(-n_in // c))
    pr = min(ir, _MAX_PASS_ROWS, max(16, _PASS_BYTES // (2 * (rp + 8)) // 16 * 16))
    cols = tuple(_up16(-(-int(o) // c)) for o in n_outs)
    pc = min(max(cols), max(16, _PASS_BYTES // (2 * rp) // 16 * 16))
    return LoraPlan(rp, c, ir, pr, cols, pc, max(1, min(n_rows, n_adapters - 1)))


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


def _check_group_args(x, pairs, ids) -> None:
    name = "lora_bgmv"
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [rows, in], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be one of {list(_DTYPE_CODE)}, got {x.dtype}")
    N, n_in = x.shape
    if N > LORA_KERNEL_MAX_ROWS:
        raise ValueError(f"{name}: {N} rows, the kernel takes at most {LORA_KERNEL_MAX_ROWS}")
    if not 1 <= len(pairs) <= KERNEL_MAX_TARGETS:
        raise ValueError(f"{name}: {len(pairs)} targets, a launch takes 1..{KERNEL_MAX_TARGETS}")
    a0 = pairs[0][0]
    for a, b in pairs:
        if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
            raise ValueError(f"{name}: factors must be a [NA, in, R], b [NA, R, out], got "
                             f"{tuple(a.shape)} and {tuple(b.shape)}")
        if a.shape[1] != n_in:
            raise ValueError(f"{name}: a maps {a.shape[1]} inputs, x has {n_in}")
        if a.dtype not in _DTYPE_CODE or b.dtype != a.dtype or a.dtype != a0.dtype:
            raise TypeError(f"{name}: factors must all be one of {list(_DTYPE_CODE)} and "
                            f"alike, got {a.dtype} and {b.dtype}")
        if a.shape[0] != a0.shape[0] or a.shape[2] != a0.shape[2]:
            raise ValueError(f"{name}: the targets of a group share NA and the rank, got "
                             f"{tuple(a.shape)} beside {tuple(a0.shape)}")
        R, n_out = a.shape[2], b.shape[2]
        if not 1 <= R <= KERNEL_MAX_RANK:
            raise ValueError(f"{name}: rank {R}, the kernel takes 1..{KERNEL_MAX_RANK}")
        if n_in % 8 or n_out % 8:
            raise ValueError(f"{name}: in = {n_in} and out = {n_out} must be multiples of 8")
        for key, t in (("a", a), ("b", b)):
            if t.device != x.device:
                raise ValueError(f"{name}: {key} is on {t.device}, x on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {key} must be contiguous")
            if t.data_ptr() % 16:  # read 16 bytes at a time
                raise ValueError(f"{name}: {key} must be 16-byte aligned")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: x must be 16-byte aligned")
    if ids.dim() != 1 or ids.shape[0] != N or ids.dtype != torch.int32:
        raise ValueError(f"{name}: ids must be int32 [{N}], got {ids.dtype} "
                         f"{tuple(ids.shape)}")


def lora_bgmv_group(x: torch.Tensor, pairs, ids: torch.Tensor) -> list[torch.Tensor]:
    """Per-row deltas B_t[ids[n]]·(A_t[ids[n]]ᵀ x[n]) for 1-3 targets t that
    share x → [[N, out_t] in x.dtype, ...]: one launch of the CUDA kernel for
    tensors on the card, the plain version target by target on the CPU.
    pairs: [(a [NA, in, R], b [NA, R, out_t]), ...] with one NA and one R.

    `ids` lies on x's device, or on the CPU: host ids are checked against
    [0, NA) here and then copied to the card. Ids already on the card are
    not checked on the host (that would wait for the device); the kernel
    writes NaN into a row whose id is outside [0, NA) and reads nothing
    for it."""
    pairs = list(pairs)
    if x.device.type == "cpu":
        return [lora_delta_plain(x, a, b, ids) for a, b in pairs]
    if x.device.type != "cuda":
        raise ValueError(f"lora_bgmv: unsupported device {x.device}")
    _check_group_args(x, pairs, ids)
    NA, R = pairs[0][0].shape[0], pairs[0][0].shape[2]
    if ids.device.type == "cpu":
        if bool(((ids < 0) | (ids >= NA)).any()):
            raise ValueError(f"lora_bgmv: adapter ids {ids.tolist()} outside [0, {NA})")
        ids = ids.to(x.device, non_blocking=True)
    elif ids.device != x.device:
        raise ValueError(f"lora_bgmv: ids are on {ids.device}, x on {x.device}")
    N, n_in = x.shape
    outs = [torch.empty((N, b.shape[2]), dtype=x.dtype, device=x.device) for _, b in pairs]
    if N == 0:
        return outs
    plan = lora_plan(n_in, [b.shape[2] for _, b in pairs], R, N, NA)
    pad = KERNEL_MAX_TARGETS - len(pairs)
    lib = kernels.load("lora_matmul")
    with torch.cuda.device(x.device):  # the library launches on the current device
        rc = lib.lora_bgmv_group(
            x.data_ptr(), ids.data_ptr(), *[a.data_ptr() for a, _ in pairs], *[None] * pad,
            *[b.data_ptr() for _, b in pairs], *[None] * pad,
            *[o.data_ptr() for o in outs], *[None] * pad,
            *[o.shape[1] for o in outs], *[0] * pad, *plan.cols, *[0] * pad,
            len(pairs), N, n_in, R, NA, _DTYPE_CODE[x.dtype], _DTYPE_CODE[pairs[0][0].dtype],
            plan.cluster, plan.slice_rows, plan.pass_rows, plan.pass_cols, plan.slots,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"lora_bgmv kernel launch failed: CUDA error {rc}")
    lora_bgmv_group.launches += 1
    return outs


# Launches of the CUDA kernel, one per grouped call (the plain CPU route
# does not count).
lora_bgmv_group.launches = 0


def lora_bgmv(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """One target's per-row delta B[ids[n]]·(A[ids[n]]ᵀ x[n]) → [N, out] in
    x.dtype: `lora_bgmv_group` with one target (one launch on the card, the
    plain version on the CPU)."""
    return lora_bgmv_group(x, [(a, b)], ids)[0]


def lora_deltas(x: torch.Tensor, entries, ids: torch.Tensor) -> list[torch.Tensor]:
    """Per-row LoRA deltas of the targets that share the input x (q / k / v,
    or gate / up): entries [{"a": [NA, in, R], "b": [NA, R, out]}, ...], one
    layer's slices of the engine's stacked adapter tensors; ids [B] int32
    device-adapter rows (0 = none). A 2-D float x of 1..LORA_KERNEL_MAX_ROWS
    rows (decode) takes one kernel launch for up to KERNEL_MAX_TARGETS
    targets; anything else (prefill [B, S, in], more rows, a non-float x)
    the gather form target by target, exactly where the JAX package leaves
    its Pallas kernel for XLA. Each target's rows are computed exactly as
    they would be alone."""
    if x.dim() == 2 and x.is_floating_point() and 0 < x.shape[0] <= LORA_KERNEL_MAX_ROWS:
        return lora_bgmv_group(x.contiguous(), [(e["a"], e["b"]) for e in entries], ids)
    return [lora_delta_gather(x, e["a"], e["b"], ids) for e in entries]


def lora_delta(x: torch.Tensor, factors: dict, ids: torch.Tensor) -> torch.Tensor:
    """Per-row LoRA delta y = B[id]·(A[id]·x) for one target projection:
    `lora_deltas` with one entry."""
    return lora_deltas(x, [factors], ids)[0]
