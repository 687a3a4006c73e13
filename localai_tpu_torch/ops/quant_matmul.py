"""Fused dequant-matmul (B3) and int8 unembed (B4) for quantized decode
(localai_tpu/ops/quant_matmul.py).

The wrappers `qmm` and `qunembed` launch the hand-written CUDA kernels of
`csrc/quant_matmul.cu` for tensors on the card; they replace the TPU
kernels localai_tpu/ops/quant_matmul.py::_qmm_kernel and ::_unembed_kernel.
For tensors on the CPU they run `qmm_plain` / `qunembed_plain`, the
kernels' function in plain PyTorch, which is also what the kernels are
held against on the card. There is no other route: a CUDA tensor the
kernel does not take (dtype, shape, alignment), a failed build or a failed
launch raises.

Weight forms (models/quant.py):
- flat int8      {"q": [in, out] i8,       "s": [1, out] f32}
- grouped int8   {"gq": [G, gs, out] i8,   "gs": [G, 1, out] f32}
- packed int4    {"g4": [G, gs/2, out] u8, "gs", "gz": [G, 1, out] f32}
  (low nibble = first gs/2 in-rows of the group; value = nibble·s − z)
- unembed        {"q": [V, D] i8, "s": [V, 1] f32}, used transposed.

B3 on bf16 x splits the reduction across blocks by the plan of
`qmm_plan`, a plain function of the shapes and the card's SM count; the
split partials go to a workspace and counters that the wrapper keeps, one
pair per device, grown when a product needs more and never allocated per
call. The port issues every product in order on one stream, which is what
makes one workspace per device safe.

B4 on bf16 h runs persistent blocks over the vocab tiles by the plan of
`qunembed_plan`, also a plain function of the shapes and the SM count; it
never splits the reduction, so it needs no workspace.

The dispatchers `dispatch_matmul` / `dispatch_unembed` take decode-shape
calls (at most QUANT_KERNEL_MAX_ROWS float rows) and return None for the
rest, which models/quant.py serves with its dequantize-then-matmul forms,
exactly where the JAX package leaves its Pallas kernels for XLA.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from localai_tpu_torch import kernels

# Rows (flattened leading dims of x) above which the kernels disengage: the
# JAX package's QUANT_PALLAS_MAX_ROWS, kept as the reference's split.
QUANT_KERNEL_MAX_ROWS = 256
# The group size of the grouped forms the CUDA kernel takes
# (csrc/quant_matmul.cu): models/quant.GROUP_SIZE, GGUF's blocks.
KERNEL_GROUP = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FORM_CODE = {"q": 0, "gq": 1, "g4": 2}
# Split plans fill the card this many times over with blocks, each split
# walking at least _MIN_SLICE_GROUPS groups of 32 in-rows, in whole stages
# of the kernel's cp.async ring (4 groups: one int4 stage, two int8 stages).
_BLOCKS_PER_SM = 2
_MIN_SLICE_GROUPS = 4
_STAGE_GROUPS = 4


class QmmPlan(NamedTuple):
    """How B3's bf16 kernel cuts x [N, in] @ w [in, out] into blocks."""

    row_tile: int    # rows of x a block: 8 or 16 (N <= 16), else 64
    block_cols: int  # output columns a block: 128, or 64 with 64-row tiles
    splits: int      # blocks that share one output tile, each over its own k-slice
    k_slice: int     # in-rows a split walks: whole groups of 32; the last split may be short

    def tiles(self, n_rows: int, n_out: int) -> int:
        """Output tiles, each with its own split counter."""
        return -(-n_out // self.block_cols) * -(-n_rows // self.row_tile)

    def workspace_floats(self, n_rows: int, n_out: int) -> int:
        """f32 partials the splits of one product write (none unsplit)."""
        if self.splits == 1:
            return 0
        return self.tiles(n_rows, n_out) * self.splits * self.row_tile * self.block_cols


def qmm_plan(n_in: int, n_out: int, n_rows: int, sm_count: int) -> QmmPlan:
    """The split plan of B3's bf16 kernel. Up to 16 rows (every decode
    batch) the plan depends on (n_in, n_out) only, so a row's sums run in
    the same order whatever the batch; 8 and 16 rows differ in the row tile
    alone, which does not change a row's arithmetic. The split count is the
    least that gives _BLOCKS_PER_SM blocks per SM, within k-slices of at
    least _MIN_SLICE_GROUPS groups and whole stages; no split is empty."""
    if n_rows <= 16:
        row_tile, block_cols, row_tiles = (8 if n_rows <= 8 else 16), 128, 1
    else:
        row_tile, block_cols = 64, 64
        row_tiles = -(-n_rows // row_tile)
    tiles = -(-n_out // block_cols) * row_tiles
    groups = -(-n_in // KERNEL_GROUP)
    want = -(-_BLOCKS_PER_SM * sm_count // tiles)
    splits = max(1, min(want, groups // _MIN_SLICE_GROUPS))
    slice_groups = -(-groups // splits)
    slice_groups = -(-slice_groups // _STAGE_GROUPS) * _STAGE_GROUPS
    splits = -(-groups // slice_groups)
    return QmmPlan(row_tile, block_cols, splits, slice_groups * KERNEL_GROUP)


# B4's bf16 kernel (csrc/quant_matmul.cu, unembed_mma_kernel): warps a
# persistent block, head columns a chunk, bf16 of padding after each staged
# h row, and the shared memory the staged h may take (of the 227 KB a block
# can have).
UNEMBED_WARPS = 16
_UNEMBED_CHUNK = 64
_UNEMBED_HPAD = 4
UNEMBED_SMEM_BYTES = 200 * 1024


class UnembedPlan(NamedTuple):
    """How B4's bf16 kernel cuts h [N, D] @ q[V, D]ᵀ into blocks."""

    row_tile: int  # h rows a block: 8 or 16 (N <= 16), else 64
    k_slice: int   # h columns staged at a time: all of D (whole chunks of 64) where it fits
    blocks: int    # persistent blocks per row tile, each over a contiguous range of tiles

    def tile_range(self, block: int, n_vocab: int) -> range:
        """The 16-row vocab tiles block `block` walks, as the kernel computes
        them (a warp sums one tile at a time)."""
        tiles = -(-n_vocab // 16)
        return range(block * tiles // self.blocks, (block + 1) * tiles // self.blocks)


def qunembed_plan(n_vocab: int, d: int, n_rows: int, sm_count: int) -> UnembedPlan:
    """The plan of B4's bf16 kernel. Up to 16 rows it depends on
    (n_vocab, d) only but for the row tile (8 or 16), which does not change
    a row's arithmetic: one block an SM, h staged once where 16 rows of it
    fit. Above 16 rows, 64-row tiles with h staged in k-slices, the SMs
    shared among the row tiles. A warp sums a tile over the chunks of d in
    order whatever the plan; no plan splits the reduction."""
    row_tile = 8 if n_rows <= 8 else 16 if n_rows <= 16 else 64
    smem_rows = max(row_tile, 16)
    fit = (UNEMBED_SMEM_BYTES // (2 * smem_rows) - _UNEMBED_HPAD) // _UNEMBED_CHUNK
    k_slice = min(-(-d // _UNEMBED_CHUNK), fit) * _UNEMBED_CHUNK
    row_tiles = -(-n_rows // row_tile)
    blocks = min(-(-(-(-n_vocab // 16)) // UNEMBED_WARPS), max(1, sm_count // row_tiles))
    return UnembedPlan(row_tile, k_slice, max(1, blocks))


# device index -> (f32 partials, int32 counters), grown on demand
_workspaces: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}


def _rows(x: torch.Tensor, tail: int = 1) -> int:
    r = 1
    for d in x.shape[: x.dim() - tail]:
        r *= int(d)
    return r


def _payload_key(w: dict) -> str:
    for key in ("q", "gq", "g4"):
        if key in w:
            return key
    raise ValueError(f"not a quantized weight: keys {sorted(w)}")


def _grouped_values(w: dict, dtype) -> torch.Tensor:
    """[..., G, gs, out] un-scaled values of a grouped dict (int4 nibbles
    unpacked low half first)."""
    if "g4" in w:
        qp = w["g4"]
        return torch.cat([qp & 0xF, qp >> 4], dim=-2).to(dtype)
    return w["gq"].to(dtype)


def qmm_plain(x: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain version of B3: x [N, in] @ the quantized w → [N, out] in
    x.dtype. Dequantizes in f32 (grouped scales on the values), f32
    products, the flat scale applied to the finished sum and the int4 zero
    point as the rank-1 correction −Σ_g (Σ_{i∈g} x_i)·z_g, as the TPU
    kernel computes them."""
    xf = x.float()
    if "q" in w:
        return ((xf @ w["q"].float()) * w["s"].float()[0]).to(x.dtype)
    vals = _grouped_values(w, torch.float32)  # [G, gs, out]
    G, gs, out = vals.shape
    acc = xf @ (vals * w["gs"].float()).reshape(G * gs, out)
    if "gz" in w:
        xs = xf.reshape(xf.shape[0], G, gs).sum(dim=-1)  # [N, G]
        acc = acc - xs @ w["gz"].float()[:, 0, :]
    return acc.to(x.dtype)


def qunembed_plain(h: torch.Tensor, w: dict) -> torch.Tensor:
    """Plain version of B4: h [N, D] @ qᵀ · s → f32 logits [N, V]."""
    return (h.float() @ w["q"].float().t()) * w["s"].float()[:, 0]


def _check_common(x, leaves, name: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [rows, in], got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be one of {list(_DTYPE_CODE)}, got {x.dtype}")
    if x.shape[0] > QUANT_KERNEL_MAX_ROWS:
        raise ValueError(f"{name}: {x.shape[0]} rows, the kernel takes at most "
                         f"{QUANT_KERNEL_MAX_ROWS}")
    for key, t in leaves:
        if t.device != x.device:
            raise ValueError(f"{name}: {key} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")


def _check_qmm_args(x, w: dict) -> tuple[int, int, int]:
    """(form code, out, group size) after checking what the kernel takes."""
    key = _payload_key(w)
    pay = w[key]
    leaves = [(k, w[k]) for k in (key, "s", "gs", "gz") if k in w]
    _check_common(x, leaves, "qmm")
    n_in = x.shape[1]
    if key == "q":
        if pay.dim() != 2 or pay.dtype != torch.int8 or pay.shape[0] != n_in:
            raise ValueError(f"qmm: flat weight must be int8 [{n_in}, out], got "
                             f"{pay.dtype} {tuple(pay.shape)}")
        out, gs = pay.shape[1], 0
        scales = {"s": (1, out)}
    else:
        want = torch.uint8 if key == "g4" else torch.int8
        if pay.dim() != 3 or pay.dtype != want:
            raise ValueError(f"qmm: {key} must be {want} [G, rows, out], got "
                             f"{pay.dtype} {tuple(pay.shape)}")
        G, rows, out = pay.shape
        gs = rows * 2 if key == "g4" else rows
        if G * gs != n_in:
            raise ValueError(f"qmm: {G} groups of {gs} do not cover in = {n_in}")
        if gs != KERNEL_GROUP:
            raise ValueError(f"qmm: group size {gs} not supported by the kernel "
                             f"(needs {KERNEL_GROUP})")
        scales = {"gs": (G, 1, out)}
        if key == "g4":
            scales["gz"] = (G, 1, out)
    for name, shape in scales.items():
        t = w.get(name)
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"qmm: {name} must be float32 {list(shape)}")
        if t.data_ptr() % 16:  # read as float4
            raise ValueError(f"qmm: {name} must be 16-byte aligned")
    if out % 4:
        raise ValueError(f"qmm: out = {out} must be a multiple of 4 (32-bit weight loads)")
    if pay.data_ptr() % 4:
        raise ValueError("qmm: the weight must be 4-byte aligned")
    if x.dtype == torch.bfloat16:  # the tensor-core kernel's 16-byte cp.async copies
        if out % 16:
            raise ValueError(f"qmm: bf16 x needs out = {out} to be a multiple of 16 "
                             "(16-byte weight rows)")
        if pay.data_ptr() % 16:
            raise ValueError(f"qmm: bf16 x needs the weight {key} 16-byte aligned")
        if n_in % 8 or x.data_ptr() % 16:
            raise ValueError(f"qmm: bf16 x needs x 16-byte aligned with in = {n_in} "
                             "a multiple of 8")
    return _FORM_CODE[key], out, gs


def qmm(x: torch.Tensor, w: dict) -> torch.Tensor:
    """x [N, in] @ the quantized weight w → [N, out] in x.dtype: the CUDA
    kernel for tensors on the card, the plain version on the CPU."""
    if x.device.type == "cpu":
        return qmm_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"qmm: unsupported device {x.device}")
    form, out_dim, gs = _check_qmm_args(x, w)
    N, n_in = x.shape
    out = torch.empty((N, out_dim), dtype=x.dtype, device=x.device)
    s = w["s"] if form == 0 else w["gs"]
    z = w.get("gz")
    ws = cnt = None
    plan = QmmPlan(0, 0, 1, 0)  # f32 x: the scalar kernel takes no plan
    if x.dtype == torch.bfloat16:
        plan = qmm_plan(n_in, out_dim, N, kernels.sm_count(x.device))
        if plan.splits > 1:
            ws, cnt = kernels.grow_workspace(_workspaces, x.device,
                                             plan.workspace_floats(N, out_dim),
                                             plan.tiles(N, out_dim))
    lib = kernels.load("quant_matmul")
    with torch.cuda.device(x.device):  # the library launches on the current device
        rc = lib.quant_matmul(
            x.data_ptr(), w[_payload_key(w)].data_ptr(), s.data_ptr(),
            None if z is None else z.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), None if cnt is None else cnt.data_ptr(),
            N, n_in, out_dim, form, gs, _DTYPE_CODE[x.dtype], plan.row_tile, plan.block_cols,
            plan.splits, plan.k_slice, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")
    qmm.launches += 1
    return out


# Launches of the CUDA kernel (the plain CPU route does not count).
qmm.launches = 0


def _check_unembed_args(h, w: dict) -> None:
    q, s = w.get("q"), w.get("s")
    if q is None or s is None:
        raise ValueError("qunembed: the head must be {'q': [V, D] int8, 's': [V, 1] f32}")
    _check_common(h, [("q", q), ("s", s)], "qunembed")
    V, D = q.shape if q.dim() == 2 else (0, 0)
    if q.dtype != torch.int8 or q.dim() != 2 or D != h.shape[1]:
        raise ValueError(f"qunembed: q must be int8 [V, {h.shape[1]}], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if s.dtype != torch.float32 or tuple(s.shape) != (V, 1):
        raise ValueError(f"qunembed: s must be float32 [{V}, 1], got {s.dtype} {tuple(s.shape)}")
    if D % 16 or q.data_ptr() % 16:
        raise ValueError(f"qunembed: rows of q must be 16-byte aligned (D = {D})")


def qunembed(h: torch.Tensor, w: dict) -> torch.Tensor:
    """h [N, D] @ qᵀ · s → f32 logits [N, V]: the CUDA kernel for tensors on
    the card, the plain version on the CPU."""
    if h.device.type == "cpu":
        return qunembed_plain(h, w)
    if h.device.type != "cuda":
        raise ValueError(f"qunembed: unsupported device {h.device}")
    _check_unembed_args(h, w)
    N, D = h.shape
    V = w["q"].shape[0]
    out = torch.empty((N, V), dtype=torch.float32, device=h.device)
    plan = UnembedPlan(0, 0, 0)  # f32 h: the scalar kernel takes no plan
    if h.dtype == torch.bfloat16:
        plan = qunembed_plan(V, D, N, kernels.sm_count(h.device))
    lib = kernels.load("quant_matmul")
    with torch.cuda.device(h.device):
        rc = lib.quant_unembed(
            h.data_ptr(), w["q"].data_ptr(), w["s"].data_ptr(), out.data_ptr(), N, D, V,
            _DTYPE_CODE[h.dtype], plan.row_tile, plan.k_slice, plan.blocks,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"quant_unembed kernel launch failed: CUDA error {rc}")
    qunembed.launches += 1
    return out


# Launches of the CUDA kernel (the plain CPU route does not count).
qunembed.launches = 0


# --------------------------------------------------------------------------- #
# Dispatchers (None → the caller's dequantize-then-matmul form serves)
# --------------------------------------------------------------------------- #


def _engaged(x: torch.Tensor, tail: int = 1) -> bool:
    return x.is_floating_point() and 0 < _rows(x, tail) <= QUANT_KERNEL_MAX_ROWS


def dispatch_matmul(x: torch.Tensor, w: dict):
    """Fused x @ w for the dense quantized forms, or None (prefill-scale
    rows, a non-float x, a weight with an expert axis)."""
    leaf = w.get("q", w.get("gq", w.get("g4")))
    if leaf is None or leaf.dim() != (2 if "q" in w else 3):
        return None
    if not _engaged(x):
        return None
    lead = x.shape[:-1]
    y = qmm(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*lead, y.shape[-1])


def dispatch_moe_mm(x, w: dict, sub: str):
    """The MoE variants of B3 come with the MoE port."""
    raise NotImplementedError(
        "quantized mixture-of-experts matmuls are not ported yet (ROADMAP Queue A item 10, "
        "with Queue B part 1 item 3)")


def dispatch_unembed(h: torch.Tensor, w: dict):
    """Fused h @ qᵀ·s for the quantized lm_head, or None."""
    if "q" not in w or w["q"].dim() != 2 or w["s"].shape[-1] != 1:
        return None
    if not _engaged(h):
        return None
    lead = h.shape[:-1]
    y = qunembed(h.reshape(-1, h.shape[-1]).contiguous(), w)
    return y.reshape(*lead, y.shape[-1])
