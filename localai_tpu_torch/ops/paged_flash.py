"""Ragged paged attention: online-softmax partials over each slot's own
pages (localai_tpu/ops/paged_flash.py).

The wrapper `paged_partials_rows` launches the hand-written CUDA kernel
`csrc/paged_attention.cu` for tensors on the card; it replaces the TPU
kernel localai_tpu/ops/paged_flash.py::_ragged_paged_kernel. For tensors on
the CPU it runs `paged_partials_plain`, the same online softmax walked page
by page in plain PyTorch, which is also what the kernel is held against on
the card. There is no other route: a CUDA tensor the kernel does not take
(dtype, head dim, layout), a failed build or a failed launch raises.

Shapes, as in the JAX package:
- q rows  [B, K, QR, D] f32 with 1/sqrt(D) applied; QR = G query rows per
  kv head for decode, T·G for a multi-query chunk (row r = t·G + g);
- pools   [P, page, K, D] (one layer's slice of the page pool), bf16, f32
  or fp8 (e4m3 / e5m2);
- kv_scale [2, K] f32 per-head (k, v) scales of a scaled fp8 pool, or None
  (all ones): the plain version multiplies each K / V element by its
  head's scale; the kernel, the same function, multiplies the head's q
  rows by the K scale and its finished acc by the V scale (it takes a
  scale with fp8 pools only);
- table   [B, MP] int32 page ids (flat; ops/ptable);
- limits  [B] int32: rows g >= limits[b] are masked, and the walk covers
  ceil(limits[b]/page) pages clamped to MP;
- qpos    [B, QR] int32 query positions (sliding-window distance).
The partials come back as acc [B, K, QR, D], m and l [B, K, QR], f32; the
merge with the block-local window stays in plain PyTorch
(ops/attention._merge_partials*), one numeric tail for every route.

The kernel splits each slot's rows across blocks by the plan of
`paged_plan`, a plain function of the table's capacity, the page, K, QR,
D, the pool type and the card's SM count (never of B or of the limits),
and the slot's own live rows (so a slot's partials do not depend on its
batch); the split partials go to a
workspace and counters that the wrapper keeps, one pair per device, grown
when a call needs more and never allocated per call. The port issues
every call in order on one stream, which is what makes one workspace per
device safe.

Not ported yet: hierarchical tables and the sink/swin cold-middle skip
(ROADMAP Queue A item 15).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from localai_tpu_torch import kernels
from localai_tpu_torch.ops import ptable as _pt

NEG_INF = -1e30
PAGED_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float8_e4m3fn: 2,
               torch.float8_e5m2: 3}


# Key rows of one stage of the kernel's cp.async ring; a split walks whole
# tiles of them.
KEY_TILE = 64
# A slot's rows are cut into splits of whole _SPLIT_UNIT rows, as few units
# a split as keep the slot within the plan's split count. The count aims at
# one block an SM for one slot, at most _MOST_SPLITS (more partials cost
# more to merge than they win at a full batch), raised where a split would
# span more than _TABLE_SLICE - 2 pages, up to _MAX_SPLITS (the kernel's
# kTableSlice and kMaxSplits).
_SPLIT_UNIT = 128
_MOST_SPLITS = 16
_TABLE_SLICE = 512
_MAX_SPLITS = 64


class PagedPlan(NamedTuple):
    """How B2 cuts q rows [B, K, QR, D] over a table of capacity MP·page."""

    kernel: str    # "mma" (bf16 / fp8 pools) or "scalar" (f32 pools)
    row_tile: int  # q rows a block: mma 16 (QR <= 16) or 64; scalar 4 (QR <= 4) or 16
    splits: int    # most splits a slot uses: the grid's blocks for each (slot, head, row tile)
    unit: int      # rows; a slot's splits are whole units (whole key tiles)

    def split_rows(self, n_rows: int) -> int:
        """Rows each split of a slot with n_rows live rows walks (the last
        may be short): the fewest whole units that need at most `splits`
        splits. The kernel computes the same from the slot's own limit."""
        units = -(-n_rows // self.unit)
        return max(1, -(-units // self.splits)) * self.unit

    def split_edges(self, n_rows: int) -> list[tuple[int, int]]:
        """[start, end) of each live split of a slot, in merge order; one
        empty split for a slot with no live row."""
        rows = self.split_rows(n_rows)
        return [(s, min(s + rows, n_rows)) for s in range(0, n_rows, rows)] or [(0, 0)]

    def tiles(self, B: int, K: int, QR: int) -> int:
        """(slot, head, row tile) triples, each with its own split counter."""
        return B * K * -(-QR // self.row_tile)

    def workspace_floats(self, B: int, K: int, QR: int, D: int) -> int:
        """f32 partials (m, l, acc) the splits of one call may write (none unsplit)."""
        if self.splits == 1:
            return 0
        return self.tiles(B, K, QR) * self.splits * self.row_tile * (D + 2)


def paged_plan(capacity: int, page: int, K: int, QR: int, D: int, pool_dtype,
               sm_count: int) -> PagedPlan:
    """The split plan of B2. It depends on the table's capacity (MP·page),
    the page, K, QR, D and the pool type, and the card's SM count, never on
    B or the limits (which live on the card): a slot's splits then follow
    from its own live rows alone (`PagedPlan.split_edges`). The split count
    is the least that gives one block an SM for one slot, at most
    _MOST_SPLITS, raised until a full slot's split spans at most
    _TABLE_SLICE - 2 pages (a table too wide for _MAX_SPLITS at its page
    size raises)."""
    if pool_dtype not in _DTYPE_CODE or D not in PAGED_HEAD_DIMS:
        raise ValueError(f"no plan for a {pool_dtype} pool at head dim {D}")
    if pool_dtype == torch.float32:
        kernel, row_tile = "scalar", (4 if QR <= 4 else 16)
    else:
        kernel, row_tile = "mma", (16 if QR <= 16 else 64)
    tiles = K * -(-QR // row_tile)
    splits = max(1, min(-(-sm_count // tiles), _MOST_SPLITS))
    widest = (_TABLE_SLICE - 2) * page // _SPLIT_UNIT  # units a split's table slice holds
    units = -(-capacity // _SPLIT_UNIT)  # a full slot's units
    splits = max(splits, -(-units // widest))
    if splits > _MAX_SPLITS:
        raise ValueError(f"a table of {capacity} rows in pages of {page} needs {splits} "
                         f"splits; the kernel takes at most {_MAX_SPLITS}")
    return PagedPlan(kernel, row_tile, splits, _SPLIT_UNIT)


def plan_for(qr: torch.Tensor, k_pool: torch.Tensor, table: torch.Tensor,
             sm_count: int) -> PagedPlan:
    """The plan of one call, from every shape it has but B."""
    _, K, QR, D = qr.shape
    page = k_pool.shape[1]
    return paged_plan(table.shape[-1] * page, page, K, QR, D, k_pool.dtype, sm_count)


_workspaces: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}  # device index -> (partials, counters)


def reject_unported(sink: int = 0, swin: int = 0, mesh=None) -> None:
    """Raise for the paged-attention features the port does not serve."""
    if sink or swin:
        raise NotImplementedError(
            "sink+window paged attention is not ported yet (ROADMAP Queue A item 15)")
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel paged attention is not ported yet (ROADMAP Queue A item 20)")


def _window_of(window: int, sliding) -> int:
    """The sliding window a layer applies: 0 for a global layer."""
    return int(window) if (window and sliding) else 0


def paged_partials_plain(
    qr: torch.Tensor,  # [B, K, QR, D] f32, scale applied
    qpos: torch.Tensor,  # [B, QR] int
    k_pool: torch.Tensor,  # [P, page, K, D]
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, MP] int
    limits: torch.Tensor,  # [B] int
    softcap: float = 0.0,
    window: int = 0,  # the layer's sliding window, 0 for none
    kv_scale: torch.Tensor | None = None,  # [2, K] f32
):
    """Plain PyTorch version of the kernel: the online softmax walked one
    table column (page) at a time for every slot, rows past each slot's
    limit masked, pool rows multiplied by `kv_scale`. Returns
    (acc [B, K, QR, D], m [B, K, QR], l [B, K, QR])."""
    table = _pt._flat(table)
    B, K, QR, D = qr.shape
    page = k_pool.shape[1]
    MP = table.shape[1]
    dev = qr.device
    qf = qr.float()
    lim = limits.to(device=dev, dtype=torch.int64)
    qp = qpos.to(device=dev, dtype=torch.int64)
    # The plain version may read the limits back; the kernel never does.
    n_pages = min(-(-max(int(lim.max()), 0) // page), MP) if B else 0
    m = torch.full((B, K, QR), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, K, QR), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, QR, D), dtype=torch.float32, device=dev)
    offs = torch.arange(page, device=dev)
    for j in range(n_pages):
        pid = table[:, j].to(torch.int64)
        kp = k_pool[pid].float()  # [B, page, K, D]
        vp = v_pool[pid].float()
        if kv_scale is not None:
            kp = kp * kv_scale[0][:, None].float()
            vp = vp * kv_scale[1][:, None].float()
        s = torch.einsum("bkrd,bskd->bkrs", qf, kp)
        if softcap:
            s = softcap * torch.tanh(s / softcap)  # before the mask
        gpos = j * page + offs  # [page]
        valid = (gpos[None, :] < lim[:, None])[:, None, None, :]  # [B, 1, 1, page]
        if window:
            valid = valid & ((qp[:, None, :, None] - gpos) < window)  # [B, 1, QR, page]
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(torch.clamp(m - m_new, min=-80.0))
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)  # masked after exp
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bkrs,bskd->bkrd", p, vp)
        m = m_new
    return acc, m, l


def _check_cuda_args(qr, qpos, k_pool, v_pool, table, limits, kv_scale) -> None:
    if qr.dim() != 4 or k_pool.dim() != 4 or v_pool.dim() != 4:
        raise ValueError("q rows must be [B, K, QR, D] and the pools [P, page, K, D]")
    B, K, QR, D = qr.shape
    if k_pool.shape != v_pool.shape or k_pool.shape[2] != K or k_pool.shape[3] != D:
        raise ValueError(f"pool shape {tuple(k_pool.shape)} does not match q rows {tuple(qr.shape)}")
    if D not in PAGED_HEAD_DIMS:
        raise ValueError(f"head dim {D} not supported by the kernel (needs {PAGED_HEAD_DIMS})")
    if qr.dtype != torch.float32:
        raise TypeError(f"q rows must be float32, got {qr.dtype}")
    if k_pool.dtype not in _DTYPE_CODE or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share one of {list(_DTYPE_CODE)}; got "
                        f"{k_pool.dtype}, {v_pool.dtype}")
    for name, t, shape in (("table", table, (B, table.shape[-1])), ("limits", limits, (B,)),
                           ("qpos", qpos, (B, QR))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise TypeError(f"{name} must be int32 {list(shape)}, got {t.dtype} {tuple(t.shape)}")
    for name, t in (("q rows", qr), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table),
                    ("limits", limits), ("qpos", qpos)):
        if t.device != qr.device:
            raise ValueError(f"{name} is on {t.device}, q rows on {qr.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:  # rows are read in 16-byte loads
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_scale is None:
        return
    if k_pool.element_size() != 1:
        raise ValueError(f"kv_scale applies to fp8 pools, got a {k_pool.dtype} pool")
    if (kv_scale.dtype != torch.float32 or tuple(kv_scale.shape) != (2, K)
            or kv_scale.device != k_pool.device or not kv_scale.is_contiguous()):
        raise ValueError(f"kv_scale must be a contiguous float32 [2, {K}] on {k_pool.device}, "
                         f"got {kv_scale.dtype} {tuple(kv_scale.shape)} on {kv_scale.device}")


def paged_partials_rows(
    qr: torch.Tensor,  # [B, K, QR, D] f32, scale applied
    qpos: torch.Tensor,  # [B, QR] int32
    k_pool: torch.Tensor,  # [P, page, K, D] bf16 | f32 | fp8 e4m3 | fp8 e5m2
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, MP] int32
    limits: torch.Tensor,  # [B] int32
    softcap: float = 0.0,
    window: int = 0,  # the layer's sliding window, 0 for none
    kv_scale: torch.Tensor | None = None,  # [2, K] f32, None for all ones
):
    """Paged partials (acc [B, K, QR, D], m, l [B, K, QR], f32): the CUDA
    kernel for tensors on the card, the plain version on the CPU. Reads
    nothing back to the host on the card."""
    if qr.device.type == "cpu":
        return paged_partials_plain(qr, qpos, k_pool, v_pool, table, limits, softcap, window,
                                    kv_scale)
    if qr.device.type != "cuda":
        raise ValueError(f"paged_partials_rows: unsupported device {qr.device}")
    table = _pt._flat(table)
    _check_cuda_args(qr, qpos, k_pool, v_pool, table, limits, kv_scale)
    B, K, QR, D = qr.shape
    P, page = k_pool.shape[:2]
    MP = table.shape[1]
    acc = torch.empty((B, K, QR, D), dtype=torch.float32, device=qr.device)
    m = torch.empty((B, K, QR), dtype=torch.float32, device=qr.device)
    l = torch.empty_like(m)
    plan = plan_for(qr, k_pool, table, kernels.sm_count(qr.device))
    ws, cnt = kernels.grow_workspace(_workspaces, qr.device, plan.workspace_floats(B, K, QR, D),
                                     plan.tiles(B, K, QR))
    lib = kernels.load("paged_attention")
    with torch.cuda.device(qr.device):  # the library launches on the current device
        rc = lib.paged_attention(
            qr.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
            limits.data_ptr(), qpos.data_ptr(),
            None if kv_scale is None else kv_scale.data_ptr(),
            acc.data_ptr(), m.data_ptr(), l.data_ptr(), ws.data_ptr(), cnt.data_ptr(),
            B, K, QR, D, P, page, MP, _DTYPE_CODE[k_pool.dtype], int(window), float(softcap),
            plan.row_tile, plan.splits, plan.unit,
            torch.cuda.current_stream(qr.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA error {rc}")
    paged_partials_rows.launches += 1
    return acc, m, l


# Launches of the CUDA kernel (the plain CPU route does not count).
paged_partials_rows.launches = 0


def _rows_call(qr, qpos_rows, k_pool, v_pool, table, limits, softcap, window, kv_scale):
    """Cast the control operands to what the kernel takes and call it."""
    i32 = dict(device=qr.device, dtype=torch.int32)
    return paged_partials_rows(
        qr.contiguous(), qpos_rows.to(**i32).contiguous(), k_pool, v_pool,
        table.to(**i32).contiguous(), limits.to(**i32).contiguous(), softcap, window, kv_scale)


def paged_decode_partials(
    q: torch.Tensor,  # [B, H, D]
    k_pool: torch.Tensor,  # [P, page, K, D]
    v_pool: torch.Tensor,
    table: torch.Tensor,  # [B, MP] int32
    limits: torch.Tensor,  # [B] int32
    softcap: float = 0.0,
    window: int = 0,
    sliding=None,
    q_pos=None,  # [B]
    kv_scale=None,
    sink: int = 0,
    swin: int = 0,
):
    """Decode partials: (acc [B, K, G, D], m [B, K, G, 1], l [B, K, G, 1])
    f32, the JAX package's contract."""
    reject_unported(sink, swin)
    B, H, D = q.shape
    K = k_pool.shape[2]
    G = H // K
    if q_pos is None:
        q_pos = limits
    qr = (q.float() * (1.0 / math.sqrt(D))).reshape(B, K, G, D)
    qpos_rows = q_pos.reshape(B, 1).expand(B, G)
    acc, m, l = _rows_call(qr, qpos_rows, k_pool, v_pool, table, limits, softcap,
                           _window_of(window, sliding), kv_scale)
    return acc, m[..., None], l[..., None]


def paged_decode_partials_mq(
    q: torch.Tensor,  # [B, T, H, D]
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    limits: torch.Tensor,
    softcap: float = 0.0,
    window: int = 0,
    sliding=None,
    q_pos=None,  # [B, T]
    kv_scale=None,
    sink: int = 0,
    swin: int = 0,
):
    """Multi-query partials, one page walk shared by all T queries (row
    r = t·G + g). Returns (acc [B, K, G, T, D], m [B, K, G, T, 1],
    l [B, K, G, T, 1])."""
    reject_unported(sink, swin)
    B, T, H, D = q.shape
    K = k_pool.shape[2]
    G = H // K
    if q_pos is None:
        q_pos = limits.reshape(B, 1).expand(B, T)
    qr = ((q.float() * (1.0 / math.sqrt(D)))
          .reshape(B, T, K, G, D).permute(0, 2, 1, 3, 4).reshape(B, K, T * G, D))
    qpos_rows = torch.repeat_interleave(q_pos, G, dim=1)  # [B, T*G]
    acc, m, l = _rows_call(qr, qpos_rows, k_pool, v_pool, table, limits, softcap,
                           _window_of(window, sliding), kv_scale)
    acc = acc.reshape(B, K, T, G, D).transpose(2, 3)
    m = m.reshape(B, K, T, G).transpose(2, 3)[..., None]
    l = l.reshape(B, K, T, G).transpose(2, 3)[..., None]
    return acc, m, l


def paged_prefill_partials_mq(
    q: torch.Tensor,  # [B, T, H, D], T = prefill-chunk tokens
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    table: torch.Tensor,
    limits: torch.Tensor,  # [B] rows already resident (the chunk's offset)
    softcap: float = 0.0,
    window: int = 0,
    sliding=None,
    q_pos=None,  # [B, T] global positions of the chunk tokens
    kv_scale=None,
    sink: int = 0,
    swin: int = 0,
):
    """`paged_decode_partials_mq` for a prefill chunk. The kernel takes the
    whole chunk in one launch (query-row tiles are its grid), so the TPU
    kernel's host-side tiling of the token axis, a VMEM bound, has no
    counterpart here."""
    return paged_decode_partials_mq(q, k_pool, v_pool, table, limits, softcap=softcap,
                                    window=window, sliding=sliding, q_pos=q_pos,
                                    kv_scale=kv_scale, sink=sink, swin=swin)
