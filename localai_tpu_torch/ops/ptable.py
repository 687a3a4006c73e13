"""Page-table helpers shared by the paged-attention ops, the model's pool
writers and the engine (localai_tpu/ops/ptable.py).

Two layouts resolve a slot's page COLUMN j (rows [j·page, (j+1)·page) of
its context) to a pool page id:

- FLAT `table[..., MP] int32`: one page id per column.
- HIER `(l1 [..., ML1] int32, l0 [NTP, SPAN] int32)`: a two-level radix.
  Column j resolves through `l0[l1[..., j // SPAN], j % SPAN]`. Each slot
  carries an ML1 = MP / SPAN entry directory of TABLE-PAGE ids; the l0
  table-page pool is global (row 0 is the all-SCRATCH table page idle
  directory entries point at), so a million-token slot ships 64 entries
  instead of an 8192-wide row.

Every consumer goes through these helpers, so one code path serves both
layouts; the engine picks one per `EngineConfig.kv_l1_span` (0 = flat).
The reference's shard specs wait for the tp port (ROADMAP Queue A item
14), its dirty-diff upload helpers for pipelined dispatch (item 1).
"""

from __future__ import annotations

import torch


def is_hier(table) -> bool:
    """True when `table` is the hierarchical (l1, l0) pair."""
    return isinstance(table, (tuple, list))


def width(table) -> int:
    """Logical column count MP."""
    if is_hier(table):
        l1, l0 = table
        return l1.shape[-1] * l0.shape[-1]
    return table.shape[-1]


def gather_cols(table, cols: torch.Tensor) -> torch.Tensor:
    """Resolve per-slot column indices to page ids. table flat [B, MP] or
    hier ([B, ML1], [NTP, SPAN]); cols [B, N] int; returns [B, N] page ids.
    Clamping out-of-range columns is the caller's job."""
    cols = cols.to(torch.int64)
    if is_hier(table):
        l1, l0 = table
        span = l0.shape[-1]
        tp = torch.gather(l1, -1, cols // span).to(torch.int64)  # [B, N]
        return l0[tp, cols % span]
    return torch.gather(table, -1, cols)


def row_lookup(table_row, idx):
    """Resolve column indices of ONE slot's table row: flat [MP] or hier
    ([ML1], [NTP, SPAN]); idx an int tensor or a Python int. Returns page
    ids shaped like idx."""
    if is_hier(table_row):
        l1, l0 = table_row
        span = l0.shape[-1]
        return l0[l1[idx // span], idx % span]
    return table_row[idx]


def select_row(table, j):
    """Row j of a batched table: flat [m, MP] -> [MP]; hier ([m, ML1], l0)
    -> ([ML1], l0): the l0 pool is global, so it rides whole."""
    if is_hier(table):
        l1, l0 = table
        return (l1[j], l0)
    return table[j]


def batch_row(table_row):
    """Lift one slot's table row to the batched form: flat [MP] -> [1, MP];
    hier ([ML1], l0) -> ([1, ML1], l0)."""
    if is_hier(table_row):
        l1, l0 = table_row
        return (l1[None], l0)
    return table_row[None]
