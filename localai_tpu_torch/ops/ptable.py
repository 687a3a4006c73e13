"""Page-table helpers shared by the paged-attention ops, the model's pool
writers and the engine (localai_tpu/ops/ptable.py, flat layout only).

A FLAT table `table[..., MP] int32` maps a slot's page COLUMN j (rows
[j·page, (j+1)·page) of its context) to a pool page id. The JAX package
also has a hierarchical `(l1, l0)` layout for million-token slots; the port
takes flat tables only and rejects the pair with NotImplementedError
(ROADMAP Queue A item 15).
"""

from __future__ import annotations

import torch


def is_hier(table) -> bool:
    """True when `table` is the hierarchical (l1, l0) pair."""
    return isinstance(table, (tuple, list))


def _flat(table) -> torch.Tensor:
    if is_hier(table):
        raise NotImplementedError(
            "hierarchical (l1, l0) page tables are not ported yet "
            "(ROADMAP Queue A item 15)")
    return table


def width(table) -> int:
    """Logical column count MP."""
    return _flat(table).shape[-1]


def gather_cols(table, cols: torch.Tensor) -> torch.Tensor:
    """Resolve per-slot column indices to page ids. table [B, MP], cols
    [B, N] int; returns [B, N] page ids. Clamping out-of-range columns is
    the caller's job."""
    return torch.gather(_flat(table), -1, cols.to(torch.int64))


def batch_row(table_row):
    """Lift one slot's table row to the batched form: [MP] -> [1, MP]."""
    return _flat(table_row)[None]
