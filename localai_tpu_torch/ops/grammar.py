"""The grammar automaton on the device (the reference's `_dfa_allowed`,
`_dfa_next_state` and `_dfa_advance`, localai_tpu/engine/engine.py).

A constrained slot carries a state of the token-level DFA that
functions/dfa.py compiles from a JSON schema or a GBNF grammar. Its tables
live on the device:

  mask_bits uint8 [S, ceil(V/8)]  bit v of row s: token v legal in state s,
                                  little-endian as np.packbits(...,
                                  bitorder="little") writes them
  next_tok  int16 [S, V]          the state after each token ("fast" mode,
                                  automata of at most NEXT_TOK_MAX_STATES)
  trans     int16 [S, C]          char-class transitions ("walk" mode)
  tok_cls   int16 [V, MAX_TOK_LEN] each token's char classes, -1 padded

Row 0 is the FREE state: every token legal, and every transition loops back
to it. Unconstrained slots ride it, so they batch with constrained ones and
take the same path unmasked. These are integer gathers and shifts with no
data-dependent length (the walk is a fixed loop of MAX_TOK_LEN gathers), so
a decode block that runs them can be captured as a CUDA graph, and the card
gives the same bits as the CPU. Plain PyTorch: the reference computes them
in plain XLA too, with no Pallas kernel.
"""

from __future__ import annotations

import torch


def dfa_allowed(mask_bits: torch.Tensor, state: torch.Tensor, V: int) -> torch.Tensor:
    """Unpack each row's legality bits: state [B] -> bool [B, V]."""
    rows = mask_bits[state.long()]  # [B, ceil(V/8)] u8
    shifts = torch.arange(8, dtype=torch.uint8, device=rows.device)
    bits = torch.bitwise_and(torch.bitwise_right_shift(rows[:, :, None], shifts), 1)
    return bits.reshape(state.shape[0], -1)[:, :V].bool()


def dfa_next_state(trans: torch.Tensor, tok_cls: torch.Tensor, state: torch.Tensor,
                   tok: torch.Tensor) -> torch.Tensor:
    """Walk each token's char classes through the transition table: state
    [B] i32, tok [B] -> the next state [B] i32. A -1 class (past the
    token's end) keeps the state, so every token takes the same number of
    gathers; the FREE row self-loops."""
    seq = tok_cls[tok.long()].long()  # [B, MAX_TOK_LEN]
    s = state.to(torch.int32)
    for p in range(seq.shape[1]):
        c = seq[:, p]
        nxt = trans[torch.clamp(s, min=0).long(), torch.clamp(c, min=0)]
        s = torch.where(c >= 0, nxt.to(torch.int32), s)
    return s


def dfa_advance(mode: str, table: torch.Tensor, tok_cls: torch.Tensor, state: torch.Tensor,
                tok: torch.Tensor) -> torch.Tensor:
    """The state after emitting `tok`: one gather of the [S, V] next-token
    table in "fast" mode (`table` is next_tok), else the char walk through
    `table` = trans [S, C]."""
    if mode == "fast":
        return table[state.long(), tok.long()].to(torch.int32)
    return dfa_next_state(table, tok_cls, state, tok)


def dfa_state_after(tables, tokens) -> int:
    """The state a DFA slot holds after emitting `tokens` from the start
    state: a numpy walk of the host tables (functions/dfa.TokenTables), the
    plain version the device state is held against."""
    s = tables.init_state
    for t in tokens:
        if tables.next_tok is not None:
            s = int(tables.next_tok[s, t])
            continue
        for c in tables.tok_cls[t]:
            if c < 0:
                break
            s = int(tables.trans[s, c])
    return s
