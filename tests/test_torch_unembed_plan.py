"""B4's bf16 tensor-core kernel (localai_tpu_torch/csrc/quant_matmul.cu,
unembed_mma_kernel) on the CPU: its plan, the wrapper's preconditions, and
a torch emulation of the kernel's per-lane data flow held against
`qunembed_plain`.

The emulation repeats what the CUDA source does, lane by lane: the
persistent blocks' tile ranges, the staged h slices (row pitch, zeros past
N and D), each lane's 16-byte head loads (bytes 16t..16t+15 of vocab rows g
and g + 8 in a 64-column chunk, masked past V and D), the int8 -> bf16
conversion through the mantissa of 2^23, the permuted k slots (word s of a
load feeds k16 step s, its bytes 0-1 slots 2t, 2t + 1 and bytes 2-3 slots
2t + 8, 2t + 9, B's fragment the 8 bytes h[n][16t + 4s .. +3]),
mma.sync m16n8k16's fragment layouts, and the scale applied on the store.
A wrong byte, slot, lane or mask shows here as a wrong logit, before any
run on the card.
"""

import numpy as np
import pytest
import torch

from localai_tpu_torch.ops import quant_matmul as tqm

H100_SMS = 132
LANE = torch.arange(32)
G_, T_ = LANE >> 2, LANE & 3  # mma groupID, thread in group
M32 = 0xFFFFFFFF


# --------------------------------------------------------------------------- #
# Bit helpers: uint32 words held in int64 tensors
# --------------------------------------------------------------------------- #


def _f32(u: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns -> float32 values."""
    u = u & M32
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32).view(torch.float32)


def _u32(f: torch.Tensor) -> torch.Tensor:
    """float32 values -> uint32 bit patterns."""
    return f.contiguous().view(torch.int32).to(torch.int64) & M32


def _prmt(a: torch.Tensor, b: torch.Tensor, sel: int) -> torch.Tensor:
    """prmt.b32: byte i of the result is byte (sel >> 4i) & 7 of {b, a}."""
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = torch.zeros_like(a)
    for i in range(4):
        out |= src[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def _pair_bf16x2(w: torch.Tensor, c: int) -> torch.Tensor:
    """pair_bf16x2: bytes c and c + 1 of w (int8 XOR 0x80) as bf16x2."""
    magic = torch.full_like(w, 0x4B000000)
    fa = _f32(_prmt(w, magic, 0x7650 | c)) - torch.tensor(8388736.0)
    fb = _f32(_prmt(w, magic, 0x7650 | (c + 1))) - torch.tensor(8388736.0)
    return _prmt(_u32(fa), _u32(fb), 0x7632)


def _bf16_halves(r: torch.Tensor):
    """uint32 -> (low bf16, high bf16) as float32."""
    return _f32((r & 0xFFFF) << 16), _f32(r & 0xFFFF0000)


def _mma(c: torch.Tensor, a, b0, b1) -> None:
    """c [32, 4] f32 += A (16x16, from the lanes' a[0..3]) · B (16x8, from
    b0, b1), with m16n8k16's fragment layouts."""
    A = torch.zeros(16, 16, dtype=torch.float64)
    B = torch.zeros(16, 8, dtype=torch.float64)
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = _bf16_halves(a[reg])
        A[G_ + dr, 2 * T_ + dk], A[G_ + dr, 2 * T_ + dk + 1] = lo.double(), hi.double()
    for reg, dk in ((b0, 0), (b1, 8)):
        lo, hi = _bf16_halves(reg)
        B[2 * T_ + dk, G_], B[2 * T_ + dk + 1, G_] = lo.double(), hi.double()
    D = A @ B
    c += torch.stack([D[G_, 2 * T_], D[G_, 2 * T_ + 1], D[G_ + 8, 2 * T_],
                      D[G_ + 8, 2 * T_ + 1]], dim=1).float()


def _words(buf: torch.Tensor, col: torch.Tensor) -> list[torch.Tensor]:
    """The 4 little-endian uint32 words of buf[lane, col[lane] .. +15]
    (uint8 rows, one per lane)."""
    idx = col[:, None] + torch.arange(16)[None, :]
    b = torch.gather(buf, 1, idx).to(torch.int64)
    return [b[:, 4 * s] | b[:, 4 * s + 1] << 8 | b[:, 4 * s + 2] << 16 | b[:, 4 * s + 3] << 24
            for s in range(4)]


# --------------------------------------------------------------------------- #
# The emulation
# --------------------------------------------------------------------------- #


def _emulate(h: torch.Tensor, head: dict, plan: tqm.UnembedPlan) -> torch.Tensor:
    """unembed_mma_kernel's function for bf16 h, lane by lane, on the CPU."""
    q = head["q"]
    V, D = q.shape
    N = h.shape[0]
    RT = plan.row_tile
    NT = RT // 8
    pitch = plan.k_slice + 4
    nch = -(-D // 64)
    cps = plan.k_slice // 64
    # Each lane's head row as bytes, with zeros past D and past V where the
    # kernel's masked lanes load zeros.
    qpad = torch.zeros(V + 16, nch * 64, dtype=torch.uint8)
    qpad[:V, :D] = q.view(torch.uint8)
    hbits = h.view(torch.int16).to(torch.int64) & 0xFFFF
    s = head["s"][:, 0]
    out = torch.full((N, V), float("nan"))
    written = torch.zeros(N, V, dtype=torch.int64)
    for rt in range(-(-N // RT)):
        r0 = rt * RT
        for block in range(plan.blocks):
            for tile in plan.tile_range(block, V):
                v0 = tile * 16
                acc = torch.zeros(NT, 32, 4)
                hs = None
                for c in range(nch):
                    cin = c % cps
                    if cin == 0:  # stage_h: the slice of h, zero past N and D
                        k0 = c * 64
                        hs = torch.zeros(RT, pitch, dtype=torch.int64)
                        rows = min(RT, N - r0)
                        cols = max(0, min(plan.k_slice, D - k0))
                        hs[:rows, :cols] = hbits[r0:r0 + rows, k0:k0 + cols]
                    col = c * 64 + 16 * T_
                    w_g, w_g8 = (_words(qpad[v0 + G_ + 8 * r], col) for r in (0, 1))
                    for st in range(4):
                        w0, w8 = w_g[st] ^ 0x80808080, w_g8[st] ^ 0x80808080
                        a = [_pair_bf16x2(w0, 0), _pair_bf16x2(w8, 0),
                             _pair_bf16x2(w0, 2), _pair_bf16x2(w8, 2)]
                        e = cin * 64 + 16 * T_ + 4 * st  # the lane's 8-byte B read
                        cols = e[:, None] + torch.arange(4)[None, :]
                        for n in range(NT):
                            v4 = torch.gather(hs[n * 8 + G_], 1, cols)
                            _mma(acc[n], a, v4[:, 0] | v4[:, 1] << 16, v4[:, 2] | v4[:, 3] << 16)
                for r in (0, 1):
                    v = v0 + G_ + 8 * r
                    for n in range(NT):
                        for e in (0, 1):
                            row = r0 + 8 * n + 2 * T_ + e
                            ok = (v < V) & (row < N)
                            vv, rr = v[ok], row[ok]
                            out[rr, vv] = acc[n, ok, 2 * r + e] * s[vv]
                            written[rr, vv] += 1
    assert (written == 1).all(), "every logit is written exactly once"
    return out


def _head(rng, V, D):
    w = torch.from_numpy(rng.standard_normal((V, D)).astype(np.float32) * 0.02)
    s = torch.clamp(w.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-9)
    return {"q": torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), "s": s}


# (rows, V, D, plan): the decode tiles (one and two n-tiles) at a ragged V
# and D = 16·odd (a last chunk of 16 or 48 columns), several blocks;
# h staged in slices of one chunk and of two; 64-row tiles with a partial
# row tile; a block count that leaves blocks uneven ranges.
EMULATED = [
    (1, 100, 80, tqm.UnembedPlan(8, 128, 2)),
    (5, 37, 48, tqm.UnembedPlan(8, 64, 1)),
    (13, 100, 208, tqm.UnembedPlan(16, 256, 3)),
    (16, 70, 208, tqm.UnembedPlan(16, 64, 2)),
    (3, 130, 176, tqm.UnembedPlan(8, 128, 3)),
    (20, 50, 112, tqm.UnembedPlan(64, 64, 2)),
    (8, 64, 64, tqm.UnembedPlan(8, 64, 1)),
]


@pytest.mark.parametrize("case", range(len(EMULATED)))
def test_fragment_emulation_matches_plain_version(case):
    N, V, D, plan = EMULATED[case]
    rng = np.random.default_rng(case)
    head = _head(rng, V, D)
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(torch.bfloat16)
    got = _emulate(h, head, plan)
    want = tqm.qunembed_plain(h, head)
    # The card's tolerance: f32 on both sides and exact bf16 x int8
    # products, so only the order of the sum differs.
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("N", [1, 8, 16, 20])
def test_emulated_plan_of_the_wrapper(N):
    """The wrapper's own plan (one block here: a tiny head) through the
    emulation, at a ragged V and D = 16 * 5."""
    V, D = 45, 80
    rng = np.random.default_rng(100 + N)
    head = _head(rng, V, D)
    h = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(torch.bfloat16)
    plan = tqm.qunembed_plan(V, D, N, H100_SMS)
    got = _emulate(h, head, plan)
    want = tqm.qunembed_plain(h, head)
    assert (got - want).abs().max().item() <= 1e-4 * want.abs().max().item()


def test_row_alone_emulation_has_the_same_bits():
    """A row's logits do not depend on the rows decoded beside it: 8 and 16
    rows (one and two n-tiles) against each row alone."""
    V, D = 40, 144
    rng = np.random.default_rng(5)
    head = _head(rng, V, D)
    h = torch.from_numpy(rng.standard_normal((16, D)).astype(np.float32)).to(torch.bfloat16)
    for n in (8, 16):
        together = _emulate(h[:n], head, tqm.qunembed_plan(V, D, n, H100_SMS))
        for i in (0, n - 1):
            alone = _emulate(h[i:i + 1], head, tqm.qunembed_plan(V, D, 1, H100_SMS))
            assert torch.equal(together[i:i + 1], alone)


def test_int8_to_bf16_trick_is_exact_for_every_byte():
    vals = torch.arange(-128, 128)
    biased = (vals & 0xFF) ^ 0x80  # the kernel XORs the raw byte with 0x80
    for c in (0, 2):  # pair_bf16x2 reads bytes (0, 1) and (2, 3)
        for shift in (0, 1):  # each byte value in the low and in the high half
            w = torch.zeros(256, dtype=torch.int64)
            other = torch.roll(biased, 1)
            w |= (biased if shift == 0 else other) << (8 * c)
            w |= (other if shift == 0 else biased) << (8 * (c + 1))
            lo, hi = _bf16_halves(_pair_bf16x2(w, c))
            got = lo if shift == 0 else hi
            assert torch.equal(got, vals.float())


def test_permuted_k_slots_cover_each_chunk_column_once():
    """Step s, lane (g, t): A's k slots 2t, 2t + 1, 2t + 8, 2t + 9 hold chunk
    columns 16t + 4s + 0..3, and B's rows of the same slots the same
    columns: over the 4 steps every column of the chunk is used once."""
    seen = []
    for s in range(4):
        slot_col = {}
        for t in range(4):
            for slot, byte in ((2 * t, 0), (2 * t + 1, 1), (2 * t + 8, 2), (2 * t + 9, 3)):
                slot_col[slot] = 16 * t + 4 * s + byte
        assert sorted(slot_col) == list(range(16))
        seen += slot_col.values()
    assert sorted(seen) == list(range(64))


# --------------------------------------------------------------------------- #
# The plan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rows", [1, 8, 9, 16, 17, 64, 256])
@pytest.mark.parametrize("shape", [(128256, 4096), (32000, 4096), (128256, 8192),
                                   (1000, 80), (37, 48), (256, 64), (151936, 3584)])
def test_plan_covers_every_vocab_tile_once(shape, rows):
    V, D = shape
    plan = tqm.qunembed_plan(V, D, rows, H100_SMS)
    walked = [t for b in range(plan.blocks) for t in plan.tile_range(b, V)]
    assert walked == list(range(-(-V // 16)))
    assert all(len(plan.tile_range(b, V)) > 0 for b in range(plan.blocks))
    assert plan.k_slice % 64 == 0 and 0 < plan.k_slice <= -(-D // 64) * 64
    # The staged h the kernel asks for (row pitch k_slice + 4 bf16).
    assert plan.row_tile * (plan.k_slice + 4) * 2 <= tqm.UNEMBED_SMEM_BYTES
    row_tiles = -(-rows // plan.row_tile)
    assert 1 <= plan.blocks * row_tiles <= H100_SMS


@pytest.mark.parametrize("shape", [(128256, 4096), (32000, 2048), (128256, 8192), (1000, 80)])
def test_plan_is_the_same_for_every_decode_batch(shape):
    plans = [tqm.qunembed_plan(*shape, n, H100_SMS) for n in range(1, 17)]
    assert {(p.k_slice, p.blocks) for p in plans} == {(plans[0].k_slice, plans[0].blocks)}
    assert [p.row_tile for p in plans] == [8] * 8 + [16] * 8


def test_plan_at_the_llama_3_8b_head():
    # Decode: one block an SM, h resident (D = 4096 fits 16 rows).
    assert tqm.qunembed_plan(128256, 4096, 8, H100_SMS) == tqm.UnembedPlan(8, 4096, 132)
    # 256 rows: 4 tiles of 64 rows, 33 blocks each, h staged in slices.
    p = tqm.qunembed_plan(128256, 4096, 256, H100_SMS)
    assert (p.row_tile, p.blocks) == (64, 33)
    assert p.k_slice < 4096
    # A wide D that 16 rows cannot hold at once is staged in slices.
    assert tqm.qunembed_plan(128256, 8192, 1, H100_SMS).k_slice < 8192


# --------------------------------------------------------------------------- #
# The wrapper's preconditions
# --------------------------------------------------------------------------- #


def test_bf16_h_with_d_not_a_multiple_of_16_raises():
    g = torch.Generator().manual_seed(0)
    head = {"q": torch.randint(-127, 128, (96, 40), generator=g, dtype=torch.int8),
            "s": torch.rand(96, 1, generator=g)}
    h = torch.randn(3, 40, generator=g).to(torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tqm._check_unembed_args(h, head)


def test_bf16_h_needs_no_alignment():
    """The kernel stages h with 2-byte loads when it is not 16-byte aligned:
    the wrapper takes such an h (narrowing it would be a loss)."""
    g = torch.Generator().manual_seed(1)
    head = {"q": torch.randint(-127, 128, (96, 64), generator=g, dtype=torch.int8),
            "s": torch.rand(96, 1, generator=g)}
    h = torch.empty(3 * 64 + 1, dtype=torch.bfloat16)[1:].reshape(3, 64)
    assert h.data_ptr() % 16
    tqm._check_unembed_args(h, head)  # does not raise
