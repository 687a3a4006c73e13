"""B3's bf16 tensor-core kernel (localai_tpu_torch/csrc/quant_matmul.cu,
qmm_mma_kernel) on the CPU: its split plan, the wrapper's preconditions,
and a numpy emulation of the kernel's per-lane data flow held against
`qmm_plain`.

The emulation repeats, lane by lane, what the CUDA source does: the stage
tiles as cp.async lays them out in shared memory (pitches, zero-filled
edges), each lane's weight loads, the prmt / lop3 / magic-number
conversions to bf16x2, ldmatrix's x fragments, mma.sync m16n8k16's
fragment layouts, the group scales and int4 zero points, and the split-K
partials added in split order. A wrong byte, nibble, lane or column
mapping shows as a wrong product here, before any run on the card.
"""

import numpy as np
import pytest
import torch

from localai_tpu_torch.models import quant
from localai_tpu_torch.ops import quant_matmul as tqm

LLAMA_3_8B = [(4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096)]
# The tiny models' projections (tiny; chip_smoke.py's tiny-d64) and the
# ragged test shape.
SMALL = [(64, 64), (64, 32), (64, 128), (128, 64), (256, 256), (256, 128), (256, 512),
         (512, 256), (96, 80)]
H100_SMS = 132


# --------------------------------------------------------------------------- #
# The split plan
# --------------------------------------------------------------------------- #


@pytest.mark.parametrize("rows", [1, 8, 16, 17, 64, 256])
@pytest.mark.parametrize("shape", LLAMA_3_8B + SMALL)
def test_plan_slices_cover_in_with_whole_groups(shape, rows):
    n_in, n_out = shape
    plan = tqm.qmm_plan(n_in, n_out, rows, H100_SMS)
    assert plan.k_slice > 0 and plan.k_slice % 32 == 0
    assert (plan.splits - 1) * plan.k_slice < n_in <= plan.splits * plan.k_slice
    assert (plan.row_tile, plan.block_cols) in ((8, 128), (16, 128), (64, 64))
    assert plan.row_tile >= min(rows, 16)
    expect = 0 if plan.splits == 1 else plan.tiles(rows, n_out) * plan.splits * \
        plan.row_tile * plan.block_cols
    assert plan.workspace_floats(rows, n_out) == expect


@pytest.mark.parametrize("shape", LLAMA_3_8B + SMALL)
def test_plan_is_the_same_for_every_decode_batch(shape):
    """Up to 16 rows only the row tile moves (8 or 16), which leaves a row's
    arithmetic alone: the k-slices and the column tiles stay."""
    plans = [tqm.qmm_plan(*shape, n, H100_SMS) for n in range(1, 17)]
    assert {(p.block_cols, p.splits, p.k_slice) for p in plans} == {
        (plans[0].block_cols, plans[0].splits, plans[0].k_slice)}
    assert [p.row_tile for p in plans] == [8] * 8 + [16] * 8


@pytest.mark.parametrize("rows", [1, 8, 16, 64, 256])
@pytest.mark.parametrize("shape", LLAMA_3_8B)
def test_plan_fills_the_card_at_llama_3_8b(shape, rows):
    plan = tqm.qmm_plan(*shape, rows, H100_SMS)
    assert plan.tiles(rows, shape[1]) * plan.splits >= H100_SMS


def test_plan_splits_only_where_the_grid_is_short():
    # w_gate at 256 rows has 896 output tiles: one split.
    assert tqm.qmm_plan(4096, 14336, 256, H100_SMS).splits == 1
    # wk at decode: 8 column tiles, 32 splits of 4 groups.
    assert tqm.qmm_plan(4096, 1024, 8, H100_SMS) == tqm.QmmPlan(8, 128, 32, 128)
    # A product of 3 groups is never cut below the least slice.
    assert tqm.qmm_plan(96, 80, 1, H100_SMS).splits == 1


# --------------------------------------------------------------------------- #
# The wrapper's preconditions for the bf16 kernel
# --------------------------------------------------------------------------- #


def test_bf16_preconditions_raise_value_errors():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(64, 96, generator=g)
    x = torch.randn(4, 64, generator=g).to(torch.bfloat16)
    for qw in (quant.quantize_tensor(w), quant.quantize_tensor_g4(w)):
        assert tqm._check_qmm_args(x, qw)[1] == 96  # what the kernel takes passes
    with pytest.raises(ValueError, match="multiple of 16"):  # 16-byte weight rows
        tqm._check_qmm_args(x, quant.quantize_tensor(w[:, :84].contiguous()))
    misaligned = torch.empty(4 * 64 + 1, dtype=torch.bfloat16)[1:].reshape(4, 64)
    with pytest.raises(ValueError, match="x 16-byte aligned"):
        tqm._check_qmm_args(misaligned, quant.quantize_tensor(w))
    with pytest.raises(ValueError, match="a multiple of 8"):
        tqm._check_qmm_args(torch.zeros(4, 36, dtype=torch.bfloat16),
                            quant.quantize_tensor(torch.randn(36, 96, generator=g)))
    q = quant.quantize_tensor(w)
    q["q"] = torch.empty(64 * 96 + 4, dtype=torch.int8)[4:].reshape(64, 96)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tqm._check_qmm_args(x, q)
    # f32 x keeps the scalar kernel and its looser preconditions.
    assert tqm._check_qmm_args(x.float(), quant.quantize_tensor(w[:, :84].contiguous()))[1] == 84


# --------------------------------------------------------------------------- #
# A numpy emulation of qmm_mma_kernel's per-lane data flow
# --------------------------------------------------------------------------- #

LANE = np.arange(32)
G_, T_ = LANE >> 2, LANE & 3  # mma groupID, thread in group
U32 = np.uint32


def _prmt(a, b, sel: int):
    src = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    out = np.zeros_like(a, dtype=U32)
    for i in range(4):
        out |= (src[(sel >> (4 * i)) & 7] << (8 * i)).astype(U32)
    return out


def _bf16_halves(r):
    """uint32 -> (low bf16, high bf16) as float32."""
    r = np.asarray(r, dtype=U32)
    return ((r & 0xFFFF) << 16).astype(U32).view(np.float32), (r & 0xFFFF0000).view(np.float32)


def _bf16x2(lo, hi):
    """Exact float32 values (small integers, bf16 x) -> uint32 bf16x2."""
    return (lo.astype(np.float32).view(U32) >> 16) | (hi.astype(np.float32).view(U32) & 0xFFFF0000)


def _nibbles_bf16x2(w):
    h = (w & U32(0x000F000F)) | U32(0x43004300)  # lop3
    lo, hi = _bf16_halves(h)
    return _bf16x2(lo - np.float32(128), hi - np.float32(128))  # __hsub2, exact


def _bytes_bf16x2(xa, xb, c: int):
    fa = _prmt(xa, np.full_like(xa, 0x4B000000), 0x7650 | c).view(np.float32) - np.float32(8388736)
    fb = _prmt(xb, np.full_like(xb, 0x4B000000), 0x7650 | c).view(np.float32) - np.float32(8388736)
    return _prmt(fa.view(U32), fb.view(U32), 0x7632)


def _mma(c, a, b0, b1):
    """c [32, 4] f32 += A (16x16, from the lanes' a[0..3]) · B (16x8, from
    b0, b1), with m16n8k16's fragment layouts."""
    A = np.zeros((16, 16))
    B = np.zeros((16, 8))
    for reg, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        lo, hi = _bf16_halves(a[reg])
        A[G_ + dr, 2 * T_ + dk], A[G_ + dr, 2 * T_ + dk + 1] = lo, hi
    for reg, dk in ((b0, 0), (b1, 8)):
        lo, hi = _bf16_halves(reg)
        B[2 * T_ + dk, G_], B[2 * T_ + dk + 1, G_] = lo, hi
    D = A @ B
    c += np.stack([D[G_, 2 * T_], D[G_, 2 * T_ + 1], D[G_ + 8, 2 * T_],
                   D[G_ + 8, 2 * T_ + 1]], axis=1).astype(np.float32)


def _u32(buf, off):
    return (buf[off].astype(U32) | (buf[off + 1].astype(U32) << 8)
            | (buf[off + 2].astype(U32) << 16) | (buf[off + 3].astype(U32) << 24))


def _ldmatrix(buf, addr, count):
    """ldmatrix.m8n8.x{count}: matrix i's row addresses come from lanes
    8i..8i+7; lane l gets row l/4, bytes 4(l%4)..+3 of each matrix."""
    return [_u32(buf, addr[8 * i:8 * i + 8][G_] + 4 * T_) for i in range(count)]


def _emulate(x: torch.Tensor, w: dict, plan: tqm.QmmPlan) -> torch.Tensor:
    """qmm_mma_kernel's function for bf16 x, lane by lane, on the CPU."""
    key = tqm._payload_key(w)
    form = {"q": 0, "gq": 1, "g4": 2}[key]
    N, IN = x.shape
    pay = w[key].numpy().view(np.uint8).reshape(-1, w[key].shape[-1])  # [byte-rows, OUT]
    OUT = pay.shape[1]
    s = (w["s"] if form == 0 else w["gs"]).numpy().reshape(-1, OUT)
    z = w["gz"].numpy().reshape(-1, OUT) if form == 2 else None
    xb = x.view(torch.int16).numpy().view(np.uint16)
    MT, NT = plan.block_cols // 64, plan.row_tile // 8
    BO, RT = plan.block_cols, plan.row_tile
    k_in = 128 if form == 2 else 64
    n_groups = k_in // 32
    wp, xp = BO + 16, k_in + 8
    wbytes, sbytes = 64 * wp, (0 if form == 0 else n_groups * BO * 4)
    zbytes = sbytes if form == 2 else 0
    stage_bytes = wbytes + sbytes + zbytes + RT * xp * 2
    ones = [np.full(32, 0x3F803F80, dtype=U32)] * 4
    out = np.zeros((N, OUT), dtype=np.float32)
    CT, RTN = -(-OUT // BO), -(-N // RT)
    for rt in range(RTN):
        for ct in range(CT):
            c0, r0 = ct * BO, rt * RT
            partials = []
            for sp in range(plan.splits):
                kbeg = sp * plan.k_slice
                kend = min(kbeg + plan.k_slice, IN)
                acc = np.zeros((4, MT, NT, 32, 4), dtype=np.float32)  # [warp][j][n][lane][e]
                for st in range(-(-(kend - kbeg) // k_in)):
                    k0 = kbeg + st * k_in
                    buf = np.zeros(stage_bytes, dtype=np.uint8)
                    wt = buf[:wbytes].reshape(64, wp)
                    for r in range(64):  # weight byte-rows
                        row, ok = ((k0 // 2 + r, k0 + (r // 16) * 32 < kend) if form == 2
                                   else (k0 + r, k0 + r < kend))
                        if ok:
                            n = max(0, min(BO, OUT - c0))
                            wt[r, :n] = pay[row, c0:c0 + n]
                    if form:
                        for gi in range(n_groups):
                            grp = k0 // 32 + gi
                            if grp * 32 < kend:
                                n = max(0, min(BO, OUT - c0))
                                buf[wbytes:wbytes + sbytes].view(np.float32)[
                                    gi * BO:gi * BO + n] = s[grp, c0:c0 + n]
                                if form == 2:
                                    buf[wbytes + sbytes:wbytes + 2 * sbytes].view(np.float32)[
                                        gi * BO:gi * BO + n] = z[grp, c0:c0 + n]
                    xt = buf[wbytes + sbytes + zbytes:].view(np.uint16).reshape(RT, xp)
                    for r in range(RT):
                        if r0 + r < N:
                            n = max(0, min(k_in, kend - k0))
                            xt[r, :n] = xb[r0 + r, k0:k0 + n]
                    xs = wbytes + sbytes + zbytes
                    ng = min(n_groups, -(-(kend - k0) // 32))
                    for warp in range(4):
                        wcol = warp * 16 * MT + G_ * 2 * MT

                        def lds_w(r):
                            v = _u32(buf, r * wp + wcol)
                            return v if MT == 2 else v & U32(0xFFFF)

                        def lds_f(region, gi):
                            f = buf[wbytes + region:wbytes + region + sbytes].view(np.float32)
                            return [f[gi * BO + wcol + c] for c in range(2 * MT)]

                        for gi in range(ng):
                            b = []
                            for kk in (gi * 32, gi * 32 + 16):
                                if NT == 1:
                                    ll = LANE & 15
                                    addr = xs + ((ll & 7) * xp + kk + (ll >> 3) * 8) * 2
                                    r_ = _ldmatrix(buf, addr, 2)
                                    b.append([(r_[0], r_[1])])
                                else:
                                    frags = []
                                    mat = LANE >> 3
                                    for p in range(NT // 2):
                                        n = (2 * p + (mat >> 1)) * 8 + (LANE & 7)
                                        addr = xs + (n * xp + kk + (mat & 1) * 8) * 2
                                        r_ = _ldmatrix(buf, addr, 4)
                                        frags += [(r_[0], r_[1]), (r_[2], r_[3])]
                                    b.append(frags)
                            part = np.zeros((MT, NT, 32, 4), dtype=np.float32)
                            if form == 2:
                                wr = gi * 16
                                w0, w1 = lds_w(wr + 2 * T_), lds_w(wr + 2 * T_ + 1)
                                w8, w9 = lds_w(wr + 2 * T_ + 8), lds_w(wr + 2 * T_ + 9)
                                for j in range(MT):
                                    sel = 0x7632 if j else 0x5410
                                    lo, hi = _prmt(w0, w1, sel), _prmt(w8, w9, sel)
                                    for step in range(2):
                                        sh = 4 * step
                                        a = [_nibbles_bf16x2(lo >> sh),
                                             _nibbles_bf16x2(lo >> (sh + 8)),
                                             _nibbles_bf16x2(hi >> sh),
                                             _nibbles_bf16x2(hi >> (sh + 8))]
                                        for n in range(NT):
                                            _mma(part[j, n], a, *b[step][n])
                            else:
                                for step in range(2):
                                    wr = gi * 32 + step * 16
                                    w0, w1, w8, w9 = (lds_w(wr + 2 * T_ + d) ^ U32(0x80808080)
                                                      for d in (0, 1, 8, 9))
                                    for j in range(MT):
                                        a = [_bytes_bf16x2(w0, w1, 2 * j),
                                             _bytes_bf16x2(w0, w1, 2 * j + 1),
                                             _bytes_bf16x2(w8, w9, 2 * j),
                                             _bytes_bf16x2(w8, w9, 2 * j + 1)]
                                        for n in range(NT):
                                            _mma(acc[warp, j, n] if form == 0 else part[j, n],
                                                 a, *b[step][n])
                            if form:
                                sv = lds_f(0, gi)
                                zv = lds_f(sbytes, gi) if form == 2 else None
                                xsum = np.zeros((NT, 32, 4), dtype=np.float32)
                                if form == 2:
                                    for n in range(NT):
                                        _mma(xsum[n], ones, *b[0][n])
                                        _mma(xsum[n], ones, *b[1][n])
                                for j in range(MT):
                                    for n in range(NT):
                                        for e in range(4):
                                            c = 2 * j + (e >> 1)
                                            v = part[j, n, :, e] * sv[c] + acc[warp, j, n, :, e]
                                            if form == 2:
                                                v = -xsum[n, :, e & 1] * zv[c] + v
                                            acc[warp, j, n, :, e] = v
                tile = np.zeros((RT, BO), dtype=np.float32)  # the split's partial tile
                for warp in range(4):
                    wcol = warp * 16 * MT + G_ * 2 * MT
                    for j in range(MT):
                        for n in range(NT):
                            for h in range(2):
                                rows = n * 8 + 2 * T_ + h
                                tile[rows, wcol + 2 * j] = acc[warp, j, n, :, h]
                                tile[rows, wcol + 2 * j + 1] = acc[warp, j, n, :, 2 + h]
                partials.append(tile)
            total = partials[0].copy()
            for p in partials[1:]:  # split order
                total += p
            n_r, n_c = min(RT, N - r0), min(BO, OUT - c0)
            if form == 0:
                total[:, :n_c] *= s[0, c0:c0 + n_c]
            out[r0:r0 + n_r, c0:c0 + n_c] = total[:n_r, :n_c]
    return torch.from_numpy(out).to(torch.bfloat16)


def _grouped_int8(w, group=32):
    g = w.shape[0] // group
    wg = w.float().reshape(g, group, w.shape[1])
    s = torch.clamp(wg.abs().amax(dim=1, keepdim=True) / 127.0, min=1e-9)
    return {"gq": torch.clamp(torch.round(wg / s), -127, 127).to(torch.int8), "gs": s}


FORMS = {"int8": quant.quantize_tensor, "grouped_int8": _grouped_int8,
         "int4": quant.quantize_tensor_g4}


# (rows, in, out, plan): decode rows unsplit and split (3 uneven splits:
# partial stages and, for int4, a partial group count), 9-16 rows (two
# n-tiles), a ragged output tile, and 64-row tiles on 64 columns.
EMULATED = [
    (1, 256, 96, tqm.QmmPlan(8, 128, 1, 256)),
    (5, 256, 160, tqm.QmmPlan(8, 128, 3, 96)),
    (13, 192, 96, tqm.QmmPlan(16, 128, 2, 128)),
    (20, 256, 80, tqm.QmmPlan(64, 64, 2, 160)),
]


@pytest.mark.parametrize("case", range(len(EMULATED)))
@pytest.mark.parametrize("form", list(FORMS))
def test_fragment_emulation_matches_plain_version(form, case):
    N, n_in, n_out, plan = EMULATED[case]
    rng = np.random.default_rng(case)
    w = torch.from_numpy(rng.standard_normal((n_in, n_out)).astype(np.float32) * 0.02)
    qw = FORMS[form](w)
    x = torch.from_numpy(rng.standard_normal((N, n_in)).astype(np.float32)).to(torch.bfloat16)
    got = _emulate(x, qw, plan)
    want = tqm.qmm_plain(x, qw)
    scale = tqm.qmm_plain(x.float(), qw).abs().max().item()
    err = (got.float() - want.float()).abs()
    # The card's tolerance for bf16 x (tests/test_torch_cuda.py): one bf16
    # step of the value plus the summation-order term.
    assert (err <= 2.0**-7 * want.float().abs() + 1e-4 * scale).all()


def test_emulated_flat_int8_covers_a_ragged_in():
    """Flat int8 with in not a multiple of 32: the last group's missing rows
    are zero-filled on both sides."""
    rng = np.random.default_rng(9)
    w = torch.from_numpy(rng.standard_normal((200, 96)).astype(np.float32) * 0.02)
    qw = quant.quantize_tensor(w)
    x = torch.from_numpy(rng.standard_normal((3, 200)).astype(np.float32)).to(torch.bfloat16)
    plan = tqm.qmm_plan(200, 96, 3, 1)
    assert plan.splits == 1
    for p in (plan, tqm.QmmPlan(8, 128, 3, 96)):
        got, want = _emulate(x, qw, p), tqm.qmm_plain(x, qw)
        assert ((got.float() - want.float()).abs()
                <= 2.0**-7 * want.float().abs() + 1e-4 * want.float().abs().max()).all()
