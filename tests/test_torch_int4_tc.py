"""K2's (bf16) and K4's tensor-core routes, checked on the CPU.

The kernels themselves run only on the card (`tests/test_torch_gpu.py`).
Here: the launch plans `w16_plan` and `a8_plan` (route, grid, splits,
shared memory) at the shapes the smoke and the card tests send, the unpack
of packed nibbles into registers, and the kernels' register layouts
(`tc_*_fragment` and `a8_*_fragment`, mirrored from `csrc/int4_matmul.cu`)
composed with the PTX fragment layouts of `mma.sync.m16n8k16` (bf16) and
`mma.sync.m16n8k32` (s8) into matmuls that must equal the plain versions,
K4's bit for bit.
"""

import numpy as np
import pytest
import torch

from plangen_tpu_torch.ops import int4_matmul as im

N_SM = 132  # H100 SXM
# (R, I, O): the smoke's phase-5 shapes (1B decode at R = 8, gate|up at
# R = 64 and 256) and the card tests' cases
PHASE5_SHAPES = [(8, 2048, 6144), (8, 2048, 2048), (8, 2048, 11264), (8, 5632, 2048),
                 (8, 2048, 16384), (64, 2048, 11264), (256, 2048, 11264)]
INT4_CASES = [(1, 256, 512), (8, 2048, 6144), (8, 5632, 2048), (37, 200, 1000),
              (256, 2048, 11264), (16, 2048, 6144), (64, 200, 1000), (128, 5632, 2048),
              (5, 100, 264)]
# K4's card cases beyond INT4_CASES: R = 64 (gate|up, and I % 16 != 0 with
# O/2 % 16 != 0), 256 rows at down_proj
A8_CASES = [(64, 2048, 11264), (256, 5632, 2048)]
SHAPES = sorted(set(PHASE5_SHAPES + INT4_CASES + A8_CASES))
DTYPES = [torch.bfloat16, torch.float32]


@pytest.mark.parametrize("dtype", DTYPES, ids=["bf16", "fp32"])
@pytest.mark.parametrize("R,I,O", SHAPES)
def test_plan_routes_covers_and_fits(R, I, O, dtype):
    OH = O // 2
    plan = im.w16_plan(R, I, OH, dtype, N_SM)
    assert plan.route == ("tensor_cores" if dtype == torch.bfloat16 else "cuda_cores")
    assert R <= im.MAX_KERNEL_ROWS
    # the splits cover every k tile exactly once, and none is empty
    ranges = plan.split_ranges(I)
    assert len(ranges) == plan.ksplit == plan.grid[2]
    assert all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(-(-I // plan.k_tile)))
    assert plan.smem_bytes <= im.SHARED_MEMORY_LIMIT
    # the blocks cover every output column and row
    rows = 8 * plan.row_tiles if plan.route == "tensor_cores" else im.ROW_TILE
    assert plan.grid[0] * im.COL_TILE >= OH > (plan.grid[0] - 1) * im.COL_TILE
    assert plan.grid[1] * rows >= R > (plan.grid[1] - 1) * rows
    if plan.route == "tensor_cores":
        assert plan.row_tiles in im.TC_ROW_TILES and plan.threads == im.TC_THREADS
        assert plan.row_tiles == im.TC_ROW_TILES[-1] or 8 * plan.row_tiles < 2 * max(R, 8)
        assert plan.stages == im.TC_STAGES
        assert plan.smem_bytes == im.TC_STAGES * (im.TC_K_TILE * im.COL_TILE
                                                  + rows * im.TC_K_TILE * 2)


def test_plan_rejects_other_types():
    with pytest.raises(TypeError):
        im.w16_plan(8, 256, 256, torch.float16, N_SM)


@pytest.mark.parametrize("byte", range(4))
def test_unpack_pair_is_exact(byte):
    """Every packed byte value, in each byte position, unpacks to the lo and
    hi nibbles of the plain version (bf16 128 + n, minus 136)."""
    rs = np.random.RandomState(byte)
    values = np.arange(256, dtype=np.int64)
    others = rs.randint(0, 256, size=(256, 2, 4))
    want_lo, want_hi = im._unpack(torch.from_numpy(values.astype(np.uint8).view(np.int8)))
    for v in values:
        a, b = others[v, 0].copy(), others[v, 1].copy()
        a[byte] = v
        b[byte] = 255 - v
        wa = int(sum(int(x) << (8 * i) for i, x in enumerate(a)))
        wb = int(sum(int(x) << (8 * i) for i, x in enumerate(b)))
        lo, hi = im.tc_unpack_pair(wa, wb, byte)
        halves = np.array([lo & 0xFFFF, lo >> 16, hi & 0xFFFF, hi >> 16], dtype=np.int32)
        got = torch.from_numpy(halves.astype(np.int16)).view(torch.bfloat16).float() - 136.0
        assert got.tolist() == [want_lo[v], want_lo[255 - v], want_hi[v], want_hi[255 - v]]


def _ptx_a(lane, reg, half):
    """(m, k) of an A element of mma.m16n8k16 (PTX ISA, row-major A)."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg & 1), 2 * t + half + 8 * (reg >> 1)


def _ptx_b(lane, reg, half):
    """(k, n) of a B element (column-major B)."""
    g, t = lane >> 2, lane & 3
    return 2 * t + half + 8 * reg, g


def _ptx_d(lane, reg):
    """(m, n) of an accumulator."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg >> 1), 2 * t + (reg & 1)


def test_fragment_maps_are_bijections():
    a = {im.tc_a_fragment(lane, c, reg, h) for lane in range(32) for c in range(4)
         for reg in range(4) for h in range(2)}
    assert a == {(k, p, hi) for k in range(16) for p in range(32) for hi in (False, True)}
    b = {im.tc_b_fragment(lane, reg, h) for lane in range(32) for reg in range(2)
         for h in range(2)}
    assert b == {(n, k) for n in range(8) for k in range(16)}
    d = {im.tc_d_fragment(lane, c, reg) for lane in range(32) for c in range(4)
         for reg in range(4)}
    assert d == {(n, p, hi) for n in range(8) for p in range(32) for hi in (False, True)}


@pytest.mark.parametrize("n_tiles,steps,seed", [(1, 2, 0), (2, 3, 1), (3, 1, 2)])
def test_fragment_layout_composes_to_the_plain_version(n_tiles, steps, seed):
    """One warp of the kernel, emulated: 32 packed columns, `n_tiles` 8-row
    n-tiles, `steps` k16 steps. A registers come from the unpack of the
    packed words each lane reads, B from its 8-byte x load, both placed by
    the PTX layout; the accumulators, written back through `tc_d_fragment`,
    must equal `int4_matmul_w16_reference`."""
    rs = np.random.RandomState(seed)
    I, R = 16 * steps, 8 * n_tiles
    w_p4 = rs.randint(-128, 128, size=(I, 32)).astype(np.int8)
    x = rs.randn(R, I).astype(np.float32)
    words = w_p4.view(np.uint8).astype(np.int64).reshape(I, 8, 4)
    words = (words << (8 * np.arange(4))).sum(-1)  # [I, 8] little-endian words
    lo_w, hi_w = im._unpack(torch.from_numpy(w_p4))
    acc = np.zeros((n_tiles, 4, 16, 8))  # [n-tile][m-tile][m][n]
    for s in range(steps):
        slot_a, slot_b = {}, {}
        for c in range(4):
            A = np.full((16, 16), np.nan)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for reg in range(4):
                    j = 2 * (reg >> 1)
                    lo, hi = im.tc_unpack_pair(int(words[16 * s + 4 * t + j, g]),
                                               int(words[16 * s + 4 * t + j + 1, g]), c)
                    bits = hi if reg & 1 else lo
                    for h in range(2):
                        half = np.array([(bits >> (16 * h)) & 0xFFFF], np.int32).astype(np.int16)
                        value = torch.from_numpy(half).view(torch.bfloat16).item() - 136.0
                        k, p, is_hi = im.tc_a_fragment(lane, c, reg, h)
                        want = (hi_w if is_hi else lo_w)[16 * s + k, p].item()
                        assert value == want, (s, c, lane, reg, h)
                        m, slot = _ptx_a(lane, reg, h)
                        assert (m >= 8) == is_hi and p == 4 * (m % 8) + c
                        slot_a.setdefault(slot, set()).add(k)
                        A[m, slot] = value
            assert not np.isnan(A).any()
            for nt in range(n_tiles):
                B = np.full((16, 8), np.nan)
                for lane in range(32):
                    for reg in range(2):
                        for h in range(2):
                            row, k = im.tc_b_fragment(lane, reg, h)
                            slot, n = _ptx_b(lane, reg, h)
                            assert n == row
                            slot_b.setdefault(slot, set()).add(k)
                            B[slot, n] = x[8 * nt + row, 16 * s + k]
                assert not np.isnan(B).any()
                acc[nt, c] += A @ B
        # every k-slot carries one input, the same in A and B
        assert all(len(v) == 1 for v in slot_a.values()) and slot_a == slot_b
    out = np.full((R, 64), np.nan)
    for nt in range(n_tiles):
        for c in range(4):
            for lane in range(32):
                for reg in range(4):
                    row, p, is_hi = im.tc_d_fragment(lane, c, reg)
                    m, n = _ptx_d(lane, reg)
                    out[8 * nt + row, p + 32 * is_hi] = acc[nt, c, m, n]
    ones = torch.ones(32)
    want = im.int4_matmul_w16_reference(torch.from_numpy(x), torch.from_numpy(w_p4),
                                        ones, ones / 16)
    np.testing.assert_allclose(out, want.numpy(), rtol=1e-5, atol=1e-4)


# ------------------------------------------------------------------ K4 (W4A8)


@pytest.mark.parametrize("R,I,O", SHAPES)
def test_a8_plan_covers_and_fits(R, I, O):
    OH = O // 2
    plan = im.a8_plan(R, I, OH, N_SM)
    assert plan.route == "tensor_cores" and plan.threads == im.TC_THREADS
    assert plan.k_tile == im.A8_K_TILE and plan.stages == im.A8_STAGES
    ranges = plan.split_ranges(I)
    assert len(ranges) == plan.ksplit == plan.grid[2]
    assert all(len(r) > 0 for r in ranges)
    assert [k for r in ranges for k in r] == list(range(-(-I // plan.k_tile)))
    rows = 8 * plan.row_tiles
    assert plan.row_tiles == im.tc_row_tiles(R)
    assert plan.grid[0] * im.COL_TILE >= OH > (plan.grid[0] - 1) * im.COL_TILE
    assert plan.grid[1] * rows >= R > (plan.grid[1] - 1) * rows
    # a stage: the packed weight tile and 8 NT rows of x8, one byte an input
    assert plan.smem_bytes == im.A8_STAGES * (im.A8_K_TILE * im.COL_TILE + rows * im.A8_K_TILE)
    assert plan.smem_bytes <= im.SHARED_MEMORY_LIMIT
    # the split aims at tc_blocks_per_sm blocks an SM, never more splits
    # than it takes to get there
    blocks = plan.grid[0] * plan.grid[1]
    target = im.tc_blocks_per_sm(plan.row_tiles) * N_SM
    assert plan.ksplit == 1 or blocks * (plan.ksplit - 1) < target


@pytest.mark.parametrize("R,I,OH", [(0, 256, 256), (257, 256, 256), (8, 254, 256),
                                    (8, 0, 256), (8, 256, 6), (8, 256, 0)],
                         ids=["no_rows", "rows_257", "i_not_4", "no_inputs", "oh_not_4",
                              "no_columns"])
def test_a8_plan_rejects_bad_shapes(R, I, OH):
    with pytest.raises(ValueError):
        im.a8_plan(R, I, OH, N_SM)


def _ptx_a8_a(lane, reg, byte):
    """(m, k) of an A element of mma.m16n8k32 with s8 operands (PTX ISA,
    row-major A): four bytes a register."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (reg & 1), 4 * t + byte + 16 * (reg >> 1)


def _ptx_a8_b(lane, reg, byte):
    """(k, n) of a B element (column-major B)."""
    g, t = lane >> 2, lane & 3
    return 4 * t + byte + 16 * reg, g


def _signed_bytes(word):
    return [((word >> (8 * i)) & 0xFF) - (256 if (word >> (8 * i)) & 0x80 else 0)
            for i in range(4)]


def test_a8_fragment_maps_are_bijections():
    a = {im.a8_a_fragment(lane, c, reg, i) for lane in range(32) for c in range(4)
         for reg in range(4) for i in range(4)}
    assert a == {(k, p, hi) for k in range(32) for p in range(32) for hi in (False, True)}
    b = {im.a8_b_fragment(lane, reg, i) for lane in range(32) for reg in range(2)
         for i in range(4)}
    assert b == {(n, k) for n in range(8) for k in range(32)}
    d = {im.a8_d_fragment(lane, c, reg) for lane in range(32) for c in range(4)
         for reg in range(4)}
    assert d == {(n, p, hi) for n in range(8) for p in range(32) for hi in (False, True)}
    # each PTX slot carries one input, the same in A and B
    slots = {}
    for lane in range(32):
        for reg in range(4):
            for i in range(4):
                _, slot = _ptx_a8_a(lane, reg, i)
                slots.setdefault(slot, set()).add(im.a8_a_fragment(lane, 0, reg, i)[0])
        for reg in range(2):
            for i in range(4):
                slot, _ = _ptx_a8_b(lane, reg, i)
                slots[slot].add(im.a8_b_fragment(lane, reg, i)[1])
    assert sorted(slots) == list(range(32)) and all(len(v) == 1 for v in slots.values())


@pytest.mark.parametrize("byte", range(4))
def test_a8_unpack_is_exact(byte):
    """Every packed byte value, in each byte position of a column word,
    gives 16 lo and 16 hi of the plain version as signed bytes."""
    rs = np.random.RandomState(10 + byte)
    values = np.arange(256)
    lo, hi = im._unpack(torch.from_numpy(values.astype(np.uint8).view(np.int8)))
    for v in values:
        others = rs.randint(0, 256, size=4)
        others[byte] = v
        col = int(sum(int(x) << (8 * i) for i, x in enumerate(others)))
        lo16, hi16 = im.a8_unpack(col)
        assert _signed_bytes(lo16)[byte] == 16 * lo[v] and _signed_bytes(hi16)[byte] == 16 * hi[v]


def test_transpose4_gathers_columns():
    rs = np.random.RandomState(3)
    words = rs.randint(0, 256, size=(4, 4))  # [input j][byte c]
    packed = [int(sum(int(x) << (8 * c) for c, x in enumerate(row))) for row in words]
    cols = im.transpose4(*packed)
    for c in range(4):
        assert [(cols[c] >> (8 * j)) & 0xFF for j in range(4)] == list(words[:, c])


def _a8_warp(w_p4, x8, n_tiles, steps, splits):
    """One warp of K4, emulated in integers: 32 packed columns, `n_tiles`
    8-row n-tiles, `steps` k32 steps cut into `splits` split-K ranges whose
    partials are added in order. A registers come from `transpose4` and
    `a8_unpack` of the words each lane reads, B from its 8-byte x8 load,
    both placed by the PTX layout; returns (acc_lo, acc16) [rows, 32]
    written back through `a8_d_fragment`, the lo ones shifted back by 4."""
    I = 32 * steps
    words = w_p4.view(np.uint8).astype(np.int64).reshape(I, 8, 4)
    words = (words << (8 * np.arange(4))).sum(-1)  # [I, 8] little-endian words
    bounds = np.linspace(0, steps, splits + 1).astype(int)
    total = np.zeros((2, 8 * n_tiles, 32), np.int64)
    for z in range(splits):
        acc = np.zeros((n_tiles, 4, 16, 8), np.int64)  # [n-tile][m-tile][m][n]
        for s in range(bounds[z], bounds[z + 1]):
            A = np.zeros((4, 16, 32), np.int64)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for half in range(2):
                    base = 32 * s + 8 * t + 4 * half
                    cols = im.transpose4(*(int(words[base + j, g]) for j in range(4)))
                    for c in range(4):
                        for reg, bits in zip((2 * half, 2 * half + 1), im.a8_unpack(cols[c])):
                            for i, value in enumerate(_signed_bytes(bits)):
                                m, slot = _ptx_a8_a(lane, reg, i)
                                k, p, is_hi = im.a8_a_fragment(lane, c, reg, i)
                                assert (m >= 8) == is_hi and p == 4 * (m % 8) + c
                                assert k == 8 * t + (slot % 4) + 4 * (slot >= 16)
                                A[c, m, slot] = value
            for nt in range(n_tiles):
                B = np.zeros((32, 8), np.int64)
                for lane in range(32):
                    for reg in range(2):
                        for i in range(4):
                            row, k = im.a8_b_fragment(lane, reg, i)
                            slot, n = _ptx_a8_b(lane, reg, i)
                            assert n == row
                            B[slot, n] = x8[8 * nt + row, 32 * s + k]
                for c in range(4):
                    acc[nt, c] += A[c] @ B
        # int32 MMA accumulators: no wrap at these sizes
        assert np.abs(acc).max() < 2**31
        for nt in range(n_tiles):
            for c in range(4):
                for lane in range(32):
                    for reg in range(4):
                        row, p, is_hi = im.a8_d_fragment(lane, c, reg)
                        m, n = _ptx_d(lane, reg)
                        v = acc[nt, c, m, n]
                        if not is_hi:
                            assert v % 16 == 0
                            v >>= 4
                        total[int(is_hi), 8 * nt + row, p] += v
    return total


@pytest.mark.parametrize("n_tiles", [1, 2, 4, 8])
@pytest.mark.parametrize("seed,steps,splits", [(0, 1, 1), (1, 2, 2), (2, 3, 2)])
def test_a8_fragment_layout_composes_to_the_plain_version_exactly(n_tiles, seed, steps, splits):
    """The emulated warp's integers, scaled as the kernel's epilogue and
    second pass scale them (float(acc) * s * xs, two roundings), equal
    `int4_matmul_w4a8_reference` bit for bit, for any split of the input
    dimension; x8 takes its extremes -128 and 127."""
    rs = np.random.RandomState(seed)
    I, R = 32 * steps, 8 * n_tiles
    w_p4 = rs.randint(-128, 128, size=(I, 32)).astype(np.int8)
    x8 = rs.randint(-128, 128, size=(R, I)).astype(np.int8)
    x8[0, :4] = [-128, 127, -128, 127]
    acc = _a8_warp(w_p4, x8, n_tiles, steps, splits)
    xs = torch.from_numpy(rs.rand(R, 1).astype(np.float32) / 127)
    s_lo = torch.from_numpy(rs.rand(1, 32).astype(np.float32) / 7)
    s_hi16 = torch.from_numpy(rs.rand(1, 32).astype(np.float32) / 112)
    lo, hi = im._unpack(torch.from_numpy(w_p4))
    xa = torch.from_numpy(x8).long()
    assert np.array_equal(acc[0], (xa @ lo.long()).numpy())
    assert np.array_equal(acc[1], (xa @ (16 * hi).long()).numpy())
    got = torch.cat([torch.from_numpy(acc[0]).float() * s_lo * xs,
                     torch.from_numpy(acc[1]).float() * s_hi16 * xs], dim=-1)
    want = im.int4_matmul_w4a8_reference(torch.from_numpy(x8), xs, torch.from_numpy(w_p4),
                                         s_lo, s_hi16, torch.float32)
    assert torch.equal(got, want)
