"""K2's tensor-core route (bf16), checked on the CPU.

The kernel itself runs only on the card (`tests/test_torch_gpu.py`). Here:
the launch plan `w16_plan` (route, grid, splits, shared memory) at the
shapes the smoke and the card tests send, the unpack of packed nibbles into
bf16 registers, and the kernel's register layout (`tc_a_fragment`,
`tc_b_fragment`, `tc_d_fragment`, mirrored from `csrc/int4_matmul.cu`)
composed with the PTX fragment layout of `mma.sync.m16n8k16` into a matmul
that must equal the plain version.
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
SHAPES = sorted(set(PHASE5_SHAPES + INT4_CASES))
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
