"""The launch plans of the fused w8a8 MLP (csrc/w8a8_mlp.cu), the fused
LN + q/k/v kernel (csrc/w8a8_qkv.cu) and the fused attention + int8
out-projection (csrc/attention_out_int8.cu), the layout check their
wrappers make before a first launch, and the host-side weight padding the
TMA loads need: pure host arithmetic, checked on the CPU at the serving,
text and ragged shapes."""

import ast
import re
from pathlib import Path

import pytest
import torch

import chip_smoke
from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import flash_attention as tfa
from gava_clip_tpu_torch.ops import int8_matmul as tim
from tests.test_torch_bounds import module_deadline  # noqa: F401

_H100_SMS = 132                 # SMs of an H100 SXM
_H100_SMEM_OPTIN = 232448       # shared bytes one block may opt in to


def _mlp_layout_bytes(p, K):
    """The kernel's own shared-memory count for a plan (w8a8_mlp.cu
    smem_bytes): slack, the code tile (or the fc2 ring), staging, floats."""
    tile, stages1, _, stage_ld, _, tile2 = tim._MLP_LAYOUT
    rows, kp = p["rows"], -(-K // 128) * 128
    region = max(rows * kp + stages1 * tile,
                 p["stages2"] * (tile2 + rows * 128))
    return 1024 + region + rows * stage_ld + 16 * rows


@pytest.mark.parametrize("M,K,H,N,rows,grid,stages2", [
    (25216, 768, 3072, 768, 192, 132, 3),   # the serving shape
    (37, 768, 3072, 768, 64, 1, 2),
    (1576, 768, 3072, 768, 64, 25, 2),      # one clip of 8 frames
    (1155, 512, 2048, 512, 64, 19, 2),      # the text tower's MLP
    (20, 64, 200, 33, 64, 1, 2),            # ragged
    (200, 1100, 512, 77, 64, 4, 3),         # rows past 1,024 values
    (70, 2048, 3072, 768, 64, 2, 4),
])
def test_w8a8_mlp_plan_at_checked_shapes(M, K, H, N, rows, grid, stages2):
    """The plan of every shape chip_smoke checks: 192 rows a block where
    that gives each SM a block and fits, else 64; the fc2 ring of 2-4
    stages; the scratch covers the grid's rows and H rounded to 128; the
    shared bytes are the kernel's count and within a block's limit."""
    p = tim.w8a8_mlp_plan(M, K, H, N, _H100_SMS, _H100_SMEM_OPTIN)
    assert (p["rows"], p["grid"], p["stages2"]) == (rows, grid, stages2)
    assert p["grid"] * p["rows"] >= M > (p["grid"] - 1) * p["rows"]
    assert p["scratch"] == (p["grid"] * p["rows"], -(-H // 128) * 128)
    assert p["smem_bytes"] == _mlp_layout_bytes(p, K)
    assert p["smem_bytes"] + tim._MLP_LAYOUT[4] <= _H100_SMEM_OPTIN


@pytest.mark.parametrize("K", [16, 100, 768, 1024, 1100, 2048, 2304])
def test_w8a8_mlp_plan_fits_every_admitted_row_length(K):
    for M in (1, 64, 8000, 25216, 100000):
        p = tim.w8a8_mlp_plan(M, K, 3072, 768, _H100_SMS, _H100_SMEM_OPTIN)
        assert p["rows"] in tim._MLP_ROWS
        assert 2 <= p["stages2"] <= tim._MLP_LAYOUT[2]
        assert p["smem_bytes"] + tim._MLP_LAYOUT[4] <= _H100_SMEM_OPTIN


@pytest.mark.parametrize("args", [
    (37, 2816, 3072, 768, _H100_SMS, _H100_SMEM_OPTIN),   # rows too long
    (37, 768, 3072, 768, _H100_SMS, 48 * 1024),           # a small card
    (0, 768, 3072, 768, _H100_SMS, _H100_SMEM_OPTIN),
    (37, 768, 0, 768, _H100_SMS, _H100_SMEM_OPTIN),
])
def test_w8a8_mlp_plan_raises_for_shapes_it_cannot_take(args):
    with pytest.raises(ValueError):
        tim.w8a8_mlp_plan(*args)


@pytest.mark.parametrize("n,k", [(33, 200), (7, 1100), (768, 3072), (5, 16)])
def test_tma_rows_padding_and_its_inverse(n, k):
    """The MLP's weights as TMA loads them: rows of a multiple of 16 bytes,
    zero past the weight; cutting the padding off gives the weight back,
    and a weight that needs none is passed as it is."""
    w = torch.randint(-127, 128, (n, k), dtype=torch.int8)
    out = tim._tma_rows(w)
    assert out.shape == (n, -(-k // 16) * 16)
    assert torch.equal(out[:, :k], w)
    assert not out[:, k:].any()
    if k % 16 == 0:
        assert out is w


# ---------------------------------------------------------------------------
# the fused LN + q/k/v kernel (csrc/w8a8_qkv.cu) and the fused attention +
# int8 out-projection (csrc/attention_out_int8.cu)
# ---------------------------------------------------------------------------

_CSRC = Path(tim.__file__).resolve().parent.parent / "csrc"


def _cuda_constants(*names):
    """The `constexpr int` constants of kernel sources, evaluated from
    their expressions (each may name constants defined before it)."""
    env = {}
    pat = re.compile(r"^constexpr (?:int|uint32_t) (\w+) = ([^;]+);", re.M)
    for name in names:
        for n, expr in pat.findall((_CSRC / name).read_text()):
            expr = re.sub(r"(0x[0-9A-Fa-f]+)u\b", r"\1", expr)
            env[n] = eval(compile(ast.parse(expr, mode="eval"), name, "eval"),
                          {}, dict(env))
    return env


def test_qkv_layout_is_the_kernel_source_s():
    """The plan's constants are the ones w8a8_qkv_layout reports: the
    source's own constants, read here without building it."""
    c = _cuda_constants("w8a8_wgmma.cuh", "w8a8_qkv.cu")
    assert tim._QKV_LAYOUT == (c["kSlabBytes"], c["kMaxStages"],
                               c["kUnitCols"], c["kStaticBytes"])
    # the static barriers (the two rings' full / empty) fit the static
    # bytes the plan leaves them
    assert 8 * 4 * c["kMaxStages"] <= c["kStaticBytes"]


def test_attention_out_layout_is_the_kernel_source_s():
    c = _cuda_constants("w8a8_wgmma.cuh", "attention_out_int8.cu")
    assert tfa._ATTN_OUT_LAYOUT == (c["kKVStageBytes"], c["kKVStages"],
                                    c["kThreadsAttn"], c["kStaticBytes"],
                                    c["kWRingBytes"])
    assert tfa._ATTN_OUT_ROWS == c["kRows"]


class _FakeLayoutLib:
    """Stands for a built library: its layout function writes `vals`."""

    def __init__(self, fn, vals):
        def layout(out):
            for i, v in enumerate(vals):
                out[i] = v
        setattr(self, fn, layout)


@pytest.mark.parametrize("fn,want", [
    ("w8a8_matmul_layout", tim._B2_LAYOUT),
    ("w8a8_matmul_layout_f32", tim._B2_LAYOUT_F32),
    ("w8a8_qkv_layout", tim._QKV_LAYOUT),
    ("attention_out_int8_layout", tfa._ATTN_OUT_LAYOUT),
    ("w8a8_mlp_layout", tim._MLP_LAYOUT),
])
def test_layout_check_before_first_launch(fn, want):
    """The wrappers hold the built library's constants against the plan's
    before the first launch (smem_limit -> check_layout) and take the card's
    shared-memory limit from it; another layout raises."""
    assert tim.check_layout(_FakeLayoutLib(fn, want + (_H100_SMEM_OPTIN,)),
                            fn, want) == _H100_SMEM_OPTIN
    bad = (want[0] + 16,) + tuple(want[1:]) + (_H100_SMEM_OPTIN,)
    with pytest.raises(RuntimeError, match="layout"):
        tim.check_layout(_FakeLayoutLib(fn, bad), fn, want)


def _qkv_smem(rows, K, N, stages, esize):
    """The kernel's count (w8a8_qkv.cu smem_bytes, staging_bytes): slack,
    the code tile, the two rings, the two staging tiles of BM x 64 outputs
    where the outputs' rows are a multiple of 16 bytes, the row scales."""
    slab = tim._QKV_LAYOUT[0]
    staging = 2 * rows * 64 * esize if rows > 64 and N * esize % 16 == 0 \
        else 0
    return (1024 + rows * (-(-K // 128) * 128) + 2 * stages * slab + staging
            + 4 * rows)


# (M, K, N): the serving shape (B3 and B3a: 27,392 kv rows), no extras rows
# (25,216), chip_smoke's ragged shapes, the text tower (1,155 x 512), the
# longest rows of before, a card's worth of 128-row tiles, the fp32 w8a8
# evaluation at batch 64 (13,696), the long clip's 4 x 70 x 214 kv rows
@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("M,K,N,rows,grid,per_sm,stages", [
    (128 * 214, 768, 768, 112, (245, 1), 1, (7, 5)),
    (128 * 197, 768, 768, 112, (226, 1), 1, (7, 5)),
    (3 * 18, 96, 40, 32, (2, 3), 2, (6, 6)),
    (4 * 21, 768, 768, 32, (3, 18), 2, (5, 5)),
    (2 * 9, 64, 19, 32, (1, 3), 2, (6, 6)),
    (1155, 512, 512, 32, (37, 4), 2, (5, 5)),
    (200, 1100, 77, 32, (7, 3), 2, (4, 4)),
    (37, 100, 40, 32, (2, 3), 2, (6, 6)),
    (100, 3456, 768, 32, (4, 18), 1, (7, 7)),
    (132 * 128, 768, 768, 128, (132, 1), 1, (6, 4)),
    (64 * 214, 768, 768, 64, (214, 1), 2, (3, 3)),
    (280 * 214, 768, 768, 128, (469, 1), 1, (6, 4)),
])
def test_w8a8_qkv_plan_at_checked_shapes(M, K, N, rows, grid, per_sm,
                                         stages, esize):
    """Every shape chip_smoke checks (W8A8_QKV_SHAPES, F32_B3_SHAPES,
    F32_B3A_SHAPES and B3a's), in bf16 and fp32 (`stages`: each's ring
    depth), gets a plan whose shared bytes are the kernel's count and fit a
    block (and two where two share an SM); the grid covers every row and
    every unit exactly once."""
    p = tim.w8a8_qkv_plan(M, K, N, _H100_SMS, _H100_SMEM_OPTIN, esize=esize)
    assert (p["rows"], p["grid"], p["per_sm"], p["stages"]) == \
        (rows, grid, per_sm, stages[esize // 4])
    tiles, split = p["grid"]
    assert tiles * p["rows"] >= M > (tiles - 1) * p["rows"]
    assert p["units"] * split == 3 * -(-N // 128)
    assert p["blocks"] == tiles * split
    assert 3 <= p["stages"] <= tim._QKV_LAYOUT[1]
    assert p["smem_bytes"] == _qkv_smem(p["rows"], K, N, p["stages"], esize)
    assert p["smem_bytes"] + tim._QKV_LAYOUT[3] <= _H100_SMEM_OPTIN
    assert p["per_sm"] * (p["smem_bytes"] + tim._QKV_LAYOUT[3] + 1024) \
        <= tim._SM90_SMEM_PER_SM


def test_w8a8_qkv_plan_stages_the_tiles_only_where_tma_stores_them():
    """The staging tiles (one per consumer warpgroup, BM x 64 outputs) are
    planned for tiles of more than 64 rows whose outputs' rows are a
    multiple of 16 bytes (TMA's stride rule), where the kernel stages them;
    elsewhere the epilogue stores from the registers and the rings take the
    room (two blocks of up to 64 rows to an SM keep theirs)."""
    p = tim.w8a8_qkv_plan(27392, 768, 768, _H100_SMS, _H100_SMEM_OPTIN,
                          esize=4)
    assert p["staging"] == 2 * 112 * 64 * 4
    for N, esize in ((77, 2), (77, 4), (19, 4), (36, 2)):
        q = tim.w8a8_qkv_plan(27392, 768, N, _H100_SMS, _H100_SMEM_OPTIN,
                              esize=esize)
        assert q["staging"] == 0 and q["stages"] == 8
    assert tim.w8a8_qkv_plan(27392, 768, 36, _H100_SMS, _H100_SMEM_OPTIN,
                             esize=4)["staging"] > 0
    assert tim.w8a8_qkv_plan(1155, 512, 512, _H100_SMS, _H100_SMEM_OPTIN,
                             esize=4)["staging"] == 0
    with pytest.raises(ValueError):
        tim.w8a8_qkv_plan(200, 768, 36, _H100_SMS, _H100_SMEM_OPTIN, esize=8)


def _qkv_schedule(p, sms):
    """A Python mirror of the kernel's blocks (w8a8_qkv.cu: block b takes row
    tile b // groups and units (b % groups) * units .. + units) placed on
    the SMs as the card places a grid, each slot (per_sm of them an SM)
    taking the next block as it frees: {sm: [(tile, unit), ...]}, the
    rounds of equal blocks in turn."""
    tiles, groups = p["grid"]
    out = {sm: [] for sm in range(sms)}
    for b in range(p["blocks"]):
        sm = b % (sms * p["per_sm"]) // p["per_sm"]
        out[sm] += [(b // groups, b % groups * p["units"] + j)
                    for j in range(p["units"])]
    return out


@pytest.mark.parametrize("M,K,N", [
    (128 * 214, 768, 768), (128 * 197, 768, 768), (1155, 512, 512),
    (3 * 18, 96, 40), (4 * 21, 768, 768), (2 * 9, 64, 19), (200, 1100, 77),
    (100, 3456, 768), (132 * 128, 768, 768), (64 * 214, 768, 768),
    (27392, 1100, 77), (4000, 768, 768), (1, 768, 768), (280 * 214, 768, 768),
])
def test_w8a8_qkv_schedule_covers_every_tile_and_unit_once(M, K, N):
    """The blocks cover every (row tile, unit) exactly once, and no SM takes
    more than one round of blocks above another."""
    p = tim.w8a8_qkv_plan(M, K, N, _H100_SMS, _H100_SMEM_OPTIN)
    tiles, groups = p["grid"]
    sched = _qkv_schedule(p, _H100_SMS)
    seen = [tu for work in sched.values() for tu in work]
    assert sorted(seen) == [(t, u) for t in range(tiles)
                            for u in range(3 * -(-N // 128))]
    rounds = [-(-len(work) // (p["units"] * p["per_sm"]))
              for work in sched.values()]
    assert max(rounds) - min(rounds) <= 1


def test_w8a8_qkv_plan_spreads_the_serving_rows_evenly():
    """At the serving shape the busiest SM takes 224 rows (two tiles of
    112) where 128-row tiles gave it 256: 93% of the SM-rounds busy against
    81%; the plan picks the rows that put the fewest on the busiest SM."""
    M = 128 * 214
    p = tim.w8a8_qkv_plan(M, 768, 768, _H100_SMS, _H100_SMEM_OPTIN)
    rounds = -(-p["blocks"] // _H100_SMS)
    assert (p["rows"], rounds * p["rows"]) == (112, 224)
    assert M / (_H100_SMS * rounds * p["rows"]) > 0.92
    p128 = tim.w8a8_qkv_plan(M, 768, 768, _H100_SMS, _H100_SMEM_OPTIN,
                             rows=128)
    assert -(-p128["blocks"] // _H100_SMS) * 128 == 256
    assert M / (_H100_SMS * 256) < 0.82


def test_w8a8_qkv_plan_fills_the_card_at_the_text_shape():
    """B3a's 1,155 rows: 37 tiles of 32 rows; the units are shared out until
    every SM has a block (148 blocks, two to an SM: one wave)."""
    p = tim.w8a8_qkv_plan(1155, 512, 512, _H100_SMS, _H100_SMEM_OPTIN)
    assert _H100_SMS <= p["blocks"] <= p["per_sm"] * _H100_SMS


@pytest.mark.parametrize("K", [16, 100, 768, 1024, 1100, 2048, 3456, 5632])
def test_w8a8_qkv_plan_fits_every_admitted_row_length(K):
    for M in (1, 64, 1155, 27392, 100000):
        p = tim.w8a8_qkv_plan(M, K, 768, _H100_SMS, _H100_SMEM_OPTIN)
        assert p["rows"] in tim._QKV_WIDE_ROWS + tim._QKV_ROWS
        assert p["smem_bytes"] + tim._QKV_LAYOUT[3] <= _H100_SMEM_OPTIN


@pytest.mark.parametrize("args", [
    (37, 5760, 768, _H100_SMS, _H100_SMEM_OPTIN),   # rows too long
    (37, 768, 768, _H100_SMS, 48 * 1024),           # a small card
    (0, 768, 768, _H100_SMS, _H100_SMEM_OPTIN),
])
def test_w8a8_qkv_plan_raises_for_shapes_it_cannot_take(args):
    with pytest.raises(ValueError):
        tim.w8a8_qkv_plan(*args)


def test_w8a8_qkv_plan_refuses_a_form_that_does_not_fit():
    """`rows` picks another form where it fits (kernel_variants times
    them); 128-row tiles of the text shape leave SMs without a block, and
    are refused."""
    assert tim.w8a8_qkv_plan(27392, 768, 768, _H100_SMS, _H100_SMEM_OPTIN,
                             rows=128)["rows"] == 128
    with pytest.raises(ValueError):
        tim.w8a8_qkv_plan(1155, 512, 512, _H100_SMS, _H100_SMEM_OPTIN,
                          rows=128)


# ---------------------------------------------------------------------------
# the w8a8 GEMM (csrc/w8a8_matmul.cu)
# ---------------------------------------------------------------------------

def test_w8a8_matmul_layout_is_the_kernel_source_s():
    c = _cuda_constants("w8a8_wgmma.cuh", "w8a8_matmul.cu")
    assert tim._B2_LAYOUT == (c["kSlabBytes"], c["kMaxStages"],
                              c["kUnitCols"], c["kStageBytes"],
                              c["kStaticBytes"])


def test_w8a8_matmul_f32_layout_is_the_kernel_source_s():
    """The fp32 form's constants (w8a8_matmul_layout_f32): the bf16 form's,
    without the epilogue's staging tiles."""
    c = _cuda_constants("w8a8_wgmma.cuh", "w8a8_matmul.cu")
    assert tim._B2_LAYOUT_F32 == (c["kSlabBytes"], c["kMaxStages"],
                                  c["kUnitCols"], c["kStageBytesF32"],
                                  c["kStaticBytes"])
    assert c["kStageBytesF32"] == 0


def _b2_smem(rows, K, stages, layout=tim._B2_LAYOUT):
    """The kernel's count (w8a8_matmul.cu smem_bytes): slack, the code tile,
    the two rings, the staging tiles, the row scales."""
    slab, _, _, stage_bytes, _ = layout
    return (1024 + rows * (-(-K // 128) * 128) + 2 * stages * slab
            + stage_bytes + 4 * rows)


@pytest.mark.parametrize("M,K,N,rows,units,blocks", [
    (25088, 768, 768, 192, 6, 131),   # the patch embed at batch 16: one wave
    (1155, 512, 512, 32, 1, 148),     # the text tower: out-projection,
    (1155, 512, 2048, 32, 4, 148),    # fc1,
    (1155, 2048, 512, 32, 2, 74),     # fc2 (one block to an SM)
    (1568, 768, 768, 32, 2, 147),     # the patch embed of one clip
    (37, 768, 77, 32, 1, 2),          # chip_smoke's ragged shapes
    (45, 100, 33, 32, 1, 2),
    (37, 1100, 77, 32, 1, 2),
    (37, 4096, 77, 32, 1, 2),
    (19, 8000, 40, 16, 1, 2),
    (19, 14272, 40, 8, 1, 3),         # the longest rows of before
])
def test_w8a8_matmul_plan_at_checked_shapes(M, K, N, rows, units, blocks):
    """Every shape chip_smoke checks (W8A8_MATMUL_SHAPES) gets the measured
    form: 192 rows where those tiles alone fill all SMs but one (the patch
    embed: 131 blocks, one wave), else 32 with N shared out over as many
    blocks as run in one wave (the text tower's 1,155 rows: 148 blocks two
    to an SM, or 74 where one fits an SM), fewer rows for rows too long;
    the shared bytes are the kernel's count and fit a block (and two where
    two share an SM); the grid covers every row and unit exactly once."""
    p = tim.w8a8_matmul_plan(M, K, N, _H100_SMS, _H100_SMEM_OPTIN)
    assert (p["rows"], p["units"], p["blocks"]) == (rows, units, blocks)
    tiles, groups = p["grid"]
    total = -(-N // 128)
    assert tiles * rows >= M > (tiles - 1) * rows
    assert groups * units >= total > (groups - 1) * units
    assert p["blocks"] == tiles * groups
    assert tim._QKV_MIN_STAGES <= p["stages"] <= tim._B2_LAYOUT[1]
    assert p["smem_bytes"] == _b2_smem(rows, K, p["stages"])
    assert p["smem_bytes"] + tim._B2_LAYOUT[4] <= _H100_SMEM_OPTIN
    assert p["per_sm"] * (p["smem_bytes"] + tim._B2_LAYOUT[4] + 1024) \
        <= tim._SM90_SMEM_PER_SM
    assert p["blocks"] <= p["per_sm"] * _H100_SMS or groups == 1


def test_w8a8_matmul_plan_takes_other_forms():
    """The forms the variants tool times beside the plan's: the rows and
    units asked for, with the stages and bytes that they fit."""
    p = tim.w8a8_matmul_plan(25088, 768, 768, _H100_SMS, _H100_SMEM_OPTIN,
                             rows=128, units=3)
    assert (p["rows"], p["units"], p["grid"]) == (128, 3, (196, 2))
    assert p["smem_bytes"] == _b2_smem(128, 768, p["stages"])
    with pytest.raises(ValueError):
        tim.w8a8_matmul_plan(1155, 2048, 512, _H100_SMS, _H100_SMEM_OPTIN,
                             rows=128)


@pytest.mark.parametrize("K", [16, 100, 768, 1024, 1100, 2048, 8000, 14272,
                               21632])
def test_w8a8_matmul_plan_fits_every_admitted_row_length(K):
    """K up to 21,632 (8 rows of codes and three ring stages fill a
    block's shared memory), a multiple of 64 or not."""
    for M in (1, 64, 1155, 25088, 100000):
        p = tim.w8a8_matmul_plan(M, K, 768, _H100_SMS, _H100_SMEM_OPTIN)
        assert p["rows"] in tim._B2_ROWS
        assert p["smem_bytes"] + tim._B2_LAYOUT[4] <= _H100_SMEM_OPTIN


@pytest.mark.parametrize("args", [
    (19, 21760, 40, _H100_SMS, _H100_SMEM_OPTIN),   # rows too long
    (37, 768, 768, _H100_SMS, 48 * 1024),           # a small card
    (0, 768, 768, _H100_SMS, _H100_SMEM_OPTIN),
    (37, 768, 0, _H100_SMS, _H100_SMEM_OPTIN),
])
def test_w8a8_matmul_plan_raises_for_shapes_it_cannot_take(args):
    with pytest.raises(ValueError):
        tim.w8a8_matmul_plan(*args)


@pytest.mark.parametrize("M,K,N", [
    (25216, 768, 768),   # the vision out-projection at 16 x 8, and B4's
    (1155, 512, 512),    # the text tower: q / k / v / out-projection,
    (1155, 512, 2048),   # fc1,
    (1155, 2048, 512),   # fc2
    (37, 768, 77), (45, 100, 33), (37, 1100, 77), (37, 4096, 77),
    (19, 8000, 40), (19, 14272, 40),
])
def test_w8a8_matmul_f32_plan_at_checked_shapes(M, K, N):
    """The fp32 form (esize 4) takes the bf16 plan's rows, units and grid;
    its shared bytes are the kernel's count without the staging tiles (the
    stages may grow into them) and fit a block, two where two share an
    SM."""
    p = tim.w8a8_matmul_plan(M, K, N, _H100_SMS, _H100_SMEM_OPTIN, esize=4)
    b = tim.w8a8_matmul_plan(M, K, N, _H100_SMS, _H100_SMEM_OPTIN)
    assert (p["rows"], p["units"], p["grid"], p["per_sm"]) == \
        (b["rows"], b["units"], b["grid"], b["per_sm"])
    assert b["stages"] <= p["stages"] <= tim._B2_LAYOUT_F32[1]
    assert p["smem_bytes"] == _b2_smem(p["rows"], K, p["stages"],
                                       tim._B2_LAYOUT_F32)
    assert p["smem_bytes"] + tim._B2_LAYOUT_F32[4] <= _H100_SMEM_OPTIN
    assert p["per_sm"] * (p["smem_bytes"] + tim._B2_LAYOUT_F32[4] + 1024) \
        <= tim._SM90_SMEM_PER_SM


def test_w8a8_matmul_plan_refuses_other_element_sizes():
    with pytest.raises(ValueError, match="bytes"):
        tim.w8a8_matmul_plan(37, 768, 77, _H100_SMS, _H100_SMEM_OPTIN,
                             esize=1)


# ---------------------------------------------------------------------------
# the whole-layer kernel of the layer tool (csrc/mega_layer.cu)
# ---------------------------------------------------------------------------

def test_mega_layer_limits_are_the_kernel_source_s():
    """The tool's limits are the kernel's constants: tiles of 128 rows, a
    frame row's workspace of two of them, at most 256 keys, head dim 64."""
    from gava_clip_tpu_torch.tools import bench_attn_variants as tool
    c = _cuda_constants("w8a8_wgmma.cuh", "mega_layer.cu")
    assert (tool._TILE, tool._MAX_KEYS, tool._HEAD_DIM) == \
        (c["kBM"], c["kMaxKeys"], c["kHD"])
    assert c["kRowsF"] == 2 * c["kBM"] == c["kMaxKeys"]
    assert c["kRunStages"] == 6


@pytest.mark.parametrize("frames,lx,le,split,tiles", [
    (64, 197, 17, 2, (2, 2)),     # the tool's shape: 128 CTAs
    (128, 197, 17, 1, (2, 2)),    # the serving batch: 128 CTAs of two tiles
    (3, 50, 5, 1, (1, 1)),        # chip_smoke's ragged shape
    (3, 100, 60, 2, (2, 1)),      # two kv tiles, one query tile
    (1000, 197, 17, 1, (2, 2)),
])
def test_mega_layer_plan_at_checked_shapes(frames, lx, le, split, tiles):
    from gava_clip_tpu_torch.tools import bench_attn_variants as tool
    p = tool.mega_layer_plan(frames, _H100_SMS, lx, le)
    assert p == {"split": split, "grid": (split, frames), "tiles": tiles}
    assert p["grid"][0] * frames <= _H100_SMS or split == 1


def _attn_smem(H):
    """The kernel's count (attention_out_int8.cu smem_bytes): slack, the K/V
    ring or the code tile in its space, the W^T ring, floats."""
    stage, stages, _, _, wring = tfa._ATTN_OUT_LAYOUT
    rows = tfa._ATTN_OUT_ROWS
    dp = -(-H * 64 // 128) * 128
    return (1024 + max(rows * dp, stages * stage) + wring + 4 * rows
            + 4 * stages * 64)


@pytest.mark.parametrize("B,lq,H,chunks,per_sm", [
    (128, 197, 12, 2, 2),   # the serving shape: two blocks a frame row
    (3, 13, 2, 1, 2),       # chip_smoke's W8A8_ATTN_SHAPES
    (2, 77, 4, 1, 2),
    (2, 40, 12, 1, 2),
    (3, 13, 2, 1, 2),       # and W8A8_2SRC_SHAPES (every q row a query)
    (2, 70, 3, 1, 2),
    (2, 64, 4, 1, 2),
    (128, 197, 16, 2, 1),   # the widest rows: 16 heads
])
def test_attention_out_plan_at_checked_shapes(B, lq, H, chunks, per_sm):
    p = tfa.attention_out_plan(B, lq, H, _H100_SMEM_OPTIN)
    rows = p["rows"]
    assert rows == tfa._ATTN_OUT_ROWS and rows % 16 == 0
    assert p["grid"] == (chunks, B) and chunks * rows >= lq > (chunks - 1) * rows
    assert p["per_sm"] == per_sm
    assert p["smem_bytes"] == _attn_smem(H)
    assert p["smem_bytes"] + tfa._ATTN_OUT_LAYOUT[3] <= _H100_SMEM_OPTIN
    assert p["per_sm"] * (p["smem_bytes"] + tfa._ATTN_OUT_LAYOUT[3] + 1024) \
        <= tim._SM90_SMEM_PER_SM
    # the fp32 scratch holds every row of every block
    assert p["scratch"] == (B, chunks * rows, H * 64)


@pytest.mark.parametrize("args", [(2, 197, 17), (0, 197, 12), (2, 0, 12),
                                  (2, 197, 12, 48 * 1024)])
def test_attention_out_plan_raises_for_shapes_it_cannot_take(args):
    if len(args) == 3:
        args = args + (_H100_SMEM_OPTIN,)
    with pytest.raises(ValueError):
        tfa.attention_out_plan(*args)


def test_profiled_symbols_are_kernels_of_the_sources():
    """Every name chip_smoke's profile tables list a hand-written kernel by
    is the name of a __global__ function in csrc/ (a renamed kernel would
    drop out of the tables unseen)."""
    import sys
    sys.path.insert(0, str(_CSRC.parent.parent))
    import chip_smoke
    text = "".join(p.read_text() for p in sorted(_CSRC.glob("*.cu*")))
    kernels = set(re.findall(
        r"__global__ void(?: __launch_bounds__\((?:[^()]|\([^()]*\))*\))?"
        r"\s+(\w+)\(", text))
    missing = [s for s in chip_smoke.KERNEL_SYMBOLS if s not in kernels]
    assert not missing, (missing, sorted(kernels))


# ---------------------------------------------------------------------------
# the streaming attention backward (csrc/streaming_attention_bwd.cu,
# attention_bwd.cuh) and the fused prompt extras (csrc/fused_extras.cu)
# ---------------------------------------------------------------------------

def test_streaming_bwd_layout_is_the_kernel_source_s():
    """The plan's constants are the ones streaming_attention_bwd_layout
    reports: the most rows of the one-launch form (8 warps of 16 keys), its
    shared bytes (q, do, k, v tiles, ds^T, two floats a row) and threads."""
    c = _cuda_constants("attention_common.cuh", "attention_bwd.cuh")
    assert tfa._SBWD_LAYOUT == (c["kFRows"], c["kFSmemBytes"],
                                c["kFThreads"])
    rows = c["kFRows"]
    assert c["kFSmemBytes"] == (4 * rows * c["kLDS"] * 2
                                + rows * (rows + 8) * 2 + 2 * rows * 4)
    assert c["kFSmemBytes"] <= _H100_SMEM_OPTIN


@pytest.mark.parametrize("B,Lq,Lk,H,form", [
    (15, 77, 77, 8, "one_launch"),      # the text tower (TRAIN_STREAM_SHAPES)
    (4, 1024, 1024, 8, "two_kernels"),
    (2, 130, 700, 2, "two_kernels"),
    (3, 13, 21, 2, "one_launch"),
    (2, 100, 60, 2, "one_launch"),
    (2, 200, 200, 3, "two_kernels"),
    (1, 128, 128, 1, "one_launch"),     # the layout's edge
    (1, 129, 16, 1, "two_kernels"),
    (1, 16, 129, 1, "two_kernels"),
])
def test_streaming_bwd_plan_at_checked_shapes(B, Lq, Lk, H, form):
    """Every shape chip_smoke checks: one launch of a block per (row, head)
    with the layout's shared bytes while every query row and key fits the
    one-launch tiles, else the two kernels (two launches)."""
    p = tfa.streaming_bwd_plan(B, Lq, Lk, H)
    assert p["form"] == form
    if form == "one_launch":
        assert (p["launches"], p["grid"]) == (1, B * H)
        assert p["smem_bytes"] == tfa._SBWD_LAYOUT[1]
    else:
        assert p["launches"] == 2 and p["smem_bytes"] == 0
        assert p["grid"] == (-(-Lq // 64) * H * B, -(-Lk // 64) * H * B)


def test_streaming_bwd_layout_check_before_first_launch():
    """The wrapper holds the built library's layout against the plan's
    before its first launch; another layout raises."""
    fn, want = "streaming_attention_bwd_layout", tfa._SBWD_LAYOUT
    tfa._bwd_layout_checked.discard("fake")
    tfa._check_layout("fake", _FakeLayoutLib(fn, want), fn, want)
    tfa._bwd_layout_checked.discard("fake")
    bad = (want[0],) + (want[1] + 16,) + tuple(want[2:])
    with pytest.raises(RuntimeError, match="layout"):
        tfa._check_layout("fake", _FakeLayoutLib(fn, bad), fn, want)


def test_fused_extras_layout_is_the_kernel_source_s():
    """The plan's constants are fused_extras_layout's: the source's own,
    and the shared bytes its smem_bytes<WT>() counts (A tile, weight tile
    of the widest stage, partial tile, two floats a row)."""
    from gava_clip_tpu_torch.ops import extras_kernel as tek
    c = _cuda_constants("fused_extras.cu")
    rows, kc, slice_n, head_n = (c["kRowsT"], c["kKC"], c["kSliceN"],
                                 c["kHeadN"])
    assert tek._EXTRAS_LAYOUT[:6] == (rows, kc, slice_n, head_n, c["kMaxTb"],
                                      c["kMaxCS"])
    for wbytes, want in ((4, tek._EXTRAS_LAYOUT[6]),
                         (2, tek._EXTRAS_LAYOUT[7])):
        assert want == (rows * c["kLDA"] * 4 + kc * (head_n + 8) * wbytes
                        + rows * c["kLDP3"] * 4 + 2 * rows * 4)
        assert want <= _H100_SMEM_OPTIN
    # every thread takes whole groups of four A values
    assert rows * (kc // 4) % c["kThreads"] == 0


@pytest.mark.parametrize("Bb,Tb,D,H,fit,clusters,sub,tiles", [
    (16, 8, 768, 12, 16, 12, 1, 1),     # the serving shape: 96 blocks
    (16, 8, 768, 12, 10, 10, 1, 1),     # a card that holds fewer clusters
    (4, 8, 768, 12, 16, 12, 1, 1),      # chip_smoke's EXTRAS_SHAPES
    (3, 3, 40, 2, 16, 2, 1, 1),
    (2, 5, 64, 4, 16, 4, 1, 1),
    (20, 8, 1024, 16, 14, 14, 2, 2),    # and EXTRAS_TILED_SHAPES
    (3, 40, 256, 4, 16, 4, 1, 1),
])
def test_fused_extras_plan_at_checked_shapes(Bb, Tb, D, H, fit, clusters,
                                             sub, tiles):
    """A cluster per 64-column slice and per head, at most as many as the
    card holds at once (the stages meet at grid-wide barriers); K split
    over the cluster's 8 blocks in sub-chunks of 96; 128-row tiles; the
    workspace holds cp, the attention output, every head's q, k, v and two
    statistics per (row, slice)."""
    from gava_clip_tpu_torch.ops import extras_kernel as tek
    p = tek.fused_extras_plan(Bb, Tb, D, H, fit)
    assert (p["cs"], p["clusters"], p["blocks"]) == (8, clusters,
                                                     8 * clusters)
    assert (p["sub_chunks"], p["row_tiles"]) == (sub, tiles)
    # K values of a block: D / 8 rounded up to a whole mma step of 8
    assert p["k_per_block"] == -(-D // 64) * 8
    BT, ns = Bb * Tb, -(-D // 64)
    assert p["workspace_floats"] == 2 * BT * D + 192 * H * BT + 2 * BT * ns


@pytest.mark.parametrize("args", [
    (16, 8, 768, 6, 16),        # heads of 128 values
    (16, 8, 36, 6, 16),         # heads of 6 values (not a multiple of 4)
    (16, 8, 770, 10, 16),       # a width not a multiple of 4
    (2, 65, 768, 12, 16),       # clips of more than 64 frames
    (16, 8, 768, 12, 0),        # a card that holds no cluster
])
def test_fused_extras_plan_raises_for_shapes_it_cannot_take(args):
    from gava_clip_tpu_torch.ops import extras_kernel as tek
    with pytest.raises(ValueError):
        tek.fused_extras_plan(*args)
    with pytest.raises(ValueError):
        tek.fused_extras_plan(16, 8, 768, 12, 16, cs=3)


def test_fused_extras_stages_meet_at_a_cooperative_grid_barrier():
    """Every launch of B10 is cooperative (the driver refuses it unless
    every block of the plan can be resident at once) and its stages meet at
    cooperative groups' grid barrier: there is no counter of the kernel's
    own, so no launch shares state with another."""
    import re
    src = (_CSRC / "fused_extras.cu").read_text()
    code = re.sub(r"//[^\n]*", "", src)
    assert code.count("cudaLaunchAttributeCooperative") == 1
    assert "cudaLaunchKernelEx(&l.cfg" in code
    assert "cg::this_grid()" in code
    assert "grid.barrier_arrive()" in code and "grid.sync()" in code
    assert "atomic" not in code


# ---------------------------------------------------------------------------
# the float32 attention kernels (csrc/attention_f32.cu)
# ---------------------------------------------------------------------------

_SM90_SMEM_PER_SM = 233472      # shared bytes of an SM (228 KB)
_BLOCK_RESERVED = 1024          # shared bytes the runtime keeps per block


def test_attention_f32_layout_is_the_kernel_source_s():
    """The plans' constants are the ones attention_f32_layout reports. The
    FMA tiles (B7's backward past 128 rows): 64-row tiles padded to 68
    floats, 256 threads, each kernel's shared bytes as its tiles and row
    floats add up, the dq kernel two blocks to an SM. The 3xTF32 forward
    (B1 / B6a and B7's): 4 warps of 16 query rows, two stages of 64-key k
    and v tiles, three blocks to an SM; B7's steps of whole 8-key chunks
    that tile a key tile. The 3xTF32 backward: 8
    warps of 16 keys, two key stages, one value tile, two stages of 32-row q
    and do tiles and ds^T fixed, 74 floats a query row (a 72-float dq row,
    inv_d, delta), its accumulator in shared memory up to Lq 240; B7's
    backward takes it in one launch for rows up to one key tile (128), whose
    accumulator always fits. The w8a8 fusion's fp32 forward: warps of 16
    query rows (rl + 4 i of a 4 x 8 patch, lane 8 rl + cl, and an mma
    m16n8k32's rows), key tiles of 64 keys (cl + 8 j), its q rows, one key
    and one value tile padded to 68 floats, each warp's 16 e rows padded to
    72, the q and key row scales and codes rows of 80 bytes (16-byte
    aligned, and 20 words apart: a fragment's rows g = 0..7 fall in
    distinct banks), every region 16-byte aligned; two blocks to an SM."""
    c = _cuda_constants("attention_f32.cu")
    assert "kFwdSmemBytes" not in c and "stream_fwd_kernel" not in (
        _CSRC / "attention_f32.cu").read_text()
    assert tfa._F32_LAYOUT == (
        c["kT"], c["kThreads"], c["kDqSmemBytes"],
        c["kDkvSmemBytes"], c["kFwdRows"], c["kFwdThreads"],
        c["kPFwdSmemBytes"], c["kBwdThreads"], c["kBwdFixedBytes"],
        c["kAccLD"] + 2, c["kMaxSmem"], c["kStreamBwdRows"],
        c["kFmaRows"], c["kFmaThreads"], c["kFmaSmemBytes"])
    assert c["kStreamBwdRows"] == c["kBwdKeys"] == 128
    assert c["kBwdFixedBytes"] + c["kStreamBwdRows"] * (c["kAccLD"] + 2) * 4 \
        <= c["kMaxSmem"]
    tile = c["kHD"] * c["kLD"] * 4
    assert c["kHD"] == tfa._KERNEL_HEAD_DIM == c["kT"]
    assert c["kLD"] * 4 % 16 == 0 and c["kLDF"] * 4 % 16 == 0   # 16-byte rows
    assert c["kThreads"] == (c["kT"] // 4) ** 2     # a 4 x 4 patch a thread
    assert (c["kDqSmemBytes"], c["kDkvSmemBytes"]) == (
        6 * tile + 2 * c["kT"] * 4, 8 * tile + 2 * c["kT"] * 4)
    row = c["kLDF"] * 4
    assert c["kFwdRows"] == 16 * c["kFwdThreads"] // 32
    assert c["kPFwdSmemBytes"] == 2 * 2 * c["kFwdKeys"] * row
    assert c["kFwdKeys"] % (8 * c["kStreamChunks"]) == 0
    assert c["kBwdKeys"] == 16 * c["kBwdThreads"] // 32
    assert c["kBwdFixedBytes"] == (3 * c["kBwdKeys"] * row
                                   + 4 * c["kBwdRows"] * row
                                   + c["kBwdKeys"] * c["kLDD"] * 4)
    assert c["kMaxSmem"] == _H100_SMEM_OPTIN
    assert c["kBwdFixedBytes"] + 240 * (c["kAccLD"] + 2) * 4 <= c["kMaxSmem"]
    assert c["kBwdFixedBytes"] + 256 * (c["kAccLD"] + 2) * 4 > c["kMaxSmem"]
    rows, keys = c["kFmaRows"], c["kFmaKeys"]
    assert rows == 16 * c["kFmaWarps"] and c["kFmaThreads"] == 32 * c["kFmaWarps"]
    assert keys == 8 * 8 and c["kLDE"] == keys + 8 and c["kLDE"] % 32 == 8
    assert c["kLDC"] % 16 == 0 and (c["kLDC"] // 4) % 32 == 20
    # rows * 4 and keys * 4 quant threads: whole warps
    assert rows * 4 % 32 == 0 and keys * 4 % 32 == 0
    regions = (c["kFmaOffK"], c["kFmaOffV"], c["kFmaOffE"], c["kFmaOffS"],
               c["kFmaOffC"], c["kFmaSmemBytes"])
    assert regions == (rows * row, (rows + keys) * row, (rows + 2 * keys) * row,
                       (rows + 2 * keys) * row + 16 * c["kFmaWarps"] * c["kLDE"] * 4,
                       c["kFmaOffS"] + (rows + keys) * 4,
                       c["kFmaOffC"] + (rows + keys) * c["kLDC"])
    assert all(r % 16 == 0 for r in regions)
    for smem, per_sm in ((c["kDqSmemBytes"], 2),
                         (c["kDkvSmemBytes"], 1), (c["kPFwdSmemBytes"], 3),
                         (c["kBwdFixedBytes"], 1), (c["kFmaSmemBytes"], 2)):
        assert smem <= _H100_SMEM_OPTIN
        assert per_sm * (smem + _BLOCK_RESERVED) <= _SM90_SMEM_PER_SM


@pytest.mark.parametrize("B,Lq,Lk,H,packed", [
    (128, 197, 214, 12, True),     # the 16 x 8 step (F32_PACKED_SHAPES)
    (280, 197, 276, 12, True),     # 4 clips x 70 frames
    (3, 13, 21, 2, True), (2, 65, 64, 3, True),
    (2, 640, 640, 4, True),        # the packed path's edge
    (15, 77, 77, 8, False),        # the text tower (F32_STREAM_SHAPES)
    (4, 1024, 1024, 8, False), (2, 130, 700, 2, False),
    (2, 100, 60, 2, False), (1, 1, 1, 1, False),
])
def test_attention_f32_plan_covers_every_row_head_and_tile(B, Lq, Lk, H,
                                                          packed):
    """Every shape chip_smoke checks. Streaming: the forward's and the dq
    kernel's grid cover every query row of every head and batch row in
    64-row tiles, the dk / dv kernel's every key; the scratch holds two
    floats a row. Packed: the forward's grid covers every query row in
    blocks of 64; the backward's one block per (batch row, head) holds the
    dq accumulator of Lq rounded up to 16 rows in shared memory, or (Lq 640)
    a grid of one block per SM walks the pairs with a global scratch of 74
    floats a padded row a block. The shared bytes are the layout's at any
    key length (640 included) and fit a block."""
    p = tfa.attention_f32_plan(B, Lq, Lk, H, packed=packed, sm_count=_H100_SMS)
    lay = tfa._F32_LAYOUT
    bwd_threads, fixed, per_row, max_smem, one_rows = lay[7:12]
    rows, threads, fwd = lay[4:7]
    tiles, heads, batch = p["fwd"]["grid"]
    assert tiles * rows >= Lq > (tiles - 1) * rows and (heads, batch) == (H, B)
    assert (p["fwd"]["threads"], p["fwd"]["smem_bytes"]) == (threads, fwd)
    if not packed:
        rows, threads, dq, dkdv = lay[:4]
        bwd = p["bwd"]
        kernels = []
        if bwd["form"] == "two_kernels":
            kernels += [("dq", bwd["dq"], Lq), ("dkdv", bwd["dkdv"], Lk)]
            assert (bwd["dq"]["smem_bytes"], bwd["dkdv"]["smem_bytes"]) == (
                dq, dkdv)
            assert bwd["scratch_floats"] == 2 * B * H * Lq
            assert bwd["launches"] == 2 and max(Lq, Lk) > one_rows
        else:
            assert max(Lq, Lk) <= one_rows and bwd["launches"] == 1
            assert (bwd["grid"], bwd["threads"], bwd["scratch_floats"]) == (
                B * H, bwd_threads, 0)
            assert bwd["lq_pad"] % 16 == 0 and 0 <= bwd["lq_pad"] - Lq < 16
            assert bwd["smem_bytes"] == fixed + 4 * bwd["lq_pad"] * per_row \
                <= max_smem
        for kernel, plan, L in kernels:
            tiles, heads, batch = plan["grid"]
            assert tiles * rows >= L > (tiles - 1) * rows
            assert (heads, batch) == (H, B)
            assert plan["threads"] == threads
        return
    bwd = p["bwd"]
    assert bwd["threads"] == bwd_threads
    assert bwd["lq_pad"] % 16 == 0 and 0 <= bwd["lq_pad"] - Lq < 16
    acc = bwd["lq_pad"] * per_row
    if Lq <= 240:
        assert (bwd["acc_in_smem"], bwd["grid"], bwd["scratch_floats"]) == (
            True, B * H, 0)
        assert bwd["smem_bytes"] == fixed + 4 * acc <= max_smem
    else:
        assert (bwd["acc_in_smem"], bwd["grid"]) == (False,
                                                     min(B * H, _H100_SMS))
        assert bwd["scratch_floats"] == bwd["grid"] * acc
        assert bwd["smem_bytes"] == fixed
    if (B, Lq) == (128, 197):
        assert (bwd["lq_pad"], bwd["smem_bytes"]) == (208, 219264)
    if Lq == 640:
        assert (bwd["lq_pad"], bwd["grid"], bwd["scratch_floats"]) == (
            640, 8, 8 * 640 * 74)
    fma_rows, fma_threads, fma_smem = lay[12:]
    blocks, heads, batch = p["fma_fwd"]["grid"]
    assert blocks * fma_rows >= Lq > (blocks - 1) * fma_rows
    assert (heads, batch) == (H, B)
    assert (p["fma_fwd"]["threads"], p["fma_fwd"]["smem_bytes"]) == (
        fma_threads, fma_smem)


@pytest.mark.parametrize("B,Lq,Lk,H", [
    (128, 197, 214, 12),     # the fp32 w8a8 evaluation (F32_B4_SHAPES)
    (3, 13, 21, 2), (2, 40, 100, 12), (128, 197, 197 + 17, 12),
    (16, 626, 643, 12),      # 400^2 frames: past the packed path's 640 keys
    (16, 785, 802, 12),      # 448^2 frames
])
def test_attention_f32_fma_fwd_plan_pads_queries_to_16_and_keys_to_8(
        B, Lq, Lk, H):
    """The w8a8 fusion's fp32 forward computes the query rows of its
    active warps (16 each; a warp past Lq only helps load) and the keys of
    each tile up to its last eighth with a real key: at the evaluation's
    (128, 197, 214, 12) 208 x 216 score entries a head, 1.066x the useful
    work (the FMA tiles' 64 x 64: 256 x 256, 1.555x); two blocks a head,
    3,072 blocks, about 11.6 waves of two blocks on an H100's 132 SMs."""
    c = _cuda_constants("attention_f32.cu")
    p = tfa.attention_fma_plan(B, Lq, Lk, H)
    if Lk <= 640:
        assert p == tfa.attention_f32_plan(B, Lq, Lk, H)["fma_fwd"]
    rows = p["grid"][0] * tfa._F32_LAYOUT[12]
    warps = -(-Lq // 16)
    keys = sum(8 * min(8, -(-(Lk - k0) // 8))
               for k0 in range(0, Lk, c["kFmaKeys"]))
    assert rows >= 16 * warps >= Lq > 16 * (warps - 1)
    assert Lk <= keys < Lk + 8
    if (B, Lq, Lk, H) == (128, 197, 214, 12):
        assert (16 * warps, keys) == (208, 216)
        assert abs(16 * warps * keys / (Lq * Lk) - 1.066) < 1e-3
        assert p["grid"] == (2, 12, 128)
        assert 11 < 2 * 12 * 128 / (2 * _H100_SMS) < 12


@pytest.mark.parametrize("Lk", [640, 641, 643, 802, 4096])
def test_attention_fma_plan_takes_any_key_length_the_packed_plan_640(Lk):
    """The fence is split: the w8a8 fusion's fp32 attention (B4 / B11 /
    B12) streams fixed key tiles, so its plan takes any key length with the
    same grid and shared bytes as at 214 keys, while the packed plan (B1 /
    B6a / B6b) still ends at 640 keys, where JAX switches to streaming."""
    p = tfa.attention_fma_plan(16, 626, Lk, 12)
    assert p == tfa.attention_fma_plan(16, 626, 214, 12)
    assert p["grid"] == (6, 12, 16)
    if Lk <= 640:
        assert tfa.attention_f32_plan(16, 626, Lk, 12)["fma_fwd"] == p
    else:
        with pytest.raises(ValueError, match="packed path ends at 640"):
            tfa.attention_f32_plan(16, 626, Lk, 12)
        assert tfa.attention_f32_plan(16, 626, Lk, 12, packed=False)["fwd"]


@pytest.mark.parametrize("B,Lq,Lk,H,form", [
    (15, 77, 77, 8, "one_launch"),     # the text tower
    (2, 100, 60, 2, "one_launch"), (3, 13, 21, 2, "one_launch"),
    (1, 128, 128, 1, "one_launch"),    # one key tile's edge
    (4, 1024, 1024, 8, "two_kernels"), (2, 130, 700, 2, "two_kernels"),
    (1, 129, 128, 1, "two_kernels"), (1, 128, 129, 1, "two_kernels"),
])
def test_attention_f32_stream_bwd_form(B, Lq, Lk, H, form):
    """B7's fp32 backward takes one launch (a block per batch row and head)
    while both lengths fit one key tile of its kernel, as the bf16 form's
    `streaming_bwd_plan`, else the dq and dk / dv kernels; chip_smoke's
    F32_STREAM_SHAPES take the forms its f32-kernel phase expects. The
    text tower's 120 blocks are one wave of an H100's 132 SMs, its shared
    bytes those of 80 padded rows."""
    bwd = tfa.attention_f32_plan(B, Lq, Lk, H, packed=False)["bwd"]
    assert bwd["form"] == form
    assert bwd["form"] == tfa.streaming_bwd_plan(B, Lq, Lk, H)["form"]
    if (B, Lq, H) == (15, 77, 8):
        assert bwd["grid"] == 120 <= _H100_SMS
        assert (bwd["lq_pad"], bwd["smem_bytes"]) == (80, 157696 + 80 * 74 * 4)
    forms = {shape[:4]: tfa.attention_f32_plan(*shape[:4], packed=False)[
        "bwd"]["form"] for shape in chip_smoke.F32_STREAM_SHAPES}
    assert forms == {shape[:4]: "one_launch" if max(shape[1:3]) <= 128
                     else "two_kernels"
                     for shape in chip_smoke.F32_STREAM_SHAPES}


@pytest.mark.parametrize("B,Lq,Lk,H,blocks,waves", [
    (15, 77, 77, 8, 240, 1),       # the text tower (F32_STREAM_SHAPES)
    (4, 1024, 1024, 8, 512, 2),    # the long causal shape
])
def test_attention_f32_stream_fwd_is_the_packed_forward(B, Lq, Lk, H, blocks,
                                                        waves):
    """B7's fp32 forward at every length is the 3xTF32 packed forward's
    kernel in its streaming form: the packed plan's grid of 64-row blocks,
    threads and shared bytes. Its shared bytes allow three blocks to an SM.
    At the streaming form's two blocks an SM, the text tower's 240 blocks
    are one wave of an H100's 132 SMs and the long causal shape's 512
    two."""
    c = _cuda_constants("attention_f32.cu")
    fwd = tfa.attention_f32_plan(B, Lq, Lk, H, packed=False)["fwd"]
    assert fwd == tfa.attention_f32_plan(B, Lq, min(Lk, 640), H)["fwd"]
    tiles, heads, batch = fwd["grid"]
    assert (tiles * heads * batch, fwd["threads"], fwd["smem_bytes"]) == (
        blocks, c["kFwdThreads"], c["kPFwdSmemBytes"])
    assert _SM90_SMEM_PER_SM // (c["kPFwdSmemBytes"] + _BLOCK_RESERVED) == 3
    assert -(-blocks // (2 * _H100_SMS)) == waves


@pytest.mark.parametrize("args,kw", [
    ((2, 13, 21, 2, 32), {}),                  # head dim 32
    ((0, 13, 21, 2), {}), ((2, 0, 21, 2), {}), ((2, 13, 0, 2), {}),
    ((2, 13, 21, 0), {}),
    ((2, 13, 641, 2), {}),                     # past the packed path
    ((70000, 13, 21, 2), {"packed": False}),   # past a grid's z
])
def test_attention_f32_plan_raises_for_shapes_it_cannot_take(args, kw):
    with pytest.raises(ValueError):
        tfa.attention_f32_plan(*args, **kw)


def test_attention_f32_layout_check_before_first_launch():
    fn, want = "attention_f32_layout", tfa._F32_LAYOUT
    tfa._bwd_layout_checked.discard("fake_f32")
    tfa._check_layout("fake_f32", _FakeLayoutLib(fn, want), fn, want)
    tfa._bwd_layout_checked.discard("fake_f32")
    bad = want[:2] + (want[2] + 16,) + want[3:]
    with pytest.raises(RuntimeError, match="layout"):
        tfa._check_layout("fake_f32", _FakeLayoutLib(fn, bad), fn, want)
    tfa._bwd_layout_checked.discard("fake_f32")


def test_w8_f32_tile_is_the_w8_kernel_layout_s():
    """B9's fp32 form reads the bf16 form's weight leaf: a block's columns
    are one tile of the w8 kernel layout (128 x 64, 8,192 bytes) and its k
    step half of one (four k8 steps of wgmma m64n128k8), two product
    warpgroups of 64 x 128 outputs (64 a thread) and a converter
    warpgroup; the raw x rows are padded to 16-byte multiples, 4 floats past
    a multiple of 32 so that a warp's fragment loads fall in 32 banks; w's
    hi and lo planes (two sets), three raw stages of x and of the half
    weight tile fit one block to an SM, whose 384 threads leave each 168
    registers."""
    c = _cuda_constants("w8_matmul_f32.cu")
    assert (c["kBN"], c["kWTileK"]) == (tim._W8_TILE_N, tim._W8_TILE_K)
    assert c["kWTileBytes"] == tim._W8_TILE_N * tim._W8_TILE_K == 8192
    assert 2 * c["kBK"] == c["kWTileK"] and c["kBK"] % 8 == 0
    assert c["kWStepBytes"] * 2 == c["kWTileBytes"]
    assert c["kMmaThreads"] == 2 * 128 and c["kCvtThreads"] == 128
    assert c["kThreads"] == c["kMmaThreads"] + c["kCvtThreads"]
    assert c["kMmaThreads"] * c["kAcc"] == c["kBM"] * c["kBN"]
    assert c["kCvtChunks"] * c["kCvtThreads"] * 16 == c["kWStepBytes"]
    assert c["kLDP"] * 4 % 16 == 0 and c["kLDP"] % 32 == 4
    assert c["kWPlaneFloats"] == c["kBN"] * c["kBK"] and c["kCoreBytes"] == 128
    assert c["kSmemBytes"] == (4 * c["kWPlaneFloats"]
                               + c["kStages"] * c["kBM"] * c["kLDP"]) * 4 \
        + c["kStages"] * c["kWStepBytes"]
    assert c["kSmemBytes"] <= _H100_SMEM_OPTIN
    assert c["kSmemBytes"] + _BLOCK_RESERVED <= _SM90_SMEM_PER_SM
    assert 65536 // c["kThreads"] >= 168


# ---------------------------------------------------------------------------
# the C entry points and their ctypes signatures (ops/_cuda._SIGNATURES)
# ---------------------------------------------------------------------------

def _with_includes(fname, seen):
    """The source of csrc/<fname> and of every csrc header it includes."""
    if fname in seen or not (_CSRC / fname).is_file():
        return ""
    seen.add(fname)
    src = (_CSRC / fname).read_text()
    return src + "".join(_with_includes(h, seen) for h in
                         re.findall(r'#include "([\w.]+)"', src))


def _c_entries(name):
    """{entry: number of parameters} of the `extern "C"` functions that
    csrc/<name>.cu and the headers it includes define."""
    src = _with_includes(f"{name}.cu", set())
    out = {}
    for m in re.finditer(r'extern "C" [\w\s\*]*?\b(\w+)\(([^)]*)\)\s*\{', src):
        params = [p for p in m.group(2).split(",") if p.strip()]
        out[m.group(1)] = len(params)
    return out


@pytest.mark.parametrize("name", sorted(_cuda._SIGNATURES))
def test_every_c_entry_has_its_ctypes_signature(name):
    """Every entry a kernel library exports is bound with argtypes of its
    own parameter count: an entry without them would take its pointers as
    32-bit ints on the card."""
    entries = _c_entries(name)
    sigs = _cuda._SIGNATURES[name]
    for fn, n in entries.items():
        if fn == "cuda_error_string" and fn not in sigs:
            continue
        assert fn in sigs, (name, fn)
        assert len(sigs[fn][0]) == n, (name, fn, len(sigs[fn][0]), n)
    assert set(sigs) <= set(entries) | {"cuda_error_string"}
