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

from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import flash_attention as tfa
from gava_clip_tpu_torch.ops import int8_matmul as tim

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


def _qkv_smem(rows, K, stages):
    """The kernel's count (w8a8_qkv.cu smem_bytes): slack, the code tile,
    the two rings, the row scales."""
    slab = tim._QKV_LAYOUT[0]
    return 1024 + rows * (-(-K // 128) * 128) + 2 * stages * slab + 4 * rows


@pytest.mark.parametrize("M,K,N,rows,grid,per_sm,stages", [
    (128 * 214, 768, 768, 128, (214, 1), 1, 8),   # the serving shape (B3)
    (128 * 197, 768, 768, 128, (197, 1), 1, 8),   # no extras rows
    (3 * 18, 96, 40, 32, (2, 3), 2, 6),           # chip_smoke's ragged shapes
    (4 * 21, 768, 768, 32, (3, 18), 2, 5),
    (2 * 9, 64, 19, 32, (1, 3), 2, 6),
    (1155, 512, 512, 32, (37, 4), 2, 5),          # B3a: the text tower
    (100, 3456, 768, 32, (4, 18), 1, 7),          # the longest rows of before
])
def test_w8a8_qkv_plan_at_checked_shapes(M, K, N, rows, grid, per_sm,
                                         stages):
    """Every shape chip_smoke checks (W8A8_QKV_SHAPES and B3a's) gets a
    plan whose shared bytes are the kernel's count and fit a block (and
    two where two share an SM); the grid covers every row and every unit
    exactly once."""
    p = tim.w8a8_qkv_plan(M, K, N, _H100_SMS, _H100_SMEM_OPTIN)
    assert (p["rows"], p["grid"], p["per_sm"], p["stages"]) == \
        (rows, grid, per_sm, stages)
    tiles, split = p["grid"]
    assert tiles * p["rows"] >= M > (tiles - 1) * p["rows"]
    assert p["units"] * split == 3 * -(-N // 128)
    assert p["blocks"] == tiles * split
    assert 3 <= p["stages"] <= tim._QKV_LAYOUT[1]
    assert p["smem_bytes"] == _qkv_smem(p["rows"], K, p["stages"])
    assert p["smem_bytes"] + tim._QKV_LAYOUT[3] <= _H100_SMEM_OPTIN
    assert p["per_sm"] * (p["smem_bytes"] + tim._QKV_LAYOUT[3] + 1024) \
        <= tim._SM90_SMEM_PER_SM


def test_w8a8_qkv_plan_fills_the_card_at_the_text_shape():
    """B3a's 1,155 rows: 37 tiles of 32 rows; the units are shared out until
    every SM has a block (148 blocks, two to an SM: one wave)."""
    p = tim.w8a8_qkv_plan(1155, 512, 512, _H100_SMS, _H100_SMEM_OPTIN)
    assert _H100_SMS <= p["blocks"] <= p["per_sm"] * _H100_SMS


@pytest.mark.parametrize("K", [16, 100, 768, 1024, 1100, 2048, 3456, 5632])
def test_w8a8_qkv_plan_fits_every_admitted_row_length(K):
    for M in (1, 64, 1155, 27392, 100000):
        p = tim.w8a8_qkv_plan(M, K, 768, _H100_SMS, _H100_SMEM_OPTIN)
        assert p["rows"] in tim._QKV_ROWS
        assert p["smem_bytes"] + tim._QKV_LAYOUT[3] <= _H100_SMEM_OPTIN


@pytest.mark.parametrize("args", [
    (37, 5760, 768, _H100_SMS, _H100_SMEM_OPTIN),   # rows too long
    (37, 768, 768, _H100_SMS, 48 * 1024),           # a small card
    (0, 768, 768, _H100_SMS, _H100_SMEM_OPTIN),
])
def test_w8a8_qkv_plan_raises_for_shapes_it_cannot_take(args):
    with pytest.raises(ValueError):
        tim.w8a8_qkv_plan(*args)


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
    """The plan's constants are the ones attention_f32_layout reports: 64-row
    tiles padded to 68 floats, 256 threads, and each kernel's shared bytes
    as its tiles and row floats add up; every kernel fits one block's
    limit, the forward three blocks to an SM and the dq kernel two."""
    c = _cuda_constants("attention_f32.cu")
    assert tfa._F32_LAYOUT == (c["kT"], c["kThreads"], c["kFwdSmemBytes"],
                               c["kDqSmemBytes"], c["kDkvSmemBytes"])
    tile = c["kHD"] * c["kLD"] * 4
    assert c["kHD"] == tfa._KERNEL_HEAD_DIM == c["kT"]
    assert c["kLD"] * 4 % 16 == 0                  # float4 rows
    assert c["kThreads"] == (c["kT"] // 4) ** 2     # a 4 x 4 patch a thread
    assert (c["kFwdSmemBytes"], c["kDqSmemBytes"], c["kDkvSmemBytes"]) == (
        4 * tile, 6 * tile + 2 * c["kT"] * 4, 8 * tile + 2 * c["kT"] * 4)
    for smem, per_sm in ((c["kFwdSmemBytes"], 3), (c["kDqSmemBytes"], 2),
                         (c["kDkvSmemBytes"], 1)):
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
    """Every shape chip_smoke checks: the forward's and the dq kernel's grid
    cover every query row of every head and batch row in 64-row tiles, the
    dk / dv kernel's every key; the scratch holds two floats a row; the
    shared bytes are the layout's at any key length (640 included)."""
    p = tfa.attention_f32_plan(B, Lq, Lk, H, packed=packed)
    rows, threads, fwd, dq, dkdv = tfa._F32_LAYOUT
    for kernel, L in (("fwd", Lq), ("dq", Lq), ("dkdv", Lk)):
        tiles, heads, batch = p[kernel]["grid"]
        assert tiles * rows >= L > (tiles - 1) * rows
        assert (heads, batch) == (H, B)
    assert (p["fwd"]["smem_bytes"], p["dq"]["smem_bytes"],
            p["dkdv"]["smem_bytes"]) == (fwd, dq, dkdv)
    assert p["threads"] == threads and p["scratch_floats"] == 2 * B * H * Lq


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
