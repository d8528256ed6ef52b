"""The launch plan of the fused w8a8 MLP (csrc/w8a8_mlp.cu) and the
host-side weight padding its TMA loads need: pure host arithmetic, checked
on the CPU at the serving, text and ragged shapes."""

import pytest
import torch

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
