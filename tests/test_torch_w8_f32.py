"""The float32 weight-only int8 GEMM (csrc/w8_matmul_f32.cu, B9's fp32
form) run on the CPU: the CUDA source compiled with g++ against the
emulation of tests/test_torch_attention_f32.py (one std::thread per CUDA
thread, shared memory filled with NaN before each launch) and called
through the same C entry point and ctypes signature as on the card. Held
against the plain version at ragged shapes within chip_smoke's
W8_F32_REL of sum |x| |w| for each output, with the weight in the w8
kernel layout that the bf16 form reads (`with_kernel_layout`); the TF32
mutant of utils/kernel_mutants.py fails that limit.

Also the dtype rule of `int8_matmul_cuda`: bf16 and fp32 rows reach the
wrapper's CUDA check, fp16 raises TypeError and counts no launch.
"""

import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import int8_matmul as tim
from gava_clip_tpu_torch.ops.quant import quantize_weight
from gava_clip_tpu_torch.utils import kernel_mutants

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_attention_f32 import _build  # noqa: E402
from tests.test_torch_bounds import module_deadline  # noqa: F401

_SOURCE = _cuda.CSRC / "w8_matmul_f32.cu"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulation")
    tmp = tmp_path_factory.mktemp("w8_matmul_f32_emu")
    return tmp, _build(tmp, "kernel", _SOURCE.read_text(), "w8_matmul_f32")


def _run(lib, M, K, N, seed=0):
    """The kernel at one shape: max over the outputs of |y - plain| / (|x|
    @ |w|). x is copied zero-padded to a multiple of 4 columns, as the
    wrapper does; the weight has heavy-tailed rows, as CLIP's."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32))
    w = rs.randn(K, N) * K ** -0.5
    w[rs.choice(K, max(1, K // 50), replace=False)] *= 16
    q, scale = quantize_weight(torch.from_numpy(w))
    leaf = tim.with_kernel_layout({"q": q, "scale": scale})
    xp = torch.zeros(M, K + -K % 4)
    xp[:, :K] = x
    y = torch.full((M, N), float("nan"))
    P = torch.Tensor.data_ptr
    assert lib.w8_matmul_f32(P(xp), P(leaf["q_t"]),
                             P(scale.reshape(-1).float().contiguous()), P(y),
                             M, xp.shape[1], N, None) == 0
    ref = tim.int8_matmul_plain(x, q, scale)
    wd = tim.dequant_weight(q, scale, torch.float32)
    return ((y - ref).abs() / (x.abs() @ wd.abs())).max().item()


# (M, K, N): K no multiple of 4 (padded) nor of 64, two row tiles and
# three column tiles with ragged edges, one weight tile, one output
_SHAPES = [(37, 101, 33), (130, 200, 260), (5, 64, 128), (1, 3, 1)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_w8_f32_kernel_matches_plain_version(emu, shape):
    err = _run(emu[1], *shape)
    assert err <= chip_smoke.W8_F32_REL, err


def test_w8_f32_tf32_mutant_fails_the_limit(emu):
    tmp, _ = emu
    path, edits, _, _ = kernel_mutants.MUTANTS["f32b9_products_tf32"]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, "f32b9_products_tf32", src, "w8_matmul_f32")
    worst = max(_run(lib, *shape) for shape in _SHAPES[:3])
    assert worst > chip_smoke.W8_F32_REL, worst


def test_w8_f32_entry_refuses_what_it_cannot_load(emu):
    """K no multiple of 4 and unaligned rows return cudaErrorInvalidValue
    (the wrapper pads such rows first)."""
    lib = emu[1]
    x = torch.zeros(4, 12)
    leaf = tim.with_kernel_layout({"q": torch.zeros(12, 8, dtype=torch.int8),
                                   "scale": torch.ones(1, 8)})
    y = torch.empty(4, 8)
    P = torch.Tensor.data_ptr
    args = (P(leaf["q_t"]), P(leaf["scale"]), P(y))
    assert lib.w8_matmul_f32(P(x), *args, 4, 10, 8, None) == 1
    assert lib.w8_matmul_f32(P(x) + 4, *args, 4, 8, 8, None) == 1
    assert lib.w8_matmul_f32(P(x), *args, 4, 12, 8, None) == 0


def test_int8_matmul_cuda_takes_bf16_or_fp32_rows():
    leaf = tim.with_kernel_layout({"q": torch.zeros(16, 8, dtype=torch.int8),
                                   "scale": torch.ones(1, 8)})
    tim.reset_launch_counts()
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA"):
            tim.int8_matmul_cuda(torch.zeros(4, 16, dtype=dtype), leaf)
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(TypeError, match="all bfloat16 or all float32"):
            tim.int8_matmul_cuda(torch.zeros(4, 16, dtype=dtype), leaf)
    assert set(tim.launch_counts.values()) == {0}
