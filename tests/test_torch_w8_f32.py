"""The float32 weight-only int8 GEMM (csrc/w8_matmul_f32.cu, B9's fp32
form: 3xTF32 mma.sync on pre-split tiles) run on the CPU: the CUDA source
compiled with g++ against the emulation of tests/test_torch_attention_f32.py
(one std::thread per CUDA thread, mma.sync m16n8k8 TF32 with the tensor
core's operand cut and truncated sum, cp.async a copy, shared memory filled
with NaN before each launch) and called through the same C entry point and
ctypes signature as on the card. Held against the plain version at ragged
shapes within chip_smoke's W8_F32_REL of sum |x| |w| for each output, with
the weight in the w8 kernel layout that the bf16 form reads
(`with_kernel_layout`), and once directly against the JAX Pallas kernel in
interpret mode; its two mutants of utils/kernel_mutants.py (1xTF32, and
the hi_x lo_w product dropped) fail that limit.

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


def _inputs(M, K, N, seed):
    """x (M, K) fp32 and a quantized weight with heavy-tailed rows, as
    CLIP's: x, q, scale."""
    rs = np.random.RandomState(seed)
    x = torch.from_numpy(rs.randn(M, K).astype(np.float32))
    w = rs.randn(K, N) * K ** -0.5
    w[rs.choice(K, max(1, K // 50), replace=False)] *= 16
    q, scale = quantize_weight(torch.from_numpy(w))
    return x, q, scale


def _kernel(lib, x, q, scale):
    """y through the entry, x copied zero-padded to a multiple of 4
    columns, as the wrapper does."""
    M, K = x.shape
    N = q.shape[1]
    leaf = tim.with_kernel_layout({"q": q, "scale": scale})
    xp = torch.zeros(M, K + -K % 4)
    xp[:, :K] = x
    y = torch.full((M, N), float("nan"))
    P = torch.Tensor.data_ptr
    assert lib.w8_matmul_f32(P(xp), P(leaf["q_t"]),
                             P(scale.reshape(-1).float().contiguous()), P(y),
                             M, xp.shape[1], N, None) == 0
    return y


def _spread(x, q, scale):
    """|x| @ |w| of each output: the scale of W8_F32_REL."""
    return x.abs() @ tim.dequant_weight(q, scale, torch.float32).abs()


def _run(lib, M, K, N, seed=0):
    """The kernel at one shape: max over the outputs of |y - plain| / (|x|
    @ |w|)."""
    x, q, scale = _inputs(M, K, N, seed)
    y = _kernel(lib, x, q, scale)
    ref = tim.int8_matmul_plain(x, q, scale)
    return ((y - ref).abs() / _spread(x, q, scale)).max().item()


# (M, K, N): K no multiple of 4 (padded) nor of 32, two row tiles and
# three column tiles with ragged edges and k steps in both halves of the
# last weight tile, one weight tile, one output
_SHAPES = [(37, 101, 33), (130, 200, 260), (5, 64, 128), (1, 3, 1)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_w8_f32_kernel_matches_plain_version(emu, shape):
    err = _run(emu[1], *shape)
    assert err <= chip_smoke.W8_F32_REL, err


def _mutant_worst(tmp, name):
    """The largest error of mutant `name` over the first three shapes."""
    path, edits, _, _ = kernel_mutants.MUTANTS[name]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, name, src, "w8_matmul_f32")
    return max(_run(lib, *shape) for shape in _SHAPES[:3])


def test_w8_f32_tf32_mutant_fails_the_limit(emu):
    """Every product as one TF32 product (both lo products dropped)."""
    worst = _mutant_worst(emu[0], "f32b9_products_tf32")
    assert worst > chip_smoke.W8_F32_REL, worst


def test_w8_f32_split_mutant_fails_the_limit(emu):
    """The hi_x lo_w product dropped: the weight's lo part never enters."""
    worst = _mutant_worst(emu[0], "f32b9_hi_x_lo_w_dropped")
    assert worst > chip_smoke.W8_F32_REL, worst


def test_w8_f32_kernel_matches_jax_kernel(emu):
    """The emulated kernel held directly against the JAX Pallas kernel
    (`int8_matmul` runs in interpret mode off the TPU) on the same x and
    int8 weight: both dequantize each weight with one fp32 product and sum
    in fp32 in other orders (the kernel's products 3xTF32, within 2^-20 of
    each), so within W8_F32_REL of sum |x| |w|, as against the plain
    version."""
    import jax.numpy as jnp
    from gava_clip_tpu.ops import int8_matmul as jim
    x, q, scale = _inputs(37, 101, 33, 3)
    y = _kernel(emu[1], x, q, scale)
    want = torch.from_numpy(np.array(jim.int8_matmul(
        jnp.asarray(x.numpy()), jnp.asarray(q.numpy()),
        jnp.asarray(scale.reshape(1, -1).float().numpy()))))
    err = ((y - want).abs() / _spread(x, q, scale)).max().item()
    assert err <= chip_smoke.W8_F32_REL, err


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
