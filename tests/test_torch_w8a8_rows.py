"""The row quant of the w8a8 kernels (csrc/w8a8_common.cuh `quant_row_to`,
and through it `quant_row_long` / `quant_row_long8`) run on the CPU: the
header compiled with g++ against the CUDA emulation of
tests/test_torch_attention_f32.py (one std::thread per CUDA thread, the
warp's shuffles through a block-wide buffer) plus the few intrinsics the
header adds (`__fmul_rn` and its kin as single fp32 operations, bf16 as
its bit pattern), called through a small kernel, one warp a row.

The rows are fp32 (the load this slice adds: 4 values a 16-byte load) and
bf16 (the load of before), at the row lengths that pick each path: K 768
and 100 (the vector load; 100 % 8 == 4 ends in a half chunk in fp32), 13
at an unaligned address (a value a load), 1,100 and 2,048 (rows held in
passes: `quant_row_long8` without a LayerNorm, `quant_row_long` with one).
Without a LayerNorm the codes and row scales equal `quant_rows` bit for
bit (a max and one rounding a value, in any order). With one they equal
`quant_rows(ln_f32(...))` up to the LayerNorm's order of sums (a warp
butterfly there, torch's reduction here): the row scales within a few fp32
ulp, and a code off by one only where its value sits that close to a
rounding tie.
"""

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import int8_matmul as tim

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_attention_f32 import _EMU_HEADER  # noqa: E402

# What w8a8_common.cuh uses beyond the emulation of the attention kernels:
# bf16 as its 16 bits (round to nearest even), the vector types, and the
# _rn intrinsics as one fp32 operation each (g++ contracts nothing into an
# FMA for x86-64 without -mfma); rsqrtf as 1 / sqrtf (the card's is an
# approximation of a few ulp: the LayerNorm comparison allows for it).
_EXTRA = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __host__
#define __noinline__ __attribute__((noinline))
#define __restrict__
struct uint2 { unsigned x, y; };
struct uint4 { unsigned x, y, z, w; };
inline uint2 make_uint2(unsigned a, unsigned b) { return {a, b}; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __float2int_rn(float x) { return static_cast<int>(std::nearbyint(x)); }
inline float __int2float_rn(int x) { return static_cast<float>(x); }
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
"""

_BF16 = r"""
#pragma once
#include <cstdint>
#include <cstring>
struct __nv_bfloat16 { unsigned short bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const unsigned u = static_cast<unsigned>(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<unsigned short>(u >> 16)};
}
"""

# one warp a row: row `blockIdx.x` of x (K values from x + row * ld) ->
# Kp codes and its scale
_KERNEL_SRC = r"""
#include "cuda_runtime.h"
#include "w8a8_emu.h"
#include "w8a8_common.cuh"

template <class T>
struct Args {
  const T* x;
  const float* gamma;
  const float* beta;
  int8_t* codes;
  float* xs;
  int ld, K, Kp;
};

template <class T>
__global__ void quant_rows_kernel(const Args<T>& a) {
  const int row = blockIdx.x, lane = threadIdx.x;
  int8_t* out = a.codes + static_cast<long long>(row) * a.Kp;
  auto store = [out](int c, int8_t code) { out[c] = code; };
  auto store8 = [out](int c0, uint2 q) { std::memcpy(out + c0, &q, 8); };
  const float v = w8a8::quant_row_to(a.x + static_cast<long long>(row) * a.ld, a.K, a.gamma,
                                     a.beta, a.Kp, store, store8, lane);
  if (lane == 0) a.xs[row] = v;
}

template <class T>
int run(const void* x, const void* gamma, const void* beta, void* codes, void* xs, int M, int ld,
        int K, int Kp) {
  const Args<T> a{static_cast<const T*>(x), static_cast<const float*>(gamma),
                  static_cast<const float*>(beta), static_cast<int8_t*>(codes),
                  static_cast<float*>(xs), ld, K, Kp};
  emu_launch(quant_rows_kernel<T>, dim3(M), 32, 0, a);
  return 0;
}

extern "C" int quant_rows_f32(const void* x, const void* gamma, const void* beta, void* codes,
                              void* xs, int M, int ld, int K, int Kp) {
  return run<float>(x, gamma, beta, codes, xs, M, ld, K, Kp);
}

extern "C" int quant_rows_bf16(const void* x, const void* gamma, const void* beta, void* codes,
                               void* xs, int M, int ld, int K, int Kp) {
  return run<__nv_bfloat16>(x, gamma, beta, codes, xs, M, ld, K, Kp);
}
"""

_SIG = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulation")
    tmp = tmp_path_factory.mktemp("w8a8_rows_emu")
    (tmp / "cuda_runtime.h").write_text(_EMU_HEADER)
    (tmp / "cuda_bf16.h").write_text(_BF16)
    (tmp / "w8a8_emu.h").write_text(_EXTRA)
    (tmp / "rows.cpp").write_text(_KERNEL_SRC)
    so = tmp / "librows.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared",
                    "-fPIC", "-Wno-unknown-pragmas", "-I", str(tmp), "-I",
                    str(_cuda.CSRC), "-o", str(so), str(tmp / "rows.cpp")],
                   check=True, capture_output=True)
    out = ctypes.CDLL(str(so))
    for fn in ("quant_rows_f32", "quant_rows_bf16"):
        getattr(out, fn).argtypes = _SIG
        getattr(out, fn).restype = ctypes.c_int
    return out


def _rows(dtype, M, K, unaligned, seed):
    """M rows of K values with a heavy channel or two, drawn with numpy, and
    the tensor the kernel reads: at a 4-byte offset from a 16-byte aligned
    start when `unaligned`."""
    rs = np.random.RandomState(seed)
    x = rs.randn(M, K).astype(np.float32)
    x[:, rs.randint(0, K, size=2)] *= 6.0
    t = torch.from_numpy(x).to(dtype)
    if not unaligned:
        return t
    base = torch.zeros(M * K + 8, dtype=dtype)
    shift = next(s for s in range(1, 8)
                 if (base[s:].data_ptr() % 16) != 0)
    view = base[shift:shift + M * K].view(M, K)
    view.copy_(t)
    return view


def _run(lib, x, ln):
    M, K = x.shape
    Kp = -(-K // 128) * 128
    codes = torch.full((M, Kp), 99, dtype=torch.int8)
    xs = torch.zeros(M)
    g, b = (None, None) if ln is None else ln
    fn = lib.quant_rows_f32 if x.dtype == torch.float32 \
        else lib.quant_rows_bf16
    assert fn(x.data_ptr(), None if g is None else g.data_ptr(),
              None if b is None else b.data_ptr(), codes.data_ptr(),
              xs.data_ptr(), M, x.stride(0), K, Kp) == 0
    return codes, xs


# (K, unaligned): the vector load (768, and 100: a half chunk in fp32), a
# value a load (13 unaligned), rows held in passes (1,100: a half chunk in
# fp32; 2,048)
_CASES = [(768, False), (100, False), (13, True), (1100, False),
          (2048, False)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,unaligned", _CASES)
def test_row_quant_equals_quant_rows(lib, dtype, K, unaligned):
    """No LayerNorm: the codes (zero from K to Kp) and row scales are those
    of `quant_rows` bit for bit."""
    x = _rows(dtype, 5, K, unaligned, seed=K)
    codes, xs = _run(lib, x, None)
    want, xs_want = tim.quant_rows(x.float())
    assert torch.equal(xs, xs_want[:, 0])
    assert torch.equal(codes[:, :K].float(), want)
    assert not codes[:, K:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("K,unaligned", _CASES)
def test_row_quant_with_layernorm_matches_ln_f32(lib, dtype, K, unaligned):
    """With the LayerNorm: against `quant_rows(ln_f32(x))`, the row scales
    within 2^-20 relative (the sums in another order move the normalised
    values by a few fp32 ulp), every code within one, and a code off by
    one only where the plain value, times 1 / xs, lies within 2^-12 of a
    rounding tie (a few ulp of values up to 127); zero codes past K."""
    rs = np.random.RandomState(K + 1)
    g = torch.from_numpy((1.0 + 0.5 * rs.randn(K)).astype(np.float32))
    b = torch.from_numpy((0.05 * rs.randn(K)).astype(np.float32))
    x = _rows(dtype, 5, K, unaligned, seed=K + 2)
    codes, xs = _run(lib, x, (g, b))
    n = tim.ln_f32(x.float(), g, b)
    want, xs_want = tim.quant_rows(n)
    assert ((xs - xs_want[:, 0]).abs() / xs_want[:, 0]).max() <= 2.0 ** -20
    diff = (codes[:, :K].float() - want).abs()
    assert diff.max() <= 1
    scaled = n * torch.reciprocal(xs_want)
    tie = (scaled - scaled.floor() - 0.5).abs()
    assert bool((tie[diff > 0] <= 2.0 ** -12).all())
    assert not codes[:, K:].any()
