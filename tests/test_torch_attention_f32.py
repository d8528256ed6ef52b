"""The float32 attention kernels (csrc/attention_f32.cu) run on the CPU:
the CUDA source compiled with g++ against a small emulation of the CUDA
features it uses (one std::thread per CUDA thread, a block's threads
meeting at a std::barrier, warp shuffles through a block-wide buffer,
shared memory filled with NaN before each launch) and called through the
same C entry points and ctypes signatures as on the card. Held against the
plain versions at small ragged shapes with chip_smoke's fp32 limit, with
their fp32 mutants (utils/kernel_mutants.py) rejected by the same limit.
ex2.approx becomes exp2f here, so this checks the kernels' indexing,
masking, tiling and summation, not the card's instructions.

The same for the forms the w8a8 serving fusion's fp32 path adds: the
int8-score form (B11), whose codes and exp2 arguments (the check entry
`attention_f32_qk8_args`) equal the plain version's bit for bit on random
rows and on rows whose values sit on the codes' rounding ties, and the
two-source form (B12), equal bit for bit to the one-source forms on the
concatenated keys; their mutants fail those checks.

Also the dtype rules of the attention wrappers: q/k/v all bfloat16 or all
float32 (every form, B11 and B12 included, takes both), fp16 or mixed
raise TypeError.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from gava_clip_tpu_torch.ops import _cuda
from gava_clip_tpu_torch.ops import flash_attention as tfa
from gava_clip_tpu_torch.utils import kernel_mutants
from tests.test_torch_bounds import module_deadline  # noqa: F401

# chip_smoke.F32_REL: fp32 summation order and exp2, ~1e-6 of the scale; a
# TF32 product ~1e-3
F32_REL = 2.0 ** -14

_EMU_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __align__(n)
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 { unsigned x, y, z; };
inline thread_local uint3 threadIdx;
inline uint3 blockIdx, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::vector<float> g_smem_buf, g_shfl(1024);
inline float* g_smem = nullptr;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F> cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float x, int off) {
  g_shfl[threadIdx.x] = x;
  __syncthreads();
  float y = g_shfl[threadIdx.x ^ off];
  __syncthreads();
  return y;
}
inline float __uint_as_float(unsigned x) { float f; std::memcpy(&f, &x, 4); return f; }
inline unsigned __float_as_uint(float f) { unsigned x; std::memcpy(&x, &f, 4); return x; }
inline int min(int a, int b) { return a < b ? a : b; }
template <class K, class A>
void emu_launch(K k, dim3 grid, int threads, int smem_bytes, const A& a) {
  gridDim = {grid.x, grid.y, grid.z};
  g_smem_buf.assign(smem_bytes / 4, std::nanf(""));
  g_smem = g_smem_buf.data();
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = {x, y, z};
        std::barrier<> bar(threads);
        g_bar = &bar;
        std::vector<std::thread> ts;
        for (int t = 0; t < threads; ++t)
          ts.emplace_back([&, t] { threadIdx = {unsigned(t), 0, 0}; k(a); });
        for (auto& th : ts) th.join();
      }
}
"""


def _split_top(text):
    out, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<"
        depth -= ch in ")>"
        if ch == "," and depth == 0:
            out.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return out + [cur.strip()]


def _emulated(src: str) -> str:
    """The CUDA source as C++ for the emulation header: dynamic shared
    memory from the launch's buffer, exp2f for ex2.approx, each
    `kernel<<<grid, threads, smem, stream>>>(args)` an emu_launch."""
    src = src.replace("extern __shared__ __align__(16) float smem[];",
                      "float* smem = g_smem;")
    src = src.replace('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : '
                      '"f"(x));', "y = exp2f(x);")
    while "<<<" in src:
        i = src.index("<<<")
        j = src.index(">>>", i)
        start = max(src.rfind(c, 0, i) for c in ";{}") + 1
        grid, threads, smem, _ = _split_top(src[i + 3:j])
        m = re.match(r"\((\w+)\)", src[j + 3:])
        src = (src[:start] + f"\n  emu_launch({src[start:i].strip()}, {grid}, "
               f"{threads}, {smem}, {m.group(1)})" + src[j + 3 + m.end():])
    assert "asm(" not in src and "__shared__" not in src
    return src


# What the int8-score form (and csrc/w8_matmul_f32.cu) uses beyond the
# header: the _rn intrinsics as one fp32 operation each (g++ contracts
# nothing into an FMA for x86-64 without -mfma), the 16-byte integer vector.
# Kept out of _EMU_HEADER, which tests/test_torch_w8a8_rows.py extends with
# its own definitions of these.
_EMU_EXTRA = r"""
#include "cuda_runtime.h"
#define __restrict__
struct uint4 { unsigned x, y, z, w; };
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
"""


def _build(tmp, name, src, library="attention_f32"):
    """The emulated source as a shared library bound with `library`'s
    ctypes signatures."""
    (tmp / "cuda_runtime.h").write_text(_EMU_HEADER)
    (tmp / f"{name}.cpp").write_text(_EMU_EXTRA + _emulated(src))
    so = tmp / f"lib{name}.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", "-I", str(tmp), "-o", str(so),
                    str(tmp / f"{name}.cpp")], check=True, capture_output=True,
                   timeout=300)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in _cuda._SIGNATURES[library].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


_SOURCE = _cuda.CSRC / "attention_f32.cu"


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++ to compile the emulation")
    tmp = tmp_path_factory.mktemp("attention_f32_emu")
    return tmp, _build(tmp, "kernel", _SOURCE.read_text())


def _inputs(seed, B, Lq, Lk, H, sliced):
    """q, k, v, do drawn with numpy; `sliced`: q, k, v as column views of
    one (B, L, 3D) projection (row stride 3D)."""
    rs = np.random.RandomState(seed)
    D = H * 64
    if sliced:
        qkv = torch.from_numpy(rs.randn(B, max(Lq, Lk), 3 * D)
                               .astype(np.float32))
        q, k, v = qkv[:, :Lq, :D], qkv[:, :Lk, D:2 * D], qkv[:, :Lk, 2 * D:]
    else:
        q, k, v = (torch.from_numpy(rs.randn(B, L, D).astype(np.float32))
                   for L in (Lq, Lk, Lk))
    do = torch.from_numpy(rs.randn(B, Lq, D).astype(np.float32))
    return q, k, v, do


def _run(lib, B, Lq, Lk, H, causal=None, sliced=False, seed=0):
    """Every entry at one shape against its plain version: {check: max err
    / scale} (forward: sum p |v|; backward: the tensor's largest |value|),
    den's relative and lse's absolute error, and the bit equalities."""
    q, k, v, do = _inputs(seed, B, Lq, Lk, H, sliced)
    D, Dh = H * 64, 64
    strides = tfa._qkv_strides(q, k, v)
    P = torch.Tensor.data_ptr

    def grads():
        return [torch.empty(B, L, D) for L in (Lq, Lk, Lk)]

    def rel(a, b, scale):
        return ((a - b).abs() / scale).max().item()

    def rel_grads(got, want):
        return max(rel(a, b, b.abs().max()) for a, b in zip(got, want))

    scratch = torch.empty(2 * B * H * Lq)
    res = {}
    if causal is None:
        c = Dh ** -0.5 * tfa._LOG2E
        o, o1 = torch.empty(B, Lq, D), torch.empty(B, Lq, D)
        den = torch.empty(B, Lq, H)
        assert lib.packed_attention_den_f32(
            P(q), P(k), P(v), P(o), P(den), B, Lq, Lk, H, Dh, *strides,
            o.stride(0), o.stride(1), c, None) == 0
        assert lib.packed_attention_f32(
            P(q), P(k), P(v), P(o1), B, Lq, Lk, H, Dh, *strides, o1.stride(0),
            o1.stride(1), c, None) == 0
        ref, den_ref = tfa.packed_attention_den_plain(q, k, v, H)
        spread = tfa.packed_attention_plain(q, k, v.abs(), H)
        res["packed_attention_den_f32"] = rel(o, ref, spread)
        res["packed_attention_f32"] = rel(o1, ref, spread)
        res["den"] = ((den - den_ref).abs() / den_ref).max().item()
        g, g8, g6 = grads(), grads(), grads()
        assert lib.packed_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(ref), P(den_ref), *map(P, g),
            P(scratch), B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, None) == 0
        res["packed_attention_bwd_f32"] = rel_grads(
            g, tfa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H))
        o8, den8 = torch.empty(B, Lq, D), torch.empty(B, Lq, H)
        assert lib.packed_attention_bwd_recompute_f32(
            P(q), P(k), P(v), P(do), P(o8), P(den8), *map(P, g8), P(scratch),
            B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, None) == 0
        res["packed_attention_bwd_recompute_f32"] = rel_grads(
            g8, tfa.packed_attention_bwd_recompute_plain(q, k, v, do, H))
        # B8 = the forward kernel, then B6b's kernels on its o and den
        assert lib.packed_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(o), P(den), *map(P, g6), P(scratch),
            B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, None) == 0
        res["bits"] = torch.equal(o, o1) and all(
            torch.equal(a, b) for a, b in zip(g8, g6))
    else:
        o, lse = torch.empty(B, Lq, D), torch.empty(B, H, Lq)
        assert lib.streaming_attention_f32(
            P(q), P(k), P(v), P(o), P(lse), B, Lq, Lk, H, Dh, *strides,
            o.stride(0), o.stride(1), Dh ** -0.5, int(causal), None) == 0
        ref, lse_ref = tfa.streaming_attention_plain(q, k, v, H, causal)
        spread = tfa.streaming_attention_plain(q, k, v.abs(), H, causal)[0]
        res["streaming_attention_f32"] = rel(o, ref, spread)
        res["lse"] = (lse - lse_ref).abs().max().item()
        g = grads()
        assert lib.streaming_attention_bwd_f32(
            P(q), P(k), P(v), P(do), P(ref), P(lse_ref), *map(P, g),
            P(scratch), B, Lq, Lk, H, Dh, *strides, Dh ** -0.5, int(causal),
            None) == 0
        res["streaming_attention_bwd_f32"] = rel_grads(
            g, tfa.streaming_attention_bwd_plain(q, k, v, do, ref, lse_ref, H,
                                                 causal))
        res["bits"] = True
    return res


# (B, Lq, Lk, H, causal or None for the packed kernels, sliced q/k/v):
# ragged tiles, more query than key tiles and the reverse, causal with Lq
# above and below Lk, q/k/v as views of one projection
_SHAPES = [(2, 13, 21, 2, None, False), (1, 70, 130, 1, None, False),
           (1, 65, 64, 2, None, True), (1, 77, 77, 2, True, False),
           (1, 130, 70, 1, True, True), (1, 40, 150, 1, False, False)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_f32_kernels_match_plain_versions(emu, shape):
    _, lib = emu
    *dims, causal, sliced = shape
    res = _run(lib, *dims, causal=causal, sliced=sliced)
    for name, err in res.items():
        if name.endswith("_f32"):
            assert err <= F32_REL, (name, err)
    assert res.get("den", 0.0) <= 2.0 ** -16
    assert res.get("lse", 0.0) <= 3e-5
    assert res["bits"]


@pytest.mark.parametrize("name", [n for n in kernel_mutants.MUTANTS
                                  if n.startswith("f32_")])
def test_f32_mutants_fail_the_limit(emu, name):
    """Each fp32 mutant, built from the source with the mutant's own edits,
    breaks the limit of the kernel it targets at one of the shapes."""
    tmp, _ = emu
    path, edits, _, word = kernel_mutants.MUTANTS[name]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, name, src)
    target = word.split()[0]
    worst = 0.0
    for shape in _SHAPES:
        *dims, causal, sliced = shape
        if (causal is None) != target.startswith("packed"):
            continue
        worst = max(worst, _run(lib, *dims, causal=causal,
                                sliced=sliced)[target])
    assert worst > F32_REL, (name, worst)


def test_attention_wrappers_take_bf16_or_fp32_and_refuse_the_rest():
    """The dtype rules hold before any device work: all bfloat16 or all
    float32 (then a CPU tensor is refused for want of a card), mixed or
    half inputs raise TypeError. The w8a8 attention + out-projection takes
    fp32 in every form: B4, its int8 QK^T form (B11) and its two-source
    entry (B12) with either score."""
    x = torch.zeros(1, 5, 128)
    op = {"kernel": {"qa": torch.zeros(128, 128, dtype=torch.int8),
                     "scale": torch.ones(1, 128)}, "bias": torch.zeros(128)}
    for dtype in (torch.float32, torch.bfloat16):
        t = x.to(dtype)
        with pytest.raises(ValueError, match="CUDA"):
            tfa.packed_attention_cuda(t, t, t, 2)
        for int8_qk in (False, True):
            with pytest.raises(ValueError, match="CUDA"):
                tfa.attention_out_int8_cuda(t, t, t, 2, op, t,
                                            int8_qk=int8_qk)
            with pytest.raises(ValueError, match="CUDA"):
                tfa.attention_out_int8_2src_cuda(t, t, t, t, t, 2, op, t,
                                                 int8_qk=int8_qk)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.packed_attention_den_cuda(x, x.bfloat16(), x, 2)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.streaming_attention_cuda(x.half(), x.half(), x.half(), 2, True)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.attention_out_int8_cuda(x.half(), x.half(), x.half(), 2, op,
                                    x.half(), int8_qk=True)
    with pytest.raises(TypeError, match="all bfloat16 or all float32"):
        tfa.attention_out_int8_2src_cuda(x, x.bfloat16(), x, x, x, 2, op, x)
    assert set(tfa.launch_counts.values()) == {0}


# ---------------------------------------------------------------------------
# the int8-score form (B11) and the two-source form (B12)
# ---------------------------------------------------------------------------

def _a12_inputs(seed, B, Lq, Lk, H, ties):
    """q, k, v (B, L, H*64) fp32; `ties`: q and k rows from
    chip_smoke.int8_qk_tie_rows (values on their codes' rounding ties)."""
    rs = np.random.RandomState(seed)
    D = H * 64
    if ties:
        q = chip_smoke.int8_qk_tie_rows(rs, B * Lq * H).reshape(B, Lq, D)
        k = chip_smoke.int8_qk_tie_rows(rs, B * Lk * H).reshape(B, Lk, D)
    else:
        q, k = rs.randn(B, Lq, D), rs.randn(B, Lk, D)
    v = rs.randn(B, Lk, D)
    return tuple(torch.from_numpy(np.asarray(a, np.float32))
                 for a in (q, k, v))


def _run_a12(lib, B, Lq, Lk, H, ties, seed=0):
    """The int8-score and two-source entries at one shape: {'args': the
    int8 form's exp2 arguments equal the plain version's bit for bit,
    'packed_attention_qk8_f32' / 'packed_attention_2src_f32': max err /
    scale of B11 and of B12 in its int8 form against the plain int8
    version, 'two': both two-source forms equal the one-source forms on
    the concatenated keys bit for bit}. The second source is a column view
    of one (B, L2, 2D) projection (row stride 2D) and starts inside a key
    tile."""
    q, k, v = _a12_inputs(seed, B, Lq, Lk, H, ties)
    D, Dh = H * 64, 64
    c = Dh ** -0.5 * tfa._LOG2E
    cq = c / (127.0 * 127.0)
    P = torch.Tensor.data_ptr
    res = {}
    args = torch.empty(B, H, Lq, Lk)
    assert lib.attention_f32_qk8_args(
        P(q), P(k), P(args), B, Lq, Lk, H, Dh, q.stride(0), q.stride(1),
        k.stride(0), k.stride(1), cq, None) == 0
    want = tfa._int8_qk_exp2_arg(tfa._heads(q, H), tfa._heads(k, H), c)
    res["args"] = torch.equal(args, want)
    ref = tfa._onepass_attention_den_f32(q, k, v, H, int8_qk=True)[0]
    spread = tfa._onepass_attention_den_f32(q, k, v.abs(), H,
                                            int8_qk=True)[0]
    L1 = Lk // 3 + 1
    k1, v1 = k[:, :L1].contiguous(), v[:, :L1].contiguous()
    kv2 = torch.cat([k[:, L1:], v[:, L1:]], dim=-1)
    k2, v2 = kv2[..., :D], kv2[..., D:]
    res["two"] = True
    for int8_qk in (0, 1):
        one, two = torch.empty(B, Lq, D), torch.empty(B, Lq, D)
        entry = lib.packed_attention_qk8_f32 if int8_qk \
            else lib.packed_attention_f32
        assert entry(P(q), P(k), P(v), P(one), B, Lq, Lk, H, Dh,
                     *tfa._qkv_strides(q, k, v), one.stride(0),
                     one.stride(1), cq if int8_qk else c, None) == 0
        assert lib.packed_attention_2src_f32(
            P(q), P(k1), P(v1), P(k2), P(v2), P(two), B, Lq, L1, Lk - L1, H,
            Dh, q.stride(0), q.stride(1), k1.stride(0), k1.stride(1),
            v1.stride(0), v1.stride(1), k2.stride(0), k2.stride(1),
            v2.stride(0), v2.stride(1), two.stride(0), two.stride(1),
            cq if int8_qk else c, int8_qk, None) == 0
        res["two"] = res["two"] and torch.equal(one, two)
        if int8_qk:
            res["packed_attention_qk8_f32"] = (
                (one - ref).abs() / spread).max().item()
            res["packed_attention_2src_f32"] = (
                (two - ref).abs() / spread).max().item()
    return res


# (B, Lq, Lk, H, tie rows): ragged tiles, more key than query tiles with
# the second source starting inside the first key tile, Lk at a tile's edge
_A12_SHAPES = [(2, 13, 21, 2, False), (1, 70, 130, 1, True),
               (1, 65, 64, 2, True)]


@pytest.mark.parametrize("shape", _A12_SHAPES)
def test_int8_qk_and_two_source_forms_match_plain_versions(emu, shape):
    res = _run_a12(emu[1], *shape)
    assert res["args"]
    assert res["two"]
    for name in ("packed_attention_qk8_f32", "packed_attention_2src_f32"):
        assert res[name] <= F32_REL, (name, res[name])


@pytest.mark.parametrize("name", [n for n in kernel_mutants.MUTANTS
                                  if n.startswith(("f32b11_", "f32b12_"))])
def test_int8_qk_and_two_source_mutants_fail(emu, name):
    """B11's mutants (codes by the reciprocal, the rescale in another
    order) change the exp2 arguments at one of the shapes; B12's (the
    second source read from the first) the two-source output."""
    tmp, _ = emu
    path, edits, _, _ = kernel_mutants.MUTANTS[name]
    assert path.endswith(_SOURCE.name)
    src = _SOURCE.read_text()
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    lib = _build(tmp, name, src)
    check = "args" if name.startswith("f32b11_") else "two"
    assert not all(_run_a12(lib, *shape)[check] for shape in _A12_SHAPES)
