"""Measure the design choices of the redesigned kernels on the card: build
variants of a kernel source (patched copies, as kernel_mutants.py does)
and time each against the same yardstick, in turns.

    python3 -m gava_clip_tpu_torch.utils.kernel_variants   # from the repo root, on a card

B1 / B6a (csrc/packed_attention.cu, the den entry) against
F.scaled_dot_product_attention's forward at the two training shapes: the
source as it is, one block of 16 warps per 256-row chunk instead of two
blocks of 8 warps, exp2f instead of ex2.approx.ftz, the denominators
summed by the threads instead of against a column of ones, three stages
instead of four. B9 (csrc/w8_matmul.cu) against torch.matmul on the
dequantized weight at fc1 and fc2: the source as it is, and a variant that
skips the dequantization (its outputs are wrong; it shows what the
conversion costs). Each variant builds into `_scratch/variants/`
(gitignored), is called through the real entry point's ctypes signature,
is compared with the plain version (the share of outputs that differ), and
is timed with chip_smoke's turns: the median ratio of 7 rounds and their
range. Prints one line per variant and shape.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PA = "gava_clip_tpu_torch/csrc/packed_attention.cu"
_W8 = "gava_clip_tpu_torch/csrc/w8_matmul.cu"
# name -> (source, [(old, new)])
VARIANTS = {
    "b1_as_is": (_PA, []),
    "b1_16_warps_1_block": (_PA, [
        ("constexpr int kWarps = 8;\nconstexpr int kMinBlocks = 2;",
         "constexpr int kWarps = 16;\nconstexpr int kMinBlocks = 1;")]),
    "b1_exp2f": (_PA, [("ex2f(fminf(", "exp2f(fminf(")]),
    "b1_den_by_threads": (_PA, [
        ("        // the denominators: the same weights against a column of "
         "ones\n        mma(dsum, pa[kc], kOnes, kOnes);\n", ""),
        ("const uint32_t p = cvt_pack(e[0], e[1]);\n",
         "const uint32_t p = cvt_pack(e[0], e[1]);\n"
         "        dsum[2 * h] += attn::lo_f(p);\n"
         "        dsum[2 * h] += attn::hi_f(p);\n"),
        ("  for (int h = 0; h < 2; ++h) rsum[h] = dsum[2 * h];\n",
         "  for (int h = 0; h < 2; ++h) {\n    rsum[h] = dsum[2 * h] + "
         "__shfl_xor_sync(0xffffffffu, dsum[2 * h], 1);\n    rsum[h] += "
         "__shfl_xor_sync(0xffffffffu, rsum[h], 2);\n  }\n")]),
    "b1_3_stages": (_PA, [("constexpr int kStages = 4;",
                           "constexpr int kStages = 3;")]),
    "b9_as_is": (_W8, []),
    "b9_no_dequant": (_W8, [
        ("    dequant_word(v.x, s0, s1, a[2 * h][0], a[2 * h][1]);\n"
         "    dequant_word(v.y, s0, s1, a[2 * h][2], a[2 * h][3]);\n"
         "    dequant_word(v.z, s0, s1, a[2 * h + 1][0], a[2 * h + 1][1]);\n"
         "    dequant_word(v.w, s0, s1, a[2 * h + 1][2], a[2 * h + 1][3]);",
         "    a[2 * h][0] = a[2 * h][1] = v.x;\n"
         "    a[2 * h][2] = a[2 * h][3] = v.y;\n"
         "    a[2 * h + 1][0] = a[2 * h + 1][1] = v.z;\n"
         "    a[2 * h + 1][2] = a[2 * h + 1][3] = v.w;")]),
}
ATTN_SHAPES = ((128, 197, 214, 12), (280, 197, 276, 12))
W8_SHAPES = ((25216, 768, 3072, "fc1"), (25216, 3072, 768, "fc2"))


def _build(name):
    from gava_clip_tpu_torch.ops import _cuda
    path, edits = VARIANTS[name]
    with open(os.path.join(ROOT, path)) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {src.count(old)} "
                               f"times in {path}")
        src = src.replace(old, new)
    d = os.path.join(ROOT, "_scratch", "variants")
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, f"{name}.cu"), os.path.join(d, f"lib{name}.so")
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I",
                          str(_cuda.CSRC), "-o", so, cu],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    lib_name = "packed_attention" if path == _PA else "w8_matmul"
    for fn, (argtypes, restype) in _cuda._SIGNATURES[lib_name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return name, lib


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    cs.import_port()
    state = {}
    cs.phase_device(state)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        libs = dict(ex.map(_build, VARIANTS))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, Lq, Lk, H in ATTN_SHAPES:
        D = H * 64
        q, k, v = (torch.randn(B, L, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for L in (Lq, Lk, Lk))
        ref = fa.packed_attention_plain(q, k, v, H)
        o = torch.empty_like(q)
        den = torch.empty(B, Lq, H, device="cuda")
        for name, lib in libs.items():
            if not name.startswith("b1"):
                continue

            def call(lib=lib):
                err = lib.packed_attention_den_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    den.data_ptr(), B, Lq, Lk, H, 64,
                    *fa._qkv_strides(q, k, v), o.stride(0), o.stride(1),
                    64 ** -0.5 * fa._LOG2E, stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            share = (o != ref).float().mean().item()
            r = cs._ratio_turns(call, cs._sdpa_fwd(q, k, v, H))
            print(f"[variants] {name} B={B} Lq={Lq} Lk={Lk} H={H}: outputs "
                  f"!= plain {share:.3e}; {r[0]:.4f} ms vs SDPA forward "
                  f"{r[1]:.4f} ms, ratio {r[2]:.3f} (rounds {r[3]:.3f}-"
                  f"{r[4]:.3f}) ({state['smi']})", flush=True)
    for M, K, N, what in W8_SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        leaf = cs._w8_leaf(gen, K, N)
        ref = im.int8_matmul_plain(x, leaf["q"], leaf["scale"])
        w = im.dequant_weight(leaf["q"], leaf["scale"], x.dtype)
        s = leaf["scale"].reshape(-1).float().contiguous()
        y = torch.empty(M, N, device="cuda", dtype=torch.bfloat16)
        for name, lib in libs.items():
            if not name.startswith("b9"):
                continue

            def call(lib=lib):
                err = lib.w8_matmul_bf16(x.data_ptr(), leaf["q_t"].data_ptr(),
                                         s.data_ptr(), y.data_ptr(), M, K, N,
                                         stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            share = (y != ref).float().mean().item()
            r = cs._ratio_turns(call, lambda: torch.matmul(x, w))
            print(f"[variants] {name} {what} M={M} K={K} N={N}: outputs != "
                  f"plain {share:.3e}; {r[0]:.4f} ms vs torch.matmul "
                  f"{r[1]:.4f} ms, ratio {r[2]:.3f} (rounds {r[3]:.3f}-"
                  f"{r[4]:.3f}) ({state['smi']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
