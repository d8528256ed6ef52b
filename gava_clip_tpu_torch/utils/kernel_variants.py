"""Measure the design choices of the redesigned kernels on the card: build
variants of a kernel source (patched copies, as kernel_mutants.py does)
and time each against the same yardstick, in turns.

    python3 -m gava_clip_tpu_torch.utils.kernel_variants [b1 b9 b7 b5 b3 b4 b2 mega b10 b7b f32b9 f32b7b f32b7f f32b4 f32b11]   # repo root, on a card
    python3 -m gava_clip_tpu_torch.utils.kernel_variants b5_as_is b5_parent b5_split   # B5, its parent and the parent's split
    python3 -m gava_clip_tpu_torch.utils.kernel_variants b3_as_is b3_parent b3_split   # B3 the same way
    python3 -m gava_clip_tpu_torch.utils.kernel_variants e2e   # the parent's tree against this one

B1 / B6a (csrc/packed_attention.cu, the den entry) against
F.scaled_dot_product_attention's forward at the two training shapes: the
source as it is, one block of 16 warps per 256-row chunk instead of two
blocks of 8 warps, exp2f instead of ex2.approx.ftz, the denominators
summed by the threads instead of against a column of ones, three stages
instead of four. B9 (csrc/w8_matmul.cu) against torch.matmul on the
dequantized weight at fc1 and fc2: the source as it is, and a variant that
skips the dequantization (its outputs are wrong; it shows what the
conversion costs). B7's causal forward (csrc/streaming_attention.cu)
against SDPA's forward, both captured in CUDA graphs, at the text tower's
shape and at (4, 1024, 1024, 8): the source as it is (4 warps of one
16-row slab), 8 warps, two slabs per warp, four stages, key tiles of 128,
two stages with four blocks per SM, three blocks per SM, the accumulator
rescaled only when a max moved, exp2f. B5 (csrc/w8a8_mlp.cuh) in bf16
and fp32 at the serving shape and at chip_smoke's fallback shape (rows
that take the full first pass), each variant's outputs held to the
parent commit's kernel (`b5_parent`) bit for bit and timed in CUDA graphs
in turns with it: the source as it is, the forms tried beside it (the
second pass's codes stored as each is made, and by the conversion unit;
slab ch + 1's fc1 products in flight during slab ch's epilogue in the
second pass; the residual or the x rows prefetched into L2; the
warpgroups' second-pass products taking turns; phase 0 two rows a warp),
the IEEE division in QuickGELU, fc2's epilogue always
bounds-checked, one W2^T slab per warpgroup in fc2, no QuickGELU (wrong
outputs), and the parent's kernel cut off to show where its time goes
(`b5_split_*`: stopped after phase 0, after either fc1 pass, the first
pass's epilogue, the code stores or the residual read left out; wrong
outputs). B3 (csrc/w8a8_qkv.cu) in bf16 and fp32 at B3_SHAPES (B3's
frame rows, B3a's 27,392 training rows with LN1, the text tower's 1,155
rows), each variant's outputs held to the parent commit's kernel
(`b3_parent`, with the parent's launch plan) bit for bit there and at
B3_RAGGED_SHAPES, and timed in CUDA graphs in turns with it: the source as
it is, on 128-row tiles (B3_PLAN_FORMS), the parent's kernel on 112-row
tiles (`b3_parent_112`: the epilogue's stores from the registers), and the
parent's kernel cut off to show where its time went (`b3_split_*`: stopped
after phase 0, without phase 0, without the epilogue, the epilogue without
its stores; wrong outputs). B4
(csrc/attention_out_int8.cu) at the serving shape: exp2f, two or three K/V
stages, and four that drop a part to show where the time goes (score
products, AV products, the fp32 scratch round trip, the out-projection's
products; wrong outputs). B2 (csrc/w8a8_matmul.cu) at the patch embed and
the text tower's three shapes in its launch forms (rows x units), each
held to the plain version's bits, in CUDA graphs beside the parent's
kernel (`b2_parent`) and the int8 product alone through torch._int_mm.
The whole-layer kernel (csrc/mega_layer.cu) at the tool's shape and at
128 frame rows: the source as it is at 1 and 2 CTAs per frame row and
five copies that stop after a stage to show where the time goes (wrong
outputs), beside the parent's kernel (`mega_parent`) and the composition
B3a + B4 + B5, in turns. B10 (csrc/fused_extras.cu) at the serving shape and B7's
bf16 backward (csrc/streaming_attention_bwd.cu) at the text tower's causal
shape, a 400^2 frame row (32, 626, 643, 12) and (4, 1024, 1024, 8) causal,
each beside the parent commit's kernel built from its own source
(`b10_parent`, `b7b_parent`, from the tree unpacked into `_scratch/parent/`)
and the yardstick (the stock ops; SDPA's flash backward op), by CUDA events
and in CUDA graphs: B10 at 8, 4 and 2 blocks a cluster, its stages cut off
one by one, its attention, copied rows or q/k/v products left out, or two of
the three TF32 products taken (wrong outputs); B7's backward in its
one-launch form and past 128 rows in its key groups at every group count
worth trying, with exp2f in place of ex2.approx, and cut to show where the
time goes (the score products, the weights, the dq product, the dv / dk
products, the accumulator, three at once), then at 640 and 704 keys for the
cost of the 643-key row's sixth key tile. The fp32 forms: B9's
(csrc/w8_matmul_f32.cu) at the w8 evaluation's four shapes against
torch.matmul on the dequantized fp32 weight (TF32 off), held to
W8_F32_REL of sum |x| |w|: the source as it is, beside the parent's kernel
(`f32b9_parent`) and three that show where the time goes: no conversion
of the weights (wrong outputs), the three products of every k8 step
chained into the running sums with no wait a step (it drifts past the
limit), one product a step (wrong outputs); B7's fp32 backward
(csrc/attention_f32.cu) at the text tower's shape, a 400^2 frame row and
(4, 1024, 1024, 8) causal (F32B7B_SHAPES) beside the parent's form
(`f32b7b_parent`) and SDPA's fp32 backward op in CUDA graphs in turns:
this tree's at every count of key-tile groups worth trying, and cut to show
where its time goes (`f32b7b_cut_*`, no split, the skeleton, one product a
step; wrong outputs), and at 640 and 656 keys (the tail tile's cost); B7's
fp32 forward (`packed_fwd_kernel<true>`) at the text tower's shape and at
(4, 1024, 1024, 8) causal, held to F32_REL and F32_LSE_ABS, beside the
parent commit's FMA kernel (`b7f_parent`) and SDPA's fp32 forward in CUDA
graphs in turns, and at the text tower's shape the host time of this
tree's wrapper against the parent's launch path: the source as it is,
steps of 8, 4 or 1 chunks, three blocks an SM, three stages, every step
with its chunk tests, two product chains, rotated row slabs, the causal
grid forwards, and three cuts (`f32b7f_*`: `kernel_variants f32b7f
b7f_parent`). The
attention of B4 and B11 in fp32 (csrc/attention_f32.cu's first launch of
each) at the fp32 w8a8 evaluation's shape: this tree's (`f32b4`,
`f32b11`) and the parent's (`f32b4_parent`, `f32b11_parent`) against each
other and against SDPA's fp32 forward in turns in CUDA graphs, each
followed by this tree's B2 fp32 launch into the whole op, whose outputs
are held to F32_W8A8_LIMITS (the share beyond 2 ulp among them). `e2e`
runs chip_smoke's serving and training phases of the parent's tree and of
this one in turns.

Each variant builds into `_scratch/variants/` (gitignored), is called
through the real entry point's ctypes signature, is compared with the
plain version (the share of outputs that differ), and is timed with
chip_smoke's turns: the median ratio of 7 rounds and their range. Prints
one line per variant and shape.
"""

import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_PA = "gava_clip_tpu_torch/csrc/packed_attention.cu"
_W8 = "gava_clip_tpu_torch/csrc/w8_matmul.cu"
_B7 = "gava_clip_tpu_torch/csrc/streaming_attention.cu"
_B5 = "gava_clip_tpu_torch/csrc/w8a8_mlp.cuh"   # built by w8a8_mlp.cu
_B3 = "gava_clip_tpu_torch/csrc/w8a8_qkv.cu"
_B4 = "gava_clip_tpu_torch/csrc/attention_out_int8.cu"
_MEGA = "gava_clip_tpu_torch/csrc/mega_layer.cu"
_B2 = "gava_clip_tpu_torch/csrc/w8a8_matmul.cu"
_B10 = "gava_clip_tpu_torch/csrc/fused_extras.cu"
_B7B = "gava_clip_tpu_torch/csrc/streaming_attention_bwd.cu"
_B7BH = "gava_clip_tpu_torch/csrc/attention_bwd.cuh"
_B7BG = "gava_clip_tpu_torch/csrc/attention_bwd_wgmma.cuh"
_F32 = "gava_clip_tpu_torch/csrc/attention_f32.cu"
_W8F32 = "gava_clip_tpu_torch/csrc/w8_matmul_f32.cu"
_LIB = {_PA: "packed_attention", _W8: "w8_matmul", _B7: "streaming_attention",
        _F32: "attention_f32", _W8F32: "w8_matmul_f32",
        _B5: "w8a8_mlp", _B3: "w8a8_qkv", _B4: "attention_out_int8",
        _MEGA: "mega_layer", _B2: "w8a8_matmul", _B10: "fused_extras",
        _B7B: "streaming_attention_bwd", _B7BH: "streaming_attention_bwd",
        _B7BG: "streaming_attention_bwd"}
# The parent commit's tree, for the kernels redesigned since: unpack it with
# `git archive <parent> | tar -x -C _scratch/parent` before the call. Its
# B10 and B7-backward sources are built as they are into the variants
# `b10_parent` and `b7b_parent`, with the parent's own entry points.
PARENT = os.path.join(ROOT, "_scratch", "parent")
_VP, _I = ctypes.c_void_p, ctypes.c_int
_PARENT_SIGNATURES = {
    # cls, cls row stride; Wc, bc, lns, lnb, Wq, bq, Wk, bk, Wv, bv, Wo, bo,
    # lp, gp; e, summary; Bb, Tb, G, D, H, le_pad; weights bf16?,
    # activations bf16?; stream
    _B10: {"fused_extras": ([_VP, ctypes.c_longlong] + [_VP] * 16
                            + [_I] * 8 + [_VP], _I)},
    # q, k, v, do, o, lse, dq, dk, dv; B, Lq, Lk, H, Dh; q/k/v batch and row
    # strides; scale; causal; form (1 one launch, 0 its two mma.sync
    # kernels); shared bytes; stream
    _B7B: {"streaming_attention_bwd_bf16": (
        [_VP] * 9 + [_I] * 5 + [_I] * 6 + [ctypes.c_float, _I, _I, _I, _VP],
        _I)},
}
_PARENT_SIGNATURES[_B2] = {
    # x, W^T, s, b, y; M, K, N; stream
    "w8a8_matmul_bf16": ([_VP] * 5 + [_I] * 3 + [_VP], _I)}
_PARENT_SIGNATURES[_B3] = {
    # x, e, Wq, Wk, Wv, sq, sk, sv, bq, bk, bv, gamma, beta, oq, ok, ov; B,
    # Lx, Le, K, N, rows, units, stages, smem; stream
    "w8a8_qkv_cat_bf16": ([_VP] * 16 + [_I] * 9 + [_VP], _I),
    "w8a8_qkv_cat_f32": ([_VP] * 16 + [_I] * 9 + [_VP], _I)}
_PARENT_SIGNATURES[_MEGA] = {
    # the parent's entry points take the same arguments as this tree's
    "mega_layer_bf16": ([_VP] * 26 + [_I] * 7 + [_VP], _I),
    "mega_layer_workspace": ([_I] * 5, ctypes.c_longlong),
    "cuda_error_string": ([_I], ctypes.c_char_p)}
_PARENT_SIGNATURES[_W8F32] = {
    # x, W^T tiles, s, y; M, K, N; stream
    "w8_matmul_f32": ([_VP] * 4 + [_I] * 3 + [_VP], _I)}
# the parent's attention_f32.cu takes this tree's signatures
# (_cuda._SIGNATURES['attention_f32']) but for B7's backward, whose plan was
# (one launch?, lq_pad, shared bytes); the parent's B5 entries take this
# tree's
# q, k, v, do, o, lse, dq, dk, dv, scratch; B, Lq, Lk, H, Dh; q/k/v batch
# and row strides; scale; causal; one launch?, lq_pad, shared bytes; stream
_PARENT_F32_B7B = ([_VP] * 10 + [_I] * 5 + [_I] * 6
                   + [ctypes.c_float, _I, _I, _I, _I, _VP], _I)
PARENT_VARIANTS = {"b10_parent": _B10, "b7b_parent": _B7B,
                   "b2_parent": _B2, "mega_parent": _MEGA,
                   "f32b9_parent": _W8F32, "f32b7b_parent": _F32,
                   "f32b4_parent": _F32, "f32b11_parent": _F32,
                   "b5_parent": _B5, "b3_parent": _B3, "b7f_parent": _F32}
# B5's parent (the parent commit's w8a8_mlp.cuh, QuickGELU in both fc1
# passes) cut off, to show where its time goes (wrong outputs): name ->
# [(old, new)] on the parent's source. The producer streams what the cut
# kernel still reads.
_B5P_PASSES = ("      for (int pass = 0; pass < 2; ++pass)\n",
               "      for (int pass = 0; pass < {}; ++pass)\n")
_B5P_NO_FC2 = ("      if (w == 1) return;\n", "      return;\n")
PARENT_CUTS = {
    # phase 0 alone (LayerNorm and quant of the block's rows)
    "b5_split_phase0": (_B5, [
        (_B5P_PASSES[0], _B5P_PASSES[1].format(0)), _B5P_NO_FC2,
        ("  consumers_sync();\n\n  int acc[kAcc];\n",
         "  consumers_sync();\n  return;\n\n  int acc[kAcc];\n")]),
    # phase 0 and the first fc1 pass (the row scales)
    "b5_split_pass1": (_B5, [
        (_B5P_PASSES[0], _B5P_PASSES[1].format(1)), _B5P_NO_FC2,
        ("    hinv[rr] = __fdiv_rn(1.0f, scale);\n  }\n  consumers_sync();\n",
         "    hinv[rr] = __fdiv_rn(1.0f, scale);\n  }\n  consumers_sync();\n"
         "  return;\n")]),
    # both fc1 passes and the hidden codes written, no fc2
    "b5_split_pass2": (_B5, [
        _B5P_NO_FC2,
        ("  mbar_arrive(&hq_ready);\n", "  mbar_arrive(&hq_ready);\n  return;\n")]),
    # the first pass keeps the accumulators' max (no epilogue, no
    # QuickGELU)
    "b5_split_pass1_no_epilogue": (_B5, [(
        "            const float v = qgelu(epilogue(acc[4 * c + 2 * h + e], xr, sa[h], "
        "ba[h]));\n            mx[2 * c + e] = fmaxf(mx[2 * c + e], fabsf(v));",
        "            mx[2 * c + e] = fmaxf(mx[2 * c + e], __int_as_float(acc[4 * c + "
        "2 * h + e] & 0x7fffffff));")]),
    # the second pass computes every code but stores none (one byte a
    # thread and slab, so that none is dropped as unused)
    "b5_split_pass2_no_code_stores": (_B5, [
        ("    fc1();\n#pragma unroll\n    for (int c = 0; c < BM / 8; ++c)\n"
         "#pragma unroll\n      for (int e = 0; e < 2; ++e) {\n"
         "        const int row = 8 * c + 2 * t + e;\n",
         "    fc1();\n    int8_t sink = 0;\n#pragma unroll\n"
         "    for (int c = 0; c < BM / 8; ++c)\n#pragma unroll\n"
         "      for (int e = 0; e < 2; ++e) {\n"
         "        const int row = 8 * c + 2 * t + e;\n"),
        ("          stg[row * kStageLD + lcol + 8 * h] = quant_code(v, inv);\n",
         "          sink ^= quant_code(v, inv);\n"),
        ("    // this warpgroup's 64 columns of the slab, 16 bytes a thread\n",
         "    stg[(ct % 64) * kStageLD + ct / 64] = sink;\n"
         "    // this warpgroup's 64 columns of the slab, 16 bytes a thread\n")]),
    # fc2's epilogue adds 0 in place of the residual (no residual read)
    "b5_split_fc2_no_residual": (_B5, [(
        "store_as(y + at, kRes ? __fadd_rn(v, to_f32(r[at])) : v);",
        "store_as(y + at, kRes ? __fadd_rn(v, 0.f) : v);")]),
}
# B3's parent (the parent commit's w8a8_qkv.cu: a block a row tile, phase 0
# by all its warps, then its units, each unit's epilogue after its
# products) cut off, to show where its time goes (wrong outputs)
_B3P_EPILOGUE_HEAD = ("    const int w = u / NS;\n"
                      "    // acc[4c + 2h + e] is out^T[col0 + 8h][row 8c + 2t + e]\n")
_B3P_STORES = ("          if (FULL) {\n"
               "            store_pair(y, v.x, v.y);\n"
               "          } else if (m < p.M) {\n"
               "            if (col < p.N) store_as(y, v.x);\n"
               "            if (col + 1 < p.N) store_as(y + 1, v.y);\n"
               "          }\n")
PARENT_CUTS.update({
    # the parent's kernel on 112-row tiles (its plan with 112 rows: 245
    # blocks, two rounds at most on an SM, B3_PARENT_ROWS), bit-equal
    "b3_parent_112": (_B3, [
        ("  if ((rows != 128 && rows != 64 && rows != 32) || units <= 0 ||",
         "  if ((rows != 128 && rows != 112 && rows != 64 && rows != 32) || units <= 0 ||"),
        ("    case 128: return launch_rows<128>(maps, p, grid_y, smem, st);",
         "    case 128: return launch_rows<128>(maps, p, grid_y, smem, st);\n"
         "    case 112: return launch_rows<112>(maps, p, grid_y, smem, st);")]),
    # phase 0 alone (LayerNorm and quant of the block's rows)
    "b3_split_phase0": (_B3, [(
        "  __syncthreads();\n\n  if (threadIdx.x < 128) {",
        "  __syncthreads();\n  return;\n\n  if (threadIdx.x < 128) {")]),
    # no phase 0: the products and the epilogue on the codes and scales
    # that shared memory happens to hold
    "b3_split_no_phase0": (_B3, [("  quant_tile<BM>(\n",
                                  "  if (false) quant_tile<BM>(\n")]),
    # phase 0 and the products, no epilogue
    "b3_split_no_epilogue": (_B3, [(
        _B3P_EPILOGUE_HEAD,
        "    const int w = u / NS;\n"
        "    if (acc[0] == 0x7fffffff) store_as(p.out[w], 0.f);\n"
        "    continue;\n" + _B3P_EPILOGUE_HEAD[len("    const int w = u / NS;\n"):])]),
    # the epilogue's values computed (the lane pairs' swaps too), none
    # stored
    "b3_split_no_stores": (_B3, [
        ("    T* out = p.out[w];\n", "    T* out = p.out[w];\n    float sink = 0.f;\n"),
        (_B3P_STORES, "          sink = __fadd_rn(sink, __fadd_rn(v.x, v.y));\n"
                      "          (void)y;\n"),
        ("      store(std::false_type{});\n  }\n}",
         "      store(std::false_type{});\n"
         "    if (sink == 1.5f) store_as(out, sink);\n  }\n}")]),
})
# w8_matmul_f32.cu's products of one k8 step and their handling
_F32B9_STEP = ("      tf32::wgmma_fence();\n"
               "      step3(f, ah, al, bh, bl);\n"
               "      tf32::wgmma_commit();\n"
               "      tf32::wgmma_wait_all();\n"
               "      tf32::pin(f);\n")
# B5's second fc1 pass with slab ch + 1's products issued during slab ch's
# epilogue (two accumulator sets, the slab loop unrolled by two so that
# each set is registers): a k-chunk's wgmma group every kEvery rows of 8
_B5_PASS2_HEAD = (
    "  // fc1, second pass: the same h, quantized, through the staging tile to\n"
    "  // the block's rows of the hidden codes\n"
    "  for (int ch = 0; ch < HC; ++ch) {\n")
_B5_PASS2_TAIL = (
    "    warpgroup_sync(wg);\n  }\n"
    "  asm volatile(\"fence.proxy.async.global;\\n\" ::: \"memory\");\n")
_B5_OVERLAP_PASS2 = """  // fc1, second pass, slab ch + 1's products in flight during slab ch's
  // epilogue
  constexpr int kEvery = BM / 48 > 0 ? BM / 48 : 1;
  int hacc[2][kAcc];
  int prev = -1;
  auto issue = [&](int (&a)[kAcc], int kc) {
    mbar_wait(&full1[wg][st], ph);
    const uint64_t da = tile_desc(ring1 + (wg * kStages1 + st) * kW1Half);
    const uint64_t db = tile_desc(xc + kc * BM * kKC);
    fence_regs(a);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) wgmma_ss<BM>(a, da + 2 * j, db + 2 * j, kc > 0 || j > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty1[wg][prev]);
    }
    prev = st;
    if (++st == kStages1) {
      st = 0;
      ph ^= 1u;
    }
  };
  auto drain = [&](int (&a)[kAcc]) {
    hopper::wgmma_wait<0>();
    fence_regs(a);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty1[wg][prev]);
    prev = -1;
  };
  // the epilogue of slab ch in a, slab ch + 1's chunks issued into b
  auto slab = [&](int (&a)[kAcc], int (&b)[kAcc], int ch) {
    float sa[2], ba[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = ch * kWRows + lcol + 8 * h;
      sa[h] = col < p.H ? p.s1[col] : 0.f;
      ba[h] = col < p.H ? p.b1[col] : 0.f;
    }
    const bool more = ch + 1 < HC;
    int kc = 0;
#pragma unroll
    for (int c = 0; c < BM / 8; ++c) {
      if (c % kEvery == 0 && more && kc < KC) issue(b, kc++);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = 8 * c + 2 * t + e;
        const float xr = xs[row], inv = hinv[row];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v = qgelu(epilogue(a[4 * c + 2 * h + e], xr, sa[h], ba[h]));
          stg[row * kStageLD + lcol + 8 * h] = quant_code_fadd(v, inv);
        }
      }
    }
    if (more)
      while (kc < KC) issue(b, kc++);
    warpgroup_sync(wg);
    for (int i = ct % 128; i < BM * 4; i += 128) {
      const int row = i / 4, at = wg * 64 + (i % 4) * 16;
      *reinterpret_cast<uint4*>(p.hq + static_cast<long long>(m0 + row) * p.Hp + ch * kKC +
                                at) = *reinterpret_cast<const uint4*>(stg + row * kStageLD + at);
    }
    warpgroup_sync(wg);
    if (more) drain(b);
  };
  for (int kc = 0; kc < KC; ++kc) issue(hacc[0], kc);
  drain(hacc[0]);
  for (int ch = 0; ch < HC; ch += 2) {
    slab(hacc[0], hacc[1], ch);
    if (ch + 1 < HC) slab(hacc[1], hacc[0], ch + 1);
  }
  asm volatile("fence.proxy.async.global;\\n" ::: "memory");
"""

_B5_OVERLAP = (None, _B5_OVERLAP_PASS2)
# the two consumer warpgroups' second-pass products take turns (named
# barriers 4 and 5): each waits for the other's slab, so that one's
# epilogue runs while the other's products do
_B5_PINGPONG = (
    "\n    fc1();\n",
    "\n    if (wg == 1 || ch > 0) named_sync(4 + wg, 256);\n"
    "    fc1();\n"
    "    if (wg == 0 || ch + 1 < HC)\n"
    "      asm volatile(\"bar.arrive %0, %1;\\n\" ::\"r\"(5 - wg), \"r\"(256) : \"memory\");\n")
_B5_PREFETCH_R = (
    "    int prev = -1;\n    for (int hc = 0; hc < HC; ++hc) {\n",
    "    if (kRes) {\n"
    "      constexpr int kLine = 128 / static_cast<int>(sizeof(T));\n"
    "      constexpr int kLines = kW2Rows / kLine;\n"
    "      for (int i = ct; i < BM * kLines; i += 256) {\n"
    "        const int m = m0 + i / kLines, col = nc * kW2Rows + (i % kLines) * kLine;\n"
    "        if (m < p.M && col < p.N)\n"
    "          asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(r + static_cast<long long>(m) * p.N + col));\n"
    "      }\n"
    "    }\n"
    "    int prev = -1;\n    for (int hc = 0; hc < HC; ++hc) {\n")
_B5_PREFETCH_X = (
    "  // phase 0: LayerNorm + quant of the block's rows into the swizzled code\n",
    "  {\n"
    "    constexpr int kLine = 128 / static_cast<int>(sizeof(T));\n"
    "    const int lines = (p.K + kLine - 1) / kLine;\n"
    "    for (int i = ct; i < BM * lines; i += 256) {\n"
    "      const int m = m0 + i / lines;\n"
    "      if (m < p.M)\n"
    "        asm volatile(\"prefetch.global.L2 [%0];\" ::\"l\"(p.x + static_cast<long long>(m) * p.K + min((i % lines) * kLine, p.K - 1)));\n"
    "    }\n"
    "  }\n"
    "  // phase 0: LayerNorm + quant of the block's rows into the swizzled code\n")

# phase 0 two rows a warp at a time (quant_tile_pairs, placed before the
# kernel's parameters)
_B5_PAIRS_FN = """// phase 0 with two rows a warp at a time, their chains interleaved, where
// quant_row_to would take its 16-byte path with a LayerNorm (else
// quant_tile): the same operations on each row in the same order
template <int BM, class T, class RowPtr>
__device__ __forceinline__ void quant_tile_pairs(int8_t* xc, float* xs, RowPtr row_ptr, int K,
                                                 int Kp, const float* gamma, const float* beta,
                                                 int w0, int nw, int lane) {
  constexpr int kChunks = kMaxRowPerLane / 8;
  const T* first = row_ptr(w0);
  if (Kp > kMaxRowPerLane * 32 || K % kVecK<T> != 0 || gamma == nullptr || !aligned16(gamma) ||
      !aligned16(beta) || (first != nullptr && !aligned16(first))) {
    quant_tile<BM>(xc, xs, row_ptr, K, Kp, gamma, beta, w0, nw, lane);
    return;
  }
  for (int r0 = w0; r0 < BM; r0 += 2 * nw) {
    const int rows[2] = {r0, r0 + nw};
    const T* src[2];
    float v[2][kChunks][8];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      src[r] = rows[r] < BM ? row_ptr(rows[r]) : nullptr;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c0 = 8 * (lane + 32 * i);
        if (src[r] != nullptr && c0 < K) {
          load8(src[r], c0, K, v[r][i]);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[r][i][j] = 0.f;
        }
      }
    }
    float s[2], mean[2], q[2], rs[2], m[2], scale[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      s[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[r] = __fadd_rn(s[r], v[r][i][j]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) mean[r] = __fdiv_rn(warp_sum(s[r]), static_cast<float>(K));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      q[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (kVecK<T> == 8 ? 8 * (lane + 32 * i) < K : 8 * (lane + 32 * i) + j < K) {
            const float d = __fadd_rn(v[r][i][j], -mean[r]);
            q[r] = __fadd_rn(q[r], __fmul_rn(d, d));
          }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      rs[r] = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(q[r]), static_cast<float>(K)), 1e-5f));
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c0 = 8 * (lane + 32 * i);
      if (c0 < K) {
        const float4* g4 = reinterpret_cast<const float4*>(gamma + c0);
        const float4* b4 = reinterpret_cast<const float4*>(beta + c0);
        const bool two = kVecK<T> == 8 || c0 + 4 < K;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 ga = g4[0], gb = two ? g4[1] : z, ba = b4[0], bb = two ? b4[1] : z;
        const float gv[8] = {ga.x, ga.y, ga.z, ga.w, gb.x, gb.y, gb.z, gb.w};
        const float bv[8] = {ba.x, ba.y, ba.z, ba.w, bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[r][i][j] = __fadd_rn(
                __fmul_rn(__fmul_rn(__fadd_rn(v[r][i][j], -mean[r]), rs[r]), gv[j]), bv[j]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = 0.f;
#pragma unroll
      for (int i = 0; i < kChunks; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) m[r] = fmaxf(m[r], fabsf(v[r][i][j]));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      scale[r] = quant_scale(warp_max(m[r]));
      inv[r] = __fdiv_rn(1.0f, scale[r]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (rows[r] >= BM) continue;
#pragma unroll
      for (int i = 0; i < kChunks; ++i) {
        const int c0 = 8 * (lane + 32 * i);
        if (c0 < Kp) {
          uint32_t w[2] = {0u, 0u};   // zero codes past K, and for a row past M
          if (c0 < K && src[r] != nullptr)
#pragma unroll
            for (int j = 0; j < 8; ++j)
              w[j / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(quant_code(v[r][i][j], inv[r])))
                          << (8 * (j % 4));
          *reinterpret_cast<uint2*>(xc + code_at<BM>(rows[r], c0)) = make_uint2(w[0], w[1]);
        }
      }
      if (lane == 0) xs[rows[r]] = src[r] != nullptr ? scale[r] : 0.f;
    }
  }
}

"""
_B5_PAIRS = [
    ("template <class T>   // __nv_bfloat16 or float: x, r and y\nstruct Params {",
     _B5_PAIRS_FN + "template <class T>   // __nv_bfloat16 or float: x, r and y\nstruct Params {"),
    ("  quant_tile<BM>(\n      xc, xs,", "  quant_tile_pairs<BM, T>(\n      xc, xs,")]

# the second pass's codes stored as each is made (the form before they
# were kept in registers to the slab's end)
_B5_DEFERRED = (
    "    // the slab's codes stay in registers, four to a word, until its last\n"
    "    // value: a store to the staging tile among them would order the next\n"
    "    // rows' scale loads (shared memory too) after it, and the compiler\n"
    "    // would run the chains a pair at a time\n"
    "    uint32_t code[BM / 8];\n"
    "#pragma unroll\n    for (int c = 0; c < BM / 8; ++c) {\n      code[c] = 0u;\n#pragma unroll\n"
    "      for (int e = 0; e < 2; ++e) {\n        const int row = 8 * c + 2 * t + e;\n"
    "        const float xr = xs[row], inv = hinv[row];\n#pragma unroll\n"
    "        for (int h = 0; h < 2; ++h) {   // no branch: columns past H give 0\n"
    "          const float v = qgelu(epilogue(acc[4 * c + 2 * h + e], xr, sa[h], ba[h]));\n"
    "          code[c] |= static_cast<uint32_t>(static_cast<uint8_t>(quant_code_fadd(v, inv)))\n"
    "                     << (8 * (2 * h + e));\n"
    "        }\n      }\n    }\n"
    "#pragma unroll\n    for (int c = 0; c < BM / 8; ++c)\n#pragma unroll\n"
    "      for (int e = 0; e < 2; ++e)\n#pragma unroll\n"
    "        for (int h = 0; h < 2; ++h)\n"
    "          stg[(8 * c + 2 * t + e) * kStageLD + lcol + 8 * h] =\n"
    "              static_cast<int8_t>(code[c] >> (8 * (2 * h + e)));\n")
_B5_STORES_IN_LOOP = (_B5_DEFERRED, (
    "#pragma unroll\n    for (int c = 0; c < BM / 8; ++c)\n#pragma unroll\n"
    "      for (int e = 0; e < 2; ++e) {\n        const int row = 8 * c + 2 * t + e;\n"
    "        const float xr = xs[row], inv = hinv[row];\n#pragma unroll\n"
    "        for (int h = 0; h < 2; ++h) {   // no branch: columns past H give 0\n"
    "          const float v = qgelu(epilogue(acc[4 * c + 2 * h + e], xr, sa[h], ba[h]));\n"
    "          stg[row * kStageLD + lcol + 8 * h] = quant_code_fadd(v, inv);\n"
    "        }\n      }\n"))

# fc2's epilogue with each row pair's scale and residual loads issued
# before its stores; and the same in a function whose pointers are
# __restrict__, so that the next rows' loads may pass the stores to y
_B5_FC2_LAMBDA = """    auto store = [&](auto full_c) {
      constexpr bool FULL = decltype(full_c)::value;
#pragma unroll
      for (int c = 0; c < BM / 8; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = 8 * c + 2 * t + e, m = m0 + row;
          if (!FULL && m >= p.M) continue;
          const float hr = hs[row];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            if (!FULL && col[q] >= p.N) continue;
            const long long at = static_cast<long long>(m) * p.N + col[q];
            const float v = epilogue(acc2[q >> 1][4 * c + 2 * (q & 1) + e], hr, sa[q], ba[q]);
            store_as(y + at, kRes ? __fadd_rn(v, to_f32(r[at])) : v);
          }
        }
    };
"""
_B5_FC2_BODY = """#pragma unroll
  for (int c = 0; c < BM / 8; ++c) {
    float hr[2], rv[2][kQ];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * c + 2 * t + e;
      hr[e] = hs[8 * c + 2 * t + e];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        rv[e][q] = kRes && (FULL || (m < M && col[q] < N))
                       ? to_f32(r[static_cast<long long>(m) * N + col[q]])
                       : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * c + 2 * t + e;
      if (!FULL && m >= M) continue;
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (!FULL && col[q] >= N) continue;
        const float v = epilogue(acc2[q >> 1][4 * c + 2 * (q & 1) + e], hr[e], sa[q], ba[q]);
        store_as(y + static_cast<long long>(m) * N + col[q], kRes ? __fadd_rn(v, rv[e][q]) : v);
      }
    }
  }
"""
_B5_FC2_LOADS_FIRST = (_B5_FC2_LAMBDA, (
    "    auto store = [&](auto full_c) {\n"
    "      constexpr bool FULL = decltype(full_c)::value;\n"
    "      const int M = p.M, N = p.N;\n"
    + _B5_FC2_BODY + "    };\n"))
_B5_FC2_RESTRICT = [
    ("template <class T>   // __nv_bfloat16 or float: x, r and y\nstruct Params {",
     "template <int BM, bool kRes, bool FULL, class T>\n"
     "__device__ __forceinline__ void fc2_store(const int (&acc2)[kW2Slabs][BM / 2],\n"
     "                                          const float* __restrict__ hs,\n"
     "                                          const float (&sa)[2 * kW2Slabs],\n"
     "                                          const float (&ba)[2 * kW2Slabs],\n"
     "                                          const int (&col)[2 * kW2Slabs],\n"
     "                                          const T* __restrict__ r, T* __restrict__ y,\n"
     "                                          int m0, int M, int N, int t) {\n"
     "  constexpr int kQ = 2 * kW2Slabs;\n"
     + _B5_FC2_BODY + "}\n\n"
     "template <class T>   // __nv_bfloat16 or float: x, r and y\nstruct Params {"),
    (_B5_FC2_LAMBDA, ""),
    ("      store(std::true_type{});\n    else\n      store(std::false_type{});\n",
     "      fc2_store<BM, kRes, true>(acc2, hs, sa, ba, col, r, y, m0, p.M, p.N, t);\n"
     "    else\n"
     "      fc2_store<BM, kRes, false>(acc2, hs, sa, ba, col, r, y, m0, p.M, p.N, t);\n")]

# B7's fp32 forward: steps of 8, 4 or 1 chunks; three blocks an SM in its
# launch bounds
_B7F_CHUNKS8 = ("constexpr int kStreamChunks = 2;", "constexpr int kStreamChunks = 8;")
_B7F_CHUNKS4 = ("constexpr int kStreamChunks = 2;", "constexpr int kStreamChunks = 4;")
_B7F_CHUNKS1 = ("constexpr int kStreamChunks = 2;", "constexpr int kStreamChunks = 1;")
_B7F_3_BLOCKS = ("__launch_bounds__(kFwdThreads, STREAM ? 2 : 3) packed_fwd_kernel",
                 "__launch_bounds__(kFwdThreads, 3) packed_fwd_kernel")
# the key groups' parts (csrc/attention_bwd_wgmma.cuh) the b7b cuts skip
_B7BG_DQ = ("      const int nk = (kmax + 15) / 16;",
            "      const int nk = a.causal < 0 ? (kmax + 15) / 16 : 0;")
_B7BG_DKDV = (("        for (int kk = 0; kk < kKD; ++kk)   // dv += bf16(p)^T do",
               "        for (int kk = 0; kk < (a.causal < 0 ? kKD : 0); ++kk)"),
              ("        for (int kk = 0; kk < kKD; ++kk)   // dk += ds^T q",
               "        for (int kk = 0; kk < (a.causal < 0 ? kKD : 0); ++kk)"))
_B7BG_SCORES = (("        for (int kk = 0; kk < kKD; ++kk)   // s^T = k q^T",
                  "        for (int kk = 0; kk < (a.causal < 0 ? kKD : 0); ++kk)"),
                 ("        for (int kk = 0; kk < kKD; ++kk)   // dp^T = v do^T",
                  "        for (int kk = 0; kk < (a.causal < 0 ? kKD : 0); ++kk)"))
_B7BG_WEIGHTS = ("        if (!a.causal && wk0 + 64 <= a.Lk)\n"
                 "          weights(std::true_type{});\n"
                 "        else\n          weights(std::false_type{});\n",
                 "        if (a.causal < 0) weights(std::false_type{});\n")
_B7BG_ACC = ("      for (int j = 0; j < 4; ++j) {\n        const int col = wg * 32",
             "      for (int j = 0; j < (a.causal < 0 ? 4 : 0); ++j) {\n"
             "        const int col = wg * 32")
# name -> (source, [(old, new)])
VARIANTS = {
    "f32b9_as_is": (_W8F32, []),
    # where B9 fp32's time goes (wrong outputs): no weight conversion (the
    # plane sets keep what they held)
    "f32b9_no_convert": (_W8F32, [(
        "        convert_w(ws(ks + 1), wplanes(ks + 1), wplanes(ks + 1) + "
        "kWPlaneFloats, sc, c);\n", "")]),
    # every step's products chained into the running sums, no wait a step
    # (the tensor core's truncation drifts past W8_F32_REL)
    "f32b9_chained": (_W8F32, [
        (_F32B9_STEP + "      // the step's sum added to the running one in "
         "fp32, to nearest\n#pragma unroll\n"
         "      for (int i = 0; i < kAcc; ++i) acc[i] += f[i];\n",
         "      tf32::wgmma_fence();\n"
         "      tf32::wgmma_tf32(acc, al, bh);\n"
         "      tf32::wgmma_tf32(acc, ah, bl);\n"
         "      tf32::wgmma_tf32(acc, ah, bh);\n"
         "      tf32::wgmma_commit();\n"),
        ("  // acc[4 j + 0, 1]: row row0",
         "  tf32::wgmma_wait_all();\n  tf32::pin(acc);\n"
         "  // acc[4 j + 0, 1]: row row0")]),
    # one TF32 product a step (wrong outputs): what the other two cost
    "f32b9_one_product": (_W8F32, [(
        "  tf32::wgmma_tf32_z(f, al, bh);   // lo_x hi_w\n"
        "  tf32::wgmma_tf32(f, ah, bl);     // hi_x lo_w\n"
        "  tf32::wgmma_tf32(f, ah, bh);     // hi_x hi_w\n",
        "  tf32::wgmma_tf32_z(f, ah, bh);\n")]),
    "f32b7b_as_is": (_F32, []),
    # B7's fp32 backward (packed_bwd_kernel<true>) cut to show where its
    # time goes (wrong outputs; each part skipped by a test the compiler
    # cannot fold, groups < 0): without the score products (q k^T, do v^T),
    # without the dv / dk products, without the dq products (its barrier,
    # ds^T and the accumulator's read and write kept), without the whole dq
    # part; and every product one TF32 product instead of three
    "f32b7b_cut_scores": (_F32, [(
        "          for (int kk = 0; kk < kHD / 8; ++kk) {\n"
        "            uint32_t kh[4], kl[4], vh[4], vl[4];",
        "          for (int kk = 0; kk < (a.groups < 0 ? kHD / 8 : 0); ++kk) {\n"
        "            uint32_t kh[4], kl[4], vh[4], vl[4];")]),
    "f32b7b_cut_dkdv": (_F32, [(
        "              const float* qor = qs + (8 * f + 2 * t) * kLDF + g;\n"
        "#pragma unroll\n"
        "              for (int n = 0; n < kHD / 8; ++n) {",
        "              const float* qor = qs + (8 * f + 2 * t) * kLDF + g;\n"
        "              for (int n = 0; n < (a.groups < 0 ? kHD / 8 : 0); ++n) {")]),
    "f32b7b_cut_dq_products": (_F32, [(
        "            if (kc < nkc) {\n              const float* dr = ds_s",
        "            if (kc < nkc && a.groups < 0) {\n              const float* dr = ds_s")]),
    "f32b7b_cut_dq": (_F32, [(
        "        const int slab = warp / WPS, c0 = warp % WPS * CW;\n"
        "        if (16 * slab < nq) {",
        "        const int slab = warp / WPS, c0 = warp % WPS * CW;\n"
        "        if (16 * slab < nq && a.groups < 0) {")]),
    # ... every operand's split into hi and lo skipped (hi the raw bits, lo
    # 0: the ALU work of the splits, an upper bound on pre-split tiles'
    # gain), and every part cut at once (the loads, barriers, p and ds, the
    # row statistics: the skeleton)
    "f32b7b_no_split": (_F32, [(
        '#include "tf32_frags.cuh"\n',
        '#include "tf32_frags.cuh"\n'
        "namespace tf32 {\n__device__ __forceinline__ void nosplit_(float x, "
        "uint32_t& hi, uint32_t& lo) {\n  hi = __float_as_uint(x);\n  lo = 0u;\n}\n"
        "}  // namespace tf32\n#define split nosplit_\n")]),
    "f32b7b_skeleton": (_F32, [(
        "          for (int kk = 0; kk < kHD / 8; ++kk) {\n"
        "            uint32_t kh[4], kl[4], vh[4], vl[4];",
        "          for (int kk = 0; kk < (a.groups < 0 ? kHD / 8 : 0); ++kk) {\n"
        "            uint32_t kh[4], kl[4], vh[4], vl[4];"), (
        "              const float* qor = qs + (8 * f + 2 * t) * kLDF + g;\n"
        "#pragma unroll\n"
        "              for (int n = 0; n < kHD / 8; ++n) {",
        "              const float* qor = qs + (8 * f + 2 * t) * kLDF + g;\n"
        "              for (int n = 0; n < (a.groups < 0 ? kHD / 8 : 0); ++n) {"), (
        "        const int slab = warp / WPS, c0 = warp % WPS * CW;\n"
        "        if (16 * slab < nq) {",
        "        const int slab = warp / WPS, c0 = warp % WPS * CW;\n"
        "        if (16 * slab < nq && a.groups < 0) {")]),
    "f32b7b_one_product": (_F32, [(
        "  tf32::mma_tf32_z(p, al, bh0, bh1);\n"
        "  tf32::mma_tf32(p, ah, bl0, bl1);\n"
        "  tf32::mma_tf32(p, ah, bh0, bh1);\n",
        "  tf32::mma_tf32_z(p, ah, bh0, bh1);\n")]),
    # B7's fp32 forward (packed_fwd_kernel<true>): the source as it is;
    # every step with the tests of each chunk (no FULL form); the hi x hi
    # product in a fresh accumulator of its own (two chains of one
    # and two products where mma3 chains three); three stages of key / value
    # tiles (a block of two tiles issues both before its first wait); the
    # warps' row slabs
    # rotated by the (batch row, head), so that two blocks on one SM give
    # their heaviest slabs to different quarters of it; its scores masked
    # and its sums rescaled every 8 chunks of 8 keys (the
    # whole key tile), every 4 or every chunk; three blocks to an SM in its
    # launch bounds (168 registers a thread where two leave 255), with 8-chunk
    # steps too; the causal grid's x forwards (the blocks with the fewest key
    # tiles first); and cut to show where its time goes (wrong outputs):
    # without the AV products, without the score products, without any step
    # (the loads, barriers and epilogue alone)
    "f32b7f_as_is": (_F32, []),
    "f32b7f_two_chains": (_F32, [
        ("// an A fragment (a0..a3 in order) split into hi and lo\n",
         "__device__ __forceinline__ void mma3p(float (&d)[4], const uint32_t (&ah)[4],\n"
         "                                      const uint32_t (&al)[4], uint32_t bh0, "
         "uint32_t bh1,\n"
         "                                      uint32_t bl0, uint32_t bl1) {\n"
         "  float p[4], r[4];\n"
         "  tf32::mma_tf32_z(p, al, bh0, bh1);\n"
         "  tf32::mma_tf32(p, ah, bl0, bl1);\n"
         "  tf32::mma_tf32_z(r, ah, bh0, bh1);\n"
         "#pragma unroll\n"
         "  for (int i = 0; i < 4; ++i) d[i] += r[i] + p[i];\n"
         "}\n\n"
         "// an A fragment (a0..a3 in order) split into hi and lo\n"),
        ("            mma3(s[j], qh[kk], ql[kk], bh0, bh1, bl0, bl1);",
         "            mma3p(s[j], qh[kk], ql[kk], bh0, bh1, bl0, bl1);"),
        ("          mma3(oacc[n], eh, el, bh0, bh1, bl0, bl1);",
         "          mma3p(oacc[n], eh, el, bh0, bh1, bl0, bl1);")]),
    "f32b7f_tests_always": (_F32, [
        ("      if (STREAM && GC * (c4 + 1) <= nch)\n", "      if (false)\n")]),
    "f32b7f_3_stages": (_F32, [
        ("constexpr int kPFwdSmemBytes = 2 * kFwdStageFloats * 4;\n",
         "constexpr int kPFwdSmemBytes = 2 * kFwdStageFloats * 4;\n"
         "constexpr int kSFwdSmemBytes = 3 * kFwdStageFloats * 4;\n"),
        ("      float* st = smem + (kt & 1) * kFwdStageFloats;",
         "      float* st = smem + static_cast<unsigned>(kt) % (STREAM ? 3 : 2) * "
         "kFwdStageFloats;"),
        ("  issue(0);\n\n  // the warp's q rows as A fragments",
         "  issue(0);\n  if (STREAM) issue(1);\n\n  // the warp's q rows as A fragments"),
        ("    tf32::cp_wait_all();\n    __syncthreads();   // tile kt is in; every warp "
         "is done with the other stage\n    issue(kt + 1);\n    if (!active) continue;\n"
         "    const float* ks = smem + (kt & 1) * kFwdStageFloats;",
         "    if (STREAM)\n      tf32::cp_wait_1();\n    else\n      tf32::cp_wait_all();\n"
         "    __syncthreads();\n    issue(kt + (STREAM ? 2 : 1));\n"
         "    if (!active) continue;\n"
         "    const float* ks = smem + static_cast<unsigned>(kt) % (STREAM ? 3 : 2) * "
         "kFwdStageFloats;"),
        ("                                         kPFwdSmemBytes);\n  if (err != cudaSuccess) "
         "return err;\n  const dim3 grid((a.Lq + kFwdRows - 1) / kFwdRows, a.H, B);\n"
         "  packed_fwd_kernel<STREAM><<<grid, kFwdThreads, kPFwdSmemBytes, stream>>>(a);",
         "                                         STREAM ? kSFwdSmemBytes : kPFwdSmemBytes);\n"
         "  if (err != cudaSuccess) return err;\n"
         "  const dim3 grid((a.Lq + kFwdRows - 1) / kFwdRows, a.H, B);\n"
         "  packed_fwd_kernel<STREAM><<<grid, kFwdThreads, STREAM ? kSFwdSmemBytes : "
         "kPFwdSmemBytes, stream>>>(a);")]),
    "f32b7f_rotate_warps": (_F32, [
        ("  const int w0 = qt * kFwdRows + warp * 16;            // the warp's first query row",
         "  const int w0 = qt * kFwdRows + ((warp + blockIdx.y + blockIdx.z * gridDim.y) & 3) * 16;")]),
    "f32b7f_chunks8": (_F32, [_B7F_CHUNKS8]),
    "f32b7f_chunks4": (_F32, [_B7F_CHUNKS4]),
    "f32b7f_chunks1": (_F32, [_B7F_CHUNKS1]),
    "f32b7f_3_blocks": (_F32, [_B7F_3_BLOCKS]),
    "f32b7f_chunks8_3_blocks": (_F32, [_B7F_CHUNKS8, _B7F_3_BLOCKS]),
    "f32b7f_grid_forwards": (_F32, [
        ("const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;",
         "const int qt = blockIdx.x;")]),
    "f32b7f_cut_av": (_F32, [
        ("          mma3(oacc[n], eh, el, bh0, bh1, bl0, bl1);\n", "")]),
    "f32b7f_cut_scores": (_F32, [
        ("            mma3(s[j], qh[kk], ql[kk], bh0, bh1, bl0, bl1);\n", "")]),
    "f32b7f_cut_steps": (_F32, [
        ("      if (STREAM && GC * (c4 + 1) <= nch)\n"
         "        step(std::true_type{}, c4);\n      else\n"
         "        step(std::false_type{}, c4);\n", "")]),
    "f32b4": (_F32, []),
    "f32b11": (_F32, []),
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
    "b7_as_is": (_B7, []),
    # 8 warps of one 16-row slab (128-row chunks); 4 warps of two slabs
    # (each K and V fragment feeding both)
    "b7_8_warps": (_B7, [("constexpr int kWarps = 4;",
                          "constexpr int kWarps = 8;")]),
    "b7_two_slabs_per_warp": (_B7, [("constexpr int kSlabs = 1;",
                                     "constexpr int kSlabs = 2;")]),
    "b7_4_stages": (_B7, [("constexpr int kStages = 3;",
                           "constexpr int kStages = 4;")]),
    "b7_3_blocks": (_B7, [("__launch_bounds__(kWarps * 32, 2)",
                           "__launch_bounds__(kWarps * 32, 3)")]),
    # key tiles of 128 (two blocks per SM); two stages of 64 keys with
    # four blocks per SM
    "b7_128_key_tiles": (_B7, [("constexpr int kTileK = 64;",
                                "constexpr int kTileK = 128;")]),
    "b7_2_stages_4_blocks": (_B7, [("constexpr int kStages = 3;",
                                    "constexpr int kStages = 2;"),
                                   ("__launch_bounds__(kWarps * 32, 2)",
                                    "__launch_bounds__(kWarps * 32, 4)")]),
    # the accumulator rescaled only when a row's max moved in the warp
    "b7_rescale_on_move": (_B7, [
        ("#pragma unroll\n        for (int d = 0; d < kND; ++d) {\n"
         "          acc[sl][d][2 * j] *= alpha;\n"
         "          acc[sl][d][2 * j + 1] *= alpha;\n        }\n",
         "        if (__any_sync(0xffffffffu, alpha != 1.f)) {\n"
         "#pragma unroll\n        for (int d = 0; d < kND; ++d) {\n"
         "          acc[sl][d][2 * j] *= alpha;\n"
         "          acc[sl][d][2 * j + 1] *= alpha;\n        }\n"
         "        }\n")]),
    "b7_exp2f": (_B7, [("const float p0 = ex2f(", "const float p0 = exp2f("),
                       ("const float p1 = ex2f(", "const float p1 = exp2f("),
                       ("const float alpha = ex2f(",
                        "const float alpha = exp2f(")]),
    "b5_as_is": (_B5, []),
    # pass 2's codes without the conversion unit: rint(h * inv) as the low
    # byte of h * inv + 1.5 * 2^23 (exact for |h * inv| < 2^22; NaN to 0
    # as the conversion gives it)
    # B5's forms tried beside the source (in CUDA graphs at the serving
    # shape, in turns with the parent's kernel, bf16 / fp32, on an H100 at
    # 700 W; all bit-equal to it): the codes stored as each is made, the
    # form before (0.886-0.893 / 0.883-0.889; the source 0.835-0.840 /
    # 0.841-0.856)
    "b5_stores_in_loop": (_B5, [_B5_STORES_IN_LOOP]),
    # ... and before that, by the conversion unit (F2I): 0.891-0.896 /
    # 0.888-0.896
    "b5_code_by_cvt": (_B5, [_B5_STORES_IN_LOOP, (
        "stg[row * kStageLD + lcol + 8 * h] = quant_code_fadd(v, inv);",
        "stg[row * kStageLD + lcol + 8 * h] = quant_code(v, inv);")]),
    # the rest measured on those forms: slab ch + 1's fc1 products in
    # flight during slab ch's epilogue in the second pass: 1.797 / 1.831
    # (two accumulator sets of 96 registers spill 5.8 KB at 192 rows, and
    # ptxas serializes the wgmma, C7518)
    "b5_overlap_pass2": (_B5, [_B5_OVERLAP]),
    # fc2's residual tile into L2 (prefetch.global.L2) as its products
    # start: 1.037 / 1.198; the block's x rows into L2 before phase 0:
    # 0.902 / 0.914; both with the overlap: 1.943 / 2.109
    "b5_prefetch_residual": (_B5, [_B5_PREFETCH_R]),
    "b5_prefetch_x": (_B5, [_B5_PREFETCH_X]),
    "b5_all": (_B5, [_B5_OVERLAP, _B5_PREFETCH_R, _B5_PREFETCH_X]),
    # phase 0 two rows a warp at a time: 0.908 / 0.916; the warpgroups'
    # second-pass products taking turns: 0.899 / 0.903 with the codes
    # stored in the loop, 0.840 / 0.857 with the source's (kept in
    # registers)
    "b5_phase0_pairs": (_B5, _B5_PAIRS),
    "b5_pingpong_pass2": (_B5, [_B5_PINGPONG]),
    # fc2's residual loads of a row pair before its stores: 0.861 / 0.873;
    # the same with __restrict__ pointers: 0.863 / 0.873 (the source 0.835 /
    # 0.856 in the same call)
    "b5_fc2_loads_first": (_B5, [_B5_FC2_LOADS_FIRST]),
    "b5_fc2_restrict": (_B5, _B5_FC2_RESTRICT),
    "b5_no_quick_gelu": (_B5, [(
        "  return __fmul_rn(h, rcp_newton(fminf(__fadd_rn(1.0f, expf("
        "-__fmul_rn(1.702f, h))), 3.0e38f)));", "  return h;")]),
    # QuickGELU's reciprocal by the IEEE division, as the plain version
    # writes it (a slow-path branch for each value)
    "b5_ieee_division": (_B5, [(
        "rcp_newton(fminf(__fadd_rn(1.0f, expf(-__fmul_rn(1.702f, h))), "
        "3.0e38f))", "__fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-__fmul_rn("
        "1.702f, h))))")]),
    # fc2's epilogue always through the bounds-checked loop
    "b5_checked_store": (_B5, [(
        "if (m0 + BM <= p.M && (nc + 1) * kW2Rows <= p.N)", "if (false)")]),
    # fc2 with one 64-row W2^T slab per warpgroup (128 output columns a
    # stage): the hidden codes read back twice as often
    "b5_fc2_one_slab": (_B5, [("constexpr int kW2Slabs = 2;",
                               "constexpr int kW2Slabs = 1;")]),
    "b3_as_is": (_B3, []),
    # the same source on 128-row tiles (B3_PLAN_FORMS)
    "b3_rows_128": (_B3, []),
    "b4_as_is": (_B4, []),
    # exp2f (with its handling of subnormal results) instead of
    # ex2.approx.ftz
    "b4_exp2f": (_B4, [("apipe::ex2f(fminf(arg, 110.f))",
                        "exp2f(fminf(arg, 110.f))")]),
    # (wrong outputs) no K / V copies (the tiles keep what they held); no
    # division of the outputs by the denominators
    "b4_no_kv_copies": (_B4, [(
        "        apipe::cp_async16(st + (which * kTileElems + rr * kLDS + cv) * 2, src + hoff + cv, ok);",
        "        if (src == nullptr) apipe::cp_async16(st + (which * kTileElems + rr * kLDS + cv) * 2, src + hoff + cv, ok);")]),
    "b4_no_division": (_B4, [(
        "        const float d0 = fmaxf(dsum[0], 1e-30f), d1 = fmaxf(dsum[2], 1e-30f);\n"
        "#pragma unroll\n"
        "        for (int d = 0; d < kND; ++d) {\n"
        "          const float2 v0 = make_float2(acc[d][0] / d0, acc[d][1] / d0);\n"
        "          const float2 v1 = make_float2(acc[d][2] / d1, acc[d][3] / d1);\n",
        "#pragma unroll\n"
        "        for (int d = 0; d < kND; ++d) {\n"
        "          const float2 v0 = make_float2(acc[d][0] * dsum[0], acc[d][1]);\n"
        "          const float2 v1 = make_float2(acc[d][2] * dsum[2], acc[d][3]);\n")]),
    # two or three K/V ring stages instead of four
    "b4_2_kv_stages": (_B4, [("constexpr int kKVStages = 4;",
                              "constexpr int kKVStages = 2;")]),
    "b4_3_kv_stages": (_B4, [("constexpr int kKVStages = 4;",
                              "constexpr int kKVStages = 3;")]),
    # where the attention's time goes (wrong outputs): no score products,
    # no AV products, no fp32 scratch round trip, no exp2
    "b4_no_score_products": (_B4, [(
        "                uint32_t bk[4];\n"
        "                apipe::ldsm(bk, ks + (n * 8 + (lane & 7)) * kLDS + (lane >> 3) * 8 + "
        "half * 32);\n"
        "                apipe::mma(s[n], qa[2 * half], bk[0], bk[1]);\n"
        "                apipe::mma(s[n], qa[2 * half + 1], bk[2], bk[3]);\n",
        "                s[n][0] += __uint_as_float(qa[2 * half][0]);\n")]),
    "b4_no_av_products": (_B4, [(
        "              uint32_t bv[4];\n"
        "              apipe::ldsm_t(bv, vs + (kc * 16 + (lane & 15)) * kLDS + (2 * dp + "
        "(lane >> 4)) * 8);\n"
        "              apipe::mma(acc[2 * dp], pa[kc], bv[0], bv[1]);\n"
        "              apipe::mma(acc[2 * dp + 1], pa[kc], bv[2], bv[3]);\n",
        "              acc[2 * dp][0] += __uint_as_float(pa[kc][0]);\n")]),
    "b4_no_scratch": (_B4, [
        ("          *reinterpret_cast<float2*>(a0 + head * kHD + d * 8) = v0;\n"
         "          *reinterpret_cast<float2*>(a1 + head * kHD + d * 8) = v1;\n", ""),
        ("        const float2 v0 = *reinterpret_cast<const float2*>(a0 + col - 2 * t);\n"
         "        const float2 v1 = *reinterpret_cast<const float2*>(a1 + col - 2 * t);\n",
         "        const float2 v0 = make_float2(rmax[0], rmax[1]);\n"
         "        const float2 v1 = make_float2(rmax[1], rmax[0]);\n")]),
    "b4_no_exp2": (_B4, [(
        "e[j] = FULL || key < p.Lk ? apipe::ex2f(fminf(arg, 110.f)) : 0.f;",
        "e[j] = FULL || key < p.Lk ? arg : 0.f;")]),
    # where the time goes (wrong outputs): no out-projection products
    # (ring_product's waits and arrivals without its wgmma: the attention,
    # the scratch and the epilogue alone)
    "b4_no_outproj_products": (_B4, [(
        "    ring_product<N>(acc, ring, kSlabBytes, full, empty, kWStages, st, ph, "
        "xc, R * kKC, KC, lane);",
        "    for (int kc = 0; kc < KC; ++kc) {\n"
        "      hopper::mbar_wait(&full[st], ph);\n"
        "      __syncwarp();\n"
        "      if (lane == 0) hopper::mbar_arrive(&empty[st]);\n"
        "      if (++st == kWStages) { st = 0; ph ^= 1u; }\n"
        "    }\n"
        "#pragma unroll\n"
        "    for (int i = 0; i < N / 2; ++i) acc[i] = i;")]),
    "b10_as_is": (_B10, []),
    # where B10's time goes (wrong outputs): the launch cut off after stage
    # 1, after the first grid barrier, before and after the second; the
    # attention or e's copied rows left out
    "b10_cut_stage1": (_B10, [(
        "  // stage 2's first weight tile, while the blocks meet",
        "  return;\n  // stage 2's first weight tile, while the blocks meet")]),
    "b10_cut_barrier1": (_B10, [(
        "  // ---------------- stage 2: LayerNorm",
        "  return;\n  // ---------------- stage 2: LayerNorm")]),
    "b10_cut_stage2": (_B10, [(
        "  // stage 3's first weight tile, while the blocks meet",
        "  return;\n  // stage 3's first weight tile, while the blocks meet")]),
    "b10_cut_barrier2": (_B10, [(
        "  // ---------------- stage 3: out-projection",
        "  return;\n  // ---------------- stage 3: out-projection")]),
    "b10_no_attention": (_B10, [(
        "  const int tid = threadIdx.x;\n  const float scale",
        "  if (nc >= 0) return;\n  const int tid = threadIdx.x;\n  const float scale")]),
    # (wrong outputs) stage 2's q/k/v products left out; the same with
    # two of their three TF32 products (lo_a hi_b dropped)
    "b10_no_qkv_products": (_B10, [(
        "warp_gemm<kHeadN / 8, true, kWLo>(acc, A_s, W_s, ldw(kHeadN), (kn + 7) / 8 * 8,",
        "warp_gemm<kHeadN / 8, true, kWLo>(acc, A_s, W_s, ldw(kHeadN), 0 * kn,")]),
    "b10_qkv_two_products": (_B10, [(
        "warp_gemm<kHeadN / 8, true, kWLo>(acc, A_s, W_s, ldw(kHeadN), (kn + 7) / 8 * 8,",
        "warp_gemm<kHeadN / 8, false, kWLo>(acc, A_s, W_s, ldw(kHeadN), (kn + 7) / 8 * 8,")]),
    "b10_no_copied_rows": (_B10, [(
        "rl < BT * nl;\n", "rl < 0;\n")]),
    "b7b_as_is": (_B7B, []),
    # exp2 by one MUFU instruction (ex2.approx.ftz, as B1 and B7's forward
    # take it) in place of exp2f in the one-launch form
    "b7b_ex2f": (_B7BH, [
        ("const float p = valid ? exp2f(s * c - stat) : 0.f;",
         "const float p = valid ? afrag::ex2f(s * c - stat) : 0.f;")]),
    # ... and exp2f (IEEE-accurate) in the key groups in place of their
    # ex2.approx
    "b7b_exp2f_groups": (_B7BG, [
        ("afrag::ex2f(s[4 * j + i] * a.c - sv.x)",
         "exp2f(s[4 * j + i] * a.c - sv.x)")]),
    # the key groups cut to show where their time goes (wrong outputs; each
    # part skipped by a test the compiler cannot fold, causal < 0): without
    # the dq product (the barrier, ds^T and the accumulator kept), without
    # the dv / dk products, without the accumulator's read and write, and
    # without all three
    "b7b_cut_dq": (_B7BG, [_B7BG_DQ]),
    "b7b_cut_dkdv": (_B7BG, list(_B7BG_DKDV)),
    "b7b_cut_acc": (_B7BG, [_B7BG_ACC]),
    "b7b_cut_all": (_B7BG, [_B7BG_DQ, *_B7BG_DKDV, _B7BG_ACC]),
    # ... without the score products (s^T, dp^T), and without the weights
    # (p, ds: the exp2 and the masks; the products read the raw scores)
    "b7b_cut_scores": (_B7BG, list(_B7BG_SCORES)),
    "b7b_cut_weights": (_B7BG, [_B7BG_WEIGHTS]),
    "b2_as_is": (_B2, []),
    "mega_as_is": (_MEGA, []),
    # where the time goes (wrong outputs): the launch stopped after stage
    # n of six (1 q/k/v, 2 the attention, 3 the out-projection and LN2, 4
    # and 5 the fc1 passes)
    **{f"mega_stages_to_{n}": (_MEGA, [(
        "constexpr int kRunStages = 6;", f"constexpr int kRunStages = {n};")])
       for n in range(1, 6)},
}
# CTAs per frame row each mega variant is timed at (the plan's: None); the
# stopped ones at 2, where each CTA takes one tile of each kind
MEGA_SPLITS = {"mega_as_is": (None, 1, 2)}


def _parent_mega_split(frames, sms):
    """The parent commit's launch plan of its mega kernel: CTAs per frame
    row filling two an SM, 1 to 8."""
    return max(1, min(8, 2 * sms // frames))


# the K/V stages of each B4 variant, for its shared bytes
B4_KV_STAGES = {"b4_2_kv_stages": 2, "b4_3_kv_stages": 3}   # the others: 4
# the fc2 weight tile of each B5 variant, for its launch plan
B5_TILE2 = {"b5_fc2_one_slab": 16384}   # the others: 32,768
# (M, K, hidden, N, B5_FALLBACK_ROWS take the full first pass?): the
# serving shape, timed; chip_smoke's fallback shape
B5_SHAPES = ((25216, 768, 3072, 768, False), (200, 768, 3072, 768, True))
# (B, Lx, Le, K, N, LayerNorm?) of B3: the fp32 w8a8 evaluation's frame
# rows (B3), the int8 training step's 27,392 kv rows with LN1 (B3a), the
# text tower's 1,155 rows (B3a, no LayerNorm); each in bf16 and fp32
B3_SHAPES = ((128, 197, 17, 768, 768, True), (1, 27392, 0, 768, 768, True),
             (1, 1155, 0, 512, 512, False))
# the other shapes of chip_smoke's B3 checks (W8A8_QKV_SHAPES,
# F32_B3_SHAPES, F32_B3A_SHAPES: ragged ones, the long clip's 280 frame
# rows), held bit for bit and not timed
B3_RAGGED_SHAPES = ((3, 13, 5, 96, 40, True), (4, 21, 0, 768, 768, True),
                    (2, 9, 0, 64, 19, True), (1, 200, 0, 1100, 77, True),
                    (1, 37, 0, 100, 40, False), (280, 197, 17, 768, 768, True))
# rows per tile of the parent-source variants launched in another form than
# the parent's plan (the rest of its plan kept, the shared bytes recounted)
B3_PARENT_ROWS = {"b3_parent_112": 112}
# the launch plan of a B3 variant other than the plan's own: name ->
# keyword arguments of ops.int8_matmul.w8a8_qkv_plan (a shape where the
# form does not fit keeps the plan's)
B3_PLAN_FORMS = {"b3_rows_128": {"rows": 128}}
# (B, Lq, heads) of B7's causal forward: the text tower, a longer L
B7_SHAPES = ((15, 77, 8), (4, 1024, 8))
# (B, L, heads) of B7's fp32 causal forward: the text tower, a longer L
B7F_SHAPES = ((15, 77, 8), (4, 1024, 8))
ATTN_SHAPES = ((128, 197, 214, 12), (280, 197, 276, 12))
W8_SHAPES = ((25216, 768, 3072, "fc1"), (25216, 3072, 768, "fc2"))


def _build(name):
    from gava_clip_tpu_torch.ops import _cuda
    if name in PARENT_VARIANTS:
        path, edits, root = PARENT_VARIANTS[name], [], PARENT
        signatures = _PARENT_SIGNATURES.get(path) or \
            _cuda._SIGNATURES[_LIB[path]]
    elif name in PARENT_CUTS:
        (path, edits), root = PARENT_CUTS[name], PARENT
        signatures = _PARENT_SIGNATURES.get(path) or \
            _cuda._SIGNATURES[_LIB[path]]
    else:
        (path, edits), root = VARIANTS[name], ROOT
        signatures = _cuda._SIGNATURES[_LIB[path]]
    if path == _F32 and root == PARENT:
        signatures = {**signatures,
                      "streaming_attention_bwd_f32": _PARENT_F32_B7B}
    if path == _B5:
        # one library with B5's bf16 and fp32 entries (the functions a
        # parent's library lacks are left out below)
        signatures = {**signatures, **_cuda._SIGNATURES["w8a8_mlp_f32"]}
    with open(os.path.join(root, path)) as f:
        src = f.read()
    for old, new in edits:
        if old is None:   # B5's second pass, head to tail
            i, j = src.index(_B5_PASS2_HEAD), src.index(_B5_PASS2_TAIL)
            old = src[i:j + len(_B5_PASS2_TAIL)]
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs {src.count(old)} "
                               f"times in {path}")
        src = src.replace(old, new)
    # each variant in a directory of its own: a patched header there is the
    # one its source's quoted #include finds first
    d = os.path.join(ROOT, "_scratch", "variants", name)
    os.makedirs(d, exist_ok=True)
    cu, so = os.path.join(d, f"{name}.cu"), os.path.join(d, f"lib{name}.so")
    if path.endswith(".cuh"):
        with open(os.path.join(d, os.path.basename(path)), "w") as f:
            f.write(src)
        sources = [_LIB[path]] + (["w8a8_mlp_f32"] if path == _B5 else [])
        src = ""
        for source in sources:
            with open(os.path.join(root, os.path.dirname(path),
                                   source + ".cu")) as f:
                src += f.read()
    with open(cu, "w") as f:
        f.write(src)
    res = subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-I",
                          os.path.join(root, os.path.dirname(path)), "-o",
                          so, cu], capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed for {name}:\n{res.stderr}")
    lib = ctypes.CDLL(so)
    if path in (_B5, _B3, _F32):
        lib.ptxas_summary = _ptxas_summary(res.stdout + res.stderr)
    for fn, (argtypes, restype) in signatures.items():
        if path == _B5 and not hasattr(lib, fn):
            continue
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return name, lib


def _ptxas_summary(log):
    """Registers and spills of each kernel instantiation in an nvcc -Xptxas
    -v log (in the order compiled), and any line about wgmma."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line and entry:
            spill = line.strip()
        elif "Used" in line and "registers" in line and entry:
            regs = line.split("Used")[1].split("registers")[0].strip()
            # a mangled name's tail holds the kernel and its template
            # arguments (its head is the anonymous namespace)
            out.append(f"{entry[-60:]}: {regs} registers, {spill}")
            entry = None
        elif "wgmma" in line.lower():
            out.append(line.strip())
    return "; ".join(out)


# the paths that B10 and B7's backward sit on, end to end: chip_smoke's
# phases up to the fused-extras w8a8 forward at batch 16, and its training
# step at 16 x 8 (the lines of those phases are printed)
E2E_PHASES = ("phase_device", "phase_build", "phase_slice",
              "phase_w8a8_slice", "phase_w8a8_variants", "phase_train_slice")


def e2e() -> int:
    """The parent commit's tree (PARENT) and this one, each through
    E2E_PHASES of its own chip_smoke.py in a process of its own, in turns:
    parent, this tree, this tree, parent."""
    code = ("import sys, torch\nsys.path.insert(0, '.')\n"
            "import chip_smoke as cs\ncs.import_port()\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "state = {'profile_dir': None}\n"
            + "".join(f"cs.{ph}(state)\n" for ph in E2E_PHASES))
    rc = 0
    for label, tree in (("parent", PARENT), ("this tree", ROOT),
                        ("this tree", ROOT), ("parent", PARENT)):
        res = subprocess.run([sys.executable, "-c", code], cwd=tree,
                             capture_output=True, text=True)
        print(f"===== e2e, {label} ({tree}): exit code {res.returncode}",
              flush=True)
        for line in res.stdout.splitlines():
            if line.startswith(("[device] nvidia-smi", "[w8a8-slice]",
                                "[w8a8-variants]", "[train-slice]")):
                print("    " + line[:600], flush=True)
        if res.returncode:
            print(res.stderr[-3000:], flush=True)
            rc = 1
    return rc


def main(argv=None) -> int:
    """argv: name prefixes of the variants to build and time (all when
    none is given), e.g. `b7 b5`; or `e2e` alone (see e2e)."""
    prefixes = tuple(sys.argv[1:] if argv is None else argv)
    if prefixes == ("e2e",):
        return e2e()
    names = [n for n in (*VARIANTS, *PARENT_VARIANTS, *PARENT_CUTS)
             if not prefixes or n.startswith(prefixes)]
    sys.path.insert(0, ROOT)
    import torch
    import chip_smoke as cs
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    cs.import_port()
    state = {}
    cs.phase_device(state)
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(ex.map(_build, names))
    gen = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for B, Lq, Lk, H in ATTN_SHAPES if _any(libs, "b1_") else ():
        D = H * 64
        q, k, v = (torch.randn(B, L, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for L in (Lq, Lk, Lk))
        ref = fa.packed_attention_plain(q, k, v, H)
        o = torch.empty_like(q)
        den = torch.empty(B, Lq, H, device="cuda")
        for name, lib in libs.items():
            if not name.startswith("b1_"):
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
    for M, K, N, what in W8_SHAPES if _any(libs, "b9") else ():
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
    if _any(libs, "b7_"):
        _b7_variants(cs, fa, libs, gen, state)
    if _any(libs, "b5"):
        _b5_variants(cs, im, libs, gen, state)
    if _any(libs, "b3"):
        _b3_variants(cs, im, libs, gen, stream, state)
    if _any(libs, "b4"):
        _b4_variants(cs, fa, im, libs, gen, stream, state)
    if _any(libs, "b2"):
        _b2_variants(cs, im, libs, gen, state)
    if _any(libs, "mega"):
        _mega_variants(cs, libs, state)
    if _any(libs, "b10"):
        _b10_variants(cs, libs, gen, state)
    if _any(libs, "b7b"):
        _b7b_variants(cs, fa, libs, gen, state)
    if _any(libs, "f32b9"):
        _f32b9_variants(cs, im, libs, gen, stream, state)
    if _any(libs, "f32b7b"):
        _f32b7b_variants(cs, fa, libs, gen, state)
    if _any(libs, "f32b4") or _any(libs, "f32b11"):
        _f32b4_variants(cs, fa, im, libs, gen, state)
    if _any(libs, "f32b7f") or "b7f_parent" in libs:
        _f32b7f_variants(cs, fa, libs, gen, state)
    return 0


def _any(libs, prefix):
    return any(name.startswith(prefix) for name in libs)


def _b7_variants(cs, fa, libs, gen, state):
    """B7's causal forward, each variant against SDPA's forward, both
    captured in CUDA graphs (device time)."""
    import torch
    for B, L, H in B7_SHAPES:
        D = H * 64
        q, k, v = (torch.randn(B, L, D, generator=gen, device="cuda",
                               dtype=torch.bfloat16) for _ in range(3))
        ref = fa.streaming_attention_plain(q, k, v, H, True)[0]
        o = torch.empty_like(q)
        lse = torch.empty(B, H, L, device="cuda")
        sdpa = cs._sdpa_fwd(q, k, v, H, True)
        for name, lib in libs.items():
            if not name.startswith("b7_"):
                continue
            def call(lib=lib):
                # the current stream: a CUDA graph captures on its own
                err = lib.streaming_attention_fwd_bf16(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(),
                    o.data_ptr(), lse.data_ptr(), B, L, L, H, 64,
                    *fa._qkv_strides(q, k, v), 64 ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            far = ((o.float() - ref.float()).abs()
                   > 2 * cs.bf16_ulp(ref)).float().mean().item()
            r = cs._ratio_graphs(call, sdpa)
            print(f"[variants] {name} B={B} L={L} H={H} causal: "
                  f"outputs > 2 ulp from plain {far:.3e}; "
                  f"{r[0]:.5f} ms vs SDPA forward {r[1]:.5f} ms per call "
                  f"in CUDA graphs, ratio {r[2]:.3f} (rounds {r[3]:.3f}-"
                  f"{r[4]:.3f}) ({state['smi']})", flush=True)


def _b5_variants(cs, im, libs, gen, state):
    """B5 (the residual entry) in bf16 and in fp32 at B5_SHAPES: each
    variant's outputs against the parent's kernel (`b5_parent`, else the
    source as it is) bit for bit, and their share != plain; at the serving
    shape its time in CUDA graphs and in turns with that kernel there
    (median of 7 rounds)."""
    import torch
    base = "b5_parent" if "b5_parent" in libs else "b5_as_is"
    names = sorted((n for n in libs if n.startswith("b5")),
                   key=lambda n: (n != base, n))
    for name in names:
        print(f"[variants] {name} ptxas: {libs[name].ptxas_summary}",
              flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for M, K, Hd, N, fallback in B5_SHAPES:
        x32 = torch.randn(M, K, generator=gen, device="cuda")
        r32 = torch.randn(M, N, generator=gen, device="cuda")
        ln = [t.contiguous() for t in cs._ln_params(gen, K)]
        fc1 = {"kernel": cs._qleaf(gen, K, Hd),
               "bias": torch.randn(Hd, generator=gen, device="cuda") * 0.02}
        fc2 = {"kernel": cs._qleaf(gen, Hd, N),
               "bias": torch.randn(N, generator=gen, device="cuda") * 0.02}
        if fallback:
            cs._b5_fallback_rows(x32, fc1, ln)
        k1, k2, b1, b2 = fc1["kernel"], fc2["kernel"], fc1["bias"], fc2["bias"]
        s1, s2 = (k["scale"].reshape(-1).float().contiguous() for k in (k1, k2))
        label = f"M={M} K={K} H={Hd} N={N}" + (
            f" (rows {cs.B5_FALLBACK_ROWS} take the full first pass)"
            if fallback else "")
        for dt, entry in ((torch.bfloat16, "w8a8_mlp_res_bf16"),
                          (torch.float32, "w8a8_mlp_res_f32")):
            x, r = x32.to(dt), r32.to(dt)
            ref = im.w8a8_mlp_res_plain(x, fc1, fc2, ln, r)
            calls, outs = {}, {}
            for name in names:
                lib = libs[name]
                layout = im._MLP_LAYOUT[:5] + (B5_TILE2.get(name, 32768),)
                saved, im._MLP_LAYOUT = im._MLP_LAYOUT, layout
                try:
                    plan = im.w8a8_mlp_plan(M, K, Hd, N, sms, 232448)
                finally:
                    im._MLP_LAYOUT = saved
                hq = torch.empty(plan["scratch"], dtype=torch.int8,
                                 device="cuda")
                y = torch.empty(M, N, dtype=dt, device="cuda")

                def call(fn=getattr(lib, entry), plan=plan, hq=hq, y=y,
                         x=x, r=r, name=name):
                    err = fn(x.data_ptr(), k1["qa_t"].data_ptr(),
                             s1.data_ptr(), b1.data_ptr(),
                             k2["qa_t"].data_ptr(), s2.data_ptr(),
                             b2.data_ptr(), ln[0].data_ptr(),
                             ln[1].data_ptr(), r.data_ptr(), y.data_ptr(),
                             hq.data_ptr(), M, K, Hd, N, plan["rows"],
                             plan["stages2"], plan["smem_bytes"],
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: launch failed ({err})")
                call()
                torch.cuda.synchronize()
                calls[name], outs[name] = call, y
                share = (y != ref).float().mean().item()
                same = torch.equal(y, outs[base])
                print(f"[variants] {name} {entry} {label}: bit-equal to "
                      f"{base}: {same}; outputs != plain {share:.3e}",
                      flush=True)
            if fallback:
                continue
            for name, call in calls.items():
                print(f"[variants] {name} {entry} {label}: "
                      f"{_graph_ms(cs, call):.5f} ms in CUDA graphs of "
                      f"{cs.GRAPH_LAUNCHES} ({state['smi']})", flush=True)
                if name != base:
                    t = cs._ratio_graphs(call, calls[base])
                    print(f"[variants] {name} vs {base} {entry}, CUDA "
                          f"graphs, median of 7 rounds in turns: {t[0]:.5f} "
                          f"ms vs {t[1]:.5f} ms, ratio {t[2]:.3f} (rounds "
                          f"{t[3]:.3f}-{t[4]:.3f}) ({state['smi']})",
                          flush=True)
            del calls, outs


def _turns_vs(cs, calls, base, state):
    for name, call in calls.items():
        if name != base:
            t = cs._ratio_turns(call, calls[base])
            print(f"[variants] {name} vs {base}, median of 7 rounds in "
                  f"turns: {t[0]:.4f} ms vs {t[1]:.4f} ms, ratio {t[2]:.3f} "
                  f"(rounds {t[3]:.3f}-{t[4]:.3f}) ({state['smi']})",
                  flush=True)


def _parent_function(relpath, name, names):
    """Function `name` of the parent tree's module `relpath`, with the
    module-level constants and helpers `names` it reads (taken from its
    source; the module itself is not imported)."""
    import ast
    import typing
    with open(os.path.join(PARENT, relpath)) as f:
        tree = ast.parse(f.read())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name in (name, *names))
            or (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id in names)]
    env = {k: getattr(typing, k) for k in ("Dict", "Optional", "Sequence",
                                           "Tuple")}
    exec(compile(ast.Module(body=keep, type_ignores=[]), relpath, "exec"), env)
    return env[name]


def _b3_variants(cs, im, libs, gen, stream, state):
    """B3 at B3_SHAPES in bf16 and fp32: each variant's three outputs
    against those of the parent's kernel (`b3_parent`, launched with the
    parent's plan; else the source as it is) bit for bit, and their share
    != plain; its time in CUDA graphs and in turns with that kernel there
    (median of 7 rounds). The parent's cuts (`b3_split_*`) and `b3_parent`
    take the parent's entry points and plan, the others this tree's."""
    import torch
    base = "b3_parent" if "b3_parent" in libs else "b3_as_is"
    names = sorted((n for n in libs if n.startswith("b3")),
                   key=lambda n: (n != base, n))
    for name in names:
        print(f"[variants] {name} ptxas: {libs[name].ptxas_summary}",
              flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    parent_plan = None
    if any(n.startswith(("b3_parent", "b3_split")) for n in names):
        parent_plan = _parent_function(
            "gava_clip_tpu_torch/ops/int8_matmul.py", "w8a8_qkv_plan",
            ("_QKV_LAYOUT", "_QKV_ROWS", "_QKV_MIN_STAGES",
             "_SM90_SMEM_PER_SM", "_BLOCK_RESERVED_SMEM", "_round_up"))
    for B, Lx, Le, K, N, with_ln in B3_SHAPES + B3_RAGGED_SHAPES:
        M = B * (Lx + Le)
        timed = (B, Lx, Le, K, N, with_ln) in B3_SHAPES
        x32 = torch.randn(B, Lx, K, generator=gen, device="cuda")
        e32 = torch.randn(B, Le, K, generator=gen, device="cuda")
        ln = [t.contiguous() for t in cs._ln_params(gen, K)] if with_ln \
            else None
        k3 = [cs._qleaf(gen, K, N) for _ in range(3)]
        w3 = [im._tma_rows(k["qa_t"]) for k in k3]   # as the wrapper pads them
        b3 = [torch.randn(N, generator=gen, device="cuda") * 0.02
              for _ in range(3)]
        s3 = [k["scale"].reshape(-1).float().contiguous() for k in k3]
        label = f"B={B} Lx={Lx} Le={Le} K={K} N={N} LN {with_ln}"
        for dt in (torch.bfloat16, torch.float32):
            form = "bf16" if dt == torch.bfloat16 else "f32"
            x, e = x32.to(dt), e32.to(dt)
            ref = torch.cat(im.w8a8_matmul3_cat_plain(
                x, e if Le else None, k3, b3, ln), dim=-1)
            calls, outs = {}, {}
            for name in names:
                old = name.startswith(("b3_parent", "b3_split"))
                if old:
                    plan = parent_plan(M, K, N, sms, 232448)
                    rows = B3_PARENT_ROWS.get(name)
                    if rows and plan["rows"] == 128:
                        kp = -(-K // 128) * 128
                        plan = dict(plan, rows=rows,
                                    smem_bytes=plan["smem_bytes"]
                                    - (128 - rows) * (kp + 4))
                else:
                    pform = B3_PLAN_FORMS.get(name, {})
                    try:
                        plan = im.w8a8_qkv_plan(M, K, N, sms, 232448,
                                                esize=x.element_size(), **pform)
                    except ValueError:   # a form this shape does not take
                        plan = im.w8a8_qkv_plan(
                            M, K, N, sms, 232448, esize=x.element_size(),
                            **{k: v for k, v in pform.items() if k != "rows"})
                tail = (plan["rows"], plan["units"], plan["stages"],
                        plan["smem_bytes"])
                o3 = [torch.empty(B, Lx + Le, N, dtype=dt, device="cuda")
                      for _ in range(3)]

                def call(fn=getattr(libs[name], f"w8a8_qkv_cat_{form}"),
                         tail=tail, o3=o3, x=x, e=e, name=name):
                    err = fn(x.data_ptr(), e.data_ptr() if Le else None,
                             *(w.data_ptr() for w in w3),
                             *(t.data_ptr() for t in s3),
                             *(t.data_ptr() for t in b3),
                             ln[0].data_ptr() if ln else None,
                             ln[1].data_ptr() if ln else None,
                             *(o.data_ptr() for o in o3), B, Lx, Le, K, N,
                             *tail, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: launch failed ({err})")
                call()
                torch.cuda.synchronize()
                y = torch.cat(o3, dim=-1)
                calls[name], outs[name] = call, y
                share = (y != ref).float().mean().item()
                print(f"[variants] {name} {form} {label}: plan {plan}; "
                      f"bit-equal to {base}: {torch.equal(y, outs[base])}; "
                      f"outputs != plain {share:.3e}", flush=True)
            for name, call in calls.items() if timed else ():
                print(f"[variants] {name} {form} {label}: "
                      f"{_graph_ms(cs, call):.5f} ms in CUDA graphs of "
                      f"{cs.GRAPH_LAUNCHES} ({state['smi']})", flush=True)
                if name != base:
                    t = cs._ratio_graphs(call, calls[base])
                    print(f"[variants] {name} vs {base} {form} {label}, "
                          f"CUDA graphs, median of 7 rounds in turns: "
                          f"{t[0]:.5f} ms vs {t[1]:.5f} ms, ratio "
                          f"{t[2]:.3f} (rounds {t[3]:.3f}-{t[4]:.3f}) "
                          f"({state['smi']})", flush=True)
            del calls, outs


def _b4_variants(cs, fa, im, libs, gen, stream, state):
    """B4 at the serving shape (B 128, lq 197, Lk 214, 12 heads): each source
    variant held to the bits of the source as it is and timed in turns with
    it."""
    import torch
    B, lq, Lk, H = 128, 197, 214, 12
    D = H * 64
    bf = torch.bfloat16
    q, k, v = (torch.randn(B, Lk, D, generator=gen, device="cuda").to(bf)
               for _ in range(3))
    r = torch.randn(B, lq, D, generator=gen, device="cuda").to(bf)
    op = {"kernel": cs._qleaf(gen, D, D),
          "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
    sc = op["kernel"]["scale"].reshape(-1).float().contiguous()
    ref = fa.attention_out_int8_plain(q, k, v, H, op, r, lq)
    calls, outs = {}, {}
    for name, lib in sorted(libs.items(), key=lambda kv: kv[0] != "b4_as_is"):
        if not name.startswith("b4"):
            continue
        stages = B4_KV_STAGES.get(name, 4)
        rows = 112
        smem = (1024 + max(rows * D, stages * 18432) + 24576 + 4 * rows
                + 4 * stages * 64)
        o = torch.empty(B, lq, D, dtype=bf, device="cuda")
        a32 = torch.empty(B, -(-lq // rows) * rows, D, device="cuda")

        def call(lib=lib, smem=smem, o=o, a32=a32):
            err = lib.attention_out_int8_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(),
                op["kernel"]["qa_t"].data_ptr(), sc.data_ptr(),
                op["bias"].data_ptr(), r.data_ptr(), o.data_ptr(),
                a32.data_ptr(), B, lq, Lk, H, *fa._qkv_strides(q, k, v),
                64 ** -0.5 * fa._LOG2E, rows, smem, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")
        call()
        torch.cuda.synchronize()
        outs[name], calls[name] = o, call
        share = (o != ref).float().mean().item()
        same = torch.equal(o, outs["b4_as_is"])
        print(f"[variants] {name} B={B} lq={lq} Lk={Lk} H={H}: outputs "
              f"!= plain {share:.3e}, bit-equal to b4_as_is: {same}; "
              f"{cs.cuda_time_ms(call, iters=10):.4f} ms "
              f"({state['smi']})", flush=True)
    _turns_vs(cs, calls, "b4_as_is", state)



def _mega_variants(cs, libs, state):
    """The whole-layer kernel at the tool's shape (64 frame rows, its
    draws) and at the serving batch (128) through the tool's wrapper, each
    variant's library standing in for the built one: the parent's kernel
    (`mega_parent`, at its own plan), the source as it is at its plan and at
    each split of MEGA_SPLITS, held to the bits of the source as it is (the
    stopped ones are wrong on purpose; they run at 64 rows only), and timed
    in turns with the parent; the composition B3a + B4 + B5 in turns with
    the source as it is."""
    import numpy as np
    import torch
    from gava_clip_tpu_torch.ops import _cuda
    from gava_clip_tpu_torch.tools import bench_attn_variants as tool
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for frames in (64, 128):
        rs = np.random.RandomState(0)
        params = tool.params_to_port(*tool.make_params(rs), device="cuda")
        x, e = tool.make_inputs(rs, frames, device="cuda")
        calls, outs = {}, {}
        order = {"mega_parent": 0, "mega_as_is": 1}
        for name, lib in sorted(libs.items(),
                                key=lambda kv: order.get(kv[0], 2)):
            if not name.startswith("mega") or (
                    frames != 64 and "stages_to" in name):
                continue
            if name == "mega_parent":
                splits = (_parent_mega_split(frames, sms),)
            else:
                splits = MEGA_SPLITS.get(name, (2,))
            for split in splits:
                def call(lib=lib, split=split):
                    saved = _cuda._libs.get("mega_layer")
                    _cuda._libs["mega_layer"] = lib
                    try:
                        return tool.mega_layer_cuda(x, e, *params,
                                                    split=split)
                    finally:
                        if saved is None:
                            del _cuda._libs["mega_layer"]
                        else:
                            _cuda._libs["mega_layer"] = saved
                key = name if split is None else f"{name}_split_{split}"
                outs[key], calls[key] = call(), call
                torch.cuda.synchronize()
                same = torch.equal(outs[key], outs.get("mega_as_is",
                                                       outs[key]))
                print(f"[variants] {key} F={frames}: bit-equal to "
                      f"mega_as_is: {same}; "
                      f"{cs.cuda_time_ms(call, iters=10):.4f} ms "
                      f"({state['smi']})", flush=True)
        parent = next((k for k in calls if k.startswith("mega_parent")), None)
        if "mega_as_is" in calls:
            calls["base (B3a + B4 + B5)"] = \
                lambda: tool.base_layer(x, e, *params)
            _turns_vs(cs, {k: v for k, v in calls.items() if k != parent},
                      "mega_as_is", state)
        if parent and "mega_as_is" in calls:
            _turns_vs(cs, {k: calls[k] for k in (parent, "mega_as_is")},
                      parent, state)


# B2's shapes (M, K, N): the patch embed, then the w8a8 text tower's
# out-projection, fc1 and fc2 (15 prompts x 77 tokens)
B2_SHAPES = ((25088, 768, 768), (1155, 512, 512), (1155, 512, 2048),
             (1155, 2048, 512))
# B2's launch forms (rows per block, units per block) timed beside the
# plan's at the patch embed and at the text tower's rows
B2_FORMS = {25088: ((192, 6), (128, 6), (128, 3), (64, 6), (64, 3)),
            1155: ((64, 1), (64, 2), (32, 1), (32, 2), (32, 4), (16, 1),
                   (128, 1))}


def _b2_variants(cs, im, libs, gen, state):
    """B2 at the patch embed and the text tower's three shapes: the
    parent's kernel (`b2_parent`), the source as it is at its plan and in
    the forms of B2_FORMS, each held to the plain version's bits and timed
    by CUDA events and in CUDA graphs, against the parent in turns and
    against the int8 product alone through torch._int_mm."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf = torch.bfloat16
    for M, K, N in B2_SHAPES:
        x = (torch.randint(0, 256, (M, K), generator=gen, device="cuda")
             if M == 25088 else
             torch.randn(M, K, generator=gen, device="cuda")).to(bf)
        leaf = cs._qleaf(gen, K, N)
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        s = leaf["scale"].reshape(-1).float().contiguous()
        wt = leaf["qa_t"]
        ref = im.w8a8_matmul_plain(x, leaf, b)
        calls = {}
        for name, lib in sorted(libs.items(),
                                key=lambda kv: kv[0] != "b2_parent"):
            if not name.startswith("b2"):
                continue
            if name == "b2_parent":
                forms = {name: None}
            else:
                plan = im.w8a8_matmul_plan(M, K, N, sms, 232448)
                forms = {f"{name}_plan_{plan['rows']}_rows_{plan['units']}"
                         f"_units": plan}
                for rows, units in B2_FORMS[M]:
                    if (rows, units) == (plan["rows"], plan["units"]) or \
                            rows * K > 64 * 1024:   # 128 rows of K 2,048
                        continue
                    forms[f"{name}_{rows}_rows_{units}_units"] = \
                        im.w8a8_matmul_plan(M, K, N, sms, 232448, rows=rows,
                                            units=units)
            for label, plan in forms.items():
                y = torch.empty(M, N, dtype=bf, device="cuda")

                def call(lib=lib, plan=plan, y=y):
                    st = torch.cuda.current_stream().cuda_stream
                    form = () if plan is None else (
                        plan["rows"], plan["units"], plan["stages"],
                        plan["smem_bytes"])
                    err = lib.w8a8_matmul_bf16(
                        x.data_ptr(), wt.data_ptr(), s.data_ptr(),
                        b.data_ptr(), y.data_ptr(), M, K, N, *form, st)
                    if err:
                        raise RuntimeError(f"{label}: launch failed ({err})")
                    return y
                out = call()
                torch.cuda.synchronize()
                print(f"[variants] {label} M={M} K={K} N={N}: bit-equal to "
                      f"the plain version: {torch.equal(out, ref)} "
                      f"({state['smi']})", flush=True)
                calls[label] = call
        a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                          dtype=torch.int8)
        wk = wt.t()
        try:
            torch._int_mm(a, wk)
        except RuntimeError:
            wk = wk.contiguous()
        bound = cs._bound(2 * M * K + K * N + 8 * N + 2 * M * N,
                          ops_int8=2 * M * K * N)
        _report_times(cs, f"M={M} K={K} N={N}", calls,
                      lambda: torch._int_mm(a, wk), "torch._int_mm alone",
                      lambda: im.w8a8_matmul_plain(x, leaf, b),
                      f"{bound[0]:.5f} ms ({bound[1]})", state)


# B10 at the serving path's shape: (Bb, Tb, D, heads, G, le_pad), bf16 cls
# rows, fp32 weights
B10_SHAPE = (16, 8, 768, 12, 8, 17)
# B7's bf16 backward: (B, Lq, Lk, heads, causal) of the text tower, a 400^2
# frame row of the vision tower at 4 clips x 8 frames, and a long causal L;
# CUDA graphs of B7B_LAUNCHES[i] calls at each
B7B_SHAPES = ((15, 77, 77, 8, True), (32, 626, 643, 12, False),
              (4, 1024, 1024, 8, True))
B7B_LAUNCHES = (20, 2, 2)
# the 400^2 frame row's keys cut to 640 (five whole key tiles) and to 704
# (a sixth of 64): what its sixth tile of 3 keys costs
B7B_TAIL_SHAPES = ((32, 626, 640, 12), (32, 626, 704, 12))


# blocks a cluster B10's source as it is is timed at (the plan's first)
B10_CS = (8, 4, 2)


def _kernels_per_call(call):
    """The kernel launches of one call, by name, from a torch.profiler
    trace of the device. The profiler's schedule takes one call to warm up
    (a trace's first launch may be missed) and records the next."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    names = {}

    def ready(prof):
        for ev in prof.key_averages():
            if ev.device_type.name == "CUDA" and ev.count:
                names[ev.key[:48]] = ev.count

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=ready) as prof:
        for _ in range(2):
            call()
            torch.cuda.synchronize()
            prof.step()
    return f"device kernels of one call: {names or 'none in the trace'}"


def _graph_ms(cs, call, launches=None):
    """Device ms of one call: `launches` (GRAPH_LAUNCHES) calls in one CUDA
    graph, replayed 5 times after a warm-up."""
    launches = launches or cs.GRAPH_LAUNCHES
    return cs.cuda_time_ms(cs._graph_call(call, launches), iters=5) / launches


def _report_times(cs, label, calls, yard, yard_name, plain, bound, state,
                  launches=None):
    """Each call of `calls` and the yardstick (None: not measured) by CUDA
    events (host-launched, 20 calls) and in CUDA graphs of `launches`
    (GRAPH_LAUNCHES) calls; each call against the yardstick and against the
    first call in turns in CUDA graphs (median of 7 rounds); the plain
    version by events; the bound."""
    launches = launches or cs.GRAPH_LAUNCHES
    names = list(calls)
    for name in names + ([yard_name] if yard is not None else []):
        call = calls.get(name, yard)
        print(f"[variants] {name} {label}: {cs.cuda_time_ms(call):.5f} ms by "
              f"CUDA events, {_graph_ms(cs, call, launches):.5f} ms in CUDA "
              f"graphs of {launches} ({state['smi']})", flush=True)
    for name in names:
        if yard is None:
            break
        r = cs._ratio_graphs(calls[name], yard, launches)
        print(f"[variants] {name} vs {yard_name} {label}, CUDA graphs, "
              f"median of 7 rounds in turns: {r[0]:.5f} ms vs {r[1]:.5f} ms, "
              f"ratio {r[2]:.3f} (rounds {r[3]:.3f}-{r[4]:.3f}) "
              f"({state['smi']})", flush=True)
    for name in names[1:]:
        r = cs._ratio_graphs(calls[name], calls[names[0]], launches)
        print(f"[variants] {name} vs {names[0]} {label}, CUDA graphs, "
              f"median of 7 rounds in turns: {r[0]:.5f} ms vs {r[1]:.5f} "
              f"ms, ratio {r[2]:.3f} (rounds {r[3]:.3f}-{r[4]:.3f}) "
              f"({state['smi']})", flush=True)
    print(f"[variants] plain version {label}: {cs.cuda_time_ms(plain, iters=5):.5f}"
          f" ms by CUDA events; bound {bound} ({state['smi']})", flush=True)


def _b10_variants(cs, libs, gen, state):
    """B10 at the serving shape: each variant, through its library's entry
    point (the parent's own; the others at a cluster size of the plan),
    against the plain version (largest |diff| of e and summary) and timed against the stock ops it
    replaces, by CUDA events and in CUDA graphs."""
    import torch
    from gava_clip_tpu_torch.models.vision import VisionConfig, prompt_extras
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    Bb, Tb, D, H, G, le_pad = B10_SHAPE
    BT = Bb * Tb
    p, gp = cs._extras_params(gen, Tb, D, G, torch.float32, 1.0)
    x = torch.randn(BT, 5, D, generator=gen, device="cuda").to(torch.bfloat16)
    cls = x[:, 0]
    kw = dict(Tb=Tb, num_heads=H, le_pad=le_pad)
    e_ref, s_ref = ek.fused_extras_plain(cls, p, gp, **kw)
    cfg = VisionConfig(num_frames=Tb, feature_dim=D, heads=H,
                       use_summary_token=True, use_local_prompts=True,
                       use_global_prompts=True, num_global_prompts=G)

    def stock():
        extras, s_ = prompt_extras(p, gp, x, cfg)
        return torch.cat(extras, dim=1), s_

    calls = {}
    for name, lib in sorted(libs.items(), key=lambda kv: kv[0] != "b10_parent"):
        if not name.startswith("b10"):
            continue
        if name == "b10_parent":
            forms = {name: _b10_call(lib, cls, p, gp, B10_SHAPE)}
        else:
            # the plan's 8 blocks a cluster, and 4 and 2 (K split over fewer
            # blocks, fewer blocks in all)
            forms = {f"{name}_cs{cs_}": _b10_call(
                lib, cls, p, gp, B10_SHAPE, ek.fused_extras_plan(
                    Bb, Tb, D, H, lib.fused_extras_max_clusters(cs_, 0), cs_))
                for cs_ in (B10_CS if name == "b10_as_is" else (8,))}
        for label, call in forms.items():
            e, s_ = call()
            torch.cuda.synchronize()
            err = max((e.float() - e_ref.float()).abs().max().item(),
                      (s_.float() - s_ref.float()).abs().max().item())
            share = (e != e_ref).float().mean().item()
            again = call()
            torch.cuda.synchronize()
            same = torch.equal(e, again[0]) and torch.equal(s_, again[1])
            print(f"[variants] {label} Bb={Bb} Tb={Tb} D={D} H={H} G={G} "
                  f"le_pad={le_pad}: max |diff| from plain {err:.3e}, outputs "
                  f"of e != plain {share:.3e}; a second run the same bits: "
                  f"{same}; {_kernels_per_call(call)} ({state['smi']})",
                  flush=True)
            calls[label] = call
    # the wrapper as the serving path calls it (models/vision.py passes
    # g_prompts[i], a new view every forward): its host time a call, 200
    # calls back to back, against the kernel's device time in a graph
    gps = gp[None].expand(2, G, D).contiguous()
    for _ in range(20):
        ek.fused_extras_cuda(cls, p, gps[1], **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        ek.fused_extras_cuda(cls, p, gps[1], **kw)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    print(f"[variants] fused_extras_cuda, the wrapper as the serving path "
          f"calls it: {host_ms:.5f} ms of host time a call; the kernel "
          f"{_graph_ms(cs, lambda: ek.fused_extras_cuda(cls, p, gp, **kw)):.5f}"
          f" ms in CUDA graphs ({state['smi']})", flush=True)
    wb, ab = 4, 2
    fp32 = cs._bound(5 * D * D * wb + BT * D * ab * 2 + BT * le_pad * D * ab
                     + 4 * (7 + Tb + G) * D,
                     flops_fp32=2 * 5 * BT * D * D + 4 * Bb * Tb * Tb * D)
    # the same products as 3xTF32 on the tensor cores: three TF32 products
    # each, at 495 TFLOP/s
    tf32 = 3 * 2 * 5 * BT * D * D / 495e12 * 1e3
    _report_times(cs, f"Bb={Bb} Tb={Tb} D={D}", calls, stock, "stock ops",
                  lambda: ek.fused_extras_plain(cls, p, gp, **kw),
                  f"{fp32[0]:.5f} ms ({fp32[1]}, fp32); 3xTF32 products "
                  f"{tf32:.5f} ms", state)


def _b10_call(lib, cls, p, gp, shape, plan=None):
    """A call of a B10 entry point with its arguments prepared once: the
    parent's (plan None) or this tree's, launched by `plan`
    (ops.extras_kernel.fused_extras_plan, fp32 weights)."""
    import torch
    Bb, Tb, D, H, G, le_pad = shape
    a = p["summary_attn"]
    lins = [p["cls_proj"]] + [a[n] for n in ("q", "k", "v", "out")]
    ws = [l["kernel"].contiguous() for l in lins]
    bs = [l["bias"].float().contiguous() for l in lins]
    lns, lnb = (p["summary_ln"][n].float().contiguous()
                for n in ("scale", "bias"))
    lp = p["local_prompts"].reshape(Tb, D).float().contiguous()
    gpc = gp.float().contiguous()
    BT = Bb * Tb
    if plan is None:
        space, launch = (), ()
    else:
        space = (torch.empty(plan["workspace_floats"], device=cls.device),)
        launch = (plan["cs"], plan["clusters"])

    def call():
        e = torch.empty((BT, le_pad, D), dtype=cls.dtype, device=cls.device)
        s_ = torch.empty((BT, D), dtype=cls.dtype, device=cls.device)
        err = lib.fused_extras(
            cls.data_ptr(), cls.stride(0), ws[0].data_ptr(), bs[0].data_ptr(),
            lns.data_ptr(), lnb.data_ptr(), ws[1].data_ptr(),
            bs[1].data_ptr(), ws[2].data_ptr(), bs[2].data_ptr(),
            ws[3].data_ptr(), bs[3].data_ptr(), ws[4].data_ptr(),
            bs[4].data_ptr(), lp.data_ptr(), gpc.data_ptr(), e.data_ptr(),
            s_.data_ptr(), *(t.data_ptr() for t in space), Bb, Tb, G, D, H,
            le_pad, int(ws[0].dtype == torch.bfloat16),
            int(cls.dtype == torch.bfloat16), *launch,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"fused_extras: launch failed ({err})")
        return e, s_.reshape(Bb, Tb, D)
    return call


def _sdpa_flash_bwd(q, k, v, do, H, causal):
    """The backward op that SDPA's flash backend runs, called directly on the
    saved results of its forward (a yardstick only): unlike
    torch.autograd.grad, a CUDA graph can capture it on any stream."""
    import torch
    B, L, D = q.shape

    def heads(x):
        return x.view(B, x.shape[1], H, D // H).transpose(1, 2)

    qh, kh, vh, doh = (heads(x) for x in (q, k, v, do))
    out, lse, cq, ck, mq, mk, seed, off = \
        torch.ops.aten._scaled_dot_product_flash_attention(
            qh, kh, vh, 0.0, causal)[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        doh, qh, kh, vh, out, lse, cq, ck, mq, mk, 0.0, causal, seed, off)


def _b7b_variants(cs, fa, libs, gen, state):
    """B7's bf16 backward at B7B_SHAPES: the parent commit's form
    (`b7b_parent`: one launch up to 128 rows, else its dq and dk / dv
    mma.sync kernels) and this tree's (`b7b_as_is`: one launch, else the
    key groups on wgmma at every count of groups worth trying, the plan's
    own marked), the other variants in the plan's form, each held to the
    plain version (outputs that differ, and > 2 bf16 ulp, worst of dq, dk,
    dv) and run twice for the same bits, then timed by CUDA events and in
    CUDA graphs, against SDPA's flash backward op and against the first
    call (the parent's) in turns in CUDA graphs (median of 7 rounds); then
    `b7b_as_is` at B7B_TAIL_SHAPES."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = fa._SBWD_LAYOUT[0]
    for (B, Lq, Lk, H, causal), launches in zip(B7B_SHAPES, B7B_LAUNCHES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H} causal={causal}"
        q, do = (torch.randn(B, Lq, D, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, Lk, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = fa.streaming_attention_plain(q, k, v, H, causal)
        ref = fa.streaming_attention_bwd_plain(q, k, v, do, o, lse, H, causal)
        one = max(Lq, Lk) <= rows
        key_tiles = -(-Lk // fa._SBWD_LAYOUT[3])
        own = fa.streaming_bwd_plan(B, Lq, Lk, H, sms, causal=causal)
        calls = {}
        for name, lib in sorted(libs.items(),
                                key=lambda kv: kv[0] != "b7b_parent"):
            if not name.startswith("b7b"):
                continue
            if name == "b7b_parent":
                tails = {name: (1, own["smem_bytes"]) if one else (0, 0)}
                n_scratch = 0
            elif one:
                tails = {f"{name}_one_launch": (None, 1, 1, 1, 0, 0,
                                                own["smem_bytes"])}
                n_scratch = 0
            else:
                plans = {}
                for g in ((1, 2, 3, key_tiles, own["groups"])
                          if name == "b7b_as_is" else (own["groups"],)):
                    plan = fa.streaming_bwd_plan(B, Lq, Lk, H, sms,
                                                 groups=min(g, key_tiles),
                                                 causal=causal)
                    plans[plan["groups"]] = plan
                tails, n_scratch = {}, 0
                for g, plan in sorted(plans.items()):
                    tag = f"{name}_groups{g}" + (
                        "_plan" if g == own["groups"] else "")
                    tails[tag] = (None, 2, g, plan["tiles"], plan["lq_pad"],
                                  int(plan["acc_in_smem"]),
                                  plan["smem_bytes"])
                    n_scratch = max(n_scratch, plan["scratch_floats"])
            scratch = torch.empty(max(n_scratch, 1), device="cuda")
            for tag, tail in tails.items():
                grads = [torch.empty_like(x) for x in (q, k, v)]
                # this tree's entry takes the scratch after dv
                extra = () if name == "b7b_parent" else (scratch.data_ptr(),)
                tail = tail if name == "b7b_parent" else tail[1:]

                def call(lib=lib, tail=tail, grads=grads, extra=extra,
                         tag=tag):
                    err = lib.streaming_attention_bwd_bf16(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        *(g.data_ptr() for g in grads), *extra, B, Lq, Lk, H,
                        64, *fa._qkv_strides(q, k, v), 64 ** -0.5,
                        int(causal), *tail,
                        torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{tag}: launch failed ({err})")
                    return grads
                call()
                torch.cuda.synchronize()
                first = [g.clone() for g in grads]
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(first, grads))
                far = max(((g.float() - r.float()).abs()
                           > 2 * cs.bf16_ulp(r)).float().mean().item()
                          for g, r in zip(grads, ref))
                diff = max((g != r).float().mean().item()
                           for g, r in zip(grads, ref))
                print(f"[variants] {tag} {label}: outputs != plain "
                      f"{diff:.3e}, > 2 ulp from plain {far:.3e} (worst of "
                      f"dq, dk, dv); a second run the same bits: {same}; "
                      f"{_kernels_per_call(call)} ({state['smi']})",
                      flush=True)
                calls[tag] = call
        bound = cs._attention_bounds(B, Lq, Lk, H, causal)["bwd"]
        _report_times(cs, label, calls,
                      _sdpa_flash_bwd(q, k, v, do, H, causal),
                      "SDPA flash backward (aten op)",
                      lambda: fa.streaming_attention_bwd_plain(
                          q, k, v, do, o, lse, H, causal),
                      f"{bound[0]:.5f} ms ({bound[1]})", state,
                      launches=launches)
        del q, k, v, do, o, lse, ref, calls
        torch.cuda.empty_cache()
    lib = libs.get("b7b_as_is")
    for B, Lq, Lk, H in B7B_TAIL_SHAPES if lib is not None else ():
        D = H * 64
        q, do = (torch.randn(B, Lq, D, generator=gen, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn(B, Lk, D, generator=gen, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = fa.streaming_attention_plain(q, k, v, H, False)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        plan = fa.streaming_bwd_plan(B, Lq, Lk, H, sms)
        scratch = torch.empty(plan["scratch_floats"], device="cuda")

        def call(Lk=Lk, plan=plan):
            err = lib.streaming_attention_bwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                o.data_ptr(), lse.data_ptr(), *(g.data_ptr() for g in grads),
                scratch.data_ptr(), B, Lq, Lk, H, 64,
                *fa._qkv_strides(q, k, v), 64 ** -0.5, 0, 2, plan["groups"],
                plan["tiles"], plan["lq_pad"], int(plan["acc_in_smem"]),
                plan["smem_bytes"], torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"b7b_as_is: launch failed ({err})")
        print(f"[variants] b7b_as_is B={B} Lq={Lq} Lk={Lk} H={H} "
              f"({-(-Lk // fa._SBWD_LAYOUT[3])} key tiles of "
              f"{fa._SBWD_LAYOUT[3]}, {plan['groups']} group(s)): "
              f"{_graph_ms(cs, call, 2):.5f} ms in CUDA graphs of 2 "
              f"({state['smi']})", flush=True)
        del q, k, v, do, o, lse, grads, scratch


def _f32b9_variants(cs, im, libs, gen, stream, state):
    """B9 in fp32 at the w8 evaluation's four shapes, each variant in turns
    with torch.matmul on the dequantized fp32 weight (TF32 off), its
    largest error against W8_F32_REL of sum |x| |w|."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    for M, K, N, what in cs.W8_MATMUL_SHAPES[:4]:
        x = torch.randn(M, K, generator=gen, device="cuda")
        leaf = cs._w8_leaf(gen, K, N)
        ref = im.int8_matmul_plain(x, leaf["q"], leaf["scale"])
        w = im.dequant_weight(leaf["q"], leaf["scale"], torch.float32)
        spread = x.abs() @ w.abs()
        s = leaf["scale"].reshape(-1).float().contiguous()
        y = torch.empty(M, N, device="cuda")
        for name, lib in libs.items():
            if not name.startswith("f32b9"):
                continue

            def call(lib=lib):
                err = lib.w8_matmul_f32(x.data_ptr(), leaf["q_t"].data_ptr(),
                                        s.data_ptr(), y.data_ptr(), M, K, N,
                                        stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            rel = ((y - ref).abs() / spread).max().item() / cs.W8_F32_REL
            r = cs._ratio_turns(call, lambda: torch.matmul(x, w))
            print(f"[variants] {name} {what} M={M} K={K} N={N}: max |err| / "
                  f"(|x| @ |w|) {rel:.4f} x 2^-19; {r[0]:.4f} ms "
                  f"({2e-9 * M * K * N / r[0]:.1f} TFLOP/s) vs torch.matmul "
                  f"{r[1]:.4f} ms, ratio {r[2]:.3f} (rounds {r[3]:.3f}-"
                  f"{r[4]:.3f}) ({state['smi']})", flush=True)


# B7's fp32 backward: (B, Lq, Lk, H, causal) of the text tower, a 400^2
# frame row of the vision tower at 4 clips x 8 frames, and a long causal L;
# CUDA graphs of F32B7B_LAUNCHES[i] calls at each (the two long shapes'
# calls take milliseconds: no launch cost to hide)
F32B7B_SHAPES = ((15, 77, 77, 8, True), (32, 626, 643, 12, False),
                 (4, 1024, 1024, 8, True))
F32B7B_LAUNCHES = (20, 2, 2)
# the 400^2 frame row's keys cut to 640 (five whole key tiles of 128) and
# to 656 (a sixth of one warp's 16): what its sixth tile of 3 keys costs
F32B7B_TAIL_SHAPES = ((32, 626, 640, 12), (32, 626, 656, 12))


def _f32b7b_variants(cs, fa, libs, gen, state):
    """B7's fp32 backward at F32B7B_SHAPES: the parent commit's form
    (`f32b7b_parent`: one launch up to 128 rows, else its two FMA kernels)
    and this tree's (`f32b7b_as_is`) at every count of key-tile groups
    worth trying (1, 2, 3 or 4, and one a key tile; the plan's own marked),
    each held to the plain version (max err over the largest |gradient|,
    F32_REL) and run twice for the same bits, then timed by CUDA events and
    in CUDA graphs, against SDPA's fp32 backward op and against the first
    call (the parent where it is built) in turns in CUDA graphs (median of
    7 rounds)."""
    import torch
    print(f"[variants] f32b7b: torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}",
          flush=True)
    for name, lib in libs.items():
        if name.startswith("f32b7b"):
            print(f"[variants] {name} ptxas: {lib.ptxas_summary}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (B, Lq, Lk, H, causal), launches in zip(F32B7B_SHAPES,
                                                F32B7B_LAUNCHES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H} causal={causal}"
        q, do = (torch.randn(B, Lq, D, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(B, Lk, D, generator=gen, device="cuda")
                for _ in range(2))
        o, lse = fa.streaming_attention_plain(q, k, v, H, causal)
        want = fa.streaming_attention_bwd_plain(q, k, v, do, o, lse, H,
                                                causal)
        key_tiles = -(-Lk // (fa._F32_LAYOUT[11] if max(Lq, Lk) <= fa._F32_LAYOUT[11]
                              else fa._F32_LAYOUT[0]))
        own = fa.attention_f32_plan(B, Lq, Lk, H, packed=False,
                                    sm_count=sms,
                                    causal=causal)["bwd"]["groups"]
        calls = {}
        for name, lib in sorted(libs.items(),
                                key=lambda kv: kv[0] != "f32b7b_parent"):
            if not name.startswith("f32b7b"):
                continue
            if name == "f32b7b_parent":
                one = max(Lq, Lk) <= fa._F32_LAYOUT[11]
                plan = fa.attention_f32_plan(B, Lq, Lk, H, packed=False,
                                             groups=1)["bwd"]
                tails = {name: (1, plan["lq_pad"], plan["smem_bytes"])
                         if one else (0, 0, 0)}
                n_scratch = 2 * B * H * Lq
            else:
                tails, n_scratch = {}, 1
                plans = {}
                for g in ((1, 2, 3, 4, key_tiles, own)
                          if name == "f32b7b_as_is" else (own,)):
                    plan = fa.attention_f32_plan(
                        B, Lq, Lk, H, packed=False, sm_count=sms,
                        groups=min(g, key_tiles))["bwd"]
                    plans[plan["groups"]] = plan
                for g, plan in sorted(plans.items()):
                    tag = f"{name}_groups{g}" + ("_plan" if g == own else "")
                    tails[tag] = (g, plan["lq_pad"], plan["grid"],
                                  int(plan["acc_in_smem"]),
                                  plan["smem_bytes"])
                    n_scratch = max(n_scratch, plan["scratch_floats"])
            scratch = torch.empty(n_scratch, device="cuda")
            for tag, tail in tails.items():
                grads = [torch.empty_like(x) for x in (q, k, v)]

                def call(lib=lib, tail=tail, grads=grads, scratch=scratch,
                         tag=tag):
                    stream = torch.cuda.current_stream().cuda_stream
                    err = lib.streaming_attention_bwd_f32(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), o.data_ptr(), lse.data_ptr(),
                        *(g.data_ptr() for g in grads), scratch.data_ptr(),
                        B, Lq, Lk, H, 64, *fa._qkv_strides(q, k, v),
                        64 ** -0.5, int(causal), *tail, stream)
                    if err:
                        raise RuntimeError(f"{tag}: launch failed ({err})")
                call()
                torch.cuda.synchronize()
                first = [g.clone() for g in grads]
                call()
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(first, grads))
                err = max(((g - r).abs() / r.abs().max()).max().item()
                          for g, r in zip(grads, want))
                print(f"[variants] {tag} {label}: max err / scale {err:.3e} "
                      f"(limit {cs.F32_REL:.3e}), the same bits twice: "
                      f"{same} {'ok' if err <= cs.F32_REL and same else 'FAIL'}",
                      flush=True)
                calls[tag] = call
        yard = cs._sdpa_bwd_op(q, k, v, do, H, causal)
        bounds = [cs._attention_bounds(B, Lq, Lk, H, causal, esize=4,
                                       tf32=t)["bwd"] for t in (True, False)]
        bound = (f"{bounds[0][0]:.4f} ms as 3xTF32 ({bounds[0][1]}), "
                 f"{bounds[1][0]:.4f} ms as fp32 FMA ({bounds[1][1]})")
        plain = lambda: fa.streaming_attention_bwd_plain(  # noqa: E731
            q, k, v, do, o, lse, H, causal)
        _report_times(cs, label, calls, yard, "SDPA's fp32 backward op",
                      plain, bound, state, launches=launches)
        del q, k, v, do, o, lse, want, calls, yard
        torch.cuda.empty_cache()
    lib = libs.get("f32b7b_as_is")
    for B, Lq, Lk, H in F32B7B_TAIL_SHAPES if lib is not None else ():
        D = H * 64
        q, do = (torch.randn(B, Lq, D, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn(B, Lk, D, generator=gen, device="cuda")
                for _ in range(2))
        o, lse = fa.streaming_attention_plain(q, k, v, H, False)
        grads = [torch.empty_like(x) for x in (q, k, v)]
        plan = fa.attention_f32_plan(B, Lq, Lk, H, packed=False,
                                     sm_count=sms)["bwd"]
        scratch = torch.empty(max(plan["scratch_floats"], 1), device="cuda")

        def call(Lk=Lk, plan=plan):
            err = lib.streaming_attention_bwd_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                o.data_ptr(), lse.data_ptr(), *(g.data_ptr() for g in grads),
                scratch.data_ptr(), B, Lq, Lk, H, 64,
                *fa._qkv_strides(q, k, v), 64 ** -0.5, 0, plan["groups"],
                plan["lq_pad"], plan["grid"], int(plan["acc_in_smem"]),
                plan["smem_bytes"], torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"f32b7b_as_is: launch failed ({err})")
        print(f"[variants] f32b7b_as_is B={B} Lq={Lq} Lk={Lk} H={H} "
              f"({-(-Lk // fa._F32_LAYOUT[0])} key tiles of "
              f"{fa._F32_LAYOUT[0]}, "
              f"{plan['groups']} group(s)): "
              f"{_graph_ms(cs, call, 2):.5f} ms in CUDA graphs of 2 "
              f"({state['smi']})", flush=True)
        del q, k, v, do, o, lse, grads, scratch


def _f32b7f_variants(cs, fa, libs, gen, state):
    """B7's fp32 causal forward at B7F_SHAPES: each library's entry
    (`f32b7f_*` of this tree, `b7f_parent` of the parent's tree) held to the
    plain version (max err / the scale sum p |v|, F32_REL; lse within
    F32_LSE_ABS), then timed by CUDA events and in CUDA graphs, against
    SDPA's fp32 forward and against the first of them (the parent where it
    is built) in turns in CUDA graphs (median of 7 rounds)."""
    import torch
    for B, L, H in B7F_SHAPES:
        D = H * 64
        q, k, v = (torch.randn(B, L, D, generator=gen, device="cuda")
                   for _ in range(3))
        ref, lse_ref = fa.streaming_attention_plain(q, k, v, H, True)
        spread = fa.streaming_attention_plain(q, k, v.abs(), H, True)[0]
        label = f"B={B} L={L} H={H} causal"
        calls = {}
        for name in sorted((n for n in libs if n.startswith(("f32b7f",
                                                              "b7f_parent"))),
                           key=lambda n: n != "b7f_parent"):
            o = torch.empty_like(q)
            lse = torch.empty(B, H, L, device="cuda")

            def call(lib=libs[name], o=o, lse=lse, name=name):
                err = lib.streaming_attention_f32(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    lse.data_ptr(), B, L, L, H, 64, *fa._qkv_strides(q, k, v),
                    o.stride(0), o.stride(1), 64 ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            err = ((o - ref).abs() / spread).max().item()
            lse_err = (lse - lse_ref).abs().max().item()
            ok = err <= cs.F32_REL and lse_err <= cs.F32_LSE_ABS
            regs = [s for s in libs[name].ptxas_summary.split("; ")
                    if "packed_fwd" in s or "stream_fwd" in s]
            print(f"[variants] {name} {label}: max err / scale {err:.3e}, "
                  f"max |lse - plain| {lse_err:.3e} "
                  f"{'ok' if ok else 'FAIL'}; ptxas {regs}", flush=True)
            calls[name] = call
        bound = cs._attention_bounds(B, L, L, H, True, esize=4,
                                     tf32=True)["fwd_stat"]
        _report_times(cs, label, calls, cs._sdpa_fwd(q, k, v, H, True),
                      "sdpa_fp32_forward",
                      lambda: fa.streaming_attention_plain(q, k, v, H, True),
                      f"{bound[0]:.5f} ms ({bound[1]}, 3xTF32)", state)
        if "b7f_parent" in libs and L <= 128:
            _b7f_host_vs_parent(cs, fa, libs["b7f_parent"], q, k, v, H,
                                label, state)


def _b7f_host_vs_parent(cs, fa, lib, q, k, v, H, label, state):
    """The host time of a call of B7's fp32 forward through this tree's
    wrapper and through the parent commit's path into its own kernel (the
    same argument checks, then the plan, the stream object and a device
    context each call, the library and its layout looked up), on the host
    clock and by CUDA events, in turns (median of 7 rounds)."""
    import torch
    from gava_clip_tpu_torch.ops._cuda import load_library
    B, Lq, D = q.shape
    Lk = k.shape[1]
    counts = {"b7f_parent": 0}

    def parent():
        fa._check_kernel_args(q, k, v, H)
        if k.shape[1] == 0 or q.dtype != torch.float32:
            raise ValueError("not the fp32 streaming path")
        out = torch.empty((B, Lq, D), dtype=q.dtype, device=q.device)
        lse = torch.empty((B, H, Lq), dtype=torch.float32, device=q.device)
        fa.attention_f32_plan(B, Lq, Lk, H, 64, packed=False)
        fa._check_layout("attention_f32", load_library("attention_f32"),
                         "attention_f32_layout", fa._F32_LAYOUT)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        with torch.cuda.device(q.device):
            err = lib.streaming_attention_f32(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, Lq, Lk, H, 64, *fa._qkv_strides(q, k, v),
                out.stride(0), out.stride(1), 64 ** -0.5, 1, stream)
        if err:
            raise RuntimeError(f"b7f_parent: launch failed ({err})")
        counts["b7f_parent"] += 1
        return out, lse

    def wrapper():
        return fa.streaming_attention_cuda(q, k, v, H, True)
    a, b = [], []
    for _ in range(7):
        a.append(cs._host_ms(wrapper))
        b += [cs._host_ms(parent), cs._host_ms(parent)]
        a.append(cs._host_ms(wrapper))
    a, b = sorted(a), sorted(b)
    ev = cs._ratio_turns(wrapper, parent)
    print(f"[variants] host ms a call {label} (100 enqueued back to back, "
          f"host clock, median of 7 rounds in turns): the wrapper "
          f"{a[len(a) // 2]:.5f} ({a[0]:.5f}-{a[-1]:.5f}), the parent's path "
          f"{b[len(b) // 2]:.5f} ({b[0]:.5f}-{b[-1]:.5f}); by CUDA events, "
          f"median of 7 rounds in turns: {ev[0]:.5f} ms vs {ev[1]:.5f} ms, "
          f"ratio {ev[2]:.3f} (rounds {ev[3]:.3f}-{ev[4]:.3f}) "
          f"({state['smi']})", flush=True)


def _f32b4_variants(cs, fa, im, libs, gen, state):
    """The attention of B4 (`f32b4*`) and B11 (`f32b11*`) in fp32 at the
    fp32 w8a8 evaluation's shape (F32_B4_SHAPES[0]): each library's entry
    (packed_attention_fma_f32 / packed_attention_qk8_f32) into a scratch,
    then this tree's B2 fp32 launch with the residual, held to the plain
    version within F32_W8A8_LIMITS (its text: the shares != plain and
    beyond 2 ulp); the attention launches alone in CUDA graphs, this tree's
    against the parent's and each against SDPA's fp32 forward, in turns
    (median of 7 rounds)."""
    import torch
    B, lq, Lq, Lk, H = cs.F32_B4_SHAPES[0]
    D = H * 64
    q, k, v = (torch.randn(B, L, D, generator=gen, device="cuda")
               for L in (Lq, Lk, Lk))
    op = {"kernel": cs._qleaf(gen, D, D),
          "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
    r = torch.randn(B, lq, D, generator=gen, device="cuda")
    sdpa = cs._sdpa_fwd(q[:, :lq], k, v, H)
    label = f"B={B} lq={lq} Lk={Lk} H={H}"
    for form, int8_qk in (("f32b4", False), ("f32b11", True)):
        name = "attention_out_int8_qk8_f32" if int8_qk \
            else "attention_out_int8_f32"
        entry = "packed_attention_qk8_f32" if int8_qk \
            else "packed_attention_fma_f32"
        c = 64 ** -0.5 * fa._LOG2E / (127.0 * 127.0 if int8_qk else 1.0)
        ref = fa.attention_out_int8_plain(q, k, v, H, op, r, lq, int8_qk)
        xs = im.quant_rows(fa._onepass_attention_den_f32(
            q[:, :lq], k, v, H, int8_qk=int8_qk)[0])[1]
        unit = cs._flip_unit(xs, op["kernel"]["scale"])
        calls = {}
        for vname in sorted((n for n in libs if n in (form, form + "_parent")),
                            key=lambda n: n.endswith("_parent")):
            a = torch.empty(B, lq, D, device="cuda")

            def call(lib=libs[vname], a=a, vname=vname):
                err = getattr(lib, entry)(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), a.data_ptr(), B,
                    lq, Lk, H, 64, *fa._qkv_strides(q, k, v), a.stride(0),
                    a.stride(1), c, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{vname}: launch failed ({err})")
            call()
            out = im._w8a8_matmul_launch(
                "f32", a.view(B * lq, D), op["kernel"], op["bias"],
                r.reshape(B * lq, D)).view(B, lq, D)
            torch.cuda.synchronize()
            ok, _, text = cs._check_w8a8_f32(name, out, ref, unit, r)
            print(f"[variants] {vname} {label}: the whole op ({entry}, then "
                  f"B2 fp32) against its plain version: {text} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            g = cs._ratio_graphs(call, sdpa)
            print(f"[variants] {vname} {label}: its attention launch vs "
                  f"SDPA's fp32 forward, CUDA graphs of {cs.GRAPH_LAUNCHES} "
                  f"calls, median of 7 rounds in turns: {g[0]:.5f} ms vs "
                  f"{g[1]:.5f} ms, ratio {g[2]:.3f} (rounds {g[3]:.3f}-"
                  f"{g[4]:.3f}) ({state['smi']})", flush=True)
            calls[vname] = call
        if len(calls) == 2:
            g = cs._ratio_graphs(calls[form], calls[form + "_parent"])
            print(f"[variants] {form} vs {form}_parent {label}: the attention "
                  f"launches in CUDA graphs of {cs.GRAPH_LAUNCHES} calls, "
                  f"median of 7 rounds in turns: {g[0]:.5f} ms vs {g[1]:.5f} "
                  f"ms, ratio {g[2]:.3f} (rounds {g[3]:.3f}-{g[4]:.3f}) "
                  f"({state['smi']})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
