"""Show that the on-card checks reject a kernel with a moved rounding point
or a wrong bound: build deliberately broken copies of a kernel source and
run the check phase of chip_smoke.py on each.

    python3 -m gava_clip_tpu_torch.utils.kernel_mutants [b2 b7 b5 b3 b4 b10 mega f32]   # repo root, on a card

Each mutant is a copy of the package and of chip_smoke.py under
`_scratch/mut_<name>/` (gitignored) with one source patched; the copy
builds into its own `_build/` (a copy of the real one, whose libraries it
reuses where their sources and headers are unchanged: a build's name
carries their hash), so the real build is never touched. A mutant is
rejected when its phase raises and a check on the kernel under test
reports FAIL; those lines are printed. The script exits 1 if a mutant is
not rejected. The fp32 mutants (`f32_*` of the attention kernels, `f32w8_*`
of the w8a8 kernels, `f32b9_*`, `f32b11_*`, `f32b12_*` of the fp32 serving
forms) are also run by chip_smoke.py's f32-mutants phase, all at once.
"""

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_BWD = "gava_clip_tpu_torch/csrc/packed_attention_bwd.cuh"
_B12 = "gava_clip_tpu_torch/csrc/attention_out_int8.cu"
_B9 = "gava_clip_tpu_torch/csrc/w8_matmul.cu"
_B1 = "gava_clip_tpu_torch/csrc/packed_attention.cu"
_W8A8 = "gava_clip_tpu_torch/csrc/w8a8_common.cuh"
_WG = "gava_clip_tpu_torch/csrc/w8a8_wgmma.cuh"
_B7 = "gava_clip_tpu_torch/csrc/streaming_attention.cu"
_B5 = "gava_clip_tpu_torch/csrc/w8a8_mlp.cuh"
_B4 = _B12
_B3 = "gava_clip_tpu_torch/csrc/w8a8_qkv.cu"
# w8a8_qkv.cu's TMA stores of a unit's staging tile
_B3_STORES = ("      if (ct % 128 == 0) {\n"
              "        const CUtensorMap* map = w == 0 ? &yq : (w == 1 ? &yk : &yv);\n"
              "#pragma unroll\n"
              "        for (int b = 0; b < kBoxes; ++b)\n"
              "          tma_store(map, stg + b * BM * 128, (u % NS) * kUnitCols + wg * 64 + "
              "b * kBoxCols, m0);\n"
              "        bulk_commit();\n"
              "      }\n")
_MEGA = "gava_clip_tpu_torch/csrc/mega_layer.cu"
_B10 = "gava_clip_tpu_torch/csrc/fused_extras.cu"
_B7B = "gava_clip_tpu_torch/csrc/attention_bwd.cuh"
_F32 = "gava_clip_tpu_torch/csrc/attention_f32.cu"
_B9F32 = "gava_clip_tpu_torch/csrc/w8_matmul_f32.cu"
_ROUND = "__bfloat162float(__float2bfloat16({}))"
# an fp32 value with its 13 low mantissa bits cut: what a TF32 tensor-core
# product reads of an fp32 operand
_TF32 = "__uint_as_float(__float_as_uint({}) & 0xffffe000u)"
# attention_f32.cu's 3xTF32 step, and the same as one TF32 product
_3XTF32 = ("  tf32::mma_tf32_z(p, al, bh0, bh1);\n"
           "  tf32::mma_tf32(p, ah, bl0, bl1);\n"
           "  tf32::mma_tf32(p, ah, bh0, bh1);\n")
_1XTF32 = "  tf32::mma_tf32_z(p, ah, bh0, bh1);\n"
# w8_matmul_f32.cu's 3xTF32 step (three wgmma), and the same as one TF32
# product
_B9_3XTF32 = ("  tf32::wgmma_tf32_z(f, al, bh);   // lo_x hi_w\n"
              "  tf32::wgmma_tf32(f, ah, bl);     // hi_x lo_w\n"
              "  tf32::wgmma_tf32(f, ah, bh);     // hi_x hi_w\n")
_B9_1XTF32 = "  tf32::wgmma_tf32_z(f, ah, bh);   // hi_x hi_w\n"
# name -> (source, [(old, new)], chip_smoke phase, word that marks the
# kernel's lines)
MUTANTS = {
    # B8: the rebuilt output rounded to bf16 before delta, as the
    # saved-residual backward reads it
    "b8_o_rounded": (
        _BWD, [(f"(n[{i}] * inv{i // 2})",
                _ROUND.format(f"n[{i}] * inv{i // 2}")) for i in range(4)],
        "phase_train_kernels", "recompute"),
    # B8: the denominator summed from the unrounded e
    "b8_den_unrounded": (
        _BWD, [("rsum[0] += lo_f(p01) + hi_f(p01);", "rsum[0] += e[0] + e[1];"),
               ("rsum[1] += lo_f(p23) + hi_f(p23);", "rsum[1] += e[2] + e[3];")],
        "phase_train_kernels", "recompute"),
    # B6b (and B8, which shares the kernel): do not multiplied by inv_d
    # before the dv product
    "b6b_do_unscaled": (
        _BWD, [("cvt_pack(lo_f(w[4 * v8 + i]) * st, hi_f(w[4 * v8 + i]) * st)",
                "cvt_pack(lo_f(w[4 * v8 + i]), hi_f(w[4 * v8 + i]))")],
        "phase_train_kernels", "packed_attention_bwd"),
    # the second source one key short
    "b12_len_off_by_one": (
        _B12, [("  const int Lk = L1 + L2;\n", "  const int Lk = L1 + L2 - 1;\n")],
        "phase_w8a8_kernels", "2src"),
    # B9: the weights cast to bf16 unscaled and the scale applied to the
    # fp32 sum, y = bf16(scale * sum x * bf16(W))
    "b9_scale_after_product": (
        _B9, [("load_a(a[0], smem + ring.stage * kStageBytes + kXBytes, slab, "
               "lane, s0, s1);",
               "load_a(a[0], smem + ring.stage * kStageBytes + kXBytes, slab, "
               "lane, 1.f, 1.f);"),
              ("load_a(a[CUR ^ 1], r.smem + next * kStageBytes + kXBytes, "
               "slab, lane, s0, s1);",
               "load_a(a[CUR ^ 1], r.smem + next * kStageBytes + kXBytes, "
               "slab, lane, 1.f, 1.f);"),
              ("__float2bfloat16(acc[4 * c + 2 * h + e]);",
               "__float2bfloat16(acc[4 * c + 2 * h + e] * (h ? s1 : s0));")],
        "phase_w8_kernels", "int8_matmul"),
    # B1 (and B6a, the same kernel): the denominator summed from the
    # unrounded e
    "b1_den_unrounded": (
        _B1, [("        // the denominators: the same weights against a "
               "column of ones\n        mma(dsum, pa[kc], kOnes, kOnes);\n",
               ""),
              ("const uint32_t p = cvt_pack(e[0], e[1]);\n",
               "const uint32_t p = cvt_pack(e[0], e[1]);\n"
               "        dsum[2 * h] += e[0];\n        dsum[2 * h] += e[1];\n"),
              ("  for (int h = 0; h < 2; ++h) rsum[h] = dsum[2 * h];\n",
               "  for (int h = 0; h < 2; ++h) {\n    rsum[h] = dsum[2 * h] + "
               "__shfl_xor_sync(0xffffffffu, dsum[2 * h], 1);\n    rsum[h] "
               "+= __shfl_xor_sync(0xffffffffu, rsum[h], 2);\n  }\n")],
        "phase_kernel", "[kernel]"),
    # B2 at K > 1,024: the row's absmax over its first 1,024 values only
    "b2_absmax_first_1024": (
        _W8A8, [("  for (int c0 = 8 * lane; c0 < K; c0 += 256) {",
                 "  for (int c0 = 8 * lane; c0 < min(K, 1024); c0 += 256) {")],
        "phase_w8a8_kernels", "w8a8_matmul M="),
    # B2: the epilogue's scale and bias as one FMA (one rounding where the
    # plain version takes two)
    "b2_epilogue_fma": (
        _WG, [("  const float v0 = epilogue(a0, x0, s, b);",
               "  const float v0 = fmaf(__fmul_rn(__int2float_rn(a0), x0), s, b);")],
        "phase_w8a8_kernels", "w8a8_matmul M="),
    # the second source's values read one row early
    "b12_second_source_row_shift": (
        _B12, [("which ? v2b + static_cast<long long>(j - p.s2.L1) * "
                "p.s2.v2_sl",
                "which ? v2b + static_cast<long long>(j - p.s2.L1 > 0 ? "
                "j - p.s2.L1 - 1 : 0) * p.s2.v2_sl")],
        "phase_w8a8_kernels", "2src"),
    # B7 forward: the row sum taken from bf16(p), the AV product's weights,
    # instead of the fp32 p
    "b7_sum_of_rounded_p": (
        _B7, [("          l[sl][j] += p0;\n          l[sl][j] += p1;\n"
               "          pa[sl][n / 2][(n % 2) * 2 + j] = cvt_pack(p0, p1);\n",
               "          pa[sl][n / 2][(n % 2) * 2 + j] = cvt_pack(p0, p1);\n"
               "          l[sl][j] += attn::lo_f(pa[sl][n / 2][(n % 2) * 2 + j]);"
               "\n          l[sl][j] += attn::hi_f(pa[sl][n / 2][(n % 2) * 2 + j]);"
               "\n")],
        "phase_train_kernels", "streaming_attention B="),
    # B5: the fp32 hidden rounded to bf16 before the requant: its absmax
    # (QuickGELU of the largest pre-activation, and the full first pass)
    # and its codes
    "b5_hidden_bf16": (
        _B5, [("const float a = qgelu(__uint_as_float(amax[rr]));",
               "const float a = " + _ROUND.format(
                   "qgelu(__uint_as_float(amax[rr]))") + ";"),
              ("if constexpr (FULL) v = fabsf(qgelu(v));",
               "if constexpr (FULL) v = fabsf(" + _ROUND.format("qgelu(v)")
               + ");"),
              ("static_cast<uint8_t>(quant_code_fadd(v, inv))",
               "static_cast<uint8_t>(quant_code_fadd(" + _ROUND.format("v")
               + ", inv))")],
        "phase_w8a8_kernels", "w8a8_mlp_res M="),
    # B5: each row's largest pre-activation (and, in the full first pass,
    # its absmax) over the first 64-column slab of h only
    "b5_absmax_first_slab": (
        _B5, [("mx[2 * c + e] = fmaxf(mx[2 * c + e], v);",
               "if (ch == 0 && wg == 0) mx[2 * c + e] = fmaxf(mx[2 * c + e], "
               "v);")],
        "phase_w8a8_kernels", "w8a8_mlp_res M="),
    # B5: the absmax always QuickGELU of the largest pre-activation, however
    # small (no block takes the full first pass): the rows of chip_smoke's
    # fallback shape, every pre-activation negative, are quantized against
    # a negative absmax
    "b5_no_fallback": (
        _B5, [("if (m0 + rr < p.M && !(a >= kQStar)) full_first_pass = 1;", "")],
        "phase_w8a8_kernels", "w8a8_mlp_res M="),
    # B3: each row's scale from the absmax of its first 64 columns (the
    # shared row quant as B3's phase 0 runs it, in both the forms that read
    # 8 values a load and a value a load; B2 and B5 take it too)
    "b3_scale_first_64_columns": (
        _W8A8, [("      for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(v[i][j]));",
                 "      for (int j = 0; j < 8; ++j)\n"
                 "        if (i == 0 && lane < 8) m = fmaxf(m, fabsf(v[i][j]));"),
                ("  for (int i = 0; i < kMaxRowPerLane; ++i) m = fmaxf(m, "
                 "fabsf(v[i]));",
                 "  for (int i = 0; i < 2; ++i) m = fmaxf(m, fabsf(v[i]));")],
        "phase_w8a8_kernels", "w8a8_matmul3_cat B="),
    # B3: each unit's staging tile stored one phase early, before the
    # warpgroup writes it: the output columns get the tile's previous
    # contents (the unit before, or nothing yet)
    "b3_tile_stored_before_written": (
        _B3, [("      if (ct % 128 == 0) bulk_wait_read();\n      named_sync(1 + wg, 128);\n",
               "      if (ct % 128 == 0) bulk_wait_read();\n      named_sync(1 + wg, 128);\n"
               + _B3_STORES),
              (_B3_STORES + "    } else if", "    } else if")],
        "phase_w8a8_kernels", "w8a8_matmul3_cat B="),
    # B3: the block's last unit never stored (its TMA stores dropped)
    "b3_last_unit_dropped": (
        _B3, [("      if (ct % 128 == 0) {\n        const CUtensorMap* map",
               "      if (ct % 128 == 0 && u + 1 < u1) {\n        const CUtensorMap* map")],
        "phase_w8a8_kernels", "w8a8_matmul3_cat B="),
    # B4: each row's absmax over the first 4 heads only
    "b4_absmax_first_4_heads": (
        _B4, [("          rmax[0] = fmaxf(rmax[0], fmaxf(fabsf(v0.x), fabsf(v0.y)));\n",
               "          if (head < 4) rmax[0] = fmaxf(rmax[0], fmaxf(fabsf(v0.x), "
               "fabsf(v0.y)));\n"),
              ("          rmax[1] = fmaxf(rmax[1], fmaxf(fabsf(v1.x), fabsf(v1.y)));\n",
               "          if (head < 4) rmax[1] = fmaxf(rmax[1], fmaxf(fabsf(v1.x), "
               "fabsf(v1.y)));\n")],
        "phase_w8a8_kernels", "attention_out_int8 B="),
    # B4: the key-tile loop cut after ten tiles (640 keys): only a check
    # past 640 keys (chip_smoke.LONG_KEY_SHAPES) sees it
    "b4_ten_key_tiles": (
        _B4, [("  const int NT = (p.Lk + kTileK - 1) / kTileK;\n",
               "  const int NT = min((p.Lk + kTileK - 1) / kTileK, 10);\n")],
        "phase_w8a8_kernels", "attention_out_int8 B="),
    # the whole layer: the residual rounded to bf16 after the
    # out-projection, as the serving composition rounds it
    "mega_residual_bf16": (
        _MEGA, [("            *reinterpret_cast<float2*>(a32 + static_cast<long "
                 "long>(rr) * D + col) =\n                make_float2(v0, v1);",
                 "            *reinterpret_cast<float2*>(a32 + static_cast<long "
                 "long>(rr) * D + col) =\n                make_float2("
                 + _ROUND.format("v0") + ", " + _ROUND.format("v1") + ");")],
        "phase_mega", "mega_layer F="),
    # the whole layer: the hidden's absmax over its first 1,024 values only
    # (fc1's first pass)
    "mega_hidden_absmax_first_1024": (
        _MEGA, [("              mx[2 * c + e] = fmaxf(mx[2 * c + e], fabsf(v));",
                 "              if (ch * kKC < 1024) mx[2 * c + e] = "
                 "fmaxf(mx[2 * c + e], fabsf(v));")],
        "phase_mega", "mega_layer F="),
    # B10: cls_proj's output rounded to bf16, as the stock branch rounds it
    # (EXTRAS_MAX_DIFF_SHARE exists for this case)
    "b10_cls_proj_bf16": (
        _B10, [("          v = make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, "
                "v.w + b4.w);\n          *reinterpret_cast<float4*>(a.cp",
                "          v = make_float4(v.x + b4.x, v.y + b4.y, v.z + b4.z, "
                "v.w + b4.w);\n          v = make_float4(" + ", ".join(
                    _ROUND.format(f"v.{c}") for c in "xyzw") + ");\n"
                "          *reinterpret_cast<float4*>(a.cp")],
        "phase_w8_kernels", "fused_extras Bb="),
    # B7's one-launch backward: dv from the unrounded p (its bf16 rounding
    # and the remainder, both through the product)
    "b7b_dv_from_unrounded_p": (
        _B7B, [("      uint32_t ea[4][4], dsa[4][4];",
                "      uint32_t ea[4][4], dsa[4][4], er[4][4];"),
               ("          ea[f / 2][(f % 2) * 2 + 1] = afrag::cvt_pack(p[2], "
                "p[3]);     // key kr1\n",
                "          ea[f / 2][(f % 2) * 2 + 1] = afrag::cvt_pack(p[2], "
                "p[3]);     // key kr1\n"
                "          er[f / 2][(f % 2) * 2] = afrag::cvt_pack(p[0] - "
                "lo_f(ea[f / 2][(f % 2) * 2]), p[1] - hi_f(ea[f / 2][(f % 2) "
                "* 2]));\n"
                "          er[f / 2][(f % 2) * 2 + 1] = afrag::cvt_pack(p[2] - "
                "lo_f(ea[f / 2][(f % 2) * 2 + 1]), p[3] - hi_f(ea[f / 2][(f % "
                "2) * 2 + 1]));\n"),
               ("          afrag::mma_chunk<kHD / 16>(dv, ea[kc], dos, c0 + kc, 0, "
                "lane);   // dv += bf16(p)^T do\n",
                "          afrag::mma_chunk<kHD / 16>(dv, ea[kc], dos, c0 + kc, 0, "
                "lane);   // dv += bf16(p)^T do\n"
                "          afrag::mma_chunk<kHD / 16>(dv, er[kc], dos, c0 + kc, 0, "
                "lane);\n")],
        "phase_train_kernels", "streaming_attention_bwd B="),
    # B7's one-launch backward: dk from the unrounded ds (the same split)
    "b7b_dk_from_unrounded_ds": (
        _B7B, [("      uint32_t ea[4][4], dsa[4][4];",
                "      uint32_t ea[4][4], dsa[4][4], dr[4][4];"),
               ("          dsa[f / 2][(f % 2) * 2 + 1] = d23;\n",
                "          dsa[f / 2][(f % 2) * 2 + 1] = d23;\n"
                "          dr[f / 2][(f % 2) * 2] = afrag::cvt_pack(ds[0] - "
                "lo_f(d01), ds[1] - hi_f(d01));\n"
                "          dr[f / 2][(f % 2) * 2 + 1] = afrag::cvt_pack(ds[2] - "
                "lo_f(d23), ds[3] - hi_f(d23));\n"),
               ("          afrag::mma_chunk<kHD / 16>(dk, dsa[kc], qs, c0 + kc, 0, "
                "lane);   // dk += ds^T q\n",
                "          afrag::mma_chunk<kHD / 16>(dk, dsa[kc], qs, c0 + kc, 0, "
                "lane);   // dk += ds^T q\n"
                "          afrag::mma_chunk<kHD / 16>(dk, dr[kc], qs, c0 + kc, 0, "
                "lane);\n")],
        "phase_train_kernels", "streaming_attention_bwd B="),
    # the fp32 attention kernels: every product of the packed forms as one
    # TF32 product (1xTF32: the two products of a lo part dropped), which
    # the fp32 limit must tell from 3xTF32
    "f32_products_tf32": (
        _F32, [(_3XTF32, _1XTF32)],
        "phase_f32_kernels", "packed_attention_den_f32 B="),
    # B1 / B6a in fp32: the weights of the keys past Lk in their last chunk
    # of 8 (exp2(0) = 1) kept, which sums them into den (their value rows
    # are zeros)
    "f32_b1_den_of_masked_keys": (
        _F32, [("            e[i] = k0 + kc + (i & 1) < a.Lk ? ex2f(fminf(s[j][i] * "
                "a.c, kClamp)) : 0.f;",
                "            e[i] = ex2f(fminf(s[j][i] * a.c, kClamp));")],
        "phase_f32_kernels", "packed_attention_f32 B="),
    # B6b in fp32 (and B8, which shares the kernel): delta from the first 32
    # head columns of do * o only
    "f32_b6b_delta_half_row": (
        _F32, [("        for (int half = 0; half < 2; ++half) {",
                "        for (int half = 0; half < 1; ++half) {")],
        "phase_f32_kernels", "packed_attention_bwd_f32 B="),
    # B8 in fp32: its forward over one key too few
    "f32_b8_forward_one_key_short": (
        _F32, [("make_fwd(q, k, v, o_scratch, den_scratch, Lq, Lk, H,",
                "make_fwd(q, k, v, o_scratch, den_scratch, Lq, Lk - 1, H,")],
        "phase_f32_kernels", "packed_attention_bwd_recompute_f32 B="),
    # B7's forward in fp32 (the packed forward's kernel in its streaming
    # form): the running sum not rescaled when a row's max moves
    "f32_b7_sum_not_rescaled": (
        _F32, [("        den0 *= al0;\n        den1 *= al1;\n", "")],
        "phase_f32_kernels", "streaming_attention_f32 B="),
    # ... the weights of the keys the causal mask hides kept (inside the key
    # tile of the block's last row and the chunk of the warp's)
    "f32_b7_causal_mask_dropped": (
        _F32, [("const bool vis = key < a.Lk && (!a.causal || key <= row);",
                "const bool vis = key < a.Lk;")],
        "phase_f32_kernels", "streaming_attention_f32 B="),
    # ... every product as one TF32 product (f32_products_tf32's edit of the
    # 3xTF32 step the fp32 kernels share, held here by B7's forward check)
    "f32_b7_products_tf32": (
        _F32, [(_3XTF32, _1XTF32)],
        "phase_f32_kernels", "streaming_attention_f32 B="),
    # B7's backward in fp32, its two FMA kernels (rows past 128): p of the
    # keys the causal mask hides kept
    "f32_b7b_causal_mask_dropped": (
        _F32, [("return causal && key > row ? 0.f : ex2f(s * c - st);",
                "return ex2f(s * c - st);")],
        "phase_f32_kernels", "streaming_attention_bwd_f32 B="),
    # B7's backward in fp32, its one-launch form (the 3xTF32 backward's
    # streaming form, rows up to 128): p of the keys the causal mask hides
    # kept
    "f32_b7b1_causal_mask_dropped": (
        _F32, [("const bool vis = kv && row < a.Lq && (!a.causal || key <= row);",
                "const bool vis = kv && row < a.Lq;")],
        "phase_f32_kernels", "streaming_attention_bwd_f32 B="),
    # ... p = exp2(s c) with the row's statistic not subtracted
    "f32_b7b1_stat_not_subtracted": (
        _F32, [("p[i] = vis ? ex2f(sT[f][i] * a.c - st[i & 1]) : 0.f;",
                "p[i] = vis ? ex2f(sT[f][i] * a.c) : 0.f;")],
        "phase_f32_kernels", "streaming_attention_bwd_f32 B="),
    # ... delta from the first 32 head columns of do * o only (the pass it
    # shares with B6b: f32_b6b_delta_half_row's edit, held here by B7's
    # check)
    "f32_b7b1_delta_half_row": (
        _F32, [("        for (int half = 0; half < 2; ++half) {",
                "        for (int half = 0; half < 1; ++half) {")],
        "phase_f32_kernels", "streaming_attention_bwd_f32 B="),
    # the fp32 forms of the w8a8 kernels (chip_smoke's w8a8-f32 phase):
    # B2 (and B3, B5, which share the row load) with each fp32 row rounded
    # to bf16 before the quant, in the 16-byte load and the value load
    "f32w8_b2_rows_bf16": (
        _W8A8, [("  v[0] = a.x;\n  v[1] = a.y;\n  v[2] = a.z;\n  v[3] = a.w;\n"
                 "  v[4] = b.x;\n  v[5] = b.y;\n  v[6] = b.z;\n  v[7] = b.w;\n",
                 "".join(f"  v[{i}] = " + _ROUND.format(f"{ab}.{c}") + ";\n"
                         for i, (ab, c) in enumerate(
                             (ab, c) for ab in "ab" for c in "xyzw"))),
                ("__device__ __forceinline__ float to_f32(float v) { return v; }",
                 "__device__ __forceinline__ float to_f32(float v) { return "
                 + _ROUND.format("v") + "; }")],
        "phase_w8a8_f32", "w8a8_matmul_f32 M="),
    # B5 in fp32: the residual read as bf16
    "f32w8_b5_residual_bf16": (
        _B5, [("store_as(y + at, kRes ? __fadd_rn(v, to_f32(r[at])) : v);",
               "store_as(y + at, kRes ? __fadd_rn(v, "
               + _ROUND.format("to_f32(r[at])") + ") : v);")],
        "phase_w8a8_f32", "w8a8_mlp_res_f32 M="),
    # B3a in fp32 at rows held in passes (K 1,100): the LayerNorm's mean
    # summed over the first 1,024 columns only
    "f32w8_b3_ln_mean_first_1024": (
        _W8A8, [("    for (int c = lane; c < K; c += 32) s = __fadd_rn(s, "
                 "to_f32(src[c]));",
                 "    for (int c = lane; c < min(K, 1024); c += 32) s = "
                 "__fadd_rn(s, to_f32(src[c]));")],
        "phase_w8a8_f32", "w8a8_matmul3_f32 M="),
    # B4 in fp32: the attention's score products in TF32 (its first launch
    # is attention_f32.cu's fma_fwd_kernel, whose scores sum dot4's fmaf)
    "f32w8_b4_products_tf32": (
        _F32, [("  acc = fmaf(a.x, b.x, acc);\n  acc = fmaf(a.y, b.y, acc);\n"
                "  acc = fmaf(a.z, b.z, acc);\n  return fmaf(a.w, b.w, acc);\n",
                "".join(f"  acc = fmaf({_TF32.format('a.' + c)}, "
                        f"{_TF32.format('b.' + c)}, acc);\n" for c in "xyz")
                + f"  return fmaf({_TF32.format('a.w')}, "
                  f"{_TF32.format('b.w')}, acc);\n")],
        "phase_w8a8_f32", "attention_out_int8_f32 B="),
    # the fp32 serving forms (chip_smoke's serving-f32 phase): B9 in fp32
    # with every product as one TF32 product (1xTF32: both lo products
    # dropped)
    "f32b9_products_tf32": (
        _B9F32, [(_B9_3XTF32, _B9_1XTF32)],
        "phase_serving_f32", "int8_matmul_f32 M="),
    # B9 in fp32 with the hi_x lo_w product dropped (the weight's lo part
    # never enters)
    "f32b9_hi_x_lo_w_dropped": (
        _B9F32, [("  tf32::wgmma_tf32(f, ah, bl);     // hi_x lo_w\n", "")],
        "phase_serving_f32", "int8_matmul_f32 M="),
    # B11 in fp32: the codes made with the reciprocal, rint(x * (rcp(qs) *
    # 127)), which rounds twice where the plain version divides once
    "f32b11_codes_reciprocal": (
        _F32, [("const float inv = __fdiv_rn(127.f, qs);",
                "const float inv = __fmul_rn(__frcp_rn(qs), 127.f);")],
        "phase_serving_f32", "attention_out_int8_qk8_f32 "),
    # B11 in fp32: the rescale in another order, s32 * ((qs * (c / 127^2))
    # * ks)
    "f32b11_rescale_order": (
        _F32, [("return __fmul_rn(__fmul_rn(s32, qf), ks);",
                "return __fmul_rn(s32, __fmul_rn(qf, ks));")],
        "phase_serving_f32", "attention_out_int8_qk8_f32 "),
    # B12 in fp32: the second source's rows read from the first
    "f32b12_second_source_from_first": (
        _F32, [("r < L ? p2 + (r - L1) * ld2", "r < L ? p1 + (r - L1) * ld1")],
        "phase_serving_f32", "attention_out_int8_2src_f32 "),
}


def _run_mutant(name):
    """Build and check one mutant in its own copy: (rejected, report)."""
    path, edits, phase, word = MUTANTS[name]
    d = os.path.join(ROOT, "_scratch", "mut_" + name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    shutil.copytree(os.path.join(ROOT, "gava_clip_tpu_torch"),
                    os.path.join(d, "gava_clip_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__", "*.tmp"))
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), d)
    with open(os.path.join(d, path)) as f:
        src = f.read()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} occurs "
                               f"{src.count(old)} times in {path}")
        src = src.replace(old, new)
    with open(os.path.join(d, path), "w") as f:
        f.write(src)
    # the phase checks the mutant's kernel alone where it can (`only`)
    code = ("import chip_smoke as cs\ncs.import_port()\n"
            f"state = {{'checks_only': True, 'only': {word.split()[0]!r}}}\n"
            f"cs.phase_device(state)\ncs.{phase}(state)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=d,
                         capture_output=True, text=True)
    # rejected only by a failed check on the kernel's own lines: a phase
    # that stops on an error of its own shows nothing about the mutant
    lines = [line for line in res.stdout.splitlines() if word in line]
    rejected = res.returncode != 0 and any(
        line.rstrip().endswith("FAIL") for line in lines)
    report = [f"===== mutant {name}: exit code {res.returncode} "
              f"({'rejected' if rejected else 'NOT REJECTED'})"]
    report += ["    " + line[:400] for line in res.stdout.splitlines()
               if word in line or line.startswith("[device] nvidia-smi")]
    if not rejected:
        report += ["    " + line
                   for line in res.stderr.strip().splitlines()[-3:]]
    return rejected, report


def main(argv=None, jobs: int = 1) -> int:
    """argv: name prefixes of the mutants to run (all when none is given),
    e.g. `b7 b5`; jobs: mutants built and checked at once."""
    prefixes = tuple(sys.argv[1:] if argv is None else argv)
    names = [n for n in MUTANTS if not prefixes or n.startswith(prefixes)]
    passed = []
    with ThreadPoolExecutor(max(1, jobs)) as ex:
        for name, (rejected, report) in zip(names,
                                            ex.map(_run_mutant, names)):
            print("\n".join(report), flush=True)
            if not rejected:
                passed.append(name)
    if passed:
        print(f"mutants that no check rejected: {passed}")
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
