#!/usr/bin/env python3
"""Bring-up check of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                      # every phase, one card
    python3 chip_smoke.py --profile profile_out   # + per-op tables

Phases, each reported on its own lines:
  device  card name and power limit (nvidia-smi), torch / CUDA versions;
  build   compiles every csrc/*.cu with nvcc for sm_90a, one process each,
          all started together, timed, with ptxas' register / spill lines;
  kernel  the packed attention kernel against its plain PyTorch version on
          the card, at the serving shape and at ragged small shapes, with
          CUDA-event times of both; the share of outputs that differ from
          the plain version at all is what tells a kernel that rounds e to
          bf16 before the denominator from one that does not;
  slice   the zero-shot serving path: build_zero_shot (ViT-B/16, T=8, 224^2,
          400 classes, random seeded weights) + inject_clip_pathologies, a
          bf16 VideoClassifier at batch 16, warmup, classify_clips on 16 and
          on 5 seeded clips; checks the probabilities, 12 kernel launches
          per forward, and the logits against the plain-attention bf16
          forward and an fp32 reference (on these weights and on the plain
          init); clips/s and batch-1 latency;
  server  that classifier behind gava_clip_tpu_torch.server.serve on
          localhost, 4 concurrent /v1/classify_clip_raw requests.
The w8a8 path gets the same three checks:
  w8a8-kernel  the four int8 kernels (w8a8_matmul, w8a8_matmul3_cat,
          attention_out_int8, w8a8_mlp_res) against their plain versions at
          the serving shapes and ragged ones, with CUDA-event times of both
          (limits in W8A8_LIMITS; w8a8_matmul3_cat also at the long
          clip's 280 frame rows, W8A8_QKV_LONG); w8a8_matmul also at rows
          longer than the 1,024 values a warp holds in registers (the text
          MLP's fc2, 1,155 x 2,048, and a ragged K) and at the text tower's
          out-projection and fc1 (1,155 x 512), bit for bit; w8a8_matmul3_cat also
          against three w8a8_matmul launches on its rows, and
          attention_out_int8 against packed_attention then w8a8_matmul,
          each in turns, and the int8 product of each alone through
          torch._int_mm (the `yardsticks` of their kernels-line entries);
          attention_out_int8, its int8 QK^T and two-source forms also past
          640 keys (LONG_KEY_SHAPES: 16 frame rows of 400^2 and 448^2, 643
          and 802 keys), timed beside 214 keys (the `long_keys` of their
          entries; w8a8-f32 the same for the fp32 forms);
  w8a8-slice   VideoClassifier(quantize="w8a8", patch_major=True) on the
          pathology weights at batch 16: launches per forward (1, 12, 12, 12
          and no packed attention), probabilities, the padded bucket, the
          logits against the same forward through the plain versions (on
          these weights and on the plain init), the prob-delta gate against
          the bf16 classifier, clips/s and batch-1 latency; then a w8a8
          classifier of build_zero_shot(input_size=400) at batch 4 (643
          keys a frame row): launches, probabilities, logits against the
          plain versions' forward, clips/s;
  w8a8-server  the w8a8 classifier behind the same server.
The training step:
  train-kernel  the denominator-emitting packed forward, the packed
          backwards (saved-residual and recompute) and the streaming
          (causal / long) forward and backward against their plain versions
          at the training shapes, ragged ones and the packed path's edge
          (limits in TRAIN_LIMITS); the packed backwards and the streaming
          backward run twice and must give the same bits (the streaming
          backward also timed in a CUDA graph); CUDA-event times of
          kernel, plain version and
          F.scaled_dot_product_attention (a yardstick only), the packed
          backwards against SDPA's backward and the packed forwards (B6a,
          and B1 on the same inputs) against SDPA's forward in turns (the
          median ratio of 7 rounds, and their range);
  train-slice   build_flagship (ViT-B/16, T=8, text tower 12 x 512, KAPT
          prompts over 5 knowledge versions, memory + NTE heads, random
          seeded weights) -> trainable_mask -> create_train_state ->
          make_train_step, bf16, attn_impl="flash", batch 16 clips: the
          first step's loss and gradients against the same step through the
          plain versions, then 6 steps on a fixed batch: launches per step
          (12 each of the four kernels, no plain packed forward), the loss
          falls, frozen leaves bit-unchanged, trainable leaves moved,
          ms/step and peak memory;
  train-long    steps at 4 clips x 70 frames with remat="full".
The float32 forms of the attention kernels (csrc/attention_f32.cu), which
a run without --use_bf16 takes:
  f32-kernel  B1 / B6a, B6b, B8 and B7's forward and backward in fp32
          against their plain versions at the training shapes (16 x 8, 4 x
          70, the text tower's causal 15 x 77), ragged ones and the packed
          path's edge (F32_REL of the scale, den and lse), the backwards
          twice with the same bits, B8 bit-equal to B6b on the forward
          kernel's o and den, B7's backward in one launch where both
          lengths are at most 128 and in its two kernels past that;
          kernel, plain version and SDPA in fp32 timed in turns; fp32 into
          B4 and mixed or fp16 q/k/v raise TypeError;
  w8a8-f32  the fp32 forms of the w8a8 kernels (B2, B3 / B3a, B5 / B5a;
          B4 as B1's function in fp32, summed in the plain version's order,
          into a scratch, then B2's fp32 entry with the residual; its
          attention launch alone also timed beside SDPA's fp32 forward in
          CUDA graphs) against their plain versions at the shapes of the
          fp32 int8 step and the fp32 w8a8 evaluation and at ragged ones
          (F32_W8A8_LIMITS; B2 bit for bit), one counted `_f32` launch each,
          timed beside their bf16 forms in turns and the int8 products
          alone through torch._int_mm (B3 and B3a also beside their bf16
          forms in CUDA graphs, in turns, with B3's launch plan logged; B3a
          also at the 4 x 70 step's 59,920 rows, F32_B3A_LONG);
          mlp_block(residual=None) on fp32 rows (B5a's path); fp16 and
          mixed rows raise TypeError;
  serving-f32  the fp32 forms of B9 (csrc/w8_matmul_f32.cu) at the w8
          evaluation's four projection shapes and ragged ones within
          W8_F32_REL of sum |x| |w| (timed beside torch.matmul on the
          dequantized fp32 weight and beside its bf16 form), of B11 (its
          codes and exp2 arguments bit for bit against the plain version's,
          on random rows and on rows at the codes' rounding ties
          (int8_qk_tie_rows), the op within F32_W8A8_LIMITS, the loose
          check against the fp32-score form, timed beside its bf16 form)
          and of B12 (both score forms bit for bit equal to B4 / B11 fp32
          on the concatenated keys, timed; its public entry on fp32 rows at
          the serving shape: one launch); fp16 and mixed rows raise;
  f32-mutants  the f32_* mutants of utils/kernel_mutants.py (one of them
          rounds every product to TF32), its f32w8_* mutants (an fp32
          row rounded to bf16 before the quant, B5's residual read as bf16,
          B3a's LayerNorm mean over the first 1,024 columns, B4's score
          products in TF32) and its f32b9_ / f32b11_ / f32b12_ mutants
          (B9's products in 1xTF32 or without hi_x lo_w, B11's codes by
          the reciprocal or its rescale in another order, B12's second
          source read from the first), built and checked all at once (B7's
          backward has mutants of each of its two forms): each must fail
          f32-kernel,
          w8a8-f32 or serving-f32;
  train-f32  the train-slice step in fp32: the first step against the
          plain versions (F32_STEP_MAX_*), launches per step
          (F32_PER_STEP), the recompute mode's step against the saved
          mode's, fp32 and bf16 steps in turns (ms/step, peak GiB); the
          driver phase also runs cli.train without --use_bf16 (12 steps,
          the fp32 kernels only) and cli.evaluate on that run (24 launches
          of the fp32 B1, the run's confusion matrix).
The training and evaluation programs:
  train-recompute  the same step under set_flash_bwd_mode("recompute"): the
          first step's loss and gradients against the saved mode, 3 steps
          with 12 launches each of the recompute backward and of the
          forward that writes no denominators; the mode reset and the
          saved-mode gradients back bit for bit;
  int8-train  int8-forward training (--int8_frozen): the straight-through
          ops int8_qkv3_st (B3a, 27,392 x 768 -> 3 x 768 with LN1),
          int8_linear_st (B2 at the vision out-projection and the text
          tower's three shapes) and int8_mlp_st (B5 with LN2 and the
          residual), each forward one counted launch within its limits of
          the impl="plain" forward (B2 bit for bit), each dx through the
          kernel path bit-equal to the plain path's and within
          INT8_TRAIN_DX_REL_ERR of autograd through the float block on the
          dequantized weights, timed; the flagship's step at 16 x 8 with
          frozen_int8=True: the first step against the plain versions
          (TRAIN_MAX_LOSS_DIFF, TRAIN_MAX_GRAD_REL_ERR), 6 steps in turns
          with the bf16 step (launches INT8_TRAIN_PER_STEP, the loss falls,
          frozen leaves bit-unchanged, ms/step, peak memory, the largest
          int8 - bf16 loss gap); 4 x 70 under save_attn_qkv and full, 2
          steps each beside bf16; cli.train --int8_frozen --use_bf16 on a
          synthetic fold (the loss falls, the run's files, launches); then
          in fp32: fp32 rows through the three ops take their `_f32` forms
          (fp16 rows raise), the 16 x 8 step with frozen_int8 against the
          plain versions (F32_STEP_MAX_*), 6 steps in turns with the fp32
          step (INT8_F32_PER_STEP: only fp32 entries), and cli.train
          --int8_frozen without --use_bf16;
  driver  writes a synthetic fold from a seed into a temporary directory
          (lists, separable uint8 clips as decoded-view cache files, NTE
          arrays, the memory pickle, the knowledge directory, a classes
          file) and runs gava_clip_tpu_torch.cli.train.main at full width,
          16 clips x 8 frames, bf16: 12 steps with one evaluation and
          periodic checkpoints; the loss falls, the run's files exist,
          prefetch on and off give the same losses, a run resumed with
          --auto_resume repeats the uninterrupted run's losses, the clamp
          monitor stays below 110; then cli.evaluate.main on that run
          (plain and --quantize_eval w8a8), the flagship's text features
          with its whole text tower in w8a8 (12 B3a launches of 15 x 77
          rows, each held against w8a8_matmul3_plain on its own inputs, and
          36 B2 launches, the out-projections and fc1 at rows of 512 and
          fc2 at rows of 2,048, each held bit for bit against
          w8a8_matmul_plain), the same 12 steps in fp32 (no --use_bf16)
          with cli.evaluate on that run, plain and --quantize_eval w8a8
          (EVAL_W8A8_F32_LAUNCHES: the fp32 B3, B4 and B5 only; accuracy
          within one clip of the plain evaluation), --quantize_eval w8 on
          it (EVAL_W8_F32_LAUNCHES: 144 B9 fp32), w8a8 under the int8 QK^T
          switch (24 B11 fp32) and under the fused-extras switch (24 B10 on
          fp32 rows), each within one clip, and cli.zero_shot.main on a
          reference-format .pth written from a model's own weights, in bf16
          and with --quantize_eval w8 in fp32; between the two, cli.train
          in fp32 with --auto_augment AUG_POLICY (8 steps: sustained
          ms/step and data_time beside the plain fp32 run's), its
          --auto_resume continuation (the same losses), the augmentation's
          ms a batch and the card against the CPU (AUG_CARD_SHARE);
  gait-text  the gait-knowledge programs from 128 synthetic WHAM walks
          drawn from a seed: offline.gait_params (10 parameters, so 210
          combinations), offline.preprocess.data_preprocess on the card
          through the flagship's text tower at full width in fp32 (107,520
          sentences of 77 tokens in calls of 4,096: seconds, sentences/s,
          peak memory; the bank unit-norm, every NTE file the means of its
          bank rows, two combinations recomputed on the host within
          BANK_HOST_ATOL), cli.train for 4 steps on a fold whose clips are
          the bank's videos with the bank as support memory and its NTE
          files (every read a real 210-row file; B6a, B6b, B7 launches),
          the evaluation and analysis programs on that run: cli.iwa over
          the run and a copy of it (equal weights; top-1 and confusion
          those of cli.evaluate on the same val split; B1 12 a batch
          forward), cli.analysis (every class's descriptor rows, every
          precision in [0, 100]; B1 and B7 12 a forward), the memory
          prompt through the text tower at full width (B7 against the
          plain attention within MEMORY_PROMPT_REL_ERR; 12 launches) and
          cli.visualize on the bank (PCA on the card against the host's
          eigenvalues, --project_vlm with the run's checkpoint,
          --pairwise; the .npz files finite, of the right shapes),
          cli.decoder_train for one epoch at the full DecapConfig (420
          steps of 64: ms/step by the host clock and by CUDA events, peak
          memory, the loss falls and the token accuracy rises), the host
          loop, K/V-cached and 8-lane decoders on 64 bank features (the
          same tokens on the first 8; captions/s, tokens/s), the bank's own
          number tokens de-scaled through the scale dict and rendered, and
          cli.decode's centroid study on the training run's checkpoint;
  driver-long  cli.train.main at 4 clips x 70 frames (selects
          save_attn_qkv), then the bare step under every remat policy:
          ms/step, peak memory, attention forward launches per step.
  parallel  the parallel layer (gava_clip_tpu_torch/parallel/): a world of
          one over NCCL in this process (a FileStore), where the
          train-slice's 16 x 8 step in fp32 with the gradient all-reduce
          must give the step without it bit for bit over 6 steps, the
          last 5 of each timed in turns, and the one bucket's all-reduce
          alone; two ranks
          on the one card (torch.distributed.run, gloo: NCCL refuses two
          ranks on one device) at full width with 2 vision and 2 text
          layers, NTE and the memory on, a global batch of 8: the
          data-parallel (2, 1) and tensor-parallel (1, 2) first steps
          (parallel/selfcheck.py) against the same step in one process
          within F32_STEP_MAX_LOSS_DIFF / F32_STEP_MAX_GRAD_REL_ERR, then
          4 steps of cli.train on a synthetic fold, rank 0's checkpoint,
          and cli.evaluate in one process reproducing its confusion
          matrix; the bf16 zero-shot forward at batch 16 with its blocks
          in 4 pipeline stages on cuda:0 and 4 micro-batches (48 B1
          launches) against the default forward, bit for bit; server
          --data_parallel 1 answering requests with the plain classifier's
          probabilities, and the classifier over two devices (cuda:0 twice)
          against one device's;
  frame   frame sharding: two gloo ranks on cuda:0, each passing 4 of every
          clip's 8 frames (mesh (1, 2, 1) over 'data', 'frame' and
          'model'): the fp32 training step of 16 clips at full width with
          2 vision and 2 text layers, NTE and the memory on, against the
          same step in one process within F32_STEP_MAX_*; the zero-shot
          ViT-B/16 forward at batch 16 (12 layers, 400 classes), bf16 and
          then w8a8 + patch-major with the fused prompt extras, against
          one process's logits within FRAME_SERVE_MAX_LOGIT_ULPS bf16 ulps
          of the largest logit (and a wrong temporal embedding outside
          them), with each rank's kernel launches (FRAME_SERVE_LAUNCHES)
          and host-clock times against one process; the same forward
          with its blocks in 2 pipeline stages on cuda:0 and 2
          micro-batches (frame x pp), bf16 within that limit and fp32
          within F32_REL of the largest logit of one process's forward
          without the pipeline (stages that pass no FrameShard outside
          both), FPP_SERVE_LAUNCHES; then four gloo
          ranks on a (1, 2, 2) mesh, 4 frames and half the heads a rank
          (frame x model): the same fp32 step within F32_STEP_MAX_* (the
          frame-partial gradients summed over every rank outside them),
          and the bf16 forward through vita_clip.apply within
          FM_SERVE_MAX_F32_DIFFS times one process's bf16-vs-fp32 logit
          distance, FM_SERVE_LAUNCHES.
The two-source attention + int8 out-projection (attention_out_int8_2src)
is held in w8a8-kernel against its plain version and, bit for bit, against
the single-source kernel on the concatenated keys, and launched once
through its public entry point at the serving shape in w8-slice.
The remaining serving modes:
  w8-kernel    the weight-only int8 GEMM (int8_matmul), the residual-free
          w8a8 MLP (w8a8_mlp), the fused prompt extras (fused_extras) and
          the int8 QK^T form of attention_out_int8 against their plain
          versions at the serving shapes and ragged ones (limits in
          W8_LIMITS, EXTRAS_*, W8A8_LIMITS; the fused extras also past one
          tile of their launch plan, EXTRAS_TILED_SHAPES, and timed in a
          CUDA graph), with CUDA-event times of
          kernel, plain version and, where there is one, a stock PyTorch
          yardstick (for the w8 GEMM torch.matmul on the dequantized
          weight, in turns: the median ratio of 7 rounds at each of the
          four projection shapes); the qkv kernel without extras rows is
          timed here too,
          and its entry w8a8_matmul3 (B3a) checked and timed at the text
          attention's shape of the driver phase, also in a CUDA graph of
          20 launches (device time: `graph_ms`);
  mega         the port's tool (tools/bench_attn_variants.py): the
          whole-layer w8a8 kernel (mega_layer) against its plain version at
          the tool's 64 frame rows, the serving 128 and a ragged shape
          (MEGA_LIMITS), the tool's gate (mega against B3a + B4 + B5 through
          their kernels, rel < 2e-2) at its shape and draws, the kernel,
          plain version and that composition timed in turns at 64 and 128
          frame rows, one CTA a frame row against the plan's cluster bit for
          bit, then the tool's entry point (--parity, timing) with its
          launches counted;
  w8-slice     VideoClassifier(quantize="w8") at batch 16: 72 int8_matmul
          and 12 packed_attention launches per forward, the logits against
          the same forward through the plain versions and against the bf16
          forward, the prob-delta gate, clips/s, batch-1 latency; the
          patch-major w8 classifier beside it; mlp_block(residual=None) on
          w8a8 leaves at the tower's shape;
  w8a8-variants  the w8a8 + patch-major classifier with set_fused_extras,
          then with set_int8_qk as well: launches per forward, logits
          against the unfused forward and the plain-version forward, the
          gate, times beside the unfused forward; both switches reset;
          then the fused extras on fp32 rows (the classifier run in fp32:
          12 B10 launches, logits within W8A8_MAX_LOGIT_DIFF_INIT of the
          unfused fp32 forward);
  w8-server    the w8 classifier behind the same server.

Any failure raises and the script exits nonzero without printing a result.
On success the line before the last but one is a JSON object describing
each kernel (time, plain version's time, its bound on this card, the
library call's time where there is one, launches on its main path) and the
last line is {"ok": true, "device": {...}}. Imports no JAX and nothing of
the JAX package.
"""

import argparse
import itertools
import json
import os
import struct
import subprocess
import sys
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the kernels' symbols, as a device trace names them
KERNEL_SYMBOLS = ("packed_attention_kernel", "w8a8_matmul_kernel",
                  "w8a8_qkv_kernel", "attention_out_int8_kernel",
                  "w8a8_mlp_kernel", "attn_bwd_fused_kernel",
                  "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel",
                  "streaming_attention_fwd_kernel",
                  "w8_matmul_kernel", "fused_extras_kernel",
                  "packed_bwd_kernel", "mega_layer_kernel",
                  "w8_matmul_f32_kernel", "fma_fwd_kernel",
                  "packed_fwd_kernel", "stream_bwd_dq_kernel",
                  "stream_bwd_dkdv_kernel")
KERNEL_SOURCE = "gava_clip_tpu_torch/csrc/packed_attention.cu"
KERNEL_REPLACES = "gava_clip_tpu/ops/flash_attention.py:181"
# every kernel of the two serving paths and of the training step:
# launch-count name -> (library, source, the TPU kernel it replaces)
KERNELS = {
    "packed_attention": ("packed_attention", KERNEL_SOURCE, KERNEL_REPLACES),
    "w8a8_matmul": ("w8a8_matmul", "gava_clip_tpu_torch/csrc/w8a8_matmul.cu",
                    "gava_clip_tpu/ops/int8_matmul.py:374"),
    "w8a8_matmul3_cat": ("w8a8_qkv", "gava_clip_tpu_torch/csrc/w8a8_qkv.cu",
                         "gava_clip_tpu/ops/int8_matmul.py:514"),
    "attention_out_int8": (
        "attention_out_int8",
        "gava_clip_tpu_torch/csrc/attention_out_int8.cu",
        "gava_clip_tpu/ops/flash_attention.py:661"),
    "w8a8_mlp_res": ("w8a8_mlp", "gava_clip_tpu_torch/csrc/w8a8_mlp.cu",
                     "gava_clip_tpu/ops/int8_matmul.py:694"),
    "packed_attention_den": ("packed_attention", KERNEL_SOURCE,
                             "gava_clip_tpu/ops/flash_attention.py:193"),
    "packed_attention_bwd": (
        "packed_attention_bwd",
        "gava_clip_tpu_torch/csrc/packed_attention_bwd.cuh",
        "gava_clip_tpu/ops/flash_attention.py:213"),
    "streaming_attention": (
        "streaming_attention",
        "gava_clip_tpu_torch/csrc/streaming_attention.cu",
        "gava_clip_tpu/ops/flash_attention.py:534"),
    "streaming_attention_bwd": (
        "streaming_attention_bwd",
        "gava_clip_tpu_torch/csrc/streaming_attention_bwd.cu",
        "gava_clip_tpu/ops/flash_attention.py:534"),
    "int8_matmul": ("w8_matmul", "gava_clip_tpu_torch/csrc/w8_matmul.cu",
                    "gava_clip_tpu/ops/int8_matmul.py:54"),
    "w8a8_mlp": ("w8a8_mlp", "gava_clip_tpu_torch/csrc/w8a8_mlp.cu",
                 "gava_clip_tpu/ops/int8_matmul.py:594"),
    "fused_extras": ("fused_extras",
                     "gava_clip_tpu_torch/csrc/fused_extras.cu",
                     "gava_clip_tpu/ops/extras_kernel.py:48"),
    "attention_out_int8_qk8": (
        "attention_out_int8",
        "gava_clip_tpu_torch/csrc/attention_out_int8.cu",
        "gava_clip_tpu/ops/flash_attention.py:117"),
    "packed_attention_bwd_recompute": (
        "packed_attention_bwd_recompute",
        "gava_clip_tpu_torch/csrc/packed_attention_bwd.cuh",
        "gava_clip_tpu/ops/flash_attention.py:410"),
    "w8a8_matmul3": ("w8a8_qkv", "gava_clip_tpu_torch/csrc/w8a8_qkv.cu",
                     "gava_clip_tpu/ops/int8_matmul.py:433"),
    "attention_out_int8_2src": (
        "attention_out_int8",
        "gava_clip_tpu_torch/csrc/attention_out_int8.cu",
        "gava_clip_tpu/ops/flash_attention.py:775"),
    "mega_layer": ("mega_layer", "gava_clip_tpu_torch/csrc/mega_layer.cu",
                   "tools/bench_attn_variants.py:37"),
    # the float32 forms of B1 / B6a, B6b, B8 and B7 (csrc/attention_f32.cu)
    **{name: ("attention_f32", "gava_clip_tpu_torch/csrc/attention_f32.cu",
              f"gava_clip_tpu/ops/flash_attention.py:{line}")
       for name, line in (("packed_attention_f32", 181),
                          ("packed_attention_den_f32", 193),
                          ("packed_attention_bwd_f32", 213),
                          ("packed_attention_bwd_recompute_f32", 410),
                          ("streaming_attention_f32", 534),
                          ("streaming_attention_bwd_f32", 534))},
    # the float32 forms of B2, B3 / B3a, B5 / B5a (the same sources) and B4
    # (B1's fp32 form into a scratch, then B2's fp32 entry with the
    # residual: csrc/w8a8_matmul.cu w8a8_matmul_f32)
    "w8a8_matmul_f32": ("w8a8_matmul", "gava_clip_tpu_torch/csrc/w8a8_matmul.cu",
                        "gava_clip_tpu/ops/int8_matmul.py:374"),
    "w8a8_matmul3_cat_f32": ("w8a8_qkv", "gava_clip_tpu_torch/csrc/w8a8_qkv.cu",
                             "gava_clip_tpu/ops/int8_matmul.py:514"),
    "w8a8_matmul3_f32": ("w8a8_qkv", "gava_clip_tpu_torch/csrc/w8a8_qkv.cu",
                         "gava_clip_tpu/ops/int8_matmul.py:433"),
    "w8a8_mlp_res_f32": ("w8a8_mlp_f32",
                         "gava_clip_tpu_torch/csrc/w8a8_mlp_f32.cu",
                         "gava_clip_tpu/ops/int8_matmul.py:694"),
    "w8a8_mlp_f32": ("w8a8_mlp_f32", "gava_clip_tpu_torch/csrc/w8a8_mlp_f32.cu",
                     "gava_clip_tpu/ops/int8_matmul.py:594"),
    # B4 in fp32: attention_f32.cu's fma_fwd_kernel into a scratch, then
    # B2's fp32 entry with the residual
    "attention_out_int8_f32": (
        "attention_f32", "gava_clip_tpu_torch/csrc/attention_f32.cu",
        "gava_clip_tpu/ops/flash_attention.py:661"),
    # the float32 forms of B9 and of B11 / B12 (attention_f32.cu's int8-score
    # and two-source forward into a scratch, then B2's fp32 entry with the
    # residual, as B4's)
    "int8_matmul_f32": ("w8_matmul_f32",
                        "gava_clip_tpu_torch/csrc/w8_matmul_f32.cu",
                        "gava_clip_tpu/ops/int8_matmul.py:54"),
    "attention_out_int8_qk8_f32": (
        "attention_f32", "gava_clip_tpu_torch/csrc/attention_f32.cu",
        "gava_clip_tpu/ops/flash_attention.py:117"),
    "attention_out_int8_2src_f32": (
        "attention_f32", "gava_clip_tpu_torch/csrc/attention_f32.cu",
        "gava_clip_tpu/ops/flash_attention.py:775"),
}
# (B, Lq, Lk, heads, head_dim); the first is the serving shape: 16 clips x
# 8 frames, 197 query tokens, 197 + 8 global + 1 summary + 8 local keys
KERNEL_SHAPES = ((128, 197, 214, 12, 64), (3, 13, 21, 2, 64),
                 (2, 77, 150, 4, 64), (2, 65, 64, 3, 64))
# kernel vs plain version: most outputs that may differ at all, and most
# that may differ by more than 2 bf16 ulps (see phase_kernel)
MAX_DIFF_SHARE = 5e-3
MAX_FAR_SHARE = 1e-3


def log(*a):
    print(*a, flush=True)


def import_port():
    """Import the port from this checkout (and nowhere else)."""
    sys.path.insert(0, ROOT)
    import gava_clip_tpu_torch
    where = os.path.dirname(os.path.abspath(gava_clip_tpu_torch.__file__))
    if os.path.dirname(where) != ROOT:
        raise RuntimeError(f"gava_clip_tpu_torch imported from {where}, "
                           f"not from this checkout {ROOT}")
    _assert_no_jax()


def _assert_no_jax():
    """Neither JAX nor any module of the JAX package may be loaded."""
    bad = sorted(m for m in sys.modules
                 if m == "jax" or m.startswith("jax.") or m == "gava_clip_tpu"
                 or m.startswith("gava_clip_tpu."))
    if bad:
        raise AssertionError(f"JAX or the JAX package was imported: {bad[:5]}")


def bf16_ulp(x):
    import torch
    mag = x.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 10) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device(state):
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    state["smi"] = smi
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__},"
        f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"capability {torch.cuda.get_device_capability(0)}, "
        f"count {torch.cuda.device_count()}")
    # a second of load first, so that the timings below do not catch the
    # card's clocks still ramping up from idle
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for _ in range(20):
            a @ a
        torch.cuda.synchronize()


def _card_state() -> str:
    """SM clock, power draw and temperature right now (a run whose clocks
    fell mid-way shows here)."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"], capture_output=True, text=True)
    return res.stdout.strip() or "nvidia-smi gave nothing"


def phase_build(state):
    """Every kernel source, one nvcc each, all started together."""
    from gava_clip_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    libs = sorted({lib for lib, _, _ in KERNELS.values()})
    _cuda.load_libraries(libs)
    log(f"[build] {len(libs)} sources built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        info = _cuda.build_info[lib]
        log(f"[build] {lib}: nvcc {info['seconds']:.2f} s -> {info['so']}")
        kernel = ""   # the (mangled) function that ptxas reports on
        for line in info["log"].splitlines():
            if "Function properties for" in line:
                kernel = line.split("properties for")[-1].strip() + ": "
            elif "registers" in line or "spill" in line:
                log(f"[build]   {kernel}{line.strip()}")
    # B9 (bf16 and fp32), B2, B5, B3, B4 and the whole-layer kernel are
    # wgmma kernels: their machine code must hold GMMA instructions (HGMMA
    # for bf16 and TF32, IGMMA for int8)
    cuobjdump = os.path.join(os.path.dirname(_cuda.find_nvcc()), "cuobjdump")
    for lib in ("w8_matmul", "w8_matmul_f32", "w8a8_matmul", "w8a8_mlp",
                "w8a8_mlp_f32", "w8a8_qkv", "attention_out_int8",
                "mega_layer"):
        sass = subprocess.run(
            [cuobjdump, "-sass", _cuda.build_info[lib]["so"]],
            capture_output=True, text=True, check=True).stdout
        log(f"[build] {lib} SASS: {sass.count('HGMMA')} HGMMA, "
            f"{sass.count('IGMMA')} IGMMA (wgmma), {sass.count('HMMA')} "
            f"HMMA, {sass.count('IMMA')} IMMA (mma.sync) instructions")
        if not sass.count("GMMA"):
            raise AssertionError(f"{lib} was built without wgmma")
    # B11 in fp32 takes its int8 score product from mma.sync s8 (IMMA), the
    # fp32 packed attention its products as 3xTF32 mma.sync (HMMA)
    sass = subprocess.run(
        [cuobjdump, "-sass", _cuda.build_info["attention_f32"]["so"]],
        capture_output=True, text=True, check=True).stdout
    log(f"[build] attention_f32 SASS: {sass.count('IMMA')} IMMA, "
        f"{sass.count('HMMA')} HMMA (mma.sync) instructions")


def phase_kernel(state):
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def check(name, q, k, v, H):
        out = fa.packed_attention_cuda(q, k, v, H)
        ref = fa.packed_attention_plain(q, k, v, H)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ulp = bf16_ulp(ref)
        # Both versions round each weight e to bf16 and the output once;
        # only their fp32 summation orders differ. That leaves an output
        # bf16 value different from the plain one only where an fp32 sum
        # lands next to a rounding boundary: a small share of elements
        # (MAX_DIFF_SHARE). A kernel that summed the unrounded fp32 e into
        # the denominator moves every row by up to 2**-9 relative and so
        # changes a few percent of the outputs by one ulp. Beyond 2 ulps
        # are only outputs that cancel to near 0 (tiny ulps) or rows where
        # a score flips an e rounding: a flip moves that weight by at most
        # 2**-8 of itself, so the output by at most 2**-8 * sum_i p_i |v_i|
        # (the plain version on |v|), the ceiling for those few.
        spread = fa.packed_attention_plain(q, k, v.abs(), H).float()
        ceiling = 2.0 ** -8 * spread + 2 * ulp + 1e-6
        diff_share = (err > 0).float().mean().item()
        far_share = (err > 2 * ulp).float().mean().item()
        ok = (bool(torch.isfinite(out).all()) and diff_share <= MAX_DIFF_SHARE
              and far_share <= MAX_FAR_SHARE and bool((err <= ceiling).all()))
        log(f"[kernel] {name}: max_abs_err {err.max().item():.3e}; share of "
            f"outputs != plain {diff_share:.3e} (limit {MAX_DIFF_SHARE:g}), "
            f"> 2 bf16 ulp {far_share:.3e} (limit {MAX_FAR_SHARE:g}); max "
            f"err/ceiling {(err / ceiling).max().item():.3f} (ceiling 2^-8 * "
            f"sum p|v| + 2 ulp) {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"kernel disagrees at {name}")
        return err.max().item()

    for i, (B, Lq, Lk, H, Dh) in enumerate(KERNEL_SHAPES):
        D = H * Dh
        q, k, v = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D)
        err = check(f"B={B} Lq={Lq} Lk={Lk} H={H} Dh={Dh}", q, k, v, H)
        if i == 0:
            state["max_abs_err"] = err
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                fn = fa.packed_attention_plain if which == "plain" \
                    else fa.packed_attention_cuda
                t[which].append(cuda_time_ms(lambda: fn(q, k, v, H)))
            state["ms"] = sum(t["kernel"]) / 2
            state["plain_ms"] = sum(t["plain"]) / 2
            gbytes = 2 * (2 * B * Lq * D + 2 * B * Lk * D) / 1e9
            log(f"[kernel] serving shape: kernel {t['kernel']} ms, plain "
                f"{t['plain']} ms (order plain, kernel, kernel, plain); "
                f"kernel moves {gbytes * 1e3:.1f} MB -> "
                f"{gbytes / (state['ms'] / 1e3):.0f} GB/s ({state['smi']})")
    # strided q (a row slice of a wider tensor) and the clamp regime
    B, Lq, Lk, H, Dh = KERNEL_SHAPES[1]
    big, k, v = rand(B, Lk, H * Dh), rand(B, Lk, H * Dh), rand(B, Lk, H * Dh)
    check("strided q (row slice)", big[:, :Lq], k, v, H)
    check("clamp regime (q x 30)", big[:, :Lq] * 30, k, v, H)


# w8a8 kernels against their plain versions: (most outputs that may differ
# at all, most that may differ by more than 2 bf16 ulp, ceiling in units of
# one int8 code flip); see _check_w8a8. Measured on an H100 (NVIDIA H100
# 80GB HBM3, 700.00 W) over the shapes below, worst case: B3 2.0e-5 /
# 2.7e-6 / 0.10; B4 1.3e-3 / 1.5e-4 / 1.31; B5 1.0e-4 / 1.0e-5 / 0.06.
# A B3 that rounds its LayerNorm output to bf16 before the quant gave
# >= 0.58 / 0.20, a B4 that rounds the fp32 attention output to bf16 before
# its quant >= 0.35 / 0.065, a B5 that rounds the hidden to bf16 >= 0.63 /
# 0.21: the share limits sit well above the right kernels and far below
# those.
# B2 has no LayerNorm and no attention sum, so its codes and its epilogue
# are the plain version's exactly: it must match bit for bit.
# The int8 QK^T attention is held to the limits of the kernel it is a form
# of (its integer scores are exact on both sides).
W8A8_LIMITS = {
    "w8a8_matmul": (0.0, 0.0, 0.0),
    "w8a8_matmul3_cat": (1e-3, 1e-4, 2.0),
    "attention_out_int8": (1e-2, 2e-3, 4.0),
    "w8a8_mlp_res": (5e-3, 1e-3, 2.0),
    # the single-source kernel's limits: the two-source entry point must
    # equal that kernel bit for bit on the concatenated keys
    "attention_out_int8_2src": (1e-2, 2e-3, 4.0),
}
# Without the residual the MLP's output is small beside a flip unit, so the
# rare row whose first-stage flip moves the hidden row's absmax (and with it
# every hidden code) shows: measured 2.54 units in one of 25,216 rows, while
# the shares stay where the residual form's are.
W8A8_LIMITS["w8a8_mlp"] = W8A8_LIMITS["w8a8_mlp_res"][:2] + (4.0,)
W8A8_LIMITS["attention_out_int8_qk8"] = W8A8_LIMITS["attention_out_int8"]
# The whole-layer kernel (csrc/mega_layer.cu) against its plain version: the
# same int8 codes and fp32 epilogues except where a LayerNorm, softmax or
# score / AV sum taken in another order (or expf against torch's exp) moves
# a value across a rounding tie. A tie flip in a k or v row of the first
# quant moves every query's softmax in its frame row, and the flips reach the
# output through LN2 and the whole hidden row, so (as between the port's
# plain version and the JAX kernel on the CPU, tests/test_torch_mega_layer.py)
# most of a frame row can move by a little: limits on the share of outputs
# that differ at all, beyond 2 bf16 ulp, and a ceiling of 2 ulp + k flip
# units of the hidden's quant (xs_hidden * s2 * 127). Measured on an H100
# (NVIDIA H100 80GB HBM3, 700.00 W): 64 frame rows 1.22e-2 / 3.1e-3 / 50.7,
# 128 frame rows 2.37e-2 / 6.1e-3 / 44.6, the ragged shape bit-equal. A
# kernel whose residual is rounded to bf16 after the out-projection (the
# serving composition's rounding) and one that takes the hidden's absmax
# over its first 1,024 values are rejected (utils/kernel_mutants.py).
MEGA_LIMITS = (5e-2, 1.5e-2, 100.0)
# (frame rows, Lx, Le, D, hidden, heads): the tool's shape (8 clips x 8
# frames), the serving batch (16 x 8), a ragged one (Lx, Le and the key
# count off every tile, 4 heads)
MEGA_SHAPES = ((64, 197, 17, 768, 3072, 12), (128, 197, 17, 768, 3072, 12),
               (3, 50, 5, 256, 1024, 4))
# shapes: the serving shape first, then ragged ones (M not a multiple of
# the tile, odd N, K not a multiple of 64, Le = 0, lq < Lkv). B2 also takes
# rows longer than the 1,024 values a warp holds in registers: the text
# MLP's fc2 (15 prompts x 77 tokens, K = 2,048, N = 512), a ragged K, and
# rows too long for 64 rows of codes in shared memory (16 and 8 per block),
# and the w8a8 text tower's out-projection and fc1 ("text": normal
# activations, on a generator of their own, after the other checks).
# Its inputs: raw pixels at the patch embed, else normal activations, whose
# absmax sits anywhere in the row (a kernel that took the absmax of the
# first 1,024 values only would wrap codes past 127 in about half the rows)
W8A8_MATMUL_SHAPES = ((25088, 768, 768, "pixels"), (37, 768, 77, "pixels"),
                      (45, 100, 33, "pixels"), (1155, 2048, 512, "normal"),
                      (37, 1100, 77, "normal"), (37, 4096, 77, "normal"),
                      (19, 8000, 40, "normal"), (1155, 512, 512, "text"),
                      (1155, 512, 2048, "text"))
W8A8_QKV_SHAPES = ((128, 197, 17, 768, 768), (3, 13, 5, 96, 40),
                   (4, 21, 0, 768, 768), (2, 9, 0, 64, 19))
# B3 at the long clip's 280 frame rows (4 x 70: 469 tiles of 128 rows, four
# rounds), checked after the others on a generator of its own
W8A8_QKV_LONG = (280, 197, 17, 768, 768)
# (B, lq, Lq rows of q, Lk, H)
W8A8_ATTN_SHAPES = ((128, 197, 214, 214, 12), (3, 13, 21, 21, 2),
                    (2, 77, 77, 150, 4), (2, 40, 100, 100, 12))
# (B, L1, L2, heads) of the two-source form: the serving shape (197 patch
# rows; 8 global + 1 summary + 8 local extras rows), then ragged ones (a
# second source that starts inside a 64-key tile, that fills one exactly,
# of one row)
W8A8_2SRC_SHAPES = ((128, 197, 17, 12), (3, 13, 5, 2), (2, 70, 64, 3),
                    (2, 64, 1, 4))
# (M, K, hidden, N[, "fallback": B5_FALLBACK_ROWS take the full first pass])
W8A8_MLP_SHAPES = ((25216, 768, 3072, 768), (37, 768, 3072, 768),
                   (20, 64, 200, 33), (200, 768, 3072, 768, "fallback"))
# B5's first pass keeps each row's largest pre-activation and takes the
# absmax from QuickGELU of it where that clears kQStar (csrc/w8a8_mlp.cuh);
# a block with a row below runs the full pass. These rows, constant at 0.5,
# have LayerNorm output beta, exactly; with beta at 0 their pre-activations
# are fc1's bias, here N(0, 0.02) with every 48th hidden column at -0.75,
# where |QuickGELU| peaks (0.1636). So their largest pre-activation (~0.06)
# gives QuickGELU ~0.03 and their absmax comes from the negative side:
# three of the four 64-row blocks of a 200-row shape take the full pass,
# the third the shortcut, and a kernel that always took the shortcut would
# quantize those rows' -0.75 columns at ~5x past code 127.
B5_FALLBACK_ROWS = (0, 70, 199)


def _b5_fallback_rows(x, fc1, ln):
    """Make B5_FALLBACK_ROWS of x take B5's full first pass (x, fc1's bias
    and the LayerNorm's beta in place)."""
    x[list(B5_FALLBACK_ROWS)] = 0.5
    ln[1].zero_()
    fc1["bias"][::48] = -0.75


# B5 with rows longer than the 1,024 values a warp holds in registers (a
# ragged K, and the longest that 64 rows of codes in shared memory take),
# over more than one row tile
W8A8_MLP_LONG_SHAPES = ((200, 1100, 512, 77), (70, 2048, 3072, 768))


def _qleaf(gen, K, N, heavy_frac=0.02, heavy_scale=16.0):
    """A w8a8 kernel leaf (int8 weight, fp32 channel scales, the kernels'
    W^T) from a random kernel whose input rows carry the heavy tail of real
    CLIP weights."""
    import torch
    from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
    from gava_clip_tpu_torch.ops.quant import quantize_weight
    w = torch.randn(K, N, generator=gen, device="cuda") * K ** -0.5
    n = max(1, round(K * heavy_frac))
    rows = torch.randperm(K, generator=gen, device="cuda")[:n]
    w[rows] *= heavy_scale
    qa, scale = quantize_weight(w)
    return with_kernel_layout({"qa": qa, "scale": scale})


def _ln_params(gen, K):
    """LayerNorm gain with 4% outlier channels (x8), small bias."""
    import torch
    g = torch.ones(K, device="cuda")
    n = max(1, round(K * 0.04))
    g[torch.randperm(K, generator=gen, device="cuda")[:n]] *= 8.0
    return g, torch.randn(K, generator=gen, device="cuda") * 0.02


def _flip_unit(xs, scale):
    """The most one int8 code flip can move an output: xs * s * 127."""
    return xs * scale.reshape(-1).float() * 127.0


def _check_w8a8(name, out, ref, unit):
    """Hold a w8a8 kernel output against its plain version. Both round the
    same values the same way (the epilogue is the same fp32 sequence); an
    output differs only where an int8 code flipped at a rounding tie (after
    a LayerNorm or attention sum taken in another order), and a flip moves
    it by at most `unit` = xs * s * 127. The ceiling is 2 ulp + k units."""
    import torch
    lim_diff, lim_far, lim_units = W8A8_LIMITS[name]
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref)
    diff_share = (err > 0).float().mean().item()
    far_share = (err > 2 * ulp).float().mean().item()
    units = ((err - 2 * ulp).clamp_min(0) / unit.clamp_min(1e-30)).max().item()
    ok = (bool(torch.isfinite(out).all()) and out.shape == ref.shape
          and diff_share <= lim_diff and far_share <= lim_far
          and units <= lim_units)
    return ok, err.max().item(), (
        f"max_abs_err {err.max().item():.3e}; outputs != plain "
        f"{diff_share:.3e} (limit {lim_diff:g}), > 2 bf16 ulp "
        f"{far_share:.3e} (limit {lim_far:g}), max (err - 2 ulp) / flip "
        f"unit {units:.3f} (limit {lim_units:g})")


def _int_mm_ms(gen, M, K, wt):
    """CUDA-event ms of the int8 product alone in one PyTorch call,
    torch._int_mm of (M, K) codes and the W^T (N, K) weight: a part of a
    w8a8 op (no quant, no epilogue) that the port never calls."""
    import torch
    a = torch.randint(-127, 128, (M, K), generator=gen, device="cuda",
                      dtype=torch.int8)
    b = wt.t()
    try:
        torch._int_mm(a, b)
    except RuntimeError:
        b = b.contiguous()
    return cuda_time_ms(lambda: torch._int_mm(a, b), iters=10)


def _yardsticks(state, name, kernel, other, what, int_mm_ms):
    """The kernel against `other` (the unfused kernels it replaces) in
    turns, median of 5 rounds, and the product alone through torch._int_mm;
    logged and kept beside the kernel's times (library_ms stays None)."""
    k, o, ratio, lo, hi = _ratio_turns(kernel, other, turns=5)
    log(f"[w8a8] {name} serving shape vs {what}, median of 5 rounds in "
        f"turns: {k:.4f} ms vs {o:.4f} ms, ratio {ratio:.3f} (rounds "
        f"{lo:.3f}-{hi:.3f}); the int8 product alone through torch._int_mm "
        f"{int_mm_ms:.4f} ms ({state['smi']})")
    state["kstats"][name]["yardsticks"] = {
        "unfused_ms": o, "kernel_ms_in_turns": k, "int_mm_ms": int_mm_ms}


def _b3_yardsticks(state, x, e, k3, b3, ln):
    """B3 against three B2 launches on its kv rows (the unfused q, k, v
    projections, without the LayerNorm); torch._int_mm of (27392, 768) x
    (768, 2304)."""
    import torch
    from gava_clip_tpu_torch.ops import int8_matmul as im
    gen = torch.Generator(device="cuda").manual_seed(5)
    kv = torch.cat([x, e], dim=1).reshape(-1, x.shape[-1])
    wt = torch.cat([k["qa_t"] for k in k3], dim=0)
    _yardsticks(state, "w8a8_matmul3_cat",
                lambda: im.w8a8_matmul3_cat_cuda(x, e, k3, b3, ln),
                lambda: [im.w8a8_matmul_cuda(kv, k, b)
                         for k, b in zip(k3, b3)],
                f"three B2 launches at ({kv.shape[0]}, {kv.shape[1]}, "
                f"{k3[0]['qa_t'].shape[0]})",
                _int_mm_ms(gen, kv.shape[0], kv.shape[1], wt))


def _b4_yardsticks(state, q, k, v, H, op, r, lq):
    """B4 against B1 (bf16 attention of the lq queries) followed by B2 (the
    out-projection of its rows); torch._int_mm of (B * lq, D) x (D, D)."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    gen = torch.Generator(device="cuda").manual_seed(6)
    B, _, D = q.shape
    a = torch.randn(B * lq, D, generator=gen, device="cuda").to(q.dtype)
    _yardsticks(state, "attention_out_int8",
                lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, lq),
                lambda: (fa.packed_attention_cuda(q[:, :lq], k, v, H),
                         im.w8a8_matmul_cuda(a, op["kernel"], op["bias"])),
                f"B1 + B2 at ({B}, {lq}, {k.shape[1]}, {H}) and "
                f"({B * lq}, {D}, {D})",
                _int_mm_ms(gen, B * lq, D, op["kernel"]["qa_t"]))


# (B frame rows, Lx patch tokens + the class token, Le prompt extras): the
# fused attention past the packed path's 640 keys, frames of 400^2 (626 +
# 17 = 643 keys) and 448^2 (785 + 17 = 802), beside the 224^2 frame's 214
# keys at the same 16 frame rows (timed only: held at 128 rows above)
LONG_KEY_SHAPES = ((16, 197, 17), (16, 626, 17), (16, 785, 17))


def _long_key_checks(state, dtype):
    """B4, B11 and B12 (`dtype` bfloat16 or float32: their fp32 forms) at
    LONG_KEY_SHAPES on 12 heads: q carries all Lx + Le rows of the kv
    projection, the first Lx are the queries (B12: q the Lx rows, the keys
    [k1 (Lx); k2 (Le)]). Past 640 keys each is held against its plain
    version within W8A8_LIMITS / F32_W8A8_LIMITS, as at 214 keys; each is
    timed by CUDA events at every shape, with its bound as the 214-key
    checks compute it. Into state['long_keys'][name]: [{Lk, ms, bound_ms,
    bound_by, max_abs_err}], and the failures into the dtype's list."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    f32 = dtype == torch.float32
    tag, H = ("w8a8-f32" if f32 else "w8a8"), 12
    D, esize = H * 64, (4 if f32 else 2)
    gen = torch.Generator(device="cuda").manual_seed(31)
    failures = state.setdefault("w8a8_f32_failures" if f32
                                else "w8a8_failures", [])

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    for B, Lx, Le in LONG_KEY_SHAPES:
        Lk = Lx + Le
        q, k, v = randn(B, Lk, D), randn(B, Lk, D), randn(B, Lk, D)
        r = randn(B, Lx, D)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        k1, v1, k2, v2 = k[:, :Lx], v[:, :Lx], k[:, Lx:], v[:, Lx:]
        q1 = q[:, :Lx].contiguous()
        # bytes: the lq query rows, the residual, the output, k, v, the
        # weight; B4: both attention products on the kernel's units (bf16
        # tensor cores, or fp32 FMA), B11: the scores in int8
        n_bytes = 3 * esize * B * Lx * D + 2 * esize * B * Lk * D + D * D \
            + 8 * D
        att = 2 * B * Lx * Lk * D
        out_proj = 2 * B * Lx * D * D
        checks = (
            ("attention_out_int8", False,
             lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, Lx),
             lambda: fa.attention_out_int8_plain(q, k, v, H, op, r, Lx),
             dict(ops_int8=out_proj, **{("flops_fp32" if f32 else
                                         "flops_bf16"): 2 * att})),
            ("attention_out_int8_qk8", True,
             lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, Lx, True),
             lambda: fa.attention_out_int8_plain(q, k, v, H, op, r, Lx,
                                                 True),
             dict(ops_int8=att + out_proj, **{("flops_fp32" if f32 else
                                               "flops_bf16"): att})),
            ("attention_out_int8_2src", False,
             lambda: fa.attention_out_int8_2src_cuda(q1, k1, v1, k2, v2, H,
                                                     op, r),
             lambda: fa.attention_out_int8_2src_plain(q1, k1, v1, k2, v2, H,
                                                      op, r),
             dict(ops_int8=out_proj, **{("flops_fp32" if f32 else
                                         "flops_bf16"): 2 * att})))
        for base, qk8, kernel, plain, ops in checks:
            name = base + ("_f32" if f32 else "")
            label = f"B={B} lq={Lx} Lq={Lk} Lk={Lk} H={H}"
            out = kernel()
            text = "timed only (held at 128 frame rows above)"
            err = None
            if Lk > 640:
                ref = plain()
                xs = im.quant_rows(fa._onepass_attention_den_f32(
                    q[:, :Lx], k, v, H, int8_qk=qk8)[0])[1]
                unit = _flip_unit(xs, op["kernel"]["scale"])
                torch.cuda.synchronize()
                ok, err, text = _check_w8a8_f32(name, out, ref, unit, r) \
                    if f32 else _check_w8a8(name, out, ref, unit)
                text += " " + ("ok" if ok else "FAIL")
                if not ok:
                    failures.append(f"{name} {label}")
                del ref
            ms = cuda_time_ms(kernel, iters=10)
            bound = _bound(n_bytes, **ops)
            state.setdefault("long_keys", {}).setdefault(name, []).append(
                {"Lk": Lk, "ms": ms, "bound_ms": bound[0],
                 "bound_by": bound[1], "max_abs_err": err})
            log(f"[{tag}] {name} {label} (past 640 keys: {Lk > 640}): "
                f"{ms:.4f} ms by CUDA events, bound {bound[0]:.4f} ms "
                f"({bound[1]}) ({state['smi']}); {text}")


def phase_w8a8_kernels(state):
    """B2-B5 against their plain versions, at the serving shape and ragged
    ones, with CUDA-event times of both at the serving shape."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, gain=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * gain).to(bf)

    def run(name, label, kernel, plain, unit, first, bound=None, timed=None):
        """Check `kernel` against `plain`; at the serving shape (`first`)
        time them, or the pair `timed` (the same calls without what the
        check adds to them)."""
        out, ref = kernel(), plain()
        torch.cuda.synchronize()
        ok, err, text = _check_w8a8(name, out, ref, unit)
        log(f"[w8a8] {name} {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8a8_failures", []).append(f"{name} {label}")
        if first:
            kernel, plain = timed or (kernel, plain)
            t = {"plain": [], "kernel": []}
            for which in ("plain", "kernel", "kernel", "plain"):
                t[which].append(cuda_time_ms(kernel if which == "kernel"
                                             else plain, iters=10))
            # no one PyTorch call computes a w8a8 op: no library time
            state.setdefault("kstats", {})[name] = {
                "max_abs_err": err, "ms": sum(t["kernel"]) / 2,
                "plain_ms": sum(t["plain"]) / 2, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}
            log(f"[w8a8] {name} serving shape: kernel {t['kernel']} ms, "
                f"plain {t['plain']} ms, bound {bound[0]:.4f} ms "
                f"({bound[1]}) (order plain, kernel, kernel, plain; "
                f"{state['smi']})")

    def b2_check(M, K, N, kind, g, first):
        x = torch.randint(0, 256, (M, K), generator=g,
                          device="cuda").to(bf) if kind == "pixels" \
            else torch.randn(M, K, generator=g, device="cuda").to(bf)
        kern = _qleaf(g, K, N)
        b = torch.randn(N, generator=g, device="cuda") * 0.1
        unit = _flip_unit(im.quant_rows(x.float())[1], kern["scale"])
        run("w8a8_matmul", f"M={M} K={K} N={N}",
            lambda: im.w8a8_matmul_cuda(x, kern, b),
            lambda: im.w8a8_matmul_plain(x, kern, b), unit, first,
            _bound(2 * M * K + K * N + 8 * N + 2 * M * N,
                   ops_int8=2 * M * K * N))
        if first:
            # the int8 product alone through torch._int_mm (a yardstick: no
            # quant, no epilogue), and the kernel's device time in a graph
            mm = _int_mm_ms(torch.Generator(device="cuda").manual_seed(8), M,
                            K, kern["qa_t"])
            graph = cuda_time_ms(_graph_call(
                lambda: im.w8a8_matmul_cuda(x, kern, b)),
                iters=5) / GRAPH_LAUNCHES
            state["kstats"]["w8a8_matmul"]["yardsticks"] = {
                "int_mm_ms": mm, "graph_ms": graph}
            log(f"[w8a8] w8a8_matmul M={M} K={K} N={N}: {graph:.5f} ms a "
                f"launch in a CUDA graph of {GRAPH_LAUNCHES}; the int8 "
                f"product alone through torch._int_mm {mm:.4f} ms "
                f"({state['smi']})")

    # the rows of at most 1,024 values first, on the generator the checks
    # below draw from; the long rows last, on one of their own
    short = [s for s in W8A8_MATMUL_SHAPES if s[1] <= 1024 and s[3] != "text"]
    for i, shape in enumerate(short):
        b2_check(*shape, gen, i == 0)

    # the long clip's shape draws from a generator of its own: the checks
    # after it keep their inputs
    gen_long = torch.Generator(device="cuda").manual_seed(25)
    for i, (B, Lx, Le, K, N) in enumerate(W8A8_QKV_SHAPES + (W8A8_QKV_LONG,)):
        g = gen if i < len(W8A8_QKV_SHAPES) else gen_long

        def draw(*shape, g=g):
            return torch.randn(*shape, generator=g,
                               device="cuda").to(torch.bfloat16)
        x, e = draw(B, Lx, K), (draw(B, Le, K) if Le else None)
        ln = _ln_params(g, K)
        k3 = [_qleaf(g, K, N) for _ in range(3)]
        b3 = [torch.randn(N, generator=g, device="cuda") * 0.02
              for _ in range(3)]
        xs = im.quant_rows(im.ln_f32(im._kv_rows(x, e).float(), *ln))[1]
        unit = torch.cat([_flip_unit(xs, k["scale"]) for k in k3], dim=-1)
        args = (x, e, k3, b3, ln)
        run("w8a8_matmul3_cat", f"B={B} Lx={Lx} Le={Le} K={K} N={N}",
            lambda: torch.cat(im.w8a8_matmul3_cat_cuda(*args), dim=-1),
            lambda: torch.cat(im.w8a8_matmul3_cat_plain(*args), dim=-1),
            unit, i == 0,
            _bound(B * (Lx + Le) * (2 * K + 6 * N) + 3 * K * N + 24 * N
                   + 8 * K, ops_int8=6 * B * (Lx + Le) * K * N),
            (lambda: im.w8a8_matmul3_cat_cuda(*args),
             lambda: im.w8a8_matmul3_cat_plain(*args)))
        if i == 0:
            _b3_yardsticks(state, x, e, k3, b3, ln)

    for i, (B, lq, Lq, Lk, H) in enumerate(W8A8_ATTN_SHAPES):
        D = H * 64
        q, k, v = randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        r = randn(B, lq, D)
        xs = im.quant_rows(fa._onepass_attention_f32(q[:, :lq], k, v, H))[1]
        unit = _flip_unit(xs, op["kernel"]["scale"])
        run("attention_out_int8", f"B={B} lq={lq} Lq={Lq} Lk={Lk} H={H}",
            lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, lq),
            lambda: fa.attention_out_int8_plain(q, k, v, H, op, r, lq),
            unit, i == 0,
            # the lq query rows, k, v, the weight, the residual, the output
            _bound(6 * B * lq * D + 4 * B * Lk * D + D * D + 8 * D,
                   flops_bf16=4 * B * lq * Lk * D,
                   ops_int8=2 * B * lq * D * D))
        if i == 0:
            _b4_yardsticks(state, q, k, v, H, op, r, lq)

    def b5_check(M, K, Hd, N, g, first, fallback=None):
        x = torch.randn(M, K, generator=g, device="cuda").to(bf)
        r = torch.randn(M, N, generator=g, device="cuda").to(bf)
        ln = _ln_params(g, K)
        fc1 = {"kernel": _qleaf(g, K, Hd),
               "bias": torch.randn(Hd, generator=g, device="cuda") * 0.02}
        fc2 = {"kernel": _qleaf(g, Hd, N),
               "bias": torch.randn(N, generator=g, device="cuda") * 0.02}
        if fallback:
            _b5_fallback_rows(x, fc1, ln)
        k1 = fc1["kernel"]
        codes, xs = im.quant_rows(im.ln_f32(x.float(), *ln))
        h = im.quick_gelu_f32(im.rescale(im.int_matmul(codes, k1["qa"]), xs,
                                         k1["scale"], fc1["bias"]))
        unit = _flip_unit(im.quant_rows(h)[1], fc2["kernel"]["scale"])
        del codes, h
        run("w8a8_mlp_res", f"M={M} K={K} H={Hd} N={N}"
            + (f" rows {B5_FALLBACK_ROWS} take the full first pass"
               if fallback else ""),
            lambda: im.w8a8_mlp_res_cuda(x, fc1, fc2, ln, r),
            lambda: im.w8a8_mlp_res_plain(x, fc1, fc2, ln, r), unit, first,
            _bound(2 * M * K + 4 * M * N + K * Hd + Hd * N
                   + 8 * (Hd + N + K), ops_int8=2 * M * Hd * (K + N)))

    # the fallback shape on a generator of its own: the checks after it
    # keep their inputs
    gen_fallback = torch.Generator(device="cuda").manual_seed(23)
    for i, (M, K, Hd, N, *fallback) in enumerate(W8A8_MLP_SHAPES):
        b5_check(M, K, Hd, N, gen_fallback if fallback else gen, i == 0,
                 *fallback)
    # the two-source form last: the checks above keep their random inputs
    for i, (B, L1, L2, H) in enumerate(W8A8_2SRC_SHAPES):
        D = H * 64
        q, k1, v1, r = (randn(B, L1, D) for _ in range(4))
        k2, v2 = randn(B, L2, D), randn(B, L2, D)
        kc, vc = torch.cat([k1, k2], dim=1), torch.cat([v1, v2], dim=1)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        xs = im.quant_rows(fa._onepass_attention_f32(q, kc, vc, H))[1]
        unit = _flip_unit(xs, op["kernel"]["scale"])
        args = (q, k1, v1, k2, v2, H, op, r)
        run("attention_out_int8_2src", f"B={B} L1={L1} L2={L2} H={H}",
            lambda: fa.attention_out_int8_2src_cuda(*args),
            lambda: fa.attention_out_int8_2src_plain(*args), unit, i == 0,
            # q, the residual, the output; k1, v1, k2, v2; the weight
            _bound(6 * B * L1 * D + 4 * B * (L1 + L2) * D + D * D + 8 * D,
                   flops_bf16=4 * B * L1 * (L1 + L2) * D,
                   ops_int8=2 * B * L1 * D * D))
        for qk8 in (False, True):
            two = fa.attention_out_int8_2src_cuda(*args, qk8)
            one = fa.attention_out_int8_cuda(q, kc, vc, H, op, r, None, qk8)
            plain = fa.attention_out_int8_2src_plain(*args, qk8)
            torch.cuda.synchronize()
            same = torch.equal(two, one)
            diff = (two != plain).float().mean().item()
            form = "int8 QK^T" if qk8 else "fp32 scores"
            log(f"[w8a8] attention_out_int8_2src B={B} L1={L1} L2={L2} "
                f"H={H}, {form}: equal to the single-source kernel on "
                f"[k1; k2] bit for bit: {same}; outputs != plain {diff:.3e} "
                f"(limit {W8A8_LIMITS['attention_out_int8_2src'][0]:g})")
            if not same or diff > W8A8_LIMITS["attention_out_int8_2src"][0]:
                state.setdefault("w8a8_failures", []).append(
                    f"attention_out_int8_2src B={B} L2={L2} {form}")
        if i == 0:
            t_two = cuda_time_ms(
                lambda: fa.attention_out_int8_2src_cuda(*args))
            t_one = cuda_time_ms(
                lambda: fa.attention_out_int8_cuda(q, kc, vc, H, op, r))
            t_cat = cuda_time_ms(lambda: (torch.cat([k1, k2], dim=1),
                                          torch.cat([v1, v2], dim=1)))
            log(f"[w8a8] attention_out_int8_2src serving shape: {t_two:.4f} "
                f"ms; the single-source kernel on keys concatenated "
                f"beforehand {t_one:.4f} ms, the two concatenations "
                f"{t_cat:.4f} ms ({state['smi']})")
    gen_long = torch.Generator(device="cuda").manual_seed(4)
    for shape in W8A8_MATMUL_SHAPES:
        if shape[1] > 1024:
            b2_check(*shape, gen_long, False)
    for shape in W8A8_MLP_LONG_SHAPES:
        b5_check(*shape, gen_long, False)
    gen_text = torch.Generator(device="cuda").manual_seed(7)
    for shape in W8A8_MATMUL_SHAPES:
        if shape[3] == "text":
            b2_check(*shape, gen_text, False)
    # B5's QuickGELU takes its reciprocal without the division's slow path:
    # it must be the IEEE reciprocal for every d in [1, 2^126)
    from gava_clip_tpu_torch.ops._cuda import load_library
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    err = load_library("w8a8_mlp").w8a8_mlp_rcp_check(
        bad.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    n_bad = bad.item()
    log(f"[w8a8] w8a8_mlp reciprocal: {n_bad} of the 1,056,964,608 floats "
        f"in [1, 2^126) differ from the IEEE reciprocal (launch {err}) "
        f"{'ok' if err == 0 and n_bad == 0 else 'FAIL'}")
    if err or n_bad:
        state.setdefault("w8a8_failures", []).append("w8a8_mlp reciprocal")
    # its first pass takes a row's absmax from QuickGELU of its largest
    # pre-activation: qgelu must be non-decreasing over the non-negative
    # floats and at most kQStar in magnitude over the negative ones
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    err = load_library("w8a8_mlp").w8a8_mlp_qgelu_check(
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    falls, above, most = out.tolist()
    most = struct.unpack("<f", struct.pack("<I", most))[0]
    # (the least of v * sigma(1.702 v) in real numbers is -0.163610: a
    # largest |qgelu| below that means the negative floats were not run)
    ok = err == 0 and falls == 0 and above == 0 and most > 0.1636
    log(f"[w8a8] w8a8_mlp QuickGELU: {falls} of the 2,139,095,040 "
        f"non-negative floats with qgelu(next float) < qgelu(u); {above} "
        f"of the negative floats with |qgelu| above the kernel's kQStar, "
        f"the largest |qgelu| of them {most!r} (launch {err}) "
        f"{'ok' if ok else 'FAIL'}")
    state["b5_qgelu_check"] = {"falls": falls, "above": above,
                               "largest_negative": most}
    if not ok:
        state.setdefault("w8a8_failures", []).append("w8a8_mlp QuickGELU")
    _long_key_checks(state, torch.bfloat16)
    if state.get("w8a8_failures"):
        raise AssertionError(f"w8a8 kernels disagree with their plain "
                             f"versions: {state['w8a8_failures']}")


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)


def _logits_three_ways(model, params, classnames, xn):
    """Logits of normalized frames xn: bf16 weights with the kernel, bf16
    weights with plain attention, and an fp32 plain-attention reference."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import VitaClip
    clf = _classifier(model, params, classnames)
    ref32 = VitaClip(model.cfg, _to_device(params, "cuda"),
                     model.text_features.cuda())
    with torch.inference_mode():
        return (clf.net(xn, compute_dtype=torch.bfloat16,
                        attn_impl="flash")["logits"],
                clf.net(xn, compute_dtype=torch.bfloat16,
                        attn_impl="xla")["logits"],
                ref32(xn, compute_dtype=torch.float32,
                      attn_impl="xla")["logits"])


def _classifier(model, params, classnames, **kw):
    from gava_clip_tpu_torch.serve import VideoClassifier
    return VideoClassifier(model, params, classnames, batch_size=16,
                           device="cuda", **kw)


def _check_probs(name, p, n):
    if p.shape != (n, 400) or not np.isfinite(p).all():
        raise AssertionError(f"{name}: bad probabilities {p.shape}")
    err = np.abs(p.sum(-1) - 1.0).max()
    if err > 1e-3:
        raise AssertionError(f"{name}: probabilities sum off by {err}")


def _serving_times(clf, clips, x, iters=10):
    """(clips/s end to end at batch 16, device forward ms, batch-1 latency
    p50 ms)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        clf.classify_clips(clips)
    e2e = 16 * iters / (time.perf_counter() - t0)
    fwd_ms = cuda_time_ms(lambda: clf._forward(x), iters=iters)
    lat = []
    for _ in range(20):
        t1 = time.perf_counter()
        clf.classify_clips(clips[:1])
        lat.append((time.perf_counter() - t1) * 1e3)
    return e2e, fwd_ms, float(np.median(lat))


def phase_slice(state):
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    from gava_clip_tpu_torch.data.video import parse_classes_file
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.utils.flagship import (build_zero_shot,
                                                    inject_clip_pathologies)
    _, labels = parse_classes_file(os.path.join(ROOT, "classes",
                                                "k400_classes.txt"))
    t0 = time.perf_counter()
    model = build_zero_shot(num_frames=8, num_classes=400, input_size=224,
                            rng_seed=0)
    params = inject_clip_pathologies(model.param_tree(), seed=0)
    clf = _classifier(model, params, labels)
    assert clf.attn_impl == "flash"
    clf.warmup()
    log(f"[slice] built + warmed up in {time.perf_counter() - t0:.1f} s "
        f"(ViT-B/16, T=8, 224^2, 400 classes, bf16, batch 16)")
    clips = np.random.RandomState(0).randint(0, 256, (16, 8, 224, 224, 3),
                                             dtype=np.uint8)

    fa.reset_launch_counts()
    p16 = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n16 = fa.launch_counts["packed_attention"]
    p5 = clf.classify_clips(clips[:5])
    torch.cuda.synchronize()
    n_all = fa.launch_counts["packed_attention"]
    state["launches"] = n_all
    log(f"[slice] packed_attention launches: {n16} for the 16-clip forward, "
        f"{n_all - n16} for the 5-clip forward (expect 12 each)")
    if (n16, n_all) != (12, 24):
        raise AssertionError("the main path did not launch the kernel once "
                             "per block")
    _check_probs("16 clips", p16, 16)
    _check_probs("5 clips", p5, 5)
    # the 5-clip request pads to the bucket of 8: other GEMM shapes, so
    # only bf16 noise may differ
    d_pad = np.abs(p5 - p16[:5]).max()

    # the same forward with plain attention, and an fp32 reference (fp32
    # weights and activations, plain attention), on the pathology-injected
    # weights and on the plain init. The kernel path and the plain bf16
    # path round differently (fp32 scores and bf16 e vs bf16 q*scale and
    # bf16 probabilities), so neither equals the other bit for bit.
    x = clf._prepare(clips)
    with torch.inference_mode():
        xn = normalize_frames(x, clf._mean, clf._std)
    lg, lg_xla, lg_32 = _logits_three_ways(model, params, labels, xn)
    d_logit = (lg - lg_xla).abs().max().item()
    d_flash = (lg - lg_32).abs().max().item()
    d_xla = (lg_xla - lg_32).abs().max().item()
    log(f"[slice] pathology weights, max |logit diff|: kernel vs plain bf16 "
        f"{d_logit:.4f}, kernel vs fp32 reference {d_flash:.4f}, plain bf16 "
        f"vs fp32 reference {d_xla:.4f} (fp32 logits span "
        f"{lg_32.min().item():.3f}..{lg_32.max().item():.3f}); padded (5 of "
        f"8) vs full batch max |prob diff| {d_pad:.2e}")
    # the outlier gains make the bf16 tower noisy whatever the attention:
    # the kernel path must be as close to fp32 as the plain bf16 path
    if not bool(torch.isfinite(lg).all()) or d_flash > 1.5 * d_xla + 0.01:
        raise AssertionError("the kernel path is farther from the fp32 "
                             "reference than the plain bf16 path")
    if d_pad > 1e-3:
        raise AssertionError("padding a partial batch changed the results")
    lg, lg_xla, lg_32 = _logits_three_ways(model, model.param_tree(), labels,
                                           xn)
    d_plain = (lg - lg_32).abs().max().item()
    log(f"[slice] plain init, max |logit diff|: kernel vs fp32 reference "
        f"{d_plain:.4f}, plain bf16 vs fp32 reference "
        f"{(lg_xla - lg_32).abs().max().item():.4f}")
    # without outliers bf16 tracks fp32 closely: 0.1 logit is 0.7% of
    # exp(logit_scale) = 14.3, a few bf16 ulps of the features
    if d_plain > 0.1:
        raise AssertionError("the kernel path disagrees with the fp32 "
                             "reference on the plain init")

    # throughput at batch 16 (host prep + H2D + forward + D2H) and the
    # device forward alone
    e2e, fwd_ms, lat = _serving_times(clf, clips, x)
    state.update(clf=clf, clips=clips, fwd_ms=fwd_ms, model=model,
                 params=params, labels=labels, p16_bf16=p16,
                 d_logit_bf16_paths=d_logit)
    log(f"[slice] batch 16: {e2e:.1f} clips/s end to end, device forward "
        f"{fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s; batch 1 latency p50 "
        f"{lat:.2f} ms ({state['smi']})")


# the w8a8 forward against the same forward with the plain versions of its
# four ops on the card, most |logit diff| allowed: on the plain init, and on
# the pathology weights as a multiple of how far the bf16 kernel path sits
# from the plain bf16 path in the same run (see phase_w8a8_slice)
W8A8_MAX_LOGIT_DIFF_INIT = 0.1
W8A8_PATHOLOGY_FACTOR = 1.5
# the repo's w8a8 accuracy gate: max softmax-prob delta against the bf16
# classifier on the same clips (bench.py)
W8A8_PROB_GATE = 0.05
W8A8_PER_FORWARD = {"w8a8_matmul": 1, "w8a8_matmul3_cat": 12,
                    "attention_out_int8": 12, "w8a8_mlp_res": 12,
                    "packed_attention": 0}


def _launch_counts():
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    from gava_clip_tpu_torch.tools import bench_attn_variants as tool
    return {**fa.launch_counts, **im.launch_counts, **ek.launch_counts,
            **tool.launch_counts}


def _reset_launch_counts():
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    from gava_clip_tpu_torch.tools import bench_attn_variants as tool
    fa.reset_launch_counts()
    im.reset_launch_counts()
    ek.reset_launch_counts()
    tool.reset_launch_counts()


def _w8a8_logits(clf, x, impl: str):
    """Logits of uint8 patch rows x through the kernels ('kernel') or the
    plain versions of the same four ops ('plain'), on the card."""
    import torch
    with torch.inference_mode():
        return clf.net(x.to(torch.bfloat16), compute_dtype=torch.bfloat16,
                       attn_impl="flash", input_format="patches",
                       int8_impl=impl)["logits"]


def phase_w8a8_slice(state):
    """The w8a8 + patch-major zero-shot path (ViT-B/16, T=8, 224^2, 400
    classes) at batch 16 on the pathology-injected weights."""
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    model, params, labels = state["model"], state["params"], state["labels"]
    clips = state["clips"]
    t0 = time.perf_counter()
    clf = _classifier(model, params, labels, quantize="w8a8",
                      patch_major=True)
    assert clf.attn_impl == "flash"
    clf.warmup()
    log(f"[w8a8-slice] built + warmed up in {time.perf_counter() - t0:.1f}"
        f" s (w8a8 + patch-major, batch 16)")

    _reset_launch_counts()
    p16 = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n16 = _launch_counts()
    p5 = clf.classify_clips(clips[:5])
    torch.cuda.synchronize()
    n_all = _launch_counts()
    state["launches_w8a8"] = n_all
    log(f"[w8a8-slice] launches for the 16-clip forward {n16}, after the "
        f"5-clip forward {n_all} (expect {W8A8_PER_FORWARD} per forward)")
    for name, per in W8A8_PER_FORWARD.items():
        if (n16[name], n_all[name]) != (per, 2 * per):
            raise AssertionError(f"{name}: {n16[name]} / {n_all[name]} "
                                 f"launches, expected {per} per forward")
    _check_probs("16 clips", p16, 16)
    _check_probs("5 clips", p5, 5)
    d_pad = np.abs(p5 - p16[:5]).max()
    if d_pad > 1e-3:
        raise AssertionError("padding a partial batch changed the results")

    # kernels vs the plain versions of the same four ops, on the pathology
    # weights and on the plain init
    x = clf._prepare(clips)
    lg, lg_plain = (_w8a8_logits(clf, x, i) for i in ("kernel", "plain"))
    d_path = (lg - lg_plain).abs().max().item()
    init_clf = _classifier(model, model.param_tree(), labels,
                           quantize="w8a8", patch_major=True)
    lg_i, lg_i_plain = (_w8a8_logits(init_clf, x, i)
                        for i in ("kernel", "plain"))
    d_init = (lg_i - lg_i_plain).abs().max().item()
    del init_clf
    # the repo's gate: prob delta against the bf16 classifier
    bf16 = state["clf"]
    with torch.inference_mode():
        xn = normalize_frames(bf16._prepare(clips), bf16._mean, bf16._std)
        lg_bf16 = bf16.net(xn, compute_dtype=torch.bfloat16,
                           attn_impl="flash")["logits"]
    d_prob = np.abs(p16 - state["p16_bf16"]).max()
    d_logit_bf16 = (lg - lg_bf16).abs().max().item()
    state["w8a8_accuracy"] = dict(d_path=d_path, d_init=d_init,
                                  d_prob=d_prob, d_logit_bf16=d_logit_bf16,
                                  d_pad=d_pad)
    # A code flipped at a rounding tie (another LayerNorm or attention sum
    # order) moves one row by one int8 step; the random 12-block tower
    # amplifies such steps on the pathology weights (x8 LN gains, x16
    # kernel rows) as it amplifies bf16 rounding, so there the w8a8 kernels
    # may sit no farther from their plain versions than the bf16 kernel sits
    # from plain bf16 attention (x1.5); on the plain init both stay close.
    lim_path = W8A8_PATHOLOGY_FACTOR * state["d_logit_bf16_paths"]
    log(f"[w8a8-slice] max |logit diff| kernels vs plain versions: "
        f"pathology weights {d_path:.4f} (limit {lim_path:.4f} = "
        f"{W8A8_PATHOLOGY_FACTOR} x the bf16 kernel-vs-plain "
        f"{state['d_logit_bf16_paths']:.4f}), plain init {d_init:.4f} "
        f"(limit {W8A8_MAX_LOGIT_DIFF_INIT}); logits span "
        f"{lg_plain.min().item():.3f}..{lg_plain.max().item():.3f}; padded "
        f"(5 of 8) vs full batch max |prob diff| {d_pad:.2e}")
    log(f"[w8a8-slice] gate vs the bf16 classifier: max |prob diff| "
        f"{d_prob:.4e} (limit {W8A8_PROB_GATE}), max |logit diff| "
        f"{d_logit_bf16:.4f}")
    if not bool(torch.isfinite(lg).all()) or d_path > lim_path or \
            d_init > W8A8_MAX_LOGIT_DIFF_INIT:
        raise AssertionError("the w8a8 kernels' forward disagrees with the "
                             "plain versions' forward")
    if d_prob > W8A8_PROB_GATE:
        raise AssertionError("the w8a8 forward fails the prob-delta gate")

    e2e, fwd_ms, lat = _serving_times(clf, clips, x)
    plain_ms = cuda_time_ms(lambda: _w8a8_logits(clf, x, "plain"), iters=3,
                            warmup=1)
    state.update(clf_w8a8=clf, fwd_ms_w8a8=fwd_ms)
    log(f"[w8a8-slice] batch 16: {e2e:.1f} clips/s end to end, device "
        f"forward {fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s (bf16 path "
        f"{state['fwd_ms']:.2f} ms; the forward through the plain versions "
        f"{plain_ms:.2f} ms); batch 1 latency p50 {lat:.2f} ms "
        f"({state['smi']})")
    _w8a8_slice_400(state, labels)


# frames of 400^2: 625 patches + the class token and 17 prompt-extras rows,
# 643 keys a frame row, past the packed path's 640
W8A8_400_BATCH = 4


def _w8a8_slice_400(state, labels):
    """VideoClassifier(quantize="w8a8", patch_major=True) on
    build_zero_shot(input_size=400) (its seeded init) at batch 4: the
    probabilities, 12 launches of B4 (and of B3, B5) per forward with no
    packed attention, the logits against the same forward through the
    plain versions within W8A8_MAX_LOGIT_DIFF_INIT (the slice's limit on
    the plain init), clips/s."""
    import torch
    from gava_clip_tpu_torch.serve import VideoClassifier
    from gava_clip_tpu_torch.utils.flagship import build_zero_shot
    t0 = time.perf_counter()
    model = build_zero_shot(num_frames=8, num_classes=400, input_size=400,
                            rng_seed=0)
    clf = VideoClassifier(model, model.param_tree(), labels,
                          batch_size=W8A8_400_BATCH, device="cuda",
                          quantize="w8a8", patch_major=True).warmup()
    clips = np.random.RandomState(4).randint(
        0, 256, (W8A8_400_BATCH, 8, 400, 400, 3), dtype=np.uint8)
    log(f"[w8a8-slice] 400^2 classifier built + warmed up in "
        f"{time.perf_counter() - t0:.1f} s (643 keys a frame row)")
    _reset_launch_counts()
    p = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n = _launch_counts()
    x = clf._prepare(clips)
    lg, lg_plain = (_w8a8_logits(clf, x, i) for i in ("kernel", "plain"))
    d = (lg - lg_plain).abs().max().item()
    t1 = time.perf_counter()
    for _ in range(5):
        clf.classify_clips(clips)
    e2e = 5 * W8A8_400_BATCH / (time.perf_counter() - t1)
    fwd_ms = cuda_time_ms(lambda: clf._forward(x), iters=5)
    counts = {k: n[k] for k in W8A8_PER_FORWARD}
    ok = counts == W8A8_PER_FORWARD and bool(torch.isfinite(lg).all()) \
        and d <= W8A8_MAX_LOGIT_DIFF_INIT
    log(f"[w8a8-slice] 400^2, batch {W8A8_400_BATCH}: launches {counts} "
        f"(expect {W8A8_PER_FORWARD}); max |logit diff| kernels vs plain "
        f"versions {d:.4f} (limit {W8A8_MAX_LOGIT_DIFF_INIT}); "
        f"{e2e:.2f} clips/s end to end, device forward {fwd_ms:.2f} ms = "
        f"{W8A8_400_BATCH * 1e3 / fwd_ms:.2f} clips/s ({state['smi']}) "
        f"{'ok' if ok else 'FAIL'}")
    state["w8a8_400"] = {"clips_per_s": e2e, "fwd_ms": fwd_ms, "d_logit": d}
    _check_probs("400^2 clips", p, W8A8_400_BATCH)
    if not ok:
        raise AssertionError("the w8a8 classifier at 400^2 failed its "
                             "checks")
    del clf, model, x
    torch.cuda.empty_cache()


# (B, Lq, Lk, heads): the two training shapes of the packed kernels first
# (16 clips x 8 frames; 4 clips x 70 frames: 197 query tokens, 197 + 8
# global + 1 summary + T local keys), then ragged ones, then the edge of
# the packed path: 640 keys, and a long ragged Lq whose dq accumulator
# lies in global scratch (the backward's launch plan)
TRAIN_PACKED_SHAPES = ((128, 197, 214, 12), (280, 197, 276, 12),
                       (3, 13, 21, 2), (2, 77, 150, 4), (2, 65, 64, 3),
                       (4, 640, 640, 12), (2, 1030, 200, 3))
# (B, Lq, Lk, heads, causal): the text tower's shape first (15 prompts x 77
# tokens, 8 heads), then a longer causal L, non-causal keys beyond the
# packed kernel's 640, and ragged cross shapes
TRAIN_STREAM_SHAPES = ((15, 77, 77, 8, True), (4, 1024, 1024, 8, True),
                       (2, 130, 700, 2, False), (3, 13, 21, 2, False),
                       (2, 100, 60, 2, True), (2, 200, 200, 3, True))
# Limits of the training kernels against their plain versions: (most
# outputs that may differ at all, most that may differ by more than 2 bf16
# ulp + the floor, and the ceiling's factor k in err <= 2 ulp + k * 2^-8 *
# bound). Both versions round each weight (e or p), each ds and each output
# to bf16 at the same points, so they differ only where an fp32 sum taken
# in another order lands next to a rounding boundary; one flipped rounding
# moves one term of a sum by 2^-8 of itself. bound is sum p|v| for a
# forward (exact: the plain version on |v|) and the largest |gradient| of
# the tensor for a backward (a term of a gradient sum is at most of that
# order). The streaming forward rescales by a running max, so the bf16
# rounding of p falls at another point than in its plain version (which
# knows the final max): there most outputs may differ by an ulp, and only
# the far share and the ceiling are held. Measured on an H100 (NVIDIA H100
# 80GB HBM3, 700.00 W), worst over the shapes above: packed forward 3.9e-4
# / 3.6e-5, den exact in all but 2.3e-3 of the rows, packed backward 6.4e-4
# / 5.8e-5; streaming forward 3.4e-1 / 5.7e-2, streaming backward 6.3e-3 /
# 6.2e-3 (all of it gradients that cancel to ~1e-7 of the tensor's scale,
# below the floor of 2^-16 of the largest |gradient|).
TRAIN_LIMITS = {
    "packed_attention_den": (5e-3, 1e-3, 1.0),
    "packed_attention_bwd": (5e-3, 1e-3, 2.0),
    "packed_attention_bwd_recompute": (5e-3, 1e-3, 2.0),
    "streaming_attention": (1.0, 1.5e-1, 1.0),
    "streaming_attention_bwd": (5e-2, 5e-3, 2.0),
}
# den: the sum of at most 640 bf16 values in fp32 is exact in most rows
# whatever the order; a kernel that sums the unrounded e moves every row
# The recompute backward against the saved-residual backward's own output:
# the two differ in one rounding (delta from the fp32 output instead of its
# bf16 rounding), which moves delta by up to 2^-9 of sum |do * o| and with
# it about a fifth of the bf16 values of ds; held as a relative L2 distance
# per gradient (measured 2e-3 .. 4e-3 on an H100)
RECOMPUTE_VS_SAVED_MAX_REL_L2 = 2e-2
MAX_DEN_DIFF_SHARE = 2e-2
MAX_DEN_REL_ERR = 2.0 ** -8
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12
H100_INT8_OPS = 1979e12
H100_FP32_FLOPS = 67e12
H100_TF32_FLOPS = 495e12


def _bound(n_bytes, flops_bf16=0.0, ops_int8=0.0, flops_fp32=0.0,
           flops_tf32=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the card's memory
    rate and the operations over the card's peak rate for their type
    (H100 SXM data sheet); an fp32 product taken as 3xTF32 counts three
    TF32 products."""
    t_bytes = n_bytes / H100_BYTES_PER_S * 1e3
    t_ops = (flops_bf16 / H100_BF16_FLOPS + ops_int8 / H100_INT8_OPS
             + flops_fp32 / H100_FP32_FLOPS
             + flops_tf32 / H100_TF32_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _visible_pairs(Lq, Lk, causal):
    """Score entries that the mask leaves visible."""
    if not causal:
        return Lq * Lk
    return sum(min(i + 1, Lk) for i in range(Lq))


def _attention_bounds(B, Lq, Lk, H, causal=False, esize=2, tf32=False):
    """Bounds of the four attention functions at one shape: forward (with
    and without the fp32 row statistic) and backward; esize 2 (bf16, the
    products on the tensor cores) or 4 (fp32: the products as fp32 FMA, or
    with tf32 as 3xTF32 on the tensor cores, three TF32 products each)."""
    D = H * 64
    pairs = B * H * _visible_pairs(Lq, Lk, causal)
    qo, kv, stat = esize * B * Lq * D, esize * B * Lk * D, 4 * B * Lq * H

    def bound(n_bytes, flops):
        if esize == 2:
            return _bound(n_bytes, flops_bf16=flops)
        return _bound(n_bytes, flops_tf32=3 * flops) if tf32 else \
            _bound(n_bytes, flops_fp32=flops)
    return {
        "fwd": bound(2 * qo + 2 * kv, 2 * 2 * 64 * pairs),
        "fwd_stat": bound(2 * qo + 2 * kv + stat, 2 * 2 * 64 * pairs),
        # reads q, do, o, k, v and the statistic, writes dq, dk, dv; five
        # products per score entry
        "bwd": bound(4 * qo + 4 * kv + stat, 5 * 2 * 64 * pairs),
        # reads q, do, k, v, writes dq, dk, dv; the forward's two products
        # and the backward's four per score entry
        "bwd_recompute": bound(3 * qo + 4 * kv, 6 * 2 * 64 * pairs),
    }


def _sdpa_times(q, k, v, do, H, causal):
    """F.scaled_dot_product_attention on the same inputs, forward and
    backward apart (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    B, Lq, D = q.shape

    def heads(x):
        return x.view(B, x.shape[1], H, D // H).transpose(1, 2)

    qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
    doh = heads(do)
    with torch.no_grad():
        fwd = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal))
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qh, kh, vh), doh, retain_graph=True))
    return fwd, bwd


def _sdpa_fwd(q, k, v, H, causal=False):
    """A call of F.scaled_dot_product_attention's forward on the same inputs
    (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    B, Lq, D = q.shape

    def heads(x):
        return x.view(B, x.shape[1], H, D // H).transpose(1, 2)

    qh, kh, vh = heads(q), heads(k), heads(v)

    def call():
        with torch.no_grad():
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  is_causal=causal)
    return call


def _sdpa_bwd(q, k, v, do, H, causal=False):
    """A call of F.scaled_dot_product_attention's backward on the same
    inputs (a yardstick only: the port never calls it)."""
    import torch
    import torch.nn.functional as F
    B, Lq, D = q.shape

    def heads(x):
        return x.view(B, x.shape[1], H, D // H).transpose(1, 2)

    qh, kh, vh = (heads(x).detach().requires_grad_() for x in (q, k, v))
    doh = heads(do)
    out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    return lambda: torch.autograd.grad(out, (qh, kh, vh), doh,
                                       retain_graph=True)


def _sdpa_bwd_op(q, k, v, do, H, causal=False):
    """The backward op that SDPA runs on fp32 inputs (its memory-efficient
    backend), called directly on the saved results of its forward (a
    yardstick only): unlike torch.autograd.grad, a CUDA graph can capture
    it on any stream."""
    import torch
    B, Lq, D = q.shape

    def heads(x):
        return x.view(B, x.shape[1], H, D // H).transpose(1, 2)

    qh, kh, vh, doh = (heads(x) for x in (q, k, v, do))
    try:
        out, lse, seed, off = \
            torch.ops.aten._scaled_dot_product_efficient_attention(
                qh, kh, vh, None, True, 0.0, causal)

        op = torch.ops.aten._scaled_dot_product_efficient_attention_backward

        def call():
            return op(doh, qh, kh, vh, None, out, lse, seed, off, 0.0,
                      [True, True, True, False], causal)
        call()
        torch.cuda.synchronize()
    except RuntimeError as e:   # this torch has no such op: not measured
        log(f"[f32-kernel] SDPA's fp32 backward op: {str(e)[:200]}")
        return None
    return call


def _time_turns(kernel, other, iters=10):
    """Mean CUDA-event ms of two calls timed in turns: kernel, other,
    other, kernel."""
    t = {"kernel": [], "other": []}
    for which in ("kernel", "other", "other", "kernel"):
        t[which].append(cuda_time_ms(kernel if which == "kernel" else other,
                                     iters=iters))
    return sum(t["kernel"]) / 2, sum(t["other"]) / 2


def _ratio_turns(kernel, other, turns=7, iters=10):
    """The kernel-to-other ratio over `turns` rounds of _time_turns: the
    median round's (kernel ms, other ms, ratio) and the ratios' range."""
    rounds = sorted((k / o, k, o) for k, o in
                    (_time_turns(kernel, other, iters) for _ in range(turns)))
    ratio, k, o = rounds[turns // 2]
    return k, o, ratio, rounds[0][0], rounds[-1][0]


GRAPH_LAUNCHES = 20


def _graph_call(fn, launches=GRAPH_LAUNCHES):
    """`fn` captured `launches` times in one CUDA graph: a call replays it
    (device time without the host's cost of each launch)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return graph.replay


def _ratio_graphs(kernel, other, launches=GRAPH_LAUNCHES):
    """_ratio_turns on `launches` calls of each captured in a CUDA graph:
    (kernel ms, other ms per call, median ratio, its range)."""
    k, o, ratio, lo, hi = _ratio_turns(_graph_call(kernel, launches),
                                       _graph_call(other, launches), iters=5)
    return k / launches, o / launches, ratio, lo, hi


def _check_train(name, label, out, ref, bound, state, hold_diff=True):
    import torch
    lim_diff, lim_far, k = TRAIN_LIMITS[name]
    if not hold_diff:
        lim_diff = 1.0
    err = (out.float() - ref.float()).abs()
    ulp = bf16_ulp(ref)
    floor = 2.0 ** -16 * ref.float().abs().max()
    ceiling = 2 * ulp + k * 2.0 ** -8 * bound + floor
    diff_share = (err > 0).float().mean().item()
    far_share = (err > 2 * ulp + floor).float().mean().item()
    ok = (out.shape == ref.shape and bool(torch.isfinite(out.float()).all())
          and diff_share <= lim_diff and far_share <= lim_far
          and bool((err <= ceiling).all()))
    log(f"[train-kernel] {name} {label}: max_abs_err {err.max().item():.3e}; "
        f"outputs != plain {diff_share:.3e} (limit {lim_diff:g}), > 2 bf16 "
        f"ulp {far_share:.3e} (limit {lim_far:g}); max err/ceiling "
        f"{(err / ceiling).max().item():.3f} {'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("train_failures", []).append(f"{name} {label}")
    return err.max().item()


def _time_pair(kernel, plain, iters=10):
    t = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        t[which].append(cuda_time_ms(kernel if which == "kernel" else plain,
                                     iters=iters))
    return sum(t["kernel"]) / 2, sum(t["plain"]) / 2, t


def phase_train_kernels(state):
    """B6a, B6b, B8 and B7 (forward and backward) against their plain
    versions on the card, at the training shapes, ragged ones and the edge
    of the packed path; B6b and B8 also run twice and must give the same
    bits; CUDA-event times of kernel, plain version and
    F.scaled_dot_product_attention at the training shapes, B6b's and B8's
    time against SDPA backward's and B6a's and B1's against SDPA forward's,
    taken in turns (median of 7 rounds)."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.bfloat16)

    def absmax(ts):
        return [t.float().abs().max() for t in ts]

    stats = state.setdefault("kstats", {})
    for i, (B, Lq, Lk, H) in enumerate(TRAIN_PACKED_SHAPES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H}"
        q, k, v, do = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D), \
            rand(B, Lq, D)
        out, den = fa.packed_attention_den_cuda(q, k, v, H)
        ref, den_ref = fa.packed_attention_den_plain(q, k, v, H)
        torch.cuda.synchronize()
        spread = fa.packed_attention_plain(q, k, v.abs(), H).float()
        err_f = _check_train("packed_attention_den", label, out, ref, spread,
                             state)
        den_err = (den - den_ref).abs()
        den_share = (den_err > 0).float().mean().item()
        den_rel = (den_err / den_ref).max().item()
        den_ok = den.shape == den_ref.shape and \
            den_share <= MAX_DEN_DIFF_SHARE and den_rel <= MAX_DEN_REL_ERR
        log(f"[train-kernel] packed_attention_den {label}: den rows != plain "
            f"{den_share:.3e} (limit {MAX_DEN_DIFF_SHARE:g}), max relative "
            f"error {den_rel:.3e} (limit 2^-8) {'ok' if den_ok else 'FAIL'}")
        if not den_ok:
            state.setdefault("train_failures", []).append(f"den {label}")
        # the backward on the plain forward's residuals, so that only the
        # backward kernel is under test
        grads = fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H)
        g_ref = fa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H)
        torch.cuda.synchronize()
        err_b = max(_check_train("packed_attention_bwd", f"{label} {n}", g, r,
                                 m, state)
                    for n, g, r, m in zip(("dq", "dk", "dv"), grads, g_ref,
                                          absmax(g_ref)))
        # the backward that takes q, k, v, do alone: against its plain
        # version, and against the saved-residual kernel's output
        g8 = fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H)
        g8_ref = fa.packed_attention_bwd_recompute_plain(q, k, v, do, H)
        torch.cuda.synchronize()
        err_8 = max(_check_train("packed_attention_bwd_recompute",
                                 f"{label} {n}", g, r, m, state)
                    for n, g, r, m in zip(("dq", "dk", "dv"), g8, g8_ref,
                                          absmax(g8_ref)))
        # one deterministic kernel each: the same inputs, the same bits
        again = (fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H),
                 fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H))
        torch.cuda.synchronize()
        same = [all(torch.equal(a, b) for a, b in zip(first, second))
                for first, second in zip((grads, g8), again)]
        log(f"[train-kernel] {label}: a second run gives the same bits: "
            f"packed_attention_bwd {same[0]}, packed_attention_bwd_recompute "
            f"{same[1]} {'ok' if all(same) else 'FAIL'}")
        if not all(same):
            state.setdefault("train_failures", []).append(
                f"determinism {label}")
        del again
        rel = [((a.float() - b.float()).norm()
                / b.float().norm().clamp_min(1e-30)).item()
               for a, b in zip(g8, grads)]
        share = [(a != b).float().mean().item() for a, b in zip(g8, grads)]
        rel_ok = max(rel) <= RECOMPUTE_VS_SAVED_MAX_REL_L2
        log(f"[train-kernel] packed_attention_bwd_recompute {label}: vs the "
            f"saved-residual kernel's dq, dk, dv: relative L2 "
            f"{[f'{x:.2e}' for x in rel]} (limit "
            f"{RECOMPUTE_VS_SAVED_MAX_REL_L2:g}), outputs that differ "
            f"{[f'{x:.2e}' for x in share]} {'ok' if rel_ok else 'FAIL'}")
        if not rel_ok:
            state.setdefault("train_failures", []).append(
                f"recompute vs saved {label}")
        del spread, grads, g_ref, g8, g8_ref
        if i < 2:
            ms_8, plain_8, t_8 = _time_pair(
                lambda: fa.packed_attention_bwd_recompute_cuda(q, k, v, do,
                                                               H),
                lambda: fa.packed_attention_bwd_recompute_plain(q, k, v, do,
                                                                H), iters=5)
            ms_f, plain_f, t_f = _time_pair(
                lambda: fa.packed_attention_den_cuda(q, k, v, H),
                lambda: fa.packed_attention_den_plain(q, k, v, H))
            ms_b, plain_b, t_b = _time_pair(
                lambda: fa.packed_attention_bwd_cuda(q, k, v, do, ref,
                                                     den_ref, H),
                lambda: fa.packed_attention_bwd_plain(q, k, v, do, ref,
                                                      den_ref, H), iters=5)
            lib_f, lib_b = _sdpa_times(q, k, v, do, H, False)
            sdpa_b = _sdpa_bwd(q, k, v, do, H)
            r6 = _ratio_turns(lambda: fa.packed_attention_bwd_cuda(
                q, k, v, do, ref, den_ref, H), sdpa_b)
            r8 = _ratio_turns(lambda: fa.packed_attention_bwd_recompute_cuda(
                q, k, v, do, H), sdpa_b)
            log(f"[train-kernel] {label}: kernel vs SDPA backward, median of "
                f"7 rounds in turns (kernel, SDPA, SDPA, kernel; 10 calls "
                f"each): " + "; ".join(
                    f"{name} {r[0]:.4f} ms vs {r[1]:.4f} ms, ratio {r[2]:.3f} "
                    f"(rounds {r[3]:.3f}-{r[4]:.3f})"
                    for name, r in (("B6b", r6), ("B8", r8)))
                + f" ({state['smi']})")
            del sdpa_b
            # B6a and B1 (the same kernel without den) against SDPA's
            # forward, in turns
            sdpa_f = _sdpa_fwd(q, k, v, H)
            r6a = _ratio_turns(lambda: fa.packed_attention_den_cuda(q, k, v,
                                                                    H),
                               sdpa_f)
            r1 = _ratio_turns(lambda: fa.packed_attention_cuda(q, k, v, H),
                              sdpa_f)
            log(f"[train-kernel] {label}: kernel vs SDPA forward, median of "
                f"7 rounds in turns (kernel, SDPA, SDPA, kernel; 10 calls "
                f"each): " + "; ".join(
                    f"{name} {r[0]:.4f} ms vs {r[1]:.4f} ms, ratio {r[2]:.3f} "
                    f"(rounds {r[3]:.3f}-{r[4]:.3f})"
                    for name, r in (("B6a", r6a), ("B1", r1)))
                + f" ({state['smi']})")
            bounds = _attention_bounds(B, Lq, Lk, H)
            log(f"[train-kernel] {label}: B6a kernel {t_f['kernel']} ms, "
                f"plain {t_f['plain']} ms, SDPA forward {lib_f:.4f} ms, bound "
                f"{bounds['fwd_stat'][0]:.4f} ms ({bounds['fwd_stat'][1]}); "
                f"B6b kernel {t_b['kernel']} ms, plain {t_b['plain']} ms, "
                f"SDPA backward {lib_b:.4f} ms, bound {bounds['bwd'][0]:.4f} "
                f"ms ({bounds['bwd'][1]}); B8 kernel {t_8['kernel']} ms, "
                f"plain {t_8['plain']} ms, bound "
                f"{bounds['bwd_recompute'][0]:.4f} ms "
                f"({bounds['bwd_recompute'][1]}) (order plain, kernel, "
                f"kernel, plain; {state['smi']})")
            if i == 0:
                for name, err, ms, plain, lib, key in (
                        ("packed_attention_den", err_f, ms_f, plain_f, r6a[1],
                         "fwd_stat"),
                        ("packed_attention_bwd", err_b, ms_b, plain_b, r6[1],
                         "bwd"),
                        ("packed_attention_bwd_recompute", err_8, ms_8,
                         plain_8, r8[1], "bwd_recompute")):
                    stats[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                        "library_ms": lib}
                # B1 shares this shape: its bound and its yardstick
                state["b1_bound"] = bounds["fwd"]
                state["b1_library_ms"] = r1[1]

    for i, (B, Lq, Lk, H, causal) in enumerate(TRAIN_STREAM_SHAPES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H} causal={causal}"
        q, k, v, do = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D), \
            rand(B, Lq, D)
        out, lse = fa.streaming_attention_cuda(q, k, v, H, causal)
        ref, lse_ref = fa.streaming_attention_plain(q, k, v, H, causal)
        torch.cuda.synchronize()
        spread = fa.streaming_attention_plain(q, k, v.abs(), H,
                                              causal)[0].float()
        err_f = _check_train("streaming_attention", label, out, ref, spread,
                             state)
        lse_err = (lse - lse_ref).abs().max().item()
        # fp32 log-sum-exp of O(1..10): sums in another order
        lse_ok = lse.shape == lse_ref.shape and lse_err <= 1e-4
        log(f"[train-kernel] streaming_attention {label}: max |lse - plain| "
            f"{lse_err:.3e} (limit 1e-4) {'ok' if lse_ok else 'FAIL'}")
        if not lse_ok:
            state.setdefault("train_failures", []).append(f"lse {label}")
        grads = fa.streaming_attention_bwd_cuda(q, k, v, do, ref, lse_ref, H,
                                                causal)
        g_ref = fa.streaming_attention_bwd_plain(q, k, v, do, ref, lse_ref,
                                                 H, causal)
        torch.cuda.synchronize()
        err_b = max(_check_train("streaming_attention_bwd", f"{label} {n}", g,
                                 r, m, state)
                    for n, g, r, m in zip(("dq", "dk", "dv"), grads, g_ref,
                                          absmax(g_ref)))
        # one deterministic launch plan: the same inputs, the same bits
        form = fa.streaming_bwd_plan(B, Lq, Lk, H)["form"]
        again = fa.streaming_attention_bwd_cuda(q, k, v, do, ref, lse_ref, H,
                                                causal)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(grads, again))
        log(f"[train-kernel] streaming_attention_bwd {label} ({form}): a "
            f"second run gives the same bits: {same} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            state.setdefault("train_failures", []).append(
                f"determinism streaming {label}")
        del spread, grads, g_ref, again
        if i < 2:
            ms_f, plain_f, t_f = _time_pair(
                lambda: fa.streaming_attention_cuda(q, k, v, H, causal),
                lambda: fa.streaming_attention_plain(q, k, v, H, causal))
            ms_b, plain_b, t_b = _time_pair(
                lambda: fa.streaming_attention_bwd_cuda(q, k, v, do, ref,
                                                        lse_ref, H, causal),
                lambda: fa.streaming_attention_bwd_plain(q, k, v, do, ref,
                                                         lse_ref, H, causal))
            lib_b = _sdpa_times(q, k, v, do, H, causal)[1]
            # B7's forward against SDPA's forward in turns, median of 7
            # rounds; then the same with both sides' launches captured in
            # CUDA graphs: device time, without the wrapper's host cost,
            # which the launch-bound text shape otherwise reads
            for name, ratio in (("", _ratio_turns), (
                    f", {GRAPH_LAUNCHES} launches per CUDA graph replay",
                    _ratio_graphs)):
                r = ratio(
                    lambda: fa.streaming_attention_cuda(q, k, v, H, causal),
                    _sdpa_fwd(q, k, v, H, causal))
                log(f"[train-kernel] {label}: B7 kernel vs SDPA forward{name}"
                    f", median of 7 rounds in turns (kernel, SDPA, SDPA, "
                    f"kernel): {r[0]:.5f} ms vs {r[1]:.5f} ms per call, ratio "
                    f"{r[2]:.3f} (rounds {r[3]:.3f}-{r[4]:.3f}) "
                    f"({state['smi']})")
                if not name:
                    lib_f = r[1]
            bounds = _attention_bounds(B, Lq, Lk, H, causal)
            log(f"[train-kernel] {label}: B7 forward kernel {t_f['kernel']} "
                f"ms, plain {t_f['plain']} ms, SDPA forward {lib_f:.4f} ms, "
                f"bound {bounds['fwd_stat'][0]:.5f} ms "
                f"({bounds['fwd_stat'][1]}); B7 backward kernel "
                f"{t_b['kernel']} ms, plain {t_b['plain']} ms, SDPA backward "
                f"{lib_b:.4f} ms, bound {bounds['bwd'][0]:.5f} ms "
                f"({bounds['bwd'][1]}) ({state['smi']})")
            # the backward's device time: launches captured in a CUDA
            # graph (CUDA events around host-launched calls read the host at
            # the text shape)
            graph_b = cuda_time_ms(_graph_call(
                lambda: fa.streaming_attention_bwd_cuda(
                    q, k, v, do, ref, lse_ref, H, causal)),
                iters=5) / GRAPH_LAUNCHES
            log(f"[train-kernel] {label}: B7 backward ({form}) "
                f"{GRAPH_LAUNCHES} launches in a CUDA graph {graph_b:.5f} ms "
                f"a launch ({state['smi']})")
            if i == 0:
                for name, err, ms, plain, lib, key in (
                        ("streaming_attention", err_f, ms_f, plain_f, lib_f,
                         "fwd_stat"),
                        ("streaming_attention_bwd", err_b, ms_b, plain_b,
                         lib_b, "bwd")):
                    stats[name] = {
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                        "library_ms": lib}
                stats["streaming_attention_bwd"]["graph_ms"] = graph_b
    # the clamp regime of the packed backward. There the softmax is nearly
    # one-hot and dq, dk cancel to ~1e-7 of dv's scale: fp32 noise decides
    # their bits, so only the far share and the ceiling are held
    B, Lq, Lk, H = TRAIN_PACKED_SHAPES[2]
    q, k, v, do = (rand(B, L, H * 64) for L in (Lq, Lk, Lk, Lq))
    q = q * 30
    ref, den_ref = fa.packed_attention_den_plain(q, k, v, H)
    grads = fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H)
    g_ref = fa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H)
    torch.cuda.synchronize()
    for n, g, r, m in zip(("dq", "dk", "dv"), grads, g_ref, absmax(g_ref)):
        _check_train("packed_attention_bwd", f"clamp regime (q x 30) {n}", g,
                     r, m, state, hold_diff=False)
    g8 = fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H)
    g8_ref = fa.packed_attention_bwd_recompute_plain(q, k, v, do, H)
    torch.cuda.synchronize()
    for n, g, r, m in zip(("dq", "dk", "dv"), g8, g8_ref, absmax(g8_ref)):
        _check_train("packed_attention_bwd_recompute",
                     f"clamp regime (q x 30) {n}", g, r, m, state,
                     hold_diff=False)
    if state.get("train_failures"):
        raise AssertionError(f"training kernels disagree with their plain "
                             f"versions: {state['train_failures']}")


# ---------------------------------------------------------------------------
# the float32 forms of the attention kernels (csrc/attention_f32.cu): B1 /
# B6a, B6b, B8 and B7's forward and backward, which an fp32 run (no
# --use_bf16) takes on the card
# ---------------------------------------------------------------------------

# (B, Lq, Lk, heads): the two training shapes of the packed kernels (16
# clips x 8 frames, 4 clips x 70 frames), ragged ones and the packed path's
# edge (640 keys)
F32_PACKED_SHAPES = ((128, 197, 214, 12), (280, 197, 276, 12), (3, 13, 21, 2),
                     (2, 65, 64, 3), (2, 640, 640, 4))
# (B, Lq, Lk, heads, causal): the text tower (15 prompts x 77 tokens, 8
# heads, causal), a long causal L, keys past 640, ragged cross shapes
F32_STREAM_SHAPES = ((15, 77, 77, 8, True), (4, 1024, 1024, 8, True),
                     (2, 130, 700, 2, False), (2, 100, 60, 2, True),
                     (3, 13, 21, 2, False))
# Limit of each fp32 kernel against its plain version on the same inputs:
# err <= F32_REL * scale, where scale is sum p |v| for a forward (exact: the
# plain version on |v|) and the largest |gradient| of the tensor for a
# backward. Both sides compute the same formula in fp32 and differ only in
# the order of their sums (64-term score dots, sums over up to 1,024 keys:
# a few 2^-24 of the terms' magnitude each, which an exp2 argument of O(10)
# carries into a weight as ~1e-6 relative) and in exp2 (ex2.approx: 2 ulp).
# A product taken in TF32 instead rounds each operand to 10 mantissa bits
# (2^-11 relative), ~1e-3 of the scale: the fp32 mutant of
# utils/kernel_mutants.py that does exactly that must fail this limit.
# Measured on an H100 (NVIDIA H100 80GB HBM3, 700.00 W), worst over the
# shapes above: 4.5e-7 (den 2.3e-7 relative, lse 9.5e-7); the TF32 mutant
# 1.2e-3 to 2.7e-3.
F32_REL = 2.0 ** -14
# den: sums of at most 640 fp32 weights, each ~1e-6 relative (above)
F32_DEN_REL = 2.0 ** -16
# lse: log of such a sum, O(1..10): absolute
F32_LSE_ABS = 3e-5


def _check_f32(name, label, out, ref, scale, state):
    """Hold an fp32 kernel's output against its plain version's:
    max(|out - ref| / scale) <= F32_REL. Returns the largest |out - ref|."""
    import torch
    err = (out - ref).abs()
    ratio = (err / scale).max().item()
    ok = (out.shape == ref.shape and out.dtype == torch.float32
          and bool(torch.isfinite(out).all()) and ratio <= F32_REL)
    log(f"[f32-kernel] {name} {label}: max_abs_err {err.max().item():.3e}, "
        f"max err / scale {ratio:.3e} (limit 2^-14 = {F32_REL:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("f32_failures", []).append(f"{name} {label}")
    return err.max().item()


def _f32_timings(state, label, rows, record=True):
    """Time each (name, kernel, plain, library, library's graph call,
    (fp32-FMA bound, 3xTF32 bound or None), err) in `rows`: kernel and
    plain version in turns; kernel and the library call (SDPA in fp32) in
    turns and in CUDA graphs of GRAPH_LAUNCHES calls each (median of 7
    rounds, device time where a call is launch-bound); with `record`, the
    kernels-line stats, whose bound is the 3xTF32 one where the kernel
    takes its products so."""
    stats = state.setdefault("kstats", {})
    for name, kernel, plain, library, library_graph, bounds, err in rows:
        fma, tf32 = bounds
        ms, plain_ms, t = _time_pair(kernel, plain, iters=5)
        r = _ratio_turns(kernel, library, iters=5)
        if library_graph is not None:
            g = _ratio_graphs(kernel, library_graph)
            graphs = (f"in CUDA graphs of {GRAPH_LAUNCHES} calls, median of "
                      f"7 rounds: {g[0]:.5f} ms vs {g[1]:.5f} ms a call, "
                      f"ratio {g[2]:.3f} (rounds {g[3]:.3f}-{g[4]:.3f})")
        else:
            g = (cuda_time_ms(_graph_call(kernel), iters=5) / GRAPH_LAUNCHES,
                 None)
            graphs = (f"in CUDA graphs of {GRAPH_LAUNCHES} calls: {g[0]:.5f} "
                      f"ms a call, SDPA not measured")
        bound = tf32 or fma
        log(f"[f32-kernel] {label}: {name} kernel {t['kernel']} ms, plain "
            f"{t['plain']} ms (order plain, kernel, kernel, plain); vs SDPA "
            f"in fp32, median of 7 rounds in turns: {r[0]:.4f} ms vs "
            f"{r[1]:.4f} ms, ratio {r[2]:.3f} (rounds {r[3]:.3f}-{r[4]:.3f}); "
            f"{graphs}; bound as fp32 FMA {fma[0]:.4f} ms ({fma[1]})"
            + (f", as 3xTF32 {tf32[0]:.4f} ms ({tf32[1]})" if tf32 else "")
            + f" ({state['smi']})")
        if record:
            stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                           "bound_ms": bound[0], "bound_by": bound[1],
                           "library_ms": r[1], "graph_ms": g[0],
                           "library_graph_ms": g[1]}


def _graph_floor_ms(state):
    """The floor of a node of a CUDA graph on this card: a stock one-element
    add in a graph of GRAPH_LAUNCHES, replayed (ms a node; measured once a
    run). A launch-bound kernel in a graph takes at least this."""
    import torch
    if "graph_floor_ms" not in state:
        x = torch.zeros(1, device="cuda")
        state["graph_floor_ms"] = cuda_time_ms(
            _graph_call(lambda: x.add_(1.0)), iters=5) / GRAPH_LAUNCHES
    return state["graph_floor_ms"]


def _host_ms(fn, iters=100):
    """Host ms of a call: `iters` calls enqueued back to back on the host
    clock (no synchronise between them), after a warm-up."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return t


def _b7_host_and_floor(state, label, q, k, v, H, causal):
    """At the text tower's shape: the host time of a call of B7's fp32
    forward through its wrapper, and the floor of a CUDA graph node beside
    the kernels-line graph times of B7's fp32 forward and backward and
    their bytes bounds."""
    from gava_clip_tpu_torch.ops import flash_attention as fa
    host = _host_ms(lambda: fa.streaming_attention_cuda(q, k, v, H, causal))
    log(f"[f32-kernel] streaming_attention_f32 {label}: host ms a call of "
        f"the wrapper (100 enqueued back to back, host clock) {host:.5f} "
        f"({state['smi']})")
    floor = _graph_floor_ms(state)
    stats = state["kstats"]
    for name in ("streaming_attention_f32", "streaming_attention_bwd_f32"):
        s = stats[name]
        log(f"[f32-kernel] {name} {label}: {s['graph_ms']:.5f} ms in CUDA "
            f"graphs beside the floor of a graph node {floor:.5f} ms (a "
            f"one-element add) and its bound {s['bound_ms']:.5f} ms "
            f"({s['bound_by']}) ({state['smi']})")


def phase_f32_kernels(state):
    """B1 / B6a, B6b, B8 and B7 (forward and backward) in float32 against
    their plain versions on the card at the training shapes, ragged ones and
    the packed path's edge (F32_REL); the backwards run twice and must give
    the same bits; B8 equals B6b on the forward kernel's own o and den bit
    for bit; CUDA-event times of kernel, plain version and SDPA in fp32 at
    the 16 x 8 shape and the text tower's (B7's forward also at (4, 1024,
    1024, 8)), the kernel against SDPA in turns and in CUDA graphs, beside
    the fp32-FMA and 3xTF32 bounds; B7's forward wrapper's host time, and
    the floor of a CUDA graph node beside the text tower's rows. With
    state['checks_only'] (the mutants' runs) nothing is timed, and with
    state['only'] naming a packed or a streaming entry only those shapes
    are checked."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(3)
    timed = not state.get("checks_only")
    only = state.get("only") or ""

    def rand(*shape):
        return torch.randn(*shape, generator=gen, device="cuda",
                           dtype=torch.float32)

    def same_bits(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def hold_grads(name, label, grads, refs):
        return max(_check_f32(name, f"{label} {n}", g, r, r.abs().max(),
                              state)
                   for n, g, r in zip(("dq", "dk", "dv"), grads, refs))

    for i, (B, Lq, Lk, H) in enumerate(
            () if only.startswith("streaming") else F32_PACKED_SHAPES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H}"
        q, k, v, do = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D), \
            rand(B, Lq, D)
        out, den = fa.packed_attention_den_cuda(q, k, v, H)
        out1 = fa.packed_attention_cuda(q, k, v, H)
        ref, den_ref = fa.packed_attention_den_plain(q, k, v, H)
        spread = fa.packed_attention_plain(q, k, v.abs(), H)
        torch.cuda.synchronize()
        err_f = _check_f32("packed_attention_den_f32", label, out, ref, spread,
                           state)
        err_1 = _check_f32("packed_attention_f32", label, out1, ref, spread,
                           state)
        den_rel = ((den - den_ref).abs() / den_ref).max().item()
        den_ok = den.shape == den_ref.shape and den_rel <= F32_DEN_REL and \
            torch.equal(out1, out)
        log(f"[f32-kernel] packed_attention_den_f32 {label}: den max relative "
            f"error {den_rel:.3e} (limit 2^-16); B1's output equals B6a's "
            f"bit for bit: {torch.equal(out1, out)} "
            f"{'ok' if den_ok else 'FAIL'}")
        if not den_ok:
            state.setdefault("f32_failures", []).append(f"den {label}")
        grads = fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H)
        g_ref = fa.packed_attention_bwd_plain(q, k, v, do, ref, den_ref, H)
        torch.cuda.synchronize()
        err_b = hold_grads("packed_attention_bwd_f32", label, grads, g_ref)
        g8 = fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H)
        g8_ref = fa.packed_attention_bwd_recompute_plain(q, k, v, do, H)
        # B8 is the forward kernel, then B6b's kernels on its o and den
        g6_own = fa.packed_attention_bwd_cuda(q, k, v, do, out, den, H)
        torch.cuda.synchronize()
        err_8 = hold_grads("packed_attention_bwd_recompute_f32", label, g8,
                           g8_ref)
        again = (fa.packed_attention_bwd_cuda(q, k, v, do, ref, den_ref, H),
                 fa.packed_attention_bwd_recompute_cuda(q, k, v, do, H))
        torch.cuda.synchronize()
        same = [same_bits(grads, again[0]), same_bits(g8, again[1]),
                same_bits(g8, g6_own)]
        log(f"[f32-kernel] packed_attention_bwd_recompute_f32 {label}: a "
            f"second run gives the same bits: B6b {same[0]}, B8 {same[1]}; "
            f"B8 equals B6b on the forward kernel's o and den bit for bit: "
            f"{same[2]} {'ok' if all(same) else 'FAIL'}")
        if not all(same):
            state.setdefault("f32_failures", []).append(f"bits {label}")
        del spread, g_ref, g8_ref, again, g6_own
        if i == 0 and timed:
            fma = _attention_bounds(B, Lq, Lk, H, esize=4)
            tf32 = _attention_bounds(B, Lq, Lk, H, esize=4, tf32=True)
            sdpa_f, sdpa_b = _sdpa_fwd(q, k, v, H), _sdpa_bwd(q, k, v, do, H)
            sdpa_b_op = _sdpa_bwd_op(q, k, v, do, H)
            _f32_timings(state, label, (
                ("packed_attention_den_f32",
                 lambda: fa.packed_attention_den_cuda(q, k, v, H),
                 lambda: fa.packed_attention_den_plain(q, k, v, H), sdpa_f,
                 sdpa_f, (fma["fwd_stat"], tf32["fwd_stat"]), err_f),
                ("packed_attention_f32",
                 lambda: fa.packed_attention_cuda(q, k, v, H),
                 lambda: fa.packed_attention_plain(q, k, v, H), sdpa_f,
                 sdpa_f, (fma["fwd"], tf32["fwd"]), err_1),
                ("packed_attention_bwd_f32",
                 lambda: fa.packed_attention_bwd_cuda(q, k, v, do, ref,
                                                      den_ref, H),
                 lambda: fa.packed_attention_bwd_plain(q, k, v, do, ref,
                                                       den_ref, H), sdpa_b,
                 sdpa_b_op, (fma["bwd"], tf32["bwd"]), err_b),
                ("packed_attention_bwd_recompute_f32",
                 lambda: fa.packed_attention_bwd_recompute_cuda(q, k, v, do,
                                                                H),
                 lambda: fa.packed_attention_bwd_recompute_plain(q, k, v, do,
                                                                 H), sdpa_b,
                 sdpa_b_op, (fma["bwd_recompute"], tf32["bwd_recompute"]),
                 err_8)))
            del sdpa_f, sdpa_b, sdpa_b_op
        del q, k, v, do, out, out1, den, ref, den_ref, grads, g8

    for i, (B, Lq, Lk, H, causal) in enumerate(
            () if only.startswith("packed") else F32_STREAM_SHAPES):
        D = H * 64
        label = f"B={B} Lq={Lq} Lk={Lk} H={H} causal={causal}"
        q, k, v, do = rand(B, Lq, D), rand(B, Lk, D), rand(B, Lk, D), \
            rand(B, Lq, D)
        out, lse = fa.streaming_attention_cuda(q, k, v, H, causal)
        ref, lse_ref = fa.streaming_attention_plain(q, k, v, H, causal)
        spread = fa.streaming_attention_plain(q, k, v.abs(), H, causal)[0]
        torch.cuda.synchronize()
        err_f = _check_f32("streaming_attention_f32", label, out, ref, spread,
                           state)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_ok = lse.shape == lse_ref.shape and lse_err <= F32_LSE_ABS
        log(f"[f32-kernel] streaming_attention_f32 {label}: max |lse - "
            f"plain| {lse_err:.3e} (limit {F32_LSE_ABS:g}) "
            f"{'ok' if lse_ok else 'FAIL'}")
        if not lse_ok:
            state.setdefault("f32_failures", []).append(f"lse {label}")
        fa.reset_launch_counts()
        grads = fa.streaming_attention_bwd_cuda(q, k, v, do, ref, lse_ref, H,
                                                causal)
        forms = {f: n for f, n in fa.stream_bwd_f32_launches.items() if n}
        g_ref = fa.streaming_attention_bwd_plain(q, k, v, do, ref, lse_ref,
                                                 H, causal)
        torch.cuda.synchronize()
        # one launch while both lengths fit one key tile (128), else the dq
        # and dk / dv kernels
        want = {"one_launch": 1} if max(Lq, Lk) <= 128 else \
            {"two_kernels": 2}
        form_ok = forms == want
        log(f"[f32-kernel] streaming_attention_bwd_f32 {label}: form and "
            f"kernel launches {forms} (expect {want}) "
            f"{'ok' if form_ok else 'FAIL'}")
        if not form_ok:
            state.setdefault("f32_failures", []).append(f"form {label}")
        err_b = hold_grads("streaming_attention_bwd_f32", label, grads, g_ref)
        again = fa.streaming_attention_bwd_cuda(q, k, v, do, ref, lse_ref, H,
                                                causal)
        torch.cuda.synchronize()
        same = same_bits(grads, again)
        log(f"[f32-kernel] streaming_attention_bwd_f32 {label}: a second run "
            f"gives the same bits: {same} {'ok' if same else 'FAIL'}")
        if not same:
            state.setdefault("f32_failures", []).append(f"bits {label}")
        if i < 2 and timed:
            # the text tower's shape (the kernels line's) and the long
            # causal one; the forward and the one-launch backward take their
            # products as 3xTF32
            bounds = _attention_bounds(B, Lq, Lk, H, causal, esize=4)
            bounds_tf32 = _attention_bounds(B, Lq, Lk, H, causal, esize=4,
                                            tf32=True)
            sdpa_f = _sdpa_fwd(q, k, v, H, causal)
            rows = [("streaming_attention_f32",
                     lambda: fa.streaming_attention_cuda(q, k, v, H, causal),
                     lambda: fa.streaming_attention_plain(q, k, v, H, causal),
                     sdpa_f, sdpa_f,
                     (bounds["fwd_stat"], bounds_tf32["fwd_stat"]), err_f)]
            if i == 0:
                rows.append((
                    "streaming_attention_bwd_f32",
                    lambda: fa.streaming_attention_bwd_cuda(
                        q, k, v, do, ref, lse_ref, H, causal),
                    lambda: fa.streaming_attention_bwd_plain(
                        q, k, v, do, ref, lse_ref, H, causal),
                    _sdpa_bwd(q, k, v, do, H, causal),
                    _sdpa_bwd_op(q, k, v, do, H, causal),
                    (bounds["bwd"], bounds_tf32["bwd"]
                     if "one_launch" in forms else None), err_b))
            _f32_timings(state, label, rows, record=i == 0)
            if i == 0:
                _b7_host_and_floor(state, label, q, k, v, H, causal)
        del spread, g_ref, again
        del q, k, v, do, out, lse, ref, lse_ref, grads
    # fp32 q/k/v into a kernel with a bf16 form only (B4's int8 QK^T form,
    # B11) raises, naming its ROADMAP item; mixed and half inputs raise in
    # every kernel (B4, B11 and B12 take fp32 too: phase_w8a8_f32,
    # phase_serving_f32)
    q = rand(2, 13, 128)
    refusals = []
    for what, call in (
            ("fp16 B11", lambda: fa.attention_out_int8_cuda(
                q.half(), q.half(), q.half(), 2, {"kernel": {}, "bias": None},
                q.half(), None, True)),
            ("mixed", lambda: fa.packed_attention_cuda(q, q.bfloat16(), q, 2)),
            ("fp16", lambda: fa.streaming_attention_cuda(
                q.half(), q.half(), q.half(), 2, True))):
        try:
            call()
            refusals.append(f"{what}: no error")
        except TypeError as e:
            if "all bfloat16 or all float32" not in str(e):
                refusals.append(f"{what}: {e}")
    log(f"[f32-kernel] fp16 into B11, mixed bf16 / fp32 and fp16 q/k/v "
        f"raise TypeError: {not refusals} {refusals}")
    if refusals:
        state.setdefault("f32_failures", []).append("refusals")
    if state.get("f32_failures"):
        raise AssertionError(f"fp32 attention kernels disagree with their "
                             f"plain versions: {state['f32_failures']}")


def phase_f32_mutants(state):
    """The fp32 mutants of utils/kernel_mutants.py, all at once: each must
    fail its phase (phase_f32_kernels for the attention kernels' f32_*,
    phase_w8a8_f32 for the w8a8 kernels' f32w8_*, phase_serving_f32 for
    B9's, B11's and B12's f32b9_*, f32b11_*, f32b12_*)."""
    from gava_clip_tpu_torch.utils import kernel_mutants
    names = [n for n in kernel_mutants.MUTANTS if n.startswith("f32")]
    if kernel_mutants.main(names, jobs=len(names)):
        raise AssertionError("an fp32 mutant passed the checks")


# ---------------------------------------------------------------------------
# the fp32 forms of the w8a8 kernels (B2, B3 / B3a, B5 / B5a and B4), which
# an fp32 `--int8_frozen` step and an fp32 `--quantize_eval w8a8` run take
# ---------------------------------------------------------------------------

# Limits of each fp32 form against its plain version on the same inputs:
# (share of outputs != plain, share beyond 2 fp32 ulp, ceiling of (err -
# 2 ulp) / flip unit), the flip unit xs * s * 127 as in W8A8_LIMITS.
#   * B2 reads the rows as they are (no LayerNorm): the same codes and the
#     same fp32 epilogue, so the same bits.
#   * B3 / B3a: the LayerNorm's two sums run in another order (a warp
#     butterfly, torch's reduction), and fp32 rows, unlike bf16 ones, make
#     those sums inexact, so a row's normalised values move by an ulp. At
#     the row's absmax that moves xs, and with it every output of the row
#     by about an ulp: the share != plain is reported and not held (1.0).
#     A code flips where a value lies within those ulps of a rounding tie
#     (~127 * 2^-23 of a code: ~1e-5 of the codes, ~1% of the 768-code
#     rows), and its row then moves by up to one flip unit: the share
#     beyond 2 ulp is held at 2e-2, the ceiling at 2 units.
#   * B5 / B5a: the same first-stage flips, and the hidden row they move
#     (its absmax and codes, 3,072 of them a row) flips hidden codes at
#     their ties too: far share 5e-2; a first-stage flip moves the whole
#     hidden row and may flip several of its codes, so the ceiling is 4
#     units with the residual or without it (W8A8_LIMITS' w8a8_mlp; the
#     bf16 B5's 2 held in bf16, whose rounding hides most of these moves,
#     and failed in fp32 at 2.81 units on an H100, NVIDIA H100 80GB HBM3,
#     700.00 W).
#   * B4: the attention's sums in another order (attention_f32.cu against
#     torch, ~1e-7 of the scale, F32_REL) move most fp32 attention values
#     by ulps, so every row's xs and a code a tie: far share 5e-2, ceiling
#     4 units (W8A8_LIMITS' for B4).
#   * B11 (B4's int8-score form) and B12 (B4 or B11 over two sources):
#     their codes and exp2 arguments are the plain version's bit for bit
#     (phase_serving_f32 holds them), and B12 is the one-source form's bits;
#     from the exp2 on they are B4 in fp32, so B4's limits. In bf16 the
#     INT8_QK_LOOSE_* limits were reasoned from a flipped code of q or k;
#     here no score code flips, only the attention row's codes at their
#     ties, as in B4.
# With a residual (B4, B5) the last add rounds at an ulp of the larger of
# its two terms, and where they cancel the output is far smaller than
# either: an ulp's move of xs then shows as many ulp of the output. The
# "2 ulp" of those forms are an ulp of max(|output|, |residual|).
# A product taken in TF32, a row rounded to bf16 or a residual read as
# bf16 moves most outputs by far more than 2 ulp: the f32w8_* mutants of
# utils/kernel_mutants.py must fail these limits.
F32_W8A8_LIMITS = {
    "w8a8_matmul_f32": (0.0, 0.0, 0.0),
    "w8a8_matmul3_cat_f32": (1.0, 2e-2, 2.0),
    "w8a8_matmul3_f32": (1.0, 2e-2, 2.0),
    "w8a8_mlp_res_f32": (1.0, 5e-2, 4.0),
    "w8a8_mlp_f32": (1.0, 5e-2, 4.0),
    "attention_out_int8_f32": (1.0, 5e-2, 4.0),
    "attention_out_int8_qk8_f32": (1.0, 5e-2, 4.0),
    "attention_out_int8_2src_f32": (1.0, 5e-2, 4.0),
}
# (M, K, N): B2 at the vision out-projection of the 16 x 8 step (the first:
# timed), the text tower's three shapes, the patch embed of raw pixels,
# then ragged ones: K % 8 == 4 in registers and in passes (the half chunk
# of an fp32 row), K 13 and 1,101 (rows not 16-byte aligned: a value a
# load)
F32_B2_SHAPES = ((25216, 768, 768), (1155, 512, 512), (1155, 512, 2048),
                 (1155, 2048, 512), (25088, 768, 768, "pixels"),
                 (45, 100, 33), (37, 1100, 77), (37, 13, 77), (19, 1101, 40))
# (M, K, N, LayerNorm?): B3a at the 16 x 8 step's 27,392 kv rows with LN1,
# rows held in passes with a LayerNorm (K 1,100), no LayerNorm
F32_B3A_SHAPES = ((27392, 768, 768, True), (200, 1100, 77, True),
                  (37, 100, 40, False))
# B3a at the 4 x 70 step's 59,920 kv rows (469 tiles of 128 rows, four
# rounds), checked after the others on a generator of its own
F32_B3A_LONG = (59920, 768, 768, True)
# (B, Lx, Le, K, N): B3 at the w8a8 evaluation's frame rows, ragged
F32_B3_SHAPES = ((128, 197, 17, 768, 768), (3, 13, 5, 96, 40))
# (M, K, hidden, N, residual?, LayerNorm?[, "fallback"]): B5 and B5a, the
# last two with B5_FALLBACK_ROWS taking the full first pass
F32_B5_SHAPES = ((25216, 768, 3072, 768, True, True),
                 (25216, 768, 3072, 768, False, True),
                 (37, 768, 3072, 768, True, True),
                 (20, 64, 200, 33, True, True), (20, 64, 200, 33, False, False),
                 (200, 768, 3072, 768, True, True, "fallback"),
                 (200, 768, 3072, 768, False, True, "fallback"))
# (B, lq, Lq rows of q, Lk, H): B4 at the w8a8 evaluation's shape, ragged
F32_B4_SHAPES = ((128, 197, 214, 214, 12), (3, 13, 21, 21, 2),
                 (2, 40, 100, 100, 12))


def f32_ulp(x):
    import torch
    mag = x.abs().float().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - 23)


def _check_w8a8_f32(name, out, ref, unit, residual=None):
    """Hold an fp32 w8a8 form's output against its plain version's within
    F32_W8A8_LIMITS[name]: (ok, max |err|, text). The ulp are those of
    max(|ref|, |residual|) where the form adds a residual."""
    import torch
    lim_diff, lim_far, lim_units = F32_W8A8_LIMITS[name]
    err = (out - ref).abs()
    ulp = f32_ulp(ref if residual is None
                  else torch.maximum(ref.abs(), residual.abs()))
    diff_share = (err > 0).float().mean().item()
    far_share = (err > 2 * ulp).float().mean().item()
    units = ((err - 2 * ulp).clamp_min(0) / unit.clamp_min(1e-30)).max().item()
    ok = (out.dtype == torch.float32 and out.shape == ref.shape
          and bool(torch.isfinite(out).all()) and diff_share <= lim_diff
          and far_share <= lim_far and units <= lim_units)
    return ok, err.max().item(), (
        f"max_abs_err {err.max().item():.3e}; outputs != plain "
        f"{diff_share:.3e} (limit {lim_diff:g}), > 2 fp32 ulp "
        f"{far_share:.3e} (limit {lim_far:g}), max (err - 2 ulp) / flip "
        f"unit {units:.3f} (limit {lim_units:g})")


def _attention_f32_yardsticks(state, name, q, k, v, H, lq, int8_qk):
    """The first launch of B4 or B11 in fp32 alone (its attention of the
    first lq query rows into a scratch, as _attention_out_f32 launches it)
    beside SDPA's fp32 forward on the same rows, keys and values, 20 calls
    of each in a CUDA graph, in turns (median of 7 rounds): a yardstick
    only, SDPA sums in another order. Into the entry's yardsticks."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    B, _, D = q.shape
    a = torch.empty(B, lq, D, device=q.device)
    c = 64 ** -0.5 * fa._LOG2E / (127.0 * 127.0 if int8_qk else 1.0)
    entry = "packed_attention_qk8_f32" if int8_qk else \
        "packed_attention_fma_f32"

    def attention():
        fa._f32_launch(entry, q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), a.data_ptr(), B, lq, k.shape[1], H, 64,
                       *fa._qkv_strides(q, k, v), a.stride(0), a.stride(1),
                       c, count=False)
    k_ms, s_ms, ratio, lo, hi = _ratio_graphs(
        attention, _sdpa_fwd(q[:, :lq], k, v, H))
    log(f"[{'serving' if int8_qk else 'w8a8'}-f32] {name} B={B} lq={lq} "
        f"Lk={k.shape[1]} H={H}: its attention launch alone ({entry}) vs "
        f"SDPA's fp32 forward, CUDA graphs of {GRAPH_LAUNCHES} calls, median "
        f"of 7 rounds in turns: {k_ms:.4f} ms vs {s_ms:.4f} ms, ratio "
        f"{ratio:.3f} (rounds {lo:.3f}-{hi:.3f}) ({state['smi']})")
    state["kstats"][name]["yardsticks"].update(
        {"attention_ms_graphs": k_ms, "sdpa_fp32_fwd_ms_graphs": s_ms})


def phase_w8a8_f32(state):
    """The fp32 forms of B2, B3 / B3a, B5 / B5a and B4 against their plain
    versions on the card (F32_W8A8_LIMITS), one counted launch each, at the
    shapes of the fp32 `--int8_frozen` step and the fp32 w8a8 evaluation
    and at ragged ones; at the first shape of each, CUDA-event times of the
    kernel and its plain version in turns, of the kernel and its bf16 form
    on the same values in bf16 in turns (median of 5 rounds), and of the
    int8 products alone through torch._int_mm; then B5a's path,
    mlp_block(residual=None) on fp32 rows. With state['checks_only'] (the
    mutants' runs) nothing is timed, and with state['only'] (a mutant's
    kernel) only that kernel is checked, its libraries built at once."""
    import torch
    from gava_clip_tpu_torch.ops import _cuda
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    from gava_clip_tpu_torch.ops.activations import quick_gelu
    from gava_clip_tpu_torch.ops.linear import mlp_block
    gen = torch.Generator(device="cuda").manual_seed(12)
    gen_mm = torch.Generator(device="cuda").manual_seed(13)
    timed = not state.get("checks_only")
    only = state.get("only")
    stats = state.setdefault("kstats", {})
    bf = torch.bfloat16
    names = [n for n in F32_W8A8_LIMITS if only in (None, n)]
    _cuda.load_libraries(sorted(
        {KERNELS[n][0] for n in names} |
        ({"w8a8_matmul"} if "attention_out_int8_f32" in names else set())))

    def randn(*shape, gain=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * gain

    def cat(out):
        return torch.cat(out, dim=-1) if isinstance(out, tuple) else out

    def run(name, label, kernel, plain, unit, timing=None, residual=None):
        """`kernel` against `plain` (one launch of `name`); `timing` (the
        first shape): (bound, the bf16 form's call on inputs cast
        beforehand, [(M, K, W^T)] of the int8 products[, (M, K, N) of B3's
        launch plan: the kernel and its bf16 form also in CUDA graphs, in
        turns, and the plan logged])."""
        if name not in names:
            return
        _reset_launch_counts()
        out = cat(kernel())
        torch.cuda.synchronize()
        n = _launch_counts()[name]
        ok, err, text = _check_w8a8_f32(name, out, cat(plain()), unit,
                                        residual)
        ok = ok and n == 1
        log(f"[w8a8-f32] {name} {label}: one launch ({n}); {text} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8a8_f32_failures", []).append(
                f"{name} {label}")
        if timing is None or not timed:
            return
        bound, bf16_call, products, *qkv = timing
        ms, plain_ms, t = _time_pair(kernel, plain, iters=5)
        k, b, ratio, lo, hi = _ratio_turns(kernel, bf16_call, turns=5)
        mm = sum(_int_mm_ms(gen_mm, *p) for p in products)
        log(f"[w8a8-f32] {name} {label}: kernel {t['kernel']} ms, plain "
            f"{t['plain']} ms (order plain, kernel, kernel, plain); vs its "
            f"bf16 form on the same values in bf16, median of 5 rounds in "
            f"turns: {k:.4f} ms vs {b:.4f} ms, ratio {ratio:.3f} (rounds "
            f"{lo:.3f}-{hi:.3f}); the int8 products alone through "
            f"torch._int_mm {mm:.4f} ms; bound {bound[0]:.4f} ms "
            f"({bound[1]}) ({state['smi']})")
        stats[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound[0], "bound_by": bound[1],
                       "library_ms": None,
                       "yardsticks": {"bf16_ms": b, "kernel_ms_in_turns": k,
                                      "int_mm_ms": mm}}
        if qkv:
            plan = im.w8a8_qkv_plan(
                *qkv[0], torch.cuda.get_device_properties(0)
                .multi_processor_count,
                im.smem_limit(_cuda.load_library("w8a8_qkv"),
                              "w8a8_qkv_layout", im._QKV_LAYOUT,
                              torch.device("cuda")), esize=4)
            gk, gb, ratio, lo, hi = _ratio_graphs(kernel, bf16_call)
            log(f"[w8a8-f32] {name} {label}: CUDA graphs of "
                f"{GRAPH_LAUNCHES}, median of 7 rounds in turns: fp32 "
                f"{gk:.5f} ms vs its bf16 form {gb:.5f} ms a launch, ratio "
                f"{ratio:.3f} (rounds {lo:.3f}-{hi:.3f}); launch plan "
                f"{plan} ({state['smi']})")
            stats[name]["yardsticks"].update(
                {"graph_ms": gk, "bf16_graph_ms": gb})

    for i, (M, K, N, *kind) in enumerate(F32_B2_SHAPES):
        x = torch.randint(0, 256, (M, K), generator=gen, device="cuda").float() \
            if kind else randn(M, K)
        kern = _qleaf(gen, K, N)
        b = randn(N, gain=0.1)
        xb = x.to(bf)
        run("w8a8_matmul_f32", f"M={M} K={K} N={N}",
            lambda: im.w8a8_matmul_cuda(x, kern, b),
            lambda: im.w8a8_matmul_plain(x, kern, b),
            _flip_unit(im.quant_rows(x)[1], kern["scale"]),
            (_bound(4 * M * K + K * N + 8 * N + 4 * M * N,
                    ops_int8=2 * M * K * N),
             lambda: im.w8a8_matmul_cuda(xb, kern, b),
             [(M, K, kern["qa_t"])]) if i == 0 else None)

    # the long step's shape draws from a generator of its own: the checks
    # after it keep their inputs
    gen_long = torch.Generator(device="cuda").manual_seed(26)
    for i, (M, K, N, with_ln) in enumerate(F32_B3A_SHAPES + (F32_B3A_LONG,)):
        g = gen if i < len(F32_B3A_SHAPES) else gen_long
        x = torch.randn(M, K, generator=g, device="cuda")
        ln = _ln_params(g, K) if with_ln else None
        k3 = [_qleaf(g, K, N) for _ in range(3)]
        b3 = [torch.randn(N, generator=g, device="cuda") * 0.02
              for _ in range(3)]
        xs = im.quant_rows(x if ln is None else im.ln_f32(x, *ln))[1]
        xb = x.to(bf)
        run("w8a8_matmul3_f32", f"M={M} K={K} N=3x{N} LN {with_ln}",
            lambda: im.w8a8_matmul3_cuda(x, k3, b3, ln),
            lambda: im.w8a8_matmul3_plain(x, k3, b3, ln),
            torch.cat([_flip_unit(xs, k["scale"]) for k in k3], dim=-1),
            (_bound(M * (4 * K + 12 * N) + 3 * K * N + 24 * N + 8 * K,
                    ops_int8=6 * M * K * N),
             lambda: im.w8a8_matmul3_cuda(xb, k3, b3, ln),
             [(M, K, torch.cat([k["qa_t"] for k in k3]))], (M, K, N))
            if i == 0 else None)

    for i, (B, Lx, Le, K, N) in enumerate(F32_B3_SHAPES):
        x, e = randn(B, Lx, K), randn(B, Le, K)
        ln = _ln_params(gen, K)
        k3 = [_qleaf(gen, K, N) for _ in range(3)]
        b3 = [randn(N, gain=0.02) for _ in range(3)]
        xs = im.quant_rows(im.ln_f32(im._kv_rows(x, e), *ln))[1]
        M = B * (Lx + Le)
        xb, eb = x.to(bf), e.to(bf)
        run("w8a8_matmul3_cat_f32", f"B={B} Lx={Lx} Le={Le} K={K} N={N}",
            lambda: im.w8a8_matmul3_cat_cuda(x, e, k3, b3, ln),
            lambda: im.w8a8_matmul3_cat_plain(x, e, k3, b3, ln),
            torch.cat([_flip_unit(xs, k["scale"]) for k in k3], dim=-1),
            (_bound(M * (4 * K + 12 * N) + 3 * K * N + 24 * N + 8 * K,
                    ops_int8=6 * M * K * N),
             lambda: im.w8a8_matmul3_cat_cuda(xb, eb, k3, b3, ln),
             [(M, K, torch.cat([k["qa_t"] for k in k3]))], (M, K, N))
            if i == 0 else None)

    first = set()
    # the fallback shapes on a generator of their own: the checks after
    # them keep their inputs
    gen_fallback = torch.Generator(device="cuda").manual_seed(23)
    for M, K, Hd, N, res, with_ln, *fallback in F32_B5_SHAPES:
        name = "w8a8_mlp_res_f32" if res else "w8a8_mlp_f32"
        g = gen_fallback if fallback else gen

        def draw(*shape, gain=1.0, g=g):
            return torch.randn(*shape, generator=g, device="cuda") * gain
        x = draw(M, K)
        r = draw(M, N) if res else None
        ln = _ln_params(g, K) if with_ln else None
        fc1 = {"kernel": _qleaf(g, K, Hd), "bias": draw(Hd, gain=0.02)}
        fc2 = {"kernel": _qleaf(g, Hd, N), "bias": draw(N, gain=0.02)}
        if fallback:
            _b5_fallback_rows(x, fc1, ln)
        k1 = fc1["kernel"]
        codes, xs = im.quant_rows(x if ln is None else im.ln_f32(x, *ln))
        h = im.quick_gelu_f32(im.rescale(im.int_matmul(codes, k1["qa"]), xs,
                                         k1["scale"], fc1["bias"]))
        unit = _flip_unit(im.quant_rows(h)[1], fc2["kernel"]["scale"])
        del codes, h
        xb = x.to(bf)
        if res:
            rb = r.to(bf)
            calls = (lambda: im.w8a8_mlp_res_cuda(x, fc1, fc2, ln, r),
                     lambda: im.w8a8_mlp_res_plain(x, fc1, fc2, ln, r),
                     lambda: im.w8a8_mlp_res_cuda(xb, fc1, fc2, ln, rb))
        else:
            calls = (lambda: im.w8a8_mlp_cuda(x, fc1, fc2, ln),
                     lambda: im.w8a8_mlp_plain(x, fc1, fc2, ln),
                     lambda: im.w8a8_mlp_cuda(xb, fc1, fc2, ln))
        run(name, f"M={M} K={K} H={Hd} N={N} LN {with_ln}"
            + (f" rows {B5_FALLBACK_ROWS} take the full first pass"
               if fallback else ""), calls[0],
            calls[1], unit,
            (_bound(4 * M * K + (8 if res else 4) * M * N + K * Hd + Hd * N
                    + 8 * (Hd + N + K), ops_int8=2 * M * Hd * (K + N)),
             calls[2], [(M, K, k1["qa_t"]), (M, Hd, fc2["kernel"]["qa_t"])])
            if name not in first else None, residual=r)
        first.add(name)

    for i, (B, lq, Lq, Lk, H) in enumerate(F32_B4_SHAPES):
        D = H * 64
        q, k, v = randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D)
        op = {"kernel": _qleaf(gen, D, D), "bias": randn(D, gain=0.02)}
        r = randn(B, lq, D)
        xs = im.quant_rows(fa._onepass_attention_f32(q[:, :lq], k, v, H))[1]
        qb, kb, vb, rb = q.to(bf), k.to(bf), v.to(bf), r.to(bf)
        run("attention_out_int8_f32", f"B={B} lq={lq} Lq={Lq} Lk={Lk} H={H}",
            lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, lq),
            lambda: fa.attention_out_int8_plain(q, k, v, H, op, r, lq),
            _flip_unit(xs, op["kernel"]["scale"]),
            # the lq query rows, the residual and the output, k and v, the
            # weight; the attention's products as fp32 FMA
            (_bound(12 * B * lq * D + 8 * B * Lk * D + D * D + 8 * D,
                    ops_int8=2 * B * lq * D * D,
                    flops_fp32=4 * B * lq * Lk * D),
             lambda: fa.attention_out_int8_cuda(qb, kb, vb, H, op, rb, lq),
             [(B * lq, D, op["kernel"]["qa_t"])]) if i == 0 else None,
            residual=r)
        if i == 0 and timed and "attention_out_int8_f32" in names:
            _attention_f32_yardsticks(state, "attention_out_int8_f32", q, k,
                                      v, H, lq, False)
    if not only:
        _long_key_checks(state, torch.float32)

    if only:
        if state.get("w8a8_f32_failures"):
            raise AssertionError(f"fp32 w8a8 kernels disagree with their "
                                 f"plain versions: "
                                 f"{state['w8a8_f32_failures']}")
        return
    # B5a's path: an MLP block called without a residual on w8a8 leaves with
    # fp32 rows, through ops.linear.mlp_block
    K, Hd = 768, 3072
    params = {"fc1": {"kernel": _qleaf(gen, K, Hd), "bias": randn(Hd)},
              "fc2": {"kernel": _qleaf(gen, Hd, K), "bias": randn(K)}}
    g, beta = _ln_params(gen, K)
    norm = {"scale": g, "bias": beta}
    xb = randn(128, 197, K)
    _reset_launch_counts()
    with torch.inference_mode():
        y = mlp_block(params, norm, xb, quick_gelu)
        y_plain = mlp_block(params, norm, xb, quick_gelu, int8_impl="plain")
    torch.cuda.synchronize()
    n = _launch_counts()
    state.setdefault("launches_by_kernel", {})["w8a8_mlp_f32"] = \
        n["w8a8_mlp_f32"]
    ok = (y.dtype == torch.float32 and y.shape == xb.shape
          and n["w8a8_mlp_f32"] == 1 and n["w8a8_mlp"] == 0
          and bool(torch.isfinite(y).all()))
    log(f"[w8a8-f32] mlp_block(residual=None) on w8a8 leaves, fp32 rows "
        f"(128, 197, 768): launches {n['w8a8_mlp_f32']} w8a8_mlp_f32 / "
        f"{n['w8a8_mlp']} w8a8_mlp (expect 1 / 0), outputs != plain "
        f"{(y != y_plain).float().mean().item():.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("w8a8_f32_failures", []).append("mlp_block")
    # fp16 and mixed rows raise TypeError (B11 and B12 take fp32:
    # phase_serving_f32), no launch counted
    x16 = randn(8, 64).half()
    q = randn(2, 13, 128)
    leaf = _qleaf(gen, 128, 128)
    op = {"kernel": leaf, "bias": randn(128)}
    refusals = []
    _reset_launch_counts()
    for what, call in (
            ("fp16 B2", lambda: im.w8a8_matmul_cuda(x16, _qleaf(gen, 64, 8))),
            ("mixed B5", lambda: im.w8a8_mlp_res_cuda(
                q[0], op, op, _ln_params(gen, 128), q[0].to(bf))),
            ("mixed B4", lambda: fa.attention_out_int8_cuda(
                q, q.to(bf), q, 2, op, q, None)),
            ("fp16 B4", lambda: fa.attention_out_int8_cuda(
                q.half(), q.half(), q.half(), 2, op, q.half(), None))):
        try:
            call()
            refusals.append(f"{what}: no error")
        except TypeError as e:
            if "all bfloat16 or all float32" not in str(e):
                refusals.append(f"{what}: {e}")
    launched = {k: v for k, v in _launch_counts().items() if v}
    if launched:
        refusals.append(f"launches counted: {launched}")
    log(f"[w8a8-f32] fp16 and mixed rows raise, no launch counted: "
        f"{not refusals} {refusals}")
    if refusals:
        state.setdefault("w8a8_f32_failures", []).append("refusals")
    if state.get("w8a8_f32_failures"):
        raise AssertionError(f"fp32 w8a8 kernels disagree with their plain "
                             f"versions: {state['w8a8_f32_failures']}")


# ---------------------------------------------------------------------------
# the fp32 forms of the serving kernels B9, B11 and B12, which an fp32
# `--quantize_eval w8` run and the int8 QK^T switch on an fp32 run take
# ---------------------------------------------------------------------------

# (B, Lq, Lk, heads, tie rows) of the check of B11's codes and exp2
# arguments (int8_qk_args_cuda, bit for bit against _int8_qk_exp2_arg):
# the w8a8 evaluation's kv rows, and rows whose values sit on the codes'
# rounding ties (int8_qk_tie_rows), full width and ragged
F32_B11_ARGS_SHAPES = ((128, 214, 214, 12, False), (2, 197, 214, 12, True),
                       (3, 13, 21, 2, True))


def _serving_f32_b9(state, gen, timed, only):
    """B9 in fp32 at the w8 evaluation's four projection shapes and the
    ragged ones within W8_F32_REL, one counted launch each; at the four
    serving shapes kernel and plain version in turns, the kernel beside
    torch.matmul on the dequantized fp32 weight (TF32 off) and beside its
    bf16 form on the same values, medians of 5 rounds in turns."""
    import torch
    from gava_clip_tpu_torch.ops import int8_matmul as im
    name = "int8_matmul_f32"
    if only not in (None, name):
        return
    for M, K, N, what in W8_MATMUL_SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda")
        leaf = _w8_leaf(gen, K, N)
        _reset_launch_counts()
        out = im.int8_matmul_cuda(x, leaf)
        n = _launch_counts()
        ref = im.int8_matmul_plain(x, leaf["q"], leaf["scale"])
        w = im.dequant_weight(leaf["q"], leaf["scale"], torch.float32)
        err = (out - ref).abs()
        rel = (err / (x.abs() @ w.abs()).clamp_min(1e-30)).max().item()
        ok = (out.dtype == torch.float32 and out.shape == ref.shape
              and bool(torch.isfinite(out).all()) and rel <= W8_F32_REL
              and n[name] == 1 and n["int8_matmul"] == 0)
        log(f"[serving-f32] {name} M={M} K={K} N={N} ({what}): launches "
            f"{n[name]} fp32 / {n['int8_matmul']} bf16 (expect 1 / 0); "
            f"max_abs_err {err.max().item():.3e}, max |err| / (|x| @ |w|) "
            f"{rel / W8_F32_REL:.4f} x 2^-19 (limit 1) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("serving_f32_failures", []).append(
                f"{name} {what} M={M}")
        max_err = err.max().item()
        del err
        if what == "ragged" or not timed:
            continue
        kernel = lambda: im.int8_matmul_cuda(x, leaf)      # noqa: E731
        ms, plain_ms, t = _time_pair(
            kernel, lambda: im.int8_matmul_plain(x, leaf["q"], leaf["scale"]),
            iters=5)
        lib_k, lib_ms, lib_r, lib_lo, lib_hi = _ratio_turns(
            kernel, lambda: torch.matmul(x, w), turns=5, iters=5)
        xb = x.to(torch.bfloat16)
        b_k, b_ms, b_r, b_lo, b_hi = _ratio_turns(
            kernel, lambda: im.int8_matmul_cuda(xb, leaf), turns=5, iters=5)
        # the kernel takes its products as 3xTF32 (three TF32 products
        # each); the fp32-FMA bound beside it
        n_bytes = 4 * M * K + K * N + 4 * N + 4 * M * N
        bound = _bound(n_bytes, flops_tf32=3 * 2 * M * K * N)
        fma = _bound(n_bytes, flops_fp32=2 * M * K * N)
        log(f"[serving-f32] {name} {what}: kernel {t['kernel']} ms "
            f"({2e-9 * M * K * N / ms:.1f} TFLOP/s), plain {t['plain']} ms "
            f"(order plain, kernel, kernel, plain); bound as 3xTF32 "
            f"{bound[0]:.4f} ms ({bound[1]}), as fp32 FMA {fma[0]:.4f} ms "
            f"({fma[1]}); torch.matmul {lib_ms:.4f} ms, its bf16 form "
            f"{b_ms:.4f} ms; vs torch.matmul on the dequantized fp32 weight, "
            f"median of 5 rounds in turns: {lib_k:.4f} ms vs {lib_ms:.4f} "
            f"ms, ratio {lib_r:.3f} (rounds {lib_lo:.3f}-{lib_hi:.3f}); vs "
            f"its bf16 form on the same values in bf16: {b_k:.4f} ms vs "
            f"{b_ms:.4f} ms, ratio {b_r:.3f} (rounds {b_lo:.3f}-{b_hi:.3f})"
            f" ({state['smi']})")
        if what == "fc1":
            _record(state, name, max_err, ms, plain_ms, bound, lib_ms)
            state["kstats"][name]["yardsticks"] = {
                "bf16_ms": b_ms, "kernel_ms_in_turns": b_k}


def _serving_f32_b11(state, gen, timed, only):
    """B11 in fp32: its codes and exp2 arguments bit for bit against the
    plain version's (random rows and rows on the codes' ties), the whole
    op against its plain version at F32_B4_SHAPES within
    F32_W8A8_LIMITS, the loose check against the fp32-score form, timed
    at the serving shape beside its bf16 form."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    name = "attention_out_int8_qk8_f32"
    if only not in (None, name):
        return
    rs = np.random.RandomState(19)
    for B, Lq, Lk, H, ties in F32_B11_ARGS_SHAPES:
        D = H * 64
        if ties:
            q, k = (torch.from_numpy(int8_qk_tie_rows(rs, B * L * H).reshape(
                B, L, D)).cuda() for L in (Lq, Lk))
        else:
            q, k = (torch.randn(B, L, D, generator=gen, device="cuda")
                    for L in (Lq, Lk))
        _reset_launch_counts()
        args = fa.int8_qk_args_cuda(q, k, H)
        want = fa._int8_qk_exp2_arg(fa._heads(q, H), fa._heads(k, H),
                                    64 ** -0.5 * fa._LOG2E)
        torch.cuda.synchronize()
        differ = (args != want).sum().item()
        launched = {k_: v for k_, v in _launch_counts().items() if v}
        ok = differ == 0 and not launched
        rows = "rows on rounding ties" if ties else "random rows"
        log(f"[serving-f32] {name} codes and exp2 arguments B={B} Lq={Lq} "
            f"Lk={Lk} H={H} ({rows}): equal to the plain version's bit for "
            f"bit ({differ} of "
            f"{args.numel()} differ), no launch counted ({launched}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("serving_f32_failures", []).append(
                f"{name} arguments B={B}")
    del q, k, args, want
    for i, (B, lq, Lq, Lk, H) in enumerate(F32_B4_SHAPES):
        D = H * 64
        q, k, v = (torch.randn(B, L, D, generator=gen, device="cuda")
                   for L in (Lq, Lk, Lk))
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        r = torch.randn(B, lq, D, generator=gen, device="cuda")
        xs = im.quant_rows(fa._onepass_attention_den_f32(
            q[:, :lq], k, v, H, int8_qk=True)[0])[1]
        kernel = lambda: fa.attention_out_int8_cuda(       # noqa: E731
            q, k, v, H, op, r, lq, True)
        plain = lambda: fa.attention_out_int8_plain(       # noqa: E731
            q, k, v, H, op, r, lq, True)
        _reset_launch_counts()
        out = kernel()
        torch.cuda.synchronize()
        n = _launch_counts()
        ok, err, text = _check_w8a8_f32(name, out, plain(),
                                        _flip_unit(xs, op["kernel"]["scale"]),
                                        r)
        ok = ok and n[name] == 1 and n["attention_out_int8_f32"] == 0 and \
            n["attention_out_int8_qk8"] == 0
        label = f"B={B} lq={lq} Lq={Lq} Lk={Lk} H={H}"
        log(f"[serving-f32] {name} {label}: launches {n[name]} (expect 1); "
            f"{text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("serving_f32_failures", []).append(
                f"{name} {label}")
        if i or not timed:
            continue
        ms, plain_ms, t = _time_pair(kernel, plain, iters=5)
        qb, kb, vb, rb = (a.to(torch.bfloat16) for a in (q, k, v, r))
        b_k, b_ms, b_r, b_lo, b_hi = _ratio_turns(
            kernel, lambda: fa.attention_out_int8_cuda(qb, kb, vb, H, op, rb,
                                                       lq, True),
            turns=5, iters=5)
        f_k, f_ms, f_r, f_lo, f_hi = _ratio_turns(
            kernel, lambda: fa.attention_out_int8_cuda(q, k, v, H, op, r, lq),
            turns=5, iters=5)
        # the lq query rows, the residual and the output, k and v, the
        # weight; the score product in int8, the AV product as fp32 FMA,
        # the out-projection in int8
        bound = _bound(12 * B * lq * D + 8 * B * Lk * D + D * D + 8 * D,
                       ops_int8=2 * B * lq * Lk * D + 2 * B * lq * D * D,
                       flops_fp32=2 * B * lq * Lk * D)
        log(f"[serving-f32] {name} {label}: kernel {t['kernel']} ms, plain "
            f"{t['plain']} ms (order plain, kernel, kernel, plain); bound "
            f"{bound[0]:.4f} ms ({bound[1]}); vs its bf16 form on the same "
            f"values in bf16, median of 5 rounds in turns: {b_k:.4f} ms vs "
            f"{b_ms:.4f} ms, ratio {b_r:.3f} (rounds {b_lo:.3f}-{b_hi:.3f});"
            f" vs the fp32-score form (B4 fp32): {f_k:.4f} ms vs {f_ms:.4f} "
            f"ms, ratio {f_r:.3f} (rounds {f_lo:.3f}-{f_hi:.3f}) "
            f"({state['smi']})")
        _record(state, name, err, ms, plain_ms, bound, None)
        state["kstats"][name]["yardsticks"] = {
            "bf16_ms": b_ms, "fp32_scores_ms": f_ms, "kernel_ms_in_turns": b_k}
        _attention_f32_yardsticks(state, name, q, k, v, H, lq, True)
    # the loose check against the fp32-score form (INT8_QK_LOOSE_*, at the
    # JAX test's statistics)
    B, Lq, Lk, H = 3, 30, 38, 4
    D = H * 64
    q, k = (torch.randn(B, L, D, generator=gen, device="cuda") * 0.3
            for L in (Lq, Lk))
    v, r = (torch.randn(B, L, D, generator=gen, device="cuda") * 0.1
            for L in (Lk, Lq))
    op = {"kernel": _qleaf(gen, D, D),
          "bias": torch.randn(D, generator=gen, device="cuda") * 0.01}
    got = fa.attention_out_int8_cuda(q, k, v, H, op, r, None, True)
    want = fa.attention_out_int8_cuda(q, k, v, H, op, r, None, False)
    diff = (got - want).abs()
    rel_l2 = (diff.norm() / (want - r).norm()).item()
    rel_max = (diff.max() / want.abs().max().clamp_min(1.0)).item()
    ok = rel_l2 <= INT8_QK_LOOSE_L2 and rel_max <= INT8_QK_LOOSE_MAX and \
        diff.max().item() > 0
    log(f"[serving-f32] {name} vs the fp32-score form (B={B} Lq={Lq} "
        f"Lk={Lk} H={H}, q, k x 0.3): relative L2 of the diff against the "
        f"attention's contribution {rel_l2:.3e} (limit {INT8_QK_LOOSE_L2:g}),"
        f" max |diff| / max |output| {rel_max:.3e} (limit "
        f"{INT8_QK_LOOSE_MAX:g}); the switch changes the result: "
        f"{diff.max().item() > 0} {'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("serving_f32_failures", []).append(
            f"{name} loose check")


def _serving_f32_b12(state, gen, timed, only):
    """B12 in fp32, both score forms, at W8A8_2SRC_SHAPES: bit for bit
    equal to the one-source fp32 form (B4 / B11) on the concatenated keys
    and within F32_W8A8_LIMITS of its plain version; timed at the serving
    shape; then its path, the public entry flash_attention_out_int8_2src
    on fp32 rows at the serving shape, one counted launch."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    name = "attention_out_int8_2src_f32"
    if only not in (None, name):
        return
    for i, (B, L1, L2, H) in enumerate(W8A8_2SRC_SHAPES):
        D = H * 64
        q, k1, v1, r = (torch.randn(B, L1, D, generator=gen, device="cuda")
                        for _ in range(4))
        k2, v2 = (torch.randn(B, L2, D, generator=gen, device="cuda")
                  for _ in range(2))
        kc, vc = torch.cat([k1, k2], dim=1), torch.cat([v1, v2], dim=1)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        args = (q, k1, v1, k2, v2, H, op, r)
        label = f"B={B} L1={L1} L2={L2} H={H}"
        for qk8 in (False, True):
            form = "int8 QK^T" if qk8 else "fp32 scores"
            _reset_launch_counts()
            two = fa.attention_out_int8_2src_cuda(*args, qk8)
            torch.cuda.synchronize()
            n = _launch_counts()
            one = fa.attention_out_int8_cuda(q, kc, vc, H, op, r, None, qk8)
            xs = im.quant_rows(fa._onepass_attention_den_f32(
                q, kc, vc, H, int8_qk=qk8)[0])[1]
            ok, err, text = _check_w8a8_f32(
                name, two, fa.attention_out_int8_2src_plain(*args, qk8),
                _flip_unit(xs, op["kernel"]["scale"]), r)
            same = torch.equal(two, one)
            ok = ok and same and n[name] == 1 and \
                n["attention_out_int8_2src"] == 0
            log(f"[serving-f32] {name} {label}, {form}: launches {n[name]} "
                f"(expect 1); equal to the one-source fp32 form on [k1; k2] "
                f"bit for bit: {same}; {text} {'ok' if ok else 'FAIL'}")
            if not ok:
                state.setdefault("serving_f32_failures", []).append(
                    f"{name} {label} {form}")
            if qk8 or i or not timed:
                continue
            kernel = lambda: fa.attention_out_int8_2src_cuda(*args)  # noqa
            ms, plain_ms, t = _time_pair(
                kernel, lambda: fa.attention_out_int8_2src_plain(*args),
                iters=5)
            o_k, o_ms, o_r, o_lo, o_hi = _ratio_turns(
                kernel, lambda: fa.attention_out_int8_cuda(q, kc, vc, H, op,
                                                           r),
                turns=5, iters=5)
            bound = _bound(12 * B * L1 * D + 8 * B * (L1 + L2) * D + D * D
                           + 8 * D, ops_int8=2 * B * L1 * D * D,
                           flops_fp32=4 * B * L1 * (L1 + L2) * D)
            log(f"[serving-f32] {name} {label}: kernel {t['kernel']} ms, "
                f"plain {t['plain']} ms (order plain, kernel, kernel, plain);"
                f" bound {bound[0]:.4f} ms ({bound[1]}); vs the one-source "
                f"fp32 form on keys concatenated beforehand, median of 5 "
                f"rounds in turns: {o_k:.4f} ms vs {o_ms:.4f} ms, ratio "
                f"{o_r:.3f} (rounds {o_lo:.3f}-{o_hi:.3f}) ({state['smi']})")
            _record(state, name, err, ms, plain_ms, bound, None)
            state["kstats"][name]["yardsticks"] = {"one_source_ms": o_ms}
    # its path: the public entry point on fp32 rows at the serving shape
    q, k1, v1, r = (torch.randn(128, 197, 768, generator=gen, device="cuda")
                    for _ in range(4))
    k2, v2 = (torch.randn(128, 17, 768, generator=gen, device="cuda")
              for _ in range(2))
    op = {"kernel": _qleaf(gen, 768, 768),
          "bias": torch.randn(768, generator=gen, device="cuda") * 0.02}
    _reset_launch_counts()
    with torch.inference_mode():
        y = fa.flash_attention_out_int8_2src(q, k1, v1, k2, v2, 12, op, r)
    torch.cuda.synchronize()
    n = _launch_counts()
    state.setdefault("launches_by_kernel", {})[name] = n[name]
    ok = (n[name] == 1 and n["attention_out_int8_2src"] == 0
          and y.dtype == torch.float32 and y.shape == r.shape
          and bool(torch.isfinite(y).all()))
    log(f"[serving-f32] {name} path: flash_attention_out_int8_2src on fp32 "
        f"q / k1 / v1 (128, 197, 768), k2 / v2 (128, 17, 768): launches "
        f"{n[name]} fp32 / {n['attention_out_int8_2src']} bf16 (expect 1 / "
        f"0) {'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("serving_f32_failures", []).append(f"{name} path")


def phase_serving_f32(state):
    """The fp32 forms of B9 (csrc/w8_matmul_f32.cu), B11 and B12
    (attention_f32.cu's int8-score and two-source forward, then B2's fp32
    entry) against their plain versions on the card; fp16 and mixed rows
    raise TypeError with no launch counted. With state['checks_only'] (the
    mutants' runs) nothing is timed, and with state['only'] only that
    kernel is checked, its libraries built at once."""
    import torch
    from gava_clip_tpu_torch.ops import _cuda
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    torch.backends.cuda.matmul.allow_tf32 = False
    only = state.get("only")
    timed = not state.get("checks_only")
    state.setdefault("kstats", {})
    _cuda.load_libraries(["w8_matmul_f32"] if only == "int8_matmul_f32"
                         else ["attention_f32", "w8a8_matmul"] if only
                         else ["w8_matmul_f32", "w8_matmul", "attention_f32",
                               "w8a8_matmul", "attention_out_int8"])
    gen = torch.Generator(device="cuda").manual_seed(19)
    _serving_f32_b9(state, gen, timed, only)
    _serving_f32_b11(state, gen, timed, only)
    _serving_f32_b12(state, gen, timed, only)
    if not only:
        x = torch.randn(2, 13, 128, generator=gen, device="cuda")
        op = {"kernel": _qleaf(gen, 128, 128),
              "bias": torch.randn(128, generator=gen, device="cuda")}
        leaf = _w8_leaf(gen, 128, 64)
        refusals = []
        _reset_launch_counts()
        for what, call in (
                ("fp16 B9", lambda: im.int8_matmul_cuda(x[0].half(), leaf)),
                ("fp16 B11", lambda: fa.attention_out_int8_cuda(
                    x.half(), x.half(), x.half(), 2, op, x.half(), None,
                    True)),
                ("mixed B11", lambda: fa.attention_out_int8_cuda(
                    x, x, x.to(torch.bfloat16), 2, op, x, None, True)),
                ("mixed B12", lambda: fa.attention_out_int8_2src_cuda(
                    x, x, x, x.to(torch.bfloat16), x, 2, op, x, True))):
            try:
                call()
                refusals.append(f"{what}: no error")
            except TypeError as e:
                if "all bfloat16 or all float32" not in str(e):
                    refusals.append(f"{what}: {e}")
        launched = {k: v for k, v in _launch_counts().items() if v}
        if launched:
            refusals.append(f"launches counted: {launched}")
        log(f"[serving-f32] fp16 and mixed rows into B9, B11 and B12 raise "
            f"TypeError, no launch counted: {not refusals} {refusals}")
        if refusals:
            state.setdefault("serving_f32_failures", []).append("refusals")
    if state.get("serving_f32_failures"):
        raise AssertionError(f"fp32 serving kernels disagree with their "
                             f"plain versions: "
                             f"{state['serving_f32_failures']}")


# launches of the attention kernels in one training step of the flagship
# model: 12 vision blocks (B6a forward, B6b backward) and 12 text blocks
# (B7 forward and backward); the forward that writes no denominators (B1)
# is not on this path
TRAIN_PER_STEP = {"packed_attention_den": 12, "packed_attention_bwd": 12,
                  "streaming_attention": 12, "streaming_attention_bwd": 12,
                  "packed_attention": 0}
TRAIN_STEPS = 6
# the first step through the kernels against the same step through the
# plain versions on the card: the two differ by single bf16 roundings in a
# share of ~5e-4 of the attention outputs (limits above), which 12 bf16
# blocks carry on. Measured on an H100 (NVIDIA H100 80GB HBM3, 700.00 W):
# loss 1.650962 vs 1.651374; relative L2 error of a gradient leaf 2.4e-4 in
# the median and 3.8e-2 at most (a leaf whose own norm is small); a wrong
# backward moves a leaf by its whole norm.
TRAIN_MAX_LOSS_DIFF = 2e-2
TRAIN_MAX_GRAD_REL_ERR = 1e-1


def _train_batch(B, T, seed=0):
    """The JAX bench's batch (bench.py main_train): seeded numpy inputs."""
    import torch
    rs = np.random.RandomState(seed)
    batch = {"video": rs.rand(B, T, 224, 224, 3).astype(np.float32),
             "labels": rs.randint(0, 3, size=B),
             "nte": rs.randn(B, 70, 512).astype(np.float32),
             "memory": rs.randn(64, 4, 512).astype(np.float32),
             "mt_labels": rs.randint(0, 3, size=64)}
    return {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def _grad_list(state_tree):
    from gava_clip_tpu_torch.train.state import tree_leaves
    return [p.grad.detach().float().clone() for p in tree_leaves(state_tree)
            if p is not None]


def _named_leaves(tree, prefix=""):
    """(path, tensor) of every leaf that is not a None placeholder."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items()
                for x in _named_leaves(v, f"{prefix}{k}.")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _named_leaves(v, f"{prefix}{i}.")]
    return [] if tree is None else [(prefix[:-1], tree)]


def phase_train_slice(state):
    """The training step at full width: build_flagship -> trainable_mask ->
    create_train_state -> make_train_step -> steps on a fixed batch."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer, tree_leaves)
    from gava_clip_tpu_torch.train.step import (LossConfig, make_loss_fn,
                                                make_train_step)
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    # the bench's schedule with a larger rate (the JAX bench's 5e-6 moves a
    # weight by less than one bf16 ulp in 6 steps: no loss could show it)
    opt = make_optimizer(lr=1e-3, num_steps=2000, weight_decay=0.2)
    kw = dict(compute_dtype=torch.bfloat16, attn_impl="flash")

    t0 = time.perf_counter()
    model = build_flagship(num_frames=8)          # on the card
    mask = trainable_mask(model.params, model.cfg)
    ts = create_train_state(model.params, mask, opt)
    n_train = sum(p.numel() for p in tree_leaves(ts.trainable)
                  if p is not None)
    n_frozen = sum(p.numel() for p in tree_leaves(ts.frozen)
                   if p is not None)
    batch = _train_batch(16, 8)
    log(f"[train-slice] built in {time.perf_counter() - t0:.1f} s (ViT-B/16 "
        f"T=8 224^2 + text 12 x 512 + KAPT over 5 versions + memory + NTE "
        f"heads; {n_train / 1e6:.2f} M trainable, {n_frozen / 1e6:.2f} M "
        f"frozen parameters; batch 16 clips, bf16, remat none)")
    if any(p.requires_grad for p in tree_leaves(ts.frozen) if p is not None):
        raise AssertionError("a frozen leaf requires a gradient")

    # the first step's loss and gradients through the plain versions
    loss_fn = make_loss_fn(model, loss_cfg, remat="none", **kw)
    with fa.plain_versions():
        total_plain, _ = loss_fn(ts.trainable, ts.frozen, batch)
        total_plain.backward()
    g_plain = _grad_list(ts.trainable)
    ts.optimizer.zero_grad(set_to_none=True)
    _reset_launch_counts()
    total_k, _ = loss_fn(ts.trainable, ts.frozen, batch)
    total_k.backward()
    torch.cuda.synchronize()
    if any(_launch_counts()[n] != TRAIN_PER_STEP[n] for n in TRAIN_PER_STEP):
        raise AssertionError(f"launches of one loss + backward "
                             f"{_launch_counts()}, expected {TRAIN_PER_STEP}")
    g_kernel = _grad_list(ts.trainable)
    ts.optimizer.zero_grad(set_to_none=True)
    d_loss = abs(total_k.item() - total_plain.item())
    scale = max(g.norm().item() for g in g_plain)
    rel = [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
           for a, b in zip(g_kernel, g_plain)]
    worst = [n for n, _ in _named_leaves(ts.trainable)][int(np.argmax(rel))]
    log(f"[train-slice] first step, kernels vs plain versions on the card: "
        f"total {total_k.item():.6f} vs {total_plain.item():.6f} (diff "
        f"{d_loss:.2e}, limit {TRAIN_MAX_LOSS_DIFF:g}); gradient leaves "
        f"{len(rel)}, max relative L2 error {max(rel):.3e} ({worst}), median "
        f"{float(np.median(rel)):.3e} (limit {TRAIN_MAX_GRAD_REL_ERR:g})")
    if not all(bool(torch.isfinite(g).all()) for g in g_kernel) or \
            d_loss > TRAIN_MAX_LOSS_DIFF or max(rel) > TRAIN_MAX_GRAD_REL_ERR:
        raise AssertionError("the training step through the kernels "
                             "disagrees with the plain versions")
    del g_plain, g_kernel

    step = make_train_step(model, loss_cfg, opt, remat="none", **kw)
    names_t = [n for n, _ in _named_leaves(ts.trainable)]
    before_t = [p.detach().clone() for _, p in _named_leaves(ts.trainable)]
    frozen = [p for p in tree_leaves(ts.frozen) if p is not None]
    before_f = [p.detach().clone() for p in frozen]
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    totals, host_ms, events = [], [], []
    for _ in range(TRAIN_STEPS):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        t1 = time.perf_counter()
        ev[0].record()
        ts, metrics = step(ts, batch)
        ev[1].record()
        totals.append(metrics["total"].item())     # waits for the step
        host_ms.append((time.perf_counter() - t1) * 1e3)
        events.append(ev)
    torch.cuda.synchronize()
    counts = _launch_counts()
    state["launches_train"] = counts
    dev_ms = [a.elapsed_time(b) for a, b in events]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"[train-slice] {TRAIN_STEPS} steps on a fixed batch: total loss "
        f"{[round(t, 4) for t in totals]}; last metrics "
        f"{ {k: round(v.item(), 4) for k, v in metrics.items()} }")
    log(f"[train-slice] launches over {TRAIN_STEPS} steps {counts} (expect "
        f"{TRAIN_PER_STEP} per step)")
    for name, per in TRAIN_PER_STEP.items():
        if counts[name] != per * TRAIN_STEPS:
            raise AssertionError(f"{name}: {counts[name]} launches, expected "
                                 f"{per} per step")
    if not all(np.isfinite(totals)) or not totals[-1] < totals[0]:
        raise AssertionError(f"the total loss did not fall: {totals}")
    if ts.step != TRAIN_STEPS:
        raise AssertionError(f"state.step {ts.step}")
    after_t = [p for _, p in _named_leaves(ts.trainable)]
    if not all(torch.equal(a, b) for a, b in zip(frozen, before_f)):
        raise AssertionError("a frozen leaf changed")
    # The knowledge projector's two layers are both zero-initialised, as in
    # the JAX package: each blocks the other's gradient, so they (and only
    # they) stay at zero. Every other trainable leaf must have moved.
    stuck = [n for n, a, b in zip(names_t, after_t, before_t)
             if torch.equal(a, b)]
    if sorted(stuck) != ["prompt.projector.w1", "prompt.projector.w2"] or \
            any(bool(ts.trainable["prompt"]["projector"][w].any())
                for w in ("w1", "w2")):
        raise AssertionError(f"trainable leaves that did not move: {stuck}")
    if len(ts.optimizer.state) != len(after_t):
        raise AssertionError("optimizer state for other than the trainable "
                             "leaves")
    log(f"[train-slice] {len(after_t) - 2} of {len(after_t)} trainable "
        f"leaves moved (the zero-initialised projector pair stays at zero), "
        f"{len(frozen)} frozen leaves bit-unchanged and without optimizer "
        f"state; step time by CUDA events {np.median(dev_ms[1:]):.2f} ms "
        f"median of {[round(t, 1) for t in dev_ms]}, by host clock "
        f"{np.median(host_ms[1:]):.2f} ms; {16e3 / np.median(host_ms[1:]):.1f}"
        f" clips/s; peak memory {peak:.2f} GiB ({state['smi']})")
    state.update(train_step=step, train_state=ts, train_batch=batch,
                 train_loss_fn=loss_fn, train_model=model,
                 train_cfg=loss_cfg, train_opt=opt, train_peak=peak,
                 train_ms=float(np.median(dev_ms[1:])))


TRAIN_LONG_STEPS = 3


def phase_train_long(state):
    """Steps at the JAX bench's shape (bench.py main_train): 4 clips of 70
    frames, remat='full': every block's forward runs twice."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from gava_clip_tpu_torch.train.step import LossConfig, make_train_step
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    for key in ("train_step", "train_state", "train_batch", "train_loss_fn",
                "train_model", "train_cfg", "train_opt"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    opt = make_optimizer(lr=5e-6, num_steps=2000, weight_decay=0.2)
    model = build_flagship(num_frames=70)
    ts = create_train_state(model.params,
                            trainable_mask(model.params, model.cfg), opt)
    step = make_train_step(model, loss_cfg, opt, remat="full",
                           compute_dtype=torch.bfloat16, attn_impl="flash")
    batch = _train_batch(4, 70)
    ts, metrics = step(ts, batch)                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launch_counts()
    dev_ms, host_ms = [], []
    for _ in range(TRAIN_LONG_STEPS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        ts, metrics = step(ts, batch)
        end.record()
        total = metrics["total"].item()            # waits for the step
        host_ms.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(start.elapsed_time(end))
    counts = _launch_counts()
    want = {n: per * TRAIN_LONG_STEPS for n, per in
            dict(TRAIN_PER_STEP, packed_attention_den=24).items()}
    log(f"[train-long] B=4 T=70 (280 frame rows, Lk 276), bf16, remat full, "
        f"{TRAIN_LONG_STEPS} steps: total {total:.4f}; launches {counts} "
        f"(expect {want}); step by CUDA events "
        f"{[round(t, 1) for t in dev_ms]} ms (median "
        f"{np.median(dev_ms):.2f}), by host clock "
        f"{[round(t, 1) for t in host_ms]} ms; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB "
        f"({state['smi']})")
    if not np.isfinite(total) or any(counts[n] != want[n] for n in want):
        raise AssertionError("the long-clip step failed its checks")


# ---------------------------------------------------------------------------
# the remaining serving modes: w8, fused prompt extras, int8 QK^T, the
# residual-free w8a8 MLP
# ---------------------------------------------------------------------------

# The w8 GEMM against its plain version: (most outputs that may differ at
# all, most that may differ by more than 2 bf16 ulp, the ceiling's factor k
# in err <= 2 ulp + k * (|x| @ |w|)). Both dequantize each weight with one
# rounding and round each output once; only the order of the fp32 sums
# differs, which moves an output across a bf16 rounding boundary in a small
# share of elements, and by more than 2 ulp only where a sum cancels to
# near zero: there the error stays within fp32 accumulation noise of the
# sum of the terms' magnitudes. A kernel that rounds the scale to bf16
# before the product moves most weights by a bf16 ulp and so most outputs.
W8_LIMITS = (5e-3, 1e-3, 2e-5)
# B9 in fp32 (csrc/w8_matmul_f32.cu) against its plain version, x @ the
# dequantized weight in fp32 (torch.matmul with TF32 off). The plain
# version sums K exact fp32 products in fp32. The kernel takes each product
# as 3xTF32, within 2^-20 of |x| |w| (the dropped lo x lo part and the
# tensor core's cut of the lo parts to 19 bits: ~2.5 * 2^-22), sums each
# k8 step's 24 products in a fresh accumulator (the tensor core truncates
# that sum: a few 2^-24 of it) and adds the step to its running sum in
# fp32, to nearest. With S = |x| @ |w| for each output, the per-product
# errors bound the sum by ~2.5 * 2^-22 * S if they all had one sign, and
# as a random walk they and the roundings stay near 2^-24 * S (the CPU
# emulation of the kernel, with the tensor core's truncation: at most
# 7.3 * 2^-24 * S against the plain version). A product whose operands
# are rounded to TF32 (10-bit mantissa, 2^-11 each) moves a sum by ~2^-10
# * |sum x w| ~ 2^-10 * S / sqrt(K), >= 2^-16 * S at K <= 3,072. Every
# output within 2^-19 * S: 2^5 above the fp32 walk, 2^3 below TF32, which
# the f32b9_products_tf32 (1xTF32) and f32b9_hi_x_lo_w_dropped mutants
# must fail.
W8_F32_REL = 2.0 ** -19
# (M, K, N): the projections of one block at batch 16 (q and out; k and v
# over the 214 kv rows; fc1; fc2), then ragged ones (K no multiple of 8:
# x copied zero-padded; K a multiple of 8 but not of 16, ragged M and odd
# N: element-wise stores; ragged M, N and K with 16-byte stores)
W8_MATMUL_SHAPES = ((25216, 768, 768, "q / out"), (27392, 768, 768, "k / v"),
                    (25216, 768, 3072, "fc1"), (25216, 3072, 768, "fc2"),
                    (37, 100, 33, "ragged"), (300, 776, 130, "ragged"),
                    (391, 1000, 264, "ragged"))
# The fused extras against their plain version: fp32 arithmetic on both
# sides, sums in another order. fp32 outputs within EXTRAS_TOL * max(1,
# max |plain|); bf16 outputs (each the rounding of such an fp32 value) equal
# in all but a share EXTRAS_MAX_DIFF_SHARE, and then one bf16 ulp apart. A
# kernel that rounds cls_proj to bf16 as the stock branch does moves every
# later value by up to 2^-9 of itself, most bf16 outputs with it.
EXTRAS_TOL = 2e-5
EXTRAS_MAX_DIFF_SHARE = 5e-3
# (Bb, Tb, D, heads, G, le_pad, activations, weights, LayerNorm gain,
# tolerance factor)
EXTRAS_SHAPES = ((16, 8, 768, 12, 8, 17, "bf16", "fp32", 1.0, 1),
                 (16, 8, 768, 12, 8, 24, "bf16", "bf16", 1.0, 1),
                 (16, 8, 768, 12, 8, 17, "fp32", "fp32", 1.0, 1),
                 (3, 3, 40, 2, 2, 8, "fp32", "fp32", 1.0, 1),
                 (2, 5, 64, 4, 3, 9, "bf16", "bf16", 1.0, 1),
                 # scores of ~1e3, far beyond a one-pass clamp: the exact
                 # softmax. The fp32 noise of such a score (~1e-4) moves an
                 # unsaturated probability by as much of itself, so the
                 # tolerance is 1e3 times wider; a clamped softmax is off
                 # by the outputs' own size, 1e4 times the tolerance
                 (4, 8, 768, 12, 8, 17, "fp32", "fp32", 40.0, 1000))
# shapes past one tile of the kernel's plan, under the same limits: 160
# frame rows (two row tiles), D = 1,024 (two K sub-chunks a block, 16
# slices and heads: more items than resident clusters on some cards) with
# zero pad rows; fp32 rows with bf16 weights and Tb = 40 (clips of a
# group that do not fill a row tile)
EXTRAS_TILED_SHAPES = ((20, 8, 1024, 16, 8, 20, "bf16", "fp32", 1.0, 1),
                       (3, 40, 256, 4, 2, 43, "fp32", "bf16", 1.0, 1))
# the int8 QK^T form against the fp32-score form of the same kernel, at the
# JAX test's input statistics (tests/test_flash_attention.py
# test_int8_qk_scores_close_to_fp32, which holds 5e-3 at D = 64 in fp32).
# Here D = 256 (the kernel's head dim is 64) and the outputs are bf16, so
# the check is on the whole tensor: the relative L2 distance, measured
# against the attention's contribution (output minus residual), and the
# largest |diff| against the largest |output|. The plain versions give
# 6.0e-3..6.7e-3 and 0.8e-2..1.1e-2 over five seeds.
INT8_QK_LOOSE_L2 = 2e-2
INT8_QK_LOOSE_MAX = 3e-2


def int8_qk_tie_rows(rs, n, width=64):
    """(n, width) float32 head slices whose values sit on the rounding ties
    of the int8 QK^T codes: each row's absmax qs is drawn where fp32(127 /
    qs) differs from fp32(fp32(1 / qs) * 127), and each other value is
    fp32((m + 0.5) / fp32(127 / qs)) wherever its product with the true
    quotient lands exactly on m + 0.5 (else a random value below qs). The
    true division gives the tie, which rounds to even; a code made with the
    reciprocal moves off it by an ulp and rounds the other way for about
    half of them."""
    f32 = np.float32
    out = np.empty((n, width), np.float32)
    for i in range(n):
        while True:
            qs = f32(rs.uniform(1.0, 4.0))
            r = f32(127.0) / qs
            if r != (f32(1.0) / qs) * f32(127.0):
                break
        m = rs.randint(0, 127, width)
        x = ((m + 0.5) / np.float64(r)).astype(np.float32)
        tie = (x * r == (m + 0.5).astype(np.float32)) & (x < qs)
        row = np.where(tie, x, rs.uniform(0.0, 1.0, width).astype(np.float32)
                       * qs)
        row = row * np.where(rs.rand(width) < 0.5, f32(-1.0), f32(1.0))
        row[rs.randint(width)] = qs if rs.rand() < 0.5 else -qs
        out[i] = row
    return out


def _w8_leaf(gen, K, N):
    """A weight-only kernel leaf {'q', 'scale', 'q_t'} (heavy-tailed rows;
    'q_t' the w8 kernel's tiles)."""
    from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
    leaf = _qleaf(gen, K, N)
    return with_kernel_layout({"q": leaf["qa"], "scale": leaf["scale"]})


def _record(state, name, err, ms, plain_ms, bound, library_ms):
    state.setdefault("kstats", {})[name] = {
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}


def _w8_matmul_checks(state, gen):
    import torch
    from gava_clip_tpu_torch.ops import int8_matmul as im
    lim_diff, lim_far, k_ceiling = W8_LIMITS
    for M, K, N, what in W8_MATMUL_SHAPES:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        leaf = _w8_leaf(gen, K, N)
        out = im.int8_matmul_cuda(x, leaf)
        ref = im.int8_matmul_plain(x, leaf["q"], leaf["scale"])
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs()
        ulp = bf16_ulp(ref)
        w = im.dequant_weight(leaf["q"], leaf["scale"], x.dtype)
        spread = x.float().abs() @ w.float().abs()
        ceiling = 2 * ulp + k_ceiling * spread
        diff_share = (err > 0).float().mean().item()
        far_share = (err > 2 * ulp).float().mean().item()
        ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
              and diff_share <= lim_diff and far_share <= lim_far
              and bool((err <= ceiling).all()))
        log(f"[w8-kernel] int8_matmul {what} M={M} K={K} N={N}: max_abs_err "
            f"{err.max().item():.3e}; outputs != plain {diff_share:.3e} "
            f"(limit {lim_diff:g}), > 2 bf16 ulp {far_share:.3e} (limit "
            f"{lim_far:g}); max err/ceiling {(err / ceiling).max().item():.3f}"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8_failures", []).append(f"int8_matmul {what}")
        del spread, ceiling, ulp
        if what == "ragged":
            continue
        ms, plain_ms, t = _time_pair(
            lambda: im.int8_matmul_cuda(x, leaf),
            lambda: im.int8_matmul_plain(x, leaf["q"], leaf["scale"]))
        # the one PyTorch call that computes the same function, on the
        # weight dequantized beforehand (a yardstick only: the port never
        # calls it), in turns with the kernel
        w = im.dequant_weight(leaf["q"], leaf["scale"], x.dtype)
        r = _ratio_turns(lambda: im.int8_matmul_cuda(x, leaf),
                         lambda: torch.matmul(x, w))
        bound = _bound(2 * M * K + K * N + 4 * N + 2 * M * N,
                       flops_bf16=2 * M * K * N)
        log(f"[w8-kernel] int8_matmul {what}: kernel {t['kernel']} ms "
            f"({2e-9 * M * K * N / ms:.0f} TFLOP/s), plain {t['plain']} ms, "
            f"bound {bound[0]:.4f} ms ({bound[1]}) (order plain, kernel, "
            f"kernel, plain); vs torch.matmul on the dequantized weight, "
            f"median of 7 rounds in turns (kernel, matmul, matmul, kernel; "
            f"10 calls each): {r[0]:.4f} ms vs {r[1]:.4f} ms, ratio "
            f"{r[2]:.3f} (rounds {r[3]:.3f}-{r[4]:.3f}) ({state['smi']})")
        if what == "fc1":
            _record(state, "int8_matmul", err.max().item(), ms, plain_ms,
                    bound, r[1])


def _w8a8_mlp_checks(state, gen):
    """B5a at the tower's shape with and without the LayerNorm, and a ragged
    shape; and the qkv kernel with no extras rows (B3a), timed."""
    import torch
    from gava_clip_tpu_torch.ops import int8_matmul as im
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    def bias(n):
        return torch.randn(n, generator=gen, device="cuda") * 0.02

    for i, (M, K, Hd, N, with_ln) in enumerate((
            (25216, 768, 3072, 768, True), (25216, 768, 3072, 768, False),
            (37, 768, 3072, 768, True), (20, 64, 200, 33, False))):
        x = randn(M, K)
        ln = _ln_params(gen, K) if with_ln else None
        fc1 = {"kernel": _qleaf(gen, K, Hd), "bias": bias(Hd)}
        fc2 = {"kernel": _qleaf(gen, Hd, N), "bias": bias(N)}
        x32 = x.float() if ln is None else im.ln_f32(x.float(), *ln)
        codes, xs = im.quant_rows(x32)
        k1 = fc1["kernel"]
        h = im.quick_gelu_f32(im.rescale(im.int_matmul(codes, k1["qa"]), xs,
                                         k1["scale"], fc1["bias"]))
        unit = _flip_unit(im.quant_rows(h)[1], fc2["kernel"]["scale"])
        del codes, h, x32
        out = im.w8a8_mlp_cuda(x, fc1, fc2, ln)
        ref = im.w8a8_mlp_plain(x, fc1, fc2, ln)
        torch.cuda.synchronize()
        ok, err, text = _check_w8a8("w8a8_mlp", out, ref, unit)
        label = f"M={M} K={K} H={Hd} N={N} ln={'yes' if with_ln else 'none'}"
        log(f"[w8-kernel] w8a8_mlp {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8_failures", []).append(f"w8a8_mlp {label}")
        if i < 2:
            ms, plain_ms, t = _time_pair(
                lambda: im.w8a8_mlp_cuda(x, fc1, fc2, ln),
                lambda: im.w8a8_mlp_plain(x, fc1, fc2, ln), iters=5)
            bound = _bound(2 * M * K + 2 * M * N + K * Hd + Hd * N
                           + 8 * (Hd + N + K), ops_int8=2 * M * Hd * (K + N))
            log(f"[w8-kernel] w8a8_mlp {label}: kernel {t['kernel']} ms, "
                f"plain {t['plain']} ms, bound {bound[0]:.4f} ms "
                f"({bound[1]}) (order plain, kernel, kernel, plain; "
                f"{state['smi']})")
            if i == 0:
                # no one PyTorch call computes a w8a8 op: no library time
                _record(state, "w8a8_mlp", err, ms, plain_ms, bound, None)

    # the qkv kernel with no extras rows (the TPU's _w8a8_kernel3) at the
    # tower's shape: checked at Le = 0 in the w8a8-kernel phase, timed here
    B, Lx, K, N = 128, 197, 768, 768
    x, ln = randn(B, Lx, K), _ln_params(gen, K)
    k3 = [_qleaf(gen, K, N) for _ in range(3)]
    b3 = [bias(N) for _ in range(3)]
    ms, plain_ms, t = _time_pair(
        lambda: im.w8a8_matmul3_cat_cuda(x, None, k3, b3, ln),
        lambda: im.w8a8_matmul3_cat_plain(x, None, k3, b3, ln))
    bound = _bound(B * Lx * (2 * K + 6 * N) + 3 * K * N + 24 * N + 8 * K,
                   ops_int8=6 * B * Lx * K * N)
    log(f"[w8-kernel] w8a8_matmul3_cat with no extras rows (Le = 0) B={B} "
        f"Lx={Lx} K={K} N={N}: kernel {t['kernel']} ms, plain {t['plain']} "
        f"ms, bound {bound[0]:.4f} ms ({bound[1]}) ({state['smi']})")
    # its public entry w8a8_matmul3 (B3a) at the shape of its main path: the
    # fused q/k/v projection of the flagship's text attention in the driver
    # phase (TEXT_QKV_ROWS rows of width 512, no LayerNorm); the driver
    # phase also holds each of those launches against the plain version
    M, K = TEXT_QKV_ROWS, TEXT_WIDTH
    x = randn(M, K)
    k3 = [_qleaf(gen, K, K) for _ in range(3)]
    b3 = [bias(K) for _ in range(3)]
    outs = im.w8a8_matmul3_cuda(x, k3, b3)
    refs = im.w8a8_matmul3_plain(x, k3, b3)
    torch.cuda.synchronize()
    xs = im.quant_rows(x.float())[1]
    errs, ok = [], True
    for o, r, leaf in zip(outs, refs, k3):
        good, err, text = _check_w8a8("w8a8_matmul3_cat", o, r,
                                      xs * leaf["scale"].reshape(1, -1) * 127)
        ok, errs = ok and good, errs + [err]
        log(f"[w8-kernel] w8a8_matmul3 M={M} K={K}: {text} "
            f"{'ok' if good else 'FAIL'}")
    if not ok:
        state.setdefault("w8_failures", []).append("w8a8_matmul3")
    ms, plain_ms, t = _time_pair(lambda: im.w8a8_matmul3_cuda(x, k3, b3),
                                 lambda: im.w8a8_matmul3_plain(x, k3, b3))
    bound = _bound(M * (2 * K + 6 * K) + 3 * K * K + 24 * K,
                   ops_int8=6 * M * K * K)
    # a launch of a few microseconds: CUDA events around host-launched
    # calls read the host's cost of each call; a CUDA graph of 20 reads the
    # device's
    graph_ms = cuda_time_ms(_graph_call(lambda: im.w8a8_matmul3_cuda(
        x, k3, b3)), iters=5) / GRAPH_LAUNCHES
    log(f"[w8-kernel] w8a8_matmul3 M={M} K={K}: kernel {t['kernel']} ms, "
        f"plain {t['plain']} ms, bound {bound[0]:.5f} ms ({bound[1]}), no "
        f"library call (order plain, kernel, kernel, plain); "
        f"{GRAPH_LAUNCHES} launches in a CUDA graph {graph_ms:.5f} ms a "
        f"launch, the floor of a graph node {_graph_floor_ms(state):.5f} ms "
        f"(a one-element add) ({state['smi']})")
    _record(state, "w8a8_matmul3", max(errs), ms, plain_ms, bound, None)
    state["kstats"]["w8a8_matmul3"]["graph_ms"] = graph_ms


def _extras_params(gen, Tb, D, G, wdtype, ln_gain):
    """A block's prompt-branch params as the w8a8 classifier holds them
    (fp32) or as a caller that cast its tree would (bf16 weights)."""
    import torch

    def randn(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    def lin():
        return {"kernel": randn(D, D, std=D ** -0.5).to(wdtype),
                "bias": randn(D, std=0.02)}

    p = {"cls_proj": lin(),
         "summary_ln": {"scale": (1 + 0.1 * randn(D)) * ln_gain,
                        "bias": randn(D, std=0.02)},
         "summary_attn": {n: lin() for n in ("q", "k", "v", "out")},
         "local_prompts": randn(1, Tb, D, std=0.05)}
    return p, randn(G, D, std=0.05)


def _fused_extras_checks(state, gen):
    import torch
    from gava_clip_tpu_torch.models.vision import VisionConfig, prompt_extras
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    dt = {"bf16": torch.bfloat16, "fp32": torch.float32}
    for i, (Bb, Tb, D, H, G, le_pad, act, wd, gain, tol_factor) in enumerate(
            EXTRAS_SHAPES + EXTRAS_TILED_SHAPES):
        tol = EXTRAS_TOL * tol_factor
        BT = Bb * Tb
        p, gp = _extras_params(gen, Tb, D, G, dt[wd], gain)
        # the cls rows as the tower hands them over: a strided view
        x = (torch.randn(BT, 5, D, generator=gen, device="cuda")
             ).to(dt[act])
        cls = x[:, 0]
        kw = dict(Tb=Tb, num_heads=H, le_pad=le_pad)
        e, summ = ek.fused_extras_cuda(cls, p, gp, **kw)
        e_ref, summ_ref = ek.fused_extras_plain(cls, p, gp, **kw)
        torch.cuda.synchronize()
        le = G + 1 + Tb
        oks, texts, worst = [], [], 0.0
        for name, out, ref in (("e", e, e_ref), ("summary", summ, summ_ref)):
            err = (out.float() - ref.float()).abs()
            scale = max(1.0, ref.float().abs().max().item())
            worst = max(worst, err.max().item())
            if act == "fp32":
                ok = bool((err <= tol * scale).all())
                texts.append(f"{name} max_abs_err {err.max().item():.3e} "
                             f"(limit {tol * scale:.1e})")
            else:
                share = (err > 0).float().mean().item()
                ok = share <= EXTRAS_MAX_DIFF_SHARE and bool(
                    (err <= bf16_ulp(ref) + tol * scale).all())
                texts.append(f"{name} max_abs_err {err.max().item():.3e}, "
                             f"outputs != plain {share:.3e} (limit "
                             f"{EXTRAS_MAX_DIFF_SHARE:g})")
            oks.append(ok and out.shape == ref.shape and out.dtype == dt[act]
                       and bool(torch.isfinite(out.float()).all()))
        # the rows that are copies: global prompts and zero pad rows
        oks.append(bool((e[:, le:] == 0).all()) and torch.equal(
            e[:, :G], gp.to(dt[act])[None].expand(BT, G, D)))
        label = (f"Bb={Bb} Tb={Tb} D={D} H={H} G={G} le_pad={le_pad} "
                 f"activations {act} weights {wd} LN gain {gain:g}")
        log(f"[w8-kernel] fused_extras {label}: {'; '.join(texts)}; pad rows "
            f"zero and global rows exact: {oks[-1]} "
            f"{'ok' if all(oks) else 'FAIL'}")
        if not all(oks):
            state.setdefault("w8_failures", []).append(f"fused_extras {label}")
        if i >= 2:
            continue
        # the stock ops that the fused launch replaces, on the same inputs,
        # in the activations' dtype (the yardstick of this row)
        cfg = VisionConfig(num_frames=Tb, feature_dim=D, heads=H,
                           use_summary_token=True, use_local_prompts=True,
                           use_global_prompts=True, num_global_prompts=G)

        def stock():
            extras, s_ = prompt_extras(p, gp, x, cfg)
            return torch.cat(extras, dim=1), s_

        ms, plain_ms, t = _time_pair(
            lambda: ek.fused_extras_cuda(cls, p, gp, **kw),
            lambda: ek.fused_extras_plain(cls, p, gp, **kw), iters=20)
        stock_ms = cuda_time_ms(stock, iters=20)
        d_stock = (stock()[0].float() - e_ref[:, :le].float()).abs().max()
        wb, ab = (2 if wd == "bf16" else 4), (2 if act == "bf16" else 4)
        bound = _bound(5 * D * D * wb + BT * D * ab * 2
                       + BT * le_pad * D * ab + 4 * (7 + Tb + G) * D,
                       flops_fp32=2 * 5 * BT * D * D
                       + 4 * Bb * Tb * Tb * D)
        log(f"[w8-kernel] fused_extras {label}: kernel {t['kernel']} ms, "
            f"plain {t['plain']} ms, the stock ops it replaces (with the "
            f"concatenation) {stock_ms:.4f} ms, bound {bound[0]:.4f} ms "
            f"({bound[1]}); stock ops vs the fp32 arithmetic max |diff| "
            f"{d_stock.item():.3e} (order plain, kernel, kernel, plain; "
            f"{state['smi']})")
        # device time: launches captured in a CUDA graph
        graph_ms = cuda_time_ms(_graph_call(
            lambda: ek.fused_extras_cuda(cls, p, gp, **kw)),
            iters=5) / GRAPH_LAUNCHES
        log(f"[w8-kernel] fused_extras {label}: {GRAPH_LAUNCHES} launches in "
            f"a CUDA graph {graph_ms:.5f} ms a launch ({state['smi']})")
        if i == 0:
            _record(state, "fused_extras", worst, ms, plain_ms, bound,
                    stock_ms)
            state["kstats"]["fused_extras"]["graph_ms"] = graph_ms


def _int8_qk_checks(state, gen):
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.ops import int8_matmul as im
    bf = torch.bfloat16

    def randn(*shape, gain=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * gain).to(bf)

    name = "attention_out_int8_qk8"
    for i, (B, lq, Lq, Lk, H) in enumerate(W8A8_ATTN_SHAPES):
        D = H * 64
        q, k, v = randn(B, Lq, D), randn(B, Lk, D), randn(B, Lk, D)
        op = {"kernel": _qleaf(gen, D, D),
              "bias": torch.randn(D, generator=gen, device="cuda") * 0.02}
        r = randn(B, lq, D)
        xs = im.quant_rows(fa._onepass_attention_den_f32(
            q[:, :lq], k, v, H, int8_qk=True)[0])[1]
        unit = _flip_unit(xs, op["kernel"]["scale"])
        out = fa.attention_out_int8_cuda(q, k, v, H, op, r, lq, True)
        ref = fa.attention_out_int8_plain(q, k, v, H, op, r, lq, True)
        torch.cuda.synchronize()
        ok, err, text = _check_w8a8(name, out, ref, unit)
        label = f"B={B} lq={lq} Lq={Lq} Lk={Lk} H={H}"
        log(f"[w8-kernel] {name} {label}: {text} {'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("w8_failures", []).append(f"{name} {label}")
        if i == 0:
            t = {"plain": [], "int8": [], "fp32": []}
            fns = {"plain": lambda: fa.attention_out_int8_plain(
                       q, k, v, H, op, r, lq, True),
                   "int8": lambda: fa.attention_out_int8_cuda(
                       q, k, v, H, op, r, lq, True),
                   "fp32": lambda: fa.attention_out_int8_cuda(
                       q, k, v, H, op, r, lq, False)}
            for which in ("plain", "fp32", "int8", "int8", "fp32", "plain"):
                t[which].append(cuda_time_ms(fns[which], iters=10))
            bound = _bound(6 * B * lq * D + 4 * B * Lk * D + D * D + 8 * D,
                           flops_bf16=2 * B * lq * Lk * D,
                           ops_int8=2 * B * lq * Lk * D + 2 * B * lq * D * D)
            log(f"[w8-kernel] {name} serving shape: kernel {t['int8']} ms, "
                f"the fp32-score form of the same kernel {t['fp32']} ms, "
                f"plain {t['plain']} ms, bound {bound[0]:.4f} ms "
                f"({bound[1]}) (order plain, fp32, int8, int8, fp32, plain; "
                f"{state['smi']})")
            _record(state, name, err, sum(t["int8"]) / 2,
                    sum(t["plain"]) / 2, bound, None)
    # the loose check against the fp32-score form
    B, Lq, Lk, H = 3, 30, 38, 4
    D = H * 64
    q, k = randn(B, Lq, D, gain=0.3), randn(B, Lk, D, gain=0.3)
    v, r = randn(B, Lk, D, gain=0.1), randn(B, Lq, D, gain=0.1)
    from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
    op = {"kernel": with_kernel_layout({
        "qa": torch.randint(-127, 127, (D, D), generator=gen,
                            device="cuda").to(torch.int8),
        "scale": torch.randn(1, D, generator=gen, device="cuda").abs()
        * 0.01}),
        "bias": torch.randn(D, generator=gen, device="cuda") * 0.01}
    got = fa.attention_out_int8_cuda(q, k, v, H, op, r, None, True).float()
    want = fa.attention_out_int8_cuda(q, k, v, H, op, r, None, False).float()
    diff = (got - want).abs()
    rel_l2 = (diff.norm() / (want - r.float()).norm()).item()
    rel_max = (diff.max() / want.abs().max().clamp_min(1.0)).item()
    ok = rel_l2 <= INT8_QK_LOOSE_L2 and rel_max <= INT8_QK_LOOSE_MAX and \
        diff.max().item() > 0
    log(f"[w8-kernel] {name} vs the fp32-score form (B={B} Lq={Lq} Lk={Lk} "
        f"H={H}, q, k x 0.3): relative L2 of the diff against the "
        f"attention's contribution {rel_l2:.3e} (limit "
        f"{INT8_QK_LOOSE_L2:g}), max |diff| / max |output| {rel_max:.3e} "
        f"(limit {INT8_QK_LOOSE_MAX:g}); the switch changes the result: "
        f"{diff.max().item() > 0} {'ok' if ok else 'FAIL'}")
    if not ok:
        state.setdefault("w8_failures", []).append(f"{name} loose check")


def phase_w8_kernels(state):
    """B9, B5a, B10 and B11 against their plain versions on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(3)
    _w8_matmul_checks(state, gen)
    _w8a8_mlp_checks(state, gen)
    _fused_extras_checks(state, gen)
    _int8_qk_checks(state, gen)
    if state.get("w8_failures"):
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{state['w8_failures']}")


def _mega_bound(F, lx, le, d, hd):
    """Bound of one whole w8a8 layer over F frame rows: the int8 products
    (q from the x rows, k and v from all rows, the out-projection, fc1,
    fc2), the bf16 score and AV products, and the bytes of x, e, the output
    and the weights with their scales, biases and LayerNorm params."""
    lkv = lx + le
    ops = 2 * F * d * (lx * d + 2 * lkv * d + lx * d + 2 * lx * hd)
    flops = 4 * F * lx * lkv * d
    n_bytes = (2 * F * (2 * lx + le) * d + 4 * d * d + 2 * d * hd
               + 4 * (10 * d + 2 * hd))
    return _bound(n_bytes, flops_bf16=flops, ops_int8=ops)


def phase_mega(state):
    """The port's tool (tools/bench_attn_variants.py): the whole-layer w8a8
    kernel against its plain version at the tool's shape, the serving batch
    and a ragged shape (MEGA_LIMITS); the tool's gate (mega against the
    serving composition through the kernels) at its shape and draws; times
    of kernel, plain version and composition in turns; then the tool's own
    entry point, `--parity` and timing, with the launches counted."""
    import torch
    from gava_clip_tpu_torch.tools import bench_attn_variants as tool
    lim_diff, lim_far, lim_units = MEGA_LIMITS
    for i, (F, lx, le, d, hd, heads) in enumerate(MEGA_SHAPES):
        rs = np.random.RandomState(0)
        params = tool.params_to_port(*tool.make_params(rs, d, hd),
                                     device="cuda")
        x, e = tool.make_inputs(rs, F, lx, le, d, device="cuda")
        out = tool.mega_layer_cuda(x, e, *params, heads=heads)
        y32, xs_hidden = tool.mega_layer_f32(x, e, *params, heads=heads)
        ref = y32.to(x.dtype)
        torch.cuda.synchronize()
        unit = (xs_hidden * 127.0
                * params[1]["fc2"]["kernel"]["scale"].reshape(-1).float())
        err = (out.float() - ref.float()).abs()
        ulp = bf16_ulp(ref)
        diff_share = (err > 0).float().mean().item()
        far_share = (err > 2 * ulp).float().mean().item()
        units = ((err - 2 * ulp).clamp_min(0) / unit).max().item()
        max_err = err.max().item()
        ok = (out.shape == ref.shape and bool(torch.isfinite(out).all())
              and diff_share <= lim_diff and far_share <= lim_far
              and units <= lim_units)
        label = f"F={F} Lx={lx} Le={le} D={d} H={hd} heads={heads}"
        log(f"[mega] mega_layer {label}: max_abs_err {max_err:.3e}"
            f"; outputs != plain {diff_share:.3e} (limit {lim_diff:g}), > 2 "
            f"bf16 ulp {far_share:.3e} (limit {lim_far:g}), max (err - 2 "
            f"ulp) / hidden flip unit {units:.3f} (limit {lim_units:g}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("mega_failures", []).append(label)
        del y32, ref, err, ulp, unit
        # the plan spreads a frame row over a cluster of CTAs (two at the
        # tool's shape); one CTA a frame row, taking all its tiles, must
        # give the same bits
        one = tool.mega_layer_cuda(x, e, *params, heads=heads, split=1)
        same = torch.equal(one, out)
        log(f"[mega] mega_layer {label}: one CTA a frame row equal to "
            f"the plan's cluster bit for bit: {same} "
            f"{'ok' if same else 'FAIL'}")
        if not same:
            state.setdefault("mega_failures", []).append(f"split {label}")
        del one
        if i == 2:
            continue
        # the tool's gate: mega against the serving composition, both
        # through their kernels
        diff, rel = tool.parity(x, e, *params, heads=heads)
        gate = i == 0
        log(f"[mega] mega vs base (B3a + B4 + B5) {label}: max abs diff "
            f"{diff:.5f}, rel {rel:.5f}"
            + (f" (the tool's gate {tool.PARITY_REL:g}) "
               f"{'ok' if rel < tool.PARITY_REL else 'FAIL'}" if gate
               else " (no gate at this shape)"))
        if gate and not rel < tool.PARITY_REL:
            state.setdefault("mega_failures", []).append(f"parity {label}")
        kernel = lambda: tool.mega_layer_cuda(x, e, *params, heads=heads)
        base = lambda: tool.base_layer(x, e, *params, heads=heads)
        k, o, ratio, lo, hi = _ratio_turns(kernel, base)
        plain_ms = cuda_time_ms(
            lambda: tool.mega_layer_plain(x, e, *params, heads=heads),
            iters=3, warmup=1)
        bound = _mega_bound(F, lx, le, d, hd)
        log(f"[mega] mega_layer {label}: kernel {k:.4f} ms, base "
            f"composition {o:.4f} ms (median of 7 rounds in turns, ratio "
            f"{ratio:.3f}, rounds {lo:.3f}-{hi:.3f}), plain {plain_ms:.4f} "
            f"ms, bound {bound[0]:.4f} ms ({bound[1]}) ({state['smi']})")
        if i == 0:
            # no one PyTorch call computes a layer: no library time; the
            # serving composition is the yardstick
            _record(state, "mega_layer", max_err, k, plain_ms, bound, None)
            state["kstats"]["mega_layer"]["yardsticks"] = {"base_ms": o}
        del x, e, params
    # the tool's own entry point, as a user runs it: the launches of its path
    _reset_launch_counts()
    rc_parity = tool.main(["--parity", "--device", "cuda"])
    rc_time = tool.main(["--iters", "10", "--device", "cuda"])
    torch.cuda.synchronize()
    n = _launch_counts()["mega_layer"]
    state.setdefault("launches_by_kernel", {})["mega_layer"] = n
    log(f"[mega] the tool's path (--parity, then timing): exit codes "
        f"{rc_parity} / {rc_time}, {n} mega_layer launches")
    if rc_parity or rc_time or n < 1:
        state.setdefault("mega_failures", []).append("the tool's path")
    if state.get("mega_failures"):
        raise AssertionError(f"mega layer checks failed: "
                             f"{state['mega_failures']}")


W8_PER_FORWARD = {"int8_matmul": 72, "packed_attention": 12,
                  "w8a8_matmul": 0, "w8a8_mlp_res": 0}
# The w8 forward is held to the same forward through the plain versions of
# its GEMM and its attention as the w8a8 slice is (W8A8_MAX_LOGIT_DIFF_INIT
# on the plain init, W8A8_PATHOLOGY_FACTOR on the pathology weights), and to
# the bf16 forward by the prob gate and this multiple of the bf16
# kernel-vs-plain logit distance (measured 1.35 against 1.58 on an H100).
W8_BF16_FACTOR = 2.0


def _w8_logits(clf, xn, plain: bool):
    import contextlib
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    with torch.inference_mode(), \
            (fa.plain_versions() if plain else contextlib.nullcontext()):
        return clf.net(xn, compute_dtype=torch.bfloat16, attn_impl="flash",
                       int8_impl="plain" if plain else "kernel")["logits"]


def phase_w8_slice(state):
    """The weight-only int8 zero-shot path (ViT-B/16, T=8, 224^2, 400
    classes) at batch 16 on the pathology-injected weights, and
    mlp_block(residual=None) on w8a8 leaves at the tower's shape."""
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    model, params, labels = state["model"], state["params"], state["labels"]
    clips = state["clips"]
    t0 = time.perf_counter()
    clf = _classifier(model, params, labels, quantize="w8")
    assert clf.attn_impl == "flash" and clf.quantize == "w8"
    clf.warmup()
    log(f"[w8-slice] built + warmed up in {time.perf_counter() - t0:.1f} s "
        f"(w8, batch 16)")
    _reset_launch_counts()
    p16 = clf.classify_clips(clips)
    torch.cuda.synchronize()
    n16 = _launch_counts()
    p5 = clf.classify_clips(clips[:5])
    torch.cuda.synchronize()
    n_all = _launch_counts()
    state.setdefault("launches_by_kernel", {})["int8_matmul"] = \
        n_all["int8_matmul"]
    log(f"[w8-slice] launches for the 16-clip forward {n16}, after the "
        f"5-clip forward {n_all} (expect {W8_PER_FORWARD} per forward)")
    for name, per in W8_PER_FORWARD.items():
        if (n16[name], n_all[name]) != (per, 2 * per):
            raise AssertionError(f"{name}: {n16[name]} / {n_all[name]} "
                                 f"launches, expected {per} per forward")
    _check_probs("16 clips", p16, 16)
    _check_probs("5 clips", p5, 5)
    d_pad = np.abs(p5 - p16[:5]).max()
    if d_pad > 1e-3:
        raise AssertionError("padding a partial batch changed the results")

    x = clf._prepare(clips)
    with torch.inference_mode():
        xn = normalize_frames(x, clf._mean, clf._std)
    lg, lg_plain = _w8_logits(clf, xn, False), _w8_logits(clf, xn, True)
    d_path = (lg - lg_plain).abs().max().item()
    init_clf = _classifier(model, model.param_tree(), labels, quantize="w8")
    d_init = (_w8_logits(init_clf, xn, False)
              - _w8_logits(init_clf, xn, True)).abs().max().item()
    del init_clf
    bf16 = state["clf"]
    with torch.inference_mode():
        lg_bf16 = bf16.net(xn, compute_dtype=torch.bfloat16,
                           attn_impl="flash")["logits"]
    d_prob = np.abs(p16 - state["p16_bf16"]).max()
    d_logit_bf16 = (lg - lg_bf16).abs().max().item()
    lim_path = W8A8_PATHOLOGY_FACTOR * state["d_logit_bf16_paths"]
    log(f"[w8-slice] max |logit diff| kernels vs plain versions: pathology "
        f"weights {d_path:.4f} (limit {lim_path:.4f} = {W8A8_PATHOLOGY_FACTOR}"
        f" x the bf16 kernel-vs-plain {state['d_logit_bf16_paths']:.4f}), "
        f"plain init {d_init:.4f} (limit {W8A8_MAX_LOGIT_DIFF_INIT}); padded "
        f"(5 of 8) vs full batch max |prob diff| {d_pad:.2e}")
    # int8 weights move the logits as far from bf16 as rounding paths move
    # them on these weights: within twice the bf16 kernel-vs-plain distance
    lim_bf16 = W8_BF16_FACTOR * state["d_logit_bf16_paths"]
    log(f"[w8-slice] gate vs the bf16 classifier: max |prob diff| "
        f"{d_prob:.4e} (limit {W8A8_PROB_GATE}), max |logit diff| "
        f"{d_logit_bf16:.4f} (limit {lim_bf16:.4f} = {W8_BF16_FACTOR} x the "
        f"bf16 kernel-vs-plain)")
    if not bool(torch.isfinite(lg).all()) or d_path > lim_path or \
            d_init > W8A8_MAX_LOGIT_DIFF_INIT:
        raise AssertionError("the w8 kernels' forward disagrees with the "
                             "plain versions' forward")
    if d_prob > W8A8_PROB_GATE or d_logit_bf16 > lim_bf16:
        raise AssertionError("the w8 forward is too far from the bf16 one")

    # patch-major + w8: the embed is the float GEMM on the folded kernel
    # (no int8 sidecar without activation quant), the blocks are the same
    pm = _classifier(model, params, labels, quantize="w8", patch_major=True)
    _reset_launch_counts()
    p_pm = pm.classify_clips(clips)
    torch.cuda.synchronize()
    n_pm = _launch_counts()
    _check_probs("patch-major", p_pm, 16)
    # another rounding path through the embed (raw uint8 rows against the
    # folded fp32 kernel cast to bf16), which the pathology weights amplify
    # as they amplify every rounding: held to the repo's gate
    d_pm = np.abs(p_pm - p16).max()
    d_pm_bf16 = np.abs(p_pm - state["p16_bf16"]).max()
    log(f"[w8-slice] w8 + patch-major: launches {n_pm['int8_matmul']} "
        f"int8_matmul, {n_pm['w8a8_matmul']} w8a8_matmul (expect 72, 0); "
        f"max |prob diff| vs the frames-input w8 classifier {d_pm:.3e}, vs "
        f"the bf16 classifier {d_pm_bf16:.4e} (limit {W8A8_PROB_GATE})")
    if (n_pm["int8_matmul"], n_pm["w8a8_matmul"]) != (72, 0) or \
            d_pm_bf16 > W8A8_PROB_GATE:
        raise AssertionError("the patch-major w8 classifier failed")
    del pm

    e2e, fwd_ms, lat = _serving_times(clf, clips, x)
    plain_ms = cuda_time_ms(lambda: _w8_logits(clf, xn, True), iters=3,
                            warmup=1)
    state.update(clf_w8=clf, fwd_ms_w8=fwd_ms)
    log(f"[w8-slice] batch 16: {e2e:.1f} clips/s end to end, device forward "
        f"{fwd_ms:.2f} ms = {16e3 / fwd_ms:.1f} clips/s (bf16 path "
        f"{state['fwd_ms']:.2f} ms; the forward through the plain versions "
        f"{plain_ms:.2f} ms); batch 1 latency p50 {lat:.2f} ms "
        f"({state['smi']})")

    # B5a's path: an MLP block called without a residual on w8a8 leaves, at
    # the tower's shape, through ops.linear.mlp_block
    from gava_clip_tpu_torch.ops.activations import quick_gelu
    from gava_clip_tpu_torch.ops.linear import mlp_block
    blk = state["clf_w8a8"].net.visual.blocks[0]
    xb = torch.randn(128, 197, 768, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4)
                     ).to(torch.bfloat16)
    _reset_launch_counts()
    with torch.inference_mode():
        y = mlp_block(blk["mlp"], blk["norm2"], xb, quick_gelu)
        y_plain = mlp_block(blk["mlp"], blk["norm2"], xb, quick_gelu,
                            int8_impl="plain")
        y_res = mlp_block(blk["mlp"], blk["norm2"], xb, quick_gelu,
                          residual=xb)
    torch.cuda.synchronize()
    n = _launch_counts()
    state["launches_by_kernel"]["w8a8_mlp"] = n["w8a8_mlp"]
    d = (y.float() - y_plain.float()).abs().max().item()
    # with the residual the same block is x + y, rounded once more
    d_res = (y_res.float() - (xb.float() + y.float())).abs()
    ok = (y.shape == xb.shape and bool(torch.isfinite(y).all())
          and n["w8a8_mlp"] == 1 and n["w8a8_mlp_res"] == 1
          and (y != y_plain).float().mean().item()
          <= W8A8_LIMITS["w8a8_mlp"][0]
          and bool((d_res <= bf16_ulp(y_res) + bf16_ulp(y)).all()))
    log(f"[w8-slice] mlp_block(residual=None) on the first block's w8a8 "
        f"leaves, (128, 197, 768): launches {n['w8a8_mlp']} w8a8_mlp / "
        f"{n['w8a8_mlp_res']} w8a8_mlp_res (expect 1 / 1), max |diff| vs "
        f"the plain version {d:.3e}, the residual form minus (x + y) at "
        f"most {(d_res / (bf16_ulp(y_res) + bf16_ulp(y))).max().item():.2f} "
        f"of one bf16 ulp of each {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("mlp_block(residual=None) failed its checks")

    # the two-source attention's path: its public entry point on the first
    # block's out-projection at the serving shape, keys from two arrays
    from gava_clip_tpu_torch.ops import flash_attention as fa
    g4 = torch.Generator(device="cuda").manual_seed(6)
    q, k1, v1 = (torch.randn(128, 197, 768, device="cuda", generator=g4
                             ).to(torch.bfloat16) for _ in range(3))
    k2, v2 = (torch.randn(128, 17, 768, device="cuda", generator=g4
                          ).to(torch.bfloat16) for _ in range(2))
    _reset_launch_counts()
    with torch.inference_mode():
        y2 = fa.flash_attention_out_int8_2src(q, k1, v1, k2, v2, 12,
                                              blk["attn"]["out"], xb)
        n = _launch_counts()
        y1 = fa.flash_attention_out_int8(
            q, torch.cat([k1, k2], dim=1), torch.cat([v1, v2], dim=1), 12,
            blk["attn"]["out"], xb)
        y2_plain = fa.flash_attention_out_int8_2src(
            q, k1, v1, k2, v2, 12, blk["attn"]["out"], xb, impl="plain")
    torch.cuda.synchronize()
    state["launches_by_kernel"]["attention_out_int8_2src"] = \
        n["attention_out_int8_2src"]
    diff = (y2 != y2_plain).float().mean().item()
    ok = (n["attention_out_int8_2src"] == 1 and n["attention_out_int8"] == 0
          and y2.shape == xb.shape and bool(torch.isfinite(y2).all())
          and torch.equal(y2, y1)
          and diff <= W8A8_LIMITS["attention_out_int8_2src"][0])
    log(f"[w8-slice] flash_attention_out_int8_2src on the first block's "
        f"out-projection, q / k1 / v1 (128, 197, 768), k2 / v2 (128, 17, "
        f"768): launches {n['attention_out_int8_2src']} (expect 1), equal to "
        f"flash_attention_out_int8 on the concatenation bit for bit: "
        f"{torch.equal(y2, y1)}, outputs != plain {diff:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash_attention_out_int8_2src failed its checks")


VARIANT_PER_FORWARD = {
    "fused": {"fused_extras": 12, "w8a8_matmul": 1, "w8a8_matmul3_cat": 12,
              "attention_out_int8": 12, "attention_out_int8_qk8": 0,
              "w8a8_mlp_res": 12},
    "fused + int8 QK^T": {"fused_extras": 12, "w8a8_matmul": 1,
                          "w8a8_matmul3_cat": 12, "attention_out_int8": 0,
                          "attention_out_int8_qk8": 12, "w8a8_mlp_res": 12},
}
# The fused extras replace bf16 stock ops by fp32 arithmetic: the extras
# rows move by bf16 roundings, which the tower carries on as it carries the
# roundings of the two bf16 attention paths; so the fused forward may sit as
# far from the unfused one as those sit from each other (x1.5), and within
# the plain-init limit of the w8a8 slice on the plain init. The int8 QK^T
# forward is held to its own plain-version forward the same way.


def phase_w8a8_variants(state):
    """The w8a8 + patch-major classifier with the fused prompt extras, then
    with the int8 QK^T scores as well."""
    import torch
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    clf, clips = state["clf_w8a8"], state["clips"]
    model, labels = state["model"], state["labels"]
    x = clf._prepare(clips)
    init_clf = _classifier(model, model.param_tree(), labels,
                           quantize="w8a8", patch_major=True)
    lim_path = W8A8_PATHOLOGY_FACTOR * state["d_logit_bf16_paths"]
    base = _w8a8_logits(clf, x, "kernel")
    base_init = _w8a8_logits(init_clf, x, "kernel")
    try:
        for variant, int8_qk in (("fused", False),
                                 ("fused + int8 QK^T", True)):
            ek.set_fused_extras(True)
            fa.set_int8_qk(int8_qk)
            clf.warmup()
            _reset_launch_counts()
            p16 = clf.classify_clips(clips)
            torch.cuda.synchronize()
            n16 = _launch_counts()
            p5 = clf.classify_clips(clips[:5])
            torch.cuda.synchronize()
            n_all = _launch_counts()
            per = VARIANT_PER_FORWARD[variant]
            log(f"[w8a8-variants] {variant}: launches for the 16-clip "
                f"forward {n16}, after the 5-clip forward {n_all} (expect "
                f"{per} per forward)")
            for name, want in per.items():
                if (n16[name], n_all[name]) != (want, 2 * want):
                    raise AssertionError(
                        f"{variant}: {name} {n16[name]} / {n_all[name]} "
                        f"launches, expected {want} per forward")
            by_kernel = state.setdefault("launches_by_kernel", {})
            by_kernel["fused_extras"] = by_kernel.get("fused_extras", 0) \
                + n_all["fused_extras"]
            if int8_qk:
                by_kernel["attention_out_int8_qk8"] = \
                    n_all["attention_out_int8_qk8"]
            _check_probs(f"{variant}, 16 clips", p16, 16)
            _check_probs(f"{variant}, 5 clips", p5, 5)
            d_pad = np.abs(p5 - p16[:5]).max()
            lg, lg_plain = (_w8a8_logits(clf, x, i)
                            for i in ("kernel", "plain"))
            d_path = (lg - lg_plain).abs().max().item()
            d_init = (_w8a8_logits(init_clf, x, "kernel")
                      - _w8a8_logits(init_clf, x, "plain")).abs().max().item()
            d_base = (lg - base).abs().max().item()
            d_base_init = (_w8a8_logits(init_clf, x, "kernel")
                           - base_init).abs().max().item()
            d_prob = np.abs(p16 - state["p16_bf16"]).max()
            log(f"[w8a8-variants] {variant}: max |logit diff| kernels vs "
                f"plain versions: pathology weights {d_path:.4f} (limit "
                f"{lim_path:.4f}), plain init {d_init:.4f} (limit "
                f"{W8A8_MAX_LOGIT_DIFF_INIT}); vs the unfused w8a8 forward: "
                f"pathology weights {d_base:.4f} (limit {lim_path:.4f}), "
                f"plain init {d_base_init:.4f} (limit "
                f"{W8A8_MAX_LOGIT_DIFF_INIT}); gate vs the bf16 classifier "
                f"max |prob diff| {d_prob:.4e} (limit {W8A8_PROB_GATE}); "
                f"padded vs full batch {d_pad:.2e}")
            if not bool(torch.isfinite(lg).all()) or d_path > lim_path or \
                    d_init > W8A8_MAX_LOGIT_DIFF_INIT or d_pad > 1e-3:
                raise AssertionError(f"{variant}: the kernels' forward "
                                     f"disagrees with the plain versions'")
            if d_base > lim_path or d_base_init > W8A8_MAX_LOGIT_DIFF_INIT:
                raise AssertionError(f"{variant}: too far from the unfused "
                                     f"w8a8 forward")
            if d_prob > W8A8_PROB_GATE:
                raise AssertionError(f"{variant}: fails the prob-delta gate")
            e2e, fwd_ms, lat = _serving_times(clf, clips, x)
            log(f"[w8a8-variants] {variant}, batch 16: {e2e:.1f} clips/s end "
                f"to end, device forward {fwd_ms:.2f} ms = "
                f"{16e3 / fwd_ms:.1f} clips/s (unfused w8a8 "
                f"{state['fwd_ms_w8a8']:.2f} ms in this run); batch 1 "
                f"latency p50 {lat:.2f} ms ({state['smi']})")
            if state.get("profile_dir"):
                tag = "_w8a8_int8qk" if int8_qk else "_w8a8_fused"
                _profile(lambda: clf._forward(x), 3,
                         f"batch-16 forward, {variant}", fwd_ms, state["smi"],
                         os.path.join(state["profile_dir"],
                                      f"profile_slice{tag}.txt"), tag, 25)
    finally:
        ek.set_fused_extras(False)
        fa.set_int8_qk(False)
    # both switches off again: the unfused forward, bit for bit
    if not torch.equal(_w8a8_logits(clf, x, "kernel"), base):
        raise AssertionError("the switches did not reset")
    _fused_extras_f32_forward(state, init_clf, x)


def _fused_extras_f32_forward(state, clf, x):
    """The fused extras (B10) on fp32 rows: the w8a8 + patch-major
    classifier on the plain init run in fp32 (the dtype of an fp32 run's
    evaluation), its forward with the switch on against the same forward
    with it off, within the plain-init limit that the bf16 variants keep
    (B10 replaces the stock extras ops by fp32 arithmetic in another order:
    in fp32 neither side rounds to bf16); 12 B10 launches a forward, beside
    the fp32 forms of B3, B4 and B5."""
    import torch
    from gava_clip_tpu_torch.ops import extras_kernel as ek

    def logits():
        with torch.inference_mode():
            return clf.net(x.to(torch.float32), compute_dtype=torch.float32,
                           attn_impl="flash", input_format="patches")["logits"]

    base = logits()
    ek.set_fused_extras(True)
    try:
        _reset_launch_counts()
        fused = logits()
        torch.cuda.synchronize()
        n = _launch_counts()
    finally:
        ek.set_fused_extras(False)
    want = {"fused_extras": 12, "w8a8_matmul3_cat_f32": 12,
            "attention_out_int8_f32": 12, "w8a8_mlp_res_f32": 12,
            "w8a8_matmul3_cat": 0, "attention_out_int8": 0}
    d = (fused - base).abs().max().item()
    ok = (fused.dtype == torch.float32 and bool(torch.isfinite(fused).all())
          and d <= W8A8_MAX_LOGIT_DIFF_INIT
          and all(n[k] == v for k, v in want.items()))
    log(f"[w8a8-variants] fused extras on fp32 rows (plain init, batch 16): "
        f"launches { {k: n[k] for k in want} } (expect {want}); max |logit "
        f"diff| against the unfused fp32 forward {d:.3e} (limit "
        f"{W8A8_MAX_LOGIT_DIFF_INIT}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("the fused extras on fp32 rows failed their "
                             "checks")


# ---------------------------------------------------------------------------
# the training and evaluation programs
# ---------------------------------------------------------------------------

# launches per step under set_flash_bwd_mode("recompute"): the forward that
# writes no denominators and the backward that rebuilds them, 12 blocks each
RECOMPUTE_PER_STEP = {"packed_attention": 12,
                      "packed_attention_bwd_recompute": 12,
                      "packed_attention_den": 0, "packed_attention_bwd": 0,
                      "streaming_attention": 12,
                      "streaming_attention_bwd": 12}
RECOMPUTE_STEPS = 3


def _loss_and_grads(state):
    """One loss + backward of the train-slice model on its fixed batch (no
    update): (loss, gradient leaves, launch counts)."""
    import torch
    ts, loss_fn = state["train_state"], state["train_loss_fn"]
    ts.optimizer.zero_grad(set_to_none=True)
    _reset_launch_counts()
    total, _ = loss_fn(ts.trainable, ts.frozen, state["train_batch"])
    total.backward()
    torch.cuda.synchronize()
    grads = _grad_list(ts.trainable)
    ts.optimizer.zero_grad(set_to_none=True)
    return total.item(), grads, _launch_counts()


def phase_train_recompute(state):
    """The training step with the backward that saves no forward output."""
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    ts, step, batch = (state[k] for k in ("train_state", "train_step",
                                          "train_batch"))
    loss_s, g_s, _ = _loss_and_grads(state)
    try:
        fa.set_flash_bwd_mode("recompute")
        loss_r, g_r, n_r = _loss_and_grads(state)
        fa.set_flash_bwd_mode("saved")
        loss_s2, g_s2, n_s2 = _loss_and_grads(state)
        fa.set_flash_bwd_mode("recompute")
        d_loss = abs(loss_r - loss_s)
        scale = max(g.norm().item() for g in g_s)
        rel = [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
               for a, b in zip(g_r, g_s)]
        back = loss_s2 == loss_s and all(torch.equal(a, b)
                                         for a, b in zip(g_s2, g_s))
        log(f"[train-recompute] first step, recompute vs saved mode: total "
            f"{loss_r:.6f} vs {loss_s:.6f} (diff {d_loss:.2e}, limit "
            f"{TRAIN_MAX_LOSS_DIFF:g}); gradient leaves {len(rel)}, max "
            f"relative L2 error {max(rel):.3e}, median "
            f"{float(np.median(rel)):.3e} (limit {TRAIN_MAX_GRAD_REL_ERR:g}); "
            f"launches {n_r}; back in saved mode the loss and every gradient "
            f"equal the first pass bit for bit: {back}")
        if d_loss > TRAIN_MAX_LOSS_DIFF or max(rel) > TRAIN_MAX_GRAD_REL_ERR \
                or not back or \
                any(n_r[k] != v for k, v in RECOMPUTE_PER_STEP.items()) or \
                any(n_s2[k] != v for k, v in TRAIN_PER_STEP.items()):
            raise AssertionError("the recompute mode failed its checks")
        del g_s, g_r, g_s2
        _reset_launch_counts()
        totals, dev_ms = [], []
        for _ in range(RECOMPUTE_STEPS):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ts, metrics = step(ts, batch)
            ev[1].record()
            totals.append(metrics["total"].item())
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        counts = _launch_counts()
    finally:
        fa.set_flash_bwd_mode("saved")
    state.setdefault("launches_by_kernel", {})[
        "packed_attention_bwd_recompute"] = \
        counts["packed_attention_bwd_recompute"]
    log(f"[train-recompute] {RECOMPUTE_STEPS} steps: total "
        f"{[round(t, 4) for t in totals]}; launches {counts} (expect "
        f"{RECOMPUTE_PER_STEP} per step); step by CUDA events "
        f"{[round(t, 1) for t in dev_ms]} ms (saved mode "
        f"{state['train_ms']:.2f} ms) ({state['smi']})")
    if not all(np.isfinite(totals)) or any(
            counts[k] != v * RECOMPUTE_STEPS
            for k, v in RECOMPUTE_PER_STEP.items()):
        raise AssertionError("the recompute-mode steps failed their checks")
    # one more saved-mode step: the default path is back
    _reset_launch_counts()
    ts, metrics = step(ts, batch)
    torch.cuda.synchronize()
    counts = _launch_counts()
    if any(counts[k] != v for k, v in TRAIN_PER_STEP.items()):
        raise AssertionError(f"after the reset: launches {counts}")


# the fp32 step (no --use_bf16): the float32 attention kernels, 12 vision
# blocks (B6a forward, B6b backward) and 12 text blocks (B7 forward and
# backward) a step, and no bf16 attention kernel
F32_PER_STEP = {"packed_attention_den_f32": 12, "packed_attention_bwd_f32": 12,
                "streaming_attention_f32": 12,
                "streaming_attention_bwd_f32": 12, "packed_attention_f32": 0,
                "packed_attention_den": 0, "packed_attention_bwd": 0,
                "streaming_attention": 0, "streaming_attention_bwd": 0}
# under set_flash_bwd_mode("recompute"): B1 and B8 in fp32
F32_RECOMPUTE_PER_STEP = dict(F32_PER_STEP, packed_attention_f32=12,
                              packed_attention_bwd_recompute_f32=12,
                              packed_attention_den_f32=0,
                              packed_attention_bwd_f32=0)
F32_STEP_TURNS = 2
# The first fp32 step through the kernels against the same step through the
# plain versions on the card: each attention output and gradient differs by
# at most 2^-14 of its scale (F32_REL; measured ~1e-6), where the bf16 step
# differs by whole bf16 roundings (TRAIN_MAX_*: 2e-2 / 0.1). 24 blocks and
# the heads carry that on, so the limits are 20 and 10 times tighter than
# the bf16 step's; a wrong kernel moves the loss and the leaves by their
# whole scale.
F32_STEP_MAX_LOSS_DIFF = 1e-3
F32_STEP_MAX_GRAD_REL_ERR = 1e-2
# the recompute mode in fp32 rebuilds o and den with the forward kernel
# that wrote them in the saved mode, and remat="save_attn" rebuilds a block
# around the kept o and den (the replay Function, no forward launch), so
# the gradients of both equal the saved mode's without remat up to the
# order of sums outside the attention (measured: equal)
F32_REBUILT_MAX_REL_L2 = 1e-6


def phase_train_f32(state):
    """The train-slice step in fp32 (compute_dtype float32, the fp32
    attention kernels): the first step's loss and gradients against the
    same step through the plain versions on the card, the launches per step,
    the recompute mode's step (B1 and B8 in fp32) and the step under
    remat="save_attn" (the kept fp32 o and den) against the saved mode's,
    then fp32 and bf16 steps in turns: ms/step, peak GiB, finite losses.
    These steps start from the weights train-slice left, near the fixed
    batch's minimum, where the loss no longer falls step by step: the
    driver phase's fp32 cli.train run, from the initial weights, holds
    that."""
    import contextlib
    import torch
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.train.step import make_loss_fn, make_train_step
    model, loss_cfg, opt = (state[k] for k in ("train_model", "train_cfg",
                                              "train_opt"))
    ts, batch, step16 = (state[k] for k in ("train_state", "train_batch",
                                            "train_step"))
    kw = dict(compute_dtype=torch.float32, attn_impl="flash")
    loss_fn = make_loss_fn(model, loss_cfg, remat="none", **kw)

    def loss_and_grads(plain=False, fn=loss_fn):
        ts.optimizer.zero_grad(set_to_none=True)
        _reset_launch_counts()
        with fa.plain_versions() if plain else contextlib.nullcontext():
            total, _ = fn(ts.trainable, ts.frozen, batch)
            total.backward()
        torch.cuda.synchronize()
        grads = _grad_list(ts.trainable)
        ts.optimizer.zero_grad(set_to_none=True)
        return total.item(), grads, _launch_counts()

    def rel_l2(got, want):
        scale = max(g.norm().item() for g in want)
        return [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
                for a, b in zip(got, want)]

    loss_p, g_p, _ = loss_and_grads(plain=True)
    loss_k, g_k, n_k = loss_and_grads()
    rel = rel_l2(g_k, g_p)
    worst = [n for n, _ in _named_leaves(ts.trainable)][int(np.argmax(rel))]
    log(f"[train-f32] first fp32 step, kernels vs plain versions on the card: "
        f"total {loss_k:.7f} vs {loss_p:.7f} (diff {abs(loss_k - loss_p):.2e}, "
        f"limit {F32_STEP_MAX_LOSS_DIFF:g}); gradient leaves {len(rel)}, max "
        f"relative L2 error {max(rel):.3e} ({worst}), median "
        f"{float(np.median(rel)):.3e} (limit {F32_STEP_MAX_GRAD_REL_ERR:g}); "
        f"launches {n_k}")
    if not all(bool(torch.isfinite(g).all()) for g in g_k) or \
            abs(loss_k - loss_p) > F32_STEP_MAX_LOSS_DIFF or \
            max(rel) > F32_STEP_MAX_GRAD_REL_ERR or \
            any(n_k[k] != v for k, v in F32_PER_STEP.items()):
        raise AssertionError("the fp32 step through the kernels disagrees "
                             "with the plain versions")
    del g_p
    try:
        fa.set_flash_bwd_mode("recompute")
        loss_r, g_r, n_r = loss_and_grads()
    finally:
        fa.set_flash_bwd_mode("saved")
    loss_a, g_a, n_a = loss_and_grads(fn=make_loss_fn(
        model, loss_cfg, remat="save_attn", **kw))
    for what, loss_x, g_x, n_x, want in (
            ("the recompute mode", loss_r, g_r, n_r, F32_RECOMPUTE_PER_STEP),
            ('remat="save_attn"', loss_a, g_a, n_a, F32_PER_STEP)):
        rel_x = rel_l2(g_x, g_k)
        equal = loss_x == loss_k and all(torch.equal(a, b)
                                         for a, b in zip(g_x, g_k))
        log(f"[train-f32] {what}: the fp32 step vs the saved mode's without "
            f"remat: total {loss_x:.7f} vs {loss_k:.7f}, max relative L2 "
            f"{max(rel_x):.3e} (limit {F32_REBUILT_MAX_REL_L2:g}), equal bit "
            f"for bit: {equal}; launches {n_x}")
        if max(rel_x) > F32_REBUILT_MAX_REL_L2 or \
                any(n_x[k] != v for k, v in want.items()):
            raise AssertionError(f"the fp32 step under {what} failed its "
                                 f"checks")
    by_kernel = state.setdefault("launches_by_kernel", {})
    for name in ("packed_attention_den_f32", "packed_attention_bwd_f32",
                 "streaming_attention_f32", "streaming_attention_bwd_f32"):
        by_kernel[name] = n_k[name]
    by_kernel["packed_attention_bwd_recompute_f32"] = \
        n_r["packed_attention_bwd_recompute_f32"]
    del g_k, g_r, g_a

    step32 = make_train_step(model, loss_cfg, opt, remat="none", **kw)
    first_step = ts.step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts, metrics = step32(ts, batch)          # the first fp32 step: warm-up
    totals = [metrics["total"].item()]
    peak32 = torch.cuda.max_memory_allocated() / 2 ** 30
    ms = {"fp32": [], "bf16": []}
    _reset_launch_counts()
    for which in ("fp32", "bf16", "bf16", "fp32") * F32_STEP_TURNS:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ts, metrics = (step32 if which == "fp32" else step16)(ts, batch)
        ev[1].record()
        total = metrics["total"].item()
        if which == "fp32":
            totals.append(total)
        ms[which].append(ev[0].elapsed_time(ev[1]))
    counts = _launch_counts()
    state["train_state"] = ts
    n32 = len(ms["fp32"])
    log(f"[train-f32] fp32 and bf16 steps in turns (fp32, bf16, bf16, fp32; "
        f"x{F32_STEP_TURNS}): fp32 {[round(t, 2) for t in ms['fp32']]} ms "
        f"(median {np.median(ms['fp32']):.2f}), bf16 "
        f"{[round(t, 2) for t in ms['bf16']]} ms (median "
        f"{np.median(ms['bf16']):.2f}), ratio "
        f"{np.median(ms['fp32']) / np.median(ms['bf16']):.3f}; peak memory "
        f"over the first fp32 step {peak32:.2f} GiB (the bf16 step's "
        f"{state['train_peak']:.2f} GiB in train-slice); fp32 total loss "
        f"{[round(t, 4) for t in totals]}; launches {counts} "
        f"({state['smi']})")
    if not all(np.isfinite(totals)) or \
            ts.step != first_step + 1 + 2 * n32 or any(
                counts[k] != v * n32 for k, v in F32_PER_STEP.items()
                if k.endswith("_f32")):
        raise AssertionError("the fp32 steps failed their checks")
    state.update(train_f32_ms=float(np.median(ms["fp32"])),
                 train_f32_peak=peak32)


# ---------------------------------------------------------------------------
# int8-forward training (--int8_frozen): the straight-through ops B3a, B2
# and B5 at the shapes of the flagship's training step, the step itself at
# 16 x 8 and 4 x 70 beside the bf16 step, and cli.train --int8_frozen
# ---------------------------------------------------------------------------

# (M, K, N): B2 at the vision out-projection (16 clips x 8 frames x 197
# query rows) and at the text tower's out-projection / q / k / v, fc1 and
# fc2 (15 prompts x 77 tokens)
INT8_TRAIN_B2_SHAPES = ((25216, 768, 768), (1155, 512, 512),
                        (1155, 512, 2048), (1155, 2048, 512))
# B3a: LN1 + q / k / v over the 27,392 kv rows (197 + 17 prompt rows a
# frame row); B5: LN2 + MLP + residual over the 25,216 query rows
INT8_TRAIN_B3A_SHAPE = (27392, 768, 768)
INT8_TRAIN_B5_SHAPE = (25216, 768, 3072, 768)
# dx of each straight-through op through its kernel against autograd
# through the float block (fp32) on the dequantized weights, relative L2
# error. The op rounds to bf16 where the float block does not: the
# dequantized weight (values and scales cast first), each bf16 product's
# output, and for B5 the recomputed LN2 output, fc1 product and dh, each
# 2^-9 of a value. Measured on the CPU at 1,024 rows of these widths:
# 2.8e-3 (B2), 3.9e-3 (B3a), 5.2e-3 (B5). A dx without the LayerNorm's mean
# terms, or through W instead of W^T, is off by its whole norm.
INT8_TRAIN_DX_REL_ERR = 2e-2
# launches of one step of the flagship at 16 x 8 with frozen_int8, remat
# none: the attention kernels of the bf16 step, and in the 12 vision blocks
# one B3a (LN1 + q/k/v), one B2 (the out-projection) and one B5 (LN2 + MLP
# + residual), in the 12 text blocks six B2 (q, k, v, out, fc1, fc2)
INT8_TRAIN_PER_STEP = dict(TRAIN_PER_STEP, w8a8_matmul3=12,
                           w8a8_matmul=12 + 72, w8a8_mlp_res=12)
INT8_TRAIN_KERNELS = ("w8a8_matmul3", "w8a8_matmul", "w8a8_mlp_res")
# the same step in fp32 (no --use_bf16): the fp32 attention kernels of the
# fp32 step and the fp32 forms of B3a, B2 and B5; no bf16 w8a8 or
# attention entry
INT8_F32_PER_STEP = dict(F32_PER_STEP, w8a8_matmul3_f32=12,
                         w8a8_matmul_f32=12 + 72, w8a8_mlp_res_f32=12,
                         w8a8_matmul3=0, w8a8_matmul=0, w8a8_mlp_res=0)
INT8_F32_KERNELS = ("w8a8_matmul3_f32", "w8a8_matmul_f32", "w8a8_mlp_res_f32")
# The first fp32 step with frozen_int8 against the same step through the
# plain versions: both take the same int8 codes except where one flips at a
# rounding tie (w8a8-f32: ~1% of B3a's rows, ~3% of B5's), and a flip moves
# its row by up to a flip unit. The loss keeps the fp32 step's limit
# (F32_STEP_MAX_LOSS_DIFF; measured 1.03e-4). A leaf that reads few rows
# carries a flip's whole effect (the last block's summary attention
# kernels: 3.17e-2, where the bf16 int8 step shows 4.17e-2; measured on an
# H100, NVIDIA H100 80GB HBM3, 700.00 W),
# so the largest leaf takes the int8 step's limit (TRAIN_MAX_GRAD_REL_ERR)
# and the median leaf is held to 1e-3 (measured 2.3e-4; 5.8e-8 in the fp32
# step without int8). A wrong kernel moves every leaf by its whole scale.
INT8_F32_STEP_MAX_LOSS_DIFF = F32_STEP_MAX_LOSS_DIFF
INT8_F32_STEP_MAX_GRAD_REL_ERR = TRAIN_MAX_GRAD_REL_ERR
INT8_F32_STEP_MAX_MEDIAN_GRAD_REL_ERR = 1e-3
# under any remat policy the straight-through ops of each vision block run
# again in the backward (their custom autograd functions are opaque to the
# policies, as the JAX ones are to jax.checkpoint's names: see
# models/vision._block_remat); the attention forward runs again under full
INT8_REMAT_PER_STEP = {
    policy: dict(INT8_TRAIN_PER_STEP, w8a8_matmul3=24, w8a8_matmul=24 + 72,
                 w8a8_mlp_res=24,
                 packed_attention_den=24 if policy == "full" else 12)
    for policy in ("save_attn_qkv", "full")}
INT8_CLI_STEPS = 8


def _qtleaf(gen, K, N):
    """A frozen-training leaf {'qt', 'scale', 'qt_t'} from _qleaf's draw."""
    leaf = _qleaf(gen, K, N)
    return {"qt": leaf["qa"], "scale": leaf["scale"], "qt_t": leaf["qa_t"]}


def _int8_train_op(state, name, label, run, inputs, cots, float_ref,
                   unit, bound):
    """One straight-through op at a training shape: its forward through
    the kernel (one launch) against the plain forward, its dx through the
    kernel path against the plain path's (bit for bit) and against autograd
    through the float block (`float_ref`: fp32 dx), the kernel and plain
    forwards timed in turns and the backward timed."""
    import torch
    _reset_launch_counts()
    outs = run("kernel")
    torch.cuda.synchronize()
    launches = _launch_counts()[name]
    refs = run("plain")
    if name == "w8a8_matmul":
        ok = all(torch.equal(o, r) for o, r in zip(outs, refs))
        err = max((o.float() - r.float()).abs().max().item()
                  for o, r in zip(outs, refs))
        text = f"bit-equal {ok}"
    else:
        lim = "w8a8_matmul3_cat" if name == "w8a8_matmul3" else name
        checks = [_check_w8a8(lim, o.detach(), r.detach(), u)
                  for o, r, u in zip(outs, refs, unit)]
        ok = all(c[0] for c in checks)
        err = max(c[1] for c in checks)
        text = "; ".join(c[2] for c in checks[:1]) + \
            f" (limits {W8A8_LIMITS[lim]})"
    dk = torch.autograd.grad(outs, inputs, cots, retain_graph=True)
    dp = torch.autograd.grad(refs, inputs, cots)
    same = all(torch.equal(a, b) for a, b in zip(dk, dp))
    rel = max(((a.float() - r).norm() / r.norm()).item()
              for a, r in zip(dk, float_ref()))
    ok = ok and same and launches == 1 and rel <= INT8_TRAIN_DX_REL_ERR

    def fwd(impl):
        def call():
            with torch.no_grad():
                run(impl)
        return call
    ms, plain_ms, t = _time_pair(fwd("kernel"), fwd("plain"))
    bwd_ms = cuda_time_ms(lambda: torch.autograd.grad(
        outs, inputs, cots, retain_graph=True), iters=10)
    log(f"[int8-train] {name} {label}: forward one launch ({launches}); "
        f"{text}; dx kernel path == plain path bit for bit: {same}; dx vs "
        f"autograd through the float block relative L2 {rel:.3e} (limit "
        f"{INT8_TRAIN_DX_REL_ERR:g}) {'ok' if ok else 'FAIL'}; forward "
        f"kernel {t['kernel']} ms, plain {t['plain']} ms (order plain, "
        f"kernel, kernel, plain), bound {bound[0]:.4f} ms ({bound[1]}); "
        f"backward (stock products) {bwd_ms:.4f} ms ({state['smi']})")
    if not ok:
        state.setdefault("int8_failures", []).append(f"{name} {label}")
    state["kstats"][name].setdefault("int8_train", {"shapes": []})[
        "shapes"].append({"shape": label, "max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound[0],
                          "bound_by": bound[1], "backward_ms": bwd_ms,
                          "dx_rel_err": rel})


def _int8_train_ops(state):
    import torch
    import torch.nn.functional as F
    from gava_clip_tpu_torch.ops import int8_matmul as im
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(bf)

    def deq(leaf):
        return leaf["qt"].float() * leaf["scale"]

    def grad32(fn, inputs, cots):
        xs = [x.detach().float().requires_grad_() for x in inputs]
        return torch.autograd.grad(fn(*xs), xs, [c.float() for c in cots])

    for M, K, N in INT8_TRAIN_B2_SHAPES:
        x = randn(M, K).requires_grad_()
        leaf = _qtleaf(gen, K, N)
        b = torch.randn(N, generator=gen, device="cuda") * 0.1
        g = randn(M, N)
        _int8_train_op(
            state, "w8a8_matmul", f"M={M} K={K} N={N}",
            lambda impl: (im.int8_linear_st(x, leaf, b, impl=impl),),
            [x], [g], lambda: grad32(lambda a: a @ deq(leaf) + b, [x], [g]),
            None, _bound(2 * M * K + K * N + 8 * N + 2 * M * N,
                         ops_int8=2 * M * K * N))
    M, K, N = INT8_TRAIN_B3A_SHAPE
    x = randn(M, K).requires_grad_()
    k3 = [_qtleaf(gen, K, N) for _ in range(3)]
    b3 = [torch.randn(N, generator=gen, device="cuda") * 0.1
          for _ in range(3)]
    ln = _ln_params(gen, K)
    gs = [randn(M, N) for _ in range(3)]
    xs = im.quant_rows(im.ln_f32(x.detach().float(), *ln))[1]
    _int8_train_op(
        state, "w8a8_matmul3", f"M={M} K={K} N=3x{N} with LN1",
        lambda impl: im.int8_qkv3_st(x, k3, b3, ln, impl=impl), [x], gs,
        lambda: grad32(lambda a: [F.layer_norm(a, (K,), *ln) @ deq(k) + bb
                                  for k, bb in zip(k3, b3)], [x], gs),
        [_flip_unit(xs, k["scale"]) for k in k3],
        _bound(M * (2 * K + 6 * N) + 3 * K * N + 24 * N + 8 * K,
               ops_int8=6 * M * K * N))
    M, K, H, N = INT8_TRAIN_B5_SHAPE
    x, r = randn(M, K).requires_grad_(), randn(M, N).requires_grad_()
    fc1 = {"kernel": _qtleaf(gen, K, H),
           "bias": torch.randn(H, generator=gen, device="cuda") * 0.02}
    fc2 = {"kernel": _qtleaf(gen, H, N),
           "bias": torch.randn(N, generator=gen, device="cuda") * 0.02}
    ln = _ln_params(gen, K)
    g = randn(M, N)
    codes, xs = im.quant_rows(im.ln_f32(x.detach().float(), *ln))
    h = im.quick_gelu_f32(im.rescale(im.int_matmul(codes, fc1["kernel"]["qt"]),
                                     xs, fc1["kernel"]["scale"], fc1["bias"]))
    unit = _flip_unit(im.quant_rows(h)[1], fc2["kernel"]["scale"])
    del codes, h

    def mlp32(a, res):
        hh = F.layer_norm(a, (K,), *ln) @ deq(fc1["kernel"]) + fc1["bias"]
        return hh * torch.sigmoid(1.702 * hh) @ deq(fc2["kernel"]) + \
            fc2["bias"] + res
    _int8_train_op(
        state, "w8a8_mlp_res", f"M={M} K={K} H={H} N={N} with LN2 and the "
        f"residual",
        lambda impl: (im.int8_mlp_st(x, fc1, fc2, ln, r, impl=impl),),
        [x, r], [g], lambda: grad32(mlp32, [x, r], [g]), [unit],
        _bound(2 * M * K + 4 * M * N + K * H + H * N + 8 * (H + N) + 8 * K,
               ops_int8=2 * M * K * H + 2 * M * H * N))
    # fp32 rows take the fp32 forms (held at these shapes in w8a8-f32): one
    # counted launch of each, an fp32 output, no cast; fp16 rows raise
    rows32 = torch.randn(64, K, generator=gen, device="cuda")
    for label, name, call in (
            ("int8_linear_st", "w8a8_matmul_f32",
             lambda a, impl="kernel": im.int8_linear_st(
                 a, fc1["kernel"], fc1["bias"], impl=impl)),
            ("int8_qkv3_st", "w8a8_matmul3_f32",
             lambda a, impl="kernel": im.int8_qkv3_st(a, k3, b3, ln,
                                                      impl=impl)),
            ("int8_mlp_st", "w8a8_mlp_res_f32",
             lambda a, impl="kernel": im.int8_mlp_st(a, fc1, fc2, ln, a,
                                                     impl=impl))):
        a = rows32.clone().requires_grad_()
        _reset_launch_counts()
        out = call(a)
        torch.cuda.synchronize()
        n = _launch_counts()
        outs = out if isinstance(out, tuple) else (out,)
        ref = call(a, "plain")
        refs = ref if isinstance(ref, tuple) else (ref,)
        cots = [torch.randn(o.shape, generator=gen, device="cuda")
                for o in outs]
        same = all(torch.equal(x, y) for x, y in zip(
            torch.autograd.grad(outs, a, cots),
            torch.autograd.grad(refs, a, cots)))
        ok = n[name] == 1 and sum(n[k] for k in INT8_TRAIN_KERNELS) == 0 \
            and same and all(o.dtype == torch.float32
                             and bool(torch.isfinite(o).all()) for o in outs)
        try:
            call(rows32.half())
            ok = False
        except TypeError:
            pass
        log(f"[int8-train] {label} on fp32 rows: one {name} launch "
            f"({n[name]}), fp32 out; dx kernel path == plain path bit for "
            f"bit: {same}; fp16 rows raise TypeError "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            state.setdefault("int8_failures", []).append(f"{label} fp32")
    if state.get("int8_failures"):
        raise AssertionError(f"the straight-through ops failed: "
                             f"{state['int8_failures']}")


def _timed_steps(step, ts, batch, n):
    """n steps: (losses, CUDA-event ms, (peak GiB over the resting memory,
    peak GiB allocated in all, resting GiB))."""
    import torch
    torch.cuda.synchronize()
    rest = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    losses, ms = [], []
    for _ in range(n):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ts, metrics = step(ts, batch)
        ev[1].record()
        losses.append(metrics["total"].item())     # waits for the step
        ms.append(ev[0].elapsed_time(ev[1]))
    peak = torch.cuda.max_memory_allocated()
    return losses, ms, ((peak - rest) / 2 ** 30, peak / 2 ** 30,
                        rest / 2 ** 30)


def _int8_flagship_step(state, dtype=None):
    """The flagship's step at 16 x 8 with frozen_int8 in `dtype` (bf16, or
    fp32: the w8a8 kernels' fp32 forms): the first step against the plain
    versions, 6 steps beside the step without int8 of the same dtype in
    turns."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.ops import flash_attention as fa
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer, tree_leaves)
    from gava_clip_tpu_torch.train.step import (LossConfig, make_loss_fn,
                                                make_train_step,
                                                quantize_frozen)
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    # the float step beside the int8 one, the limits of the first step
    # against the plain versions, the launches a step, the state's keys
    tag = "fp32" if f32 else "bf16"
    max_loss, max_grad, max_median = (
        INT8_F32_STEP_MAX_LOSS_DIFF, INT8_F32_STEP_MAX_GRAD_REL_ERR,
        INT8_F32_STEP_MAX_MEDIAN_GRAD_REL_ERR) if f32 else (
        TRAIN_MAX_LOSS_DIFF, TRAIN_MAX_GRAD_REL_ERR, 1.0)
    per_step = INT8_F32_PER_STEP if f32 else INT8_TRAIN_PER_STEP
    key = "_f32" if f32 else ""
    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    opt = make_optimizer(lr=1e-3, num_steps=2000, weight_decay=0.2)
    kw = dict(compute_dtype=dtype, attn_impl="flash", remat="none")
    model = build_flagship(num_frames=8)
    mask = trainable_mask(model.params, model.cfg)
    ts8, ts16 = (create_train_state(model.params, mask, opt)
                 for _ in range(2))
    batch = _train_batch(16, 8)

    # the frozen tree quantized once, as the loss does, and then again:
    # the first call pays the first use of its torch ops and the
    # allocator's new blocks
    quant_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        q = quantize_frozen(ts8.frozen)
        torch.cuda.synchronize()
        quant_ms.append((time.perf_counter() - t0) * 1e3)
    n_qt = sum(1 for leaf in tree_leaves(q) if leaf is not None and
               leaf.dtype == torch.int8) // 2       # codes and W^T
    # what the cached tree holds beside the float frozen tree it shares
    shared = {id(p) for p in tree_leaves(ts8.frozen)}
    qt_gib = sum(leaf.numel() * leaf.element_size()
                 for leaf in tree_leaves(q) if leaf is not None and
                 id(leaf) not in shared) / 2 ** 30
    del q
    loss_k = make_loss_fn(model, loss_cfg, frozen_int8=True, **kw)
    loss_p = make_loss_fn(model, loss_cfg, frozen_int8=True,
                          int8_impl="plain", **kw)
    with fa.plain_versions():
        total_p, _ = loss_p(ts8.trainable, ts8.frozen, batch)
        total_p.backward()
    g_plain = _grad_list(ts8.trainable)
    ts8.optimizer.zero_grad(set_to_none=True)
    _reset_launch_counts()
    total_k, _ = loss_k(ts8.trainable, ts8.frozen, batch)
    total_k.backward()
    torch.cuda.synchronize()
    counts = _launch_counts()
    g_kernel = _grad_list(ts8.trainable)
    ts8.optimizer.zero_grad(set_to_none=True)
    d_loss = abs(total_k.item() - total_p.item())
    scale = max(g.norm().item() for g in g_plain)
    rel = [((a - b).norm() / b.norm().clamp_min(1e-3 * scale)).item()
           for a, b in zip(g_kernel, g_plain)]
    worst = [n for n, _ in _named_leaves(ts8.trainable)][int(np.argmax(rel))]
    log(f"[int8-train] {tag}: {n_qt} frozen projections quantized to 'qt' "
        f"leaves (with the kernels' W^T; {qt_gib:.3f} GiB beside the float "
        f"frozen tree) in {quant_ms[0]:.1f} ms by the host clock, "
        f"{quant_ms[1]:.1f} ms when done again; the loss quantizes once per "
        f"run; first {tag} step with frozen_int8, kernels vs plain "
        f"versions on the card: total {total_k.item():.6f} vs "
        f"{total_p.item():.6f} (diff {d_loss:.2e}, limit "
        f"{max_loss:g}); gradient leaves {len(rel)}, max "
        f"relative L2 error {max(rel):.3e} ({worst}) (limit {max_grad:g}), "
        f"median {float(np.median(rel)):.3e} (limit {max_median:g}); "
        f"launches {counts}")
    if any(counts[k] != v for k, v in per_step.items()) or \
            not all(bool(torch.isfinite(g).all()) for g in g_kernel) or \
            d_loss > max_loss or max(rel) > max_grad or \
            float(np.median(rel)) > max_median:
        raise AssertionError(f"the {tag} int8 training step through the "
                             f"kernels disagrees with the plain versions "
                             f"(launches {counts}, expected {per_step})")
    del g_plain, g_kernel, loss_k, loss_p       # and their cached trees

    step8 = make_train_step(model, loss_cfg, opt, frozen_int8=True, **kw)
    step16 = make_train_step(model, loss_cfg, opt, **kw)
    frozen = [p for p in tree_leaves(ts8.frozen) if p is not None]
    before_f = [p.detach().clone() for p in frozen]
    before_t = [p.detach().clone() for _, p in _named_leaves(ts8.trainable)]
    # one warm-up step each (the allocator's first blocks, cuBLAS's first
    # plans), then in turns: float, int8, int8, float, three times; the main
    # path's launches are those of the 6 int8 steps in turns
    step16(ts16, batch)
    step8(ts8, batch)
    runs = {"bf16": ([], [], []), "int8": ([], [], [])}
    launches = {k: 0 for k in per_step}
    for which in ("bf16", "int8", "int8", "bf16") * 3:
        _reset_launch_counts()
        losses, ms, peak = _timed_steps(
            *((step8, ts8) if which == "int8" else (step16, ts16)), batch, 1)
        if which == "int8":
            n = _launch_counts()
            launches = {k: launches[k] + n[k] for k in launches}
        for acc, v in zip(runs[which], (losses, ms, [peak])):
            acc.extend(v)
    (l8, ms8, pk8), (l16, ms16, pk16) = runs["int8"], runs["bf16"]
    # the largest of each memory figure over the three turns of each step
    pk8, pk16 = (tuple(max(p[i] for p in pk) for i in range(3))
                 for pk in (pk8, pk16))
    gap = max(abs(a - b) for a, b in zip(l8, l16))
    state["int8_launches" + key] = launches
    moved = sum(not torch.equal(a, b) for a, (_, b) in
                zip(before_t, _named_leaves(ts8.trainable)))
    log(f"[int8-train] 16 x 8, {tag}, flash, remat none, after a warm-up "
        f"step each 6 steps each in turns ({tag}, int8, int8, {tag}): int8 "
        f"total "
        f"{[round(t, 4) for t in l8]}, {tag} {[round(t, 4) for t in l16]}, "
        f"largest int8 - {tag} gap "
        f"{gap:.4f} (no gate on the card); step by CUDA events int8 "
        f"{[round(t, 2) for t in ms8]} ms (median "
        f"{np.median(ms8):.2f}), {tag} {[round(t, 2) for t in ms16]} "
        f"(median {np.median(ms16):.2f}); peak memory over the resting "
        f"int8 {pk8[0]:.2f} GiB, {tag} {pk16[0]:.2f} GiB; peak allocated in "
        f"all int8 {pk8[1]:.2f} GiB, {tag} {pk16[1]:.2f} GiB, resting int8 "
        f"{pk8[2]:.2f}, {tag} {pk16[2]:.2f} GiB (the process holds both "
        f"steps' states, and the int8 step its cached tree); int8 launches "
        f"over 6 steps {launches} (expect {per_step} per step); "
        f"{moved} of {len(before_t)} trainable leaves moved "
        f"({state['smi']})")
    if any(launches[k] != 6 * v for k, v in per_step.items()):
        raise AssertionError(f"{tag} int8 step launches")
    if not all(np.isfinite(l8)) or not l8[-1] < l8[0] < total_k.item():
        raise AssertionError(f"the int8 loss did not fall: {l8}")
    if not all(torch.equal(a, b) for a, b in zip(frozen, before_f)):
        raise AssertionError("a frozen leaf changed in the int8 steps")
    state["int8_step" + key] = {"int8_ms": float(np.median(ms8)),
                          "bf16_ms": float(np.median(ms16)),
                          "int8_peak_gib": pk8[0],
                          "bf16_peak_gib": pk16[0],
                          "int8_peak_abs_gib": pk8[1],
                          "bf16_peak_abs_gib": pk16[1],
                          "qt_tree_gib": qt_gib, "max_loss_gap": gap,
                          "quantize_ms": quant_ms}
    if state.get("profile_dir") and not f32:
        _profile(lambda: step8(ts8, batch), 2,
                 "batch-16 training step with frozen_int8",
                 state["int8_step"]["int8_ms"], state["smi"],
                 os.path.join(state["profile_dir"], "profile_train_int8.txt"),
                 "_int8", 40)


def _int8_long_steps(state):
    """4 clips x 70 frames under remat save_attn_qkv (cli.train's choice)
    and full: 2 steps each with and without frozen_int8."""
    import torch
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from gava_clip_tpu_torch.train.step import LossConfig, make_train_step
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    torch.cuda.empty_cache()
    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    opt = make_optimizer(lr=5e-6, num_steps=2000, weight_decay=0.2)
    model = build_flagship(num_frames=70)
    ts = create_train_state(model.params,
                            trainable_mask(model.params, model.cfg), opt)
    batch = _train_batch(4, 70)
    for policy, want in INT8_REMAT_PER_STEP.items():
        for int8 in (False, True):
            step = make_train_step(model, loss_cfg, opt, remat=policy,
                                   compute_dtype=torch.bfloat16,
                                   attn_impl="flash", frozen_int8=int8)
            ts, _ = step(ts, batch)                 # warm-up
            _reset_launch_counts()
            losses, ms, peak = _timed_steps(step, ts, batch, 2)
            n = _launch_counts()
            expect = want if int8 else dict(
                TRAIN_PER_STEP, **{k: 0 for k in INT8_TRAIN_KERNELS},
                packed_attention_den=want["packed_attention_den"])
            log(f"[int8-train] 4 x 70, remat {policy}, "
                f"{'int8' if int8 else 'bf16'}: step by CUDA events "
                f"{[round(t, 2) for t in ms]} ms, peak memory over the "
                f"resting {peak[0]:.2f} GiB, peak allocated in all "
                f"{peak[1]:.2f} GiB (resting {peak[2]:.2f}), launches {n} "
                f"(expect {expect} per "
                f"step), total {[round(t, 4) for t in losses]} "
                f"({state['smi']})")
            if not all(np.isfinite(losses)) or any(
                    n[k] != 2 * v for k, v in expect.items()):
                raise AssertionError(f"4 x 70 {policy} int8={int8} failed")


def _int8_cli(state):
    """cli.train --int8_frozen at 16 x 8 on a synthetic fold, with
    --use_bf16 and without it (fp32: the w8a8 kernels' fp32 forms)."""
    import shutil
    import tempfile
    import torch
    root = tempfile.mkdtemp(prefix="gava_int8_")
    cwd = os.getcwd()
    kdir = None
    try:
        data_args, kdir = _write_fold(root, T=8, n_train=32, n_val=16)
        os.chdir(root)
        for f32 in (False, True):
            tag = "fp32 (no --use_bf16)" if f32 else "--use_bf16"
            args = [a for a in data_args if not (f32 and a == "--use_bf16")]
            _reset_launch_counts()
            logdir, rec = _train_main(args + [
                "--int8_frozen", "--batch_size", "16", "--num_steps",
                str(INT8_CLI_STEPS), "--print_freq", "1", "--lr", "1e-3",
                "--eval_freq", str(INT8_CLI_STEPS), "--save_freq", "1000"],
                "run_int8_f32" if f32 else "run_int8")
            counts = _launch_counts()
            steps = [r for r in rec if "loss" in r]
            losses = [r["loss"] for r in steps]
            sustained = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                         for a, b in zip(steps[1:], steps[2:])]
            files = set(os.listdir(logdir)) | set(
                os.listdir(os.path.join(logdir, "fold_0")))
            # the evaluation at the end runs forwards of the run's dtype
            # (B1, and B7 in the text tower), so only the training kernels
            # are counted; in fp32 no bf16 w8a8 or attention kernel runs
            if f32:
                want = {k: INT8_CLI_STEPS * INT8_F32_PER_STEP[k] for k in
                        INT8_F32_KERNELS + INT8_TRAIN_KERNELS
                        + ("packed_attention_den_f32",
                           "packed_attention_bwd_f32",
                           "streaming_attention_bwd_f32")}
                want.update({k: 0 for k in (
                    "packed_attention", "packed_attention_den",
                    "packed_attention_bwd", "streaming_attention",
                    "streaming_attention_bwd", "w8a8_matmul3_cat",
                    "w8a8_mlp", "attention_out_int8")})
            else:
                want = {k: INT8_CLI_STEPS * INT8_TRAIN_PER_STEP[k] for k in
                        INT8_TRAIN_KERNELS + ("packed_attention_den",
                                              "packed_attention_bwd",
                                              "streaming_attention_bwd")}
            log(f"[int8-train] cli.train --int8_frozen {tag}, "
                f"{INT8_CLI_STEPS} steps of 16 clips x 8 frames: loss "
                f"{[round(x, 4) for x in losses]}; sustained "
                f"{np.median(sustained):.2f} ms/step between print steps "
                f"(host clock); launches {counts} (expect {want}, and the "
                f"evaluation's forwards)")
            if not all(np.isfinite(losses)) or not \
                    np.mean(losses[-2:]) < np.mean(losses[:2]) or \
                    any(counts[k] != v for k, v in want.items()) or not \
                    {"config.yaml", "results.txt", "metrics.jsonl",
                     "fold-0-best.ckpt"} <= files:
                raise AssertionError(f"cli.train --int8_frozen {tag} failed "
                                     f"its checks")
            state["int8_cli_sustained_ms" + ("_f32" if f32 else "")] = \
                float(np.median(sustained))
            shutil.rmtree(logdir, ignore_errors=True)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if kdir:
            shutil.rmtree(kdir, ignore_errors=True)
        torch.cuda.empty_cache()


def phase_int8_train(state):
    """int8-forward training (--int8_frozen) through B3a, B2 and B5."""
    import torch
    for key in ("train_step", "train_state", "train_batch", "train_loss_fn",
                "train_model", "train_cfg", "train_opt"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    _int8_train_ops(state)
    torch.cuda.empty_cache()
    _int8_flagship_step(state)
    torch.cuda.empty_cache()
    _int8_flagship_step(state, torch.float32)
    torch.cuda.empty_cache()
    _int8_long_steps(state)
    _int8_cli(state)
    for name in INT8_TRAIN_KERNELS:
        state["kstats"][name]["int8_train"]["launches"] = \
            state["int8_launches"][name]
    # the fp32 forms' main path is the fp32 step: its 6 steps in turns
    for name in INT8_F32_KERNELS:
        state["launches_by_kernel"][name] = state["int8_launches_f32"][name]


FOLD_CLASSES = ("normal\nslight difficulty\nmoderate difficulty\n"
                "*normal\n*slight\n*moderate\n")
KNOWLEDGE_VERSIONS = ("v1", "v2", "v3", "v4", "v5")
CLI_STEPS = 12
CLI_PRINT_FREQ = 2
CLI_SAVE_FREQ = 6
# data-root substrings that the fold remapping of the training program
# rewrites (utils/config.remap_fold_data_root)
_REMAPPED = ("park", "mix", "real", "miccai", "tulip", "sep")


def _separable_clip(rs, label: int, T: int, S: int = 224) -> np.ndarray:
    """A uint8 clip (T, S, S, 3) whose class shows in its brightness and in
    the direction of a gradient, under uniform noise."""
    ramp = np.linspace(0.0, 1.0, S, dtype=np.float32)
    base = (ramp[None, :], ramp[:, None],
            np.abs(ramp[:, None] - ramp[None, :]))[label]
    img = 40.0 + 70.0 * label + 60.0 * np.broadcast_to(base, (S, S))
    clip = img[None, :, :, None] + rs.uniform(-25, 25, (T, S, S, 3))
    return np.clip(clip, 0, 255).astype(np.uint8)


def _write_fold(root: str, T: int, n_train: int, n_val: int, seed: int = 0,
                videos=None, memory: str = ""):
    """A synthetic fold under `root`: lists, decoded-view cache files in
    place of videos (no decoder needed), NTE arrays, the memory pickle, the
    knowledge directory and a classes file. Returns the program's data
    arguments. With `videos` (n_train + n_val names) the clips are
    `<name>*0.mp4`, whose NTE files `<name>.npy` the caller wrote under
    root/nte, and `memory` is the memory pickle: neither is drawn here."""
    import pickle
    from gava_clip_tpu_torch.data.datasets import (VideoDataset,
                                                   VideoDatasetConfig)
    from gava_clip_tpu_torch.utils.flagship import make_synthetic_knowledge_dir
    if any(w in root for w in _REMAPPED):
        raise RuntimeError(f"temporary directory {root} contains one of "
                           f"{_REMAPPED}, which the fold remapping rewrites")
    rs = np.random.RandomState(seed)
    cache = os.path.join(root, "cache")
    os.makedirs(os.path.join(root, "nte"), exist_ok=videos is not None)
    for split, n in (("train", n_train), ("val", n_val)):
        if videos is None:
            rows = [(f"{split}vid{i:03d}.mp4", i % 3) for i in range(n)]
        else:
            first = 0 if split == "train" else n_train
            rows = [(f"{videos[first + i]}*0.mp4", i % 3) for i in range(n)]
        lst = os.path.join(root, f"{split}_updrs.csv")
        with open(lst, "w") as f:
            f.write("".join(f"{p},{c}\n" for p, c in rows))
        ds = VideoDataset(VideoDatasetConfig(
            list_path=lst, data_root=root, num_spatial_views=1,
            num_temporal_views=1, num_frames=T, sampling_rate=1,
            is_train=split == "train", cache_dir=cache))
        for path, label in rows:
            ds._cache_store(path, _separable_clip(rs, label, T)[None])
            if videos is None:
                np.save(os.path.join(root, "nte",
                                     path.split(".")[0] + ".npy"),
                        rs.randn(70, 512).astype(np.float32))
    if not memory:
        memory = os.path.join(root, "mem.pkl")
        with open(memory, "wb") as f:
            pickle.dump({"embeds": rs.randn(192, 4, 512).astype(np.float32),
                         "updrs": np.arange(192) % 3}, f)
    classes = os.path.join(root, "classes.txt")
    with open(classes, "w") as f:
        f.write(FOLD_CLASSES)
    kdir = make_synthetic_knowledge_dir(3, KNOWLEDGE_VERSIONS)
    args = ["--nfold", "1", "--type", "updrs", "--data_root", root,
            "--text_prompt_classes_path", classes,
            "--decoded_cache_dir", cache, "--num_temporal_views", "1",
            "--num_frames", str(T), "--use_bf16",
            "--use_text_prompt_learning", "--use_text_prompt_CSC",
            "--text_num_prompts", "8",
            "--text_prompt_init", "cntn_split_uni_disc",
            "--knowledge_dir", kdir,
            "--use_summary_token", "--use_local_prompts",
            "--use_global_prompts", "--use_support_memory",
            "--memory_data_path", memory,
            "--mem_batch_size", "64", "--clLoss_nte_video",
            "--use_focal_ordinal_loss", "--num_workers", "4"]
    for kv in KNOWLEDGE_VERSIONS:
        args += ["--knowledge_version", kv]
    return args, kdir


def _run_records(logdir: str):
    with open(os.path.join(logdir, "fold_0", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _only_logdir(before):
    new = sorted(set(os.listdir("logs")) - before)
    if len(new) != 1:
        raise AssertionError(f"expected one new run directory, got {new}")
    return os.path.join("logs", new[0])


def _train_main(argv, tag: str):
    """cli.train.main in a run directory of its own: (logdir, records)."""
    from gava_clip_tpu_torch.cli import train as cli_train
    os.makedirs("logs", exist_ok=True)
    before = set(os.listdir("logs"))
    t0 = time.perf_counter()
    cli_train.main(argv)
    secs = time.perf_counter() - t0
    logdir = _only_logdir(before)
    os.rename(logdir, os.path.join("logs", tag))   # the name holds a minute
    logdir = os.path.join("logs", tag)
    log(f"[driver] {tag}: cli.train.main returned in {secs:.1f} s")
    return logdir, _run_records(logdir)


def _reference_state_dict(params) -> dict:
    """The port's `visual` / `textual` trees under the reference model's
    state-dict names (the inverse of utils/torch_convert), to write a
    .pth that the zero-shot program loads."""
    import torch
    sd = {}

    def lin(name, p):
        sd[f"{name}.weight"] = p["kernel"].t().contiguous()
        if p.get("bias") is not None:
            sd[f"{name}.bias"] = p["bias"]

    def ln(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["scale"], p["bias"]

    vis = params["visual"]
    D = vis["patch_embed"]["kernel"].shape[1]
    sd["visual.patch_embed.proj.weight"] = vis["patch_embed"]["kernel"] \
        .reshape(16, 16, 3, D).permute(3, 2, 0, 1).contiguous()
    sd["visual.patch_embed.proj.bias"] = vis["patch_embed"]["bias"]
    for name in ("cls_token", "pos_embed", "time_embed", "proj",
                 "global_prompts"):
        sd[f"visual.{name}"] = vis[name]
    ln("visual.ln_pre", vis["ln_pre"])
    ln("visual.ln_post", vis["ln_post"])
    for i, b in enumerate(vis["blocks"]):
        pre = f"visual.blocks.{i}"
        for n in ("q", "k", "v", "out"):
            lin(f"{pre}.attn.{n}_proj", b["attn"][n])
            lin(f"{pre}.summary_attn_layer.{n}_proj", b["summary_attn"][n])
        ln(f"{pre}.norm1", b["norm1"])
        ln(f"{pre}.norm2", b["norm2"])
        ln(f"{pre}.summary_ln", b["summary_ln"])
        lin(f"{pre}.mlp.fc1", b["mlp"]["fc1"])
        lin(f"{pre}.mlp.fc2", b["mlp"]["fc2"])
        lin(f"{pre}.cls_proj", b["cls_proj"])
        sd[f"{pre}.local_prompts"] = b["local_prompts"]
    txt = params["textual"]
    sd["textual.token_embedding.weight"] = txt["token_embedding"]
    sd["textual.positional_embedding"] = txt["positional_embedding"]
    sd["textual.text_projection"] = txt["text_projection"]
    ln("textual.ln_final", txt["ln_final"])
    for i, b in enumerate(txt["blocks"]):
        pre = f"textual.transformer.resblocks.{i}"
        a = b["attn"]
        sd[f"{pre}.attn.in_proj_weight"] = torch.cat(
            [a[n]["kernel"].t() for n in ("q", "k", "v")]).contiguous()
        sd[f"{pre}.attn.in_proj_bias"] = torch.cat(
            [a[n]["bias"] for n in ("q", "k", "v")])
        lin(f"{pre}.attn.out_proj", a["out"])
        ln(f"{pre}.ln_1", b["ln_1"])
        ln(f"{pre}.ln_2", b["ln_2"])
        lin(f"{pre}.mlp.c_fc", b["mlp"]["fc1"])
        lin(f"{pre}.mlp.c_proj", b["mlp"]["fc2"])
    return {k: v.detach().float().cpu() for k, v in sd.items()}


def _w8a8_text_features(state, model):
    """The flagship's text features with the whole text tower in w8a8:
    launch counts, each B3a and B2 launch against its plain version on
    its own inputs, the cosine to the bf16 features."""
    import torch
    # B3a's main path, and B2's at rows of 2,048. No program runs a
    # quantized text tower (cli.evaluate's zero-shot model holds the
    # vision tower only). So: the text features of the flagship with
    # its whole text tower in w8a8 (the attention projections and the
    # MLP), held against the same call on the bf16 weights
    from gava_clip_tpu_torch.ops.int8_matmul import with_kernel_layout
    from gava_clip_tpu_torch.ops.quant import quantize_weight
    bf = torch.bfloat16
    textual = model.params["textual"]

    def q8_linears(group):
        return {n: dict(p, kernel=dict(zip(("qa", "scale"),
                                           quantize_weight(p["kernel"]))))
                for n, p in group.items()}
    blocks = [dict(blk, attn=q8_linears(blk["attn"]),
                   mlp=q8_linears(blk["mlp"]))
              for blk in textual["blocks"]]
    q8 = with_kernel_layout(dict(model.params,
                                 textual=dict(textual, blocks=blocks)))
    # keep each B3a and B2 launch's inputs and outputs, to hold it
    # against the plain version on the same inputs after the call
    from gava_clip_tpu_torch.ops import int8_matmul as im
    b3a_calls, b3a_cuda = [], im.w8a8_matmul3_cuda
    b2_calls, b2_cuda = [], im.w8a8_matmul_cuda

    def recording_b3a(x, kernels3, bias3, ln=None):
        outs = b3a_cuda(x, kernels3, bias3, ln)
        b3a_calls.append(((x.clone(), kernels3, bias3, ln),
                          tuple(o.clone() for o in outs)))
        return outs

    def recording_b2(x, kernel, bias=None):
        out = b2_cuda(x, kernel, bias)
        b2_calls.append(((x.clone(), kernel, bias), out.clone()))
        return out
    im.w8a8_matmul3_cuda, im.w8a8_matmul_cuda = recording_b3a, \
        recording_b2
    try:
        _reset_launch_counts()
        tf8 = model.text_features_only(q8, model.buffers, bf)
        torch.cuda.synchronize()
        n3 = _launch_counts()
    finally:
        im.w8a8_matmul3_cuda, im.w8a8_matmul_cuda = b3a_cuda, b2_cuda
    b3a_ok, b3a_errs = True, []
    for i, ((x, k3, b3, ln), outs) in enumerate(b3a_calls):
        refs = im.w8a8_matmul3_plain(x, k3, b3, ln)
        xs = im.quant_rows(x.float())[1]
        for o, r, leaf in zip(outs, refs, k3):
            good, err, text = _check_w8a8(
                "w8a8_matmul3_cat", o, r, _flip_unit(xs, leaf["scale"]))
            b3a_ok, b3a_errs = b3a_ok and good, b3a_errs + [err]
            if not good:
                log(f"[driver] text block {i} B3a {tuple(x.shape)}: "
                    f"{text} FAIL")
        b3a_ok = b3a_ok and tuple(x.shape) == (TEXT_QKV_ROWS, TEXT_WIDTH)
    log(f"[driver] B3a launches of the text features held against "
        f"w8a8_matmul3_plain on their inputs: {len(b3a_calls)} launches "
        f"of {sorted({tuple(c[0][0].shape) for c in b3a_calls})} rows "
        f"(expect ({TEXT_QKV_ROWS}, {TEXT_WIDTH})), largest max_abs_err "
        f"{max(b3a_errs, default=float('nan')):.3e}, limits "
        f"{W8A8_LIMITS['w8a8_matmul3_cat']}: {'ok' if b3a_ok else 'FAIL'}")
    del b3a_calls
    # B2: the out-projection and fc1 (K = 512) and fc2 (K = 2,048) of
    # each block, each launch bit-equal to the plain version
    b2_ok, b2_errs = True, []
    for i, ((x, kern, bias), out) in enumerate(b2_calls):
        ref = im.w8a8_matmul_plain(x, kern, bias)
        good, err, text = _check_w8a8(
            "w8a8_matmul", out, ref,
            _flip_unit(im.quant_rows(x.float())[1], kern["scale"]))
        b2_ok, b2_errs = b2_ok and good, b2_errs + [err]
        if not good:
            log(f"[driver] text launch {i} B2 {tuple(x.shape)}: {text} "
                f"FAIL")
    b2_widths = sorted({c[0][0].shape[1] for c in b2_calls})
    b2_ok = b2_ok and b2_widths == sorted(TEXT_B2_WIDTHS) and all(
        c[0][0].shape[0] == TEXT_QKV_ROWS for c in b2_calls)
    log(f"[driver] B2 launches of the text features held against "
        f"w8a8_matmul_plain on their inputs: {len(b2_calls)} launches of "
        f"{TEXT_QKV_ROWS} rows, row widths {b2_widths} (expect "
        f"{sorted(TEXT_B2_WIDTHS)}), largest max_abs_err "
        f"{max(b2_errs, default=float('nan')):.3e}, limits "
        f"{W8A8_LIMITS['w8a8_matmul']} (bit-equal): "
        f"{'ok' if b2_ok else 'FAIL'}")
    del b2_calls
    tf16 = model.text_features_only(model.params, model.buffers, bf)
    cos = (tf8.float() * tf16.float()).sum(-1).min().item()
    log(f"[driver] text features, w8a8 text tower "
        f"{tuple(tf8.shape)}: "
        f"launches w8a8_matmul3 {n3['w8a8_matmul3']}, w8a8_matmul "
        f"{n3['w8a8_matmul']} (expect {TEXT_W8A8_LAUNCHES}); smallest "
        f"cosine to the bf16 model's {cos:.5f} (limit "
        f"{TEXT_W8A8_MIN_COSINE})")
    state.setdefault("launches_by_kernel", {})["w8a8_matmul3"] = \
        n3["w8a8_matmul3"]
    if any(n3[k] != n for k, n in TEXT_W8A8_LAUNCHES.items()) or \
            not b3a_ok or not b2_ok or tf8.shape != tf16.shape or \
            not bool(torch.isfinite(tf8.float()).all()) or \
            cos < TEXT_W8A8_MIN_COSINE:
        raise AssertionError("the w8a8 text features failed their checks")


def phase_cli(state):
    """cli.train, cli.evaluate and cli.zero_shot at full width on a
    synthetic fold."""
    import shutil
    import tempfile
    import torch
    from gava_clip_tpu_torch.cli import evaluate as cli_eval
    from gava_clip_tpu_torch.cli import train as cli_train
    from gava_clip_tpu_torch.cli import zero_shot as cli_zs
    from gava_clip_tpu_torch.train import checkpoint as ckpt_lib
    for key in ("train_step", "train_state", "train_batch", "train_loss_fn",
                "train_model", "train_cfg", "train_opt"):
        state.pop(key, None)
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="gava_fold_")
    cwd = os.getcwd()
    kdir = None
    try:
        t0 = time.perf_counter()
        data_args, kdir = _write_fold(root, T=8, n_train=64, n_val=32)
        log(f"[driver] synthetic fold written in "
            f"{time.perf_counter() - t0:.1f} s: 64 train + 32 val clips of "
            f"8 x 224 x 224 x 3 uint8 as decoded-view cache files, NTE "
            f"arrays, memory pickle, knowledge directory")
        os.chdir(root)
        train_args = data_args + [
            "--batch_size", "16", "--num_steps", str(CLI_STEPS),
            "--print_freq", str(CLI_PRINT_FREQ), "--lr", "1e-3",
            "--eval_freq", str(CLI_STEPS)]
        _reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run_a, rec_a = _train_main(
            train_args + ["--save_freq", str(CLI_SAVE_FREQ)], "run_a")
        counts = _launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        save_secs = dict(ckpt_lib.last_save_seconds)
        eval_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        steps_a = [r for r in rec_a if "loss" in r]
        loss_a = {r["step"]: r["loss"] for r in steps_a}
        # sustained time per step between print steps, the first window
        # (set-up, warm-up) left out
        sustained = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                     for a, b in zip(steps_a[1:], steps_a[2:])]
        data_ms = [r["data_time_s"] * 1e3 for r in steps_a[1:]]
        log(f"[driver] run_a: {CLI_STEPS} steps of 16 clips x 8 frames, "
            f"bf16, flash, prefetch 2: loss at the print steps "
            f"{ {k: round(v, 4) for k, v in loss_a.items()} }; sustained "
            f"{[round(x, 1) for x in sustained]} ms/step between print steps "
            f"(median {np.median(sustained):.2f}; the bare step "
            f"{state['train_ms']:.2f} ms by CUDA events), data_time "
            f"{[round(x, 1) for x in data_ms]} ms; evaluation "
            f"{eval_rate:.1f} clips/s over "
            f"{cli_train.last_eval['clips']} clips; last checkpoint: fetch "
            f"{save_secs['fetch']:.2f} s, write {save_secs['write']:.2f} s; "
            f"peak memory {peak:.2f} GiB; launches {counts} "
            f"({state['smi']})")
        first, last = steps_a[:2], steps_a[-2:]
        if not all(np.isfinite(list(loss_a.values()))) or not \
                np.mean([r["loss"] for r in last]) < \
                np.mean([r["loss"] for r in first]):
            raise AssertionError(f"the program's loss did not fall: {loss_a}")
        # 12 steps + 2 evaluation batches of 12 blocks
        want = {"packed_attention_den": 12 * CLI_STEPS,
                "packed_attention_bwd": 12 * CLI_STEPS,
                "packed_attention": 24,
                "streaming_attention_bwd": 12 * CLI_STEPS}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"launches {counts}, expected {want}")
        state["launches_cli"] = counts
        files = set(os.listdir(run_a))
        fold_files = set(os.listdir(os.path.join(run_a, "fold_0")))
        need = {"config.yaml", "results.txt", "confusion_matrix_fold-0.txt",
                "confusion_matrix_total.txt"}
        need_fold = {"metrics.jsonl", "fold-0-best.ckpt",
                     f"checkpoint-{CLI_SAVE_FREQ}.ckpt",
                     f"checkpoint-{CLI_STEPS}.ckpt"}
        if not need <= files or not need_fold <= fold_files:
            raise AssertionError(f"files of the run: {sorted(files)}, "
                                 f"{sorted(fold_files)}")
        with open(os.path.join(run_a, "results.txt")) as f:
            txt = f.read()
        best = ckpt_lib.load_checkpoint(
            os.path.join(run_a, "fold_0", "fold-0-best.ckpt"))
        if "Average F1-score" not in txt or \
                best["next_step"] != CLI_STEPS or \
                best["text_features"].shape != (3, 512) or \
                not any("eval_macro_f1" in r for r in rec_a):
            raise AssertionError("the run's reports are incomplete")
        conf_a = np.loadtxt(os.path.join(run_a,
                                         "confusion_matrix_fold-0.txt"))
        del best

        # the same run without the device prefetch and with the clamp
        # monitor: the same losses
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            run_b, rec_b = _train_main(
                train_args + ["--save_freq", "1000", "--device_prefetch", "0",
                              "--debug_attn_clamp"], "run_b")
        out_b = buf.getvalue()
        sys.stdout.write(out_b)
        from gava_clip_tpu_torch.ops import flash_attention as fa
        clamp = dict(fa.read_clamp_stats())
        fa.enable_clamp_monitor(False)
        steps_b = [r for r in rec_b if "loss" in r]
        loss_b = {r["step"]: r["loss"] for r in steps_b}
        sustained_b = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                       for a, b in zip(steps_b[1:], steps_b[2:])]
        log(f"[driver] run_b (--device_prefetch 0, --debug_attn_clamp): "
            f"losses equal run_a's: {loss_b == loss_a}; sustained "
            f"{np.median(sustained_b):.2f} ms/step, data_time "
            f"{[round(r['data_time_s'] * 1e3, 1) for r in steps_b[1:]]} ms; "
            f"clamp monitor: max exp2 argument {clamp['max_exp2_arg']:.2f} "
            f"over {clamp['calls']} calls, clipped {clamp['clipped']}")
        if loss_b != loss_a or "attn_max_exp2_arg" not in out_b or \
                not 0.0 < clamp["max_exp2_arg"] < 110.0 or clamp["clipped"] \
                or clamp["calls"] < 12 * CLI_STEPS:
            raise AssertionError("prefetch off / clamp monitor run failed")
        shutil.rmtree(run_b)

        # resume from the periodic checkpoint: the uninterrupted run's losses
        os.makedirs("resume_from")
        shutil.copy(os.path.join(run_a, "fold_0",
                                 f"checkpoint-{CLI_SAVE_FREQ}.ckpt"),
                    "resume_from")
        run_c, rec_c = _train_main(
            train_args + ["--save_freq", "1000", "--auto_resume",
                          "--checkpoint_dir", "resume_from"], "run_c")
        loss_c = {r["step"]: r["loss"] for r in rec_c if "loss" in r}
        tail = {k: v for k, v in loss_a.items() if k >= CLI_SAVE_FREQ}
        conf_c = np.loadtxt(os.path.join(run_c,
                                         "confusion_matrix_fold-0.txt"))
        log(f"[driver] run_c (--auto_resume from checkpoint-"
            f"{CLI_SAVE_FREQ}): steps {sorted(loss_c)}, losses equal the "
            f"uninterrupted run's: {loss_c == tail}, confusion matrix equal: "
            f"{np.array_equal(conf_c, conf_a)}")
        if loss_c != tail or not np.array_equal(conf_c, conf_a):
            raise AssertionError(f"resumed run {loss_c} vs {tail}")
        shutil.rmtree(run_c)
        shutil.rmtree("resume_from")

        # cli.evaluate on run_a: plain, then w8a8
        eval_args = ["--checkpoint_dir", run_a, "--data_root", root,
                     "--val_list_path", os.path.join(root, "val_updrs.csv"),
                     "--text_prompt_classes_path",
                     os.path.join(root, "classes.txt")]
        perf, conf = cli_eval.main(eval_args)
        plain_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        _reset_launch_counts()
        perf8, conf8 = cli_eval.main(eval_args + ["--quantize_eval", "w8a8"])
        n8 = _launch_counts()
        w8a8_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        log(f"[driver] cli.evaluate on run_a: accuracy {perf[0]:.4f}, "
            f"confusion {conf.tolist()} (the training run's best "
            f"{conf_a.astype(int).tolist()}), {plain_rate:.1f} clips/s; "
            f"--quantize_eval w8a8: accuracy {perf8[0]:.4f}, confusion "
            f"{conf8.tolist()}, {w8a8_rate:.1f} clips/s, launches "
            f"attention_out_int8 {n8['attention_out_int8']}, w8a8_mlp_res "
            f"{n8['w8a8_mlp_res']}, w8a8_matmul3 {n8['w8a8_matmul3']}, "
            f"w8a8_matmul {n8['w8a8_matmul']} (expect {EVAL_W8A8_LAUNCHES})")
        if not np.array_equal(conf, conf_a) or conf8.sum() != 32 or \
                any(n8[k] != n for k, n in EVAL_W8A8_LAUNCHES.items()) or \
                not any(f.startswith("eval_") for f in os.listdir(run_a)):
            raise AssertionError("cli.evaluate failed its checks")

        # the same program in fp32 (no --use_bf16): the fp32 attention
        # kernels and no bf16 one, then cli.evaluate on that run (fp32 from
        # the run's config.yaml) through the fp32 B1
        f32_args = [a for a in train_args if a != "--use_bf16"]
        _reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run_f, rec_f = _train_main(f32_args + ["--save_freq", "1000"],
                                   "run_f32")
        n_f = _launch_counts()
        peak_f = torch.cuda.max_memory_allocated() / 2 ** 30
        steps_f = [r for r in rec_f if "loss" in r]
        loss_f = {r["step"]: r["loss"] for r in steps_f}
        sustained_f = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                       for a, b in zip(steps_f[1:], steps_f[2:])]
        f32_rate = cli_train.last_eval["clips"] / \
            cli_train.last_eval["seconds"]
        want_f = {"packed_attention_den_f32": 12 * CLI_STEPS,
                  "packed_attention_bwd_f32": 12 * CLI_STEPS,
                  "packed_attention_f32": 24,
                  "streaming_attention_bwd_f32": 12 * CLI_STEPS,
                  "packed_attention_den": 0, "packed_attention_bwd": 0,
                  "packed_attention": 0, "streaming_attention": 0,
                  "streaming_attention_bwd": 0}
        log(f"[driver] run_f32 (no --use_bf16): {CLI_STEPS} steps of 16 clips "
            f"x 8 frames, fp32, flash, prefetch 2: loss at the print steps "
            f"{ {k: round(v, 4) for k, v in loss_f.items()} }; sustained "
            f"{[round(x, 1) for x in sustained_f]} ms/step (median "
            f"{np.median(sustained_f):.2f}; bf16 run_a {np.median(sustained):.2f}"
            f"); evaluation {f32_rate:.1f} clips/s; peak memory {peak_f:.2f} "
            f"GiB; launches {n_f} ({state['smi']})")
        first, last = steps_f[:2], steps_f[-2:]
        if not all(np.isfinite(list(loss_f.values()))) or not \
                np.mean([r["loss"] for r in last]) < \
                np.mean([r["loss"] for r in first]) or \
                any(n_f[k] != v for k, v in want_f.items()):
            raise AssertionError(f"the fp32 run failed its checks: losses "
                                 f"{loss_f}, launches {n_f}, expected "
                                 f"{want_f}")
        conf_f_run = np.loadtxt(os.path.join(run_f,
                                             "confusion_matrix_fold-0.txt"))
        _reset_launch_counts()
        perf_f, conf_f = cli_eval.main(["--checkpoint_dir", run_f] +
                                       eval_args[2:])
        n_ef = _launch_counts()
        log(f"[driver] cli.evaluate on run_f32: accuracy {perf_f[0]:.4f}, "
            f"confusion {conf_f.tolist()} (the run's best "
            f"{conf_f_run.astype(int).tolist()}), "
            f"{cli_train.last_eval['clips'] / cli_train.last_eval['seconds']:.1f}"
            f" clips/s, launches packed_attention_f32 "
            f"{n_ef['packed_attention_f32']} (expect 24), packed_attention "
            f"{n_ef['packed_attention']} (expect 0)")
        if not np.array_equal(conf_f, conf_f_run) or \
                n_ef["packed_attention_f32"] != 24 or n_ef["packed_attention"]:
            raise AssertionError("cli.evaluate on the fp32 run failed its "
                                 "checks")
        state.setdefault("launches_by_kernel", {})["packed_attention_f32"] = \
            n_ef["packed_attention_f32"]
        # --quantize_eval w8a8 on the fp32 run: the fp32 forms of B3 (with
        # the extras rows), B4 and B5 in every block, no bf16 w8a8 entry
        _reset_launch_counts()
        perf_q, conf_q = cli_eval.main(["--checkpoint_dir", run_f] +
                                       eval_args[2:] +
                                       ["--quantize_eval", "w8a8"])
        n_q = _launch_counts()
        log(f"[driver] cli.evaluate --quantize_eval w8a8 on run_f32: accuracy "
            f"{perf_q[0]:.4f} (plain {perf_f[0]:.4f}), confusion "
            f"{conf_q.tolist()}, "
            f"{cli_train.last_eval['clips'] / cli_train.last_eval['seconds']:.1f}"
            f" clips/s, launches "
            f"{ {k: n_q[k] for k in EVAL_W8A8_F32_LAUNCHES} } (expect "
            f"{EVAL_W8A8_F32_LAUNCHES})")
        if conf_q.sum() != 32 or abs(perf_q[0] - perf_f[0]) > 1 / 32 + 1e-9 \
                or any(n_q[k] != v for k, v in EVAL_W8A8_F32_LAUNCHES.items()):
            raise AssertionError("cli.evaluate --quantize_eval w8a8 on the "
                                 "fp32 run failed its checks")
        for name in ("attention_out_int8_f32", "w8a8_matmul3_cat_f32"):
            state["launches_by_kernel"][name] = n_q[name]
        _quantized_f32_evaluations(state, cli_eval, ["--checkpoint_dir",
                                                     run_f] + eval_args[2:],
                                   perf_f[0])
        shutil.rmtree(run_f)
        _augmented_runs(state, [a for a in data_args if a != "--use_bf16"],
                        steps_f, sustained_f)

        # cli.zero_shot on reference-format files written from a model's
        # own weights
        from gava_clip_tpu_torch.utils.flagship import build_flagship
        model = build_flagship(num_frames=8, knowledge_dir=kdir)
        _w8a8_text_features(state, model)
        sd = _reference_state_dict(model.params)
        torch.save(sd, "clip_backbone.pth")
        vlm = {f"module.{k}": v for k, v in sd.items()
               if k.startswith("visual.")}
        vlm["module.logit_scale"] = model.params["logit_scale"].cpu()
        torch.save({"model": vlm}, "vlm.pth")
        want_tf = model.params["textual"]["text_projection"].shape
        del model, sd, vlm
        zs_perf, zs_conf = cli_zs.main([
            "--type", "updrs", "--eval_data_root", root,
            "--eval_list_path", os.path.join(root, "val_updrs.csv"),
            "--text_prompt_classes_path", os.path.join(root, "classes.txt"),
            "--backbone_path", "clip_backbone.pth",
            "--pretrained_vlm", "vlm.pth", "--info_dir", "zs_info",
            "--decoded_cache_dir", os.path.join(root, "cache"),
            "--batch_size", "16", "--num_frames", "8",
            "--num_temporal_views", "1", "--use_bf16", "--num_workers", "4"])
        tf = np.load(os.path.join("zs_info", "ke_updrs",
                                  "text_features_v0.npy"))
        log(f"[driver] cli.zero_shot: accuracy {zs_perf:.4f}, confusion "
            f"{zs_conf.tolist()}, text features {tf.shape}")
        if zs_conf.sum() != 32 or tf.shape != (3, want_tf[1]) or \
                not np.isfinite(tf).all() or \
                not os.path.isfile("eval_output/class_name.txt"):
            raise AssertionError("cli.zero_shot failed its checks")
        # the same program in fp32 with --quantize_eval w8: B9's fp32 form
        # for the vision tower's projections, no bf16 entry
        _reset_launch_counts()
        zs8_perf, zs8_conf = cli_zs.main([
            "--type", "updrs", "--eval_data_root", root,
            "--eval_list_path", os.path.join(root, "val_updrs.csv"),
            "--text_prompt_classes_path", os.path.join(root, "classes.txt"),
            "--backbone_path", "clip_backbone.pth",
            "--pretrained_vlm", "vlm.pth", "--info_dir", "zs_info_w8",
            "--decoded_cache_dir", os.path.join(root, "cache"),
            "--batch_size", "16", "--num_frames", "8",
            "--num_temporal_views", "1", "--num_workers", "4",
            "--quantize_eval", "w8"])
        n_zs = _launch_counts()
        log(f"[driver] cli.zero_shot --quantize_eval w8 in fp32 (no "
            f"--use_bf16): accuracy {zs8_perf:.4f} (bf16 {zs_perf:.4f}), "
            f"confusion {zs8_conf.tolist()}, launches int8_matmul_f32 "
            f"{n_zs['int8_matmul_f32']} (at least 2 forwards x "
            f"{EVAL_W8_F32_LAUNCHES['int8_matmul_f32'] // 2}), int8_matmul "
            f"{n_zs['int8_matmul']}, packed_attention_f32 "
            f"{n_zs['packed_attention_f32']}, packed_attention "
            f"{n_zs['packed_attention']}")
        if zs8_conf.sum() != 32 or n_zs["int8_matmul"] or \
                n_zs["packed_attention"] or n_zs["int8_matmul_f32"] < \
                EVAL_W8_F32_LAUNCHES["int8_matmul_f32"]:
            raise AssertionError("cli.zero_shot --quantize_eval w8 in fp32 "
                                 "failed its checks")
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if kdir:
            shutil.rmtree(kdir, ignore_errors=True)


# the one RandAugment policy of the repo's recipes (scripts/k400_eval.sh)
AUG_POLICY = "rand-m7-n4-mstd0.5-inc1"
AUG_STEPS = 10
AUG_SAVE_FREQ = 5
# The augmentation on the card against the same function on the CPU with
# the same draws (normalized values): the share of values more than
# AUG_CARD_NEAR apart. The card's cos / sin and the geometric ops'
# products may each be an ulp off the CPU's, which moves a source
# coordinate of up to ~450 by a few ulp (3.1e-5 each) and so a bilinear
# value by that times the image's gradient (at most 1 a pixel, x 4.4 after
# the normalize): below 5.4e-4, on every pixel of a rotated clip. Where a
# coordinate crosses an integer at the frame's edge (the gray fill) or a
# value crosses a later posterize / equalize / solarize threshold, a pixel
# jumps instead: a few pixels, never most (the CPU tests hold the CPU form
# to JAX the same way, tests/test_torch_augment.py). (A first limit of 1%
# beyond 1e-5 missed the continuous part at 224^2: 1.17% of values, max
# 5.5e-5, on a batch with a rotation.)
AUG_CARD_NEAR = 1e-3
AUG_CARD_SHARE = 1e-2


def _augment_card_vs_cpu(state):
    """make_train_augment(AUG_POLICY, mirror, erase_prob 0.25) on 16 uint8
    clips of 8 x 224^2 on the card: its device ms per batch by CUDA events
    (the host draws and groups the ops: a host-paced time), then the card
    against the CPU on 4 clips with the same draws (AUG_CARD_SHARE)."""
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import (
        make_train_augment, step_generator)
    aug = make_train_augment(AUG_POLICY, True, erase_prob=0.25)
    frames = torch.randint(0, 256, (16, 8, 224, 224, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(2))
    card = frames.cuda()
    steps = iter(range(10 ** 6))
    ms = cuda_time_ms(lambda: aug(step_generator(0, next(steps)), card),
                      iters=10, warmup=3)
    t0 = time.perf_counter()
    for i in range(10):
        aug(step_generator(1, i), card)
    host_ms = (time.perf_counter() - t0) * 1e2
    torch.cuda.synchronize()
    worst = 0.0
    for step in range(3):
        d = aug.draw(step_generator(0, step), (4,) + tuple(frames.shape[1:]),
                     "cuda")
        got = aug(None, card[:4], draws=d)
        d_cpu = dict(d, erase=dict(d["erase"],
                                   noise=d["erase"]["noise"].cpu()))
        want = aug(None, frames[:4], draws=d_cpu)
        diff = (got.cpu() - want).abs()
        far = (diff > AUG_CARD_NEAR).float().mean().item()
        worst = max(worst, far)
        log(f"[driver] augmentation on the card vs the CPU, 4 clips, step "
            f"{step}, ops {d['rand_augment']['op'].tolist()}: values more "
            f"than {AUG_CARD_NEAR:g} apart {far:.3e}, more than 1e-5 apart "
            f"{(diff > 1e-5).float().mean().item():.3e}, max |diff| "
            f"{diff.max().item():.3e}")
    ok = worst <= AUG_CARD_SHARE
    log(f"[driver] augmentation {AUG_POLICY} + mirror + erasing 0.25 on 16 "
        f"clips of 8 x 224^2: {ms:.3f} ms a batch by CUDA events, "
        f"{host_ms:.3f} ms of host time a call; card vs CPU worst share "
        f"beyond {AUG_CARD_NEAR:g} {worst:.3e} (limit {AUG_CARD_SHARE:g}) "
        f"({state['smi']}) "
        f"{'ok' if ok else 'FAIL'}")
    state["augment"] = {"ms": ms, "host_ms": host_ms, "card_vs_cpu": worst}
    if not ok:
        raise AssertionError("the augmentation on the card disagrees with "
                             "the CPU")


def _augmented_runs(state, f32_data_args, steps_f, sustained_f):
    """cli.train --auto_augment AUG_POLICY (mirror on, the default) at
    16 x 8 in fp32 (the programs' default), AUG_STEPS steps: finite losses,
    the run files, sustained ms/step and data_time beside the plain fp32
    run's; an --auto_resume continuation from checkpoint-AUG_SAVE_FREQ
    repeats its losses; then the augmentation alone (_augment_card_vs_cpu)."""
    import shutil
    args = f32_data_args + [
        "--batch_size", "16", "--num_steps", str(AUG_STEPS),
        "--print_freq", str(CLI_PRINT_FREQ), "--lr", "1e-3",
        "--eval_freq", str(AUG_STEPS), "--auto_augment", AUG_POLICY]
    run, rec = _train_main(args + ["--save_freq", str(AUG_SAVE_FREQ)],
                           "run_aug")
    steps = [r for r in rec if "loss" in r]
    loss = {r["step"]: r["loss"] for r in steps}
    sustained = [(b["t"] - a["t"]) / (b["step"] - a["step"]) * 1e3
                 for a, b in zip(steps[1:], steps[2:])]
    data_ms = [round(r["data_time_s"] * 1e3, 1) for r in steps[1:]]
    data_f = [round(r["data_time_s"] * 1e3, 1) for r in steps_f[1:]]
    fold = set(os.listdir(os.path.join(run, "fold_0")))
    need = {"metrics.jsonl", "fold-0-best.ckpt",
            f"checkpoint-{AUG_SAVE_FREQ}.ckpt", f"checkpoint-{AUG_STEPS}.ckpt"}
    log(f"[driver] run_aug (--auto_augment {AUG_POLICY}, mirror, fp32): "
        f"{AUG_STEPS} steps of 16 clips x 8 frames: loss at the print steps "
        f"{ {k: round(v, 4) for k, v in loss.items()} }; sustained "
        f"{[round(x, 1) for x in sustained]} ms/step (median "
        f"{np.median(sustained):.2f}; the plain fp32 run "
        f"{np.median(sustained_f):.2f}), data_time {data_ms} ms (plain fp32 "
        f"run {data_f} ms) ({state['smi']})")
    state["aug_run"] = {"sustained_ms": float(np.median(sustained)),
                        "plain_sustained_ms": float(np.median(sustained_f)),
                        "data_ms": data_ms, "plain_data_ms": data_f}
    if not all(np.isfinite(list(loss.values()))) or not need <= fold or \
            "results.txt" not in os.listdir(run):
        raise AssertionError(f"the augmented run failed its checks: {loss}, "
                             f"{sorted(fold)}")
    os.makedirs("resume_aug")
    shutil.copy(os.path.join(run, "fold_0",
                             f"checkpoint-{AUG_SAVE_FREQ}.ckpt"), "resume_aug")
    run_r, rec_r = _train_main(
        args + ["--save_freq", "1000", "--auto_resume", "--checkpoint_dir",
                "resume_aug"], "run_aug_resumed")
    loss_r = {r["step"]: r["loss"] for r in rec_r if "loss" in r}
    tail = {k: v for k, v in loss.items() if k >= AUG_SAVE_FREQ}
    log(f"[driver] run_aug_resumed (--auto_resume from checkpoint-"
        f"{AUG_SAVE_FREQ}): steps {sorted(loss_r)}, losses equal the "
        f"uninterrupted augmented run's: {loss_r == tail}")
    if loss_r != tail:
        raise AssertionError(f"resumed augmented run {loss_r} vs {tail}")
    for d in (run, run_r, "resume_aug"):
        shutil.rmtree(d)
    _augment_card_vs_cpu(state)


# launches of the w8a8 evaluation of the driver phase: 2 batches of 16
# clips through the 12 vision blocks (B4). cli.evaluate builds the
# zero-shot model, which holds the vision tower only (the text features
# come from the checkpoint), so no text tower runs and neither B3a nor B2
# is launched
EVAL_W8A8_LAUNCHES = {"attention_out_int8": 24, "w8a8_matmul3": 0,
                      "w8a8_matmul": 0}
# the same evaluation of an fp32 run: the fp32 forms of B3 (the kv rows of
# a block with its extras rows), B4 and B5 in every block of the 2 batches
# (W8A8_PER_FORWARD's), and no bf16 w8a8 entry; the fp32 B1 is not
# launched on its own (B4's first launch is counted as B4)
EVAL_W8A8_F32_LAUNCHES = {
    "attention_out_int8_f32": 24, "w8a8_matmul3_cat_f32": 24,
    "w8a8_mlp_res_f32": 24, "w8a8_matmul3_f32": 0, "w8a8_matmul_f32": 0,
    "packed_attention_f32": 0, "attention_out_int8": 0,
    "w8a8_matmul3_cat": 0, "w8a8_mlp_res": 0, "w8a8_matmul3": 0,
    "w8a8_matmul": 0}
# the w8 evaluation of an fp32 run: B9's fp32 form for the q, k, v, out,
# fc1 and fc2 projections of the 12 vision blocks (72 a forward) and the
# fp32 B1 for their attention, in the 2 batches; no bf16 entry. The text
# features come from the checkpoint, so no text tower runs
EVAL_W8_F32_LAUNCHES = {"int8_matmul_f32": 144, "packed_attention_f32": 24,
                        "int8_matmul": 0, "packed_attention": 0}
# the w8a8 evaluation of an fp32 run under the int8 QK^T switch (B11 in
# fp32 in place of B4), and under the fused-extras switch (B10 on the fp32
# rows of each block's prompt extras, beside the fp32 B3, B4 and B5)
EVAL_W8A8_QK8_F32_LAUNCHES = dict(
    EVAL_W8A8_F32_LAUNCHES, attention_out_int8_f32=0,
    attention_out_int8_qk8_f32=24, attention_out_int8_qk8=0, fused_extras=0)
EVAL_W8A8_FUSED_F32_LAUNCHES = dict(EVAL_W8A8_F32_LAUNCHES, fused_extras=24,
                                    attention_out_int8_qk8_f32=0)


def _quantized_f32_evaluations(state, cli_eval, argv, plain_acc):
    """cli.evaluate on phase_cli's fp32 run with --quantize_eval w8,
    then --quantize_eval w8a8 under the int8 QK^T switch and under the
    fused-extras switch (each reset afterwards): the launches of each, and
    an accuracy within one clip (of 32) of the plain evaluation's."""
    from gava_clip_tpu_torch.cli import train as cli_train
    from gava_clip_tpu_torch.ops import extras_kernel as ek
    from gava_clip_tpu_torch.ops import flash_attention as fa
    runs = (("--quantize_eval w8", ["--quantize_eval", "w8"], None,
             EVAL_W8_F32_LAUNCHES, "int8_matmul_f32"),
            ("--quantize_eval w8a8, int8 QK^T", ["--quantize_eval", "w8a8"],
             fa.set_int8_qk, EVAL_W8A8_QK8_F32_LAUNCHES,
             "attention_out_int8_qk8_f32"),
            ("--quantize_eval w8a8, fused extras",
             ["--quantize_eval", "w8a8"], ek.set_fused_extras,
             EVAL_W8A8_FUSED_F32_LAUNCHES, None))
    for what, flags, switch, want, main_path in runs:
        if switch is not None:
            switch(True)
        try:
            _reset_launch_counts()
            perf, conf = cli_eval.main(argv + flags)
            n = _launch_counts()
        finally:
            fa.set_int8_qk(False)
            ek.set_fused_extras(False)
        rate = cli_train.last_eval["clips"] / cli_train.last_eval["seconds"]
        log(f"[driver] cli.evaluate {what} on run_f32: accuracy "
            f"{perf[0]:.4f} (plain {plain_acc:.4f}), confusion "
            f"{conf.tolist()}, {rate:.1f} clips/s, launches "
            f"{ {k: n[k] for k in want} } (expect {want})")
        if conf.sum() != 32 or abs(perf[0] - plain_acc) > 1 / 32 + 1e-9 or \
                any(n[k] != v for k, v in want.items()):
            raise AssertionError(f"cli.evaluate {what} on the fp32 run "
                                 f"failed its checks")
        if main_path:
            state["launches_by_kernel"][main_path] = n[main_path]


# the text features of the flagship with its whole text tower in w8a8: 12
# text blocks, each one B3a (the fused q/k/v of its self-attention) and
# three B2 (the out-projection, fc1 and fc2, whose rows are the MLP's
# hidden width, 2,048)
TEXT_W8A8_LAUNCHES = {"w8a8_matmul3": 12, "w8a8_matmul": 36}
TEXT_B2_WIDTHS = (512, 2048)
TEXT_W8A8_MIN_COSINE = 0.95
# rows of each of those B3a launches: the flagship's 3 classes x 5
# knowledge versions = 15 prompts of 77 tokens, 512 wide
TEXT_QKV_ROWS, TEXT_WIDTH = 3 * len(KNOWLEDGE_VERSIONS) * 77, 512


# the gait-text phase. 128 synthetic WHAM walks give the 10 gait
# parameters of offline/gait_params, so C(10, 4) = 210 combinations and a
# bank of 210 x 128 = 26,880 rows of 4 sentences (107,520 sentences)
GAIT_VIDEOS = 128
GAIT_SEED = 15
GAIT_COMBINATIONS = 210
GAIT_TRAIN_CLIPS, GAIT_VAL_CLIPS, GAIT_TRAIN_STEPS, GAIT_BATCH = 64, 16, 4, 16
GAIT_DEVICE = "cuda"
# the decoder at its full DecapConfig for one epoch of the bank (26,880 //
# 64 = 420 steps); the program's defaults (1e-5 over a 1,000-step warm-up)
# barely move the weights in 420 steps
DECAP_ARGS = ["--bs", "64", "--epochs", "1", "--lr", "1e-4",
              "--warmup_steps", "50"]
DECAP_STEPS = GAIT_COMBINATIONS * GAIT_VIDEOS // 64
DECODE_FEATURES, DECODE_CHECKED = 64, 8
# unit-norm bank rows: a norm off by more than fp32 rounding of 512 squares
BANK_NORM_TOL = 1e-5
# two combinations (the first and the last), 8 videos each, recomputed by
# the port on the host from the bank's own number tokens. Both sides are
# fp32 with TF32 off: the same operations summed in another order (cuBLAS
# against the host BLAS), each product of <= 2,048 terms off by ~sqrt(K)
# 2^-24 relative, the 12 residual blocks adding rather than compounding
# (LayerNorm rescales): ~1e-6 on these unit rows (~0.044 rms an element).
# 2e-5 leaves a 10x margin; a bf16 tower (2^-8 relative), a wrong row, slot
# or number level lands 10-1,000x above it
BANK_HOST_COMBOS, BANK_HOST_VIDEOS, BANK_HOST_ATOL = (0, 209), 8, 2e-5
# an NTE row is the mean of its bank row's 4 sentences: the same float32
# operations on the same values, so only last-bit differences
NTE_ATOL = 1e-6


def _synthetic_walk(rs, n_frames=240, fps=30):
    """A y-up SMPL walking skeleton (T, 24, 3) whose step frequency and
    speed are drawn from `rs`: the pelvis advances in x, the feet alternate
    (the pattern of the JAX package's offline tests)."""
    step_freq, speed = rs.uniform(1.4, 2.2), rs.uniform(0.8, 1.5)
    t = np.arange(n_frames) / fps
    joints = np.zeros((n_frames, 24, 3))
    phase = 2 * np.pi * step_freq * t
    x = speed * t
    joints[:, 0] = np.stack([x, 0.9 + 0.02 * np.sin(2 * phase),
                             np.zeros_like(t)], 1)
    joints[:, 1] = joints[:, 0] + [0, 0, 0.1]
    joints[:, 2] = joints[:, 0] + [0, 0, -0.1]
    joints[:, 10] = np.stack([x + 0.3 * np.sin(phase),
                              0.05 + 0.05 * np.maximum(np.sin(phase), 0),
                              0.1 * np.ones_like(t)], 1)
    joints[:, 11] = np.stack([x - 0.3 * np.sin(phase),
                              0.05 + 0.05 * np.maximum(-np.sin(phase), 0),
                              -0.1 * np.ones_like(t)], 1)
    return joints + rs.randn(*joints.shape) * 1e-3


def _gait_bank(state, root: str):
    """Steps 1-2: walks -> gait parameters -> metadata file -> the bank, the
    scale dict and the NTE files through the flagship's text tower on the
    card; the bank's checks. Returns (table, paths, bank)."""
    import math
    import pickle
    import torch
    from gava_clip_tpu_torch.models.text import (TextConfig,
                                                 encode_text_embeds,
                                                 init_text_params)
    from gava_clip_tpu_torch.offline import gait_params, preprocess
    from gava_clip_tpu_torch.text import tokenize
    from gava_clip_tpu_torch.text.tokenizer import EOT_TOKEN, VOCAB_SIZE
    from gava_clip_tpu_torch.utils.device import tree_to

    t0 = time.perf_counter()
    rs = np.random.RandomState(GAIT_SEED)
    skeletons = {f"walk{i:03d}": {"joints3D": _synthetic_walk(rs),
                                      "gait_score": i % 3, "diag": i % 2}
                 for i in range(GAIT_VIDEOS)}
    table = gait_params.process_skeletons(skeletons)
    meta = gait_params.save_metadata(
        table, os.path.join(root, "tulip_basic_gparams.xlsx"))
    log(f"[gait-text] {GAIT_VIDEOS} synthetic walks -> "
        f"{len(table['vidname'])} rows of {len(gait_params.GAIT_PARAM_NAMES)}"
        f" gait parameters -> {os.path.basename(meta)} in "
        f"{time.perf_counter() - t0:.2f} s (host)")
    if len(table["vidname"]) != GAIT_VIDEOS or \
            math.comb(len(gait_params.GAIT_PARAM_NAMES), 4) != \
            GAIT_COMBINATIONS:
        raise AssertionError("the gait-parameter table is short")

    cfg = TextConfig()
    text = init_text_params(torch.Generator().manual_seed(GAIT_SEED), cfg)
    n_sent = GAIT_COMBINATIONS * 4 * GAIT_VIDEOS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rest = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    paths = preprocess.data_preprocess(meta, text, cfg,
                                       save_dir=os.path.join(root, "gait"),
                                       video_dir=root, device=GAIT_DEVICE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - rest) / 2 ** 30
    # the tower alone: one call of batch_rows sentences by CUDA events
    params = tree_to(text, GAIT_DEVICE)
    rows = preprocess.PreprocessConfig().batch_rows
    x = torch.randn(rows, cfg.context_length, cfg.width, device=GAIT_DEVICE)
    eot = torch.full((rows,), 4, dtype=torch.int32, device=GAIT_DEVICE)
    with torch.inference_mode():
        call_ms = cuda_time_ms(lambda: encode_text_embeds(params, x, eot, cfg),
                               iters=3, warmup=1)
    del params, x
    flop = 2 * n_sent * cfg.context_length * cfg.layers * (
        12 * cfg.width ** 2 + 2 * cfg.context_length * cfg.width)
    tower_s = call_ms * n_sent / rows / 1e3
    state["gait_bank"] = {"seconds": secs, "sentences_per_s": n_sent / secs,
                          "peak_gib": peak, "call_ms": call_ms}
    log(f"[gait-text] bank: {n_sent:,} sentences of {cfg.context_length} "
        f"tokens through the text tower ({cfg.layers} x {cfg.width}, fp32, "
        f"plain attention) in calls of {rows:,}: {secs:.2f} s by the host "
        f"clock, {n_sent / secs:,.0f} sentences/s, peak "
        f"{peak:.2f} GiB over the resting memory; one call of {rows:,} "
        f"{call_ms:.1f} ms by CUDA events, so the tower ~{tower_s:.2f} s of "
        f"it ({flop / 1e15:.3f} PFLOP, {flop / tower_s / 1e12:.1f} TFLOP/s; "
        f"bound {flop / 67e12:.2f} s at 67 TFLOP/s fp32) ({state['smi']})")

    with open(paths["data"], "rb") as f:
        bank = pickle.load(f)
    emb = bank["embeds"]
    n_rows = GAIT_COMBINATIONS * GAIT_VIDEOS
    norms = np.linalg.norm(emb, axis=-1)
    if emb.shape != (n_rows, 4, cfg.embed_dim) or emb.dtype != np.float32 \
            or not np.isfinite(emb).all() or \
            np.abs(norms - 1).max() > BANK_NORM_TOL or \
            bank["tokens"].shape != (n_rows, 77) or \
            len(bank["text"]) != n_rows or \
            ((bank["tokens"] >= VOCAB_SIZE).sum(1) != 4).any():
        raise AssertionError(f"bank {emb.shape} {emb.dtype}, norms "
                             f"{norms.min()}..{norms.max()}")
    by_video = emb.reshape(GAIT_COMBINATIONS, GAIT_VIDEOS, 4, -1)
    nte_err = 0.0
    for v, vn in enumerate(table["vidname"]):
        nte = np.load(os.path.join(paths["nte_dir"], f"{vn}.npy"))
        if nte.shape != (GAIT_COMBINATIONS, cfg.embed_dim):
            raise AssertionError(f"NTE file {vn}: {nte.shape}")
        nte_err = max(nte_err, float(np.abs(
            nte - by_video[:, v].mean(axis=1)).max()))

    # two combinations recomputed on the host from the bank's own tokens
    t0 = time.perf_counter()
    host = tree_to(text, "cpu")
    names = [k for k in table if k not in ("vidname", "updrs", "diag",
                                           "leglength")]
    base = preprocess.encode_tokens(host, tokenize(names), cfg)
    base /= np.linalg.norm(base, axis=-1, keepdims=True)
    combos = preprocess.enumerate_combinations(len(names))
    rows_h = [c * GAIT_VIDEOS + v for c in BANK_HOST_COMBOS
              for v in range(BANK_HOST_VIDEOS)]
    tok = bank["tokens"][rows_h]
    levels = (tok[tok >= VOCAB_SIZE] - VOCAB_SIZE).astype(np.int64)
    name_idx = np.concatenate([combos[c] for c in BANK_HOST_COMBOS
                               for _ in range(BANK_HOST_VIDEOS)])
    template_ids = tokenize("X is X")[0]
    ne = preprocess.orthogonal_num_embedding(
        preprocess.sinusoidal_pe(1000, cfg.embed_dim))
    with torch.inference_mode():
        template = host["token_embedding"][torch.from_numpy(
            template_ids).long()]
    pooled = preprocess.encode_sentences(
        host, template, int(np.argmax(template_ids == EOT_TOKEN)),
        torch.from_numpy(base), torch.from_numpy(name_idx),
        torch.from_numpy(levels), True, torch.from_numpy(ne),
        torch.zeros(1, cfg.embed_dim, dtype=torch.float64), cfg, 4096)
    pooled /= np.linalg.norm(pooled, axis=-1, keepdims=True)
    host_err = float(np.abs(pooled.reshape(len(rows_h), 4, -1)
                            - emb[rows_h]).max())
    log(f"[gait-text] bank {emb.shape}, unit-norm within "
        f"{np.abs(norms - 1).max():.2e}, finite; {GAIT_VIDEOS} NTE files of "
        f"({GAIT_COMBINATIONS}, {cfg.embed_dim}), each row the mean of its "
        f"bank row within {nte_err:.2e} (limit {NTE_ATOL}); combinations "
        f"{BANK_HOST_COMBOS} x {BANK_HOST_VIDEOS} videos recomputed on the "
        f"host in {time.perf_counter() - t0:.2f} s: max |card - host| "
        f"{host_err:.2e} (limit {BANK_HOST_ATOL})")
    if nte_err > NTE_ATOL or not host_err <= BANK_HOST_ATOL:
        raise AssertionError("the bank disagrees with its NTE files or with "
                             "the host")
    return table, paths, bank


def _gait_train(state, root: str, table, paths):
    """Step 3: cli.train on a fold whose clips are the bank's videos, with
    the port's bank as support memory and its NTE files. Returns the run's
    best checkpoint."""
    from gava_clip_tpu_torch.data import datasets as tds

    videos = table["vidname"]
    data_args, kdir = _write_fold(root, T=8, n_train=GAIT_TRAIN_CLIPS,
                                  n_val=GAIT_VAL_CLIPS, videos=videos,
                                  memory=paths["data"])
    state["gait_kdir"] = kdir
    reads = []
    load_nte = tds.VideoDataset._load_nte

    def counted(self, rel_path):
        nte = load_nte(self, rel_path)
        reads.append((rel_path, nte.shape, bool(np.any(nte))))
        return nte

    tds.VideoDataset._load_nte = counted
    os.chdir(root)
    _reset_launch_counts()
    try:
        logdir, rec = _train_main(data_args + [
            "--batch_size", str(GAIT_BATCH), "--num_steps",
            str(GAIT_TRAIN_STEPS),
            "--print_freq", "1", "--lr", "1e-3",
            "--eval_freq", str(GAIT_TRAIN_STEPS)], "gait_run")
    finally:
        tds.VideoDataset._load_nte = load_nte
    counts = _launch_counts()
    losses = [r["loss"] for r in rec if "loss" in r]
    real = [r for r in reads if r[1] == (GAIT_COMBINATIONS, 512) and r[2]]
    best = os.path.join(root, logdir, "fold_0", "fold-0-best.ckpt")
    log(f"[gait-text] cli.train, {GAIT_TRAIN_STEPS} steps of {GAIT_BATCH} "
        f"clips x 8 "
        f"frames on the port's bank (--use_support_memory "
        f"--clLoss_nte_video): losses {[round(x, 4) for x in losses]}; NTE "
        f"reads {len(reads)}, {len(real)} of them a real "
        f"({GAIT_COMBINATIONS}, 512) file, "
        f"{len(reads) - len(real)} the zero default; launches {counts}")
    per_run = 12 * GAIT_TRAIN_STEPS
    if not losses or not np.isfinite(losses).all() or \
            len(reads) < GAIT_TRAIN_STEPS * GAIT_BATCH or \
            len(real) != len(reads) or \
            not os.path.isfile(best) or \
            any(counts[k] != per_run for k in (
                "packed_attention_den", "packed_attention_bwd",
                "streaming_attention_bwd")) or \
            counts["streaming_attention"] < per_run:
        raise AssertionError("cli.train on the port's bank failed its checks")
    state["launches_gait"] = counts
    return best


# the memory prompt at the CLIP text tower's full width: 3 classes over 16
# bank rows of 4 sentences, so 192 prompts of 77 tokens through the 12 x 512
# tower in bf16, B7 against the plain attention. Both paths run the same
# bf16 GEMMs, LayerNorms and MLPs; only the attention differs, where B7
# rounds its one-pass probabilities to bf16 (2^-9 relative each) and the
# plain path rounds the exact softmax: a few 2^-9 of each attention output,
# 12 times into a LayerNorm-bounded residual stream, adding rather than
# compounding: ~sqrt(12) x 2^-9 ~ 7e-3 at the very most, a few 1e-3
# expected. 2e-2 relative L2 leaves that a margin of 3x; a wrong mask,
# scale or row lands near 1
MEMORY_PROMPT_ROWS, MEMORY_PROMPT_CLASSES = 16, 3
MEMORY_PROMPT_REL_ERR = 2e-2
# the PCA on the card: its two variances against the top two eigenvalues of
# the same float32 rows' covariance on the host in float64, and its two
# columns uncorrelated. Both sides work in float64 on the same values and
# eigenvalues are well conditioned (Weyl), so they differ by summation
# order (~1e-12); the points are stored in float32 (2^-24 each, ~1e-7 on a
# variance). 1e-5 leaves 100x; a float32 SVD on the card moved them by
# 2.2e-4, an uncentred or wrong subspace is off by O(1)
PCA_REL_ERR = 1e-5
VIS_POINTS = 2000


def _rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def _gait_iwa(state, root: str, data, run: str):
    """cli.iwa over the gait run and a copy of it, beside cli.evaluate of
    the run on the same val split."""
    import math
    import shutil
    from gava_clip_tpu_torch.cli import evaluate as cli_eval
    from gava_clip_tpu_torch.cli import iwa as cli_iwa
    copy = run + "_copy"
    shutil.copytree(run, copy)
    _reset_launch_counts()
    perf, conf = cli_iwa.main(["--model_dirs", run, copy] + data)
    counts = _launch_counts()
    run_iwa = dict(cli_iwa.last_run)
    weights, forwards = run_iwa["weights"][0], run_iwa["forwards"]
    _reset_launch_counts()
    t0 = time.perf_counter()
    eperf, econf = cli_eval.main(["--checkpoint_dir", run] + data)
    eval_s = time.perf_counter() - t0
    want = 2 * (math.ceil(GAIT_TRAIN_CLIPS / GAIT_BATCH)
                + math.ceil(GAIT_VAL_CLIPS / GAIT_BATCH))
    others = {k: v for k, v in counts.items()
              if v and k != "packed_attention"}
    state["gait_iwa"] = {"seconds": run_iwa["seconds"],
                         "forwards": forwards,
                         "packed_attention": counts["packed_attention"]}
    log(f"[gait-text] cli.iwa over the run and its copy: {forwards} batch "
        f"forwards of {GAIT_BATCH} clips x 8 frames (2 models x train "
        f"{GAIT_TRAIN_CLIPS} + val {GAIT_VAL_CLIPS} clips) in "
        f"{run_iwa['seconds']:.2f} s by the host clock, the models' builds "
        f"and loaders included; weights {weights.tolist()}; top-1 "
        f"{perf[0]:.4f}, confusion {conf.tolist()}; cli.evaluate of the run "
        f"in {eval_s:.2f} s: top-1 {eperf[0]:.4f}, confusion "
        f"{econf.tolist()}; launches {counts['packed_attention']} "
        f"packed_attention (12 x {forwards}), others {others}")
    # two copies of one checkpoint give one logit matrix twice: a rank-1
    # Gram matrix whose pseudo-inverse spreads the weight evenly (the two
    # entries one SVD's rounding apart)
    if not np.isclose(weights[0], weights[1], rtol=1e-9, atol=0) or \
            forwards != want or \
            counts["packed_attention"] != 12 * forwards or others or \
            not np.isclose(perf[0], eperf[0], rtol=0, atol=1e-12) or \
            not np.array_equal(conf, econf) or \
            conf.sum() != GAIT_VAL_CLIPS:
        raise AssertionError("cli.iwa failed its checks")


def _gait_analysis(state, root: str, data, run: str):
    """cli.analysis of the gait run: the desc_wise forward, both towers."""
    import re
    from gava_clip_tpu_torch.cli import analysis as cli_an
    _reset_launch_counts()
    per_desc = cli_an.main(["--model_dir", run, "--output_dir",
                            os.path.join(root, "analysis")] + data)
    counts = _launch_counts()
    run_an = dict(cli_an.last_run)
    forwards = run_an["forwards"]
    with open(run_an["report"]) as f:
        report = f.read()
    precs = [float(x) for x in re.findall(r"\[\s*([-0-9.]+)%\]", report)]
    rows = {c: len(d) for c, d in per_desc.items()}
    state["gait_analysis"] = {"seconds": run_an["seconds"],
                              "forwards": forwards, **{
                                  k: counts[k] for k in (
                                      "packed_attention",
                                      "streaming_attention")}}
    log(f"[gait-text] cli.analysis of the run: {forwards} desc_wise "
        f"forward(s) of {GAIT_BATCH} clips in {run_an['seconds']:.2f} s by "
        f"the host clock; descriptor rows per class {rows}, precisions "
        f"{precs}; launches packed_attention "
        f"{counts['packed_attention']}, streaming_attention "
        f"{counts['streaming_attention']} (12 x {forwards} each)")
    if set(per_desc) != {0, 1, 2} or \
            any(n != len(KNOWLEDGE_VERSIONS) for n in rows.values()) or \
            len(precs) != sum(rows.values()) or \
            not all(0.0 <= p <= 100.0 for p in precs) or forwards < 1 or \
            counts["packed_attention"] != 12 * forwards or \
            counts["streaming_attention"] != 12 * forwards:
        raise AssertionError("cli.analysis failed its checks")


def _gait_memory_prompt(state, bank):
    """memory_prompt_features at the text tower's full width on the bank's
    rows, through B7 and through the plain attention."""
    import torch
    from gava_clip_tpu_torch.models.memory_prompt import (
        init_memory_prompt_params, memory_prompt_features)
    from gava_clip_tpu_torch.models.text import TextConfig, init_text_params
    from gava_clip_tpu_torch.utils.device import tree_to
    cfg = TextConfig()
    text = tree_to(init_text_params(torch.Generator().manual_seed(GAIT_SEED),
                                    cfg), GAIT_DEVICE)
    mp = init_memory_prompt_params(
        torch.Generator().manual_seed(GAIT_SEED), MEMORY_PROMPT_CLASSES,
        inp_dim=cfg.embed_dim, out_dim=cfg.width, device=GAIT_DEVICE)
    rows = torch.from_numpy(
        bank["embeds"][:MEMORY_PROMPT_ROWS]).to(GAIT_DEVICE)
    with torch.inference_mode():
        memory_prompt_features(mp, text, rows, rows, cfg)     # warm-up
        torch.cuda.synchronize()
        _reset_launch_counts()
        t0 = time.perf_counter()
        got = memory_prompt_features(mp, text, rows, rows, cfg)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = _launch_counts()
        ms = cuda_time_ms(lambda: memory_prompt_features(
            mp, text, rows, rows, cfg), iters=5, warmup=1)
        plain = memory_prompt_features(mp, text, rows, rows, cfg,
                                       attn_impl="xla")
        plain_ms = cuda_time_ms(lambda: memory_prompt_features(
            mp, text, rows, rows, cfg, attn_impl="xla"), iters=5, warmup=1)
    err = _rel_l2(got, plain)
    n = MEMORY_PROMPT_CLASSES * MEMORY_PROMPT_ROWS * 4
    state["gait_memory_prompt"] = {"seconds": secs, "ms": ms,
                                   "plain_ms": plain_ms}
    log(f"[gait-text] memory prompt, {MEMORY_PROMPT_CLASSES} classes x "
        f"{MEMORY_PROMPT_ROWS} bank rows x 4 sentences = {n} prompts of "
        f"{cfg.context_length} tokens through the {cfg.layers} x "
        f"{cfg.width} text tower in bf16: {tuple(got.shape)}, "
        f"{secs * 1e3:.2f} ms by the host clock, {ms:.2f} ms by CUDA "
        f"events (the plain attention {plain_ms:.2f}); relative L2 to the "
        f"plain attention {err:.2e} (limit {MEMORY_PROMPT_REL_ERR}); "
        f"launches streaming_attention {counts['streaming_attention']}")
    if tuple(got.shape) != (MEMORY_PROMPT_CLASSES, MEMORY_PROMPT_ROWS,
                            cfg.embed_dim) or \
            not torch.isfinite(got).all() or \
            not err <= MEMORY_PROMPT_REL_ERR or \
            counts["streaming_attention"] != cfg.layers or \
            sum(counts.values()) != cfg.layers:
        raise AssertionError("the memory prompt failed its checks")


def _gait_visualize(state, root: str, paths, vlm_ckpt: str):
    """cli.visualize on the bank: PCA on the card, --project_vlm with the
    run's checkpoint, --pairwise against one video's NTE file."""
    import torch
    from gava_clip_tpu_torch.cli import visualize as cli_vis
    secs = {}

    def timed(name, argv):
        """One run of the program, in an output directory of its own."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cli_vis.main(argv + ["--device", GAIT_DEVICE, "--output_dir",
                                   os.path.join(root, "vis", name)])
        secs[name] = time.perf_counter() - t0
        return dict(np.load(res["npz"])) if "npz" in res else res

    pca = timed("pca", ["--embeddings", paths["data"]])
    proj = timed("project_vlm", ["--embeddings", paths["data"],
                                 "--project_vlm", vlm_ckpt])
    feats, labels = cli_vis.load_embeddings(paths["data"])
    idx = np.random.RandomState(0).choice(len(feats), VIS_POINTS,
                                          replace=False)
    sub = feats[idx].astype(np.float64)
    base = os.path.join(root, "bank_rows.npy")
    np.save(base, feats[idx])
    nte = os.path.join(paths["nte_dir"], sorted(os.listdir(
        paths["nte_dir"]))[0])
    pair = timed("pairwise", ["--pairwise", f"nte={nte}", "--base", base])
    pair = dict(np.load(pair["nte"]["npz"]))
    # the card's PCA against the host's covariance in float64
    cov = np.cov(sub, rowvar=False)
    eig = np.linalg.eigvalsh(cov)[::-1][:2]
    pts = pca["points"].astype(np.float64)
    pcov = np.cov(pts, rowvar=False)
    var_err = float(np.abs(np.diag(pcov) / eig - 1).max())
    corr = float(abs(pcov[0, 1]) / pcov[0, 0])
    n_sub = 210
    shapes = {"pca": pca["points"].shape, "pca_labels": pca["labels"].shape,
              "project_vlm": proj["points"].shape,
              "base_base": pair["base_base"].shape,
              "base_sub": pair["base_sub"].shape}
    want = {"pca": (VIS_POINTS, 2), "pca_labels": (VIS_POINTS,),
            "project_vlm": (VIS_POINTS, 2),
            "base_base": (VIS_POINTS * (VIS_POINTS - 1) // 2,),
            "base_sub": (VIS_POINTS * n_sub + n_sub * (n_sub - 1) // 2,)}
    finite = all(np.isfinite(a).all() for a in (
        pca["points"], proj["points"], pair["base_base"], pair["base_sub"]))
    state["gait_visualize"] = secs
    log(f"[gait-text] cli.visualize on the bank: seconds "
        f"{ {k: round(v, 2) for k, v in secs.items()} } (host clock, the "
        f"220 MB pickle read included); PCA of {VIS_POINTS} rows on the "
        f"card: variances {np.diag(pcov).tolist()} against the host's "
        f"eigenvalues {eig.tolist()}, worst {var_err:.2e}, correlation "
        f"{corr:.2e} (limit {PCA_REL_ERR}); shapes {shapes}; finite "
        f"{finite}")
    if shapes != want or not finite or not var_err <= PCA_REL_ERR or \
            not corr <= PCA_REL_ERR:
        raise AssertionError("cli.visualize failed its checks")


def _gait_eval_tools(state, root: str, paths, bank, vlm_ckpt: str):
    """Step 4: the evaluation and analysis programs on the gait run."""
    run = os.path.dirname(os.path.dirname(vlm_ckpt))
    data = ["--data_root", root,
            "--val_list_path", os.path.join(root, "val_updrs.csv"),
            "--text_prompt_classes_path", os.path.join(root, "classes.txt"),
            "--batch_size", str(GAIT_BATCH), "--device", GAIT_DEVICE]
    t0 = time.perf_counter()
    _gait_iwa(state, root, data, run)
    _gait_analysis(state, root, data, run)
    _gait_memory_prompt(state, bank)
    _gait_visualize(state, root, paths, vlm_ckpt)
    state["gait_tools_s"] = time.perf_counter() - t0
    log(f"[gait-text] the evaluation and analysis programs in "
        f"{state['gait_tools_s']:.2f} s by the host clock ({state['smi']})")


def _gait_decoder(state, root: str, paths):
    """Step 5: cli.decoder_train at the full DecapConfig on the bank, one
    epoch; ms/step by the host clock and by CUDA events, peak memory."""
    import torch
    from gava_clip_tpu_torch.cli import decode as cli_decode
    from gava_clip_tpu_torch.cli import decoder_train as cli_dt
    from gava_clip_tpu_torch.train.state import tree_leaves

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    rest = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    best = cli_dt.main(["--train_data", paths["data"], "--output_dir",
                        os.path.join(root, "decap"), "--device", GAIT_DEVICE]
                       + DECAP_ARGS)
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - rest) / 2 ** 30
    run = dict(cli_dt.last_run)
    host_ms = run["seconds"] / max(run["steps"], 1) * 1e3

    params, cfg = cli_decode.load_decap(best, GAIT_DEVICE)
    ds = cli_dt.ClipGaitDataset(paths["data"])
    opt, sched = cli_dt.make_optimizer(params, 1e-4, 50, DECAP_STEPS)
    step = cli_dt.make_train_step(params, cfg, opt, sched)
    rs = np.random.RandomState(0)
    feeds = itertools.cycle([
        (torch.from_numpy(ds.embeds[i]).to(GAIT_DEVICE),
         torch.from_numpy(ds.tokens[i]).to(GAIT_DEVICE))
        for i in (rs.randint(0, len(ds), 64) for _ in range(4))])
    event_ms = cuda_time_ms(lambda: step(*next(feeds)), iters=20, warmup=3)
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params, opt, step, feeds
    tokens = 64 * 78
    flop = 3 * 2 * tokens * (cfg.n_layer * 12 * cfg.n_embd ** 2
                             + cfg.n_embd * cfg.vocab_size)
    if len(run["prints"]) < 2:
        raise AssertionError(f"{len(run['prints'])} prints of the decoder")
    first, last = run["prints"][0], run["prints"][-1]
    state["gait_decoder"] = {"host_ms": host_ms, "event_ms": event_ms,
                             "peak_gib": peak}
    log(f"[gait-text] cli.decoder_train, DecapConfig "
        f"{cfg.n_layer} x {cfg.n_embd}, vocabulary {cfg.vocab_size:,}, "
        f"{n_params / 1e6:.1f} M parameters, {' '.join(DECAP_ARGS)}: "
        f"{run['steps']} steps in {secs:.1f} s ({run['seconds']:.1f} s of "
        f"steps, {host_ms:.2f} ms/step by the host clock, the checkpoint "
        f"write included); the bare step {event_ms:.2f} ms by CUDA events "
        f"({flop / 1e12:.2f} TFLOP, {flop / event_ms / 1e9:.1f} TFLOP/s; "
        f"bound {flop / 67e12 * 1e3:.1f} ms at 67 TFLOP/s fp32); peak "
        f"{peak:.2f} GiB over the resting memory; prints (step, loss, acc) "
        f"{[(s, round(l, 4), round(a, 4)) for s, l, a in run['prints']]}")
    if run["steps"] != DECAP_STEPS or not np.isfinite(
            [l for _, l, _ in run["prints"]]).all() or \
            not last[1] < first[1] or not last[2] > first[2]:
        raise AssertionError("the decoder did not learn: loss and accuracy "
                             f"{first} -> {last}")
    return best


def _gait_decode(state, root: str, paths, bank, decap_ckpt: str,
                 vlm_ckpt: str):
    """Step 6: caption bank features with the three decoders; de-scale the
    bank's own number tokens through the scale dict and render them; then
    cli.decode's centroid study on the VLM checkpoint."""
    import pickle
    import torch
    from gava_clip_tpu_torch.cli import decode as cli_decode
    from gava_clip_tpu_torch.cli import decoder_train as cli_dt
    from gava_clip_tpu_torch.models import decap
    from gava_clip_tpu_torch.offline import preprocess
    from gava_clip_tpu_torch.text import ClipBpeTokenizer
    from gava_clip_tpu_torch.text.tokenizer import VOCAB_SIZE

    params, cfg = cli_decode.load_decap(decap_ckpt, GAIT_DEVICE)
    ds = cli_dt.ClipGaitDataset(paths["data"])
    rows = np.linspace(0, len(ds) - 1, DECODE_FEATURES).astype(int)
    feats = ds.embeds[rows]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    host, host_s = timed(lambda: [decap.greedy_decode(params, f, cfg)
                                  for f in feats[:DECODE_CHECKED]])
    cached_fn = decap.make_greedy_decoder(params, cfg)
    cached, cached_s = timed(lambda: [cached_fn(f) for f in feats])
    batched, batched_s = timed(
        lambda: decap.make_batched_decoder(params, cfg, batch=8)(feats))
    del params
    n_tok = sum(len(t) for t, _ in batched)
    agree = sum(a == b for a, b in zip(cached, batched))
    with open(paths["scale"], "rb") as f:
        scale = pickle.load(f)
    extra = scale["extra_info"]
    names = [k for k in scale if k != "extra_info"]
    tok = ClipBpeTokenizer()
    captions = [cli_decode.render_caption(list(t), n, scale, tok)
                for t, n in batched]
    decoded = [decap.descale_number(n, scale[k], extra)
               for _, ns in batched for n in ns for k in names]

    # the same rows' own tokens: each number token de-scales to its text's
    # value within one quantization level (graduated / weight * std) plus
    # the two roundings to 3 decimals, and the rendered caption carries it
    combos = preprocess.enumerate_combinations(len(names))
    worst, missing = 0.0, 0
    for r in rows:
        t = bank["tokens"][r].astype(int)
        levels = (t[t >= VOCAB_SIZE] - VOCAB_SIZE).tolist()
        combo = combos[r // GAIT_VIDEOS]
        written = [float(seg.split()[1]) for seg in
                   bank["text"][r].split(" , ")]
        values = [decap.descale_number(n, scale[names[i]], extra)
                  for n, i in zip(levels, combo)]
        for v, w, i in zip(values, written, combo):
            e = scale[names[i]]
            worst = max(worst, abs(v - w) / (
                extra["graduated"] / e["weight"] * e["std"] + 1e-3))
        t = [decap.QUESTION_TOKEN if x >= VOCAB_SIZE else x
             for x in t[:int(np.argmax(t == 49407)) + 1]]
        words = cli_decode.render_caption(t, levels, scale, tok).split()
        missing += sum(str(v) not in words for v in values)
    state["gait_decode"] = {"captions_per_s": DECODE_FEATURES / batched_s,
                            "tokens_per_s": n_tok / batched_s}
    log(f"[gait-text] decoding {DECODE_FEATURES} bank features: host loop "
        f"{DECODE_CHECKED} captions in {host_s:.2f} s "
        f"({DECODE_CHECKED / host_s:.2f} captions/s); K/V-cached "
        f"{DECODE_FEATURES / cached_s:.2f} captions/s; batched (8 lanes) "
        f"{DECODE_FEATURES / batched_s:.2f} captions/s, "
        f"{n_tok / batched_s:.0f} tokens/s ({n_tok} tokens); the cached and "
        f"batched decoders agree on {agree} of {DECODE_FEATURES}, both with "
        f"the host loop on the first {DECODE_CHECKED}: "
        f"{cached[:DECODE_CHECKED] == host}, "
        f"{batched[:DECODE_CHECKED] == host}; "
        f"{len(decoded) // len(names)} numbers decoded; the rows' own number "
        f"tokens de-scale to their text within {worst:.3f} of a level, "
        f"{missing} missing from the rendered captions; e.g. {captions[:2]}")
    if cached[:DECODE_CHECKED] != host or \
            batched[:DECODE_CHECKED] != host or \
            not np.isfinite(decoded).all() or worst > 1.0 or missing:
        raise AssertionError("the decoders disagree, or a number does not "
                             "de-scale")
    t0 = time.perf_counter()
    study = cli_decode.main(["--decap_ckpt", decap_ckpt, "--vlm_ckpt",
                             vlm_ckpt, "--memory_bank", paths["data"],
                             "--use_centroid", "--scale_dict", paths["scale"],
                             "--output", os.path.join(root, "centroid.txt"),
                             "--device", GAIT_DEVICE])
    log(f"[gait-text] cli.decode --use_centroid on the run's checkpoint in "
        f"{time.perf_counter() - t0:.2f} s: {study}")
    if set(study) != {"updrs 0", "updrs 1", "updrs 2"} or \
            not all(isinstance(v, str) for v in study.values()):
        raise AssertionError("cli.decode's centroid study failed")


def phase_gait_text(state):
    """WHAM joints to captions on the card: gait parameters, the bank and
    the NTE files, cli.train on them, the evaluation and analysis programs
    on that run, the DeCap decoder and its decoding."""
    import shutil
    import tempfile
    import torch
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="gava_gait_")
    cwd = os.getcwd()
    try:
        table, paths, bank = _gait_bank(state, root)
        vlm_ckpt = _gait_train(state, root, table, paths)
        _gait_eval_tools(state, root, paths, bank, vlm_ckpt)
        decap_ckpt = _gait_decoder(state, root, paths)
        _gait_decode(state, root, paths, bank, decap_ckpt, vlm_ckpt)
    finally:
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if state.get("gait_kdir"):
            shutil.rmtree(state.pop("gait_kdir"), ignore_errors=True)
        torch.cuda.empty_cache()


REMAT_POLICIES = ("none", "full", "save_attn", "save_attn_qkv",
                  "save_attn_mlp", "dots")
# attention forward launches per step at 12 blocks: the policies that keep
# the attention output launch it once per block
REMAT_FORWARDS = {"none": 12, "full": 24, "save_attn": 12,
                  "save_attn_qkv": 12, "save_attn_mlp": 12, "dots": 24}


def phase_cli_long(state):
    """The long clip: cli.train.main at 4 x 70 (the program picks
    save_attn_qkv), then the bare step under every remat policy."""
    import shutil
    import tempfile
    import torch
    from gava_clip_tpu_torch.cli import train as cli_train
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer)
    from gava_clip_tpu_torch.train.step import LossConfig, make_train_step
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    torch.cuda.empty_cache()
    root = tempfile.mkdtemp(prefix="gava_long_")
    cwd = os.getcwd()
    kdir = None
    seen = {}
    make = cli_train.make_train_step

    def spy(*a, **kw):
        seen["remat"] = kw.get("remat")
        return make(*a, **kw)

    try:
        data_args, kdir = _write_fold(root, T=70, n_train=8, n_val=4)
        os.chdir(root)
        cli_train.make_train_step = spy
        _reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        run, rec = _train_main(data_args + [
            "--batch_size", "4", "--num_steps", "3", "--print_freq", "1",
            "--lr", "5e-6", "--eval_freq", "1000", "--save_freq", "1000"],
            "run_long")
        counts = _launch_counts()
        losses = [r["loss"] for r in rec if "loss" in r]
        log(f"[driver-long] cli.train.main at 4 clips x 70 frames, 3 steps: "
            f"remat {seen.get('remat')!r}, losses "
            f"{[round(x, 4) for x in losses]}, batch_time "
            f"{[r['batch_time_s'] for r in rec if 'loss' in r]} s, peak "
            f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB, "
            f"launches {counts}")
        if seen.get("remat") != "save_attn_qkv" or len(losses) != 3 or \
                not all(np.isfinite(losses)) or \
                counts["packed_attention_den"] != 36 or \
                counts["packed_attention_bwd"] != 36:
            raise AssertionError("the long-clip run failed its checks")
    finally:
        cli_train.make_train_step = make
        os.chdir(cwd)
        shutil.rmtree(root, ignore_errors=True)
        if kdir:
            shutil.rmtree(kdir, ignore_errors=True)

    loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                          use_support_memory=True, add_nte=True)
    opt = make_optimizer(lr=5e-6, num_steps=2000, weight_decay=0.2)
    model = build_flagship(num_frames=70)
    ts = create_train_state(model.params,
                            trainable_mask(model.params, model.cfg), opt)
    batch = _train_batch(4, 70)
    table = {}
    for policy in REMAT_POLICIES:
        step = make_train_step(model, loss_cfg, opt, remat=policy,
                               compute_dtype=torch.bfloat16,
                               attn_impl="flash")
        torch.cuda.empty_cache()
        ts, metrics = step(ts, batch)                  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        dev_ms = []
        for _ in range(2):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            ts, metrics = step(ts, batch)
            ev[1].record()
            total = metrics["total"].item()
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        counts = _launch_counts()
        fwd = (counts["packed_attention_den"] + counts["packed_attention"]) \
            // 2
        table[policy] = (float(np.mean(dev_ms)),
                         torch.cuda.max_memory_allocated() / 2 ** 30, fwd)
        log(f"[driver-long] remat {policy}: {table[policy][0]:.2f} ms/step "
            f"(CUDA events, {[round(t, 1) for t in dev_ms]}), peak memory "
            f"{table[policy][1]:.2f} GiB, attention forward launches per "
            f"step {fwd} (expect {REMAT_FORWARDS[policy]}), backward "
            f"{counts['packed_attention_bwd'] // 2}; total {total:.4f} "
            f"({state['smi']})")
        if not np.isfinite(total) or fwd != REMAT_FORWARDS[policy] or \
                counts["packed_attention_bwd"] != 24:
            raise AssertionError(f"remat {policy} failed its checks")
    state["remat_table"] = table


def _profile(fn, runs: int, what: str, ms: float, smi: str, path: str,
             tag: str, rows: int):
    """torch.profiler over `runs` calls of fn: self device time by
    operator (the hand-written kernels by their symbols) and the device's
    busy share of the measured time `ms`; written to `path`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    ops, busy = [], 0.0
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0)
        if e.device_type == DeviceType.CUDA:
            busy += dev                         # a kernel, memcpy or memset
            if any(name in e.key for name in KERNEL_SYMBOLS):
                ops.append((dev, e.count, e.key))   # launched via ctypes
        elif dev > 0 and not e.key.startswith(("_PackedAttention",
                                               "_StreamingAttention")):
            # the op that launched them (the attention Functions' own
            # kernels are listed by symbol above)
            ops.append((dev, e.count, e.key))
    ops.sort(reverse=True)
    busy_ms = busy / runs / 1e3
    lines = [f"{what}: {ms:.3f} ms by CUDA events, device kernels "
             f"{busy_ms:.3f} ms of it (traced), idle share "
             f"{100 * (1 - busy_ms / ms):.1f}%, {smi}",
             "self device ms per run | calls per run | op"]
    lines += [f"{dev / runs / 1e3:9.3f} | {n / runs:6.1f} | {key}"
              for dev, n, key in ops[:rows]]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for line in lines[:16]:
        log(f"[profile{tag}] {line}")


def profile_train(state, out_dir: str):
    """2 training steps at batch 16."""
    step, batch = state["train_step"], state["train_batch"]
    _profile(lambda: step(state["train_state"], batch), 2,
             "batch-16 training step", state["train_ms"], state["smi"],
             os.path.join(out_dir, "profile_train.txt"), "_train", 32)


def profile_slice(state, out_dir: str, tag: str = ""):
    """3 device forwards of a serving classifier at batch 16."""
    clf = state[f"clf{tag}"]
    x = clf._prepare(state["clips"])
    _profile(lambda: clf._forward(x), 3, "batch-16 forward",
             state[f"fwd_ms{tag}"], state["smi"],
             os.path.join(out_dir, f"profile_slice{tag}.txt"), tag, 25)


def phase_server(state, tag: str = ""):
    from gava_clip_tpu_torch.server import serve
    clf, clips = state[f"clf{tag}"], state["clips"]
    httpd = serve(clf, "127.0.0.1", 0)
    port = httpd.server_address[1]
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{port}"
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            assert r.status == 200

        def post(i):
            req = urllib.request.Request(
                base + "/v1/classify_clip_raw", data=clips[i].tobytes(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())

        with ThreadPoolExecutor(4) as ex:
            res = list(ex.map(post, range(4)))
        for status, body in res:
            if status != 200 or len(body["probs"]) != len(clf.classnames) or \
                    abs(sum(body["probs"]) - 1.0) > 1e-3:
                raise AssertionError(f"bad response {status}")
        log(f"[server{tag}] 4 concurrent /v1/classify_clip_raw: all 200, labels "
            f"{[b['label'] for _, b in res]}, batcher {httpd.batcher.stats}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.stop()
        th.join(timeout=10)


# ---------------------------------------------------------------------------
# the parallel layer: a world of one over NCCL, two ranks on the one card,
# the pipelined forward and data-parallel serving
# ---------------------------------------------------------------------------

# the world of one: a first step with and without the all-reduce (NCCL's
# warm-up, untimed), then PARALLEL_TIMED_STEPS of each in turns
PARALLEL_TIMED_STEPS = 5
# the two-rank checks: ViT-B/16 and the text tower at full width, cut to
# 2 + 2 layers; a global batch of 8 clips (4 a rank) and 16 memory rows
PARALLEL_LAYERS = 2
PARALLEL_BATCH = 8
PARALLEL_MEMORY = 16
PARALLEL_CLI_STEPS = 4
# the pipelined zero-shot forward: 12 blocks in 4 stages, 4 micro-batches
# of the 16 clips, every stage on cuda:0; one B1 launch a block and
# micro-batch
PP_STAGES = 4
PP_MICRO = 4
PP_LAUNCHES = 12 * PP_MICRO
PARALLEL_TURNS = 3
# the data-parallel server against the plain classifier: a batch of 16
# (pad_buckets off) against the bucket of 4, the slice phase's padding
# limit; the same limit for the classifier over two devices (two shards of
# 8 clips, both on cuda:0) against one device's batch of 16
DP_SERVER_MAX_PROB_DIFF = 1e-3


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in [env.get("PYTHONPATH")] if p])
    return env


def _two_ranks(args, cwd, timeout=600, nproc=2):
    """`python -m torch.distributed.run --standalone --nproc_per_node
    <nproc> <args>`: its output; a nonzero exit raises with its last
    lines."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", str(nproc), *args]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=cwd, env=_child_env(), capture_output=True,
                         text=True, timeout=timeout)
    out = res.stdout + res.stderr
    if res.returncode != 0:
        raise AssertionError(f"{nproc} ranks exited {res.returncode}:\n"
                             f"{out[-6000:]}")
    return out, time.perf_counter() - t0


def _nccl_world_one(state):
    """The 16 x 8 fp32 step with and without the data-parallel all-reduce
    in a world of one over NCCL: the same bits over every step; the steps
    after the first timed in turns."""
    import tempfile
    import torch
    import torch.distributed as dist
    from gava_clip_tpu_torch.models.vita_clip import trainable_mask
    from gava_clip_tpu_torch.parallel import distributed as pdist
    from gava_clip_tpu_torch.parallel.mesh import all_reduce_grads, create_mesh
    from gava_clip_tpu_torch.train.state import (create_train_state,
                                                 make_optimizer, tree_leaves)
    from gava_clip_tpu_torch.train.step import LossConfig, make_train_step
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    store = tempfile.mkdtemp(prefix="gava_store_")
    pdist.init_distributed(f"file://{store}/store", num_processes=1,
                           process_id=0, backend="nccl")
    try:
        mesh = create_mesh()
        model = build_flagship(num_frames=8)
        mask = trainable_mask(model.params, model.cfg)
        opt = make_optimizer(lr=1e-3, num_steps=2000, weight_decay=0.2)
        loss_cfg = LossConfig(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                              use_support_memory=True, add_nte=True)
        kw = dict(compute_dtype=torch.float32, attn_impl="flash")
        runs = {"plain": [create_train_state(model.params, mask, opt),
                          make_train_step(model, loss_cfg, opt, **kw)],
                "all-reduce": [create_train_state(model.params, mask, opt),
                               make_train_step(model, loss_cfg, opt,
                                               mesh=mesh, **kw)]}
        batch = _train_batch(16, 8)
        totals = {k: [] for k in runs}
        ms = {k: [] for k in runs}
        for i in range(1 + PARALLEL_TIMED_STEPS):
            order = list(runs) if i % 2 == 0 else list(runs)[::-1]
            for name in order:
                ts, step = runs[name]
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                ts, metrics = step(ts, batch)
                ev[1].record()
                totals[name].append(metrics["total"].item())
                if i > 0:
                    ms[name].append(ev[0].elapsed_time(ev[1]))
        a, b = (runs[k][0] for k in runs)
        leaves = [(x, y) for x, y in zip(tree_leaves(a.trainable),
                                         tree_leaves(b.trainable))
                  if x is not None]
        equal = totals["plain"] == totals["all-reduce"] and all(
            torch.equal(x, y) for x, y in leaves)
        n_values = sum(x.numel() for x, _ in leaves)
        # the bucket alone: flatten, all-reduce, scale, copy back
        for _ in range(3):
            all_reduce_grads(b.trainable, mesh)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        for _ in range(10):
            all_reduce_grads(b.trainable, mesh)
        ev[1].record()
        torch.cuda.synchronize()
        bucket_ms = ev[0].elapsed_time(ev[1]) / 10
        # of which the collective itself, on a bucket of the same size
        flat = torch.zeros(n_values, device="cuda")
        dist.all_reduce(flat)
        ev[0].record()
        for _ in range(10):
            dist.all_reduce(flat)
        ev[1].record()
        torch.cuda.synchronize()
        collective_ms = ev[0].elapsed_time(ev[1]) / 10
        del flat
        med = {k: float(np.median(v)) for k, v in ms.items()}
        log(f"[parallel] world of one over NCCL ({dist.get_backend()}): "
            f"{1 + PARALLEL_TIMED_STEPS} fp32 steps of 16 x 8 with and "
            f"without the gradient all-reduce, in turns: totals "
            f"{totals['all-reduce']} vs {totals['plain']}, {len(leaves)} "
            f"trainable leaves, equal bit for bit: {equal}; ms/step after "
            f"the first (NCCL's warm-up) with {ms['all-reduce']}, without "
            f"{ms['plain']}: medians {med['all-reduce']} vs {med['plain']}, "
            f"difference {med['all-reduce'] - med['plain']}; the bucket of "
            f"{n_values / 1e6:.2f} M fp32 values: all_reduce_grads "
            f"{bucket_ms:.3f} ms, of which the NCCL all-reduce alone "
            f"{collective_ms:.3f} ms (CUDA events, mean of 10; "
            f"{state['smi']})")
        if not equal:
            raise AssertionError("a world of one changed the step")
        state["parallel_bucket"] = (n_values, bucket_ms)
    finally:
        dist.destroy_process_group()
        import shutil
        shutil.rmtree(store, ignore_errors=True)
        torch.cuda.empty_cache()


def _two_rank_model(path: str):
    """The flagship at full width cut to PARALLEL_LAYERS vision and text
    layers, saved for parallel/selfcheck.py; its config."""
    import dataclasses
    import torch
    from gava_clip_tpu_torch.utils.flagship import build_flagship
    model = build_flagship(num_frames=8, device="cpu")
    L = PARALLEL_LAYERS
    cfg = dataclasses.replace(
        model.cfg, vision=dataclasses.replace(model.cfg.vision, layers=L),
        text=dataclasses.replace(model.cfg.text, layers=L))
    params = dict(model.params)
    params["visual"] = dict(params["visual"],
                            blocks=params["visual"]["blocks"][:L],
                            global_prompts=params["visual"]
                            ["global_prompts"][:L].clone())
    params["textual"] = dict(params["textual"],
                             blocks=params["textual"]["blocks"][:L])
    torch.save({"cfg": cfg, "params": params, "buffers": model.buffers},
               path)
    return cfg


def _two_rank_steps(state, root: str):
    """The first data- and tensor-parallel steps of two ranks against one
    process (parallel/selfcheck.py --reference)."""
    import torch
    _two_rank_model(os.path.join(root, "model.pt"))
    rs = np.random.RandomState(1)
    B, Bm = PARALLEL_BATCH, PARALLEL_MEMORY
    np.savez(os.path.join(root, "batch.npz"),
             video=rs.rand(B, 8, 224, 224, 3).astype(np.float32),
             labels=rs.randint(0, 3, size=B),
             nte=rs.randn(B, 70, 512).astype(np.float32),
             memory=rs.randn(Bm, 4, 512).astype(np.float32),
             mt_labels=rs.randint(0, 3, size=Bm))
    loss = dict(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                use_support_memory=True, add_nte=True)
    out, secs = _two_ranks(
        ["-m", "gava_clip_tpu_torch.parallel.selfcheck",
         "--model", os.path.join(root, "model.pt"),
         "--batch", os.path.join(root, "batch.npz"),
         "--out", os.path.join(root, "results.pt"), "--backend", "gloo",
         "--scenarios", "dp,tp", "--steps", "1", "--reference",
         "--loss", json.dumps(loss)], cwd=ROOT)
    results = torch.load(os.path.join(root, "results.pt"),
                         weights_only=False)
    bad = []
    for name, what in (("dp", "data-parallel (2, 1)"),
                       ("tp", "tensor-parallel (1, 2)")):
        c = results[name]["check"]
        log(f"[parallel] two ranks on cuda:0 (gloo), {what} first fp32 step "
            f"at a global batch of {B} (ViT-B/16 and the text tower at full "
            f"width, {PARALLEL_LAYERS} + {PARALLEL_LAYERS} layers, NTE + "
            f"memory): total {c['loss']:.7f} vs one process "
            f"{c['loss_ref']:.7f} (diff {c['loss_diff']:.2e}, limit "
            f"{F32_STEP_MAX_LOSS_DIFF:g}); gradient leaves {c['leaves']}, max "
            f"relative L2 error {c['max_grad_rel_err']:.3e}, median "
            f"{c['median_grad_rel_err']:.3e} (limit "
            f"{F32_STEP_MAX_GRAD_REL_ERR:g}); the step "
            f"{results[name]['ms'][0]:.1f} ms on the host's clock, two ranks "
            f"sharing the card ({state['smi']})")
        if not c["loss_diff"] <= F32_STEP_MAX_LOSS_DIFF or \
                not c["max_grad_rel_err"] <= F32_STEP_MAX_GRAD_REL_ERR:
            bad.append(name)
    log(f"[parallel] the selfcheck launch took {secs:.1f} s on the host's "
        f"clock ({state['smi']})")
    if bad:
        raise AssertionError(f"two-rank steps {bad} disagree with the step "
                             f"in one process")


def _two_rank_cli(state, root: str):
    """cli.train over two ranks on a synthetic fold, then cli.evaluate in
    one process on its run."""
    from gava_clip_tpu_torch.cli import evaluate as cli_eval
    from gava_clip_tpu_torch.train import checkpoint as ckpt_lib
    os.makedirs(root)
    data_args, kdir = _write_fold(root, T=8, n_train=16, n_val=8)
    try:
        data_args = [a for a in data_args if a != "--use_bf16"]
        data_args[data_args.index("--num_workers") + 1] = "2"
        argv = data_args + [
            "--batch_size", str(PARALLEL_BATCH),
            "--num_steps", str(PARALLEL_CLI_STEPS), "--print_freq", "1",
            "--eval_freq", str(PARALLEL_CLI_STEPS), "--save_freq", "100",
            "--lr", "1e-3", "--num_layers", str(PARALLEL_LAYERS),
            "--text_transformer_layers", str(PARALLEL_LAYERS)]
        out, secs = _two_ranks(
            ["-m", "gava_clip_tpu_torch.cli.train", *argv,
             "--dist_backend", "gloo"], cwd=root)
        (run,) = os.listdir(os.path.join(root, "logs"))
        run = os.path.join(root, "logs", run)
        records = _run_records(run)
        losses = [r["loss"] for r in records if "loss" in r]
        conf_run = np.loadtxt(os.path.join(run, "confusion_matrix_fold-0.txt"))
        best = ckpt_lib.load_checkpoint(
            os.path.join(run, "fold_0", "fold-0-best.ckpt"))
        perf, conf = cli_eval.main(
            ["--checkpoint_dir", run, "--data_root", root,
             "--val_list_path", os.path.join(root, "val_updrs.csv"),
             "--text_prompt_classes_path", os.path.join(root, "classes.txt")])
        log(f"[parallel] cli.train over two ranks (gloo, fp32, "
            f"{PARALLEL_LAYERS} + {PARALLEL_LAYERS} layers, global batch "
            f"{PARALLEL_BATCH}): {secs:.1f} s, losses "
            f"{[round(x, 4) for x in losses]}; rank 0's checkpoint at step {best['next_step']}; cli.evaluate "
            f"in one process: confusion {conf.tolist()}, the run's "
            f"{conf_run.astype(int).tolist()} ({state['smi']})")
        if len(losses) != PARALLEL_CLI_STEPS or \
                not all(np.isfinite(losses)) or \
                "data-parallel over 2 ranks (gloo)" not in out or \
                best["next_step"] != PARALLEL_CLI_STEPS or \
                conf.sum() != 8 or not np.array_equal(conf, conf_run):
            raise AssertionError("cli.train over two ranks failed its "
                                 "checks")
    finally:
        import shutil
        shutil.rmtree(kdir, ignore_errors=True)


def _pipelined_forward(state):
    """The bf16 zero-shot forward with its 12 blocks in PP_STAGES stages on
    cuda:0 and PP_MICRO micro-batches, against the default forward."""
    import torch
    from gava_clip_tpu_torch.data.device_preprocess import normalize_frames
    from gava_clip_tpu_torch.data.video import parse_classes_file
    from gava_clip_tpu_torch.utils.flagship import (build_zero_shot,
                                                    inject_clip_pathologies)
    _, labels = parse_classes_file(os.path.join(ROOT, "classes",
                                                "k400_classes.txt"))
    model = build_zero_shot(num_frames=8, num_classes=400, input_size=224,
                            rng_seed=0)
    clf = _classifier(model, inject_clip_pathologies(model.param_tree(),
                                                     seed=0), labels)
    clips = np.random.RandomState(0).randint(0, 256, (16, 8, 224, 224, 3),
                                             dtype=np.uint8)
    pp = (["cuda:0"] * PP_STAGES, PP_MICRO)

    def forward(pipelined):
        with torch.inference_mode():
            xn = normalize_frames(clf._prepare(clips), clf._mean, clf._std)
            return clf.net(xn, compute_dtype=torch.bfloat16,
                           attn_impl="flash",
                           pp=pp if pipelined else None)["logits"]

    lg = forward(False)
    _reset_launch_counts()
    lg_pp = forward(True)
    torch.cuda.synchronize()
    n = _launch_counts()["packed_attention"]
    ms = _time_turns(lambda: forward(True), lambda: forward(False),
                     iters=PARALLEL_TURNS)
    d = (lg_pp - lg).abs().max().item()
    # the same kernels on the same rows: a micro-batch is whole clips and
    # every op of the tower works row by row, so the logits must match bit
    # for bit (a stage or a micro-batch that is off by any amount shows)
    same = torch.equal(lg_pp, lg)
    log(f"[parallel] the bf16 zero-shot forward at batch 16, the blocks in "
        f"{PP_STAGES} stages on cuda:0 with {PP_MICRO} micro-batches: "
        f"packed_attention launches {n} (expect {PP_LAUNCHES}); max |logit "
        f"diff| against the default forward {d!r}, equal bit for bit: "
        f"{same}; {ms[0]:.2f} ms pipelined vs {ms[1]:.2f} ms default (CUDA "
        f"events, in turns; {state['smi']})")
    if n != PP_LAUNCHES or not bool(torch.isfinite(lg_pp).all()) or \
            not same:
        raise AssertionError("the pipelined forward failed its checks")
    del clf, model
    torch.cuda.empty_cache()


def _dp_server(state):
    """`server --data_parallel 1` against the plain classifier on the same
    (seeded) weights; the classifier over two devices (both cuda:0: its
    shard, queue and gather steps) against one device's."""
    import torch
    from gava_clip_tpu_torch.data.video import parse_classes_file
    from gava_clip_tpu_torch.server import make_server
    from gava_clip_tpu_torch.serve import VideoClassifier
    from gava_clip_tpu_torch.utils.flagship import build_zero_shot
    classes = os.path.join(ROOT, "classes", "k400_classes.txt")
    _, labels = parse_classes_file(classes)
    httpd = make_server(["--host", "127.0.0.1", "--port", "0",
                         "--classes", classes, "--batch_size", "16",
                         "--data_parallel", "1"])
    clips = np.random.RandomState(5).randint(0, 256, (4, 8, 224, 224, 3),
                                             dtype=np.uint8)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        def post(i):
            req = urllib.request.Request(
                base + "/v1/classify_clip_raw", data=clips[i].tobytes(),
                method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())

        with ThreadPoolExecutor(4) as ex:
            res = list(ex.map(post, range(4)))
    finally:
        httpd.shutdown()
        httpd.server_close()
        httpd.batcher.stop()
        th.join(timeout=10)
    model = build_zero_shot(num_frames=8, num_classes=400)
    plain = VideoClassifier.from_model(model, labels, batch_size=16,
                                       device="cuda")
    want = plain.classify_clips(clips)
    got = np.array([b["probs"] for _, b in res], np.float32)
    d = float(np.abs(got - want).max())
    log(f"[parallel] server --data_parallel 1: 4 concurrent requests, "
        f"statuses {[st for st, _ in res]}, max |prob diff| against the "
        f"plain classifier {d:.2e} (limit {DP_SERVER_MAX_PROB_DIFF:g}; "
        f"{state['smi']})")
    if any(st != 200 for st, _ in res) or d > DP_SERVER_MAX_PROB_DIFF:
        raise AssertionError("the data-parallel server disagrees with the "
                             "plain classifier")
    del httpd
    two = VideoClassifier.from_model(model, labels, batch_size=16,
                                     devices=["cuda:0", "cuda:0"])
    clips16 = np.random.RandomState(6).randint(
        0, 256, (16, 8, 224, 224, 3), dtype=np.uint8)
    want16 = plain.classify_clips(clips16)
    _reset_launch_counts()
    got16 = two.classify_clips(clips16)
    n = _launch_counts()["packed_attention"]
    d16 = float(np.abs(got16 - want16).max())
    log(f"[parallel] VideoClassifier over two devices (cuda:0 twice, two "
        f"shards of 8 clips): packed_attention launches {n} (expect 24: 12 "
        f"a shard), max |prob diff| against one device's batch of 16 "
        f"{d16:.2e} (limit {DP_SERVER_MAX_PROB_DIFF:g}; {state['smi']})")
    if n != 24 or got16.shape != (16, 400) or \
            d16 > DP_SERVER_MAX_PROB_DIFF:
        raise AssertionError("the classifier over two devices disagrees "
                             "with one device's")
    del plain, two, model
    torch.cuda.empty_cache()


def phase_parallel(state):
    import shutil
    import tempfile
    _nccl_world_one(state)
    root = tempfile.mkdtemp(prefix="gava_par_")
    try:
        _two_rank_steps(state, root)
        _two_rank_cli(state, os.path.join(root, "fold"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    _pipelined_forward(state)
    _dp_server(state)


# ---------------------------------------------------------------------------
# frame sharding: two gloo ranks on cuda:0, each with half of every clip's
# frames
# ---------------------------------------------------------------------------

# the training step: the two-rank model of the parallel phase (full width,
# PARALLEL_LAYERS + PARALLEL_LAYERS layers), 16 clips of 8 frames, 4 a rank;
# each rank's launches in its first step: the fp32 attention kernels once a
# block (F32_PER_STEP's, PARALLEL_LAYERS blocks a tower), no other kernel
FRAME_BATCH = 16
FRAME_STEP_LAUNCHES = {k: PARALLEL_LAYERS for k, n in F32_PER_STEP.items()
                       if n}
# the zero-shot forward of 16 clips of 8 frames (parallel/selfcheck.py
# fp_serve), in bf16 ulps of its largest |logit|: the row-local kernels see
# each frame row as in one process, and the cross-frame extras run on the
# same gathered rows, so only the temporal mean's fp32 summation order may
# differ, and with it at most the rounding of a feature or a logit to
# bf16. The same forwards with rank 1's frames given the temporal
# embedding of frames 0..3 (the mutant fp_serve:local_time_embed) must
# leave it.
FRAME_SERVE_MAX_LOGIT_ULPS = 2
# each rank's launches in one frame-sharded forward: one a block, and the
# patch embed's B2 once
FRAME_SERVE_LAUNCHES = {
    "bf16": {"packed_attention": 12},
    "w8a8": {"w8a8_matmul": 1, "w8a8_matmul3_cat": 12,
             "attention_out_int8": 12, "w8a8_mlp_res": 12,
             "fused_extras": 12}}
# frame x pp (parallel/selfcheck.py fpp_serve): the blocks in 2 stages on
# cuda:0 and PP_SERVE_MICRO = 2 micro-batches of 8 clips; each rank
# launches B1 once a block and micro-batch (the counts below are one
# micro-batch's), in bf16 and then in fp32 (the model's fp32 weights). The pipeline runs each micro-batch's rows through the same
# kernels as one process, so bf16 takes FRAME_SERVE_MAX_LOGIT_ULPS and
# fp32, where only the order of fp32 sums may differ (the temporal mean,
# stock GEMMs over fewer rows), F32_REL of the largest |logit|, the fp32
# kernels' own limit. Stages that pass no FrameShard (fpp:no_gather) must
# leave both
FPP_SERVE_LAUNCHES = {"bf16": {"packed_attention": 12},
                      "fp32": {"packed_attention_f32": 12}}
# frame x model (fm_serve): the bf16 forward through vita_clip.apply, each
# rank 4 frames and 6 of the 12 heads (B1 once a block). The row-parallel
# out-projection and fc2 sum two bf16 partials over 'model', another
# rounding order than one GEMM's, so the limit is not in ulps of one
# process's arithmetic: one process's bf16 logits sit f32_diff from its
# fp32 forward on the same weights, the sharded forward (the same
# arithmetic rounded in another order) is taken to sit as far, and by the
# triangle inequality the two differ by at most twice that
FM_SERVE_MAX_F32_DIFFS = 2
FM_SERVE_LAUNCHES = {"packed_attention": 12}


def _frame_batch(path: str, seed: int):
    """The frame phase's global training batch: FRAME_BATCH clips of 8
    frames, NTE and memory rows."""
    rs = np.random.RandomState(seed)
    B, Bm = FRAME_BATCH, PARALLEL_MEMORY
    np.savez(path,
             video=rs.rand(B, 8, 224, 224, 3).astype(np.float32),
             labels=rs.randint(0, 3, size=B),
             nte=rs.randn(B, 70, 512).astype(np.float32),
             memory=rs.randn(Bm, 4, 512).astype(np.float32),
             mt_labels=rs.randint(0, 3, size=Bm))


def _frame_step_check(state, res, what: str, mutant=None) -> bool:
    """Log the first step of a frame scenario against one process (and of
    its mutant, which must leave the limits); True where it holds."""
    c = res["check"]
    log(f"[frame] {what}: the first fp32 step (ViT-B/16 and the text tower "
        f"at full width, {PARALLEL_LAYERS} + {PARALLEL_LAYERS} layers, NTE + "
        f"memory, {FRAME_BATCH} clips): total {c['loss']:.7f} vs one process "
        f"{c['loss_ref']:.7f} (diff {c['loss_diff']:.2e}, limit "
        f"{F32_STEP_MAX_LOSS_DIFF:g}); gradient leaves {c['leaves']}, max "
        f"relative L2 error {c['max_grad_rel_err']:.3e}, median "
        f"{c['median_grad_rel_err']:.3e} (limit "
        f"{F32_STEP_MAX_GRAD_REL_ERR:g}); the ranks' leaves after 2 steps "
        f"differ by {res['rank_spread']!r}; ms a step on the host's clock, "
        f"the ranks sharing the card {res['ms']}, one process alone "
        f"{c['ms_reference']} (the first step of each includes its warm-up; "
        f"{state['smi']}); rank 0's launches in its first step "
        f"{res['launches']} (expect {FRAME_STEP_LAUNCHES})")
    ok = c["loss_diff"] <= F32_STEP_MAX_LOSS_DIFF and \
        c["max_grad_rel_err"] <= F32_STEP_MAX_GRAD_REL_ERR and \
        res["rank_spread"] == 0.0 and \
        res["launches"] == FRAME_STEP_LAUNCHES
    if mutant is not None:
        m = mutant["check"]
        log(f"[frame] {what}, with the frame-partial gradients summed over "
            f"every rank instead of the 'frame' group: loss diff "
            f"{m['loss_diff']:.2e}, max gradient relative L2 error "
            f"{m['max_grad_rel_err']:.3e} (must exceed "
            f"{F32_STEP_MAX_GRAD_REL_ERR:g})")
        ok = ok and m["max_grad_rel_err"] > F32_STEP_MAX_GRAD_REL_ERR
    return ok


def _frame_serve_check(state, r, what: str, want: dict, shape, limit: float,
                       limit_text: str, mutant=None) -> bool:
    """Log a frame-sharded forward against one process (and its mutant,
    which must leave the limit); True where it holds."""
    per_rank = [{k: counts.get(k, 0) for k in want}
                for counts in r["launches"]]
    log(f"[frame] {what}: max |logit diff| against one process "
        f"{r['max_abs_diff']!r} (limit {limit_text}, {limit!r}"
        f"{'' if mutant is None else f'; its mutant {mutant!r}, which must exceed it'}"
        f"), ranks differ by {r['rank_spread']!r}; launches per rank "
        f"{per_rank} (expect {want}; all nonzero counts {r['launches']}); "
        f"ms a forward on the host's clock, the ranks together "
        f"{[round(x, 2) for x in r['ms']]}, one process alone "
        f"{[round(x, 2) for x in r['ms_one_process']]} ({state['smi']})")
    return r["finite"] and r["shape"] == shape and \
        r["max_abs_diff"] <= limit and \
        (mutant is None or mutant > limit) and r["rank_spread"] == 0.0 and \
        all(counts == want for counts in per_rank) and \
        not any(set(counts) - set(want) for counts in r["launches"])


def phase_frame(state):
    """Frame sharding against one process: the training step and the
    zero-shot forward of two frame ranks, the forward with its blocks as a
    pipeline (frame x pp), then the step and the forward of four ranks on
    a ('data', 'frame', 'model') (1, 2, 2) mesh (frame x model)
    (parallel/selfcheck.py fp, fp_serve, fpp_serve, fm, fm_serve)."""
    import shutil
    import tempfile
    import torch
    from gava_clip_tpu_torch.parallel.selfcheck import PP_SERVE_MICRO
    loss = json.dumps(dict(num_classes=3, focal_ordinal=True, fo_beta=0.2,
                           use_support_memory=True, add_nte=True))
    root = tempfile.mkdtemp(prefix="gava_frame_")
    results = {}
    try:
        _two_rank_model(os.path.join(root, "model.pt"))
        _frame_batch(os.path.join(root, "batch.npz"), 2)
        for nproc, scenarios in (
                (2, "fp,fp_serve,fp_serve:local_time_embed,fpp_serve,"
                    "fpp:no_gather"),
                (4, "fm,fm:grads_over_world,fm_serve")):
            out = os.path.join(root, f"results{nproc}.pt")
            _, secs = _two_ranks(
                ["-m", "gava_clip_tpu_torch.parallel.selfcheck",
                 "--model", os.path.join(root, "model.pt"),
                 "--batch", os.path.join(root, "batch.npz"),
                 "--out", out, "--backend", "gloo",
                 "--scenarios", scenarios, "--steps", "2", "--reference",
                 "--loss", loss], cwd=ROOT, nproc=nproc)
            results.update(torch.load(out, weights_only=False))
            log(f"[frame] the selfcheck launch of {nproc} ranks "
                f"({scenarios}) took {secs:.1f} s on the host's clock "
                f"({state['smi']})")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    bad = []
    if not _frame_step_check(state, results["fp"], "two ranks on cuda:0 "
                             "(gloo), 4 of the 8 frames of each clip a "
                             "rank"):
        bad.append("the training step")
    ulps = f"{FRAME_SERVE_MAX_LOGIT_ULPS} bf16 ulps of the largest |logit|"
    shape = (FRAME_BATCH, 400)
    for mode, want in FRAME_SERVE_LAUNCHES.items():
        r = results["fp_serve"][mode]
        what = (f"the zero-shot forward ({mode}"
                f"{' + patch-major, fused extras' if mode == 'w8a8' else ''})"
                f" of 16 clips of 8 frames, ViT-B/16 12 layers, 400 classes, "
                f"4 frames a rank (the mutant: rank 1's frames embedded as "
                f"frames 0..3)")
        if not _frame_serve_check(
                state, r, what, want, shape,
                FRAME_SERVE_MAX_LOGIT_ULPS * r["logit_ulp"], ulps,
                results["fp_serve:local_time_embed"][mode]["max_abs_diff"]):
            bad.append(f"the {mode} forward")
    for mode, per_micro in FPP_SERVE_LAUNCHES.items():
        r = results["fpp_serve"][mode]
        want = {k: n * PP_SERVE_MICRO for k, n in per_micro.items()}
        what = (f"frame x pp: the zero-shot forward ({mode}) of 16 clips, 4 "
                f"frames a rank, its 12 blocks in 2 stages on cuda:0 and "
                f"{PP_SERVE_MICRO} micro-batches, against one process "
                f"without the pipeline (the mutant: stages that pass no "
                f"FrameShard)")
        limit, text = (FRAME_SERVE_MAX_LOGIT_ULPS * r["logit_ulp"], ulps) \
            if mode == "bf16" else (F32_REL * r["max_abs_logit"],
                                    "F32_REL of the largest |logit|")
        if not _frame_serve_check(
                state, r, what, want, shape, limit, text,
                results["fpp:no_gather"][mode]["max_abs_diff"]):
            bad.append(f"the pipelined {mode} forward")
    if not _frame_step_check(state, results["fm"], "frame x model: four "
                             "ranks on cuda:0 (gloo), mesh (1, 2, 2), 4 "
                             "frames and 6 of the 12 heads a rank",
                             results["fm:grads_over_world"]):
        bad.append("the frame x model training step")
    r = results["fm_serve"]["bf16"]
    if not _frame_serve_check(
            state, r, "frame x model: the zero-shot forward (bf16) through "
            "vita_clip.apply of 16 clips, 4 frames and 6 of the 12 heads a "
            "rank", FM_SERVE_LAUNCHES, shape,
            FM_SERVE_MAX_F32_DIFFS * r["f32_diff"],
            f"{FM_SERVE_MAX_F32_DIFFS} x one process's bf16-vs-fp32 "
            f"distance {r['f32_diff']!r}"):
        bad.append("the frame x model forward")
    if bad:
        raise AssertionError(f"frame sharding: {bad} disagree with one "
                             f"process")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="after each slice phase, write a torch.profiler "
                         "breakdown of the batch-16 forward (and of the "
                         "training step) to this directory")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import_port()
    # plain references in full fp32 / full-precision bf16 reductions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    state = {"profile_dir": args.profile}
    slice_tags = {"slice": "", "w8a8-slice": "_w8a8", "w8-slice": "_w8"}
    for name, phase in (
            ("device", phase_device), ("build", phase_build),
            ("kernel", phase_kernel), ("w8a8-kernel", phase_w8a8_kernels),
            ("train-kernel", phase_train_kernels),
            ("f32-kernel", phase_f32_kernels),
            ("w8a8-f32", phase_w8a8_f32),
            ("serving-f32", phase_serving_f32),
            ("f32-mutants", phase_f32_mutants),
            ("w8-kernel", phase_w8_kernels), ("mega", phase_mega),
            ("slice", phase_slice), ("w8a8-slice", phase_w8a8_slice),
            ("w8-slice", phase_w8_slice),
            ("w8a8-variants", phase_w8a8_variants),
            ("server", phase_server),
            ("w8a8-server", lambda st: phase_server(st, "_w8a8")),
            ("w8-server", lambda st: phase_server(st, "_w8")),
            ("train-slice", phase_train_slice),
            ("train-recompute", phase_train_recompute),
            ("train-f32", phase_train_f32),
            ("int8-train", phase_int8_train),
            ("driver", phase_cli),
            ("gait-text", phase_gait_text),
            ("train-long", phase_train_long),
            ("driver-long", phase_cli_long),
            ("parallel", phase_parallel),
            ("frame", phase_frame)):
        t0 = time.perf_counter()
        phase(state)
        log(f"[{name}] done in {time.perf_counter() - t0:.1f} s "
            f"({_card_state()})")
        if name in slice_tags and args.profile:
            profile_slice(state, args.profile, slice_tags[name])
        if name == "train-slice" and args.profile:
            profile_train(state, args.profile)
        if name == "w8-server":
            # the serving phases are done: free their weights before the
            # training step
            for key in ("clf", "clf_w8a8", "clf_w8", "model", "params",
                        "clips"):
                state.pop(key, None)
            torch.cuda.empty_cache()
    _assert_no_jax()
    kernels = [{"name": "packed_attention", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
                "launches": state["launches"],
                "max_abs_err": state["max_abs_err"],
                "ms": state["ms"], "plain_ms": state["plain_ms"],
                "bound_ms": state["b1_bound"][0],
                "bound_by": state["b1_bound"][1],
                "library_ms": state["b1_library_ms"]}]
    for name, stats in state["kstats"].items():
        _, source, replaces = KERNELS[name]
        # the count from the run of the kernel's own main path
        launches = state["launches_by_kernel"] \
            if name in state["launches_by_kernel"] \
            else state["launches_w8a8"] if name in W8A8_PER_FORWARD \
            else state["launches_train"]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **stats})
    for entry in kernels:
        if entry["name"] in state.get("long_keys", {}):
            entry["long_keys"] = state["long_keys"][entry["name"]]
    missing = sorted(set(KERNELS) - {e["name"] for e in kernels})
    if missing:
        raise AssertionError(f"kernels without a check and a time: {missing}")
    for entry in kernels:
        if entry["launches"] < 1:
            raise AssertionError(f"{entry['name']} was never launched on "
                                 f"its main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(state["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
