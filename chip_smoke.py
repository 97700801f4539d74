#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port end to end on one NVIDIA card, and check it.

Run from the root of a checkout, on a machine with the card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; there is no CPU path). Phases 1-14
run one after another; then 15-15f start in the background and this
process runs 16-20, 22, 23 and 15's card checks beside them, waits for
them, and runs 21 last. A ``time:`` line after each step gives its
seconds.

1. card: ``nvidia-smi`` name and power limit, torch/CUDA versions; TF32
   off for matmuls and convolutions (the LM head is an f32 product, and
   the plain versions of the kernels must be full f32);
   builds every kernel of ``dss_ml_at_scale_tpu_torch/csrc`` with nvcc,
   one process per source, all at once; prints the build time, each
   kernel's registers, spills and static shared memory from ptxas (and its
   C75xx performance notes, such as serialized wgmmas), the dynamic shared
   memory of K4 and K1, and K4's wide and f32 layouts.
2. kernels: the flash attention kernel (K4) against its plain version on the
   card, in bf16, at the serving shapes (b=1, h=8, d=128, causal, seq 128,
   512, 1024), the LM training shape (causal b8 h8 s2048 d128) plus a
   non-causal, an ``sq < sk``, a d=64 and a d=32 case (the ``lm``
   command's default head dim), and heads the kernel has no tile for,
   zero-padded to 32 (d8 and d16 at b1 h4 s24 and s128, and d8 at the
   full_stack pipeline's lm shape, b8 h4 s24), and heads above 128 (the
   wide kernels: d192, d256, d320 and d512, causal and not, at b1 h8 s2048
   in bf16 and in f32, and d256 at the training shape b8 h8 s2048); atol
   2e-2, and a mean error under one bf16 spacing of the mean output. The
   f32 cases (d32, d64 and d128 causal b1 h8 s512, the LM training shape
   b8 h8 s2048 d128, and the wide ones) hold the f32 kernel to atol 2e-5.
   Median times (CUDA events) of the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never called
   by the port), beside the least time the card could take. At the three
   serving buckets also the kernel with and without its key-split plan
   (``split_ms``, ``nosplit_ms``), both held to the same limits, and the
   split output checked bit for bit from run to run.
2a. wide-lm: the head-256 LM of ``lm --dim 1024 --heads 4``
   (``TransformerLM`` vocab 8192, dim 1024, 4 heads, 4 layers, seeded), one
   causal forward through ``attention="flash"`` against
   ``attention="reference"`` with the same weights: bf16 at batch 8, seq
   2048, logits within 2e-2 of max-abs and 4 launches of the bf16 wide
   kernel (``launches_wide``); f32 at batch 8, seq 512, within 2e-5 and 4
   launches of the f32 kernel (``launches_f32``).
3. fused-matmul kernels: K1 (BN-apply + ReLU + 1x1 conv forward), K2 (its
   masked input gradient with the BN channel sums) and K3 (its weight
   gradient) against their plain versions, in bf16, at the four ResNet-50
   stage shapes at batch 212, each with and without a residual, plus a
   ragged case (M, K and N on no tile boundary). K1's out to rtol 0.05 /
   atol 0.15 (the bf16 tolerance of tests/test_fused_matmul.py:203); gt,
   the two sums and dW to a max-abs error of one bf16 spacing (2^-7) of
   the plain result's max-abs: gt is stored in bf16, so it may differ by
   one rounding, while the sums and dW are f32 sums taken in another
   order. Times of each kernel, its plain version and the cuBLAS product of
   the same shapes alone (the matmul part only: no PyTorch call computes
   the fused function), beside the least time the card could take.
3a. fused-f32: K1f-K3f (``csrc/fused_matmul_f32.cu``) against their plain
   versions in f32 at the same ten cases: K1f's out at rtol/atol 1e-5
   (tests/test_fused_matmul.py:76), K2f's gt within 1e-5 of max-abs and its
   ReLU mask bit for bit (gt zero wherever the mask is off and, with g and
   W positive, nonzero exactly where it is on; a gt that cancels to exactly
   zero where the plain one does not fails past 1e-5 of max-abs and is
   counted); the M-long sums (sum_g, sum_gx, dW) each held, beside the
   plain version's, against an f64 sum of the same f32 terms: within 1e-5
   of max-abs or no worse than twice the plain version. Times of each
   kernel, its plain version and cuBLAS SGEMM (TF32 off) of the same
   product, beside two bounds for the same work: 3xTF32 on the tensor cores
   (three products at 495 TFLOP/s, ``bound_ms``; K1f, K2f and K3f all run
   so) and one f32 product on the CUDA cores (67 TFLOP/s,
   ``bound_ffma_ms``: the yardstick of their earlier FFMA designs).
4. training: a 848-row train table and a 212-row val table from the port's
   ``datagen images`` (256 px JPEGs, 1000 classes), then the port's
   ``train`` entry at full width: ResNet-50, ``--pallas-fused``, batch
   212, crop 224, 1000 classes, bf16, Adam 1e-5, 4 steps and 1 eval batch.
   Checks finite loss and metrics and the kernels' launch counts (K1 16
   per train step and 16 per eval batch; K2 and K3 16 per train step);
   prints images/s, step ms and data wait over steps 2-4.
5. parity: the pallas-level ResNet-50 (kernels) against the fused-level
   one (no kernel) with identical weights, the last BN scale of every
   block nonzero (at its zero init the gradient reaching K2/K3 is exactly
   zero). The whole model on one batch: logits and loss within 2e-2 of
   max-abs, every conv3 weight and middle-BN gamma/beta gradient nonzero.
   Each of the 16 blocks alone at its full-width shape, with one input
   and one cotangent: its output within 2e-2, its conv3 weight and
   middle-BN gamma/beta gradients within 5e-2 of max-abs (bf16, rtol
   0.05 of tests/test_fused_matmul.py:203). The whole model's bf16
   gradients are not held to 5e-2: any two bf16 implementations of it
   differ by far more (PERF.md); 5b holds them in f32.
5a. f32-train: the f32 ResNet-50 pallas level at full width through the
   port's API (``ResNet(..., dtype=float32, fused_bn="pallas")`` from
   ``seeded_resnet``, ``ClassifierTask``, ``Trainer.fit``) on the training
   phase's tables: batch 212, crop 224, Adam 1e-5, 2 steps and 1 eval batch;
   finite metrics, K1 48 / K2 32 / K3 32 launches, all of the f32 variants
   (``.launches_f32``); step ms, images/s, peak GiB.
5b. f32-parity: the f32 pallas level (K1f-K3f) on one batch of 212, cuDNN
   deterministic: against the f32 fused level, logits and loss within 1e-4
   and every BN running statistic within 1e-5 of max-abs; against the same
   model through the plain versions, logits and loss within 1e-4; against
   the same model with K1f's forward and the plain versions' backward (the
   same ReLU masks), every parameter gradient within 5e-4 of max-abs (JAX's
   model-level bar); the gradients against the fused level and the
   all-plain model recorded (mask flips at this depth: PERF.md); each of
   the 16 blocks alone, output within 1e-5 of the fused level's and
   conv3/middle-BN gradients within 1e-4 of the plain backward's (the fused
   level's and the all-plain block's recorded).
5c. pad: ``bn_relu_matmul`` at JAX's awkward shape (3, 5, 7, 17) -> N 33,
   zero-padded to the kernels' 16-byte rows, in f32 and bf16: K1-K3 launched
   once each (the f32 variants in f32), forward and dy against the plain
   composition at JAX's tolerances.
6. slice: the full-width LM (vocab 8192, dim 1024, 8 heads, 4 layers, bf16,
   flash attention, seeded random weights) behind the HTTP server: 8
   slots, max_len 2048, prefill buckets 128/512/1024. Six concurrent
   greedy ``/generate`` streams over every bucket, then the same six one
   at a time; checks the streams, the kernel launch count, the kernel's
   prefill logits against reference attention, and concurrent == solo
   tokens.
7. LM training: the port's ``lm`` entry at full width (vocab 8192, dim
   1024, 8 heads of 128, 4 layers, seq 2048, batch 8, f32 params with bf16
   compute, flash attention, Adam 3e-4, concentration 0.05, seeded
   weights). Run 1: 2 epochs of 6 steps, 2 val batches, a cosine schedule,
   checkpoints, ``--sample 16``; run 2: ``--resume`` with 3 epochs, which
   continues from step 12 to 18. Checks K4's launches exactly (4 per train
   step and per val batch, plus the 4 of the ``--sample`` prefill), finite
   metrics, run 1's ``val_loss`` falling epoch over epoch and below the
   untrained model's on the same val batches (it stays above ln 8192 at
   this length: the model first sheds its initial logit scale, PERF.md),
   every checkpoint's manifest intact;
   prints steady tokens/s, step ms and data wait per step of run 1's
   second epoch.
8. LM parity at the same width on one seeded batch: the flash-attention LM
   against the reference-attention LM with the same weights (logits and
   loss within 2e-2 of max-abs; every block's qkv weight gradient nonzero
   and within 5e-2 of max-abs), and the flash Function's dq/dk/dv at b8 h8
   s2048 d128 bf16 against autograd through the plain version (within 2e-2
   of max-abs, nonzero).
9. dp: two processes on the one card, joined by gloo (NCCL takes one rank
   per card), each at batch 106 of the global 212, against one process at
   batch 212 on the same seeded data made on the card: the pallas-level
   ResNet-50 at full width takes one DDP step (loss within 2e-2, global BN
   running statistics within 2e-2 of max-abs, equal on both ranks; K1-K3
   16 launches each per rank per step), each of the 16 blocks its
   gradients (conv3, middle-BN gamma/beta summed over the ranks, within
   5e-2 of max-abs), and ZeRO-1 on and off two steps each (parameters
   equal, or within 1e-6 of max-abs). The kernels are built before the
   ranks start; each rank first checks gloo's all-reduce, broadcast and
   all-gather of CUDA tensors. Then the time of one step's collectives
   under gloo at 2 ranks and NCCL in a group of one.
10. train-flags: ``train --pallas-fused --coordinator`` (NCCL, a group of
   one) with ``--lr-schedule cosine --augment --shard-opt-state
   --pretrained <seeded ResNet-50 exported by the port> --profile-dir``
   on the 848-row table: 4 steps, 1 eval batch; finite metrics, K1-K3
   launches, the trace file, ``dsst_model.json``, an intact checkpoint
   with consolidated Adam state, the stem still the file's; prints the
   resolved decode backend.
11. augment: the device crop of a 212 x 224 x 224 batch against the CPU
   run of the same (seed, step), within 1e-4 of max-abs (TF32 off); wall
   ms per step.
12. decode: native against PIL images/s on the train table's JPEGs, with
   the libjpeg the native build links (the system's, else Pillow's bundled
   one; the headers are vendored), and native's load error where it does
   not build.
12a. photos-train (Track A's front at full width): ``datagen photos --n 424
   --size 256`` (crops of the two sample photographs the port keeps) and
   ``ingest`` (424 rows, ids 0..423, labels.json {china: 0, flower: 1}),
   then ``train --pallas-fused --model resnet50 --batch-size 212 --epochs 1
   --limit-val-batches 1`` on the ingested table at the JAX CLI's other
   defaults, alone on the card: 2 steps and 1 eval batch, finite metrics,
   K1 16 per train step and per eval batch, K2/K3 16 per train step; step
   ms, images/s and data wait of step 2; whether scikit-learn imports on
   the host (the port loads none of it).
13. lm-dp: ``lm --coordinator`` (NCCL, a group of one) at full width and 2
   layers, 4 steps and 1 val batch; K4's launches exactly.
14. resilience: (a) ``train --pallas-fused`` on the 848-row table, 2
   epochs, ``--health-policy rollback --max-consecutive-skips 1``, with the
   two steps after the first epoch's checkpoint poisoned
   (``grads.nonfinite=2@4``): ends at the clean count (8), one rollback,
   two nonfinite steps, 424 quarantined rows, K1-K3 16 launches per
   dispatched step (discarded ones included) and K1 16 per eval batch.
   (b) The guarded ResNet-50 step at batch 212 with a NaN, then a spike,
   injected: weights, Adam's moments and step, BN running statistics and
   ``task.step`` bit-equal on the card. (c) What supervision costs: the
   ResNet-50 and full-width LM steps with ``--health-policy off`` and
   ``skip`` (no fault), data on the card, in turns, 3 trials of 5 steps.
   (d) The full-width ``lm`` in a subprocess: SIGTERM after its first
   logged step, a ``preempted`` mid-epoch checkpoint, ``--resume-auto`` to
   the uninterrupted step count (K4 counted); a run SIGKILLed after its
   first checkpoint, marked INTERRUPTED by ``runs doctor`` and finished by
   ``runs doctor --resume``; ``--health-policy skip`` with one
   ``loss.spike`` (one discarded step); the save and restore times of the
   LM's checkpoint.
15. group-fit (no kernel: plain batched PyTorch on the card): ``datagen
   demand`` and ``forecast`` at their defaults (the reference's 50 SKUs x
   157 weeks, the full 75-order grid, max_iter 200, bfgs_iter 100), run as
   ``pipelines/demand_forecasting.json`` through the port's ``pipeline``
   (which also runs ``datagen bom``; this run takes the place of the
   phase's own two CLI calls, to keep the script's time): 50 groups, 7,850
   rows, every Demand_Fitted finite, 1 chunk, the tracked run FINISHED, the
   bom and sku_mapper tables written; wall time, skus/s, NM iterations,
   peak memory and the card's idle share (``nvidia-smi`` utilization
   sampled every 200 ms, read over the forecast's wall_s and over the
   task; the side runs' work included). In this process, the card against
   the CPU in float64 on 4 of those SKUs
   (max orders 1/1/1, max_iter 20, bfgs_iter 5): winning orders equal,
   params within 1e-6 relative. The golden fixture in float32: loglike
   and predict at the pinned points with the JAX test's tolerances, and
   (a process of its own beside 15a-15f, for the script's time)
   ``sarimax_fit``'s loglike for every d >= 1 order within the JAX test's
   per-order bar at that test's config (max_iter 600), but for (4, 2, 1),
   whose float32 fit lands in either of two basins in the JAX package too:
   its shortfall is printed and held finite. At the 1,024-group chunk
   shape (230,400 lanes): one NM iteration's ms, one BFGS
   value-and-gradient's seconds and peak memory.
15a. tpe (no kernel; beside 15b-15f): ``forecast --search tpe --max-evals
   1`` (the reference's 10 cut for time) through the CLI on that table at
   the default bounds: 7,850 finite rows, the run FINISHED with max_evals
   logged; seconds per round, the projected cost of 10 rounds, the idle
   share. In a process of its own, an 8-group panel at max orders 1/1/1,
   ``max_evals`` 3, on the card in float64 against the CPU in float64: identical per-group
   histories (losses within 1e-6 relative), best orders, Demand_Fitted
   within 1e-6 relative.
15b. eda (no kernel): ``eda --polish --max-evals 2 --parallelism 2`` (the
   CLI's 10 and 10 cut for time), with ``--plot`` where matplotlib
   imports (whether it does is printed), on the table's first SKU: 7 rows,
   every mse finite and positive, the best order inside the bounds, the
   PNG, 2 journaled trials; the wall time and its split over the families.
   Each Holt-Winters variant's recursion at the golden fixture's pinned
   parameters and its forecast, card against CPU in float64, within 1e-9.
15c. pipeline (the job DAG): ``full_stack.json`` and
   ``imagenet_train.json`` unchanged through the port's ``pipeline
   --task-device cuda``, each in its own workdir, to ``pipeline ok`` with
   every output they name (forecast table, predictions, ``weights.npz``,
   the lm line's ``sample_mean_true_prob``, the train line's
   ``val_top2_acc``); K4 counted by full_stack's ``lm`` task at head_dim 8;
   a spec with a failing task skips its dependent and returns 1;
   ``real_photos_train.json`` for real (``datagen photos`` -> ``ingest`` ->
   ``train --model tiny`` 8 epochs -> ``predict``): 256 rows, ids 0..255,
   labels.json, every ``pred_label`` named from the checkpoint's
   ``label_names``, ``accuracy_vs_label_index`` over 0.6; each task's
   seconds.
15d. hpo (the HPO track, host numpy; beside 15b-15c, on a thread): ``hpo
   --bytes 1e7 --max-evals 4 --parallelism 2`` (the closure regime, trials
   pinned to the card); ``datagen regression --bytes 1e8`` (the ~100 MB
   regime); two ``trial-worker`` processes with a shared secret and ``hpo
   --workers --data --secret-file`` over 200 evals, one worker SIGKILLed
   after 2 trials and started again on its address: every trial ok, the
   restarted worker's trial spans (pulled over RPC) count its evaluations,
   the sweep's process re-admitted it; a sweep SIGKILLed at its third trial
   (``--fault-plan trial.evaluate=k1@2``) and ``hpo --resume-auto`` to 4
   (tids 2 and 3 journaled, the killed run INTERRUPTED). Best alphas in
   [0, 10], seconds per trial, the card's idle share over the closure
   sweep.
15e. chaos (beside 15b-15d, on a thread): the ``chaos`` soaks of train,
   then serve, with hpo beside them, on the card, every invariant held
   (``CHAOS_SOAKS``).
15f. analysis (beside 15b-15e, on a thread): the three analysis tiers of
   the port through its CLI, one process each: ``lint --json`` rc 0;
   ``sanitize --device cuda --json`` rc 0 (the feeder workload placing on
   the card through pinned memory and its side stream, every workload
   clean); ``audit --device cuda --json`` rc 0, every hotpath entrypoint
   clean under ``torch.cuda.set_sync_debug_mode("error")`` (the
   health-guarded step under ``"warn"``, its one verdict read counted),
   every program pinned on the card, K1, K2 and K3 each launched by
   ``ops.fused_matmul.grad`` and K4 by ``ops.flash_attention.grad`` (in
   bf16). Each tier's seconds.
16. moe-lm: ``lm --ffn moe --num-experts 8 --aux-loss-weight 0.01`` at the
   LM-training width (capacity factor 1.25), 2 epochs of 4 steps, 2 val
   batches, checkpoints, ``--sample 16``: K4's launches exactly (4 per train
   step and per val batch, plus the sample prefill's 4), finite metrics,
   val_loss below the untrained model's, intact manifests, and the first
   step's ``train_loss`` equal to its next-token loss plus 0.01 x the
   blocks' aux losses recomputed on its batch (1e-5 relative); tokens/s,
   step ms, data wait, peak GiB, checkpoint bytes and save seconds.
17. moe-parity, one seeded batch at full width: the MoE LM with flash
   against reference attention (logits of the tokens routed alike in every
   block and the loss within 2e-2 of max-abs; the two bf16 roundings move
   the router's logits, so a token with a near-tie may take another
   expert: every such change explained by a top-1 margin within twice the
   token's logit difference, the capacity boundaries moved by at most two
   places per change, at most 5% of tokens routed apart; every block's qkv
   and w_up gradients nonzero and within 5e-2); one MoE layer at 8 x 2048 tokens: the index
   dispatch bit-equal to the dense one-hot plain version, routing equal,
   and the times of both, the experts' FFN and the router; f32 routing on
   the card equal to the CPU's.
18. moe-dp: two gloo ranks on the card, batch 4 each, experts split 4 + 4,
   against one process at batch 8: loss and aux within 2e-2, per-block
   qkv/w_up/router gradients within 5e-2 of max-abs and equal on both ranks.
19. ring: two gloo ranks, the sequence split 1024 + 1024: ring attention at
   causal b8 h8 s2048 d128 bf16 against plain attention (output and
   dq/dk/dv within 2e-2 of max-abs); one train step of the full-width ring
   LM against the reference LM (loss 2e-2, qkv gradients 5e-2); the hop's ms.
20. pipeline: four gloo ranks, ``PipelinedLM`` at vocab 8192, dim 1024, 8
   heads, 4 stages, max_seq 2048, f32, 4 microbatches of 2, against the
   same blocks in sequence in one process: logits within 2e-5, one
   ``PipelinedLMTask`` step's gradients within atol 1e-5 / rtol 1e-4, the
   ``pipeline_utilization`` gauge 4/7; the tick's ms.
   Each rank of 18-20 first checks gloo's all_reduce, all_gather,
   broadcast, and the port's all_to_all and ring hop on CUDA tensors, and
   prints which ops go through host memory.
21. image-serve (no kernel: a ``--pallas-fused`` checkpoint scores at the
   fused level, as the JAX resolver rebuilds it): the train-flags phase's
   ResNet-50 checkpoint behind ``serve`` in a subprocess (``chip_smoke.py
   --serve-child``) at the JAX defaults (micro-batch 8, queue depth 64,
   window 5 ms, deadline 2000 ms, 2 decode workers), then at micro-batch
   32: 32 concurrent single-image clients (8 requests each), then 3
   clients posting the val table as JSON batches of 1-20 images, twice;
   every prediction equal to ``predict``'s on the same row at the same
   batch shape; K1-K4 launched 0 times by the server and by ``predict``; a
   flood of 8 x 20 images gets 429 with Retry-After; SIGINT drains with
   rc 0. Latency p50/p99, images/s, mean batch fill, score ms per batch,
   time in queue, the card's idle share (``nvidia-smi`` sampled every
   100 ms), and the host's decode ms per image on one thread.
22. vit (no kernel: the ViT's attention is the plain version, as JAX's):
   ``train --model vit-s16`` at batch 212, crop 224, 1000 classes, 4
   steps and 1 eval batch (finite metrics, an intact checkpoint, K1-K4 0),
   then ``predict`` and ``export``, then ``train --pretrained`` from the
   export at learning rate 0 (its weights the checkpoint's, its eval loss
   the first run's within 2e-2); the card's logits against the CPU's on
   the same weights and images within 2e-2 of max-abs. Images/s, step ms
   and peak GiB.
23. ring-moe: two gloo ranks, the sequence split 1024 + 1024, the ring MoE
   LM (2 layers at the LM-training width, E 8, cf 1.25, aux weight 0.01)
   through ``LMTask``, against one process on the whole sequence with
   reference attention: the objective within 1e-4 (a tenth of the aux
   term's share); every change of expert
   explained by a top-1 margin within twice the token's router-logit
   difference, capacity boundaries moved by at most two places per change,
   at most 5% of tokens routed apart; the qkv, w_up and router gradients within
   5e-2 of max-abs on tokens routed alike (the one-process model given the
   ranks' routing) and equal on both ranks.
24. the script's total seconds, a ``kernels`` JSON line (K1-K3's entries
   carry an ``f32`` block: K1f-K3f's cases, times and f32-train launches),
   the card line, and the device JSON line last.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ATOL = 2e-2  # bf16 tolerance of tests/test_flash_attention.py:41
ATOL_F32 = 2e-5  # f32 tolerance of tests/test_flash_attention.py:23
# The mean error, over the mean magnitude of the plain version's output,
# must stay under one bf16 spacing (2^-7): atol alone is loose where
# the output is small, as it is in the long causal rows.
MEAN_REL = 2.0 ** -7
PEAK_FLOPS = {"bfloat16": 989e12,  # H100 SXM dense tensor-core peak
              "float32": 67e12,  # H100 SXM float32 outside the tensor cores
              "tf32": 495e12}  # H100 SXM dense TF32 tensor-core peak
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
LM = dict(vocab_size=8192, dim=1024, num_heads=8, num_layers=4, max_seq=2048)
SLOTS, MAX_LEN, BUCKETS = 8, 2048, (128, 512, 1024)
PROMPT_LENS = (17, 128, 300, 512, 700, 1000)  # two per bucket
NEW_TOKENS = 32
# K1-K3: (name, M, K, N) at batch 212 (M = 212 * H * W of the stage), plus
# a ragged case on no tile boundary of any of the three kernels.
FUSED_SHAPES = (
    ("stage1", 212 * 56 * 56, 64, 256),
    ("stage2", 212 * 28 * 28, 128, 512),
    ("stage3", 212 * 14 * 14, 256, 1024),
    ("stage4", 212 * 7 * 7, 512, 2048),
    ("ragged", 4133, 72, 200),
)
FUSED_RTOL, FUSED_ATOL = 0.05, 0.15  # K1 out: tests/test_fused_matmul.py:203
FUSED_REL = 2.0 ** -7  # gt, sums, dW: one bf16 spacing of the plain max-abs
PARITY_LOGITS = 2e-2  # pallas vs fused model: logits and loss, of max-abs
PARITY_GRADS = 5e-2  # conv3 and middle-BN gradients, of max-abs
# K1f-K3f: K1f's out at rtol/atol 1e-5 (tests/test_fused_matmul.py:76); K2f's
# gt within 1e-5 of the plain max-abs; the M-long sums (K2f's two, K3f's dW)
# within 1e-5 of the max-abs of an f64 sum of the same f32 terms, or no
# worse than twice the plain version's error against that sum.
FUSED_F32_TOL = 1e-5
# The f32 pallas level against the fused level at full width: logits and
# loss (JAX's 1e-5 holds at its 2-block test model; here 16 blocks and 53
# layers), every BN running statistic (JAX's rtol 1e-5, :309-313), every
# parameter gradient (JAX's model-level bar, :407), each block alone.
F32_PARITY_LOGITS = 1e-4
F32_PARITY_STATS = 1e-5
F32_PARITY_GRADS = 5e-4
F32_BLOCK_OUT, F32_BLOCK_GRADS = 1e-5, 1e-4
F32_STEPS = 2  # the f32 training phase: train steps, then 1 eval batch
# JAX's awkward-shape case (tests/test_fused_matmul.py:107-118): K 17, N 33.
PAD_SHAPE, PAD_N = (3, 5, 7, 17), 33
TRAIN_ROWS, VAL_ROWS, BATCH, STEPS = 848, 212, 212, 4
# The LM training configuration: bench.py child_lm (the repo's full-width LM).
LM_TRAIN = ["--vocab", "8192", "--dim", "1024", "--heads", "8", "--layers", "4",
            "--seq", "2048", "--batch-size", "8", "--learning-rate", "3e-4",
            "--concentration", "0.05", "--steps-per-epoch", "6", "--limit-val-batches", "2"]
LM_STEPS, LM_VAL, LM_SAMPLE = 6, 2, 16
LM_GRADS = 5e-2  # per-block qkv weight gradients, flash vs reference, of max-abs
SM_COUNT = 132  # set from the card in main()
T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


_LAP = [T_START]


def lap(what: str) -> None:
    """Print the seconds since the last mark and since the start: where the
    script's time goes."""
    now = time.perf_counter()
    print(f"time: {what} {now - _LAP[0]:.1f} s (at {now - T_START:.1f} s)", flush=True)
    _LAP[0] = now


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def toolchain(_build) -> dict:
    """What the card's host offers for building kernels."""
    import importlib.metadata
    import importlib.util
    import os

    nvcc = _build.find_nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60, check=True).stdout
    return {
        "nvcc": nvcc,
        "nvcc_release": version.strip().splitlines()[-1],
        "triton": (importlib.metadata.version("triton")
                   if importlib.util.find_spec("triton") else None),
        "cutlass_headers": os.path.isdir("/usr/local/cutlass/include"),
    }


def device_ms(fn, launches: int = 20, trials: int = 3) -> float:
    """Device time of one call: ``launches`` calls queued back to back
    behind a GPU sleep (so the host's launch overhead is hidden), timed with
    CUDA events; the median over ``trials`` of the mean per call. Inputs
    stay in the 50 MB L2, as they are when the model calls the kernel."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of GPU time to queue behind
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        means.append(start.elapsed_time(end) / launches)
    return statistics.median(means)


def kernel_phase(torch, F) -> list[dict]:
    import importlib

    from dss_ml_at_scale_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention,
    )

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")

    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        ("causal b1 h8 s128 d128", 1, 8, 128, 128, 128, True, bf16),
        ("causal b1 h8 s512 d128", 1, 8, 512, 512, 128, True, bf16),
        ("causal b1 h8 s1024 d128", 1, 8, 1024, 1024, 128, True, bf16),
        ("non-causal b1 h8 s512 d128", 1, 8, 512, 512, 128, False, bf16),
        ("causal b1 h8 sq256 sk1024 d128", 1, 8, 256, 1024, 128, True, bf16),
        ("causal b1 h8 s512 d64", 1, 8, 512, 512, 64, True, bf16),
        ("causal b1 h8 s1024 d32", 1, 8, 1024, 1024, 32, True, bf16),
        # The LM training shape.
        ("causal b8 h8 s2048 d128", 8, 8, 2048, 2048, 128, True, bf16),
        # The f32 kernel: off the serving path, held to the f32 contract;
        # at the LM training shape too.
        ("f32 causal b1 h8 s512 d128", 1, 8, 512, 512, 128, True, f32),
        ("f32 causal b1 h8 s512 d64", 1, 8, 512, 512, 64, True, f32),
        ("f32 causal b1 h8 s512 d32", 1, 8, 512, 512, 32, True, f32),
        ("f32 causal b8 h8 s2048 d128", 8, 8, 2048, 2048, 128, True, f32),
        # Heads the kernel has no tile for, zero-padded to 32: d8 is the
        # full_stack pipeline's lm (--dim 32 --heads 4), at its shape last.
        ("causal b1 h4 s24 d8", 1, 4, 24, 24, 8, True, bf16),
        ("causal b1 h4 s128 d8", 1, 4, 128, 128, 8, True, bf16),
        ("causal b1 h4 s24 d16", 1, 4, 24, 24, 16, True, bf16),
        ("causal b1 h4 s128 d16", 1, 4, 128, 128, 16, True, bf16),
        ("causal b8 h4 s24 d8", 8, 4, 24, 24, 8, True, bf16),
        # Heads above 128 (the wide kernels; 320 in slices of 256 and 64),
        # causal and not, in both dtypes; d256 also at the LM training shape.
        *((f"{dn}causal b1 h8 s2048 d{d}", 1, 8, 2048, 2048, d, causal, dtype)
          for dtype, dn_dtype in ((bf16, ""), (f32, "f32 ")) for d in (192, 256, 320, 512)
          for causal, dn in ((True, dn_dtype), (False, dn_dtype + "non-"))),
        ("causal b8 h8 s2048 d256", 8, 8, 2048, 2048, 256, True, bf16),
        # A wide head few enough to take the key-split plan per column slice.
        ("causal b1 h1 s1024 d256", 1, 1, 1024, 1024, 256, True, bf16),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for name, b, h, sq, sk, d, causal, dtype in cases:
        def mk(s):
            return torch.randn(b, h, s, d, generator=gen, device="cuda",
                               dtype=dtype)

        q, k, v = mk(sq), mk(sk), mk(sk)
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = attention_reference(q, k, v, causal=causal)
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        mean_rel = diff.mean().item() / ref.float().abs().mean().item()
        atol = ATOL if dtype == bf16 else ATOL_F32
        check(bool(torch.isfinite(out).all()), f"{name}: non-finite output")
        check(err <= atol, f"{name}: max abs err {err} > {atol}")
        check(mean_rel <= MEAN_REL,
              f"{name}: mean abs err {mean_rel} of the mean |output| > {MEAN_REL}")
        # SDPA's is_causal is top-left aligned: a mask gives the bottom-right
        # alignment when sq < sk.
        mask, is_causal = None, causal and sq == sk
        if causal and sq < sk:
            mask = (torch.arange(sq, device="cuda")[:, None] + (sk - sq)
                    >= torch.arange(sk, device="cuda")[None, :])
        pairs = sq * (sk - sq + 1) + sq * (sq - 1) // 2 if causal else sq * sk
        flops = 4 * b * h * d * pairs  # Q·Kᵀ and P·V over the visible pairs
        nbytes = b * h * d * (2 * sq + 2 * sk) * q.element_size()  # q, k, v read; o written
        t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")]
        t_bytes = nbytes / PEAK_BYTES
        row = {
            "shape": name,
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": err,
            "atol": atol,
            "mean_rel_err": mean_rel,
        }
        if dtype == bf16 and causal and sq == sk and b == 1 and h in (1, 8):
            # A serving bucket: the split plan's launch against one CTA per
            # query tile, both held to the same limits; the split output
            # must be the same from run to run.
            whole = fa._launch(q, k, v, causal, split=False)
            again = flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"{name}: split output differs between runs")
            werr = (whole.float() - ref.float()).abs()
            check(werr.max().item() <= atol, f"{name}: unsplit max abs err {werr.max().item()}")
            check(werr.mean().item() / ref.float().abs().mean().item() <= MEAN_REL,
                  f"{name}: unsplit mean abs err over the limit")
            d_pad = fa.padded_head_dim(d)
            plan = fa.split_plan(b * h * fa.launch_slices(d_pad), sq, sk, causal, SM_COUNT,
                                 **fa.plan_tiling(d_pad))
            row["split_items"] = None if plan is None else len(plan[0])
            row["split_ms"] = device_ms(lambda: fa._launch(q, k, v, causal, split=True))
            row["nosplit_ms"] = device_ms(lambda: fa._launch(q, k, v, causal, split=False))
        row.update({
            "ms": device_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "plain_ms": device_ms(lambda: attention_reference(q, k, v, causal=causal)),
            "library_ms": device_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=is_causal)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        })
        print("kernel-case " + json.dumps(row), flush=True)
        rows.append(row)
        del q, k, v, out, ref, diff
        torch.cuda.empty_cache()
    return rows


# The head-256 LM of `lm --dim 1024 --heads 4`: the bf16 wide kernel on a
# CLI path; and the same model in f32 through the API.
WIDE_LM = dict(vocab_size=8192, dim=1024, num_heads=4, num_layers=4, max_seq=2048)
WIDE_LM_CASES = (("bfloat16", 8, 2048, PARITY_LOGITS), ("float32", 8, 512, ATOL_F32))


def wide_lm_phase(torch) -> dict:
    """One causal forward of the head-256 LM through the flash kernel and
    through the reference attention, the same seeded weights, per dtype:
    logits within the dtype's bar of max-abs, and 4 launches (one a layer)
    of the bf16 wide kernel or of the f32 kernel."""
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(9)
    out = {}
    for name, batch, seq, tol in WIDE_LM_CASES:
        tokens = torch.randint(0, WIDE_LM["vocab_size"], (batch, seq), generator=gen,
                               device="cuda")
        flash_attention.launches = flash_attention.launches_wide = 0
        flash_attention.launches_f32 = 0
        logits = {}
        for attention in ("flash", "reference"):  # one model at a time
            model = seeded_lm(0, device="cuda", attention=attention,
                              dtype=getattr(torch, name), **WIDE_LM)
            with torch.inference_mode():
                logits[attention] = model(tokens).float()
            del model
        torch.cuda.synchronize()
        counts = {"launches": flash_attention.launches,
                  "launches_wide": flash_attention.launches_wide,
                  "launches_f32": flash_attention.launches_f32}
        layers = WIDE_LM["num_layers"]
        want = {"launches": layers, "launches_wide": layers if name == "bfloat16" else 0,
                "launches_f32": layers if name == "float32" else 0}
        check(counts == want, f"wide-lm {name}: launches {counts}, want {want}")
        check(bool(torch.isfinite(logits["flash"]).all()), f"wide-lm {name}: non-finite logits")
        err = _rel(logits["flash"], logits["reference"])
        check(err <= tol, f"wide-lm {name}: logits differ by {err} of max-abs > {tol}")
        out[name] = {"shape": f"b{batch} s{seq} head 256", "logits_rel_err": err, "tol": tol,
                     **counts}
        del logits, tokens
        torch.cuda.empty_cache()
    return out


def k4_variants(cases: list[dict], wide_lm: dict) -> dict:
    """K4's wide and f32 kernels for the kernels line: launches from the
    head-256 LM check, times at causal b1 h8 s2048 d256, the largest error
    over the cases each took."""
    def entry(kernel: str, shape: str, launches: int, picked) -> dict:
        case = next(c for c in cases if c["shape"] == shape)
        return {"kernel": kernel, "launches": launches,
                **{x: case[x] for x in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
                "max_abs_err": max(c["max_abs_err"] for c in cases if picked(c))}

    def head_dim(c: dict) -> int:
        return int(c["shape"].rsplit("d", 1)[-1])

    return {
        "wide": entry("flash_fwd_bf16_wide_kernel, flash_fwd_bf16_wide_lockstep_kernel",
                      "causal b1 h8 s2048 d256", wide_lm["bfloat16"]["launches_wide"],
                      lambda c: c["dtype"] == "bfloat16" and head_dim(c) > 128),
        "f32": entry("flash_fwd_f32_kernel", "f32 causal b1 h8 s2048 d256",
                     wide_lm["float32"]["launches_f32"], lambda c: c["dtype"] == "float32"),
    }


def _bound(nbytes: float, flops: float, dtype: str = "bfloat16") -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _f32_bounds(nbytes: float, macs: float) -> dict:
    """The two bounds of an f32 product of ``macs`` multiply-adds moving
    ``nbytes``: 3xTF32 (three products on the tensor cores, how K1f-K3f run
    it) and one f32 product on the CUDA cores (FFMA, the yardstick of their
    earlier designs)."""
    bound, by = _bound(nbytes, 3 * 2 * macs, "tf32")
    ffma, ffma_by = _bound(nbytes, 2 * macs, "float32")
    return {"bound_ms": bound, "bound_by": by, "bound_ffma_ms": ffma, "bound_ffma_by": ffma_by}


def _rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def fused_kernel_phase(torch) -> dict[str, list[dict]]:
    """K1-K3 against their plain versions at the path's shapes."""
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {"K1": [], "K2": [], "K3": []}

    def randn(*shape, std=1.0, mean=0.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std + mean).to(dtype)

    for name, m, k, n in FUSED_SHAPES:
        y = randn(m, k)
        y32 = y.float()
        mean = y32.mean(0)
        var = y32.square().mean(0) - mean.square()
        inv = torch.rsqrt(var + 1e-5)
        gamma = randn(k, mean=1.0, std=0.2, dtype=torch.float32)
        beta = randn(k, std=0.2, dtype=torch.float32)
        s = gamma * inv
        t = beta - mean * s
        w = randn(k, n, std=k ** -0.5)
        g = randn(m, n)
        for with_res in (False, True):
            res = randn(m, k) if with_res else None
            case = f"{name} M{m} K{k} N{n}" + (" +res" if with_res else "")
            rb = m * k * 2 if with_res else 0  # residual bytes
            # K1
            out = fm.bn_relu_matmul_fwd(y, s, t, w, res)
            torch.cuda.synchronize()
            ref = fm.bn_relu_matmul_fwd_reference(y, s, t, w, res)
            diff = (out.float() - ref.float()).abs()
            check(bool(torch.isfinite(out).all()), f"K1 {case}: non-finite output")
            bad = int((diff > FUSED_ATOL + FUSED_RTOL * ref.float().abs()).sum())
            check(bad == 0, f"K1 {case}: {bad} elements outside rtol {FUSED_RTOL} / atol {FUSED_ATOL}")
            a = torch.clamp_min(fm._z(y, s, t, res), 0.0).to(torch.bfloat16)
            bound, by = _bound(2 * m * k + rb + 2 * k * n + 2 * m * n + 8 * k, 2 * m * k * n)
            rows["K1"].append({
                "shape": case, "max_abs_err": diff.max().item(), "rel_err": _rel(out, ref),
                "ms": device_ms(lambda: fm.bn_relu_matmul_fwd(y, s, t, w, res)),
                "plain_ms": device_ms(lambda: fm.bn_relu_matmul_fwd_reference(y, s, t, w, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(a, w)),
                "bound_ms": bound, "bound_by": by,
            })
            # K2
            gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
            torch.cuda.synchronize()
            rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
            errs = {"gt": _rel(gt, rgt), "sum_g": _rel(sg, rsg), "sum_gx": _rel(sgx, rsgx)}
            for what, e in errs.items():
                check(math.isfinite(e) and e <= FUSED_REL,
                      f"K2 {case}: {what} max-abs err {e} of max-abs > {FUSED_REL}")
            bound, by = _bound(2 * m * n + 2 * k * n + 2 * m * k + rb + 16 * k + 2 * m * k + 8 * k,
                               2 * m * k * n)
            rows["K2"].append({
                "shape": case, "rel_err": max(errs.values()), **{f"rel_err_{x}": e for x, e in errs.items()},
                "max_abs_err": (gt.float() - rgt.float()).abs().max().item(),
                "ms": device_ms(lambda: fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)),
                "plain_ms": device_ms(
                    lambda: fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(g, w.t())),
                "bound_ms": bound, "bound_by": by,
            })
            # K3
            dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
            torch.cuda.synchronize()
            rdw = fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res)
            e = _rel(dw, rdw)
            check(math.isfinite(e) and e <= FUSED_REL,
                  f"K3 {case}: dW max-abs err {e} of max-abs > {FUSED_REL}")
            bound, by = _bound(2 * m * k + rb + 8 * k + 2 * m * n + 4 * k * n, 2 * m * k * n)
            rows["K3"].append({
                "shape": case, "rel_err": e, "max_abs_err": (dw - rdw).abs().max().item(),
                "ms": device_ms(lambda: fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)),
                "plain_ms": device_ms(lambda: fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(a.t(), g)),
                "bound_ms": bound, "bound_by": by,
            })
            for kname in rows:
                print(f"kernel-case {kname} " + json.dumps(rows[kname][-1]), flush=True)
        del y, y32, g, w
        torch.cuda.empty_cache()
    return rows


def fused_f32_kernel_phase(torch) -> dict[str, list[dict]]:
    """K1f-K3f (the f32 variants) against their plain versions at the
    path's shapes, in f32, with TF32 off (the plain products are full f32)."""
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    gen = torch.Generator(device="cuda").manual_seed(4)
    rows = {"K1": [], "K2": [], "K3": []}
    tol = FUSED_F32_TOL

    def randn(*shape, std=1.0, mean=0.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std + mean

    def sum_errs(got, plain, got64, plain64) -> tuple[float, float]:
        """Each result against an f64 sum of its own f32 terms, of the
        f64 sum's max-abs."""
        scale = plain64.abs().max().item()
        return ((got.double() - got64).abs().max().item() / scale,
                (plain.double() - plain64).abs().max().item() / scale)

    def summed(what: str, case: str, errs: tuple[float, float]) -> dict:
        e, p = errs
        check(math.isfinite(e) and (e <= tol or e <= 2 * p),
              f"{case}: {what} err {e} of max-abs against its f64 sum > {tol} "
              f"and > twice the plain version's {p}")
        return {f"rel_err_{what}": e, f"rel_err_plain_{what}": p}

    for name, m, k, n in FUSED_SHAPES:
        y = randn(m, k)
        mean = y.mean(0)
        var = y.square().mean(0) - mean.square()
        inv = torch.rsqrt(var + 1e-5)
        s = randn(k, mean=1.0, std=0.2) * inv
        t = randn(k, std=0.2) - mean * s
        w = randn(k, n, std=k ** -0.5)
        g = randn(m, n)
        x_hat = (y - mean) * inv
        for with_res in (False, True):
            res = randn(m, k) if with_res else None
            case = f"f32 {name} M{m} K{k} N{n}" + (" +res" if with_res else "")
            rb = m * k * 4 if with_res else 0  # residual bytes
            z = fm._z(y, s, t, res)
            a = torch.clamp_min(z, 0.0)
            # K1f
            out = fm.bn_relu_matmul_fwd(y, s, t, w, res)
            torch.cuda.synchronize()
            ref = fm.bn_relu_matmul_fwd_reference(y, s, t, w, res)
            diff = (out - ref).abs()
            check(bool(torch.isfinite(out).all()), f"K1f {case}: non-finite output")
            bad = int((diff > tol + tol * ref.abs()).sum())
            check(bad == 0, f"K1f {case}: {bad} elements outside rtol/atol {tol}")
            rows["K1"].append({
                **_f32_bounds(4 * m * k + rb + 4 * k * n + 4 * m * n + 8 * k, m * k * n),
                "shape": case, "max_abs_err": diff.max().item(), "rel_err": _rel(out, ref),
                "tol": tol,
                "ms": device_ms(lambda: fm.bn_relu_matmul_fwd(y, s, t, w, res)),
                "plain_ms": device_ms(lambda: fm.bn_relu_matmul_fwd_reference(y, s, t, w, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(a, w)),
            })
            del out, ref, diff
            # K2f
            gt, sg, sgx = fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)
            torch.cuda.synchronize()
            rgt, rsg, rsgx = fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res)
            gt_err = _rel(gt, rgt)
            check(math.isfinite(gt_err) and gt_err <= tol,
                  f"K2f {case}: gt max-abs err {gt_err} of max-abs > {tol}")
            # The ReLU mask bit for bit: gt is zero wherever the plain mask
            # is off, and, with g and W positive (no sum can cancel),
            # nonzero exactly where it is on. With random g and W, a gt that
            # cancels to exactly zero where the plain one does not is counted
            # (the tensor cores' sums, truncated, reach zero more often than
            # an FFMA chain) and fails unless the plain gt is within the gt
            # bar (1e-5 of max-abs) of zero.
            mask = z > 0
            zero = mask & (gt == 0) & (rgt != 0)
            flips = int(gt[~mask].ne(0).sum()) + int(
                (zero & (rgt.abs() > tol * rgt.abs().max())).sum())
            check(flips == 0, f"K2f {case}: {flips} elements off the plain ReLU mask")
            positive = fm.bn_relu_matmul_bwd_da(g.abs(), w.abs(), y, s, t, mean, inv, res)[0]
            check(torch.equal(positive != 0, mask),
                  f"K2f {case}: with g and W positive, gt != 0 is not the plain ReLU mask")
            row = {"shape": case, "rel_err_gt": gt_err, "mask_flips": flips,
                   "zero_where_plain_is_not": int(zero.sum()),
                   "max_abs_err": (gt - rgt).abs().max().item(), "tol": tol}
            del positive, zero
            row.update(summed("sum_g", f"K2f {case}",
                              sum_errs(sg, rsg, gt.double().sum(0), rgt.double().sum(0))))
            row.update(summed("sum_gx", f"K2f {case}", sum_errs(
                sgx, rsgx, (gt * x_hat).double().sum(0), (rgt * x_hat).double().sum(0))))
            row.update({
                **_f32_bounds(4 * m * n + 4 * k * n + 4 * m * k + rb + 16 * k + 4 * m * k + 8 * k,
                              m * k * n),
                "rel_err": max(v for key, v in row.items() if key.startswith("rel_err_")
                               and "plain" not in key),
                "ms": device_ms(lambda: fm.bn_relu_matmul_bwd_da(g, w, y, s, t, mean, inv, res)),
                "plain_ms": device_ms(
                    lambda: fm.bn_relu_matmul_bwd_da_reference(g, w, y, s, t, mean, inv, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(g, w.t())),
            })
            rows["K2"].append(row)
            del gt, rgt, mask
            # K3f: both against the f64 product of the same f32 terms (the
            # kernel's a is the plain version's bit for bit).
            dw = fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)
            torch.cuda.synchronize()
            rdw = fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res)
            dw64 = a.double().t() @ g.double()
            row = {"shape": case, "max_abs_err": (dw - rdw).abs().max().item(), "tol": tol,
                   "rel_err_vs_plain": _rel(dw, rdw)}
            row.update(summed("dw", f"K3f {case}", sum_errs(dw, rdw, dw64, dw64)))
            row.update({
                **_f32_bounds(4 * m * k + rb + 8 * k + 4 * m * n + 4 * k * n, m * k * n),
                "rel_err": row["rel_err_dw"],
                "ms": device_ms(lambda: fm.bn_relu_matmul_bwd_dw(y, s, t, g, res)),
                "plain_ms": device_ms(lambda: fm.bn_relu_matmul_bwd_dw_reference(y, s, t, g, res), 5),
                "library_ms": device_ms(lambda: torch.matmul(a.t(), g)),
            })
            rows["K3"].append(row)
            del dw, rdw, dw64, z, a, res
            for kname in rows:
                print(f"kernel-case {kname}f " + json.dumps(rows[kname][-1]), flush=True)
        del y, g, w, x_hat
        torch.cuda.empty_cache()
    return rows


def train_phase(torch) -> dict:
    """The port's datagen and train entries at full width, 4 steps + 1 eval."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    train, val = str(work / "train"), str(work / "val")
    t0 = time.perf_counter()
    for out, n, seed in ((train, TRAIN_ROWS, 0), (val, VAL_ROWS, 1)):
        rc = cli.main(["datagen", "images", "--out", out, "--n", str(n), "--classes", "1000",
                       "--size", "256", "--seed", str(seed)])
        check(rc == 0, f"datagen images exited {rc}")
    datagen_s = time.perf_counter() - t0
    args = cli.build_parser().parse_args([
        "train", "--data", train, "--val-data", val, "--model", "resnet50", "--pallas-fused",
        "--batch-size", str(BATCH), "--crop", "224", "--num-classes", "1000", "--epochs", "1",
        "--limit-val-batches", "1", "--decode-backend", "pil",
    ])
    # The main path: counts set to 0 just before, read just after.
    fm.bn_relu_matmul_fwd.launches = 0
    fm.bn_relu_matmul_bwd_da.launches = 0
    fm.bn_relu_matmul_bwd_dw.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = cli.run_train(args)
    wall = time.perf_counter() - t0
    launches = {"K1": fm.bn_relu_matmul_fwd.launches, "K2": fm.bn_relu_matmul_bwd_da.launches,
                "K3": fm.bn_relu_matmul_bwd_dw.launches}
    peak = torch.cuda.max_memory_allocated()
    epoch = summary["history"][0]
    check(summary["steps"] == STEPS, f"train ran {summary['steps']} steps, want {STEPS}")
    for key in ("train_loss", "train_acc", "grad_norm", "val_loss", "val_acc"):
        check(key in epoch and math.isfinite(epoch[key]), f"train metric {key}: {epoch.get(key)}")
    check(epoch["grad_norm"] > 0, "zero gradient norm")
    want = {"K1": 16 * STEPS + 16, "K2": 16 * STEPS, "K3": 16 * STEPS}
    check(launches == want, f"kernel launches {launches}, want {want}")
    return {
        "tables": [train, val],
        "launches": launches,
        "datagen_s": datagen_s,
        "wall_s": wall,
        "train_loss": epoch["train_loss"],
        "train_acc": epoch["train_acc"],
        "grad_norm": epoch["grad_norm"],
        "val_loss": epoch["val_loss"],
        "val_acc": epoch["val_acc"],
        "images_per_sec_steps_2_4": epoch["steady_images_per_sec"],
        "step_ms_steps_2_4": epoch["steady_step_time_s"] * 1e3,
        "data_wait_ms_steps_2_4": epoch["steady_data_wait_s"] * 1e3,
        "epoch_images_per_sec": epoch["images_per_sec"],
        "decode_backend": summary["decode_backend"],
        "peak_memory_gib": peak / 2 ** 30,
        "trace": trace_checks(torch, epoch["steady_step_time_s"] * 1e3, peak),
    }


def f32_train_phase(torch, tables, card: str) -> dict:
    """The f32 ResNet-50 pallas level at full width through the port's API
    (the JAX CLI has no f32 model flag; JAX's tests build this model):
    ``ResNet(stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock,
    num_filters=64, num_classes=1000, dtype=float32, fused_bn="pallas")``
    seeded by ``seeded_resnet``, trained by ``ClassifierTask`` under
    ``Trainer.fit`` on the training phase's tables: batch 212, crop 224,
    Adam 1e-5, 2 steps and 1 eval batch. Checks finite metrics and K1 48 /
    K2 32 / K3 32 launches, every one of them the f32 variant's."""
    from dss_ml_at_scale_tpu_torch.data import batch_loader, make_batch_reader
    from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec
    from dss_ml_at_scale_tpu_torch.models import BottleneckBlock, seeded_resnet
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, Trainer, TrainerConfig

    train, val = tables
    spec = imagenet_transform_spec(crop=224)
    model = seeded_resnet(5, device="cuda", stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock,
                          num_filters=64, num_classes=1000, dtype=torch.float32,
                          fused_bn="pallas")
    task = ClassifierTask(model=model, learning_rate=1e-5)
    trainer = Trainer(TrainerConfig(max_epochs=1, steps_per_epoch=F32_STEPS,
                                    limit_val_batches=1), device="cuda")

    def val_factory():
        return make_batch_reader(val, batch_size=BATCH, num_epochs=1, transform_spec=spec,
                                 shuffle_row_groups=False)

    # The main path: counts set to 0 just before, read just after.
    _zero_fused_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with batch_loader(train, batch_size=BATCH, num_epochs=None, transform_spec=spec) as reader:
        result = trainer.fit(task, reader, val_data_factory=val_factory)
    wall = time.perf_counter() - t0
    launches, launches_f32 = _fused_launches(), _fused_launches_f32()
    epoch = result.history[0]
    check(result.steps == F32_STEPS, f"f32 train ran {result.steps} steps, want {F32_STEPS}")
    for key in ("train_loss", "train_acc", "grad_norm", "val_loss", "val_acc"):
        check(key in epoch and math.isfinite(epoch[key]), f"f32 train metric {key}: "
              f"{epoch.get(key)}")
    want = {"K1": 16 * F32_STEPS + 16, "K2": 16 * F32_STEPS, "K3": 16 * F32_STEPS}
    check(launches == want, f"f32 train kernel launches {launches}, want {want}")
    check(launches_f32 == want, f"f32 train f32-variant launches {launches_f32}, want {want}")
    out = {
        "launches": launches, "launches_f32": launches_f32, "wall_s": wall,
        "train_loss": epoch["train_loss"], "grad_norm": epoch["grad_norm"],
        "val_loss": epoch["val_loss"],
        "step_ms_step_2": epoch["steady_step_time_s"] * 1e3,
        "images_per_sec_step_2": epoch["steady_images_per_sec"],
        "data_wait_ms_step_2": epoch["steady_data_wait_s"] * 1e3,
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    print(f"f32-train ({card}): " + json.dumps(out), flush=True)
    del model, task, trainer
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def _plain_fused_matmul(forward: bool = True):
    """The op's three wrappers swapped for their plain versions, so that the
    pallas level runs its arithmetic without the kernels: the comparison's
    plain side, which launches nothing. ``forward=False`` keeps K1 and swaps
    the backward's two: a model that takes the kernel's forward, and so its
    ReLU masks, bit for bit."""
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    saved = fm.bn_relu_matmul_fwd, fm.bn_relu_matmul_bwd_da, fm.bn_relu_matmul_bwd_dw
    if forward:
        fm.bn_relu_matmul_fwd = fm.bn_relu_matmul_fwd_reference
    fm.bn_relu_matmul_bwd_da = fm.bn_relu_matmul_bwd_da_reference
    fm.bn_relu_matmul_bwd_dw = fm.bn_relu_matmul_bwd_dw_reference
    try:
        yield
    finally:
        fm.bn_relu_matmul_fwd, fm.bn_relu_matmul_bwd_da, fm.bn_relu_matmul_bwd_dw = saved


def f32_parity_phase(torch, card: str) -> dict:
    """The f32 pallas-level ResNet-50 through K1f-K3f at full width, with
    the last BN scale of every block nonzero, on one batch of 212 at crop
    224 (cuDNN deterministic, so that its convolutions add no run-to-run
    noise). Against the f32 fused level (no kernel) with identical weights:
    logits and loss within 1e-4 of max-abs and every updated BN running
    statistic within 1e-5 of its max-abs. Against the same pallas level
    through the plain versions: logits and loss within 1e-4 of max-abs. The
    backward against the same pallas level whose backward runs the plain
    versions of K2 and K3 and whose forward runs K1f (so that both take the
    same ReLU masks, bit for bit): every parameter gradient of the whole
    model within 5e-4 of max-abs (JAX's model-level f32 bar, which bf16
    cannot meet). The whole model's gradients against the fused level and
    against the all-plain model are recorded, not held: at this depth they
    differ by up to 4e-2 of max-abs wherever two forwards differ in their
    last bits (K1f's 3xTF32 product against SGEMM's, like the fused level's
    BN against the pallas level's), as an element's ReLU argument lies
    within that difference of zero and its mask flips (PERF.md, ROADMAP).
    Then each of the 16 blocks alone at its full-width shape: output within
    1e-5 of the fused level's, conv3 and middle-BN gradients within 1e-4 of
    max-abs of those of the block whose backward runs the plain versions
    (the fused level's and the all-plain block's recorded: the same
    flips)."""
    import torch.nn.functional as F

    from dss_ml_at_scale_tpu_torch.models import seeded_resnet

    config = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000, dtype=torch.float32)
    kernel = seeded_resnet(0, device="cuda", fused_bn="pallas", **config)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in kernel.named_parameters():
            if name.endswith("bn3.weight"):  # zero-init would hide the backward
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + 0.1)
    state = {k: v.clone() for k, v in kernel.state_dict().items()}
    plain = seeded_resnet(0, device="cuda", fused_bn=True, **config)
    plain.load_state_dict(state)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def step(model):
            logits = model(x)
            loss = F.cross_entropy(logits, labels)
            loss.backward()
            torch.cuda.synchronize()
            return logits.detach(), loss.item()

        _zero_fused_launches()
        out = {"kernel": step(kernel)}
        want = {"K1": 16, "K2": 16, "K3": 16}
        check(_fused_launches() == want and _fused_launches_f32() == want,
              f"f32 parity step launched {_fused_launches()} (f32 {_fused_launches_f32()}), "
              f"want {want}")
        out["plain"] = step(plain)
        versions = seeded_resnet(0, device="cuda", fused_bn="pallas", **config)
        versions.load_state_dict(state)
        with _plain_fused_matmul():
            out["versions"] = step(versions)
        check(_fused_launches() == want, "the plain versions launched a kernel")
        # The kernels' forward, the plain versions' backward: both models
        # take the same ReLU masks, so the gradients differ by K2f and K3f.
        bwd_versions = seeded_resnet(0, device="cuda", fused_bn="pallas", **config)
        bwd_versions.load_state_dict(state)
        with _plain_fused_matmul(forward=False):
            out["bwd_versions"] = step(bwd_versions)
        check(_fused_launches() == {**want, "K1": 32},
              f"the plain backward launched {_fused_launches()}, want K1 32, K2 16, K3 16")
        check(torch.equal(out["bwd_versions"][0], out["kernel"][0]),
              "K1f's forward differs from run to run")
        check(bool(torch.isfinite(out["kernel"][0]).all()), "f32 parity: non-finite logits")
        logits_err = _rel(out["kernel"][0], out["plain"][0])
        loss_err = abs(out["kernel"][1] - out["plain"][1]) / abs(out["plain"][1])
        check(logits_err <= F32_PARITY_LOGITS, f"f32 logits differ by {logits_err} of max-abs")
        check(loss_err <= F32_PARITY_LOGITS, f"f32 loss differs by {loss_err}")
        versions_logits_err = _rel(out["kernel"][0], out["versions"][0])
        versions_loss_err = abs(out["kernel"][1] - out["versions"][1]) / abs(out["versions"][1])
        check(versions_logits_err <= F32_PARITY_LOGITS,
              f"f32 logits differ from the plain versions' by {versions_logits_err} of max-abs")
        check(versions_loss_err <= F32_PARITY_LOGITS,
              f"f32 loss differs from the plain versions' by {versions_loss_err}")
        plain_state = plain.state_dict()
        stat_errs = {name: _rel(v, plain_state[name])
                     for name, v in kernel.state_dict().items() if "running" in name}
        check(len(stat_errs) == 2 * 53, f"{len(stat_errs)} running statistics, want 106")
        worst_stat = max(stat_errs, key=stat_errs.get)
        check(stat_errs[worst_stat] <= F32_PARITY_STATS,
              f"{worst_stat} differs by {stat_errs[worst_stat]} of max-abs")

        def grad_errs(a, b) -> dict:
            theirs = dict(b.named_parameters())
            return {name: _rel(p.grad, theirs[name].grad) for name, p in a.named_parameters()}

        vs_versions = grad_errs(kernel, bwd_versions)
        check(len(vs_versions) == 161, f"{len(vs_versions)} parameters, want 161")
        for name in vs_versions:
            if name.endswith(("conv3.weight", "bn2.weight", "bn2.bias")):
                check(kernel.get_parameter(name).grad.abs().max().item() > 0,
                      f"{name}: zero gradient")
        worst = max(vs_versions, key=vs_versions.get)
        check(vs_versions[worst] <= F32_PARITY_GRADS,
              f"f32 model gradient {worst}: kernels and plain versions differ by "
              f"{vs_versions[worst]} of max-abs")
        vs_fused, versions_vs_fused = grad_errs(kernel, plain), grad_errs(versions, plain)
        vs_all_plain = grad_errs(kernel, versions)
        worst_fused = max(vs_fused, key=vs_fused.get)
        block_errs, block_fused_errs, block_all_plain_errs, out_errs = [], [], [], []
        swaps = {"versions": lambda: _plain_fused_matmul(forward=False),
                 "all_plain": _plain_fused_matmul}
        for li, count in enumerate(config["stage_sizes"], start=1):
            for j in range(count):
                blocks = {tag: getattr(model, f"layer{li}")[j] for tag, model in
                          (("kernel", kernel), ("versions", bwd_versions),
                           ("all_plain", versions), ("plain", plain))}
                hw = 56 >> (li - 1) if j else 56 >> max(li - 2, 0)  # the block's input
                xb = torch.randn(BATCH, hw, hw, blocks["kernel"].conv1.weight.shape[1],
                                 generator=gen, device="cuda")
                yb = {}
                for tag, blk in blocks.items():
                    blk.zero_grad()
                    with swaps.get(tag, contextlib.nullcontext)():
                        yb[tag] = blk(xb)
                cot = torch.randn(yb["plain"].shape, generator=gen, device="cuda")
                for tag, blk in blocks.items():
                    with swaps.get(tag, contextlib.nullcontext)():
                        yb[tag].backward(cot)
                e = _rel(yb["kernel"].detach(), yb["plain"].detach())
                check(e <= F32_BLOCK_OUT, f"f32 layer{li}.{j}: output differs by {e} of max-abs")
                out_errs.append(e)
                for attr in ("conv3.weight", "bn2.weight", "bn2.bias"):
                    grad = {tag: blk.get_parameter(attr).grad for tag, blk in blocks.items()}
                    e = _rel(grad["kernel"], grad["versions"])
                    check(e <= F32_BLOCK_GRADS, f"f32 layer{li}.{j}.{attr}: kernels and plain "
                          f"versions' gradients differ by {e} of max-abs")
                    block_errs.append(e)
                    block_fused_errs.append(_rel(grad["kernel"], grad["plain"]))
                    block_all_plain_errs.append(_rel(grad["kernel"], grad["all_plain"]))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    result = {"logits_rel_err": logits_err, "loss_rel_err": loss_err, "loss": out["kernel"][1],
              "logits_rel_err_plain_versions": versions_logits_err,
              "loss_rel_err_plain_versions": versions_loss_err,
              "running_stat_rel_err_max": stat_errs[worst_stat], "running_stat_worst": worst_stat,
              "model_grad_rel_err_max": vs_versions[worst], "model_grad_worst": worst,
              "model_grad_rel_err_median": statistics.median(vs_versions.values()),
              "model_grads_checked": len(vs_versions),
              "vs_fused_model_grad_rel_err_max": vs_fused[worst_fused],
              "vs_fused_model_grad_worst": worst_fused,
              "vs_fused_model_grad_rel_err_median": statistics.median(vs_fused.values()),
              "vs_fused_model_grads_over_5e-4": sum(e > F32_PARITY_GRADS for e in vs_fused.values()),
              "plain_versions_vs_fused_model_grad_rel_err_max": max(versions_vs_fused.values()),
              "vs_all_plain_model_grad_rel_err_max": max(vs_all_plain.values()),
              "vs_all_plain_model_grad_rel_err_median": statistics.median(vs_all_plain.values()),
              "vs_all_plain_model_grads_over_5e-4": sum(
                  e > F32_PARITY_GRADS for e in vs_all_plain.values()),
              "block_out_rel_err_max": max(out_errs),
              "block_grad_rel_err_max": max(block_errs),
              "block_grads_checked": len(block_errs),
              "vs_fused_block_grad_rel_err_max": max(block_fused_errs),
              "vs_fused_block_grad_rel_err_median": statistics.median(block_fused_errs),
              "vs_all_plain_block_grad_rel_err_max": max(block_all_plain_errs)}
    print(f"f32-parity ({card}): " + json.dumps(result), flush=True)
    del kernel, plain, versions, bwd_versions, out
    torch.cuda.empty_cache()
    return result


def _bn_relu_matmul_composition(torch, y, gamma, beta, w, eps=1e-5):
    """The plain composition of JAX's test (tests/test_fused_matmul.py:35-47):
    batch statistics differentiated by autograd, in f32."""
    k = y.shape[-1]
    yf = y.reshape(-1, k).float()
    mean = yf.mean(0)
    var = yf.square().mean(0) - mean.square()
    a = torch.clamp_min((y.float() - mean) * torch.rsqrt(var + eps) * gamma + beta, 0.0)
    return (a.reshape(-1, k) @ w.float()).reshape(*y.shape[:-1], w.shape[1])


def pad_phase(torch, card: str) -> dict:
    """``bn_relu_matmul`` on the card at JAX's awkward shape, (3, 5, 7, 17)
    -> N 33 (tests/test_fused_matmul.py:107-118): K and N are zero-padded to
    the kernels' 16-byte rows and K1-K3 run on the padded operands, in f32
    (K1f-K3f) and in bf16. f32: forward within rtol/atol 1e-5 and dy within
    rtol 1e-4 / atol 1e-5 of the plain composition; bf16: forward within
    rtol 0.05 / atol 0.15 of the f32 composition (:203) and dy within 5e-2
    of its max-abs."""
    import numpy as np

    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    rng = np.random.default_rng(42)  # JAX's _inputs, in its order
    y = rng.normal(size=PAD_SHAPE).astype(np.float32)
    rng.normal(size=PAD_SHAPE)  # its residual, unused by the awkward case
    k = PAD_SHAPE[-1]
    gamma = rng.normal(1.0, 0.2, k).astype(np.float32)
    beta = rng.normal(0.0, 0.2, k).astype(np.float32)
    w = rng.normal(0.0, 0.1, (k, PAD_N)).astype(np.float32)
    cuda = [torch.from_numpy(a).cuda() for a in (y, gamma, beta, w)]
    ref_y = cuda[0].clone().requires_grad_()
    ref = _bn_relu_matmul_composition(torch, ref_y, *cuda[1:])
    ref.sum().backward()
    result = {}
    for dtype in (torch.float32, torch.bfloat16):
        ty = cuda[0].to(dtype, copy=True).requires_grad_()
        tw = cuda[3].to(dtype)
        yf = ty.detach().reshape(-1, k).float()
        mean = yf.mean(0)
        var = yf.square().mean(0) - mean.square()
        _zero_fused_launches()
        out = fm.bn_relu_matmul(ty, cuda[1], cuda[2], mean, var, tw)
        out.float().sum().backward()
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        want = {"K1": 1, "K2": 1, "K3": 1}
        check(_fused_launches() == want, f"pad {dtype}: launches {_fused_launches()}")
        check(_fused_launches_f32() == (want if f32 else {"K1": 0, "K2": 0, "K3": 0}),
              f"pad {dtype}: f32-variant launches {_fused_launches_f32()}")
        check(tuple(out.shape) == (*PAD_SHAPE[:-1], PAD_N) and out.dtype == dtype,
              f"pad {dtype}: output {tuple(out.shape)} {out.dtype}")
        got, dy = out.detach().float(), ty.grad.float()
        fwd_err = (got - ref.detach()).abs()
        dy_err = (dy - ref_y.grad).abs()
        if f32:
            check(bool((fwd_err <= 1e-5 + 1e-5 * ref.detach().abs()).all()),
                  f"pad f32: forward off rtol/atol 1e-5 by {fwd_err.max().item()}")
            check(bool((dy_err <= 1e-5 + 1e-4 * ref_y.grad.abs()).all()),
                  f"pad f32: dy off rtol 1e-4 / atol 1e-5 by {dy_err.max().item()}")
        else:
            check(bool((fwd_err <= FUSED_ATOL + FUSED_RTOL * ref.detach().abs()).all()),
                  f"pad bf16: forward off rtol {FUSED_RTOL} / atol {FUSED_ATOL}")
            check(_rel(dy, ref_y.grad) <= PARITY_GRADS,
                  f"pad bf16: dy differs by {_rel(dy, ref_y.grad)} of max-abs")
        result[str(dtype).removeprefix("torch.")] = {
            "forward_max_abs_err": fwd_err.max().item(), "dy_max_abs_err": dy_err.max().item(),
            "dy_rel_err": _rel(dy, ref_y.grad), "launches": _fused_launches(),
            "launches_f32": _fused_launches_f32()}
    print(f"pad ({card}): " + json.dumps(result), flush=True)
    return result


def _cli_out(argv: list[str]) -> tuple[int, str]:
    """One in-process call of the port's CLI: ``(exit code, stdout)``."""
    import contextlib
    import io

    from dss_ml_at_scale_tpu_torch.config import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


def trace_checks(torch, step_ms: float, peak: int) -> dict:
    """The training phase's run read back through the operability commands:
    ``trace attribution`` finds its 4 steps, each ``train_step`` in one
    trace with that step's ``reader.next`` and ``feeder.place`` (the feeder
    thread's), compute above 0; ``telemetry --run`` has
    ``train_step_seconds`` with count 4; ``trace export`` writes flow
    events; the device monitor's peak equals the allocator's. Prints the
    per-step buckets beside the phase's measured step ms."""
    import os

    from dss_ml_at_scale_tpu_torch import telemetry
    from dss_ml_at_scale_tpu_torch.telemetry import flightrec
    from dss_ml_at_scale_tpu_torch.telemetry.device import DeviceMonitor

    monitor = DeviceMonitor(devices=["cuda:0"])
    monitor.sample()
    gauge = telemetry.get_registry().gauge("device_hbm_bytes_peak", labels=("device",))
    check(gauge.labels(device="cuda:0").value == peak,
          f"device_hbm_bytes_peak {gauge.labels(device='cuda:0').value} != "
          f"max_memory_allocated {peak}")
    run_dir = max((Path(os.environ["DSST_TRACKING_ROOT"]) / "imagenet").iterdir(),
                  key=lambda p: p.stat().st_mtime)
    rc, out = _cli_out(["trace", "attribution", "--run", str(run_dir), "--json"])
    report = json.loads(out)
    check(rc == 0 and report["steps"] == STEPS, f"trace attribution: {out[-500:]}")
    check(all(s["compute"] > 0 for s in report["per_step"]),
          f"a step without compute: {report['per_step']}")
    complete, opens = flightrec.reconstruct(flightrec.read_events(run_dir / "flightrec.jsonl"))
    check(not opens, f"the finished run left open spans {[o['name'] for o in opens]}")
    by_trace: dict = {}
    for e in complete:
        if e.get("kind") == "step":
            by_trace.setdefault(e["trace"], {})[e["name"]] = e.get("thread")
    stepped = [t for t in by_trace.values() if "train_step" in t]
    check(len(stepped) == STEPS and all(
        t.get("reader.next") == t.get("feeder.place") == "feeder-train" for t in stepped),
        f"step traces {stepped}")
    rc, out = _cli_out(["telemetry", "--run", str(run_dir), "--json"])
    snap = {m["name"]: m for m in json.loads(out)["metrics"] if not m.get("labels")}
    check(rc == 0 and snap["train_step_seconds"]["count"] == STEPS,
          f"telemetry --run: train_step_seconds {snap.get('train_step_seconds')}")
    perfetto = run_dir / "trace.json"
    rc, out = _cli_out(["trace", "export", "--run", str(run_dir), "--out", str(perfetto)])
    flows = sum(1 for e in json.loads(perfetto.read_text())["traceEvents"]
                if e["ph"] in ("s", "f"))
    check(rc == 0 and flows > 0, f"trace export: {out}, {flows} flow events")
    buckets = {k: report[f"{k}_ms_mean"] for k in ("data_wait", "transfer", "compute", "host")}
    print(f"train step attribution, ms per step (mean of {STEPS}): " + ", ".join(
        f"{k} {v:.3f}" for k, v in buckets.items())
        + f"; the phase's measured step ms (steps 2-{STEPS}) {step_ms:.3f}", flush=True)
    return {"per_step": report["per_step"], "means_ms": buckets, "flow_events": flows,
            "train_step_seconds_count": snap["train_step_seconds"]["count"],
            "train_compile_events": snap["train_compile_events_total"]["value"],
            "device_hbm_bytes_peak": peak}


def serving_ops_checks(port: int, what: str, fleet: bool = False) -> dict:
    """``slo status --json``, ``slo check`` (exit 0, or 1 naming the firing
    objective) and ``top --once`` against a running server, in process;
    with ``fleet``, ``slo status --fleet <it> <a dead port>``: the dead
    replica's column is down and the cycle ends within its budget."""
    url = f"http://127.0.0.1:{port}"
    rc, out = _cli_out(["slo", "status", "--url", url, "--json"])
    doc = json.loads(out)
    check(rc == 0 and doc["version"] == 1 and len(doc["objectives"]) == 6,
          f"slo status against {what}: rc {rc}")
    check_rc, out = _cli_out(["slo", "check", "--url", url, "--json"])
    verdict = json.loads(out)
    check((check_rc == 0 and verdict["ok"]) or (check_rc == 1 and verdict["failing"]),
          f"slo check against {what}: rc {check_rc}, {verdict}")
    rc, out = _cli_out(["top", "--url", url, "--once"])
    check(rc == 0 and "dsst top" in out and "OBJECTIVE" in out, f"top --once against {what}")
    result = {"slo_check_rc": check_rc, "failing": verdict["failing"],
              "states": {o["name"]: o["state"] for o in doc["objectives"]},
              "top_lines": len(out.splitlines())}
    if fleet:
        dead = free_port()
        t0 = time.perf_counter()
        rc, out = _cli_out(["slo", "status", "--fleet", f"127.0.0.1:{port}",
                            f"127.0.0.1:{dead}", "--fleet-timeout", "2", "--json"])
        elapsed = time.perf_counter() - t0
        view = json.loads(out)
        by = {r["endpoint"]: r for r in view["replicas"]}
        check(rc == 0 and view["up"] == 1 and by[f"127.0.0.1:{port}"]["up"]
              and not by[f"127.0.0.1:{dead}"]["up"] and elapsed < 2 + 1.0,
              f"fleet with a dead replica: {view['replicas']} in {elapsed:.2f} s")
        result["fleet"] = {"cycle_s": elapsed, "dead_outcome": by[f"127.0.0.1:{dead}"]["outcome"],
                           "merged_series": view["merged_series"]}
    print(f"slo/top against {what}: " + json.dumps(result), flush=True)
    return result



def parity_phase(torch) -> dict:
    """The pallas-level ResNet-50 against the fused-level one: the whole
    model on one batch (logits, loss; every conv3 and middle-BN gradient
    nonzero), then each of the 16 blocks alone at its full-width shape with
    one input and one cotangent (its conv3 and middle-BN gradients)."""
    import torch.nn.functional as F

    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    config = dict(stage_sizes=[3, 4, 6, 3], num_classes=1000, dtype=torch.bfloat16)
    kernel = seeded_resnet(0, device="cuda", fused_bn="pallas", **config)
    plain = seeded_resnet(0, device="cuda", fused_bn=True, **config)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in kernel.named_parameters():
            if name.endswith("bn3.weight"):  # zero-init would hide the backward
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + 0.1)
    plain.load_state_dict(kernel.state_dict())
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(BATCH, 224, 224, 3, generator=gen, device="cuda")
    labels = torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")
    before = fm.bn_relu_matmul_bwd_dw.launches
    out = {}
    for tag, model in (("kernel", kernel), ("plain", plain)):
        logits = model(x)
        loss = F.cross_entropy(logits, labels)
        loss.backward()
        out[tag] = (logits.detach(), loss.detach())
    torch.cuda.synchronize()
    check(fm.bn_relu_matmul_bwd_dw.launches == before + 16, "parity step missed the kernels")
    logits_err = _rel(out["kernel"][0], out["plain"][0])
    loss_err = abs(out["kernel"][1].item() - out["plain"][1].item()) / abs(out["plain"][1].item())
    check(bool(torch.isfinite(out["kernel"][0]).all()), "non-finite logits")
    check(logits_err <= PARITY_LOGITS, f"logits differ by {logits_err} of max-abs")
    check(loss_err <= PARITY_LOGITS, f"loss differs by {loss_err}")
    names = [n for n, _ in kernel.named_parameters()
             if n.endswith(("conv3.weight", "bn2.weight", "bn2.bias"))]
    check(len(names) == 48, f"{len(names)} conv3/bn2 parameters, want 48")
    grads = dict(plain.named_parameters())
    model_errs = []
    for name, p in kernel.named_parameters():
        if name in names:
            a, b = p.grad, grads[name].grad
            check(a is not None and a.abs().max().item() > 0, f"{name}: zero gradient")
            model_errs.append(_rel(a, b))
    # Block by block: the model-level bf16 gradients of two implementations
    # differ far beyond 5e-2 (any two, the JAX package's own BN levels
    # included), so the gradient check holds each block to one input.
    block_errs, out_errs = [], []
    for li, count in enumerate(config["stage_sizes"], start=1):
        for j in range(count):
            kb, pb = getattr(kernel, f"layer{li}")[j], getattr(plain, f"layer{li}")[j]
            hw = 56 >> (li - 1) if j else 56 >> max(li - 2, 0)  # the block's input
            xb = torch.randn(BATCH, hw, hw, kb.conv1.weight.shape[1], generator=gen,
                             device="cuda", dtype=torch.bfloat16)
            yb = {}
            for tag, blk in (("kernel", kb), ("plain", pb)):
                blk.zero_grad()
                yb[tag] = blk(xb)
            cot = torch.randn(yb["plain"].shape, generator=gen, device="cuda",
                              dtype=torch.bfloat16)
            for tag, blk in (("kernel", kb), ("plain", pb)):
                yb[tag].backward(cot)
            out_errs.append(_rel(yb["kernel"].detach(), yb["plain"].detach()))
            for attr in ("conv3.weight", "bn2.weight", "bn2.bias"):
                a = kb.get_parameter(attr).grad
                b = pb.get_parameter(attr).grad
                check(a.abs().max().item() > 0, f"layer{li}.{j}.{attr}: zero gradient")
                e = _rel(a, b)
                check(e <= PARITY_GRADS, f"layer{li}.{j}.{attr}: gradient differs by {e} of max-abs")
                block_errs.append(e)
    check(max(out_errs) <= PARITY_LOGITS, f"a block's output differs by {max(out_errs)} of max-abs")
    result = {"logits_rel_err": logits_err, "loss_rel_err": loss_err,
              "loss": out["kernel"][1].item(),
              "model_grad_rel_err_max": max(model_errs),
              "model_grad_rel_err_median": statistics.median(model_errs),
              "block_out_rel_err_max": max(out_errs),
              "block_grad_rel_err_max": max(block_errs),
              "block_grads_checked": len(block_errs)}
    del kernel, plain, out, grads
    torch.cuda.empty_cache()
    return result

def stream(port: int, prompt: list[int]) -> dict:
    """One greedy /generate: tokens, terminal line, client-side TTFT."""
    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", "/generate", json.dumps(
        {"tokens": prompt, "max_new_tokens": NEW_TOKENS}).encode(),
        {"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status != 200:
        fail(f"/generate answered {resp.status}: {resp.read()!r}")
    tokens, ttft, done = [], None, None
    for raw in iter(resp.readline, b""):
        line = json.loads(raw)
        if "done" in line:
            done = line
            break
        if ttft is None:
            ttft = time.perf_counter() - t0
        tokens.append(line["token"])
    resp.read()
    conn.close()
    return {"tokens": tokens, "done": done, "ttft_s": ttft}


def slice_phase(torch) -> dict:
    import numpy as np

    from dss_ml_at_scale_tpu_torch import telemetry
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.serving.lm import (
        LMConfig, LMEngine, TransformerDecoder,
    )
    from dss_ml_at_scale_tpu_torch.workloads.serving import serve_lm_in_thread

    t0 = time.perf_counter()
    model = seeded_lm(0, device="cuda", dtype=torch.bfloat16,
                      attention="flash", **LM)
    engine = LMEngine(
        TransformerDecoder(model, slots=SLOTS, max_len=MAX_LEN, buckets=BUCKETS),
        LMConfig(slots=SLOTS, max_len=MAX_LEN, prefill_buckets=BUCKETS,
                 queue_depth=32),
    ).start()
    handle = serve_lm_in_thread(engine)
    print(f"slice: model + engine warm in {time.perf_counter() - t0:.2f} s",
          flush=True)
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, LM["vocab_size"], n)]
               for n in PROMPT_LENS]
    try:
        # The main path: counts set to 0 just before, read just after.
        flash_attention.launches = 0
        results = [None] * len(prompts)

        def run(i):
            results[i] = stream(handle.port, prompts[i])

        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        t_start = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        wall = time.perf_counter() - t_start
        launches = flash_attention.launches
        check(all(r is not None for r in results), "a concurrent stream did not finish")
        for n, r in zip(PROMPT_LENS, results):
            check(r["done"] is not None and r["done"]["done"] == "max_tokens",
                  f"prompt {n}: stream ended {r['done']}")
            check(len(r["tokens"]) == NEW_TOKENS == r["done"]["tokens"],
                  f"prompt {n}: {len(r['tokens'])} tokens streamed")
            check(all(0 <= t < LM["vocab_size"] for t in r["tokens"]),
                  f"prompt {n}: token out of range")
        want = len(prompts) * LM["num_layers"]
        check(launches == want,
              f"flash kernel launched {launches} times, want {want} "
              "(prefills x layers)")

        solo = [stream(handle.port, p) for p in prompts]
        for n, r, s in zip(PROMPT_LENS, results, solo):
            check(r["tokens"] == s["tokens"],
                  f"prompt {n}: concurrent tokens differ from solo")
        ops = serving_ops_checks(handle.port, "serve-lm")

        snap = {m["name"]: m for m in telemetry.snapshot()["metrics"]
                if m["type"] == "histogram" and not m["labels"]}
    finally:
        handle.close()

    with torch.inference_mode():
        tokens = torch.tensor([prompts[3]], device="cuda")  # 512: one bucket
        got = model(tokens)
        ref = model(tokens, attention="reference")
    scale = ref.abs().max().item()
    rel = (got - ref).abs().max().item() / scale
    check(bool(torch.isfinite(got).all()), "non-finite prefill logits")
    check(rel <= ATOL, f"flash prefill logits differ from reference by {rel} of max-abs")

    ttfts = [r["ttft_s"] for r in results]
    n_tokens = sum(len(r["tokens"]) for r in results)

    def mean_ms(name):
        m = snap[name]
        return m["sum"] / m["count"] * 1e3 if m["count"] else None

    return {
        "launches": launches,
        "prefill_logits_rel_err": rel,
        "concurrent_streams": len(prompts),
        "tokens": n_tokens,
        "distinct_tokens": len({t for r in results for t in r["tokens"]}),
        "wall_s": wall,
        "tokens_per_s": n_tokens / wall,
        "ttft_ms_median": statistics.median(ttfts) * 1e3,
        "ttft_ms_max": max(ttfts) * 1e3,
        "prefill_ms_mean": mean_ms("lm_prefill_seconds"),
        "decode_step_ms_mean": mean_ms("lm_decode_step_seconds"),
        "slo_top": ops,
    }


def lm_train_phase(torch, card: str) -> dict:
    """The port's lm entry at full width: run 1 with checkpoints, run 2
    resumed from them; K4's launches counted over each run."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

    from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, token_batches
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.parallel import LMTask

    # The untrained model (the lm entry's seed-0 weights) on the entry's val
    # batches (chain seed 0, sample seed 100000).
    stream = TokenStreamConfig(vocab_size=8192, batch_size=8, seq_len=2048,
                               concentration=0.05, seed=0)
    task = LMTask(model=seeded_lm(0, device="cuda", attention="flash", **LM))
    untrained = statistics.mean(
        float(task.eval_step({"tokens": torch.as_tensor(b["tokens"], device="cuda")})["val_loss"])
        for b in token_batches(stream, LM_VAL, sample_seed=100_000))
    del task
    torch.cuda.empty_cache()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_lm_")
    runs = []
    for epochs, extra in ((2, ["--lr-schedule", "cosine", "--sample", str(LM_SAMPLE)]),
                          (3, ["--resume"])):
        args = cli.build_parser().parse_args(
            ["lm", *LM_TRAIN, "--epochs", str(epochs), "--checkpoint-dir", ckpt, *extra])
        # The main path: counts set to 0 just before, read just after.
        flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = cli.run_lm(args)
        summary["wall_s"] = time.perf_counter() - t0
        summary["launches"] = flash_attention.launches
        summary["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"lm-train run {len(runs) + 1}: " + json.dumps(
            {k: v for k, v in summary.items() if k not in ("history", "sample_tokens")}
            | {"val_loss_by_epoch": [h["val_loss"] for h in summary["history"]]}), flush=True)
        runs.append(summary)
    first, resumed = runs
    layers = 4
    want = [layers * (2 * LM_STEPS + 2 * LM_VAL) + layers,  # + the --sample prefill
            layers * (LM_STEPS + LM_VAL)]
    check([r["launches"] for r in runs] == want,
          f"lm: K4 launched {[r['launches'] for r in runs]} times, want {want}")
    check(first["steps"] == 2 * LM_STEPS, f"lm run 1 ran {first['steps']} steps")
    check(resumed["steps"] == 3 * LM_STEPS and [h["epoch"] for h in resumed["history"]] == [2],
          f"lm --resume ran to step {resumed['steps']}, epochs "
          f"{[h['epoch'] for h in resumed['history']]}; want step 18 from step 12")
    for run in runs:
        for h in run["history"]:
            for key in ("train_loss", "train_ppl", "grad_norm", "val_loss", "val_ppl"):
                check(math.isfinite(h[key]), f"lm metric {key}: {h[key]}")
    val = [h["val_loss"] for h in first["history"]]
    check(all(a > b for a, b in zip(val, val[1:])) and val[-1] < untrained,
          f"lm val_loss by epoch {val}: not falling below the untrained model's {untrained}")
    check(len(first["sample_tokens"]) == 4 + LM_SAMPLE, "lm --sample length")
    report = integrity.verify_checkpoint_dir(ckpt)
    check(report and all(r["status"] == "intact" for r in report),
          f"lm checkpoints not intact: {report}")
    steady = first["history"][-1]  # run 1's second epoch: kernels built, caches warm
    for what, value in (("steady tokens/s", steady["steady_tokens_per_sec"]),
                        ("step ms", steady["steady_step_time_s"] * 1e3),
                        ("data wait ms per step", steady["steady_data_wait_s"] * 1e3)):
        print(f"lm-train {what} (steps 2-6 of epoch 1, run 1): {value} ({card})", flush=True)
    keys = ("steps", "train_loss", "val_loss", "val_ppl", "entropy_floor_nats",
            "best_checkpoint", "tokens_per_sec", "steady_tokens_per_sec", "lr_schedule",
            "sample_mean_true_prob", "sample_chance_prob", "wall_s", "launches",
            "peak_memory_gib")
    return {
        "untrained_val_loss": untrained,
        "ln_vocab": math.log(8192),
        "runs": [{k: r[k] for k in keys if k in r} for r in runs],
        "checkpoints": [r["step"] for r in report],
        "launches": sum(r["launches"] for r in runs),
        "steady_tokens_per_sec": steady["steady_tokens_per_sec"],
        "steady_step_ms": steady["steady_step_time_s"] * 1e3,
        "steady_data_wait_ms": steady["steady_data_wait_s"] * 1e3,
        "epochs": [{k: h[k] for k in ("epoch", "steps", "epoch_time_s", "tokens_per_sec",
                                      "steady_tokens_per_sec", "steady_step_time_s",
                                      "steady_data_wait_s", "train_loss", "val_loss")
                    if k in h} for r in runs for h in r["history"]],
    }


def lm_parity_phase(torch) -> dict:
    """The flash-attention LM against the reference-attention LM on one
    seeded batch at full width, then the flash Function's gradients against
    autograd through the plain version at the training shape."""
    from dss_ml_at_scale_tpu_torch.models import next_token_loss, seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import (
        attention_reference, flash_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, 8192, (8, 2048), generator=gen, device="cuda")
    out = {}
    before = flash_attention.launches
    for attention in ("flash", "reference"):  # one model at a time
        model = seeded_lm(0, device="cuda", attention=attention, **LM).train()
        logits = model(tokens)
        loss = next_token_loss(logits, tokens)
        loss.backward()
        torch.cuda.synchronize()
        out[attention] = (logits.detach(), loss.detach(),
                          [b.qkv.weight.grad.clone() for b in model.blocks])
        del model, logits, loss
        torch.cuda.empty_cache()
    check(flash_attention.launches == before + 4, "the flash LM missed the kernel")
    logits_err = _rel(out["flash"][0], out["reference"][0])
    loss_err = abs(out["flash"][1].item() - out["reference"][1].item()) / abs(
        out["reference"][1].item())
    check(bool(torch.isfinite(out["flash"][0]).all()), "non-finite flash LM logits")
    check(logits_err <= PARITY_LOGITS, f"LM logits differ by {logits_err} of max-abs")
    check(loss_err <= PARITY_LOGITS, f"LM loss differs by {loss_err}")
    qkv_errs = []
    for i, (a, b) in enumerate(zip(out["flash"][2], out["reference"][2])):
        check(a.abs().max().item() > 0, f"block {i}: zero qkv gradient through the kernel")
        qkv_errs.append(_rel(a, b))
        check(qkv_errs[-1] <= LM_GRADS, f"block {i}: qkv gradient differs by {qkv_errs[-1]}")
    del out
    torch.cuda.empty_cache()

    g = torch.randn(8, 8, 2048, 128, generator=gen, device="cuda", dtype=torch.bfloat16)
    grads = {}
    for tag in ("flash", "plain"):
        leaves = [torch.randn(8, 8, 2048, 128, generator=torch.Generator(device="cuda")
                              .manual_seed(6 + i), device="cuda", dtype=torch.bfloat16)
                  .requires_grad_() for i in range(3)]
        fn = flash_attention if tag == "flash" else attention_reference
        o = fn(*leaves, causal=True)
        check(o.grad_fn is not None, f"{tag} attention output has no grad_fn")
        o.backward(g)
        torch.cuda.synchronize()
        grads[tag] = [t.grad for t in leaves]
        del leaves, o
        torch.cuda.empty_cache()
    fn_errs = {}
    for name, a, b in zip(("dq", "dk", "dv"), grads["flash"], grads["plain"]):
        check(a.abs().max().item() > 0, f"flash {name} is zero")
        fn_errs[name] = _rel(a, b)
        check(fn_errs[name] <= ATOL, f"flash {name} differs by {fn_errs[name]} of max-abs")
    del grads
    torch.cuda.empty_cache()
    return {"logits_rel_err": logits_err, "loss_rel_err": loss_err,
            "qkv_grad_rel_err": qkv_errs, "function_grad_rel_err": fn_errs}


# ---------------------------------------------------------------------------
# Slice 6: data parallelism, train's remaining flags, augment, decode
# ---------------------------------------------------------------------------

DP_WORLD = 2  # ranks of the dp phase, both on the one card (gloo)
DP_ZERO_STEPS = 2


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Env:
    """Environment variables set for a block and restored after it."""

    def __init__(self, **values):
        self.values = values

    def __enter__(self):
        import os

        self.saved = {k: os.environ.get(k) for k in self.values}
        os.environ.update(self.values)

    def __exit__(self, *exc):
        import os

        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_model(torch):
    """The pallas-level ResNet-50 at full width, seed-0 weights, the last BN
    scale of every block nonzero (its zero init hides the backward)."""
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet

    model = seeded_resnet(0, device="cuda", fused_bn="pallas", stage_sizes=[3, 4, 6, 3],
                          num_classes=1000, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bn3.weight"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02 + 0.1)
    return model


def dp_batch(torch, step: int = 0):
    """The global batch of step ``step``: 212 seeded images and labels, made
    on the card."""
    gen = torch.Generator(device="cuda").manual_seed(10 + step)
    x = torch.randn(BATCH, 224, 224, 3, generator=gen, device="cuda")
    return x, torch.randint(0, 1000, (BATCH,), generator=gen, device="cuda")


def allreduce_ms(torch, model, trials: int = 3) -> float:
    """Host ms of the collectives one data-parallel step of ``model`` issues,
    issued alone on this process group: every BatchNorm's forward sums
    (2K+1 floats) and backward sums (2K), then the gradient all-reduce of
    every parameter in f32 (DDP's buckets, as one tensor)."""
    import torch.distributed as dist

    from dss_ml_at_scale_tpu_torch.models.resnet import PlainBatchNorm
    from dss_ml_at_scale_tpu_torch.ops.fused_norm import BatchNorm

    widths = [m.weight.numel() for m in model.modules()
              if isinstance(m, (BatchNorm, PlainBatchNorm))]
    small = [torch.zeros(2 * k + 1, device="cuda") for k in widths] + [
        torch.zeros(2 * k, device="cuda") for k in widths]
    grads = torch.zeros(sum(p.numel() for p in model.parameters()), device="cuda")
    times = []
    for _ in range(trials + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in small:
            dist.all_reduce(t)
        dist.all_reduce(grads)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def dp_work(torch, rank: int, world: int) -> dict:
    """What the dp phase computes on rank ``rank`` of ``world`` (world 1:
    the one-process reference at the global batch): one train step of the
    whole model under DDP (loss, running statistics, K1-K3 launches); each
    of the 16 blocks at its full-width shape with one input and one
    cotangent (its conv3 and middle-BN gradients, summed over the ranks);
    with ranks, two steps with ZeRO-1 off and on."""
    import torch.distributed as dist

    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, Trainer, TrainerConfig

    rows = slice(rank * BATCH // world, (rank + 1) * BATCH // world)
    out: dict = {"rank": rank, "world": world, "rows": rows.stop - rows.start}

    def step(task, s=0):
        x, labels = dp_batch(torch, s)
        return task.train_step({"image": x[rows].contiguous(), "label": labels[rows].contiguous()})

    task = ClassifierTask(model=dp_model(torch), learning_rate=1e-5)
    Trainer(TrainerConfig(), device="cuda").data_parallel(task)
    # The main path of this phase: counts set to 0 just before, read after.
    fm.bn_relu_matmul_fwd.launches = 0
    fm.bn_relu_matmul_bwd_da.launches = 0
    fm.bn_relu_matmul_bwd_dw.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(task)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t0) * 1e3
    out["launches"] = {"K1": fm.bn_relu_matmul_fwd.launches,
                       "K2": fm.bn_relu_matmul_bwd_da.launches,
                       "K3": fm.bn_relu_matmul_bwd_dw.launches}
    loss = metrics["train_loss"].float().reshape(1)
    if world > 1:
        dist.all_reduce(loss)
        loss /= world
    out["loss"] = loss.item()
    out["running"] = {n: b.float().cpu() for n, b in task.model.named_buffers() if "running" in n}
    del task
    torch.cuda.empty_cache()

    model = dp_model(torch)
    grads = {}
    for li, count in enumerate((3, 4, 6, 3), start=1):
        for j in range(count):
            blk = getattr(model, f"layer{li}")[j]
            hw = 56 >> (li - 1) if j else 56 >> max(li - 2, 0)  # the block's input
            gen = torch.Generator(device="cuda").manual_seed(100 * li + j)
            xb = torch.randn(BATCH, hw, hw, blk.conv1.weight.shape[1], generator=gen,
                             device="cuda", dtype=torch.bfloat16)
            blk.zero_grad()
            yb = blk(xb[rows].contiguous())
            cot = torch.randn((BATCH, *yb.shape[1:]), generator=gen, device="cuda",
                              dtype=torch.bfloat16)
            yb.backward(cot[rows].contiguous())
            for attr in ("conv3.weight", "bn2.weight", "bn2.bias"):
                g = blk.get_parameter(attr).grad.float()
                if world > 1:
                    dist.all_reduce(g)
                grads[f"layer{li}.{j}.{attr}"] = g.cpu()
            del xb, yb, cot
    out["block_grads"] = grads
    if world > 1:
        out["allreduce_ms"] = allreduce_ms(torch, model)
    del model
    torch.cuda.empty_cache()

    if world > 1:
        params, state_bytes, warm_ms = {}, {}, {}
        for zero in (False, True):
            task = ClassifierTask(model=dp_model(torch), learning_rate=1e-5)
            Trainer(TrainerConfig(shard_opt_state=zero), device="cuda").data_parallel(task)
            for s in range(DP_ZERO_STEPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(task, s)
                torch.cuda.synchronize()
                warm_ms[zero] = (time.perf_counter() - t0) * 1e3  # kept: the last step's
            params[zero] = {n: p.detach().float().cpu() for n, p in task.model.named_parameters()}
            local = task.optimizer.optim if zero else task.optimizer
            state_bytes[zero] = sum(t.numel() * t.element_size() for st in local.state.values()
                                    for t in st.values() if torch.is_tensor(t))
            del task
            torch.cuda.empty_cache()
        out["zero1_rel_err"] = max(_rel(params[True][n], params[False][n]) for n in params[False])
        out["zero1_exact"] = all(torch.equal(params[True][n], params[False][n])
                                 for n in params[False])
        out["adam_state_bytes"] = {"replicated": state_bytes[False], "zero1": state_bytes[True]}
        out["warm_step_ms"] = {"replicated": warm_ms[False], "zero1": warm_ms[True]}
    return out


def dp_phase(torch, card: str) -> dict:
    """Two processes on the one card (gloo: NCCL takes one rank per card)
    against one process at the global batch: loss, global BN running
    statistics, per-block gradients, K1-K3 launches per rank, ZeRO-1 on and
    off; then the same collectives' time on NCCL in a group of one."""
    from dss_ml_at_scale_tpu_torch.runtime import initialize_distributed, shutdown_distributed

    ref = dp_work(torch, 0, 1)
    torch.cuda.empty_cache()
    work = _spawn_ranks("dp", DP_WORLD)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(DP_WORLD)]
    want = {"K1": 16, "K2": 16, "K3": 16}
    for r in ranks:
        check(r["launches"] == want, f"dp rank {r['rank']}: kernel launches {r['launches']}, "
              f"want {want} per step")
    loss_err = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    check(math.isfinite(ranks[0]["loss"]) and loss_err <= PARITY_LOGITS,
          f"dp loss {ranks[0]['loss']} vs one process {ref['loss']}")
    stats_err = max(_rel(ranks[0]["running"][n], v) for n, v in ref["running"].items())
    check(stats_err <= PARITY_LOGITS, f"dp running statistics differ by {stats_err} of max-abs")
    check(all(torch.equal(ranks[0]["running"][n], ranks[1]["running"][n]) for n in ref["running"]),
          "the ranks' running statistics differ")
    grad_errs = {n: _rel(ranks[0]["block_grads"][n], g) for n, g in ref["block_grads"].items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= PARITY_GRADS,
          f"dp {worst}: gradient differs by {grad_errs[worst]} of max-abs")
    check(min(g.abs().max().item() for g in ranks[0]["block_grads"].values()) > 0,
          "a block gradient is zero")
    zero = ranks[0]
    check(zero["zero1_exact"] or zero["zero1_rel_err"] <= 1e-6,
          f"ZeRO-1 parameters differ from replicated Adam's by {zero['zero1_rel_err']} of max-abs")
    port = free_port()
    initialize_distributed(f"127.0.0.1:{port}", 1, 0, device="cuda")  # NCCL, a group of one
    try:
        model = dp_model(torch)
        nccl_ms = allreduce_ms(torch, model)
        del model
    finally:
        shutdown_distributed()
    torch.cuda.empty_cache()
    result = {
        "ranks": DP_WORLD, "rows_per_rank": ranks[0]["rows"],
        "launches_per_rank": [r["launches"] for r in ranks],
        "loss": ranks[0]["loss"], "loss_one_process": ref["loss"], "loss_rel_err": loss_err,
        "running_stats_rel_err_max": stats_err,
        "block_grad_rel_err_max": grad_errs[worst], "block_grads_checked": len(grad_errs),
        "zero1_exact": zero["zero1_exact"], "zero1_rel_err": zero["zero1_rel_err"],
        "adam_state_bytes_per_rank": zero["adam_state_bytes"],
        "first_step_ms_two_ranks": [r["step_ms"] for r in ranks],
        "first_step_ms_one_process": ref["step_ms"],
        "second_step_ms_two_ranks": [r["warm_step_ms"] for r in ranks],
        "allreduce_ms_per_step_gloo_2_ranks": [r["allreduce_ms"] for r in ranks],
        "allreduce_ms_per_step_nccl_1_rank": nccl_ms,
    }
    print(f"dp ({card}; two ranks on one card are no scaling result): " + json.dumps(result),
          flush=True)
    return result


def train_flags_phase(torch, tables, card: str) -> dict:
    """``train`` through ``--coordinator`` (NCCL, a group of one) with the
    cosine schedule, on-device augmentation, ZeRO-1, pretrained weights
    exported from seeded ones, a profiling window and checkpoints."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.models import seeded_resnet
    from dss_ml_at_scale_tpu_torch.models.pretrained import export_torchvision
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

    train, val = tables
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_flags_"))
    source = seeded_resnet(7, device="cpu", stage_sizes=[3, 4, 6, 3], num_classes=1000,
                           torch_padding=True, fused_bn="pallas")
    export_torchvision(source, work / "pretrained.npz")
    args = cli.build_parser().parse_args([
        "train", "--data", train, "--val-data", val, "--model", "resnet50", "--pallas-fused",
        "--batch-size", str(BATCH), "--crop", "224", "--num-classes", "1000", "--epochs", "1",
        "--limit-val-batches", "1", "--coordinator", f"127.0.0.1:{free_port()}",
        "--lr-schedule", "cosine", "--augment", "--shard-opt-state",
        "--pretrained", str(work / "pretrained.npz"), "--profile-dir", str(work / "trace"),
        "--profile-start-step", "1", "--profile-num-steps", "2",
        "--checkpoint-dir", str(work / "ckpt"),
    ])
    # The main path: counts set to 0 just before, read just after.
    fm.bn_relu_matmul_fwd.launches = 0
    fm.bn_relu_matmul_bwd_da.launches = 0
    fm.bn_relu_matmul_bwd_dw.launches = 0
    t0 = time.perf_counter()
    with _Env(NUM_PROCESSES="1", PROCESS_ID="0"):
        summary = cli.run_train(args)
    wall = time.perf_counter() - t0
    launches = {"K1": fm.bn_relu_matmul_fwd.launches, "K2": fm.bn_relu_matmul_bwd_da.launches,
                "K3": fm.bn_relu_matmul_bwd_dw.launches}
    epoch = summary["history"][0]
    check(summary["steps"] == STEPS, f"train-flags ran {summary['steps']} steps, want {STEPS}")
    check(summary["process_count"] == 1, f"train-flags process count {summary['process_count']}")
    for key in ("train_loss", "train_acc", "grad_norm", "val_loss", "val_acc"):
        check(key in epoch and math.isfinite(epoch[key]), f"train-flags metric {key}")
    want = {"K1": 16 * STEPS + 16, "K2": 16 * STEPS, "K3": 16 * STEPS}
    check(launches == want, f"train-flags kernel launches {launches}, want {want}")
    traces = sorted(p.name for p in (work / "trace").glob("*.json"))
    check(traces == ["trace_rank0_steps1-3.json"], f"train-flags traces {traces}")
    meta = json.loads((work / "ckpt" / "dsst_model.json").read_text())
    check(meta["torch_padding"] is True and meta["lr_schedule"] == "cosine"
          and meta["decay_steps"] == STEPS, f"train-flags dsst_model.json {meta}")
    report = integrity.verify_checkpoint_dir(work / "ckpt")
    check([r["step"] for r in report] == [STEPS] and report[0]["status"] == "intact",
          f"train-flags checkpoints {report}")
    state = torch.load(work / "ckpt" / str(STEPS) / "state.pt", map_location="cpu",
                       weights_only=True)
    # Adam moves a weight by a few lr (1e-5) at most in a step: the
    # trained stem is the pretrained file's within four such steps.
    drift = (state["model"]["conv1.weight"] - source.state_dict()["conv1.weight"]).abs().max()
    check(drift.item() <= 4 * 3e-5, f"train-flags stem moved {drift.item()} from the file")
    check(len(state["optimizer"]["state"]) == len(list(source.parameters())),
          "the ZeRO-1 checkpoint lacks consolidated optimizer state")
    print(f"train-flags: decode backend {summary['decode_backend']} (auto resolved)", flush=True)
    result = {
        "launches": launches, "wall_s": wall, "decode_backend": summary["decode_backend"],
        "traces": traces, "trace_bytes": (work / "trace" / traces[0]).stat().st_size,
        "train_loss": epoch["train_loss"], "val_loss": epoch["val_loss"],
        "images_per_sec_steps_2_4": epoch.get("steady_images_per_sec"),
        "step_ms_steps_2_4": epoch.get("steady_step_time_s", math.nan) * 1e3,
        "stem_drift_from_pretrained": drift.item(),
        "checkpoint_dir": str(work / "ckpt"),
    }
    print(f"train-flags ({card}): " + json.dumps(result), flush=True)
    return result


def augment_phase(torch, card: str) -> dict:
    """The device crop against the CPU run of the same (seed, step) and
    batch, TF32 off; wall ms per step (host draws, device crop) and the
    crop's device ms alone."""
    from dss_ml_at_scale_tpu_torch.data.augment import (
        AugmentConfig, ThreefryKey, augment_for_step, crop_flip, draws,
    )

    gen = torch.Generator().manual_seed(4)
    x = torch.randn(BATCH, 224, 224, 3, generator=gen)
    want = augment_for_step(3, x, 224)
    xd = x.cuda()
    got = augment_for_step(3, xd, 224)
    torch.cuda.synchronize()
    err = _rel(got.cpu(), want)
    check(bool(torch.isfinite(got).all()) and err <= 1e-4,
          f"augment: device crop differs from the CPU's by {err} of max-abs")
    times = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        augment_for_step(3, xd, 224)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    drawn = [torch.as_tensor(d, device="cuda") for d in
             draws(ThreefryKey.from_seed(0).fold_in(3), BATCH, 224, 224, AugmentConfig())]
    result = {"rel_err": err, "wall_ms_per_step": statistics.median(times),
              "crop_device_ms": device_ms(lambda: crop_flip(xd, 224, *drawn), 10),
              "batch": BATCH, "crop": 224}
    print(f"augment ({card}): " + json.dumps(result), flush=True)
    del xd, got
    torch.cuda.empty_cache()
    return result


def decode_phase(tables, card: str) -> dict:
    """Native against PIL decode of the train table's JPEGs on this host;
    where native does not build, its load error."""
    import os

    import numpy as np
    import pyarrow.parquet as pq

    from dss_ml_at_scale_tpu_torch import native
    from dss_ml_at_scale_tpu_torch.data import DeltaTable
    from dss_ml_at_scale_tpu_torch.data.transform import decode_resize_crop

    jpegs = pq.read_table(DeltaTable(tables[0]).file_uris(), columns=["content"]).column(
        "content").to_pylist()
    _, libjpeg = native.jpeg_library()
    result = {"system_jpeglib_h": Path("/usr/include/jpeglib.h").exists(),
              "libjpeg": str(libjpeg) if libjpeg is not None else None, "images": len(jpegs),
              "host_cores": os.cpu_count()}
    print(f"decode: system jpeglib.h {'found' if result['system_jpeglib_h'] else 'missing'}; "
          f"linking {result['libjpeg']} (headers vendored beside the source)", flush=True)
    t0 = time.perf_counter()
    pil = np.stack([decode_resize_crop(b) for b in jpegs[:BATCH]])
    result["pil_images_per_sec_1_thread"] = BATCH / (time.perf_counter() - t0)
    if native.native_available():
        for threads, key in ((1, "native_images_per_sec_1_thread"),
                             (None, "native_images_per_sec_all_cores")):
            t0 = time.perf_counter()
            images, ok = native.decode_jpeg_batch(jpegs, num_threads=threads)
            result[key] = len(jpegs) / (time.perf_counter() - t0)
            check(bool(ok.all()), "native decode rejected a JPEG of the table")
        diff = np.abs(images[:BATCH] - pil)
        result["native_vs_pil_mean_abs"] = float(diff.mean())
        result["native_vs_pil_max_abs"] = float(diff.max())
        check(diff.mean() < 0.01 and diff.max() < 0.15,
              f"native decode differs from PIL by mean {diff.mean()} max {diff.max()}")
    else:
        result["native_load_error"] = native.load_error()
        print(f"decode: native unavailable: {native.load_error()}", flush=True)
    print(f"decode ({card}; host CPU): " + json.dumps(result), flush=True)
    return result


def lm_dp_phase(torch, card: str) -> dict:
    """``lm --coordinator`` on NCCL in a group of one, at full width and half
    the depth of the LM-training phase: 4 steps and 1 val batch."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention

    layers, steps = 2, 4
    argv = [a for a in LM_TRAIN]
    argv[argv.index("--layers") + 1] = str(layers)
    argv[argv.index("--steps-per-epoch") + 1] = str(steps)
    argv[argv.index("--limit-val-batches") + 1] = "1"
    args = cli.build_parser().parse_args(
        ["lm", *argv, "--epochs", "1", "--coordinator", f"127.0.0.1:{free_port()}"])
    # The main path: counts set to 0 just before, read just after.
    flash_attention.launches = 0
    t0 = time.perf_counter()
    with _Env(NUM_PROCESSES="1", PROCESS_ID="0"):
        summary = cli.run_lm(args)
    wall = time.perf_counter() - t0
    launches = flash_attention.launches
    check(launches == layers * (steps + 1), f"lm-dp: K4 launched {launches} times, "
          f"want {layers * (steps + 1)}")
    check(summary["steps"] == steps and summary["process_count"] == 1,
          f"lm-dp ran {summary['steps']} steps in {summary['process_count']} processes")
    for key in ("train_loss", "val_loss", "val_ppl"):
        check(math.isfinite(summary[key]), f"lm-dp metric {key}: {summary[key]}")
    result = {"launches": launches, "wall_s": wall, "layers": layers,
              **{k: summary[k] for k in ("steps", "train_loss", "val_loss", "tokens_per_sec",
                                         "steady_tokens_per_sec", "device")}}
    print(f"lm-dp ({card}): " + json.dumps(result), flush=True)
    return result


def _counter(name: str) -> float:
    from dss_ml_at_scale_tpu_torch import telemetry

    return next((m["value"] for m in telemetry.snapshot()["metrics"]
                 if m["name"] == name and not m.get("labels")), 0.0)


def _fused_launches() -> dict:
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    return {"K1": fm.bn_relu_matmul_fwd.launches, "K2": fm.bn_relu_matmul_bwd_da.launches,
            "K3": fm.bn_relu_matmul_bwd_dw.launches}


def _fused_launches_f32() -> dict:
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    return {"K1": fm.bn_relu_matmul_fwd.launches_f32,
            "K2": fm.bn_relu_matmul_bwd_da.launches_f32,
            "K3": fm.bn_relu_matmul_bwd_dw.launches_f32}


def _zero_fused_launches() -> None:
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    for fn in (fm.bn_relu_matmul_fwd, fm.bn_relu_matmul_bwd_da, fm.bn_relu_matmul_bwd_dw):
        fn.launches = fn.launches_f32 = 0


def resilience_train_phase(torch, tables, work: Path, card: str) -> dict:
    """``train --pallas-fused`` at full width on the 848-row table, 2 epochs
    of 4 steps, under ``--health-policy rollback --max-consecutive-skips 1``
    with the first two steps after the first epoch's checkpoint poisoned:
    skip, then rollback to step 4, then steps 5-8 again."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity
    from dss_ml_at_scale_tpu_torch.resilience import faults
    from dss_ml_at_scale_tpu_torch.resilience.rollback import QuarantineList

    train, val = tables
    ckpt = work / "rollback"
    args = cli.build_parser().parse_args([
        "train", "--data", train, "--val-data", val, "--model", "resnet50", "--pallas-fused",
        "--batch-size", str(BATCH), "--crop", "224", "--num-classes", "1000", "--epochs", "2",
        "--limit-val-batches", "1", "--checkpoint-dir", str(ckpt), "--health-policy",
        "rollback", "--max-consecutive-skips", "1", "--tracking-root", str(work / "runs")])
    nonfinite0 = _counter("nonfinite_steps_total")
    faults.install_from_spec(f"grads.nonfinite=2@{STEPS}")
    # The main path: counts set to 0 just before, read just after.
    _zero_fused_launches()
    t0 = time.perf_counter()
    try:
        summary = cli.run_train(args)
    finally:
        faults.clear()
    wall = time.perf_counter() - t0
    launches = _fused_launches()
    dispatched = 2 * STEPS + 2  # two epochs, and the two discarded steps
    check(summary["steps"] == 2 * STEPS, f"rollback run ended at step {summary['steps']}, "
          f"the clean run's count is {2 * STEPS}")
    check(summary["health_rollbacks"] == 1 and summary["skipped_steps"] == 2,
          f"rollback run: {summary['health_rollbacks']} rollbacks, "
          f"{summary['skipped_steps']} skipped steps; want 1 and 2")
    check(_counter("nonfinite_steps_total") - nonfinite0 == 2, "nonfinite_steps_total")
    entries = QuarantineList(ckpt / "quarantine.jsonl").entries
    rows = sum(e["row_hi"] - e["row_lo"] for e in entries)
    check(rows == 2 * BATCH and {e["step"] for e in entries} == {STEPS + 1}
          and all("nonfinite" in e["reason"] for e in entries),
          f"quarantine: {len(entries)} entries over {rows} rows, want {2 * BATCH} rows")
    want = {"K1": 16 * dispatched + 16 * 2, "K2": 16 * dispatched, "K3": 16 * dispatched}
    check(launches == want, f"rollback run kernel launches {launches}, want {want} "
          f"(16 per dispatched step, discarded ones included, and per eval batch)")
    report = integrity.verify_checkpoint_dir(ckpt)
    check([r["step"] for r in report] == [2 * STEPS, STEPS]
          and all(r["status"] == "intact" for r in report), f"rollback checkpoints {report}")
    result = {"launches": launches, "dispatched_steps": dispatched, "wall_s": wall,
              "steps": summary["steps"], "health_rollbacks": summary["health_rollbacks"],
              "skipped_steps": summary["skipped_steps"], "quarantine_entries": len(entries),
              "quarantined_rows": rows, "val_acc": summary["val_acc"]}
    print(f"resilience rollback run ({card}): " + json.dumps(result), flush=True)
    return result


def _timed_steps(torch, step, n: int) -> float:
    """Wall ms per step of ``n`` steps, the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def _supervision_cost(torch, task, batch, trials: int = 3, n: int = 5) -> dict:
    """The task's step with ``--health-policy off`` (``train_step``) and
    ``skip`` (the guarded step, no fault), data already on the card, timed
    in turns: off, skip, skip, off, ..."""
    from dss_ml_at_scale_tpu_torch.resilience import health

    guarded = health.guard_train_step(task, health.HealthConfig(policy="skip"))
    state = {"h": health.HealthState.create("cuda")}

    def skip():
        state["h"], m = guarded(state["h"], batch, health.INJECT_NONE)
        check(m["health_verdict"] == health.VERDICT_OK, "supervision timing: a bad verdict")

    steps = {"off": lambda: task.train_step(batch), "skip": skip}
    for fn in steps.values():  # warm both
        fn()
    times = {"off": [], "skip": []}
    order = ["off", "skip", "skip", "off"] * ((trials + 1) // 2)
    for name in order[:2 * trials]:
        times[name].append(_timed_steps(torch, steps[name], n))
    return {"off_ms": times["off"], "skip_ms": times["skip"],
            "off_ms_median": statistics.median(times["off"]),
            "skip_ms_median": statistics.median(times["skip"]), "steps_per_trial": n}


def _state(task) -> dict:
    import copy

    opt = task.optimizer.state_dict()
    return {"model": {k: v.clone() for k, v in task.model.state_dict().items()},
            "adam": copy.deepcopy(opt["state"]), "step": task.step}


def _bit_equal(a: dict, b: dict) -> bool:
    import torch

    return (a["step"] == b["step"]
            and all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
            and a["adam"].keys() == b["adam"].keys()
            and all(torch.equal(v, b["adam"][i][k])
                    for i, st in a["adam"].items() for k, v in st.items()))


def resilience_step_phase(torch, card: str) -> dict:
    """A poisoned step at full width on the card: the guarded ResNet-50
    ``ClassifierTask`` step (pallas level, batch 212, crop 224) with a NaN
    and then a spike injected leaves the weights, Adam's moments and step,
    the BN running statistics and ``task.step`` bit-equal, K1-K3 launched
    16 times each per discarded step; then the supervision cost of the
    ResNet-50 step and of the full-width LM step."""
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.parallel import ClassifierTask, LMTask
    from dss_ml_at_scale_tpu_torch.resilience import health

    model = build_classifier_model("resnet50", num_classes=1000, torch_padding=False,
                                   fused_bn="pallas", device="cuda")
    task = ClassifierTask(model=model, learning_rate=1e-5)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"image": torch.randn(BATCH, 224, 224, 3, device="cuda", generator=gen),
             "label": torch.randint(0, 1000, (BATCH,), device="cuda", generator=gen)}
    guarded = health.guard_train_step(task, health.HealthConfig(policy="skip", warmup_steps=1))
    h, m = guarded(health.HealthState.create("cuda"), batch, health.INJECT_NONE)
    check(m["health_verdict"] == health.VERDICT_OK and task.step == 1, "first guarded step")
    before = _state(task)
    check(any(k.endswith("running_var") for k in before["model"]) and before["adam"],
          "no BN statistics or Adam state to hold")
    verdicts = []
    _zero_fused_launches()
    for inject in (health.INJECT_NONFINITE, health.INJECT_SPIKE):
        h2, m = guarded(h, batch, inject)
        verdicts.append(m["health_verdict"])
        check(h2 is h, "a discarded step moved the EWMA state")
    launches = _fused_launches()
    check(verdicts == [health.VERDICT_NONFINITE, health.VERDICT_SPIKE],
          f"poisoned-step verdicts {verdicts}")
    check(_bit_equal(_state(task), before),
          "a discarded step changed the weights, moments, BN statistics or step count")
    check(launches == {"K1": 32, "K2": 32, "K3": 32},
          f"discarded steps launched {launches}, want 16 each per step")
    cost = {"resnet50": _supervision_cost(torch, task, batch)}
    del task, model, batch, guarded
    torch.cuda.empty_cache()
    lm = LMTask(model=seeded_lm(0, device="cuda", vocab_size=8192, dim=1024, num_heads=8,
                                num_layers=4, max_seq=2048, attention="flash"),
                learning_rate=3e-4)
    tokens = {"tokens": torch.randint(0, 8192, (8, 2048), device="cuda", generator=gen)}
    flash_attention.launches = 0
    cost["lm"] = _supervision_cost(torch, lm, tokens)
    timed = 2 + (len(cost["lm"]["off_ms"]) + len(cost["lm"]["skip_ms"])) * 5
    check(flash_attention.launches == 4 * timed, "LM timing: K4 launches")
    del lm, tokens
    torch.cuda.empty_cache()
    result = {"verdicts": verdicts, "launches": launches, "supervision": cost}
    print(f"resilience step ({card}): " + json.dumps(result), flush=True)
    return result


def _wait_for(pred, proc, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        if proc.poll() is not None:
            fail(f"{what}: the run exited ({proc.returncode}) first:\n"
                 + proc.stderr.read()[-3000:])
        time.sleep(0.05)
    proc.kill()
    fail(f"{what}: timed out")


def _lm_argv(steps_per_epoch: int, work: Path, *extra: str) -> list[str]:
    argv = list(LM_TRAIN)
    argv[argv.index("--steps-per-epoch") + 1] = str(steps_per_epoch)
    return ["lm", *argv, "--epochs", "2", "--checkpoint-dir", str(work / "ck"),
            "--tracking-root", str(work / "runs"), *extra]


def resilience_lm_phase(torch, work: Path, card: str) -> dict:
    """The full-width ``lm`` in subprocesses: SIGTERM after its first logged
    step, then ``--resume-auto`` (in this process, K4 counted) to the
    uninterrupted step count; a run SIGKILLed after its first checkpoint,
    which ``runs doctor`` marks INTERRUPTED and ``runs doctor --resume``
    finishes; ``--health-policy skip`` with one ``loss.spike``; the save and
    restore times of the full-width LM's checkpoint."""
    import contextlib
    import io
    import os
    import signal

    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.parallel import LMTask
    from dss_ml_at_scale_tpu_torch.parallel import trainer as trainer_mod
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity
    from dss_ml_at_scale_tpu_torch.resilience import faults
    from dss_ml_at_scale_tpu_torch.tracking import list_runs, read_journal

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH", "")]))
    layers, result = 4, {}

    def start(argv, cwd):
        return subprocess.Popen([sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli",
                                 *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    # 1. SIGTERM mid-epoch, then --resume-auto.
    spe, pre = 30, work / "preempt"
    pre.mkdir()
    proc = start(_lm_argv(spe, pre), pre)
    _wait_for(lambda: any(p.stat().st_size for p in (pre / "runs").glob("lm/*/metrics.jsonl")),
              proc, 300, "lm SIGTERM run")
    t_sig = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    out, err = proc.communicate(timeout=300)
    exit_s = time.perf_counter() - t_sig
    check(proc.returncode == 0, f"lm SIGTERM run exited {proc.returncode}:\n{err[-3000:]}")
    first = json.loads(out.strip().splitlines()[-1])
    stopped = first["steps"]
    check(first["preempted"] is True and 0 < stopped < spe,
          f"lm SIGTERM run: preempted {first['preempted']} at step {stopped}")
    check(integrity.list_steps(pre / "ck") == [stopped]
          and json.loads((pre / "ck" / str(stopped) / "metrics.json").read_text()) == {}
          and integrity.verify_step(pre / "ck" / str(stopped))[0] == "intact",
          f"lm preemption checkpoint {integrity.verify_checkpoint_dir(pre / 'ck')}")
    args = cli.build_parser().parse_args(_lm_argv(spe, pre, "--resume-auto"))
    # The main path: counts set to 0 just before, read just after.
    flash_attention.launches = 0
    t0 = time.perf_counter()
    resumed = cli.run_lm(args)
    resume_wall = time.perf_counter() - t0
    launches = flash_attention.launches
    want = layers * ((2 * spe - stopped) + 2 * LM_VAL)
    check(resumed["steps"] == 2 * spe and resumed["auto_resumed"] is True,
          f"lm --resume-auto ended at step {resumed['steps']}, want {2 * spe}")
    check(launches == want, f"lm --resume-auto: K4 launched {launches} times, want {want}")
    result["preempt"] = {"stopped_at": stopped, "sigterm_to_exit_s": exit_s,
                         "resume_auto_wall_s": resume_wall, "steps": resumed["steps"],
                         "launches": launches}

    # 2. SIGKILL after the first checkpoint, runs doctor, runs doctor --resume.
    spe, dead = 6, work / "killed"
    dead.mkdir()
    proc = start(_lm_argv(spe, dead), dead)

    def journaled_checkpoint():
        return any(e["event"] == "checkpoint" for d in (dead / "runs").glob("lm/*")
                   for e in read_journal(d))

    _wait_for(journaled_checkpoint, proc, 300, "lm SIGKILL run")
    proc.kill()
    proc.communicate(timeout=60)
    (killed_dir,) = list((dead / "runs" / "lm").iterdir())
    rc, out = _cli_out(["trace", "tail", "--run", str(killed_dir), "--json"])
    tail = [json.loads(line) for line in out.splitlines()]
    open_spans = sorted({r["name"] for r in tail if r.get("open")})
    check(rc == 0 and {"fit"} <= set(open_spans),
          f"trace tail of the killed lm: rc {rc}, open spans {open_spans}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["runs", "doctor", "--json", "--tracking-root", str(dead / "runs")])
    (run,) = json.loads(buf.getvalue())["runs"]
    check(rc == 0 and run["effective_status"] == "INTERRUPTED" and run.get("marked")
          and run["resumable_step"] == spe, f"runs doctor on the killed run: {run}")
    check(run["trace_file"] == str((killed_dir / "flightrec.jsonl").absolute()),
          f"runs doctor names the tail {run['trace_file']}")
    result["killed_tail"] = {"open_spans": open_spans, "tail_rows": len(tail)}
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["runs", "doctor", "--resume", "--tracking-root", str(dead / "runs")])
    revive_wall = time.perf_counter() - t0
    statuses = sorted(m["status"] for m in list_runs(dead / "runs"))
    check(rc == 0 and integrity.list_steps(dead / "ck")[-1] == 2 * spe
          and statuses == ["FINISHED", "INTERRUPTED"],
          f"runs doctor --resume: rc {rc}, steps {integrity.list_steps(dead / 'ck')}, "
          f"runs {statuses}")
    result["killed"] = {"resumable_step": run["resumable_step"], "revive_wall_s": revive_wall,
                        "final_step": 2 * spe}

    # 3. --health-policy skip with one loss spike.
    spike = work / "spike"
    args = cli.build_parser().parse_args(
        ["lm", *LM_TRAIN, "--epochs", "1", "--health-policy", "skip", "--health-warmup", "2",
         "--tracking-root", str(spike / "runs")])
    faults.install_from_spec("loss.spike=1@4")
    flash_attention.launches = 0
    try:
        summary = cli.run_lm(args)
    finally:
        faults.clear()
    launches = flash_attention.launches
    want = layers * (LM_STEPS + 1 + LM_VAL)
    check(summary["steps"] == LM_STEPS and summary["skipped_steps"] == 1
          and summary["health_rollbacks"] == 0,
          f"lm skip: {summary['steps']} steps, {summary['skipped_steps']} skipped")
    check(launches == want, f"lm skip: K4 launched {launches} times, want {want}")
    result["spike"] = {"steps": summary["steps"], "skipped_steps": summary["skipped_steps"],
                       "launches": launches}

    # 4. What a checkpoint of the full-width LM costs to save and restore.
    task = LMTask(model=seeded_lm(0, device="cuda", vocab_size=8192, dim=1024, num_heads=8,
                                  num_layers=4, max_seq=2048, attention="flash"))
    gen = torch.Generator(device="cuda").manual_seed(1)
    task.train_step({"tokens": torch.randint(0, 8192, (8, 2048), device="cuda", generator=gen)})
    torch.cuda.synchronize()
    root = work / "save"
    t0 = time.perf_counter()
    trainer_mod._save(root, task, 1, 0, {})
    save_s = time.perf_counter() - t0
    fresh = LMTask(model=seeded_lm(0, device="cuda", vocab_size=8192, dim=1024, num_heads=8,
                                   num_layers=4, max_seq=2048, attention="flash"))
    t0 = time.perf_counter()
    restored = trainer_mod._restore_with_fallback(root, fresh)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(restored == 1 and all(torch.equal(a, b) for a, b in zip(
        task.model.state_dict().values(), fresh.model.state_dict().values())),
        "the restored LM differs from the saved one")
    result["checkpoint"] = {"save_s": save_s, "restore_s": restore_s,
                            "state_bytes": (root / "1" / "state.pt").stat().st_size}
    del task, fresh
    torch.cuda.empty_cache()
    result["launches"] = result["preempt"]["launches"] + result["spike"]["launches"]
    print(f"resilience lm ({card}): " + json.dumps(result), flush=True)
    return result


# The group-fit phase: the reference's demand panel (50 SKUs x 157 weeks)
# and forecast at their defaults; the card against the CPU in float64 at a
# small config; the card against the golden fixture in float32; and the
# 1,024-group chunk shape.
GF_GROUPS, GF_ROWS = 50, 50 * 157
GF_F64 = dict(max_p=1, max_d=1, max_q=1, k_exog=3, max_iter=20, bfgs_iter=5)
GF_F64_SKUS, GF_F64_TOL = 4, 1e-6
GF_GOLDEN = Path(__file__).resolve().parent / "tests" / "fixtures" / "sarimax_golden.json"
GF_CHUNK = 1024  # parallel/group_apply.py DEFAULT_GRID_CHUNK
# The golden fit runs tests/test_sarimax_golden.py's slow-test config.
GF_GOLDEN_CFG_KW = dict(k_exog=3, max_iter=600)
# Orders whose float32 fit lands in either of two basins, in the JAX
# package too: on 16 copies of the series scaled by 1 + 1e-5 z, JAX's fit
# of (4, 2, 1) trails the oracle by 8.0-16.1 nats on 5 and the port's by
# 7.8-14.9 on 4, against a bar of 7.5 (scripts/golden_fit_sweep_jax.py and
# golden_fit_sweep_torch.py --orders 4,2,1 --perturb 16 --max-iter 600,
# on the CPU). Their shortfall is printed and held finite; every other
# order is held to its bar.
GF_GOLDEN_BASIN = {(4, 2, 1)}


def _fit_tol(order) -> float:
    """tests/test_sarimax_golden.py's per-order fit bar (nats)."""
    p, d, q = order
    if d == 0 and (p or q):
        return 30.0
    return max(1.0, 1.5 * (p + q))


def _read_delta(path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from dss_ml_at_scale_tpu_torch.data.delta import DeltaTable

    return pa.concat_tables(pq.read_table(u) for u in DeltaTable(path).file_uris())


def _util_samples(text: str) -> list[tuple[float, float]]:
    """``(epoch seconds, utilization %)`` from nvidia-smi's
    ``timestamp,utilization.gpu`` lines."""
    from datetime import datetime

    rows = []
    for line in text.splitlines():
        stamp, _, util = line.rpartition(",")
        try:
            rows.append((datetime.strptime(stamp.strip(), "%Y/%m/%d %H:%M:%S.%f").timestamp(),
                         float(util)))
        except ValueError:
            continue  # a "[N/A]" or a line cut by the sampler's termination
    return rows


def _port_env(**extra) -> dict:
    """The environment of a subprocess of the port's CLI: the checkout on
    the path."""
    import os

    root = str(Path(__file__).resolve().parent)
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p), **extra)


CLI = [sys.executable, "-m", "dss_ml_at_scale_tpu_torch.config.cli"]


def _idle(util, lo: float, hi: float) -> tuple[float, int]:
    """The card's idle share over ``[lo, hi]`` (epoch s), and the samples."""
    inside = [u for t, u in util if lo <= t <= hi]
    check(len(inside) > 0, "no nvidia-smi sample inside the window")
    return round(1.0 - sum(inside) / len(inside) / 100.0, 3), len(inside)


def _task_seconds(text: str) -> dict:
    """``{task_key: seconds}`` from the pipeline runner's ``[key] ok (Xs)`` lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("[") and "] ok (" in line:
            key = line[1:line.index("]")]
            out[key] = float(line.rsplit("(", 1)[1].rstrip("s)"))
    return out


def group_fit_phase(card: str, side: dict) -> dict:
    """Read back ``datagen demand`` and ``forecast`` at their defaults on the
    card, run as ``pipelines/demand_forecasting.json`` through the port's
    ``pipeline`` (the spec's two commands at the same size, plus its
    ``datagen bom``; this run takes the place of the phase's own two CLI
    calls, to keep the script's time), started by :func:`start_side_runs`;
    the card's idle share from the block's sampler. Returns the spec's run
    for the pipeline phase under ``"spec_run"``."""
    import numpy as np

    out: dict = {}
    run = side["group_fit"]
    work, util = run["work"], side["util"]

    # 1. The main path at the reference's size: the demand_forecasting spec.
    proc, wall = _wait(run, 1800, "demand_forecasting pipeline")
    check(proc.returncode == 0 and proc.stdout.strip().endswith("pipeline ok"),
          f"demand_forecasting pipeline failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    tasks = _task_seconds(proc.stdout)
    check(f"50 SKUs × 157 weeks = {GF_ROWS} rows" in proc.stdout,
          f"datagen demand: {proc.stdout[-2000:]}")
    out["datagen_s"] = tasks["generate_demand"]
    fc_lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("forecast: ")]
    check(len(fc_lines) == 1 and fc_lines[0].startswith(
        f"forecast: {GF_GROUPS} groups, {GF_ROWS} rows, mse "), f"forecast line: {fc_lines}")
    table = _read_delta(work / "part_level_demand_with_forecasts")
    fitted = table.column("Demand_Fitted").to_numpy()
    check(table.num_rows == GF_ROWS, f"forecast table has {table.num_rows} rows")
    check(bool(np.isfinite(fitted).all()), "forecast: non-finite Demand_Fitted")
    bom, mapper = _read_delta(work / "bom"), _read_delta(work / "sku_mapper")
    check(bom.num_rows > 0 and mapper.num_rows == GF_GROUPS,
          f"bom {bom.num_rows} edges, sku_mapper {mapper.num_rows} rows")
    (run_dir,) = list((work / "runs" / "forecasting").iterdir())
    meta = json.loads((run_dir / "meta.json").read_text())
    check(meta["status"] == "FINISHED", f"forecast run is {meta['status']}")
    records = {m["name"]: m for m in map(json.loads, (
        run_dir / "metrics.jsonl").read_text().splitlines())}
    metrics = {k: m["value"] for k, m in records.items()}
    check(metrics["grid_chunks"] == 1, f"forecast took {metrics['grid_chunks']} chunks")
    # The card's busy share over the forecast's own wall_s (Delta read, grid
    # fit, Delta write) and, apart, over the whole forecast task.
    fit_end = records["wall_s"]["ts"]
    idle, n_fit = _idle(util, fit_end - metrics["wall_s"], fit_end)
    idle_cmd, n_cmd = _idle(util, fit_end - tasks["fine_grained_forecasting"], fit_end + 1.0)
    out.update(
        forecast_wall_s=tasks["fine_grained_forecasting"],
        forecast_fit_s=round(metrics["wall_s"], 2),
        skus_per_s=round(GF_GROUPS / metrics["wall_s"], 3),
        nm_iterations=int(metrics["nm_iterations"]),
        peak_mem_gib=round(metrics["peak_mem_bytes"] / 2 ** 30, 3),
        mse=round(metrics["mse"], 2), grid_chunks=int(metrics["grid_chunks"]),
        idle_share_side_by_side=idle, util_samples=n_fit,
        idle_share_command_side_by_side=idle_cmd,
        util_samples_command=n_cmd, run_status=meta["status"], bom_edges=bom.num_rows,
        spec_run={"tasks": tasks, "wall_s": round(wall, 2), "bom_edges": bom.num_rows,
                  "sku_mappings": mapper.num_rows, "forecast_rows": table.num_rows})
    print(f"group-fit forecast ({card}): {fc_lines[0]}", flush=True)
    return out


def group_fit_card_checks(torch, demand_path: str) -> dict:
    """The group-fit phase's checks in this process, on the spec's demand
    table: the card against the CPU in float64 and against the golden
    fixture in float32; one Nelder-Mead iteration and one BFGS
    value-and-gradient at the 1,024-group chunk shape."""
    import numpy as np

    from dss_ml_at_scale_tpu_torch.ops import bfgs, sarimax as sx
    from dss_ml_at_scale_tpu_torch.ops.neldermead import nelder_mead
    from dss_ml_at_scale_tpu_torch.parallel.group_apply import grid_fit_panel, pad_groups
    from dss_ml_at_scale_tpu_torch.workloads.forecasting import EXO_FIELDS, add_exo_variables

    out: dict = {}
    # 2. The card against the CPU, float64, at a small config.
    demand = add_exo_variables(_read_delta(demand_path))
    padded = pad_groups(demand, ["Product", "SKU"], ["Demand", *EXO_FIELDS], sort_by="Date")
    y = padded.values["Demand"]
    exog = np.stack([padded.values[f] for f in EXO_FIELDS], -1)
    n_valid = padded.n_valid.astype(np.int32)
    n_train = np.maximum(n_valid - 40, 1).astype(np.int32)
    cfg = sx.SarimaxConfig(**GF_F64)
    k = slice(0, GF_F64_SKUS)
    res = {dev: grid_fit_panel(cfg, y[k], exog[k], n_train[k], n_valid[k], device=dev,
                               dtype=torch.float64) for dev in ("cuda", "cpu")}
    check(bool((res["cuda"].order == res["cpu"].order).all()),
          f"f64 winning orders differ: {res['cuda'].order.tolist()} vs {res['cpu'].order.tolist()}")
    rel = float(np.max(np.abs(res["cuda"].params - res["cpu"].params)
                       / np.maximum(np.abs(res["cpu"].params), 1.0)))
    check(rel <= GF_F64_TOL, f"f64 params differ card vs CPU by {rel:.3g} relative")
    out["f64_card_vs_cpu_params_rel"] = rel
    out["f64_orders"] = res["cuda"].order.tolist()

    # 3. The golden fixture in float32 on the card: loglike and predict at
    # the pinned points, sarimax_fit's loglike for every d >= 1 order.
    fix = json.loads(GF_GOLDEN.read_text())
    gcfg = sx.SarimaxConfig(k_exog=3)
    f32 = dict(dtype=torch.float32, device="cuda")
    gy = torch.tensor(fix["y"], **f32)
    gex = torch.tensor(fix["exog"], **f32)
    params = torch.tensor(np.stack([np.concatenate([
        c["beta"], np.pad(c["phi"], (0, 4 - len(c["phi"]))),
        np.pad(c["theta"], (0, 4 - len(c["theta"]))), [c["log_sigma2"]]])
        for c in fix["cases"]]), **f32)
    orders = torch.tensor([c["order"] for c in fix["cases"]], device="cuda")
    nv = torch.tensor(fix["n_valid"], device="cuda")
    ll = sx.sarimax_loglike(gcfg, params, gy, gex, orders, nv).cpu().numpy()
    pred = sx.sarimax_predict(gcfg, params, gy, gex, orders, nv).cpu().numpy()
    worst_ll = worst_pred = 0.0
    for i, c in enumerate(fix["cases"]):
        err = abs(float(ll[i]) - c["loglike"])
        check(err <= max(1e-4 * abs(c["loglike"]), 0.05),
              f"golden loglike {c['order']}: {ll[i]} vs {c['loglike']}")
        worst_ll = max(worst_ll, err)
        perr = np.abs(pred[i] - np.asarray(c["predict"]))
        check(bool((perr <= 5e-3 + 1e-3 * np.abs(np.asarray(c["predict"]))).all()),
              f"golden predict {c['order']}: max error {perr.max()}")
        worst_pred = max(worst_pred, float(perr.max()))
    out.update(golden_loglike_max_abs_err=worst_ll, golden_predict_max_abs_err=worst_pred)

    # 4. The 1,024-group chunk shape: 1,024 x 75 orders x 3 starts lanes.
    fcfg = sx.SarimaxConfig(k_exog=3)
    K = len(sx.grid_orders(fcfg))
    gi = np.arange(GF_CHUNK) % len(y)
    B = GF_CHUNK * K * 3
    rep = lambda a: torch.as_tensor(np.repeat(a[gi], K * 3, axis=0), device="cuda")  # noqa: E731
    og = torch.as_tensor(np.tile(np.repeat(sx.grid_orders(fcfg), 3, axis=0), (GF_CHUNK, 1)),
                         device="cuda").long()
    obj = sx._Objective(fcfg, rep(y), rep(exog), og, rep(n_train).long())
    x0 = torch.zeros(B, fcfg.n_params - 1, device="cuda")
    torch.cuda.synchronize()
    times = {}
    for iters in (1, 3):
        t0 = time.perf_counter()
        nelder_mead(obj.points, x0, max_iter=iters)
        torch.cuda.synchronize()
        times[iters] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    f, g = bfgs.value_and_grad(obj, x0, sx.GRAD_LANES)
    torch.cuda.synchronize()
    vg_s = time.perf_counter() - t0
    check(bool(torch.isfinite(f).all()) and bool(torch.isfinite(g).all()),
          "chunk-shape value and gradient not finite")
    out.update(chunk_lanes=B, chunk_nm_iter_ms=round((times[3] - times[1]) / 2 * 1e3, 1),
               chunk_bfgs_vg_s=round(vg_s, 3),
               chunk_bfgs_vg_peak_gib=round((torch.cuda.max_memory_allocated() - base) / 2 ** 30,
                                            3))
    del obj, f, g
    torch.cuda.empty_cache()
    return out


def group_fit_golden(torch) -> dict:
    """The group-fit phase's golden fit: ``sarimax_fit`` in float32 on the
    card for every d >= 1 order of the golden fixture at
    ``tests/test_sarimax_golden.py``'s slow-test config (max_iter 600), each
    loglike within that test's per-order bar of the oracle's, but for
    (4, 2, 1), whose float32 fit lands in either of two basins in the JAX
    package too: its shortfall is printed and held finite. A process of its
    own beside the side runs (:func:`child_main`; a fit bound by the host's
    dispatch, the card idle most of it)."""
    from dss_ml_at_scale_tpu_torch.ops import sarimax as sx

    fix = json.loads(GF_GOLDEN.read_text())
    f32 = dict(dtype=torch.float32, device="cuda")
    gy = torch.tensor(fix["y"], **f32)
    gex = torch.tensor(fix["exog"], **f32)
    nv = torch.tensor(fix["n_valid"], device="cuda")
    bars = [b for b in fix["fits"] if b["order"][1] >= 1]
    t0 = time.perf_counter()
    fit = sx.sarimax_fit(sx.SarimaxConfig(**GF_GOLDEN_CFG_KW), gy, gex,
                         torch.tensor([b["order"] for b in bars], device="cuda"), nv)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    shortfall = {}
    for i, b in enumerate(bars):
        got = float(fit.loglike[i])
        order = tuple(b["order"])
        check(math.isfinite(got), f"golden fit {order}: non-finite loglike")
        shortfall[order] = b["loglike"] - got
        check(order in GF_GOLDEN_BASIN or b["loglike"] - got <= _fit_tol(order),
              f"golden fit {order}: loglike {got} trails the oracle's {b['loglike']} "
              f"by more than {_fit_tol(order)}")
    held = [v for o, v in shortfall.items() if o not in GF_GOLDEN_BASIN]
    return {"golden_fit_orders": len(bars), "golden_fit_s_beside_side_runs": round(fit_s, 2),
            "golden_fit_max_shortfall": round(max(held), 4),
            "golden_fit_basin_shortfall": {str(o): round(shortfall[o], 4)
                                           for o in GF_GOLDEN_BASIN}}


# ---------------------------------------------------------------------------
# The forecasting track's search: TPE, eda, and the job DAG
# ---------------------------------------------------------------------------

# The reference's --max-evals 10, cut for the script's time (2 until the f32
# phases came; both rounds are TPE's random start-up draws either way).
TPE_EVALS = 1
TPE_F64 = dict(GF_F64)  # the card-vs-CPU panel's config (max orders 1/1/1)
TPE_F64_GROUPS, TPE_F64_EVALS, TPE_F64_TOL = 8, 3, 1e-6
# The CLI's --max-evals 10, --parallelism 10 and --max-iter 200, cut for the
# script's time: each SARIMAX fit is bound by the host's dispatch.
EDA_EVALS, EDA_PARALLELISM, EDA_MAX_ITER = 2, 2, 50
EDA_HW_TOL = 1e-9
HW_GOLDEN = Path(__file__).resolve().parent / "tests" / "fixtures" / "hw_golden.json"
# Processes started in the background: killed, with their children, when
# the script exits before it has waited for them (:func:`_track`).
_CHILDREN: list = []


def _kill_children() -> None:
    import os
    import signal

    for proc in _CHILDREN:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)  # its own session: the tasks too
            except (ProcessLookupError, PermissionError):
                proc.kill()


def _track(proc):
    import atexit

    if not _CHILDREN:
        atexit.register(_kill_children)
    _CHILDREN.append(proc)
    return proc


def _start(cmd: list[str], log: Path, **kw) -> dict:
    """Start ``cmd`` in its own session, its output in ``log`` (.out/.err)."""
    out, err = open(log.with_suffix(".out"), "w"), open(log.with_suffix(".err"), "w")
    proc = _track(subprocess.Popen(cmd, stdout=out, stderr=err, text=True,
                                   start_new_session=True, **kw))
    out.close()
    err.close()
    return {"proc": proc, "log": log, "t0": time.perf_counter(), "epoch0": time.time()}


def _wait(run: dict, timeout: float, what: str):
    """Wait for a :func:`_start`ed run; ``(CompletedProcess, wall s)``."""
    try:
        rc = run["proc"].wait(timeout=max(1.0, run["t0"] + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        fail(f"{what} did not finish within {timeout} s")
    log = run["log"]
    # From the start to the output's last write: the run may have ended
    # before this wait began.
    wall = log.with_suffix(".out").stat().st_mtime - run["epoch0"]
    return subprocess.CompletedProcess(run["proc"].args, rc, log.with_suffix(".out").read_text(),
                                       log.with_suffix(".err").read_text()), wall


def _run_dir(runs: Path, experiment: str) -> tuple[Path, dict, dict, dict]:
    """The one run of ``experiment``: its directory, meta, params and metric
    records by name."""
    (run_dir,) = list((runs / experiment).iterdir())
    meta = json.loads((run_dir / "meta.json").read_text())
    params = json.loads((run_dir / "params.json").read_text())
    records: dict = {}
    for m in map(json.loads, (run_dir / "metrics.jsonl").read_text().splitlines()):
        records.setdefault(m["name"], []).append(m)
    return run_dir, meta, params, records


def tpe_argv(demand: str, work: Path) -> list[str]:
    """``forecast --search tpe`` through the CLI on the group-fit phase's
    reference-size table, at the default order bounds and max_iter, with
    ``--max-evals 1`` where the reference takes 10."""
    return CLI + ["forecast", "--data", demand, "--out", str(work / "f"), "--search", "tpe",
                  "--max-evals", str(TPE_EVALS), "--tracking-root", str(work / "runs")]


def tpe_phase(card: str, side: dict) -> dict:
    """Read back ``forecast --search tpe`` (:func:`tpe_argv`), run beside
    the other side runs (a round is one batched fit bound by the host's
    dispatch; PERF.md states the cost of 10): 7,850 finite rows, the run
    FINISHED with ``max_evals`` logged; seconds per round, the projected
    cost of 10, the card's idle share (the side runs' work included)."""
    import numpy as np

    run = side["tpe"]
    work = run["work"]
    proc, wall = _wait(run, 1500, "forecast --search tpe")
    check(proc.returncode == 0, f"forecast --search tpe failed: {proc.stderr[-3000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    check(last.startswith(f"forecast: {GF_GROUPS} groups, {GF_ROWS} rows, mse "),
          f"tpe forecast line: {last}")
    table = _read_delta(work / "f")
    check(table.num_rows == GF_ROWS, f"tpe forecast table has {table.num_rows} rows")
    check(bool(np.isfinite(table.column("Demand_Fitted").to_numpy()).all()),
          "tpe forecast: non-finite Demand_Fitted")
    _, meta, params, records = _run_dir(work / "runs", "forecasting")
    check(meta["status"] == "FINISHED", f"tpe forecast run is {meta['status']}")
    check(params.get("max_evals") == TPE_EVALS and params.get("search") == "tpe",
          f"tpe run params: max_evals {params.get('max_evals')}, search {params.get('search')}")
    rounds = [m["value"] for m in sorted(records["tpe_round_s"], key=lambda m: m["step"])]
    check(len(rounds) == TPE_EVALS, f"{len(rounds)} TPE rounds logged")
    fit_s, fit_end = records["wall_s"][-1]["value"], records["wall_s"][-1]["ts"]
    idle, n = _idle(side["util"], fit_end - fit_s, fit_end)
    idle_cmd, n_cmd = _idle(side["util"], run["epoch0"], run["epoch0"] + wall)
    print(f"tpe forecast ({card}): {last}", flush=True)
    return {"wall_s": round(wall, 2), "fit_s": round(fit_s, 2),
            "round_s": [round(r, 2) for r in rounds],
            # the refit is one more batched fit, then the predict and the IO
            "refit_and_io_s": round(fit_s - sum(rounds), 2),
            "projected_max_evals_10_s": round(fit_s + (10 - TPE_EVALS) * float(np.mean(rounds)),
                                              1),
            "idle_share_side_by_side": idle, "util_samples": n,
            "idle_share_command_side_by_side": idle_cmd, "util_samples_command": n_cmd,
            "mse": records["mse"][-1]["value"],
            "peak_mem_gib": round(records["peak_mem_bytes"][-1]["value"] / 2 ** 30, 3)
            if "peak_mem_bytes" in records else None}


def tpe_parity(torch, demand: str) -> dict:
    """An 8-group panel of the table at max orders 1/1/1, ``max_evals`` 3,
    through the API on the card in float64 against the CPU in float64:
    identical per-group histories (losses within 1e-6 relative) and best
    orders, Demand_Fitted within 1e-6 relative. A process of its own beside
    the side runs (:func:`child_main`)."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.compute as pc

    from dss_ml_at_scale_tpu_torch.ops.sarimax import SarimaxConfig
    from dss_ml_at_scale_tpu_torch.workloads.forecasting import (
        add_exo_variables, tune_and_forecast_panel,
    )

    full = add_exo_variables(_read_delta(demand))
    skus = sorted(set(full.column("SKU").to_pylist()))[:TPE_F64_GROUPS]
    small = full.filter(pc.is_in(full["SKU"], pa.array(skus)))
    res = {}
    for dev in ("cuda", "cpu"):
        stats: dict = {}
        t0 = time.perf_counter()
        table = tune_and_forecast_panel(small, cfg=SarimaxConfig(**TPE_F64), search="tpe",
                                        max_evals=TPE_F64_EVALS, rstate=123, device=dev,
                                        dtype=torch.float64, stats=stats)
        res[dev] = (table, stats, time.perf_counter() - t0)
    (gt, gs, g_s), (ct, cs, c_s) = res["cuda"], res["cpu"]
    worst = 0.0
    for g, (a, b) in enumerate(zip(gs["histories"], cs["histories"])):
        check([p for p, _ in a] == [p for p, _ in b], f"f64 TPE group {g}: points differ")
        la, lb = np.array([v for _, v in a]), np.array([v for _, v in b])
        rel = float(np.max(np.abs(la - lb) / np.maximum(np.abs(lb), 1e-300)))
        check(rel <= TPE_F64_TOL, f"f64 TPE group {g}: losses differ by {rel:.3g} relative")
        worst = max(worst, rel)
    check(gs["best_orders"] == cs["best_orders"],
          f"f64 TPE best orders: {gs['best_orders']} vs {cs['best_orders']}")
    fa_, fb = (t.column("Demand_Fitted").to_numpy().astype(np.float64) for t in (gt, ct))
    frel = float(np.max(np.abs(fa_ - fb) / np.maximum(np.abs(fb), 1.0)))
    check(frel <= TPE_F64_TOL, f"f64 TPE Demand_Fitted differs by {frel:.3g} relative")
    return {"f64_groups": len(skus), "f64_loss_rel": worst, "f64_fitted_rel": frel,
            "f64_best_orders": gs["best_orders"], "f64_card_s": round(g_s, 2),
            "f64_cpu_s": round(c_s, 2)}


def start_side_runs() -> dict:
    """Start, side by side in the background, the group-fit phase's
    ``demand_forecasting.json`` and, on its demand table once its first task
    has written it, ``eda``, ``forecast --search tpe`` (:func:`tpe_argv`)
    and :func:`tpe_parity` (on a thread, :func:`_start_search`); the
    pipeline phase's specs (``real_photos_train.json`` among them),
    :func:`group_fit_golden`, and, on threads, the HPO chain
    (:func:`hpo_chain`), the chaos soaks (:func:`chaos_chain`) and the
    analysis tiers: each a chain of processes whose time is mostly the
    host's. They share the card and the host's cores while the script goes
    on with the LM's parallel extras. Their times are measured beside one
    another."""
    import importlib

    side: dict = {"sampler": _track(subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu", "--format=csv,noheader,nounits",
         "-lms", "200"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))}
    try:
        importlib.import_module("matplotlib")
        side["plot"], why = True, ""
    except ImportError as e:
        side["plot"], why = False, str(e)
    print(f"eda: import matplotlib {'works' if side['plot'] else 'fails: ' + why}", flush=True)
    if not side["plot"]:
        print("eda: --plot not run: matplotlib does not import on this host", flush=True)
    root = Path(__file__).resolve().parent / "pipelines"
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_groupfit_"))
    side["group_fit"] = {**_start(
        CLI + ["pipeline", "--spec", str(root / "demand_forecasting.json"), "--workdir",
               str(work), "--task-device", "cuda"], work / "pipeline", cwd=work,
        env=_port_env(DSST_TRACKING_ROOT=str(work / "runs"))), "work": work}
    side["demand"] = str(work / "part_level_demand")
    side["search"] = threading.Thread(target=_start_search, args=(side,), name="search",
                                      daemon=True)
    side["search"].start()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_golden_"))
    side["golden"] = _start([sys.executable, str(Path(__file__).resolve()), "--child",
                             "golden"], work / "golden", env=_port_env())
    specs = {"full_stack": root / "full_stack.json",
             "imagenet_train": root / "imagenet_train.json",
             "real_photos": root / "real_photos_train.json"}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_failing_"))
    specs["failing"] = work / "failing.json"
    specs["failing"].write_text(json.dumps({"name": "failing", "timeout_seconds": 600, "tasks": [
        {"task_key": "bad", "argv": ["datagen", "bom", "--demand", "{workdir}/missing",
                                     "--out", "{workdir}/b", "--mapper-out", "{workdir}/m"]},
        {"task_key": "down", "argv": ["forecast", "--data", "{workdir}/d", "--out",
                                      "{workdir}/f"], "depends_on": ["bad"]}]}))
    for name, spec in specs.items():
        work = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{name}_"))
        side[name] = {**_start(CLI + ["pipeline", "--spec", str(spec), "--workdir", str(work),
                                      "--task-device", "cuda"], work / "pipeline", cwd=work,
                               env=_port_env(DSST_TRACKING_ROOT=str(work / "runs"))),
                      "work": work}
    side["hpo"] = {"t0": time.perf_counter()}

    def _hpo() -> None:
        try:
            side["hpo"]["result"] = hpo_chain(Path(tempfile.mkdtemp(prefix="chip_smoke_hpo_")))
        except BaseException as e:  # a failed check exits; the phase reports it
            side["hpo"]["error"] = f"{type(e).__name__}: {e}"
        finally:
            side["hpo"]["wall_s"] = time.perf_counter() - side["hpo"]["t0"]

    side["hpo"]["thread"] = threading.Thread(target=_hpo, name="hpo-chain", daemon=True)
    side["hpo"]["thread"].start()
    side["chaos"] = {"t0": time.perf_counter()}

    def _chaos() -> None:
        try:
            side["chaos"]["result"] = chaos_chain(Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_")))
        except BaseException as e:  # a failed check exits; the phase reports it
            side["chaos"]["error"] = f"{type(e).__name__}: {e}"

    side["chaos"]["thread"] = threading.Thread(target=_chaos, name="chaos-chain", daemon=True)
    side["chaos"]["thread"].start()
    side["analysis"] = {"t0": time.perf_counter()}

    def _analysis() -> None:
        try:
            side["analysis"]["result"] = analysis_chain(
                Path(tempfile.mkdtemp(prefix="chip_smoke_analysis_")))
        except BaseException as e:  # a failed check exits; the phase reports it
            side["analysis"]["error"] = f"{type(e).__name__}: {e}"

    side["analysis"]["thread"] = threading.Thread(target=_analysis, name="analysis-chain",
                                                  daemon=True)
    side["analysis"]["thread"].start()
    return side


def _start_search(side: dict) -> None:
    """Wait for the demand_forecasting spec's ``generate_demand`` task, then
    start ``eda``, ``forecast --search tpe`` and :func:`tpe_parity` on its
    table (a thread of :func:`start_side_runs`)."""
    run, demand = side["group_fit"], side["demand"]
    out = run["log"].with_suffix(".out")
    deadline = time.monotonic() + 600
    while "[generate_demand] ok (" not in out.read_text():
        if run["proc"].poll() is not None or time.monotonic() > deadline:
            side["search_error"] = f"the spec wrote no demand table:\n{out.read_text()[-2000:]}"
            return
        time.sleep(0.2)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_eda_"))
    argv = CLI + ["eda", "--data", demand, "--max-evals", str(EDA_EVALS), "--parallelism",
                  str(EDA_PARALLELISM), "--max-iter", str(EDA_MAX_ITER), "--polish",
                  "--tracking-root", str(work / "runs")]
    if side["plot"]:
        argv += ["--plot", str(work / "eda.png")]
    side["eda"] = {**_start(argv, work / "eda", env=_port_env()), "work": work}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tpe_"))
    side["tpe"] = {**_start(tpe_argv(demand, work), work / "tpe", env=_port_env()),
                   "work": work}
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tpe_parity_"))
    side["tpe_parity"] = _start([sys.executable, str(Path(__file__).resolve()), "--child",
                                 "tpe_parity", demand], work / "tpe_parity", env=_port_env())


def demand_table(side: dict) -> str:
    """The spec's demand table, once :func:`_start_search` has started the
    runs that read it."""
    side["search"].join(timeout=660)
    check(not side["search"].is_alive() and "search_error" not in side,
          f"demand_forecasting: {side.get('search_error', 'no demand table in 660 s')}")
    return side["demand"]


# The chaos soaks on the card. train: the JAX package's tier-1 soak
# (tests/test_crashonly.py: 5 SIGKILL cycles, seed 0, 2 epochs, kills at
# 1-3 s, 48 rows of 32 px, the tiny model); serve: 2 kill/restart cycles on
# its checkpoint; hpo: 3 cycles of a 6-trial sweep.
CHAOS_SOAKS = (
    ("train", ["--workload", "train", "--cycles", "5", "--seed", "0", "--epochs", "2",
               "--kill-max", "3.0", "--rows", "48", "--image-size", "32"]),
    ("serve", ["--workload", "serve", "--cycles", "2"]),
    ("hpo", ["--workload", "hpo", "--cycles", "3", "--seed", "1", "--kill-max", "4.0",
             "--max-evals", "6"]),
)


def chaos_chain(work: Path) -> dict:
    """``chaos`` on the card, each soak a process of its own: train, then
    serve on its checkpoint, with hpo (which needs neither) beside them:
    rc, every invariant, wall time and kills delivered."""
    work.mkdir(parents=True, exist_ok=True)

    def start(name: str, argv: list[str]) -> dict:
        if name == "serve":
            argv = [*argv, "--checkpoint-dir", str(work / "train" / "ckpt")]
        return _start(CLI + ["chaos", "--workdir", str(work / name), *argv, "--device", "cuda",
                             "--timeout", "300", "--json"], work / f"{name}_soak",
                      env=_port_env())

    runs = {name: start(name, argv) for name, argv in CHAOS_SOAKS if name == "hpo"}
    out = {}
    for name, argv in CHAOS_SOAKS:
        run = runs.get(name) or start(name, argv)
        proc, wall = _wait(run, 900, f"chaos --workload {name}")
        report = json.loads(proc.stdout.strip().splitlines()[-1])
        out[name] = {"rc": proc.returncode, "ok": report["ok"], "wall_s": round(wall, 2),
                     "kills_delivered": report.get("kills_delivered"),
                     "invariants": {k: v["ok"] for k, v in report["invariants"].items()},
                     "failing": {k: v for k, v in report["invariants"].items() if not v["ok"]}}
        if name == "train":
            out[name]["params"] = report["invariants"]["params_bitwise_equal"]
            out[name]["modes"] = [c["mode"] for c in report["cycles"]]
            out[name]["open_spans_per_run"] = \
                report["invariants"]["flight_recorder_tail"]["open_spans_per_run"]
    return out


def chaos_phase(card: str, side: dict) -> dict:
    """Wait for :func:`chaos_chain` (started beside the other side runs):
    every soak exits 0 with every invariant OK, ``params_bitwise_equal``
    (the digest of every tensor of the final checkpoint against an
    uninterrupted same-seed run) included."""
    side["chaos"]["thread"].join(
        timeout=max(1.0, side["chaos"]["t0"] + 1500 - time.perf_counter()))
    check(not side["chaos"]["thread"].is_alive(), "the chaos soaks did not finish within 1500 s")
    if "error" in side["chaos"]:
        fail(f"chaos soaks: {side['chaos']['error']}")
    out = side["chaos"]["result"]
    for name, soak in out.items():
        check(soak["rc"] == 0 and soak["ok"], f"chaos --workload {name}: {soak}")
    check(out["train"]["invariants"]["params_bitwise_equal"]
          and out["train"]["params"]["chaos"] == out["train"]["params"]["ref"],
          f"chaos train: final parameters differ from the uninterrupted run's "
          f"{out['train']['params']}")
    print(f"chaos ({card}): " + json.dumps(out), flush=True)
    print("chaos soaks: " + ", ".join(f"{n} {s['wall_s']:.1f} s, {s['kills_delivered']} kills"
                                      for n, s in out.items()), flush=True)
    return out


# The analysis tiers on the card, in this order, each a process of its own.
ANALYSIS_TIERS = (
    ("lint", ["lint", "--json"]),
    ("sanitize", ["sanitize", "--device", "cuda", "--json"]),
    ("audit", ["audit", "--device", "cuda", "--json"]),
)


def analysis_chain(work: Path) -> dict:
    """``lint``, ``sanitize`` and ``audit`` of the port through its CLI,
    one after another: each tier's rc, seconds and JSON report."""
    work.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, argv in ANALYSIS_TIERS:
        run = _start(CLI + argv, work / name, env=_port_env())
        proc, wall = _wait(run, 600, name)
        try:
            report = json.loads(proc.stdout)
        except json.JSONDecodeError:
            report = {"stdout": proc.stdout[-2000:]}
        out[name] = {"rc": proc.returncode, "seconds": round(wall, 2), "report": report,
                     "stderr": proc.stderr[-2000:] if proc.returncode else ""}
    return out


def analysis_phase(card: str, side: dict) -> dict:
    """Wait for :func:`analysis_chain` (started beside the other side
    runs): every tier rc 0 with no active finding and no stale baseline
    entry; the sanitizer ran every workload; the audit ran every hotpath
    entrypoint clean under sync-debug ``error`` (the health-guarded step
    under ``warn``, with exactly its one verdict read counted), every
    program pinned on the card, and its kernel entrypoints launched K1, K2
    and K3 (``ops.fused_matmul.grad``) and K4 (``ops.flash_attention.grad``)
    in the recorded call."""
    side["analysis"]["thread"].join(
        timeout=max(1.0, side["analysis"]["t0"] + 1500 - time.perf_counter()))
    check(not side["analysis"]["thread"].is_alive(),
          "the analysis tiers did not finish within 1500 s")
    if "error" in side["analysis"]:
        fail(f"analysis tiers: {side['analysis']['error']}")
    out = side["analysis"]["result"]
    for name, tier in out.items():
        report = tier["report"]
        check(tier["rc"] == 0 and report.get("ok") is True,
              f"{name} rc {tier['rc']}: {json.dumps(report)[-3000:]} {tier['stderr']}")
    sanitize = out["sanitize"]["report"]
    check(sorted(sanitize["workloads"]) == ["feeder", "journal", "serving", "trace", "workers"],
          f"sanitize ran {sanitize['workloads']}")
    audit = out["audit"]["report"]
    check(audit["device"] == "cuda" and len(audit["entrypoints"]) == 13,
          f"audit ran {audit['entrypoints']} on {audit['device']}")
    programs = audit["programs"]
    cold = {"sarimax.batched_fit"}  # declared cold in the registry, with its reason
    warned = {"train_step.classifier.health"}  # its one verdict read, counted under "warn"
    modes = {n: (p["sync_debug"], p["sync_error"], p["syncs"]) for n, p in programs.items()}
    check(all(modes[n] == ("warn", None, 1) if n in warned else modes[n] == ("error", None, None)
              for n in programs if n not in cold),
          f"audit: sync-debug (mode, error, count) per entrypoint {modes}")
    unpinned = {n: p["pin"] for n, p in programs.items() if p["pin"] != "pinned"}
    check(not unpinned, f"audit: programs not pinned on the card {unpinned}; re-pin with "
          "scripts/analysis_tiers_probe.py")
    fm = programs["ops.fused_matmul.grad"]
    k4 = programs["ops.flash_attention.grad"]
    check(all(fm["launches"][k] >= 1 for k in ("K1", "K2", "K3")) and k4["launches"]["K4"] >= 1,
          f"audit: kernel entrypoints launched {fm['launches']} and {k4['launches']} "
          "in the recorded call")
    summary = {name: {"rc": t["rc"], "seconds": t["seconds"],
                      "counts": t["report"].get("counts")} for name, t in out.items()}
    summary["sanitize"]["stats"] = sanitize["stats"]
    # The audit process's launches: warm-up and recorded call.
    summary["audit"]["launches"] = {"ops.fused_matmul.grad": fm["launches_total"],
                                    "ops.flash_attention.grad": k4["launches_total"]}
    summary["audit"]["sync_debug"] = modes
    summary["audit"]["pins"] = {n: p["pin"] for n, p in programs.items()}
    print(f"analysis ({card}): " + json.dumps(summary), flush=True)
    print("analysis tiers: " + ", ".join(f"{n} {t['seconds']:.1f} s" for n, t in out.items()),
          flush=True)
    return summary


def stop_sampler(side: dict) -> float:
    """Wait for the side runs the card's utilization is read over (the HPO
    chain, whose closure sweep it covers, tpe and the group-fit spec), stop
    the sampler, and return the card's idle share over the side-by-side
    block."""
    side["hpo"]["thread"].join(timeout=max(1.0, side["hpo"]["t0"] + 1500 - time.perf_counter()))
    _wait(side["tpe"], 1500, "forecast --search tpe")
    _wait(side["group_fit"], 1800, "demand_forecasting pipeline")
    side["sampler"].terminate()
    samples, _ = side["sampler"].communicate(timeout=60)
    side["util"] = util = _util_samples(samples)
    return _idle(util, 0, float("inf"))[0]


def child_result(side: dict, name: str, what: str) -> dict:
    """Wait for a :func:`child_main` process of the side-by-side block and
    return the JSON object of its last line."""
    proc, _ = _wait(side[name], 1500, what)
    check(proc.returncode == 0, f"{what} rc {proc.returncode}:\n{proc.stdout[-2000:]}"
          f"{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def child_main(argv: list[str]) -> int:
    """One check of the side-by-side block in a process of its own
    (``chip_smoke.py --child tpe_parity DEMAND`` or ``--child golden``,
    started by :func:`start_side_runs`): its result as the last line."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if argv[0] == "tpe_parity":
        out = tpe_parity(torch, argv[1])
    elif argv[0] == "golden":
        out = group_fit_golden(torch)
    else:
        fail(f"no child check named {argv[0]}")
    print(json.dumps(out), flush=True)
    return 0


def eda_phase(torch, card: str, side: dict) -> dict:
    """``eda --polish --max-evals 2 --parallelism 2 --max-iter 50`` (the
    CLI's 10, 10 and 200, cut for the script's time: each SARIMAX fit is
    bound by the host's dispatch), with ``--plot`` where matplotlib
    imports, on the group-fit table's first SKU (157 weeks, horizon 40,
    seasonal period 52), run beside the pipeline specs
    (:func:`start_side_runs`): 7 rows (4 Holt-Winters variants, 2 SARIMAX,
    1 tuned), every mse finite and positive, the best order inside the
    bounds, the PNG when asked, the run FINISHED with its 2 trials
    journaled; the wall time and its split over the families. Then each
    variant's Holt-Winters recursion at the golden fixture's pinned
    parameters and the forecast from its states, on the card against the
    CPU in float64: within 1e-9 relative."""
    import numpy as np

    from dss_ml_at_scale_tpu_torch.ops import holt_winters as hw

    run = side["eda"]
    proc, wall = _wait(run, 1200, "eda")
    check(proc.returncode == 0, f"eda failed: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    work, png = run["work"], run["work"] / "eda.png"
    lines = proc.stdout.strip().splitlines()
    rows = [ln.split() for ln in lines if ln.strip().startswith(("hw_", "sarimax"))]
    check(len(rows) == 7, f"eda printed {len(rows)} model rows:\n{proc.stdout[-2000:]}")
    names = [r[0] for r in rows]
    check({"hw_add", "hw_add_damped", "hw_mul", "hw_mul_damped", "sarimax_exog",
           "sarimax_no_exog"} <= set(names) and any(n.startswith("sarimax_tuned(")
                                                     for n in names), f"eda models {names}")
    mses = [float(r[-1]) for r in rows]
    check(all(math.isfinite(v) and v > 0 for v in mses), f"eda mse {mses}")
    best = next(ln for ln in lines if ln.startswith("best SARIMAX order: ("))
    p, d, q = (int(v) for v in best.split("(")[1].split(")")[0].split(","))
    check(0 <= p <= 4 and 0 <= d <= 2 and 0 <= q <= 4, f"eda best order {(p, d, q)}")
    if side["plot"]:
        check(png.exists() and png.stat().st_size > 5_000, "eda --plot wrote no figure")
    run_dir, meta, _, _ = _run_dir(work / "runs", "eda")
    check(meta["status"] == "FINISHED", f"eda run is {meta['status']}")
    trials = [e for e in map(json.loads, (run_dir / "journal.jsonl").read_text().splitlines())
              if e.get("event") == "trial"]
    check(len(trials) == EDA_EVALS, f"eda journaled {len(trials)} trials")
    seconds = json.loads(lines[-1])
    out = {"wall_s": round(wall, 2), "scores": dict(zip([n.split("(")[0] if n.startswith(
        "sarimax_tuned") else n for n in names], mses)), "best_order": [p, d, q],
        "seconds": {k: round(v, 2) for k, v in seconds.items()}, "plot": side["plot"],
        "png_bytes": png.stat().st_size if side["plot"] else 0}
    print(f"eda ({card}): " + " ".join(lines[:1] + [best]), flush=True)

    # Holt-Winters on the card against the CPU, float64, at pinned parameters.
    fix = json.loads(HW_GOLDEN.read_text())
    worst = 0.0
    for name, var in fix["variants"].items():
        got = {}
        for dev in ("cuda", "cpu"):
            y = torch.tensor(fix["y"], dtype=torch.float64, device=dev)
            pin = tuple(torch.tensor(var["pinned"][k], dtype=torch.float64, device=dev)
                        for k in ("alpha", "beta", "gamma", "phi"))
            sse, fitted, level, trend, season = hw._smooth(
                y, pin, hw._heuristic_init(y, fix["m"], var["seasonal"]), fix["m"],
                var["seasonal"], var["damped"])
            res = hw.HoltWintersResult(*pin, torch.tensor(1.0, dtype=torch.float64, device=dev),
                                       False, hw._SEASONAL_CODES[var["seasonal"]], level,
                                       trend, season, fitted, sse)
            got[dev] = (fitted.cpu().numpy(),
                        hw.holt_winters_forecast(res, fix["h_max"]).cpu().numpy())
        for a, b in zip(got["cuda"], got["cpu"]):
            rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))
            check(rel <= EDA_HW_TOL, f"holt-winters {name}: card vs CPU {rel:.3g} relative")
            worst = max(worst, rel)
    out["hw_card_vs_cpu_rel"] = worst
    return out


def _json_lines(text: str) -> list[dict]:
    rows = []
    for line in text.splitlines():
        if line.startswith("{"):
            try:
                rows.append(json.loads(line))
            except ValueError:
                continue
    return rows


def job_pipeline_phase(torch, card: str, side: dict) -> dict:
    """The port's ``pipeline`` on the card (``--task-device cuda``), each
    spec unchanged in its own workdir, started side by side with ``eda``
    (:func:`start_side_runs`): ``full_stack.json`` (every output it names:
    the forecast table, the predictions, ``weights.npz``, the ``lm`` line's
    ``sample_mean_true_prob`` with K4's launches counted by the task at
    head_dim 8, the train line's ``val_top2_acc``) and
    ``imagenet_train.json`` to ``pipeline ok`` (``demand_forecasting.json``
    is the group-fit phase's). A spec whose first
    task fails skips its dependent and returns 1. ``real_photos_train.json``
    (``datagen photos`` -> ``ingest`` -> ``train --model tiny`` for 8 epochs
    -> ``predict``) to ``pipeline ok``: 256 rows with ids 0..255,
    ``labels.json`` {china: 0, flower: 1}, every ``pred_label`` named from
    the checkpoint's ``label_names``, ``accuracy_vs_label_index`` over 0.6
    (the JAX package's slow test's bar). Each task's seconds."""
    import numpy as np

    out: dict = {}
    proc, wall = _wait(side["full_stack"], 2400, "full_stack pipeline")
    work = side["full_stack"]["work"]
    check(proc.returncode == 0 and proc.stdout.strip().endswith("pipeline ok"),
          f"full_stack pipeline failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    lines = _json_lines(proc.stdout)
    lm = next((j for j in lines if "sample_mean_true_prob" in j), None)
    train = next((j for j in lines if "val_top2_acc" in j), None)
    check(lm is not None and 0.0 < lm["sample_mean_true_prob"] <= 1.0, f"full_stack lm: {lm}")
    check(train is not None and 0.0 <= train["val_top2_acc"] <= 1.0,
          f"full_stack train: {train}")
    # 1 layer: one launch per train step (10), per val batch (5) and for
    # the --sample prefill.
    want = 1 * (10 + 5 + 1)
    check(lm["flash_launches"] == want,
          f"full_stack lm: K4 launched {lm['flash_launches']} times, want {want}")
    fc = _read_delta(work / "forecasts")
    check(fc.num_rows == 265 and bool(np.isfinite(fc.column("Demand_Fitted").to_numpy()).all()),
          f"full_stack forecasts: {fc.num_rows} rows")
    preds = _read_delta(work / "predictions")
    check(preds.num_rows == 128, f"full_stack predictions: {preds.num_rows} rows")
    check((work / "weights.npz").stat().st_size > 0, "full_stack: no weights.npz")
    out["full_stack"] = {
        "tasks": _task_seconds(proc.stdout), "wall_s": round(wall, 2),
        "lm_flash_launches": lm["flash_launches"],
        "sample_mean_true_prob": lm["sample_mean_true_prob"],
        "val_top2_acc": train["val_top2_acc"], "predictions": preds.num_rows}

    proc, wall = _wait(side["imagenet_train"], 1800, "imagenet_train pipeline")
    check(proc.returncode == 0 and proc.stdout.strip().endswith("pipeline ok"),
          f"imagenet_train pipeline failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    preds = _read_delta(side["imagenet_train"]["work"] / "predictions")
    check(preds.num_rows == 256, f"imagenet_train predictions: {preds.num_rows} rows")
    train = next(j for j in _json_lines(proc.stdout) if "val_acc" in j)
    check(train["steps"] == 32 and math.isfinite(train["train_loss"]),
          f"imagenet_train train: {train}")
    out["imagenet_train"] = {"tasks": _task_seconds(proc.stdout), "wall_s": round(wall, 2),
                             "val_acc": train["val_acc"], "predictions": preds.num_rows}

    proc, wall = _wait(side["failing"], 600, "failing pipeline")
    check(proc.returncode == 1 and "[bad] FAILED (exit" in proc.stdout
          and "[down] SKIPPED (failed dependency bad)" in proc.stdout
          and "pipeline failed: bad (skipped: down)" in proc.stdout,
          f"failing spec: rc {proc.returncode}\n{proc.stdout[-2000:]}")
    check(not (side["failing"]["work"] / "f").exists(), "failing spec: the skipped task ran")
    out["failing"] = {"rc": proc.returncode, "wall_s": round(wall, 2)}

    proc, wall = _wait(side["real_photos"], 1800, "real_photos_train pipeline")
    work = side["real_photos"]["work"]
    check(proc.returncode == 0 and proc.stdout.strip().endswith("pipeline ok"),
          f"real_photos_train pipeline failed:\n{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    table = _read_delta(work / "table")
    check(sorted(table.column("id").to_pylist()) == list(range(256)),
          f"real_photos table: {table.num_rows} rows, ids not 0..255")
    labels = json.loads((work / "table" / "labels.json").read_text())
    check(labels == {"china": 0, "flower": 1}, f"real_photos labels.json {labels}")
    names = json.loads((work / "ckpt" / "dsst_model.json").read_text())["label_names"]
    preds = _read_delta(work / "predictions").to_pylist()
    check(len(preds) == 256 and all(r["pred_label"] == names[r["pred_index"]] for r in preds),
          f"real_photos predictions: {len(preds)} rows, labels not named from {names}")
    acc = next((j for j in _json_lines(proc.stdout) if "accuracy_vs_label_index" in j), None)
    check(acc is not None and acc["accuracy_vs_label_index"] > 0.6,
          f"real_photos accuracy_vs_label_index {acc}")
    out["real_photos_train"] = {"tasks": _task_seconds(proc.stdout), "wall_s": round(wall, 2),
                                "rows": table.num_rows,
                                "accuracy_vs_label_index": acc["accuracy_vs_label_index"]}
    for name in ("full_stack", "imagenet_train", "real_photos_train"):
        print(f"pipeline {name} task seconds ({card}): {json.dumps(out[name]['tasks'])}",
              flush=True)
    return out


# ---------------------------------------------------------------------------
# The front of Track A (photos -> ingest -> train) and the HPO track
# ---------------------------------------------------------------------------

# Two train steps of 212 real-photo crops at the repo's Track A width.
PHOTOS_ROWS, PHOTOS_SIZE, PHOTOS_STEPS = 424, 256, 2
# The reference's <= 10 MB closure and ~100 MB regimes
# (hyperopt/2. hyperopt on diff sizes of data.py); its >= 1 GB shared-FS
# regime is cut for the script's time (PERF.md section 4).
HPO_CLOSURE_BYTES, HPO_SHARED_BYTES = "1e7", "1e8"
HPO_EVALS, HPO_PARALLELISM = 4, 2
# The remote sweep's length: long enough that a killed worker, started again
# on its address (a process start of seconds), rejoins it mid-sweep.
HPO_REMOTE_EVALS = 200
# Two trial workers share the host: each takes one BLAS thread, or their
# multithreaded BLAS calls oversubscribe the cores (a trial of the 100 MB
# Lasso took 2.7 s against 0.12 s so on an 8-core CPU host).
HPO_WORKER_ENV = {"OPENBLAS_NUM_THREADS": "1", "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def photos_train_phase(torch, card: str) -> dict:
    """``datagen photos --n 424 --size 256`` and ``ingest`` through the port's
    CLI, then ``train --pallas-fused --model resnet50 --batch-size 212
    --epochs 1 --limit-val-batches 1`` on the ingested table (the val table
    too) at the JAX CLI's other defaults (1000 classes, crop 224, bf16, Adam
    1e-5): 2 train steps and 1 eval batch on real camera JPEGs, alone on the
    card. Checks the table (424 rows, ids 0..423, labels.json), finite
    metrics and K1-K3's launches; prints step ms, images/s and data wait,
    and whether scikit-learn imports on this host (the port never loads
    it)."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_photos_"))
    raw, table = str(work / "raw"), str(work / "table")
    t0 = time.perf_counter()
    check(cli.main(["datagen", "photos", "--out", raw, "--n", str(PHOTOS_ROWS),
                    "--size", str(PHOTOS_SIZE)]) == 0, "datagen photos failed")
    t1 = time.perf_counter()
    check(cli.main(["ingest", "--data-root", raw, "--out", table]) == 0, "ingest failed")
    t2 = time.perf_counter()
    rows = _read_delta(table)
    check(sorted(rows.column("id").to_pylist()) == list(range(PHOTOS_ROWS)),
          f"ingest ids are not 0..{PHOTOS_ROWS - 1}")
    labels = json.loads((work / "table" / "labels.json").read_text())
    check(labels == {"china": 0, "flower": 1}, f"labels.json {labels}")
    args = cli.build_parser().parse_args([
        "train", "--data", table, "--val-data", table, "--model", "resnet50", "--pallas-fused",
        "--batch-size", str(BATCH), "--epochs", "1", "--limit-val-batches", "1"])
    # The main path: counts set to 0 just before, read just after.
    _zero_fused_launches()
    torch.cuda.reset_peak_memory_stats()
    t3 = time.perf_counter()
    summary = cli.run_train(args)
    wall = time.perf_counter() - t3
    launches = _fused_launches()
    epoch = summary["history"][0]
    check(summary["steps"] == PHOTOS_STEPS,
          f"photos train ran {summary['steps']} steps, want {PHOTOS_STEPS}")
    for key in ("train_loss", "train_acc", "grad_norm", "val_loss", "val_acc"):
        check(key in epoch and math.isfinite(epoch[key]), f"photos train metric {key}")
    want = {"K1": 16 * PHOTOS_STEPS + 16, "K2": 16 * PHOTOS_STEPS, "K3": 16 * PHOTOS_STEPS}
    check(launches == want, f"photos train kernel launches {launches}, want {want}")
    check("sklearn" not in sys.modules, "the port loaded scikit-learn")
    probe = subprocess.run([sys.executable, "-c", "import sklearn"], capture_output=True,
                           text=True, timeout=120)
    why = probe.stderr.strip().splitlines()[-1] if probe.returncode else ""
    print(f"photos: import sklearn {'works' if probe.returncode == 0 else 'fails: ' + why} "
          "on this host; the port's photos, ingest and train loaded none of it", flush=True)
    result = {
        "launches": launches, "rows": PHOTOS_ROWS, "datagen_s": round(t1 - t0, 2),
        "ingest_s": round(t2 - t1, 2), "train_wall_s": round(wall, 2),
        "train_loss": epoch["train_loss"], "val_loss": epoch["val_loss"],
        "step_ms_step_2": epoch["steady_step_time_s"] * 1e3,
        "images_per_sec_step_2": epoch["steady_images_per_sec"],
        "data_wait_ms_step_2": epoch["steady_data_wait_s"] * 1e3,
        "epoch_images_per_sec": epoch["images_per_sec"],
        "decode_backend": summary["decode_backend"],
        "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "sklearn_imports": probe.returncode == 0,
    }
    print(f"photos-train ({card}): " + json.dumps(result), flush=True)
    return result


def _hpo_cmd(work: Path, experiment: str, *args: str, plan: str | None = None) -> list[str]:
    """An ``hpo`` command of the port's CLI, its runs under ``work/runs``."""
    head = CLI + (["--fault-plan", plan] if plan else [])
    return head + ["hpo", "--tracking-root", str(work / "runs"), "--experiment", experiment,
                   *args]


def _hpo_runs(work: Path, experiment: str) -> list[Path]:
    root = work / "runs" / experiment
    return sorted(root.iterdir(), key=lambda p: p.stat().st_mtime) if root.is_dir() else []


def _journal_trials(run_dir: Path) -> list[dict]:
    from dss_ml_at_scale_tpu_torch.tracking import read_journal

    return [e for e in read_journal(run_dir) if e.get("event") == "trial"]


def _span_mean_s(run_dir: Path, name: str) -> float | None:
    path = run_dir / "artifacts" / "spans.jsonl"
    if not path.exists():
        return None
    durs = [e["dur"] for e in map(json.loads, path.read_text().splitlines()) if e["name"] == name]
    return round(sum(durs) / len(durs), 4) if durs else None


def _best_alpha(stdout: str, head: str) -> float:
    line = next((ln for ln in stdout.splitlines() if ln.startswith(head)), None)
    check(line is not None, f"no '{head}' line in:\n{stdout[-2000:]}")
    alpha = float(line.split("best alpha ")[1].split()[0])
    check(0.0 <= alpha <= 10.0, f"{head}: best alpha {alpha} outside [0, 10]")
    return alpha


def _start_worker(work: Path, name: str, bind: str, secret: Path) -> tuple[dict, str]:
    """A ``trial-worker`` of the port's CLI in its own session, and the
    address it prints (within 120 s)."""
    run = _start(CLI + ["trial-worker", "--bind", bind, "--secret-file", str(secret)],
                 work / name, env=_port_env(**HPO_WORKER_ENV), cwd=work)
    out = (work / name).with_suffix(".out")
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        text = out.read_text()
        if "listening on" in text:
            return run, text.split("listening on", 1)[1].split()[0]
        check(run["proc"].poll() is None,
              f"trial-worker {name} exited: {(work / name).with_suffix('.err').read_text()[-2000:]}")
        time.sleep(0.1)
    fail(f"trial-worker {name} printed no address within 120 s")


def _killpg(run: dict) -> None:
    import os
    import signal

    try:
        os.killpg(run["proc"].pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    run["proc"].wait(timeout=60)


def hpo_chain(work: Path) -> dict:
    """The HPO track through the port's CLI, host-bound, run beside the other
    side runs (:func:`start_side_runs` starts it on a thread):

    1. closure: ``hpo --bytes 1e7 --max-evals 4 --parallelism 2`` (the
       reference's <= 10 MB regime, its ``tune_alpha``), trials pinned to
       the card;
    2. ``datagen regression --bytes 1e8`` (the ~100 MB regime) as an npz;
    3. remote: two ``trial-worker`` processes (one BLAS thread each) with a
       shared secret, ``hpo --workers a,b --data <npz> --secret-file`` over
       200 evals; worker b
       SIGKILLed once 2 trials are journaled and started again on its
       address; the sweep ends with every trial ok and the restarted
       worker's own trial spans (pulled over RPC) count its evaluations;
    4. resume: the closure sweep at parallelism 1 with
       ``--fault-plan trial.evaluate=k1@2`` (the sweep SIGKILLs itself at
       its third trial), then ``hpo --resume-auto`` to 4.
    """
    import os
    import secrets

    from dss_ml_at_scale_tpu_torch.runtime.rpc import rpc_call

    out: dict = {}
    env = _port_env()
    # 1. closure
    t0, e0 = time.perf_counter(), time.time()
    proc = subprocess.run(_hpo_cmd(work, "closure", "--bytes", HPO_CLOSURE_BYTES,
                                   "--max-evals", str(HPO_EVALS), "--parallelism",
                                   str(HPO_PARALLELISM)),
                          capture_output=True, text=True, timeout=900, env=env, cwd=work)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"hpo closure rc {proc.returncode}:\n{proc.stderr[-3000:]}")
    (run_dir,) = _hpo_runs(work, "closure")
    trials = _journal_trials(run_dir)
    check(len(trials) == HPO_EVALS and all(t["status"] == "ok" for t in trials),
          f"hpo closure trials {trials}")
    out["closure"] = {"best_alpha": _best_alpha(proc.stdout, "hpo (closure)"),
                      "wall_s": round(wall, 2), "trial_span_s": _span_mean_s(run_dir, "trial"),
                      "window": [e0, time.time()]}
    # 2. the ~100 MB regime's dataset on a shared path
    npz = work / "regression.npz"
    proc = subprocess.run(CLI + ["datagen", "regression", "--bytes", HPO_SHARED_BYTES,
                                 "--out", str(npz)],
                          capture_output=True, text=True, timeout=600, env=env, cwd=work)
    check(proc.returncode == 0 and "regression: 99009+24753 samples" in proc.stdout,
          f"datagen regression: {proc.stdout[-1000:]}{proc.stderr[-2000:]}")
    out["regression_npz_bytes"] = npz.stat().st_size
    # 3. remote, one worker killed and started again on its address
    secret = work / "secret"
    secret.write_text(secrets.token_hex(16) + "\n")
    a, addr_a = _start_worker(work, "worker_a", "127.0.0.1:0", secret)
    b, addr_b = _start_worker(work, "worker_b", "127.0.0.1:0", secret)
    t0 = time.perf_counter()
    sweep = _start(_hpo_cmd(work, "remote", "--workers", f"{addr_a},{addr_b}", "--data",
                             str(npz), "--secret-file", str(secret), "--max-evals",
                             str(HPO_REMOTE_EVALS), "--parallelism", str(HPO_PARALLELISM)),
                    work / "remote", env=env, cwd=work)
    deadline = time.monotonic() + 600
    while not (_hpo_runs(work, "remote") and len(_journal_trials(_hpo_runs(work, "remote")[0])) >= 2):
        check(time.monotonic() < deadline, "the remote sweep journaled no 2 trials in 600 s")
        check(sweep["proc"].poll() is None, "the remote sweep ended before the kill")
        time.sleep(0.05)
    killed_at = len(_journal_trials(_hpo_runs(work, "remote")[0]))
    _killpg(b)
    b2, addr_b2 = _start_worker(work, "worker_b_again", addr_b, secret)
    check(addr_b2 == addr_b, f"the restarted worker bound {addr_b2}, not {addr_b}")
    proc, wall = _wait(sweep, 900, "hpo --workers")
    want = f"hpo (remote, 2 workers): best alpha "
    check(proc.returncode == 0 and want in proc.stdout
          and f"({HPO_REMOTE_EVALS}/{HPO_REMOTE_EVALS} trials ok)" in proc.stdout,
          f"hpo remote rc {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    spans = rpc_call(addr_b2, "telemetry_spans", timeout=60,
                     secret=secret.read_text().strip())
    by_restarted = sum(1 for e in spans if e.get("name") == "trial")
    check(by_restarted >= 1, "the restarted worker evaluated no trial")
    (run_dir,) = _hpo_runs(work, "remote")
    snap = json.loads((run_dir / "telemetry.json").read_text())
    readmitted = sum(m["value"] for m in snap["metrics"] if m["name"] == "worker_readmitted_total")
    check(readmitted >= 1, "the sweep re-admitted no worker")
    for run in (a, b2):
        _killpg(run)
    out["remote"] = {"best_alpha": _best_alpha(proc.stdout, "hpo (remote"),
                     "evals": HPO_REMOTE_EVALS, "wall_s": round(wall, 2),
                     "s_per_trial": round(wall / HPO_REMOTE_EVALS, 4),
                     "trial_span_s": _span_mean_s(run_dir, "trial"),
                     "killed_after_trials": killed_at, "restarted_worker_trials": by_restarted,
                     "readmitted": readmitted}
    # 4. a sweep killed after 2 trials, then --resume-auto to 4
    t0 = time.perf_counter()
    common = ("--bytes", HPO_CLOSURE_BYTES, "--max-evals", str(HPO_EVALS), "--parallelism", "1")
    proc = subprocess.run(_hpo_cmd(work, "resume", *common, plan="trial.evaluate=k1@2"),
                          capture_output=True, text=True, timeout=900, env=env, cwd=work)
    check(proc.returncode == -9, f"the killed sweep exited {proc.returncode}, not SIGKILL")
    (killed,) = _hpo_runs(work, "resume")
    check(len(_journal_trials(killed)) == 2, f"{len(_journal_trials(killed))} trials journaled")
    proc = subprocess.run(_hpo_cmd(work, "resume", *common, "--resume-auto"),
                          capture_output=True, text=True, timeout=900, env=env, cwd=work)
    check(proc.returncode == 0 and "continuing from 2 journaled trial(s)" in proc.stdout,
          f"hpo --resume-auto rc {proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    resumed = [r for r in _hpo_runs(work, "resume") if r != killed]
    check(len(resumed) == 1, f"resume runs {resumed}")
    tids = sorted(t["tid"] for t in _journal_trials(resumed[0]))
    check(tids == [2, 3] and all(t["status"] == "ok" for t in _journal_trials(resumed[0])),
          f"the resumed sweep journaled {tids}")
    meta = json.loads((killed / "meta.json").read_text())
    check(meta["status"] == "INTERRUPTED", f"the killed run is {meta['status']}")
    out["resume"] = {"best_alpha": _best_alpha(proc.stdout, "hpo (closure)"),
                     "wall_s": round(time.perf_counter() - t0, 2), "resumed_tids": tids}
    return out


def hpo_phase(card: str, side: dict) -> dict:
    """Wait for :func:`hpo_chain` (started beside the other side runs) and
    print its result: best alphas, seconds per trial, the restarted worker's
    trials, and the card's idle share over the closure sweep (sampled with
    the side runs beside it)."""
    side["hpo"]["thread"].join(timeout=max(1.0, side["hpo"]["t0"] + 1500 - time.perf_counter()))
    check(not side["hpo"]["thread"].is_alive(), "the hpo chain did not finish within 1500 s")
    if "error" in side["hpo"]:
        fail(f"hpo chain: {side['hpo']['error']}")
    out = side["hpo"]["result"]
    lo, hi = out["closure"].pop("window")
    out["closure"]["idle_share_side_by_side"] = _idle(side["util"], lo, hi)[0]
    out["wall_s"] = round(side["hpo"]["wall_s"], 2)
    print(f"hpo ({card}): " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# The LM's parallel extras (MoE, ring attention, the pipeline)
# ---------------------------------------------------------------------------

MOE_ARGS = ["--ffn", "moe", "--num-experts", "8", "--aux-loss-weight", "0.01"]
MOE_STEPS, MOE_E, MOE_AUX = 4, 8, 0.01
MOE_LM = dict(LM, ffn="moe", num_experts=MOE_E)


def _moe_argv(steps: int, *extra: str) -> list[str]:
    argv = [a for a in LM_TRAIN]
    argv[argv.index("--steps-per-epoch") + 1] = str(steps)
    return ["lm", *argv, *MOE_ARGS, *extra]


def moe_lm_phase(torch, card: str) -> dict:
    """``lm --ffn moe`` at full width: 2 epochs of 4 steps, 2 val batches,
    checkpoints and ``--sample 16``; K4's launches counted over the run."""
    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.datagen.tokens import TokenStreamConfig, token_batches
    from dss_ml_at_scale_tpu_torch.models import collect_aux_loss, next_token_loss, seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.parallel import LMTask
    from dss_ml_at_scale_tpu_torch.parallel import trainer as trainer_mod
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

    t_phase = time.perf_counter()
    stream = TokenStreamConfig(vocab_size=8192, batch_size=8, seq_len=2048,
                               concentration=0.05, seed=0)
    # The entry's seed-0 weights, untrained, on its val batches.
    untrained = seeded_lm(0, device="cuda", attention="flash", **MOE_LM)
    with torch.no_grad():
        losses = [float(next_token_loss(untrained(t), t)) for t in (
            torch.as_tensor(b["tokens"], device="cuda")
            for b in token_batches(stream, LM_VAL, sample_seed=100_000))]
    untrained_val = statistics.mean(losses)
    # Record the first step's batch and the train_loss the task returned
    # for it, and how long each checkpoint save took.
    first, saves = {}, []
    compute, save = LMTask.compute_update, trainer_mod._save

    def recording_compute(self, batch):
        metrics = compute(self, batch)
        if not first:
            first.update(tokens=batch["tokens"].clone(), loss=float(metrics["train_loss"]))
        return metrics

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        try:
            return save(*a, **kw)
        finally:
            saves.append(time.perf_counter() - t0)

    ckpt = tempfile.mkdtemp(prefix="chip_smoke_moe_")
    args = cli.build_parser().parse_args(
        _moe_argv(MOE_STEPS, "--epochs", "2", "--checkpoint-dir", ckpt, "--sample", str(LM_SAMPLE)))
    LMTask.compute_update, trainer_mod._save = recording_compute, timed_save
    try:
        # The main path: counts set to 0 just before, read just after.
        flash_attention.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        summary = cli.run_lm(args)
        wall = time.perf_counter() - t0
        launches = flash_attention.launches
    finally:
        LMTask.compute_update, trainer_mod._save = compute, save
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    layers = 4
    want = layers * (2 * MOE_STEPS + 2 * LM_VAL) + layers  # + the --sample prefill
    check(launches == want, f"moe-lm: K4 launched {launches} times, want {want}")
    check(summary["steps"] == 2 * MOE_STEPS, f"moe-lm ran {summary['steps']} steps")
    for h in summary["history"]:
        for key in ("train_loss", "train_ppl", "grad_norm", "val_loss", "val_ppl"):
            check(math.isfinite(h[key]), f"moe-lm metric {key}: {h[key]}")
    check(summary["val_loss"] < untrained_val,
          f"moe-lm val_loss {summary['val_loss']} not below the untrained {untrained_val}")
    check(len(summary["sample_tokens"]) == 4 + LM_SAMPLE, "moe-lm --sample length")
    report = integrity.verify_checkpoint_dir(ckpt)
    check(report and all(r["status"] == "intact" for r in report),
          f"moe-lm checkpoints not intact: {report}")
    # The reported objective: the next-token loss plus w * sum of the blocks'
    # aux losses, recomputed on the first step's batch with the weights it saw.
    with torch.no_grad():
        t = first["tokens"]
        ntl = float(next_token_loss(untrained(t), t))
        aux = float(collect_aux_loss(untrained))
    objective = ntl + MOE_AUX * aux
    obj_err = abs(first["loss"] - objective) / abs(objective)
    check(obj_err <= 1e-5, f"moe-lm train_loss {first['loss']} != next-token {ntl} + "
          f"{MOE_AUX} x aux {aux}")
    del untrained
    torch.cuda.empty_cache()
    steady = summary["history"][-1]
    result = {
        "launches": launches, "wall_s": wall, "steps": summary["steps"],
        "train_loss": summary["train_loss"], "val_loss": summary["val_loss"],
        "untrained_val_loss": untrained_val, "val_loss_by_epoch":
            [h["val_loss"] for h in summary["history"]],
        "first_step": {"train_loss": first["loss"], "next_token_loss": ntl, "aux_sum": aux,
                       "rel_err": obj_err},
        "steady_tokens_per_sec": steady["steady_tokens_per_sec"],
        "steady_step_ms": steady["steady_step_time_s"] * 1e3,
        "steady_data_wait_ms": steady["steady_data_wait_s"] * 1e3,
        "peak_memory_gib": peak,
        "checkpoint_bytes": [(Path(ckpt) / str(r["step"]) / "state.pt").stat().st_size
                             for r in report],
        "save_s": saves,
        "sample_mean_true_prob": summary["sample_mean_true_prob"],
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"moe-lm ({card}): " + json.dumps(result), flush=True)
    return result


def _route_spy(torch, logits: list | None = None):
    """Record every routing the port's MoE layers compute (and, given a
    list, their router logits), until undone."""
    from dss_ml_at_scale_tpu_torch.models import moe

    seen, real = [], moe.route

    def spy(tokens, weight, *a, **kw):
        seen.append(real(tokens, weight, *a, **kw))
        if logits is not None:
            with torch.no_grad():
                logits.append(torch.nn.functional.linear(tokens.float(), weight.float()))
        return seen[-1]

    moe.route = spy
    return seen, lambda: setattr(moe, "route", real)


def moe_parity_phase(torch, card: str) -> dict:
    """The MoE LM with flash against reference attention on one seeded batch
    at full width; the index dispatch against the dense one-hot plain
    version; routing on the card against the CPU in f32."""
    from dss_ml_at_scale_tpu_torch.models import (
        MoEMLP, collect_aux_loss, init_lm_state, moe_dense_reference, next_token_loss, seeded_lm,
    )
    from dss_ml_at_scale_tpu_torch.models.moe import route

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, 8192, (8, 2048), generator=gen, device="cuda")
    out = {}
    for attention in ("flash", "reference"):  # one model at a time
        router_logits = []
        seen, undo = _route_spy(torch, router_logits)
        try:
            model = seeded_lm(0, device="cuda", attention=attention, **MOE_LM).train()
            logits = model(tokens)
            loss = next_token_loss(logits, tokens) + MOE_AUX * collect_aux_loss(model)
            loss.backward()
        finally:
            undo()
        torch.cuda.synchronize()
        out[attention] = dict(
            logits=logits.detach(), loss=loss.item(),
            routes=[(r.expert, r.kept) for r in seen], router_logits=router_logits,
            grads=[(b.qkv.weight.grad.clone(), b.moe.w_up.grad.clone()) for b in model.blocks])
        del model, logits, loss
        torch.cuda.empty_cache()
    fl, rf = out["flash"], out["reference"]
    # The two attention implementations round differently in bf16, which
    # moves the router's logits a little: a token whose top-1 margin is
    # below that move may take another expert (and each such token moves
    # its two experts' capacity boundary by one place). Such a token is
    # routed apart; the logits are held on the tokens routed alike in
    # every block. Every change of expert must be explained by a margin
    # within twice the token's largest logit difference between the runs.
    alike = torch.ones(8 * 2048, dtype=torch.bool, device="cuda")
    flips, unexplained, keep_shifts = [], 0, []
    for (e1, k1), (e2, k2), l1, l2 in zip(fl["routes"], rf["routes"], fl["router_logits"],
                                          rf["router_logits"]):
        alike &= (e1 == e2) & (k1 == k2)
        flip = e1 != e2
        top2 = l2.topk(2, dim=-1).values
        unexplained += int((flip & (top2[:, 0] - top2[:, 1] > 2 * (l1 - l2).abs().amax(-1))).sum())
        flips.append(int(flip.sum()))
        keep_shifts.append(int((~flip & (k1 != k2)).sum()))
    apart = int((~alike).sum())
    mask = alike.view(8, 2048)
    logits_err = _rel(fl["logits"][mask], rf["logits"][mask])
    loss_err = abs(fl["loss"] - rf["loss"]) / abs(rf["loss"])
    grad_errs = {}
    for i, ((q1, w1), (q2, w2)) in enumerate(zip(fl["grads"], rf["grads"])):
        for name, a, b in (("qkv", q1, q2), ("w_up", w1, w2)):
            check(a.abs().max().item() > 0, f"block {i}: zero {name} gradient")
            grad_errs[f"{i}.{name}"] = _rel(a, b)
    finite = bool(torch.isfinite(fl["logits"]).all())
    del out, fl, rf
    torch.cuda.empty_cache()
    lm_parity = {"tokens_routed_apart": apart, "expert_flips_by_block": flips,
                 "keep_shifts_by_block": keep_shifts, "logits_rel_err": logits_err,
                 "loss_rel_err": loss_err, "grad_rel_errs": grad_errs}
    print("moe-parity LM: " + json.dumps(lm_parity), flush=True)
    check(finite, "non-finite MoE LM logits")
    check(unexplained == 0, f"moe parity: {unexplained} expert changes not explained by a "
          "margin within the logits' difference")
    check(all(k <= 2 * f for k, f in zip(keep_shifts, flips)),
          f"moe parity: capacity boundaries moved more than the flips explain: {keep_shifts}, "
          f"{flips}")
    check(apart <= 0.05 * alike.numel(), f"moe parity: {apart} tokens routed apart")
    check(logits_err <= PARITY_LOGITS, f"MoE LM logits differ by {logits_err} of max-abs")
    check(loss_err <= PARITY_LOGITS, f"MoE LM loss differs by {loss_err}")
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= LM_GRADS, f"block {worst} gradient differs by {grad_errs[worst]}")

    # One MoE layer at the full-width shape: index dispatch vs dense one-hot.
    layer = MoEMLP(1024, MOE_E, device="cuda")
    state = init_lm_state(seeded_lm(0, device="meta", **{**MOE_LM, "num_layers": 1}), 3)
    layer.load_state_dict({k[len("blocks.0.moe."):]: v for k, v in state.items()
                           if k.startswith("blocks.0.moe.")})
    x = torch.randn(8, 2048, 1024, generator=gen, device="cuda").to(torch.bfloat16)
    flat = x.view(-1, 1024)
    dense_layer = lambda: moe_dense_reference(  # noqa: E731
        flat, route(flat, layer.router.weight, MOE_E, 1.25), layer)
    seen, undo = _route_spy(torch)
    try:
        with torch.no_grad():
            index = layer(x).view(-1, 1024)
    finally:
        undo()
    with torch.no_grad():
        plain_route = route(flat, layer.router.weight, MOE_E, 1.25)
        dense = moe_dense_reference(flat, plain_route, layer)
    torch.cuda.synchronize()
    same_route = all(torch.equal(getattr(seen[0], f), getattr(plain_route, f))
                     for f in ("expert", "position", "kept"))
    check(same_route, "index and dense dispatch routed differently")
    check(torch.equal(index, dense), "the index dispatch differs from the dense one-hot form")
    dropped = int((~seen[0].kept).sum())
    with torch.no_grad():
        index_ms = device_ms(lambda: layer(x), launches=5)
        dense_ms = device_ms(dense_layer, launches=5)
        ffn_ms = device_ms(lambda: layer._experts(
            torch.zeros(MOE_E, seen[0].capacity, 1024, dtype=torch.bfloat16, device="cuda"),
            0, MOE_E), launches=5)
        route_ms = device_ms(lambda: route(x.view(-1, 1024), layer.router.weight, MOE_E, 1.25),
                             launches=5)
    # Routing in f32 on the card and on the CPU.
    tokens32 = x.view(-1, 1024).float()
    card_r = route(tokens32, layer.router.weight, MOE_E, 1.25)
    cpu_r = route(tokens32.cpu(), layer.router.weight.cpu(), MOE_E, 1.25)
    logits = (tokens32.double() @ layer.router.weight.double().t()).sort(dim=-1).values
    margin = (logits[:, -1] - logits[:, -2]).min().item()
    check(torch.equal(card_r.expert.cpu(), cpu_r.expert)
          and torch.equal(card_r.kept.cpu(), cpu_r.kept),
          f"f32 routing differs between the card and the CPU (least margin {margin})")
    del layer, x, index, dense
    torch.cuda.empty_cache()
    result = {
        **lm_parity, "grad_rel_err_max": grad_errs[worst], "dispatch_bit_equal": True, "capacity": seen[0].capacity, "dropped_tokens": dropped,
        "layer_index_ms": index_ms, "layer_dense_ms": dense_ms, "expert_ffn_ms": ffn_ms,
        "router_ms": route_ms, "f32_routing_card_eq_cpu": True, "f32_least_margin": margin,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"moe-parity ({card}): " + json.dumps(result), flush=True)
    return result


def _spawn_ranks(phase: str, world: int, timeout: float = 600) -> Path:
    """``world`` processes of this script on the one card (gloo), each
    running ``{phase}_work``; returns the directory of their results."""
    import os

    work = Path(tempfile.mkdtemp(prefix=f"chip_smoke_{phase}_"))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--par-rank",
                               phase, str(r), str(world), str(work)], env=env)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    check(rcs == [0] * world, f"{phase} ranks exited {rcs}")
    return work


def par_rank_main(phase: str, rank: int, world: int, work: str) -> int:
    """One rank of a multi-rank phase (``chip_smoke.py --par-rank PHASE R N
    DIR``, started by the phase): joins the gloo group, checks the
    collectives the phases run on CUDA tensors, then saves
    ``{phase}_work``'s result in ``DIR``."""
    import torch
    import torch.distributed as dist

    from dss_ml_at_scale_tpu_torch import runtime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # Bit-identical gradients from run to run, so the dp phase can hold
    # ZeRO-1 on and off to equality.
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    runtime.initialize_distributed(f"file://{work}/rdzv", world, rank, backend="gloo",
                                   device="cuda")
    try:
        t = torch.full((2,), float(rank + 1), device="cuda")
        dist.all_reduce(t)
        check(t.tolist() == [world * (world + 1) / 2] * 2, f"gloo all_reduce gave {t.tolist()}")
        parts = [torch.empty(1, device="cuda") for _ in range(world)]
        dist.all_gather(parts, torch.full((1,), float(rank), device="cuda"))
        check([p.item() for p in parts] == list(range(world)), "gloo all_gather of CUDA tensors")
        b = torch.full((1,), float(rank), device="cuda")
        dist.broadcast(b, src=world - 1)
        check(b.item() == world - 1, "gloo broadcast of a CUDA tensor")
        x = torch.arange(world, device="cuda", dtype=torch.float32) + 10 * rank
        got = runtime.all_to_all(x.view(world, 1)).view(-1)
        check(got.tolist() == [10 * j + rank for j in range(world)],
              f"all_to_all of a CUDA tensor gave {got.tolist()}")
        hop = runtime.ring_shift(torch.full((3,), float(rank), device="cuda"))
        check(hop.device.type == "cuda" and hop.tolist() == [float((rank - 1) % world)] * 3,
              f"ring_shift of a CUDA tensor gave {hop.tolist()}")
        print(f"{phase} rank {rank}: gloo all_reduce, all_gather, broadcast, all_to_all and "
              f"send/recv of CUDA tensors checked; copied through host memory: "
              f"{runtime.host_routed()}", flush=True)
        result = globals()[f"{phase}_work"](torch, rank, world)
        result["host_routed"] = runtime.host_routed()
        torch.save(result, Path(work) / f"rank{rank}.pt")
    finally:
        runtime.shutdown_distributed()
    return 0


def _moe_batch(torch):
    gen = torch.Generator(device="cuda").manual_seed(21)
    return torch.randint(0, 8192, (8, 2048), generator=gen, device="cuda")


def moe_dp_work(torch, rank: int, world: int) -> dict:
    """One DDP step of ``LMTask`` on the MoE LM (aux weight 0.01) at this
    rank's rows of the seeded batch (world 1: the one-process reference at
    the whole batch): loss, aux, per-block gradients, the experts run."""
    import torch.distributed as dist

    from dss_ml_at_scale_tpu_torch.models import collect_aux_loss, seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.parallel import LMTask, Trainer, TrainerConfig

    multi = world > 1
    model = seeded_lm(0, device="cuda", attention="flash", **MOE_LM,
                      expert_group=dist.group.WORLD if multi else None, shard_experts=multi)
    task = LMTask(model=model, aux_loss_weight=MOE_AUX)
    Trainer(TrainerConfig(), device="cuda").data_parallel(task)
    rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
    tokens = _moe_batch(torch)[rows].contiguous()
    torch.cuda.synchronize()
    # The main path of this phase: the count set to 0 just before, read after.
    flash_attention.launches = 0
    t0 = time.perf_counter()
    metrics = task.compute_update({"tokens": tokens})
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = flash_attention.launches
    stats = torch.stack([metrics["train_loss"].float(), collect_aux_loss(model).detach()])
    if multi:
        dist.all_reduce(stats)
        stats /= world
    out = {"rank": rank, "loss": stats[0].item(), "aux": stats[1].item(), "step_ms": step_ms,
           "launches": launches, "experts": [b.moe.computed_experts for b in model.blocks],
           "grads": {}}
    for i, b in enumerate(model.blocks):
        out["grads"][f"{i}.qkv"] = b.qkv.weight.grad.float().cpu()
        out["grads"][f"{i}.w_up"] = b.moe.w_up.grad.float().cpu()
        out["grads"][f"{i}.router"] = b.moe.router.weight.grad.float().cpu()
    del task, model
    torch.cuda.empty_cache()
    return out


def moe_dp_phase(torch, card: str) -> dict:
    """Two gloo ranks on the card, batch 4 each, expert-sharded, against one
    process at batch 8 on the same seeded weights and data."""
    t_phase = time.perf_counter()
    ref = moe_dp_work(torch, 0, 1)
    torch.cuda.empty_cache()
    work = _spawn_ranks("moe_dp", 2)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    loss_err = abs(ranks[0]["loss"] - ref["loss"]) / abs(ref["loss"])
    aux_err = abs(ranks[0]["aux"] - ref["aux"]) / abs(ref["aux"])
    check(math.isfinite(ranks[0]["loss"]) and loss_err <= PARITY_LOGITS,
          f"moe-dp loss {ranks[0]['loss']} vs one process {ref['loss']}")
    check(aux_err <= PARITY_LOGITS, f"moe-dp aux {ranks[0]['aux']} vs one process {ref['aux']}")
    for r in ranks:
        want = [(4 * r["rank"], 4 * r["rank"] + 4)] * 4
        check(r["experts"] == want, f"moe-dp rank {r['rank']} ran experts {r['experts']}")
        check(r["launches"] == 4, f"moe-dp rank {r['rank']}: K4 launched {r['launches']} "
              "times in the step, want 4 (one per block)")
    grad_errs = {n: _rel(ranks[0]["grads"][n], g) for n, g in ref["grads"].items()}
    worst = max(grad_errs, key=grad_errs.get)
    check(grad_errs[worst] <= PARITY_GRADS, f"moe-dp {worst}: gradient differs by "
          f"{grad_errs[worst]} of max-abs")
    check(min(g.abs().max().item() for g in ranks[0]["grads"].values()) > 0,
          "a moe-dp block gradient is zero")
    check(all(torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]) for n in grad_errs),
          "the ranks' DDP gradients differ")
    result = {"loss": ranks[0]["loss"], "loss_one_process": ref["loss"], "loss_rel_err": loss_err,
              "aux": ranks[0]["aux"], "aux_one_process": ref["aux"], "aux_rel_err": aux_err,
              "grad_rel_err_max": grad_errs[worst], "worst": worst,
              "experts_per_rank": [r["experts"][0] for r in ranks],
              "launches_per_rank": [r["launches"] for r in ranks],
              "step_ms_two_ranks": [r["step_ms"] for r in ranks],
              "step_ms_one_process": ref["step_ms"], "host_routed": ranks[0]["host_routed"],
              "phase_s": time.perf_counter() - t_phase}
    print(f"moe-dp ({card}; two ranks on one card are no scaling result): "
          + json.dumps(result), flush=True)
    return result


def _ring_inputs(torch):
    gen = torch.Generator(device="cuda").manual_seed(31)
    qkv = [torch.randn(8, 8, 2048, 128, generator=gen, device="cuda").to(torch.bfloat16)
           for _ in range(3)]
    cot = torch.randn(8, 8, 2048, 128, generator=gen, device="cuda").to(torch.bfloat16)
    return qkv, cot


def ring_work(torch, rank: int, world: int) -> dict:
    """This rank's half of the sequence: ring attention at causal b8 h8
    s2048 d128 bf16 with its gradients; one train step of the ring LM; the
    hop's ms."""
    import torch.distributed as dist

    from dss_ml_at_scale_tpu_torch import runtime
    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.parallel import LMTask, ring_attention

    g = dist.group.WORLD
    qkv, cot = _ring_inputs(torch)
    part = slice(rank * 1024, (rank + 1) * 1024)
    times = []
    for _ in range(2):  # the second call is timed: the first sets up the library handles
        leaves = [t[:, :, part].contiguous().requires_grad_() for t in qkv]
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = ring_attention(*leaves, group=g, causal=True)
        o.backward(cot[:, :, part])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out = {"attn_ms": times[-1], "attn_first_ms": times[0], "out": o.detach().cpu(),
           "grads": [t.grad.cpu() for t in leaves]}
    kv = torch.stack((leaves[1].detach(), leaves[2].detach()))
    hops = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runtime.ring_shift(kv, g)
        torch.cuda.synchronize()
        hops.append((time.perf_counter() - t0) * 1e3)
    out["hop_ms"] = statistics.median(hops[1:])
    out["hop_bytes"] = kv.numel() * kv.element_size()
    del qkv, cot, leaves, o, kv
    torch.cuda.empty_cache()
    task = LMTask(model=seeded_lm(0, device="cuda", attention="ring", group=g, **LM))
    metrics = task.compute_update({"tokens": _moe_batch(torch)})
    out["lm_loss"] = metrics["train_loss"].item()
    out["qkv_grads"] = [b.qkv.weight.grad.float().cpu() for b in task.model.blocks]
    del task
    torch.cuda.empty_cache()
    return out


def ring_phase(torch, card: str) -> dict:
    """Two gloo ranks, the sequence split 1024 + 1024, against one process."""
    from dss_ml_at_scale_tpu_torch.models import next_token_loss, seeded_lm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import attention_reference

    t_phase = time.perf_counter()
    work = _spawn_ranks("ring", 2)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    qkv, cot = _ring_inputs(torch)
    leaves = [t.clone().requires_grad_() for t in qkv]
    ref = attention_reference(*leaves, causal=True)
    ref.backward(cot)
    errs = {"out": _rel(torch.cat([r["out"] for r in ranks], dim=2), ref.detach().cpu())}
    for i, name in enumerate(("dq", "dk", "dv")):
        got = torch.cat([r["grads"][i] for r in ranks], dim=2)
        check(got.abs().max().item() > 0, f"ring {name} is zero")
        errs[name] = _rel(got, leaves[i].grad.cpu())
    for k, e in errs.items():
        check(e <= ATOL, f"ring attention {k} differs by {e} of max-abs")
    del qkv, cot, leaves, ref
    torch.cuda.empty_cache()
    model = seeded_lm(0, device="cuda", attention="reference", **LM).train()
    tokens = _moe_batch(torch)
    loss = next_token_loss(model(tokens), tokens)
    loss.backward()
    loss_err = abs(ranks[0]["lm_loss"] - loss.item()) / abs(loss.item())
    check(loss_err <= PARITY_LOGITS, f"ring LM loss {ranks[0]['lm_loss']} vs {loss.item()}")
    qkv_errs = []
    for i, b in enumerate(model.blocks):
        for r in ranks:
            qkv_errs.append(_rel(r["qkv_grads"][i], b.qkv.weight.grad.cpu()))
            check(qkv_errs[-1] <= LM_GRADS, f"ring LM block {i}: qkv gradient differs by "
                  f"{qkv_errs[-1]}")
    one_process = loss.item()
    del model, loss
    torch.cuda.empty_cache()
    result = {"attention_rel_err": errs, "lm_loss": ranks[0]["lm_loss"],
              "lm_loss_one_process": one_process, "lm_loss_rel_err": loss_err, "qkv_grad_rel_err_max": max(qkv_errs),
              "hop_ms": [r["hop_ms"] for r in ranks], "hop_bytes": ranks[0]["hop_bytes"],
              "attention_fwd_bwd_ms": [r["attn_ms"] for r in ranks],
              "attention_fwd_bwd_first_ms": [r["attn_first_ms"] for r in ranks],
              "host_routed": ranks[0]["host_routed"], "phase_s": time.perf_counter() - t_phase}
    print(f"ring ({card}; two ranks on one card are no scaling result): " + json.dumps(result),
          flush=True)
    return result


PIPE = dict(vocab_size=8192, dim=1024, num_heads=8, max_seq=2048)
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 4, 4, 2


def _pipe_tokens(torch):
    gen = torch.Generator(device="cuda").manual_seed(41)
    return torch.randint(0, 8192, (PIPE_MICRO, PIPE_MB, 2048), generator=gen, device="cuda")


def pipeline_work(torch, rank: int, world: int) -> dict:
    """This rank's stage of the 4-stage PipelinedLM (seed-0 weights, f32):
    the logits of 4 microbatches of 2, then one PipelinedLMTask step."""
    from dss_ml_at_scale_tpu_torch import telemetry
    from dss_ml_at_scale_tpu_torch.models import (
        PipelinedLM, PipelinedLMTask, init_pipelined_lm_state,
    )
    from dss_ml_at_scale_tpu_torch.parallel import pipe_grid

    grid = pipe_grid(PIPE_STAGES)
    lm = PipelinedLM(**PIPE, grid=grid, device="cuda")
    lm.load_state_dict(init_pipelined_lm_state(lm, 0))
    tokens = _pipe_tokens(torch)
    with torch.no_grad():
        lm(tokens)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = lm(tokens)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
    task = PipelinedLMTask(lm)
    units = task.batch_units({"tokens": tokens})  # publishes the gauge
    util = next(m["value"] for m in telemetry.snapshot()["metrics"]
                if m["name"] == "pipeline_utilization")
    metrics = task.compute_update({"tokens": tokens})
    torch.cuda.synchronize()
    out = {"stage": grid.stage, "units": units, "utilization": util, "forward_ms": fwd_ms,
           "tick_ms": fwd_ms / (PIPE_MICRO + PIPE_STAGES - 1),
           "loss": metrics["train_loss"].item(),
           "grads": {n: p.grad.cpu() for n, p in lm.named_parameters()}}
    if rank == 0:
        out["logits"] = logits.cpu()
    del lm, task, logits
    torch.cuda.empty_cache()
    return out


def pipeline_phase(torch, card: str) -> dict:
    """Four gloo ranks, one stage each, against the same blocks run in
    sequence in one process."""
    from dss_ml_at_scale_tpu_torch.models import (
        PipelinedLM, init_pipelined_lm_state, next_token_loss, rms_norm,
    )
    from dss_ml_at_scale_tpu_torch.models.transformer import _select_attention
    from dss_ml_at_scale_tpu_torch.parallel import PipeGrid

    t_phase = time.perf_counter()
    work = _spawn_ranks("pipeline", PIPE_STAGES)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(PIPE_STAGES)]
    # The same weights in one process: every stage's block, in sequence.
    stages = [PipelinedLM(**PIPE, grid=PipeGrid(PIPE_STAGES, 1, s, 0), device="cuda")
              for s in range(PIPE_STAGES)]
    for lm in stages:
        lm.load_state_dict(init_pipelined_lm_state(lm, 0))
    head = stages[0]
    attention = _select_attention("reference")
    tokens = _pipe_tokens(torch)
    x = torch.nn.functional.embedding(tokens, head.tok) + head.pos[:2048]
    for lm in stages:
        x = torch.stack([lm.block(x[m], attention) for m in range(PIPE_MICRO)])
    logits = rms_norm(x, head.norm_scale) @ head.head
    logits_err = (ranks[0]["logits"] - logits.detach().cpu()).abs().max().item()
    check(logits_err <= 2e-5, f"pipeline logits differ from the sequential blocks by {logits_err}")
    loss = next_token_loss(logits.reshape(-1, 2048, 8192), tokens.reshape(-1, 2048))
    loss.backward()
    check(abs(ranks[0]["loss"] - loss.item()) <= 1e-5 * abs(loss.item()),
          f"pipeline loss {ranks[0]['loss']} vs sequential {loss.item()}")
    worst = 0.0
    for r in ranks:
        want = {f"block.{n}": p.grad.cpu() for n, p in stages[r["stage"]].block.named_parameters()}
        want.update({n: getattr(head, n).grad.cpu() for n in ("tok", "pos", "norm_scale", "head")})
        for n, g in r["grads"].items():
            w = want[n]
            bad = (g - w).abs() > 1e-5 + 1e-4 * w.abs()
            check(not bad.any(), f"pipeline stage {r['stage']} {n}: gradient off by "
                  f"{(g - w).abs().max().item()}")
            worst = max(worst, ((g - w).abs() / (1e-5 + 1e-4 * w.abs())).max().item())
    check(all(r["utilization"] == 4 / 7 for r in ranks),
          f"pipeline_utilization {[r['utilization'] for r in ranks]}, want 4/7")
    del stages, head, x, logits, loss
    torch.cuda.empty_cache()
    result = {"logits_max_abs_err": logits_err, "grad_worst_over_tolerance": worst,
              "loss": ranks[0]["loss"], "utilization": ranks[0]["utilization"],
              "tick_ms": [r["tick_ms"] for r in ranks],
              "forward_ms": [r["forward_ms"] for r in ranks],
              "host_routed": ranks[0]["host_routed"], "phase_s": time.perf_counter() - t_phase}
    print(f"pipeline ({card}; four ranks on one card are no scaling result): "
          + json.dumps(result), flush=True)
    return result


# -- slice 10: image serving, the ViT, ring attention with MoE ---------------

SERVE_ROUNDS = 8  # requests per single-image client
SERVE_BATCHES = tuple(range(1, 21))  # JSON batch sizes, cycled over the table


def serve_child_main(argv: list[str]) -> int:
    """``chip_smoke.py --serve-child ARGS``: the port's ``serve`` command in
    this process (TF32 off, as ``predict`` runs in the parent), then one
    JSON line with every kernel's launch count over the server's life."""
    import torch

    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rc = cli.main(["serve", *argv])
    print(json.dumps({"serve_rc": rc, "launches": {
        "K1": fm.bn_relu_matmul_fwd.launches, "K2": fm.bn_relu_matmul_bwd_da.launches,
        "K3": fm.bn_relu_matmul_bwd_dw.launches, "K4": flash_attention.launches}}), flush=True)
    return rc


def _http(port: int, body: bytes, content_type: str, timeout: float = 60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    conn.request("POST", "/predict", body=body, headers={"Content-Type": content_type})
    resp = conn.getresponse()
    raw = resp.read()
    ms = (time.perf_counter() - t0) * 1e3
    headers = dict(resp.getheaders())
    conn.close()
    return resp.status, json.loads(raw), headers, ms


SERVE_HISTOGRAMS = ("serving_batch_fill", "predict_batch_seconds",
                    "serving_time_in_queue_seconds")


def _histograms(port: int) -> dict[str, tuple[float, float]]:
    """``{name: (sum, count)}`` of the unlabelled ``SERVE_HISTOGRAMS`` on the
    server's /metrics."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/metrics")
    text = conn.getresponse().read().decode()
    conn.close()
    vals = {}
    for line in text.splitlines():
        name, _, value = line.partition(" ")
        if name.endswith(("_sum", "_count")):
            vals[name] = float(value)
    return {n: (vals.get(n + "_sum", 0.0), vals.get(n + "_count", 0.0))
            for n in SERVE_HISTOGRAMS}


def _means(before: dict, after: dict) -> dict:
    """Each histogram's mean over the window between two scrapes."""
    return {n: (after[n][0] - before[n][0]) / max(after[n][1] - before[n][1], 1)
            for n in SERVE_HISTOGRAMS}


def _in_threads(n: int, fn) -> list:
    """``fn(i)`` for ``i < n`` on ``n`` threads started together; a
    thread's failure (a failed check too) fails the phase."""
    barrier = threading.Barrier(n)
    out: list = [None] * n
    errors: list = []

    def run(i):
        barrier.wait()
        try:
            out[i] = fn(i)
        except BaseException as e:  # SystemExit from check() included
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    check(not any(t.is_alive() for t in threads), "a client thread did not finish")
    if errors:
        raise errors[0]
    return out


def _serve_traffic(port: int, jpegs: list[bytes], flood: bool) -> tuple[dict, dict, list]:
    """32 concurrent single-image clients (``SERVE_ROUNDS`` requests each),
    then 3 concurrent clients posting the table as JSON batches of 1-20
    images, twice (at most 60 images pending: under the 64-image queue,
    so none is refused); the card's utilization sampled meanwhile. With
    ``flood``: 8 concurrent 20-image requests against the 64-image queue."""
    import base64

    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=timestamp,utilization.gpu", "--format=csv,noheader,nounits",
         "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        h0 = _histograms(port)
        t0 = time.perf_counter()
        singles = _in_threads(32, lambda i: [
            ((i * SERVE_ROUNDS + r) % len(jpegs),
             *_http(port, jpegs[(i * SERVE_ROUNDS + r) % len(jpegs)], "image/jpeg"))
            for r in range(SERVE_ROUNDS)])
        singles_s = time.perf_counter() - t0
        h1 = _histograms(port)
        chunks, lo = [], 0
        while lo < len(jpegs):
            size = SERVE_BATCHES[len(chunks) % len(SERVE_BATCHES)]
            chunks.append((lo, jpegs[lo:lo + size]))
            lo += size
        served: dict[int, dict] = {}

        def client(i):
            rows = []
            for k in range(i, 2 * len(chunks), 3):  # the table twice
                lo, part = chunks[k % len(chunks)]
                body = json.dumps({"instances": [base64.b64encode(j).decode() for j in part]})
                status, payload, _, ms = _http(port, body.encode(), "application/json")
                check(status == 200, f"image-serve JSON batch of {len(part)}: {status} {payload}")
                rows.append((lo, payload["predictions"], ms, len(part)))
            return rows

        t0 = time.perf_counter()
        batches = [r for rows in _in_threads(3, client) for r in rows]
        batches_s = time.perf_counter() - t0
        h2 = _histograms(port)
    finally:
        sampler.terminate()
        samples, _ = sampler.communicate(timeout=60)
    for lo, preds, _, n in batches:
        check(len(preds) == n, f"image-serve: {len(preds)} predictions for {n} images")
        for k, p in enumerate(preds):
            served.setdefault(lo + k, p)
    lat = [ms for rows in singles for *_, ms in rows]
    served_singles = []
    for rows in singles:
        for row, status, payload, _, _ in rows:
            check(status == 200 and len(payload["predictions"]) == 1,
                  f"image-serve single: {status} {payload}")
            served_singles.append((row, payload["predictions"][0]))
    util = [u for _, u in _util_samples(samples)]
    singles_mean, batches_mean = _means(h0, h1), _means(h1, h2)
    out = {
        "single_requests": len(lat),
        "single_p50_ms": statistics.median(lat),
        "single_p99_ms": sorted(lat)[max(0, math.ceil(0.99 * len(lat)) - 1)],
        "single_images_per_s": len(lat) / singles_s,
        "single_mean_batch_fill": singles_mean["serving_batch_fill"],
        "single_score_ms_per_batch": singles_mean["predict_batch_seconds"] * 1e3,
        "single_time_in_queue_ms": singles_mean["serving_time_in_queue_seconds"] * 1e3,
        "batch_requests": len(batches),
        "batch_p50_ms": statistics.median(ms for *_, ms, _ in batches),
        "batch_p99_ms": sorted(ms for *_, ms, _ in batches)[
            max(0, math.ceil(0.99 * len(batches)) - 1)],
        "batch_images_per_s": sum(n for *_, n in batches) / batches_s,
        "batch_mean_batch_fill": batches_mean["serving_batch_fill"],
        "batch_score_ms_per_batch": batches_mean["predict_batch_seconds"] * 1e3,
        "batch_time_in_queue_ms": batches_mean["serving_time_in_queue_seconds"] * 1e3,
        "idle_share": round(1.0 - sum(util) / max(len(util), 1) / 100.0, 3),
        "util_samples": len(util),
    }
    if flood:
        big = json.dumps({"instances": [base64.b64encode(j).decode()
                                        for j in jpegs[:20]]}).encode()
        statuses, retry = [], []
        for _ in range(5):
            for status, payload, headers, _ in _in_threads(
                    8, lambda i: _http(port, big, "application/json")):
                statuses.append(status)
                if status == 429:
                    retry.append(int(headers["Retry-After"]))
                    check("full" in payload["error"], f"429 without the queue: {payload}")
            if retry:
                break
        check(retry and min(retry) >= 1, f"no 429 with Retry-After in a flood: {statuses}")
        check(set(statuses) <= {200, 429}, f"flood statuses {statuses}")
        out.update(flood_statuses={s: statuses.count(s) for s in set(statuses)},
                   retry_after_s=sorted(set(retry)))
    return out, served, served_singles


def _predict_rows(cli, data: str, ckpt: str, batch: int, device: str) -> tuple[dict, dict]:
    """``predict`` through the port's CLI in this process: its JSON line and
    ``{row: (pred_index, pred_prob)}``."""
    import contextlib
    import io

    out = tempfile.mkdtemp(prefix="chip_smoke_predict_")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["predict", "--data", data, "--checkpoint-dir", ckpt, "--out", out,
                       "--batch-size", str(batch), "--device", device])
    check(rc == 0, f"predict exited {rc}: {buf.getvalue()[-2000:]}")
    table = _read_delta(out).to_pylist()
    return (json.loads(buf.getvalue().strip().splitlines()[-1]),
            {r["row"]: (r["pred_index"], r["pred_prob"]) for r in table})


def image_serve_phase(torch, tables, ckpt: str, card: str, device: str = "cuda") -> dict:
    """The train-flags phase's ResNet-50 checkpoint (``--pallas-fused``,
    full width) behind ``serve`` in a subprocess at the JAX defaults, then
    at ``--micro-batch 32``: traffic, predictions equal to ``predict`` on
    the same rows at the same batch shape, no fused-matmul kernel (the
    checkpoint scores at the fused level), a flood's 429s, the SIGINT
    drain."""
    import os
    import signal

    from dss_ml_at_scale_tpu_torch.config import cli

    t_phase = time.perf_counter()
    _, val = tables
    jpegs = _read_delta(val).column("content").to_pylist()
    meta = json.loads((Path(ckpt) / "dsst_model.json").read_text())
    check(meta["fused_bn"] == "pallas" and meta["model"] == "resnet50",
          f"image-serve checkpoint meta {meta}")
    result: dict = {"checkpoint": {k: meta[k] for k in ("model", "fused_bn", "crop",
                                                        "num_classes")}}
    # The host's decode of one JPEG, on one thread, as a decode worker runs it.
    import numpy as np

    from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec

    spec = imagenet_transform_spec(crop=int(meta["crop"]))
    t0 = time.perf_counter()
    for jpeg in jpegs:
        spec({"content": np.array([jpeg], dtype=object), "label_index": np.zeros(1, np.int64)})
    result["decode_ms_per_image_one_thread"] = (time.perf_counter() - t0) * 1e3 / len(jpegs)
    result["decode_backend"] = spec.backend
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(Path(__file__).resolve().parent), os.environ.get("PYTHONPATH", "")]))
    for micro in (8, 32):
        # predict at the server's batch shape, on the same rows: the main
        # path's counts set to 0 just before, read just after.
        _zero_fused_launches()
        summary, want = _predict_rows(cli, val, ckpt, micro, device)
        check(_fused_launches()["K1"] == 0, f"predict launched K1: {_fused_launches()}")
        check(summary["rows"] == len(jpegs), f"predict scored {summary['rows']} rows")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--serve-child",
             "--checkpoint-dir", ckpt, "--port", "0", "--micro-batch", str(micro),
             "--device", device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            boot = json.loads(proc.stdout.readline())
            boot_s = time.perf_counter() - t0
            check(boot["model"] == "resnet50" and boot["micro_batch"] == micro
                  and boot["queue_depth"] == 64 and boot["batch_window_ms"] == 5.0
                  and boot["deadline_ms"] == 2000.0, f"serve boot line {boot}")
            traffic, served, singles = _serve_traffic(boot["port"], jpegs, flood=micro == 8)
            if micro == 8:
                result["slo_top"] = serving_ops_checks(boot["port"], "serve", fleet=True)
            proc.send_signal(signal.SIGINT)
            out, err = proc.communicate(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        check(proc.returncode == 0, f"serve exited {proc.returncode}: {err[-3000:]}")
        lines = [json.loads(x) for x in out.strip().splitlines()]
        check(lines[0].get("draining") is True, f"serve drain line {lines[0]}")
        launches = lines[-1]["launches"]
        check(launches["K1"] == 0, f"serve launched K1 {launches['K1']} times: the checkpoint "
              "must score at the fused level")
        check(sorted(served) == list(range(len(jpegs))), "image-serve missed rows")
        # Every JSON-batch row and every single (coalesced across requests
        # into mixed batches) against predict's row for the same image.
        rows = [*served.items(), *singles]
        wrong = sorted({i for i, p in rows if p["pred_index"] != want[i][0]})
        check(not wrong, f"served != predict on rows {wrong[:10]} at micro-batch {micro}")
        prob_err = max(abs(p["pred_prob"] - want[i][1]) for i, p in rows)
        check(prob_err <= 1e-6, f"served pred_prob differs from predict's by {prob_err}")
        result[f"micro_batch_{micro}"] = {**traffic, "boot_s": boot_s, "launches": launches,
                                          "predict_accuracy": summary["accuracy_vs_label_index"],
                                          "pred_prob_max_diff": prob_err}
    result["phase_s"] = time.perf_counter() - t_phase
    print(f"image-serve ({card}): " + json.dumps(result), flush=True)
    return result


def vit_phase(torch, tables, card: str) -> dict:
    """``train --model vit-s16`` at full width (batch 212, crop 224, 1000
    classes, 4 steps, 1 eval batch), ``predict``, ``export``, ``train
    --pretrained`` from the export at learning rate 0, and the card's
    logits against the CPU's."""
    import contextlib
    import io

    from dss_ml_at_scale_tpu_torch.config import cli
    from dss_ml_at_scale_tpu_torch.config.checkpoints import build_classifier_model
    from dss_ml_at_scale_tpu_torch.data.transform import imagenet_transform_spec
    from dss_ml_at_scale_tpu_torch.ops.flash_attention import flash_attention
    from dss_ml_at_scale_tpu_torch.resilience import checkpoint as integrity

    t_phase = time.perf_counter()
    train, val = tables
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_vit_"))
    base = ["train", "--data", train, "--val-data", val, "--model", "vit-s16", "--batch-size",
            str(BATCH), "--crop", "224", "--num-classes", "1000", "--epochs", "1",
            "--limit-val-batches", "1"]
    # The main path: counts set to 0 just before, read just after.
    _zero_fused_launches()
    flash_attention.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    summary = cli.run_train(cli.build_parser().parse_args(
        base + ["--checkpoint-dir", str(work / "ck")]))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {**_fused_launches(), "K4": flash_attention.launches}
    check(launches == {"K1": 0, "K2": 0, "K3": 0, "K4": 0},
          f"vit launched a kernel: {launches} (its attention is the plain version, as JAX's)")
    epoch = summary["history"][0]
    check(summary["steps"] == STEPS, f"vit ran {summary['steps']} steps, want {STEPS}")
    for key in ("train_loss", "train_acc", "grad_norm", "val_loss", "val_acc"):
        check(math.isfinite(epoch[key]), f"vit metric {key}: {epoch[key]}")
    report = integrity.verify_checkpoint_dir(work / "ck")
    check([r["step"] for r in report] == [STEPS] and report[0]["status"] == "intact",
          f"vit checkpoints {report}")
    meta = json.loads((work / "ck" / "dsst_model.json").read_text())
    check(meta["model"] == "vit-s16" and meta["crop"] == 224, f"vit dsst_model.json {meta}")

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc_p = cli.main(["predict", "--data", val, "--checkpoint-dir", str(work / "ck"),
                         "--out", str(work / "preds")])
        rc_e = cli.main(["export", "--checkpoint-dir", str(work / "ck"), "--out",
                         str(work / "vit.npz")])
    check(rc_p == 0 and rc_e == 0, f"vit predict/export exited {rc_p}/{rc_e}: "
          f"{buf.getvalue()[-2000:]}")
    pred, export = (json.loads(x) for x in buf.getvalue().strip().splitlines()[-2:])
    check(pred["rows"] == VAL_ROWS and export["checkpoint_step"] == STEPS,
          f"vit predict {pred}, export {export}")

    # train --pretrained from the export at lr 0: every forward is the first
    # one's weights, the checkpoint's; its eval batch scores as the first
    # run's eval did (same weights).
    again = cli.run_train(cli.build_parser().parse_args(
        base + ["--pretrained", str(work / "vit.npz"), "--learning-rate", "0",
                "--checkpoint-dir", str(work / "ck2")]))
    first_state = torch.load(work / "ck" / str(STEPS) / "state.pt", map_location="cpu",
                             weights_only=True)["model"]
    second_state = torch.load(work / "ck2" / str(STEPS) / "state.pt", map_location="cpu",
                              weights_only=True)["model"]
    check(all(torch.equal(first_state[k], second_state[k]) for k in first_state),
          "train --pretrained at lr 0 did not keep the exported weights")
    val_err = abs(again["history"][0]["val_loss"] - epoch["val_loss"]) / abs(epoch["val_loss"])
    check(val_err <= PARITY_LOGITS, f"vit --pretrained val_loss {again['history'][0]['val_loss']}"
          f" vs the checkpoint's {epoch['val_loss']}")

    # The card's logits against the CPU's, same weights and images.
    spec = imagenet_transform_spec(crop=224)
    content = _read_delta(val).column("content").to_pylist()[:8]
    import numpy as np

    cols = spec({"content": np.array(content, dtype=object),
                 "label_index": np.zeros(len(content), np.int64)})
    images = torch.from_numpy(cols["image"])
    logits = {}
    for device in ("cuda", "cpu"):
        model = build_classifier_model("vit-s16", num_classes=1000, torch_padding=False,
                                       device=device)
        model.load_state_dict(first_state)
        with torch.inference_mode():
            logits[device] = model(images.to(device)).float().cpu()
        del model
    cpu_err = _rel(logits["cuda"], logits["cpu"])
    check(cpu_err <= PARITY_LOGITS, f"vit logits on the card vs the CPU differ by {cpu_err}")
    torch.cuda.empty_cache()
    result = {
        "launches": launches, "wall_s": wall, "steps": summary["steps"],
        "train_loss": epoch["train_loss"], "val_loss": epoch["val_loss"],
        "val_acc": epoch["val_acc"],
        "images_per_sec_steps_2_4": epoch["steady_images_per_sec"],
        "step_ms_steps_2_4": epoch["steady_step_time_s"] * 1e3,
        "data_wait_ms_steps_2_4": epoch["steady_data_wait_s"] * 1e3,
        "peak_memory_gib": peak, "predict": pred, "export_tensors": export["tensors"],
        "pretrained_val_loss_rel_err": val_err, "card_vs_cpu_logits_rel_err": cpu_err,
        "phase_s": time.perf_counter() - t_phase,
    }
    print(f"vit ({card}): " + json.dumps(result), flush=True)
    return result


RING_MOE_LAYERS = 2  # the LM-training width, at the depth the phase's time allows
# The ring MoE objective against one process's, relative: the aux term is
# about 1e-3 of it (weight 0.01, a loss near 9.5), so a missing aux term fails.
RING_MOE_LOSS = 1e-4


def ring_moe_work(torch, rank: int, world: int) -> dict:
    """One ``LMTask`` gradient of the ring MoE LM (aux weight 0.01) on this
    rank's half of the sequence of the seeded batch: the objective, each
    block's routing and router logits, its qkv, w_up and router gradients
    (summed over the ranks by the task)."""
    import torch.distributed as dist

    from dss_ml_at_scale_tpu_torch.models import seeded_lm
    from dss_ml_at_scale_tpu_torch.parallel import LMTask

    router_logits = []
    seen, undo = _route_spy(torch, router_logits)
    try:
        model = seeded_lm(0, device="cuda", attention="ring", group=dist.group.WORLD,
                          **{**MOE_LM, "num_layers": RING_MOE_LAYERS})
        task = LMTask(model=model, aux_loss_weight=MOE_AUX)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = task.compute_update({"tokens": _moe_batch(torch)})
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        undo()
    out = {"loss": metrics["train_loss"].item(), "step_ms": step_ms, "layout": task.layout,
           "routes": [{"expert": r.expert.cpu(), "position": r.position.cpu(),
                       "kept": r.kept.cpu(), "capacity": r.capacity} for r in seen],
           "router_logits": [x.cpu() for x in router_logits],
           "grads": _ring_moe_grads(model)}
    del task, model
    torch.cuda.empty_cache()
    return out


def _ring_moe_grads(model) -> dict:
    # The router's gradient is mostly the aux term's: a rank that dropped
    # its share of the aux term would fail there.
    return {f"{i}.{n}": t.grad.float().cpu() for i, b in enumerate(model.blocks)
            for n, t in (("qkv", b.qkv.weight), ("w_up", b.moe.w_up),
                         ("router", b.moe.router.weight))}


def _reference_moe_pass(torch, tokens, forced: list | None = None):
    """The one-process MoE LM (reference attention) on the whole batch:
    objective, routes, router logits, gradients. ``forced``: per block, the
    ring's global routing (expert, place, kept), taken in place of the
    reference's own; the gates and the aux term's mean probabilities stay
    the reference's, so its values are compared on tokens routed alike."""
    import torch.nn.functional as F

    from dss_ml_at_scale_tpu_torch.models import collect_aux_loss, moe, next_token_loss, seeded_lm

    real = moe.route

    def force(tokens_, weight, e, cf, **kw):
        r = real(tokens_, weight, e, cf, **kw)
        f = forced[len(seen)]  # this block's: the spy appends once this returns
        probs = torch.softmax(F.linear(tokens_.float(), weight.float()), dim=-1)
        expert = f["expert"].to(tokens_.device)
        counts = F.one_hot(expert, e).float().sum(dim=0)
        return moe.Routing(
            expert=expert, gate=probs.gather(1, expert[:, None])[:, 0],
            position=f["position"].to(tokens_.device), kept=f["kept"].to(tokens_.device),
            capacity=r.capacity,
            aux_loss=e * torch.sum(counts / expert.numel() * probs.mean(dim=0)))

    router_logits = []
    if forced is not None:
        moe.route = force
    seen, undo = _route_spy(torch, router_logits)
    try:
        model = seeded_lm(0, device="cuda", attention="reference",
                          **{**MOE_LM, "num_layers": RING_MOE_LAYERS}).train()
        loss = next_token_loss(model(tokens), tokens) + MOE_AUX * collect_aux_loss(model)
        loss.backward()
    finally:
        undo()
        moe.route = real
    out = {"loss": loss.item(), "routes": seen, "router_logits": router_logits,
           "grads": _ring_moe_grads(model)}
    del model, loss
    torch.cuda.empty_cache()
    return out


def ring_moe_phase(torch, card: str) -> dict:
    """Two gloo ranks, the sequence split 1024 + 1024, the ring MoE LM at
    the LM-training width against one process on the whole sequence with
    reference attention: the objective with aux and the routing (each
    change of expert explained by its margin) against the reference's own
    routing; the qkv, w_up and router gradients on tokens routed alike
    (the reference given the ring's routing)."""
    t_phase = time.perf_counter()
    work = _spawn_ranks("ring_moe", 2)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(2)]
    check(all(r["layout"] == "sequence" for r in ranks), "ring-moe task layout")
    tokens = _moe_batch(torch)
    own = _reference_moe_pass(torch, tokens)
    # Rank k's tokens, in their row-major [8, 1024] order, are the global
    # tokens r * 2048 + k * 1024 + p.
    order = torch.cat([(torch.arange(8)[:, None] * 2048 + k * 1024
                        + torch.arange(1024)[None, :]).reshape(-1) for k in range(2)])
    ring_routes, flips, keep_shifts, unexplained, apart = [], [], [], 0, 0
    for block, ref_route in enumerate(own["routes"]):
        glob = {}
        for key in ("expert", "position", "kept"):
            glob[key] = torch.empty_like(torch.cat([r["routes"][block][key] for r in ranks]))
            glob[key][order] = torch.cat([r["routes"][block][key] for r in ranks])
        logits = torch.empty(8 * 2048, MOE_E)
        logits[order] = torch.cat([r["router_logits"][block] for r in ranks])
        ring_routes.append(glob)
        check(ranks[0]["routes"][block]["capacity"] == ref_route.capacity,
              f"ring-moe capacity {ranks[0]['routes'][block]['capacity']} vs "
              f"{ref_route.capacity}")
        e2, k2 = ref_route.expert.cpu(), ref_route.kept.cpu()
        l2 = own["router_logits"][block].cpu()
        flip = glob["expert"] != e2
        top2 = l2.topk(2, dim=-1).values
        unexplained += int((flip & (top2[:, 0] - top2[:, 1]
                                    > 2 * (logits - l2).abs().amax(-1))).sum())
        flips.append(int(flip.sum()))
        keep_shifts.append(int((~flip & (glob["kept"] != k2)).sum()))
        apart += int((flip | (glob["kept"] != k2)).sum())
    alike = _reference_moe_pass(torch, tokens, forced=ring_routes)
    loss_err = abs(ranks[0]["loss"] - own["loss"]) / abs(own["loss"])
    alike_loss_err = abs(ranks[0]["loss"] - alike["loss"]) / abs(alike["loss"])
    grad_errs = {name: _rel(ranks[0]["grads"][name], want)
                 for name, want in alike["grads"].items()}
    own_grad_errs = {name: _rel(ranks[0]["grads"][name], want)
                     for name, want in own["grads"].items()}
    worst = max(grad_errs, key=grad_errs.get)
    result = {"loss": ranks[0]["loss"], "loss_one_process": own["loss"],
              "loss_rel_err": loss_err, "loss_rel_err_routed_alike": alike_loss_err,
              "expert_flips_by_block": flips, "keep_shifts_by_block": keep_shifts,
              "tokens_routed_apart": apart, "unexplained_flips": unexplained,
              "grad_rel_errs_routed_alike": grad_errs, "grad_rel_err_max": grad_errs[worst],
              "grad_rel_errs_own_routing": own_grad_errs,
              "step_ms_two_ranks": [r["step_ms"] for r in ranks],
              "layers": RING_MOE_LAYERS, "host_routed": ranks[0]["host_routed"],
              "phase_s": time.perf_counter() - t_phase}
    print(f"ring-moe ({card}; two ranks on one card are no scaling result): "
          + json.dumps(result), flush=True)
    check(ranks[0]["loss"] == ranks[1]["loss"], "the ranks report different objectives")
    check(loss_err <= RING_MOE_LOSS and alike_loss_err <= RING_MOE_LOSS,
          f"ring-moe loss {ranks[0]['loss']} vs one process {own['loss']} / {alike['loss']}")
    check(unexplained == 0, f"ring-moe: {unexplained} expert changes not explained by a margin")
    check(all(k <= 2 * f for k, f in zip(keep_shifts, flips)),
          f"ring-moe: capacity boundaries moved more than the flips explain: {keep_shifts}")
    check(apart <= 0.05 * 8 * 2048 * RING_MOE_LAYERS, f"ring-moe: {apart} tokens routed apart")
    for name in grad_errs:
        check(ranks[0]["grads"][name].abs().max().item() > 0, f"ring-moe {name} gradient is 0")
        check(torch.equal(ranks[0]["grads"][name], ranks[1]["grads"][name]),
              f"ring-moe {name}: the ranks' summed gradients differ")
    check(grad_errs[worst] <= LM_GRADS, f"ring-moe {worst} gradient differs by "
          f"{grad_errs[worst]} of max-abs on tokens routed alike")
    return result


def main() -> int:
    if "--par-rank" in sys.argv:  # one rank of a multi-rank phase, started by it
        i = sys.argv.index("--par-rank")
        phase, rank, world, work = sys.argv[i + 1:i + 5]
        return par_rank_main(phase, int(rank), int(world), work)
    if "--serve-child" in sys.argv:  # the image-serve phase's server
        return serve_child_main(sys.argv[sys.argv.index("--serve-child") + 1:])
    if "--child" in sys.argv:  # a check of the side-by-side block
        return child_main(sys.argv[sys.argv.index("--child") + 1:])
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs the card")
    try:
        from dss_ml_at_scale_tpu_torch.ops import _build
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")

    import os

    # Every command's run store goes to a temporary directory, never into
    # the checkout (the resilience phase passes its own --tracking-root).
    os.environ["DSST_TRACKING_ROOT"] = tempfile.mkdtemp(prefix="chip_smoke_runs_")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"card: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmuls and convolutions", flush=True)

    print("toolchain: " + json.dumps(toolchain(_build)), flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.2f} s",
          flush=True)
    for name in built:
        for line in _build.build_log(name).splitlines():
            if any(x in line for x in ("registers", "Compiling entry", "spill", "(C75")):
                print(f"ptxas {name}: {line.split(':', 1)[-1].strip()}", flush=True)
    global SM_COUNT
    SM_COUNT = torch.cuda.get_device_properties(0).multi_processor_count
    import importlib

    from dss_ml_at_scale_tpu_torch.ops import fused_matmul as fm

    fa = importlib.import_module("dss_ml_at_scale_tpu_torch.ops.flash_attention")
    k4, k1 = fa._kernel(), fm._kernel()
    import ctypes

    lay = (ctypes.c_int * 4)()
    for d, dv in ((192, 192), (256, 256), (320, 256), (320, 64), (512, 256)):
        b = k4.dsst_flash_attention_wide_layout(d, dv, lay)
        print(f"K4 wide d{d} slice {dv}: {b} B (Q resident, K slots, V stages, tile held: "
              f"{list(lay)})", flush=True)
    for d, dv in ((32, 32), (128, 128), (256, 256), (512, 256)):
        b = k4.dsst_flash_attention_f32_smem_bytes(d, dv, lay)
        print(f"K4 f32 d{d} slice {dv}: {b} B (Q resident {lay[0]})", flush=True)
    print(f"dynamic shared memory per CTA: K4 d128 {k4.dsst_flash_attention_smem_bytes(128)} B "
          f"(d256 {k4.dsst_flash_attention_smem_bytes(256)} B), "
          f"K1 K512 {k1.dsst_bn_relu_matmul_fwd_smem_bytes(512, 0)} B "
          f"(+res {k1.dsst_bn_relu_matmul_fwd_smem_bytes(512, 1)} B), "
          f"K2 64/128 channels {[k1.dsst_bn_relu_matmul_bwd_da_smem_bytes(b, 0) for b in (64, 128)]} B "
          f"(+res {[k1.dsst_bn_relu_matmul_bwd_da_smem_bytes(b, 1) for b in (64, 128)]} B), "
          f"K3 64/128 channels {[k1.dsst_bn_relu_matmul_bwd_dw_smem_bytes(b, 0) for b in (64, 128)]} B "
          f"(+res {[k1.dsst_bn_relu_matmul_bwd_dw_smem_bytes(b, 1) for b in (64, 128)]} B); "
          f"{SM_COUNT} SMs", flush=True)

    lap("build")
    cases = kernel_phase(torch, F)
    lap("kernels")
    wide_lm = wide_lm_phase(torch)
    print(f"wide-lm ({kind}; {card}): " + json.dumps(wide_lm), flush=True)
    lap("wide-lm")
    fused = fused_kernel_phase(torch)
    lap("fused kernels")
    fused_f32 = fused_f32_kernel_phase(torch)
    lap("fused-f32 kernels")
    training = train_phase(torch)
    print(f"training ({kind}; {card}): " + json.dumps(training), flush=True)
    torch.cuda.empty_cache()
    lap("training")
    parity = parity_phase(torch)
    print(f"parity ({kind}; {card}): " + json.dumps(parity), flush=True)
    lap("parity")
    f32_train = f32_train_phase(torch, training["tables"], card)
    f32_parity_phase(torch, card)
    pad = pad_phase(torch, card)
    lap("f32-train, f32-parity and pad")
    dp = dp_phase(torch, card)
    lap("dp")
    flags = train_flags_phase(torch, training["tables"], card)
    torch.cuda.empty_cache()
    augment_phase(torch, card)
    decode_phase(training["tables"], card)
    lap("train-flags, augment and decode")
    photos = photos_train_phase(torch, card)
    torch.cuda.empty_cache()
    lap("photos-train")
    serving = slice_phase(torch)
    print(f"serving ({kind}; {card}): " + json.dumps(serving), flush=True)
    torch.cuda.empty_cache()
    lap("serving")
    lm_train = lm_train_phase(torch, card)
    print(f"lm-train ({kind}; {card}): " + json.dumps(lm_train), flush=True)
    torch.cuda.empty_cache()
    lap("lm-train")
    lm_dp = lm_dp_phase(torch, card)
    torch.cuda.empty_cache()
    lm_parity = lm_parity_phase(torch)
    print(f"lm-parity ({kind}; {card}): " + json.dumps(lm_parity), flush=True)
    torch.cuda.empty_cache()
    lap("lm-dp and lm-parity")
    res_work = Path(tempfile.mkdtemp(prefix="chip_smoke_resilience_"))
    res_train = resilience_train_phase(torch, training["tables"], res_work, card)
    torch.cuda.empty_cache()
    res_step = resilience_step_phase(torch, card)
    lap("resilience train and step")
    res_lm = resilience_lm_phase(torch, res_work, card)
    for name, c in res_step["supervision"].items():
        print(f"resilience supervision cost, {name} step ms, off vs skip, in turns "
              f"({card}): off {c['off_ms']} skip {c['skip_ms']}", flush=True)
    torch.cuda.empty_cache()
    lap("resilience lm")
    # The side-by-side block: the forecasting track (the group-fit spec,
    # tpe, its f64 parity, the golden fit, eda), the pipeline specs, the HPO
    # chain, the chaos soaks and the analysis tiers start in the background,
    # each mostly the host's; this process runs the LM's parallel extras,
    # the ViT, ring-moe and the group-fit phase's card checks beside them.
    side = start_side_runs()
    moe_lm = moe_lm_phase(torch, card)
    torch.cuda.empty_cache()
    moe_parity_phase(torch, card)
    moe_dp = moe_dp_phase(torch, card)
    ring_phase(torch, card)
    pipeline_phase(torch, card)
    torch.cuda.empty_cache()
    vit_phase(torch, training["tables"], card)
    torch.cuda.empty_cache()
    ring_moe_phase(torch, card)
    torch.cuda.empty_cache()
    gf_checks = group_fit_card_checks(torch, demand_table(side))
    torch.cuda.empty_cache()
    lap("parallel extras, vit, ring-moe and group-fit checks (beside the side runs)")
    eda = eda_phase(torch, card, side)
    print(f"eda ({card}): " + json.dumps(eda), flush=True)
    jobs = job_pipeline_phase(torch, card, side)
    jobs["side_by_side_idle_share"] = stop_sampler(side)
    group_fit = {**group_fit_phase(card, side), **gf_checks}
    jobs["demand_forecasting"] = group_fit.pop("spec_run")
    print(f"group-fit ({card}): " + json.dumps(group_fit), flush=True)
    print(f"pipeline demand_forecasting task seconds ({card}): "
          f"{json.dumps(jobs['demand_forecasting']['tasks'])}", flush=True)
    print(f"pipeline ({card}): " + json.dumps(jobs), flush=True)
    tpe = tpe_phase(card, side)
    tpe.update(child_result(side, "tpe_parity", "tpe f64 parity"))
    print(f"tpe ({card}): " + json.dumps(tpe), flush=True)
    golden = child_result(side, "golden", "group-fit golden fit")
    print(f"group-fit golden ({card}): " + json.dumps(golden), flush=True)
    hpo_phase(card, side)
    print(f"hpo chain: {side['hpo']['wall_s']:.1f} s beside the others", flush=True)
    chaos_phase(card, side)
    analysis = analysis_phase(card, side)
    audit_launches = analysis["audit"]["launches"]
    lap("the rest of the side-by-side block")
    torch.cuda.empty_cache()
    image_serve = image_serve_phase(torch, training["tables"], flags["checkpoint_dir"], card)
    lap("image-serve")

    head = cases[2]  # causal s1024: the largest prefill bucket of the path
    train_case = next(c for c in cases if c["shape"] == "causal b8 h8 s2048 d128")
    kernels = [{
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "dss_ml_at_scale_tpu_torch/csrc/flash_attention.cu",
        "replaces": "dss_ml_at_scale_tpu/ops/flash_attention.py:70",
        "launches": (serving["launches"] + lm_train["launches"] + lm_dp["launches"]
                     + res_lm["launches"] + moe_lm["launches"]
                     + sum(moe_dp["launches_per_rank"])
                     + jobs["full_stack"]["lm_flash_launches"]
                     + audit_launches["ops.flash_attention.grad"]["K4"]),
        "launches_by_path": {"serving": serving["launches"], "lm_train": lm_train["launches"],
                             "lm_dp": lm_dp["launches"], "resilience": res_lm["launches"],
                             "moe_lm": moe_lm["launches"],
                             "moe_dp_per_rank": moe_dp["launches_per_rank"],
                             "pipeline": jobs["full_stack"]["lm_flash_launches"],
                             "audit": audit_launches["ops.flash_attention.grad"]["K4"]},
        "training": {k: train_case[k] for k in ("shape", "max_abs_err", "mean_rel_err", "ms",
                                                "plain_ms", "bound_ms", "bound_by",
                                                "library_ms")},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        **k4_variants(cases, wide_lm),
        "cases": cases,
    }]
    sources = (("K1", "bn_relu_matmul_fwd", ":113"), ("K2", "bn_relu_matmul_bwd_da", ":128"),
               ("K3", "bn_relu_matmul_bwd_dw", ":159"))
    for key, name, line in sources:
        head = fused[key][0]  # stage 1: the site that moves the most bytes
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dss_ml_at_scale_tpu_torch/csrc/fused_matmul.cu",
            "replaces": "dss_ml_at_scale_tpu/ops/fused_matmul.py" + line,
            "launches": (training["launches"][key] + flags["launches"][key]
                         + sum(r[key] for r in dp["launches_per_rank"])
                         + res_train["launches"][key] + photos["launches"][key]
                         + audit_launches["ops.fused_matmul.grad"][key]
                         + f32_train["launches"][key]),
            "launches_by_path": {"train": training["launches"][key],
                                 "f32_train": f32_train["launches_f32"][key],
                                 "pad_f32": pad["float32"]["launches_f32"][key],
                                 "train_flags": flags["launches"][key],
                                 "photos_train": photos["launches"][key],
                                 "dp_per_rank": [r[key] for r in dp["launches_per_rank"]],
                                 "resilience": res_train["launches"][key],
                                 "audit": audit_launches["ops.fused_matmul.grad"][key],
                                 "serve": [image_serve[f"micro_batch_{m}"]["launches"][key]
                                           for m in (8, 32)]},
            "max_abs_err": max(c["max_abs_err"] for c in fused[key]),
            "ms": head["ms"],
            "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"],
            "library_ms": head["library_ms"],
            "library": "cuBLAS product of the same shapes (matmul part only)",
            "shape": head["shape"],
            "cases": fused[key],
            # K1f-K3f, csrc/fused_matmul_f32.cu; library: cuBLAS SGEMM, TF32 off;
            # bound_ms: 3xTF32 on the tensor cores, bound_ffma_ms: FFMA.
            "f32": {
                "source": "dss_ml_at_scale_tpu_torch/csrc/fused_matmul_f32.cu",
                "launches": f32_train["launches_f32"][key],
                **{x: fused_f32[key][0][x] for x in ("shape", "ms", "plain_ms", "bound_ms",
                                                      "bound_by", "bound_ffma_ms",
                                                      "library_ms")},
                "max_abs_err": max(c["max_abs_err"] for c in fused_f32[key]),
                "cases": fused_f32[key],
            },
        })
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
