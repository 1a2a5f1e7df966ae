#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``vdpp_tpu_torch``), one GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-3 and 8 (a), then stop
    python3 chip_smoke.py --intra-only     # the build and phases 9 and 10, then stop
    python3 chip_smoke.py --moe-int8-only  # the build and phase 11, then stop
    python3 chip_smoke.py --serve-only     # the build and phase 12, then stop
    python3 chip_smoke.py --variants-only  # the build, phase 3's last variants and phase 13

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit;
2. build: every kernel under ``vdpp_tpu_torch/csrc/`` compiled by nvcc for
   sm_90a (one nvcc per source, all at once), with ptxas' report (registers,
   spills, shared memory per CTA of each kernel of the three sources);
3. kernels: each kernel against its plain PyTorch version on the card at the
   shapes the main paths give it, with times for the kernel, the plain
   version, a one-call PyTorch yardstick and the bound, the share of the
   bound and the ratio to the yardstick (and for flash the TFLOP/s): flash
   attention at d = 64 bf16 (UNet, at 25 frames and at the image->video
   app's 14; the wgmma + TMA kernel, plus fp32 timed at a ragged length:
   static max on its SIMT kernel, running max on the generic one), d = 512 fp32 (the register-tiled SIMT kernel) and bf16
   (the wgmma + TMA kernel) at the VAE mid-block's shapes (B = 4, 1 and 2
   at L = 9216, B = 4 at L = 2560, ragged 600 and 201), and d = 72
   bf16 (DiT-XL's joint3d and factorized sites, plus ragged bf16 lengths and
   fp32), fused GroupNorm+SiLU (two launches, bf16 weights as the UNet
   stores them), and frame attention at d = 64 (the UNet's sites) and d = 72
   (the factorized DiT's; bf16 on the TMA + mma.sync kernel); last, the
   kernels' last variants, each against its plain version and timed with
   its bound and library call: flash above d = 512 (640, 768, 1024, bf16
   and fp32, both softmax modes, timed; 520, 1000 and 1536 with a ragged
   last slab at Lq = 600 != Lk; the bf16 exponent in 8 (a)), flash at
   B*H = 65,606 (bf16 d = 64, fp32 d = 512, bf16 d = 16 and 136, fp32 d = 24,
   bf16 d = 520), GroupNorm+SiLU past C = 4096, G = 256 and N = 65,535 (the
   same bits twice), and the fused QKV
   projection's strided chunks at the models' flash and frame-attention
   sites and at a video DiT's head dim 128, read in place (no copy) and
   bit-equal to contiguous operands;
4. agreement: a small UNet (head dim 64, so the flash kernel runs) and one
   CFG Euler step, on the card against the same weights on the CPU, first
   as it is, then with both kernel switches on (VDPP_GN_FUSED=1,
   VDPP_TEMPORAL_ATTN=pallas); then a small VAE decoder whose mid-block
   attention takes the flash kernel at d = 512; then a small fp32 DiT with
   head dim 72, joint3d and then factorized with VDPP_TEMPORAL_ATTN=pallas
   (forward and one CFG Euler step), whose flash and frame-attention
   launches are counted; then the image->video app's encoders, small and
   fp32: a CLIP tower at head dim 80 and 257 tokens (no flash launch) and a
   VAE encoder whose mid-block attention takes flash at d = 512 once;
5. main paths: full-width SVD-XT (random weights from a seed), 25 frames at
   72x128, CFG ramp to 3 in sequential mode, Euler steps through
   ``vdpp_tpu_torch.bench.measure_config``, first as it is, then with both
   kernel switches on; then ``bench.measure_decode`` decodes the switched
   run's latent with the full-width temporal VAE decoder (fp32, chunks of 4
   frames) to (1, 25, 576, 1024, 3), and again with the bf16 decoder
   (``VAEConfig.svd(torch.bfloat16)``, 7 flash launches at d = 512 in bf16).
   Then the text->video path at full
   width (random weights from a seed): T5-v1.1-XXL encodes the app's default
   prompt and is freed, DiT-XL denoises 8 frames at 40x64 (512x320) for 2
   Euler steps with a CFG ramp to 6 through ``bench.measure_dit_config``,
   joint3d and then factorized with VDPP_TEMPORAL_ATTN=pallas, and the fp32
   decoder turns the factorized run's latent into (1, 8, 320, 512, 3). Last,
   the image->video app through its entry point
   (``vdpp_tpu_torch.apps.generate_video.main``, random weights from a seed,
   ``--num-stages 1`` so that it runs in this process on any card count):
   CLIP ViT-H/14 and the SVD VAE encoder (fp32) encode the synthetic card at
   1024x576, SVD-XT denoises 14 frames for 2 Euler steps, the fp32 decoder
   decodes them and the app writes MP4 (or Y4M) and GIF, which must hold 14
   frames of 1024x576; 60 flash launches at d = 64 and 5 at d = 512 (1 in the
   encoder, 4 in the decode); its TIMING split, the CLIP and VAE-encode
   seconds and the peak memory are printed. Then the step pipeline, one
   process per stage (``parallel/mesh.py::run_stages``): full-width SVD-XT
   with both switches on, 25 frames at 72x128, CFG ramp to 3, 2 stages, 2
   Euler steps (one a stage), 2 samples, through ``StepPipeline.run_ticked``
   (3 ticks): NCCL on cuda:0 and cuda:1 where there are two cards, else both
   ranks on cuda:0 over gloo with the hand-off through host memory. The last
   rank's outputs must equal the single-device run on cuda:0 bit for bit,
   and each rank must launch 60 flash (d = 64), 356 GroupNorm+SiLU and 64
   frame-attention kernels; tick seconds, each rank's peak memory and the
   hand-off's bytes are printed, and a one-stage pipeline is timed against
   the single-device run. The same again with the dpmpp2m solver, whose
   payload has 8 channels. For each run the launch counts are set to 0 just
   before and read just after, and must show the kernels on every site.
6. the slice of DeepCache, euler_a and the video->video and long apps,
   between the image->video app and the pipeline: (c) the restyle app
   (``apps.restyle_video.main``) on the image->video app's 14-frame Y4M,
   strength 0.4 of 5 steps (2 run), whose files must hold 14 frames of
   1024x576, 60 flash launches at d = 64 and 9 at d = 512 (5 in the encoder,
   4 in the decode); (d) the long app (``apps.generate_video_long.main``), 2
   segments of 14 frames, 2 steps at DeepCache-2, 27 frames, 80 and 10
   launches; (a) full-width SVD-XT switched, 25 frames, dpmpp2m x
   DeepCache-2 at split 1: ``apply_cached(use_full=True)`` bit-equal to
   ``forward`` on the same inputs, the launches of a full (15, 89, 16) and a
   cache forward (5, 21, 5), 4 steps (full, cache, full, cache) through
   ``run_reference_single_device`` with their launches counted, and a full
   and a cache step timed alone; (b) the pipeline phase again with euler_a
   and with dpmpp2m at DeepCache-2 (rank 0 takes the full step, rank 1 the
   cache step; 644 and 648 fp32 channels, 593.5 and 597.2 MB a hand-off),
   bit-equal to the single-device run as words, the hand-off's bytes and
   milliseconds printed.
7. the benchmark modes through their entry points, after the pipeline
   phase, at full SVD-XT width with both switches on, 25 frames at 72x128,
   CFG ramp to 3: (a) ``modes.benchmark.main`` at one stage in this
   process, 4 steps, 1 warm-up and 2 measured samples, whose 360 flash,
   2136 GroupNorm+SiLU and 384 frame-attention launches are counted; (b) 2
   stages, ticked and ``--fused``; (c) ``--fsdp`` at 2 ranks and
   ``modes.benchmark_data_parallel.main`` at 2 ranks, or 1: NCCL on a card a
   rank where there are two, else the ranks sharing cuda:0 over gloo. Each
   ``BENCHMARK_JSON`` line is printed and must carry the contract's keys, one
   positive allocator peak a rank and finite positive times.
8. the slice of production, resume and the kernels' variants: (a) in phase
   3, the generic flash kernels (every head dim up to 512 without a kernel of
   its own: bf16 on wgmma, fp32 register-tiled) at d = 16, 40, 80, 128 and
   256, bf16 and fp32, both softmax modes, at a ragged L = 600 and at
   L = 2304 (timed), at their routing edges d = 8, 24, 136, 200, 264, 320 and
   504 (Lq = 600 against Lk = 593) and at one long row, bf16 d = 128 at
   (1, 9216, 24) (timed), VDPP_FLASH_EXP=bf16
   (running max) on the d = 64 wgmma and fp32 kernels, both d = 512 kernels,
   the generic ones at d = 16, 80 and 136 and the one above d = 512 at 640
   and 1024 (inputs whose
   rows peak at key 0, so that the fp32 limit sits below the flag's own
   effect), and the generic frame-attention
   kernel at d = 16 and 40 with 14 frames, d = 64 with 48 and d = 33 with
   25; (b) after the agreement checks, the
   tiny SVD UNet (14 frames of 16x32) and the tiny DiT (8 frames of 32x64),
   both at head dim 16, card against CPU as they are, switched and switched
   with the bf16 exponent, every route's calls launching their kernel; (c)
   last, the production mode as ``modes.production.main`` runs it, at
   SVD-XT width and its default latent (14 frames of 40x72), CFG 3, 4 steps,
   3 samples, 2 ranks sharing cuda:0 over gloo, ``--ticked --state-path
   --state-every 1`` (10 flash launches a forward, the snapshots' bytes and
   write times), then one spawned group at the API level that runs euler and
   dpmpp2m uncut, snapshotting after tick 1 and resumed from it: the resumed
   samples bit-equal to the uncut run's.
9. intra-sample parallelism (in phase 3: the bf16 flash kernel at the
   (Lq, Lk) that seq sharding gives the UNet at 14 frames of 72x128, seq 2
   (4608, 9216), (1152, 2304) and seq 4 (2304, 9216), (576, 2304), timed
   with its bound and SDPA, plus ragged unequal lengths at d = 64 and 72;
   frame attention at a seq-2 rank's local L), then last: full-width
   SVD-XT bf16, 14 frames of 72x128, CFG 3, 2 Euler steps, one sample,
   VDPP_TEMPORAL_ATTN=pallas, against the one-process run of the same
   steps: (a) 2 ranks sharing cuda:0 over gloo, seq 2 (within INTRA_TOL;
   10 flash launches a forward at those (Lq, Lk), 16 frame attention), frame
   2 (within INTRA_TOL; 15 flash, 0 frame attention, 16 fallbacks to the
   default form), cfg 2 (bit for bit; 15 flash, one forward a step); (b) 4
   ranks (NCCL with four cards, else cuda:0 over gloo), stage 2 x seq 2 and
   stage 2 x cfg 2, each bit-equal to (a)'s; each run's collectives and
   bytes are printed; (c) the image->video app with ``--seq-parallel 2
   --num-stages 1`` on two ranks sharing cuda:0, whose files must hold 14
   frames of 1024x576.
10. the DiT's seq and cfg axes, the topology planner and the decode ranks
   (in phase 3: the bf16 flash kernel at d = 72 where seq sharding puts
   DiT-XL's joint3d queries, 16 heads, seq 2 (2560, 5120) and seq 4 (1280,
   5120), timed with its bound and SDPA, plus a ragged (333, 5077); frame
   attention at d = 72 at the factorized seq-2 rank's L = 320, F = 8, timed),
   then last: DiT-XL bf16 (T5-XXL's cross width, random weights and a
   random context from seeds), 8 frames of 40x64, CFG ramp to 6
   (sequential), 2 Euler steps, one sample, against the one-process run of
   the same steps: (a) 2 ranks sharing cuda:0 over gloo, joint3d seq 2
   (within INTRA_TOL; 28 flash a forward at (2560, 5120), 57 gathers a
   forward), joint3d cfg 2 (bit for bit; one forward a step) and
   factorized seq 2 with VDPP_TEMPORAL_ATTN=pallas (within INTRA_TOL; 0
   flash, the local Lq 320 taking the plain path, and 14 frame attention a
   forward at L = 320); (b) 4 ranks (NCCL with four cards, else cuda:0 over
   gloo), joint3d stage 2 x seq 2 and stage 2 x cfg 2, each bit-equal to
   (a)'s, and seq 2 x cfg 2 (within INTRA_TOL); each run's collectives and
   bytes a forward a rank are printed; (c) the text->video app with
   ``--seq-parallel 2 --num-stages 1`` on two ranks sharing cuda:0, whose
   files must hold 8 frames of 512x320; (d) ``modes.production`` with
   ``--auto-topology latency --devices cuda:0 cuda:0`` at SVD-XT width (its
   default latent, CFG 3, 2 steps): the plan and runner-ups it logs, cfg 2
   chosen, its samples bit-equal to the run with ``--num-stages 1
   --cfg-parallel``; (e) the image->video app (``apps.generate_video.run``,
   2 samples of 14 frames at 1024x576, 2 steps) with a stage rank and a
   decode rank on cuda:0 (``--decode-devices 1``), then in this process
   with no decode rank, then over 2 stage ranks that split the decode: the
   files byte-equal, the decode rank's flash launches at d = 512 4 a video
   and the stage rank's none (from the denoise on), each run's TIMING split
   printed.
11. the MoE DiT with expert parallelism and int8 weights, last: (a) DiT-XL
   joint3d bf16 with 4 experts of 4608 inner in every second block (1.26 B
   parameters), T5-XXL's cross width and a random context, 8 frames of
   40x64, CFG ramp to 6, 2 Euler steps, in this process with the dense
   dispatch (28 flash launches a forward at (5120, 5120)), the gather
   dispatch at capacity 4 (nothing drops: within TOL["bf16"] of dense) and at
   the default 2.0, each timed; then 2 ranks sharing cuda:0 over gloo at
   expert 2 (within INTRA_TOL of one process) and 4 ranks (NCCL with four
   cards, else cuda:0 over gloo) at stage 2 x expert 2, bit-equal to expert 2:
   each rank's parameter bytes (half of the expert stacks kept and freed on
   the card), peak, flash launches and the psum calls and bytes a forward;
   (b) full-width SVD-XT bf16, 14 frames of 72x128, CFG 3, 2 Euler steps,
   both kernel switches on, through ``modes.benchmark.main`` at one stage in
   this process: as it is, ``--weights-int8`` and ``--weights-w8a8``, the
   parameter MB each logs, the launches of B1, B2, B3 and ``torch._int_mm``
   counted, each int8 latent's relative L2 to the bf16 one within the CPU
   tests' bounds, and ``int8_dot`` on the card bit-equal to the CPU at the
   W8A8 sites' shapes (the single row padded), timed against the bf16
   product; (c) the benchmark's tiny MoE DiT at ``--expert-parallel 2
   --num-stages 2`` and ``--fsdp --weights-int8``, the ranks sharing cuda:0,
   each BENCHMARK_JSON line checked. Phase 11 begins with the MoE expert
   product's route on the card (bf16 operands, an fp32 result through
   ``out_dtype``), against the fp32 product and the one rounded to bf16 first.
12. serving, last: ``python -m vdpp_tpu_torch.modes.serve`` in a subprocess,
   SVD-XT with both switches, 14 frames of 72x128, 2 steps, CFG 3: (a) one
   stage in the server process: /healthz, two concurrent y4m requests and a
   third with the first's seed (byte-equal; each 14 frames of 1024x576),
   /metrics (4 served with the warm-up), then SIGTERM with a request in
   flight (200, exit 0); its launches since the warm-up, 60 flash at d = 64,
   4 at d = 512, 356 GroupNorm+SiLU and 64 frame attention a request; (b)
   two stage ranks and a decode rank (a card each over NCCL where there are
   three, else on cuda:0 over gloo): the same seeds give (a)'s bytes, each
   stage rank launches half a request's denoise kernels and the decode rank
   the decode's flash; (c) the tiny joint3d DiT server (8 frames of 32x64):
   two requests with one prompt share a stream, a negative prompt opens
   another, the generic flash at d = 16 (16 a request) and d = 32 (2). Each
   part prints its wall, its request seconds, its ticks and each process's
   peak.

13. fused QKV, last: the image->video app (``apps.generate_video.run`` in
   this process: SVD-XT bf16 with both kernel switches, 14 frames of
   72x128, CFG 3, 2 Euler steps, CLIP, the fp32 VAE encode and decode) and
   DiT-XL joint3d bf16 (8 frames of 40x64, 2 steps, a random context), each
   with VDPP_FUSE_QKV=0, 1, 1, 0 in turns: the latents within TOL["bf16"] x max
   (bit-equality printed), the app's videos within as many levels of 255,
   the unfused run's launches (60 flash at d = 64, 5 at d = 512, 356
   GroupNorm+SiLU, 64 frame attention; 224 flash at d = 72) and no operand
   copy in any; the app's diffusion seconds and the DiT's s/step of each.

The last two lines are the ``nvidia-smi`` name/power-limit line and the
contract line ``{"ok": true, "device": {...}}``; the ``kernels`` JSON line
comes before them. Its entries for the variants no model reaches (flash
above d = 512 and past 65,535 B*H, GroupNorm past its old limits) count
their launches over every model phase (phases 4-13): this process's from
the wrappers' counters, each spawned rank's and server's as its counts come
back (``spawned``); the spawned processes that report no counts are named
in the entry.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time

STEPS = 2  # Euler steps of the full-width run
VIDEOS = 1  # timed videos of the full-width run, after one warm-up video
# Flash kernel against its plain version: fail when max|kernel - plain| exceeds
# TOL * max|plain| for the shape and mode. Relative, because the outputs are
# small: each is a softmax-weighted mean of N(0, 1) values, std about
# sqrt(e / L), so max|plain| is about 0.1 at L = 9216. A bf16 ulp is 2^-8 to
# 2^-7 of the value it rounds, so 2e-2 is 2.5 to 5 ulps of the largest output:
# room for the 1-2 ulp flips where the two sides' fp32 sums, taken in other
# orders, round q', P or o the other way; a kernel off by a few percent fails.
TOL = {"bf16": 2e-2, "fp32": 1e-5}
# The generic flash kernel's head dims and shapes (B, L, H): a ragged length
# and one at least 2304, which is timed.
GENERIC_FLASH_DIMS = (16, 40, 80, 128, 256)
GENERIC_FLASH_SHAPES = ((2, 600, 3), (1, 2304, 8))
# Their routing edges, both sides of every width class (fp32: 16, 32, 64, 128,
# 256, 512; bf16: d rounded up to 16, with or without the 32- and 16-column
# boxes) and of the bf16 kernel's layouts (a producer warpgroup to 128, a
# warpgroup's rows' whole O to 256, O's columns split over two above), at
# (B, Lq, Lk, H) = EDGE_SHAPE; and one long row, bf16 d = 128 at (B, L, H) =
# GENERIC_LONG_ROW (a video DiT's head dim), timed.
GENERIC_EDGE_DIMS = (8, 24, 136, 200, 264, 320, 504)
EDGE_SHAPE = (2, 600, 593, 3)
GENERIC_LONG_ROW = (1, 9216, 24)
# VDPP_FLASH_EXP=bf16 against the plain version of the same form, on inputs
# whose every row has its largest score at key 0 (exp_inputs), so that the
# kernel's running max is the plain version's global max from the first key
# tile on and both round the same s - m: fp32 then agrees to fp32 sums in
# other orders, and EXP_TOL_FP32 lies between that and the flag's own effect
# (the plain version with the flag against without it), which is checked to
# exceed it. In bf16 the flag's effect is about one ulp of the output, so the
# limit is TOL's; there the kernel's output with the flag must differ from its
# output without it, and in fewer elements from the plain version's with the
# flag than from the plain version's without it.
EXP_TOL_FP32 = 1e-4
# The generic frame-attention kernel's (head dim, frames); F d odd in the last
# (a bf16 warp's staged rows are then 2 mod 4 bytes long).
GENERIC_FRAME_CASES = ((16, 14), (40, 14), (64, 48), (33, 25))
H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM, 700 W)
H100_FP32_FLOPS = 67e12  # fp32 outside the tensor cores (the same data sheet)
H100_HBM_BYTES = 3.35e12
# Launches per UNet forward at SVD-XT (4 levels, 2 ResNets a level down, 3 up):
# 15 spatial self-attention sites at L >= 512 (levels 0-2: 6 down + 9 up);
# 16 temporal transformer blocks (levels 0-2 down: 6, mid: 1, up: 9); and
# 4 GroupNorm+SiLU pairs in each of the 22 spatio-temporal ResBlocks (8 down,
# 2 mid, 12 up) plus conv_norm_out, all of whose row counts have an 8-aligned
# chunking (the reference's rule for fusing a site).
FLASH_PER_FORWARD = 15
FRAME_ATTN_PER_FORWARD = 16
GN_SILU_PER_FORWARD = 4 * 22 + 1
# 25 frames decoded in chunks of 4: 7 mid-block attentions at d = 512.
FLASH_PER_DECODE = 7
SWITCHES = {"VDPP_GN_FUSED": "1", "VDPP_TEMPORAL_ATTN": "pallas"}
TEMPORAL_SWITCH = {"VDPP_TEMPORAL_ATTN": "pallas"}  # the only one the DiT reads
# DiT-XL (28 blocks) at 8 frames of a 40x64 latent: 640 patch tokens a frame.
# joint3d: all 28 blocks self-attend over 8 * 640 = 5120 tokens (flash);
# factorized: 14 spatial blocks over 640 tokens (flash) and 14 temporal
# blocks over the 8 frames (frame attention under VDPP_TEMPORAL_ATTN=pallas).
DIT_FRAMES, DIT_LAT = 8, (40, 64)
FLASH_PER_JOINT3D_FORWARD = 28
FLASH_PER_FACTORIZED_FORWARD = 14
FRAME_ATTN_PER_FACTORIZED_FORWARD = 14
# 8 frames decoded in chunks of 4: 2 mid-block attentions at d = 512.
FLASH_PER_DIT_DECODE = 2
# The image->video app at its defaults (SVD-XT, 14 frames of 1024x576) for
# APP_STEPS Euler steps, sequential CFG: 15 flash launches at d = 64 per UNet
# forward, two forwards a step; at d = 512, one in the VAE encoder (its mid
# block over the 72 x 128 latent of the one image) and one per chunk of 4
# frames in the decode. CLIP (head dim 80, L = 257) never takes flash.
APP_FRAMES, APP_W, APP_H, APP_STEPS = 14, 1024, 576, 2
FLASH_PER_APP = {64: FLASH_PER_FORWARD * 2 * APP_STEPS, 512: 1 + -(-APP_FRAMES // 4)}
# The step pipeline, one process per stage, at full SVD-XT width with both
# switches on: PIPE_STAGES stages, PIPE_STEPS Euler steps (one a stage),
# PIPE_SAMPLES samples, so N + S - 1 = 3 ticks, and each rank runs one step of
# each sample, two UNet forwards a step (CFG sequential).
PIPE_STAGES, PIPE_STEPS, PIPE_SAMPLES = 2, 2, 2
PIPE_FORWARDS_PER_RANK = 2 * PIPE_SAMPLES * PIPE_STEPS // PIPE_STAGES
# Phase 9, intra-sample parallelism: full-width SVD-XT, INTRA_FRAMES frames
# of 72x128, CFG ramp to 3 (sequential), INTRA_STEPS Euler steps, one sample,
# with VDPP_TEMPORAL_ATTN=pallas. Under seq 2 a rank holds 64 of the 128
# columns: self-attention takes flash at levels 0 and 1, 5 sites each, with
# its local queries against the gathered keys, (Lq, Lk) = (72 * 64, 72 * 128)
# and (36 * 32, 36 * 64); level 2 (Lq = 288 < 512) is plain, as in the
# reference; the 16 temporal sites run the frame-attention kernel at the
# local L. Under frame 2 every site runs as unsharded on 7 frames (15 flash)
# and frame attention takes the default form (0 launches, 16 fallbacks a
# forward). Under cfg 2 a rank runs one forward a step, as unsharded.
INTRA_FRAMES, INTRA_STEPS = 14, 2
INTRA_SEQ2_SHAPES = {(4608, 9216): 5, (1152, 2304): 5}
INTRA_PER_FORWARD = {  # case: (flash, frame attention, fallbacks, forwards a step)
    "seq2": (10, 16, 0, 2), "frame2": (15, 0, 16, 2), "cfg2": (15, 16, 0, 1)}
# seq and frame against the one-process run: max|diff| <= INTRA_TOL x
# max|one process| (written in PERF.md before the first run: the bf16 UNet's
# sums taken in other orders flip roundings site by site).
INTRA_TOL = 5e-2
# Phase 10, the DiT's intra-sample axes: DiT-XL bf16 with T5-XXL's 4096-wide
# cross-attention, DIT_FRAMES frames of DIT_LAT, CFG ramp to 6 (sequential),
# STEPS Euler steps, one sample, a random context of DIT_CTX_TOKENS tokens,
# against the one-process run of the same steps. joint3d seq 2: each rank's
# queries are its 2560 of the 5120 tokens against every key (28 flash
# launches a forward at (2560, 5120)); cfg 2: one unsharded forward a step
# a rank (28 at (5120, 5120)); factorized seq 2: the spatial blocks' local
# Lq = 320 < 512 takes the plain path, as in the reference (0 flash), and the
# 14 temporal blocks frame attention at the local L = 320 under
# VDPP_TEMPORAL_ATTN=pallas. name: (mode, inner axes, flash a forward, its
# (Lq, Lk), frame attention a forward, forwards a step).
DIT_CTX_TOKENS = 16
DIT_INTRA = {
    "joint3d_seq2": ("joint3d", {"seq": 2}, 28, (2560, 5120), 0, 2),
    "joint3d_cfg2": ("joint3d", {"cfg": 2}, 28, (5120, 5120), 0, 1),
    "factorized_seq2": ("factorized", {"seq": 2}, 0, None, 14, 2),
    "joint3d_stage2_seq2": ("joint3d", {"seq": 2}, 28, (2560, 5120), 0, 2),
    "joint3d_stage2_cfg2": ("joint3d", {"cfg": 2}, 28, (5120, 5120), 0, 1),
    "joint3d_seq2_cfg2": ("joint3d", {"seq": 2, "cfg": 2}, 28, (2560, 5120), 0, 1),
}
# Predicted collectives a joint3d seq-2 forward a rank: K and V of each of the
# 28 blocks and the head's output gathered, 57 calls; each K or V shard is
# (1, 2560, 16, 72) bf16, so 56 x 5.9 MB = 0.33 GB of K/V.
DIT_SEQ2_GATHERS = 2 * 28 + 1
# Phase 11 (a), the MoE DiT: DiT-XL joint3d (as phase 10's) with MOE_EXPERTS
# experts of 4608 inner in every second block (MOE_BLOCKS of 28, 1.26 B
# parameters), one forward a step a CFG branch; MOE_CAPACITY is the gather
# dispatch's default capacity factor. Each MoE block's output is one sum over
# the expert axis.
MOE_EXPERTS, MOE_BLOCKS, MOE_CAPACITY = 4, 14, 2.0
MOE_FORWARDS = 2 * STEPS
# Phase 11 (b), int8 SVD-XT: 14 frames of 72x128; the latent's relative L2 to
# the bf16 run's after the steps, at most the bound that tests/test_torch_port_
# quant_model.py::test_trajectory_over_int8_weights holds a 4-step trajectory
# of the tiny UNet to (int8 and W8A8 against float; the JAX package's bound
# for an int8 trajectory, tests/test_deepcache.py). A single forward drifts
# less (0.05 and 0.1 there).
INT8_LATENT = ["--latent-shape", "1", "4", "14", "72", "128"]
INT8_DRIFT = {"--weights-int8": 0.2, "--weights-w8a8": 0.2}
# (e) The image->video app with a reserved decode rank: DECODE_SAMPLES
# samples, APP_STEPS steps, the 14 frames decoded in chunks of 4 (4 chunks,
# 4 flash launches at d = 512 a video).
DECODE_SAMPLES = 2
FLASH_PER_APP_DECODE = -(-APP_FRAMES // 4)
# The pipeline phase's cases: (solver, DeepCache interval). With interval 2
# rank 0 takes the full step and rank 1 the cache step, so the cache crosses
# the hand-off: 644 fp32 channels a sample (648 with dpmpp2m's x0_hat).
PIPE_CASES = (("euler", 0), ("dpmpp2m", 0), ("euler_a", 2), ("dpmpp2m", 2))
# (b) The tiny configs on the card, card against CPU: as they are, switched
# (the fused GroupNorm+SiLU and frame attention, running-max flash), and
# switched with VDPP_FLASH_EXP=bf16, each with the tolerance TINY_TOL on
# max|diff| / max|CPU|: fp32 sums in other orders, no TF32. The flag's own
# effect on these outputs (the CPU's switched runs with it against without it)
# is printed beside it; phase (a) is what holds the flag's arithmetic.
TINY_SWITCHED = {"VDPP_GN_FUSED": "1", "VDPP_TEMPORAL_ATTN": "pallas",
                 "VDPP_FLASH_SOFTMAX": "running"}
TINY_EXP = "switched, VDPP_FLASH_EXP=bf16"
TINY_SETTINGS = (("as it is", {}), ("switched", TINY_SWITCHED),
                 (TINY_EXP, {**TINY_SWITCHED, "VDPP_FLASH_EXP": "bf16"}))
TINY_TOL = 1e-4
TINY_FRAMES = 14
# (c) The production mode at SVD-XT width and its default latent (14 frames
# of 40x72), CFG 3 sequential, PROD_STEPS Euler steps, PROD_SAMPLES samples,
# 2 ranks sharing cuda:0 over gloo. Self-attention takes flash at levels 0
# (L = 2880) and 1 (L = 720), 2 down and 3 up sites each; level 2 (L = 180)
# is plain. A rank runs PROD_STEPS / 2 steps of each sample, two forwards a
# step.
PROD_STEPS, PROD_SAMPLES, PROD_STAGES = 4, 3, 2
PROD_LATENT = ("1", "4", "14", "40", "72")
PROD_FLASH_PER_FORWARD = 10
PROD_FORWARDS_PER_RANK = 2 * PROD_SAMPLES * PROD_STEPS // PROD_STAGES
PROD_SNAP_TICK = 1
PROD_SOLVERS = ("euler", "dpmpp2m")
# A cache forward at split 1 runs conv_in, down level 0 (2 ResBlocks, 2
# transformers; no downsample), up block 3 (3 ResBlocks, 3 transformers) and
# the head: 5 flash sites (all at L = 9216), 5 temporal attentions, and
# 4 x 5 + 1 GroupNorm+SiLU pairs.
FLASH_PER_CACHE_FORWARD = 5
FRAME_ATTN_PER_CACHE_FORWARD = 5
GN_SILU_PER_CACHE_FORWARD = 4 * 5 + 1
# Phase (a): the fast path's composition, dpmpp2m x DeepCache-2 at split 1,
# switched, 25 frames, DC_STEPS steps: full, cache, full, cache.
DC_STEPS, DC_INTERVAL = 4, 2
# The restyle app on the image->video app's 14-frame Y4M: strength 0.4 of 5
# steps runs the last 2 (denoise_from 3). The VAE encodes frame 0 (B = 1)
# and the 14 frames in chunks of 4 (B = 4, 4, 4, 2), and decodes 4 chunks.
RESTYLE_STEPS, RESTYLE_STRENGTH, RESTYLE_RUN = 5, 0.4, 2
FLASH_PER_RESTYLE = {64: FLASH_PER_FORWARD * 2 * RESTYLE_RUN, 512: 1 + 4 + 4}
# The long app: 2 segments of 14 frames, 2 steps at DeepCache-2 (a full and
# a cache step each), so 14 + 13 = 27 frames; per segment 1 encoder and 4
# decode launches at d = 512.
LONG_SEGMENTS, LONG_STEPS = 2, 2
FLASH_PER_LONG = {64: LONG_SEGMENTS * 2 * (FLASH_PER_FORWARD + FLASH_PER_CACHE_FORWARD),
                  512: LONG_SEGMENTS * (1 + 4)}
# The benchmark modes (phase 7), all at full SVD-XT width with both switches
# on, 25 frames at 72x128, CFG ramp to 3 (sequential: 2 forwards a step).
# (a) one stage in this process: BENCH_STEPS steps of BENCH_WARMUP +
# BENCH_SAMPLES samples, every forward's launches counted.
BENCH_LATENT = ["--latent-shape", "1", "4", "25", "72", "128"]
BENCH_STEPS, BENCH_SAMPLES, BENCH_WARMUP = 4, 2, 1
BENCH_FORWARDS = 2 * BENCH_STEPS * (BENCH_SAMPLES + BENCH_WARMUP)
# The BENCHMARK_JSON keys of every mode (the JAX package's, but for its
# compiled-program fallback), and the pipeline modes' two more.
BENCH_KEYS = {"world_size", "total_steps", "steps_per_gpu", "model", "mode", "fsdp",
              "num_samples_measured", "warmup_samples", "latent_shape", "first_sample_time_s",
              "avg_sample_time_s", "throughput_samples_per_s", "per_sample_times_ms",
              "peak_memory_gb_per_rank", "max_peak_memory_gb", "platform", "peak_memory_source"}
PIPELINE_KEYS = BENCH_KEYS | {"bubble_fraction", "data_parallel_size"}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def time_ms(torch, fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_flash(torch, fa, F) -> dict:
    """The flash kernel against its plain version at the UNet's three
    self-attention shapes (d = 64, bf16, full B*H: the plain version chunks
    its queries, so no reduction is needed) at the denoise's 25 frames and
    the image->video app's 14, and the production mode's two (L = 2880 and
    720), both softmax modes, plus a ragged length and fp32. Every UNet
    shape is timed."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def inputs(b, l, h, dtype):
        return [torch.randn(b, l, h, 64, generator=g, device="cuda").to(dtype) for _ in range(3)]

    def compare(what, q, k, v, static, tol):
        got = fa.flash_attention(q, k, v, static_max=static)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
        torch.cuda.synchronize()
        err = (got.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        mode = "static" if static else "running"
        print(f"flash {what} {mode}: max|diff| {err:.3g}, max|plain| {ref_max:.3g}, "
              f"limit {tol} x max|plain| = {tol * ref_max:.3g}", flush=True)
        if not math.isfinite(err) or err > tol * ref_max:
            fail(f"flash {what} {mode}: max|diff| {err} > {tol} x {ref_max}")
        return err, ref_max

    print(f"flash tolerance: max|kernel - plain| <= {TOL['bf16']} x max|plain| in bf16 (2.5 "
          f"to 5 bf16 ulps of the largest output; the sums run in other orders), "
          f"{TOL['fp32']} x max|plain| in fp32")
    max_err = 0.0
    shapes = []
    # (frames*batch, L, heads): UNet levels 0, 1, 2 at 72x128, at 25 frames
    # (the denoise) and at APP_FRAMES (the image->video app); then levels 0
    # and 1 of the production mode's default 14 frames of 40x72.
    for b, l, h in [(f, l, h) for f in (25, APP_FRAMES)
                    for l, h in ((9216, 5), (2304, 10), (576, 20))] + [(14, 2880, 5),
                                                                       (14, 720, 10)]:
        q, k, v = inputs(b, l, h, torch.bfloat16)
        row = {"frames": b, "L": l, "BH": b * h}
        for static in (True, False):
            err, ref_max = compare(f"bf16 L={l} B*H={b * h}", q, k, v, static, TOL["bf16"])
            max_err = max(max_err, err)
            row["err_static" if static else "err_running"] = err
            row["ref_max"] = ref_max
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
        row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=False))
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's (B, H, L, D)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4 * b * h * l * l * 64
        nbytes = 4 * b * h * l * 64 * 2
        row["bound_ms"] = max(flops / H100_BF16_FLOPS, nbytes / H100_HBM_BYTES) * 1e3
        row["bound_by"] = "operations" if flops / H100_BF16_FLOPS > nbytes / H100_HBM_BYTES \
            else "bytes"
        add_rates(row, flops)
        print(f"flash bf16 frames={b} L={l} B*H={b * h}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{rates_text(row)}", flush=True)
        shapes.append(row)
    for dtype, tol, l in ((torch.bfloat16, TOL["bf16"], 600), (torch.bfloat16, TOL["bf16"], 201),
                          (torch.float32, TOL["fp32"], 600)):
        q, k, v = inputs(2, l, 3, dtype)  # ragged: the last query and key tiles part-filled
        for static in (True, False):
            err, _ = compare(f"{dtype} L={l}", q, k, v, static, tol)
            if dtype == torch.bfloat16:
                max_err = max(max_err, err)
        if dtype == torch.float32:
            fp32_row = time_flash_fp32(torch, fa, F, q, k, v, "d=64 ragged")
    return {"max_abs_err": max_err, "shapes": shapes, "fp32": fp32_row}


def time_flash_fp32(torch, fa, F, q, k, v, what: str) -> dict:
    """fp32 flash at d = 64/72 (off the models' paths; the small agreement
    configs use it: static max on its SIMT kernel, running max on the
    generic one) timed beside its plain version and SDPA in fp32, with its
    bound: fp32 FMA at 67 TFLOP/s or the bytes."""
    b, l, h, d = q.shape
    row = {"site": what, "B": b, "L": l, "H": h, "D": d}
    row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
    row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=False))
    row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True), iters=3,
                              warmup=1)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
    flops = 4 * b * h * l * l * d
    row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * h * l * d * 4, H100_FP32_FLOPS)
    add_rates(row, flops)
    print(f"flash fp32 {what} B={b} L={l} H={h}: kernel_ms {row['ms']:.4f} (running "
          f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA fp32) "
          f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.5f} ({row['bound_by']}, 67 "
          f"TFLOP/s fp32); {row['tflops']:.2f} TFLOP/s, {row['bound_share']:.3f} of the bound, "
          f"{row['vs_library']:.3f}x SDPA's time", flush=True)
    return row


def add_rates(row: dict, flops: float) -> None:
    """TFLOP/s, the share of the bound and the ratio to the library call,
    from the row's times."""
    row["tflops"] = flops / row["ms"] / 1e9
    add_shares(row)


def add_shares(row: dict) -> None:
    """The share of the bound and the ratio to the library call (None where
    the library call refused the shape)."""
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["vs_library"] = row["ms"] / row["library_ms"] if row["library_ms"] else None


def shares_text(row: dict, library: str) -> str:
    if row["vs_library"] is None:
        return f"{row['bound_share']:.3f} of the bound, no {library} time (it refused the shape)"
    return (f"{row['bound_share']:.3f} of the bound, {row['vs_library']:.3f}x {library}'s "
            f"time")


def rates_text(row: dict) -> str:
    return f"{row['tflops']:.1f} TFLOP/s, {shares_text(row, 'SDPA')}"


# Kernel templates of each source, as ptxas names them, and the words for
# their bool arguments in order (the last pair for any further bool).
KERNEL_NAMES = {"flash_attention": (r"flash_fwd_\w+?", (("running", "static"),
                                                        ("exp_f32", "exp_bf16"))),
                "frame_attention": (r"frame_attn\w*?", (("unmerged", "merged"),)),
                "group_norm_silu": (r"gn_\w+?", (("false", "true"),))}


def template_args(mangled: str, flags: tuple[tuple[str, str], ...]) -> str:
    """``Li64ELb1ELb0E`` -> ``64, static, exp_f32``: the template arguments of
    a mangled kernel name (ints, bools, ``float`` and ``__nv_bfloat16``)."""
    out = []
    nbool = 0
    for m in re.finditer(r"Li(\d+)E|Lb([01])E|13__nv_bfloat16|f", mangled):
        if m.group(1):
            out.append(m.group(1))
        elif m.group(2):
            out.append(flags[min(nbool, len(flags) - 1)][int(m.group(2))])
            nbool += 1
        else:
            out.append("f32" if m.group(0) == "f" else "bf16")
    return ", ".join(out)


def ptxas_report(log: str, source: str = "flash_attention") -> dict[str, dict]:
    """Registers, spills and static shared memory of each kernel of
    ``csrc/<source>.cu`` in ptxas' ``-v`` log, by a readable name such as
    ``flash_fwd_bf16<64, static>``."""
    names, flags = KERNEL_NAMES[source]
    out: dict[str, dict] = {}
    name = None
    for line in log.splitlines():
        m = re.search(rf"Function properties for \S*?\d+({names})I(\w+?)EEv", line)
        if m:
            name = f"{m.group(1)}<{template_args(m.group(2), flags)}>"
            out[name] = {}
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and "spill_stores" not in out[name]:
            out[name]["spill_stores"], out[name]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[name]["static_smem"] = int(sm.group(1)) if sm else 0
            name = None
    return out


def bound(flops: float, nbytes: float, peak_flops: float) -> tuple[float, str]:
    """The least time in ms for the work, and what bounds it."""
    t_ops, t_bytes = flops / peak_flops, nbytes / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def bf16_ulp(x: float) -> float:
    """One bf16 ulp at magnitude ``x`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(x)) - 7) if x > 0 else 0.0


def check_flash_512(torch, fa, F, dtype) -> dict:
    """The flash kernel at the VAE mid-block's shapes: d = 512, one head,
    B = 4 frames of a decode chunk at L = 9216 (72 x 128 latent positions),
    B = 1 (the last chunk of 25 frames, and the VAE encoder's one image), B
    = 2 (the last chunk of the image->video app's 14 frames) and the DiT
    decode's L = 2560 (40 x 64), both softmax modes, plus ragged lengths
    (600, 201) whose last query and key tiles are part-filled. fp32 is the
    VAE's default and runs on the register-tiled SIMT kernel; bf16 is
    ``VAEConfig.svd(torch.bfloat16)`` and runs on the wgmma + TMA kernel.
    The four path shapes are timed."""
    g = torch.Generator(device="cuda").manual_seed(1 if dtype == torch.float32 else 9)
    name = "fp32" if dtype == torch.float32 else "bf16"

    def inputs(b, l):
        return [torch.randn(b, l, 1, 512, generator=g, device="cuda").to(dtype) for _ in range(3)]

    tol = TOL[name]
    print(f"flash d=512 {name} tolerance: max|kernel - plain| <= {tol} x max|plain| "
          + ("(fp32 both sides, sums in other orders, no TF32)" if name == "fp32"
             else "(as at d = 64: q', P and o rounded to bf16 on both sides)"))
    max_err = 0.0
    shapes = []
    for b, l in ((4, 9216), (1, 9216), (2, 9216), (4, 2560), (2, 600), (2, 201)):
        q, k, v = inputs(b, l)
        for static in (True, False):
            got = fa.flash_attention(q, k, v, static_max=static).float()
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            mode = "static" if static else "running"
            print(f"flash {name} d=512 B={b} L={l} {mode}: max|diff| {err:.3g}, max|plain| "
                  f"{ref_max:.3g}, limit {tol * ref_max:.3g}", flush=True)
            if not math.isfinite(err) or err > tol * ref_max:
                fail(f"flash {name} d=512 B={b} L={l} {mode}: max|diff| {err} > {tol} x {ref_max}")
            max_err = max(max_err, err)
        if l not in (9216, 2560):
            continue
        row = {"L": l, "B": b, "dtype": name, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True),
                            iters=5, warmup=1)
        row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, False),
                                    iters=5, warmup=1)
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                    iters=5, warmup=1)
        flops = 4 * b * l * l * 512
        # fp32: the SIMT rate (the tensor cores would round to TF32); bf16:
        # the tensor cores' bf16 rate, the card's peak for the inputs' type.
        peak = H100_FP32_FLOPS if name == "fp32" else H100_BF16_FLOPS
        row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * l * 512 * q.element_size(), peak)
        add_rates(row, flops)
        print(f"flash {name} d=512 B={b} L={l}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA "
              f"{name}) {row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
              f"({row['bound_by']}, {peak / 1e12:.0f} TFLOP/s); {rates_text(row)}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_group_norm(torch, nk, F) -> dict:
    """Fused GroupNorm+SiLU against its plain version at the UNet's sites,
    bf16, G = 32: level 0 spatial (N = 25 frames, S = 72 x 128) and temporal
    (N = 1, S = 25 x 72 x 128), the 2560-channel skip concatenation at level
    3, level 3 temporal; plus fp32, and an fp32 shape whose chunks are ragged
    and whose rows are not 16-byte aligned."""
    from vdpp_tpu_torch.ops.normalization import Norm

    g = torch.Generator(device="cuda").manual_seed(2)
    print("GroupNorm+SiLU tolerance: bf16 max|kernel - plain| <= one bf16 ulp at max|plain| "
          "(fp32 statistics merged in another order flip an output rounding at most once); "
          f"fp32 {TOL['fp32']} x max|plain|")
    max_err = 0.0
    shapes = []
    cases = (("level 0 temporal", 1, 25 * 9216, 320, torch.bfloat16),
             ("level 0 spatial", 25, 9216, 320, torch.bfloat16),
             ("level 3 skip concat", 25, 144, 2560, torch.bfloat16),
             ("level 3 temporal", 1, 25 * 144, 1280, torch.bfloat16),
             ("fp32", 3, 512, 128, torch.float32),
             ("fp32 ragged", 2, 200, 90, torch.float32))
    for what, n, rows, c, dtype in cases:
        groups = 6 if c == 90 else 32
        norm = Norm(c, device="cuda", dtype=dtype)
        norm.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g, device="cuda"))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g, device="cuda"))
        x = (3.0 * torch.randn(n, rows, c, generator=g, device="cuda")).to(dtype)
        before = nk.launches
        got = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
        torch.cuda.synchronize()
        if nk.launches != before + 1:
            fail("the GroupNorm+SiLU wrapper did not count its launch")
        ref = nk.group_norm_silu_fused_plain(x, norm, groups, 1e-6)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
        print(f"gn_silu {what} (N={n}, S={rows}, C={c}, {dtype}): max|diff| {err:.3g}, "
              f"max|plain| {ref_max:.3g}, limit {tol:.3g}", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"gn_silu {what}: max|diff| {err} > {tol}")
        if dtype != torch.bfloat16:
            continue
        max_err = max(max_err, err)
        row = {"site": what, "N": n, "S": rows, "C": c, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: nk.group_norm_silu_fused(x, norm, groups, 1e-6))
        row["plain_ms"] = time_ms(torch, lambda: nk.group_norm_silu_fused_plain(x, norm, groups,
                                                                                 1e-6),
                                  iters=3, warmup=1)
        xc = x.transpose(1, 2).contiguous()  # channels-first copy, not timed
        w, b = norm.weight.to(dtype), norm.bias.to(dtype)
        row["library_ms"] = time_ms(torch, lambda: F.silu(F.group_norm(xc, groups, w, b, 1e-6)))
        elems = n * rows * c
        row["bound_ms"], row["bound_by"] = bound(8 * elems, 2 * elems * 2, H100_FP32_FLOPS)
        add_shares(row)
        print(f"gn_silu {what}: kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.3f}, "
              f"library_ms (two calls: F.group_norm + F.silu, channels-first) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'the library')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_frame_attention(torch, ta, F) -> dict:
    """Frame attention against its plain version at the UNet's four temporal
    attention shapes (B = 1, F = 25, d = 64, bf16), at the four a seq-2
    rank runs at INTRA_FRAMES frames of 72x128 (its local L: 72 * 64 = 4608
    at level 0, then 1152, 288, 72), plus fp32."""
    g = torch.Generator(device="cuda").manual_seed(3)
    print("frame attention tolerance: bf16 max|kernel - plain| <= one bf16 ulp at max|plain| "
          "(fp32 softmax on both sides, sums in other orders); "
          f"fp32 {TOL['fp32']} x max|plain|")
    max_err = 0.0
    shapes, fp32_rows = [], []
    cases = [(9216, 5, 25, torch.bfloat16), (2304, 10, 25, torch.bfloat16),
             (576, 20, 25, torch.bfloat16), (144, 20, 25, torch.bfloat16),
             *((l, h, INTRA_FRAMES, torch.bfloat16)
               for l, h in ((4608, 5), (1152, 10), (288, 20), (72, 20))),
             (512, 4, 3, torch.float32), (2304, 10, 25, torch.float32)]
    for l, h, f, dtype in cases:
        q, k, v = (torch.randn(1, f, l, h, 64, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        before = ta.launches
        got = ta.frame_attention(q, k, v)
        torch.cuda.synchronize()
        if ta.launches != before + 1:
            fail("the frame-attention wrapper did not count its launch")
        ref = ta.frame_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
        print(f"frame_attention L={l} H={h} F={f} {dtype}: max|diff| {err:.3g}, max|plain| "
              f"{ref_max:.3g}, limit {tol:.3g}", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"frame_attention L={l} H={h}: max|diff| {err} > {tol}")
        if dtype != torch.bfloat16:
            fp32_rows.append(time_frame_fp32(torch, ta, F, q, k, v))
            continue
        max_err = max(max_err, err)
        row = {"L": l, "H": h, "F": f, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
        row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                                  warmup=1)
        # SDPA over (B*L, H, F, D) copies (not timed): frames as the sequence axis.
        qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(l, h, f, 64).contiguous()
                      for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = bound(l * h * 4 * f * f * 64, 4 * f * l * h * 64 * 2,
                                                 H100_BF16_FLOPS)
        add_shares(row)
        print(f"frame_attention L={l} H={h}: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'SDPA')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes, "fp32": fp32_rows}


def time_frame_fp32(torch, ta, F, q, k, v) -> dict:
    """An fp32 frame-attention launch (the SIMT kernels; off the models'
    paths) timed beside its plain version and SDPA in fp32, with its bound:
    fp32 FMA at 67 TFLOP/s or the bytes."""
    b, f, l, h, d = q.shape
    row = {"B": b, "F": f, "L": l, "H": h, "D": d}
    row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
    row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                              warmup=1)
    qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(b * l, h, f, d).contiguous()
                  for t in (q, k, v))
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    row["bound_ms"], row["bound_by"] = bound(b * l * h * 4 * f * f * d, 4 * b * f * l * h * d * 4,
                                             H100_FP32_FLOPS)
    add_shares(row)
    print(f"frame_attention fp32 d={d} F={f} L={l} H={h}: kernel_ms {row['ms']:.4f}, plain_ms "
          f"{row['plain_ms']:.3f}, library_ms (SDPA fp32 on a (L, H, F, D) copy) "
          f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.5f} ({row['bound_by']}); "
          f"{shares_text(row, 'SDPA')}", flush=True)
    return row


def check_flash_72(torch, fa, F) -> dict:
    """The flash kernel at DiT-XL's head dim 72, bf16: the joint3d site
    (B = 1, L = 8 x 640 = 5120, 16 heads) and the factorized spatial site
    (B = 8 frames, L = 640, 16 heads), both softmax modes; plus fp32 at a
    ragged L = 600 (the small-config agreement runs fp32)."""
    g = torch.Generator(device="cuda").manual_seed(6)

    def inputs(b, l, h, dtype):
        return [torch.randn(b, l, h, 72, generator=g, device="cuda").to(dtype) for _ in range(3)]

    print(f"flash d=72 tolerance: max|kernel - plain| <= {TOL['bf16']} x max|plain| in bf16, "
          f"{TOL['fp32']} x max|plain| in fp32 (as at d = 64)")
    max_err = 0.0
    shapes = []
    for site, b, l, h, dtype in (("joint3d", 1, 5120, 16, torch.bfloat16),
                                 ("factorized spatial", 8, 640, 16, torch.bfloat16),
                                 ("bf16 ragged", 2, 600, 3, torch.bfloat16),
                                 ("bf16 ragged, under two tiles", 2, 201, 3, torch.bfloat16),
                                 ("fp32 ragged", 2, 600, 3, torch.float32)):
        q, k, v = inputs(b, l, h, dtype)
        tol = TOL["bf16"] if dtype == torch.bfloat16 else TOL["fp32"]
        row = {"site": site, "B": b, "L": l, "H": h}
        for static in (True, False):
            got = fa.flash_attention(q, k, v, static_max=static)
            torch.cuda.synchronize()
            ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
            torch.cuda.synchronize()
            err = (got.float() - ref).abs().max().item()
            ref_max = ref.abs().max().item()
            mode = "static" if static else "running"
            print(f"flash d=72 {site} {dtype} B={b} L={l} H={h} {mode}: max|diff| {err:.3g}, "
                  f"max|plain| {ref_max:.3g}, limit {tol * ref_max:.3g}", flush=True)
            if not math.isfinite(err) or err > tol * ref_max:
                fail(f"flash d=72 {site} {mode}: max|diff| {err} > {tol} x {ref_max}")
            row["err_static" if static else "err_running"] = err
            row["ref_max"] = ref_max
        if dtype != torch.bfloat16:
            fp32_row = time_flash_fp32(torch, fa, F, q, k, v, "d=72 ragged")
            continue
        max_err = max(max_err, row["err_static"], row["err_running"])
        if "ragged" in site:
            continue
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
        row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=False))
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # SDPA's (B, H, L, D)
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4 * b * h * l * l * 72
        row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * h * l * 72 * 2, H100_BF16_FLOPS)
        add_rates(row, flops)
        print(f"flash d=72 {site} bf16 B={b} L={l} H={h}: kernel_ms {row['ms']:.4f} (running "
              f"{row['running_ms']:.4f}), plain_ms {row['plain_ms']:.3f}, library_ms (SDPA) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{rates_text(row)}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes, "fp32": fp32_row}


def check_flash_seq_sharded(torch, fa, F) -> dict:
    """The bf16 wgmma kernel at Lq != Lk: the SVD-XT UNet's self-attention
    under seq sharding at INTRA_FRAMES frames of 72x128, the local queries
    of levels 0 and 1 against the keys gathered from every shard (seq 2:
    (4608, 9216), (1152, 2304); seq 4: (2304, 9216), (576, 2304)), both
    softmax modes, each timed beside its plain version and SDPA with its
    bound; then ragged unequal lengths at d = 64 and 72."""
    g = torch.Generator(device="cuda").manual_seed(13)

    def inputs(b, lq, lk, h, d):
        q = torch.randn(b, lq, h, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, lk, h, d, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        return q, k, v

    def compare(what, q, k, v, static):
        got = fa.flash_attention(q, k, v, static_max=static)
        torch.cuda.synchronize()
        ref = fa.flash_attention_plain(q, k, v, static_max=static).float()
        err = (got.float() - ref).abs().max().item()
        ref_max = ref.abs().max().item()
        mode = "static" if static else "running"
        print(f"flash {what} {mode}: max|diff| {err:.3g}, max|plain| {ref_max:.3g}, limit "
              f"{TOL['bf16']} x max|plain| = {TOL['bf16'] * ref_max:.3g}", flush=True)
        if not math.isfinite(err) or err > TOL["bf16"] * ref_max:
            fail(f"flash {what} {mode}: max|diff| {err} > {TOL['bf16']} x {ref_max}")
        return err

    max_err, shapes = 0.0, []
    for seq, lq, lk, h in ((2, 4608, 9216, 5), (2, 1152, 2304, 10), (4, 2304, 9216, 5),
                           (4, 576, 2304, 10)):
        b, d = INTRA_FRAMES, 64
        q, k, v = inputs(b, lq, lk, h, d)
        what = f"bf16 seq {seq} Lq={lq} Lk={lk} B*H={b * h}"
        row = {"seq": seq, "frames": b, "Lq": lq, "Lk": lk, "BH": b * h, "D": d}
        for static in (True, False):
            err = compare(what, q, k, v, static)
            row["err_static" if static else "err_running"] = err
            max_err = max(max_err, err)
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4 * b * h * lq * lk * d
        row["bound_ms"], row["bound_by"] = bound(flops, 2 * b * h * d * 2 * (lq + lk),
                                                 H100_BF16_FLOPS)
        add_rates(row, flops)
        print(f"flash {what}: kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.3f}, "
              f"library_ms (SDPA) {row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
              f"({row['bound_by']}); {rates_text(row)}", flush=True)
        shapes.append(row)
    for d in (64, 72):  # ragged: neither length on a tile, the keys past the last
        q, k, v = inputs(2, 601, 1203, 3, d)
        for static in (True, False):
            max_err = max(max_err, compare(f"bf16 d={d} Lq=601 Lk=1203", q, k, v, static))
    return {"max_abs_err": max_err, "shapes": shapes}


def check_frame_attention_72(torch, ta, F) -> dict:
    """Frame attention at the factorized DiT-XL's temporal sites: B = 1,
    F = 8, L = 640, 16 heads, d = 72, bf16 and fp32."""
    g = torch.Generator(device="cuda").manual_seed(7)
    print("frame attention d=72 tolerance: bf16 one bf16 ulp at max|plain|, "
          f"fp32 {TOL['fp32']} x max|plain| (as at d = 64)")
    max_err = 0.0
    shapes, fp32_rows = [], []
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(1, 8, 640, 16, 72, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        before = ta.launches
        got = ta.frame_attention(q, k, v)
        torch.cuda.synchronize()
        if ta.launches != before + 1:
            fail("the frame-attention wrapper did not count its launch")
        ref = ta.frame_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
        print(f"frame_attention d=72 F=8 L=640 H=16 {dtype}: max|diff| {err:.3g}, max|plain| "
              f"{ref_max:.3g}, limit {tol:.3g}", flush=True)
        if not math.isfinite(err) or err > tol:
            fail(f"frame_attention d=72 {dtype}: max|diff| {err} > {tol}")
        if dtype != torch.bfloat16:
            fp32_rows.append(time_frame_fp32(torch, ta, F, q, k, v))
            continue
        max_err = err
        row = {"L": 640, "H": 16, "F": 8, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
        row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                                  warmup=1)
        qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(640, 16, 8, 72).contiguous()
                      for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = bound(640 * 16 * 4 * 8 * 8 * 72,
                                                 4 * 8 * 640 * 16 * 72 * 2, H100_BF16_FLOPS)
        add_shares(row)
        print(f"frame_attention d=72 F=8 L=640 H=16: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'SDPA')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes, "fp32": fp32_rows}


def check_dit_sharded_kernels(torch, fa, ta, F) -> dict:
    """Phase 10's kernel shapes: B1 bf16 at d = 72 where seq sharding puts
    DiT-XL's joint3d queries (1 x 16 heads; seq 2 (2560, 5120), seq 4 (1280,
    5120)), both softmax modes, each timed beside its plain version and SDPA
    with its bound, plus a ragged (Lq, Lk); and B3 bf16 at d = 72 at the
    factorized seq-2 rank's local L = 320 (F = 8, 16 heads), timed likewise."""
    g = torch.Generator(device="cuda").manual_seed(17)

    def inputs(b, lq, lk, h, d):
        q = torch.randn(b, lq, h, d, generator=g, device="cuda").bfloat16()
        k, v = (torch.randn(b, lk, h, d, generator=g, device="cuda").bfloat16()
                for _ in range(2))
        return q, k, v

    max_err, flash_rows = 0.0, []
    for seq, lq, lk in ((2, 2560, 5120), (4, 1280, 5120), (0, 333, 5077)):
        b, h, d = 1, 16, 72
        q, k, v = inputs(b, lq, lk, h, d)
        what = (f"d=72 bf16 {'ragged' if not seq else f'DiT joint3d seq {seq}'} Lq={lq} "
                f"Lk={lk} B*H={b * h}")
        row = {"seq": seq, "Lq": lq, "Lk": lk, "BH": b * h, "D": d}
        for static in (True, False):
            err, _ = compare_flash(torch, fa, what, q, k, v, static, False, TOL["bf16"])
            row["err_static" if static else "err_running"] = err
            max_err = max(max_err, err)
        if not seq:
            continue
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static_max=True))
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, True),
                                  iters=3, warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh))
        flops = 4 * b * h * lq * lk * d
        row["bound_ms"], row["bound_by"] = bound(flops, 2 * b * h * d * 2 * (lq + lk),
                                                 H100_BF16_FLOPS)
        add_rates(row, flops)
        print(f"flash {what}: kernel_ms {row['ms']:.4f}, plain_ms {row['plain_ms']:.3f}, "
              f"library_ms (SDPA) {row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} "
              f"({row['bound_by']}); {rates_text(row)}", flush=True)
        flash_rows.append(row)

    fr, l, h, d = DIT_FRAMES, 320, 16, 72
    q, k, v = (torch.randn(1, fr, l, h, d, generator=g, device="cuda").bfloat16()
               for _ in range(3))
    before = ta.launches
    got = ta.frame_attention(q, k, v)
    torch.cuda.synchronize()
    if ta.launches != before + 1:
        fail("the frame-attention wrapper did not count its launch")
    ref = ta.frame_attention_plain(q, k, v).float()
    err = (got.float() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    tol = bf16_ulp(ref_max)
    print(f"frame_attention d=72 bf16 F={fr} L={l} H={h} (factorized seq 2): max|diff| {err:.3g}, "
          f"max|plain| {ref_max:.3g}, limit {tol:.3g}", flush=True)
    if not math.isfinite(err) or err > tol:
        fail(f"frame_attention d=72 F={fr} L={l}: max|diff| {err} > {tol}")
    row = {"L": l, "H": h, "F": fr, "D": d, "ref_max": ref_max, "err": err}
    row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
    row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3, warmup=1)
    qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(l, h, fr, d).contiguous() for t in (q, k, v))
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
    row["bound_ms"], row["bound_by"] = bound(l * h * 4 * fr * fr * d, 4 * fr * l * h * d * 2,
                                             H100_BF16_FLOPS)
    add_shares(row)
    print(f"frame_attention d=72 F={fr} L={l} H={h}: kernel_ms {row['ms']:.4f}, plain_ms "
          f"{row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
          f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
          f"{shares_text(row, 'SDPA')}", flush=True)
    return {"flash": {"max_abs_err": max_err, "shapes": flash_rows},
            "frame": {"max_abs_err": err, "shapes": [row]}}


def compare_flash(torch, fa, what: str, q, k, v, static: bool, exp_bf16: bool,
                  tol: float) -> tuple[float, float]:
    """One flash launch (counted by the wrapper) against the plain version on
    the same inputs; fails past ``tol`` x max|plain|. Returns (max|diff|,
    max|plain|)."""
    before = fa.launches.total()
    got = fa.flash_attention(q, k, v, static_max=static, exp_bf16=exp_bf16)
    torch.cuda.synchronize()
    if fa.launches.total() != before + 1:
        fail(f"flash {what}: the wrapper did not count its launch")
    ref = fa.flash_attention_plain(q, k, v, static, exp_bf16).float()
    torch.cuda.synchronize()
    err = (got.float() - ref).abs().max().item()
    ref_max = ref.abs().max().item()
    mode = "static" if static else "running" + (" exp_bf16" if exp_bf16 else "")
    print(f"flash {what} {mode}: max|diff| {err:.3g}, max|plain| {ref_max:.3g}, limit {tol} x "
          f"max|plain| = {tol * ref_max:.3g}", flush=True)
    if not math.isfinite(err) or err > tol * ref_max:
        fail(f"flash {what} {mode}: max|diff| {err} > {tol} x {ref_max}")
    return err, ref_max


def time_flash_row(torch, fa, F, q, k, v, row: dict, exp_bf16: bool = False) -> dict:
    """Kernel, plain and SDPA milliseconds of ``q, k, v`` into ``row``, with
    the bound: the tensor cores' bf16 rate for bf16, the SIMT fp32 rate for
    fp32 (the tensor cores would round to TF32), or the bytes. With
    ``exp_bf16`` the kernel and the plain version run that form (running max)."""
    b, l, h, d = q.shape
    static = not exp_bf16
    row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, static, exp_bf16), iters=5,
                        warmup=1)
    row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v, static, exp_bf16),
                              iters=3, warmup=1)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                iters=5, warmup=1)
    flops = 4 * b * h * l * l * d
    peak = H100_BF16_FLOPS if q.dtype == torch.bfloat16 else H100_FP32_FLOPS
    row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * h * l * d * q.element_size(), peak)
    add_rates(row, flops)
    return row


def check_flash_generic(torch, fa, F) -> dict:
    """The generic flash kernels (every head dim up to 512 without a kernel
    of its own: ``flash_fwd_any`` in bf16, ``flash_fwd_any_f32``) at d = 16
    (the tiny SVD UNet's and DiT's), 40, 80, 128 and 256, bf16 and fp32, both
    softmax modes, at a ragged L = 600 (B = 2, 3 heads) and at L = 2304
    (B = 1, 8 heads), which is timed; at GENERIC_EDGE_DIMS with Lq != Lk; and
    bf16 d = 128 at GENERIC_LONG_ROW, timed."""
    g = torch.Generator(device="cuda").manual_seed(12)
    print(f"flash generic tolerance: as at d = 64, {TOL['bf16']} x max|plain| in bf16, "
          f"{TOL['fp32']} x max|plain| in fp32")
    max_err = 0.0
    shapes = []
    for d in GENERIC_FLASH_DIMS:
        for b, l, h in GENERIC_FLASH_SHAPES:
            base = [torch.randn(b, l, h, d, generator=g, device="cuda") for _ in range(3)]
            for name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
                q, k, v = (t.to(dtype) for t in base)
                for static in (True, False):
                    err, ref_max = compare_flash(torch, fa, f"generic d={d} {name} B={b} L={l} "
                                                 f"H={h}", q, k, v, static, False, TOL[name])
                    max_err = max(max_err, err)
                if l < 2304:
                    continue
                row = time_flash_row(torch, fa, F, q, k, v,
                                     {"D": d, "B": b, "L": l, "H": h, "dtype": name,
                                      "ref_max": ref_max})
                print(f"flash generic d={d} {name} B={b} L={l} H={h}: kernel_ms "
                      f"{row['ms']:.4f}, plain_ms {row['plain_ms']:.3f}, library_ms (SDPA "
                      f"{name}) {row['library_ms']:.4f}, bound_ms {row['bound_ms']:.5f} "
                      f"({row['bound_by']}); {rates_text(row)}", flush=True)
                shapes.append(row)
    max_err = max(max_err, check_flash_edges(torch, fa, g, "generic", GENERIC_EDGE_DIMS,
                                             EDGE_SHAPE))
    b, l, h = GENERIC_LONG_ROW
    q, k, v = (torch.randn(b, l, h, 128, generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    for static in (True, False):
        err, ref_max = compare_flash(torch, fa, f"generic long row d=128 bf16 B={b} L={l} H={h}",
                                     q, k, v, static, False, TOL["bf16"])
        max_err = max(max_err, err)
    row = time_flash_row(torch, fa, F, q, k, v, {"D": 128, "B": b, "L": l, "H": h,
                                                 "dtype": "bf16", "ref_max": ref_max})
    print(f"flash generic long row d=128 bf16 B={b} L={l} H={h}: kernel_ms {row['ms']:.4f}, "
          f"plain_ms {row['plain_ms']:.3f}, library_ms (SDPA bf16) {row['library_ms']:.4f}, "
          f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']}); {rates_text(row)}", flush=True)
    shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_flash_edges(torch, fa, g, what: str, dims, shape) -> float:
    """Flash at each head dim of ``dims``, bf16 and fp32, both softmax modes,
    at (B, Lq, Lk, H) = ``shape``, against the plain version; returns the
    largest bf16 max|diff|."""
    b, lq, lk, h = shape
    max_err = 0.0
    for d in dims:
        base = [torch.randn(b, n, h, d, generator=g, device="cuda") for n in (lq, lk, lk)]
        for name in ("bf16", "fp32"):
            q, k, v = (t.to(dtype_of(torch, name)) for t in base)
            for static in (True, False):
                err, _ = compare_flash(torch, fa, f"{what} d={d} {name} B={b} Lq={lq} Lk={lk} "
                                       f"H={h}", q, k, v, static, False, TOL[name])
                if name == "bf16":
                    max_err = max(max_err, err)
    return max_err


def exp_inputs(torch, g, b, l, h, d, dtype):
    """N(0, 1) q, k, v in ``dtype`` whose every row has its largest score at
    key 0: q's column 0 is 1, k's is 0 but for key 0, whose other columns are
    0 and whose column 0 is 8 sqrt(d), so that s_0 = 8 against N(0, 1) scores
    of the other keys (checked)."""
    q, k, v = (torch.randn(b, l, h, d, generator=g, device="cuda") for _ in range(3))
    q[..., 0] = 1.0
    k[..., 0] = 0.0
    k[:, 0] = 0.0
    k[:, 0, :, 0] = 8.0 * math.sqrt(d)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    if not bool((s[..., 0] > s[..., 1:].amax(dim=-1)).all()):
        fail(f"exp_inputs d={d} L={l}: a row's largest score is not at key 0")
    return q, k, v


def check_flash_exp(torch, fa, F) -> dict:
    """VDPP_FLASH_EXP=bf16 (running max, s - m and its exponential rounded to
    bf16) on every kernel that has a running-max form: d = 64 bf16 (wgmma)
    and fp32, d = 512 bf16 (wgmma) and fp32, the generic kernels at d = 16,
    80 and 136 (bf16: with the producer warpgroup, then without), and the kernels
    above d = 512 at the first and last of
    WIDE_FLASH_DIMS, on ``exp_inputs``; the d = 64 bf16 site at L = 2304 is
    timed."""
    g = torch.Generator(device="cuda").manual_seed(13)
    print(f"flash VDPP_FLASH_EXP=bf16 tolerance: fp32 {EXP_TOL_FP32} x max|plain|, below the "
          f"flag's own effect (checked); bf16 {TOL['bf16']} x max|plain| as without the flag, "
          f"the kernel's output with the flag differing from its output without it, and "
          f"in fewer elements from the plain version's with the flag than without it")
    max_err = 0.0
    shapes = []
    for d, b, l, h, dtype in ((64, 1, 2304, 10, torch.bfloat16), (64, 2, 600, 3, torch.bfloat16),
                              (64, 2, 600, 3, torch.float32), (512, 1, 2560, 1, torch.bfloat16),
                              (512, 1, 2560, 1, torch.float32), (16, 2, 600, 3, torch.bfloat16),
                              (16, 2, 600, 3, torch.float32), (80, 1, 2304, 8, torch.bfloat16),
                              (80, 1, 2304, 8, torch.float32), (136, 2, 600, 3, torch.bfloat16),
                              (136, 2, 600, 3, torch.float32),
                              *((d, 1, WIDE_FLASH_SHAPE[1], WIDE_FLASH_SHAPE[2], dtype)
                                for d in (WIDE_FLASH_DIMS[0], WIDE_FLASH_DIMS[-1])
                                for dtype in (torch.bfloat16, torch.float32))):
        q, k, v = exp_inputs(torch, g, b, l, h, d, dtype)
        name = "bf16" if dtype == torch.bfloat16 else "fp32"
        what = f"d={d} {name} B={b} L={l} H={h}"
        tol = EXP_TOL_FP32 if name == "fp32" else TOL["bf16"]
        before = fa.exp_bf16_launches.total()
        err, ref_max = compare_flash(torch, fa, what, q, k, v, False, True, tol)
        if fa.exp_bf16_launches.total() != before + 1:
            fail(f"flash {what}: the bf16-exponent launch was not counted")
        with_flag = fa.flash_attention(q, k, v, False, True)
        without = fa.flash_attention(q, k, v, False, False)
        plain_with = fa.flash_attention_plain(q, k, v, False, True)
        plain_without = fa.flash_attention_plain(q, k, v, False, False)
        changed = (with_flag != without).float().mean().item()
        off_with = (with_flag != plain_with).float().mean().item()
        off_without = (with_flag != plain_without).float().mean().item()
        effect = (plain_with.float() - plain_without.float()).abs().max().item()
        print(f"flash exp_bf16 {what}: the flag's own effect (plain with it against without "
              f"it) max|diff| {effect:.3g} = {effect / ref_max:.3g} x max|plain|; the kernel's "
              f"outputs with and without it differ in {changed:.3%} of the elements; the "
              f"kernel's output with it differs from the plain version's with it in "
              f"{off_with:.3%}, without it in {off_without:.3%}", flush=True)
        if changed == 0.0:
            fail(f"flash exp_bf16 {what}: the kernel gave the same output without the flag")
        if name == "fp32" and effect <= tol * ref_max:
            fail(f"flash exp_bf16 {what}: the flag's own effect {effect} is within the limit")
        if name == "bf16" and off_with >= off_without:
            fail(f"flash exp_bf16 {what}: the kernel is nearer the plain version without the "
                 f"flag ({off_without:.3%} of the elements differ) than with it ({off_with:.3%})")
        max_err = max(max_err, err)
        if (d, l, dtype) == (64, 2304, torch.bfloat16):
            row = time_flash_row(torch, fa, F, q, k, v,
                                 {"D": d, "B": b, "L": l, "H": h, "dtype": name,
                                  "ref_max": ref_max}, exp_bf16=True)
            row["running_ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v, False, False),
                                        iters=5, warmup=1)
            print(f"flash exp_bf16 {what}: kernel_ms {row['ms']:.4f} "
                  f"(running max without it {row['running_ms']:.4f}), plain_ms "
                  f"{row['plain_ms']:.3f}, library_ms (SDPA) {row['library_ms']:.4f}, "
                  f"bound_ms {row['bound_ms']:.5f} ({row['bound_by']}); {rates_text(row)}",
                  flush=True)
            shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def check_frame_generic(torch, ta, F) -> dict:
    """The generic frame-attention kernel (every head dim but 64 and 72, and
    more than 32 frames) at d = 16 and 40 with F = 14 (the tiny configs' head
    dim at the image->video app's frame count) and d = 64 with F = 48: B = 1,
    L = 1024, 4 heads, bf16 and fp32; the bf16 cases are timed."""
    g = torch.Generator(device="cuda").manual_seed(14)
    print("frame attention generic tolerance: bf16 one bf16 ulp at max|plain|, "
          f"fp32 {TOL['fp32']} x max|plain| (as at d = 64)")
    max_err = 0.0
    shapes = []
    l, h = 1024, 4
    for d, f in GENERIC_FRAME_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = (torch.randn(1, f, l, h, d, generator=g, device="cuda").to(dtype)
                       for _ in range(3))
            before = ta.launches
            got = ta.frame_attention(q, k, v)
            torch.cuda.synchronize()
            if ta.launches != before + 1:
                fail("the frame-attention wrapper did not count its launch")
            ref = ta.frame_attention_plain(q, k, v)
            err = (got.float() - ref.float()).abs().max().item()
            ref_max = ref.float().abs().max().item()
            tol = bf16_ulp(ref_max) if dtype == torch.bfloat16 else TOL["fp32"] * ref_max
            print(f"frame_attention generic d={d} F={f} L={l} H={h} {dtype}: max|diff| "
                  f"{err:.3g}, max|plain| {ref_max:.3g}, limit {tol:.3g}", flush=True)
            if not math.isfinite(err) or err > tol:
                fail(f"frame_attention generic d={d} F={f} {dtype}: max|diff| {err} > {tol}")
            max_err = max(max_err, err)
            if dtype != torch.bfloat16:
                continue
            row = {"D": d, "F": f, "L": l, "H": h, "ref_max": ref_max}
            row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
            row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                                      warmup=1)
            qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(l, h, f, d).contiguous()
                          for t in (q, k, v))
            row["library_ms"] = time_ms(torch,
                                        lambda: F.scaled_dot_product_attention(qt, kt, vt))
            row["bound_ms"], row["bound_by"] = bound(l * h * 4 * f * f * d, 4 * f * l * h * d * 2,
                                                     H100_BF16_FLOPS)
            add_shares(row)
            print(f"frame_attention generic d={d} F={f} L={l} H={h}: kernel_ms {row['ms']:.4f}, "
                  f"plain_ms {row['plain_ms']:.3f}, library_ms (SDPA on a (L, H, F, D) copy) "
                  f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.5f} ({row['bound_by']}); "
                  f"{shares_text(row, 'SDPA')}", flush=True)
            shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


@contextlib.contextmanager
def kernel_switches(switches: dict[str, str] = SWITCHES):
    """Opt-in kernel switches on, by default both (VDPP_GN_FUSED=1 is read
    when a wrapper is built, VDPP_TEMPORAL_ATTN=pallas at every call)."""
    saved = {k: os.environ.get(k) for k in switches}
    os.environ.update(switches)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_agreement(torch, switches: bool) -> None:
    """A small UNet with head dim 64 (level 0 has 512 tokens, so the flash
    kernel runs) in fp32: the card's forward and CFG Euler step against the
    same weights and inputs on the CPU (plain versions). With ``switches``
    its GroupNorm+SiLU pairs and temporal attention take the fused kernels
    on the card, which must launch."""
    import dataclasses

    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    cfg = SVDUNetConfig(block_out_channels=(128, 256), num_attention_heads=(2, 4),
                        layers_per_block=1, cross_attention_dim=64,
                        addition_time_embed_dim=8, projection_class_embeddings_input_dim=24,
                        norm_num_groups=8, dtype=torch.float32, fused_groupnorm=switches)
    params = {"cpu": StableVideoUNet(cfg, device="cpu").init(torch.Generator().manual_seed(0))}
    params["cuda"] = SVDUNet(cfg, device="cuda")
    params["cuda"].load_state_dict(params["cpu"].state_dict())
    cond = make_dummy_conditioning(torch.Generator().manual_seed(1), 1, 3, 16, 32,
                                   cross_dim=64, guidance_scale=3.0)
    x = torch.randn(1, 1, 3, 16, 32, 4, generator=torch.Generator().manual_seed(2))
    outs = {}
    with kernel_switches() if switches else contextlib.nullcontext():
        for dev in ("cpu", "cuda"):
            nk.launches = ta.launches = 0
            model = StableVideoUNet(cfg, num_steps=4, device=dev)
            c = dataclasses.replace(cond, **{f.name: getattr(cond, f.name).to(dev)
                                             for f in dataclasses.fields(cond)})
            xd = (x * model.init_noise_sigma).to(dev)
            with torch.inference_mode():
                lat = torch.cat([xd[0], c.image_latents], dim=-1)
                fwd = params[dev](lat, 0.5, c.image_embeddings, c.added_time_ids)
                step = run_reference_single_device(model.pipeline_step_fn(), (params[dev], c),
                                                   xd, 1)
            outs[dev] = (fwd.cpu(), step.cpu())
    what = "with both kernel switches" if switches else "as it is"
    if switches and not (nk.launches and ta.launches):
        fail(f"the small UNet {what} launched GroupNorm+SiLU {nk.launches} and frame "
             f"attention {ta.launches} times on the card")
    for name, i in (("UNet forward", 0), ("CFG Euler step", 1)):
        ref = outs["cpu"][i]
        rel = ((outs["cuda"][i] - ref).abs().max() / ref.abs().max()).item()
        print(f"agreement card vs CPU, small fp32 UNet {what} ({name}): max|diff|/max|ref| "
              f"{rel:.3g} (tolerance 1e-4: fp32 sums in other orders, no TF32)")
        if not math.isfinite(rel) or rel > 1e-4:
            fail(f"card and CPU disagree on the small UNet {what} ({name}): {rel}")


def check_vae_agreement(torch, fa) -> None:
    """A small fp32 temporal VAE decoder with 512 top channels (its mid-block
    attention is one head at d = 512 over 16 x 32 = 512 latent positions, so
    it takes the flash kernel on the card): ``decode_chunked`` of 3 frames in
    chunks of 2 on the card against the same weights on the CPU."""
    from vdpp_tpu_torch.models.vae import TemporalVAEDecoder, VAEConfig

    cfg = VAEConfig(block_out_channels=(64, 512), layers_per_block=1)
    cpu = TemporalVAEDecoder(cfg, device="cpu").init_weights(torch.Generator().manual_seed(4))
    card = TemporalVAEDecoder(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    lat = torch.randn(1, 3, 16, 32, 4, generator=torch.Generator().manual_seed(5))
    ref = cpu.decode_chunked(lat, chunk_frames=2)
    fa.launches.clear()
    got = card.decode_chunked(lat.cuda(), chunk_frames=2).cpu()
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    print(f"agreement card vs CPU, small fp32 VAE decoder (d = 512 attention, 2 chunks): "
          f"max|diff|/max|ref| {rel:.3g} (tolerance 1e-4: fp32 sums in other orders, no TF32); "
          f"flash launches {fa.launches.total()}")
    if fa.launches.total() != 2:
        fail(f"the small VAE decoder launched the flash kernel {fa.launches.total()} times, "
             f"expected 2")
    if got.shape != (1, 3, 32, 64, 3) or not math.isfinite(rel) or rel > 1e-4:
        fail(f"card and CPU disagree on the small VAE decoder: {rel}, shape {tuple(got.shape)}")


def check_dit_agreement(torch, fa, ta) -> None:
    """A small fp32 DiT with DiT-XL's head dim (hidden 144 over 2 heads),
    depth 2, 4 frames of a 32 x 64 latent (512 patch tokens a frame): its
    forward and one CFG Euler step on the card against the same weights on
    the CPU, joint3d (2 flash launches a forward, L = 2048) and then
    factorized with VDPP_TEMPORAL_ATTN=pallas (1 flash launch, L = 512, and 1
    frame-attention launch a forward)."""
    from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoConfig, DiTVideoWrapper
    from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    g = torch.Generator().manual_seed(8)
    lat = torch.randn(1, 4, 32, 64, 4, generator=g)
    ctx = torch.randn(1, 7, 32, generator=g)
    for mode, want in (("joint3d", (2, 0)), ("factorized", (1, 1))):
        cfg = DiTVideoConfig(hidden_size=144, depth=2, num_heads=2, cross_attention_dim=32,
                             attention_mode=mode, dtype=torch.float32)
        models = {"cpu": DiTVideo(cfg, device="cpu").init_weights(torch.Generator().manual_seed(9))}
        models["cuda"] = DiTVideo(cfg, device="cuda")
        models["cuda"].load_state_dict(models["cpu"].state_dict())
        outs, counts = {}, {}
        with kernel_switches(TEMPORAL_SWITCH) if mode == "factorized" else \
                contextlib.nullcontext():
            for dev, model in models.items():
                wrapper = DiTVideoWrapper(cfg, num_steps=4, device=dev)
                bundle = (model, ctx.to(dev), make_guidance_ramp(6.0, 4, device=dev))
                fa.launches.clear()
                ta.launches = 0
                with torch.inference_mode():
                    fwd = model(lat.to(dev), 0.3, ctx.to(dev))
                    step = run_reference_single_device(
                        wrapper.pipeline_step_fn(), bundle,
                        (lat * wrapper.init_noise_sigma).to(dev)[None], 1)
                outs[dev] = (fwd.cpu(), step.cpu())
                counts[dev] = (fa.launches.total(), ta.launches)
        what = "joint3d" if mode == "joint3d" else "factorized with VDPP_TEMPORAL_ATTN=pallas"
        forwards = 3  # the forward, then the step's two CFG forwards
        expect(f"flash in the small DiT {what} on the card", counts["cuda"][0],
               want[0] * forwards)
        expect(f"frame attention in the small DiT {what} on the card", counts["cuda"][1],
               want[1] * forwards)
        for name, i in (("forward", 0), ("CFG Euler step", 1)):
            ref = outs["cpu"][i]
            rel = ((outs["cuda"][i] - ref).abs().max() / ref.abs().max()).item()
            print(f"agreement card vs CPU, small fp32 DiT d=72 {what} ({name}): "
                  f"max|diff|/max|ref| {rel:.3g} (tolerance 1e-4: fp32 sums in other orders, "
                  f"no TF32)")
            if not math.isfinite(rel) or rel > 1e-4:
                fail(f"card and CPU disagree on the small DiT {what} ({name}): {rel}")


def check_encoder_agreement(torch, fa) -> None:
    """The image->video app's two encoders, small and fp32, on the card
    against the same weights on the CPU: a CLIP tower at ViT-H/14's head dim
    80 and 257 tokens (2 layers of width 160; it must launch no flash
    kernel), and a VAE encoder whose last level has 512 channels, so that
    its mid-block attention (one head, d = 512, over the 32 x 32 positions
    of a 64 x 64 image) takes the flash kernel once."""
    from vdpp_tpu_torch.models.clip_encoder import CLIPVisionConfig, CLIPVisionEncoder
    from vdpp_tpu_torch.models.vae import VAEConfig, VAEEncoder

    g = torch.Generator().manual_seed(10)
    clip_cfg = CLIPVisionConfig(hidden_size=160, num_layers=2, num_heads=2, projection_dim=64)
    vae_cfg = VAEConfig(block_out_channels=(64, 512), layers_per_block=1)
    cases = (("CLIP tower (head dim 80, L = 257)", CLIPVisionEncoder, clip_cfg,
              torch.randn(2, 224, 224, 3, generator=g), {}),
             ("VAE encoder (d = 512 attention, L = 1024)", VAEEncoder, vae_cfg,
              torch.randn(2, 64, 64, 3, generator=g), {512: 1}))
    for what, cls, cfg, x, want in cases:
        cpu = cls(cfg, device="cpu").init_weights(torch.Generator().manual_seed(11))
        card = cls(cfg, device="cuda")
        card.load_state_dict(cpu.state_dict())
        ref = cpu.apply(x)
        fa.launches.clear()
        got = card.apply(x.cuda()).cpu()
        rel = ((got - ref).abs().max() / ref.abs().max()).item()
        print(f"agreement card vs CPU, small fp32 {what}: output {tuple(got.shape)}, "
              f"max|diff|/max|ref| {rel:.3g} (tolerance 1e-4: fp32 sums in other orders, no "
              f"TF32); flash launches by head dim {dict(fa.launches)}")
        if dict(fa.launches) != want:
            fail(f"the small {what} launched flash {dict(fa.launches)}, "
                 f"expected {want}")
        if got.shape != ref.shape or not math.isfinite(rel) or rel > 1e-4:
            fail(f"card and CPU disagree on the small {what}: {rel}")


def y4m_frames(path: str) -> tuple[int, int, int]:
    """(frames, width, height) of a Y4M file."""
    with open(path, "rb") as f:
        data = f.read()
    header = data[:data.index(b"\n")].split()
    w = int(next(t[1:] for t in header if t.startswith(b"W")))
    h = int(next(t[1:] for t in header if t.startswith(b"H")))
    return data.count(b"FRAME"), w, h


def gif_frames(path: str) -> tuple[int, int, int]:
    """(frames, width, height) of a GIF: its image descriptors, found by
    walking the blocks."""
    with open(path, "rb") as f:
        data = f.read()
    w, h = int.from_bytes(data[6:8], "little"), int.from_bytes(data[8:10], "little")
    pos = 13 + (3 << ((data[10] & 7) + 1) if data[10] & 0x80 else 0)

    def skip_sub_blocks(pos: int) -> int:
        while data[pos]:
            pos += data[pos] + 1
        return pos + 1

    frames = 0
    while pos < len(data) and data[pos] != 0x3B:
        if data[pos] == 0x21:  # extension: label, then sub-blocks
            pos = skip_sub_blocks(pos + 2)
        elif data[pos] == 0x2C:  # image descriptor, local colour table, LZW data
            flags = data[pos + 9]
            pos += 10 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)
            pos = skip_sub_blocks(pos + 1)
            frames += 1
        else:
            fail(f"{path}: unexpected GIF block 0x{data[pos]:02x} at byte {pos}")
    return frames, w, h


def run_app(torch, fa, nk, ta, smi: str) -> dict:
    """The image->video app at full width through its entry point,
    ``apps.generate_video.main``: random weights from a seed, SVD-XT,
    ViT-H/14 and the SVD VAE in fp32, the synthetic card at 1024x576, 14
    frames, APP_STEPS Euler steps, into a temporary directory. The launch
    counts are set to 0 just before and read just after; the files must
    hold 14 frames of 1024x576. Returns the app's TIMING split, the encode
    seconds, the peak memory and the launch counts."""
    import logging
    import shutil
    import tempfile

    from vdpp_tpu_torch.apps import generate_video

    lines: list[str] = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    keep = Keep()
    logging.getLogger("vdpp_torch.generate").addHandler(keep)
    logging.getLogger("vdpp_torch.generate").setLevel(logging.INFO)
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_app_")
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_counts(fa, nk, ta)
        t0 = time.perf_counter()
        # One stage, in this process (the counts and log lines are read here),
        # on any number of cards; the pipeline phase spawns the stages.
        rc = generate_video.main(["--random-weights", "--steps", str(APP_STEPS), "--device",
                                  "cuda", "--num-stages", "1", "--output-dir", out_dir])
        wall = time.perf_counter() - t0
        flash = dict(fa.launches)
        counts = {"gn": nk.launches, "frame": ta.launches}
        peak = torch.cuda.max_memory_allocated()
        files = {os.path.splitext(n)[1]: os.path.join(out_dir, n) for n in os.listdir(out_dir)}
        if rc != 0:
            fail(f"the image->video app returned {rc}")
        want = (APP_FRAMES, APP_W, APP_H)
        # The native writer (the card's machine has no imageio) writes an
        # MJPEG MP4 and a lossless Y4M beside it; the Y4M is read back.
        if not ({".mp4", ".y4m", ".gif"} <= set(files)
                and os.path.getsize(files[".mp4"]) > 0):
            fail(f"the image->video app wrote {sorted(files)}, not an MP4, a Y4M and a GIF")
        video = y4m_frames(files[".y4m"])
        gif = gif_frames(files[".gif"])
        # The restyle phase's input.
        fd, y4m = tempfile.mkstemp(prefix="chip_smoke_app_", suffix=".y4m")
        os.close(fd)
        shutil.copyfile(files[".y4m"], y4m)
    finally:
        logging.getLogger("vdpp_torch.generate").removeHandler(keep)
        shutil.rmtree(out_dir, ignore_errors=True)
    print(f"image->video app: y4m {video}, gif {gif} (frames, width, height; expected "
          f"{want}), {wall:.3f} s in main ({smi})")
    if video != want or gif != want:
        fail(f"the app's files hold y4m {video} and gif {gif}, expected {want}")
    for d, n in FLASH_PER_APP.items():
        expect(f"flash at d = {d} in the image->video app", flash.get(d, 0), n)
    if set(flash) - set(FLASH_PER_APP):
        fail(f"the image->video app launched flash at head dims {sorted(flash)}")
    expect("GroupNorm+SiLU in the image->video app", counts["gn"], 0)
    expect("frame attention in the image->video app", counts["frame"], 0)
    timing = next((ln for ln in lines if ln.startswith("TIMING")), None)
    encode = next((ln for ln in lines if ln.startswith("conditioning encoded")), None)
    decode = next((ln for ln in lines if ln.startswith("decoded in")), None)
    if timing is None or encode is None or decode is None:
        fail("the image->video app logged no TIMING, encode or decode line")
    secs = dict(zip(("load", "encode", "diffusion", "decode_save", "total"),
                    map(float, re.findall(r"([0-9.]+)s", timing))))
    secs.update(zip(("encode_total", "preprocess", "clip", "vae_encode"),
                    map(float, re.findall(r"([0-9.]+)s", encode))))
    secs.update(zip(("decode", "save"), map(float, re.findall(r"([0-9.]+)s", decode))))
    print(f"image->video app {timing} ({smi})")
    print(f"image->video app encode: CLIP ViT-H/14 fp32 {secs['clip']:.3f} s, VAE encode fp32 "
          f"at {APP_W}x{APP_H} {secs['vae_encode']:.3f} s, preprocess {secs['preprocess']:.3f} s "
          f"(cold: first call of each in the process); decode fp32 of {APP_FRAMES} frames "
          f"{secs['decode']:.3f} s, writing the files {secs['save']:.3f} s ({smi})")
    print(f"image->video app peak allocated {peak / 2**30:.2f} GiB ({smi})")
    return {"seconds": secs, "peak_mem_bytes": peak, "flash": flash, "y4m": y4m}


def run_entry_point(torch, fa, nk, ta, smi: str, what: str, main, argv: list[str],
                    want_frames: int, want_flash: dict) -> dict:
    """An app through its entry point ``main(argv + ["--output-dir", tmp])``
    at one stage in this process, the launch counts set to 0 just before and
    read just after; its Y4M and GIF must hold ``want_frames`` frames of
    APP_W x APP_H, and flash must have launched ``want_flash`` times by head
    dim."""
    import shutil
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_app_")
    try:
        reset_counts(fa, nk, ta)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        rc = main(argv + ["--num-stages", "1", "--device", "cuda", "--output-dir", out_dir])
        wall = time.perf_counter() - t0
        flash = dict(fa.launches)
        counts = {"gn": nk.launches, "frame": ta.launches}
        peak = torch.cuda.max_memory_allocated()
        if rc != 0:
            fail(f"the {what} returned {rc}")
        files = {os.path.splitext(n)[1]: os.path.join(out_dir, n) for n in os.listdir(out_dir)}
        if not {".mp4", ".y4m", ".gif"} <= set(files):
            fail(f"the {what} wrote {sorted(files)}, not an MP4, a Y4M and a GIF")
        video, gif = y4m_frames(files[".y4m"]), gif_frames(files[".gif"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    want = (want_frames, APP_W, APP_H)
    print(f"{what}: y4m {video}, gif {gif} (frames, width, height; expected {want}), "
          f"{wall:.3f} s in main, peak allocated {peak / 2**30:.2f} GiB ({smi})")
    if video != want or gif != want:
        fail(f"the {what}'s files hold y4m {video} and gif {gif}, expected {want}")
    for d, n in want_flash.items():
        expect(f"flash at d = {d} in the {what}", flash.get(d, 0), n)
    if set(flash) - set(want_flash):
        fail(f"the {what} launched flash at head dims {sorted(flash)}")
    expect(f"GroupNorm+SiLU in the {what}", counts["gn"], 0)
    expect(f"frame attention in the {what}", counts["frame"], 0)
    return {"flash": flash, "wall_s": wall, "peak_mem_bytes": peak}


def run_dit_path(torch, bench, config, context, smi: str, what: str) -> dict:
    """The full-width text->video denoise through ``bench.measure_dit_config``,
    checked."""
    res = bench.measure_dit_config(
        config=config, context=context, frames=DIT_FRAMES, lat_h=DIT_LAT[0], lat_w=DIT_LAT[1],
        steps=STEPS, guidance=6.0, videos=VIDEOS, warmup=1, device="cuda",
    )
    print(f"full width {what}: DiT-XL bf16, {DIT_FRAMES} frames at {DIT_LAT[0]}x{DIT_LAT[1]}, "
          f"CFG ramp to 6, {STEPS} Euler steps: {res['sec_per_step']:.3f} s/step "
          f"({res['sec_per_video']:.3f} s/video of {STEPS} steps), peak allocated "
          f"{res['peak_mem_bytes'] / 2**30:.2f} GiB, output {res['shape']}, finite "
          f"{res['finite']}, on {res['device']} ({smi})")
    if not res["finite"]:
        fail(f"the full-width DiT run {what} gave non-finite values")
    if res["shape"] != (1, DIT_FRAMES, *DIT_LAT, 4):
        fail(f"unexpected DiT output shape {res['shape']}")
    return res


def run_main_path(torch, bench, config, smi: str, what: str) -> dict:
    """The full-width denoise through ``bench.measure_config``, checked."""
    res = bench.measure_config(
        config=config, frames=25, lat_h=72, lat_w=128, steps=STEPS, guidance=3.0,
        cfg_mode="sequential", videos=VIDEOS, warmup=1, device="cuda",
    )
    print(f"full width {what}: SVD-XT bf16, 25 frames at 72x128, CFG 3 sequential, {STEPS} "
          f"Euler steps: {res['sec_per_step']:.3f} s/step ({res['sec_per_video']:.3f} s/video of "
          f"{STEPS} steps), peak allocated {res['peak_mem_bytes'] / 2**30:.2f} GiB, "
          f"output {res['shape']}, finite {res['finite']}, on {res['device']} ({smi})")
    if not res["finite"]:
        fail(f"the full-width run {what} gave non-finite values")
    if res["shape"] != (1, 25, 72, 128, 4):
        fail(f"unexpected output shape {res['shape']}")
    return res


def exact_libraries(torch) -> None:
    """cuDNN picks its algorithms by its heuristics, the same in every
    process, and none that is not deterministic: the pipeline's ranks and
    the single-device run must give the same bits."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def pipeline_case(torch, device, solver: str, interval: int = 0):
    """What every rank and the single-device run build alike on ``device``:
    full-width SVD-XT from seed 0, random conditioning for 25 frames at
    72x128 with a CFG ramp to 3, and PIPE_SAMPLES noise draws packed for
    ``solver`` (dpmpp2m: 8 channels) and DeepCache every ``interval`` steps
    (640 more). euler_a draws its noise from sampler seed 7 on each rank's
    card. Returns (wrapper, params, inputs)."""
    from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning

    config = SVDUNetConfig.svd_xt()
    wrapper = StableVideoUNet(config, num_steps=PIPE_STEPS, cfg_mode="sequential", solver=solver,
                              deepcache_interval=interval, sampler_seed=7, device=device)
    unet = wrapper.init(torch.Generator(device=device).manual_seed(0))
    cond = make_dummy_conditioning(torch.Generator(device=device).manual_seed(1), 1, 25, 72, 128,
                                   cross_dim=config.cross_attention_dim, guidance_scale=3.0)
    noise = torch.randn(PIPE_SAMPLES, 1, 25, 72, 128, 4, device=device,
                        generator=torch.Generator(device=device).manual_seed(2))
    return wrapper, (unet, cond), wrapper.pack_initial(noise * wrapper.init_noise_sigma)


def pipeline_rank(stage, solver: str, interval: int) -> dict:
    """One rank of the pipeline phase, in its own process: the launch counts
    set to 0 just before ``run_ticked`` and read just after; the last rank
    also returns the outputs, the tick seconds and what ``on_sample`` saw."""
    import torch

    from vdpp_tpu_torch.ops import flash_attention as fa
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils import kernels

    exact_libraries(torch)
    wrapper, params, inputs = pipeline_case(torch, stage.device, solver, interval)
    pipe = StepPipeline(stage, wrapper.pipeline_step_fn(),
                        PipelineConfig(PIPE_STEPS, stage.num_stages))
    handoff, handoff_s = stage.handoff, []

    def timed_handoff(out, recv_like):  # host seconds of each tick's hand-off
        t0 = time.perf_counter()
        got = handoff(out, recv_like)
        handoff_s.append(time.perf_counter() - t0)
        return got

    stage.handoff = timed_handoff
    seen = []
    torch.cuda.synchronize(stage.device)
    torch.cuda.reset_peak_memory_stats(stage.device)
    reset_counts(fa, nk, ta)
    res = pipe.run_ticked(params, inputs, on_sample=lambda i, lat: seen.append((i, lat.clone())))
    out = {"rank": stage.rank, "device": str(stage.device),
           "counts": {"flash": dict(fa.launches), "gn": nk.launches, "frame": ta.launches},
           "variants": kernels.variant_launches(),
           "peak": torch.cuda.max_memory_allocated(stage.device),
           "handoff_bytes": inputs[0].numel() * inputs.element_size(), "handoff_s": handoff_s}
    if res is not None:
        outputs, ticks = res
        out.update(outputs=outputs.cpu(), ticks=ticks, on_sample=[i for i, _ in seen],
                   on_sample_equal=all(torch.equal(lat, outputs[i]) for i, lat in seen))
    return out


def same_bits(torch, a, b) -> bool:
    """Equal bit for bit (the packed cache lanes are compared as words)."""
    return a.shape == b.shape and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


def run_pipeline(torch, smi: str, solver: str, interval: int = 0) -> dict:
    """The step pipeline at full width, switched, through ``run_ticked``: two
    ranks on two cards over NCCL where there are two, else both on the one
    card over gloo (the hand-off through host memory). The last rank's
    outputs must equal the single-device run of every step on cuda:0 bit for
    bit; each rank must have launched every kernel on every site. With Euler
    it also times a one-stage ``StepPipeline.run`` against
    ``run_reference_single_device`` in this process (O, P, P, O)."""
    from vdpp_tpu_torch.parallel.mesh import Stage, make_pipeline_mesh, run_stages
    from vdpp_tpu_torch.parallel.pipeline import (
        PipelineConfig,
        StepPipeline,
        run_reference_single_device,
    )

    if torch.cuda.device_count() >= 2:
        mesh = make_pipeline_mesh(PIPE_STAGES, device="cuda")
        how, note = "NCCL, one card a rank (cuda:0, cuda:1)", ""
    else:
        mesh = make_pipeline_mesh(devices=["cuda:0"] * PIPE_STAGES)
        how = "gloo, both ranks sharing cuda:0, the hand-off through host memory"
        note = " (the ranks time-share one card: no measure of pipelining speed)"
    name = solver + (f" x DeepCache-{interval}" if interval else "")
    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.cuda.empty_cache()
    with kernel_switches():
        t0 = time.perf_counter()
        try:
            ranks = spawned(run_stages(mesh, pipeline_rank, solver, interval, timeout=900))
        except (RuntimeError, TimeoutError) as e:
            fail(f"the {name} pipeline failed: {e}")
        wall = time.perf_counter() - t0
        exact_libraries(torch)
        wrapper, params, inputs = pipeline_case(torch, torch.device("cuda:0"), solver, interval)
        step_fn = wrapper.pipeline_step_fn()

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return time.perf_counter() - t, out

        def oracle():
            return run_reference_single_device(step_fn, params, inputs, PIPE_STEPS)

        t_ref, ref = timed(oracle)
        one_stage = {}
        if solver == "euler" and not interval:
            pipe1 = StepPipeline(Stage(make_pipeline_mesh(1, device="cuda"), 0), step_fn,
                                 PipelineConfig(PIPE_STEPS, 1))
            t_p1, out1 = timed(lambda: pipe1.run(params, inputs))
            t_p2, _ = timed(lambda: pipe1.run(params, inputs))
            t_ref2, _ = timed(oracle)
            one_stage = {"oracle_s": [t_ref, t_ref2], "pipeline_s": [t_p1, t_p2],
                         "equal": bool(torch.equal(out1, ref))}
        ref = ref.cpu()
        channels = inputs.shape[-1]
        del wrapper, params, inputs, step_fn
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    torch.cuda.empty_cache()

    last = ranks[-1]
    what = f"the {name} pipeline ({PIPE_STAGES} stages, {how})"
    print(f"{what}: SVD-XT bf16 switched, 25 frames at 72x128, CFG 3 sequential, {PIPE_STEPS} "
          f"steps, {PIPE_SAMPLES} samples: {wall:.3f} s for the spawned ranks, tick seconds "
          f"{[round(t, 4) for t in last['ticks']]}{note} ({smi})")
    for r in ranks:
        print(f"{what}: rank {r['rank']} on {r['device']}: peak allocated {r['peak'] / 2**30:.2f} "
              f"GiB, hand-off {r['handoff_bytes']} bytes a sample, hand-off seconds by tick "
              f"{[round(t, 5) for t in r['handoff_s']]}, launches {r['counts']} ({smi})")
    print(f"{what}: rank 0's tick-0 hand-off ({ranks[0]['handoff_s'][0] * 1e3:.3f} ms) is the "
          f"send alone, rank 1 having posted its receive; a receive's time includes the wait "
          f"for the sender's steps")
    if one_stage:
        print(f"one-stage StepPipeline.run against run_reference_single_device, the same "
              f"{PIPE_SAMPLES} samples x {PIPE_STEPS} steps in this process (O, P, P, O): oracle "
              f"{one_stage['oracle_s'][0]:.3f} / {one_stage['oracle_s'][1]:.3f} s, pipeline "
              f"{one_stage['pipeline_s'][0]:.3f} / {one_stage['pipeline_s'][1]:.3f} s, equal "
              f"{one_stage['equal']} ({smi})")
        if not one_stage["equal"]:
            fail("the one-stage pipeline differs from run_reference_single_device")
    want_ch = 4 * (2 if solver == "dpmpp2m" else 1) + (640 if interval else 0)
    want_shape = (PIPE_SAMPLES, 1, 25, 72, 128, want_ch)
    out = last["outputs"]
    equal = same_bits(torch, out, ref)
    head = out[..., :4 * (2 if solver == "dpmpp2m" else 1)]
    print(f"{what}: output {tuple(out.shape)}, latent finite {bool(torch.isfinite(head).all())}, "
          f"equal bit for bit to the single-device run {equal}, {len(last['ticks'])} ticks, "
          f"on_sample {last['on_sample']}")
    if tuple(out.shape) != want_shape or channels != want_ch or not torch.isfinite(head).all():
        fail(f"{what} gave {tuple(out.shape)} (expected {want_shape}) or non-finite values")
    if not equal:
        fail(f"{what} differs from the single-device run")
    if len(last["ticks"]) != PIPE_SAMPLES + PIPE_STAGES - 1:
        fail(f"{what} ran {len(last['ticks'])} ticks")
    if last["on_sample"] != list(range(PIPE_SAMPLES)) or not last["on_sample_equal"]:
        fail(f"{what}: on_sample saw {last['on_sample']}, equal {last['on_sample_equal']}")
    for r in ranks:
        # With DeepCache-2 rank 0 runs step 0 (full) and rank 1 step 1 (cache).
        cache = interval and r["rank"] % interval
        per = ((FLASH_PER_CACHE_FORWARD, GN_SILU_PER_CACHE_FORWARD, FRAME_ATTN_PER_CACHE_FORWARD)
               if cache else (FLASH_PER_FORWARD, GN_SILU_PER_FORWARD, FRAME_ATTN_PER_FORWARD))
        expect(f"{what}, rank {r['rank']}: flash at d = 64", r["counts"]["flash"].get(64, 0),
               per[0] * PIPE_FORWARDS_PER_RANK)
        if set(r["counts"]["flash"]) - {64}:
            fail(f"{what}, rank {r['rank']} launched flash at {sorted(r['counts']['flash'])}")
        expect(f"{what}, rank {r['rank']}: GroupNorm+SiLU", r["counts"]["gn"],
               per[1] * PIPE_FORWARDS_PER_RANK)
        expect(f"{what}, rank {r['rank']}: frame attention", r["counts"]["frame"],
               per[2] * PIPE_FORWARDS_PER_RANK)
        if r["handoff_bytes"] != 25 * 72 * 128 * want_ch * 4:
            fail(f"{what}: a {r['handoff_bytes']}-byte hand-off")
    print(f"{what}: the hand-off carries {ranks[0]['handoff_bytes']} bytes a sample "
          f"({ranks[0]['handoff_bytes'] / 1e6:.1f} MB); rank 0's tick-0 send "
          f"{ranks[0]['handoff_s'][0] * 1e3:.3f} ms, its tick-1 send and receive "
          f"{ranks[0]['handoff_s'][1] * 1e3:.3f} ms ({smi})")
    return {"ranks": [{k: v for k, v in r.items() if k != "outputs"} for r in ranks],
            "backend": mesh.backend, "wall_s": wall, "one_stage": one_stage}


def run_deepcache(torch, fa, nk, ta, smi: str) -> dict:
    """Phase (a): full-width SVD-XT, switched, 25 frames at 72x128, CFG 3
    sequential, dpmpp2m x DeepCache-2 at split 1 for DC_STEPS steps (full,
    cache, full, cache) through ``run_reference_single_device``. First the
    full branch of ``apply_cached`` against ``forward`` on the same inputs,
    bit for bit, each forward's launches counted; then the schedule, its
    launches counted; then each kind of step timed alone (CUDA events around
    ``wrapper.step``, 3 calls after a warm-up)."""
    from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    exact_libraries(torch)
    dev = torch.device("cuda:0")
    out = {}
    with kernel_switches(), torch.inference_mode():
        config = SVDUNetConfig.svd_xt()
        wrapper = StableVideoUNet(config, num_steps=DC_STEPS, cfg_mode="sequential",
                                  solver="dpmpp2m", deepcache_interval=DC_INTERVAL, device=dev)
        unet = wrapper.init(torch.Generator(device=dev).manual_seed(0))
        cond = make_dummy_conditioning(torch.Generator(device=dev).manual_seed(1), 1, 25, 72, 128,
                                       cross_dim=config.cross_attention_dim, guidance_scale=3.0)
        g = torch.Generator(device=dev).manual_seed(3)
        x = torch.randn(1, 25, 72, 128, 8, generator=g, device=dev)
        cache0 = torch.zeros(unet.cache_feature_shape(1, 25, 72, 128, 1), dtype=config.dtype,
                             device=dev)
        counts = {}
        for what, fn in (("forward", lambda: unet(x, 0.7, cond.image_embeddings,
                                                     cond.added_time_ids)),
                         ("full", lambda: unet.apply_cached(x, 0.7, cond.image_embeddings,
                                                            cond.added_time_ids, cache0, True)),
                         ("cache", lambda: unet.apply_cached(x, 0.7, cond.image_embeddings,
                                                             cond.added_time_ids, cache, False))):
            reset_counts(fa, nk, ta)
            res = fn()
            torch.cuda.synchronize()
            counts[what] = (fa.launches.total(), nk.launches, ta.launches)
            out[what] = res
            if what == "full":
                cache = res[1]
        equal = bool(torch.equal(out["forward"], out["full"][0]))
        print(f"DeepCache (a): apply_cached(use_full=True) against forward, SVD-XT bf16 switched, "
              f"25 frames at 72x128: equal bit for bit {equal}; cache "
              f"{tuple(out['full'][1].shape)} {out['full'][1].dtype}; launches (flash, "
              f"GroupNorm+SiLU, frame attention) per forward {counts['forward']}, per full "
              f"forward {counts['full']}, per cache forward {counts['cache']}")
        if not equal:
            fail("the full branch of apply_cached differs from forward on the card")
        per_full = (FLASH_PER_FORWARD, GN_SILU_PER_FORWARD, FRAME_ATTN_PER_FORWARD)
        per_cache = (FLASH_PER_CACHE_FORWARD, GN_SILU_PER_CACHE_FORWARD,
                     FRAME_ATTN_PER_CACHE_FORWARD)
        for what, want in (("forward", per_full), ("full", per_full), ("cache", per_cache)):
            for kname, got, n in zip(("flash", "GroupNorm+SiLU", "frame attention"),
                                     counts[what], want):
                expect(f"DeepCache (a): {kname} per {what} forward", got, n)
        if not torch.isfinite(out["cache"][0]).all():
            fail("the cache forward gave non-finite values")
        del out

        noise = torch.randn(1, 1, 25, 72, 128, 4, generator=g, device=dev)
        inputs = wrapper.pack_initial(noise * wrapper.init_noise_sigma)
        step_fn = wrapper.pipeline_step_fn()
        reset_counts(fa, nk, ta)
        final = run_reference_single_device(step_fn, (unet, cond), inputs, DC_STEPS)
        torch.cuda.synchronize()
        sched = {"flash": fa.launches.total(), "gn": nk.launches, "frame": ta.launches}
        full_steps = len(range(0, DC_STEPS, DC_INTERVAL))
        cache_steps = DC_STEPS - full_steps
        for key, i in (("flash", 0), ("gn", 1), ("frame", 2)):
            expect(f"DeepCache (a): {key} over {DC_STEPS} dpmpp2m steps ({full_steps} full, "
                   f"{cache_steps} cache, 2 forwards each)", sched[key],
                   2 * (full_steps * per_full[i] + cache_steps * per_cache[i]))
        lat = wrapper.unpack_final(final)
        print(f"DeepCache (a): payload {tuple(inputs.shape)} fp32 "
              f"({inputs[0].numel() * 4} bytes a sample), output {tuple(lat.shape)}, finite "
              f"{bool(torch.isfinite(lat).all())}")
        if tuple(lat.shape) != (1, 1, 25, 72, 128, 4) or not torch.isfinite(lat).all():
            fail("the DeepCache denoise gave a wrong shape or non-finite values")

        payload = final[0]
        times = {}
        for what, k in (("full", 0), ("cache", 1)):
            step = lambda k=k: wrapper.step(unet, payload, k, cond)  # noqa: E731
            times[what] = time_ms(torch, step, iters=3, warmup=1)
        share = times["cache"] / times["full"]
        print(f"DeepCache (a): one step (2 CFG forwards + the dpmpp2m update): full "
              f"{times['full']:.3f} ms, cache {times['cache']:.3f} ms, cache / full "
              f"{share:.4f} ({smi})")
        del wrapper, unet, cond, inputs, final, payload
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    torch.cuda.empty_cache()
    return {"counts": counts, "schedule": sched, "full_ms": times["full"],
            "cache_ms": times["cache"], "cache_share": share}


def run_mode(main, argv: list[str], what: str, mode: str, ranks: int, smi: str) -> dict:
    """One benchmark mode through its entry point ``main(argv)`` in this
    process (ranks above one are spawned): its one BENCHMARK_JSON line
    parsed and printed, and checked for the contract's keys, the mode, one
    positive allocator peak a rank, and finite positive times."""
    import contextlib
    import io

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    except (Exception, SystemExit) as e:  # noqa: BLE001 (reported, then the script fails)
        fail(f"the benchmark mode {what} failed: {e!r}")
    wall = time.perf_counter() - t0
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("BENCHMARK_JSON=")]
    if rc != 0 or len(lines) != 1:
        fail(f"the benchmark mode {what} returned {rc} with {len(lines)} BENCHMARK_JSON lines")
    print(lines[0], flush=True)
    res = json.loads(lines[0][len("BENCHMARK_JSON="):])
    keys = BENCH_KEYS if mode == "data_parallel" else PIPELINE_KEYS
    times = [res["first_sample_time_s"], res["avg_sample_time_s"],
             res["throughput_samples_per_s"], *res["per_sample_times_ms"]]
    peaks = res["peak_memory_gb_per_rank"]
    print(f"benchmark mode {what}: {res['mode']}, world {res['world_size']}, "
          f"{res['steps_per_gpu']} steps a rank, avg_sample_time_s {res['avg_sample_time_s']}, "
          f"throughput_samples_per_s {res['throughput_samples_per_s']}, first_sample_time_s "
          f"{res['first_sample_time_s']}, peak GB a rank {peaks} ({res['peak_memory_source']}), "
          f"{wall:.1f} s in main ({smi})", flush=True)
    if set(res) != keys:
        fail(f"{what}: BENCHMARK_JSON keys {sorted(res)}, expected {sorted(keys)}")
    if res["mode"] != mode or res["platform"] != "gpu":
        fail(f"{what}: mode {res['mode']} on {res['platform']}, expected {mode} on gpu")
    if res["peak_memory_source"] != "allocator" or len(peaks) != ranks or min(peaks) <= 0:
        fail(f"{what}: peaks {peaks} from {res['peak_memory_source']}, expected {ranks} "
             f"positive allocator peaks")
    if not all(math.isfinite(t) and t > 0 for t in times):
        fail(f"{what}: times {times} are not all finite and positive")
    res["wall_s"] = wall
    return res


def run_benchmark_modes(torch, fa, nk, ta, smi: str) -> dict:
    """Phase 7: the benchmark modes through their entry points at full SVD-XT
    width, switched (``modes.benchmark.main``, ``modes.benchmark_data_parallel
    .main``). (a) One stage in this process, the launch counts set to 0 just
    before and read just after; (b) two stages, ticked and ``--fused``;
    (c) ``--fsdp`` at two ranks and the data-parallel baseline: NCCL on a card
    a rank where there are two, else the ranks sharing cuda:0 over gloo (the
    data-parallel baseline then at one rank, in this process)."""
    from vdpp_tpu_torch.modes import benchmark, benchmark_data_parallel

    two = torch.cuda.device_count() >= 2
    pair = [] if two else ["--devices", "cuda:0", "cuda:0"]
    svd = ["--model", "svd", "--guidance-scale", "3", *BENCH_LATENT]
    out = {}
    torch.cuda.empty_cache()
    with kernel_switches():
        reset_counts(fa, nk, ta)
        out["one_stage"] = run_mode(
            benchmark.main, [*svd, "--num-stages", "1", "--total-steps", str(BENCH_STEPS),
                             "--num-samples", str(BENCH_SAMPLES), "--warmup-samples",
                             str(BENCH_WARMUP)], "(a) 1 stage, ticked", "pipeline", 1, smi)
        counts = {"flash": fa.launches.total(), "gn": nk.launches, "frame": ta.launches}
        expect(f"flash in the benchmark mode (a) ({BENCH_FORWARDS} UNet forwards)",
               counts["flash"], FLASH_PER_FORWARD * BENCH_FORWARDS)
        expect("GroupNorm+SiLU in the benchmark mode (a)", counts["gn"],
               GN_SILU_PER_FORWARD * BENCH_FORWARDS)
        expect("frame attention in the benchmark mode (a)", counts["frame"],
               FRAME_ATTN_PER_FORWARD * BENCH_FORWARDS)
        torch.cuda.empty_cache()
        how = "NCCL, a card a rank" if two else "gloo, the ranks sharing cuda:0"
        two_stages = [*svd, "--num-stages", "2", "--total-steps", "2", *pair]
        out["ticked_2"] = run_mode(benchmark.main, [*two_stages, "--num-samples", "2",
                                                    "--warmup-samples", "1"],
                                   f"(b) 2 stages, ticked ({how})", "pipeline", 2, smi)
        out["fused_2"] = run_mode(benchmark.main, [*two_stages, "--num-samples", "1",
                                                   "--warmup-samples", "1", "--fused"],
                                  f"(b) 2 stages, --fused ({how})", "pipeline", 2, smi)
        out["fsdp_2"] = run_mode(benchmark.main, [*svd, "--fsdp", "--num-stages", "2", *pair,
                                                  "--total-steps", "1", "--num-samples", "1",
                                                  "--warmup-samples", "1"],
                                 f"(c) --fsdp at 2 ranks ({how})", "fsdp", 2, smi)
        n = 2 if two else 1
        out["data_parallel"] = run_mode(
            benchmark_data_parallel.main,
            ["--model", "svd", "--guidance-scale", "3", *BENCH_LATENT, "--num-devices", str(n),
             "--total-steps", "2", "--num-samples", "2"],
            f"(c) data parallel at {n} rank(s)", "data_parallel", n, smi)
    torch.cuda.empty_cache()
    out["counts"] = counts
    return out


@contextlib.contextmanager
def route_counts():
    """Calls that reach each kernel's wrapper through the models' routes
    (``ops/attention.py``'s flash and frame attention, ``ops/normalization.py``'s
    fused GroupNorm+SiLU), counted on any device: on the CPU they take the
    plain versions, on the card every one must launch its kernel."""
    from vdpp_tpu_torch.ops import attention as tattn
    from vdpp_tpu_torch.ops import normalization as tnorm

    calls = {"flash": 0, "frame": 0, "gn": 0}
    sites = ((tattn, "flash_attention", "flash"), (tattn, "frame_attention", "frame"),
             (tnorm, "group_norm_silu_fused", "gn"))
    real = {key: getattr(mod, name) for mod, name, key in sites}

    def counted(key):
        def call(*args, **kwargs):
            calls[key] += 1
            return real[key](*args, **kwargs)
        return call

    for mod, name, key in sites:
        setattr(mod, name, counted(key))
    try:
        yield calls
    finally:
        for mod, name, key in sites:
            setattr(mod, name, real[key])


def check_tiny_models(torch, fa, nk, ta) -> dict:
    """(b) ``SVDUNetConfig.tiny()`` (head dim 16) at TINY_FRAMES frames of a
    16x32 latent, whose level 0 has 512 tokens, and ``DiTVideoConfig.tiny()``
    (factorized, head dim 16) at 8 frames of 32x64 (512 patch tokens a
    frame): a forward and one CFG Euler step on the card against the same
    weights and inputs on the CPU, in each of TINY_SETTINGS. The head dim
    takes the generic flash and frame-attention kernels. The launch counts
    are set to 0 before and read after each card run, and must equal the
    calls that reached the kernel routes (counted the same way on the CPU),
    every flash launch at d = 16. Returns the card's counts by model and
    setting."""
    import dataclasses

    from vdpp_tpu_torch.models.dit import DiTVideo, DiTVideoConfig, DiTVideoWrapper
    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import (
        StableVideoUNet,
        make_dummy_conditioning,
        make_guidance_ramp,
    )
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    g = torch.Generator().manual_seed(20)
    svd_state = SVDUNet(SVDUNetConfig.tiny(), device="cpu").init_weights(g).state_dict()
    cond = make_dummy_conditioning(g, 1, TINY_FRAMES, 16, 32, cross_dim=48, guidance_scale=3.0)
    svd_x = torch.randn(1, 1, TINY_FRAMES, 16, 32, 4, generator=g)
    dit_cfg = DiTVideoConfig.tiny()
    dit_state = DiTVideo(dit_cfg, device="cpu").init_weights(g).state_dict()
    dit_lat = torch.randn(1, 8, 32, 64, 4, generator=g)
    dit_ctx = torch.randn(1, 7, dit_cfg.cross_attention_dim, generator=g)

    def svd_run(dev):
        wrapper = StableVideoUNet(SVDUNetConfig.tiny(), num_steps=4, device=dev)
        unet = SVDUNet(wrapper.config, device=dev)
        unet.load_state_dict(svd_state)
        c = dataclasses.replace(cond, **{f.name: getattr(cond, f.name).to(dev)
                                         for f in dataclasses.fields(cond)})
        xd = (svd_x * wrapper.init_noise_sigma).to(dev)
        lat = torch.cat([xd[0], c.image_latents], dim=-1)
        fwd = unet(lat, 0.5, c.image_embeddings, c.added_time_ids)
        step = run_reference_single_device(wrapper.pipeline_step_fn(), (unet, c), xd, 1)
        return fwd, step

    def dit_run(dev):
        wrapper = DiTVideoWrapper(dit_cfg, num_steps=4, device=dev)
        dit = DiTVideo(dit_cfg, device=dev)
        dit.load_state_dict(dit_state)
        bundle = (dit, dit_ctx.to(dev), make_guidance_ramp(6.0, 8, device=dev))
        fwd = dit(dit_lat.to(dev), 0.3, dit_ctx.to(dev))
        step = run_reference_single_device(wrapper.pipeline_step_fn(), bundle,
                                           (dit_lat * wrapper.init_noise_sigma).to(dev)[None], 1)
        return fwd, step

    counts = {}
    for model, run in (("svd_tiny", svd_run), ("dit_tiny", dit_run)):
        cpu_outs = {}
        for setting, switches in TINY_SETTINGS:
            outs, routes = {}, {}
            with kernel_switches(switches), route_counts() as calls:
                for dev in ("cpu", "cuda"):
                    for key in calls:
                        calls[key] = 0
                    reset_counts(fa, nk, ta)
                    fa.exp_bf16_launches.clear()
                    with torch.inference_mode():
                        outs[dev] = [t.cpu() for t in run(dev)]
                    routes[dev] = dict(calls)
            got = {"flash": fa.launches.total(), "flash_d16": fa.launches[16],
                   "flash_exp_bf16": fa.exp_bf16_launches.total(), "gn": nk.launches,
                   "frame": ta.launches}
            what = f"{model} {setting}"
            print(f"tiny {what}: routes on the CPU {routes['cpu']}, on the card "
                  f"{routes['cuda']}; card launches {got}", flush=True)
            if routes["cpu"] != routes["cuda"]:
                fail(f"tiny {what}: the CPU and the card took other routes")
            expect(f"tiny {what}: flash at d = 16", got["flash_d16"], routes["cuda"]["flash"])
            expect(f"tiny {what}: flash", got["flash"], routes["cuda"]["flash"])
            expect(f"tiny {what}: GroupNorm+SiLU", got["gn"], routes["cuda"]["gn"])
            expect(f"tiny {what}: frame attention", got["frame"], routes["cuda"]["frame"])
            expect(f"tiny {what}: flash with the bf16 exponent", got["flash_exp_bf16"],
                   got["flash"] if "VDPP_FLASH_EXP" in switches else 0)
            if not got["flash"] or (switches and not got["frame"]):
                fail(f"tiny {what}: the generic kernels did not run: {got}")
            cpu_outs[setting] = outs["cpu"]
            for name, i in (("forward", 0), ("CFG Euler step", 1)):
                ref = outs["cpu"][i]
                rel = ((outs["cuda"][i] - ref).abs().max() / ref.abs().max()).item()
                effect = ""
                if setting == TINY_EXP:
                    off = cpu_outs["switched"][i]
                    effect = (f"; the flag's own effect on the CPU "
                              f"{((ref - off).abs().max() / off.abs().max()).item():.3g}")
                print(f"agreement card vs CPU, tiny {what} ({name}): max|diff|/max|ref| "
                      f"{rel:.3g} (tolerance {TINY_TOL}){effect}", flush=True)
                if not math.isfinite(rel) or rel > TINY_TOL:
                    fail(f"card and CPU disagree on tiny {what} ({name}): {rel}")
            counts[what] = got
    return counts


def production_rank(stage, tmpdir: str) -> dict:
    """One rank of phase (c)'s API-level group: for each of PROD_SOLVERS, the
    production path's pieces at its default shape (SVD-XT from seed 0, the
    conditioning from seed 1, PROD_SAMPLES noise draws x init_noise_sigma
    from seed 2, packed) through ``run_ticked`` three times: uncut, again
    snapshotting after tick PROD_SNAP_TICK, and resumed from that file. The
    launch counts are set to 0 before and read after each run; the last rank
    returns the outputs, the tick seconds and the snapshot's bytes and write
    seconds."""
    import torch

    from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning
    from vdpp_tpu_torch.ops import flash_attention as fa
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils import kernels
    from vdpp_tpu_torch.utils.resume import load_pipeline_state, save_pipeline_state

    exact_libraries(torch)
    dev = stage.device
    config = SVDUNetConfig.svd_xt()
    b, _, f, h, w = (int(v) for v in PROD_LATENT)
    out = {"rank": stage.rank}
    unet = None
    for solver in PROD_SOLVERS:
        wrapper = StableVideoUNet(config, num_steps=PROD_STEPS, solver=solver, device=dev)
        if unet is None:
            unet = wrapper.init(torch.Generator(device=dev).manual_seed(0))
        cond = make_dummy_conditioning(torch.Generator(device=dev).manual_seed(1), b, f, h, w,
                                       cross_dim=config.cross_attention_dim, guidance_scale=3.0)
        noise = torch.randn(PROD_SAMPLES, b, f, h, w, 4, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(2))
        inputs = wrapper.pack_initial(noise * wrapper.init_noise_sigma)
        pipe = StepPipeline(stage, wrapper.pipeline_step_fn(),
                            PipelineConfig(PROD_STEPS, stage.num_stages))
        path = os.path.join(tmpdir, f"{solver}.npz")
        writes = []

        def on_tick(t, buf, path=path, writes=writes, pipe=pipe, solver=solver):
            if t == PROD_SNAP_TICK:
                t0 = time.perf_counter()
                save_pipeline_state(path, t, buf, meta={"solver": solver})
                writes.append({"seconds": time.perf_counter() - t0,
                               "bytes": os.path.getsize(path), "slots": buf.shape[0],
                               "gather_seconds": pipe.gather_seconds[-1]})

        runs = {}
        for name in ("full", "snapshot", "resumed"):
            kw = {}
            if name == "snapshot":
                kw = {"on_tick": on_tick, "on_tick_every": 1}
            elif name == "resumed":
                tick, buf, _ = load_pipeline_state(path)
                kw = {"start_tick": tick + 1, "initial_buf": buf}
            reset_counts(fa, nk, ta)
            res = pipe.run_ticked((unet, cond), inputs, **kw)
            runs[name] = {"counts": {"flash": dict(fa.launches), "gn": nk.launches,
                                     "frame": ta.launches}}
            if res is not None:
                runs[name].update(outputs=res[0].cpu(), ticks=res[1])
        out[solver] = {"runs": runs, "writes": writes}
    out["variants"] = kernels.variant_launches()
    return out


def run_production(torch, fa, nk, ta, smi: str) -> dict:
    """(c) The production mode. First as its entry point
    ``modes.production.main`` runs it (parse the flags, set up logging,
    ``run``), keeping ``run``'s result: SVD-XT at its default latent (1, 4, 14, 40,
    72), CFG 3, PROD_STEPS steps, PROD_SAMPLES samples, 2 ranks sharing
    cuda:0 over gloo, ``--ticked --state-path ... --state-every 1``: the
    outputs finite, each rank's flash launches at d = 64 those of its
    forwards, a snapshot after every tick, the last one read back. Then one
    spawned group at the API level (``production_rank``) with euler and
    dpmpp2m: the resumed run's samples bit-equal to the uncut run's."""
    import tempfile

    from vdpp_tpu_torch.modes import production
    from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
    from vdpp_tpu_torch.utils.logging import setup_logging
    from vdpp_tpu_torch.utils.resume import load_pipeline_state

    devices = ["cuda:0"] * PROD_STAGES
    want_flash = PROD_FLASH_PER_FORWARD * PROD_FORWARDS_PER_RANK
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_production_") as tmp:
        state = os.path.join(tmp, "state.npz")
        argv = ["--latent-shape", *PROD_LATENT, "--guidance-scale", "3", "--total-steps",
                str(PROD_STEPS), "--num-samples", str(PROD_SAMPLES), "--devices", *devices,
                "--ticked", "--state-path", state, "--state-every", "1"]
        # What production.main does, keeping run's result.
        args = production.build_parser().parse_args(argv)
        setup_logging(args.log_level)
        t0 = time.perf_counter()
        result = production.run(args)
        wall = time.perf_counter() - t0
        spawned(result["launches"])
        tick, buf, meta = load_pipeline_state(state)
        what = (f"production (SVD-XT bf16, latent {'x'.join(PROD_LATENT)}, CFG 3, "
                f"{PROD_STEPS} Euler steps, {PROD_SAMPLES} samples, {PROD_STAGES} ranks on "
                f"cuda:0 over gloo, --ticked --state-every 1)")
        out = result["out"]
        print(f"{what}: {wall:.3f} s with the spawned ranks, output "
              f"{tuple(out.shape)}, finite {bool(torch.isfinite(out).all())}, tick seconds "
              f"{[round(t, 4) for t in result['ticks']]} ({smi})", flush=True)
        for snap in result["snapshots"]:
            print(f"{what}: snapshot after tick {snap['tick']}: {snap['bytes']} bytes "
                  f"({snap['bytes'] / PROD_STAGES / 1e6:.3f} MB a slot) gathered in "
                  f"{snap['gather_seconds'] * 1e3:.3f} ms, written in "
                  f"{snap['seconds'] * 1e3:.3f} ms ({smi})", flush=True)
        b, _, f, h, w = (int(v) for v in PROD_LATENT)
        want_shape = (PROD_SAMPLES, b, f, h, w, 4)
        if tuple(out.shape) != want_shape or not torch.isfinite(out).all():
            fail(f"{what} gave {tuple(out.shape)} or non-finite values")
        n_ticks = PROD_SAMPLES + PROD_STAGES - 1
        if len(result["ticks"]) != n_ticks or [s["tick"] for s in result["snapshots"]] != \
                list(range(n_ticks)):
            fail(f"{what}: {len(result['ticks'])} ticks, snapshots {result['snapshots']}")
        if tick != n_ticks - 1 or tuple(buf.shape) != (PROD_STAGES, *want_shape[1:]) or \
                len(meta) != 15:
            fail(f"{what}: the last snapshot holds tick {tick}, {tuple(buf.shape)}, "
                 f"{len(meta)} keys")
        for r, counts in enumerate(result["launches"]):
            expect(f"{what}, rank {r}: flash at d = 64", counts["flash"].get(64, 0), want_flash)
            if set(counts["flash"]) - {64} or counts["group_norm_silu"] or \
                    counts["frame_attention"]:
                fail(f"{what}, rank {r} launched {counts}")
        main_run = {"wall_s": wall, "ticks": result["ticks"], "snapshots": result["snapshots"],
                    "launches": result["launches"]}

        mesh = make_pipeline_mesh(devices=devices)
        t0 = time.perf_counter()
        try:
            ranks = spawned(run_stages(mesh, production_rank, tmp, timeout=900))
        except (RuntimeError, TimeoutError) as e:
            fail(f"the production API-level group failed: {e}")
        wall_api = time.perf_counter() - t0
    last = ranks[-1]
    already = PROD_SNAP_TICK + 1 - (PROD_STAGES - 1)
    api = {"wall_s": wall_api}
    for solver in PROD_SOLVERS:
        runs = last[solver]["runs"]
        full, rest = runs["full"]["outputs"], runs["resumed"]["outputs"]
        equal = same_bits(torch, rest, full[already:])
        snap_equal = same_bits(torch, runs["snapshot"]["outputs"], full)
        write = last[solver]["writes"][0]
        name = f"production {solver} ({PROD_STAGES} ranks on cuda:0 over gloo, run_ticked)"
        print(f"{name}: uncut ticks {[round(t, 4) for t in runs['full']['ticks']]}, "
              f"snapshotting ticks {[round(t, 4) for t in runs['snapshot']['ticks']]}, "
              f"resumed at tick {PROD_SNAP_TICK + 1}: ticks "
              f"{[round(t, 4) for t in runs['resumed']['ticks']]}; snapshot after tick "
              f"{PROD_SNAP_TICK}: {write['bytes']} bytes ("
              f"{write['bytes'] / write['slots'] / 1e6:.3f} MB a slot) gathered in "
              f"{write['gather_seconds'] * 1e3:.3f} ms, written in "
              f"{write['seconds'] * 1e3:.3f} ms; resumed samples "
              f"{already}..{PROD_SAMPLES - 1} equal bit for bit to the uncut run's {equal}, "
              f"snapshotting run equal to the uncut one {snap_equal} ({smi})", flush=True)
        if not (equal and snap_equal) or tuple(rest.shape)[0] != PROD_SAMPLES - already:
            fail(f"{name}: the resumed samples differ from the uncut run's")
        for r in ranks:
            counts = r[solver]["runs"]["full"]["counts"]
            expect(f"{name}, rank {r['rank']}: flash at d = 64 (uncut)",
                   counts["flash"].get(64, 0), want_flash)
        api[solver] = {"ticks": {k: v["ticks"] for k, v in runs.items()}, "write": write,
                       "launches": {f"rank{r['rank']}": {k: v["counts"]
                                                         for k, v in r[solver]["runs"].items()}
                                    for r in ranks}}
    return {"main": main_run, "api": api}


def intra_case(torch, device):
    """What phase 9's ranks and its one-process run build alike on
    ``device``: the wrapper (SVD-XT bf16, INTRA_STEPS Euler steps, CFG
    sequential), the UNet from seed 0, random conditioning for INTRA_FRAMES
    frames of 72x128 with a CFG ramp to 3, and one noise draw."""
    from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
    from vdpp_tpu_torch.models.svd_wrapper import StableVideoUNet, make_dummy_conditioning

    config = SVDUNetConfig.svd_xt()
    wrapper = StableVideoUNet(config, num_steps=INTRA_STEPS, cfg_mode="sequential",
                              device=device)
    unet = wrapper.init(torch.Generator(device=device).manual_seed(0))
    cond = make_dummy_conditioning(torch.Generator(device=device).manual_seed(1), 1,
                                   INTRA_FRAMES, 72, 128, cross_dim=config.cross_attention_dim,
                                   guidance_scale=3.0)
    noise = torch.randn(1, 1, INTRA_FRAMES, 72, 128, 4, device=device,
                        generator=torch.Generator(device=device).manual_seed(2))
    return wrapper, (unet, cond), noise * wrapper.init_noise_sigma


def intra_rank(stage, cases) -> dict:
    """One rank of phase 9: each ``(name, axes)`` of ``cases`` on this group
    laid out with those inner axes (``seq``, ``frame``, ``cfg``; the stage
    count follows), through ``StepPipeline.run``. For each run the launch
    counts, the frame-attention fallbacks and the collectives' counts are
    set to 0 just before and read just after; flash's (Lq, Lk) are recorded.
    The mesh's last rank also returns the outputs."""
    import collections
    import dataclasses

    import torch

    from vdpp_tpu_torch.ops import attention
    from vdpp_tpu_torch.ops import flash_attention as fa
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.parallel import collectives
    from vdpp_tpu_torch.parallel.mesh import Stage
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils import kernels

    exact_libraries(torch)
    wrapper, params, inputs = intra_case(torch, stage.device)
    shapes = collections.Counter()
    flash = attention.flash_attention

    def recorded(q, k, v, *args, **kw):
        shapes[f"{q.shape[1]},{k.shape[1]}"] += 1
        return flash(q, k, v, *args, **kw)

    attention.flash_attention = recorded
    out = {"rank": stage.rank, "device": str(stage.device)}
    for name, axes in cases:
        st = Stage(dataclasses.replace(stage.mesh, **{"seq": 1, "frame": 1, "cfg": 1, **axes}),
                   stage.rank)
        pipe = StepPipeline(st, wrapper.pipeline_step_fn(**st.axes),
                            PipelineConfig(INTRA_STEPS, st.num_stages))
        torch.cuda.synchronize(stage.device)
        torch.cuda.reset_peak_memory_stats(stage.device)
        reset_counts(fa, nk, ta)
        attention.frame_axis_fallbacks = 0
        collectives.clear_counts()
        shapes.clear()
        t0 = time.perf_counter()
        res = pipe.run(params, inputs)
        torch.cuda.synchronize(stage.device)
        seconds = time.perf_counter() - t0
        out[name] = {
            "seconds": seconds, "stage": st.index, "stages": st.num_stages,
            "counts": {"flash": dict(fa.launches), "gn": nk.launches, "frame": ta.launches,
                       "fallbacks": attention.frame_axis_fallbacks,
                       "flash_shapes": dict(shapes)},
            "collectives": dict(collectives.counts), "bytes": dict(collectives.nbytes),
            "peak": torch.cuda.max_memory_allocated(stage.device),
            "outputs": res.cpu() if res is not None and st.is_last_rank else None}
    out["variants"] = kernels.variant_launches()
    return out


def run_intra_sample(torch, smi: str) -> dict:
    """Phase 9, intra-sample parallelism at full width: the one-process run
    of INTRA_STEPS steps on cuda:0; (a) 2 ranks sharing cuda:0 over gloo, in
    turn seq 2, frame 2 and cfg 2; (b) 4 ranks (NCCL with four cards, else
    sharing cuda:0 over gloo), stage 2 x seq 2 and stage 2 x cfg 2, each
    bit-equal to (a)'s run of the same axis; (c) the image->video app with
    ``--seq-parallel 2 --num-stages 1``, whose files must hold 14 frames of
    1024x576. cfg 2 must equal the one-process run bit for bit, seq 2 and
    frame 2 within INTRA_TOL; every rank's launches must match
    INTRA_PER_FORWARD. All with VDPP_TEMPORAL_ATTN=pallas."""
    import shutil
    import tempfile

    from vdpp_tpu_torch.apps import generate_video
    from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.cuda.empty_cache()
    out: dict = {}
    with kernel_switches(TEMPORAL_SWITCH):
        exact_libraries(torch)
        wrapper, params, inputs = intra_case(torch, torch.device("cuda:0"))
        run_reference_single_device(wrapper.pipeline_step_fn(), params, inputs, 1)  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = run_reference_single_device(wrapper.pipeline_step_fn(), params, inputs,
                                          INTRA_STEPS)
        torch.cuda.synchronize()
        out["one_process_s"] = time.perf_counter() - t0
        ref = ref.cpu()
        del wrapper, params, inputs
        torch.cuda.empty_cache()
        four = torch.cuda.device_count() >= 4
        meshes = {"a": (make_pipeline_mesh(devices=["cuda:0"] * 2),
                        [("seq2", {"seq": 2}), ("frame2", {"frame": 2}), ("cfg2", {"cfg": 2})]),
                  "b": (make_pipeline_mesh(4, device="cuda") if four
                        else make_pipeline_mesh(devices=["cuda:0"] * 4),
                        [("stage2_seq2", {"seq": 2}), ("stage2_cfg2", {"cfg": 2})])}
        for part, (mesh, cases) in meshes.items():
            t0 = time.perf_counter()
            try:
                out[part] = spawned(run_stages(mesh, intra_rank, cases, timeout=900))
            except (RuntimeError, TimeoutError) as e:
                fail(f"phase 9 ({part}) failed: {e}")
            out[part + "_wall_s"] = time.perf_counter() - t0
            out[part + "_backend"] = mesh.backend
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved

    ref_max = ref.abs().max().item()
    print(f"intra-sample: one-process run, SVD-XT bf16, {INTRA_FRAMES} frames at 72x128, CFG 3 "
          f"sequential, {INTRA_STEPS} Euler steps, VDPP_TEMPORAL_ATTN=pallas: "
          f"{out['one_process_s']:.3f} s, max|latent| {ref_max:.4g} ({smi})", flush=True)
    results, a_outputs = {}, {}
    for part, (_, cases) in meshes.items():
        ranks = out[part]
        how = (f"{len(ranks)} ranks, {out[part + '_backend']}"
               + (", sharing cuda:0" if out[part + "_backend"] == "gloo" else ""))
        for name, _ in cases:
            base = name.replace("stage2_", "")
            flash_n, frame_n, fallback_n, per_step = INTRA_PER_FORWARD[base]
            got = ranks[-1][name]["outputs"]
            err = (got - ref).abs().max().item()
            if base == "cfg2":
                ok = torch.equal(got, ref)
            else:
                ok = math.isfinite(err) and err <= INTRA_TOL * ref_max
            equal_a = None if part == "a" else torch.equal(got, a_outputs[base])
            print(f"intra-sample {name} ({how}): {ranks[-1][name]['seconds']:.3f} s on the last "
                  f"rank, output {tuple(got.shape)}, max|diff| to the one-process run {err:.4g} "
                  f"({err / ref_max:.3g} of max|latent|; "
                  + ("bit for bit " if base == "cfg2" else f"limit {INTRA_TOL} x max, ")
                  + f"equal {torch.equal(got, ref)})"
                  + ("" if equal_a is None else f", bit-equal to (a)'s {base} {equal_a}")
                  + f" ({smi})", flush=True)
            if not ok or (equal_a is False) or not torch.isfinite(got).all():
                fail(f"intra-sample {name} ({how}) disagrees: max|diff| {err}, equal to (a) "
                     f"{equal_a}")
            for r in ranks:
                res = r[name]
                forwards = per_step * INTRA_STEPS // res["stages"]
                c = res["counts"]
                print(f"intra-sample {name}, rank {r['rank']} (stage {res['stage']}): launches "
                      f"{ {k: v for k, v in c.items() if k != 'flash_shapes'} }, flash (Lq, Lk) "
                      f"{c['flash_shapes']}, collectives {res['collectives']}, bytes "
                      f"{res['bytes']}, peak allocated {res['peak'] / 2**30:.2f} GiB ({smi})")
                expect(f"intra-sample {name}, rank {r['rank']}: flash at d = 64",
                       c["flash"].get(64, 0), flash_n * forwards)
                expect(f"intra-sample {name}, rank {r['rank']}: frame attention", c["frame"],
                       frame_n * forwards)
                expect(f"intra-sample {name}, rank {r['rank']}: frame-attention fallbacks",
                       c["fallbacks"], fallback_n * forwards)
                if base == "seq2" and c["flash_shapes"] != {
                        f"{lq},{lk}": n * forwards for (lq, lk), n in INTRA_SEQ2_SHAPES.items()}:
                    fail(f"intra-sample {name}: flash at {c['flash_shapes']}")
            if part == "a":
                a_outputs[base] = got
            results[name] = {
                "seconds": ranks[-1][name]["seconds"], "max_abs_err": err,
                "rel_err": err / ref_max, "backend": out[part + "_backend"],
                "per_rank": [{"launches": r[name]["counts"], "collectives": r[name]["collectives"],
                              "bytes": r[name]["bytes"], "peak_gb": r[name]["peak"] / 2**30}
                             for r in ranks]}

    # (c) The image->video app at full width over 2 seq ranks on one card.
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_intra_app_")
    try:
        t0 = time.perf_counter()
        with kernel_switches(TEMPORAL_SWITCH):
            rc = generate_video.main(["--random-weights", "--steps", str(APP_STEPS),
                                      "--seq-parallel", "2", "--num-stages", "1", "--devices",
                                      "cuda:0", "cuda:0", "--output-dir", out_dir])
        wall = time.perf_counter() - t0
        files = {os.path.splitext(n)[1]: os.path.join(out_dir, n) for n in os.listdir(out_dir)}
        if rc != 0 or ".y4m" not in files or ".gif" not in files:
            fail(f"the image->video app with --seq-parallel 2 returned {rc}, wrote "
                 f"{sorted(files)}")
        video, gif = y4m_frames(files[".y4m"]), gif_frames(files[".gif"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    want = (APP_FRAMES, APP_W, APP_H)
    print(f"image->video app --seq-parallel 2 (2 ranks sharing cuda:0 over gloo): y4m {video}, "
          f"gif {gif} (expected {want}), {wall:.3f} s in main ({smi})", flush=True)
    if video != want or gif != want:
        fail(f"the app with --seq-parallel 2 wrote y4m {video} and gif {gif}, expected {want}")
    results["app_seq2"] = {"wall_s": wall, "y4m": video}
    results["one_process_s"] = out["one_process_s"]
    results["walls"] = {p: out[p + "_wall_s"] for p in meshes}
    return results


def dit_intra_case(torch, device, mode: str):
    """What phase 10's ranks and its one-process runs build alike on
    ``device``: the wrapper (DiT-XL bf16 in ``mode``, T5-XXL's cross width,
    STEPS Euler steps), the DiT from seed 1, a random context of
    DIT_CTX_TOKENS tokens from seed 3 with a CFG ramp to 6 over DIT_FRAMES
    frames, and one noise draw of DIT_FRAMES x DIT_LAT from seed 2."""
    from vdpp_tpu_torch.models.dit import DiTVideoConfig, DiTVideoWrapper
    from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp

    config = dataclasses.replace(DiTVideoConfig.latte_xl(), cross_attention_dim=4096,
                                 attention_mode=mode)
    wrapper = DiTVideoWrapper(config, num_steps=STEPS, device=device)
    dit = wrapper.init(torch.Generator(device=device).manual_seed(1))
    ctx = torch.randn(1, DIT_CTX_TOKENS, 4096, device=device,
                      generator=torch.Generator(device=device).manual_seed(3))
    noise = torch.randn(1, 1, DIT_FRAMES, *DIT_LAT, config.in_channels, device=device,
                        generator=torch.Generator(device=device).manual_seed(2))
    bundle = (dit, ctx, make_guidance_ramp(6.0, DIT_FRAMES, device=device))
    return wrapper, bundle, noise * wrapper.init_noise_sigma


def dit_intra_rank(stage, cases) -> dict:
    """One rank of phase 10: each name of ``cases`` (keys of DIT_INTRA) on this
    group laid out with its inner axes (the stage count follows), through
    ``StepPipeline.run``, the factorized ones with VDPP_TEMPORAL_ATTN=pallas.
    For each run the launch counts and the collectives' counts are set to 0
    just before and read just after; flash's (Lq, Lk) are recorded. The
    mesh's last rank also returns the outputs."""
    import collections

    import torch

    from vdpp_tpu_torch.ops import attention
    from vdpp_tpu_torch.ops import flash_attention as fa
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.parallel import collectives
    from vdpp_tpu_torch.parallel.mesh import Stage
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils import kernels

    exact_libraries(torch)
    shapes = collections.Counter()
    flash = attention.flash_attention

    def recorded(q, k, v, *args, **kw):
        shapes[f"{q.shape[1]},{k.shape[1]}"] += 1
        return flash(q, k, v, *args, **kw)

    attention.flash_attention = recorded
    out = {"rank": stage.rank, "device": str(stage.device)}
    built = {}
    for name in cases:
        mode, axes = DIT_INTRA[name][:2]
        if mode not in built:
            built.clear()  # one DiT-XL at a time
            torch.cuda.empty_cache()
            built[mode] = dit_intra_case(torch, stage.device, mode)
        wrapper, params, inputs = built[mode]
        st = Stage(dataclasses.replace(stage.mesh, **{"seq": 1, "frame": 1, "cfg": 1, **axes}),
                   stage.rank)
        pipe = StepPipeline(st, wrapper.pipeline_step_fn(**st.axes),
                            PipelineConfig(STEPS, st.num_stages))
        with kernel_switches(TEMPORAL_SWITCH if mode == "factorized" else {}):
            torch.cuda.synchronize(stage.device)
            torch.cuda.reset_peak_memory_stats(stage.device)
            reset_counts(fa, nk, ta)
            collectives.clear_counts()
            shapes.clear()
            t0 = time.perf_counter()
            res = pipe.run(params, inputs)
            torch.cuda.synchronize(stage.device)
            seconds = time.perf_counter() - t0
        out[name] = {
            "seconds": seconds, "stage": st.index, "stages": st.num_stages,
            "counts": {"flash": dict(fa.launches), "frame": ta.launches,
                       "flash_shapes": dict(shapes)},
            "collectives": dict(collectives.counts), "bytes": dict(collectives.nbytes),
            "peak": torch.cuda.max_memory_allocated(stage.device),
            "outputs": res.cpu() if res is not None and st.is_last_rank else None}
    out["variants"] = kernels.variant_launches()
    return out


def run_dit_intra(torch, smi: str) -> dict:
    """Phase 10 (a)-(b): the DiT's seq and cfg axes at DiT-XL width. The
    one-process runs of STEPS steps on cuda:0 (joint3d; factorized with
    VDPP_TEMPORAL_ATTN=pallas); (a) 2 ranks sharing cuda:0 over gloo: joint3d
    seq 2, joint3d cfg 2, factorized seq 2; (b) 4 ranks (NCCL with four
    cards, else cuda:0 over gloo): stage 2 x seq 2 and stage 2 x cfg 2, each
    bit-equal to (a)'s run of the same axis, and seq 2 x cfg 2. cfg runs
    must equal the one-process run bit for bit, seq runs lie within
    INTRA_TOL; every rank's launches must match DIT_INTRA."""
    from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    torch.cuda.empty_cache()
    refs, out = {}, {}
    exact_libraries(torch)
    for mode in ("joint3d", "factorized"):
        with kernel_switches(TEMPORAL_SWITCH if mode == "factorized" else {}):
            wrapper, params, inputs = dit_intra_case(torch, torch.device("cuda:0"), mode)
            run_reference_single_device(wrapper.pipeline_step_fn(), params, inputs, 1)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            refs[mode] = run_reference_single_device(wrapper.pipeline_step_fn(), params, inputs,
                                                     STEPS).cpu()
            torch.cuda.synchronize()
            out[f"one_process_{mode}_s"] = time.perf_counter() - t0
        del wrapper, params, inputs
        torch.cuda.empty_cache()
    four = torch.cuda.device_count() >= 4
    meshes = {"a": (make_pipeline_mesh(devices=["cuda:0"] * 2),
                    ["joint3d_seq2", "joint3d_cfg2", "factorized_seq2"]),
              "b": (make_pipeline_mesh(4, device="cuda") if four
                    else make_pipeline_mesh(devices=["cuda:0"] * 4),
                    ["joint3d_stage2_seq2", "joint3d_stage2_cfg2", "joint3d_seq2_cfg2"])}
    for part, (mesh, cases) in meshes.items():
        t0 = time.perf_counter()
        try:
            out[part] = spawned(run_stages(mesh, dit_intra_rank, cases, timeout=900))
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 10 ({part}) failed: {e}")
        out[part + "_wall_s"] = time.perf_counter() - t0
        out[part + "_backend"] = mesh.backend
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved

    for mode, ref in refs.items():
        print(f"DiT intra-sample: one-process run, DiT-XL {mode} bf16, {DIT_FRAMES} frames at "
              f"{DIT_LAT[0]}x{DIT_LAT[1]}, CFG ramp to 6 sequential, {STEPS} Euler steps"
              + (", VDPP_TEMPORAL_ATTN=pallas" if mode == "factorized" else "")
              + f": {out[f'one_process_{mode}_s']:.3f} s, max|latent| "
              f"{ref.abs().max().item():.4g} ({smi})", flush=True)
    results, a_outputs = {}, {}
    for part, (_, cases) in meshes.items():
        ranks = out[part]
        how = (f"{len(ranks)} ranks, {out[part + '_backend']}"
               + (", sharing cuda:0" if out[part + "_backend"] == "gloo" else ""))
        for name in cases:
            mode, axes, flash_n, flash_shape, frame_n, per_step = DIT_INTRA[name]
            ref = refs[mode]
            ref_max = ref.abs().max().item()
            got = ranks[-1][name]["outputs"]
            err = (got - ref).abs().max().item()
            exact = "seq" not in axes
            ok = torch.equal(got, ref) if exact else (math.isfinite(err)
                                                      and err <= INTRA_TOL * ref_max)
            base = name.replace("stage2_", "")
            equal_a = None if part == "a" or base not in a_outputs else torch.equal(
                got, a_outputs[base])
            print(f"DiT intra-sample {name} ({how}): {ranks[-1][name]['seconds']:.3f} s on the "
                  f"last rank, output {tuple(got.shape)}, max|diff| to the one-process run "
                  f"{err:.4g} ({err / ref_max:.3g} of max|latent|; "
                  + ("bit for bit " if exact else f"limit {INTRA_TOL} x max, ")
                  + f"equal {torch.equal(got, ref)})"
                  + ("" if equal_a is None else f", bit-equal to (a)'s {base} {equal_a}")
                  + f" ({smi})", flush=True)
            if not ok or equal_a is False or not torch.isfinite(got).all():
                fail(f"DiT intra-sample {name} ({how}) disagrees: max|diff| {err}, equal to "
                     f"(a) {equal_a}")
            for r in ranks:
                res = r[name]
                forwards = per_step * STEPS // res["stages"]
                c = res["counts"]
                per_fwd = {k: v / forwards for k, v in res["collectives"].items()}
                bytes_fwd = {k: v / forwards for k, v in res["bytes"].items()}
                print(f"DiT intra-sample {name}, rank {r['rank']} (stage {res['stage']}): "
                      f"launches flash {c['flash']}, frame attention {c['frame']}, flash "
                      f"(Lq, Lk) {c['flash_shapes']}; collectives a forward {per_fwd}, bytes a "
                      f"forward {bytes_fwd}; peak allocated {res['peak'] / 2**30:.2f} GiB "
                      f"({smi})")
                expect(f"DiT intra-sample {name}, rank {r['rank']}: flash at d = 72",
                       c["flash"].get(72, 0), flash_n * forwards)
                expect(f"DiT intra-sample {name}, rank {r['rank']}: frame attention",
                       c["frame"], frame_n * forwards)
                want_shapes = ({} if flash_shape is None else
                               {"{},{}".format(*flash_shape): flash_n * forwards})
                if c["flash_shapes"] != want_shapes or set(c["flash"]) - {72}:
                    fail(f"DiT intra-sample {name}: flash at {c['flash_shapes']}, head dims "
                         f"{sorted(c['flash'])}")
                if name == "joint3d_seq2" and per_fwd.get("all_gather") != DIT_SEQ2_GATHERS:
                    fail(f"DiT intra-sample {name}: {per_fwd} collectives a forward, expected "
                         f"{DIT_SEQ2_GATHERS} gathers")
            if part == "a":
                a_outputs[base] = got
            results[name] = {
                "seconds": ranks[-1][name]["seconds"], "max_abs_err": err,
                "rel_err": err / ref_max, "backend": out[part + "_backend"],
                "per_rank": [{"launches": r[name]["counts"], "collectives": r[name]["collectives"],
                              "bytes": r[name]["bytes"], "peak_gb": r[name]["peak"] / 2**30}
                             for r in ranks]}
    results["one_process_s"] = {m: out[f"one_process_{m}_s"] for m in refs}
    results["walls"] = {p: out[p + "_wall_s"] for p in meshes}
    return results


def app_files(out_dir: str) -> dict:
    """``{(seed tag, extension): bytes}`` of an app's output directory (the
    names carry a time stamp and the stage count; the seed tells the samples
    apart)."""
    files = {}
    for n in os.listdir(out_dir):
        with open(os.path.join(out_dir, n), "rb") as f:
            files[n.split("_seed")[1]] = f.read()
    return files


def run_dit_intra_apps(torch, smi: str) -> dict:
    """Phase 10 (c)-(e), through the entry points: (c) the text->video app
    with --seq-parallel 2 on two ranks sharing cuda:0, whose files must hold
    8 frames of 512x320; (d) the production mode with --auto-topology latency
    on two ranks sharing cuda:0 at SVD-XT width (its default latent, CFG 3,
    STEPS steps): the plan it chose, the runner-ups, and its samples bit-equal
    to the run with the chosen flags given; (e) the image->video app with a
    stage rank and a decode rank on cuda:0 (--decode-devices 1,
    DECODE_SAMPLES samples), then with no decode rank in this process, then
    over 2 stage ranks decoding chunk-parallel: the files byte-equal, the
    decode rank's flash launches at d = 512 4 a video and the stage rank's 0
    (from the denoise on), each run's TIMING split printed."""
    import logging
    import shutil
    import tempfile

    from vdpp_tpu_torch.apps import generate_video, generate_video_text
    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.modes import production
    from vdpp_tpu_torch.utils.logging import setup_logging

    results = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dit_intra_")
    try:
        # (c) The text->video app over 2 seq ranks.
        out_dir = os.path.join(tmp, "text")
        t0 = time.perf_counter()
        rc = generate_video_text.main(["--random-weights", "--steps", str(STEPS),
                                       "--seq-parallel", "2", "--num-stages", "1", "--devices",
                                       "cuda:0", "cuda:0", "--output-dir", out_dir])
        wall = time.perf_counter() - t0
        files = {os.path.splitext(n)[1]: os.path.join(out_dir, n) for n in os.listdir(out_dir)}
        if rc != 0 or ".y4m" not in files or ".gif" not in files:
            fail(f"the text->video app with --seq-parallel 2 returned {rc}, wrote {sorted(files)}")
        video, gif = y4m_frames(files[".y4m"]), gif_frames(files[".gif"])
        want = (DIT_FRAMES, 512, 320)
        print(f"text->video app --seq-parallel 2 (2 ranks sharing cuda:0 over gloo): y4m {video}, "
              f"gif {gif} (expected {want}), {wall:.3f} s in main ({smi})", flush=True)
        if video != want or gif != want:
            fail(f"the text app with --seq-parallel 2 wrote y4m {video} and gif {gif}")
        results["text_app_seq2"] = {"wall_s": wall, "y4m": video}

        # (d) The planner: production --auto-topology latency on two ranks.
        lines: list[str] = []

        class Keep(logging.Handler):
            def emit(self, record):
                lines.append(record.getMessage())

        keep = Keep()
        prod_log = logging.getLogger("vdpp_torch.production")
        base = ["--guidance-scale", "3", "--total-steps", str(STEPS), "--num-samples", "1",
                "--devices", "cuda:0", "cuda:0"]
        dev = torch.device("cuda:0")
        state = production._cpu_state(SVDUNet(SVDUNetConfig.svd_xt(), device=dev).init_weights(
            production._generator(dev, 42)))
        torch.cuda.empty_cache()
        runs = {}
        for what, extra in (("auto", ["--auto-topology", "latency"]),
                            ("explicit", ["--num-stages", "1", "--cfg-parallel"])):
            args = production.build_parser().parse_args(base + extra)
            setup_logging(args.log_level)
            prod_log.addHandler(keep)
            try:
                t0 = time.perf_counter()
                res = production.run(args, state=state)
                spawned(res["launches"])
                runs[what] = {"out": res["out"], "wall_s": time.perf_counter() - t0,
                              "launches": res["launches"],
                              "flags": (args.num_stages, args.seq_parallel, args.frame_parallel,
                                        args.cfg_parallel)}
            finally:
                prod_log.removeHandler(keep)
        del state
        plan = [ln for ln in lines if ln.startswith(("auto-topology", "  runner-up"))]
        for ln in plan:
            print(f"production --auto-topology latency, 2 ranks on cuda:0: {ln}")
        same = torch.equal(runs["auto"]["out"], runs["explicit"]["out"])
        print(f"production --auto-topology latency: stage, seq, frame, cfg = "
              f"{runs['auto']['flags']}, {runs['auto']['wall_s']:.3f} s; explicit "
              f"--num-stages 1 --cfg-parallel {runs['explicit']['wall_s']:.3f} s; samples "
              f"{tuple(runs['auto']['out'].shape)} bit-equal {same} ({smi})", flush=True)
        if not plan or runs["auto"]["flags"] != (1, 1, 1, True) or not same or \
                not torch.isfinite(runs["auto"]["out"]).all():
            fail(f"production --auto-topology: plan {plan}, flags {runs['auto']['flags']}, "
                 f"bit-equal to the explicit run {same}")
        for r, counts in enumerate(runs["auto"]["launches"]):
            expect(f"production --auto-topology, rank {r}: flash at d = 64",
                   counts["flash"].get(64, 0), PROD_FLASH_PER_FORWARD * STEPS)
        results["auto_topology"] = {"plan": plan, "flags": runs["auto"]["flags"],
                                    "walls": {k: v["wall_s"] for k, v in runs.items()},
                                    "launches": runs["auto"]["launches"]}
        del runs
        torch.cuda.empty_cache()

        # (e) The image->video app: a decode rank, none, and the decode split
        # over 2 stage ranks.
        app_runs = {}
        for what, extra in (("decode1", ["--num-stages", "1", "--decode-devices", "1",
                                         "--devices", "cuda:0", "cuda:0"]),
                            ("one_rank", ["--num-stages", "1", "--device", "cuda"]),
                            ("stages2", ["--num-stages", "2", "--devices", "cuda:0", "cuda:0"])):
            out_dir = os.path.join(tmp, what)
            t0 = time.perf_counter()
            ranks = generate_video.run(["--random-weights", "--steps", str(APP_STEPS),
                                        "--num-samples", str(DECODE_SAMPLES), "--output-dir",
                                        out_dir, *extra])
            wall = time.perf_counter() - t0
            if ranks is None:
                fail(f"the image->video app ({what}) refused its flags")
            if len(ranks) > 1:  # spawned ranks (one rank runs in this process)
                spawned([r["launches"] for r in ranks])
            app_runs[what] = {"files": app_files(out_dir), "wall_s": wall, "ranks": ranks}
            writer = next(r for r in ranks if r["outputs"])
            print(f"image->video app {what}: {wall:.3f} s in run, TIMING {writer['timing']}, "
                  f"launches from the denoise on by rank {[r['launches'] for r in ranks]} "
                  f"({smi})", flush=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    one = app_runs["one_rank"]["files"]
    if len(one) != 3 * DECODE_SAMPLES:
        fail(f"the image->video app wrote {sorted(one)}")
    for what in ("decode1", "stages2"):
        same = app_runs[what]["files"] == one
        print(f"image->video app {what}: files byte-equal to the one-rank run's {same}")
        if not same:
            fail(f"the image->video app's files with {what} differ from the one-rank run's")
    fwd64 = FLASH_PER_FORWARD * 2 * APP_STEPS * DECODE_SAMPLES
    d512 = FLASH_PER_APP_DECODE * DECODE_SAMPLES
    stage_r, decode_r = app_runs["decode1"]["ranks"]
    expect("image->video app --decode-devices 1, decode rank: flash at d = 512",
           decode_r["launches"]["flash"].get(512, 0), d512)
    expect("image->video app --decode-devices 1, decode rank: flash at d = 64",
           decode_r["launches"]["flash"].get(64, 0), 0)
    expect("image->video app --decode-devices 1, stage rank: flash at d = 512",
           stage_r["launches"]["flash"].get(512, 0), 0)
    expect("image->video app --decode-devices 1, stage rank: flash at d = 64",
           stage_r["launches"]["flash"].get(64, 0), fwd64)
    for r, res in enumerate(app_runs["stages2"]["ranks"]):
        expect(f"image->video app --num-stages 2, rank {r}: flash at d = 512",
               res["launches"]["flash"].get(512, 0), d512 // 2)
    results["apps"] = {k: {"wall_s": v["wall_s"], "ranks": [
        {"launches": r["launches"], "timing": r["timing"]} for r in v["ranks"]]}
        for k, v in app_runs.items()}
    results["decode_launches"] = {"decode_rank": d512, "stages2": d512}
    return results


# ---- phase 11: the MoE DiT (expert parallelism) and int8 weights ---- #


def moe_case(torch, device, dispatch: dict[str, str] | None = None):
    """What phase 11 (a)'s runs build alike on ``device``: the wrapper
    (MoE DiT-XL joint3d bf16, MOE_EXPERTS experts in every second block,
    T5-XXL's cross width, STEPS Euler steps; built under ``dispatch``, the
    MoE switches it reads once), the DiT from seed 1, a random context of
    DIT_CTX_TOKENS tokens from seed 3 with a CFG ramp to 6 over DIT_FRAMES
    frames, and one noise draw of DIT_FRAMES x DIT_LAT from seed 2."""
    from vdpp_tpu_torch.models.dit import DiTVideoConfig, DiTVideoWrapper
    from vdpp_tpu_torch.models.svd_wrapper import make_guidance_ramp

    config = dataclasses.replace(DiTVideoConfig.joint3d_xl(), cross_attention_dim=4096,
                                 num_experts=MOE_EXPERTS)
    with kernel_switches(dispatch or {}):
        wrapper = DiTVideoWrapper(config, num_steps=STEPS, device=device)
    dit = wrapper.init(torch.Generator(device=device).manual_seed(1))
    ctx = torch.randn(1, DIT_CTX_TOKENS, 4096, device=device,
                      generator=torch.Generator(device=device).manual_seed(3))
    noise = torch.randn(1, 1, DIT_FRAMES, *DIT_LAT, config.in_channels, device=device,
                        generator=torch.Generator(device=device).manual_seed(2))
    bundle = (dit, ctx, make_guidance_ramp(6.0, DIT_FRAMES, device=device))
    return wrapper, bundle, noise * wrapper.init_noise_sigma


def moe_stack_bytes(dit) -> int:
    from vdpp_tpu_torch.ops.moe import MoEFF

    return sum(p.numel() * p.element_size() for m in dit.modules() if isinstance(m, MoEFF)
               for p in m._parameters.values())


def moe_rank(stage, cases) -> dict:
    """One rank of phase 11 (a): each ``(name, axes)`` of ``cases`` on this
    group laid out with its inner axes (the stage count follows), through
    ``StepPipeline.run`` with the expert layout: the model is built whole on
    the card, then the rank keeps its experts (the parameter bytes and the
    allocated bytes before and after are recorded), the launch counts and the
    collectives' counts set to 0 just before the run and read just after.
    The mesh's last rank also returns the outputs."""
    import torch

    from vdpp_tpu_torch.ops import flash_attention as fa
    from vdpp_tpu_torch.ops import norm_kernel as nk
    from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
    from vdpp_tpu_torch.ops.moe import expert_layout
    from vdpp_tpu_torch.parallel import collectives
    from vdpp_tpu_torch.parallel.mesh import Stage
    from vdpp_tpu_torch.parallel.pipeline import PipelineConfig, StepPipeline
    from vdpp_tpu_torch.utils import kernels
    from vdpp_tpu_torch.utils.memory import params_bytes_per_device

    exact_libraries(torch)
    out = {"rank": stage.rank, "device": str(stage.device)}
    for name, axes in cases:
        st = Stage(dataclasses.replace(stage.mesh, **{"seq": 1, "frame": 1, "cfg": 1,
                                                      "expert": 1, **axes}), stage.rank)
        torch.cuda.empty_cache()
        wrapper, params, inputs = moe_case(torch, stage.device)
        whole, stacks = params_bytes_per_device(params), moe_stack_bytes(params[0])
        torch.cuda.synchronize(stage.device)
        allocated = torch.cuda.memory_allocated(stage.device)
        pipe = StepPipeline(st, wrapper.pipeline_step_fn(**st.axes),
                            PipelineConfig(STEPS, st.num_stages), param_spec=expert_layout)
        pipe.layout(params)
        torch.cuda.synchronize(stage.device)
        kept = params_bytes_per_device(params)
        freed = allocated - torch.cuda.memory_allocated(stage.device)
        torch.cuda.reset_peak_memory_stats(stage.device)
        reset_counts(fa, nk, ta)
        collectives.clear_counts()
        t0 = time.perf_counter()
        res = pipe.run(params, inputs)
        torch.cuda.synchronize(stage.device)
        out[name] = {
            "seconds": time.perf_counter() - t0, "stage": st.index, "stages": st.num_stages,
            "flash": dict(fa.launches), "collectives": dict(collectives.counts),
            "bytes": dict(collectives.nbytes), "param_bytes": kept, "whole_bytes": whole,
            "stack_bytes": stacks, "freed": freed,
            "peak": torch.cuda.max_memory_allocated(stage.device),
            "outputs": res.cpu() if res is not None and st.is_last_rank else None}
        del wrapper, params, inputs, pipe
    out["variants"] = kernels.variant_launches()
    return out


def run_moe(torch, fa, nk, ta, smi: str) -> dict:
    """Phase 11 (a): the MoE DiT-XL joint3d at full width. In this process on
    cuda:0: dense dispatch (STEPS steps, counted and timed, after a warm-up
    step), the gather dispatch at capacity MOE_EXPERTS (nothing drops: within
    TOL["bf16"] x max|latent| of dense) and at the default capacity 2.0
    (timed); then 2 ranks sharing cuda:0 over gloo at expert 2 (within
    INTRA_TOL of one process), and 4 ranks (NCCL with four cards, else cuda:0
    over gloo) at stage 2 x expert 2, bit-equal to expert 2. Each rank keeps
    half of the expert stacks; each run's psum calls and bytes a forward are
    printed."""
    from vdpp_tpu_torch.parallel.mesh import make_pipeline_mesh, run_stages
    from vdpp_tpu_torch.parallel.pipeline import run_reference_single_device

    saved = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic)
    exact_libraries(torch)
    torch.cuda.empty_cache()
    out, lat = {}, {}
    dev = torch.device("cuda:0")
    wrapper, params, inputs = moe_case(torch, dev)
    n_params = sum(p.numel() for p in params[0].parameters())
    stacks = moe_stack_bytes(params[0])
    print(f"MoE DiT-XL joint3d bf16 ({MOE_EXPERTS} experts in {MOE_BLOCKS} of 28 blocks): "
          f"{n_params / 1e9:.3f} B parameters, {stacks / 2**30:.3f} GiB of expert stacks",
          flush=True)
    gather_wrappers = {cap: moe_case(torch, dev, {"VDPP_MOE_DISPATCH": "gather",
                                                  "VDPP_MOE_CAPACITY": str(cap)})[0]
                       for cap in (float(MOE_EXPERTS), MOE_CAPACITY)}
    runs = {"dense": wrapper, **{f"gather_{cap:g}": w for cap, w in gather_wrappers.items()}}
    for name, w in runs.items():
        run_reference_single_device(w.pipeline_step_fn(), params, inputs, 1)  # warm
        torch.cuda.synchronize()
        reset_counts(fa, nk, ta)
        t0 = time.perf_counter()
        lat[name] = run_reference_single_device(w.pipeline_step_fn(), params, inputs,
                                                STEPS).cpu()
        torch.cuda.synchronize()
        out[name] = {"seconds": time.perf_counter() - t0, "flash": fa.launches.get(72, 0)}
        expect(f"MoE DiT-XL {name}: flash at d = 72 ({MOE_FORWARDS} forwards)",
               out[name]["flash"], FLASH_PER_JOINT3D_FORWARD * MOE_FORWARDS)
    ref = lat["dense"]
    ref_max = ref.abs().max().item()
    for name in runs:
        err = (lat[name] - ref).abs().max().item()
        out[name]["max_abs_err"] = err
        print(f"MoE DiT-XL {name} dispatch, one process: {out[name]['seconds']:.3f} s for "
              f"{STEPS} steps ({MOE_FORWARDS} forwards), max|diff| to dense {err:.4g} "
              f"({err / ref_max:.3g} of max|latent| {ref_max:.4g}) ({smi})", flush=True)
        if not torch.isfinite(lat[name]).all():
            fail(f"MoE DiT-XL {name}: non-finite latent")
    full = f"gather_{float(MOE_EXPERTS):g}"
    if not out[full]["max_abs_err"] <= TOL["bf16"] * ref_max:
        fail(f"MoE gather at capacity {MOE_EXPERTS} (nothing drops) differs from dense by "
             f"{out[full]['max_abs_err']}, more than {TOL['bf16']} x {ref_max}")
    del wrapper, params, inputs, gather_wrappers, runs
    torch.cuda.empty_cache()

    four = torch.cuda.device_count() >= 4
    meshes = {"a": (make_pipeline_mesh(devices=["cuda:0"] * 2), [("ep2", {"expert": 2})]),
              "b": (make_pipeline_mesh(4, device="cuda") if four
                    else make_pipeline_mesh(devices=["cuda:0"] * 4),
                    [("stage2_ep2", {"expert": 2})])}
    ranks = {}
    for part, (mesh, cases) in meshes.items():
        t0 = time.perf_counter()
        try:
            ranks[part] = spawned(run_stages(mesh, moe_rank, cases, timeout=900))
        except (RuntimeError, TimeoutError) as e:
            fail(f"phase 11 (a{part}) failed: {e}")
        out[part + "_wall_s"] = time.perf_counter() - t0
        out[part + "_backend"] = mesh.backend
    torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = saved
    got = {name: ranks[part][-1][name]["outputs"] for part, (_, cases) in meshes.items()
           for name, _ in cases}
    err = (got["ep2"] - ref).abs().max().item()
    print(f"MoE DiT-XL expert 2 (2 ranks sharing cuda:0, gloo): max|diff| to one process "
          f"{err:.4g} ({err / ref_max:.3g} of max|latent|; limit {INTRA_TOL} x max), bit-equal "
          f"{torch.equal(got['ep2'], ref)}; stage 2 x expert 2 ({len(ranks['b'])} ranks, "
          f"{out['b_backend']}) bit-equal to expert 2 {torch.equal(got['stage2_ep2'], got['ep2'])}"
          f" ({smi})", flush=True)
    if not err <= INTRA_TOL * ref_max or not torch.isfinite(got["ep2"]).all():
        fail(f"MoE expert 2 disagrees with one process: max|diff| {err}")
    if not torch.equal(got["stage2_ep2"], got["ep2"]):
        fail("MoE stage 2 x expert 2 is not bit-equal to expert 2")
    out["ep2_max_abs_err"], out["ep2_bit_equal"] = err, torch.equal(got["ep2"], ref)
    for part, (_, cases) in meshes.items():
        for name, _ in cases:
            for r in ranks[part]:
                res = r[name]
                forwards = MOE_FORWARDS // res["stages"]
                per_fwd = {k: v / forwards for k, v in res["collectives"].items()}
                bytes_fwd = {k: v / forwards for k, v in res["bytes"].items()}
                print(f"MoE {name}, rank {r['rank']} (stage {res['stage']}): "
                      f"{res['seconds']:.3f} s; flash {res['flash']}; collectives a forward "
                      f"{per_fwd}, bytes a forward {bytes_fwd}; parameters "
                      f"{res['param_bytes'] / 2**30:.3f} GiB of {res['whole_bytes'] / 2**30:.3f}"
                      f" (stacks {res['stack_bytes'] / 2**30:.3f} GiB, freed on the card "
                      f"{res['freed'] / 2**30:.3f}); peak allocated {res['peak'] / 2**30:.2f} "
                      f"GiB ({smi})", flush=True)
                expect(f"MoE {name}, rank {r['rank']}: flash at d = 72",
                       res["flash"].get(72, 0), FLASH_PER_JOINT3D_FORWARD * forwards)
                if per_fwd.get("sum") != MOE_BLOCKS:
                    fail(f"MoE {name}: {per_fwd} collectives a forward, expected "
                         f"{MOE_BLOCKS} sums")
                if res["whole_bytes"] - res["param_bytes"] != res["stack_bytes"] // 2 \
                        or res["freed"] < res["stack_bytes"] // 2:
                    fail(f"MoE {name}, rank {r['rank']}: kept {res['param_bytes']} of "
                         f"{res['whole_bytes']} parameter bytes, freed {res['freed']}; "
                         f"expected half of the stacks' {res['stack_bytes']} gone")
    out["ranks"] = {name: [{k: v for k, v in r[name].items() if k != "outputs"}
                           for r in ranks[part]]
                    for part, (_, cases) in meshes.items() for name, _ in cases}
    return out


def int8_mark_count(torch) -> int:
    """W8A8 sites a forward of SVD-XT: the linears and spatial convs that
    ``quantize_model(act_int8=True)`` marks (counted on the meta device), each
    run once a forward, but the cross-attentions' ``to_q`` and ``to_k``: over
    the one key of the image embedding the output is ``to_out(to_v(ctx))``,
    so they never run (in the reference neither)."""
    from vdpp_tpu_torch.models.svd_unet import SVDUNet, SVDUNetConfig
    from vdpp_tpu_torch.ops.quant import is_a8, quantize_model

    unet = quantize_model(SVDUNet(SVDUNetConfig.svd_xt(), device="meta"), act_int8=True)
    return sum(is_a8(m) for name, m in unet.named_modules()
               if not re.search(r"attn2\.to_[qk]$", name))


def check_int8_dot(torch) -> dict:
    """``int8_dot`` on the card against the CPU at SVD-XT's W8A8 shapes (the
    timestep MLP's single row, which ``_int_mm`` takes padded; the add
    embedding's 2 rows; 4096 rows of a 320 -> 2560 GEGLU projection and of a
    level-0 conv's im2col, 2880 -> 320): bit for bit, timed against the bf16
    product of the same shape."""
    import torch.nn.functional as F

    from vdpp_tpu_torch.ops import quant as tq

    rows = []
    for m, k, n in ((1, 320, 1280), (2, 1280, 1280), (4096, 320, 2560), (4096, 2880, 320)):
        g = torch.Generator().manual_seed(m + k + n)
        x = torch.randn(m, k, generator=g) * 3.0
        q8, scale = tq.quantize_weight(torch.randn(n, k, generator=g) / math.sqrt(k))
        want = tq.int8_dot(x, q8, scale)
        xc, qc, sc = x.cuda(), q8.cuda(), scale.cuda()
        got = tq.int8_dot(xc, qc, sc).cpu()
        xb, wb = xc.to(torch.bfloat16), (qc.float() * sc).to(torch.bfloat16)
        row = {"M": m, "K": k, "N": n, "bit_equal": torch.equal(got, want),
               "ms": time_ms(torch, lambda: tq.int8_dot(xc, qc, sc)),
               "bf16_ms": time_ms(torch, lambda: F.linear(xb, wb))}
        print(f"int8_dot on the card, M {m}, K {k}, N {n}: bit-equal to the CPU "
              f"{row['bit_equal']}, {row['ms']:.4f} ms (the bf16 product {row['bf16_ms']:.4f})",
              flush=True)
        if not row["bit_equal"]:
            fail(f"int8_dot on the card differs from the CPU at M {m}, K {k}, N {n}")
        rows.append(row)
    return {"shapes": rows}


def run_int8_svd(torch, fa, nk, ta, smi: str) -> dict:
    """Phase 11 (b): full-width SVD-XT bf16, INT8_FRAMES frames of 72x128,
    CFG 3, STEPS Euler steps, both kernel switches on, through
    ``modes.benchmark.main`` at one stage in this process (one warm-up and
    one measured sample): as it is, ``--weights-int8``, ``--weights-w8a8``.
    For each: the parameter MB the benchmark logs, the launches (flash, B2,
    B3, ``_int_mm``) counted from 0, the measured sample's latent (captured
    from ``StepPipeline.run_ticked``) against the bf16 run's within
    INT8_DRIFT, and the BENCHMARK_JSON line."""
    import logging.handlers

    from vdpp_tpu_torch.modes import benchmark
    from vdpp_tpu_torch.ops import quant as tq
    from vdpp_tpu_torch.parallel.pipeline import StepPipeline

    argv = ["--model", "svd", "--guidance-scale", "3", "--num-stages", "1", "--total-steps",
            str(STEPS), "--num-samples", "1", "--warmup-samples", "1", *INT8_LATENT]
    latents, log = [], logging.handlers.BufferingHandler(1000)
    run_ticked = StepPipeline.run_ticked

    def capture(self, params, inputs, *a, **kw):
        res = run_ticked(self, params, inputs, *a, **kw)
        latents.append(res[0][-1].cpu())
        return res

    out = {}
    sites = int8_mark_count(torch)
    forwards = 2 * STEPS * 2  # CFG sequential, a warm-up and a measured sample
    StepPipeline.run_ticked = capture
    benchmark.LOGGER.addHandler(log)
    try:
        for flag in ("", "--weights-int8", "--weights-w8a8"):
            torch.cuda.empty_cache()
            log.buffer.clear()
            with kernel_switches():
                reset_counts(fa, nk, ta)
                tq.int_mm_calls = 0
                res = run_mode(benchmark.main, argv + ([flag] if flag else []),
                               f"(11b) SVD-XT {flag or 'bf16'}", "pipeline", 1, smi)
                counts = {"flash": fa.launches.total(), "gn": nk.launches,
                          "frame": ta.launches, "int_mm": tq.int_mm_calls}
            mb = [r.getMessage() for r in log.buffer if "MB of parameters" in r.getMessage()]
            out[flag or "bf16"] = {"json": res, "counts": counts, "log": mb}
            print(f"SVD-XT {flag or 'bf16'}: {'; '.join(mb)}; launches {counts}; "
                  f"{res['avg_sample_time_s'] / STEPS:.4f} s a step ({smi})", flush=True)
            expect(f"flash in SVD-XT {flag or 'bf16'}", counts["flash"],
                   FLASH_PER_FORWARD * forwards)
            expect(f"GroupNorm+SiLU in SVD-XT {flag or 'bf16'}", counts["gn"],
                   GN_SILU_PER_FORWARD * forwards)
            expect(f"frame attention in SVD-XT {flag or 'bf16'}", counts["frame"],
                   FRAME_ATTN_PER_FORWARD * forwards)
            expect(f"_int_mm in SVD-XT {flag or 'bf16'}", counts["int_mm"],
                   sites * forwards if flag == "--weights-w8a8" else 0)
    finally:
        StepPipeline.run_ticked = run_ticked
        benchmark.LOGGER.removeHandler(log)
    ref = latents[0].float()
    for flag, lat in zip(("--weights-int8", "--weights-w8a8"), latents[1:]):
        drift = ((lat.float() - ref).norm() / ref.norm()).item()
        out[flag]["drift"] = drift
        print(f"SVD-XT {flag}: latent relative L2 to bf16 {drift:.4g} (limit "
              f"{INT8_DRIFT[flag]}), finite {bool(torch.isfinite(lat).all())} ({smi})",
              flush=True)
        if not (0 < drift < INT8_DRIFT[flag]) or not torch.isfinite(lat).all():
            fail(f"SVD-XT {flag}: latent drift {drift} from bf16, limit {INT8_DRIFT[flag]}")
    out["a8_sites_per_forward"] = sites
    out["int8_dot"] = check_int8_dot(torch)
    return out


def run_moe_int8_cli(smi: str) -> dict:
    """Phase 11 (c): ``modes.benchmark.main`` with the tiny MoE DiT at
    ``--expert-parallel 2 --num-stages 2`` (4 ranks) and ``--fsdp
    --weights-int8`` (2 ranks), the ranks sharing cuda:0 over gloo; each
    BENCHMARK_JSON line carries the contract's keys."""
    from vdpp_tpu_torch.modes import benchmark

    tiny = ["--model", "dit3d_moe_tiny", "--guidance-scale", "5", "--total-steps", "4",
            "--num-samples", "2", "--warmup-samples", "1", "--latent-shape", "1", "4", "4", "16",
            "16"]
    return {
        "ep2": run_mode(benchmark.main, [*tiny, "--expert-parallel", "2", "--num-stages", "2",
                                         "--devices", *["cuda:0"] * 4],
                        "(11c) dit3d_moe_tiny --expert-parallel 2 --num-stages 2",
                        "pipeline_x_ep2", 4, smi),
        "fsdp_int8": run_mode(benchmark.main, [*tiny, "--fsdp", "--weights-int8",
                                               "--num-stages", "2", "--devices", "cuda:0",
                                               "cuda:0"],
                              "(11c) dit3d_moe_tiny --fsdp --weights-int8", "fsdp", 2, smi)}


def check_moe_products(torch) -> dict:
    """The MoE expert products' route on the card (``ops/moe.py::_mm_f32``:
    bf16 operands, an fp32 result, ``out_dtype``), at a dense block's shapes
    (E = 4, T = 5120 tokens, D = 1152, I = 4608): its distance to the fp32
    product of the same operands, against that of the product rounded to
    bf16 first (what the port did before)."""
    from vdpp_tpu_torch.ops.moe import _mm_f32

    g = torch.Generator(device="cuda").manual_seed(30)
    x = torch.randn(4, 5120, 1152, generator=g, device="cuda").bfloat16()
    w = (torch.randn(4, 1152, 4608, generator=g, device="cuda") / 1152 ** 0.5).bfloat16()
    ref = torch.bmm(x.float(), w.float())
    got = _mm_f32(x, w)
    rounded = torch.bmm(x, w).float()
    scale = ref.abs().max().item()
    err, err_bf16 = ((got - ref).abs().max().item() / scale,
                     (rounded - ref).abs().max().item() / scale)
    ms = time_ms(torch, lambda: _mm_f32(x, w))
    ms_bf16 = time_ms(torch, lambda: torch.bmm(x, w))
    ms_rounded = time_ms(torch, lambda: torch.bmm(x, w).float())
    print(f"MoE expert product (11a): torch.bmm(out_dtype=torch.float32) on the card, "
          f"{got.dtype}; max|diff| to the fp32 product / max|ref| {err:.3g} (rounded to bf16 "
          f"first: {err_bf16:.3g}); {ms:.4f} ms against the bf16-output product's "
          f"{ms_bf16:.4f} ms and the rounded product's, widened after, {ms_rounded:.4f} ms",
          flush=True)
    if got.dtype != torch.float32 or not err < err_bf16 / 10:
        fail(f"the MoE expert product is not an fp32 result: {got.dtype}, {err} vs {err_bf16}")
    return {"max_rel_err": err, "max_rel_err_bf16_rounded": err_bf16, "ms": ms,
            "bf16_output_ms": ms_bf16, "rounded_then_widened_ms": ms_rounded}


def run_phase11(torch, fa, nk, ta, smi: str) -> dict:
    t0 = time.perf_counter()
    out = {"moe_products": check_moe_products(torch), "moe": run_moe(torch, fa, nk, ta, smi),
           "int8": run_int8_svd(torch, fa, nk, ta, smi), "cli": run_moe_int8_cli(smi)}
    print(f"phase 11 (the MoE DiT, int8 weights) done in {time.perf_counter() - t0:.1f} s "
          f"({smi})", flush=True)
    return out


# 12. Serving (``modes/serve.py``), after phase 11: the server as a user
# starts it, ``python -m vdpp_tpu_torch.modes.serve``, in a subprocess (its
# ``main`` installs signal handlers, which only a main thread may do). The
# image->video app's shape, 14 frames of a 72x128 latent, where the
# reference's serve default (4 frames of 16x16) would reach no kernel. Each
# server counts its kernel launches from the end of its warm-up request and
# logs them, each process's, when it stops.
SERVE_FRAMES = 14
SERVE_STEPS = 2
SERVE_ARGS = ["--preset", "svd_xt", "--num-frames", str(SERVE_FRAMES), "--latent-hw", "72",
              "128", "--steps", str(SERVE_STEPS), "--guidance-scale", "3"]
SERVE_VIDEO = (SERVE_FRAMES, 1024, 576)  # y4m frames, width, height
SERVE_FORWARDS = 2 * SERVE_STEPS  # CFG: two UNet forwards a step
# A request's launches at one stage (the decode in the server process):
SERVE_PER_REQUEST = {"flash64": FLASH_PER_FORWARD * SERVE_FORWARDS,
                     "flash512": -(-SERVE_FRAMES // 4),
                     "gn": GN_SILU_PER_FORWARD * SERVE_FORWARDS,
                     "frame": FRAME_ATTN_PER_FORWARD * SERVE_FORWARDS}
SERVE_SEEDS = (1, 2)
# (c) The tiny joint3d DiT (head dim 16) at 8 frames of 32x64: its 4
# blocks' self-attention over 8 x 512 patch tokens takes the generic flash
# kernel at d = 16 in each of a request's 4 forwards, and the tiny VAE's
# mid-block attention (32 channels, L = 2048) at d = 32 once a 4-frame chunk.
SERVE_TINY_ARGS = ["--model", "dit3d", "--preset", "tiny", "--num-frames", "8", "--latent-hw",
                   "32", "64", "--steps", str(SERVE_STEPS), "--guidance-scale", "5"]
SERVE_TINY_PER_REQUEST = {16: 4 * SERVE_FORWARDS, 32: 2}
SERVE_TINY_VIDEO = (8, 128, 64)
SERVE_READY_S = 900
SERVE_LAUNCH_RE = re.compile(r"(?:rank (\d+)|server process) \(([^)]*)\) launched since the "
                             r"warm-up: (\{.*\}); peak allocated ([\d.]+) GB")
SERVE_TICKS_RE = re.compile(r"stream: (\d+) ticks, tick seconds mean ([\d.]+), min ([\d.]+), "
                            r"max ([\d.]+)")


class ServeProcess:
    """``python -m vdpp_tpu_torch.modes.serve`` on a free port of this host,
    its log in a file."""

    def __init__(self, what: str, argv: list[str], env: dict[str, str], log_dir: str):
        import socket
        import subprocess

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.port = s.getsockname()[1]
        here = os.path.dirname(os.path.abspath(__file__))
        self.what = what
        self.base = f"http://127.0.0.1:{self.port}"
        self.log_path = os.path.join(log_dir, f"serve_{self.port}.log")
        self.log = open(self.log_path, "w")
        full_env = dict(os.environ, **env,
                        PYTHONPATH=os.pathsep.join([here, os.environ.get("PYTHONPATH", "")]))
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "vdpp_tpu_torch.modes.serve", *argv, "--port",
             str(self.port)], cwd=here, env=full_env, stdout=self.log,
            stderr=subprocess.STDOUT)
        print(f"serve {what}: started with {' '.join(argv)}", flush=True)

    def text(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def failed(self, msg: str) -> None:
        self.kill()
        print(self.text()[-6000:], flush=True)
        fail(f"serve {self.what}: {msg}")

    def wait_ready(self) -> float:
        import urllib.request

        while True:
            if self.proc.poll() is not None:
                self.failed(f"the server exited with {self.proc.returncode} before it was ready")
            if time.perf_counter() - self.t0 > SERVE_READY_S:
                self.failed(f"not ready in {SERVE_READY_S} s")
            try:
                with urllib.request.urlopen(self.base + "/healthz", timeout=5) as r:
                    if r.status == 200:
                        return time.perf_counter() - self.t0
            except OSError:
                time.sleep(1.0)

    def get(self, path: str) -> dict:
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=60) as r:
            return json.loads(r.read())

    def post(self, body: dict) -> dict:
        """``{"status", "seconds" (X-Generation-Seconds), "wall", "body"}``."""
        import urllib.error
        import urllib.request

        req = urllib.request.Request(self.base + "/generate", data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                return {"status": r.status, "seconds": float(r.headers["X-Generation-Seconds"]),
                        "wall": time.perf_counter() - t0, "body": r.read()}
        except urllib.error.HTTPError as e:
            return {"status": e.code, "body": e.read(), "wall": time.perf_counter() - t0}

    def posts(self, bodies: list[dict]) -> list[dict]:
        """The requests at once, one thread each."""
        import threading

        out: list = [None] * len(bodies)

        def one(i):
            try:
                out[i] = self.post(bodies[i])
            except Exception as e:  # noqa: BLE001 - reported below
                out[i] = {"status": None, "error": repr(e)}

        threads = [threading.Thread(target=one, args=(i,)) for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for r in out:
            if r["status"] != 200:
                self.failed(f"a request failed: {r.get('error') or r['body'][:2000]}")
        return out

    def stop(self) -> int:
        """SIGTERM (drain), then the exit code."""
        import signal

        self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout=300)
        except Exception:  # noqa: BLE001 - a server that does not drain fails the phase
            self.failed("did not exit within 300 s of SIGTERM")

    def kill(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()

    def launches(self) -> dict:
        """Each process's launches since the warm-up and its peak, from the
        log: ``{rank or "server": (counts, peak GB)}``."""
        out = {}
        for m in SERVE_LAUNCH_RE.finditer(self.text()):
            counts = json.loads(m.group(3))
            counts["flash"] = {int(d): n for d, n in counts["flash"].items()}
            out[int(m.group(1)) if m.group(1) else "server"] = (counts, float(m.group(4)))
        return out


def serve_video(srv: ServeProcess, data: bytes, want: tuple[int, int, int]) -> None:
    header = data[:data.index(b"\n")].split()
    w = int(next(t[1:] for t in header if t.startswith(b"W")))
    h = int(next(t[1:] for t in header if t.startswith(b"H")))
    got = (data.count(b"FRAME"), w, h)
    if header[0] != b"YUV4MPEG2" or got != want:
        srv.failed(f"the y4m holds {got} (frames, width, height), expected {want}")


def serve_expect(srv: ServeProcess, what: str, got: int, want: int) -> None:
    print(f"serve {srv.what}: {what}: {got} launches (expected {want})", flush=True)
    if got != want:
        srv.failed(f"{what}: {got} launches, expected {want}")


def serve_report(srv: ServeProcess, smi: str, ready_s: float, reqs: list[dict]) -> dict:
    """Print the part's latencies, ticks, each process's peak; returns them."""
    log = srv.text()
    ticks = SERVE_TICKS_RE.search(log)
    procs = srv.launches()
    spawned([counts for counts, _ in procs.values()])
    for key, (counts, peak) in procs.items():
        print(f"serve {srv.what}: {'rank ' + str(key) if key != 'server' else 'server'}: "
              f"launches since the warm-up {counts}, peak allocated {peak:.3f} GB ({smi})",
              flush=True)
    lat = [r["seconds"] for r in reqs]
    print(f"serve {srv.what}: ready in {ready_s:.1f} s; request seconds (server) "
          f"{[round(x, 4) for x in lat]}, client walls {[round(r['wall'], 4) for r in reqs]}; "
          f"ticks: {ticks.group(0) if ticks else 'none logged'}; wall "
          f"{time.perf_counter() - srv.t0:.1f} s ({smi})", flush=True)
    return {"ready_s": ready_s, "request_s": lat, "walls": [r["wall"] for r in reqs],
            "ticks": ticks.group(0) if ticks else None,
            "launches": {str(k): v[0] for k, v in procs.items()},
            "peak_gb": {str(k): v[1] for k, v in procs.items()},
            "wall_s": time.perf_counter() - srv.t0}


def run_serve_one_stage(smi: str, log_dir: str) -> dict:
    """(a) One stage in the server process, both switches on: /healthz, two
    concurrent y4m requests, a third with the first's seed (byte-equal),
    /metrics (the warm-up counts), then SIGTERM with a request in flight:
    200, exit 0. The launches since the warm-up: 4 requests' worth."""
    import threading

    srv = ServeProcess("(12a) one stage", [*SERVE_ARGS, "--num-stages", "1", "--device", "cuda"],
                       SWITCHES, log_dir)
    try:
        ready_s = srv.wait_ready()
        health = srv.get("/healthz")
        if health.get("status") != "ok" or health.get("stages") != 1:
            srv.failed(f"/healthz gave {health}")
        pair = srv.posts([{"seed": s, "format": "y4m"} for s in SERVE_SEEDS])
        again = srv.posts([{"seed": SERVE_SEEDS[0], "format": "y4m"}])[0]
        for r in (*pair, again):
            serve_video(srv, r["body"], SERVE_VIDEO)
        if again["body"] != pair[0]["body"]:
            srv.failed("the same seed gave other bytes")
        metrics = srv.get("/metrics")
        if metrics["requests_served"] != 4:
            srv.failed(f"/metrics gave {metrics} (4 served, the warm-up with them)")
        drained: list = []
        t = threading.Thread(target=lambda: drained.extend(
            srv.posts([{"seed": 3, "format": "y4m"}])))
        t.start()
        time.sleep(1.5)  # the request is in its denoise (a request takes seconds)
        rc = srv.stop()
        t.join()
        log = srv.text()
        if rc != 0 or not drained or "drained; exiting" not in log:
            srv.failed(f"the drain: exit code {rc}, {len(drained)} answers")
        if log.index("signal 15: draining") > log.rindex('"POST /generate HTTP/1.1" 200'):
            srv.failed("the request answered before the drain began: not in flight")
        serve_video(srv, drained[0]["body"], SERVE_VIDEO)
        res = serve_report(srv, smi, ready_s, [*pair, again, *drained])
        counts = srv.launches().get(0, ({}, 0))[0]
        if not counts:
            srv.failed("no launch counts logged")
        n = 4
        serve_expect(srv, "flash at d = 64", counts["flash"].get(64, 0),
                     n * SERVE_PER_REQUEST["flash64"])
        serve_expect(srv, "flash at d = 512 (the decode)", counts["flash"].get(512, 0),
                     n * SERVE_PER_REQUEST["flash512"])
        serve_expect(srv, "GroupNorm+SiLU", counts["group_norm_silu"], n * SERVE_PER_REQUEST["gn"])
        serve_expect(srv, "frame attention", counts["frame_attention"],
                     n * SERVE_PER_REQUEST["frame"])
        res["bytes"] = [pair[0]["body"], pair[1]["body"]]
        res["metrics"] = metrics
        return res
    finally:
        srv.kill()


def run_serve_decode_rank(torch, smi: str, log_dir: str, want_bytes: list[bytes]) -> dict:
    """(b) Two stage ranks and a decode rank (a card each over NCCL where
    there are three, else all on cuda:0 over gloo): the same seeds give
    (a)'s bytes; each stage rank launches half a request's denoise kernels
    a request, the decode rank the decode's flash; the server none."""
    devices = (["cuda:0", "cuda:1", "cuda:2"] if torch.cuda.device_count() >= 3
               else ["cuda:0"] * 3)
    srv = ServeProcess("(12b) two stage ranks, a decode rank",
                       [*SERVE_ARGS, "--num-stages", "2", "--decode-devices", "1", "--devices",
                        *devices], SWITCHES, log_dir)
    try:
        ready_s = srv.wait_ready()
        health = srv.get("/healthz")
        if health.get("stages") != 2 or health.get("decode_devices") != 1:
            srv.failed(f"/healthz gave {health}")
        pair = srv.posts([{"seed": s, "format": "y4m"} for s in SERVE_SEEDS])
        again = srv.posts([{"seed": SERVE_SEEDS[0], "format": "y4m"}])[0]
        for r, want in zip((*pair, again), (*want_bytes, want_bytes[0])):
            serve_video(srv, r["body"], SERVE_VIDEO)
            if r["body"] != want:
                srv.failed("a y4m differs from the one-stage server's for the same seed")
        print(f"serve {srv.what}: 3 y4m byte-equal to the one-stage server's ({devices})",
              flush=True)
        if srv.stop() != 0:
            srv.failed("the drain did not exit 0")
        res = serve_report(srv, smi, ready_s, [*pair, again])
        procs = srv.launches()
        n = 3
        for r in (0, 1):
            counts = procs.get(r, ({}, 0))[0]
            if not counts:
                srv.failed(f"no launch counts logged for rank {r}")
            serve_expect(srv, f"stage rank {r}: flash at d = 64", counts["flash"].get(64, 0),
                         n * SERVE_PER_REQUEST["flash64"] // 2)
            serve_expect(srv, f"stage rank {r}: GroupNorm+SiLU", counts["group_norm_silu"],
                         n * SERVE_PER_REQUEST["gn"] // 2)
            serve_expect(srv, f"stage rank {r}: frame attention", counts["frame_attention"],
                         n * SERVE_PER_REQUEST["frame"] // 2)
        dec = procs.get(2, ({"flash": {}}, 0))[0]
        serve_expect(srv, "decode rank: flash at d = 512", dec["flash"].get(512, 0),
                     n * SERVE_PER_REQUEST["flash512"])
        server = procs.get("server", ({"flash": {}}, 0))[0]
        serve_expect(srv, "server process: flash", sum(server["flash"].values()), 0)
        res["devices"] = devices
        return res
    finally:
        srv.kill()


def run_serve_tiny_dit(smi: str, log_dir: str) -> dict:
    """(c) The tiny joint3d DiT at one stage: two requests with one prompt
    share a stream, one with a negative prompt opens another; the generic
    flash kernel at d = 16 (the DiT) and d = 32 (the tiny VAE)."""
    srv = ServeProcess("(12c) tiny dit3d", [*SERVE_TINY_ARGS, "--num-stages", "1", "--device",
                                            "cuda"], {}, log_dir)
    try:
        ready_s = srv.wait_ready()
        warm = srv.get("/metrics")["active_streams"]  # the warm-up's, with no prompt
        pair = srv.posts([{"seed": s, "prompt": "a red panda", "format": "y4m"}
                          for s in SERVE_SEEDS])
        if srv.get("/metrics")["active_streams"] != warm + 1:
            srv.failed("two requests with one prompt did not share a stream")
        neg = srv.posts([{"seed": SERVE_SEEDS[0], "prompt": "a red panda",
                          "negative_prompt": "blurry, dark", "format": "y4m"}])[0]
        if srv.get("/metrics")["active_streams"] != warm + 2:
            srv.failed("the negative prompt did not open a stream of its own")
        for r in (*pair, neg):
            serve_video(srv, r["body"], SERVE_TINY_VIDEO)
        if neg["body"] == pair[0]["body"]:
            srv.failed("the negative prompt changed nothing")
        if srv.stop() != 0:
            srv.failed("the drain did not exit 0")
        res = serve_report(srv, smi, ready_s, [*pair, neg])
        counts = srv.launches().get(0, ({"flash": {}}, 0))[0]
        for d, per in SERVE_TINY_PER_REQUEST.items():
            serve_expect(srv, f"generic flash at d = {d}", counts["flash"].get(d, 0), 3 * per)
        return res
    finally:
        srv.kill()


def run_phase12(torch, smi: str) -> dict:
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as log_dir:
        one = run_serve_one_stage(smi, log_dir)
        two = run_serve_decode_rank(torch, smi, log_dir, one.pop("bytes"))
        tiny = run_serve_tiny_dit(smi, log_dir)
    print(f"phase 12 (serving) done in {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return {"one_stage": one, "decode_rank": two, "tiny_dit3d": tiny}


# ---- the last kernel variants (in phase 3) and fused QKV (phase 13) ---- #

WIDE_FLASH_DIMS = (640, 768, 1024)  # flash_fwd_wide: O in slabs of 512 columns
WIDE_FLASH_SHAPE = (1, 2304, 2)  # B, L, H
# The last slab 8, 488 and 512 of 512 columns wide, at (B, Lq, Lk, H).
WIDE_EDGE_DIMS = (520, 1000, 1536)
WIDE_EDGE_SHAPE = (1, 600, 593, 2)
MANY_HEADS = (2, 32803)  # B, H: B * H = 65,536 + 70, past grid y's 65,535
MANY_HEADS_CASES = ((64, "bf16", 40), (512, "fp32", 12), (16, "bf16", 40),  # d, dtype, L
                    (136, "bf16", 24), (24, "fp32", 24), (520, "bf16", 12))
# (N, S, C, G): two channel tiles of 2560 (16 whole groups each), G = 512,
# two tiles of 4096, one group of 8192 split over two tiles, N = 70,000.
GN_WIDE_CASES = ((1, 1024, 5120, 32), (1, 1024, 5120, 512), (1, 1024, 8192, 512),
                 (2, 64, 8192, 1), (70000, 8, 64, 32))
# The fused projection's chunks at the models' sites: (what, B, L, H, d, dtype).
FUSED_FLASH_CASES = (("UNet level 0, 14 frames", 14, 9216, 5, 64, "bf16"),
                     ("DiT-XL joint3d", 1, 5120, 16, 72, "bf16"),
                     ("VAE mid-block, a decode chunk", 4, 9216, 1, 512, "fp32"),
                     ("VAE mid-block bf16", 4, 9216, 1, 512, "bf16"),
                     ("a video DiT's head dim", 1, 2304, 8, 128, "bf16"))
# (what, B, F, L, H, d): temporal self-attention's fused chunks.
FUSED_FRAME_CASES = (("UNet level 0, 14 frames", 1, 14, 9216, 5, 64),
                     ("DiT-XL factorized", 1, 8, 640, 16, 72))
FUSE_SWITCH = "VDPP_FUSE_QKV"
FUSE_ORDER = ("0", "1", "1", "0")  # unfused, fused, fused, unfused: the times in turns


def dtype_of(torch, name: str):
    return {"bf16": torch.bfloat16, "fp32": torch.float32}[name]


def library_ms(torch, fn, what: str) -> float | None:
    """The one-call PyTorch yardstick's time, or None where it refuses the
    shape (said so)."""
    try:
        return time_ms(torch, fn, iters=5, warmup=1)
    except RuntimeError as e:
        print(f"{what}: the library call refused the shape: {str(e).splitlines()[0]}")
        return None


def check_flash_wide(torch, fa, F) -> dict:
    """Flash above d = 512 (``flash_fwd_wide``, ``flash_fwd_wide_f32``) at
    d = 640, 768 and 1024, bf16 and fp32, both softmax modes, at B = 1,
    L = 2304, 2 heads, every dtype timed with its bound and SDPA; and at
    WIDE_EDGE_DIMS (a ragged last slab) with Lq != Lk (``check_flash_exp``
    holds its bf16 exponent)."""
    g = torch.Generator(device="cuda").manual_seed(17)
    b, l, h = WIDE_FLASH_SHAPE
    max_err, shapes = 0.0, []
    for d in WIDE_FLASH_DIMS:
        base = [torch.randn(b, l, h, d, generator=g, device="cuda") for _ in range(3)]
        for name in ("bf16", "fp32"):
            q, k, v = (t.to(dtype_of(torch, name)) for t in base)
            for static in (True, False):
                err, ref_max = compare_flash(torch, fa, f"wide d={d} {name} B={b} L={l} H={h}",
                                             q, k, v, static, False, TOL[name])
                max_err = max(max_err, err)
            row = time_flash_row(torch, fa, F, q, k, v, {"D": d, "B": b, "L": l, "H": h,
                                                         "dtype": name, "ref_max": ref_max})
            print(f"flash wide d={d} {name} B={b} L={l} H={h}: kernel_ms {row['ms']:.4f}, "
                  f"plain_ms {row['plain_ms']:.3f}, library_ms (SDPA {name}) "
                  f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.5f} ({row['bound_by']}); "
                  f"{rates_text(row)}", flush=True)
            shapes.append(row)
    max_err = max(max_err, check_flash_edges(torch, fa, g, "wide", WIDE_EDGE_DIMS,
                                             WIDE_EDGE_SHAPE))
    return {"max_abs_err": max_err, "shapes": shapes}


def check_flash_many_heads(torch, fa, F) -> dict:
    """B * H = 65,536 + 70 on the wgmma kernel (bf16, d = 64), the fp32
    d = 512 kernel, the generic ones (bf16 d = 16 and 136, fp32 d = 24) and
    the one above 512 (bf16 d = 520): every (b, h) against the plain
    version, timed with its bound and SDPA."""
    g = torch.Generator(device="cuda").manual_seed(18)
    b, h = MANY_HEADS
    max_err, shapes = 0.0, []
    for d, name, l in MANY_HEADS_CASES:
        dtype = dtype_of(torch, name)
        q, k, v = (torch.randn(b, l, h, d, generator=g, device="cuda").to(dtype)
                   for _ in range(3))
        err, ref_max = compare_flash(torch, fa, f"B*H={b * h} d={d} {name} L={l}", q, k, v,
                                     True, False, TOL[name])
        max_err = max(max_err, err)
        row = {"D": d, "B": b, "H": h, "L": l, "dtype": name, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: fa.flash_attention(q, k, v), iters=5, warmup=1)
        row["plain_ms"] = time_ms(torch, lambda: fa.flash_attention_plain(q, k, v), iters=3,
                                  warmup=1)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        row["library_ms"] = library_ms(torch, lambda: F.scaled_dot_product_attention(qh, kh, vh),
                                       f"SDPA at B*H={b * h} d={d}")
        del qh, kh, vh
        flops = 4 * b * h * l * l * d
        peak = H100_BF16_FLOPS if name == "bf16" else H100_FP32_FLOPS
        row["bound_ms"], row["bound_by"] = bound(flops, 4 * b * h * l * d * q.element_size(),
                                                 peak)
        add_shares(row)
        print(f"flash B*H={b * h} d={d} {name} L={l}: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (SDPA) {row['library_ms']}, bound_ms "
              f"{row['bound_ms']:.5f} ({row['bound_by']}); {shares_text(row, 'SDPA')}",
              flush=True)
        shapes.append(row)
        del q, k, v
        torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "shapes": shapes}


def check_group_norm_wide(torch, nk, F) -> dict:
    """GroupNorm+SiLU past the kernel's old limits (GN_WIDE_CASES: C > 4096 in
    channel tiles, G > 256, N > 65,535), bf16 with bf16 weights, against the
    plain version (one bf16 ulp), the same bits on a second call, timed with
    its bound and F.group_norm + F.silu."""
    from vdpp_tpu_torch.ops.normalization import Norm

    g = torch.Generator(device="cuda").manual_seed(19)
    max_err, shapes = 0.0, []
    for n, rows, c, groups in GN_WIDE_CASES:
        norm = Norm(c, device="cuda", dtype=torch.bfloat16)
        norm.weight.copy_(1.0 + 0.2 * torch.randn(c, generator=g, device="cuda"))
        norm.bias.copy_(0.1 * torch.randn(c, generator=g, device="cuda"))
        x = (3.0 * torch.randn(n, rows, c, generator=g, device="cuda")).to(torch.bfloat16)
        before = nk.launches
        got = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
        again = nk.group_norm_silu_fused(x, norm, groups, 1e-6)
        torch.cuda.synchronize()
        if nk.launches != before + 2:
            fail("the GroupNorm+SiLU wrapper did not count its launches")
        ref = nk.group_norm_silu_fused_plain(x, norm, groups, 1e-6)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max)
        print(f"gn_silu N={n} S={rows} C={c} G={groups}: max|diff| {err:.3g}, max|plain| "
              f"{ref_max:.3g}, limit {tol:.3g}; the same bits twice: {torch.equal(got, again)}",
              flush=True)
        if not math.isfinite(err) or err > tol or not torch.equal(got, again):
            fail(f"gn_silu N={n} C={c} G={groups}: max|diff| {err} > {tol}, or other bits on a "
                 "second call")
        max_err = max(max_err, err)
        row = {"N": n, "S": rows, "C": c, "G": groups, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: nk.group_norm_silu_fused(x, norm, groups, 1e-6))
        row["plain_ms"] = time_ms(torch, lambda: nk.group_norm_silu_fused_plain(x, norm, groups,
                                                                                 1e-6),
                                  iters=3, warmup=1)
        xc = x.transpose(1, 2).contiguous()  # channels-first copy, not timed
        row["library_ms"] = library_ms(
            torch, lambda: F.silu(F.group_norm(xc, groups, norm.weight, norm.bias, 1e-6)),
            f"F.group_norm at N={n} C={c} G={groups}")
        elems = n * rows * c
        row["bound_ms"], row["bound_by"] = bound(8 * elems, 2 * elems * 2, H100_FP32_FLOPS)
        add_shares(row)
        print(f"gn_silu N={n} S={rows} C={c} G={groups}: kernel_ms {row['ms']:.4f}, plain_ms "
              f"{row['plain_ms']:.3f}, library_ms (F.group_norm + F.silu, channels-first) "
              f"{row['library_ms']}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{shares_text(row, 'the library')}", flush=True)
        shapes.append(row)
    return {"max_abs_err": max_err, "shapes": shapes}


def fused_chunks(torch, g, shape: tuple, heads_dim: tuple, dtype):
    """q, k, v as VDPP_FUSE_QKV=1 leaves them: the chunks of one projection of
    ``shape[:-1] + (3 C,)``, each reshaped to ``heads_dim`` (strided views)."""
    qkv = torch.randn(*shape[:-1], 3 * shape[-1], generator=g, device="cuda").to(dtype)
    return [t.reshape(heads_dim) for t in qkv.chunk(3, dim=-1)]


def check_fused_qkv_kernels(torch, fa, ta, F) -> dict:
    """The fused projection's strided chunks at the models' sites: flash
    (FUSED_FLASH_CASES) and frame attention (FUSED_FRAME_CASES) read them in
    place (no copy), bit-equal to the contiguous operands, against the plain
    version; the kernel timed on the strided and on contiguous operands,
    with its bound, the plain version and SDPA."""
    g = torch.Generator(device="cuda").manual_seed(20)
    out = {"flash": [], "frame": []}
    errs = {"flash": 0.0, "frame": 0.0}
    for what, b, l, h, d, name in FUSED_FLASH_CASES:
        q, k, v = fused_chunks(torch, g, (b, l, h * d), (b, l, h, d), dtype_of(torch, name))
        copies = fa.copies
        err, ref_max = compare_flash(torch, fa, f"fused QKV {what} d={d} {name}", q, k, v, True,
                                     False, TOL[name])
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        same = torch.equal(fa.flash_attention(q, k, v), fa.flash_attention(qc, kc, vc))
        if fa.copies != copies or not same:
            fail(f"flash fused QKV {what}: {fa.copies - copies} copies, bit-equal to contiguous "
                 f"operands {same}")
        errs["flash"] = max(errs["flash"], err)
        row = time_flash_row(torch, fa, F, q, k, v, {"site": what, "B": b, "L": l, "H": h,
                                                     "D": d, "dtype": name, "ref_max": ref_max})
        row["contiguous_ms"] = time_ms(torch, lambda: fa.flash_attention(qc, kc, vc), iters=5,
                                       warmup=1)
        print(f"flash fused QKV {what} (B={b}, L={l}, H={h}, d={d}, {name}): kernel_ms "
              f"{row['ms']:.4f} on the strided chunks, {row['contiguous_ms']:.4f} on contiguous "
              f"copies; plain_ms {row['plain_ms']:.3f}, library_ms (SDPA) "
              f"{row['library_ms']:.4f}, bound_ms {row['bound_ms']:.4f} ({row['bound_by']}); "
              f"{rates_text(row)}", flush=True)
        out["flash"].append(row)
    for what, b, f, l, h, d in FUSED_FRAME_CASES:
        q, k, v = fused_chunks(torch, g, (b * f, l, h * d), (b, f, l, h, d), torch.bfloat16)
        copies = ta.copies
        got = ta.frame_attention(q, k, v)
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        same = torch.equal(got, ta.frame_attention(qc, kc, vc))
        ref = ta.frame_attention_plain(q, k, v)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = bf16_ulp(ref_max)
        print(f"frame attention fused QKV {what} (F={f}, L={l}, H={h}, d={d}): max|diff| "
              f"{err:.3g}, limit {tol:.3g}; bit-equal to contiguous operands {same}, copies "
              f"{ta.copies - copies}", flush=True)
        if not math.isfinite(err) or err > tol or not same or ta.copies != copies:
            fail(f"frame attention fused QKV {what}: max|diff| {err} > {tol}, bit-equal {same}, "
                 f"{ta.copies - copies} copies")
        errs["frame"] = max(errs["frame"], err)
        row = {"site": what, "B": b, "F": f, "L": l, "H": h, "D": d, "ref_max": ref_max}
        row["ms"] = time_ms(torch, lambda: ta.frame_attention(q, k, v))
        row["contiguous_ms"] = time_ms(torch, lambda: ta.frame_attention(qc, kc, vc))
        row["plain_ms"] = time_ms(torch, lambda: ta.frame_attention_plain(q, k, v), iters=3,
                                  warmup=1)
        qt, kt, vt = (t.permute(0, 2, 3, 1, 4).reshape(b * l, h, f, d).contiguous()
                      for t in (q, k, v))
        row["library_ms"] = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt))
        row["bound_ms"], row["bound_by"] = bound(b * l * h * 4 * f * f * d,
                                                 4 * b * f * l * h * d * 2, H100_BF16_FLOPS)
        add_shares(row)
        print(f"frame attention fused QKV {what}: kernel_ms {row['ms']:.4f} strided, "
              f"{row['contiguous_ms']:.4f} contiguous; plain_ms {row['plain_ms']:.3f}, "
              f"library_ms (SDPA on a copy) {row['library_ms']:.4f}, bound_ms "
              f"{row['bound_ms']:.4f} ({row['bound_by']}); {shares_text(row, 'SDPA')}",
              flush=True)
        out["frame"].append(row)
    return {f"fused_{kind}": {"max_abs_err": errs[kind], "shapes": out[kind]}
            for kind in ("flash", "frame")}


def check_variants(torch, fa, nk, ta, F) -> dict:
    """Phase 3's part for the last variants and the fused QKV layout."""
    t0 = time.perf_counter()
    res = {"wide": check_flash_wide(torch, fa, F),
           "many_heads": check_flash_many_heads(torch, fa, F),
           "gn_wide": check_group_norm_wide(torch, nk, F),
           **check_fused_qkv_kernels(torch, fa, ta, F)}
    print(f"the kernels' variants checked in {time.perf_counter() - t0:.1f} s", flush=True)
    return res


def same_within(torch, what: str, got, want, tol: float, smi: str) -> dict:
    """max|got - want| against ``tol`` x max|want| (bit-equal noted); fails past it."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    top = want.abs().max().item()
    equal = torch.equal(got, want)
    print(f"{what}: max|fused - unfused| {err:.4g}, max|unfused| {top:.4g}, limit {tol} x "
          f"max = {tol * top:.4g}; bit-equal {equal} ({smi})", flush=True)
    if not math.isfinite(err) or err > tol * top:
        fail(f"{what}: max|fused - unfused| {err} > {tol} x {top}")
    return {"max_abs_diff": err, "max_abs": top, "bit_equal": equal}


def fused_app_run(torch, fa, nk, ta, smi: str, fuse: str) -> dict:
    """One run of the image->video app (``apps.generate_video.run``, in this
    process) with both kernel switches and VDPP_FUSE_QKV=``fuse``: its
    latent (captured from ``StepPipeline.run``), its Y4M's bytes, the
    launches and the copies from the encode on, the TIMING split."""
    import shutil
    import tempfile

    from vdpp_tpu_torch.apps import generate_video
    from vdpp_tpu_torch.parallel.pipeline import StepPipeline

    latents, run = [], StepPipeline.run

    def capture(self, params, inputs, *a, **kw):
        res = run(self, params, inputs, *a, **kw)
        latents.append(res.cpu())
        return res

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_fused_")
    StepPipeline.run = capture
    try:
        with kernel_switches({**SWITCHES, FUSE_SWITCH: fuse}):
            reset_counts(fa, nk, ta)
            copies = (fa.copies, ta.copies)
            t0 = time.perf_counter()
            ranks = generate_video.run(["--random-weights", "--steps", str(APP_STEPS),
                                        "--device", "cuda", "--num-stages", "1",
                                        "--output-dir", out_dir])
            wall = time.perf_counter() - t0
            counts = {"flash": dict(fa.launches), "gn": nk.launches, "frame": ta.launches,
                      "copies": fa.copies - copies[0] + ta.copies - copies[1]}
        if not ranks or len(latents) != 1:
            fail(f"the image->video app with {FUSE_SWITCH}={fuse} gave no result")
        y4m = next(os.path.join(out_dir, n) for n in os.listdir(out_dir) if n.endswith(".y4m"))
        with open(y4m, "rb") as fh:
            video = fh.read()
        frames = y4m_frames(y4m)
    finally:
        StepPipeline.run = run
        shutil.rmtree(out_dir, ignore_errors=True)
    timing = ranks[0]["timing"]
    print(f"(13a) image->video app, {FUSE_SWITCH}={fuse}, both kernel switches: {wall:.2f} s, "
          f"TIMING {timing}, launches {counts}, y4m {frames} ({smi})", flush=True)
    if frames != (APP_FRAMES, APP_W, APP_H):
        fail(f"the app with {FUSE_SWITCH}={fuse} wrote {frames}")
    return {"latent": latents[0], "video": video, "counts": counts, "timing": timing,
            "wall_s": wall}


def run_fused_qkv(torch, bench, fa, nk, ta, smi: str) -> dict:
    """Phase 13: the fused-QKV paths at full width, each against the same run
    with VDPP_FUSE_QKV=0 (within TOL["bf16"] x max, bit-equal where cuBLAS
    picks the same GEMM for the 3C-wide product), with the unfused run's
    launches and no copy, each run in FUSE_ORDER (the times in turns): (a)
    the image->video app (SVD-XT bf16 with both
    kernel switches, 14 frames of 72x128, CFG 3, APP_STEPS Euler steps, CLIP
    and the fp32 VAE encode and decode, whose mid-block attention fuses with
    its bias: d = 512 at the fused k and v); (b) DiT-XL joint3d bf16, 8 frames
    of 40x64, STEPS steps, a random context (d = 72)."""
    from vdpp_tpu_torch.models.dit import DiTVideoConfig

    t0 = time.perf_counter()
    res: dict = {"svd_app": {}, "dit_joint3d": {}}
    order = [(fuse, fused_app_run(torch, fa, nk, ta, smi, fuse)) for fuse in FUSE_ORDER]
    runs = dict(order[:2])  # the first of each
    forwards = 2 * APP_STEPS
    want = {"flash": FLASH_PER_APP, "gn": GN_SILU_PER_FORWARD * forwards,
            "frame": FRAME_ATTN_PER_FORWARD * forwards, "copies": 0}
    for fuse, r in order:
        for key, n in want.items():
            if key == "flash":
                for d, nd in n.items():
                    expect(f"(13a) flash at d = {d}, {FUSE_SWITCH}={fuse}", r["counts"]["flash"]
                           .get(d, 0), nd)
            elif key == "copies":
                print(f"(13a) operand copies, {FUSE_SWITCH}={fuse}: {r['counts']['copies']}")
                if r["counts"]["copies"]:
                    fail(f"(13a) {r['counts']['copies']} operand copies with {FUSE_SWITCH}={fuse}")
            else:
                expect(f"(13a) {key}, {FUSE_SWITCH}={fuse}", r["counts"][key], n)
    import numpy as np

    a, b = (np.frombuffer(runs[f]["video"], np.uint8).astype(np.int16) for f in ("0", "1"))
    levels = int(np.abs(a - b).max()) if a.shape == b.shape else None
    print(f"(13a) the videos' bytes: equal {runs['0']['video'] == runs['1']['video']}, max "
          f"|fused - unfused| {levels} levels of 255 (limit {TOL['bf16']} x 255)", flush=True)
    if levels is None or levels > TOL["bf16"] * 255:
        fail(f"(13a) the fused run's video differs by {levels} levels")
    res["svd_app"] = {
        "latent": same_within(torch, "(13a) SVD-XT latent", runs["1"]["latent"],
                              runs["0"]["latent"], TOL["bf16"], smi),
        "video_levels": levels, "counts": {f: r["counts"] for f, r in runs.items()},
        "diffusion_s": [(f, r["timing"]["diffusion"]) for f, r in order],
        "wall_s": [(f, r["wall_s"]) for f, r in order]}
    print(f"(13a) the app's diffusion seconds in turns: {res['svd_app']['diffusion_s']} ({smi})")

    g = torch.Generator(device="cuda").manual_seed(3)
    ctx = torch.randn(1, DIT_CTX_TOKENS, 4096, generator=g, device="cuda").to(torch.bfloat16)
    config = dataclasses.replace(DiTVideoConfig.latte_xl(), cross_attention_dim=4096,
                                 attention_mode="joint3d")
    order = []
    forwards = 2 * STEPS * (VIDEOS + 1)
    for fuse in FUSE_ORDER:
        with kernel_switches({FUSE_SWITCH: fuse}):
            reset_counts(fa, nk, ta)
            copies = fa.copies
            r = run_dit_path(torch, bench, config, ctx, smi, f"(13b) joint3d, {FUSE_SWITCH}={fuse}")
            expect(f"(13b) flash at d = 72, {FUSE_SWITCH}={fuse}", fa.launches[72],
                   FLASH_PER_JOINT3D_FORWARD * forwards)
            r["flash"] = fa.launches[72]
            if fa.copies != copies:
                fail(f"(13b) {fa.copies - copies} operand copies with {FUSE_SWITCH}={fuse}")
        order.append((fuse, r))
    dit = dict(order[:2])
    res["dit_joint3d"] = {
        "latent": same_within(torch, "(13b) DiT-XL joint3d latent", dit["1"]["latent"],
                              dit["0"]["latent"], TOL["bf16"], smi),
        "sec_per_step": [(f, r["sec_per_step"]) for f, r in order],
        "flash": {f: r["flash"] for f, r in dit.items()}}
    print(f"(13b) DiT-XL joint3d s/step in turns: {res['dit_joint3d']['sec_per_step']} ({smi})")
    print(f"phase 13 (fused QKV) done in {time.perf_counter() - t0:.1f} s ({smi})", flush=True)
    return res


def reset_counts(fa, nk, ta) -> None:
    """Every kernel's launch count set to 0."""
    fa.launches.clear()
    nk.launches = ta.launches = 0


# The launches of the kernels' variants that no model reaches
# (``utils.kernels.variant_launches``: d > 512, B * H > 65,535, GroupNorm past
# its old limits) in the processes the model phases spawn, added up as their
# counts come back. This process's own are in the wrappers' counters, which
# only grow and are set to 0 once, before the first model phase.
SPAWNED_VARIANTS = {"flash_wide": 0, "flash_many_heads": 0, "group_norm_silu_wide": 0}
# The spawned processes of the model phases that report no launch counts.
UNCOUNTED_SPAWNS = ["phase 7 (b), (c): the benchmark modes' ranks",
                    "phase 10 (c): the text->video app's 2 seq ranks",
                    "phase 11: the benchmark modes' MoE and int8 ranks",
                    "phase 12: the servers' warm-ups"]


def spawned(ranks: list) -> list:
    """``ranks`` (each a spawned process's result or launch counts) as they
    are, after adding each one's ``"variants"`` to SPAWNED_VARIANTS."""
    for r in ranks:
        if "variants" not in r:
            fail(f"a spawned process reported no variant launches: {sorted(r)}")
        for key, n in r["variants"].items():
            SPAWNED_VARIANTS[key] += n
    return ranks


def expect(what: str, got: int, want: int) -> None:
    print(f"{what}: {got} launches (expected {want})")
    if got != want:
        fail(f"{what}: {got} launches, expected {want}")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description="On-card smoke test of the port, one GPU.")
    parser.add_argument("--kernels-only", action="store_true",
                        help="build the kernels, hold each against its plain version and time "
                             "it (phases 1-3 and 8 (a)), then stop without the result lines")
    parser.add_argument("--moe-int8-only", action="store_true",
                        help="build the kernels, then only phase 11 (the MoE DiT-XL with its "
                             "expert axis, int8 SVD-XT, the benchmark's MoE and int8 flags), "
                             "and stop without the result lines")
    parser.add_argument("--serve-only", action="store_true",
                        help="build the kernels, then only phase 12 (the server at SVD-XT width "
                             "at one stage and with a decode rank, and the tiny DiT server), and "
                             "stop without the result lines")
    parser.add_argument("--variants-only", action="store_true",
                        help="build the kernels, then only the kernels' last variants (d > 512, "
                             "B*H > 65,535, GroupNorm past C = 4096, G = 256, N = 65,535, the "
                             "fused QKV layout) and phase 13 (the fused-QKV paths), and stop "
                             "without the result lines")
    parser.add_argument("--intra-only", action="store_true",
                        help="build the kernels, then only phases 9 and 10 (the kernels at the "
                             "seq-sharded shapes, the intra-sample axes at full width, the "
                             "planner and the decode ranks), and stop without the result lines")
    args = parser.parse_args(argv)
    try:
        import torch
        import torch.nn.functional as F
    except ImportError as e:
        fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    try:
        from vdpp_tpu_torch import bench
        from vdpp_tpu_torch.models.dit import DiTVideoConfig
        from vdpp_tpu_torch.models.svd_unet import SVDUNetConfig
        from vdpp_tpu_torch.models.t5_encoder import T5EncoderConfig
        from vdpp_tpu_torch.models.vae import VAEConfig
        from vdpp_tpu_torch.ops import flash_attention as fa
        from vdpp_tpu_torch.ops import norm_kernel as nk
        from vdpp_tpu_torch.ops import temporal_attention_kernel as ta
        from vdpp_tpu_torch.utils import kernels
        from vdpp_tpu_torch.utils.device import resolve_device
    except ImportError as e:
        fail(f"the vdpp_tpu_torch package is not beside this script: {e}")

    t_start = time.perf_counter()
    resolve_device("cuda")  # full-fp32 matmuls and convolutions, no TF32
    name = torch.cuda.get_device_name(0)
    smi = bench.nvidia_smi_line()
    print(f"device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    built = kernels.build()
    print(f"build: {len(built)} kernel source(s) in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(kernels.NVCC_FLAGS)})")
    for src, info in built.items():
        print(f"  {src}: {info['path']} ({info['seconds']:.1f} s)")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    ptxas = ptxas_report(built["flash_attention"]["log"])
    lib = fa._kernel_lib()
    for kname, r in ptxas.items():
        # (head dim, bf16) of a call that launches the kernel: flash_fwd_any's
        # template argument is d rounded up (at most 128: producer and
        # consumer warpgroups), flash_fwd_any_f32's a width class.
        d = re.match(r"flash_fwd_(bf16|any)<(\d+)", kname)
        f32 = re.match(r"flash_fwd_any_f32<(\d+)", kname)
        dims = {"flash_fwd_d512_bf16": (512, 1), "flash_fwd_d512_f32": (512, 0),
                "flash_fwd_wide": (1024, 1), "flash_fwd_wide_f32": (1024, 0)}
        d_bf16 = ((int(d.group(2)), 1) if d else (int(f32.group(1)) // 2 + 1, 0) if f32
                  else dims.get(kname.split("<")[0]))
        producer = d and (d.group(1) == "bf16" or int(d.group(2)) <= 128)
        r["dynamic_smem"] = lib.vdpp_flash_attention_smem(*d_bf16) if d_bf16 else None
        print(f"ptxas {kname}: {r.get('registers')} registers"
              + (" at launch (setmaxnreg: consumer warpgroups 240, producer 24)" if producer
                 else "")
              + f", {r.get('spill_stores')} B spill stores, {r.get('spill_loads')} B spill loads, "
              f"{r.get('static_smem')} B static shared memory"
              + (f", {r['dynamic_smem']} B dynamic shared memory per CTA" if d_bf16 else ""))
    for new in ("flash_fwd_d512_bf16", "flash_fwd_d512_f32", "flash_fwd_any<", "flash_fwd_any_f32",
                "flash_fwd_wide<", "flash_fwd_wide_f32"):
        if built["flash_attention"]["seconds"] and not any(k.startswith(new) for k in ptxas):
            fail(f"no ptxas report for {new}")
    if not ptxas:
        print("ptxas: no report (the flash library was built before this run)")
    frame_lib = ta._kernel_lib()
    other_ptxas = {src: ptxas_report(built[src]["log"], src)
                   for src in ("frame_attention", "group_norm_silu")}
    for src, report in other_ptxas.items():
        for kname, r in report.items():
            d = re.match(r"frame_attn_tma<(\d+)", kname)
            r["dynamic_smem"] = frame_lib.vdpp_frame_attention_smem(int(d.group(1))) if d else None
            print(f"ptxas {kname}: {r.get('registers')} registers, {r.get('spill_stores')} B "
                  f"spill stores, {r.get('spill_loads')} B spill loads, {r.get('static_smem')} B "
                  f"static shared memory"
                  + (f", {r['dynamic_smem']} B dynamic shared memory per CTA" if d else ""))
        if built[src]["seconds"] and not report:
            fail(f"no ptxas report for {src}.cu")

    if args.moe_int8_only:
        run_phase11(torch, fa, nk, ta, smi)
        print(f"phase 11 run done in {time.perf_counter() - t_start:.1f} s ({smi})")
        return 0
    if args.serve_only:
        run_phase12(torch, smi)
        print(f"phase 12 run done in {time.perf_counter() - t_start:.1f} s ({smi})")
        return 0
    if args.variants_only:
        check_variants(torch, fa, nk, ta, F)
        run_fused_qkv(torch, bench, fa, nk, ta, smi)
        print(f"variants and phase 13 done in {time.perf_counter() - t_start:.1f} s ({smi})")
        return 0
    if args.intra_only:
        check_flash_seq_sharded(torch, fa, F)
        run_intra_sample(torch, smi)
        t10 = time.perf_counter()
        check_dit_sharded_kernels(torch, fa, ta, F)
        run_dit_intra(torch, smi)
        run_dit_intra_apps(torch, smi)
        print(f"phase 10 (the DiT's axes, the planner, the decode ranks) done in "
              f"{time.perf_counter() - t10:.1f} s ({smi})")
        print(f"intra-sample phases done in {time.perf_counter() - t_start:.1f} s ({smi})")
        return 0
    t_lap = [time.perf_counter()]

    def lap(what: str) -> None:  # where the script's time goes
        now = time.perf_counter()
        print(f"{what} done in {now - t_lap[0]:.1f} s ({smi})", flush=True)
        t_lap[0] = now

    flash = check_flash(torch, fa, F)
    flash512 = check_flash_512(torch, fa, F, torch.float32)
    flash512_bf16 = check_flash_512(torch, fa, F, torch.bfloat16)
    gn = check_group_norm(torch, nk, F)
    frame = check_frame_attention(torch, ta, F)
    flash72 = check_flash_72(torch, fa, F)
    flash_seq = check_flash_seq_sharded(torch, fa, F)
    frame72 = check_frame_attention_72(torch, ta, F)
    dit_kernels = check_dit_sharded_kernels(torch, fa, ta, F)
    # (a) The generic flash kernel, the bf16 exponent, the generic frame
    # attention.
    flash_generic = check_flash_generic(torch, fa, F)
    flash_exp = check_flash_exp(torch, fa, F)
    frame_generic = check_frame_generic(torch, ta, F)
    # The last variants: d > 512, B*H > 65,535, GroupNorm past its old
    # limits, and the fused QKV projection's strided chunks.
    variants = check_variants(torch, fa, nk, ta, F)
    lap("the kernel checks (phases 1-3, 8 (a), the variants)")
    if args.kernels_only:
        print(f"kernel phases done in {time.perf_counter() - t_start:.1f} s ({smi})")
        return 0
    # Every launch from here on is a model phase's: the variants' counters
    # start from 0.
    fa.variant_launches.clear()
    nk.wide_launches = 0
    check_agreement(torch, switches=False)
    check_agreement(torch, switches=True)
    check_vae_agreement(torch, fa)
    check_dit_agreement(torch, fa, ta)
    check_encoder_agreement(torch, fa)
    # (b) The tiny configs (head dim 16) on the card.
    tiny = check_tiny_models(torch, fa, nk, ta)
    lap("the agreement checks and the tiny configs (8 (b))")

    forwards = 2 * STEPS * (VIDEOS + 1)
    reset_counts(fa, nk, ta)
    run_main_path(torch, bench, SVDUNetConfig.svd_xt(), smi, "as it is")
    flash_launches = fa.launches.total()
    expect(f"flash on the main path ({forwards} UNet forwards)", flash_launches,
           FLASH_PER_FORWARD * forwards)
    expect("GroupNorm+SiLU on the main path as it is", nk.launches, 0)
    expect("frame attention on the main path as it is", ta.launches, 0)

    with kernel_switches():
        reset_counts(fa, nk, ta)
        res = run_main_path(torch, bench, SVDUNetConfig.svd_xt(), smi,
                            "with VDPP_GN_FUSED=1 VDPP_TEMPORAL_ATTN=pallas")
        switched = {"flash": fa.launches.total(), "gn": nk.launches, "frame": ta.launches}
    expect(f"flash on the switched path ({forwards} UNet forwards)", switched["flash"],
           FLASH_PER_FORWARD * forwards)
    expect("GroupNorm+SiLU on the switched path", switched["gn"], GN_SILU_PER_FORWARD * forwards)
    expect("frame attention on the switched path", switched["frame"],
           FRAME_ATTN_PER_FORWARD * forwards)

    reset_counts(fa, nk, ta)
    dec = bench.measure_decode(res["latent"])
    decode_flash = fa.launches.total()
    print(f"decode: temporal VAE decoder fp32, 25 frames in chunks of 4: {dec['sec']:.3f} s, "
          f"video {dec['shape']}, finite {dec['finite']}, peak allocated "
          f"{dec['peak_mem_bytes'] / 2**30:.2f} GiB ({smi})")
    expect("flash at d = 512 in the decode", decode_flash, FLASH_PER_DECODE)
    expect("GroupNorm+SiLU in the decode", nk.launches, 0)
    if dec["shape"] != (1, 25, 576, 1024, 3) or not dec["finite"]:
        fail(f"decode gave shape {dec['shape']}, finite {dec['finite']}")

    # The same latent through the bf16 decoder (VAEConfig.svd(torch.bfloat16),
    # the JAX scripts' --vae-dtype bfloat16): its mid-block attention takes the
    # flash kernel at d = 512 in bf16.
    reset_counts(fa, nk, ta)
    dec16 = bench.measure_decode(res["latent"], config=VAEConfig.svd(torch.bfloat16))
    decode16_flash = fa.launches.total()
    print(f"decode: temporal VAE decoder bf16, 25 frames in chunks of 4: {dec16['sec']:.3f} s, "
          f"video {dec16['shape']}, finite {dec16['finite']}, peak allocated "
          f"{dec16['peak_mem_bytes'] / 2**30:.2f} GiB ({smi})")
    expect("flash at d = 512 in bf16 in the bf16 decode", decode16_flash, FLASH_PER_DECODE)
    if dec16["shape"] != (1, 25, 576, 1024, 3) or not dec16["finite"]:
        fail(f"the bf16 decode gave shape {dec16['shape']}, finite {dec16['finite']}")

    # The text->video path: T5-XXL encode (then freed), DiT-XL joint3d, then
    # factorized with frame attention switched on, then the decode.
    t5_cfg = T5EncoderConfig.xxl()
    enc = bench.encode_prompt(t5_cfg, device="cuda")
    ctx = enc["context"]
    print(f"encode: T5-v1.1-XXL bf16, {enc['tokens']} tokens: {enc['sec']:.3f} s, context "
          f"{tuple(ctx.shape)}, finite {bool(torch.isfinite(ctx).all())} ({smi})")
    if tuple(ctx.shape) != (1, enc["tokens"], t5_cfg.d_model) or not torch.isfinite(ctx).all():
        fail(f"the T5-XXL encode gave shape {tuple(ctx.shape)} or non-finite values")
    dit_xl = dataclasses.replace(DiTVideoConfig.latte_xl(), cross_attention_dim=t5_cfg.d_model)
    reset_counts(fa, nk, ta)
    run_dit_path(torch, bench, dataclasses.replace(dit_xl, attention_mode="joint3d"), ctx, smi,
                 "joint3d")
    joint = {"flash": fa.launches.total(), "frame": ta.launches}
    expect(f"flash at d = 72 on the joint3d path ({forwards} DiT forwards)", joint["flash"],
           FLASH_PER_JOINT3D_FORWARD * forwards)
    expect("frame attention on the joint3d path", joint["frame"], 0)
    with kernel_switches(TEMPORAL_SWITCH):
        reset_counts(fa, nk, ta)
        dit_res = run_dit_path(torch, bench, dataclasses.replace(dit_xl,
                                                                 attention_mode="factorized"),
                               ctx, smi, "factorized with VDPP_TEMPORAL_ATTN=pallas")
        fact = {"flash": fa.launches.total(), "frame": ta.launches}
    expect(f"flash at d = 72 on the factorized path ({forwards} DiT forwards)", fact["flash"],
           FLASH_PER_FACTORIZED_FORWARD * forwards)
    expect("frame attention at d = 72 on the factorized path", fact["frame"],
           FRAME_ATTN_PER_FACTORIZED_FORWARD * forwards)
    expect("GroupNorm+SiLU on the DiT paths", nk.launches, 0)
    fa.launches.clear()
    dit_dec = bench.measure_decode(dit_res["latent"])
    dit_decode_flash = fa.launches.total()
    print(f"decode: temporal VAE decoder fp32, {DIT_FRAMES} frames in chunks of 4: "
          f"{dit_dec['sec']:.3f} s, video {dit_dec['shape']}, finite {dit_dec['finite']}, peak "
          f"allocated {dit_dec['peak_mem_bytes'] / 2**30:.2f} GiB ({smi})")
    expect("flash at d = 512 in the text->video decode", dit_decode_flash, FLASH_PER_DIT_DECODE)
    if dit_dec["shape"] != (1, DIT_FRAMES, 320, 512, 3) or not dit_dec["finite"]:
        fail(f"the text->video decode gave shape {dit_dec['shape']}, finite "
             f"{dit_dec['finite']}")

    lap("the main paths, their decodes and text->video")
    # The image->video app: CLIP and VAE encode, the SVD-XT denoise, the decode.
    app = run_app(torch, fa, nk, ta, smi)
    # (c) The restyle app on the Y4M the image->video app wrote; (d) the long
    # app, two segments at DeepCache-2.
    from vdpp_tpu_torch.apps import generate_video_long, restyle_video

    try:
        restyle = run_entry_point(
            torch, fa, nk, ta, smi, "restyle app", restyle_video.main,
            ["--input", app["y4m"], "--random-weights", "--strength", str(RESTYLE_STRENGTH),
             "--steps", str(RESTYLE_STEPS)], APP_FRAMES, FLASH_PER_RESTYLE)
    finally:
        os.remove(app["y4m"])
    long_app = run_entry_point(
        torch, fa, nk, ta, smi, "long app", generate_video_long.main,
        ["--random-weights", "--segments", str(LONG_SEGMENTS), "--steps", str(LONG_STEPS),
         "--deepcache", "2"], APP_FRAMES + (LONG_SEGMENTS - 1) * (APP_FRAMES - 1),
        FLASH_PER_LONG)

    lap("the apps")
    # (a) DeepCache: the full branch against forward, the launches of each
    # kind of forward, the fast path's composition and each step's time.
    deepcache = run_deepcache(torch, fa, nk, ta, smi)

    # The step pipeline, one process per stage, with Euler and dpmpp2m (whose
    # 8-channel payload carries the solver's state across the hand-off), and
    # (b) euler_a and dpmpp2m at DeepCache-2, whose cache crosses it too.
    pipes = {solver + (f"_deepcache{interval}" if interval else ""):
             run_pipeline(torch, smi, solver, interval) for solver, interval in PIPE_CASES}

    def pipe_launches(key, get=lambda c: c):
        return {f"step_pipeline_{case}_rank{r['rank']}": get(r["counts"][key])
                for case, res in pipes.items() for r in res["ranks"]}

    lap("DeepCache and the step pipelines")
    pipe_flash = pipe_launches("flash", lambda c: c.get(64, 0))
    pipe_gn, pipe_frame = pipe_launches("gn"), pipe_launches("frame")

    # 7. The benchmark modes: (a) one stage in this process, counted; (b), (c)
    # the spawned modes.
    modes = run_benchmark_modes(torch, fa, nk, ta, smi)
    bench_counts = modes["counts"]

    # (c) The production mode through its entry point, then snapshot and
    # resume at the API level.
    prod = run_production(torch, fa, nk, ta, smi)
    prod_flash = {f"production_main_rank{r}": c["flash"].get(64, 0)
                  for r, c in enumerate(prod["main"]["launches"])}
    prod_flash.update({f"production_{solver}_{rank}_{run}": c["flash"].get(64, 0)
                       for solver in PROD_SOLVERS
                       for rank, runs in prod["api"][solver]["launches"].items()
                       for run, c in runs.items()})

    lap("the benchmark modes and production (7, 8 (c))")
    # 9. Intra-sample parallelism: seq, frame and cfg ranks inside a stage.
    intra = run_intra_sample(torch, smi)
    lap("phase 9")

    def intra_launches(cases, get):
        return {f"intra_{case}_rank{r}": get(res["launches"])
                for case in cases for r, res in enumerate(intra[case]["per_rank"])}

    intra_seq_flash = intra_launches(("seq2", "stage2_seq2"), lambda c: c["flash"].get(64, 0))
    intra_flash = intra_launches(("frame2", "cfg2", "stage2_cfg2"),
                                 lambda c: c["flash"].get(64, 0))
    intra_frame = intra_launches(("seq2", "cfg2", "stage2_seq2", "stage2_cfg2"),
                                 lambda c: c["frame"])

    # 10. The DiT's seq and cfg axes, the planner and the decode ranks.
    t10 = time.perf_counter()
    dit_intra = run_dit_intra(torch, smi)
    dit_apps = run_dit_intra_apps(torch, smi)
    print(f"phase 10 (the DiT's axes, the planner, the decode ranks) done in "
          f"{time.perf_counter() - t10:.1f} s ({smi})")
    # 11. The MoE DiT with its expert axis, int8 weights and W8A8.
    p11 = run_phase11(torch, fa, nk, ta, smi)
    moe_flash = {f"moe_{k}": v["flash"] for k, v in p11["moe"].items()
                 if isinstance(v, dict) and "flash" in v}
    moe_flash.update({f"moe_{name}_rank{r}": res["flash"].get(72, 0)
                      for name, rs in p11["moe"]["ranks"].items() for r, res in enumerate(rs)})
    int8_counts = {f"svd_xt_{k.lstrip('-')}": v["counts"] for k, v in p11["int8"].items()
                   if isinstance(v, dict) and "counts" in v}
    # 12. Serving: the server at one stage, with a decode rank, the tiny DiT.
    p12 = run_phase12(torch, smi)
    serve_runs = {f"serve_{part}_{proc}": c for part in ("one_stage", "decode_rank")
                  for proc, c in p12[part]["launches"].items() if proc != "server"}
    serve_d64 = {k: c["flash"].get(64, 0) for k, c in serve_runs.items()}
    serve_d512 = {k: c["flash"].get(512, 0) for k, c in serve_runs.items()}
    serve_gn = {k: c["group_norm_silu"] for k, c in serve_runs.items()}
    serve_frame = {k: c["frame_attention"] for k, c in serve_runs.items()}
    serve_tiny = {f"serve_tiny_dit3d_d{d}": n
                  for d, n in p12["tiny_dit3d"]["launches"]["0"]["flash"].items()}
    # 13. The fused-QKV paths against the unfused ones.
    p13 = run_fused_qkv(torch, bench, fa, nk, ta, smi)
    fused_counts = p13["svd_app"]["counts"]["1"]
    fused_flash = {"svd_app_d64": fused_counts["flash"].get(64, 0),
                   "svd_app_d512": fused_counts["flash"].get(512, 0),
                   "dit_joint3d_d72": p13["dit_joint3d"]["flash"]["1"]}

    def dit_launches(cases, get):
        return {f"dit_{case}_rank{r}": get(res["launches"])
                for case in cases for r, res in enumerate(dit_intra[case]["per_rank"])}

    dit_seq_flash = dit_launches(("joint3d_seq2", "joint3d_stage2_seq2", "joint3d_seq2_cfg2"),
                                 lambda c: c["flash"].get(72, 0))
    dit_cfg_flash = dit_launches(("joint3d_cfg2", "joint3d_stage2_cfg2"),
                                 lambda c: c["flash"].get(72, 0))
    dit_frame = dit_launches(("factorized_seq2",), lambda c: c["frame"])
    app_runs = {f"{k}_rank{r}": res["launches"]["flash"]
                for k, v in dit_apps["apps"].items() for r, res in enumerate(v["ranks"])}
    app_d64 = {k: c.get(64, 0) for k, c in app_runs.items()}
    app_d512 = {k: c.get(512, 0) for k, c in app_runs.items()}
    auto_flash = {f"auto_topology_rank{r}": c["flash"].get(64, 0)
                  for r, c in enumerate(dit_apps["auto_topology"]["launches"])}

    def entry(name, source, replaces, launches, check, row, **extra):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": check["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shapes": check["shapes"], **extra}

    print(f"chip_smoke phases done in {time.perf_counter() - t_start:.1f} s")
    here = kernels.variant_launches()

    def variant_paths(key):
        return {"model phases in this process": here[key],
                "the model phases' spawned ranks and servers": SPAWNED_VARIANTS[key]}

    def variant_entry(name, source, replaces, key, check):
        paths = variant_paths(key)
        print(f"{name}: {sum(paths.values())} launches over the model phases {paths}")
        return entry(name, source, replaces, sum(paths.values()), check,
                     check["shapes"][0], launches_by_path=paths,
                     not_counted=UNCOUNTED_SPAWNS)

    flash_src, flash_tpu = ("vdpp_tpu_torch/csrc/flash_attention.cu",
                            "vdpp_tpu/ops/flash_attention.py:233")
    frame_src, frame_tpu = ("vdpp_tpu_torch/csrc/frame_attention.cu",
                            "vdpp_tpu/ops/temporal_attention_kernel.py:80")
    print(json.dumps({"kernels": [
        entry("flash_attention", flash_src, flash_tpu,
              flash_launches + app["flash"][64] + restyle["flash"][64] + long_app["flash"][64]
              + deepcache["schedule"]["flash"] + sum(pipe_flash.values())
              + bench_counts["flash"] + sum(prod_flash.values()) + sum(intra_flash.values())
              + sum(auto_flash.values()) + sum(app_d64.values())
              + sum(c["flash"] for c in int8_counts.values()) + sum(serve_d64.values()),
              flash,
              flash["shapes"][0], ptxas=ptxas,
              fp32_d64_d72=[flash["fp32"], flash72["fp32"]],
              launches_per_forward={"full": deepcache["counts"]["full"][0],
                                    "deepcache_split1": deepcache["counts"]["cache"][0]},
              launches_by_path={"svd_xt_denoise": flash_launches,
                                "image_to_video_app": app["flash"][64],
                                "restyle_app": restyle["flash"][64],
                                "long_app_deepcache2": long_app["flash"][64],
                                "dpmpp2m_deepcache2_switched": deepcache["schedule"]["flash"],
                                **pipe_flash,
                                "benchmark_mode_1stage_switched": bench_counts["flash"],
                                **prod_flash, **intra_flash, **auto_flash,
                                **{f"image_to_video_app_{k}": n for k, n in app_d64.items()},
                                **{k: c["flash"] for k, c in int8_counts.items()},
                                **serve_d64},
              production_launches_per_forward=PROD_FLASH_PER_FORWARD, int8=p11["int8"],
              moe_int8_cli=p11["cli"], serve=p12),
        entry("flash_attention_d512", flash_src, flash_tpu,
              decode_flash + dit_decode_flash + app["flash"][512] + restyle["flash"][512]
              + long_app["flash"][512] + sum(app_d512.values()) + sum(serve_d512.values()),
              flash512,
              flash512["shapes"][0], encoder_site=flash512["shapes"][1],
              launches_by_path={"svd_decode": decode_flash, "dit_decode": dit_decode_flash,
                                "image_to_video_app (1 encoder + 4 decode)":
                                    app["flash"][512],
                                "restyle_app (5 encoder + 4 decode)": restyle["flash"][512],
                                "long_app (2 x (1 encoder + 4 decode))":
                                    long_app["flash"][512],
                                **{f"image_to_video_app_{k} (decode)": n
                                   for k, n in app_d512.items()},
                                **{f"{k} (decode)": n for k, n in serve_d512.items()}}),
        entry("flash_attention_d512_bf16", flash_src, flash_tpu, decode16_flash, flash512_bf16,
              flash512_bf16["shapes"][0]),
        entry("group_norm_silu", "vdpp_tpu_torch/csrc/group_norm_silu.cu",
              "vdpp_tpu/ops/norm_kernel.py:165",
              switched["gn"] + deepcache["schedule"]["gn"] + sum(pipe_gn.values())
              + bench_counts["gn"] + sum(c["gn"] for c in int8_counts.values())
              + sum(serve_gn.values()), gn,
              gn["shapes"][0], ptxas=other_ptxas["group_norm_silu"],
              launches_per_forward={"full": deepcache["counts"]["full"][1],
                                    "deepcache_split1": deepcache["counts"]["cache"][1]},
              launches_by_path={"svd_xt_denoise_switched": switched["gn"],
                                "dpmpp2m_deepcache2_switched": deepcache["schedule"]["gn"],
                                **pipe_gn,
                                "benchmark_mode_1stage_switched": bench_counts["gn"],
                                **{k: c["gn"] for k, c in int8_counts.items()}, **serve_gn}),
        entry("frame_attention", frame_src, frame_tpu,
              switched["frame"] + deepcache["schedule"]["frame"] + sum(pipe_frame.values())
              + bench_counts["frame"] + sum(intra_frame.values())
              + sum(c["frame"] for c in int8_counts.values()) + sum(serve_frame.values()), frame,
              frame["shapes"][0],
              ptxas=other_ptxas["frame_attention"], fp32_d64_d72=frame["fp32"] + frame72["fp32"],
              launches_per_forward={"full": deepcache["counts"]["full"][2],
                                    "deepcache_split1": deepcache["counts"]["cache"][2]},
              launches_by_path={"svd_xt_denoise_switched": switched["frame"],
                                "dpmpp2m_deepcache2_switched": deepcache["schedule"]["frame"],
                                **pipe_frame,
                                "benchmark_mode_1stage_switched": bench_counts["frame"],
                                **intra_frame, **{k: c["frame"] for k, c in int8_counts.items()},
                                **serve_frame}),
        entry("flash_attention_d72", flash_src, flash_tpu,
              joint["flash"] + fact["flash"] + sum(dit_cfg_flash.values())
              + sum(moe_flash.values()),
              flash72, flash72["shapes"][0],
              launches_by_path={"dit_joint3d": joint["flash"], "dit_factorized": fact["flash"],
                                **dit_cfg_flash, **moe_flash},
              moe=p11["moe"]),
        entry("flash_attention_dit_seq_sharded", flash_src, flash_tpu,
              sum(dit_seq_flash.values()), dit_kernels["flash"], dit_kernels["flash"]["shapes"][0],
              launches_by_path=dit_seq_flash,
              launches_per_forward={"joint3d seq2 Lq=2560 Lk=5120": 28}, dit_intra=dit_intra,
              planner_and_decode=dit_apps),
        entry("frame_attention_dit_seq_sharded", frame_src, frame_tpu, sum(dit_frame.values()),
              dit_kernels["frame"], dit_kernels["frame"]["shapes"][0],
              launches_by_path=dit_frame,
              launches_per_forward={"factorized seq2 L=320": 14}),
        entry("flash_attention_seq_sharded", flash_src, flash_tpu,
              sum(intra_seq_flash.values()), flash_seq, flash_seq["shapes"][0],
              launches_by_path=intra_seq_flash,
              launches_per_forward={f"seq2 Lq={lq} Lk={lk}": n
                                    for (lq, lk), n in INTRA_SEQ2_SHAPES.items()},
              intra_sample=intra),
        entry("frame_attention_d72", frame_src, frame_tpu, fact["frame"], frame72,
              frame72["shapes"][0]),
        entry("flash_attention_generic", flash_src, flash_tpu,
              sum(c["flash"] for c in tiny.values()) + sum(serve_tiny.values()), flash_generic,
              next(r for r in flash_generic["shapes"] if r["D"] == 16 and r["dtype"] == "fp32"),
              launches_by_path={**{k: c["flash"] for k, c in tiny.items()}, **serve_tiny}),
        entry("flash_attention_exp_bf16", flash_src, flash_tpu,
              sum(c["flash_exp_bf16"] for c in tiny.values()), flash_exp,
              flash_exp["shapes"][0],
              launches_by_path={k: c["flash_exp_bf16"] for k, c in tiny.items()}),
        entry("frame_attention_generic", frame_src, frame_tpu,
              sum(c["frame"] for c in tiny.values()), frame_generic,
              frame_generic["shapes"][0],
              launches_by_path={k: c["frame"] for k, c in tiny.items()}),
        variant_entry("flash_attention_wide", flash_src, flash_tpu, "flash_wide",
                      variants["wide"]),
        variant_entry("flash_attention_many_heads", flash_src, flash_tpu, "flash_many_heads",
                      variants["many_heads"]),
        variant_entry("group_norm_silu_wide", "vdpp_tpu_torch/csrc/group_norm_silu.cu",
                      "vdpp_tpu/ops/norm_kernel.py:165", "group_norm_silu_wide",
                      variants["gn_wide"]),
        entry("flash_attention_fused_qkv", flash_src, flash_tpu, sum(fused_flash.values()),
              variants["fused_flash"], variants["fused_flash"]["shapes"][0],
              launches_by_path=fused_flash, fused_qkv=p13),
        entry("frame_attention_fused_qkv", frame_src, frame_tpu, fused_counts["frame"],
              variants["fused_frame"], variants["fused_frame"]["shapes"][0],
              launches_by_path={"svd_app": fused_counts["frame"]}),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
