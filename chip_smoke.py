#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run by raising:
  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
  2. hold each kernel against its plain PyTorch version on the card
     (the cases of tests/test_kernels.py and the main path's shapes; bf16
     outputs against the fp32 result of the same bf16 inputs; each path of
     a kernel that has two, such as the SSD scan's wgmma and FMA kernels;
     flash at head dim 192, fp32 and bf16: nemotron-4-340b's prefill shape
     FLASH_NEMOTRON in the model's views and FLASH_HD192_CASES around the
     64-row kv tiles, S 1, 127, 200 and 300, each causal, with a window and
     non-causal; RMSNorm at every main-path shape of each served model,
     nemotron's H 18432 included);
  3. serve full-width yi-6b, mamba2-2.7b, hymba-1.5b and
     granite-moe-3b-a800m in turn (random bf16 weights from a seed),
     through the port's entry points: prefill B=2 S=2000 with its kernel
     launches counted, the bf16 model's logits through the kernels against
     its logits through the plain versions, a teacher-forced forward/decode
     check (hymba past its 1024-slot KV ring, granite-moe drop-free),
     greedy generation and a few serve steps; then the embeds-input archs:
     hubert-xlarge at all 48 layers (an encoder: non-causal flash at head
     dim 80, logits at every position of B=2 S=2000 embeddings, no
     decode) and llava-next-34b at full width (all 60 layers where the
     card holds its 67.9 GB of bf16 weights: prefill B=2 S=2000 and decode
     B=4 from embeddings), their logits gates at 4 layers; then
     nemotron-4-340b at full width and the depth the card holds (8 of 96
     layers on an 80 GB card; flash at head dim 192): prefill B=2 S=2000
     counted, greedy generation, decode B=4 at 2-33 and 1985-2016 of a
     2,048-slot cache, the bf16 teacher-forced check reported at that depth,
     and with the model freed its gates (bf16 logits at 4 layers against an
     fp32 copy built a layer at a time, the fp32 teacher-forced check on 1
     layer, whose fp32 copy is 51.6 GB), drawn at the served depth's scales;
  4. after each model's path, time its kernels beside their bound, their
     plain version and one PyTorch library call where there is one (the
     SSD forward's wgmma path, at mamba2's N 128 and hymba's N 16, beside
     its FMA kernel, which it must beat; nemotron's flash at head dim 192
     forward and backward beside SDPA), and time prefill and decode;
  5. hold the backward kernels (flash attention, at head dims 32 to 192:
     FLASH_BWD_CASES at each, nemotron's layer at FLASH_BWD_NEMOTRON, the
     hd-192 cases non-causal; RMSNorm on both its
     versions, the SSD scan on both its paths: wgmma for bf16 at hp 64 /
     N 16, 64, 128, and the FMA kernel, which also runs each of those
     cases) against their plain backwards (``kernels/ref.py``), each call
     repeated for the same bits;
  6. train full-width yi-6b cut to 16 of its 32 layers, then mamba2-2.7b
     at all 64, hymba-1.5b and granite-moe-3b-a800m at all 32,
     hubert-xlarge at all 48 (from embeddings and frame labels; fp32
     masters and Adam moments, bf16 compute, microbatch 1 x 2048 tokens,
     G = 2) through the port's entry points: gradients through the kernels
     against the plain versions (bf16 against fp32, fp32 at 2 layers
     against fp64), ``train_loop`` for 10 steps into a checkpoint and a
     restore that must give the saved state bit for bit (at
     TRAIN_LOOP_LAYERS), 10 ``make_train_step`` steps on one batch whose
     loss must fall, the first with its launches counted exactly, then the
     train step's time, tokens/s and peak memory and the backward kernels'
     times (the SSD backward's wgmma path, at mamba2's N 128 and hymba's
     N 16, beside its FMA kernel, which it must beat);
  7. the FSDP x TP train step over NCCL on a one-card (1, 1) mesh: yi-6b at
     16 layers (3 steps), hymba-1.5b at 4 (one) and mamba2-2.7b at full
     width and SHARDED_MAMBA2_LAYERS (3 steps; its mixer head parallel over
     the one-rank "model" axis), each with remat off and on, from the
     training phase's seed and batch; the first sharded step's launches,
     loss and fp32 masters must equal the single-device step's (bit for
     bit), then its time and peak memory beside the single-device step's;
  8. sharded serving and expert parallelism in the same one-rank NCCL
     group on the (1, 1) mesh: full-width yi-6b, mamba2-2.7b, hymba-1.5b
     and granite-moe-3b-a800m (bf16, the serving phase's seed) decode B=4
     on the mesh (the KV cache context parallel over "model", the SSM
     state's heads over it, each layer's weights gathered, granite's
     experts through ``moe_ep``) and on one device in turn, at positions
     2-33 and 1985-2016 of a 2,048-slot cache (hymba past its ring;
     mamba2 at 2-33 only), llava-next-34b at 4 layers from embeddings:
     tokens and logits bit-equal at every step, each step's launches equal
     to the single-device step's, then ms/token beside one device and the
     peak memory; granite-moe at 4 layers trains one sharded step (the
     expert-parallel layer both ways) whose launches, loss and masters
     equal the single-device step's; ``compressed_psum`` and a one-stage
     ``pipeline_apply`` (and its gradient) over NCCL against their
     one-rank results;
  9. the dry-run (``repro_torch.launch.dryrun``: the entry points on meta
     tensors, each kernel op through its fake implementation) held to the
     card: yi-6b's 16-layer train step and its 32-layer serving run on the
     card and, in a child with no card visible, dry-run, and so does
     nemotron-4-340b's serving at the depth the card holds; the dry-run's
     peak within 5% of ``max_memory_allocated``, the train step's flops
     equal to ``FlopCounterMode``'s on the card, phase 7's sharded step's
     collectives equal kind by kind to the dry-run's on a fake (1, 1)
     mesh, ``kernels.build``'s target constants equal to the card's, and
     the CLI on one production cell ``ok`` without the card; under 60 s;
 10. the PALM simulator's core (``repro_torch.core``): the batched co-design
     tier's 512-job sweep (full-width yi-6b at sequence 4096, the 16x16
     tiled mesh of benchmarks/bench_sim_scaling.py, 32 tile rates x 8 DRAM
     rates, plans (4,1,4) and (2,1,8)) through ``run_fast_batch`` on the
     card (the group replay in ``chain_replay`` launches) and on the CPU,
     bit-equal job by job, in 2 groups with every job batched; each plan's
     grid corners equal to the scalar fast tier and the event tier;
     ``chain_replay`` equal to its plain version on random programs
     nesting to its depth limit at G 1 to 4096; under 30 s;
 11. the scale-out fabric (``repro_torch.fabric``, ``repro_torch.obs``):
     ``tiled_cluster`` (4 chips of 4x4 tiles on ``cluster_2x2``) with its
     board and node link rates and tile rate crossed, full-width yi-6b at
     sequence 4096 on plans (4,4,4) and (2,4,8): 128 ANALYTICAL jobs through
     ``run_fast_batch`` on the card and on the CPU, bit-equal job by job,
     in 2 groups with every job batched, the fabric-bytes accumulator
     nonzero; grid corners equal to the scalar fast tier and the event
     tier, with equal ``run_metrics`` sim documents; 8 MACRO jobs rejected
     for contention by the card's interval validation as on the CPU, and
     the first of them with ``metrics=True`` on the event tier: FABRIC
     lanes and ``payload_by_level`` as expected; under 30 s.
 12. the simulator's front door (``repro_torch.api``, the serving
     simulator, ``python -m repro_torch``): full-width yi-6b on the 16x16
     TPU v5e slice, 4 tile rates x 4 DRAM rates x 4 plans (64 jobs,
     ANALYTICAL, ``--engine auto``) through the command line in process on
     the card and with ``--device cpu``, equal but for wall clock, every job
     batched in 3 groups and ``chain_replay`` launched; the same as
     ``python -m repro_torch`` in a child process and through a spawned
     pool of 2, equal to the serial report; ``plan_codesign`` under the SLO
     objective, host code (event engine, no launch); ``serve-sim`` and
     ``serve-plan`` at full width; under 60 s;
 13. guided search (``repro_torch.search``) on phase 12's 64 candidates
     through the command line in process, no pool and no child:
     successive halving at budget 8 (rungs of 32, 16 and 8 candidates, the
     reduced ones at ``analytical-mb2`` and ``analytical-mb4``) on the card
     and with ``--device cpu``, equal but for wall clock, ``chain_replay``
     launched on every rung on the card; ``random`` and ``evolve`` the
     same; every guided full-fidelity run equal to phase 12's exhaustive
     run of its (hardware, plan); ``plan_codesign(strategy="sh")`` at full
     width, card equal to CPU, launching on the card; under 30 s.
The last line is one JSON object with ``"ok": true`` and the device. It
needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # dense tensor core / fp32 FMA
TOL_F32 = dict(rtol=3e-4, atol=3e-4)                           # tests/test_kernels.py:16-18
# bf16 kernels against fp32 of the same bf16 inputs. Flash rounds p to
# bf16 for p v (l sums the fp32 p) and rounds o once: on random inputs
# that reads about 3e-3 relative L2 in the worst row and 0.65 of the
# pointwise limit. A 3% error on late kv tiles reads 3e-2 and 3.8; a
# dropped tile 1.0 and 130. The SSD FMA kernel keeps everything in fp32 and
# rounds y once (about 2^-9 of each); the SSD wgmma kernel rounds x o w to
# bf16 (at N 16 to a pair too) and P and h to bf16 pairs (hi + lo), and
# reads about 0.6 pointwise at mamba2's prefill shape; with h and P rounded
# once it read 4 to 7.
BF16_LIMITS = {"rel_l2": 1e-2, "row_rel_l2": 1e-2, "pointwise": 1.0}
# the forward kernels' row log-sum-exp (log2 units) against the plain
# forward's: max |err| / (1 + |ref|). fp32 sums exp2f in fp32; bf16 (the
# wgmma kernel) uses ex2.approx (2^-22 relative) on scores from bf16 inputs.
LSE_LIMITS = {"float32": 1e-5, "bfloat16": 2 ** -10}
# fp32 SSD kernel against the plain version: tests/test_kernels.py:56,
# plus relative L2 (the kernel chunks by 64, the plain version by 256).
SSD_F32_TOL, SSD_F32_REL_L2 = dict(rtol=2e-3, atol=2e-3), 1e-4
# bf16 RMSNorm against fp32 of the same inputs: one rounding, half a bf16
# ulp (2^-8 relative), plus fp32 reassociation.
RMS_BF16_RTOL = 1.01 * 2 ** -8
FLASH_CASES = [(1, 128, 4, 4, 64), (2, 200, 4, 2, 64), (1, 384, 8, 1, 32), (2, 256, 6, 3, 128)]
FLASH_MAIN = (2, 2000, 32, 4, 128)       # yi-6b prefill: B, S, nh, nkv, hd
FLASH_HYMBA = (2, 2000, 25, 5, 64)       # hymba-1.5b prefill (window 1024)
FLASH_GRANITE = (2, 2000, 24, 8, 64)     # granite-moe-3b-a800m prefill (GQA group 3)
FLASH_HUBERT = (2, 2000, 16, 16, 80)     # hubert-xlarge prefill: non-causal, hd 80, no GQA
FLASH_LLAVA = (2, 2000, 56, 8, 128)      # llava-next-34b prefill (GQA group 7)
FLASH_NEMOTRON = (2, 2000, 96, 8, 192)   # nemotron-4-340b prefill: hd 192, GQA group 12
# hd 192 around its 64-row kv tiles (S 1, 127, 200, 300: none a multiple of
# 64) and GQA groups 2, 12, 12; each causal, with a window, and non-causal
FLASH_HD192_CASES = [(1, 1, 4, 2, 192), (2, 127, 4, 2, 192), (1, 200, 12, 1, 192),
                     (2, 300, 24, 2, 192)]
# non-causal cases beside hubert's: a tail of 2 rows past the 128-row tiles
# at hd 80, and hd 128 (B, S, nh, nkv, hd)
FLASH_NONCAUSAL_CASES = [(2, 130, 4, 4, 80), (2, 200, 8, 2, 128)]
HYMBA_WINDOW = 1024
ROPE_MAIN = (1, 3500, 32, 4, 128)        # yi-6b prefill (the benchmark's): B, S, nh, nkv, hd
# decode's S 1; hymba's, hubert's and nemotron's head dims (64, 80, 192); a
# head dim whose halves (6) take single elements
ROPE_CASES = [(4, 1, 32, 4, 128), (2, 2000, 25, 5, 64), (2, 300, 16, 16, 80),
              (1, 300, 96, 8, 192), (2, 70, 6, 3, 12)]
RMS_CASES = [(64, 256), (100, 512), (256, 1024)]
# prefill B*S, teacher-forced S, decode B, prefill's final norm (B), teacher-forced decode
RMS_MAIN = [(4000, 4096), (64, 4096), (4, 4096), (2, 4096), (1, 4096)]
# B, nh, S, hp, N and the plain version's chunk (tests/test_kernels.py:40-44)
SSD_CASES = [(1, 2, 256, 64, 16, 128), (2, 3, 300, 32, 64, 64), (1, 4, 64, 16, 128, 32)]
SSD_MAIN = (2, 80, 2000, 64, 128, 256)   # mamba2-2.7b prefill
SSD_HYMBA = (2, 50, 2000, 64, 16, 256)   # hymba-1.5b prefill: its SSM's 50 heads, N 16
# the bf16 wgmma path (hp 64, N 64/128): B, nh, S, hp, N around its 64-token
# chunks and up to mamba2's prefill length, and the test grid's wgmma case
SSD_WGMMA_CASES = ([(2, 3, S, 64, N) for S in (1, 63, 65, 500, 2000) for N in (64, 128)]
                   + [(1, 5, 130, 64, 128)])
# the wgmma path at N 16 (hymba-1.5b's state), forward and backward, around
# its 64-token chunks
SSD_WGMMA_N16_CASES = [(2, 3, S, 64, 16) for S in (1, 63, 65, 500, 2000)] + [(1, 5, 130, 64, 16)]
SSD_STATE_REL_L2 = 1e-2   # final state (fp32) of the wgmma path against the plain version
# mamba2-2.7b: prefill B*S, teacher-forced S, decode B, final norm B, teacher-forced decode
RMS_MAIN_SSM = [(4000, 2560), (4000, 5120), (300, 2560), (300, 5120), (4, 2560), (4, 5120),
                (2, 2560), (1, 2560), (1, 5120)]
# hymba-1.5b (H 1600, ssm_norm over d_inner 3200) and granite-moe (H 1536),
# all on the loop version: prefill B*S, decode B, prefill's final norm B,
# teacher-forced S and its decode
RMS_MAIN_NEW = [(4000, 1600), (4000, 3200), (4000, 1536), (4, 1600), (4, 3200), (4, 1536),
                (2, 1600), (2, 1536), (1100, 1600), (1100, 3200), (64, 1536), (1, 1600),
                (1, 3200), (1, 1536)]
# hubert-xlarge (H 1280, logits at every position) and llava-next-34b (H
# 7168), both on the loop version: prefill B*S, llava's decode B and final
# norm B, its teacher-forced S
RMS_MAIN_EMBEDS = [(4000, 1280), (4000, 7168), (4, 7168), (2, 7168), (64, 7168), (1, 7168)]
# nemotron-4-340b (H 18432, the loop version): prefill B*S, decode B,
# prefill's final norm B, teacher-forced S and its decode
RMS_MAIN_NEMOTRON = [(4000, 18432), (4, 18432), (2, 18432), (64, 18432), (1, 18432)]
# backward cases, B, S, nh, nkv, window (GQA groups 1, 2, 8; S 1, 127, 200,
# 2048; causal, one window), each at hd 32, 64 and 128; the training shape
FLASH_BWD_CASES = [(1, 1, 2, 2, 0), (2, 127, 4, 2, 0), (1, 200, 8, 1, 0), (1, 200, 4, 4, 37),
                   (1, 2048, 8, 1, 0)]
FLASH_BWD_MAIN = (1, 2048, 32, 4, 0, 128)      # yi-6b training: B, S, nh, nkv, window, hd
FLASH_BWD_HYMBA = (1, 2048, 25, 5, 1024, 64)   # hymba-1.5b's attention (GQA group 5)
FLASH_BWD_GRANITE = (1, 2048, 24, 8, 0, 64)    # granite-moe-3b-a800m's attention (group 3)
FLASH_BWD_HUBERT = (1, 2048, 16, 16, 0, 80)    # hubert-xlarge's attention: non-causal, hd 80
FLASH_BWD_NEMOTRON = (1, 2048, 96, 8, 0, 192)  # nemotron-4-340b's layer: hd 192, GQA group 12
RMS_BWD_CASES = [(1, 256), (7, 4096), (300, 1000), (4096, 256), (4096, 4096), (33, 12288),
                 (2048, 2560), (5, 2560), (2048, 5120), (1, 5120), (1, 1600), (9, 1536),
                 (300, 3200)]
RMS_BWD_MAIN = (2048, 4096)                    # yi-6b training, one microbatch
# hymba-1.5b (norm1, norm2 at 1600, ssm_norm at 3200) and granite-moe (1536)
# training, one microbatch; the register version (the forward's loop)
RMS_BWD_NEW = [(2048, 1600), (2048, 3200), (2048, 1536), (2048, 1280)]
# the model that trains at each RMS_BWD_NEW width (hubert's 1280 on the
# loop version)
RMS_BWD_NEW_MODELS = {1600: "hymba-1.5b", 3200: "hymba-1.5b", 1536: "granite-moe-3b-a800m",
                      1280: "hubert-xlarge"}
# the SSD backward, beside SSD_CASES and SSD_WGMMA_CASES: mamba2-2.7b's
# training shape (B, nh, S, hp, N) and hymba-1.5b's (its SSM: d_inner
# 2 x 1600 = 3200, so 50 heads of hp 64, N 16; the wgmma path at N 16)
SSD_BWD_MAIN = (1, 80, 2048, 64, 128)
SSD_BWD_N16 = (1, 50, 2048, 64, 16)
# layers each model trains at: yi-6b cut to fit one card, the others whole (PERF.md)
TRAIN_LAYERS = {"yi-6b": 16, "mamba2-2.7b": 64, "hymba-1.5b": 32, "granite-moe-3b-a800m": 32,
                "hubert-xlarge": 48}
# layers of each model's train_loop and checkpoint round trip, cut to keep
# the run near 600 s: the checkpoint's save, check and restore run at ~0.4
# GB/s (PERF.md). yi-6b at 2 (0.87 B parameters, 10.4 GB of masters and
# moments; 4 layers took 136 s of the run), mamba2 at 8 (4.4 GB), the new
# two at 2, which holds every leaf kind of their trees (hymba's attention,
# SSM and MLP, granite's [E,H,F] experts), hubert at 2 (a tree without embed)
TRAIN_LOOP_LAYERS = {"yi-6b": 2, "mamba2-2.7b": 8, "hymba-1.5b": 2, "granite-moe-3b-a800m": 2,
                     "hubert-xlarge": 2}
# drop-free capacity factor for MoE checks that compare two routings of the
# same tokens (tests/test_models.py:58-62)
DROP_FREE = 8.0
TRAIN_S, TRAIN_G = 2048, 2
TRAIN_STEPS = 10
SOURCES = {"flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                               "src/repro/kernels/flash_attention.py:87"),
           "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
                                   "src/repro/kernels/flash_attention.py:87"),
           # the wgmma flash at head dim 80 (hubert-xlarge, non-causal), both
           # ways, counted apart
           "flash_attention_hd80": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                    "src/repro/kernels/flash_attention.py:87"),
           "flash_attention_bwd_hd80": ("src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
                                        "src/repro/kernels/flash_attention.py:87"),
           # the wgmma flash forward at head dim 192 (nemotron-4-340b, served
           # only: its backward is a shape of flash_attention_bwd's entry)
           "flash_attention_hd192": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                     "src/repro/kernels/flash_attention.py:87"),
           "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                       "src/repro/kernels/rmsnorm.py:24"),
           "rmsnorm_bwd": ("src/repro_torch/kernels/csrc/rmsnorm_bwd.cu",
                           "src/repro/kernels/rmsnorm.py:24"),
           "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                        "src/repro/kernels/ssd_scan.py:65"),
           # the wgmma SSD forward at N 16 (hymba-1.5b), counted apart
           "ssd_scan_n16": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                            "src/repro/kernels/ssd_scan.py:65"),
           "ssd_scan_bwd": ("src/repro_torch/kernels/csrc/ssd_scan_bwd_wgmma.cu",
                            "src/repro/kernels/ssd_scan.py:65"),
           # the wgmma SSD backward at N 16 (hymba-1.5b), counted apart
           "ssd_scan_bwd_n16": ("src/repro_torch/kernels/csrc/ssd_scan_bwd_wgmma.cu",
                                "src/repro/kernels/ssd_scan.py:65"),
           # the SSD scan's FMA paths (fp32, and bf16 off the wgmma shapes),
           # counted apart from the wgmma ones: on the main path they run in
           # the fp32 gradient gates of mamba2-2.7b and hymba-1.5b (counted
           # there), and each is timed beside the wgmma path
           "ssd_scan_fma": ("src/repro_torch/kernels/csrc/ssd_scan_fma.cu",
                            "src/repro/kernels/ssd_scan.py:65"),
           "ssd_scan_bwd_fma": ("src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
                                "src/repro/kernels/ssd_scan.py:65"),
           # the simulator's batched chain replay (phase 10): it replaces the
           # reference's numpy evaluator, not a Pallas kernel
           "chain_replay": ("src/repro_torch/kernels/csrc/chain_replay.cu",
                            "src/repro/core/fastbatch.py:283 (numpy _BatchEval)")}


def log(*args):
    print(*args, flush=True)


def _launches(**counts):
    """Every kernel's launch count: those given, 0 for the rest."""
    from repro_torch import kernels
    return {name: counts.get(name, 0) for name in kernels.KERNELS}


# --------------------------------------------------------------------------
# 1. build
# --------------------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import build
    path, seconds, out = build.build()
    build.library()
    log(f"[build] {path.name} nvcc {seconds:.2f} s")
    for line in out.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")
    log_ssd_wgmma_resources()
    log_flash_resources()
    log_bwd_resources()
    log_ssd_bwd_resources()
    log_ssd_bwd_wgmma_resources()
    log_chain_replay_resources()


def log_chain_replay_resources():
    """Registers, local memory, CTAs an SM of ``chain_replay`` at each
    stack depth it instantiates. Its par/spawn stack is an array indexed at
    run time, so it lives in local memory by design (not a spill)."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    for depth in (4, 8, 16, 32):
        info = (ctypes.c_int * 4)()
        build.check(lib.chain_replay_info(depth, info), "chain_replay_info")
        _log_info(f"chain_replay<DEPTH={depth}>", info, spills_ok=True)


def _log_info(name, info, spills_ok=False):
    """Log one kernel's (registers, local bytes, shared bytes, CTAs an SM)
    from a ``*_info`` entry point; fail if a CTA does not fit on an SM, or
    on a spill unless ``spills_ok``."""
    regs, local, smem, ctas = info
    log(f"[build] {name}: {regs} registers, {local} bytes local (spills), {smem} bytes dynamic "
        f"shared memory, {ctas} CTAs an SM")
    if local and not spills_ok:
        raise AssertionError(f"{name} spills {local} bytes a thread")
    if ctas < 1:
        raise AssertionError(f"{name} does not fit on an SM")


def log_ssd_wgmma_resources():
    """Registers, spills (local memory), dynamic shared memory and CTAs an
    SM of the three wgmma SSD kernels at N 16, 64 and 128, from the
    runtime; fails on a spill, or if fewer scan CTAs fit on an SM than
    ``segment_chunks`` assumes (``SCAN_COST``)."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import SCAN_COST, WGMMA_STATE_DIMS
    lib = build.library()
    for N in WGMMA_STATE_DIMS:
        info = (ctypes.c_int * 12)()
        build.check(lib.ssd_scan_wgmma_info(N, info), "ssd_scan_wgmma_info")
        for k, name in enumerate(("ssd_cb16" if N == 16 else "ssd_cb", "ssd_segment_states",
                                  "ssd_chunk_scan")):
            _log_info(f"{name}<N={N}>", info[4 * k:4 * k + 4])
        if info[11] < SCAN_COST[N]["ctas"]:
            raise AssertionError(f"ssd_chunk_scan<N={N}>: {info[11]} CTAs an SM, "
                                 f"segment_chunks assumes {SCAN_COST[N]['ctas']}")


def log_ssd_bwd_resources():
    """Registers, spills (local memory), dynamic shared memory and CTAs an
    SM of the SSD backward's three bf16 kernels at mamba2's (hp 64, N 128)
    and a few other shapes, from the runtime; fails if a CTA does not fit
    on an SM. A spill is logged, not failed: the kernel is a first,
    simple version."""
    import ctypes
    from repro_torch.kernels import build
    lib = build.library()
    for hp, N in ((64, 128), (64, 64), (64, 16), (32, 16)):
        info = (ctypes.c_int * 12)()
        build.check(lib.ssd_scan_bwd_info(hp, N, info), "ssd_scan_bwd_info")
        for k, name in enumerate(("ssd_bwd_states", "ssd_bwd_dstates", "ssd_bwd_chunk")):
            _log_info(f"{name}<hp={hp},N={N}>", info[4 * k:4 * k + 4], spills_ok=True)


def log_ssd_bwd_wgmma_resources():
    """Registers, spills (local memory), dynamic shared memory and CTAs an
    SM of the wgmma SSD backward's five kernels at N 16, 64 and 128, from
    the runtime; fails on a spill, or if a CTA does not fit on an SM."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import BWD_WGMMA_STATE_DIMS
    lib = build.library()
    for N in BWD_WGMMA_STATE_DIMS:
        info = (ctypes.c_int * 20)()
        build.check(lib.ssd_scan_bwd_wgmma_info(N, info), "ssd_scan_bwd_wgmma_info")
        for k, name in enumerate(("ssd_cb16" if N == 16 else "ssd_cb<transposed too>",
                                  "ssd_bwd_segment_ends",
                                  "ssd_bwd_fold", "ssd_bwd_chunk", "ssd_bwd_sums")):
            _log_info(f"{name}<N={N}>", info[4 * k:4 * k + 4])


def log_flash_resources():
    """Registers, spills, dynamic shared memory and CTAs an SM of the flash
    kernels beside the wgmma backward's (``log_bwd_resources``): the wgmma
    forward at each of WGMMA_HEAD_DIMS (fails on a spill) and the mma
    kernels' fp32 forward and backward at hd 128 and 192 (a spill logged,
    not failed: at hd 192 the backward's dK and dV pass 255 registers, and
    it serves only the fp32 gates)."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import WGMMA_HEAD_DIMS
    lib = build.library()
    for hd in WGMMA_HEAD_DIMS:
        info = (ctypes.c_int * 4)()
        build.check(lib.flash_attention_wgmma_info(hd, info), "flash_attention_wgmma_info")
        _log_info(f"flash_wgmma<hd={hd}>", info[:])
    fp32 = build.DTYPE_CODES[torch.float32]
    for hd in (128, 192):
        info = (ctypes.c_int * 4)()
        build.check(lib.flash_attention_mma_info(hd, fp32, info), "flash_attention_mma_info")
        _log_info(f"flash_fwd<float, hd={hd}>", info[:], spills_ok=True)
        info = (ctypes.c_int * 8)()
        build.check(lib.flash_attention_bwd_info(hd, fp32, info), "flash_attention_bwd_info")
        _log_info(f"flash_bwd_dkdv<float, hd={hd}>", info[:4], spills_ok=True)
        _log_info(f"flash_bwd_dq<float, hd={hd}>", info[4:], spills_ok=True)


def log_bwd_resources():
    """Registers, spills (local memory), dynamic shared memory and CTAs an
    SM of the wgmma flash backward's kernels (dK/dV, dQ, the partials' sum)
    at hd 64, 128 and 192 and of the register RMSNorm backward at each of
    its widths (BWD_ROW_GROUPS), from the runtime; fails on a spill, or if
    a CTA does not fit on an SM."""
    import ctypes
    from repro_torch.kernels import build
    from repro_torch.kernels.rmsnorm import BWD_ROW_GROUPS
    lib = build.library()
    for hd in (64, 128, 192):
        info = (ctypes.c_int * 12)()
        build.check(lib.flash_attention_bwd_wgmma_info(hd, info), "flash_attention_bwd_wgmma_info")
        for k, name in enumerate(("flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_sum")):
            _log_info(f"{name}<hd={hd}>", info[4 * k:4 * k + 4])
    for H, groups in BWD_ROW_GROUPS.items():
        info = (ctypes.c_int * 4)()
        build.check(lib.rmsnorm_bwd_rows_info(H, info), "rmsnorm_bwd_rows_info")
        _log_info(f"rmsnorm_bwd_rows<H={H}, {groups} row groups>", info[:])


# --------------------------------------------------------------------------
# 2. kernel parity on the card
# --------------------------------------------------------------------------

def _randn(gen, *shape, dtype):
    return torch.randn(*shape, generator=gen, device="cuda", dtype=torch.float32).to(dtype)


def _flash_inputs(gen, B, S, nh, nkv, hd, dtype):
    return (_randn(gen, B, nh, S, hd, dtype=dtype), _randn(gen, B, nkv, S, hd, dtype=dtype),
            _randn(gen, B, nkv, S, hd, dtype=dtype))


def _compare_f32(name, out, ref):
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **TOL_F32, msg=lambda m: f"{name}: {m}")
    log(f"[parity] {name} max_abs_err={err:.3e} (allclose rtol=atol=3e-4) ok")
    return err


def _compare_bf16(name, out, ref):
    """out: a kernel's bf16 [B,nh,S,d] output; ref: the fp32 plain version
    on the same bf16 inputs. Gates the relative L2 error overall and of the
    worst row (b, h, s), and the worst ratio of |err| to
    2^-7 |ref| + 2^-6 rms(ref row)."""
    torch.cuda.synchronize()
    err = out.float() - ref
    row_err, row_ref = err.norm(dim=-1), ref.norm(dim=-1)
    row_rms = row_ref[..., None] / ref.shape[-1] ** 0.5
    got = {"rel_l2": (err.norm() / ref.norm()).item(),
           "row_rel_l2": (row_err / row_ref.clamp_min(1e-30)).max().item(),   # 0-rows must be 0
           "pointwise": (err.abs() / (2 ** -7 * ref.abs() + 2 ** -6 * row_rms)
                         .clamp_min(1e-30)).max().item()}
    max_abs = err.abs().max().item()
    reading = " ".join(f"{k}={v:.3e} (limit {BF16_LIMITS[k]:g})" for k, v in got.items())
    bad = [k for k, v in got.items() if not v <= BF16_LIMITS[k]]
    if bad:
        raise AssertionError(f"{name}: {reading}: over the limit in {bad}")
    log(f"[parity] {name} {reading} max_abs_err={max_abs:.3e} ok")
    return max_abs


def _compare_rms_bf16(name, out, ref):
    """out: the kernel's bf16 output; ref: fp32 RMSNorm of the same inputs."""
    torch.cuda.synchronize()
    err = (out.float() - ref).abs()
    ratio = (err / (RMS_BF16_RTOL * ref.abs() + 1e-6)).max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: |err| / (1.01 * 2^-8 |ref| + 1e-6) = {ratio:.3f} > 1")
    log(f"[parity] {name} |err|/(1.01*2^-8|ref|+1e-6)={ratio:.3f} (limit 1) "
        f"max_abs_err={err.max().item():.3e} ok")
    return err.max().item()


def _flash_case(name, q, k, v, window=0, causal=True):
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    ref = flash_attention_ref(q.float(), k.float(), v.float(), causal=causal, window=window)
    if q.dtype == torch.float32:
        return _compare_f32(name, out, ref)
    return _compare_bf16(name, out, ref)


def _ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory=False, views=False):
    """x [B,nh,S,hp], dt [B,nh,S] fp32, A [nh] fp32, Bm/Cm [B,S,N].
    tests/test_kernels.py's draw (dt = softplus(N(0,1)), A = -exp(N(0,1)/2))
    forgets within a few tokens; ``long_memory`` draws from the init's
    ranges (dt ~ U(1e-3, 1e-1), A = -U(1, 16)), so the state carried across
    chunks matters far past a chunk start. ``views`` lays the tensors out as
    the model does: x, Bm, Cm column slices of one [B,S,nh*hp+2N] buffer,
    dt a [B,nh,S] view of a [B,S,nh] tensor."""
    if views:
        buf = _randn(gen, B, S, nh * hp + 2 * N, dtype=dtype)
        x = buf[..., :nh * hp].view(B, S, nh, hp).transpose(1, 2)
        Bm, Cm = buf[..., nh * hp:nh * hp + N], buf[..., nh * hp + N:]
    else:
        x = _randn(gen, B, nh, S, hp, dtype=dtype)
        Bm, Cm = _randn(gen, B, S, N, dtype=dtype), _randn(gen, B, S, N, dtype=dtype)
    shape = (B, S, nh) if views else (B, nh, S)
    if long_memory:
        dt = 1e-3 + (1e-1 - 1e-3) * torch.rand(*shape, generator=gen, device="cuda")
        A = -(1.0 + 15.0 * torch.rand(nh, generator=gen, device="cuda"))
    else:
        dt = F.softplus(torch.randn(*shape, generator=gen, device="cuda"))
        A = -torch.exp(0.5 * torch.randn(nh, generator=gen, device="cuda"))
    return x, (dt.transpose(1, 2) if views else dt), A, Bm, Cm


def _ssd_case(name, chunk, x, dt, A, Bm, Cm, initial_state=None, return_state=False, fma=False):
    """The kernel's y (and with ``initial_state`` or ``return_state`` its
    final state) against the plain version in fp32 on the same inputs: the
    ``kernel_path`` kernel through ``ssd_scan``, or with ``fma`` the FMA
    kernel whatever the path (``launch_fma``, not counted)."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import launch_fma
    args = (x.float(), dt, A, Bm.float(), Cm.float())
    if initial_state is not None or return_state:
        out, h = ssd_scan(x, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                          return_state=True)
        torch.cuda.synchronize()
        ref, h_ref = ssd_scan_ref(*args, chunk=chunk, initial_state=initial_state,
                                  return_state=True)
        rel = ((h - h_ref).norm() / h_ref.norm()).item()
        if not (torch.isfinite(h).all() and rel <= SSD_STATE_REL_L2):
            raise AssertionError(f"{name}: final state rel_l2={rel:.3e} > {SSD_STATE_REL_L2:g}")
        log(f"[parity] {name} final state rel_l2={rel:.3e} (limit {SSD_STATE_REL_L2:g}) ok")
        return _compare_bf16(name, out, ref)
    out = launch_fma(x, dt, A, Bm, Cm) if fma else ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    torch.cuda.synchronize()
    ref = ssd_scan_ref(*args, chunk=chunk)
    if x.dtype != torch.float32:
        return _compare_bf16(name, out, ref)
    rel = ((out - ref).norm() / ref.norm()).item()
    err = (out - ref).abs().max().item()
    torch.testing.assert_close(out, ref, **SSD_F32_TOL, msg=lambda m: f"{name}: {m}")
    if not rel <= SSD_F32_REL_L2:
        raise AssertionError(f"{name}: rel_l2={rel:.3e} > {SSD_F32_REL_L2:g}")
    log(f"[parity] {name} rel_l2={rel:.3e} (limit {SSD_F32_REL_L2:g}) max_abs_err={err:.3e} "
        f"(allclose rtol=atol=2e-3) ok")
    return err


def flash_hd192_parity(gen, dtype):
    """The flash forward at hd 192 (nemotron-4-340b) against its plain
    version: the prefill shape in the model's views (rows 96 x 192 apart),
    then FLASH_HD192_CASES around the 64-row kv tiles, each causal, with a
    window and non-causal. Returns the prefill shape's max abs error."""
    tag = str(dtype).replace("torch.", "")
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _flash_inputs(gen, *FLASH_NEMOTRON, dtype))
    err = _flash_case(f"flash {tag} nemotron {FLASH_NEMOTRON} [B,S,nh,hd] views", q, k, v)
    del q, k, v
    for case in FLASH_HD192_CASES:
        inputs = _flash_inputs(gen, *case, dtype)
        for window, causal in ((0, True), (96, True), (0, False)):
            mode = f"window={window}" if causal else "non-causal"
            _flash_case(f"flash {tag} hd=192 B,S,nh,nkv,hd={case} {mode}", *inputs,
                        window=window, causal=causal)
    return err


def flash_bwd_hd192_parity(gen, dtype):
    """The flash backward at hd 192 against its plain backward, each call
    twice for the same bits (FLASH_BWD_CASES at hd 192 run in
    ``phase_bwd_parity``'s loop over head dims): FLASH_HD192_CASES[2:]
    non-causal, and nemotron-4-340b's layer at a training shape
    (FLASH_BWD_NEMOTRON, group 12) in the model's layout; no card trains
    nemotron, so its backward is held here. Returns that shape's max abs
    error."""
    tag = str(dtype).replace("torch.", "")
    for B, S, nh, nkv, hd in FLASH_HD192_CASES[2:]:
        _flash_bwd_case(f"flash_bwd {tag} non-causal hd={hd} B,S,nh,nkv=({B},{S},{nh},{nkv})",
                        *_flash_inputs(gen, B, S, nh, nkv, hd, dtype), 0, causal=False)
    B, S, nh, nkv, window, hd = FLASH_BWD_NEMOTRON
    q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
               for t in _flash_inputs(gen, B, S, nh, nkv, hd, dtype))
    do = _randn(gen, B, S, nh, hd, dtype=dtype).transpose(1, 2)
    return _flash_bwd_case(
        f"flash_bwd {tag} nemotron {FLASH_BWD_NEMOTRON[:4]} hd={hd} [B,S,nh,hd] views",
        q, k, v, window, do)


def _rope_table(positions, half, theta=10_000.0):
    """``layers.rope_qk``'s table: cos, sin [B,S,half] fp32."""
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device)
                             / half))
    angles = positions[..., :, None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def _rope_inputs(gen, B, S, nh, nkv, hd, dtype, first=0):
    """q, k, their gradients (a tenth of the entries +0 or -0: the sign of a
    zero sum is autograd's to match), cos, sin at positions first + s."""
    q, k = _randn(gen, B, S, nh, hd, dtype=dtype), _randn(gen, B, S, nkv, hd, dtype=dtype)
    grads = []
    for shape in ((B, S, nh, hd), (B, S, nkv, hd)):
        g = _randn(gen, *shape, dtype=dtype)
        u = torch.rand(shape, generator=gen, device="cuda")
        grads.append(torch.where(u < 0.05, -0.0, torch.where(u < 0.1, 0.0, g)).to(dtype))
    positions = first + torch.arange(S, device="cuda").expand(B, S)
    return q, k, *grads, *_rope_table(positions, hd // 2)


def _bits_differ(a, b):
    """Elements of a and b (one type) whose bits differ."""
    wide = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[a.dtype]
    return int((a.view(wide) != b.view(wide)).sum())


def rope_parity(gen):
    """The rope kernel against its plain version, forward and backward, bit
    for bit, at yi-6b's prefill shape and ``ROPE_CASES`` in bf16 and fp32;
    at the prefill shape the backward against autograd of the plain
    version on the card too. One launch a call, counted on ``rope`` /
    ``rope_bwd``."""
    from repro_torch.kernels import rope, rope_bwd
    from repro_torch.kernels.ref import rope_bwd_ref, rope_ref
    from repro_torch.kernels.rope import vector_path
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for case in [ROPE_MAIN, *ROPE_CASES]:
            q, k, gq, gk, cos, sin = _rope_inputs(gen, *case, dtype, first=7 * case[1] % 2048)
            before = (rope.launches, rope_bwd.launches)
            got = (*rope(q, k, cos, sin), *rope_bwd(gq, gk, cos, sin))
            torch.cuda.synchronize()
            if (rope.launches, rope_bwd.launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"rope {tag} {case}: launches {before} -> "
                                     f"{(rope.launches, rope_bwd.launches)}")
            want = (*rope_ref(q, k, cos, sin), *rope_bwd_ref(gq, gk, cos, sin))
            if case == ROPE_MAIN:
                qa, ka = q.clone().requires_grad_(), k.clone().requires_grad_()
                torch.autograd.backward(rope_ref(qa, ka, cos, sin), (gq, gk))
                want_ag = (qa.grad, ka.grad)
                bad = [_bits_differ(a, b) for a, b in zip(got[2:], want_ag)]
                if any(bad):
                    raise AssertionError(f"rope {tag} {case} backward: {bad} elements differ "
                                         f"from autograd's")
            bad = [_bits_differ(a, b) for a, b in zip(got, want)]
            if any(bad):
                raise AssertionError(f"rope {tag} {case}: {bad} elements (q, k, dq, dk) differ "
                                     f"from the plain version's")
            path = "16-byte vectors" if vector_path(q, k, cos, sin) else "single elements"
            log(f"[parity] rope {tag} B,S,nh,nkv,hd={case} ({path}): forward and backward "
                f"bit-equal")


def phase_parity():
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.ref import rmsnorm_ref
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for case in FLASH_CASES + [FLASH_MAIN]:
            for window in ((0, 96) if case != FLASH_MAIN else (0,)):
                err = _flash_case(f"flash {tag} B,S,nh,nkv,hd={case} window={window}",
                                  *_flash_inputs(gen, *case, dtype), window=window)
                if case == FLASH_MAIN:
                    errs[("flash_attention", dtype)] = err
        # the model's layout: [B,nh,S,hd] views of [B,S,nh,hd] tensors
        for case in ((2, 200, 4, 2, 64), FLASH_MAIN):
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in _flash_inputs(gen, *case, dtype))
            _flash_case(f"flash {tag} strided [B,S,nh,hd] views {case}", q, k, v)
        # rows past a short window and a padded tail: finite, no NaN
        q, k, v = _flash_inputs(gen, 1, 130, 2, 2, 64, dtype)
        _flash_case(f"flash {tag} window=3 S=130", q, k, v, window=3)
        # hymba-1.5b's attention (hd 64, GQA group 5, window 1024) and
        # granite-moe's (hd 64, group 3, causal) at prefill, in the model's
        # [B,S,nh,hd] layout
        for case, window in ((FLASH_HYMBA, HYMBA_WINDOW), (FLASH_GRANITE, 0)):
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in _flash_inputs(gen, *case, dtype))
            _flash_case(f"flash {tag} B,S,nh,nkv,hd={case} window={window} [B,S,nh,hd] views",
                        q, k, v, window=window)
        # q based 16 bytes into a larger buffer: aligned for TMA, off the
        # 128-byte swizzle span
        q, k, v = _flash_inputs(gen, 2, 200, 4, 2, 128, dtype)
        q = torch.cat([q.new_zeros(16 // q.element_size()), q.flatten()])[16 // q.element_size():]
        _flash_case(f"flash {tag} q 16 bytes into a buffer", q.view(2, 4, 200, 128), k, v)
        # non-causal (hubert-xlarge): its prefill shape at hd 80 as tensors
        # and in the model's views, its training shape's forward, a tail of 2
        # rows, and hd 128; llava-next-34b's causal prefill (group 7)
        _flash_case(f"flash {tag} non-causal hubert {FLASH_HUBERT}",
                    *_flash_inputs(gen, *FLASH_HUBERT, dtype), causal=False)
        for case in (FLASH_HUBERT, FLASH_BWD_HUBERT[:4] + FLASH_BWD_HUBERT[5:]):
            q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                       for t in _flash_inputs(gen, *case, dtype))
            err = _flash_case(f"flash {tag} non-causal hubert {case} [B,S,nh,hd] views", q, k, v,
                              causal=False)
            if case == FLASH_HUBERT:
                errs[("flash_attention_hd80", dtype)] = err
        for case in FLASH_NONCAUSAL_CASES:
            _flash_case(f"flash {tag} non-causal {case}", *_flash_inputs(gen, *case, dtype),
                        causal=False)
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _flash_inputs(gen, *FLASH_LLAVA, dtype))
        _flash_case(f"flash {tag} llava {FLASH_LLAVA} [B,S,nh,hd] views", q, k, v)
        errs[("flash_attention_hd192", dtype)] = flash_hd192_parity(gen, dtype)
        for T, H in (RMS_CASES + RMS_MAIN + RMS_MAIN_SSM + RMS_MAIN_NEW + RMS_MAIN_EMBEDS
                     + RMS_MAIN_NEMOTRON):
            x, w = _randn(gen, T, H, dtype=dtype), _randn(gen, H, dtype=dtype)
            out = rmsnorm(x, w)
            torch.cuda.synchronize()
            ref = rmsnorm_ref(x.float(), w.float())
            name = f"rmsnorm {tag} T,H=({T},{H})"
            err = (_compare_f32(name, out, ref) if dtype == torch.float32
                   else _compare_rms_bf16(name, out, ref))
            if (T, H) == RMS_MAIN[0]:
                errs[("rmsnorm", dtype)] = err
        for B, nh, S, hp, N, chunk in SSD_CASES:
            for long_memory in (False, True):
                _ssd_case(f"ssd {tag} B,nh,S,hp,N=({B},{nh},{S},{hp},{N}) chunk={chunk}"
                          f"{' long-memory' if long_memory else ''}", chunk,
                          *_ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory))
        B, nh, S, hp, N, chunk = SSD_MAIN
        for long_memory in (False, True):
            for views in (False, True):
                err = _ssd_case(f"ssd {tag} main B,nh,S,hp,N=({B},{nh},{S},{hp},{N})"
                                f"{' [B,S,.] views' if views else ''}"
                                f"{' long-memory' if long_memory else ''}", chunk,
                                *_ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory, views))
                if views and not long_memory:
                    errs[("ssd_scan", dtype)] = err
        # hymba-1.5b's SSM: 50 heads of hp 64, N 16, in the model's layout (x,
        # B, C column slices of one [B,S,3232] buffer); fp32 on the FMA
        # kernel, bf16 on the wgmma path and again on the FMA kernel
        B, nh, S, hp, N, chunk = SSD_HYMBA
        for long_memory in (False, True):
            inputs = _ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory, True)
            paths = ("wgmma", "fma") if dtype == torch.bfloat16 else ("fma",)
            for path in paths:
                err = _ssd_case(f"ssd {path} {tag} hymba B,nh,S,hp,N=({B},{nh},{S},{hp},{N}) "
                                f"[B,S,.] views{' long-memory' if long_memory else ''}", chunk,
                                *inputs, fma=path == "fma")
                if not long_memory:
                    errs[("ssd_scan_n16" if path == "wgmma" else "ssd_scan_fma", dtype)] = err
    # the bf16 wgmma path: its own cases, then the state options at the main
    # shape in the model's layout (the recurrence starts from a given state)
    from repro_torch.kernels.ssd_scan import kernel_path as ssd_path
    for B, nh, S, hp, N in SSD_WGMMA_CASES:
        assert ssd_path(torch.bfloat16, hp, N) == "wgmma"
        for long_memory in (False, True):
            _ssd_case(f"ssd wgmma bf16 B,nh,S,hp,N=({B},{nh},{S},{hp},{N})"
                      f"{' long-memory' if long_memory else ''}", 256,
                      *_ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, long_memory))
    B, nh, S, hp, N, chunk = SSD_MAIN
    h0 = torch.randn(B, nh, hp, N, generator=gen, device="cuda")
    _ssd_case("ssd wgmma bf16 main [B,S,.] views long-memory, initial_state and return_state",
              chunk, *_ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, True, True),
              initial_state=h0)
    # the wgmma path at N 16: its cases, then the final state at hymba's
    # prefill shape in the model's layout, from zeros and from a given state
    for B, nh, S, hp, N in SSD_WGMMA_N16_CASES:
        assert ssd_path(torch.bfloat16, hp, N) == "wgmma"
        for long_memory in (False, True):
            _ssd_case(f"ssd wgmma bf16 B,nh,S,hp,N=({B},{nh},{S},{hp},{N})"
                      f"{' long-memory' if long_memory else ''}", 256,
                      *_ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, long_memory))
    B, nh, S, hp, N, chunk = SSD_HYMBA
    h0 = torch.randn(B, nh, hp, N, generator=gen, device="cuda")
    for state in (None, h0):
        _ssd_case(f"ssd wgmma bf16 hymba [B,S,.] views long-memory, "
                  f"{'initial_state and ' if state is not None else ''}return_state", chunk,
                  *_ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, True, True),
                  initial_state=state, return_state=True)
    rope_parity(gen)
    return errs


# --------------------------------------------------------------------------
# 3. full-width slice
# --------------------------------------------------------------------------

def _counts_since_reset(fn):
    from repro_torch import kernels
    kernels.reset_launch_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, kernels.launch_counts()


class Launches(dict):
    """Main-path launches under the kernel line's names, and by (model,
    compute dtype) (``by_model``)."""

    def __init__(self):
        super().__init__()
        self.by_model = {}

    def add(self, counts, arch, dtype=torch.bfloat16):
        """Add one run's ``counts`` of ``arch`` at compute ``dtype``: the SSD
        and flash launches under the name of the path they took
        (``_kernel_names``)."""
        names = _kernel_names(arch, dtype)
        mine = self.by_model.setdefault((arch.name, dtype), {})
        for k, n in counts.items():
            k = names.get(k, k)
            self[k] = self.get(k, 0) + n
            mine[k] = mine.get(k, 0) + n


@contextlib.contextmanager
def plain_versions():
    """Route the model's kernel calls to their plain PyTorch versions
    (``repro_torch.models.layers`` looks the wrappers up on
    ``repro_torch.kernels`` at each call; ``KERNELS`` and ``POINTWISE`` keep
    the wrappers, whose counts must stay 0)."""
    from repro_torch import kernels
    saved = {name: getattr(kernels, name) for name in (*kernels.KERNELS, *kernels.POINTWISE)}
    for name in saved:
        setattr(kernels, name, getattr(kernels.ref, f"{name}_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


def _gap(a, b):
    """Relative L2 distance of logits a from b, and their argmax agreement."""
    return ((a - b).norm() / b.norm()).item(), (a.argmax(-1) == b.argmax(-1)).float().mean().item()


def _forward(model, x, **kw):
    """The model's forward over tokens [B,S] or, for an embeds-input arch,
    embeddings [B,S,H]."""
    return model(embeds=x, **kw) if model.arch.embeds_input else model(x, **kw)


def _decode(model, cache, x, pos):
    """One decode step from tokens [B] or, for an embeds-input arch,
    embeddings [B,H]."""
    if model.arch.embeds_input:
        return model.decode_step(cache, None, pos, embeds=x)
    return model.decode_step(cache, x, pos)


def _prompt(arch, gen, B, S):
    """Random tokens [B,S] of ``arch``'s vocabulary or, for an embeds-input
    arch, fp32 embeddings [B,S,H] ~ N(0, 1) (``train/data.py``'s draw)."""
    if arch.embeds_input:
        return torch.randn(B, S, arch.d_model, generator=gen, device="cuda")
    return torch.randint(0, arch.vocab, (B, S), generator=gen, device="cuda")


def _fp32_logits(model, x):
    """fp32 logits at every position of tokens (or embeddings) ``x`` of
    ``model``'s weights in fp32, through the plain versions: one layer's
    fp32 copy at a time, the embed rows and the head's columns cast as they
    are used (the fp32 model's forward, without its whole copy: 93 GB for
    nemotron-4-340b at 4 layers)."""
    import dataclasses
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.lm import Block
    cfg32 = dataclasses.replace(model.cfg, compute_dtype=torch.float32)
    with plain_versions():
        with torch.inference_mode():
            h = x.float() if model.arch.embeds_input else model.embed[x].float()
            positions = torch.arange(h.shape[1], device=h.device).expand(*h.shape[:2])
        for blk in model.blocks:
            blk32 = Block(model.arch, cfg32, model.device)
            blk32.load_state_dict(blk.state_dict())
            with torch.inference_mode():
                h, _ = blk32(h, positions)
            del blk32
        with torch.inference_mode():
            h = rmsnorm(h, model.final_norm.float())
            cols = 1 << 15
            return torch.cat([h @ model.lm_head[:, c:c + cols].float()
                              for c in range(0, model.arch.vocab, cols)], dim=-1)


def check_model_bf16(model, tokens, want):
    """The bf16 model's logits at every position of ``tokens`` (or
    embeddings), through the kernels (launching ``want``) and through their
    plain versions, each against the same weights in fp32 through the
    plain versions (``_fp32_logits``, first: its one-layer fp32 copy is
    freed before the bf16 logits exist, so nemotron-4-340b's three [B·S,
    V] fp32 logits stay on the card beside its 4-layer model). The
    kernels must land no further from fp32 than bf16 rounding puts the
    plain versions: relative L2 within 1.5x the plain gap, argmax
    agreement within 0.05 of it."""
    t0 = time.perf_counter()
    exact = _fp32_logits(model, tokens)
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with torch.inference_mode():
        kern, counts = _counts_since_reset(lambda: _forward(model, tokens, logits_positions="all"))
        with plain_versions():
            plain, plain_counts = _counts_since_reset(
                lambda: _forward(model, tokens, logits_positions="all"))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    if counts != want or any(plain_counts.values()):
        raise AssertionError(f"launches: kernels {counts} (expected {want}), "
                             f"plain versions {plain_counts}")
    for name, t in (("kernels", kern), ("plain", plain), ("fp32", exact)):
        if not torch.isfinite(t).all():
            raise AssertionError(f"model bf16 check: {name} logits not finite")
    (k_rel, k_agree), (p_rel, p_agree) = _gap(kern, exact), _gap(plain, exact)
    kp_rel, kp_agree = _gap(kern, plain)
    log(f"[slice] (c) bf16 logits check: fp32 {t1 - t0:.1f} s, kernels and plain {t2 - t1:.1f} s, "
        f"comparison {time.perf_counter() - t2:.1f} s")
    log(f"[slice] (c) bf16 logits B,S={tuple(tokens.shape[:2])} vs fp32 weights-equal model: "
        f"kernels rel_l2={k_rel:.4g} argmax={k_agree:.4f}; plain rel_l2={p_rel:.4g} "
        f"argmax={p_agree:.4f}; kernels vs plain rel_l2={kp_rel:.4g} argmax={kp_agree:.4f}; "
        f"limits rel_l2<={1.5 * p_rel:.4g} argmax>={p_agree - 0.05:.4f}")
    if not (k_rel <= 1.5 * p_rel and k_agree >= p_agree - 0.05):
        raise AssertionError("bf16 logits through the kernels are further from fp32 than the "
                             "plain versions' rounding allows")


def _teacher_forced(model, tokens):
    """Logits [S,V] of one forward over ``tokens`` [1,S] (or embeddings
    [1,S,H]) and of S decode steps."""
    with torch.inference_mode():
        full = _forward(model, tokens, logits_positions="all")[0]
        cache = model.init_cache(1, tokens.shape[1])
        dec = torch.stack([_decode(model, cache, tokens[:, t], t)[0]
                           for t in range(tokens.shape[1])])
    return full, dec


def _tf_summary(full, dec):
    err = (dec - full).abs()
    ratio = (err / (2e-2 + 2e-2 * full.abs())).max().item()
    rel = ((dec - full).norm() / full.norm()).item()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    return (f"max_abs_err={err.max().item():.4g} allclose(2e-2) ratio={ratio:.3g} "
            f"rel_l2={rel:.3g} argmax agreement={agree:.3f}")


def _norms(arch):
    """RMSNorm launches of one forward: norm1 per layer, norm2 where the
    layer has an MLP or experts, ssm_norm where it has the SSM, and the
    final norm."""
    per_layer = 1 + (arch.has_attention and bool(arch.d_ff or arch.n_experts)) + \
        (arch.block in ("ssm", "hymba"))
    return per_layer * arch.num_layers + 1


def _forward_launches(arch):
    """Kernel launches of one forward (prefill) of ``arch``."""
    L, ssm = arch.num_layers, arch.block in ("ssm", "hymba")
    return _launches(flash_attention=L if arch.has_attention else 0, rmsnorm=_norms(arch),
                     ssd_scan=L if ssm else 0)


def _kernel_names(arch, dtype=torch.bfloat16):
    """The kernel line's names for ``arch``'s launches at ``dtype``:
    ``flash_attention_hd80`` / ``flash_attention_bwd_hd80`` where bf16
    attention runs the wgmma kernels at head dim 80 (hubert-xlarge),
    ``flash_attention_hd192`` where it runs the forward at head dim 192
    (nemotron-4-340b, served only); for
    the SSD ``ssd_scan_fma`` / ``ssd_scan_bwd_fma`` where a pass takes the
    FMA kernel, ``ssd_scan_n16`` / ``ssd_scan_bwd_n16`` where it takes the
    wgmma path at N 16; the wrappers' own names otherwise."""
    from repro_torch.kernels.ssd_scan import bwd_kernel_path, kernel_path
    names = {}
    if arch.has_attention and arch.head_dim == 80 and dtype == torch.bfloat16:
        names = {"flash_attention": "flash_attention_hd80",
                 "flash_attention_bwd": "flash_attention_bwd_hd80"}
    if arch.has_attention and arch.head_dim == 192 and dtype == torch.bfloat16:
        names = {"flash_attention": "flash_attention_hd192"}
    if arch.block not in ("ssm", "hymba"):
        return names
    hp, N = arch.ssm_headdim, arch.ssm_state
    if kernel_path(dtype, hp, N) == "fma":
        names["ssd_scan"] = "ssd_scan_fma"
    elif N == 16:
        names["ssd_scan"] = "ssd_scan_n16"
    if bwd_kernel_path(dtype, hp, N) == "fma":
        names["ssd_scan_bwd"] = "ssd_scan_bwd_fma"
    elif N == 16:
        names["ssd_scan_bwd"] = "ssd_scan_bwd_n16"
    return names


@torch.no_grad()
def _as_first_layers_of(model, L):
    """Rescale the per-layer weights of a model cut to fewer layers whose
    init std depends on the depth (``lm._dense`` takes fan-in from the
    layer axis, (1/L)^0.5; the output projections divide by (2L)^0.5: every
    leaf of 2 or more dims but the router and the conv taps) to what an
    ``L``-layer init draws, so the cut holds layers of the served model's
    distribution. Returns the model."""
    f = (model.arch.num_layers / L) ** 0.5
    for blk in model.blocks:
        for name, p in blk.named_parameters():
            if p.dim() >= 2 and name.rsplit(".", 1)[-1] not in ("router", "conv_w"):
                p.mul_(f)
    return model


def _teacher_forced_gate(name, arch, tf_len, tf_layers, tf_tokens, model, tf_cfg, bf16_tokens):
    """(c) teacher-forced: a forward over ``tf_len`` tokens vs ``tf_len``
    decode steps (tests/test_models.py:55-85). Gated in fp32 compute, where
    the 2e-2 of that test applies. In bf16 the two paths round at different
    places (kernels vs plain decode attention or recurrence, GEMMs of S rows
    vs 1, the SSM leaves in bf16 in forward and fp32 in decode), and the
    reference's init amplifies rounding (yi-6b: attention a hard argmax
    over logits of std ~128), so there the numbers are only reported; the
    bf16 logits check gates bf16. With ``tf_layers`` < L the gate runs on
    the first ``tf_layers`` layers of the same weights; with
    ``tf_cfg["full_depth"]`` false every check runs there (hymba: 1100
    decode steps at 32 layers cost too much), and with ``tf_cfg["depth"]``
    its weights are drawn at the scales of that many layers
    (``_as_first_layers_of``; llava: 4 of 60). ``tf_cfg["run"]``: RunCfg
    fields of the checks (an MoE arch's drop-free capacity factor). With
    ``tf_cfg["bf16_layers"]`` the bf16 logits check (``check_model_bf16``)
    also runs, gated, on the first that many layers of the same weights:
    at full depth granite-moe's bf16 logits sit 1.32 relative L2 from fp32
    (kernels and plain versions alike, argmax agreement 0.0005), where a
    gate sees nothing."""
    import dataclasses
    from repro_torch.models.lm import RunCfg, init_params
    L = arch.num_layers
    run = tf_cfg.get("run", {})
    full_depth = tf_cfg.get("full_depth", True)
    depth = tf_cfg.get("depth")

    def seeded_init(arch, dtype):
        model = init_params(arch, torch.Generator(device="cuda").manual_seed(0),
                            RunCfg(compute_dtype=dtype, **run), device="cuda")
        return _as_first_layers_of(model, depth) if depth else model

    if not full_depth:
        arch = dataclasses.replace(arch, num_layers=tf_layers)
    if run or not full_depth:
        model = seeded_init(arch, torch.bfloat16)
    layers = f"{arch.num_layers} layers" + (f" at {depth} layers' scales" if depth else "")
    full, dec = _teacher_forced(model, tf_tokens)
    log(f"[slice] (c) {name} teacher-forced S={tf_len} bf16, {layers} (reported): "
        f"{_tf_summary(full, dec)}")
    del model
    model32 = seeded_init(arch, torch.float32)
    (full, dec), counts = _counts_since_reset(lambda: _teacher_forced(model32, tf_tokens))
    gated = tf_layers == arch.num_layers
    log(f"[slice] (c) {name} teacher-forced S={tf_len} fp32, {layers} "
        f"({'gated' if gated else 'reported'}): {_tf_summary(full, dec)}; launches {counts}")
    if not gated:
        # Even fp32 rounding grows through mamba2's 64 layers under the
        # reference's init (a few percent of a logit at 64 layers); two
        # forwards that differ only in fp32 summation order show it. The
        # gate runs on the first tf_layers layers of the same weights.
        with torch.inference_mode(), plain_versions():
            plain = _forward(model32, tf_tokens, logits_positions="all")[0]
        log(f"[slice] (c) {name} fp32 forward, plain versions vs kernels, {L} layers "
            f"(reported): {_tf_summary(full, plain)}")
        model32.blocks = model32.blocks[:tf_layers]
        (full, dec), counts = _counts_since_reset(lambda: _teacher_forced(model32, tf_tokens))
        log(f"[slice] (c) {name} teacher-forced S={tf_len} fp32, first {tf_layers} layers "
            f"(gated): {_tf_summary(full, dec)}; launches {counts}")
    del model32
    torch.cuda.empty_cache()
    if not (torch.isfinite(full).all() and torch.isfinite(dec).all()):
        raise AssertionError("teacher-forced logits not finite")
    torch.testing.assert_close(dec, full, rtol=2e-2, atol=2e-2)
    if tf_cfg.get("bf16_layers"):
        cut = dataclasses.replace(arch, num_layers=tf_cfg["bf16_layers"])
        model = init_params(cut, torch.Generator(device="cuda").manual_seed(0),
                            RunCfg(compute_dtype=torch.bfloat16), device="cuda")
        check_model_bf16(_as_first_layers_of(model, depth) if depth else model, bf16_tokens,
                         _forward_launches(cut))
        del model
        torch.cuda.empty_cache()
    agree = (dec.argmax(-1) == full.argmax(-1)).float().mean().item()
    if agree < 0.95:
        raise AssertionError(f"teacher-forced argmax agreement {agree:.3f} < 0.95")


def _check_rope_launches(what, want):
    """The rope kernel's launches since the last reset: one a layer with
    attention, forward and backward apart."""
    from repro_torch import kernels
    got = (kernels.rope.launches, kernels.rope_bwd.launches)
    if got != (want, 0):
        raise AssertionError(f"{what}: rope launched {got} (forward, backward), expected "
                             f"({want}, 0)")


def phase_slice(name, tf_len, tf_layers, total, tf_cfg=None):
    """Serve full-width ``name`` through the port's entry points; adds the
    main path's launches to ``total``. The teacher-forced check runs
    ``tf_len`` tokens and is gated on the first ``tf_layers`` layers
    (``_teacher_forced_gate``, which takes ``tf_cfg``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import scale_arch
    from repro_torch.models.lm import RunCfg, init_params, param_count
    from repro_torch.serving.serve import greedy_generate, make_prefill_step, make_serve_step

    arch = scale_arch(get_config(name), "full")
    cfg = RunCfg(compute_dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(arch, gen, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] {name} full width: {arch.num_layers} layers, d {arch.d_model}, "
        f"{param_count(model) / 1e9:.3f} B params bf16, init {time.perf_counter() - t0:.2f} s")
    V = arch.vocab

    # (a), (b) prefill with its launches counted
    prefill = make_prefill_step(model)
    tokens = torch.randint(0, V, (2, 2000), generator=gen, device="cuda")
    logits, counts = _counts_since_reset(lambda: prefill({"tokens": tokens}))
    if logits.shape != (2, 1, V) or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite [2,1,{V}]")
    want = _forward_launches(arch)
    if counts != want:
        raise AssertionError(f"prefill launched {counts}, expected {want}")
    _check_rope_launches(f"{name} prefill", arch.num_layers if arch.has_attention else 0)
    log(f"[slice] (a,b) {name} prefill B=2 S=2000: logits {tuple(logits.shape)} finite; "
        f"launches {counts}")
    total.add(counts, arch)

    # (c) the bf16 model through the kernels against the plain versions, at
    # the prefill's shape and in the model's layouts
    check_model_bf16(model, tokens, want)

    # (c) teacher-forced forward vs decode
    tf_tokens = torch.randint(0, V, (1, tf_len), generator=gen, device="cuda")
    _teacher_forced_gate(name, arch, tf_len, tf_layers, tf_tokens, model, tf_cfg or {}, tokens)

    # (d) greedy generation
    prompt = torch.randint(0, V, (4, 32), generator=gen, device="cuda")
    out, counts = _counts_since_reset(lambda: greedy_generate(model, prompt, 32))
    total.add(counts, arch)
    if out.shape != (4, 32) or out.min() < 0 or out.max() >= V:
        raise AssertionError(f"greedy_generate gave {tuple(out.shape)} in "
                             f"[{out.min()}, {out.max()}]")
    log(f"[slice] (d) {name} greedy_generate B=4 prompt 32 new 32: tokens {tuple(out.shape)}; "
        f"launches {counts}")

    # (e) serve steps
    serve = make_serve_step(model)
    cache = model.init_cache(4, 8)

    def serve_steps():
        tok = prompt[:, 0]
        for pos in range(4):
            tok, lg, _ = serve(cache, tok, pos)
        return tok, lg

    (tok, lg), counts = _counts_since_reset(serve_steps)
    total.add(counts, arch)
    if lg.shape != (4, V) or not torch.isfinite(lg).all() or tok.shape != (4,):
        raise AssertionError("serve_step output malformed")
    if counts != _launches(rmsnorm=4 * _norms(arch)):
        raise AssertionError(f"4 serve steps launched {counts}")
    _check_rope_launches(f"{name} 4 serve steps", 4 * arch.num_layers if arch.has_attention else 0)
    log(f"[slice] (e) {name} 4 serve steps B=4: logits {tuple(lg.shape)} finite; "
        f"launches {counts}")
    return model, prefill, serve


# --------------------------------------------------------------------------
# 4. times
# --------------------------------------------------------------------------

def time_device(fn, n=20, reps=5):
    """Median device ms per call. A sleep kernel holds the card while the
    host queues all n calls, so host overhead does not leak in."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / n)
    return statistics.median(per_call)


def _bound(nbytes, flops, dtype):
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _log_row(r):
    lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
    log(f"[time] {r['name']} {r['shape']}: kernel {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} "
        f"ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library {lib}")


def flash_fwd_bound(q, k, causal=True, window=0):
    """((bound ms, "bytes" or "operations"), products) of the flash forward
    on these inputs: q, k, v read once, o written once; the products of the
    (query, key) pairs this input needs (``kernels.flash_attention.flops``,
    the count its ``FlopCounterMode`` formula gives)."""
    from repro_torch.kernels.flash_attention import flops
    B, nh, S, hd = q.shape
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    n = flops(B, nh, S, hd, causal, window)
    return _bound(nbytes, n, q.dtype), n


def flash_bwd_bound(q, k, causal=True, window=0):
    """The same for the backward: read q, k, v, o, dO, write dq, dk, dv;
    five products over the pairs (``kernels.flash_attention.bwd_flops``)."""
    from repro_torch.kernels.flash_attention import bwd_flops
    B, nh, S, hd = q.shape
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size()
    n = bwd_flops(B, nh, S, hd, causal, window)
    return _bound(nbytes, n, q.dtype), n


def _flash_row(gen, views, case=FLASH_MAIN, window=0, causal=True, name="flash_attention"):
    """Flash at ``case`` (B, S, nh, nkv, hd; yi-6b's prefill shape by
    default), bf16, beside SDPA on the same tensors (``is_causal=causal``,
    or a boolean band mask for a window; ``enable_gqa``): [B,nh,S,hd]
    tensors, or the model's [B,S,nh,hd] tensors seen through transposed
    views."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.ref import attention_mask, flash_attention_ref
    dt = torch.bfloat16
    B, S, nh, nkv, hd = case
    q, k, v = _flash_inputs(gen, B, S, nh, nkv, hd, dt)
    if views:
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    (bound, by), flops = flash_fwd_bound(q, k, causal, window)
    if window:
        mask = attention_mask(S, True, window, q.device)
        library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    else:
        library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                         enable_gqa=True)
    mode = f"window={window}" if causal else "non-causal"
    row = dict(name=name,
               ms=time_device(lambda: flash_attention(q, k, v, causal=causal, window=window)),
               plain_ms=time_device(lambda: flash_attention_ref(q, k, v, causal=causal,
                                                                window=window), n=3, reps=3),
               library_ms=time_device(library), bound_ms=bound, bound_by=by,
               shape=f"q{list(q.shape)} kv{list(k.shape)} bf16 {mode}"
                     f"{' [B,S,nh,hd] views' if views else ''}")
    log(f"[time] flash_attention {list(case)} {mode}{' views' if views else ''}: "
        f"{flops / row['ms'] / 1e9:.1f} TFLOP/s, {100 * bound / row['ms']:.1f}% of the bound; SDPA "
        f"{flops / row['library_ms'] / 1e9:.1f} TFLOP/s; kernel / SDPA = "
        f"{row['ms'] / row['library_ms']:.3f}")
    return row


def _rms_row(gen, T, H):
    from repro_torch.kernels import rmsnorm
    from repro_torch.kernels.ref import rmsnorm_ref
    dt = torch.bfloat16
    x, w = _randn(gen, T, H, dtype=dt), _randn(gen, H, dtype=dt)
    bound, by = _bound((2 * x.numel() + w.numel()) * x.element_size(), 4 * x.numel(),
                       torch.float32)
    row = dict(name="rmsnorm", ms=time_device(lambda: rmsnorm(x, w)),
               plain_ms=time_device(lambda: rmsnorm_ref(x, w)),
               library_ms=time_device(lambda: F.rms_norm(x, (H,), w, eps=1e-5)),
               bound_ms=bound, bound_by=by, shape=f"x{list(x.shape)} bf16")
    log(f"[time] rmsnorm x[{T}, {H}]: {100 * bound / row['ms']:.1f}% of the bound; "
        f"kernel / F.rms_norm = {row['ms'] / row['library_ms']:.3f}")
    return row


def _rope_rows(gen, case=ROPE_MAIN):
    """The rope kernel, forward and backward, at ``case`` (yi-6b's prefill
    shape by default), bf16: q and k read and written once, the table read
    once; the plain version beside it (``ref.rope_ref``, the eager lines
    past the table), and the table's own eager lines."""
    from repro_torch.kernels import rope, rope_bwd
    from repro_torch.kernels.ref import rope_bwd_ref, rope_ref
    q, k, gq, gk, cos, sin = _rope_inputs(gen, *case, torch.bfloat16)
    nbytes = 2 * (q.numel() + k.numel()) * q.element_size() + 2 * cos.numel() * 4
    bound, by = _bound(nbytes, 6 * (q.numel() + k.numel()), torch.float32)
    shape = f"q{list(q.shape)} k{list(k.shape)} bf16"
    positions = torch.arange(case[1], device="cuda").expand(case[0], case[1])
    table_ms = time_device(lambda: _rope_table(positions, case[4] // 2))
    rows = [dict(name="rope", ms=time_device(lambda: rope(q, k, cos, sin)),
                 plain_ms=time_device(lambda: rope_ref(q, k, cos, sin)), library_ms=None,
                 bound_ms=bound, bound_by=by, shape=shape),
            dict(name="rope_bwd", ms=time_device(lambda: rope_bwd(gq, gk, cos, sin)),
                 plain_ms=time_device(lambda: rope_bwd_ref(gq, gk, cos, sin)), library_ms=None,
                 bound_ms=bound, bound_by=by, shape=shape)]
    for r in rows:
        log(f"[time] {r['name']} {shape}: {100 * bound / r['ms']:.1f}% of the bound; the table's "
            f"eager lines {table_ms:.4f} ms")
    return rows


def times_attn_kernels(gen):
    """yi-6b's kernels at its prefill shapes, bf16. The kernel line keeps
    the contiguous flash row and RMSNorm at [4000, 4096]; the strided flash
    row and the rope kernel's rows are logged."""
    rows = [_flash_row(gen, views=False)]
    _log_row(_flash_row(gen, views=True))
    for r in _rope_rows(gen):
        _log_row(r)
    rows.append(_rms_row(gen, *RMS_MAIN[0]))
    return rows


def ssd_fwd_bound(x, dt, A, Bm, Cm, Q):
    """(bound ms, "bytes" or "operations") of the SSD forward on these
    inputs: each input read once, y written once; the chunked algorithm's
    products at chunk Q (``kernels.ssd_scan.fwd_flops``, the count its
    ``FlopCounterMode`` formula gives at the kernels' chunk)."""
    from repro_torch.kernels.ssd_scan import fwd_flops
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4
              + (Bm.numel() + Cm.numel()) * Bm.element_size())
    return _bound(nbytes, fwd_flops(B, nh, S, hp, N, Q), x.dtype)


def times_hymba_kernels(gen):
    """hymba-1.5b's kernels at its prefill shapes, bf16: the windowed flash
    (window 1024, GQA group 5) in the model's views; the SSD scan (50
    heads, N 16) on the wgmma path in turns with the FMA kernel
    (``times_ssd_fwd_kernel``) at its prefill shape and, logged, its
    training shape; RMSNorm at H 1600 (norm1, norm2) and 3200 (ssm_norm).
    Returns the SSD rows (the kernel line's ``ssd_scan_n16`` and
    ``ssd_scan_fma``); logs the others."""
    shapes = [_flash_row(gen, True, FLASH_HYMBA, HYMBA_WINDOW)]
    shapes += [_rms_row(gen, T, H) for T, H in RMS_MAIN_NEW[:2]]
    rows = list(times_ssd_fwd_kernel(gen, "ssd_scan_n16", SSD_HYMBA[:5]))
    train = times_ssd_fwd_kernel(gen, "ssd_scan_n16", SSD_BWD_N16)
    for r in shapes + list(train):
        _log_row(r)
    return rows


def times_granite_kernels(gen):
    """granite-moe's kernels at its prefill shapes, bf16: flash at GQA group
    3 in the model's views and RMSNorm at H 1536, each beside its bound, its
    plain version and its library call; logged. The kernel line keeps
    yi-6b's rows of these kernels, so this returns none."""
    for r in (_flash_row(gen, True, FLASH_GRANITE), _rms_row(gen, *RMS_MAIN_NEW[2])):
        _log_row(r)
    return []


def times_hubert_kernels(gen):
    """hubert-xlarge's kernels at its prefill shapes, bf16: the non-causal
    flash at head dim 80 in the model's views (the kernel line's
    ``flash_attention_hd80``; SDPA with ``is_causal=False`` the yardstick),
    and RMSNorm's loop version at [4000, 1280] (a shape under the kernel
    line's ``rmsnorm``); also logs the flash at its training shape."""
    rows = [_flash_row(gen, True, FLASH_HUBERT, causal=False, name="flash_attention_hd80"),
            dict(_rms_row(gen, *RMS_MAIN_EMBEDS[0]), model="hubert-xlarge")]
    _log_row(_flash_row(gen, True, FLASH_BWD_HUBERT[:4] + FLASH_BWD_HUBERT[5:], causal=False,
                        name="flash_attention_hd80"))
    return rows


def times_llava_kernels(gen):
    """llava-next-34b's kernels at its prefill shapes, bf16: the causal
    flash at hd 128, GQA group 7, in the model's views, and RMSNorm's loop
    version at [4000, 7168]; shapes under the kernel line's
    ``flash_attention`` and ``rmsnorm``."""
    return [dict(_flash_row(gen, True, FLASH_LLAVA), model="llava-next-34b"),
            dict(_rms_row(gen, *RMS_MAIN_EMBEDS[1]), model="llava-next-34b")]


def times_nemotron_kernels(gen):
    """nemotron-4-340b's kernels, bf16: flash at hd 192, GQA group 12, at
    its prefill shape in the model's views (the kernel line's
    ``flash_attention_hd192``), RMSNorm's loop version at [4000, 18432] (a
    shape under ``rmsnorm``), and the flash backward at hd 192 at
    FLASH_BWD_NEMOTRON (a shape under ``flash_attention_bwd``, with no
    main-path launches: no card trains nemotron), each beside its bound,
    its plain version and SDPA (``enable_gqa``) or ``F.rms_norm``."""
    return [_flash_row(gen, True, FLASH_NEMOTRON, name="flash_attention_hd192"),
            dict(_rms_row(gen, *RMS_MAIN_NEMOTRON[0]), model="nemotron-4-340b"),
            dict(_flash_bwd_row(gen, FLASH_BWD_NEMOTRON), model="nemotron-4-340b",
                 note="not on the main path: no card trains nemotron-4-340b")]


def times_ssd_fwd_kernel(gen, name, case):
    """The SSD forward at ``case`` (B, nh, S, hp, N) on the wgmma path, in
    the model's layout (bf16 x, B, C column slices of the conv output, fp32
    dt), in turns with the FMA kernel on the same inputs (``launch_fma``:
    FMA, wgmma, wgmma, FMA), which it must beat; beside its bound and its
    plain version. No single PyTorch call computes the scan, so there is no
    library time. Returns (the wgmma row under ``name``, the mean of its two
    turns, with the FMA time as "fma_ms"; the FMA kernel's row,
    ``ssd_scan_fma``)."""
    from repro_torch.kernels import ssd_scan
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import KERNEL_CHUNK, kernel_path, launch_fma
    B, nh, S, hp, N = case
    assert kernel_path(torch.bfloat16, hp, N) == "wgmma"
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, views=True)
    bound, by = ssd_fwd_bound(x, dt, A, Bm, Cm, KERNEL_CHUNK)
    turns = [time_device(lambda: launch_fma(x, dt, A, Bm, Cm) if which == "fma"
                         else ssd_scan(x, dt, A, Bm, Cm))
             for which in ("fma", "wgmma", "wgmma", "fma")]
    ms, fma_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
    log(f"[time] {name} {list(case)} in turns FMA, wgmma, wgmma, FMA: "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms; wgmma {100 * bound / ms:.1f}% of the bound, "
        f"fma {100 * bound / fma_ms:.1f}%; wgmma / fma = {ms / fma_ms:.3f}")
    if not ms < fma_ms:
        raise AssertionError(f"{name}: the wgmma path ({ms:.4f} ms) is not faster than the "
                             f"FMA kernel ({fma_ms:.4f} ms) at {case}")
    row = dict(name=name, ms=ms, fma_ms=fma_ms,
               plain_ms=time_device(lambda: ssd_scan_ref(x, dt, A, Bm, Cm), n=3, reps=3),
               library_ms=None, bound_ms=bound, bound_by=by,
               shape=f"x{list(x.shape)} B/C{list(Bm.shape)} bf16, dt fp32, views")
    return row, dict(row, name="ssd_scan_fma", ms=fma_ms)


def times_ssm_kernels(gen):
    """The SSD kernel at mamba2-2.7b's prefill shape on the wgmma path, in
    turns with the FMA kernel that served this shape before it
    (``times_ssd_fwd_kernel``; the kernel line's ``ssd_scan``). Also logs
    RMSNorm at mamba2's two prefill shapes (norm1 and the gated ssm_norm),
    for the prefill breakdown; the kernel line keeps yi-6b's RMSNorm row."""
    for T, H in RMS_MAIN_SSM[:2]:
        _log_row(_rms_row(gen, T, H))
    return [times_ssd_fwd_kernel(gen, "ssd_scan", SSD_MAIN[:5])[0]]


def times_end_to_end(name, model, prefill, serve, gen, decode_spans):
    """Prefill B=2 S=2000 (tokens, or embeddings for an embeds-input arch),
    median of 3, and decode ms/token for B=4 over 32 steps at each (cache
    span, first position) of ``decode_spans`` (host clock around
    synchronised work; an embeds-input arch decodes from fresh random
    embeddings, its greedy tokens not fed back); peak memory over both."""
    a = model.arch
    key = "embeds" if a.embeds_input else "tokens"
    tokens = _prompt(a, gen, 2, 2000)
    torch.cuda.reset_peak_memory_stats()
    pre = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill({key: tokens})
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    dec = []
    for span, first in decode_spans:
        cache = model.init_cache(4, span)
        steps = _prompt(a, gen, 4, 33)
        tok = steps[:, 0] if a.embeds_input else tokens[:2].reshape(-1)[:4]
        serve(cache, tok, first - 1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for pos in range(first, first + 32):
            if a.embeds_input:
                tok = steps[:, pos - first + 1]
            tok, _, _ = serve(cache, tok, pos)
        torch.cuda.synchronize()
        dec.append(f"pos {first + 1}-{first + 32} {(time.perf_counter() - t0) * 1e3 / 32:.3f}")
        del cache
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {name} prefill B=2 S=2000: median {statistics.median(pre):.2f} ms of {pre}; "
        f"decode B=4 ms/token at {', '.join(dec) or 'none (an encoder)'}; peak memory "
        f"{peak:.2f} GiB")


# --------------------------------------------------------------------------
# 5. backward kernels against their plain backwards
# --------------------------------------------------------------------------

def _bwd_gate(name, out, ref, exact_zero_scale=None):
    """A backward kernel's output against the plain backward in fp32 on the
    same inputs; returns the max abs error. fp32: relative L2 within 1e-4.
    bf16 (fp32 of the same bf16 inputs): BF16_LIMITS, with each row's error
    taken against its norm plus 2^-6 of the typical row norm and the
    pointwise limit 2^-7 |ref| + 2^-6 rms(ref row) + 2^-6 rms(ref): rows
    whose exact gradient cancels to ~0 (the first causal row of dq) are
    rounding noise on both sides. ``exact_zero_scale``: the exact result is
    0 (dq, dk at S = 1: one live key, dS = P (dO.v - dO.o) with o = v), so
    |out| must stay below 1e-3 of that scale (max |dv|)."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: not finite")
    out32 = out.float()
    if exact_zero_scale is not None:
        got = out32.abs().max().item()
        if not got <= 1e-3 * exact_zero_scale:
            raise AssertionError(f"{name}: max |out| {got:.3e} > 1e-3 x {exact_zero_scale:.3e}")
        log(f"[bwd] {name} exact 0: max |out| {got:.3e} (limit {1e-3 * exact_zero_scale:.3e}) ok")
        return got
    err = out32 - ref
    max_abs = err.abs().max().item()
    rel = (err.norm() / ref.norm()).item()
    if out.dtype == torch.float32:
        if not rel <= 1e-4:
            raise AssertionError(f"{name}: rel_l2={rel:.3e} > 1e-4")
        log(f"[bwd] {name} rel_l2={rel:.3e} (limit 1e-4) max_abs_err={max_abs:.3e} ok")
        return max_abs
    R, E = ref.reshape(-1, ref.shape[-1]), err.reshape(-1, ref.shape[-1])
    rows = R.norm(dim=-1)
    typical = R.norm() / R.shape[0] ** 0.5
    limit = (2 ** -7 * R.abs() + 2 ** -6 * rows[:, None] / R.shape[-1] ** 0.5
             + 2 ** -6 * typical / R.shape[-1] ** 0.5)
    got = {"rel_l2": rel,
           "row_rel_l2": (E.norm(dim=-1) / (rows + 2 ** -6 * typical)).max().item(),
           "pointwise": (E.abs() / limit).max().item()}
    reading = " ".join(f"{k}={v:.3e} (limit {BF16_LIMITS[k]:g})" for k, v in got.items())
    bad = [k for k, v in got.items() if not v <= BF16_LIMITS[k]]
    if bad:
        raise AssertionError(f"{name}: {reading}: over the limit in {bad}")
    log(f"[bwd] {name} {reading} max_abs_err={max_abs:.3e} ok")
    return max_abs


def _lse_gate(name, lse, ref):
    """The forward kernel's row log-sum-exp (log2 units) against the plain
    forward's on the same inputs: finite, and max |err| / (1 + |ref|)
    within LSE_LIMITS (a P of the backward moves by ln 2 times it)."""
    torch.cuda.synchronize()
    if not torch.isfinite(lse).all():
        raise AssertionError(f"{name} lse: not finite")
    got = ((lse - ref).abs() / (1 + ref.abs())).max().item()
    limit = LSE_LIMITS[name.split()[1]]
    if not got <= limit:
        raise AssertionError(f"{name} lse: max |err|/(1+|ref|) {got:.3e} > {limit:g}")
    log(f"[bwd] {name} lse max |err|/(1+|ref|)={got:.3e} (limit {limit:g}) ok")


def _flash_bwd_case(name, q, k, v, window, do=None, causal=True):
    """The forward kernel's LSE and the backward kernels against the plain
    forward and backward on the same inputs (the plain backward given the
    plain forward's LSE), and a second backward call equal bit for bit."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
    from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_fwd_ref
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    gen = torch.Generator(device="cuda").manual_seed(q.shape[2])
    if do is None:
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal, window=window)
    _, lse_ref = flash_attention_fwd_ref(q.float(), k.float(), v.float(), causal=causal,
                                         window=window)
    _lse_gate(name, lse, lse_ref)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two backward calls differ")
    want = flash_attention_bwd_ref(q.float(), k.float(), v.float(), o.float(), do.float(),
                                   lse_ref, causal=causal, window=window)
    errs = []
    for i, (part, g, w) in enumerate(zip(("dq", "dk", "dv"), got, want)):
        zero = want[2].abs().max().item() if q.shape[2] == 1 and i < 2 else None
        errs.append(_bwd_gate(f"{name} {part}", g, w, exact_zero_scale=zero))
    return max(errs)


def _ssd_bwd_case(name, chunk, x, dt, A, Bm, Cm, initial_state=None, d_final=None, fma=False):
    """The SSD backward kernel against the plain backward in fp32 on the same
    inputs (the plain one at its own ``chunk``): the ``bwd_kernel_path``
    kernel through ``ssd_scan_bwd``, or with ``fma`` the FMA kernel whatever
    the path (``launch_bwd_fma``, not counted). Each output through
    ``_bwd_gate``: the fp32 outputs (all six of an fp32 call; ddt, dA and
    d_initial of a bf16 one) within relative L2 SSD_F32_REL_L2, which equals
    ``_bwd_gate``'s fp32 limit; bf16 dx, dBm and dCm within BF16_LIMITS. dA
    [nh], a sum over b and s, is gated as one vector. Where the exact
    gradient is 0 (dA at S = 1 from a zero state), |out| must stay below
    1e-3 of max |ddt|. A second call must give the same bits. Returns the
    largest max abs error of dx, dBm and dCm."""
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    from repro_torch.kernels.ssd_scan import launch_bwd_fma
    assert SSD_F32_REL_L2 == 1e-4       # _bwd_gate's fp32 limit
    gen = torch.Generator(device="cuda").manual_seed(x.shape[2])
    dy = torch.randn(x.shape, generator=gen, device="cuda").to(x.dtype)
    fn = launch_bwd_fma if fma else ssd_scan_bwd
    got = fn(x, dt, A, Bm, Cm, dy, initial_state, d_final)
    again = fn(x, dt, A, Bm, Cm, dy, initial_state, d_final)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name}: two backward calls differ")
    want = ssd_scan_bwd_ref(x.float(), dt, A, Bm.float(), Cm.float(), dy.float(), initial_state,
                            d_final, chunk=chunk)
    errs = []
    for part, out, ref in zip(("dx", "ddt", "dA", "dBm", "dCm", "d_initial"), got, want):
        if part == "dA":
            out, ref = out[None], ref[None]
        zero = want[1].abs().max().item() if not ref.abs().max().item() else None
        err = _bwd_gate(f"{name} {part}", out, ref, exact_zero_scale=zero)
        if part in ("dx", "dBm", "dCm"):
            errs.append(err)
    return max(errs)


def ssd_bwd_bound(x, dt, A, Bm, Cm, dtype):
    """(bound ms, "bytes" or "operations") of the SSD backward on these
    inputs: read x, dy, dt, A, Bm, Cm once and write dx, ddt, dA, dBm, dCm
    once; the products the kernel's 64-token chunks need
    (``kernels.ssd_scan.bwd_flops``, the count its ``FlopCounterMode``
    formula gives)."""
    from repro_torch.kernels.ssd_scan import bwd_flops
    B, nh, S, hp = x.shape
    N = Bm.shape[-1]
    e = x.element_size()
    nbytes = 3 * x.numel() * e + 2 * (dt.numel() + A.numel()) * 4 + 4 * Bm.numel() * e
    return _bound(nbytes, bwd_flops(B, nh, S, hp, N), dtype)


def phase_ssd_bwd_parity():
    """The SSD backward against its plain backward, fp32 and bf16:
    SSD_CASES, SSD_WGMMA_CASES and SSD_WGMMA_N16_CASES (S 1 to 2000 around
    the 64-token chunks), each with the tests' draw and the long-memory
    one; mamba2's training shape and hymba's (50 heads, hp 64, N 16) in the
    model's layout (x, Bm, Cm column slices of one buffer, dt a [B,nh,S]
    view) with both draws; an initial_state with a final-state gradient at
    both shapes. bf16 at hp 64 / N 16, 64, 128 runs on the wgmma path, and
    each such case runs again on the FMA kernel, as every case did before
    the wgmma path existed. Returns the max abs errors at the training
    shapes, long-memory draw: {("ssd_scan_bwd", dtype): err} and
    {("ssd_scan_bwd fma", bf16): err} at mamba2's,
    {("ssd_scan_bwd_n16", bf16): err} (wgmma) and {("ssd_scan_bwd_fma",
    dtype): err} (the FMA kernel) at hymba's."""
    from repro_torch.kernels.ssd_scan import bwd_kernel_path
    gen = torch.Generator(device="cuda").manual_seed(19)
    errs = {}

    def case(tag, dtype, B, nh, S, hp, N, chunk, *inputs, **state):
        paths = ([False, True] if bwd_kernel_path(dtype, hp, N) == "wgmma" else [False])
        out = {}
        for fma in paths:
            label = "fma" if fma or len(paths) == 1 else "wgmma"
            out[label] = _ssd_bwd_case(f"ssd_bwd [{label}] {tag}", chunk, *inputs, fma=fma,
                                       **state)
        return out

    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for B, nh, S, hp, N, chunk in SSD_CASES + [c + (256,) for c in SSD_WGMMA_CASES
                                                   + SSD_WGMMA_N16_CASES]:
            for long_memory in (False, True):
                case(f"{tag} B,nh,S,hp,N=({B},{nh},{S},{hp},{N})"
                     f"{' long-memory' if long_memory else ''}", dtype, B, nh, S, hp, N, chunk,
                     *_ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory))
        for B, nh, S, hp, N in (SSD_BWD_N16, SSD_BWD_MAIN):
            for long_memory in (False, True):
                got = case(f"{tag} B,nh,S,hp,N=({B},{nh},{S},{hp},{N}) [B,S,.] views"
                           f"{' long-memory' if long_memory else ''}", dtype, B, nh, S, hp, N, 256,
                           *_ssd_inputs(gen, B, nh, S, hp, N, dtype, long_memory, True))
                if (B, nh, S, hp, N) == SSD_BWD_MAIN and long_memory:
                    errs[("ssd_scan_bwd", dtype)] = got.get("wgmma", got["fma"])
                    if dtype == torch.bfloat16:
                        errs[("ssd_scan_bwd fma", dtype)] = got["fma"]
                if (B, nh, S, hp, N) == SSD_BWD_N16 and long_memory:
                    errs[("ssd_scan_bwd_fma", dtype)] = got["fma"]
                    if dtype == torch.bfloat16:
                        errs[("ssd_scan_bwd_n16", dtype)] = got["wgmma"]
            h0 = torch.randn(B, nh, hp, N, generator=gen, device="cuda")
            d_final = torch.randn(B, nh, hp, N, generator=gen, device="cuda")
            case(f"{tag} B,nh,S,hp,N=({B},{nh},{S},{hp},{N}) [B,S,.] views long-memory, "
                 f"initial_state and d_final", dtype, B, nh, S, hp, N, 256,
                 *_ssd_inputs(gen, B, nh, S, hp, N, dtype, True, True),
                 initial_state=h0, d_final=d_final)
    return errs


def phase_bwd_parity():
    """Each backward kernel against its plain backward (``kernels/ref.py``)
    on the same inputs, the forward kernels' LSE against the plain
    forward's, and each backward twice for the same bits: flash at hd
    32/64/80/128/192 (bf16 hd 64/80/128/192 on the wgmma path, the rest on
    the mma path), GQA groups 1, 2 and 8, S 1, 127, 200 and 2048, causal
    and one window, the model's strided views, the training shape,
    hymba-1.5b's (group 5, window 1024) and granite-moe's (group 3);
    non-causal at hubert-xlarge's training shape (hd 80, fp32 and bf16), a
    tail at hd 80 and hd 128; hd 192 non-causal and at nemotron-4-340b's
    layer (``flash_bwd_hd192_parity``); RMSNorm at H 256, 1280,
    1000, 1536, 1600, 2560, 3200, 4096, 5120 and 12288 (the register
    version at 1536/1600/2560/3200/4096/5120 in bf16) and T 1-4096."""
    from repro_torch.kernels import rmsnorm_bwd
    from repro_torch.kernels.ref import rmsnorm_bwd_ref
    gen = torch.Generator(device="cuda").manual_seed(17)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).replace("torch.", "")
        for hd in (32, 64, 80, 128, 192):
            for B, S, nh, nkv, window in FLASH_BWD_CASES:
                _flash_bwd_case(f"flash_bwd {tag} hd={hd} B,S,nh,nkv=({B},{S},{nh},{nkv}) "
                                f"window={window}", *_flash_inputs(gen, B, S, nh, nkv, hd, dtype),
                                window)
        if dtype == torch.bfloat16:
            # hymba-1.5b's (group 5, window 1024) and granite-moe's (group 3)
            # training shapes, in the model's [B,S,nh,hd] layout
            for case in (FLASH_BWD_HYMBA, FLASH_BWD_GRANITE):
                B, S, nh, nkv, window, hd = case
                q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                           for t in _flash_inputs(gen, B, S, nh, nkv, hd, dtype))
                do = _randn(gen, B, S, nh, hd, dtype=dtype).transpose(1, 2)
                _flash_bwd_case(f"flash_bwd {tag} {case[:4]} hd={hd} window={window} "
                                f"[B,S,nh,hd] views", q, k, v, window, do)
        # hubert-xlarge's training shape, non-causal, in the model's layout;
        # a tail of 2 rows at hd 80, and hd 128
        B, S, nh, nkv, window, hd = FLASH_BWD_HUBERT
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _flash_inputs(gen, B, S, nh, nkv, hd, dtype))
        do = _randn(gen, B, S, nh, hd, dtype=dtype).transpose(1, 2)
        errs[("flash_attention_bwd_hd80", dtype)] = _flash_bwd_case(
            f"flash_bwd {tag} non-causal hubert {FLASH_BWD_HUBERT[:4]} hd={hd} [B,S,nh,hd] views",
            q, k, v, window, do, causal=False)
        for B, S, nh, nkv, hd in FLASH_NONCAUSAL_CASES:
            _flash_bwd_case(f"flash_bwd {tag} non-causal hd={hd} B,S,nh,nkv=({B},{S},{nh},{nkv})",
                            *_flash_inputs(gen, B, S, nh, nkv, hd, dtype), 0, causal=False)
        errs[("flash_attention_bwd_hd192", dtype)] = flash_bwd_hd192_parity(gen, dtype)
        B, S, nh, nkv, window, hd = FLASH_BWD_MAIN
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in _flash_inputs(gen, B, S, nh, nkv, hd, dtype))
        do = _randn(gen, B, S, nh, hd, dtype=dtype).transpose(1, 2)
        errs[("flash_attention_bwd", dtype)] = _flash_bwd_case(
            f"flash_bwd {tag} main {FLASH_BWD_MAIN[:4]} hd={hd} [B,S,nh,hd] views", q, k, v,
            window, do)
        for T, H in RMS_BWD_CASES + [RMS_BWD_MAIN] + RMS_BWD_NEW:
            x, w, dy = _randn(gen, T, H, dtype=dtype), _randn(gen, H, dtype=dtype), \
                _randn(gen, T, H, dtype=dtype)
            dx, dw = rmsnorm_bwd(x, w, dy)
            again = rmsnorm_bwd(x, w, dy)
            if not (torch.equal(dx, again[0]) and torch.equal(dw, again[1])):
                raise AssertionError(f"rmsnorm_bwd {tag} T,H=({T},{H}): two calls differ")
            want = rmsnorm_bwd_ref(x.float(), w.float(), dy.float())
            err = max(_bwd_gate(f"rmsnorm_bwd {tag} T,H=({T},{H}) dx", dx, want[0]),
                      _bwd_gate(f"rmsnorm_bwd {tag} T,H=({T},{H}) dw", dw[None], want[1][None]))
            if (T, H) == RMS_BWD_MAIN:
                errs[("rmsnorm_bwd", dtype)] = err
            if (T, H) in RMS_BWD_NEW:
                errs[("rmsnorm_bwd", dtype, H)] = err
    return errs


# --------------------------------------------------------------------------
# 6. training slices: full-width yi-6b at 16 layers, mamba2-2.7b at 64
# --------------------------------------------------------------------------

def _train_arch(name, layers=None):
    """``name`` at full width, cut to ``layers`` (TRAIN_LAYERS[name] by
    default)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(name), num_layers=layers or TRAIN_LAYERS[name])


def _train_cfg(dtype=torch.bfloat16, remat=False):
    from repro_torch.models.lm import RunCfg
    from repro_torch.train.optim import OptimizerCfg
    from repro_torch.train.step import TrainCfg
    return TrainCfg(run=RunCfg(compute_dtype=dtype, remat=remat),
                    opt=OptimizerCfg(peak_lr=3e-4, warmup_steps=2, decay_steps=TRAIN_STEPS),
                    num_microbatches=TRAIN_G)


def _train_data(arch):
    from repro_torch.train.data import DataCfg, SyntheticDataset
    return SyntheticDataset(arch, DataCfg(seq_len=TRAIN_S, global_batch=TRAIN_G,
                                          num_microbatches=TRAIN_G, seed=0))


def _step_launches(arch):
    """Kernel launches of one train step, remat off: for each of the G
    microbatches a forward's (``_forward_launches``: per layer a flash
    forward where the arch has attention, an SSD forward where it has the
    SSM, its RMSNorms, the final norm) and a backward of each."""
    fwd = _forward_launches(arch)
    bwd = {f"{k}_bwd": n for k, n in fwd.items() if n and not k.endswith("_bwd")}
    return _launches(**{k: n * TRAIN_G for k, n in {**fwd, **bwd}.items() if n})


def _grads(model, batch, cfg, plain=False, remat=None):
    """(grads, loss, grad global norm, launches) of the G microbatches
    (``accumulate_grads``, the gradient half of the train step); with
    ``plain``, through the plain versions; ``remat`` overrides the model's."""
    import dataclasses
    from repro_torch.train.optim import global_norm
    from repro_torch.train.step import accumulate_grads
    saved = model.cfg
    if remat is not None:
        model.cfg = dataclasses.replace(saved, remat=remat)
    try:
        with plain_versions() if plain else contextlib.nullcontext():
            (grads, loss, _), counts = _counts_since_reset(
                lambda: accumulate_grads(model, batch, cfg))
    finally:
        model.cfg = saved
    return grads, loss.item(), global_norm(grads).item(), counts


def _rel_by_leaf(grads, ref):
    return {n: ((g.float() - ref[n]).norm() / ref[n].norm().clamp_min(1e-30)).item()
            for n, g in grads.items()}


@torch.no_grad()
def _fan_in_h(model):
    """Rescale wq, wk, wv, the MLP's or the experts' wi and wg, and the
    SSM's in_proj, where the arch has them, from the reference's std
    (1/L)^0.5 to (1/H)^0.5 (``lm._dense`` takes fan-in from the layer axis;
    ROADMAP §3)."""
    a = model.arch
    scaled = {"attn": ("wq", "wk", "wv"), "mlp": ("wi", "wg"), "moe": ("wi", "wg"),
              "ssm": ("in_proj",)}
    for blk in model.blocks:
        for group, names in scaled.items():
            for name in names:
                if hasattr(blk, group) and name in getattr(blk, group):
                    getattr(blk, group)[name].mul_((a.num_layers / a.d_model) ** 0.5)
    return model


def _bf16_grads_vs_fp32(arch, batch, init):
    """bf16 gradients of G microbatches through the kernels and through the
    plain versions, each against fp32 of the same weights (plain versions,
    remat on); the kernels' launches gated exactly. Returns the readings."""
    from repro_torch.models.lm import LM, RunCfg, init_params
    model = init(init_params(arch, torch.Generator(device="cuda").manual_seed(0),
                             RunCfg(compute_dtype=torch.bfloat16, remat=False), device="cuda"))
    model32 = LM(arch, RunCfg(compute_dtype=torch.float32), device="cuda")
    model32.load_state_dict(model.state_dict())
    g32, l32, n32, _ = _grads(model32, batch, _train_cfg(torch.float32), plain=True, remat=True)
    del model32
    torch.cuda.empty_cache()
    gk, lk, nk, counts = _grads(model, batch, _train_cfg())
    if counts != _step_launches(arch):
        raise AssertionError(f"gradients launched {counts}, expected {_step_launches(arch)}")
    rel_k = _rel_by_leaf(gk, g32)
    del gk
    gp, lp, np_, counts = _grads(model, batch, _train_cfg(), plain=True, remat=True)
    if any(counts.values()):
        raise AssertionError(f"plain versions launched {counts}")
    rel_p = _rel_by_leaf(gp, g32)
    del gp, g32, model
    torch.cuda.empty_cache()
    return dict(loss=(l32, lk, lp), norm=(n32, nk, np_), rel_k=rel_k, rel_p=rel_p)


def _fp32_grads_vs_fp64(arch, batch, init, total):
    """fp32 gradients through the kernels and through the plain versions,
    and fp64 gradients through the plain versions, of the same weights and
    batch: ((loss kernels, plain, fp64), (grad norms), (leaf relative L2
    of kernels to plain, of kernels to fp64, of plain to fp64), (relative L2
    of the whole gradient of kernels to fp64, of plain to fp64)). The
    kernels' launches (the fp32 paths: the SSD's FMA kernels) are added to
    ``total``."""
    import dataclasses
    from repro_torch.models.lm import LM, RunCfg, init_params
    model = init(init_params(arch, torch.Generator(device="cuda").manual_seed(0),
                             RunCfg(compute_dtype=torch.float32, remat=False), device="cuda"))
    cfg = _train_cfg(torch.float32)
    gk, lk, nk, counts = _grads(model, batch, cfg)
    total.add(counts, arch, torch.float32)
    gp, lp, np_, _ = _grads(model, batch, cfg, plain=True)
    model64 = LM(arch, RunCfg(compute_dtype=torch.float64, remat=False), device="cuda")
    model64.load_state_dict(model.state_dict())
    del model
    cfg64 = dataclasses.replace(_train_cfg(torch.float64), grad_accum_dtype=torch.float64)
    g64, l64, n64, _ = _grads(model64, batch, cfg64, plain=True)
    rels = (_rel_by_leaf(gk, gp), _rel_by_leaf(gk, g64), _rel_by_leaf(gp, g64))
    whole = tuple(math.sqrt(sum((r[n] * g64[n].norm().item()) ** 2 for n in r)) / n64
                  for r in rels[1:])
    del gk, gp, g64, model64
    torch.cuda.empty_cache()
    return (lk, lp, l64), (nk, np_, n64), rels, whole


def train_grads_gate(name, total):
    """(a) The gradients of the G microbatches (``accumulate_grads``, the
    train step's gradient half) through the kernels and through the plain
    versions from the same weights and batch, under two inits of the same
    seed: the reference's, and the same weights with wq, wk, wv, wi, wg
    (mamba2: in_proj) at fan-in H (``_fan_in_h``). yi-6b at 16 layers,
    mamba2 at all 64. Under the reference's init attention is a
    hard argmax (logits of std ~250 at 16 layers, ~2000 at 2): dS = P (dP
    - D) cancels for the one live entry of a row, so gradients upstream of
    the scores turn on rounding, and two correct backwards (the kernels'
    FA2 form, autograd's softmax form) differ by percents even in fp32.
    bf16 at TRAIN_LAYERS: each route against fp32 of the same weights (plain
    versions): the kernels' distance to fp32 of the loss, the global norm
    and each leaf within 1.5x the plain versions' (or 1e-3 of the loss,
    1e-2 relative of a norm or leaf, where the plain versions land
    closer); gated on fan-in-H weights, reported on the reference's init.
    fp32 at 2 layers, both inits gated: each route against fp64 of the
    same weights (plain versions), the kernels' distance within 1.5x the
    plain versions' (or 1e-5 of the loss, 1e-4 relative L2 of the whole
    gradient or a leaf); the global norm of a gradient that is ~12%
    rounding noise moves by a few percent either way, so under the
    reference's init it is reported, and the whole gradient's distance
    gated. On fan-in-H weights also kernels against plain versions within
    1e-3 relative L2 for the norm and each leaf, 1e-5 for the loss. The
    fp32 runs' kernel launches are added to ``total``."""
    arch = _train_arch(name)
    batch = _train_data(arch).batch_at(0)
    for init_name, init in (("reference init", lambda m: m), ("fan-in-H init", _fan_in_h)):
        r = _bf16_grads_vs_fp32(arch, batch, init)
        (l32, lk, lp), (n32, nk, np_), rel_k, rel_p = r["loss"], r["norm"], r["rel_k"], r["rel_p"]
        ratios = {n: rel_k[n] / max(rel_p[n], 1e-30) for n in rel_k}
        worst = sorted(ratios, key=ratios.get)[-3:]
        gated = init_name != "reference init"
        log(f"[train] (a) {name} bf16 {arch.num_layers} layers, {init_name} "
            f"({'gated' if gated else 'reported'}),"
            f" G={TRAIN_G} x S={TRAIN_S}: loss fp32 {l32:.6f}, kernels {lk:.6f}, plain {lp:.6f}; "
            f"grad norm fp32 {n32:.6g}, kernels {nk:.6g}, plain {np_:.6g}; leaf rel_l2 to fp32: "
            f"kernels median {statistics.median(rel_k.values()):.4g} max "
            f"{max(rel_k.values()):.4g}, plain median {statistics.median(rel_p.values()):.4g} "
            f"max {max(rel_p.values()):.4g}; highest kernels/plain "
            + ", ".join(f"{n} {rel_k[n]:.4g}/{rel_p[n]:.4g}" for n in worst))
        if not all(math.isfinite(x) for x in (l32, lk, lp, n32, nk, np_)):
            raise AssertionError(f"bf16 gradients ({init_name}): a loss or norm is not finite")
        if not gated:
            continue
        for what, k, p, floor in (("loss", abs(lk - l32), abs(lp - l32), 1e-3 * abs(l32)),
                                  ("grad norm", abs(nk - n32) / n32, abs(np_ - n32) / n32,
                                   1e-2)):
            if not k <= max(1.5 * p, floor):
                raise AssertionError(f"bf16 {what}: kernels {k:.4g} from fp32, plain {p:.4g}")
        bad = [n for n in rel_k if not rel_k[n] <= max(1.5 * rel_p[n], 1e-2)]
        if bad:
            raise AssertionError("bf16 gradients further from fp32 than the plain versions "
                                 "allow: " + ", ".join(f"{n} {rel_k[n]:.4g}/{rel_p[n]:.4g}"
                                                        for n in bad))
    arch2 = _train_arch(name, 2)
    batch2 = _train_data(arch2).batch_at(0)
    for init_name, init in (("reference init", lambda m: m), ("fan-in-H init", _fan_in_h)):
        (lk, lp, l64), (nk, np_, n64), (rel, rel_k, rel_p), (whole_k, whole_p) = \
            _fp32_grads_vs_fp64(arch2, batch2, init, total)
        ratios = {n: rel_k[n] / max(rel_p[n], 1e-30) for n in rel_k}
        worst = sorted(ratios, key=ratios.get)[-3:]
        log(f"[train] (a) {name} fp32 2 layers, {init_name}: loss kernels {lk:.7f} plain "
            f"{lp:.7f} fp64 "
            f"{l64:.7f}; grad norm kernels {nk:.7g} plain {np_:.7g} fp64 {n64:.7g}; whole "
            f"gradient rel_l2 to fp64 kernels {whole_k:.3e} plain {whole_p:.3e}; leaf rel_l2 "
            f"kernels to plain max {max(rel.values()):.3e} ({max(rel, key=rel.get)}) median "
            f"{statistics.median(rel.values()):.3e}; to fp64: kernels median "
            f"{statistics.median(rel_k.values()):.3e} max {max(rel_k.values()):.3e}, plain "
            f"median {statistics.median(rel_p.values()):.3e} max {max(rel_p.values()):.3e}; "
            f"highest kernels/plain " + ", ".join(f"{n} {rel_k[n]:.3e}/{rel_p[n]:.3e}"
                                                  for n in worst))
        for what, k, p, floor in (("loss", abs(lk - l64) / abs(l64), abs(lp - l64) / abs(l64),
                                   1e-5),
                                  ("whole gradient", whole_k, whole_p, 1e-4)):
            if not k <= max(1.5 * p, floor):
                raise AssertionError(f"fp32 {what} ({init_name}): kernels {k:.4g} from fp64, plain "
                                     f"{p:.4g}")
        bad = [n for n in rel_k if not rel_k[n] <= max(1.5 * rel_p[n], 1e-4)]
        if bad:
            raise AssertionError(f"fp32 gradients ({init_name}) further from fp64 than the plain "
                                 "versions allow: " + ", ".join(
                                     f"{n} {rel_k[n]:.4g}/{rel_p[n]:.4g}" for n in bad))
        if init_name != "reference init" and not (abs(lk - lp) <= 1e-5 * abs(lp)
                                             and abs(nk - np_) <= 1e-3 * np_
                                             and max(rel.values()) <= 1e-3):
            raise AssertionError("fp32 gradients through the kernels differ from the plain "
                                 "versions")


def _check_against_checkpoint(state, ckpt_dir, step):
    """Every master, moment and the step of ``state`` equal, bit for bit,
    to the checkpoint of ``step`` in ``ckpt_dir`` (read a stacked leaf at a
    time)."""
    import numpy as np
    from repro_torch.convert import tree_path
    path = Path(ckpt_dir) / f"step_{step:08d}" / "arrays.npz"
    leaves = {}
    for tree, named in (("params::", state.params), ("opt_state::m/", state.opt_state["m"]),
                        ("opt_state::v/", state.opt_state["v"])):
        for name, t in named.items():
            keys, layer = tree_path(name)
            leaves.setdefault(tree + "/".join(keys), []).append((layer, t))
    with np.load(path) as data:
        if int(data["opt_state::step"]) != int(state.opt_state["step"]):
            raise AssertionError("checkpoint step differs")
        for key, items in leaves.items():
            arr = data[key]
            for layer, t in items:
                a = torch.from_numpy(arr if layer is None else arr[layer]).to(t.device)
                if a.dtype != t.dtype or not torch.equal(a, t):
                    raise AssertionError(f"checkpoint {key} layer {layer} differs from the state")
    return len(leaves)


def train_loop_and_restore(name, total, layers=None):
    """(b) ``train_loop`` for TRAIN_STEPS steps on the synthetic stream into
    a checkpoint directory, its launches gated exactly (and added to
    ``total``): finite losses and grad norms; the checkpoint equal to the
    state bit for bit; a second ``train_loop`` over the same directory
    restores it (running no step) to the same state bit for bit. ``name``
    at ``layers`` (TRAIN_LAYERS[name] by default). Frees the state."""
    from repro_torch.launch.train import train_loop
    from repro_torch.train.data import DataCfg
    arch, cfg = _train_arch(name, layers), _train_cfg()
    data = DataCfg(seq_len=TRAIN_S, global_batch=TRAIN_G, num_microbatches=TRAIN_G, seed=0)
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        t0 = time.perf_counter()
        (state, losses, gnorms), counts = _counts_since_reset(lambda: train_loop(
            arch, cfg, data, TRAIN_STEPS, ckpt_dir=ckpt, log_every=1, ckpt_every=TRAIN_STEPS,
            log_fn=lambda m: log(f"[train] (b) {m}"), device="cuda"))
        seconds = time.perf_counter() - t0
        total.add(counts, arch)
        want = {k: n * TRAIN_STEPS for k, n in _step_launches(arch).items()}
        if counts != want:
            raise AssertionError(f"train_loop launched {counts}, expected {want}")
        log(f"[train] (b) {name} {arch.num_layers} layers: train_loop {TRAIN_STEPS} steps in "
            f"{seconds:.1f} s (init, steps and a "
            f"checkpoint): losses {[round(x, 4) for x in losses]}, grad norms "
            f"{[round(x, 4) for x in gnorms]}; launches {counts}")
        if not all(math.isfinite(x) for x in losses + gnorms):
            raise AssertionError("train_loop: a loss or grad norm is not finite")
        t0 = time.perf_counter()
        n = _check_against_checkpoint(state, ckpt, TRAIN_STEPS)
        log(f"[train] (b) checkpoint step {TRAIN_STEPS}: {n} stacked leaves equal the state bit "
            f"for bit ({time.perf_counter() - t0:.1f} s)")
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        state, losses, _ = train_loop(arch, cfg, data, TRAIN_STEPS, ckpt_dir=ckpt,
                                      log_fn=lambda m: log(f"[train] (b) {m}"), device="cuda")
        if losses:
            raise AssertionError(f"the resumed train_loop ran {len(losses)} steps, expected 0")
        _check_against_checkpoint(state, ckpt, TRAIN_STEPS)
        log(f"[train] (b) restored by train_loop in {time.perf_counter() - t0:.1f} s: equal "
            f"bit for bit")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()


def train_step_descent_and_times(name, total):
    """(c) ``make_train_step`` for TRAIN_STEPS steps on one fixed batch from
    a fresh train state (the seed of (b)), remat off: the first step's
    launches counted exactly (and added to ``total``); finite losses, the
    mean of the last 3 below the first; the steps after the first two
    timed (host clock around synchronised steps); peak memory over all of
    them. One batch, not the stream: a 4,096-token batch sees ~6% of the
    64,000-token vocabulary, so over 10 steps of fresh batches the loss
    only wanders by the batches' own spread (PERF.md); a fixed batch shows
    whether the steps descend."""
    from repro_torch.train.step import init_train_state, make_train_step
    arch, cfg = _train_arch(name), _train_cfg()
    batch = _train_data(arch).batch_at(0)
    state = init_train_state(arch, cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    step = make_train_step(arch, cfg)
    torch.cuda.reset_peak_memory_stats()
    ms, losses = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            (state, metrics), counts = _counts_since_reset(lambda: step(state, batch))
        else:
            state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if i == 0:
            total.add(counts, arch)
            if counts != _step_launches(arch):
                raise AssertionError(f"one train step launched {counts}, expected "
                                     f"{_step_launches(arch)}")
            log(f"[train] (c) {name} one train step, remat off, G={TRAIN_G}: launches {counts} "
                f"(exact)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train] (c) {name} {TRAIN_STEPS} steps on one fixed batch: losses "
        f"{[round(x, 4) for x in losses]}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train step losses not finite: {losses}")
    if not statistics.mean(losses[-3:]) < losses[0]:
        raise AssertionError(f"train step: loss did not fall ({losses})")
    med = statistics.median(ms[2:])
    log(f"[time] train step {name} {arch.num_layers} layers, G={TRAIN_G} x 1 x {TRAIN_S} tokens, "
        f"bf16 compute, fp32 masters and moments, remat off: median {med:.2f} ms of "
        f"{[round(x, 2) for x in ms[2:]]} (warm-up {ms[0]:.2f}, {ms[1]:.2f}); "
        f"{TRAIN_G * TRAIN_S / med * 1e3:.1f} tokens/s; peak memory {peak:.2f} GiB")
    return med, peak


def _flash_bwd_row(gen, case, causal=True, name="flash_attention_bwd"):
    """The flash backward at ``case`` (B, S, nh, nkv, window, hd), bf16,
    beside its bound, its plain backward and SDPA's backward through
    autograd (``enable_gqa``, ``is_causal=causal``; a boolean band mask for
    a window)."""
    from repro_torch.kernels import flash_attention_bwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.ref import attention_mask, flash_attention_bwd_ref
    dt = torch.bfloat16
    B, S, nh, nkv, window, hd = case
    q, k, v = _flash_inputs(gen, B, S, nh, nkv, hd, dt)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window)
    do = _randn(gen, B, nh, S, hd, dtype=dt)
    (bound, by), flops = flash_bwd_bound(q, k, causal, window)
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    if window:
        lo = F.scaled_dot_product_attention(ql, kl, vl, enable_gqa=True,
                                            attn_mask=attention_mask(S, True, window, q.device))
    else:
        lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, enable_gqa=True)
    r = dict(name=name,
             ms=time_device(lambda: flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                                        window=window)),
             plain_ms=time_device(lambda: flash_attention_bwd_ref(q, k, v, o, do, lse,
                                                                  causal=causal, window=window),
                                  n=3, reps=3),
             library_ms=time_device(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                                retain_graph=True)),
             bound_ms=bound, bound_by=by,
             shape=f"q{list(q.shape)} kv{list(k.shape)} bf16 "
                   f"{f'causal window={window}' if causal else 'non-causal'}")
    log(f"[time] flash_attention_bwd {list(case)}{'' if causal else ' non-causal'}: "
        f"{flops / r['ms'] / 1e9:.1f} TFLOP/s, "
        f"{100 * bound / r['ms']:.1f}% of the bound; SDPA backward "
        f"{flops / r['library_ms'] / 1e9:.1f} TFLOP/s; kernel / SDPA = "
        f"{r['ms'] / r['library_ms']:.3f}")
    return r


def _rms_bwd_row(gen, T, H):
    """The RMSNorm backward at [T, H], bf16, beside its bound, its plain
    backward and ``F.rms_norm``'s backward through autograd; the row names
    its version (``bwd_kernel_path``)."""
    from repro_torch.kernels import rmsnorm_bwd
    from repro_torch.kernels.ref import rmsnorm_bwd_ref
    from repro_torch.kernels.rmsnorm import bwd_kernel_path
    dt = torch.bfloat16
    x, w, dy = _randn(gen, T, H, dtype=dt), _randn(gen, H, dtype=dt), _randn(gen, T, H, dtype=dt)
    bound, by = _bound((3 * x.numel() + w.numel()) * x.element_size(), 10 * x.numel(),
                       torch.float32)
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    yl = F.rms_norm(xl, (H,), wl, eps=1e-5)
    r = dict(name="rmsnorm_bwd", ms=time_device(lambda: rmsnorm_bwd(x, w, dy)),
             plain_ms=time_device(lambda: rmsnorm_bwd_ref(x, w, dy)),
             library_ms=time_device(lambda: torch.autograd.grad(yl, (xl, wl), dy,
                                                                retain_graph=True)),
             bound_ms=bound, bound_by=by, shape=f"x{list(x.shape)} bf16",
             path=bwd_kernel_path(dt, H), H=H)
    log(f"[time] rmsnorm_bwd ({r['path']}) x[{T}, {H}]: {100 * bound / r['ms']:.1f}% of the "
        f"bound; kernel / F.rms_norm backward = {r['ms'] / r['library_ms']:.3f}")
    return r


def times_train_kernels(gen):
    """The backward kernels at yi-6b's training shapes, bf16, beside their
    bound, their plain backward and the backward of one PyTorch call
    through autograd (SDPA with ``enable_gqa``, ``F.rms_norm``)."""
    return [_flash_bwd_row(gen, FLASH_BWD_MAIN), _rms_bwd_row(gen, *RMS_BWD_MAIN)]


def times_hymba_train_kernels(gen):
    """hymba-1.5b's backward kernels at its training shapes, bf16: the SSD
    backward on the wgmma path at N 16 (50 heads; the kernel line's
    ``ssd_scan_bwd_n16``) in turns with the FMA kernel on the same inputs
    (its ``ssd_scan_bwd_fma``), which it must beat; RMSNorm's register
    backward at H 1600 and 3200 (rows under the kernel line's
    ``rmsnorm_bwd``); logged, the windowed flash backward."""
    _log_row(_flash_bwd_row(gen, FLASH_BWD_HYMBA))
    row, fma = times_ssd_bwd_kernel(gen, "ssd_scan_bwd_n16", SSD_BWD_N16)
    return [row, fma] + [_rms_bwd_row(gen, *c) for c in RMS_BWD_NEW[:2]]


def times_hubert_train_kernels(gen):
    """hubert-xlarge's backward kernels at its training shapes, bf16: the
    non-causal flash backward at head dim 80 (the kernel line's
    ``flash_attention_bwd_hd80``) and RMSNorm's loop backward at H 1280 (a
    row under ``rmsnorm_bwd``'s paths)."""
    return [_flash_bwd_row(gen, FLASH_BWD_HUBERT, causal=False, name="flash_attention_bwd_hd80"),
            _rms_bwd_row(gen, *RMS_BWD_NEW[3])]


def times_granite_train_kernels(gen):
    """granite-moe's backward kernels at its training shapes, bf16: RMSNorm's
    register backward at H 1536 (a row under the kernel line's
    ``rmsnorm_bwd``); logged, flash at GQA group 3."""
    _log_row(_flash_bwd_row(gen, FLASH_BWD_GRANITE))
    return [_rms_bwd_row(gen, *RMS_BWD_NEW[2])]


def _ssd_bwd_row(gen, name, case):
    """The SSD backward (``ssd_scan_bwd``, the kernel ``bwd_kernel_path``
    names) at ``case`` (B, nh, S, hp, N), bf16, in the model's layout (x,
    Bm, Cm column slices of one buffer, dt a [B,nh,S] view), beside its
    bound and its plain backward. No single PyTorch call computes it, so
    there is no library time. Returns (the row, its inputs)."""
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.kernels.ref import ssd_scan_bwd_ref
    B, nh, S, hp, N = case
    x, dt, A, Bm, Cm = _ssd_inputs(gen, B, nh, S, hp, N, torch.bfloat16, True, True)
    dy = _randn(gen, B, S, nh, hp, dtype=torch.bfloat16).transpose(1, 2)
    args = (x, dt, A, Bm, Cm, dy)
    bound, by = ssd_bwd_bound(x, dt, A, Bm, Cm, torch.bfloat16)
    row = dict(name=name, ms=time_device(lambda: ssd_scan_bwd(*args)),
               plain_ms=time_device(lambda: ssd_scan_bwd_ref(*args), n=3, reps=3),
               library_ms=None, bound_ms=bound, bound_by=by,
               shape=f"x{list(x.shape)} B/C{list(Bm.shape)} bf16, dt fp32, views")
    return row, args


def times_ssd_bwd_kernel(gen, name="ssd_scan_bwd", case=SSD_BWD_MAIN):
    """(d) The SSD backward at ``case`` (mamba2's training shape by default)
    on the wgmma path (``_ssd_bwd_row``), in turns with the FMA kernel on the
    same inputs (``launch_bwd_fma``: FMA, wgmma, wgmma, FMA), which it must
    beat. Returns (the wgmma row under ``name``, with the FMA time as
    "fma_ms" for its "paths"; the FMA kernel's row, ``ssd_scan_bwd_fma``)."""
    from repro_torch.kernels import ssd_scan_bwd
    from repro_torch.kernels.ssd_scan import bwd_kernel_path, launch_bwd_fma
    assert bwd_kernel_path(torch.bfloat16, *case[3:]) == "wgmma"
    row, args = _ssd_bwd_row(gen, name, case)
    turns = [time_device(lambda: launch_bwd_fma(*args) if which == "fma" else ssd_scan_bwd(*args))
             for which in ("fma", "wgmma", "wgmma", "fma")]
    ms, fma_ms, bound = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2, row["bound_ms"]
    row["ms"], row["fma_ms"] = ms, fma_ms
    log(f"[time] {name} {list(case)} in turns FMA, wgmma, wgmma, FMA: "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms; wgmma {100 * bound / ms:.1f}% of the bound, "
        f"fma {100 * bound / fma_ms:.1f}%; wgmma / fma = {ms / fma_ms:.3f}")
    if not ms < fma_ms:
        raise AssertionError(f"{name}: the wgmma path ({ms:.4f} ms) is not faster than the "
                             f"FMA kernel ({fma_ms:.4f} ms) at {case}")
    return row, dict(row, name="ssd_scan_bwd_fma", ms=fma_ms)


# each training slice's backward kernel times (section 6)
TRAIN_KERNEL_TIMES = {"yi-6b": times_train_kernels,
                      "mamba2-2.7b": lambda g: [times_ssd_bwd_kernel(g)[0]],
                      "hymba-1.5b": times_hymba_train_kernels,
                      "granite-moe-3b-a800m": times_granite_train_kernels,
                      "hubert-xlarge": times_hubert_train_kernels}


def phase_train(total, mark=lambda name: None):
    """Section 6, each model of TRAIN_LAYERS in turn (yi-6b, mamba2-2.7b,
    hymba-1.5b, granite-moe-3b-a800m, hubert-xlarge): (a) gradients, (b) train_loop and
    restore, (c) descent on one batch, one step's launches and the step's
    time; then its backward kernels' times (TRAIN_KERNEL_TIMES). ``mark``
    is called with each model's name when it is done. Returns (the kernel
    rows, {name: (c)'s median step ms and peak GiB})."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows, steps = [], {}
    for name in TRAIN_LAYERS:
        t0 = time.perf_counter()
        train_grads_gate(name, total)
        log(f"[train] (a) {name} done in {time.perf_counter() - t0:.1f} s")
        train_loop_and_restore(name, total, TRAIN_LOOP_LAYERS[name])
        steps[name] = train_step_descent_and_times(name, total)
        rows += TRAIN_KERNEL_TIMES[name](gen)
        mark(f"{name} training")
    for r in rows:
        _log_row(r)
    return rows, steps


# --------------------------------------------------------------------------
# 7. the sharded train step over NCCL on a (1, 1) mesh
# --------------------------------------------------------------------------

def _masters_on_host(state):
    """{name: a CPU copy of each master} (the whole tensor on a (1, 1) mesh)."""
    from repro_torch.parallel.comm import local
    return {n: local(p).detach().to("cpu", copy=True) for n, p in state.params.items()}


def sharded_step_gate(name, layers, steps, total, mesh, single=None, remat=False, comm=None):
    """``name`` at full width cut to ``layers``, from the training phase's
    seed and fixed batch, remat off or on (``remat``: each Block recomputed
    in the backward, its collectives issued again there): one single-device
    step (its loss, launches, masters and peak memory), then ``steps``
    FSDP x TP steps on ``mesh`` through ``init_train_state(mesh=)`` /
    ``make_train_step(mesh=)``. Gates on the first sharded step: launches
    equal the single-device step's, kernel by kernel (added to ``total``);
    the loss equal bit for bit; every master equal bit for bit. Then the
    sharded steps after the first timed (host clock around synchronised
    steps) and the peak memory, logged beside the single-device step's
    peak and ``single`` (the training phase's (median ms, peak GiB) at
    this config); without ``single``, the single-device state takes
    ``steps`` - 1 more steps after the first, timed the same way. With
    ``comm`` (a dict), the first sharded step runs under
    ``launch.comm_analysis.CollectiveCounter``, whose record goes into
    ``comm``."""
    from repro_torch.parallel.comm import local
    from repro_torch.train.step import init_train_state, make_train_step
    arch, cfg = _train_arch(name, layers), _train_cfg(remat=remat)
    batch = _train_data(arch).batch_at(0)
    gen = lambda: torch.Generator(device="cuda").manual_seed(0)
    state = init_train_state(arch, cfg, gen(), "cuda")
    torch.cuda.reset_peak_memory_stats()
    (state, metrics), want = _counts_since_reset(lambda: make_train_step(arch, cfg)(state, batch))
    single_peak = torch.cuda.max_memory_allocated() / 2**30
    loss, masters = float(metrics["loss"]), _masters_on_host(state)
    single_ms = []
    for _ in range(0 if single else steps - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = make_train_step(arch, cfg)(state, batch)
        torch.cuda.synchronize()
        single_ms.append((time.perf_counter() - t0) * 1e3)
    del state, metrics
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(arch, cfg, gen(), "cuda", mesh=mesh)
    step = make_train_step(arch, cfg, mesh)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            counter = contextlib.nullcontext()
            if comm is not None:
                from repro_torch.launch.comm_analysis import CollectiveCounter
                counter = CollectiveCounter()
            with counter:
                (state, got), counts = _counts_since_reset(lambda: step(state, batch))
            if comm is not None:
                comm.update(counter.record())
        else:
            state, got = step(state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        if i:
            continue
        total.add(counts, arch)
        if counts != want:
            raise AssertionError(f"{name}: the sharded step launched {counts}, the single-device "
                                 f"step {want}")
        if float(got["loss"]) != loss:
            raise AssertionError(f"{name}: sharded loss {float(got['loss'])!r}, single-device "
                                 f"{loss!r}")
        off = {}
        for n, p in state.params.items():
            ref = masters[n].to("cuda")
            d = (local(p) - ref).float().norm() / ref.float().norm().clamp_min(1e-30)
            if not torch.equal(local(p), ref):
                off[n] = d.item()
        if off:
            worst = max(off, key=off.get)
            raise AssertionError(f"{name}: {len(off)} of {len(masters)} masters differ from the "
                                 f"single-device step's (worst {worst}: relative L2 "
                                 f"{off[worst]:.3e})")
        log(f"[sharded] {name} {layers} layers on the (1, 1) mesh, remat {'on' if remat else 'off'}, "
            f"step 1: launches {counts} "
            f"(equal to the single-device step's), loss {loss!r} and all {len(masters)} "
            f"masters equal to the single-device step's bit for bit")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del state, masters
    gc.collect()
    torch.cuda.empty_cache()
    timed = (f"median after the first {statistics.median(ms[1:]):.2f} ms; " if len(ms) > 1
             else "")
    beside = (f"; single-device step {single[0]:.2f} ms, peak {single[1]:.2f} GiB "
              f"(training phase, same config)" if single else "")
    if single_ms:
        beside = (f"; single-device steps after the first {[round(x, 2) for x in single_ms]} "
                  f"ms, median {statistics.median(single_ms):.2f} (same call)")
    log(f"[time] sharded train step {name} {layers} layers, remat {'on' if remat else 'off'}, "
        f"(1, 1) mesh over NCCL, G={TRAIN_G} x 1 x {TRAIN_S} tokens: "
        f"{[round(x, 2) for x in ms]} ms (the first with its launches counted); {timed}peak "
        f"memory {peak:.2f} GiB, the single-device step's {single_peak:.2f} GiB (one step, "
        f"same call){beside}")


# mamba2-2.7b's depth in phase 7: 16 of 64 layers, 0.90 B parameters, 16.2 GB
# of train state at 18 B a parameter (fp32 masters and moments, the bf16
# model); the single-device state is freed before the sharded one is built
SHARDED_MAMBA2_LAYERS = 16


@contextlib.contextmanager
def one_rank_nccl():
    """A one-rank NCCL process group (a FileStore in a temporary directory)
    and the (1, 1) ("data", "model") mesh of ``launch.mesh.make_mesh`` on
    it; the group is destroyed at the end."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pg_")
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(os.path.join(tmp, "store"), 1),
                            device_id=torch.device("cuda", 0))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_sharded(total, single_steps, mesh):
    """Section 7, on ``mesh`` (``one_rank_nccl``): ``sharded_step_gate`` for
    yi-6b at TRAIN_LAYERS' 16 layers (3 steps, timed beside the training
    phase's step; then one step with remat on, the peak memory beside the
    single-device step's), hymba-1.5b at 4 layers (one step with remat
    off and one with it on: the SSD scan, the windowed flash and the fused
    mixers on the sharded path) and mamba2-2.7b at SHARDED_MAMBA2_LAYERS
    (3 steps with remat off, timed beside as many single-device steps, and
    one with it on: the head-parallel mixer, in_proj's columns taken in
    their order, the scan on the rank's heads, out_proj row-parallel).
    Returns the collectives of yi-6b's first sharded step
    (``CollectiveCounter.record``), which phase 9 holds the dry-run to."""
    comm = {}
    sharded_step_gate("yi-6b", TRAIN_LAYERS["yi-6b"], 3, total, mesh,
                      single_steps.get("yi-6b"), comm=comm)
    sharded_step_gate("yi-6b", TRAIN_LAYERS["yi-6b"], 1, total, mesh, remat=True)
    sharded_step_gate("hymba-1.5b", 4, 1, total, mesh)
    sharded_step_gate("hymba-1.5b", 4, 1, total, mesh, remat=True)
    sharded_step_gate("mamba2-2.7b", SHARDED_MAMBA2_LAYERS, 3, total, mesh)
    sharded_step_gate("mamba2-2.7b", SHARDED_MAMBA2_LAYERS, 1, total, mesh, remat=True)
    return comm


# --------------------------------------------------------------------------
# 8. sharded serving and expert parallelism on the (1, 1) mesh
# --------------------------------------------------------------------------

# decode B=4: (cache slots, first timed position) as the serving phase's
# decode spans; mamba2's state does not grow with the context
MESH_DECODE = {"yi-6b": ((40, 1), (2048, 1984)), "mamba2-2.7b": ((40, 1),),
               "hymba-1.5b": ((40, 1), (2048, 1984)),
               "granite-moe-3b-a800m": ((40, 1), (2048, 1984))}
MESH_DECODE_STEPS = 32
# llava-next-34b decodes from embeddings at 4 of its 60 layers: two copies of
# all 60 (67.9 GB each) do not fit one card
MESH_LLAVA_LAYERS = 4


@torch.no_grad()
def _on_mesh(model, mesh):
    """``model``'s weights in an ``LM`` built on ``mesh`` (each rank its
    shards; on the (1, 1) mesh a copy of each weight)."""
    import dataclasses
    from repro_torch.models.lm import LM
    from repro_torch.parallel.comm import local
    from repro_torch.parallel.sharding import MeshPlacements
    sharded = LM(model.arch, dataclasses.replace(model.cfg, mesh=mesh))
    for (name, w), (_, p) in zip(sharded.named_parameters(), model.named_parameters()):
        local(w).copy_(local(MeshPlacements(mesh, tuple(w.placements)).distribute(p)))
    return sharded


def _decode_gated(model, span, first, start, feed=None):
    """MESH_DECODE_STEPS serve steps of ``model`` at ``first``, ... from a
    fresh ``span``-slot cache after one step at ``first - 1``: the greedy
    tokens fed back (or, for an embeds-input arch, ``feed`` [B, steps + 1,
    H]), each step's launches counted (a synchronise after each step).
    Returns (tokens, logits, launches of each step, ms/token on the host
    clock over the steps)."""
    from repro_torch.serving.serve import make_serve_step
    serve = make_serve_step(model)
    cache = model.init_cache(4, span)
    tok = serve(cache, start if feed is None else feed[:, 0], first - 1)[0]
    toks, logits, counts = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, pos in enumerate(range(first, first + MESH_DECODE_STEPS)):
        x = tok if feed is None else feed[:, i + 1]
        (tok, lg, _), n = _counts_since_reset(lambda: serve(cache, x, pos))
        toks.append(tok)
        logits.append(lg)
        counts.append(n)
    ms = (time.perf_counter() - t0) * 1e3 / MESH_DECODE_STEPS
    return torch.stack(toks), torch.stack(logits), counts, ms


def mesh_decode_gate(name, mesh, total, layers=None, spans=((40, 1),)):
    """Full-width ``name`` (cut to ``layers``) in bf16 from the serving
    phase's seed, on one device and on ``mesh``: for each (cache slots,
    first position) of ``spans``, MESH_DECODE_STEPS decode steps of B=4
    each way (``_decode_gated``; one device first, then the mesh, the other
    way round at the next span), the mesh's launches added to ``total``.
    Gates: tokens and fp32 logits equal bit for bit at every step, each
    step's launches equal. Logs the steps' ms/token each way and the peak
    memory of the mesh's decode (both models held)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import RunCfg, init_params
    arch = get_config(name)
    if layers:
        arch = dataclasses.replace(arch, num_layers=layers)
    gen = torch.Generator(device="cuda").manual_seed(0)
    single = init_params(arch, gen, RunCfg(compute_dtype=torch.bfloat16), device="cuda")
    sharded = _on_mesh(single, mesh)
    start = torch.randint(0, arch.vocab, (4,), generator=gen, device="cuda")
    feed = (_prompt(arch, gen, 4, MESH_DECODE_STEPS + 1) if arch.embeds_input else None)
    times = []
    for k, (span, first) in enumerate(spans):
        runs = {}
        for who in (("one device", "mesh") if k % 2 == 0 else ("mesh", "one device")):
            if who == "mesh":
                torch.cuda.reset_peak_memory_stats()
            runs[who] = _decode_gated(sharded if who == "mesh" else single, span, first, start,
                                      feed)
            if who == "mesh":
                peak = torch.cuda.max_memory_allocated() / 2**30
        got, want = runs["mesh"], runs["one device"]
        for counts in got[2]:
            total.add(counts, arch)
        steps = f"{name} decode B=4 at {first + 1}-{first + MESH_DECODE_STEPS} of {span} slots"
        if not torch.equal(got[0], want[0]):
            bad = (got[0] != want[0]).any(dim=1).nonzero()[0, 0].item()
            raise AssertionError(f"{steps}: the mesh's tokens differ from one device's at step "
                                 f"{bad}")
        if not torch.equal(got[1], want[1]):
            bad = (got[1] != want[1]).flatten(1).any(dim=1).nonzero()[0, 0].item()
            raise AssertionError(f"{steps}: the mesh's logits differ from one device's from step "
                                 f"{bad} (max |diff| {(got[1] - want[1]).abs().max().item():.3g})")
        if got[2] != want[2]:
            raise AssertionError(f"{steps}: launches a step, mesh {got[2][0]}, one device "
                                 f"{want[2][0]}")
        log(f"[mesh] {steps}: tokens and logits equal to one device's bit for bit at every "
            f"step; launches a step {got[2][0]} (equal)")
        times.append(f"{first + 1}-{first + MESH_DECODE_STEPS} of {span}: mesh {got[3]:.3f}, "
                     f"one device {want[3]:.3f} ({got[3] / want[3]:.2f}x); mesh decode peak "
                     f"{peak:.2f} GiB")
    log(f"[time] {name} ({arch.num_layers} layers) decode B=4 ms/token on the (1, 1) mesh over "
        f"NCCL and on one device, each step synchronised: {'; '.join(times)}")
    del single, sharded
    gc.collect()
    torch.cuda.empty_cache()


def mesh_parallel_utilities(mesh):
    """``compressed_psum`` over the mesh's "model" group (one rank, NCCL)
    against the one-rank result (its own scales, no sum); ``pipeline_apply``
    with one stage on "model" (G 4 microbatches [4, 4096], stage tanh(x @
    w), the ring's send and receive to itself) and its gradient against
    the stage applied to each microbatch, bit for bit."""
    from repro_torch.parallel.compression import compressed_psum, dequantize_int8, quantize_int8
    from repro_torch.parallel.pipeline import pipeline_apply
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(4096, 1000, generator=gen, device="cuda")
    got = compressed_psum(x, mesh.get_group("model"))
    want = dequantize_int8(*quantize_int8(x), x.shape, x.dtype)
    if not torch.equal(got, want):
        raise AssertionError("compressed_psum over one rank differs from its one-rank result")
    err = ((got - x).norm() / x.norm()).item()
    w = (torch.randn(1, 4096, 4096, generator=gen, device="cuda") / 64).requires_grad_()
    mbs = torch.randn(4, 4, 4096, generator=gen, device="cuda")
    stage = lambda w, x: torch.tanh(x @ w)
    piped = pipeline_apply(stage, w, mbs, mesh, axis="model")
    (piped ** 2).sum().backward()
    w2 = w.detach().clone().requires_grad_()
    seq = torch.stack([stage(w2[0], m) for m in mbs])
    (seq ** 2).sum().backward()
    grad_rel = ((w.grad - w2.grad).norm() / w2.grad.norm()).item()
    if not torch.equal(piped, seq) or grad_rel > 1e-6:
        raise AssertionError(f"pipeline_apply over one stage differs from the stage applied in "
                             f"turn (outputs equal: {torch.equal(piped, seq)}, the gradient "
                             f"{grad_rel:.3g} relative L2)")
    log(f"[mesh] compressed_psum of [4096, 1000] fp32 over NCCL: equal to the one-rank int8 "
        f"round trip (relative L2 {err:.3g} from x); pipeline_apply, 1 stage x 4 microbatches "
        f"[4, 4096]: outputs equal to the stage applied in turn, its gradient "
        f"{'equal' if torch.equal(w.grad, w2.grad) else f'{grad_rel:.3g} relative L2'}")


def phase_mesh_serving(total, mesh):
    """Section 8, on ``mesh`` (``one_rank_nccl``): ``mesh_decode_gate`` for
    MESH_DECODE's models at full depth and llava-next-34b at
    MESH_LLAVA_LAYERS; granite-moe's sharded train step at 4 layers
    (``sharded_step_gate``: the expert-parallel layer forward and backward,
    bit for bit); then ``mesh_parallel_utilities``."""
    for name, spans in MESH_DECODE.items():
        mesh_decode_gate(name, mesh, total, spans=spans)
    mesh_decode_gate("llava-next-34b", mesh, total, layers=MESH_LLAVA_LAYERS)
    sharded_step_gate("granite-moe-3b-a800m", 4, 1, total, mesh)
    mesh_parallel_utilities(mesh)


# --------------------------------------------------------------------------
# 9. the dry-run held to the card
# --------------------------------------------------------------------------

DRYRUN_MEMORY_TOL = 0.05        # the dry-run's peak within 5% of the card's
DRYRUN_PHASE_S = 60.0
DRYRUN_DECODE = (2048, 1984, 4)  # decode: cache slots, first position, steps
DRYRUN_CLI = ["--arch", "yi-6b", "--shape", "train_4k", "--mesh", "single"]


def _no_card_env():
    """The environment of a child that must not touch the card: none visible."""
    import os
    return {**os.environ, "CUDA_VISIBLE_DEVICES": "",
            "PYTHONPATH": str(ROOT / "src")}


def _dryrun_train_args(device):
    """yi-6b at TRAIN_LAYERS' 16 layers, the training phase's config (remat
    off, G = 2 x 1 x 2048): a fresh train state and the training phase's
    fixed batch on ``device`` (as tensors, so the step copies nothing in)."""
    from repro_torch.train.step import init_train_state
    arch, cfg = _train_arch("yi-6b"), _train_cfg()
    gen = (torch.Generator(device="cuda") if device == "cuda" else torch.Generator()).manual_seed(0)
    state = init_train_state(arch, cfg, gen, device)
    host = _train_data(arch).batch_at(0)
    if device == "cuda":
        batch = {k: torch.as_tensor(v, device="cuda") for k, v in host.items()}
    else:
        batch = {k: torch.empty(v.shape, dtype=torch.from_numpy(v[:0]).dtype, device=device)
                 for k, v in host.items()}
    return state, batch


def _dryrun_train_step(args):
    from repro_torch.train.step import make_train_step
    state, batch = args
    return make_train_step(_train_arch("yi-6b"), _train_cfg())(state, batch)


def _dryrun_serving_args(device, name="yi-6b", layers=None):
    """Full-width ``name`` (bf16; all its layers, or ``layers``): the model, a
    prefill batch B=2 S=2000, a DRYRUN_DECODE cache for B=4 and its first
    tokens, on ``device``."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import RunCfg, init_params
    arch = get_config(name)
    arch = dataclasses.replace(arch, num_layers=layers or arch.num_layers)
    gen = (torch.Generator(device="cuda") if device == "cuda" else torch.Generator()).manual_seed(0)
    model = init_params(arch, gen, RunCfg(compute_dtype=torch.bfloat16), device)
    tokens = torch.zeros(2, 2000, dtype=torch.int32, device=device)
    cache = model.init_cache(4, DRYRUN_DECODE[0])
    return model, tokens, cache, torch.zeros(4, dtype=torch.int32, device=device)


def _dryrun_serving_step(args):
    """Prefill, then DRYRUN_DECODE's greedy serve steps."""
    from repro_torch.serving.serve import make_prefill_step, make_serve_step
    model, tokens, cache, tok = args
    logits = make_prefill_step(model)({"tokens": tokens})
    serve = make_serve_step(model)
    _, first, steps = DRYRUN_DECODE
    for pos in range(first, first + steps):
        tok, _, _ = serve(cache, tok, pos)
    return logits, tok


def _card_peak(build_args, step):
    """``step(build_args())`` on the card: (the arguments, the bytes
    allocated when the step starts and the peak over it, each above what
    the process held before ``build_args``). The dry-run's ``measure`` on
    the card."""
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    args = build_args()
    torch.cuda.synchronize()
    gc.collect()
    start = torch.cuda.memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    out = step(args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return args, start, peak


def _memory_gate(name, dry, start, peak):
    err = abs(dry["peak_bytes"] - peak) / peak
    log(f"[dryrun] {name}: peak {peak} B ({peak / 2**30:.3f} GiB) on the card, "
        f"{dry['peak_bytes']} B ({dry['peak_bytes'] / 2**30:.3f} GiB) dry-run, "
        f"{100 * err:.2f}% apart; live at the step's start {start} B on the card, "
        f"{dry['live_bytes_at_start']} B dry-run")
    if err > DRYRUN_MEMORY_TOL:
        raise AssertionError(f"dry-run peak of {name} {100 * err:.2f}% from the card's "
                             f"max_memory_allocated (limit {100 * DRYRUN_MEMORY_TOL:.0f}%)")
    return err


def dryrun_child(nemotron_layers) -> int:
    """Run in a child with no card visible (``phase_dryrun``): the dry-runs
    of phase 9's single-device train step and servings (yi-6b; nemotron-4-340b
    at ``nemotron_layers``) (``dryrun.measure`` on meta tensors), then of
    phase 7's sharded yi-6b step (16 layers, remat off) on a fake (1, 1)
    mesh; prints their numbers as one JSON line."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh
    if torch.cuda.is_available():
        raise RuntimeError("the dry-run child sees a card")
    out = {}
    nemotron_args = lambda device: _dryrun_serving_args(device, "nemotron-4-340b",
                                                        nemotron_layers)
    for name, build_args, step in (("train", _dryrun_train_args, _dryrun_train_step),
                                   ("serving", _dryrun_serving_args, _dryrun_serving_step),
                                   ("nemotron", nemotron_args, _dryrun_serving_step)):
        m = dryrun.measure(lambda: build_args("meta"), step)
        out[name] = {k: m[k] for k in ("peak_bytes", "live_bytes_at_start", "flops")}
    dryrun.fake_world(1)
    mesh = make_mesh((1, 1), ("data", "model"), "meta")
    arch, cfg = _train_arch("yi-6b"), _train_cfg()
    host = _train_data(arch).batch_at(0)
    rec = dryrun.dry_train(arch, cfg, lambda: {k: torch.empty(v.shape, dtype=torch.int32,
                                                              device="meta")
                                               for k, v in host.items()}, mesh)
    out["sharded"] = rec["collectives"]
    print(json.dumps(out))
    return 0


def phase_dryrun(card_comm):
    """Section 9: the dry-run (``repro_torch.launch.dryrun``) held to the
    card. Two children with no card visible run beside the card's work:
    the CLI on one cell, and ``dryrun_child``. (a) The CLI's record has
    ``ok``, the peak, the argument bytes, flops, collectives and ``fits``.
    (b) yi-6b's 16-layer train step (the training phase's config) and its
    serving (prefill B=2 S=2000, 4 decode steps B=4 at 1984-1987 of a
    2,048-slot cache), and nemotron-4-340b's serving the same way at the
    depth the card holds (``_layers_that_fit``), each run on the card: the
    dry-run's peak within DRYRUN_MEMORY_TOL of ``max_memory_allocated``,
    the train step's flops
    under ``FlopCounterMode`` on the card equal to the dry-run's. (c) The
    collectives of phase 7's first sharded yi-6b step (``card_comm``)
    equal, kind by kind, to the dry-run's on a fake (1, 1) mesh. (d)
    ``kernels.build``'s target constants equal to the card's properties."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.lm import RunCfg
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    nemotron = _layers_that_fit(get_config("nemotron-4-340b"), RunCfg(compute_dtype=torch.bfloat16))
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    cli = subprocess.Popen([sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
                            *DRYRUN_CLI, "--out", out_dir], cwd=ROOT, env=_no_card_env(),
                           stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    child = subprocess.Popen([sys.executable, "-W", "ignore", "-c",
                              "import sys, chip_smoke; "
                              f"sys.exit(chip_smoke.dryrun_child({nemotron}))"],
                             cwd=ROOT, env=_no_card_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    mark = lambda what: log(f"[dryrun] {what} at {time.perf_counter() - t0:.1f} s")
    try:
        props = torch.cuda.get_device_properties(0)
        got = (props.name, props.multi_processor_count, props.total_memory)
        want = (build.TARGET_NAME, build.TARGET_SMS, build.TARGET_MEMORY)
        log(f"[dryrun] (d) the card: {got}; kernels.build's target: {want}")
        if got != want:
            raise AssertionError(f"the card's (name, SMs, memory) {got} are not the target's "
                                 f"{want}")

        # (b) on the card: training (memory, then flops on a second step), serving
        card = {}
        args, start, peak = _card_peak(lambda: _dryrun_train_args("cuda"), _dryrun_train_step)
        with FlopCounterMode(display=False) as fc:
            _dryrun_train_step(args)
        card["train"] = (start, peak, fc.get_total_flops())
        del args
        gc.collect()
        torch.cuda.empty_cache()
        args, start, peak = _card_peak(lambda: _dryrun_serving_args("cuda"), _dryrun_serving_step)
        card["serving"] = (start, peak, None)
        del args
        gc.collect()
        torch.cuda.empty_cache()
        args, start, peak = _card_peak(
            lambda: _dryrun_serving_args("cuda", "nemotron-4-340b", nemotron), _dryrun_serving_step)
        card["nemotron"] = (start, peak, None)
        del args
        gc.collect()
        torch.cuda.empty_cache()
        mark("the card's steps done")

        stdout, stderr = child.communicate(timeout=2 * DRYRUN_PHASE_S)
        if child.returncode != 0:
            raise AssertionError(f"the dry-run child failed:\n{stderr[-4000:]}")
        dry = json.loads(stdout.strip().splitlines()[-1])
        mark("the dry-run child done")
        errs = {}
        for name, what in (("train", "yi-6b 16 layers, train step G=2 x 1 x 2048, remat off"),
                           ("serving", "yi-6b 32 layers, prefill B=2 S=2000 and decode B=4"),
                           ("nemotron", f"nemotron-4-340b {nemotron} layers, prefill B=2 S=2000 "
                                        f"and decode B=4")):
            start, peak, flops = card[name]
            errs[name] = _memory_gate(what, dry[name], start, peak)
        log(f"[dryrun] (b) yi-6b train step flops: {card['train'][2]} under FlopCounterMode on "
            f"the card, {dry['train']['flops']} dry-run")
        if card["train"][2] != dry["train"]["flops"]:
            raise AssertionError(f"train step flops {card['train'][2]} on the card, "
                                 f"{dry['train']['flops']} dry-run")
        log(f"[dryrun] (c) yi-6b sharded step on the (1, 1) mesh: collectives on the card "
            f"{card_comm}; dry-run {dry['sharded']}")
        if dry["sharded"] != card_comm:
            raise AssertionError(f"collectives differ: card {card_comm}, dry-run "
                                 f"{dry['sharded']}")

        # (a) the CLI
        text = cli.communicate(timeout=2 * DRYRUN_PHASE_S)[0]
        mark("the CLI done")
        path = Path(out_dir) / "yi-6b__train_4k__single.json"
        if cli.returncode != 0 or not path.is_file():
            raise AssertionError(f"dryrun CLI exited {cli.returncode}:\n{text[-4000:]}")
        rec = json.loads(path.read_text())
        need = ("ok", "memory", "flops", "collectives", "fits", "target")
        if not rec.get("ok") or any(k not in rec for k in need):
            raise AssertionError(f"dryrun CLI record lacks {need}: {sorted(rec)}")
        log(f"[dryrun] (a) python -m repro_torch.launch.dryrun {' '.join(DRYRUN_CLI)} (no card "
            f"visible): ok, peak {rec['memory']['peak_bytes']} B, arguments "
            f"{rec['memory']['argument_bytes']}, flops {rec['flops']}, collectives "
            f"{rec['collectives']}, fits {rec['fits']}, {rec['wall_s']} s")
    finally:
        for proc in (cli, child):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    log(f"[dryrun] the phase: {seconds:.1f} s; peaks {100 * errs['train']:.2f}% (train), "
        f"{100 * errs['serving']:.2f}% (serving) and {100 * errs['nemotron']:.2f}% (nemotron "
        f"serving) from the card's")
    if seconds > DRYRUN_PHASE_S:
        raise AssertionError(f"the dry-run phase took {seconds:.1f} s (limit {DRYRUN_PHASE_S} s)")


# --------------------------------------------------------------------------
# 10. the PALM simulator's core on the card
# --------------------------------------------------------------------------

# The co-design sweep of the batched tier: the 16x16 tiled mesh of
# benchmarks/bench_sim_scaling.py:68-77 (tiles of 4x4 cores, 1024 GB/s
# inside a tile, 256 GB/s across, 20 ns links; 16 TFLOP/s and 3.75 MB a
# core; DRAM 256 GB/s on 16 channels, 300 ns, a port every 4th row), its
# hardware grid 32 tile rates x 8 DRAM rates, and its two fast-eligible
# plans (_gate_plan, :88-93) on full-width yi-6b at sequence 4096: 512 jobs
PALM_MESH = 16
PALM_FLOPS = tuple(2e12 + i * 0.25e12 for i in range(32))
PALM_DRAM_GBS = (16, 32, 48, 64, 96, 128, 192, 256)
PALM_PLANS = ((4, 1, 4), (2, 1, 8))         # (pp, dp, tp)
PALM_SEQ = 4096
PALM_PHASE_S = 30.0
CHAIN_G = (1, 31, 256, 4096)               # chain_replay's parity widths
PEAK_FP64_S = 34e12                         # H100 SXM fp64 outside the tensor cores


def palm_sims():
    """The sweep's 512 simulators (timelines on), plan-major, each plan's
    hardware grid tile rate major. One compiled topology serves every
    hardware variant (the grid changes rates, not the mesh)."""
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.core.workload import arch_to_graph
    spec = core.MeshSpec(rows=PALM_MESH, cols=PALM_MESH, intra_bw=1024e9, inter_bw=256e9,
                         link_latency=2e-8, tile_shape=(4, 4))
    topo = spec.compile()
    ports = tuple(topo.device(r, 0) for r in range(0, PALM_MESH, 4))
    arch = get_config("yi-6b")
    sims = []
    for pp, dp, tp in PALM_PLANS:
        plan = core.ParallelPlan(pp=pp, dp=dp, tp=tp, microbatch=2, global_batch=8 * dp,
                                 schedule=core.Schedule.ONE_F_ONE_B, recompute="never")
        graph = arch_to_graph(arch, PALM_SEQ, plan.microbatch * plan.dp, training=True)
        for flops in PALM_FLOPS:
            for gbs in PALM_DRAM_GBS:
                hw = core.HardwareSpec(
                    name=f"mesh16-f{flops:g}-d{gbs}", topology=topo,
                    tile=core.TileSpec(flops=flops, sram_bytes=3.75e6),
                    dram=core.DRAMSpec(bandwidth=gbs * 1e9, response_time=3e-7,
                                       channels=PALM_MESH),
                    dram_ports=ports)
                sims.append(core.PipelineSimulator(core.map_graph(graph, hw, plan),
                                                   collect_timeline=True))
    return sims


def _result_key(r):
    """Every SimResult field the batched tier fills, and the raw trace."""
    import dataclasses
    return (r.total_time, r.throughput, r.bubble_ratio, r.noc_bytes, r.dram_bytes,
            r.event_count, r.recompute, r.engine,
            [dataclasses.asdict(m) for m in r.stage_memory], r.trace.to_bytes())


def _random_chain(shape, values, depth, spine=0):
    """A chain of random structure (``shape``) and leaves (``values``):
    dt, hold (0-2 lane keys), byte counters and par/spawn nesting at most
    ``depth`` deep, ``spine`` levels of it forced at the front."""
    chain = []
    if spine:
        inner = tuple(_random_chain(shape, values, depth - 1, spine - 1))
        chain.append(("par", (inner,)) if shape.random() < 0.5 else ("spawn", inner))
    for _ in range(int(shape.integers(0, 5))):
        r = shape.random()
        if r < 0.3:
            chain.append(("dt", next(values)))
        elif r < 0.55:
            keys = tuple(int(k) for k in shape.integers(0, 1 << 40, int(shape.integers(0, 3))))
            chain.append(("hold", keys, next(values)))
        elif r < 0.75:
            chain.append(("bytes", ("noc", "dram", "fabric")[shape.integers(3)], next(values)))
        elif depth > 0 and r < 0.9:
            chain.append(("par", tuple(tuple(_random_chain(shape, values, depth - 1))
                                       for _ in range(int(shape.integers(0, 3))))))
        elif depth > 0:
            chain.append(("spawn", tuple(_random_chain(shape, values, depth - 1))))
    return chain


def chain_replay_parity():
    """``chain_replay`` against ``chain_replay_ref`` (on the same CUDA
    tensors) on random programs nesting par/spawn to the kernel's depth
    limit, at each width of CHAIN_G; every call twice for the same bits.
    Raises on any difference."""
    import itertools
    import numpy as np
    from repro_torch.core.fastbatch import compile_chain
    from repro_torch.kernels.chain_replay import MAX_DEPTH, chain_replay
    from repro_torch.kernels.ref import chain_replay_ref
    for G in CHAIN_G:
        for depth in (2, 8, MAX_DEPTH):
            # the structure from a seed; the leaves are V's, drawn below
            chain = _random_chain(np.random.default_rng(depth), itertools.repeat(1.0), depth,
                                  spine=depth)
            code, prog, leaves = compile_chain(chain)
            if prog.depth != depth:
                raise AssertionError(f"random program nests {prog.depth} deep, wanted {depth}")
            gen = np.random.default_rng(G * 100 + depth)
            # magnitudes far apart, so an add's order shows in its bits
            scale = gen.choice([1.0, 1e-3, 1e8, 3e15], size=(len(leaves), G))
            V = torch.tensor(scale * gen.random((len(leaves), G)), device="cuda")
            t = torch.tensor(gen.random(G) * 1e3, device="cuda")
            accs = torch.tensor(gen.random((3, G)), device="cuda")
            code_d = torch.from_numpy(code).cuda()
            kw = dict(entry=prog.entry, holds=len(prog.keys), spawns=prog.spawns,
                      depth=prog.depth)
            runs = []
            for _ in range(2):
                a = accs.clone()
                runs.append((*chain_replay(code_d, V, t, a, **kw), a))
            a = accs.clone()
            want = (*chain_replay_ref(code_d, V, t, a, prog.entry, len(prog.keys),
                                      prog.spawns, prog.depth), a)
            torch.cuda.synchronize()
            for got, ref, again in zip(runs[0], want, runs[1]):
                if not torch.equal(got, again):
                    raise AssertionError(f"chain_replay G={G} depth {depth}: two calls differ")
                same = (got == ref) | (torch.isnan(got) & torch.isnan(ref))
                if not bool(same.all()):
                    bad = (got - ref).abs().max().item()
                    raise AssertionError(f"chain_replay G={G} depth {depth} differs from its "
                                         f"plain version: {bad}")
            log(f"[palm] chain_replay G={G} depth {depth}: {len(code)} words, "
                f"{len(leaves)} leaves, {len(prog.keys)} holds, {prog.spawns} spawns: "
                f"equal to chain_replay_ref bit for bit, twice")


def _program_rows(code, entry):
    """(leaf rows a program reads, its words) from ``code[entry:]``."""
    from repro_torch.kernels.chain_replay import CHAIN_OPS
    pc, rows = entry, 0
    while code[pc] != CHAIN_OPS["end"]:
        if code[pc] == CHAIN_OPS["seg"]:
            k, h, n0, n1, n2 = (int(x) for x in code[pc + 1:pc + 6])
            rows += k + n0 + n1 + n2
            pc += 6 + k + h + n0 + n1 + n2
        else:
            pc += 1
    return rows, pc + 1 - entry


def chain_replay_row(sims):
    """Time the first group's launches as the main path makes them (replayed
    from a recording), per launch, beside their byte bound, and the plain
    version on the same CUDA tensors."""
    from repro_torch.core import fastbatch
    from repro_torch.kernels.chain_replay import chain_replay
    from repro_torch.kernels.ref import chain_replay_ref
    calls = []

    def record(code, V, t, accs, **kw):
        calls.append((code, V, t, kw))
        return chain_replay(code, V, t, accs, **kw)
    fastbatch.chain_replay = record
    try:
        fastbatch.run_fast_batch(sims[:len(sims) // len(PALM_PLANS)], device="cuda")
    finally:
        fastbatch.chain_replay = chain_replay
    torch.cuda.synchronize()
    code_host = calls[0][0].cpu().numpy()
    G = calls[0][1].shape[1]
    nbytes = flops = 0
    for code, V, t, kw in calls:
        rows, words = _program_rows(code_host, kw["entry"])
        # leaf rows, t in and out, the counters in and out, holds, spawns
        nbytes += 8 * G * (rows + 2 + 6 + 2 * kw["holds"] + kw["spawns"]) + 4 * words
        flops += rows * G
    scratch = calls[0][1].new_zeros((3, G))

    def kernel():
        for code, V, t, kw in calls:
            chain_replay(code, V, t, scratch, **kw)

    def plain():
        for code, V, t, kw in calls:
            chain_replay_ref(code, V, t, scratch, kw["entry"], kw["holds"], kw["spawns"],
                             kw["depth"])
    n = len(calls)
    ms = time_device(kernel, n=5, reps=3) / n
    plain_ms = time_device(plain, n=1, reps=3) / n
    t_bytes = nbytes / n / PEAK_BYTES_S * 1e3
    t_ops = flops / n / PEAK_FP64_S * 1e3
    bound, by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return {"name": "chain_replay", "dtype": torch.float64,
            "shape": f"G={G}, {n} launches (yi-6b pp4 tp4 group)", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
            "bytes_per_launch": nbytes / n}


def phase_palm_core(total):
    """Section 10: the batched co-design tier (``repro_torch.core.
    run_fast_batch``) on the sweep above. Gates: ``chain_replay`` equal to
    its plain version on random programs (``chain_replay_parity``); the
    sweep in 2 signature groups, all 512 jobs batched, none ineligible,
    contended or stalled; every job bit-equal between ``device="cuda"`` and
    ``device="cpu"`` (every field and the raw trace); each plan's 4 grid
    corners equal to the scalar fast tier (raw trace) and the event tier
    (canonical trace). ``chain_replay``'s main-path launches are those of
    the card's run alone. Returns (the kernel row, its error)."""
    from repro_torch import kernels
    from repro_torch.core import PipelineSimulator, compile_stage_chains, replay_chains
    from repro_torch.core import run_fast_batch
    t0 = time.perf_counter()
    chain_replay_parity()
    err = 0.0               # bit for bit, or the parity raised
    sims = palm_sims()
    log(f"[palm] sweep: yi-6b full width seq {PALM_SEQ}, plans (pp, dp, tp) {PALM_PLANS}, "
        f"{len(PALM_FLOPS)} tile rates x {len(PALM_DRAM_GBS)} DRAM rates: {len(sims)} jobs, "
        f"built in {time.perf_counter() - t0:.2f} s")

    prof = {}
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    on_card = run_fast_batch(sims, device="cuda", profile=prof)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    counts = kernels.launch_counts()
    launches = counts["chain_replay"]
    if counts != _launches(chain_replay=launches) or launches == 0:
        raise AssertionError(f"the batched sweep launched {counts}")
    total["chain_replay"] = total.get("chain_replay", 0) + launches

    prof_cpu = {}
    t1 = time.perf_counter()
    on_cpu = run_fast_batch(sims, device="cpu", profile=prof_cpu)
    cpu_s = time.perf_counter() - t1
    # the same call again on the card, warm (the first one pays the lazy
    # CUDA set-up of every torch op it meets); its results must not change
    prof_warm = {}
    t1 = time.perf_counter()
    again = run_fast_batch(sims, device="cuda", profile=prof_warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t1
    if any(_result_key(a) != _result_key(b) for (a, _), (b, _) in zip(on_card, again)):
        raise AssertionError("run_fast_batch on the card: a second call differs")

    want = {"jobs": len(sims), "groups": 2, "batched_jobs": len(sims)}
    for p, where in ((prof, "cuda"), (prof_cpu, "cpu")):
        got = {k: p.get(k, 0) for k in ("jobs", "groups", "batched_jobs", "ineligible_jobs",
                                        "contended_jobs", "scalar_jobs")}
        if got != {**want, "ineligible_jobs": 0, "contended_jobs": 0, "scalar_jobs": 0}:
            raise AssertionError(f"run_fast_batch({where}) profile {got}")
    for i, ((a, why_a), (b, why_b)) in enumerate(zip(on_card, on_cpu)):
        if a is None or b is None:
            raise AssertionError(f"job {i}: no batched result ({why_a!r} on the card, "
                                 f"{why_b!r} on the CPU)")
        if _result_key(a) != _result_key(b):
            raise AssertionError(f"job {i} ({sims[i].hw.name}, pp{sims[i].plan.pp} "
                                 f"tp{sims[i].plan.tp}): card and CPU results differ")
    log(f"[palm] run_fast_batch: {len(sims)} jobs bit-equal card against CPU (every field, "
        f"raw traces); {prof['groups']} groups, {prof['batched_jobs']} batched, none "
        f"ineligible, contended or stalled")

    grid = len(PALM_FLOPS) * len(PALM_DRAM_GBS)
    corners = [p * grid + i * len(PALM_DRAM_GBS) + j for p in range(len(PALM_PLANS))
               for i in (0, len(PALM_FLOPS) - 1) for j in (0, len(PALM_DRAM_GBS) - 1)]
    for i in corners:
        sim = sims[i]
        scalar, why = replay_chains(sim, compile_stage_chains(sim))
        event = PipelineSimulator(sim.mapped, collect_timeline=True, engine="event").run()
        res = on_card[i][0]
        if scalar is None or _result_key(scalar) != _result_key(res):
            raise AssertionError(f"corner {sim.hw.name}: scalar fast tier {why!r} or differs")
        if ((event.total_time, event.throughput, event.noc_bytes, event.dram_bytes)
                != (res.total_time, res.throughput, res.noc_bytes, res.dram_bytes)
                or event.trace.canonical() != res.trace.canonical()):
            raise AssertionError(f"corner {sim.hw.name}: event tier differs")
        log(f"[palm] corner {sim.hw.name} pp{sim.plan.pp} tp{sim.plan.tp}: "
            f"{res.total_time!r} s, {res.throughput!r} samples/s, equal to the scalar fast "
            f"tier and the event tier")

    us = lambda p, k: p.get(k, 0) / 1e6
    for what, p, whole in (("card, first call", prof, card_s), ("card, warm", prof_warm, warm_s),
                           ("plain CPU path on this host", prof_cpu, cpu_s)):
        log(f"[palm] {what}: host compile (classify, chains, signatures) "
            f"{us(p, 'compile_us'):.4f} s, group replay {us(p, 'eval_us'):.4f} s, interval "
            f"validation {us(p, 'validate_us'):.4f} s, whole call {whole:.4f} s")
    log(f"[palm] chain_replay: {launches} launches in {prof['groups']} groups")
    row = chain_replay_row(sims)
    _log_row(row)
    log(f"[palm] chain_replay bytes a launch {row['bytes_per_launch']:.0f} (bound at "
        f"{PEAK_BYTES_S / 1e12:.2f} TB/s)")
    seconds = time.perf_counter() - t0
    log(f"[palm] the phase: {seconds:.1f} s")
    if seconds > PALM_PHASE_S:
        raise AssertionError(f"the PALM core phase took {seconds:.1f} s "
                             f"(limit {PALM_PHASE_S} s)")
    return row, err


# --------------------------------------------------------------------------
# 11. the scale-out fabric on the card
# --------------------------------------------------------------------------

# The fabric co-design sweep: tiled_cluster (4 chips of 4x4 tiles, 16
# TFLOP/s a tile, on cluster_2x2: 2 boards of 2 chips, 100 GB/s board and
# 25 GB/s node links), its board and node link rates and its tile rate
# crossed, and two plans over all 64 tiles on full-width yi-6b at sequence
# 4096 (microbatch 2, global batch 8 dp, 1F1B, no recompute). In the
# ANALYTICAL NoC mode every job batches; in the default MACRO mode the
# fabric's holds contend in every job, so they all fall back
FABRIC_BOARD_GBS = (25, 50, 100, 200)
FABRIC_NODE_GBS = (6.25, 12.5, 25, 50)
FABRIC_TILE_TFLOPS = (8, 16, 32, 64)
FABRIC_PLANS = ((4, 4, 4), (2, 4, 8))       # (pp, dp, tp)
FABRIC_MACRO = ((25, 100), (6.25, 50), (8, 64))     # board, node, tile
# simulated bytes a level carries in the first MACRO job: the same on any host
FABRIC_PAYLOAD = {"board": 3221225472.0, "node": 1073741824.0}
FABRIC_PHASE_S = 30.0


def fabric_sims(mode, plans=FABRIC_PLANS, boards=FABRIC_BOARD_GBS, nodes=FABRIC_NODE_GBS,
                tiles=FABRIC_TILE_TFLOPS, metrics=False):
    """The sweep's simulators (timelines on), plan-major, then board, node
    and tile rate. The variants share tiled_cluster's compiled topology."""
    import dataclasses
    from repro_torch import core
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import tiled_cluster
    from repro_torch.core.workload import arch_to_graph
    base = tiled_cluster()
    arch = get_config("yi-6b")
    sims = []
    for pp, dp, tp in plans:
        plan = core.ParallelPlan(pp=pp, dp=dp, tp=tp, microbatch=2, global_batch=8 * dp,
                                 schedule=core.Schedule.ONE_F_ONE_B, recompute="never")
        graph = arch_to_graph(arch, PALM_SEQ, plan.microbatch * plan.dp, training=True)
        for board in boards:
            for node in nodes:
                for tile in tiles:
                    fabric = base.fabric.with_level(0, bandwidth=board * 1e9).with_level(
                        1, bandwidth=node * 1e9)
                    hw = base.with_(name=f"tiled_cluster-b{board:g}-n{node:g}-t{tile:g}",
                                    tile=dataclasses.replace(base.tile, flops=tile * 1e12),
                                    fabric=fabric)
                    sims.append(core.PipelineSimulator(
                        core.map_graph(graph, hw, plan), noc_mode=core.NoCMode(mode),
                        collect_timeline=True, metrics=metrics))
    return sims


def _fabric_bytes_on_card(sims):
    """Run the batch on the card once more, keeping each group's byte
    counters; the sum of their fabric row (``chain_replay``'s third
    accumulator) over every job, and the results."""
    from repro_torch.core import fastbatch
    from repro_torch.kernels.chain_replay import chain_replay
    accs = {}

    def keep(code, V, t, acc, **kw):
        accs[id(acc)] = acc
        return chain_replay(code, V, t, acc, **kw)
    fastbatch.chain_replay = keep
    try:
        prof = {}
        t1 = time.perf_counter()
        out = fastbatch.run_fast_batch(sims, device="cuda", profile=prof)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t1
    finally:
        fastbatch.chain_replay = chain_replay
    return sum(float(a[2].sum()) for a in accs.values()), out, prof, seconds


def phase_fabric(total):
    """Section 11: the fabric co-design sweep through the batched tier.
    Gates: the ANALYTICAL sweep in 2 signature groups, all 128 jobs
    batched, none ineligible, contended or scalar; every job bit-equal
    between ``device="cuda"`` and ``device="cpu"`` (every field and the raw
    trace), and between the card's first and warm calls; each plan's 4 grid
    corners (each rate at both ends) equal to the scalar fast tier (raw
    trace) and the event tier (canonical trace), with equal ``run_metrics``
    sim documents; the 8 MACRO jobs contended on the card and on the CPU,
    with the same reasons; the first of them with ``metrics=True`` through
    ``PipelineSimulator.run()`` (the simulator's default engine, the event
    tier): FABRIC lanes in its trace and FABRIC_PAYLOAD by level. ``chain_replay``'s
    main-path launches are those of the card's first ANALYTICAL and MACRO
    calls."""
    from repro_torch import kernels
    from repro_torch.core import (NoCMode, PipelineSimulator, compile_stage_chains,
                                  replay_chains, run_fast_batch)
    from repro_torch.core.trace import KIND_FABRIC
    from repro_torch.obs import run_metrics
    t0 = time.perf_counter()
    sims = fabric_sims("analytical")
    log(f"[fabric] sweep: yi-6b full width seq {PALM_SEQ} on tiled_cluster, plans (pp, dp, tp) "
        f"{FABRIC_PLANS}, board {FABRIC_BOARD_GBS} GB/s x node {FABRIC_NODE_GBS} GB/s x tile "
        f"{FABRIC_TILE_TFLOPS} TFLOP/s, ANALYTICAL: {len(sims)} jobs, built in "
        f"{time.perf_counter() - t0:.2f} s")

    prof = {}
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    on_card = run_fast_batch(sims, device="cuda", profile=prof)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t1
    counts = kernels.launch_counts()
    launches = counts["chain_replay"]
    if counts != _launches(chain_replay=launches) or launches == 0:
        raise AssertionError(f"the fabric sweep launched {counts}")

    prof_cpu = {}
    t1 = time.perf_counter()
    on_cpu = run_fast_batch(sims, device="cpu", profile=prof_cpu)
    cpu_s = time.perf_counter() - t1
    fabric_bytes, again, prof_warm, warm_s = _fabric_bytes_on_card(sims)
    if any(_result_key(a) != _result_key(b) for (a, _), (b, _) in zip(on_card, again)):
        raise AssertionError("the fabric sweep on the card: a second call differs")
    if not fabric_bytes > 0:
        raise AssertionError(f"the fabric sweep's fabric-bytes accumulator reads {fabric_bytes}")

    want = {"jobs": len(sims), "groups": 2, "batched_jobs": len(sims), "ineligible_jobs": 0,
            "contended_jobs": 0, "scalar_jobs": 0}
    for p, where in ((prof, "cuda"), (prof_cpu, "cpu"), (prof_warm, "cuda, warm")):
        got = {k: p.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"fabric run_fast_batch({where}) profile {got}")
    for i, ((a, why_a), (b, why_b)) in enumerate(zip(on_card, on_cpu)):
        if a is None or b is None:
            raise AssertionError(f"fabric job {i}: no batched result ({why_a!r} on the card, "
                                 f"{why_b!r} on the CPU)")
        if _result_key(a) != _result_key(b):
            raise AssertionError(f"fabric job {i} ({sims[i].hw.name}, pp{sims[i].plan.pp} "
                                 f"tp{sims[i].plan.tp}): card and CPU results differ")
    times = {r.total_time for r, _ in on_card}
    log(f"[fabric] run_fast_batch: {len(sims)} jobs bit-equal card against CPU (every field, "
        f"raw traces) and card against card; {prof['groups']} groups, "
        f"{prof['batched_jobs']} batched, none ineligible, contended or scalar; "
        f"{len(times)} distinct total times; fabric bytes (chain_replay's third accumulator) "
        f"summed over the sweep on the card: {fabric_bytes!r}")

    grid = (len(FABRIC_BOARD_GBS), len(FABRIC_NODE_GBS), len(FABRIC_TILE_TFLOPS))
    ends = [(0, 0, 0), (0, 1, 1), (1, 0, 1), (1, 1, 0)]
    for p in range(len(FABRIC_PLANS)):
        for e in ends:
            b, n, t = ((g - 1) * x for g, x in zip(grid, e))
            i = ((p * grid[0] + b) * grid[1] + n) * grid[2] + t
            sim = sims[i]
            res = on_card[i][0]
            scalar, why = replay_chains(sim, compile_stage_chains(sim))
            if scalar is None or _result_key(scalar) != _result_key(res):
                raise AssertionError(f"corner {sim.hw.name}: scalar fast tier {why!r} or differs")
            ev_sim = PipelineSimulator(sim.mapped, noc_mode=NoCMode.ANALYTICAL,
                                       collect_timeline=True, engine="event")
            event = ev_sim.run()
            if ((event.total_time, event.throughput, event.noc_bytes, event.dram_bytes)
                    != (res.total_time, res.throughput, res.noc_bytes, res.dram_bytes)
                    or event.trace.canonical() != res.trace.canonical()):
                raise AssertionError(f"corner {sim.hw.name}: event tier differs")
            docs = [json.dumps(run_metrics(s, r)["sim"], sort_keys=True)
                    for s, r in ((sim, res), (ev_sim, event))]
            if docs[0] != docs[1]:
                raise AssertionError(f"corner {sim.hw.name}: metrics documents differ")
            log(f"[fabric] corner {sim.hw.name} pp{sim.plan.pp} dp{sim.plan.dp} "
                f"tp{sim.plan.tp}: {res.total_time!r} s, {res.throughput!r} samples/s, "
                f"noc+fabric bytes {res.noc_bytes!r}; equal to the scalar fast tier and the "
                f"event tier, metrics documents equal")

    macro = fabric_sims("macro", FABRIC_PLANS[:1], *FABRIC_MACRO)
    prof_m = {}
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    m_card = run_fast_batch(macro, device="cuda", profile=prof_m)
    torch.cuda.synchronize()
    m_card_s = time.perf_counter() - t1
    counts = kernels.launch_counts()
    m_launches = counts["chain_replay"]
    if counts != _launches(chain_replay=m_launches):
        raise AssertionError(f"the MACRO fabric jobs launched {counts}")
    prof_mc = {}
    m_cpu = run_fast_batch(macro, device="cpu", profile=prof_mc)
    reasons = [(why_a, why_b) for (_, why_a), (_, why_b) in zip(m_card, m_cpu)]
    contended = "resource contention detected by interval validation"
    if (any(r is not None for r, _ in m_card) or any(a != b or a != contended for a, b in reasons)
            or prof_m.get("contended_jobs") != len(macro)
            or prof_mc.get("contended_jobs") != len(macro)):
        raise AssertionError(f"MACRO fabric jobs: reasons {reasons}, contended "
                             f"{prof_m.get('contended_jobs')} on the card, "
                             f"{prof_mc.get('contended_jobs')} on the CPU")
    total["chain_replay"] = total.get("chain_replay", 0) + launches + m_launches
    log(f"[fabric] MACRO: {len(macro)} jobs (pp4 dp4 tp4, board {FABRIC_MACRO[0]} x node "
        f"{FABRIC_MACRO[1]} x tile {FABRIC_MACRO[2]}) rejected for contention by the card's "
        f"interval validation, as on the CPU; {m_launches} chain_replay launches, "
        f"{m_card_s:.4f} s")

    first = fabric_sims("macro", FABRIC_PLANS[:1], *((x[0],) for x in FABRIC_MACRO),
                        metrics=True)[0]
    t1 = time.perf_counter()
    res = first.run()
    event_s = time.perf_counter() - t1
    lanes = {int(r) for k, r in zip(res.trace.kind, res.trace.resource) if int(k) == KIND_FABRIC}
    sim_doc, host = res.metrics["sim"], res.metrics["host"]
    if (res.engine != "event" or host != {"engine": "event"} or not lanes
            or sim_doc.get("payload_by_level") != FABRIC_PAYLOAD):
        raise AssertionError(f"MACRO job with metrics: engine {res.engine}, host {host}, "
                             f"{len(lanes)} fabric lanes, payload "
                             f"{sim_doc.get('payload_by_level')}")
    log(f"[fabric] {first.hw.name} with metrics=True: the event tier ({event_s:.4f} s), "
        f"{res.total_time!r} s, {len(res.trace)} trace rows, {len(lanes)} FABRIC lanes, "
        f"payload by level {sim_doc['payload_by_level']}")

    us = lambda p, k: p.get(k, 0) / 1e6
    for what, p, whole in (("card, first call", prof, card_s), ("card, warm", prof_warm, warm_s),
                           ("plain CPU path on this host", prof_cpu, cpu_s)):
        log(f"[fabric] {what}: host compile (classify, chains, signatures) "
            f"{us(p, 'compile_us'):.4f} s, group replay {us(p, 'eval_us'):.4f} s, interval "
            f"validation {us(p, 'validate_us'):.4f} s, whole call {whole:.4f} s")
    log(f"[fabric] chain_replay: {launches} launches in {prof['groups']} groups "
        f"({launches / prof['groups']:.1f} a group)")
    seconds = time.perf_counter() - t0
    log(f"[fabric] the phase: {seconds:.1f} s")
    if seconds > FABRIC_PHASE_S:
        raise AssertionError(f"the fabric phase took {seconds:.1f} s (limit {FABRIC_PHASE_S} s)")


# the co-design sweep of phase 12 through the port's command line: full-width
# yi-6b on the 16x16 TPU v5e slice, 4 tile rates x 4 DRAM rates x 4 plans
FRONT_SWEEP = ["sweep", "--arch", "yi-6b", "--hardware", "tpu_v5e_16x16", "--seq-len", "4096",
               "--global-batch", "256", "--noc-mode", "analytical", "--engine", "auto",
               "--max-plans", "4", "--microbatch-sizes", "1",
               "--hw-flops", "98e12", "197e12", "394e12", "788e12",
               "--hw-dram-bw", "409e9", "819e9", "1638e9", "3276e9", "--profile", "--metrics"]
FRONT_JOBS, FRONT_GROUPS = 64, 3
FRONT_SERVE = ["--arch", "yi-6b", "--hardware", "tpu_v5e_4x4"]
FRONT_PHASE_S = 60.0


def _wall_clock_free(doc):
    """A report document without what is wall clock: the profile's and the
    host counters' microseconds (keys ending in ``us``)."""
    if isinstance(doc, dict):
        return {k: _wall_clock_free(v) for k, v in doc.items()
                if not (k.endswith("_us") or k.endswith(".us"))}
    if isinstance(doc, list):
        return [_wall_clock_free(v) for v in doc]
    return doc


def _cli(argv):
    """``repro_torch.api.cli.main(argv)`` in this process: (exit code,
    standard output, seconds)."""
    import io
    from repro_torch.api import cli
    buf = io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t1


def _json_of(out):
    return json.loads(out[out.index("\n{") + 1:])


def phase_front_door(total):
    """Section 12: the simulator's front door (``repro_torch.api``,
    ``repro_torch.serving``, ``python -m repro_torch``). Gates: the
    co-design sweep of FRONT_SWEEP through ``cli.main`` on the card (the
    default device) launches ``chain_replay`` and nothing else and batches
    all 64 jobs in 3 groups (no fallback); ``--device cpu`` launches
    nothing; the two reports equal field by field but for wall clock; the
    same sweep as ``python -m repro_torch`` in a child process prints the
    in-process report, and with ``--workers 2`` (a spawned pool, a CUDA
    context a worker) gives the serial report; ``plan_codesign`` with a
    ``HardwareSearchSpace`` and the SLO objective on full-width yi-6b runs
    once, as the host code it is (its experiments run the event engine and
    never batch): it launches nothing and ranks every candidate on the
    event engine; ``serve-sim`` (64 Poisson requests) and ``serve-plan``
    on full-width yi-6b on the 4x4 slice run and print their summaries. ``chain_replay``'s main-path
    launches are those of the in-process card sweep. The child runs
    beside the rest of the phase, whose seconds include waiting for it.
    Returns the card sweep's report less its wall clock (phase 13 holds
    its guided runs to it)."""
    t0 = time.perf_counter()
    # the child's start-up (an interpreter, torch, a CUDA context) runs
    # beside the in-process sweeps and the pool; its output goes to files,
    # so a full pipe never stalls it
    child_out, child_err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    child = subprocess.Popen([sys.executable, "-m", "repro_torch", *FRONT_SWEEP, "--json", "-"],
                             cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                             stdout=child_out, stderr=child_err, text=True)
    try:
        return _front_door_gates(total, t0, child, child_out, child_err)
    finally:
        if child.poll() is None:
            child.kill()
        child.wait()
        child_out.close()
        child_err.close()


def _front_door_gates(total, t0, child, child_out, child_err):
    """The gates of :func:`phase_front_door`, beside the running child
    ``python -m repro_torch`` (``child``, its output in the two files)."""
    from repro_torch import api, kernels
    from repro_torch.configs import get_config
    from repro_torch.core.hardware import tpu_v5e_pod
    from repro_torch.serving.system import ServingSpec
    from repro_torch.serving.workload import WorkloadSpec
    runs = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        argv = FRONT_SWEEP + ["--json", "-"] + (["--device", "cpu"] if device == "cpu" else [])
        rc, out, seconds = _cli(argv)
        counts = kernels.launch_counts()
        if rc != 0:
            raise AssertionError(f"front door sweep on {device}: exit {rc}")
        doc = _json_of(out)
        prof = doc["profile"]
        want = {"jobs": FRONT_JOBS, "groups": FRONT_GROUPS, "batched_jobs": FRONT_JOBS,
                "fallback_jobs": 0, "ineligible_jobs": 0, "contended_jobs": 0, "scalar_jobs": 0}
        got = {k: prof.get(k, 0) for k in want}
        if got != want or doc["num_candidates"] != FRONT_JOBS or len(doc["runs"]) != FRONT_JOBS:
            raise AssertionError(f"front door sweep on {device}: profile {got}, "
                                 f"{len(doc['runs'])} runs")
        launches = counts["chain_replay"]
        if device == "cuda" and (counts != _launches(chain_replay=launches) or launches == 0):
            raise AssertionError(f"the front door sweep on the card launched {counts}")
        if device == "cpu" and counts != _launches():
            raise AssertionError(f"the front door sweep on the CPU launched {counts}")
        runs[device] = (doc, seconds, launches)
    card, cpu = (_wall_clock_free(runs[d][0]) for d in ("cuda", "cpu"))
    if card != cpu:
        diff = [k for k in card if card[k] != cpu.get(k)]
        raise AssertionError(f"front door sweep: card and CPU reports differ in {diff}")
    launches = runs["cuda"][2]
    total["chain_replay"] = total.get("chain_replay", 0) + launches
    best = card["runs"][0]
    log(f"[front door] cli sweep: yi-6b full width seq 4096 on tpu_v5e_16x16, 16 hardware "
        f"variants x 4 plans: {FRONT_JOBS} jobs, {FRONT_GROUPS} groups, all batched; card and "
        f"CPU reports equal but for wall clock; {launches} chain_replay launches; best "
        f"{best['hardware']} pp{best['plan']['pp']} dp{best['plan']['dp']} "
        f"tp{best['plan']['tp']} {best['throughput']!r} samples/s")

    rc, out, pool_s = _cli(FRONT_SWEEP + ["--workers", "2", "--json", "-"])
    pooled = _wall_clock_free(_json_of(out))
    # each worker groups its own shard, and the host half of the metrics
    # counts the pool's work (shards, workers): neither is a result
    if rc != 0 or pooled["executor"] != "process[2]" or \
            pooled["profile"]["batched_jobs"] != FRONT_JOBS:
        raise AssertionError(f"front door sweep, --workers 2: exit {rc}, executor "
                             f"{pooled['executor']}, profile {pooled['profile']}")
    result = lambda d: {**d, "executor": None, "profile": None,
                        "metrics": {"sim": d["metrics"]["sim"]}}
    if result(pooled) != result(card):
        raise AssertionError("front door sweep: the spawned pool's report differs from serial")
    log(f"[front door] --workers 2 (spawned, a CUDA context a worker): the serial report, "
        f"every job batched in {pooled['profile']['groups']} groups over the shards, "
        f"{pool_s:.2f} s with the pool's start")

    arch = get_config("yi-6b")
    slo = ServingSpec(workload=WorkloadSpec(rate=8.0, num_requests=12, seed=0, prompt_mean=128,
                                            decode_mean=16),
                      max_batch=4, ctx_bucket=128, slo_ttft_ms=500.0, slo_tpot_ms=8.0)
    cfg = api.PlannerCfg(global_batch=32, seq_len=256, microbatch_sizes=(1,), max_plans=8,
                         slo=slo, hardware_search=api.HardwareSearchSpace(
                             mesh_shapes=((1, 4), (2, 2))))
    kernels.reset_launch_counts()
    t1 = time.perf_counter()
    res = api.plan_codesign(arch, tpu_v5e_pod(2, 2), cfg, objective="slo")
    codesign_s = time.perf_counter() - t1
    counts = kernels.launch_counts()
    # the planner's experiments run the event engine and never batch
    if counts != _launches():
        raise AssertionError(f"plan_codesign(objective='slo') launched {counts}")
    engines = {r.extra.get("engine", "event") for r in res.report.runs}
    if res.objective != "slo" or res.run is not res.report.best or engines != {"event"} or \
            not res.run.extra["serving"]["slo"]["attainment"] > 0:
        raise AssertionError(f"plan_codesign(objective='slo'): {res.summary()}, engines {engines}")
    log(f"[front door] plan_codesign, SLO objective, {res.report.num_candidates} candidates on "
        f"{res.report.num_hardware} meshes: {res.summary()}; host code (the event engine, no "
        f"launch), {codesign_s:.2f} s")

    for argv in (["serve-sim", *FRONT_SERVE, "--num-requests", "64"],
                 ["serve-plan", *FRONT_SERVE]):
        rc, out, seconds = _cli(argv)
        head = "goodput:" if argv[0] == "serve-sim" else "best serving split"
        if rc != 0 or head not in out:
            raise AssertionError(f"{argv[0]}: exit {rc}\n{out[-2000:]}")
        for line in out.strip().splitlines():
            log(f"[front door] {argv[0]} | {line}")
        log(f"[front door] {argv[0]}: {seconds:.2f} s")

    rc = child.wait(timeout=300)
    child_s = time.perf_counter() - t0
    child_out.seek(0)
    child_err.seek(0)
    if rc != 0:
        raise AssertionError(f"python -m repro_torch: exit {rc}\n{child_err.read()[-3000:]}")
    if _wall_clock_free(_json_of(child_out.read())) != card:
        raise AssertionError("python -m repro_torch: its report differs from the in-process one")
    log(f"[front door] python -m repro_torch (a child process on the card, beside the rest of "
        f"the phase): the same report, done {child_s:.2f} s after its start")

    for device in ("cuda", "cpu"):
        doc, seconds, _ = runs[device]
        p = doc["profile"]
        log(f"[front door] sweep on {device}: host compile {p['compile_us'] / 1e6:.4f} s, group "
            f"replay {p['eval_us'] / 1e6:.4f} s, interval validation "
            f"{p['validate_us'] / 1e6:.4f} s, whole cli call {seconds:.4f} s")
    seconds = time.perf_counter() - t0
    log(f"[front door] the phase: {seconds:.1f} s")
    if seconds > FRONT_PHASE_S:
        raise AssertionError(f"the front door phase took {seconds:.1f} s "
                             f"(limit {FRONT_PHASE_S} s)")
    return card


# phase 13: guided search on FRONT_SWEEP's space; successive halving's
# rungs at budget 8 (the reference's ladder for an ANALYTICAL experiment)
SEARCH_SEED = ["--search-budget", "8", "--seed", "0"]
SEARCH_RUNGS = {"analytical-mb2": 32, "analytical-mb4": 16, "full": 8}
SEARCH_PLAN_BUDGET = 4     # the guided plan_codesign's full-fidelity sims (event engine)
SEARCH_PHASE_S = 30.0


@contextlib.contextmanager
def _launches_per_generation():
    """``chain_replay`` launches of each ``SweepEngine.evaluate_jobs`` call
    (a guided search's generation), in call order."""
    from repro_torch import kernels
    from repro_torch.api.sweep import SweepEngine
    calls, inner = [], SweepEngine.evaluate_jobs

    def counted(self, *args, **kwargs):
        before = kernels.launch_counts()["chain_replay"]
        try:
            return inner(self, *args, **kwargs)
        finally:
            calls.append(kernels.launch_counts()["chain_replay"] - before)
    SweepEngine.evaluate_jobs = counted
    try:
        yield calls
    finally:
        SweepEngine.evaluate_jobs = inner


def _run_key(run):
    return run["hardware"], json.dumps(run["plan"], sort_keys=True)


def _guided_cli(strategy, device):
    """One guided FRONT_SWEEP through ``cli.main`` on ``device``: (report
    document, seconds, launches by kernel, chain_replay launches a
    generation)."""
    from repro_torch import kernels
    argv = FRONT_SWEEP + ["--search", strategy, *SEARCH_SEED, "--json", "-"]
    kernels.reset_launch_counts()
    with _launches_per_generation() as gens:
        rc, out, seconds = _cli(argv + (["--device", "cpu"] if device == "cpu" else []))
    if rc != 0:
        raise AssertionError(f"--search {strategy} on {device}: exit {rc}\n{out[-2000:]}")
    return _json_of(out), seconds, kernels.launch_counts(), gens


def phase_search(total, exhaustive):
    """Section 13: guided multi-fidelity search (``repro_torch.search``) on
    FRONT_SWEEP's 64 candidates through ``cli.main`` in this process, no
    pool and no child. Gates: ``--search sh`` at budget 8 on the card (the
    default device) and with ``--device cpu`` gives equal reports but for
    wall clock; its rungs evaluate 32, 16 and 8 candidates
    (SEARCH_RUNGS), at most 8 at full fidelity; on the card every rung
    launches ``chain_replay`` and nothing else, on the CPU nothing
    launches. Every guided full-fidelity run equals the exhaustive card
    sweep's run of the same (hardware, plan) (``exhaustive``: phase 12's
    report). ``--search random`` and ``evolve`` on the card equal the CPU
    too. ``plan_codesign(strategy="sh")`` on full-width yi-6b over the same
    hardware space (throughput objective, SEARCH_PLAN_BUDGET full sims on
    the event engine) launches ``chain_replay`` on the card, nothing on
    the CPU, and gives the same result. The card runs' launches join
    ``chain_replay``'s main-path count."""
    from repro_torch import api, kernels
    from repro_torch.configs import get_config
    from repro_torch.core.enums import NoCMode
    t0 = time.perf_counter()
    by_run = {_run_key(r): r for r in exhaustive["runs"]}
    launches = 0
    for strategy in ("sh", "random", "evolve"):
        docs = {}
        for device in ("cuda", "cpu"):
            doc, seconds, counts, gens = _guided_cli(strategy, device)
            search, prof = doc["search"], doc["profile"]
            n = counts["chain_replay"]
            if device == "cuda" and (counts != _launches(chain_replay=n) or n == 0):
                raise AssertionError(f"--search {strategy} on the card launched {counts}")
            if device == "cpu" and counts != _launches():
                raise AssertionError(f"--search {strategy} on the CPU launched {counts}")
            if search["full_fidelity_sims"] > 8 or len(gens) != len(prof["generations"]):
                raise AssertionError(f"--search {strategy} on {device}: {search}, "
                                     f"{len(gens)} engine calls")
            if strategy == "sh":
                if search["sims_per_fidelity"] != SEARCH_RUNGS:
                    raise AssertionError(f"--search sh on {device}: rungs "
                                         f"{search['sims_per_fidelity']}")
                if device == "cuda" and not all(gens):
                    raise AssertionError(f"--search sh: a rung launched nothing on the card "
                                         f"({gens})")
            if device == "cuda":
                launches += n
            docs[device] = _wall_clock_free(doc)
            rungs = ", ".join(f"{g['jobs']} jobs {g.get('batched_jobs', 0)} batched "
                              f"{launches_g} launches {g.get('eval_us', 0) / 1e6:.4f} s replay"
                              for g, launches_g in zip(prof["generations"], gens))
            log(f"[search] --search {strategy} on {device}: {seconds:.4f} s, host compile "
                f"{prof.get('compile_us', 0) / 1e6:.4f} s, group replay "
                f"{prof.get('eval_us', 0) / 1e6:.4f} s, interval validation "
                f"{prof.get('validate_us', 0) / 1e6:.4f} s; rungs: {rungs}")
        card, cpu = docs["cuda"], docs["cpu"]
        if card != cpu:
            diff = [k for k in card if card[k] != cpu.get(k)]
            raise AssertionError(f"--search {strategy}: card and CPU reports differ in {diff}")
        for run in card["runs"]:
            if by_run.get(_run_key(run)) != run:
                raise AssertionError(f"--search {strategy}: the full-fidelity run "
                                     f"{_run_key(run)} differs from the exhaustive sweep's")
        best = card["runs"][0]
        log(f"[search] --search {strategy}: card and CPU reports equal but for wall clock; "
            f"{card['search']['sims_per_fidelity']}; {len(card['runs'])} full-fidelity runs "
            f"equal to the exhaustive sweep's; best {best['hardware']} pp{best['plan']['pp']} "
            f"dp{best['plan']['dp']} tp{best['plan']['tp']} {best['throughput']!r} samples/s")

    cfg = api.PlannerCfg(global_batch=256, seq_len=4096, max_plans=4, microbatch_sizes=(1,),
                         noc_mode=NoCMode.ANALYTICAL,
                         hardware_search=api.HardwareSearchSpace(
                             tile_flops=(98e12, 197e12, 394e12, 788e12),
                             dram_bandwidth=(409e9, 819e9, 1638e9, 3276e9)),
                         search_strategy="sh", search_budget=SEARCH_PLAN_BUDGET, search_seed=0)
    plans = {}
    for device in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        t1 = time.perf_counter()
        res = api.plan_codesign(get_config("yi-6b"), api.resolve_hardware("tpu_v5e_16x16"), cfg,
                                device=None if device == "cuda" else "cpu")
        seconds = time.perf_counter() - t1
        counts = kernels.launch_counts()
        n = counts["chain_replay"]
        if device == "cuda" and (counts != _launches(chain_replay=n) or n == 0):
            raise AssertionError(f"the guided plan_codesign on the card launched {counts}")
        if device == "cpu" and counts != _launches():
            raise AssertionError(f"the guided plan_codesign on the CPU launched {counts}")
        if device == "cuda":
            launches += n
        plans[device] = res
        log(f"[search] plan_codesign(strategy='sh') on {device}: {res.summary()}; "
            f"{res.report.search.summary()}; {n} chain_replay launches, {seconds:.4f} s")
    card, cpu = (_wall_clock_free(json.loads(plans[d].to_json())) for d in ("cuda", "cpu"))
    if card != cpu or _wall_clock_free(plans["cuda"].report.to_dict()) != \
            _wall_clock_free(plans["cpu"].report.to_dict()):
        raise AssertionError("the guided plan_codesign: card and CPU results differ")
    total["chain_replay"] = total.get("chain_replay", 0) + launches
    seconds = time.perf_counter() - t0
    log(f"[search] the phase: {launches} chain_replay launches on the card, {seconds:.1f} s")
    if seconds > SEARCH_PHASE_S:
        raise AssertionError(f"the search phase took {seconds:.1f} s (limit {SEARCH_PHASE_S} s)")


def kernel_line(rows, errs, total):
    """The kernels line: one entry a kernel of the main path, the SSD scan's
    FMA paths apart from its wgmma ones, and the wgmma SSD forward and
    backward at N 16 (hymba-1.5b's) apart from N 128 (mamba2-2.7b's). The
    wgmma SSD entries at N 16 and the backward's at N 128 list the FMA
    kernel on their inputs under "paths"; the
    RMSNorm backward's lists its versions at the RMS_BWD_NEW widths (the
    register version, hubert's 1280 the loop version), each with the bf16
    launches of the model that trains there (at that width and the model's
    others); flash's and RMSNorm's forward entries list the embeds-input
    archs' prefill shapes under "shapes" with that model's launches. The
    wgmma flash at head dim 80 (hubert-xlarge) has entries of its own, and
    its forward at head dim 192 (nemotron-4-340b) one; the backward at hd
    192 is a shape of ``flash_attention_bwd``'s (0 main-path launches)."""
    bf16 = torch.bfloat16
    new_width = lambda r: r["name"] == "rmsnorm_bwd" and r["H"] != RMS_BWD_MAIN[1]
    out, rms_new = [], [r for r in rows if new_width(r)]
    shapes = {}           # other models' shapes of a kernel, by the kernel's name
    for r in rows:
        if "model" in r:
            shapes.setdefault(r["name"], []).append(
                {"model": r["model"], "shape": r["shape"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                 "library_ms": r["library_ms"],
                 "launches": total.by_model[r["model"], bf16][r["name"]],
                 **({"note": r["note"]} if "note" in r else {})})
    for r in rows:
        if new_width(r) or "model" in r:
            continue
        src, replaces = SOURCES[r["name"]]
        entry = {"name": r["name"], "route": "cuda", "source": src, "replaces": replaces,
                 "launches": total[r["name"]],
                 "max_abs_err": errs[(r["name"], r.get("dtype", bf16))],
                 "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                 "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if r["name"] in ("ssd_scan_n16", "ssd_scan_bwd", "ssd_scan_bwd_n16"):
            fma = "ssd_scan_fma" if r["name"] == "ssd_scan_n16" else "ssd_scan_bwd_fma"
            fma_err = errs[("ssd_scan_bwd fma", bf16) if r["name"] == "ssd_scan_bwd"
                           else (fma, bf16)]
            entry["paths"] = [
                {"path": "wgmma", "source": src, "ms": r["ms"],
                 "max_abs_err": entry["max_abs_err"]},
                {"path": "fma", "source": SOURCES[fma][0], "ms": r["fma_ms"],
                 "max_abs_err": fma_err}]
        if r["name"] == "rmsnorm_bwd":
            entry["paths"] = [
                {"path": n["path"], "shape": n["shape"], "ms": n["ms"], "plain_ms": n["plain_ms"],
                 "bound_ms": n["bound_ms"], "bound_by": n["bound_by"],
                 "library_ms": n["library_ms"], "max_abs_err": errs[("rmsnorm_bwd", bf16, n["H"])],
                 "model": RMS_BWD_NEW_MODELS[n["H"]],
                 "launches": total.by_model[RMS_BWD_NEW_MODELS[n["H"]], bf16]["rmsnorm_bwd"]}
                for n in rms_new]
        if r["name"] in shapes:
            entry["shapes"] = shapes[r["name"]]
        out.append(entry)
    return out


def run_model(name, tf_len, tf_layers, total, time_kernels, decode_spans, tf_cfg=None):
    """One model's main path (launches added to ``total``), then its kernel
    and end-to-end times. Returns the kernel rows; frees the model."""
    model, prefill, serve = phase_slice(name, tf_len, tf_layers, total, tf_cfg)
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = time_kernels(gen)
    for r in rows:
        _log_row(r)
    times_end_to_end(name, model, prefill, serve, gen, decode_spans)
    del model, prefill, serve
    torch.cuda.empty_cache()
    return rows


def _layers_that_fit(arch, cfg, reserve=6 * 2**30):
    """``arch.num_layers``, or the most layers whose weights in
    ``cfg.compute_dtype`` leave ``reserve`` bytes of the card free
    (``torch.cuda.mem_get_info``) for activations and the decode cache."""
    import dataclasses
    from repro_torch.models.lm import LM, param_count
    free, _ = torch.cuda.mem_get_info()
    per = lambda L: param_count(LM(dataclasses.replace(arch, num_layers=L), cfg, device="meta"))
    size = torch.finfo(cfg.compute_dtype).bits // 8
    head, layer = per(0), per(1) - per(0)
    fit = int((free - reserve) / size - head) // layer
    log(f"[slice] {arch.name}: {per(arch.num_layers) * size / 1e9:.2f} GB of weights at "
        f"{arch.num_layers} layers, {free / 2**30:.2f} GiB free on the card: room for {fit} "
        f"layers beside {reserve / 2**30:.0f} GiB")
    return min(arch.num_layers, fit)


def phase_capped_slice(name, total, time_kernels, decode_spans, gate_layers=4, tf_len=64,
                       tf_layers=None):
    """Serve full-width ``name`` through the port's entry points (random
    bf16 weights from seed 0) at as many of its layers as the card holds
    (``_layers_that_fit``): the archs whose gates cannot run beside the
    served model, the embeds-input ones (hubert-xlarge, llava-next-34b)
    and nemotron-4-340b (8 of its 96 layers on an 80 GB card). Prefill B=2
    S=2000 from fp32 embeddings or tokens with its launches counted (logits
    at every position for an encoder, the last for a causal arch); for a
    causal arch 4 serve steps B=4, counted, for a token arch greedy
    generation, counted, and where the fp32 check is cut to ``tf_layers``
    (nemotron: 1) the bf16 teacher-forced forward/decode check over
    ``tf_len`` inputs at the served depth (reported: bf16 is gated by the
    logits check); its end-to-end and kernels' times. Then, with the
    model freed, the gates on the first layers of the same seed, drawn at
    the served depth's scales (``_as_first_layers_of``: drawn as a 4-layer
    model, llava's wq would have std 0.5 where the served model's has
    0.129, and its fp32 teacher-forced check read 1.73x the 2e-2
    tolerance): the bf16 logits through the kernels against the plain
    versions (``check_model_bf16``) at the prefill's shape on
    ``gate_layers`` layers, and for a causal arch the teacher-forced check
    from ``tf_len`` inputs, fp32 gated, on ``tf_layers`` layers
    (``gate_layers`` by default; nemotron's fp32 copy holds one layer).
    Returns the kernel rows."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.lm import RunCfg, init_params, param_count
    from repro_torch.serving.serve import greedy_generate, make_prefill_step, make_serve_step

    cfg = RunCfg(compute_dtype=torch.bfloat16)
    arch = get_config(name)
    layers = _layers_that_fit(arch, cfg)
    if layers < max(1, gate_layers):
        raise AssertionError(f"{name}: {layers} layers fit beside the head, the gates take "
                             f"{gate_layers}")
    arch = dataclasses.replace(arch, num_layers=layers)
    key = "embeds" if arch.embeds_input else "tokens"
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model = init_params(arch, gen, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"[slice] {name} full width: {arch.num_layers} of {get_config(name).num_layers} layers, "
        f"d {arch.d_model}, {param_count(model) / 1e9:.3f} B params bf16, init "
        f"{time.perf_counter() - t0:.2f} s")
    V = arch.vocab

    # (a), (b) prefill with its launches counted
    prefill = make_prefill_step(model)
    prompt = _prompt(arch, gen, 2, 2000)
    logits, counts = _counts_since_reset(lambda: prefill({key: prompt}))
    want_shape = (2, 1 if arch.causal else 2000, V)
    if logits.shape != want_shape or not torch.isfinite(logits).all():
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not finite {want_shape}")
    want = _forward_launches(arch)
    if counts != want:
        raise AssertionError(f"prefill launched {counts}, expected {want}")
    _check_rope_launches(f"{name} prefill", arch.num_layers if arch.has_attention else 0)
    log(f"[slice] (a,b) {name} prefill B=2 S=2000 from {key}: logits {tuple(logits.shape)} "
        f"finite; launches {counts}")
    total.add(counts, arch)
    del logits

    # (e) serve steps (causal archs; an encoder has no decode), (d) greedy
    # generation (token archs), (c) bf16 teacher-forced at the served depth
    # where the fp32 check is cut (nemotron)
    serve = make_serve_step(model)
    if arch.causal:
        cache = model.init_cache(4, 8)
        steps = _prompt(arch, gen, 4, 4)

        def serve_steps():
            for pos in range(4):
                tok, lg, _ = serve(cache, steps[:, pos], pos)
            return tok, lg

        (tok, lg), counts = _counts_since_reset(serve_steps)
        total.add(counts, arch)
        if lg.shape != (4, V) or not torch.isfinite(lg).all() or tok.shape != (4,):
            raise AssertionError("serve_step output malformed")
        if counts != _launches(rmsnorm=4 * _norms(arch)):
            raise AssertionError(f"4 serve steps launched {counts}")
        log(f"[slice] (e) {name} 4 serve steps B=4 from {key}: logits {tuple(lg.shape)} "
            f"finite; launches {counts}")
        del cache
        tf = _prompt(arch, torch.Generator(device="cuda").manual_seed(1), 1, tf_len)
        if not arch.embeds_input:
            start = torch.randint(0, V, (4, 32), generator=gen, device="cuda")
            out, counts = _counts_since_reset(lambda: greedy_generate(model, start, 32))
            total.add(counts, arch)
            if out.shape != (4, 32) or out.min() < 0 or out.max() >= V:
                raise AssertionError(f"greedy_generate gave {tuple(out.shape)} in "
                                     f"[{out.min()}, {out.max()}]")
            log(f"[slice] (d) {name} greedy_generate B=4 prompt 32 new 32: tokens "
                f"{tuple(out.shape)}; launches {counts}")
        if tf_layers is not None:
            full, dec = _teacher_forced(model, tf)
            log(f"[slice] (c) {name} teacher-forced S={tf_len} bf16, the served "
                f"{arch.num_layers} layers (reported): {_tf_summary(full, dec)}")
            del full, dec

    # end-to-end times, then (the model freed: the plain versions' scratch
    # does not fit beside nemotron's weights) the kernels' times
    tgen = torch.Generator(device="cuda").manual_seed(11)
    times_end_to_end(name, model, prefill, serve, tgen, decode_spans)
    del model, prefill, serve
    gc.collect()
    torch.cuda.empty_cache()
    rows = time_kernels(tgen)
    for r in rows:
        _log_row(r)

    # (c) the gates on the first layers of the same seed
    cut = dataclasses.replace(arch, num_layers=gate_layers)
    if arch.causal:
        tf_layers = tf_layers or gate_layers
        _teacher_forced_gate(name, dataclasses.replace(arch, num_layers=tf_layers), tf_len,
                             tf_layers, tf, None,
                             {"full_depth": False, "bf16_layers": gate_layers,
                              "depth": arch.num_layers}, prompt)
    else:
        model = init_params(cut, torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        check_model_bf16(_as_first_layers_of(model, arch.num_layers), prompt,
                         _forward_launches(cut))
        del model
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 references in full fp32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    mark = [t0]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[phase] {name}: {now - mark[0]:.1f} s")
        mark[0] = now

    phase_build()
    phase_done("build")
    errs = phase_parity()
    phase_done("forward parity")
    errs.update(phase_bwd_parity())
    phase_done("flash and RMSNorm backward parity")
    errs.update(phase_ssd_bwd_parity())
    phase_done("SSD backward parity")
    total = Launches()
    # yi-6b: decode after a short prompt, and at the prefill's context in a
    # 2,048-token cache (decode attention reads pos + 1 slots)
    rows = run_model("yi-6b", 64, 32, total, times_attn_kernels, ((40, 1), (2048, 1984)))
    phase_done("yi-6b serving")
    # mamba2-2.7b: decode cost does not depend on the context (a fixed state)
    rows += run_model("mamba2-2.7b", 300, 8, total, times_ssm_kernels, ((40, 1),))
    phase_done("mamba2-2.7b serving")
    # hymba-1.5b: the teacher-forced check runs 1100 tokens past the
    # 1024-slot KV ring on its first 4 layers; decode after a short prompt
    # and at 1985-2016 of a 2,048-token request, where the ring has wrapped
    rows += run_model("hymba-1.5b", 1100, 4, total, times_hymba_kernels,
                      ((40, 1), (2048, 1984)), tf_cfg={"full_depth": False})
    phase_done("hymba-1.5b serving")
    # granite-moe: teacher-forced drop-free (its decode's capacity is 1 slot
    # an expert at B = 1), gated on its first 4 layers: under the
    # reference's init fp32 rounding flips routing and attention argmaxes
    # further in (0.378 relative L2 at 32 layers); bf16 logits gated there
    # too; decode as yi-6b's
    rows += run_model("granite-moe-3b-a800m", 64, 4, total, times_granite_kernels,
                      ((40, 1), (2048, 1984)),
                      tf_cfg={"run": {"capacity_factor": DROP_FREE}, "bf16_layers": 4})
    phase_done("granite-moe-3b-a800m serving")
    # the embeds-input archs: hubert-xlarge, an encoder (no decode), and
    # llava-next-34b, decoded from embeddings at positions 2-33
    rows += phase_capped_slice("hubert-xlarge", total, times_hubert_kernels, ())
    phase_done("hubert-xlarge serving")
    rows += phase_capped_slice("llava-next-34b", total, times_llava_kernels, ((40, 1),))
    phase_done("llava-next-34b serving")
    # nemotron-4-340b at the depth the card holds (8 of 96 layers): decode
    # after a short prompt and at 1985-2016 of a 2,048-slot cache; the fp32
    # teacher-forced gate on 1 layer (its fp32 copy: 51.6 GB)
    rows += phase_capped_slice("nemotron-4-340b", total, times_nemotron_kernels,
                               ((40, 1), (2048, 1984)), tf_layers=1)
    phase_done("nemotron-4-340b serving")
    train_rows, single_steps = phase_train(total, phase_done)
    rows += train_rows
    with one_rank_nccl() as mesh:
        card_comm = phase_sharded(total, single_steps, mesh)
        phase_done("sharded training")
        torch.cuda.reset_peak_memory_stats()
        phase_mesh_serving(total, mesh)
        phase_done("sharded serving and expert parallelism")
    phase_dryrun(card_comm)
    phase_done("dry-run held to the card")
    palm_row, errs[("chain_replay", torch.float64)] = phase_palm_core(total)
    rows.append(palm_row)
    phase_done("the PALM core on the card")
    phase_fabric(total)
    phase_done("the scale-out fabric on the card")
    exhaustive = phase_front_door(total)
    phase_done("the simulator's front door")
    phase_search(total, exhaustive)
    phase_done("guided search")
    for name in [*SOURCES]:
        if not total.get(name):
            raise AssertionError(f"kernel {name} was never launched on the main path")
    log(f"[slice] main-path launches, every model's serving and training {total}")
    kernels = kernel_line(rows, errs, total)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
