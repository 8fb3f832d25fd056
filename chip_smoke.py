#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

  env      torch / CUDA / nvcc / triton versions, the card and its power
           limit
  build    nvcc builds every kernel source in src/repro_torch/kernels/csrc
           for sm_90a, one process per source, all at once; the flash
           library's SASS, and each flash_bf16 instance's (<64, 64>,
           <128, 128>, <192, 128>) on its own, must hold HGMMA and UTMALDG
           (the bf16 body's wgmma and TMA loads), and the SASS of
           flash_f32 and of ssd_chunk_f32 HMMA (the f32 entries' mma.sync
           products), each flash_f32 instance twice its P.V's (S on the
           tensor cores too)
  kernels  each hand-written kernel held against its plain PyTorch
           version over a sweep of shapes (bit-exact; the scatter with the
           rank's counts, at row widths of every body: narrow, medium,
           wide; grouped_agg's entries on both sides of every boundary of
           grouped_agg.plan and at 2^26 and 2^28 slots, with skewed cases,
           and its keys entry in RDMA-AGG's layouts; the f32 grouped_agg
           within atol 1e-3, rtol 1e-4 on random floats; flash_attention
           within 2e-5 in f32 and 2e-2 in bf16, and in bf16 each query
           row's rms difference within ROW_TOL of its rms, at S up to 4096
           and at glm4's S = 8192, where a control with one key tile
           dropped must read above ROW_TOL; ssd_scan within 2e-3 in f32
           (every case, N = 40 and 1024 included) and, in bf16, y within
           2e-2 and the f32 state within 2e-3, over SSD_SWEEP and at
           mamba2's layer; the MLA entry of flash in bf16
           over MLA_SWEEP and at deepseek's layer (q.k 192, v 128), with a
           dropped-tile control there; its non-causal calls over
           CROSS_SWEEP, the VLM's cross layer, whisper's encoder and cross
           layers with T = 1601 and 1500 keys, ragged S and T on both bf16
           bodies and f32, each path shape with a dropped-tile control and
           timed beside non-causal SDPA; the sweeps also hold the bf16
           body's persistent schedule: S either side of the 64-wide
           body's 192-row units and unit counts either side of a
           multiple of 132 blocks, every output pre-filled with NaN;
           each timed flash row also records its host issue, SDPA's
           device time and the exponentials' own time, ex2_ms; with
           --parent DIR the earlier tree's flash kernel, built from DIR,
           is timed beside this one's at the five path rows, in turns:
           the flash_parent line, and phases serve and xattn time each
           flash model's prefill step on both kernels, in turns: its
           prefill's parent_kernel), radix_partition also at the
           joins' A = 128 000 000 and its rank alone at 2^24 requests into
           8 and 64 buckets, the hash join (ops.join_sum) bit-exact
           against the plain sort-probe on a join's routed relations at
           A = 128 000 000 and timed there by pass, then each timed at the
           main paths' shapes (per call between CUDA events, and its device
           time from torch.profiler) beside its plain version, the nearest
           single PyTorch call and its bound (the larger of bytes / 3.35
           TB/s and operations / 989 TFLOP/s; flash also its TFLOP/s
           and share of the bound); for cas, the scatter, the rank and
           grouped_agg (at every table size of the OLAP path) also the
           host time to issue a call (and the PyTorch call's where there
           is one), the rank its scan's own device time, and a cas call
           must be one device operation, with no fill
  oltp     the OLTP path at the paper's §4.3 width: Database(device="cuda")
           with 1 000 000 products of 1 KB (+131 072 insert rows), 8 waves
           of 4096 checkout sessions (Session.begin/get/put ->
           Database.commit, max_retries=2), held against the same waves on
           a second Database whose kernels run their plain versions
  olap     the OLAP path at the paper's §5.4 size (configs OLAP: 128 000 000
           tuples a relation): Fig 8a's four joins over four bloom
           selectivities and Fig 8b's two aggregation schemes over the
           distinct-group sweep up to 67 108 864, through
           Database.load_table / scan / explain / execute, each held to
           its independent ground truth and to a second Database whose
           kernels run their plain versions; times, peak memory, and one
           profiled execution per variant at sel 0.5, G = 64 and 2**26.
           Then, outside those queries: Fig 8b's kernel row (a direct
           ops.grouped_agg call, f32, 2048 slots) and the shuffle
           microbench's two legs (direct LocalTransport.route calls)
  fig6     the fig6 commit batch at the JAX benchmark's sizes and at the
           paper's width (T = 1024, 8192), txn/s from the median of 40
           commits between CUDA events, and their spread
  serve    model serving at full published width and depth
           (src/repro_torch/bench/serve.py): glm4-9b and mamba2-370m with
           bf16 weights drawn on the card; the prefill step (glm4 B=1,
           mamba2 B=8, S=8192; median of 3 after a warm-up) must launch
           flash_attention / ssd_scan once a layer; every layer's kernel is
           held to its plain version on that layer's inputs at every
           position (within ROW_TOL, a faulty plain version reading above
           it), and the full-depth logits with f32 weights within
           F32_LOGIT_TOL wherever a 2^-20 nudge of the embedding moves the
           plain path's less (the bf16 full-depth difference is
           reported); then ServeEngine(slots=8,
           max_seq=1024) serves 16 requests in two waves, each wave must
           launch cas_lock, and its tokens must equal a plain engine's.
           Each measured prefill step is also counted once, outside its
           timed steps (launch/roofline.py: on the card, where the
           kernels credit themselves, and on meta tensors of the same
           shapes in a process of its own beside the card's work, which
           must agree), and its roofline row printed
           (serve_roofline, with mfu: MODEL_FLOPS / 989 TFLOP/s / the
           median step); the kernelized bound must not exceed the median.
           For glm4-9b, the dry-run's one-device estimate (argument bytes
           and the step's peak live bytes, launch/dryrun.py) must be at
           least MEMORY_MIN_RATIO of torch.cuda.max_memory_allocated()
  moe      the MoE and MLA model stack (bench/serve.py): llama4-maverick at
           full width cut to 2 of 48 layers (a dense and an MoE layer:
           128 experts of d_ff 8192 at top-1 and a shared expert) and
           deepseek-v2 at full width cut to 5 of 60 layers (the dense
           first layer and four MoE layers of 160 experts at top-6 and 2
           shared, MLA with q.k 192 / v 128), bf16 weights drawn on the
           card from seed 0; jamba-1.5-large at reduce_config only (one
           period of its layers at full width passes the card).  For each:
           the prefill step (B 1, S 8192; median of 3 after a warm-up)
           must launch exactly MOE_ARCHS' kernels (flash_attention or its
           MLA entry once an attention layer, the rank once an MoE layer,
           where it packs the experts' rows, ssd_scan once an SSM layer);
           every layer's kernel against its plain version and every MoE
           layer's packed experts against the reference loop on their own
           inputs within ROW_TOL, each with a faulty control above it (a
           dropped key tile, a dropped expert, a lost state); the rank at
           the dispatch's shape timed; an 8-request engine (one wave)
           whose tokens must equal a plain engine's, lock words 0; peak
           memory.  Then
           deepseek's sharded leg (mesh_leg, MESH_CUT): the same weights
           under a (data 2, model 4) sharding policy, the RRJ dispatch over
           8 shards of the card; a B 2 x S 4096 prefill step with the
           policy and without, whose launches must be exact (the MLA
           entry once an attention layer, the rank and the scatter twice
           an MoE layer a shard); every MoE layer's kernel RRJ against its
           plain twin (equal drops) and against the one-shard packed
           experts at the tokens that dropped nothing, within ROW_TOL, a
           dropped expert above it; 4 teacher-forced decode steps on the
           replicated twin against the reference loop, logit rows within
           ROW_TOL; the rank and the scatter at both radix passes' shapes
           timed beside index_copy_; dropped assignments, peak memory; the
           sharded step's roofline as phase serve's (moe_mesh_roofline,
           8 chips), with each shard's collective bytes by kind beside the
           time of one layer's all-to-alls through shard_map and of a
           re-enactment of their copies.  Then the RRJ's backward at
           deepseek's first MoE layer at full width under the same policy
           (mesh_grad_leg): kernel gradients equal to the plain RRJ's,
           within RRJ_GRAD_TOL of the one-shard packed experts' at the
           tokens that dropped nothing, a dropped expert above it, and the
           backward's launches exact (the scatter twice a shard, no rank)
  xattn    cross-attention and the encoder-decoder (bench/serve.py):
           llama-3.2-vision-90b at full width cut to 10 of 100 layers (8
           self-attention and 2 cross layers over 1601 image tokens of
           width 1280; B 1, S 8192) and whisper-base at its full config (6
           encoder layers over 16 x 1500 frames of 80 mel features, 6
           decoder layers at S 448), bf16 weights drawn on the card from
           seed 0.  Each timed prefill step (median of 3 after a warm-up)
           must launch exactly XATTN_ARCHS' kernels (flash_attention once
           a causal layer, its non-causal calls once a cross or encoder
           layer); every layer's kernel against its plain version on its
           own inputs within ROW_TOL, with a dropped-tile control of each
           kind above it; 32 greedy decode steps from
           init_decode_state(modality=), finite and launching nothing;
           whisper's f32 full-depth witness (phase serve's rule)
  paged    paged serving (src/repro_torch/bench/serve.py paged_engine):
           glm4-9b at its full config with bf16 weights drawn on the
           card; ServeEngine(paged=True, slots=8, max_seq=1024,
           block_tokens=16, max_resident=16, 128 cold blocks of 640 KiB)
           takes the 16 requests at once, all-local, async at a 25 % hot
           tier, blocking at 25 %, all-cold (1 hot block), and async on
           the plain path: tokens equal to all-local's and the plain run
           equal to the kernel run; lock words 0; cold reads and dirty
           write-backs in every configuration but all-local, none there;
           cas_lock once in each tick that claims a slot, no other
           kernel; hit rate, read_cold/write_cold msgs and bytes, ms a
           tick, tokens/s, the share of a tick outside the decode step,
           peak memory.  Then Fig serve (bench/fig_serve.py) at the JAX
           benchmark's sizes on the card, with its asserts
  shards   the n-shard fabric (MeshTransport(4) on the one card: a host
           thread a shard, collectives at a barrier): the radix and CAS
           kernels at the shards' shapes against their plain versions;
           the oltp checkout at the same width on 4 shards
           (max_retries=0), whose masks, store and txn_stats must equal a
           one-shard run's and a plain 4-shard run's (fabric_stats too),
           every committed write reading back, and whose rank, scatter
           and cas launches must be exactly 4x the one-shard run's; the
           fig6 paper_T8192 commit on 4 shards beside 1 (median of 40,
           host time to issue, profiled device time); the four joins at
           sel 0.5 and both aggregations at G in {64, 2^20, 2^26} on 4
           shards of 32 000 000 tuples, each equal to its ground truth
           and to the same query on one shard (RRJ also to the plain
           path), with times and peak memory
  train    the rank and the scatter at a parameter-server push's shapes
           (4 rows of 23.4 M and of 92 M lanes) and at RDMA-AGG's flush at
           G = 2^26 (4 rows of 2^26 lanes; 16 of 2^24 into 4 buckets, a
           shard's at n = 4) against their plain versions, timed, and the
           scatter against index_copy_ in PS_ROUNDS interleaved rounds; the trainer (src/repro_torch/bench/train.py)
           at mamba2-370m's full config, f32 masters from seed 0, AdamW, SyntheticLM
           batches of 8 x 2048, through Trainer.run in three sync modes:
           allreduce (6 steps), raw paramserver(staleness=0) (6 steps,
           losses equal to allreduce's within PARITY_RTOL) and compressed
           paramserver(staleness=4) (8 steps, epoch 8, every push routing
           bench.train.route_bytes); seconds a step, tokens/s, pull and
           push ms, peak memory and one more step, profiled, split by
           where its device time goes; then, on the first batch, every
           layer's bf16 kernel against its plain version at the training
           shapes within ROW_TOL, and the gradients on the kernel path
           against the plain path, leaf by leaf, in f32 within
           max(GRAD_TOL, 2 x the spread of sound roundings of S)
           (a faulty plain path above both limits) and in bf16 within
           each leaf's spread of bf16 rounding, for mamba2-370m and
           for glm4-9b at full width cut to 2 layers (B 1, S 4096: one
           build_grad_step, which must launch flash_attention twice a
           layer); and Fig 9
           (bench/fig9_ml.py) at the reference's sizes, its rows equal to
           a CPU run's, with one PS round timed

  scale    fig_scale (bench/fig_scale.py): at the JAX benchmark's sizes
           (4096 records, W in 1..64, uniform / zipf 0.9 / zipf 1.2) the
           kernel path against the plain path (txn_stats, attempts, ids,
           masks, store leaves equal) and the three panels' asserts; at
           the oltp store (1 000 000 records of 1 KB, 64 transactions a
           worker, T = 4096 at W = 64, max_retries 3) each point's
           grouped wave: launches, read-back, commits + final aborts ==
           sessions, host seconds, device time profiled; at W = 64 zipf
           1.2 the store equal to the plain path's; panels (b) and (c) on
           those traces, with the simulator's host time; the figure
           itself (panels, locality run, timed waves) through the
           harness's one-figure entry, on the kernel path's economics
  contention  Fig 10 (bench/fig10_contention.py) through the harness's
           one-figure entry at the JAX benchmark's sizes: the window
           sweep, the planner, a recorded workload replayed; the
           planner's load crossover on the §5.4 join (R and S of 128M
           tuples, sel 0.25) at loads 0, 8, 64; one GHJ and one RRJ at
           128M recorded through an EventTracer on the kernel and the
           plain path (traces equal event for event, values equal to the
           ground truth) and replayed on every profile; fig8a's replay
           row; then fabric-check on the card: every suite (27
           targets, 0 violations) and one 4096-session checkout wave
           through a ScheduleRecorder, race-checked (0 violations)
  figures  the benchmark harness (bench/run.py) in this process: --only F
           --time --check --json for fig2, fig6, fig7, fig8a and fig8b
           (train, paged, scale and contention run fig9, fig_serve,
           fig_scale and fig10 through bench.run.run_figure into the same
           folder); every JSON with JAX's keys and a measured_s for each
           measured row, 0 fabric-check violations, fig7's rows and
           fig2's modeled rows equal to a CPU run's; then the example
           twins (src/repro_torch/examples) at their small sizes

The kernels' f32 entries, which no timed path runs, are timed in phase
kernels at the f32 witnesses' shapes: flash_f32 (causal and non-causal
apart; S and P.V by 3xTF32 products on mma.sync, bound by both products
as three TF32 products at 495 TFLOP/s, the earlier FMA bound at 67
TFLOP/s beside it) and
ssd_chunk_f32 (the chunked SSD on mma.sync with x, B and C split into
bf16 parts, bound by its bytes, the split products at 989 TFLOP/s and
the recurrence's FMA bound beside them).  Their launches are counted where serve's and xattn's
f32 witnesses and train's f32 gradient check run them (a comparison's
launches, on no path): one f32_entries line.

Launch counts are set to 0 just before each path and read just after:
the oltp sessions and commits, the olap queries (Database.execute
alone), Fig 8b's kernel row, the one path of the f32 grouped_agg
entry, in serve and moe each timed prefill step and each engine wave
(moe's sharded leg: each timed prefill step with the policy and each
sharded decode step), in
xattn each timed prefill step and the decode steps, in
paged
each tick of each engine run, in shards the 4-shard oltp waves and the
4-shard queries, and in train each trainer run, Fig 9 and glm4's grad
step, in scale every grouped wave and the figure, in contention each
traced join and the recorded wave, in figures each figure's own run
(fig2 a path of its own: cas_lock, the rank and the scatter); each path
must have launched every kernel it runs.  The gradient checks' launches
count on no path.  The shuffle microbench's launches are reported beside
it and counted on no path.
Then three lines: the per-kernel JSON record (launches summed over the
paths named in its "paths"), the card's name and power limit
(nvidia-smi), and {"ok": true, "device": ...}.

    python3 chip_smoke.py            # everything, one card
    python3 chip_smoke.py --phases env,build,kernels --quick
    python3 chip_smoke.py --parent build/parent   # also time the kernel
                                                  # of an unpacked archive
    python3 chip_smoke.py --out smoke.jsonl   # also keep every phase line
    python3 chip_smoke.py --phases env,build,shards   # the n-shard fabric
    python3 chip_smoke.py --phases env,build,train    # training
    python3 chip_smoke.py --phases env,build,paged    # paged serving
    python3 chip_smoke.py --phases env,build,moe      # MoE and MLA models,
                                                      # the sharded RRJ
    python3 chip_smoke.py --phases env,build,xattn    # VLM and whisper
    python3 chip_smoke.py --phases env,build,scale,contention   # under load
    python3 chip_smoke.py --phases env,build,figures  # harness, examples
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# the card's datasheet peaks, read by main() from the port's one source,
# repro_torch.core.costmodel.H100: HBM3 bytes/s, dense bf16 and TF32
# tensor-core FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = BF16_FLOP_PER_S = F32_FLOP_PER_S = TF32_FLOP_PER_S = None
PHASES = ("env", "build", "kernels", "oltp", "olap", "fig6", "serve",
          "moe", "xattn", "paged", "shards", "train", "scale", "contention",
          "figures")
SERVE_ARCHS = {"glm4-9b": "flash_attention", "mamba2-370m": "ssd_scan"}
MEMORY_ARCH = "glm4-9b"          # the dry-run's memory estimate, held to
MEMORY_MIN_RATIO = 0.9           # at least this share of the measured peak
ROW_TOL = 2 ** -6        # bf16, kernel vs plain: rms(diff) / rms(plain)
                         # per row (a query row of one head; an SSD output
                         # row of one head), the worst row
F32_LOGIT_TOL = 0.05     # f32 weights and activations, full depth: last-
                         # position logits, kernel path vs plain path
MAIN_T, MAIN_WAVES = 4096, 8     # checkouts per wave, waves (the store's
                                 # widths: configs/paper_nam.py::OLTP)
FIG6_ITERS = 40                  # timed commits per fig6 run
OLAP_N = 128_000_000             # tuples a relation: configs OLAP
OLAP_QUICK_N = 1 << 22
RANK_WIDE_A = 1 << 24            # check_radix's rank-only cases: 4096 blocks
PROFILE_SELS = (0.5,)            # one profiled execution per join here
PROFILE_GROUPS = (64, 67_108_864)  # ... and per aggregation scheme here
OLTP_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "cas_lock")
OLAP_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "grouped_sum_u32", "hash_join")
KERNEL_ROW_KERNELS = ("grouped_agg",)
SHARDS = 4                       # the paper's 3 storage and 4 client nodes
                                 # as one n
SHARD_GROUPS = (64, 1 << 20, 1 << 26)
TRAIN_ARCH = "mamba2-370m"
TRAIN_BATCH, TRAIN_SEQ = 8, 2048
TRAIN_MODES = (("allreduce", True, 6),          # (sync mode, compressed
               ("paramserver(staleness=0)", False, 6),   # push, steps)
               ("paramserver(staleness=4)", True, 8))
PARITY_RTOL = 1e-4       # allreduce vs raw paramserver(staleness=0) losses
PS_ROUNDS, PS_CALLS = 3, 50     # the PS push's scatter against index_copy_:
                                 # rounds in turns, calls a round
GRAD_TOL = 2 ** -8       # kernel vs plain path gradients, f32 masters and
                         # f32 activations: rms(diff) / rms(plain) per
                         # leaf, the worst leaf; the floor of the limit,
                         # which is twice the spread of sound roundings of
                         # S where that is larger (_grad_check; on an
                         # H100 mamba2-370m read 2.6e-5, faulty control
                         # 0.034, glm4-9b's control 0.90)
GLM_GRAD = ("glm4-9b", 2, 1, 4096)   # arch, layers, batch, seq
SCALE_TXNS = 64          # fig_scale at the oltp store: transactions a
                         # worker, so T = 4096 at W = 64 (the oltp wave)
SCALE_QUICK = (65_536, 16, 16)   # --quick: records, payload words, txns
CONTENTION_VARIANTS = ("ghj", "rrj")
JOIN_KERNELS = ("radix_partition_rank", "radix_partition_scatter",
                "hash_join")
# phase moe: arch -> (layers, reduce_config?, what a prefill step launches)
MOE_ARCHS = {
    "llama4-maverick-400b-a17b": (2, False, {"flash_attention": 2,
                                             "radix_partition_rank": 1}),
    "deepseek-v2-236b": (5, False, {"flash_attention_mla": 5,
                                    "radix_partition_rank": 4}),
    "jamba-1.5-large-398b": (None, True, {"flash_attention": 2,
                                          "ssd_scan": 2,
                                          "radix_partition_rank": 2}),
}
MOE_CUTS = {
    "llama4-maverick-400b-a17b":
        "full width, 2 of 48 layers: one period (a dense and an MoE layer), "
        "18.7 B parameters, 37 GB in bf16; four layers would pass the card",
    "deepseek-v2-236b":
        "full width, 5 of 60 layers: the dense first layer and four MoE "
        "layers, 17.3 B parameters, 35 GB in bf16",
    "jamba-1.5-large-398b":
        "reduce_config only: one 8-layer period at full width holds four MoE "
        "layers of 16 x 604 M = 9.66 B parameters each, 77 GB in bf16 before "
        "the SSM, attention and embeddings, more than the card's 80 GB; a "
        "chip's share of its experts needs a machine of several cards "
        "(ROADMAP item 8, step 3): a mesh emulated on one card holds every "
        "shard's experts",
}
MOE_REQUESTS = 8                 # phase moe's engines: one wave of 8 slots
# phase moe's sharded leg: deepseek-v2's cut under make_policy(
# make_host_mesh(*MESH_SHAPE)), the RRJ dispatch over 8 shards of the card
MESH_ARCH = "deepseek-v2-236b"
MESH_SHAPE = (2, 4)              # (data, model)
MESH_PREFILL = (2, 4096)         # B over data, S over model: T_local 1024
MESH_DECODE = (2, 4)             # batch, teacher-forced decode steps
RRJ_PASSES = 2                   # radix passes (a rank and a scatter each)
RRJ_GRAD_TOL = 2 ** -6           # bf16: each gradient leaf of the RRJ
                                 # against the packed experts', the norm of
                                 # the difference over the packed one's
                                 # of moe._moe_rrj an MoE layer a shard: by
                                 # owner shard, then by local expert; the
                                 # decode twin (_moe_replicated) bins once
MESH_CUT = ("deepseek-moe-5L's weights (full width, 5 of 60 layers) under a "
            "(data 2, model 4) policy: 8 shards emulated on one card, 40 "
            "experts a model shard, FSDP halves of d_model; B 2 x S 4096 "
            "(the phase's 8192 tokens), capacity_factor 1.25")
# phase xattn: arch -> (layers, what a prefill step launches)
XATTN_ARCHS = {
    "llama-3.2-vision-90b": (10, {"flash_attention": 8,
                                  "flash_attention_noncausal": 2}),
    "whisper-base": (None, {"flash_attention": 6,
                            "flash_attention_noncausal": 12}),
}
XATTN_CUTS = {
    "llama-3.2-vision-90b":
        "full width, 10 of 100 layers: two periods of 4 self-attention "
        "layers and a cross layer; the 100 layers' 90 B parameters take "
        "181 GB in bf16; 1601 image tokens of width 1280 (one tile); B 1 x "
        "S 8192 text tokens",
    "whisper-base":
        "none: the full config (6 encoder and 6 decoder layers); B 16 "
        "utterances of 30 s (1500 frames of 80 mel features), decoder S 448 "
        "(Whisper's text context, arXiv:2212.04356)",
}
DECODE_STEPS = 32                # phase xattn: greedy decode steps a model
PAGED_ARCH = "glm4-9b"
PAGED_CONFIGS = {"all_local": dict(hot_frac=1.0),      # paged engine runs
                 "async": dict(hot_frac=0.25),         # (bench.serve.
                 "blocking": dict(hot_frac=0.25, prefetch=False),  # paged_
                 "all_cold": dict(hot_blocks=1)}       # engine keywords)
PAGED_PLAIN = "async"            # the configuration also run on the plain
                                 # path (impl="plain")
CHECK_TARGETS = 27               # fabric-check: the JAX package's targets
# phase figures: bench/run.py's main in-process, --time --check --json, for
# the figures no other phase runs; the rest come through run_figure in
# phases train (fig9), paged (fig_serve), scale (fig_scale) and
# contention (fig10), into the same directory
FIGURES = ("fig2", "fig6", "fig7", "fig8a", "fig8b")
# what each figure's own run launches (fig7 is analytic: nothing)
FIGURE_KERNELS = {
    "fig2": ("cas_lock", "radix_partition_rank", "radix_partition_scatter"),
    "fig6": ("cas_lock", "radix_partition_rank", "radix_partition_scatter"),
    "fig7": (),
    "fig8a": ("radix_partition_rank", "radix_partition_scatter",
              "hash_join"),
    "fig8b": ("radix_partition_rank", "radix_partition_scatter",
              "grouped_sum_u32", "grouped_agg"),
}
# the JAX harness's BENCH_<figure>.json keys (benchmarks/run.py --time),
# beside figure, profile, timed, rows and measured_s
JAX_EXTRAS = {
    "fig2": ("profiles",), "fig6": ("fabric", "modeled_wire_s"),
    "fig7": ("crossover", "profiles"),
    "fig8a": ("fabric", "modeled_wire_s", "overlap", "crossover"),
    "fig8b": ("fabric", "modeled_wire_s", "crossover"),
    "fig9": ("workers", "straggler_factor", "total_batches"),
    "fig10": ("windows", "crossover", "replay", "fabric"),
    "fig_scale": ("workers", "skews", "throughput", "abort_rate", "retries",
                  "locality", "txn"),
    "fig_serve": ("workload", "parity", "latency", "recovery", "configs"),
}
# the rows each figure measures: every one needs its measured_s
MEASURED_ROWS = {
    "fig2": r"fig2/(mem_copy_|fabric_)",
    "fig6": r"fig6/measured_rsi_commit_local$",
    "fig7": r"$^",
    "fig8a": r"fig8a/(sel[0-9.]+_(ghj|ghj_bloom|rdma_ghj|rrj)|shuffle_)",
    "fig8b": r"fig8b/(groups[0-9]+_(dist_agg|rdma_agg)|kernel_)",
}
EXAMPLE_TRAIN_STEPS = 10         # train_lm --tiny on the card
_FIG_DIR = []                    # the temporary BENCH_<figure>.json folder
# the kernels' f32 entries (flash_f32's causal and non-causal calls
# apart): timed in phase kernels, launches counted where the f32 witnesses
# and gradient checks run them
F32 = {"flash_f32": {}, "flash_f32_noncausal": {}, "ssd_chunk_f32": {}}
_OUT = []                        # a file every emitted line also goes to


def emit(phase: str, **kw):
    line = json.dumps({"phase": phase, **kw})
    print(line, flush=True)
    for f in _OUT:
        f.write(line + "\n")
        f.flush()


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def fig_dir() -> Path:
    """The run's temporary folder of BENCH_<figure>.json files (made at
    the first call, removed when main ends)."""
    if not _FIG_DIR:
        _FIG_DIR.append(Path(tempfile.mkdtemp(prefix="chip_smoke_bench_")))
    return _FIG_DIR[0]


def run_figure(name: str, *, device="cuda", **kw) -> dict:
    """One figure through the harness's one-figure entry
    (src/repro_torch/bench/run.py), timed, its JSON into fig_dir() and
    its CSV rows nowhere: the payload."""
    from repro_torch.bench import run as bench_run
    return bench_run.run_figure(name, timed=True, device=device,
                                json_to=fig_dir(), out=io.StringIO(), **kw)


def payload_failures(name: str, payload: dict, *, checked: bool) -> list:
    """What a BENCH_<figure>.json lacks: JAX's keys, a measured_s for each
    measured row (every value a positive float), and, when ``checked``, a
    check block with no violation."""
    bad = []
    want = {"figure", "profile", "timed", "rows", "measured_s",
            *JAX_EXTRAS[name]} | ({"check"} if checked else set())
    if set(want) - set(payload):
        bad.append(f"{name}: no {sorted(set(want) - set(payload))}")
    measured = payload.get("measured_s") or {}
    if not measured or not all(isinstance(v, float) and v > 0
                               for v in measured.values()):
        bad.append(f"{name}: measured_s {measured}")
    pat = re.compile(MEASURED_ROWS.get(name, r"$^"))
    rows = [r["name"] for r in payload.get("rows", [])]
    missing = [r for r in rows if pat.match(r) and r not in measured]
    if missing:
        bad.append(f"{name}: measured rows without measured_s {missing}")
    if checked and (payload.get("check", {}).get("violations")
                    or not payload.get("check", {}).get("targets")):
        bad.append(f"{name}: fabric-check {payload.get('check')}")
    return bad


# ------------------------------------------------------------- timing ---

def time_ms(fn, *, setup=None, iters=20, warmup=3):
    """Median milliseconds of ``fn()`` over ``iters`` calls, each between
    its own CUDA events; ``setup()`` runs before each call, outside the
    window (it restores state an in-place kernel changed)."""
    import torch
    out = []
    for k in range(warmup + iters):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        if k >= warmup:
            out.append(a.elapsed_time(b))
    return statistics.median(out)


LEAD_OPS = 8             # throwaway device ops that open a profiled trace
LEAD_GAP_S = 1e-3        # host seconds between them and the measured calls
MEASURED = "chip_smoke.measured"   # the range around them (the profiler
                                   # also lists it as a device event)


def device_events(fn, *, setup=None, iters: int) -> list:
    """The device events (kernels, copies, fills) of ``iters`` calls of
    ``fn()`` under ``torch.profiler``, ``setup()`` before each.  A trace can
    lose its first device records (on the H100 machines, up to three: every
    launch is in the host's runtime records, its kernel not), so each trace
    opens with LEAD_OPS throwaway fills, a sync and a LEAD_GAP_S pause, and
    only device events that start after half that pause count (and not
    the MEASURED range itself)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    fn()
    lead = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_OPS):
            lead.add_(1)
        torch.cuda.synchronize()
        time.sleep(LEAD_GAP_S)
        with record_function(MEASURED):
            for _ in range(iters):
                if setup is not None:
                    setup()
                fn()
            torch.cuda.synchronize()
    events = prof.events()
    t0 = next(e.time_range.start for e in events if e.name == MEASURED)
    cut = t0 - LEAD_GAP_S * 1e6 / 2                    # microseconds
    return [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.time_range.start >= cut and e.name != MEASURED]


def device_ms(fn, kernels, *, setup=None, iters=20) -> float:
    """Mean device milliseconds per call of ``fn()`` spent in the named
    kernels and in fills (:func:`device_events`): the kernel's own time,
    without the host work of its wrapper.  ``setup()`` runs before each
    call; its copies are not counted.  A trace that holds none of the
    kernels is taken again, twice at most (on an H100 machine one trace of
    ten rank calls lost all their records; with one retry, phase
    ``train``'s PS-route scatter traces lost theirs twice in a row)."""
    for _ in range(3):       # a trace that lost every record, again
        us = sum(e.time_range.elapsed_us()
                 for e in device_events(fn, setup=setup, iters=iters)
                 if e.name.startswith("Memset")
                 or any(f"::{k}{c}" in e.name for k in kernels for c in "(<"))
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError(f"the profiler saw none of {kernels}, thrice")


def host_ms(fn, *, setup=None, iters=50, warmup=5) -> float:
    """Median host milliseconds to issue ``fn()``: ``time.perf_counter``
    around the call alone, with no sync inside, the device idle before it
    (a sync after ``setup()``, outside the window)."""
    import torch
    out = []
    for k in range(warmup + iters):
        if setup is not None:
            setup()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        if k >= warmup:
            out.append((t1 - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(out)


def device_ops(fn, *, iters=10) -> dict:
    """Device operations (kernels, copies, fills) per call of ``fn()`` by
    name (:func:`device_events`).  Each call launches a whole number of
    each, so a trace that holds none, or a fraction of one a call, lost
    records and is taken again, twice at most (on an H100 machine one
    trace of ten cas calls held three of their kernels); the last one is
    returned as it is."""
    for _ in range(3):
        names: dict = {}
        for e in device_events(fn, iters=iters):
            names[e.name] = names.get(e.name, 0) + 1
        if names and all(v % iters == 0 for v in names.values()):
            break
    return {k: v / iters for k, v in names.items()}


def all_device_ms(fn, *, iters=5) -> float:
    """Mean device milliseconds per call of ``fn()`` over every device
    operation it issues (:func:`device_events`): a library call's kernels,
    whatever their names.  A trace that holds none is taken again, twice
    at most."""
    for _ in range(3):
        us = sum(e.time_range.elapsed_us()
                 for e in device_events(fn, iters=iters))
        if us > 0:
            return us / 1e3 / iters
    raise AssertionError("the profiler saw no device operation, thrice")


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def ex2_ms(scores: int) -> float:
    """The softmax's exponentials alone: one ex2 a score at 16 a clock an
    SM (the MUFU's rate), the clock the bf16 peak's (4096 FLOP a clock an
    SM).  Beside a flash row's bound, not in it."""
    return scores / (BF16_FLOP_PER_S * 16 / 4096) * 1e3


def launches_since(before: dict) -> dict:
    """Kernel launches since ``before`` (an ``ops.launch_counts()``), for
    a comparison that counts on no path and must not reset the counts."""
    from repro_torch.kernels import ops
    return {k: v - before[k] for k, v in ops.launch_counts().items()}


def _count_f32(entry: str, wrapper: str, before: dict):
    """Add the launches of an f32 witness or gradient check (every launch
    of ``wrapper`` since ``before`` is its f32 entry) to F32."""
    n = launches_since(before)[wrapper]
    F32[entry]["launches"] = F32[entry].get("launches", 0) + n


# -------------------------------------------------------------- phases ---

def phase_env():
    import torch
    nvcc = subprocess.run([_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_v = triton.__version__
    except ImportError:
        triton_v = None
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, triton=triton_v, python=sys.version.split()[0],
         gpu=smi(), device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())


def _nvcc():
    from repro_torch.kernels import build
    return build.nvcc()


def sass_counts(name: str, ops=("HGMMA", "UTMALDG"), fun=None) -> dict:
    """How often each instruction occurs in a built library's SASS
    (``cuobjdump -sass``); with ``fun``, only in the device functions whose
    (mangled) name holds it, every instance of a template, as cuobjdump
    lists them under "Function : <name>"."""
    from repro_torch.kernels import build
    cuobjdump = str(Path(build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    if fun is not None:
        parts = re.split(r"^\s*Function\s*:\s*(\S+)\s*$", sass, flags=re.M)
        sass = "".join(body for fn, body in zip(parts[1::2], parts[2::2])
                       if fun in fn)
        if not sass:
            raise AssertionError(f"no function {fun} in {name}'s SASS")
    return {op: len(re.findall(rf"\b{op}\b", sass)) for op in ops}


def phase_build():
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build()
    secs = time.perf_counter() - t0
    # ptxas -v: registers / shared memory / spills per kernel, and what it
    # says of setmaxnreg and wgmma
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if any(w in ln for w in ("registers", "spill",
                                             "setmaxnreg", "wgmma"))]
             for name, log in report.items()}
    # the bf16 flash body is wgmma fed by TMA, and the f32 entries run
    # their products on the tensor cores (mma.sync: HMMA), or the build
    # fails.  flash_f32 takes S = Q.K^T and P.V alike as 3 MMAs a product
    # of 8 keys x 8 columns of d (the loops unrolled): each instance needs
    # twice the HMMA of its P.V alone, or S left the tensor cores
    from repro_torch.kernels import flash_attention as fa
    flash_sass = sass_counts("flash_attention")
    # each bf16 instance on its own: wgmma fed by TMA
    bf16_sass = {f"flash_bf16<{dq}, {dv}>": sass_counts(
        "flash_attention", fun=f"flash_bf16ILi{dq}ELi{dv}E")
        for dq, dv in BF16_BODIES}
    f32_sass = {"ssd_chunk_f32": sass_counts("ssd_scan", ("HMMA",),
                                             fun="ssd_chunk_f32")}
    f32_need = {}
    for dp, bk in fa.F32_TILE_KEYS.items():
        name = f"flash_f32<{dp}>"
        f32_sass[name] = sass_counts("flash_attention", ("HMMA", "FFMA"),
                                     fun=f"flash_f32ILi{dp}E")
        f32_need[name] = 2 * 3 * (bk // 8) * (dp // 8)
    emit("build", seconds=secs, sources=list(report), ptxas=ptxas,
         flash_sass=flash_sass, bf16_sass=bf16_sass, f32_sass=f32_sass,
         f32_hmma_needed=f32_need,
         dir=str(build.BUILD_DIR.relative_to(ROOT)))
    if not all(flash_sass.values()):
        raise AssertionError(f"flash_attention's SASS lacks an instruction "
                             f"of its design: {flash_sass}")
    short = {k: c for k, c in bf16_sass.items() if not all(c.values())}
    if short:
        raise AssertionError(f"a flash_bf16 instance's SASS lacks HGMMA or "
                             f"UTMALDG: {short}")
    if not all(c["HMMA"] for c in f32_sass.values()):
        raise AssertionError(f"an f32 entry's SASS has no HMMA: {f32_sass}")
    short = {k: f32_sass[k]["HMMA"] for k, n in f32_need.items()
             if f32_sass[k]["HMMA"] < n}
    if short:
        raise AssertionError(f"flash_f32's S is not on the tensor cores: "
                             f"HMMA {short}, needed {f32_need}")


def _rand_dest(g, A, n, dev):
    import torch
    # mostly deliverable, some filtered on both sides
    return torch.randint(-2, n + 2, (A,), generator=g, device=dev,
                         dtype=torch.int32)


WIDE_WIDTHS = (2000, 2001, 2002, 5003)   # scatter_wide's rows: w + 1 is
                                         # 1, 2, 3 and 0 mod 4


def check_radix(quick: bool, stats: dict):
    """rank + scatter bit-exact against ref over the sweep, then the rank
    alone at RANK_WIDE_A requests into 8 and 64 buckets.  The wide body's
    widths (WIDE_WIDTHS: every alignment of w + 1) also take rows whose
    base is one int past a 16-byte boundary (a view at an offset)."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    sizes = (1, 1000) if quick else (1, 1000, 1 << 20)
    cases = 0
    for A, w, off in [(A, w, off) for A in sizes
                      for w in (1, 5, 261) + (WIDE_WIDTHS if A <= 1000
                                              else ())
                      for off in ((0, 1) if w in WIDE_WIDTHS else (0,))]:
        rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A * w + off,),
                             generator=g, device=dev,
                             dtype=torch.int32)[off:].view(A, w)
        mask = torch.rand((A,), generator=g, device=dev) < 0.7
        for n in (1, 8, 64):
            dest = _rand_dest(g, A, n, dev)
            inb = dest[(dest >= 0) & (dest < n)].to(torch.int64)
            most = int(torch.bincount(inb, minlength=n).max()) if \
                inb.numel() else 0
            for cap in sorted({max(most, 1), max(most // 2, 1)}):
                got = rp.rank(dest, n, cap)
                want = ref.rank(dest, n, cap)
                for x, y, what in zip(got, want, ("slot", "keep",
                                                  "overflow", "counts")):
                    if not torch.equal(x, y):
                        raise AssertionError(
                            f"radix rank {what} differs: A={A} n={n} "
                            f"cap={cap}")
                stats["rank"] = max(stats["rank"], _err(got[0], want[0]))
                for m in (None, mask):
                    kb = rp.scatter(rows, got[0], n * cap,
                                    counts=got[3], mask=m)
                    pb = ref.scatter(rows, got[0], n * cap,
                                     counts=got[3], mask=m)
                    if not torch.equal(kb, pb):
                        raise AssertionError(
                            f"radix scatter differs: A={A} n={n} "
                            f"cap={cap} w={w} offset={off} "
                            f"mask={m is not None}")
                    stats["scatter"] = max(stats["scatter"], _err(kb, pb))
                    cases += 1
                del kb, pb
        del rows
        torch.cuda.empty_cache()
    # the rank alone at RANK_WIDE_A requests: more blocks than the scan
    # over blocks has threads, in every bucket's column
    for n in (8, 64):
        dest = _rand_dest(g, RANK_WIDE_A, n, dev)
        inb = dest[(dest >= 0) & (dest < n)].to(torch.int64)
        most = int(torch.bincount(inb, minlength=n).max())
        for cap in (most, most // 2):
            got = rp.rank(dest, n, cap)
            want = ref.rank(dest, n, cap)
            for x, y, what in zip(got, want, ("slot", "keep", "overflow",
                                              "counts")):
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"radix rank {what} differs: A={RANK_WIDE_A} n={n} "
                        f"cap={cap}")
            stats["rank"] = max(stats["rank"], _err(got[0], want[0]))
            cases += 1
        del dest, inb, got, want
    torch.cuda.empty_cache()
    return cases


def _err(a, b) -> int:
    import torch
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def check_cas(quick: bool, stats: dict):
    """cas bit-exact against ref.cas (heavy conflicts, mixed and negative
    priorities, idx < 0 and >= R) and, in the cas_lock case, against the
    sequential FIFO ref.cas_lock."""
    import torch
    from repro_torch._bits import LOCK_BIT
    from repro_torch.kernels import cas_lock as ck, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    cases = 0
    for R in (1, 1000, 1_131_072):
        for A in ((1, 1000) if quick else (1, 1000, 1 << 20)):
            span = min(R, 64) + 4            # heavy conflicts near 0..span
            idx = torch.randint(-2, span, (A,), generator=g, device=dev,
                                dtype=torch.int32)
            spread = torch.randint(-2, R + 3, (A,), generator=g, device=dev,
                                   dtype=torch.int32)
            idx = torch.where(torch.rand((A,), generator=g, device=dev)
                              < 0.5, idx, spread)
            words = torch.randint(0, 4, (R,), generator=g, device=dev,
                                  dtype=torch.int32)
            exp = torch.where(
                torch.rand((A,), generator=g, device=dev) < 0.7,
                words[idx.clamp(0, R - 1).to(torch.int64)],
                torch.randint(0, 4, (A,), generator=g, device=dev,
                              dtype=torch.int32))
            new = torch.randint(-2 ** 31, 2 ** 31 - 1, (A,), generator=g,
                                device=dev, dtype=torch.int32)
            for prio in (
                    torch.randint(-3, 3, (A,), generator=g, device=dev,
                                  dtype=torch.int32),
                    torch.randint(-2 ** 31, 2 ** 31 - 1, (A,), generator=g,
                                  device=dev, dtype=torch.int32),
                    torch.arange(A, dtype=torch.int32, device=dev)):
                kw, pw = words.clone(), words.clone()
                ok_k = ck.cas(kw, idx, exp, new, prio)
                ok_p = ref.cas(pw, idx, exp, new, prio)
                if not (torch.equal(ok_k, ok_p) and torch.equal(kw, pw)):
                    raise AssertionError(f"cas differs: R={R} A={A}")
                stats["cas"] = max(stats["cas"], _err(kw, pw))
                cases += 1
            if A <= 1000 or not quick:
                # the cas_lock case: unlocked expected words, FIFO order.
                # idx == R is moved past it: there the verb's clamped
                # compare lets a request win the spare slot, where the
                # FIFO fails it (every other index agrees)
                lidx = torch.where(idx == R, R + 1, idx)
                lk = words.clone()
                ok_k = ck.cas(lk, lidx, exp, exp | LOCK_BIT,
                              torch.arange(A, dtype=torch.int32, device=dev))
                ok_f, fw = ref.cas_lock(words, lidx, exp)
                if not (torch.equal(ok_k, ok_f) and torch.equal(lk, fw)):
                    raise AssertionError(f"cas_lock case differs: R={R} "
                                         f"A={A}")
                cases += 1
    best, slot_r = ck.arbitration_scratch(1, dev)
    if best.numel() < 1_131_072:
        raise AssertionError("cas's arbitration table is not the one the "
                             "sweep used")
    if not (bool((best == -1).all()) and int(slot_r[0]) == -1):
        raise AssertionError("cas left its arbitration scratch dirty")
    return cases


def grouped_sweep(rows: int) -> tuple:
    """check_grouped's table sizes: small tables, both sides of every
    boundary of grouped_agg.plan at ``rows`` rows, and RDMA-AGG's tables
    at Fig 8b's largest G (2**26 groups, 4 chunks: 2**28 slots)."""
    from repro_torch.kernels import grouped_agg as ga
    edges = {S + k for S in ga.boundaries(rows, ga.device_info("cuda"))
             for k in (0, 1)}
    return tuple(sorted({1, 64, 2048, 4096, 1 << 26, 1 << 28} | edges))


def check_grouped(quick: bool, stats: dict):
    """grouped_sum_u32 bit-exact against ref over random u32 words (sums
    wrap), grouped_agg (f32) bit-exact on small signed integers and within
    atol 1e-3, rtol 1e-4 on uniform [0, 1) floats (the f32 atomics add in
    an order that changes from run to run), over N up to 2**27 and S over
    grouped_sweep (every path of the plan, up to 2**28 slots); uniform
    slots, and 90 % of the rows in one slot at 2048 and 2**26 slots.  The
    keys entry bit-exact against its plain version on keys with the top
    bit set in half the rows: key % G, and RDMA-AGG's phase-1 layouts
    (4 chunks, 1 and 4 owners).  Then all three on views one int past an
    allocation (no 16-byte loads) and on an odd row count, with chunks of
    an odd number of rows."""
    import torch
    from repro_torch.kernels import grouped_agg as ga, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(14)
    sizes = (1, 1000, 1 << 20) if quick else (1, 1000, 1 << 20, 1 << 27)
    cases = 0
    for N in sizes:
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                              device=dev, dtype=torch.int32)
        ints = torch.randint(-8, 9, (N,), generator=g, device=dev
                             ).to(torch.float32)
        floats = torch.rand((N,), generator=g, device=dev)
        keys = torch.randint(-2 ** 31, 2 ** 31 - 1, (N,), generator=g,
                             device=dev, dtype=torch.int32)
        for S in grouped_sweep(N):
            uni = torch.randint(0, S, (N,), generator=g, device=dev,
                                dtype=torch.int32)
            layouts = [("uniform", uni)]
            if S in (2048, 1 << 26):
                layouts.append(("skewed", torch.where(
                    torch.rand((N,), generator=g, device=dev) < 0.9, S // 2,
                    uni)))
            for skew, slot in layouts:
                where = f"N={N} S={S} {skew} ({ga.plan(S, N).path})"
                got = ga.grouped_sum_u32(slot, words, S)
                if not torch.equal(got, ref.grouped_sum_u32(slot, words, S)):
                    raise AssertionError(f"grouped_sum_u32 differs: {where}")
                got = ga.grouped_agg(slot, ints, S)
                if not torch.equal(got, ref.grouped_agg(slot, ints, S)):
                    raise AssertionError(f"grouped_agg (integers) differs: "
                                         f"{where}")
                got = ga.grouped_agg(slot, floats, S)
                want = ref.grouped_agg(slot, floats, S)
                if not torch.allclose(got, want, atol=1e-3, rtol=1e-4):
                    raise AssertionError(f"grouped_agg (floats) outside "
                                         f"atol 1e-3 rtol 1e-4: {where}")
                stats["grouped_agg"] = max(stats["grouped_agg"], float(
                    (got - want).abs().max()))
                cases += 3
            del uni, layouts
            for chunks, owners in ((1, 1), (4, 1), (4, 4)):
                if chunks * S > 1 << 28 or N % chunks:
                    continue
                got = ga.grouped_sum_u32_by_key(keys, words, S, chunks=chunks,
                                                n=owners)
                want = ref.grouped_sum_u32_by_key(keys, words, S,
                                                  chunks=chunks, n=owners)
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"grouped_sum_u32_by_key differs: N={N} G={S} "
                        f"chunks={chunks} n={owners}")
                cases += 1
            torch.cuda.empty_cache()
        del words, ints, floats, keys
        torch.cuda.empty_cache()
    # views one int past an allocation (no 16-byte loads), a row count
    # that is no multiple of 4, and chunk boundaries inside a quad of rows
    base = torch.randint(-2 ** 31, 2 ** 31 - 1, (3, 4 * 250_001 + 1),
                         generator=g, device=dev, dtype=torch.int32)
    keys, words = base[0, 1:], base[1, 1:]
    floats = torch.rand((base.shape[1],), generator=g, device=dev)[1:]
    for S in (64, 2048, 51_201, 1 << 22, (1 << 22) + 1, 1 << 26):
        for N, view in ((keys.shape[0], True), (keys.shape[0] - 1, True),
                        (keys.shape[0] - 1, False)):
            slot = (keys[:N] & 0x7FFFFFFF) % S
            w, f = ((words[:N], floats[:N]) if view
                    else (words[:N].clone(), floats[:N].clone()))
            where = (f"N={N} S={S} {'view' if view else 'aligned'} "
                     f"({ga.plan(S, N).path})")
            if not torch.equal(ga.grouped_sum_u32(slot, w, S),
                               ref.grouped_sum_u32(slot, w, S)):
                raise AssertionError(f"grouped_sum_u32 differs: {where}")
            if not torch.allclose(ga.grouped_agg(slot, f, S),
                                  ref.grouped_agg(slot, f, S),
                                  atol=1e-3, rtol=1e-4):
                raise AssertionError(f"grouped_agg outside atol 1e-3 rtol "
                                     f"1e-4: {where}")
            cases += 2
        for chunks, owners in ((1, 1), (4, 1), (4, 4)):
            got = ga.grouped_sum_u32_by_key(keys, words, S, chunks=chunks,
                                            n=owners)
            if not torch.equal(got, ref.grouped_sum_u32_by_key(
                    keys, words, S, chunks=chunks, n=owners)):
                raise AssertionError(
                    f"grouped_sum_u32_by_key differs: misaligned N="
                    f"{keys.shape[0]} G={S} chunks={chunks} n={owners}")
            cases += 1
    del base, keys, words, floats
    # a slot outside [0, S) is skipped, never written
    slot = torch.tensor([-1, 0, 5, 1], dtype=torch.int32, device=dev)
    one = torch.ones(4, dtype=torch.int32, device=dev)
    for path in ("shared", "global", "partition"):
        p = ga.plan(2, 4, ga.device_info(dev), path=path)
        if ga.grouped_sum_u32(slot, one, 2, plan=p).tolist() != [1, 1]:
            raise AssertionError(f"grouped_sum_u32 ({path}) wrote an "
                                 "out-of-range slot")
    return cases + 3


def check_radix_join(quick: bool, stats: dict):
    """rank + scatter bit-exact against ref at a join's route: A requests
    (10 % filtered), one shard, cap = 2A, rows of (key, value)."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    A = OLAP_QUICK_N if quick else OLAP_N
    dest = (torch.rand((A,), generator=g, device=dev) < 0.1).to(torch.int32)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, 2), generator=g,
                         device=dev, dtype=torch.int32)
    got = rp.rank(dest, 1, 2 * A)
    for x, y, what in zip(got, ref.rank(dest, 1, 2 * A),
                          ("slot", "keep", "overflow", "counts")):
        if not torch.equal(x, y):
            raise AssertionError(f"radix rank {what} differs at A={A}")
    kb = rp.scatter(rows, got[0], 2 * A, counts=got[3])
    if not torch.equal(kb, ref.scatter(rows, got[0], 2 * A, counts=got[3])):
        raise AssertionError(f"radix scatter differs at A={A}")
    del kb
    torch.cuda.empty_cache()
    return A


def grouped_olap_slots() -> tuple:
    """The table sizes the OLAP path gives grouped_agg: Fig 8b's kernel
    row (2048), and for each G of the sweep Dist-AGG's G slots and
    RDMA-AGG's 4G (4 chunks, one owner)."""
    from repro_torch.bench import fig8b_agg
    return tuple(sorted({fig8b_agg.KERNEL_SLOTS}
                        | {G for G in fig8b_agg.GROUPS}
                        | {4 * G for G in fig8b_agg.GROUPS}))


def time_grouped(quick: bool, record: dict) -> dict:
    """The grouped_agg entries at every table size of the OLAP path
    (grouped_olap_slots): N rows of Fig 8b's table (keys uniform in [0,
    2**30), unit values), the f32 and u32 slot entries on ``key % S`` and
    the keys entry in the layout the path calls at that S (Dist-AGG: G
    slots; RDMA-AGG: 4 chunks of G); and the skewed case (90 % of the rows
    in one slot) at 2**26.  Each: per call (CUDA events), device time
    (profiler), host issue, the bytes bound (8N + 4S) and index_add_.
    The JSON record takes the f32 entry at 2048 slots and the u32 entry
    at 2**26."""
    import torch
    from repro_torch.bench import fig8b_agg
    from repro_torch.kernels import grouped_agg as ga, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(16)
    N = OLAP_QUICK_N if quick else OLAP_N
    keys = torch.randint(0, 1 << 30, (N,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = {"f32": torch.ones((N,), dtype=torch.float32, device=dev),
            "u32": torch.ones((N,), dtype=torch.int32, device=dev)}
    groups = set(fig8b_agg.GROUPS)
    out = {}
    cases = [(S, False) for S in grouped_olap_slots()] + [(1 << 26, True)]
    for S, skew in cases:
        k = keys
        if skew:
            hot = torch.rand((N,), generator=g, device=dev) < 0.9
            k = torch.where(hot, torch.full_like(keys, S // 2), keys)
        slot = (k % S).to(torch.int32)
        calls = {"grouped_agg": ("f32", lambda: ga.grouped_agg(
                     slot, vals["f32"], S), lambda: ref.grouped_agg(
                     slot, vals["f32"], S)),
                 "grouped_sum_u32": ("u32", lambda: ga.grouped_sum_u32(
                     slot, vals["u32"], S), lambda: ref.grouped_sum_u32(
                     slot, vals["u32"], S))}
        if S in groups or skew:
            calls["grouped_sum_u32_by_key"] = (
                "u32", lambda: ga.grouped_sum_u32_by_key(k, vals["u32"], S),
                None)
        if S % 4 == 0 and S // 4 in groups and not skew:
            calls["grouped_sum_u32_by_key/4_chunks"] = (
                "u32", lambda: ga.grouped_sum_u32_by_key(
                    k, vals["u32"], S // 4, chunks=4), None)
        for name, (ent, kern, plain) in calls.items():
            v = vals[ent]
            lib = torch.zeros((S,), dtype=v.dtype, device=dev)
            t = {"ms": time_ms(kern),
                 "device_ms": device_ms(kern, ga.KERNELS[ent]),
                 "host_ms": host_ms(kern),
                 "bound_ms": bound_ms(8 * N + 4 * S), "bound_by": "bytes",
                 "library_ms": time_ms(
                     lambda: lib.zero_().index_add_(0, slot, v), iters=5),
                 "path": ga.plan(S, N, ga.device_info(dev)).path,
                 "shape": {"N": N, "S": S, "skewed": skew}}
            if (name, S) in (("grouped_agg", 2048),
                             ("grouped_sum_u32", 1 << 26)) and not skew:
                t["plain_ms"] = time_ms(plain, iters=5)
                record[name].update(t)
            out[f"{name}@S={S}{'/skewed' if skew else ''}"] = t
            del lib
        del slot, k
        torch.cuda.empty_cache()
    return out


def time_radix_join(quick: bool) -> dict:
    """rank and scatter at a join's route (A rows of (key, value), one
    shard, cap = 2A), beside their plain versions and index_copy_."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    A = OLAP_QUICK_N if quick else OLAP_N
    dest = torch.zeros((A,), dtype=torch.int32, device=dev)
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, 2), generator=g,
                         device=dev, dtype=torch.int32)
    out = {"radix_partition_rank@join": {
        "ms": time_ms(lambda: rp.rank(dest, 1, 2 * A), iters=5),
        "device_ms": device_ms(lambda: rp.rank(dest, 1, 2 * A),
                               rp.KERNELS["rank"], iters=5),
        "scan_device_ms": device_ms(lambda: rp.rank(dest, 1, 2 * A),
                                    ("scan_kernel",), iters=5),
        "host_ms": host_ms(lambda: rp.rank(dest, 1, 2 * A), iters=10),
        "plain_ms": time_ms(lambda: ref.rank(dest, 1, 2 * A), iters=5),
        "bound_ms": bound_ms(4 * A + 4 * A + 2 * A + 4), "bound_by": "bytes",
        "library_ms": None, "shape": {"A": A, "n": 1, "cap": 2 * A}}}
    slot, _, _, counts = rp.rank(dest, 1, 2 * A)
    wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                       device=dev)], 1)
    buf = torch.zeros((2 * A, 3), dtype=torch.int32, device=dev)
    kslot = slot.to(torch.int64)

    def kern():
        return rp.scatter(rows, slot, 2 * A, counts=counts)
    t = out["radix_partition_scatter@join"] = {
        "ms": time_ms(kern, iters=5),
        "device_ms": device_ms(kern, rp.KERNELS["scatter"], iters=5),
        "host_ms": host_ms(kern, iters=10),
        "plain_ms": time_ms(lambda: ref.scatter(rows, slot, 2 * A,
                                                counts=counts), iters=5),
        "bound_ms": bound_ms(A * 8 + A * 4 + 2 * A * 3 * 4),
        "bound_by": "bytes",
        "library_ms": time_ms(lambda: buf.index_copy_(0, kslot, wide),
                              iters=5),
        "shape": {"A": A, "w": 2, "slots": 2 * A}}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    del rows, wide, buf, kslot, slot
    torch.cuda.empty_cache()
    return out


def time_hash_join(quick: bool) -> dict:
    """The local join (``ops.join_sum``) at a join's shape: R and S of A
    rows (the benchmark's draw at sel 0.5) routed as RRJ routes them (one
    shard, cap 2A, 4 chunks): 2A slots a relation, half of them empty.
    The kernel, checked against the plain sort-probe, per call, on the
    device by pass, its host time to launch, and the bound: the four
    routed int32 columns read once."""
    import torch
    from repro_torch.core import shuffle
    from repro_torch.fabric import LocalTransport
    from repro_torch.kernels import hash_join as hj, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    A = OLAP_QUICK_N if quick else OLAP_N
    rk = (torch.randperm(A, generator=g, device=dev) + 1).to(torch.int32)
    sk = torch.where(torch.rand(A, generator=g, device=dev) < 0.5,
                     torch.randint(1, A + 1, (A,), generator=g, device=dev,
                                   dtype=torch.int32),
                     torch.randint(A + 1, 2 * A, (A,), generator=g,
                                   device=dev, dtype=torch.int32))
    ones = torch.ones((A,), dtype=torch.int32, device=dev)
    tr = LocalTransport(device=dev)
    r = shuffle._route_by_key(tr, rk, rk, 2 * A, chunks=4)[:2]
    s = shuffle._route_by_key(tr, sk, ones, 2 * A, chunks=4)[:2]
    del rk, sk, ones
    torch.cuda.empty_cache()
    args = (*r, *s)
    got = hj.join_sum(*args)
    want = ref.join_sum(*args)
    if not torch.equal(got, want):
        raise AssertionError(f"hash_join at A={A}: {int(got)} against the "
                             f"plain {int(want)}")
    p = hj.plan(2 * A)
    by_pass = {k: device_ms(lambda: hj.join_sum(*args), (k,), iters=5)
               for k in hj.KERNELS["hash_join"]}
    t = {"ms": time_ms(lambda: hj.join_sum(*args), iters=10),
         "device_ms": device_ms(lambda: hj.join_sum(*args),
                                hj.KERNELS["hash_join"], iters=5),
         "device_ms_by_kernel": by_pass,
         "host_ms": host_ms(lambda: hj.join_sum(*args), iters=20),
         "plain_ms": time_ms(lambda: ref.join_sum(*args), iters=3,
                             warmup=1),
         "bound_ms": bound_ms(4 * 2 * A * 4), "bound_by": "bytes",
         "library_ms": None,
         "shape": {"A": A, "slots": 2 * A, "parts": p.parts,
                   "passes": 2 if p.lo_bits else 1, "table": p.table},
         "peak_bytes": torch.cuda.max_memory_allocated(), "gpu": smi()}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    del args, r, s
    torch.cuda.empty_cache()
    return {"hash_join@join": t}


def time_kernels(record: dict):
    """Each kernel at the main path's shapes: a commit wave of T=4096
    checkouts (A = T*W requests, one shard) on the 1 131 072-record
    table, install rows of 259 lanes."""
    import torch
    from repro_torch._bits import LOCK_BIT
    from repro_torch.bench.checkout import (PAYLOAD_WORDS, PRODUCTS, W_INSERT,
                                            W_READ)
    from repro_torch.kernels import cas_lock as ck, radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    W = W_READ + W_INSERT
    A = MAIN_T * W
    R = PRODUCTS + MAIN_WAVES * MAIN_T * W_INSERT
    n, cap = 1, A

    dest = torch.zeros((A,), dtype=torch.int32, device=dev)
    record["radix_partition_rank"].update(
        ms=time_ms(lambda: rp.rank(dest, n, cap)),
        device_ms=device_ms(lambda: rp.rank(dest, n, cap),
                            rp.KERNELS["rank"]),
        scan_device_ms=device_ms(lambda: rp.rank(dest, n, cap),
                                 ("scan_kernel",)),
        host_ms=host_ms(lambda: rp.rank(dest, n, cap)),
        plain_ms=time_ms(lambda: ref.rank(dest, n, cap)),
        bound_ms=bound_ms(A * 4 + A * 4 + 2 * A + n * 4),
        bound_by="bytes", library_ms=None,
        shape={"A": A, "n": n, "cap": cap})

    w = PAYLOAD_WORDS + 3                      # install: rec, val, npay, do_pay
    rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                         device=dev, dtype=torch.int32)
    slot, _, _, counts = rp.rank(dest, n, cap)
    mask = torch.rand((A,), generator=g, device=dev) < 0.9
    kept = int(mask.sum())
    wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                       device=dev)], 1)
    sel = mask.nonzero()[:, 0]
    kslot, krows = slot[sel].to(torch.int64), wide[sel]
    buf = torch.zeros((n * cap, w + 1), dtype=torch.int32, device=dev)

    def scatter():
        return rp.scatter(rows, slot, n * cap, counts=counts, mask=mask)

    def lib_copy():
        return buf.index_copy_(0, kslot, krows)
    record["radix_partition_scatter"].update(
        ms=time_ms(scatter),
        device_ms=device_ms(scatter, rp.KERNELS["scatter"]),
        host_ms=host_ms(scatter),
        plain_ms=time_ms(lambda: ref.scatter(rows, slot, n * cap,
                                             counts=counts, mask=mask)),
        bound_ms=bound_ms(kept * w * 4 + A * 4 + A + n * cap * (w + 1) * 4),
        bound_by="bytes",
        library_ms=time_ms(lib_copy),
        library_host_ms=host_ms(lib_copy),
        shape={"A": A, "w": w, "slots": n * cap, "kept": kept})
    del rows, wide, krows, buf

    # the prepare CAS: 3 uniform product updates + 4 unborn inserts per txn
    prods = torch.randint(0, PRODUCTS, (MAIN_T, W_READ), generator=g,
                          device=dev, dtype=torch.int32)
    ins = PRODUCTS + torch.arange(MAIN_T * W_INSERT, dtype=torch.int32,
                                  device=dev).reshape(MAIN_T, W_INSERT)
    idx = torch.cat([prods, ins], 1).reshape(-1)
    words = torch.zeros((R,), dtype=torch.int32, device=dev)
    words[:PRODUCTS] = 1
    exp = torch.cat([torch.ones((MAIN_T, W_READ), dtype=torch.int32,
                                device=dev),
                     torch.zeros((MAIN_T, W_INSERT), dtype=torch.int32,
                                 device=dev)], 1).reshape(-1)
    new = exp | LOCK_BIT
    prio = torch.arange(MAIN_T, dtype=torch.int32,
                        device=dev).repeat_interleave(W)
    live = words.clone()

    def restore():
        live.copy_(words)
    ok = ck.cas(live, idx, exp, new, prio)
    winners = int(ok.sum())
    touched = int(torch.unique(idx).numel())
    key = ((prio.to(torch.int64) + 2 ** 31) << 32) | torch.arange(
        A, dtype=torch.int64, device=dev)
    best = torch.full((R,), -1, dtype=torch.int64, device=dev)
    idx64 = idx.to(torch.int64)

    def lib_call():
        best.scatter_reduce_(0, idx64, key, reduce="amin")

    def call():
        return ck.cas(live, idx, exp, new, prio)
    # one device operation a call, and no fill
    ops_per_call = device_ops(call)
    if (sum(ops_per_call.values()) != 1
            or any(k.startswith("Memset") for k in ops_per_call)):
        raise AssertionError(f"a cas call is not one device operation: "
                             f"{ops_per_call}")
    record["cas_lock"].update(
        ms=time_ms(call, setup=restore),
        device_ms=device_ms(call, ck.KERNELS["cas"], setup=restore),
        host_ms=host_ms(call, setup=restore),
        device_ops=ops_per_call,
        plain_ms=time_ms(lambda: ref.cas(live, idx, exp, new, prio),
                         setup=restore),
        bound_ms=bound_ms(A * 16 + touched * 4 + A + winners * 4),
        bound_by="bytes",
        library_ms=time_ms(lib_call, setup=lambda: best.fill_(-1)),
        library_host_ms=host_ms(lib_call, setup=lambda: best.fill_(-1)),
        shape={"R": R, "A": A, "winners": winners})


FLASH_SWEEP = (     # (B, S, T, H, KH, D, causal): tests/test_kernels.py:47-52,
    (2, 128, 128, 4, 4, 32, True),      # then ragged S/T, GQA 1/8/16 and
    (2, 256, 256, 4, 2, 32, True),      # D from 8 to 128
    (2, 128, 256, 8, 1, 64, False),
    (2, 100, 100, 8, 2, 24, True),
    (1, 77, 133, 4, 4, 40, False),
    (1, 64, 100, 4, 2, 64, True),
    (1, 65, 65, 2, 2, 8, True),
    (1, 300, 300, 32, 4, 128, True),
    (1, 200, 200, 16, 1, 128, True),
    (2, 257, 257, 32, 2, 128, True),
    (1, 2048, 2048, 4, 2, 64, True),    # long: tiles far from the start,
    (1, 2048, 2048, 8, 2, 128, True),   # f32 held at 2e-5
    (2, 200, 330, 16, 2, 128, False),   # ragged across the bf16 body's
    (1, 4096, 4096, 8, 1, 64, True),    # 128-row tiles; long at D = 64;
    (1, 191, 191, 4, 2, 64, True),      # then the persistent schedule: S
    (1, 193, 193, 4, 2, 64, True),      # either side of the 64-wide
    (1, 100, 100, 133, 7, 64, True),    # body's 192-row units, and units
    (1, 150, 150, 263, 263, 64, False),  # either side of a multiple of 132
    (1, 200, 200, 131, 131, 128, True),  # blocks (133, 263, 262, 266)
    (1, 200, 300, 133, 7, 128, False),
)
SSD_SWEEP = (       # (B, S, H, hd, N): tests/test_kernels.py:70-74, then
    (2, 64, 8, 16, 16),                 # ragged S, N = 8 and 128, and the
    (2, 128, 4, 32, 8),                 # mamba2 head (hd 64, N 128); then,
    (2, 256, 16, 16, 32),               # for the bf16 body's plans and
    (2, 100, 4, 16, 16),                # padding, hd 24 at N = 256, N =
    (1, 300, 32, 64, 128),              # 1024 (16-step chunks), and hd 20
    (2, 1000, 4, 64, 128),              # at N = 40 (bf16 only: zero-padded
    (1, 200, 4, 24, 256),               # to 24 and 64)
    (1, 130, 2, 16, 1024),
    (1, 150, 3, 20, 40),
)
MLA_SWEEP = (       # (B, S, T, H, KH, D, Dv, causal), bf16: the MLA entry
    (1, 1, 1, 16, 16, 192, 128, True),  # (192, 128) at ragged S (one row,
    (2, 127, 127, 16, 16, 192, 128, True),   # either side of a 128-row
    (1, 129, 129, 8, 2, 192, 128, True),     # tile, many tiles), with GQA,
    (1, 1000, 1000, 16, 16, 192, 128, True),  # non-causal ragged T, and
    (1, 129, 300, 8, 8, 192, 128, False),    # widths padded into it; then
    (1, 200, 200, 4, 4, 136, 72, True),      # unequal widths on the
    (1, 130, 130, 4, 2, 128, 64, True),      # (128, 128) and (64, 64)
    (1, 100, 100, 4, 4, 64, 32, True),       # bodies; last, K and V past
    (1, 1000, 1000, 128, 128, 192, 128, True),  # half the L2, so blocks
    (1, 2048, 2048, 64, 32, 128, 128, True),    # take query tiles fastest
)
CROSS_PATHS = {     # the non-causal path shapes, timed: (B, S, T, H, KH,
    "vlm_cross": (1, 8192, 1601, 64, 8, 128),        # D), bf16
    "whisper_encoder": (16, 1500, 1500, 8, 8, 64),
    "whisper_cross": (16, 448, 1500, 8, 8, 64),
}
CROSS_SWEEP = tuple(   # (B, S, T, H, KH, D, dtype), non-causal: the path
    (*p, "bf16") for p in CROSS_PATHS.values()      # shapes, then ragged S
) + tuple((1, S, T, 8, 2, D, "bf16")       # and T either side of the
          for D in (64, 128)               # 128-row tiles on both bf16
          for S in (1, 127, 129, 300)      # bodies, T < S and T > S, and
          for T in (1, 127, 129, 300)      # the f32 body at D 64 and 128
          if S != T) + (
    (2, 300, 129, 8, 2, 64, "f32"),
    (1, 129, 300, 4, 4, 128, "f32"),
    (1, 127, 1, 8, 8, 64, "f32"),
    (2, 1, 300, 4, 2, 128, "f32"),
    (1, 191, 300, 8, 2, 64, "bf16"),     # the persistent schedule: S either
    (1, 193, 129, 8, 2, 64, "bf16"),     # side of the 64-wide body's 192
    (1, 100, 300, 133, 7, 64, "bf16"),   # rows, units either side of a
    (1, 150, 150, 263, 263, 64, "bf16"),  # multiple of 132 blocks (133,
    (2, 129, 200, 131, 131, 128, "bf16"),  # 263, 524, 266)
    (1, 250, 100, 133, 19, 128, "bf16"),
)
BF16_BODIES = ((64, 64), (128, 128), (192, 128))   # flash_bf16<DQ, DV>
MLA_PATH = (1, 8192, 128, 192, 128)     # deepseek prefill: B, S, H = KH,
                                        # D (q.k), Dv
FLASH_PATH = (1, 8192, 32, 2, 128)      # glm4 prefill: B, S, H, KH, D
SSD_PATH = (8, 8192, 32, 64, 128)       # mamba2 prefill: B, S, H, hd, N


def _normal(g, shape, dtype, dev, scale=1.0):
    import torch
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)


def _nan_out(q, v):
    """An output for flash_attention's ``out=``, pre-filled with NaN: a
    query tile the kernel's schedule skips stays NaN and fails the
    check."""
    import torch
    B, S, H, _ = q.shape
    return torch.full((B, S, H, v.shape[-1]), float("nan"), dtype=q.dtype,
                      device=q.device)


def check_flash(stats: dict):
    """flash_attention against ref.flash_attention over FLASH_SWEEP in f32
    (within 2e-5) and bf16 (within 2e-2), the tolerances of
    tests/test_kernels.py:62; in bf16 also each query row's rms difference
    within ROW_TOL of its rms (2e-2 is about the size of a late row's
    values at long S, so it alone would not see a fault there).  Every
    output is pre-filled with NaN (:func:`_nan_out`)."""
    import torch
    from repro_torch.bench.serve import row_rel_err
    from repro_torch.kernels import flash_attention as fa, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    cases = 0
    for B, S, T, H, KH, D, causal in FLASH_SWEEP:
        for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
            q = _normal(g, (B, S, H, D), dtype, dev)
            k = _normal(g, (B, T, KH, D), dtype, dev)
            v = _normal(g, (B, T, KH, D), dtype, dev)
            got = fa.flash_attention(q, k, v, causal=causal,
                                     out=_nan_out(q, v)).float()
            want = ref.flash_attention(q, k, v, causal=causal).float()
            if not (torch.isfinite(got).all()
                    and torch.allclose(got, want, atol=tol, rtol=tol)):
                raise AssertionError(
                    f"flash_attention outside {tol}: B={B} S={S} T={T} H={H} "
                    f"KH={KH} D={D} causal={causal} {dtype}: max "
                    f"{float((got - want).abs().max())}")
            if dtype == torch.bfloat16:
                row = row_rel_err(got, want)
                if row > ROW_TOL:
                    raise AssertionError(
                        f"flash_attention bf16 row error {row} > {ROW_TOL}: "
                        f"B={B} S={S} T={T} H={H} KH={KH} D={D} "
                        f"causal={causal}")
                stats["flash_bf16_row"] = max(stats["flash_bf16_row"], row)
            key = "flash_f32" if dtype == torch.float32 else "flash_bf16"
            stats[key] = max(stats[key], float((got - want).abs().max()))
            cases += 1
    return cases


def check_ssd(stats: dict):
    """ssd_scan against ref.ssd_scan over SSD_SWEEP: f32 y and final state
    within 2e-3 (tests/test_kernels.py:84), with and without an initial
    state; bf16 inputs, y within 2e-2 relative (one bf16 rounding of y)
    and the f32 state within 2e-3.  Both types run every case: the
    chunked body takes N = 1..1024 in either."""
    import torch
    from repro_torch.kernels import ref, ssd_scan as sk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(19)
    cases = 0
    for B, S, H, P, N in SSD_SWEEP:
        for dtype, tol in ((torch.float32, 2e-3), (torch.bfloat16, 2e-2)):
            xh = _normal(g, (B, S, H, P), dtype, dev, 0.5)
            bv = _normal(g, (B, S, N), dtype, dev, 0.5)
            cv = _normal(g, (B, S, N), dtype, dev, 0.5)
            dt = torch.nn.functional.softplus(
                torch.randn((B, S, H), generator=g, device=dev))
            a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
            for s0 in (None, _normal(g, (B, H, P, N), torch.float32, dev)):
                y, st = sk.ssd_scan(xh, bv, cv, dt, a, s0)
                yr, str_ = ref.ssd_scan(xh, bv, cv, dt, a, s0)
                where = (f"B={B} S={S} H={H} hd={P} N={N} {dtype} "
                         f"state0={s0 is not None}")
                if not torch.allclose(y.float(), yr.float(), atol=tol,
                                      rtol=tol):
                    raise AssertionError(
                        f"ssd_scan y outside {tol}: {where}: max "
                        f"{float((y.float() - yr.float()).abs().max())}")
                if not torch.allclose(st, str_, atol=2e-3, rtol=2e-3):
                    raise AssertionError(
                        f"ssd_scan state outside 2e-3: {where}: max "
                        f"{float((st - str_).abs().max())}")
                stats["ssd"] = max(stats["ssd"], float(
                    (y.float() - yr.float()).abs().max()))
                cases += 1
    return cases


def time_flash(record: dict) -> dict:
    """flash_attention at one glm4 layer's prefill (B=1, S=8192, H=32,
    KH=2, D=128, bf16, causal), held to its plain version there, beside
    scaled_dot_product_attention (timed only: the port never calls it).
    Held within 2e-2 and, row by row, within ROW_TOL; a control, the plain
    version with one key tile dropped, must read above ROW_TOL.  Bound: the
    larger of the causal FLOPs (4 D H per unmasked pair, S(S+1)/2 pairs) at
    989 TFLOP/s and q, k, v, o once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.serve import row_rel_err
    from repro_torch.kernels import flash_attention as fa, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(20)
    B, S, H, KH, D = FLASH_PATH
    q = _normal(g, (B, S, H, D), torch.bfloat16, dev)
    k = _normal(g, (B, S, KH, D), torch.bfloat16, dev)
    v = _normal(g, (B, S, KH, D), torch.bfloat16, dev)
    got = fa.flash_attention(q, k, v).float()
    want = ref.flash_attention(q, k, v).float()
    err = float((got - want).abs().max())
    row = row_rel_err(got, want)
    control = row_rel_err(_attn_tile_dropped(q, k, v), want)
    if not torch.allclose(got, want, atol=2e-2, rtol=2e-2):
        raise AssertionError(f"flash_attention outside 2e-2 at the glm4 "
                             f"prefill shape: max {err}")
    if not row <= ROW_TOL < control:
        raise AssertionError(f"flash_attention at the glm4 prefill shape: "
                             f"row error {row}, control {control}, limit "
                             f"{ROW_TOL}")
    del got, want
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    flops = 4 * B * H * D * S * (S + 1) // 2
    nbytes = 2 * (q.numel() * 2 + k.numel() * 2)
    t = {"ms": time_ms(lambda: fa.flash_attention(q, k, v), iters=10),
         "device_ms": device_ms(lambda: fa.flash_attention(q, k, v),
                                fa.KERNELS["flash"], iters=5),
         "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v), iters=3,
                             warmup=1),
         "bound_ms": max(bound_ms(nbytes), flops / BF16_FLOP_PER_S * 1e3),
         "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                      > nbytes / HBM_BYTES_PER_S else "bytes"),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=True, enable_gqa=True), iters=10),
         "library_device_ms": all_device_ms(
             lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=True, enable_gqa=True)),
         "host_ms": host_ms(lambda: fa.flash_attention(q, k, v), iters=20),
         "ex2_ms": ex2_ms(B * H * S * (S + 1) // 2),
         "flops": flops, "bytes": nbytes, "path_max_abs_err": err,
         "path_row_err": row, "path_row_err_control": control,
         "shape": {"B": B, "S": S, "H": H, "KH": KH, "D": D,
                   "dtype": "bf16", "causal": True}}
    t["tflop_per_s"] = flops / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    record["flash_attention"].update(t)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return t


def _attn_flops(B, S, H, D, Dv) -> int:
    """Operations of causal attention: 2 (D + Dv) H per unmasked (query,
    key) pair, S (S + 1) / 2 pairs (``roofline.attention_flops``, which
    the step counter credits a flash region with)."""
    from repro_torch.launch import roofline
    return roofline.attention_flops(B, S, S, H, D, Dv, True)


def check_mla(stats: dict, record: dict) -> int:
    """The flash kernel's MLA entry (bf16, q.k width up to 192, v up to
    128): over MLA_SWEEP against ref.flash_attention within 2e-2 and each
    row within ROW_TOL, outputs pre-filled with NaN; the f32 body must
    refuse unequal widths; then at
    deepseek's layer (MLA_PATH, causal), held the same way with a
    dropped-tile control above ROW_TOL, timed beside its plain version and
    scaled_dot_product_attention on the same q, k, v (timed only: the port
    never calls it; it takes E_v != E on its non-math backends).  Bound:
    the larger of the causal operations (:func:`_attn_flops`) at 989
    TFLOP/s and q, k, v, o once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.bench.serve import row_rel_err
    from repro_torch.kernels import flash_attention as fa, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(23)
    cases = 0
    for B, S, T, H, KH, D, Dv, causal in MLA_SWEEP:
        q = _normal(g, (B, S, H, D), torch.bfloat16, dev)
        k = _normal(g, (B, T, KH, D), torch.bfloat16, dev)
        v = _normal(g, (B, T, KH, Dv), torch.bfloat16, dev)
        got = fa.flash_attention(q, k, v, causal=causal,
                                 out=_nan_out(q, v)).float()
        want = ref.flash_attention(q, k, v, causal=causal).float()
        row = row_rel_err(got, want)
        where = f"B={B} S={S} T={T} H={H} KH={KH} D={D} Dv={Dv} " \
                f"causal={causal}"
        if got.shape != (B, S, H, Dv) or not torch.isfinite(got).all() \
                or not torch.allclose(got, want, atol=2e-2, rtol=2e-2) \
                or row > ROW_TOL:
            raise AssertionError(
                f"flash MLA entry off: {where}: max "
                f"{float((got - want).abs().max())}, row {row}")
        stats["flash_mla"] = max(stats["flash_mla"],
                                 float((got - want).abs().max()))
        stats["flash_mla_row"] = max(stats["flash_mla_row"], row)
        cases += 1
    q32 = torch.zeros((1, 8, 2, 192), device=dev)
    try:
        fa.flash_attention(q32, q32, q32[..., :128])
    except ValueError:
        pass
    else:
        raise AssertionError("flash_f32 took unequal widths")
    B, S, H, D, Dv = MLA_PATH
    q = _normal(g, (B, S, H, D), torch.bfloat16, dev)
    k = _normal(g, (B, S, H, D), torch.bfloat16, dev)
    v = _normal(g, (B, S, H, Dv), torch.bfloat16, dev)
    got = fa.flash_attention(q, k, v).float()
    want = ref.flash_attention(q, k, v).float()
    err = float((got - want).abs().max())
    row = row_rel_err(got, want)
    close = torch.allclose(got, want, atol=2e-2, rtol=2e-2)
    del got
    control = row_rel_err(_attn_tile_dropped(q, k, v), want)
    del want
    if not close or not row <= ROW_TOL < control:
        raise AssertionError(f"flash MLA entry at deepseek's layer: max "
                             f"{err} (limit 2e-2), row error {row}, control "
                             f"{control}, limit {ROW_TOL}")
    stats["flash_mla"] = max(stats["flash_mla"], err)
    stats["flash_mla_row"] = max(stats["flash_mla_row"], row)
    torch.cuda.empty_cache()
    flops = _attn_flops(B, S, H, D, Dv)
    nbytes = 2 * (q.numel() + k.numel() + 2 * v.numel())
    t = {"ms": time_ms(lambda: fa.flash_attention(q, k, v), iters=10),
         "device_ms": device_ms(lambda: fa.flash_attention(q, k, v),
                                fa.KERNELS["mla"], iters=5),
         "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v), iters=2,
                             warmup=1),
         "bound_ms": max(bound_ms(nbytes), flops / BF16_FLOP_PER_S * 1e3),
         "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                      > nbytes / HBM_BYTES_PER_S else "bytes"),
         "host_ms": host_ms(lambda: fa.flash_attention(q, k, v), iters=20),
         "ex2_ms": ex2_ms(B * H * S * (S + 1) // 2),
         "flops": flops, "bytes": nbytes, "path_max_abs_err": err,
         "path_row_err": row, "path_row_err_control": control,
         "sweep_cases": cases,
         "shape": {"B": B, "S": S, "H": H, "KH": H, "D": D, "Dv": Dv,
                   "dtype": "bf16", "causal": True}}
    torch.cuda.empty_cache()
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    try:
        with sdpa_kernel(backends):
            t["library_ms"] = time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True),
                iters=10)
            t["library_device_ms"] = all_device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=True))
    except RuntimeError as e:       # a yardstick only: no fused backend
        t["library_ms"] = None      # takes these widths
        t["library_error"] = str(e)[:300]
    t["tflop_per_s"] = flops / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    record["flash_attention_mla"].update(t)
    del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return t


def check_cross(stats: dict, record: dict) -> dict:
    """flash_attention's non-causal calls: over CROSS_SWEEP against
    ref.flash_attention (bf16 within 2e-2 and each row within ROW_TOL,
    f32 within 2e-5; outputs pre-filled with NaN); at the three path
    shapes (CROSS_PATHS) also a dropped-tile control above ROW_TOL, and
    each timed beside its plain version and non-causal
    scaled_dot_product_attention (timed only: the port never calls it;
    per call and on the device), with the wrapper's host issue and the
    exponentials' time (:func:`ex2_ms`); f32 also timed at whisper's
    encoder shape (its
    f32 witness), beside f32 SDPA (:func:`_f32_flash_times`).  Bound: the
    larger of the operations, 4 B S T D H (every key of T read), at 989
    TFLOP/s and q, k, v, o once at 3.35 TB/s."""
    import torch
    import torch.nn.functional as F
    from repro_torch.bench.serve import row_rel_err
    from repro_torch.kernels import flash_attention as fa, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(25)
    dtypes = {"bf16": (torch.bfloat16, 2e-2), "f32": (torch.float32, 2e-5)}
    cases = 0
    for B, S, T, H, KH, D, dt in CROSS_SWEEP:
        dtype, tol = dtypes[dt]
        q = _normal(g, (B, S, H, D), dtype, dev)
        k = _normal(g, (B, T, KH, D), dtype, dev)
        v = _normal(g, (B, T, KH, D), dtype, dev)
        got = fa.flash_attention(q, k, v, causal=False,
                                 out=_nan_out(q, v)).float()
        want = ref.flash_attention(q, k, v, causal=False).float()
        err = float((got - want).abs().max())
        row = row_rel_err(got, want) if dt == "bf16" else 0.0
        where = f"B={B} S={S} T={T} H={H} KH={KH} D={D} {dt}"
        if not torch.isfinite(got).all() \
                or not torch.allclose(got, want, atol=tol, rtol=tol) \
                or row > ROW_TOL:
            raise AssertionError(f"flash non-causal off: {where}: max "
                                 f"{err} (limit {tol}), row {row}")
        key = f"flash_noncausal_{dt}"
        stats[key] = max(stats[key], err)
        stats["flash_noncausal_row"] = max(stats["flash_noncausal_row"],
                                           row)
        cases += 1
        del got, want, q, k, v
    torch.cuda.empty_cache()
    timing = {}
    for name, (B, S, T, H, KH, D) in CROSS_PATHS.items():
        q = _normal(g, (B, S, H, D), torch.bfloat16, dev)
        k = _normal(g, (B, T, KH, D), torch.bfloat16, dev)
        v = _normal(g, (B, T, KH, D), torch.bfloat16, dev)
        got = fa.flash_attention(q, k, v, causal=False).float()
        want = ref.flash_attention(q, k, v, causal=False).float()
        err = float((got - want).abs().max())
        row = row_rel_err(got, want)
        del got
        control = row_rel_err(_attn_tile_dropped(q, k, v, causal=False),
                              want)
        del want
        if not row <= ROW_TOL < control:
            raise AssertionError(f"flash non-causal at {name}: row error "
                                 f"{row}, control {control}, limit "
                                 f"{ROW_TOL}")
        flops = 4 * B * S * T * D * H
        nbytes = 2 * (2 * q.numel() + 2 * k.numel())
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        t = {"ms": time_ms(lambda: fa.flash_attention(q, k, v,
                                                      causal=False),
                           iters=10),
             "device_ms": device_ms(lambda: fa.flash_attention(
                 q, k, v, causal=False), fa.KERNELS["flash_noncausal"],
                 iters=5),
             "plain_ms": time_ms(lambda: ref.flash_attention(
                 q, k, v, causal=False), iters=3, warmup=1),
             "bound_ms": max(bound_ms(nbytes),
                             flops / BF16_FLOP_PER_S * 1e3),
             "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                          > nbytes / HBM_BYTES_PER_S else "bytes"),
             "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=False, enable_gqa=H != KH),
                 iters=10),
             "library_device_ms": all_device_ms(
                 lambda: F.scaled_dot_product_attention(
                     qt, kt, vt, is_causal=False, enable_gqa=H != KH)),
             "host_ms": host_ms(lambda: fa.flash_attention(
                 q, k, v, causal=False), iters=20),
             "ex2_ms": ex2_ms(B * H * S * T),
             "flops": flops, "bytes": nbytes, "path_max_abs_err": err,
             "path_row_err": row, "path_row_err_control": control,
             "shape": {"B": B, "S": S, "T": T, "H": H, "KH": KH, "D": D,
                       "dtype": "bf16", "causal": False}}
        t["tflop_per_s"] = flops / t["ms"] / 1e9
        t["bound_share"] = t["bound_ms"] / t["ms"]
        timing[name] = t
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    main = timing["vlm_cross"]
    record["flash_attention_noncausal"].update(
        {k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms", "shape")},
        max_abs_err=max(stats["flash_noncausal_bf16"],
                        stats["flash_noncausal_f32"]))
    B, S, T, H, KH, D = CROSS_PATHS["whisper_encoder"]
    q = _normal(g, (B, S, H, D), torch.float32, dev)
    k = _normal(g, (B, T, KH, D), torch.float32, dev)
    v = _normal(g, (B, T, KH, D), torch.float32, dev)
    F32["flash_f32_noncausal"].update(_f32_flash_times(q, k, v, False))
    del q, k, v
    torch.cuda.empty_cache()
    timing["sweep_cases"] = cases
    return timing


def _f32_flash_times(q, k, v, causal: bool) -> dict:
    """flash_f32 on f32 q, k, v (B, S, H, D) / (B, T, KH, D): held within
    2e-5 of its plain version, timed beside it and beside SDPA on the same
    inputs.  Bound: the larger of the bytes and both products as three TF32
    products at 495 TFLOP/s (the f32-accurate work the card can do);
    beside it ``bound_fma_ms`` (both products at 67 TFLOP/s, the earlier
    FMA body's bound)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa, ref
    B, S, H, D = q.shape
    T, KH = k.shape[1], k.shape[2]
    err = float((fa.flash_attention(q, k, v, causal=causal)
                 - ref.flash_attention(q, k, v, causal=causal)).abs().max())
    if not err <= 2e-5:
        raise AssertionError(f"flash_f32 off at B={B} S={S} T={T} H={H} "
                             f"KH={KH} D={D} causal={causal}: max {err}")
    flops = (4 * B * H * D * S * (S + 1) // 2 if causal
             else 4 * B * S * T * D * H)
    nbytes = 4 * (2 * q.numel() + 2 * k.numel())
    ops_s = 3 * flops / TF32_FLOP_PER_S           # three TF32 passes
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    kernels = fa.KERNELS["flash" if causal else "flash_noncausal"]
    t = {"ms": time_ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                       iters=10),
         "device_ms": device_ms(lambda: fa.flash_attention(
             q, k, v, causal=causal), kernels, iters=5),
         "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v,
                                                         causal=causal),
                             iters=3, warmup=1),
         "bound_ms": max(bound_ms(nbytes), ops_s * 1e3),
         "bound_by": ("operations" if ops_s > nbytes / HBM_BYTES_PER_S
                      else "bytes"),
         "bound_fma_ms": max(bound_ms(nbytes),
                             flops / F32_FLOP_PER_S * 1e3),
         "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
             qt, kt, vt, is_causal=causal, enable_gqa=H != KH), iters=5),
         "library_device_ms": all_device_ms(
             lambda: F.scaled_dot_product_attention(
                 qt, kt, vt, is_causal=causal, enable_gqa=H != KH),
             iters=3),
         "host_ms": host_ms(lambda: fa.flash_attention(q, k, v,
                                                       causal=causal),
                            iters=20),
         "max_abs_err": err, "flops": flops, "bytes": nbytes,
         "shape": {"B": B, "S": S, "T": T, "H": H, "KH": KH, "D": D,
                   "dtype": "f32", "causal": causal}}
    t["tflop_per_s"] = flops / t["ms"] / 1e9
    t["bound_share"] = t["bound_ms"] / t["ms"]
    return t


def time_f32_entries() -> dict:
    """The f32 entries of flash_attention (``flash_f32``: S and P.V by
    3xTF32 products on mma.sync) and ssd_scan (``ssd_chunk_f32``: the
    chunked SSD on mma.sync, x, B and C split into bf16 parts) at the
    shapes of the f32 full-depth witnesses (FLASH_PATH and SSD_PATH in
    f32: glm4-9b's and mamba2-370m's prefill), held to their plain
    versions within the sweeps' f32 tolerances (2e-5; y and state 2e-3),
    timed beside them and, for flash_f32, beside SDPA on the same f32
    inputs (no one PyTorch call computes the SSD scan).  Bounds: flash_f32 :func:`_f32_flash_times`;
    the SSD the larger of its bytes at 3.35 TB/s and its split products
    (three MMAs a product of the chunked form at the kernel's chunk) at 989
    TFLOP/s, with the recurrence's FMA bound (4 B S H hd N at 67 TFLOP/s)
    beside it as ``bound_recurrence_ms``."""
    import torch
    from repro_torch.kernels import ref, ssd_scan as sk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(22)
    B, S, H, KH, D = FLASH_PATH
    q = _normal(g, (B, S, H, D), torch.float32, dev)
    k = _normal(g, (B, S, KH, D), torch.float32, dev)
    v = _normal(g, (B, S, KH, D), torch.float32, dev)
    F32["flash_f32"].update(_f32_flash_times(q, k, v, True))
    del q, k, v
    torch.cuda.empty_cache()
    B, S, H, P, N = SSD_PATH
    xh = _normal(g, (B, S, H, P), torch.float32, dev, 0.5)
    bv = _normal(g, (B, S, N), torch.float32, dev, 0.5)
    cv = _normal(g, (B, S, N), torch.float32, dev, 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    y, st = sk.ssd_scan(xh, bv, cv, dt, a)
    yr, sr = ref.ssd_scan(xh, bv, cv, dt, a)
    err = float((y - yr).abs().max())
    serr = float((st - sr).abs().max())
    if not (torch.allclose(y, yr, atol=2e-3, rtol=2e-3)
            and torch.allclose(st, sr, atol=2e-3, rtol=2e-3)):
        raise AssertionError(f"ssd_chunk_f32 off at the mamba2 witness "
                             f"shape: y {err}, state {serr}")
    del y, st, yr, sr
    plan = sk.chunk_plan(P, N, dtype=torch.float32)
    split_flops = 3 * ssd_chunked_flops(B, S, H, P, N, plan["L"])
    nbytes = 4 * (2 * xh.numel() + 2 * bv.numel() + dt.numel() + H
                  + B * H * P * N)
    F32["ssd_chunk_f32"].update(
        ms=time_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a), iters=10),
        device_ms=device_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a),
                            sk.KERNELS["ssd"], iters=5),
        plain_ms=time_ms(lambda: ref.ssd_scan(xh, bv, cv, dt, a), iters=3,
                         warmup=1),
        bound_ms=max(bound_ms(nbytes), split_flops / BF16_FLOP_PER_S * 1e3),
        bound_by=("operations"
                  if split_flops / BF16_FLOP_PER_S > nbytes / HBM_BYTES_PER_S
                  else "bytes"),
        bound_recurrence_ms=max(bound_ms(nbytes), 4 * B * S * H * P * N
                                / F32_FLOP_PER_S * 1e3),
        library_ms=None, max_abs_err=err, state_max_abs_err=serr,
        split_flops=split_flops, bytes=nbytes, plan=plan,
        shape={"B": B, "S": S, "H": H, "hd": P, "N": N, "dtype": "f32"})
    F32["ssd_chunk_f32"]["bound_share"] = (F32["ssd_chunk_f32"]["bound_ms"]
                                           / F32["ssd_chunk_f32"]["ms"])
    del xh, bv, cv, dt
    torch.cuda.empty_cache()
    return F32


def ssd_chunked_flops(B, S, H, P, N, L=256) -> int:
    """Operations of the chunked SSD at chunk L (the JAX model's form):
    per chunk C B^T (2 L^2 N), and per head the causal intra-chunk product
    (L(L+1) P), the inter-chunk read of the state and its update
    (2 L N P each): ``roofline.ssd_flops``."""
    from repro_torch.launch import roofline
    return roofline.ssd_flops(B, S, H, P, N, L)


def time_ssd(record: dict) -> dict:
    """ssd_scan at one mamba2 layer's prefill (B=8, S=8192, H=32, hd=64,
    N=128, bf16 x/B/C, f32 dt and state), held to its plain version
    there.  Bound: the larger of its bytes (each input read once, y and
    the final state written once) at 3.35 TB/s and the chunked form's
    operations at 989 TFLOP/s.  No single PyTorch call computes it."""
    import torch
    from repro_torch.kernels import ref, ssd_scan as sk
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(21)
    B, S, H, P, N = SSD_PATH
    xh = _normal(g, (B, S, H, P), torch.bfloat16, dev, 0.5)
    bv = _normal(g, (B, S, N), torch.bfloat16, dev, 0.5)
    cv = _normal(g, (B, S, N), torch.bfloat16, dev, 0.5)
    dt = torch.nn.functional.softplus(
        torch.randn((B, S, H), generator=g, device=dev))
    a = -torch.exp(torch.randn((H,), generator=g, device=dev) * 0.3)
    y, st = sk.ssd_scan(xh, bv, cv, dt, a)
    yr, sr = ref.ssd_scan(xh, bv, cv, dt, a)
    err = float((y.float() - yr.float()).abs().max())
    serr = float((st - sr).abs().max())
    if not (torch.allclose(y.float(), yr.float(), atol=2e-2, rtol=2e-2)
            and torch.allclose(st, sr, atol=2e-3, rtol=2e-3)):
        raise AssertionError(f"ssd_scan off at the mamba2 prefill shape: y "
                             f"{err}, state {serr}")
    del y, st, yr, sr
    nbytes = (2 * xh.numel() * 2 + 2 * bv.numel() * 2 + dt.numel() * 4
              + H * 4 + B * H * P * N * 4)
    flops = ssd_chunked_flops(B, S, H, P, N)
    t = {"ms": time_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a), iters=10),
         "device_ms": device_ms(lambda: sk.ssd_scan(xh, bv, cv, dt, a),
                                sk.KERNELS["ssd"], iters=5),
         "plain_ms": time_ms(lambda: ref.ssd_scan(xh, bv, cv, dt, a),
                             iters=3, warmup=1),
         "bound_ms": max(bound_ms(nbytes), flops / BF16_FLOP_PER_S * 1e3),
         "bound_by": ("operations" if flops / BF16_FLOP_PER_S
                      > nbytes / HBM_BYTES_PER_S else "bytes"),
         "library_ms": None, "flops_chunked": flops,
         "flops_recurrence": 4 * B * S * H * P * N, "bytes": nbytes,
         "path_max_abs_err": err, "path_state_max_abs_err": serr,
         "plan": sk.chunk_plan(P, N),
         "shape": {"B": B, "S": S, "H": H, "hd": P, "N": N}}
    t["bound_share"] = t["bound_ms"] / t["ms"]
    record["ssd_scan"].update(t)
    del xh, bv, cv, dt
    torch.cuda.empty_cache()
    return t


PARENT = {"dir": None, "lib": None}   # --parent, and its flash library


def parent_lib():
    """The --parent tree's flash library, built on first use (None without
    --parent).  Its C entry takes the same arguments as this tree's."""
    if PARENT["dir"] is not None and PARENT["lib"] is None:
        from repro_torch.bench import flash_sched
        PARENT["lib"] = flash_sched.build_parent(PARENT["dir"])._lib
    return PARENT["lib"]


def prefill_turns(cfg, params, batch: int, seq: int):
    """With --parent: the prefill step with this tree's flash kernel and
    with the parent's (the wrapper's library swapped), in turns (this,
    parent, parent, this), each turn a warm-up and 2 steps between syncs;
    the median of each.  Outside every path's counts.  None without
    --parent."""
    lib = parent_lib()
    if lib is None:
        return None
    import torch
    from repro_torch.bench import serve
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.train.train_step import build_prefill_step
    dev = params["embed"].device
    step = build_prefill_step(cfg)
    batch_in = {"tokens": serve.prompt(cfg, batch, seq, dev),
                "modality": serve.modality(cfg, batch, dev)}
    libs = {"this": fa._load(), "parent": lib}
    times = {"this": [], "parent": []}
    try:
        for m in ("this", "parent", "parent", "this"):
            fa._lib = libs[m]
            step(params, batch_in)
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(params, batch_in)
                torch.cuda.synchronize()
                times[m].append(time.perf_counter() - t0)
    finally:
        fa._lib = libs["this"]
    out = {f"{m}_s": statistics.median(v) for m, v in times.items()}
    out["ratio"] = out["this_s"] / out["parent_s"]
    return dict(out, times_s=times)


def time_parent_flash(parent: str) -> dict:
    """The flash kernel of an earlier tree (``--parent``: an unpacked
    ``git archive`` of it), built from its source and run through its own
    wrapper (:func:`repro_torch.bench.flash_sched.build_parent`), beside
    this tree's at the five path rows of ``flash_sched.ROWS``, in turns
    (parent, this, this, parent): per call, device and host issue, the
    median of each, and this tree's over the parent's."""
    import torch
    from repro_torch.bench import flash_sched
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    old = flash_sched.build_parent(parent)
    built = time.perf_counter() - t0
    PARENT["lib"] = old._lib
    rows = {}
    for i, (name, row) in enumerate(flash_sched.ROWS.items()):
        q, k, v, causal = flash_sched.inputs(row, 60 + i)
        fns = {"parent": lambda: old.flash_attention(q, k, v,
                                                     causal=causal),
               "this": lambda: fa.flash_attention(q, k, v, causal=causal)}
        turns = {"parent": [], "this": []}
        for m in ("parent", "this", "this", "parent"):
            turns[m].append({
                "ms": time_ms(fns[m], iters=10),
                "device_ms": device_ms(fns[m], ("flash_bf16",), iters=5),
                "host_ms": host_ms(fns[m], iters=20)})
        med = {m: {key: statistics.median(t[key] for t in ts)
                   for key in ("ms", "device_ms", "host_ms")}
               for m, ts in turns.items()}
        rows[name] = {**med, "turns": turns,
                      "ratio_ms": med["this"]["ms"] / med["parent"]["ms"],
                      "ratio_device_ms": med["this"]["device_ms"]
                      / med["parent"]["device_ms"]}
        del q, k, v
        torch.cuda.empty_cache()
    emit("flash_parent", parent=parent, build_s=built, rows=rows, gpu=smi())
    return rows


def phase_kernels(quick: bool, record: dict):
    emit("kernels", names=["radix_partition", "cas_lock", "grouped_agg",
                           "flash_attention", "ssd_scan"])
    err = {"rank": 0, "scatter": 0, "cas": 0, "grouped_agg": 0.0,
           "flash_f32": 0.0, "flash_bf16": 0.0, "flash_bf16_row": 0.0,
           "flash_mla": 0.0, "flash_mla_row": 0.0,
           "flash_noncausal_bf16": 0.0, "flash_noncausal_f32": 0.0,
           "flash_noncausal_row": 0.0, "ssd": 0.0}
    t0 = time.perf_counter()
    nf = check_flash(err)
    mla = check_mla(err, record)
    cross = check_cross(err, record)
    ns = check_ssd(err)
    nr = check_radix(quick, err)
    nc = check_cas(quick, err)
    ng = check_grouped(quick, err)
    join_a = check_radix_join(quick, err)
    record["radix_partition_rank"]["max_abs_err"] = err["rank"]
    record["radix_partition_scatter"]["max_abs_err"] = err["scatter"]
    record["cas_lock"]["max_abs_err"] = err["cas"]
    record["grouped_agg"]["max_abs_err"] = err["grouped_agg"]
    record["grouped_sum_u32"]["max_abs_err"] = 0
    record["flash_attention_mla"]["max_abs_err"] = err["flash_mla"]
    record["flash_attention"]["max_abs_err"] = max(err["flash_f32"],
                                                   err["flash_bf16"])
    record["ssd_scan"]["max_abs_err"] = err["ssd"]
    timing = {"flash_attention": time_flash(record),
              "flash_attention_mla": mla,
              "flash_attention_noncausal": cross,
              "ssd_scan": time_ssd(record),
              "f32_entries": time_f32_entries()}
    if PARENT["dir"] is not None:
        timing["flash_parent"] = time_parent_flash(PARENT["dir"])
    time_kernels(record)
    timing.update({k: {kk: v for kk, v in record[k].items() if kk not in (
        "source", "replaces", "route", "launches", "paths", "max_abs_err")}
        for k in OLTP_KERNELS})
    timing.update(time_grouped(quick, record))
    timing.update(time_radix_join(quick))
    timing.update(time_hash_join(quick))
    emit("kernels_checked", flash_cases=nf,
         flash_mla_cases=mla["sweep_cases"],
         flash_noncausal_cases=cross["sweep_cases"], ssd_cases=ns,
         radix_cases=nr,
         cas_cases=nc, grouped_agg_cases=ng, radix_join_A=join_a,
         max_abs_err=err, seconds=time.perf_counter() - t0, gpu=smi(),
         timing=timing)


# ----------------------------------------------------------- main path --

def _count(names, launches: dict, record: dict, path: str):
    """Add a path's launches to the record; fail if it launched none of
    a kernel it runs, or a kernel it does not run."""
    for name in names:
        record[name]["launches"] += launches[name]
        if launches[name] == 0:
            raise AssertionError(f"the {path} path launched no {name}")
    other = {k: v for k, v in launches.items() if v and k not in names}
    if other:
        raise AssertionError(f"the {path} path launched {other}")


def phase_oltp(quick: bool, record: dict):
    import numpy as np
    import torch
    from repro_torch.bench import checkout, fig6_rsi
    from repro_torch.db import Database
    from repro_torch.kernels import ops
    waves = 2 if quick else MAIN_WAVES
    size = {"products": checkout.PRODUCTS,
            "payload_words": checkout.PAYLOAD_WORDS}
    plan = checkout.plan(seed=7, waves=waves, T=MAIN_T, **size)

    def run(db):
        checkout.create_table(db, waves=waves, T=MAIN_T, **size)
        return checkout.drive(db, plan, max_retries=2)

    db = Database(device="cuda")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    masks, sessions, commit_s = run(db)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, "oltp")
    db_plain = Database(device="cuda", impl="plain")
    masks_p, _, commit_s_p = run(db_plain)
    if ops.launch_counts() != launches:
        raise AssertionError("the plain run launched a kernel")
    # the kernels' path equals the plain path, bit for bit
    for a, b in zip(masks, masks_p):
        if not np.array_equal(a, b):
            raise AssertionError("committed masks differ")
    if db.txn_stats != db_plain.txn_stats:
        raise AssertionError(f"txn_stats differ: {db.txn_stats} vs "
                             f"{db_plain.txn_stats}")
    if db.fabric_stats() != db_plain.fabric_stats():
        raise AssertionError("fabric_stats differ")
    st, stp = db.table("products").store, db_plain.table("products").store
    for k in st:
        if not torch.equal(st[k], stp[k]):
            raise AssertionError(f"store leaf {k} differs")
    del db_plain, stp
    torch.cuda.empty_cache()
    t = db.table("products")
    if t.locked_rows() != 0:
        raise AssertionError(f"{t.locked_rows()} rows left locked")
    n_sessions = waves * MAIN_T
    final_aborts = sum(int((~m).sum()) for m in masks)
    if db.txn_stats["commits"] + final_aborts != n_sessions:
        raise AssertionError("commits + final aborts != sessions")
    readback = checkout.check_readback(db, sessions)
    emit("oltp", sessions=n_sessions, waves=waves,
         commits=db.txn_stats["commits"], final_aborts=final_aborts,
         txn_stats=db.txn_stats, readback=readback,
         wall_s=wall, commit_s=commit_s, commit_s_plain=commit_s_p,
         commit_txn_per_s=n_sessions / sum(commit_s),
         commit_spread=fig6_rsi.spread(commit_s[1:]),
         launches=launches, fabric=db.fabric_stats(), gpu=smi())


def phase_olap(quick: bool, record: dict):
    """Fig 8a's and Fig 8b's queries through the facade at the paper's
    size; each bench module holds every result to its ground truth and,
    on a subset, to the plain path, and raises otherwise.  Then Fig 8b's
    kernel row and the shuffle microbench, each with its own counts."""
    import torch
    from repro_torch.bench import fig8a_joins, fig8b_agg
    from repro_torch.kernels import ops
    n = OLAP_QUICK_N if quick else OLAP_N
    sels = (0.5,) if quick else fig8a_joins.SELS
    groups = (1, 64, 1 << 20) if quick else fig8b_agg.GROUPS
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    a = fig8a_joins.joins(n, device="cuda", sels=sels, plain_sels=sels,
                          profile_sels=PROFILE_SELS)
    t1 = time.perf_counter()
    keys, vals = fig8b_agg.table(n, device="cuda")
    b = fig8b_agg.aggregations(keys, vals, groups=groups,
                               plain_groups=groups,
                               profile_groups=PROFILE_GROUPS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = ops.launch_counts()
    _count(OLAP_KERNELS, launches, record, "olap")

    ops.reset_launch_counts()
    b["kernel_row"] = fig8b_agg.kernel_row(keys, vals)
    row_launches = ops.launch_counts()
    _count(KERNEL_ROW_KERNELS, row_launches, record, "fig8b kernel row")
    del keys, vals
    torch.cuda.empty_cache()

    shuffle = {"rows": n, "chunks": fig8a_joins.ROUTE_CHUNKS}
    for leg, kw in (("overlap_on", {"overlap": True,
                                    "chunks": fig8a_joins.ROUTE_CHUNKS}),
                    ("overlap_off", {})):
        ops.reset_launch_counts()
        shuffle[f"{leg}_s"] = fig8a_joins.shuffle_route_bench(
            n, device="cuda", **kw)
        shuffle[f"{leg}_launches"] = {
            k: v for k, v in ops.launch_counts().items() if v}
    for row in a.pop("rows"):
        emit("olap_join", n=n, **row, gpu=smi())
    for row in b.pop("rows"):
        emit("olap_agg", n=n, **row, gpu=smi())
    emit("olap", n=n, joins_s=t1 - t0, aggs_s=t2 - t1, launches=launches,
         kernel_row_launches=row_launches, shuffle_route=shuffle,
         fig8a=a, fig8b=b, gpu=smi())


def phase_fig6(quick: bool):
    from repro_torch.bench import fig6_rsi
    runs = [("jax_defaults", {}, None),
            ("paper_T1024", fig6_rsi.paper_width(1024), None)]
    if not quick:
        runs += [("paper_T8192", fig6_rsi.paper_width(8192), None),
                 ("paper_T8192_plain", fig6_rsi.paper_width(8192), "plain")]
    for name, kw, impl in runs:
        r = fig6_rsi.measured_local_txn_rate(iters=FIG6_ITERS, impl=impl,
                                             **kw)
        emit("fig6", run=name, impl=impl or "kernel", T=r["T"],
             txn_per_s=r["txn_per_s"], median_s=r["median_s"],
             spread=r["spread"], times_s=r["times_s"],
             committed=r["committed"],
             plan_builds=r["plan_builds"], stats=r["stats"], gpu=smi())


# ----------------------------------------------------------- n shards ---

def _paged_failures(name: str, run: dict, kernel: bool) -> list:
    """The checks of one paged engine run: locks end free; all-local
    moves no cold block, every other configuration pages (cold reads and
    dirty write-backs); a kernel run launches cas_lock once in each tick
    that claims a slot and nothing else, a plain run launches nothing."""
    out = []
    if not run["lock_words_zero"]:
        out.append(f"{name}: slot locks left held")
    c = run["store"]
    if name == "all_local":
        if c["misses"] or c["prefetched"] or c["writebacks"]:
            out.append(f"all_local paged cold blocks: {c}")
    elif not (c["misses"] + c["prefetched"] > 0 and c["writebacks"] > 0):
        out.append(f"{name} did not page: {c}")
    for i, t in enumerate(run["ticks"]):
        want = int(kernel and t["claimed"])
        other = {k: v for k, v in t["launches"].items()
                 if v and k != "cas_lock"}
        if t["launches"]["cas_lock"] != want or other:
            out.append(f"{name} tick {i} launched {t['launches']}, claimed "
                       f"{t['claimed']}")
            break
    return out


def _paged_line(run: dict) -> dict:
    """What the phase line keeps of one paged engine run."""
    keep = ("seconds", "tick_ms", "step_ms", "tokens_per_s",
            "new_tokens_per_s", "swap_share", "peak_bytes", "hot_blocks",
            "block_bytes", "cold", "tiers")
    return {**{k: run[k] for k in keep},
            "hit_rate": run["store"]["hit_rate"],
            "store": {k: run["store"][k] for k in (
                "hits", "misses", "evictions", "writebacks", "prefetched",
                "drops", "n_blocks")},
            "ticks": len(run["ticks"]),
            "claims": sum(t["claimed"] for t in run["ticks"]),
            "launches": {k: v for k, v in _summed_launches(run).items()
                         if v}}


def _summed_launches(run: dict) -> dict:
    """A paged run's launches: its ticks' counts, summed."""
    return {k: sum(t["launches"][k] for t in run["ticks"])
            for k in run["ticks"][0]["launches"]}


def phase_paged(quick: bool, record: dict):
    """glm4-9b at its full config (--quick: 4 layers) with bf16 weights
    drawn on the card, through src/repro_torch/bench/serve.py's
    paged_engine: ServeEngine(paged=True, slots=8, max_seq=1024,
    block_tokens=16, max_resident=16) takes the 16 requests of
    bench.serve.requests at once, in each of PAGED_CONFIGS and once more
    on the plain path.  Every configuration's tokens must equal the
    all-local run's, the plain run's the kernel run's; the lock words end
    at 0; all-local moves no cold block and the others page; each tick is
    counted between a reset and a read, and in a kernel run cas_lock
    launches once in each tick that claims a slot and nothing else
    launches.  Then Fig serve (bench/fig_serve.py) at the JAX benchmark's
    sizes on the card, with its asserts (a), (b) and (c).  The phase line
    is printed before a failure is raised."""
    import torch
    from repro_torch.bench import serve
    t0 = time.perf_counter()
    cfg = serve.config(PAGED_ARCH, 4 if quick else None)
    params = serve.weights(cfg, device="cuda")
    runs = {name: serve.paged_engine(cfg, params, **kw)
            for name, kw in PAGED_CONFIGS.items()}
    plain = serve.paged_engine(cfg, params, impl="plain",
                               **PAGED_CONFIGS[PAGED_PLAIN])
    del params
    torch.cuda.empty_cache()
    failures = []
    base = runs["all_local"]["outs"]
    if len(base) != serve.REQUESTS or any(
            len(o) != serve.MAX_NEW for o in base.values()):
        failures.append(f"all_local finished {len(base)} requests")
    for name, run in runs.items():
        if run["outs"] != base:
            failures.append(f"{name} tokens differ from all_local's")
        failures += _paged_failures(name, run, kernel=True)
    if plain["outs"] != runs[PAGED_PLAIN]["outs"]:
        failures.append("the plain engine's tokens differ from the "
                        "kernel engine's")
    failures += _paged_failures(f"plain {PAGED_PLAIN}", plain,
                                kernel=False)
    tf = time.perf_counter()
    try:
        extras = run_figure("fig_serve")
        fig = {"rows": extras["rows"], "recovery": extras["recovery"],
               "workload": extras["workload"],
               "record_s": extras["measured_s"],
               "counters": {k: v["counters"]
                            for k, v in extras["configs"].items()}}
    except AssertionError as e:
        failures.append(f"fig_serve: {e}")
        fig = None
    emit("paged", arch=PAGED_ARCH, layers=cfg.num_layers,
         slots=serve.SLOTS, max_seq=serve.MAX_SEQ,
         block_tokens=serve.BLOCK_TOKENS, max_resident=serve.MAX_RESIDENT,
         capacity_blocks=serve.CAPACITY_BLOCKS,
         runs={name: _paged_line(r) for name, r in runs.items()},
         plain={PAGED_PLAIN: _paged_line(plain)},
         tokens_equal=all(r["outs"] == base for r in runs.values()),
         plain_equal=plain["outs"] == runs[PAGED_PLAIN]["outs"],
         fig_serve=fig, fig_serve_s=time.perf_counter() - tf,
         failures=failures, seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("paged: " + "; ".join(failures))
    for name, run in runs.items():
        _count(("cas_lock",), _summed_launches(run), record,
               f"paged {name}")


def check_shard_shapes(quick: bool, record: dict):
    """The rank, the scatter and the CAS bit-exact against their plain
    versions at the shapes the 4-shard path gives them: a commit shard's
    7168 requests into 4 buckets of 7168 (prepare and install widths), a
    home shard's 282 768 words under 28 672 routed requests, and a join
    shard's 32 000 000 requests into 4 buckets of 16 000 000."""
    import torch
    from repro_torch.kernels import cas_lock as ck, radix_partition as rp
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(18)
    errs = {"rank": 0, "scatter": 0, "cas": 0}
    join_a = (OLAP_QUICK_N if quick else OLAP_N) // SHARDS
    for A, cap, widths in ((MAIN_T // SHARDS * 7, MAIN_T // SHARDS * 7,
                            (4, 259)), (join_a, 2 * join_a // SHARDS, (2,))):
        dest = _rand_dest(g, A, SHARDS, dev)
        got, want = rp.rank(dest, SHARDS, cap), ref.rank(dest, SHARDS, cap)
        for x, y, what in zip(got, want, ("slot", "keep", "overflow",
                                          "counts")):
            if not torch.equal(x, y):
                raise AssertionError(f"radix rank {what} differs at the "
                                     f"shards' A={A} cap={cap}")
            errs["rank"] = max(errs["rank"], _err(x, y))
        for w in widths:
            rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                                 device=dev, dtype=torch.int32)
            mask = torch.rand((A,), generator=g, device=dev) < 0.9
            kb = rp.scatter(rows, got[0], SHARDS * cap, counts=got[3],
                            mask=mask)
            pb = ref.scatter(rows, got[0], SHARDS * cap, counts=got[3],
                             mask=mask)
            if not torch.equal(kb, pb):
                raise AssertionError(f"radix scatter differs at the shards' "
                                     f"A={A} cap={cap} w={w}")
            errs["scatter"] = max(errs["scatter"], _err(kb, pb))
            del rows, kb, pb
    R, A = 1_131_072 // SHARDS, MAIN_T * 7
    words = torch.randint(0, 4, (R,), generator=g, device=dev,
                          dtype=torch.int32)
    idx = torch.randint(-1, R, (A,), generator=g, device=dev,
                        dtype=torch.int32)
    exp = words[idx.clamp(0, R - 1).to(torch.int64)]
    prio = torch.randint(0, A, (A,), generator=g, device=dev,
                         dtype=torch.int32)
    kw, pw = words.clone(), words.clone()
    ok_k = ck.cas(kw, idx, exp, exp + 8, prio)
    ok_p = ref.cas(pw, idx, exp, exp + 8, prio)
    if not (torch.equal(ok_k, ok_p) and torch.equal(kw, pw)):
        raise AssertionError(f"cas differs at the shards' R={R} A={A}")
    errs["cas"] = _err(kw, pw)
    for name, key in (("radix_partition_rank", "rank"),
                      ("radix_partition_scatter", "scatter"),
                      ("cas_lock", "cas")):
        record[name]["max_abs_err"] = max(record[name].get("max_abs_err")
                                          or 0, errs[key])
    torch.cuda.empty_cache()
    return errs


def shards_oltp(quick: bool, record: dict):
    """The §4.3 checkout on 4 shards against one shard and the plain path
    on 4: the same masks, store, txn_stats; 4x the one-shard launches."""
    import numpy as np
    import torch
    from repro_torch.bench import checkout, fig6_rsi
    from repro_torch.kernels import ops
    waves = 2 if quick else MAIN_WAVES
    size = {"products": checkout.PRODUCTS,
            "payload_words": checkout.PAYLOAD_WORDS}
    plan = checkout.plan(seed=7, waves=waves, T=MAIN_T, **size)
    runs = {}
    for name, shards, impl in (("one", 1, None), ("mesh", SHARDS, None),
                               ("mesh_plain", SHARDS, "plain")):
        db = checkout.database(shards, device="cuda", impl=impl)
        checkout.create_table(db, waves=waves, T=MAIN_T, **size)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        masks, sessions, commit_s = checkout.drive(db, plan, max_retries=0)
        torch.cuda.synchronize()
        runs[name] = {"db": db, "masks": masks, "sessions": sessions,
                      "commit_s": commit_s, "wall_s": time.perf_counter() - t0,
                      "launches": ops.launch_counts()}
    one, mesh, plain = runs["one"], runs["mesh"], runs["mesh_plain"]
    _count(OLTP_KERNELS, mesh["launches"], record, "shards/oltp")
    for k in OLTP_KERNELS:
        if mesh["launches"][k] != SHARDS * one["launches"][k]:
            raise AssertionError(
                f"{k}: {mesh['launches'][k]} launches on {SHARDS} shards, "
                f"{one['launches'][k]} on one")
    if any(plain["launches"].values()):
        raise AssertionError("the plain 4-shard run launched a kernel")
    for other in (one, plain):
        for a, b in zip(mesh["masks"], other["masks"]):
            if not np.array_equal(a, b):
                raise AssertionError("committed masks differ")
        if mesh["db"].txn_stats != other["db"].txn_stats:
            raise AssertionError(f"txn_stats differ: "
                                 f"{mesh['db'].txn_stats} vs "
                                 f"{other['db'].txn_stats}")
        st, sto = (r["db"].table("products").store for r in (mesh, other))
        for k in st:
            if not torch.equal(st[k], sto[k]):
                raise AssertionError(f"store leaf {k} differs")
    if mesh["db"].fabric_stats() != plain["db"].fabric_stats():
        raise AssertionError("fabric_stats differ from the plain path's")
    db = mesh["db"]
    if db.table("products").locked_rows() != 0:
        raise AssertionError("rows left locked")
    readback = checkout.check_readback(db, mesh["sessions"])
    n_sessions = waves * MAIN_T
    emit("shards_oltp", shards=SHARDS, sessions=n_sessions, waves=waves,
         records_a_shard=db.table("products").schema.num_records // SHARDS,
         txn_stats=db.txn_stats, readback=readback,
         commit_s={k: r["commit_s"] for k, r in runs.items()},
         commit_txn_per_s={k: n_sessions / sum(r["commit_s"])
                           for k, r in runs.items()},
         commit_spread={k: fig6_rsi.spread(r["commit_s"][1:])
                        for k, r in runs.items()},
         wall_s={k: r["wall_s"] for k, r in runs.items()},
         launches={k: r["launches"] for k, r in runs.items()},
         fabric=db.fabric_stats(), gpu=smi())


def shards_fig6(quick: bool):
    """The paper_T8192 commit on 4 shards beside 1, in turns (1, 4, 4,
    1), then each under the profiler."""
    from repro_torch.bench import fig6_rsi, profile_commit
    T = 1024 if quick else 8192
    for shards in (1, SHARDS, SHARDS, 1):
        r = fig6_rsi.measured_local_txn_rate(
            iters=FIG6_ITERS, shards=shards, **fig6_rsi.paper_width(T))
        emit("shards_fig6", shards=shards, T=T, txn_per_s=r["txn_per_s"],
             median_s=r["median_s"], spread=r["spread"],
             host_median_s=r["host_median_s"],
             host_spread=fig6_rsi.spread(r["host_times_s"]),
             committed=r["committed"], plan_builds=r["plan_builds"],
             stats=r["stats"], gpu=smi())
    for shards in (1, SHARDS):
        p = profile_commit.profile_fig6(T, shards=shards)
        emit("shards_fig6_profile", **{k: v for k, v in p.items()
                                       if k != "times_s"}, gpu=smi())


def shards_olap(quick: bool, record: dict):
    """The joins at sel 0.5 and the aggregations on 4 shards of N/4
    tuples, each held by the bench modules to its ground truth (the
    joins also to the plain path), then the same queries on one shard,
    which must give the same values."""
    import torch
    from repro_torch.bench import fig8a_joins, fig8b_agg
    from repro_torch.kernels import ops
    n = OLAP_QUICK_N if quick else OLAP_N
    groups = (64, 1 << 20) if quick else SHARD_GROUPS
    out = {}
    for shards in (SHARDS, 1):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        # one join on the plain path: the plain rank's one-hot cumsum
        # over 4 buckets took 35 s a join at 32M rows a shard on an H100
        a = fig8a_joins.joins(n, device="cuda", sels=(0.5,),
                              plain_sels=(0.5,) if shards > 1 else (),
                              plain_variants=("rrj",), shards=shards)
        keys, vals = fig8b_agg.table(n, device="cuda")
        b = fig8b_agg.aggregations(keys, vals, groups=groups, shards=shards)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        if shards > 1:
            _count(OLAP_KERNELS, launches, record, "shards/olap")
        del keys, vals
        torch.cuda.empty_cache()
        out[shards] = (a, b, time.perf_counter() - t0, launches)
    (a4, b4, s4, l4), (a1, b1, s1, l1) = out[SHARDS], out[1]
    for r4, r1 in zip(a4["rows"], a1["rows"]):
        for name, v4 in r4["variants"].items():
            v1 = r1["variants"][name]
            if (v4["value"], v4["dropped"]) != (v1["value"], v1["dropped"]):
                raise AssertionError(f"shards: join {name} differs from "
                                     "one shard")
            emit("shards_join", n=n, shards=SHARDS, sel=r4["sel"],
                 variant=name, value=v4["value"], dropped=v4["dropped"],
                 median_s=v4["median_s"], min_s=v4["min_s"],
                 max_s=v4["max_s"], peak_bytes=v4["peak_bytes"],
                 plain_s=v4.get("plain_s"), one_shard_median_s=v1["median_s"],
                 one_shard_peak_bytes=v1["peak_bytes"], stats=v4["stats"],
                 gpu=smi())
    for r4, r1 in zip(b4["rows"], b1["rows"]):
        for name, v4 in r4["schemes"].items():
            v1 = r1["schemes"][name]
            emit("shards_agg", n=n, shards=SHARDS, groups=r4["groups"],
                 scheme=name, median_s=v4["median_s"], min_s=v4["min_s"],
                 max_s=v4["max_s"], peak_bytes=v4["peak_bytes"],
                 one_shard_median_s=v1["median_s"],
                 one_shard_peak_bytes=v1["peak_bytes"], stats=v4["stats"],
                 gpu=smi())
    emit("shards_olap", n=n, shards=SHARDS, seconds={SHARDS: s4, 1: s1},
         launches={SHARDS: l4, 1: l1}, gpu=smi())


def phase_shards(quick: bool, record: dict):
    t0 = time.perf_counter()
    errs = check_shard_shapes(quick, record)
    shards_oltp(quick, record)
    shards_fig6(quick)
    shards_olap(quick, record)
    for name in ("radix_partition_rank", "radix_partition_scatter",
                 "cas_lock", "grouped_sum_u32", "hash_join"):
        record[name]["paths"] += ", shards"
    emit("shards", shards=SHARDS, max_abs_err=errs,
         seconds=time.perf_counter() - t0, gpu=smi())


# ------------------------------------------------------------ controls --
# Plain versions with a fault a kernel could have: a control reading of a
# check must land above its limit, or the check could not see that fault.

def _attn_tile_dropped(q, k, v, *, causal: bool = True):
    """ref.flash_attention with the 64-key tile [T/2, T/2 + 64) hidden,
    causal: from every query after it; non-causal: from every query; as a
    kernel that skipped one tile would compute."""
    import torch
    B, S, H, D = q.shape
    T = k.shape[1]
    G = H // k.shape[2]
    lo = T // 2 // 64 * 64
    kk = k.float().repeat_interleave(G, dim=2)
    vv = v.float().repeat_interleave(G, dim=2)
    kpos = torch.arange(T, device=q.device)
    tile = (kpos >= lo) & (kpos < lo + 64)
    out = q.new_empty((B, S, H, v.shape[-1]))
    for s0 in range(0, S, 1024):
        qc = q[:, s0:s0 + 1024].float()
        qpos = torch.arange(s0, s0 + qc.shape[1], device=q.device)[:, None]
        keep = ((kpos <= qpos) & ~(tile & (qpos >= lo + 64)) if causal
                else ~tile)
        sc = torch.einsum("bshd,bthd->bhst", qc, kk) * D ** -0.5
        p = torch.softmax(sc.masked_fill(~keep, -1e30), dim=-1)
        out[:, s0:s0 + 1024] = torch.einsum("bhst,bthd->bshd", p,
                                            vv).to(q.dtype)
    return out


def _ssd_state_dropped(xh, bv, cv, dt, a, state0=None):
    """ref.ssd_scan with the state not carried across the chunk boundary
    nearest S/2, as a kernel that lost its state there would compute."""
    import torch
    from repro_torch.kernels import ref
    mid = max(xh.shape[1] // 2 // 256 * 256, 1)
    y1, _ = ref.ssd_scan(xh[:, :mid], bv[:, :mid], cv[:, :mid], dt[:, :mid],
                         a, state0)
    y2, st = ref.ssd_scan(xh[:, mid:], bv[:, mid:], cv[:, mid:], dt[:, mid:],
                          a)
    return torch.cat([y1, y2], dim=1), st


def _moe_expert_dropped(cfg, mcfg, p, x):
    """moe._moe_reference with one expert left out (the first choice of
    the first token, so it has work), as a dispatch that lost an expert's
    rows would compute."""
    import torch
    from repro_torch.models import moe
    B, S, D = x.shape
    xt = x.reshape(-1, D)
    vals, idx, _ = moe._gates(mcfg, xt, p["router"])
    drop = int(idx[0, 0])
    out = torch.zeros_like(xt)
    for e in range(mcfg.num_experts):
        if e == drop:
            continue
        w = torch.where(idx == e, vals, 0.0).sum(-1)
        y = moe._expert_ffn(xt, p["wi"][e].to(x.dtype),
                            p["wo"][e].to(x.dtype))
        out = out + y * w[:, None].to(x.dtype)
    return out.reshape(B, S, D)


@contextlib.contextmanager
def faulty_plain(kernel: str):
    """Within the block, ``ops.<kernel>`` with impl="plain" runs the faulty
    control above; the kernel path is left alone.  ``"moe"``: the MoE
    reference loop (the packed experts' plain version) drops an expert."""
    from repro_torch.kernels import ops
    if kernel == "moe":
        from repro_torch.models import moe
        orig = moe._moe_reference
        moe._moe_reference = _moe_expert_dropped
        try:
            yield
        finally:
            moe._moe_reference = orig
        return
    orig = getattr(ops, kernel)
    fault = {"flash_attention": _attn_tile_dropped,
             "ssd_scan": _ssd_state_dropped}[kernel]

    def patched(*args, impl=None, backward=None, **kw):
        if impl == "plain":
            return fault(*args, **kw)
        kw["backward"] = backward
        return orig(*args, impl=impl, **kw)
    setattr(ops, kernel, patched)
    try:
        yield
    finally:
        setattr(ops, kernel, orig)


def _scores(q, k):
    """Unscaled scores (B, K, G, c, T) of a chunk of chunked attention."""
    import torch
    return torch.einsum("bckgd,btkd->bkgct", q, k)


def _halves(q, k):
    h = q.shape[-1] // 2
    return _scores(q[..., :h], k[..., :h]) + _scores(q[..., h:], k[..., h:])


# S = Q.K^T of f32 q and k, rounded other sound ways than the plain f32
# product's: each score summed in f64 and rounded once to f32; d summed
# from D - 1 down to 0; each half of d summed apart, then the halves added
SOUND_S = {"f64": lambda q, k: _scores(q.double(), k.double()).float(),
           "reversed": lambda q, k: _scores(q.flip(-1), k.flip(-1)),
           "halves": _halves}


@contextlib.contextmanager
def sound_plain(kernel: str, variant: str):
    """Within the block, ``ops.flash_attention`` with impl="plain" runs
    the function the plain path differentiates (``attention.
    chunked_attend``) with S = Q.K^T rounded another sound way
    (``SOUND_S[variant]``), with and without autograd; the kernel path is
    left alone.  Each variant is the plain path's function to f32
    precision (``tests/test_torch_flash_f32_split.py`` holds it to JAX's
    reference), so the gradient check's reading between a variant and the
    plain path is a spread that sound f32 arithmetic alone gives."""
    from repro_torch.kernels import ops
    from repro_torch.models import attention
    if kernel != "flash_attention":
        raise ValueError(f"no sound variants of {kernel}: it has no S")
    orig, scores = ops.flash_attention, SOUND_S[variant]

    def patched(q, k, v, *, causal=True, impl=None, backward=None):
        if impl != "plain":
            return orig(q, k, v, causal=causal, impl=impl,
                        backward=backward)
        B, S, H, hd = q.shape
        K = k.shape[2]
        out = attention.chunked_attend(q.reshape(B, S, K, H // K, hd), k, v,
                                       causal=causal, scores=scores)
        return out.reshape(B, S, H, v.shape[-1])
    ops.flash_attention = patched
    try:
        yield
    finally:
        ops.flash_attention = orig


def roofline_line(phase: str, arch: str, device: dict, meta: dict,
                  pre: dict, **extra) -> list:
    """Print a prefill step's roofline (``launch/roofline.py``: the step
    counted once outside the timed steps, on the card and on meta tensors
    of the same shapes) on a line of its own with the card's name and
    power limit, its measured share (``mfu``), and return the failures:
    the card's count differs from the meta device's, or the kernelized
    bound is slower than the measured median step (a miscount)."""
    from repro_torch.bench import serve
    agree, dev, met = serve.counts_agree(device, meta)
    row = serve.roofline_row(meta, median_s=pre["median_s"])
    failures = []
    if not agree:
        failures.append(f"the card counted {dev}, the meta device {met}")
    if not row["bound_s_kernelized"] <= pre["median_s"]:
        failures.append(f"the kernelized bound {row['bound_s_kernelized']} s "
                        f"exceeds the measured median {pre['median_s']} s")
    emit(f"{phase}_roofline", arch=arch, n_chips=meta["n_chips"],
         roofline=row, counts_agree=agree, card_count=dev,
         **({} if agree else {"meta_count": met}),
         count_s={"card": device["seconds"], "meta": meta["seconds"]},
         **extra, failures=failures, gpu=smi())
    return failures


def memory_estimate(meta: dict, pre: dict) -> dict:
    """The dry-run's one-device estimate of the prefill step's memory, read
    from its meta count (``bench.serve.count_on_meta``: the arguments'
    bytes, the kernelized peak of live bytes above them), beside the
    measured peak (``torch.cuda.max_memory_allocated`` over the timed
    steps)."""
    args, live = meta["argument_bytes"], meta["seen"]["peak_live_k"]
    est = args + live
    return {"argument_bytes": args, "peak_live_bytes": live,
            "estimate_bytes": est, "measured_peak_bytes": pre["peak_bytes"],
            "ratio": est / pre["peak_bytes"], "held_to": MEMORY_MIN_RATIO}


def phase_serve(quick: bool, record: dict):
    """Each model at its full published config (--quick: 4 layers, S=1024)
    through src/repro_torch/bench/serve.py.  Every timed prefill step must
    launch its model's kernel once a layer and nothing else; every engine
    wave must launch cas_lock and nothing else; the engine's tokens must
    equal the plain engine's; the lock words end at 0.  Logits and layers:

    * every layer's kernel against its plain version on that layer's own
      inputs in a kernel-path forward over the prefill prompt, at every
      position, within ROW_TOL; the same check with a faulty plain path (a
      dropped key tile, a state not carried) on the first layer must read
      above ROW_TOL;
    * the full-depth last-position logits with f32 weights and activations
      within F32_LOGIT_TOL, argmax equal, wherever the plain path with its
      embedding nudged by 2^-20 stays within F32_LOGIT_TOL of itself (a
      model whose depth amplifies that nudge beyond the limit cannot be
      held at full depth; its witness is reported, and the layer check
      holds its kernel).  The bf16 full-depth difference is reported.

    The phase line is printed before a failure is raised."""
    import torch
    from repro_torch.bench import serve
    from repro_torch.kernels import ops
    for arch, kernel in SERVE_ARCHS.items():
        cfg = serve.config(arch, 4 if quick else None)
        batch, seq = serve.PREFILL[arch]
        seq = 1024 if quick else seq
        t0 = time.perf_counter()
        # the meta count is CPU work (a minute for mamba2's plain SSD on
        # meta): a process of its own runs it beside the card's work
        meta = serve.start_count_on_meta(cfg, batch=batch, seq=seq)
        params = serve.weights(cfg, device="cuda")
        torch.cuda.synchronize()
        nbytes = sum(t.numel() * t.element_size() for t in
                     _leaves(params))
        pre = serve.prefill(cfg, params, batch=batch, seq=seq)
        card = serve.count_on_device(cfg, params, batch=batch, seq=seq)
        tokens = serve.prompt(cfg, batch, seq, params["embed"].device)
        layers = serve.layer_check(cfg, params, tokens)
        with faulty_plain(kernel):
            layers["control"] = serve.layer_check(cfg, params, tokens,
                                                  groups=1)["max"]
        del tokens
        if kernel == "flash_attention":
            pre["parent_kernel"] = prefill_turns(cfg, params, batch, seq)
        eng = serve.engine(cfg, params)
        plain = serve.engine(cfg, params, impl="plain")
        del params
        torch.cuda.empty_cache()
        before = ops.launch_counts()
        f32 = serve.f32_witness(cfg, batch=batch, seq=seq, device="cuda")
        _count_f32("flash_f32" if kernel == "flash_attention"
                   else "ssd_chunk_f32", kernel, before)
        torch.cuda.empty_cache()
        meta = serve.join_count_on_meta(meta)
        memory = memory_estimate(meta, pre) if arch == MEMORY_ARCH else None
        failures = roofline_line(
            "serve", arch, card, meta, pre,
            **({} if memory is None else {"memory_estimate": memory}))
        if memory is not None and memory["ratio"] < MEMORY_MIN_RATIO:
            failures.append(f"the dry-run estimates {memory['estimate_bytes']}"
                            f" bytes, {memory['ratio']} of the measured peak "
                            f"{memory['measured_peak_bytes']} (at least "
                            f"{MEMORY_MIN_RATIO})")
        for launches in pre["launches"]:
            if launches[kernel] != cfg.num_layers:
                failures.append(f"prefill launched {kernel} "
                                f"{launches[kernel]} times, not "
                                f"{cfg.num_layers}")
        if not (pre["full"]["finite"] and f32["kernel"]["finite"]):
            failures.append("prefill logits not finite")
        if not pre["full"]["step_agrees"]:
            failures.append("the prefill step's token is not the argmax of "
                            "its logits")
        if len(layers["per_layer"]) != cfg.num_layers:
            failures.append(f"the layer check read "
                            f"{len(layers['per_layer'])} kernel calls")
        if layers["max"] > ROW_TOL:
            failures.append(f"layer {layers['worst_layer']}'s {kernel} "
                            f"differs from the plain path by "
                            f"{layers['max']} > {ROW_TOL}")
        if not layers["control"] > ROW_TOL:
            failures.append(f"the layer check read {layers['control']} on "
                            f"a faulty plain path, not above {ROW_TOL}")
        f32["held"] = f32["nudged"]["max_abs_diff"] <= F32_LOGIT_TOL
        if f32["held"] and (f32["kernel"]["max_abs_diff"] > F32_LOGIT_TOL
                            or f32["kernel"]["argmax_agree"] < 1):
            failures.append(f"f32 full-depth logits differ from the plain "
                            f"path by {f32['kernel']['max_abs_diff']} "
                            f"(limit {F32_LOGIT_TOL}), argmax agreement "
                            f"{f32['kernel']['argmax_agree']}")
        if any(v for w in plain["waves"] for v in w["launches"].values()):
            failures.append("the plain engine launched a kernel")
        if eng["outs"] != plain["outs"]:
            failures.append("engine tokens differ from the plain engine's")
        if not (eng["lock_words_zero"] and plain["lock_words_zero"]):
            failures.append("the engine left slot locks held")
        if len(eng["outs"]) != serve.REQUESTS:
            failures.append(f"the engine finished {len(eng['outs'])} "
                            "requests")
        emit("serve", arch=arch, layers=cfg.num_layers,
             weights_bytes=nbytes, prefill=pre, layer_check=layers,
             layer_check_held_to=ROW_TOL, f32_full=f32,
             f32_held_to=F32_LOGIT_TOL,
             engine={k: v for k, v in eng.items() if k != "outs"},
             engine_plain_s=plain["seconds"],
             tokens_equal=eng["outs"] == plain["outs"], failures=failures,
             seconds=time.perf_counter() - t0, gpu=smi())
        if failures:
            raise AssertionError(f"serve {arch}: " + "; ".join(failures))
        for launches in pre["launches"]:
            _count((kernel,), launches, record, f"serve {arch} prefill")
        for w in eng["waves"]:
            _count(("cas_lock",), w["launches"], record,
                   f"serve {arch} engine wave")
        del pre, eng, plain


def time_dispatch_rank(T: int, k: int, E: int) -> dict:
    """The rank at an MoE dispatch's shape: A = T k distinct-per-token
    expert ids (seed 24) into E buckets of cap T, held bit-exact to its
    plain version and timed beside it.  Bound: the ids read once and the
    slot (int32), keep and overflow (bool) and counts written once, at
    3.35 TB/s.  No single PyTorch call computes a stable rank."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(24)
    dest = torch.rand((T, E), generator=g, device=dev).argsort(
        -1)[:, :k].sort(-1).values.reshape(-1).to(torch.int32).contiguous()
    got, want = rp.rank(dest, E, T), ref.rank(dest, E, T)
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"rank at the dispatch shape T={T} k={k} "
                             f"E={E} differs from its plain version")
    A = dest.numel()
    nbytes = 4 * A + 4 * A + 2 * A + 4 * E
    return {"A": A, "n": E, "cap": T,
            "ms": time_ms(lambda: rp.rank(dest, E, T), iters=20),
            "device_ms": device_ms(lambda: rp.rank(dest, E, T),
                                   rp.KERNELS["rank"], iters=10),
            "plain_ms": time_ms(lambda: ref.rank(dest, E, T), iters=5),
            "bound_ms": bound_ms(nbytes), "bound_by": "bytes",
            "library_ms": None, "max_abs_err": 0}


def time_rrj_route(T: int, k: int, E: int, D: int, tp: int, cap: int,
                   ecap: int) -> dict:
    """The rank and the scatter at the RRJ dispatch's two radix passes on
    one shard (seed 26): T tokens' k distinct experts of E binned by owner
    shard into tp buffers of cap rows of D/2 + 1 lanes (a bf16 token row
    and its local expert; the scatter appends the valid lane), then tp *
    cap received rows of D/2 lanes, the first counts[j] of source j's
    block valid, by local expert into E/tp bins of ecap (invalid rows not
    binned).  Each held bit-exact to its plain version and timed beside
    it; the scatter also beside ``index_copy_`` into a buffer with a spare
    row for the rows not sent.  Bounds: bytes once at 3.35 TB/s (the rank:
    ids in, slot, keep, overflow and counts out; the scatter: the rows it
    sends and every slot in, the whole buffer out)."""
    import torch
    from repro_torch.kernels import radix_partition as rp, ref
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(26)
    local_e = E // tp
    experts = torch.rand((T, E), generator=g, device=dev).argsort(
        -1)[:, :k].reshape(-1).to(torch.int32)
    passes = {"rrj1": (torch.div(experts, local_e, rounding_mode="floor")
                       .to(torch.int32).contiguous(), tp, cap, D // 2 + 1)}
    _, _, _, counts = rp.rank(passes["rrj1"][0], tp, cap)
    valid = (torch.arange(cap, device=dev)[None, :] < counts[:, None]
             ).reshape(-1)
    le = torch.randint(0, local_e, (tp * cap,), generator=g, device=dev,
                       dtype=torch.int32)
    passes["rrj2"] = (torch.where(valid, le, local_e).to(torch.int32),
                      local_e, ecap, D // 2)
    out = {}
    for name, (dest, n, c, w) in passes.items():
        A = dest.numel()
        got, want = rp.rank(dest, n, c), ref.rank(dest, n, c)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"rank at {name} differs from its plain "
                                 "version")
        slot, keep, _, cnt = got
        kept = int(keep.sum())
        rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                             device=dev, dtype=torch.int32)
        if not torch.equal(rp.scatter(rows, slot, n * c, counts=cnt),
                           ref.scatter(rows, slot, n * c, counts=cnt)):
            raise AssertionError(f"scatter at {name} differs from its "
                                 "plain version")
        wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                           device=dev)], 1)
        buf = torch.zeros((n * c + 1, w + 1), dtype=torch.int32, device=dev)
        kslot = torch.where(keep, slot, n * c).to(torch.int64)
        shape = {"A": A, "n": n, "cap": c, "lanes": w, "kept": kept}
        out[f"radix_partition_rank@{name}"] = {
            "ms": time_ms(lambda: rp.rank(dest, n, c)),
            "device_ms": device_ms(lambda: rp.rank(dest, n, c),
                                   rp.KERNELS["rank"], iters=10),
            "plain_ms": time_ms(lambda: ref.rank(dest, n, c), iters=5),
            "bound_ms": bound_ms(10 * A + 4 * n), "bound_by": "bytes",
            "library_ms": None, "max_abs_err": 0, "shape": shape}
        out[f"radix_partition_scatter@{name}"] = t = {
            "ms": time_ms(lambda: rp.scatter(rows, slot, n * c,
                                             counts=cnt)),
            "device_ms": device_ms(lambda: rp.scatter(rows, slot, n * c,
                                                      counts=cnt),
                                   rp.KERNELS["scatter"], iters=10),
            "plain_ms": time_ms(lambda: ref.scatter(rows, slot, n * c,
                                                    counts=cnt), iters=5),
            "bound_ms": bound_ms(4 * (kept * w + A + n * c * (w + 1))),
            "bound_by": "bytes",
            "library_ms": time_ms(lambda: buf.index_copy_(0, kslot, wide)),
            "max_abs_err": 0, "shape": shape}
        t["bound_share"] = t["bound_ms"] / t["ms"]
    return out


def time_mesh_a2a(mesh, cap: int, D: int) -> dict:
    """The emulated all-to-alls of one MoE layer of the sharded step: each
    shard's pass-1 buffer (tp * cap rows of D/2 + 2 int32 lanes: a bf16
    token row, its local expert, the valid lane) and its returned results
    (tp * cap bf16 rows of D) exchanged over 'model'.  ``copies_ms``: a
    re-enactment, not the mesh's own code: CUDA events around the copies
    an exchange makes (each shard stacks its block of every member's
    buffer), issued back to back from one thread, so no host hand-off
    between shards is timed; ``shard_map_ms``: CUDA events around the
    exchange itself, ``Mesh.all_to_all`` in ``shard_map``, a thread a
    shard.  No profiler: on the H100 machines a trace taken while the
    shard threads issue work was followed, in the same process, by traces
    that lost their device records."""
    import torch
    from repro_torch.launch.mesh import shard_map
    from repro_torch.sharding import P
    tp, n = mesh.shape["model"], mesh.size
    lanes = D // 2 + 2
    fwd = torch.zeros((n * tp * cap, lanes), dtype=torch.int32,
                      device="cuda")
    back = torch.zeros((n * tp * cap, D), dtype=torch.bfloat16,
                       device="cuda")

    def body(a, b):
        return (mesh.all_to_all(a.reshape(tp, cap, lanes), "model", 0, 0),
                mesh.all_to_all(b.reshape(tp, cap, D), "model", 0, 0))

    spec = P(("data", "model"), None)
    f = shard_map(body, mesh, (spec, spec), (P(("data", "model")),) * 2)
    blocks = [(a.reshape(tp, cap, lanes), b.reshape(tp, cap, D))
              for a, b in zip(fwd.chunk(n), back.chunk(n))]

    def copies():
        for i in range(n):
            d = mesh.coords(i)[:-1]
            members = [blocks[mesh.index(d + (j,))] for j in range(tp)]
            me = mesh.coords(i)[-1]
            for k in range(2):
                torch.stack([m[k].select(0, me) for m in members], 0)

    return {"bytes_per_shard": 4 * tp * cap * lanes + 2 * tp * cap * D,
            "copies_ms": time_ms(copies, iters=10),
            "shard_map_ms": time_ms(lambda: f(fwd, back), iters=10)}


def mesh_leg(cfg, params, quick: bool, record: dict):
    """Phase moe's sharded leg (MESH_CUT; --quick: S 512) on the weights
    the phase holds, under ``set_policy(make_policy(make_host_mesh(
    *MESH_SHAPE)))``:

    * the prefill step (``bench.serve.prefill``) with the policy and,
      beside it, without: with it each step must launch the MLA entry
      once an attention layer and the rank and the scatter RRJ_PASSES
      times an MoE layer a shard, and nothing else; logits finite; peak
      memory;
    * every MoE layer on its own inputs (``bench.serve.mesh_layer_check``):
      the kernel RRJ against the plain RRJ (the same dropped assignments,
      rows within ROW_TOL) and, at the tokens none of whose assignments
      dropped, against today's one-shard packed experts within ROW_TOL;
      a dropped expert (``_moe_expert_dropped``) must read above it;
    * MESH_DECODE teacher-forced decode steps with the policy (the
      replicated twin: the rank and the scatter once an MoE layer a shard
      a step) against the same steps without it (the reference loop, no
      launch): each step's logit rows within ROW_TOL;
    * the rank and the scatter at the two passes' shapes
      (:func:`time_rrj_route`).

    The leg's line is printed before a failure is raised."""
    import torch
    from repro_torch.bench import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import make_policy, set_policy
    t0 = time.perf_counter()
    mesh = make_host_mesh(*MESH_SHAPE, device="cuda")
    pol = make_policy(mesh)
    batch, seq = (MESH_PREFILL[0], 512) if quick else MESH_PREFILL
    arch_want = MOE_ARCHS[MESH_ARCH][2]
    n_moe = arch_want["radix_partition_rank"]
    want = {"flash_attention_mla": arch_want["flash_attention_mla"],
            "radix_partition_rank": n_moe * mesh.size * RRJ_PASSES,
            "radix_partition_scatter": n_moe * mesh.size * RRJ_PASSES}
    want_dec = {"radix_partition_rank": n_moe * mesh.size,
                "radix_partition_scatter": n_moe * mesh.size}
    m = cfg.moe
    tp = mesh.shape["model"]
    T_local = batch // mesh.shape["data"] * (seq // tp)
    cap = moe._round8(int(T_local * m.top_k / tp * m.capacity_factor))
    ecap = min(moe._round8(int(tp * cap / (m.num_experts // tp)
                               * m.capacity_factor)), moe._round8(tp * cap))
    base = serve.prefill(cfg, params, batch=batch, seq=seq, profiled=False)
    with set_policy(pol):
        pre = serve.prefill(cfg, params, batch=batch, seq=seq,
                            profiled=False)
    card = serve.count_on_device(cfg, params, batch=batch, seq=seq,
                                 mesh=mesh)
    meta = serve.count_on_meta(cfg, batch=batch, seq=seq,
                               mesh_shape=MESH_SHAPE)
    a2a = time_mesh_a2a(mesh, cap, cfg.d_model)
    rl_failures = roofline_line(
        "moe_mesh", MESH_ARCH, card, meta, pre,
        collective_bytes_per_shard=card["per_shard"],
        all_to_all={"per_layer": a2a, "moe_layers": n_moe})
    dev = params["embed"].device
    tokens = serve.prompt(cfg, batch, seq, dev)
    with set_policy(pol):
        layers = serve.mesh_layer_check(cfg, params, tokens,
                                        faulty=_moe_expert_dropped)
    del tokens
    toks = serve.prompt(cfg, *MESH_DECODE, dev)
    dec_ref = serve.forced_decode(cfg, params, toks)
    with set_policy(pol):
        dec = serve.forced_decode(cfg, params, toks)
    dec_rows = [serve.row_rel_err(a, b) for a, b in zip(dec["logits"],
                                                         dec_ref["logits"])]
    torch.cuda.empty_cache()
    route = time_rrj_route(T_local, m.top_k, m.num_experts, cfg.d_model, tp,
                           cap, ecap)
    failures = list(rl_failures)
    for launches in pre["launches"]:
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            failures.append(f"the sharded prefill launched {got}, not {want}")
    if not (pre["full"]["finite"] and pre["full"]["step_agrees"]):
        failures.append(f"sharded prefill logits: {pre['full']}")
    per = layers["per_layer"]
    if len(per) != n_moe:
        failures.append(f"the layer check read {len(per)} MoE layers")
    if not all(r["drops_equal"] for r in per):
        failures.append("the kernel RRJ dropped other assignments than the "
                        "plain RRJ")
    for key in ("max_vs_plain", "max_vs_packed"):
        if not layers[key] <= ROW_TOL:
            failures.append(f"the layer check's {key} read {layers[key]} "
                            f"> {ROW_TOL}")
    if not per[0].get("control", 0.0) > ROW_TOL:
        failures.append(f"the layer check read {per[0].get('control')} on "
                        f"a dropped expert, not above {ROW_TOL}")
    for s, launches in enumerate(dec["launches"]):
        got = {k: v for k, v in launches.items() if v}
        if got != want_dec:
            failures.append(f"sharded decode step {s} launched {got}, not "
                            f"{want_dec}")
    if any(v for l in dec_ref["launches"] for v in l.values()):
        failures.append("the reference decode launched a kernel")
    if not max(dec_rows) <= ROW_TOL:
        failures.append(f"sharded decode logits differ from the reference "
                        f"loop's by {max(dec_rows)} > {ROW_TOL}")
    emit("moe_mesh", arch=MESH_ARCH, cut=MESH_CUT, mesh=mesh.shape,
         capacity={"T_local": T_local, "cap": cap, "ecap": ecap,
                   "capacity_factor": m.capacity_factor},
         prefill=pre, prefill_unsharded=base,
         dropped={"count": layers["dropped"],
                  "share": layers["dropped"] / layers["assignments"]},
         layer_check=layers, layer_check_held_to=ROW_TOL,
         decode={"steps": MESH_DECODE[1], "batch": MESH_DECODE[0],
                 "rows": dec_rows, "launches": dec["launches"]},
         route=route, failures=failures,
         seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("moe mesh: " + "; ".join(failures))
    for launches in pre["launches"]:
        _count(tuple(want), launches, record, f"moe {MESH_ARCH} mesh "
               "prefill")
    for launches in dec["launches"]:
        _count(tuple(want_dec), launches, record, f"moe {MESH_ARCH} mesh "
               "decode")


def phase_moe(quick: bool, record: dict):
    """MOE_ARCHS through src/repro_torch/bench/serve.py (--quick: S=1024).
    Each timed prefill step must launch exactly its MOE_ARCHS kernels,
    each engine wave cas_lock and nothing else; the kernel engine's tokens
    must equal the plain engine's; the lock words end at 0; the layer
    check (every kernel against its plain version, every MoE layer's
    packed experts against the reference loop, on their own inputs at
    every position) within ROW_TOL, and a faulty control of each kind on
    the first group above it.  No f32 witness: these cuts' f32 weights
    take about 70 GB.  MESH_ARCH then runs the sharded leg on the same
    weights (:func:`mesh_leg`).  The phase line is printed before a
    failure is raised."""
    import torch
    from repro_torch.bench import serve
    for arch, (layers, reduced, want) in MOE_ARCHS.items():
        cfg = serve.config(arch, layers, reduced=reduced)
        batch, seq = serve.PREFILL[arch]
        seq = 1024 if quick else seq
        t0 = time.perf_counter()
        params = serve.weights(cfg, device="cuda")
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        nparams = sum(t.numel() for t in leaves)
        del leaves
        pre = serve.prefill(cfg, params, batch=batch, seq=seq)
        tokens = serve.prompt(cfg, batch, seq, params["embed"].device)
        layers_ = serve.layer_check(cfg, params, tokens)
        controls = {}
        for kind in sorted(set(layers_["kinds"])):
            with faulty_plain(kind):
                got = serve.layer_check(cfg, params, tokens, groups=1)
            controls[kind] = max(r for r, kd in zip(got["per_layer"],
                                                    got["kinds"])
                                 if kd == kind)
        layers_["control"] = controls
        del tokens
        torch.cuda.empty_cache()
        eng = serve.engine(cfg, params, n=MOE_REQUESTS)
        plain = serve.engine(cfg, params, impl="plain", n=MOE_REQUESTS)
        m = cfg.moe
        rank = time_dispatch_rank(batch * seq, m.top_k, m.num_experts)
        torch.cuda.empty_cache()
        failures = []
        for launches in pre["launches"]:
            got = {k: v for k, v in launches.items() if v}
            if got != want:
                failures.append(f"prefill launched {got}, not {want}")
        if not pre["full"]["finite"]:
            failures.append("prefill logits not finite")
        if not pre["full"]["step_agrees"]:
            failures.append("the prefill step's token is not the argmax of "
                            "its logits")
        n_moe = want["radix_partition_rank"]
        n_reads = sum(want.values())
        if len(layers_["per_layer"]) != n_reads \
                or layers_["kinds"].count("moe") != n_moe:
            failures.append(f"the layer check read {layers_['kinds']}")
        if layers_["max"] > ROW_TOL:
            failures.append(f"layer reading {layers_['worst_layer']} "
                            f"({layers_['kinds'][layers_['worst_layer']]}) "
                            f"differs from its plain version by "
                            f"{layers_['max']} > {ROW_TOL}")
        for kind, c in controls.items():
            if not c > ROW_TOL:
                failures.append(f"the layer check read {c} on a faulty "
                                f"plain {kind}, not above {ROW_TOL}")
        if any(v for w in plain["waves"] for v in w["launches"].values()):
            failures.append("the plain engine launched a kernel")
        if eng["outs"] != plain["outs"]:
            failures.append("engine tokens differ from the plain engine's")
        if not (eng["lock_words_zero"] and plain["lock_words_zero"]):
            failures.append("the engine left slot locks held")
        if len(eng["outs"]) != MOE_REQUESTS:
            failures.append(f"the engine finished {len(eng['outs'])} "
                            "requests")
        emit("moe", arch=arch, cut=MOE_CUTS[arch], layers=cfg.num_layers,
             params=nparams, weights_bytes=nbytes, prefill=pre,
             layer_check=layers_, layer_check_held_to=ROW_TOL,
             engine={k: v for k, v in eng.items() if k != "outs"},
             engine_plain_s=plain["seconds"],
             tokens_equal=eng["outs"] == plain["outs"], dispatch_rank=rank,
             failures=failures, seconds=time.perf_counter() - t0, gpu=smi())
        if failures:
            raise AssertionError(f"moe {arch}: " + "; ".join(failures))
        for launches in pre["launches"]:
            _count(tuple(want), launches, record, f"moe {arch} prefill")
        for w in eng["waves"]:
            _count(("cas_lock",), w["launches"], record,
                   f"moe {arch} engine wave")
        del pre, eng, plain
        layer = None
        if arch == MESH_ARCH:
            mesh_leg(cfg, params, quick, record)
            layer = first_moe_layer(params)
        del params
        torch.cuda.empty_cache()
        if layer is not None:
            mesh_grad_leg(cfg, layer, quick)
            del layer
            torch.cuda.empty_cache()


def first_moe_layer(params) -> dict:
    """A copy of the first MoE layer's router and experts."""
    for block in params["groups"].values():
        for name, sub in block.items():
            if name.endswith("_moe"):
                return {k: sub[k][0].clone() for k in ("router", "wi", "wo")}
    raise ValueError("no MoE layer")


def mesh_grad_leg(cfg, layer, quick: bool):
    """The RRJ's backward at one MoE layer of MESH_ARCH at full width
    (its first, from the phase's weights) under the (2, 4) policy: a
    MESH_PREFILL (--quick: S 512) input, normal with an offset common to
    every token (so that assignments drop), and an output gradient in
    bf16 from seed 27 (``bench.serve.rrj_grad_check``).  The gradients of
    x, the router, wi and wo through the kernels must equal those through
    their plain twins to the bit; against the one-shard packed experts'
    autograd gradients, the output gradient zeroed at the tokens that
    dropped an assignment, each leaf within RRJ_GRAD_TOL (bf16 rounding
    of differently ordered sums); a packed layer with an expert dropped
    must read above it; the backward launches the scatter twice a shard
    (the transposed routes: the combine's and the un-bin's gathers) and
    no rank (the forward's plans are reused).  The line is printed before
    a failure is raised."""
    import torch
    from repro_torch.bench import serve
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import make_policy, set_policy
    t0 = time.perf_counter()
    mesh = make_host_mesh(*MESH_SHAPE, device="cuda")
    batch, seq = (MESH_PREFILL[0], 512) if quick else MESH_PREFILL
    shape = (batch, seq, cfg.d_model)
    gen = torch.Generator(device="cuda").manual_seed(27)
    # a small offset common to every token: the router favours some
    # experts a little, as trained routers do, so the capacity factor
    # drops a few assignments (0.4 % at 0.1 in a CPU simulation of this
    # routing; 61 % at 1.5, which leaves few clean tokens)
    x = (torch.randn(shape, generator=gen, device="cuda") + 0.1
         * torch.randn(cfg.d_model, generator=gen, device="cuda")
         ).to(torch.bfloat16)
    g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    with set_policy(make_policy(mesh)):
        chk = serve.rrj_grad_check(cfg, layer, x, g, tol=RRJ_GRAD_TOL)
    want = {"radix_partition_scatter": RRJ_PASSES * mesh.size}
    failures = []
    if not all(chk["kernel_equals_plain"].values()):
        failures.append(f"kernel RRJ gradients differ from the plain RRJ's: "
                        f"{chk['kernel_equals_plain']}")
    if not max(chk["vs_packed"].values()) <= RRJ_GRAD_TOL:
        failures.append(f"RRJ gradients against the packed experts' read "
                        f"{chk['vs_packed']} > {RRJ_GRAD_TOL}")
    if not max(chk["control"].values()) > RRJ_GRAD_TOL:
        failures.append(f"a dropped expert read {chk['control']}, not above "
                        f"{RRJ_GRAD_TOL}")
    if chk["backward_launches"] != want:
        failures.append(f"the backward launched {chk['backward_launches']}, "
                        f"not {want}")
    emit("moe_mesh_grad", arch=MESH_ARCH, mesh=mesh.shape, batch=batch,
         seq=seq, check=chk, failures=failures,
         seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("moe mesh grad: " + "; ".join(failures))


def phase_xattn(quick: bool, record: dict):
    """XATTN_ARCHS through src/repro_torch/bench/serve.py (--quick: the
    VLM at S=1024): bf16 weights drawn on the card from seed 0, modality
    features from seed 4.  Each timed prefill step must launch exactly its
    XATTN_ARCHS kernels: flash_attention once a causal self-attention
    layer, its non-causal calls once a cross layer and once a whisper
    encoder layer.  The layer check (every self, cross and encoder
    layer's kernel against its plain version on its own inputs, at every
    position) within ROW_TOL, and a faulty control (a dropped key tile)
    on the first group above it for each kind.  Then DECODE_STEPS greedy
    decode steps from init_decode_state(modality=): finite logits, no
    kernel launched (decode runs the plain chunked attention, the cross
    layers over the memory's caches).  For whisper also the f32
    full-depth witness, held within F32_LOGIT_TOL wherever the plain
    path's embedding nudge stays within it (phase serve's rule); the
    VLM's cut takes 43 GB of f32 weights and has none.  The phase line is
    printed before a failure is raised."""
    import torch
    from repro_torch.bench import serve
    from repro_torch.kernels import ops
    for arch, (layers, want) in XATTN_ARCHS.items():
        cfg = serve.config(arch, layers)
        batch, seq = serve.PREFILL[arch]
        if quick and cfg.family == "vlm":
            seq = 1024
        t0 = time.perf_counter()
        params = serve.weights(cfg, device="cuda")
        torch.cuda.synchronize()
        leaves = list(_leaves(params))
        nbytes = sum(t.numel() * t.element_size() for t in leaves)
        nparams = sum(t.numel() for t in leaves)
        del leaves
        pre = serve.prefill(cfg, params, batch=batch, seq=seq)
        dev = params["embed"].device
        tokens = serve.prompt(cfg, batch, seq, dev)
        mod = serve.modality(cfg, batch, dev)
        layers_ = serve.layer_check(cfg, params, tokens, modality=mod)
        with faulty_plain("flash_attention"):
            got = serve.layer_check(cfg, params, tokens, modality=mod,
                                    groups=1)
        layers_["control"] = {
            kind: max(r for r, kd in zip(got["per_layer"], got["kinds"])
                      if kd == kind) for kind in sorted(set(got["kinds"]))}
        del tokens, mod, got
        torch.cuda.empty_cache()
        pre["parent_kernel"] = prefill_turns(cfg, params, batch, seq)
        dec = serve.decode(cfg, params, batch=batch, steps=DECODE_STEPS)
        del params
        torch.cuda.empty_cache()
        f32 = None
        if cfg.family == "encdec":
            before = ops.launch_counts()
            f32 = serve.f32_witness(cfg, batch=batch, seq=seq,
                                    device="cuda")
            _count_f32("flash_f32", "flash_attention", before)
            _count_f32("flash_f32_noncausal", "flash_attention_noncausal",
                       before)
            f32["held"] = f32["nudged"]["max_abs_diff"] <= F32_LOGIT_TOL
            torch.cuda.empty_cache()
        failures = []
        for launches in pre["launches"]:
            got = {k: v for k, v in launches.items() if v}
            if got != want:
                failures.append(f"prefill launched {got}, not {want}")
        if not pre["full"]["finite"]:
            failures.append("prefill logits not finite")
        if not pre["full"]["step_agrees"]:
            failures.append("the prefill step's token is not the argmax of "
                            "its logits")
        kinds = {"flash_attention": want["flash_attention"],
                 "flash_noncausal": want["flash_attention_noncausal"]}
        if {k: layers_["kinds"].count(k) for k in kinds} != kinds \
                or len(layers_["kinds"]) != sum(kinds.values()):
            failures.append(f"the layer check read {layers_['kinds']}")
        if layers_["max"] > ROW_TOL:
            failures.append(f"layer reading {layers_['worst_layer']} "
                            f"({layers_['kinds'][layers_['worst_layer']]}) "
                            f"differs from its plain version by "
                            f"{layers_['max']} > {ROW_TOL}")
        if set(layers_["control"]) != set(kinds):
            failures.append(f"the control read {layers_['control']}")
        for kind, c in layers_["control"].items():
            if not c > ROW_TOL:
                failures.append(f"the layer check read {c} on a faulty "
                                f"plain {kind}, not above {ROW_TOL}")
        if not dec["finite"]:
            failures.append("decode logits not finite")
        if any(dec["launches"].values()):
            failures.append(f"decode launched {dec['launches']}")
        if f32 is not None:
            if not f32["kernel"]["finite"]:
                failures.append("f32 logits not finite")
            if f32["held"] and (f32["kernel"]["max_abs_diff"]
                                > F32_LOGIT_TOL
                                or f32["kernel"]["argmax_agree"] < 1):
                failures.append(
                    f"f32 full-depth logits differ from the plain path by "
                    f"{f32['kernel']['max_abs_diff']} (limit "
                    f"{F32_LOGIT_TOL}), argmax agreement "
                    f"{f32['kernel']['argmax_agree']}")
        emit("xattn", arch=arch, cut=XATTN_CUTS[arch], layers=cfg.num_layers,
             encoder_layers=cfg.encoder_layers or None, params=nparams,
             weights_bytes=nbytes, prefill=pre, layer_check=layers_,
             layer_check_held_to=ROW_TOL,
             decode={k: v for k, v in dec.items() if k != "tokens"},
             f32_full=f32, f32_held_to=F32_LOGIT_TOL, failures=failures,
             seconds=time.perf_counter() - t0, gpu=smi())
        if failures:
            raise AssertionError(f"xattn {arch}: " + "; ".join(failures))
        for launches in pre["launches"]:
            _count(tuple(want), launches, record, f"xattn {arch} prefill")
        del pre, dec


def _layer_check(cfg, params, tokens, kernel: str) -> dict:
    """bench.serve.layer_check at a training forward's shapes and dtypes
    (f32 masters, bf16 activations: the kernels' bf16 entries, which every
    training step launches): each layer's kernel against its plain version
    on that layer's own inputs, every position; and the same reading of
    the first layer with a faulty plain path (``faulty_plain``)."""
    import torch
    from repro_torch.bench import serve
    with torch.no_grad():
        out = serve.layer_check(cfg, params, tokens)
        with faulty_plain(kernel):
            out["control"] = serve.layer_check(cfg, params, tokens,
                                               groups=1)["max"]
    return out


def _grad_check(cfg, params, batch, kernel: str) -> dict:
    """Unclipped gradients of ``batch`` on the kernel path against the
    plain path (the functions the model trains through), leaf by leaf
    (``bench.train.leaf_check``: rms(diff) / rms(plain)).  The kernel
    path's launches here are a comparison's and count on no path.

    * ``f32``: both paths with f32 activations (the kernels' f32 entries):
      the autograd Functions' plumbing, held within ``limit`` = max(GRAD_TOL,
      2 ``spread``); a faulty plain path (``faulty_plain``) must read above
      it.  ``spread``: for flash_attention, the largest reading of the
      plain path with S rounded another sound way (``sound_plain``, each
      of SOUND_S: ``sound``) against the plain path; 0 for ssd_scan, which
      has no S.  At glm4's reference init (scaled scores of rms ~500) every
      sound rounding of S reads ~0.01 here, so GRAD_TOL alone would pass
      only the plain product's own summation order.
    * ``bf16``: bf16 activations, as training runs.  Each leaf's kernel
      path reading must lie within that leaf's ``rounding``: the plain
      path's bf16 gradient against its f32 gradient, the spread bf16
      rounding alone gives the plain path.  A fault smaller than that
      spread cannot show here (the faulty plain path's readings are
      reported, ``control_per_leaf``); the layer check holds the bf16
      kernels themselves."""
    import torch
    from repro_torch.bench import train as bt
    from repro_torch.models import lm
    from repro_torch.train.train_step import build_grad_step
    inf = float("inf")
    names = bt.leaf_names(params)

    def grads(**kw):
        g, m = build_grad_step(cfg, max_grad_norm=inf, **kw)(params, batch)
        return g, float(m["loss"]), float(m["grad_norm"])

    from repro_torch.kernels import ops
    saved = lm.ACT_DTYPE
    lm.ACT_DTYPE = torch.float32
    try:
        before = ops.launch_counts()
        gk, lk, nk = grads()
        _count_f32("flash_f32" if kernel == "flash_attention"
                   else "ssd_chunk_f32", kernel, before)
        gp32, lp, np_ = grads(impl="plain")
        chk = bt.leaf_check(gk, gp32)
        f32 = {"max": chk["max"], "worst_leaf": names[chk["worst_leaf"]],
               "loss": [lk, lp], "grad_norm": [nk, np_], "sound": {}}
        if kernel == "flash_attention":
            for variant in SOUND_S:
                with sound_plain(kernel, variant):
                    gv, _, _ = grads(impl="plain")
                f32["sound"][variant] = bt.leaf_check(gv, gp32)["max"]
                del gv
                torch.cuda.empty_cache()
        f32["spread"] = max(f32["sound"].values(), default=0.0)
        f32["limit"] = max(GRAD_TOL, 2 * f32["spread"])
        with faulty_plain(kernel):
            gf, _, _ = grads(impl="plain")
        f32["control"] = bt.leaf_check(gk, gf)["max"]
        del gk, gf
        torch.cuda.empty_cache()
    finally:
        lm.ACT_DTYPE = saved
    gk, lk, nk = grads()
    gp, lp, np_ = grads(impl="plain")
    per = bt.leaf_check(gk, gp)["per_leaf"]
    rounding = bt.leaf_check(gp, gp32)["per_leaf"]
    del gk, gp32
    torch.cuda.empty_cache()
    with faulty_plain(kernel):
        gf, _, _ = grads(impl="plain")
    ctl = bt.leaf_check(gf, gp)["per_leaf"]
    del gf, gp
    torch.cuda.empty_cache()
    ratio = [p / r if r > 0 else math.inf for p, r in zip(per, rounding)]
    worst = ratio.index(max(ratio))
    bf16 = {"leaves": names, "per_leaf": per, "rounding": rounding,
            "control_per_leaf": ctl, "max_ratio": ratio[worst],
            "worst_leaf": names[worst], "loss": [lk, lp],
            "grad_norm": [nk, np_], "f32_grad_norm": f32["grad_norm"][1]}
    return {"f32": f32, "bf16": bf16}


def _hold_train_checks(name: str, layers: dict, chk: dict, nlayers: int,
                       failures: list):
    """The failures of a model's layer check and gradient check."""
    if len(layers["per_layer"]) != nlayers:
        failures.append(f"{name} layer check read "
                        f"{len(layers['per_layer'])} kernel calls")
    if not layers["max"] <= ROW_TOL:
        failures.append(f"{name} layer {layers['worst_layer']}'s kernel "
                        f"differs from the plain path at training shapes "
                        f"by {layers['max']} > {ROW_TOL}")
    if not layers["control"] > ROW_TOL:
        failures.append(f"{name} layer check read {layers['control']} on a "
                        f"faulty plain path, not above {ROW_TOL}")
    f32, bf16 = chk["f32"], chk["bf16"]
    if not f32["max"] <= f32["limit"]:
        failures.append(f"{name} f32 gradients differ from the plain "
                        f"path's by {f32['max']} > {f32['limit']} (sound "
                        f"roundings of S: {f32['sound']})")
    if not f32["control"] > f32["limit"]:
        failures.append(f"{name} f32 gradient check read {f32['control']} "
                        f"on a faulty plain path, not above {f32['limit']}")
    if not bf16["max_ratio"] <= 1:
        failures.append(f"{name} bf16 gradient of {bf16['worst_leaf']} "
                        f"differs from the plain path's by "
                        f"{bf16['max_ratio']} times the spread of bf16 "
                        f"rounding")


def check_ps_route(cfg, stats: dict) -> dict:
    """The rank and the scatter at the wide body's path shapes: a PS
    push for ``cfg`` (S = 4 rows of the compressed payload's L/4 + L/256
    lanes, and of the raw payload's L lanes) and RDMA-AGG's flush at G =
    2^26 (4 rows of G lanes into one bucket; on 4 shards a shard's 16 rows
    of G/4 into 4 buckets, slots out of arrival order): bit-exact against
    ref, then timed beside the plain version and the bytes bound (rows
    read once, the buffer written once), and against index_copy_ in
    PS_ROUNDS turns of PS_CALLS calls each (``interleaved``: per-call
    medians of each round, and the ratio of their medians)."""
    import torch
    from repro_torch.analytics import row_layout
    from repro_torch.kernels import radix_partition as rp, ref
    from repro_torch.models import api
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(17)
    S, L = row_layout(sum(math.prod(s) for s in
                          _leaves(api.param_shapes(cfg))))
    G = 1 << 26
    push = torch.zeros((S,), dtype=torch.int32, device=dev)
    flush4 = torch.arange(SHARDS, dtype=torch.int32, device=dev).repeat(4)
    # name: (dest, n, cap, w)
    shapes = {"compressed": (push, 1, S, L // 4 + L // 256),
              "raw": (push, 1, S, L),
              "rdma_agg_flush": (torch.zeros((4,), dtype=torch.int32,
                                             device=dev), 1, 4, G),
              "rdma_agg_flush_4_shards": (flush4, SHARDS, 4, G // SHARDS)}
    out = {}
    for name, (dest, n, cap, w) in shapes.items():
        A = dest.shape[0]
        got = rp.rank(dest, n, cap)
        for x, y in zip(got, ref.rank(dest, n, cap)):
            if not torch.equal(x, y):
                raise AssertionError(f"radix rank differs at {name}: A={A}")
        slot, counts = got[0], got[3]
        rows = torch.randint(-2 ** 31, 2 ** 31 - 1, (A, w), generator=g,
                             device=dev, dtype=torch.int32)
        kb = rp.scatter(rows, slot, n * cap, counts=counts)
        pb = ref.scatter(rows, slot, n * cap, counts=counts)
        if not torch.equal(kb, pb):
            raise AssertionError(f"radix scatter differs at {name}: A={A} "
                                 f"w={w}")
        stats["scatter"] = max(stats["scatter"], _err(kb, pb))
        del kb, pb
        # the nearest PyTorch call: index_copy_ of the rows with their
        # valid lane into the wire buffer, at the rank's slots
        wide = torch.cat([rows, torch.ones((A, 1), dtype=torch.int32,
                                           device=dev)], 1)
        buf = torch.zeros((n * cap, w + 1), dtype=torch.int32, device=dev)
        slot64 = slot.to(torch.int64)

        def lib_copy():
            return buf.index_copy_(0, slot64, wide)

        def scatter():
            return rp.scatter(rows, slot, n * cap, counts=counts)
        # the card's copy rate at these bytes: the rows copied as they are
        flat = rows.view(-1)
        copy = torch.empty_like(flat)
        out[name] = {
            "A": A, "w": w, "n": n, "cap": cap,
            "ms": time_ms(scatter, iters=PS_CALLS),
            "device_ms": device_ms(scatter, rp.KERNELS["scatter"], iters=5),
            "host_ms": host_ms(scatter, iters=20),
            "plain_ms": time_ms(lambda: ref.scatter(rows, slot, n * cap,
                                                    counts=counts), iters=5),
            "bound_ms": bound_ms(A * w * 4 + A * 4
                                 + n * cap * (w + 1) * 4),
            "bound_by": "bytes",
            "library_ms": time_ms(lib_copy, iters=10),
            "library_host_ms": host_ms(lib_copy, iters=20),
            "copy_ms": time_ms(lambda: copy.copy_(flat), iters=10)}
        out[name]["bound_share"] = out[name]["bound_ms"] / out[name]["ms"]
        # the factor over index_copy_, settled: PS_ROUNDS rounds of
        # PS_CALLS calls of each, in turns (kernel, library, kernel, ...)
        turns = {"kernel_ms": [], "library_ms": []}
        for _ in range(PS_ROUNDS):
            turns["kernel_ms"].append(time_ms(scatter, iters=PS_CALLS))
            turns["library_ms"].append(time_ms(lib_copy, iters=PS_CALLS))
        turns["factor"] = (statistics.median(turns["kernel_ms"])
                           / statistics.median(turns["library_ms"]))
        out[name]["interleaved"] = turns
        del rows, wide, buf, flat, copy
        torch.cuda.empty_cache()
    return out


def phase_train(quick: bool, record: dict):
    """First the rank and the scatter at the PS push's shapes
    (check_ps_route).  Then the trainer (src/repro_torch/bench/train.py)
    at mamba2-370m's full config (--quick: 4 layers, S=512), f32 masters
    from seed 0, AdamW
    (cfg.optimizer), SyntheticLM batches of TRAIN_BATCH x TRAIN_SEQ, in
    each of TRAIN_MODES through Trainer.run: losses finite; ssd_scan
    launched twice a layer a step (forward and the remat recompute), the
    rank and the scatter once a push; the raw paramserver(staleness=0)
    losses equal allreduce's within PARITY_RTOL; the compressed
    paramserver(staleness=4) ends at epoch == steps with every push's
    route bytes bench.train.route_bytes(S, L, 256).  Then, on the
    trainer's first batch, the layer check (every layer's bf16 kernel
    against its plain version at the training shapes within ROW_TOL, a
    faulty plain path above it) and the gradient check (kernel vs plain
    path in f32 within max(GRAD_TOL, twice the spread that other sound
    roundings of S give the plain path), a faulty plain path above it; in
    bf16 within the spread of bf16 rounding, leaf by leaf), Fig 9 on the card
    (its rows equal to the CPU's), and glm4-9b at full width cut to 2
    layers: one build_grad_step on the kernel path (flash_attention twice
    a layer: forward and recompute) and the same two checks.  Each phase
    line is printed before a failure is raised."""
    import torch
    from repro_torch.bench import train as bt
    from repro_torch.kernels import ops
    from repro_torch.train.train_step import build_grad_step
    dev = torch.device("cuda")
    cfg = bt.config(TRAIN_ARCH, 4 if quick else None)
    seq = 512 if quick else TRAIN_SEQ
    ckpt = ROOT / "build" / "train_ckpt"
    ssd_a_step = 2 * cfg.num_layers
    failures, runs = [], {}
    t0 = time.perf_counter()
    err = {"scatter": 0}
    emit("train_ps_route", arch=cfg.name, **check_ps_route(cfg, err),
         max_abs_err=err, gpu=smi())
    for mode, compress, steps in TRAIN_MODES:
        r = bt.train(cfg, mode=mode, compress=compress, steps=steps,
                     batch=TRAIN_BATCH, seq=seq, device=dev, ckpt_dir=ckpt)
        torch.cuda.empty_cache()
        runs[mode] = r
        bad = []
        if len(r["losses"]) != steps or not all(
                math.isfinite(x) for x in r["losses"]):
            bad.append(f"losses {r['losses']}")
        ps = mode != "allreduce"
        want = {"ssd_scan": ssd_a_step * steps}
        if ps:
            want.update(radix_partition_rank=steps,
                        radix_partition_scatter=steps)
        got = {k: v for k, v in r["launches"].items() if v}
        if got != want:
            bad.append(f"launches {got}, expected {want}")
        if ps:
            rb = bt.route_bytes(r["num_shards"], r["shard_len"], 256,
                                compress)
            if r["epoch"] != steps:
                bad.append(f"epoch {r['epoch']} after {steps} pushes")
            if r["push_route_bytes"] != [rb] * steps:
                bad.append(f"push route bytes {r['push_route_bytes']}, "
                           f"expected {rb} each")
        failures += [f"train {mode}: {b}" for b in bad]
        emit("train", arch=cfg.name, layers=cfg.num_layers, **{
            k: v for k, v in r.items() if k not in ("fabric",)},
            gpu=smi())
        _count(tuple(want), r["launches"], record,
               f"train {cfg.name} {mode}")
    a = runs["allreduce"]["losses"]
    b = runs["paramserver(staleness=0)"]["losses"]
    parity = max(abs(x - y) / abs(y) for x, y in zip(a, b))
    if not parity <= PARITY_RTOL:
        failures.append(f"allreduce and paramserver(staleness=0) losses "
                        f"differ by {parity} relative (> {PARITY_RTOL})")
    del runs
    params = bt.masters(cfg, dev)
    batch = bt.first_batch(cfg, batch=TRAIN_BATCH, seq=seq, device=dev)
    layers = _layer_check(cfg, params, batch["tokens"], "ssd_scan")
    torch.cuda.empty_cache()
    chk = _grad_check(cfg, params, batch, "ssd_scan")
    del params, batch
    torch.cuda.empty_cache()
    _hold_train_checks(cfg.name, layers, chk, cfg.num_layers, failures)
    emit("train_grad_check", arch=cfg.name, layers=cfg.num_layers,
         batch=TRAIN_BATCH, seq=seq, parity_rel=parity,
         parity_rtol=PARITY_RTOL, layer_check=layers,
         layer_check_held_to=ROW_TOL, held_to=chk["f32"]["limit"], **chk,
         gpu=smi())
    # Fig 9 at the reference's sizes on the card: its rows depend on the
    # schedule and the counters, not on values, so they equal the CPU's
    from repro_torch.bench import fig9_ml
    ops.reset_launch_counts()
    extras = run_figure("fig9", device=dev)
    fig9_launches = ops.launch_counts()
    rows = [(r["name"], r["us_per_call"], r["derived"])
            for r in extras["rows"]]
    cpu_rows, _ = fig9_ml.run(device="cpu")
    if rows != cpu_rows:
        failures.append("fig9 rows on the card differ from the CPU's")
    emit("train_fig9", rows=rows, measured_s=extras["measured_s"],
         wallclock_s=extras["wallclock_s"], launches=fig9_launches,
         gpu=smi())
    _count(("radix_partition_rank", "radix_partition_scatter"),
           fig9_launches, record, "fig9")
    arch, layers, gb, gs = GLM_GRAD
    gcfg = bt.config(arch, layers)
    gs = 512 if quick else gs
    params = bt.masters(gcfg, dev)
    batch = bt.first_batch(gcfg, batch=gb, seq=gs, device=dev)
    step = build_grad_step(gcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    g, m = step(params, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t1
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(x).all()) for x in _leaves(g))
    del g
    torch.cuda.empty_cache()
    glayers = _layer_check(gcfg, params, batch["tokens"], "flash_attention")
    torch.cuda.empty_cache()
    gchk = _grad_check(gcfg, params, batch, "flash_attention")
    nparams = sum(x.numel() for x in _leaves(params))
    del params, batch
    torch.cuda.empty_cache()
    if launches["flash_attention"] != 2 * layers:
        failures.append(f"glm4 grad step launched flash_attention "
                        f"{launches['flash_attention']} times, not "
                        f"{2 * layers}")
    if not (finite and math.isfinite(float(m["loss"]))):
        failures.append("glm4 grad step not finite")
    _hold_train_checks(gcfg.name, glayers, gchk, layers, failures)
    emit("train_glm4_grad", arch=gcfg.name, layers=layers, batch=gb,
         seq=gs, params=nparams, step_s=step_s, peak_bytes=peak,
         step_loss=float(m["loss"]), launches=launches,
         layer_check=glayers, layer_check_held_to=ROW_TOL,
         held_to=gchk["f32"]["limit"], **gchk,
         failures=failures, seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("train: " + "; ".join(failures))
    _count(("flash_attention",), launches, record, f"train {arch} grad")
    record["ssd_scan"]["paths"] += f", train {cfg.name}"
    record["flash_attention"]["paths"] += f", train {arch} grad"
    for name in ("radix_partition_rank", "radix_partition_scatter"):
        record[name]["paths"] += ", train paramserver, fig9"


def _scale_point(fs, W, s, *, sizes: dict, record: dict, path: str,
                 keep_db: bool = False) -> dict:
    """One real-size fig_scale point on the card: the grouped wave with
    its launches counted between a reset and a read, the accounting and
    read-back checks, then the same wave again under torch.profiler."""
    import torch
    from repro_torch.bench import profile_commit
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    st, sets, att, tids, run = fs.run_economics(W, s, device="cuda",
                                                keep=True, **sizes)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, path)
    sessions = [x for g in run["groups"] for x in g]
    final_aborts = sum(int((~m).sum()) for m in run["masks"])
    if st["commits"] + final_aborts != len(sessions):
        raise AssertionError(f"{path}: commits {st['commits']} + final "
                             f"aborts {final_aborts} != {len(sessions)}")
    t1 = time.perf_counter()
    readback = fs.read_back(run["db"], sessions)
    t2 = time.perf_counter()
    prof = []
    fs.run_economics(W, s, device="cuda", sets=sets,
                     around=lambda: profile_commit._profiled(prof), **sizes)
    out = {"W": W, "skew": s, "sessions": len(sessions),
           "rounds": max(max(a) for a in att), "txn_stats": st,
           "final_aborts": final_aborts, "host_s": run["host_s"],
           "device": {k: prof[0][k] for k in ("device_s", "port_kernels_s",
                                               "device_ops", "by_kernel")},
           "launches": {k: v for k, v in launches.items() if v},
           "readback": readback,
           "seconds": {"run": t1 - t0, "readback": t2 - t1,
                       "profiled_run": time.perf_counter() - t2}}
    return out, (st, sets, att, tids), (run if keep_db else None)


def phase_scale(quick: bool, record: dict):
    """fig_scale (src/repro_torch/bench/fig_scale.py) on the card.

    (a) at the JAX benchmark's sizes (4096 one-word records, 8
    transactions of 2 writes a worker, max_retries 3; --quick: W in 4, 8,
    32): every point on the kernel path and on the plain path, whose
    txn_stats, attempts, transaction ids, committed masks and store
    leaves must be equal, and whose economics must equal a CPU run's
    (which the CPU tests hold to the JAX benchmark); then the three
    panels with the JAX benchmark's asserts.  At the real size, the paper's §4.3 store (1 000 000 records
    of 256 words; 64 transactions a worker, so T = 4096 at W = 64):
    every point's launches counted between a reset and a read, its
    committed writes read back, commits + final aborts == sessions, the
    host seconds of its grouped wave (retry waves included) and the
    device time of the same wave profiled; at W = 64, zipf 1.2 the store
    and txn_stats equal the plain path's.  Then panels (b) and (c) on the
    real-size traces, each install WRITE carrying the real row (1028 B),
    with the simulator's own host seconds."""
    import numpy as np
    import torch
    from repro_torch.bench import checkout, fig_scale as fs
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    workers = (4, 8, 32) if quick else fs.WORKERS
    profiles = fs.DEFAULT_PROFILES

    # (a) at the JAX benchmark's sizes: the kernel path against the plain
    ops.reset_launch_counts()
    kern = {sn: {W: fs.run_economics(W, s, device="cuda", keep=True)
                 for W in workers} for sn, s in fs.SKEWS.items()}
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, "scale at JAX's sizes")
    diffs = []
    for sn, s in fs.SKEWS.items():
        for W in workers:
            p = fs.run_economics(W, s, device="cuda", impl="plain",
                                 keep=True)
            c = fs.run_economics(W, s, device="cpu")
            k = kern[sn][W]
            same = (k[0] == p[0] == c[0] and k[2] == p[2] == c[2]
                    and k[3] == p[3] == c[3]
                    and all(np.array_equal(a, b) for a, b in
                            zip(k[4]["masks"], p[4]["masks"]))
                    and fs.store_equal(k[4]["db"], p[4]["db"]))
            if not same:
                diffs.append(f"{sn} W={W}")
    if ops.launch_counts() != launches:
        raise AssertionError("the plain runs launched a kernel")
    if diffs:
        raise AssertionError(f"scale: the kernel path differs from the "
                             f"plain path or the CPU at {diffs}")
    t_equal = time.perf_counter() - t0
    econ = {sn: {W: kern[sn][W][:4] for W in workers} for sn in kern}
    del kern
    # the figure through the harness on these economics: the panels and
    # their asserts, the locality run and the timed grouped waves
    ts = time.perf_counter()
    ops.reset_launch_counts()
    fig = run_figure("fig_scale", workers=workers, econ=econ)
    fig_launches = ops.launch_counts()
    _count(OLTP_KERNELS, fig_launches, record,
           "scale figure (locality, timed waves)")
    emit("scale_jax_size", workers=list(workers),
         abort_rate=fig["abort_rate"], throughput=fig["throughput"],
         locality=fig["locality"], rows=fig["rows"],
         measured_s=fig["measured_s"], plain_equal=True, cpu_equal=True,
         launches={k: v for k, v in launches.items() if v},
         figure_launches={k: v for k, v in fig_launches.items() if v},
         figure_s=time.perf_counter() - ts, equal_check_s=t_equal,
         seconds=time.perf_counter() - t0, gpu=smi())

    # the real size: the oltp phase's store
    records, words, txns = (SCALE_QUICK if quick else
                            (checkout.PRODUCTS, checkout.PAYLOAD_WORDS,
                             SCALE_TXNS))
    sizes = {"records": records, "payload_words": words,
             "txns_per_worker": txns}
    real, kept = {}, None
    for sn, s in fs.SKEWS.items():
        real[sn] = {}
        for W in workers:
            keep = sn == "zipf12" and W == max(workers)
            point, econ_pt, run = _scale_point(
                fs, W, s, sizes=sizes, record=record,
                path=f"scale {sn} W={W}", keep_db=keep)
            real[sn][W] = econ_pt
            if keep:
                kept = run
            emit("scale_point", **sizes, **point, gpu=smi())
            torch.cuda.empty_cache()
    plain = fs.run_economics(max(workers), fs.SKEWS["zipf12"], device="cuda",
                             impl="plain", keep=True,
                             sets=real["zipf12"][max(workers)][1], **sizes)
    if not (plain[0] == real["zipf12"][max(workers)][0]
            and fs.store_equal(kept["db"], plain[4]["db"])):
        raise AssertionError("scale: the real-size zipf12 wave differs from "
                             "the plain path")
    del kept, plain
    torch.cuda.empty_cache()
    rows = []
    ts = time.perf_counter()
    tput = fs.throughput_panel(real, workers, profiles, rows,
                               records=records,
                               row_bytes=fs.row_bytes(words))
    sim_b = time.perf_counter() - ts
    ops.reset_launch_counts()
    loc = fs.run_economics(fs.LOCALITY_WORKERS, fs.SKEWS["zipf12"],
                           shared=False, device="cuda", **sizes)
    loc_launches = ops.launch_counts()
    _count(OLTP_KERNELS, loc_launches, record, "scale locality, real size")
    ts = time.perf_counter()
    locality = fs.locality_panel(loc, profiles, rows, records=records,
                                 row_bytes=fs.row_bytes(words))
    sim_c = time.perf_counter() - ts
    emit("scale", **sizes, row_bytes=fs.row_bytes(words),
         workers=list(workers),
         abort_rate={sn: {str(W): real[sn][W][0]["abort_rate"]
                          for W in workers} for sn in real},
         throughput=tput, locality=locality, rows=rows,
         plain_equal_at=f"zipf12 W={max(workers)}",
         sim_host_s={"throughput": sim_b, "locality": sim_c},
         seconds=time.perf_counter() - t0, gpu=smi())


def phase_contention(quick: bool, record: dict):
    """Fig 10 (src/repro_torch/bench/fig10_contention.py) on the card.

    (a) the window sweep, WRITE against SEND, with the JAX benchmark's
    asserts.  (b) the planner prices the paper's §5.4 join (R and S of
    128 000 000 tuples, sel 0.25; --quick: 2^22) at loads 0, 8 and 64 and
    must flip on the RDMA profile.  (c) one GHJ and one RRJ over those
    relations, each recorded through an EventTracer on the kernel path
    (launches counted between a reset and a read) and on the plain path:
    the traces must be equal event for event and the joins equal to the
    ground truth with no dropped row; each trace is replayed on every
    profile (lower bound <= makespan; the window-1 replay equal to the
    analytic sum).  Fig 8a's replay row is printed beside it.  Then
    fabric-check on the card: every suite of repro_torch.fabric.check
    (0 violations), and one 4096-session checkout wave of the oltp store
    through a ScheduleRecorder (launches counted), race-checked: 0
    violations, its access and fence counts and the checker's host
    seconds."""
    import dataclasses as dc
    import torch
    from repro_torch.bench import checkout, fig8a_joins
    from repro_torch.bench import fig10_contention as f10
    from repro_torch.db import Database
    from repro_torch.fabric import LocalTransport, check, netsim
    from repro_torch.kernels import ops
    from repro_torch.configs import OLTP
    t0 = time.perf_counter()
    n = OLAP_QUICK_N if quick else OLAP_N
    # the figure at the JAX benchmark's sizes through the harness: the
    # window sweep, the planner's crossover, a recorded workload replayed
    fig10 = run_figure("fig10")
    windows = fig10["windows"]
    rows = []

    rk, rv, sk, sv = fig8a_joins.relations(f10.JOIN_SEL, n, device="cuda")
    truth = fig8a_joins.ground_truth(sk, n)
    dbs = {impl: Database(device="cuda", impl=impl,
                          net=f10.DEFAULT_PROFILES[0])
           for impl in (None, "plain")}
    for d in dbs.values():
        d.create_table("R", n, payload_words=1, partitioning="hash")
        d.create_table("S", n, payload_words=1, partitioning="hash")
        d.table("R").load(rk, rv)
        d.table("S").load(sk, sv)
    del rk, rv, sk, sv
    db = dbs[None]
    crossover = f10.planner_rows(db, f10.join_query(db), f10.DEFAULT_PROFILES,
                                 rows)
    profiles = sorted(netsim.PROFILES)
    traces, replay, joins = {}, {}, {}
    for v in CONTENTION_VARIANTS:
        ops.reset_launch_counts()
        t1 = time.perf_counter()
        trace, res = f10.record_join(db, f10.join_query(db), v)
        torch.cuda.synchronize()
        join_s = time.perf_counter() - t1
        launches = ops.launch_counts()
        _count(JOIN_KERNELS, launches, record, f"contention {v}")
        before = ops.launch_counts()
        ptrace, pres = f10.record_join(dbs["plain"],
                                       f10.join_query(dbs["plain"]), v)
        if launches_since(before) != {k: 0 for k in before}:
            raise AssertionError("the plain join launched a kernel")
        value = int(res.value) & 0xFFFFFFFF
        if value != truth or res.dropped != 0 or \
                int(pres.value) & 0xFFFFFFFF != truth:
            raise AssertionError(f"contention {v}: value {value} (truth "
                                 f"{truth}), dropped {res.dropped}")
        if [dc.astuple(e) for e in trace] != [dc.astuple(e) for e in ptrace]:
            raise AssertionError(f"contention {v}: the kernel path's trace "
                                 "differs from the plain path's")
        ts = time.perf_counter()
        replay[v] = f10.replay_rows(trace, profiles, rows, v)
        joins[v] = {"events": [dc.asdict(e) for e in trace],
                    "join_s": join_s, "replay_host_s":
                    time.perf_counter() - ts,
                    "launches": {k: x for k, x in launches.items() if x},
                    "value": value, "trace_equal_plain": True}
    del db, dbs
    torch.cuda.empty_cache()
    emit("contention", n=n, sel=f10.JOIN_SEL, windows=windows,
         fig10={k: fig10[k] for k in ("rows", "crossover", "replay",
                                      "measured_s")},
         crossover=crossover, replay=replay, joins=joins, rows=rows,
         fig8a_replay=fig8a_joins.replay_row(n), gpu=smi())

    # fabric-check on the card
    ts = time.perf_counter()
    reports = check.check_all("cuda")
    summ = check.summarize(reports)
    suites_s = time.perf_counter() - ts
    rec = check.ScheduleRecorder()
    cdb = Database(LocalTransport(recorder=rec, device="cuda"))
    size = {"products": checkout.PRODUCTS,
            "payload_words": checkout.PAYLOAD_WORDS}
    checkout.create_table(cdb, waves=1, T=MAIN_T, **size)
    rec.declare_locks("products/words", ("products/payload",
                                         "products/cids"), lock_bit=1 << 31)
    plan = checkout.plan(seed=7, waves=1, T=MAIN_T, **size)
    ops.reset_launch_counts()
    tw = time.perf_counter()
    ss = checkout.sessions(cdb, plan[0])
    mask = cdb.commit(ss, max_retries=2)
    torch.cuda.synchronize()
    wave_s = time.perf_counter() - tw
    launches = ops.launch_counts()
    _count(OLTP_KERNELS, launches, record, "contention recorded wave")
    tc = time.perf_counter()
    rep = check.check_schedule(rec, target=f"sessions/checkout[T={MAIN_T}]")
    check_s = time.perf_counter() - tc
    wave = {"sessions": len(ss), "committed": int(mask.sum()),
            **rec.summary(), "violations": [str(v) for v in rep.violations],
            "record_wave_s": wave_s, "check_host_s": check_s,
            "launches": {k: v for k, v in launches.items() if v}}
    del cdb, rec
    torch.cuda.empty_cache()
    emit("contention_check", targets=len(reports),
         rules=len(summ["rules_run"]), violations=summ["violations"],
         exemptions=summ["exemptions"], suites_host_s=suites_s, wave=wave,
         oltp_width={"products": OLTP.num_products,
                     "record_bytes": OLTP.record_bytes},
         seconds=time.perf_counter() - t0, gpu=smi())
    if summ["violations"] or not rep.ok or len(reports) != CHECK_TARGETS:
        raise AssertionError(f"fabric-check on the card: {len(reports)} "
                             f"targets, {summ['violations']} "
                             f"{wave['violations']}")


def phase_figures(quick: bool, record: dict):
    """The benchmark harness of the port (src/repro_torch/bench/run.py):
    its main, in this process, with --only F --time --check --json for
    each of FIGURES on the card.  Each figure's own run (not its check)
    is counted between a reset and a read and must launch exactly
    FIGURE_KERNELS[F]: fig2 is a path of its own (the cas_lock kernel
    through fabric.verbs.cas, the rank and the scatter through a 64K
    route).  Every BENCH_<figure>.json of the run (these five and those
    that phases train, paged, scale and contention wrote) must parse with
    JAX's keys and a measured_s for each measured row; the five, 0
    fabric-check violations; fig7's rows must equal a CPU run's, fig2's
    modeled rows too.  Then the four example twins on the card at their
    small sizes: quickstart (reduce_config), nam_oltp (10 000 products,
    8 waves of T 512: commits + aborts == sessions), serve_lm (every
    lock word 0 after release) and train_lm --tiny --steps 10 into a
    temporary checkpoint folder, run twice (finite losses; the second
    restores and resumes at step 10)."""
    import torch
    from repro_torch.bench import fig2_microbench
    from repro_torch.bench import run as bench_run
    from repro_torch.examples import nam_oltp, quickstart, serve_lm, train_lm
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    counts, secs, failures = {}, {}, []

    @contextlib.contextmanager
    def around(name):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        yield
        torch.cuda.synchronize()
        counts[name] = ops.launch_counts()

    for name in FIGURES:
        ts = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            try:
                bench_run.main(["--only", name, "--time", "--check",
                                "--json", str(fig_dir())], around=around)
            except SystemExit as e:
                failures.append(f"{name}: {e}")
        secs[name] = time.perf_counter() - ts
    payloads = {}
    for path in sorted(fig_dir().glob("BENCH_*.json")):
        name = path.stem[len("BENCH_"):]
        payloads[name] = json.loads(path.read_text())
        failures += payload_failures(name, payloads[name],
                                     checked=name in FIGURES)
    missing = set(FIGURES) - set(payloads)
    if missing:
        failures.append(f"no BENCH json for {sorted(missing)}")
    cpu7 = bench_run.run_figure("fig7", device="cpu", out=io.StringIO())
    if "fig7" in payloads and payloads["fig7"]["rows"] != cpu7["rows"]:
        failures.append("fig7's rows differ from the CPU's")
    cpu2, _ = fig2_microbench.run(device="cpu")
    model2 = [{"name": r, "us_per_call": us, "derived": d}
              for r, us, d in cpu2 if "/model_" in r]
    if "fig2" in payloads and [r for r in payloads["fig2"]["rows"]
                               if "/model_" in r["name"]] != model2:
        failures.append("fig2's modeled rows differ from the CPU's")
    for name in FIGURES:
        got = {k: v for k, v in counts.get(name, {}).items() if v}
        if set(got) != set(FIGURE_KERNELS[name]):
            failures.append(f"{name} launched {got}, expected "
                            f"{FIGURE_KERNELS[name]}")
    emit("figures", seconds_by_figure=secs,
         launches={n: {k: v for k, v in c.items() if v}
                   for n, c in counts.items()},
         files=sorted(payloads),
         rows={n: len(p["rows"]) for n, p in payloads.items()},
         measured_s={n: p.get("measured_s") for n, p in payloads.items()},
         fig2_rows=payloads.get("fig2", {}).get("rows"),
         violations={n: len(p.get("check", {}).get("violations", []))
                     for n, p in payloads.items() if n in FIGURES},
         cards=sorted({p.get("card") for p in payloads.values()} - {None}),
         failures=failures, seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("figures: " + "; ".join(failures))
    for name in FIGURES:
        if FIGURE_KERNELS[name]:
            _count(FIGURE_KERNELS[name], counts[name], record,
                   f"figures {name}")
        for k in FIGURE_KERNELS[name]:
            record[k]["paths"] += ", fig2" if name == "fig2" else \
                f", figures {name}"

    # the example twins on the card
    te = time.perf_counter()
    out = {}
    with contextlib.redirect_stdout(io.StringIO()) as printed, \
            tempfile.TemporaryDirectory(prefix="train_lm_") as ckpt:
        out["quickstart"] = quickstart.main([])
        out["nam_oltp"] = nam_oltp.main([])
        out["serve_lm"] = serve_lm.main([])
        targs = ["--tiny", "--steps", str(EXAMPLE_TRAIN_STEPS),
                 "--ckpt-dir", ckpt]
        out["train_lm"] = train_lm.main(targs)
        out["train_lm_resumed"] = train_lm.main(targs)
    q, o, v = out["quickstart"], out["nam_oltp"], out["serve_lm"]
    t1, t2 = out["train_lm"], out["train_lm_resumed"]
    if not (math.isfinite(q["loss"]) and q["db"]["committed"]
            and q["ps"]["epoch_after"] == q["ps"]["epoch_before"] + 1):
        failures.append(f"quickstart {q}")
    st = o["txn_stats"]
    if st["commits"] + st["aborts"] != o["sessions"] or \
            st["commits"] != o["committed"]:
        failures.append(f"nam_oltp: {st} over {o['sessions']} sessions")
    if any(v["slot_words"]) or len(v["outs"]) != 8:
        failures.append(f"serve_lm: lock words {v['slot_words']}, "
                        f"{len(v['outs'])} requests")
    if not (t1["finite"] and t1["step"] == EXAMPLE_TRAIN_STEPS
            and not t1["resumed"] and t1["log"]):
        failures.append(f"train_lm: {t1}")
    if not (t2["resumed"] and t2["start_step"] == EXAMPLE_TRAIN_STEPS):
        failures.append(f"train_lm resumed: {t2}")
    emit("figures_examples", quickstart={k: q[k] for k in (
             "arch", "params", "loss", "grad_norm", "decoded", "db", "ps")},
         nam_oltp={k: o[k] for k in ("sessions", "committed", "seconds",
                                     "txn_stats", "read_timestamp")},
         serve_lm=v, train_lm={"first": t1, "resumed": t2},
         printed_lines=printed.getvalue().count("\n"),
         seconds=time.perf_counter() - te, failures=failures,
         phase_seconds=time.perf_counter() - t0, gpu=smi())
    if failures:
        raise AssertionError("figures: " + "; ".join(failures))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ---------------------------------------------------------------- main ---

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--quick", action="store_true",
                    help="small sweep, 2 waves, serve at 4 layers and "
                    "S=1024, train at 4 layers and S=512 (a first look "
                    "only)")
    ap.add_argument("--out", default=None,
                    help="also append every phase line to this file")
    ap.add_argument("--parent", default=None,
                    help="an unpacked git archive of an earlier tree: "
                    "phase kernels times its flash kernel beside this "
                    "tree's")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    PARENT["dir"] = args.parent
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found next to the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.costmodel import H100
    global HBM_BYTES_PER_S, BF16_FLOP_PER_S, F32_FLOP_PER_S, TF32_FLOP_PER_S
    HBM_BYTES_PER_S, BF16_FLOP_PER_S = H100.hbm_bw, H100.peak_flops_bf16
    F32_FLOP_PER_S, TF32_FLOP_PER_S = H100.peak_flops_f32, H100.peak_flops_tf32
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        _OUT.append(open(args.out, "a"))
    record = {
        "radix_partition_rank": {
            "source": "src/repro_torch/kernels/csrc/radix_partition.cu",
            "replaces": "src/repro/kernels/radix_partition.py:59"},
        "radix_partition_scatter": {
            "source": "src/repro_torch/kernels/csrc/radix_partition.cu",
            "replaces": "src/repro/kernels/radix_partition.py:59"},
        "cas_lock": {
            "source": "src/repro_torch/kernels/csrc/cas_lock.cu",
            "replaces": "src/repro/kernels/cas_lock.py:53"},
        "grouped_agg": {
            "source": "src/repro_torch/kernels/csrc/grouped_agg.cu",
            "replaces": "src/repro/kernels/grouped_agg.py:41"},
        "grouped_sum_u32": {
            "source": "src/repro_torch/kernels/csrc/grouped_agg.cu",
            "replaces": "src/repro/kernels/grouped_agg.py:41"},
        "flash_attention": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:67"},
        "flash_attention_noncausal": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:67"},
        "flash_attention_mla": {
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:67"},
        "ssd_scan": {
            "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan.py:55"},
        "hash_join": {
            "source": "src/repro_torch/kernels/csrc/hash_join.cu",
            "replaces": "none (jnp.sort + searchsorted in "
                        "src/repro/core/shuffle.py)"},
    }
    paths = {"radix_partition_rank": "oltp, olap, moe prefill (expert "
                                     "packing), moe deepseek-v2-236b mesh "
                                     "prefill and decode (RRJ), scale, "
                                     "contention",
             "radix_partition_scatter": "oltp, olap, moe deepseek-v2-236b "
                                        "mesh prefill and decode (RRJ), "
                                        "scale, contention",
             "cas_lock": "oltp, serve and moe engine waves, paged ticks, "
                         "scale, contention recorded wave",
             "grouped_agg": "fig8b kernel row", "grouped_sum_u32": "olap",
             "flash_attention": "serve glm4-9b prefill, moe llama4 and "
                                "jamba prefill, xattn llama-3.2-vision and "
                                "whisper-base prefill (self-attention)",
             "flash_attention_noncausal": "xattn llama-3.2-vision prefill "
                                          "(cross layers), whisper-base "
                                          "prefill (encoder and cross "
                                          "layers)",
             "flash_attention_mla": "moe deepseek-v2-236b prefill",
             "ssd_scan": "serve mamba2-370m prefill, moe jamba prefill",
             "hash_join": "olap (every join's local join), contention"}
    for name, r in record.items():
        r.update(route="cuda", launches=0, paths=paths[name])
    try:
        run_phases(args, phases, record)
    finally:
        for d in _FIG_DIR:
            shutil.rmtree(d, ignore_errors=True)
    if any(F32.values()):
        emit("f32_entries", **F32, gpu=smi())
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "paths")
    print(json.dumps({"kernels": [
        {k: ({"name": name, **r}).get(k) for k in keys}
        for name, r in record.items()]}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(args, phases, record):
    if "env" in phases:
        phase_env()
    if "build" in phases:
        phase_build()
    if "kernels" in phases:
        phase_kernels(args.quick, record)
    if "oltp" in phases:
        phase_oltp(args.quick, record)
    if "olap" in phases:
        phase_olap(args.quick, record)
    if "fig6" in phases:
        phase_fig6(args.quick)
    if "serve" in phases:
        phase_serve(args.quick, record)
    if "moe" in phases:
        phase_moe(args.quick, record)
    if "xattn" in phases:
        phase_xattn(args.quick, record)
    if "paged" in phases:
        phase_paged(args.quick, record)
    if "shards" in phases:
        phase_shards(args.quick, record)
    if "train" in phases:
        phase_train(args.quick, record)
    if "scale" in phases:
        phase_scale(args.quick, record)
    if "contention" in phases:
        phase_contention(args.quick, record)
    if "figures" in phases:
        phase_figures(args.quick, record)


if __name__ == "__main__":
    sys.exit(main())
