#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of DRAGON on one GPU, end to end.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):

1. environment — torch, CUDA and nvcc versions, the card's name and power limit;
2. build — compile every kernel under src/repro_torch/kernels/csrc with nvcc
   for sm_90a (one process per source, in parallel), check the binaries hold
   sm_90a code, and count the tensor-core (HGMMA) and TMA (UTMALDG)
   instructions in the bf16 attention kernel's SASS, which must hold both;
3. kernels — each CUDA kernel against its plain PyTorch version on the card,
   on inputs from seeded torch.Generators (one for each kernel), at the shapes
   the main paths give it (K1: the mapper's fused carries, forward and
   backward, their clamp codes equal to the plain version's, and the bare
   affine scan; attention: each call must launch the kernel that
   ``flash_attention.route`` names for its dtype and head width, at head
   widths from 8 to 256 in float32 and bf16; the SSD scan
   in float32: the kernel and its plain version each against the float64
   recurrence on 8 draws; the selective scan at each prompt length the serving
   path gives it, its float64 error printed; popsim bit for bit at 512 and
   65,536 designs, timed at both); each one's device time per call
   (torch.profiler over many calls), its plain version's, and for attention the
   time of PyTorch's scaled_dot_product_attention on the same inputs (a
   yardstick the port never calls), the float32-pipe kernel timed at
   [1,32,4096,64] and [1,32,4096,128] in float32, the tensor-core kernel at the
   dense families' q [1,32,4096,128] over 8 KV heads and at kimi-k2's heads
   (q [1,64,4096,112], k and v [1,8,4096,112]); attention also at the
   transformer families' shapes: the vision model's cross-attention (not
   causal, 1,601 patches) in prefill and at one query a decode step,
   llama4-scout's GQA group 5, musicgen's MHA at D 64, kimi-k2's 64 heads of
   112 over 8 at the engine's prompt buckets; the scans' backwards
   (plain PyTorch from the state entering each of the kernel's chunks) on the
   card against the same functions on the CPU (computed on a host thread
   while the phase runs) at falcon-mamba's layer (u [1,4096,8192], N 16) and
   zamba2's (x [1,4096,64,64], N 64) in bf16 and float32, K5's entering
   states against its plain version's, each backward's time and memory, and
   K5's time with and without the entering-state output, in turns;
4. the simulator path, with the launch counts set to 0 just before and read
   just after (K1, K2 and, on the no-gradient calls, the mapper's two kernels
   around K1 must run on it; on the DSE, session and design paths as well):
   a. simulate the 16 workloads of results/bench/sim_speed.json at the default
      design, each padded to its vertex bucket (next power of two, >= 32),
      with the default MapperCfg(), and hold cycles against ``cycles_dsim``;
   b. optimize 20 DOpt steps on the stack of the 5 LM cells (V = 1024) and
      hold the history against the reference package's (constants below);
   c. 3 steps on the 11 classic workloads (bucket 256) with scan_impl="ref"
      and with the default, which must agree;
   d. with MapperCfg(streaming=False), where the occupancy carry decides
      cycles, the default cycles of the 11 classic workloads and of
      qwen2.5-32b:prefill_32k against scan_impl="ref" (rtol 1e-5);
   e. evaluate a population of 65,536 designs on qwen2.5-32b:prefill_32k and
      hold the default design's cycles against the simulator's (the phase's
      wall time printed);
5. the DSE path, with the launch counts set to 0 just before and read just
   after (K1 forward and backward must run on it):
   a. the 7 library archs of the .dhd language compiled on the card, each
      serialized, re-parsed and re-serialized byte-identically;
   b. DSim cycles on base, datacenter and edge for the 11 workloads of
      tests/test_refsim_accuracy.py against the float64 cycle walker
      (``refsim.reference_simulate``) at that file's tolerances;
   c. population_chunk against sequential optimize(fused=True) runs (4
      jittered members, one-hot edp; one mixed member with a binding budget),
      rtol 1e-5;
   d. benchmarks/bench_pareto.py's full configuration (32 members, 24 steps,
      3 workloads, 5 seeds) through ``pareto_dse`` with the draws of
      tests/data/torch_pareto_ref.npz (made by tools/make_torch_pareto_ref.py
      from the reference package) against that fixture at rtol 1e-3, every
      winner's .dhd re-parsed bit for bit, and the descent's member-epochs/s;
   e. 1,024 members on the LM stack [5, 1024], 8 epochs: member-epochs/s,
      peak device memory, K1's launches, every member finite or frozen, and
      member 0 against sequential optimize(objective="mixed") at rtol 1e-4;
   then the bare affine scan's own path: the package's public ``affine_scan``,
   forward and backward, on the LM stack's bandwidth input, held against the
   fused kernel's bw_prev;
6. the session path, with the launch counts set to 0 just before and read
   just after (K1 forward and backward must run on it): the ``Session``
   façade (``repro_torch.api``) over the same engines, every reply held bit
   for bit against the engine call on the same stack:
   a. the 16 workloads of results/bench/sim_speed.json through
      ``Session("base").simulate`` at their buckets (cycles within rtol 1e-5
      of ``cycles_dsim``), and ``Session.perf`` against simulate_stacked;
   b. ``explain`` on the LM stack [5, 1024] against a direct autograd.grad,
      and ``optimize`` (20 steps) against dopt.optimize;
   c. ``frontier`` at bench_pareto.py's configuration with the DSE path's
      draws against pareto_dse;
   d. the 5 LM cells as 5 simulate_batch and explain_batch queries at
      request_bucket=8, equal as to_json text alone, together and reversed;
   e. warm calls (the same workload, another of its bucket, another design
      point) build nothing (``core.instrument``); the first reply, the warm
      medians of simulate and explain and simulate_batch's queries/s printed;
7. the design path, with the launch counts set to 0 just before and read just
   after (K1 forward and backward must run on it): the design-serving tier
   (``repro_torch.serving``) at benchmarks/bench_serving.py's traffic, seed
   20260808, request bucket 16:
   a. its 1,200-query design stream (simulate and explain over lstm,
      merge_sort, gcn and stencil2d at (1, 32) across base, edge, datacenter
      and mobile) and 80 queries on the 5 LM cells at (1, 1024), through
      ``DesignService`` one at a time and ``BatchingDesignService`` (flush at
      16 queries or 5 ms) by enqueue and flush: every query ok within its
      deadline, batched replies equal to sequential ones as to_json text,
      sampled replies equal to ``Session.simulate_batch`` / ``explain_batch``
      alone; queries/s, p50/p99 reply ms and batches printed;
   b. its four chaos gates on the batched service over 96 queries (an
      optimize at 6 steps every 24): isolation, availability exactly 1.0
      under transient-class chaos, clean replies bit-identical to the no-chaos
      run under full chaos (availability >= 0.99), an identical seeded
      replay; the schedules equal to tests/data/torch_chaos_schedule.json
      (made by tools/make_torch_chaos_schedule.py from the reference package);
   c. a restart: two fresh processes over one temporary cache_dir, the first
      warming up lstm and an LM cell and serving 8 queries, the second serving
      them after construction alone with zero builds and zero misses,
      disk_loaded equal to the first's persisted, replies equal as to_json
      text and its first query predicted warm;
   then the pool path (the tier past one thread and one process), with the
   launch counts set to 0 just before and read just after (K1 forward and
   backward must run in this process), on the same two streams, its replies
   held as to_json text against the design path's sequential ones:
   a. staged assembly: on one bench chunk and one LM chunk of 16 every
      staged leaf equal to ``Session._assemble_batch``'s (torch.equal, dtype,
      shape, strides), the host time of each printed; then
      ``StagedBatchingService`` by enqueue and flush, timed in turns with a
      ``BatchingDesignService`` (batched, staged, staged, batched), whose
      mean is the yardstick of every tier's ratio below;
   b. ``PooledDesignService(workers=2)``: every query ok, K1 launched;
   c. ``MultiProcessDesignService(workers=2)`` over a cache_dir that a
      parent ``BatchingDesignService.warmup`` preheated (lstm, merge_sort,
      gcn, stencil2d and the LM cells): the fleet builds nothing
      (``stats.traces == 0``), its time from ``start()`` to ready printed;
   d. worker-kill chaos (seed 20260808, p_worker_kill 0.1, as
      bench_serving.py has it): kills >= 1, requeues >= 1, every query ok;
   queries/s, p50/p99 reply ms and each tier's ratio to the batched service
   printed beside bench_serving.py's 1.5x floor (a finding, not a gate);
8. the serving path, with the launch counts set to 0 just before and read
   just after: zamba2-1.2b, falcon-mamba-7b, granite-3-8b,
   llama-3.2-vision-11b and musicgen-large at full width and depth,
   llama4-scout-17b-a16e at full width and 4 of its 48 layers, and
   kimi-k2-1t-a32b at full width (384 experts, top-8, 64 heads of 112) and 1
   of its 61 layers (bf16 activations; weights from a seeded torch.Generator
   on the card, fp32, or bf16 where the config stores them so), each
   behind an Engine(slots=2, max_len=4608) answering 4 greedy requests
   (prompts of 4096, 1000, 257 and 64 tokens, 16 tokens each; the kv-cache
   families prefill them padded to 4096, 1024, 512 and 64; musicgen's are
   [S, 4] codebook tokens); each model's attention must go through the bf16
   tensor-core kernel alone, once for every attention layer of a prefill
   (zamba2: 6 shared blocks) and, for the vision model, once for each of its 8
   cross layers at every decode step;
9. the training path, with the launch counts set to 0 just before and read
   just after (bf16, remat "full", AdamW with warmup_cosine, batches from
   ``make_batch``): granite-3-8b at full width with 4 of its 40 layers, 2 x
   4,096 tokens in 2 microbatches, 5 steps of ``make_train_step`` (median
   step ms over the last 3, tokens/s, the step's bound: model FLOPs over
   989 TFLOP/s, the idle share and the plain attention backward's share of
   device time from torch.profiler, peak memory); musicgen-large at full
   width with 12 of 48 layers, 3 steps at 1 x 4,096 x 4 codebooks; llama-3.2-vision-11b
   with 5 of 40 layers and llama4-scout-17b-a16e with 1 of 48 (int8 moments),
   5 steps each on one fixed batch of 1 x 1,024, whose loss must fall;
   zamba2-1.2b at full width and depth and falcon-mamba-7b at full width with
   8 of 64 layers, 3 steps at 1 x 4,096 (each scan backward's share of
   device time printed); each run's launches equal to steps x microbatches x
   (attention: 2 a self layer, its forward and its recompute, + 1 a cross
   layer or a shared block; K4 or K5: 2 an SSM layer) and none of the float32
   attention kernel; then the ``Trainer`` on musicgen-large at full width with
   2 of 48 layers (2 x 1,024 tokens, 8 steps, checkpoints every 4 into a temporary
   directory), once uninterrupted and once with a failure injected at step
   6, which must restore from step 4 and end with the uninterrupted run's
   parameters (atol 1e-6; deterministic algorithms, cuBLAS's workspace fixed
   before CUDA starts);
10. the launch path, with the launch counts set to 0 just before and read
   just after: ``repro_torch.launch.train --reduced`` on falcon-mamba-7b and
   ``repro_torch.launch.serve --reduced`` on zamba2-1.2b, as a user runs them
   (each under ``make_local_mesh()`` over a one-rank group of its own);
11. the mesh path, with the launch counts set to 0 just before and read just
   after: a one-rank NCCL process group and ``make_local_mesh()``, a (1, 1)
   ``DeviceMesh``; under deterministic algorithms, one ``make_train_step``
   step of granite-3-8b (full width, 2 of 40 layers) and of falcon-mamba-7b
   (16 of 64 layers) at 1 x 4,096 tokens, and an ``Engine`` request of
   granite-3-8b @2 and of zamba2-1.2b (full depth) with a 4,096-token prompt
   and 4 decode steps, each run on the mesh equal bit for bit to the same
   run without one (loss, grad norm, updated parameters; logits and tokens)
   with equal K3/K4/K5 launches; the cost counter (``launch.hlo_costs``) on
   granite's mesh step, its counted FLOPs and bytes beside the step's time;
   ``compressed_psum`` over the one-rank "data" group, two rounds, equal bit
   for bit to ``ef_compress_tree`` on granite @2's gradient tree; on a
   one-rank ("stage",) mesh, ``pipeline_apply`` over granite-3-8b's dense
   block (full width, 2 stacked bf16 layers, attention through K3 and its
   plain backward) on 4 microbatches of 1 x 4,096 tokens, forward and
   backward, equal bit for bit in y and every gradient to the same layers
   applied microbatch by microbatch, K3's launches equal, both walls
   printed; on a one-rank ("pop",) mesh, popsim's member-sharded body
   (``population_chunk_sharded``) at phase 5e's configuration equal bit for
   bit to the plain path in history and state, K1's launches equal,
   member-epochs/s of both (in turns), and ``Session.frontier(mesh=)`` at
   bench_pareto.py's configuration equal to the call without a mesh
   (history, hypervolume, winners' .dhd text); then the dry runs started on
   the host right after the build (``python -m repro_torch.launch.dryrun``
   of granite-3-8b and llama4-scout-17b-a16e at train_4k on the 16x16 mesh,
   a fake group of 256 ranks, and ``--popsim --multipod both``, the
   population-DSE step on the 256- and 512-rank meshes), each exiting 0 with
   ``ok`` records, their roofline terms or FLOPs, bytes and link bytes
   printed;
12. the agreement path, with the launch counts set to 0 just before and read
   just after: tests/data/torch_ssm_train_ref.npz (made by
   tools/make_torch_train_ref.py --ssm: falcon-mamba-7b at 2 layers and
   zamba2-1.2b at 6, full width, float32, 2 x 128 tokens; the loss, grad
   norm, per-leaf grad norms, sampled grads and 3 AdamW steps' losses, each
   within 4x the reference's own spread); the fixtures
   tests/data/torch_ssm_ref.npz and tests/data/torch_lm_ref.npz (made by
   tools/make_torch_ssm_ref.py and tools/make_torch_lm_ref.py from the JAX
   models on the same numpy weights: granite-3-8b at 2 layers,
   llama-3.2-vision-11b at 5 with nonzero cross gates and a seeded vision
   input, musicgen-large at 2, llama4-scout at 1, kimi-k2 at 1 with 16 of its
   384 experts, all at full width) against
   this package on the card in float32 (prefill logits and 8 teacher-forced
   decode steps), which runs attention through the float32 kernel; the
   fixtures' numpy weights are made on host threads from the affine-scan
   path on (after the design and pool paths, which the host's cores bound);
   then tests/data/torch_train_ref.npz (made by
   tools/make_torch_train_ref.py) on the same granite-3-8b weights: the loss,
   grad norm, per-leaf grad norms, sampled grads and 3 AdamW steps' losses in
   float32, each within 4x the reference's own spread.

The last two lines are a JSON ``kernels`` record and the contract line
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, float32 rate
# outside the tensor cores, dense bf16 tensor-core rate; used for each
# kernel's lower bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TC_OPS_PER_S = 989e12
# the special-function unit's exponentials (ex2): 16 a clock per SM (NVIDIA's
# throughput table for compute capability 9.0) on 132 SMs at the 1.98 GHz boost clock
EXP_PER_S = 16 * 132 * 1.98e9
# an exponential computed on the FP32 pipe instead (range reduction and a
# polynomial, ~7 instructions): 14 operations as FP32_OPS_PER_S counts them
EXP_FP32_OPS = 14

# seeds of the generators the model kernels draw their checks' inputs from,
# one a kernel, so that no kernel's inputs depend on another's case list
K1_SEED, K3_SEED, K4_SEED, K5_SEED, MAPPER_SEED = 1, 3, 4, 5, 6
K4_DRAWS = 8  # float32 draws at 4,096 steps on which K4 is held to the float64 recurrence

SERVE_MODELS = ("zamba2-1.2b", "falcon-mamba-7b", "granite-3-8b", "llama-3.2-vision-11b", "musicgen-large",
                "llama4-scout-17b-a16e", "kimi-k2-1t-a32b")
# the depth cuts of the serving path: llama4-scout-17b-a16e at full width
# (16 experts, d_model 5120) with 4 of its 48 layers, 38.6 GiB of fp32 weights
# and ~56 GiB at the peak of the bf16 cast; all 48 layers would be 379 GiB.
# kimi-k2-1t-a32b at full width (384 experts of 7168 x 2048, top-8, 64 heads
# of 112, vocabulary 163,840) with 1 of its 61 layers: 19.4 B parameters, 36.1
# GiB stored in bf16 (its param_dtype), ~57 GiB at the peak of the draw (each
# leaf is drawn in fp32 before its cast, an expert leaf 21 GiB); 2 layers would
# be 67.8 GiB stored, past 80 GB at that peak
SERVE_DEPTH = {"llama4-scout-17b-a16e": 4, "kimi-k2-1t-a32b": 1}
SERVE_PROMPTS = (4096, 1000, 257, 64)  # tokens; two slots, so slots are reused
SERVE_NEW_TOKENS = 16
SERVE_MAX_LEN = 4608
FIXTURE = ROOT / "tests" / "data" / "torch_ssm_ref.npz"
LM_FIXTURE = ROOT / "tests" / "data" / "torch_lm_ref.npz"  # made by tools/make_torch_lm_ref.py
# Agreement with the fixture, float32 on both sides, measured as max |logit
# difference| at the fixture's top-64 indices over the step's largest |logit|.
# The bound of an entry is AGREE_FACTOR times the reference's own spread (how
# far the JAX model moves when one weight matrix moves by one ulp, stored in
# the fixture), and never below AGREE_FLOOR.  On the CPU the port came within
# 1.4-1.6x the spread of every entry (zamba2 at 38 and 6 layers, falcon-mamba at
# 2: max rel 0.081, 4.5e-5 and 4.0e-6 against spreads 0.056, 2.8e-5 and
# 2.7e-6); the card sums in other orders again, hence the factor.
AGREE_FACTOR = 4.0
AGREE_FLOOR = 3e-5

CLASSIC = ["resnet50", "vgg16", "lstm", "dlrm", "bert_base", "bert_large",
           "gcn", "graphsage", "stencil2d", "merge_sort", "bfs_graph"]
LM = [("qwen2.5-32b", "prefill_32k"), ("granite-3-8b", "train_4k"),
      ("kimi-k2-1t-a32b", "decode_32k"), ("falcon-mamba-7b", "long_500k"),
      ("zamba2-1.2b", "train_4k")]

# The reference package's 20-step DOpt history for
#   repro.core.dopt.optimize(Graph.stack([lm_cell(a, s).pad_to(1024) for a, s in LM]),
#                            objective="edp", lr=0.05, steps=20)
# at the default design, run with JAX 0.9.0 on the CPU (float32, x64 off).
REF_HISTORY = {
    "objective": [14.148513793945312, 13.870190620422363, 13.592188835144043, 13.320175170898438,
                  13.032916069030762, 12.7896728515625, 12.550333976745605, 12.339588165283203,
                  12.082541465759277, 11.882933616638184, 11.66612434387207, 11.457076072692871,
                  11.2293062210083, 11.057284355163574, 10.8035306930542, 10.610099792480469,
                  10.411011695861816, 10.184656143188477, 9.982619285583496, 9.79565715789795],
    "runtime": [6981.8115234375, 6089.45849609375, 5285.28125, 4601.7822265625, 3993.958984375,
                3496.166748046875, 3041.1455078125, 2690.078857421875, 2393.89306640625,
                2136.758544921875, 1901.60546875, 1674.08935546875, 1474.2564697265625,
                1322.9212646484375, 1187.2471923828125, 1061.09423828125, 944.2295532226562,
                839.150146484375, 748.9849243164062, 673.27099609375],
    "energy": [651694.9375, 576358.75, 509851.53125, 451133.9375, 399273.0625, 353470.90625,
               312995.78125, 277238.125, 245629.5625, 217682.9375, 192955.796875, 171071.5625,
               151707.3125, 134579.109375, 119419.25, 105998.1953125, 94113.2890625, 83587.0234375,
               74263.5, 66003.75],
    "area": [598.8424072265625, 544.08984375, 496.70745849609375, 455.5601806640625, 419.69049072265625,
             389.3304138183594, 363.4437255859375, 340.99639892578125, 321.083251953125,
             303.258544921875, 287.1769104003906, 272.5820617675781, 259.2673645019531,
             247.0598602294922, 235.7674560546875, 225.29954528808594, 215.55613708496094,
             206.45245361328125, 197.9178009033203, 189.890625],
    "edp": [4550011392.0, 3509712640.0, 2694708736.0, 2076020096.0, 1594680192.0, 1235793280.0,
            951865728.0, 745792448.0, 588010880.0, 465135872.0, 366925792.0, 286389088.0,
            223655488.0, 178037568.0, 141780176.0, 112474072.0, 88864552.0, 70142064.0,
            55622240.0, 44438412.0],
}


T_START = time.perf_counter()  # reset by main: the run's clock


def stamp(what: str) -> None:
    print(f"  {what}: done {time.perf_counter() - T_START:.1f} s into the run")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def bucket(v: int) -> int:
    """The façade's vertex bucket: next power of two, at least 32."""
    return max(32, 1 << (max(v, 1) - 1).bit_length())


def median_ms(fn, device, n: int = 20) -> float:
    """Median time of ``n`` calls: CUDA events around each call on the card,
    the host clock on the CPU.  Two warm-up calls first."""
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, launches, name) of every kernel a torch.profiler run saw
    (not the device-side spans of ``record_function`` ranges, which would
    count their kernels twice)."""
    rows = []
    for avg in prof.key_averages():
        dt = getattr(avg, "self_device_time_total", 0.0) or 0.0
        if (dt > 0 and getattr(avg, "device_type", None) is not None and "CUDA" in str(avg.device_type)
                and not getattr(avg, "is_user_annotation", False)):
            rows.append((dt / 1e3, avg.count, avg.key))
    return rows


def profiled_rows(fn, n: int, ok=None) -> list[tuple[float, int, str]]:
    """``device_rows`` of ``n`` calls of ``fn`` after one warm-up call.  The
    profiler can drop events (it once saw 7 of 20 launches on the H100): a
    window whose rows ``ok`` rejects is measured once more."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(2):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = device_rows(prof)
        if ok is None or ok(rows):
            break
    return rows


def queued_ms(fn, n: int) -> float:
    """Device time per call of ``n`` calls of ``fn`` queued behind a spin
    kernel that outlasts their launches, so that no host gap falls between
    them: CUDA events around the ``n`` calls, over ``n``.  One call first."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0  # a bound on one call's launches
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * min(1.0, 0.005 + 2 * n * host_s)))  # cycles at ~2 GHz
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def call_ms(fn, n: int) -> tuple[float, str]:
    """``queued_ms`` with its method, for whole calls that launch several
    kernels and never wait on the host."""
    return queued_ms(fn, n), "events around calls queued behind a spin kernel"


def device_ms(fn, n: int, kernel: str | None = None) -> tuple[float, str]:
    """Device time per call of ``fn`` from torch.profiler over ``n`` calls
    after one warm-up call: with ``kernel``, the mean time of the launches of
    kernels whose name holds it (the profiler may miss launches, so the mean
    is over the launches it saw; each kernel timed so launches one device
    kernel a call); without, the summed time of every kernel the calls
    launch, over ``n`` (low where the profiler misses launches: attention
    times its whole calls by ``queued_ms``).  Should the profiler see no
    device time, or fewer than half of the kernel's launches (in a long
    process it has seen 3 of 20), ``queued_ms``.  Returns (ms, method)."""
    ok = None if kernel is None else lambda rows: n // 2 <= sum(r[1] for r in rows if kernel in r[2]) <= n
    rows = [r for r in profiled_rows(fn, n, ok) if kernel is None or kernel in r[2]]
    seen = sum(r[1] for r in rows)
    method = "events around calls queued behind a spin kernel"
    if rows and kernel is None:
        return sum(r[0] for r in rows) / n, f"profiler, {seen} launches"
    if rows:
        check(seen <= n, f"profiler saw {seen} launches of {kernel} in {n} calls")
        if seen >= n // 2:
            return sum(r[0] for r in rows) / seen, f"profiler, {seen} launches"
        method += f" (the profiler saw {seen} of {n} launches)"
    return queued_ms(fn, n), method


def kernel_split_ms(fn, n: int, pattern: str) -> dict[str, float]:
    """Device time per call of each kernel that ``fn`` launches once a call
    and whose name matches the regex ``pattern`` (its first group names it),
    from torch.profiler over ``n`` calls: the mean of the launches the
    profiler saw.  Empty if the profiler saw no device time."""
    split = {}
    ok = lambda rows: all(n // 2 <= r[1] <= n for r in rows if re.search(pattern, r[2]))  # noqa: E731
    for ms, seen, key in profiled_rows(fn, n, ok):
        m = re.search(pattern, key)
        if m:
            check(n // 2 <= seen <= n, f"profiler saw {seen} launches of {m.group(1)} in {n} calls")
            split[m.group(1)] = split.get(m.group(1), 0.0) + ms / seen
    return split


def bound_terms(r: dict) -> dict:
    """The lower bounds of a kernel record, in ms: ``bytes`` over the HBM rate,
    ``operations`` over the peak of their type, ``exponentials`` over the
    special-function unit alone, and ``operations_and_exponentials``, the least
    time of the FP32 pipe and that unit together when each exponential may go to
    either (the pipe is free of the operations when they run on the tensor
    cores)."""
    ops_ms = r["ops"] / r["peak"] * 1e3
    fp32_ms = ops_ms if r["peak"] == FP32_OPS_PER_S else 0.0
    unit_ms = r["exps"] / EXP_PER_S * 1e3
    c, u = EXP_FP32_OPS / FP32_OPS_PER_S * 1e3, 1e3 / EXP_PER_S  # ms an exponential takes on the pipe, the unit
    x = max(0.0, (unit_ms - fp32_ms) / (c + u))  # exponentials moved to the pipe until both finish together
    both_ms = max(fp32_ms + x * c, unit_ms - x * u)
    return {"bytes": r["bytes"] / HBM_BYTES_PER_S * 1e3, "operations": ops_ms, "exponentials": unit_ms,
            "operations_and_exponentials": max(ops_ms, both_ms)}


def rel_close(got, ref, rtol: float) -> tuple[bool, float]:
    import numpy as np

    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = float(np.max(np.abs(got - ref) / np.maximum(np.abs(ref), 1e-300)))
    return bool(np.all(np.isfinite(got))) and err <= rtol, err


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #


def phase_env() -> str:
    import torch

    from repro_torch.kernels import runtime

    nvcc = subprocess.run([runtime.nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}")
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    print("card:", smi)
    return smi


def phase_build() -> None:
    from repro_torch.kernels import runtime

    t0 = time.perf_counter()
    paths = runtime.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(paths)} kernels; each: "
          + ", ".join(f"{n} {s:.1f} s" for n, s in runtime.BUILD_SECONDS.items()))
    if "flash_attention" in runtime.BUILD_SECONDS:
        print(f"  flash_attention.cu built in {runtime.BUILD_SECONDS['flash_attention']:.1f} s")
    for name, log in runtime.BUILD_LOG.items():
        for line in log.strip().splitlines():
            print(f"  {name}: {line}")
    cuobjdump = pathlib.Path(runtime.nvcc_path()).with_name("cuobjdump")
    for name, path in paths.items():
        elf = subprocess.run([str(cuobjdump), "--list-elf", str(path)], capture_output=True, text=True,
                             check=True).stdout
        print(f"  {name}: {' '.join(elf.split())}")
        check("sm_90a" in elf, f"{path.name} holds no sm_90a code")
    sass = subprocess.run([str(cuobjdump), "-sass", str(paths["flash_attention_sm90"])], capture_output=True,
                          text=True, check=True).stdout
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
    print(f"  flash_attention_sm90 SASS: {counts['HGMMA']} HGMMA (wgmma), {counts['UTMALDG']} UTMALDG (TMA loads)")
    check(all(counts.values()), f"flash_attention_sm90 holds no tensor-core or no TMA instruction: {counts}")
    for name in paths:
        runtime.library(name)


def phase_kernels(device) -> dict:
    """Each kernel against its plain version; returns the kernel records."""
    import torch

    from repro_torch.core import ArchParams, TechParams, specialize
    from repro_torch.kernels import ops, ref, sscan
    from repro_torch.kernels import popsim_kernel as pk
    from repro_torch.workloads import lm_cell

    gen = torch.Generator(device.type).manual_seed(0)
    rand = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731

    # K1, the bare affine scan (the fused carries: carries_records): forward
    # and backward (the autograd path) at edge shapes and at the shapes the
    # mapper's carries take: [1, bucket] for each simulate, [5, 1024] for the
    # LM-stack DOpt, [11, 256] for the classic DOpt
    k1_err = 0.0
    shapes = [(1, 1), (3, 33), (16, 707), (512, 4096), (len(LM), 1024), (len(CLASSIC), 256)]
    shapes += [(1, 1 << k) for k in range(5, 11)]
    for R, V in shapes:
        b = (0.4 * rand(R, V)).requires_grad_(True)
        cot = rand(R, V)
        s = sscan.affine_scan(0.8, b)
        (s * cot).sum().backward()
        s_ref = ref.affine_scan_reference(0.8, b.detach())
        g_ref = ref.affine_scan_reference(0.8, cot, reverse=True)
        for got, want, x in ((s.detach(), s_ref, b.detach()), (b.grad, g_ref, cot)):
            err = (got - want).abs()
            tol = 1e-6 * x.abs().max() + 1e-5 * want.abs()
            check(bool(torch.all(err <= tol)), f"affine_scan [{R},{V}] off its plain version by {float(err.max())}")
            k1_err = max(k1_err, float(err.max()))
        print(f"  affine_scan [{R},{V}] fwd+bwd within rtol 1e-5, atol 1e-6*max|x|")
    # timing at the LM stack's [5, 1024] bw-EMA input.
    # ms / plain_ms: device time per call (kernel time, no host dispatch);
    # host_ms / plain_host_ms: CUDA events around each call, host path included
    b = 0.4 * rand(len(LM), 1024)
    kern = lambda: sscan.affine_scan_op(b, 0.8, False)  # noqa: E731
    plain = lambda: ref.affine_scan_reference(0.8, b)  # noqa: E731
    k1 = dict(bytes=2 * b.numel() * 4, ops=2 * b.numel(),
              host_ms=median_ms(kern, device), plain_host_ms=median_ms(plain, device))
    (k1["ms"], k1["ms_method"]), (k1["plain_ms"], _) = device_ms(kern, 100, "carries_kernel<false>"), device_ms(plain, 20)

    # K2: the qwen DFG against populations that scale cell_read_latency, held
    # to its plain version bit for bit (the kernel keeps its operation order,
    # IEEE '/' and ceilf, and no contraction) and timed at both sizes
    gp = ops.pack_graph(lm_cell("qwen2.5-32b", "prefill_32k", device=device))
    k2_err, k2, k2_ms_by_P = 0.0, None, {}
    for P in (512, 65536):
        scales = torch.linspace(0.5, 2.0, P, device=device)
        tech = TechParams.default(device)
        tech.cell_read_latency = tech.cell_read_latency * scales[:, None]
        cp = ops.pack_chw(specialize(tech, ArchParams.default(device)))
        got = ops.popsim(gp, cp)
        want = ref.popsim_reference(gp, cp)
        err = float((got - want).abs().max())
        check(torch.equal(got, want) and bool(torch.isfinite(got).all()),
              f"popsim P={P} differs from its plain version (max abs err {err})")
        k2_err = max(k2_err, err)
        print(f"  popsim P={P} V={gp.shape[0]}: equal to its plain version bit for bit (max abs err {err})")
        kern = lambda: ops.popsim(gp, cp)  # noqa: E731
        k2_ms_by_P[P] = device_ms(kern, 20, "popsim_kernel")
        if P == 65536:
            plain = lambda: ref.popsim_reference(gp, cp)  # noqa: E731
            k2 = dict(bytes=(gp.numel() + cp.numel() + P * pk.OUT_COLS) * 4, ops=pk.operations(gp, P),
                      host_ms=median_ms(kern, device), plain_host_ms=median_ms(plain, device, n=3))
            (k2["ms"], k2["ms_method"]), (k2["plain_ms"], _) = k2_ms_by_P[P], device_ms(plain, 1)
    k2["ms_by_P"] = {P: ms for P, (ms, _) in k2_ms_by_P.items()}
    k1["max_abs_err"], k2["max_abs_err"] = k1_err, k2_err
    return {"affine_scan": k1, **carries_records(device), **mapper_records(device), "popsim": k2}


# shapes the main paths give K1's fused kernels: [1, bucket] for each
# simulate (qwen's 1024 the largest), [5, 1024] for the LM-stack DOpt,
# [11, 256] for the classic DOpt (one design over R workloads: one cap), and
# the DSE path's populations, P·W rows of one design each: [96, 109] for the
# bench configuration (32 members x 3 workloads, bert_base's 109 vertices)
# and [5120, 1024] for 1,024 members on the LM stack; the session path's
# batches, nb·W rows of one design each: [8, 32] and [64, 32] for
# simulate_batch and preheat on (1, 32), [8, 1024] for the LM cells at
# request_bucket=8, and [96, 128] for frontier, which pads the bench stack to
# its bucket; the design path's, one query a row at its pinned request bucket
# of 16: [16, 32] for the bench's (1, 32) stream and [16, 1024] for the LM
# cells; the records are timed at [5, 1024], and at every shape in
# ms_by_shape
DSE_CARRY_SHAPES = ((96, 109), (5120, 1024))
SESSION_CARRY_SHAPES = ((8, 32), (64, 32), (8, 1024), (96, 128))
DESIGN_CARRY_SHAPES = ((16, 32), (16, 1024))
ROW_CAP_SHAPES = DSE_CARRY_SHAPES + SESSION_CARRY_SHAPES + DESIGN_CARRY_SHAPES  # a design, so a cap, a row
CARRY_SHAPES = ((1, 1024), (len(LM), 1024), (len(CLASSIC), 256), *ROW_CAP_SHAPES)


def carries_records(device) -> dict:
    """K1's fused kernels, the mapper's two carries forward and their
    closed-form backward, against their plain versions at edge shapes and the
    main path's (inputs from their own seeded generator; alloc near cap, so
    rows clamp often): occ_prev, bw_prev, the clamp codes (equal), grad_alloc,
    grad_bw_x and grad_cap.  Each timed at CARRY_SHAPES; the backward as the
    mapper runs it, with no gradient for alloc."""
    import torch

    from repro_torch.core import mapper
    from repro_torch.kernels import ref, sscan

    decays = (mapper._OCC_DECAY, mapper._BW_DECAY, mapper._BW_GAIN)
    gen = torch.Generator(device.type).manual_seed(K1_SEED)
    rand = lambda *s: torch.rand(*s, generator=gen, device=device)  # noqa: E731

    def draw(R, V):
        cap = 1.0 + 2.0 * rand(R)
        return cap[:, None] * (0.2 + 0.7 * rand(R, V)), 2.0 * rand(R, V), cap

    err = {"forward": 0.0, "backward": 0.0}
    shapes = [(1, 1), (3, 33), (16, 707), (512, 4096), (3, 2500), *CARRY_SHAPES]  # a cap a row
    shapes += [(1, 1 << k) for k in range(5, 11)]
    for R, V in shapes:
        alloc, bw_x, cap = draw(R, V)
        g_occ, g_bw = rand(R, V) - 0.5, rand(R, V) - 0.5
        occ, bw, code = sscan.mapper_carries_op(alloc, bw_x, cap, *decays)
        ga, gb, gc = sscan.mapper_carries_backward_op(g_occ, g_bw, code, *decays, True)
        w_occ, w_bw, w_code = ref.mapper_carries_reference(alloc, bw_x, cap, *decays)
        wa, wb, wc = ref.mapper_carries_backward_reference(g_occ, g_bw, w_code, *decays)
        check(torch.equal(code, w_code), f"mapper_carries [{R},{V}]: {int((code != w_code).sum())} clamp codes "
                                         "differ from the plain version's")
        clamped = float((code == 0).float().mean())
        check(V < 256 or 0.05 < clamped < 0.95, f"mapper_carries [{R},{V}]: {clamped:.3f} of vertices clamp")
        scale_c = ref.mapper_carries_backward_reference(g_occ.abs(), g_bw.abs(), w_code, *decays)[2]
        for what, got, want, atol in (("occ_prev", occ, w_occ, None), ("bw_prev", bw, w_bw, None),
                                      ("grad_alloc", ga, wa, None), ("grad_bw_x", gb, wb, None),
                                      ("grad_cap", gc, wc, 1e-6 * scale_c)):
            atol = 1e-6 * want.abs().max() if atol is None else atol
            e = (got - want).abs()
            check(bool(torch.isfinite(got).all()) and bool(torch.all(e <= atol + 1e-5 * want.abs())),
                  f"mapper_carries {what} [{R},{V}] off its plain version by {float(e.max())}")
            key = "forward" if what in ("occ_prev", "bw_prev") else "backward"
            err[key] = max(err[key], float(e.max()))
        print(f"  mapper_carries [{R},{V}] fwd+bwd within rtol 1e-5, atol 1e-6*max|want| (grad_cap: of its "
              f"|terms|' sum); codes equal, {clamped:.3f} clamped")

    rec = {}
    for name, kernel in (("mapper_carries", "carries_kernel<true>"),
                         ("mapper_carries_backward", "carries_backward_kernel")):
        by_shape, bound_by_shape = {}, {}
        for R, V in CARRY_SHAPES:
            alloc, bw_x, cap = draw(R, V)
            # one design over R workloads (one cap), or a population's one design a row
            cap1 = cap if (R, V) in ROW_CAP_SHAPES else cap[:1]
            occ, bw, code = sscan.mapper_carries_op(alloc, bw_x, cap1, *decays)
            g_occ, g_bw = rand(R, V) - 0.5, rand(R, V) - 0.5
            if name == "mapper_carries":
                kern = lambda: sscan.mapper_carries_op(alloc, bw_x, cap1, *decays)  # noqa: E731
                plain = lambda: ref.mapper_carries_reference(alloc, bw_x, cap1, *decays)  # noqa: E731
                # alloc, bw_x, cap read; occ_prev, bw_prev (float32) and the code (uint8) written;
                # per vertex: occupancy 0.5*s, + alloc, min, the tie test; bandwidth 0.2*x, 0.8*t, +
                size, ops = (4 * R * V * 2 + 4 * cap1.numel()) + (4 * R * V * 2 + R * V), 7 * R * V
            else:
                kern = lambda: sscan.mapper_carries_backward_op(g_occ, g_bw, code, *decays, False)  # noqa: E731
                plain = lambda: ref.mapper_carries_backward_reference(g_occ, g_bw, code, *decays)  # noqa: E731
                # g_occ, g_bw and the code read; grad_bw_x and grad_cap written;
                # per vertex: occupancy 0.5*m, *lambda, + g, 1-m, *lambda, + sum; bandwidth 0.2*mu, 0.8*mu, + g
                size, ops = (4 * R * V * 2 + R * V) + (4 * R * V + 4 * R), 9 * R * V
            ms, method = device_ms(kern, 100, kernel)
            by_shape[f"{R}x{V}"] = ms
            bound_by_shape[f"{R}x{V}"] = max(size / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
            if (R, V) == (len(LM), 1024):
                r = dict(bytes=size, ops=ops, ms=ms, ms_method=method, host_ms=median_ms(kern, device),
                         plain_host_ms=median_ms(plain, device), plain_ms=device_ms(plain, 20)[0],
                         max_abs_err=err["forward" if name == "mapper_carries" else "backward"])
        r["ms_by_shape"], r["bound_ms_by_shape"] = by_shape, bound_by_shape
        rec[name] = r
    return rec


# the mapper's kernels around K1 at the main path's shapes: the sweep's
# 65,536 designs [P, 1] against the classic stack [11, 256], and 16,384
# against the LM stack [5, 1024] (the descent's population); the records are
# the sweep's
MAPPER_SHAPES = (("classic", 65536), ("lm_stack", 16384))
# float operations a real (row, vertex), counted by hand from csrc/mapper.cu as
# it executes them (each add, multiply, division, ceil, max/min and compare
# once; a select not): the carry-free terms 47, the systolic wave model 22 more
# where the vertex has systolic work; the finish recomputes them and adds the
# activity flag, the gates, exposed time, cycles and the sums, 47.  A padding
# vertex takes its design's precomputed terms: none counted
MAPPER_OPS_TERMS, MAPPER_OPS_WAVE, MAPPER_OPS_FINISH = 47, 22, 47


def mapper_records(device) -> dict:
    """The mapper's kernels around K1 (``csrc/mapper.cu``) called through
    their ops at MAPPER_SHAPES, against the torch stages they replace on the
    same designs (each field of the default design scaled by exp(0.5 N(0, 1))):
    ``mapper_intrinsics``' bw_x equal to ``_vertex_intrinsics``' bit for bit;
    ``mapper_finish``'s sums and bw_util within rtol 1e-5 of
    ``_vertex_finish``'s on the same carries (its sums over V run in another
    order), n_tiles equal below 2^24.  Each kernel and each stage timed at
    both shapes."""
    import torch

    from repro_torch.core import ArchParams, Graph, MapperCfg, TechParams, mapper, specialize
    from repro_torch.kernels import mapper_kernel
    from repro_torch.workloads import get_workload, lm_cell

    stacks = {"classic": lambda: Graph.stack([get_workload(n, device=device).pad_to(256) for n in CLASSIC]),
              "lm_stack": lambda: Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])}
    chw0 = specialize(TechParams.default(device), ArchParams.default(device))
    cfg = MapperCfg()
    gen = torch.Generator(device.type).manual_seed(MAPPER_SEED)
    names = {"mapper_intrinsics": "mapper_kernel<false>", "mapper_finish": "mapper_kernel<true>"}
    rec = {name: dict(ms_by_shape={}, bound_ms_by_shape={}, plain_ms_by_shape={}, max_abs_err=0.0,
                      max_rel_err=0.0) for name in names}
    with torch.no_grad():
        for stack, P in MAPPER_SHAPES:
            g = stacks[stack]()
            chw = type(chw0)(**{f.name: getattr(chw0, f.name) * torch.exp(0.5 * torch.randn(
                (P, 1, *getattr(chw0, f.name).shape), generator=gen, device=device)) for f in dataclasses.fields(chw0)})
            h = mapper._hw(chw)
            fz = mapper.pack(chw, g)
            R, V = math.prod(fz.lead), g.n_vertices
            check(fz.lead == (P, g.n_comp.shape[0]), f"mapper kernels: {stack} packed as {fz.lead}")
            intr = lambda: mapper_kernel.mapper_intrinsics_op(fz.graph, fz.designs, fz.span, cfg.headroom)  # noqa: E731
            plain_intr = lambda: mapper._vertex_intrinsics(h, g, cfg)  # noqa: E731
            bw_x, iv = intr(), plain_intr()
            check(torch.equal(bw_x, iv["bw_x"].reshape(R, V)),
                  f"mapper_intrinsics [{R},{V}]: bw_x differs from _vertex_intrinsics' by "
                  f"{float((bw_x - iv['bw_x'].reshape(R, V)).abs().max())}")
            occ, bwp = mapper._carry_prefixes(chw, cfg, iv)
            occ_r, bwp_r = occ.reshape(R, V), bwp.reshape(R, V)
            fin = lambda: mapper_kernel.mapper_finish_op(fz.graph, fz.designs, occ_r, bwp_r, fz.span,  # noqa: E731
                                                         cfg.headroom, cfg.prefetch, cfg.streaming)
            plain_fin = lambda: mapper._vertex_finish(h, g, cfg, iv, occ, bwp)  # noqa: E731
            (sums, bw_util), want = fin(), plain_fin()
            w_sums = torch.stack([getattr(want, f).reshape(R) for f in mapper_kernel.SUMS])
            for what, got, w in (("sums", sums, w_sums), ("bw_util", bw_util, want.bw_util.reshape(R, 3))):
                e = (got - w).abs()
                check(bool(torch.isfinite(got).all()) and bool(torch.all(e <= 1e-5 * w.abs())),
                      f"mapper_finish [{R},{V}]: {what} off the torch stage's beyond rtol 1e-5 "
                      f"(max abs {float(e.max())})")
                rec["mapper_finish"]["max_abs_err"] = max(rec["mapper_finish"]["max_abs_err"], float(e.max()))
                rel = float((e / w.abs().clamp_min(1e-30)).max())
                rec["mapper_finish"]["max_rel_err"] = max(rec["mapper_finish"]["max_rel_err"], rel)
            tiles, w_tiles = sums[mapper_kernel.SUMS.index("n_tiles")], w_sums[mapper_kernel.SUMS.index("n_tiles")]
            check(torch.equal(tiles[w_tiles < 2.0 ** 24], w_tiles[w_tiles < 2.0 ** 24]),
                  f"mapper_finish [{R},{V}]: n_tiles differs from the torch stage's")
            print(f"  mapper_intrinsics [{R},{V}] ({stack}, P = {P}): bw_x equal to the torch stage's bit for bit; "
                  f"mapper_finish: sums and bw_util within rtol 1e-5 (largest relative gap "
                  f"{rec['mapper_finish']['max_rel_err']:.3g}), n_tiles equal")
            active = (g.n_comp.sum(-1) + g.n_read.sum(-1) + g.n_write.sum(-1) + g.n_alloc.sum(-1)) > 0
            n_real, n_sys = int(active.sum()), int((g.n_comp[..., 0] > 0).sum())
            ops_terms = P * (n_real * MAPPER_OPS_TERMS + n_sys * MAPPER_OPS_WAVE)
            packed = 4 * (fz.graph.numel() + fz.designs.numel())
            # intrinsics: the packed arrays read, bw_x written; finish: the carries read, [5, R] and [R, 3] written
            size = {"mapper_intrinsics": packed + 4 * R * V,
                    "mapper_finish": packed + 2 * 4 * R * V + 4 * R * (len(mapper_kernel.SUMS) + 3)}
            ops = {"mapper_intrinsics": ops_terms, "mapper_finish": ops_terms + P * n_real * MAPPER_OPS_FINISH}
            for name, kern, plain in (("mapper_intrinsics", intr, plain_intr), ("mapper_finish", fin, plain_fin)):
                r, key = rec[name], f"{R}x{V}"
                ms, method = device_ms(kern, 20, names[name])
                plain_ms = device_ms(plain, 3)[0]
                r["ms_by_shape"][key], r["plain_ms_by_shape"][key] = ms, plain_ms
                r["bound_ms_by_shape"][key] = max(size[name] / HBM_BYTES_PER_S, ops[name] / FP32_OPS_PER_S) * 1e3
                if stack == "classic":
                    r.update(bytes=size[name], ops=ops[name], ms=ms, ms_method=method, plain_ms=plain_ms)
            del g, chw, h, fz, bw_x, iv, occ, bwp, occ_r, bwp_r, sums, bw_util, want, w_sums
            gc.collect()
            torch.cuda.empty_cache()
    return rec


def _bound_ratio(got, want, atol: float, rtol: float) -> float:
    """max |got - want| / (atol + rtol |want|), in float64 (inf where got is
    not finite): above 1 breaks that bound."""
    import torch

    g, w = got.double(), want.double()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return float(((g - w).abs() / (atol + rtol * w.abs())).max())


def _close(got, want, atol: float, rtol: float, what: str) -> float:
    """Raise unless |got - want| <= atol + rtol*|want| everywhere (and got is
    finite); return the max abs error."""
    import torch

    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and bool(torch.all(err <= atol + rtol * want.float().abs()))
    check(ok, f"{what} off its plain version by {float(err.max())} (atol {atol}, rtol {rtol})")
    return float(err.max())


def ssd_draw(randn, S: int, dtype):
    """zamba2's Mamba2 layer inputs from ``randn``: x [1,S,64,64] in ``dtype``,
    dt [1,S,64] (after softplus), A [64] (negative), B and C [1,S,64]."""
    import torch
    import torch.nn.functional as F

    x = randn(1, S, 64, 64).to(dtype)
    return x, F.softplus(randn(1, S, 64)), -torch.exp(randn(64)), randn(1, S, 64), randn(1, S, 64)


def scan_draw(randn, S: int, dtype, C: int = 8192, N: int = 16, batch: int = 1):
    """falcon-mamba's Mamba1 layer inputs from ``randn``: u [B,S,C] in
    ``dtype``, dt [B,S,C] (after softplus), A [C,N] (negative), B and C
    [B,S,N], D [C]."""
    import torch
    import torch.nn.functional as F

    u = randn(batch, S, C).to(dtype)
    dt, A = F.softplus(randn(batch, S, C)), -torch.exp(randn(C, N))
    return u, dt, A, randn(batch, S, N), randn(batch, S, N), randn(C)


# float32 tolerances are the reference's own (tests/test_kernels.py), with a
# relative term for outputs of larger magnitude; a bf16 output is rounded from
# float32 by the kernel and by the plain version alike, so they may differ by
# one bf16 step: 2e-2, the reference's bf16 attention bound
def _tol(dtype, f32_atol: float) -> dict:
    import torch

    return dict(atol=f32_atol, rtol=1e-4) if dtype == torch.float32 else dict(atol=2e-2, rtol=2e-2)


def _close_rows(got, want, rtol: float, what: str) -> float:
    """Raise unless every row (the last axis) of ``got`` is within ``rtol`` of
    the plain version's, relative to that row's norm; return the largest ratio.
    An elementwise bound of 2e-2 is large beside the outputs of rows that see
    thousands of keys (~0.03 each at S = 4096), so attention is held row by row too."""
    import torch

    diff = (got.float() - want.float()).norm(dim=-1)
    rel = diff / want.float().norm(dim=-1).clamp_min(1e-30)
    check(bool(torch.all(rel <= rtol)), f"{what}: a row off its plain version by {float(rel.max())} of its norm "
                                        f"(bound {rtol})")
    return float(rel.max())


# per-row bound for attention: rounding P and the output to bf16 puts the
# tensor-core kernel's rows within ~5e-3 of the plain version's (4.75e-3 at
# worst, S = 4096, H100 80GB HBM3); float32 rows differ in summation order only
_ROW_RTOL = {"bfloat16": 1e-2, "float32": 1e-4}


def _attention_record(q, k, v, peak: float, kernel: str, n: int, what: str) -> dict:
    """One timed attention record, causal, on q, k, v: the kernel ``route``
    names held against the plain version on these inputs (one launch) and,
    in float32, each against a float64 oracle (printed); device ms of the
    kernel, the plain version and SDPA on the same inputs (grouped heads
    through ``enable_gqa``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, runtime

    B, Hq, S, D = q.shape
    gqa = k.shape[1] != Hq
    check(fa.route(q.dtype, D) == kernel, f"{what}: route names {fa.route(q.dtype, D)}, not {kernel}")
    before = runtime.LAUNCHES[kernel]
    got = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    check(runtime.LAUNCHES[kernel] == before + 1, f"{what} did not launch {kernel} once")
    want = ref.reference_attention(q, k, v, causal=True)
    err = _close(got, want, **_tol(q.dtype, 2e-5), what=what)
    row = _close_rows(got, want, _ROW_RTOL[str(q.dtype)[6:]], what)
    line = f"  {what}: max abs err {err:.3g}, max row err {row:.3g} of the row's norm"
    if q.dtype == torch.float32:
        group = Hq // k.shape[1]
        s64 = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double().repeat_interleave(group, 1)) * D ** -0.5
        s64 = s64.masked_fill(~torch.ones(S, S, dtype=torch.bool, device=q.device).tril(), -1e30)
        o64 = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s64, -1), v.double().repeat_interleave(group, 1))
        del s64
        line += (f"; against float64: kernel {float((got.double() - o64).abs().max()):.3g}, "
                 f"plain version {float((want.double() - o64).abs().max()):.3g}")
        del o64
    print(line)
    ops = fa.operations(B, Hq, S, S, D, True)
    kw = dict(enable_gqa=True) if gqa else {}
    rec = dict(
        kernel=kernel, max_abs_err=err, bytes=2 * (q.numel() + k.numel()) * q.element_size(), ops=ops, peak=peak,
        exps=ops // (4 * D + 1),  # one exponential per kept (query, key) pair
        ms=device_ms(lambda: fa.flash_attention_op(q, k, v, True, D ** -0.5), n, f"{kernel}_kernel"),
        plain_ms=call_ms(lambda: ref.reference_attention(q, k, v, causal=True), 3),
        library_ms=call_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw), n))
    del got, want
    return rec


def attention_records(device) -> dict:
    """K3's two kernels against the plain version at the serving path's
    shapes and beyond; records timed at q, k, v [1,32,4096,64], the tensor-core
    kernel in bf16 (the serving path's) and the other in float32 (the
    agreement path's), the float32-pipe kernel at [1,32,4096,128] in
    float32, and the tensor-core kernel at kimi-k2's heads, q [1,64,4096,112]
    with k and v [1,8,4096,112], and at q [1,32,4096,128] with k and v
    [1,8,4096,128] (the dense families' heads)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, runtime

    gen = torch.Generator(device.type).manual_seed(0)
    randn = lambda *s: torch.randn(*s, generator=gen, device=device)  # noqa: E731
    rec = {}

    # K3: zamba2's shared block, 32 heads of 64 (MHA); GQA group 4 with Sq < Skv;
    # rows that see no key (Sq > Skv); head width 128 (the dense families) in bf16;
    # a bf16 head width of 32, which stays on the float32-pipe kernel.  First one
    # tile, not causal: the wgmma operand layouts on their own.  The three
    # earlier shapes and the timing inputs draw from ``gen`` (seed 0), the
    # added cases from a generator of their own; K4 and K5 draw from theirs.
    gen_k3 = torch.Generator(device.type).manual_seed(K3_SEED)
    randn_k3 = lambda *s: torch.randn(*s, generator=gen_k3, device=device)  # noqa: E731
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(randn_k3, 1, 1, 64, 64, 64, False, (bf16,)), (randn_k3, 1, 1, 64, 64, 128, False, (bf16,))]
    cases += [(randn, 32, Hkv, Sq, Skv, 64, True, (bf16, f32))
              for Hkv, Sq, Skv in ((32, 4096, 4096), (32, 257, 257), (8, 1000, 4096))]
    cases += [(randn_k3, 32, 8, 300, 200, 64, True, (bf16, f32))]
    cases += [(randn_k3, 32, Hkv, Sq, Skv, 128, True, (bf16,))
              for Hkv, Sq, Skv in ((32, 4096, 4096), (8, 1000, 4096), (8, 300, 200))]
    cases += [(randn_k3, 32, 8, 257, 257, 32, True, (bf16,))]
    # the serving path's other two prompts (1000: a q tile's second warpgroup partly
    # past Sq, the keys ragged at the diagonal; 64: one tile)
    cases += [(randn_k3, 32, 32, S, S, 64, True, (bf16, f32)) for S in (1000, 64)]
    # every head width the reference takes, on the float32-pipe kernel: float32
    # inside and at each of its width caps (64, 128, 256), bf16 off the
    # tensor-core kernel's two widths; ragged Sq and Skv, GQA 4:1, causal and
    # full; and at D = 128, rows that see no key (Sq > Skv)
    cases += [(randn_k3, 8, 2, 257, 333, D, causal, (f32,))
              for D in (8, 48, 80, 112, 128, 256) for causal in (True, False)]
    cases += [(randn_k3, 8, 2, 257, 333, D, causal, (bf16,)) for D in (8, 96, 112, 256) for causal in (True, False)]
    cases += [(randn_k3, 8, 2, 300, 200, 128, causal, (f32,)) for causal in (True, False)]
    cases = [(c[0], 1) + c[1:] for c in cases]  # batch 1
    # the transformer families' shapes, from a generator of their own: serving
    # (bf16) at the engine's prompt buckets (4096, 1024, 512, 64) and
    # agreement (float32) at the fixture's 67-token prompt and its decode steps.
    # The vision model's cross-attention, not causal, against 1,601 patches (a
    # prime: a ragged last K/V tile), in prefill and at Sq = 1 in every decode
    # step (2 slots serving, 1 in agreement); llama4-scout's GQA group 5 (40
    # query heads over 8); granite's GQA 4 and musicgen's MHA at D 64 at the
    # buckets the SSM prompts did not give
    gen_lm = torch.Generator(device.type).manual_seed(K3_SEED + 100)
    randn_lm = lambda *s: torch.randn(*s, generator=gen_lm, device=device)  # noqa: E731
    buckets = (4096, 1024, 512, 64)
    cases += [(randn_lm, 1, 32, 8, S, 1601, 128, False, (bf16,)) for S in buckets]
    cases += [(randn_lm, 2, 32, 8, 1, 1601, 128, False, (bf16,)), (randn_lm, 1, 32, 8, 1, 1601, 128, False, (f32,)),
              (randn_lm, 1, 32, 8, 67, 1601, 128, False, (f32,))]
    cases += [(randn_lm, 1, 40, 8, S, S, 128, True, (bf16,)) for S in buckets]
    cases += [(randn_lm, 1, 32, 8, S, S, 128, True, (bf16,)) for S in buckets[1:]]
    cases += [(randn_lm, 1, 32, 32, S, S, 64, True, (bf16,)) for S in buckets[1:3]]
    cases += [(randn_lm, 1, Hq, Hkv, 67, 67, D, True, (f32,))
              for Hq, Hkv, D in ((40, 8, 128), (32, 8, 128), (32, 32, 64), (64, 8, 112))]
    # kimi-k2's heads (64 of 112 over 8) on the tensor-core kernel: its serving
    # shapes at the engine's buckets, one tile not causal (the two 64-column
    # boxes, the second zero-filled past column 112, and m64n112k16 alone), and
    # rows that see no key (Sq > Skv)
    cases += [(randn_lm, 1, 64, 8, S, S, 112, True, (bf16,)) for S in buckets]
    cases += [(randn_lm, 1, 1, 1, 64, 64, 112, False, (bf16,)), (randn_lm, 1, 64, 8, 300, 200, 112, True, (bf16,))]
    # and every shape the training path gives it that the cases above miss
    # (the Trainer's batch 2, the float32 agreement's batch 2 of 128 tokens)
    have = {c[1:8] + (dt,) for c in cases for dt in c[8]}
    cases += [(randn_lm,) + c[:7] + ((c[7],),) for c in sorted(train_attention_cases() - have, key=str)]
    err = {"flash_attention_sm90": 0.0, "flash_attention": 0.0}
    for (draw, B, Hq, Hkv, Sq, Skv, D, causal, dtypes) in cases:
        for dtype in dtypes:
            q, k, v = draw(B, Hq, Sq, D).to(dtype), draw(B, Hkv, Skv, D).to(dtype), draw(B, Hkv, Skv, D).to(dtype)
            name = fa.route(dtype, D)
            before = {n: runtime.LAUNCHES[n] for n in err}
            got = fa.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            check({n: runtime.LAUNCHES[n] - before[n] for n in err} == {n: int(n == name) for n in err},
                  f"flash_attention {dtype} D={D} did not launch {name} once")
            what = f"{name} q[{B},{Hq},{Sq},{D}] kv[{B},{Hkv},{Skv},{D}] {str(dtype)[6:]} causal={causal}"
            want = ref.reference_attention(q, k, v, causal=causal)
            e = _close(got, want, **_tol(dtype, 2e-5), what=what)
            row = _close_rows(got, want, _ROW_RTOL[str(dtype)[6:]], what)
            err[name] = max(err[name], e)
            print(f"  {what}: max abs err {e:.3g}, max row err {row:.3g} of the row's norm")
    q, k, v = (randn(1, 32, 4096, 64).to(bf16) for _ in range(3))
    ops = fa.operations(1, 32, 4096, 4096, 64, True)
    exps = 32 * 4096 * 4097 // 2  # one exponential per causal score
    rec["flash_attention_sm90"] = dict(  # q, k, v in and o out, bf16
        max_abs_err=err["flash_attention_sm90"], bytes=4 * q.numel() * 2, ops=ops, peak=BF16_TC_OPS_PER_S, exps=exps,
        ms=device_ms(lambda: fa.flash_attention_op(q, k, v, True, 64 ** -0.5), 20, "flash_attention_sm90_kernel"),
        plain_ms=call_ms(lambda: ref.reference_attention(q, k, v, causal=True), 3),
        library_ms=call_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
    q, k, v = (x.float() for x in (q, k, v))
    rec["flash_attention"] = dict(  # the same inputs in float32, the kernel's path in the agreement phase
        max_abs_err=err["flash_attention"], bytes=4 * q.numel() * 4, ops=ops, peak=FP32_OPS_PER_S, exps=exps,
        ms=device_ms(lambda: fa.flash_attention_op(q, k, v, True, 64 ** -0.5), 10, "flash_attention_kernel"),
        plain_ms=call_ms(lambda: ref.reference_attention(q, k, v, causal=True), 3),
        library_ms=call_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 20))
    # the float32-pipe kernel at the dense families' head width
    q, k, v = (randn_k3(1, 32, 4096, 128) for _ in range(3))
    rec["flash_attention/f32_d128"] = _attention_record(q, k, v, FP32_OPS_PER_S, "flash_attention", 10,
                                                        "flash_attention q,k,v[1,32,4096,128] float32 causal")
    # the tensor-core kernel at kimi-k2's heads (64 query heads, 8 KV heads, 112
    # wide: its serving prefill); the float32-pipe kernel's record at this shape
    # until the tensor-core kernel took D 112
    q, k, v = (randn_k3(1, H, 4096, 112).to(bf16) for H in (64, 8, 8))
    rec["flash_attention_sm90/bf16_d112_gqa8"] = _attention_record(
        q, k, v, BF16_TC_OPS_PER_S, "flash_attention_sm90", 20,
        "flash_attention_sm90 q[1,64,4096,112] kv[1,8,4096,112] bf16 causal")
    # the tensor-core kernel at the dense families' head width (granite,
    # llama-3.2-vision): 32 query heads of 128 over 8 KV heads
    q, k, v = (randn_lm(1, H, 4096, 128).to(bf16) for H in (32, 8, 8))
    rec["flash_attention_sm90/bf16_d128_gqa4"] = _attention_record(
        q, k, v, BF16_TC_OPS_PER_S, "flash_attention_sm90", 20,
        "flash_attention_sm90 q[1,32,4096,128] kv[1,8,4096,128] bf16 causal")
    del q, k, v
    return rec


def ssd_record(device) -> dict:
    """K4 against the float64 recurrence (float32) and its plain version (bf16)
    at zamba2's shapes; its record, timed at x [1,4096,64,64] in bf16."""
    import torch

    from repro_torch.kernels import ref, ssd

    # K4: zamba2's Mamba2 layers: x [1,S,64,64], dt [1,S,64], A [64], B, C [1,S,64].
    # In float32 the kernel and its plain version (two chunked forms that sum in
    # their own orders) are each held to the per-step recurrence in float64 by
    # the same bound, the reference's SSD tolerance atol 1e-4 + rtol 1e-4 |y|, on
    # K4_DRAWS draws at 4,096 steps and one at each of the serving path's other
    # prompt lengths (ragged chunks): held to each other they differ by up to 1.2
    # of it on some draws while each stays within 0.81 of it from float64
    # (PERF.md, K4's check).  bf16 y (the serving path's) is held to the plain
    # version within a bf16 step at each prompt length.
    gen4 = torch.Generator(device.type).manual_seed(K4_SEED)
    randn4 = lambda *s: torch.randn(*s, generator=gen4, device=device)  # noqa: E731
    err, worst = 0.0, {"kernel": 0.0, "plain": 0.0}
    cases = [(4096, f" draw {i}") for i in range(K4_DRAWS)] + [(S, "") for S in SERVE_PROMPTS[1:]]
    for S, draw in cases:
        args = ssd_draw(randn4, S, torch.float32)
        y64, s64 = ref.ssd_reference(*args, dtype=torch.float64)
        for name, (y, st) in (("kernel", ssd.ssd_chunk_scan(*args)), ("plain", ref.ssd_scan(*args, chunk=ssd.CHUNK))):
            r = max(_bound_ratio(y, y64, 1e-4, 1e-4), _bound_ratio(st, s64, 1e-4, 1e-4))
            check(r <= 1, f"ssd_chunk_scan float32 S={S}{draw}: the {name} version off the float64 recurrence by "
                          f"{r:.4g} of atol 1e-4 + rtol 1e-4 |y|")
            worst[name] = max(worst[name], r)
            if name == "kernel":
                e = max(float((y.double() - y64).abs().max()), float((st.double() - s64).abs().max()))
        err = max(err, e)
        print(f"  ssd_chunk_scan x[1,{S},64,64] float32{draw}: y and final state within {e:.4g} of float64")
        del args, y64, s64
    print(f"  ssd_chunk_scan float32, {len(cases)} draws: worst error against float64 over atol 1e-4 + rtol 1e-4 |y|: "
          f"kernel {worst['kernel']:.4g}, plain version {worst['plain']:.4g}")
    for S in SERVE_PROMPTS:
        x, dt, A, Bm, Cm = ssd_draw(randn4, S, torch.bfloat16)
        y, st = ssd.ssd_chunk_scan(x, dt, A, Bm, Cm)
        y_ref, _ = ref.ssd_scan(x, dt, A, Bm, Cm, chunk=ssd.CHUNK)
        _, s64 = ref.ssd_reference(x, dt, A, Bm, Cm, dtype=torch.float64)
        e = _close(y, y_ref, **_tol(torch.bfloat16, 1e-4), what=f"ssd_chunk_scan y S={S} bf16")
        r = _bound_ratio(st, s64, 1e-4, 1e-4)
        check(r <= 1, f"ssd_chunk_scan bf16 S={S}: final state off float64 by {r:.4g} of atol 1e-4 + rtol 1e-4 |s|")
        err = max(err, e)
        print(f"  ssd_chunk_scan x[1,{S},64,64] bfloat16: y within {e:.3g} of the plain version, final state "
              f"within {r:.3g} of the float64 bound")
    x, dt, A, Bm, Cm = ssd_draw(randn4, 4096, torch.bfloat16)
    # one op call launches three device kernels (chunk states, state pass, chunk
    # outputs): its time is theirs summed, each the mean of its launches
    split = kernel_split_ms(lambda: ssd.ssd_chunk_scan_op(x, dt, A, Bm, Cm), 20, r"(ssd_\w+_kernel)")
    check(len(split) == 3, f"ssd_chunk_scan: the profiler saw the kernels {sorted(split)}, want 3")
    rec = dict(
        # x in and y out in bf16; dt, A, B, C in and the final state [1,64,64,64] out in f32
        max_abs_err=err, bytes=2 * x.numel() * 2 + (dt.numel() + A.numel() + 2 * Bm.numel() + 64 * 64 * 64) * 4,
        ops=ssd.operations(1, 4096, 64, 64, 64), peak=FP32_OPS_PER_S, exps=dt.numel(),
        ms=(sum(split.values()), "profiler, the three kernels' means summed"), ms_by_kernel=split,
        plain_ms=device_ms(lambda: ref.ssd_scan(x, dt, A, Bm, Cm, chunk=ssd.CHUNK), 3), library_ms=None)
    del x, dt, A, Bm, Cm
    return rec


def scan_record(device) -> dict:
    """K5 against its plain version and beside the float64 recurrence at
    falcon-mamba's shapes and the serving path's prompt lengths; its record,
    timed in bf16 at each of them."""
    import torch

    from repro_torch.kernels import ref, sscan

    # K5: falcon-mamba's Mamba1 layers: u, dt [1,S,8192], A [8192,16], B, C [1,S,16],
    # D [8192], at the serving path's prompt lengths; held to the plain version at
    # the reference's atol 2e-4 (float32) and a bf16 step (bf16), and printed
    # beside the float64 recurrence (ex2.approx against the plain version's exp)
    gen5 = torch.Generator(device.type).manual_seed(K5_SEED)
    randn5 = lambda *s: torch.randn(*s, generator=gen5, device=device)  # noqa: E731
    err = 0.0
    for S in SERVE_PROMPTS:
        for dtype in (torch.bfloat16, torch.float32):
            args = scan_draw(randn5, S, dtype)
            y, st = sscan.selective_scan(*args)
            y_ref, st_ref = ref.selective_scan(*args)
            y64, s64 = ref.selective_scan_reference(*args, dtype=torch.float64)
            e = max(_close(y, y_ref, **_tol(dtype, 2e-4), what=f"selective_scan y S={S} {dtype}"),
                    _close(st, st_ref, atol=2e-4, rtol=1e-4, what=f"selective_scan state S={S} {dtype}"))
            err = max(err, e)
            e64 = [float((t.double() - w).abs().max()) for t, w in ((y, y64), (st, s64), (y_ref, y64), (st_ref, s64))]
            print(f"  selective_scan u[1,{S},8192] N=16 {str(dtype)[6:]}: y and final state within {e:.3g} of the "
                  f"plain version; against float64 y {e64[0]:.3g}, state {e64[1]:.3g} (the plain version's "
                  f"{e64[2]:.3g}, {e64[3]:.3g})")
            del args, y64, s64
    timed = {S: scan_draw(randn5, S, torch.bfloat16) for S in SERVE_PROMPTS}
    u, dt, A, Bm, Cm, D = timed[4096]
    rec = dict(
        # u in and y out in bf16; dt, A, B, C, D in and the final state [1,8192,16] (A's size) out in f32
        max_abs_err=err,
        bytes=2 * u.numel() * 2 + (dt.numel() + A.numel() + 2 * Bm.numel() + D.numel() + A.numel()) * 4,
        ops=sscan.selective_scan_operations(1, 4096, 8192, 16), peak=FP32_OPS_PER_S, exps=dt.numel() * A.shape[1],
        ms=device_ms(lambda: sscan.selective_scan_op(u, dt, A, Bm, Cm, D), 20, "selective_scan_kernel"),
        plain_ms=device_ms(lambda: ref.selective_scan(u, dt, A, Bm, Cm, D), 3), library_ms=None,
        ms_by_prompt={S: device_ms(lambda a=a: sscan.selective_scan_op(*a), 20, "selective_scan_kernel")[0]
                      for S, a in timed.items()})
    del timed, u, dt, A, Bm, Cm, D
    return rec


def _scan_grads(fn, args, cots, dev) -> list:
    """The gradients of (y, final state) of the scan ``fn`` on ``dev`` at the
    cotangents ``cots``, on the CPU."""
    import torch

    xs = [a.detach().to(dev).requires_grad_(True) for a in args]
    y, state = fn(*xs)
    return [g.cpu() for g in torch.autograd.grad([y, state], xs, [c.to(dev) for c in cots])]


SCAN_GRAD_NAMES = {"selective_scan": ("u", "dt", "A", "B", "C", "D"), "ssd_chunk_scan": ("x", "dt", "A", "B", "C")}


def scan_backward_cases() -> list:
    """The scans' backward checks' cases at the training shapes, drawn on the
    CPU from seeded generators: (kernel, dtype, inputs, cotangents of y and
    of the final state), K5 at falcon-mamba's layer and K4 at zamba2's, each
    in bf16 and float32.  K5's float32 case takes its bf16 case's values:
    the CPU's bf16 function computes in float32 and casts gu to bf16 at the
    end, so one float32 run on the CPU (the costly one, ~1 min) serves both
    (tests/test_torch_ssm_grad.py holds that equality bit for bit)."""
    import torch

    gen5 = torch.Generator().manual_seed(K5_SEED + 10)
    randn5 = lambda *s: torch.randn(*s, generator=gen5)  # noqa: E731
    gen4 = torch.Generator().manual_seed(K4_SEED + 10)
    randn4 = lambda *s: torch.randn(*s, generator=gen4)  # noqa: E731
    args, cots = scan_draw(randn5, 4096, torch.bfloat16), (randn5(1, 4096, 8192).bfloat16(), randn5(1, 8192, 16))
    cases = [("selective_scan", torch.bfloat16, args, cots),
             ("selective_scan", torch.float32, [a.float() for a in args], [c.float() for c in cots])]
    cases += [("ssd_chunk_scan", dtype, ssd_draw(randn4, 4096, dtype),
               (randn4(1, 4096, 64, 64).to(dtype), randn4(1, 64, 64, 64))) for dtype in (torch.bfloat16, torch.float32)]
    return cases


def card_scan_backward_checks(device, cases: list, rec: dict) -> list:
    """The card's side of each scan's backward check (plain PyTorch from the
    state entering each of the kernel's chunks): K5's entering states against
    the plain version's at the same chunking, its y and final state bit for
    bit those of the launch that writes none; each backward's time (events)
    and the device memory it takes above its inputs; the gradients on the
    card, returned (on the host) for ``hold_scan_backward``.  Adds K5's time
    with the entering-state output, timed in turns with the launch without,
    to its record."""
    import torch

    from repro_torch.kernels import ref, ssd, sscan

    fns = {"selective_scan": (sscan.selective_scan, sscan.selective_scan_states_op, ref.selective_scan_bwd,
                              sscan.CHUNK),
           "ssd_chunk_scan": (ssd.ssd_chunk_scan, ssd.ssd_chunk_scan_states_op, ref.ssd_scan_bwd, ssd.CHUNK)}
    out = []
    for name, dtype, args, cots in cases:
        fn, states_op, bwd, chunk = fns[name]
        args, cots = [a.to(device) for a in args], [c.to(device) for c in cots]
        y, state, entering = states_op(*args)
        what = f"{name} {tuple(args[0].shape)} {str(dtype)[6:]}"
        line = ""
        if name == "selective_scan":
            y0, s0 = sscan.selective_scan_op(*args)
            check(torch.equal(y, y0) and torch.equal(state, s0),
                  f"{what}: y or the final state moved when the entering states were written")
            _, _, want = ref.selective_scan_states(*args, chunk=chunk)
            line = f"entering states within {_close(entering, want, 2e-4, 1e-4, f'{what} entering states'):.3g} " \
                   f"of the plain version's; "
            del y0, s0, want
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = queued_ms(lambda: bwd(*args, entering, *cots, chunk=chunk), 3)
        gib = (torch.cuda.max_memory_allocated() - base) / 2**30
        del y, state, entering
        out.append((what, name, _scan_grads(fn, args, cots, device)))
        del args, cots
        print(f"  {what}: {line}backward {ms:.3f} ms (events), {gib:.2f} GiB above its inputs")
    gen5 = torch.Generator(device.type).manual_seed(K5_SEED + 20)
    u, dt, A, Bm, Cm, D = scan_draw(lambda *s: torch.randn(*s, generator=gen5, device=device), 4096, torch.bfloat16)
    turns = {"without": [], "with": []}
    for which in ("without", "with", "with", "without"):
        op = sscan.selective_scan_op if which == "without" else sscan.selective_scan_states_op
        turns[which].append(device_ms(lambda: op(u, dt, A, Bm, Cm, D), 20, "selective_scan_kernel")[0])
    rec["selective_scan"]["ms_with_entering_states"] = statistics.mean(turns["with"])
    print(f"  selective_scan u[1,4096,8192] bf16, in turns: without the entering states "
          f"{', '.join(f'{x:.6f}' for x in turns['without'])} ms, with them "
          f"{', '.join(f'{x:.6f}' for x in turns['with'])} ms")
    return out


def start_cpu_scan_backward(cases: list) -> list:
    """The same backwards on the CPU, on a host thread while the kernels
    phase runs (its times are device times; beside the host-bound paths or
    the training path the thread slowed what they measure).  K5's bf16 case
    takes its result from the float32 case's (``scan_backward_cases``).
    Returns a future for each case."""
    import concurrent.futures

    import torch

    from repro_torch.kernels import ssd, sscan

    def k5_bf16(f32):
        grads = f32.result()
        return [grads[0].bfloat16(), *grads[1:]]

    fns = {"selective_scan": sscan.selective_scan, "ssd_chunk_scan": ssd.ssd_chunk_scan}
    pool = concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="scan-backward-cpu")
    futures = {(name, dtype): pool.submit(_scan_grads, fns[name], args, cots, "cpu")
               for name, dtype, args, cots in cases if (name, dtype) != ("selective_scan", torch.bfloat16)}
    futures["selective_scan", torch.bfloat16] = pool.submit(k5_bf16, futures["selective_scan", torch.float32])
    pool.shutdown(wait=False)
    return [futures[name, dtype] for name, dtype, _, _ in cases]


def hold_scan_backward(card: list, futures: list) -> None:
    """Each scan's backward on the card against the same function on the CPU.
    Tolerances as tests/test_torch_ssm_grad.py's: atol 2e-4 (K5) / 1e-4 (K4)
    plus rtol 1e-4 of each gradient's largest entry; a bf16 gradient (u's,
    x's) 2e-2 plus 1e-2 of it (a bf16 step is 2^-8 of the value)."""
    import torch

    t0 = time.perf_counter()
    wants = [f.result() for f in futures]
    print(f"  the CPU's side: {time.perf_counter() - t0:.1f} s waited for it")
    for (what, name, got), want in zip(card, wants):
        atol = 2e-4 if name == "selective_scan" else 1e-4
        worst = 0.0
        for n, g, w in zip(SCAN_GRAD_NAMES[name], got, want):
            scale = float(w.float().abs().max())
            tol = atol + 1e-4 * scale if g.dtype == torch.float32 else 2e-2 + 1e-2 * scale
            err = float((g.double() - w.double()).abs().max())
            check(bool(torch.isfinite(g.float()).all()) and err <= tol,
                  f"{what} backward: the gradient of {n} on the card off the CPU's by {err:.3g} (bound {tol:.3g})")
            worst = max(worst, err / tol)
        print(f"  {what}: backward on the card within {worst:.3g} of its bound from the CPU's")


def phase_model_kernels(device, scan_cases: list, cpu: list) -> dict:
    """K3-K5 on the card (each kernel's inputs from a generator of its own),
    and the scans' backwards on ``scan_cases`` on the card against the CPU
    (``cpu``: the futures of ``start_cpu_scan_backward``); returns the
    records with (ms, method) pairs turned into ms."""
    rec = attention_records(device)
    stamp("attention's cases and records")
    rec["ssd_chunk_scan"] = ssd_record(device)
    stamp("K4's checks and record")
    rec["selective_scan"] = scan_record(device)
    stamp("K5's checks and record")
    hold_scan_backward(card_scan_backward_checks(device, scan_cases, rec), cpu)
    stamp("the scans' backwards")
    for r in rec.values():  # (ms, method) pairs -> ms
        r["ms_method"] = r["ms"][1]
        r["ms"], r["plain_ms"] = r["ms"][0], r["plain_ms"][0]
        if r["library_ms"] is not None:
            r["library_ms"] = r["library_ms"][0]
    return rec


def serve_config(name: str):
    """A serving model's config, at its depth cut if it has one."""
    from repro_torch.configs import get_config

    cfg = get_config(name)
    return dataclasses.replace(cfg, n_layers=SERVE_DEPTH[name]) if name in SERVE_DEPTH else cfg


def serve_bounds(cfg, S: int, ctx: int) -> dict:
    """Lower bounds, in ms (``bound_terms``: bytes and operations), of a
    transformer-family model's prefill of ``S`` tokens (batch 1) and of a
    2-slot decode step with ``ctx`` tokens cached in each slot, bf16 weights
    and cache on the tensor cores.  Bytes: each weight a step needs read once
    (a MoE step: the experts its tokens can pick, at most all), the k and v it
    writes (prefill) or reads (decode), the LM head.  Operations: 2 a
    multiply-add of the products on the tokens (a MoE token: top_k experts)
    and attention's (``flash_attention.operations``; the vlm's cross layers
    over its patches, whose k and v a prefill projects)."""
    from repro_torch.kernels import flash_attention as fa

    d, H, KV, hd, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab_size
    ncb = cfg.audio.n_codebooks if cfg.audio else 1
    qo, kv = 2 * d * H * hd, 2 * d * KV * hd  # projection weights of q and o, of k and v
    if cfg.moe:
        e = cfg.moe
        expert = 3 * d * e.d_ff_expert
        mlp_tok, mlp_all = e.top_k * expert + d * e.n_experts, lambda t: min(e.n_experts, t * e.top_k) * expert
    else:
        mlp_tok = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
        mlp_all = lambda t: mlp_tok  # noqa: E731
    n_cross = cfg.n_layers // cfg.vision.cross_attn_every if cfg.vision else 0
    n_self, P = cfg.n_layers - n_cross, (cfg.vision.n_patches if cfg.vision else 0)
    head = d * V * ncb
    out = {}
    for step, T, B in (("prefill", S, 1), ("decode", 1, 2)):
        tok_params = n_self * (qo + kv + mlp_tok) + n_cross * (qo + mlp_tok) + head
        ops = 2 * B * T * tok_params
        weights = cfg.n_layers * (qo + kv + mlp_all(B * T)) + head
        if step == "prefill":
            ops += n_self * fa.operations(1, H, S, S, hd, True) + n_cross * fa.operations(1, H, S, P, hd, False)
            ops += 2 * P * (cfg.vision.d_vision * d + n_cross * kv) if cfg.vision else 0
            kv_bytes = (S * n_self + P * n_cross) * 2 * KV * hd * 2
        else:
            ops += B * (n_self * H * ctx + n_cross * H * P) * (4 * hd + 1)
            kv_bytes = B * (ctx * n_self + P * n_cross) * 2 * KV * hd * 2
        terms = bound_terms({"bytes": 2 * weights + kv_bytes, "ops": ops, "peak": BF16_TC_OPS_PER_S, "exps": 0})
        out[step] = {"bound_ms": max(terms["bytes"], terms["operations"]), "bytes_ms": terms["bytes"],
                     "operations_ms": terms["operations"], "ops": ops, "bytes": 2 * weights + kv_bytes}
    return out


def attention_launches(cfg, n_requests: int, n_decode_steps: int) -> int:
    """The serving path's launches of the bf16 attention kernel for one
    model: every attention layer of a prefill (zamba2: each shared block; the
    vlm: its self and cross layers), and the vlm's cross layers at each decode
    step (self-attention decode is plain PyTorch, as in the reference)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid.attn_every * n_requests
    n = cfg.n_layers * n_requests
    if cfg.family == "vlm":
        n += cfg.n_layers // cfg.vision.cross_attn_every * n_decode_steps
    return n


def phase_serve(device) -> dict:
    """Each serving model behind the token engine; returns, per model, its
    launches of the two attention kernels (bf16 tensor-core, float32-pipe)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, Request

    per_model = {}
    for name in SERVE_MODELS:
        t_model = time.perf_counter()
        cfg = serve_config(name)
        model = build_model(cfg)
        if name in SERVE_DEPTH:
            print(f"  serve {name}: full width, depth cut to {cfg.n_layers} of {get_config(name).n_layers} layers")
        before = {k: runtime.LAUNCHES[k] for k in ("flash_attention_sm90", "flash_attention")}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(seed=0, device=device)
        torch.cuda.synchronize()
        print(f"  serve {name}: {model.param_count() / 1e9:.3f} B parameters drawn on the card in "
              f"{time.perf_counter() - t0:.2f} s (peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while "
              f"drawing)")
        eng = Engine(model, params, slots=2, max_len=SERVE_MAX_LEN, device=device)
        del params  # the engine keeps the cast copy
        torch.cuda.synchronize()
        loaded = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        rng = np.random.default_rng(0)
        tail = (cfg.audio.n_codebooks,) if cfg.audio else ()
        for rid, n in enumerate(SERVE_PROMPTS):
            eng.submit(Request(rid=rid, prompt=rng.integers(0, cfg.vocab_size, (n,) + tail),
                               max_tokens=SERVE_NEW_TOKENS))
        decode_ms, n_steps, busy, n_kern, profiled_ms = [], 0, 0.0, 0, 0.0
        t_start = time.perf_counter()
        while eng.queue or any(r is not None for r in eng.slot_req):
            admitted = [r for r in eng.queue[:eng.slot_req.count(None)]]
            t0 = time.perf_counter()
            if n_steps == 1:  # a pure decode step (both slots busy, two requests waiting)
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    eng.step()
                    torch.cuda.synchronize()
                    profiled_ms = (time.perf_counter() - t0) * 1e3
                rows = device_rows(prof)
                busy, n_kern = sum(r[0] for r in rows), sum(r[1] for r in rows)
            else:
                eng.step()
                torch.cuda.synchronize()
                decode_ms.append((time.perf_counter() - max([t0] + [r.t_first for r in admitted])) * 1e3)
            n_steps += 1  # every engine step here ends in one batched decode step
        wall = time.perf_counter() - t_start
        done = sorted(eng.finished, key=lambda r: r.rid)
        check(len(done) == len(SERVE_PROMPTS), f"{name}: {len(done)} of {len(SERVE_PROMPTS)} requests finished")
        for r in done:
            toks = np.asarray(r.generated)
            check(toks.shape == (SERVE_NEW_TOKENS,) + tail and bool(np.all((0 <= toks) & (toks < cfg.vocab_size))),
                  f"{name}: request {r.rid} generated {r.generated}")
        check(all(bool(torch.isfinite(v.float()).all()) for k, v in eng.cache.items() if k != "len"),
              f"{name}: non-finite values in the decode cache")
        launched = {k: runtime.LAUNCHES[k] - n for k, n in before.items()}
        want = attention_launches(cfg, len(SERVE_PROMPTS), n_steps)
        check(launched == {"flash_attention_sm90": want, "flash_attention": 0},
              f"{name}: attention launches {launched}, want {want} of flash_attention_sm90 and 0 of the float32 "
              f"kernel")
        per_model[name] = launched
        n_tok = sum(len(r.generated) for r in done)
        print(f"  serve {name}: prefill ms by prompt length: "
              + ", ".join(f"{len(r.prompt)}: {(r.t_first - r.t_admit) * 1e3:.2f}" for r in done))
        print(f"  serve {name}: decode ms per engine step (2 slots): median {statistics.median(decode_ms):.3f}, "
              f"min {min(decode_ms):.3f}, max {max(decode_ms):.3f} over {len(decode_ms)} steps")
        if cfg.family not in ("ssm", "hybrid"):
            bounds = {S: serve_bounds(cfg, S, 0) for S in SERVE_PROMPTS}
            print(f"  serve {name}: bounds (serve_bounds, bf16 on the tensor cores): prefill ms by prompt length "
                  + ", ".join(f"{S}: {b['prefill']['bound_ms']:.3f}" for S, b in bounds.items())
                  + f"; decode step {bounds[64]['decode']['bound_ms']:.3f} (weights alone), "
                  f"{serve_bounds(cfg, 64, 4096)['decode']['bound_ms']:.3f} at 4,096 tokens cached a slot")
        print(f"  serve {name}: {n_tok} tokens in {wall:.3f} s, {n_tok / wall:.2f} generated tokens/s end to end "
              f"(prefills included); {n_steps} engine steps")
        print(f"  serve {name}: device memory {loaded / 2**30:.2f} GiB after load (cast weights and cache), "
              f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB while serving")
        if busy > 0:
            med = statistics.median(decode_ms)
            print(f"  serve {name}: one profiled decode step: {n_kern} kernels, device busy {busy:.3f} ms (wall "
                  f"{profiled_ms:.3f} ms "
                  f"under the profiler); idle share {max(0.0, 1 - busy / med):.3f} of the unprofiled median step "
                  f"({med:.3f} ms)")
        else:
            print(f"  serve {name}: decode-step idle share not measured (the profiler saw no device time)")
        print(f"  serve {name}: attention launches {launched} (want {want} on the tensor cores); model wall "
              f"{time.perf_counter() - t_model:.1f} s")
        del eng, model
        gc.collect()
        torch.cuda.empty_cache()
    return per_model


def agree_config(ref, key: str):
    """A fixture entry's config: float32 at its depth, and at its expert count
    where it cuts the experts (``n_experts``)."""
    from repro_torch.configs import get_config

    cfg = get_config(str(ref[f"{key}/name"]))
    kw = dict(dtype="float32", n_layers=int(ref[f"{key}/n_layers"]))
    if f"{key}/n_experts" in ref:
        kw["moe"] = dataclasses.replace(cfg.moe, n_experts=int(ref[f"{key}/n_experts"]))
    return dataclasses.replace(cfg, **kw)


def agree_weights(ref, key: str) -> dict:
    """A fixture entry's numpy weights: ``init_numpy(seed)`` at its depth, with
    the cross layers' gates the fixture stores (they start at 0, which would
    zero the cross path)."""
    from repro_torch.models import build_model

    w = build_model(agree_config(ref, key)).init_numpy(int(ref[f"{key}/seed"]))
    if f"{key}/attn_gate" in ref:
        w["cross_layers"]["attn_gate"], w["cross_layers"]["mlp_gate"] = ref[f"{key}/attn_gate"], ref[f"{key}/mlp_gate"]
    return w


def prefetch_agree_weights(path) -> dict:
    """Start making a fixture's numpy weights on a host thread, entry by entry
    (numpy draws without holding the interpreter lock, so the paths before the
    agreement path run meanwhile: 10.4 B float32 draws, 41.6 GB, for
    torch_lm_ref.npz, 2.3 B for torch_ssm_ref.npz).  Returns {entry: future};
    the thread is a daemon, so a failed run exits without waiting for it."""
    import concurrent.futures
    import threading

    import numpy as np

    ref = dict(np.load(path))
    futures = {str(k): concurrent.futures.Future() for k in ref["entries"]}

    def make():
        for key, fut in futures.items():
            try:
                fut.set_result(agree_weights(ref, key))
            except Exception as exc:  # handed to the agreement path, which raises it
                fut.set_exception(exc)

    threading.Thread(target=make, name="agree-weights", daemon=True).start()
    return futures


def vision_input(cfg, seed: int):
    """The agreement path's vision input, as tools/make_torch_lm_ref.py makes it."""
    import numpy as np

    return np.random.default_rng(seed).standard_normal((1, cfg.vision.n_patches, cfg.vision.d_vision),
                                                       dtype=np.float32)


def phase_agree(device, path=FIXTURE, weights=None) -> None:
    """This package on the card, float32, against a fixture of the reference's
    logits; ``weights`` maps an entry to a future of its numpy weights (else
    they are made here)."""
    import numpy as np
    import torch

    from repro_torch.models import build_model, params_from_numpy

    ref = dict(np.load(path))
    for key in [str(k) for k in ref["entries"]]:
        t_entry = time.perf_counter()
        cfg = agree_config(ref, key)
        model = build_model(cfg)
        t0 = time.perf_counter()
        w = weights.pop(key).result() if weights is not None else agree_weights(ref, key)
        t_wait = time.perf_counter() - t0
        params = params_from_numpy(cfg, w, device)
        del w
        t_init = time.perf_counter() - t0
        vision = None
        if cfg.vision:
            vision = torch.from_numpy(vision_input(cfg, int(ref[f"{key}/vision_seed"]))).to(device)
        prompt = torch.as_tensor(ref[f"{key}/prompt"], device=device)[None]
        tokens, top_idx, top_val = ref[f"{key}/tokens"], ref[f"{key}/top_idx"], ref[f"{key}/top_val"]
        bound = max(AGREE_FLOOR, AGREE_FACTOR * float(np.max(ref[f"{key}/spread"])))
        logits, cache = model.prefill(params, prompt, max_len=prompt.shape[1] + len(tokens), vision=vision)
        steps = [logits[0]]
        for t in tokens[:-1]:  # teacher-forced with the fixture's greedy tokens ([ncb] a step for audio)
            t = torch.as_tensor(np.asarray(t), device=device)
            logits, cache = model.decode_step(params, t.reshape((1, 1) + tuple(t.shape)), cache)
            steps.append(logits[0])
        router = (f"; the reference's smallest top-k router margin {float(ref[f'{key}/router_margin']):.3g}"
                  if f"{key}/router_margin" in ref else "")
        worst, checked, total = 0.0, 0, 0
        for i, lg in enumerate(steps):
            lg = lg.double().cpu().numpy()
            check(bool(np.all(np.isfinite(lg))), f"{key} step {i}: non-finite logits")
            lg = lg.reshape(-1, lg.shape[-1])  # [codebooks, V]
            scale = float(np.max(np.abs(top_val[i])))
            rel = float(np.max(np.abs(lg.reshape(-1)[top_idx[i]] - top_val[i]))) / scale
            worst = max(worst, rel)
            check(rel <= bound, f"{key} step {i}: logits off the fixture by rel {rel:.3g} (bound {bound:.3g}){router}")
            # each codebook's top-2 margin (the SSM fixture has one codebook and no stored margins)
            margin = (ref[f"{key}/margin"][i] if f"{key}/margin" in ref
                      else [float(top_val[i][0] - top_val[i][1]) / scale])
            want = np.asarray(tokens[i]).reshape(-1)
            for c, m in enumerate(margin):
                total += 1
                if m > bound:
                    checked += 1
                    check(int(lg[c].argmax()) == int(want[c]),
                          f"{key} step {i} codebook {c}: greedy token {int(lg[c].argmax())}, fixture {int(want[c])}")
        made = f"{t_wait:.1f} s of it waiting for the host thread" if weights is not None else "on this thread"
        print(f"  agree {key} (float32, weights made in {t_init:.1f} s, {made}): prefill + {len(tokens) - 1} "
              f"decode steps within rel {worst:.3g} of the fixture (bound "
              f"{bound:.3g}, the reference's own spread {float(np.max(ref[f'{key}/spread'])):.3g}); greedy tokens "
              f"equal at the {checked} of {total} steps and codebooks whose top-2 margin exceeds the bound{router}; "
              f"entry wall {time.perf_counter() - t_entry:.1f} s")
        del params, cache, model
        gc.collect()
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------- #
# the training path: the train step and the Trainer on the transformer families
# --------------------------------------------------------------------------- #

TRAIN_FIXTURE = ROOT / "tests" / "data" / "torch_train_ref.npz"  # made by tools/make_torch_train_ref.py
TRAIN_FIXTURE_KEY = "granite-3-8b@2"  # the torch_lm_ref.npz entry whose numpy weights it shares
# (name, layers kept, batch, sequence, microbatches, steps, int8 states, one fixed batch)
TRAIN_RUNS = (
    ("granite-3-8b", 4, 2, 4096, 2, 5, False, False),  # the main run: train_4k's sequence
    ("musicgen-large", 12, 1, 4096, 1, 3, False, False),  # 12 of 48: at 24 with kimi-k2 served, 600 s passed
    ("llama-3.2-vision-11b", 5, 1, 1024, 1, 5, False, True),  # one group: 4 self layers and a cross layer
    ("llama4-scout-17b-a16e", 1, 1, 1024, 1, 5, True, True),  # 16 experts; int8 moments: 38.6 GiB of state
    ("zamba2-1.2b", 38, 1, 4096, 1, 3, False, False),  # full depth: 1.183 B parameters, 17.6 GiB with grads
    ("falcon-mamba-7b", 8, 1, 4096, 1, 3, False, False),  # 8 of 64 (16 until kimi-k2 was served): 1.375 B
)
TRAINER_STEPS, TRAINER_CKPT_EVERY, TRAINER_FAIL_AT = 8, 4, 6
TRAINER_MODEL, TRAINER_LAYERS, TRAINER_BATCH, TRAINER_SEQ = "musicgen-large", 2, 2, 1024
BWD_RANGE = "repro_torch::chunked_attention_backward"  # layers.py's profiler range around the backward
# the SSM families' training numbers from the reference (tools/make_torch_train_ref.py --ssm), one entry a
# model; their numpy weights are torch_ssm_ref.npz's entries of the same name
SSM_TRAIN_FIXTURE = ROOT / "tests" / "data" / "torch_ssm_train_ref.npz"


def train_attention_launches(cfg, steps: int, microbatches: int) -> int:
    """The attention kernel's launches of ``steps`` train steps under
    ``remat="full"``: each self layer's forward and its recompute in the
    backward, each vlm cross layer's forward and each of the hybrid's shared
    blocks' (neither checkpointed, as in the reference); none in the ssm
    family."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return steps * microbatches * (cfg.n_layers // cfg.hybrid.attn_every)
    n_cross = cfg.n_layers // cfg.vision.cross_attn_every if cfg.vision else 0
    return steps * microbatches * (2 * (cfg.n_layers - n_cross) + n_cross)


def train_scan_launches(cfg, steps: int, microbatches: int) -> dict:
    """The scan kernels' launches of ``steps`` train steps under
    ``remat="full"``: each SSM layer's forward and its recompute in the
    backward (the backward itself launches none); K4 in the hybrid, K5 in the
    ssm family."""
    n = steps * microbatches * 2 * cfg.n_layers
    return {"ssd_chunk_scan": n if cfg.family == "hybrid" else 0, "selective_scan": n if cfg.family == "ssm" else 0}


def train_attention_cases() -> set:
    """Every shape the training path gives the attention kernel, as (B, Hq,
    Hkv, Sq, Skv, D, causal, dtype): each run of TRAIN_RUNS at its microbatch
    and the Trainer's in bf16, the float32 agreement at the fixture's batch;
    causal self layers, and the vlm's cross layers over the patches."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config

    runs = [(name, B // mb, S, torch.bfloat16) for name, _, B, S, mb, *_ in TRAIN_RUNS]
    runs.append((TRAINER_MODEL, TRAINER_BATCH, TRAINER_SEQ, torch.bfloat16))
    with np.load(TRAIN_FIXTURE) as ref:
        runs.append((str(ref["name"]), int(ref["batch"]), int(ref["seq"]), torch.float32))
    with np.load(SSM_TRAIN_FIXTURE) as ref:
        runs += [(str(ref[f"{k}/name"]), int(ref[f"{k}/batch"]), int(ref[f"{k}/seq"]), torch.float32)
                 for k in ref["entries"]]
    cases = set()
    for name, B, S, dtype in runs:
        cfg = get_config(name)
        if cfg.family == "ssm":  # no attention
            continue
        cases.add((B, cfg.n_heads, cfg.n_kv_heads, S, S, cfg.hd, True, dtype))
        if cfg.vision:
            cases.add((B, cfg.n_heads, cfg.n_kv_heads, S, cfg.vision.n_patches, cfg.hd, False, dtype))
    return cases


def train_bound(cfg, B: int, S: int) -> dict:
    """A train step's least time: model FLOPs over the bf16 tensor-core peak.
    6 x the matmul parameters a token meets x tokens (the MoE: its top_k
    experts and the router; the vlm: the vision projection and the cross
    layers' k and v on the patches; the SSM families: each layer's
    projections and the hybrid's shared block at each of its applications),
    plus 3 x attention's forward operations (``flash_attention.operations``:
    causal self layers and shared blocks, the cross layers over the patches).
    The scans' own operations (float32, ~0.4% of a falcon-mamba layer's) are
    not counted."""
    from repro_torch.kernels import flash_attention as fa

    d, H, KV, hd, V = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.vocab_size
    if cfg.family in ("ssm", "hybrid"):
        di, N = cfg.d_inner, cfg.ssm.d_state
        if cfg.family == "ssm":
            layer, n_shared, shared = d * 2 * di + di * (cfg.dt_rank + 2 * N) + cfg.dt_rank * di + di * d, 0, 0
        else:
            layer = d * (2 * di + 2 * N + di // cfg.ssm.head_dim) + di * d
            n_shared = cfg.n_layers // cfg.hybrid.attn_every
            shared = 2 * d * (H + 2 * KV) * hd + H * hd * d + 3 * d * cfg.hybrid.shared_attn_mlp_ff
        matmul = 6 * B * S * (cfg.n_layers * layer + n_shared * shared + d * V)
        attn = 3 * n_shared * fa.operations(B, H, S, S, hd, True) if n_shared else 0
        return {"flops": matmul + attn, "bound_ms": (matmul + attn) / BF16_TC_OPS_PER_S * 1e3}
    ncb = cfg.audio.n_codebooks if cfg.audio else 1
    qo, kv = 2 * d * H * hd, 2 * d * KV * hd
    if cfg.moe:
        mlp = cfg.moe.top_k * 3 * d * cfg.moe.d_ff_expert + d * cfg.moe.n_experts
    else:
        mlp = (3 if cfg.mlp_type == "swiglu" else 2) * d * cfg.d_ff
    n_cross = cfg.n_layers // cfg.vision.cross_attn_every if cfg.vision else 0
    n_self, P = cfg.n_layers - n_cross, (cfg.vision.n_patches if cfg.vision else 0)
    per_token = n_self * (qo + kv + mlp) + n_cross * (qo + mlp) + d * V * ncb
    per_patch = cfg.vision.d_vision * d + n_cross * kv if cfg.vision else 0
    matmul = 6 * (B * S * per_token + B * P * per_patch)
    attn = 3 * (n_self * fa.operations(B, H, S, S, hd, True) + n_cross * fa.operations(B, H, S, P, hd, False))
    return {"flops": matmul + attn, "bound_ms": (matmul + attn) / BF16_TC_OPS_PER_S * 1e3}


def range_device_ms(prof, names) -> dict[str, tuple[float, int]]:
    """For each name: the device time of the kernels that ran inside the
    device-side spans of the ``record_function`` ranges so called (one
    stream: the kernels between a span's start and end are the range's), and
    the spans seen; one pass over the profile's device events."""
    import bisect

    evs = [e for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))]
    kernels = [e.time_range for e in evs if not getattr(e, "is_user_annotation", False)]
    out = {}
    for name in names:
        spans = sorted((e.time_range.start, e.time_range.end) for e in evs
                       if e.name == name and getattr(e, "is_user_annotation", False))
        starts = [a for a, _ in spans]
        total = 0.0
        for r in kernels:
            i = bisect.bisect_right(starts, r.start) - 1
            if i >= 0 and r.start < spans[i][1]:
                total += r.end - r.start
        out[name] = (total / 1e3, len(spans))
    return out


def state_gib(state) -> float:
    from repro_torch import tree as tu

    return sum(t.numel() * t.element_size() for t in tu.leaves(state)) / 2**30


def train_run(device, name: str, n_layers: int, B: int, S: int, mb: int, steps: int, int8: bool,
              fixed: bool) -> dict:
    """One model trained ``steps`` steps by ``make_train_step`` (bf16, remat
    "full", AdamW with warmup_cosine), each timed by the host clock after a
    sync, then one more step under torch.profiler.  Holds finite losses, a
    falling loss on a fixed batch, and the attention and scan kernels'
    launches; prints step ms, tokens/s, the bound, the idle share, the
    attention backward's and each scan backward's share and peak memory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_to, make_batch
    from repro_torch.kernels import runtime, ssd, sscan
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    scan_ranges = {"ssd_chunk_scan": ssd.BACKWARD_RANGE, "selective_scan": sscan.BACKWARD_RANGE}
    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    model = build_model(cfg)
    # a fixed batch takes a larger lr, so that its loss falls within the few steps run
    opt = AdamWConfig(lr=1e-4 if not fixed else 1e-3, int8_states=int8, schedule=warmup_cosine(2, steps))
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(model, 0, opt, TrainConfig(microbatches=mb), device)
    torch.cuda.synchronize()
    depth = "full depth" if n_layers == full.n_layers else f"{n_layers} of {full.n_layers} layers"
    print(f"  train {name} ({depth}, full width, bf16, remat {cfg.remat}, {'int8' if int8 else 'fp32'} moments): "
          f"{model.param_count() / 1e9:.3f} B parameters, {state_gib(state):.2f} GiB of train state (params and "
          f"moments; grads come with the step) drawn in {time.perf_counter() - t0:.2f} s")
    shape = ShapeConfig("train", S, B, "train")
    data = [batch_to(make_batch(cfg, shape, s), device) for s in range(1 if fixed else steps + 1)]
    step_fn = make_train_step(model, opt, TrainConfig(microbatches=mb))
    before = {k: runtime.LAUNCHES[k] for k in ("flash_attention_sm90", "flash_attention", *scan_ranges)}
    ms, losses = [], []
    for s in range(steps + 1):  # the timed steps, then one under the profiler
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if s == steps:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                state, metrics = step_fn(state, data[0 if fixed else s])
                losses.append(float(metrics["total_loss"]))
            prof_ms = (time.perf_counter() - t0) * 1e3
        else:
            state, metrics = step_fn(state, data[0 if fixed else s])
            losses.append(float(metrics["total_loss"]))  # waits for the step
            ms.append((time.perf_counter() - t0) * 1e3)
    launched = {k: runtime.LAUNCHES[k] - n for k, n in before.items()}
    want = {"flash_attention_sm90": train_attention_launches(cfg, steps + 1, mb), "flash_attention": 0,
            **train_scan_launches(cfg, steps + 1, mb)}
    check(all(math.isfinite(x) for x in losses), f"train {name}: losses {losses}")
    if fixed:
        check(losses[-1] < losses[0], f"train {name}: the loss on one fixed batch did not fall: {losses}")
    check(launched == want,
          f"train {name}: launches {launched}, want {want} (steps x microbatches x: attention 2 a self layer + 1 a "
          f"cross layer or shared block; a scan 2 an SSM layer; none of the float32 attention kernel)")
    check(all(bool(torch.isfinite(p).all()) for p in state["params"]["layers"].values()),
          f"train {name}: non-finite parameters")
    rows = device_rows(prof)
    busy, n_kern = sum(r[0] for r in rows), sum(r[1] for r in rows)
    ranges = {k: r for k, r in (("flash_attention_sm90", BWD_RANGE), *scan_ranges.items()) if want[k]}
    spans = range_device_ms(prof, ranges.values())
    bwd, n_spans = spans.get(BWD_RANGE, (0.0, 0))
    scan_bwd = {k: spans[r] for k, r in scan_ranges.items() if want[k]}
    med = statistics.median(ms[-3:])
    bound = train_bound(cfg, B, S)
    tokens = B * S
    print(f"  train {name}: losses {[round(x, 4) for x in losses]}; step ms {[round(m, 1) for m in ms]}, then one "
          f"step under the profiler ({prof_ms:.1f} ms)")
    print(f"  train {name}: median step {med:.3f} ms over the last 3 timed steps, {tokens / med * 1e3:.1f} tokens/s "
          f"({B} x {S} tokens, {mb} microbatches); bound {bound['bound_ms']:.3f} ms "
          f"({bound['flops'] / 1e12:.2f} TFLOP over {BF16_TC_OPS_PER_S / 1e12:.0f} TFLOP/s), the step "
          f"{med / bound['bound_ms']:.2f}x its bound")
    if busy > 0:
        def share(ms_, n_):
            return (f"{ms_:.3f} ms over {n_} calls, {ms_ / busy:.3f} of device time" if n_
                    else "not measured (the profiler showed no device span of the range)")

        shares = "; ".join(f"the {k} backward (plain PyTorch): {share(*v)}" for k, v in scan_bwd.items())
        attn = f"the attention backward (plain PyTorch): {share(bwd, n_spans)}" if want["flash_attention_sm90"] else ""
        print(f"  train {name}: profiled step: {n_kern} kernels, device busy {busy:.3f} ms; idle share "
              f"{max(0.0, 1 - busy / med):.3f} of the median step; " + "; ".join(x for x in (attn, shares) if x))
        print(f"  train {name}: top kernels: " + "; ".join(f"{k[:56]} {t:.3f} ms x{c}"
                                                             for t, c, k in sorted(rows, reverse=True)[:6]))
    else:
        print(f"  train {name}: idle share not measured (the profiler saw no device time)")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  train {name}: launches {launched} (want {want}); peak device memory {peak:.2f} GiB")
    out = {"launched": launched, "median_ms": med, "bound_ms": bound["bound_ms"], "losses": losses,
           "busy_ms": busy, "bwd_ms": bwd, "peak_gib": peak}
    del state, data, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return out


def attention_backward_ms(device) -> None:
    """The attention backward alone at the main run's layer shape (q
    [1,32,4096,128] bf16 over 8 KV heads, causal), by CUDA events, beside
    the forward kernel: what the training path's profiled share should agree
    with."""
    import torch

    from repro_torch.models import layers

    gen = torch.Generator(device.type).manual_seed(K3_SEED)
    q, k, v, do = (torch.randn(1, h, 4096, 128, generator=gen, device=device).to(torch.bfloat16)
                   for h in (32, 8, 8, 32))
    out = layers.flash_attention(q, k, v, causal=True)
    bwd = queued_ms(lambda: layers.chunked_attention_bwd(q, k, v, out, do, causal=True, scale=128 ** -0.5), 5)
    fwd = queued_ms(lambda: layers.flash_attention(q, k, v, causal=True), 20)
    print(f"  attention at the main run's layer shape: backward {bwd:.3f} ms, forward kernel {fwd:.3f} ms a call "
          f"(events around calls queued behind a spin kernel)")


def phase_train(device) -> dict:
    """The training runs; returns the attention kernel's launches per run."""
    per_run = {}
    for run in TRAIN_RUNS:
        t0 = time.perf_counter()
        per_run[run[0]] = train_run(device, *run)["launched"]
        print(f"  train {run[0]}: wall {time.perf_counter() - t0:.1f} s")
    return per_run


def phase_trainer(device) -> dict:
    """The Trainer: TRAINER_MODEL at full width with TRAINER_LAYERS layers,
    TRAINER_BATCH x TRAINER_SEQ tokens, 8 steps, checkpoints every 4 into a
    temporary directory;
    one run uninterrupted, one with a failure injected at step 6, which must
    restore from step 4 and end with the same parameters (atol 1e-6).  Runs
    with deterministic algorithms (cuBLAS's workspace is fixed in ``main``
    before CUDA starts).  Returns the attention kernel's launches."""
    import shutil
    import tempfile

    import torch

    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.ft import FailureInjector
    from repro_torch.kernels import runtime
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    cfg = dataclasses.replace(get_config(TRAINER_MODEL), n_layers=TRAINER_LAYERS)
    shape = ShapeConfig("trainer", TRAINER_SEQ, TRAINER_BATCH, "train")
    opt = AdamWConfig(lr=1e-3, schedule=warmup_cosine(2, TRAINER_STEPS))
    before = runtime.LAUNCHES["flash_attention_sm90"]
    outs, logs = {}, []
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_trainer_") as tmp:
            for run, injector in (("uninterrupted", None), ("restarted", FailureInjector(fail_at=(TRAINER_FAIL_AT,)))):
                t0 = time.perf_counter()
                tr = Trainer(build_model(cfg), shape, opt,
                             rcfg=TrainerConfig(steps=TRAINER_STEPS, ckpt_every=TRAINER_CKPT_EVERY,
                                                ckpt_dir=f"{tmp}/{run}", log_every=0),
                             injector=injector, log_fn=logs.append, device=device)
                outs[run] = tr.run()
                steps = [h["step"] for h in tr.history]
                print(f"  trainer {run}: steps run {steps}, losses {[round(x, 4) for x in outs[run]['losses']]}, "
                      f"wall {time.perf_counter() - t0:.1f} s")
                outs[run]["steps"] = steps
                shutil.rmtree(f"{tmp}/{run}")  # ~2 GB a checkpoint
    finally:
        torch.use_deterministic_algorithms(False)
    check(any(f"restored checkpoint at step {TRAINER_CKPT_EVERY}" in s for s in logs),
          f"trainer: the restarted run did not restore step {TRAINER_CKPT_EVERY}: {logs}")
    check(outs["restarted"]["steps"] == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7],
          f"trainer: steps run {outs['restarted']['steps']}")
    worst = 0.0
    for (path, a), (_, b) in zip(tu.leaves_with_path(outs["uninterrupted"]["state"]["params"]),
                                 tu.leaves_with_path(outs["restarted"]["state"]["params"])):
        worst = max(worst, float((a.float() - b.float()).abs().max()))
    check(worst <= 1e-6, f"trainer: the restarted run's params differ from the uninterrupted run's by {worst:.3g} "
                         f"(atol 1e-6)")
    print(f"  trainer: restored from step {TRAINER_CKPT_EVERY} after the failure at step {TRAINER_FAIL_AT}; final "
          f"params equal the uninterrupted run's within {worst:.3g} (atol 1e-6); stragglers "
          f"{outs['restarted']['stragglers']}")
    n = runtime.LAUNCHES["flash_attention_sm90"] - before
    want = train_attention_launches(cfg, TRAINER_STEPS + len(outs["restarted"]["steps"]), 1)
    check(n == want, f"trainer: {n} attention launches, want {want}")
    del outs
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_sm90": n}


def train_distances(got: dict, ref) -> dict:
    """As tools/make_torch_train_ref.py's ``distances``: how far the port's
    training numbers are from the fixture, one number a measure."""
    import numpy as np

    ref_norm = np.asarray(ref["leaf_norm"], np.float64)
    ref_sample = np.asarray(ref["sample"], np.float64)
    scale = np.maximum(np.abs(ref_sample).max(1), ref_norm / np.sqrt(np.asarray(ref["leaf_size"], np.float64)))
    return {
        "loss": abs(got["loss"] - float(ref["loss"])) / abs(float(ref["loss"])),
        "grad_norm": abs(got["grad_norm"] - float(ref["grad_norm"])) / float(ref["grad_norm"]),
        "leaf_norm": float(np.max(np.abs(np.asarray(got["leaf_norm"], np.float64) - ref_norm) / ref_norm)),
        "sample": float(np.max(np.abs(np.asarray(got["sample"], np.float64) - ref_sample).max(1) / scale)),
        "history": float(np.max(np.abs(np.asarray(got["history"], np.float64) - ref["history"])
                                / np.abs(ref["history"]))),
    }


def fixture_entry(ref: dict, key: str | None) -> dict:
    """A fixture's fields, or one entry's of a fixture that keys them
    ``"<entry>/<field>"``."""
    return ref if key is None else {k[len(key) + 1:]: v for k, v in ref.items() if k.startswith(f"{key}/")}


def phase_train_agree(device, weights: dict, path=TRAIN_FIXTURE, key: str | None = None) -> None:
    """The port's training numbers on the card, float32, against a training
    fixture: tests/data/torch_train_ref.npz (``key`` None: granite-3-8b at
    full width with 2 of 40 layers on the weights of torch_lm_ref.npz's
    granite entry) or an entry of SSM_TRAIN_FIXTURE (falcon-mamba-7b at 2 of
    64 layers, zamba2-1.2b at 6 of 38, on torch_ssm_ref.npz's entries of the
    same name); ``weights`` maps the entry to a future of its numpy weights,
    left there for phase_agree.  2 x 128 tokens: the loss, the grad norm,
    per-leaf grad norms, sampled grads and 3 AdamW steps' losses, each within
    AGREE_FACTOR x the reference's own spread (at least AGREE_FLOOR)."""
    import numpy as np
    import torch

    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_to, make_batch
    from repro_torch.models import build_model, params_from_numpy
    from repro_torch.optim import AdamWConfig, global_norm, init_opt_state
    from repro_torch.train import make_train_step

    t_phase = time.perf_counter()
    ref = fixture_entry(dict(np.load(path)), key)
    label = key or TRAIN_FIXTURE_KEY
    cfg = dataclasses.replace(get_config(str(ref["name"])), dtype="float32", n_layers=int(ref["n_layers"]))
    model = build_model(cfg)
    params = params_from_numpy(cfg, weights[label].result(), device)
    # the fixture's batches: make_batch's Zipf stream is numpy's, which may differ between numpy versions
    shape = ShapeConfig("fixture", int(ref["seq"]), int(ref["batch"]), "train")
    same = all(np.array_equal(make_batch(cfg, shape, s)["tokens"], ref["tokens"][s]) for s in range(len(ref["tokens"])))
    print(f"  agree training {label}: make_batch with numpy {np.__version__} "
          f"{'reproduces' if same else 'does not reproduce'} the fixture's batches (made with numpy {ref['numpy']})")
    data = [batch_to({"tokens": t, "labels": lab}, device) for t, lab in zip(ref["tokens"], ref["labels"])]
    live = tu.tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(live, data[0])
    grads = torch.autograd.grad(loss, tu.leaves(live))
    paths = [p for p, _ in tu.leaves_with_path(params)]
    check(paths == [str(x) for x in ref["leaves"]], f"train agreement: leaves {paths}")
    got = {"loss": float(loss.detach()), "grad_norm": float(global_norm(list(grads))),
           "leaf_norm": [float(torch.sqrt(torch.sum(torch.square(g)))) for g in grads],  # a tree sum
           "sample": np.stack([g.reshape(-1)[torch.as_tensor(i, device=device)].cpu().numpy()
                               for g, i in zip(grads, ref["idx"])])}
    del live, grads, loss
    opt = AdamWConfig(lr=float(ref["lr"]))
    state = {"params": params, "opt": init_opt_state(params, opt),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step = make_train_step(model, opt)
    got["history"] = [float(step(state, b)[1]["total_loss"]) for b in data]
    dist = train_distances(got, ref)
    spread = dict(zip([str(m) for m in ref["measures"]], ref["spread"]))
    for k, d in dist.items():
        bound = max(AGREE_FLOOR, AGREE_FACTOR * float(spread[k]))
        check(d <= bound, f"train agreement: {k} off the fixture by {d:.3g} (bound {bound:.3g}, spread "
                          f"{float(spread[k]):.3g})")
    print(f"  agree training {label} (float32, 2 x {int(ref['seq'])} tokens): loss {got['loss']:.7g} "
          f"(fixture {float(ref['loss']):.7g}), history {[round(x, 6) for x in got['history']]}; "
          + ", ".join(f"{k} {d:.3g} (spread {float(spread[k]):.3g})" for k, d in dist.items())
          + f"; bound {AGREE_FACTOR:g}x the spread, at least {AGREE_FLOOR:g}; wall {time.perf_counter() - t_phase:.1f} s")
    del state, params, data
    gc.collect()
    torch.cuda.empty_cache()


def phase_launch(device) -> None:
    """The launchers as a user runs them, on the card: ``repro_torch.launch.train
    --reduced`` on falcon-mamba-7b (4 steps, 2 x 256 tokens) and
    ``repro_torch.launch.serve --reduced`` on zamba2-1.2b (4 requests of 8
    tokens); finite losses, every request answered."""
    from repro_torch.launch import serve, train

    t0 = time.perf_counter()
    out = train.main(["--arch", "falcon-mamba-7b", "--reduced", "--steps", "4", "--batch", "2", "--seq", "256",
                      "--warmup", "1"])
    check(len(out["losses"]) == 4 and all(math.isfinite(x) for x in out["losses"]),
          f"launch.train: losses {out['losses']}")
    done = serve.main(["--arch", "zamba2-1.2b", "--reduced", "--requests", "4", "--max-tokens", "8"])
    check(len(done) == 4 and all(len(r.generated) == 8 for r in done),
          f"launch.serve: {[(r.rid, len(r.generated)) for r in done]}")
    print(f"  launchers: train losses {[round(x, 4) for x in out['losses']]}, 4 requests served; wall "
          f"{time.perf_counter() - t0:.1f} s")


def phase_simulate(device) -> None:
    from repro_torch.core import ArchParams, Graph, TechParams, simulate_stacked
    from repro_torch.workloads import get_workload, lm_cell

    rows = json.loads((ROOT / "results/bench/sim_speed.json").read_text())["rows"]
    expect = {r["workload"]: r["cycles_dsim"] for r in rows}
    tech, arch = TechParams.default(device), ArchParams.default(device)
    graphs = [(n, get_workload(n, device=device)) for n in CLASSIC]
    graphs += [(f"{a}:{s}", lm_cell(a, s, device=device)) for a, s in LM]
    check(sorted(expect) == sorted(n for n, _ in graphs), "sim_speed.json rows differ from the 16 workloads")
    for name, g in graphs:
        gs = Graph.stack([g.pad_to(bucket(g.n_vertices))])
        cyc = float(simulate_stacked(tech, arch, gs).cycles[0])
        ok, err = rel_close(cyc, expect[name], 1e-5)
        check(ok, f"{name}: cycles {cyc} vs cycles_dsim {expect[name]} (rel {err:.3g})")

        def run():
            simulate_stacked(tech, arch, gs).cycles.sum().item()

        t = median_ms(run, device, n=5)
        print(f"  simulate {name:28s} V={g.n_vertices:4d} bucket={gs.n_vertices:5d} cycles={cyc:.6e} "
              f"rel_err={err:.2e} steady={t:.3f} ms")


def phase_optimize(device) -> None:
    from repro_torch.core import Graph, MapperCfg, optimize
    from repro_torch.workloads import get_workload, lm_cell

    gs = Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])
    t0 = time.perf_counter()
    r = optimize(gs, objective="edp", lr=0.05, steps=20, device=device)
    dt = (time.perf_counter() - t0) / 20
    obj = r.history["objective"]
    check(all(map(lambda x: x == x and abs(x) != float("inf"), obj)), "non-finite DOpt history")
    check(obj[-1] < obj[0], f"DOpt objective did not decrease: {obj[0]} -> {obj[-1]}")
    for k, want in REF_HISTORY.items():
        ok, err = rel_close(r.history[k], want, 1e-3)
        check(ok, f"DOpt history '{k}' off the reference package's by rel {err:.3g}")
        print(f"  optimize LM stack [5,1024]: history '{k}' within rel {err:.2e} of the reference")
    print(f"  optimize LM stack: objective {obj[0]:.4f} -> {obj[-1]:.4f} in 20 steps, {dt * 1e3:.2f} ms/step "
          f"(first call included)")
    t0 = time.perf_counter()
    optimize(gs, objective="edp", lr=0.05, steps=20, device=device)
    print(f"  optimize LM stack: {(time.perf_counter() - t0) / 20 * 1e3:.2f} ms/step (warm)")

    cs = Graph.stack([get_workload(n, device=device).pad_to(256) for n in CLASSIC])
    hist = {}
    for impl in ("ref", "auto"):
        t0 = time.perf_counter()
        hist[impl] = optimize(cs, objective="edp", lr=0.05, steps=3, mcfg=MapperCfg(scan_impl=impl),
                              device=device).history
        print(f"  optimize classic [11,256] scan_impl={impl}: {(time.perf_counter() - t0) / 3 * 1e3:.1f} ms/step")
    for k in REF_HISTORY:
        ok, err = rel_close(hist["auto"][k], hist["ref"][k], 1e-4)
        check(ok, f"classic stack: '{k}' of default vs scan_impl='ref' differs by rel {err:.3g}")
    print("  optimize classic: default and scan_impl='ref' histories agree within rtol 1e-4")


def phase_no_streaming(device) -> None:
    """Where the occupancy carry decides cycles: with MapperCfg(streaming=False)
    the default (auto) cycles of the 11 classic workloads (bucket 256) and of
    qwen2.5-32b:prefill_32k (bucket 1024) against the sequential oracle
    (scan_impl="ref"), within rtol 1e-5.  With streaming on, the occupancy
    reaches no cycle count, so the checks above would pass with it wrong."""
    from repro_torch.core import ArchParams, Graph, MapperCfg, TechParams, simulate_stacked
    from repro_torch.workloads import get_workload, lm_cell

    tech, arch = TechParams.default(device), ArchParams.default(device)
    stacks = {"classic [11,256]": (CLASSIC, Graph.stack([get_workload(n, device=device).pad_to(256)
                                                         for n in CLASSIC])),
              "qwen2.5-32b:prefill_32k [1,1024]": (["qwen2.5-32b:prefill_32k"], Graph.stack(
                  [lm_cell("qwen2.5-32b", "prefill_32k", device=device).pad_to(1024)]))}
    for what, (names, gs) in stacks.items():
        cyc = {impl: simulate_stacked(tech, arch, gs, mcfg=MapperCfg(streaming=False, scan_impl=impl)).cycles
               for impl in ("auto", "ref")}
        ok, err = rel_close(cyc["auto"].cpu(), cyc["ref"].cpu(), 1e-5)
        check(ok, f"streaming=False {what}: default cycles off scan_impl='ref' by rel {err:.3g}")
        print(f"  no streaming {what}: default cycles within rel {err:.2e} of scan_impl='ref'; "
              + ", ".join(f"{n} {float(c):.0f}" for n, c in zip(names, cyc["auto"])))


def phase_affine_scan(device) -> None:
    """The bare affine scan through the package's public entry point (the
    reference package's ``repro.kernels.sscan.affine_scan``), forward and
    backward, on the LM stack's bandwidth-EMA input at the default design:
    its inclusive prefix, one vertex on, is the fused kernel's bw_prev."""
    import torch

    from repro_torch import kernels
    from repro_torch.core import ArchParams, Graph, TechParams, mapper, specialize
    from repro_torch.workloads import lm_cell

    gs = Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])
    chw = specialize(TechParams.default(device), ArchParams.default(device))
    iv = mapper._vertex_intrinsics(mapper._hw(chw), gs, mapper.MapperCfg())
    x = (mapper._BW_GAIN * iv["bw_x"]).detach().requires_grad_(True)
    ema = kernels.affine_scan(mapper._BW_DECAY, x)
    ema.sum().backward()
    _, bw_prev = mapper._carry_prefixes(chw, mapper.MapperCfg(), iv)
    err = _close(ema[..., :-1].detach(), bw_prev[..., 1:].detach(), 1e-6 * float(bw_prev.abs().max()), 1e-5,
                 "affine_scan against the fused kernel's bw_prev")
    check(bool(torch.isfinite(x.grad).all()), "affine_scan: non-finite gradient")
    print(f"  affine_scan on the LM stack's bandwidth input {tuple(x.shape)}: within {err:.3g} of the fused "
          "kernel's bw_prev (rtol 1e-5, atol 1e-6*max); gradient finite")


def phase_population(device) -> None:
    import torch

    from repro_torch.core import ArchParams, Graph, TechParams, simulate_stacked, specialize
    from repro_torch.kernels import ops
    from repro_torch.workloads import lm_cell

    t0 = time.perf_counter()
    g = lm_cell("qwen2.5-32b", "prefill_32k", device=device)
    gp = ops.pack_graph(g)
    P = 65536
    scales = torch.linspace(0.5, 2.0, P, device=device)
    tech, arch = TechParams.default(device), ArchParams.default(device)
    tech_p = TechParams.default(device)
    tech_p.cell_read_latency = tech_p.cell_read_latency * scales[:, None]
    out = ops.popsim(gp, ops.pack_chw(specialize(tech_p, arch)))
    check(tuple(out.shape) == (P, 8) and bool(torch.isfinite(out).all()), "population output malformed")
    one = ops.popsim(gp, ops.pack_chw(specialize(tech, arch)))
    cyc = float(simulate_stacked(tech, arch, Graph.stack([g])).cycles[0])
    ok, err = rel_close(float(one[0, 0]), cyc, 1e-5)
    check(ok, f"popsim cycles {float(one[0, 0])} vs simulate {cyc} at the default design (rel {err:.3g})")
    print(f"  population P={P} on qwen2.5-32b:prefill_32k: cycles {float(out[:, 0].min()):.4e}.."
          f"{float(out[:, 0].max()):.4e}; default design within rel {err:.2e} of simulate; phase wall "
          f"{(time.perf_counter() - t0) * 1e3:.3f} ms")


def phase_profile(device, more: dict) -> None:
    """Where the time goes: one warm DOpt step on the LM stack, one simulate
    of qwen2.5-32b:prefill_32k and the calls in ``more`` (name -> callable;
    the DSE path leaves one epoch of its 1,024 members there, the session
    path one warm ``Session.simulate``) under
    torch.profiler (each kernel alone is timed in phase kernels).  Prints
    wall time, summed device time, the device's idle share and the kernels
    with most device time.  Runs after the main path's launch counts are
    read, so its launches count nowhere."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import ArchParams, Graph, TechParams, optimize, simulate_stacked
    from repro_torch.workloads import lm_cell

    gs = Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])
    q = Graph.stack([lm_cell("qwen2.5-32b", "prefill_32k", device=device).pad_to(1024)])
    tech, arch = TechParams.default(device), ArchParams.default(device)
    work = {
        "dopt_step_lm_stack": lambda: optimize(gs, objective="edp", lr=0.05, steps=1, device=device),
        "simulate_qwen": lambda: simulate_stacked(tech, arch, q).cycles.sum().item(),
        **more,
    }
    for name, fn in work.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        rows = device_rows(prof)
        busy = sum(r[0] for r in rows)
        n_kern = sum(r[1] for r in rows)
        if busy == 0.0:
            print(f"  profile {name}: wall {wall:.3f} ms; device time not measured (profiler saw none)")
            continue
        top = sorted(rows, reverse=True)[:4]
        print(f"  profile {name}: wall {wall:.3f} ms, device busy {busy:.3f} ms over {n_kern} kernels, "
              f"idle share {max(0.0, 1 - busy / wall):.3f}; top: "
              + "; ".join(f"{k[:48]} {t:.4f} ms x{c}" for t, c, k in top))


# --------------------------------------------------------------------------- #
# the DSE path: .dhd library -> walker accuracy -> population = sequential ->
# the users' Pareto DSE against the reference's fixture -> 1,024 members
# --------------------------------------------------------------------------- #

PARETO_FIXTURE = ROOT / "tests" / "data" / "torch_pareto_ref.npz"
PARETO_RTOL = 1e-3  # the tolerance phase_optimize holds DOpt's history to
# tests/test_refsim_accuracy.py's matrix: workload -> DSim-vs-walker relative tolerance
REFSIM_MATRIX = {"resnet50": 0.05, "lstm": 0.08, "bert_base": 0.03, "dlrm": 0.06, "gcn": 0.08, "graphsage": 0.09,
                 "stencil2d": 0.08, "merge_sort": 0.08, "bfs_graph": 0.06, "granite-3-8b:train_4k": 0.02,
                 "qwen2.5-32b:prefill_32k": 0.02}
REFSIM_ARCHS = ("base", "datacenter", "edge")
SCALE_P, SCALE_EPOCHS, SCALE_LR, SCALE_PENALTY = 1024, 8, 0.1, 2.0


def graph(name: str, device):
    """A workload by its name in REFSIM_MATRIX (``arch:shape`` for an LM cell)."""
    from repro_torch.workloads import get_workload, lm_cell

    return lm_cell(*name.split(":"), device=device) if ":" in name else get_workload(name, device=device)


def trees_equal(a, b) -> bool:
    import torch

    return all(torch.equal(x, y) for x, y in zip(a.leaves(), b.leaves()))


def phase_dse_library(device) -> None:
    """Every library arch on the card; each serializes, re-parses and
    re-serializes byte-identically, and re-parses to the loaded design bit for bit."""
    from repro_torch.core import dhdl

    names = dhdl.library_archs()
    for name in names:
        ca = dhdl.load_arch(name, device)
        text = dhdl.serialize_arch(ca)
        again = dhdl.parse_arch(text, env={}, device=device)
        check(dhdl.serialize_arch(again) == text, f"{name}: serialize -> parse -> serialize is not byte-identical")
        check(again.spec == ca.spec and trees_equal(again.tech, ca.tech) and trees_equal(again.arch, ca.arch),
              f"{name}: the re-parsed design differs from the loaded one")
    print(f"  dhd library: {len(names)} archs ({', '.join(names)}) compiled on the card; each serializes, "
          "re-parses and re-serializes byte-identically, and re-parses to the loaded design bit for bit")


def phase_dse_refsim(device) -> None:
    """DSim on the card against the float64 cycle walker, at
    tests/test_refsim_accuracy.py's per-workload tolerances."""
    from repro_torch.core import dhdl
    from repro_torch.core.refsim import reference_simulate

    graphs = {name: graph(name, device) for name in REFSIM_MATRIX}
    for arch in REFSIM_ARCHS:
        ca = dhdl.load_arch(arch, device)
        chw = ca.specialize()
        errs = []
        for name, tol in REFSIM_MATRIX.items():
            cyc = float(ca.simulate(graphs[name]).cycles)
            want = reference_simulate(chw, graphs[name])["cycles"]
            rel = abs(cyc - want) / max(want, 1.0)
            check(rel <= tol, f"{name} on {arch}: DSim {cyc:.6g} vs walker {want:.6g} (rel {rel:.4f} > {tol})")
            errs.append(f"{name} {rel:.4f}/{tol}")
        print(f"  walker accuracy on {arch}: DSim cycles vs the walker's, rel err/tol: " + ", ".join(errs))


def phase_dse_equivalence(device) -> None:
    """The population chunk is P sequential optimize(fused=True) runs: 4
    jittered members, one-hot edp, 4 epochs (rtol 1e-5, as the reference's
    tests/test_popsim.py holds its own); then one member with a mixed
    objective, a binding area budget and a constant penalty weight."""
    import numpy as np

    from repro_torch.core import ArchParams, Graph, TechParams, optimize, popsim
    from repro_torch.core.dopt import from_log
    from repro_torch.workloads import get_workload

    gl = [get_workload("lstm", device=device), get_workload("merge_sort", device=device)]
    n, steps = 4, 4
    tech, arch = popsim.init_population(7, n, sigma=0.2, device=device)
    onehot = np.zeros((n, 4), np.float32)
    onehot[:, 3] = 1.0  # edp
    state, m = popsim.population_chunk(popsim.init_population_state(tech, arch),
                                       (onehot, np.full(n, np.inf), np.full(n, np.inf)), Graph.stack(gl), 0.05,
                                       np.ones(steps, np.float32))
    pt, pa = from_log(state[0]), from_log(state[1])
    worst = 0.0
    for i in range(n):
        res = optimize(gl, tech=tech.map(lambda x: x[i]), arch=arch.map(lambda x: x[i]), objective="edp",
                       steps=steps, lr=0.05, fused=True, device=device)
        ok, err = rel_close(m[:, i, 0], res.history["objective"], 1e-5)
        check(ok, f"population member {i}: objective history off sequential optimize by rel {err:.3g}")
        worst = max(worst, err)
        for got, want in zip(pt.map(lambda x: x[i]).leaves() + pa.map(lambda x: x[i]).leaves(),
                             res.tech.leaves() + res.arch.leaves()):
            ok, err = rel_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)
            check(ok, f"population member {i}: final parameters off sequential optimize by rel {err:.3g}")
            worst = max(worst, err)
    print(f"  population = sequential: {n} jittered members x {steps} epochs (edp) within rel {worst:.3g} of "
          "optimize(fused=True), history and final parameters (rtol 1e-5)")
    lstm = [gl[0]]
    w = np.asarray([[0.5, 0.3, 0.2, 0.0]], np.float32)
    one = [t.map(lambda x: x[None]) for t in (TechParams.default(device), ArchParams.default(device))]
    _, m = popsim.population_chunk(popsim.init_population_state(*one), (w, [300.0], [np.inf]), Graph.stack(lstm),
                                   0.08, np.full(3, 2.0, np.float32))
    res = optimize(lstm, objective="mixed", objective_weights=w[0], area_budget=300.0, penalty_weight=2.0, steps=3,
                   lr=0.08, fused=True, device=device)
    ok, err = rel_close(m[:, 0, 0], res.history["objective"], 1e-5)
    check(ok, f"mixed population member: history off optimize(objective='mixed') by rel {err:.3g}")
    print(f"  population = sequential, mixed [0.5, 0.3, 0.2, 0], area budget 300, penalty 2.0, 3 epochs: within "
          f"rel {err:.3g} (rtol 1e-5)")


def pareto_kwargs(ref: dict) -> dict:
    """``pareto_dse``'s arguments at the fixture's configuration (bench_pareto.py's
    full run): its seeds, sizes, draws, budgets and hypervolume box."""
    noise = tuple({k.split("/")[2]: v for k, v in ref.items() if k.startswith(f"noise/{t}/")} for t in ("tech", "arch"))
    return dict(
        seeds=tuple(str(s) for s in ref["seeds"]), population=int(ref["population"]), steps=int(ref["steps"]),
        lr=float(ref["lr"]), metrics=tuple(str(m) for m in ref["metrics"]),
        area_budget=float(ref["area_budget"]), power_budget=float(ref["power_budget"]),
        penalty_weight=tuple(float(p) for p in ref["penalty"]), hv_box=(ref["hv_lo"], ref["hv_ref"]),
        noise=noise, mix_draws=ref["mix_draws"], hv_samples=ref["hv_samples"])


def fixture_pareto_dse(ref: dict, device):
    """The port's pareto_dse at the fixture's configuration, with the
    fixture's draws, budgets and hypervolume box."""
    from repro_torch.core import popsim
    from repro_torch.workloads import get_workload

    return popsim.pareto_dse([get_workload(str(n), device=device) for n in ref["workloads"]], device=device,
                             **pareto_kwargs(ref))


def _rel(got, want):
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.where(np.isfinite(got), np.abs(got - want) / np.maximum(np.abs(want), 1e-30), np.inf)


def _front_margin(pts, i: int, dominated: bool) -> float:
    """How far (relative, per coordinate) member ``i`` of ``pts`` [P, M] is
    from the other side of its domination status: when dominated, the least
    move that escapes every member dominating it; when not, the least move
    that lets some member dominate it."""
    import numpy as np

    p = np.asarray(pts, np.float64)
    scale = np.maximum(np.abs(p[i]), 1e-30)
    others = [j for j in range(len(p)) if j != i]
    if dominated:
        doms = [j for j in others if np.all(p[j] <= p[i]) and np.any(p[j] < p[i])]
        return max(float(np.min((p[i] - p[j]) / scale)) for j in doms)
    return min(float(np.max(np.maximum(p[j] - p[i], 0.0) / scale)) for j in others)


def hold_pareto(res, ref: dict) -> dict:
    """Hold a port pareto_dse result against the reference's fixture at
    PARETO_RTOL.  Members whose own spread in the reference (its history or log
    metrics moving under exact reformulations of its arithmetic, stored in the
    fixture) exceeds PARETO_RTOL are not determined by the reference to that
    tolerance: they are held at the first epoch (before any step), finite
    after it, and where they stand on the front.  Returns what was measured."""
    import numpy as np

    from repro_torch.core.dsim import PARETO_METRICS
    from repro_torch.core.pareto import non_dominated_mask

    spread = np.maximum(ref["spread_history"], ref["spread_log_metrics"])
    held = spread <= PARETO_RTOL
    free = np.nonzero(~held)[0].tolist()
    h, lm = _rel(res.history, ref["history"]), _rel(res.log_metrics, ref["log_metrics"])
    out = {"held": int(held.sum()), "free": free, "history": float(h[:, held].max()),
           "log_metrics": float(lm[held].max()), "first_epoch": float(h[0].max())}
    check(out["history"] <= PARETO_RTOL, f"pareto history off the fixture by rel {out['history']:.3g} "
                                         f"(member {int(h.max(axis=(0, 2))[held].argmax())} of the held)")
    check(out["log_metrics"] <= PARETO_RTOL, f"pareto log metrics off the fixture by rel {out['log_metrics']:.3g}")
    check(out["first_epoch"] <= PARETO_RTOL, f"pareto first epoch off the fixture by rel {out['first_epoch']:.3g}")
    check(bool(np.isfinite(res.history).all() and np.isfinite(res.log_metrics).all()), "non-finite pareto result")
    check(np.array_equal(res.feasible[held], ref["feasible"][held]), "feasible members differ from the fixture's")
    for i in free:
        print(f"    member {i}: not determined by the reference at rtol {PARETO_RTOL} (its own spread "
              f"{spread[i]:.3g}); first epoch within {float(h[0, i].max()):.3g}, history within "
              f"{float(h[:, i].max()):.3g}, log metrics within {float(lm[i].max()):.3g} of the fixture")
    # the front the reference gives once the undetermined members stand where the port put them
    midx = [PARETO_METRICS.index(str(m)) for m in ref["metrics"]]
    pts = np.asarray(ref["log_metrics"], np.float32).copy()
    feas = np.asarray(ref["feasible"]).copy()
    pts[free], feas[free] = res.log_metrics[free], res.feasible[free]
    want = np.nonzero(non_dominated_mask(pts[:, midx], feas, device="cpu").numpy())[0]
    port_pts = res.log_metrics[:, midx]
    for i in sorted(set(want.tolist()) ^ set(res.front.tolist())):
        margin = _front_margin(port_pts[res.feasible], int(np.searchsorted(np.nonzero(res.feasible)[0], i)),
                               i not in res.front)
        check(margin <= PARETO_RTOL, f"front member {i} differs from the fixture's by a margin of {margin:.3g}")
        print(f"    front member {i} differs: it lies within {margin:.3g} (rel) of the other side of its "
              f"domination status (held to rtol {PARETO_RTOL})")
    out["front_equal"] = np.array_equal(res.front, ref["front"])
    print(f"    front {res.front.tolist()}" + ("" if out["front_equal"] else f" (fixture {ref['front'].tolist()})"))
    out["hypervolume"] = float(_rel(res.hypervolume, ref["hypervolume"]))
    check(out["hypervolume"] <= PARETO_RTOL, f"hypervolume {res.hypervolume} vs fixture {float(ref['hypervolume'])} "
                                             f"(rel {out['hypervolume']:.3g})")
    return out


def phase_dse_bench(device, keep: dict) -> None:
    """The users' DSE configuration (benchmarks/bench_pareto.py's full run)
    against the reference's fixture; every winner's .dhd re-parses to its
    member bit for bit; member-epochs/s of the descent (one epoch of it left
    in ``keep`` for phase_profile)."""
    import numpy as np
    import torch

    from repro_torch.core import Graph, dhdl, popsim

    ref = dict(np.load(PARETO_FIXTURE))
    t0 = time.perf_counter()
    res = fixture_pareto_dse(ref, device)
    wall = time.perf_counter() - t0
    out = hold_pareto(res, ref)
    for w in res.winners:
        i = w["index"]
        ca = dhdl.parse_arch(w["dhd"], device=device)
        check(ca.spec == res.spec and trees_equal(ca.tech, res.tech.map(lambda x: x[i]))
              and trees_equal(ca.arch, res.arch.map(lambda x: x[i])) and dhdl.serialize_arch(ca) == w["dhd"],
              f"winner {i}: its .dhd does not re-parse to its member bit for bit")
    P, steps = int(ref["population"]), int(ref["steps"])
    print(f"  pareto_dse, bench configuration (P={P}, {steps} steps, {len(ref['workloads'])} workloads, "
          f"{len(ref['seeds'])} seeds): {out['held']} members held within rel {out['history']:.3g} (history) and "
          f"{out['log_metrics']:.3g} (log metrics) of the fixture (rtol {PARETO_RTOL}); first epoch within "
          f"{out['first_epoch']:.3g}; front of {res.front.size}, hypervolume {res.hypervolume:.6g} within rel "
          f"{out['hypervolume']:.3g}; {len(res.winners)} winners re-parse bit for bit; wall {wall:.3f} s")
    # the descent alone, warm: one chunk of every epoch, one host copy
    (tech, arch), spec, _ = popsim.seed_population(P, tuple(str(s) for s in ref["seeds"]), key=0, device=device)
    mixes = (popsim.sample_objective_mixes(P, device=device), np.full(P, float(ref["area_budget"])),
             np.full(P, float(ref["power_budget"])))
    gs = Graph.stack([graph(str(n), device) for n in ref["workloads"]])
    sched = np.geomspace(*(float(p) for p in ref["penalty"]), steps).astype(np.float32)
    state = popsim.init_population_state(tech, arch)
    run = lambda: popsim.population_chunk(state, mixes, gs, float(ref["lr"]), sched, spec=spec)  # noqa: E731
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0
    print(f"  pareto descent, bench configuration: {P * steps / dt:.1f} member-epochs/s ({dt * 1e3:.3f} ms for "
          f"{steps} epochs of {P} members, warm, one host copy)")
    keep["dse_epoch_bench_P32"] = lambda: popsim.population_chunk(state, mixes, gs, float(ref["lr"]), sched[:1],
                                                                  spec=spec)


def scale_population(device) -> dict:
    """1,024 members seeded from the 5 library archs on the LM stack [5, 1024],
    SCALE_EPOCHS epochs at a constant penalty weight; budgets from the seeds as
    bench_pareto.py's ``_seed_budgets`` takes them (the worst seed's area and
    power): the stack, spec, members, mixes, budgets and schedule."""
    import numpy as np

    from repro_torch.core import Graph, popsim
    from repro_torch.workloads import lm_cell

    seeds = ("base", "edge", "mobile", "datacenter", "hbm_class")
    gs = Graph.stack([lm_cell(a, s, device=device).pad_to(1024) for a, s in LM])
    (tech, arch), spec, _ = popsim.seed_population(SCALE_P, seeds, key=0, device=device)
    w = popsim.sample_objective_mixes(SCALE_P, device=device)
    _, area, power = popsim.population_log_metrics(tech.map(lambda x: x[:len(seeds)]),
                                                   arch.map(lambda x: x[:len(seeds)]), gs, spec)
    area_b, power_b = float(area.max()), float(power.max())
    return dict(gs=gs, spec=spec, tech=tech, arch=arch, w=w, area_b=area_b, power_b=power_b,
                mixes=(w, np.full(SCALE_P, area_b), np.full(SCALE_P, power_b)),
                sched=np.full(SCALE_EPOCHS, SCALE_PENALTY, np.float32))


def phase_dse_scale(device, keep: dict) -> None:
    """Phase 5e: :func:`scale_population`'s chunk, its memory and K1's
    launches, member 0 against sequential optimize."""
    import numpy as np
    import torch

    from repro_torch.core import optimize, popsim
    from repro_torch.kernels import runtime

    inp = scale_population(device)
    gs, spec, tech, arch, w, mixes, sched = (inp[k] for k in ("gs", "spec", "tech", "arch", "w", "mixes", "sched"))
    area_b, power_b = inp["area_b"], inp["power_b"]
    P = SCALE_P
    start = popsim.init_population_state(tech, arch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1 = {k: runtime.LAUNCHES[k] for k in ("mapper_carries", "mapper_carries_backward")}
    t0 = time.perf_counter()
    state, m = popsim.population_chunk(start, mixes, gs, SCALE_LR, sched, spec=spec)
    dt = time.perf_counter() - t0  # population_chunk ends in its one host copy
    k1 = {k: runtime.LAUNCHES[k] - n for k, n in k1.items()}
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    again = popsim.population_chunk(start, mixes, gs, SCALE_LR, sched, spec=spec)[1]
    warm = time.perf_counter() - t0
    check(np.array_equal(again, m), f"P={P}: a second run from the same state differs")
    finite = all(bool(torch.isfinite(x).all()) for x in state[0].leaves() + state[1].leaves())
    check(finite, f"P={P}: a member's parameters are not finite (a diverging member freezes at its last finite "
                  "state)")
    rows_bad = int((~np.isfinite(m).all(axis=(0, 2))).sum())
    check(m.shape == (SCALE_EPOCHS, P, 5), f"P={P} history {m.shape}")
    check(k1 == {"mapper_carries": SCALE_EPOCHS, "mapper_carries_backward": SCALE_EPOCHS},
          f"P={P}: K1 launches {k1}, want one each way an epoch")
    res = optimize(gs, tech=tech.map(lambda x: x[0]), arch=arch.map(lambda x: x[0]), spec=spec, objective="mixed",
                   objective_weights=w[0].cpu().numpy(), area_budget=area_b, power_budget=power_b,
                   penalty_weight=SCALE_PENALTY, steps=SCALE_EPOCHS, lr=SCALE_LR, fused=True, device=device)
    ok, err = rel_close(m[:, 0, 0], res.history["objective"], 1e-4)
    check(ok, f"P={P} member 0 off sequential optimize(objective='mixed') by rel {err:.3g}")
    print(f"  pareto descent at scale: P={P} on the LM stack [5,1024], {SCALE_EPOCHS} epochs: "
          f"{P * SCALE_EPOCHS / warm:.1f} member-epochs/s warm ({warm * 1e3:.3f} ms; first call "
          f"{P * SCALE_EPOCHS / dt:.1f}, {dt * 1e3:.3f} ms); peak device memory {peak / 2**30:.3f} GiB; K1 launches "
          f"{k1} ([{P * len(LM)}, 1024] rows each); every member's parameters finite, {rows_bad} members with a "
          f"non-finite history row (frozen); member 0 within rel {err:.3g} of sequential optimize (rtol 1e-4); "
          f"budgets area {area_b:.6g} mm^2, power {power_b:.6g} W")
    keep["dse_epoch_P1024_lm_stack"] = lambda: popsim.population_chunk(state, mixes, gs, SCALE_LR, sched[:1],
                                                                       spec=spec)


# --------------------------------------------------------------------------- #
# the session path: the Session façade over the engines, bit for bit
# --------------------------------------------------------------------------- #

SESSION_BATCH_BUCKET = 8  # the pinned request axis of the LM cells' batched queries
SESSION_QPS_NB = (8, 64)  # simulate_batch throughput at these request axes
SESSION_SMALL = ("lstm", "dlrm", "gcn", "graphsage", "stencil2d", "merge_sort", "bfs_graph", "vgg16")  # (1, 32)


def lm_workloads(device) -> list:
    """The 5 LM cells, each a Workload padded to 1,024 vertices (one bucket)."""
    from repro_torch.api import Workload
    from repro_torch.workloads import lm_cell

    return [Workload(lm_cell(a, s, device=device).pad_to(1024), labels=(f"{a}:{s}",), device=device) for a, s in LM]


def phase_session_simulate(sess, device) -> None:
    """The 16 workloads of results/bench/sim_speed.json through
    ``Session.simulate`` at their buckets: each reply and ``Session.perf``
    equal to simulate_stacked on the same stack bit for bit, cycles within
    rtol 1e-5 of ``cycles_dsim``; the first reply of the new session timed."""
    from repro_torch.api import Workload
    from repro_torch.core import simulate_stacked

    rows = json.loads((ROOT / "results/bench/sim_speed.json").read_text())["rows"]
    a = sess.architecture
    t0 = time.perf_counter()
    sess.simulate("lstm")
    first_ms = (time.perf_counter() - t0) * 1e3
    worst = 0.0
    for r in rows:
        name = r["workload"]
        w = Workload(graph(name, device), labels=(name,), device=device)
        rep = sess.simulate(w).workloads[0]
        eng = simulate_stacked(a.tech, a.arch, w.stacked, a.spec)
        check(trees_equal(sess.perf(w), eng), f"session {name}: Session.perf differs from simulate_stacked")
        got = (rep.cycles, rep.runtime_s, rep.energy_j, rep.edp, rep.power_w)
        want = tuple(float(x[0]) for x in (eng.cycles, eng.runtime, eng.energy, eng.edp, eng.power))
        check(got == want, f"session {name}: the report {got} is not simulate_stacked's {want} bit for bit")
        ok, err = rel_close(rep.cycles, r["cycles_dsim"], 1e-5)
        check(ok, f"session {name}: cycles {rep.cycles} vs cycles_dsim {r['cycles_dsim']} (rel {err:.3g})")
        worst = max(worst, err)
    print(f"  session simulate: {len(rows)} workloads of sim_speed.json at their buckets, each reply and "
          f"Session.perf equal to simulate_stacked bit for bit, cycles within rel {worst:.3g} of cycles_dsim "
          f"(rtol 1e-5); first reply of a new session (lstm, bucket (1, 32); kernels already loaded) "
          f"{first_ms:.3f} ms; {sess.stats}")


def phase_session_explain_optimize(sess, device) -> None:
    """``explain`` and ``optimize`` (20 steps) on the LM stack [5, 1024]: the
    elasticities equal a direct autograd.grad of the log objective, the
    history and the optimized design equal dopt.optimize's, bit for bit."""
    import torch

    from repro_torch.api import Workload, _param_names
    from repro_torch.core import dhdl, optimize, stacked_log_objective
    from repro_torch.core.dopt import from_log, to_log

    w = Workload([g for lw in lm_workloads(device) for g in lw.graphs], labels=tuple(f"{a}:{s}" for a, s in LM),
                 device=device)
    a = sess.architecture
    rep = sess.explain(w)
    tz = to_log(a.tech).map(lambda x: x.detach().requires_grad_(True))
    az = to_log(a.arch).map(lambda x: x.detach().requires_grad_(True))
    val, _ = stacked_log_objective(from_log(tz), from_log(az), w.stacked, "edp", spec=a.spec)
    wrt = tz.leaves() + az.leaves()
    grads = torch.autograd.grad(val, wrt, allow_unused=True)
    flat = torch.cat([(torch.zeros_like(x) if g is None else g).reshape(-1) for x, g in zip(wrt, grads)]).tolist()
    check({at.parameter: at.elasticity for at in rep.attribution} == dict(zip(_param_names(), flat)),
          "session explain: elasticities differ from a direct autograd.grad")
    top = ", ".join(f"{at.parameter} {at.elasticity:+.4f}" for at in rep.bottlenecks(3))
    print(f"  session explain LM stack {w.bucket}: {len(rep.attribution)} elasticities equal to a direct "
          f"autograd.grad bit for bit; top: {top}")

    res = sess.optimize(w, steps=20, lr=0.05)
    eng = optimize(w.stacked, tech=a.tech, arch=a.arch, spec=a.spec, objective="edp", steps=20, lr=0.05,
                   device=device)
    check(list(res.objective_history) == [math.exp(v) for v in eng.history["objective"]],
          "session optimize: history differs from dopt.optimize")
    check(res.dhd == dhdl.serialize_arch(name="base_opt", spec=a.spec, arch=eng.arch, tech=eng.tech),
          "session optimize: the optimized design differs from dopt.optimize's")
    ok, err = rel_close([math.log(v) for v in res.objective_history], REF_HISTORY["objective"], 1e-3)
    check(ok, f"session optimize: history off the reference package's by rel {err:.3g}")
    print(f"  session optimize LM stack, 20 steps: history and design equal to dopt.optimize bit for bit; "
          f"within rel {err:.2e} of the reference's history; {res.improvement:.1f}x better")


def phase_session_frontier(sess, device) -> None:
    """``frontier`` at bench_pareto.py's configuration with the DSE path's
    draws, equal to pareto_dse on the same stack bit for bit."""
    import numpy as np

    from repro_torch.api import Workload
    from repro_torch.core import popsim

    ref = dict(np.load(PARETO_FIXTURE))
    kw = pareto_kwargs(ref)
    w = Workload([str(n) for n in ref["workloads"]], device=device)
    t0 = time.perf_counter()
    fr = sess.frontier(w, **kw)
    wall = time.perf_counter() - t0
    eng = popsim.pareto_dse(w.stacked, device=device, **kw)
    check(np.array_equal(fr.raw.history, eng.history) and np.array_equal(fr.raw.log_metrics, eng.log_metrics),
          "session frontier: history or log metrics differ from pareto_dse")
    check([p.dhd for p in fr.front] == [win["dhd"] for win in eng.winners] and fr.hypervolume == eng.hypervolume,
          "session frontier: front or hypervolume differs from pareto_dse")
    print(f"  session frontier, bench configuration at bucket {w.bucket}: front of {len(fr.front)}, hypervolume "
          f"{fr.hypervolume:.6g} (fixture {float(ref['hypervolume']):.6g} at the natural V), equal to pareto_dse "
          f"bit for bit; wall {wall:.3f} s")


def phase_session_batch(sess, device) -> None:
    """The 5 LM cells as 5 queries of simulate_batch and explain_batch at
    request_bucket=8: each reply equal as to_json text to the same query sent
    alone at that bucket and to it in the batch in reversed order."""
    ws = lm_workloads(device)
    nb = SESSION_BATCH_BUCKET
    for method in ("simulate_batch", "explain_batch"):
        call = getattr(sess, method)
        together = call(ws, request_bucket=nb)
        alone = [call([w], request_bucket=nb)[0] for w in ws]
        reverse = call(ws[::-1], request_bucket=nb)[::-1]
        for w, t, a, r in zip(ws, together, alone, reverse):
            check(t.to_json() == a.to_json() == r.to_json(),
                  f"session {method} {w.labels[0]}: the reply depends on the batch's composition")
    print(f"  session batches: the 5 LM cells through simulate_batch and explain_batch at request_bucket={nb}, "
          "each reply equal as to_json text alone, together and in reversed order")


def phase_session_warm(sess, device, smi: str, keep: dict) -> None:
    """Warm calls build nothing: the same workload, another workload of the
    bucket and another design point, for simulate, explain and the batched
    programs (preheated).  Then the façade's warm times (printed, not gated)."""
    from repro_torch.api import Workload
    from repro_torch.core import instrument

    lm = Workload([g for lw in lm_workloads(device) for g in lw.graphs], device=device)
    qs = {nb: [SESSION_SMALL[i % len(SESSION_SMALL)] for i in range(nb)] for nb in SESSION_QPS_NB}
    archs = {nb: [("base", "edge", "datacenter", "mobile")[i % 4] for i in range(nb)] for nb in SESSION_QPS_NB}
    t0 = time.perf_counter()
    pre = sess.preheat("lstm", request_buckets=SESSION_QPS_NB)
    pre_s = time.perf_counter() - t0
    for nb in SESSION_QPS_NB:  # the designs' first parse is host work, not a build
        sess.simulate_batch(qs[nb], architectures=archs[nb], request_bucket=nb)
    before = instrument.snapshot()
    calls = {
        "simulate lstm": lambda: sess.simulate("lstm"),
        "simulate merge_sort": lambda: sess.simulate("merge_sort"),
        "simulate lstm on edge": lambda: sess.simulate("lstm", architecture="edge"),
        "explain lstm": lambda: sess.explain("lstm"),
        "explain dlrm on datacenter": lambda: sess.explain("dlrm", architecture="datacenter"),
        "simulate LM stack": lambda: sess.simulate(lm),
        "explain LM stack": lambda: sess.explain(lm),
    }
    for fn in calls.values():
        fn()
    ms = {k: median_ms(calls[k], device, n=10) for k in ("simulate lstm", "explain lstm", "simulate LM stack",
                                                       "explain LM stack")}
    qps = {nb: nb / median_ms(lambda nb=nb: sess.simulate_batch(qs[nb], architectures=archs[nb], request_bucket=nb),
                              device, n=10) * 1e3
           for nb in SESSION_QPS_NB}
    after = instrument.snapshot()
    check(after == before, f"session: warm calls built {dict(set(after.items()) - set(before.items()))}")
    print(f"  session warm: preheat {pre} in {pre_s:.3f} s; then {len(calls)} kinds of warm call (same workload, "
          f"another of its bucket, another design point) and the timing loops built nothing "
          f"(instrument.trace_count() {sum(after.values())} before and after)")
    print(f"  session times on {smi}: warm median "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
          + "; simulate_batch " + ", ".join(f"nb={nb} {q:.1f} queries/s" for nb, q in qps.items()))
    keep["session_simulate_lstm"] = calls["simulate lstm"]


def phase_session(device, smi: str, keep: dict) -> None:
    from repro_torch.api import Session

    t0 = time.perf_counter()
    sess = Session("base", device=device)
    phase_session_simulate(sess, device)
    phase_session_explain_optimize(sess, device)
    phase_session_frontier(sess, device)
    phase_session_batch(sess, device)
    phase_session_warm(sess, device, smi, keep)
    print(f"  session path wall {time.perf_counter() - t0:.1f} s; {sess.stats}")


# --------------------------------------------------------------------------- #
# the design path: the single-process design-serving tier at the reference
# bench's traffic (benchmarks/bench_serving.py)
# --------------------------------------------------------------------------- #

DESIGN_SEED = 20260808  # bench_serving.py's _SEED
DESIGN_BUCKET = 16  # its _REQUEST_BUCKET: sequential and batched dispatches share it
DESIGN_QUERIES = 1200  # its design_bench stream, full run
DESIGN_LM_QUERIES = 80  # the LM cells at full width, each alone at (1, 1024)
DESIGN_ARCHS = (None, "edge", "datacenter", "mobile")  # None: the service's base
CHAOS_QUERIES = 96  # its chaos_bench stream, full run, an optimize every 24
CHAOS_FIXTURE = ROOT / "tests" / "data" / "torch_chaos_schedule.json"
CHAOS_TRANSIENT = dict(seed=DESIGN_SEED, p_transient=0.35, p_compile_fail=0.2, p_cache_corrupt=0.2)
CHAOS_FULL = dict(seed=DESIGN_SEED, p_transient=0.3, p_compile_fail=0.1, p_nan=0.25, p_latency=0.2, latency_s=0.02)
RESTART_QUERIES = 8


def design_queries(n: int) -> list:
    """bench_serving.py's ``_design_queries``: simulate and explain alternating
    over lstm, merge_sort, gcn and stencil2d (all at bucket (1, 32)) across
    base, edge, datacenter and mobile."""
    from repro_torch.serving import DesignQuery

    loads = ("lstm", "merge_sort", "gcn", "stencil2d")
    return [DesignQuery(i, ("simulate", "explain")[i % 2], loads[(i // 2) % 4], architecture=DESIGN_ARCHS[(i // 8) % 4])
            for i in range(n)]


def lm_design_queries(device, first: int) -> list:
    """The 5 LM cells, each alone at (1, 1024), simulate and explain
    alternating across the same 4 designs: DESIGN_LM_QUERIES queries."""
    from repro_torch.serving import DesignQuery

    ws = lm_workloads(device)
    return [DesignQuery(first + i, ("simulate", "explain")[i % 2], ws[(i // 2) % len(ws)],
                        architecture=DESIGN_ARCHS[(i // 10) % 4]) for i in range(DESIGN_LM_QUERIES)]


def chaos_queries(n: int, optimize_every: int) -> list:
    """bench_serving.py's ``_queries`` (lstm and merge_sort at (1, 32)), the
    optimize queries at 6 steps without reports."""
    from repro_torch.serving import DesignQuery

    loads = ("lstm", "merge_sort")
    return [DesignQuery(i, "optimize", loads[i % 2], params=dict(steps=6, report=False))
            if optimize_every and i and i % optimize_every == 0
            else DesignQuery(i, ("simulate", "explain")[i % 2], loads[(i // 2) % 2]) for i in range(n)]


def reply_ms(replies) -> tuple[float, float]:
    import numpy as np

    walls = np.asarray([r.wall_s for r in replies if r.ok], np.float64) * 1e3
    return float(np.percentile(walls, 50)), float(np.percentile(walls, 99))


def check_answered(replies, queries, what: str) -> None:
    """Isolation and availability: one reply a query, in order, each ok (an
    answer after its deadline is not ok)."""
    check([r.qid for r in replies] == [q.qid for q in queries], f"{what}: replies out of order or missing")
    bad = [(r.qid, r.error.to_json()) for r in replies if not r.ok]
    check(not bad, f"{what}: {len(bad)} queries not answered ok, first {bad[:3]}")


def phase_design_service(device, smi: str) -> dict:
    """bench_serving.py's design stream (1,200 queries at (1, 32)) and 80 LM
    cell queries at (1, 1024), through DesignService one query at a time and
    through BatchingDesignService by enqueue and flush, both pinned to the
    request bucket 16: every query ok, batched replies equal to sequential
    ones as to_json text, sampled sequential replies equal to
    Session.simulate_batch alone; qps, p50/p99 reply ms, batches printed.
    Returns the streams, the sequential replies as to_json text and the
    batched queries/s, the pool path's yardsticks."""
    from repro_torch.api import Session
    from repro_torch.serving import BatchingDesignService, DesignService, FlushPolicy, RetryPolicy

    streams = {"bench (1, 32)": design_queries(DESIGN_QUERIES),
               "LM cells (1, 1024)": lm_design_queries(device, DESIGN_QUERIES)}
    keep = {"streams": streams, "sequential": {}, "batched_qps": {}}
    seq = DesignService("base", request_bucket=DESIGN_BUCKET, retry=RetryPolicy(max_attempts=4, base_s=0.005),
                        device=device)
    bat = BatchingDesignService("base", policy=FlushPolicy(max_batch=DESIGN_BUCKET, max_delay_s=0.005),
                                retry=RetryPolicy(max_attempts=4, base_s=0.005), device=device)
    for name, queries in streams.items():
        t0 = time.perf_counter()
        seq_replies = seq.serve(queries)
        seq_wall = time.perf_counter() - t0
        b0 = bat.stats
        t0 = time.perf_counter()
        bat_replies = []
        for q in queries:
            bat_replies.extend(bat.enqueue(q))
        bat_replies.extend(bat.flush())
        bat_wall = time.perf_counter() - t0
        b1 = bat.stats
        check_answered(seq_replies, queries, f"design sequential {name}")
        check_answered(bat_replies, queries, f"design batched {name}")
        differ = [r.qid for r, b in zip(seq_replies, bat_replies) if r.result.to_json() != b.result.to_json()]
        check(not differ, f"design {name}: {len(differ)} batched replies differ from sequential, first {differ[:8]}")
        batches = b1.batches - b0.batches
        mean = (b1.batched_queries - b0.batched_queries) / max(batches, 1)
        (s50, s99), (b50, b99) = reply_ms(seq_replies), reply_ms(bat_replies)
        n = len(queries)
        keep["sequential"][name] = [r.result.to_json() for r in seq_replies]
        keep["batched_qps"][name] = n / bat_wall
        print(f"  design {name}: {n} queries, all ok, batched replies equal to sequential as to_json text; "
              f"sequential {n / seq_wall:.1f} queries/s (p50 {s50:.3f} ms, p99 {s99:.3f} ms), batched "
              f"{n / bat_wall:.1f} queries/s (p50 {b50:.3f} ms, p99 {b99:.3f} ms, queue wait included), ratio "
              f"{seq_wall / bat_wall:.2f}; {batches} batches, mean batch {mean:.2f}; on {smi}")
    sess = Session("base", device=device)
    bench, lm = streams["bench (1, 32)"], streams["LM cells (1, 1024)"]
    for q in (bench[0], bench[17], bench[len(bench) - 8], lm[0], lm[len(lm) - 1]):
        call = getattr(sess, f"{q.kind}_batch")
        alone = call([q.workload], architectures=[q.architecture], request_bucket=DESIGN_BUCKET)[0]
        got = seq.replies[[r.qid for r in seq.replies].index(q.qid)].result
        check(got.to_json() == alone.to_json(), f"design q{q.qid}: the reply differs from {q.kind}_batch alone")
    print(f"  design: sampled replies equal to Session.simulate_batch / explain_batch alone at "
          f"request_bucket={DESIGN_BUCKET}; "
          f"sequential {seq.stats.programs} programs, {seq.stats.traces} builds, stragglers "
          f"{len(seq.stats.stragglers)}; batched {len(bat.stats.stragglers)}")
    return keep


def phase_design_chaos(device) -> None:
    """bench_serving.py's four chaos gates on the batched service, the
    schedules held against the reference's (tests/data/torch_chaos_schedule.json)."""
    from repro_torch.serving import BatchingDesignService, ChaosConfig, ChaosInjector, FlushPolicy, RetryPolicy

    ref = json.loads(CHAOS_FIXTURE.read_text())
    for name, plans in ref["schedules"].items():
        mine = [p.to_json() for p in ChaosInjector(ChaosConfig(**ref["configs"][name])).schedule(range(CHAOS_QUERIES))]
        check(mine == plans[:CHAOS_QUERIES], f"design chaos: the {name} schedule differs from the reference's")
    check(ref["configs"]["transient_only"] == CHAOS_TRANSIENT and ref["configs"]["full"] == CHAOS_FULL,
          "design chaos: the fixture's configurations are not the bench's")
    queries = chaos_queries(CHAOS_QUERIES, optimize_every=24)

    def serve(cfg=None):
        inj = None if cfg is None else ChaosInjector(ChaosConfig(**cfg))
        svc = BatchingDesignService("base", policy=FlushPolicy(max_batch=DESIGN_BUCKET, max_delay_s=0.005),
                                    chaos=inj, retry=RetryPolicy(max_attempts=4, base_s=0.005), device=device)
        t0 = time.perf_counter()
        replies = svc.serve(queries)
        return svc, replies, inj, time.perf_counter() - t0

    def texts(replies):
        return {r.qid: r.result.to_json() for r in replies if r.ok}

    svc0, replies0, _, wall0 = serve()  # 1. isolation, and the bit-identity oracle
    check_answered(replies0, queries, "design chaos, clean")
    svc_t, replies_t, inj_t, wall_t = serve(CHAOS_TRANSIENT)  # 2. transient-only: availability exactly 1.0
    check(len(replies_t) == len(queries) and svc_t.stats.availability == 1.0,
          f"design chaos: transient-only availability {svc_t.stats.availability} != 1.0")
    svc_f, replies_f, inj_f, wall_f = serve(CHAOS_FULL)  # 3. full: clean queries bit-identical
    clean = [p.qid for p in inj_f.schedule(range(CHAOS_QUERIES)) if p.clean]
    base, full = texts(replies0), texts(replies_f)
    differ = [q for q in clean if q in full and full[q] != base[q]]
    check(len(replies_f) == len(queries) and not differ,
          f"design chaos: {len(differ)} clean replies differ from the no-chaos run, first {differ[:8]}")
    check(svc_f.stats.availability >= 0.99, f"design chaos: full availability {svc_f.stats.availability} < 0.99")
    svc_r, replies_r, inj_r, _ = serve(CHAOS_FULL)  # 4. replay
    outcome = lambda rs: [(r.qid, r.ok, r.error.code if r.error else None) for r in rs]  # noqa: E731
    check([p.to_json() for p in inj_r.schedule(range(CHAOS_QUERIES))]
          == [p.to_json() for p in inj_f.schedule(range(CHAOS_QUERIES))]
          and outcome(replies_r) == outcome(replies_f) and texts(replies_r) == full,
          "design chaos: the seeded replay diverged (schedule, outcomes or results)")
    for what, svc, replies, inj, wall in (("clean", svc0, replies0, None, wall0),
                                          ("transient-only", svc_t, replies_t, inj_t, wall_t),
                                          ("full", svc_f, replies_f, inj_f, wall_f)):
        st = svc.stats
        p50, p99 = reply_ms(replies)
        print(f"  design chaos {what}: availability {st.availability}, retries {st.retries}, errors {st.errors}, "
              f"deadline misses {st.deadline_misses}, batches {st.batches}, p50 {p50:.3f} ms, p99 {p99:.3f} ms, "
              f"wall {wall:.3f} s" + (f", injected {inj.summary()}" if inj else ""))
    print(f"  design chaos: schedules equal to the reference's fixture; {len(clean)} clean queries of "
          f"{CHAOS_QUERIES} bit-identical to the no-chaos run; the replay identical")


RESTART_CHILD = r"""
import json, sys, time
from repro_torch.api import Workload
from repro_torch.core import instrument
from repro_torch.serving import DesignQuery, DesignService
from repro_torch.workloads import lm_cell

t0 = time.perf_counter()
svc = DesignService("base", cache_dir=sys.argv[1], request_bucket=int(sys.argv[3]), device=sys.argv[6])
construct_s = time.perf_counter() - t0
dev = svc.session.device
a, s = sys.argv[4].split(":")
lm = Workload(lm_cell(a, s, device=dev).pad_to(1024), labels=(sys.argv[4],), device=dev)
info = svc.warmup(["lstm", lm], kinds=("simulate", "explain")) if sys.argv[2] == "warmup" else None
before = instrument.snapshot()
qs = [DesignQuery(i, ("simulate", "explain")[i % 2], ("lstm", lm)[(i // 2) % 2]) for i in range(int(sys.argv[5]))]
t1 = time.perf_counter()
replies = svc.serve(qs)
serve_s = time.perf_counter() - t1
sim, expl = svc.session.simulate("lstm").to_json(), svc.session.explain("lstm").to_json()
after = instrument.snapshot()
print(json.dumps(dict(
    info=info, disk_loaded=svc.session.disk_loaded, misses=svc.stats.misses, construct_s=construct_s,
    serve_s=serve_s, built={k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)},
    replies=[r.result.to_json() if r.ok else None for r in replies], deadline0=replies[0].deadline_s,
    warm_s=svc.deadlines.warm_s, sim=sim, expl=expl,
    foreign=sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")))))
"""


def phase_design_restart(device) -> None:
    """Two fresh processes over one temporary cache_dir: the first warms up
    lstm and an LM cell and serves 8 queries, the second serves the same 8
    after construction alone: zero builds after construction, no misses,
    disk_loaded equal to the first's persisted, replies equal as to_json
    text, its first query predicted warm."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src") + os.pathsep + os.environ.get("PYTHONPATH", ""))
    lm = "%s:%s" % LM[0]
    with tempfile.TemporaryDirectory(prefix="dragon-design-cache-") as d:
        runs = []
        for mode in ("warmup", "restart"):
            t0 = time.perf_counter()
            out = subprocess.run([sys.executable, "-c", RESTART_CHILD, d, mode, str(DESIGN_BUCKET), lm,
                                  str(RESTART_QUERIES), str(device)], capture_output=True, text=True, env=env,
                                 timeout=300)
            check(out.returncode == 0, f"design restart ({mode}) failed:\n{out.stderr[-4000:]}")
            runs.append(dict(json.loads(out.stdout.strip().splitlines()[-1]), wall_s=time.perf_counter() - t0))
        records = len([n for n in os.listdir(d) if n.endswith(".pkey")])
    pre, post = runs
    check(pre["foreign"] == post["foreign"] == [], f"design restart: imported {pre['foreign'] + post['foreign']}")
    check(all(pre["replies"]) and all(post["replies"]), "design restart: a query was not answered ok")
    check(post["built"] == {} and post["misses"] == 0,
          f"design restart: built {post['built']} and missed {post['misses']} after construction")
    check(post["disk_loaded"] == pre["info"]["persisted"] == records > 0,
          f"design restart: disk_loaded {post['disk_loaded']}, persisted {pre['info']['persisted']}, "
          f"records {records}")
    check(post["replies"] == pre["replies"] and (post["sim"], post["expl"]) == (pre["sim"], pre["expl"]),
          "design restart: the restarted replies differ from the first process's")
    check(post["deadline0"] == post["warm_s"], f"design restart: first query's deadline {post['deadline0']} s "
                                               f"is not the warm budget {post['warm_s']} s")
    print(f"  design restart: warmup {pre['info']}; restarted process rehydrated {post['disk_loaded']} programs "
          f"in construction ({post['construct_s']:.3f} s, first process {pre['construct_s']:.3f} s), then served "
          f"{RESTART_QUERIES} queries ({post['serve_s']:.3f} s; first process {pre['serve_s']:.3f} s) and "
          "Session.simulate/explain with 0 builds and 0 misses, replies equal as to_json text, first query "
          f"warm; process walls {pre['wall_s']:.1f} s and {post['wall_s']:.1f} s")


def phase_design(device, smi: str) -> dict:
    t0 = time.perf_counter()
    keep = phase_design_service(device, smi)
    phase_design_chaos(device)
    phase_design_restart(device)
    print(f"  design path wall {time.perf_counter() - t0:.1f} s")
    return keep


# --------------------------------------------------------------------------- #
# the pool path: the design-serving tier past one thread and one process
# --------------------------------------------------------------------------- #

POOL_WORKERS = 2  # bench_serving.py's _pool_bench: two pool threads, two worker processes
POOL_FLOOR = 1.5  # its floor for the pooled and multi-process tiers against the batched service
POOL_KILL = dict(seed=DESIGN_SEED, p_worker_kill=0.1)  # its worker-kill chaos
POOL_WARM = ("lstm", "merge_sort", "gcn", "stencil2d")  # its parent's warmup, and the LM cells


def pool_kw() -> dict:
    """The batched service's settings (phase_design_service)."""
    from repro_torch.serving import FlushPolicy, RetryPolicy

    return dict(policy=FlushPolicy(max_batch=DESIGN_BUCKET, max_delay_s=0.005),
                retry=RetryPolicy(max_attempts=4, base_s=0.005))


def check_sequential(replies, queries, want: list, what: str) -> None:
    check_answered(replies, queries, what)
    differ = [r.qid for r, w in zip(replies, want) if r.result.to_json() != w]
    check(not differ, f"{what}: {len(differ)} replies differ from sequential, first {differ[:8]}")


def tier_line(what: str, replies, wall: float, batched_qps: float, smi: str) -> float:
    n = len(replies)
    p50, p99 = reply_ms(replies)
    ratio = n / wall / batched_qps
    print(f"  pool {what}: {n} queries, all ok, replies equal to sequential as to_json text; {n / wall:.1f} "
          f"queries/s (p50 {p50:.3f} ms, p99 {p99:.3f} ms, queue wait included), {ratio:.2f}x the batched "
          f"service ({batched_qps:.1f} queries/s; bench_serving.py's floor {POOL_FLOOR}x: "
          f"{'reached' if ratio > POOL_FLOOR else 'not reached'}, a finding, not a gate); on {smi}")
    return ratio


def staged_leaves(svc, queries) -> tuple[float, float]:
    """One chunk of DESIGN_BUCKET queries: every staged leaf equal to
    Session._assemble_batch's in values, dtype, shape and strides; returns
    the median host ms of each (to the end of the copies, synchronized)."""
    import torch

    sess = svc.session
    ws = [sess._workload(q.workload) for q in queries[:DESIGN_BUCKET]]
    archs = [sess._arch(q.architecture) for q in queries[:DESIGN_BUCKET]]
    _, _, _, (techs, arch_ps, g) = sess._assemble_batch(ws, archs, DESIGN_BUCKET)
    st, sa, sg = svc._assembler.stage(ws, archs)
    fields = ("n_comp", "n_read", "n_write", "n_alloc", "dims", "op_kind", "edges")
    want = techs.leaves() + arch_ps.leaves() + [getattr(g, f) for f in fields]
    got = st.leaves() + sa.leaves() + [getattr(sg, f) for f in fields]
    check(len(want) == len(got) and sg.names == g.names, "pool staged: the staged trees differ in structure")
    for i, (x, y) in enumerate(zip(want, got)):
        check((x.dtype, x.shape, x.stride(), x.device) == (y.dtype, y.shape, y.stride(), y.device)
              and y.is_contiguous() and torch.equal(x, y), f"pool staged: leaf {i} differs from _assemble_batch's")

    def host_ms(fn) -> float:
        times = []
        for _ in range(30):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return (host_ms(lambda: svc._assembler.stage(ws, archs)),
            host_ms(lambda: sess._assemble_batch(ws, archs, DESIGN_BUCKET)))


def frame_costs(streams: dict, replies: dict) -> None:
    """What one chunk costs on the wire: a frame of DESIGN_BUCKET queries of
    one kind, and the reply frame of their answers, each encoded and decoded
    in this process (host ms, median of 5) with its size."""
    import pickle

    from repro_torch.serving import protocol

    for name, queries in streams.items():
        for kind in ("simulate", "explain"):
            qs = [q for q in queries if q.kind == kind][:DESIGN_BUCKET]
            rs = [r for r in replies[name] if r.kind == kind][:DESIGN_BUCKET]
            parts = []
            for what, tag, payload in (("queries", "chunk", (0, qs)), ("replies", "replies", (0, rs, None))):
                enc, dec = [], []
                for _ in range(5):
                    t0 = time.perf_counter()
                    frame = protocol.encode_frame(tag, payload)
                    t1 = time.perf_counter()
                    pickle.loads(frame[8:])
                    dec.append(time.perf_counter() - t1)
                    enc.append(t1 - t0)
                parts.append(f"{what} {len(frame) / 1e3:.1f} kB, encode {statistics.median(enc) * 1e3:.3f} ms, "
                             f"decode {statistics.median(dec) * 1e3:.3f} ms")
            print(f"  pool frames {name} {kind}, a chunk of {len(qs)}: " + "; ".join(parts))


def phase_pool(device, smi: str, keep: dict) -> None:
    import tempfile

    from repro_torch.kernels import runtime
    from repro_torch.serving import (BatchingDesignService, ChaosConfig, MultiProcessDesignService,
                                     PooledDesignService, StagedBatchingService)

    t_path = time.perf_counter()
    streams, want = keep["streams"], keep["sequential"]
    ratios: dict = {}
    batched: dict = {}  # queries/s of the batched service timed in turns with the staged one, in this path
    last_replies: dict = {}  # the staged replies by stream
    # a. staged assembly, then the staged service against the batched one by
    # enqueue and flush, in turns (batched, staged, staged, batched)
    svc = StagedBatchingService("base", device=device, **pool_kw())
    bat = BatchingDesignService("base", device=device, **pool_kw())
    for name, queries in streams.items():
        stage_ms, stack_ms = staged_leaves(svc, queries)
        print(f"  pool staged {name}: a chunk of {DESIGN_BUCKET}, every staged leaf equal to _assemble_batch's "
              f"(values, dtype, shape, strides); host {stage_ms:.3f} ms staged against {stack_ms:.3f} ms stacked")
    for name, queries in streams.items():
        walls: dict = {"batched": [], "staged": []}
        last: dict = {}
        for tier, service in (("batched", bat), ("staged", svc), ("staged", svc), ("batched", bat)):
            t0 = time.perf_counter()
            replies = []
            for q in queries:
                replies.extend(service.enqueue(q))
            replies.extend(service.flush())
            walls[tier].append(time.perf_counter() - t0)
            check_sequential(replies, queries, want[name], f"pool {tier} {name}")
            last[tier] = replies
        batched[name] = len(queries) / statistics.mean(walls["batched"])
        print(f"  pool batched {name}, in turns with staged: {len(queries) / walls['batched'][0]:.1f} and "
              f"{len(queries) / walls['batched'][1]:.1f} queries/s (the design path's run: "
              f"{keep['batched_qps'][name]:.1f}); staged {len(queries) / walls['staged'][0]:.1f} and "
              f"{len(queries) / walls['staged'][1]:.1f}")
        ratios[("staged", name)] = tier_line(f"staged {name}", last["staged"], statistics.mean(walls["staged"]),
                                             batched[name], smi)
        last_replies[name] = last["staged"]
    # b. two pool threads over one session, launching on the current stream
    with PooledDesignService("base", workers=POOL_WORKERS, device=device, **pool_kw()) as pool:
        for name, queries in streams.items():
            k0 = runtime.LAUNCHES["mapper_carries"]
            t0 = time.perf_counter()
            replies = pool.serve(queries)
            wall = time.perf_counter() - t0
            check_sequential(replies, queries, want[name], f"pool pooled {name}")
            check(runtime.LAUNCHES["mapper_carries"] > k0, f"pool pooled {name}: K1 was not launched")
            ratios[("pooled", name)] = tier_line(f"pooled {name}", replies, wall, batched[name], smi)
    # c. two worker processes over a cache_dir a parent preheated; d. a seeded worker kill
    with tempfile.TemporaryDirectory(prefix="dragon-pool-cache-") as d:
        parent = BatchingDesignService("base", cache_dir=d, device=device, **pool_kw())
        info = parent.warmup([*POOL_WARM, *lm_workloads(device)])
        check(info["persisted"] == 8, f"pool: the parent persisted {info} (want 8 programs)")
        mp = MultiProcessDesignService("base", workers=POOL_WORKERS, cache_dir=d, device=device, **pool_kw())
        t0 = time.perf_counter()
        mp.start()
        ready_s = time.perf_counter() - t0
        with mp:
            check(mp.pool_info["kernels_built"] == 0, f"pool multi-process: workers compiled kernels {mp.pool_info}")
            print(f"  pool multi-process: parent warmup {info}; {POOL_WORKERS} workers ready {ready_s:.3f} s after "
                  f"start(), {mp.pool_info['disk_loaded']} programs rehydrated, no kernel compiled (the parent's "
                  "binaries loaded)")
            for name, queries in streams.items():
                t0 = time.perf_counter()
                replies = mp.serve(queries)
                wall = time.perf_counter() - t0
                check_sequential(replies, queries, want[name], f"pool multi-process {name}")
                check(not any(r.compiled for r in replies), f"pool multi-process {name}: a query built")
                ratios[("multi-process", name)] = tier_line(f"multi-process {name}", replies, wall, batched[name],
                                                            smi)
            st = mp.stats
        check(st.traces == 0 and st.misses == 0, f"pool multi-process: the fleet built {st.traces} programs, "
                                                 f"missed {st.misses}")
        frame_costs(streams, last_replies)
        print(f"  pool multi-process: fleet ledger {st.queries} queries, {st.ok} ok, {st.traces} builds, "
              f"{st.hits} hits, {st.misses} misses, {st.batches} batches; {mp.pool_info}")
        with MultiProcessDesignService("base", workers=POOL_WORKERS, cache_dir=d, device=device,
                                       chaos=ChaosConfig(**POOL_KILL), **pool_kw()) as mpk:
            for name, queries in streams.items():
                t0 = time.perf_counter()
                replies = mpk.serve(queries)
                wall = time.perf_counter() - t0
                check_sequential(replies, queries, want[name], f"pool worker-kill {name}")
                p50, p99 = reply_ms(replies)
                print(f"  pool worker-kill {name}: {len(queries)} queries, all ok, replies equal to sequential; "
                      f"{len(queries) / wall:.1f} queries/s (p50 {p50:.3f} ms, p99 {p99:.3f} ms)")
            kinfo = mpk.pool_info
        check(kinfo["kills"] >= 1 and kinfo["requeues"] >= 1,
              f"pool worker-kill: kills {kinfo['kills']}, requeues {kinfo['requeues']} (want >= 1 each)")
        print(f"  pool worker-kill: {kinfo}, availability 1.0")
    held = [f"{tier} {name} {r:.2f}x" for (tier, name), r in ratios.items()]
    print(f"  pool: against the batched service: {', '.join(held)}; the {POOL_FLOOR}x floor "
          f"reached by {sum(r > POOL_FLOOR for r in ratios.values())} of {len(ratios)}")
    print(f"  pool path wall {time.perf_counter() - t_path:.1f} s")


# the mesh path: the port's DeviceMesh layer on a one-rank (1, 1) mesh, each run
# held bit for bit against the same run without a mesh
MESH_TRAIN = (("granite-3-8b", 2), ("falcon-mamba-7b", 16))  # model, depth (granite: 2 of 40, falcon: 16 of 64)
MESH_SERVE = (("granite-3-8b", 2), ("zamba2-1.2b", None))  # None: full depth
MESH_TOKENS = 4096  # 1 x 4,096 tokens a train step and a prompt
MESH_DECODE_STEPS = 4
MESH_KERNELS = ("flash_attention_sm90", "ssd_chunk_scan", "selective_scan", "mapper_carries",
                "mapper_carries_backward")
# the pipeline: granite-3-8b's dense block at full width, 2 stacked layers, 4 microbatches of 1 x 4,096 tokens
PIPE_LAYERS, PIPE_MICROBATCHES = 2, 4
# the dry runs, on the host, as a user runs them: full size on the 16x16 mesh (a fake group of 256 ranks), and
# the population-DSE step on both production meshes
DRYRUN_CELLS = (("granite-3-8b", "train_4k"), ("llama4-scout-17b-a16e", "train_4k"))
DRYRUN_POPSIM = ("16x16", "2x16x16")
DRYRUN_TIMEOUT = 900


def start_dryruns() -> dict:
    """``python -m repro_torch.launch.dryrun`` for each of DRYRUN_CELLS, on the
    host (no CUDA device), all started together; collected by
    :func:`collect_dryruns`."""
    import tempfile

    out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    procs = {}
    runs = {(arch, shape): ["--arch", arch, "--shape", shape] for arch, shape in DRYRUN_CELLS}
    runs[("popsim", "both")] = ["--popsim", "--multipod", "both"]
    for (arch, shape), args in runs.items():
        log = open(os.path.join(out, f"{arch}__{shape}.log"), "w")
        procs[(arch, shape)] = (subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", *args, "--out", out],
            stdout=log, stderr=subprocess.STDOUT, cwd=str(ROOT), env=env), log)
    return {"out": out, "procs": procs, "t0": time.perf_counter()}


def collect_dryruns(runs: dict) -> dict:
    """Wait for the dry runs; each must exit 0 with an ``ok`` record.  Prints
    their roofline terms (counts over the H100 constants, not measurements)."""
    import shutil

    recs = {}
    try:
        for (arch, shape), (proc, log) in runs["procs"].items():
            left = max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - runs["t0"]))
            try:
                rc = proc.wait(timeout=left)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                rc = "timeout"
            log.close()
            text = pathlib.Path(log.name).read_text()
            check(rc == 0, f"dryrun {arch} x {shape}: exit {rc}\n{text[-3000:]}")
            if arch == "popsim":
                for mesh in DRYRUN_POPSIM:
                    rec = json.loads(pathlib.Path(runs["out"], f"popsim__{mesh}.json").read_text())
                    check(rec.get("ok") is True and rec["chips"] == (512 if mesh == "2x16x16" else 256),
                          f"dryrun --popsim [{mesh}]: {rec}")
                    c = rec["collectives"]
                    print(f"  dryrun --popsim [{mesh}, {rec['chips']} chips]: {rec['arch']} {rec['shape']}: per rank "
                          f"{rec['flops_per_device']:.6g} FLOPs, {rec['bytes_per_device']:.6g} bytes, collectives "
                          f"{c['total_bytes']} link bytes ({c['counts']}); run {rec['compile_s']} s")
                    recs[("popsim", mesh)] = rec
                continue
            rec = json.loads(pathlib.Path(runs["out"], f"{arch}__{shape}__16x16.json").read_text())
            check(rec.get("ok") is True, f"dryrun {arch} x {shape}: {rec.get('error')}")
            r = rec["roofline"]
            print(f"  dryrun {arch} x {shape} [16x16, {rec['parallelism']}]: per rank {rec['flops_per_device']:.4g} "
                  f"FLOPs, {rec['bytes_per_device']:.4g} bytes, collectives {rec['collectives']['total_bytes']:.4g} "
                  f"link bytes, hbm {rec['hbm_per_device_gb']} GB; roofline t_compute {r['t_compute']:.6g} s, "
                  f"t_memory {r['t_memory']:.6g} s, t_collective {r['t_collective']:.6g} s -> {r['bottleneck']} "
                  f"(counts over the H100 constants; run {rec['compile_s']} s)")
            recs[(arch, shape)] = rec
    finally:
        for proc, log in runs["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(runs["out"], ignore_errors=True)
    return recs


def _full(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _mesh_train(device, mesh, name: str, layers: int) -> dict:
    """One ``make_train_step`` step of ``name`` at full width and ``layers``
    layers on 1 x MESH_TOKENS tokens, without and with ``mesh``, from the same
    seeded weights and batch: the loss, the grad norm and every updated
    parameter equal bit for bit, and the scan or attention launches equal."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import make_batch
    from repro_torch.kernels import runtime
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import distribute_train_state

    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    model = build_model(cfg)
    opt, tcfg = AdamWConfig(), TrainConfig()
    batch = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=1, seq_override=MESH_TOKENS)
    kept, counts = {}, {}
    for run in ("plain", "mesh"):
        state = init_train_state(model, 0, opt, tcfg, device)
        if run == "mesh":
            state = distribute_train_state(state, model, opt, tcfg, mesh)
        step = make_train_step(model, opt, tcfg, mesh=mesh if run == "mesh" else None)
        before = dict(runtime.LAUNCHES)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts[run] = {k: runtime.LAUNCHES[k] - before[k] for k in MESH_KERNELS}
        kept[run] = ({k: _full(v) for k, v in metrics.items()}, [_full(p) for p in tu.leaves(state["params"])], wall)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    (m0, p0, w0), (m1, p1, w1) = kept["plain"], kept["mesh"]
    check(all(torch.equal(m0[k], m1[k]) for k in ("loss", "grad_norm", "total_loss")),
          f"mesh {name}: metrics {[(k, float(m0[k]), float(m1[k])) for k in ('loss', 'grad_norm')]}")
    bad = [i for i, (a, b) in enumerate(zip(p0, p1)) if not torch.equal(a, b)]
    check(not bad, f"mesh {name}: {len(bad)} of {len(p0)} updated parameters differ")
    check(counts["plain"] == counts["mesh"], f"mesh {name}: launches {counts}")
    print(f"  mesh train {name} @{layers} layers, 1 x {MESH_TOKENS}: loss {float(m1['loss']):.6f}, grad norm "
          f"{float(m1['grad_norm']):.6f}, {len(p1)} updated parameters, all equal bit for bit to the run without a "
          f"mesh; launches {counts['mesh']} both; step wall {w0:.2f} s plain, {w1:.2f} s on the mesh")
    del kept
    gc.collect()
    torch.cuda.empty_cache()
    return counts["mesh"]


class _Logged:
    """A model whose prefill and decode logits are kept (on the host)."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, k):
        return getattr(self.model, k)

    def prefill(self, *a, **kw):
        out = self.model.prefill(*a, **kw)
        self.logits.append(_full(out[0]).float().cpu())
        return out

    def decode_step(self, *a, **kw):
        out = self.model.decode_step(*a, **kw)
        self.logits.append(_full(out[0]).float().cpu())
        return out


def _mesh_serve(device, mesh, name: str, layers) -> dict:
    """One greedy request of a MESH_TOKENS-token prompt and MESH_DECODE_STEPS
    decode steps through ``Engine``, without and with ``mesh``: the prefill
    and decode logits and the tokens equal bit for bit, the launches equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.models import build_model
    from repro_torch.serving import Engine, Request

    cfg = get_config(name)
    cfg = dataclasses.replace(cfg, n_layers=layers) if layers else cfg
    model = build_model(cfg)
    params = model.init(0, device)
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size, MESH_TOKENS).astype(np.int32)
    out, counts = {}, {}
    for run in ("plain", "mesh"):
        logged = _Logged(model)
        eng = Engine(logged, params, slots=1, max_len=MESH_TOKENS + 8, device=device,
                     mesh=mesh if run == "mesh" else None)
        eng.submit(Request(rid=0, prompt=prompt, max_tokens=MESH_DECODE_STEPS + 1, temperature=0.0, seed=0))
        before = dict(runtime.LAUNCHES)
        done = eng.run()
        torch.cuda.synchronize()
        counts[run] = {k: runtime.LAUNCHES[k] - before[k] for k in MESH_KERNELS}
        out[run] = ([np.asarray(t).tolist() for t in done[0].generated], logged.logits)
        del eng
        gc.collect()
    (t0, l0), (t1, l1) = out["plain"], out["mesh"]
    check(t0 == t1, f"mesh serve {name}: tokens {t0} against {t1}")
    check(len(l0) == len(l1) == MESH_DECODE_STEPS + 1 and all(torch.equal(a, b) for a, b in zip(l0, l1)),
          f"mesh serve {name}: the logits differ")
    check(counts["plain"] == counts["mesh"], f"mesh serve {name}: launches {counts}")
    print(f"  mesh serve {name}{f' @{layers} layers' if layers else ''}: prefill of {MESH_TOKENS} tokens and "
          f"{MESH_DECODE_STEPS} decode steps, tokens {t1} and logits equal bit for bit to the run without a mesh; "
          f"launches {counts['mesh']} both")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return counts["mesh"]


def _mesh_costs(device, mesh) -> None:
    """The cost counter (``launch.hlo_costs``) on granite's mesh train step:
    counted FLOPs and bytes beside the measured step time, their shares of
    the H100's bf16 peak and HBM rate, and model FLOPs (``train_bound``).
    No claim rides on it."""
    import torch

    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import make_batch
    from repro_torch.launch.hlo_costs import trace
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.train_step import distribute_train_state

    name, layers = MESH_TRAIN[0]
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    model = build_model(cfg)
    opt, tcfg = AdamWConfig(), TrainConfig()
    state = distribute_train_state(init_train_state(model, 0, opt, tcfg, device), model, opt, tcfg, mesh)
    step = make_train_step(model, opt, tcfg, mesh=mesh)
    batch = make_batch(cfg, SHAPES["train_4k"], 0, batch_override=1, seq_override=MESH_TOKENS)
    state, _ = step(state, batch)  # warm
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        state, _ = step(state, batch)
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    ms = statistics.median(times)
    costs = trace(step, state, batch).costs()
    torch.cuda.synchronize()
    flops, nbytes = costs["flops"], costs["bytes"]
    model_flops = train_bound(cfg, 1, MESH_TOKENS)["flops"]
    print(f"  cost counter, {name} @{layers} layers mesh train step (1 x {MESH_TOKENS}): counted {flops:.6g} FLOPs "
          f"(dot {costs['flops_by_op'].get('dot', 0):.6g}), {nbytes:.6g} bytes; step {ms:.3f} ms (CUDA events, "
          f"median of 3); FLOPs / 989e12 = {flops / BF16_TC_OPS_PER_S * 1e3:.3f} ms "
          f"({flops / BF16_TC_OPS_PER_S * 1e3 / ms:.3f} of the step), bytes / 3.35e12 = "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms ({nbytes / HBM_BYTES_PER_S * 1e3 / ms:.3f} of the step); "
          f"model FLOPs (6ND + attention) {model_flops:.6g}")
    print("    by op: " + ", ".join(f"{k} {v:.4g} FLOPs" for k, v in sorted(costs["flops_by_op"].items())) + "; "
          + ", ".join(f"{k} {v:.4g} B" for k, v in sorted(costs["bytes_by_op"].items())))
    del state
    gc.collect()
    torch.cuda.empty_cache()


def _k1() -> dict:
    from repro_torch.kernels import runtime

    return {k: runtime.LAUNCHES[k] for k in ("mapper_carries", "mapper_carries_backward")}


def _mesh_population(device, mesh) -> dict:
    """popsim's member-sharded body (``population_chunk_sharded``) on the
    one-rank ("pop",) mesh against the plain path at phase 5e's
    configuration, in turns (plain, sharded, sharded, plain): the history and
    every state leaf equal bit for bit, K1's launches equal; member-epochs/s
    of both.  Then ``Session.frontier(mesh=)`` at bench_pareto.py's
    configuration against the same call without a mesh.  Returns the
    sharded runs' K1 launches."""
    import numpy as np
    import torch

    from repro_torch.api import Session, Workload
    from repro_torch.core import popsim

    inp = scale_population(device)
    start = popsim.init_population_state(inp["tech"], inp["arch"])
    args = (start, inp["mixes"], inp["gs"], SCALE_LR, inp["sched"])
    runs = {"plain": lambda: popsim.population_chunk(*args, spec=inp["spec"]),
            "sharded": lambda: popsim.population_chunk_sharded(*args, spec=inp["spec"], mesh=mesh)}
    got, walls, k1 = {}, {"plain": [], "sharded": []}, {}
    runs["plain"]()  # warm: the first call of a process builds the kernels' libraries and the spec's arrays
    for run in ("plain", "sharded", "sharded", "plain"):
        torch.cuda.synchronize()
        before = _k1()
        t0 = time.perf_counter()
        state, m = runs[run]()
        walls[run].append(time.perf_counter() - t0)  # each ends in its one host copy of the history
        k1[run] = {k: n - before[k] for k, n in _k1().items()}
        leaves = [_full(x) for x in popsim._state_leaves(state)]
        if run in got:
            check(np.array_equal(m, got[run][0]) and all(torch.equal(a, b) for a, b in zip(leaves, got[run][1])),
                  f"mesh population {run}: a second run from the same state differs")
        got[run] = (m, leaves)
    (m0, l0), (m1, l1) = got["plain"], got["sharded"]
    check(np.array_equal(m0, m1), "mesh population: the sharded body's history differs from the plain path's")
    bad = [i for i, (a, b) in enumerate(zip(l0, l1)) if not torch.equal(a, b)]
    check(not bad, f"mesh population: {len(bad)} of {len(l0)} state leaves differ")
    check(k1["plain"] == k1["sharded"] and k1["plain"]["mapper_carries"] == SCALE_EPOCHS,
          f"mesh population: K1 launches {k1}")
    rate = {r: SCALE_P * SCALE_EPOCHS / statistics.mean(w) for r, w in walls.items()}
    print(f"  mesh population P={SCALE_P} on the LM stack [5,1024], {SCALE_EPOCHS} epochs on the ('pop',) mesh: "
          f"history [{m1.shape[0]}, {m1.shape[1]}, 5] and {len(l1)} state leaves equal bit for bit to the plain "
          f"path; K1 launches {k1['sharded']} both; member-epochs/s plain {rate['plain']:.1f}, sharded "
          f"{rate['sharded']:.1f} (host clock, mean of 2 in turns: plain {[round(w, 4) for w in walls['plain']]} s, "
          f"sharded {[round(w, 4) for w in walls['sharded']]} s)")

    ref = dict(np.load(PARETO_FIXTURE))
    kw = pareto_kwargs(ref)
    sess = Session("base", device=device)
    w = Workload([str(n) for n in ref["workloads"]], device=device)
    before = _k1()
    t0 = time.perf_counter()
    meshed = sess.frontier(w, mesh=mesh, **kw)
    wall = time.perf_counter() - t0
    k1_frontier = {k: n - before[k] for k, n in _k1().items()}
    plain = sess.frontier(w, **kw)
    check(np.array_equal(meshed.raw.history, plain.raw.history)
          and np.array_equal(meshed.raw.log_metrics, plain.raw.log_metrics)
          and meshed.hypervolume == plain.hypervolume
          and [p.dhd for p in meshed.front] == [p.dhd for p in plain.front],
          "mesh frontier: history, log metrics, hypervolume or winners differ from the run without a mesh")
    print(f"  mesh frontier, bench configuration (P={int(ref['population'])}, {int(ref['steps'])} steps) on the "
          f"('pop',) mesh: front of {len(meshed.front)}, hypervolume {meshed.hypervolume:.6g}, winners' .dhd text "
          f"equal to the call without a mesh; wall {wall:.3f} s")
    return {k: k1["sharded"][k] + k1_frontier[k] for k in k1_frontier}


def _mesh_compressed_psum(device, mesh) -> None:
    """``compressed_psum`` over the one-rank group of the (1, 1) mesh's
    "data" dim, two rounds (the second carrying the first's residual), each
    equal bit for bit to ``ef_compress_tree`` on granite-3-8b @2's gradient
    tree (the mesh train step's loss and gradients, 1 x MESH_TOKENS)."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.data import batch_to, make_batch
    from repro_torch.launch.specs import batch_specs, distribute_tree
    from repro_torch.models import build_model
    from repro_torch.models.model import on_mesh
    from repro_torch.optim import AdamWConfig, compressed_psum, ef_compress_tree, init_error_buffer
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.train_step import distribute_train_state

    name, layers = MESH_TRAIN[0]
    cfg = dataclasses.replace(get_config(name), n_layers=layers)
    model = build_model(cfg)
    opt, tcfg = AdamWConfig(), TrainConfig()
    params = distribute_train_state(init_train_state(model, 0, opt, tcfg, device), model, opt, tcfg, mesh)["params"]
    batch = batch_to(make_batch(cfg, SHAPES["train_4k"], 0, batch_override=1, seq_override=MESH_TOKENS), device)
    live = tu.tree_map(lambda p: p.detach().requires_grad_(True), params)
    with torch.enable_grad(), on_mesh(mesh):
        loss, _ = model.loss(live, distribute_tree(batch, mesh, batch_specs(cfg, mesh, batch)), mesh=mesh)
        grads = torch.autograd.grad(loss, tu.leaves(live))
    grads = tu.unflatten_like(params, [_full(g) for g in grads])
    del live, params
    err = err_ref = init_error_buffer(grads)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, err = compressed_psum(grads, "data", err, mesh=mesh)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        want, err_ref = ef_compress_tree(grads, err_ref)
        bad = [p for (p, a), b, e, f in zip(tu.leaves_with_path(mean), tu.leaves(want), tu.leaves(err),
                                            tu.leaves(err_ref)) if not (torch.equal(a, b) and torch.equal(e, f))]
        check(not bad, f"compressed_psum: {len(bad)} leaves differ from ef_compress_tree ({bad[:3]})")
    n = sum(g.numel() for g in tu.leaves(grads))
    print(f"  compressed_psum over the one-rank 'data' group: {name} @{layers} gradient tree ({len(tu.leaves(grads))} "
          f"leaves, {n} elements, loss {float(_full(loss.detach())):.6f}), 2 rounds, mean and residual equal bit for "
          f"bit to ef_compress_tree; wall {[round(w, 4) for w in walls]} s (host clock after a sync; the first "
          f"round's all-reduce starts the group's NCCL communicator)")
    del grads, mean, err, want, err_ref
    gc.collect()
    torch.cuda.empty_cache()


def _mesh_pipeline(device, mesh) -> dict:
    """``pipeline_apply`` on the one-rank ("stage",) mesh against the same
    layers applied microbatch by microbatch in a plain loop: granite-3-8b's
    dense block (``self_attn_block`` and ``mlp_block`` with their residuals,
    positions fixed; attention through K3 and its plain backward) at full
    width, PIPE_LAYERS stacked bf16 layers, PIPE_MICROBATCHES microbatches of
    1 x MESH_TOKENS bf16 tokens, forward and ``backward()``: y and every
    gradient equal bit for bit, K3's launches equal.  Returns the pipeline's
    launches."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.configs import get_config
    from repro_torch.kernels import runtime
    from repro_torch.models import build_model
    from repro_torch.models import transformer as T
    from repro_torch.models.model import cast_layer_params
    from repro_torch.train import pipeline_apply

    cfg = dataclasses.replace(get_config("granite-3-8b"), n_layers=PIPE_LAYERS)
    layers = cast_layer_params(cfg, build_model(cfg).init(0, device)["layers"])
    positions = torch.arange(MESH_TOKENS, device=device).expand(1, MESH_TOKENS)

    def layer_fn(lp, h):
        a, _ = T.self_attn_block(cfg, lp, h, positions)
        h = h + a
        return h + T.mlp_block(cfg, lp, h)

    g = torch.Generator(device=device).manual_seed(K3_SEED)
    x0 = torch.randn(PIPE_MICROBATCHES, MESH_TOKENS, cfg.d_model, generator=g, device=device).to(torch.bfloat16)

    def plain(W, x):
        outs = []
        for h in x.reshape(PIPE_MICROBATCHES, 1, MESH_TOKENS, cfg.d_model):
            for i in range(PIPE_LAYERS):
                h = layer_fn({k: v[i] for k, v in W.items()}, h)
            outs.append(h)
        return torch.stack(outs).reshape(x.shape)

    runs = {"plain": plain,
            "pipeline": lambda W, x: pipeline_apply(mesh, layer_fn, W, x, n_microbatches=PIPE_MICROBATCHES)}
    got, counts, walls = {}, {}, {"plain": [], "pipeline": []}
    for run in ("plain", "pipeline", "pipeline", "plain"):
        W = {k: v.detach().clone().requires_grad_(True) for k, v in layers.items()}
        x = x0.clone().requires_grad_(True)
        torch.cuda.synchronize()
        before = runtime.LAUNCHES["flash_attention_sm90"]
        t0 = time.perf_counter()
        y = runs[run](W, x)
        y.float().sum().backward()
        torch.cuda.synchronize()
        walls[run].append(time.perf_counter() - t0)
        counts[run] = runtime.LAUNCHES["flash_attention_sm90"] - before
        out = (y.detach(), x.grad, {k: v.grad for k, v in W.items()})
        if run in got:
            check(torch.equal(out[0], got[run][0]) and torch.equal(out[1], got[run][1])
                  and all(torch.equal(out[2][k], got[run][2][k]) for k in out[2]),
                  f"pipeline {run}: a second run differs from the first")
        else:
            got[run] = out
        del W, x, y, out
    (y0, gx0, gw0), (y1, gx1, gw1) = got["plain"], got["pipeline"]
    check(torch.equal(y0, y1), "pipeline: y differs from the microbatch loop's")
    check(torch.equal(gx0, gx1), "pipeline: x's gradient differs from the microbatch loop's")
    bad = [k for k in gw0 if not torch.equal(gw0[k], gw1[k])]
    check(not bad, f"pipeline: the gradients of {bad} differ from the microbatch loop's")
    want = PIPE_MICROBATCHES * PIPE_LAYERS
    check(counts["plain"] == counts["pipeline"] == want, f"pipeline: K3 launches {counts}, want {want} each")
    print(f"  pipeline granite-3-8b dense block @{PIPE_LAYERS} layers on the ('stage',) mesh, {PIPE_MICROBATCHES} "
          f"microbatches of 1 x {MESH_TOKENS} bf16, forward and backward: y, x's gradient and {len(gw1)} stacked "
          f"parameters' gradients equal bit for bit to the microbatch loop; K3 launches {counts['pipeline']} each "
          f"run of both; wall in turns (plain, pipeline, pipeline, plain; host clock after a sync) plain "
          f"{[round(w, 4) for w in walls['plain']]} s, pipeline {[round(w, 4) for w in walls['pipeline']]} s")
    del got, layers
    gc.collect()
    torch.cuda.empty_cache()
    return {"flash_attention_sm90": counts["pipeline"]}


def phase_mesh(device, dryruns: dict) -> dict:
    """The mesh path: a one-rank NCCL process group (a FileStore) and
    ``make_local_mesh()``, a (1, 1) DeviceMesh on the card; the training and
    serving runs of MESH_TRAIN and MESH_SERVE each equal bit for bit to the
    same run without a mesh, under deterministic algorithms; the cost
    counter on granite's step; ``compressed_psum``; GPipe on a one-rank
    ("stage",) mesh; popsim's member-sharded body and ``Session.frontier``
    on a one-rank ("pop",) mesh; then the dry runs started at the top of the
    run, collected.  Returns the mesh runs' launches."""
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch.mesh import make_local_mesh

    counts = {k: 0 for k in MESH_KERNELS}
    torch.cuda.set_device(device.index if device.index is not None else torch.cuda.current_device())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
        torch.use_deterministic_algorithms(True)
        try:
            mesh = make_local_mesh()
            print(f"  mesh: {mesh} ({mesh.mesh_dim_names}, shape {tuple(mesh.shape)})")
            for name, layers in MESH_TRAIN:
                for k, n in _mesh_train(device, mesh, name, layers).items():
                    counts[k] += n
            for name, layers in MESH_SERVE:
                for k, n in _mesh_serve(device, mesh, name, layers).items():
                    counts[k] += n
            _mesh_costs(device, mesh)
            _mesh_compressed_psum(device, mesh)
            one = torch.arange(1)
            for k, n in _mesh_pipeline(device, DeviceMesh("cuda", one, mesh_dim_names=("stage",))).items():
                counts[k] += n
            # the population runs as the DSE and session paths do, where it repeats bit for bit
            torch.use_deterministic_algorithms(False)
            for k, n in _mesh_population(device, DeviceMesh("cuda", one, mesh_dim_names=("pop",))).items():
                counts[k] += n
        finally:
            torch.use_deterministic_algorithms(False)
            dist.destroy_process_group()
    collect_dryruns(dryruns)
    return counts


# the mapper's kernels around K1 run on every no-gradient call of map_workload
MAPPER_KERNELS = ("mapper_intrinsics", "mapper_finish")
SIM_KERNELS = ("mapper_carries", "mapper_carries_backward", "popsim", *MAPPER_KERNELS)
DSE_KERNELS = ("mapper_carries", "mapper_carries_backward", *MAPPER_KERNELS)
SESSION_KERNELS = ("mapper_carries", "mapper_carries_backward", *MAPPER_KERNELS)
DESIGN_KERNELS = ("mapper_carries", "mapper_carries_backward", *MAPPER_KERNELS)
SCAN_KERNELS = ("affine_scan",)
SERVE_KERNELS = ("flash_attention_sm90", "ssd_chunk_scan", "selective_scan")
# bf16 attention and the scans, forward (their backwards are plain PyTorch)
TRAIN_KERNELS = ("flash_attention_sm90", "ssd_chunk_scan", "selective_scan")
# the reduced configs' bf16 heads of 16 go to the float32-pipe attention kernel
LAUNCH_KERNELS = ("selective_scan", "ssd_chunk_scan", "flash_attention")
AGREE_KERNELS = ("flash_attention", "ssd_chunk_scan", "selective_scan")  # float32 attention and the scans
META = {  # kernel -> (source, the TPU kernel it replaces)
    "affine_scan": ("src/repro_torch/kernels/csrc/affine_scan.cu", "src/repro/kernels/sscan.py:134"),
    "mapper_carries": ("src/repro_torch/kernels/csrc/affine_scan.cu", "src/repro/kernels/sscan.py:134"),
    "mapper_carries_backward": ("src/repro_torch/kernels/csrc/affine_scan.cu", "src/repro/kernels/sscan.py:186"),
    "popsim": ("src/repro_torch/kernels/csrc/popsim.cu", "src/repro/kernels/popsim_kernel.py:152"),
    "mapper_intrinsics": ("src/repro_torch/kernels/csrc/mapper.cu", "none (XLA fused)"),
    "mapper_finish": ("src/repro_torch/kernels/csrc/mapper.cu", "none (XLA fused)"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu", "src/repro/kernels/flash_attention.py:88"),
    "flash_attention_sm90": ("src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention.py:88"),
    "ssd_chunk_scan": ("src/repro_torch/kernels/csrc/ssd.cu", "src/repro/kernels/ssd.py:93"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu", "src/repro/kernels/sscan.py:70"),
}


def drive(name: str, phases, kernels) -> dict:
    """Run one main path with the launch counts set to 0 just before and read
    just after; fail unless each of its kernels was launched."""
    import torch

    from repro_torch.kernels import runtime

    print(f"{name} path:")
    t0 = time.perf_counter()
    runtime.reset_launches()
    for phase in phases:
        phase()
    torch.cuda.synchronize()
    launches = {k: runtime.LAUNCHES[k] for k in kernels}
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched on the {name} path")
    print(f"{name}-path launches: {dict(runtime.LAUNCHES)}")
    print(f"{name} path: {time.perf_counter() - t0:.1f} s, ending {time.perf_counter() - T_START:.1f} s into the run")
    return launches


def main() -> int:
    # the Trainer's replay runs with deterministic algorithms, for which cuBLAS
    # needs a fixed workspace, set before CUDA starts
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    # segments that grow in place: llama4-scout's int8 train step peaks at 70.7
    # of the card's 79.2 GiB, and with fixed segments one run's 10.29 GiB of
    # free fragments could not hold the step's 3.86 GiB block
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch.kernels import runtime

    global T_START
    T_START = time.perf_counter()
    device = runtime.resolve_device(None)
    smi = phase_env()
    phase_build()
    # the mesh path's dry runs, on the host while the card runs the other paths
    dryruns = start_dryruns()
    print("kernels against their plain versions:")
    # the CPU's side of the scans' backward checks, on a host thread while the kernels are checked
    scan_cases = scan_backward_cases()
    scan_cpu = start_cpu_scan_backward(scan_cases)
    rec = phase_kernels(device)
    stamp("K1's and K2's checks and records")
    rec.update(phase_model_kernels(device, scan_cases, scan_cpu))
    del scan_cases, scan_cpu

    launches = drive("simulator", [lambda: phase_simulate(device), lambda: phase_optimize(device),
                                   lambda: phase_no_streaming(device), lambda: phase_population(device)],
                     SIM_KERNELS)
    dse = {}
    for k, n in drive("dse", [lambda: phase_dse_library(device), lambda: phase_dse_refsim(device),
                              lambda: phase_dse_equivalence(device), lambda: phase_dse_bench(device, dse),
                              lambda: phase_dse_scale(device, dse)], DSE_KERNELS).items():
        launches[k] += n  # the simulator path's and the DSE path's launches of K1
    for k, n in drive("session", [lambda: phase_session(device, smi, dse)], SESSION_KERNELS).items():
        launches[k] += n  # and the session path's
    design = {}
    for k, n in drive("design", [lambda: design.update(phase_design(device, smi))], DESIGN_KERNELS).items():
        launches[k] += n  # and the design path's
    for k, n in drive("pool", [lambda: phase_pool(device, smi, design)], DESIGN_KERNELS).items():
        launches[k] += n  # and the pool path's (its staged and pooled tiers; workers count their own)
    # the agreement path's numpy weights for the transformer and SSM fixtures,
    # made on host threads while the paths from here on run (started after the
    # design and pool paths, which are bound by the host's cores)
    lm_weights = prefetch_agree_weights(LM_FIXTURE)
    ssm_weights = prefetch_agree_weights(FIXTURE)
    launches.update(drive("affine-scan", [lambda: phase_affine_scan(device)], SCAN_KERNELS))
    t0 = time.perf_counter()
    served = {}
    launches.update(drive("serving", [lambda: served.update(phase_serve(device))], SERVE_KERNELS))
    # each model's count was held in phase_serve (bf16 kernel: every attention
    # layer of a prefill and the vlm's cross layers a decode step; float32 kernel: 0)
    check(launches["flash_attention_sm90"] == sum(n["flash_attention_sm90"] for n in served.values())
          and runtime.LAUNCHES["flash_attention"] == 0,
          f"serving path: {launches['flash_attention_sm90']} launches of flash_attention_sm90 (per model "
          f"{served}) and {runtime.LAUNCHES['flash_attention']} of the float32 kernel (want 0)")
    print(f"serving path wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    trained = {}
    for k, n in drive("training", [lambda: trained.update(phase_train(device)),
                                   lambda: trained.update(trainer=phase_trainer(device))], TRAIN_KERNELS).items():
        launches[k] += n  # the serving path's and the training path's launches of the bf16 kernel and the scans
    # each run's counts were held in phase_train and phase_trainer (attention: 2 a
    # self layer a step, the forward and its recompute, 1 a cross layer or shared
    # block; a scan: 2 an SSM layer); the float32 kernel: 0
    check(all(sum(n.get(k, 0) for n in trained.values()) == runtime.LAUNCHES[k] for k in TRAIN_KERNELS)
          and runtime.LAUNCHES["flash_attention"] == 0,
          f"training path: launches {dict(runtime.LAUNCHES)} against the runs' {trained} (the float32 attention "
          f"kernel: want 0)")
    print(f"training path wall {time.perf_counter() - t0:.1f} s")
    attention_backward_ms(device)  # after the path's counts are read: its launches count nowhere
    t0 = time.perf_counter()
    for k, n in drive("launch", [lambda: phase_launch(device)], LAUNCH_KERNELS).items():
        launches[k] = launches.get(k, 0) + n
    print(f"launch path wall {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    for k, n in drive("mesh", [lambda: phase_mesh(device, dryruns)], MESH_KERNELS).items():
        launches[k] = launches.get(k, 0) + n
    print(f"mesh path wall {time.perf_counter() - t0:.1f} s")
    print("agreement with the reference package (fixtures), float32:")
    with open("/proc/meminfo") as f:  # the host's headroom beside the fixtures' numpy weights
        mem = {ln.split(":")[0]: int(ln.split()[1]) / 2**20 for ln in f if ln.startswith(("MemTotal", "MemAvailable"))}
    print(f"  host memory: {mem['MemAvailable']:.1f} of {mem['MemTotal']:.1f} GiB available")
    t0 = time.perf_counter()
    import numpy as np

    with np.load(SSM_TRAIN_FIXTURE) as ref:
        ssm_train_keys = [str(k) for k in ref["entries"]]
    for k, n in drive("agreement", [*(lambda key=key: phase_train_agree(device, ssm_weights, SSM_TRAIN_FIXTURE, key)
                                      for key in ssm_train_keys),
                                    lambda: phase_agree(device, FIXTURE, ssm_weights),
                                    lambda: phase_train_agree(device, lm_weights),
                                    lambda: phase_agree(device, LM_FIXTURE, lm_weights)], AGREE_KERNELS).items():
        launches[k] = launches.get(k, 0) + n
    print(f"agreement path wall {time.perf_counter() - t0:.1f} s")
    print("where the time goes:")
    phase_profile(device, dse)

    kernels = []
    for name, r in rec.items():
        # the least time: the larger of the bytes' and the operations' (the
        # exponentials shared between the special-function unit and the FP32 pipe)
        terms = bound_terms({"peak": FP32_OPS_PER_S, "exps": 0, **r})
        by = "bytes" if terms["bytes"] >= terms["operations_and_exponentials"] else "operations"
        bound = terms["bytes" if by == "bytes" else "operations_and_exponentials"]
        kernel = r.get("kernel", name)  # a record of a kernel at another shape names it
        kernels.append(dict(
            name=name, route="cuda", source=META[kernel][0], replaces=META[kernel][1],
            launches=launches[kernel], max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=bound, bound_by=by, bound_terms_ms=terms, library_ms=r.get("library_ms"),
        ))
        for key in ("ms_by_prompt", "ms_by_kernel", "ms_by_P", "ms_by_shape", "bound_ms_by_shape",
                    "plain_ms_by_shape", "max_rel_err", "ms_with_entering_states"):
            if key in r:
                kernels[-1][key] = r[key]
        host = f", host path {r['host_ms']:.6f} ms per call" if "host_ms" in r else ""
        by_prompt = ("; by prompt length " + ", ".join(f"{S}: {ms:.6f}" for S, ms in r["ms_by_prompt"].items())
                     if "ms_by_prompt" in r else "")
        by_prompt += ("; by kernel " + ", ".join(f"{k}: {ms:.6f}" for k, ms in r["ms_by_kernel"].items())
                      if "ms_by_kernel" in r else "")
        by_prompt += ("; by P " + ", ".join(f"{P}: {ms:.6f}" for P, ms in r["ms_by_P"].items())
                      if "ms_by_P" in r else "")
        by_prompt += ("; by shape " + ", ".join(f"{k}: {ms:.6f} (bound {r['bound_ms_by_shape'][k]:.6f})"
                                                for k, ms in r["ms_by_shape"].items())
                      if "ms_by_shape" in r else "")
        library = f"; library {r['library_ms']:.6f} ms" if r.get("library_ms") is not None else ""
        print(f"  {name}: device {r['ms']:.6f} ms ({r['ms_method']}){host}{by_prompt}; plain device "
              f"{r['plain_ms']:.6f} ms{library}; bound {bound:.6f} ms ({by}; "
              + ", ".join(f"{k} {v:.6f}" for k, v in terms.items()) + ")")
    print(f"command time: {time.perf_counter() - T_START:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
