"""Smoke run of the PyTorch + CUDA port (vilma_tpu_torch) on one GPU.

    python3 chip_smoke.py     # every phase, one CUDA device
    python3 chip_smoke.py --split-only   # phases 1-2, then phase 3's
                                         # K-split kernels alone; no JSON
    python3 chip_smoke.py --matvec-only  # phases 1-2, then phase 3's
                                         # matvec cases (bars printed, not
                                         # required), the group route's
                                         # B-sweep and stamps; no JSON

Phases:
  1. device: the card's name and power limit; refuses without CUDA.
  2. build: nvcc builds the kernels from vilma_tpu_torch/csrc (one nvcc
     per source, in parallel).
  3. kernels: each CUDA kernel against its plain PyTorch version on the
     card at main-path shapes, within a stated band, bit-for-bit
     repeatable, with CUDA-event times of both (the matvec also beside
     its cuBLAS route) and the least time the card could take (bound);
     each kernel's cluster size and what ptxas reported for it. The
     matvec in bf16 and f32 U (the cluster route) and at five oversize
     buckets (the group route: 128 and 4 blocks of [2048, 1024] f32, 128
     of [2048, 512] f32, 64 of [2048, 1024] bf16, 8 of [4096, 4096]
     bf16), and at the widths of phase 13 (beside cuBLAS in turns, no
     bar): 4 and 8 cohorts a launch (the traits of a --trait fit: 977 and
     88 bf16 blocks, 4 f32 blocks at 4) and one (977 bf16 blocks). The
     group route's B-sweep (ms a call at B = 1-128 blocks of [2048, 1024]
     f32 and bf16 and 1-8 of [4096, 4096] bf16, CUDA events, the L2
     flushed, the card kept busy past the enqueue; the least-squares us a
     block and a launch) and its stamps (the measurement build,
     build.library('stamps'): CTA 0's clock64 at each phase of each panel,
     the mean offsets and period; its output equal to the main library's
     bit for bit). The epoch prologue at
     2 and 1 live epochs and on a clamp-heavy input; the [P, I] sums at a
     K·A past one shared-memory group. Bars required, each side measured
     in this run: the bf16 matvec and the group route at the two 128-block
     f32 buckets and at 64 [2048, 1024] bf16 blocks no slower than cuBLAS
     in turns; at 1M SNPs, P = 2,
     K = 582, the epoch sums (1 live epoch) at most 2.0x the epoch
     prologue, the [P, I] prologue no slower than the epoch prologue, and
     the [P, I] sums at most 2.0x the [P, I] prologue; at 90,112 SNPs the
     kdim sums at most 2.0x the kdim prologue. The matvec's backward
     (the forward's kernel on the gradient, under autograd) at phase 4's
     bucket against the plain matvec on the gradient, timed through
     torch.autograd.grad against the plain version's own autograd. The
     K-split kernels of component sharding at phase 16's shapes (2 slices
     of 291 components: the shared and kdim state on 45,056 slots, the
     epoch state on 1,000,448): each partial, pass 1 and pass 2 against
     its plain version (pass 2 given the stacked pass-1 partials, whose
     normalizers it merges itself), the prologue's merge on the kernels'
     partials (one device launch a call), and the whole split path
     against the whole-K kernels and plain versions; repeatable bit for
     bit. Each K-split row prints, beside the CUDA-event ms, the device ms
     a call (kernel durations from torch.profiler, the L2 cache flushed
     before each call) and the host us a call (the enqueue); the merge
     also at the epoch shape's 1,000,448 SNPs.
  4. fit: `vilma-tpu-torch fit` in-process on a synthetic on-disk schema
     the size of a per-chromosome HapMap3 fit (~90K variants in
     1024-SNP AR(1) blocks at half rank, factored for the schema by
     batched float64 eigh on the card, 2 cohorts sharing the panel) at
     the default -K 12 grid (582 components), f32 with bf16 LD, which
     takes the streamed output route. The kernel launch counters are
     zeroed just before and read just after: every kernel of the path
     must launch. Then small-input references: a 2-block fit on the
     card (f32) held against the same fit on the host at f64, without
     and with --learn-scaling (kdim and epoch-history routes). Phases
     4-11 memoize the loader's host factors (memo_factors): phase 4's
     fit factors its panel, and phases 6, 10 and 11 reuse the factors.
  4b. fit at the default precision (f32 U) on a schema of a 1024-SNP and
     a 2048-SNP block: the f32 cluster route and the group route of the
     matvec must launch; then the same fit with bf16 U: the group route
     must launch with bf16 U (the kernels line's _group_bf16 entry).
  5. engine: 1M SNPs (977 blocks of 1024), 2 cohorts, K = 18, bf16 U;
     3 timed outer steps after one warm-up step.
  6. fit --learn-scaling: phase 4's schema and flags; the kdim
     [K, P, I] state (420 MB). Steps until an error-scaling EM event
     fires (step cap STEP_CAP_SE), writing a checkpoint every
     CHECKPOINT_FREQ steps; the kdim kernels must launch.
  7. engine --learn-scaling: phase 5's LD, the 582-component grid of
     the CLI; the epoch-history state, selected by size. One warm-up
     step, one EM append, 3 timed outer steps.
  8. make_ld_schema --ldthresh 0.8 on the card of a synthetic PLINK
     chromosome: 503 samples (the 1000 Genomes EUR panel), ~90K SNPs in
     130 blocks of 500-900 (HapMap3 chromosome 1 under Berisa-Pickrell
     blocks), ~1% missing calls, a few monomorphic SNPs. The host
     rebuilds the first blocks (--device cpu --extract): .schema and
     .var text equal, ranks equal, eigenvalues and U diag(s) U^T within
     BAND_SCHEMA.
  9. check_ld_schema --trace --listvars of that schema on the card and
     on the host: equal text.
 10. sim from phase 4's fit (its .npz and .covariance.pkl) on phase 4's
     schema, 2 cohorts, the default RNG path, on the card (f32), on the
     host at f64 and at f32 (the host runs reuse the card run's host LD
     factors: the same code on the same blocks): true_beta equal to the
     host's bit for bit, BETA within BAND_SIM of the host f64 run; the
     matvec must launch.
 11. resume: phase 6's last checkpoint through fit --load-checkpoint
     (the kdim state, streamed), and phase 7's epoch state dumped and
     resumed through MultiPopVI.optimize; the ELBO after resuming
     within BAND_RESUME of the original run's; their kernels must
     launch.
 12. the K-chunked shape: ~100K SNPs (phase 5's device LD, 98 blocks)
     shared by 3 cohorts, the -K 12 --drop-non-psd grid (42,999
     components), f32, the shared state: the [P, I] prologue and sums
     against their plain versions at this shape, then MultiPopVI.optimize
     (the initialization and 2 timed outer steps); seconds and peak
     device memory of each; the [P, I] kernels must launch. Then the
     fit's outputs into a temporary directory, where the disk holds
     vi_mu and vi_delta (~69 GB) plus 20%: the .npz of dump_spec
     streamed by utils/npz_stream (vi_mu [42999, 3, 100352], vi_delta
     [100352, 42999]; no vi_sigma, ~155 GB) and the estimates; seconds
     and peak host RSS of the write; the members read back with their
     shapes, the last vi_mu chunk equal to vi_mu_chunks' bit for bit;
     the files deleted. Where the disk is short, the free and needed
     bytes are printed, nothing is written, and the same chunks and
     estimates are drained without a file (seconds, peak host RSS, the
     rows the chunks cover).
 13. the materialized path (P >= 4), its ELBO finite, no compact kernel:
     a. `fit --trait` of 4 traits on one ~90K-variant panel (phase 4's
        schema size, bf16 U), -K 3 --drop-non-psd (~1,953 components),
        f32, 5 steps, --no-save-vi-sigma, its factors cached in a fresh
        --factor-cache (16c reads them): seconds and host syncs per
        step, peak device memory, where the seconds go (time_calls);
        the matvec must launch at 4 cohorts;
     b. 4 ancestries at genome scale through MultiPopVI: 1,000,448 SNPs,
        a bf16 panel each (phase 5's generator, 4 seeds; the first is
        phase 5's own panel, each other one ANCESTRY_DISTINCT factored
        AR(1) blocks spread over its 977), -K 2
        --drop-non-psd (216 components), f32: the initialization and 2
        steps, seconds and peak memory;
     c. a 4-trait fit of 4 blocks, -K 2: the card's f32 fit within
        BAND_TRAIT_FACTOR x the host's own f32 error of the host's f64
        fit; resumed through --load-checkpoint from its own checkpoint,
        the ELBO within BAND_RESUME;
     d. 8 traits on one panel through MultiPopVI: the matvec at 8
        cohorts a launch.
     Phase 13 takes ~2 minutes of the ~8 the phases take on an H100
     80GB HBM3 at 700 W.
 14. bounded-memory loading and the validation tools, on phase 4's
     panel:
     a-c. phase 4's fit (FACTOR_ITS steps), each in a process of its own:
        a. with --factor-cache in a fresh directory: a miss for every
           block, no hit;
        b. the same command again: a hit for every block, no miss, every
           output file (.npz members, .estimates.tsv, .covariance.pkl)
           bit for bit 14a's; load seconds beside 14a's;
        c. again with --mmap (the disk spill), the reference's mmap RNG
           draws switched off so the grid is 14a's: hits only, 14a's
           outputs bit for bit; peak host RSS (VmHWM) and the peak
           anonymous RSS of the load beside 14b's;
     d. the gradient tool (inference/gradient.py) from phase 4's
        initialized state (P = 2, K = 582, 90,112 SNPs, bf16 U): the ELBO
        gradient through the kernel and its backward against the plain
        version's within BAND_BF16, then GRAD_STEPS Adam steps: the ELBO
        rises, the backward launches; seconds a step, peak memory;
     e. SMC and a short NUTS chain (inference/mcmc.py) on the 8-SNP
        blocks of tests/test_validation.py, densities on the card: finite
        draws, posterior means within BAND_SAMPLER of the VI answer.
 15. sharded fits (parallel/), the shards co-located on cuda:0 unless
     said otherwise; each sharded run's launches are zeroed just before
     and read just after it:
     a. phase 4's fit through commands/fit.main at --mesh snp=SHARDS:
        every output file within BAND_SHARD of phase 4's, the same
        evaluations of the objective and host syncs per step, each
        kernel launched SHARDS times as often;
     b. the same with phase 6's flags (--learn-scaling, the kdim
        kernels) for KDIM_STEPS steps, against the same command
        unsharded (over phase 6's 150 steps the two f32 trajectories
        part: the EM events fire at other steps); then phase 7's epoch
        state at 1M SNPs on EPOCH_SHARDS shards for EPOCH_STEPS steps
        against the same steps unsharded: seconds a step of both;
     and a 2-block fit at --mesh snp=2 on the card (f32) against the
     host's unsharded f64 fit, without and with --learn-scaling, within
     the bands of the unsharded card fit (BAND_FIT, BAND_FIT_SE);
     c. fit --distributed in one fresh process (NCCL, --mesh snp=1),
        run beside 17c's process and read after it: the process group's
        backend; its outputs phase 4's bit for bit;
     d. with two cards or more, two processes over NCCL, one card each,
        at --mesh snp=2, outputs against 15c's; with one card it prints
        `phase 15d not run: 1 card`. Every process of 15c-d must leave
        its process group once, after a barrier.
 16. component sharding (--mesh comp=M), the shards co-located on
     cuda:0; each run's launches zeroed just before and read just after:
     a. phase 4's fit at --mesh comp=2,snp=2 and phase 6's flags for
        KDIM_STEPS steps (kdim) at the same mesh: every output within
        BAND_SHARD of phase 4's (of 15b's unsharded kdim run), the same
        evaluations and host syncs a step, the matvec 4x, no whole-K
        compact kernel, each K-split kernel and merge 4x the whole-K
        kernel's launches; seconds a step; then 3 more steps of the
        shared fit traced (torch.profiler): the busy share, each
        kernel's device ms and launches per evaluation, each K-split
        launcher's host us a call;
     b. phase 12's shape at --mesh comp=4: the K-split path against the
        whole-K kernels and plain versions at one point (K = 42,999, 4
        slices), then the initialization and 2 steps, the ELBO against
        phase 12's;
     c. phase 13a's fit --trait of 4 traits at --mesh comp=2 (13a's
        factor cache, warm): outputs within BAND_SHARD of 13a's, each
        shard's vi_mu, vi_delta and sigma-summary bytes against 13a's
        (half, of K = 1,953);
     d. phase 7's epoch state at --mesh comp=2 for 3 steps against the
        same steps unsharded: seconds a step of both.
 17. the global-gather layout (schemas that disagree on the order of
     shared variants): phase 4's fit with cohort 2 on a copy of its
     panel whose blocks list their variants in reverse (no shard-local
     layout exists), f32 with bf16 LD, --no-save-vi-sigma; each run's
     launches zeroed just before and read just after:
     a. at --mesh snp=3 on cuda:0 (90,112 variants padded to 90,114):
        every output within BAND_SHARD of the same two-panel fit run
        unsharded here, the same evaluations and host syncs a step,
        each kernel launched 3x; every LD matrix in the gathered
        layout, the pad slots' vi_mu and posterior means exactly 0, the
        outputs of n rows; each shard's blocks per bucket, the mesh's
        gather and sum bytes in one evaluation, seconds a step of both;
     b. at --mesh comp=2,snp=2 with phase 6's flags for KDIM_STEPS steps
        (the kdim state): as 16a against the unsharded kdim run of the
        same command, with 17a's readings;
     c. the same command as 17a's reference in one fresh process,
        --distributed --mesh snp=1 over NCCL (the per-process gathered
        loader): the process group left once, after a barrier; outputs
        within BAND_SHARD of the unsharded run's (bit for bit is
        reported).
 18. bench_torch.py, bench.py's twin, each run a subprocess on a copy
     of the script (its LD cache in a temporary directory, where the
     float64 pack of 100,000 SNPs is factored on the card first): a. the
     default run's two legs (100,000 SNPs, 2 cohorts, K = 18, bf16 U):
     the host's f64 baseline leg (BENCH_DEVICE=cpu, its own line) in the
     background from phase 15 on with BASELINE_THREADS host threads,
     read here, then the default run with BENCH_CPU_IPS set to its value
     (the card leg, and the line with vs_baseline); b. --accel with
     BENCH_SCALE_SE=1 BENCH_GRID=cli (582 components, the kdim state);
     c. the same at BENCH_LOCI=300000 (the epoch-history state). Each
     bench line carries the expected metric and a finite value > 0; the
     kernels of its state launch over its timed chains, no other state's
     compact kernel does; lines, launches and seconds are printed.
 19. the drift check (tools/drift_genome_torch.py), each leg a
     subprocess on 18a's problem and LD cache, DRIFT_ITERS (40) outer
     steps: f64cpu on the host, f32cuda (f32 U) and bf16cuda on the
     card, all three started after phase 12 (the LD cache made then) and
     run in the background beside phases 13-18 with DRIFT_THREADS host
     threads each, read here. Each card leg's report against the f64 leg
     (drift_genome.py's keys) is printed and held to the bands of
     tests/test_f32_genome_scale.py: 99.9% of SNPs within 2 posterior
     SDs, at most 0.2% beyond 3, the median absolute difference below
     1e-3 of the posterior scale, the recomputed ELBOs within 5e-3,
     first convergence within 2; the ELBO accumulator within 1e-5 on
     f32cuda (the f64 leg's within 1e-9), printed on bf16cuda. Each
     leg's launches are printed; the matvec, prologue and sums must
     launch on each card leg.
 20. the evaluation chain (tools/eval_scaling_torch.py), run right after
     phase 5 on its engine (1,000,448 SNPs, K = 18, bf16 U): a chain of
     EVAL_CHAIN (50) objective evaluations timed as the tool times it
     (host ms an evaluation, the best of 3 chains), then traced (device
     busy ms an evaluation). Held: the chain's sum within BAND_CHAIN of
     50 x one evaluation's objective; exactly 1 prologue and 1 matvec
     per bucket of the pack an evaluation, no other kernel; no host
     sync (engine.host_syncs unchanged); the tool's top-offset check
     (the prologue over the last 65,536 SNPs, the matvec over the last
     64 blocks, against their plain versions within the phase-3 bands).
     Then bench_hbm_torch.py's read probe at HBM_PROBE_MIB (4096) MiB:
     finite, above 0 and at most HBM_ROOM x the published 3.35 TB/s.
 21. the fit CLI end to end on on-disk inputs, run right after phase 11:
     tools/export_synthetic_schema_torch.py writes bench's problem at
     E2E_LOCI (100,000) SNPs, factored on the card; check_ld_schema
     --trace --listvars reads it back through the port's loader (every
     variant listed; each block's U diag(s) U^T within the f32 rounding
     bound of the exported U and s, 3 * 2^-24 * (|U| s) |U|^T); then fit
     -K 12 --learn-scaling --num-its 5 (the kdim state) through
     tools/e2e_fit_torch.py, which prints its E2E line (seconds by
     stage, RSS, device memory, bytes by member), reusing the trace's
     host factors (memo_factors). The matvec and the kdim kernels must
     launch; every output member is present, finite, of its reckoned
     shape and size.

The next-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Any failed phase exits
nonzero before those lines are printed. Imports nothing of JAX.
"""
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# kernel-vs-plain bands, relative to max|plain|:
#  * f32 results: the kernel and the plain version sum in different
#    orders (f32 accumulators, ~1e-7 per rounding, growing with the
#    number of terms);
#  * bf16 U: t = s * U^T x is rounded to bf16 after an f32 sum whose
#    order differs, so an element on a rounding boundary can land on the
#    neighbouring bf16 value: one bf16 ulp, 2**-8, of the scale. That
#    band alone would also pass a kernel that skips rounding x or t, so
#    check_matvec also holds the kernel closer to the plain version than
#    either half-rounded product is.
BAND_F32 = 1e-5
BAND_BF16 = 2.0 ** -8
# the beta-KL scalar sums ~1e6 * K signed terms: relative band
BAND_KL = 1e-4
# a 5-step f32 fit (f32 LD) against the f64 fit of the same input, per
# posterior column relative to its scale: the host's own f32 fit of that
# input (measured beside the card's) lands within 2.24e-5 and the card's
# within 2.83e-5; the band leaves the kernels' accumulation-order noise
# ~7x room
BAND_FIT = 2e-4
# the same with --learn-scaling, 20 steps through one EM event: the
# host's own f32 fits land within 6.4e-05 (kdim and epoch) and the card's
# within 4.5e-05, their learned scalings within 1.6e-5 relative; the
# bands leave ~10x room
BAND_FIT_SE = 7e-4
BAND_SCALING = 2e-4
SMALL_ITS_SE = '20'        # the first EM event fires at step 17 there
# phase 6: the per-chromosome fit steps until an EM event fires, writing
# a checkpoint every CHECKPOINT_FREQ steps for phase 11
STEP_CAP_SE = 150
CHECKPOINT_FREQ = 40
# phase 8: a chromosome the size of HapMap3's chromosome 1 under
# Berisa-Pickrell blocks (~90K SNPs, ~130 blocks of ~700), genotyped in
# the 1000 Genomes EUR panel's 503 samples; the host rebuilds the first
# SCHEMA_CHECK_BLOCKS blocks. Card against host (float64 both, GEMM
# order and cuSOLVER against LAPACK): eigenvalues relative, U diag(s)
# U^T absolute; they read 7.6e-15 and 9.4e-15 on the H100, the band
# leaves ~100x room
PLINK_SAMPLES = 503
PLINK_BLOCKS = 130
SCHEMA_CHECK_BLOCKS = 6
BAND_SCHEMA = 1e-12
# phase 10: the card's f32 sim BETA against the host's f64 run, relative
# to its scale: the host's own f32 run lands within 2.0e-7 and the
# card's within 7.7e-8; the band leaves ~10x room over the host's
BAND_SIM = 2e-6
# phase 11: the ELBO after a resume against the original run's,
# relative (f32 objectives of a state restored through f32 vi_mu: both
# read 0 on the H100); steps taken after resuming
BAND_RESUME = 1e-6
RESUME_STEPS = 3
# phase 12: PSD components of the -K 12 grid at 3 cohorts
CHUNKED_K = 42_999
# phase 13: `fit --trait` of TRAITS traits (13a: STEPS_TRAIT steps); 13c:
# the card's f32 fit of 4 traits within BAND_TRAIT_FACTOR times the host's
# own f32 fit's error of the host's f64 fit (per column, of its scale)
TRAITS = 4
STEPS_TRAIT = 5
TRAIT_NAMES = ('t1', 't2', 't3', 't4', 't5', 't6', 't7', 't8')
BAND_TRAIT_FACTOR = 10

# phase 15: sharded fits. 15a and 15b's kdim fit (KDIM_STEPS steps) put
# SHARDS shards on cuda:0, 15b's epoch state EPOCH_SHARDS for EPOCH_STEPS
# steps. A sharded f32 fit against the unsharded one, each output
# relative to its scale: the shards' partial sums add in another order
# than one sum over every SNP, and the f32 steps carry that difference
# on (at f64 the two agree to ~1e-13, tests/test_torch_parallel.py). The
# first readings on the H100: 1.97e-3 (15a) and 2.45e-3 (15b kdim), the
# posterior variances the farthest; the band leaves 2x room. The 2-block
# fit sharded on the card meets the unsharded card fit's bands against
# the host's f64 fit (BAND_FIT, BAND_FIT_SE).
SHARDS = 4
KDIM_STEPS = 10
EPOCH_SHARDS = 2
EPOCH_STEPS = 2
BAND_SHARD = 5e-3

# the card's published peaks (NVIDIA H100 SXM data sheet, dense): HBM
# bytes/s, FP32 and bf16 tensor operations/s
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
BF16_OPS_S = 989e12

# each kernel of the port, with the main-path instantiation whose ptxas
# report phase 3 prints (a pattern on the demangled name)
KERNELS = {
    'bucket_matvec_multi': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'cluster_matvec_kernel<__nv_bfloat16, \(int\)2>'),
    'bucket_matvec_multi_f32': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'cluster_matvec_kernel<float, \(int\)2>'),
    'bucket_matvec_multi_group': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'group_matvec_kernel<float, \(int\)2>'),
    'bucket_matvec_multi_group_bf16': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'group_matvec_kernel<__nv_bfloat16, \(int\)2>'),
    'bucket_matvec_multi_c4': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'cluster_matvec_kernel<__nv_bfloat16, \(int\)4>'),
    'bucket_matvec_multi_c8': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'cluster_matvec_kernel<__nv_bfloat16, \(int\)8>'),
    'bucket_matvec_multi_backward': dict(
        source='vilma_tpu_torch/csrc/block_matvec.cu',
        replaces='vilma_tpu/ops/pallas/block_matvec.py:88',
        ptxas=r'cluster_matvec_kernel<__nv_bfloat16, \(int\)2>'),
    'prologue': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:414',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)0, \(int\)0,'),
    'delta_sums': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:653',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)0,'),
    'prologue_kdim': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)0, \(int\)1,'),
    'delta_sums_kdim': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)1,'),
    'prologue_epochs': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:562',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)0, \(int\)2, \(int\)[12]>'),
    'delta_sums_epochs': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:603',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)2, \(int\)[12]>'),
    # the K-split forms of component sharding (phase 16)
    'prologue_partial': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:414',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)0, \(int\)0, .*1>'),
    'prologue_kdim_partial': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)0, \(int\)1, .*1>'),
    'prologue_epochs_partial': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:562',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)0, \(int\)2, \(int\)1, .*1>'),
    'prologue_merge': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:414',
        ptxas=r'merge_kernel<\(int\)2, \(int\)2>'),
    'delta_norm': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:653',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)0, .*1>'),
    'delta_norm_kdim': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)1, .*1>'),
    'delta_norm_epochs': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:603',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)2, \(int\)1, .*1>'),
    # pass 2 of the sums, given the stacked pass-1 partials: each merges
    # its SNPs' normalizers itself (merged_norm; no normalizer-merge kernel)
    'delta_sums_given': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:653',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)0, .*2>',
        note='the normalizer merge folded in'),
    'delta_sums_kdim_given': dict(
        source='vilma_tpu_torch/csrc/compact_obj.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:257',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)1, .*2>',
        note='the normalizer merge folded in'),
    'delta_sums_epochs_given': dict(
        source='vilma_tpu_torch/csrc/compact_obj_epochs.cu',
        replaces='vilma_tpu/ops/pallas/compact_obj.py:603',
        ptxas=r'compact_kernel<\(int\)2, \(bool\)1, \(int\)2, \(int\)1, .*2>',
        note='the normalizer merge folded in'),
}
# the K-split kernels of each state form (phases 3 and 16):
# (prologue partial, sums pass 1, sums pass 2); the merge serves all three
SPLIT_KEYS = {
    'shared': ('prologue_partial', 'delta_norm', 'delta_sums_given'),
    'kdim': ('prologue_kdim_partial', 'delta_norm_kdim',
             'delta_sums_kdim_given'),
    'epochs': ('prologue_epochs_partial', 'delta_norm_epochs',
               'delta_sums_epochs_given'),
}
MERGE_KEYS = ('prologue_merge',)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


_T0 = time.perf_counter()


def phase(msg):
    log(f'{msg} [at {time.perf_counter() - _T0:.1f} s]')


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=20, warmup=3):
    """Mean milliseconds per call from CUDA events around `reps` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def trace_events(prof):
    """The events of a torch.profiler trace (its Chrome trace JSON)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, 'trace.json')
        prof.export_chrome_trace(path)
        with open(path) as fh:
            return json.load(fh)['traceEvents']


def trace_kernels(prof):
    """[(start us, duration us, name)] of the device kernels in a
    torch.profiler trace (CUPTI), in start order."""
    return sorted((e['ts'], e['dur'], e['name']) for e in trace_events(prof)
                  if e.get('cat') == 'kernel' and e.get('ph') == 'X')


DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


def timeline(events, span='outer_steps'):
    """(wall ms, busy ms, {kernel name: [ms, launches]}) of a trace's
    `span` annotation (record_function) and the device events from its
    start: busy is the union of the kernel, memcpy and memset intervals,
    the wall runs to the later of the span's end and the last of them."""
    marks = [e for e in events if e.get('name') == span
             and e.get('cat') == 'user_annotation']
    require(marks, f'the trace has no {span} annotation')
    t0 = marks[0]['ts']
    t1 = t0 + marks[0]['dur']
    dev = sorted((e['ts'], e['ts'] + e['dur'], e['cat'], e['name'])
                 for e in events if e.get('cat') in DEVICE_CATS
                 and e.get('ph') == 'X' and e['ts'] >= t0)
    require(dev, 'the trace holds no device events')
    t1 = max(t1, dev[-1][1])
    busy, cur_start, cur_end = 0.0, None, None
    per_kernel = {}
    for start, end, cat, name in dev:
        if cat == 'kernel':
            entry = per_kernel.setdefault(name, [0.0, 0])
            entry[0] += (end - start) / 1e3
            entry[1] += 1
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    return (t1 - t0) / 1e3, busy / 1e3, per_kernel


# device_ms flushes the card's 50 MB L2 cache before each timed call by
# filling a buffer of this many bytes (the bound reads every input from
# device memory once); the fill's kernels are told apart by name
L2_FLUSH_BYTES = 256 << 20
FLUSH_KERNEL = 'FillFunctor'


def device_ms(fn, reps=10, warmup=2):
    """(device ms a call, device launches a call, recorded share) of
    `fn`: the kernels torch.profiler records over `reps` calls after a
    warm-up, the L2 cache flushed before each call. Per kernel name, its
    launches a call (the recorded count over `reps`, rounded: the trace
    can miss a few events) times its mean duration, summed over the
    names; the share is the events recorded over those expected."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES // 4, device='cuda')
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.fill_(0.0)
            fn()
        torch.cuda.synchronize()
    by_name = {}
    for _, dur, name in trace_kernels(prof):
        if FLUSH_KERNEL not in name:
            by_name.setdefault(name, []).append(dur)
    require(by_name, 'torch.profiler recorded no device kernel')
    per_call = {n: max(1, round(len(d) / reps)) for n, d in by_name.items()}
    ms = sum(float(np.mean(d)) * per_call[n]
             for n, d in by_name.items()) / 1e3
    launches = sum(per_call.values())
    return ms, launches, sum(map(len, by_name.values())) / (reps * launches)


def host_us(fn, reps=10, warmup=2):
    """Host microseconds a call of `fn`: the host clock around `reps`
    calls with no synchronization in between (the enqueue: checks,
    allocations, the launch)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def paired_ms(kernel_fn, plain_fn, reps=20, plain_reps=None):
    """(kernel ms, plain ms), measured in turns plain, kernel, kernel,
    plain and averaged per version."""
    plain_reps = reps if plain_reps is None else plain_reps
    p1 = cuda_ms(plain_fn, plain_reps, warmup=1)
    k1 = cuda_ms(kernel_fn, reps)
    k2 = cuda_ms(kernel_fn, reps)
    p2 = cuda_ms(plain_fn, plain_reps, warmup=1)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes, ops, ops_per_s=FP32_OPS_S):
    """(ms, what bounds it): the larger of the bytes the function must
    move over the memory rate and its operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return ((t_bytes, 'bytes') if t_bytes >= t_ops
            else (t_ops, 'operations'))


def entry(err, ms, plain_ms, bound_ms_by, library_ms=None):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                library_ms=library_ms)


def compact_cost(P, K, I, A, sums, live=None):
    """(bytes, operations) of one compact kernel call: each input read
    once, each output written once; the operations are the TPU kernels'
    own cost estimates (compact_obj.py pl.CostEstimate: flops, plus 3
    transcendentals per component and SNP, each counted as one FP32
    operation). live: None for the shared [P, I] natural mean, 'kdim'
    for [K, P, I], an int for the epoch state's live epochs."""
    ncol = P * (P + 1) // 2 + 1
    tables = 4 * K * (ncol + A)
    per_snp = 4 * (1 + 2 * P)                         # ann, dterm, nat
    if live == 'kdim':
        per_snp += 4 * (K - 1) * P
    elif live is not None:
        per_snp += 4 * live * P                       # live epochs
        tables += 4 * ((live + 1) * P + live)
    out = 4 * K * A if sums else 4 * 2 * P * I + 4
    if live is None or live == 'kdim':
        flops = (50 + 2 * A if sums else 60) * K * I
    else:
        flops = (20 * (live + 1) + (30 + 2 * A if sums else 40)) * K * I
    return tables + per_snp * I + out, flops + 3 * K * I


def split_cost(kind, P, K, I, A, live=None, M=2):
    """(bytes, operations) of one K-split kernel call over a slice of K
    components (compact_cost's counting): 'partial' the prologue partial
    (its [3 + 2P, I] accumulators out), 'norm' the sums' pass 1 ([2, I]
    out; the sums' z-only flops halved, two transcendentals per pair),
    'given' pass 2 (the M pass-1 partials [M, 2, I] in, whose normalizers
    it merges: one exponential per partial and SNP; [K, A] out), 'merge'
    the prologue's merge of M partials (one exponential per partial and
    SNP, bytes-bound)."""
    if kind == 'merge':
        rows = 3 + 2 * P
        return (4 * M * rows * I + 4 * I + 4 * 2 * P * I + 4,
                I * (M * (2 * rows + 3) + 4 * P + 8))
    nbytes, _ = compact_cost(P, K, I, A, sums=kind == 'given', live=live)
    if live is None or live == 'kdim':
        z = 25 * K * I
    else:
        z = (20 * (live + 1) + 15) * K * I
    if kind == 'partial':
        return (nbytes - 4 * 2 * P * I - 4 + 4 * (3 + 2 * P) * I,
                compact_cost(P, K, I, A, sums=False, live=live)[1])
    if kind == 'norm':
        return nbytes - 4 * 2 * P * I - 4 + 4 * 2 * I, z + 2 * K * I
    return (nbytes + 4 * M * 2 * I,
            z + 2 * A * K * I + 2 * K * I + I * (M * 4 + 2))


def max_err(got, want):
    """(max abs error, max abs error / max |want|)."""
    import torch
    got = got.double()
    want = want.double()
    err = float(torch.max(torch.abs(got - want)))
    scale = float(torch.max(torch.abs(want)))
    return err, err / scale if scale > 0 else err


# ---------------------------------------------------------------------------
# phase 3: kernel checks
# ---------------------------------------------------------------------------

def synthetic_covs(P, K, seed, lo=1e-6, hi=1e-2):
    """K mixture covariances with scales log-spaced over [lo, hi] and
    random correlations (vilma_tpu's synthetic_problem construction)."""
    rng = np.random.default_rng(seed)
    scales = np.exp(np.linspace(np.log(lo), np.log(hi), K))
    covs = []
    for k in range(K):
        a = rng.standard_normal((P, P))
        corr = 0.3 * (a @ a.T) + P * np.eye(P)
        dd = 1 / np.sqrt(np.diag(corr))
        covs.append(scales[k] * (corr * np.outer(dd, dd)))
    return np.array(covs)


def half_rounded_matvec(u, s, d, x, round_x):
    """The bf16-U product with only x (round_x) or only t rounded to
    bf16: what a kernel that skipped the other rounding would give."""
    import torch
    uf = u.float()
    xr = x.to(torch.bfloat16).float() if round_x else x
    t = torch.einsum('bpr,bcp->bcr', uf, xr) * s[:, None, :]
    if not round_x:
        t = t.to(torch.bfloat16).float()
    return torch.einsum('bpr,bcr->bcp', uf, t) + d[:, None, :] * x


def cublas_matvec(u, s, d, x):
    """y = U (s * (U^T x)) + d x by two torch.bmm calls on U's type."""
    import torch
    t = torch.bmm(x.to(u.dtype), u) * s[:, None, :]
    return (torch.bmm(t.to(u.dtype), u.transpose(1, 2)).float()
            + d[:, None, :] * x)


# the main path's bucket (977 blocks of 1024 SNPs at rank 512), and
# oversize ones for the group route (blocks of 2048 SNPs, too large for 16
# slices of shared memory): 128 blocks at rank 1024 in f32 (1.07 GB of U,
# the reported one), 128 at rank 512, a small bucket of 4 blocks (as
# per-block eigen-truncation leaves many), and 64 in bf16; and 8 blocks of
# 4096 SNPs at full rank in bf16, whose column slices do not fit twice (U
# read from device memory in both products, one block at a time)
MATVEC_SHAPE = (977, 1024, 512, 2)
GROUP_SHAPE = (128, 2048, 1024, 2)
# the matvec of the materialized phases: 4 and 8 traits on one panel per
# launch (the 1M bucket, and the 90K one of phases 13a and 13d; phase
# 13c's 4 blocks in f32 U), one cohort per panel (phase 13b's 4
# ancestries)
# (kernels-line key or None, U's type, (B, P, R, C), route, required no
# slower than cuBLAS in turns)
MATVEC_CASES = (
    ('bucket_matvec_multi', 'bfloat16', MATVEC_SHAPE, 'cluster', True),
    ('bucket_matvec_multi_f32', 'float32', MATVEC_SHAPE, 'cluster', False),
    ('bucket_matvec_multi_group', 'float32', GROUP_SHAPE, 'group', True),
    (None, 'float32', (128, 2048, 512, 2), 'group', True),
    (None, 'float32', (4, 2048, 1024, 2), 'group', False),
    ('bucket_matvec_multi_group_bf16', 'bfloat16', (64, 2048, 1024, 2),
     'group', True),
    (None, 'bfloat16', (8, 4096, 4096, 2), 'group', False),
    ('bucket_matvec_multi_c4', 'bfloat16', (977, 1024, 512, 4), 'cluster',
     False),
    ('bucket_matvec_multi_c8', 'bfloat16', (977, 1024, 512, 8), 'cluster',
     False),
    (None, 'bfloat16', (88, 1024, 512, 4), 'cluster', False),
    (None, 'bfloat16', (88, 1024, 512, 8), 'cluster', False),
    (None, 'bfloat16', (977, 1024, 512, 1), 'cluster', False),
    (None, 'float32', (4, 1024, 512, 4), 'cluster', False),
)


def matvec_plan(name):
    """The planner's route for a MATVEC_CASES entry, or for the backward
    (the forward's route at BACKWARD_SHAPE, bf16 U)."""
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    if name == 'bucket_matvec_multi_backward':
        dtype, (_, P, R, C) = 'bfloat16', BACKWARD_SHAPE
    else:
        _, dtype, (_, P, R, C), _, _ = next(c for c in MATVEC_CASES
                                            if c[0] == name)
    return bm.plan(P, R, 2 if dtype == 'bfloat16' else 4, C)


def check_matvec(device, results, bars=True):
    """The matvec's routes at their shapes (MATVEC_CASES): bf16 and f32 U
    at the main path's bucket (the cluster route), oversize buckets (the
    group route). Each against its plain version and its cuBLAS route
    (timed in turns with the kernel), with its bound. bars: require the
    cases' cuBLAS bars (--matvec-only prints them and goes on, so that a
    checkout whose kernel misses one is measured all the same)."""
    import torch
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    for key, dtype, (B, P, R, C), route, vs_cublas in MATVEC_CASES:
        bf16 = dtype == 'bfloat16'
        band = BAND_BF16 if bf16 else BAND_F32
        u, s, d, x = matvec_operands(device, dtype, B, P, R, C)
        pl = bm.plan(P, R, u.element_size(), C)
        require(pl.route == route,
                f'{key}: the planner chose the {pl.route} route')
        y = bm.bucket_matvec_multi(u, s, d, x)
        y2 = bm.bucket_matvec_multi(u, s, d, x)
        ref = bm.bucket_matvec_multi_plain(u, s, d, x)
        torch.cuda.synchronize()
        err, rel = max_err(y, ref)
        repeat = bool(torch.equal(y, y2))
        ms, plain_ms = paired_ms(
            lambda: bm.bucket_matvec_multi(u, s, d, x),
            lambda: bm.bucket_matvec_multi_plain(u, s, d, x))
        # the library yardstick: cuBLAS, two batched products (U's type,
        # f32 accumulation) plus the diagonal, in turns with the kernel
        k_ms, lib_ms = paired_ms(lambda: bm.bucket_matvec_multi(u, s, d, x),
                                 lambda: cublas_matvec(u, s, d, x), 10)
        ubytes = u.numel() * u.element_size()
        nbytes = ubytes + 4 * B * R + 4 * B * P + 2 * 4 * B * C * P
        b = bound(nbytes, 4 * B * P * R * C, BF16_OPS_S if bf16 else FP32_OPS_S)
        name = f'{key or "matvec"} u={dtype} B={B} P={P} R={R} C={C}'
        shape = (f'{pl.cluster} CTAs per cluster on {pl.panels(R)} '
                 f'panels of {pl.panel} columns'
                 if getattr(pl, 'panel', 0) else
                 f'{pl.cluster} CTAs per block')
        log(f'  {name}: {pl.route} route, {shape}, {pl.slots} ring '
            f'slot(s), {pl.smem} B of shared memory each; max_abs_err '
            f'{err:.3e} '
            f'scaled {rel:.3e} (band {band:.1e}) repeatable {repeat}; kernel '
            f'{ms:.4f} ms ({ubytes / ms / 1e6:.1f} GB/s of U), plain '
            f'{plain_ms:.4f} ms')
        log(f'    in turns with cuBLAS (2 torch.bmm + diagonal): kernel '
            f'{k_ms:.4f} ms, cuBLAS {lib_ms:.4f} ms (kernel/cuBLAS '
            f'{k_ms / lib_ms:.3f}, target <= 1); bound {b[0]:.4f} ms '
            f'({b[1]}), {b[0] / ms:.1%} of it reached')
        require(rel <= band, f'{name} outside its band')
        require(repeat, f'{name} not bit-for-bit repeatable')
        if bf16:
            # the rounding of x and of t both matter: the kernel must sit
            # closer to the plain version than a product missing either
            half = [max_err(half_rounded_matvec(u, s, d, x, rx), ref)[1]
                    for rx in (True, False)]
            log(f'    scaled error of the product rounding only x '
                f'{half[0]:.3e}, only t {half[1]:.3e}')
            require(rel < min(half), f'{name} is no closer to the plain '
                    'version than a product that skips a bf16 rounding')
        if vs_cublas and bars:
            # these routes read U once: they must not lose to the library,
            # which reads it twice
            require(k_ms <= lib_ms, f'{name}: {k_ms:.4f} ms, slower than '
                    f'cuBLAS ({lib_ms:.4f} ms) in turns')
        if key is not None:
            results[key] = entry(err, ms, plain_ms, b, lib_ms)
        del u, x, s, d, y, y2, ref
        torch.cuda.empty_cache()


def matvec_operands(device, dtype, B, P, R, C, seed=3):
    """u [B, P, R] of U's type, s, d, x f32, from a seeded generator on the
    card."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(B, C, P, generator=gen, device=device)
    s = torch.rand(B, R, generator=gen, device=device) * 1.9 + 0.1
    d = torch.rand(B, P, generator=gen, device=device)
    u = (torch.randn(B, P, R, generator=gen, device=device)
         / math.sqrt(P)).to(getattr(torch, dtype))
    return u, s, d, x


# cycles of torch.cuda._sleep before each call flushed_ms times (~0.1 ms
# at the H100's ~2 GHz): the card stays busy while the host enqueues the
# call, so that the events time the device alone
SLEEP_CYCLES = 200_000


def flushed_ms(fn, reps=5, warmup=2):
    """Mean ms a call of `fn` from CUDA events around each call, the L2
    cache flushed before each (a bucket's U arrives cold, as in a step)
    and the card kept busy past the host's enqueue (SLEEP_CYCLES)."""
    import torch
    flush = torch.empty(L2_FLUSH_BYTES // 4, device='cuda')
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(reps):
        torch.cuda._sleep(SLEEP_CYCLES)
        flush.fill_(0.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.mean([a.elapsed_time(b) for a, b in pairs]))


# the group route's B-sweep: (U's type, P, R, bucket sizes B), 2 cohorts
SWEEP_CASES = (
    ('float32', 2048, 1024, (1, 2, 4, 8, 16, 32, 64, 128)),
    ('bfloat16', 2048, 1024, (1, 2, 4, 8, 16, 32, 64, 128)),
    ('bfloat16', 4096, 4096, (1, 2, 4, 8)),
)


def group_sweep(device, cases=SWEEP_CASES):
    """The group route's time against the bucket size B: ms a call at each
    B (flushed_ms), and the least-squares line over B, whose slope is the
    us a block and whose intercept the us a launch. Returns {(dtype, P,
    R): (slope us, intercept us, {B: ms})}."""
    import torch
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    out = {}
    for dtype, P, R, sizes in cases:
        u, s, d, x = matvec_operands(device, dtype, max(sizes), P, R, 2)
        ms = {B: flushed_ms(lambda B=B: bm.bucket_matvec_multi(
            u[:B], s[:B], d[:B], x[:B])) for B in sizes}
        slope, icpt = np.polyfit(list(ms), [1e3 * v for v in ms.values()], 1)
        out[(dtype, P, R)] = (float(slope), float(icpt), ms)
        log(f'  group-route B-sweep u={dtype} P={P} R={R} C=2 (L2 flushed): '
            + ', '.join(f'B={B} {v:.4f} ms ({1e3 * v / B:.2f} us/block)'
                        for B, v in ms.items())
            + f'; fit {slope:.3f} us a block + {icpt:.2f} us a launch')
        del u, s, d, x
        torch.cuda.empty_cache()
    return out


# buckets whose group-route launch is split into phases by the stamps
STAMP_CASES = (
    ('float32', (128, 2048, 1024, 2)),
    ('bfloat16', (64, 2048, 1024, 2)),
    ('bfloat16', (8, 4096, 4096, 2)),
)
STAMP_CAP = 4096
# phase 2 starts the measurement build beside the main one (a thread
# running its nvcc); group_stamps waits for it
STAMPS_BUILD = []


def group_stamps(device, cases=STAMP_CASES):
    """Where one work item's time goes on the group route: the
    measurement build (build.library('stamps'), the same source with
    -DVILMA_MATVEC_STAMPS) records, in CTA 0, clock64 at the kernel's
    stamp points of each item (an LD block's panel) it works on, and
    %globaltimer at the first. Prints each point's mean offset from the
    item's first stamp (us, clock64 over the SM clock the two timers give)
    over the items but the first and last, and the mean period between
    items; the stamped launch's output must equal the main library's bit
    for bit. Returns {(dtype, B, P, R): (period us, {point: us})}."""
    import torch
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    from vilma_tpu_torch.ops.cuda import build
    if 'stamps' not in getattr(build, 'VARIANTS', {}):
        log('  group-route phase stamps: no measurement build here')
        return {}
    for thread in STAMPS_BUILD:
        thread.join()
    lib = build.library('stamps')
    names = lib.vilma_block_matvec_stamp_points().decode().split(',')
    flush = torch.empty(L2_FLUSH_BYTES // 4, device='cuda')
    buf = torch.zeros(STAMP_CAP * len(names) * 2, dtype=torch.int64,
                      device=device)
    build.check(lib.vilma_block_matvec_stamps(buf.data_ptr(), STAMP_CAP),
                'vilma_block_matvec_stamps')
    out = {}
    try:
        for dtype, (B, P, R, C) in cases:
            u, s, d, x = matvec_operands(device, dtype, B, P, R, C)
            want = bm._launch(u, s, d, x)
            bm._launch(u, s, d, x, lib=lib)
            torch.cuda.synchronize()
            buf.zero_()
            flush.fill_(0.0)
            got = bm._launch(u, s, d, x, lib=lib)
            torch.cuda.synchronize()
            require(torch.equal(got, want), f'the stamped group route at '
                    f'u={dtype} B={B} P={P} R={R} differs from the main one')
            st = buf.view(STAMP_CAP, len(names), 2).cpu().numpy()
            n = int(np.count_nonzero(st[:, 0, 1]))
            require(n > 0, 'the stamped group route recorded no stamp')
            st = st[:n].astype(np.float64)
            mid = slice(1, n - 1) if n > 3 else slice(0, n)
            # clock64 at every point, %globaltimer at the first: the SM
            # clock is their ratio over CTA 0's blocks
            clk = st[:, :, 1] - st[:, :1, 1]
            span = st[-1, 0, 1] - st[0, 0, 1]
            ghz = span / (st[-1, 0, 0] - st[0, 0, 0]) if span else 0.0
            period = float(np.mean(np.diff(st[:, 0, 0]))) / 1e3 if n > 1 \
                else 0.0
            points = {}
            for k, name in enumerate(names):
                hit = st[mid, k, 1] > 0
                if hit.any() and ghz:
                    points[name] = float(np.mean(clk[mid, k][hit])) / ghz / 1e3
            out[(dtype, B, P, R)] = (period, points)
            log(f'  group-route stamps u={dtype} B={B} P={P} R={R} C={C}: '
                f'CTA 0 took {n} panels, one every {period:.3f} us (SM '
                f'clock {ghz:.3f} GHz); offsets from the panel\'s start, us: '
                + ', '.join(f'{k} {a:.3f}' for k, a in points.items()))
            del u, s, d, x, want, got
            torch.cuda.empty_cache()
    finally:
        lib.vilma_block_matvec_stamps(None, 0)
    return out


# the matvec's backward (phase 14d): the forward's kernel on the
# incoming gradient, at phase 4's bucket (88 blocks of 1024 SNPs at rank
# 512, bf16 U, 2 cohorts)
BACKWARD_SHAPE = (88, 1024, 512, 2)


def check_matvec_backward(device, results):
    """The matvec under autograd: the gradient with respect to x is the
    forward's kernel on the incoming gradient g, held against its plain
    version (the plain matvec on g) within the bf16 band and closer to it
    than a product skipping a rounding; timed through torch.autograd.grad
    against the plain version's own autograd, in turns, and the
    backward's launch beside the plain matvec on g and cuBLAS on g. The
    gap to the plain version's autograd, whose backward rounds at other
    places, is logged."""
    import torch
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    B, P, R, C = BACKWARD_SHAPE
    gen = torch.Generator(device=device).manual_seed(4)
    x = torch.randn(B, C, P, generator=gen, device=device)
    g = torch.randn(B, C, P, generator=gen, device=device)
    s = torch.rand(B, R, generator=gen, device=device) * 1.9 + 0.1
    d = torch.rand(B, P, generator=gen, device=device)
    u = (torch.randn(B, P, R, generator=gen, device=device)
         / math.sqrt(P)).to(torch.bfloat16)
    x.requires_grad_(True)
    y = bm.bucket_matvec_multi(u, s, d, x)
    y_plain = bm.bucket_matvec_multi_plain(u, s, d, x)

    def kernel():
        return torch.autograd.grad(y, x, g, retain_graph=True)[0]

    def plain():
        return torch.autograd.grad(y_plain, x, g, retain_graph=True)[0]

    before = bm.launches_backward
    got, again = kernel(), kernel()
    torch.cuda.synchronize()
    require(bm.launches_backward == before + 2,
            'the backward did not launch the kernel once a call')
    with torch.no_grad():
        ref = bm.bucket_matvec_multi_plain(u, s, d, g)
        err, rel = max_err(got, ref)
        auto = max_err(plain(), ref)[1]
        half = [max_err(half_rounded_matvec(u, s, d, g, rx), ref)[1]
                for rx in (True, False)]
    repeat = bool(torch.equal(got, again))
    # the backward's launch as autograd makes it, against the function it
    # computes (the plain matvec on g) and cuBLAS on g; then the whole
    # torch.autograd.grad call of each version, host overhead included
    count = bm.launches_backward

    def launch():
        return bm._launch(u, s, d, g, backward=True)

    ms, plain_ms = paired_ms(launch, lambda: bm.bucket_matvec_multi_plain(
        u, s, d, g))
    k_ms, lib_ms = paired_ms(launch, lambda: cublas_matvec(u, s, d, g), 10)
    grad_ms, plain_grad_ms = paired_ms(kernel, plain)
    with torch.no_grad():
        fwd_ms, bwd_ms = paired_ms(
            lambda: bm.bucket_matvec_multi(u, s, d, x), launch)
    bm.launches_backward = count
    ubytes = u.numel() * u.element_size()
    b = bound(ubytes + 4 * B * R + 4 * B * P + 2 * 4 * B * C * P,
              4 * B * P * R * C, BF16_OPS_S)
    log(f'  matvec backward u=bfloat16 B={B} P={P} R={R} C={C}: scaled '
        f'error {rel:.3e} of the plain matvec on g (band {BAND_BF16:.1e}; '
        f'products rounding only g {half[0]:.3e}, only t {half[1]:.3e}; '
        f'the plain version\'s own autograd {auto:.3e}) repeatable '
        f'{repeat}; the backward\'s launch {ms:.4f} ms, the plain matvec '
        f'on g {plain_ms:.4f} ms; in turns with cuBLAS on g {k_ms:.4f} vs '
        f'{lib_ms:.4f} ms; in turns with the forward on x {bwd_ms:.4f} vs '
        f'{fwd_ms:.4f} ms; bound {b[0]:.4f} ms ({b[1]}); a whole '
        f'torch.autograd.grad call {grad_ms:.4f} ms, the plain version\'s '
        f'{plain_grad_ms:.4f} ms')
    require(rel <= BAND_BF16, 'the matvec backward outside its band')
    require(rel < min(half), 'the matvec backward is no closer to the plain '
            'version than a product that skips a bf16 rounding')
    require(repeat, 'the matvec backward is not bit-for-bit repeatable')
    results['bucket_matvec_multi_backward'] = entry(err, ms, plain_ms, b,
                                                    lib_ms)
    del u, x, g, y, y_plain
    torch.cuda.empty_cache()


def print_kernel_resources():
    """Each kernel's cluster size and what ptxas reported for its
    main-path instantiation (registers, static shared memory, spills).
    A diagnostic: an entry it cannot match fails nothing."""
    import re
    from vilma_tpu_torch.ops.cuda import build
    if not build.ptxas_report:
        log('  ptxas report: not available (the library was built earlier)')
        return
    found = build.kernel_resources(build.ptxas_report)
    for name, meta in KERNELS.items():
        cluster = (matvec_plan(name).cluster if name.startswith('bucket')
                   else 1)
        hits = [(k, v) for k, v in found.items()
                if re.search(meta['ptxas'], k.replace('false', '(bool)0')
                             .replace('true', '(bool)1'))]
        if not hits:
            # a diagnostic: mangled names (no cu++filt) match no pattern
            log(f'  {name}: cluster {cluster}; no ptxas entry matched '
                '(names not demangled: no cu++filt beside nvcc?)')
        for k, v in hits:
            short = re.search(r'(\w+<.*?>)\(', k.replace('<unnamed>::', '')
                              .replace('(anonymous namespace)::', ''))
            log(f'  {name}: cluster {cluster}; '
                f'{short.group(1) if short else k}: {v.get("registers")} '
                f'registers, {v.get("smem")} B static shared memory, '
                f'{v.get("stack")} B stack, spills {v.get("spill_stores")}/'
                f'{v.get("spill_loads")} B (stores/loads)'
                + (f'; {meta["note"]}' if 'note' in meta else ''))


def compact_inputs(device, P, K, I, A, seed, clamp_heavy=False):
    """Compact-kernel operands. clamp_heavy: most components of most SNPs
    sit beyond the f32 clamp (69 nats below the largest logit): variances
    1e-8..1, natural means at z-scores up to 1.5 (~100x the ordinary
    ones), and hyper-deltas of e^-600..e^-80 on ~80% of the components, as
    a converged fit leaves the components it does not use. (Larger means
    make post_vars = E[y^2] - pm^2 cancel in f32, in the kernel and the
    plain version alike.)"""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    rng = np.random.default_rng(seed)
    covs = synthetic_covs(P, K, seed, *((1e-8, 1.0) if clamp_heavy
                                        else (1e-6, 1e-2)))
    prec = np.linalg.inv(covs)
    log_det = np.linalg.slogdet(covs)[1]
    hd = rng.uniform(0.1, 1.0, (A, K))
    hd /= hd.sum(axis=1, keepdims=True)
    log_hd = np.log(hd)
    if clamp_heavy:
        unused = rng.random((A, K)) < 0.8
        log_hd[unused] = rng.uniform(-600, -80, unused.sum())
    ann = rng.integers(0, A, I).astype(np.int32)
    ann[rng.random(I) < 0.01] = A                      # ~1% pad SNPs
    dterm = 1.0 / rng.uniform(0.01, 0.05, (P, I)) ** 2
    if clamp_heavy:
        nat = rng.uniform(-1.5, 1.5, (P, I)) * np.sqrt(dterm)
    else:
        nat = rng.standard_normal((P, I)) * 0.5

    def f32(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32, device=device)

    coeffs = co.build_coeffs(f32(prec), f32(log_det)).contiguous()
    scores_t = f32((log_hd - 0.5 * log_det).T)
    return (coeffs, scores_t, torch.as_tensor(ann, device=device),
            f32(dterm), f32(nat))


def check_compact(device, results, I=1_000_000, A=4):
    """The shared [P, I] natural mean at P = 1..3, K = 18 and 582; the
    reported shape is P = 2, K = 582. Returns its (prologue, sums) kernel
    ms."""
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    reported = None
    for P in (1, 2, 3):
        for K in (18, 582):
            kw = dict(zip(('coeffs', 'scores_t', 'annotations', 'dterm',
                           'nat_mu'),
                          compact_inputs(device, P, K, I, A,
                                         seed=10 * P + K)),
                      num_annotations=A)
            main = (P, K) == (2, 582)
            ms = check_pair(f'[P, I] P={P} K={K} I={I} A={A}',
                            ('prologue', 'delta_sums') if main else None,
                            results, (co.prologue, co.delta_sums),
                            (co.prologue_plain, co.delta_sums_plain), kw,
                            lambda sums: compact_cost(P, K, I, A, sums))
            if main:
                reported = ms
    # K·A past one shared-memory group: the sums take K in groups
    K = 14_000
    kt, kg, _ = co._launch_shape(100_000, K, A, 4, sums=True)
    kw = dict(zip(('coeffs', 'scores_t', 'annotations', 'dterm', 'nat_mu'),
                  compact_inputs(device, 2, K, 100_000, A, seed=K)),
              num_annotations=A)
    check_pair(f'[P, I] P=2 K={K} I=100000 A={A} ({-(-K // kg)} component '
               f'groups of {kg})', None, results,
               (co.prologue, co.delta_sums),
               (co.prologue_plain, co.delta_sums_plain), kw,
               lambda sums: compact_cost(2, K, 100_000, A, sums), timed=False)
    require(kg < K, f'K = {K}, A = {A} fit one group ({kg})')
    return reported


def check_pair(name, key, results, run, plain, kw, cost, reps=10,
               plain_reps=2, timed=True):
    """One prologue/sums pair of a state form against its plain
    versions: bands, repeatability, times (unless not `timed`), bound.
    `run` and `plain` are (prologue, delta_sums) callables taking **kw.
    Returns the (prologue, sums) kernel ms."""
    import torch
    pm, pv, kl = run[0](**kw)
    pm2, pv2, kl2 = run[0](**kw)
    rpm, rpv, rkl = plain[0](**kw)
    s, s2, rs = run[1](**kw), run[1](**kw), plain[1](**kw)
    torch.cuda.synchronize()
    e_pm, r_pm = max_err(pm, rpm)
    e_pv, r_pv = max_err(pv, rpv)
    e_kl, r_kl = max_err(kl, rkl)
    e_s, r_s = max_err(s, rs)
    rep = bool(torch.equal(pm, pm2) and torch.equal(pv, pv2)
               and torch.equal(kl, kl2) and torch.equal(s, s2))
    times = [paired_ms(lambda: run[j](**kw), lambda: plain[j](**kw), reps,
                       plain_reps) if timed else (math.nan, math.nan)
             for j in (0, 1)]
    log(f'  {name}: pm {e_pm:.3e} ({r_pm:.3e}) pv {e_pv:.3e} ({r_pv:.3e}) '
        f'kl {e_kl:.3e} ({r_kl:.3e}) sums {e_s:.3e} ({r_s:.3e}); bands '
        f'{BAND_F32:.0e}/{BAND_KL:.0e}; repeatable {rep}'
        + (f'; prologue {times[0][0]:.4f} ms (plain {times[0][1]:.4f}), '
           f'sums {times[1][0]:.4f} ms (plain {times[1][1]:.4f}), '
           f'sums/prologue {times[1][0] / times[0][0]:.3f}' if timed
           else ''))
    require(max(r_pm, r_pv, r_s) <= BAND_F32 and r_kl <= BAND_KL,
            f'{name} outside its band')
    require(rep, f'{name} not bit-for-bit repeatable')
    if timed:
        names = key or ('prologue', 'sums')
        for j, sums in enumerate((False, True)):
            b = bound(*cost(sums))
            if key is not None:
                results[names[j]] = entry(e_s if sums else max(e_pm, e_pv),
                                          times[j][0], times[j][1], b)
            log(f'    {names[j]}: bound {b[0]:.4f} ms ({b[1]}), '
                f'{b[0] / times[j][0]:.1%} of it reached')
    return times[0][0], times[1][0]


KDIM_SHAPES = ((2, 582, 90_112), (2, 18, 1_000_000), (1, 582, 90_112),
               (3, 582, 90_112))
# (P, K, I, live epochs, clamp-heavy input, timed): the first is phase 7's
# shape, the one reported; phase 7 itself runs with 1 live epoch
EPOCH_CASES = ((2, 582, 1_000_000, 2, False, True),
               (2, 582, 1_000_000, 1, False, True),
               (1, 582, 90_112, 2, False, True),
               (3, 582, 90_112, 2, False, True),
               (2, 582, 1_000_000, 2, True, False),
               (1, 582, 90_112, 2, True, False),
               (3, 582, 90_112, 2, True, False))


def check_kdim(device, results, A=4, shapes=KDIM_SHAPES):
    """The per-component [K, P, I] natural mean at (P, K, I) shapes: the
    first is the per-chromosome shape of phase 6, the one reported.
    Returns its (prologue, sums) kernel ms."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    reported = None
    for P, K, I in shapes:
        coeffs, scores_t, ann, dterm, _ = compact_inputs(device, P, K, I, A,
                                                         seed=7 * P + K)
        gen = torch.Generator(device=device).manual_seed(P * K)
        kw = dict(coeffs=coeffs, scores_t=scores_t, annotations=ann,
                  dterm=dterm, num_annotations=A,
                  nat_mu=torch.randn(K, P, I, generator=gen,
                                     device=device) * 0.5)
        main = (P, K, I) == shapes[0]
        ms = check_pair(f'kdim P={P} K={K} I={I} A={A}',
                        ('prologue_kdim', 'delta_sums_kdim') if main
                        else None, results, (co.prologue, co.delta_sums),
                        (co.prologue_plain, co.delta_sums_plain), kw,
                        lambda sums: compact_cost(P, K, I, A, sums, 'kdim'))
        if main:
            reported = ms
        del kw
    return reported


def check_epochs(device, results, A=4, B=4, cases=EPOCH_CASES):
    """The epoch-history state with `live` of B slots live (EPOCH_CASES).
    On the clamp-heavy inputs the share of (SNP, component) pairs the
    plain version clamps, over the first 20,000 SNPs, must pass one half.
    Returns {(P, I, live): (prologue, sums) kernel ms} of the timed
    ordinary cases."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    from vilma_tpu_torch.utils.config import epsilon
    times = {}
    for P, K, I, live, clamp_heavy, timed in cases:
        coeffs, scores_t, ann, sld, u = compact_inputs(
            device, P, K, I, A, seed=11 * P + K, clamp_heavy=clamp_heavy)
        rng = np.random.default_rng(P)
        gen = torch.Generator(device=device).manual_seed(P + K)
        hist = torch.zeros(B, P, I, device=device)
        hist[:live] = torch.randn(live, P, I, generator=gen,
                                  device=device) * (
            0.5 * torch.sqrt(sld) if clamp_heavy else 0.5)
        isc = np.ones((B + 1, P))
        isc[:live + 1] = 1 / rng.uniform(0.7, 1.4, (live + 1, P))
        hc = np.zeros(B)
        hc[:live] = rng.uniform(0.1, 1.0, live)
        kw = dict(coeffs=coeffs, scores_t=scores_t, annotations=ann,
                  sld=sld, nat_u=u, hist_v=hist,
                  inv_scales=torch.as_tensor(isc, dtype=torch.float32,
                                             device=device),
                  hist_c=torch.as_tensor(hc, dtype=torch.float32,
                                         device=device),
                  num_annotations=A, num_live=live)
        name = (f'epochs P={P} K={K} I={I} A={A} B={B} live={live}'
                + (' clamp-heavy' if clamp_heavy else ''))
        if clamp_heavy:
            log_vd = co._epoch_deriver(
                coeffs, scores_t, ann, sld, u, hist, kw['inv_scales'],
                kw['hist_c'], live)(0, 20_000)['log_vd']
            share = float((log_vd <= math.log(epsilon(torch.float32))
                           ).float().mean())
            log(f'  {name}: {share:.3f} of (SNP, component) pairs clamped')
            require(share > 0.5, f'{name}: only {share:.3f} clamped')
        main = not times
        # the plain version loops over every slot: the inert ones add
        # exact zeros, so the kernel's live-only loop must agree with it
        plain = (lambda **k: co.prologue_epochs_plain(
                     **dict(k, num_live=None)),
                 lambda **k: co.delta_sums_epochs_plain(
                     **dict(k, num_live=None)))
        ms = check_pair(name, ('prologue_epochs', 'delta_sums_epochs')
                        if main else None, results,
                        (co.prologue_epochs, co.delta_sums_epochs), plain,
                        kw, lambda sums: compact_cost(P, K, I, A, sums, live),
                        timed=timed)
        if timed and not clamp_heavy:
            times[(P, I, live)] = ms
        del hist, kw
    return times


# (form, P, K of the grid, I, live epochs): phase 16's shapes at comp = 2
# (K = 291 a slice): 16a's shared state and kdim state on a snp span of
# phase 4's 90,112 variants (45,056 slots), 16d's epoch state at 1M SNPs
SPLIT_SHAPES = (('shared', 2, 582, 45_056, None),
                ('kdim', 2, 582, 45_056, 'kdim'),
                ('epochs', 2, 582, 1_000_448, 1))


def split_operands(device, form, P, K, I, A, live, B=4):
    """Whole-K operands of a form's kernels (keyword arguments)."""
    import torch
    coeffs, scores_t, ann, dterm, nat = compact_inputs(device, P, K, I, A,
                                                       seed=5 * P + K + I)
    kw = dict(coeffs=coeffs, scores_t=scores_t, annotations=ann,
              num_annotations=A)
    gen = torch.Generator(device=device).manual_seed(K + I)
    if form == 'shared':
        return dict(kw, dterm=dterm, nat_mu=nat)
    if form == 'kdim':
        return dict(kw, dterm=dterm, nat_mu=torch.randn(
            K, P, I, generator=gen, device=device) * 0.5)
    rng = np.random.default_rng(P + live)
    hist = torch.zeros(B, P, I, device=device)
    hist[:live] = torch.randn(live, P, I, generator=gen,
                              device=device) * 0.5
    isc = np.ones((B + 1, P))
    isc[:live + 1] = 1 / rng.uniform(0.7, 1.4, (live + 1, P))
    hc = np.zeros(B)
    hc[:live] = rng.uniform(0.1, 1.0, live)
    return dict(kw, sld=dterm, nat_u=nat, hist_v=hist,
                inv_scales=torch.as_tensor(isc, dtype=torch.float32,
                                           device=device),
                hist_c=torch.as_tensor(hc, dtype=torch.float32,
                                       device=device), num_live=live)


def split_fns(form):
    """(whole prologue, whole sums, partial, pass 1, pass 2) kernels and
    their plain versions of a form."""
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    if form == 'epochs':
        names = ('prologue_epochs', 'delta_sums_epochs',
                 'prologue_epochs_partial', 'delta_norm_epochs',
                 'delta_sums_epochs_given')
    else:
        names = ('prologue', 'delta_sums', 'prologue_partial', 'delta_norm',
                 'delta_sums_given')
    return ([getattr(co, n) for n in names],
            [getattr(co, n + '_plain') for n in names])


def slice_kw(kw, ks):
    """The operands of the components `ks`: their coefficient and score
    rows, and a kdim natural mean's rows."""
    out = dict(kw, coeffs=kw['coeffs'][ks].contiguous(),
               scores_t=kw['scores_t'][ks].contiguous())
    if 'nat_mu' in kw and kw['nat_mu'].dim() == 3:
        out['nat_mu'] = kw['nat_mu'][ks].contiguous()
    return out


def run_split(kw, fns, M):
    """(pm, pv, kl, [A, K] sums, prologue partials, pass-1 partials) of
    the K-split path over M comp slices: partials, their merge, pass 1,
    pass 2 given the stacked pass-1 partials (kernels or plain versions,
    `fns` as split_fns gives them)."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    from vilma_tpu_torch.parallel.mesh import k_slices
    plain = fns[0] is co.prologue_plain or fns[0] is co.prologue_epochs_plain
    merge = co.prologue_merge_plain if plain else co.prologue_merge
    kss = [slice(a, b) for a, b in k_slices(kw['scores_t'].shape[0], M)]
    accs = torch.stack([fns[2](**slice_kw(kw, ks)) for ks in kss])
    pm, pv, kl = merge(accs, kw['annotations'],
                       num_annotations=kw['num_annotations'])
    parts = torch.stack([fns[3](**slice_kw(kw, ks)) for ks in kss])
    sums = torch.cat([fns[4](**slice_kw(kw, ks), parts=parts)
                      for ks in kss], dim=1)
    return pm, pv, kl, sums, accs, parts


def check_split(device, results, A=4, M=2, shapes=SPLIT_SHAPES, timed=True):
    """The K-split kernels (component sharding) at phase 16's shapes
    (SPLIT_SHAPES), each against its plain version on the same inputs and
    repeatable bit for bit: the partial (both sides finished alone by the
    plain merge), pass 1, pass 2 given the kernels' stacked pass-1
    partials, the merge on the kernels' partials; then the whole split
    path of kernels against the whole-K kernels and the whole-K plain
    versions (BAND_F32, BAND_KL). Times the slice-0 call of each kernel
    beside its plain version (CUDA events), its device time and launches
    (torch.profiler) and its host time a call; the merge must make one
    device launch a call."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    from vilma_tpu_torch.parallel.mesh import k_slices
    for form, P, K, I, live in shapes:
        kw = split_operands(device, form, P, K, I, A, live)
        kern, plain = split_fns(form)
        got = run_split(kw, kern, M)
        again = run_split(kw, kern, M)
        want = run_split(kw, plain, M)
        rep = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        whole = kern[0](**kw) + (kern[1](**kw),)
        wplain = plain[0](**kw) + (plain[1](**kw),)
        torch.cuda.synchronize()
        errs = {}
        for tag, ref in (('whole kernel', whole), ('whole plain', wplain),
                         ('split plain', want)):
            errs[tag] = [max_err(a, b)[1] for a, b in zip(got[:4], ref)]
        ks = slice(*k_slices(K, M)[0])
        kw0 = slice_kw(kw, ks)
        Kc = ks.stop - ks.start
        finish = co.prologue_merge_plain
        acc_k, acc_p = kern[2](**kw0), plain[2](**kw0)
        per = {
            'partial': [max_err(a, b) for a, b in zip(
                finish(acc_k[None], kw['annotations'], num_annotations=A),
                finish(acc_p[None], kw['annotations'], num_annotations=A))],
            'norm': [max_err(kern[3](**kw0), plain[3](**kw0))],
            'given': [max_err(kern[4](**kw0, parts=got[5]),
                              plain[4](**kw0, parts=got[5]))],
            'merge': [max_err(a, b) for a, b in zip(
                co.prologue_merge(got[4], kw['annotations'],
                                  num_annotations=A),
                co.prologue_merge_plain(got[4], kw['annotations'],
                                        num_annotations=A))]}
        name = f'K-split {form} P={P} K={K} ({M} slices of {Kc}) I={I}'
        log(f'  {name}: split path of kernels vs ' + '; '.join(
            f'{t} (pm, pv, kl, sums) {[float(f"{e:.2e}") for e in v]}'
            for t, v in errs.items()) + f'; repeatable {rep}')
        for t, v in errs.items():
            require(max(v[0], v[1], v[3]) <= BAND_F32 and v[2] <= BAND_KL,
                    f'{name}: against the {t} outside the band: {v}')
        require(rep, f'{name}: not bit-for-bit repeatable')
        keys = dict(zip(('partial', 'norm', 'given'), SPLIT_KEYS[form]))
        # the merges: reported at the shared shape, also timed at the epoch
        # shape's I (1,000,448 SNPs), where their bytes matter
        if form in ('shared', 'epochs') and timed:
            keys.update(merge='prologue_merge')
        runs = {
            'partial': ((lambda: kern[2](**kw0)), (lambda: plain[2](**kw0)),
                        split_cost('partial', P, Kc, I, A, live)),
            'norm': ((lambda: kern[3](**kw0)), (lambda: plain[3](**kw0)),
                     split_cost('norm', P, Kc, I, A, live)),
            'given': ((lambda: kern[4](**kw0, parts=got[5])),
                      (lambda: plain[4](**kw0, parts=got[5])),
                      split_cost('given', P, Kc, I, A, live, M=M)),
            'merge': ((lambda: co.prologue_merge(
                got[4], kw['annotations'], num_annotations=A)),
                (lambda: co.prologue_merge_plain(
                    got[4], kw['annotations'], num_annotations=A)),
                split_cost('merge', P, Kc, I, A, M=M))}
        for kind, key in keys.items():
            # (pm, pv, kl) of the prologue's two; one result elsewhere
            bands = (BAND_F32, BAND_F32, BAND_KL)
            rel = max(e[1] for e in per[kind])
            require(all(e[1] <= band for e, band in zip(per[kind], bands)),
                    f'{name}: {kind} kernel {per[kind]} (abs, of scale) '
                    f'from its plain version (bands {bands})')
            if not timed:
                log(f'    {key}: {rel:.2e} of scale from plain')
                continue
            run, ref, cost = runs[kind]
            ms, plain_ms = paired_ms(run, ref, reps=10, plain_reps=2)
            dev_ms, dev_n, seen = device_ms(run)
            host = host_us(run)
            require(kind != 'merge' or dev_n == 1,
                    f'{name}: the merge made {dev_n} device launches a '
                    'call (one expected)')
            b = bound(*cost)
            if key not in results:
                results[key] = entry(max(e[0] for e in per[kind]), ms,
                                     plain_ms, b)
            log(f'    {key}: {rel:.2e} of scale from plain; {ms:.4f} ms '
                f'(plain {plain_ms:.4f}); bound {b[0]:.4f} ms ({b[1]}), '
                f'{b[0] / ms:.1%} of it reached; device {dev_ms:.4f} ms a '
                f'call in {dev_n} launches ({b[0] / dev_ms:.1%} of the '
                f'bound; {seen:.0%} of the events recorded), host '
                f'{host:.1f} us a call')
        del kw, got, again, want, whole, wplain
        torch.cuda.empty_cache()


def check_bars(shared_ms, kdim_ms, epoch_ms):
    """The redesigned compact kernels, all timed in this run. At 1M SNPs,
    P = 2, K = 582, 1 live epoch: the epoch sums' two z-only passes at
    most 2.0x the epoch prologue's one full pass, the [P, I] prologue (the
    same pass with less algebra) no slower, and the [P, I] sums (two
    z-only passes) at most 2.0x the [P, I] prologue. At 90,112 SNPs the
    kdim sums at most 2.0x the kdim prologue."""
    pro, sums = epoch_ms[(2, 1_000_000, 1)]
    ratios = (('epoch sums / epoch prologue (1 live)', sums / pro, 2.0),
              ('[P, I] prologue / epoch prologue', shared_ms[0] / pro, 1.0),
              ('[P, I] sums / [P, I] prologue', shared_ms[1] / shared_ms[0],
               2.0),
              ('kdim sums / kdim prologue (90K)', kdim_ms[1] / kdim_ms[0],
               2.0))
    log('  bars: ' + '; '.join(f'{name} {r:.3f} (target <= {cap})'
                               for name, r, cap in ratios))
    for name, r, cap in ratios:
        require(r <= cap, f'{name} is {r:.3f} (target <= {cap})')


# ---------------------------------------------------------------------------
# phase 4: CLI fit on an on-disk schema
# ---------------------------------------------------------------------------

def ar1_factors(sizes, rhos, rank_frac, device='cpu'):
    """[(U, s)]: the top size * rank_frac eigenpairs (float64 numpy) of
    each AR(1) correlation block, on the host block by block, or on a
    CUDA device by batched float64 eigh of the blocks of one size."""
    out = [None] * len(sizes)
    if device == 'cpu':
        for b, (n, rho) in enumerate(zip(sizes, rhos)):
            idx = np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
            vals, vecs = np.linalg.eigh(rho ** idx)
            rank = int(n * rank_frac)
            out[b] = vecs[:, -rank:], vals[-rank:]
        return out
    import torch
    for n in sorted(set(sizes)):
        which = [b for b, size in enumerate(sizes) if size == n]
        idx = torch.arange(n, device=device)
        lag = (idx[:, None] - idx[None, :]).abs().double()
        rank = int(n * rank_frac)
        for c0 in range(0, len(which), 64):
            chunk = which[c0:c0 + 64]
            rho = torch.as_tensor([rhos[b] for b in chunk],
                                  dtype=torch.float64, device=device)
            vals, vecs = torch.linalg.eigh(rho[:, None, None] ** lag[None])
            vals = vals[:, -rank:].cpu().numpy()
            vecs = vecs[:, :, -rank:].cpu().numpy()
            for j, b in enumerate(chunk):
                out[b] = vecs[j], vals[j]
    return out


def write_schema(out_dir, num_blocks, block_size=1024, rank_frac=0.5,
                 num_pops=2, seed=1, block_sizes=None, device='cpu'):
    """Stacked-eigendecomposition .npy + .var blocks, a .schema manifest,
    one sumstats TSV per cohort and an extract list (the layout
    tools/export_synthetic_schema.py writes): `num_blocks` blocks of
    `block_size` SNPs, or one block per entry of `block_sizes`, factored
    on `device` (ar1_factors). Returns the paths."""
    rng = np.random.default_rng(seed)
    sizes = block_sizes or [block_size] * num_blocks
    n = sum(sizes)
    ids = [f'snp{i}' for i in range(n)]
    manifest = []
    start = 0
    factors = ar1_factors(sizes, [rng.uniform(0.3, 0.95) for _ in sizes],
                          rank_frac, device)
    for b, (size, (u, s)) in enumerate(zip(sizes, factors)):
        base = f'block{b}'
        np.save(os.path.join(out_dir, base + '.npy'),
                np.vstack([u, s[None, :]]).astype(np.float32))
        with open(os.path.join(out_dir, base + '.var'), 'w') as fh:
            for i in range(start, start + size):
                fh.write(f'{ids[i]}\t1\t{i + 1}\t0.0\tA\tG\n')
        manifest.append(f'{base}.var\t{base}.npy')
        start += size
    schema = os.path.join(out_dir, 'panel.schema')
    with open(schema, 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')
    std_errs = rng.uniform(0.01, 0.05, (num_pops, n))
    betas = rng.standard_normal((num_pops, n)) * std_errs * 2
    sumstats = []
    for p in range(num_pops):
        path = os.path.join(out_dir, f'pop{p + 1}.sumstats.tsv')
        with open(path, 'w') as fh:
            fh.write('ID\tA1\tA2\tBETA\tSE\n')
            fh.writelines(f'{ids[i]}\tA\tG\t{betas[p, i]:.8e}\t'
                          f'{std_errs[p, i]:.8e}\n' for i in range(n))
        sumstats.append(path)
    extract = os.path.join(out_dir, 'extract.tsv')
    with open(extract, 'w') as fh:
        fh.write('ID\tA1\tA2\n')
        fh.writelines(f'{i}\tA\tG\n' for i in ids)
    return schema, sumstats, extract, n


def fit_argv(schema, sumstats, extract, prefix, device):
    return ['fit', '--ld-schema', f'{schema},{schema}',
            '--sumstats', ','.join(sumstats), '--extract', extract,
            '--names', 'pop1,pop2', '--samplesizes', '1e5,1e5',
            '--init-hg', '0.3,0.3', '--seed', '42', '--num-its', '5',
            '--output', prefix, '--device', device]


def read_posteriors(prefix):
    """[n, 4] posterior means and variances of a 2-cohort fit."""
    return np.loadtxt(prefix + '.estimates.tsv', skiprows=1,
                      usecols=(3, 4, 5, 6))


class count_em:
    """Context manager recording each error-scaling EM update the engine
    makes while active: (the value of `step()`, the scaling it leaves)."""

    def __init__(self, step=lambda: None):
        self.step = step

    def __enter__(self):
        from vilma_tpu_torch.inference import engine
        self.engine, self.real, self.events = (
            engine, engine._error_scaling, [])

        def counted(*a, **k):
            out = self.real(*a, **k)
            self.events.append((self.step(),
                                out[0][0].error_scaling.tolist()))
            return out

        engine._error_scaling = counted
        return self

    def __exit__(self, *exc):
        self.engine._error_scaling = self.real


def check_small_fit(out_dir):
    """The card's f32 fit against the host's f64 fit (the plain
    versions) on one 2-block schema, -K 3: posterior means and variances
    within their band of their scale, without --learn-scaling (5 steps)
    and with it on both of its routes (20 steps through an EM event; the
    epoch route forced by the size threshold 0, as VILMA_EPOCH_STATE_BYTES
    does). The host's own f32 fit, which sets the bands, is measured
    beside it. Returns {route: (card errors, scaling error, card scaling,
    host f32 errors)}."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.inference import engine
    schema, sumstats, extract, _ = write_schema(out_dir, num_blocks=2)
    errs = {}
    threshold = engine._EPOCH_STATE_BYTES
    for route, flags, band in (
            ('plain', [], BAND_FIT),
            ('kdim', ['--learn-scaling', '--num-its', SMALL_ITS_SE],
             BAND_FIT_SE),
            ('epoch', ['--learn-scaling', '--num-its', SMALL_ITS_SE],
             BAND_FIT_SE)):
        runs, scal = {}, {}
        for device, precision in (('cuda', 'f32'), ('cpu', 'f64'),
                                  ('cpu', 'f32')):
            tag = f'{device}_{precision}'
            prefix = os.path.join(out_dir, f'small_{route}_{tag}')
            engine._EPOCH_STATE_BYTES = 0 if route == 'epoch' else threshold
            try:
                with count_em() as em:
                    frontend.main(
                        fit_argv(schema, sumstats, extract, prefix, device)
                        + ['-K', '3', '--precision', precision,
                           '--ld-precision', 'f32' if precision == 'f32'
                           else 'auto'] + flags)
            finally:
                engine._EPOCH_STATE_BYTES = threshold
            runs[tag] = read_posteriors(prefix)
            z = np.load(prefix + '.npz')
            scal[tag] = z['error_scaling']
            if route != 'plain':
                require(len(em.events) >= 1,
                        f'{route} small fit on {tag}: no EM event')
                require(('nat_hist_n' in z.files) == (route == 'epoch'),
                        f'{route} small fit on {tag}: wrong state')

        def scaled(tag):
            return (np.abs(runs[tag] - runs['cpu_f64']).max(axis=0)
                    / np.abs(runs['cpu_f64']).max(axis=0))

        err = scaled('cuda_f32')
        require(np.all(np.isfinite(runs['cuda_f32'])), 'non-finite card fit')
        require(np.all(err <= band),
                f'{route}: card f32 fit vs host f64 fit: scaled errors '
                f'{err} exceed {band:.0e}')
        s_err = float(np.max(np.abs(scal['cuda_f32'] / scal['cpu_f64'] - 1)))
        require(s_err <= BAND_SCALING,
                f'{route}: learned scalings {scal} differ by {s_err:.2e}')
        errs[route] = (err, s_err, scal['cuda_f32'], scaled('cpu_f32'))
    return errs


def run_fit(paths, prefix, device, extra=(), devices=None):
    """run_argv of the 2-cohort CLI fit on a written schema."""
    schema, sumstats, extract, _ = paths
    return run_argv(fit_argv(schema, sumstats, extract, prefix, device)
                    + list(extra), device, devices)


def run_argv(argv, device, devices=None):
    """Zero the launch counters, run a CLI fit, read the counters.
    `devices` places the shards of a --mesh fit (commands/fit.main).
    Returns (counts, seconds per outer step, host syncs, EM scalings)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.commands import fit as fit_cmd
    from vilma_tpu_torch.inference import engine

    step_s = []
    real_step = engine.outer_step

    def timed_step(*a, **k):
        _sync(device)
        t = time.perf_counter()
        out = real_step(*a, **k)
        _sync(device)
        step_s.append(time.perf_counter() - t)
        return out

    zero_counts()
    engine.host_syncs = 0
    engine.outer_step = timed_step
    t0 = time.perf_counter()
    try:
        with count_em(step=lambda: len(step_s) + 1) as em:
            if devices is None:
                frontend.main(argv)
            else:
                fit_cmd.main(frontend.build_parser()[0].parse_args(argv),
                             devices=devices)
    finally:
        engine.outer_step = real_step
    counts = read_counts()
    log(f'  fit: {time.perf_counter() - t0:.1f} s in all, '
        f'{len(step_s)} outer steps')
    return counts, step_s, engine.host_syncs, em.events


def zero_counts():
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    block_matvec.launches = block_matvec.launches_group = 0
    block_matvec.launches_group_bf16 = 0
    block_matvec.launches_by_cohorts.clear()
    for key in compact_obj.launches:
        compact_obj.launches[key] = 0


def read_counts():
    """Launches by kernel; the matvec's cluster route counts under
    bucket_matvec_multi whatever U's type, its group route under
    bucket_matvec_multi_group (with bf16 U also under _group_bf16), and
    its launches of 4 and 8 cohorts (either route) also under the _c4 and
    _c8 keys."""
    from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
    by_c = block_matvec.launches_by_cohorts
    return dict(bucket_matvec_multi=block_matvec.launches,
                bucket_matvec_multi_group=block_matvec.launches_group,
                bucket_matvec_multi_group_bf16=(
                    block_matvec.launches_group_bf16),
                bucket_matvec_multi_c4=by_c.get(4, 0),
                bucket_matvec_multi_c8=by_c.get(8, 0),
                **compact_obj.launches)


def require_launched(counts, names, phase):
    for name in names:
        require(counts[name] > 0,
                f'{phase} never launched the {name} kernel')


def _sync(device):
    import torch
    if device == 'cuda':
        torch.cuda.synchronize()


def check_fit_outputs(prefix, n, K, names=('pop1', 'pop2'), vi_sigma=True):
    P = len(names)
    with np.load(prefix + '.npz') as npz:        # each member read once
        z = {key: npz[key] for key in npz.files}
    require(z['vi_mu'].shape == (K, P, n), f'vi_mu shape {z["vi_mu"].shape}')
    require(z['vi_delta'].shape == (n, K), 'vi_delta shape')
    require(('vi_sigma' in z) == vi_sigma, 'vi_sigma written or not')
    if vi_sigma:
        require(z['vi_sigma'].shape == (K, P, P, n), 'vi_sigma shape')
    for key, value in z.items():
        require(np.all(np.isfinite(value)), f'non-finite {key}')
    require(np.allclose(z['vi_delta'].sum(axis=1), 1.0, atol=1e-3),
            'vi_delta rows do not sum to 1')
    with open(prefix + '.estimates.tsv') as fh:
        header = fh.readline().rstrip('\n').split('\t')
        rows = [line.rstrip('\n').split('\t') for line in fh]
    require(len(rows) == n, f'{len(rows)} estimate rows for {n} variants')
    want = (['ID', 'A1', 'A2'] + [f'posterior_{m}' for m in names]
            + [f'posterior_variance_{m}' for m in names]
            + [f'missing_{w}_{m}' for m in names
               for w in ('sumstats', 'LD')])
    require(header == want, f'estimates columns {header}')
    post = np.array([[float(v) for v in r[3:3 + 2 * P]] for r in rows])
    require(np.all(np.isfinite(post)), 'non-finite posterior estimates')
    require(np.all(post[:, P:] >= 0), 'negative posterior variance')
    return float(np.max(np.abs(post[:, :P]))), z['error_scaling']


def remove_outputs(prefix):
    for ext in ('.npz', '.estimates.tsv', '.covariance.pkl'):
        if os.path.exists(prefix + ext):
            os.remove(prefix + ext)


# ---------------------------------------------------------------------------
# phases 5 and 7: engine at whole-genome HapMap3 scale
# ---------------------------------------------------------------------------

def device_ld(num_blocks, block_size, rank, device, seed=5, u_dtype=None,
              distinct=None):
    """A PackedLD of AR(1) blocks factored on the card (batched eigh,
    set-up rather than a kernel), eigenvectors in u_dtype (bf16 by
    default). With `distinct`, that many AR(1) blocks are factored and
    each of the num_blocks blocks holds a copy of one of them, drawn
    from the seed: the same packed shapes and bytes, a fraction of the
    set-up."""
    import torch
    u_dtype = torch.bfloat16 if u_dtype is None else u_dtype
    from vilma_tpu_torch.ops.blocks import BlockBucket, PackedLD
    rng = np.random.default_rng(seed)
    rho = rng.uniform(0.3, 0.95, num_blocks)
    pick = None
    if distinct is not None and distinct < num_blocks:
        pick = torch.as_tensor(rng.integers(0, distinct, num_blocks),
                               device=device)
        rho = rho[:distinct]
    rho = torch.as_tensor(rho, dtype=torch.float32, device=device)
    idx = torch.arange(block_size, device=device)
    lag = (idx[:, None] - idx[None, :]).abs().float()
    us, ss = [], []
    for b0 in range(0, len(rho), 64):
        r = rho[b0:b0 + 64]
        blocks = r[:, None, None] ** lag[None]
        vals, vecs = torch.linalg.eigh(blocks)
        us.append(vecs[:, :, -rank:].to(u_dtype))
        ss.append(vals[:, -rank:].contiguous())
        del blocks, vals, vecs
    u = torch.cat(us)
    s = torch.cat(ss)
    if pick is not None:
        u, s = u[pick], s[pick]
    u = u.contiguous()
    n = num_blocks * block_size
    perm = torch.arange(n, device=device).reshape(num_blocks, block_size)
    bucket = BlockBucket(
        u=u, s=s, inv_s=torch.where(s > 0, 1.0 / s, torch.zeros_like(s)),
        d=torch.zeros(num_blocks, block_size, device=device), perm=perm,
        seq=perm)
    return PackedLD(buckets=(bucket,), n=n, has_diag=False,
                    rank=float(num_blocks * rank), missing=())


def build_engine(device, ld=None, num_blocks=977, block_size=1024, K=18,
                 scale_se=False, u_dtype=None):
    """MultiPopVI and its initial state for a 2-cohort fit on AR(1)
    blocks at half rank sharing one panel (`ld`, or `num_blocks` of them
    factored here, U in u_dtype, bf16 by default): K synthetic
    components, or with scale_se the CLI's -K 12 grid drawn for these
    effect sizes (582 components)."""
    import torch
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.models import mixture
    t0 = time.perf_counter()
    if ld is None:
        ld = device_ld(num_blocks, block_size, block_size // 2, device,
                       u_dtype=u_dtype)
    _sync(device)
    n = ld.n
    rng = np.random.default_rng(7)
    std_errs = rng.uniform(0.01, 0.05, (2, n)).astype(np.float32)
    betas = (rng.standard_normal((2, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    if scale_se:
        covs = mixture.make_simple(
            2, 12, *mixture.effect_size_ranges(betas, std_errs, False))
    else:
        covs = synthetic_covs(2, K, 1)
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld, ld],
        annotations=np.ones((n, 1)), mixture_covs=covs, checkpoint=False,
        gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3), num_its=1,
        scale_se=scale_se, dtype=torch.float32, device=device)
    # the inputs, for the sharded run of phase 15b
    vi.inputs = dict(betas=betas, std_errs=std_errs, covs=covs)
    st = vi._initialize()
    st = engine.dataclasses.replace(st, elbo=vi.elbo_value(st))
    _sync(device)
    u = ld.buckets[0].u
    log(f'  set-up: {n} SNPs, K = {vi.num_mix}, U '
        f'{u.numel() * u.element_size() / 1e9:.2f} GB '
        f'{str(u.dtype).replace("torch.", "")}, '
        f'{time.perf_counter() - t0:.1f} s')
    return vi, st, ld


def timed_steps(data, st, steps):
    """(state, outer iterations/s, host syncs per step) of `steps` outer
    steps on the host clock."""
    import torch
    from vilma_tpu_torch.inference import engine
    _sync('cuda')
    syncs0 = engine.host_syncs
    t0 = time.perf_counter()
    for _ in range(steps):
        st, pm = engine.outer_step(data, st)
    _sync('cuda')
    dt = time.perf_counter() - t0
    require(math.isfinite(st.elbo), 'non-finite ELBO')
    require(all(bool(torch.isfinite(p).all())
                for p in (pm if isinstance(pm, tuple) else (pm,))),
            'non-finite posterior mean')
    return st, steps / dt, (engine.host_syncs - syncs0) / steps, pm


def run_engine(device, steps=3):
    """Phase 5: (iterations/s, host syncs a step, the engine, its state
    after the timed steps, its LD)."""
    from vilma_tpu_torch.inference import engine
    vi, st, ld = build_engine(device)
    st, _ = engine.outer_step(vi.data, st)             # warm-up
    st, ips, syncs, _ = timed_steps(vi.data, st, steps)
    return ips, syncs, vi, st, ld


def run_engine_se(device, ld, steps=3):
    """Phase 7: the epoch-history route at 1M SNPs, selected by size. A
    warm-up step, one EM append (the update a step makes once its ELBO
    gain falls below EM_TOL), then `steps` timed steps."""
    from vilma_tpu_torch.inference import engine
    vi, st, _ = build_engine(device, ld=ld, scale_se=True)
    require(vi._epoch, 'the size rule did not select the epoch state '
            f'(K = {vi.num_mix}, I = {vi.num_loci})')
    data = vi.data
    zero_counts()
    st, _ = engine.outer_step(data, st)                 # warm-up
    obj, pm, lk = engine._objective(data, st, engine._params(st),
                                    st.hyper_delta)
    with count_em() as em:
        st, _, _ = engine._update_error_scaling(
            data, st, engine._sync_float(obj), pm, lk)
    require(st.nat_hist_n >= 1, 'the EM update appended no epoch')
    st, ips, syncs, _ = timed_steps(data, st, steps)
    counts = read_counts()
    return counts, ips, syncs, st, em.events, vi


# ---------------------------------------------------------------------------
# phases 8-12: the subcommands around fit, resume, the K-chunked shape
# ---------------------------------------------------------------------------

class time_calls:
    """Context manager timing every call of the given module functions
    made while active, on the host clock with the card synchronized
    around each call (with sync=False: the host's time alone, the
    enqueue of a launcher): targets are label=(module or class, name),
    none calling another. `split(total)` says where a phase's seconds
    went."""

    def __init__(self, sync=True, **targets):
        self.targets, self.sync = targets, sync
        self.spent = {label: [0.0, 0] for label in targets}

    def __enter__(self):
        self.real = {}
        for label, (owner, name) in self.targets.items():
            self.real[label] = real = getattr(owner, name)

            def timed(*a, _real=real, _label=label, **k):
                if self.sync:
                    _sync('cuda')
                t = time.perf_counter()
                try:
                    return _real(*a, **k)
                finally:
                    if self.sync:
                        _sync('cuda')
                    self.spent[_label][0] += time.perf_counter() - t
                    self.spent[_label][1] += 1
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for label, (owner, name) in self.targets.items():
            setattr(owner, name, self.real[label])

    def split(self, total):
        rest = total - sum(sec for sec, _ in self.spent.values())
        return '; '.join([f'{label} {sec:.3f} s ({calls} calls)'
                          for label, (sec, calls) in self.spent.items()]
                         + [f'the rest {rest:.3f} s'])


def load_targets():
    """time_calls targets of an LD load: each block's read, match and
    eigendecomposition on the host, and the packing onto the device."""
    from vilma_tpu_torch.io import load
    from vilma_tpu_torch.ops import blocks
    return dict(ld_read_eigh=(load, 'load_entry_factor'),
                ld_pack=(blocks, 'pack'))


class record_elbos:
    """Context manager recording the ELBO of every outer step that
    MultiPopVI.optimize reports while active."""

    def __enter__(self):
        from vilma_tpu_torch.inference import engine
        self.cls, self.real, self.values = (
            engine.MultiPopVI, engine.MultiPopVI._dump_info, [])

        def recorded(vi, num_its, stats):
            self.values.append(float(stats[1]))
            return self.real(vi, num_its, stats)

        self.cls._dump_info = recorded
        return self

    def __exit__(self, *exc):
        self.cls._dump_info = self.real


def write_plink_chromosome(out_dir, num_blocks, samples, seed=3):
    """One synthetic PLINK chromosome in `num_blocks` LD blocks of 500-900
    SNPs (two SNPs between blocks lie in none): haplotypes that copy
    their neighbour's allele with probability 0.95, ~1% missing calls and
    a monomorphic SNP every 10,000. Returns (plink list, block bed file,
    SNP IDs by block)."""
    from vilma_tpu_torch.io import plink
    rng = np.random.default_rng(seed)
    sizes = rng.integers(500, 901, num_blocks)
    bed_lines, block_ids, bps, ids = [], [], [], []
    pos = 0
    for b, size in enumerate(sizes):
        start = pos
        members = []
        for _ in range(size):
            pos += 10
            bps.append(pos)
            ids.append(f'snp{len(ids)}')
            members.append(ids[-1])
        bed_lines.append(f'1\t{start}\t{pos}')
        block_ids.append(members)
        for _ in range(2):                       # between blocks
            pos += 10
            bps.append(pos)
            ids.append(f'snp{len(ids)}')
    n = len(bps)
    freqs = rng.uniform(0.05, 0.5, n)
    haps = np.empty((n, 2 * samples), dtype=np.int8)
    haps[0] = rng.random(2 * samples) < freqs[0]
    for j in range(1, n):
        copy = rng.random(2 * samples) < 0.95
        haps[j] = np.where(copy, haps[j - 1],
                           rng.random(2 * samples) < freqs[j])
    genos = haps[:, :samples] + haps[:, samples:]
    genos[rng.random(genos.shape) < 0.01] = 3
    genos[::10_000] = 0
    base = os.path.join(out_dir, 'chr1')
    plink.encode_bed(base + '.bed', genos)
    with open(base + '.bim', 'w') as fh:
        fh.writelines(f'1\t{ids[j]}\t{bps[j] * 1e-6:.6f}\t{bps[j]}\tA\tG\n'
                      for j in range(n))
    with open(base + '.fam', 'w') as fh:
        fh.writelines(f'f{i} i{i} 0 0 0 -9\n' for i in range(samples))
    plist = os.path.join(out_dir, 'plink_list.txt')
    with open(plist, 'w') as fh:
        fh.write('chr1\n')
    bed = os.path.join(out_dir, 'blocks.bed')
    with open(bed, 'w') as fh:
        fh.write('\n'.join(bed_lines) + '\n')
    return plist, bed, block_ids


def read_schema(root):
    with open(root + '.schema') as fh:
        text = fh.read()
    return text, [line.split() for line in text.splitlines() if line]


def run_make_ld_schema(out_dir):
    """Phase 8: make_ld_schema --ldthresh 0.8 of the whole chromosome on
    the card, then the first SCHEMA_CHECK_BLOCKS blocks (by --extract) on
    the host, held against the card's files. Returns (schema, seconds,
    variants, blocks, max ranks, errors)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.commands import make_ld_schema
    from vilma_tpu_torch.io import plink
    t0 = time.perf_counter()
    plist, bed, block_ids = write_plink_chromosome(out_dir, PLINK_BLOCKS,
                                                   PLINK_SAMPLES)
    log(f'  PLINK: {sum(map(len, block_ids))} SNPs in {len(block_ids)} '
        f'blocks, {PLINK_SAMPLES} samples, written in '
        f'{time.perf_counter() - t0:.1f} s')
    roots = {dev: os.path.join(out_dir, dev, 'ld') for dev in ('cuda', 'cpu')}
    for dev in roots:
        os.makedirs(os.path.dirname(roots[dev]))
    t0 = time.perf_counter()
    with time_calls(decode=(plink, 'decode_bed'),
                    correlation=(make_ld_schema, 'nan_corr'),
                    eigh=(make_ld_schema, 'truncate')) as split:
        frontend.main(['make_ld_schema', '-o', roots['cuda'], '-b', bed,
                       '-p', plist, '--ldthresh', '0.8', '--device',
                       'cuda'])
    _sync('cuda')
    seconds = time.perf_counter() - t0
    log(f'  card split: {split.split(seconds)}')
    extract = os.path.join(out_dir, 'extract.tsv')
    with open(extract, 'w') as fh:
        fh.write('ID\n')
        fh.writelines(f'{i}\n' for b in block_ids[:SCHEMA_CHECK_BLOCKS]
                      for i in b)
    frontend.main(['make_ld_schema', '-o', roots['cpu'], '-b', bed, '-p',
                   plist, '--ldthresh', '0.8', '--device', 'cpu',
                   '--extract', extract])
    card_text, card_entries = read_schema(roots['cuda'])
    host_text, host_entries = read_schema(roots['cpu'])
    require(len(card_entries) == len(block_ids),
            f'{len(card_entries)} schema entries for {len(block_ids)} blocks')
    require(host_text == ''.join(line + '\n' for line in
                                 card_text.splitlines()[:SCHEMA_CHECK_BLOCKS]),
            'card and host .schema text differ')
    errs = dict(s=0.0, recon=0.0)
    ranks = []
    n_vars = 0
    for j, (var, npy) in enumerate(card_entries):
        with open(os.path.join(os.path.dirname(roots['cuda']), var)) as fh:
            card_var = fh.read()
        n = len(card_var.splitlines())
        n_vars += n
        card = np.load(os.path.join(os.path.dirname(roots['cuda']), npy))
        require(card.shape[0] == n + 1 and np.all(np.isfinite(card)),
                f'{npy}: shape {card.shape} for {n} variants')
        ranks.append(card.shape[1])
        if j >= SCHEMA_CHECK_BLOCKS:
            continue
        with open(os.path.join(os.path.dirname(roots['cpu']), var)) as fh:
            require(fh.read() == card_var, f'{var}: card and host differ')
        host = np.load(os.path.join(os.path.dirname(roots['cpu']), npy))
        require(host.shape == card.shape,
                f'{npy}: rank {card.shape[1]} on the card, {host.shape[1]} '
                'on the host')
        cu, cs, hu, hs = card[:n], card[n], host[:n], host[n]
        errs['s'] = max(errs['s'], float(np.max(np.abs(cs / hs - 1))))
        errs['recon'] = max(errs['recon'], float(np.max(np.abs(
            (cu * cs) @ cu.T - (hu * hs) @ hu.T))))
    require(errs['s'] <= BAND_SCHEMA and errs['recon'] <= BAND_SCHEMA,
            f'card vs host eigen-truncation errors {errs} exceed '
            f'{BAND_SCHEMA:.0e}')
    return roots['cuda'], seconds, n_vars, len(card_entries), ranks, errs


def run_check_ld_schema(root, out_dir):
    """Phase 9: check_ld_schema --trace and --listvars of phase 8's
    schema on the card and on the host: equal text. Returns (seconds on
    the card, the trace table)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.io import load
    from vilma_tpu_torch.ops import blocks
    texts, seconds = {}, None
    for dev in ('cuda', 'cpu'):
        trace = os.path.join(out_dir, f'{dev}.trace.tsv')
        listvars = os.path.join(out_dir, f'{dev}.vars.tsv')
        t0 = time.perf_counter()
        with time_calls(**load_targets(),
                        diagonal=(blocks, 'diag'),
                        var_tables=(load, 'read_var_table')) as split:
            frontend.main(['check_ld_schema', '--ld-schema',
                           root + '.schema', '--trace', trace,
                           '--listvars', listvars, '--device', dev])
        if dev == 'cuda':
            seconds = time.perf_counter() - t0
            log(f'  card split: {split.split(seconds)}')
        with open(trace) as fh, open(listvars) as gh:
            texts[dev] = (fh.read(), gh.read())
    require(texts['cuda'] == texts['cpu'],
            'check_ld_schema: card and host text differ')
    return seconds, texts['cuda'][0].strip().replace('\n', ' | ')


def read_sim(path):
    with open(path) as fh:
        header = fh.readline().rstrip('\n').split('\t')
        rows = [line.rstrip('\n').split('\t') for line in fh]
    return header, rows


class memo_factors:
    """Context manager memoizing the LD loader's per-block host
    factorization (io/load.load_entry_factor) while active, keyed as the
    factor cache keys it (the .npy file's identity, the threshold, the
    variant match): a second load of the same blocks, here the host
    references of a card run and phases 6-11's reloads of phase 4's
    panel, reuses the first's factors, which the same host code on the
    same inputs would compute bit for bit."""

    def __enter__(self):
        from vilma_tpu_torch.io import load
        self.load, self.real, memo = load, load.load_entry_factor, {}

        def memoized(entry, ldthresh, cache_dir=None):
            key = load._factor_cache_key(entry, ldthresh)
            if key not in memo:
                memo[key] = self.real(entry, ldthresh, cache_dir)
            return memo[key]
        load.load_entry_factor = memoized
        return self

    def __exit__(self, *exc):
        self.load.load_entry_factor = self.real


def run_sim(paths, fit_prefix, out_dir):
    """Phase 10: sim from phase 4's fit (its .npz weights and
    .covariance.pkl) on phase 4's schema, 2 cohorts, default RNG path: on
    the card (f32), on the host at f64 and, for the band, at f32. The two
    host references reuse the card run's host LD factors (memo_factors).
    Returns (card seconds, matvec launches, card error, host f32
    error)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.commands import sim
    schema, sumstats, _, n = paths
    outs, seconds, counts = {}, None, None
    real_dtype = sim.ld_dtype
    with memo_factors():
        for tag, dev, dtype in (('cuda', 'cuda', None),
                                ('cpu_f64', 'cpu', None),
                                ('cpu_f32', 'cpu', 'f32')):
            prefix = os.path.join(out_dir, f'sim_{tag}')
            if dtype == 'f32':
                import torch
                sim.ld_dtype = lambda device: torch.float32
            zero_counts()
            t0 = time.perf_counter()
            try:
                with time_calls(**load_targets(),
                                components=(sim, 'sim_components'),
                                ld_products_noise=(sim, 'sim_gwas')) as split:
                    frontend.main(['sim', '--sumstats', ','.join(sumstats),
                                   '--covariance',
                                   fit_prefix + '.covariance.pkl',
                                   '--weights', fit_prefix + '.npz',
                                   '--ld-schema', f'{schema},{schema}',
                                   '--output', prefix, '--names',
                                   'pop1,pop2', '--seed', '42',
                                   '--device', dev])
            finally:
                sim.ld_dtype = real_dtype
            if tag == 'cuda':
                seconds = time.perf_counter() - t0
                counts = read_counts()
                log(f'  card split: {split.split(seconds)}')
            outs[tag] = {p: read_sim(f'{prefix}.{p}.simgwas.tsv')
                         for p in ('pop1', 'pop2')}
    errs = {}
    for tag in ('cuda', 'cpu_f32'):
        worst = 0.0
        for p in ('pop1', 'pop2'):
            header, rows = outs[tag][p]
            want_header, want = outs['cpu_f64'][p]
            require(header == want_header == ['ID', 'A1', 'A2', 'SE',
                                              'BETA', 'true_beta'],
                    f'sim columns {header}')
            require(len(rows) == len(want) == n, f'{len(rows)} sim rows')
            require([r[0] for r in rows] == [r[0] for r in want]
                    and [r[5] for r in rows] == [r[5] for r in want],
                    f'sim {tag} {p}: IDs or true_beta differ from the host')
            got = np.array([float(r[4]) for r in rows])
            ref = np.array([float(r[4]) for r in want])
            require(np.all(np.isfinite(got)), f'sim {tag}: non-finite BETA')
            worst = max(worst, float(np.max(np.abs(got - ref))
                                     / np.max(np.abs(ref))))
        errs[tag] = worst
    require(errs['cuda'] <= BAND_SIM,
            f'sim: card BETA {errs["cuda"]:.2e} of scale from the host f64 '
            f'run (band {BAND_SIM:.0e}; host f32 {errs["cpu_f32"]:.2e})')
    require(counts['bucket_matvec_multi'] > 0,
            'sim never launched the bucket_matvec_multi kernel')
    return seconds, counts['bucket_matvec_multi'], errs


def resume_kdim(paths, fit_prefix, elbos, out_dir):
    """Phase 11a: resume phase 6's kdim fit from its last checkpoint
    through `fit --load-checkpoint` on the card (the streamed route: the
    vi_mu member is over 256 MB) for RESUME_STEPS steps. The first ELBO
    after the resume, that of the restored state, is held to the
    original run's ELBO at that iteration (after the step before the
    checkpoint). Returns (checkpoint step, seconds, relative ELBO error,
    launches)."""
    from vilma_tpu_torch.inference import engine
    steps = [int(f.split('.')[1]) for f in os.listdir(out_dir)
             if f.startswith('fit_se-checkpoint.')]
    c = max(k for k in steps if 0 < k < len(elbos))
    streamed, first = [], []
    cls = engine.MultiPopVI
    real_elbo = cls.elbo_value

    def counted(vi, *a):
        streamed.append(1)
        return real_stream(vi, *a)

    def elbo_value(vi, *a):
        value = real_elbo(vi, *a)
        first.append(value)
        return value

    t0 = time.perf_counter()
    with time_calls(**load_targets(),
                    recovery=(cls, '_nat_from_checkpoint_streamed'),
                    steps=(engine, 'outer_step')) as split:
        real_stream = cls._nat_from_checkpoint_streamed      # timed
        cls._nat_from_checkpoint_streamed = counted
        cls.elbo_value = elbo_value
        try:
            with record_elbos() as rec:
                counts, step_s, _, _ = run_fit(
                    paths, os.path.join(out_dir, 'resumed'), 'cuda',
                    F32_BF16 + ['--learn-scaling', '--num-its',
                                str(RESUME_STEPS), '--load-checkpoint',
                                os.path.join(out_dir,
                                             f'fit_se-checkpoint.{c}.npz'),
                                fit_prefix + '.covariance.pkl'])
        finally:
            cls._nat_from_checkpoint_streamed = real_stream
            cls.elbo_value = real_elbo
    seconds = time.perf_counter() - t0
    log(f'  kdim card split: {split.split(seconds)}')
    require(streamed, 'the kdim resume did not take the streamed route')
    require(len(rec.values) == len(step_s) >= 1
            and all(math.isfinite(v) for v in rec.values),
            f'resumed fit: ELBOs {rec.values}')
    err = abs(first[0] / elbos[c - 1] - 1)
    require(err <= BAND_RESUME,
            f'ELBO after resuming at iteration {c}: {first[0]!r} vs the '
            f'original run\'s {elbos[c - 1]!r} ({err:.2e} > '
            f'{BAND_RESUME:.0e})')
    require_launched(counts, ('bucket_matvec_multi', 'prologue_kdim',
                              'delta_sums_kdim'), 'the kdim resume')
    return c, seconds, err, counts, rec.values


def resume_epoch(vi, st, out_dir):
    """Phase 11b: dump phase 7's epoch-history state as a checkpoint
    (the arrays of dump_spec: the epoch keys, hyper_delta, error_scaling;
    the derived vi_mu/vi_delta streams, 7 GB at this size, are not what
    an epoch resume reads) and resume it through MultiPopVI.optimize on
    the card for RESUME_STEPS steps. The first ELBO after the resume is
    held to that of a step taken from the dumped state itself, with the
    step-size and running-delta estimates a resume starts from. Returns
    (seconds, relative ELBO error, launches)."""
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.utils.npz_stream import save_npz_stream
    path = os.path.join(out_dir, 'epoch-checkpoint.npz')
    arrays, _ = vi.dump_spec(st)
    save_npz_stream(path, arrays)
    fresh = vi._fresh_state()
    st0 = engine.dataclasses.replace(
        st, elbo=vi.elbo_value(st), L=fresh.L,
        running_elbo_delta=fresh.running_elbo_delta, num_err=0)
    want, _ = engine.outer_step(vi.data, st0)
    vi.checkpoint, vi.num_its = False, RESUME_STEPS
    zero_counts()
    t0 = time.perf_counter()
    with record_elbos() as rec:
        vi.optimize(np.load(path))
    _sync('cuda')
    seconds = time.perf_counter() - t0
    counts = read_counts()
    require(len(rec.values) >= 1, 'the resumed epoch fit took no step')
    err = abs(rec.values[0] / want.elbo - 1)
    require(err <= BAND_RESUME,
            f'first ELBO after the epoch resume {rec.values[0]!r} vs '
            f'{want.elbo!r} ({err:.2e} > {BAND_RESUME:.0e})')
    require_launched(counts, ('bucket_matvec_multi', 'prologue_epochs',
                              'delta_sums_epochs'), 'the epoch resume')
    return seconds, err, counts


def check_chunked_kernels(device, I, K, A=1, P=3):
    """Phase 12's kernel check: the [P, I] prologue and sums against their
    plain versions on seeded operands of the K-chunked shape, where the
    prologue walks K in several tiles and the sums keep all of K in one
    group of narrow tiles (a branch no phase 3 shape takes). Returns the
    launch shapes."""
    from vilma_tpu_torch.ops.cuda import compact_obj as co
    kw = dict(zip(('coeffs', 'scores_t', 'annotations', 'dterm', 'nat_mu'),
                  compact_inputs(device, P, K, I, A, seed=K)),
              num_annotations=A)
    ncol = kw['coeffs'].shape[1]
    kt_p = co._launch_shape(I, K, A, ncol, sums=False)[0]
    kt_s, kg_s, _ = co._launch_shape(I, K, A, ncol, sums=True)
    check_pair(f'[P, I] P={P} K={K} I={I} A={A} (prologue '
               f'{-(-K // kt_p)} tiles of {kt_p}; sums one group, '
               f'{-(-K // kt_s)} tiles of {kt_s})', None, {},
               (co.prologue, co.delta_sums),
               (co.prologue_plain, co.delta_sums_plain), kw,
               lambda sums: compact_cost(P, K, I, A, sums), timed=False)
    require(kt_p < K and kg_s == K and kt_s < K,
            f'K = {K}, A = {A}: prologue tile {kt_p}, sums tile {kt_s} and '
            f'group {kg_s}, not the narrow-tile one-group branch')
    return kt_p, kt_s, kg_s


def run_chunked_shape(device, num_blocks=98, steps=2):
    """Phase 12: the JAX package's largest K-chunked shape, through
    MultiPopVI.optimize: ~100K SNPs (98 blocks of 1024 at half rank, bf16
    U) shared by 3 cohorts, the CLI's -K 12 --drop-non-psd grid (42,999
    components), f32, the shared [P, I] state; the initialization (its
    [K, I] terms in SNP chunks) and `steps` outer steps. The prologue and
    sums are first held against their plain versions at this shape.
    Returns a dict of what it measured."""
    import torch
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.models import mixture
    ld = device_ld(num_blocks, 1024, 512, device)
    n = ld.n
    kt_p, kt_s, kg_s = check_chunked_kernels(device, n, CHUNKED_K)
    rng = np.random.default_rng(11)
    std_errs = rng.uniform(0.01, 0.05, (3, n)).astype(np.float32)
    betas = (rng.standard_normal((3, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    covs = mixture.make_simple(
        3, 12, *mixture.effect_size_ranges(betas, std_errs, False),
        drop_non_psd=True)
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld] * 3,
        annotations=np.ones((n, 1)), mixture_covs=covs, checkpoint=False,
        gwas_N=np.full(3, 1e5), init_hg=np.full(3, 0.3), num_its=steps,
        dtype=torch.float32, device=device)
    K = vi.num_mix
    require(K == CHUNKED_K, f'the -K 12 grid at 3 cohorts has {K} PSD '
            f'components, not {CHUNKED_K}')
    st, out = timed_optimize(vi, device)
    out.update(K=K, kt_prologue=kt_p, kt_sums=kt_s, kg_sums=kg_s)
    require(len(out['step_s']) == steps,
            f'{len(out["step_s"])} outer steps, not {steps}')
    require(st.vi_mu is None, 'the [K, P, I] outputs were materialized')
    require_launched(out['counts'], ('bucket_matvec_multi', 'prologue',
                                     'delta_sums'), 'the K-chunked shape')
    out['write'] = write_chunked_outputs(vi, st, device)
    return out


class host_rss:
    """Context manager sampling this process's VmRSS every 5 ms: `before`
    and `peak`, in bytes."""

    @staticmethod
    def now():
        with open('/proc/self/status') as fh:
            for line in fh:
                if line.startswith('VmRSS:'):
                    return int(line.split()[1]) * 1024
        raise SmokeFailure('/proc/self/status has no VmRSS')

    def __enter__(self):
        import threading
        self.before = self.peak = self.now()
        self._done = threading.Event()

        def sample():
            while not self._done.wait(0.005):
                self.peak = max(self.peak, self.now())

        self._watcher = threading.Thread(target=sample, daemon=True)
        self._watcher.start()
        return self

    def __exit__(self, *exc):
        self._done.set()
        self._watcher.join()
        self.peak = max(self.peak, self.now())
        return False


def drain(streams):
    """Consume dump_spec's streams as save_npz_stream would, writing
    nothing: each chunk's trailing shape and dtype checked, its rows
    counted. Returns {name: (rows, the first chunk, the last chunk)}."""
    out = {}
    for name, shape, dtype, chunks in streams:
        rows, first, last = 0, None, None
        for chunk in chunks:
            require(chunk.shape[1:] == tuple(shape[1:])
                    and chunk.dtype == np.dtype(dtype),
                    f'{name} chunk {chunk.shape} {chunk.dtype}')
            rows += chunk.shape[0]
            first = chunk if first is None else first
            last = chunk
        require(rows == shape[0], f'{name}: chunks cover {rows} of '
                f'{shape[0]} rows')
        out[name] = (rows, first, last)
    return out


def write_chunked_outputs(vi, st, device):
    """Phase 12's outputs, as fit writes them: the .npz of dump_spec
    (vi_mu [K, P, I] in component chunks, vi_delta [I, K] in variant
    chunks, streamed by utils/npz_stream; no vi_sigma, ~155 GB at this
    shape) and the posterior estimates, into a temporary directory,
    timed on the host clock with the peak host RSS sampled. Read back:
    the members' shapes, one vi_mu chunk (the last, ragged one) against
    vi_mu_chunks' output for it, bit for bit. The files are deleted.
    Where the disk holds less than the two members plus 20%, nothing is
    written: the free and needed bytes come back, and the same streams
    and estimates are computed and checked without a file (`drain`)."""
    import shutil
    from vilma_tpu_torch.utils.npz_stream import (npz_member_memmap,
                                                  save_npz_stream)
    K, P, n = vi.num_mix, vi.num_pops, vi.num_loci
    itemsize = vi._np_dtype.itemsize
    members = (K * P * n + n * K) * itemsize
    out = dict(members_bytes=members, need_bytes=int(members * 1.2))
    with tempfile.TemporaryDirectory() as tmp:
        out['free_bytes'] = shutil.disk_usage(tmp).free
        out['written'] = out['free_bytes'] >= out['need_bytes']
        prefix = os.path.join(tmp, 'chunked')
        _sync(device)
        with host_rss() as rss:
            t0 = time.perf_counter()
            arrays, streams = vi.dump_spec(st)
            require([s[0] for s in streams] == ['vi_mu', 'vi_delta'],
                    f'dump_spec streams {[s[0] for s in streams]}')
            if out['written']:
                save_npz_stream(prefix + '.npz', arrays, streams)
            else:
                drained = drain(streams)
            t1 = time.perf_counter()
            pm, pv = vi._streamed_moments(st)
            if out['written']:
                np.savetxt(prefix + '.estimates.tsv',
                           np.concatenate([pm, pv]).T, delimiter='\t',
                           comments='', header='\t'.join(
                               [f'posterior_pop{p + 1}' for p in range(P)]
                               + [f'posterior_variance_pop{p + 1}'
                                  for p in range(P)]))
            t2 = time.perf_counter()
        out.update(npz_s=t1 - t0, estimates_s=t2 - t1,
                   rss_before=rss.before, rss_peak=rss.peak)
        require(pm.shape == pv.shape == (P, n) and np.all(np.isfinite(pm))
                and np.all(np.isfinite(pv)) and np.all(pv >= 0),
                'non-finite or negative estimates')
        if not out['written']:
            rows_mu, _, last = drained['vi_mu']
            rows_i, first_d, last_d = drained['vi_delta']
            out['vi_mu_shape'] = (rows_mu,) + last.shape[1:]
            out['vi_delta_shape'] = (rows_i,) + last_d.shape[1:]
            require(np.all(np.isfinite(last)), 'non-finite vi_mu chunk')
            for part in (first_d, last_d):
                require(np.allclose(part.sum(axis=1), 1.0, atol=1e-3),
                        'vi_delta rows do not sum to 1')
            return out
        out['npz_bytes'] = os.path.getsize(prefix + '.npz')
        with open(prefix + '.estimates.tsv') as fh:
            rows = sum(1 for _ in fh) - 1
        require(rows == n, f'{rows} estimate rows for {n} variants')
        mu = npz_member_memmap(prefix + '.npz', 'vi_mu')
        delta = npz_member_memmap(prefix + '.npz', 'vi_delta')
        require(mu is not None and delta is not None,
                'the streamed members are not mappable')
        out['vi_mu_shape'], out['vi_delta_shape'] = mu.shape, delta.shape
        require(mu.shape == (K, P, n) and delta.shape == (n, K),
                f'read back vi_mu {mu.shape}, vi_delta {delta.shape}')
        *_, last = vi.vi_mu_chunks(st)
        k0 = K - last.shape[0]
        require(np.array_equal(np.asarray(mu[k0:]), last),
                f'the vi_mu chunk [{k0}, {K}) read back differs from '
                'vi_mu_chunks\' output for it')
        rows = np.asarray(delta[:1024]).sum(axis=1)
        require(np.allclose(rows, 1.0, atol=1e-3),
                'vi_delta rows read back do not sum to 1')
        out['checked_chunk'] = (k0, K)
        del mu, delta
    return out


def log_chunked_write(w, smi):
    rss = (f'host RSS {w["rss_before"] / 2**30:.2f} GiB before, peak '
           f'{w["rss_peak"] / 2**30:.2f} GiB during it')
    if not w['written']:
        log(f'  outputs NOT written: the disk has {w["free_bytes"]} bytes '
            f'free, the vi_mu and vi_delta members need {w["need_bytes"]} '
            f'(their {w["members_bytes"]} bytes plus 20%); streamed '
            f'without a file instead: vi_mu {list(w["vi_mu_shape"])} and '
            f'vi_delta {list(w["vi_delta_shape"])} in {w["npz_s"]:.1f} s, '
            f'the estimates in {w["estimates_s"]:.1f} s; {rss}; {smi}')
        return
    log(f'  outputs written: .npz ({w["npz_bytes"]} bytes: vi_mu and '
        f'vi_delta streamed, hyper_delta, error_scaling, scalings) in '
        f'{w["npz_s"]:.1f} s ({w["npz_bytes"] / w["npz_s"] / 1e9:.2f} GB/s), '
        f'estimates in {w["estimates_s"]:.1f} s; {rss}; read back: '
        f'vi_mu {list(w["vi_mu_shape"])}, vi_delta '
        f'{list(w["vi_delta_shape"])}, the vi_mu chunk '
        f'{list(w["checked_chunk"])} equal to vi_mu_chunks\' bit for bit; '
        f'{w["free_bytes"]} bytes were free; files deleted; {smi}')


def timed_optimize(vi, device):
    """MultiPopVI.optimize from its initialization, its outer steps and
    initialization timed on the host clock (the card synchronized), the
    launch counters zeroed just before. Returns (state, dict: init_s and
    init_peak, the initialization's seconds and peak device memory;
    step_s, s_per_iter and step_peak, the steps'; syncs, host syncs per
    step; counts, launches; elbo)."""
    import torch
    from vilma_tpu_torch.inference import engine
    out, step_s, finite = {}, [], []
    real_step, real_init = engine.outer_step, vi._initialize

    def timed_step(*a, **k):
        _sync(device)
        t = time.perf_counter()
        st, pm = real_step(*a, **k)
        _sync(device)
        step_s.append(time.perf_counter() - t)
        finite.append(all(bool(torch.isfinite(p).all()) for p in (
            pm if isinstance(pm, tuple) else (pm,))))
        return st, pm

    def timed_init():
        t = time.perf_counter()
        st = real_init()
        _sync(device)
        out['init_s'] = time.perf_counter() - t
        out['init_peak'] = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        return st

    _sync(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    engine.host_syncs = 0
    engine.outer_step, vi._initialize = timed_step, timed_init
    try:
        st = vi.optimize()
    finally:
        engine.outer_step = real_step
        del vi._initialize
    require(math.isfinite(st.elbo), 'non-finite ELBO')
    require(step_s and all(finite), 'non-finite posterior mean')
    out.update(step_s=step_s, s_per_iter=sum(step_s) / len(step_s),
               step_peak=torch.cuda.max_memory_allocated(),
               counts=read_counts(), syncs=engine.host_syncs / len(step_s),
               elbo=st.elbo)
    return st, out


# ---------------------------------------------------------------------------
# phase 13: the materialized path (P >= 4 cohorts or traits)
# ---------------------------------------------------------------------------

def trait_argv(paths, prefix, device, K, its):
    """`fit --trait` of every sumstats file of a written schema on its
    one panel, the -K grid with its non-PSD components dropped."""
    schema, sumstats, extract, _ = paths
    T = len(sumstats)
    return ['fit', '--trait', '--ld-schema', schema,
            '--sumstats', ','.join(sumstats), '--extract', extract,
            '--names', ','.join(TRAIT_NAMES[:T]),
            '--samplesizes', ','.join(['1e5'] * T),
            '--init-hg', ','.join(['0.3'] * T), '--seed', '42',
            '--num-its', str(its), '-K', str(K), '--drop-non-psd',
            '--output', prefix, '--device', device]


def materialized_targets():
    """time_calls targets of a materialized fit: the P x P Cholesky
    solves and inverses, the [K, P, I] and [K, I] elementwise passes, the
    matvec (none calls another)."""
    from vilma_tpu_torch.models import sigma
    from vilma_tpu_torch.ops import blocks, kernels
    return dict(
        pxp_solves=(sigma, 'apply_sigma'),
        pxp_inverses=(sigma, 'make_summaries'),
        pxp_init=(sigma, 'sigma_weighted_sum'),
        kpi_precision=(sigma, 'apply_precision'),
        kpi_step=(kernels, 'sum_betas'),
        kpi_vi_delta=(kernels, 'fast_invert_nat_vi_delta'),
        kpi_mean=(kernels, 'fast_posterior_mean'),
        kpi_variance=(kernels, 'fast_pmv'),
        kpi_quadform=(kernels, 'fast_inner_product_comp'),
        ki_delta_kl=(kernels, 'fast_delta_kl'),
        matvec=(blocks, 'dot_multi'))


def trait_cache(paths):
    """Phase 13a's factor cache, beside its panel (16c reads it warm)."""
    return os.path.join(os.path.dirname(paths[0]), 'factor_cache')


def run_trait_fit(out_dir, device='cuda', num_blocks=88, K=3, keep=False):
    """Phase 13a: `fit --trait` of TRAITS traits on one ~90K-variant panel
    (88 blocks of 1024 at half rank, bf16 U, its factors cached in a
    fresh --factor-cache), -K 3 --drop-non-psd, f32,
    STEPS_TRAIT steps, no vi_sigma output; the materialized state. The
    matvec must launch with 4 cohorts and no compact kernel at all; the
    ELBO stays finite and does not fall by more than the line search's
    relative tolerance. Returns what it measured (with `keep`, the
    schema's paths and the outputs' prefix, which stay, for phase 16c)."""
    import torch
    paths = write_schema(out_dir, num_blocks=num_blocks, num_pops=TRAITS,
                         device=device)
    prefix = os.path.join(out_dir, 'trait')
    argv = (trait_argv(paths, prefix, device, K, STEPS_TRAIT) + F32_BF16
            + ['--no-save-vi-sigma', '--factor-cache',
               trait_cache(paths)])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    from vilma_tpu_torch.utils import npz_stream
    with time_calls(**load_targets(), **materialized_targets(),
                    write_npz=(npz_stream, 'save_npz_stream')) as split, \
            record_elbos() as rec:
        counts, step_s, syncs, _ = run_argv(argv, device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    with open(prefix + '.covariance.pkl', 'rb') as fh:
        K = len(pickle.load(fh)[0])
    top, _ = check_fit_outputs(prefix, paths[3], K,
                               names=TRAIT_NAMES[:TRAITS], vi_sigma=False)
    require(len(step_s) == STEPS_TRAIT, f'{len(step_s)} outer steps')
    v = rec.values
    require(len(v) == STEPS_TRAIT and all(math.isfinite(e) for e in v)
            and all(b >= a - 1e-6 * abs(a) for a, b in zip(v, v[1:])),
            f'phase 13a ELBOs {v}')
    if device == 'cuda':
        require_launched(counts, ('bucket_matvec_multi',
                                  'bucket_matvec_multi_c4'), 'phase 13a')
    require(all(counts[k] == 0 for k in counts
                if not k.startswith('bucket')),
            f'phase 13a ran a compact kernel: {counts}')
    if not keep:
        remove_outputs(prefix)
    return dict(K=K, n=paths[3], seconds=seconds, step_s=step_s,
                paths=paths, prefix=prefix,
                syncs=syncs / len(step_s), peak=peak, counts=counts,
                elbos=v, top=top, split=split.split(seconds))


# phase 13b's panels but phase 5's: each block a copy of one of this many
# AR(1) blocks factored for the panel (device_ld's `distinct`)
ANCESTRY_DISTINCT = 64


def run_ancestry_fit(device, ld5=None, num_blocks=977, steps=2):
    """Phase 13b: 4 ancestries at genome scale, through MultiPopVI:
    1,000,448 SNPs (977 blocks of 1024 at half rank), each cohort with its
    own bf16 panel (phase 5's generator, 4 seeds: the matvec at one cohort
    per panel; the first, seed 5, is phase 5's panel `ld5` where given,
    the others ANCESTRY_DISTINCT factored blocks spread over the 977),
    the -K 2 --drop-non-psd grid at 4 cohorts, f32, the materialized
    state; the initialization and `steps` steps."""
    import torch
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.models import mixture
    t0 = time.perf_counter()
    lds = [ld5 if p == 0 and ld5 is not None
           else device_ld(num_blocks, 1024, 512, device, seed=5 + p,
                          distinct=ANCESTRY_DISTINCT)
           for p in range(4)]
    _sync(device)
    setup_s = time.perf_counter() - t0
    n = lds[0].n
    rng = np.random.default_rng(13)
    std_errs = rng.uniform(0.01, 0.05, (4, n)).astype(np.float32)
    betas = (rng.standard_normal((4, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    covs = mixture.make_simple(
        4, 2, *mixture.effect_size_ranges(betas, std_errs, False),
        drop_non_psd=True)
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=lds,
        annotations=np.ones((n, 1)), mixture_covs=covs, checkpoint=False,
        gwas_N=np.full(4, 1e5), init_hg=np.full(4, 0.3), num_its=steps,
        dtype=torch.float32, device=device)
    require(not vi._compact, 'phase 13b did not take the materialized state')
    st, out = timed_optimize(vi, device)
    require(len(out['step_s']) == steps, f'{len(out["step_s"])} steps')
    require(st.vi_mu is not None and st.nat_mu is None,
            'phase 13b state is not materialized')
    require_launched(out['counts'], ('bucket_matvec_multi',), 'phase 13b')
    require(out['counts']['bucket_matvec_multi_c4'] == 0,
            'phase 13b shares a panel')
    out.update(K=vi.num_mix, n=n, setup_s=setup_s)
    return out


def run_trait_references(out_dir, card='cuda'):
    """Phase 13c: a small 4-trait fit (4 blocks, 4,096 variants, the -K 2
    --drop-non-psd grid, 5 steps) on the card at f32 (f32 U) against the
    host's f64 fit: posterior means and variances within
    BAND_TRAIT_FACTOR times the host's own f32 fit's error (per column,
    relative to its scale). Then the card's fit resumed through
    --load-checkpoint from its own materialized checkpoint at step 4: the
    ELBO of the restored state within BAND_RESUME of the original run's
    there. Returns (card errors, host f32 errors, resume error, K)."""
    from vilma_tpu_torch.inference import engine
    paths = write_schema(out_dir, num_blocks=4, num_pops=TRAITS, seed=4)
    P = TRAITS
    runs, elbos = {}, {}
    for tag, device, precision in (('card', card, 'f32'),
                                   ('cpu_f64', 'cpu', 'f64'),
                                   ('cpu_f32', 'cpu', 'f32')):
        prefix = os.path.join(out_dir, f'small_{tag}')
        extra = ['--precision', precision, '--ld-precision',
                 'f32' if precision == 'f32' else 'auto']
        if tag == 'card':
            extra += ['--checkpoint-freq', '2']
        with record_elbos() as rec:
            counts, _, _, _ = run_argv(
                trait_argv(paths, prefix, device, 2, 5) + extra, device)
        elbos[tag] = rec.values
        runs[tag] = np.loadtxt(prefix + '.estimates.tsv', skiprows=1,
                               usecols=range(3, 3 + 2 * P))
        if tag == 'card' and card == 'cuda':
            require_launched(counts, ('bucket_matvec_multi_c4',),
                             'phase 13c')

    def scaled(tag):
        return (np.abs(runs[tag] - runs['cpu_f64']).max(axis=0)
                / np.abs(runs['cpu_f64']).max(axis=0))

    err, host = scaled('card'), scaled('cpu_f32')
    require(np.all(np.isfinite(runs['card'])), 'non-finite card fit')
    require(np.all(err <= BAND_TRAIT_FACTOR * host.max()),
            f'4-trait card f32 fit vs host f64 fit: scaled errors {err} '
            f'exceed {BAND_TRAIT_FACTOR} x the host f32 fit\'s {host.max():.2e}')
    # resume the card's fit from its checkpoint at step 4
    c = 4
    first = []
    cls = engine.MultiPopVI
    real_elbo = cls.elbo_value

    def elbo_value(vi, *a):
        value = real_elbo(vi, *a)
        first.append(value)
        return value

    prefix = os.path.join(out_dir, 'small_card')
    cls.elbo_value = elbo_value
    try:
        counts, _, _, _ = run_argv(
            trait_argv(paths, os.path.join(out_dir, 'resumed'), card, 2, 2)
            + ['--precision', 'f32', '--ld-precision', 'f32',
               '--load-checkpoint', f'{prefix}-checkpoint.{c}.npz',
               prefix + '.covariance.pkl'], card)
    finally:
        cls.elbo_value = real_elbo
    want = elbos['card'][c - 1]
    r_err = abs(first[0] / want - 1)
    require(r_err <= BAND_RESUME,
            f'ELBO after resuming the 4-trait fit at step {c}: {first[0]!r} '
            f'vs {want!r} ({r_err:.2e} > {BAND_RESUME:.0e})')
    if card == 'cuda':
        require_launched(counts, ('bucket_matvec_multi_c4',), 'the resume')
    z = np.load(prefix + '.npz')
    return err, host, r_err, z['vi_mu'].shape[0]


def run_eight_traits(device, num_blocks=88, steps=2):
    """Phase 13d: 8 traits on one panel (88 blocks of 1024 at half rank,
    bf16 U), 6 synthetic components, f32, through MultiPopVI: the
    initialization and `steps` steps, the matvec at 8 cohorts a launch."""
    import torch
    from vilma_tpu_torch.inference import engine
    ld = device_ld(num_blocks, 1024, 512, device, seed=8)
    n = ld.n
    rng = np.random.default_rng(17)
    std_errs = rng.uniform(0.01, 0.05, (8, n)).astype(np.float32)
    betas = (rng.standard_normal((8, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=std_errs, ld_mats=[ld] * 8,
        annotations=np.ones((n, 1)), mixture_covs=synthetic_covs(8, 6, 8),
        checkpoint=False, gwas_N=np.full(8, 1e5), init_hg=np.full(8, 0.3),
        num_its=steps, dtype=torch.float32, device=device)
    _, out = timed_optimize(vi, device)
    require(len(out['step_s']) == steps, f'{len(out["step_s"])} steps')
    require_launched(out['counts'], ('bucket_matvec_multi_c8',), 'phase 13d')
    return out


# ---------------------------------------------------------------------------
# phase 14: bounded-memory loading (--factor-cache, --mmap) and the
# validation tools (the gradient ELBO fit, NUTS and SMC)
# ---------------------------------------------------------------------------

# 14a-c: phase 4's fit, FACTOR_ITS steps, each run in a process of its
# own so that its host memory is its own
FACTOR_ITS = '3'
# 14d: Adam steps of the gradient tool from phase 4's initialized state,
# and their rate. Adam moves every parameter by about the rate a step,
# whatever its scale, so the components of the 582-point grid with the
# smallest prior variances bound it: a rate of 1e-5 loses ELBO over the
# first steps of this state
GRAD_STEPS = 20
GRAD_LR = 5e-7
# 14e: the samplers on tests/test_validation.py's 8-SNP blocks; their
# posterior means within BAND_SAMPLER of the largest |beta_hat| of the VI
# answer (that test's band); NUTS at fewer draws than that test's
# 500 + 1500
BAND_SAMPLER = 0.1
NUTS_WARMUP, NUTS_SAMPLES = 200, 300

# one fit of phase 14a-c: argv (JSON), the device, and '1' to switch off
# the reference's mmap-mode RNG draws. Prints RESULT and a JSON object:
# factor-cache hits and misses, the load's seconds, the process's RSS
# (VmRSS) and anonymous RSS (RssAnon) before the load and their peaks
# during it (sampled every 2 ms), its peak RSS (VmHWM) just after the
# load and at the end, launches. A field /proc does not report is None
# (the card's sandbox reports VmRSS alone; getrusage's ru_maxrss is no
# stand-in: it keeps the parent's RSS over the fork and exec)
_FIT_WORKER = r'''
import json, sys, threading, time
sys.path.insert(0, sys.argv[4])
import torch
from vilma_tpu_torch import frontend
from vilma_tpu_torch.io import load
from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj

argv, device = json.loads(sys.argv[1]), sys.argv[2]
if sys.argv[3] == '1':
    load.consume_mmap_rng_draws = lambda num_blocks=1: None


def status():
    """The kB fields of /proc/self/status."""
    with open('/proc/self/status') as fh:
        return {f[0].rstrip(':'): int(f[1]) for f in map(str.split, fh)
                if len(f) == 3 and f[2] == 'kB'}


out = {}
real = load.load_ld_from_schema


def measured(*a, **k):
    first = status()
    peak = {key: first.get(key) for key in ('VmRSS', 'RssAnon')}
    out['rss_before_kb'], out['anon_before_kb'] = (peak['VmRSS'],
                                                   peak['RssAnon'])
    done = threading.Event()

    def sample():
        while not done.wait(0.002):
            now = status()
            for key, value in peak.items():
                if value is not None:
                    peak[key] = max(value, now.get(key, value))

    watcher = threading.Thread(target=sample)
    watcher.start()
    t = time.perf_counter()
    try:
        res = real(*a, **k)
        if device == 'cuda':
            torch.cuda.synchronize()
    finally:
        done.set()
        watcher.join()
    out['load_s'] = out.get('load_s', 0.0) + time.perf_counter() - t
    out['rss_peak_kb'], out['anon_peak_kb'] = peak['VmRSS'], peak['RssAnon']
    out['hwm_load_kb'] = status().get('VmHWM')
    return res


load.load_ld_from_schema = measured
if device == 'cuda':
    torch.zeros(1, device=device)       # the context, before any load
t = time.perf_counter()
frontend.main(argv)
out.update(fit_s=time.perf_counter() - t, hwm_kb=status().get('VmHWM'),
           hits=load.factor_cache_hits, misses=load.factor_cache_misses,
           bucket_matvec_multi=block_matvec.launches,
           prologue=compact_obj.launches['prologue'],
           delta_sums=compact_obj.launches['delta_sums'])
print('RESULT', json.dumps(out))
'''


def _gib(kb):
    return 'not reported' if kb is None else f'{kb / 2**20:.3f} GiB'


def rise(r, field):
    """How far a 14a-c run's `field` (rss, anon) rose during the load."""
    before, peak = r[f'{field}_before_kb'], r[f'{field}_peak_kb']
    return None if before is None else peak - before


def run_fit_process(argv, device, draws=True):
    """One CLI fit in a fresh process (_FIT_WORKER); returns its RESULT."""
    proc = subprocess.run(
        [sys.executable, '-c', _FIT_WORKER, json.dumps(argv), device,
         '0' if draws else '1', REPO], capture_output=True, text=True,
        timeout=600)
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith('RESULT ')]
    require(proc.returncode == 0 and lines,
            f'fit process failed ({proc.returncode}): '
            f'{proc.stderr[-3000:]}')
    return json.loads(lines[-1][len('RESULT '):])


def differing_outputs(a, b):
    """The output files (.npz members by their bits, .estimates.tsv and
    .covariance.pkl by their bytes) in which two fit prefixes differ."""
    diff = []
    with np.load(a + '.npz') as za, np.load(b + '.npz') as zb:
        if sorted(za.files) != sorted(zb.files):
            return ['the .npz members']
        for key in za.files:
            x, y = za[key], zb[key]
            if (x.dtype, x.shape) != (y.dtype, y.shape) or (
                    x.tobytes() != y.tobytes()):
                diff.append(key)
    for ext in ('.estimates.tsv', '.covariance.pkl'):
        with open(a + ext, 'rb') as fa, open(b + ext, 'rb') as fb:
            if fa.read() != fb.read():
                diff.append(ext)
    return diff


def run_factor_cache(paths, out_dir, device, num_blocks, cache):
    """Phases 14a-c: phase 4's fit with --factor-cache in a fresh
    directory (cold: a miss for every block), the same command again
    (warm: a hit for every block), and warm with --mmap (the spill). 14b
    and 14c write the same bits as 14a. The reference's mmap-mode RNG
    draws would move the mixture grid (its draws follow the load), so
    14c runs with them switched off and its grid is 14a's: the spill
    alone differs. `cache` is the cache directory, not made yet.
    Returns {run: RESULT}."""
    runs, prefixes = {}, {}
    for run, flags in (('14a', []), ('14b', []), ('14c', ['--mmap'])):
        prefixes[run] = os.path.join(out_dir, f'cache_{run}')
        argv = (fit_argv(*paths[:3], prefixes[run], device) + F32_BF16
                + ['--num-its', FACTOR_ITS, '--factor-cache', cache]
                + flags)
        runs[run] = r = run_fit_process(argv, device, draws=run != '14c')
        want = ((0, num_blocks) if run == '14a' else (num_blocks, 0))
        require((r['hits'], r['misses']) == want,
                f'{run}: {r["hits"]} factor-cache hits and {r["misses"]} '
                f'misses, expected {want}')
        if device == 'cuda':
            require_launched(r, ('bucket_matvec_multi', 'prologue',
                                 'delta_sums'), run)
        if run != '14a':
            diff = differing_outputs(prefixes['14a'], prefixes[run])
            require(not diff, f'{run}: outputs differ from 14a\'s: {diff}')
            remove_outputs(prefixes[run])
    check_fit_outputs(prefixes['14a'], paths[3], K=582)
    return runs, prefixes['14a'] + '.covariance.pkl'


class plain_matvec:
    """Context manager running the matvec's plain version (on the card's
    tensors) wherever the port calls the kernel. Its backward is, by
    default, the plain version on the incoming gradient (what the
    kernel's backward computes: the operator is symmetric); with
    own_autograd=True it is torch's autograd of the plain version, which
    rounds to bf16 at other places (U^T g and the product, where the
    kernel rounds g and s U^T g)."""

    def __init__(self, own_autograd=False):
        self.own_autograd = own_autograd

    def __enter__(self):
        import torch
        from vilma_tpu_torch.ops.cuda import block_matvec as bm
        self.bm, self.real = bm, bm.bucket_matvec_multi
        plain = bm.bucket_matvec_multi_plain

        class Plain(torch.autograd.Function):
            @staticmethod
            def forward(ctx, u, s, d, x):
                ctx.save_for_backward(u, s, d)
                return plain(u, s, d, x)

            @staticmethod
            def backward(ctx, grad):
                u, s, d = ctx.saved_tensors
                return None, None, None, plain(u, s, d, grad)

        bm.bucket_matvec_multi = plain if self.own_autograd else Plain.apply
        return self

    def __exit__(self, *exc):
        self.bm.bucket_matvec_multi = self.real


def elbo_gradients(data, st):
    """The gradient of -ELBO with respect to the gradient tool's three
    parameter leaves, at a state's materialized parameters."""
    import torch
    from vilma_tpu_torch.inference import gradient
    params, sigma, scaling = gradient.initial_params(data, st)
    loss = -gradient.elbo_of(data, sigma, scaling, params)
    leaves = (params.vi_mu, params.delta_logits, params.hyper_logits)
    return [g.detach() for g in torch.autograd.grad(loss, leaves)]


def run_gradient_tool(paths, cache, cov_path, device, steps=GRAD_STEPS):
    """Phase 14d: the gradient tool from phase 4's initialized state (the
    LD from the warm cache): its ELBO gradient through the kernel and its
    autograd backward against the plain version's on the same state
    (each leaf, relative to its largest element; plain_matvec), the gap
    between that and torch's autograd of the plain version logged, then
    `steps` Adam steps. Returns a dict."""
    import torch
    from vilma_tpu_torch.inference import engine, gradient
    from vilma_tpu_torch.io import load
    from vilma_tpu_torch.ops.cuda import block_matvec as bm
    schema, sumstats, extract, n = paths
    variants = load.load_variant_list(extract)
    ld, _ = load.load_ld_from_schema(
        schema, variants, [], 1.0, dtype=torch.float32,
        u_dtype=torch.bfloat16, cache_dir=cache, device=device)
    tables = [load.load_sumstats(p, variants)[0] for p in sumstats]
    with open(cov_path, 'rb') as fh:
        covs = pickle.load(fh)[0]
    np.random.seed(42)
    vi = engine.MultiPopVI(
        marginal_effects=np.array([t['BETA'] for t in tables], np.float32),
        std_errs=np.array([t['SE'] for t in tables], np.float32),
        ld_mats=[ld, ld], mixture_covs=covs, annotations=np.ones((n, 1)),
        checkpoint=False, gwas_N=np.full(2, 1e5), init_hg=np.full(2, 0.3),
        num_its=1, dtype=torch.float32, device=device)
    st0 = vi._initialize()
    out = dict(K=vi.num_mix, n=n)
    got = elbo_gradients(vi.data, st0)
    with plain_matvec():
        want = elbo_gradients(vi.data, st0)
    out['grad_err'] = [max_err(g, w)[1] for g, w in zip(got, want)]
    require(all(e <= BAND_BF16 for e in out['grad_err']),
            f'ELBO gradient through the kernel vs the plain version: '
            f'scaled errors {out["grad_err"]} (band {BAND_BF16:.1e})')
    with plain_matvec(own_autograd=True):
        auto = elbo_gradients(vi.data, st0)
    out['autograd_gap'] = [max_err(a, w)[1] for a, w in zip(auto, want)]
    del got, want, auto
    _sync(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    bm.launches_backward = 0
    # each step ends in the trace's fetch, so the host clock at each
    # step's start splits the run into steps without more syncs
    starts, real = [], gradient.elbo_of

    def stamped(*a):
        starts.append(time.perf_counter())
        return real(*a)

    gradient.elbo_of = stamped
    t = time.perf_counter()
    try:
        _, trace = gradient.fit_elbo_gradient(vi.data, st0, num_steps=steps,
                                              learning_rate=GRAD_LR)
        _sync(device)
    finally:
        gradient.elbo_of = real
    step_s = np.diff(starts + [time.perf_counter()])
    out.update(setup_s=starts[0] - t, step_s=step_s.tolist(),
               s_per_step=float(np.median(step_s[1:])), trace=trace,
               peak=torch.cuda.max_memory_allocated(),
               counts=read_counts(), backward=bm.launches_backward)
    require(all(math.isfinite(v) for v in trace), 'non-finite ELBO trace')
    require(trace[-1] > trace[0], f'the ELBO trace did not rise: {trace}')
    require(out['backward'] > 0, 'no matvec launch in the backward')
    if device == 'cuda':
        require_launched(out['counts'], ('bucket_matvec_multi',),
                         'phase 14d')
    return out


def validation_problem(n, seed, covs, spike):
    """tests/test_validation.py's 8-SNP blocks: the AR(1) LD, effects,
    marginal estimates and the port's VI answer (host, f64), as
    (ld, betas, se, covs, VI posterior means, VI weights)."""
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops import blocks
    rng = np.random.default_rng(seed)
    ld = 0.4 ** np.abs(np.subtract.outer(np.arange(n), np.arange(n)))
    se = np.full((1, n), 0.05)
    if spike:
        true_beta = np.where(rng.random(n) < 0.3,
                             rng.standard_normal(n) * 0.1, 0.0)
    else:
        true_beta = rng.standard_normal(n) * 0.1
    betas = (ld @ true_beta + rng.standard_normal(n) * 0.05)[None]
    vi = engine.MultiPopVI(
        marginal_effects=betas, std_errs=se,
        ld_mats=[blocks.from_dense_blocks([ld], [np.arange(n)], n)],
        mixture_covs=covs, annotations=np.ones((n, 1)), checkpoint=False,
        gwas_N=np.array([1e4]), init_hg=np.array([0.3]), num_its=60,
        device='cpu')
    np.random.seed(0 if spike else 1)
    st = vi.optimize()
    return (ld, betas, se, np.asarray(covs), vi.real_posterior_mean(st),
            st.hyper_delta.numpy())


def run_samplers(device):
    """Phase 14e: annealed SMC on the spike-and-slab block (1500
    particles, 25 temperatures, as tests/test_validation.py) and a short
    NUTS chain on the spike-free one, their densities on the card; the
    means within BAND_SAMPLER of the VI answer. Returns a dict."""
    from vilma_tpu_torch.inference import mcmc
    out = {}
    ann = np.zeros(8, dtype=int)
    ld, betas, se, covs, vi_mean, w = validation_problem(
        8, 0, [np.eye(1) * 1e-6, np.eye(1) * 0.01, np.eye(1) * 0.05], True)
    t = time.perf_counter()
    smc = mcmc.smc_sample(
        mcmc.make_block_log_posterior(ld, betas, se, covs, w, ann,
                                      device=device),
        mcmc.mixture_prior_sampler(covs, w, ann, 1, device=device),
        num_particles=1500, num_steps=25, num_mcmc=5, seed=2,
        device=device)
    out['smc_s'] = time.perf_counter() - t
    out['smc_err'] = float(np.abs(smc.mean(0) - vi_mean).max()
                           / np.abs(betas).max())
    require(np.all(np.isfinite(smc)), 'non-finite SMC particles')
    ld, betas, se, covs, vi_mean, w = validation_problem(
        8, 3, [np.eye(1) * 0.01, np.eye(1) * 0.05], False)
    t = time.perf_counter()
    nuts = mcmc.nuts_sample(
        mcmc.make_block_log_posterior(ld, betas, se, covs, w, ann,
                                      device=device),
        np.zeros((1, 8)), num_samples=NUTS_SAMPLES, num_warmup=NUTS_WARMUP,
        seed=1, device=device)
    out['nuts_s'] = time.perf_counter() - t
    out['nuts_err'] = float(np.abs(nuts.mean(0) - vi_mean).max()
                            / np.abs(betas).max())
    require(np.all(np.isfinite(nuts)), 'non-finite NUTS draws')
    for name in ('smc', 'nuts'):
        require(out[f'{name}_err'] <= BAND_SAMPLER,
                f'{name} posterior means {out[f"{name}_err"]:.3f} of scale '
                f'from the VI answer (band {BAND_SAMPLER})')
    return out


F32_BF16 = ['--precision', 'f32', '--ld-precision', 'bf16']


# ---------------------------------------------------------------------------
# phase 15: sharded fits (--mesh, --distributed) on the card
# ---------------------------------------------------------------------------

class count_calls:
    """Context manager counting the calls of owner.name while active."""

    def __init__(self, owner, name):
        self.owner, self.name, self.calls = owner, name, 0

    def __enter__(self):
        self.real = real = getattr(self.owner, self.name)

        def counted(*a, **k):
            self.calls += 1
            return real(*a, **k)
        setattr(self.owner, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.real)


def counted_fit(paths, prefix, extra, devices=None):
    """run_fit on the card, counting the shard evaluations of the
    objective (engine._objective_terms calls: one per shard of each
    evaluation). Returns (counts, step seconds, host syncs, EM events,
    shard evaluations)."""
    schema, sumstats, extract, _ = paths
    return counted_argv(fit_argv(schema, sumstats, extract, prefix, 'cuda')
                        + list(extra), devices)


def counted_argv(argv, devices=None):
    """counted_fit of a CLI fit's argv."""
    from vilma_tpu_torch.inference import engine
    with count_calls(engine, '_objective_terms') as terms:
        out = run_argv(argv, 'cuda', devices)
    return out + (terms.calls,)


def keep_outputs(prefix, out_dir):
    """Move a fit's output files into out_dir; returns their new
    prefix."""
    kept = os.path.join(out_dir, os.path.basename(prefix))
    for ext in ('.npz', '.estimates.tsv', '.covariance.pkl'):
        os.replace(prefix + ext, kept + ext)
    return kept


def scaled_max_diff(got, want, chunk=1 << 22):
    """max |got - want| (in float64) over max |want| (at least 1e-30),
    taken over flat chunks of `chunk` elements: the whole arrays' value,
    with small temporaries (the outputs of phase 13a's shape hold 0.7e9
    elements a member)."""
    g, w = got.reshape(-1), want.reshape(-1)
    diffs, tops = [0.0], [0.0]
    for i in range(0, w.size, chunk):
        d = g[i:i + chunk].astype(np.float64)
        d -= w[i:i + chunk]
        diffs.append(np.max(np.abs(d)))
        tops.append(np.max(np.abs(w[i:i + chunk])))
    return float(np.max(diffs)) / max(float(np.max(tops)), 1e-30)


def output_errors(got, want):
    """Per output of two fit prefixes, max |got - want| over max |want|:
    each .npz member and the posterior columns of .estimates.tsv; the
    .covariance.pkl bytes and the other columns must be equal."""
    errs = {}
    with np.load(got + '.npz') as zg, np.load(want + '.npz') as zw:
        require(sorted(zg.files) == sorted(zw.files),
                f'.npz members {zg.files} vs {zw.files}')
        for key in zw.files:
            g, w = zg[key], zw[key]
            require(g.shape == w.shape and g.dtype == w.dtype,
                    f'{key}: {g.shape} {g.dtype} vs {w.shape} {w.dtype}')
            errs[key] = scaled_max_diff(g, w)
    with open(got + '.estimates.tsv') as fg, open(want + '.estimates.tsv') \
            as fw:
        rows_g = [ln.rstrip('\n').split('\t') for ln in fg]
        rows_w = [ln.rstrip('\n').split('\t') for ln in fw]
    require(rows_g[0] == rows_w[0] and len(rows_g) == len(rows_w),
            'estimates headers or lengths differ')
    for j, col in enumerate(rows_w[0]):
        if col.startswith('posterior'):
            g = np.array([float(r[j]) for r in rows_g[1:]])
            w = np.array([float(r[j]) for r in rows_w[1:]])
            errs[col] = float(np.max(np.abs(g - w)) / np.max(np.abs(w)))
        else:
            require([r[j] for r in rows_g] == [r[j] for r in rows_w],
                    f'estimates column {col} differs')
    with open(got + '.covariance.pkl', 'rb') as fg, \
            open(want + '.covariance.pkl', 'rb') as fw:
        require(fg.read() == fw.read(), '.covariance.pkl differs')
    return errs


def check_sharded_fit(name, run, ref, shards, band):
    """A sharded CLI fit (`run`, counted_fit's result and its prefix)
    against the unsharded one (`ref`, the same) of the same command:
    every output within `band` of its scale, the same evaluations of the
    objective and host syncs per step, and each kernel launched `shards`
    times as often (once per shard where the unsharded fit launches once:
    the precompute's matvecs, every evaluation, every step's sums).
    Returns a dict of the readings."""
    (counts, step_s, syncs, em, terms), prefix = run
    (counts0, step0, syncs0, em0, terms0), prefix0 = ref
    errs = output_errors(prefix, prefix0)
    worst = max(errs.values())
    per_step, per_step0 = syncs / len(step_s), syncs0 / len(step0)
    evals, evals0 = terms / shards, terms0
    per_eval = {key: (counts[key] / evals, counts0[key] / evals0)
                for key in ('bucket_matvec_multi', 'prologue', 'delta_sums',
                            'prologue_kdim', 'delta_sums_kdim')
                if counts0[key]}
    log(f'  {name}: outputs against the unsharded run, of their scale: '
        + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
        + f' (band {band:.0e}); evaluations {evals} (unsharded {evals0}); '
        f'host syncs a step {per_step} ({per_step0}); launches {counts} '
        f'({counts0})')
    require(worst <= band, f'{name}: an output {worst:.2e} of its scale '
            f'from the unsharded run\'s (band {band:.0e})')
    require(per_step == per_step0,
            f'{name}: {per_step} host syncs a step, unsharded {per_step0}')
    require(evals == evals0, f'{name}: {evals} evaluations of the '
            f'objective, unsharded {evals0}')
    for key in ('bucket_matvec_multi', 'prologue', 'delta_sums',
                'prologue_kdim', 'delta_sums_kdim'):
        require(counts[key] == shards * counts0[key],
                f'{name}: {key} launched {counts[key]} times, unsharded '
                f'{counts0[key]} (x{shards} expected)')
    return dict(errs=errs, per=per_eval, syncs=(per_step, per_step0),
                em=(em, em0), step_s=(float(np.median(step_s)),
                                      float(np.median(step0))),
                counts=counts)


def check_sharded_small_fit(out_dir):
    """check_small_fit's 2-block schema fitted on the card at --mesh
    snp=2 (a block a shard, co-located, f32) against the host's
    unsharded f64 fit, without and with --learn-scaling (kdim): the
    sharded card fit must land within the band the unsharded card fit
    meets (BAND_FIT, BAND_FIT_SE). Returns {route: scaled errors}."""
    schema, sumstats, extract, _ = write_schema(out_dir, num_blocks=2)
    errs = {}
    for route, flags, band in (
            ('plain', [], BAND_FIT),
            ('kdim', ['--learn-scaling', '--num-its', SMALL_ITS_SE],
             BAND_FIT_SE)):
        runs = {}
        for tag, device, precision, devices in (
                ('host', 'cpu', 'f64', None),
                ('card', 'cuda', 'f32', ['cuda:0'] * 2)):
            prefix = os.path.join(out_dir, f'small_{route}_{tag}')
            run_argv(fit_argv(schema, sumstats, extract, prefix, device)
                     + ['-K', '3', '--precision', precision,
                        '--ld-precision', 'f32' if precision == 'f32'
                        else 'auto'] + flags
                     + (['--mesh', 'snp=2'] if devices else []),
                     device, devices)
            runs[tag] = read_posteriors(prefix)
        err = (np.abs(runs['card'] - runs['host']).max(axis=0)
               / np.abs(runs['host']).max(axis=0))
        require(np.all(err <= band),
                f'{route}: sharded card fit vs host f64 fit: scaled errors '
                f'{err} exceed {band:.0e}')
        errs[route] = err
    return errs


def run_sharded_epoch(vi, st, ld, steps=EPOCH_STEPS, shards=EPOCH_SHARDS,
                      n_comp=1, name='phase 15b epoch'):
    """Phase 15b's epoch state (16d's with n_comp > 1): phase 7's state
    at 1M SNPs stepped `steps` times unsharded and on `shards` snp shards
    by n_comp comp shards co-located on cuda:0 (the LD relaid out in the
    shard-local layout, the state carried into it); ELBO and posterior
    means against each other, seconds a step of each, the sharded run's
    launches: each epoch kernel (its K-split forms and merges under comp)
    once per shard where the unsharded run launches it once."""
    import torch
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.parallel import alignment, mesh as mesh_mod
    out = {}
    zero_counts()
    stU, ips0, syncs0, pmU = timed_steps(vi.data, st, steps)
    counts0 = read_counts()
    t0 = time.perf_counter()
    total = shards * n_comp
    mesh = mesh_mod.make_mesh(shards, n_comp=n_comp,
                              devices=['cuda:0'] * total)
    n = ld.n
    lmap, L, ok = alignment.compute_layout([ld], n, n_shards=shards)
    require(ok, 'no shard-local layout for phase 7\'s LD')
    ld_s = alignment.relayout_ld(ld, lmap, L, dtype=torch.float32,
                                 u_dtype=torch.bfloat16, n_shards=shards,
                                 device=list(mesh.devices),
                                 shards=list(mesh.snp_shards))
    inp = vi.inputs
    vi_s = engine.MultiPopVI(
        marginal_effects=alignment.relayout_rows(inp['betas'], lmap, L),
        std_errs=alignment.relayout_rows(inp['std_errs'], lmap, L,
                                         fill=1.0),
        ld_mats=[ld_s, ld_s],
        annotations=alignment.relayout_annotations(np.ones((n, 1)), lmap,
                                                   L),
        mixture_covs=inp['covs'], checkpoint=False, gwas_N=np.full(2, 1e5),
        init_hg=np.full(2, 0.3), num_its=1, scale_se=True,
        dtype=torch.float32, mesh=mesh, out_index=lmap)
    require(vi_s._epoch, 'the sharded fit did not take the epoch state')

    def spread(x):
        full = x.new_zeros(tuple(x.shape[:-1]) + (L,))
        full[..., torch.as_tensor(lmap, device=x.device)] = x
        return full

    st_s = mesh_mod.shard_state(engine.dataclasses.replace(
        st, nat_mu=spread(st.nat_mu), nat_hist=spread(st.nat_hist)), mesh)
    _sync('cuda')
    out['setup_s'] = time.perf_counter() - t0
    zero_counts()
    stS, ips, syncs, pmS = timed_steps(vi_s.data, st_s, steps)
    out['counts'] = read_counts()
    pmS = mesh.gather_spans(pmS).cpu().numpy()[:, lmap]
    pmU = pmU.cpu().numpy()
    out['pm_err'] = float(np.max(np.abs(pmS - pmU)) / np.max(np.abs(pmU)))
    out['elbo_err'] = abs(stS.elbo / stU.elbo - 1)
    out.update(s_step=1 / ips, s_step0=1 / ips0, syncs=syncs, syncs0=syncs0,
               counts0=counts0, L=L, nat_hist_n=(stS.nat_hist_n,
                                                 stU.nat_hist_n))
    for key in ('pm_err', 'elbo_err'):
        require(out[key] <= BAND_SHARD, f'{name}: {key} '
                f'{out[key]:.2e} (band {BAND_SHARD:.0e})')
    require(syncs == syncs0, f'{name}: {syncs} host syncs a step, '
            f'unsharded {syncs0}')
    pairs = ([('bucket_matvec_multi', 'bucket_matvec_multi')]
             + comp_pairs('epochs') if n_comp > 1 else
             [(k, k) for k in ('bucket_matvec_multi', 'prologue_epochs',
                               'delta_sums_epochs')])
    for key, key0 in pairs:
        require(out['counts'][key] == total * counts0[key0] > 0,
                f'{name}: {key} launched {out["counts"][key]} times, '
                f'unsharded {key0} {counts0[key0]} (x{total} expected)')
    del vi_s, st_s, stS, ld_s
    torch.cuda.empty_cache()
    return out


# phase 15c-d and 17c: `fit --distributed` in fresh processes (argv JSON,
# the repo); prints RESULT and a JSON object: the process group's backend,
# world size and rank as the fit leaves the group (distributed.shutdown,
# with its barrier), whether it is gone after the fit, the launches
_DIST_WORKER = r'''
import json, sys
sys.path.insert(0, sys.argv[2])
import torch
import torch.distributed as dist
from vilma_tpu_torch import frontend
from vilma_tpu_torch.ops.cuda import block_matvec, compact_obj
from vilma_tpu_torch.parallel import distributed

left, leave = [], distributed.shutdown


def shutdown(barrier=True):
    left.append(dict(backend=dist.get_backend(), world=dist.get_world_size(),
                     rank=dist.get_rank(), barrier=barrier))
    leave(barrier)


distributed.shutdown = shutdown
frontend.main(json.loads(sys.argv[1]))
out = dict(left[0], shutdowns=len(left), destroyed=not dist.is_initialized(),
           bucket_matvec_multi=block_matvec.launches, **compact_obj.launches)
print('RESULT', json.dumps(out))
'''


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        return sock.getsockname()[1]


def start_distributed(argv, nproc, n_snp):
    """`fit --distributed` started in nproc processes over NCCL on
    localhost, one card each (stop_background kills them at exit)."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, '-c', _DIST_WORKER, json.dumps(
            argv + ['--distributed', '--coordinator', f'localhost:{port}',
                    '--num-processes', str(nproc), '--process-id',
                    str(rank), '--mesh', f'snp={n_snp}']), REPO],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(nproc)]
    BACKGROUND.extend(procs)
    return procs


def run_distributed(argv, nproc, n_snp, procs=None):
    """`fit --distributed` in nproc processes (start_distributed's, or
    `procs` started by it); returns their RESULTs (a failed process fails
    the phase)."""
    if procs is None:
        procs = start_distributed(argv, nproc, n_snp)
    results = []
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            out, err = proc.communicate()
        lines = [ln for ln in out.splitlines() if ln.startswith('RESULT ')]
        require(proc.returncode == 0 and lines,
                f'fit --distributed process failed ({proc.returncode}): '
                f'{err[-3000:]}')
        results.append(json.loads(lines[-1][len('RESULT '):]))
    return results


def run_phase15(paths, p4, vi7, st7, ld7, out_dir, cache, launches, smi):
    """Phase 15a-b: sharded fits on the card (15c-d: run_phase15c, after
    phase 17c). p4 is phase 4's (counted_fit
    result, kept output prefix); vi7, st7 and ld7 phase 7's engine, final
    state and LD; `cache` the factor cache of phase 4's panel (phase 14
    fills it; a load through it writes the uncached load's bits, phase
    14b). Adds the sharded runs' launches to `launches`; returns the
    readings."""
    out = {}
    devices = ['cuda:0'] * SHARDS
    phase(f'phase 15a: phase 4\'s fit at --mesh snp={SHARDS}, the shards '
          'co-located on cuda:0')
    prefix = os.path.join(out_dir, 'mesh_fit')
    t0 = time.perf_counter()
    run = counted_fit(paths, prefix, F32_BF16 + [
        '--factor-cache', cache, '--mesh', f'snp={SHARDS}'], devices)
    out['15a'] = r = check_sharded_fit('15a', (run, prefix), p4, SHARDS,
                                       BAND_SHARD)
    out['15a']['seconds'] = time.perf_counter() - t0
    log(f'  launches {r["counts"]}; per evaluation of the objective, '
        f'sharded vs unsharded {r["per"]}; host syncs a step '
        f'{r["syncs"]}; median seconds a step sharded / unsharded '
        f'{r["step_s"][0]:.4f} / {r["step_s"][1]:.4f}; {smi}')
    for key in ('bucket_matvec_multi', 'prologue', 'delta_sums'):
        launches[key] += r['counts'][key]
    remove_outputs(prefix)
    with tempfile.TemporaryDirectory() as small:
        out['small'] = errs = check_sharded_small_fit(small)
    log('  2-block fit at --mesh snp=2, card f32 vs host f64 unsharded, '
        'scaled errors (pm1, pm2, pv1, pv2): '
        + '; '.join(f'{k} {v}' for k, v in errs.items())
        + f' (bands {BAND_FIT:.0e}, {BAND_FIT_SE:.0e}, as for the '
        'unsharded card fit)')

    phase(f'phase 15b: phase 6\'s --learn-scaling fit, {KDIM_STEPS} '
          f'steps, unsharded and at --mesh snp={SHARDS} (kdim), then '
          f'phase 7\'s epoch state at {EPOCH_SHARDS} shards')
    flags = F32_BF16 + ['--learn-scaling', '--num-its', str(KDIM_STEPS),
                        '--factor-cache', cache]
    runs = {}
    for tag, extra, where in (('fit_se', [], None),
                              ('mesh_fit_se', ['--mesh', f'snp={SHARDS}'],
                               devices)):
        prefix = os.path.join(out_dir, tag)
        with record_elbos() as rec:
            runs[tag] = ((counted_fit(paths, prefix, flags + extra, where),
                          prefix), rec.values)
    out['15b'] = r = check_sharded_fit(
        '15b kdim', runs['mesh_fit_se'][0], runs['fit_se'][0], SHARDS,
        BAND_SHARD)
    gaps = [abs(a / b - 1) for a, b in zip(runs['mesh_fit_se'][1],
                                           runs['fit_se'][1])]
    log(f'  kdim: per evaluation, sharded vs unsharded {r["per"]}; host '
        f'syncs a step {r["syncs"]}; ELBO gap each step '
        f'{[float(f"{g:.1e}") for g in gaps]}; median seconds a step '
        f'sharded / unsharded {r["step_s"][0]:.4f} / {r["step_s"][1]:.4f}; '
        f'{smi}')
    for key in ('bucket_matvec_multi', 'prologue_kdim', 'delta_sums_kdim'):
        launches[key] += r['counts'][key]
    # phase 16a compares its comp-sharded kdim fit with the unsharded one
    remove_outputs(os.path.join(out_dir, 'mesh_fit_se'))
    out['kdim_ref'] = runs['fit_se'][0]
    e = run_sharded_epoch(vi7, st7, ld7)
    out['15b_epoch'] = e
    log(f'  epoch: 1,000,448 SNPs in {e["L"]} slots on {EPOCH_SHARDS} '
        f'shards (set-up {e["setup_s"]:.1f} s); {EPOCH_STEPS} steps from '
        f'phase 7\'s state: posterior means {e["pm_err"]:.2e} of scale, '
        f'ELBO {e["elbo_err"]:.2e} from the unsharded steps (band '
        f'{BAND_SHARD:.0e}); seconds a step sharded {e["s_step"]:.4f}, '
        f'unsharded {e["s_step0"]:.4f}; host syncs a step {e["syncs"]} '
        f'and {e["syncs0"]}; live epochs {e["nat_hist_n"]}; launches '
        f'{e["counts"]} (unsharded {e["counts0"]}); {smi}')
    for key in ('bucket_matvec_multi', 'prologue_epochs',
                'delta_sums_epochs'):
        launches[key] += e['counts'][key]
    return out


def start_phase15c(paths, out_dir, cache):
    """Phase 15c's process, started (it runs beside phase 17c's): phase
    4's fit with --distributed, one process, --mesh snp=1, NCCL. Returns
    what run_phase15c takes."""
    schema, sumstats, extract, _ = paths
    prefix = os.path.join(out_dir, 'dist_fit')
    argv = fit_argv(schema, sumstats, extract, prefix, 'cuda') + F32_BF16 \
        + ['--factor-cache', cache]
    return argv, prefix, time.perf_counter(), start_distributed(argv, 1, 1)


def run_phase15c(paths, p4, out_dir, cache, started):
    """Phases 15c (its process `started` by start_phase15c) and 15d, with
    two cards. Returns the readings."""
    import torch
    out = {}
    argv, prefix, t0, procs = started
    schema, sumstats, extract, _ = paths
    phase('phase 15c: fit --distributed, one process, --mesh snp=1, NCCL')
    (res,) = run_distributed(argv, 1, 1, procs)
    out['15c'] = res
    differ = differing_outputs(prefix, p4[1])
    log(f'  process group backend {res["backend"]}, world {res["world"]}; '
        f'{time.perf_counter() - t0:.1f} s; launches {res}; outputs '
        f'against phase 4\'s: '
        f'{"bit for bit" if not differ else f"{differ} differ"}')
    require(res['backend'] == 'nccl', f'backend {res["backend"]}')
    require(res['shutdowns'] == 1 and res['barrier'] and res['destroyed'],
            f'phase 15c: the fit did not leave its process group once '
            f'after a barrier: {res}')
    # one shard: the layout is the identity, the LD the unsharded load's
    # bits, every sum the unsharded fit's
    require(not differ, f'phase 15c: {differ} differ from phase 4\'s')
    for key in ('bucket_matvec_multi', 'prologue', 'delta_sums'):
        require(res[key] > 0, f'phase 15c never launched {key}')

    if torch.cuda.device_count() >= 2:
        phase('phase 15d: fit --distributed, two processes over NCCL, one '
              'card each, --mesh snp=2')
        prefix2 = os.path.join(out_dir, 'dist_fit2')
        argv2 = fit_argv(schema, sumstats, extract, prefix2, 'cuda') \
            + F32_BF16 + ['--factor-cache', cache]
        res2 = run_distributed(argv2, 2, 2)
        errs = output_errors(prefix2, prefix)
        worst = max(errs.values())
        log(f'  ranks {[(r["rank"], r["backend"]) for r in res2]}; '
            f'outputs against 15c\'s, of their scale: max {worst:.2e} '
            f'(band {BAND_SHARD:.0e}); launches {res2}')
        require(worst <= BAND_SHARD, f'phase 15d: outputs {worst:.2e} '
                'from 15c\'s')
        out['15d'] = dict(errs=errs, results=res2)
        remove_outputs(prefix2)
    else:
        print('phase 15d not run: 1 card', flush=True)
    remove_outputs(prefix)
    return out


def comp_pairs(form):
    """(K-split kernel, the whole-K kernel it stands in for) of a form:
    under comp each shard launches the first as often as an unsharded
    fit launches the second."""
    whole = {'shared': ('prologue', 'delta_sums'),
             'kdim': ('prologue_kdim', 'delta_sums_kdim'),
             'epochs': ('prologue_epochs', 'delta_sums_epochs')}[form]
    part, norm, given = SPLIT_KEYS[form]
    return [(part, whole[0]), ('prologue_merge', whole[0]),
            (norm, whole[1]), (given, whole[1])]


def check_comp_fit(name, run, ref, shards, form, band=BAND_SHARD):
    """A comp-sharded CLI fit (`run`, counted_fit's result and its
    prefix) against the unsharded one (`ref`) of the same command: every
    output within `band` of its scale, the same evaluations of the
    objective and host syncs per step, the matvec launched `shards` times
    as often, no whole-K compact kernel, and each K-split kernel and
    merge once per shard where the unsharded fit launches the whole-K
    kernel it stands in for. Returns the readings."""
    (counts, step_s, syncs, em, terms), prefix = run
    (counts0, step0, syncs0, em0, terms0), prefix0 = ref
    errs = output_errors(prefix, prefix0)
    worst = max(errs.values())
    per_step, per_step0 = syncs / len(step_s), syncs0 / len(step0)
    evals = terms / shards
    pairs = [('bucket_matvec_multi', 'bucket_matvec_multi')] + comp_pairs(
        form)
    log(f'  {name}: outputs against the unsharded run, of their scale: '
        + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
        + f' (band {band:.0e}); evaluations {evals} (unsharded {terms0}); '
        f'host syncs a step {per_step} ({per_step0}); launches per shard '
        + str({k: counts[k] / shards for k, _ in pairs})
        + f' (unsharded {dict((k0, counts0[k0]) for _, k0 in pairs)})')
    require(worst <= band, f'{name}: an output {worst:.2e} of its scale '
            f'from the unsharded run\'s (band {band:.0e})')
    require(per_step == per_step0,
            f'{name}: {per_step} host syncs a step, unsharded {per_step0}')
    require(evals == terms0, f'{name}: {evals} evaluations of the '
            f'objective, unsharded {terms0}')
    for key, key0 in pairs:
        require(counts[key] == shards * counts0[key0] > 0,
                f'{name}: {key} launched {counts[key]} times, unsharded '
                f'{key0} {counts0[key0]} (x{shards} expected)')
    whole = [k for k in ('prologue', 'delta_sums', 'prologue_kdim',
                         'delta_sums_kdim', 'prologue_epochs',
                         'delta_sums_epochs') if counts[k]]
    require(not whole, f'{name} launched whole-K kernels {whole}')
    return dict(errs=errs, syncs=(per_step, per_step0),
                step_s=(float(np.median(step_s)), float(np.median(step0))),
                counts=counts)


class capture_fit:
    """The MultiPopVI of the fits run inside (its optimize wrapped)."""

    def __enter__(self):
        from vilma_tpu_torch.inference import engine
        self.owner, self.real = engine.MultiPopVI, engine.MultiPopVI.optimize
        self.fits = []
        real, fits = self.real, self.fits

        def optimize(vi, *a, **k):
            fits.append(vi)
            return real(vi, *a, **k)
        self.owner.optimize = optimize
        return self

    def __exit__(self, *exc):
        self.owner.optimize = self.real


# the K-split launchers the engine calls under comp (the kdim forms go
# through prologue_partial, delta_norm and delta_sums_given)
COMP_WRAPPERS = ('prologue_partial', 'prologue_epochs_partial',
                 'prologue_merge', 'delta_norm', 'delta_norm_epochs',
                 'delta_sums_given', 'delta_sums_epochs_given')


def kernel_key(name):
    """A trace's kernel name without its argument list: the port's
    kernels with their template arguments, others by function name."""
    name = name.replace('void ', '').replace('(anonymous namespace)::', '')
    name = name.split('(')[0].strip()
    if name.startswith('vilma::'):
        return name[len('vilma::'):]
    return name.split('<')[0].split('::')[-1]


def trace_comp_steps(vi, shards, steps=3):
    """Phase 16a's trace: from a comp-sharded fit's final state, `steps`
    outer steps on the host clock with each K-split launcher's host time
    summed (time_calls, unsynchronized), then `steps` more under
    torch.profiler (CPU
    and CUDA). Returns the busy share, the traced wall ms, the
    evaluations a step, each kernel's device ms and launches per
    evaluation, and each launcher's host us a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.ops.cuda import compact_obj
    data, st = vi.data, vi.state
    _sync('cuda')
    with time_calls(sync=False, **{n: (compact_obj, n)
                                   for n in COMP_WRAPPERS}) as tw:
        for _ in range(steps):
            st, _ = engine.outer_step(data, st)
        _sync('cuda')
    with count_calls(engine, '_objective_terms') as terms, \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        with record_function('outer_steps'):
            for _ in range(steps):
                st, _ = engine.outer_step(data, st)
            _sync('cuda')
    wall, busy, per_kernel = timeline(trace_events(prof))
    evals = terms.calls / shards
    short = {}
    for name, (ms, n) in per_kernel.items():
        k = short.setdefault(kernel_key(name), [0.0, 0])
        k[0] += ms
        k[1] += n
    return dict(
        busy=busy / wall, wall_ms=wall, evals_per_step=evals / steps,
        device={k: (ms / evals, n / evals) for k, (ms, n) in short.items()},
        host_us={k: (t / n * 1e6, n) for k, (t, n) in tw.spent.items()
                 if n})


def run_comp_chunked(device, c12, M=4, num_blocks=98, steps=2):
    """Phase 16b: phase 12's shape (100,352 SNPs, 3 cohorts, 42,999
    components) at comp = M, the shards co-located on cuda:0: the K-split
    kernels against the whole-K kernels and the plain versions at one
    point, then MultiPopVI.optimize's initialization and `steps` steps;
    the ELBO against phase 12's (`c12`)."""
    import torch
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.models import mixture
    from vilma_tpu_torch.parallel import alignment, mesh as mesh_mod
    ld = device_ld(num_blocks, 1024, 512, device)
    n = ld.n
    check_split(device, {}, A=1, M=M,
                shapes=(('shared', 3, CHUNKED_K, n, None),), timed=False)
    rng = np.random.default_rng(11)
    std_errs = rng.uniform(0.01, 0.05, (3, n)).astype(np.float32)
    betas = (rng.standard_normal((3, n)) * std_errs * 2).astype(np.float32)
    np.random.seed(42)
    covs = mixture.make_simple(
        3, 12, *mixture.effect_size_ranges(betas, std_errs, False),
        drop_non_psd=True)
    mesh = mesh_mod.make_mesh(1, n_comp=M, devices=['cuda:0'] * M)
    lmap, L, ok = alignment.compute_layout([ld], n, n_shards=1)
    require(ok and L == n, f'phase 16b layout: {L} slots for {n} SNPs')
    ld_s = alignment.relayout_ld(ld, lmap, L, dtype=torch.float32,
                                 u_dtype=torch.bfloat16, n_shards=1,
                                 device=list(mesh.devices),
                                 shards=list(mesh.snp_shards))
    del ld
    vi = engine.MultiPopVI(
        marginal_effects=alignment.relayout_rows(betas, lmap, L),
        std_errs=alignment.relayout_rows(std_errs, lmap, L, fill=1.0),
        ld_mats=[ld_s] * 3,
        annotations=alignment.relayout_annotations(np.ones((n, 1)), lmap,
                                                   L),
        mixture_covs=covs, checkpoint=False, gwas_N=np.full(3, 1e5),
        init_hg=np.full(3, 0.3), num_its=steps, dtype=torch.float32,
        mesh=mesh, out_index=lmap)
    st, out = timed_optimize(vi, device)
    out['slices'] = [s.hyper_delta.shape[1] for s in st.shards]
    out['elbo_err'] = abs(out['elbo'] / c12['elbo'] - 1)
    require(len(out['step_s']) == steps, f'{len(out["step_s"])} steps')
    require(out['elbo_err'] <= BAND_SHARD, f'phase 16b: ELBO '
            f'{out["elbo"]!r} against phase 12\'s {c12["elbo"]!r}')
    require_launched(out['counts'], ('bucket_matvec_multi',)
                     + SPLIT_KEYS['shared'] + MERGE_KEYS, 'phase 16b')
    del vi, st, ld_s
    torch.cuda.empty_cache()
    return out


def run_phase16(paths, p4, kdim_ref, trait, c12, vi7, st7, ld7, out_dir,
                cache, launches, smi):
    """Phase 16: component sharding, the shards co-located on cuda:0.
    p4 and kdim_ref are phase 4's and 15b's unsharded kdim run
    (counted_fit result, kept output prefix); `trait` phase 13a's
    (schema paths, kept output prefix, K); c12 phase 12's readings; vi7,
    st7 and ld7 phase 7's engine, state and LD. Adds the runs' launches
    to `launches`; returns the readings."""
    import torch
    from vilma_tpu_torch.ops.cuda import compact_obj
    out = {}
    for key in list(SPLIT_KEYS['shared'] + SPLIT_KEYS['kdim']
                    + SPLIT_KEYS['epochs'] + MERGE_KEYS):
        launches.setdefault(key, 0)
    devices = ['cuda:0'] * 4
    phase('phase 16a: phase 4\'s fit at --mesh comp=2,snp=2, then phase '
          f'6\'s flags for {KDIM_STEPS} steps (kdim)')
    for tag, form, extra, ref in (
            ('16a', 'shared', [], p4),
            ('16a kdim', 'kdim', ['--learn-scaling', '--num-its',
                                  str(KDIM_STEPS)], kdim_ref)):
        prefix = os.path.join(out_dir, 'comp_fit')
        with capture_fit() as cap:
            run = counted_fit(paths, prefix, F32_BF16 + extra + [
                '--factor-cache', cache, '--mesh', 'comp=2,snp=2'], devices)
        out[tag] = r = check_comp_fit(tag, (run, prefix), ref, 4, form)
        log(f'  {tag}: median seconds a step comp / unsharded '
            f'{r["step_s"][0]:.4f} / {r["step_s"][1]:.4f}; the K-split '
            f'kernels at 291 components a slice; {smi}')
        for key in SPLIT_KEYS[form] + MERGE_KEYS + ('bucket_matvec_multi',):
            launches[key] += r['counts'][key]
        remove_outputs(prefix)
        if form == 'shared':
            t = r['trace'] = trace_comp_steps(cap.fits[-1], 4)
            top = sorted(t['device'].items(), key=lambda kv: -kv[1][0])
            log(f'  {tag} traced (3 steps from the fit\'s state): busy share '
                f'{t["busy"]:.3f} of {t["wall_ms"]:.3f} ms, '
                f'{t["evals_per_step"]:.2f} evaluations a step; device ms '
                'and launches per evaluation (4 shards): '
                + '; '.join(f'{k} {ms:.4f} ({n:.2f}x)' for k, (ms, n) in top)
                + '; host us a call (calls): '
                + '; '.join(f'{k} {us:.1f} ({n})'
                            for k, (us, n) in t['host_us'].items()))
        del cap

    phase('phase 16b: phase 12\'s shape (42,999 components, 3 cohorts) at '
          '--mesh comp=4')
    b = out['16b'] = run_comp_chunked('cuda', c12)
    log(f'  slices {b["slices"]}; initialization {b["init_s"]:.3f} s, peak '
        f'{b["init_peak"] / 2**30:.2f} GiB (phase 12: {c12["init_s"]:.3f} '
        f's); steps {[round(t, 4) for t in b["step_s"]]} s, '
        f'{b["s_per_iter"]:.3f} s/iter (phase 12: {c12["s_per_iter"]:.3f}) '
        f'({b["syncs"]:.1f} host syncs per step; phase 12 '
        f'{c12["syncs"]:.1f}), peak {b["step_peak"] / 2**30:.2f} GiB; ELBO '
        f'{b["elbo"]!r} within {b["elbo_err"]:.2e} of phase 12\'s; '
        f'launches {b["counts"]}; {smi}')
    for key in SPLIT_KEYS['shared'] + MERGE_KEYS:
        launches[key] += b['counts'][key]

    phase('phase 16c: phase 13a\'s fit --trait of 4 traits at --mesh '
          'comp=2, 5 steps (the materialized state)')
    tpaths, tref, K = trait
    prefix = os.path.join(out_dir, 'comp_trait')
    argv = (trait_argv(tpaths, prefix, 'cuda', 3, STEPS_TRAIT) + F32_BF16
            + ['--no-save-vi-sigma', '--factor-cache', trait_cache(tpaths),
               '--mesh', 'comp=2'])
    with capture_fit() as cap:
        counts, step_s, syncs, _ = run_argv(argv, 'cuda', ['cuda:0'] * 2)
    errs = output_errors(prefix, tref)
    vi = cap.fits[-1]
    shards = vi.state.shards
    I, P = shards[0].vi_mu.shape[2], shards[0].vi_mu.shape[1]

    def nbytes(st):
        sig = sum(getattr(st.sigma, f).numel() for f in (
            'log_det_sigma', 'sigma_summary', 'diag', 'matches'))
        return (st.vi_mu.numel() * 4, st.vi_delta.numel() * 4, sig * 4)

    whole = (K * P * I * 4, K * I * 4, K * (3 + P) * I * 4)
    per = [nbytes(st) for st in shards]
    ratios = [[a / w for a, w in zip(p, whole)] for p in per]
    out['16c'] = dict(errs=errs, step_s=step_s, per_shard=per, whole=whole)
    log(f'  outputs against 13a\'s, of their scale: '
        + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
        + f' (band {BAND_SHARD:.0e}); steps {[round(t, 3) for t in step_s]} '
        f's ({syncs / len(step_s):.1f} host syncs per step); bytes of '
        f'(vi_mu, vi_delta, sigma summaries) per shard {per}, 13a\'s '
        f'{whole}: ratios {[[round(x, 4) for x in r] for r in ratios]}; '
        f'launches {counts}; {smi}')
    require(max(errs.values()) <= BAND_SHARD, f'phase 16c: outputs '
            f'{max(errs.values()):.2e} from 13a\'s')
    require(all(max(r) <= (K // 2 + 1) / K for r in ratios)
            and sum(p[0] for p in per) == whole[0],
            f'phase 16c: shard bytes {per} are not halves of {whole}')
    require(all(counts[k] == 0 for k in compact_obj.launches),
            f'phase 16c ran a compact kernel: {counts}')
    require_launched(counts, ('bucket_matvec_multi',
                              'bucket_matvec_multi_c4'), 'phase 16c')
    remove_outputs(prefix)
    del vi, shards, cap
    torch.cuda.empty_cache()

    phase('phase 16d: phase 7\'s epoch state (1M SNPs) at --mesh comp=2, '
          '3 steps')
    e = out['16d'] = run_sharded_epoch(vi7, st7, ld7, steps=3, shards=1,
                                       n_comp=2, name='phase 16d')
    log(f'  posterior means {e["pm_err"]:.2e} of scale, ELBO '
        f'{e["elbo_err"]:.2e} from the unsharded steps (band '
        f'{BAND_SHARD:.0e}); seconds a step comp {e["s_step"]:.4f}, '
        f'unsharded {e["s_step0"]:.4f}; host syncs a step {e["syncs"]} and '
        f'{e["syncs0"]}; launches {e["counts"]} (unsharded '
        f'{e["counts0"]}); {smi}')
    for key in SPLIT_KEYS['epochs'] + MERGE_KEYS:
        launches[key] += e['counts'][key]
    return out


def write_reversed_panel(schema):
    """Phase 17's second panel: a copy of `schema`'s blocks with the
    variant order reversed inside every block (the .var lines and the
    eigenvector rows of the .npy; its last row, the eigenvalues, stays).
    The two panels disagree on the order of shared variants, so no
    shard-local layout exists. Returns its .schema path."""
    root = os.path.dirname(schema)
    with open(schema) as fh:
        entries = [ln.split('\t') for ln in fh.read().splitlines() if ln]
    manifest = []
    for var, npy in entries:
        a = np.load(os.path.join(root, npy))
        np.save(os.path.join(root, 'rev_' + npy),
                np.vstack([a[:-1][::-1], a[-1:]]))
        with open(os.path.join(root, var)) as fh:
            rows = fh.read().splitlines()
        with open(os.path.join(root, 'rev_' + var), 'w') as fh:
            fh.write('\n'.join(rows[::-1]) + '\n')
        manifest.append(f'rev_{var}\trev_{npy}')
    rev = os.path.join(root, 'rev.schema')
    with open(rev, 'w') as fh:
        fh.write('\n'.join(manifest) + '\n')
    return rev


def gathered_argv(paths, rev, prefix, extra):
    """Phase 4's fit command with cohort 2 on the reversed panel."""
    schema, sumstats, extract, _ = paths
    argv = fit_argv(schema, sumstats, extract, prefix, 'cuda')
    argv[argv.index('--ld-schema') + 1] = f'{schema},{rev}'
    return argv + F32_BF16 + list(extra)


def gathered_readings(vi, n):
    """What phase 17 reads from a gathered fit's MultiPopVI: each shard's
    blocks per bucket of each panel, the bytes the mesh's gather and sum
    move in one evaluation (elbo_value), the pad slots' posterior means
    and vi_mu (materialized per column; zero where inert)."""
    from vilma_tpu_torch.inference import engine
    layouts = {ld.layout for d in vi._ds for ld in d.ld}
    blocks = [[[bk.num_blocks for bk in ld.buckets] for ld in d.ld]
              for d in vi._ds]
    traffic = vi.mesh.traffic
    for key in traffic:
        traffic[key] = 0
    vi.elbo_value()
    per_eval = dict(traffic)
    rows = vi._padded_loci // vi.mesh.n_snp
    om = vi._omesh
    # each output column's snp index and first local shard
    cols = (list(zip(om.columns, (js[0] for js in om.lines)))
            if om is not vi.mesh else
            [(s, j) for j, s in enumerate(vi.mesh.snp_shards)])
    pads = []
    pms = vi._posterior_mean(vi.state)
    for od, st, (s, j) in zip(vi._ods, vi._out_states(vi.state), cols):
        lo = max(0, n - s * rows)
        if lo >= rows:
            continue
        mu = engine.materialize_state(od, st).vi_mu[..., lo:]
        pads.append(float(max(mu.abs().max(), pms[j][..., lo:].abs().max())))
    return dict(layouts=layouts, blocks=blocks, per_eval=per_eval,
                pads=pads, L=vi._padded_loci)


def run_phase17(paths, out_dir, cache, launches, smi, beside=None):
    """Phase 17: the global-gather layout at full width. Cohort 2 fits on
    a copy of phase 4's panel with the variant order reversed inside
    every block (no shard-local layout exists); 17a at --mesh snp=3
    (90,112 variants padded to 90,114), 17b at --mesh comp=2,snp=2 with
    --learn-scaling (the kdim state, the K-split kernels), the shards
    co-located on cuda:0, each against the unsharded fit of the same
    two-panel command run here; 17c the same command in one NCCL process
    (--distributed --mesh snp=1: the per-process gathered loader), with
    `beside()` called once its process has started (its result under
    'beside'). Adds the runs' launches to `launches`; returns the
    readings."""
    out = {}
    n = paths[3]
    t0 = time.perf_counter()
    rev = write_reversed_panel(paths[0])
    log(f'  reversed panel written in {time.perf_counter() - t0:.1f} s')
    common = ['--factor-cache', cache, '--no-save-vi-sigma']
    for tag, mesh, shards, form, extra in (
            ('17a', 'snp=3', 3, 'shared', []),
            ('17b', 'comp=2,snp=2', 4, 'kdim',
             ['--learn-scaling', '--num-its', str(KDIM_STEPS)])):
        phase(f'phase {tag}: phase 4\'s fit, cohort 2 on the reversed panel, '
              f'at --mesh {mesh} (the global-gather layout) against the '
              'same fit unsharded')
        ref_prefix = os.path.join(out_dir, f'gather_ref_{form}')
        ref = counted_argv(gathered_argv(paths, rev, ref_prefix,
                                         common + extra))
        prefix = os.path.join(out_dir, 'gather_fit')
        with capture_fit() as cap:
            run = counted_argv(gathered_argv(
                paths, rev, prefix, common + extra + ['--mesh', mesh]),
                ['cuda:0'] * shards)
        if form == 'shared':
            r = check_sharded_fit(tag, (run, prefix), (ref, ref_prefix),
                                  shards, BAND_SHARD)
            keys = ('bucket_matvec_multi', 'prologue', 'delta_sums')
        else:
            r = check_comp_fit(tag, (run, prefix), (ref, ref_prefix),
                               shards, form)
            keys = ('bucket_matvec_multi',) + SPLIT_KEYS[form] + MERGE_KEYS
        g = gathered_readings(cap.fits[-1], n)
        with np.load(prefix + '.npz') as z:
            rows_out = z['vi_mu'].shape[-1]
        r.update(g, rows_out=rows_out)
        log(f'  {tag}: {n} variants in {g["L"]} slots; blocks per bucket '
            f'of each panel, shard by shard {g["blocks"]}; gather and sum '
            f'per evaluation {g["per_eval"]}; pad slots\' largest '
            f'|vi_mu|, |posterior mean| {g["pads"]}; median seconds a '
            f'step sharded / unsharded {r["step_s"][0]:.4f} / '
            f'{r["step_s"][1]:.4f}; {smi}')
        require(g['layouts'] == {'gather'},
                f'{tag}: LD layouts {g["layouts"]}, not the gathered one')
        require(rows_out == n, f'{tag}: {rows_out} output rows, {n} '
                'variants')
        require(all(v == 0 for v in g['pads']),
                f'{tag}: pad slots not inert: {g["pads"]}')
        require(g['per_eval']['gathers'] > 0 and g['per_eval']['sums'] > 0,
                f'{tag}: an evaluation moved nothing through the mesh')
        for key in keys:
            launches[key] += r['counts'][key]
        out[tag] = r
        del cap
        remove_outputs(prefix)
        if form == 'kdim':
            remove_outputs(ref_prefix)

    phase('phase 17c: the same fit in one NCCL process, --distributed '
          '--mesh snp=1 (the gathered per-process loader)')
    prefix = os.path.join(out_dir, 'gather_dist')
    t0 = time.perf_counter()
    argv = gathered_argv(paths, rev, prefix, common)
    procs = start_distributed(argv, 1, 1)
    if beside is not None:
        out['beside'] = beside()
    (res,) = run_distributed(argv, 1, 1, procs)
    ref_prefix = os.path.join(out_dir, 'gather_ref_shared')
    errs = output_errors(prefix, ref_prefix)
    differ = differing_outputs(prefix, ref_prefix)
    log(f'  {time.perf_counter() - t0:.1f} s; left the group {res}; outputs '
        'against 17a\'s unsharded run: '
        + ('bit for bit' if not differ else
           ', '.join(f'{k} {v:.2e}' for k, v in errs.items())))
    require(res['backend'] == 'nccl' and res['shutdowns'] == 1
            and res['barrier'] and res['destroyed'],
            f'phase 17c: the process group was not left once: {res}')
    require(max(errs.values()) <= BAND_SHARD,
            f'phase 17c: outputs {max(errs.values()):.2e} from the '
            'unsharded run\'s')
    for key in ('bucket_matvec_multi', 'prologue', 'delta_sums'):
        require(res[key] > 0, f'phase 17c never launched {key}')
    out['17c'] = dict(errs=errs, result=res, bitwise=not differ)
    remove_outputs(prefix)
    remove_outputs(ref_prefix)
    return out


# ---------------------------------------------------------------------------
# phase 18: bench_torch.py (bench.py's twin) on the card
# ---------------------------------------------------------------------------

# (tag, arguments, knobs, metric, the kernels of its state)
BENCH_RUNS = (
    ('18a', [], {}, 'vi_iterations_per_s_100k_snp_2pop_K18',
     ('bucket_matvec_multi', 'prologue', 'delta_sums')),
    ('18b', ['--accel'], {'BENCH_SCALE_SE': '1', 'BENCH_GRID': 'cli'},
     'vi_iterations_per_s_100k_snp_2pop_cligrid12_scale_se',
     ('bucket_matvec_multi', 'prologue_kdim', 'delta_sums_kdim')),
    ('18c', ['--accel'], {'BENCH_SCALE_SE': '1', 'BENCH_GRID': 'cli',
                          'BENCH_LOCI': '300000'},
     'vi_iterations_per_s_300000loci_snp_2pop_cligrid12_scale_se',
     ('bucket_matvec_multi', 'prologue_epochs', 'delta_sums_epochs')),
)
# the compact kernels of each state form: a run launches its own alone
STATE_KERNELS = ('prologue', 'delta_sums', 'prologue_kdim',
                 'delta_sums_kdim', 'prologue_epochs', 'delta_sums_epochs')


def run_bench(tmp, args, knobs, timeout=600):
    """bench_torch.py, copied into `tmp` (its LD cache lands there),
    run with `knobs` and no other BENCH_ variable. Returns (the seconds,
    stdout)."""
    import shutil
    script = os.path.join(tmp, 'bench_torch.py')
    if not os.path.exists(script):
        shutil.copy(os.path.join(REPO, 'bench_torch.py'), script)
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(knobs)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, script, *args], env=env,
                          cwd=tmp, capture_output=True, text=True,
                          timeout=timeout)
    seconds = time.perf_counter() - t0
    require(proc.returncode == 0,
            f'bench_torch.py {" ".join(args)} with {knobs} failed '
            f'({proc.returncode}): {proc.stderr[-3000:]}')
    return seconds, proc.stdout


def bench_reading(args, stdout):
    """(the bench line, the card leg's launches line) of one run: the
    twin's own last line, or, for --accel, the line composed of its
    ACCEL_IPS and the metric of its ACCEL_LAUNCHES line."""
    lines = stdout.strip().splitlines()
    info = [json.loads(ln.split(' ', 1)[1]) for ln in lines
            if ln.startswith('ACCEL_LAUNCHES ')]
    require(len(info) == 1, f'{len(info)} ACCEL_LAUNCHES lines')
    if args:
        ips = [float(ln.split()[1]) for ln in lines
               if ln.startswith('ACCEL_IPS ')]
        require(len(ips) == 1, f'{len(ips)} ACCEL_IPS lines')
        line = dict(metric=info[0]['metric'], value=ips[0], unit='iters/s',
                    vs_baseline=None)
    else:
        line = json.loads(lines[-1])
        require(list(line) == ['metric', 'value', 'unit', 'vs_baseline'],
                f'bench line keys {list(line)}')
    return line, info[0]


def prepare_bench(tmp):
    """bench_torch.py copied into `tmp` with its LD cache: 18a's float64
    pack factored on the card (batched f64 eigh), which 18a's host leg
    would factor with LAPACK (24.1 s on the card machine's host). Phases
    18 and 19 read it."""
    import importlib.util
    import shutil
    import torch
    script = os.path.join(tmp, 'bench_torch.py')
    shutil.copy(os.path.join(REPO, 'bench_torch.py'), script)
    spec = importlib.util.spec_from_file_location('bench_torch', script)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    bench._cached_ld(torch.float64, torch.device('cuda'))
    torch.cuda.empty_cache()


# 18a's host f64 baseline leg runs in the background from phase 15 on
# (start_baseline), with this many host threads
BASELINE_THREADS = 2


def start_baseline(tmp):
    """18a's baseline leg (bench_torch.py with BENCH_DEVICE=cpu) from
    phase 18's copy in `tmp`, started in the background; its output goes
    to files in `tmp`. Returns the process."""
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env.update(BENCH_DEVICE='cpu', OMP_NUM_THREADS=str(BASELINE_THREADS),
               MKL_NUM_THREADS=str(BASELINE_THREADS))
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    with open(os.path.join(tmp, 'baseline.out'), 'w') as out, \
            open(os.path.join(tmp, 'baseline.err'), 'w') as err:
        proc = subprocess.Popen(
            [sys.executable, os.path.join(tmp, 'bench_torch.py')], env=env,
            cwd=tmp, stdout=out, stderr=err)
    BACKGROUND.append(proc)
    return proc


def read_baseline(tmp, proc, metric, timeout=600):
    """The baseline leg's value (iters/s) once `proc` ends: its line of
    bench.py's keys with `metric`, a finite value > 0, vs_baseline 1.0;
    its lines are printed."""
    proc.wait(timeout=timeout)
    with open(os.path.join(tmp, 'baseline.out')) as out, \
            open(os.path.join(tmp, 'baseline.err')) as err:
        stdout, stderr = out.read(), err.read()
    require(proc.returncode == 0, f'18a\'s baseline leg failed '
            f'({proc.returncode}): {stderr[-3000:]}')
    line = json.loads(stdout.strip().splitlines()[-1])
    require(list(line) == ['metric', 'value', 'unit', 'vs_baseline']
            and line['metric'] == metric and line['vs_baseline'] == 1.0
            and math.isfinite(line['value']) and line['value'] > 0,
            f'18a\'s baseline line {line}')
    for ln in stdout.splitlines():
        if ln.startswith(('LD ', 'baseline leg')):
            log(f'  {ln} ({BASELINE_THREADS} host threads, in the '
                'background)')
    return line['value']


def run_phase18(tmp, smi, baseline):
    """Phase 18: bench_torch.py in subprocesses (BENCH_RUNS), from its
    copy in `tmp` (prepare_bench), 18a's card leg given the value of its
    baseline leg, the process `baseline` (start_baseline): each line
    with the expected metric and a finite value > 0, the kernels of its
    state launched and no other state's. Returns {tag: (line, launches
    line, seconds)}."""
    import torch
    out = {}
    kind = torch.cuda.get_device_name(0)
    for tag, args, knobs, metric, kernels in BENCH_RUNS:
        phase(f'phase {tag}: bench_torch.py {" ".join(args)} '
              f'{" ".join(f"{k}={v}" for k, v in knobs.items())}')
        if tag == '18a':
            knobs = dict(knobs, BENCH_CPU_IPS=repr(
                read_baseline(tmp, baseline, metric)))
        seconds, stdout = run_bench(tmp, args, knobs)
        line, info = bench_reading(args, stdout)
        require(line['metric'] == metric,
                f'{tag}: metric {line["metric"]}, not {metric}')
        require(isinstance(line['value'], float)
                and math.isfinite(line['value']) and line['value'] > 0,
                f'{tag}: value {line["value"]!r}')
        require(info['device'] == kind, f'{tag} ran on {info["device"]}')
        counts = info['launches']
        require_launched(counts, kernels, f'phase {tag}')
        others = [k for k in STATE_KERNELS
                  if k not in kernels and counts[k]]
        require(not others, f'{tag} launched {others}')
        for ln in stdout.splitlines():
            if ln.startswith(('LD ', 'BENCH_GRID', 'scale_se state',
                              'baseline leg')):
                log(f'  {ln}')
        log(f'  {json.dumps(line)}')
        log(f'  launches over the 3 timed chains {counts}; host syncs '
            f'{info["host_syncs_per_step"]:.2f} a step; '
            f'{seconds:.1f} s; {smi}')
        out[tag] = (line, info, seconds)
    return out


# ---------------------------------------------------------------------------
# phase 19: the drift check (tools/drift_genome_torch.py) at 100K SNPs
# ---------------------------------------------------------------------------

# the tool's legs on phase 18a's problem (100,000 SNPs, 2 cohorts, K = 18,
# 1024-SNP blocks at half rank), DRIFT_ITERS outer steps each; each card
# leg against the host's f64 leg within tests/test_f32_genome_scale.py's
# bands (the tool's BANDS), the ELBO accumulator gated on f32cuda
# (BAND_ACC_TEST 1e-5, the f64 base BAND_ACC_BASE 1e-9) and printed on
# bf16cuda, whose U is rounded to bf16
DRIFT_BASE = 'f64cpu'
DRIFT_CARD_LEGS = (('f32cuda', True), ('bf16cuda', False))
DRIFT_ITERS = 40
DRIFT_KERNELS = ('bucket_matvec_multi', 'prologue', 'delta_sums')
# the legs run in the background from phase 13 on (start_phase19), each
# leg's host threads capped so that the phases in front keep most of the
# host's cores: the f64 leg's arithmetic runs there, the card legs' on
# the card
DRIFT_THREADS = {DRIFT_BASE: 4, 'f32cuda': 1, 'bf16cuda': 1}
# the processes start_phase19 started, stopped at exit if still running
BACKGROUND = []


def tool(name):
    """tools/<name>.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, 'tools', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def start_phase19(tmp):
    """Phase 19's legs, started at once in the background: the drift
    tool's legs in subprocesses, on a copy of the tool beside phase 18's
    copy of bench_torch.py in `tmp` (so its LD cache is prepare_bench's),
    each with DRIFT_THREADS host threads. Returns {leg: process}."""
    import shutil
    tool = os.path.join(tmp, 'tools', 'drift_genome_torch.py')
    os.makedirs(os.path.dirname(tool), exist_ok=True)
    shutil.copy(os.path.join(REPO, 'tools', 'drift_genome_torch.py'), tool)
    env = {k: v for k, v in os.environ.items() if not k.startswith('BENCH_')}
    env['BENCH_SIZE'] = '100k'
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = {}
    for leg in (DRIFT_BASE,) + tuple(leg for leg, _ in DRIFT_CARD_LEGS):
        threads = str(DRIFT_THREADS[leg])
        # the output goes to files: a full pipe nobody reads would stall
        with open(os.path.join(tmp, f'{leg}.out'), 'w') as out, \
                open(os.path.join(tmp, f'{leg}.err'), 'w') as err:
            procs[leg] = subprocess.Popen(
                [sys.executable, tool, '--leg', leg, '--out',
                 os.path.join(tmp, f'{leg}.npz'), '--iters',
                 str(DRIFT_ITERS)],
                env=dict(env, OMP_NUM_THREADS=threads,
                         MKL_NUM_THREADS=threads),
                cwd=tmp, stdout=out, stderr=err)
        BACKGROUND.append(procs[leg])
    return procs


def stop_background():
    """Kill what start_phase19 and start_baseline started and is still
    running."""
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def run_phase19(tmp, smi, procs, timeout=600):
    """Phase 19: waits for the legs start_phase19 started in `tmp`. Each
    card leg's report against the f64 leg within the bands, its matvec
    and [P, I] kernels launched. Returns {leg: (report, launches,
    seconds)}."""
    t0 = time.perf_counter()
    try:
        for proc in procs.values():
            proc.wait(timeout=max(timeout - (time.perf_counter() - t0), 1))
    finally:
        stop_background()
    log(f'  waited {time.perf_counter() - t0:.1f} s for the legs')
    for leg, proc in procs.items():
        with open(os.path.join(tmp, f'{leg}.out')) as out, \
                open(os.path.join(tmp, f'{leg}.err')) as err:
            stdout, stderr = out.read(), err.read()
        require(proc.returncode == 0, f'phase 19: leg {leg} failed '
                f'({proc.returncode}): {stderr[-3000:]}')
        for ln in stdout.splitlines():
            if ln.startswith(('leg=', 'LD ', 'launches', 'saved')):
                log(f'  {ln}')

    drift = tool('drift_genome_torch')
    kind = smi.splitlines()[0]
    out = {}
    base_path = os.path.join(tmp, f'{DRIFT_BASE}.npz')
    for leg, gated in DRIFT_CARD_LEGS:
        path = os.path.join(tmp, f'{leg}.npz')
        f = np.load(path)
        counts = json.loads(str(f['launches']))
        require(str(f['device']) == smi,
                f'phase 19: leg {leg} ran on {f["device"]}')
        require_launched(counts, DRIFT_KERNELS, f'phase 19 ({leg})')
        log(f'  {leg} against {DRIFT_BASE}, {DRIFT_ITERS} outer steps '
            f'({float(f["seconds"]):.2f} s of steps on {kind}):')
        rep = drift.compare(base_path, path)
        bad = drift.out_of_band(rep, accumulator=gated)
        log(f'  {leg}: ELBO accumulator drift '
            f'{rep["elbo_accumulator_drift_test"]:.3e} ('
            + (f'band {drift.BAND_ACC_TEST:.0e}' if gated else 'not gated')
            + ')')
        require(not bad, f'phase 19: {leg} outside the bands {bad}')
        out[leg] = (rep, counts, float(f['seconds']))
    return out


# phase 20: a chain of EVAL_CHAIN evaluations on phase 5's engine; the
# chain's float64 sum of equal float32 objectives is exact, so it must
# equal EVAL_CHAIN times one evaluation's to BAND_CHAIN. The read probe
# may not pass the published peak by more than HBM_ROOM: a reading past
# it means the timing is broken.
EVAL_CHAIN = 50
BAND_CHAIN = 1e-6
HBM_PROBE_MIB = 4096
HBM_PROBE_CHAIN = 30
HBM_ROOM = 1.05


def run_phase20(data, st, smi):
    """Phase 20 on phase 5's engine (`data`, `st`): the evaluation chain,
    its launches, host syncs and top-offset check; then the read probe."""
    import torch
    import bench_hbm_torch
    ev = tool('eval_scaling_torch')
    stamps = [time.perf_counter()]
    one = float(ev.chain(data, st, 1))
    m = ev.measure(data, st, EVAL_CHAIN)
    stamps.append(time.perf_counter())
    rel = abs(m['total'] - EVAL_CHAIN * one) / abs(EVAL_CHAIN * one)
    require(math.isfinite(m['total']) and rel <= BAND_CHAIN,
            f'the chain sums {m["total"]!r}, {rel:.2e} from {EVAL_CHAIN} x '
            f'one evaluation\'s {one!r} (band {BAND_CHAIN:.0e})')
    require(m['host_syncs'] == 0,
            f'{m["host_syncs"]} host syncs inside the timed chains')
    buckets = sum(len(ld.buckets) for ld in data.ld)
    got = dict(m['launches'])
    matvec = (got.pop('bucket_matvec_multi', 0)
              + got.pop('bucket_matvec_multi_group', 0))
    got.pop('bucket_matvec_multi_group_bf16', None)
    require(matvec == buckets * m['evals'] and got == {
        'prologue': m['evals']}, f'launches {m["launches"]} over '
        f'{m["evals"]} evaluations: want 1 prologue and {buckets} matvec '
        'an evaluation, no other kernel')
    busy, wall = ev.busy_ms(data, st, EVAL_CHAIN)
    stamps.append(time.perf_counter())
    top = ev.top_offset_check(data, st)
    require(top['ok'], f'the top-offset check missed: {top}')
    stamps.append(time.perf_counter())
    gib_s, ms = bench_hbm_torch.probe(HBM_PROBE_MIB, HBM_PROBE_CHAIN,
                                      torch.device('cuda'))
    stamps.append(time.perf_counter())
    secs = np.diff(stamps)
    rate = gib_s * 2**30
    require(math.isfinite(rate) and 0 < rate <= HBM_ROOM * HBM_BYTES_S,
            f'the read probe reads {gib_s!r} GiB/s: not in (0, '
            f'{HBM_ROOM} x {HBM_BYTES_S:.3e} B/s]')
    log(f'  chain of {EVAL_CHAIN}: host {m["host_ms"]:.4f} ms an '
        f'evaluation, device busy {busy:.4f} ms (traced wall {wall:.4f}); '
        f'launches an evaluation: prologue 1, matvec {buckets}; host syncs '
        f'0; the sum within {rel:.2e} of {EVAL_CHAIN} x one evaluation '
        f'(band {BAND_CHAIN:.0e}); top offset {json.dumps(top)}')
    probe = bench_hbm_torch.line(HBM_PROBE_MIB, gib_s, ms,
                                 torch.device('cuda'))
    log(f'  read probe: {probe.strip()}, {rate / 1e12:.3f} TB/s, '
        f'{rate / HBM_BYTES_S:.1%} of the published '
        f'{HBM_BYTES_S / 1e12:.2f} TB/s; {smi}')
    log(f'  seconds: chains {secs[0]:.1f}, trace {secs[1]:.1f}, top-offset '
        f'check {secs[2]:.1f}, read probe {secs[3]:.1f}')
    return dict(host_ms=m['host_ms'], busy_ms=busy, hbm_gib_s=gib_s)


# phase 21: the production CLI end to end on the on-disk inputs that
# tools/export_synthetic_schema_torch.py writes (bench's problem at 100K)
E2E_LOCI = 100_000
E2E_ITS = '5'
E2E_PATH = ('bucket_matvec_multi', 'prologue_kdim', 'delta_sums_kdim')


def export_error(captured, device):
    """The blocks read back by the port's loader against the factors they
    were exported from (synthetic_factors on the card, recomputed): each
    block's U diag(s) U^T, in float64, over the f32 rounding bound of the
    exported U and s, 3 * 2^-24 * (|U| s) |U|^T elementwise. Returns the
    largest ratio (at most 1 passes) and the blocks compared."""
    import torch
    from vilma_tpu_torch.utils import synthetic
    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float64,
                               device=device)

    worst, blocks = 0.0, 0
    exported = synthetic.synthetic_factors(E2E_LOCI, 1024, 0.5, seed=0,
                                           device=device)
    for (idx, f), (ix, fe) in zip(captured, exported):
        require(np.array_equal(idx, ix), f'block {blocks}: the loader '
                'matched other variants than the export wrote')
        u, s, ue, se = t(f.u), t(f.s), t(fe.u), t(fe.s)
        err = ((u * s) @ u.T - (ue * se) @ ue.T).abs()
        bound = 3 * 2.0 ** -24 * (ue.abs() * se) @ ue.abs().T
        worst = max(worst, float((err / bound).max()))
        blocks += 1
    require(blocks == len(captured), 'fewer exported blocks than loaded')
    return worst, blocks


def run_phase21(device, smi):
    """Phase 21: tools/export_synthetic_schema_torch.py writes bench's
    100K problem (its factors from the card); check_ld_schema --trace
    --listvars reads it back through the port's loader, whose blocks
    equal the exported ones to f32 rounding (export_error); then fit -K
    12 --learn-scaling through tools/e2e_fit_torch.py (its E2E line: the
    stage split), the launch counters zeroed just before and read just
    after. The fit reuses the trace's host factors (memo_factors)."""
    from vilma_tpu_torch import frontend
    from vilma_tpu_torch.inference import engine
    from vilma_tpu_torch.io import load
    export, e2e = tool('export_synthetic_schema_torch'), tool('e2e_fit_torch')
    out = {}
    with tempfile.TemporaryDirectory() as tmp, memo_factors():
        d = os.path.join(tmp, 'in')
        t0 = time.perf_counter()
        nb, nbytes, source = export.export(d, E2E_LOCI, device=device)
        out['export_s'] = time.perf_counter() - t0
        require(source != 'archive' and nb == -(-E2E_LOCI // 1024),
                f'export: {nb} blocks from {source}')
        log(f'  export: {nb} blocks, {nbytes} bytes in '
            f'{out["export_s"]:.1f} s (factors on {source})')

        schema = os.path.join(d, 'schema.schema')
        trace, listvars = (os.path.join(tmp, 'trace.tsv'),
                           os.path.join(tmp, 'vars.tsv'))
        captured = []
        memoized = load.load_entry_factor

        def capture(entry, ldthresh, cache_dir=None):
            f = memoized(entry, ldthresh, cache_dir)
            captured.append((entry['idx'], f))
            return f

        load.load_entry_factor = capture
        t0 = time.perf_counter()
        try:
            frontend.main(['check_ld_schema', '--ld-schema', schema,
                           '--trace', trace, '--listvars', listvars,
                           '--device', device])
        finally:
            load.load_entry_factor = memoized
        out['check_s'] = time.perf_counter() - t0
        with open(listvars) as fh:
            rows = fh.read().split('\n')[1:-1]
        require(len(rows) == E2E_LOCI and rows[0].startswith('snp0\t')
                and rows[-1].startswith(f'snp{E2E_LOCI - 1}\t'),
                f'check_ld_schema --listvars: {len(rows)} variants')
        with open(trace) as fh:
            ratio = float(fh.read().split('\n')[1].split('\t')[3])
        require(0.5 < ratio <= 1.0, f'trace ratio {ratio}')
        out['export_err'], n_blocks = export_error(captured, device)
        require(out['export_err'] <= 1.0,
                f'the loaded blocks differ from the exported ones by '
                f'{out["export_err"]:.3f} x their f32 rounding bound')
        log(f'  check_ld_schema --trace --listvars: {out["check_s"]:.1f} s, '
            f'{len(rows)} variants, trace ratio {ratio:.6f}; the {n_blocks} '
            f'blocks read back within {out["export_err"]:.3f} x the f32 '
            'rounding bound of the exported U and s')

        prefix = os.path.join(tmp, 'fit')
        argv = ['fit', '--sumstats',
                f'{d}/pop1.sumstats.tsv,{d}/pop2.sumstats.tsv',
                '--ld-schema', f'{schema},{schema}', '--extract',
                f'{d}/extract.tsv', '--names', 'pop1,pop2',
                '--samplesizes', '1e5,1e5', '--init-hg', '0.3,0.3',
                '--seed', '42', '-K', '12', '--learn-scaling',
                '--num-its', E2E_ITS, '--output', prefix,
                '--device', device]
        zero_counts()
        engine.host_syncs = 0
        line = e2e.run(argv, tag='phase21')
        counts = read_counts()
        require(line is not None, 'phase 21: the outputs do not fit')
        require(line['iterations'] == int(E2E_ITS) and line['state'] == 'kdim',
                f'phase 21: {line["iterations"]} steps on {line["state"]}')
        require_launched(counts, E2E_PATH, 'phase 21')
        check_fit_outputs(prefix, E2E_LOCI, K=line['K'])
        for key, size in line['reckoned'].items():
            got = line['written']['npz'].get(key, 0)
            require(0 <= got - size <= 256, f'{key}: {got} bytes written, '
                    f'{size} reckoned')
        out.update(line=line, counts=counts)
    log(f'  fit: launches {counts}; {line["iterations"]} steps; seconds '
        f'{ {k: round(v, 2) for k, v in line["seconds"].items()} }; device '
        f'peak GiB {line["device_peak_gib"]}; host RSS GiB '
        f'{line["rss_gib"]}; {smi}')
    return out


def run_phase14(paths, device, launches, timings, smi, cache):
    """Phase 14 on phase 4's panel (`paths`): 14a-c, 14d and 14e, adding
    the backward's launches to `launches` and the seconds to
    `timings`. `cache`, a directory not made yet, is the factor cache
    14a fills (phase 15 reads it)."""
    with tempfile.TemporaryDirectory() as tmp:
        phase('phase 14a-c: phase 4\'s fit with --factor-cache, cold, warm '
              'and warm with --mmap, a process each')
        with open(paths[0]) as fh:
            num_blocks = sum(1 for line in fh if line.strip())
        runs, cov_path = run_factor_cache(paths, tmp, device, num_blocks,
                                          cache)
        for run, r in runs.items():
            log(f'  {run}: {r["hits"]} hits, {r["misses"]} misses; load '
                f'{r["load_s"]:.2f} s, fit {r["fit_s"]:.1f} s in all; RSS '
                f'before the load {_gib(r["rss_before_kb"])}, peak during '
                f'it {_gib(r["rss_peak_kb"])} (+{_gib(rise(r, "rss"))}); '
                f'anonymous RSS before {_gib(r["anon_before_kb"])}, peak '
                f'{_gib(r["anon_peak_kb"])}; VmHWM after the load '
                f'{_gib(r["hwm_load_kb"])}, at the end {_gib(r["hwm_kb"])}; '
                f'launches matvec {r["bucket_matvec_multi"]}, prologue '
                f'{r["prologue"]}, sums {r["delta_sums"]}')
        log(f'  load seconds cold {runs["14a"]["load_s"]:.2f}, warm '
            f'{runs["14b"]["load_s"]:.2f}, warm --mmap '
            f'{runs["14c"]["load_s"]:.2f}; 14b and 14c outputs equal 14a\'s '
            f'bit for bit; peak host RSS during the load 14b '
            f'{_gib(runs["14b"]["rss_peak_kb"])} (VmHWM '
            f'{_gib(runs["14b"]["hwm_load_kb"])}), 14c (--mmap) '
            f'{_gib(runs["14c"]["rss_peak_kb"])} (VmHWM '
            f'{_gib(runs["14c"]["hwm_load_kb"])}); {smi}')
        timings['load_cold_s'] = runs['14a']['load_s']
        timings['load_warm_s'] = runs['14b']['load_s']
        timings['load_warm_mmap_s'] = runs['14c']['load_s']

        phase('phase 14d: the gradient tool from phase 4\'s initialized '
              f'state, {GRAD_STEPS} Adam steps')
        g = run_gradient_tool(paths, cache, cov_path, device)
        launches['bucket_matvec_multi_backward'] = g['backward']
        timings['gradient_s_per_step'] = g['s_per_step']
        log(f'  K = {g["K"]}, {g["n"]} SNPs; ELBO gradient through the '
            f'kernel vs the plain version, scaled errors (vi_mu, vi_delta '
            f'logits, hyper_delta logits) {g["grad_err"]} (band '
            f'{BAND_BF16:.1e}; the plain version\'s own autograd differs '
            f'from it by {g["autograd_gap"]}); set-up {g["setup_s"]:.3f} s, '
            f'steps {[round(x, 4) for x in g["step_s"]]} s (median after '
            f'the first {g["s_per_step"]:.4f} s); peak device '
            f'memory {g["peak"] / 2**30:.2f} GiB; ELBO {g["trace"][0]!r} -> '
            f'{g["trace"][-1]!r}; launches {g["counts"]}, backward '
            f'{g["backward"]}; {smi}')

    phase('phase 14e: SMC and NUTS on 8-SNP blocks, densities on the card')
    e = run_samplers(device)
    log(f'  SMC 1500 particles {e["smc_s"]:.1f} s, means within '
        f'{e["smc_err"]:.3f} of scale of the VI answer; NUTS '
        f'{NUTS_WARMUP} + {NUTS_SAMPLES} draws {e["nuts_s"]:.1f} s, within '
        f'{e["nuts_err"]:.3f} (band {BAND_SAMPLER})')


def main():
    import torch
    phase('phase 1: device')
    if not torch.cuda.is_available():
        raise SmokeFailure('torch.cuda.is_available() is false: '
                           'chip_smoke.py needs a CUDA device')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    log(f'  {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, REPO)
    device = 'cuda'
    t_start = time.perf_counter()

    phase('phase 2: build')
    from vilma_tpu_torch.ops.cuda import build
    t0 = time.perf_counter()
    if ('stamps' in getattr(build, 'VARIANTS', {})
            and '--split-only' not in sys.argv[1:]):
        import threading
        STAMPS_BUILD.append(threading.Thread(
            target=build.build, kwargs=dict(variant='stamps'), daemon=True))
        STAMPS_BUILD[0].start()
    build.library()
    log(f'  built {build.library_path().name} in '
        f'{time.perf_counter() - t0:.1f} s (nvcc '
        f'{build.build_seconds if build.build_seconds is not None else 0:.1f} s)')
    print_kernel_resources()

    results = {}
    if '--matvec-only' in sys.argv[1:]:
        phase('phase 3, the matvec alone (--matvec-only)')
        group_sweep(device)
        group_stamps(device)
        check_matvec(device, results, bars=False)
        log(f'  {smi}; no JSON line: --matvec-only')
        return
    if '--split-only' in sys.argv[1:]:
        phase('phase 3, the K-split kernels alone (--split-only)')
        check_split(device, results)
        log(f'  {smi}; no JSON line: --split-only')
        return
    phase('phase 3: kernels against their plain versions')
    t0 = time.perf_counter()
    check_matvec(device, results)
    group_sweep(device)
    group_stamps(device)
    check_matvec_backward(device, results)
    shared_ms = check_compact(device, results)
    kdim_ms = check_kdim(device, results)
    check_bars(shared_ms, kdim_ms, check_epochs(device, results))
    torch.cuda.empty_cache()
    check_split(device, results)
    log(f'  phase 3: {time.perf_counter() - t0:.1f} s')

    launches = {}
    timings = {}
    # phases 6, 10 and 11 reload phase 4's panel: its host factors are
    # computed once, by phase 4's fit (set-up, not the path under test)
    with tempfile.TemporaryDirectory() as tmp, memo_factors():
        phase('phase 4: CLI fit, ~90K variants, -K 12 (582 components)')
        t0 = time.perf_counter()
        # phase 4's panel lives until phase 14
        panel = tempfile.TemporaryDirectory()
        paths = write_schema(panel.name, num_blocks=88, device=device)
        n = paths[3]
        log(f'  schema: {n} variants in 88 blocks written in '
            f'{time.perf_counter() - t0:.1f} s')
        fit_prefix = os.path.join(tmp, 'fit')
        p4 = counted_fit(paths, fit_prefix, F32_BF16)
        counts, step_s, syncs, _, _ = p4
        top, _ = check_fit_outputs(fit_prefix, n, K=582)
        log(f'  launches {counts}; host syncs {syncs} '
            f'({syncs / max(len(step_s), 1):.1f} per step); seconds per '
            f'outer step {[round(x, 4) for x in step_s]}; max |posterior| '
            f'{top:.3e}')
        path_a = ('bucket_matvec_multi', 'prologue', 'delta_sums')
        require_launched(counts, path_a, 'phase 4')
        launches.update({k: counts[k] for k in path_a})
        with tempfile.TemporaryDirectory() as small:
            errs = check_small_fit(small)
        for route, (err, s_err, scal, host_err) in errs.items():
            log(f'  reference ({route}): 2-block fit, card f32 vs host '
                f'f64, scaled errors (pm1, pm2, pv1, pv2) {err} (band '
                f'{BAND_FIT if route == "plain" else BAND_FIT_SE:.0e}; '
                f'host f32 vs host f64 {host_err}); learned scaling {scal} '
                f'within {s_err:.2e} of the host')

        phase('phase 4b: CLI fit at the default precision (f32 U), a 1024-SNP '
            'and a 2048-SNP block; then the same with bf16 U')
        with tempfile.TemporaryDirectory() as mixed:
            paths4b = write_schema(mixed, 2, block_sizes=[1024, 2048])
            prefix = os.path.join(mixed, 'fit')
            counts, step_s, _, _ = run_fit(paths4b, prefix, device)
            check_fit_outputs(prefix, paths4b[3], K=582)
            log(f'  f32 U: launches {counts}; {len(step_s)} outer steps')
            require_launched(counts, ('bucket_matvec_multi',
                                      'bucket_matvec_multi_group', 'prologue',
                                      'delta_sums'), 'phase 4b')
            require(counts['bucket_matvec_multi_group_bf16'] == 0,
                    'phase 4b (f32 U) launched the bf16 group route')
            launches['bucket_matvec_multi_f32'] = counts['bucket_matvec_multi']
            launches['bucket_matvec_multi_group'] = counts[
                'bucket_matvec_multi_group']
            prefix = os.path.join(mixed, 'fit_bf16')
            counts, step_s, _, _ = run_fit(paths4b, prefix, device, F32_BF16)
            check_fit_outputs(prefix, paths4b[3], K=582)
            log(f'  bf16 U: launches {counts}; {len(step_s)} outer steps')
            require_launched(counts, ('bucket_matvec_multi_group_bf16',),
                             'phase 4b (bf16 U)')
            launches['bucket_matvec_multi_group_bf16'] = counts[
                'bucket_matvec_multi_group_bf16']

        phase('phase 5: engine, 1M SNPs, 2 cohorts, K=18, bf16 U')
        ips, syncs, vi5, st5, ld = run_engine(device)
        log(f'  {ips:.3f} outer iterations/s ({syncs:.1f} host syncs per '
            f'step), ELBO {st5.elbo:.6e}; {smi}')

        phase(f'phase 20: phase 5\'s engine, a chain of {EVAL_CHAIN} '
              'objective evaluations (tools/eval_scaling_torch.py), then '
              f'the read probe at {HBM_PROBE_MIB} MiB (bench_hbm_torch.py)')
        t0 = time.perf_counter()
        p20 = run_phase20(vi5.data, st5, smi)
        del vi5, st5
        timings['phase20_s'] = time.perf_counter() - t0
        for key in ('host_ms', 'busy_ms', 'hbm_gib_s'):
            timings[f'20_{key}'] = p20[key]
        log(f'  phase 20: {timings["phase20_s"]:.1f} s')
        torch.cuda.empty_cache()

        phase('phase 6: CLI fit --learn-scaling, phase 4\'s schema, -K 12, '
            'kdim state, a checkpoint every '
            f'{CHECKPOINT_FREQ} steps')
        se_prefix = os.path.join(tmp, 'fit_se')
        with record_elbos() as se_elbos:
            counts, step_s, syncs, em = run_fit(
                paths, se_prefix, device,
                F32_BF16 + ['--learn-scaling', '--num-its', str(STEP_CAP_SE),
                            '--checkpoint-freq', str(CHECKPOINT_FREQ)])
        top, scaling = check_fit_outputs(se_prefix, n, K=582)
        log(f'  launches {counts}; {len(step_s)} outer steps, host syncs '
            f'{syncs / max(len(step_s), 1):.1f} per step, median '
            f'{float(np.median(step_s)):.4f} s a step; EM events '
            f'{len(em)} (at steps {[e[0] for e in em]}); learned '
            f'error_scaling {scaling.tolist()}; max |posterior| '
            f'{top:.3e}')
        require(len(em) >= 1, f'no error-scaling EM event in '
                f'{len(step_s)} steps (cap {STEP_CAP_SE})')
        require(np.all(np.isfinite(scaling)) and not np.allclose(scaling, 1),
                f'error_scaling {scaling} was not learned')
        path_b = ('prologue_kdim', 'delta_sums_kdim')
        require_launched(counts, ('bucket_matvec_multi',) + path_b,
                         'phase 6')
        require(counts['prologue'] == counts['delta_sums'] == 0,
                'phase 6 ran a shared-state kernel on the kdim state')
        launches.update({k: counts[k] for k in path_b})

        phase('phase 7: engine --learn-scaling, 1M SNPs, 2 cohorts, -K 12 '
              'grid, epoch-history state')
        counts, ips, syncs, st7, em, vi7 = run_engine_se(device, ld)
        log(f'  K = {vi7.num_mix}; launches {counts}; {ips:.3f} outer '
            f'iterations/s ({syncs:.1f} host syncs per step); nat_hist_n '
            f'{st7.nat_hist_n}; error_scaling {st7.error_scaling.tolist()}; '
            f'ELBO {st7.elbo:.6e}')
        path_c = ('prologue_epochs', 'delta_sums_epochs')
        require_launched(counts, ('bucket_matvec_multi',) + path_c,
                         'phase 7')
        launches.update({k: counts[k] for k in path_c})

        phase('phase 8: make_ld_schema --ldthresh 0.8, ~90K SNPs in ~130 '
              f'blocks, {PLINK_SAMPLES} samples')
        schema_dir = os.path.join(tmp, 'make')
        os.makedirs(schema_dir)
        root, secs, n_vars, n_blocks, ranks, errs = run_make_ld_schema(
            schema_dir)
        timings['make_ld_schema_s'] = secs
        log(f'  card: {secs:.1f} s for {n_vars} variants in {n_blocks} '
            f'blocks (ranks {min(ranks)}-{max(ranks)}, median '
            f'{int(np.median(ranks))}); host vs card on the first '
            f'{SCHEMA_CHECK_BLOCKS} blocks: .schema and .var text equal, '
            f'ranks equal, eigenvalues within {errs["s"]:.2e} relative, '
            f'U diag(s) U^T within {errs["recon"]:.2e} (band '
            f'{BAND_SCHEMA:.0e})')

        phase('phase 9: check_ld_schema --trace --listvars of phase 8\'s '
              'schema, card and host')
        secs, trace = run_check_ld_schema(root, schema_dir)
        timings['check_ld_schema_s'] = secs
        log(f'  card {secs:.1f} s; text equal to the host\'s; trace: {trace}')

        phase('phase 10: sim from phase 4\'s fit, 2 cohorts, default RNG')
        secs, matvecs, errs = run_sim(paths, fit_prefix, tmp)
        timings['sim_s'] = secs
        log(f'  card {secs:.1f} s, {matvecs} matvec launches; true_beta '
            f'equal to the host\'s; BETA within {errs["cuda"]:.2e} of '
            f'scale of the host f64 run (band {BAND_SIM:.0e}; the host\'s '
            f'own f32 run: {errs["cpu_f32"]:.2e})')
        # phase 15 compares its sharded fits with phases 4 and 6
        p4 = (p4, keep_outputs(fit_prefix, panel.name))

        phase('phase 11: resume, kdim (phase 6\'s checkpoint) and epoch '
              '(phase 7\'s state)')
        c, secs, err, counts, values = resume_kdim(paths, se_prefix,
                                                   se_elbos.values, tmp)
        timings['resume_kdim_s'] = secs
        log(f'  kdim: checkpoint at iteration {c}, streamed; {secs:.1f} s '
            f'for {len(values)} steps (the load included); ELBO of the '
            f'restored state within {err:.2e} of the original run\'s (band '
            f'{BAND_RESUME:.0e}); launches {counts}')
        remove_outputs(se_prefix)
        secs, err, counts = resume_epoch(vi7, st7, tmp)
        timings['resume_epoch_s'] = secs
        log(f'  epoch: {secs:.1f} s for {RESUME_STEPS} steps; first ELBO '
            f'within {err:.2e} of a step from the dumped state; launches '
            f'{counts}')
    torch.cuda.empty_cache()

    phase(f'phase 21: the fit CLI end to end on on-disk inputs: '
          f'tools/export_synthetic_schema_torch.py at {E2E_LOCI:,} SNPs, '
          f'check_ld_schema, fit -K 12 --learn-scaling --num-its {E2E_ITS} '
          'through tools/e2e_fit_torch.py')
    t0 = time.perf_counter()
    p21 = run_phase21(device, smi)
    timings['phase21_s'] = time.perf_counter() - t0
    timings['21_export_err'] = p21['export_err']
    timings['21_stages_s'] = p21['line']['seconds']
    log(f'  phase 21: {timings["phase21_s"]:.1f} s')
    torch.cuda.empty_cache()

    phase('phase 12: K-chunked shape, ~100K SNPs, 3 cohorts, -K 12 '
          '--drop-non-psd grid, f32, shared state')
    c = run_chunked_shape(device)
    timings['chunked_init_s'] = c['init_s']
    timings['chunked_s_per_iter'] = c['s_per_iter']
    log(f'  K = {c["K"]}; initialization {c["init_s"]:.3f} s, peak device '
        f'memory {c["init_peak"] / 2**30:.2f} GiB; steps '
        f'{[round(t, 4) for t in c["step_s"]]} s, {c["s_per_iter"]:.3f} '
        f's/iter ({c["syncs"]:.1f} host syncs per step), peak device '
        f'memory {c["step_peak"] / 2**30:.2f} GiB; ELBO {c["elbo"]!r}; '
        f'launches {c["counts"]}; {smi}')
    log_chunked_write(c['write'], smi)
    timings['chunked_write'] = {k: c['write'].get(k) for k in (
        'written', 'npz_s', 'estimates_s', 'free_bytes', 'need_bytes')}
    torch.cuda.empty_cache()

    # phase 19's legs run from here on, beside phases 13-18
    bench_dir = tempfile.TemporaryDirectory()
    bench_tmp = bench_dir.name
    t19 = time.perf_counter()
    prepare_bench(bench_tmp)
    legs = start_phase19(bench_tmp)
    log(f'  phase 19\'s legs {", ".join(legs)} started in the background '
        f'({time.perf_counter() - t19:.1f} s for the LD cache)')

    with tempfile.TemporaryDirectory() as tmp:
        phase(f'phase 13a: fit --trait, {TRAITS} traits on one ~90K-variant '
              'panel, -K 3 --drop-non-psd, f32, the materialized state')
        # its panel and outputs stay for phase 16c
        trait_dir = os.path.join(panel.name, 'trait')
        os.makedirs(trait_dir)
        a = run_trait_fit(trait_dir, keep=True)
        timings['trait_s_per_iter'] = sum(a['step_s']) / len(a['step_s'])
        launches['bucket_matvec_multi_c4'] = a['counts'][
            'bucket_matvec_multi_c4']
        log(f'  K = {a["K"]} components, {a["n"]} variants; {a["seconds"]:.1f} '
            f's in all; steps {[round(t, 3) for t in a["step_s"]]} s '
            f'({a["syncs"]:.1f} host syncs per step); peak device memory '
            f'{a["peak"] / 2**30:.2f} GiB; ELBOs {a["elbos"]}; max '
            f'|posterior| {a["top"]:.3e}; launches {a["counts"]}; {smi}')
        log(f'  card split: {a["split"]}')

        phase('phase 13c: 4-trait fit, card f32 against host f64, and its '
              'resume')
        err, host, r_err, K = run_trait_references(tmp)
        log(f'  -K 2 --drop-non-psd: K = {K}; card f32 vs host f64, scaled '
            f'errors (means, variances) {err} (band {BAND_TRAIT_FACTOR} x '
            f'the host f32 fit\'s {host.max():.2e}; host f32 {host}); the '
            f'resumed ELBO within {r_err:.2e} (band {BAND_RESUME:.0e})')

    phase('phase 13b: 4 ancestries, 1,000,448 SNPs, a bf16 panel each, '
          '-K 2 --drop-non-psd, f32, the materialized state')
    b = run_ancestry_fit(device, ld)
    timings['ancestry_init_s'] = b['init_s']
    timings['ancestry_s_per_iter'] = b['s_per_iter']
    log(f'  K = {b["K"]}, {b["n"]} SNPs; panels 2-4 ({ANCESTRY_DISTINCT} '
        f'factored blocks each; the first is phase 5\'s) made in '
        f'{b["setup_s"]:.1f} s; initialization '
        f'{b["init_s"]:.3f} s, peak '
        f'device memory {b["init_peak"] / 2**30:.2f} GiB; steps '
        f'{[round(t, 3) for t in b["step_s"]]} s ({b["syncs"]:.1f} host '
        f'syncs per step), peak device memory {b["step_peak"] / 2**30:.2f} '
        f'GiB; ELBO {b["elbo"]!r}; launches {b["counts"]}; {smi}')
    del b
    torch.cuda.empty_cache()

    phase('phase 13d: 8 traits on one panel, ~90K variants, 6 components, '
          'f32: the matvec at 8 cohorts a launch')
    d = run_eight_traits(device)
    launches['bucket_matvec_multi_c8'] = d['counts']['bucket_matvec_multi_c8']
    log(f'  initialization {d["init_s"]:.3f} s; steps '
        f'{[round(t, 3) for t in d["step_s"]]} s; peak device memory '
        f'{d["step_peak"] / 2**30:.2f} GiB; launches {d["counts"]}; {smi}')
    del d
    torch.cuda.empty_cache()

    cache = os.path.join(panel.name, 'factor_cache')
    run_phase14(paths, device, launches, timings, smi, cache)
    baseline = start_baseline(bench_tmp)
    t0 = time.perf_counter()
    p15 = run_phase15(paths, p4, vi7, st7, ld, panel.name, cache, launches,
                      smi)
    timings['phase15_s'] = time.perf_counter() - t0
    timings['epoch_sharded_s_per_step'] = p15['15b_epoch']['s_step']
    timings['epoch_unsharded_s_per_step'] = p15['15b_epoch']['s_step0']
    t0 = time.perf_counter()
    p16 = run_phase16(paths, p4, p15['kdim_ref'],
                      (a['paths'], a['prefix'], a['K']), c, vi7, st7, ld,
                      panel.name, cache, launches, smi)
    del ld, vi7, st7
    timings['phase16_s'] = time.perf_counter() - t0
    for tag in ('16a', '16a kdim'):
        timings[f'{tag.replace(" ", "_")}_s_per_step'] = p16[tag]['step_s']
    timings['16d_s_per_step'] = (p16['16d']['s_step'],
                                 p16['16d']['s_step0'])
    t0 = time.perf_counter()
    # 15c's process runs beside 17c's: both wait on a fresh process
    p17 = run_phase17(paths, panel.name, cache, launches, smi,
                      beside=lambda: start_phase15c(paths, panel.name, cache))
    p15.update(run_phase15c(paths, p4, panel.name, cache,
                            p17.pop('beside')))
    timings['phase17_s'] = time.perf_counter() - t0
    for tag in ('17a', '17b'):
        timings[f'{tag}_s_per_step'] = p17[tag]['step_s']
        timings[f'{tag}_bytes_per_eval'] = p17[tag]['per_eval']
    panel.cleanup()
    with bench_dir:
        t0 = time.perf_counter()
        p18 = run_phase18(bench_tmp, smi, baseline)
        timings['phase18_s'] = time.perf_counter() - t0
        for tag, (line, _, seconds) in p18.items():
            timings[f'{tag}_iters_per_s'] = line['value']
            timings[f'{tag}_s'] = seconds
        log(f'  phase 18: {timings["phase18_s"]:.1f} s')
        phase(f'phase 19: the drift check, {DRIFT_BASE} against '
              f'{", ".join(leg for leg, _ in DRIFT_CARD_LEGS)} on 18a\'s '
              f'problem, {DRIFT_ITERS} outer steps (the legs started after '
              f'phase 12, {time.perf_counter() - t19:.1f} s ago)')
        t0 = time.perf_counter()
        p19 = run_phase19(bench_tmp, smi, legs)
        timings['phase19_s'] = time.perf_counter() - t0
        for leg, (rep, _, seconds) in p19.items():
            timings[f'19_{leg}_accumulator_drift'] = rep[
                'elbo_accumulator_drift_test']
            timings[f'19_{leg}_steps_s'] = seconds
        log(f'  phase 19: {timings["phase19_s"]:.1f} s')
    log(f'  timings {json.dumps(timings)}')
    log(f'  all phases: {time.perf_counter() - t_start:.1f} s')

    print(smi, flush=True)
    table = [dict(name=name, route='cuda', source=meta['source'],
                  replaces=meta['replaces'], launches=launches[name],
                  **results[name])
             for name, meta in KERNELS.items()]
    print(json.dumps({'kernels': table}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    try:
        main()
    except SmokeFailure as exc:
        print(f'chip_smoke FAILED: {exc}', file=sys.stderr)
        sys.exit(1)
    finally:
        stop_background()
