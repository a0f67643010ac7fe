"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                    # every phase
    python3 chip_smoke.py --phases build,C,E # a subset, for a quick check
    python3 chip_smoke.py --phases build,multidevice  # the multi-device layer
    python3 chip_smoke.py --phases build,ring  # geometry sharded by ring orbits
    python3 chip_smoke.py --phases build,grid_build  # the grid builders G and H
    python3 chip_smoke.py --phases build,parity  # the CLI's flags and the bench's single mode

Run from the repository root on a machine with a CUDA device.  Phases,
each printing one JSON line:

  1. device: PyTorch/CUDA versions, the card's name and power limit;
  2. build: compile every kernel of csrc/ (one nvcc per source, in
     parallel) and time it; registers and spills of every kernel;
  3. kernel A (csrc/brute_intersect.cu) against its plain PyTorch version
     on the serial scene's 256x256 camera rays and their shadow rays:
     hit and tri_id equal, t bitwise equal;
  4. kernel B (csrc/traverse_grid.cu) against its plain version on the
     same rays and on the parallel scene's grid and camera, float32 and
     float64 determinants, faithful and production modes: all five
     TraceResult fields equal;
  5. kernel C (csrc/packed_march.cu) against its plain version on the
     turbo serial grid's 256x256 camera rays, one lane per ray and on the
     compacted and the chord-ordered queues (directly and through
     persistent_trace): fused with and without the dead-shadow skip,
     nearest and any hit, inline and blocks layouts (and a probe chain),
     rows of 14, 28 and 56 triangles: every record field bitwise equal,
     no ray capped;
  6. kernel E (csrc/whitted_wave.cu) against its plain version: the turbo
     parallel scene at 256x256, the serial scene at 256x256 with
     whitted_wave="on", the parallel scene at 128x128 with spp 2, and with
     spp 2 and a lens (aperture 0.25, focus 20): the camera rays E makes
     bitwise equal to the CPU batch (which the plain version traces),
     colors bitwise equal, every counter equal, no lane capped;
  7. the main path at full size, launch counts zeroed before each render
     and read after it, each config required to launch its kernel:
     prepare + render of the serial scene at 1024x1024 with the default
     config (csr), traversal="brute_pallas" and the tuned production
     config (config.apply_turbo: packed grid, persistent fused march);
     median of 5 renders after a warm-up and Mrays/s (primary + shadow);
     the images agree with the csr image up to boundary pixels; the
     command line renders the csr and the --turbo PPM bytes; the turbo
     parallel scene at 1024x1024 through the cross-depth Whitted wave (one
     launch of E a frame and none of C; median of 5, each frame under
     torch.cuda.set_sync_debug_mode("error"), so that a device-to-host
     copy or a synchronisation inside render raises; the profile's device
     kernels, pixels and segments marched a second of frame; E's camera
     rays against the CPU batch; its image against the bounce loop's, 4
     launches of C, by the 2-count rule; the command line's PPM bytes);
     one timed render of the 3-bounce parallel scene at 512x512, csr and
     turbo (whitted_wave="off");
  8. card vs CPU: the 64x64 float64 csr render gives the PPM bytes of the
     port's own CPU render; the 64x64 turbo march gives the CPU's per-ray
     records, and its image differs by more than 2 counts on under 1% of
     pixels; so does the 64x64 turbo parallel image through the wave, and
     where its floats differ, the pow inputs of those pixels are taken on
     both devices (the plain wave on the card with pow on the CPU gives
     the CPU's colors);
  9. kernel D (csrc/gather_row_test.cu) against its plain version through
     the port's gather tool, and the tool's step-loop time;
 10. kernel F (csrc/gi_wave.cu, the cross-depth GI wave: stage P, the
     persistent stage S and the fold) against its plain version on the
     card: the turbo serial scene at 128x128 with S = 4, D = 2, the turbo
     parallel scene (the mirror mix) at 128x128 with S = 2, D = 3, the
     escape-only plane, D = 0, 100x75 pixels with S = 3, D = 2 (the
     queues' tails) and S = 8, D = 1 (the fold's order): the radiance
     bitwise equal and every counter equal, no pixel capped.  In phase 7
     (main) the path-traced render: the official GI row (turbo serial,
     1024x1024, S = 4, D = 2) through prepare + render, one call of F a
     frame and nothing else, each frame under
     torch.cuda.set_sync_debug_mode("error"), Mpaths/s and F's segments a
     second, the ten-frame profile and the CUDA kernels a frame runs; the GI
     wave against the segment integrator at 256x256 (the serial and
     parallel scenes, the JAX package's statistical rule); the command
     line's GI PPM; and the turbo nefertiti scene at 1024x1024 (kernel C,
     the tuned knobs) against its csr image (kernel B) by the 2-count rule.
     Every launch of C that the segment integrator and the nefertiti
     frame make is logged and held, at its own inputs, to the plain
     version: records bitwise, the rows tested and touched, the capped
     lanes and the most steps equal.  Each path's launch counts on a line
     of their own.  In phase 8 the 64x64 GI wave renders, card against
     CPU, bitwise; and the 64x64 segment integrator over the csr grid
     (S = 2, D = 1, the command line's default GI): each launch of B held
     to the plain version (records bitwise, rows tested equal) and the
     image against the CPU's by the 2-count rule.
 11. the appearance epilogues (phase appearance): kernel F's feature
     instantiations (csrc/texture.cuh; environment map, smooth normals,
     checker or image texture) against the plain version on ten cases at
     64x64 to 128x128 (the env furnace, a non-constant map, smooth normals
     on the plane and the gradcheck scene, both textures at depth 0 and 1,
     every feature with the mirror mix on a quad and on the parallel
     scene), radiance and every counter bitwise; the official GI row with
     smooth normals, a 256x256 image texture and a 256x512 environment
     map (numpy, fixed seed) through prepare + render, one call of F a
     frame, held bitwise to the plain version, timed beside the
     featureless row (median of 5 frames under the sync debug mode, the
     profile's busy time, F's device time) with ptxas's registers of every
     instantiation (the featureless stages must not spill); and the turbo
     serial Whitted bounce loop with all three at 1024x1024 (kernel C, not
     E), card against CPU at 64x64 by the 2-count rule.
 12. the train step (phase train): BASELINE config 4, the turbo nefertiti
     scene at 1024x1024 with verts, base_color, kd, ks, ka and light_pos
     trainable, 6 steps of opt.fit.fit (Adam, lr 1e-2) against the
     self-demo target (kd x 1.5, base_color x 0.6) with a grid rebuild
     after step 3: launch counts zeroed before the fit and read after it
     (C launched), the losses finite and falling, each step's CUDA-event
     time (the median of the steps after the first), Mrays/s forward +
     backward at 2 rays a pixel, the rebuild's seconds, the peak device
     memory, a three-step profiler window's busy time and idle share;
     kernel C's launch on the first step held to its plain version
     bitwise; the forward under autograd bitwise render()'s image (the
     nefertiti scene, and the gradcheck scene at 64x64 with soft
     visibility and soft primary); on that gradcheck scene the loss card
     against CPU to rtol 1e-6 and every gradient leaf to rtol 1e-4, atol
     1e-6 max|g|; the soft-primary silhouette gradient of one triangle at
     16x16 against central differences (rtol 5e-2).
 13. every light and material (phase lights), at 1024x1024 through
     prepare + render, each frame launching kernel C and neither wave:
     (a) the turbo serial scene with two extra lights and a 16-sample area
     light of radius 0.5, byte-equal at shadow_sample_batch 1 and 4; (b)
     the turbo parallel scene (3 bounces) with one extra light; (c) the
     path-traced serial scene (S 4, D 2) with one extra light, blub made
     glass (ior 1.5) and env NEE under a 64 x 128 sky (the segment
     integrator); each frame's CUDA-event time (median of 5), kernels,
     busy time and idle share beside its featureless frames (the bounce
     loop and the waves); every launch of C that (a) makes at batch 4 (the
     4R shadow rays of four samples, queued live rays only) and (c) makes
     held to the plain version at its own inputs, records and counters
     bitwise; (d) five Adam steps of opt.fit.fit on the gradcheck scene at
     256x256 with one extra light, extra_light_pos, extra_light_intensity
     and light_pos trainable (kernel B), each timed, the losses finite and
     falling; at 64x64 card against CPU, (a) to (c) and (a) over the csr
     grid by the 2-count rule, (d)'s loss to rtol 1e-6 and gradients to
     rtol 1e-4, atol 1e-6 max|g|.  The lights' positions are LIGHTS_A,
     LIGHTS_B, LIGHTS_C and LIGHTS_FIT below.

 14. dtype="float64" (phase float64), at 1024x1024 through prepare +
     render: the csr serial frame with float32 and with float64 dets
     (kernel B's f64-ray instantiations: the launch counter of float64
     rays rises, and every launch is held bitwise to the plain version at
     its own inputs, records and rows tested), the turbo serial frame (C
     on float32 copies of the rays, the epilogue on the float64 rays) and
     the GI segment integrator at 256x256 (S 4, D 2; the GI wave refuses
     float64), each a float64 image, timed beside its float32 frame
     (CUDA events, kernels a frame, busy and idle); at 64x64 card against
     CPU, the csr frame with float64 dets by its PPM bytes and the others
     by the 2-count rule.
 15. the inspection path (phase inspect), on the turbo serial scene and
     the csr serial scene at 1024x1024: render_aovs (one launch, ids and
     flags its record's), render_ao at 16 samples (a primary and 16
     any-hit launches), every launch of B and C held bitwise to the plain
     version; trace_pixel at three pixels, each the frame's primary
     record there; render_banded with 8 bands, the same floats as
     render(); collect_render_metrics (its two launches of C held) and the
     three probes with their picks and wall times on the bench's
     spot_1024 and nefertiti_1024 rows; the command line's stats, debug,
     aov and info at 256x256 as subprocesses, each exiting 0 with output
     that parses.
 16. ray-sharded multi-device (phase multidevice): (a) in one process, E on
     parallel_1024 and F on the GI row dealt to 4 shard queues
     (pix_offset, pix_stride, queue_len), contiguous and round-robin: the
     shards' rows composed are the single launch's bits, each shard's
     CUDA-event time beside the single launch's; at 256x256 with a dead
     position a shard, every shard's launch against its plain version on
     the same queue, colors and counters bitwise; (b) on a process group
     of one rank (NCCL) and of two ranks sharing the card (gloo; this
     process is rank 0, the other a `chip_smoke.py --rank-job` process),
     render_sharded of spot_1024 (C), the csr serial frame (B),
     parallel_1024 (E) and the GI row (F) bitwise render()'s at both
     dealings, each kernel launched (the counts zeroed just before the
     sharded frame and read just after), frame wall times beside
     render()'s and rank 0's busy time; (c) 3 sharded Adam steps on
     spot_1024 (verts and materials), each against an unsharded step from
     the same parameters (loss rtol 1e-6, gradients rtol 1e-4 with atol
     1e-6 max|g|), the parameters bitwise equal on every rank, the losses
     falling; (d) sharded render_aovs bitwise one device's, and `cli
     render --devices 1` (one NCCL rank the command starts) writing `cli
     render`'s PPM bytes; (e) scaling_report at [1] and [1, 2] and
     balance_report at 4 shards on spot_1024 and nefertiti_1024.  The
     backend that carried the collectives is on every line; two ranks on
     one card give no scaling number.
 17. geometry sharded by ring orbits (phase ring): (a) in one process, the
     dealing of a 4-card ring on nefertiti_1024: each rank of a four-rank
     gloo group on this card builds its own shard (build_ring_shard, the
     build of every ring entry point given no grids), its host seconds
     printed, and this process stacks the four; kernel C on each shard's
     grid over the whole 1024^2 primary batch, merged by the orbit's rule
     (smaller t, or equal t and the lower global id) against the
     replicated march of the same rays (the differing ids counted and held
     to 1e-4 of the rays), each launch's CUDA-event time beside the
     replicated launch's, shard 1's launch held bitwise to the plain
     version; (b) on the one-rank NCCL group and the two-rank gloo group
     of phase multidevice, one "tris" axis over the ranks:
     render_sharded_geometry with grid hops on spot_1024 (every launch of
     C held bitwise to the plain version), parallel_1024 (three mirror
     bounces) and the GI row through the ring tracer (512x512 at two
     ranks), each against render() (the GI row against the segment
     integrator on the same camera rays) on every pixel whose orbits all
     agree with the same frame's orbits replaced by the replicated march
     (the ids of every path orbit, the hit flags of every shadow orbit),
     to the JAX ring tests' tolerances (atol 1e-4, rtol 1e-5; GI atol
     5e-3, rtol 1e-3), no pixel excepted; the pixels whose orbits differ,
     and those whose primary ids differ, counted and held to 1e-4 of the
     pixels; wall times beside render()'s, C's launches a frame, rank 0's
     busy time; the bytes a hop moves and one hop's time; the all-pairs
     ring on the serial scene at 128x128 (the same bits at one and two
     ranks); 3 ring train steps on spot_1024 (verts and materials), each
     against the unsharded step (loss rtol 1e-6, gradients rtol 1e-4 with
     atol 1e-6 max|g|), the parameters bitwise equal on every rank;
     render_aovs and render_ao (8 samples) with ring=True (ids and flags
     exact, floats to 1e-5) and trace_pixel(mesh=) at three pixels; (c)
     `cli render --ring --devices 2` (two gloo ranks sharing the card) at
     1024^2 writing the PPM bytes of (b)'s two-rank spot_1024 image.

 18. the grid builders (phase grid_build, before main): nefertiti_1024's
     turbo prepare with the launch counts set to 0 just before it and read
     just after (kernels G and H each launched; its seconds printed), and
     the JAX package's ring build of its four shards in one process
     (build_ring_grids: G and H four times each; its seconds); that
     prepare and one rebuild of the config-4 fit split into their parts
     (utils/timing.split_parts: the scene, build_grid's host frame, H, the
     CSR's copies to the host, G, its words to the host, pack_grid's numpy
     rows, the upload, B's, E's and F's tables; host seconds fenced by a
     device sync, CUDA-event ms inside); on spot_1024's and
     nefertiti_1024's turbo grids (SAT-exact) and on spot_1024's csr grid
     (AABB binning, the main path's csr prepare) kernel H
     (csrc/grid_bin.cu) against its plain version on the same CUDA
     tensors, cell_start and tri_ids bitwise and equal to the grid
     build's, its host syncs counted under the sync debug mode (at most
     2), its parts in CUDA events, and max_per_voxel; on spot at a forced
     2x2x2 resolution (cells past kBlockSort) H bitwise; kernel G
     (csrc/empty_boxes.cu) against its plain version on the grid's
     occupancy, the packed words, the greedy slab-test count and the box
     counts made (probes, slab tests) bitwise; each kernel's CUDA-event
     time (5 calls), its profiled device time by kernel, its plain
     version's time on the card and its bound (G: the box counts made,
     OPS_PER_PROBE_G and OPS_PER_TEST_G, at the INT32 rate, and beside it
     the greedy tests' bound; H: the SAT test's float64 operations, or
     its bytes on an AABB grid), and torch.cumsum's summed-area table
     beside G's own; on spot the card's grid and packed grid byte-equal
     to the CPU build's.  The nefertiti row's times go to the kernels line.
 19. the last parity gaps (phase parity, after inspect), at 1024x1024:
     through `ray_tracer_tpu_torch.cli.main` in this process, each command's
     launch counts set to 0 just before it and read just after, (a) `render
     --scene gradcheck` (kernel B; every launch logged and held bitwise to
     the plain version, the PPM render()'s bytes), (b) `render --scene
     parallel --turbo --gi-samples 4 --gi-depth 2 --gi-no-specular
     --light-intensity PARITY_GI_LIGHT` (the GI wave without its mirror mix:
     one call of F, held bitwise to the plain version with every counter;
     the PPM render()'s bytes for gi_specular=False and not the specular
     render's), (c) `render --scene serial --turbo --profile DIR` (the
     trace file names packed_march_kernel); then as subprocesses, one after
     another, `bench_torch.py --size 1024 --scene spot`, `cli bench --width
     1024`, `bench_torch.py --gi 4 --gi-depth 2` and `bench_torch.py
     --grad` (the first with bench_torch's start-up probe, the others
     without it: BENCH_PROBE_TIMEOUT=0): one JSON line each with
     bench.py's keys for the mode (BENCH_PY_KEYS) beside `device` and
     `card`, a nonzero oracle and vs_baseline its value over the oracle's
     on the forward lines, and the mode's kernel launched (C, or F for GI;
     the counts each writes to stderr); then (d) bench.py's knob overrides (KNOB_RUNS: spot --layout
     inline / blocks, --fused on / off, --scheduler persistent / tiled,
     --exact on / off; parallel --whitted-wave on / off; GI S 4 D 2
     --gi-wave on / off) through bench_torch.single in this process, each
     run's first frame's launches of B, C, E and F counted from 0, logged
     and held bitwise to the plain version (records or colors, and every
     counter), a line a run with the knobs taken, the best and median
     value, busy and idle over a ten-frame profile and the probes' picks.
     The phase's paths go on a launches_by_path line of their own, and its
     seconds on a line.

Then the kernel times at the main path's shapes (each launch held
bitwise to the plain version; B's, C's and E's barycentric passes, and
E's camera rays, vertices and reflections, counted for their operation
bounds; C's device time against its time before the shared header; E's
lane utilisation before and after its redesign, on lines of their own;
F's device time as the sum of its kernels and memset, each stage's
beside it, its lane utilisation before and after its redesign, its
events over launches, its plain version once and its bound from its
counters, with ptxas's registers and spills; B's f64-ray instantiations
on the 1024^2 csr frame's float64 camera rays, float32 and float64 dets,
each held bitwise to the plain version, with registers and spills and a
bound from the tests at the determinants' rate and the float64 DDA steps
at the FP64 rate; the JAX package's K7, the all-pairs hit as six matrix
products, on 16,384 rays against the serial scene's triangles beside the
six torch.matmul products alone and the Cramer sweep),
a `kernels` line, the card line, and last {"ok": true, "device": {...}}.  Any
failure raises and exits non-zero; without a CUDA device it exits
non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores, HBM3.
# The FP32 peak counts a fused multiply-add as two operations; the kernels
# build with -fmad=false, so they issue at most half of it.
PEAK_FP32_OPS = 67e12
PEAK_FP32_UNFUSED = PEAK_FP32_OPS / 2
PEAK_BYTES = 3.35e12
# FP32 operations per (ray, triangle) pair of kernel A, counted from
# ray_tracer_tpu/ops/pallas_intersect.py:65-83 with the common products
# shared: s (3), det A (11), t numerator (11), beta numerator (11), gamma
# numerator (5 beyond the shared terms), 1/A (1), three products (3),
# beta + gamma (1), and the five comparisons of the acceptance test.
OPS_PER_PAIR_A = 51
# FP32 operations per tested triangle of kernels B and C (cramer.cuh
# cramer_pass_t, 11 a determinant as for A and D): one that fails the
# barycentric test takes the three columns (9), the determinant A and
# beta's and gamma's numerators (33), two divisions (2) and the test (4);
# one that passes adds t's numerator (11), its division (1) and the gate
# (1).  The kernels count the passes of this run's data.
OPS_PER_FAILED_TEST = 48
OPS_PER_PASSED_TEST = 61
# H100 SXM FP64 outside the tensor cores (NVIDIA data sheet: 34 TFLOP/s,
# a fused multiply-add counted as two operations), unfused as for FP32.
PEAK_FP64_UNFUSED = 34e12 / 2
# Float64 operations per DDA step of kernel B's f64-ray instantiations: the
# three crossing comparisons, the early-exit minimum, the move comparison
# and the crossing's advance (two selects not counted).
OPS_PER_STEP_B_F64 = 6
# FP32 operations per (ray, triangle) pair of K7 (ops/intersect.py
# mxu_intersect_all_pairs): six 3-term products (5 each), t (2), beta and
# gamma (3 each), the acceptance test with the gate (6) and the masked
# minimum (2).
OPS_PER_PAIR_K7 = 46
# FP32 operations per triangle lane of kernel D, counted as for B: the
# columns (9), four determinants (44), 1/A (1), three products (3), the
# acceptance test (5) and the running minimum (1).
OPS_PER_LANE_D = 63
# FP32 operations per vertex of kernel E beyond its slot tests (counted as
# for C), from csrc/whitted_wave.cu with a normalize at 10 (length 5, sqrt,
# reciprocal, three products) and powf at 3 (lg2, multiply, ex2): the
# recomputed t (columns 9, two determinants 22, the division), the two hit
# points (12), the normal (edges 6, cross 9), the view and light directions
# (3 + 10 each), h (3 + 10, normalized in the parallel variant), n.l and
# n.h with their max (12), powf, A and B (21 in the parallel variant); the
# shadow ray (light - poi 3, length 6, divisions 3) and its slab entry (30:
# three reciprocals, six subtractions, six products, the min/max folds);
# and the blend (color 6, tint and 1 - km 7, the weighted sum 6).
OPS_PER_VERTEX_E = 195
# ... and per reflection: the normalized incident direction and normal
# (20), the dot and its double (6), nn * two and the subtraction (6), the
# normalized result (10), the slab entry (30), the weight (1) and an
# escape's background (6).
OPS_PER_REFLECTION_E = 79
# ... and per camera ray it makes (csrc/camera.cuh, the pinhole): xw (4) and
# yw (3), the direction (a negation, three products and two sums a
# component: 18), its normalize (10), and the primary's reciprocal
# direction (3) and slab entry (30).
OPS_PER_CAMERA_RAY_E = 68
# FP32 operations of kernel F beyond its slot tests, counted from
# csrc/gi_wave.cu as for E (a normalize at 10, a hash at 14 integer
# operations, float64 cos and sin at one each): per vertex the recomputed t
# (32), the two hit points (12), the oriented face normal (33), the NEE
# terms (31), the branch draw (14), the shadow direction (12) and its slab
# entry (30), the banked NEE (3): 167; per bounce or restart the key and
# two draws (30), the basis (16), the cosine sample (24), the mirror
# (12), the slab entry (30) and the throughput and reciprocal direction
# (6): 118, counted for the bounces that entered the grid; per escape the
# background term (6) alone; per pixel the camera ray (68, as for E), its
# key (11) and the sum of its S samples (3 each).
OPS_PER_VERTEX_F = 167
OPS_PER_BOUNCE_F = 118
OPS_PER_ESCAPE_F = 6
OPS_PER_PIXEL_F = 79
OPS_PER_SAMPLE_F = 3
# H100 SXM INT32 rate outside the tensor cores: 64 results a clock an SM
# (Hopper's arithmetic pipes), 132 SMs, at the 1,980 MHz boost clock.
PEAK_INT32_OPS = 64 * 132 * 1.98e9
# Integer operations per slab test of kernel G (csrc/empty_boxes.cu), the
# arithmetic one test needs: the cap-and-failed test (1), the slab's face
# coordinate (1), six clamps of two operations and three +1 (15), the
# eight table addresses from four row products and twelve sums (16), the
# eight-term sum (7), the zero test and the growth or the failure mark
# (2).  The kernel's test counter is not counted, and neither are the
# other five box faces, which a held box need not recompute.  The tests
# are those this run's data needs: a direction is tested while it is
# below the cap and has not failed (a failed slab only widens, so the
# numpy lock-step's re-tests of it change no bit; the kernel skips them).
OPS_PER_TEST_G = 42
# Integer operations per probe of kernel G's jump search (csrc/empty_boxes.cu),
# counted as a slab test is: the search's midpoint (3), the box's six faces
# from the cell and the radius (6), six clamps of two operations and three
# +1 (15), the eight table addresses (16), the eight-term sum (7), and the
# zero test with the update of the range (3).  The directions that failed
# (a select each) are not counted.  G's bound counts the probes and slab
# tests its counters report (queries_out); the greedy loop's tests at
# OPS_PER_TEST_G give the bound that the cell-a-thread kernel had.
OPS_PER_PROBE_G = 50
# Float64 operations of kernel H's SAT test (csrc/grid_bin.cu) per
# candidate that survives it: the box and the vertices against its centre
# (14 an axis: 42), the edges (9), the plane normal (9), and the 10 axes
# it tests, the plane axis and the nine edge axes, at 30 each (three
# 5-operation projections, the radius 8, the fold 4, -r and two
# comparisons: 300); the three box axes are the AABB expansion's, not the
# test's.  A rejected candidate needs at least the first 60 and one axis
# (30), which is all this bound counts for it.
OPS_PER_SURVIVOR_H = 360
OPS_PER_REJECT_H = 90
ALL_PHASES = ("build", "A", "B", "C", "E", "F", "grid_build", "main", "card_vs_cpu",
              "appearance", "lights", "float64", "inspect", "parity", "train", "multidevice",
              "ring", "D", "times")
# The kernels' device times on the 1024^2 main path before this version
# of the sources (B and C as redesigned, before C's march step moved into
# csrc/packed_step.cuh), NVIDIA H100 80GB HBM3 at 700 W, as recorded in
# PERF.md; C's must stay within 5%.
PREVIOUS_MS = {"B": {"device_ms": 0.4504}, "C": {"device_ms": 0.4288}}
# Kernel E on the turbo parallel 1024^2 frame before its redesign as a
# persistent wave (one thread a queue position, the camera batch in
# memory), on the same card as recorded in PERF.md: device time and lane
# utilisation (active lane-steps over 32 x warp loop iterations).
PREVIOUS_E = {"device_ms": 1.8276, "lane_utilisation": 0.7347491342129305}
# Kernel F on the official GI row (turbo serial 1024^2, S 4, D 2) before its
# redesign (one thread a pixel serving all its samples, no queue), on the
# same card as recorded in PERF.md: device time, lane utilisation (active
# lane-steps over 32 x warp loop iterations) and the share of warp steps
# in which a lane ended a segment.
PREVIOUS_F = {"device_ms": 1.1417, "lane_utilisation": 0.5449485670180693,
              "transition_share": 0.6849817278403751}


# Phase lights: the extra point lights, (x, y, z, intensity): (a) two on the
# turbo serial scene, (b) one on the turbo parallel scene, (c) one on the
# path-traced serial scene, and one on the gradcheck scene of the fit (d);
# and the area light of (a).
LIGHTS_A = ((-5.0, -5.0, 2.0, 128.0), (0.0, 5.0, 5.0, 96.0))
LIGHTS_B = ((-6.0, 8.0, 4.0, 0.6),)
LIGHTS_C = ((0.0, 5.0, 5.0, 96.0),)
LIGHTS_FIT = ((-4.0, 6.0, -2.0, 1.0),)
AREA_LIGHT = dict(light_radius=0.5, shadow_samples=16)
# Phase parity: the primary light's intensity of the path-traced parallel
# scene (its faithful light, 1, is black in GI's radiometric units), and the
# keys of bench.py's JSON line in each mode (bench.py:519-533, _bench_gi,
# _bench_grad), which bench_torch.py's single measurement prints.
PARITY_GI_LIGHT = 5000.0
BENCH_PY_KEYS = {
    "forward": {"metric", "value", "unit", "vs_baseline", "seconds_per_frame", "value_median",
                "secs_chains", "size", "oracle_mrays_per_s", "device"},
    "gi": {"metric", "value", "unit", "vs_baseline", "seconds_per_frame", "secs_chains", "size",
           "gi_samples", "gi_depth", "paths_per_s_m", "paths_per_s_m_median"},
    "grad": {"metric", "value", "unit", "vs_baseline", "seconds_per_step", "size", "trainable"},
}
# Phase parity's knob runs: bench.py's overrides through bench_torch.single
# at 1024^2, each pair one TPU-tuned choice and its other side, run one after
# the other
KNOB_RUNS = (
    ("spot_layout_inline", ["--scene", "spot", "--layout", "inline"]),
    ("spot_layout_blocks", ["--scene", "spot", "--layout", "blocks"]),
    ("spot_fused_on", ["--scene", "spot", "--fused", "on"]),
    ("spot_fused_off", ["--scene", "spot", "--fused", "off"]),
    ("spot_scheduler_persistent", ["--scene", "spot", "--scheduler", "persistent"]),
    ("spot_scheduler_tiled", ["--scene", "spot", "--scheduler", "tiled"]),
    ("spot_exact_on", ["--scene", "spot", "--exact", "on"]),
    ("spot_exact_off", ["--scene", "spot", "--exact", "off"]),
    ("parallel_whitted_wave_on", ["--scene", "parallel", "--whitted-wave", "on"]),
    ("parallel_whitted_wave_off", ["--scene", "parallel", "--whitted-wave", "off"]),
    ("gi_s4d2_gi_wave_on", ["--gi", "4", "--gi-depth", "2", "--gi-wave", "on"]),
    ("gi_s4d2_gi_wave_off", ["--gi", "4", "--gi-depth", "2", "--gi-wave", "off"]),
)
KNOB_ROUNDS = 5  # timed chains of bench_torch's 8 frames a knob run
# Phase ring: the all-pairs ring's image size (its sweep is every ray
# against every triangle of the serial scene).
RING_BRUTE_SIZE = 128
# the share of rays whose ring ids may differ from the replicated march's
# (shared-edge flips between per-shard grids; 0 in every reading so far)
RING_IDS_DIFFER = 1e-4


def extra_lights(raw):
    from ray_tracer_tpu_torch.config import LightConfig

    return tuple(LightConfig(position=e[:3], intensity=e[3]) for e in raw)


def bound_of(n_bytes, n_ops, peak_ops):
    """(bound ms, what bounds it): bytes at the HBM rate, operations at
    `peak_ops` a second."""
    tb, to = n_bytes / PEAK_BYTES, n_ops / peak_ops
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, n: int) -> float:
    """CUDA-event time of n back-to-back fn() calls over n, after one
    warm-up: the host's work in the wrapper overlaps the device's."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


def calls_device_ms(fn, n: int, kernel: str = ""):
    """Device time of one fn() call from n calls under torch.profiler: the
    kernels and memsets whose name holds `kernel` summed, and the same by
    name; (None, {}) if the profiler saw none.  The profiler can drop a
    few of a window's events, so a name's launches a call are the ceiling
    of its events over n, each at its mean duration."""
    from ray_tracer_tpu_torch.tools.profiling import profiled_kernels

    kernels, _ = profiled_kernels(fn, n)
    by_name = {}
    for e in kernels:
        if kernel in e.name:
            by_name.setdefault(e.name, []).append(e.time_range.end - e.time_range.start)
    per_call = {k: -(-len(v) // n) * sum(v) / len(v) / 1e3 for k, v in by_name.items()}
    if not per_call:
        return None, {}
    return sum(per_call.values()), per_call


def once_ms(fn):
    """(CUDA-event time of one fn() call, its result)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), out


def compare(label: str, got, want) -> float:
    """Fields equal (floats bitwise); raise with a count and an example
    otherwise.  Returns the max |difference| of the float fields."""
    err = 0.0
    names = getattr(got, "_fields", None) or [str(i) for i in range(len(got))]
    for name, g, w in zip(names, got, want):
        if g.dtype == torch.float32:
            bad = g.view(torch.int32) != w.view(torch.int32)
            both = torch.isfinite(g) & torch.isfinite(w)
            if bool(both.any()):
                err = max(err, float((g[both] - w[both]).abs().max()))
        else:
            bad = g != w
        n = int(bad.sum())
        if n:
            i = int(bad.nonzero()[0, 0])
            raise AssertionError(
                f"{label}: field {name} differs in {n} of {g.numel()} lanes; "
                f"lane {i}: kernel {g[i].item()!r}, plain {w[i].item()!r}")
    return err


def ptxas_usage(lib_path: str) -> dict:
    """Registers and spill bytes per kernel from the build's -Xptxas -v log,
    keyed by the kernel's name and its mangled template arguments (e.g.
    traverse_grid_kernelIdEE: double determinants)."""
    with open(lib_path + ".log") as fh:
        log = fh.read()
    out = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"([a-z_]+_kernel)(I\w*?EE)?", m.group(1))
            name = k.group(1) + (k.group(2) or "") if k else m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out.setdefault(name, {})["stack_frame"] = int(m.group(1))
            out[name]["spill_stores"] = int(m.group(2))
            out[name]["spill_loads"] = int(m.group(3))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def image_rule(a, b) -> float:
    """Share of pixels whose channels differ by more than 2 counts."""
    diff = abs(a.astype(int) - b.astype(int)).max(axis=-1)
    return float((diff > 2).mean())


class Logged:
    """Stands in for a kernel's wrapper in the module that calls it: each
    call's inputs and records (cloned, so that later frames, or a fit's
    in-place updates of the light, cannot change them) go to `log`; the
    launch count stays the wrapped function's."""

    def __init__(self, fn, kernel: str, log: list):
        self.fn, self.kernel, self.log = fn, kernel, log

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    @property
    def launches_f64(self):  # kernel B's launches of its f64-ray instantiations
        return self.fn.launches_f64

    @launches_f64.setter
    def launches_f64(self, n):
        self.fn.launches_f64 = n

    def __call__(self, rays, *args, **kw):
        from ray_tracer_tpu_torch.core.rays import RayBatch

        out = self.fn(rays, *args, **kw)
        kept = {k: v.clone() if k == "queue" and v is not None else v for k, v in kw.items()}
        args = tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        self.log.append((self.kernel, RayBatch(*(x.clone() for x in rays)), args, kept,
                         type(out)(*(x.clone() for x in out))))
        return out


class LoggedWave(Logged):
    """Logged for kernel E's or F's wrapper, which takes a camera: each
    call's camera, tables, knobs and colors (cloned) go to `log`."""

    def __call__(self, camera, *args, **kw):
        out = self.fn(camera, *args, **kw)
        self.log.append((self.kernel, camera, args, dict(kw), out.clone()))
        return out


class Smoke:
    """The phases share the card, the imports and what each phase measured
    for the `kernels` line."""

    def __init__(self):
        from ray_tracer_tpu_torch.accel import native as kGH
        from ray_tracer_tpu_torch.ops import brute_intersect as kA
        from ray_tracer_tpu_torch.ops import traverse as kB
        from ray_tracer_tpu_torch.ops import traverse_packed as kC
        from ray_tracer_tpu_torch.ops import gi_wave as kF
        from ray_tracer_tpu_torch.ops import whitted_wave as kE
        from ray_tracer_tpu_torch.tools import gather_bench as kD

        self.kA, self.kB, self.kC, self.kD, self.kE, self.kF = kA, kB, kC, kD, kE, kF
        self.counters = {"brute_intersect": kA.brute_intersect_cuda,
                         "traverse_grid": kB.traverse_grid_cuda,
                         "packed_march": kC.march_cuda,
                         "gather_row_test": kD.gather_row_test_cuda,
                         "whitted_wave": kE.whitted_wave_cuda,
                         "gi_wave": kF.gi_wave_cuda,
                         "empty_boxes": kGH.empty_boxes_cuda,
                         "grid_bin": kGH.bin_triangles_cuda}
        self.dev = torch.device("cuda")
        self.root = os.path.dirname(os.path.abspath(__file__))
        self.launches = {}
        self.err = {"brute_intersect": 0.0, "traverse_grid": 0.0, "traverse_grid_f64": 0.0,
                    "packed_march": 0.0,
                    "gather_row_test": 0.0, "whitted_wave": 0.0, "gi_wave": 0.0,
                    "empty_boxes": 0.0, "grid_bin": 0.0}  # G and H: integers, held bitwise
        self.times = {}
        self.images = {}
        self.libs = {}
        self.ptxas = {}
        self.wave_frame = None  # (cfg, prepared) of the turbo parallel 1024^2 frame
        self.gi_frame = None  # the prepared official GI row (turbo serial 1024^2, S 4, D 2)
        self.path_launches = {}  # each main-path render's launch counts
        self.nef_prep = None  # the prepared turbo nefertiti 1024^2 scene (BASELINE config 4)

    def zero_counts(self):
        for fn in self.counters.values():
            fn.launches = 0
        self.kB.traverse_grid_cuda.launches_f64 = 0

    def counts(self):
        return {k: fn.launches for k, fn in self.counters.items()}

    @contextlib.contextmanager
    def logging_launches(self):
        """Log every launch of kernels B and C that the port makes inside
        the block (through traverse.traverse_grid, traverse_packed.march
        and persistent.persistent_trace)."""
        from ray_tracer_tpu_torch.ops import persistent, traverse, traverse_packed

        log = []
        sites = ((traverse, "traverse_grid_cuda", "traverse_grid"),
                 (traverse_packed, "march_cuda", "packed_march"),
                 (persistent, "march_cuda", "packed_march"))
        saved = [(module, name, getattr(module, name)) for module, name, _ in sites]
        try:
            for (module, name, kernel), (_, _, fn) in zip(sites, saved):
                setattr(module, name, Logged(fn, kernel, log))
            yield log
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)

    @contextlib.contextmanager
    def logging_waves(self):
        """Log every launch of kernels E and F that the port makes inside
        the block (through whitted_wave.whitted_wave_trace and
        gi_wave.gi_wave_trace)."""
        from ray_tracer_tpu_torch.ops import gi_wave, whitted_wave

        log = []
        sites = ((whitted_wave, "whitted_wave_cuda", "whitted_wave"),
                 (gi_wave, "gi_wave_cuda", "gi_wave"))
        saved = [(module, name, getattr(module, name)) for module, name, _ in sites]
        try:
            for (module, name, kernel), (_, _, fn) in zip(sites, saved):
                setattr(module, name, LoggedWave(fn, kernel, log))
            yield log
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)

    def hold_waves(self, label, log) -> dict:
        """Each logged launch of E or F again with its counters, and its
        plain version on the CPU camera batch (on the card): the new launch
        gives the logged colors' bits, the plain version's bitwise, and
        every counter the plain version keeps equal.  Returns, by kernel,
        the launches and positions held."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        launch_only = ("spp", "cam", "consts", "pix_offset", "pix_stride", "queue_len")
        held = {}
        for i, (kernel, camera, args, kw, logged) in enumerate(log):
            where = f"{label}: launch {i} of {kernel}"
            spp = kw.get("spp", 1)
            whole = camera.width * camera.height * spp * spp
            if kw.get("pix_offset", 0) != 0 or kw.get("pix_stride", 1) != 1 or kw.get(
                    "queue_len", whole) != whole:
                raise AssertionError(f"{where}: a shard's queue, not the whole frame")
            rays = RayBatch(*(x.to(self.dev) for x in camera_rays(camera, spp=spp,
                                                                    device="cpu")))
            plain_kw = {k: v for k, v in kw.items() if k not in launch_only}
            if kernel == "whitted_wave":
                grid, meta = args[4], args[5]

                def z(*shape):
                    return torch.zeros(shape, dtype=torch.int32, device=self.dev)

                ck, cp = (dict(capped_out=z(1), passes_out=z(1), tested_out=z(rays.count),
                               touched_out=z(meta.n_blocks),
                               slots_out=z(grid.slot_tri.shape[0]),
                               events_out=z(len(self.kE.EVENTS))) for _ in range(2))
                got = self.kE.whitted_wave_cuda(camera, *args, **kw, **ck)
                want = self.kE.whitted_wave_plain(rays, *args, **plain_kw, **cp)
            else:
                ck, cp = self.gi_counters(), self.gi_counters()
                got = self.kF.gi_wave_cuda(camera, *args, **kw, **ck)
                want = self.kF.gi_wave_plain(rays, *args, **plain_kw, **cp)
            torch.cuda.synchronize()
            compare(f"{where} again", (got.reshape(-1),), (logged.reshape(-1),))
            self.err[kernel] = max(self.err[kernel], compare(
                f"{where} vs plain", (got.reshape(-1),), (want.reshape(-1),)))
            for name in ck:
                if not torch.equal(ck[name], cp[name]):
                    raise AssertionError(f"{where}: counter {name} differs from the plain "
                                         "version's")
            if int(ck["capped_out"].item()):
                raise AssertionError(f"{where}: {int(ck['capped_out'])} lanes capped")
            row = held.setdefault(kernel, {"launches": 0, "positions": 0})
            row["launches"] += 1
            row["positions"] += rays.count
        return held

    def hold_logged(self, label, log) -> dict:
        """Each logged launch of B or C again, with its counters, and its
        plain version on the same inputs: the new launch gives the logged
        records' bits, the plain version's records bitwise, and each
        counter the plain version keeps equal.  Returns, by kernel, the
        launches, rays, hits and capped lanes held."""
        from ray_tracer_tpu_torch.ops.persistent import _march_queued

        i32 = dict(dtype=torch.int32, device=self.dev)
        held = {}
        for i, (kernel, rays, args, kw, logged) in enumerate(log):
            r = rays.count
            where = f"{label}: launch {i} of {kernel}"
            if kernel == "traverse_grid":
                grid, meta, tri9 = args
                base = {k: v for k, v in kw.items()
                        if k not in ("tested_out", "passes_out", "tables")}
                tk, tp = torch.zeros((r,), **i32), torch.zeros((r,), **i32)
                got = self.kB.traverse_grid_cuda(rays, grid, meta, tri9, tables=kw.get("tables"),
                                                 tested_out=tk, **base)
                want = self.kB.traverse_grid_plain(rays, grid, meta, tri9, tested_out=tp, **base)
                counters = {"tested": (tk, tp)}
                capped = 0
            else:
                grid, meta, light = args
                base = {k: v for k, v in kw.items()
                        if k not in ("queue", "n_work", "consts", "tested_out", "touched_out",
                                     "capped_out", "iters_out", "passes_out")}
                ck, cp = ({"tested_out": torch.zeros((r,), **i32),
                           "touched_out": torch.zeros((meta.n_blocks,), **i32),
                           "capped_out": torch.zeros((1,), **i32)} for _ in range(2))
                iters = torch.zeros((1,), **i32)
                queue, n_work = kw.get("queue"), kw.get("n_work")
                got = self.kC.march_cuda(rays, grid, meta, light, queue=queue, n_work=n_work,
                                         consts=kw.get("consts"), iters_out=iters, **ck, **base)
                if queue is None:
                    want = self.kC.march_plain(rays, grid, meta, light, **cp, **base)
                else:
                    n_work = queue.shape[0] if n_work is None else int(n_work)
                    want = _march_queued(rays, grid, meta, light, (queue, n_work),
                                         cp["tested_out"], dict(base,
                                                                touched_out=cp["touched_out"],
                                                                capped_out=cp["capped_out"]))
                most = torch.full((1,), int(want.steps.max()) if r else 0, **i32)
                counters = {k[:-4]: (ck[k], cp[k]) for k in ck}
                counters["most_steps"] = (iters, most)
                capped = int(ck["capped_out"].item())
            torch.cuda.synchronize()
            compare(f"{where} again", got, logged)
            self.err[kernel] = max(self.err[kernel], compare(f"{where} vs plain", got, want))
            for name, (k, p) in counters.items():
                if not torch.equal(k, p):
                    raise AssertionError(f"{where}: counter {name} differs from the plain "
                                         "version's")
            row = held.setdefault(kernel, {"launches": 0, "rays": 0, "hits": 0, "capped": 0})
            row["launches"] += 1
            row["rays"] += r
            row["hits"] += int(want.hit.sum())
            row["capped"] += capped
        return held

    # ---- 2. build ----------------------------------------------------------
    def build(self):
        from ray_tracer_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        self.libs = _build.build()
        secs = time.perf_counter() - t0
        self.ptxas = {k: ptxas_usage(v) for k, v in self.libs.items()}
        emit({"phase": "build", "seconds": secs, "libraries": len(self.libs),
              "ptxas": self.ptxas})

    # ---- 3. and 4. kernels A and B vs their plain versions ---------------
    def kernels_ab(self, which):
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.render.renderer import prepare, shadow_rays_for

        kA, kB = self.kA, self.kB
        base = serial_scene_config(256, 256)
        prep = prepare(base)
        grid, meta = prep.grid.arrays, prep.grid.meta
        v0, v1, v2 = prep.scene.triangle_soa()
        tri9_soa = kA.triangle_table(v0, v1, v2)
        tri9_rows = kB.vertex_table(v0, v1, v2)
        n_tris = v0.shape[0]
        eps = base.render.shadow_eps
        rays = camera_rays(base.camera, device=self.dev)

        def shadow_of(cfg, t, hit):
            poi = torch.where(hit[:, None], rays.at(torch.where(hit, t, torch.zeros_like(t))),
                              torch.zeros_like(rays.orig))
            return shadow_rays_for(cfg.render, prep.scene.light_pos, poi, hit)

        if "A" in which:
            ka = kA.brute_intersect_cuda(rays.orig, rays.dirn, tri9_soa, 0.0)
            pa = kA.brute_intersect_plain(rays.orig, rays.dirn, tri9_soa, 0.0)
            err = compare("kernel A primary", ka, pa)
            hit = ka[1] >= 0
            srays = shadow_of(dataclasses.replace(base, render=dataclasses.replace(
                base.render, faithful=False)), ka[0], hit)
            ks = kA.brute_intersect_cuda(srays.orig, srays.dirn, tri9_soa, eps)
            ps = kA.brute_intersect_plain(srays.orig, srays.dirn, tri9_soa, eps)
            err = max(err, compare("kernel A shadow", ks, ps))
            self.err["brute_intersect"] = max(self.err["brute_intersect"], err)
            emit({"phase": "kernel_A_vs_plain", "rays": rays.count, "triangles": n_tris,
                  "primary_hits": int(hit.sum()), "shadow_hits": int((ks[1] >= 0).sum()),
                  "max_abs_err": err, "tolerance": "bitwise", "equal": True})

        if "B" in which:
            from ray_tracer_tpu_torch.models.scenes import parallel_scene_config

            err = 0.0
            checked = []
            pcfg = parallel_scene_config(256, 256)
            pprep = prepare(pcfg)
            prays = camera_rays(pcfg.camera, device=self.dev)
            for scene, cfg, p, rs in (("serial", base, prep, rays),
                                      ("parallel", pcfg, pprep, prays)):
                g, m = p.grid.arrays, p.grid.meta
                rows = kB.vertex_table(*p.scene.triangle_soa())
                s_eps = cfg.render.shadow_eps

                def shadow_b(t, hit, p=p, rs=rs, cfg=cfg):
                    poi = torch.where(hit[:, None], rs.at(torch.where(hit, t, torch.zeros_like(t))),
                                      torch.zeros_like(rs.orig))
                    return shadow_rays_for(cfg.render, p.scene.light_pos, poi, hit)

                for det in ("float32", "float64"):
                    for mode, kw, skw in (
                        ("faithful", dict(t_gate=None), dict(t_gate=s_eps)),
                        ("production", dict(t_gate=0.0, early_exit=True),
                         dict(t_gate=s_eps, early_exit=True, stop_on_first_hit=True)),
                    ):
                        label = f"kernel B {scene} {det} {mode}"
                        kb = kB.traverse_grid_cuda(rs, g, m, rows, det_dtype=det,
                                                   tables=p.dda, **kw)
                        pb = kB.traverse_grid_plain(rs, g, m, rows, det_dtype=det, **kw)
                        err = max(err, compare(f"{label} primary", kb, pb))
                        h = kb.any_pass if mode == "faithful" else kb.hit
                        sr = shadow_b(kb.t, h)
                        kbs = kB.traverse_grid_cuda(sr, g, m, rows, det_dtype=det,
                                                    tables=p.dda, **skw)
                        pbs = kB.traverse_grid_plain(sr, g, m, rows, det_dtype=det, **skw)
                        err = max(err, compare(f"{label} shadow", kbs, pbs))
                        checked.append({"scene": scene, "det": det, "mode": mode,
                                        "primary_hits": int(h.sum()),
                                        "shadow_hits": int(kbs.hit.sum()),
                                        "mean_steps": float(kb.steps.float().mean())})
            grids = {name: {"n_voxels": list(p.grid.meta.n_voxels), "nnz": p.grid.meta.nnz,
                            "occupied_cells": int((p.dda.cell_range[:, 1] > 0).sum()),
                            "mask_bytes": p.dda.occupancy.numel() * 4}
                     for name, p in (("serial", prep), ("parallel", pprep))}
            self.err["traverse_grid"] = max(self.err["traverse_grid"], err)
            emit({"phase": "kernel_B_vs_plain", "rays": rays.count, "grids": grids,
                  "cases": checked, "max_abs_err": err, "tolerance": "bitwise",
                  "equal": True})

    # ---- 5. kernel C vs its plain version --------------------------------
    def kernel_c(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.persistent import persistent_trace, work_queue
        from ray_tracer_tpu_torch.render.renderer import prepare

        kC = self.kC
        cfg = apply_turbo(serial_scene_config(256, 256), "serial")
        preps = {"inline": prepare(cfg)}
        if not preps["inline"].packed.meta.inline:
            raise AssertionError("the turbo serial grid should take the inline layout")
        for name, change in (("blocks", dict(grid_layout="blocks")),
                             ("bt28", dict(packed_block_tris=28)),
                             ("bt56", dict(packed_block_tris=56))):
            preps[name] = prepare(dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, **change)))
        rcfg = cfg.render
        rays = camera_rays(cfg.camera, device=self.dev)
        light = preps["inline"].scene.light_pos
        fkw = dict(fused=True, shadow_gate=rcfg.shadow_eps, shadow_mint=rcfg.shadow_mint(),
                   serial_quirk=True, shade_serial=True)
        cases = [
            ("inline", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("inline", "fused", dict(fkw)),
            ("inline", "nearest", dict(t_gate=0.0)),
            ("inline", "any_hit", dict(t_gate=0.0, stop_on_first_hit=True)),
            ("blocks", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("blocks", "nearest", dict(t_gate=0.0)),
            ("blocks", "nearest_chain3", dict(t_gate=0.0, probe_chain=3)),
            ("bt28", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("bt28", "nearest", dict(t_gate=0.0)),
            ("bt56", "fused_skip", dict(fkw, skip_dead_shadow=True)),
            ("bt56", "any_hit", dict(t_gate=0.0, stop_on_first_hit=True)),
        ]
        err = 0.0
        out = []
        capped = torch.zeros((1,), dtype=torch.int32, device=self.dev)
        for layout, name, kw in cases:
            p = preps[layout]
            grid, meta = p.packed.arrays, p.packed.meta
            plain = kC.march_plain(rays, grid, meta, light, capped_out=capped, **kw)
            if int(capped.item()):
                raise AssertionError(f"kernel C {layout} {name}: plain capped {int(capped)}")
            got = kC.march_cuda(rays, grid, meta, light, capped_out=capped, **kw)
            torch.cuda.synchronize()
            err = max(err, compare(f"kernel C {layout} {name}", got, plain))
            if int(capped.item()):
                raise AssertionError(f"kernel C {layout} {name}: {int(capped)} rays capped")
            out.append({"layout": layout, "case": name, "block_tris": meta.block_tris,
                        "inline": meta.inline,
                        "hits": int(plain.hit.sum()), "in_shadow": int(plain.in_shadow.sum()),
                        "mean_steps": float(plain.steps.float().mean()),
                        "max_steps": int(plain.steps.max())})
        # the queues of the persistent wave (compacted, chord-ordered),
        # directly and through persistent_trace
        p = preps["inline"]
        grid, meta = p.packed.arrays, p.packed.meta
        keys = kC.chord_keys(rays, grid)
        plain = kC.march_plain(rays, grid, meta, light, skip_dead_shadow=True, **fkw)
        for qname, qkw in (("compact", dict(compact=True)),
                           ("chord", dict(order_keys=keys)),
                           ("compact_chord", dict(compact=True, order_keys=keys))):
            ids, n_work = work_queue(rays, grid, compact=qkw.get("compact", False),
                                     order_keys=qkw.get("order_keys"))
            got = kC.march_cuda(rays, grid, meta, light, queue=ids, n_work=n_work,
                                skip_dead_shadow=True, capped_out=capped, **fkw)
            torch.cuda.synchronize()
            err = max(err, compare(f"kernel C {qname} queue", got, plain))
            if int(capped.item()):
                raise AssertionError(f"kernel C {qname} queue: rays capped")
            got = persistent_trace(
                rays, grid, meta, light, fuse_shadow=True, t_gate=0.0,
                shadow_gate=rcfg.shadow_eps, shadow_mint=rcfg.shadow_mint(),
                serial_quirk=True, shadow_skip_dead=True, shade_serial=True,
                need_t=True, need_steps=True, need_shadow_tri=True, capped_out=capped,
                **qkw)
            torch.cuda.synchronize()
            err = max(err, compare(f"kernel C persistent_trace {qname}", got, plain))
            if int(capped.item()):
                raise AssertionError(f"kernel C persistent_trace {qname}: rays capped")
        self.err["packed_march"] = max(self.err["packed_march"], err)
        emit({"phase": "kernel_C_vs_plain", "rays": rays.count,
              "grid": list(preps["inline"].packed.meta.n_voxels),
              "rows": {k: v.packed.meta.n_blocks for k, v in preps.items()},
              "cases": out, "queues": ["compact", "chord", "compact_chord"], "capped": 0,
              "max_abs_err": err, "tolerance": "bitwise", "equal": True})

    # ---- 6. kernel E vs its plain version --------------------------------
    def wave_inputs(self, cfg, prep):
        """Kernel E's arguments for a prepared wave config after the camera
        (the scene and grid tensors, the knobs of _render_whitted_wave) and
        the plain version's rays: the CPU camera batch, moved to the card,
        whose bits E's own rays must have."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        rc = cfg.render
        mat9, tri9 = prep.wave
        rays = RayBatch(*(x.to(self.dev) for x in camera_rays(cfg.camera, spp=rc.spp,
                                                                device="cpu")))
        pg = rc.primary_gate()
        kw = dict(max_bounces=rc.max_bounces, serial=rc.serial_shading,
                  gate0=0.0 if pg is None else pg, gate_b=rc.bounce_gate(), eps=rc.shadow_eps,
                  smint=rc.shadow_mint(), quirk=rc.shadow_dir_away_from_light(),
                  shadow_scale=rc.shadow_scale, bg=tuple(rc.background))
        tail = (prep.scene.light_pos, prep.scene.light_intensity, mat9, tri9,
                prep.packed.arrays, prep.packed.meta)
        return tail, kw, rays

    def wave_launch(self, cfg, prep, tail, kw, **extra):
        """One launch of kernel E on a prepared wave config."""
        return self.kE.whitted_wave_cuda(cfg.camera, *tail, spp=cfg.render.spp, **kw,
                                         cam=prep.setup.cam, consts=prep.setup.consts,
                                         **extra)

    def check_rays(self, label, rays_out, rays):
        """E's own camera rays (orig, dirn, mint, maxt a row) against the CPU
        batch's bits."""
        want = torch.cat([rays.orig, rays.dirn, rays.mint[:, None], rays.maxt[:, None]], dim=1)
        bad = int((rays_out.view(torch.int32) != want.view(torch.int32)).sum())
        if bad:
            raise AssertionError(f"{label}: {bad} floats of kernel E's camera rays differ from "
                                 "the CPU batch")

    def wave_counters(self, prep, r):
        def z(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.dev)

        return dict(capped_out=z(1), passes_out=z(1), tested_out=z(r),
                    touched_out=z(prep.packed.meta.n_blocks),
                    slots_out=z(prep.packed.arrays.slot_tri.shape[0]),
                    events_out=z(len(self.kE.EVENTS)))

    def kernel_e(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, whitted_wave_eligible

        kE = self.kE

        def turbo(make, size, family, camera=None, **kw):
            cfg = apply_turbo(make(size, size), family)
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))
            if camera:
                cfg = dataclasses.replace(cfg, camera=dataclasses.replace(cfg.camera, **camera))
            return cfg

        cases = [
            ("parallel_256", turbo(parallel_scene_config, 256, "parallel")),
            ("serial_256_on", turbo(serial_scene_config, 256, "serial", whitted_wave="on")),
            ("parallel_128_spp2", turbo(parallel_scene_config, 128, "parallel", spp=2)),
            ("parallel_128_spp2_dof", turbo(parallel_scene_config, 128, "parallel", spp=2,
                                            camera=dict(aperture=0.25, focus_distance=20.0))),
        ]
        err = 0.0
        out = []
        for name, cfg in cases:
            prep = prepare(cfg)
            if not whitted_wave_eligible(cfg, prep.scene):
                raise AssertionError(f"kernel E {name}: the config should take the wave")
            tail, kw, rays = self.wave_inputs(cfg, prep)
            r = rays.count
            cp = self.wave_counters(prep, r)
            want = kE.whitted_wave_plain(rays, *tail, **kw, **cp)
            ck = self.wave_counters(prep, r)
            ro = torch.empty((r, 8), dtype=torch.float32, device=self.dev)
            lanes = torch.zeros((2,), dtype=torch.int64, device=self.dev)
            got = self.wave_launch(cfg, prep, tail, kw, rays_out=ro, lanes_out=lanes, **ck)
            torch.cuda.synchronize()
            label = f"kernel E {name}"
            self.check_rays(label, ro, rays)
            err = max(err, compare(label, (got.reshape(-1),), (want.reshape(-1),)))
            for key in ck:
                if not torch.equal(ck[key], cp[key]):
                    raise AssertionError(f"{label}: counter {key} differs from the plain "
                                         "version's")
            if int(ck["capped_out"].item()):
                raise AssertionError(f"{label}: {int(ck['capped_out'])} lanes capped")
            it, steps = lanes.tolist()
            out.append({"case": name, "positions": r, "spp": cfg.render.spp,
                        "aperture": cfg.camera.aperture, "serial": cfg.render.serial_shading,
                        "events": dict(zip(kE.EVENTS, ck["events_out"].tolist())),
                        "rows_tested": int(ck["tested_out"].sum()),
                        "passes": int(ck["passes_out"].item()), "capped": 0,
                        "rays_equal": True, "lane_utilisation": steps / (32 * it)})
        self.err["whitted_wave"] = max(self.err["whitted_wave"], err)
        emit({"phase": "kernel_E_vs_plain", "cases": out, "max_abs_err": err,
              "tolerance": "bitwise (colors, every counter and E's camera rays)",
              "equal": True})

    # ---- 10. kernel F vs its plain version --------------------------------
    def gi_config(self, make, size, family, S, D, height=None, **kw):
        """A path-traced turbo config (gi_samples set before apply_turbo, as
        the command line sets it), size x size or size x height pixels."""
        from ray_tracer_tpu_torch.config import apply_turbo

        cfg = make(size, height or size)
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, gi_samples=S))
        cfg = apply_turbo(cfg, family)
        return dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, gi_samples=S, gi_depth=D, **kw))

    def gi_inputs(self, prep):
        """Kernel F's arguments for a prepared GI wave config after the
        camera, and the plain version's rays (the CPU camera batch on the
        card)."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        tail, kw = self.kF.launch_inputs(prep)
        rays = RayBatch(*(x.to(self.dev) for x in camera_rays(prep.cfg.camera, device="cpu")))
        return tail, kw, rays

    def gi_launch(self, prep, tail, kw, **extra):
        """One launch of kernel F on a prepared GI wave config."""
        return self.kF.gi_wave_cuda(prep.cfg.camera, *tail, **kw, cam=prep.setup.cam,
                                    consts=prep.setup.consts, **extra)

    def gi_counters(self):
        return dict(capped_out=torch.zeros((1,), dtype=torch.int32, device=self.dev),
                    passes_out=torch.zeros((1,), dtype=torch.int32, device=self.dev),
                    events_out=torch.zeros((len(self.kF.EVENTS),), dtype=torch.int64,
                                           device=self.dev))

    def gi_check(self, label, prep):
        """F against its plain version on prep's frame: radiance bitwise,
        every counter equal, no pixel capped.  Returns (max |err|, events,
        passes)."""
        tail, kw, rays = self.gi_inputs(prep)
        cp, ck = self.gi_counters(), self.gi_counters()
        want = self.kF.gi_wave_plain(rays, *tail, **kw, **cp)
        got = self.gi_launch(prep, tail, kw, **ck)
        torch.cuda.synchronize()
        err = compare(label, (got.reshape(-1),), (want.reshape(-1),))
        for key in ck:
            if not torch.equal(ck[key], cp[key]):
                raise AssertionError(f"{label}: counter {key} differs from the plain "
                                     f"version's: {ck[key].tolist()} vs {cp[key].tolist()}")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"{label}: {int(ck['capped_out'])} pixels capped")
        return err, dict(zip(self.kF.EVENTS, ck["events_out"].tolist())), int(ck["passes_out"])

    def plane_gi_config(self, size):
        """The escape-only plane (tests/test_torch_gi_wave.py): every bounce
        escapes to the background, so radiance is direction-independent."""
        from ray_tracer_tpu_torch.config import (CameraConfig, LightConfig, MaterialConfig,
                                                 SceneConfig)
        from ray_tracer_tpu_torch.models import meshes
        from ray_tracer_tpu_torch.models.scenes import scene_from_meshes

        mats = (MaterialConfig(base_color=(140.0, 90.0, 200.0)),)
        light = LightConfig(position=(0.5, 6.0, 0.3), intensity=60.0)
        scene = scene_from_meshes([(meshes.make_plane(extent=8.0, y=-1.0, density=2), 0)],
                                  mats, light, device=self.dev)
        cfg = SceneConfig(materials=mats, light=light, camera=CameraConfig(
            position=(0.0, 3.0, 0.0), target=(0.1, -1.0, 0.1), width=size, height=size))
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, faithful=False, det_dtype="float32", traversal="packed",
            scheduler="persistent", gi_samples=3, gi_depth=2, background=(30.0, 20.0, 10.0),
            gi_wave="on"))
        return cfg, scene

    def kernel_f(self):
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare

        plane_cfg, plane_scene = self.plane_gi_config(64)
        cases = [
            ("serial_128_s4d2", self.gi_config(serial_scene_config, 128, "serial", 4, 2), None),
            ("parallel_128_s2d3", self.gi_config(parallel_scene_config, 128, "parallel", 2, 3),
             None),
            ("escape_plane_64_s3d2", plane_cfg, plane_scene),
            ("serial_128_s4d0", self.gi_config(serial_scene_config, 128, "serial", 4, 0), None),
            # 7,500 pixels: no multiple of 32 or of a chunk (the queues' tails)
            ("serial_100x75_s3d2", self.gi_config(serial_scene_config, 100, "serial", 3, 2,
                                                  height=75), None),
            # eight items a queued pixel (the fold's order)
            ("serial_128_s8d1", self.gi_config(serial_scene_config, 128, "serial", 8, 1), None),
        ]
        err = 0.0
        out = []
        for name, cfg, scene in cases:
            prep = prepare(cfg, scene=scene)
            if not prep.setup.gi_wave:
                raise AssertionError(f"kernel F {name}: the config should take the GI wave")
            e, events, passes = self.gi_check(f"kernel F {name}", prep)
            err = max(err, e)
            out.append({"case": name, "pixels": cfg.camera.width * cfg.camera.height,
                        "S": cfg.render.gi_samples, "D": cfg.render.gi_depth,
                        "mirror_mix": prep.gi.km is not None, "events": events,
                        "passes": passes, "capped": 0})
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        emit({"phase": "kernel_F_vs_plain", "cases": out, "max_abs_err": err,
              "tolerance": "bitwise (radiance and every counter)", "equal": True})

    # ---- 7. (continued) the path-traced render and the nefertiti scene --
    def main_gi(self):
        """The official GI row (turbo serial 1024x1024, S = 4, D = 2) through
        prepare + render: one launch of F a frame and nothing else."""
        from ray_tracer_tpu_torch.core import vecmath as vm
        from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        size, S, D = 1024, 4, 2
        cfg = self.gi_config(serial_scene_config, size, "serial", S, D)
        t0 = time.perf_counter()
        p = prepare(cfg)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        self.zero_counts()
        img = render(p)
        torch.cuda.synchronize()
        counts = self.counts()
        if counts["gi_wave"] != 1 or sum(counts.values()) != 1:
            raise AssertionError(f"the GI frame launched {counts}: F once and nothing else "
                                 "expected")
        self.launches["gi_wave"] = counts["gi_wave"]
        if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"GI render: bad image {tuple(img.shape)}")
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = render(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = sorted(secs)[2]
        gi_u8 = tonemap_u8(img.cpu().numpy())
        # F's counters on this frame's inputs (a separate, counted launch)
        tail, kw, _ = self.gi_inputs(p)
        ck = self.gi_counters()
        counted = self.gi_launch(p, tail, kw, **ck)
        torch.cuda.synchronize()
        if not torch.equal(vm.div_scalar(counted, float(S)).view(torch.int32),
                           img.reshape(-1, 3).view(torch.int32)):
            raise AssertionError("the counted launch of kernel F differs from the frame")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"GI frame: {int(ck['capped_out'])} pixels capped")
        events = dict(zip(self.kF.EVENTS, ck["events_out"].tolist()))
        segments = events["primaries"] + events["bounce_segments"] + events["shadow_rays"]
        self.gi_frame = p
        emit({"phase": "main_path", "config": "turbo_spot_gi_s4d2", "size": size,
              "S": S, "D": D, "pump": cfg.render.pump, "triangles": p.scene.num_faces,
              "prepare_s": prep_s, "median_ms": med * 1e3,
              "renders_ms": [x * 1e3 for x in secs],
              "mpaths_per_s": size * size * S / med / 1e6,
              "segments_marched": segments, "segments_marched_per_s_of_frame": segments / med,
              "bench_py_gi_mrays_per_s": size * size * S * 2 * (D + 1) / med / 1e6,
              "sync_debug_mode": "error", "events": events, "launches_per_frame": counts,
              "lit_pixels": int((gi_u8.max(axis=-1) > 0).sum()),
              "packed_grid": {"n_voxels": list(p.packed.meta.n_voxels),
                              "rows": p.packed.meta.n_blocks, "inline": p.packed.meta.inline,
                              "block_tris": p.packed.meta.block_tris}})
        prof = profile_render(p, med, "turbo_spot_gi_s4d2")
        self.path_launches["turbo_spot_gi_s4d2"] = dict(
            counts, cuda_kernels_per_frame=prof["kernels_per_frame"])
        emit(prof)

        out_ppm = os.path.join(self.root, "build", "chip_smoke_cli_gi.ppm")
        os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
        cli = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "serial",
             "--width", str(size), "--turbo", "--gi", str(S), "--gi-depth", str(D),
             "--out", out_ppm],
            cwd=self.root, capture_output=True, text=True, timeout=600,
        )
        if cli.returncode != 0:
            raise AssertionError(f"cli render gi failed:\n{cli.stderr[-3000:]}")
        if not (read_ppm(out_ppm) == gi_u8).all():
            raise AssertionError("cli render gi differs from the in-process render")
        emit({"phase": "cli", "config": "turbo_spot_gi_s4d2", "size": size,
              "same_bytes_as_render": True, "stderr": cli.stderr.strip().splitlines()[-1]})

    def gi_wave_vs_segments(self):
        """The GI wave (F) against the segment integrator (C, one fused march
        a sample batch and depth) at 256x256: the JAX package's rule for its
        own wave (tests/test_pathtrace.py:565-586), more than 97% of pixels
        within 1e-5 and the means within 2%.  Each of the segment
        integrator's launches of C is held to the plain version at its own
        inputs."""
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        for name, cfg in (("serial_s4d2", self.gi_config(serial_scene_config, 256, "serial",
                                                         4, 2)),
                          ("parallel_s2d3", self.gi_config(parallel_scene_config, 256,
                                                           "parallel", 2, 3))):
            p = prepare(cfg)
            self.zero_counts()
            wave = render(p)
            torch.cuda.synchronize()
            wcounts = self.counts()
            off = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                      gi_wave="off"))
            self.zero_counts()
            with self.logging_launches() as log:
                seg = render(p._replace(cfg=off))
                torch.cuda.synchronize()
            scounts = self.counts()
            self.path_launches[f"gi_wave_{name}_256"] = wcounts
            self.path_launches[f"gi_segments_{name}_256"] = scounts
            if wcounts["gi_wave"] != 1 or scounts["gi_wave"] or scounts["packed_march"] <= 0:
                raise AssertionError(f"GI {name}: wave launched {wcounts}, segments {scounts}")
            held = self.hold_logged(f"GI segments {name}", log)
            same = float(((wave - seg).abs() <= 1e-5).all(dim=-1).float().mean())
            means = (float(wave.mean()), float(seg.mean()))
            rel = abs(means[0] - means[1]) / max(abs(means[1]), 1e-30)
            emit({"phase": "gi_wave_vs_segments", "case": name, "size": 256,
                  "pixels_within_1e-5": same, "means": means, "means_rel_diff": rel,
                  "bitwise_pixels": float((wave.view(torch.int32) == seg.view(torch.int32))
                                          .all(dim=-1).float().mean()),
                  "segment_launches": scounts, "segments_kernel_C_held": held})
            if same <= 0.97 or rel > 0.02:
                raise AssertionError(f"GI wave vs segments {name}: {same:.4f} of pixels within "
                                     f"1e-5, means {means}")

    def main_nefertiti(self):
        """The turbo nefertiti scene (261,120 faces) at 1024x1024: kernel C
        with the tuned knobs, each of its launches held to the plain version
        at the frame's own inputs, and its image against the csr image
        (kernel B) by the 2-count rule."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        size = 1024
        scene, base = nefertiti_scene(size, size, device=self.dev)
        imgs = {}
        for name, cfg, kernel in (
                ("turbo_nefertiti", apply_turbo(base, "nefertiti"), "packed_march"),
                ("csr_nefertiti", dataclasses.replace(base, render=dataclasses.replace(
                    base.render, traversal="csr")), "traverse_grid")):
            t0 = time.perf_counter()
            p = prepare(cfg, scene=scene)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            self.zero_counts()
            with self.logging_launches() as log:
                img = render(p)
                torch.cuda.synchronize()
            counts = self.counts()
            self.path_launches[name] = counts
            if counts[kernel] <= 0:
                raise AssertionError(f"{name} launched {kernel} 0 times")
            if name == "turbo_nefertiti":
                self.nef_prep = p  # the train phase fits this prepared scene
                held = self.hold_logged(name, log)
                emit({"phase": "kernel_C_on_path", "config": name, "size": size,
                      "layout": "inline" if p.packed.meta.inline else "blocks",
                      "held": held, "tolerance": "bitwise (records, rows tested and "
                      "touched, capped lanes, most steps)", "equal": True})
            if not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}: non-finite pixels")
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                img = render(p)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            med = sorted(secs)[2]
            imgs[name] = tonemap_u8(img.cpu().numpy())
            line = {"phase": "main_path", "config": name, "size": size,
                    "triangles": p.scene.num_faces, "prepare_s": prep_s,
                    "median_ms": med * 1e3, "renders_ms": [x * 1e3 for x in secs],
                    "mrays_per_s": size * size * 2 / med / 1e6, "launches_per_frame": counts,
                    "lit_pixels": int((imgs[name].max(axis=-1) > 0).sum())}
            if p.packed is not None:
                line["packed_grid"] = {"n_voxels": list(p.packed.meta.n_voxels),
                                       "rows": p.packed.meta.n_blocks,
                                       "inline": p.packed.meta.inline,
                                       "block_tris": p.packed.meta.block_tris,
                                       "max_blocks": p.packed.meta.max_blocks}
            emit(line)
            if name == "turbo_nefertiti":
                emit(profile_render(p, med, name))
        frac = image_rule(imgs["turbo_nefertiti"], imgs["csr_nefertiti"])
        emit({"phase": "nefertiti_agreement", "pixels_over_2_counts": frac,
              "bytes_differing": int((imgs["turbo_nefertiti"] != imgs["csr_nefertiti"]).sum())})
        if frac >= 0.01:
            raise AssertionError(f"nefertiti turbo vs csr: {frac:.2%} of pixels differ by > 2")

    # ---- the grid builders on the card (kernels G and H) -----------------
    def grid_build(self):
        """Kernels G and H on spot_1024's and nefertiti_1024's turbo grids:
        H's cell_start and tri_ids and G's extents, words and slab-test
        count bitwise their plain versions' on the same CUDA inputs, the
        card's grid and packed grid on spot byte-equal to the CPU build;
        each kernel's time beside its plain version's and its bound; and
        nefertiti's prepare, the main path of G and H, with the counts set
        to 0 just before it and read just after."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import (build_scene, nefertiti_scene,
                                                         serial_scene_config)
        from ray_tracer_tpu_torch.parallel.shard import build_ring_grids
        from ray_tracer_tpu_torch.render.renderer import prepare

        scene, cfg = nefertiti_scene(1024, 1024, device=self.dev)
        cfg = apply_turbo(cfg, "nefertiti")
        torch.cuda.synchronize()
        self.zero_counts()
        t0 = time.perf_counter()
        self.nef_prep = prepare(cfg, scene=scene)
        torch.cuda.synchronize()
        prepare_s = time.perf_counter() - t0
        counts = self.counts()
        for kernel in ("empty_boxes", "grid_bin"):
            if counts[kernel] <= 0:
                raise AssertionError(f"nefertiti's prepare launched {kernel} 0 times")
            self.launches[kernel] = counts[kernel]
        self.path_launches["prepare_turbo_nefertiti"] = counts
        # the JAX package's ring build: all four shards' grids in this process
        self.zero_counts()
        t0 = time.perf_counter()
        ring = build_ring_grids(self.nef_prep, 4)
        ring_s = time.perf_counter() - t0
        ring_counts = self.counts()
        if ring_counts["empty_boxes"] != 4 or ring_counts["grid_bin"] != 4:
            raise AssertionError(f"build_ring_grids at 4 shards launched {ring_counts}: G and "
                                 "H four times each expected")
        emit({"phase": "grid_build_prepare", "config": "turbo_nefertiti", "size": 1024,
              "triangles": self.nef_prep.scene.num_faces, "prepare_s": prepare_s,
              "launches": counts, "n_voxels": list(self.nef_prep.grid.meta.n_voxels),
              "nnz": self.nef_prep.grid.meta.nnz, "build_ring_grids_4_s": ring_s,
              "ring_launches": ring_counts, "ring_blocks": ring.meta.n_blocks})
        self.grid_build_split(cfg, scene)

        csr_cfg = serial_scene_config(1024, 1024)
        spot_cfg = apply_turbo(csr_cfg, "serial")
        spot = build_scene(spot_cfg, device=self.dev)
        csr_spot = build_scene(csr_cfg, device=self.dev)
        rows = {}
        # nefertiti last: its row's times go to the kernels line
        for name, sc, c in (("spot_1024", spot, spot_cfg),
                            ("spot_1024_csr", csr_spot, csr_cfg),
                            ("nefertiti_1024", self.nef_prep.scene, cfg)):
            rows[name] = self.grid_build_row(name, sc, c)
        rows["spot_2x2x2"] = self.grid_build_coarse(csr_spot)
        emit({"phase": "grid_build", "rows": rows,
              "tolerance": "bitwise (H: cell_start, tri_ids; G: words, greedy slab tests, "
                           "probes and slab tests made; spot's packed grid card against CPU)"})

    def grid_build_split(self, cfg, scene):
        """nefertiti's turbo prepare and one rebuild of the config-4 fit
        split into their parts (utils/timing.part: host seconds of work
        fenced by a device synchronisation, CUDA-event ms inside), beside
        their unsplit seconds."""
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare
        from ray_tracer_tpu_torch.utils.timing import split_parts

        # the parts inside build_grid and pack_grid; what is left of each is
        # its host frame and its numpy rows
        nested = {"build_grid": ("H", "csr_to_host", "grid_assemble"),
                  "pack_grid": ("G", "words_to_host", "upload")}

        def split(fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            unsplit_s = time.perf_counter() - t0
            with split_parts() as parts:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                total_s = time.perf_counter() - t0
            by = {}
            for name, host_s, dev_ms in parts:
                h, d = by.get(name, (0.0, 0.0))
                by[name] = (h + host_s, d + (dev_ms or 0.0))
            rests = {"build_grid": "grid_frame", "pack_grid": "rows"}
            for outer, inner in nested.items():
                if outer in by:
                    by[rests[outer]] = tuple(by[outer][k] - sum(by[n][k] for n in inner
                                                                if n in by) for k in (0, 1))
            top = [n for n in by if n not in sum(nested.values(), ()) + tuple(rests.values())]
            return {"unsplit_s": unsplit_s, "split_total_s": total_s,
                    "outside_parts_s": total_s - sum(by[n][0] for n in top),
                    "parts": {n: {"host_s": h, "device_ms": d} for n, (h, d) in by.items()}}

        prep = split(lambda: prepare(cfg, scene=scene))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nefertiti_scene(1024, 1024, device=self.dev)  # the scene prepare is given
        torch.cuda.synchronize()
        prep["scene_build_s"] = time.perf_counter() - t0
        params = fitmod.split_scene(self.nef_prep.scene)
        rebuild = split(lambda: fitmod._rebuild(self.nef_prep, params))
        emit({"phase": "grid_build_split", "config": "turbo_nefertiti", "size": 1024,
              "prepare": prep, "rebuild": rebuild})

    def grid_build_coarse(self, scene) -> dict:
        """Kernel H's rank tier: spot at a forced 2x2x2 resolution (AABB),
        every cell past kWarpSort triangles, against its plain version."""
        from ray_tracer_tpu_torch.accel import native
        from ray_tracer_tpu_torch.accel.grid import build_grid

        verts = scene.verts.to(torch.float32).contiguous()
        faces = scene.faces.to(torch.int32).contiguous()
        cgrid = build_grid(verts.cpu().numpy(), faces.cpu().numpy(),
                           force_resolution=(2, 2, 2), device="cpu")
        h = cgrid.host
        frame = (h.lower, h.inv_width, h.width, cgrid.meta.n_voxels, False)
        got = native.bin_triangles_cuda(verts, faces, *frame)
        want = native.bin_triangles_plain(verts, faces, *frame)
        for field, a, b, c in (("cell_start", got[0], want[0], h.cell_start),
                               ("tri_ids", got[1], want[1], h.tri_ids)):
            if not torch.equal(a, b) or not np.array_equal(a.cpu().numpy(), c):
                raise AssertionError(f"kernel H on spot at 2x2x2: {field} differs")
        return {"n_voxels": [2, 2, 2], "nnz": cgrid.meta.nnz,
                "max_per_voxel": cgrid.meta.max_per_voxel, "H_equal_plain": True}

    def grid_build_row(self, name, scene, cfg) -> dict:
        """One scene's grid at its config's knobs (SAT-exact or AABB): H and
        G held and timed (the last row's times go to the kernels line); on
        spot's turbo grid, the card's grid and packed grid against the CPU
        build's bytes."""
        from ray_tracer_tpu_torch.accel import native
        from ray_tracer_tpu_torch.accel.grid import build_grid
        from ray_tracer_tpu_torch.accel.packed import PackedGridArrays, pack_grid
        from ray_tracer_tpu_torch.render.renderer import choose_inline_layout

        g = cfg.render.grid
        verts = scene.verts.to(torch.float32).contiguous()
        faces = scene.faces.to(torch.int32).contiguous()
        verts_np, faces_np = verts.cpu().numpy(), faces.cpu().numpy()
        knobs = dict(resolution_multiplier=g.resolution_multiplier,
                     max_resolution=g.max_resolution, exact_overlap=g.exact_overlap)
        t0 = time.perf_counter()
        grid = build_grid(verts_np, faces_np, device=self.dev, **knobs)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        h, meta = grid.host, grid.meta
        frame = (h.lower, h.inv_width, h.width, meta.n_voxels, g.exact_overlap)

        def run_h():
            return native.bin_triangles_cuda(verts, faces, *frame)

        cand = []
        torch.cuda.synchronize()
        # the wrapper's host syncs, counted: each synchronizing CUDA call
        # warns under the sync debug mode
        # the wrapper's host syncs, counted: under the sync debug mode each
        # synchronizing CUDA call warns (the mode is set outside the count:
        # setting it warns too)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                got = native.bin_triangles_cuda(verts, faces, *frame, candidates_out=cand)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync_sites = [f"{os.path.basename(w.filename)}:{w.lineno}" for w in caught
                      if "synchroniz" in str(w.message)]
        h_syncs = len(sync_sites)
        if h_syncs > 2:
            raise AssertionError(f"kernel H on {name}: {h_syncs} host syncs, at most 2: "
                                 f"{sync_sites}")
        plain_ms, want = once_ms(lambda: native.bin_triangles_plain(verts, faces, *frame))
        for field, a, b in (("cell_start", got[0], want[0]), ("tri_ids", got[1], want[1])):
            if a.dtype != b.dtype or not torch.equal(a, b):
                raise AssertionError(f"kernel H on {name}: {field} differs from the plain "
                                     "version's")
        if not (np.array_equal(got[0].cpu().numpy(), h.cell_start)
                and np.array_equal(got[1].cpu().numpy(), h.tri_ids)):
            raise AssertionError(f"kernel H on {name}: the grid build's CSR differs")
        h_ms = cuda_ms(run_h, 5)
        h_dev, h_by = calls_device_ms(run_h, 5)
        h_parts = {}
        native.bin_triangles_cuda(verts, faces, *frame, parts_out=h_parts)
        n_cand, nnz, cells = cand[0], meta.nnz, meta.total_voxels
        # the vertices and faces in, the counts written and read, the CSR out
        h_bytes = (verts.numel() * 4 + faces.numel() * 4 + cells * 4 * 2 + (cells + 1) * 8
                   + nnz * 4)
        h_ops = (nnz * OPS_PER_SURVIVOR_H + (n_cand - nnz) * OPS_PER_REJECT_H
                 if g.exact_overlap else 0)
        h_bound, h_bound_by = bound_of(h_bytes, h_ops, PEAK_FP64_UNFUSED)
        counts = np.diff(h.cell_start)

        nx, ny, nz = meta.n_voxels
        cs = grid.arrays.cell_start
        occ = (cs[1:] > cs[:-1]).reshape(nz, ny, nx)

        def run_g():
            return native.empty_boxes_cuda(occ)

        i64 = dict(dtype=torch.int64, device=self.dev)
        tk, tp, qk, qp = (torch.zeros(n, **i64) for n in (1, 1, 2, 2))
        words = native.empty_boxes_cuda(occ, tests_out=tk, queries_out=qk)
        g_plain_ms, ext_p = once_ms(lambda: native.empty_boxes_plain(occ, tests_out=tp,
                                                                     queries_out=qp))
        if not torch.equal(words, native.pack_extents_words(ext_p)):
            raise AssertionError(f"kernel G on {name}: words differ from the plain version's")
        if not torch.equal(tk, tp) or not torch.equal(qk, qp):
            raise AssertionError(f"kernel G on {name}: {int(tk)} slab tests and queries "
                                 f"{qk.tolist()}, the plain version {int(tp)} and "
                                 f"{qp.tolist()}")
        g_ms = cuda_ms(run_g, 5)
        g_dev, g_by = calls_device_ms(run_g, 5)
        table_torch_ms = cuda_ms(lambda: native._summed_area(occ), 5)
        tests = int(tp)
        probes, made = qp.tolist()
        g_bytes = cells * 1 + cells * 4  # the occupancy in, a word out
        g_ops = probes * OPS_PER_PROBE_G + made * OPS_PER_TEST_G
        g_bound, g_bound_by = bound_of(g_bytes, g_ops, PEAK_INT32_OPS)
        g_bound_greedy, _ = bound_of(g_bytes, tests * OPS_PER_TEST_G, PEAK_INT32_OPS)
        row = {"triangles": int(faces.shape[0]), "n_voxels": [nx, ny, nz],
               "occupied": int(occ.sum()), "build_grid_s": build_s,
               "H": {"ms": h_ms, "device_ms": h_dev, "device_ms_by_kernel": h_by,
                     "parts_ms": h_parts, "host_syncs": h_syncs, "sync_sites": sync_sites,
                     "plain_ms": plain_ms, "candidates": n_cand, "nnz": nnz,
                     "max_per_voxel": int(counts.max()),
                     "cells_over_32": int((counts > 32).sum()),
                     "cells_over_1024": int((counts > 1024).sum()),
                     "bytes": h_bytes, "ops": h_ops, "bound_ms": h_bound,
                     "bound_by": h_bound_by, "ptxas": self.ptxas.get("grid_bin"),
                     "equal_plain": True},
               "G": {"ms": g_ms, "device_ms": g_dev, "device_ms_by_kernel": g_by,
                     "table_torch_cumsum_ms": table_torch_ms, "plain_ms": g_plain_ms,
                     "greedy_slab_tests": tests, "probes": probes, "slab_tests_made": made,
                     "bytes": g_bytes, "ops": g_ops, "bound_ms": g_bound,
                     "bound_by": g_bound_by, "ops_greedy": tests * OPS_PER_TEST_G,
                     "bound_ms_greedy": g_bound_greedy,
                     "ptxas": self.ptxas.get("empty_boxes"), "equal_plain": True}}
        self.times["G"] = dict(ms=g_ms, plain_ms=g_plain_ms, bound_ms=g_bound,
                               bound_by=g_bound_by)
        self.times["H"] = dict(ms=h_ms, plain_ms=plain_ms, bound_ms=h_bound,
                               bound_by=h_bound_by)
        if name == "spot_1024":
            bt = cfg.render.packed_block_tris
            inline = choose_inline_layout(grid, bt)
            t0 = time.perf_counter()
            card = pack_grid(grid, verts_np, faces_np, block_tris=bt, inline=inline)
            torch.cuda.synchronize()
            pack_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            cgrid = build_grid(verts_np, faces_np, device="cpu", **knobs)
            cpu = pack_grid(cgrid, verts_np, faces_np, block_tris=bt, inline=inline)
            cpu_s = time.perf_counter() - t0
            if tuple(card.meta) != tuple(cpu.meta):
                raise AssertionError("spot_1024: the card's packed meta differs from the CPU's")
            for field in ("cell_start", "tri_ids"):
                if not np.array_equal(getattr(h, field), getattr(cgrid.host, field)):
                    raise AssertionError(f"spot_1024: the card's {field} differs from the "
                                         "CPU build's")
            for field in PackedGridArrays._fields:
                a = getattr(card.arrays, field).cpu().numpy()
                b = getattr(cpu.arrays, field).numpy()
                if a.shape != b.shape or a.tobytes() != b.tobytes():
                    raise AssertionError(f"spot_1024: the card's packed {field} differs from "
                                         "the CPU build's")
            row["pack_grid"] = {"card_s": pack_s, "cpu_build_and_pack_s": cpu_s,
                                "inline": inline, "byte_equal_cpu": True}
        return row

    # ---- 7. the main path at full size -----------------------------------
    def main_path(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        size = 1024
        main_cfg = serial_scene_config(size, size)
        configs = {
            "csr": (main_cfg, "traverse_grid"),
            "brute_pallas": (dataclasses.replace(main_cfg, render=dataclasses.replace(
                main_cfg.render, traversal="brute_pallas", faithful=False)), "brute_intersect"),
            "turbo": (apply_turbo(main_cfg, "serial"), "packed_march"),
        }
        for name, (cfg, kernel) in configs.items():
            t0 = time.perf_counter()
            p = prepare(cfg)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
            self.zero_counts()
            img = render(p)
            torch.cuda.synchronize()
            counts = self.counts()
            if counts[kernel] <= 0:
                raise AssertionError(f"render with config {name} launched {kernel} 0 times")
            self.launches[kernel] = counts[kernel]
            self.path_launches[name] = counts
            if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name} render: bad image {tuple(img.shape)}")
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                img = render(p)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            med = sorted(secs)[2]
            self.images[name] = tonemap_u8(img.cpu().numpy())
            line = {"phase": "main_path", "config": name, "size": size,
                    "prepare_s": prep_s, "median_ms": med * 1e3,
                    "renders_ms": [s * 1e3 for s in secs],
                    "mrays_per_s": size * size * 2 / med / 1e6,
                    "launches_per_frame": counts,
                    "lit_pixels": int((self.images[name].max(axis=-1) > 0).sum())}
            if name == "turbo":
                line["packed_grid"] = {"n_voxels": list(p.packed.meta.n_voxels),
                                       "rows": p.packed.meta.n_blocks,
                                       "inline": p.packed.meta.inline,
                                       "max_blocks": p.packed.meta.max_blocks,
                                       "table_mb": p.packed.arrays.blocks.numel() * 4 / 1e6}
            emit(line)
            if name in ("csr", "turbo"):
                emit(profile_render(p, med, name))
        agree = {}
        for name in ("brute_pallas", "turbo"):
            frac = image_rule(self.images["csr"], self.images[name])
            if frac >= 0.01:
                raise AssertionError(f"csr vs {name}: {frac:.2%} of pixels differ by > 2")
            agree[name] = frac
        emit({"phase": "main_path_agreement", "pixels_over_2_counts": agree["brute_pallas"],
              "turbo_pixels_over_2_counts": agree["turbo"],
              "turbo_bytes_differing_from_csr": int(
                  (self.images["csr"] != self.images["turbo"]).sum())})

        # the default and the --turbo renders through the command line
        for name, extra in (("csr", []), ("turbo", ["--turbo"])):
            out_ppm = os.path.join(self.root, "build", f"chip_smoke_cli_{name}.ppm")
            os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
            cli = subprocess.run(
                [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene",
                 "serial", "--width", str(size), "--out", out_ppm, *extra],
                cwd=self.root, capture_output=True, text=True, timeout=600,
            )
            if cli.returncode != 0:
                raise AssertionError(f"cli render {name} failed:\n{cli.stderr[-3000:]}")
            if not (read_ppm(out_ppm) == self.images[name]).all():
                raise AssertionError(f"cli render {name} differs from the in-process render")
            emit({"phase": "cli", "config": name, "size": size, "same_bytes_as_render": True,
                  "stderr": cli.stderr.strip().splitlines()[-1]})

        self.main_wave()
        self.main_gi()
        self.gi_wave_vs_segments()
        self.main_nefertiti()

        base = parallel_scene_config(512, 512)
        turbo = apply_turbo(base, "parallel")
        turbo = dataclasses.replace(turbo, render=dataclasses.replace(
            turbo.render, whitted_wave="off"))
        for name, pcfg, kernel in (("csr", base, "traverse_grid"),
                                   ("turbo", turbo, "packed_march")):
            pp = prepare(pcfg)
            self.zero_counts()
            render(pp)
            torch.cuda.synchronize()
            pcounts = self.counts()
            self.path_launches[f"parallel_512_{name}"] = pcounts
            if pcounts[kernel] <= 0:
                raise AssertionError(f"parallel render {name} launched {kernel} 0 times")
            t0 = time.perf_counter()
            pimg = render(pp)
            torch.cuda.synchronize()
            pms = (time.perf_counter() - t0) * 1e3
            if not bool(torch.isfinite(pimg).all()):
                raise AssertionError(f"parallel render {name}: non-finite pixels")
            self.images["parallel_" + name] = tonemap_u8(pimg.cpu().numpy())
            emit({"phase": "parallel_scene", "config": name, "size": 512,
                  "triangles": pp.scene.num_faces, "bounces": pcfg.render.max_bounces,
                  "ms": pms, "launches_per_frame": pcounts})
        frac = image_rule(self.images["parallel_csr"], self.images["parallel_turbo"])
        emit({"phase": "parallel_agreement", "pixels_over_2_counts": frac})
        if frac >= 0.01:
            raise AssertionError(f"parallel csr vs turbo: {frac:.2%} of pixels differ by > 2")
        # each main-path render's own launches, counted from 0 (the
        # `kernels` line gives each kernel's count on its first path:
        # B csr, A brute_pallas, C turbo, E turbo_parallel_wave, F the GI row)
        emit({"phase": "launches_by_path", "paths": self.path_launches})

    def main_wave(self):
        """The turbo parallel scene at 1024x1024 through prepare + render: the
        cross-depth Whitted wave, one launch of kernel E a frame and none of
        C; against the bounce loop (whitted_wave="off", four launches of C)
        and through the command line."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import read_ppm, tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        kE = self.kE
        size = 1024
        cfg = apply_turbo(parallel_scene_config(size, size), "parallel")
        t0 = time.perf_counter()
        p = prepare(cfg)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t0
        self.zero_counts()
        img = render(p)
        torch.cuda.synchronize()
        counts = self.counts()
        if counts["whitted_wave"] != 1 or counts["packed_march"] != 0:
            raise AssertionError(f"the turbo parallel frame launched {counts}: E once and C "
                                 "never expected")
        self.launches["whitted_wave"] = counts["whitted_wave"]
        self.path_launches["turbo_parallel_wave"] = counts
        if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"turbo parallel render: bad image {tuple(img.shape)}")
        # each frame under the sync debug mode: a device-to-host copy or a
        # synchronisation inside render raises
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img = render(p)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        med = sorted(secs)[2]
        wave_u8 = tonemap_u8(img.cpu().numpy())
        # E's counters and camera rays on this frame's inputs (a separate,
        # counted launch)
        tail, kw, rays = self.wave_inputs(cfg, p)
        ck = self.wave_counters(p, rays.count)
        ro = torch.empty((rays.count, 8), dtype=torch.float32, device=self.dev)
        counted = self.wave_launch(cfg, p, tail, kw, rays_out=ro, **ck)
        torch.cuda.synchronize()
        self.check_rays("kernel E 1024", ro, rays)
        if not torch.equal(counted.view(torch.int32), img.reshape(-1, 3).view(torch.int32)):
            raise AssertionError("the counted launch of kernel E differs from the frame")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"turbo parallel frame: {int(ck['capped_out'])} lanes capped")
        events = dict(zip(kE.EVENTS, ck["events_out"].tolist()))
        segments = events["primaries"] + events["shadow_rays"] + events["mirror_rays"]
        self.wave_frame = (cfg, p)
        emit({"phase": "main_path", "config": "turbo_parallel_wave", "size": size,
              "triangles": p.scene.num_faces, "bounces": cfg.render.max_bounces,
              "prepare_s": prep_s, "median_ms": med * 1e3, "renders_ms": [x * 1e3 for x in secs],
              "pixels_per_s_of_frame": size * size / med,
              "segments_marched": segments,
              "segments_marched_per_s_of_frame": segments / med,
              "sync_debug_mode": "error", "rays_equal_cpu_batch": True,
              "events": events, "launches_per_frame": counts,
              "packed_grid": {"n_voxels": list(p.packed.meta.n_voxels),
                              "rows": p.packed.meta.n_blocks, "inline": p.packed.meta.inline,
                              "block_tris": p.packed.meta.block_tris,
                              "max_blocks": p.packed.meta.max_blocks,
                              "table_mb": p.packed.arrays.blocks.numel() * 4 / 1e6}})
        emit(profile_render(p, med, "turbo_parallel_wave"))

        off = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render,
                                                                  whitted_wave="off"))
        self.zero_counts()
        loop = render(p._replace(cfg=off))
        torch.cuda.synchronize()
        lcounts = self.counts()
        self.path_launches["turbo_parallel_bounce_loop"] = lcounts
        if lcounts["packed_march"] != cfg.render.max_bounces + 1 or lcounts["whitted_wave"]:
            raise AssertionError(f"the bounce-loop frame launched {lcounts}")
        frac = image_rule(wave_u8, tonemap_u8(loop.cpu().numpy()))
        big = torch.maximum(img.abs(), loop.abs())
        rel = float(torch.where(big > 0, (img - loop).abs() / big,
                                torch.zeros_like(big)).max())
        emit({"phase": "wave_vs_bounce_loop", "size": size, "pixels_over_2_counts": frac,
              "bytes_differing": int((wave_u8 != tonemap_u8(loop.cpu().numpy())).sum()),
              "max_rel_diff": rel, "max_abs_diff": float((img - loop).abs().max()),
              "bounce_loop_launches": lcounts})
        if frac >= 0.01:
            raise AssertionError(f"wave vs bounce loop: {frac:.2%} of pixels differ by > 2")

        out_ppm = os.path.join(self.root, "build", "chip_smoke_cli_parallel.ppm")
        os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
        cli = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "parallel",
             "--width", str(size), "--turbo", "--out", out_ppm],
            cwd=self.root, capture_output=True, text=True, timeout=600,
        )
        if cli.returncode != 0:
            raise AssertionError(f"cli render parallel failed:\n{cli.stderr[-3000:]}")
        if not (read_ppm(out_ppm) == wave_u8).all():
            raise AssertionError("cli render parallel differs from the in-process render")
        emit({"phase": "cli", "config": "turbo_parallel_wave", "size": size,
              "same_bytes_as_render": True, "stderr": cli.stderr.strip().splitlines()[-1]})

    # ---- 8. card vs CPU --------------------------------------------------
    def card_vs_cpu(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.persistent import persistent_trace
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        small = serial_scene_config(64, 64)
        small = dataclasses.replace(small, render=dataclasses.replace(
            small.render, det_dtype="float64"))
        on_card = tonemap_u8(render(prepare(small)).cpu().numpy())
        on_cpu = tonemap_u8(render(prepare(small, device="cpu")).numpy())
        n_bad = int((on_card != on_cpu).sum())
        if n_bad:
            raise AssertionError(f"64x64 float64 render: {n_bad} PPM bytes differ card vs CPU")
        emit({"phase": "card_vs_cpu", "size": 64, "det_dtype": "float64", "bytes_differing": 0})

        cfg = apply_turbo(serial_scene_config(64, 64), "serial")
        rcfg = cfg.render
        recs = {}
        imgs = {}
        for dev in ("cuda", "cpu"):
            p = prepare(cfg, device=dev)
            rays = camera_rays(cfg.camera, device=dev)
            recs[dev] = persistent_trace(
                rays, p.packed.arrays, p.packed.meta, p.scene.light_pos, wave=rcfg.wave,
                fuse_shadow=True, t_gate=0.0, shadow_gate=rcfg.shadow_eps,
                shadow_mint=rcfg.shadow_mint(), serial_quirk=True, shadow_skip_dead=True,
                shade_serial=True, need_t=True, need_steps=True, need_shadow_tri=True)
            imgs[dev] = tonemap_u8(render(p).cpu().numpy())
        compare("turbo 64 card vs CPU records", tuple(x.cpu() for x in recs["cuda"]),
                tuple(recs["cpu"]))
        frac = image_rule(imgs["cuda"], imgs["cpu"])
        if frac >= 0.01:
            raise AssertionError(f"turbo 64 card vs CPU: {frac:.2%} of pixels differ by > 2")
        emit({"phase": "card_vs_cpu", "size": 64, "config": "turbo", "records_equal": True,
              "hits": int(recs["cpu"].hit.sum()),
              "bytes_differing": int((imgs["cuda"] != imgs["cpu"]).sum()),
              "pixels_over_2_counts": frac})

        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config

        wcfg = apply_turbo(parallel_scene_config(64, 64), "parallel")
        wprep = prepare(wcfg)
        self.zero_counts()
        w_card = render(wprep)
        torch.cuda.synchronize()
        if self.counts()["whitted_wave"] != 1:
            raise AssertionError("the 64x64 turbo parallel render did not launch kernel E")
        w_cpu = render(prepare(wcfg, device="cpu"))
        a, b = tonemap_u8(w_card.cpu().numpy()), tonemap_u8(w_cpu.numpy())
        frac = image_rule(a, b)
        if frac >= 0.01:
            raise AssertionError(f"wave 64 card vs CPU: {frac:.2%} of pixels differ by > 2")
        diff = (w_card.cpu().view(torch.int32) != w_cpu.view(torch.int32)).any(dim=-1)
        # the torch CUDA camera batch (what the wave traced before kernel E
        # made its own rays) against the CPU batch
        cam_card = camera_rays(wcfg.camera, device=self.dev)
        cam_cpu = camera_rays(wcfg.camera, device="cpu")
        cam_bad = sum(int((x.cpu().view(torch.int32) != y.view(torch.int32)).sum())
                      for x, y in zip(cam_card[:2], cam_cpu[:2]))
        line = {"phase": "card_vs_cpu", "size": 64, "config": "turbo_parallel_wave",
                "bytes_differing": int((a != b).sum()), "pixels_over_2_counts": frac,
                "floats_differing": int((w_card.cpu().view(torch.int32)
                                         != w_cpu.view(torch.int32)).sum()),
                "pixels_differing": int(diff.sum()),
                "cuda_camera_batch_floats_differing": cam_bad}
        if bool(diff.any()):
            line["pow"] = self.wave_pow_probe(wcfg, wprep, diff.reshape(-1).nonzero()[:, 0])
        emit(line)

        # path-traced GI at 64x64 through the GI wave (F on the card, its
        # plain version on the CPU): cos and sin are taken in float64 on
        # both, so the radiance is held bitwise
        for name, gcfg in (("turbo_spot_gi_s4d2",
                            self.gi_config(serial_scene_config, 64, "serial", 4, 2)),
                           ("turbo_parallel_gi_s2d3",
                            self.gi_config(parallel_scene_config, 64, "parallel", 2, 3))):
            self.zero_counts()
            g_card = render(prepare(gcfg))
            torch.cuda.synchronize()
            if self.counts()["gi_wave"] != 1:
                raise AssertionError(f"the 64x64 {name} render did not launch kernel F")
            g_cpu = render(prepare(gcfg, device="cpu"))
            n_bad = int((g_card.cpu().view(torch.int32) != g_cpu.view(torch.int32)).sum())
            emit({"phase": "card_vs_cpu", "size": 64, "config": name,
                  "tolerance": "bitwise (cos and sin in float64 on both)",
                  "floats_differing": n_bad,
                  "max_abs_diff": float((g_card.cpu() - g_cpu).abs().max())})
            if n_bad:
                raise AssertionError(f"GI 64 {name}: {n_bad} floats differ card vs CPU")

        # the segment integrator over the csr grid (kernel B), the command
        # line's GI without --turbo: each launch of B held to the plain
        # version, and the image against the CPU's by the 2-count rule
        ccfg = serial_scene_config(64, 64)
        ccfg = dataclasses.replace(ccfg, render=dataclasses.replace(
            ccfg.render, faithful=False, gi_samples=2, gi_depth=1))
        cprep = prepare(ccfg)
        self.zero_counts()
        with self.logging_launches() as log:
            c_card = render(cprep)
            torch.cuda.synchronize()
        ccounts = self.counts()
        if ccounts["traverse_grid"] <= 0 or ccounts["packed_march"] or ccounts["gi_wave"]:
            raise AssertionError(f"the 64x64 csr GI render launched {ccounts}: B only expected")
        held = self.hold_logged("csr GI 64", log)
        c_cpu = render(prepare(ccfg, device="cpu"))
        a, b = tonemap_u8(c_card.cpu().numpy()), tonemap_u8(c_cpu.numpy())
        frac = image_rule(a, b)
        emit({"phase": "card_vs_cpu", "size": 64, "config": "csr_spot_gi_s2d1",
              "launches": ccounts, "kernel_B_held": held,
              "tolerance": "launches of B bitwise; image by the 2-count rule",
              "floats_differing": int((c_card.cpu().view(torch.int32)
                                       != c_cpu.view(torch.int32)).sum()),
              "bytes_differing": int((a != b).sum()), "pixels_over_2_counts": frac})
        if frac >= 0.01:
            raise AssertionError(f"csr GI 64 card vs CPU: {frac:.2%} of pixels differ by > 2")

    # ---- 11. the appearance epilogues ------------------------------------
    def appearance_images(self):
        """The full-width renders' image texture (256 x 256 x 3, in [0, 1])
        and environment map (256 x 512 x 3, color units), made in numpy from
        a fixed seed: gradients with noise, on the card."""
        import numpy as np

        rng = np.random.default_rng(20261017)
        yy, xx = np.meshgrid(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 256),
                             indexing="ij")
        tex = np.stack([xx, yy, 1.0 - xx * yy], axis=-1) * 0.7 + 0.3 * rng.random((256, 256, 3))
        pol, azi = np.meshgrid(np.linspace(0.0, 1.0, 256), np.linspace(0.0, 1.0, 512),
                               indexing="ij")
        sky = np.stack([60.0 + 150.0 * (1.0 - pol), 90.0 + 120.0 * (1.0 - pol),
                        120.0 + 60.0 * np.cos(2.0 * np.pi * azi)], axis=-1)
        env = sky + 40.0 * rng.random((256, 512, 3))
        return (torch.from_numpy(tex.astype(np.float32)).to(self.dev),
                torch.from_numpy(env.astype(np.float32)).to(self.dev))

    def quad_gi_config(self, size, S, D, texture, **kw):
        """The uv-mapped quad under a point light (tests/test_torch_appearance.py,
        after tests/test_pathtrace.py's textured scene), prepared for the GI
        wave: (cfg, scene)."""
        import numpy as np

        from ray_tracer_tpu_torch.config import (CameraConfig, LightConfig, MaterialConfig,
                                                 SceneConfig)
        from ray_tracer_tpu_torch.io.obj import MeshArrays
        from ray_tracer_tpu_torch.models.scenes import scene_from_meshes

        quad = MeshArrays(
            verts=np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32),
            faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
            uvs=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
            uv_faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32))
        mat = MaterialConfig(base_color=(200.0, 120.0, 60.0), kd=2.0, ks=0.0, spec_alpha=4.0,
                             ka=0.3, **kw.pop("material", {}))
        light = LightConfig(position=(0.0, 8.0, 0.0), intensity=50.0)
        scene = scene_from_meshes([(quad, 0)], [mat], light, device=self.dev)
        cfg = SceneConfig(materials=(mat,), light=light, camera=CameraConfig(
            position=(0.0, 5.0, 0.01), target=(0, 0, 0), up=(0, 0, 1), fov_degrees=45.0,
            width=size, height=size))
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(
            cfg.render, shading="parallel", faithful=False, det_dtype="float32",
            traversal="packed", scheduler="persistent", shadow_eps=1e-3, texture=texture,
            texture_scale=4.0, gi_samples=S, gi_depth=D, gi_wave="on", **kw))
        return cfg, scene

    def appearance_cases(self):
        """Kernel F's feature cases, 64^2 to 128^2, after the JAX package's
        tests (tests/test_pathtrace.py:695-1000): (name, cfg, scene)."""
        import numpy as np

        from ray_tracer_tpu_torch.models.scenes import (build_scene, gradcheck_scene,
                                                        parallel_scene_config)

        def rep(cfg, **kw):
            return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))

        def img(a):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.dev)

        flat = img(np.broadcast_to(np.float32(100.0), (4, 8, 3)))
        ramp = img(np.linspace(5.0, 90.0, 4 * 8 * 3).reshape(4, 8, 3))
        tex = img(np.linspace(0.1, 1.0, 4 * 4 * 3).reshape(4, 4, 3))
        cases = []
        plane_cfg, plane_scene = self.plane_gi_config(64)
        furnace = plane_scene._replace(
            env_image=flat, materials=plane_scene.materials._replace(
                base_color=torch.full_like(plane_scene.materials.base_color, 127.5)),
            light_intensity=torch.zeros_like(plane_scene.light_intensity))
        cases.append(("env_furnace_plane_64_s3d1", rep(plane_cfg, gi_samples=3, gi_depth=1),
                      furnace))
        gscene, gcfg = gradcheck_scene(128, 128, device=self.dev)
        gscene = gscene._replace(light_intensity=torch.full_like(gscene.light_intensity, 40.0))
        gcfg = rep(gcfg, faithful=False, det_dtype="float32", traversal="packed",
                   scheduler="persistent", gi_wave="on")
        cases.append(("env_gradcheck_128_s2d2", rep(gcfg, gi_samples=2, gi_depth=2),
                      gscene._replace(env_image=ramp)))
        cases.append(("smooth_plane_64_s2d1",
                      rep(plane_cfg, gi_samples=2, gi_depth=1, normal_mode="smooth"),
                      plane_scene))
        cases.append(("smooth_gradcheck_128_s2d1",
                      rep(gcfg, gi_samples=2, gi_depth=1, normal_mode="smooth"), gscene))
        for texture in ("checker", "image"):
            for D in (0, 1):
                cfg, scene = self.quad_gi_config(64, 2, D, texture,
                                                 background=(12.0, 8.0, 4.0))
                if texture == "image":
                    scene = scene._replace(texture_image=tex)
                cases.append((f"{texture}_quad_64_s2d{D}", cfg, scene))
        cfg, scene = self.quad_gi_config(64, 2, 0, "checker", normal_mode="smooth",
                                         material=dict(km=0.3, reflective=True))
        cases.append(("all_quad_mirror_64_s2d0", cfg, scene._replace(
            env_image=img(np.broadcast_to(np.array([40.0, 30.0, 20.0], np.float32),
                                          (4, 8, 3))))))
        pcfg = rep(self.gi_config(parallel_scene_config, 128, "parallel", 2, 3),
                   normal_mode="smooth", texture="image", gi_wave="on")
        cases.append(("all_parallel_mirror_128_s2d3", pcfg, build_scene(pcfg)._replace(
            env_image=ramp, texture_image=tex)))
        return cases

    # ---- 12. the train step: differentiate and fit ----------------------
    def train(self):
        """BASELINE config 4 on the card: nefertiti at 1024x1024 under the
        turbo knobs, verts and the materials and light trainable, 6 steps
        of fit() against the self-demo target with a rebuild after step 3;
        the forward under autograd bitwise render()'s image; card against
        CPU on the gradcheck scene with soft visibility and soft primary;
        kernel C's first launch held to its plain version."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_calls

        size, steps = 1024, 6
        trainable = ("verts", "base_color", "kd", "ks", "ka", "light_pos")
        prep = self.nef_prep
        prep_s = None
        if prep is None:
            scene, base = nefertiti_scene(size, size, device=self.dev)
            t0 = time.perf_counter()
            prep = prepare(apply_turbo(base, "nefertiti"), scene=scene)
            torch.cuda.synchronize()
            prep_s = time.perf_counter() - t0
        target = render(prep)
        p = fitmod.split_scene(prep.scene)
        demo = prep._replace(scene=fitmod.merge_scene(
            p._replace(kd=p.kd * 1.5, base_color=p.base_color * 0.6), prep.scene))
        self.forward_under_autograd("nefertiti_1024", demo, trainable)

        # the fit, its steps timed with CUDA events and its rebuild (kernels H
        # and G on the card, the rows on the host) on the host's clock
        step_events, rebuild_s = [], []
        make_step, rebuild = fitmod.make_train_step, fitmod._rebuild

        def timed_make_step(*a, **kw):
            step, init = make_step(*a, **kw)

            def timed(*sa, **skw):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = step(*sa, **skw)
                ev[1].record()
                step_events.append(ev)
                return out
            return timed, init

        def timed_rebuild(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = rebuild(*a, **kw)
            torch.cuda.synchronize()
            rebuild_s.append(time.perf_counter() - t0)
            return out

        torch.cuda.reset_peak_memory_stats()
        fitmod.make_train_step, fitmod._rebuild = timed_make_step, timed_rebuild
        try:
            self.zero_counts()
            with self.logging_launches() as log:
                t0 = time.perf_counter()
                params, losses = fitmod.fit(demo, target, steps=steps, lr=1e-2,
                                            trainable=trainable, rebuild_grid_every=3, log_every=0)
                torch.cuda.synchronize()
                fit_s = time.perf_counter() - t0
            counts = self.counts()
        finally:
            fitmod.make_train_step, fitmod._rebuild = make_step, rebuild
        self.path_launches["train_nefertiti"] = counts
        peak = torch.cuda.max_memory_allocated()
        if counts["packed_march"] <= 0:
            raise AssertionError("the fit launched packed_march 0 times")
        if len(log) != steps or len(rebuild_s) != 1:
            raise AssertionError(f"expected one launch of C a step and one rebuild, got "
                                 f"{len(log)} launches, {len(rebuild_s)} rebuilds")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"the fit's losses do not fall: {losses}")
        if not all(bool(torch.isfinite(x).all()) for x in params if x is not None):
            raise AssertionError("non-finite parameters after the fit")
        held = self.hold_logged("train step 0", log[:1])
        step_ms = [a.elapsed_time(b) for a, b in step_events]
        med_s = sorted(step_ms[1:])[len(step_ms[1:]) // 2] / 1e3

        # a three-step profiler window of the train step at the fitted params
        step, init = fitmod.make_train_step(prep.packed.meta, prep.cfg, lr=1e-2,
                                            trainable=trainable)
        tp, opt = init(params)
        consts = prep.frame().consts
        prof = profile_calls(lambda: step(tp, opt, prep.scene, prep.packed.arrays, target,
                                          consts=consts), med_s, "train_nefertiti_1024", 3)
        emit({"phase": "train", "config": "nefertiti_1024 (BASELINE config 4)", "size": size,
              "triangles": prep.scene.num_faces, "trainable": list(trainable), "steps": steps,
              "rebuild_grid_every": 3, "optimizer": "adam", "lr": 1e-2,
              "losses": losses, "step_ms": step_ms, "median_step_ms": med_s * 1e3,
              "mrays_per_s_fwd_bwd": size * size * 2 / med_s / 1e6,
              "rebuild_s": rebuild_s, "fit_s": fit_s, "prepare_s": prep_s,
              "max_memory_allocated_gib": peak / 2 ** 30, "launches": counts,
              "kernel_C_first_step": held,
              "device_busy_ms_per_step": prof["device_busy_ms"],
              "device_idle_share": prof["device_idle_share"],
              "device_kernels_per_step": prof["device_kernels"],
              "top_device_ms": prof["top_device_ms"]})
        self.train_card_vs_cpu()

    def forward_under_autograd(self, label, prep, trainable):
        """The colors the loss sees, every trainable leaf requiring grad,
        are render()'s image bit for bit."""
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import render

        img = render(prep)
        params = fitmod.split_scene(prep.scene)
        params = params._replace(**{f: getattr(params, f).clone().requires_grad_(True)
                                    for f in trainable})
        grid, meta = fitmod._grid_of(prep)
        colors = fitmod._colors(params, prep.scene, grid, meta, prep.cfg, prep.dda,
                                prep.frame().consts)
        if not colors.requires_grad:
            raise AssertionError(f"{label}: the loss's colors are not under autograd")
        n = int((colors.detach().reshape(img.shape).view(torch.int32)
                 != img.view(torch.int32)).sum())
        emit({"phase": "train_forward_bitwise", "config": label, "floats_differing": n})
        if n:
            raise AssertionError(f"{label}: the forward under autograd differs from render() "
                                 f"in {n} floats")

    def train_card_vs_cpu(self):
        """The gradcheck scene at 64x64 with soft visibility and soft primary
        (csr, kernel B): the forward under autograd bitwise render()'s on the
        card; the loss on the card against the CPU's to rtol 1e-6, every
        gradient leaf to rtol 1e-4 with atol 1e-6 max|g| (the CPU tests'
        tolerance against JAX)."""
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare

        fields = ("verts", "base_color", "kd", "ka", "light_pos")
        out = {}
        for dev in ("cuda", "cpu"):
            scene, cfg = gradcheck_scene(64, 64, device=dev)
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, soft_visibility=0.1, soft_primary=0.08))
            prep = prepare(cfg, scene=scene)
            if dev == "cuda":
                self.forward_under_autograd("gradcheck_64_soft", prep, fields)
            target = torch.full((64, 64, 3), 40.0, device=dev)
            params = fitmod.split_scene(prep.scene)
            leaves = {f: getattr(params, f).clone().requires_grad_(True) for f in fields}
            self.zero_counts()
            loss = fitmod.image_loss(params._replace(**leaves), prep.scene, prep.grid.arrays,
                                     prep.grid.meta, cfg, target, dda=prep.dda)
            grads = torch.autograd.grad(loss, list(leaves.values()))
            if dev == "cuda" and self.counts()["traverse_grid"] <= 0:
                raise AssertionError("the gradcheck loss launched traverse_grid 0 times")
            out[dev] = (float(loss.detach()), [g.cpu() for g in grads])
        rel = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
        worst = {}
        for f, g, w in zip(fields, out["cuda"][1], out["cpu"][1]):
            atol = 1e-6 * float(w.abs().max())
            excess = (g - w).abs() - (atol + 1e-4 * w.abs())
            worst[f] = float((g - w).abs().max())
            if bool((excess > 0).any()) or not bool(torch.isfinite(g).all()):
                raise AssertionError(f"gradcheck 64x64: gradient {f} card vs CPU beyond "
                                     f"rtol 1e-4, atol {atol:.3g}")
        emit({"phase": "train_card_vs_cpu", "config": "gradcheck_64 soft_visibility 0.1 "
              "soft_primary 0.08", "loss_cuda": out["cuda"][0], "loss_cpu": out["cpu"][0],
              "loss_rel_err": rel, "grad_max_abs_err": worst,
              "tolerance": "loss rtol 1e-6; gradients rtol 1e-4, atol 1e-6 max|g|"})
        if rel > 1e-6:
            raise AssertionError(f"gradcheck 64x64: loss card vs CPU rel err {rel:.3g}")
        self.silhouette_fd()

    def silhouette_fd(self):
        """soft_primary 0.08 on one triangle at 16x16 on the card: the
        vertex gradients that drag its silhouette across pixel centres
        against central differences (rtol 5e-2, as the CPU test)."""
        import numpy as np

        from ray_tracer_tpu_torch.config import (
            CameraConfig, LightConfig, MaterialConfig, RenderConfig, SceneConfig,
        )
        from ray_tracer_tpu_torch.io.obj import MeshArrays
        from ray_tracer_tpu_torch.models.scenes import scene_from_meshes
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare

        tri = MeshArrays(verts=np.array([[-1.2, -1.0, 0.0], [1.2, -1.0, 0.0], [0.0, 1.2, 0.0]],
                                        np.float32),
                         faces=np.array([[0, 1, 2]], np.int32),
                         uvs=np.zeros((1, 2), np.float32), uv_faces=np.zeros((1, 3), np.int32))
        mat = MaterialConfig(base_color=(220.0, 160.0, 40.0), kd=2.0, ks=1.0, spec_alpha=4.0,
                             ka=0.3)
        light = LightConfig(position=(0.0, 0.0, 6.0), intensity=1.0)
        cfg = SceneConfig(
            materials=(mat,), light=light,
            camera=CameraConfig(position=(0.0, 0.0, 4.0), target=(0, 0, 0), up=(0, 1, 0),
                                fov_degrees=45.0, width=16, height=16),
            render=RenderConfig(shading="parallel", faithful=False, max_bounces=0,
                                shadow_eps=1e-3, shadow_scale=0.5, soft_primary=0.08))
        prep = prepare(cfg, scene=scene_from_meshes([(tri, 0)], [mat], light, device=self.dev))
        target = torch.zeros((16, 16, 3), device=self.dev)
        params = fitmod.split_scene(prep.scene)

        def loss_of(verts):
            return fitmod.image_loss(params._replace(verts=verts), prep.scene, prep.grid.arrays,
                                     prep.grid.meta, cfg, target, dda=prep.dda)

        verts = params.verts.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_of(verts), verts)
        out, eps = [], 2e-3
        for idx in ((0, 0), (2, 1)):
            with torch.no_grad():
                up, down = params.verts.clone(), params.verts.clone()
                up[idx] += eps
                down[idx] -= eps
                fd = (float(loss_of(up)) - float(loss_of(down))) / (2 * eps)
            analytic = float(g[idx])
            out.append({"vertex": list(idx), "autodiff": analytic, "fd": fd})
            if not abs(analytic - fd) <= 1e-7 + 5e-2 * abs(fd):
                raise AssertionError(f"silhouette gradient {idx}: autodiff {analytic} vs "
                                     f"finite differences {fd}")
        emit({"phase": "train_silhouette_fd", "size": 16, "soft_primary": 0.08,
              "checks": out, "tolerance": "rtol 5e-2, atol 1e-7"})

    def appearance(self):
        """The appearance epilogues on the card: kernel F's feature
        instantiations against the plain wave on their cases; the GI row's
        configuration with smooth normals, an image texture and an
        environment map at 1024^2 through render() (F once a frame), held
        bitwise to the plain wave and timed beside the featureless row; and
        the Whitted bounce loop with all three at 1024^2, card against CPU
        at 64^2 by the 2-count rule."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import build_scene, serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        # 1. kernel F against its plain version on every feature case
        err = 0.0
        out = []
        for name, cfg, scene in self.appearance_cases():
            prep = prepare(cfg, scene=scene)
            if not prep.setup.gi_wave:
                raise AssertionError(f"appearance {name}: the config should take the GI wave")
            e, events, passes = self.gi_check(f"kernel F {name}", prep)
            err = max(err, e)
            g = prep.gi
            out.append({"case": name, "pixels": cfg.camera.width * cfg.camera.height,
                        "S": cfg.render.gi_samples, "D": cfg.render.gi_depth,
                        "env": prep.scene.env_image is not None, "smooth": g.fvn9 is not None,
                        "texture": (None if g.fuv7 is None
                                    else "image" if g.tex_image is not None else "checker"),
                        "mirror_mix": g.km is not None, "events": events, "passes": passes})
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        emit({"phase": "appearance_kernel_F_vs_plain", "cases": out, "max_abs_err": err,
              "tolerance": "bitwise (radiance and every counter)", "equal": True})

        # 2. the GI row's configuration with all three features, and without
        tex, env = self.appearance_images()
        size, S, D = 1024, 4, 2
        rows = {}
        for name, feats in (("gi_spot_1024_s4d2", {}),
                            ("gi_spot_1024_s4d2_appearance",
                             dict(normal_mode="smooth", texture="image"))):
            cfg = self.gi_config(serial_scene_config, size, "serial", S, D, **feats)
            scene = None
            if feats:
                scene = build_scene(cfg)._replace(texture_image=tex, env_image=env)
            p = prepare(cfg, scene=scene)
            self.zero_counts()
            img = render(p)
            torch.cuda.synchronize()
            counts = self.counts()
            if counts["gi_wave"] != 1 or sum(counts.values()) != 1:
                raise AssertionError(f"{name} launched {counts}: F once and nothing else "
                                     "expected")
            self.path_launches[name] = counts
            if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}: bad image {tuple(img.shape)}")
            secs = []
            for _ in range(5):
                t0 = time.perf_counter()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    render(p)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            med = sorted(secs)[2]
            prof = profile_render(p, med, name)
            tail, kw, _ = self.gi_inputs(p)
            f_dev_ms, _ = calls_device_ms(lambda: self.gi_launch(p, tail, kw), 10)
            rows[name] = {"median_ms": med * 1e3, "renders_ms": [x * 1e3 for x in secs],
                          "device_busy_ms": prof["device_busy_ms"],
                          "device_idle_share": prof["device_idle_share"],
                          "kernel_F_device_ms": f_dev_ms, "launches": counts}
            if feats:
                e, events, passes = self.gi_check(f"kernel F {name}", p)
                self.err["gi_wave"] = max(self.err["gi_wave"], e)
                rows[name].update(events=events, passes=passes, max_abs_err=e,
                                  bitwise_vs_plain=True,
                                  images={"texture": list(tex.shape), "env": list(env.shape)})
        regs = {k: v for k, v in self.ptxas.get("gi_wave", {}).items()
                if k.startswith(("gi_primary_kernel", "gi_sample_kernel"))}
        for k in ("gi_primary_kernelILb0ELb0ELi0EE", "gi_sample_kernelILb0ELb0ELi0EE"):
            if k not in regs or regs[k].get("spill_stores", 0) or regs[k].get("spill_loads", 0):
                raise AssertionError(f"the featureless stage {k} spills or is missing: "
                                     f"{regs.get(k)}")
        emit({"phase": "appearance_gi", "size": size, "S": S, "D": D, "rows": rows,
              "ptxas_by_instantiation": regs,
              "instantiation_keys": "gi_<stage>_kernelILb<env>ELb<smooth>ELi<texture: 0 none, "
                                    "1 checker, 2 image>EE"})

        # 3. the Whitted bounce loop with all three features
        def whitted(n, device):
            cfg = apply_turbo(serial_scene_config(n, n), "serial")
            cfg = dataclasses.replace(cfg, render=dataclasses.replace(
                cfg.render, normal_mode="smooth", texture="image"))
            scene = build_scene(cfg, device=device)._replace(
                texture_image=tex.to(device), env_image=env.to(device))
            return prepare(cfg, scene=scene)

        p = whitted(1024, "cuda")
        self.zero_counts()
        img = render(p)
        torch.cuda.synchronize()
        counts = self.counts()
        if counts["packed_march"] < 1 or counts["whitted_wave"] or counts["gi_wave"]:
            raise AssertionError(f"the Whitted appearance frame launched {counts}: C, not E "
                                 "or F, expected")
        self.path_launches["turbo_spot_whitted_appearance"] = counts
        if not bool(torch.isfinite(img).all()):
            raise AssertionError("the Whitted appearance frame has non-finite colors")
        secs = []
        for _ in range(5):
            t0 = time.perf_counter()
            render(p)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        a = tonemap_u8(render(whitted(64, "cuda")).cpu().numpy())
        b = tonemap_u8(render(whitted(64, "cpu")).numpy())
        frac = image_rule(a, b)
        emit({"phase": "appearance_whitted", "size": 1024, "config": "turbo serial, smooth, "
              "image texture 256x256, env 256x512", "launches": counts,
              "median_ms": sorted(secs)[2] * 1e3, "renders_ms": [x * 1e3 for x in secs],
              "card_vs_cpu_64": {"bytes_differing": int((a != b).sum()),
                                 "pixels_over_2_counts": frac,
                                 "tolerance": "under 1% of pixels over 2 counts"}})
        if frac >= 0.01:
            raise AssertionError(f"Whitted appearance 64 card vs CPU: {frac:.2%} of pixels "
                                 "differ by > 2")

    # ---- 13. the lights and materials of the JAX package ------------------
    def lights_configs(self, size, device):
        """This phase's frames at size x size, each with its featureless
        counterparts: {name: (cfg, scene or None, [(base name, cfg, scene)])}.
        (a) the turbo serial scene with two extra lights and a 16-sample
        area light; (b) the turbo parallel scene, 3 bounces, one extra
        light (the Whitted wave is then ineligible: the bounce loop on C);
        (c) the path-traced serial scene (S 4, D 2) with one extra light,
        blub made glass (ior 1.5) and env NEE under a 64 x 128 sky (the
        segment integrator on C)."""
        import numpy as np

        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import (build_scene, parallel_scene_config,
                                                        serial_scene_config)

        def rep(cfg, **kw):
            return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))

        serial = apply_turbo(serial_scene_config(size, size), "serial")
        a = dataclasses.replace(rep(serial, **AREA_LIGHT), extra_lights=extra_lights(LIGHTS_A))
        parallel = apply_turbo(parallel_scene_config(size, size), "parallel")
        b = dataclasses.replace(parallel, extra_lights=extra_lights(LIGHTS_B))
        gi = self.gi_config(serial_scene_config, size, "serial", 4, 2)
        glass = dataclasses.replace(gi.materials[0], transmissive=True, ior=1.5)
        c = dataclasses.replace(
            rep(gi, gi_env_nee=True), extra_lights=extra_lights(LIGHTS_C),
            materials=(gi.materials[0], glass),
            meshes=(gi.meshes[0], dataclasses.replace(gi.meshes[1], material_index=1)))
        # the sky: blue above, a warm horizon, a bright sun patch (numpy,
        # fixed seed)
        rng = np.random.default_rng(20261018)
        pol, azi = np.meshgrid(np.linspace(0.0, 1.0, 64), np.linspace(0.0, 1.0, 128),
                               indexing="ij")
        sky = np.stack([50.0 + 140.0 * pol, 80.0 + 90.0 * pol, 200.0 - 120.0 * pol], axis=-1)
        sky = sky * (0.9 + 0.1 * np.cos(2.0 * np.pi * azi))[..., None]
        sky[10:14, 40:46] = 4000.0
        sky = torch.from_numpy((sky + 8.0 * rng.random(sky.shape)).astype(np.float32))
        c_scene = build_scene(c, device=device)._replace(env_image=sky.to(device))
        return {
            "a_serial_extras_area": (a, None, [("a_serial_featureless", serial, None)]),
            "b_parallel_extra_light": (b, None, [
                ("b_parallel_featureless_bounce_loop", rep(parallel, whitted_wave="off"), None),
                ("b_parallel_featureless_wave", parallel, None)]),
            "c_gi_extra_light_glass_env_nee": (c, c_scene, [
                ("c_gi_featureless_segments", rep(gi, gi_wave="off"), None),
                ("c_gi_featureless_wave", gi, None)]),
        }

    def frame_times(self, p, name) -> dict:
        """A frame's CUDA-event time (median of 5 after a warm-up, each
        frame timed alone), and the ten-frame profile's kernels, busy time
        and idle share against it."""
        from ray_tracer_tpu_torch.render.renderer import render
        from ray_tracer_tpu_torch.tools.profiling import profile_render

        render(p)
        ms = [once_ms(lambda: render(p))[0] for _ in range(5)]
        med = sorted(ms)[2]
        prof = profile_render(p, med / 1e3, name)
        return {"median_ms": med, "frames_ms": ms, "device_kernels": prof["device_kernels"],
                "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "top_device_ms": prof["top_device_ms"]}

    def lights(self, size=1024):
        """Extra point lights, area-light soft shadows, glass and env NEE
        on the card at 1024^2: frames (a) to (c) of `lights_configs` through
        prepare + render, each launching C and neither wave, timed beside
        their featureless counterparts; (a) byte-equal at shadow_sample_batch
        1 and 4, and every launch of C that (a) at batch 4 and (c) make held
        bitwise to the plain version at its own inputs; (d) five fit steps on
        the gradcheck scene at 256^2 with one extra light; each of (a) to
        (c), a csr (a) and (d)'s gradients at 64^2, card against CPU."""
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        rows = {}
        for name, (cfg, scene, bases) in self.lights_configs(size, self.dev).items():
            p = prepare(cfg, scene=scene)
            if p.setup.wave or p.setup.gi_wave:
                raise AssertionError(f"{name} should take neither wave")
            # every launch of C that (c) makes is logged, to be held below
            logging = name.startswith("c_")
            self.zero_counts()
            with (self.logging_launches() if logging else contextlib.nullcontext()) as log:
                img = render(p)
                torch.cuda.synchronize()
            counts = self.counts()
            self.path_launches[name] = counts
            if (counts["packed_march"] < 1 or counts["whitted_wave"] or counts["gi_wave"]
                    or counts["traverse_grid"]):
                raise AssertionError(f"{name} launched {counts}: C alone expected")
            if img.shape != (size, size, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{name}: bad image")
            row = {"launches": counts, **self.frame_times(p, name)}
            if name.startswith("a_"):
                # the same frame in batches of 4 samples: 4R shadow rays a
                # launch of C, each launch logged to be held below
                logging = True
                p4 = prepare(dataclasses.replace(cfg, render=dataclasses.replace(
                    cfg.render, shadow_sample_batch=4)))
                self.zero_counts()
                with self.logging_launches() as log:
                    img4 = render(p4)
                    torch.cuda.synchronize()
                counts4 = self.counts()
                n_bad = int((img4.view(torch.int32) != img.view(torch.int32)).sum())
                if n_bad:
                    raise AssertionError(f"{name}: shadow_sample_batch 4 differs from 1 in "
                                         f"{n_bad} floats")
                r = size * size
                batched = [x for x in log if x[1].count == 4 * r]
                if len(batched) != 4 * 3 or any(x[3].get("queue") is None for x in batched):
                    raise AssertionError(f"{name}: expected 12 compacted launches of 4R shadow "
                                         f"rays, got {[x[1].count for x in log]}")
                row["batch_4"] = {"launches": counts4, "floats_differing_from_batch_1": 0,
                                  **self.frame_times(p4, name + "_batch4")}
            if logging:
                row["kernel_C_held"] = self.hold_logged(name, log)
                del log
            row["lit_pixels"] = int((tonemap_u8(img.cpu().numpy()).max(axis=-1) > 0).sum())
            for bname, bcfg, bscene in bases:
                bp = prepare(bcfg, scene=bscene)
                self.zero_counts()
                render(bp)
                torch.cuda.synchronize()
                bcounts = self.counts()
                self.path_launches[bname] = bcounts
                rows[bname] = {"launches": bcounts, **self.frame_times(bp, bname)}
            rows[name] = row
            emit({"phase": "lights_frame", "config": name, "size": size, **row,
                  "featureless": {b: rows[b] for b, _, _ in bases},
                  "extra_lights": [list(l.position) + [l.intensity] for l in cfg.extra_lights],
                  "tolerance": "launches of C bitwise against the plain version (records, "
                               "rows tested and touched, capped lanes, most steps)"})
        self.lights_fit(256 if size == 1024 else size)
        self.lights_card_vs_cpu()

    def lights_fit(self, size=256):
        """(d) The gradcheck scene at 256^2 with one extra light (kernel B):
        extra_light_pos, extra_light_intensity and light_pos trainable, five
        Adam steps from a perturbed start toward the true render, each timed
        with CUDA events; the losses finite and falling."""
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        trainable = ("extra_light_pos", "extra_light_intensity", "light_pos")
        scene, cfg = gradcheck_scene(size, size, device=self.dev)
        cfg = dataclasses.replace(cfg, extra_lights=extra_lights(LIGHTS_FIT))
        prep = prepare(cfg, scene=scene)
        target = render(prep)
        p = fitmod.split_scene(prep.scene)
        start = prep._replace(scene=fitmod.merge_scene(p._replace(
            extra_light_pos=p.extra_light_pos + 0.4,
            extra_light_intensity=p.extra_light_intensity * 1.5), prep.scene))
        events = []
        make_step = fitmod.make_train_step

        def timed_make_step(*a, **kw):
            step, init = make_step(*a, **kw)

            def timed(*sa, **skw):
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                out = step(*sa, **skw)
                ev[1].record()
                events.append(ev)
                return out
            return timed, init

        fitmod.make_train_step = timed_make_step
        try:
            self.zero_counts()
            params, losses = fitmod.fit(start, target, steps=5, lr=2e-2, trainable=trainable,
                                        log_every=0)
            torch.cuda.synchronize()
            counts = self.counts()
        finally:
            fitmod.make_train_step = make_step
        self.path_launches["d_fit_gradcheck_extra_light"] = counts
        if counts["traverse_grid"] <= 0:
            raise AssertionError("the extra-light fit launched traverse_grid 0 times")
        if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
            raise AssertionError(f"the extra-light fit's losses do not fall: {losses}")
        step_ms = [a.elapsed_time(b) for a, b in events]
        emit({"phase": "lights_fit", "config": "gradcheck, one extra light", "size": size,
              "trainable": list(trainable), "losses": losses, "step_ms": step_ms,
              "median_step_ms": sorted(step_ms[1:])[len(step_ms[1:]) // 2],
              "launches": counts, "extra_light_pos": params.extra_light_pos.tolist()})

    def lights_card_vs_cpu(self):
        """(a) to (c) at 64x64, and (a) over the csr grid (kernel B), card
        against CPU: the image by the 2-count rule (the floats that differ
        reported: powf and, with the sky, acos and atan2 differ between the
        card's libdevice and the CPU); (d)'s loss at 64x64 to rtol 1e-6 and
        its gradients to rtol 1e-4, atol 1e-6 max|g|."""
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene
        from ray_tracer_tpu_torch.opt import fit as fitmod
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        out = {}
        devs = {"card": self.dev, "cpu": torch.device("cpu")}
        cases = {k: self.lights_configs(64, dev) for k, dev in devs.items()}
        for k in cases:
            a = cases[k]["a_serial_extras_area"][0]
            cases[k]["a_csr"] = (dataclasses.replace(a, render=dataclasses.replace(
                a.render, traversal="csr")), None, [])
        for name in cases["card"]:
            imgs = {}
            for k, dev in devs.items():
                cfg, scene, _ = cases[k][name]
                self.zero_counts()
                imgs[k] = render(prepare(cfg, scene=scene,
                                         device=dev if scene is None else None)).cpu()
                if k == "card":
                    counts = self.counts()
            kernel = "traverse_grid" if name == "a_csr" else "packed_march"
            if counts[kernel] <= 0:
                raise AssertionError(f"{name} 64: {kernel} not launched ({counts})")
            a, b = tonemap_u8(imgs["card"].numpy()), tonemap_u8(imgs["cpu"].numpy())
            frac = image_rule(a, b)
            out[name] = {"launches": counts, "pixels_over_2_counts": frac,
                         "bytes_differing": int((a != b).sum()),
                         "floats_differing": int((imgs["card"].view(torch.int32)
                                                  != imgs["cpu"].view(torch.int32)).sum())}
            if frac >= 0.01:
                raise AssertionError(f"{name} 64 card vs CPU: {frac:.2%} of pixels differ "
                                     "by > 2")
        fields = ("extra_light_pos", "extra_light_intensity", "light_pos")
        grads = {}
        for k, dev in devs.items():
            scene, cfg = gradcheck_scene(64, 64, device=dev)
            prep = prepare(dataclasses.replace(cfg, extra_lights=extra_lights(LIGHTS_FIT)),
                           scene=scene)
            params = fitmod.split_scene(prep.scene)
            leaves = {f: getattr(params, f).clone().requires_grad_(True) for f in fields}
            loss = fitmod.image_loss(params._replace(**leaves), prep.scene, prep.grid.arrays,
                                     prep.grid.meta, prep.cfg,
                                     torch.full((64, 64, 3), 40.0, device=dev), dda=prep.dda)
            grads[k] = (float(loss.detach()),
                        [g.cpu() for g in torch.autograd.grad(loss, list(leaves.values()))])
        rel = abs(grads["card"][0] - grads["cpu"][0]) / abs(grads["cpu"][0])
        worst = {}
        for f, g, w in zip(fields, grads["card"][1], grads["cpu"][1]):
            atol = 1e-6 * float(w.abs().max())
            worst[f] = float((g - w).abs().max())
            if bool(((g - w).abs() > atol + 1e-4 * w.abs()).any()) or not bool(
                    torch.isfinite(g).all()):
                raise AssertionError(f"extra-light gradient {f} card vs CPU beyond rtol 1e-4, "
                                     f"atol {atol:.3g}")
        out["d_fit_gradients"] = {"loss_cuda": grads["card"][0], "loss_cpu": grads["cpu"][0],
                                  "loss_rel_err": rel, "grad_max_abs_err": worst}
        emit({"phase": "lights_card_vs_cpu", "size": 64, "cases": out,
              "tolerance": "images: under 1% of pixels over 2 counts; loss rtol 1e-6; "
                           "gradients rtol 1e-4, atol 1e-6 max|g|"})
        if rel > 1e-6:
            raise AssertionError(f"extra-light loss card vs CPU rel err {rel:.3g}")

    # ---- 14. dtype="float64" ------------------------------------------
    def float64(self, size=1024):
        """dtype="float64" on the card at size x size: the csr serial frame
        with float32 and float64 dets (kernel B's f64-ray instantiations,
        every launch held bitwise to the plain version at its own inputs),
        the turbo serial frame (C on float32 copies, the bounce loop's
        epilogue on the float64 rays) and the GI segment integrator at
        256x256 (the GI wave refuses float64), each timed beside its
        float32 frame; then 64x64 card against CPU."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        def rep(cfg, **kw):
            return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **kw))

        b = self.kB.traverse_grid_cuda
        main = serial_scene_config(size, size)
        gi = self.gi_config(serial_scene_config, 256, "serial", 4, 2)
        frames = {
            "csr_det32": (rep(main, dtype="float64"), main, "traverse_grid"),
            "csr_det64": (rep(main, dtype="float64", det_dtype="float64"),
                          rep(main, det_dtype="float64"), "traverse_grid"),
            "turbo": (rep(apply_turbo(main, "serial"), dtype="float64"),
                      apply_turbo(main, "serial"), "packed_march"),
            "gi_segments_256": (rep(gi, dtype="float64"), rep(gi, gi_wave="off"),
                                "packed_march"),
        }
        for name, (cfg, base, kernel) in frames.items():
            p = prepare(cfg)
            if p.setup.wave or p.setup.gi_wave:
                raise AssertionError(f"float64 {name} took a wave")
            csr = kernel == "traverse_grid"
            self.zero_counts()
            with (self.logging_launches() if csr else contextlib.nullcontext()) as log:
                img = render(p)
                torch.cuda.synchronize()
            counts = self.counts()
            n_f64 = b.launches_f64
            self.path_launches[f"float64_{name}"] = dict(counts, traverse_grid_f64=n_f64)
            if counts[kernel] < 1 or counts["whitted_wave"] or counts["gi_wave"]:
                raise AssertionError(f"float64 {name} launched {counts}")
            if csr != (n_f64 == counts["traverse_grid"] > 0):
                raise AssertionError(f"float64 {name}: {n_f64} f64-ray launches of B in "
                                     f"{counts}")
            h = img.shape[0]
            if img.dtype != torch.float64 or img.shape != (h, h, 3) or not bool(
                    torch.isfinite(img).all()):
                raise AssertionError(f"float64 {name}: bad image {img.dtype} {img.shape}")
            row = {"launches": counts, "launches_B_f64_rays": n_f64,
                   **self.frame_times(p, f"float64_{name}")}
            if csr:
                if any(x[1].orig.dtype != torch.float64 for x in log):
                    raise AssertionError(f"float64 {name}: B took non-float64 rays")
                row["kernel_B_held"] = self.hold_logged(f"float64 {name}", log)
                del log
                if name == "csr_det32":
                    self.launches["traverse_grid_f64"] = n_f64
            bp = prepare(base)
            self.zero_counts()
            render(bp)
            torch.cuda.synchronize()
            row["float32"] = {"launches": self.counts(),
                              **self.frame_times(bp, f"float32_{name}")}
            emit({"phase": "float64_frame", "config": name, "size": h, **row,
                  "tolerance": "every launch of B bitwise against the plain version "
                               "(records and rows tested)"})
        self.float64_card_vs_cpu()

    def float64_card_vs_cpu(self):
        """The float64 frames at 64x64, card against CPU: the csr frame with
        float64 dets gives the CPU's PPM bytes (as the float32-ray one does,
        phase card_vs_cpu); the others keep to the 2-count rule.  The floats
        that differ are reported (libdevice's pow against glibc's)."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        def rep(cfg, **kw):
            return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, dtype="float64",
                                                                       **kw))

        small = serial_scene_config(64, 64)
        cases = {"csr_det64": rep(small, det_dtype="float64"), "csr_det32": rep(small),
                 "turbo": rep(apply_turbo(small, "serial")),
                 "gi_segments": rep(self.gi_config(serial_scene_config, 64, "serial", 2, 1))}
        out = {}
        for name, cfg in cases.items():
            self.zero_counts()
            card = render(prepare(cfg)).cpu()
            counts = self.counts()
            cpu = render(prepare(cfg, device="cpu"))
            a, c = tonemap_u8(card.numpy()), tonemap_u8(cpu.numpy())
            frac = image_rule(a, c)
            out[name] = {"launches": counts, "bytes_differing": int((a != c).sum()),
                         "pixels_over_2_counts": frac,
                         "floats_differing": int((card.view(torch.int64)
                                                  != cpu.view(torch.int64)).sum())}
            if name == "csr_det64" and out[name]["bytes_differing"]:
                raise AssertionError(f"float64 csr 64 card vs CPU: {out[name]} PPM bytes differ")
            if frac >= 0.01:
                raise AssertionError(f"float64 {name} 64 card vs CPU: {frac:.2%} of pixels "
                                     "differ by > 2")
        emit({"phase": "float64_card_vs_cpu", "size": 64, "cases": out,
              "tolerance": "csr float64 dets: PPM bytes equal; others under 1% of pixels "
                           "over 2 counts"})

    # ---- 15. inspection: AOVs, AO, metrics and probes, trace_pixel, bands --
    def inspect(self, size=1024):
        """The inspection path on the card: render_aovs, render_ao (16
        samples), trace_pixel at three pixels and render_banded (8 bands) on
        the turbo serial scene and on the csr serial scene at size x size,
        every launch of B and C held bitwise to the plain version; the
        metrics and the three probes on the bench's spot_1024 and
        nefertiti_1024 rows; the command line's stats, debug, aov and info
        at 256x256."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs
        from ray_tracer_tpu_torch.render.debug import trace_pixel
        from ray_tracer_tpu_torch.render.renderer import prepare, render
        from ray_tracer_tpu_torch.render.resilient import render_banded

        main = serial_scene_config(size, size)
        pixels = ((size // 2, size // 2), (size * 3 // 10, size * 7 // 10), (10, 10))
        for name, cfg in (("turbo", apply_turbo(main, "serial")), ("csr", main)):
            p = prepare(cfg)
            kernel = "packed_march" if name == "turbo" else "traverse_grid"
            row = {}
            # AOVs: one primary launch; ids and flags are its record's
            self.zero_counts()
            with self.logging_launches() as log:
                ms, aovs = once_ms(lambda: render_aovs(p))
            counts = self.counts()
            if counts[kernel] != 1 or len(log) != 1:
                raise AssertionError(f"inspect {name} aovs launched {counts}")
            rec = log[0][4]
            hit = aovs["hit"].reshape(-1)
            if not (torch.equal(hit, rec.hit) and torch.equal(
                    aovs["tri_id"].reshape(-1)[hit], rec.tri_id[hit])):
                raise AssertionError(f"inspect {name}: AOV ids differ from the trace's record")
            row["aovs"] = {"ms": ms, "launches": counts, "hits": int(hit.sum()),
                           "held": self.hold_logged(f"inspect {name} aovs", log)}
            del log
            # AO: the primary launch and 16 any-hit launches, each held
            self.zero_counts()
            with self.logging_launches() as log:
                ms, ao = once_ms(lambda: render_ao(p, samples=16, radius=1.0))
            counts = self.counts()
            if counts[kernel] != 17 or not bool(((ao >= 0) & (ao <= 1)).all()):
                raise AssertionError(f"inspect {name} ao launched {counts}")
            if not all(x[3].get("stop_on_first_hit") for x in log[1:]):
                raise AssertionError(f"inspect {name}: AO's occlusion traces were not any-hit")
            row["ao"] = {"ms": ms, "launches": counts, "mean": float(ao.mean()),
                         "held": self.hold_logged(f"inspect {name} ao", log)}
            del log
            # trace_pixel: the frame's primary record at each pixel (the
            # render's own policy: csr faithful walks to the end, any t)
            rays = camera_rays(cfg.camera, device=self.dev)
            if name == "turbo":
                frame_hit, frame_tri, frame_t = hit, aovs["tri_id"].reshape(-1), \
                    aovs["depth"].reshape(-1)
            else:
                tri9 = self.kB.vertex_table(*p.scene.triangle_soa())
                fr = self.kB.traverse_grid(rays, p.grid.arrays, p.grid.meta, tri9,
                                           t_gate=cfg.render.primary_gate(), early_exit=False,
                                           det_dtype=cfg.render.det_dtype, tables=p.dda)
                frame_hit, frame_tri, frame_t = fr.hit, fr.tri_id, fr.t
            traced = []
            for x, y in pixels:
                d = trace_pixel(p, x, y)
                i = y * size + x
                want = (bool(frame_hit[i]), int(frame_tri[i]) if bool(frame_hit[i]) else None,
                        float(frame_t[i]) if bool(frame_hit[i]) else None)
                got = (d["hit"], d["tri_id"] if d["hit"] else None, d["t"] if d["hit"] else None)
                if got != want:
                    raise AssertionError(f"inspect {name}: trace_pixel{(x, y)} {got} against "
                                         f"the frame's {want}")
                traced.append({"pixel": [x, y], "hit": d["hit"], "steps": d["steps"],
                               "in_shadow": d.get("in_shadow")})
            row["trace_pixel"] = traced
            # render_banded: 8 bands, the same bits as render()
            img = render(p).cpu().numpy()
            t0 = time.perf_counter()
            banded = render_banded(p, bands=8)
            banded_s = time.perf_counter() - t0
            if not np.array_equal(banded.view(np.int32), img.view(np.int32)):
                raise AssertionError(f"inspect {name}: render_banded differs from render()")
            row["render_banded"] = {"bands": 8, "seconds": banded_s, "floats_differing": 0}
            emit({"phase": "inspect", "config": name, "size": size, **row,
                  "tolerance": "every launch of B and C bitwise against the plain version; "
                               "AOV ids, trace_pixel and render_banded equal"})
        self.inspect_probes()
        self.inspect_cli()

    def inspect_probes(self):
        """collect_render_metrics (its launches held) and the three probes,
        with their picks and wall times, on the bench's spot_1024 and
        nefertiti_1024 rows."""
        from bench_torch import row_config
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.render import metrics
        from ray_tracer_tpu_torch.render.renderer import frame_setup, prepare

        for row in ("spot_1024", "nefertiti_1024"):
            cfg = row_config(row)
            if row == "spot_1024":
                p = prepare(cfg)
            elif self.nef_prep is not None:
                p = self.nef_prep._replace(cfg=cfg, setup=frame_setup(
                    cfg, self.nef_prep.scene, self.nef_prep.packed))
            else:
                scene, _ = nefertiti_scene(device=self.dev)
                p = prepare(cfg, scene=scene)
            self.zero_counts()
            with self.logging_launches() as log:
                t0 = time.perf_counter()
                m = metrics.collect_render_metrics(p)
                m_s = time.perf_counter() - t0
            counts = self.counts()
            if counts["packed_march"] != 2:
                raise AssertionError(f"metrics {row} launched {counts}")
            held = self.hold_logged(f"metrics {row}", log)
            del log
            picks = {}
            for probe in ("estimate_coverage", "choose_fused_shadow", "choose_camera_refill"):
                t0 = time.perf_counter()
                value = getattr(metrics, probe)(p)
                torch.cuda.synchronize()
                picks[probe] = {"value": value, "seconds": time.perf_counter() - t0}
            emit({"phase": "inspect_metrics", "row": row, "metrics": m, "seconds": m_s,
                  "launches": counts, "held": held, "probes": picks})

    def inspect_cli(self):
        """python -m ray_tracer_tpu_torch.cli stats, debug, aov and info at
        256x256 as subprocesses, all four started together (each spends
        most of its time starting): each exits 0 and its output parses."""
        out_npz = os.path.join(self.root, "build", "chip_smoke_aovs.npz")
        os.makedirs(os.path.dirname(out_npz), exist_ok=True)
        scene = ["--scene", "serial", "--width", "256"]
        t0 = time.perf_counter()
        procs = {cmd: subprocess.Popen(
            [sys.executable, "-m", "ray_tracer_tpu_torch.cli", cmd, *args], cwd=self.root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for cmd, args in (("stats", scene + ["--turbo"]),
                              ("debug", scene + ["--x", "128", "--y", "128"]),
                              ("aov", scene + ["--turbo", "--ao-samples", "4", "--out", out_npz]),
                              ("info", []))}
        results = {}
        try:
            outs = {cmd: proc.communicate(timeout=600) for cmd, proc in procs.items()}
        finally:
            for proc in procs.values():  # none outlives the phase
                proc.kill()
        for cmd, (stdout, stderr) in outs.items():
            proc = procs[cmd]
            if proc.returncode != 0:
                raise AssertionError(f"cli {cmd} failed:\n{stderr[-3000:]}")
            if cmd == "aov":
                data = np.load(out_npz)
                if data["depth"].shape != (256, 256) or data["ao"].shape != (256, 256):
                    raise AssertionError(f"cli aov wrote {data.files}")
                parsed = sorted(data.files)
            else:
                parsed = json.loads(stdout)
            if cmd == "info" and not (parsed["native_library"]
                                      and parsed["default_backend"] == "cuda"):
                raise AssertionError(f"cli info: {parsed}")
            results[cmd] = {"output": parsed if cmd != "stats" else {
                k: parsed[k] for k in ("primary_rays", "primary_hits", "primary_steps_mean",
                                       "shadow_hits", "packed_blocks")}}
        emit({"phase": "inspect_cli", "size": 256, "seconds_all_four": time.perf_counter() - t0,
              "commands": results})

    # ---- 19. the last parity gaps (phase parity) ---------------------------
    def parity(self):
        """The command line's flags that close the gaps to the JAX package's,
        in this process (its launches counted from 0 and logged), and
        bench_torch.py's single measurement as subprocesses."""
        t0 = time.perf_counter()
        self.parity_cli()
        self.parity_bench()
        self.parity_knobs()
        emit({"phase": "parity_seconds", "seconds": time.perf_counter() - t0})
        emit({"phase": "launches_by_path", "paths": {
            k: v for k, v in self.path_launches.items() if k.startswith("parity_")}})

    def cli_render(self, name, args):
        """`cli render ARGS --out build/chip_smoke_<name>.ppm` in this
        process, the launch counts set to 0 just before and read just after
        -> (its PPM, the counts)."""
        from ray_tracer_tpu_torch import cli
        from ray_tracer_tpu_torch.io.ppm import read_ppm

        out_ppm = os.path.join(self.root, "build", f"chip_smoke_{name}.ppm")
        os.makedirs(os.path.dirname(out_ppm), exist_ok=True)
        self.zero_counts()
        cli.main(["render", *args, "--out", out_ppm])
        torch.cuda.synchronize()
        counts = self.counts()
        self.path_launches[f"parity_{name}"] = counts
        return read_ppm(out_ppm), counts

    def parity_cli(self, size=1024):
        """(a) `render --scene gradcheck`: every launch of B held to the plain
        version, the PPM render()'s bytes; (b) `render --scene parallel
        --turbo --gi-samples 4 --gi-depth 2 --gi-no-specular`: the GI wave
        without its mirror mix, one call of F held bitwise to the plain
        version, the PPM render()'s bytes for gi_specular=False and not the
        specular render's; (c) `render --profile DIR`: the trace names
        kernel C's symbol."""
        import shutil

        from ray_tracer_tpu_torch.io.ppm import tonemap_u8
        from ray_tracer_tpu_torch.models.scenes import gradcheck_scene, parallel_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare, render

        width = ["--width", str(size)]
        with self.logging_launches() as log:
            ppm, counts = self.cli_render("gradcheck", ["--scene", "gradcheck", *width])
        if counts["traverse_grid"] <= 0:
            raise AssertionError(f"cli render --scene gradcheck launched {counts}")
        held = self.hold_logged("cli render --scene gradcheck", log)
        del log
        scene, cfg = gradcheck_scene(size, size, device=self.dev)
        if not (ppm == tonemap_u8(render(prepare(cfg, scene=scene)).cpu().numpy())).all():
            raise AssertionError("cli render --scene gradcheck differs from render()")
        emit({"phase": "parity_gradcheck", "size": size, "launches": counts, "held": held,
              "tolerance": "bitwise (records, rows tested)", "same_bytes_as_render": True})

        # the faithful parallel scene's light (intensity 1) renders black
        # in GI's radiometric units: the JAX command's --light-intensity
        gi = ["--scene", "parallel", *width, "--turbo", "--gi-samples", "4", "--gi-depth", "2",
              "--light-intensity", str(PARITY_GI_LIGHT)]
        lambert, counts = self.cli_render("gi_no_specular", gi + ["--gi-no-specular"])
        traces = {k: v for k, v in counts.items() if k not in ("empty_boxes", "grid_bin")}
        if traces["gi_wave"] != 1 or sum(traces.values()) != 1:
            raise AssertionError(f"the --gi-no-specular command launched {counts}: F once "
                                 "and no other trace (G and H build its grid) expected")
        specular, scounts = self.cli_render("gi_specular", gi)
        cfg = self.gi_config(parallel_scene_config, size, "parallel", 4, 2, gi_specular=False)
        cfg = dataclasses.replace(cfg, light=dataclasses.replace(
            cfg.light, intensity=float(PARITY_GI_LIGHT)))
        p = prepare(cfg)
        if not p.setup.gi_wave or p.setup.gi_spec:
            raise AssertionError("the --gi-no-specular config should take the GI wave "
                                 "without its mirror mix")
        if not (lambert == tonemap_u8(render(p).cpu().numpy())).all():
            raise AssertionError("cli render --gi-no-specular differs from render()")
        differ = float((lambert != specular).mean())
        if differ <= 0.0:
            raise AssertionError("--gi-no-specular renders the specular image")
        err, events, passes = self.gi_check("kernel F --gi-no-specular", p)
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        emit({"phase": "parity_gi_no_specular", "size": size, "S": 4, "D": 2,
              "light_intensity": PARITY_GI_LIGHT, "launches": counts,
              "specular_launches": scounts, "mirror_mix": False,
              "bytes_differing_from_specular": differ, "same_bytes_as_render": True,
              "kernel_F": {"events": events, "passes": passes, "max_abs_err": err,
                           "tolerance": "bitwise (radiance and every counter)"}})

        logdir = os.path.join(self.root, "build", "chip_smoke_profile")
        shutil.rmtree(logdir, ignore_errors=True)
        _, counts = self.cli_render("profile", ["--scene", "serial", *width, "--turbo",
                                                "--profile", logdir])
        (trace,) = os.listdir(logdir)
        with open(os.path.join(logdir, trace)) as fh:
            events = json.load(fh)["traceEvents"]
        symbol = "packed_march_kernel"
        named = sum(1 for e in events if symbol in str(e.get("name", "")))
        if counts["packed_march"] <= 0 or named <= 0:
            raise AssertionError(f"--profile: {named} events of {symbol}, launches {counts}")
        emit({"phase": "parity_profile", "size": size, "trace": trace,
              "trace_mb": os.path.getsize(os.path.join(logdir, trace)) / 1e6,
              "events": len(events), "events_of_" + symbol: named, "launches": counts})

    def parity_bench(self):
        """bench_torch.py's single measurement (spot 1024^2: the forward
        frame, GI S 4 D 2, the train step) and `cli bench --width 1024`, one
        subprocess after another: each prints one JSON line with bench.py's
        keys for its mode beside `device` and `card`, the forward lines a
        vs_baseline of their value over the oracle's Mrays/s, and each
        frame launched its kernel (the counts it writes to stderr)."""
        from ray_tracer_tpu_torch.tools.profiling import card_line

        card = card_line()
        runs = {
            "bench_single_spot_1024": ("forward", ["bench_torch.py", "--size", "1024",
                                                   "--scene", "spot"]),
            "cli_bench_width_1024": ("forward", ["-m", "ray_tracer_tpu_torch.cli", "bench",
                                                 "--width", "1024"]),
            "bench_single_gi_spot_1024_s4d2": ("gi", ["bench_torch.py", "--gi", "4",
                                                      "--gi-depth", "2"]),
            "bench_single_train_spot_1024": ("grad", ["bench_torch.py", "--grad"]),
        }
        kernel = {"forward": "packed_march", "gi": "gi_wave", "grad": "packed_march"}
        lines = {}
        for i, (name, (mode, argv)) in enumerate(runs.items()):
            # the first run starts CUDA in bench_torch's probe child, as a
            # user's call does; the others skip it (the card is up)
            env = dict(os.environ, **({"BENCH_PROBE_TIMEOUT": "0"} if i else {}))
            t0 = time.perf_counter()
            run = subprocess.run([sys.executable, *argv], cwd=self.root, capture_output=True,
                                 text=True, timeout=600, env=env)
            secs = time.perf_counter() - t0
            if run.returncode != 0:
                raise AssertionError(f"{name} failed:\n{run.stderr[-3000:]}")
            out = run.stdout.strip().splitlines()
            if len(out) != 1:
                raise AssertionError(f"{name}: {len(out)} lines on stdout, one expected")
            line = json.loads(out[0])
            want = BENCH_PY_KEYS[mode] | {"device", "card"}
            if set(line) != want:
                raise AssertionError(f"{name}: keys {sorted(line)} are not {sorted(want)}")
            if line["device"] != torch.cuda.get_device_name(0) or line["card"] != card:
                raise AssertionError(f"{name}: device {line['device']!r}, card {line['card']!r}")
            if not line["value"] > 0 or line["size"] != 1024:
                raise AssertionError(f"{name}: {line}")
            if mode == "forward":
                oracle = line["oracle_mrays_per_s"]
                if not oracle > 0:
                    raise AssertionError(f"{name}: no oracle baseline ({line})")
                if abs(line["vs_baseline"] - line["value"] / oracle) > 1e-4 * max(
                        1.0, line["vs_baseline"]):
                    raise AssertionError(f"{name}: vs_baseline is not value / oracle ({line})")
            elif line["vs_baseline"] != 0.0:
                raise AssertionError(f"{name}: vs_baseline {line['vs_baseline']}, 0 expected")
            logged = [x for x in run.stderr.splitlines() if x.startswith("launches: ")]
            launches = json.loads(logged[-1][len("launches: "):])
            if launches[kernel[mode]] <= 0:
                raise AssertionError(f"{name} launched {kernel[mode]} 0 times ({launches})")
            self.path_launches[f"parity_{name}"] = launches
            lines[name] = {"line": line, "seconds": secs, "launches": launches}
        emit({"phase": "parity_bench", "runs": lines})

    def parity_knobs(self):
        """bench.py's knob overrides on the card: each of KNOB_RUNS through
        bench_torch.single in this process (1024^2, 8 frames a chain,
        KNOB_ROUNDS chains).  Its first frame's launches of B, C, E and F
        are counted from 0 and logged, and each is held to its plain
        version; one line a run: the knobs the frame took, the best and
        median value and seconds a frame, the device's busy time and idle
        share over a ten-frame profile, the first frame's launches and the
        probes' picks.  The oracle is not run (the runs compare the port
        with itself; phase parity_bench's lines carry its baseline)."""
        import bench_torch
        from ray_tracer_tpu_torch.render import renderer
        from ray_tracer_tpu_torch.tools.profiling import card_line, profile_render

        card = card_line()
        real = {"render": renderer.render, "probed": bench_torch.probed,
                "timed_chains": bench_torch.timed_chains, "oracle": bench_torch.oracle_mrays}
        lines = {}
        t_all = time.perf_counter()
        for name, argv in KNOB_RUNS:
            seen = {}

            def first_logged(prep):
                """The first frame with its launches counted from 0 and logged;
                the later frames as they are."""
                if "img" in seen:
                    return real["render"](prep)
                self.zero_counts()
                with self.logging_launches() as log, self.logging_waves() as wlog:
                    img = real["render"](prep)
                    torch.cuda.synchronize()
                seen.update(counts=self.counts(), log=log, wlog=wlog, img=img)
                return img

            def probed(prep, fused="auto"):
                seen["prep"], seen["probes"] = real["probed"](prep, fused)
                return seen["prep"], seen["probes"]

            def timed_chains(*a, **kw):
                seen["chains"] = real["timed_chains"](*a, **kw)
                return seen["chains"]

            args = bench_torch.parse_args(["--size", "1024", *argv, "--rounds", str(KNOB_ROUNDS),
                                           "--probe-timeout", "0"])
            t0 = time.perf_counter()
            try:
                renderer.render = first_logged
                bench_torch.probed = probed
                bench_torch.timed_chains = timed_chains
                bench_torch.oracle_mrays = lambda size, scene="spot": 0.0
                line = bench_torch.single(args)
            finally:
                renderer.render = real["render"]
                bench_torch.probed = real["probed"]
                bench_torch.timed_chains = real["timed_chains"]
                bench_torch.oracle_mrays = real["oracle"]
            secs = time.perf_counter() - t0
            prep, counts = seen["prep"], seen["counts"]
            self.path_launches[f"parity_knobs_{name}"] = counts
            rc = prep.cfg.render
            if "whitted_wave_off" in name and counts["whitted_wave"]:
                raise AssertionError(f"{name}: the bounce loop launched E ({counts})")
            label = f"parity knobs {name}"
            held = self.hold_logged(label, seen["log"])
            held.update(self.hold_waves(label, seen["wlog"]))
            want = {k for k in ("traverse_grid", "packed_march", "whitted_wave", "gi_wave")
                    if counts[k]}
            if set(held) != want:
                raise AssertionError(f"{name}: held {sorted(held)}, launched {counts}")
            del seen["log"], seen["wlog"], seen["img"]
            chains = seen["chains"]
            best, med = min(chains), sorted(chains)[len(chains) // 2]
            prof = profile_render(prep, med, f"parity_knobs_{name}")
            # bench.py's count a frame: 2 rays a pixel, or GI's path and NEE
            # segments, 2 (depth + 1) a path
            rays = args.size ** 2 * 2 * (args.gi * (args.gi_depth + 1) if args.gi else 1)
            lines[name] = {
                "argv": argv, "metric": line["metric"], "unit": line["unit"],
                "value": rays / best / 1e6, "value_median": rays / med / 1e6,
                "seconds_per_frame": best, "seconds_per_frame_median": med,
                "secs_chains": chains,
                "knobs": {"inline": prep.packed.meta.inline, "fused_shadow": rc.fused_shadow,
                          "scheduler": rc.scheduler, "exact": rc.grid.exact_overlap,
                          "whitted_wave": rc.whitted_wave, "takes_whitted_wave": prep.setup.wave,
                          "gi_wave": rc.gi_wave, "takes_gi_wave": prep.setup.gi_wave,
                          "wave": rc.wave, "pump": rc.pump,
                          "block_tris": prep.packed.meta.block_tris,
                          "grid": list(prep.packed.meta.n_voxels)},
                "probes": seen["probes"], "first_frame_launches": counts, "held": held,
                "device_busy_ms": prof["device_busy_ms"],
                "device_idle_share": prof["device_idle_share"],
                "top_device_ms": prof["top_device_ms"], "seconds": secs}
            emit({"phase": "parity_knobs_run", "run": name, **lines[name]})
        emit({"phase": "parity_knobs", "card": card, "seconds": time.perf_counter() - t_all,
              "tolerance": "bitwise (B and C: records, counters; E and F: colors, counters)",
              "best_ms": {k: v["seconds_per_frame"] * 1e3 for k, v in lines.items()}})

    # ---- 16. multi-device (phase multidevice) ------------------------------
    def multidevice(self):
        """(a) the sharded queues of E and F in one process; (b) to (e) the
        ray-sharded paths on process groups of one rank (NCCL) and two ranks
        sharing the card (gloo); the command line's --devices 1; the work
        balance of four shards."""
        self.md_queues()
        groups = {}
        for world, backend in ((1, "nccl"), (2, "gloo")):
            groups[world] = self.md_group(world, backend)
        self.md_cli()
        self.md_balance()
        return groups

    def md_shard_queues(self, r: int, n: int, extra: int = 0):
        """The n shards' wave queues over r pixels, contiguous and round-robin
        (render_sharded's dealing; `extra` positions more a shard leave dead
        rows), with the permutation that composes them."""
        from ray_tracer_tpu_torch.parallel.shard import stride_permutation

        local = -(-r // n) + extra
        out = {}
        for layout in ("contiguous", "round_robin"):
            if layout == "round_robin":
                queues = [dict(pix_offset=s, pix_stride=n, queue_len=local) for s in range(n)]
                perm = stride_permutation(local * n, n)
            else:
                queues = [dict(pix_offset=s * local, pix_stride=1, queue_len=local)
                          for s in range(n)]
                perm = np.arange(local * n)
            out[layout] = (queues, torch.from_numpy(np.argsort(perm)).to(self.dev))
        return out

    def md_queues(self, n: int = 4):
        """(a) E on parallel_1024 and F on the GI row, each dealt to n shard
        queues, contiguous and round-robin: the shards' rows composed are the
        single launch's bits; each shard's events time beside the single
        launch's.  At 256x256, with one dead position a shard, every shard's
        launch against its plain version on the same queue: colors and
        counters bitwise."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import queue_rays
        from ray_tracer_tpu_torch.render.renderer import prepare

        kE, kF = self.kE, self.kF
        if self.wave_frame is None:
            cfg = apply_turbo(parallel_scene_config(1024, 1024), "parallel")
            self.wave_frame = (cfg, prepare(cfg))
        if self.gi_frame is None:
            self.gi_frame = prepare(self.gi_config(serial_scene_config, 1024, "serial", 4, 2))
        wcfg, wp = self.wave_frame
        wtail, wkw, _ = self.wave_inputs(wcfg, wp)
        gp = self.gi_frame
        gtail, gkw = kF.launch_inputs(gp)
        launchers = {
            "E": ("parallel_1024", lambda **q: self.wave_launch(wcfg, wp, wtail, wkw, **q),
                  wcfg.camera),
            "F": ("gi_spot_1024_s4d2", lambda **q: self.gi_launch(gp, gtail, gkw, **q),
                  gp.cfg.camera),
        }
        rows = []
        for kernel, (frame, launch, cam) in launchers.items():
            r = cam.width * cam.height
            whole = launch()
            whole_ms = cuda_ms(launch, 10)
            for layout, (queues, inv) in self.md_shard_queues(r, n).items():
                parts = [launch(**q) for q in queues]
                composed = torch.cat(parts)[inv][:r]
                torch.cuda.synchronize()
                compare(f"kernel {kernel} {frame}: {n} {layout} shards composed vs the single "
                        "launch", (composed.reshape(-1),), (whole.reshape(-1),))
                shard_ms = [cuda_ms(lambda q=q: launch(**q), 5) for q in queues]
                rows.append({"kernel": kernel, "frame": frame, "layout": layout, "shards": n,
                             "queue_len": queues[0]["queue_len"], "shard_ms": shard_ms,
                             "sum_ms": sum(shard_ms), "single_launch_ms": whole_ms,
                             "composed_equals_single": True})
        emit({"phase": "multidevice_queues", "rows": rows,
              "timing": "CUDA events, each shard 5 launches, the single launch 10"})
        # every shard's launch against its plain version, at 256x256
        size = 256
        wcfg2 = apply_turbo(parallel_scene_config(size, size), "parallel")
        wp2 = prepare(wcfg2)
        wtail2, wkw2, _ = self.wave_inputs(wcfg2, wp2)
        gp2 = prepare(self.gi_config(serial_scene_config, size, "serial", 4, 2))
        gtail2, gkw2 = kF.launch_inputs(gp2)
        held = []
        err = {"E": 0.0, "F": 0.0}
        for layout, (queues, _) in self.md_shard_queues(size * size, n, extra=1).items():
            for s, q in enumerate(queues):
                def rays_of(camera, q=q):
                    """The queue's rays from the CPU batch, whose bits the
                    kernels' own camera rays have."""
                    return RayBatch(*(x.to(self.dev) for x in queue_rays(
                        camera, q["pix_offset"], q["pix_stride"], q["queue_len"],
                        device="cpu")))

                rays = rays_of(wcfg2.camera)
                ck, cp = (self.wave_counters(wp2, q["queue_len"]) for _ in range(2))
                got = self.wave_launch(wcfg2, wp2, wtail2, wkw2, **q, **ck)
                want = kE.whitted_wave_plain(rays, *wtail2, **wkw2, **cp)
                torch.cuda.synchronize()
                label = f"kernel E 256 {layout} shard {s}"
                err["E"] = max(err["E"], compare(label, (got.reshape(-1),),
                                                 (want.reshape(-1),)))
                for key in ck:
                    if not torch.equal(ck[key], cp[key]):
                        raise AssertionError(f"{label}: counter {key} differs from the plain "
                                             "version's")
                gk, gq = self.gi_counters(), self.gi_counters()
                got = self.gi_launch(gp2, gtail2, gkw2, **q, **gk)
                want = kF.gi_wave_plain(rays_of(gp2.cfg.camera), *gtail2, **gkw2, **gq)
                torch.cuda.synchronize()
                label = f"kernel F 256 {layout} shard {s}"
                err["F"] = max(err["F"], compare(label, (got.reshape(-1),),
                                                 (want.reshape(-1),)))
                for key in gk:
                    if not torch.equal(gk[key], gq[key]):
                        raise AssertionError(f"{label}: counter {key} differs from the plain "
                                             f"version's: {gk[key].tolist()} vs "
                                             f"{gq[key].tolist()}")
                dead = int((q["pix_offset"] + torch.arange(q["queue_len"]) * q["pix_stride"]
                            >= size * size).sum())
                held.append({"layout": layout, "shard": s, **q, "dead_positions": dead})
        self.err["whitted_wave"] = max(self.err["whitted_wave"], err["E"])
        self.err["gi_wave"] = max(self.err["gi_wave"], err["F"])
        emit({"phase": "multidevice_queues_vs_plain", "size": size, "shards": held,
              "max_abs_err": err, "tolerance": "bitwise (colors or radiance, every counter)",
              "equal": True})

    def md_group(self, world: int, backend: str, work: str = "multidevice") -> dict:
        """Phase multidevice's (b) to (e), or with work="ring" phase ring's
        (b), on a process group of `world` ranks on this card: this process
        is rank 0 (its prepared frames reused), the others are
        `chip_smoke.py --rank-job` processes.  Every rank checks its own
        images, steps and buffers; rank 0's numbers are printed."""
        import tempfile

        import torch.distributed as dist

        from ray_tracer_tpu_torch.parallel import multihost

        os.makedirs(os.path.join(self.root, "build"), exist_ok=True)
        tmp = tempfile.mkdtemp(dir=os.path.join(self.root, "build"))
        init = f"file://{tmp}/rendezvous"
        outs = [os.path.join(tmp, f"rank{i}.json") for i in range(world)]
        logs = [os.path.join(tmp, f"rank{i}.log") for i in range(world)]
        procs = []
        for i in range(1, world):  # output to files: a full pipe would stall a rank
            with open(logs[i], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank-job", init, str(world),
                     backend, str(i), outs[i], work], cwd=self.root, stdout=log,
                    stderr=subprocess.STDOUT))
        ok = False
        try:
            multihost.initialize(init, world, 0, backend=backend, timeout=240)
            res = RANK_WORK[work](self, 0)
            ok = True
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            for proc in procs:
                try:
                    proc.wait(timeout=600 if ok else 5)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
        for i, proc in enumerate(procs, start=1):
            if proc.returncode != 0:
                with open(logs[i]) as fh:
                    tail = fh.read()[-3000:]
                raise AssertionError(f"rank {i} of the {backend} group failed:\n{tail}")
            with open(outs[i]) as fh:
                other = json.load(fh)
            if other["backend"] != res["backend"]:
                raise AssertionError(f"rank {i} ran on {other['backend']}")
        if work == "ring_build":
            return res
        note = (f"{world} ranks share one card: not a scaling number" if world > 1 else
                "one rank: the sharded path's own cost over render()")
        if work == "ring":
            for name, frame in res["frames"].items():
                self.path_launches[f"ring_{name}_w{world}"] = frame["launches_per_frame"]
            for key in ("frames", "hop", "fit", "queries"):
                emit({"phase": f"ring_{key}", "world": world, "backend": res["backend"],
                      "ranks_on": res["device"], "note": note, key: res[key]})
            emit({"phase": "launches_by_path", "paths": {
                k: v for k, v in self.path_launches.items()
                if k.startswith("ring_") and k.endswith(f"_w{world}")}})
            return res
        for name, frame in res["frames"].items():
            self.path_launches[f"sharded_{name}_w{world}"] = frame["launches_per_frame"]
        emit({"phase": "multidevice_frames", "world": world, "backend": res["backend"],
              "ranks_on": res["device"], "note": note, "frames": res["frames"]})
        emit({"phase": "multidevice_fit", "world": world, "backend": res["backend"],
              **res["fit"]})
        emit({"phase": "multidevice_aov", "world": world, "backend": res["backend"],
              **res["aov"]})
        emit({"phase": "multidevice_scaling", "world": world, "backend": res["backend"],
              "note": note, **res["scaling"]})
        emit({"phase": "launches_by_path", "paths": {
            k: v for k, v in self.path_launches.items() if k.endswith(f"_w{world}")}})
        return res

    def md_cli(self):
        """(d) `cli render --devices 1` (one NCCL rank started by the command)
        writes `cli render`'s PPM bytes."""
        outs = {}
        procs = {}
        for name, extra in (("single", []), ("devices_1", ["--devices", "1"])):
            outs[name] = os.path.join(self.root, "build", f"chip_smoke_cli_{name}.ppm")
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "serial",
                 "--width", "1024", "--turbo", *extra, "--out", outs[name]], cwd=self.root,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            done = {name: proc.communicate(timeout=600) for name, proc in procs.items()}
        finally:
            for proc in procs.values():
                proc.kill()
        for name, proc in procs.items():
            if proc.returncode != 0:
                raise AssertionError(f"cli render ({name}) failed:\n{done[name][1][-3000:]}")
        with open(outs["single"], "rb") as a, open(outs["devices_1"], "rb") as b:
            same = a.read() == b.read()
        if not same:
            raise AssertionError("cli render --devices 1 differs from cli render")
        emit({"phase": "multidevice_cli", "size": 1024, "same_bytes": True,
              "stderr": done["devices_1"][1].strip().splitlines()[-1]})

    def md_balance(self, n: int = 4):
        """(e) balance_report at n shards on spot_1024 and nefertiti_1024."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene, serial_scene_config
        from ray_tracer_tpu_torch.parallel.scaling import balance_report
        from ray_tracer_tpu_torch.render.renderer import prepare

        if self.nef_prep is None:
            scene, cfg = nefertiti_scene(1024, 1024, device=self.dev)
            self.nef_prep = prepare(apply_turbo(cfg, "nefertiti"), scene=scene)
        rows = {}
        for name, p in (("spot_1024", prepare(apply_turbo(serial_scene_config(1024, 1024),
                                                          "serial"))),
                        ("nefertiti_1024", self.nef_prep)):
            t0 = time.perf_counter()
            rows[name] = balance_report(p, n)
            rows[name]["seconds"] = time.perf_counter() - t0
        emit({"phase": "multidevice_balance", "reports": rows})

    # ---- 17. geometry sharded by ring orbits ---------------------------
    def ring(self):
        """(a) the dealing of a 4-card ring on nefertiti_1024 in one
        process; (b) the ring paths on process groups of one rank (NCCL) and
        two ranks sharing the card (gloo); (c) `cli render --ring --devices
        2` against (b)'s image."""
        self.ring_deal()
        groups = {}
        for world, backend in ((1, "nccl"), (2, "gloo")):
            groups[world] = self.md_group(world, backend, work="ring")
        if groups[1]["brute_sha256"] != groups[2]["brute_sha256"]:
            raise AssertionError("the all-pairs ring image differs between 1 and 2 ranks")
        emit({"phase": "ring_all_pairs", "size": RING_BRUTE_SIZE, "same_bits_at_worlds": [1, 2],
              "sha256": groups[1]["brute_sha256"]})
        self.ring_cli(groups[2]["spot_ppm"])

    def ring_deal(self, n: int = 4):
        """(a) nefertiti_1024's ring grids for n shards, each built by its
        own rank (`build_ring_shard` on a gloo group of n ranks sharing the
        card, what each rank of an n-card ring builds; their host seconds
        printed) and stacked here;
        kernel C on each shard's grid over the whole 1024^2 primary batch,
        the n results merged by the orbit's rule against the replicated
        march of the same rays (the ids that differ counted and held to
        RING_IDS_DIFFER of the rays), each launch's CUDA-event time beside
        the replicated launch's, and one shard's launch held bitwise to the
        plain version at its own inputs."""
        from ray_tracer_tpu_torch.accel.packed import PackedGridArrays
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.parallel.shard import RingGrids
        from ray_tracer_tpu_torch.render.renderer import prepare

        kC = self.kC
        if self.nef_prep is None:
            scene, cfg = nefertiti_scene(1024, 1024, device=self.dev)
            self.nef_prep = prepare(apply_turbo(cfg, "nefertiti"), scene=scene)
        p = self.nef_prep
        rcfg = p.cfg.render
        gate = rcfg.primary_gate()
        gate = 0.0 if gate is None else gate
        t0 = time.perf_counter()
        built = self.md_group(n, "gloo", work="ring_build")
        group_s = time.perf_counter() - t0
        parts = [torch.load(f, weights_only=True) for f in built["files"]]
        metas = {tuple(x["meta"]) for x in parts}
        if len(metas) != 1 or len({x["fp"] for x in parts}) != 1:
            raise AssertionError(f"the ranks' ring grids disagree on the shared meta: {metas}")
        meta = type(p.packed.meta)(*metas.pop())
        rg = RingGrids(PackedGridArrays(**{k: torch.cat([x["arrays"][k] for x in parts])
                                           for k in PackedGridArrays._fields}),
                       meta, parts[0]["fp"])
        st = rg.fp // n
        rays = camera_rays(p.cfg.camera, device=self.dev)
        consts = p.frame().consts

        def replicated():
            return kC.traverse_packed(rays, p.packed.arrays, p.packed.meta, t_gate=gate,
                                      consts=consts)

        self.zero_counts()
        want = replicated()
        best_t = torch.full((rays.count,), float("inf"), device=self.dev)
        best_id = torch.full((rays.count,), 2 ** 31 - 1, dtype=torch.int32, device=self.dev)
        launchers = []
        for d in range(n):
            garr, cd = rg.shard(d, self.dev)

            def launch(garr=garr, cd=cd):
                return kC.traverse_packed(rays, garr, rg.meta, t_gate=gate, consts=cd)

            res = launch()
            t = torch.where(res.hit, res.t, torch.full_like(res.t, float("inf")))
            tid = torch.where(res.hit, res.tri_id + d * st, torch.full_like(res.tri_id,
                                                                           2 ** 31 - 1))
            better = (t < best_t) | ((t == best_t) & (tid < best_id))
            best_t = torch.where(better, t, best_t)
            best_id = torch.where(better, tid, best_id)
            launchers.append((launch, garr, cd, int(res.hit.sum())))
        torch.cuda.synchronize()
        launches = self.counts()["packed_march"]
        shards = [{"shard": d, "hits": hits, "ms": cuda_ms(launch, 5)}
                  for d, (launch, _, _, hits) in enumerate(launchers)]
        for f in built["files"]:
            os.remove(f)
        _, garr, cd, _ = launchers[1]
        plain = kC.march_plain(rays, garr, rg.meta, t_gate=gate,
                               max_steps=kC._default_max_steps(rg.meta))
        got = kC.march_cuda(rays, garr, rg.meta, t_gate=gate, consts=cd)
        torch.cuda.synchronize()
        self.err["packed_march"] = max(self.err["packed_march"],
                                       compare("ring shard 1 vs plain", got, plain))
        hit = torch.isfinite(best_t)
        differ = int(((hit != want.hit) | (hit & (best_id != want.tri_id))).sum())
        if differ > RING_IDS_DIFFER * rays.count:
            raise AssertionError(f"ring dealing: {differ} of {rays.count} merged ids differ from "
                                 "the replicated march")
        emit({"phase": "ring_deal", "frame": "nefertiti_1024", "shards": n, "faces": rg.fp,
              "meta": {"n_voxels": list(rg.meta.n_voxels), "n_blocks": rg.meta.n_blocks,
                       "max_blocks": rg.meta.max_blocks, "probe_delta": rg.meta.probe_delta,
                       "replicated_n_blocks": p.packed.meta.n_blocks,
                       "replicated_inline": p.packed.meta.inline},
              "build_ring_shard_s": built["build_s"], "build_prepare_s": built["prepare_s"],
              "build_group_wall_s": group_s, "shard_launches": shards,
              "replicated_ms": cuda_ms(replicated, 5), "launches_c": launches,
              "rays": rays.count, "hits": int(hit.sum()), "ids_differ": differ,
              "shard_1_vs_plain": "bitwise",
              "timing": "CUDA events, 5 launches after a warm-up"})

    def ring_cli(self, want_ppm: str):
        """(c) `cli render --ring --devices 2` (two ranks the command starts
        on this card, which join over gloo as they outnumber the cards) at
        1024^2 writes the PPM bytes of the world-2 ring frame of
        spot_1024."""
        out = os.path.join(self.root, "build", "chip_smoke_cli_ring2.ppm")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tracer_tpu_torch.cli", "render", "--scene", "serial",
             "--width", "1024", "--turbo", "--devices", "2", "--ring", "--out", out], cwd=self.root, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli render --ring failed:\n{proc.stderr[-3000:]}")
        with open(out, "rb") as a, open(want_ppm, "rb") as b:
            if a.read() != b.read():
                raise AssertionError("cli render --ring --devices 2 differs from "
                                     "render_sharded_geometry's image")
        emit({"phase": "ring_cli", "size": 1024, "devices": 2, "backend": "gloo",
              "same_bytes": True, "seconds": secs,
              "stderr": proc.stderr.strip().splitlines()[-1]})

    def wave_pow_probe(self, cfg, prep, lanes):
        """The wave's plain version on the card over the differing pixels'
        CPU camera rays, twice: with torch.pow on the card, and with each
        pow's inputs taken to the CPU and torch.pow there.  Reports the pow
        inputs whose results differ and whether pow on the CPU alone gives
        the CPU's colors."""
        from ray_tracer_tpu_torch.core.rays import RayBatch
        from ray_tracer_tpu_torch.ops import shade

        kE = self.kE
        tail, kw, rays = self.wave_inputs(cfg, prep)
        sub = RayBatch(*(x[lanes] for x in rays))
        cpu_tail = tuple(x.cpu() if torch.is_tensor(x) else x for x in tail[:4]) + (
            type(tail[4])(*(x.cpu() for x in tail[4])), tail[5])
        want = kE.whitted_wave_plain(RayBatch(*(x.cpu() for x in sub)), *cpu_tail, **kw)
        seen = []

        def card_pow(base, e):
            pos = base > 0
            seen.append((base[pos], e[pos]))
            return shade._pow_safe(base, e)

        def host_pow(base, e):
            return shade._pow_safe(base.cpu(), e.cpu()).to(base.device)

        try:
            kE._pow_safe = card_pow
            on_card = kE.whitted_wave_plain(sub, *tail, **kw).cpu()
            kE._pow_safe = host_pow
            host = kE.whitted_wave_plain(sub, *tail, **kw).cpu()
        finally:
            kE._pow_safe = shade._pow_safe
        base = torch.cat([b for b, _ in seen])
        e = torch.cat([x for _, x in seen])
        p_card = torch.pow(base, e).cpu()
        p_cpu = torch.pow(base.cpu(), e.cpu())
        bad = (p_card.view(torch.int32) != p_cpu.view(torch.int32)).nonzero()[:, 0]
        examples = [{"base": float(base[i]), "exponent": float(e[i]), "card": float(p_card[i]),
                     "cpu": float(p_cpu[i])} for i in bad[:8].tolist()]
        return {"pixels": int(lanes.numel()), "pow_inputs": int(base.numel()),
                "pow_results_differing": int(bad.numel()), "examples": examples,
                "card_plain_equals_cpu": bool(torch.equal(on_card.view(torch.int32),
                                                          want.view(torch.int32))),
                "card_plain_with_cpu_pow_equals_cpu": bool(
                    torch.equal(host.view(torch.int32), want.view(torch.int32)))}

    # ---- 9. kernel D through the gather tool -----------------------------
    def kernel_d(self):
        kD = self.kD
        chk = kD.check(device=self.dev)
        self.err["gather_row_test"] = max(self.err["gather_row_test"], chk["max_abs_err"])
        emit(dict(chk, phase="kernel_D_vs_plain"))
        self.zero_counts()
        bench = kD.bench(device=self.dev)
        counts = self.counts()
        if counts["gather_row_test"] <= 0:
            raise AssertionError("the gather tool's step loop launched kernel D 0 times")
        self.launches["gather_row_test"] = counts["gather_row_test"]
        self.times["D_bench"] = bench
        emit(dict(bench, phase="gather_bench", launches=counts["gather_row_test"]))

    # ---- kernel times at the main path's shapes --------------------------
    def kernel_times(self):
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.persistent import persistent_trace
        from ray_tracer_tpu_torch.render.renderer import prepare, shadow_rays_for

        kA, kB, kC, kD = self.kA, self.kB, self.kC, self.kD
        dev = self.dev
        main_cfg = serial_scene_config(1024, 1024)
        p = prepare(main_cfg)
        grid, meta = p.grid.arrays, p.grid.meta
        v0, v1, v2 = p.scene.triangle_soa()
        n_tris = v0.shape[0]
        tri9_soa = kA.triangle_table(v0, v1, v2)
        tri9_rows = kB.vertex_table(v0, v1, v2)
        rays = camera_rays(main_cfg.camera, device=dev)
        r = rays.count
        eps = main_cfg.render.shadow_eps

        def shadow_of(cfg, t, hit):
            poi = torch.where(hit[:, None], rays.at(torch.where(hit, t, torch.zeros_like(t))),
                              torch.zeros_like(rays.orig))
            return shadow_rays_for(cfg.render, p.scene.light_pos, poi, hit)

        def bound(n_bytes, n_ops):
            """(bound ms, what bounds it): bytes at the HBM rate, operations
            at the unfused FP32 rate (every kernel builds with -fmad=false)."""
            tb, to = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32_UNFUSED
            return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")

        # Inputs are made once; each kernel's time is n back-to-back launches
        # over n, its device time the profiler's mean for the kernel alone.
        def launch_a():
            return kA.brute_intersect_cuda(rays.orig, rays.dirn, tri9_soa, 0.0)

        a_ms = cuda_ms(launch_a, 5)
        a_dev_ms = calls_device_ms(launch_a, 3, "brute_intersect_kernel")[0]
        a_out = launch_a()
        a_plain_ms, a_plain = once_ms(
            lambda: kA.brute_intersect_plain(rays.orig, rays.dirn, tri9_soa, 0.0))
        self.err["brute_intersect"] = max(self.err["brute_intersect"],
                                          compare("kernel A 1024 primary", a_out, a_plain))
        a_ops = r * n_tris * OPS_PER_PAIR_A
        a_bytes = r * (24 + 8) + n_tris * 36
        a_bound, a_by = bound(a_bytes, a_ops)

        # kernel B: the csr frame's primary launch over prepare's tables
        kw = dict(det_dtype=main_cfg.render.det_dtype, t_gate=main_cfg.render.primary_gate(),
                  early_exit=not main_cfg.render.faithful, tables=p.dda)

        def launch_b(**extra):
            return kB.traverse_grid_cuda(rays, grid, meta, tri9_rows, **kw, **extra)

        b_ms = cuda_ms(launch_b, 50)
        b_dev_ms = calls_device_ms(launch_b, 20, "traverse_grid_kernel")[0]
        tested = torch.zeros((r,), dtype=torch.int32, device=dev)
        b_passes = torch.zeros((1,), dtype=torch.int32, device=dev)
        b_out = launch_b(tested_out=tested, passes_out=b_passes)
        pkw_b = {k: v for k, v in kw.items() if k != "tables"}
        b_plain_ms, b_plain = once_ms(
            lambda: kB.traverse_grid_plain(rays, grid, meta, tri9_rows, **pkw_b))
        b_err = compare("kernel B 1024 primary", b_out, b_plain)
        # the frame's second launch of each kernel: the shadow rays of its hits
        fast = dataclasses.replace(main_cfg, render=dataclasses.replace(
            main_cfg.render, faithful=False))
        sa = shadow_of(fast, a_out[0], a_out[1] >= 0)
        a_shadow_ms = cuda_ms(lambda: kA.brute_intersect_cuda(sa.orig, sa.dirn, tri9_soa, eps), 5)
        sb = shadow_of(main_cfg, b_out.t, main_cfg.render.accepted_hit(b_out))

        def launch_b_shadow(**extra):
            return kB.traverse_grid_cuda(
                sb, grid, meta, tri9_rows, det_dtype=kw["det_dtype"], t_gate=eps,
                early_exit=kw["early_exit"], stop_on_first_hit=kw["early_exit"],
                tables=p.dda, **extra)

        b_shadow_ms = cuda_ms(launch_b_shadow, 50)
        b_shadow_dev_ms = calls_device_ms(launch_b_shadow, 20, "traverse_grid_kernel")[0]
        self.err["traverse_grid"] = max(self.err["traverse_grid"], b_err)
        n_tests = int(tested.sum())
        n_passes = int(b_passes.item())
        if not int(b_out.any_pass.sum()) <= n_passes <= n_tests:  # a passing ray passes once
            raise AssertionError(f"kernel B counted {n_passes} passes of {n_tests} tests")
        n_steps = int(b_out.steps.sum())
        # each input of the function read once, each output written once:
        # the rays (32 B) and five results (14 B), the CSR arrays and the
        # vertex table.  The kernel's own tables (mask, int2 pairs, vertices
        # in CSR order) are derived from those inputs and not counted: the
        # bound counts the same work whatever implements it.
        b_bytes = (r * (32 + 14) + (grid.cell_start.numel() + grid.tri_ids.numel()) * 4
                   + tri9_rows.numel() * 4)
        b_ops = (n_tests - n_passes) * OPS_PER_FAILED_TEST + n_passes * OPS_PER_PASSED_TEST
        b_bound, b_by = bound(b_bytes, b_ops)

        # kernel C: the turbo frame's one launch, the fused persistent march
        tcfg = apply_turbo(main_cfg, "serial")
        tp = prepare(tcfg)
        pgrid, pmeta = tp.packed.arrays, tp.packed.meta
        trc = tcfg.render
        ckw = dict(wave=trc.wave, fuse_shadow=True, t_gate=0.0, shadow_gate=trc.shadow_eps,
                   shadow_mint=trc.shadow_mint(), serial_quirk=True, shadow_skip_dead=True,
                   shade_serial=True, need_t=True, need_steps=True, need_shadow_tri=True)
        light = tp.scene.light_pos

        def launch_c():
            return persistent_trace(rays, pgrid, pmeta, light, **ckw)

        c_ms = cuda_ms(launch_c, 20)
        c_dev_ms = calls_device_ms(launch_c, 10, "packed_march")[0]
        pkw = dict(fused=True, t_gate=0.0, shadow_gate=trc.shadow_eps,
                   shadow_mint=trc.shadow_mint(), serial_quirk=True, skip_dead_shadow=True,
                   shade_serial=True)
        c_plain_ms, c_plain = once_ms(lambda: kC.march_plain(rays, pgrid, pmeta, light, **pkw))
        c_err = compare("kernel C 1024 turbo", launch_c(), c_plain)
        # the same march with its counters: rows tested and touched, passes
        c_tested = torch.zeros((r,), dtype=torch.int32, device=dev)
        touched = torch.zeros((pmeta.n_blocks,), dtype=torch.int32, device=dev)
        capped = torch.zeros((1,), dtype=torch.int32, device=dev)
        c_passes = torch.zeros((1,), dtype=torch.int32, device=dev)
        c_out = kC.march_cuda(rays, pgrid, pmeta, light, tested_out=c_tested,
                              touched_out=touched, capped_out=capped, passes_out=c_passes,
                              **pkw)
        c_err = max(c_err, compare("kernel C 1024 turbo counted", c_out, c_plain))
        if int(capped.item()):
            raise AssertionError(f"kernel C 1024: {int(capped)} rays capped")
        self.err["packed_march"] = max(self.err["packed_march"], c_err)
        rows_tested = int(c_tested.sum())
        full_rows = int(((touched & 2) != 0).sum())
        header_rows = int((touched == 1).sum())
        c_hits = int(c_out.hit.sum())
        c_shadow = int(c_out.in_shadow.sum())
        # rays in (32 B), six record fields out (18 B), each distinct row
        # tested once (row_lanes * 4 B), each header-only row's 8 B, and
        # one slot_tri entry per primary hit and per blocker
        c_bytes = (r * (32 + 18) + full_rows * pmeta.row_lanes * 4 + header_rows * 8
                   + (c_hits + c_shadow) * 4)
        slot_tests = rows_tested * pmeta.block_tris
        c_pass = int(c_passes.item())
        if not 0 <= c_pass <= slot_tests:
            raise AssertionError(f"kernel C counted {c_pass} passes of {slot_tests} tests")
        c_ops = (slot_tests - c_pass) * OPS_PER_FAILED_TEST + c_pass * OPS_PER_PASSED_TEST
        c_bound, c_by = bound(c_bytes, c_ops)

        # kernel D at the gather tool's shapes (W = 8192 lanes, NB = 2270 rows)
        blocks, o, d, idx0 = kD.make_inputs(device=dev)

        def launch_d():
            return kD.gather_row_test_cuda(blocks, o, d, idx0)

        d_ms = cuda_ms(launch_d, 200)
        d_dev_ms = calls_device_ms(launch_d, 50, "gather_row_test_kernel")[0]
        d_plain_ms, d_plain = once_ms(lambda: kD.gather_row_test_plain(blocks, o, d, idx0))
        self.err["gather_row_test"] = max(self.err["gather_row_test"],
                                          compare("kernel D", (launch_d(),), (d_plain,)))
        w, tl = idx0.shape[0], blocks.shape[2]
        d_rows = int(torch.unique(idx0).numel())
        d_bytes = d_rows * 9 * tl * 4 + w * (24 + 4) + w * 4
        d_ops = w * tl * OPS_PER_LANE_D
        d_bound, d_by = bound(d_bytes, d_ops)

        e = self.wave_times(bound)
        f = self.gi_times(bound)
        b64 = self.b64_times(p)
        k7 = self.k7_times(p)
        emit({"phase": "kernel_times_B_f64_rays", "rays": r, "cases": b64,
              "rates": {"fp32_unfused": PEAK_FP32_UNFUSED, "fp64_unfused": PEAK_FP64_UNFUSED,
                        "bytes": PEAK_BYTES}})
        emit({"phase": "times_K7", **k7})

        self.times.update(
            E=e, F=f,
            A=dict(ms=a_ms, plain_ms=a_plain_ms, bound_ms=a_bound, bound_by=a_by),
            B=dict(ms=b_ms, plain_ms=b_plain_ms, bound_ms=b_bound, bound_by=b_by),
            C=dict(ms=c_ms, plain_ms=c_plain_ms, bound_ms=c_bound, bound_by=c_by),
            D=dict(ms=d_ms, plain_ms=d_plain_ms, bound_ms=d_bound, bound_by=d_by),
            B64={k: b64["float32"][k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        )
        emit({"phase": "kernel_times", "rays": r, "triangles": n_tris,
              "A": {"ms": a_ms, "device_ms": a_dev_ms, "shadow_ms": a_shadow_ms,
                    "plain_ms": a_plain_ms, "ops": a_ops, "bytes": a_bytes, "bound_ms": a_bound,
                    "bound_fma_peak_ms": a_ops / PEAK_FP32_OPS * 1e3},
              "B": {"ms": b_ms, "device_ms": b_dev_ms, "shadow_ms": b_shadow_ms,
                    "shadow_device_ms": b_shadow_dev_ms,
                    "plain_ms": b_plain_ms, "previous_ms": PREVIOUS_MS["B"],
                    "mask_bytes": p.dda.occupancy.numel() * 4,
                    "ptxas": self.ptxas.get("traverse_grid"),
                    "steps": n_steps, "tested_triangles": n_tests, "passes": n_passes,
                    "occupied_cells": int((p.dda.cell_range[:, 1] > 0).sum()),
                    "cells": p.dda.cell_range.shape[0],
                    "bytes": b_bytes, "ops": b_ops, "bound_ms": b_bound, "bound_by": b_by,
                    "bound_bytes_ms": b_bytes / PEAK_BYTES * 1e3,
                    "bound_ops_ms": b_ops / PEAK_FP32_UNFUSED * 1e3},
              "C": {"ms": c_ms, "device_ms": c_dev_ms,
                    "plain_ms": c_plain_ms, "previous_ms": PREVIOUS_MS["C"],
                    "device_vs_previous": (c_dev_ms / PREVIOUS_MS["C"]["device_ms"]
                                           if c_dev_ms else None),
                    "ptxas": self.ptxas.get("packed_march"),
                    "steps": int(c_out.steps.sum()), "max_steps": int(c_out.steps.max()),
                    "rows_tested": rows_tested, "slot_tests": slot_tests, "passes": c_pass,
                    "distinct_rows_tested": full_rows,
                    "header_only_rows": header_rows, "table_rows": pmeta.n_blocks,
                    "hits": c_hits, "in_shadow": c_shadow, "bytes": c_bytes, "ops": c_ops,
                    "bound_ms": c_bound, "bound_by": c_by,
                    "bound_ops_ms": c_ops / PEAK_FP32_UNFUSED * 1e3,
                    "bound_bytes_ms": c_bytes / PEAK_BYTES * 1e3},
              "D": {"ms": d_ms, "device_ms": d_dev_ms, "plain_ms": d_plain_ms,
                    "lanes": w, "distinct_rows": d_rows, "bytes": d_bytes, "ops": d_ops,
                    "bound_ms": d_bound, "bound_ops_fma_peak_ms": d_ops / PEAK_FP32_OPS * 1e3,
                    "bound_bytes_ms": d_bytes / PEAK_BYTES * 1e3}})

    def b64_times(self, p) -> dict:
        """Kernel B's f64-ray instantiations at the 1024^2 csr frame's
        primary shape (float64 camera rays, float32 and float64 dets): events
        over n launches, the profiler's device time, the plain version once
        (held bitwise), and the bound: the bytes, the triangle tests at the
        determinants' unfused rate and the float64 DDA steps at the unfused
        FP64 rate, the largest of the three."""
        from ray_tracer_tpu_torch.ops.camera import camera_rays

        kB, dev = self.kB, self.dev
        rcfg = p.cfg.render
        grid, meta = p.grid.arrays, p.grid.meta
        tri9 = kB.vertex_table(*p.scene.triangle_soa())
        rays = camera_rays(p.cfg.camera, dtype=torch.float64, device=dev)
        r = rays.count
        out = {}
        for det in ("float32", "float64"):
            kw = dict(det_dtype=det, t_gate=rcfg.primary_gate(), early_exit=not rcfg.faithful)

            def launch(**extra):
                return kB.traverse_grid_cuda(rays, grid, meta, tri9, tables=p.dda, **kw, **extra)

            ms = cuda_ms(launch, 20)
            dev_ms = calls_device_ms(launch, 10, "traverse_grid_kernel")[0]
            tested = torch.zeros((r,), dtype=torch.int32, device=dev)
            passes = torch.zeros((1,), dtype=torch.int32, device=dev)
            got = launch(tested_out=tested, passes_out=passes)
            plain_ms, want = once_ms(lambda: kB.traverse_grid_plain(rays, grid, meta, tri9, **kw))
            self.err["traverse_grid_f64"] = max(self.err["traverse_grid_f64"], compare(
                f"kernel B f64 rays {det} 1024 primary", got, want))
            n_tests, n_passes = int(tested.sum()), int(passes.item())
            n_steps = int(got.steps.sum())
            test_ops = (n_tests - n_passes) * OPS_PER_FAILED_TEST + n_passes * OPS_PER_PASSED_TEST
            n_bytes = (r * (64 + 14) + (grid.cell_start.numel() + grid.tri_ids.numel()) * 4
                       + tri9.numel() * 4)
            parts = {"bytes": n_bytes / PEAK_BYTES * 1e3,
                     "operations": max(test_ops / (PEAK_FP64_UNFUSED if det == "float64"
                                                   else PEAK_FP32_UNFUSED),
                                       n_steps * OPS_PER_STEP_B_F64 / PEAK_FP64_UNFUSED) * 1e3}
            by = max(parts, key=parts.get)
            name = "traverse_grid_kernelId" + ("d" if det == "float64" else "f") + "EE"
            out[det] = {"ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
                        "bound_ms": parts[by], "bound_by": by, "bound_parts_ms": parts,
                        "tested_triangles": n_tests, "passes": n_passes, "steps": n_steps,
                        "hits": int(got.hit.sum()),
                        "ptxas": self.ptxas.get("traverse_grid", {}).get(name)}
        return out

    def k7_times(self, p) -> dict:
        """The all-pairs hit as six matrix products (ops/intersect.py
        mxu_intersect_all_pairs, the JAX package's K7; no render path calls
        it) on a tile of 16,384 of the 1024^2 serial frame's camera rays
        (the middle rows) against its 20,064 triangles: events over n calls,
        the six torch.matmul products alone, its topology against the Cramer
        all-pairs sweep (intersect_brute) on the same rays, and the bound
        (operations at the FMA peak: the products fuse)."""
        from ray_tracer_tpu_torch.ops.camera import camera_rays
        from ray_tracer_tpu_torch.ops.intersect import (_dual_basis, intersect_brute,
                                                        mxu_intersect_all_pairs)

        tile = 16384
        rays = camera_rays(p.cfg.camera, device=self.dev)
        lo = rays.count // 2 - tile // 2
        rb = rays.slice(lo, lo + tile)
        v0, v1, v2 = p.scene.triangle_soa()
        n_tris = v0.shape[0]
        eps = p.cfg.render.shadow_eps
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: mxu_intersect_all_pairs(rb, v0, v1, v2, t_lower=eps), 5)
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        got = mxu_intersect_all_pairs(rb, v0, v1, v2, t_lower=eps)
        n, b1, b2 = _dual_basis(v0, v1, v2, torch.float32)

        def products():
            return [torch.matmul(x, y.T) for x in (rb.dirn, rb.orig) for y in (n, b1, b2)]

        library_ms = cuda_ms(products, 5)
        cramer_ms, want = once_ms(lambda: intersect_brute(rb, v0, v1, v2, t_lower=eps))
        same = got.hit == want.hit
        both = got.hit & want.hit
        agree = float(same.float().mean())
        tri_agree = float((got.tri_id[both] == want.tri_id[both]).float().mean())
        if agree < 0.99 or tri_agree < 0.99:
            raise AssertionError(f"K7 against the Cramer sweep: hits agree on {agree:.4f}, "
                                 f"triangles on {tri_agree:.4f}")
        n_ops = tile * n_tris * OPS_PER_PAIR_K7
        n_bytes = tile * (24 + 13) + n_tris * 36
        tb, to = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_FP32_OPS * 1e3
        return {"rays": tile, "triangles": n_tris, "ms": ms, "library_ms": library_ms,
                "library": "six torch.matmul (R,3)x(3,T) products", "cramer_ms": cramer_ms,
                "peak_memory_gib": peak_gib, "hits": int(got.hit.sum()),
                "hit_agreement": agree, "triangle_agreement": tri_agree,
                "t_max_rel_err": float(((got.t[both] - want.t[both]).abs()
                                        / want.t[both].abs()).max()) if bool(both.any()) else 0.0,
                "bound_ms": max(tb, to), "bound_by": "bytes" if tb >= to else "operations",
                "launches_on_render_paths": 0}

    def wave_times(self, bound) -> dict:
        """Kernel E at the main path's shape, the turbo parallel 1024^2
        frame: events over n launches, the profiler's device time, the plain
        version once (held bitwise), and the bound from a counted launch
        whose six counters equal the plain version's."""
        from ray_tracer_tpu_torch.config import apply_turbo
        from ray_tracer_tpu_torch.models.scenes import parallel_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare

        kE = self.kE
        if self.wave_frame is None:
            cfg = apply_turbo(parallel_scene_config(1024, 1024), "parallel")
            self.wave_frame = (cfg, prepare(cfg))
        cfg, p = self.wave_frame
        tail, kw, rays = self.wave_inputs(cfg, p)
        r = rays.count

        def launch_e(**extra):
            return self.wave_launch(cfg, p, tail, kw, **extra)

        e_ms = cuda_ms(launch_e, 20)
        e_dev_ms = calls_device_ms(launch_e, 10, "whitted_wave_kernel")[0]
        e_plain_ms, e_plain = once_ms(lambda: kE.whitted_wave_plain(rays, *tail, **kw))
        err = compare("kernel E 1024 turbo parallel", (launch_e().reshape(-1),),
                      (e_plain.reshape(-1),))
        self.err["whitted_wave"] = max(self.err["whitted_wave"], err)
        lanes = torch.zeros((2,), dtype=torch.int64, device=self.dev)
        launch_e(lanes_out=lanes)
        warp_iters, lane_steps = lanes.tolist()
        emit({"phase": "lane_utilisation_before", "kernel": "E",
              "design": "one thread a queue position (recorded in PERF.md)",
              "lane_utilisation": PREVIOUS_E["lane_utilisation"],
              "device_ms": PREVIOUS_E["device_ms"]})
        emit({"phase": "lane_utilisation_after", "kernel": "E",
              "design": "persistent wave, half-warp refill", "warp_iterations": warp_iters,
              "active_lane_steps": lane_steps,
              "lane_utilisation": lane_steps / (32 * warp_iters), "device_ms": e_dev_ms})
        # E's counters on this frame against the plain version's, all six
        ck, cp = self.wave_counters(p, r), self.wave_counters(p, r)
        self.wave_launch(cfg, p, tail, kw, **ck)
        kE.whitted_wave_plain(rays, *tail, **kw, **cp)
        torch.cuda.synchronize()
        for key in ck:
            if not torch.equal(ck[key], cp[key]):
                raise AssertionError(f"kernel E 1024: counter {key} differs from the plain "
                                     "version's")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"kernel E 1024: {int(ck['capped_out'])} lanes capped")
        meta, grid = p.packed.meta, p.packed.arrays
        events = dict(zip(kE.EVENTS, ck["events_out"].tolist()))
        rows_tested = int(ck["tested_out"].sum())
        slot_tests = rows_tested * meta.block_tris
        passes = int(ck["passes_out"].item())
        if not 0 <= passes <= slot_tests:
            raise AssertionError(f"kernel E counted {passes} passes of {slot_tests} tests")
        touched = ck["touched_out"]
        full_rows = int(((touched & 2) != 0).sum())
        header_rows = int((touched == 1).sum())
        slots = ck["slots_out"].nonzero()[:, 0]
        tris = torch.unique(grid.slot_tri[slots])
        mats = torch.unique(p.scene.face_material[tris.long()])
        # the camera's launch values in (its subsample table) and colors out
        # (12 B), each distinct row tested once (row_lanes * 4 B), each
        # header-only row's 8 B, and the slot_tri entries, tri9 rows (40 B)
        # and mat9 rows (36 B) the vertices used
        e_bytes = (p.setup.cam.table.numel() * 4 + r * 12 + full_rows * meta.row_lanes * 4
                   + header_rows * 8 + slots.numel() * 4 + tris.numel() * 40
                   + mats.numel() * 36)
        e_ops = ((slot_tests - passes) * OPS_PER_FAILED_TEST + passes * OPS_PER_PASSED_TEST
                 + r * OPS_PER_CAMERA_RAY_E
                 + events["vertices"] * OPS_PER_VERTEX_E
                 + events["reflections"] * OPS_PER_REFLECTION_E)
        e_bound, e_by = bound(e_bytes, e_ops)
        segments = events["primaries"] + events["shadow_rays"] + events["mirror_rays"]
        emit({"phase": "kernel_times_E", "positions": r, "ms": e_ms, "device_ms": e_dev_ms,
              "previous": PREVIOUS_E, "plain_ms": e_plain_ms, "ptxas": self.ptxas.get("whitted_wave"),
              "events": events, "segments": segments,
              "segments_per_s_of_kernel": segments / ((e_dev_ms or e_ms) / 1e3),
              "rows_tested": rows_tested, "slot_tests": slot_tests, "passes": passes,
              "distinct_rows_tested": full_rows, "header_only_rows": header_rows,
              "slots_used": slots.numel(), "triangles_used": tris.numel(),
              "materials_used": mats.numel(), "bytes": e_bytes, "ops": e_ops,
              "bound_ms": e_bound, "bound_by": e_by,
              "bound_bytes_ms": e_bytes / PEAK_BYTES * 1e3,
              "bound_ops_ms": e_ops / PEAK_FP32_UNFUSED * 1e3, "max_abs_err": err,
              "counters_equal_plain": True})
        return dict(ms=e_ms, plain_ms=e_plain_ms, bound_ms=e_bound, bound_by=e_by)

    def gi_times(self, bound) -> dict:
        """Kernel F at the main path's shape, the official GI row (turbo
        serial 1024^2, S = 4, D = 2): events over n calls, the profiler's
        device time of a call (its three kernels and memset summed, and each
        beside the sum), the lane utilisation, the plain version once (held
        bitwise), and the bound from a counted call whose counters equal the
        plain version's."""
        from ray_tracer_tpu_torch.models.scenes import serial_scene_config
        from ray_tracer_tpu_torch.render.renderer import prepare

        kF = self.kF
        if self.gi_frame is None:
            self.gi_frame = prepare(self.gi_config(serial_scene_config, 1024, "serial", 4, 2))
        p = self.gi_frame
        tail, kw, rays = self.gi_inputs(p)
        r = rays.count

        def launch_f(**extra):
            return self.gi_launch(p, tail, kw, **extra)

        f_ms = cuda_ms(launch_f, 20)
        # F is several kernels and a memset: its device time is their sum
        f_dev_ms, by_name = calls_device_ms(launch_f, 10)
        f_by_kernel = {}
        for name, ms in by_name.items():
            short = re.search(r"gi_\w+_kernel|Memset", name)
            key = short.group(0) if short else name[:60]
            f_by_kernel[key] = f_by_kernel.get(key, 0.0) + ms
        lanes = torch.zeros((2, 3), dtype=torch.int64, device=self.dev)
        launch_f(lanes_out=lanes)
        ln = lanes.tolist()
        iters = ln[0][0] + ln[1][0]
        emit({"phase": "lane_utilisation_before", "kernel": "F",
              "design": "one thread a pixel serving all its samples, no queue (recorded in "
                        "PERF.md)", **PREVIOUS_F})
        emit({"phase": "lane_utilisation_after", "kernel": "F",
              "design": "stage P, a persistent refilled stage S of sample items, the fold",
              "lanes": {"stage_P": ln[0], "stage_S": ln[1],
                        "keys": ["warp_iterations", "active_lane_steps", "transition_steps"]},
              "lane_utilisation": (ln[0][1] + ln[1][1]) / (32 * iters),
              "lane_utilisation_by_stage": [x[1] / (32 * x[0]) if x[0] else None for x in ln],
              "transition_share": (ln[0][2] + ln[1][2]) / iters, "device_ms": f_dev_ms})
        cp, ck = self.gi_counters(), self.gi_counters()
        f_plain_ms, f_plain = once_ms(lambda: kF.gi_wave_plain(rays, *tail, **kw, **cp))
        err = compare("kernel F 1024 GI", (launch_f(**ck).reshape(-1),), (f_plain.reshape(-1),))
        torch.cuda.synchronize()
        for key in ck:
            if not torch.equal(ck[key], cp[key]):
                raise AssertionError(f"kernel F 1024: counter {key} differs from the plain "
                                     "version's")
        if int(ck["capped_out"].item()):
            raise AssertionError(f"kernel F 1024: {int(ck['capped_out'])} pixels capped")
        self.err["gi_wave"] = max(self.err["gi_wave"], err)
        meta, grid = p.packed.meta, p.packed.arrays
        events = dict(zip(kF.EVENTS, ck["events_out"].tolist()))
        passes = int(ck["passes_out"].item())
        slot_tests = events["slot_tests"]
        if not 0 <= passes <= slot_tests:
            raise AssertionError(f"kernel F counted {passes} passes of {slot_tests} tests")
        tri9, albedo, km = p.gi.tri9, p.gi.albedo, p.gi.km
        # every input read once and the radiance written once: the whole
        # grid tables (an upper bound of the rows the frame reads: F keeps
        # no per-row counter, and the bytes term does not bind), the
        # triangle rows, the material tables, the camera table
        f_bytes = (r * 12 + (grid.blocks.numel() + grid.slot_tri.numel()
                             + grid.cell_info.numel()) * 4 + tri9.numel() * 4
                   + albedo.numel() * 4 + (km.numel() * 4 if km is not None else 0)
                   + p.setup.cam.table.numel() * 4)
        f_ops = ((slot_tests - passes) * OPS_PER_FAILED_TEST + passes * OPS_PER_PASSED_TEST
                 + r * OPS_PER_PIXEL_F + r * kw["S"] * OPS_PER_SAMPLE_F
                 + events["vertices"] * OPS_PER_VERTEX_F
                 + events["bounce_segments"] * OPS_PER_BOUNCE_F
                 + events["escapes"] * OPS_PER_ESCAPE_F)
        f_bound, f_by = bound(f_bytes, f_ops)
        segments = events["primaries"] + events["bounce_segments"] + events["shadow_rays"]
        emit({"phase": "kernel_times_F", "pixels": r, "S": kw["S"], "D": kw["D"], "ms": f_ms,
              "device_ms": f_dev_ms, "device_ms_by_kernel": f_by_kernel,
              "plain_ms": f_plain_ms, "ptxas": self.ptxas.get("gi_wave"),
              "events": events, "passes": passes, "segments": segments,
              "segments_per_s_of_kernel": segments / ((f_dev_ms or f_ms) / 1e3),
              "bytes": f_bytes, "ops": f_ops, "bound_ms": f_bound, "bound_by": f_by,
              "bound_bytes_ms": f_bytes / PEAK_BYTES * 1e3,
              "bound_ops_ms": f_ops / PEAK_FP32_UNFUSED * 1e3, "library_ms": None,
              "max_abs_err": err, "counters_equal_plain": True})
        return dict(ms=f_ms, plain_ms=f_plain_ms, bound_ms=f_bound, bound_by=f_by)

    def kernels_line(self):
        rows = []
        for name, key, source, replaces in (
            ("brute_intersect", "A", "ray_tracer_tpu_torch/csrc/brute_intersect.cu",
             "ray_tracer_tpu/ops/pallas_intersect.py:114"),
            ("traverse_grid", "B", "ray_tracer_tpu_torch/csrc/traverse_grid.cu",
             "ray_tracer_tpu/ops/traverse.py:91"),
            ("traverse_grid_f64", "B64", "ray_tracer_tpu_torch/csrc/traverse_grid.cu",
             "ray_tracer_tpu/ops/traverse.py:91"),
            ("packed_march", "C", "ray_tracer_tpu_torch/csrc/packed_march.cu",
             "ray_tracer_tpu/ops/traverse_packed.py:152"),
            ("gather_row_test", "D", "ray_tracer_tpu_torch/csrc/gather_row_test.cu",
             "tools/pallas_gather_bench.py:98"),
            ("whitted_wave", "E", "ray_tracer_tpu_torch/csrc/whitted_wave.cu",
             "ray_tracer_tpu/ops/whitted_wave.py:79"),
            ("gi_wave", "F", "ray_tracer_tpu_torch/csrc/gi_wave.cu",
             "ray_tracer_tpu/ops/gi_wave.py:96"),
            ("empty_boxes", "G", "ray_tracer_tpu_torch/csrc/empty_boxes.cu",
             "ray_tracer_tpu/accel/native.py:151"),
            ("grid_bin", "H", "ray_tracer_tpu_torch/csrc/grid_bin.cu",
             "ray_tracer_tpu/accel/native.py:170"),
        ):
            t = self.times[key]
            rows.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                         "launches": self.launches[name], "max_abs_err": self.err[name],
                         "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "library_ms": None})
        emit({"kernels": rows})


def md_busy(fn, calls: int, profile: bool):
    """`calls` calls of fn() after one warm-up, in a torch.profiler window
    when `profile` (rank 0; the other ranks make the same calls, so that
    the collectives pair up) -> the device busy time and kernels of a
    call, or None."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiler

    fn()
    torch.cuda.synchronize()
    with (profiler(activities=[ProfilerActivity.CUDA]) if profile
          else contextlib.nullcontext()) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        if profile:
            time.sleep(0.05)  # let the tracer take the window's last records
    if not profile:
        return None
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy = sum(e.time_range.end - e.time_range.start for e in kernels) / calls / 1e3
    return {"device_busy_ms": busy, "kernels_per_frame": len(kernels) / calls}


def md_median_ms(fn, n: int = 5) -> list:
    """Host-clock times of n calls of fn(), each ended by a synchronise."""
    secs = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
    return secs


def md_rank_work(smoke, rank: int, size: int = 1024) -> dict:
    """A rank's share of phase multidevice on the current process group,
    every rank on the card: (b) render_sharded of spot_1024 (C), the csr
    serial frame (B), parallel_1024 (E) and the GI row (F), each image
    bitwise render()'s at both dealings, its kernel launched (the counts
    zeroed just before the sharded frame and read just after), the frame's
    wall time (median of 5) beside render()'s and rank 0's busy time; (c) 3
    sharded Adam steps (lr 1e-4) on spot_1024 with verts and the materials trainable,
    each against an unsharded step from the same parameters (loss rtol
    1e-6, gradients rtol 1e-4 with atol 1e-6 max|g|), the losses finite and
    falling, the parameters bitwise equal on every rank after every step;
    (d) render_aovs sharded against single-device, bitwise; (e)
    scaling_report over 1 to world ranks.  Raises on any failed hold."""
    import torch.distributed as dist

    from ray_tracer_tpu_torch.config import apply_turbo
    from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
    from ray_tracer_tpu_torch.opt import fit
    from ray_tracer_tpu_torch.parallel.collectives import all_gather
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_tpu_torch.parallel.scaling import scaling_report
    from ray_tracer_tpu_torch.parallel.shard import render_sharded
    from ray_tracer_tpu_torch.render.aov import render_aovs
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    dev = smoke.dev
    world = dist.get_world_size()
    mesh = make_mesh(devices=dev)
    serial = serial_scene_config(size, size)

    def bitwise(a, b) -> bool:
        if a.dtype.is_floating_point:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)

    def parallel_frame():
        if smoke.wave_frame is None:
            cfg = apply_turbo(parallel_scene_config(size, size), "parallel")
            smoke.wave_frame = (cfg, prepare(cfg))
        return smoke.wave_frame[1]

    def gi_frame():
        if smoke.gi_frame is None:
            smoke.gi_frame = prepare(smoke.gi_config(serial_scene_config, size, "serial", 4, 2))
        return smoke.gi_frame

    spot = prepare(apply_turbo(serial, "serial"))
    frames = {}
    for name, make, kernel in (
            ("spot_1024", lambda: spot, "packed_march"),
            ("csr_spot_1024", lambda: prepare(serial), "traverse_grid"),
            ("parallel_1024", parallel_frame, "whitted_wave"),
            ("gi_spot_1024_s4d2", gi_frame, "gi_wave")):
        p = make()
        single = render(p)
        torch.cuda.synchronize()
        smoke.zero_counts()
        img = render_sharded(p, mesh=mesh)
        torch.cuda.synchronize()
        counts = smoke.counts()
        if counts[kernel] <= 0:
            raise AssertionError(f"sharded {name} launched {kernel} 0 times: {counts}")
        contiguous = render_sharded(p, mesh=mesh, balance=False)
        for layout, got in (("round_robin", img), ("contiguous", contiguous)):
            if not bitwise(got, single):
                bad = int((got.view(torch.int32) != single.view(torch.int32)).sum())
                raise AssertionError(f"rank {rank}: sharded {name} ({layout}) differs from "
                                     f"render() in {bad} floats")
        sharded_ms = md_median_ms(lambda: render_sharded(p, mesh=mesh))
        single_ms = md_median_ms(lambda: render(p))
        frames[name] = {"kernel": kernel, "launches_per_frame": counts,
                        "equal_render_bitwise": True,
                        "sharded_median_ms": sorted(sharded_ms)[2], "sharded_ms": sharded_ms,
                        "render_median_ms": sorted(single_ms)[2],
                        "busy": md_busy(lambda: render_sharded(p, mesh=mesh), 5, rank == 0)}
    # (c) the data-parallel fit
    trainable = ("verts", "base_color", "kd", "ks", "ka")
    target = render(spot)
    p0 = fit.split_scene(spot.scene)
    scene = fit.merge_scene(p0._replace(kd=p0.kd * 1.5, base_color=p0.base_color * 0.6),
                            spot.scene)
    grid, meta, consts = spot.packed.arrays, spot.packed.meta, spot.frame().consts
    # lr 1e-4: the serial scene's vertex gradients are large (unnormalized
    # normals, a bright light), and Adam at 1e-2 throws its loss up
    s_step, s_init = fit.make_train_step(meta, spot.cfg, lr=1e-4, mesh=mesh,
                                         trainable=trainable)
    u_step, u_init = fit.make_train_step(meta, spot.cfg, lr=1e-4, trainable=trainable)
    params, opt = s_init(fit.split_scene(scene))
    steps, fit_counts = [], {}
    for k in range(3):
        up, uo = u_init(fit.detached(params))
        _, _, u_loss = u_step(up, uo, scene, grid, target, consts=consts)
        smoke.zero_counts()
        params, opt, s_loss = s_step(params, opt, scene, grid, target, consts=consts)
        torch.cuda.synchronize()
        for key, v in smoke.counts().items():
            fit_counts[key] = fit_counts.get(key, 0) + v
        rel = abs(float(s_loss) - float(u_loss)) / abs(float(u_loss))
        if not rel <= 1e-6:
            raise AssertionError(f"rank {rank}: step {k} loss {float(s_loss)!r} vs the "
                                 f"unsharded {float(u_loss)!r} (rel {rel:.3g})")
        worst = 0.0
        for f in trainable:
            gs, gu = getattr(params, f).grad, getattr(up, f).grad
            scale = float(gu.abs().max())
            excess = float(((gs - gu).abs() - 1e-4 * gu.abs()).max())
            worst = max(worst, excess / scale if scale else excess)
            if excess > 1e-6 * scale:
                raise AssertionError(f"rank {rank}: step {k} gradient of {f} off by {excess:.3g} "
                                     f"beyond rtol 1e-4 (max|g| {scale:.3g})")
            if not all(bitwise(x, getattr(params, f).detach())
                       for x in all_gather(getattr(params, f).detach())):
                raise AssertionError(f"rank {rank}: step {k}: {f} differs across ranks")
        steps.append({"loss": float(s_loss), "unsharded_loss": float(u_loss), "loss_rel": rel,
                      "grad_excess_over_max": worst})
    losses = [s["loss"] for s in steps]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"rank {rank}: sharded fit losses {losses}")
    if fit_counts["packed_march"] <= 0:
        raise AssertionError(f"the sharded fit launched no kernel C: {fit_counts}")
    fit_out = {"frame": "spot_1024", "trainable": list(trainable), "steps": steps,
               "launches": fit_counts, "params_equal_across_ranks": True,
               "tolerance": "loss rtol 1e-6; gradients rtol 1e-4, atol 1e-6 max|g|"}
    # (d) the AOV buffers
    mesh2 = make_mesh(world, ("rays", "tris"), shape=(world, 1), devices=dev)
    smoke.zero_counts()
    t0 = time.perf_counter()
    aovs = render_aovs(spot, mesh=mesh2)
    torch.cuda.synchronize()
    aov_ms = (time.perf_counter() - t0) * 1e3
    aov_counts = smoke.counts()
    want = render_aovs(spot)
    for key, v in want.items():
        if not bitwise(aovs[key], v):
            raise AssertionError(f"rank {rank}: sharded AOV {key} differs from one device's")
    if aov_counts["packed_march"] <= 0:
        raise AssertionError(f"sharded render_aovs launched no kernel C: {aov_counts}")
    aov_out = {"frame": "spot_1024", "buffers": sorted(want), "equal_bitwise": True,
               "ms": aov_ms, "launches": aov_counts}
    # (e) throughput over 1 to world ranks
    scaling = scaling_report(spot, device_counts=list(range(1, world + 1)), repeats=3)
    dist.barrier()  # no rank tears the group down under another
    return {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev),
            "frames": frames, "fit": fit_out, "aov": aov_out, "scaling": scaling}


def ring_rank_work(smoke, rank: int, size: int = 1024) -> dict:
    """A rank's share of phase ring on the current process group (one
    "tris" axis over every rank, the rays dealt over it), every rank on the
    card: render_sharded_geometry with grid hops on spot_1024, on
    parallel_1024 and on the GI row through the ring tracer (at 512x512 on
    more than one rank), each against render() (the GI row against the
    segment integrator on the same camera rays) on the pixels whose
    primary ids equal the replicated trace's, to the JAX ring tests'
    tolerances, the differing ids counted; every launch of kernel C on the
    spot frame held bitwise to the plain version; the all-pairs ring on
    the serial scene at 128x128; 3 ring train steps on spot_1024 (verts and
    materials), each against the unsharded step; render_aovs, render_ao
    and trace_pixel with ring orbits.  Raises on any failed hold."""
    import hashlib

    import torch.distributed as dist

    from ray_tracer_tpu_torch.config import apply_turbo
    from ray_tracer_tpu_torch.io.ppm import write_ppm
    from ray_tracer_tpu_torch.models.scenes import parallel_scene_config, serial_scene_config
    from ray_tracer_tpu_torch.opt import fit
    from ray_tracer_tpu_torch.ops.camera import camera_rays
    from ray_tracer_tpu_torch.parallel.collectives import all_gather, ring_pass
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_tpu_torch.parallel import shard
    from ray_tracer_tpu_torch.parallel.shard import build_ring_shard, render_sharded_geometry
    from ray_tracer_tpu_torch.render.aov import render_ao, render_aovs
    from ray_tracer_tpu_torch.render.debug import trace_pixel
    from ray_tracer_tpu_torch.render.pathtrace import pathtrace_rays
    from ray_tracer_tpu_torch.render.renderer import prepare, render

    dev = smoke.dev
    world = dist.get_world_size()
    mesh = make_mesh(world, ("tris",), shape=(world,), devices=dev)
    two = make_mesh(world, ("rays", "tris"), shape=(1, world), devices=dev)
    serial = serial_scene_config(size, size)

    def bitwise(a, b) -> bool:
        if a.dtype.is_floating_point:
            return torch.equal(a.view(torch.int32), b.view(torch.int32))
        return torch.equal(a, b)

    def orbit_chains(frame, prep):
        """frame() twice, every ring orbit recorded: as it runs, and with
        each orbit replaced by the replicated march of the same rays
        (`_grid_local_best` over prep's packed grid) -> (pixels whose
        orbits all agree, pixels whose primary ids agree), each (H*W,)
        bool.  A path orbit agrees by its winner's id, a shadow orbit by
        its hit flag (an any-hit id is any blocker's)."""
        h, w = prep.cfg.camera.height, prep.cfg.camera.width
        deal = shard._RingDeal(h * w, mesh, None, "tris")
        v0, v1, v2 = prep.scene.triangle_soa()
        fmat, f = prep.scene.face_material, prep.scene.num_faces
        full = shard._ring_extras(prep, prep.scene.faces, slice(None))
        ring_orbit = shard._Ring.orbit

        def replicated(ring, rb, t_gate, stop_first, with_any_pass=False):
            extras = (None,) * 3 if stop_first else tuple(
                x if use else None for x, use in zip(full, (ring.smooth, ring.textured,
                                                            ring.textured)))
            return rb, shard._grid_local_best(rb, 0, prep.packed.arrays, prep.packed.meta, v0,
                                              v1, v2, fmat, f, t_gate, stop_first,
                                              extras=extras, consts=prep.frame().consts)

        def run(orbit):
            log = []

            def recorded(ring, rb, t_gate, stop_first, with_any_pass=False):
                out = orbit(ring, rb, t_gate, stop_first, with_any_pass)
                hit = torch.isfinite(out[1]["t"])
                log.append(hit if stop_first else
                           torch.where(hit, out[1]["tid"], torch.full_like(out[1]["tid"], -1)))
                return out

            shard._Ring.orbit = recorded
            try:
                frame()
            finally:
                shard._Ring.orbit = ring_orbit
            return log

        got, want = run(ring_orbit), run(replicated)
        if len(got) != len(want):
            raise AssertionError(f"rank {rank}: {len(got)} ring orbits against {len(want)}")
        agree = torch.ones((deal.per,), dtype=torch.bool, device=dev)
        for g, r in zip(got, want):
            agree &= (g == r).reshape(-1, deal.per).all(dim=0)  # sample-major batches
        first = (got[0] == want[0]).reshape(-1, deal.per).all(dim=0)
        return deal.gather(agree), deal.gather(first)

    def hold_image(name, got, want, prep, frame, atol, rtol):
        """got within atol + rtol |want| on every pixel whose orbits all
        agree with the replicated march's (`orbit_chains`); the pixels
        whose orbits differ held to RING_IDS_DIFFER of the frame."""
        same, first = orbit_chains(frame, prep)
        g, w = got.reshape(-1, 3), want.reshape(-1, 3)
        out = ((g - w).abs() > atol + rtol * w.abs()).any(dim=1) & same
        n_out, n_differ = int(out.sum()), int((~same).sum())
        if not (torch.isfinite(got).all() and n_out == 0):
            raise AssertionError(f"rank {rank}: ring {name}: {n_out} of {int(same.sum())} "
                                 f"pixels whose orbits agree beyond atol {atol}, rtol {rtol}")
        if n_differ > RING_IDS_DIFFER * same.numel():
            raise AssertionError(f"rank {rank}: ring {name}: the orbits of {n_differ} of "
                                 f"{same.numel()} pixels differ from the replicated march's")
        return {"ids_differ": int((~first).sum()), "orbits_differ": n_differ,
                "pixels_beyond_tolerance": n_out,
                "max_abs_diff_equal_orbits": float((g - w).abs().max(dim=1).values[same].max()),
                "tolerance": f"atol {atol}, rtol {rtol}"}

    spot = prepare(apply_turbo(serial, "serial"))
    gi_size = size if world == 1 else size // 2
    frames, grids = {}, {}

    def parallel_frame():
        if world == 1 and smoke.wave_frame is not None:
            return smoke.wave_frame[1]
        return prepare(apply_turbo(parallel_scene_config(size, size), "parallel"))

    def gi_frame():
        if world == 1 and smoke.gi_frame is not None:
            return smoke.gi_frame
        return prepare(smoke.gi_config(serial_scene_config, gi_size, "serial", 4, 2))

    for name, make in (("spot_1024", lambda: spot), ("parallel_1024", parallel_frame),
                       (f"gi_spot_{gi_size}_s4d2", gi_frame)):
        p = make()
        t0 = time.perf_counter()
        grids[name] = build_ring_shard(p, mesh)
        build_s = time.perf_counter() - t0
        gi = p.cfg.render.gi_samples > 0
        if gi:
            # the ring tracer runs the segment integrator; so does the reference
            cam = camera_rays(p.cfg.camera, device=dev)
            single_fn = lambda p=p, cam=cam: pathtrace_rays(  # noqa: E731
                cam, p.scene, p.packed.arrays, p.packed.meta, p.cfg,
                consts=p.frame().consts).reshape(p.cfg.camera.height, p.cfg.camera.width, 3)
        else:
            single_fn = lambda p=p: render(p)  # noqa: E731
        with torch.no_grad():
            single = single_fn()
        torch.cuda.synchronize()

        def frame(p=p, name=name):
            return render_sharded_geometry(p, mesh=mesh, rays_axis=None, ring_grids=grids[name])

        frame()  # the shard's grid on the card, the kernels warm
        torch.cuda.synchronize()
        smoke.zero_counts()
        if name == "spot_1024":
            with smoke.logging_launches() as log:
                img = frame()
                torch.cuda.synchronize()
            counts = smoke.counts()
            held = smoke.hold_logged(f"rank {rank} ring spot_1024", log)
        else:
            img = frame()
            torch.cuda.synchronize()
            counts = smoke.counts()
            held = None
        if counts["packed_march"] <= 0:
            raise AssertionError(f"ring {name} launched no kernel C: {counts}")
        tol = (5e-3, 1e-3) if gi else (1e-4, 1e-5)
        agree = hold_image(name, img, single, p, frame, *tol)
        reps = 3 if world == 1 else 1
        ring_ms = md_median_ms(frame, reps)
        single_ms = md_median_ms(single_fn, 3)
        frames[name] = {"launches_per_frame": counts, "held": held,
                        "build_ring_shard_s": build_s, **agree,
                        "ring_ms": ring_ms, "ring_median_ms": sorted(ring_ms)[len(ring_ms) // 2],
                        "single_median_ms": sorted(single_ms)[1],
                        "single": "segment integrator" if gi else "render()",
                        "busy": md_busy(frame, 1, rank == 0)}
        if name == "spot_1024":
            spot_img = img
    # the bytes a hop moves: the spot frame's path orbit, measured alone
    per = -(-size * size // world)
    words = 20  # rays 8, t, id, material, three vertices 9
    side = [torch.zeros((per, 8), dtype=torch.float32, device=dev),
            torch.zeros((per, 3), dtype=torch.int32, device=dev)]
    diff = [torch.zeros((per, 9), dtype=torch.float32, device=dev)]
    hop_ms = md_median_ms(lambda: ring_pass(side, diff, mesh, "tris"), 5)
    hop = {"rays_a_rank": per, "bytes_a_ray": words * 4, "bytes_a_hop": per * words * 4,
           "hop_ms": hop_ms, "hop_median_ms": sorted(hop_ms)[2],
           "gb_per_s": per * words * 4 / (sorted(hop_ms)[2] * 1e-3) / 1e9}
    # the all-pairs ring at 128x128
    bcfg = serial_scene_config(RING_BRUTE_SIZE, RING_BRUTE_SIZE)
    bcfg = dataclasses.replace(bcfg, render=dataclasses.replace(bcfg.render, traversal="brute",
                                                                faithful=False))
    bp = prepare(bcfg)
    bimg = render_sharded_geometry(bp, mesh=mesh, rays_axis=None)
    bsingle = render(bp)
    bdiff = float((bimg - bsingle).abs().max())
    if not torch.allclose(bimg, bsingle, atol=1e-4, rtol=1e-5):
        raise AssertionError(f"rank {rank}: the all-pairs ring differs from render() by {bdiff}")
    brute_sha = hashlib.sha256(bimg.cpu().numpy().tobytes()).hexdigest()
    # 3 ring train steps on spot_1024
    trainable = ("verts", "base_color", "kd", "ks", "ka")
    target = render(spot)
    p0 = fit.split_scene(spot.scene)
    scene = fit.merge_scene(p0._replace(kd=p0.kd * 1.5, base_color=p0.base_color * 0.6),
                            spot.scene)
    sprep = spot._replace(scene=scene)
    s_step, s_init, ring_scene = fit.make_ring_train_step(sprep, mesh, rays_axis=None, lr=1e-4,
                                                          trainable=trainable,
                                                          ring_grids=grids["spot_1024"])
    u_step, u_init = fit.make_train_step(spot.packed.meta, spot.cfg, lr=1e-4,
                                         trainable=trainable)
    params, opt = s_init(fit.split_scene(scene))
    steps, fit_counts = [], {}
    for k in range(3):
        up, uo = u_init(fit.detached(params))
        _, _, u_loss = u_step(up, uo, scene, spot.packed.arrays, target,
                              consts=spot.frame().consts)
        smoke.zero_counts()
        ms, (params, opt, s_loss) = once_ms(lambda: s_step(params, opt, ring_scene, target))
        for key, v in smoke.counts().items():
            fit_counts[key] = fit_counts.get(key, 0) + v
        rel = abs(float(s_loss) - float(u_loss)) / abs(float(u_loss))
        if not rel <= 1e-6:
            raise AssertionError(f"rank {rank}: ring step {k} loss {float(s_loss)!r} vs the "
                                 f"unsharded {float(u_loss)!r} (rel {rel:.3g})")
        worst = 0.0
        for f in trainable:
            gs, gu = getattr(params, f).grad, getattr(up, f).grad
            scale = float(gu.abs().max())
            excess = float(((gs - gu).abs() - 1e-4 * gu.abs()).max())
            worst = max(worst, excess / scale if scale else excess)
            if excess > 1e-6 * scale:
                raise AssertionError(f"rank {rank}: ring step {k} gradient of {f} off by "
                                     f"{excess:.3g} beyond rtol 1e-4 (max|g| {scale:.3g})")
            if not all(bitwise(x, getattr(params, f).detach())
                       for x in all_gather(getattr(params, f).detach())):
                raise AssertionError(f"rank {rank}: ring step {k}: {f} differs across ranks")
        steps.append({"loss": float(s_loss), "unsharded_loss": float(u_loss), "loss_rel": rel,
                      "grad_excess_over_max": worst, "step_ms": ms})
    losses = [s["loss"] for s in steps]
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"rank {rank}: ring fit losses {losses}")
    if fit_counts["packed_march"] <= 0:
        raise AssertionError(f"the ring train step launched no kernel C: {fit_counts}")
    # the ring queries on spot_1024 over (1, world) ("rays", "tris")
    smoke.zero_counts()
    t0 = time.perf_counter()
    aovs = render_aovs(spot, mesh=two, ring=True, ring_grids=grids["spot_1024"])
    ao = render_ao(spot, samples=8, radius=1.0, mesh=two, ring=True,
                   ring_grids=grids["spot_1024"])
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3
    query_counts = smoke.counts()
    want = render_aovs(spot)
    for key, v in want.items():
        if v.dtype.is_floating_point:
            if not torch.allclose(aovs[key], v, rtol=1e-5, atol=1e-5, equal_nan=True):
                raise AssertionError(f"rank {rank}: ring AOV {key} differs from one device's")
        elif not torch.equal(aovs[key], v):
            n_bad = int((aovs[key] != v).sum())
            raise AssertionError(f"rank {rank}: ring AOV {key} differs in {n_bad} pixels")
    ao_diff = float((ao - render_ao(spot, samples=8, radius=1.0)).abs().max())
    pixels = []
    for x, y in ((512, 512), (300, 700), (5, 5)):
        rec = trace_pixel(spot, x, y, mesh=two, ring_grids=grids["spot_1024"])
        one = trace_pixel(spot, x, y)
        if rec["steps"] != -1 or rec["hit"] != one["hit"] or rec["tri_id"] != one["tri_id"]:
            raise AssertionError(f"rank {rank}: trace_pixel({x}, {y}) ring {rec} vs {one}")
        pixels.append({"pixel": [x, y], "hit": rec["hit"], "tri_id": rec["tri_id"],
                       "in_shadow": rec.get("in_shadow")})
    spot_ppm = None
    if rank == 0 and world == 2:
        spot_ppm = os.path.join(smoke.root, "build", "chip_smoke_ring2_spot.ppm")
        write_ppm(spot_ppm, spot_img.cpu().numpy())
    dist.barrier()  # no rank tears the group down under another
    return {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(dev),
            "frames": frames, "hop": hop, "brute_sha256": brute_sha,
            "brute_max_diff_vs_render": bdiff,
            "fit": {"frame": "spot_1024", "trainable": list(trainable), "steps": steps,
                    "launches": fit_counts, "params_equal_across_ranks": True,
                    "tolerance": "loss rtol 1e-6; gradients rtol 1e-4, atol 1e-6 max|g|"},
            "queries": {"frame": "spot_1024", "aov_buffers": sorted(want),
                        "ids_and_flags_equal": True, "floats": "rtol 1e-5, atol 1e-5",
                        "ao_samples": 8, "ao_max_diff": ao_diff, "ms": query_ms,
                        "launches": query_counts, "trace_pixel": pixels},
            "spot_ppm": spot_ppm}


def ring_build_rank_work(smoke, rank: int) -> dict:
    """A rank's share of phase ring's (a): its own ring grid of
    nefertiti_1024 on a "tris" axis over every rank (`build_ring_shard`),
    saved for rank 0 to stack; every rank's build seconds, and the
    seconds the others took to prepare the frame (rank 0 reuses its
    own)."""
    import torch.distributed as dist

    from ray_tracer_tpu_torch.accel.packed import PackedGridArrays
    from ray_tracer_tpu_torch.config import apply_turbo
    from ray_tracer_tpu_torch.models.scenes import nefertiti_scene
    from ray_tracer_tpu_torch.parallel.collectives import all_gather
    from ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from ray_tracer_tpu_torch.parallel.shard import build_ring_shard
    from ray_tracer_tpu_torch.render.renderer import prepare

    world = dist.get_world_size()
    t0 = time.perf_counter()
    p = smoke.nef_prep
    if p is None:
        scene, cfg = nefertiti_scene(1024, 1024, device=smoke.dev)
        p = prepare(apply_turbo(cfg, "nefertiti"), scene=scene)
    prepare_s = time.perf_counter() - t0
    mesh = make_mesh(world, ("tris",), shape=(world,), devices=smoke.dev)
    t0 = time.perf_counter()
    rg = build_ring_shard(p, mesh)
    build_s = time.perf_counter() - t0
    out = os.path.join(smoke.root, "build", f"chip_smoke_ring_shard{rank}.pt")
    torch.save({"arrays": {k: getattr(rg.arrays, k) for k in PackedGridArrays._fields},
                "meta": tuple(rg.meta), "fp": rg.fp}, out)
    secs = all_gather(torch.tensor([build_s, prepare_s], dtype=torch.float64))
    dist.barrier()  # every rank's file is written
    return {"rank": rank, "world": world, "backend": dist.get_backend(), "device": str(smoke.dev),
            "build_s": [float(x[0]) for x in secs],
            "prepare_s": [float(x[1]) for x in secs[1:]],
            "files": [os.path.join(smoke.root, "build", f"chip_smoke_ring_shard{i}.pt")
                      for i in range(world)]}


RANK_WORK = {"multidevice": md_rank_work, "ring": ring_rank_work,
             "ring_build": ring_build_rank_work}


def rank_job(argv) -> int:
    """`chip_smoke.py --rank-job INIT WORLD BACKEND RANK OUT WORK`: rank RANK
    (> 0) of phase multidevice's or ring's (WORK) group on this card;
    writes its results to OUT."""
    import torch.distributed as dist

    init, world, backend, rank, out, work = argv
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tracer_tpu_torch.parallel import multihost

    torch.cuda.set_device(0)
    multihost.initialize(init, int(world), int(rank), backend=backend, timeout=240)
    try:
        res = RANK_WORK[work](Smoke(), int(rank))
    finally:
        dist.destroy_process_group()
    with open(out, "w") as fh:
        json.dump(res, fh)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma list of " + ",".join(ALL_PHASES))
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ray_tracer_tpu_torch.tools.profiling import card_line

    card = card_line()
    emit({"phase": "device", "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "card": card,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})
    smoke = Smoke()
    t_start = time.perf_counter()
    steps = [("build", smoke.build)]
    if phases & {"A", "B"}:
        steps.append(("A,B", lambda: smoke.kernels_ab(phases)))
    steps += [(name, run) for name, run in (
        ("C", smoke.kernel_c), ("E", smoke.kernel_e), ("F", smoke.kernel_f),
        ("grid_build", smoke.grid_build), ("main", smoke.main_path), ("card_vs_cpu", smoke.card_vs_cpu),
        ("appearance", smoke.appearance), ("lights", smoke.lights),
        ("float64", smoke.float64), ("inspect", smoke.inspect), ("parity", smoke.parity),
        ("train", smoke.train),
        ("multidevice", smoke.multidevice), ("ring", smoke.ring), ("D", smoke.kernel_d),
        ("times", smoke.kernel_times)) if name in phases]
    seconds = {}
    for name, run in steps:
        t0 = time.perf_counter()
        run()
        seconds[name] = time.perf_counter() - t0
    emit({"phase": "elapsed", "seconds": time.perf_counter() - t_start,
          "by_phase": seconds})
    if phases >= set(ALL_PHASES):
        smoke.kernels_line()
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-job"]:
        sys.exit(rank_job(sys.argv[2:]))
    sys.exit(main())
