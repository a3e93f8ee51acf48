"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. device: requires a CUDA card, prints its name and power limit;
  2. build: compiles the hand-written kernels from ``orb_slam3_ros_tpu_torch/csrc``;
  3. kernel vs plain: the projection matcher kernel against its plain torch
     version on the card at the tracking shapes (768 map points x 1032
     features) at both radii of the lean schedule (60 and 4 px * 1.2^level),
     exact equality with planted ties, also across every boundary of the
     kernel's column splits; then their times: a call with its wrapper
     (median of 100), the kernel's device time (100 launches queued behind
     a spin kernel), the host's enqueue time, an empty launch's device time,
     the bound from the shapes, and the kernels one call queues, by the
     library's count of its own launches around that call (1 or 2 allowed);
  4. fusion kernel: the same at landmark fusion's shape and settings (4096
     map points x 1032 features, radius 3 * 1.2^level, max_dist 35, ratio
     1.0); then odd shapes (rows that do not fill a block, columns that do
     not fill a split, a group or even one group), all rows invalid, and
     both shapes back to back in turns without a sync, which a workspace
     left dirty would fail; each exact;
  5. slice: renders a 60-frame 752x480 sequence on the card, seeds a map
     from rendered depth at ground-truth keyframe poses, and tracks frames
     1..59 with ``MonoSlam`` in localization mode; requires no lost frame,
     metric ATE <= 0.01 m and that every tracking pass launched the kernel;
  6. card vs CPU: the first 5 frames of phase 5 again on the CPU, poses
     within 5 mm / 5 mrad of the card's;
  7. mapping: ``MonoSlam`` maps a 120-frame 752x480 sequence from frame 0
     (two-view initialization, keyframes, fusion, covisibility local BA,
     culling) at ``bench.py``'s configuration; requires initialization by
     frame 4, no frame lost after it, >= 12 keyframes, Sim(3) ATE <= 0.02 m,
     and kernel launches equal to the tracking passes plus 2 for each
     fusing keyframe (plus the keyframe program's capture warm-ups; the
     comparisons' launches, after the run, are printed apart); every
     keyframe after the initial pair runs the keyframe program
     (``kf_program``, none the eager ``keyframe_work``): the
     replays of its region graphs its id calls for, one synchronizing call
     (the packed read), the fuse graph 2 K1 launches a replay, and under
     deterministic algorithms a twin program's replays equal to the plain
     ``keyframe_work`` on copies of the first steady and the first fusing
     keyframe's inputs (``ProgramWatch``, compared after the run); prints
     the program's device and host ms a keyframe beside the plain
     function's. Phases 12 (a), 14 (a) and (b), 16 (d), 17, 18 (b), 19 (c)
     and (d) and 20 hold their mono keyframes the same way (a deferred
     one, the pipelined mode's, with no synchronizing call);
  8. mono-inertial: ``InertialSlam`` runs a 165-frame 752x480 sequence with
     100 Hz IMU samples from frame 0 at ``bench.py``'s ``main_vi``
     configuration (``utils/profile_keyframe.py`` holds it, for its ``--vi``
     profile too): IMU preintegration, the three initialization stages,
     the 15-dof refinement of every frame, the temporal-window VI-BA of
     every keyframe; once the IMU is initialized each frame one frame
     behind, as one replay of the VI frame program's CUDA graph (drained
     at the next call). Requires the IMU initialized and all three stages
     done, no bad-IMU reset, no frame lost after map initialization (one
     pose a frame, posted once each in order; None returned only at the
     first VI frame), state OK at the end, metric ATE (no scale alignment,
     first 12 poses skipped) <= 0.015 m, Umeyama scale within 1% of 1, the
     alignment's R[2,2] > 0.999 (gravity), the gyro bias within 3e-3 of
     the truth, every VI frame one replay of the VI frame graph, no
     synchronizing call in a steady VI dispatch, one replay equal to the
     eager program (integers exact, floats to 1e-4), every VI keyframe the
     replays of the VI keyframe program's region graphs its id calls for
     (``ProgramWatch``: one synchronizing call a keyframe, the packed read;
     the fuse graph 2 K1 launches a replay; under deterministic algorithms a
     twin program's replays equal to the plain ``_vi_kf_work`` on copies of
     the keyframe's inputs, integers exact, floats to 1e-4), and kernel
     launches equal to the visual frames' tracking passes plus the VI graph
     replays' passes (plus the captures' warm-ups) plus 2 for each fusing
     keyframe (plus the keyframe program's warm-ups; its comparisons run
     after the run).
     Prints frames/s and latency beside the eager VI frame's, the VI
     graph's device ms (CUDA events) and nodes, the share of drains
     whose copy had landed, and the keyframe program's device and host ms
     a keyframe beside the plain function's.
     Then (after phase 9, so that phase 9's device times are taken before
     the profiler is first used) times the inertial stages alone on inputs
     captured from the run (host ms and the CUDA-event span, and launches
     and device ms where the profiler traces the card), tree against
     sequential preintegration among them, and counts the synchronizing
     calls of a steady frame; each initialization solve is replayed once,
     the other stages three times, and only the refinement and the window
     VI-BA under the profiler (prints the replays' seconds);
  9. VI chunk loop: ``bench.py``'s ``main_vi`` protocol with the same
     configuration: per frame until ``_vi_chunkable()``, then
     ``InertialSlam.process_frames`` on chunks of 15 frames of a uint8 stack
     on the card (the CUDA graphs are captured in the chunks up to frame
     105), then the timed chunks to frame 165; it starts from a copy of
     phase 8's system at the frame where that run first passed the gate,
     whose prefix is ``main_vi``'s. Requires every chunk frame a
     replay of a step graph (no eager step on the card but the warm-up
     before each capture), K1 launches equal to 2 a frame plus 2 a fusing
     keyframe (plus the warm-ups'), no frame lost, no bad-IMU reset, phase
     8's accuracy limits, one replay of the step graph equal to the
     eager step on the same inputs (integers exact, floats to 1e-4), and no
     synchronizing call in the step or any keyframe segment run eagerly. Prints
     frames/s and latency per chunk and per frame beside phase 8's, the
     step and keyframe graphs' device ms (CUDA events around each replay),
     the busy share, the host's gap between a frame's flag read and the
     next launch, capture seconds, graphs and their nodes, peak memory, the
     synchronizing calls a chunk frame makes, and the card's SM clock,
     temperature and power draw during the timed chunks (nvidia-smi).
 10. mono chunk loop: ``bench.py``'s ``main`` protocol and configuration
     (phase 7's sequence, ``transfer_uint8``, the lean schedule ((40, 2, 4),
     (4, 2, 4))): per frame until ``_chunkable()``, then
     ``MonoSlam.process_frames`` on chunks of 15 of a uint8 stack on the
     card up to frame 45 (the CUDA graphs are captured there), then the
     timed chunks 45..120. Requires every timed frame a step-graph replay,
     K1 launches equal to 2 a frame plus 2 a fusing keyframe (plus the
     warm-ups'), no frame lost after initialization, >= 12 keyframes, Sim(3)
     ATE <= 0.02 m, one replay of the step graph equal to the eager step
     (integers exact, floats to 1e-4), the device-form local BA equal to
     the host-exit one on the BA segment's problem (to the bit, under
     torch's deterministic algorithms), and no
     synchronizing call in any region run eagerly. Prints frames/s beside
     phase 7's, the step and segment graphs' device ms, the busy share, the
     host gap, graphs and nodes, capture seconds and peak memory;
 11. relocalization, from copies of phase 10's system at frame 45 sharing
     its graphs: (a) the timestamps from frame 90 on 2 s later: frame 90
     goes LOST and must relocalize there, and tracking goes on to frame 120
     without another loss; (b) frames 60..62 black: the chunk hands its dead
     tail to the per-frame path, LOST, and the system must be OK again at
     frame 63, the first good frame, as the JAX package is on the CPU at
     240x376 (``scripts/reloc_blackout.py``), with no loss after it. Prints
     each attempt's host ms, candidates tried, PnP and tracking inliers, and
     the K1 launches of each relocalization;
 12. mono loop closing: (a) the closed loop of ``tests/test_loop_closing.py``
     at 752x480 (``make_sequence(trajectory="loop", seed=5)``, 90 frames,
     ``track_window`` 8, ``kf_every`` 3, ``min_gap`` 8, ``min_sim3_inliers``
     15, that test's 6144 points), per frame to the gate and then chunks of
     15, once without loop closing and once with it; requires a closure,
     Sim(3) ATE below the run without it and below 0.25 m, every started
     global BA folded in by ``flush``, 7 graphs captured, K1's "sim3"
     launches equal to the SearchBySim3 calls the closer counted, and K1
     exact against its plain version on one recorded SearchBySim3 input
     (then timed there: call, device time, bound); (b)
     ``scripts/bench_variants.py``'s ``lc`` protocol (orbit seed 3, 195
     frames, ``kf_every`` 5, warm to frame 105, timed chunks of 15 to 195):
     requires that every keyframe the timed chunks inserted reached the
     closer at its chunk boundary and every global BA folded in; prints
     frames/s, closures, global-BA dispatches (host ms and CUDA-event
     span each), each closure's host ms, the closer's check ms, syncs,
     the graphs' busy share and peak memory;
 13. mono-inertial loop closing, ``bench_variants.py``'s ``vi+lc``: phase
     8's calibration and settings with loop closing, 255 frames, the
     closer's covisibility exclusion off, per frame to the gate, chunks of
     15 to frame 150, timed chunks to 255; requires a closure, state OK
     with no bad-IMU reset, metric ATE (first 12 poses skipped) within
     phases 8 and 9's limit (its ratio to phase 9's printed), every
     inertial global BA folded in, and K1's "sim3" launches equal to the
     closer's count.
 14. the Atlas (``tests/torch_atlas_scenarios.py``'s scenarios, whose JAX run on
     the CPU gives the limits): (a) ``tests/test_atlas.py``'s blackout on
     phase 7's sequence (``kf_every`` 3, ``lost_patience`` 3: frames 0..29
     mapped, 8 blank frames inserted, back to the scene at frame 30; per
     frame to the chunk gate, then chunks of 15 to frame 105): requires one
     map archived at the blackout, the JAX runs' recovery route (a weld)
     at its first attempt, 21 frames (within 2) after tracking again as in
     the JAX runs (seeds 0..4), state OK with the archived map taken back,
     a finite
     trajectory, Sim(3) ATE after the return <= 0.02 m, and K1's "merge"
     launches equal to the Atlas's cross-map searches; (b) the end of (a)
     through ``save_atlas`` / ``load_atlas`` into a fresh system in state
     LOST, frames 101..119: relocalizes in the loaded map, keeps mapping,
     ATE <= 0.02 m, and a copy with one byte flipped raises; (c) the
     inertial weld at phase 8's configuration: map 1 IMU-initialized and
     archived, map 2 IMU-initialized, the weld rigid (scale 1) with its seam
     a chain break, poses and velocities finite, the welded map's metric
     keyframe ATE within 2x the JAX run's, state OK over 10 more frames;
     then the "merge" searches against the plain version (exact), timed.
 15. stereo and RGB-D (``tests/torch_stereo_scenarios.py``'s protocols, whose
     JAX run on the CPU gives the limits): (a) ``scripts/bench_variants.py``'s
     ``run_stereo`` (the KITTI shape: 1242x376 pairs, 2000 features in 2040
     slots, a 0.54 m baseline, ``transfer_uint8``, bench.py's lean
     schedule): per frame until ``_chunkable()``, chunks of 15 of a
     [N, 2, H, W] uint8 stack to frame 45, then the timed chunks to 120;
     requires initialization at frame 0, a pose for every frame, every
     timed frame a step-graph replay, K1 launches as predicted, graph =
     eager on one step, no synchronizing call in a region, the metric ATE
     within 2x the JAX run's and the Sim(3) scale within 2%; prints
     frames/s, the graphs' ms and nodes, the busy share and syncs; (b) K1 at
     P = 768, N = 2040 at both radii, exact with ties on its split
     boundaries, timed, and ``match_stereo`` on the first pair: its depth
     against the rendered depth (median error <= 5%, >= 80% within 15%),
     no synchronizing call, its call and device time and bound; (c)
     ``StereoInertialSlam`` at phase 8's configuration with a 0.11 m rig
     and 16384 point slots, per frame until ``_vi_chunkable()``, then
     chunks of 15: initialized at frame 0, IMU stage 3 with the scale
     fixed, 0 resets, a pose for every frame, metric ATE (first 12 poses
     skipped) within 2x the JAX run's and phase 9's 0.015 m, scale within
     1%; (d) ``RgbdSlam`` (60 frames) and
     ``RgbdInertialSlam`` (45 frames, phase 8's IMU) at 640x480 per frame:
     initialized at frame 0, a pose for every frame, metric ATE within 2x
     the JAX run's, scale within 2%. In (b) the stereo front-end program
     on the first pair, in (c) and (d) every per-frame frame's front end:
     one replay a frame, no synchronizing call, a replay equal to the eager
     front end; every VI keyframe of (c) and (d) as in phase 8. Prints its
     time, and each program's device ms beside its eager run's.
 16. the fisheye camera (``tests/torch_fisheye_scenarios.py``'s protocols,
     whose JAX run on the CPU gives the limits) at the TUM-VI shape
     (512x512 KB8, cam0 of Examples/Stereo-Inertial/TUM-VI.yaml, 1000
     features): (a) ``MonoSlam(cam_model="kb8")`` on raw fisheye frames of
     the orbit at 20 Hz with phase 10's protocol and settings: requires
     initialization, no frame lost after it, every timed frame a step-graph
     replay, K1 launches equal to 2 a timed frame plus 2 a fusing keyframe
     (plus the warm-ups'), graph = eager on one step, no synchronizing call
     in a region and the Sim(3) ATE within 2x the JAX run's; then K1 on the
     first posed KB8 frame (768 of (a)'s points projected through KB8 into
     its 1032 feature slots) against its plain version, exact, timed; (b)
     ``FisheyeStereoSlam`` on the non-rectified rig (0.101 m, the right
     camera yawed 2 degrees), 60 frames per frame: at most 8 frames without
     a pose and the metric ATE within 2x the JAX run's; prints the
     cross-camera depth error against the rendered depth and
     ``triangulate_cross_camera``'s call and device time; (c)
     ``FisheyeStereoInertialSlam(cam_model="pinhole")`` on phase 8's
     sequence with a 0.11 m rig, 45 frames: the IMU initialized with the
     scale fixed, the scale within 6%, the metric ATE within 2x the JAX
     run's; in (b) and (c) the rig's front-end program and in (c) the VI
     keyframe program held as in phase 15; (d) the rectified route (KB8 rendered at 768x768, one
     ``kb8_rect_map``, ``remap_bilinear`` on the card each frame, the pinhole
     ``MonoSlam``), 25 frames: the Sim(3) ATE within 2x the JAX run's;
     prints the remap's time a frame.
 17. the system surface: (a) the dataset-replay entry point
     (``run_synth.run`` with ``--native-feed --stream --verbose 1 --json``)
     at phase 7's configuration and the first 75 frames of its sequence
     (``SURF_FRAMES``, cut for time), per frame, fed by the C++
     measurement sync (``native.py``, built from ``native/measurement_sync
     .cpp`` with g++ in this run) from a producer thread, the JSONL event
     stream and the stage timer live, ``points_every`` 1: requires
     initialization by frame 4, a pose for every frame after it, Sim(3) ATE
     <= 0.02 m, one frame event a tracked frame, one keyframe event a
     keyframe, the point events at their cadence, K1 launches equal to the
     tracking passes plus 2 for each fusing keyframe, and K1 exact against
     its plain version on the run's first tracking and fusion searches;
     prints frames/s (the whole run's and the steady rate phase 7 reports),
     ``print_time_stats()`` and the producer's push waits; (b) the same run
     with the control socket (``--control``) and clients in a second
     process: status, save_traj, save_map (loaded back into a fresh
     system), localization mode on and off, a subscriber that receives the
     frame events and one that never reads; requires every reply, the
     reader kept and the other dropped once its socket buffer and its
     queue filled, K1's launches as in (a), and the median frame rate
     within 10% of (a)'s: (b) runs twice, each between two runs of (a)
     (a b a b a, all under the same instrumentation, ``SurfaceCounters``),
     each run's rate divided by the host's speed over its frames (the rate
     of a fixed pure-Python loop in a second process, ``host_probe``), and
     the mean of the two (b)s' ratios to the (a)s around them is held to
     0.9; (c) the problem dump of phase 12 (a)'s
     closed loop (``dump_from_map`` and ``save_optimization_data`` on its
     final map and loop edge) re-solved by ``reoptimize`` on the card: the
     cost falls and the poses are within 1e-4 of the same call on the CPU;
     (d) ``detect_plane`` on (a)'s map finds a plane (ok: >= 15% inliers)
     and ``ARDemo.render`` draws the cube.
 18. scale-out and the two-device split: (a) the sharded Schur-LM BA (2
     iterations), PCG BA (2 iterations, 20 CG steps), VI-BA (24 keyframes,
     512 points, 4 iterations) and 7-dof PGO (64 keyframes, 256 edges, 6
     iterations; ``scale_out.ITERS``) of ``parallel/dist_ba.py`` at the
     global-BA shape (K=64, P=8192, E=65536, ``parallel/problems.py``), at
     world 1 in this process over NCCL (one rank, so no collective runs),
     at world 2 as two ``parallel/scale_out.py`` processes on this
     card over gloo with CUDA tensors and, with two cards, over NCCL; each
     held to the same solve without a communicator on the card at
     ``tests/test_dist_ba.py``'s tolerances (> 60000 inliers at this shape);
     prints ms per iteration by CUDA events, the bytes summed per iteration
     and the peak memory of each rank; (b) ``MonoSlam(devices=("cuda:0",
     "cuda:0"))`` (two cards: "cuda:0", "cuda:1") on phase 7's sequence and
     configuration per frame: requires initialization by phase 7's frame, no
     frame lost, Sim(3) ATE <= 0.02 m and within 2x phase 7's, the canonical
     map on the map device and the replica on the track device in storage of
     its own, one replica refresh a keyframe, no frame more than one
     keyframe behind, K1 launches equal to the tracking passes plus 2 for
     each fusing keyframe and K1 exact on the first tracking and fusion
     searches; prints frames/s beside phase 7's and the microseconds and
     bytes of a refresh; (c) ``InertialSlam`` split on the first 45 frames
     of phase 8's sequence per frame: the map initialized by frame 20 (phase
     8's bound), the IMU initialized no later than in the same run on one
     device (its sixth keyframe, frame ~32) and the metric ATE within 2x
     that run's (cut for time: 45 frames, 60 until phase 20 came).
 19. the KB8 camera's inertial, loop-closing and Atlas paths at the TUM-VI
     shape (512x512, cam0's intrinsics, 1000 features a view; the views
     rendered KB8 by ``synth.render(cam_model="kb8")``): (a)
     ``InertialSlam(cam_model="kb8")`` through phase 9's protocol on phase
     8's trajectory, IMU and room (so phase 9 and (a) differ only in the
     camera): requires the chunk gate passed by frame 75 (all three IMU
     stages, as phase 9 needs), the map by frame 20, no frame lost, no
     bad-IMU reset, metric ATE (first 12 poses skipped) <= 0.015 m, scale
     within 1%, K1 launches over the timed chunks equal to 2 a timed frame
     plus 2 a fusing keyframe (plus any warm-up), one step-graph replay
     equal to the eager step and no synchronizing call in a region; prints
     the step graph's ms and nodes beside phase 9's; (b)
     ``FisheyeStereoInertialSlam()`` at its KB8 default on phase 16 (b)'s
     rig, both views of phase 8's first 30 frames rendered KB8, per frame:
     the IMU initialized with the scale fixed, the scale within 6%, metric
     ATE <= 0.015 m (printed beside phase 16 (c)'s pinhole run), its front
     ends and VI keyframes held as in phase 16 (c); (c)
     ``MonoSlam(cam_model="kb8", enable_loop_closing=True)`` on phase 12
     (a)'s loop (seed 5, 90 frames, 6144 points) through the KB8 camera,
     once without loop closing: requires a closure, K1's "sim3" launches
     equal to the closer's SearchBySim3 calls, the Sim(3) ATE within 1.1x
     the run without loop closing (which barely drifts through this
     camera: ``KB8_LOOP_OPEN_RATIO``) and <= 0.02 m, and K1 exact against its plain
     version on the first KB8 SearchBySim3 input (timed); prints each
     closure's and PGO's ms; (d) ``MonoSlam(cam_model="kb8",
     enable_atlas=True)`` on phase 14 (a)'s blackout of phase 7's
     trajectory through the KB8 camera: the map archived at the blackout,
     the archived map back by a weld or a switch, state OK, the Sim(3) ATE
     after the return <= 0.02 m, K1's "merge" launches equal to the Atlas's
     cross-map searches and, where a merge search ran, K1 exact against its
     plain version on it (timed). Cut for time: (b) runs 30 of phase 16
     (c)'s 45 frames (``KB8_RIG_FRAMES``); no width is cut.
 20. the pipelined per-frame mode: ``MonoSlam`` at its default
     (``pipelined=True``) on phase 7's sequence and configuration, per
     frame: each OK frame dispatched as one replay of the speculative frame
     program's CUDA graph (predicted on the card from frames i-1 and i-2),
     frame i-1 drained after it, each keyframe's work queued with no host
     read and absorbed later. Requires initialization at phase 7's frame, a
     pose for every frame after it, call i returning frame i-1's
     trajectory entry and ``flush`` the last frame's, Sim(3) ATE <= 0.02 m
     and within 2x phase 7's, every OK frame one replay of the frame graph,
     one replay equal to the eager frame program (integers exact, floats
     to 1e-4), K1 launches equal to the frames' tracking passes (plus the
     captures' warm-ups) and 2 a fusing keyframe, and no synchronizing call
     in any frame's dispatch (but a capturing one) or keyframe's queued
     work. Prints frames/s beside phase 7's and phase 10's, host ms a call,
     the frame graph's device ms (CUDA events) and nodes, the share of
     drains whose copy had landed, capture seconds and peak memory, beside
     the card's name and power limit.
 21. the pipelined mono-inertial system: ``InertialSlam(pipelined=True)``
     on phase 8's configuration and the first 120 of its 165 frames
     (``VI_PIPE_FRAMES``, cut for time), per frame: the
     visual frames through the mono frame graph with their keyframe work
     deferred, the handoff (the visual frame in flight when the IMU
     initializes runs again through the VI frame graph and is posted
     first), then the VI frames one frame behind. Requires phase 8's
     accuracy limits, the IMU's three stages, one pose a frame posted once
     each in order, None returned only at the visual frames' lag and the
     first VI frame, every dispatch one graph replay with no synchronizing
     call (but a capturing one), K1 launches equal to the replays' tracking
     passes (plus warm-ups) and 2 a fusing keyframe, every VI keyframe held
     as in phase 8, and K1 exact against its plain version on the run's
     first tracking search of a frame with features.
Prints one JSON line of kernel results, then as its last line
``{"ok": true, "device": {...}}``. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from types import SimpleNamespace

import numpy as np

H, W, N_FEATURES, N_FRAMES, KF_EVERY = 480, 752, 1000, 60, 6
P_TRACK = 768
P_FUSE = 4096  # landmark fusion searches the whole point table
N_SLOTS = 1032  # feature slots of 1000 features over 8 levels
WARM = 5
SPIN_CYCLES = 50_000_000  # ~25 ms of spin kernel: longer than queueing 100 calls takes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT8_OPS_PER_S = 1979e12
FUSE_KW = dict(max_dist=35, ratio=1.0)
ATE_LIMIT = 0.01
MAP_FRAMES, MAP_INIT_BY, MAP_MIN_KF, MAP_ATE_LIMIT = 120, 4, 12, 0.02
VI_SKIP, VI_MIN_STEADY, VI_MIN_KF, VI_INIT_BY = 12, 30, 14, 20
# The JAX package's test bounds are 0.05 m (0.10 at 240x376), 5%, 0.98 and
# 1.5e-2; the first card run measured 0.0028 m, 0.014%, 1.00000 and 2.8e-4,
# so each was tightened to about 5-10x what was measured.
VI_ATE_LIMIT, VI_SCALE_TOL, VI_MIN_R22, VI_BG_TOL = 0.015, 0.01, 0.999, 3e-3
CHUNK, CHUNK_WARM = 15, 105  # bench.py main_vi: chunks of 15, timed from frame 105 on
MONO_WARM = 45  # bench.py main: chunks of 15, timed from frame 45 on
BENCH_LEAN = ((40.0, 2, 4), (4.0, 2, 4))  # bench.py main's lean schedule
JUMP_AT, JUMP_S, DARK = 90, 2.0, (60, 63)  # phase 11's timestamp jump and blackout
# Frames after the blackout's first good frame that the JAX package needs
# to relocalize at bench.py's protocol (scripts/reloc_blackout.py, CPU,
# 240x376): it relocalizes at that frame.
RELOC_AFTER_DARK = 0
GRAPH_TOL = 1e-4  # graph replay vs eager step, float fields (abs, and rel to max(1, |x|))
# A VI keyframe's landmark fields, printed apart from its keyframes' fields
POINT_FIELDS = ("pt_X", "pt_normal", "pt_min_dist", "pt_max_dist")
# Phase 12 (a): the closed loop of tests/test_loop_closing.py at full width,
# with that test's point capacity: at 4096 points the JAX package's map
# fills before the revisit at 752x480, tracking is lost at frame 74 and no
# loop closes (on the CPU; with 6144 it closes keyframe 29 on keyframe 0).
# (b) bench_variants.py's lc protocol (frames, timed from); phase 13 its vi+lc.
LOOP_FRAMES, LOOP_ATE_LIMIT, LOOP_MAX_POINTS = 90, 0.25, 6144
LC_FRAMES, VI_LC_FRAMES = (195, 105), (255, 150)
# Phase 14, tests/torch_atlas_scenarios.py's protocol: (a) frames mapped before
# the blackout, blank frames, the last frame of (a), the first of (b); (c)
# map 1's frames, the frames after the weld, the last frame map 2 may take
# to initialize its IMU. The JAX package's runs of it (CPU, 752x480): (a)
# with the systems' seeds 0..4 the archived map came back by a weld at a
# chunk boundary at frames 80, 59, 72, 72, 84, each 21 frames after the
# new map's initialization (frames 59, 38, 51, 51, 63: which RANSAC draw
# initializes is luck), at the first weld attempt, Sim(3) ATE after the
# return 0.00327-0.00734 m; seed 0: (b) relocalized at frame 101, ATE
# 0.00261 m; (c) the welded map's metric keyframe ATE 0.01601 m. The card
# is held to the route and to the weld at the first attempt, 21 frames
# (within 2) after tracking again. Whether an attempt holds is a RANSAC
# draw on a young map: on the port's session saved on the card just
# before its first attempt, the weld held for 20 of 20 RANSAC keys in the
# JAX package and 20 of 20 seeds in the port (torch_atlas_scenarios.py
# --device cuda --save-attempts, then --weld-trials on the CPU).
ATLAS_MAP, ATLAS_BLANK, ATLAS_END, ATLAS_B_START = 30, 8, 105, 101
ATLAS_C_SPLIT, ATLAS_C_AFTER, ATLAS_C_INIT_BY = 45, 10, 140
ATLAS_JAX = dict(route="weld", back_at=(80, 59, 72, 72, 84), weld_after=21, reloc_at=101,
                 c_ate_m=0.016012884390779178)
# Phase 15, tests/torch_stereo_scenarios.py's protocols: (a)
# scripts/bench_variants.py::run_stereo (config/Stereo/KITTI00-02.yaml:
# 1241x376 rectified pairs at 10 Hz, 2000 features, a 0.54 m baseline):
# the shape, the sequence's frames, the frames before the timed chunks and
# StereoSlam's settings beside the shape's; (c) phase 8's configuration
# with EuRoC's 0.11 m stereo rig and a stereo map's point capacity (the
# point table only grows: keyframes that add their close points from depth
# fill phase 8's 4096 slots by frame ~60, and tracking then starves in
# both packages; 16384 last the run); (d) the TUM RGB-D shape
# (config/RGB-D/TUM1.yaml: 640x480, 1000 features) per frame, alone and
# with phase 8's IMU, and their frames.
ST_H, ST_W, ST_BASE, ST_FRAMES, ST_WARM = 376, 1242, 0.54, 120, 45
ST_SLAM_KW = dict(n_features=2000, max_keyframes=64, max_points=4096, kf_every=8, fuse_every=3,
                  stats_every=3, cull_every=3, lean_after_kf=4, track_cap=P_TRACK,
                  transfer_uint8=True)
SVI_BASE, SVI_MAX_POINTS = 0.11, 16384
RGBD_H, RGBD_W, RGBD_FRAMES, RGBD_VI_FRAMES = 480, 640, 60, 45
RGBD_SLAM_KW = dict(n_features=1000, max_keyframes=64, max_points=4096, track_cap=P_TRACK)
ST_SLOTS = 2040  # feature slots of 2000 features over 8 levels
ST_SCALE_TOL = 0.02
# The JAX package's runs of these protocols on the CPU
# (tests/torch_stereo_scenarios.py --package jax): the metric ATE (m) of
# (a), (c) (first 12 poses skipped) and (d); the card is held to 2x each.
ST_JAX = dict(a_ate_m=0.05826476169258746, c_ate_m=0.01750881383327182,
              d_rgbd_ate_m=0.0025017769415136655, d_rgbd_vi_ate_m=0.002850680836549069)
# Phase 16, tests/torch_fisheye_scenarios.py's protocols at the TUM-VI shape
# (Examples/Stereo-Inertial/TUM-VI.yaml: 512x512 KB8 frames at 20 Hz, cam0's
# intrinsics, 1000 features, a 0.101 m baseline): (a) the mono chunk loop on
# raw KB8 frames with phase 10's settings; (b) the two-camera rig with the
# right camera yawed 2 degrees (tests/test_fisheye_stereo.py's rig), its
# orbit at 10 Hz as that test's, for the spatial extent a metric ATE needs;
# (c) the JAX test's two-camera inertial run on phase 8's sequence, pinhole,
# the rig phase 15 (c)'s; (d) the rectified route, tests/test_rectify.py's
# scenario (KB8 rendered at 1.5x, remapped to a virtual pinhole).
FE_H, FE_W = 512, 512
FE_KB8 = np.asarray([190.978, 190.973, 254.932, 256.897, 0.0034824, 0.00071503, -0.0020532,
                     0.00020294], np.float32)
FE_FRAMES, FE_DT = 120, 0.05
FE_SLAM_KW = dict(n_features=1000, max_keyframes=64, max_points=4096, kf_every=8, fuse_every=3,
                  stats_every=3, cull_every=3, lean_after_kf=4, track_cap=P_TRACK,
                  transfer_uint8=True, pipelined=False)
FE_BASE, FE_YAW = 0.101, 0.035
FE_ST_FRAMES, FE_ST_DT, FE_ST_MAX_LOST = 60, 0.1, 8
FE_ST_KW = dict(n_features=1000, max_keyframes=32, max_points=4096, kf_every=3,
                track_cap=P_TRACK)
FE_VI_FRAMES, FE_VI_SCALE_TOL = 45, 0.06
FE_VI_KW = dict(n_features=1000, max_keyframes=32, max_points=4096, kf_every=3,
                init_after_kf=6)
FE_RECT_FRAMES, FE_RECT_UP = 25, 1.5
FE_RECT_KW = dict(n_features=1000, max_keyframes=32, max_points=4096, pipelined=False)
# The JAX package's runs of these protocols on the CPU
# (tests/torch_fisheye_scenarios.py --package jax): the Sim(3) ATE (m) of
# (a) and (d), the metric ATE of (b) and (c); the card is held to 2x each.
FE_JAX = dict(a_ate_m=0.09143445721133506, b_ate_m=0.005943132446196125,
              c_ate_m=0.015430461873248041, d_ate_m=0.007757705106899272)
# Phase 19, tests/torch_fisheye_scenarios.py's parts (e)-(g) run by the JAX
# package on the CPU: the metric ATE (m, first 12 poses skipped) of phase 9's
# protocol through the pinhole (e) and through the KB8 camera at the TUM-VI
# shape (f), and of FisheyeStereoInertialSlam() at its KB8 default on phase
# 16 (b)'s rig (g; lost from its second frame: no ATE). Its KB8 runs project
# the visual-inertial rows through the pinhole model (ROADMAP "Known faults"),
# so the card is not held to them; (a) and (b) are held to VI_ATE_LIMIT.
KB8_JAX = dict(a_pinhole_ate_m=0.0033262839341695726, a_kb8_ate_m=5.877434484895381,
               b_kb8_ate_m=float("inf"))
# Phase 19 (c): through the KB8 camera the loop barely drifts open (Sim(3)
# ATE 0.00527 m on an H100, 0.00591 m on the CPU, against phase 12 (a)'s
# pinhole loop, which the closure corrects), so a closure has almost
# nothing to correct: the run with loop closing is held to 1.1x the open
# run's ATE, not below it (an H100 run measured 0.00530 m against
# 0.00527 m), and to MAP_ATE_LIMIT.
KB8_LOOP_OPEN_RATIO = 1.1
# Phase 19 (b): 30 of phase 16 (c)'s 45 frames, for time (0.6-0.9 s a frame
# per frame on an H100's host); the IMU reaches its second stage by then.
KB8_RIG_FRAMES = 30
# Phase 17: the point events' cadence, the frame rate (b) keeps against
# (a), the reoptimization's card-vs-CPU pose bound and its iterations.
SURF_POINTS_EVERY, SURF_FPS_RATIO, SURF_REOPT_TOL, SURF_REOPT_ITERS = 1, 0.9, 1e-4, 30
SURF_B_RUNS = 2  # (b) runs, each between two runs of (a)
VI_PIPE_FRAMES = 120  # phase 21's frames: phase 8's first 120 of 165 (cut for time)
# each replay's frames: phase 7's first 75 (120 before phase 21, 90 before
# the mono keyframe program's comparisons; cut for time)
SURF_FRAMES = 75
FRONT_RUNS = 21  # phase 15 (b): runs of the stereo front-end program on one pair (1 captures)
PROBE_LOOP = 100_000  # interpreter iterations a host-probe sample (8-10 ms on the card's host)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, runs: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` calls, by CUDA events
    around each call, after warm-up calls."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_us(fn, calls: int = 100) -> float:
    """Microseconds of device time a call of ``fn`` takes when the next is
    already queued: the stream is held by a spin kernel while the host
    queues every call, so the host's enqueue rate does not show."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) * 1e3 / calls


def host_us(fn, calls: int = 200) -> float:
    """Microseconds the host spends to queue one call (no sync inside)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt * 1e6 / calls


def kernel_launches(lib, fn) -> int:
    """Kernels of the matcher's library that one call of ``fn`` queues:
    the library counts every launch it makes, read around a second call
    (the first may also fill a new workspace)."""
    import torch

    fn()
    before = lib.project_match_launches_queued()
    fn()
    queued = lib.project_match_launches_queued() - before
    torch.cuda.synchronize()
    return queued


def search_inputs(seed: int, P: int, N: int, radius_px: float, all_invalid: bool = False,
                  width: int = W, height: int = H):
    """The tests' projection-search case (``synth.make_search_case``: +-1
    descriptors, octaves 0..7, planted ties, also across every boundary of
    the kernel's column splits at this shape) in a ``width`` x ``height``
    image with radii of ``radius_px`` * 1.2^level px, as the matcher's nine
    input tensors on the card."""
    import torch

    from orb_slam3_ros_tpu_torch.ops import project_match
    from orb_slam3_ros_tpu_torch.utils.synth import make_search_case

    cols = project_match.build().project_match_split_cols(P, N)
    d = make_search_case(seed, P, N, W=width, H=height, tie_columns=tuple(range(cols, N, cols)))
    if all_invalid:
        d["proj_valid"][:] = False
    radius = (radius_px * 1.2 ** d["proj_level"].astype(np.float32)).astype(np.float32)
    arrays = (d["proj_uv"], d["proj_valid"], d["proj_level"], d["proj_sign"], radius,
              d["feat_xy"], d["feat_level"], d["feat_valid"], d["feat_sign"])
    return [torch.from_numpy(a).to("cuda") for a in arrays]


def kernel_vs_plain(torch, project_match, args, kw, what: str) -> tuple[int, int]:
    """(max |diff|, matches) of one search by the kernel and by its plain
    version; raises unless they are equal."""
    ik, dk = project_match.project_match(*args, **kw)
    ir, dr = project_match.project_match_reference(*args, **kw)
    torch.cuda.synchronize()
    err = max(int((ik - ir).abs().max()), int((dk - dr).abs().max()))
    check(err == 0, f"kernel disagrees with its plain version at {what} (max |diff| {err})")
    return err, int((ir >= 0).sum())


def search_bound(torch, project_match, args, kw) -> dict:
    """The least time the card could take for this search: every input read
    once and every output written once at the HBM rate, against the int8
    operations of the distances these inputs need (pairs inside a window x
    256 multiply-adds) at the tensor-core rate."""
    P, N = args[0].shape[0], args[5].shape[0]
    n_bytes = sum(a.numel() * a.element_size() for a in args) + 2 * P * 4
    pairs = int(project_match._window_mask(
        args[0], args[1], args[2], args[4], args[5], args[6], args[7],
        kw.get("level_slack", 1)).sum())
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    by_ops = pairs * 256 * 2 / INT8_OPS_PER_S * 1e6
    return dict(bound_us=max(by_bytes, by_ops), bound_by="bytes" if by_bytes >= by_ops else
                "operations", bytes=n_bytes, candidate_pairs=pairs)


def phase_kernel(torch, project_match, P: int, radius_px: float, min_match: int,
                 n: int = N_SLOTS, width: int = W, height: int = H, **kw) -> dict:
    """The kernel against its plain version on three seeded cases of P
    rows x ``n`` features in a ``width`` x ``height`` image (launches
    outside the counted runs), then both timed on the last case. ``kw``:
    the search settings (max_dist, ratio)."""
    max_err = 0
    for seed in range(3):
        args = search_inputs(seed, P, n, radius_px, width=width, height=height)
        err, n_match = kernel_vs_plain(torch, project_match, args, kw, f"P={P}, N={n}, seed {seed}")
        print(f"kernel vs plain at P={P}, radius {radius_px}, seed {seed}: matches {n_match}, "
              f"max |diff| {err}")
        check(n_match > min_match, "the comparison case matched too little to mean anything")
        max_err = max(max_err, err)
    kernel = lambda: project_match.project_match(*args, **kw)  # noqa: E731
    ms = cuda_ms(kernel, 100)
    plain_ms = cuda_ms(lambda: project_match.project_match_reference(*args, **kw), 100)
    dev_us, enqueue_us = device_us(kernel), host_us(kernel)
    queued = kernel_launches(project_match.build(), kernel)
    check(1 <= queued <= 2, f"a search queued {queued} kernels, expected 1 or 2")
    bound = search_bound(torch, project_match, args, kw)
    print(f"project_match at P={P} N={n} radius {radius_px} {kw}: call with wrapper "
          f"{ms * 1e3:.1f} us, plain torch {plain_ms * 1e3:.1f} us (median of 100, CUDA events "
          f"around each); kernel device time {dev_us:.2f} us (100 queued launches); host enqueue "
          f"{enqueue_us:.1f} us a call; bound {bound['bound_us']:.3f} us by {bound['bound_by']} "
          f"({bound['bytes']} B, {bound['candidate_pairs']} candidate pairs); kernels a call "
          f"queues, counted by the library: {queued}")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, device_us=dev_us,
                host_us=enqueue_us, kernel_launches=queued, **bound)


def phase_kernel_edges(torch, project_match) -> int:
    """Shapes and states that the two main shapes do not reach; each exact.
    Returns the number of cases."""
    odd = [  # P, N, radius, settings
        (771, 1000, 4.0, {}), (1, N_SLOTS, 60.0, {}), (13, 17, 60.0, {}),
        (4099, 1031, 3.0, FUSE_KW), (770, 33, 60.0, {}),
    ]
    for P, N, radius_px, kw in odd:
        args = search_inputs(3, P, N, radius_px)
        _, n_match = kernel_vs_plain(torch, project_match, args, kw, f"P={P}, N={N}")
        print(f"kernel vs plain at odd shape P={P} N={N} radius {radius_px}: matches {n_match}, "
              "max |diff| 0")
    args = search_inputs(4, P_TRACK, N_SLOTS, 60.0, all_invalid=True)
    _, n_match = kernel_vs_plain(torch, project_match, args, {}, "all rows invalid")
    check(n_match == 0, "a search without a valid row matched something")
    # 768, 4096, 768 rows, twice round, queued without a sync in between:
    # every call must leave its workspace as it found it.
    cases = [(search_inputs(5, P_TRACK, N_SLOTS, 60.0), {}),
             (search_inputs(6, P_FUSE, N_SLOTS, 3.0), FUSE_KW),
             (search_inputs(7, P_TRACK, N_SLOTS, 4.0), {})]
    refs = [project_match.project_match_reference(*a, **kw) for a, kw in cases]
    outs = [project_match.project_match(*a, **kw) for _ in range(2) for a, kw in cases]
    torch.cuda.synchronize()
    for (ik, dk), (ir, dr) in zip(outs, refs * 2):
        check(torch.equal(ik, ir) and torch.equal(dk, dr),
              "kernel disagrees with its plain version in back-to-back calls at alternating shapes")
        check(int((ir >= 0).sum()) > 50, "an alternating-shape case matched too little")
    print(f"kernel vs plain: {len(odd)} odd shapes, all rows invalid, {len(outs)} back-to-back "
          "calls at alternating shapes: max |diff| 0")
    return len(odd) + 1 + len(outs)


def ate(slam, seq, frames, with_scale=False) -> float:
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])
    pos = np.stack([T[:3, 3] for _, T in traj])
    rmse, n, _ = ate_rmse(ts, pos, seq.timestamps, seq.t_wc, with_scale=with_scale)
    check(n == frames, f"ATE matched {n} of {frames} poses")
    return rmse


def mono_kw(seq, device) -> dict:
    """bench.py's EuRoC-shape configuration (bench.py:60-66; phases 5-7 and
    20 with the port's default lean schedule, phase 10 with bench.py's)."""
    return dict(height=H, width=W, cam_params=seq.cam_params, n_features=N_FEATURES,
                max_keyframes=64, max_points=4096, kf_every=8, fuse_every=3, stats_every=3,
                cull_every=3, lean_after_kf=4, track_cap=P_TRACK, device=device)


def make_slam(seq, device, **kw):
    """``MonoSlam`` at ``mono_kw``'s configuration, each frame tracked at once
    (``pipelined=False``), with ``kw`` over it."""
    from orb_slam3_ros_tpu_torch.models.system import MonoSlam

    return MonoSlam(**{**mono_kw(seq, device), "pipelined": False, **kw})


def reset_launches(project_match) -> None:
    for site in project_match.LAUNCHES:
        project_match.LAUNCHES[site] = 0


def phase_slice(torch, project_match) -> tuple[dict, list]:
    from orb_slam3_ros_tpu_torch.models import tracking
    from orb_slam3_ros_tpu_torch.ops import orb
    from orb_slam3_ros_tpu_torch.utils import synth

    t0 = time.perf_counter()
    seq = synth.make_sequence(n_frames=N_FRAMES, height=H, width=W, dt=0.1, seed=3,
                              with_depth=True, device="cuda")
    slam = make_slam(seq, "cuda")
    m, n_kf, n_pts = synth.seed_map_from_depth(seq, KF_EVERY, slam)
    torch.cuda.synchronize()
    print(f"slice setup: rendered {N_FRAMES} frames at {W}x{H}, map of {n_kf} keyframes "
          f"and {n_pts} points in {time.perf_counter() - t0:.1f} s")
    check(n_kf == N_FRAMES // KF_EVERY and n_pts == slam.P_cap, "map seeding fell short")
    R0 = seq.R_wc[0].T
    slam.set_map(m, n_kf, n_pts, R0, -R0 @ seq.t_wc[0])
    slam.activate_localization_mode()
    passes = len(slam._current_schedule())

    torch.cuda.reset_peak_memory_stats()
    reset_launches(project_match)
    poses, frame_ms = [], []
    for i in range(1, N_FRAMES):
        if i == WARM + 1:
            torch.cuda.synchronize()
            t_start = time.perf_counter()
        t_frame = time.perf_counter()
        # process_frame ends in a host read of the pose: its return marks
        # the frame's completion on the card.
        out = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        if i > WARM:
            frame_ms.append((time.perf_counter() - t_frame) * 1e3)
        check(out is not None, f"frame {i} lost")
        poses.append(out)
    torch.cuda.synchronize()
    t_steady = time.perf_counter() - t_start
    launches = project_match.LAUNCHES["track"]
    peak = torch.cuda.max_memory_allocated()
    check(launches == passes * (N_FRAMES - 1) and project_match.LAUNCHES["fuse"] == 0,
          f"matcher kernel launched {project_match.LAUNCHES}, expected {passes} x {N_FRAMES - 1} "
          "from tracking and none from fusion")
    rmse = ate(slam, seq, N_FRAMES - 1)
    fps = (N_FRAMES - 1 - WARM) / t_steady
    print(f"slice: tracked {N_FRAMES - 1}/{N_FRAMES - 1} frames, metric ATE {rmse:.5f} m, "
          f"{fps:.2f} frames/s steady (frames {WARM + 1}..{N_FRAMES - 1}), "
          f"{passes} tracking passes/frame, kernel launches {launches}, "
          f"peak device memory {peak / 2**20:.1f} MiB")
    # p80: the highest percentile with >= 10 of the 54 steady frames beyond it.
    lat = np.percentile(frame_ms, [50, 80])
    print(f"frame latency over {len(frame_ms)} steady frames: median {lat[0]:.2f} ms, "
          f"p80 {lat[1]:.2f} ms, max {max(frame_ms):.2f} ms")
    check(rmse <= ATE_LIMIT, f"ATE {rmse:.5f} m above {ATE_LIMIT} m")

    # Stage times on the same frames and map, outside the counted run.
    feats_ms, track_ms = [], []
    sched = slam._current_schedule()
    for i in range(WARM + 1, WARM + 21):
        a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        a.record()
        f = orb.extract(seq.images[i], slam.config)
        b.record()
        R = torch.as_tensor(seq.R_wc[i].T, device="cuda")
        tt = -R @ torch.as_tensor(seq.t_wc[i], device="cuda")
        tracking.track_against_map(slam.map, f, R, tt, slam.cam_params, W, H,
                                   schedule=sched, track_cap=P_TRACK)
        c.record()
        c.synchronize()
        feats_ms.append(a.elapsed_time(b))
        track_ms.append(b.elapsed_time(c))
    print(f"stages (median of 20 frames, CUDA events): extract {np.median(feats_ms):.2f} ms, "
          f"track {np.median(track_ms):.2f} ms")
    result = dict(frames_per_s=fps, frame_ms_p50=float(lat[0]), frame_ms_p80=float(lat[1]),
                  ate_m=rmse, launches=launches, passes=passes,
                  extract_ms=float(np.median(feats_ms)), track_ms=float(np.median(track_ms)),
                  peak_mem_mib=peak / 2**20)
    return result, (seq, m, n_kf, n_pts, poses)


def phase_cpu(torch, state) -> None:
    """First 5 frames on the CPU from the same map and images. Tolerance
    5 mm / 5 mrad: FAST scores, moments and LM normal equations are summed
    in another order on the card, which moves poses by micrometres."""
    seq, m, n_kf, n_pts, gpu_poses = state
    slam = make_slam(seq, "cpu")
    R0 = seq.R_wc[0].T
    slam.set_map(m, n_kf, n_pts, R0, -R0 @ seq.t_wc[0])
    slam.activate_localization_mode()
    worst_t = worst_r = 0.0
    for i in range(1, 6):
        out = slam.process_frame(seq.images[i].cpu(), float(seq.timestamps[i]))
        check(out is not None, f"CPU run lost frame {i}")
        g = gpu_poses[i - 1]
        worst_t = max(worst_t, float(np.linalg.norm(out[:3, 3] - g[:3, 3])))
        # Angle from the skew part (arcsin), in float64: arccos of the
        # float32 trace cannot resolve angles below ~1 mrad.
        dR = out[:3, :3].astype(np.float64).T @ g[:3, :3].astype(np.float64)
        w = np.asarray([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2
        worst_r = max(worst_r, float(np.arcsin(min(1.0, np.linalg.norm(w)))))
    print(f"card vs CPU over frames 1..5: max |dt| {worst_t * 1e3:.4f} mm, "
          f"max rotation {worst_r * 1e3:.4f} mrad")
    check(worst_t <= 5e-3 and worst_r <= 5e-3, "card and CPU poses disagree")


def phase_mapping(torch, project_match) -> dict:
    """``MonoSlam`` maps a rendered 120-frame sequence from frame 0 on the
    card (``bench.py``'s sequence and configuration, no stored map). Each
    keyframe runs the keyframe program (``ProgramWatch``), its call timed by
    CUDA events around it; none runs the eager ``keyframe_work``."""
    from orb_slam3_ros_tpu_torch.models import kf_work, system
    from orb_slam3_ros_tpu_torch.utils import synth

    t0 = time.perf_counter()
    seq = synth.make_sequence(n_frames=MAP_FRAMES, height=H, width=W, dt=0.1, seed=3, device="cuda")
    slam = make_slam(seq, "cuda")
    torch.cuda.synchronize()
    print(f"mapping setup: rendered {MAP_FRAMES} frames at {W}x{H} in {time.perf_counter() - t0:.1f} s")

    eager = []
    work = kf_work.keyframe_work

    def counted_work(*args, **kw):
        eager.append(args[1])
        return work(*args, **kw)

    kf_work.keyframe_work = counted_work
    watch = ProgramWatch(torch, project_match, "mapping").__enter__()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(project_match)
    passes = 0
    init_at = None
    frame_ms = []
    try:
        for i in range(MAP_FRAMES):
            if slam.state == system.OK:
                passes += len(slam._current_schedule())
            t_frame = time.perf_counter()
            # process_frame ends in a host read (pose, or the initializer's
            # decision): its return marks the frame's completion on the card.
            out = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            dt = (time.perf_counter() - t_frame) * 1e3
            if init_at is None and out is not None:
                init_at, init_ms = i, dt
                t_init = time.perf_counter()
            elif init_at is not None:
                check(out is not None, f"mapping lost frame {i}")
                if i > init_at + WARM:
                    frame_ms.append(dt)
            check(init_at is not None or i < MAP_INIT_BY, f"not initialized by frame {MAP_INIT_BY}")
    finally:
        watch.__exit__()
        kf_work.keyframe_work = work
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_init
    t_steady = sum(frame_ms) / 1e3
    peak = torch.cuda.max_memory_allocated()
    launches = dict(project_match.LAUNCHES)  # the run's: the comparisons come after it
    kfw = watch.report(mono=True)
    n_fusing = kfw["fusing_keyframes"]
    kf_ms = kfw["mkf_call_ms"]  # every keyframe's call, the capture's included
    n_kf_made = 2 + len(kf_ms)
    rmse = ate(slam, seq, MAP_FRAMES - init_at, with_scale=True)
    lat = np.percentile(frame_ms, [50, 80])
    kf_med, kf_max = float(np.median(kf_ms)), float(max(kf_ms[1:] or kf_ms))
    extra = kfw["warmup_launches"]
    print(f"mapping: initialized at frame {init_at} ({init_ms:.1f} ms, initial BA "
          f"{slam.ba_iters[0]} iterations); tracked {MAP_FRAMES - init_at}/{MAP_FRAMES - init_at} "
          f"frames after it; {n_kf_made} keyframes made, {slam.n_kf} slots, "
          f"{int(slam.map.kf_valid.sum())} live; {slam.n_pts} points; Sim(3) ATE {rmse:.5f} m; "
          f"{len(frame_ms) / t_steady:.2f} frames/s steady over {len(frame_ms)} frames; latency "
          f"median {lat[0]:.2f} ms, p80 {lat[1]:.2f} ms; keyframe work (the program's call, CUDA "
          f"events) median {kf_med:.2f} ms over {len(kf_ms)}, max {kf_max:.2f} ms after the "
          f"capture, the capture's {kf_ms[0]:.2f} ms; local-BA iterations {slam.ba_iters[1:]}; "
          f"kernel launches {launches} (tracking passes {passes}, fusing keyframes {n_fusing}, "
          f"the program's capture warm-ups {extra}); peak device memory "
          f"{peak / 2**20:.1f} MiB; wall {wall:.1f} s after initialization")
    check(n_kf_made >= MAP_MIN_KF, f"only {n_kf_made} keyframes")
    check(not eager, f"keyframes {eager} ran the eager keyframe_work")
    check(rmse <= MAP_ATE_LIMIT, f"mapping ATE {rmse:.5f} m above {MAP_ATE_LIMIT} m")
    check(launches == {"track": passes + extra["track"], "fuse": 2 * n_fusing + extra["fuse"],
                       "sim3": 0, "merge": 0},
          f"matcher launches {launches}, expected {passes} from tracking and "
          f"{2 * n_fusing} from fusion, plus {extra}")
    return dict(init_frame=init_at, init_ms=init_ms, keyframes=n_kf_made, ate_sim3_m=rmse,
                frames_per_s=len(frame_ms) / t_steady, frame_ms_p50=float(lat[0]),
                frame_ms_p80=float(lat[1]), kf_work_ms_p50=kf_med, kf_work_ms_max=kf_max,
                kf_capture_ms=kf_ms[0], kf_program={k: v for k, v in kfw.items()
                                                   if k.startswith("mkf_")},
                ba_iters=slam.ba_iters, launches=launches, peak_mem_mib=peak / 2**20), seq


class Captured:
    """Replaces ``module.name`` by a wrapper that keeps the arguments of
    its calls (the newest ``keep``), so a stage can be run again alone."""

    def __init__(self, module, name: str, keep: int = 1):
        self.module, self.name, self.keep = module, name, keep
        self.fn = getattr(module, name)
        self.calls = []
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        self.calls = (self.calls + [(args, kw)])[-self.keep:]
        return self.fn(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)

    def replay(self, i: int = -1):
        args, kw = self.calls[i]
        return self.fn(*args, **kw)


def stage_cost(torch, fn, runs: int = 5, profile: bool = True) -> dict:
    """Host ms of ``fn()`` (median of ``runs``, each ended by a device
    sync; after one warm-up call when ``runs`` > 1) and, of the same runs,
    the span between CUDA events around it (the card's clock; its waits for
    the host are inside). With ``profile``, from one more run under
    ``torch.profiler`` the kernels it launched and their summed device ms:
    both None where the profiler traces nothing on the card, which the
    events do not depend on, or without ``profile``. Last, the
    synchronizing calls of one more run."""
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import device_profile

    if runs > 1:
        fn()
    torch.cuda.synchronize()
    times, spans = [], []
    for _ in range(runs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        spans.append(a.elapsed_time(b))
    launches, device_ms = device_profile(fn) if profile else (None, None)
    return dict(host_ms=float(np.median(times)), event_ms=float(np.median(spans)),
                launches=launches, device_ms=device_ms, sync_calls=sync_calls(torch, fn),
                runs=runs, profiled=profile)


def sync_calls(torch, fn) -> int:
    """Synchronizing calls (host reads among them) that ``fn()`` makes, by
    torch's sync debug mode, which warns at each."""
    return counting_syncs(torch, fn)[1]


def counting_syncs(torch, fn, *args):
    """(``fn(*args)``, the synchronizing calls it made: ``sync_calls``)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def float_gap(got, want) -> float:
    """The largest difference of two tensors relative to max(1, |want|),
    for a float dtype; raises on any difference of an integer or bool one."""
    if not want.dtype.is_floating_point:
        check(bool((got == want).all()), "integer or bool outputs differ")
        return 0.0
    if not want.numel():
        return 0.0
    return float(((got - want).abs() / want.abs().clamp(min=1.0)).max())


def map_gaps(a: dict, b: dict) -> dict:
    """Two VI keyframes' results (map fields and ``packed`` by name) apart:
    the largest float difference relative to max(1, |b|) in the keyframes'
    fields with the packed read, in the landmarks', and the integer and
    bool entries that differ."""
    out = {"keyframes": 0.0, "points": 0.0, "int_entries": 0}
    for f, y in b.items():
        x = a[f]
        if not y.dtype.is_floating_point:
            out["int_entries"] += int((x != y).sum())
        elif y.numel():
            c = "points" if f in POINT_FIELDS else "keyframes"
            out[c] = max(out[c], float(((x - y).abs() / y.abs().clamp(min=1.0)).max()))
    return out


class ProgramWatch:
    """The per-frame programs of one run, watched through their ``run``
    (``kf_program.KeyframeProgram``, ``vi_kf_program.VIKeyframeProgram`` and
    ``front_end_program.FrontEndProgram``, wrapped on their classes while
    the block runs): each keyframe's region replays against the regions
    ``kf_segments`` names, its synchronizing calls (the one packed read of a
    synchronous keyframe, none of a deferred mono one, but at a capture),
    its call's CUDA-event span, its host ms (the packed read included) and
    its replays' spans; each front end's replays a frame, synchronizing
    calls and spans. In the run the watch only copies what a comparison
    needs: the inputs of a kind's first keyframe after the capture and of
    its first fusing one, and a front-end program's buffers after its first
    replay after the capture. ``report`` compares, so that no timed frame
    holds a comparison and the K1 launches a phase reads before ``report``
    are its main path's alone. A keyframe is held to the plain function
    (``kf_work.keyframe_work``, or ``_vi_kf_work``) on its copies: under
    torch's deterministic algorithms (sums in a fixed order), a twin
    program's graphs, captured and replayed there, must equal the plain
    function (integers exact, floats to ``GRAPH_TOL``; equal to the bit as
    a rule); as the system's own graphs run (atomic sums, not reproducible
    on the card), the replays' gap to a plain run is printed beside two
    plain runs' gap, with the plain run's CUDA-event time. A front-end
    program's region runs eagerly on a copy of its buffers and is held to
    the replay's outputs (timed eagerly a few times). ``report`` prints the
    comparisons' K1 launches on a line of their own."""

    KINDS = ("VI", "mono")  # the keyframe programs, in the order of ``_cls``

    def __init__(self, torch, project_match, what: str):
        self.torch, self.pm, self.what = torch, project_match, what
        self.kf, self.mkf, self.front = [], [], []  # VI keyframes, mono keyframes, front ends
        self.kf_cmp = []  # the keyframes to compare (kind, id, fusing), then compared
        self.front_cmp = {}  # program -> its buffers after a replay, then (worst gap, eager ms)

    def __enter__(self):
        from orb_slam3_ros_tpu_torch.models import front_end_program, kf_program, vi_kf_program

        self._cls = (vi_kf_program.VIKeyframeProgram, kf_program.KeyframeProgram,
                     front_end_program.FrontEndProgram)
        self._mods = (vi_kf_program, kf_program)
        self._runs = tuple(c.run for c in self._cls)
        watch = self
        self._cls[0].run = lambda prog, m, inp: watch._kf_run(0, prog, m, inp)
        self._cls[1].run = lambda prog, m, inp, defer=False: watch._kf_run(1, prog, m, inp, defer)
        self._cls[2].run = lambda prog, a, b: watch._fe_run(prog, a, b)
        return self

    def __exit__(self, *exc):
        for c, r in zip(self._cls, self._runs):
            c.run = r

    @staticmethod
    def _copies(m, inp, n: int) -> list:
        """``n`` copies of a keyframe's map and inputs (the tensors cloned)."""
        from orb_slam3_ros_tpu_torch.models.map_state import MapState

        def clone(x):
            return x.clone() if hasattr(x, "clone") else x

        out = []
        for _ in range(n):
            kw = {f: clone(v) for f, v in inp._asdict().items() if f != "feats"}
            kw["feats"] = type(inp.feats)(*(clone(x) for x in inp.feats))
            out.append((MapState(*(x.clone() for x in m)), type(inp)(**kw)))
        return out

    def _kf_run(self, k: int, prog, m, inp, defer: bool = False):
        """A keyframe of program kind ``KINDS[k]``, watched."""
        from orb_slam3_ros_tpu_torch.models import kf_program as kfp
        from orb_slam3_ros_tpu_torch.models.map_state import MapState

        torch, kind = self.torch, self.KINDS[k]
        segs = kfp.kf_segments(prog.cfg, inp.kf_id)
        capturing = prog.graphs and prog.n_graphs < len(kfp.REGIONS)
        fusing = "kf_fuse" in segs
        done = [c for c in self.kf_cmp if c["kind"] == kind]
        snap = None
        if not capturing and (not done or fusing and not any(c["fuse"] for c in done)):
            snap = self._copies(m, inp, 4)
        runs0, s0 = sum(prog.runs.values()), len(prog.spans)
        prog.timing = True
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        out, n_sync = counting_syncs(torch, self._runs[k], prog, m, inp,
                                     *((defer,) if kind == "mono" else ()))
        b.record()
        host_ms = (time.perf_counter() - t0) * 1e3
        (self.mkf if kind == "mono" else self.kf).append(dict(
            kf=inp.kf_id, segs=segs, replays=sum(prog.runs.values()) - runs0, syncs=n_sync,
            host_ms=host_ms, capturing=capturing, prog=prog, spans=(s0, len(prog.spans)),
            deferred=defer, call=(a, b)))
        if snap is not None:
            graph = {f: prog.buf[f].clone() for f in MapState._fields + ("packed",)}
            self.kf_cmp.append(dict(kind=kind, kf=inp.kf_id, fuse=fusing, prog=prog, snap=snap,
                                    graph=graph))
        return out

    def _kf_compare(self, kind: str, prog, snap, graph) -> dict:
        """A keyframe's program of kind ``kind`` held to the plain function
        on the copies ``snap`` of its inputs; ``graph``: the system's
        replays' outputs."""
        import warnings

        from orb_slam3_ros_tpu_torch.models.map_state import MapState

        torch = self.torch
        k = self.KINDS.index(kind)
        mod, run = self._mods[k], self._runs[k]

        def named(m, packed):
            return dict(zip(MapState._fields, m), packed=packed)

        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        plain = named(*mod.eager_keyframe(*snap[0], prog.cfg))
        b.record()
        plain2 = named(*mod.eager_keyframe(*snap[1], prog.cfg))
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                K, N = prog.buf["kf_obs"].shape
                twin = type(prog)(prog.cfg, prog.device, K, N, prog.buf["pt_valid"].shape[0])
                det_graph = named(*run(twin, *snap[2]))
                det_graph["packed"] = twin.buf["packed"]
                det_plain = named(*mod.eager_keyframe(*snap[3], prog.cfg))
                torch.cuda.synchronize()
        finally:
            torch.use_deterministic_algorithms(False)
        det = map_gaps(det_graph, det_plain)
        return dict(det=det, det_bitwise=all(torch.equal(det_graph[f], v)
                                             for f, v in det_plain.items()),
                    nondet_ops=sorted({str(w.message).split(" does not")[0][:80] for w in caught
                                       if "deterministic" in str(w.message)}),
                    gap=map_gaps(graph, plain), spread=map_gaps(plain2, plain),
                    eager_ms=a.elapsed_time(b))

    def _fe_run(self, prog, img, img2):
        torch = self.torch
        capturing = prog.graphs and not prog.n_graphs
        runs0, s0 = prog.runs[prog.REGION], len(prog.spans)
        prog.timing = True
        t0 = time.perf_counter()
        out, n_sync = counting_syncs(torch, self._runs[2], prog, img, img2)
        host_ms = (time.perf_counter() - t0) * 1e3
        self.front.append(dict(replays=prog.runs[prog.REGION] - runs0, syncs=n_sync,
                               host_ms=host_ms, capturing=capturing, prog=prog,
                               spans=(s0, len(prog.spans))))
        if prog not in self.front_cmp and not capturing:
            # the replay left this frame's inputs and outputs in the buffers
            self.front_cmp[prog] = {k: v.clone() for k, v in prog.buf.items()}
        return out

    def _compare(self) -> dict:
        """Run the comparisons the run copied inputs for; returns their K1
        launches."""
        before = dict(self.pm.LAUNCHES)
        for c in self.kf_cmp:
            if "det" not in c:
                c.update(self._kf_compare(c["kind"], c.pop("prog"), c.pop("snap"),
                                          c.pop("graph")))
        for prog, got in self.front_cmp.items():
            if isinstance(got, dict):
                fn = prog.region(prog.REGION)
                scratch = {k: v.clone() for k, v in got.items()}
                fn(scratch)
                worst = max(float_gap(got[k], v) for k, v in scratch.items())
                self.front_cmp[prog] = (worst, cuda_ms(lambda: fn(scratch), 3))
        return {site: n - before[site] for site, n in self.pm.LAUNCHES.items()}

    def _ms(self, rec) -> float:
        """A record's replays' device ms, summed (CUDA events)."""
        prog, (i, j) = rec["prog"], rec["spans"]
        return sum(a.elapsed_time(b) for _, a, b in prog.spans[i:j])

    def warmups(self) -> dict:
        """K1 launches of the watched programs' captures' warm-ups."""
        progs = {id(r["prog"]): r["prog"] for r in self.kf + self.front + self.mkf}
        return {site: sum(p.warmup_launches[site] for p in progs.values())
                for site in self.pm.LAUNCHES}

    def _kf_report(self, recs: list, kind: str, plain_name: str) -> dict:
        """Check and print the keyframes ``recs`` of program kind ``kind``
        and their comparisons. Returns the figures."""
        what = self.what
        cmp = [c for c in self.kf_cmp if c["kind"] == kind]
        bad = [(r["kf"], r["replays"], len(r["segs"])) for r in recs
               if r["replays"] != len(r["segs"])]
        check(not bad, f"{what}: keyframes whose replays are not the regions kf_segments names "
                       f"(kf, replays, regions): {bad}")
        check(all(r["prog"].graphs for r in recs), f"{what}: a {kind} keyframe ran off the card")
        steady = [r for r in recs if not r["capturing"]]
        bad = sorted({(r["deferred"], r["syncs"]) for r in steady
                      if r["syncs"] != (0 if r["deferred"] else 1)})
        check(steady and not bad, f"{what}: synchronizing calls in a steady {kind} keyframe "
                                  f"(deferred, syncs) {bad} (1 synchronous, 0 deferred expected)")
        syncs = sorted({r["syncs"] for r in steady})
        fuse_k1 = {r["prog"]._graph["kf_fuse"][1]["fuse"] for r in recs}
        check(fuse_k1 == {2}, f"{what}: K1 launches a replay of the fuse graph {fuse_k1}")
        graph_ms = [self._ms(r) for r in steady]
        host_ms = [r["host_ms"] for r in steady]
        progs = {id(r["prog"]): r["prog"] for r in recs}
        out = dict(
            keyframes=len(recs), fusing_keyframes=sum("kf_fuse" in r["segs"] for r in recs),
            deferred=sum(r["deferred"] for r in recs),
            replays=sum(r["replays"] for r in recs), graph_ms_p50=float(np.median(graph_ms)),
            graph_ms_max=float(max(graph_ms)), host_ms_p50=float(np.median(host_ms)),
            host_ms_max=float(max(host_ms)), programs=len(progs),
            capture_s=sum(p.capture_s for p in progs.values()), syncs=syncs)
        head = (f"{what} {kind} keyframe program: {len(recs)} keyframes ({out['deferred']} "
                f"deferred) = {out['replays']} region replays, as kf_segments names; device ms a "
                f"keyframe median {out['graph_ms_p50']:.3f} (max {out['graph_ms_max']:.3f}), host "
                f"ms with the packed read median {out['host_ms_p50']:.3f} (max "
                f"{out['host_ms_max']:.3f}) over {len(steady)} after the capture "
                f"({out['programs']} programs, captures {out['capture_s']:.2f} s); syncs a steady "
                f"keyframe {syncs}; fusing keyframes {out['fusing_keyframes']}, K1 2 a fuse replay")
        check(len(cmp) >= 1, f"{what}: no {kind} keyframe was compared with {plain_name}")
        keys = ("keyframes", "points", "int_entries")
        det = {c: max(x["det"][c] for x in cmp) for c in keys}
        check(det["int_entries"] == 0 and max(det["keyframes"], det["points"]) <= GRAPH_TOL,
              f"{what}: under deterministic algorithms a {kind} keyframe's replays and the plain "
              f"{plain_name} differ: {det}")
        worst = {c: max(x["gap"][c] for x in cmp) for c in keys}
        spread = {c: max(x["spread"][c] for x in cmp) for c in keys}
        out.update(eager_ms=float(np.median([c["eager_ms"] for c in cmp])), graph_vs_eager=worst,
                   eager_spread=spread, det_bitwise=all(c["det_bitwise"] for c in cmp),
                   det_gap=det, nondet_ops=sorted({o for c in cmp for o in c["nondet_ops"]}))
        cmp_txt = ", ".join(f"keyframe {c['kf']}{' (fusing)' if c['fuse'] else ''} "
                            f"{c['eager_ms']:.3f} ms" for c in cmp)
        print(f"{head}; the plain {plain_name} on copies of the inputs: {cmp_txt} (CUDA "
              f"events); under deterministic algorithms a twin program's replays equal to it "
              f"{'to the bit' if out['det_bitwise'] else det} (ops without a deterministic form: "
              f"{out['nondet_ops'] or 'none'}); the system's replays (atomic sums) {worst} from a "
              f"plain run, two plain runs {spread} apart")
        return out

    def report(self, frames: int | None = None, mono: bool = False) -> dict:
        """Run the comparisons (``_compare``), then check and print the run's
        programs: every keyframe the regions its id names, each one replay,
        one synchronizing call (the packed read) a synchronous keyframe and
        none a deferred one but at a capture, the fuse graph 2 K1 launches a
        replay, the compared keyframes' twin replays equal to the plain
        function under deterministic algorithms; with ``mono``, mono
        keyframes must have run; with ``frames``, that many front-end runs,
        each one replay, none synchronizing but a capture, each program equal
        to its eager region. Returns the figures, with the fusing keyframes
        (of both kinds), the K1 launches of the captures' warm-ups (in the
        run) and of the comparisons (after it)."""
        torch, what = self.torch, self.what
        torch.cuda.synchronize()
        cmp_launches = self._compare()
        out = dict(vi_keyframes=len(self.kf), mono_keyframes=len(self.mkf), fusing_keyframes=0,
                   cmp_launches=cmp_launches, warmup_launches=self.warmups())
        check(not mono or self.mkf, f"{what}: no keyframe ran the mono keyframe program")
        if self.mkf:
            m = self._kf_report(self.mkf, "mono", "keyframe_work")
            out.update({f"mkf_{k}": v for k, v in m.items()})
            out["mkf_call_ms"] = [a.elapsed_time(b) for a, b in (r["call"] for r in self.mkf)]
            out["fusing_keyframes"] += m["fusing_keyframes"]
        if self.kf:
            v = self._kf_report(self.kf, "VI", "_vi_kf_work")
            out.update(
                fusing_keyframes=out["fusing_keyframes"] + v["fusing_keyframes"],
                kf_replays=v["replays"], kf_graph_ms_p50=v["graph_ms_p50"],
                kf_graph_ms_max=v["graph_ms_max"], kf_host_ms_p50=v["host_ms_p50"],
                kf_host_ms_max=v["host_ms_max"], kf_eager_ms=v["eager_ms"],
                kf_graph_vs_eager=v["graph_vs_eager"], kf_eager_spread=v["eager_spread"],
                kf_capture_s=v["capture_s"], kf_det_bitwise=v["det_bitwise"],
                kf_det_gap=v["det_gap"], kf_nondet_ops=v["nondet_ops"])
        if frames is not None:
            check(len(self.front) == frames, f"{what}: {len(self.front)} front-end runs for "
                                             f"{frames} frames")
            bad = [r["replays"] for r in self.front if r["replays"] != 1]
            check(not bad and all(r["prog"].graphs for r in self.front),
                  f"{what}: front-end runs that were not one replay: {bad}")
            steady = [r for r in self.front if not r["capturing"]]
            syncs = sorted({r["syncs"] for r in steady})
            check(syncs == [0], f"{what}: synchronizing calls in a front-end run {syncs}")
            worst = max(w for w, _ in self.front_cmp.values())
            check(worst <= GRAPH_TOL, f"{what}: front-end replay and eager differ by {worst:.3g}")
            graph_ms = [self._ms(r) for r in steady]
            host_ms = [r["host_ms"] for r in steady]
            eager_ms = float(np.median([e for _, e in self.front_cmp.values()]))
            out.update(front_runs=len(self.front), front_ms_p50=float(np.median(graph_ms)),
                       front_host_ms_p50=float(np.median(host_ms)), front_eager_ms=eager_ms,
                       front_graph_vs_eager=worst)
            print(f"{what} front end: {len(self.front)} frames = {len(self.front)} replays; device "
                  f"ms median {out['front_ms_p50']:.3f} (CUDA events), eager {eager_ms:.3f} ms, "
                  f"host ms a run {out['front_host_ms_p50']:.3f}; equal to the eager region to "
                  f"{worst:.3g}; syncs a run {syncs}")
        print(f"{what}: K1 launches of the comparisons above {cmp_launches} (after the run, "
              f"apart from its count)")
        return out


COUNTED = ("_track_res", "_dispatch_vi", "_log_pose")  # phase 8's wrappers of its system


_VI_SEQ = []  # (SynthSequence, imu dict) of ``vi_sequence``, made once


def vi_sequence(n_frames: int) -> tuple:
    """The first ``n_frames`` of the sequence of phases 8, 13, 14 (c), 18 (c)
    and 21 (``VI_SEQ_KW`` at phase 13's length, rendered once on the card):
    the same frames and IMU samples, sample for sample, as
    ``make_vi_sequence`` at that length. Returns (SynthSequence, imu dict)."""
    from orb_slam3_ros_tpu_torch.utils import synth
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW

    if not _VI_SEQ:
        _VI_SEQ.append(synth.make_vi_sequence(**{**VI_SEQ_KW, "n_frames": VI_LC_FRAMES[0]}))
    seq, im = _VI_SEQ[0]
    check(n_frames <= len(seq.timestamps), f"vi_sequence: {n_frames} frames asked for")
    per_frame = ("acc", "gyro", "dts", "vel")
    return (seq._replace(images=seq.images[:n_frames], R_wc=seq.R_wc[:n_frames],
                         t_wc=seq.t_wc[:n_frames], timestamps=seq.timestamps[:n_frames]),
            {k: v[:n_frames] if k in per_frame else v for k, v in im.items()})


def phase_vi(torch, project_match, card: str) -> tuple:
    """``InertialSlam`` over a rendered 165-frame sequence with IMU samples
    on the card at ``bench.py``'s ``main_vi`` shape, the VI frames one
    frame behind through the VI frame graph. Returns (result, phase 9's
    start, (the system and what ``phase_vi_stages`` replays, the sequence
    and its IMU samples))."""
    from orb_slam3_ros_tpu_torch.models import inertial_system, local_mapping, system
    from orb_slam3_ros_tpu_torch.ops import viba
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import align_umeyama, ate_rmse
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_IMU_HZ, VI_SEQ_KW, VI_SLAM_KW, vi_calib

    n_frames = VI_SEQ_KW["n_frames"]
    check(tuple(VI_SLAM_KW[k] for k in ("height", "width", "n_features", "track_cap", "max_points"))
          == (H, W, N_FEATURES, P_TRACK, P_FUSE),
          "the mono-inertial configuration is not at the shapes the kernel was held at")
    t0 = time.perf_counter()
    seq, im = vi_sequence(n_frames)
    slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(), **VI_SLAM_KW)
    check(slam.device.type == "cuda", "InertialSlam without a device argument is not on the card")
    torch.cuda.synchronize()
    print(f"vi setup: rendered {VI_LC_FRAMES[0]} frames at {W}x{H} with {int(VI_IMU_HZ)} Hz IMU "
          f"(this phase's first {n_frames}, phase 13's all) in {time.perf_counter() - t0:.1f} s")

    n_fusing = 0
    caps = {
        "refine": Captured(inertial_system, "_vi_refine"),
        "build": Captured(local_mapping, "build_vi_ba"),
        "viba": Captured(viba, "vi_bundle_adjust"),
        "init": Captured(viba, "inertial_init", keep=2),
        "gs": Captured(viba, "vi_bundle_adjust_gs", keep=3),
    }
    watch = ProgramWatch(torch, project_match, "vi")

    mono_work = inertial_system.MonoSlam._insert_keyframe

    def counted_mono_kf(self, feats, ts, track_res):
        # keyframes before IMU initialization run the mono keyframe work
        nonlocal n_fusing
        kf_id = self.n_kf
        n_fusing += self.fuse_neighbors > 0 and kf_id >= 2 and kf_id % self.fuse_every == 0
        return mono_work(self, feats, ts, track_res)

    track_res, dispatch_vi = slam._track_res, slam._dispatch_vi
    mono_passes, vi_syncs, vi_calls, posted = 0, [], 0, []
    log_pose = slam._log_pose

    def counted_track_res(feats):
        # the visual frames before the IMU initializes track eagerly
        nonlocal mono_passes
        mono_passes += len(slam._current_schedule())
        return track_res(feats)

    def counted_dispatch_vi(*args):
        prog = slam._vi_prog
        graphs = 0 if prog is None else prog.n_graphs
        out, n = counting_syncs(torch, dispatch_vi, *args)
        if graphs == slam._vi_prog.n_graphs:  # a capture synchronizes its side stream
            vi_syncs.append(n)
        slam._vi_prog.timing = True  # CUDA events around each later replay
        return out

    def logged(ts):
        posted.append(ts)
        log_pose(ts)

    inertial_system.MonoSlam._insert_keyframe = counted_mono_kf
    slam._track_res, slam._dispatch_vi, slam._log_pose = counted_track_res, counted_dispatch_vi, logged
    torch.cuda.reset_peak_memory_stats()
    reset_launches(project_match)
    init_at, stage_at, frame_ms, syncs, nones = None, {}, [], [], []
    start = None
    watch.__enter__()
    try:
        for i in range(n_frames):
            if start is None and i < CHUNK_WARM - 2 * CHUNK and slam._vi_chunkable():
                # Phase 9 goes on from here: where bench.py's main_vi stops
                # going frame by frame.
                start = (i, chunk_snapshot(slam), seq, im)
                for k in COUNTED:  # this run's counting wrappers stay with it
                    del vars(start[1])[k]
            stage0 = slam.imu_stage
            n_kf0 = slam.n_kf
            vi_calls += slam.imu_initialized and slam.state in (system.OK, system.RECENTLY_LOST)
            args = (seq.images[i], float(seq.timestamps[i]))
            kw = dict(acc=im["acc"][i], gyro=im["gyro"][i], dts=im["dts"][i])
            t_frame = time.perf_counter()
            if i >= n_frames - 10:  # the last frames also count their synchronizing calls
                box = []
                n_sync = sync_calls(torch, lambda: box.append(slam.process_frame(*args, **kw)))
                out = box[0]
                if slam.n_kf == n_kf0:
                    syncs.append(n_sync)
            else:
                out = slam.process_frame(*args, **kw)
            dt = (time.perf_counter() - t_frame) * 1e3
            if init_at is None and out is not None:
                init_at = i
            elif init_at is not None:
                # a VI call returns the frame before it: None at the first one
                if out is None:
                    nones.append(i)
                check(slam.state == system.OK, f"vi run left state OK at frame {i}: {slam.state}")
            check(init_at is not None or i < VI_INIT_BY, f"vi map not initialized by frame {VI_INIT_BY}")
            if slam.imu_stage != stage0:
                stage_at[slam.imu_stage] = i
            elif slam.imu_stage == 3 and i < n_frames - 10:
                frame_ms.append(dt)
        t_flush = time.perf_counter()
        slam.flush()
        flush_ms = (time.perf_counter() - t_flush) * 1e3
        torch.cuda.synchronize()
        launches = dict(project_match.LAUNCHES)
        prog = slam._vi_prog
        # The refinement's arguments for phase_vi_stages: inside the graph
        # _vi_refine runs only at capture, on the graph's buffers, so the VI
        # frame program runs once more eagerly on a copy of its buffers (the
        # last frame's inputs), which Captured records.
        sched = slam._current_schedule()
        prog.region(("frame", sched))({k: v.clone() for k, v in prog.buf.items()})
        # build_vi_ba's and vi_bundle_adjust's too, from the keyframe
        # program's BA region on a copy of its buffers (the last keyframe's)
        kfp = slam._vi_kf_prog
        kfp.region("kf_ba")({k: v.clone() for k, v in kfp.buf.items()})
    finally:
        watch.__exit__()
        inertial_system.MonoSlam._insert_keyframe = mono_work
        for c in caps.values():
            c.restore()
        for k in COUNTED:
            del vars(slam)[k]
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counts = dict(slam.pipe_counts)
    kfw = watch.report()
    n_fusing += kfw["fusing_keyframes"]

    check(slam.imu_initialized and slam.imu_stage == 3,
          f"IMU initialization stopped at stage {slam.imu_stage}")
    check(slam.bad_imu_resets == 0, f"{slam.bad_imu_resets} bad-IMU resets")
    check(len(frame_ms) >= VI_MIN_STEADY, f"only {len(frame_ms)} steady VI frames after stage 3")
    check(slam.n_kf >= VI_MIN_KF, f"only {slam.n_kf} keyframes")
    traj = slam.get_trajectory()
    check(len(traj) == n_frames - init_at, f"{len(traj)} poses for {n_frames - init_at} frames")
    check(posted == [float(t) for t in seq.timestamps[init_at:]],
          "the frames were not posted once each, in order")
    check(len(nones) == 1, f"calls after initialization returned None at frames {nones}, the "
          "first VI frame's only expected")
    ts = np.asarray([t for t, _ in traj])[VI_SKIP:]
    est = np.stack([T[:3, 3] for _, T in traj])[VI_SKIP:]
    gt_ts = seq.timestamps.astype(np.float64)
    rmse_m, n_m, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    gt = seq.t_wc[np.clip(np.searchsorted(seq.timestamps, ts - 1e-6), 0, n_frames - 1)]
    _, R_align, _ = align_umeyama(est, gt, with_scale=True)
    bg_err = float(np.abs(slam.bg_cur - im["bg"]).max())
    lat = np.percentile(frame_ms, [50, 80])
    fps = len(frame_ms) / (sum(frame_ms) / 1e3)
    kf_med, kf_max = kfw["kf_graph_ms_p50"], kfw["kf_graph_ms_max"]
    label = {slam._sched_dense: "dense", slam._sched_lean: "lean"}
    runs = {label[name[1]]: n for name, n in prog.runs.items()}
    vi_passes = sum(len(name[1]) * n for name, n in prog.runs.items())
    passes = mono_passes + vi_passes
    warm = dict(prog.warmup_launches)
    graph_ms = [a.elapsed_time(b) for _, a, b in prog.spans]
    nodes = {label[name[1]]: graph_nodes(g) for name, (g, _) in prog._graph.items()}
    ready = counts["vi_ready"] / max(1, counts["vi_drains"])
    print(f"vi: map initialized at frame {init_at}; IMU stages done at frames {stage_at} in "
          f"{ {k: round(v, 1) for k, v in slam.init_stage_ms.items()} } ms (wall, each ended by a "
          f"host read); {len(traj)}/{n_frames - init_at} frames tracked; {slam.n_kf} keyframes, "
          f"{slam.n_pts} points; metric ATE {rmse_m:.5f} m over {n_m} poses, Umeyama scale "
          f"{scale:.5f}, alignment R[2,2] {R_align[2, 2]:.5f}; bg {slam.bg_cur} (truth {im['bg']}), "
          f"ba {slam.ba_cur}; {fps:.2f} frames/s steady over {len(frame_ms)} frames after stage 3 "
          f"(keyframe frames included; the eager VI frame before the VI frame graph: 2.36-2.75 "
          f"frames/s, median 346.50 ms; with the eager VI keyframe work 13.78-18.75, PERF.md); "
          f"latency median {lat[0]:.2f} ms, p80 {lat[1]:.2f} ms; flush {flush_ms:.2f} ms; VI "
          f"keyframe program device ms median {kf_med:.2f}, max {kf_max:.2f}, host ms median "
          f"{kfw['kf_host_ms_p50']:.2f} (the eager VI keyframe work 95.25-132.33 ms median, "
          f"PERF.md); kernel "
          f"launches {launches} (tracking passes {passes}: {mono_passes} visual, {vi_passes} in "
          f"the VI frame graphs' replays {runs}, warm-ups {warm}; fusing keyframes {n_fusing}); "
          f"synchronizing calls of a steady frame without a keyframe {sorted(set(syncs))}; peak "
          f"device memory {peak / 2**20:.1f} MiB")
    print(f"vi frame graph ({card}): {counts['vi_dispatches']} dispatches = {vi_calls} VI frames = "
          f"replays {runs}; device ms median {np.median(graph_ms):.3f} (min {min(graph_ms):.3f}, "
          f"max {max(graph_ms):.3f}) over {len(graph_ms)} replays; nodes {nodes}; captured in "
          f"{prog.capture_s:.2f} s; drains whose copy had landed {counts['vi_ready']}/"
          f"{counts['vi_drains']} ({ready:.3f}); anchors {dict(prog.anchors)}; map copies "
          f"{prog.map_copies}; syncs in a steady dispatch {sorted(set(vi_syncs))} over "
          f"{len(vi_syncs)}")
    check(n_m == len(ts), f"ATE matched {n_m} of {len(ts)} poses")
    check(rmse_m <= VI_ATE_LIMIT, f"metric ATE {rmse_m:.5f} m above {VI_ATE_LIMIT} m")
    check(abs(scale - 1.0) <= VI_SCALE_TOL, f"Umeyama scale {scale:.5f} not within {VI_SCALE_TOL:.0%} of 1")
    check(R_align[2, 2] > VI_MIN_R22, f"gravity misaligned: alignment R[2,2] {R_align[2, 2]:.5f}")
    check(bg_err <= VI_BG_TOL, f"gyro bias off by {bg_err:.5f}")
    check(prog.graphs and sum(prog.runs.values()) == counts["vi_dispatches"] == vi_calls,
          f"{sum(prog.runs.values())} VI frame graph replays, {counts['vi_dispatches']} dispatches, "
          f"{vi_calls} VI frames")
    check(vi_syncs and not any(vi_syncs),
          f"synchronizing calls in a steady VI dispatch: {sorted(set(vi_syncs))}")
    extra = kfw["warmup_launches"]  # the keyframe program's capture warm-ups launch K1 too
    want = {"track": passes + warm["track"] + extra["track"],
            "fuse": 2 * n_fusing + warm["fuse"] + extra["fuse"], "sim3": 0, "merge": 0}
    check(launches == want, f"matcher launches {launches}, expected {want}: {mono_passes} visual "
          f"passes, {vi_passes} in the VI frame graphs, {2 * n_fusing} from fusion, warm-ups {warm}"
          f", the keyframe program's warm-ups {extra}")
    worst = graph_vs_eager(torch, prog, sched, "frame")
    print(f"vi frame graph: one replay = the eager program to {worst:.3g}")
    return dict(
        init_frame=init_at, stage_frames=stage_at, init_stage_ms=slam.init_stage_ms,
        keyframes=slam.n_kf, ate_metric_m=rmse_m, scale=scale, r22=float(R_align[2, 2]),
        bg_err=bg_err, frames_per_s=fps, steady_frames=len(frame_ms), frame_ms_p50=float(lat[0]),
        frame_ms_p80=float(lat[1]), flush_ms=flush_ms, kf_work_ms_p50=kf_med, kf_work_ms_max=kf_max,
        launches=launches, passes=passes, mono_passes=mono_passes, vi_passes=vi_passes,
        vi_graph_runs=runs, warmup_launches=warm, fusing_keyframes=n_fusing,
        graph_ms_p50=float(np.median(graph_ms)), graph_nodes=nodes, capture_s=prog.capture_s,
        ready_share=ready, graph_vs_eager=worst, sync_free_dispatches=len(vi_syncs),
        kf_program={k: v for k, v in kfw.items() if not k.endswith("launches")},
        sync_calls_per_frame=sorted(set(syncs)), peak_mem_mib=peak / 2**20,
    ), start, (slam, caps, seq, im)


def phase_vi_stages(torch, slam, caps) -> dict:
    """Phase 8's inertial stages alone, on the arguments of their last
    calls in its run (the initialization stages: of each stage's own call).
    Run after phase 9, so that phase 9's device times are taken before any
    use of the profiler (PERF.md §7)."""
    from orb_slam3_ros_tpu_torch.ops import imu, lie

    calib = slam.calib
    dev = slam.device
    rng = np.random.default_rng(0)

    def imu_block(*shape):
        a = torch.as_tensor(rng.normal(size=shape + (3,)).astype(np.float32), device=dev)
        g = torch.as_tensor(rng.normal(size=shape + (3,)).astype(np.float32) * 0.3, device=dev)
        d = torch.full(shape, 0.01, dtype=torch.float32, device=dev)
        b = torch.zeros(shape[:-1] + (6,), dtype=torch.float32, device=dev)
        return a, g, d, b

    frame_blk, window_blk = imu_block(16), imu_block(slam.W - 1, 64)
    stages = {
        "preintegrate frame block [16], tree": lambda: imu.preintegrate(*frame_blk, calib),
        "preintegrate frame block [16], sequential":
            lambda: imu.preintegrate_sequential(*frame_blk, calib),
        f"preintegrate window [{slam.W - 1}, 64], tree": lambda: imu.preintegrate(*window_blk, calib),
        f"preintegrate window [{slam.W - 1}, 64], sequential":
            lambda: imu.preintegrate_sequential(*window_blk, calib),
        "build_vi_ba (W=12)": caps["build"].replay,
        "pose_inertial_optimization (_vi_refine)": caps["refine"].replay,
        "vi_bundle_adjust, 4 iterations": caps["viba"].replay,
        "normalize_rotation of one 3x3 (Newton polar)":
            lambda: lie.normalize_rotation(torch.eye(3, device=dev)),
        "init stage 1: inertial_init, 40 iterations": lambda: caps["init"].replay(0),
        "init stage 1: vi_bundle_adjust_gs, 25 iterations": lambda: caps["gs"].replay(0),
        "init stage 2: inertial_init, 40 iterations": lambda: caps["init"].replay(1),
        "init stage 2: vi_bundle_adjust_gs, 25 iterations": lambda: caps["gs"].replay(1),
        "init stage 3: vi_bundle_adjust_gs, 40 iterations": lambda: caps["gs"].replay(2),
    }
    check(len(caps["init"].calls) == 2 and len(caps["gs"].calls) == 3,
          "the initialization stages did not make their 2 + 3 solver calls")
    # Each initialization solve (0.5-1 s eager, up to ~40,000 launches) is
    # replayed once, the other stages three times, and only the two solves
    # every frame and keyframe run under the profiler. Every stage five
    # times and under the profiler took 132 s of the script's time on an
    # H100's host; with the initialization solves once, 54 s.
    profiled = ("pose_inertial_optimization (_vi_refine)", "vi_bundle_adjust, 4 iterations")
    t0 = time.perf_counter()
    costs = {}
    for name, fn in stages.items():
        costs[name] = c = stage_cost(torch, fn, runs=1 if name.startswith("init stage") else 3,
                                     profile=name in profiled)
        dev_txt = ("launches and device ms not profiled" if not c["profiled"] else
                   "launches and device ms not measured (the profiler traced nothing)"
                   if c["device_ms"] is None else
                   f"{c['launches']} launches, device {c['device_ms']:.3f} ms")
        print(f"vi stage {name}: host {c['host_ms']:.2f} ms, CUDA-event span {c['event_ms']:.2f} ms "
              f"(median of {c['runs']} synchronized runs), {dev_txt}, "
              f"{c['sync_calls']} synchronizing calls")
    print(f"phase 8 stage replays: {time.perf_counter() - t0:.1f} s")
    seq_faster = (costs["preintegrate frame block [16], sequential"]["host_ms"]
                  < costs["preintegrate frame block [16], tree"]["host_ms"])
    print(f"preintegration on the main path: tree (sequential faster at the frame shape: {seq_faster})")
    return costs


SHARED = ("generator", "_mono_runner", "_frame_prog", "_vi_prog", "_front_prog")
# Not shared: a keyframe program's buffers are its system's map after a
# keyframe, so a copy makes its own at its first keyframe.
OWN = ("_vi_kf_prog", "_kf_prog")


def chunk_snapshot(slam):
    """A deep copy of a system on the card that shares, not copies, its CUDA
    generator, its mono chunk runner and its frame programs (graphs cannot
    be copied; each chunk or frame loads its own inputs into the buffers),
    and has no keyframe program (mono or VI) yet. A frame in flight is
    copied with its host copy landed."""
    held = {k: getattr(slam, k, None) for k in SHARED + OWN}
    for k in held:
        setattr(slam, k, None)
    try:
        snap = copy.deepcopy(slam)
    finally:
        for k, v in held.items():
            setattr(slam, k, v)
    for k in SHARED:
        setattr(snap, k, held[k])
    return snap


def poll_card():
    """nvidia-smi in the background, reading the card's SM clock, its
    maximum, temperature and power draw every 100 ms until ``read_card``."""
    q = "clocks.sm,clocks.max.sm,temperature.gpu,power.draw"
    return subprocess.Popen(
        ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
    )


def read_card(proc) -> dict:
    """Stops ``poll_card``'s process; the medians and extremes it read, or
    {} where nvidia-smi printed nothing usable."""
    proc.terminate()
    out, _ = proc.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        try:
            row = [float(x) for x in line.split(",")]
        except ValueError:  # an error message, or "[N/A]"
            continue
        if len(row) == 4:
            rows.append(row)
    if not rows:
        return {}
    sm, sm_max, temp, power = np.asarray(rows).T
    return dict(samples=len(sm), sm_mhz_median=float(np.median(sm)), sm_mhz_min=float(sm.min()),
                sm_mhz_max_allowed=float(sm_max.max()), temp_c_max=float(temp.max()),
                power_w_median=float(np.median(power)))


def graph_nodes(g):
    """Nodes of a captured ``torch.cuda.CUDAGraph`` by libcuda's
    ``cuGraphGetNodes``, or None where torch or libcuda does not say."""
    import ctypes

    try:
        handle = g.raw_cuda_graph()
        cuda = ctypes.CDLL("libcuda.so.1")
        n = ctypes.c_size_t(0)
        err = cuda.cuGraphGetNodes(ctypes.c_void_p(handle), None, ctypes.byref(n))
    except (AttributeError, OSError, RuntimeError, TypeError):
        return None
    return int(n.value) if err == 0 else None


def vi_accuracy(slam, seq, im, n_frames) -> dict:
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import align_umeyama, ate_rmse

    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])[VI_SKIP:]
    est = np.stack([T[:3, 3] for _, T in traj])[VI_SKIP:]
    gt_ts = seq.timestamps.astype(np.float64)
    rmse, n, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    gt = seq.t_wc[np.clip(np.searchsorted(seq.timestamps, ts - 1e-6), 0, n_frames - 1)]
    _, R_align, _ = align_umeyama(est, gt, with_scale=True)
    return dict(poses=len(traj), scored=n, ate_metric_m=rmse, scale=scale,
                r22=float(R_align[2, 2]), bg_err=float(np.abs(slam.bg_cur - im["bg"]).max()))


def check_vi_accuracy(acc: dict, what: str) -> None:
    check(acc["scored"] == acc["poses"] - VI_SKIP, f"{what}: ATE matched {acc['scored']} poses")
    check(acc["ate_metric_m"] <= VI_ATE_LIMIT,
          f"{what}: metric ATE {acc['ate_metric_m']:.5f} m above {VI_ATE_LIMIT} m")
    check(abs(acc["scale"] - 1.0) <= VI_SCALE_TOL, f"{what}: Umeyama scale {acc['scale']:.5f}")
    check(acc["r22"] > VI_MIN_R22, f"{what}: gravity misaligned, R[2,2] {acc['r22']:.5f}")
    check(acc["bg_err"] <= VI_BG_TOL, f"{what}: gyro bias off by {acc['bg_err']:.5f}")


def graph_vs_eager(torch, runner, schedule, kind: str = "step") -> float:
    """One region (``(kind, schedule)``: a chunk's step, or the pipelined
    frame program's frame) from the runner's buffers twice: eagerly on a
    copy of them, and as a replay of its captured graph on them. Returns the
    largest float difference; raises on any integer or bool difference."""
    scratch = {k: v.clone() for k, v in runner.buf.items()}
    runner.region((kind, schedule))(scratch)
    runner._run((kind, schedule))
    torch.cuda.synchronize()
    worst = 0.0
    for k, eager in scratch.items():
        graph = runner.buf[k]
        if eager.dtype.is_floating_point:
            d = ((graph - eager).abs() / torch.clamp(eager.abs(), min=1.0)).max()
            worst = max(worst, float(d)) if eager.numel() else worst
        else:
            check(torch.equal(graph, eager), f"graph replay and eager step differ in {k}")
    check(worst <= GRAPH_TOL, f"graph replay and eager step differ by {worst:.3g} in a float field")
    return worst


def region_syncs(torch, runner, schedule) -> dict:
    """Synchronizing calls of each chunk region run eagerly once, in order,
    on a copy of the runner's buffers: the step, then every keyframe
    segment. A capture would fail on any of them; this names where."""
    scratch = {k: v.clone() for k, v in runner.buf.items()}
    out = {}
    for name in [("step", schedule), *runner.SEGMENTS]:
        fn = runner.region(name)
        torch.cuda.synchronize()
        out["step" if isinstance(name, tuple) else name] = sync_calls(torch, lambda: fn(scratch))
    return out


def replay_stats(runner, chunk_ms, n_kf: int):
    """From a runner's CUDA events of the timed chunks: (device ms of each
    replay by region, keyframe graphs' ms a keyframe, busy share of the
    chunks' wall time, the step's median ms, the host's mean gap from a flag
    read to the next launch in µs, each graph's nodes)."""
    spans = {}
    for name, a, b in runner.spans:
        spans.setdefault("step" if isinstance(name, tuple) else name, []).append(a.elapsed_time(b))
    kf_graph_ms = sum(sum(v) for k, v in spans.items() if k != "step") / max(1, n_kf)
    busy = sum(sum(v) for v in spans.values()) / sum(chunk_ms)
    nodes = {("step" if isinstance(k, tuple) else k): graph_nodes(g) for k, (g, _) in runner._graph.items()}
    return (spans, kf_graph_ms, busy, float(np.median(spans["step"])),
            float(np.mean(runner.gaps_s)) * 1e6, nodes)


def phase_vi_chunk(torch, project_match, vi8: dict, start) -> dict:
    """``bench.py``'s ``main_vi`` protocol on the card through
    ``InertialSlam.process_frames``, with the step and keyframe bodies as
    CUDA graphs. ``start``: (frame, system, sequence, IMU) where phase 8's
    run first passed the chunk gate (its prefix is ``main_vi``'s)."""
    from orb_slam3_ros_tpu_torch.models import system, vi_device_loop

    check(start is not None, f"phase 8 never passed the chunk gate before frame "
          f"{CHUNK_WARM - 2 * CHUNK}")
    i, slam, seq, im = start
    n_frames = len(seq.timestamps)
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)  # bench.py's frame stack
    eager_steps = []  # frame_step calls outside a capture: the warm-ups
    step_fn = vi_device_loop.frame_step

    def counted_step(*args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            eager_steps.append(1)
        return step_fn(*args, **kw)

    per_frame = slam.process_frame
    calls = []

    def counted_frame(*args, **kw):
        calls.append(1)
        return per_frame(*args, **kw)

    def chunk(i, n):
        slam.process_frames((stack, i), seq.timestamps[i : i + n], acc=im["acc"][i : i + n],
                            gyro=im["gyro"][i : i + n], dts=im["dts"][i : i + n])

    i_steady = i
    vi_device_loop.frame_step = counted_step
    slam.process_frame = counted_frame
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        while i + CHUNK <= CHUNK_WARM:
            chunk(i, CHUNK)
            i += CHUNK
        warm_s = time.perf_counter() - t0
        runner = slam._vi_runner
        check(runner is not None and runner.graphs, "the chunks did not run on graphs")
        # The timed chunks, with CUDA events around every replay.
        start = i
        runner.timing = True
        reset_launches(project_match)
        runs0, warm0 = dict(runner.runs), dict(runner.warmup_launches)
        chunk_ms = []

        def timed_chunks():
            nonlocal i
            while i + CHUNK <= n_frames:
                t1 = time.perf_counter()
                chunk(i, CHUNK)  # ends in the chunk's host read
                chunk_ms.append((time.perf_counter() - t1) * 1e3)
                i += CHUNK

        poll = poll_card()
        try:
            n_sync = sync_calls(torch, timed_chunks)
            torch.cuda.synchronize()
        finally:
            card = read_card(poll)
        runner.timing = False
        launches = dict(project_match.LAUNCHES)
        runs = {k: runner.runs[k] - runs0.get(k, 0) for k in runner.runs}
        warm = {k: runner.warmup_launches[k] - warm0[k] for k in warm0}
        n_last = n_frames - i  # the last frames as one more, shorter chunk
        if n_last:
            chunk(i, n_last)
            i += n_last
    finally:
        vi_device_loop.frame_step = step_fn
        slam.process_frame = per_frame
    peak = torch.cuda.max_memory_allocated()
    timed = i - n_last - start if n_last else i - start
    step_runs = sum(v for k, v in runs.items() if isinstance(k, tuple))
    fusing = runs.get("kf_fuse", 0)
    n_kf_timed = runs.get("kf_insert", 0)
    passes = len(slam._current_schedule())
    check(not calls, f"{len(calls)} frames went through process_frame during the chunks")
    check(step_runs == timed, f"{step_runs} step-graph replays for {timed} timed frames")
    n_step_graphs = sum(isinstance(k, tuple) for k in runner._graph)
    check(len(eager_steps) == n_step_graphs,
          f"{len(eager_steps)} eager steps on the card, expected one warm-up for each of "
          f"{n_step_graphs} step graphs")
    check(launches == {"track": passes * timed + warm["track"], "fuse": 2 * fusing + warm["fuse"],
                      "sim3": 0, "merge": 0},
          f"matcher launches {launches}, expected {passes} x {timed} from tracking and 2 x {fusing} "
          f"from fusion (plus warm-ups {warm})")
    check(slam.bad_imu_resets == 0, f"{slam.bad_imu_resets} bad-IMU resets")
    check(slam.state == system.OK, f"state {slam.state} after the chunks")
    acc = vi_accuracy(slam, seq, im, n_frames)
    check(acc["poses"] == n_frames - vi8["init_frame"],
          f"{acc['poses']} poses for {n_frames - vi8['init_frame']} frames")
    check_vi_accuracy(acc, "vi chunk")

    spans, kf_graph_ms, busy, step_ms, gap_us, nodes = replay_stats(runner, chunk_ms, n_kf_timed)
    fps = timed / (sum(chunk_ms) / 1e3)
    worst = graph_vs_eager(torch, runner, slam._current_schedule())
    audit = region_syncs(torch, runner, slam._current_schedule())
    check(not any(audit.values()), f"synchronizing calls in the eager regions: {audit}")
    syncs_per_frame = n_sync / timed
    print(f"vi chunk: chunkable at frame {i_steady}; {runner.n_graphs} graphs captured in "
          f"{runner.capture_s:.2f} s (nodes {nodes}), chunks up to frame {start} in {warm_s:.2f} s; "
          f"timed frames {start}..{start + timed - 1}: {fps:.2f} frames/s (phase 8, per frame: "
          f"{vi8['frames_per_s']:.2f}), chunk latency median {np.median(chunk_ms):.2f} ms over "
          f"{len(chunk_ms)} chunks of {CHUNK} = {np.median(chunk_ms) / CHUNK:.2f} ms a frame (phase 8: "
          f"median {vi8['frame_ms_p50']:.2f} ms); step graph {step_ms:.2f} ms median over "
          f"{len(spans['step'])} replays; keyframe graphs {kf_graph_ms:.2f} ms a keyframe over "
          f"{n_kf_timed} ({ {k: round(float(np.median(v)), 3) for k, v in spans.items()} } ms "
          f"medians); busy {busy:.1%} of the chunks' wall time; host gap flag read -> next launch "
          f"{gap_us:.1f} us mean; K1 launches {launches} (passes {passes}, fusing keyframes "
          f"{fusing}, warm-ups {warm}); metric ATE {acc['ate_metric_m']:.5f} m, scale "
          f"{acc['scale']:.5f}, R[2,2] {acc['r22']:.5f}, bg err {acc['bg_err']:.2e}; "
          f"{slam.n_kf} keyframes; graph vs eager step max diff {worst:.3g}; synchronizing calls "
          f"{n_sync} over the {timed} timed frames, {audit} in each region run eagerly; peak "
          f"device memory {peak / 2**20:.1f} MiB; the card during the timed chunks {card}")
    return dict(chunkable_frame=i_steady, graphs=runner.n_graphs, graph_nodes=nodes,
                capture_s=runner.capture_s, timed_frames=timed, frames_per_s=fps,
                chunk_ms=chunk_ms, frame_ms=float(np.median(chunk_ms)) / CHUNK, step_ms=step_ms,
                kf_graph_ms=kf_graph_ms, busy=busy, gap_us=gap_us, launches=launches,
                warmup_launches=warm, fusing_keyframes=fusing, passes=passes,
                graph_vs_eager=worst, syncs_per_frame=syncs_per_frame, region_syncs=audit, card=card,
                peak_mem_mib=peak / 2**20,
                **acc)


def ba_forms(torch, runner, kf_id: int, n_iters: int) -> dict:
    """The BA segment's problem (the covisibility window around keyframe
    ``kf_id`` of the runner's map, the id a 0-d tensor on the card as the
    segment has it) solved by both early-stop forms of ``bundle_adjust``:
    under torch's deterministic algorithms (``index_add_`` then sums in a
    fixed order) they must be equal to the bit; as the graphs run them
    (atomic sums), their difference is printed beside that of two runs of
    one form."""
    import warnings

    from orb_slam3_ros_tpu_torch.models import local_mapping
    from orb_slam3_ros_tpu_torch.ops import ba

    m = runner.carry().m
    ids, fixed, ev = local_mapping.select_covis_window(
        m, torch.tensor(kf_id, dtype=torch.int32, device=runner.device), runner.cfg.ba_window,
        runner.cfg.ba_fixed)
    prob, _ = local_mapping.build_local_ba(m, ids, fixed, runner.cfg.cam_params, entry_valid=ev)

    def solve(on_device):
        return ba.bundle_adjust(prob, n_iters=n_iters, rel_tol=1e-3, on_device=on_device)

    def diff(a, b):
        return max(float(((getattr(a, f) - getattr(b, f)).abs()
                          / torch.clamp(getattr(a, f).abs(), min=1.0)).max())
                   for f in ("R", "t", "X", "chi2", "cost"))

    host, dev, host2 = solve(False), solve(True), solve(False)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            host_d, dev_d = solve(False), solve(True)
    finally:
        torch.use_deterministic_algorithms(False)
    exact = all(torch.equal(getattr(host_d, f), getattr(dev_d, f))
                for f in ("R", "t", "X", "chi2", "inlier", "cost", "n_inliers"))
    check(int(dev_d.iters) == host_d.iters and exact,
          f"BA forms differ under deterministic algorithms: {int(dev_d.iters)} against "
          f"{host_d.iters} iterations, max diff {diff(host_d, dev_d):.3g}")
    return dict(iters=host_d.iters, of=n_iters, deterministic_bitwise_equal=exact,
                atomic_forms_max_diff=diff(host, dev), atomic_same_form_max_diff=diff(host, host2),
                atomic_iters=(host.iters, int(dev.iters)), edges=int(prob.edge_valid.sum()),
                inliers=int(host_d.n_inliers),
                nondeterministic_ops=sorted({str(w.message).split(" does not")[0][:80]
                                             for w in caught}))


def phase_mono_chunk(torch, project_match, mp: dict, seq) -> tuple:
    """``bench.py``'s ``main`` protocol on the card through
    ``MonoSlam.process_frames`` (phase 7's sequence), the step and keyframe
    segments as CUDA graphs. Returns (result, the system at frame
    MONO_WARM for phase 11, the uint8 stack)."""
    from orb_slam3_ros_tpu_torch.models import device_loop, system

    n_frames = len(seq.timestamps)
    slam = make_slam(seq, "cuda", transfer_uint8=True)
    slam._sched_lean = BENCH_LEAN
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)  # bench.py's frame stack
    eager_steps, calls = [], []
    step_fn, per_frame = device_loop.frame_step, slam.process_frame

    def counted_step(*args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            eager_steps.append(1)
        return step_fn(*args, **kw)

    def counted_frame(*args, **kw):
        calls.append(1)
        return per_frame(*args, **kw)

    def chunk(i):
        slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK])

    device_loop.frame_step = counted_step
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        i, init_at = 0, None
        while (slam.state != system.OK or not slam._chunkable()) and i < MONO_WARM - CHUNK:
            if slam.process_frame(seq.images[i], float(seq.timestamps[i])) is not None:
                init_at = i if init_at is None else init_at
            i += 1
        i_steady = i
        while i + CHUNK <= MONO_WARM:
            chunk(i)
            i += CHUNK
        while i < MONO_WARM:
            slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            i += 1
        warm_s = time.perf_counter() - t0
        runner = slam._mono_runner
        check(runner is not None and runner.graphs, "the mono chunks did not run on graphs")
        snap = chunk_snapshot(slam)
        slam.process_frame = counted_frame
        runner.timing = True
        runner.spans, runner.gaps_s = [], []
        reset_launches(project_match)
        runs0, warm0 = dict(runner.runs), dict(runner.warmup_launches)
        chunk_ms = []

        def timed_chunks():
            nonlocal i
            while i + CHUNK <= n_frames:
                t1 = time.perf_counter()
                chunk(i)  # ends in the chunk's host read
                chunk_ms.append((time.perf_counter() - t1) * 1e3)
                i += CHUNK

        n_sync = sync_calls(torch, timed_chunks)
        torch.cuda.synchronize()
        runner.timing = False
        launches = dict(project_match.LAUNCHES)
    finally:
        device_loop.frame_step = step_fn
        slam.process_frame = per_frame
    peak = torch.cuda.max_memory_allocated()
    timed = i - MONO_WARM
    runs = {k: runner.runs[k] - runs0.get(k, 0) for k in runner.runs}
    warm = {k: runner.warmup_launches[k] - warm0[k] for k in warm0}
    step_runs = sum(v for k, v in runs.items() if isinstance(k, tuple))
    fusing, n_kf_timed = runs.get("kf_fuse", 0), runs.get("kf_insert", 0)
    passes = len(slam._sched_lean)
    check(init_at is not None, "the mono run never initialized")
    check(not calls, f"{len(calls)} frames went through process_frame during the timed chunks")
    check(step_runs == timed, f"{step_runs} step-graph replays for {timed} timed frames")
    n_step_graphs = sum(isinstance(k, tuple) for k in runner._graph)
    check(len(eager_steps) == n_step_graphs,
          f"{len(eager_steps)} eager steps on the card, expected one warm-up for each of "
          f"{n_step_graphs} step graphs")
    check(launches == {"track": passes * timed + warm["track"], "fuse": 2 * fusing + warm["fuse"],
                      "sim3": 0, "merge": 0},
          f"matcher launches {launches}, expected {passes} x {timed} from tracking and 2 x {fusing} "
          f"from fusion (plus warm-ups {warm})")
    check(slam.state == system.OK, f"state {slam.state} after the chunks")
    check(slam.n_kf >= MAP_MIN_KF, f"only {slam.n_kf} keyframes")
    rmse = ate(slam, seq, n_frames - init_at, with_scale=True)
    check(rmse <= MAP_ATE_LIMIT, f"mono chunk ATE {rmse:.5f} m above {MAP_ATE_LIMIT} m")
    spans, kf_graph_ms, busy, step_ms, gap_us, nodes = replay_stats(runner, chunk_ms, n_kf_timed)
    gap_med_us = float(np.median(runner.gaps_s)) * 1e6
    fps = timed / (sum(chunk_ms) / 1e3)
    worst = graph_vs_eager(torch, runner, slam._sched_lean)
    audit = region_syncs(torch, runner, slam._sched_lean)
    check(not any(audit.values()), f"synchronizing calls in the eager regions: {audit}")
    bas = ba_forms(torch, runner, slam.n_kf - 1, slam.local_ba_iters)
    print(f"mono chunk: initialized at frame {init_at}, chunkable at frame {i_steady}; "
          f"{runner.n_graphs} graphs captured in {runner.capture_s:.2f} s (nodes {nodes}), chunks "
          f"up to frame {MONO_WARM} in {warm_s:.2f} s; timed frames {MONO_WARM}..{i - 1}: "
          f"{fps:.2f} frames/s (phase 7, per frame: {mp['frames_per_s']:.2f}), chunk latency median "
          f"{np.median(chunk_ms):.2f} ms over {len(chunk_ms)} chunks of {CHUNK} = "
          f"{np.median(chunk_ms) / CHUNK:.2f} ms a frame (phase 7: median {mp['frame_ms_p50']:.2f} "
          f"ms); step graph {step_ms:.2f} ms median over {len(spans['step'])} replays; keyframe "
          f"graphs {kf_graph_ms:.2f} ms a keyframe over {n_kf_timed} "
          f"({ {k: round(float(np.median(v)), 3) for k, v in spans.items()} } ms medians); busy "
          f"{busy:.1%} of the chunks' wall time; host gap flag read -> next launch {gap_us:.1f} us "
          f"mean, {gap_med_us:.1f} us median (a segment's first capture falls in the gap); K1 "
          f"launches {launches} (passes {passes}, fusing keyframes {fusing}, warm-ups "
          f"{warm}); Sim(3) ATE {rmse:.5f} m; {slam.n_kf} keyframes, {slam.n_pts} points; graph vs "
          f"eager step max diff {worst:.3g}; BA forms {bas}; synchronizing calls {n_sync} over the "
          f"{timed} timed frames, {audit} in each region run eagerly; peak device memory "
          f"{peak / 2**20:.1f} MiB")
    return dict(init_frame=init_at, chunkable_frame=i_steady, graphs=runner.n_graphs,
                graph_nodes=nodes, capture_s=runner.capture_s, timed_frames=timed,
                frames_per_s=fps, chunk_ms=chunk_ms, frame_ms=float(np.median(chunk_ms)) / CHUNK,
                step_ms=step_ms, kf_graph_ms=kf_graph_ms,
                segment_ms={k: float(np.median(v)) for k, v in spans.items()}, busy=busy,
                gap_us=gap_us, gap_us_median=gap_med_us, launches=launches,
                warmup_launches=warm, fusing_keyframes=fusing,
                passes=passes, keyframes=slam.n_kf, ate_sim3_m=rmse, graph_vs_eager=worst,
                ba_forms=bas, syncs_per_frame=n_sync / timed, region_syncs=audit,
                peak_mem_mib=peak / 2**20), snap, stack


def phase_reloc(torch, project_match, snap, seq, stack) -> dict:
    """Two losses from copies of phase 10's system at frame MONO_WARM, the
    rest of the sequence in chunks of 15 (frames a chunk cannot take go
    through ``process_frame``): (a) a timestamp jump at JUMP_AT, (b) the
    frames DARK black. Each relocalization call and attempt is timed and
    its K1 launches (the counts set to 0 just before the call, read just
    after it: one search a pass of the dense schedule an attempt) and
    inliers kept. First the kernel against its plain version at an
    attempt's searches: the whole point table, each pass's radius, the
    tracker's settings."""
    from orb_slam3_ros_tpu_torch.models import system, tracking
    from orb_slam3_ros_tpu_torch.ops import pnp

    n_points = snap.map.P
    for i, (radius_px, _, _) in enumerate(tracking.SCHEDULE_DENSE):
        args = search_inputs(8 + i, n_points, N_SLOTS, radius_px)
        err, n_match = kernel_vs_plain(torch, project_match, args, {}, f"relocalization pass {i}")
        check(n_match > 50, "a relocalization-shaped case matched too little to mean anything")
        print(f"kernel vs plain at relocalization's pass {i}: P={n_points}, radius {radius_px}: "
              f"matches {n_match}, max |diff| {err}")
    n_passes = len(tracking.SCHEDULE_DENSE)
    n_frames = len(seq.timestamps)
    attempt_fn, solve_fn = system._reloc_attempt, pnp.solve_pnp

    def run(name, tss, frames):
        slam = chunk_snapshot(snap)
        reloc, calls, attempts, pnp_inl = slam._try_relocalize, [], [], []

        def frame_of(ts):
            return int(np.argmin(np.abs(tss - ts)))

        def timed_attempt(*args, **kw):
            t0 = time.perf_counter()
            out = attempt_fn(*args, **kw)
            torch.cuda.synchronize()
            attempts.append(dict(cand=int(args[1]), host_ms=(time.perf_counter() - t0) * 1e3,
                                 out=out))
            return out

        def kept_pnp(*args, **kw):
            res = solve_fn(*args, **kw)
            pnp_inl.append(res.n_inliers)
            return res

        def logged(feats, ts):
            n0 = len(attempts)
            reset_launches(project_match)
            t0 = time.perf_counter()
            out = reloc(feats, ts)
            ms = (time.perf_counter() - t0) * 1e3
            launches = dict(project_match.LAUNCHES)
            want = {"track": n_passes * (len(attempts) - n0), "fuse": 0, "sim3": 0, "merge": 0}
            check(launches == want, f"reloc {name}: K1 launches {launches} in a relocalization "
                  f"call, expected {want}")
            calls.append(dict(frame=frame_of(ts), ok=out is not None, ms=ms,
                              attempts=attempts[n0:], launches=launches))
            return out

        slam._try_relocalize = logged
        system._reloc_attempt, pnp.solve_pnp = timed_attempt, kept_pnp
        try:
            for i in range(MONO_WARM, n_frames, CHUNK):
                slam.process_frames((frames, i), tss[i : i + CHUNK])
        finally:
            system._reloc_attempt, pnp.solve_pnp = attempt_fn, solve_fn
        for a, n in zip([a for c in calls for a in c["attempts"]], pnp_inl):
            a.update(pnp_inliers=int(n), track_inliers=int(a.pop("out")[12]))
        posed = {frame_of(t) for t, _ in slam.get_trajectory()}
        print(f"reloc {name}: " + "; ".join(
            f"frame {c['frame']}: {'recovered' if c['ok'] else 'failed'} in {c['ms']:.1f} ms, K1 "
            f"launches {c['launches']}, attempts " + ", ".join(
                f"(candidate {a['cand']}: {a['host_ms']:.1f} ms, PnP inliers {a['pnp_inliers']}, "
                f"tracking inliers {a['track_inliers']})" for a in c["attempts"])
            for c in calls) + f"; state {slam.state}, {slam.n_kf} keyframes")
        check(slam.state == system.OK, f"reloc {name}: state {slam.state} at the end")
        return calls, posed

    tss_jump = np.asarray(seq.timestamps, np.float64).copy()
    tss_jump[JUMP_AT:] += JUMP_S
    calls, posed = run("(a) timestamp jump", tss_jump, stack)
    check([c["frame"] for c in calls] == [JUMP_AT] and calls[0]["ok"],
          f"reloc (a): relocalization calls {[(c['frame'], c['ok']) for c in calls]}, expected one "
          f"that succeeds at frame {JUMP_AT}")
    check(set(range(MONO_WARM, n_frames)) <= posed, "reloc (a): a frame after the jump lost")
    dark = stack.clone()
    dark[DARK[0] : DARK[1]] = 0
    calls_b, posed_b = run("(b) blackout", np.asarray(seq.timestamps, np.float64), dark)
    ok_at = [c["frame"] for c in calls_b if c["ok"]]
    check(len(ok_at) == 1 and ok_at[0] <= DARK[1] + RELOC_AFTER_DARK,
          f"reloc (b): relocalization calls {[(c['frame'], c['ok']) for c in calls_b]}, expected "
          f"a recovery by frame {DARK[1] + RELOC_AFTER_DARK}")
    check(set(range(ok_at[0], n_frames)) <= posed_b, "reloc (b): a frame after the recovery lost")
    launches = {k: sum(c["launches"][k] for c in calls + calls_b) for k in project_match.LAUNCHES}
    return dict(jump=calls, blackout=calls_b, recovered_at=ok_at[0], launches=launches)


class SearchRecorder:
    """Wraps ``project_match.project_match_cuda`` (the kernel's launching
    wrapper, which counts each launch) to keep a copy of the inputs of the
    first search at launch site ``site`` for which ``keep(args)`` holds
    (default: any); counts nothing itself."""

    def __init__(self, project_match, site: str, keep=None):
        self.pm, self.site, self.fn = project_match, site, project_match.project_match_cuda
        self.keep = keep or (lambda args: True)
        self.args = self.kw = None

    def __enter__(self):
        def recorded(*args, **kw):
            if kw.get("site") == self.site and self.args is None and self.keep(args):
                self.args = [a.clone() for a in args]
                self.kw = {k: v for k, v in kw.items() if k != "site"}
            return self.fn(*args, **kw)

        self.pm.project_match_cuda = recorded
        return self

    def __exit__(self, *exc):
        self.pm.project_match_cuda = self.fn


def loop_run(torch, seq, close: bool):
    """Phase 12(a)'s run: ``MonoSlam`` over the closed loop with local-map
    tracking, per frame to the chunk gate, then chunks of 15 (the rest per
    frame), flushed. Returns the system."""
    from orb_slam3_ros_tpu_torch.models.system import OK, MonoSlam

    slam = MonoSlam(height=H, width=W, cam_params=seq.cam_params, n_features=N_FEATURES,
                    max_keyframes=64, max_points=LOOP_MAX_POINTS, kf_every=3, track_window=8,
                    enable_loop_closing=close, pipelined=False)
    if close:
        slam.loop_closer.min_gap = 8
        slam.loop_closer.min_sim3_inliers = 15
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)
    n, i = len(seq.timestamps), 0
    while i < n:
        if slam.state == OK and slam._chunkable() and i + CHUNK <= n:
            slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK])
            i += CHUNK
        else:
            slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            i += 1
    slam.flush()
    return slam


def phase_loop_mono(torch, project_match) -> dict:
    """Phase 12: monocular loop closing on the card. (a) the closed loop at
    full width, with and without loop closing; (b) ``bench_variants.py``'s
    ``lc`` protocol, timed."""
    from orb_slam3_ros_tpu_torch.ops import ba_pcg, graphs, pgo, robust
    from orb_slam3_ros_tpu_torch.utils import synth

    seq = synth.make_sequence(n_frames=LOOP_FRAMES, height=H, width=W, dt=0.1, seed=5,
                              trajectory="loop")
    watch = ProgramWatch(torch, project_match, "loop (a)").__enter__()
    t0 = time.perf_counter()
    open_slam = loop_run(torch, seq, close=False)
    open_s = time.perf_counter() - t0
    rmse_open = ate(open_slam, seq, len(open_slam.get_trajectory()), with_scale=True)
    reset_launches(project_match)
    kept, pgo_fn, pcg_fn = {"pgo": [], "pcg": []}, pgo.optimize_pose_graph, ba_pcg.bundle_adjust_pcg

    def keeper(name, fn):  # keeps a copy of each problem the solve is given
        def kept_fn(prob, *a, **kw):
            kept[name].append((type(prob)(*(x.clone() for x in prob)), kw))
            return fn(prob, *a, **kw)
        return kept_fn

    t0 = time.perf_counter()
    pgo.optimize_pose_graph, ba_pcg.bundle_adjust_pcg = keeper("pgo", pgo_fn), keeper("pcg", pcg_fn)
    try:
        with SearchRecorder(project_match, "sim3") as rec:
            slam = loop_run(torch, seq, close=True)
    finally:
        pgo.optimize_pose_graph, ba_pcg.bundle_adjust_pcg = pgo_fn, pcg_fn
        watch.__exit__()
    loop_s = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    kfw = watch.report(mono=True)
    lc, runner = slam.loop_closer, slam._mono_runner
    rmse = ate(slam, seq, len(slam.get_trajectory()), with_scale=True)
    print(f"loop (a): {LOOP_FRAMES} frames of the closed loop at {W}x{H}: closures {lc.closures}, "
          f"Sim(3) ATE {rmse:.5f} m (without loop closing {rmse_open:.5f} m), {slam.n_kf} "
          f"keyframes, global BAs {slam.gba_counts}, {runner and runner.n_graphs} graphs; K1 "
          f"launches {launches} ({lc.sim3_searches} SearchBySim3 calls); run {loop_s:.1f} s "
          f"(without loop closing {open_s:.1f} s)")
    check(len(lc.closures) >= 1, "no loop closure fired on the closed loop")
    check(rmse < rmse_open and rmse < LOOP_ATE_LIMIT,
          f"ATE {rmse:.5f} m with loop closing, {rmse_open:.5f} m without (limit {LOOP_ATE_LIMIT} m)")
    check(slam.gba_counts["started"] == slam.gba_counts["finished"] >= 1,
          f"global BAs started / folded in: {slam.gba_counts}")
    check(runner is not None and runner.graphs and runner.n_graphs == 7,
          f"{runner and runner.n_graphs} graphs captured in the loop run, expected 7")
    check(launches["sim3"] == lc.sim3_searches >= 1,
          f"{launches['sim3']} SearchBySim3 launches, the closer made {lc.sim3_searches} searches")
    check(rec.args is not None, "no SearchBySim3 input was recorded")
    # the essential-graph solve and a global-BA dispatch as their CUDA graphs
    # against the same solves run eagerly on the same inputs (the callers
    # pass n_iters, n_cg by keyword)
    check(kept["pgo"] and kept["pcg"], "no pose-graph solve or global-BA dispatch ran")
    prob, kw = kept["pgo"][0]
    res_g, res_e = pgo.optimize_pose_graph(prob, **kw), pgo._solve_7dof(prob, kw["n_iters"], 1e-4)
    pgo_diff = max(float((g - e).abs().max()) for g, e in zip(res_g, res_e))
    check(pgo_diff <= GRAPH_TOL, f"pose-graph solve: graph vs eager max diff {pgo_diff:.3g}")
    prob, kw = kept["pcg"][0]
    res_g = ba_pcg.bundle_adjust_pcg(prob, **kw)
    res_e = ba_pcg._solve(prob, kw["n_iters"], kw["n_cg"], robust.CHI2_MONO, True, 1e-3)
    pcg_diff = {f: float((getattr(res_g, f) - getattr(res_e, f)).abs().max()) for f in ("R", "t", "X")}
    # index_add_'s atomics sum in any order: poses to 1e-3 (the BA forms' 7e-5, phase 10)
    check(max(pcg_diff["R"], pcg_diff["t"]) <= 1e-3,
          f"global-BA dispatch: graph vs eager max diff {pcg_diff}")
    err, n_match = kernel_vs_plain(torch, project_match, rec.args, rec.kw, "SearchBySim3")
    kernel = lambda: project_match.project_match(*rec.args, **rec.kw)  # noqa: E731
    k_ms = cuda_ms(kernel, 100)
    plain_ms = cuda_ms(lambda: project_match.project_match_reference(*rec.args, **rec.kw), 100)
    dev_us = device_us(kernel)
    bound = search_bound(torch, project_match, rec.args, rec.kw)
    print(f"loop (a) solves as CUDA graphs {graphs.COUNTS}: the pose graph against its eager run "
          f"max diff {pgo_diff:.3g}, a global-BA dispatch {pcg_diff}")
    print(f"loop (a) SearchBySim3 kernel vs plain at P={rec.args[0].shape[0]} "
          f"N={rec.args[5].shape[0]} {rec.kw}: max |diff| {err}, {n_match} matches; call "
          f"{k_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, device {dev_us:.2f} us, bound "
          f"{bound['bound_us']:.3f} us by {bound['bound_by']}")
    a = dict(closures=lc.closures, ate_sim3_m=rmse, ate_open_m=rmse_open, keyframes=slam.n_kf,
             gba=slam.gba_counts, graphs=runner.n_graphs, launches=launches,
             sim3_searches=lc.sim3_searches, sim3_max_abs_err=err, sim3_matches=n_match,
             sim3_ms=k_ms, sim3_plain_ms=plain_ms, sim3_device_us=dev_us,
             sim3_bound_us=bound["bound_us"], sim3_bound_by=bound["bound_by"], run_s=loop_s,
             pgo_graph_vs_eager=pgo_diff, pcg_graph_vs_eager=pcg_diff,
             kf_program={k: v for k, v in kfw.items() if k.startswith("mkf_")})
    return dict(closed_loop=a, lc=phase_lc_protocol(torch, project_match)), slam


def phase_lc_protocol(torch, project_match) -> dict:
    """``bench_variants.py``'s ``lc`` (``run_mono(True)``): the orbit, seed 3,
    195 frames, ``kf_every`` 5, loop closing on, per frame to the gate and
    chunks of 15 to frame 105, then the timed chunks to 195."""
    from orb_slam3_ros_tpu_torch.models import loop_closing, system
    from orb_slam3_ros_tpu_torch.utils import synth

    n_frames, warm = LC_FRAMES
    seq = synth.make_sequence(n_frames=n_frames, height=H, width=W, dt=0.1, seed=3)
    slam = make_slam(seq, "cuda", transfer_uint8=True, enable_loop_closing=True, kf_every=5)
    slam._sched_lean = BENCH_LEAN
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)
    handed, check_ms, closure_ms, gba_ms = [], [], [], []  # per call, host clock
    lc = slam.loop_closer
    batch, apply, dispatch = lc.try_close_batch, lc._apply_closure, slam._dispatch_gba_chunk

    def counted_batch(s, kfs, *a, **kw):
        handed.append(list(kfs))
        t1 = time.perf_counter()
        out = batch(s, kfs, *a, **kw)
        check_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    def timed_apply(*a, **kw):
        t1 = time.perf_counter()
        out = apply(*a, **kw)
        closure_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    def timed_dispatch():
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t1 = time.perf_counter()
        a.record()
        dispatch()
        b.record()
        gba_ms.append(((time.perf_counter() - t1) * 1e3, a, b))

    pgo_ms, pgo_fn = [], loop_closing._essential_graph_pgo

    def timed_pgo(*a, **kw):  # ended by a sync: the solve's device time included
        t1 = time.perf_counter()
        out = pgo_fn(*a, **kw)
        torch.cuda.synchronize()
        pgo_ms.append((time.perf_counter() - t1) * 1e3)
        return out

    lc.try_close_batch, lc._apply_closure = counted_batch, timed_apply
    slam._dispatch_gba_chunk = timed_dispatch
    loop_closing._essential_graph_pgo = timed_pgo
    i = 0
    while (slam.state != system.OK or not slam._chunkable()) and i < warm - CHUNK:
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    while i + CHUNK <= warm:
        slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK])
        i += CHUNK
    while i < warm:
        slam.process_frame(seq.images[i], float(seq.timestamps[i]))
        i += 1
    slam.flush()
    runner = slam._mono_runner
    check(runner is not None and runner.graphs, "the lc chunks did not run on graphs")
    torch.cuda.reset_peak_memory_stats()
    runner.timing = True
    runner.spans, runner.gaps_s = [], []
    runs0, handed0, closure0, gba0_n = dict(runner.runs), len(handed), len(closure_ms), len(gba_ms)
    check0, pgo0 = len(check_ms), len(pgo_ms)
    closures0, gba0 = len(slam.loop_closer.closures), dict(slam.gba_counts)
    reset_launches(project_match)
    chunk_ms = []
    start = i

    def timed():
        nonlocal i
        while i + CHUNK <= n_frames:
            t1 = time.perf_counter()
            slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK])
            chunk_ms.append((time.perf_counter() - t1) * 1e3)
            i += CHUNK
        slam.flush()

    t0 = time.perf_counter()
    try:
        n_sync = sync_calls(torch, timed)
        torch.cuda.synchronize()
    finally:
        loop_closing._essential_graph_pgo = pgo_fn
    wall = time.perf_counter() - t0
    runner.timing = False
    launches = dict(project_match.LAUNCHES)
    kf_timed = runner.runs["kf_insert"] - runs0.get("kf_insert", 0)
    checks = [k for k in handed[handed0:] if k]  # the boundaries with new keyframes
    check(sum(len(k) for k in checks) == kf_timed,
          f"the closer saw {sum(len(k) for k in checks)} of the {kf_timed} keyframes the timed "
          "chunks inserted")
    check(slam.gba_counts["started"] == slam.gba_counts["finished"],
          f"global BAs started / folded in: {slam.gba_counts}")
    spans, kf_graph_ms, busy, step_ms, gap_us, _ = replay_stats(runner, chunk_ms, max(1, kf_timed))
    timed_frames = i - start
    fps = timed_frames / wall
    gba = {k: slam.gba_counts[k] - gba0[k] for k in gba0}
    closures = slam.loop_closer.closures[closures0:]
    peak = torch.cuda.max_memory_allocated()
    checks_ms = [m for m, k in zip(check_ms[check0:], handed[handed0:]) if k]
    closure_ms, pgo_ms = closure_ms[closure0:], pgo_ms[pgo0:]
    gba_host = [h for h, _, _ in gba_ms[gba0_n:]]
    gba_span = [a.elapsed_time(b) for _, a, b in gba_ms[gba0_n:]]
    print(f"loop (b) lc protocol: {timed_frames} timed frames {start}..{i - 1}: {fps:.2f} frames/s "
          f"(flush included), chunk latency median {np.median(chunk_ms):.2f} ms; closures in the "
          f"timed window {closures} (all {slam.loop_closer.closures}); global BA in the window "
          f"{gba}; the closer checked {len(checks)} boundaries with "
          f"{kf_timed} new keyframes; K1 launches {launches}; synchronizing calls {n_sync} "
          f"({n_sync / timed_frames:.2f} a frame); the closer's check {np.median(checks_ms):.1f} ms "
          f"median over {len(checks_ms)} boundaries (host clock, closures included); each closure "
          f"{[round(x, 1) for x in closure_ms]} ms (PGO, weld, first GBA dispatch, point stats), "
          f"of it the essential-graph PGO {[round(x, 1) for x in pgo_ms]} ms; "
          f"GBA dispatches: host {[round(x, 1) for x in gba_host]} ms, CUDA-event span "
          f"{[round(x, 1) for x in gba_span]} ms; step graph {step_ms:.2f} ms; graphs busy "
          f"{busy:.1%} of the chunks' wall time (loop closing and the global BA are outside the "
          f"graphs); peak device memory {peak / 2**20:.1f} MiB")
    return dict(timed_frames=timed_frames, frames_per_s=fps, chunk_ms=chunk_ms,
                closures_timed=closures, closures=slam.loop_closer.closures, gba_timed=gba,
                boundaries_checked=len(checks), keyframes_timed=kf_timed,
                launches=launches, syncs=n_sync, step_ms=step_ms, busy=busy,
                check_ms=checks_ms, closure_ms=closure_ms, pgo_ms=pgo_ms, gba_host_ms=gba_host,
                gba_span_ms=gba_span, peak_mem_mib=peak / 2**20)


def phase_loop_vi(torch, project_match, vc: dict) -> dict:
    """Phase 13: ``bench_variants.py``'s ``vi+lc`` (``run_vi(True)``): phase
    8's calibration and settings with loop closing, 255 frames, the closer's
    covisibility exclusion off, per frame to the gate and chunks of 15 to
    frame 150, then the timed chunks."""
    from orb_slam3_ros_tpu_torch.models import inertial_system, system
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SLAM_KW, vi_calib

    n_frames, warm = VI_LC_FRAMES
    seq, im = vi_sequence(n_frames)
    slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(),
                                        enable_loop_closing=True, **VI_SLAM_KW)
    slam.loop_closer.use_covisibility = False
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)

    def chunk(i):
        slam.process_frames((stack, i), seq.timestamps[i : i + CHUNK], acc=im["acc"][i : i + CHUNK],
                            gyro=im["gyro"][i : i + CHUNK], dts=im["dts"][i : i + CHUNK])

    reset_launches(project_match)
    i = 0
    while i < warm - 2 * CHUNK and not slam._vi_chunkable():
        slam.process_frame(seq.images[i], float(seq.timestamps[i]), acc=im["acc"][i],
                           gyro=im["gyro"][i], dts=im["dts"][i])
        i += 1
    while i + CHUNK <= warm:
        chunk(i)
        i += CHUNK
    start, closures0, gba0 = i, len(slam.loop_closer.closures), dict(slam.gba_counts)
    t0 = time.perf_counter()
    while i + CHUNK <= n_frames:
        chunk(i)
        i += CHUNK
    slam.flush()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    acc = vi_accuracy(slam, seq, im, n_frames)
    lc = slam.loop_closer
    runner = slam._vi_runner
    fps = (i - start) / wall
    gba = {k: slam.gba_counts[k] - gba0[k] for k in gba0}
    print(f"loop vi+lc: {i - start} timed frames {start}..{i - 1}: {fps:.2f} frames/s (flush "
          f"included); closures {lc.closures} ({len(lc.closures) - closures0} in the timed "
          f"window); global BAs {slam.gba_counts} ({gba} in the window); metric ATE "
          f"{acc['ate_metric_m']:.5f} m (phase 9: {vc['ate_metric_m']:.5f} m, "
          f"{acc['ate_metric_m'] / vc['ate_metric_m']:.2f} times), scale "
          f"{acc['scale']:.5f}; {runner and runner.n_graphs} graphs captured; K1 launches "
          f"{launches}; state {slam.state}, bad-IMU resets {slam.bad_imu_resets}")
    check(len(lc.closures) >= 1, "no loop closure fired in the vi+lc run")
    # Held to phases 8 and 9's metric ATE limit, the ratio to phase 9's
    # printed: the closures this protocol forces (covisible candidates
    # allowed, on a map that has not drifted) each add their Sim(3) fit's
    # error, and how much depends on how many chunks a global BA spans
    # (1.92 to 2.55 times phase 9's measured on the card, PERF.md); the JAX
    # package, run on the CPU through this protocol, ends at 7.40 m.
    check(acc["ate_metric_m"] <= VI_ATE_LIMIT,
          f"vi+lc metric ATE {acc['ate_metric_m']:.5f} m above {VI_ATE_LIMIT} m "
          f"({acc['ate_metric_m'] / vc['ate_metric_m']:.2f} times phase 9's)")
    check(slam.state == system.OK and slam.bad_imu_resets == 0,
          f"vi+lc ended in state {slam.state} with {slam.bad_imu_resets} bad-IMU resets")
    check(slam.gba_counts["started"] == slam.gba_counts["finished"],
          f"inertial global BAs started / folded in: {slam.gba_counts}")
    check(launches["sim3"] == lc.sim3_searches,
          f"{launches['sim3']} SearchBySim3 launches, the closer made {lc.sim3_searches}")
    return dict(timed_frames=i - start, frames_per_s=fps, closures=lc.closures,
                ate_ratio_to_phase9=acc["ate_metric_m"] / vc["ate_metric_m"],
                closures_timed=len(lc.closures) - closures0, gba=slam.gba_counts, gba_timed=gba,
                graphs=runner and runner.n_graphs, launches=launches,
                sim3_searches=lc.sim3_searches, **acc)


def atlas_steps(torch, seq):
    """Phase 14 (a)'s timeline: (timestamps, the sequence frame of each step
    or None for a blank frame, the steps' float32 images on the card, which
    the per-frame path takes as the JAX runs of the scenario do, and their
    uint8 stack, which the chunks take)."""
    n = len(seq.timestamps)
    frames = list(range(ATLAS_MAP)) + [None] * ATLAS_BLANK + list(range(ATLAS_MAP, n))
    tss = float(seq.timestamps[0]) + 0.1 * np.arange(len(frames))
    imgs = seq.images.to(torch.float32)
    blank = torch.zeros((ATLAS_BLANK,) + tuple(imgs.shape[1:]), dtype=imgs.dtype, device=imgs.device)
    steps = torch.cat([imgs[:ATLAS_MAP], blank, imgs[ATLAS_MAP:]])
    return tss, frames, steps, torch.clamp(steps, 0, 255).to(torch.uint8)


def atlas_ate(slam, seq, tss, frames, ts0: float):
    """Sim(3) ATE of the frames logged from ``ts0`` on, against the ground
    truth of the frames the steps showed."""
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    shown = [s for s, f in enumerate(frames) if f is not None]
    traj = [(t, T) for t, T in slam.get_trajectory() if t >= ts0 - 1e-6]
    rmse, n, _ = ate_rmse(np.asarray([t for t, _ in traj]), np.stack([T[:3, 3] for _, T in traj]),
                          tss[shown], seq.t_wc[[frames[s] for s in shown]], with_scale=True)
    return rmse, n


def count_atlas(slam, events: dict) -> None:
    """Count the switches and welds of ``slam``'s Atlas in ``events``, and
    list each weld attempt there as (``events["frame"]`` when it was made,
    whether it held)."""
    atlas = slam.atlas
    reloc, merge = atlas.try_relocalize_in_archived, atlas.merge_current_into

    def switch(*a, **k):
        ok = reloc(*a, **k)
        events["switch"] += bool(ok)
        return ok

    def weld(*a, **k):
        ok = merge(*a, **k)
        events["weld"] += bool(ok)
        events["attempts"].append((events["frame"], bool(ok)))
        return ok

    atlas.try_relocalize_in_archived, atlas.merge_current_into = switch, weld


def phase_atlas(torch, project_match, seq) -> dict:
    """Phase 14: the Atlas on the card (see the module docstring). ``seq``:
    phase 7's sequence."""
    from orb_slam3_ros_tpu_torch.models import system
    from orb_slam3_ros_tpu_torch.utils import checkpoint

    tss, frames, images, stack = atlas_steps(torch, seq)
    kw = dict(kf_every=3, enable_atlas=True, lost_patience=3, transfer_uint8=True)
    slam = make_slam(seq, "cuda", **kw)
    ev = {"switch": 0, "weld": 0, "attempts": [], "frame": None}
    count_atlas(slam, ev)
    t0 = time.perf_counter()
    reset_launches(project_match)
    watch = ProgramWatch(torch, project_match, "atlas (a), (b)").__enter__()
    with SearchRecorder(project_match, "merge") as rec:
        for s in range(ATLAS_MAP + ATLAS_BLANK):
            slam.process_frame(images[s], float(tss[s]))
            if s == ATLAS_MAP - 1:
                kf_before = slam.n_kf
        archived = len(slam.atlas.maps)
        s, end, back, path, tracked_at = ATLAS_MAP + ATLAS_BLANK, ATLAS_END + ATLAS_BLANK, None, None, None
        while s < end:
            chunked = slam.state == system.OK and slam._chunkable() and s + CHUNK <= end
            maps0 = len(slam.atlas.maps)
            ev["frame"] = frames[s + CHUNK - 1] if chunked else frames[s]
            if chunked:
                slam.process_frames((stack, s), tss[s : s + CHUNK])
                s += CHUNK
            else:
                if slam.process_frame(images[s], float(tss[s])) is not None and tracked_at is None:
                    tracked_at = frames[s]
                s += 1
            if maps0 and not slam.atlas.maps and back is None:
                back, path = frames[s - 1], "chunk boundary" if chunked else "per keyframe"
                back_ts = float(tss[s])
        slam.flush()
    torch.cuda.synchronize()
    a_s = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    route = "switch" if ev["switch"] else "weld" if ev["weld"] else None
    traj = slam.get_trajectory()
    finite = all(np.isfinite(T).all() for _, T in traj)
    rmse, n_ate = atlas_ate(slam, seq, tss, frames, back_ts) if back is not None else (np.inf, 0)
    print(f"atlas (a): {kf_before} keyframes before the blackout, {archived} map(s) archived at it; "
          f"tracking again at frame {tracked_at}; the archived map back at frame {back} by "
          f"{route} ({path}; the JAX runs: {ATLAS_JAX['route']} at frames {ATLAS_JAX['back_at']}); "
          f"weld attempts (frame, held) {ev['attempts']}; "
          f"state {slam.state}, {len(slam.atlas.maps)} maps left, {slam.n_kf} keyframes; Sim(3) "
          f"ATE after the return {rmse:.5f} m over {n_ate} poses; K1 launches {launches}, "
          f"{slam.atlas.grow_searches} cross-map searches; {a_s:.1f} s")
    check(kf_before >= 8 and archived == 1,
          f"atlas (a): {kf_before} keyframes before the blackout, {archived} maps archived")
    att = ev["attempts"]
    gap = back - tracked_at if back is not None and tracked_at is not None else None
    check(route == ATLAS_JAX["route"] and gap is not None and abs(gap - ATLAS_JAX["weld_after"]) <= 2,
          f"atlas (a): the archived map back at frame {back} by {route}, {gap} frames after "
          f"tracking again at frame {tracked_at} (weld attempts {att}); the JAX runs: "
          f"{ATLAS_JAX['route']}, {ATLAS_JAX['weld_after']} frames after")
    check(slam.state == system.OK and not slam.atlas.maps and finite,
          f"atlas (a): state {slam.state}, {len(slam.atlas.maps)} maps left, finite {finite}")
    check(rmse <= MAP_ATE_LIMIT, f"atlas (a): Sim(3) ATE after the return {rmse:.5f} m")
    check(launches["merge"] == slam.atlas.grow_searches >= 1,
          f"atlas (a): {launches['merge']} merge launches, {slam.atlas.grow_searches} searches")
    a = dict(kf_before=kf_before, archived=archived, tracked_at=tracked_at, back_at=back, route=route,
             weld_path=path, weld_attempts=att, ate_sim3_m=rmse, ate_poses=n_ate, keyframes=slam.n_kf,
             grow_searches=slam.atlas.grow_searches, launches=launches, run_s=a_s)

    # (b) a second session from the checkpoint of (a)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_atlas_")
    try:
        path_ck = os.path.join(tmp, "session")
        digest = checkpoint.save_atlas(path_ck, slam)
        s2 = make_slam(seq, "cuda", **kw)
        checkpoint.load_atlas(path_ck, s2)
        n_kf0 = s2.n_kf
        s2.state = system.LOST
        reset_launches(project_match)
        reloc_at = None
        for i in range(ATLAS_B_START, len(seq.timestamps)):
            st = i + ATLAS_BLANK
            if s2.process_frame(images[st], float(tss[st])) is not None and reloc_at is None:
                reloc_at = i
        s2.flush()
        torch.cuda.synchronize()
        b_launches = dict(project_match.LAUNCHES)
        rmse_b, n_b = atlas_ate(s2, seq, tss, frames, float(tss[ATLAS_B_START + ATLAS_BLANK]))
        raw = bytearray(open(path_ck + ".npz", "rb").read())
        raw[len(raw) // 2] ^= 0xFF
        bad = os.path.join(tmp, "corrupt")
        open(bad + ".npz", "wb").write(bytes(raw))
        shutil.copy(path_ck + ".json", bad + ".json")
        try:
            checkpoint.load_atlas(bad, make_slam(seq, "cuda", **kw))
            raised = False
        except ValueError:
            raised = True
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        watch.__exit__()
    b_s = time.perf_counter() - t0
    kfw = watch.report(mono=True)  # (a)'s and (b)'s keyframes
    print(f"atlas (b): session saved (md5 {digest}) and loaded, {n_kf0} keyframes; relocalized at "
          f"frame {reloc_at} (the JAX run: {ATLAS_JAX['reloc_at']}), {s2.n_kf} keyframes at the end, "
          f"state {s2.state}; Sim(3) ATE {rmse_b:.5f} m over {n_b} poses; K1 launches "
          f"{b_launches}; a corrupted copy raised: {raised}; {b_s:.1f} s")
    check(reloc_at is not None and reloc_at <= ATLAS_B_START + 2,
          f"atlas (b): relocalized at {reloc_at}")
    check(s2.state == system.OK and s2.n_kf > n_kf0, f"atlas (b): state {s2.state}, keyframes "
          f"{n_kf0} -> {s2.n_kf}")
    check(rmse_b <= MAP_ATE_LIMIT, f"atlas (b): Sim(3) ATE {rmse_b:.5f} m")
    check(raised, "atlas (b): a corrupted checkpoint loaded")
    b = dict(reloc_at=reloc_at, n_kf_loaded=n_kf0, n_kf_end=s2.n_kf, ate_sim3_m=rmse_b, ate_poses=n_b,
             launches=b_launches, run_s=b_s,
             kf_program={k: v for k, v in kfw.items() if k.startswith("mkf_")})
    c = phase_atlas_vi(torch, project_match)

    # the merge site's searches against the plain version, and their times
    check(rec.args is not None, "atlas: no cross-map search input was recorded")
    err, n_match = kernel_vs_plain(torch, project_match, rec.args, rec.kw, "the merge site")
    args = search_inputs(12, N_SLOTS, N_SLOTS, 10.0)
    merge_kw = dict(max_dist=100, ratio=1.0)
    err2, n_match2 = kernel_vs_plain(torch, project_match, args, merge_kw, "a merge-shaped case")
    check(n_match2 > 50, "the merge-shaped case matched too little to mean anything")
    kernel = lambda: project_match.project_match(*rec.args, **rec.kw)  # noqa: E731
    k_ms = cuda_ms(kernel, 100)
    plain_ms = cuda_ms(lambda: project_match.project_match_reference(*rec.args, **rec.kw), 100)
    dev_us = device_us(kernel)
    bound = search_bound(torch, project_match, rec.args, rec.kw)
    print(f"atlas merge site: kernel vs plain at P={rec.args[0].shape[0]} N={rec.args[5].shape[0]} "
          f"{rec.kw}: max |diff| {err}, {n_match} matches; merge-shaped case P=N={N_SLOTS}: max "
          f"|diff| {err2}, {n_match2} matches; call {k_ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} "
          f"us, device {dev_us:.2f} us, bound {bound['bound_us']:.3f} us by {bound['bound_by']}")
    launches = {k: a["launches"][k] + b["launches"][k] + c["launches"][k] for k in a["launches"]}
    return dict(a=a, b=b, c=c, launches=launches, merge_max_abs_err=max(err, err2),
                merge_matches=n_match, merge_ms=k_ms, merge_plain_ms=plain_ms,
                merge_device_us=dev_us, merge_bound_us=bound["bound_us"],
                merge_bound_by=bound["bound_by"])


def phase_atlas_vi(torch, project_match) -> dict:
    """Phase 14 (c): ``tests/test_atlas.py``'s inertial weld at phase 8's
    configuration."""
    from orb_slam3_ros_tpu_torch.models import atlas as atlas_mod
    from orb_slam3_ros_tpu_torch.models import inertial_system, system
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW, VI_SLAM_KW, vi_calib

    seq, im = vi_sequence(VI_SEQ_KW["n_frames"])
    slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(),
                                        enable_atlas=True, **VI_SLAM_KW)

    def run(i):
        slam.process_frame(seq.images[i], float(seq.timestamps[i]), acc=im["acc"][i],
                           gyro=im["gyro"][i], dts=im["dts"][i])

    t0 = time.perf_counter()
    reset_launches(project_match)
    for i in range(ATLAS_C_SPLIT):
        run(i)
    init1, kf1 = slam.imu_initialized, slam.n_kf
    slam._freeze_rel_traj()
    archived = slam.atlas.archive_current(slam)
    held, slam.atlas.maps = slam.atlas.maps, []  # no weld before map 2's IMU is initialized
    i = ATLAS_C_SPLIT
    while i < ATLAS_C_INIT_BY and not (slam.imu_initialized and slam.state == system.OK):
        run(i)
        i += 1
    init2_at, kf2 = i - 1, slam.n_kf
    slam.atlas.maps = held
    scales = []
    transform = atlas_mod._transform_map

    def kept(m, Rw, tw, sw):
        scales.append(float(sw))
        return transform(m, Rw, tw, sw)

    atlas_mod._transform_map = kept
    try:
        slam._freeze_rel_traj()
        welded = slam.atlas.merge_current_into(slam, 0)
    finally:
        atlas_mod._transform_map = transform
    m = slam.map
    kv = m.kf_valid.cpu().numpy()
    R, t, kts, v = (x.cpu().numpy()[kv] for x in (m.kf_R, m.kf_t, m.kf_ts, m.kf_v))
    finite = bool(np.isfinite(R).all() and np.isfinite(t).all() and np.isfinite(v).all())
    pos = -np.einsum("kji,kj->ki", R, t)
    ate_kf, n_kf_ate, _ = ate_rmse(kts.astype(np.float64), pos, seq.timestamps.astype(np.float64),
                                   seq.t_wc, with_scale=False)
    breaks = sorted(slam.chain_breaks)
    states = []
    for j in range(i, i + ATLAS_C_AFTER):
        run(j)
        states.append(slam.state)
    torch.cuda.synchronize()
    c_s = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    print(f"atlas (c): map 1 {kf1} keyframes, IMU initialized {init1}, archived {archived}; map 2 "
          f"IMU-initialized at frame {init2_at} with {kf2} keyframes; weld {welded} at scale "
          f"{scales[-1] if scales else None}, chain breaks {breaks}, {slam.n_kf} keyframes; metric "
          f"keyframe ATE {ate_kf:.5f} m over {n_kf_ate} (the JAX run {ATLAS_JAX['c_ate_m']:.5f} m); "
          f"states after {states}; K1 launches {launches}, {slam.atlas.grow_searches} cross-map "
          f"searches; {c_s:.1f} s")
    check(init1 and archived and slam.imu_initialized, "atlas (c): a map was not IMU-initialized")
    check(welded and scales == [1.0], f"atlas (c): weld {welded} at scales {scales}")
    check(kf1 in slam.chain_breaks, f"atlas (c): the seam {kf1} is not a chain break: {breaks}")
    check(finite, "atlas (c): the welded map holds non-finite poses or velocities")
    check(ate_kf <= 2 * ATLAS_JAX["c_ate_m"],
          f"atlas (c): metric keyframe ATE {ate_kf:.5f} m above 2x the JAX run's")
    check(states == [system.OK] * ATLAS_C_AFTER, f"atlas (c): states after the weld {states}")
    check(launches["merge"] == slam.atlas.grow_searches >= 1,
          f"atlas (c): {launches['merge']} merge launches, {slam.atlas.grow_searches} searches")
    return dict(map1_kf=kf1, map2_init_at=init2_at, map2_kf=kf2, scale=scales[-1],
                chain_breaks=breaks, keyframes=slam.n_kf, ate_metric_kf_m=ate_kf,
                ate_keyframes=n_kf_ate, states_after=states, launches=launches, run_s=c_s)


def stereo_accuracy(slam, seq, skip: int = 0) -> dict:
    """Poses, the metric ATE (no scale alignment) over the poses after the
    first ``skip`` and the scale of a Sim(3) fit."""
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    traj = slam.get_trajectory()
    ts = np.asarray([t for t, _ in traj])[skip:]
    est = np.stack([T[:3, 3] for _, T in traj])[skip:]
    gt_ts = seq.timestamps.astype(np.float64)
    metric, n, _ = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=False)
    _, _, scale = ate_rmse(ts, est, gt_ts, seq.t_wc, with_scale=True)
    return dict(poses=len(traj), scored=int(n), ate_metric_m=float(metric), scale=float(scale))


def check_stereo_accuracy(acc: dict, jax_ate: float, frames: int, what: str,
                          scale_tol: float) -> None:
    check(acc["poses"] == frames, f"{what}: {acc['poses']} poses for {frames} frames")
    check(acc["ate_metric_m"] <= 2 * jax_ate,
          f"{what}: metric ATE {acc['ate_metric_m']:.5f} m above 2x the JAX run's {jax_ate:.5f} m")
    check(abs(acc["scale"] - 1.0) <= scale_tol, f"{what}: Sim(3) scale {acc['scale']:.5f}")


def per_frame_run(step, frames, first: list, lost: list) -> None:
    """Frames ``frames`` through ``step(i)`` (a system's process_frame);
    records the first frame with a pose and every later one without."""
    for i in frames:
        out = step(i)
        if out is not None and not first:
            first.append(i)
        elif out is None and first:
            lost.append(i)


def phase_stereo_chunk(torch, project_match) -> tuple:
    """Phase 15 (a): ``scripts/bench_variants.py::run_stereo``'s protocol on
    the card through ``StereoSlam.process_frames``, the step and keyframe
    segments as CUDA graphs. Returns (result, the sequence)."""
    from orb_slam3_ros_tpu_torch.models import device_loop, system
    from orb_slam3_ros_tpu_torch.models.stereo_system import StereoSlam
    from orb_slam3_ros_tpu_torch.utils import synth

    t0 = time.perf_counter()
    seq = synth.make_sequence(n_frames=ST_FRAMES, height=ST_H, width=ST_W, dt=0.1, seed=3,
                              stereo_baseline=ST_BASE, with_depth=True)
    slam = StereoSlam(height=ST_H, width=ST_W, cam_params=seq.cam_params, baseline=ST_BASE,
                      **ST_SLAM_KW)
    check(slam.device.type == "cuda", "StereoSlam without a device argument is not on the card")
    slam._sched_lean = BENCH_LEAN
    pairs = torch.clamp(torch.stack([seq.images, seq.images_right], 1), 0, 255).to(torch.uint8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eager_steps, calls, first, lost = [], [], [], []
    step_fn, per_frame = device_loop.frame_step, slam.process_frame

    def counted_step(*args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            eager_steps.append(1)
        return step_fn(*args, **kw)

    def counted_frame(*args, **kw):
        calls.append(1)
        return per_frame(*args, **kw)

    def frame(i):
        return slam.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]))

    def chunk(i):
        slam.process_frames((pairs, i), seq.timestamps[i : i + CHUNK])

    device_loop.frame_step = counted_step
    torch.cuda.reset_peak_memory_stats()
    reset_launches(project_match)
    try:
        t0 = time.perf_counter()
        i = 0
        while (slam.state != system.OK or not slam._chunkable()) and i < ST_WARM - CHUNK:
            per_frame_run(frame, [i], first, lost)
            i += 1
        i_steady = i
        while i + CHUNK <= ST_WARM:
            chunk(i)
            i += CHUNK
        per_frame_run(frame, range(i, ST_WARM), first, lost)
        i = ST_WARM
        warm_s = time.perf_counter() - t0
        runner = slam._mono_runner
        check(runner is not None and runner.graphs, "the stereo chunks did not run on graphs")
        check(runner.stereo, "the stereo system's chunks did not take the stereo branch")
        slam.process_frame = counted_frame
        runner.timing = True
        runner.spans, runner.gaps_s = [], []
        launches_warm = dict(project_match.LAUNCHES)
        reset_launches(project_match)
        runs0, warm0 = dict(runner.runs), dict(runner.warmup_launches)
        chunk_ms = []

        def timed_chunks():
            nonlocal i
            while i + CHUNK <= ST_FRAMES:
                t1 = time.perf_counter()
                chunk(i)  # ends in the chunk's host read
                chunk_ms.append((time.perf_counter() - t1) * 1e3)
                i += CHUNK

        n_sync = sync_calls(torch, timed_chunks)
        torch.cuda.synchronize()
        runner.timing = False
        launches = dict(project_match.LAUNCHES)
    finally:
        device_loop.frame_step = step_fn
        slam.process_frame = per_frame
    peak = torch.cuda.max_memory_allocated()
    timed = i - ST_WARM
    runs = {k: runner.runs[k] - runs0.get(k, 0) for k in runner.runs}
    warm = {k: runner.warmup_launches[k] - warm0[k] for k in warm0}
    step_runs = sum(v for k, v in runs.items() if isinstance(k, tuple))
    fusing, n_kf_timed = runs.get("kf_fuse", 0), runs.get("kf_insert", 0)
    passes = len(slam._sched_lean)
    predicted = {"track": passes * timed + warm["track"], "fuse": 2 * fusing + warm["fuse"],
                 "sim3": 0, "merge": 0}
    check(first and first[0] == 0, f"stereo initialized at frame {first[:1]}, not frame 0")
    check(not lost, f"frames without a pose: {lost}")
    check(not calls, f"{len(calls)} frames went through process_frame during the timed chunks")
    check(step_runs == timed, f"{step_runs} step-graph replays for {timed} timed frames")
    n_step_graphs = sum(isinstance(k, tuple) for k in runner._graph)
    check(len(eager_steps) == n_step_graphs,
          f"{len(eager_steps)} eager steps on the card, expected one warm-up for each of "
          f"{n_step_graphs} step graphs")
    check(launches == predicted, f"matcher launches {launches}, predicted {predicted} ({passes} x "
          f"{timed} from tracking, 2 x {fusing} from fusion, plus warm-ups {warm})")
    check(slam.state == system.OK, f"state {slam.state} after the chunks")
    acc = stereo_accuracy(slam, seq)
    check_stereo_accuracy(acc, ST_JAX["a_ate_m"], ST_FRAMES, "stereo chunks", ST_SCALE_TOL)
    spans, kf_graph_ms, busy, step_ms, gap_us, nodes = replay_stats(runner, chunk_ms, n_kf_timed)
    fps = timed / (sum(chunk_ms) / 1e3)
    worst = graph_vs_eager(torch, runner, slam._sched_lean)
    audit = region_syncs(torch, runner, slam._sched_lean)
    check(not any(audit.values()), f"synchronizing calls in the eager regions: {audit}")
    print(f"stereo chunk (a): {ST_W}x{ST_H} pairs, {slam.N} feature slots, rendered in "
          f"{setup_s:.1f} s; initialized at frame {first[0]}, chunkable at frame {i_steady}; "
          f"{runner.n_graphs} graphs captured in {runner.capture_s:.2f} s (nodes {nodes}), up to "
          f"frame {ST_WARM} in {warm_s:.2f} s; timed frames {ST_WARM}..{i - 1}: {fps:.2f} frames/s, "
          f"chunk latency median {np.median(chunk_ms):.2f} ms over {len(chunk_ms)} chunks of "
          f"{CHUNK}; step graph {step_ms:.2f} ms median over {len(spans['step'])} replays; "
          f"keyframe graphs {kf_graph_ms:.2f} ms a keyframe over {n_kf_timed} "
          f"({ {k: round(float(np.median(v)), 3) for k, v in spans.items()} } ms medians); busy "
          f"{busy:.1%}; host gap {gap_us:.1f} us mean, "
          f"{float(np.median(runner.gaps_s)) * 1e6:.1f} us median (a segment's first capture "
          f"falls in the gap); K1 launches {launches} = predicted "
          f"(passes {passes}, fusing keyframes {fusing}, warm-ups {warm}), before the timed "
          f"chunks {launches_warm}; metric ATE {acc['ate_metric_m']:.5f} m (JAX package, CPU: "
          f"{ST_JAX['a_ate_m']:.5f} m), Sim(3) scale {acc['scale']:.5f}; {slam.n_kf} keyframes, "
          f"{slam.n_pts} points; graph vs eager step max diff {worst:.3g}; synchronizing calls "
          f"{n_sync} over the {timed} timed frames, {audit} in each region run eagerly; peak "
          f"device memory {peak / 2**20:.1f} MiB")
    total = {k: launches[k] + launches_warm[k] for k in launches}
    return dict(init_frame=first[0], chunkable_frame=i_steady, graphs=runner.n_graphs,
                graph_nodes=nodes, capture_s=runner.capture_s, timed_frames=timed,
                frames_per_s=fps, frame_ms=float(np.median(chunk_ms)) / CHUNK, step_ms=step_ms,
                kf_graph_ms=kf_graph_ms,
                segment_ms={k: float(np.median(v)) for k, v in spans.items()}, busy=busy,
                gap_us=gap_us, launches=total, timed_launches=launches,
                predicted_launches=predicted, fusing_keyframes=fusing, keyframes=slam.n_kf,
                graph_vs_eager=worst, syncs_per_frame=n_sync / timed, region_syncs=audit,
                peak_mem_mib=peak / 2**20, **acc), seq


def stereo_bound_us(fl, fr, il, ir) -> dict:
    """The least time the card could take for ``match_stereo``: every input
    read once and every output (u_r and depth f32, valid bool) written once
    at the HBM rate, against the int8 operations of the dense Hamming
    product (NL x NR x 256 multiply-adds) at the tensor-core rate."""
    ins = (fl.xy, fl.level, fl.valid, fl.desc_sign, fr.xy, fr.level, fr.valid, fr.desc_sign,
           il, ir)
    n_bytes = sum(t.numel() * t.element_size() for t in ins) + fl.xy.shape[0] * 9
    by_bytes = n_bytes / HBM_BYTES_PER_S * 1e6
    by_ops = fl.xy.shape[0] * fr.xy.shape[0] * 256 * 2 / INT8_OPS_PER_S * 1e6
    return dict(bound_us=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations", bytes=n_bytes)


def phase_stereo_kernels(torch, project_match, seq) -> dict:
    """Phase 15 (b): K1 at the KITTI shape (768 rows x the 2040 feature
    slots of 2000 features, both radii of the lean schedule, ties planted
    on its split boundaries) against its plain version, exact, then timed;
    ``match_stereo`` on the sequence's first pair, its matches' depth held
    to the rendered depth, timed; the stereo front-end program on that pair,
    its replay against the eager front end."""
    from orb_slam3_ros_tpu_torch.models import front_end_program
    from orb_slam3_ros_tpu_torch.ops import orb, stereo

    cfg = orb.default_config(ST_H, ST_W, n_features=ST_SLAM_KW["n_features"])
    n = cfg.total_cap
    check(n == ST_SLOTS, f"{n} feature slots at the KITTI shape, expected {ST_SLOTS}")
    k = phase_kernel(torch, project_match, P_TRACK, 60.0, 50, n=n, width=ST_W, height=ST_H)
    k4 = phase_kernel(torch, project_match, P_TRACK, 4.0, 50, n=n, width=ST_W, height=ST_H)
    il, ir = seq.images[0], seq.images_right[0]
    fl, fr = orb.extract(il, cfg), orb.extract(ir, cfg)
    fx = float(seq.cam_params[0])

    def fn():
        return stereo.match_stereo(fl, fr, il, ir, fx=fx, baseline=ST_BASE)

    sm = fn()
    valid = sm.valid.cpu().numpy()
    xy = fl.xy.cpu().numpy()[valid]
    d_est = sm.depth.cpu().numpy()[valid]
    dep = seq.depths[0].cpu().numpy()
    d_gt = dep[np.clip(xy[:, 1].astype(int), 0, ST_H - 1), np.clip(xy[:, 0].astype(int), 0, ST_W - 1)]
    rel = np.abs(d_est - d_gt) / d_gt
    med, within = float(np.median(rel)), float((rel < 0.15).mean())
    check(valid.sum() > 100, f"only {valid.sum()} stereo matches")
    check(med <= 0.05 and within >= 0.8,
          f"stereo depth: median relative error {med:.4f}, {within:.1%} within 15%")
    n_sync = sync_calls(torch, fn)
    check(n_sync == 0, f"match_stereo made {n_sync} synchronizing calls")
    ms = cuda_ms(fn, 50)
    dev_us = device_us(fn, 20)
    bound = stereo_bound_us(fl, fr, il, ir)
    # the stereo front end (both extractions and match_stereo) as its
    # program runs it per frame: one capture, then replays of this pair
    fcfg = front_end_program.FrontEndConfig(
        kind="stereo", config=cfg, height=ST_H, width=ST_W,
        cam_params=torch.as_tensor(np.asarray(seq.cam_params, np.float32), device="cuda"),
        cam_model="pinhole", fx=fx, baseline=ST_BASE)
    fprog = front_end_program.FrontEndProgram(fcfg, "cuda")
    with ProgramWatch(torch, project_match, "stereo (b)") as watch:
        for _ in range(FRONT_RUNS):
            fprog.run(il, ir)
    front = watch.report(frames=FRONT_RUNS)
    print(f"match_stereo at {n}x{n} features ({ST_W}x{ST_H}): {int(valid.sum())} matches, depth "
          f"median relative error {med:.4f}, {within:.1%} within 15% of the rendered depth; call "
          f"{ms * 1e3:.1f} us (median of 50, CUDA events), device {dev_us:.1f} us (20 queued calls);"
          f" bound {bound['bound_us']:.3f} us by {bound['bound_by']} ({bound['bytes']} B); "
          f"synchronizing calls 0")
    return dict(k1=k, k1_r4=k4, front=front, stereo_matches=int(valid.sum()),
                stereo_depth_median_rel=med,
                stereo_depth_within_15=within, stereo_ms=ms, stereo_device_us=dev_us,
                stereo_bound_us=bound["bound_us"], stereo_bound_by=bound["bound_by"])


def phase_stereo_vi(torch, project_match) -> dict:
    """Phase 15 (c): ``StereoInertialSlam`` at phase 8's configuration with
    a 0.11 m stereo rig, per frame until ``_vi_chunkable()``, then chunks of
    15 of a uint8 stack of pairs."""
    from orb_slam3_ros_tpu_torch.models import system
    from orb_slam3_ros_tpu_torch.models.stereo_system import StereoInertialSlam
    from orb_slam3_ros_tpu_torch.utils import synth
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW, VI_SLAM_KW, vi_calib

    n_frames = VI_SEQ_KW["n_frames"]
    seq, im = synth.make_vi_sequence(**VI_SEQ_KW, stereo_baseline=SVI_BASE)
    slam = StereoInertialSlam(cam_params=seq.cam_params, calib=vi_calib(), baseline=SVI_BASE,
                              **{**VI_SLAM_KW, "max_points": SVI_MAX_POINTS})
    pairs = torch.clamp(torch.stack([seq.images, seq.images_right], 1), 0, 255).to(torch.uint8)
    first, lost = [], []

    def frame(i):
        return slam.process_frame(seq.images[i], seq.images_right[i], float(seq.timestamps[i]),
                                  acc=im["acc"][i], gyro=im["gyro"][i], dts=im["dts"][i])

    reset_launches(project_match)
    t0 = time.perf_counter()
    calls, per_frame = [], slam.process_frame

    def counted(*args, **kw):
        calls.append(1)
        return per_frame(*args, **kw)

    slam.process_frame = counted
    watch = ProgramWatch(torch, project_match, "stereo-inertial (c)").__enter__()
    i = 0
    while i < n_frames and not slam._vi_chunkable():
        per_frame_run(frame, [i], first, lost)
        i += 1
    per_frame_s, i_steady = time.perf_counter() - t0, i
    check(i_steady <= n_frames - 2 * CHUNK, f"the stereo VI chunk gate held only at frame {i}")
    chunk_ms = []
    while i + CHUNK <= n_frames:
        s = slice(i, i + CHUNK)
        t1 = time.perf_counter()
        slam.process_frames((pairs, i), seq.timestamps[s], acc=im["acc"][s], gyro=im["gyro"][s],
                            dts=im["dts"][s])
        chunk_ms.append((time.perf_counter() - t1) * 1e3)
        if len(chunk_ms) == 1:
            runner = slam._vi_runner
            check(runner is not None and runner.graphs and runner.stereo,
                  "the stereo-inertial chunks did not run on graphs of the stereo branch")
            runner.timing = True
        i += CHUNK
    per_frame_run(frame, range(i, n_frames), first, lost)
    watch.__exit__()
    del slam.process_frame
    torch.cuda.synchronize()
    launches = dict(project_match.LAUNCHES)
    progs = watch.report(frames=len(calls))
    runner.timing = False
    run_s = time.perf_counter() - t0
    steps = [a.elapsed_time(b) for name, a, b in runner.spans if isinstance(name, tuple)]
    nodes = {("step" if isinstance(k, tuple) else k): graph_nodes(g)
             for k, (g, _) in runner._graph.items()}
    fps = (len(chunk_ms) - 1) * CHUNK / (sum(chunk_ms[1:]) / 1e3) if len(chunk_ms) > 1 else None
    acc = vi_accuracy(slam, seq, im, n_frames)
    check(first and first[0] == 0, f"stereo-inertial initialized at frame {first[:1]}")
    check(not lost, f"frames without a pose: {lost}")
    check(slam.imu_initialized and slam.imu_fix_scale and slam.imu_stage == 3,
          f"IMU initialized {slam.imu_initialized}, fix_scale {slam.imu_fix_scale}, stage "
          f"{slam.imu_stage}")
    check(slam.bad_imu_resets == 0, f"{slam.bad_imu_resets} bad-IMU resets")
    check(slam.state == system.OK, f"state {slam.state} at the end")
    check(acc["poses"] == n_frames, f"{acc['poses']} poses for {n_frames} frames")
    limit = min(2 * ST_JAX["c_ate_m"], VI_ATE_LIMIT)
    check(acc["ate_metric_m"] <= limit,
          f"stereo-inertial metric ATE {acc['ate_metric_m']:.5f} m above {limit:.5f} m")
    check(abs(acc["scale"] - 1.0) <= VI_SCALE_TOL, f"stereo-inertial scale {acc['scale']:.5f}")
    check(launches["track"] > 0, "the stereo-inertial run launched no tracking search")
    print(f"stereo-inertial (c): initialized at frame {first[0]}, IMU stage {slam.imu_stage} "
          f"(scale fixed), chunkable at frame {i_steady} after {per_frame_s:.1f} s per frame; "
          f"{len(chunk_ms)} chunks of {CHUNK}, the first {chunk_ms[0]:.0f} ms (graphs captured in "
          f"{runner.capture_s:.2f} s), then {fps:.2f} frames/s; step graph "
          f"{np.median(steps):.2f} ms median over {len(steps)} replays (nodes {nodes}); metric ATE "
          f"{acc['ate_metric_m']:.5f} m (JAX package, CPU: {ST_JAX['c_ate_m']:.5f} m), scale "
          f"{acc['scale']:.5f}, R[2,2] {acc['r22']:.5f}, bg err {acc['bg_err']:.2e}; "
          f"{slam.n_kf} keyframes, {slam.n_pts} of {slam.P_cap} point slots; K1 launches "
          f"{launches}; {run_s:.1f} s")
    return dict(init_frame=first[0], chunkable_frame=i_steady, frames_per_s=fps,
                per_frame_s=per_frame_s, per_frame_per_s=i_steady / per_frame_s,
                programs=progs, step_ms=float(np.median(steps)), graph_nodes=nodes,
                launches=launches,
                imu_stage=slam.imu_stage, resets=slam.bad_imu_resets, seconds=run_s, **acc)


def phase_rgbd(torch, project_match) -> dict:
    """Phase 15 (d): ``RgbdSlam`` at the TUM RGB-D shape and
    ``RgbdInertialSlam`` at that shape with phase 8's IMU, per frame."""
    from orb_slam3_ros_tpu_torch.models.stereo_system import RgbdInertialSlam, RgbdSlam
    from orb_slam3_ros_tpu_torch.utils import synth
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW, VI_SLAM_KW, vi_calib

    out = {}
    shape = dict(height=RGBD_H, width=RGBD_W)
    for name in ("rgbd", "rgbd_vi"):
        reset_launches(project_match)
        t0 = time.perf_counter()
        first, lost = [], []
        watch = ProgramWatch(torch, project_match, name).__enter__()
        if name == "rgbd":
            n = RGBD_FRAMES
            seq = synth.make_sequence(n_frames=n, dt=0.1, seed=3, with_depth=True, **shape)
            slam = RgbdSlam(cam_params=seq.cam_params, **shape, **RGBD_SLAM_KW)
            per_frame_run(lambda i: slam.process_frame(seq.images[i], seq.depths[i],
                                                       float(seq.timestamps[i])),
                          range(n), first, lost)
            acc = stereo_accuracy(slam, seq)
        else:
            n = RGBD_VI_FRAMES
            seq, im = synth.make_vi_sequence(**{**VI_SEQ_KW, "n_frames": n, **shape},
                                             with_depth=True)
            slam = RgbdInertialSlam(cam_params=seq.cam_params, calib=vi_calib(),
                                    **{**VI_SLAM_KW, **shape})
            per_frame_run(lambda i: slam.process_frame(
                seq.images[i], seq.depths[i], float(seq.timestamps[i]), acc=im["acc"][i],
                gyro=im["gyro"][i], dts=im["dts"][i]), range(n), first, lost)
            acc = stereo_accuracy(slam, seq, skip=VI_SKIP)
            check(slam.imu_initialized, "RGB-D-inertial: the IMU was not initialized")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        watch.__exit__()
        launches = dict(project_match.LAUNCHES)
        progs = watch.report(frames=n)
        check(first and first[0] == 0, f"{name} initialized at frame {first[:1]}, not frame 0")
        check(not lost, f"{name}: frames without a pose: {lost}")
        check_stereo_accuracy(acc, ST_JAX[f"d_{name}_ate_m"], n, name, ST_SCALE_TOL)
        check(launches["track"] > 0, f"{name} launched no tracking search")
        print(f"{name} (d): {RGBD_W}x{RGBD_H}, {n} frames per frame in {secs:.1f} s "
              f"({n / secs:.2f} frames/s); initialized at frame {first[0]}; metric ATE "
              f"{acc['ate_metric_m']:.5f} m (JAX package, CPU: {ST_JAX[f'd_{name}_ate_m']:.5f} m), "
              f"Sim(3) scale {acc['scale']:.5f}; {slam.n_kf} keyframes; K1 launches {launches}")
        out[name] = dict(init_frame=first[0], frames_per_s=n / secs, launches=launches,
                         keyframes=slam.n_kf, programs=progs, **acc)
    return out


def phase_stereo(torch, project_match) -> dict:
    """Phase 15: stereo and RGB-D, (a) to (d)."""
    t0 = time.perf_counter()
    a, seq = phase_stereo_chunk(torch, project_match)
    b = phase_stereo_kernels(torch, project_match, seq)
    del seq
    c = phase_stereo_vi(torch, project_match)
    d = phase_rgbd(torch, project_match)
    secs = time.perf_counter() - t0
    launches = {k: sum(x["launches"][k] for x in (a, c, d["rgbd"], d["rgbd_vi"]))
                for k in a["launches"]}
    print(f"phase 15: {secs:.1f} s; K1 launches on its main paths {launches}")
    return dict(a=a, b=b, c=c, d=d, seconds=secs, launches=launches)


def traj_ate(slam, ts, t_wc, with_scale: bool) -> dict:
    """Poses, the ATE (Sim(3) or metric) and the Sim(3) scale of a system's
    trajectory against ground truth (``ts`` [N], ``t_wc`` [N, 3])."""
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse

    traj = slam.get_trajectory()
    tss = np.asarray([t for t, _ in traj])
    est = np.stack([np.asarray(T)[:3, 3] for _, T in traj])
    gt_ts = np.asarray(ts, np.float64)
    sim3, n, scale = ate_rmse(tss, est, gt_ts, np.asarray(t_wc), with_scale=True)
    metric, _, _ = ate_rmse(tss, est, gt_ts, np.asarray(t_wc), with_scale=False)
    return dict(poses=len(traj), scored=int(n), ate_m=float(sim3 if with_scale else metric),
                ate_sim3_m=float(sim3), ate_metric_m=float(metric), scale=float(scale))


def kb8_views(torch, scene, R_wc, t_wc, rig=None, cam=None, h=None, w=None):
    """Frames [n, h, w] of ``scene`` through the KB8 camera ``cam`` (None:
    the TUM-VI shape's, FE_KB8 at FE_H x FE_W) at the poses (R_wc, t_wc),
    rendered on the card; with ``rig`` (R_rl, t_rl) also the right
    camera's (else None)."""
    from orb_slam3_ros_tpu_torch.utils import synth

    cam, h, w = (FE_KB8, FE_H, FE_W) if cam is None else (cam, h, w)

    def view(R, t):
        return synth.render(scene, R, t, cam, height=h, width=w, cam_model="kb8")[0]

    left = torch.stack([view(R_wc[i], t_wc[i]) for i in range(len(t_wc))])
    if rig is None:
        return left, None
    R_rl, t_rl = rig
    right = torch.stack([view(R_wc[i] @ R_rl.T, t_wc[i] + R_wc[i] @ (-R_rl.T @ t_rl))
                         for i in range(len(t_wc))])
    return left, right


def kb8_orbit(torch, n: int, dt: float, cam, h: int, w: int, rig=None):
    """The room (seed 2) seen along the orbit through a KB8 camera, rendered
    on the card: (left frames [n, h, w], right frames or None, R_wc, t_wc,
    ts). ``rig`` (R_rl, t_rl) adds the right camera's frames."""
    from orb_slam3_ros_tpu_torch.utils import synth

    R_wc, t_wc, ts = synth.orbit_trajectory(n, dt=dt)
    left, right = kb8_views(torch, synth.make_room(seed=2), R_wc, t_wc, rig, cam, h, w)
    return left, right, R_wc, t_wc, ts


def fe_rig():
    """(R_rl, t_rl) of phase 16's right camera: FE_BASE along the left's x,
    yawed FE_YAW (X_r = R_rl X_l + t_rl)."""
    c, s = np.cos(-FE_YAW), np.sin(-FE_YAW)
    R_rl = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return R_rl, (-R_rl @ np.asarray([FE_BASE, 0.0, 0.0], np.float32)).astype(np.float32)


def phase_fisheye_chunk(torch, project_match) -> tuple:
    """Phase 16 (a): ``MonoSlam(cam_model="kb8")`` on raw KB8 frames at the
    TUM-VI shape through phase 10's protocol, the step and keyframe
    segments as CUDA graphs. Returns (result, the system, the frames)."""
    from orb_slam3_ros_tpu_torch.models import device_loop, system

    t0 = time.perf_counter()
    imgs, _, R_wc, t_wc, ts = kb8_orbit(torch, FE_FRAMES, FE_DT, FE_KB8, FE_H, FE_W)
    slam = system.MonoSlam(height=FE_H, width=FE_W, cam_params=FE_KB8, cam_model="kb8",
                           **FE_SLAM_KW)
    check(slam.device.type == "cuda", "MonoSlam(cam_model='kb8') is not on the card")
    slam._sched_lean = BENCH_LEAN
    stack = torch.clamp(imgs, 0, 255).to(torch.uint8)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    eager_steps, calls, first, lost = [], [], [], []
    step_fn, per_frame = device_loop.frame_step, slam.process_frame

    def counted_step(*args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            eager_steps.append(1)
        return step_fn(*args, **kw)

    def counted_frame(*args, **kw):
        calls.append(1)
        return per_frame(*args, **kw)

    def frame(i):
        return slam.process_frame(imgs[i], float(ts[i]))

    def chunk(i):
        slam.process_frames((stack, i), ts[i : i + CHUNK])

    device_loop.frame_step = counted_step
    reset_launches(project_match)
    try:
        t0 = time.perf_counter()
        i = 0
        while (slam.state != system.OK or not slam._chunkable()) and i < MONO_WARM - CHUNK:
            per_frame_run(frame, [i], first, lost)
            i += 1
        i_steady = i
        while i + CHUNK <= MONO_WARM:
            chunk(i)
            i += CHUNK
        per_frame_run(frame, range(i, MONO_WARM), first, lost)
        i = MONO_WARM
        warm_s = time.perf_counter() - t0
        runner = slam._mono_runner
        check(runner is not None and runner.graphs, "the KB8 chunks did not run on graphs")
        check(runner.cfg.cam_model == "kb8", "the KB8 chunks did not take the KB8 camera")
        slam.process_frame = counted_frame
        runner.timing = True
        runner.spans, runner.gaps_s = [], []
        launches_warm = dict(project_match.LAUNCHES)
        reset_launches(project_match)
        runs0, warm0 = dict(runner.runs), dict(runner.warmup_launches)
        chunk_ms = []
        while i + CHUNK <= FE_FRAMES:
            t1 = time.perf_counter()
            chunk(i)  # ends in the chunk's host read
            chunk_ms.append((time.perf_counter() - t1) * 1e3)
            i += CHUNK
        torch.cuda.synchronize()
        runner.timing = False
        launches = dict(project_match.LAUNCHES)
    finally:
        device_loop.frame_step = step_fn
        slam.process_frame = per_frame
    timed = i - MONO_WARM
    runs = {k: runner.runs[k] - runs0.get(k, 0) for k in runner.runs}
    warm = {k: runner.warmup_launches[k] - warm0[k] for k in warm0}
    step_runs = sum(v for k, v in runs.items() if isinstance(k, tuple))
    fusing, n_kf_timed = runs.get("kf_fuse", 0), runs.get("kf_insert", 0)
    passes = len(slam._sched_lean)
    predicted = {"track": passes * timed + warm["track"], "fuse": 2 * fusing + warm["fuse"],
                 "sim3": 0, "merge": 0}
    check(first, "the KB8 run never initialized")
    check(not lost, f"KB8 frames without a pose after initialization: {lost}")
    check(not calls, f"{len(calls)} frames went through process_frame during the timed chunks")
    check(step_runs == timed, f"{step_runs} step-graph replays for {timed} timed frames")
    n_step_graphs = sum(isinstance(k, tuple) for k in runner._graph)
    check(len(eager_steps) == n_step_graphs,
          f"{len(eager_steps)} eager steps on the card, expected one warm-up for each of "
          f"{n_step_graphs} step graphs")
    check(launches == predicted, f"matcher launches {launches}, predicted {predicted} ({passes} x "
          f"{timed} from tracking, 2 x {fusing} from fusion, plus warm-ups {warm})")
    check(slam.state == system.OK, f"state {slam.state} after the KB8 chunks")
    acc = traj_ate(slam, ts, t_wc, with_scale=True)
    check(acc["ate_m"] <= 2 * FE_JAX["a_ate_m"],
          f"KB8 chunks: Sim(3) ATE {acc['ate_m']:.5f} m above 2x the JAX run's "
          f"{FE_JAX['a_ate_m']:.5f} m")
    spans, kf_graph_ms, busy, step_ms, gap_us, nodes = replay_stats(runner, chunk_ms, n_kf_timed)
    fps = timed / (sum(chunk_ms) / 1e3)
    worst = graph_vs_eager(torch, runner, slam._sched_lean)
    audit = region_syncs(torch, runner, slam._sched_lean)
    check(not any(audit.values()), f"synchronizing calls in the eager KB8 regions: {audit}")
    print(f"fisheye (a): KB8 {FE_W}x{FE_H}, {slam.N} feature slots, rendered in {setup_s:.1f} s; "
          f"initialized at frame {first[0]}, frames lost {lost}, chunkable at frame {i_steady}; "
          f"{runner.n_graphs} graphs captured in {runner.capture_s:.2f} s (nodes {nodes}), up to "
          f"frame {MONO_WARM} in {warm_s:.2f} s; timed frames {MONO_WARM}..{i - 1}: {fps:.2f} "
          f"frames/s, chunk latency median {np.median(chunk_ms):.2f} ms over {len(chunk_ms)} chunks "
          f"of {CHUNK}; step graph {step_ms:.2f} ms median over {len(spans['step'])} replays; "
          f"keyframe graphs {kf_graph_ms:.2f} ms a keyframe over {n_kf_timed} "
          f"({ {k: round(float(np.median(v)), 3) for k, v in spans.items()} } ms medians); busy "
          f"{busy:.1%}; host gap {gap_us:.1f} us mean; K1 launches {launches} = predicted (passes "
          f"{passes}, fusing keyframes {fusing}, warm-ups {warm}), before the timed chunks "
          f"{launches_warm}; Sim(3) ATE {acc['ate_m']:.5f} m (JAX package, CPU: "
          f"{FE_JAX['a_ate_m']:.5f} m); {slam.n_kf} keyframes, {slam.n_pts} points; graph vs eager "
          f"step max diff {worst:.3g}; synchronizing calls {audit} in each region run eagerly")
    total = {k: launches[k] + launches_warm[k] for k in launches}
    return dict(init_frame=first[0], lost=lost, chunkable_frame=i_steady, graphs=runner.n_graphs,
                graph_nodes=nodes, capture_s=runner.capture_s, timed_frames=timed,
                frames_per_s=fps, frame_ms=float(np.median(chunk_ms)) / CHUNK, step_ms=step_ms,
                kf_graph_ms=kf_graph_ms,
                segment_ms={k: float(np.median(v)) for k, v in spans.items()}, busy=busy,
                gap_us=gap_us, launches=total, timed_launches=launches,
                predicted_launches=predicted, fusing_keyframes=fusing, keyframes=slam.n_kf,
                graph_vs_eager=worst, region_syncs=audit, **acc), slam, imgs


def phase_fisheye_kernel(torch, project_match, slam, imgs) -> dict:
    """Phase 16, K1 on a KB8 frame: the first frame (a) posed, its features,
    and P_TRACK of (a)'s map points projected into it through KB8 at that
    pose (the tracking shape, N = 1032; the lean schedule's first radius,
    40 px * 1.2^level), kernel against plain version (exact), then timed."""
    from orb_slam3_ros_tpu_torch.ops import cameras, orb

    cfg = slam.config
    check(cfg.total_cap == N_SLOTS, f"{cfg.total_cap} feature slots at the TUM-VI shape")
    ts0, T_wc = slam.get_trajectory()[0]
    k = int(round(ts0 / FE_DT))
    R = torch.as_tensor(T_wc[:3, :3].T, device=slam.device)
    t = -R @ torch.as_tensor(T_wc[:3, 3], device=slam.device)
    m = slam.map
    idx = torch.nonzero(m.pt_valid)[:P_TRACK, 0]
    check(idx.numel() == P_TRACK, f"(a)'s map holds only {idx.numel()} points")
    Xc = m.pt_X[idx] @ R.T + t
    uv = cameras.kb8_project(slam.cam_params, Xc)
    level = m.pt_level[idx]
    valid = (Xc[:, 2] > 0.05) & cameras.in_image(uv, FE_W, FE_H, 2.0)
    f = orb.extract(imgs[k], cfg)
    radius = BENCH_LEAN[0][0] * 1.2 ** level.to(torch.float32)
    args = [uv.contiguous(), valid, level, m.pt_desc_sign[idx].contiguous(), radius, f.xy,
            f.level, f.valid, f.desc_sign]
    kw = dict(max_dist=100, ratio=0.9)
    err, n_match = kernel_vs_plain(torch, project_match, args, kw, f"a KB8 frame (frame {k})")
    check(n_match > 50, f"only {n_match} matches on the KB8 frame")
    kernel = lambda: project_match.project_match(*args, **kw)  # noqa: E731
    ms = cuda_ms(kernel, 100)
    plain_ms = cuda_ms(lambda: project_match.project_match_reference(*args, **kw), 100)
    dev_us = device_us(kernel)
    bound = search_bound(torch, project_match, args, kw)
    print(f"K1 on KB8 frame {k}: {int(valid.sum())} of {P_TRACK} points in the image, {n_match} "
          f"matches, max |diff| {err}; call {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
          f"device {dev_us:.2f} us, bound {bound['bound_us']:.3f} us by {bound['bound_by']}")
    return dict(frame=k, matches=n_match, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                device_us=dev_us, **bound)


def phase_fisheye_stereo(torch, project_match) -> dict:
    """Phase 16 (b): ``FisheyeStereoSlam`` on the non-rectified KB8 rig at
    the TUM-VI shape, per frame; the cross-camera depth of the first pair
    against the rendered depth, and ``triangulate_cross_camera`` timed."""
    from orb_slam3_ros_tpu_torch.models.fisheye_stereo import FisheyeStereoSlam
    from orb_slam3_ros_tpu_torch.ops import orb, twocam
    from orb_slam3_ros_tpu_torch.utils import synth

    R_rl, t_rl = fe_rig()
    left, right, R_wc, t_wc, ts = kb8_orbit(torch, FE_ST_FRAMES, FE_ST_DT, FE_KB8, FE_H, FE_W,
                                            rig=(R_rl, t_rl))
    slam = FisheyeStereoSlam(height=FE_H, width=FE_W, cam_params=FE_KB8, R_rl=R_rl, t_rl=t_rl,
                             **FE_ST_KW)
    check(slam.device.type == "cuda", "FisheyeStereoSlam is not on the card")
    reset_launches(project_match)
    first, lost = [], []
    t0 = time.perf_counter()
    with ProgramWatch(torch, project_match, "fisheye (b)") as watch:
        per_frame_run(lambda i: slam.process_frame(left[i], right[i], float(ts[i])),
                      range(FE_ST_FRAMES), first, lost)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    progs = watch.report(frames=FE_ST_FRAMES)
    acc = traj_ate(slam, ts, t_wc, with_scale=False)
    without = FE_ST_FRAMES - acc["poses"]
    check(first, "the two-camera rig never initialized")
    check(without <= FE_ST_MAX_LOST, f"{without} frames without a pose (limit {FE_ST_MAX_LOST})")
    check(acc["ate_m"] <= 2 * FE_JAX["b_ate_m"],
          f"two-camera rig: metric ATE {acc['ate_m']:.5f} m above 2x the JAX run's "
          f"{FE_JAX['b_ate_m']:.5f} m")
    check(launches["track"] > 0, "the two-camera rig launched no tracking search")
    # the cross-camera depth of the first pair against the rendered depth
    cfg = slam.config
    fl, fr = orb.extract(left[0], cfg), orb.extract(right[0], cfg)
    R_d, t_d = slam.R_rl, slam.t_rl

    def cross():
        return twocam.triangulate_cross_camera(fl, fr, R_d, t_d, slam.cam_params, slam.cam_params)

    c = cross()
    ok = c.ok.cpu().numpy()
    z = c.X_l[:, 2].cpu().numpy()[ok]
    xy = fl.xy.cpu().numpy()[ok]
    _, depth = synth.render(synth.make_room(seed=2), R_wc[0], t_wc[0], FE_KB8, height=FE_H,
                            width=FE_W, cam_model="kb8")
    dep = depth.cpu().numpy()
    gt = dep[np.clip(np.round(xy[:, 1]).astype(int), 0, FE_H - 1),
             np.clip(np.round(xy[:, 0]).astype(int), 0, FE_W - 1)]
    rel = float(np.median(np.abs(z - gt) / gt)) if ok.any() else float("nan")
    ms = cuda_ms(cross, 50)
    dev_us = device_us(cross, 20)
    print(f"fisheye (b): two-camera KB8 rig ({FE_BASE} m, yawed {FE_YAW} rad) {FE_W}x{FE_H}, "
          f"{FE_ST_FRAMES} frames per frame in {secs:.1f} s ({FE_ST_FRAMES / secs:.2f} frames/s); "
          f"initialized at frame {first[0]}, {without} frames without a pose; metric ATE "
          f"{acc['ate_m']:.5f} m (JAX package, CPU: {FE_JAX['b_ate_m']:.5f} m), Sim(3) scale "
          f"{acc['scale']:.5f}; {slam.n_kf} keyframes, {slam.n_pts} points; cross-camera points "
          f"of the first pair {int(ok.sum())}, depth median relative error {rel:.4f} against the "
          f"rendered depth; triangulate_cross_camera call {ms * 1e3:.1f} us (median of 50), "
          f"device {dev_us:.1f} us (20 queued calls); K1 launches {launches}")
    return dict(init_frame=first[0], frames_without_pose=without, frames_per_s=FE_ST_FRAMES / secs,
                keyframes=slam.n_kf, cross_points=int(ok.sum()), cross_depth_median_rel=rel,
                cross_ms=ms, cross_device_us=dev_us, launches=launches, programs=progs, **acc)


def phase_fisheye_vi(torch, project_match) -> dict:
    """Phase 16 (c): ``FisheyeStereoInertialSlam(cam_model="pinhole")`` on
    phase 8's sequence with a 0.11 m pure-translation rig, per frame."""
    from orb_slam3_ros_tpu_torch.models.fisheye_stereo import FisheyeStereoInertialSlam
    from orb_slam3_ros_tpu_torch.utils import synth
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW, vi_calib

    kw = {**VI_SEQ_KW, "n_frames": FE_VI_FRAMES}
    seq, im = synth.make_vi_sequence(**kw, stereo_baseline=SVI_BASE)
    slam = FisheyeStereoInertialSlam(
        height=kw["height"], width=kw["width"], cam_params=seq.cam_params, calib=vi_calib(),
        R_rl=np.eye(3, dtype=np.float32), t_rl=np.asarray([-SVI_BASE, 0.0, 0.0], np.float32),
        cam_model="pinhole", **FE_VI_KW)
    reset_launches(project_match)
    first, lost = [], []
    t0 = time.perf_counter()
    with ProgramWatch(torch, project_match, "fisheye (c)") as watch:
        per_frame_run(lambda i: slam.process_frame(
            seq.images[i], seq.images_right[i], float(seq.timestamps[i]), acc=im["acc"][i],
            gyro=im["gyro"][i], dts=im["dts"][i]), range(FE_VI_FRAMES), first, lost)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    progs = watch.report(frames=FE_VI_FRAMES)
    acc = traj_ate(slam, seq.timestamps, seq.t_wc, with_scale=False)
    check(first, "the two-camera inertial run never initialized")
    check(slam.imu_initialized and slam.imu_fix_scale,
          f"IMU initialized {slam.imu_initialized}, fix_scale {slam.imu_fix_scale}")
    check(abs(acc["scale"] - 1.0) <= FE_VI_SCALE_TOL, f"two-camera inertial scale {acc['scale']:.5f}")
    check(acc["ate_m"] <= 2 * FE_JAX["c_ate_m"],
          f"two-camera inertial: metric ATE {acc['ate_m']:.5f} m above 2x the JAX run's "
          f"{FE_JAX['c_ate_m']:.5f} m")
    check(launches["track"] > 0, "the two-camera inertial run launched no tracking search")
    print(f"fisheye (c): two-camera inertial (pinhole, {SVI_BASE} m rig) {kw['width']}x"
          f"{kw['height']}, {FE_VI_FRAMES} frames per frame in {secs:.1f} s; initialized at frame "
          f"{first[0]}, lost {lost}; IMU stage {slam.imu_stage} (scale fixed); metric ATE "
          f"{acc['ate_m']:.5f} m (JAX package, CPU: {FE_JAX['c_ate_m']:.5f} m), scale "
          f"{acc['scale']:.5f}; {slam.n_kf} keyframes; K1 launches {launches}")
    return dict(init_frame=first[0], lost=lost, imu_stage=slam.imu_stage, keyframes=slam.n_kf,
                frames_per_s=FE_VI_FRAMES / secs, launches=launches, programs=progs, **acc)


def phase_rectified(torch, project_match) -> dict:
    """Phase 16 (d): KB8 frames rendered at FE_RECT_UP x the TUM-VI shape,
    one ``kb8_rect_map``, ``remap_bilinear`` on the card each frame, into the
    pinhole ``MonoSlam`` at ``virtual_pinhole_params``; per frame."""
    from orb_slam3_ros_tpu_torch.models.system import MonoSlam
    from orb_slam3_ros_tpu_torch.ops import rectify

    hi = FE_KB8.copy()
    hi[:4] *= FE_RECT_UP
    hs, ws = int(FE_H * FE_RECT_UP), int(FE_W * FE_RECT_UP)
    fish, _, R_wc, t_wc, ts = kb8_orbit(torch, FE_RECT_FRAMES, FE_ST_DT, hi, hs, ws)
    pin = rectify.virtual_pinhole_params(FE_KB8, FE_H, FE_W)
    smap = rectify.kb8_rect_map(torch.as_tensor(hi, device=fish.device), pin, FE_H, FE_W)
    slam = MonoSlam(height=FE_H, width=FE_W, cam_params=pin, **FE_RECT_KW)
    reset_launches(project_match)
    first, lost = [], []
    t0 = time.perf_counter()
    with ProgramWatch(torch, project_match, "fisheye (d)") as watch:
        per_frame_run(lambda i: slam.process_frame(rectify.remap_bilinear(fish[i], smap),
                                                   float(ts[i])),
                      range(FE_RECT_FRAMES), first, lost)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    kfw = watch.report(mono=True)
    remap_ms = cuda_ms(lambda: rectify.remap_bilinear(fish[0], smap), 50)
    acc = traj_ate(slam, ts, t_wc, with_scale=True)
    check(first, "the rectified route never initialized")
    check(acc["ate_m"] <= 2 * FE_JAX["d_ate_m"],
          f"rectified route: Sim(3) ATE {acc['ate_m']:.5f} m above 2x the JAX run's "
          f"{FE_JAX['d_ate_m']:.5f} m")
    check(launches["track"] > 0, "the rectified route launched no tracking search")
    print(f"fisheye (d): rectified route {ws}x{hs} KB8 -> {FE_W}x{FE_H} pinhole, "
          f"{FE_RECT_FRAMES} frames per frame in {secs:.1f} s; initialized at frame {first[0]}, "
          f"lost {lost}; Sim(3) ATE {acc['ate_m']:.5f} m (JAX package, CPU: "
          f"{FE_JAX['d_ate_m']:.5f} m); remap {remap_ms * 1e3:.1f} us a frame (median of 50, CUDA "
          f"events); {slam.n_kf} keyframes; K1 launches {launches}")
    return dict(init_frame=first[0], lost=lost, keyframes=slam.n_kf, remap_ms=remap_ms,
                frames_per_s=FE_RECT_FRAMES / secs, launches=launches,
                kf_program={k: v for k, v in kfw.items() if k.startswith("mkf_")}, **acc)


def phase_fisheye(torch, project_match) -> dict:
    """Phase 16: the fisheye paths, (a) to (d), and K1 on a KB8 frame."""
    t0 = time.perf_counter()
    a, slam, imgs = phase_fisheye_chunk(torch, project_match)
    k1 = phase_fisheye_kernel(torch, project_match, slam, imgs)
    del slam, imgs
    b = phase_fisheye_stereo(torch, project_match)
    c = phase_fisheye_vi(torch, project_match)
    d = phase_rectified(torch, project_match)
    secs = time.perf_counter() - t0
    launches = {k: sum(x["launches"][k] for x in (a, b, c, d)) for k in a["launches"]}
    print(f"phase 16: {secs:.1f} s; K1 launches on its main paths {launches}")
    return dict(a=a, k1=k1, b=b, c=c, d=d, seconds=secs, launches=launches)


def surface_args(tmp: str, control: bool) -> list:
    """Phase 17's ``run_synth`` flags: phase 7's sequence at the EuRoC
    shape through the native feed, the event stream and the log level on."""
    argv = ["--frames", str(SURF_FRAMES), "--height", str(H), "--width", str(W),
            "--features", str(N_FEATURES), "--seed", "3", "--dt", "0.1", "--device", "cuda",
            "--native-feed", "--stream", os.path.join(tmp, "events.jsonl"), "--verbose", "1",
            "--json"]
    return argv + (["--control", os.path.join(tmp, "slam.sock")] if control else [])


def surface_kw() -> dict:
    """Phase 7's configuration (``make_slam``'s) and the point cadence."""
    return dict(max_keyframes=64, max_points=4096, kf_every=8, fuse_every=3, stats_every=3,
                cull_every=3, lean_after_kf=4, track_cap=P_TRACK,
                points_every=SURF_POINTS_EVERY, pipelined=False)


def check_stream(path: str, summary: dict, n_kf_work: int, tss) -> dict:
    """The event stream of a native-feed run: one frame event a tracked
    frame (the initializing frame has none), one keyframe event a keyframe
    the run made, and the point events at the frame ids the cadence rule
    picks among the tracked frames."""
    evs = [json.loads(x) for x in open(path).read().splitlines()]
    kinds = [e["event"] for e in evs]
    frames = [e for e in evs if e["event"] == "frame"]
    check(len(frames) == summary["tracked"] - 1,
          f"{len(frames)} frame events for {summary['tracked']} tracked frames")
    check(kinds.count("keyframe") == n_kf_work,
          f"{kinds.count('keyframe')} keyframe events, {n_kf_work} keyframes made")
    last, want = -1, []
    for e in frames:
        fid = int(np.argmin(np.abs(tss - e["ts"])))  # the frame's index = its frame id
        if fid - last >= SURF_POINTS_EVERY:
            last = fid
            want.append(e["ts"])
    for kind in ("map_points", "kf_markers", "tracked_points"):
        got = [e["ts"] for e in evs if e["event"] == kind]
        check(got == want, f"{kind} events at {got}, the cadence gives {want}")
    check(all(e["n"] > 0 for e in evs if e["event"] == "map_points"), "an empty map_points event")
    return dict(events=len(evs), frame_events=len(frames), keyframe_events=kinds.count("keyframe"),
                point_events=3 * len(want))


def host_probe() -> None:
    """The host's speed seen from a second process: prints the wall time and
    the rate (iterations/s) of a fixed pure-Python loop, sample after
    sample, until killed. A replay's frame rate is host-bound and follows
    the host's speed, which drifts from one replay to the next by more than
    (b)'s margin; divided by this rate over its frames, it drifts less."""
    while True:
        t0 = time.perf_counter()
        x = 0
        for i in range(PROBE_LOOP):
            x += i * i % 7
        print(f"{time.time():.4f} {PROBE_LOOP / (time.perf_counter() - t0):.1f}", flush=True)


class HostProbe:
    """``host_probe`` in a process of its own for the ``with`` block, its
    samples in ``path``; ``rate(t0, t1)`` is their median between two wall
    times."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        here = os.path.dirname(os.path.abspath(__file__))
        self._out = open(self.path, "w")
        self._proc = subprocess.Popen([
            sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.host_probe()", here], stdout=self._out)
        return self

    def __exit__(self, *exc):
        self._proc.kill()
        self._proc.wait()
        self._out.close()

    def rate(self, t0: float, t1: float) -> float:
        check(self._proc.poll() is None, f"the host probe exited {self._proc.returncode}")
        rows = [line.split() for line in open(self.path).read().splitlines()]
        v = [float(r) for t, r in rows if t0 <= float(t) <= t1]
        check(len(v) >= 10, f"{len(v)} host-probe samples between {t0:.2f} and {t1:.2f}")
        return float(np.median(v))


def surface_clients(sock: str, tmp: str, out_path: str) -> None:
    """Phase 17 (b)'s clients, in a process of their own (as a deployment's
    are: threads here would take the interpreter lock from the SLAM
    thread): a subscriber that reads the frame events until the server
    closes, one that never reads, and a client that sends status,
    save_traj, save_map and localization mode on, then off once 5 more
    frame events came. Writes the replies, the frame events' count, or the
    error, as JSON to ``out_path``. The port's ``ControlClient`` is loaded
    from its file alone: the package's ``__init__`` imports torch, whose
    import took 10-14 s of CPU on the card's host beside the replay."""
    import importlib.util
    import socket

    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "control", os.path.join(here, "orb_slam3_ros_tpu_torch", "utils", "control.py"))
    control = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(control)
    ControlClient = control.ControlClient

    out = {}
    try:
        deadline = time.time() + 120
        while not os.path.exists(sock):
            check(time.time() < deadline, "the control socket never appeared")
            time.sleep(0.05)
        frames = []
        sub = ControlClient(sock, timeout=60)

        def listen():
            try:
                for ev in sub.subscribe():
                    if ev.get("event") == "frame":
                        frames.append(ev["ts"])
            except (OSError, ValueError):
                pass

        th = threading.Thread(target=listen, daemon=True)
        th.start()
        stuck = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        stuck.connect(sock)
        stuck.sendall(b'{"cmd": "subscribe"}\n')  # and never reads
        c = ControlClient(sock, timeout=60)
        while len(frames) < 5:
            check(time.time() < deadline, "the subscriber received no frame events")
            time.sleep(0.05)
        out["status"] = c.call("status")
        out["save_traj"] = c.call("save_traj", path=os.path.join(tmp, "traj.txt"), format="tum")
        out["save_map"] = c.call("save_map", path=os.path.join(tmp, "session"))
        out["loc_on"] = c.call("localization_mode", on=True)
        n0 = len(frames)
        while len(frames) < n0 + 5:
            check(time.time() < deadline, "no frame events in localization mode")
            time.sleep(0.05)
        out["loc_off"] = c.call("localization_mode", on=False)
        out["status_end"] = c.call("status")
        th.join(timeout=120)  # the server closes the connection at the run's end
        check(not th.is_alive(), "the subscriber's connection outlived the run")
        out["frame_events"] = len(frames)
        for x in (stuck, c, sub):
            x.close()
    except Exception as e:  # reported to the replay's process
        out["error"] = repr(e)
    with open(out_path, "w") as f:
        json.dump(out, f)


class SurfaceCounters:
    """Phase 17's instrumentation, the same on every replay it compares:
    K1's launch counts by site (zeroed on entry, read on exit, before the
    keyframe program's report), the tracking passes and fusing keyframes
    they must equal, the keyframe program's keyframes (``ProgramWatch``,
    whose comparisons run at the exit) beside any eager ``keyframe_work``,
    the first search at each site (for the kernel-vs-plain check) and the
    wall time of each ``process_frame`` call (for phase 7's steady rate)."""

    def __init__(self, project_match, what: str = "surface"):
        self.pm, self.what = project_match, what
        self.passes = self.n_fusing = self.n_work = 0
        self.frames = []  # (ms, tracked, wall start) a process_frame call

    def __enter__(self):
        import torch

        from orb_slam3_ros_tpu_torch.models import kf_work, system

        self._saved = (kf_work.keyframe_work, system.MonoSlam._track_res,
                       system.MonoSlam.process_frame)
        work, track_res, process = self._saved

        def counted_work(*args, **kw):
            self.n_fusing += bool(kw["do_fuse"])
            self.n_work += 1
            return work(*args, **kw)

        def counted_track(slam, feats):
            self.passes += len(slam._current_schedule())
            return track_res(slam, feats)

        def timed_process(slam, *args, **kw):
            w0, t0 = time.time(), time.perf_counter()
            out = process(slam, *args, **kw)
            self.frames.append(((time.perf_counter() - t0) * 1e3, out is not None, w0))
            return out

        kf_work.keyframe_work = counted_work
        system.MonoSlam._track_res, system.MonoSlam.process_frame = counted_track, timed_process
        reset_launches(self.pm)
        self.rec_t = SearchRecorder(self.pm, "track").__enter__()
        self.rec_f = SearchRecorder(self.pm, "fuse").__enter__()
        self.watch = ProgramWatch(torch, self.pm, self.what).__enter__()
        return self

    def __exit__(self, *exc):
        from orb_slam3_ros_tpu_torch.models import kf_work, system

        self.watch.__exit__(*exc)
        self.rec_f.__exit__(*exc)
        self.rec_t.__exit__(*exc)
        kf_work.keyframe_work = self._saved[0]
        system.MonoSlam._track_res, system.MonoSlam.process_frame = self._saved[1:]
        self.launches = dict(self.pm.LAUNCHES)
        if exc[0] is None:
            self.kfw = self.watch.report(mono=True)
            self.n_work += self.kfw["mono_keyframes"]
            self.n_fusing += self.kfw["fusing_keyframes"]
            self.extra = self.kfw["warmup_launches"]

    def _steady(self) -> list:
        """The frames after the first tracked one and ``WARM`` more (phase
        7's steady frames)."""
        first = next(i for i, (_, ok, _) in enumerate(self.frames) if ok)
        return self.frames[first + WARM + 1:]

    def steady_ms(self) -> list:
        """The ``process_frame`` ms of the steady frames."""
        return [t for t, _, _ in self._steady()]

    def steady_window(self) -> tuple:
        """The wall times (``time.time()``) at the first steady frame's start
        and the last one's end."""
        f = self._steady()
        return f[0][2], f[-1][2] + f[-1][0] / 1e3

    def steady_fps(self) -> float:
        """Phase 7's rate: the steady frames over their time."""
        ms = self.steady_ms()
        return len(ms) / (sum(ms) / 1e3)

    def median_fps(self) -> float:
        """1 / the median steady frame: the tracking cadence, without the
        keyframes' long frames and the commands that ``poll()`` runs
        between frames."""
        return 1e3 / float(np.median(self.steady_ms()))

    def check_launches(self, what: str) -> None:
        x = self.extra
        check(self.launches == {"track": self.passes + x["track"],
                                "fuse": 2 * self.n_fusing + x["fuse"], "sim3": 0, "merge": 0},
              f"{what}: matcher launches {self.launches}, expected {self.passes} from tracking "
              f"and {2 * self.n_fusing} from fusion, plus the keyframe program's capture "
              f"warm-ups {x}")


def surface_replay(project_match, tmp: str, control: bool, argv=None):
    """One phase 17 replay through ``run_synth.run`` (``argv``: its flags,
    by default the native feed's) under ``SurfaceCounters``;
    with ``control`` the clients of ``surface_clients`` run beside it, in a
    process started here and ended before this returns. Returns (the
    system, the sequence, the summary, the counters, the clients' results)."""
    from orb_slam3_ros_tpu_torch import run_synth

    box, proc = {}, None
    out_path = os.path.join(tmp, "clients.json")
    if control:
        here = os.path.dirname(os.path.abspath(__file__))
        proc = subprocess.Popen([
            sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.surface_clients(*sys.argv[2:])", here, os.path.join(tmp, "slam.sock"),
            tmp, out_path])
    try:
        with SurfaceCounters(project_match, f"surface {os.path.basename(tmp)}") as cnt:
            slam, seq, summary, _ = run_synth.run(
                run_synth.parse_args(argv or surface_args(tmp, control)), surface_kw())
        if proc is not None:
            check(proc.wait(timeout=120) == 0, f"the clients' process exited {proc.returncode}")
            box = json.load(open(out_path))
            check("error" not in box, f"the control clients failed: {box.get('error')}")
            check("status_end" in box, "the control clients did not finish")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
    return slam, seq, summary, cnt, box


def phase_surface(torch, project_match, loop_slam, mp: dict) -> dict:
    """Phase 17: the dataset-replay entry point through the native feed with
    the event stream, stage timer and control socket live; the problem dump
    of phase 12 (a)'s closure re-solved on the card; plane detection and the
    AR overlay on the replay's map. ``mp``: phase 7's result, whose steady
    rate (the plain loop: no feed, no events, no timer around each frame)
    is printed beside (a)'s."""
    from orb_slam3_ros_tpu_torch import native
    from orb_slam3_ros_tpu_torch.models import system
    from orb_slam3_ros_tpu_torch.utils import ar, checkpoint, kernel_build, optdump

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="surface-")  # removed at the phase's end
    tmp = os.path.join(root, "a")
    os.makedirs(tmp)
    t0 = time.perf_counter()
    lib = native.load_library()
    lib_dir = os.path.dirname(lib._name)
    build_log = open(os.path.join(lib_dir, "build.log")).read().splitlines()[0]
    check(os.path.dirname(lib_dir) == str(kernel_build.BUILD_ROOT) and "g++" in build_log,
          f"the measurement sync was not built from source here: {lib._name}")
    print(f"surface: measurement sync built with g++ and loaded in {time.perf_counter() - t0:.2f} s "
          f"({build_log})")

    with HostProbe(os.path.join(root, "probe.txt")) as probe:
        # (a) the native-feed replay, counted as phase 7 counts
        slam, seq, sa, ca, _ = surface_replay(project_match, tmp, False)
        launches = ca.launches
        init_at = int(np.argmin(np.abs(seq.timestamps - slam.trajectory[0][0])))
        rmse = ate(slam, seq, SURF_FRAMES - init_at, with_scale=True)
        stream = check_stream(os.path.join(tmp, "events.jsonl"), sa, ca.n_work, seq.timestamps)
        steady_a = ca.steady_fps()
        print(f"surface (a): native feed, {SURF_FRAMES} frames at {W}x{H}: {sa['fps']} frames/s over "
              f"the run, {steady_a:.2f} steady as phase 7 counts (phase 7: "
              f"{mp['frames_per_s']:.2f}), initialized at frame {init_at}, tracked {sa['tracked']}, "
              f"{slam.n_kf} keyframes, Sim(3) ATE {rmse:.5f} m; producer waits {sa['native_feed']}; "
              f"stream {stream}; K1 launches {launches} (tracking passes {ca.passes}, fusing "
              f"keyframes {ca.n_fusing})")
        slam.print_time_stats(file=sys.stdout)
        check(init_at <= MAP_INIT_BY, f"not initialized by frame {MAP_INIT_BY}")
        check(sa["tracked"] == SURF_FRAMES - init_at and slam.state == system.OK,
              f"{sa['tracked']} frames tracked of {SURF_FRAMES - init_at} after initialization")
        check(rmse <= MAP_ATE_LIMIT, f"native-feed ATE {rmse:.5f} m above {MAP_ATE_LIMIT} m")
        ca.check_launches("surface (a)")
        check(ca.rec_t.args is not None and ca.rec_f.args is not None, "no search was recorded")
        err_t, m_t = kernel_vs_plain(torch, project_match, ca.rec_t.args, ca.rec_t.kw,
                                     "the replay's tracking")
        err_f, m_f = kernel_vs_plain(torch, project_match, ca.rec_f.args, ca.rec_f.kw,
                                     "the replay's fusion")
        stages = {k: round(v[0] * 1e3, 3) for k, v in slam.timing_summary().items()}
        a = dict(frames_per_s=sa["fps"], steady_frames_per_s=steady_a,
                 phase7_frames_per_s=mp["frames_per_s"], init_frame=init_at, tracked=sa["tracked"],
                 keyframes=slam.n_kf, ate_sim3_m=rmse, native_feed=sa["native_feed"],
                 per_stage_ms=stages, stream=stream, launches=launches, tracking_passes=ca.passes,
                 fusing_keyframes=ca.n_fusing, k1_max_abs_err=max(err_t, err_f),
                 k1_matches=(m_t, m_f), run_s=sa["wall_s"])

        # (b) the same run with the control socket and its clients, each
        # (b) between two runs of (a): each run's median frame rate over
        # the host's speed across its frames, and each (b) over the mean of
        # the (a)s around it, which cancels the host's drift in between
        a_runs, b_runs = [(sa, ca)], []
        for r in range(SURF_B_RUNS):
            d_b, d_a = (os.path.join(root, f"{x}{r + 1}") for x in ("b", "a"))
            os.makedirs(d_b)
            os.makedirs(d_a)
            b_runs.append(surface_replay(project_match, d_b, True))
            _, _, sa_r, ca_r, _ = surface_replay(project_match, d_a, False)
            ca_r.check_launches(f"surface (a) after (b) {r + 1}")
            a_runs.append((sa_r, ca_r))
        # M probe iterations/s over each run's steady frames
        host_a = [probe.rate(*c.steady_window()) / 1e6 for _, c in a_runs]
        host_b = [probe.rate(*cb.steady_window()) / 1e6 for *_, cb, _ in b_runs]
    med_a = [c.median_fps() for _, c in a_runs]
    med_b = [cb.median_fps() for *_, cb, _ in b_runs]

    def around(v_b, v_a):  # each (b) over the mean of the (a)s before and after it
        return [x / ((v_a[r] + v_a[r + 1]) / 2) for r, x in enumerate(v_b)]

    ratios = around([m / h for m, h in zip(med_b, host_b)], [m / h for m, h in zip(med_a, host_a)])
    fps_ratio = float(np.mean(ratios))
    raw = around(med_b, med_a)
    whole = around([sb["fps"] for _, _, sb, _, _ in b_runs], [sa_r["fps"] for sa_r, _ in a_runs])
    print(f"surface (b): (a) median frame rates {[round(x, 3) for x in med_a]} frames/s, the "
          f"host {[round(x, 3) for x in host_a]} M probe iterations/s over their frames; (b) "
          f"{[round(x, 3) for x in med_b]} frames/s, the host {[round(x, 3) for x in host_b]}; "
          f"(b) over the (a)s around it: over the host's speed {[round(x, 4) for x in ratios]}, "
          f"mean {fps_ratio:.4f}; as measured {[round(x, 4) for x in raw]}; over the whole run "
          f"{[round(x, 4) for x in whole]}")
    for r, (slam_b, _, sb, cb, box) in enumerate(b_runs):
        st, tr, sm = box["status"], box["save_traj"], box["save_map"]
        fresh = system.MonoSlam(height=H, width=W, cam_params=seq.cam_params,
                                n_features=N_FEATURES, **{k: v for k, v in surface_kw().items()
                                                          if k != "points_every"})
        check(st["ok"] and st["state"] == system.OK and st["n_kf"] >= 2, f"status reply {st}")
        check(tr["ok"] and tr["n_poses"] == len(open(tr["path"]).read().splitlines()) > 0,
              f"save_traj reply {tr}")
        checkpoint.load_atlas(sm["path"], fresh)
        check(sm["ok"] and fresh.n_kf >= 2 and fresh.state == system.OK,
              f"save_map reply {sm}; loaded n_kf {fresh.n_kf}, state {fresh.state}")
        check(box["loc_on"] == {"ok": True, "localization_only": True}
              and box["loc_off"] == {"ok": True, "localization_only": False}
              and not slam_b.localization_only,
              f"localization mode {box['loc_on']}, {box['loc_off']}")
        n_sub = box["frame_events"]
        print(f"surface (b) {r + 1}: with the control socket: status {st}, save_traj "
              f"{tr['n_poses']} poses, save_map md5 {sm['md5']} (loaded: {fresh.n_kf} keyframes), "
              f"localization mode on then off, subscriber {n_sub} frame events, subscribers "
              f"dropped {sb['control']['dropped']} (the one that never read); tracked "
              f"{sb['tracked']}, {slam_b.n_kf} keyframes, K1 launches {cb.launches}")
        check(n_sub >= 10, f"the subscriber received {n_sub} frame events")
        check(sb["control"]["dropped"] == 1,
              f"{sb['control']['dropped']} subscribers dropped: the one that never read must go "
              "once its socket buffer and queue are full, the reader must stay")
        cb.check_launches(f"surface (b) {r + 1}")
    check(fps_ratio >= SURF_FPS_RATIO, f"median frame rate with the control socket, over the "
          f"host's speed, {fps_ratio:.4f} of (a)'s, below {SURF_FPS_RATIO} (by run {ratios})")
    b = dict(frames_per_s=[sb["fps"] for _, _, sb, _, _ in b_runs], median_frames_per_s=med_b,
             a_median_frames_per_s=med_a, a_frames_per_s=[sa_r["fps"] for sa_r, _ in a_runs],
             host_rate_a=host_a, host_rate_b=host_b, ratios=ratios, fps_ratio=fps_ratio,
             ratios_as_measured=raw, whole_run_ratios=whole,
             subscriber_frames=[box["frame_events"] for *_, box in b_runs],
             dropped=[sb["control"]["dropped"] for _, _, sb, _, _ in b_runs],
             status=b_runs[0][4]["status"],
             saved_poses=[box["save_traj"]["n_poses"] for *_, box in b_runs],
             loaded_keyframes=fresh.n_kf)

    # (c) phase 12 (a)'s closure as a problem dump, re-solved on the card
    lc = loop_slam.loop_closer
    k = int(np.nonzero(lc._edge_i >= 0)[0][0])
    edge = (int(lc._edge_i[k]), int(lc._edge_j[k]), lc._edge_R[k], lc._edge_t[k],
            float(lc._edge_s[k]))
    d = os.path.join(tmp, f"closure_{edge[0]}")
    optdump.save_optimization_data(d, **optdump.dump_from_map(loop_slam.map, loop_slam.n_kf,
                                                              loop_edges=[edge]))
    dump = optdump.load_optimization_data(d)
    t0 = time.perf_counter()
    R_g, t_g, s_g, cost = optdump.reoptimize(dump, n_iters=SURF_REOPT_ITERS, device="cuda")
    reopt_s = time.perf_counter() - t0
    cost0 = optdump.reoptimize(dump, n_iters=0, device="cuda")[3]
    R_c, t_c, s_c, cost_c = optdump.reoptimize(dump, n_iters=SURF_REOPT_ITERS, device="cpu")
    diff = max(float(np.abs(R_g - R_c).max()), float(np.abs(t_g * s_g[:, None]
                                                            - t_c * s_c[:, None]).max()))
    print(f"surface (c): the dump of phase 12 (a)'s closure {edge[:2]} ({len(dump.kf_id)} "
          f"keyframes, {len(dump.e_i)} edges, {len(dump.pt_X)} points): reoptimize on the card "
          f"cost {cost0:.6g} -> {cost:.6g} in {reopt_s:.2f} s (the CPU: {cost_c:.6g}), poses "
          f"within {diff:.3g} of the CPU's")
    check(cost < cost0, f"reoptimize's cost did not fall: {cost0} -> {cost}")
    check(diff <= SURF_REOPT_TOL, f"reoptimize on the card vs the CPU: {diff:.3g}")
    c = dict(closure=edge[:2], keyframes=len(dump.kf_id), edges=len(dump.e_i), cost0=cost0,
             cost=cost, cost_cpu=cost_c, card_vs_cpu=diff, reopt_s=reopt_s)

    # (d) plane and AR on (a)'s map
    demo = ar.ARDemo(slam)
    check(demo.try_detect_plane(), "no dominant plane on the replay's map")
    n_valid = int(slam.map.pt_valid.sum())
    img = seq.images[-1]
    drawn = int((np.abs(demo.render(img) - img.cpu().numpy()) > 0).sum())
    n, dpl, _ = demo.plane
    print(f"surface (d): plane normal {np.round(n, 4).tolist()}, d {dpl:.4f} over {n_valid} "
          f"points; the cube drew {drawn} pixels; phase 17 {time.perf_counter() - t_phase:.1f} s")
    check(drawn > 50, f"the cube drew {drawn} pixels")
    shutil.rmtree(root)
    return dict(a=a, b=b, c=c, d=dict(normal=n.tolist(), d=dpl, drawn_px=drawn),
                phase_s=time.perf_counter() - t_phase)


SCALE_SHAPE = (64, 8192, 65536)  # K, P, E: the global-BA shape (scripts/bench_dist.py)
SCALE_TIMEOUT = 240  # seconds for a group of worker processes
SPLIT_VI_FRAMES = 45  # 60 until phase 20 was added (cut for time)
REFRESH_TIMED = 20  # replica refreshes timed alone after phase 18 (b)'s run


def scale_workers(torch, world: int, backend: str, devices: list, probs: str, tmp: str) -> dict:
    """``world`` scale-out ranks, one process each (``parallel/scale_out.py``,
    the runner a user starts), each with the same problems file, rank r on
    ``devices[r]``; every rank must exit 0. Returns rank 0's report."""
    from orb_slam3_ros_tpu_torch.parallel.multihost import free_port

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "orb_slam3_ros_tpu_torch.parallel.scale_out", "--world",
           str(world), "--coordinator", f"127.0.0.1:{free_port()}", "--backend", backend,
           "--problems", probs, "--compare"]
    logs = [open(os.path.join(tmp, f"{backend}{world}-rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r), "--device", devices[r]], cwd=here, env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=SCALE_TIMEOUT)
            except subprocess.TimeoutExpired:
                rc = "a timeout"
            logs[r].seek(0)
            out = logs[r].read()
            check(rc == 0, f"scale-out rank {r} of {world} ({backend}) exited with {rc}: "
                           f"{out[-2000:]}")
            if r == 0:
                line = [ln for ln in out.splitlines() if ln.startswith("SCALE_OUT ")]
                check(line, f"scale-out rank 0 printed no report: {out[-2000:]}")
                report = json.loads(line[0][len("SCALE_OUT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    return report


def print_scale(tag: str, rep: dict) -> None:
    for name, e in rep["solvers"].items():
        c = e["check"]
        check(c["ok"], f"scale-out {tag} {name}: differs from the solve without a communicator "
                       f"beyond the JAX tests' tolerances: {c}")
        print(f"scale-out {tag} {name}: {[round(r[0], 3) for r in e['ms_per_iter']]} ms/iter by "
              f"rank over {e['iters']} iterations, {e['sums_per_iter']:.1f} sums and "
              f"{e['bytes_per_iter'] / 2**20:.3f} MiB summed per iteration, peak "
              f"{[round(m, 1) for m in e['peak_mib']]} MiB by rank, shards (edges, points, "
              f"cameras) {[[int(x) for x in r] for r in e['shard']]}, largest |differences| to "
              f"the solve without a communicator {c['max_diff']} (of the bound "
              f"{ {k: round(v, 4) for k, v in c['of_bound'].items()} })"
              + (f", {c['n_inliers']} inliers" if "n_inliers" in c else ""))


def phase_scale_out(torch) -> dict:
    """Phase 18 (a): the sharded solvers at the global-BA shape, at world 1
    in this process over NCCL (one rank: every sum is over one rank, so no
    collective runs), at world 2 as two processes on this card over gloo
    (NCCL takes one rank a card) and, with two cards, over NCCL."""
    from orb_slam3_ros_tpu_torch.parallel import multihost, problems, scale_out

    t0 = time.perf_counter()
    K, P, E = SCALE_SHAPE
    trees = dict(ba=problems.ba_problem(K, P, E), vi=problems.vi_problem(),
                 pgo=problems.pgo_problem())
    tmp = tempfile.mkdtemp(prefix="scale-out-")  # removed at the phase's end
    try:
        probs = os.path.join(tmp, "problems.npz")
        problems.save(probs, **trees)
        out = {}
        multihost.init(f"127.0.0.1:{multihost.free_port()}", 1, 0, backend="nccl",
                       device="cuda:0")
        try:
            out["nccl1"], _ = scale_out.run(multihost.global_mesh(), trees, check=True)
        finally:
            multihost.shutdown()
        print_scale("world 1 (NCCL, in process, no collective)", out["nccl1"])
        out["gloo2"] = scale_workers(torch, 2, "gloo", ["cuda:0", "cuda:0"], probs, tmp)
        print_scale("world 2 (gloo, two processes on one card)", out["gloo2"])
        if torch.cuda.device_count() >= 2:
            out["nccl2"] = scale_workers(torch, 2, "nccl", ["cuda:0", "cuda:1"], probs, tmp)
            print_scale("world 2 (NCCL, two cards)", out["nccl2"])
        else:
            print("scale-out world 2 over NCCL on two cards: not measured (one card)")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"scale-out: K={K} P={P} E={E}, {time.perf_counter() - t0:.1f} s")
    return out


def phase_split(torch, project_match, mp: dict, seq) -> dict:
    """Phase 18 (b): ``MonoSlam`` split over (track, map) devices on phase
    7's sequence and configuration, per frame, counted as phase 17 counts."""
    from orb_slam3_ros_tpu_torch.models import system

    devices = ("cuda:0", "cuda:1") if torch.cuda.device_count() >= 2 else ("cuda:0", "cuda:0")
    t0 = time.perf_counter()
    slam = make_slam(seq, devices[1], devices=devices)
    check(slam._replica is not None and not slam._chunkable(), "MonoSlam(devices=...) is not split")
    with SurfaceCounters(project_match, "split") as cnt:
        init_at = None
        for i in range(MAP_FRAMES):
            out = slam.process_frame(seq.images[i], float(seq.timestamps[i]))
            if init_at is None and out is not None:
                init_at = i
            check(init_at is not None or i < MAP_INIT_BY, f"split: not initialized by frame "
                                                          f"{MAP_INIT_BY}")
            check(init_at is None or out is not None, f"split: lost frame {i}")
    torch.cuda.synchronize()
    rep = slam._replica
    rmse = ate(slam, seq, MAP_FRAMES - init_at, with_scale=True)
    fps = cnt.steady_fps()
    ptrs = {x.data_ptr() for x in slam.map}
    on_dev = all(x.device == torch.device(devices[1]) for x in slam.map) and all(
        x.device == torch.device(devices[0]) for b in rep._bufs for x in b)
    distinct = all(not ptrs & {x.data_ptr() for x in b} for b in rep._bufs)
    us = rep.refresh_us() or [float("nan")]  # timed on the card only
    c = dict(rep.counts)
    # In the run the card is idle when a keyframe's refresh is queued (the
    # keyframe ends in a host read), so its events time the host's queueing.
    # The device's time: refreshes queued behind a spin kernel, which the copy
    # stream waits for.
    host_us, n0 = [], len(us)
    for _ in range(REFRESH_TIMED):
        torch.cuda._sleep(SPIN_CYCLES // 10)
        t1 = time.perf_counter()
        rep.start(slam.map)
        host_us.append((time.perf_counter() - t1) * 1e6)
        rep.poll(force=True)
    dev_us = rep.refresh_us()[n0:] or [float("nan")]
    k_t = kernel_vs_plain(torch, project_match, cnt.rec_t.args, cnt.rec_t.kw, "split tracking")
    k_f = kernel_vs_plain(torch, project_match, cnt.rec_f.args, cnt.rec_f.kw, "split fusion")
    bound_us = 2 * rep.nbytes / HBM_BYTES_PER_S * 1e6
    print(f"split {devices}: initialized at frame {init_at}, tracked {MAP_FRAMES - init_at} "
          f"frames, {slam.n_kf} keyframes, Sim(3) ATE {rmse:.5f} m (phase 7 "
          f"{mp['ate_sim3_m']:.5f}); {fps:.2f} frames/s steady (phase 7 {mp['frames_per_s']:.2f}); "
          f"replica refreshes {c}; a refresh in the run {float(np.median(us)):.1f} us median, "
          f"{min(us):.1f}-{max(us):.1f} us over {len(us)} (CUDA events on the copy stream); "
          f"queued behind a spin kernel {float(np.median(dev_us)):.1f} us of device time and "
          f"{float(np.median(host_us)):.1f} us of host time median over {REFRESH_TIMED}; "
          f"{rep.nbytes / 2**20:.2f} MiB, bound {bound_us:.2f} us at {HBM_BYTES_PER_S / 1e12} TB/s "
          f"read + write; K1 launches {cnt.launches} (tracking passes {cnt.passes}, fusing "
          f"keyframes {cnt.n_fusing}), exact on the first tracking ({k_t[1]} matches) and fusion "
          f"({k_f[1]} matches) searches; {time.perf_counter() - t0:.1f} s")
    check(rmse <= MAP_ATE_LIMIT and rmse <= 2 * mp["ate_sim3_m"],
          f"split ATE {rmse:.5f} m above {MAP_ATE_LIMIT} m or 2x phase 7's")
    check(on_dev and distinct, "the canonical map and the replica are not where they belong")
    # every refresh is timed, the construction's first fill too
    check(len(us) == 1 + c["copies"] + c["syncs"], f"{len(us)} refreshes timed of {c}")
    check(c["copies"] == cnt.n_work and c["max_stale"] <= 1,
          f"replica refreshes {c} for {cnt.n_work} keyframes")
    check(c["adopted"] in (c["copies"], c["copies"] - 1), f"refreshes not adopted: {c}")
    cnt.check_launches("split")
    return dict(devices=list(devices), init_frame=init_at, keyframes=slam.n_kf, ate_sim3_m=rmse,
                frames_per_s=fps, replica=c, refresh_us_p50=float(np.median(us)),
                refresh_device_us_p50=float(np.median(dev_us)),
                refresh_host_us_p50=float(np.median(host_us)),
                refresh_bytes=rep.nbytes, refresh_bound_us=bound_us, launches=cnt.launches,
                k1_max_abs_err=max(k_t[0], k_f[0]))


def phase_split_vi(torch, project_match) -> dict:
    """Phase 18 (c): ``InertialSlam`` split on the first frames of phase 8's
    sequence, per frame, against the same run on one device."""
    from orb_slam3_ros_tpu_torch.models import inertial_system, system
    from orb_slam3_ros_tpu_torch.utils.evaluate_ate import ate_rmse
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SLAM_KW, vi_calib

    devices = ("cuda:0", "cuda:1") if torch.cuda.device_count() >= 2 else ("cuda:0", "cuda:0")
    t0 = time.perf_counter()
    n = SPLIT_VI_FRAMES
    seq, im = vi_sequence(n)
    res = {}
    for tag, kw in (("split", dict(devices=devices)), ("one", {})):
        slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(),
                                            **{**VI_SLAM_KW, **kw})
        reset_launches(project_match)
        init_at = map_at = None
        for i in range(n):
            out = slam.process_frame(seq.images[i], float(seq.timestamps[i]), acc=im["acc"][i],
                                     gyro=im["gyro"][i], dts=im["dts"][i])
            if map_at is None and out is not None:
                map_at = i
            if init_at is None and slam.imu_initialized:
                init_at = i
        traj = slam.get_trajectory()
        ts = np.asarray([t for t, _ in traj])[VI_SKIP:]
        pos = np.stack([T[:3, 3] for _, T in traj])[VI_SKIP:]
        metric, n_m, _ = ate_rmse(ts, pos, seq.timestamps, seq.t_wc, with_scale=False)
        res[tag] = dict(map_at=map_at, init_at=init_at, metric=metric, n=n_m, state=slam.state,
                        stage=slam.imu_stage, resets=slam.bad_imu_resets,
                        launches=dict(project_match.LAUNCHES),
                        replica=None if slam._replica is None else dict(slam._replica.counts))
    s, o = res["split"], res["one"]
    print(f"split VI {devices}: {n} frames of phase 8's sequence, map initialized at frame "
          f"{s['map_at']}, IMU at {s['init_at']} (one device: {o['map_at']}, {o['init_at']}), "
          f"stage {s['stage']}, metric ATE "
          f"{s['metric']:.5f} m over {s['n']} poses (one device: {o['metric']:.5f} m), replica "
          f"refreshes {s['replica']}, K1 launches {s['launches']}; {time.perf_counter() - t0:.1f} s")
    # VI_INIT_BY bounds the map's initialization, as in phase 8; at phase 8's
    # configuration the IMU initializes at its sixth keyframe, frame ~32
    check(s["map_at"] is not None and s["map_at"] <= VI_INIT_BY,
          f"split VI: the map not initialized by frame {VI_INIT_BY}")
    check(s["init_at"] is not None and s["init_at"] <= o["init_at"],
          f"split VI: the IMU initialized at frame {s['init_at']}, one device at {o['init_at']}")
    check(s["state"] == system.OK and s["resets"] == 0, f"split VI ended in state {s['state']}")
    check(s["metric"] <= 2 * o["metric"], f"split VI metric ATE {s['metric']:.5f} m above 2x "
                                          f"one device's {o['metric']:.5f} m")
    check(s["replica"]["max_stale"] <= 1, f"split VI replica {s['replica']}")
    return dict(res, launches=s["launches"])


def kb8_vi_sequence(torch, n_frames: int, rig=None):
    """``make_vi_sequence(seed=0)`` of phase 8 (its trajectory, IMU and
    room) with its views rendered through the KB8 camera at the TUM-VI shape
    instead of the pinhole: (sequence, IMU, right frames or None)."""
    from orb_slam3_ros_tpu_torch.utils import synth
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW

    kw = {**VI_SEQ_KW, "n_frames": n_frames, "height": FE_H, "width": FE_W}
    seq, im = synth.make_vi_sequence(**kw)
    left, right = kb8_views(torch, synth.make_room(seed=kw["seed"]), seq.R_wc, seq.t_wc, rig)
    return seq._replace(images=left, cam_params=FE_KB8), im, right


def phase_kb8_vi(torch, project_match, vc: dict) -> dict:
    """Phase 19 (a): ``InertialSlam(cam_model="kb8")`` through phase 9's
    protocol on phase 8's trajectory and IMU seen through the KB8 camera."""
    from orb_slam3_ros_tpu_torch.models import system
    from orb_slam3_ros_tpu_torch.models.inertial_system import InertialSlam
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SEQ_KW, VI_SLAM_KW, vi_calib

    n = VI_SEQ_KW["n_frames"]
    seq, im, _ = kb8_vi_sequence(torch, n)
    slam = InertialSlam(**{**VI_SLAM_KW, "height": FE_H, "width": FE_W}, cam_params=FE_KB8,
                        cam_model="kb8", calib=vi_calib())
    stack = torch.clamp(seq.images, 0, 255).to(torch.uint8)

    def chunk(i, k):
        slam.process_frames((stack, i), seq.timestamps[i : i + k], acc=im["acc"][i : i + k],
                            gyro=im["gyro"][i : i + k], dts=im["dts"][i : i + k])

    t0 = time.perf_counter()
    first, lost, imu_at, i, first_vi = [], [], None, 0, None
    while i < CHUNK_WARM - 2 * CHUNK and not slam._vi_chunkable():
        per_frame_run(lambda j: slam.process_frame(seq.images[j], float(seq.timestamps[j]),
                                                   acc=im["acc"][j], gyro=im["gyro"][j],
                                                   dts=im["dts"][j]), [i], first, lost)
        if slam.imu_initialized and imu_at is None:
            imu_at = i
        if first_vi is None and slam.pipe_counts["vi_dispatches"]:
            first_vi = i
        i += 1
    gate = i
    # a VI call returns the frame before it: the first one returns None
    lost = [j for j in lost if j != first_vi]
    check(slam._vi_chunkable(), f"kb8 vi: the chunk gate not passed by frame {gate} (IMU stage "
          f"{slam.imu_stage}, state {slam.state})")
    while i + CHUNK <= CHUNK_WARM:
        chunk(i, CHUNK)
        i += CHUNK
    runner = slam._vi_runner
    check(runner is not None and runner.graphs, "kb8 vi: the chunks did not run on graphs")
    start, chunk_ms = i, []
    runner.timing = True
    reset_launches(project_match)
    runs0, warm0 = dict(runner.runs), dict(runner.warmup_launches)
    while i + CHUNK <= n:
        t1 = time.perf_counter()
        chunk(i, CHUNK)
        chunk_ms.append((time.perf_counter() - t1) * 1e3)
        i += CHUNK
    torch.cuda.synchronize()
    runner.timing = False
    launches = dict(project_match.LAUNCHES)
    secs = time.perf_counter() - t0
    runs = {k: runner.runs[k] - runs0.get(k, 0) for k in runner.runs}
    warm = {k: runner.warmup_launches[k] - warm0[k] for k in warm0}
    timed = i - start
    fusing = runs.get("kf_fuse", 0)
    passes = len(slam._current_schedule())
    want = {"track": passes * timed + warm["track"], "fuse": 2 * fusing + warm["fuse"], "sim3": 0,
            "merge": 0}
    acc = vi_accuracy(slam, seq, im, n)
    spans, kf_graph_ms, busy, step_ms, gap_us, nodes = replay_stats(runner, chunk_ms,
                                                                     runs.get("kf_insert", 0))
    worst = graph_vs_eager(torch, runner, slam._current_schedule())
    audit = region_syncs(torch, runner, slam._current_schedule())
    fps = timed / (sum(chunk_ms) / 1e3)
    print(f"kb8 (a): InertialSlam(cam_model=\"kb8\") {FE_W}x{FE_H}, phase 8's trajectory and IMU: "
          f"map at frame {first and first[0]}, IMU at frame {imu_at}, chunkable at frame {gate}; "
          f"timed frames {start}..{i - 1}: {fps:.2f} frames/s (phase 9, pinhole 752x480: "
          f"{vc['frames_per_s']:.2f}); step graph {step_ms:.2f} ms (phase 9: {vc['step_ms']:.2f}), "
          f"nodes {nodes} (phase 9: {vc['graph_nodes']}); keyframe graphs {kf_graph_ms:.2f} ms a "
          f"keyframe; busy {busy:.1%}; metric ATE {acc['ate_metric_m']:.5f} m (phase 9: "
          f"{vc['ate_metric_m']:.5f} m; the JAX package, CPU, pinhole {KB8_JAX['a_pinhole_ate_m']:.5f}"
          f" m, its KB8 run {KB8_JAX['a_kb8_ate_m']:.5f} m), scale {acc['scale']:.5f}, R[2,2] "
          f"{acc['r22']:.5f}, bg err {acc['bg_err']:.2e}; lost {lost}; K1 launches {launches} "
          f"(predicted {want}: {passes} x {timed} + 2 x {fusing} fusing keyframes + warm-ups "
          f"{warm}); graph vs eager {worst:.3g}; syncs {audit}; {secs:.1f} s")
    check(first and first[0] <= VI_INIT_BY and not lost, f"kb8 vi: map at frame "
          f"{first and first[0]}, frames lost {lost}")
    check(slam.imu_initialized and slam.imu_stage == 3 and slam.bad_imu_resets == 0
          and slam.state == system.OK, f"kb8 vi: IMU {slam.imu_initialized} stage {slam.imu_stage}"
          f", resets {slam.bad_imu_resets}, state {slam.state}")
    check(acc["ate_metric_m"] <= VI_ATE_LIMIT,
          f"kb8 vi: metric ATE {acc['ate_metric_m']:.5f} m above {VI_ATE_LIMIT} m")
    check(abs(acc["scale"] - 1.0) <= VI_SCALE_TOL, f"kb8 vi: scale {acc['scale']:.5f}")
    check(launches == want, f"kb8 vi: K1 launches {launches}, predicted {want}")
    check(not any(audit.values()), f"kb8 vi: synchronizing calls in the eager regions: {audit}")
    return dict(init_frame=first[0], imu_frame=imu_at, chunkable_frame=gate, timed_frames=timed,
                frames_per_s=fps, step_ms=step_ms, graph_nodes=nodes, kf_graph_ms=kf_graph_ms,
                busy=busy, graph_vs_eager=worst, region_syncs=audit, launches=launches,
                predicted=want, fusing_keyframes=fusing, seconds=secs, **acc)


def phase_kb8_rig_vi(torch, project_match) -> dict:
    """Phase 19 (b): ``FisheyeStereoInertialSlam()`` at its KB8 default on
    phase 16 (b)'s rig, both views of phase 8's trajectory rendered through
    the KB8 camera, per frame."""
    from orb_slam3_ros_tpu_torch.models.fisheye_stereo import FisheyeStereoInertialSlam
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import vi_calib

    R_rl, t_rl = fe_rig()
    n = KB8_RIG_FRAMES
    seq, im, right = kb8_vi_sequence(torch, n, rig=(R_rl, t_rl))
    slam = FisheyeStereoInertialSlam(height=FE_H, width=FE_W, cam_params=FE_KB8,
                                     calib=vi_calib(), R_rl=R_rl, t_rl=t_rl, **FE_VI_KW)
    reset_launches(project_match)
    first, lost = [], []
    t0 = time.perf_counter()
    with ProgramWatch(torch, project_match, "kb8 (b)") as watch:
        per_frame_run(lambda i: slam.process_frame(
            seq.images[i], right[i], float(seq.timestamps[i]), acc=im["acc"][i],
            gyro=im["gyro"][i], dts=im["dts"][i]), range(n), first, lost)
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    progs = watch.report(frames=n)
    acc = traj_ate(slam, seq.timestamps, seq.t_wc, with_scale=False)
    print(f"kb8 (b): FisheyeStereoInertialSlam() (cam_model {slam.cam_model!r}, {FE_BASE} m rig "
          f"yawed {FE_YAW} rad) {FE_W}x{FE_H}, {n} frames per frame in {secs:.1f} s: "
          f"initialized at frame {first and first[0]}, lost {lost}; IMU stage {slam.imu_stage} "
          f"(scale fixed {slam.imu_fix_scale}); metric ATE {acc['ate_metric_m']:.5f} m (phase 16 "
          f"(c), pinhole: 0.00232 m on the card; the JAX package, CPU, its KB8 run "
          f"{KB8_JAX['b_kb8_ate_m']:.5f} m), scale {acc['scale']:.5f}; {slam.n_kf} keyframes; K1 "
          f"launches {launches}")
    check(slam.cam_model == "kb8" and first, f"kb8 rig: camera {slam.cam_model}, first {first}")
    check(slam.imu_initialized and slam.imu_fix_scale,
          f"kb8 rig: IMU initialized {slam.imu_initialized}, fix_scale {slam.imu_fix_scale}")
    check(abs(acc["scale"] - 1.0) <= FE_VI_SCALE_TOL, f"kb8 rig: scale {acc['scale']:.5f}")
    check(acc["ate_metric_m"] <= VI_ATE_LIMIT,
          f"kb8 rig: metric ATE {acc['ate_metric_m']:.5f} m above {VI_ATE_LIMIT} m")
    check(launches["track"] > 0, "kb8 rig: no tracking search launched")
    return dict(init_frame=first[0], lost=lost, imu_stage=slam.imu_stage, keyframes=slam.n_kf,
                frames_per_s=n / secs, launches=launches, seconds=secs, programs=progs, **acc)


def kb8_loop_run(torch, imgs, ts, close: bool, times=None):
    """Phase 19 (c)'s run: phase 12 (a)'s settings through the KB8 camera,
    per frame to the chunk gate, then chunks of 15 (the rest per frame),
    flushed. ``times``: {"closure": [], "pgo": []} gets each correction's
    and each essential-graph solve's host ms (the solve ended by a sync)."""
    from orb_slam3_ros_tpu_torch.models import loop_closing
    from orb_slam3_ros_tpu_torch.models.system import OK, MonoSlam

    slam = MonoSlam(height=FE_H, width=FE_W, cam_params=FE_KB8, cam_model="kb8",
                    n_features=N_FEATURES, max_keyframes=64, max_points=LOOP_MAX_POINTS,
                    kf_every=3, track_window=8, enable_loop_closing=close, pipelined=False)
    pgo_fn = loop_closing._essential_graph_pgo
    if close:
        slam.loop_closer.min_gap = 8
        slam.loop_closer.min_sim3_inliers = 15
        apply = slam.loop_closer._apply_closure

        def timed(fn, out):
            def run(*a, **kw):
                t1 = time.perf_counter()
                res = fn(*a, **kw)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t1) * 1e3)
                return res
            return run

        slam.loop_closer._apply_closure = timed(apply, times["closure"])
        loop_closing._essential_graph_pgo = timed(pgo_fn, times["pgo"])
    stack = torch.clamp(imgs, 0, 255).to(torch.uint8)
    n, i = len(ts), 0
    try:
        while i < n:
            if slam.state == OK and slam._chunkable() and i + CHUNK <= n:
                slam.process_frames((stack, i), ts[i : i + CHUNK])
                i += CHUNK
            else:
                slam.process_frame(imgs[i], float(ts[i]))
                i += 1
        slam.flush()
    finally:
        loop_closing._essential_graph_pgo = pgo_fn
    return slam


def phase_kb8_loop(torch, project_match) -> dict:
    """Phase 19 (c): ``MonoSlam(cam_model="kb8", enable_loop_closing=True)``
    on phase 12 (a)'s closed loop seen through the KB8 camera, against the
    same run without loop closing."""
    from orb_slam3_ros_tpu_torch.utils import synth

    R_wc, t_wc, ts = synth.loop_trajectory(LOOP_FRAMES, dt=0.1)
    imgs, _ = kb8_views(torch, synth.make_room(seed=5), R_wc, t_wc)
    truth = SimpleNamespace(timestamps=ts, t_wc=t_wc)
    t0 = time.perf_counter()
    watch = ProgramWatch(torch, project_match, "kb8 (c)").__enter__()
    open_slam = kb8_loop_run(torch, imgs, ts, close=False)
    rmse_open = ate(open_slam, truth, len(open_slam.get_trajectory()), with_scale=True)
    reset_launches(project_match)
    t1 = time.perf_counter()
    times = {"closure": [], "pgo": []}
    try:
        with SearchRecorder(project_match, "sim3") as rec:
            slam = kb8_loop_run(torch, imgs, ts, close=True, times=times)
    finally:
        watch.__exit__()
    torch.cuda.synchronize()
    loop_s, secs = time.perf_counter() - t1, time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    kfw = watch.report(mono=True)
    check(all(r["prog"].cfg.cam_model == "kb8" for r in watch.mkf),
          "kb8 loop: a keyframe program not on the KB8 camera")
    lc = slam.loop_closer
    rmse = ate(slam, truth, len(slam.get_trajectory()), with_scale=True)
    times = {k: [round(x, 1) for x in v] for k, v in times.items()}
    print(f"kb8 (c): {LOOP_FRAMES} frames of the closed loop through the KB8 camera {FE_W}x{FE_H}: "
          f"closures {lc.closures}, Sim(3) ATE {rmse:.5f} m (without loop closing {rmse_open:.5f} "
          f"m; phase 12 (a), pinhole: the print above), {slam.n_kf} keyframes, global BAs "
          f"{slam.gba_counts}; closure / PGO ms {times}; K1 launches {launches} "
          f"({lc.sim3_searches} SearchBySim3 calls); run {loop_s:.1f} s ({secs:.1f} s with the "
          f"open run)")
    check(len(lc.closures) >= 1, "kb8 loop: no loop closure fired")
    check(rmse <= KB8_LOOP_OPEN_RATIO * rmse_open and rmse <= MAP_ATE_LIMIT,
          f"kb8 loop: ATE {rmse:.5f} m with loop closing, {rmse_open:.5f} m without")
    check(launches["sim3"] == lc.sim3_searches >= 1,
          f"kb8 loop: {launches['sim3']} SearchBySim3 launches, the closer made "
          f"{lc.sim3_searches} searches")
    k1 = site_kernel(torch, project_match, rec, "kb8 (c) SearchBySim3 on KB8 projections")
    return dict(closures=lc.closures, ate_sim3_m=rmse, ate_open_m=rmse_open, keyframes=slam.n_kf,
                gba=slam.gba_counts, sim3_searches=lc.sim3_searches, closure_ms=times,
                launches=launches, run_s=loop_s, seconds=secs, k1=k1,
                kf_program={k: v for k, v in kfw.items() if k.startswith("mkf_")})


def phase_kb8_atlas(torch, project_match) -> dict:
    """Phase 19 (d): phase 14 (a)'s blackout on phase 7's trajectory seen
    through the KB8 camera, ``MonoSlam(cam_model="kb8", enable_atlas=True)``."""
    from orb_slam3_ros_tpu_torch.models import system
    from orb_slam3_ros_tpu_torch.utils import synth

    R_wc, t_wc, ts0 = synth.orbit_trajectory(MAP_FRAMES, dt=0.1)
    imgs, _ = kb8_views(torch, synth.make_room(seed=3), R_wc, t_wc)
    seq = SimpleNamespace(images=imgs, timestamps=ts0, t_wc=t_wc, cam_params=FE_KB8)
    tss, frames, images, stack = atlas_steps(torch, seq)
    slam = make_slam(seq, "cuda", height=FE_H, width=FE_W, cam_model="kb8", kf_every=3,
                     enable_atlas=True, lost_patience=3, transfer_uint8=True)
    ev = {"switch": 0, "weld": 0, "attempts": [], "frame": None}
    count_atlas(slam, ev)
    reset_launches(project_match)
    t0 = time.perf_counter()
    rec = SearchRecorder(project_match, "merge").__enter__()
    watch = ProgramWatch(torch, project_match, "kb8 (d)").__enter__()
    try:
        for s in range(ATLAS_MAP + ATLAS_BLANK):
            slam.process_frame(images[s], float(tss[s]))
        archived = len(slam.atlas.maps)
        s, end, back, tracked_at, back_ts = ATLAS_MAP + ATLAS_BLANK, ATLAS_END + ATLAS_BLANK, None, None, None
        while s < end:
            chunked = slam.state == system.OK and slam._chunkable() and s + CHUNK <= end
            maps0 = len(slam.atlas.maps)
            ev["frame"] = frames[s + CHUNK - 1] if chunked else frames[s]
            if chunked:
                slam.process_frames((stack, s), tss[s : s + CHUNK])
                s += CHUNK
            else:
                if slam.process_frame(images[s], float(tss[s])) is not None and tracked_at is None:
                    tracked_at = frames[s]
                s += 1
            if maps0 and not slam.atlas.maps and back is None:
                back, back_ts = frames[s - 1], float(tss[s])
        slam.flush()
    finally:
        watch.__exit__()
        rec.__exit__()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(project_match.LAUNCHES)
    kfw = watch.report(mono=True)
    route = "switch" if ev["switch"] else "weld" if ev["weld"] else None
    rmse, n_ate = atlas_ate(slam, seq, tss, frames, back_ts) if back is not None else (np.inf, 0)
    print(f"kb8 (d): the blackout through the KB8 camera {FE_W}x{FE_H}: {archived} map(s) archived; "
          f"tracking again at frame {tracked_at}; the archived map back at frame {back} by {route} "
          f"(phase 14 (a), pinhole: weld 21 frames after tracking again); weld attempts "
          f"{ev['attempts']}; state {slam.state}, {len(slam.atlas.maps)} maps left; Sim(3) ATE after "
          f"the return {rmse:.5f} m over {n_ate} poses; K1 launches {launches}, "
          f"{slam.atlas.grow_searches} cross-map searches; {secs:.1f} s")
    check(archived == 1, f"kb8 atlas: {archived} maps archived at the blackout")
    check(route is not None and not slam.atlas.maps and slam.state == system.OK,
          f"kb8 atlas: the archived map back by {route}, {len(slam.atlas.maps)} maps left, state "
          f"{slam.state}")
    check(rmse <= MAP_ATE_LIMIT, f"kb8 atlas: Sim(3) ATE after the return {rmse:.5f} m")
    check(launches["merge"] == slam.atlas.grow_searches,
          f"kb8 atlas: {launches['merge']} merge launches, {slam.atlas.grow_searches} searches")
    k1 = (site_kernel(torch, project_match, rec, "kb8 (d) the merge search on KB8 projections")
          if rec.args is not None else None)
    return dict(archived=archived, tracked_at=tracked_at, back_at=back, route=route,
                weld_attempts=ev["attempts"], ate_sim3_m=rmse, ate_poses=n_ate,
                grow_searches=slam.atlas.grow_searches, launches=launches, seconds=secs, k1=k1,
                kf_program={k: v for k, v in kfw.items() if k.startswith("mkf_")})


def site_kernel(torch, project_match, rec, what: str) -> dict:
    """K1 on the first search a ``SearchRecorder`` kept: exact against its
    plain version, then timed (call, plain call, device time) beside its
    bound."""
    check(rec.args is not None, f"{what}: no search input was recorded")
    err, n_match = kernel_vs_plain(torch, project_match, rec.args, rec.kw, what)
    # an empty search (no candidates, say a warm-up's blank frame) agrees
    # with any kernel
    check(n_match > 0, f"{what}: the recorded search has no matches")
    kernel = lambda: project_match.project_match(*rec.args, **rec.kw)  # noqa: E731
    out = dict(max_abs_err=err, matches=n_match, P=int(rec.args[0].shape[0]),
               N=int(rec.args[5].shape[0]), ms=cuda_ms(kernel, 100),
               plain_ms=cuda_ms(lambda: project_match.project_match_reference(*rec.args, **rec.kw),
                                100),
               device_us=device_us(kernel), **search_bound(torch, project_match, rec.args, rec.kw))
    print(f"{what}: kernel vs plain at P={out['P']} N={out['N']} {rec.kw}: max |diff| {err}, "
          f"{n_match} matches; call {out['ms'] * 1e3:.1f} us, plain {out['plain_ms'] * 1e3:.1f} us, "
          f"device {out['device_us']:.2f} us, bound {out['bound_us']:.3f} us by {out['bound_by']}")
    return out


def phase_kb8(torch, project_match, vc: dict) -> dict:
    """Phase 19: the KB8 camera's inertial, loop-closing and Atlas paths."""
    t0 = time.perf_counter()
    out = dict(a=phase_kb8_vi(torch, project_match, vc), b=phase_kb8_rig_vi(torch, project_match),
               c=phase_kb8_loop(torch, project_match), d=phase_kb8_atlas(torch, project_match))
    secs = time.perf_counter() - t0
    launches = {k: sum(x["launches"][k] for x in out.values()) for k in out["a"]["launches"]}
    print(f"phase 19: {secs:.1f} s; K1 launches on its main paths {launches}")
    return dict(out, launches=launches, seconds=secs)


def phase_scale(torch, project_match, mp: dict, seq) -> dict:
    """Phase 18: the scale-out solvers and the two-device split."""
    t0 = time.perf_counter()
    out = dict(a=phase_scale_out(torch), b=phase_split(torch, project_match, mp, seq),
               c=phase_split_vi(torch, project_match))
    launches = {k: out["b"]["launches"][k] + out["c"]["launches"][k] for k in out["b"]["launches"]}
    print(f"phase 18: {time.perf_counter() - t0:.1f} s")
    return dict(out, launches=launches)


def phase_pipelined(torch, project_match, mp: dict, mc: dict, seq, card: str) -> dict:
    """Phase 20: ``MonoSlam`` at its default, the pipelined one-frame lag,
    per frame over phase 7's sequence and configuration: each OK frame one
    replay of the frame graph, frame i-1 drained after frame i's dispatch,
    the keyframe work queued with its results deferred, as replays of the
    keyframe program (``ProgramWatch``). Counts the synchronizing calls of
    every frame's dispatch and every keyframe's queued work (but the
    captures'), in the run; CUDA events around every replay."""
    from orb_slam3_ros_tpu_torch.models import kf_work, system

    t0 = time.perf_counter()
    slam = system.MonoSlam(**mono_kw(seq, "cuda"))
    check(slam.pipelined, "MonoSlam's default is not the pipelined mode")
    prog = slam._frame_program()
    prog.timing = True
    syncs = {"dispatch": [], "keyframe": []}
    dispatch, queue, work = slam._dispatch, slam._queue_keyframe, kf_work.keyframe_work
    passes = fusing = 0

    def counted_dispatch(img, ts, schedule, prev):
        nonlocal passes
        graphs = prog.n_graphs
        out, n = counting_syncs(torch, dispatch, img, ts, schedule, prev)
        passes += len(schedule)
        if prog.n_graphs == graphs:  # a capture synchronizes its side stream
            syncs["dispatch"].append(n)
        return out

    def counted_queue(*args):
        k0 = len(watch.mkf)
        n = counting_syncs(torch, queue, *args)[1]
        # the program's run counts its own (a nested count ends the outer one)
        new = watch.mkf[k0:]
        if not any(r["capturing"] for r in new):
            syncs["keyframe"].append(n + sum(r["syncs"] for r in new))

    def counted_work(*args, **kw):
        nonlocal fusing
        fusing += bool(kw["do_fuse"])
        return work(*args, **kw)

    slam._dispatch, slam._queue_keyframe, kf_work.keyframe_work = (counted_dispatch,
                                                                   counted_queue, counted_work)
    watch = ProgramWatch(torch, project_match, "pipelined").__enter__()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(project_match)
    outs, call_ms, ok_calls, init_at = [], [], 0, None
    try:
        for i in range(MAP_FRAMES):
            ok_calls += slam.state == system.OK
            t_call = time.perf_counter()
            outs.append(slam.process_frame(seq.images[i], float(seq.timestamps[i])))
            call_ms.append((time.perf_counter() - t_call) * 1e3)
            if init_at is None and outs[-1] is not None:
                init_at = i
            check(init_at is not None or i < MAP_INIT_BY, f"not initialized by frame {MAP_INIT_BY}")
        t_flush = time.perf_counter()
        last = slam.flush()
        flush_ms = (time.perf_counter() - t_flush) * 1e3
    finally:
        watch.__exit__()
        slam._dispatch, slam._queue_keyframe, kf_work.keyframe_work = dispatch, queue, work
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = dict(project_match.LAUNCHES)
    kfw = watch.report(mono=True)
    fusing += kfw["fusing_keyframes"]
    extra = kfw["warmup_launches"]
    counts = dict(slam.pipe_counts)
    traj = list(slam.trajectory)
    check(init_at == mp["init_frame"], f"initialized at frame {init_at}, phase 7 at "
          f"{mp['init_frame']}")
    check(len(traj) == MAP_FRAMES - init_at and slam.state == system.OK,
          f"{len(traj)} poses of {MAP_FRAMES - init_at} frames after initialization")
    # call i returns frame i-1's entry (the first call after initialization
    # has nothing in flight; the flush returns the last frame's)
    check(outs[init_at + 1] is None and all(o is not None for o in outs[init_at + 2:]),
          "a call after initialization returned no pose")
    for i in range(init_at + 2, MAP_FRAMES):
        ts_i, T_i = traj[i - 1 - init_at]
        check(abs(ts_i - float(seq.timestamps[i - 1])) < 1e-6 and np.array_equal(outs[i], T_i),
              f"call {i} did not return frame {i - 1}'s pose")
    check(last is not None and np.array_equal(last, traj[-1][1]), f"flush did not drain frame {MAP_FRAMES - 1}")
    rmse = ate(slam, seq, MAP_FRAMES - init_at, with_scale=True)
    check(rmse <= MAP_ATE_LIMIT and rmse <= 2 * mp["ate_sim3_m"],
          f"pipelined ATE {rmse:.5f} m above {MAP_ATE_LIMIT} m or 2x phase 7's "
          f"{mp['ate_sim3_m']:.5f} m")
    runs = sum(prog.runs.values())
    check(prog.graphs and runs == counts["dispatches"] == ok_calls,
          f"{runs} frame-graph replays, {counts['dispatches']} dispatches, {ok_calls} OK frames")
    fuse_pred = 2 * fusing + prog.warmup_launches["fuse"] + extra["fuse"]
    track_pred = passes + prog.warmup_launches["track"] + extra["track"]
    check(launches == {"track": track_pred, "fuse": fuse_pred, "sim3": 0, "merge": 0},
          f"K1 launches {launches}, expected {track_pred} from the frame graphs (passes {passes} "
          f"+ {prog.warmup_launches['track']} warm-up) and {fuse_pred} from fusion (the keyframe "
          f"program's capture warm-ups {extra} included)")
    check(kfw["mkf_deferred"] == kfw["mono_keyframes"] == counts["kf_deferred"],
          f"{kfw['mkf_deferred']} deferred program keyframes of {kfw['mono_keyframes']}, "
          f"{counts['kf_deferred']} deferred")
    check(syncs["dispatch"] and not any(syncs["dispatch"]) and syncs["keyframe"]
          and not any(syncs["keyframe"]),
          f"synchronizing calls: dispatches {sorted(set(syncs['dispatch']))}, keyframes "
          f"{syncs['keyframe']}")
    label = {slam._sched_dense: "dense", slam._sched_lean: "lean"}
    by_schedule = {label[name[1]]: n for name, n in prog.runs.items()}
    worst = graph_vs_eager(torch, prog, slam._current_schedule(), "frame")
    steady = call_ms[init_at + WARM + 1:]
    fps = len(steady) / (sum(steady) / 1e3)
    lat = np.percentile(steady, [50, 80])
    graph_ms = [a.elapsed_time(b) for _, a, b in prog.spans]
    nodes = {label[name[1]]: graph_nodes(g) for name, (g, _) in prog._graph.items()}
    ready = counts["ready"] / max(1, counts["drains"])
    stages = {k: round(v[0] * 1e3, 3) for k, v in slam.timing_summary().items()}
    print(f"pipelined ({card}): MonoSlam() at its default over phase 7's {MAP_FRAMES} frames: "
          f"initialized at frame {init_at}, {len(traj)} poses, Sim(3) ATE {rmse:.5f} m (phase 7: "
          f"{mp['ate_sim3_m']:.5f}); {fps:.2f} frames/s steady over {len(steady)} frames (phase 7 "
          f"per frame {mp['frames_per_s']:.2f}, phase 10 chunks {mc['frames_per_s']:.2f}); host ms "
          f"a call median {lat[0]:.2f}, p80 {lat[1]:.2f}, flush {flush_ms:.2f}; stages {stages}")
    print(f"pipelined ({card}): {counts['dispatches']} dispatches = OK frames = frame-graph "
          f"replays ({by_schedule}), graph device ms median "
          f"{np.median(graph_ms):.3f} (min {min(graph_ms):.3f}, max {max(graph_ms):.3f}), nodes "
          f"{nodes}, captured in {prog.capture_s:.2f} s; drains whose copy had landed "
          f"{counts['ready']}/{counts['drains']} ({ready:.3f}); keyframes deferred "
          f"{counts['kf_deferred']}; map copies {prog.map_copies}; syncs in a dispatch 0 over "
          f"{len(syncs['dispatch'])}, in a keyframe's queued work 0 over {len(syncs['keyframe'])}; "
          f"graph = eager to {worst:.3g}; K1 {launches} (passes {passes}, fusing keyframes "
          f"{fusing}, warm-up {prog.warmup_launches}, the keyframe program's {extra}); peak device "
          f"memory {peak / 2**20:.1f} MiB; "
          f"phase 20 {time.perf_counter() - t0:.1f} s")
    return dict(init_frame=init_at, poses=len(traj), ate_sim3_m=rmse, frames_per_s=fps,
                phase7_frames_per_s=mp["frames_per_s"], chunk_frames_per_s=mc["frames_per_s"],
                call_ms_p50=float(lat[0]), call_ms_p80=float(lat[1]), flush_ms=flush_ms,
                stages_ms=stages, dispatches=counts["dispatches"], replays=runs,
                graph_ms_p50=float(np.median(graph_ms)), graph_nodes=nodes,
                capture_s=prog.capture_s, drains=counts["drains"], drains_ready=counts["ready"],
                ready_share=ready, kf_deferred=counts["kf_deferred"], map_copies=prog.map_copies,
                sync_free_dispatches=len(syncs["dispatch"]),
                sync_free_keyframes=len(syncs["keyframe"]),
                graph_vs_eager=worst, launches=launches, passes=passes, fusing_keyframes=fusing,
                warmup_launches=dict(prog.warmup_launches), peak_mem_mib=peak / 2**20,
                kf_program={k: v for k, v in kfw.items() if k.startswith("mkf_")},
                phase_s=time.perf_counter() - t0)


def phase_vi_pipelined(torch, project_match, vi: dict, seq, im, card: str) -> dict:
    """Phase 21: ``InertialSlam(pipelined=True)`` over phase 8's sequence
    and configuration, per frame: the visual frames through the mono frame
    graph with their keyframe work deferred, the handoff (the visual frame
    in flight when the IMU initializes is run again through the VI frame
    graph and posted first), then the VI frames through the VI frame graph,
    one frame behind. Counts each dispatch's synchronizing calls and K1's
    launches by replay; keeps the run's first tracking search for K1 against
    its plain version."""
    from orb_slam3_ros_tpu_torch.models import inertial_system, kf_work, system
    from orb_slam3_ros_tpu_torch.utils.profile_keyframe import VI_SLAM_KW, vi_calib

    t0 = time.perf_counter()
    n_frames = VI_PIPE_FRAMES
    slam = inertial_system.InertialSlam(cam_params=seq.cam_params, calib=vi_calib(),
                                        pipelined=True, **VI_SLAM_KW)
    syncs = {"visual": [], "vi": []}
    posted, fusing = [], 0
    dispatch, dispatch_vi, log_pose = slam._dispatch, slam._dispatch_vi, slam._log_pose
    work = kf_work.keyframe_work
    watch = ProgramWatch(torch, project_match, "vi pipelined")

    def counted(fn, kind, prog_of):
        def run(*args):
            prog = prog_of()
            graphs = 0 if prog is None else prog.n_graphs
            out, n = counting_syncs(torch, fn, *args)
            if graphs == prog_of().n_graphs:  # a capture synchronizes its side stream
                syncs[kind].append(n)
            return out
        return run

    def logged(ts):
        posted.append(ts)
        log_pose(ts)

    def counted_work(*args, **kw):
        nonlocal fusing
        fusing += bool(kw["do_fuse"])
        return work(*args, **kw)

    slam._dispatch = counted(dispatch, "visual", lambda: slam._frame_prog)
    slam._dispatch_vi = counted(dispatch_vi, "vi", lambda: slam._vi_prog)
    slam._log_pose = logged
    kf_work.keyframe_work = counted_work
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(project_match)
    outs, call_ms, init_at, imu_at, stage3_at = [], [], None, None, None
    # The first search of a frame with features (the graph captured at the
    # initialization warms up on an empty image buffer; no search is kept
    # while a graph is being captured)
    rec = SearchRecorder(project_match, "track", keep=lambda args: (
        not torch.cuda.is_current_stream_capturing() and bool(args[7].any()))).__enter__()
    watch.__enter__()
    try:
        for i in range(n_frames):
            t_call = time.perf_counter()
            outs.append(slam.process_frame(seq.images[i], float(seq.timestamps[i]),
                                           acc=im["acc"][i], gyro=im["gyro"][i], dts=im["dts"][i]))
            call_ms.append((time.perf_counter() - t_call) * 1e3)
            if init_at is None and outs[-1] is not None:
                init_at = i
            elif init_at is not None:
                check(slam.state == system.OK, f"vi pipelined: state {slam.state} at frame {i}")
            if imu_at is None and slam.imu_initialized:
                imu_at = i
            if stage3_at is None and slam.imu_stage == 3:
                stage3_at = i
            check(init_at is not None or i < VI_INIT_BY,
                  f"vi pipelined: not initialized by frame {VI_INIT_BY}")
        slam.flush()
    finally:
        watch.__exit__()
        rec.__exit__()
        kf_work.keyframe_work = work
        for k in ("_dispatch", "_dispatch_vi", "_log_pose"):
            del vars(slam)[k]
    torch.cuda.synchronize()
    launches = dict(project_match.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    counts = dict(slam.pipe_counts)
    kfw = watch.report()
    fusing += kfw["fusing_keyframes"]
    acc = vi_accuracy(slam, seq, im, n_frames)
    fp, vp = slam._frame_prog, slam._vi_prog
    progs = {"visual": fp, "vi": vp}
    replays = {k: sum(p.runs.values()) for k, p in progs.items()}
    passes = {k: sum(len(name[1]) * n for name, n in p.runs.items()) for k, p in progs.items()}
    # the keyframe program's capture warm-ups launch K1 too
    warm = {site: fp.warmup_launches[site] + vp.warmup_launches[site]
            + kfw["warmup_launches"][site] for site in launches}
    want = {"track": passes["visual"] + passes["vi"] + warm["track"],
            "fuse": 2 * fusing + warm["fuse"], "sim3": 0, "merge": 0}
    nones = [i for i in range(init_at, n_frames) if outs[i] is None]
    steady = call_ms[stage3_at + 1:]
    fps = len(steady) / (sum(steady) / 1e3)
    lat = np.percentile(steady, [50, 80])
    k1 = site_kernel(torch, project_match, rec, "vi pipelined: the run's first tracking search")
    print(f"vi pipelined ({card}): InertialSlam(pipelined=True) over phase 8's {n_frames} frames: "
          f"initialized at frame {init_at} (phase 8: {vi['init_frame']}), IMU at frame {imu_at}, "
          f"stage {slam.imu_stage}, {acc['poses']} poses; metric ATE {acc['ate_metric_m']:.5f} m "
          f"(phase 8: {vi['ate_metric_m']:.5f}), scale {acc['scale']:.5f}, R[2,2] "
          f"{acc['r22']:.5f}, bg err {acc['bg_err']:.2e}; calls returning None after "
          f"initialization {nones}; {fps:.2f} frames/s over the {len(steady)} calls after stage 3 "
          f"(phase 8: {vi['frames_per_s']:.2f}), host ms a call median {lat[0]:.2f}, p80 "
          f"{lat[1]:.2f}; dispatches {counts}; replays {replays}, K1 {launches} (predicted "
          f"{want}: passes {passes}, fusing keyframes {fusing}, warm-ups {warm}); syncs in a "
          f"steady dispatch: visual {sorted(set(syncs['visual']))} over {len(syncs['visual'])}, "
          f"VI {sorted(set(syncs['vi']))} over {len(syncs['vi'])}; peak device memory "
          f"{peak / 2**20:.1f} MiB; phase 21 {time.perf_counter() - t0:.1f} s")
    check_vi_accuracy(acc, "vi pipelined")
    check(slam.imu_stage == 3 and slam.bad_imu_resets == 0 and slam.state == system.OK,
          f"vi pipelined: stage {slam.imu_stage}, resets {slam.bad_imu_resets}, state {slam.state}")
    check(init_at <= VI_INIT_BY and acc["poses"] == n_frames - init_at
          and posted == [float(t) for t in seq.timestamps[init_at:n_frames]],
          f"vi pipelined: {acc['poses']} poses of {n_frames - init_at} frames, or posted out of "
          "order")
    # the visual frames' lag (init + 1) and the first VI frame, which posts
    # the frame handed off
    check(len(nones) == 2 and nones[0] == init_at + 1, f"vi pipelined: None returned at {nones}")
    check(counts["kf_deferred"] >= 1 and slam._kf_async is None,
          f"vi pipelined: deferred keyframes {counts['kf_deferred']}")
    check(fp.graphs and vp.graphs and replays["visual"] == counts["dispatches"]
          and replays["vi"] == counts["vi_dispatches"] == n_frames - nones[1] + 1,
          f"vi pipelined: replays {replays}, dispatches {counts}")
    check(all(syncs.values()) and not any(any(v) for v in syncs.values()),
          f"vi pipelined: synchronizing calls in a dispatch {syncs}")
    check(launches == want, f"vi pipelined: K1 launches {launches}, predicted {want}")
    return dict(init_frame=init_at, imu_frame=imu_at, nones=nones, frames_per_s=fps,
                call_ms_p50=float(lat[0]), call_ms_p80=float(lat[1]), replays=replays,
                passes=passes, fusing_keyframes=fusing, warmup_launches=warm, launches=launches,
                kf_program={k: v for k, v in kfw.items() if not k.endswith("launches")},
                pipe_counts=counts, k1=k1, peak_mem_mib=peak / 2**20,
                phase_s=time.perf_counter() - t0, **acc)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card only", file=sys.stderr)
        return 2
    from orb_slam3_ros_tpu_torch.ops import project_match
    from orb_slam3_ros_tpu_torch.utils import kernel_build

    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {count} device(s), using {name}")

    t0 = time.perf_counter()
    project_match.build()
    print(f"build: project_match.cu compiled and loaded in {time.perf_counter() - t0:.1f} s")
    spills = []
    for log in sorted(kernel_build.BUILD_ROOT.glob("project_match-*/build.log")):
        for line in log.read_text().splitlines():
            if "spill" in line or ("ptxas info" in line and ("Used" in line or "Compiling" in line)):
                print(line.strip())
            if "spill" in line:
                spills.append("0 bytes spill stores, 0 bytes spill loads" in line)
    check(spills and all(spills), "ptxas reports register spills (or no spill line at all)")

    stream = torch.cuda.current_stream().cuda_stream
    lib = project_match.build()
    empty_us = device_us(lambda: lib.project_match_empty_launch(stream))
    queued = kernel_launches(lib, lambda: lib.project_match_empty_launch(stream))
    check(queued == 1, f"the library counted {queued} launches for one empty launch")
    print(f"empty kernel launch: {empty_us:.2f} us of device time (100 queued launches)")
    laps, t_lap = {}, [t0]

    def lap(name: str) -> None:  # the wall seconds since the previous lap, by phase
        now = time.perf_counter()
        laps[name] = round(now - t_lap[0], 1)
        t_lap[0] = now

    k = phase_kernel(torch, project_match, P_TRACK, 60.0, 50)
    k4 = phase_kernel(torch, project_match, P_TRACK, 4.0, 50)
    kf = phase_kernel(torch, project_match, P_FUSE, 3.0, 50, **FUSE_KW)
    phase_kernel_edges(torch, project_match)
    lap("1-4 build and kernel")
    s, state = phase_slice(torch, project_match)
    phase_cpu(torch, state)
    lap("5-6 slice")
    mp, map_seq = phase_mapping(torch, project_match)
    lap("7 mapping")
    vi, start, (vi_slam, caps, vi_seq, vi_im) = phase_vi(torch, project_match, smi[0])
    lap("8 mono-inertial")
    vc = phase_vi_chunk(torch, project_match, vi, start)
    lap("9 VI chunks")
    mc, mono_snap, mono_stack = phase_mono_chunk(torch, project_match, mp, map_seq)
    lap("10 mono chunks")
    rl = phase_reloc(torch, project_match, mono_snap, map_seq, mono_stack)
    lap("11 relocalization")
    vi["stages"] = phase_vi_stages(torch, vi_slam, caps)
    lap("8 VI stages")
    lp, loop_slam = phase_loop_mono(torch, project_match)
    lap("12 mono loop closing")
    lv = phase_loop_vi(torch, project_match, vc)
    lap("13 VI loop closing")
    la = lp["closed_loop"]
    at = phase_atlas(torch, project_match, map_seq)
    lap("14 Atlas")
    st = phase_stereo(torch, project_match)
    lap("15 stereo and RGB-D")
    kb = st["b"]
    fe = phase_fisheye(torch, project_match)
    lap("16 fisheye")
    kfe = fe["k1"]
    su = phase_surface(torch, project_match, loop_slam, mp)
    lap("17 surface")
    sc = phase_scale(torch, project_match, mp, map_seq)
    lap("18 scale-out and split")
    k8 = phase_kb8(torch, project_match, vc)
    lap("19 KB8 paths")
    pp = phase_pipelined(torch, project_match, mp, mc, map_seq, smi[0])
    lap("20 pipelined")
    vp = phase_vi_pipelined(torch, project_match, vi, vi_seq, vi_im, smi[0])
    lap("21 VI pipelined")
    print(f"seconds by phase: {laps}")

    print(json.dumps({"slice": s, "mapping": mp, "vi": vi, "vi_chunk": vc, "mono_chunk": mc,
                      "reloc": rl, "loop_mono": lp, "loop_vi": lv, "atlas": at, "stereo": st,
                      "fisheye": fe, "surface": su, "scale": sc, "kb8": k8, "pipelined": pp,
                      "vi_pipelined": vp,
                      "phase_s": laps,
                      "card": smi[0]}, default=str))
    print(json.dumps({"kernels": [{
        "name": "project_match",
        "route": "cuda",
        "source": "orb_slam3_ros_tpu_torch/csrc/project_match.cu",
        "replaces": "orb_slam3_ros_tpu/ops/pallas_match.py:37",
        # the main paths: mapping (phase 7), mono-inertial (phase 8), its
        # chunk loop (phase 9), the mono chunk loop (phase 10),
        # relocalization (phase 11), mono loop closing (phase 12 (a), (b)),
        # VI loop closing (phase 13), the Atlas (phase 14 (a), (b), (c)),
        # stereo and RGB-D (phase 15 (a), (c), (d)) and the fisheye paths
        # (phase 16 (a) to (d)), the native-feed replay (phase 17 (a)), the
        # two-device split (phase 18 (b), (c)), the KB8 paths (phase 19
        # (a) to (d)), the pipelined per-frame mode (phase 20) and the
        # pipelined mono-inertial system (phase 21), the counts set to 0
        # before each and read after it
        "launches": sum(sum(x["launches"].values())
                        for x in (mp, vi, vc, mc, rl, la, lp["lc"], lv, at["a"], at["b"], at["c"],
                                  st, fe, su["a"], sc, k8, pp, vp)),
        "launches_track": mp["launches"]["track"],
        "launches_fuse": mp["launches"]["fuse"],
        "launches_vi_track": vi["launches"]["track"],
        "launches_vi_fuse": vi["launches"]["fuse"],
        # phase 8's VI frame graph: its replays' tracking passes and warm-ups
        "launches_vi_frame_graph_track": vi["vi_passes"] + vi["warmup_launches"]["track"],
        "launches_vi_pipelined_track": vp["launches"]["track"],
        "launches_vi_pipelined_fuse": vp["launches"]["fuse"],
        "launches_vi_pipelined_vi_graph_track": vp["passes"]["vi"],
        "launches_vi_chunk_track": vc["launches"]["track"],
        "launches_vi_chunk_fuse": vc["launches"]["fuse"],
        "launches_mono_chunk_track": mc["launches"]["track"],
        "launches_mono_chunk_fuse": mc["launches"]["fuse"],
        "launches_reloc_track": rl["launches"]["track"],
        "launches_reloc_fuse": rl["launches"]["fuse"],
        "launches_sim3": la["launches"]["sim3"] + lp["lc"]["launches"]["sim3"] + lv["launches"]["sim3"],
        "launches_loop_track": la["launches"]["track"],
        "launches_loop_fuse": la["launches"]["fuse"],
        "launches_loop_sim3": la["launches"]["sim3"],
        "launches_lc_sim3": lp["lc"]["launches"]["sim3"],
        "launches_vi_lc_sim3": lv["launches"]["sim3"],
        "launches_merge": at["launches"]["merge"],
        "launches_atlas_track": at["launches"]["track"],
        "launches_atlas_fuse": at["launches"]["fuse"],
        "launches_stereo_track": st["launches"]["track"],
        "launches_stereo_fuse": st["launches"]["fuse"],
        "launches_stereo_chunk_track": st["a"]["launches"]["track"],
        "launches_stereo_chunk_fuse": st["a"]["launches"]["fuse"],
        "launches_stereo_vi_track": st["c"]["launches"]["track"],
        "launches_rgbd_track": st["d"]["rgbd"]["launches"]["track"] + st["d"]["rgbd_vi"]["launches"]["track"],
        "launches_fisheye_track": fe["launches"]["track"],
        "launches_fisheye_fuse": fe["launches"]["fuse"],
        "launches_fisheye_chunk_track": fe["a"]["launches"]["track"],
        "launches_fisheye_chunk_fuse": fe["a"]["launches"]["fuse"],
        "launches_fisheye_stereo_track": fe["b"]["launches"]["track"],
        "launches_fisheye_vi_track": fe["c"]["launches"]["track"],
        "launches_fisheye_rectified_track": fe["d"]["launches"]["track"],
        "launches_surface_track": su["a"]["launches"]["track"],
        "launches_surface_fuse": su["a"]["launches"]["fuse"],
        "launches_split_track": sc["b"]["launches"]["track"],
        "launches_split_fuse": sc["b"]["launches"]["fuse"],
        "launches_split_vi_track": sc["c"]["launches"]["track"],
        "launches_split_vi_fuse": sc["c"]["launches"]["fuse"],
        "launches_kb8_vi_chunk_track": k8["a"]["launches"]["track"],
        "launches_kb8_vi_chunk_fuse": k8["a"]["launches"]["fuse"],
        "launches_kb8_rig_vi_track": k8["b"]["launches"]["track"],
        "launches_kb8_loop_track": k8["c"]["launches"]["track"],
        "launches_kb8_loop_fuse": k8["c"]["launches"]["fuse"],
        "launches_kb8_sim3": k8["c"]["launches"]["sim3"],
        "launches_kb8_atlas_track": k8["d"]["launches"]["track"],
        "launches_kb8_merge": k8["d"]["launches"]["merge"],
        "launches_pipelined_track": pp["launches"]["track"],
        "launches_pipelined_fuse": pp["launches"]["fuse"],
        "merge_ms": at["merge_ms"],
        "merge_plain_ms": at["merge_plain_ms"],
        "merge_device_us": at["merge_device_us"],
        "merge_bound_us": at["merge_bound_us"],
        "sim3_ms": la["sim3_ms"],
        "sim3_plain_ms": la["sim3_plain_ms"],
        "sim3_device_us": la["sim3_device_us"],
        "sim3_bound_us": la["sim3_bound_us"],
        # K1 on KB8 projections at the "sim3" and "merge" sites, phase 19
        "kb8_sim3_ms": k8["c"]["k1"]["ms"],
        "kb8_sim3_plain_ms": k8["c"]["k1"]["plain_ms"],
        "kb8_sim3_device_us": k8["c"]["k1"]["device_us"],
        "kb8_sim3_bound_us": k8["c"]["k1"]["bound_us"],
        "kb8_merge_ms": (k8["d"]["k1"] or {}).get("ms"),
        "kb8_merge_plain_ms": (k8["d"]["k1"] or {}).get("plain_ms"),
        "kb8_merge_device_us": (k8["d"]["k1"] or {}).get("device_us"),
        "kb8_merge_bound_us": (k8["d"]["k1"] or {}).get("bound_us"),
        "max_abs_err": max(k["max_abs_err"], k4["max_abs_err"], kf["max_abs_err"],
                           la["sim3_max_abs_err"], at["merge_max_abs_err"],
                           kb["k1"]["max_abs_err"], kb["k1_r4"]["max_abs_err"],
                           kfe["max_abs_err"], su["a"]["k1_max_abs_err"],
                           sc["b"]["k1_max_abs_err"], k8["c"]["k1"]["max_abs_err"],
                           vp["k1"]["max_abs_err"],
                           (k8["d"]["k1"] or {}).get("max_abs_err", 0)),
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_us"] / 1e3,
        "bound_by": k["bound_by"],
        "library_ms": None,  # no single PyTorch call computes this search
        "fuse_ms": kf["ms"],
        "fuse_plain_ms": kf["plain_ms"],
        "fuse_bound_ms": kf["bound_us"] / 1e3,
        "r4_ms": k4["ms"],
        "r4_plain_ms": k4["plain_ms"],
        "device_us": k["device_us"],
        "r4_device_us": k4["device_us"],
        "fuse_device_us": kf["device_us"],
        "host_us": k["host_us"],
        "r4_host_us": k4["host_us"],
        "fuse_host_us": kf["host_us"],
        "bound_us": k["bound_us"],
        "fuse_bound_us": kf["bound_us"],
        "empty_launch_us": empty_us,
        "kernel_launches_per_call": k["kernel_launches"],
        "r4_kernel_launches_per_call": k4["kernel_launches"],
        "fuse_kernel_launches_per_call": kf["kernel_launches"],
        # the KITTI shape (P = 768, N = 2040), phase 15 (b)
        "kitti_ms": kb["k1"]["ms"],
        "kitti_plain_ms": kb["k1"]["plain_ms"],
        "kitti_device_us": kb["k1"]["device_us"],
        "kitti_bound_us": kb["k1"]["bound_us"],
        "kitti_r4_ms": kb["k1_r4"]["ms"],
        "kitti_r4_device_us": kb["k1_r4"]["device_us"],
        # a KB8 frame at the TUM-VI shape (P = 768, N = 1032), phase 16
        "fisheye_max_abs_err": kfe["max_abs_err"],
        "fisheye_ms": kfe["ms"],
        "fisheye_plain_ms": kfe["plain_ms"],
        "fisheye_device_us": kfe["device_us"],
        "fisheye_bound_us": kfe["bound_us"],
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
