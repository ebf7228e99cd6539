#!/usr/bin/env python3
"""Smoke run of tpu_face_torch on one CUDA card: checks, one phase timed.

    python3 chip_smoke.py

Phases, each of which fails loudly (nonzero exit, no result line):

1. device  -- the card's name and power limit (nvidia-smi), torch's name;
2. build   -- compiles the kernel sources from tpu_face_torch/csrc, one
              nvcc per source, started together, and prints their ptxas
              lines;
3. kernel  -- each warp and fused-block kernel against its plain PyTorch
              version.  The warps (max abs error <= 1e-3) on random ROIs
              to +-45 deg, mirrored grids and taps past the frame edge,
              with the cascade's grids (a 192x192 mesh grid, 64x64 left
              and mirrored right iris grids): warp_bilinear_segments on
              f32 planes of 32 frames of 540x360, a 1280x720 and two 64x64
              frames (two faces each), bit-exact, with the mesh grid, both
              iris grids and all three as one, two and three segments, a
              37x37 grid cut from the mesh grid (not contiguous, rows not
              a multiple of 4) and the one-segment warp_bilinear on the
              concatenated coordinates; f32 warp_sample_multi takes it in
              one launch; warp_bilinear_strips and both staged variants
              (one fused copy per block, three per-channel copies) on the
              same calls over bf16 and f32 planes of 8 frames of
              1920x1080, 2 of 3840x2160 and 2 of 1281x723 (rows of bf16
              planes start off the 16-byte grid), with 1 and 4 faces per
              frame and ROIs of one to three times the short side, whose
              blocks overflow the staged kernel's window budget (the
              kernel counts those blocks and the bytes its windows copied,
              the same for both variants).  The fused block (TF32 off):
              f32 and bf16 at each residual run of the BACK detector
              (128x128x24, 64x64x24, 32x32x48, 16x16x96, seven blocks each,
              batch 64, the f32 and the bf16 detector's weights), f32
              within 1e-4 * max(1, max|plain|), bf16 within one bf16 ulp
              of max|plain| (the kernel rounds where the plain version
              rounds), and f32 and bf16 at the Pallas prototypes' shape
              (batch 256, 128x128x24, 7 blocks, their seeded weights); the
              tiling the wrapper chose for each run is printed.  The
              convolution epilogue at the main path's shapes (the iris
              net's 256x64x32x32 NCHW, the mesh net's 128x16x96x96
              channels_last, and the iris net's mixed chain: y
              channels_last, the skip NCHW and half as wide, first),
              one launch each, bit-equal to ATen's op-by-op sequence with
              the same strides.  The split-TF32 convolution at one of
              R100's routed shapes (128 crops of 56x56x128 -> 128, stride
              2) against an f64 convolution: one launch, within 4x cuDNN
              f32's error, and its TF32 mode outside that bound.  The
              split-TF32 token FC at ViT-L's fc1 and fc2 shapes (128
              crops of 144 tokens: 18432x768 -> 3072 and 18432x3072 ->
              768) and two of Swin-S's (401408x96 -> 384, stage 1's fc1;
              100352x192 -> 192, stage 2's q, k, v, proj and fc2, on the
              256x64 tile) against an f64 product: one launch each, within 4x
              cuBLAS f32's error, its TF32 mode outside that bound, and
              its bias and activation bit-equal to ATen's after its bare
              product.  The card tests (tests/test_torch_epilogue_card.py,
              tests/test_torch_conv_tc_card.py,
              tests/test_torch_fc_tc_card.py) hold the three kernels over
              more cases.  Then == attention: the attention core at
              ViT-L's core (128 crops of 144 tokens, 8 heads of 96) and at
              Swin-S's four stages' (8,192 to 128 windows of 49 tokens,
              heads of 32, a bias, the first three stages also with a
              mask) against the plain version in f64: one launch each,
              within 4x the plain version's f32 error, its TF32 mode
              outside that bound; with the device ms of the kernel, the
              plain version and F.scaled_dot_product_attention (a
              yardstick; the port never calls it) at each shape, and a
              call's sum for each net beside the cores' byte bound (the
              one phase that times; tests/test_torch_attention_tc_card.py
              holds the kernel over more cases);
4. cascade -- the main paths, with every launch count set to 0 before
              each and read after it.  Each call is a cascade's first at
              its geometry: on the card it runs ``_forward`` eagerly
              twice (the warm-ups) and once more under capture, then
              replays the captured CUDA graph, which launches the same
              kernels without a wrapper call; so each call counts three
              times the launches of one ``_forward`` (``capture_runs``),
              and its result is the replay's.  f32: FaceCascade() on the
              seven rotated frames of assets/rotated/ (one infer_batch per
              geometry; 2 warp_bilinear, 0 warp_bilinear_strips and the
              detector's planned f32 fused-block launches each), held
              against their ground truth (bbox IoU >= 0.99, landmarks <= 1
              px) and the port's own CPU result; then canvas (a) at
              1920x1080 (K=1) and (b) at 1280x824 (K=2), 2
              warp_bilinear_strips launches each, and (c) at 1080x720
              (K=4), 2 warp_bilinear launches (the mesh grid as one
              segment, both iris grids as two, no coordinate
              concatenation); every face valid and within 0.25 px / 1e-3
              of the CPU port; and canvas (c) at batch 32 with K=4, every
              face valid.  bf16: FaceCascade(compute_dtype=torch.bfloat16)
              on the same frames and canvases (a) and (c), the detector's
              residual runs on fused_dw_pw_block_bf16 only (its planned
              launches per call, none of the f32 kernel's), against the
              ground truth and the CPU port's bf16 result (the BF16_*
              tolerances; with K=4 the faces matched by position, since
              the score sort may swap faces whose bf16 scores nearly tie: a
              swap passes only where the CPU's two scores differ by at
              most BF16_SCORE_TOL, and each side's slot scores are
              printed); with K > 1 the card's valid faces must come in
              non-increasing score, and f32 faces match slot by slot.
              gather: FaceCascade(warp_method="gather") with f32 nets on the
              rotated frames, no warp kernel launched (only the detector's
              fused launches), against the ground truth and the kernel
              path's result within 0.25 px / 1e-3;
   The phases that check each call's launches from here on (models,
   the standalone detectors of full_detectors, the chain of mxu,
   tracker, embed, aot, aot_executable, sharded, batches) run the
   objects' eager calls (``eager_calls``: the program caches step
   aside), so every count is one ``_forward``'s; == graphs holds the
   cached calls against them;
5. models  -- the standalone models, counts set to 0 before and read
              after: FaceDetection(BACK) -> face_detection_to_roi ->
              FaceLandmark -> iris_roi_from_face_landmarks -> IrisLandmark
              (left, and right mirrored) on the seven rotated frames,
              against their ground truth and the CPU port (0.25 px /
              1e-3), each warp on warp_bilinear; then the same chain on
              canvas (a), where the mesh and iris warps take
              warp_bilinear_strips over f32 planes; then the chain with
              bf16 nets on the rotated frames (ground truth, and the CPU
              port within the BF16_* tolerances);
6. full_detectors -- the counts set to 0 before and read after:
              FaceDetection(FULL) and FaceDetection(FULL_SPARSE) on the
              seven rotated frames and canvas (c) (one warp_bilinear
              launch per call but on the portraits, which take the
              two-stage letterbox; no fused launch: the full-range nets'
              bottleneck blocks are no run), FaceCascade(FULL) on the four
              540p frames and FaceCascade(FULL_SPARSE, max_faces=4) on
              canvas (c) (2 warp_bilinear launches each), every face valid,
              against the CPU port (0.25 px / 1e-3) and, for FULL's
              cascade, the nose and irises within 2 px of the ground
              truth;
7. mxu     -- warp_method="mxu" (the banded hat-weight matmuls, plain
              torch): the standalone chain on the rotated frames but the
              close-up (its mesh ROI overflows the band, in JAX too) and
              the cascade on the 540p frames, against the CPU port; no
              warp kernel launched, only the BACK detector's fused ones;
8. embed iresnet, embed vit, embed swin -- EmbedCascade(FULL_SPARSE,
              max_faces=4) on ArcFace's IR-ResNet-100, on insightface's
              ViT-L and on Swin-S (benchmark/models/iresnet.py, vit.py
              and swin.py at their published widths, the graphs written
              from R100_SEED, VIT_SEED and SWIN_SEED into build/) on
              canvas (c) eight times over: per run 98 split-TF32
              convolutions (R100), 144 split-TF32 token FCs (ViT-L, 6 a
              block) or 137 (Swin-S: stage 1's fc1s, the merges, every FC
              of stages 2-4), 24 attention cores (ViT-L and Swin-S) and
              one epilogue a chain, the cached call
              equal to the eager one and making no launch on a replay,
              the first frame against the port on the CPU (the nets on
              the card's crops within their configurations'
              embedding_abs, R100_EMBED_TOL, VIT_EMBED_TOL and
              SWIN_EMBED_TOL);
9. tracker -- FaceTracker() with the published nets: 8 streams of a
              five-step rotated 540p sequence (stream 2 blanked at step
              2), then 2 streams of canvas (a) at 1920x1080 over three
              steps, every step's launches checked (the first step the
              full cascade; a locked step 2 warp launches, warp_bilinear
              or at 1080p warp_bilinear_strips, and no fused launch: the
              detector does not run; a repair step 4 warp launches and
              the fused launches of the one-stream repair cascade), each
              step against the port's CPU tracker entered with the card's
              state (0.25 px / 1e-3, equal lock states); then a locked
              step of 64 streams, its launches;
10. embed  -- the identification path, the counts set to 0 before and
              read after: EmbedCascade(BACK, the demo embedding graph
              tpu_face/data/demo) with f32 and with bf16 nets on the
              rotated frames (the 540p four x16 = batch 64, the close-up,
              the portraits) and on canvas (c) with max_faces=4, each call
              13 fused launches (f32) or 8 (bf16) and no warp kernel (the
              crop is the separable hat matmuls); FaceEmbeddings
              .infer_batch (f32, bf16) and .embed_boxes of a FaceCascade
              result's meshes.  f32 against the port's CPU result
              (crop_bbox equal, 0.25 px / 1e-3, embeddings within 1e-4),
              bf16 against the card's f32 result (crops within 1 px,
              cosine >= 0.99 against the f32 net on the same crop, 0.98
              for crops under 112 px); ``python -m tpu_face_torch
              identify`` and ``cascade`` in subprocesses on the card
              against the same commands with ``--device cpu``;
              native_loader.available() (where the loader builds: a JPEG
              of a rotated frame decoded against Pillow); then one call
              each of EmbedCascade and FaceCascade at 540p b64 in f32 and
              bf16 (its launches, a face in every frame);
11. aot     -- the serving programs (tpu_face_torch.aot), the counts set
              to 0 before and read after: FaceCascade with f32 and with
              bf16 nets at 540x360 batch 8, f32 at 1920x1080 planar batch
              4 (the strip kernel) and EmbedCascade f32 (demo graph) at
              540x360 batch 8, each saved, loaded and attached to a fresh
              object: the attached call within 1e-6 of the live one with
              the flags equal, the same counted launches per call, and the
              loaded graph's kernel operators giving those launches (2 warp
              nodes, 4 fused run nodes whose chunks add up to 13 f32 or 8
              bf16 launches); then FaceTracker's and MultiFaceTracker's
              (K=2) artifacts at 8 streams of 540x360, each one "step"
              program (its exported graph two torch.cond nodes), attached
              and held against the live step in every branch (locked,
              repair, forced, mass loss; within 1e-6, flags, lock states
              and launches equal), the loaded program attach returns
              (aot.load's) called as prog(images, *state, force)
              bit-identical with the attached step;
12. aot_executable -- those three FaceCascade programs and FaceTracker's
              step program at 8 streams of 540x360, saved with
              kind="executable" (AOTInductor packages compiled on the
              card, the four compiles in four child processes of this
              script started together; the counts set to 0 before and read
              after), each cascade attached to a fresh object and held
              against the live one: the same counted launches per call
              (the package calls the kernels' operators), f32 within
              0.25 px / 1e-3 and bf16 nets within the BF16_* criteria, the
              ground truth of the rotated frames, one call on a side
              stream equal to the default stream's; then the tracker's
              step executable in every branch (the cascade contract on
              the result and on the next ROIs, flags, lock states and
              launches equal).  The EmbedCascade and MultiFaceTracker
              executables are left out (a compile costs one to three
              minutes on the card); tests/test_torch_aot_executable.py
              compiles and checks both on the CPU, under ``slow``;
13. graphs -- the per-geometry CUDA-graph programs (tpu_face_torch.programs),
              the counts set to 0 before and read after (the warm-ups and
              captures of first calls, and the eager references): every
              cached path against the eager call on the same input,
              bit-identical or within the cascade contract (printed):
              FaceCascade f32 and bf16 at 540x360 b1, b8 and b64, planar
              1920x1080 b64 (the strip kernel), FULL_SPARSE K=4 on canvas
              (c) b32, EmbedCascade f32 b8, FaceTracker and
              MultiFaceTracker (K=2) over 8 streams and five steps with a
              two-stream repair and a forced redetect (each step from the
              same state, the lock states equal; their caches hold one
              step program at 8 streams), the four models' infer_batch at
              b8; two geometries interleaved (540x360 b8, the close-up,
              540x360 b8 again) with a held result unchanged; one profiled
              replay each of f32 540x360 b8, bf16 540x360 b8 and f32 1080p
              planar b64 holding K1 and K3, K4, and K2 among its kernels,
              and one epilogue launch a chain of the f32 nets;
14. tracker_program -- each tracker step as one captured program
              (programs.cond: the step's two decisions as CUDA-graph
              conditional nodes), the counts set to 0 before and read
              after (the warm-ups and captures): a nested cond (a cuBLAS
              matmul and an inner cond against a cuDNN convolution) for
              each pair of predicates against the eager call; then
              FaceTracker and MultiFaceTracker (K=2) with f32 and with
              bf16 nets at 540x360: over == graphs' five-step sequence
              at 8 streams, and for each branch (locked, repair, forced,
              mass loss) at 8 and 64 streams, each step bit-identical
              with the host-branch step entered with the same state (its
              ``_step_fn`` called eagerly, each decision read to the
              host; NaN where both have NaN), one step program per
              tracker; at 8 streams two profiled replays of each branch:
              2 K1 and no fused launch locked, 4 K1 and the detector's 13
              K3 (f32) or 8 K4 (bf16) on a repair, 2 K1 and the detector's
              on the full path; then 12 steps over every branch with
              OneEuro smoothing and ``dt``, after their capture, under
              ``torch.cuda.set_sync_debug_mode("error")``;
15. sharded -- tpu_face_torch.parallel, the counts set to 0 before and
              read after: infer_sharded of FaceCascade() at 540x360 batch
              64 over data_parallel_mesh() (every visible card; its size
              printed) and over [cuda:0, cuda:0] against the unsharded
              call (within 2e-3, flags equal; each shard's launches), and
              track_sharded of FaceTracker() over both meshes, 8 streams
              over a full, a locked and a repair step, against the
              unsharded tracker; then FaceTracker and MultiFaceTracker
              (K=2, repair_batch=2) over [cuda:0, cuda:0] in every branch
              (locked, repair, forced, mass loss) from the unsharded
              tracker's state, after a first step, under
              torch.cuda.set_sync_debug_mode("error"), within 2e-3 of the
              unsharded step with the lock states equal;
16. strip_dma -- K5's A/B configuration (tools/tpu_strip_dma_probe.py's:
              batch 64 of 1920x1080 bf16 planes, 192x192 mesh grids of
              350-640 px ROIs to +-0.3 rad): the gather strip kernel and
              both staged variants once each (this path's launches), the
              staged outputs bit-exact with the gather's, which is within
              1e-3 of the plain version, and both variants' window counts
              equal (printed);
17. batches -- the main paths at the bench rows' batches, each call's
              launches counted: K1 and K2 against their plain versions on
              the grids of the cascade's own calls (540x360 b32, 1080p
              planar b64); FaceCascade bf16 at 540x360 b64 and planar
              1080p b64 and 4K b8 in f32 and bf16, a valid face in every
              frame; the BACK detector at 540x360 b64 with its residual
              runs fused and op by op, f32 within BLOCK_TOL_F32 and bf16
              within BLOCK_TOL_BF16;
18. bench  -- ``tpu_face_torch.bench.main`` (the port's bench, ``python -m
              tpu_face_torch.bench``) in this process at batch 64 with
              the shortest windows it takes (BENCH_ARGS), every row on,
              with f32 and then bf16 nets, the counts set to 0 before and
              read after: each run's accuracy gate passed in the type
              asked for, every row of ``bench.ROWS`` present and positive,
              the serving row through an executable, the record naming
              this card (its name and nvidia-smi line); each record is
              printed (its numbers are from one short window: the port's
              speed is measured by benchmark/run.py).

Its last lines are the nvidia-smi line, a JSON line of each path's
launches and the run's seconds, the kernels' JSON line (each kernel's
source, the Pallas kernel it replaces, its launches and its largest
error against its plain version here) and {"ok": true, "device":
{...}}.  Imports nothing of JAX or of the tpu_face package.
"""

import argparse
import collections
import contextlib
import importlib
import io
import itertools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ROT = ROOT / "assets" / "rotated"

KERNEL_TOL = 1e-3               # 0-255 units, before rounding
BLOCK_TOL_F32 = 1e-4            # fused block, x max(1, max|plain|)
BLOCK_TOL_BF16 = 2e-2           # bf16 BACK net, fused vs op by op, x max(1, max)
CPU_PX_TOL = 0.25               # landmarks, GPU vs CPU port, pixels
CPU_SCORE_TOL = 1e-3
# a standalone model's cached call vs its eager call where they are not
# bit-identical: normalized points and scores, CPU_PX_TOL at 540 px
MODEL_TOL = CPU_PX_TOL / 540
# FULL's cascade: nose and irises against the ground truth rows (taken
# with the BACK detector's ROIs), the budget tests/test_rotation_e2e.py
# gives the tracked mesh and iris
FULL_GT_PX = 2.0
# bf16 nets, GPU vs CPU port: cuDNN and the CPU's convolutions round their
# bf16 outputs at other places (the detector's residual runs, on K4 on
# the card, round where the CPU's per-op sequence rounds).  The
# detection, the iris points and the nose within 1 px and the scores
# within 1e-2; the mesh in steps of the mesh net's bf16 output (1.0 in
# its 192-px input above 128, i.e. ROI / 192 px in the frame) everywhere
# within two steps and on average within one: the face ROI comes from
# the detector, which differs by a fraction of a pixel, and the whole
# mesh moves with it (tests/test_torch_bf16.py holds the CPU port to
# JAX's bf16 cascade, whose detector rounds like the CPU's, within half a
# step on average).
BF16_PX_TOL = 1.0
BF16_MESH_MEAN_STEPS = 1.0
BF16_MESH_STEPS = 2.0
BF16_SCORE_TOL = 1e-2
# ground-truth rotation tolerances (face ROI, eye ROIs), rad: f32 as
# tests/test_rotation_e2e.py; bf16 eye ROIs looser, as one bf16 step of
# the mesh output (~1 px) turns an eye corner pair ~35 px apart by ~0.03
ROT_TOL = (0.01, 0.02)
BF16_ROT_TOL = (0.01, 0.03)

# Ground truth of the rotated frames (TFLite + OpenCV reference
# transcription; the same rows as tests/test_rotation_e2e.py).
GT = {
    "man_rotp15.png": {
        "size": (540, 360), "score": 0.9412,
        "keypoints": [(219.6, 124.5), (272.5, 108.2), (254.8, 148.1),
                      (263.2, 175.5), (195.0, 147.5), (307.8, 113.7)],
        "bbox": (184.8, 80.8, 317.5, 213.6),
        "roi_rot": -0.2983, "nose": (255.63, 146.75),
        "iris": {"L": (219.20, 120.41), "R": (271.60, 105.20)},
        "eye_rots": (-0.3492, -0.4751)},
    "man_rotm15.png": {
        "size": (540, 360), "score": 0.9611,
        "keypoints": [(254.4, 105.5), (307.8, 118.5), (273.3, 147.1),
                      (267.0, 173.2), (221.4, 110.6), (335.8, 138.1)],
        "bbox": (208.0, 72.0, 347.0, 211.1),
        "roi_rot": 0.2381, "nose": (272.26, 142.97),
        "iris": {"L": (255.85, 102.66), "R": (308.64, 116.28)},
        "eye_rots": (0.4246, 0.2800)},
    "man_rotp30.png": {
        "size": (540, 360), "score": 0.9475,
        "keypoints": [(209.1, 139.0), (255.8, 109.7), (250.0, 153.4),
                      (264.2, 177.8), (188.8, 165.3), (288.7, 103.9)],
        "bbox": (178.4, 88.7, 301.1, 211.4),
        "roi_rot": -0.5612, "nose": (247.59, 151.92),
        "iris": {"L": (205.44, 135.63), "R": (252.41, 107.08)},
        "eye_rots": (-0.6559, -0.7816)},
    "man_rotm30.png": {
        "size": (540, 360), "score": 0.9284,
        "keypoints": [(274.3, 104.3), (322.7, 132.6), (280.9, 148.6),
                      (266.8, 172.2), (242.7, 99.2), (344.9, 159.5)],
        "bbox": (231.0, 82.4, 353.4, 204.7),
        "roi_rot": 0.5287, "nose": (282.63, 146.37),
        "iris": {"L": (275.97, 101.57), "R": (323.83, 128.60)},
        "eye_rots": (0.7652, 0.6119)},
    "man_closeup_rotp30.png": {
        "size": (704, 704), "score": 0.785,
        "keypoints": [(237.9, 266.0), (332.7, 208.2), (321.5, 294.5),
                      (348.8, 342.1), (198.2, 316.8), (392.5, 199.3)],
        "bbox": (181.8, 170.1, 415.6, 403.9),
        "roi_rot": -0.5473, "nose": (317.30, 291.96),
        "iris": {"L": (234.49, 260.51), "R": (326.30, 205.84)},
        "eye_rots": (-0.4764, -0.5867)},
    "russ2_rotp20.png": {
        "size": (200, 225), "score": 0.9123,
        "bbox": (56.3, 70.7, 148.6, 163.0),
        "roi_rot": -0.4737, "nose": (103.69, 125.47),
        "iris": {"L": (77.09, 106.69), "R": (113.66, 89.22)},
        "eye_rots": (-0.3145, -0.4772)},
    "russ2_rotm20.png": {
        "size": (200, 225), "score": 0.9226,
        "bbox": (57.3, 71.0, 154.3, 168.0),
        "roi_rot": 0.2164, "nose": (95.01, 124.70),
        "iris": {"L": (86.22, 93.21), "R": (125.23, 103.28)},
        "eye_rots": (0.2922, 0.1481)},
}
FRAMES_540 = ["man_rotp15.png", "man_rotm15.png", "man_rotp30.png",
              "man_rotm30.png"]


def canvas_1080p(load_image, scale=2, size=(1920, 1080)):
    """Canvas (a): man_rotp15.png upscaled ``scale`` times by repetition
    and pasted at (x 420, y 180) on a black 1920x1080 canvas; with
    ``scale=4`` and ``size=(3840, 2160)`` its 4K counterpart, pasted at
    (x 840, y 360)."""
    img = load_image(ROT / "man_rotp15.png")
    big = np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)
    w, h = size
    canvas = np.zeros((h, w, 3), np.uint8)
    x, y = 210 * scale, 90 * scale
    canvas[y:y + big.shape[0], x:x + big.shape[1]] = big
    return canvas


def canvas_two_faces(load_image):
    """Canvas (b): man_rotp15.png at (x 50, y 232) and man_rotm30.png at
    (x 690, y 232) on a black 1280x824 canvas, just past the f32
    residency budget (the strip kernel's tier)."""
    canvas = np.zeros((824, 1280, 3), np.uint8)
    canvas[232:592, 50:590] = load_image(ROT / "man_rotp15.png")
    canvas[232:592, 690:1230] = load_image(ROT / "man_rotm30.png")
    return canvas


def canvas_grid(load_image):
    """Canvas (c): the four 540x360 rotated frames as a 2x2 grid on
    1080x720 (the resident kernel's tier)."""
    canvas = np.zeros((720, 1080, 3), np.uint8)
    for i, name in enumerate(FRAMES_540):
        r, c = divmod(i, 2)
        canvas[r * 360:(r + 1) * 360, c * 540:(c + 1) * 540] = \
            load_image(ROT / name)
    return canvas


T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def iou(a, b):
    xmin, ymin = max(a[0], b[0]), max(a[1], b[1])
    xmax, ymax = min(a[2], b[2]), min(a[3], b[3])
    if not (xmin < xmax and ymin < ymax):
        return 0.0
    inter = (xmax - xmin) * (ymax - ymin)
    area = lambda r: (r[2] - r[0]) * (r[3] - r[1])  # noqa: E731
    return inter / (area(a) + area(b) - inter)


def check_gt(res, i, gt, rot_tol=ROT_TOL):
    """One frame of a CascadeResult against its ground-truth row; returns
    (bbox IoU, worst landmark error in px)."""
    w, h = gt["size"]
    assert bool(res.face_valid[i]) and bool(res.mesh_valid[i]), gt
    det = res.detection[i].cpu().numpy()
    box = (det[0, 0] * w, det[0, 1] * h, det[1, 0] * w, det[1, 1] * h)
    box_iou = iou(box, gt["bbox"])
    assert box_iou >= 0.99, (box, gt["bbox"], box_iou)
    roi_rot = float(res.face_roi[i, 4])
    assert abs(roi_rot - gt["roi_rot"]) <= rot_tol[0], (roi_rot,
                                                          gt["roi_rot"])
    eye_rots = res.eye_rois[i, :, 4].cpu().numpy()
    for e, grot in enumerate(gt["eye_rots"]):
        assert abs(eye_rots[e] - grot) <= rot_tol[1], (e, eye_rots[e], grot)
    mesh = res.mesh[i].cpu().numpy()
    iris = res.iris[i].cpu().numpy()
    pts = [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
           ((iris[0, 0, 0] * w, iris[0, 0, 1] * h), gt["iris"]["L"]),
           ((iris[1, 0, 0] * w, iris[1, 0, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= 1.0, (pts, worst)
    return box_iou, worst


def check_bf16_points(det, mesh, iris, nose, roi_px):
    """bf16 card-vs-CPU differences in px ([faces, points] each; ``nose``
    [faces]; ``roi_px`` the faces' ROI sides) against the BF16 tolerances;
    returns the worst point difference."""
    px = max(float(det.max()), float(iris.max()), float(nose.max()))
    assert px <= BF16_PX_TOL, ("detection/iris/nose", px)
    steps = mesh / (roi_px[:, None] / 192.0)
    assert float(steps.mean(-1).max()) <= BF16_MESH_MEAN_STEPS, (
        "mesh mean steps", steps.mean(-1))
    assert float(steps.max()) <= BF16_MESH_STEPS, ("mesh steps",
                                                   steps.amax(-1))
    return max(px, float(mesh.max()))


def align_faces(res, ref):
    """(``res`` (a result with a face axis, on the card) with each
    frame's face slots in ``ref``'s order, the swaps): each valid slot of
    ``ref`` takes the unused slot of ``res`` whose detection box centre
    is nearest, the other slots follow in their order.  The swaps are
    the (frame, j, k) of each two valid slots j < k of ``ref`` whose
    faces ``res`` holds in the other order.  The cascade sorts faces by
    score, and two faces whose scores differ by less than the bf16 nets'
    rounding may come out in either order."""
    centre = (lambda d: d[..., :2, :].mean(-2))       # noqa: E731
    det, rdet = centre(res.detection.cpu()), centre(ref.detection)
    orders = []
    for i in range(det.shape[0]):
        free = list(range(det.shape[1]))
        order = []
        for j in range(det.shape[1]):
            if bool(ref.face_valid[i, j]):
                k = min(free, key=lambda k: float((det[i, k]
                                                   - rdet[i, j]).norm()))
            else:
                k = free[0]
            free.remove(k)
            order.append(k)
        orders.append(order)
    swaps = [(i, j, k) for i, order in enumerate(orders)
             for j in range(len(order)) for k in range(j + 1, len(order))
             if bool(ref.face_valid[i, k]) and order[j] > order[k]]
    rows = torch.arange(det.shape[0])[:, None]
    index = torch.tensor(orders)
    return type(res)(*(f.cpu()[rows, index] for f in res)), swaps


def check_against_cpu(res, ref, size, bf16=False):
    """GPU result vs the port's CPU result on the same frames: equal
    bools, and the numbers of every valid face slot, within the f32
    tolerances or, for bf16 nets, the bf16 ones; returns (worst landmark
    px, worst score difference).  Where there is a face axis the card's
    valid faces must come in non-increasing score, and f32 results are
    compared slot by slot; bf16 results are first matched to the CPU's
    by ``align_faces``, and two faces may only have swapped where their
    CPU scores differ by at most ``BF16_SCORE_TOL``."""
    if res.face_valid.dim() == 2:
        score, valid = res.score.cpu(), res.face_valid.cpu()
        assert bool(((score[:, :-1] >= score[:, 1:])
                     | ~valid[:, 1:]).all()), ("face order", score, valid)
    if bf16 and res.face_valid.dim() == 2:
        res, swaps = align_faces(res, ref)
        for i, j, k in swaps:
            gap = abs(float(ref.score[i, j] - ref.score[i, k]))
            print(f"frame {i}: the card holds CPU faces {j} and {k} "
                  f"(CPU scores {float(ref.score[i, j]):.5f}, "
                  f"{float(ref.score[i, k]):.5f}; card "
                  f"{float(res.score[i, j]):.5f}, "
                  f"{float(res.score[i, k]):.5f}) in the other order")
            assert gap <= BF16_SCORE_TOL, ("swap", i, j, k, gap)
    w, h = size
    for f in ("face_valid", "mesh_valid", "envelope_ok"):
        assert torch.equal(getattr(res, f).cpu(), getattr(ref, f)), f
    ok = ref.face_valid

    def diff(f):
        return (getattr(res, f).cpu()[ok] - getattr(ref, f)[ok]).abs()

    scale = torch.tensor([w, h, w], dtype=torch.float32)
    sc = max(float(diff(f).max()) for f in ("score", "mesh_score"))
    if bf16:
        assert sc <= BF16_SCORE_TOL, sc

        def px2(f):             # [faces, points] x/y distance in px
            d = diff(f)[..., :2] * scale[:2]
            return d.amax(-1).flatten(1)

        roi_px = (ref.face_roi[ok][..., 2:4] * scale[:2]).amax(-1)
        mesh = torch.maximum(px2("mesh"), px2("mesh_raw"))
        return check_bf16_points(px2("detection"), mesh, px2("iris"),
                                 mesh[:, 1], roi_px), sc
    px = max(float((diff(f) * scale).max())
             for f in ("mesh", "mesh_raw", "iris"))
    px = max(px, float((diff("detection") * scale[:2]).max()))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def random_coords(rng, b, w, h, image_ops, faces=1, sides=(0.05, 0.7)):
    """Mesh (192x192) and iris (two 64x64, right mirrored) grids of
    random ROIs over a w x h frame, ``faces`` per frame ([b, faces, Ho,
    Wo] grids): rotation to +-45 deg, centres past the frame edge, sizes
    from ``sides[0]`` to ``sides[1]`` of the short side."""
    def rois():
        n = (b, faces)
        cx = rng.uniform(-0.1 * w, 1.1 * w, n)
        cy = rng.uniform(-0.1 * h, 1.1 * h, n)
        side = rng.uniform(*sides, n) * min(w, h)
        aspect = rng.uniform(0.8, 1.25, n)
        rot = rng.uniform(-math.pi / 4, math.pi / 4, n)
        return torch.from_numpy(np.stack(
            [cx, cy, side, side * aspect, rot], -1).astype(np.float32)
        ).cuda()
    mx, my, _ = image_ops._source_coords(rois(), (192, 192), False, False)
    lx, ly, _ = image_ops._source_coords(rois(), (64, 64), True, False)
    rx, ry, _ = image_ops._source_coords(rois(), (64, 64), True, True)
    return [(mx, my)], [(lx, ly), (rx, ry)]


def flat(coords):
    b = coords[0][0].shape[0]
    return (torch.cat([x.reshape(b, -1) for x, _ in coords], 1).contiguous(),
            torch.cat([y.reshape(b, -1) for _, y in coords], 1).contiguous())


def stacked(coords):
    """One call's same-size grids as the staged kernel takes them, [B, n,
    ..., Ho, Wo] (the pixels in ``flat``'s order)."""
    return (torch.stack([x for x, _ in coords], 1),
            torch.stack([y for _, y in coords], 1))


def staged_stats(planes, gx, gy, copies):
    """One launch of the staged kernel on grids [B, ..., Ho, Wo] with its
    counters on: (its output, its launches, the bytes its windows' bulk
    copies moved, its blocks whose window did not hold all their taps),
    as the kernel counted them on the card."""
    stats = torch.zeros(2, dtype=torch.int64, device=planes.device)
    got, n = counted(lambda: warp.warp_bilinear_strips_staged(
        planes, gx, gy, copies, stats=stats))
    copied, over = stats.tolist()
    return got, n, copied, over


def staged_blocks(gx):
    """Blocks of the staged kernel (``warp.STAGED_BLOCK``) over grids
    [B, ..., Ho, Wo]."""
    rt, cw = warp.STAGED_BLOCK
    gh, gw = gx.shape[-2:]
    return gx[..., 0, 0].numel() * -(-gh // rt) * -(-gw // cw)


def stage_coords(cascade, frames, size):
    """The planes and the two warp calls' grids (the mesh grid, then both
    iris grids; ``flat`` makes the kernels' [B, K*P] rows of them) that
    one cascade call over ``frames`` gives its warp kernel."""
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(frames, size)
        dets, _, _ = cascade._detect_stage(planes, size)
        roi = cascade._face_roi_from_det(dets, size)
        mx, my, _ = image_ops._source_coords(roi, (192, 192), False,
                                             False)
        _, _, lroi, rroi = cascade._mesh_half(planes, roi, size)
        lx, ly, _ = image_ops._source_coords(lroi, (64, 64), True, False)
        rx, ry, _ = image_ops._source_coords(rroi, (64, 64), True, True)
    return planes, [[(mx, my)], [(lx, ly), (rx, ry)]]


def hires_batch(canvas, batch, rng):
    """A planar uint8 batch on the card built like bench.py's 1080p/4K
    rows: the canvas, then copies rolled along x by up to a tenth of the
    width, every third one mirrored."""
    width = canvas.shape[1]
    frames = [canvas]
    while len(frames) < batch:
        f = np.roll(canvas, int(rng.integers(-width // 10, width // 10)),
                    axis=1)
        if len(frames) % 3 == 1:
            f = f[:, ::-1]
        frames.append(np.ascontiguousarray(f))
    return torch.from_numpy(np.ascontiguousarray(
        np.stack(frames).transpose(0, 3, 1, 2))).cuda()


def launch_counts():
    """{kernels line entry: its wrapper's launch count}."""
    return {"warp_bilinear": warp.LAUNCHES,
            "warp_bilinear_strips": warp.STRIP_LAUNCHES,
            "fused_dw_pw_block_f32": fused_block.LAUNCHES,
            "fused_dw_pw_block_bf16": fused_block.BF16_LAUNCHES,
            "warp_strips_staged_fused": warp.STAGED_LAUNCHES["fused"],
            "warp_strips_staged_split": warp.STAGED_LAUNCHES["split"],
            "conv_epilogue": ce.LAUNCHES,
            "conv3x3_tc": ctc.LAUNCHES,
            "fc_tc": ftc.LAUNCHES,
            "attention_tc": atc.LAUNCHES}


def reset_counts():
    warp.LAUNCHES = warp.STRIP_LAUNCHES = 0
    fused_block.LAUNCHES = fused_block.BF16_LAUNCHES = 0
    warp.STAGED_LAUNCHES.update(fused=0, split=0)
    ce.LAUNCHES = 0
    ctc.LAUNCHES = 0
    ftc.LAUNCHES = 0
    atc.LAUNCHES = 0


def epilogues(*nets):
    """The convolution epilogue launches of one forward of each of
    ``nets``: one a chain (a bf16 net has none)."""
    return sum(len(net.chains) for net in nets)


def cascade_epilogues(cascade):
    """The epilogue launches of one call of ``cascade`` (a FaceCascade or
    an EmbedCascade): one forward of each of its nets."""
    return epilogues(*(getattr(cascade, n) for n in cascade._net_names))


def only(**launches):
    """The launch counts of a call that launched ``launches`` and no other
    kernel."""
    assert set(launches) <= set(SOURCES), launches
    return {name: launches.get(name, 0) for name in SOURCES}


def counted(fn):
    """``fn()`` and the launches of each kernel it made."""
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: v - before[k] for k, v in launch_counts().items()}


def phase_build():
    phase("build")
    t0 = time.perf_counter()
    _build.build_all(KERNELS)          # one nvcc per source, in parallel
    for name in KERNELS:
        _build.load(name)
        log = _build.BUILD_LOG[name]
        print(log["ptxas"])
        print(f"{name}: nvcc {log['seconds']:.2f} s")
    print(f"{len(KERNELS)} kernels built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(rng):
    """Each warp, fused-block, epilogue and split-TF32 convolution and FC
    kernel against its plain version; returns the max abs errors {kernel:
    err}."""
    phase("kernel vs plain")
    errs = collections.defaultdict(float)

    def check(name, kernel, plain, planes, coords):
        xs, ys = flat(coords)
        got, n = counted(lambda: kernel(planes, xs, ys))
        assert n == only(**{name: 1}), (name, n)
        err = float((got - plain(planes, xs, ys)).abs().max())
        b, _, h, w = planes.shape
        print(f"{name} {str(planes.dtype)[6:]} B={b} {w}x{h} grids "
              f"{[tuple(x.shape[1:]) for x, _ in coords]}: "
              f"max abs err {err:.3g}")
        assert err <= KERNEL_TOL, (name, err)
        errs[name] = max(errs[name], err)
        return got

    def check_staged(planes, coords, gather):
        """Both staged variants against the plain version and the gather
        kernel's output ``gather`` on the same call; both must count the
        same windows.  Returns the blocks whose window was cut."""
        xs, ys = flat(coords)
        plain = warp.warp_bilinear_strips_plain(planes, xs, ys)
        gx, gy = stacked(coords)
        counts = []
        for copies in ("fused", "split"):
            name = f"warp_strips_staged_{copies}"
            got, n, copied, over = staged_stats(planes, gx, gy, copies)
            assert n == only(**{name: 1}), (name, n)
            err = float((got - plain).abs().max())
            print(f"{name} {str(planes.dtype)[6:]} grids "
                  f"{tuple(gx.shape[1:])}: max abs err {err:.3g}, "
                  f"bit-exact with the gather "
                  f"{bool(torch.equal(got, gather))}; {over} of "
                  f"{staged_blocks(gx)} blocks over the window budget, "
                  f"{copied} bytes copied (counted by the kernel)")
            assert err <= KERNEL_TOL, (name, err)
            errs[name] = max(errs[name], err)
            counts.append((copied, over))
        assert counts[0] == counts[1], counts
        return counts[0][1]

    def check_segments(planes, coords):
        """warp_bilinear_segments with each grid a segment, and
        warp_bilinear on the concatenated coordinates: both bit-exact
        with the plain version."""
        segs = [(x, y, x.shape[-1]) for x, y in coords]
        got, n = counted(lambda: warp.warp_bilinear_segments(planes, segs))
        assert n == only(warp_bilinear=1), n
        ref = warp.warp_bilinear_plain(planes, *flat(coords))
        err = float((got - ref).abs().max())
        b, _, h, w = planes.shape
        print(f"warp_bilinear_segments B={b} {w}x{h} segments "
              f"{[tuple(x.shape[1:]) for x, _ in coords]}: max abs err "
              f"{err:.3g}, bit-exact {bool(torch.equal(got, ref))}")
        assert torch.equal(got, ref), err
        flat_got = check("warp_bilinear", warp.warp_bilinear,
                         warp.warp_bilinear_plain, planes, coords)
        assert torch.equal(flat_got, ref)
        errs["warp_bilinear"] = max(errs["warp_bilinear"], err)

    for b, (w, h), faces in ((32, (540, 360), 1), (1, (1280, 720), 1),
                             (2, (64, 64), 2)):
        frames = torch.from_numpy(
            rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).cuda()
        planes = warp.make_planes(frames)
        mesh, iris = random_coords(rng, b, w, h, image_ops, faces)
        for coords in (mesh, iris, mesh + iris):
            check_segments(planes, coords)
        # a grid whose rows are not a multiple of 4, not contiguous
        check_segments(planes, [(x[..., :37, :37], y[..., :37, :37])
                                for x, y in mesh])
        # the cascade's f32 planes: one launch, each grid a segment
        _, n = counted(lambda: warp.warp_sample_multi(planes, iris))
        assert n == only(warp_bilinear=1), n
    # the strip kernel and both staged variants on the same calls; ROIs
    # of one to three times the short side overflow the staged kernel's
    # window budget, so its global-memory taps run too
    over = 0
    for b, (w, h) in ((8, (1920, 1080)), (2, (3840, 2160)), (2, (1281, 723))):
        frames = torch.from_numpy(
            rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)).cuda()
        for dtype in (torch.bfloat16, torch.float32):
            planes = warp.make_planes(frames, dtype=dtype)
            for faces, sides in ((1, (0.05, 0.7)), (4, (0.05, 0.7)),
                                 (1, (1.0, 3.0))):
                for coords in random_coords(rng, b, w, h, image_ops, faces,
                                            sides):
                    got = check("warp_bilinear_strips",
                                warp.warp_bilinear_strips,
                                warp.warp_bilinear_strips_plain, planes,
                                coords)
                    over += check_staged(planes, coords, got)
            del planes
    assert over > 0, "no block overflowed the staged window budget"
    # warp_sample_multi takes the strip kernel for bf16 planes
    planes = warp.make_planes(frames, dtype=torch.bfloat16)
    _, n = counted(lambda: warp.warp_sample_multi(
        planes, random_coords(rng, b, w, h, image_ops, 2)[1]))
    assert n == only(warp_bilinear_strips=1), n
    del planes, frames
    errs.update(phase_fused_blocks())
    for label, args in epilogue_cases(rng):
        errs["conv_epilogue"] = max(errs["conv_epilogue"],
                                    check_epilogue(label, *args))
    errs["conv3x3_tc"] = check_conv_tc(rng)
    errs["fc_tc"] = max(check_fc_tc(rng, *shape) for shape in FC_TC_SHAPES)
    return errs


def epilogue_cases(rng):
    """The convolution epilogue's operands at the main path's shapes:
    [(label, (y, bias, skip, alpha, act, skip_first))], normal noise on
    the card: the iris net's 256x64x32x32 NCHW (a flat pass over planes),
    the mesh net's 128x16x96x96 channels_last (over pixels), and the iris
    net's mixed chain (y channels_last from cuDNN's 1x1, the skip NCHW
    and half as wide, the skip the ADD's first operand: the tiled
    kernel), each with a skip and PRELU."""
    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()

    cl = torch.channels_last
    cases = []
    for label, (b, c, cs, h), y_cl, s_cl, first in (
            ("iris 256x64x32x32 NCHW", (256, 64, 64, 32), False, False,
             False),
            ("mesh 128x16x96x96 channels_last", (128, 16, 16, 96), True,
             True, False),
            ("iris 256x64x32x32 y channels_last, skip NCHW 32 wide",
             (256, 64, 32, 32), True, False, True)):
        y, skip = normal(b, c, h, h), normal(b, cs, h, h)
        if y_cl:
            y = y.contiguous(memory_format=cl)
        if s_cl:
            skip = skip.contiguous(memory_format=cl)
        cases.append((label, (y, normal(c), skip, normal(c), "PRELU",
                              first)))
    return cases


def check_epilogue(label, y, bias, skip, alpha, act, first):
    """The convolution epilogue kernel against its plain version (ATen's
    op-by-op sequence on the card) on one case: one launch, bit-equal
    values and the same strides.  Returns the max abs error (0)."""
    got, n = counted(lambda: ce.conv_epilogue(y, bias, skip, alpha, act,
                                              first))
    assert n == only(conv_epilogue=1), (label, n)
    want = ce.conv_epilogue_plain(y, bias, skip, alpha, ce.ACTS[act], first)
    equal = bool(torch.equal(got, want))
    print(f"conv_epilogue {label}: bit-equal with the op-by-op sequence "
          f"{equal}, strides {got.stride()}", flush=True)
    assert equal and got.stride() == want.stride(), label
    return float((got - want).abs().max())


def check_conv_tc(rng):
    """The split-TF32 convolution against an f64 convolution at one of
    R100's routed shapes (CONV_TC_SHAPE, CONV_TC_CROPS crops): one launch,
    a channels_last result, its error within CONV_TC_ERR_RATIO times
    cuDNN's f32 convolution's (TF32 off), and the kernel with TF32 allowed
    (one product a step) failing that bound; then its input affine at one
    of R100's first convs (CONV_TC_AFFINE_SHAPE): one launch, bit-equal
    to ATen's MUL, then ADD, then the kernel.  Returns the kernel's max
    abs error against the f64 result."""
    side, ci, co, stride = CONV_TC_SHAPE
    label = f"{side}x{side}x{ci}->{co}/s{stride}"
    x = torch.from_numpy(rng.standard_normal(
        (CONV_TC_CROPS, side, side, ci), dtype=np.float32)).cuda()
    x = x.permute(0, 3, 1, 2)
    w = torch.from_numpy(rng.standard_normal(
        (co, ci, 3, 3), dtype=np.float32) / (3 * ci ** 0.5)).cuda()
    hi, lo = ctc.kernel_weights(w)
    with torch.inference_mode(), exact_f32():
        want = torch.nn.functional.conv2d(x.double(), w.double(), None,
                                          stride, 1)
        got, n = counted(lambda: ctc.conv3x3_tc(x, w, hi, lo, stride, 1))
        assert n == only(conv3x3_tc=1), (label, n)
        assert got.is_contiguous(memory_format=torch.channels_last), label
        cudnn = torch.nn.functional.conv2d(x, w, None, stride, 1)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
            tf32 = ctc.conv3x3_tc(x, w, hi, lo, stride, 1)
    diff = {k: float((v.double() - want).abs().max())
            for k, v in (("kernel", got), ("cudnn_f32", cudnn),
                         ("tf32", tf32))}
    top = float(want.abs().max())
    rel = {k: v / top for k, v in diff.items()}
    print(f"conv3x3_tc {label}: error / max |y| {rel}", flush=True)
    bound = CONV_TC_ERR_RATIO * rel["cudnn_f32"]
    assert rel["kernel"] <= bound < rel["tf32"], (label, rel)

    side, ci, co = CONV_TC_AFFINE_SHAPE
    label = f"{side}x{side}x{ci}->{co}/s1 with its BN"
    x = torch.from_numpy(rng.standard_normal(
        (CONV_TC_CROPS, side, side, ci), dtype=np.float32)).cuda()
    x = x.permute(0, 3, 1, 2)
    w = torch.from_numpy(rng.standard_normal(
        (co, ci, 3, 3), dtype=np.float32) / (3 * ci ** 0.5)).cuda()
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, ci).astype(
        np.float32)).cuda()
    shift = torch.from_numpy(rng.uniform(3.0, 4.0, ci).astype(
        np.float32)).cuda()
    hi, lo = ctc.kernel_weights(w)
    with torch.inference_mode(), exact_f32():
        got, n = counted(lambda: ctc.conv3x3_tc(x, w, hi, lo, 1, 1, scale,
                                                shift))
        assert n == only(conv3x3_tc=1), (label, n)
        t = x * scale[:, None, None]
        want = ctc.conv3x3_tc(t + shift[:, None, None], w, hi, lo, 1, 1)
    equal = bool(torch.equal(got, want))
    print(f"conv3x3_tc {label}: bit-equal with MUL, ADD, then the kernel "
          f"{equal}", flush=True)
    assert equal, label
    return diff["kernel"]


# one 3x3 convolution R100 routes to the split-TF32 kernel (side, Cin,
# Cout, stride; padding 1) and its crops a call (the card tests,
# tests/test_torch_conv_tc_card.py, hold all twelve routed shapes)
CONV_TC_SHAPE = (56, 128, 128, 2)
# one of R100's first convs of a unit (side, Cin, Cout; stride 1, padding
# 1), whose unit's leading BatchNorm it reads through its input affine
CONV_TC_AFFINE_SHAPE = (28, 128, 128)
CONV_TC_CROPS = 128
# the split-TF32 kernels' largest error, over the f64 output's largest
# magnitude, at most this many times cuDNN's f32 convolution's or
# cuBLAS's f32 product's (TF32 off) at the shape
CONV_TC_ERR_RATIO = 4.0
# token FCs at 128 crops (M, K, N, activation): ViT-L's fc1 (bias and
# RELU6) and fc2 (bias) over 144 tokens, which take the 128x128 tile;
# Swin-S's stage-1 fc1 over 3,136 tokens (K = 96) and stage 2's q, k, v,
# proj and fc2 over 784 (N = 192, the 256x64 tile); the card tests
# (tests/test_torch_fc_tc_card.py) hold ViT-L's three (K, N) at 1, 3 and
# 128 crops and these two of Swin-S's
FC_TC_SHAPES = [(128 * 144, 768, 3072, "RELU6"),
                (128 * 144, 3072, 768, "NONE"),
                (128 * 3136, 96, 384, "NONE"),
                (128 * 784, 192, 192, "NONE")]


def check_fc_tc(rng, m, k, n, act):
    """The split-TF32 token FC against an f64 product at one of
    ``FC_TC_SHAPES``: the bare product one launch, its error within
    CONV_TC_ERR_RATIO times cuBLAS's f32 product's (TF32 off), and the
    kernel with TF32 allowed in matmuls (one product a step) failing that
    bound; then the FC with its bias and activation ``act``: one launch,
    bit-equal to ATen's ``+ bias`` and ``clamp(0, 6)`` after the bare
    product.  Returns the bare product's max abs error against the f64
    one."""
    label = f"[{m}, {k}] x [{k}, {n}] + bias, {act}"
    x = torch.from_numpy(rng.standard_normal((m, k),
                                             dtype=np.float32)).cuda()
    # pre-activations of standard deviation ~2, so RELU6 clips at both
    # ends
    w = torch.from_numpy(2 * rng.standard_normal(
        (n, k), dtype=np.float32) / k ** 0.5).cuda()
    bias = torch.from_numpy(rng.standard_normal(n, dtype=np.float32)).cuda()
    hi, lo = ftc.kernel_weights(w)
    with torch.inference_mode(), exact_f32():
        want = x.double() @ w.double().t()
        bare, launches = counted(lambda: ftc.fc_tc(x, w, hi, lo))
        assert launches == only(fc_tc=1), (label, launches)
        cublas = x @ w.t()
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = ftc.fc_tc(x, w, hi, lo)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        got, launches = counted(lambda: ftc.fc_tc(x, w, hi, lo, bias, act))
        assert launches == only(fc_tc=1), (label, launches)
        aten = bare + bias
        if act == "RELU6":
            aten = torch.clamp(aten, 0.0, 6.0)
    diff = {name: float((y.double() - want).abs().max())
            for name, y in (("kernel", bare), ("cublas_f32", cublas),
                            ("tf32", tf32))}
    top = float(want.abs().max())
    rel = {name: v / top for name, v in diff.items()}
    equal = bool(torch.equal(got, aten))
    print(f"fc_tc {label}: error / max |y| {rel}; bias and {act} "
          f"bit-equal with ATen after the bare product {equal}", flush=True)
    assert rel["kernel"] <= CONV_TC_ERR_RATIO * rel["cublas_f32"] < (
        rel["tf32"]), (label, rel)
    assert equal, label
    if act == "RELU6":
        assert bool((aten == 6).any()) and bool((aten == 0).any()), label
    return diff["kernel"]


# the attention cores of a call of 128 crops: {net: [(label, sequences,
# tokens, heads, head width, windows an image or 0 (no mask), bias, cores
# a call)]}: ViT-L's 24 blocks; Swin-S's [2, 2, 18, 2] blocks by stage, of
# each of the first three stages' the shifted half masked
ATTENTION_SHAPES = {
    "vit_l": [("vit_l", 128, 144, 8, 96, 0, False, 24)],
    "swin_s": [("swin_s.1", 8192, 49, 3, 32, 0, True, 1),
               ("swin_s.1 masked", 8192, 49, 3, 32, 64, True, 1),
               ("swin_s.2", 2048, 49, 6, 32, 0, True, 1),
               ("swin_s.2 masked", 2048, 49, 6, 32, 16, True, 1),
               ("swin_s.3", 512, 49, 12, 32, 0, True, 9),
               ("swin_s.3 masked", 512, 49, 12, 32, 4, True, 9),
               ("swin_s.4", 128, 49, 24, 32, 0, True, 2)]}
# the card's memory rate for the cores' byte bounds (H100 SXM, B/s)
HBM_BYTES_PER_S = 3.35e12


def check_attention(rng, label, seqs, n, heads, d, windows, bias):
    """The attention core at one of ``ATTENTION_SHAPES``: one launch, its
    error against the plain version in f64 within CONV_TC_ERR_RATIO times
    the plain version's in f32 on the card, the TF32 mode outside that
    bound; then the device ms a core of the kernel (CUDA events over 20
    launches), of the plain version and, as a yardstick the port never
    calls, of ``F.scaled_dot_product_attention`` with the same additive
    mask.  Returns (the kernel's max abs error, {"kernel", "plain",
    "library"}: ms)."""
    import torch.nn.functional as F

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(
            shape, dtype=np.float32)).cuda()

    q, k, v = (normal(seqs, n, heads * d) for _ in range(3))
    q *= 2                      # logits of standard deviation ~2
    scale = torch.tensor(d ** -0.5).cuda()
    b = normal(heads, n, n) if bias else None
    mask = None
    if windows:                 # -100 between tokens of other regions
        regions = rng.integers(0, 3, (windows, n))
        mask = torch.from_numpy(np.where(
            regions[:, :, None] != regions[:, None, :], -100.0,
            0.0).astype(np.float32)).cuda()
    ops = (q, k, v, scale, b, mask)
    with torch.inference_mode(), exact_f32():
        want = atc.attention_tc_plain(
            *(None if t is None else t.double() for t in ops), heads)
        plain = atc.attention_tc_plain(*ops, heads)
        got, launches = counted(lambda: atc.attention_tc(*ops, heads=heads))
        assert launches == only(attention_tc=1), (label, launches)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = atc.attention_tc(*ops, heads=heads)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        diff = {name: float((y.double() - want).abs().max())
                for name, y in (("kernel", got), ("aten_f32", plain),
                                ("tf32", tf32))}
        rel = {name: e / float(want.abs().max()) for name, e in diff.items()}
        assert rel["kernel"] <= CONV_TC_ERR_RATIO * rel["aten_f32"] < (
            rel["tf32"]), (label, rel)
        # SDPA's inputs: the heads as a view, the bias and the mask as one
        # additive mask of every sequence
        heads_of = [t.reshape(seqs, n, heads, d).transpose(1, 2)
                    for t in (q, k, v)]
        add = torch.zeros(seqs, heads, n, n, device=q.device)
        if b is not None:
            add += b
        if mask is not None:
            add = (add.reshape(-1, windows, heads, n, n)
                   + mask[:, None]).reshape(seqs, heads, n, n)
        runs = {
            "kernel": lambda: atc.attention_tc(*ops, heads=heads),
            "plain": lambda: atc.attention_tc_plain(*ops, heads),
            "library": lambda: F.scaled_dot_product_attention(
                *heads_of, attn_mask=add, scale=d ** -0.5)}
        ms = {}
        for name, fn in runs.items():
            fn()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            for _ in range(20):
                fn()
            end.record()
            torch.cuda.synchronize()
            ms[name] = start.elapsed_time(end) / 20
    print(f"attention_tc {label} [{seqs}, {n}, {heads}x{d}]: error / max "
          f"|o| {rel}; ms a core {ms}", flush=True)
    return diff["kernel"], ms


def phase_attention(rng):
    """The attention core kernel at ViT-L's core and Swin-S's four stages'
    (``ATTENTION_SHAPES``, 128 crops), each checked and timed by
    ``check_attention``; then each net's device ms a call of 128 crops of
    the kernel, the plain version and the library's call beside the
    cores' byte bound (q, k and v read once and o written once, the bias
    and the mask once, at ``HBM_BYTES_PER_S``).  Returns the kernel's
    largest error."""
    phase("attention")
    worst = 0.0
    for net, shapes in ATTENTION_SHAPES.items():
        total = {"kernel": 0.0, "plain": 0.0, "library": 0.0}
        moved = 0
        for label, seqs, n, heads, d, windows, bias, cores in shapes:
            err, ms = check_attention(rng, label, seqs, n, heads, d,
                                      windows, bias)
            worst = max(worst, err)
            for name in total:
                total[name] += cores * ms[name]
            moved += cores * 4 * (4 * seqs * n * heads * d
                                  + bias * heads * n * n
                                  + windows * n * n)
        print(f"attention_tc {net}: ms a call of 128 crops {total}; "
              f"bound {1e3 * moved / HBM_BYTES_PER_S:.3f} ms "
              f"({moved / 1e9:.3f} GB)", flush=True)
    return worst


# the seed of the R100 graph the identification path runs on
# (benchmark/models/iresnet.py at its published widths)
R100_SEED = 2**31 + 20
# R100's embeddings on the card against the CPU's on the same crops: the
# limit of the arcface_r100_k4_f32 configuration's embedding_abs
R100_EMBED_TOL = 2e-5
# the seed of the ViT-L graph (benchmark/models/vit.py at its published
# widths) and the limit of the arcface_vitl_k4_f32 configuration's
# embedding_abs
VIT_SEED = 2**31 + 23
VIT_EMBED_TOL = 2e-5
# the seed of the Swin-S graph (benchmark/models/swin.py at its published
# widths) and the limit of the swin_s_k4_f32 configuration's embedding_abs
SWIN_SEED = 2**31 + 25
SWIN_EMBED_TOL = 2e-5


def fused_entry(dtype):
    """The fused block's kernels line entry for activations of ``dtype``."""
    return ("fused_dw_pw_block_bf16" if dtype == torch.bfloat16
            else "fused_dw_pw_block_f32")


def back_net(fuse_blocks=True, dtype=torch.float32):
    """The BACK detector lowered on the card in ``dtype`` (its residual
    runs on the fused kernel, or op by op)."""
    return build_torch_fn(Graph(DATA_DIR / "face_detection_back.npz"),
                          resolve_device(), fuse_blocks=fuse_blocks,
                          compute_dtype=dtype)


def detector_runs(net, rng, batch):
    """The BACK detector's residual runs as ``fused_blocks`` arguments at
    ``batch``: [(label, x, weights)], x relu'd normal noise of the run's
    shape on the card, the weights the net's own."""
    cases = []
    for k, (c, h, w, layers) in enumerate(net.run_shapes):
        x = torch.from_numpy(rng.standard_normal(
            (batch, c, h, w), dtype=np.float32)).cuda().relu_()
        cases.append((f"R{k + 1} {h}x{w}x{c} L={layers}", x,
                      [getattr(net, f"run{k}_{n}")
                       for n in ("wd", "bd", "wp", "bp")]))
    return cases


def prototype_inputs(batch):
    """K3/K4's inputs, seeded as docs/experiments/fused_block_prototype.py
    :25-29 (generator 0: x [B, 128, 128, 24] normal, wd [7, 3, 3, 24] *
    0.2, wp [7, 24, 24] * 0.2, one bias [7, 24]), in the port's layout:
    x NCHW on the card, the depthwise bias zero."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(batch, 128, 128, 24)).astype(np.float32)
    wd = (rng.normal(size=(7, 3, 3, 24)) * 0.2).astype(np.float32)
    wp = (rng.normal(size=(7, 24, 24)) * 0.2).astype(np.float32)
    bias = rng.normal(size=(7, 24)).astype(np.float32)
    x = torch.from_numpy(x).cuda().permute(0, 3, 1, 2).contiguous()
    return x, [torch.from_numpy(wd).permute(0, 3, 1, 2).contiguous().cuda(),
               torch.zeros(7, 24).cuda(), torch.from_numpy(wp).cuda(),
               torch.from_numpy(bias).cuda()]


def bf16_ulp(v):
    """One bf16 unit in the last place at magnitude ``v`` > 0 (8 bits of
    significand)."""
    return 2.0 ** (math.floor(math.log2(v)) - 7)


def check_fused(label, x, weights):
    """The fused kernel against its plain version on one run (TF32 off),
    with the weights in the kernel's form made once as the lowered nets
    make them; returns the max abs error."""
    b, c, h, w = x.shape
    tile, chunks = fused_block.plan(c, h, w, weights[0].shape[0],
                                    x.element_size())
    packed = fused_block.kernel_weights(*weights, x.dtype)
    with torch.inference_mode(), exact_f32():
        got, n = counted(lambda: fused_block.fused_blocks(
            x, *weights, tiling=(tile, chunks), weights=packed))
        ref = fused_block.fused_blocks_plain(x, *weights)
    assert n == only(**{fused_entry(x.dtype): len(chunks)}), (label, n,
                                                              chunks)
    err = float((got.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    tol = (BLOCK_TOL_F32 * max(1.0, scale) if x.dtype == torch.float32
           else bf16_ulp(scale))
    print(f"fused_dw_pw_block {str(x.dtype)[6:]} {label} B={b}: tile "
          f"{tile}x{tile}, layers per launch {list(chunks)}; max abs err "
          f"{err:.3g} (max |plain| {scale:.3g}, tolerance {tol:.3g})",
          flush=True)
    assert err <= tol, (label, err, tol)
    return err


def phase_fused_blocks():
    """The fused block against its plain version: at the BACK detector's
    four runs (batch ``BATCH["fused"]``), f32 with the f32 net's weights
    and bf16 with the bf16 net's, and f32 and bf16 at K3/K4's shape;
    returns the max abs errors of the two entry points."""
    rng = np.random.default_rng(1)
    err32 = max(check_fused(label, x, w) for label, x, w in
                detector_runs(back_net(), rng, BATCH["fused"]))
    err16 = max(check_fused(label, x.to(torch.bfloat16), w)
                for label, x, w in detector_runs(
                    back_net(dtype=torch.bfloat16), rng, BATCH["fused"]))
    x, w = prototype_inputs(BATCH["k3"])
    err32 = max(err32, check_fused("K3 128x128x24 L=7", x, w))
    err16 = max(err16, check_fused("K4 128x128x24 L=7", x.to(torch.bfloat16),
                                   w))
    return {"fused_dw_pw_block_f32": err32, "fused_dw_pw_block_bf16": err16}


def segment_calls(fn):
    """``fn()`` with warp.warp_bilinear_segments watched: returns (its
    result, [(segments, whether every segment is a grid as it lies
    ([B, ..., Ho, Wo], not flattened)) for each call])."""
    real = warp.warp_bilinear_segments
    seen = []

    def spy(planes, segments):
        seen.append((len(segments), all(x.dim() >= 3 for x, _, _ in segments)))
        return real(planes, segments)

    warp.warp_bilinear_segments = spy
    try:
        return fn(), seen
    finally:
        warp.warp_bilinear_segments = real


def run_cascade(cascade, frames, launches):
    """The first infer_batch of ``cascade`` at ``frames``' geometry on the
    card, checked for its kernel launches: ``launches`` per eager run of
    ``_forward``, times the runs of a first call (``capture_runs``: the
    warm-ups and the capture of its CUDA graph, whose replay makes no
    wrapper call); where it warps f32 planes, for the mesh grid as one
    segment and the iris grids as two in each run, read where they lie
    (no coordinate concatenation)."""
    (res, n), seen = segment_calls(
        lambda: counted(lambda: cascade.infer_batch(frames)))
    runs = capture_runs()
    assert n == {k: v * runs for k, v in launches.items()}, (n, launches,
                                                            runs)
    assert seen == ([(1, True), (2, True)] * runs
                    if launches["warp_bilinear"] else []), seen
    return res


def rotated_batches():
    """The rotated frames by size: ({size: [names]}, {size: uint8 batch
    [B, H, W, 3]})."""
    groups = {}
    for name, gt in GT.items():
        groups.setdefault(gt["size"], []).append(name)
    return groups, {size: np.stack([load_image(ROT / n) for n in names])
                    for size, names in groups.items()}


def phase_cascade(dtype=torch.float32):
    """A main path, FaceCascade(compute_dtype=dtype): returns the launches
    of each kernel in it (canvas (c) at batch 32 with f32 nets, after the
    count is read, not among them)."""
    bf16 = dtype == torch.bfloat16
    phase(f"cascade {str(dtype)[6:]}")
    groups, batches = rotated_batches()
    cascade = FaceCascade(compute_dtype=dtype)
    # the detector's residual runs: one fused launch per layer chunk of
    # the wrapper's tiling plan (for the nets' type), per infer_batch, on
    # the entry point of that type
    fused = {fused_entry(dtype): cascade._det_net.fused_launches(),
             "conv_epilogue": cascade_epilogues(cascade)}
    canvases = {"a": (canvas_1080p(load_image), 1,
                      only(warp_bilinear_strips=2, **fused)),
                "b": (canvas_two_faces(load_image), 2,
                      only(warp_bilinear_strips=2, **fused)),
                "c": (canvas_grid(load_image), 4,
                      only(warp_bilinear=2, **fused))}
    if bf16:
        del canvases["b"]
    cascades = {k: FaceCascade(max_faces=k, compute_dtype=dtype)
                for _, k, _ in canvases.values() if k > 1}
    cascades[1] = cascade
    reset_counts()
    results = {size: run_cascade(cascade, batch,
                                 only(warp_bilinear=2, **fused))
               for size, batch in batches.items()}
    canvas_results = {key: run_cascade(cascades[k], img[None], n)
                      for key, (img, k, n) in canvases.items()}
    launches = launch_counts()
    print(f"launches on the main path: {launches} for {len(batches)} "
          f"rotated-frame and {len(canvases)} canvas infer_batch calls, "
          f"each a first call at its geometry ({capture_runs()} runs of "
          f"_forward: the warm-ups and the capture; {fused} fused-block "
          f"and epilogue launches planned per run)")

    cpu = {k: FaceCascade(device="cpu", max_faces=k, compute_dtype=dtype)
           for k in cascades}
    for size, names in groups.items():
        res = results[size]
        for i, name in enumerate(names):
            box_iou, px = check_gt(res, i, GT[name],
                                   BF16_ROT_TOL if bf16 else ROT_TOL)
            print(f"{name}: IoU {box_iou:.4f}, worst landmark "
                  f"{px:.3f} px vs ground truth")
        px, sc = check_against_cpu(res, cpu[1].infer_batch(batches[size]),
                                   size, bf16)
        print(f"{size[0]}x{size[1]} GPU vs CPU port: {px:.4f} px, "
              f"scores {sc:.2e}", flush=True)
    for key, (img, k, _) in canvases.items():
        res = canvas_results[key]
        assert bool(res.mesh_valid.all()), (key, res.mesh_valid)
        size = (img.shape[1], img.shape[0])
        ref = cpu[k].infer_batch(img[None])
        px, sc = check_against_cpu(res, ref, size, bf16)
        print(f"canvas ({key}) {size[0]}x{size[1]} K={k}: "
              f"{int(res.mesh_valid.sum())} valid faces; GPU vs CPU port "
              f"{px:.4f} px, scores {sc:.2e}; slot scores card "
              f"{[round(float(v), 5) for v in res.score.flatten()]}, CPU "
              f"{[round(float(v), 5) for v in ref.score.flatten()]}",
              flush=True)
    if not bf16:
        # K=4 at batch BATCH["k4"]: the four faces of canvas (c) in each
        # frame
        b = BATCH["k4"]
        res = run_cascade(cascades[4], np.stack([canvases["c"][0]] * b),
                          only(warp_bilinear=2, **fused))
        faces = int(res.mesh_valid.sum())
        assert faces == 4 * b, faces
        print(f"canvas (c) K=4 B={b}: {faces} valid faces", flush=True)
    return launches


def phase_cascade_gather():
    """The f32 cascade with warp_method="gather" on the rotated frames
    (one infer_batch per geometry, the counts set to 0 before): no warp
    kernel launched (the detector's fused launches only), its results
    against the ground truth and against the kernel path's
    (FaceCascade() on the same frames) within the CPU tolerances; returns
    its launches."""
    phase("cascade gather")
    groups, batches = rotated_batches()
    gather = FaceCascade(warp_method="gather")
    kernels = FaceCascade()
    assert (gather.warp_method, kernels.warp_method) == ("gather", "pallas")
    fused = only(fused_dw_pw_block_f32=gather._det_net.fused_launches(),
                 conv_epilogue=cascade_epilogues(gather))
    reset_counts()
    results = {size: run_cascade(gather, batch, fused)
               for size, batch in batches.items()}
    launches = launch_counts()
    print(f"launches of the gather cascade: {launches} for {len(batches)} "
          f"infer_batch calls", flush=True)
    for size, names in groups.items():
        res = results[size]
        for i, name in enumerate(names):
            box_iou, px = check_gt(res, i, GT[name])
            print(f"{name} (gather): IoU {box_iou:.4f}, worst landmark "
                  f"{px:.3f} px vs ground truth")
        ref = kernels.infer_batch(batches[size])
        px, sc = check_against_cpu(res, type(ref)(*(f.cpu() for f in ref)),
                                   size)
        print(f"{size[0]}x{size[1]} gather vs kernel path: {px:.4f} px, "
              f"scores {sc:.2e}", flush=True)
    return launches


def chain(models, img, size):
    """The verify skill's chain: detection -> face ROI -> mesh -> eye
    ROIs -> left and mirrored right iris.  Returns [detection data
    (8, 2) normalized, mesh (468, 3), left contour + iris (76, 3), right
    contour + iris (76, 3)] as arrays, the detection score and the face
    ROI's long side in px."""
    det, mesh_model, iris_model = models
    faces = det.infer(img)
    assert len(faces) == 1, len(faces)
    roi = tmodels.face_detection_to_roi(faces[0], size)
    mesh = mesh_model.infer(img, roi)
    assert len(mesh) == 468
    left, right = tmodels.iris_roi_from_face_landmarks(mesh, size)
    eyes = [iris_model.infer(img, left),
            iris_model.infer(img, right, is_right_eye=True)]

    def rows(points):
        return np.array([(p.x, p.y, p.z) for p in points], np.float32)

    return ([faces[0].data, rows(mesh)]
            + [rows(e.contour + e.iris) for e in eyes], faces[0].score,
            max(roi.width * size[0], roi.height * size[1]))


def check_chain_gt(res, gt):
    """A chain's result against a ground-truth row: score within 0.01,
    bbox IoU >= 0.99, keypoints (where the row has them), nose and iris
    centres <= 1 px; returns (IoU, worst px)."""
    (det, mesh, left, right), score, _ = res
    w, h = gt["size"]
    assert abs(score - gt["score"]) < 0.01, (score, gt["score"])
    box_iou = iou((det[0, 0] * w, det[0, 1] * h, det[1, 0] * w,
                   det[1, 1] * h), gt["bbox"])
    assert box_iou >= 0.99, box_iou
    pts = [((det[2 + k, 0] * w, det[2 + k, 1] * h), g)
           for k, g in enumerate(gt.get("keypoints", []))]
    pts += [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
            ((left[71, 0] * w, left[71, 1] * h), gt["iris"]["L"]),
            ((right[71, 0] * w, right[71, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= 1.0, (pts, worst)
    return box_iou, worst


def compare_chains(res, ref, size, bf16=False):
    """Card chain vs CPU chain: worst point difference in px and score
    difference, within 0.25 px (x, y, and z in x's units) / 1e-3, or for
    bf16 nets the BF16 tolerances (x and y)."""
    w, h = size
    scale = np.array([w, h, w], np.float32)
    sc = abs(res[1] - ref[1])
    if bf16:
        assert sc <= BF16_SCORE_TOL, sc
        det, mesh, left, right = (
            torch.from_numpy(np.abs(a - b)[:, :2] * scale[:2]).amax(-1)[None]
            for a, b in zip(res[0], ref[0]))
        px = check_bf16_points(det, mesh, torch.cat([left, right], 1),
                               mesh[:, 1], torch.tensor([ref[2]]))
        return px, sc
    px = max(float((np.abs(a - b) * scale[:a.shape[1]]).max())
             for a, b in zip(res[0], ref[0]))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def phase_models(dtype=torch.float32):
    """The standalone models on the card with nets in ``dtype``; returns
    the launches of each kernel in this path."""
    bf16 = dtype == torch.bfloat16
    phase(f"models {str(dtype)[6:]}")
    back = tmodels.FaceDetectionModel.BACK_CAMERA
    card = (tmodels.FaceDetection(back, compute_dtype=dtype),
            tmodels.FaceLandmark(compute_dtype=dtype),
            tmodels.IrisLandmark(compute_dtype=dtype))
    cpu = (tmodels.FaceDetection(back, device="cpu", compute_dtype=dtype),
           tmodels.FaceLandmark(device="cpu", compute_dtype=dtype),
           tmodels.IrisLandmark(device="cpu", compute_dtype=dtype))
    fused = {fused_entry(dtype): card[0]._net.fused_launches(),
             "conv_epilogue": epilogues(card[0]._net, card[1]._net,
                                        card[2]._net, card[2]._net)}
    frames = {name: load_image(ROT / name) for name in GT}
    canvas = canvas_1080p(load_image)
    strip_types = []
    strips = warp.warp_bilinear_strips

    def spy(planes, xs, ys):
        strip_types.append(planes.dtype)
        return strips(planes, xs, ys)

    reset_counts()
    results = {}
    for name, img in frames.items():
        size = GT[name]["size"]
        # the whole-frame detection warp is K1 too, unless the geometry
        # takes the exact two-stage letterbox (the 200x225 portraits)
        warps = 3 + (image_ops.letterbox_two_stage_params(
            size, (card[0].in_w, card[0].in_h)) is None)
        results[name], n = counted(lambda: chain(card, img, size))
        assert n == only(warp_bilinear=warps, **fused), (name, n, warps)
    if not bf16:
        warp.warp_bilinear_strips = spy
        try:
            canvas_res, n = counted(lambda: chain(card, canvas,
                                                  (1920, 1080)))
        finally:
            warp.warp_bilinear_strips = strips
        # at 1080p the detection, mesh and both iris warps take the strip
        # kernel, over f32 planes
        assert n == only(warp_bilinear_strips=4, **fused), n
        assert strip_types == [torch.float32] * 4, strip_types
    launches = launch_counts()
    print(f"launches of the standalone models: {launches} for "
          f"{len(frames)} rotated frames" + ("" if bf16 else
                                            " and canvas (a)")
          + ", 5 calls each (detection, mesh, two irises)")
    for name, img in frames.items():
        size = GT[name]["size"]
        box_iou, worst = check_chain_gt(results[name], GT[name])
        px, sc = compare_chains(results[name], chain(cpu, img, size), size,
                                bf16)
        print(f"{name}: IoU {box_iou:.4f}, worst {worst:.3f} px vs ground "
              f"truth; GPU vs CPU port {px:.4f} px, score {sc:.2e}",
              flush=True)
    if not bf16:
        px, sc = compare_chains(canvas_res,
                                chain(cpu, canvas, (1920, 1080)),
                                (1920, 1080))
        print(f"canvas (a) 1920x1080 (warps on the strip kernel, f32 "
              f"planes): GPU vs CPU port {px:.4f} px, score {sc:.2e}",
              flush=True)
    return launches


def compare_detections(res, ref, size):
    """Card detections vs the CPU port's (lists of ``Detection``): the
    same count, points within CPU_PX_TOL, scores within CPU_SCORE_TOL;
    returns (worst px, worst score difference)."""
    w, h = size
    assert len(res) == len(ref) >= 1, (len(res), len(ref))
    px = sc = 0.0
    for a, b in zip(res, ref):
        px = max(px, float((np.abs(a.data - b.data)
                            * np.array([w, h], np.float32)).max()))
        sc = max(sc, abs(a.score - b.score))
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (px, sc)
    return px, sc


def check_gt_points(res, i, gt, budget=FULL_GT_PX):
    """The nose and both iris centres of frame ``i`` of a cascade result
    against a ground-truth row, within ``budget`` px; returns the worst."""
    w, h = gt["size"]
    mesh = res.mesh[i].cpu().numpy()
    iris = res.iris[i].cpu().numpy()
    pts = [((mesh[1, 0] * w, mesh[1, 1] * h), gt["nose"]),
           ((iris[0, 0, 0] * w, iris[0, 0, 1] * h), gt["iris"]["L"]),
           ((iris[1, 0, 0] * w, iris[1, 0, 1] * h), gt["iris"]["R"])]
    worst = max(max(abs(p[0] - g[0]), abs(p[1] - g[1])) for p, g in pts)
    assert worst <= budget, (pts, worst)
    return worst


def phase_full_detectors():
    """The full-range detectors on the card: FaceDetection(FULL) and
    FaceDetection(FULL_SPARSE) on the rotated frames and canvas (c), then
    FaceCascade(FULL) on the 540p rotated batch and
    FaceCascade(FULL_SPARSE, max_faces=4) on canvas (c), the counts set to
    0 before and read after: the detectors run op by op (no fused launch),
    each whole-frame detection warp and each cascade warp stage is one
    warp_bilinear launch.  Each against the port's CPU result (f32
    tolerances), the FULL cascade's nose and irises against the ground
    truth within FULL_GT_PX; returns the launches."""
    phase("full_detectors")
    full = tmodels.FaceDetectionModel.FULL
    sparse = tmodels.FaceDetectionModel.FULL_SPARSE
    frames = {name: load_image(ROT / name) for name in GT}
    frames["canvas (c)"] = canvas_grid(load_image)
    batch = np.stack([frames[n] for n in FRAMES_540])
    card = {m: tmodels.FaceDetection(m) for m in (full, sparse)}
    cascades = {"FULL": (full, 1, batch),
                "FULL_SPARSE K=4": (sparse, 4, frames["canvas (c)"][None])}
    for m, det in card.items():
        assert det._net.runs == [], m
    reset_counts()
    found = {}
    with eager_calls():         # each call's launches
        for m, det in card.items():
            for name, img in frames.items():
                size = (img.shape[1], img.shape[0])
                # the whole-frame warp is K1 unless the geometry takes
                # the exact two-stage letterbox (the 200x225 portraits)
                warps = int(image_ops.letterbox_two_stage_params(
                    size, (det.in_w, det.in_h)) is None)
                found[m, name], n = counted(lambda: det.infer(img))
                assert n == only(warp_bilinear=warps,
                                 conv_epilogue=epilogues(det._net)), (
                    m, name, n)
    cards = {label: FaceCascade(m, max_faces=k)
             for label, (m, k, _) in cascades.items()}
    results = {}
    for label, (_, _, images) in cascades.items():
        results[label] = run_cascade(
            cards[label], images,
            only(warp_bilinear=2,
                 conv_epilogue=cascade_epilogues(cards[label])))
    launches = launch_counts()
    print(f"launches of the full-range detectors: {launches} for "
          f"{len(card) * len(frames)} FaceDetection.infer calls and "
          f"{len(cascades)} cascade calls (2 warp_bilinear each, no fused "
          f"block: the nets' bottleneck blocks are no run)", flush=True)
    for m in card:
        cpu = tmodels.FaceDetection(m, device="cpu")
        worst = [0.0, 0.0]
        for name, img in frames.items():
            px, sc = compare_detections(found[m, name], cpu.infer(img),
                                        (img.shape[1], img.shape[0]))
            worst = [max(worst[0], px), max(worst[1], sc)]
        assert len(found[m, "canvas (c)"]) == 4
        print(f"FaceDetection({m.name}) on {len(frames)} frames: GPU vs "
              f"CPU port {worst[0]:.4f} px, scores {worst[1]:.2e}")
    for label, (m, k, images) in cascades.items():
        res = results[label]
        assert bool(res.mesh_valid.all()), (label, res.mesh_valid)
        size = (images.shape[2], images.shape[1])
        ref = FaceCascade(m, device="cpu", max_faces=k).infer_batch(images)
        px, sc = check_against_cpu(res, ref, size)
        print(f"FaceCascade({label}) {size[0]}x{size[1]} "
              f"B={images.shape[0]}: GPU vs CPU port {px:.4f} px, scores "
              f"{sc:.2e}", flush=True)
    worst = max(check_gt_points(results["FULL"], i, GT[name])
                for i, name in enumerate(FRAMES_540))
    print(f"FaceCascade(FULL) 540p: nose and irises within {worst:.3f} px "
          f"of the ground truth (budget {FULL_GT_PX})", flush=True)
    return launches


def phase_mxu():
    """warp_method="mxu" on the card: the standalone chain (BACK) on the
    rotated frames but the close-up (whose 350-px mesh ROI at 0.55 rad
    overflows auto_band's 56 rows: mxu_sample clamps to the band, in JAX
    too, and the mesh's presence drops to ~2e-4) and FaceCascade on the
    540p rotated batch, each against
    the port's CPU result (f32 tolerances), the counts set to 0 before and
    read after: no warp kernel (mxu_sample is plain torch), the BACK
    detector's fused launches only; returns the launches."""
    phase("mxu")
    back = tmodels.FaceDetectionModel.BACK_CAMERA
    card = (tmodels.FaceDetection(back, warp_method="mxu"),
            tmodels.FaceLandmark(warp_method="mxu"),
            tmodels.IrisLandmark(warp_method="mxu"))
    cascade = FaceCascade(warp_method="mxu")
    fused = card[0]._net.fused_launches()
    chained = epilogues(card[0]._net, card[1]._net, card[2]._net,
                        card[2]._net)
    frames = {name: load_image(ROT / name) for name in GT
              if name != "man_closeup_rotp30.png"}
    batch = np.stack([frames[n] for n in FRAMES_540])
    reset_counts()
    chains = {}
    with eager_calls():         # each call's launches
        for name, img in frames.items():
            chains[name], n = counted(lambda: chain(card, img,
                                                    GT[name]["size"]))
            assert n == only(fused_dw_pw_block_f32=fused,
                             conv_epilogue=chained), (name, n)
    res = run_cascade(cascade, batch, only(
        fused_dw_pw_block_f32=fused,
        conv_epilogue=cascade_epilogues(cascade)))
    launches = launch_counts()
    print(f"launches of the mxu paths: {launches} for {len(frames)} "
          f"standalone chains and one cascade call", flush=True)
    cpu = (tmodels.FaceDetection(back, warp_method="mxu", device="cpu"),
           tmodels.FaceLandmark(warp_method="mxu", device="cpu"),
           tmodels.IrisLandmark(warp_method="mxu", device="cpu"))
    worst = [0.0, 0.0]
    for name, img in frames.items():
        size = GT[name]["size"]
        px, sc = compare_chains(chains[name], chain(cpu, img, size), size)
        worst = [max(worst[0], px), max(worst[1], sc)]
    print(f"mxu standalone chain on {len(frames)} frames: GPU vs CPU port "
          f"{worst[0]:.4f} px, scores {worst[1]:.2e}")
    px, sc = check_against_cpu(res, FaceCascade(
        warp_method="mxu", device="cpu").infer_batch(batch), (540, 360))
    print(f"mxu cascade 540x360 B=4: GPU vs CPU port {px:.4f} px, scores "
          f"{sc:.2e}", flush=True)
    return launches



# identification (EmbedCascade, FaceEmbeddings): f32 embeddings on the
# card against the port's CPU result, max abs on the unit vectors (see
# TIE).  bf16 against the card's f32 result on the same frames: every
# crop edge within one pixel (the int-truncated crop moves where the bf16
# detections differ), and the cosine against the f32 net's embedding of
# the bf16 path's own crop (the bf16 nets' rounding alone) >= 0.99, or
# >= 0.98 for a crop smaller than the net's 112-px input (the 200x225
# portraits' ~93-px faces): there the port's op-by-op bf16 net, which
# rounds after every op as un-jitted JAX does, reaches 0.99002 on the
# CPU on russ2_rotp20's crop, where un-jitted JAX's own bf16 net reaches
# 0.98982 (jitted JAX, which keeps fused elementwise chains in f32,
# 0.99725), and 0.98820 on the portraits on an H100 80GB HBM3 (700 W).
# The cosine against the f32 path's embedding, whose crop may sit a
# pixel away, is printed: a 1-px move of a portrait crop turns the demo
# graph's (synthetic) embedding to cosine 0.984.
EMBED_TOL = 1e-4
BF16_CROP_PX = 1.0
BF16_COSINE = 0.99
BF16_COSINE_UPSCALED = 0.98


# Card against CPU in f32, the crops' uint8 levels differ by one where
# the value before the rint is a tie: an axis-aligned crop of an integer
# box samples at fractions k/112 of integer pixels, so many values sit
# exactly on a half level, and each device's f32 sums (cuBLAS and the
# CPU's BLAS add a hat matmul's two taps in other orders) land a few ulps
# to either side (on an H100 80GB HBM3 at 700 W: 2,048 of 2.4 million
# values at 540p b64; the JAX package's jitted crop differs from its own
# eager one in the same way).  The sampling coordinates differ by an
# ulp here and there too (ATen's CUDA division by a scalar multiplies by
# its reciprocal), which at coordinates of hundreds of pixels moves a value
# by up to a few hundredths of a level.  One level moves the demo graph's
# embedding by about 1e-4.  So the f32 embeddings are held in parts: each
# side's crop against the same crop computed in f64 from that side's own
# sampling coordinates (equal levels away from a tie, within one at a
# tie: within TIE of a half level), the nets on the card's own crops
# (EMBED_TOL), and the recomputed crops reproduce the path's embeddings.
TIE = 1e-3                      # 0-255 units


def exact_crops(frames, boxes, device, size=112):
    """The crops' values before the rint (0-255 units), flat
    [N, size, size, 3] (``size`` the embedding net's input side), of host
    frames [B, H, W, 3] at crop boxes [B(, K), 4]: the f32 sampling
    coordinates the port computes on ``device``, then the hat weights and
    both products in f64 on the CPU."""
    box = torch.as_tensor(np.asarray(boxes), dtype=torch.float32,
                          device=device)
    roi = torch.stack([(box[..., 0] + box[..., 2]) / 2.0,
                       (box[..., 1] + box[..., 3]) / 2.0,
                       box[..., 2] - box[..., 0], box[..., 3] - box[..., 1],
                       torch.zeros_like(box[..., 0])], dim=-1)
    sx, sy, _ = (t.cpu() for t in image_ops._source_coords(
        roi, (size, size), False, False))
    img = torch.from_numpy(np.ascontiguousarray(frames)).double()
    if box.dim() == 3:
        img = img[:, None]
    h, w = img.shape[-3:-1]

    def hat(src, n):
        taps = torch.arange(n, dtype=torch.float64)
        return (1.0 - (taps - src.double()[..., None]).abs()).clamp(min=0)

    t1 = hat(sy[..., :, 0], h) @ img.reshape(*img.shape[:-3], h, w * 3)
    out = hat(sx[..., 0, :], w).unsqueeze(-3) @ t1.reshape(
        *t1.shape[:-1], w, 3)
    return out.reshape(-1, size, size, 3)


def face_crops(model, frames, boxes):
    """The 112x112 crops (range (0, 1)), flat [N, 112, 112, 3] on the CPU,
    that ``model`` takes of host frames [B, H, W, 3] at absolute crop boxes
    (x0, y0, x1, y1) [B, 4] or [B, K, 4], recomputed on its device with
    its path's own shapes and sampler: an EmbedCascade over its frame
    planes (``_crop``), a FaceEmbeddings as its ``_pipeline`` crops."""
    dev = model.device
    box = torch.as_tensor(np.asarray(boxes), dtype=torch.float32).to(dev)
    roi = torch.stack([(box[..., 0] + box[..., 2]) / 2.0,
                       (box[..., 1] + box[..., 3]) / 2.0,
                       box[..., 2] - box[..., 0], box[..., 3] - box[..., 1],
                       torch.zeros_like(box[..., 0])], dim=-1)
    images = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
    with torch.inference_mode(), exact_f32():
        if isinstance(model, EmbedCascade):
            size = (images.shape[2], images.shape[1])
            crops = model._crop(model._prepare_frame(images, size),
                                roi if roi.dim() == 3 else roi[:, None])
        else:
            crops, _ = image_ops.warp_image_to_tensor(
                images, roi, (model.in_w, model.in_h), False, (0.0, 1.0),
                method=("separable" if model._warp == "pallas"
                        else model._warp))
    return crops.reshape(-1, *crops.shape[-3:]).cpu()


def crop_embeddings(model, crops):
    """``model``'s embedding net and L2 norm on crops [N, 112, 112, 3], on
    its device; [N, D] on the CPU."""
    net = model._embed_net if isinstance(model, EmbedCascade) else model._net
    with torch.inference_mode(), exact_f32():
        (raw,) = net(crops.to(model.device))
        return l2_normalize(raw.reshape(raw.shape[0], -1)).cpu()


def hold_f32_embeddings(card, cpu, card_emb, cpu_emb, frames, boxes,
                        valid, label):
    """The f32 embeddings [N, D] one path gave on the card (``card``, a
    model on the card) and on the CPU (``cpu``), for the N faces of host
    frames [B, H, W, 3] cropped at ``boxes`` [B(, K), 4] (the same on
    both: ``check_embed`` holds the crop boxes equal), of which ``valid``
    [N] count: the crops recomputed on the card give ``card_emb``; each
    side's crop levels equal the rint of its ``exact_crops`` away from a
    tie and lie within one of it at a tie; the CPU's net on the card's crops
    gives ``card_emb`` within EMBED_TOL.  Returns (worst embedding
    difference, levels one apart between the two sides, worst net
    difference)."""
    card_emb, cpu_emb = card_emb.cpu(), torch.as_tensor(cpu_emb).cpu()
    valid = torch.as_tensor(valid).cpu()
    crops = face_crops(card, frames, boxes)
    again = float((crop_embeddings(card, crops) - card_emb).abs().max())
    assert again <= 1e-6, (label, "the recomputed crops", again)
    sides = []
    for model, side in ((card, crops), (cpu, face_crops(cpu, frames,
                                                         boxes))):
        exact = exact_crops(frames, boxes, model.device,
                            side.shape[1])[valid]
        tie = ((exact - torch.floor(exact)) - 0.5).abs() <= TIE
        want = torch.round(exact)
        levels = torch.round(side[valid] * 255)
        off = (levels - want).abs()
        assert float(off.max()) <= 1 and not bool((off > 0)[~tie].any()), (
            label, float(off.max()), int((off > 0)[~tie].sum()))
        sides.append(levels)
    flips = int((sides[0] != sides[1]).sum())
    net = float((crop_embeddings(cpu, crops) - card_emb)[valid].abs().max())
    assert net <= EMBED_TOL, (label, net)
    return float((card_emb - cpu_emb)[valid].abs().max()), flips, net


def check_embed(res, ref, size, label):
    """An f32 EmbedResult on the card against the CPU port's: equal
    ``face_valid`` and, for valid faces, equal ``crop_bbox``, detection
    within CPU_PX_TOL px and scores within CPU_SCORE_TOL (the embeddings:
    ``hold_f32_embeddings``); returns (px, score) differences."""
    res = type(res)(*(f.cpu() for f in res))
    assert torch.equal(res.face_valid, ref.face_valid), label
    ok = ref.face_valid
    assert bool(ok.any()), label
    assert torch.equal(res.crop_bbox[ok], ref.crop_bbox[ok]), (
        label, res.crop_bbox[ok], ref.crop_bbox[ok])
    w, h = size
    px = float(((res.detection[ok] - ref.detection[ok]).abs()
                * torch.tensor([w, h])).max())
    sc = float((res.score[ok] - ref.score[ok]).abs().max())
    assert px <= CPU_PX_TOL and sc <= CPU_SCORE_TOL, (label, px, sc)
    return px, sc


def hold_cascade_embeddings(card, cpu, res, ref, frames, label):
    """``hold_f32_embeddings`` for an EmbedCascade's results on the card
    (``res``) and the CPU (``ref``) over host frames [B, H, W, 3]."""
    d = res.embedding.shape[-1]
    return hold_f32_embeddings(
        card, cpu, res.embedding.reshape(-1, d),
        ref.embedding.reshape(-1, d), frames, res.crop_bbox.cpu(),
        ref.face_valid.reshape(-1), label)


def check_embed_bf16(res, f32, model, frames, label):
    """A bf16 EmbedResult against the card's f32 one on the same frames
    (host [B, H, W, 3]): as many valid faces per frame; each valid f32
    face matched to the valid bf16 face of its frame whose crop centre is
    nearest (bf16 scores may order near-tied faces the other way), its
    crop edges within BF16_CROP_PX; and each bf16 embedding within cosine
    BF16_COSINE (BF16_COSINE_UPSCALED for a crop smaller than 112 px) of
    ``model``'s (f32 FaceEmbeddings) embedding of the same crop.  Returns
    (worst crop px, lowest cosine against the f32 path's embedding,
    lowest cosine against the f32 net on the same crop)."""
    res, f32 = (type(r)(*(f.cpu() for f in r)) for r in (res, f32))
    if f32.face_valid.dim() == 1:           # no face axis at max_faces=1
        res, f32 = (type(r)(*(f[:, None] for f in r)) for r in (res, f32))
    assert torch.equal(res.face_valid.sum(1), f32.face_valid.sum(1)), label
    centre = (lambda c: (c[:2] + c[2:]) / 2)           # noqa: E731
    worst, lowest = 0.0, 1.0
    for i, j in torch.nonzero(f32.face_valid).tolist():
        want = f32.crop_bbox[i, j]
        k = min(torch.nonzero(res.face_valid[i]).flatten().tolist(),
                key=lambda k: float((centre(res.crop_bbox[i, k])
                                     - centre(want)).norm()))
        worst = max(worst, float((res.crop_bbox[i, k] - want).abs().max()))
        lowest = min(lowest, float((res.embedding[i, k]
                                    * f32.embedding[i, j]).sum()))
    faces = torch.nonzero(res.face_valid).tolist()
    same = torch.from_numpy(model.infer_batch(
        frames[[i for i, _ in faces]],
        [tuple(res.crop_bbox[i, k].tolist()) for i, k in faces]))
    net = 1.0
    for n, (i, k) in enumerate(faces):
        box = res.crop_bbox[i, k]
        cos = float((res.embedding[i, k] * same[n]).sum())
        side = float(min(box[2] - box[0], box[3] - box[1]))
        assert cos >= (BF16_COSINE if side >= 112 else
                       BF16_COSINE_UPSCALED), (label, i, k, side, cos)
        net = min(net, cos)
    assert worst <= BF16_CROP_PX, (label, worst)
    return worst, lowest, net


def cli_json(argv, device=None):
    """``python -m tpu_face_torch <argv>`` in a subprocess from the
    repository root (``--device`` only if given: the card by default),
    started and returned as a Popen."""
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_face_torch", *argv]
        + (["--device", device] if device else []), cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_lines(proc):
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, (proc.args, err[-3000:])
    return [json.loads(line) for line in out.strip().splitlines()]


def cli_close(got, want, key=""):
    """The card CLI's JSON against the CPU run's: the same keys, equal
    flags, strings and crop boxes, scores within CPU_SCORE_TOL,
    coordinates within CPU_PX_TOL px and cosines within 1e-3 (four
    decimals of embeddings within EMBED_TOL)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (key, got, want)
        for k in want:
            cli_close(got[k], want[k], k)
    elif isinstance(want, list):
        assert len(got) == len(want), (key, got, want)
        for g, w in zip(got, want):
            cli_close(g, w, key)
    elif isinstance(want, (bool, str)) or key in ("crop_bbox", "dim"):
        assert got == want, (key, got, want)
    else:
        tol = {"score": CPU_SCORE_TOL,
               "cosine_similarity": 1e-3}.get(key, CPU_PX_TOL)
        assert abs(got - want) <= tol, (key, got, want)


def phase_embed_net(model, seed, tol, routed):
    """A main path: the identification path on one of the benchmark's
    published-width embedding nets (``benchmark/models/<model>.py``, the
    graph written from ``seed`` into build/), EmbedCascade(FULL_SPARSE,
    max_faces=4) through its cached call on canvas (c) eight times over
    (32 crops a call), the counts set to 0 before it and read after.
    ``routed`` gives the launches a run of each split-TF32 kernel
    ({"conv3x3_tc": R100's 98 routed convs, "fc_tc": ViT-L's 144 token
    FCs, 6 a block, or Swin-S's 137}): the net's ``tc_convs`` and
    ``tc_fcs`` count them, and one eager run of ``_forward`` first makes
    them and one epilogue a chain, no other launch but the detector's
    and the warp's.  The cached first call makes them once for each of
    its runs (the warm-ups and the capture), its replays none, and its
    result equals the eager call's within ``tol``; the first frame's
    result against the port on the CPU (``check_embed``,
    ``hold_cascade_embeddings``: the nets on the card's crops within
    ``tol``, the configuration's ``embedding_abs``).
    Returns the launches."""
    phase(f"embed {model}")
    if str(ROOT / "benchmark") not in sys.path:
        sys.path.append(str(ROOT / "benchmark"))
    gen = importlib.import_module(f"models.{model}")
    made = gen.write(ROOT / "build" / "chip_smoke" / model, seed,
                     files=(gen.GRAPH_FILE,))
    sparse = tmodels.FaceDetectionModel.FULL_SPARSE
    canvas = canvas_grid(load_image)[None]
    frames = np.tile(canvas, (8, 1, 1, 1))
    cas = EmbedCascade(sparse, embed_model_path=str(made), max_faces=4)
    net = cas._embed_net
    assert {"conv3x3_tc": len(net.tc_convs), "fc_tc": len(net.tc_fcs),
            "attention_tc": len(net.tc_cores)} == routed, (model, routed)
    with eager_calls():
        eager, per_run = counted(lambda: cas.infer_batch(frames))
    assert per_run == only(
        fused_dw_pw_block_f32=cas._det_net.fused_launches(),
        warp_bilinear=per_run["warp_bilinear"],
        conv_epilogue=cascade_epilogues(cas), **routed), (model, per_run)
    reset_counts()
    res, n = counted(lambda: cas.infer_batch(frames))
    runs = capture_runs()
    assert n == {k: v * runs for k, v in per_run.items()}, (n, per_run)
    launches = launch_counts()
    again, n = counted(lambda: cas.infer_batch(frames))
    assert n == only(), n
    assert all(torch.equal(a, b) for a, b in
               zip(result_arrays(again), result_arrays(res)))
    hold_cached(f"EmbedCascade {model} 1080x720 K=4 B=8", res, eager,
                tol=tol)
    print(f"launches of the {model} identification path: {launches} for "
          f"one cached infer_batch of 8 frames ({runs} runs of _forward: "
          f"the warm-ups and the capture; {per_run['conv3x3_tc']} "
          f"conv3x3_tc, {per_run['fc_tc']} fc_tc, "
          f"{per_run['attention_tc']} attention_tc (the attention cores) and "
          f"{per_run['conv_epilogue']} epilogue launches a run)",
          flush=True)

    cpu = EmbedCascade(sparse, embed_model_path=str(made), max_faces=4,
                       device="cpu")
    ref = cpu.infer_batch(canvas)
    first = type(res)(*(f[:1] for f in res))
    label = f"{model} canvas (c)"
    px, sc = check_embed(first, ref, (1080, 720), label)
    e, flips, net = hold_cascade_embeddings(cas, cpu, first, ref, canvas,
                                            label)
    assert net <= tol, (model, net)
    print(f"EmbedCascade {model} canvas (c) 1080x720 K=4: "
          f"{int(first.face_valid.sum())} valid faces; f32 GPU vs CPU port "
          f"{px:.4f} px, scores {sc:.2e}, embeddings {e:.2e} ({flips} crop "
          f"levels one apart; {model} on the card's crops {net:.2e}, limit "
          f"{tol:g})", flush=True)
    return launches


def phase_embed():
    """The identification path on the card, the counts set to 0 before
    and read after: EmbedCascade(BACK, the demo embedding graph) with f32
    and with bf16 nets on the rotated frames (the 540p four x16 = batch
    64, the close-up, the portraits) and on canvas (c) with max_faces=4,
    then FaceEmbeddings.infer_batch (f32, bf16) and embed_boxes of a
    FaceCascade result's meshes (f32).  Each call's launches: the BACK
    detector's fused launches (13 on the f32 kernel, 8 on the bf16 one)
    and no warp kernel (the crop is the separable hat matmuls); the
    standalone model none.  f32 against the port's CPU result
    (``check_embed``), bf16 against the card's f32 result
    (``check_embed_bf16``).  Then the CLI's ``identify`` and ``cascade``
    on the card against the CPU (subprocesses), the native JPEG loader
    against Pillow where it builds, and one call each of EmbedCascade and
    FaceCascade at 540p b64 (``check_batch``).  Returns the launches."""
    phase("embed")
    f32, bf16 = torch.float32, torch.bfloat16
    demo = str(DATA_DIR / "demo")
    groups, batches = rotated_batches()
    b = BATCH["540p"]
    four = batches[(540, 360)]
    batches[(540, 360)] = np.tile(four, (b // 4, 1, 1, 1))
    canvas = canvas_grid(load_image)[None]
    cas = {dt: EmbedCascade(embed_model_path=demo, compute_dtype=dt)
           for dt in (f32, bf16)}
    cas4 = {dt: EmbedCascade(embed_model_path=demo, compute_dtype=dt,
                             max_faces=4) for dt in (f32, bf16)}
    fused = {dt: cas[dt]._det_net.fused_launches() for dt in (f32, bf16)}
    assert fused == {f32: 13, bf16: 8}, fused
    assert cas[f32]._embed_net.runs == [], "the embedding net has a run"
    emb = {dt: tmodels.FaceEmbeddings(demo, compute_dtype=dt)
           for dt in (f32, bf16)}
    boxes = [(207.3, 72.5, 346.9, 211.2), (184.2, 80.3, 317.9, 213.7),
             (178.4, 88.7, 301.1, 211.4), (231.6, 82.1, 353.8, 204.9)]
    # set-up, not this path: the meshes embed_boxes takes
    meshes = FaceCascade().infer_batch(four).mesh

    reset_counts()
    res = {}
    for dt in (f32, bf16):
        want = only(**{fused_entry(dt): fused[dt]},
                    conv_epilogue=cascade_epilogues(cas[dt]))
        for size, batch in batches.items():
            res[dt, size], n = counted(
                lambda: cas[dt].infer_batch(batch))
            assert n == want, (str(dt), size, n, want)
        res[dt, "c"], n = counted(lambda: cas4[dt].infer_batch(canvas))
        assert n == want, (str(dt), "canvas (c)", n, want)
        res[dt, "infer_batch"], n = counted(
            lambda: emb[dt].infer_batch(four, boxes))
        assert n == only(conv_epilogue=epilogues(emb[dt]._net)), (
            str(dt), "infer_batch", n)
    res["embed_boxes"], n = counted(
        lambda: emb[f32].embed_boxes(four, meshes, as_numpy=False))
    assert n == only(conv_epilogue=epilogues(emb[f32]._net)), (
        "embed_boxes", n)
    launches = launch_counts()
    print(f"launches of the identification path: {launches} for "
          f"{len(batches) + 1} EmbedCascade calls per dtype ({fused[f32]} "
          f"f32 and {fused[bf16]} bf16 fused launches per call, no warp "
          f"kernel) and 3 FaceEmbeddings calls (the f32 embedding net's "
          f"epilogues only)", flush=True)

    cpu = EmbedCascade(embed_model_path=demo, device="cpu")
    cpu4 = EmbedCascade(embed_model_path=demo, device="cpu", max_faces=4)
    for size, names in groups.items():
        frames = four if size == (540, 360) else batches[size]
        ref = cpu.infer_batch(frames)
        rows = torch.arange(batches[size].shape[0]) % len(names)
        ref = type(ref)(*(f[rows] for f in ref))
        px, sc = check_embed(res[f32, size], ref, size, size)
        e, flips, net = hold_cascade_embeddings(
            cas[f32], cpu, res[f32, size], ref, batches[size], size)
        crop, cos, same = check_embed_bf16(res[bf16, size], res[f32, size],
                                           emb[f32], batches[size], size)
        print(f"EmbedCascade {size[0]}x{size[1]} B={len(rows)}: f32 GPU vs "
              f"CPU port {px:.4f} px, scores {sc:.2e}, embeddings {e:.2e} "
              f"({flips} crop levels one apart; the nets on the card's "
              f"crops {net:.2e}); bf16 vs f32 crops within {crop:.0f} px, "
              f"cosine >= {cos:.5f} (the f32 net on the bf16 crops: >= "
              f"{same:.5f})", flush=True)
    ref = cpu4.infer_batch(canvas)
    px, sc = check_embed(res[f32, "c"], ref, (1080, 720), "canvas (c)")
    assert int(res[f32, "c"].face_valid.sum()) == 4
    e, flips, net = hold_cascade_embeddings(cas4[f32], cpu4, res[f32, "c"],
                                            ref, canvas, "canvas (c)")
    crop, cos, same = check_embed_bf16(res[bf16, "c"], res[f32, "c"],
                                       emb[f32], canvas, "canvas (c)")
    print(f"EmbedCascade canvas (c) 1080x720 K=4: f32 GPU vs CPU port "
          f"{px:.4f} px, scores {sc:.2e}, embeddings {e:.2e} ({flips} crop "
          f"levels one apart; the nets on the card's crops {net:.2e}); "
          f"bf16 vs f32 crops within {crop:.0f} px, cosine >= {cos:.5f} "
          f"(the f32 net on the bf16 crops: >= {same:.5f})", flush=True)
    cpu_emb = tmodels.FaceEmbeddings(demo, device="cpu")
    cut = [(int(x0), int(y0), int(x0) + int(x1 - x0), int(y0) + int(y1 - y0))
           for x0, y0, x1, y1 in boxes]
    e1, f1, n1 = hold_f32_embeddings(
        emb[f32], cpu_emb, torch.from_numpy(res[f32, "infer_batch"]),
        cpu_emb.infer_batch(four, boxes), four, cut,
        torch.ones(4, dtype=torch.bool), "infer_batch")
    xy = meshes[..., :2].cpu()
    _, mesh_boxes = geometry.crop_roi_from_detection(
        torch.stack([xy.amin(-2), xy.amax(-2)], dim=-2), (540, 360),
        xp=torch)
    e2, f2, n2 = hold_f32_embeddings(
        emb[f32], cpu_emb, res["embed_boxes"],
        cpu_emb.embed_boxes(four, meshes.cpu()), four, mesh_boxes,
        torch.ones(4, dtype=torch.bool), "embed_boxes")
    cos = float((res[bf16, "infer_batch"] * res[f32, "infer_batch"])
                .sum(-1).min())
    assert cos >= BF16_COSINE, cos
    print(f"FaceEmbeddings: infer_batch GPU vs CPU port {e1:.2e} ({f1} "
          f"crop levels one apart; nets {n1:.2e}), embed_boxes of the "
          f"cascade's meshes {e2:.2e} ({f2}; {n2:.2e}); bf16 vs f32 cosine "
          f">= {cos:.5f}", flush=True)

    # the CLI on the card against the CPU, in subprocesses started
    # together
    two = [str(ROT / n) for n in FRAMES_540[:2]]
    commands = {"identify": ["identify", *two],
                "cascade": ["cascade", *two, "--pixels"]}
    procs = {(name, dev): cli_json(argv, dev)
             for name, argv in commands.items() for dev in (None, "cpu")}
    for name in commands:
        card_lines = cli_lines(procs[name, None])
        cli_close(card_lines, cli_lines(procs[name, "cpu"]))
        print(f"python -m tpu_face_torch {name} on the card: "
              f"{json.dumps(card_lines[-1])[:160]} (matches the CPU run)",
              flush=True)

    # the native JPEG loader against Pillow
    from PIL import Image
    available = native_loader.available()
    print(f"native_loader.available(): {available}", flush=True)
    if available:
        buf = io.BytesIO()
        Image.fromarray(four[0]).save(buf, format="JPEG", quality=90)
        ours = native_loader.decode_jpeg(buf.getvalue())
        pil = np.asarray(Image.open(io.BytesIO(buf.getvalue()))
                         .convert("RGB"))
        diff = np.abs(ours.astype(np.int16) - pil.astype(np.int16))
        assert diff.mean() < 1.0 and diff.max() <= 16, (diff.mean(),
                                                        diff.max())
        print(f"native decode vs Pillow: mean {diff.mean():.4f}, max "
              f"{diff.max()} levels", flush=True)

    # EmbedCascade and FaceCascade at 540p b64, the batch on the card
    batch = torch.from_numpy(batches[(540, 360)]).cuda()
    for dt in (f32, bf16):
        want = {fused_entry(dt): fused[dt]}
        face = FaceCascade(compute_dtype=dt)
        check_batch(cas[dt], batch, only(
            **want, conv_epilogue=cascade_epilogues(cas[dt])))
        check_batch(face, batch, only(
            warp_bilinear=2, **want, conv_epilogue=cascade_epilogues(face)))
    print(f"EmbedCascade and FaceCascade 540x360 b{b}, f32 and bf16: each "
          f"call's launches, a face in every frame", flush=True)
    return launches


TRACK_SEQ = ["man_rotm30.png", "man_rotm15.png", "man_rotp15.png",
             "man_rotp30.png", "man_rotp15.png"]


def tracker_frames(frames, step, streams, blank=()):
    """Step ``step`` of the tracker's 540p sequence for ``streams``
    streams, stream s shifted 4*s px right, the streams in ``blank``
    black."""
    out = []
    for s in range(streams):
        f = np.roll(frames[TRACK_SEQ[step]], 4 * s, axis=1)
        out.append(np.zeros_like(f) if s in blank else f)
    return np.stack(out)


def run_tracker(card, cpu, steps, size):
    """Each ``(frames, launches)`` of ``steps`` through the card's tracker,
    checked for its launches, and through the CPU port's tracker entered
    with the card's state: the results within the f32 tolerances, the
    lock states equal.  Returns the worst (px, score) differences."""
    worst = [0.0, 0.0]
    for i, (frames, want) in enumerate(steps):
        if card._state is not None:
            cpu._state = type(card._state)(*(t.cpu() for t in card._state))
        res, n = counted(lambda: card.step(frames))
        assert n == want, (i, n, want)
        ref = cpu.step(frames)
        assert (card.tracking == cpu.tracking).all(), i
        px, sc = check_against_cpu(res, ref, size)
        worst = [max(worst[0], px), max(worst[1], sc)]
    return worst


def phase_tracker():
    """FaceTracker() (BACK, f32) on the card, the counts set to 0 before
    and read after: 8 streams of the rotated 540p sequence (TRACK_SEQ),
    stream 2 blanked at step 2; then 2 streams of canvas (a) at 1920x1080
    over three steps.  Every step's launches are checked: the full path
    (the first step) 2 warp launches and the detector's fused launches, a
    locked step 2 warp launches and no fused launch (the detector does
    not run), a repair step 4 warp launches (the tracked stages and the
    one-stream repair cascade) and the fused launches of the sub-batch's
    detector; at 1080p the warps are warp_bilinear_strips.  Each step
    against the port's CPU tracker entered with the card's state.  Then a
    locked step of 64 streams, its launches.  Returns the launches."""
    phase("tracker")
    frames = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    card = tracking.FaceTracker()
    fused = card.cascade._det_net.fused_launches()
    chained = cascade_epilogues(card.cascade)
    tracked = epilogues(card.cascade._mesh_net, card.cascade._iris_net)
    full = only(warp_bilinear=2, fused_dw_pw_block_f32=fused,
                conv_epilogue=chained)
    locked = only(warp_bilinear=2, conv_epilogue=tracked)
    repair = only(warp_bilinear=4, fused_dw_pw_block_f32=fused,
                  conv_epilogue=chained + tracked)
    steps = [(tracker_frames(frames, i, 8, (2,) if i == 2 else ()), want)
             for i, want in enumerate((full, locked, repair, repair,
                                       locked))]
    canvas = canvas_1080p(load_image)
    hires = [(np.stack([np.roll(canvas, 8 * i + 4 * s, axis=1)
                        for s in range(2)]), want)
             for i, want in enumerate((
                 only(warp_bilinear_strips=2, fused_dw_pw_block_f32=fused,
                      conv_epilogue=chained),
                 only(warp_bilinear_strips=2, conv_epilogue=tracked),
                 only(warp_bilinear_strips=2, conv_epilogue=tracked)))]
    cards = (card, tracking.FaceTracker())
    reset_counts()
    cpu = tracking.FaceTracker(device="cpu")
    worst = run_tracker(card, cpu, steps, (540, 360))
    print(f"tracker 540x360 8 streams, 5 steps (full, locked, repair, "
          f"repair, locked): GPU vs CPU port {worst[0]:.4f} px, scores "
          f"{worst[1]:.2e}", flush=True)
    worst = run_tracker(cards[1], tracking.FaceTracker(device="cpu"), hires,
                        (1920, 1080))
    print(f"tracker 1920x1080 2 streams, 3 steps (full, locked, locked; "
          f"warp_bilinear_strips): GPU vs CPU port {worst[0]:.4f} px, "
          f"scores {worst[1]:.2e}", flush=True)
    launches = launch_counts()
    print(f"launches of the tracker: {launches}", flush=True)

    # a locked step of 64 streams
    b = BATCH["track"]
    batch = torch.from_numpy(np.tile(np.stack([frames[n] for n in
                                               FRAMES_540]),
                                     (b // 4, 1, 1, 1))).cuda()
    big = tracking.FaceTracker()
    big.step(batch)
    _, n = counted(lambda: big.step(batch))
    assert n == locked and big.tracking.all(), n
    print(f"tracker 540x360 {b} streams: a locked step's launches {n}",
          flush=True)
    return launches


# ---- serving: AOT programs and batch data parallelism ------------------

AOT_DIR = ROOT / "build" / "tpu_face_torch" / "aot"
SHARD_TOL = 2e-3    # sharded vs unsharded, as tests/test_sharding.py


def close(got, want, tol, label):
    """Every field of ``got`` within ``tol`` of ``want``'s, bools equal;
    returns the largest difference."""
    worst = 0.0
    for f, a, b in zip(want._fields, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, (label, f)
        if a.dtype == torch.bool:
            assert torch.equal(a, b), (label, f)
        else:
            worst = max(worst, float((a.float() - b.float()).abs().max()))
    assert worst <= tol, (label, worst)
    return worst


# the kernels line's entry of each warp and epilogue operator
GRAPH_OPS = {"warp_bilinear_segments": "warp_bilinear",
             "warp_bilinear_strips": "warp_bilinear_strips",
             "conv_epilogue": "conv_epilogue",
             "conv3x3_tc": "conv3x3_tc",
             "fc_tc": "fc_tc"}


def graph_launches(prog):
    """The kernel launches one call of a loaded program makes, read from
    its graph: one per warp operator node, one per chunk of each fused
    run operator node (by its activations' type), one per epilogue
    operator node; and the fused nodes."""
    counts = dict.fromkeys(SOURCES, 0)
    runs = 0
    for program in prog.programs.values():
        for node in program.module.graph.nodes:
            name = str(node.target)
            if node.op != "call_function" or not name.startswith(
                    "tpu_face_torch."):
                continue
            op = name.split(".")[1]
            if op == "fused_blocks":
                runs += 1
                counts[fused_entry(node.args[0].meta["val"].dtype)] += len(
                    node.args[3])
            else:
                counts[GRAPH_OPS[op]] += 1
    return counts, runs


def aot_cascade(label, make, frames, want, runs):
    """Save ``make()``'s program at ``frames``' geometry, load it, attach
    it to a fresh ``make()`` and hold one call against the live one: within
    1e-6 with the flags equal, the same counted launches (``want``) per
    call, and its graph's operators: ``want`` launches in ``runs`` fused
    run nodes."""
    live_obj = make()
    live, n = counted(lambda: live_obj(frames))
    assert n == want, (label, "live", n, want)
    b = frames.shape[0]
    planar = live_obj._layout == "planar"
    h, w = frames.shape[2:] if planar else frames.shape[1:3]
    path = aot.save(live_obj, AOT_DIR / f"{label}.aot", batch=b, height=h,
                    width=w)
    prog = aot.load(path)
    assert graph_launches(prog) == (want, runs), (label, graph_launches(prog))
    fresh = make()
    aot.attach(fresh, path)
    out, n = counted(lambda: fresh(frames))
    assert n == want, (label, "attached", n, want)
    diff = close(out, live, 1e-6, label)
    print(f"aot {label}: attached vs live max |diff| {diff:.3g}, launches "
          f"per call {({k: v for k, v in want.items() if v})} (graph: {runs} "
          f"fused run nodes)", flush=True)


def cascade_makers():
    """{label: constructor} of the aot phases' cascades."""
    demo = str(DATA_DIR / "demo")
    return {
        "cascade_f32_540p_b8": FaceCascade,
        "cascade_bf16_540p_b8": lambda: FaceCascade(
            compute_dtype=torch.bfloat16),
        "cascade_f32_1080p_planar_b4": lambda: FaceCascade(
            input_layout="planar"),
        "embed_cascade_f32_540p_b8": lambda: EmbedCascade(
            embed_model_path=demo)}


def aot_cases(frames, hires, fused):
    """{label: (constructor, frames, launches per call)} of the aot
    phases: FaceCascade f32 and bf16 at 540x360 batch 8 (``frames``), f32
    at 1920x1080 planar batch 4 (``hires``: the strip kernel) and
    EmbedCascade f32 (demo graph) at 540x360 batch 8; ``fused`` the BACK
    detector's fused launches per forward by the nets' type.  The f32
    nets' epilogue launches are their chains' (81 for a FaceCascade: 5
    detector, 23 mesh, 53 iris); the bf16 nets have none."""
    f32, bf16 = torch.float32, torch.bfloat16
    make = cascade_makers()
    chained = {label: cascade_epilogues(make[label]())
               for label in ("cascade_f32_540p_b8",
                             "embed_cascade_f32_540p_b8")}
    assert chained["cascade_f32_540p_b8"] == 81, chained
    want = {
        "cascade_f32_540p_b8": (frames, only(
            warp_bilinear=2, fused_dw_pw_block_f32=fused[f32],
            conv_epilogue=chained["cascade_f32_540p_b8"])),
        "cascade_bf16_540p_b8": (frames, only(
            warp_bilinear=2, fused_dw_pw_block_bf16=fused[bf16])),
        "cascade_f32_1080p_planar_b4": (hires, only(
            warp_bilinear_strips=2, fused_dw_pw_block_f32=fused[f32],
            conv_epilogue=chained["cascade_f32_540p_b8"])),
        "embed_cascade_f32_540p_b8": (frames, only(
            fused_dw_pw_block_f32=fused[f32],
            conv_epilogue=chained["embed_cascade_f32_540p_b8"]))}
    return {label: (make[label], *v) for label, v in want.items()}


def phase_aot():
    """The serving programs on the card, the counts set to 0 before and
    read after: FaceCascade f32 and bf16 at 540x360 batch 8, f32 at
    1920x1080 planar batch 4 (the strip kernel), EmbedCascade f32 (demo
    graph) at 540x360 batch 8, each saved (``aot.save``), loaded and
    attached to a fresh object and held against the live one
    (``aot_cascade``); then FaceTracker and MultiFaceTracker (K=2) at 8
    streams of 540x360, each saved as one step program, attached and held
    against the live step in every branch (``aot_tracker``: within 1e-6,
    flags, lock states and launches equal; the loaded program
    bit-identical with the attached step).  Returns (launches, the three
    FaceCascade cases of ``aot_cases``, whose export artifacts stay in
    AOT_DIR for ``phase_aot_executable``)."""
    phase("aot")
    AOT_DIR.mkdir(parents=True, exist_ok=True)
    f32, bf16 = torch.float32, torch.bfloat16
    four = np.stack([load_image(ROT / n) for n in FRAMES_540])
    frames = torch.from_numpy(np.tile(four, (2, 1, 1, 1))).cuda()
    hires = hires_batch(canvas_1080p(load_image), 4, np.random.default_rng(1))
    fused = {dt: FaceCascade(compute_dtype=dt)._det_net.fused_launches()
             for dt in (f32, bf16)}
    runs = 4                    # the BACK detector's residual runs
    cases = aot_cases(frames, hires, fused)
    reset_counts()
    for label, (make, x, want) in cases.items():
        aot_cascade(label, make, x, want, runs)
    cases.pop("embed_cascade_f32_540p_b8")
    assert (fused[f32], fused[bf16]) == (13, 8), fused

    # the trackers: one step program each, held in every branch
    track = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    x = torch.from_numpy(np.stack([np.roll(track[TRACK_SEQ[2]], 4 * s,
                                           axis=1)
                                   for s in range(8)])).cuda()
    for label, make in TRACKERS.items():
        aot_tracker(label, make, x)
    launches = launch_counts()
    print(f"launches of the aot path: {launches}", flush=True)
    return launches, cases


# the trackers of the aot phases: redetect_every and repair_batch as
# branch_cases needs them
TRACKERS = {
    "face_tracker": lambda: tracking.FaceTracker(redetect_every=3,
                                                 repair_batch=2),
    "multiface_tracker_k2": lambda: tracking.MultiFaceTracker(
        max_faces=2, redetect_every=3, repair_batch=2)}


def entered_step(tracker, state, steps, frames):
    """One ``step`` of ``tracker`` entered with ``state`` after ``steps``
    steps, on frames of the state's size; returns (result, next
    state)."""
    entered(tracker, state, steps)
    tracker._state_hw = tuple(frames.shape[1:3])
    res = tracker.step(frames)
    return res, tracker._state


def next_rois(got, want, label):
    """A next tracker state held to the cascade contract: the flags and
    lock states equal, and over the valid rows the ROIs' centre and size
    within 0.25 px and their angle within 1e-3 rad (as
    tests/test_torch_aot_tracking.py holds a loaded step against JAX's).
    Returns the largest (px, rad)."""
    close(got, want, math.inf, label)           # the bools equal
    ok = want.valid
    if not bool(ok.any()):
        return 0.0, 0.0
    d = (got.roi[ok] - want.roi[ok]).abs()
    px, rad = float(d[:, :4].max()), float(d[:, 4].max())
    assert px <= CPU_PX_TOL and rad <= 1e-3, (label, px, rad)
    return px, rad


def aot_tracker(label, make, frames, compiled=None):
    """Save ``make()``'s step program at 8 streams of 540x360 (one
    "step" program, its exported graph two ``torch.cond`` nodes), or take
    the executable at ``compiled`` (from ``compile_executables``), attach
    it to a fresh ``make()`` and hold it in every branch
    (``branch_cases``: locked, repair, forced, mass loss), each entered
    with the same state: the attached step against the live step (this
    phase's eager calls) with the same counted launches, the flags and
    next lock states equal and the numbers within 1e-6 (an export) or,
    the result and the next ROIs, the cascade contract (an executable:
    ``next_rois``); the loaded program ``attach`` returns (``aot.load``'s),
    called as ``prog(images, *state, force)``, bit-identical with the
    attached step."""
    blank = frames.clone()
    blank[2] = 0
    live, attached = make(), make()
    if compiled is None:
        kind, path = "export", AOT_DIR / f"{label}.aot"
        aot.save(make(), path, batch=8, height=360, width=540)
    else:
        kind, path = "executable", compiled
    prog = aot.attach(attached, path)
    assert [q["name"] for q in prog.meta["programs"]] == ["step"], prog.meta
    if kind == "export":
        graph = prog.programs["step"].module.graph
        assert sum(n.target is torch.ops.higher_order.cond
                   for n in graph.nodes) == 2, label
    cases = branch_cases(live, frames, blank)
    for branch, (x, state, n) in cases.items():
        (want, want_state), nl = counted(
            lambda: entered_step(live, state, n, x))
        (got, got_state), na = counted(
            lambda: entered_step(attached, state, n, x))
        assert na == nl, (label, branch, na, nl)
        if kind == "export":
            diff = max(close(got, want, 1e-6, f"{label} {branch}"),
                       close(got_state, want_state, 1e-6,
                             f"{label} {branch} state"))
        else:
            px, sc = check_against_cpu(
                got, type(want)(*(f.cpu() for f in want)), (540, 360))
            roi_px, roi_rad = next_rois(got_state, want_state,
                                        f"{label} {branch} state")
            diff = {"px": px, "score": sc, "next_roi_px": roi_px,
                    "next_roi_rad": roi_rad}
        entered(attached, state, n)
        force = tracking._force_flags(x.device)[attached.next_step_forced]
        loaded = prog(x, *state, force)
        close(loaded[0], got, 0.0, f"{label} {branch} load")
        close(loaded[1], got_state, 0.0, f"{label} {branch} load state")
        print(f"aot {label} ({kind}) {branch}: vs live {diff}, launches "
              f"{({k: v for k, v in na.items() if v})}", flush=True)


def aot_executable(label, make, frames, want, export_path, compiled):
    """Take ``make()``'s program at ``frames``' geometry as an executable
    (``kind="executable"``: an AOTInductor package compiled on the card;
    ``compiled`` its path, from ``compile_executables``), attach it to a
    fresh ``make()`` and hold one call against the live object: the same
    counted launches (``want``) per call, so the package launches the
    hand-written kernels; within the cascade contract (f32 0.25 px /
    1e-3, bf16 nets the BF16_* criteria) and, on the rotated 540p frames,
    their ground truth; a call on a side stream equal to the default
    stream's.  Prints the largest differences against live and against
    the export artifact at ``export_path``."""
    live_obj = make()
    bf16 = live_obj.compute_dtype == torch.bfloat16
    live, n = counted(lambda: live_obj(frames))
    assert n == want, (label, "live", n, want)
    b = frames.shape[0]
    planar = live_obj._layout == "planar"
    h, w = frames.shape[2:] if planar else frames.shape[1:3]
    served = make()
    prog = aot.attach(served, compiled)
    assert prog.meta["kind"] == "executable", prog.meta
    out, n = counted(lambda: served(frames))
    assert n == want, (label, "executable", n, want)
    px, sc = check_against_cpu(out, type(live)(*(f.cpu() for f in live)),
                               (w, h), bf16)
    if not planar:              # the rotated 540p frames, tiled
        for i in range(b):
            check_gt(out, i, GT[FRAMES_540[i % len(FRAMES_540)]],
                     BF16_ROT_TOL if bf16 else ROT_TOL)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        again = served(frames)
    torch.cuda.current_stream().wait_stream(side)
    close(again, out, 0.0, f"{label} side stream")
    exported = make()
    aot.attach(exported, export_path)
    vs_export = close(out, exported(frames), math.inf, f"{label} export")
    print(f"aot executable {label}: vs live {px:.4f} px, scores {sc:.2e}, "
          f"max |diff| {close(out, live, math.inf, label):.3g} (vs export "
          f"{vs_export:.3g}); launches per call "
          f"{({k: v for k, v in want.items() if v})}", flush=True)


def compile_one(label, batch, height, width):
    """The child of ``compile_executables``: save the program ``label``
    names (a cascade of ``cascade_makers`` or a tracker of ``TRACKERS``)
    at the geometry given as an executable in AOT_DIR.  Returns the exit
    code."""
    make = {**cascade_makers(), **TRACKERS}[label]
    with eager_calls():
        aot.save(make(), AOT_DIR / f"{label}.exe.aot", batch=batch,
                 height=height, width=width, kind="executable")
    return 0


def compile_executables(geometry):
    """Compile each program of ``geometry`` ({label: (batch, height,
    width)}) as an executable, one child process of this script each
    (``--compile-executable``), all started together: each compile is
    mostly one process's host work, one to three minutes on the card's
    host, so together they take less than one after another.
    Each child's output goes to AOT_DIR/<label>.compile.log; a child
    that fails or outlasts COMPILE_TIMEOUT_S raises, and every child is
    stopped.  Returns {label: path}."""
    t0 = time.perf_counter()
    procs, logs = {}, {}
    try:
        for label, (b, h, w) in geometry.items():
            logs[label] = open(AOT_DIR / f"{label}.compile.log", "w")
            procs[label] = subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--compile-executable", label, str(b), str(h), str(w)],
                stdout=logs[label], stderr=subprocess.STDOUT, cwd=ROOT)
        for label, proc in procs.items():
            left = COMPILE_TIMEOUT_S - (time.perf_counter() - t0)
            rc = proc.wait(timeout=max(left, 1.0))
            if rc != 0:
                tail = (AOT_DIR / f"{label}.compile.log").read_text()[-6000:]
                raise RuntimeError(f"compiling {label} exited {rc}:\n{tail}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs.values():
            log.close()
    return {label: AOT_DIR / f"{label}.exe.aot" for label in geometry}


COMPILE_TIMEOUT_S = 600


def phase_aot_executable(cases):
    """The serving programs as executables on the card, the counts set to
    0 before and read after: the three FaceCascade cases of ``aot_cases``
    (f32 and bf16 at 540x360 batch 8, f32 at 1920x1080 planar batch 4)
    and the FaceTracker step program at 8 streams of 540x360, compiled
    together (``compile_executables``); each cascade attached and held
    against the live object by ``aot_executable``; the tracker's step in
    every branch (``aot_tracker``: the cascade contract on the result
    and the next ROIs, launches and lock states equal).  Left out, to keep
    the script within its time limit: the EmbedCascade and
    MultiFaceTracker executables, which tests/test_torch_aot_executable.py
    compiles and checks on the CPU (its ``slow`` tests).  Returns the
    launches."""
    phase("aot_executable")
    geometry = {}
    for label, (_, x, _) in cases.items():
        h, w = x.shape[2:] if "planar" in label else x.shape[1:3]
        geometry[label] = (x.shape[0], h, w)
    geometry["face_tracker"] = (8, 360, 540)
    compiled = compile_executables(geometry)
    reset_counts()
    for label, (make, x, want) in cases.items():
        aot_executable(label, make, x, want, AOT_DIR / f"{label}.aot",
                       compiled[label])
    track = load_image(ROT / TRACK_SEQ[2])
    x = torch.from_numpy(np.stack([np.roll(track, 4 * s, axis=1)
                                   for s in range(8)])).cuda()
    aot_tracker("face_tracker", TRACKERS["face_tracker"], x,
                compiled["face_tracker"])
    launches = launch_counts()
    print(f"launches of the executables' path: {launches}", flush=True)
    for p in AOT_DIR.glob("*.aot"):
        p.unlink()
    return launches


def phase_sharded():
    """Batch data parallelism on the card, the counts set to 0 before and
    read after: infer_sharded of FaceCascade() over data_parallel_mesh()
    (every visible card) and over [cuda:0, cuda:0] (two shards on one
    card) on the 540x360 batch of 64, against the unsharded call (within
    2e-3, flags equal; 2 warp and the detector's fused launches per
    shard); then track_sharded of FaceTracker() over both meshes, 8
    streams over three steps (full, locked, repair: stream 2 blanked, on
    the second shard of two), against the unsharded tracker step by step;
    then FaceTracker and MultiFaceTracker (K=2) with repair_batch=2 over
    [cuda:0, cuda:0] in every branch (``branch_cases``), each entered
    with the same state as the unsharded tracker, after a first step that
    captures the shards' programs, under
    ``torch.cuda.set_sync_debug_mode("error")`` (no host read), each
    within 2e-3 of the unsharded step with the flags and lock states
    equal.  The trackers run their cached programs
    (``eager_calls(False)``).  Returns the launches."""
    phase("sharded")
    meshes = {"visible": data_parallel_mesh(),
              "cuda0_x2": data_parallel_mesh(["cuda:0", "cuda:0"])}
    print(f"data_parallel_mesh(): {len(meshes['visible'])} device(s) "
          f"{[str(d) for d in meshes['visible']]}", flush=True)
    four = np.stack([load_image(ROT / n) for n in FRAMES_540])
    b = BATCH["540p"]
    batch = torch.from_numpy(np.tile(four, (b // 4, 1, 1, 1))).cuda()
    cascade = FaceCascade()
    fused = cascade._det_net.fused_launches()
    chained = cascade_epilogues(cascade)
    track = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    steps = [torch.from_numpy(tracker_frames(track, i, 8,
                                             (2,) if i == 2 else ())).cuda()
             for i in range(3)]
    reset_counts()
    ref = cascade(batch)
    for label, mesh in meshes.items():
        out, n = counted(lambda: infer_sharded(cascade, batch, mesh))
        assert n == only(warp_bilinear=2 * len(mesh),
                         fused_dw_pw_block_f32=fused * len(mesh),
                         conv_epilogue=chained * len(mesh)), (label, n)
        diff = close(out, ref, SHARD_TOL, f"infer_sharded {label}")
        single, sharded = tracking.FaceTracker(), tracking.FaceTracker()
        worst = 0.0
        with eager_calls(False):
            for i, x in enumerate(steps):
                ru = single.step(x)
                rs = track_sharded(sharded, x, mesh)
                worst = max(worst, close(rs, ru, SHARD_TOL,
                                         f"track_sharded {label} step {i}"))
                assert (sharded.tracking == single.tracking).all(), (label, i)
        assert list(sharded.tracking) == [True, True, False] + [True] * 5
        print(f"infer_sharded over {[str(d) for d in mesh]}: vs unsharded "
              f"max |diff| {diff:.3g}; track_sharded 3 steps (full, "
              f"locked, repair) max |diff| {worst:.3g}", flush=True)

    # every branch over two shards, after the shards' programs are
    # captured: no host read
    mesh = meshes["cuda0_x2"]
    x = torch.from_numpy(np.stack([np.roll(track[TRACK_SEQ[2]], 4 * s,
                                           axis=1)
                                   for s in range(8)])).cuda()
    blank = x.clone()
    blank[2] = 0
    with eager_calls(False):
        for label, make in TRACKERS.items():
            single, sharded = make(), make()
            track_sharded(sharded, x, mesh)
            for branch, (frames, state, n) in branch_cases(
                    single, x, blank).items():
                want, want_state = entered_step(single, state, n, frames)

                def step():
                    sharded._shards = None
                    entered(sharded, state, n)
                    sharded._state_hw = tuple(frames.shape[1:3])
                    return track_sharded(sharded, frames, mesh)

                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    got = step()
                    got_state = sharded._held_state()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                diff = max(close(got, want, SHARD_TOL,
                                 f"track_sharded {label} {branch}"),
                           close(got_state, want_state, SHARD_TOL,
                                 f"track_sharded {label} {branch} state"))
                print(f"track_sharded {label} over {[str(d) for d in mesh]}"
                      f" {branch}: no host read; vs unsharded max |diff| "
                      f"{diff:.3g}", flush=True)
            assert [k[0] for k in sharded.cascade._cache.entries] == [
                "shard_stage", "shard_finish"], label
    launches = launch_counts()
    print(f"launches of the sharded path: {launches}", flush=True)
    return launches


def phase_strip_dma(rng):
    """K5's A/B configuration, as tools/tpu_strip_dma_probe.py runs it on
    the TPU: batch 64 of 1920x1080 bf16 planes (canvas (a), each frame
    rolled along x by up to 99 px), one 192x192 mesh grid per frame from
    a seeded ROI (centre 960+-200, 540+-100, sides 350-640 px, rotation
    +-0.3 rad).  The gather strip kernel and the staged kernel with one
    fused copy and with three per-channel copies, once each with the
    counts set to 0 before (this path's launches): the staged outputs
    bit-exact with the gather's, which is within KERNEL_TOL of the plain
    version, and both variants counting the same windows.  Returns
    (launches, the max abs error)."""
    phase("strip_dma")
    b = BATCH["strip_dma"]
    canvas = canvas_1080p(load_image)
    frames = np.stack([np.roll(canvas, int(rng.integers(-99, 99)), axis=1)
                       for _ in range(b)])
    planes = warp.make_planes(torch.from_numpy(frames).cuda(),
                              dtype=torch.bfloat16)
    rois = np.stack([np.array(
        [960 + rng.integers(-200, 200), 540 + rng.integers(-100, 100),
         rng.integers(350, 640), rng.integers(350, 640),
         rng.uniform(-0.3, 0.3)], np.float32) for _ in range(b)])
    with torch.inference_mode():
        gx, gy, _ = image_ops._source_coords(
            torch.from_numpy(rois).cuda(), (192, 192), False, False)
    xs, ys = flat([(gx, gy)])
    sx, sy = stacked([(gx, gy)])
    reset_counts()
    gather = warp.warp_bilinear_strips(planes, xs, ys)
    staged = {copies: warp.warp_bilinear_strips_staged(planes, sx, sy, copies)
              for copies in ("fused", "split")}
    torch.cuda.synchronize()
    launches = launch_counts()
    assert launches == only(warp_bilinear_strips=1,
                            warp_strips_staged_fused=1,
                            warp_strips_staged_split=1), launches
    for copies, out in staged.items():
        assert torch.equal(out, gather), copies
    err = float((gather - warp.warp_bilinear_strips_plain(planes, xs, ys))
                .abs().max())
    assert err <= KERNEL_TOL, err
    counts = {copies: staged_stats(planes, sx, sy, copies)[2:]
              for copies in ("fused", "split")}
    assert counts["fused"] == counts["split"], counts
    copied, over = counts["fused"]
    print(f"strip_dma b{b}: both staged variants bit-exact with the gather, "
          f"max abs err {err:.3g}; {over} of {staged_blocks(sx)} blocks over "
          f"the window budget, the windows copied {copied} bytes (counted "
          f"by the kernel)", flush=True)
    return launches, err


def check_back_net(cascade, batch, size, per_op, tol):
    """The cascade's detector net on this batch's detection input with
    the residual runs on the fused kernel and op by op (``per_op``): the
    two nets' outputs agree within ``tol`` relative to the raw outputs
    (which reach ~1e4: the score logits).  Returns the difference."""
    with torch.inference_mode(), exact_f32():
        planes = cascade._prepare_frame(batch, size)
        dx, dy, _ = cascade._whole_frame_coords(size)
        det_in = image_ops._normalize_pixels(
            image_ops.separable_sample_planar(planes, dx, dy), (-1.0, 1.0),
            True)
        err = max(float((a - b).abs().max()) / max(1.0, float(
            b.abs().max())) for a, b in zip(cascade._det_net(det_in),
                                            per_op(det_in)))
    assert err <= tol, err
    return err


def check_batch(cascade, batch, launches):
    """One call of ``cascade`` (a FaceCascade or an EmbedCascade) on
    ``batch``: its launches ``launches``, and a valid face, with a valid
    mesh where there is one, in every frame."""
    res, n = counted(lambda: cascade(batch))
    assert n == launches, (n, launches)
    valid = int(getattr(res, "mesh_valid", res.face_valid).sum())
    assert valid == batch.shape[0], f"{valid} of {batch.shape[0]} faces"


def kernel_err(kernel, plain, planes, calls):
    """The largest difference of ``kernel(planes, *args)`` from
    ``plain(planes, *args)`` over each ``args`` of ``calls``, within
    KERNEL_TOL."""
    err = max(float((kernel(planes, *args) - plain(planes, *args))
                    .abs().max()) for args in calls)
    assert err <= KERNEL_TOL, err
    return err


def phase_batches(rng):
    """The main path's kernels and cascades at the batches of the bench's
    rows, each call's launches counted: K1 against its plain version on
    the grids of a FaceCascade call over 32 540x360 frames and K2 on those
    of a planar call over 64 1920x1080 frames; FaceCascade with bf16 nets
    at 540x360 batch 64, and planar at 1920x1080 batch 64 and 3840x2160
    batch 8 with f32 and with bf16 nets (``check_batch``); the BACK
    detector at 540x360 batch 64 with its residual runs on the fused
    kernel and op by op, f32 within BLOCK_TOL_F32 and bf16 within
    BLOCK_TOL_BF16.  Returns the max abs errors {kernel: err}."""
    phase("batches")
    errs = {}
    frames = np.stack([load_image(ROT / n) for n in FRAMES_540])
    size = (540, 360)
    bf16 = torch.bfloat16
    cascade = FaceCascade()
    cascade16 = FaceCascade(compute_dtype=bf16)
    fused = cascade._det_net.fused_launches()
    fused16 = cascade16._det_net.fused_launches()
    chained = cascade_epilogues(cascade)

    b = BATCH["warp_540p"]
    planes, grids = stage_coords(
        cascade,
        torch.from_numpy(np.tile(frames, (b // 4, 1, 1, 1))).cuda(), size)
    errs["warp_bilinear"] = kernel_err(
        warp.warp_bilinear_segments, warp.warp_bilinear_segments_plain,
        planes, [([(x, y, x.shape[-1]) for x, y in g],) for g in grids])
    print(f"warp_bilinear_segments on the cascade's grids at 540x360 b{b}: "
          f"max abs err {errs['warp_bilinear']:.3g}", flush=True)

    b = BATCH["540p"]
    batch = torch.from_numpy(np.tile(frames, (b // 4, 1, 1, 1))).cuda()
    check_batch(cascade16, batch,
                only(warp_bilinear=2, fused_dw_pw_block_bf16=fused16))
    for net, dtype, tol in ((cascade, torch.float32, BLOCK_TOL_F32),
                            (cascade16, bf16, BLOCK_TOL_BF16)):
        err = check_back_net(net, batch, size,
                             back_net(fuse_blocks=False, dtype=dtype), tol)
        print(f"BACK net {str(dtype)[6:]} 540x360 b{b}: fused vs op by op "
              f"{err:.3g} of the outputs' magnitude (tolerance {tol:g})",
              flush=True)
    del batch, planes, grids

    planar = FaceCascade(input_layout="planar")
    planar16 = FaceCascade(input_layout="planar", compute_dtype=bf16)
    for label, canvas, b in (
            ("1080p", canvas_1080p(load_image), BATCH["1080p"]),
            ("4k", canvas_1080p(load_image, 4, (3840, 2160)),
             BATCH["4k"])):
        hbatch = hires_batch(canvas, b, rng)
        check_batch(planar, hbatch,
                    only(warp_bilinear_strips=2, fused_dw_pw_block_f32=fused,
                         conv_epilogue=chained))
        check_batch(planar16, hbatch,
                    only(warp_bilinear_strips=2,
                         fused_dw_pw_block_bf16=fused16))
        if label == "1080p":
            planes, grids = stage_coords(planar, hbatch,
                                         (canvas.shape[1], canvas.shape[0]))
            errs["warp_bilinear_strips"] = kernel_err(
                warp.warp_bilinear_strips, warp.warp_bilinear_strips_plain,
                planes, [flat(g) for g in grids])
            print(f"warp_bilinear_strips on the cascade's grids at {label} "
                  f"b{b}: max abs err {errs['warp_bilinear_strips']:.3g}",
                  flush=True)
            del planes, grids
        print(f"FaceCascade planar {label} b{b}, f32 and bf16: each call's "
              f"launches, a face in every frame", flush=True)
        del hbatch
    return errs


# python -m tpu_face_torch.bench's arguments in the bench phase: its
# rows at batch 64, the shortest windows it takes (every row on, hires
# included)
BENCH_ARGS = ["--batch", "64", "--iters", "1", "--warmup", "0",
              "--repeats", "1"]


def phase_bench(smi):
    """``tpu_face_torch.bench.main`` in this process with f32 and then
    bf16 nets (BENCH_ARGS), the counts set to 0 before and read after:
    each run's gate passed in its type, every row of ``bench.ROWS``
    present and positive (``p50_aot_b8_ms`` through an executable), the
    record naming this card.  Returns the launches."""
    phase("bench")
    reset_counts()
    for dtype in ("f32", "bf16"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = bench.main(BENCH_ARGS + ["--dtype", dtype])
        record = json.loads(out.getvalue().strip().splitlines()[-1])
        assert rc == 0 and record["gate_dtype"] == dtype, (rc, record)
        assert record["gate_iou"] >= bench.GATE_IOU, record
        bad = [row for row in bench.ROWS
               if not isinstance(record.get(row), (int, float))
               or not record[row] > 0]
        assert not bad, (dtype, bad, record)
        assert record["aot_kind"] == "executable", record
        assert record["device"]["kind"] == torch.cuda.get_device_name(0)
        assert record["device"]["nvidia_smi"] in smi, (record, smi)
        print(f"bench {dtype}: {json.dumps(record)}", flush=True)
    launches = launch_counts()
    print(f"launches of the bench: {launches}", flush=True)
    return launches


# ---- the cached programs (tpu_face_torch.programs) ---------------------


EAGER = False      # inside eager_calls


@contextlib.contextmanager
def eager_calls(eager=True):
    """Inside the block the objects' calls run their eager functions
    (``_forward``, the trackers' and the models' passes) and not the
    CUDA graphs their program caches hold: for the phases that count
    each call's kernel launches, which a graph replay does not make.
    ``eager_calls(False)`` turns the caches back on inside such a
    block."""
    global EAGER
    saved = (programs.ProgramCache.__call__, EAGER)
    programs.ProgramCache.__call__ = (
        (lambda self, name, fn, *inputs: fn(*inputs)) if eager
        else CACHED_CALL)
    EAGER = eager
    try:
        yield
    finally:
        programs.ProgramCache.__call__, EAGER = saved


def capture_runs():
    """The eager runs of a program's function in its first call: the
    warm-ups and the capture (one where ``eager_calls`` is on)."""
    return 1 if EAGER else programs.WARMUPS + 1


def result_arrays(out):
    """The numbers of a call's result as a flat list of CPU tensors (a
    NamedTuple of tensors, numpy arrays, lists of ``Detection``)."""
    if isinstance(out, torch.Tensor):
        return [out.cpu()]
    if isinstance(out, np.ndarray):
        return [torch.from_numpy(out)]
    if hasattr(out, "data") and hasattr(out, "score"):      # Detection
        return [torch.from_numpy(out.data), torch.tensor(out.score)]
    return [t for part in out for t in result_arrays(part)]


def hold_cached(label, got, want, size=None, bf16=False, tol=0.0):
    """A cached call's result against the eager call's on the same input:
    bit-identical, or else equal bools and a CascadeResult within the
    cascade contract (``check_against_cpu``: f32 0.25 px / 1e-3, bf16 nets
    the BF16_* criteria), anything else within ``tol``.  Prints which and
    returns the largest difference."""
    a, b = result_arrays(got), result_arrays(want)
    assert [(t.shape, t.dtype) for t in a] == [(t.shape, t.dtype)
                                               for t in b], label
    if all(torch.equal(x, y) for x, y in zip(a, b)):
        print(f"{label}: cached vs eager bit-identical", flush=True)
        return 0.0
    worst = 0.0
    for x, y in zip(a, b):
        if x.dtype == torch.bool:
            assert torch.equal(x, y), label
        else:
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    if hasattr(got, "mesh"):
        check_against_cpu(got, type(want)(*(f.cpu() for f in want)), size,
                          bf16)
    else:
        assert worst <= tol, (label, worst, tol)
    print(f"{label}: cached vs eager max |diff| {worst:.3e} (within the "
          f"contract)", flush=True)
    return worst


def eager_forward(obj, frames):
    """``obj``'s eager ``_forward`` on ``frames``, as ``__call__`` runs it."""
    planar = obj._layout == "planar"
    h, w = frames.shape[2:] if planar else frames.shape[1:3]
    with torch.inference_mode(), exact_f32():
        return obj._forward(frames, (w, h))


def hold_steps(label, tracker, steps, size):
    """Each frame batch of ``steps`` through ``tracker``'s cached step and,
    from the same state, its eager step (``eager_calls``); the cached
    step's state goes on.  Returns the worst difference."""
    worst = 0.0
    for i, frames in enumerate(steps):
        before = (tracker._state, tracker._state_hw, tracker._steps)
        with eager_calls():
            want = tracker.step(frames)
            want_lock = tracker.tracking
        tracker._state, tracker._state_hw, tracker._steps = before
        got = tracker.step(frames)
        assert (tracker.tracking == want_lock).all(), (label, i)
        worst = max(worst, hold_cached(f"{label} step {i}", got, want,
                                       size))
    return worst


def replay_kernels(obj, frames):
    """torch.profiler over one cached call (a graph replay): {kernel
    name: launches} of what the device ran."""
    from torch.profiler import ProfilerActivity, profile
    obj(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        obj(frames)
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


# the 540x360 batches of the cached FaceCascade, each held against
# _forward
GRAPH_BATCHES = (1, 8, 64)
# the hand-written kernels' function names in csrc/, as the profiler
# lists them (a substring of the key)
KERNEL_FUNCS = {"warp_bilinear": "warp_bilinear_kernel",
                "warp_bilinear_strips": "warp_bilinear_strips_kernel",
                "fused_dw_pw_block_f32": "fused_blocks_kernel",
                "fused_dw_pw_block_bf16": "fused_blocks_bf16_kernel",
                # epilogue_kernel and epilogue_kernel_tiled
                "conv_epilogue": "epilogue_kernel"}


def kernels_in(names):
    """{kernels line entry: launches} of the hand-written kernels among
    a profile's {kernel name: launches}."""
    found = {k: sum(c for n, c in names.items() if func in n)
             for k, func in KERNEL_FUNCS.items()}
    return {k: c for k, c in found.items() if c}


def phase_graphs():
    """The cached programs on the card: each object's first call at a
    geometry captures a CUDA graph, every later call replays it.  Each
    cached path against the eager call on the same input; two geometries
    interleaved with a held result; the hand-written kernels found in the
    profiled replays.  Returns the launches."""
    phase("graphs")
    rot = {n: load_image(ROT / n) for n in GT}
    tile = np.stack([rot[n] for n in FRAMES_540])
    reset_counts()

    def frames540(b):
        return torch.from_numpy(np.tile(tile, (b // 4 or 1, 1, 1, 1))[:b]
                                ).cuda()

    # FaceCascade BACK at 540x360, each batch held against _forward
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        cascade = FaceCascade(compute_dtype=dt)
        for b in GRAPH_BATCHES:
            x = frames540(b)
            got = cascade(x)
            hold_cached(f"FaceCascade {name} 540x360 b{b}", got,
                        eager_forward(cascade, x), (540, 360),
                        dt == torch.bfloat16)
        if dt == torch.float32:
            f32_cascade = cascade

    # two geometries interleaved (540x360 b8, the 704x704 close-up b1),
    # a held result unchanged by the next calls
    cascade = f32_cascade
    a1, a2 = frames540(8), frames540(8).flip(0).contiguous()
    close_up = torch.from_numpy(rot["man_closeup_rotp30.png"][None].copy()
                                ).cuda()
    first = cascade(a1)
    held = [f.clone() for f in first]
    other = cascade(close_up)
    again = cascade(a2)
    for f, h in zip(first, held):
        assert torch.equal(f, h), "a held result changed"
    hold_cached("interleaved B (704x704 b1)", other,
                eager_forward(cascade, close_up), (704, 704))
    hold_cached("interleaved A again (540x360 b8, other frames)", again,
                eager_forward(cascade, a2), (540, 360))

    # planar 1080p b64 (the strip kernel), FULL_SPARSE K=4 on canvas (c)
    # b32, EmbedCascade f32 b8
    rng = np.random.default_rng(1)
    hires = hires_batch(canvas_1080p(load_image), BATCH["1080p"], rng)
    planar = FaceCascade(input_layout="planar")
    hold_cached(f"FaceCascade f32 1920x1080 planar b{BATCH['1080p']}",
                planar(hires), eager_forward(planar, hires), (1920, 1080))
    grid = torch.from_numpy(np.stack([canvas_grid(load_image)]
                                     * BATCH["k4"])).cuda()
    sparse = FaceCascade(tmodels.FaceDetectionModel.FULL_SPARSE,
                         max_faces=4)
    hold_cached(f"FaceCascade FULL_SPARSE K=4 1080x720 b{BATCH['k4']}",
                sparse(grid), eager_forward(sparse, grid), (1080, 720))
    embed = EmbedCascade(embed_model_path=str(DATA_DIR / "demo"))
    x8 = frames540(8)
    hold_cached("EmbedCascade f32 540x360 b8", embed(x8),
                eager_forward(embed, x8), tol=EMBED_TOL)

    # the trackers: 8 streams, a forced redetect every third step, a
    # two-stream repair (stream 2 blanked at step 2)
    seq = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    steps = [tracker_frames(seq, i, 8, (2,) if i == 2 else ())
             for i in range(5)]
    for label, tracker in (
            ("FaceTracker", tracking.FaceTracker(redetect_every=3,
                                                 repair_batch=2)),
            ("MultiFaceTracker K=2", tracking.MultiFaceTracker(
                max_faces=2, redetect_every=3, repair_batch=2))):
        hold_steps(label, tracker, steps, (540, 360))
        cache = tracker.cascade._cache
        assert [(k[0], k[1][0][0]) for k in cache.entries] == [
            ("step", 8)], list(cache.entries)

    # the four models' infer_batch, cached against eager
    models = {"FaceDetection": tmodels.FaceDetection(
                  tmodels.FaceDetectionModel.BACK_CAMERA),
              "FaceLandmark": tmodels.FaceLandmark(),
              "IrisLandmark": tmodels.IrisLandmark(),
              "FaceEmbeddings": tmodels.FaceEmbeddings(
                  str(DATA_DIR / "demo"))}
    roi = Rect(0.47, 0.41, 0.4, 0.6, 0.2, normalized=True)
    eye = Rect(0.42, 0.33, 0.08, 0.08, 0.1, normalized=True)
    n8 = x8.cpu().numpy()
    calls = {"FaceDetection": lambda m: m.infer_batch(n8),
             "FaceLandmark": lambda m: m.infer_batch(n8, [roi] * 8),
             "IrisLandmark": lambda m: m.infer_batch(
                 n8, [eye] * 8, [i % 2 == 1 for i in range(8)]),
             "FaceEmbeddings": lambda m: m.infer_batch(
                 n8, [(180, 80, 320, 215)] * 8)}
    for label, model in models.items():
        got = calls[label](model)
        with eager_calls():
            want = calls[label](model)
        hold_cached(f"{label}.infer_batch 540x360 b8", got, want,
                    tol=EMBED_TOL if label == "FaceEmbeddings" else MODEL_TOL)
        assert len(model._cache.entries) == 1, label
    launches = launch_counts()
    print(f"launches of the graphs phase (the warm-ups and captures of "
          f"each first call; a replay makes no wrapper call): {launches}",
          flush=True)

    # the kernels in one profiled replay per type and frame tier
    for label, obj, x, want in (
            ("f32_540p_b8", f32_cascade, x8,
             {"warp_bilinear", "fused_dw_pw_block_f32", "conv_epilogue"}),
            ("bf16_540p_b8", FaceCascade(compute_dtype=torch.bfloat16), x8,
             {"warp_bilinear", "fused_dw_pw_block_bf16"}),
            ("f32_1080p_b64", planar, hires,
             {"warp_bilinear_strips", "conv_epilogue"})):
        names = replay_kernels(obj, x)
        found = kernels_in(names)
        assert want <= set(found), (label, want, sorted(names))
        # one epilogue launch a chain of the f32 nets, none in bf16
        assert found.get("conv_epilogue", 0) == cascade_epilogues(obj), (
            label, found)
        print(f"replay {label}: {sum(names.values())} kernel launches "
              f"({len(names)} kernels by name), the hand-written ones "
              f"{found}", flush=True)
    return launches


# ---- each tracker step as one program (programs.cond) -----------------


def host_step(tracker, frames):
    """One step of ``tracker`` with its decisions taken on the host: its
    ``_step_fn`` called eagerly, each cond reading its predicate (the
    step an eager call on the card takes)."""
    images, hw = tracker._frames(frames)
    if tracker._fresh(images.shape[0], hw):
        tracker._state = tracker._empty_state(images.shape[0])
    force = tracking._force_flags(tracker.device)[tracker.next_step_forced]
    with torch.inference_mode(), exact_f32():
        res, tracker._state = tracker._step_fn(images, *tracker._state,
                                               force, (hw[1], hw[0]))
    tracker._steps += 1
    return res


def entered(tracker, state, steps):
    """``tracker`` set to enter its next step with ``state`` after
    ``steps`` steps (the redetect schedule reads the count)."""
    tracker._state, tracker._steps = state, steps


def same_step(label, tracker, frames):
    """``frames`` through the step program and, from the same state, the
    host-branch step: the results and the next states bit-identical.
    Returns the program's result; the program's state goes on."""
    before = (tracker._state, tracker._steps)
    want = host_step(tracker, frames)
    want_state = tracker._state
    entered(tracker, *before)
    got = tracker.step(frames)
    for a, b in zip(result_arrays((got, tracker._state)),
                    result_arrays((want, want_state))):
        # bit-identical, NaN where the other has NaN (an empty slot's
        # mesh may be NaN on both)
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                   msg=label)
    return got


def nested_cond():
    """``programs.cond`` nested on the card: a captured program of two
    conds, a cuBLAS matmul and an inner cond in one branch and a cuDNN
    convolution in the other, bit-identical with the eager call for each
    pair of predicates."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(64, 64, device="cuda", generator=gen)
    w = torch.randn(1, 1, 3, 3, device="cuda", generator=gen)

    def fn(x, p, q):
        def matmul(x):
            return programs.cond(q, lambda y: (y * 2,), lambda y: (y - 1,),
                                 (x @ x,))

        def conv(x):
            return (torch.nn.functional.conv2d(x[None, None], w,
                                               padding=1)[0, 0],)
        return programs.cond(p, matmul, conv, (x,))

    flags = tracking._force_flags(x.device)
    prog = programs.Program(fn, [x, flags[1], flags[1]], x.device)
    for p, q in itertools.product(flags, flags):
        with torch.inference_mode(), exact_f32():
            assert torch.equal(prog(x, p, q)[0], fn(x, p, q)[0]), (p, q)
    print("nested cond: each pair of predicates bit-identical with the "
          "eager call", flush=True)


def branch_cases(tracker, frames, blank):
    """{branch: (frames, state, steps)} entering each decision of a step
    of ``tracker`` (redetect_every=3, repair_batch=2): every stream
    locked (locked), stream 2 black (repair), the redetect due (forced),
    three streams unlocked (mass loss).  The locked state is the one the
    first step leaves."""
    tracker.reset()
    tracker.step(frames)
    locked = tracker._state
    field = "locked" if hasattr(locked, "locked") else "valid"
    flags = getattr(locked, field).clone()
    flags[:3] = False
    return {"locked": (frames, locked, 1), "repair": (blank, locked, 1),
            "forced": (frames, locked, 3),
            "mass_loss": (frames, locked._replace(**{field: flags}), 1)}


def step_kernels(fn, label, calls=2):
    """{kernel name: launches per call} of ``fn`` from torch.profiler over
    ``calls`` back-to-back calls (each hand-written kernel's count a
    multiple of ``calls``)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA)
    odd = kernels_in({n: c for n, c in names.items() if c % calls})
    assert not odd, (label, calls, odd)
    return {n: c // calls for n, c in names.items()}


# the replayed step's hand-written kernels by branch, beside the
# detector's fused launches (13 f32, 8 bf16): a locked step runs the
# tracked stages only, a repair step those and the cascade on the repair
# batch, the full path the cascade on every stream
STEP_KERNELS = {"locked": (2, False), "repair": (4, True),
                "forced": (2, True), "mass_loss": (2, True)}
STEP_SEQ = [()] * 2 + [(2,), (), (1, 3, 5), ()] + [()] * 3 + [(0,), (), ()]


def phase_tracker_program():
    """Each tracker step as one captured program (``programs.cond``):
    FaceTracker and MultiFaceTracker K=2, f32 and bf16, 540x360, the
    counts set to 0 before and read after.  At 8 streams the sequence of
    == graphs (a redetect every third step, a two-stream repair, stream
    2 blanked at step 2), each step bit-identical with the host-branch
    step entered with the same state; one step entry per tracker.  Then,
    at 8 and 64 streams, each branch (locked, repair, forced, mass loss)
    entered from the same state through both steps, bit-identical; at 8
    streams two profiled replays of each branch, its warp, epilogue and
    fused launches checked (STEP_KERNELS).  Then 12 steps over every
    branch with OneEuro smoothing and ``dt``, after their capture, under
    ``torch.cuda.set_sync_debug_mode("error")``.  Returns the
    launches."""
    phase("tracker_program")
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"driver {driver}, torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)
    nested_cond()
    seq = {n: load_image(ROT / n) for n in set(TRACK_SEQ)}
    steps = [tracker_frames(seq, i, 8, (2,) if i == 2 else ())
             for i in range(5)]
    f32 = torch.float32
    kinds = {"FaceTracker": lambda **kw: tracking.FaceTracker(**kw),
             "MultiFaceTracker K=2": lambda **kw: tracking.MultiFaceTracker(
                 max_faces=2, **kw)}
    reset_counts()
    for (kind, make), dt in itertools.product(kinds.items(),
                                              (f32, torch.bfloat16)):
        name = str(dt)[6:]
        fused = "fused_dw_pw_block_" + ("f32" if dt == f32 else "bf16")
        for b in (8, BATCH["track"]):
            tracker = make(compute_dtype=dt, redetect_every=3,
                           repair_batch=2)
            label = f"{kind} {name} b{b}"
            if b == 8:
                for i, x in enumerate(steps):
                    same_step(f"{label} step {i}", tracker, x)
            frames = torch.from_numpy(np.stack(
                [np.roll(seq[TRACK_SEQ[2]], 4 * s, axis=1)
                 for s in range(b)])).cuda()
            blank = frames.clone()
            blank[2] = 0
            for branch, (x, state, n) in branch_cases(
                    tracker, frames, blank).items():
                entered(tracker, state, n)
                same_step(f"{label} {branch}", tracker, x)

                if b == 8:
                    def program():
                        entered(tracker, state, n)
                        tracker.step(x)

                    names = step_kernels(program, f"{label} {branch}")
                    found = kernels_in(names)
                    warps, detector = STEP_KERNELS[branch]
                    assert found.get("warp_bilinear") == warps, (
                        label, branch, found)
                    # the mesh and iris nets once per two warps, the
                    # detector where it runs
                    nets = tracker.cascade
                    chained = (warps // 2 * epilogues(nets._mesh_net,
                                                      nets._iris_net)
                               + detector * epilogues(nets._det_net))
                    assert found.get("conv_epilogue", 0) == chained, (
                        label, branch, found)
                    want = (tracker.cascade._det_net.fused_launches()
                            if detector else None)
                    assert found.get(fused) == want, (label, branch, found)
                    print(f"{label} {branch}: replay {found}", flush=True)
            entries = tracker.cascade._cache.entries
            steps_keyed = [k for k in entries if k[0] == "step"]
            assert len(steps_keyed) == 1 and steps_keyed[0][1][0][0] == b, \
                (label, list(entries))
            print(f"{label}: every branch bit-identical with the host-branch "
                  f"step; one step program", flush=True)
    launches = launch_counts()
    print(f"launches of the tracker_program phase (the warm-ups and "
          f"captures; a replay makes no wrapper call): {launches}",
          flush=True)

    # every branch after the capture: no synchronizing call
    batches = [torch.from_numpy(tracker_frames(seq, i % 5, 8, blank)).cuda()
               for i, blank in enumerate(STEP_SEQ)]
    for kind, make in kinds.items():
        tracker = make(redetect_every=6, repair_batch=2,
                       smoothing="one_euro")
        for x in batches:
            tracker.step(x, dt=1 / 30)
        tracker.reset()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i, x in enumerate(batches):
                res = tracker.step(x, dt=1 / 30 + i * 1e-3)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert torch.isfinite(res.mesh[res.mesh_valid]).all(), kind
        assert len(tracker.cascade._cache.entries) == 1, kind
        print(f"{kind}: {len(batches)} steps (full, locked, repair, "
              f"unrepaired, mass loss, forced) with OneEuro smoothing "
              f"under sync debug mode 'error': no synchronizing call",
              flush=True)
    return launches


# batch sizes of the phases' calls
BATCH = {"warp_540p": 32, "540p": 64, "1080p": 64, "4k": 8, "k4": 32,
         "fused": 64, "k3": 256, "strip_dma": 64, "track": 64}
# the kernel libraries, built from tpu_face_torch/csrc/<name>.cu
KERNELS = ("warp_bilinear", "warp_bilinear_strips", "fused_dw_pw_block",
           "fused_dw_pw_block_bf16", "warp_strips_staged", "graph_cond",
           "conv_epilogue", "conv3x3_tc", "fc_tc", "attention_tc")
# the kernels line's entries: (source, the Pallas kernel it replaces)
SOURCES = {
    "warp_bilinear": ("tpu_face_torch/csrc/warp_bilinear.cu",
                      "tpu_face/ops/pallas_warp.py:203"),
    "warp_bilinear_strips": ("tpu_face_torch/csrc/warp_bilinear_strips.cu",
                             "tpu_face/ops/pallas_warp.py:249"),
    "fused_dw_pw_block_f32": ("tpu_face_torch/csrc/fused_dw_pw_block.cu",
                              "docs/experiments/fused_block_prototype.py:46"),
    "fused_dw_pw_block_bf16": ("tpu_face_torch/csrc/fused_dw_pw_block_bf16.cu",
                               "docs/experiments/fused_block_v2.py:74"),
    "warp_strips_staged_fused": ("tpu_face_torch/csrc/warp_strips_staged.cu",
                                 "tpu_face/ops/pallas_warp.py:249"),
    "warp_strips_staged_split": ("tpu_face_torch/csrc/warp_strips_staged.cu",
                                 "tools/tpu_strip_dma_probe.py:59"),
    # no Pallas kernel: XLA fuses the bias, ADD and PReLU into the
    # convolution on the TPU
    "conv_epilogue": ("tpu_face_torch/csrc/conv_epilogue.cu",
                      "tpu_face/compiler/lowering.py:232"),
    # no Pallas kernel: XLA lowers the JAX package's convolutions
    # (lax.conv_general_dilated) onto the TPU's matrix unit
    "conv3x3_tc": ("tpu_face_torch/csrc/conv3x3_tc.cu",
                   "tpu_face/compiler/lowering.py:328"),
    # no Pallas kernel: XLA lowers the JAX package's FULLY_CONNECTED
    # (jnp.dot) onto the TPU's matrix unit
    "fc_tc": ("tpu_face_torch/csrc/fc_tc.cu",
              "tpu_face/compiler/lowering.py:396"),
    # no Pallas kernel: XLA fuses the JAX package's attention ops
    # (BATCH_MATMUL, the scale, bias and mask, SOFTMAX) on the TPU
    "attention_tc": ("tpu_face_torch/csrc/attention_tc.cu",
                     "tpu_face/compiler/lowering.py:401"),
}


def import_port():
    """The port's modules as this module's globals, once the repository
    is on sys.path (the helpers above use them)."""
    global _build, image_ops, warp, fused_block, ce, FaceCascade, exact_f32
    global load_image, tmodels, Graph, build_torch_fn, DATA_DIR
    global resolve_device, tracking, EmbedCascade, native_loader
    global geometry, l2_normalize, aot, data_parallel_mesh, infer_sharded
    global track_sharded, bench, programs, Rect, CACHED_CALL, ctc, ftc, atc
    sys.path.insert(0, str(ROOT))
    from tpu_face_torch import models as tmodels
    from tpu_face_torch import (aot, bench, programs, resolve_device,
                                tracking)
    from tpu_face_torch.compiler import Graph, build_torch_fn
    from tpu_face_torch.models.face_detection import _DATA_DIR as DATA_DIR
    from tpu_face_torch.models.face_embeddings import l2_normalize
    from tpu_face_torch.ops import _build, fused_block, geometry
    from tpu_face_torch.ops import conv_epilogue as ce
    from tpu_face_torch.ops import conv_tc as ctc
    from tpu_face_torch.ops import attention_tc as atc
    from tpu_face_torch.ops import fc_tc as ftc
    from tpu_face_torch.ops import image as image_ops
    from tpu_face_torch.ops import warp
    from tpu_face_torch.parallel import (data_parallel_mesh, infer_sharded,
                                         track_sharded)
    from tpu_face_torch.pipeline import (EmbedCascade, FaceCascade,
                                         exact_f32)
    from tpu_face_torch.types import Rect
    from tpu_face_torch.utils import native_loader
    from tpu_face_torch.utils.image_io import load_image
    CACHED_CALL = programs.ProgramCache.__call__


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--compile-executable", nargs=4,
                        metavar=("LABEL", "BATCH", "HEIGHT", "WIDTH"),
                        help="compile one program of == aot_executable "
                        "as an executable and exit (the phase starts "
                        "one such process per program)")
    args = parser.parse_args(argv)
    # end CUPTI's session with each profile: left subscribed, it kept
    # recording the later CUDA-graph replays (slowing their launches) and
    # gave their records to the next profile
    os.environ.setdefault("TEARDOWN_CUPTI", "1")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs a CUDA card", file=sys.stderr)
        return 1
    import_port()
    if args.compile_executable:
        label, *geometry = args.compile_executable
        return compile_one(label, *map(int, geometry))

    t_start = time.perf_counter()
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"nvidia-smi: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda}: {kind}, "
          f"{torch.cuda.device_count()} device(s)", flush=True)

    rng = np.random.default_rng(0)
    phase_build()
    errs = phase_kernels(rng)
    errs["attention_tc"] = phase_attention(rng)
    # the paths, each with the counts set to 0 before it and read after.
    # The cascades' main paths are the cached calls (their first call at
    # each geometry counted: the warm-ups and the capture); the phases
    # that check each call's launches run the eager calls (eager_calls),
    # and == graphs holds every cached path against them
    paths = {"cascade_f32": phase_cascade(),
             "cascade_bf16": phase_cascade(torch.bfloat16),
             "cascade_gather": phase_cascade_gather()}
    with eager_calls():
        models = {"f32": phase_models(),
                  "bf16": phase_models(torch.bfloat16)}
    paths["full_detectors"] = phase_full_detectors()
    paths["mxu"] = phase_mxu()
    paths["embed_r100"] = phase_embed_net(
        "iresnet", R100_SEED, R100_EMBED_TOL,
        {"conv3x3_tc": 98, "fc_tc": 0, "attention_tc": 0})
    paths["embed_vit"] = phase_embed_net(
        "vit", VIT_SEED, VIT_EMBED_TOL,
        {"conv3x3_tc": 0, "fc_tc": 144, "attention_tc": 24})
    paths["embed_swin"] = phase_embed_net(
        "swin", SWIN_SEED, SWIN_EMBED_TOL,
        {"conv3x3_tc": 0, "fc_tc": 137, "attention_tc": 24})
    with eager_calls():
        paths["tracker"] = phase_tracker()
        paths["embed"] = phase_embed()
        paths["aot"], aot_cascades = phase_aot()
        paths["aot_executable"] = phase_aot_executable(aot_cascades)
    paths["graphs"] = phase_graphs()
    paths["tracker_program"] = phase_tracker_program()
    with eager_calls():
        paths["sharded"] = phase_sharded()
    paths["strip_dma"], err = phase_strip_dma(rng)
    for name in ("warp_strips_staged_fused", "warp_strips_staged_split"):
        errs[name] = max(errs[name], err)
    with eager_calls():
        for name, err in phase_batches(rng).items():
            errs[name] = max(errs[name], err)
    paths["bench"] = phase_bench(smi)
    # the bf16 paths run the bf16 kernel and never the f32 one, and no
    # epilogue
    for counts in (paths["cascade_bf16"], models["bf16"]):
        assert counts["fused_dw_pw_block_f32"] == 0, counts
        assert counts["fused_dw_pw_block_bf16"] > 0, counts
        assert counts["conv_epilogue"] == 0, counts
    for name in ("warp_bilinear", "warp_bilinear_strips",
                 "fused_dw_pw_block_f32", "conv_epilogue"):
        assert models["f32"][name] > 0, (name, models["f32"])
        assert paths["tracker"][name] > 0, (name, paths["tracker"])
    # the step programs' captures launch the f32 and the bf16 path's
    # kernels
    for name in ("warp_bilinear", "fused_dw_pw_block_f32",
                 "fused_dw_pw_block_bf16", "conv_epilogue"):
        assert paths["tracker_program"][name] > 0, (name, paths)
    # the exported programs and the executables launch the five kernels
    # of the package's path
    for name in ("warp_bilinear", "warp_bilinear_strips",
                 "fused_dw_pw_block_f32", "fused_dw_pw_block_bf16",
                 "conv_epilogue"):
        for key in ("aot", "aot_executable"):
            assert paths[key][name] > 0, (name, key, paths[key])
    # the full-range nets have no fused run; mxu launches no warp kernel
    full = paths["full_detectors"]
    assert full == only(warp_bilinear=full["warp_bilinear"],
                        conv_epilogue=full["conv_epilogue"]), paths
    assert paths["mxu"] == only(
        fused_dw_pw_block_f32=paths["mxu"]["fused_dw_pw_block_f32"],
        conv_epilogue=paths["mxu"]["conv_epilogue"]), paths
    # identification: the detector's fused kernels and the f32 nets'
    # epilogues only, no warp kernel
    assert paths["embed"] == only(
        fused_dw_pw_block_f32=paths["embed"]["fused_dw_pw_block_f32"],
        fused_dw_pw_block_bf16=paths["embed"]["fused_dw_pw_block_bf16"],
        conv_epilogue=paths["embed"]["conv_epilogue"]), paths
    # the split-TF32 convolution runs on R100's path alone and the token
    # FC on the transformers': no bundled graph has a convolution or an FC
    # they take
    for key, counts in {**paths, **models}.items():
        if key != "embed_r100":
            assert counts["conv3x3_tc"] == 0, (key, counts)
        if key not in ("embed_vit", "embed_swin"):
            assert counts["fc_tc"] == 0, (key, counts)
            assert counts["attention_tc"] == 0, (key, counts)
    numbers = {"path_launches": paths, "models_launches": models,
               "device": smi, "seconds": time.perf_counter() - t_start}

    kernels = []
    for name, (source, replaces) in SOURCES.items():
        n = sum(counts[name] for counts in paths.values())
        assert n > 0, (name, paths)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n,
            "max_abs_err": errs.get(name)})

    print(smi)
    print(json.dumps(numbers))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
