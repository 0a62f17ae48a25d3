"""Smoke run of the PyTorch/CUDA port (raytracer_tpu_torch) on one NVIDIA
GPU: the quickest proof that the port builds and renders on the card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  0. Require a CUDA device; print torch/CUDA versions and the card's name
     and power limit (nvidia-smi).
  1. Build the kernels (csrc/quad_traverse.cu, the 4-wide tree's K1/K2;
     csrc/binary_traverse.cu, the binary tree's K3/K4;
     csrc/lab_traverse.cu, the traversal lab's L1/L9/L2;
     csrc/lab2_traverse.cu, its L3-L8; csrc/lab3_traverse.cu, the
     fixed-sequence labs' L10/L11; csrc/bf16_lab.cu, L12; the names of
     PERF.md's kernel table; csrc/light_select.cu, NEE's light selection
     S1) with nvcc, one process per source, all started together.
  2. Kernels against their plain torch versions on the card, on the
     300k-triangle atrium and five 1920x1080 ray sets (primary rays,
     incoherent reflected rays, the incoherent rays with a quarter of the
     lanes inactive, shadow rays with finite t_max and a skipped light
     object, and the shadow rays with the same lanes inactive); K3/K4
     also on the primary and shadow sets at t_min 0.01 (a t_min that
     makes the renderer fall back to accel="bvh"), and once at the
     largest stack need (128 entries, 64 KB of shared memory a block) on
     the primary and shadow sets. The plain versions run on every ray
     (and, for K1/K2, timed apart on a strided subset of >= 65,536 rays);
     the gate is bit equality (hit, tri, t, u, v; the occlusion mask).
     Times the kernels (CUDA events, mean of 5 launches) and the plain
     versions (host clock, one run). Prints how K1-K4 launch on this card
     (registers and ptxas spills, local and dynamic shared memory,
     resident blocks a SM, the persistent grid, G and the refill
     threshold) and the share of inactive lanes in each set. K3 against
     K1 and K4 against K2 on the same rays at t_min 1e-3: hit flips and
     triangle differences at most 1e-4 of the rays.
  3. The main path: ProgressiveRenderer on the atrium at 1920x1080, depth 3,
     NEE; 2 warm and 4 timed frames, with ms/frame, rays/frame, Mrays/s
     and peak device memory; a finite, non-black image; both kernels
     launched during the run, and S1 once a bounce (3 a frame). Then the
     atrium at 64x64, 2 frames, on the card against the CPU (the plain
     versions), pixel by pixel.
  4. The CLI renders a JSON scene to a PNG.
  5. The accel="bvh" path: phase 3 with RenderConfig(accel="bvh"), whose
     frames must launch K3/K4 and not K1/K2, and whose image must agree
     with phase 3's; then card against CPU at 64x64, 2 frames.
  6. The traversal lab (raytracer_tpu_torch/lab) at 1920x1080 on the atrium,
     through the functions its entry points run: kernel_lab (leaf-16 bake;
     primary rays and the bounce-1 wavefront in the renderer's and in the
     sorted order), occl_lab (leaf-8 bake; the NEE shadow batches at bounce
     0 and 1, the latter in both orders) and bvh4_lab (leaf-8 bake; the
     closest-hit sets), with every lab launch count set to 0 just before
     and read just after. Kernel times by CUDA events (mean of 5),
     visits per ray, leaf share, ns per visit. Then every variant against
     its plain torch version on every ray of every set (bit equality of
     the hit records, masks and counts; plain timed by host clock, one
     run), and L2 against K1 (hit flips and triangle differences at most
     TREE_AGREEMENT of the rays; L2 ordered, K1's walk on K1's machinery,
     equal to K1 on every ray). Then L2's launch shapes (both orders; no
     local memory and no spills) and its bounds on every set and order,
     counted on the triangles it tests (walk_bound), each beside bound()
     and beside the kernel's ms.
  7. The deferred-leaf and component-major labs at 1920x1080 on the leaf-8
     atrium (its closest-hit sets), through the functions their entry
     points run: v2_kernel_lab (L3), v3_kernel_lab (L4: base, nocond,
     dblread), v4_interleave_lab (L5: shared, switch, with K1, K3 and L4
     base timed in the same run) and r3_kernel_lab (L6: the four
     descent/divfree combinations and leafpar), with their launch counts
     set to 0 just before and read just after. Then every variant against
     its plain torch version on every ray of every set (bit equality of t,
     tri, u, v and L4's counts; plain timed by host clock, one run); L4
     dblread = base, L5 switch = L4 base, L6 descent = no descent; L3/L4
     against K3 and L5/L6 against K1 (hit flips and triangle differences
     at most TREE_AGREEMENT of the rays; nocond's results are wrong by
     design and exempt); L5's times beside L4 base's, K3's and K1's. Then
     the launch shapes of L3-L6 (every variant and combination run; no
     local memory and no spills) and the bounds of L3, L4, L5 and L6's
     serial combinations on every set, counted on the triangles they test
     (walk_bound), each beside bound().
  8. The 8-wide lab L7 and the near-first any-hit lab L8 at 1920x1080 on
     the leaf-8 atrium, through the functions their entry points run:
     r3_oct_lab (the oct collapse of the bake's BVH, timed; K1 and L7 on
     the closest-hit sets) and r3_occl3_lab (K2 and L8 in both orders on
     the shadow batches and on the bounce-1 batch resorted by origin), with
     their launch counts set to 0 just before and read just after; each run
     times its plain version once (host clock) and counts its steps. Then
     every kernel against its plain version on every ray of every set (bit
     equality), L7 against K1 (hit flips and triangle differences at most
     TREE_AGREEMENT of the rays) and L8, both orders, against K2 (the same
     mask on every ray: any-hit does not depend on the visiting order).
     Then L7's and L8's launch shapes (registers, ptxas spills, local
     memory, which must be 0 with no spills, dynamic shared memory, blocks
     a SM, grid), and their bounds on every set, counted on the triangles
     they test (walk_bound), each beside bound() (every slot of each leaf
     row visited) and beside the kernel's ms.
  9. The fixed-sequence labs on the leaf-8 atrium, through the functions
     their entry points run, with their launch counts set to 0 just before
     and read just after: visit_cost_lab (L11a, its six variants; L11b, its
     four) and smem_lab (L10, smem and transp) at the JAX labs' sizes and
     at the card size (every SM full) at the labs' K, with each warp's
     clock64() cycles per iteration and CUDA-event times; bf16_lab (L12,
     the six JAX chains and the two fused forms). Then every L10/L11
     variant against its plain version at K_CHECK iterations on every ray
     of every size, on the lab's rays and on rays aimed at the sequence's
     triangles (bit equality), and at the lab size on a table whose
     triangles' edges are scaled by a power of two, so that dets reach
     2^126 and L11b's and L10's exact rerun runs; their reciprocal against the
     division on every float it takes (lab_rcp_check); L12's against its
     plain versions at its K on the ones input and a random one (bit
     equality; the fused forms within 1 ulp, the differing elements
     counted); the identities (L11b slice = base and sliceilp = ilp, L10
     smem = L11b base: different kernels, L12 bf16 = bf16_mul on the ones
     input); the launch shapes of every L11a, L11b and L10 kernel (no
     local memory and no spills); the SASS instructions of the K loop of
     L11a full and nored, L11b's four and L10's two a visit and the issue
     time they imply at the card size; each variant's bound at the card
     size.
 10. The render modes on the 1080p 300k atrium at the bench camera, through
     ProgressiveRenderer, with K1/K2's launch counts set to 0 before and
     read after each part, and each part required to launch them (and S1
     3 a frame, a step or a preview; none for the G-buffer): (a) one
     spp_batch=4 step against 4 sequential steps of a fresh renderer
     (bit-equal, else within PIXEL_ATOL / MAX_FLIPPED), with ms per step
     and per sample against phase 3's ms/frame and the peak device memory
     of each; (b) adaptive sampling at tol 0.15, min frames 8, over 24
     frames, with ms and rays traced per frame and the converged fraction
     at frames 8, 16 and 24; retired pixels unchanged by one more step, and
     tol 0 at 64x64 bit-equal to the plain accumulation on the card; (c)
     image(denoise=True) after 4 frames (one K1 launch for the G-buffer),
     the G-buffer pass and the filter timed apart, the accumulation
     unchanged, and the card's filter against the CPU's on the same 1080p
     buffers within rtol 1e-5 (atol 1e-6); (d) preview_image(4) with and
     without denoise, upscaled or not, and aovs(). In (a), (b), (c) and
     (d), one K1 launch of the path (and one K2 launch, but in (c)) is
     captured at its 1080p (or preview) shape, masks included, and held
     bit for bit against the plain walk on the card on the same rays.
     (e) (a), (b) and (d) at 32x32, card against CPU, within PIXEL_ATOL /
     MAX_FLIPPED (adaptive counts equal on all but MAX_FLIPPED of the
     pixels).
 11. ReSTIR DI (RenderConfig(use_restir=True)) through ProgressiveRenderer,
     with every launch count set to 0 before and read after each run:
     (a) the 1080p atrium at the bench camera, accel auto, 2 warm and 4
     timed frames, with ms/frame beside phase 3's, Mrays/s (shadow rays
     included) and peak device memory; K1 3 and K2 4 launches a frame and
     no K3/K4, S1 3 (the primary vertex's MIS-only call and 2 bounces); a
     finite, non-black image and M > 0 on every pixel that hits; (b) the
     same with accel="bvh": K3 3 and K4 4 a frame, no K1/K2, the image
     within PIXEL_ATOL / MAX_FLIPPED of (a)'s; (c) one more step
     of (a) with its primary K1 launch and K2 launch 1 (step 6's final
     visibility, each ray skipping its sample's light object) captured and
     held bit for bit against the plain walks on the card; (d) the 64-light
     grid at 1080p (the JAX ReSTIR lab's camera), ReSTIR against plain
     NEE, 4 timed frames each, S1 3 a frame; (e) the atrium at 32x32 and
     the lightgrid at 24x24, 3 frames each, card against CPU within
     PIXEL_ATOL / MAX_FLIPPED, the reservoir's light_index equal on all
     but MAX_FLIPPED of the pixels.
 12. The editor path (scene edits, ROADMAP P3/P11), with the launch counts
     set to 0 before and read after each part, and each part required to
     launch its kernels: (a) examples/interactive_session.py's edits on the
     Cornell box at 1080p (camera move, transform drag, material paint,
     light brighten, object add through prebake_async), each shown on the
     4x denoised native preview: each edit's ms to its visible frame and
     to resumed full-res accumulation, and its replay branch checked (the
     transform refits the same BVH object, the material edits keep the
     geometry tensors, the add takes the prebake); (b) on the 1080p atrium
     with accel auto and bvh, the refit replay after moving the skylight
     and a column, timed beside a full bake of the same state (and the
     refit's host part, the tree's refit and repack in it, and the
     upload apart), and a material-only edit; (c)
     after the refit, after the material edit, and after a column's
     collapse to its position and its restore, one captured K1/K2 (K3/K4)
     launch pair of the path held bit for bit against the plain walks on
     the card (they test every slot of a leaf row, so they do not read the
     cached leaf counts), with the leaf counts equal to the row counts of
     each ptris; (d) the refit scene against a fresh bake of the same state
     at 1080p, and the session at 32x32, 3 frames an edit, card against
     CPU, within PIXEL_ATOL / MAX_FLIPPED.
 13. The sharded renderer (pixel tiles over torch.distributed, ROADMAP
     P12), every part in ranks the script spawns (parallel/launch.spawn:
     each rank a process, each group with a timeout, each spawn joined with
     a deadline), each rank's launch counts set to 0 before its frames and
     read after each frame: (a) a world of 1 over NCCL,
     ProgressiveRenderer(mesh=make_pixel_mesh()) on the 1080p atrium at the
     bench camera, 2 warm and 4 timed frames, ms/frame beside phase 3's, K1
     3 and K2 3 launches a frame, the image bit-equal to a single-device
     renderer's after the same frames; (b) a world of 2 over gloo, both
     ranks on the one card (NCCL refuses two ranks on one device; gloo
     moves card tensors through host memory), 540 rows a rank: plain NEE
     and ReSTIR at the defaults (radius 16: a 17-row halo), each with
     per-rank ms/frame, PhaseTimer spans (tile render, halo, gather), peak
     device memory and launches by frame (K1 3 / K2 3, ReSTIR K1 3 / K2
     4; S1 3 in both), the gathered images bit-equal to (a)'s single-device
     ones, and one K1 and one K2 launch per rank captured and bit-equal to
     the plain walks; (c) one accel="bvh" frame in that world: K3/K4 3 each
     on every rank, no K1/K2, the image bit-equal to (b)'s first frame; (d)
     the Cornell box at 32x32 on the card's world of 2 against one CPU
     device: plain, spp_batch=2, adaptive (tol 0.15), preview_image(4) with and
     without the denoiser, aovs(), image(denoise=True) and ReSTIR (radius
     2), within PIXEL_ATOL / MAX_FLIPPED.
 14. The port's last modules (ROADMAP P6, P1, P4, P5, P2), through
     ProgressiveRenderer, with every launch count set to 0 before and read
     after each run: (a) the 1080p atrium at depth DEEP_DEPTH with
     compact_deep on and off, 2 warm and 4 timed frames each, the images
     bit-equal; one instrumented compacted frame with each bounce's prefix
     k, live count and lanes run, K1/K2's lanes per launch, the bounce
     sorts' ms (sort + state permute), one K1 and one K2 launch on a
     prefix captured and bit-equal to the plain walks; the frame's shadow
     sets traced unsorted and sorted (_occluded_sorted), masks equal, with
     the sort's ms against the K2 ms it saves; (b) the 1M atrium baked as
     one part and in parts at the JAX budget (MULTIPART_BUDGET), bake
     seconds, ms/frame under accel "cuda" and "bvh" (1 warm, 2 timed),
     K1/K2 (K3/K4) 3 a part a frame, the images bit-equal to one part's,
     and the first launch of each kernel on each part captured and
     bit-equal to the plain walks; (c) phase 3's frame on the exact and
     the stable bake (accel "cuda" and "bvh"), ms/frame, the tables' rows
     and K1-K4's launch shape (registers, shared memory, blocks a SM) on
     each, the images bit-equal, one launch of each kernel on the padded
     tables captured and bit-equal; (d) one 1080p accel="bvh" frame with
     binary_traverse.STACK_CAP lowered to WALK_STACK_CAP, so that the
     atrium's tree takes the skip-link walk (no kernel launches), with its
     ms and micro-steps a trace, against a K3/K4 frame within PIXEL_ATOL /
     MAX_FLIPPED; (e) (a)-(d) on the Cornell box (a at 64x32 with
     compact_decay 0.25, so that a prefix runs; b at the JAX tests' 96 KiB
     budget), 2 frames, card against CPU within PIXEL_ATOL / MAX_FLIPPED.
 15. NEE light selection (S1, ops/light_select.py) on the renderer's own
     tensors: one frame of the 1080p atrium at the bench camera and one of
     the 64-light grid (NEE, phase 11's camera), each with its bounce-1
     call's inputs and outputs kept (2,073,600 lanes; L columns as the
     scene gives them), the kernel's outputs bit-equal to the plain
     version's on the same inputs (run on the CPU), the kernel timed
     (CUDA events, mean of SELECT_REPS launches) and the plain version on
     the card (host clock, one run), each beside select_bound().

Every kernel's entry in the kernels line has its bound (bound_ms,
bound_by): the larger of its bytes over the card's memory rate and its
FP32 operations over the card's FP32 rate (L12: its results over the
card's instruction rate for their type), counted on the run whose ms it
shows (bound(); walk_bound() for K1-K4 and L1-L9, which count only the
triangles they test; fixed_seq_bound(), chain_bound(); select_bound()
for S1); library_ms is null, as no PyTorch call computes a BVH walk, a
fixed-sequence walk, a K-step chain or a light selection. The line before
the last is {"kernels": [...]}; the last line is {"ok": true, "device":
{...}}. The scene and all rays are generated from
fixed seeds; nothing is downloaded.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

WIDTH, HEIGHT = 1920, 1080
TARGET_TRIS = 300_000
# The camera of bench.py's headline workload.
CAM_POS, CAM_TARGET = (-16.0, 6.5, -7.5), (8.0, 3.0, 4.0)
SUBSET_MIN = 65_536
PIXEL_ATOL = 1e-4  # the slice tolerance: per pixel, except flipped pixels
MAX_FLIPPED = 0.01
KERNEL_SOURCE = "raytracer_tpu_torch/csrc/quad_traverse.cu"
BINARY_SOURCE = "raytracer_tpu_torch/csrc/binary_traverse.cu"
LAB_SOURCE = "raytracer_tpu_torch/csrc/lab_traverse.cu"
LAB2_SOURCE = "raytracer_tpu_torch/csrc/lab2_traverse.cu"
LAB3_SOURCE = "raytracer_tpu_torch/csrc/lab3_traverse.cu"
BF16_SOURCE = "raytracer_tpu_torch/csrc/bf16_lab.cu"
SELECT_SOURCE = "raytracer_tpu_torch/csrc/light_select.cu"
AIMED_SEED = 9  # phase 9's rays that hit
# K3 vs K1, K4 vs K2, L2 vs K1: share of rays that may differ
TREE_AGREEMENT = 1e-4
# Phase 2's partly inactive sets: the share of inactive lanes and its seed.
INACTIVE_SHARE = 0.25
INACTIVE_SEED = 8

# The card's peaks for the bounds (NVIDIA's H100 SXM data sheet, at 700 W):
# HBM3 bytes per second, and FP32 operations per second outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# FP32 operations of one test, counted from csrc/traverse_common.cuh: each
# add, sub, mul, min, max, divide and compare counts one (the libraries
# are built with -fmad=false, so there are no FMAs); selects, fabsf, the
# NaN checks of nmin/nmax and integer work count none.
SLAB_OPS = 25  # slab(): 6 sub, 6 mul, 6 min, 6 max, 1 compare
NODE_OPS = {
    "binary": 2 * SLAB_OPS + 1,  # binary_visit<true>: + near_r < near_l
    "quad": 4 * SLAB_OPS + 5,  # quad_visit<true>: + argmin, 3 cmp, 2 min
    "quad_fixed": 4 * SLAB_OPS,  # quad_visit<false>
    "oct": 8 * SLAB_OPS + 13,  # oct_visit: + tournament, 7 cmp, 6 min
}
# moller(): 38 mul/add/sub of the two cross and four dot products, 3 sub
# (origin - v0), 3 mul by 1/det, 1 divide, |det| > 1e-10, u + v and 5
# bounds compares.
TRI_OPS = {
    "closest": 52,
    "any": 53,  # + the skip-object compare
    "cm": 54,  # L3's one-pass leaf: + t < t_min, t == t_min
}
CLOSEST_RAY_BYTES = 28 + 16  # origin, direction, t_max in; t, tri, u, v out
ANY_RAY_BYTES = 32 + 1  # + skip_object in; the bool mask out
# What a persistent kernel moves for an inactive ray: t_max in, the outputs.
INACTIVE_RAY_BYTES = {"closest": 4 + 16, "any": 4 + 1}
# The bytes of a node row that a persistent kernel's node step reads: the
# whole 64-byte binary row; 7 float4 (boxes and metas) of the 128-byte
# quad row; 14 float4 of the 256-byte oct row.
ROW_READ_BYTES = {"binary": 64, "quad": 112, "quad_fixed": 112, "oct": 224}
COUNTER_BYTES = 8  # nvisit/nit and nleaf out (L1, L4, L9)
# The 10 floats of a triangle in a component-major row (v0, e1, e2, tri_f).
CM_TRI_BYTES = 10 * 4
# The fixed-sequence labs (phase 9): FP32 operations per iteration of
# csrc/lab3_traverse.cu, counted as above. A warp's min of 32 values is 31
# mins, counted as one a ray. L11a: full = 2 slab() + the two t_near mins +
# the swap compare; nored = 2 slab(); noslab = 4 compares of t_cap with
# the row + the two mins + the swap compare; extracts = 11 adds; rowonly
# and empty none (their bound is bytes, and their share means nothing).
VISIT_OPS = {"full": 2 * SLAB_OPS + 3, "nored": 2 * SLAB_OPS, "noslab": 7,
             "extracts": 11, "rowonly": 0, "empty": 0}
# One leaf visit of 8 triangles: base/slice and smem the serial leaf;
# ilp/sliceilp + 7 min-tree compares and the compare with the best t;
# transp cm_leaf's 8 triangles + the compare with the best t.
LEAF_VISIT_OPS = {"base": 8 * TRI_OPS["closest"],
                  "slice": 8 * TRI_OPS["closest"],
                  "ilp": 8 * TRI_OPS["closest"] + 8,
                  "sliceilp": 8 * TRI_OPS["closest"] + 8,
                  "smem": 8 * TRI_OPS["closest"],
                  "transp": 8 * TRI_OPS["cm"] + 1}
FIXED_RAY_BYTES = 24 + 4  # origin, direction in; one int32 out
# L12 is bound by instruction issue. An FP32 add, multiply or FMA is one
# instruction, and an SM retires 128 FP32 results a clock; a bf16x2 add,
# multiply or FMA gives two results, 256 a clock (the CUDA C++ Programming
# Guide's arithmetic-instruction throughput table, compute capability
# 9.0). At the data sheet's 132 SMs and 1.98 GHz these are half of
# PEAK_FP32_PER_S (which counts an FMA as two operations) and all of it.
PEAK_FP32_RESULTS_PER_S = PEAK_FP32_PER_S / 2
PEAK_BF16_RESULTS_PER_S = PEAK_FP32_PER_S


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def new_counts(like):
    """Zeroed (visits or steps, leaf ones) i32 counters for the rays of
    `like`, as the plain versions take them."""
    import torch

    return tuple(torch.zeros(like.shape[0], dtype=torch.int32,
                             device=like.device) for _ in range(2))


def bound(n_rays, ray_bytes, arrays, counts, node, tri):
    """The least time the card could take for a walk's work on these rays:
    the larger of its bytes (each ray's inputs read and outputs written
    once, the tree's `arrays` and last the leaf rows read once) over
    PEAK_BYTES_PER_S and its FP32 operations (the internal visits of
    `counts` times NODE_OPS[node], the leaf rows times the leaf size times
    TRI_OPS[tri]) over PEAK_FP32_PER_S. `counts` (visits or steps, leaf
    ones) per ray, from the plain version on the same rays (or the
    kernel's own counters).
    Returns {"bound_ms", "bound_by", "bytes", "ops"}."""
    leaf = arrays[-1].shape[1] // 12  # triangles per leaf row
    visits, leaves = (int(c.sum()) for c in counts)
    ops = (visits - leaves) * NODE_OPS[node] + leaves * leaf * TRI_OPS[tri]
    nbytes = n_rays * ray_bytes + sum(a.numel() * a.element_size()
                                      for a in arrays)
    return bound_of(nbytes, ops)


def walk_bound(ds, nodes, n_rays, ray_bytes, counts, tests, node, tri,
               counter_bytes=0, leaf_bytes=None):
    """The bound of K1-K4 and the persistent labs, which test only the
    triangles below each leaf row's count: as bound(), for what they read
    and test. Bytes: each live ray's inputs and outputs (ray_bytes; a live
    ray takes at least one step of `counts`), each inactive ray's t_max and
    outputs (INACTIVE_RAY_BYTES), `counter_bytes` more for every ray (the
    counters L1, L4 and L9 write, 0s for an inactive ray), what a node step
    reads of each of the tree's node rows `nodes` (qnodes, onodes, whose
    rows hold the child metas, or pnodes; ROW_READ_BYTES), the leaf counts
    and the real triangles of each leaf row (or `leaf_bytes` of them: L3's
    CM_TRI_BYTES a triangle), once. Operations: the internal visits or steps of
    `counts` times NODE_OPS[node] and `tests` (counting_leaf_tests(): the
    triangles they test, not every slot of each row visited) times
    TRI_OPS[tri]."""
    from raytracer_tpu_torch.ops import quad_traverse as qt

    lc = qt.leaf_counts(ds)
    visits, leaves = (int(c.sum()) for c in counts)
    ops = (visits - leaves) * NODE_OPS[node] + tests * TRI_OPS[tri]
    live = int((counts[0] > 0).sum())
    if leaf_bytes is None:
        leaf_bytes = int(lc.sum()) * qt.TRI_STRIDE * 4
    kind = "any" if tri == "any" else "closest"
    nbytes = (live * ray_bytes + (n_rays - live) * INACTIVE_RAY_BYTES[kind]
              + n_rays * counter_bytes
              + nodes.shape[0] * ROW_READ_BYTES[node] + lc.numel() * 4
              + leaf_bytes)
    return bound_of(nbytes, ops)


def quad_walk(ds, origin, direction, closest):
    """(root, node step, stack cap) of K1's (`closest`) or K2's plain
    walk."""
    from raytracer_tpu_torch.ops import quad_traverse as qt

    visit = qt._quad_near_last_visit if closest else qt._quad_fixed_visit
    return (ds.root, visit(origin, qt._inv_dir(direction), ds.qmeta,
                           ds.qnodes), qt.CAP)


def binary_walk(ds, origin, direction, t_min):
    """(root, node step, stack cap) of K3's and K4's plain walk."""
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    return (ds.binary_root, bt._binary_visit(origin, qt._inv_dir(direction),
                                             ds.pnodes, t_min), bt.STACK_CAP)


def counting_leaf_tests():
    """(closest, any_hit, total): leaf hooks for the plain walks, called as
    quad_traverse._serial_leaf and _any_leaf, that test as those do and add
    to total[0] the triangle tests a kernel of the persistent walk makes:
    in each leaf row the slots below the row's count
    (quad_traverse.row_counts), and for any-hit those up to the first
    accepted hit only."""
    import torch

    from raytracer_tpu_torch.ops import quad_traverse as qt

    total = [0]

    def closest(o, d, rows, *best_and_t_min):
        total[0] += int(qt.row_counts(rows).sum())
        return qt._serial_leaf(o, d, rows, *best_and_t_min)

    def any_hit(o, d, rows, tm, skip_f, t_min):
        ox, oy, oz = o.unbind(1)
        dx, dy, dz = d.unbind(1)
        tests = qt.row_counts(rows)
        found = torch.zeros_like(tm, dtype=torch.bool)
        for k in range(rows.shape[1] // qt.TRI_STRIDE):
            tri = rows[:, k * qt.TRI_STRIDE:(k + 1) * qt.TRI_STRIDE]
            _, _, _, valid = qt._moller(ox, oy, oz, dx, dy, dz, tri, tm,
                                        t_min)
            first = valid & (tri[:, 10] != skip_f) & ~found
            tests = torch.where(first, k + 1, tests)
            found |= first
        total[0] += int(tests.sum())
        return found

    return closest, any_hit, total


def leaf_tests(ds, walk, origin, direction, t_max, skip_object=None,
               t_min=1e-3):
    """The triangle tests a kernel of the persistent walk makes on these
    rays, closest hit (skip_object None) or any-hit: those of the plain
    walk `walk` (quad_walk() or binary_walk()), counted by
    counting_leaf_tests(). Returns an int."""
    from raytracer_tpu_torch.ops import quad_traverse as qt

    closest, any_hit, total = counting_leaf_tests()
    root, visit, cap = walk
    if skip_object is None:
        qt._closest_walk(origin, direction, t_max, root, ds.ptris, visit,
                         cap, t_min, leaf_test=closest)
    else:
        qt._any_walk(origin, direction, t_max, skip_object, root, ds.ptris,
                     visit, cap, t_min, leaf_test=any_hit)
    return total[0]


def counting_cm_tests():
    """(leaf, total): a leaf hook for L3's plain walk, called as
    v2_kernel_lab._cm_leaf, that tests every slot as that does and adds to
    total[0] the triangle tests lab_closest_cm makes: 4 a float4 group of
    v2_kernel_lab.cm_groups in each leaf row; and to total[1] those below
    each row's count, which the function needs and K3's leaf makes on this
    walk."""
    from raytracer_tpu_torch.lab import v2_kernel_lab as v2

    total = [0, 0]

    def leaf(o, d, rows, bt_, *rest):
        total[0] += 4 * int(v2.cm_groups(rows, bt_).sum())
        total[1] += int(v2.cm_row_counts(rows).sum())
        return v2._cm_leaf(o, d, rows, bt_, *rest)

    return leaf, total


def gate_cm_ties(label, l3, k3, ds, origin, direction):
    """Raise unless L3's t equals K3's on every ray and, where their
    triangles differ, both triangles hit the ray at exactly that t (L3
    keeps the largest index of a tie, K3 the first in slot order). Returns
    the number of rays whose triangles differ."""
    import torch

    from raytracer_tpu_torch.ops import quad_traverse as qt

    if not torch.equal(l3[0], k3[0]):
        raise RuntimeError(f"L3 {label}: t differs from K3's on "
                           f"{int((l3[0] != k3[0]).sum())} rays")
    differ = torch.nonzero(l3[1] != k3[1]).squeeze(1)
    if not differ.numel():
        return 0
    rows = ds.ptris.view(-1, qt.TRI_STRIDE)
    leaf = ds.ptris.shape[1] // qt.TRI_STRIDE
    slot = torch.arange(rows.shape[0], device=rows.device)
    real = (slot % leaf) < qt.leaf_counts(ds).repeat_interleave(leaf)
    where = torch.full((int(rows[real, 9].max()) + 1,), -1, dtype=torch.int64,
                       device=rows.device)
    where[rows[real, 9].long()] = slot[real]
    o, d = origin[differ], direction[differ]
    ox, oy, oz = o.unbind(1)
    dx, dy, dz = d.unbind(1)
    t_cap = torch.full_like(k3[0][differ], float("inf"))
    for got in (l3, k3):
        tri = rows[where[got[1][differ].long()]]
        t, _, _, valid = qt._moller(ox, oy, oz, dx, dy, dz, tri, t_cap, 1e-3)
        if not (bool(valid.all()) and torch.equal(t, k3[0][differ])):
            raise RuntimeError(f"L3 {label}: a triangle that differs from "
                               "K3's is not a tie at K3's t")
    return int(differ.numel())


def bound_of(nbytes, ops, ops_per_s=PEAK_FP32_PER_S):
    """{"bound_ms", "bound_by", "bytes", "ops"}: the larger of nbytes over
    PEAK_BYTES_PER_S and ops over ops_per_s."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / ops_per_s
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def fixed_seq_bound(n_rays, k, table, ops_per_iter):
    """The bound of a fixed-sequence walk (phase 9): each ray's
    FIXED_RAY_BYTES and the min(k, rows) rows of `table` that k iterations
    read, once; n_rays x k x ops_per_iter FP32 operations."""
    rows = min(k, table.shape[0])
    nbytes = (n_rays * FIXED_RAY_BYTES
              + rows * table.shape[1] * table.element_size())
    return bound_of(nbytes, n_rays * k * ops_per_iter)


def chain_bound(variant, x, y, k):
    """The bound of an L12 chain (phase 9): its inputs read and its output
    written once; its results (one per element and instruction; bf16x2
    instructions give two) over the card's rate for their type. Per
    element of x (and of y): k (mul, fma) or 2k (mul + add) chain results;
    the ILP forms 2 x 8 or 2 x 16 per k/4 steps, + 4 + 3 (f32: the scales
    and the sum of 4 chains) or 8 + 7 (bf16, 8 chains); the f32 forms one
    add per output element."""
    steps = k // 4
    per = {"f32": 2 * k, "f32_mul": k, "f32_fma": k,
           "f32_ilp": 8 * steps + 7, "bf16": 2 * k, "bf16_mul": k,
           "bf16_fma": k, "bf16_ilp": 16 * steps + 15}[variant]
    elems = x.numel() + (0 if y is None else y.numel())
    nbytes = (elems + x.numel()) * x.element_size()
    if y is None:
        return bound_of(nbytes, elems * per, PEAK_BF16_RESULTS_PER_S)
    return bound_of(nbytes, elems * per + x.numel(), PEAK_FP32_RESULTS_PER_S)


def phase0():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL phase 0: torch.cuda.is_available() is False")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(f"nvidia-smi: {nvidia_smi_line()}")


def phase1():
    from concurrent.futures import ThreadPoolExecutor

    from raytracer_tpu_torch.ops import _build

    loaders = (_build.quad_traverse_lib, _build.binary_traverse_lib,
               _build.lab_traverse_lib, _build.lab2_traverse_lib,
               _build.lab3_traverse_lib, _build.bf16_lab_lib,
               _build.light_select_lib)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(loaders)) as pool:
        for b in [pool.submit(load) for load in loaders]:
            b.result()
    log(f"phase 1: built the {len(loaders)} kernel libraries in "
        f"{time.perf_counter() - t0:.2f} s")
    for source, stem in ((KERNEL_SOURCE, "libquad_traverse"),
                         (BINARY_SOURCE, "libbinary_traverse"),
                         (LAB_SOURCE, "liblab_traverse"),
                         (LAB2_SOURCE, "liblab2_traverse"),
                         (LAB3_SOURCE, "liblab3_traverse"),
                         (BF16_SOURCE, "libbf16_lab"),
                         (SELECT_SOURCE, "liblight_select")):
        info = _build.build_info[stem]
        log(f"phase 1: {source}: nvcc {info['seconds']:.2f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "Function" in line:
                log(f"  ptxas: {line.strip()}")


# The traversal kernels' keys of all_launch_counts().
TRAVERSAL_KINDS = ("quad_closest", "quad_occlusion", "binary_closest",
                   "binary_occlusion")
# S1's launches in a depth-3 frame: one a `_shade`, one a bounce.
SELECT_PER_FRAME = 3


def reset_all_launch_counts():
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import light_select as ls
    from raytracer_tpu_torch.ops import quad_traverse as qt

    qt.reset_launch_counts()
    bt.reset_launch_counts()
    ls.reset_launch_counts()


def all_launch_counts():
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import light_select as ls
    from raytracer_tpu_torch.ops import quad_traverse as qt

    return {"quad_closest": qt.closest_launches,
            "quad_occlusion": qt.occlusion_launches,
            "binary_closest": bt.closest_launches,
            "binary_occlusion": bt.occlusion_launches,
            "light_select": ls.launches}


def gate_select(what, frames, per_frame=SELECT_PER_FRAME):
    """Raise unless S1 launched `per_frame` times a frame over `frames`
    depth-3 frames (steps, previews) since the last
    reset_all_launch_counts(); returns its launches."""
    from raytracer_tpu_torch.ops import light_select as ls

    if ls.launches != per_frame * frames:
        raise RuntimeError(f"{what}: {ls.launches} light selection "
                           f"launches, want {per_frame} a frame over "
                           f"{frames} frames")
    return ls.launches


def bench_camera_ubo(device, width, height):
    import numpy as np
    import torch

    from raytracer_tpu_torch.ops.camera import Camera

    cam = Camera.create(position=CAM_POS, aspect=width / height,
                        target=CAM_TARGET)
    mats = cam.matrices()
    return cam, {k: torch.from_numpy(np.ascontiguousarray(mats[k])).to(device)
                 for k in ("inverse_view", "inverse_proj")}


def ray_sets(ds, device):
    """The 1920x1080 ray sets: primary, incoherent reflected (both with
    active mask None) and the incoherent set with INACTIVE_SHARE of its
    lanes inactive; shadow (t_max, skip_object, active mask) and the shadow
    set with the same lanes inactive."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.integrator.wavefront import _camera_rays
    from raytracer_tpu_torch.ops import quad_traverse as qt

    n = WIDTH * HEIGHT
    _, ubo = bench_camera_ubo(device, WIDTH, HEIGHT)
    origin, direction = _camera_rays(
        ubo["inverse_view"], ubo["inverse_proj"], WIDTH, HEIGHT,
        torch.full((n, 2), 0.5, device=device),
        torch.arange(n, device=device))
    rng = np.random.default_rng(7)
    # A bounce-like incoherent set: reflect off a pseudo-random normal
    # (tools/tpu_smoke.py's construction, from a numpy seed).
    nrm = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    nrm = (nrm / nrm.norm(dim=1, keepdim=True)).to(device)
    bdir = direction - 2.0 * (direction * nrm).sum(1, keepdim=True) * nrm
    bdir = (bdir / bdir.norm(dim=1, keepdim=True)).contiguous()
    # Shadow rays from the primary hits toward random points of the
    # skylight, skipping the skylight's own object.
    hit = qt.intersect_quad(origin, direction, ds, 1e-3, 1e4)
    pos = origin + (hit.t * 0.999)[:, None] * direction
    light_obj = int(ds.light_meta_packed[0, 5])
    rows = ds.light_tri_packed[ds.light_tri_packed[:, 9] == light_obj]
    corners = torch.cat([rows[:, 0:3], rows[:, 0:3] + rows[:, 3:6],
                         rows[:, 0:3] + rows[:, 6:9]])
    lo, hi = corners.amin(0), corners.amax(0)
    u = torch.from_numpy(rng.uniform(size=(n, 3)).astype(np.float32))
    target = lo + u.to(device) * (hi - lo)
    to_l = target - pos
    dist = to_l.norm(dim=1)
    sdir = (to_l / dist.clamp_min(1e-20)[:, None]).contiguous()
    shadow = (pos.contiguous(), sdir, (dist * 0.999).contiguous(),
              torch.full((n,), light_obj, dtype=torch.int32, device=device))
    # A quarter of the lanes inactive, from a numpy seed: the kernels'
    # fetch answers such rays without walking them.
    keep = torch.from_numpy(np.random.default_rng(INACTIVE_SEED).uniform(
        size=n) >= INACTIVE_SHARE).to(device)
    return {
        "primary": (origin, direction, None),
        "incoherent": (origin, bdir, None),
        "incoherent_inactive": (origin, bdir, keep),
        "shadow": (*shadow, hit.hit),
        "shadow_inactive": (*shadow, hit.hit & keep),
    }


def phase2(ds, device):
    """Kernels vs plain versions; returns the kernels' report entries."""
    import torch

    from raytracer_tpu_torch.lab.rays import cuda_ms, host_ms
    from raytracer_tpu_torch.ops import quad_traverse as qt

    sets = ray_sets(ds, device)
    n = WIDTH * HEIGHT
    stride = max(1, n // SUBSET_MIN)
    sub = torch.arange(0, n, stride, device=device)
    assert sub.numel() >= SUBSET_MIN
    report = {}

    scene_args = (ds.root, ds.qmeta, ds.qnodes, ds.ptris)
    for name in ("primary", "incoherent", "incoherent_inactive"):
        o, d, active = sets[name]
        tmax = torch.full((n,), 1e4, device=device)
        got = qt.intersect_quad(o, d, ds, 1e-3, tmax, active_mask=active)
        tm_eff = qt._ray_inputs(o, d, tmax, active)[2]
        _, sub_ms = host_ms(qt._intersect_quad_plain, o[sub].contiguous(),
                            d[sub].contiguous(), tm_eff[sub], *scene_args)
        # The full set contains the strided subset: gate on every ray.
        counts = new_counts(o)
        ref, plain_ms = host_ms(qt._intersect_quad_plain, o, d, tm_eff,
                                *scene_args, counts)
        max_dt = gate_closest(f"K1 {name}", (got.t, got.tri, got.u, got.v),
                              ref)
        ms = cuda_ms(lambda: qt.intersect_quad(o, d, ds, 1e-3, tmax,
                                               active_mask=active), 5)
        log(f"phase 2: closest {name}: {inactive_share(tm_eff):.4f} of the "
            f"lanes inactive, {int((got.tri >= 0).sum())} of {n} rays hit; "
            f"all {n} rays equal to the plain version (t, tri, u, v); "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on {n} rays, plain "
            f"{sub_ms:.1f} ms on the {sub.numel()}-ray subset")
        report[f"closest_{name}"] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=max_dt,
            **walk_bound(ds, ds.qnodes, n, CLOSEST_RAY_BYTES, counts,
                         leaf_tests(ds, quad_walk(ds, o, d, True), o, d,
                                    tm_eff), "quad", "closest"))
        log_walk_bound(f"closest {name}", report[f"closest_{name}"],
                       (ds.qnodes, ds.qmeta, ds.ptris), counts, "quad",
                       "closest")

    for name in ("shadow", "shadow_inactive"):
        o, d, tmax, skip, active = sets[name]
        got = qt.occlusion_quad(o, d, 1e-3, tmax, ds, skip,
                                active_mask=active)
        tm_eff = qt._ray_inputs(o, d, tmax, active)[2]
        _, sub_ms = host_ms(qt._occlusion_quad_plain, o[sub].contiguous(),
                            d[sub].contiguous(), tm_eff[sub], skip[sub],
                            *scene_args)
        counts = new_counts(o)
        ref, plain_ms = host_ms(qt._occlusion_quad_plain, o, d, tm_eff, skip,
                                *scene_args, counts)
        mism = int((got != ref).sum())
        ms = cuda_ms(lambda: qt.occlusion_quad(o, d, 1e-3, tmax, ds, skip,
                                               active_mask=active), 5)
        log(f"phase 2: occlusion {name}: {inactive_share(tm_eff):.4f} of "
            f"the lanes inactive, {int(got.sum())} occluded; all {n} rays "
            f"vs plain: mism {mism}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms on {n} rays, plain {sub_ms:.1f} ms on the "
            f"{sub.numel()}-ray subset")
        if mism:
            raise RuntimeError(f"occlusion kernel != plain version ({name})")
        report[f"occlusion_{name}"] = dict(
            ms=ms, plain_ms=plain_ms,
            max_abs_err=float((got.int() - ref.int()).abs().max()),
            **walk_bound(ds, ds.qnodes, n, ANY_RAY_BYTES, counts,
                         leaf_tests(ds, quad_walk(ds, o, d, False), o, d,
                                    tm_eff, skip), "quad_fixed", "any"))
        log_walk_bound(f"occlusion {name}", report[f"occlusion_{name}"],
                       (ds.qnodes, ds.qmeta, ds.ptris), counts, "quad_fixed",
                       "any")
    phase2_launch_info(ds)
    report.update(phase2_binary(ds, sets))
    return report


def log_walk_bound(what, r, arrays, counts, node, tri, phase="phase 2",
                   counter_bytes=0):
    """A persistent kernel's bound on one set, beside bound() of the same
    walk, which counts every slot of each leaf row visited and reads the
    tree's `arrays` whole (qmeta or ometa too): the bound given for the
    one-thread-per-ray design (with `counter_bytes` a ray, L1's and L9's
    counters)."""
    whole = bound(WIDTH * HEIGHT, counter_bytes + (
        ANY_RAY_BYTES if tri == "any" else CLOSEST_RAY_BYTES), arrays,
        counts, node, tri)
    log(f"{phase}: bound {what}: {r['bound_ms']:.4f} ms ({r['bound_by']}: "
        f"{r['bytes']} B, {r['ops']} FP32 operations); every slot of each "
        f"row visited: {whole['bound_ms']:.4f} ms ({whole['ops']} "
        f"operations)")


def inactive_share(t_max, t_min=1e-3):
    """The share of lanes whose t_max leaves them inactive (<= t_min)."""
    return float((t_max <= t_min).float().mean())


def phase2_launch_info(ds):
    """K1-K4 as launched on this card: registers and ptxas spills, local
    memory, dynamic shared memory, resident blocks a SM, the persistent
    grid, G and the refill threshold; K3/K4 also at the largest stack need
    the port accepts (STACK_CAP)."""
    from raytracer_tpu_torch.ops import _build
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    for label, stem, info, needs in (
            ("K1/K2", "libquad_traverse",
             lambda kernel, _: qt.launch_info(kernel, ds),
             (ds.q_stack_need,)),
            ("K3/K4", "libbinary_traverse",
             lambda kernel, need: bt.launch_info(kernel, ds, need),
             (bt.stack_need(ds), bt.STACK_CAP))):
        ptxas = _build.build_info.get(stem, {}).get("log", "")
        for kernel in ("closest", "occlusion"):
            for need in needs:
                i = info(kernel, need)
                st, ld = _build.ptxas_spills(ptxas, f"{kernel}_kernel")
                log(f"phase 2: {label} {kernel}_kernel: {i['registers']} "
                    f"registers, spill stores {st} B, spill loads {ld} B, "
                    f"local {i['local_bytes']} B a thread, dynamic shared "
                    f"{i['smem_bytes']} B a block (stack need {need}), "
                    f"{i['blocks_per_sm']} blocks of 128 a SM "
                    f"({4 * i['blocks_per_sm']} warps), grid {i['grid']} "
                    f"blocks on {i['sms']} SMs; G = {i['group']}, refill at "
                    f"{i['refill_at']} idle lanes")


# Phase 2's K3 and K4 runs: (report name, ray set, t_min). The t_min of
# 0.01 is one that makes the renderer fall back to accel="bvh".
BINARY_CLOSEST_RUNS = (("primary", "primary", 1e-3),
                       ("incoherent", "incoherent", 1e-3),
                       ("incoherent_inactive", "incoherent_inactive", 1e-3),
                       ("primary_tmin", "primary", 0.01))
BINARY_SHADOW_RUNS = (("shadow", "shadow", 1e-3),
                      ("shadow_inactive", "shadow_inactive", 1e-3),
                      ("shadow_tmin", "shadow", 0.01))
OTHER_T_MIN = 0.01


def phase2_binary(ds, sets):
    """K3/K4 against their plain versions on the same rays (bit equality),
    at t_min 1e-3 and OTHER_T_MIN, and once more at the largest stack need
    (STACK_CAP, over 48 KB of shared memory a block) on the primary and
    shadow sets; at t_min 1e-3 also against K1/K2 (the other tree)."""
    import torch

    from raytracer_tpu_torch.lab.rays import cuda_ms, host_ms
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    n = WIDTH * HEIGHT
    device = ds.device
    report = {}
    scene_args = (ds.binary_root, ds.pnodes, ds.ptris)
    arrays = (ds.pnodes, ds.ptris)
    tmax = torch.full((n,), 1e4, device=device)
    for name, set_name, t_min in BINARY_CLOSEST_RUNS:
        o, d, active = sets[set_name]
        got = bt.intersect_bvh_binary(o, d, ds, t_min, tmax,
                                      active_mask=active)
        tm_eff = qt._ray_inputs(o, d, tmax, active, t_min)[2]
        counts = new_counts(o)
        ref, plain_ms = host_ms(bt._intersect_binary_plain, o, d, tm_eff,
                                t_min, *scene_args, counts)
        max_dt = gate_closest(f"K3 {name}", (got.t, got.tri, got.u, got.v),
                              ref)
        ms = cuda_ms(lambda: bt.intersect_bvh_binary(
            o, d, ds, t_min, tmax, active_mask=active), 5)
        log(f"phase 2: binary closest {name} (t_min {t_min}): "
            f"{inactive_share(tm_eff, t_min):.4f} of the lanes inactive, "
            f"{int(got.hit.sum())} of {n} rays hit; all {n} rays equal to "
            f"the plain version (t, tri, u, v); kernel {ms:.3f} ms, plain "
            f"{plain_ms:.1f} ms on {n} rays")
        if name == "primary":
            deep = bt._intersect_binary_cuda(o, d, tm_eff, t_min, ds,
                                             need=bt.STACK_CAP)
            deep_ms = cuda_ms(lambda: bt._intersect_binary_cuda(
                o, d, tm_eff, t_min, ds, need=bt.STACK_CAP), 5)
            gate_closest(f"K3 {name} at stack need {bt.STACK_CAP}", deep,
                         ref)
            log(f"phase 2: binary closest {name} at stack need "
                f"{bt.STACK_CAP} ({bt.STACK_CAP * 128 * 4} B of shared "
                f"memory a block): all {n} rays equal to the plain version; "
                f"kernel {deep_ms:.3f} ms")
        if t_min == 1e-3:
            quad = qt.intersect_quad(o, d, ds, 1e-3, tmax,
                                     active_mask=active)
            flips = int((got.hit != quad.hit).sum())
            both = got.hit & quad.hit
            tri_diff = int((both & (got.tri != quad.tri)).sum())
            dt_both = float((got.t - quad.t).abs()[both].max())
            log(f"phase 2: binary vs quad closest {name}: {flips} hit "
                f"flips, {tri_diff} triangle differences of {n} rays, "
                f"max|dt| on common hits {dt_both}")
            if flips + tri_diff > TREE_AGREEMENT * n:
                raise RuntimeError(f"K3 and K1 disagree beyond "
                                   f"{TREE_AGREEMENT} of the rays ({name})")
        report[f"binary_closest_{name}"] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=max_dt,
            **walk_bound(ds, ds.pnodes, n, CLOSEST_RAY_BYTES, counts,
                         leaf_tests(ds, binary_walk(ds, o, d, t_min), o, d,
                                    tm_eff, t_min=t_min), "binary",
                         "closest"))
        log_walk_bound(f"binary closest {name}",
                       report[f"binary_closest_{name}"], arrays, counts,
                       "binary", "closest")

    for name, set_name, t_min in BINARY_SHADOW_RUNS:
        o, d, tmax_s, skip, active = sets[set_name]
        got = bt.occlusion_bvh_binary(o, d, t_min, tmax_s, ds, skip,
                                      active_mask=active)
        tm_eff = qt._ray_inputs(o, d, tmax_s, active, t_min)[2]
        counts = new_counts(o)
        ref, plain_ms = host_ms(bt._occlusion_binary_plain, o, d, tm_eff,
                                skip, t_min, *scene_args, counts)
        gate_equal(f"K4 {name}", (got,), (ref,))
        ms = cuda_ms(lambda: bt.occlusion_bvh_binary(
            o, d, t_min, tmax_s, ds, skip, active_mask=active), 5)
        log(f"phase 2: binary occlusion {name} (t_min {t_min}): "
            f"{inactive_share(tm_eff, t_min):.4f} of the lanes inactive, "
            f"{int(got.sum())} occluded; all {n} rays equal to the plain "
            f"version; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on {n} "
            "rays")
        if name == "shadow":
            deep = bt._occlusion_binary_cuda(o, d, tm_eff, skip, t_min, ds,
                                             need=bt.STACK_CAP)
            deep_ms = cuda_ms(lambda: bt._occlusion_binary_cuda(
                o, d, tm_eff, skip, t_min, ds, need=bt.STACK_CAP), 5)
            gate_equal(f"K4 {name} at stack need {bt.STACK_CAP}", (deep,),
                       (ref,))
            log(f"phase 2: binary occlusion {name} at stack need "
                f"{bt.STACK_CAP}: all {n} rays equal to the plain version; "
                f"kernel {deep_ms:.3f} ms")
        if t_min == 1e-3:
            quad = qt.occlusion_quad(o, d, 1e-3, tmax_s, ds, skip,
                                     active_mask=active)
            vs_quad = int((got != quad).sum())
            log(f"phase 2: binary vs quad occlusion {name}: {vs_quad} of "
                f"{n} rays differ")
            if vs_quad > TREE_AGREEMENT * n:
                raise RuntimeError(f"K4 and K2 disagree beyond "
                                   f"{TREE_AGREEMENT} of the rays ({name})")
        report[f"binary_occlusion_{name}"] = dict(
            ms=ms, plain_ms=plain_ms,
            max_abs_err=float((got.int() - ref.int()).abs().max()),
            **walk_bound(ds, ds.pnodes, n, ANY_RAY_BYTES, counts,
                         leaf_tests(ds, binary_walk(ds, o, d, t_min), o, d,
                                    tm_eff, skip, t_min), "binary", "any"))
        log_walk_bound(f"binary occlusion {name}",
                       report[f"binary_occlusion_{name}"], arrays, counts,
                       "binary", "any")
    return report


def gate_closest(what, got, ref):
    """Raise unless a closest-hit kernel's (t, tri, u, v) equal its plain
    version's on every ray; returns max |dt| (0.0)."""
    import torch

    t, tri, u, v = got
    hit_mism = int(((tri >= 0) != (ref[1] >= 0)).sum())
    tri_mism = int((tri != ref[1]).sum())
    max_dt = float((t - ref[0]).abs().max())
    uv_equal = bool(torch.equal(u, ref[2]) and torch.equal(v, ref[3]))
    if hit_mism or tri_mism or max_dt != 0.0 or not uv_equal:
        raise RuntimeError(f"{what}: kernel != plain version (hit_mism "
                           f"{hit_mism}, tri_mism {tri_mism}, max|dt| "
                           f"{max_dt}, uv_equal {uv_equal})")
    return max_dt


def main_path(scene_fn, device, label, accel):
    """ProgressiveRenderer with `accel` on the atrium at 1920x1080: 2 warm
    and 4 timed frames, with every launch count set to 0 just before and
    read just after; then the atrium at 64x64, 2 frames, on the card
    against the CPU. Returns (launch counts, the 1080p image, ms/frame)."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.utils.config import RenderConfig

    cfg = RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3, accel=accel)
    cam, _ = bench_camera_ubo(device, WIDTH, HEIGHT)
    t0 = time.perf_counter()
    r = ProgressiveRenderer(scene_fn(), cam, cfg, device=device)
    torch.cuda.synchronize()
    log(f"{label}: accel={r.config.accel}, bake "
        f"{time.perf_counter() - t0:.2f} s "
        f"({r.device_scene.num_triangles} triangles, qnodes "
        f"{r.device_scene.qnodes.numel() * 4} B, pnodes "
        f"{r.device_scene.pnodes.numel() * 4} B, ptris "
        f"{r.device_scene.ptris.numel() * 4} B, depth "
        f"{r.device_scene.bvh_max_depth})")
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    times, rays = [], []
    for f in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if f >= 2:
            times.append(dt)
            rays.append(int(r.last_stats["total_rays"]))
        log(f"  frame {f} {'warm' if f < 2 else 'timed'}: {dt * 1e3:.1f} ms, "
            f"{int(r.last_stats['rays_traced'])} traced + "
            f"{int(r.last_stats['shadow_rays'])} shadow rays")
    launches = all_launch_counts()
    ms = 1e3 * sum(times) / len(times)
    mrays = sum(rays) / sum(times) / 1e6
    peak = torch.cuda.max_memory_allocated()
    img = r.image()
    per_frame = {k: v / 6 for k, v in launches.items()}
    log(f"{label}: {ms:.1f} ms/frame, {sum(rays) // len(rays)} rays/frame, "
        f"{mrays:.2f} Mrays/s, peak device memory {peak} B, kernel "
        f"launches {launches} in 6 frames ({per_frame} per frame), image "
        f"mean {float(img.mean()):.5f}")
    if not np.isfinite(img).all() or not img.mean() > 0:
        raise RuntimeError(f"{label}: image is not finite and non-black")
    if launches["light_select"] != SELECT_PER_FRAME * 6:
        raise RuntimeError(f"{label}: {launches['light_select']} light "
                           f"selection launches in 6 frames, want "
                           f"{SELECT_PER_FRAME} a frame")

    # Card vs CPU (the plain versions) at 64x64, 2 frames.
    small = {}
    for dev in (device, "cpu"):
        c, _ = bench_camera_ubo(dev, 64, 64)
        small[str(dev)] = ProgressiveRenderer(
            scene_fn(), c, RenderConfig(width=64, height=64, max_depth=3,
                                        accel=accel),
            device=dev).render(2)
    a, b = small[str(device)], small["cpu"]
    flipped = np.abs(a - b).max(axis=-1) > PIXEL_ATOL
    log(f"{label}: 64x64 x2 frames card vs CPU: {int(flipped.sum())} "
        f"flipped pixels of {flipped.size}, max |diff| "
        f"{float(np.abs(a - b).max()):.3g}")
    if flipped.mean() > MAX_FLIPPED:
        raise RuntimeError(f"{label}: card and CPU renders differ beyond "
                           "tolerance")
    return launches, img, ms


def phase3(scene_fn, device):
    launches, img, ms = main_path(scene_fn, device, "phase 3", "auto")
    if not (launches["quad_closest"] > 0 and launches["quad_occlusion"] > 0):
        raise RuntimeError(f"a kernel was not launched: {launches}")
    return launches, img, ms


def phase5(scene_fn, device, cuda_img):
    import numpy as np

    launches, img, _ = main_path(scene_fn, device, "phase 5", "bvh")
    if not (launches["binary_closest"] > 0
            and launches["binary_occlusion"] > 0):
        raise RuntimeError(f"a binary kernel was not launched: {launches}")
    if launches["quad_closest"] or launches["quad_occlusion"]:
        raise RuntimeError(f"accel='bvh' launched a quad kernel: {launches}")
    flipped = np.abs(img - cuda_img).max(axis=-1) > PIXEL_ATOL
    log(f"phase 5: 1080p accel=bvh vs accel=cuda after the same frames: "
        f"{int(flipped.sum())} flipped pixels of {flipped.size}, max |diff| "
        f"{float(np.abs(img - cuda_img).max()):.3g}")
    if flipped.mean() > MAX_FLIPPED:
        raise RuntimeError("accel='bvh' and accel='cuda' images differ "
                           "beyond tolerance")
    return launches


def lab_launch_counts():
    from raytracer_tpu_torch.lab import bvh4_lab, kernel_lab, occl_lab

    return {"lab_closest": kernel_lab.closest_launches,
            "lab_closest_ts": kernel_lab.closest_ts_launches,
            "lab_occlusion": occl_lab.occlusion_launches,
            "lab_closest4": bvh4_lab.closest4_launches}


def reset_lab_launch_counts():
    from raytracer_tpu_torch.lab import bvh4_lab, kernel_lab, occl_lab

    for mod in (kernel_lab, occl_lab, bvh4_lab):
        mod.reset_launch_counts()


def gate_equal(what, got, ref):
    """Raise unless every output tensor of a kernel equals its plain
    version's; returns max |got - ref| over them (0.0)."""
    import torch

    for g, r in zip(got, ref, strict=True):
        if not torch.equal(g, r):
            raise RuntimeError(f"{what}: kernel != plain version")
    return max(float((g.double() - r.double()).abs().max()) if g.numel()
               else 0.0 for g, r in zip(got, ref))


def phase6(device):
    """The traversal lab: its runs (the launch counts; L1 with K3 and L9
    with K4 timed on the same sets), then each kernel against its plain
    version, L1 base against K3, L9 lean against K4's mask and L2 ordered
    against K1, the persistent kernels' launch shapes (no local memory, no
    spills) and their bounds on the triangles they test. Returns the four
    kernels' report entries."""
    import torch

    from raytracer_tpu_torch.lab import bvh4_lab, kernel_lab, occl_lab
    from raytracer_tpu_torch.lab import queue_walk as qw
    from raytracer_tpu_torch.lab import rays as lab_rays
    from raytracer_tpu_torch.ops import binary_traverse as bt

    plog = lambda m: log(f"phase 6: {m}")  # noqa: E731
    t0 = time.perf_counter()
    ds16 = lab_rays.atrium(kernel_lab.LEAF_SIZE, device)
    ds8 = lab_rays.atrium(occl_lab.LEAF_SIZE, device)
    closest16 = lab_rays.closest_sets(ds16)
    closest8 = lab_rays.closest_sets(ds8)
    shadow8 = lab_rays.shadow_sets(ds8)
    torch.cuda.synchronize()
    plog(f"two bakes (leaf 16: {ds16.pnodes.shape[0]} binary internal nodes, "
         f"depth {ds16.bvh_max_depth}; leaf 8: {ds8.pnodes.shape[0]}, depth "
         f"{ds8.bvh_max_depth}, {ds8.qnodes.shape[0]} quad nodes) and ray "
         f"sets in {time.perf_counter() - t0:.2f} s; live rays: "
         + ", ".join(f"{k} {int((v[2] > 1e-3).sum())}"
                     for k, v in {**closest16, **shadow8}.items()))
    plog(f"card: {lab_rays.card_line()}")

    reset_lab_launch_counts()
    kres = kernel_lab.run(ds16, closest16, log=plog)
    ores = occl_lab.run(ds8, shadow8, log=plog)
    bres = bvh4_lab.run(ds8, closest8, log=plog)
    launches = lab_launch_counts()
    plog(f"lab launch counts {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a lab kernel was not launched: {launches}")

    t0 = time.perf_counter()
    report = {name: dict(max_abs_err=0.0) for name in launches}

    def keep(name, err, plain_ms=None):
        entry = report[name]
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if plain_ms is not None:
            entry["plain_ms"] = plain_ms

    # L1 and L9 count their own visits (gated here against their plain
    # versions'); the plain versions' leaf hooks count the triangles they
    # test (leafilp's ILP leaf: every slot of each row it visits).
    tests = {}
    leaf16 = ds16.ptris.shape[1] // 12
    for label, (o, d, tm) in closest16.items():
        for plain_variant in ("nored", "leafilp", "pop2", "pop4"):
            leaf_test, _, total = counting_leaf_tests()
            ref, plain_ms = lab_rays.host_ms(
                kernel_lab.closest_lab_plain, o, d, tm, ds16.binary_root,
                ds16.pnodes, ds16.ptris, plain_variant,
                None if plain_variant == "leafilp" else leaf_test)
            tested = (int(ref[5].sum()) * leaf16
                      if plain_variant == "leafilp" else total[0])
            names = [plain_variant]
            if plain_variant == "nored":
                names = ["base", "nored"]
                for block in kernel_lab.BLOCKS:
                    err = gate_equal(f"lab_closest_ts {label} {block}",
                                     kres[(label, f"ts{block}")]["out"], ref)
                    keep("lab_closest_ts", err,
                         plain_ms if label == "bounce1" else None)
                    tests[(label, f"ts{block}")] = tested
            for name in names:
                err = gate_equal(f"lab_closest {label} {name}",
                                 kres[(label, name)]["out"], ref)
                keep("lab_closest", err, plain_ms
                     if (label, name) == ("bounce1", "base") else None)
                tests[(label, name)] = tested
            plog(f"lab_closest {label} {'/'.join(names)}: equal to the "
                 f"plain version on all {o.shape[0]} rays (t, tri, u, v, "
                 f"nvisit, nleaf); plain {plain_ms:.1f} ms")
        # L1 base takes K3's steps in K3's order on K3's machinery.
        gate_equal(f"lab_closest {label} base vs K3",
                   kres[(label, "base")]["out"][:4],
                   kres[(label, "k3")]["out"])
        plog(f"lab_closest {label} base: equal to K3 on all {o.shape[0]} "
             f"rays (t, tri, u, v); K3 {kres[(label, 'k3')]['ms']:.3f} ms")

    for label, (o, d, tm, skip, _) in shadow8.items():
        args = (ds8.binary_root, ds8.pnodes, ds8.ptris)
        for variant in occl_lab.VARIANTS:
            ordered = variant != "noorder"
            _, any_hit, total = counting_leaf_tests()
            if variant == "resort":
                perm = occl_lab.resort_perm(o, tm, ds8)
                got_p, plain_ms = lab_rays.host_ms(
                    occl_lab.occl_lab_plain, o[perm], d[perm], tm[perm],
                    skip[perm], *args, ordered, any_hit)
                ref = tuple(torch.empty_like(g) for g in got_p)
                for dst, src in zip(ref, got_p):
                    dst[perm] = src
            else:
                ref, plain_ms = lab_rays.host_ms(occl_lab.occl_lab_plain, o, d,
                                            tm, skip, *args, ordered, any_hit)
            tests[(label, variant)] = total[0]
            err = gate_equal(f"lab_occlusion {label} {variant}",
                             ores[(label, variant)]["out"], ref)
            keep("lab_occlusion", err, plain_ms
                 if (label, variant) == ("shadow_b1", "lean") else None)
            plog(f"lab_occlusion {label} {variant}: equal to the plain "
                 f"version on all {o.shape[0]} rays (occ, nvisit, nleaf); "
                 f"plain {plain_ms:.1f} ms")
        # L9 lean takes K4's steps in K4's order on K4's machinery.
        gate_equal(f"lab_occlusion {label} lean vs K4",
                   ores[(label, "lean")]["out"][:1],
                   ores[(label, "k4")]["out"])
        plog(f"lab_occlusion {label} lean: equal to K4's mask on all "
             f"{o.shape[0]} rays; K4 {ores[(label, 'k4')]['ms']:.3f} ms")

    n = lab_rays.WIDTH * lab_rays.HEIGHT
    for label, (o, d, tm) in closest8.items():
        live = max(int((tm > 1e-3).sum()), 1)
        for order in bvh4_lab.ORDERS:
            # The kernel has no counters; its plain version counts the
            # same walk's pops, and the triangles it tests.
            counts = new_counts(o)
            leaf_test, _, total = counting_leaf_tests()
            ref, plain_ms = lab_rays.host_ms(
                bvh4_lab.closest4_plain, o, d, tm, ds8.root, ds8.qmeta,
                ds8.qnodes, ds8.ptris, order == "ordered", counts,
                leaf_test)
            r = bres[(label, order)]
            r["counts"], r["tests"] = counts, total[0]
            err = gate_equal(f"lab_closest4 {label} {order}", r["out"], ref)
            keep("lab_closest4", err, plain_ms
                 if (label, order) == ("bounce1", "ordered") else None)
            visits, leaves = (int(c.sum()) for c in counts)
            plog(f"lab_closest4 {label} {order}: equal to the plain version "
                 f"on all {o.shape[0]} rays (t, tri, u, v); plain "
                 f"{plain_ms:.1f} ms; vs K1 {r['flips']} hit flips, "
                 f"{r['tri_diff']} triangle differences; 4-wide walk "
                 f"{visits / live:.3f} visits/ray, {leaves / live:.3f} of "
                 f"them leaves")
            if r["flips"] + r["tri_diff"] > TREE_AGREEMENT * n:
                raise RuntimeError(f"L2 and K1 disagree beyond "
                                   f"{TREE_AGREEMENT} of the rays ({label}, "
                                   f"{order})")
        # L2 ordered takes K1's steps in K1's order on K1's machinery.
        gate_equal(f"lab_closest4 {label} ordered vs K1",
                   bres[(label, "ordered")]["out"], bres[(label, "k1")]["out"])
        plog(f"lab_closest4 {label} ordered: equal to K1 on all "
             f"{o.shape[0]} rays (t, tri, u, v)")
        # The binary walk on the same (leaf-8) bake, for the two trees side
        # by side.
        b = kernel_lab.run_closest_lab(o, d, tm, ds8, "base")
        b_ms = lab_rays.cuda_ms(
            lambda: kernel_lab.run_closest_lab(o, d, tm, ds8, "base"), 5)
        plog(f"trees on the leaf-8 bake, {label}: binary L1 {b_ms:.3f} ms, "
             f"{int(b[4].sum()) / live:.3f} visits/ray, "
             f"{int(b[5].sum()) / live:.3f} of them leaves; 4-wide K1 "
             f"{bres[(label, 'k1')]['ms']:.3f} ms (counts above)")
    plog(f"kernels vs plain versions in {time.perf_counter() - t0:.1f} s")

    need16, need8 = bt.stack_need(ds16), bt.stack_need(ds8)
    launch_shapes_gate(
        [(f"closest4_{order}", ds8.q_stack_need)
         for order in bvh4_lab.ORDERS]
        + [(qw.l1_kernel(v, leaf16), kernel_lab.stack_need(ds16, v))
           for v in kernel_lab.VARIANTS]
        + [(qw.l1_kernel("nored", block=b), need16)
           for b in kernel_lab.BLOCKS]
        + [(f"lab_occlusion_{order}", need8)
           for order in ("ordered", "noorder")], device)
    l2_bounds = lab4_bounds(ds8, closest8, bres, bvh4_lab.ORDERS,
                            "lab_closest4", "L2", "phase 6")
    l1_bounds = lab_binary_bounds(ds16, kres, tests, closest16, "closest",
                                  "lab_closest", "L1")
    l9_bounds = lab_binary_bounds(ds8, ores, tests, shadow8, "any",
                                  "lab_occlusion", "L9")

    for name, r, b in (
            ("lab_closest", kres[("bounce1", "base")],
             l1_bounds[("bounce1", "base")]),
            ("lab_closest_ts", kres[("bounce1", "ts128")],
             l1_bounds[("bounce1", "ts128")]),
            ("lab_occlusion", ores[("shadow_b1", "lean")],
             l9_bounds[("shadow_b1", "lean")])):
        report[name].update(ms=r["ms"], launches=launches[name], **b)
    report["lab_closest4"].update(
        ms=bres[("bounce1", "ordered")]["ms"],
        launches=launches["lab_closest4"],
        **l2_bounds[("bounce1", "ordered")])
    return report


def lab4_bounds(ds, sets, res, variants, name, label, phase):
    """The bound of L2 (`variants` its orders) or L6 (its (descent, divfree,
    leafpar) combinations) on each closest-hit set of `sets`, counted on
    the triangles they test and on live rays' bytes (walk_bound, 112 B a
    qnodes row) from the steps and tests the runs `res` hold ("counts",
    "tests"), each logged beside bound() (every slot of each leaf row
    visited, qmeta read) and beside the run's ms. Returns {(set, variant):
    bound}."""
    from raytracer_tpu_torch.lab import r3_kernel_lab

    bounds = {}
    for set_label in sets:
        for variant in variants:
            r = res[(set_label, variant)]
            if r.get("tests") is None:
                continue
            ordered = variant == "ordered" or isinstance(variant, tuple)
            node = "quad" if ordered else "quad_fixed"
            b = bounds[(set_label, variant)] = walk_bound(
                ds, ds.qnodes, WIDTH * HEIGHT, CLOSEST_RAY_BYTES,
                r["counts"], r["tests"], node, "closest")
            what = (f"{set_label} {variant}" if isinstance(variant, str)
                    else f"{set_label} {r3_kernel_lab.name(*variant)}")
            log_walk_bound(f"{name} {what}", b,
                           (ds.qnodes, ds.qmeta, ds.ptris), r["counts"],
                           node, "closest", phase=phase)
            log(f"{phase}: {label} {what}: {r['ms']:.3f} ms against a bound "
                f"of {b['bound_ms']:.4f} ms, "
                f"{100 * b['bound_ms'] / r['ms']:.2f}% of the bound")
    return bounds


def lab_binary_bounds(ds, res, tests, sets, tri, name, label,
                      phase="phase 6", counters=True):
    """The bound of L1, L4 or L5 (tri "closest") or L9 ("any") on each set
    of `sets` and each variant (and L1b block) of the runs `res`, counted on
    the triangles the plain versions tested (`tests`, keyed (set, variant))
    and on live rays' bytes with their counters (walk_bound, 64 B a pnodes
    row), from the kernels' own counters; each logged beside bound() (every
    slot of each leaf row visited) and beside the run's ms. Without
    `counters` (L5) the steps are the plain version's ("counts") and no
    counter bytes are written. Returns {(set, variant): bound}."""
    ray_bytes = CLOSEST_RAY_BYTES if tri == "closest" else ANY_RAY_BYTES
    counter_bytes = COUNTER_BYTES if counters else 0
    bounds = {}
    for key, tested in tests.items():
        if key[0] not in sets:
            continue
        r = res[key]
        counts = r["out"][-2:] if counters else r["counts"]
        b = bounds[key] = walk_bound(ds, ds.pnodes, WIDTH * HEIGHT, ray_bytes,
                                     counts, tested, "binary", tri,
                                     counter_bytes=counter_bytes)
        what = f"{key[0]} {key[1]}"
        log_walk_bound(f"{name} {what}", b, (ds.pnodes, ds.ptris), counts,
                       "binary", tri, phase=phase,
                       counter_bytes=counter_bytes)
        log(f"{phase}: {label} {what}: {r['ms']:.3f} ms against a bound of "
            f"{b['bound_ms']:.4f} ms, {100 * b['bound_ms'] / r['ms']:.2f}% "
            "of the bound")
    return bounds


def launch_shapes_gate(kernels, device):
    """Each persistent lab kernel of `kernels` ((queue_walk.launch_info
    key, stack need) pairs) runs on `device` without local memory and
    without ptxas spills (the lab runs print each launch shape)."""
    from raytracer_tpu_torch.lab import queue_walk as qw

    for kernel, need in kernels:
        i = qw.launch_info(kernel, need, device)
        if i["local_bytes"] or i["spills"] not in ((0, 0), ("?", "?")):
            raise RuntimeError(f"{kernel}: {i['local_bytes']} B of local "
                               f"memory a thread, spills {i['spills']}")


def lab2_modules():
    from raytracer_tpu_torch.lab import (
        r3_kernel_lab,
        v2_kernel_lab,
        v3_kernel_lab,
        v4_interleave_lab,
    )

    return {"lab_closest_cm": v2_kernel_lab,
            "lab_closest_queued": v3_kernel_lab,
            "lab_closest_pair": v4_interleave_lab,
            "lab_closest4_queued": r3_kernel_lab}


def phase7(device):
    """The deferred-leaf and component-major labs: their runs (the launch
    counts; K3 and L1 base/leafilp timed beside L3 and L4 on the same
    sets), then each kernel against its plain version, the identities, L3
    against K3 (t on every ray, triangles only at ties) and the agreement
    with K3/K1, the persistent kernels' launch shapes (no local memory, no
    spills) and their bounds on the triangles they test. Returns the four
    kernels' report entries."""
    import torch

    from raytracer_tpu_torch.lab import queue_walk as qw
    from raytracer_tpu_torch.lab import rays as lab_rays
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    mods = lab2_modules()
    v2, v3 = mods["lab_closest_cm"], mods["lab_closest_queued"]
    v4, r3 = mods["lab_closest_pair"], mods["lab_closest4_queued"]
    plog = lambda m: log(f"phase 7: {m}")  # noqa: E731
    t0 = time.perf_counter()
    ds = lab_rays.atrium(v3.LEAF_SIZE, device)
    sets = lab_rays.closest_sets(ds)
    torch.cuda.synchronize()
    plog(f"leaf-8 bake ({ds.pnodes.shape[0]} binary internal nodes, depth "
         f"{ds.bvh_max_depth}; {ds.qnodes.shape[0]} quad nodes) and ray sets "
         f"in {time.perf_counter() - t0:.2f} s; live rays: "
         + ", ".join(f"{k} {int((v[2] > 1e-3).sum())}"
                     for k, v in sets.items()))
    plog(f"card: {lab_rays.card_line()}")
    combos = r3.ALL + r3.LEAFPAR[1:]

    for mod in mods.values():
        mod.reset_launch_counts()
    res = {"lab_closest_cm": v2.run(ds, sets, log=plog),
           "lab_closest_queued": v3.run(ds, sets, log=plog),
           "lab_closest_pair": v4.run(ds, sets, log=plog),
           "lab_closest4_queued": r3.run(ds, sets, combos, log=plog)}
    launches = {name: mod.closest_launches for name, mod in mods.items()}
    plog(f"lab launch counts {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a lab kernel was not launched: {launches}")
    cm, q = res["lab_closest_cm"], res["lab_closest_queued"]
    for label in sets:
        k3_ms = cm[(label, "k3")]["ms"]
        times = [("L1 base", cm[(label, "l1_base")]["ms"]),
                 ("L1 leafilp", cm[(label, "l1_leafilp")]["ms"]),
                 ("L3", cm[(label, "v2")]["ms"]),
                 *((f"L4 {v}", q[(label, v)]["ms"]) for v in v3.VARIANTS)]
        plog(f"leaf-8 yardsticks {label}: K3 {k3_ms:.3f} ms; " + ", ".join(
            f"{what} {ms:.3f} ms ({ms / k3_ms:.2f}x K3)"
            for what, ms in times))

    t0 = time.perf_counter()
    ptris_cm = v2.to_component_major(ds.ptris)
    # Each plain version takes zeroed counters `c` (L4's returns its own)
    # and counts its walk's visits or steps, and a leaf hook `lt` where it
    # counts the triangles it tests: the kernels but L4's have no
    # counters, and take the same walk.
    plain = {
        "lab_closest_cm": [(
            "v2", lambda o, d, tm, c, lt=v2._cm_leaf: v2.closest_v2_plain(
                o, d, tm, ds.binary_root, ds.pnodes, ptris_cm, counts=c,
                leaf_test=lt))],
        "lab_closest_queued": [
            (var, lambda o, d, tm, c, lt=qt._serial_leaf, var=var:
             v3.closest_v3_plain(o, d, tm, ds.binary_root, ds.pnodes,
                                 ds.ptris, qw.DRAIN_AT, var, leaf_test=lt))
            for var in v3.VARIANTS],
        "lab_closest_pair": [
            (var, lambda o, d, tm, c, lt=qt._serial_leaf, var=var:
             v4.closest_v4_plain(o, d, tm, ds.binary_root, ds.pnodes,
                                 ds.ptris, var, counts=c, leaf_test=lt))
            for var in v4.VARIANTS],
        "lab_closest4_queued": [
            (combo, lambda o, d, tm, c, lt=None, combo=combo:
             r3.closest_variant_plain(o, d, tm, ds.root, ds.qmeta, ds.qnodes,
                                      ds.ptris, *combo, counts=c,
                                      leaf_test=lt))
            for combo in combos],
    }
    # L4, L5 and L6's serial combinations count the triangles they test
    # through counting_leaf_tests(), L3 its float4 groups
    # (counting_cm_tests()).
    serial = [c for c in combos if not (c[1] or c[2])]
    counted = ({("lab_closest_queued", v) for v in v3.VARIANTS}
               | {("lab_closest_pair", v) for v in v4.VARIANTS}
               | {("lab_closest4_queued", c) for c in serial})

    report = {name: dict(max_abs_err=0.0) for name in mods}
    n = lab_rays.WIDTH * lab_rays.HEIGHT
    for label, (o, d, tm) in sets.items():
        for name, variants in plain.items():
            for variant, fn in variants:
                counts = new_counts(o)
                r = res[name][(label, variant)]
                if name == "lab_closest_cm":
                    leaf_test, total = counting_cm_tests()
                elif (name, variant) in counted:
                    leaf_test, _, total = counting_leaf_tests()
                else:
                    leaf_test = total = None
                if leaf_test is None:
                    ref, plain_ms = lab_rays.host_ms(fn, o, d, tm, counts)
                else:
                    ref, plain_ms = lab_rays.host_ms(fn, o, d, tm, counts,
                                                     leaf_test)
                    r["tests"] = total[0]
                    if name == "lab_closest_cm":
                        r["count_tests"] = total[1]
                if name == "lab_closest_queued":
                    counts = ref[4:]
                r["counts"] = counts
                err = gate_equal(f"{name} {label} {variant}", r["out"], ref)
                entry = report[name]
                entry["max_abs_err"] = max(entry["max_abs_err"], err)
                if label == "bounce1" and variant == variants[0][0]:
                    entry["plain_ms"] = plain_ms
                vname = (r3.name(*variant) if isinstance(variant, tuple)
                         else variant)
                plog(f"{name} {label} {vname}: equal to the plain version "
                     f"on all {o.shape[0]} rays; plain {plain_ms:.1f} ms; "
                     f"vs the production kernel {r['flips']} hit flips, "
                     f"{r['tri_diff']} triangle differences")
                if name == "lab_closest4_queued" and not any(variant):
                    live = max(int((tm > 1e-3).sum()), 1)
                    nit, nleaf = (int(c.sum()) for c in counts)
                    plog(f"4-wide queued walk {label}: {nit / live:.3f} steps"
                         f"/ray, {nleaf / live:.3f} of them leaf steps")
                if variant != "nocond" and (r["flips"] + r["tri_diff"]
                                            > TREE_AGREEMENT * n):
                    raise RuntimeError(f"{name} {variant} and the production "
                                       f"kernel disagree beyond "
                                       f"{TREE_AGREEMENT} of the rays "
                                       f"({label})")
        p = res["lab_closest_pair"]
        quad = res["lab_closest4_queued"]
        base = q[(label, "base")]["out"]
        gate_equal(f"L4 dblread vs base {label}",
                   q[(label, "dblread")]["out"], base)
        gate_equal(f"L5 switch vs L4 base {label}",
                   p[(label, "switch")]["out"], base[:4])
        for divfree in (False, True):
            gate_equal(f"L6 descent divfree={divfree} {label}",
                       quad[(label, (True, divfree, False))]["out"],
                       quad[(label, (False, divfree, False))]["out"])
        yard = {what: p[(label, key)]["ms"] for what, key in (
            ("L4 base", v4.run_key("l4_base", qw.DRAIN_AT)), ("K3", "k3"),
            ("K1", "k1"))}
        plog(f"L5 yardsticks {label}: " + "; ".join(
            f"{v} {p[(label, v)]['ms']:.3f} ms ("
            + ", ".join(f"{p[(label, v)]['ms'] / ms:.2f}x {what}"
                        for what, ms in yard.items()) + ")"
            for v in v4.VARIANTS)
            + "; " + ", ".join(f"{what} {ms:.3f} ms"
                               for what, ms in yard.items())
            + f", all at drain {qw.DRAIN_AT} in the same run")
        ties = gate_cm_ties(label, cm[(label, "v2")]["out"],
                            cm[(label, "k3")]["out"], ds, o, d)
        plog(f"{label}: L4 dblread = base (counts included), L5 switch = L4 "
             f"base, L6 descent = no descent, on all {o.shape[0]} rays; L3's "
             f"t = K3's on every ray, its triangle differs on {ties} rays, "
             "each a tie at that t")
    plog(f"kernels vs plain versions in {time.perf_counter() - t0:.1f} s")

    need = bt.stack_need(ds)
    launch_shapes_gate([("closest_cm", need)]
                       + [(qw.l4_kernel(v), need) for v in v3.VARIANTS]
                       + [(qw.l5_kernel(v), need) for v in v4.VARIANTS]
                       + [(r3.launch_kernel(*combo), ds.q_stack_need)
                          for combo in combos], device)
    l3_bounds = lab_cm_bounds(ds, sets, cm, ptris_cm)
    l4_bounds = lab_binary_bounds(
        ds, q, {(s, v): q[(s, v)]["tests"] for s in sets
                for v in v3.VARIANTS},
        sets, "closest", "lab_closest_queued", "L4", phase="phase 7")
    p = res["lab_closest_pair"]
    l5_bounds = lab_binary_bounds(
        ds, p, {(s, v): p[(s, v)]["tests"] for s in sets
                for v in v4.VARIANTS},
        sets, "closest", "lab_closest_pair", "L5", phase="phase 7",
        counters=False)
    l6_bounds = lab4_bounds(ds, sets, res["lab_closest4_queued"], serial,
                            "lab_closest4_queued", "L6", "phase 7")
    report["lab_closest_cm"].update(l3_bounds["bounce1"])
    report["lab_closest_queued"].update(l4_bounds[("bounce1", "base")])
    report["lab_closest_pair"].update(l5_bounds[("bounce1", "shared")])
    report["lab_closest4_queued"].update(
        l6_bounds[("bounce1", (False, False, False))])
    for name, key in (("lab_closest_cm", "v2"), ("lab_closest_queued", "base"),
                      ("lab_closest_pair", "shared"),
                      ("lab_closest4_queued", (False, False, False))):
        report[name]["ms"] = res[name][("bounce1", key)]["ms"]
        report[name]["launches"] = launches[name]
    return report


def lab_cm_bounds(ds, sets, cm, ptris_cm):
    """The bound of L3 on each set, counted on the work its function needs
    (walk_bound, 64 B a pnodes row): its plain walk's visits, the triangles
    below each leaf row's count (the tests K3's leaf makes on the same
    walk: the zero padding past the count is never valid, so it changes
    neither t nor the triangle) and CM_TRI_BYTES of each real triangle,
    once. Each is logged beside bound() (every slot of each row visited),
    beside the run's ms and beside the whole float4 groups the kernel
    tests, its extra work. Then what those cost: L1 leafilp's tests past
    the counts (every slot) over L1 base's time on the same walk price a
    test, and L3's time less its extra tests at that price is what it
    would take tested to the counts, beside K3's. Returns {set: bound}."""
    from raytracer_tpu_torch.ops import quad_traverse as qt

    leaf = ptris_cm.shape[1] // 12
    leaf_bytes = int(qt.leaf_counts(ds).sum()) * CM_TRI_BYTES
    bounds = {}
    for label in sets:
        r = cm[(label, "v2")]
        k3, base, ilp = (cm[(label, k)]["ms"]
                         for k in ("k3", "l1_base", "l1_leafilp"))
        b = bounds[label] = walk_bound(
            ds, ds.pnodes, WIDTH * HEIGHT, CLOSEST_RAY_BYTES, r["counts"],
            r["count_tests"], "binary", "cm", leaf_bytes=leaf_bytes)
        log_walk_bound(f"lab_closest_cm {label}", b, (ds.pnodes, ptris_cm),
                       r["counts"], "binary", "cm", phase="phase 7")
        log(f"phase 7: L3 {label}: {r['ms']:.3f} ms against a bound of "
            f"{b['bound_ms']:.4f} ms, {100 * b['bound_ms'] / r['ms']:.2f}% "
            f"of the bound; the function needs {r['count_tests']} triangle "
            f"tests, the kernel makes {r['tests']} in whole float4 groups "
            f"({r['tests'] / max(r['count_tests'], 1):.3f}x)")
        past = int(r["counts"][1].sum()) * leaf - r["count_tests"]
        per_m = (ilp - base) / max(past, 1) * 1e6
        extra = (r["tests"] - r["count_tests"]) * per_m / 1e6
        log(f"phase 7: L3 {label} layout: L1 leafilp's {past} tests past "
            f"the counts take {ilp - base:.3f} ms over L1 base, "
            f"{per_m:.4f} ms a million; at that price L3's "
            f"{r['tests'] - r['count_tests']} take {extra:.3f} ms, and L3 "
            f"tested to the counts would take about {r['ms'] - extra:.3f} "
            f"ms ({(r['ms'] - extra) / k3:.3f}x K3's {k3:.3f} ms)")
    return bounds


def phase8(device):
    """The 8-wide lab L7 and the near-first any-hit lab L8: their runs
    (the launch counts; each run also times its plain version once), then
    each kernel against its plain version, L7 against K1 and L8 against
    K2. Returns the two kernels' report entries."""
    import torch

    from raytracer_tpu_torch.lab import r3_occl3_lab as l8
    from raytracer_tpu_torch.lab import r3_oct_lab as l7
    from raytracer_tpu_torch.lab import rays as lab_rays

    plog = lambda m: log(f"phase 8: {m}")  # noqa: E731
    t0 = time.perf_counter()
    ds, bvh = lab_rays.atrium_and_bvh(l7.LEAF_SIZE, device)
    tree = l7.oct_tree(bvh, device)
    del bvh
    closest = lab_rays.closest_sets(ds)
    shadow = lab_rays.shadow_sets(ds)
    torch.cuda.synchronize()
    plog(f"leaf-8 bake, oct collapse ({tree.collapse_s:.2f} s: "
         f"{tree.nodes.shape[0]} oct nodes against {ds.qnodes.shape[0]} quad "
         f"nodes, stack need {tree.stack_need}) and ray sets in "
         f"{time.perf_counter() - t0:.2f} s")
    plog(f"card: {lab_rays.card_line()}")

    l7.reset_launch_counts()
    l8.reset_launch_counts()
    res7 = l7.run(ds, tree, closest, log=plog, leaf_hooks=counting_leaf_tests)
    res8 = l8.run(ds, shadow, log=plog, leaf_hooks=counting_leaf_tests)
    launches = {"lab_closest8_queued": l7.closest_launches,
                "lab_occlusion4_queued": l8.occlusion_launches}
    plog(f"lab launch counts {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a lab kernel was not launched: {launches}")

    n = lab_rays.WIDTH * lab_rays.HEIGHT
    err7 = err8 = 0.0
    for label in closest:
        r = res7[(label, "oct")]
        err7 = max(err7, gate_equal(f"lab_closest8_queued {label}", r["out"],
                                    r["plain"]))
        plog(f"lab_closest8_queued {label}: equal to the plain version on "
             f"all {n} rays (t, tri, u, v); vs K1 {r['flips']} hit flips, "
             f"{r['tri_diff']} triangle differences")
        if r["flips"] + r["tri_diff"] > TREE_AGREEMENT * n:
            raise RuntimeError(f"L7 and K1 disagree beyond {TREE_AGREEMENT} "
                               f"of the rays ({label})")
    for label, order in res8:
        if order not in l8.ORDERS:
            continue
        r = res8[(label, order)]
        err8 = max(err8, gate_equal(f"lab_occlusion4_queued {label} {order}",
                                    (r["out"],), (r["plain"],)))
        plog(f"lab_occlusion4_queued {label} {order}: equal to the plain "
             f"version on all {n} rays; {r['mism']} rays differ from K2")
        if r["mism"]:
            raise RuntimeError(f"L8 {order} and K2 differ ({label})")

    phase8_launch_shapes(ds, tree)
    bounds = phase8_bounds(ds, tree, res7, res8)
    for key, b in bounds.items():
        label, kind = key
        r = (res7 if kind == "oct" else res8)[key]
        plog(f"{'L7' if kind == 'oct' else 'L8 ' + kind} {label}: "
             f"{r['ms']:.3f} ms against a bound of {b['bound_ms']:.4f} "
             f"ms, {100 * b['bound_ms'] / r['ms']:.2f}% of the bound")
    oct_run = res7[("bounce1", "oct")]
    occl_run = res8[("shadow_b1", "ordered")]
    return {
        "lab_closest8_queued": dict(
            launches=launches["lab_closest8_queued"], max_abs_err=err7,
            ms=oct_run["ms"], plain_ms=oct_run["plain_ms"],
            **bounds[("bounce1", "oct")]),
        "lab_occlusion4_queued": dict(
            launches=launches["lab_occlusion4_queued"], max_abs_err=err8,
            ms=occl_run["ms"], plain_ms=occl_run["plain_ms"],
            **bounds[("shadow_b1", "ordered")]),
    }


def phase8_launch_shapes(ds, tree):
    """L7 and L8 (both orders) run without local memory and without ptxas
    spills (their lab runs print each launch shape)."""
    launch_shapes_gate((("closest8", tree.stack_need),
                        ("occlusion_ordered", ds.q_stack_need),
                        ("occlusion_fixed", ds.q_stack_need)),
                       ds.ptris.device)


def phase8_bounds(ds, tree, res7, res8):
    """L7's bound on each closest-hit set and L8's (each order) on each
    shadow set, the resorted one included, counted on the triangles they
    test (walk_bound) from the steps and tests of the plain runs in `res7`
    and `res8` (l7.run and l8.run with counting_leaf_tests), each logged
    beside bound(), every slot of each leaf row visited and ometa or qmeta
    read. Returns {(set, "oct" or order): bound}."""
    from raytracer_tpu_torch.lab import r3_occl3_lab as l8

    n = WIDTH * HEIGHT
    bounds = {}
    for (label, kind), r in (*res7.items(), *res8.items()):
        if kind == "oct":
            node, tri, nodes = "oct", "closest", tree.nodes
            name, arrays = "lab_closest8_queued", (tree.nodes, tree.meta)
        elif kind in l8.ORDERS:
            node = "quad" if l8.ORDERS[kind] else "quad_fixed"
            tri, nodes = "any", ds.qnodes
            name, arrays = "lab_occlusion4_queued", (ds.qnodes, ds.qmeta)
        else:
            continue
        b = bounds[(label, kind)] = walk_bound(
            ds, nodes, n, CLOSEST_RAY_BYTES if tri == "closest"
            else ANY_RAY_BYTES, r["counts"], r["tests"], node, tri)
        log_walk_bound(f"{name} {label}{'' if kind == 'oct' else ' ' + kind}",
                       b, (*arrays, ds.ptris), r["counts"], node, tri,
                       phase="phase 8")
    return bounds


def aimed_rays(ptris, n, rows, seed, device):
    """n distinct rays that hit: from points of the box around the
    centroids of the non-degenerate triangles of ptris' first `rows` rows
    (what `rows` leaf visits of a fixed sequence test), grown by half its
    size, each toward one of those centroids; made from a numpy seed."""
    import numpy as np
    import torch

    tris = ptris[:rows].reshape(-1, 12).double().cpu().numpy()
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    cent = (v0 + (e1 + e2) / 3)[np.linalg.norm(np.cross(e1, e2), axis=1) > 0]
    lo, hi = cent.min(0), cent.max(0)
    grow = 0.5 * (hi - lo) + 1e-3
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo - grow, hi + grow, (n, 3))
    d = cent[rng.integers(0, len(cent), n)] - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (o, d))


def phase9(device):
    """The fixed-sequence labs L11a, L11b (visit_cost_lab), L10 (smem_lab)
    and L12 (bf16_lab): their runs at the full K (the launch counts), then
    every variant against its plain version at K_CHECK on the lab's rays
    and on rays that hit, at every size, the identities, and each variant's
    bound at the card size. Returns the four kernels' report entries."""
    import torch

    from raytracer_tpu_torch.lab import bf16_lab, smem_lab
    from raytracer_tpu_torch.lab import fixed_seq as fs
    from raytracer_tpu_torch.lab import rays as lab_rays
    from raytracer_tpu_torch.lab import visit_cost_lab as vc

    plog = lambda m: log(f"phase 9: {m}")  # noqa: E731
    t0 = time.perf_counter()
    ds = lab_rays.atrium(vc.LEAF_SIZE, device)
    torch.cuda.synchronize()
    plog(f"leaf-8 bake in {time.perf_counter() - t0:.2f} s: pnodes "
         f"{tuple(ds.pnodes.shape)}, ptris {tuple(ds.ptris.shape)}; card "
         f"rays {fs.card_rays(device)}; card: {lab_rays.card_line()}")

    for mod in (vc, smem_lab, bf16_lab):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    runs = {"lab_visit": vc.run(ds, log=plog),
            "lab_leaf_visit": vc.run_leaf(ds, log=plog),
            "lab_smem": smem_lab.run(ds, log=plog)}
    chains = bf16_lab.run(device, log=plog)
    launches = {"lab_visit": vc.visit_launches,
                "lab_leaf_visit": vc.leaf_visit_launches,
                "lab_smem": smem_lab.smem_launches,
                "lab_bf16": bf16_lab.bf16_launches}
    plog(f"the labs' runs in {time.perf_counter() - t0:.1f} s; card after: "
         f"{lab_rays.card_line()}; lab launch counts {launches}")
    if not all(launches.values()):
        raise RuntimeError(f"a lab kernel was not launched: {launches}")

    # Every variant against its plain version at K_CHECK iterations.
    # Variants that share a plain version (L11b slice and base, sliceilp
    # and ilp; L10 smem and L11b base) run it once.
    kc = fs.K_CHECK
    t0 = time.perf_counter()
    labs = (
        ("lab_visit", vc.VISIT_LAB_RAYS, vc.VISIT_VARIANTS,
         lambda o, d, v: vc.run_visit(o, d, ds.pnodes, v, kc),
         lambda v: v,
         lambda o, d, v: (vc.visit_plain(o, d, ds.pnodes, v, kc), None)),
        ("lab_leaf_visit", vc.LEAF_LAB_RAYS, vc.LEAF_VARIANTS,
         lambda o, d, v: vc.run_leaf_visit(o, d, ds.ptris, v, kc),
         lambda v: ("ilp" if vc.LEAF_ILP[v] else "base"),
         lambda o, d, v: vc.leaf_visit_plain(o, d, ds.ptris, v, kc)),
        ("lab_smem", smem_lab.LAB_RAYS, smem_lab.VARIANTS,
         lambda o, d, v: smem_lab.run_smem(o, d, ds.ptris, v, kc),
         # smem computes L11b base: one plain version for both
         lambda v: "base" if v == "smem" else v,
         lambda o, d, v: smem_lab.smem_plain(o, d, ds.ptris, v, kc)),
    )
    err = {name: 0.0 for name in launches}
    plain_ms, check_ms, outs, cache = {}, {}, {}, {}
    for name, lab_sizes, variants, launch, plain_key, plain in labs:
        for label, n in fs.sizes(device, lab_sizes):
            ray_sets = {"lab rays": fs.lab_rays_const(n, device),
                        "aimed": aimed_rays(ds.ptris, n, kc, AIMED_SEED,
                                            device)}
            for rays, (o, d) in ray_sets.items():
                for v in variants:
                    got = outs[(name, label, rays, v)] = launch(o, d, v)
                    key = (name != "lab_visit", plain_key(v), n, rays)
                    if key not in cache:
                        cache[key] = lab_rays.host_ms(plain, o, d, v)
                    (ref, bt), ms = cache[key]
                    if bt is not None:
                        hits, ref = int((ref >= 0).sum()), fs.leaf_out(ref, bt)
                    err[name] = max(err[name], gate_equal(
                        f"{name} {v} {label} {rays}", (got,), (ref,)))
                    if rays == "lab rays":
                        plain_ms[(name, label, v)] = ms
                        check_ms[(name, label, v)] = lab_rays.cuda_ms(
                            lambda: launch(o, d, v), 3)
                    plog(f"{name} {v} {label} {rays}: equal to the plain "
                         f"version on all {n} rays at k = {kc} ("
                         + (f"{hits} with btri >= 0" if bt is not None else
                            f"{torch.unique(got).numel()} distinct outputs")
                         + f"); plain {ms:.1f} ms")
    # The identities: two kernels a pair; L10 smem computes L11b
    # base; bf16 = bf16_mul on the ones input (b below half an ulp).
    for label, n in fs.sizes(device, vc.LEAF_LAB_RAYS):
        for rays in ("lab rays", "aimed"):
            for a, b in (("slice", "base"), ("sliceilp", "ilp")):
                gate_equal(f"L11b {a} vs {b} {label} {rays}",
                           (outs[("lab_leaf_visit", label, rays, a)],),
                           (outs[("lab_leaf_visit", label, rays, b)],))
    for label, n in fs.sizes(device, smem_lab.LAB_RAYS):
        for rays in ("lab rays", "aimed"):
            gate_equal(f"L10 smem vs L11b base {label} {rays}",
                       (outs[("lab_smem", label, rays, "smem")],),
                       (outs[("lab_leaf_visit", label, rays, "base")],))
    phase9_exact(ds, device, plog)
    gate_equal("L12 bf16 vs bf16_mul on the ones input",
               (chains["bf16"]["out"].view(torch.int16),),
               (chains["bf16_mul"]["out"].view(torch.int16),))
    plog("identities hold: L11b slice = base and sliceilp = ilp at every "
         "size, L10 smem = L11b base (each pair two kernels), L12 bf16 = "
         "bf16_mul on the ones input")

    # L12 against its plain version at the full K, on the ones input and
    # on a seeded random one: the six JAX chains bit for bit, the fused
    # forms within 1 ulp.
    for v in bf16_lab.ALL:
        for seed in (None, 11):
            if seed is None:
                x, y, got = (chains[v][key] for key in ("x", "y", "out"))
            else:
                x, y = bf16_lab.inputs(v, chains[v]["x"].shape[0], device,
                                       seed)
                got = bf16_lab.run_bf16(v, x, y, bf16_lab.K)
            ref, ms = lab_rays.host_ms(bf16_lab.bf16_plain, v, x, y,
                                       bf16_lab.K)
            ulps = bf16_lab.ulp_diff(got, ref)
            worst, differ = int(ulps.max()), int((ulps > 0).sum())
            if (v in bf16_lab.VARIANTS and differ) or worst > 1:
                raise RuntimeError(f"lab_bf16 {v}: kernel != plain version "
                                   f"({differ} elements, {worst} ulp)")
            err["lab_bf16"] = max(err["lab_bf16"], float(
                (got.double() - ref.double()).abs().max()))
            if seed is None:
                plain_ms[("lab_bf16", v)] = ms
            plog(f"lab_bf16 {v} {'ones' if seed is None else 'random'}: "
                 f"{differ} of {got.numel()} elements differ from the plain "
                 f"version (at most {worst} ulp) at k = {bf16_lab.K}; plain "
                 f"{ms:.1f} ms")
    plog(f"kernels vs plain versions in {time.perf_counter() - t0:.1f} s")

    phase9_visit_shapes(device, runs, plog)

    # Each variant's bound on its card-size run.
    bounds = {}
    for name, variants, table, ops in (
            ("lab_visit", vc.VISIT_VARIANTS, ds.pnodes, VISIT_OPS),
            ("lab_leaf_visit", vc.LEAF_VARIANTS, ds.ptris, LEAF_VISIT_OPS),
            ("lab_smem", smem_lab.VARIANTS, ds.ptris, LEAF_VISIT_OPS)):
        for v in variants:
            r = runs[name][("card", v)]
            b = bounds[(name, v)] = fixed_seq_bound(r["rays"], r["k"], table,
                                                    ops[v])
            plog(f"bound {name} {v} card: {r['ms']:.3f} ms against "
                 f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
                 f"{b['ops']} FP32 operations), "
                 f"{100 * b['bound_ms'] / r['ms']:.2f}% of the bound; "
                 f"{r['ns_per_ray_iter']:.6f} ns/ray-iteration, "
                 f"{r['cycles_per_iter']:.1f} cycles/iteration a warp; at k "
                 f"= {kc}: kernel {check_ms[(name, 'card', v)]:.3f} ms, plain "
                 f"{plain_ms[(name, 'card', v)]:.1f} ms")
    for v in bf16_lab.ALL:
        r = chains[v]
        b = bounds[("lab_bf16", v)] = chain_bound(v, r["x"], r["y"],
                                                  bf16_lab.K)
        plog(f"bound lab_bf16 {v}: {r['ms']:.4f} ms against "
             f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
             f"{b['ops']} results), {100 * b['bound_ms'] / r['ms']:.2f}% of "
             f"the bound")

    report = {}
    for name, v, r in (
            ("lab_visit", "full", runs["lab_visit"][("card", "full")]),
            ("lab_leaf_visit", "base",
             runs["lab_leaf_visit"][("card", "base")]),
            ("lab_smem", "smem", runs["lab_smem"][("card", "smem")]),
            ("lab_bf16", "f32", chains["f32"])):
        report[name] = dict(
            launches=launches[name], max_abs_err=err[name], ms=r["ms"],
            plain_ms=plain_ms[(name, "card", v) if name != "lab_bf16"
                              else (name, v)],
            **bounds[(name, v)])
    return report


def max_sm_clock_mhz():
    """The card's highest SM clock, MHz (nvidia-smi clocks.max.sm)."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {proc.stderr.strip()}")
    return float(proc.stdout.strip().splitlines()[0])


def phase9_exact(ds, device, plog):
    """L11b's and L10's reciprocal (rcp_fast, the division's fast path)
    against the IEEE division on every float it takes, and each of their
    variants against its plain version at K_CHECK on a table whose
    triangles reach dets of 2^126 (the first K_CHECK rows, every third
    triangle's edges scaled by a power of two), on the lab's rays and on
    aimed rays at the lab size: a thread whose visits meet a det of 2^126
    or more runs them again with the division (csrc/lab3_traverse.cu:
    exact_visits)."""
    import torch

    from raytracer_tpu_torch.lab import fixed_seq as fs
    from raytracer_tpu_torch.lab import smem_lab
    from raytracer_tpu_torch.lab import visit_cost_lab as vc

    checked, differ = fs.rcp_check(device)
    if checked != fs.RCP_FLOATS or differ:
        raise RuntimeError(f"lab_rcp_check: {differ} of {checked} floats "
                           f"differ from the division (want 0 of "
                           f"{fs.RCP_FLOATS})")
    plog(f"rcp_fast equals the IEEE division on all {checked} floats with "
         "|x| in [2^-126, 2^126)")
    kc = fs.K_CHECK
    n = vc.LEAF_LAB_RAYS[0]
    runs = [("lab_leaf_visit", v, vc.run_leaf_visit, vc.leaf_visit_plain)
            for v in vc.LEAF_VARIANTS]
    runs += [("lab_smem", v, smem_lab.run_smem, smem_lab.smem_plain)
             for v in smem_lab.VARIANTS]
    for rays, (o, d) in (("lab rays", fs.lab_rays_const(n, device)),
                         ("aimed", aimed_rays(ds.ptris, n, kc, AIMED_SEED,
                                              device))):
        # Every third triangle's edges scaled by a power of two 2^e that
        # takes the median |det| of these rays to about 2^127.
        huge = ds.ptris[:kc].clone().view(kc, vc.LEAF_SIZE, 12)
        tri = huge.view(-1, 12)[None]
        det = (tri[..., 3:6] * torch.linalg.cross(
            d[:, None, :].expand(-1, tri.shape[1], 3),
            tri[..., 6:9].expand(n, -1, 3))).sum(-1).abs()
        e = math.ceil((127 - math.log2(float(det[det > 0].median()))) / 2)
        huge[:, ::3, 3:9] *= 2.0 ** e
        huge = huge.view(kc, -1).contiguous()
        big = int((det.view(n, kc, vc.LEAF_SIZE)[:, :, ::3]
                   >= 2.0 ** (126 - 2 * e)).sum())
        if not big:
            raise RuntimeError(f"phase 9 exact: no det reaches 2^126 on "
                               f"{rays}")
        for name, v, launch, plain in runs:
            gate_equal(f"{name} {v} exact {rays}",
                       (launch(o, d, huge, v, kc),),
                       (fs.leaf_out(*plain(o, d, huge, v, kc)),))
        plog(f"exact rerun on {rays}: every L11b and L10 variant equal to "
             f"its plain version at k = {kc} on the table with every third "
             f"triangle's edges scaled by 2^{e} (about {big} of "
             f"{det.numel()} ray-triangle dets reach 2^126)")


def phase9_visit_shapes(device, runs, plog):
    """The fixed-sequence kernels' launch shapes (lab3_launch_info): every
    L11a, L11b and L10 kernel must run without local memory and without
    ptxas spills. Then the SASS instructions of the K loop (cuobjdump;
    visit_cost_lab.loop_body) of L11a full and nored an iteration and of
    L11b's and L10's kernels a visit, and the issue time they imply on the
    card-size runs `runs` (phase 9's): warps x K x instructions over 4 a
    clock per SM on every SM at the highest SM clock."""
    import torch

    from raytracer_tpu_torch.lab import fixed_seq as fs
    from raytracer_tpu_torch.lab import smem_lab
    from raytracer_tpu_torch.lab import visit_cost_lab as vc
    from raytracer_tpu_torch.lab.quad_variant_lab import library_sass
    from raytracer_tpu_torch.ops import _build

    for index in range(len(fs.LAUNCH_KERNELS)):
        plog(fs.launch_line(index, device))
        i = fs.launch_info(index, device)
        if i["local_bytes"] or i["spills"] not in ((0, 0), ("?", "?")):
            raise RuntimeError(f"{fs.LAUNCH_KERNELS[index][0]}: "
                               f"{i['local_bytes']} B of local memory a "
                               f"thread, spills {i['spills']}")
    sass = library_sass(_build.build_info["liblab3_traverse"]["path"])
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = max_sm_clock_mhz()
    for lab, v, label, unit in (
            *(("lab_visit", v, f"L11a {v}", "iteration")
              for v in ("full", "nored")),
            *(("lab_leaf_visit", v, f"L11b {v}", "visit")
              for v in vc.LEAF_VARIANTS),
            *(("lab_smem", v, f"L10 {v}", "visit")
              for v in smem_lab.VARIANTS)):
        name = fs.LAUNCH_KERNELS[fs.launch_index(label)][1]
        loop = len(vc.loop_body(sass, name))
        r = runs[lab][("card", v)]
        warps = r["rays"] // fs.WARP
        issue_ms = warps * r["k"] * loop / (4 * sms * mhz * 1e6) * 1e3
        article = "an" if unit[0] in "aeiou" else "a"
        plog(f"issue {label}: {loop} SASS instructions {article} {unit}; "
             f"{warps} warps x k = {r['k']} at 4 instructions a clock per "
             f"SM on {sms} SMs at {mhz:.0f} MHz: {issue_ms:.3f} ms, "
             f"{100 * issue_ms / r['ms']:.1f}% of the card run's "
             f"{r['ms']:.3f} ms; {1e9 * issue_ms / (r['rays'] * r['k']):.3f}"
             f" ps a ray-{unit} against {r['ns_per_ray_iter'] * 1e3:.3f}")


CORNELL_JSON = {
    "materials": {
        "white": {"albedo": [0.73, 0.73, 0.73], "roughness": 1.0},
        "red": {"albedo": [0.65, 0.05, 0.05], "roughness": 1.0},
        "green": {"albedo": [0.12, 0.45, 0.15], "roughness": 1.0},
        "metal": {"albedo": [0.9, 0.9, 0.9], "metallic": 1.0,
                  "roughness": 0.2},
        "light": {"albedo": [1, 1, 1], "emission_color": [1, 0.9, 0.8],
                  "emission_power": 10.0},
    },
    "objects": {
        "floor": {"mesh": "Plane", "material": "white",
                  "transform": {"position": [0, -1, 0],
                                "rotation": [-90, 0, 0], "scale": [2, 2, 1]}},
        "ceiling": {"mesh": "Plane", "material": "white",
                    "transform": {"position": [0, 1, 0],
                                  "rotation": [90, 0, 0],
                                  "scale": [2, 2, 1]}},
        "back": {"mesh": "Plane", "material": "white",
                 "transform": {"position": [0, 0, 1],
                               "rotation": [0, 180, 0], "scale": [2, 2, 1]}},
        "left": {"mesh": "Plane", "material": "red",
                 "transform": {"position": [-1, 0, 0],
                               "rotation": [0, 90, 0], "scale": [2, 2, 1]}},
        "right": {"mesh": "Plane", "material": "green",
                  "transform": {"position": [1, 0, 0],
                                "rotation": [0, -90, 0], "scale": [2, 2, 1]}},
        "ball": {"mesh": "Sphere", "material": "metal",
                 "transform": {"position": [0.3, -0.6, 0.3],
                               "scale": [0.4, 0.4, 0.4]}},
        "lamp": {"mesh": "Plane", "material": "light",
                 "transform": {"position": [0, 0.99, 0],
                               "rotation": [90, 0, 0],
                               "scale": [0.6, 0.6, 1]}},
    },
}


# Phase 10's small card-against-CPU size: the CPU's plain walks take about
# 12 s for one 4096-lane launch on the 300k atrium (2.8 s for 1024 lanes),
# so 64x64 would not fit the phase in its minute. The 1080p launches are
# held against the plain walks on the card instead (check_captured).
MODES_SMALL = 32
MODES_SPP = 4  # (a)'s spp_batch at 1080p (MODES_SMALL: 2)
MODES_TOL, MODES_MIN_FRAMES, MODES_FRAMES = 0.15, 8, 24  # (b)
PREVIEW_SCALE = 4  # (d)
FILTER_RTOL, FILTER_ATOL = 1e-5, 1e-6  # (c)


def timed(fn):
    """(fn(), its ms on the host clock between two device syncs)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def timed_runs(fn, runs):
    """The ms of `runs` calls of fn (timed()), each with the device
    allocator's cudaMalloc calls during it: [(ms, mallocs), ...]."""
    import torch

    out = []
    for _ in range(runs):
        before = torch.cuda.memory_stats().get("num_device_alloc", 0)
        _, ms = timed(fn)
        out.append((ms, torch.cuda.memory_stats().get("num_device_alloc", 0)
                    - before))
    return out


def modes_renderer(scene_fn, device, size, **cfg):
    """A ProgressiveRenderer at the bench camera, depth 3: (width, height)
    `size` (or size x size) with RenderConfig(**cfg)."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.utils.config import RenderConfig

    w, h = size if isinstance(size, tuple) else (size, size)
    cam, _ = bench_camera_ubo(device, w, h)
    return ProgressiveRenderer(
        scene_fn(), cam, RenderConfig(width=w, height=h, max_depth=3, **cfg),
        device=device)


def quad_launches(part, closest=True, occlusion=True, phase="phase 10"):
    """K1's and K2's launches since the last reset_all_launch_counts();
    raises unless each one asked for launched."""
    from raytracer_tpu_torch.ops import quad_traverse as qt

    counts = {"quad_closest": qt.closest_launches,
              "quad_occlusion": qt.occlusion_launches}
    if ((closest and not counts["quad_closest"])
            or (occlusion and not counts["quad_occlusion"])):
        raise RuntimeError(f"{phase} {part}: a kernel was not launched: "
                           f"{counts}")
    return counts


def gate_pixels(what, a, b, phase="phase 10"):
    """Raise unless images (or buffers [..., C]) `a` and `b` agree within
    PIXEL_ATOL except at most MAX_FLIPPED of the pixels."""
    import numpy as np

    diff = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    flipped = diff.reshape(-1, diff.shape[-1]).max(axis=-1) > PIXEL_ATOL
    log(f"{phase} {what}: {int(flipped.sum())} flipped pixels of "
        f"{flipped.size}, max |diff| {float(diff.max()):.3g}")
    if flipped.mean() > MAX_FLIPPED:
        raise RuntimeError(f"{phase} {what}: beyond tolerance")


@contextlib.contextmanager
def capture_launches(closest_at, occlusion_at=None, tree="quad"):
    """Keeps the rays and the results of the closest-hit launch number
    `closest_at` and the any-hit launch number `occlusion_at` (None: none),
    counted from 0 within the block, as the main path launches them: K1
    and K2 (`tree` "quad") or K3 and K4 ("binary"). The wrappers' launch
    functions are wrapped, so the launches and their counts are the path's
    own. Yields a dict that check_captured() reads."""
    import torch

    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    # The launch functions' ray arguments before the scene: (origin,
    # direction, t_max) for K1, with skip_object for K2, then t_min for
    # K3/K4.
    mod, names, n_in = {
        "quad": (qt, ("_intersect_quad_cuda", "_occlusion_quad_cuda"), 3),
        "binary": (bt, ("_intersect_binary_cuda", "_occlusion_binary_cuda"),
                   4)}[tree]
    kept = {"at": {"closest": closest_at, "occlusion": occlusion_at},
            "tree": tree}
    seen = {"closest": 0, "occlusion": 0}
    k1, k2 = (getattr(mod, name) for name in names)

    def keep(kind, inputs, out):
        if seen[kind] == kept["at"][kind]:
            kept[kind] = (tuple(x.clone() if isinstance(x, torch.Tensor)
                                else x for x in inputs),
                          tuple(x.clone() for x in out))
        seen[kind] += 1

    def closest(*args, **kw):
        out = k1(*args, **kw)
        keep("closest", args[:n_in], out)
        kept["scene"] = args[n_in]
        return out

    def occlusion(*args, **kw):
        out = k2(*args, **kw)
        keep("occlusion", args[:n_in + 1], (out,))
        return out

    setattr(mod, names[0], closest)
    setattr(mod, names[1], occlusion)
    try:
        yield kept
    finally:
        setattr(mod, names[0], k1)
        setattr(mod, names[1], k2)


def check_captured(part, kept, phase="phase 10"):
    """Raise unless the launches capture_launches() kept equal their plain
    versions, run on the card on the same rays, bit for bit (phase 2's
    gate). The plain walks test every slot of a leaf row, so they do not
    read the kernels' leaf counts."""
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    t0 = time.perf_counter()
    closest_at, occlusion_at = kept["at"]["closest"], kept["at"]["occlusion"]
    scene = kept["scene"]
    if kept["tree"] == "quad":
        names = ("K1", "K2")
        arrays = (scene.root, scene.qmeta, scene.qnodes, scene.ptris)
        closest_plain = lambda o, d, tm: qt._intersect_quad_plain(  # noqa
            o, d, tm, *arrays)
        any_plain = lambda o, d, tm, skip: qt._occlusion_quad_plain(  # noqa
            o, d, tm, skip, *arrays)
    else:
        names = ("K3", "K4")
        arrays = (scene.binary_root, scene.pnodes, scene.ptris)
        closest_plain = lambda o, d, tm, t_min: (  # noqa: E731
            bt._intersect_binary_plain(o, d, tm, t_min, *arrays))
        any_plain = lambda o, d, tm, skip, t_min: (  # noqa: E731
            bt._occlusion_binary_plain(o, d, tm, skip, t_min, *arrays))
    inputs, got = kept["closest"]
    gate_closest(f"{phase} {part} {names[0]} launch {closest_at}", got,
                 closest_plain(*inputs))
    o, tm = inputs[0], inputs[2]
    said = (f"{names[0]} launch {closest_at} ({o.shape[0]} rays, "
            f"{inactive_share(tm):.4f} of the lanes inactive)")
    if occlusion_at is not None:
        inputs, (got,) = kept["occlusion"]
        mism = int((got != any_plain(*inputs)).sum())
        if mism:
            raise RuntimeError(f"{phase} {part}: {names[1]} launch "
                               f"{occlusion_at} != plain version on {mism} "
                               "rays")
        o, tm = inputs[0], inputs[2]
        said += (f" and {names[1]} launch {occlusion_at} ({o.shape[0]} "
                 f"rays, {inactive_share(tm):.4f} inactive)")
    log(f"{phase} {part}: {said} of the path equal to the plain versions "
        f"on the card, every ray ({time.perf_counter() - t0:.2f} s)")


def phase10_spp(scene_fn, device, phase3_ms):
    """(a) One spp_batch=MODES_SPP step against MODES_SPP sequential steps
    of a fresh renderer at 1080p; ms per step and per sample, peak memory
    of each."""
    import numpy as np
    import torch

    s_count = MODES_SPP
    bat = modes_renderer(scene_fn, device, (WIDTH, HEIGHT),
                         spp_batch=s_count)
    seq = modes_renderer(scene_fn, device, (WIDTH, HEIGHT))
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    _, ms_first = timed(bat.step)
    counts = quad_launches("(a) spp batching")
    counts["light_select"] = gate_select("phase 10 (a) spp batching", 1)
    bat_peak = torch.cuda.max_memory_allocated()
    img_bat = bat.image()
    torch.cuda.reset_peak_memory_stats()
    seq_ms = [timed(seq.step)[1] for _ in range(s_count)]
    seq_peak = torch.cuda.max_memory_allocated()
    img_seq = seq.image()
    # Warm steps, frames s_count .. 4 s_count - 1; the median is the figure.
    warm = timed_runs(bat.step, 3)
    ms_step = statistics.median(ms for ms, _ in warm)
    equal = bool(np.array_equal(img_bat, img_seq))
    # The bounce-1 launches of one more step: every (pixel, sample) lane.
    with capture_launches(1, 1) as kept:
        bat.step()
    check_captured("(a)", kept)
    log(f"phase 10 (a): spp_batch={s_count}: first step {ms_first:.1f} ms, "
        f"warm steps {', '.join(f'{ms:.1f}' for ms, _ in warm)} ms "
        f"(cudaMalloc calls {[m for _, m in warm]}), median {ms_step:.1f} "
        f"= {ms_step / s_count:.1f} ms a sample "
        f"(phase 3: {phase3_ms:.1f} ms/frame; {s_count} sequential steps "
        f"here: {', '.join(f'{t:.1f}' for t in seq_ms)} ms); peak device "
        f"memory {bat_peak} B batched, {seq_peak} B sequential "
        f"({bat_peak / seq_peak:.2f}x); launches of the first step {counts}; "
        f"batched vs sequential bit-equal: {equal}")
    if not equal:
        gate_pixels("(a) batched vs sequential", img_bat, img_seq)
    return {"ms_step": ms_step, "ms_sample": ms_step / s_count,
            "peak": bat_peak, "seq_peak": seq_peak, "equal": equal}


def phase10_adaptive(scene_fn, device):
    """(b) Adaptive sampling at 1080p, tol MODES_TOL, min frames
    MODES_MIN_FRAMES, MODES_FRAMES frames: ms/frame, rays traced per frame,
    the converged fraction at frames 8, 16, 24; retired pixels unchanged
    by one more step; then tol 0 at 64x64 on the card bit-equal to the
    plain accumulation on the card."""
    import torch

    from raytracer_tpu_torch.integrator import adaptive
    from raytracer_tpu_torch.integrator.wavefront import render_frame

    r = modes_renderer(scene_fn, device, (WIDTH, HEIGHT),
                       adaptive_tol=MODES_TOL,
                       adaptive_min_frames=MODES_MIN_FRAMES)
    reset_all_launch_counts()
    rows = []
    for f in range(MODES_FRAMES):
        _, ms = timed(r.step)
        frac = (r.adaptive_converged_fraction()
                if (f + 1) % 8 == 0 else None)
        rows.append((ms, int(r.last_stats["rays_traced"]),
                     int(r.last_stats["shadow_rays"]), frac))
    counts = quad_launches("(b) adaptive sampling")
    counts["light_select"] = gate_select("phase 10 (b) adaptive sampling",
                                         MODES_FRAMES)
    for f, (ms, traced, shadow, frac) in enumerate(rows):
        log(f"  adaptive frame {f}: {ms:.1f} ms, {traced} traced + {shadow} "
            f"shadow rays" + ("" if frac is None else
                              f", converged {frac:.6f}"))
    log(f"phase 10 (b): tol {MODES_TOL}, min frames {MODES_MIN_FRAMES}: "
        f"{sum(row[0] for row in rows[:8]) / 8:.1f} ms/frame over frames "
        f"0-7, {sum(row[0] for row in rows[16:]) / 8:.1f} over 16-23; "
        f"converged {[row[3] for row in rows if row[3] is not None]} at "
        f"frames 8, 16, 24; launches {counts}")

    active = adaptive.active_mask(r.adaptive, r.config)
    before = r.adaptive
    # The camera launch (retired pixels inactive) and the first NEE launch.
    with capture_launches(0, 0) as kept:
        r.step()
    check_captured("(b)", kept)
    retired = ~active
    if not (torch.equal(r.adaptive.mean[retired], before.mean[retired])
            and torch.equal(r.adaptive.count[retired],
                            before.count[retired])
            and torch.equal(r.adaptive.count[active],
                            before.count[active] + 1)):
        raise RuntimeError("phase 10 (b): a retired pixel changed, or an "
                           "active one did not count")
    log(f"phase 10 (b): {int(retired.sum())} retired pixels unchanged by "
        "one more step")

    small = modes_renderer(scene_fn, device, 64)
    small.begin_frame()
    cfg = small.config.replace(adaptive_tol=0.0)
    accum = torch.zeros((cfg.num_pixels, 3), device=device)
    st = adaptive.AdaptiveState.empty(cfg.num_pixels, device)
    for f in range(4):
        accum = render_frame(small.device_scene, small._camera_ubo_dev,
                             accum, f, cfg)
        st = adaptive.render_frame_adaptive(
            small.device_scene, small._camera_ubo_dev, st, cfg)
    if not (torch.equal(accum, st.mean) and bool((st.count == 4).all())):
        raise RuntimeError("phase 10 (b): tol 0 differs from the plain "
                           "accumulation on the card")
    log("phase 10 (b): 64x64 x4 frames, tol 0 bit-equal to the plain "
        "accumulation on the card")
    return {"rows": rows}


def phase10_denoise_preview(scene_fn, device):
    """(c) image(denoise=True) after 4 frames at 1080p, with the G-buffer
    pass (one K1 launch) and the filter timed apart; the card's filter
    against the CPU's on the same 1080p buffers, within rtol FILTER_RTOL
    (atol FILTER_ATOL). (d) preview_image at scale PREVIEW_SCALE with and
    without denoise, upscaled or not, and aovs()."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.integrator.denoise import (
        MISS_DEPTH, atrous_denoise, gbuffer_pass,
    )

    r = modes_renderer(scene_fn, device, (WIDTH, HEIGHT))
    for _ in range(4):
        r.step()
    accum = r.accum.clone()
    reset_all_launch_counts()
    img, ms_image = timed(lambda: r.image(denoise=True))
    counts = quad_launches("(c) denoise", occlusion=False)
    gate_select("phase 10 (c) denoise", 0)
    if counts != {"quad_closest": 1, "quad_occlusion": 0}:
        raise RuntimeError(f"phase 10 (c): the G-buffer pass launched "
                           f"{counts}, not one K1")
    if not torch.equal(r.accum, accum):
        raise RuntimeError("phase 10 (c): the denoiser changed the "
                           "accumulation")
    if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all():
        raise RuntimeError("phase 10 (c): the denoised image is not finite "
                           "and full size")
    gbuf, ms_gbuf = timed(lambda: gbuffer_pass(
        r.device_scene, r._camera_ubo_dev, r.config))
    card_filter, ms_filter = timed(lambda: atrous_denoise(
        r.accum, *gbuf, HEIGHT, WIDTH,
        iterations=r.config.denoise_iterations))
    with capture_launches(0) as kept:
        gbuffer_pass(r.device_scene, r._camera_ubo_dev, r.config)
    check_captured("(c) G-buffer", kept)
    t0 = time.perf_counter()
    want = atrous_denoise(*(b.cpu() for b in (r.accum, *gbuf)), HEIGHT,
                          WIDTH, iterations=r.config.denoise_iterations)
    cpu_s = time.perf_counter() - t0
    card_filter = card_filter.cpu().numpy()
    np.testing.assert_allclose(card_filter, want.numpy(), rtol=FILTER_RTOL,
                               atol=FILTER_ATOL)
    log(f"phase 10 (c): the card's filter against the CPU's ({cpu_s:.2f} s) "
        f"on the same {WIDTH}x{HEIGHT} buffers: max |diff| "
        f"{float(np.abs(card_filter - want.numpy()).max()):.3g} (rtol "
        f"{FILTER_RTOL}, atol {FILTER_ATOL})")
    log(f"phase 10 (c): image(denoise=True) {ms_image:.1f} ms (G-buffer, "
        f"filter, readback); warm: G-buffer pass {ms_gbuf:.2f} ms (one K1 "
        f"launch of {WIDTH * HEIGHT} rays), filter {ms_filter:.2f} ms "
        f"({r.config.denoise_iterations} iterations); launches {counts}")

    # The preview's bounce-1 launches, on its 1/PREVIEW_SCALE lanes.
    with capture_launches(1, 1) as kept:
        r.preview_image(PREVIEW_SCALE, denoise=False, upscale=False)
    check_captured("(d) preview", kept)
    ms_preview = {}
    for denoise in (False, True):
        for upscale in (True, False):
            reset_all_launch_counts()

            def preview():
                return r.preview_image(PREVIEW_SCALE, denoise=denoise,
                                       upscale=upscale)

            # The first denoised call builds the G-buffer.
            out, first = timed(preview)
            warm = [ms for ms, _ in timed_runs(preview, 3)]
            counts = quad_launches(f"(d) preview denoise={denoise}")
            counts["light_select"] = gate_select(
                f"phase 10 (d) preview denoise={denoise}", 1 + 3)
            shape = ((HEIGHT, WIDTH, 3) if upscale else
                     (HEIGHT // PREVIEW_SCALE, WIDTH // PREVIEW_SCALE, 3))
            if out.shape != shape or not np.isfinite(out).all():
                raise RuntimeError(f"phase 10 (d): preview {out.shape}, "
                                   f"not a finite {shape}")
            ms = ms_preview[(denoise, upscale)] = statistics.median(warm)
            log(f"phase 10 (d): preview_image({PREVIEW_SCALE}, denoise="
                f"{denoise}, upscale={upscale}) {first:.1f} ms, then "
                f"{', '.join(f'{t:.1f}' for t in warm)} ms (median "
                f"{ms:.1f}); launches in the four {counts}")
    aov, ms_aov = timed(r.aovs)
    hit = aov["depth"] < MISS_DEPTH
    if (aov["normal"].shape != (HEIGHT, WIDTH, 3)
            or aov["depth"].shape != (HEIGHT, WIDTH)
            or aov["albedo"].shape != (HEIGHT, WIDTH, 3)
            or not hit.any() or not np.isfinite(aov["depth"][hit]).all()):
        raise RuntimeError("phase 10 (d): AOVs of the wrong shape, or no "
                           "finite depth on hits")
    log(f"phase 10 (d): aovs() {ms_aov:.1f} ms (cached G-buffer, readback), "
        f"{float(hit.mean()):.4f} of the pixels hit")
    return {"ms_image": ms_image, "ms_gbuf": ms_gbuf,
            "ms_filter": ms_filter, "ms_preview": ms_preview}


def phase10_small(scene_fn, device):
    """(e) Modes (a), (b) and (d) end to end at MODES_SMALL x MODES_SMALL,
    card against CPU: spp_batch 2, adaptive sampling, the preview and the
    AOVs within PIXEL_ATOL / MAX_FLIPPED."""
    n = MODES_SMALL
    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        reset_all_launch_counts()
        spp = modes_renderer(scene_fn, dev, n, spp_batch=2)
        spp.step()
        ada = modes_renderer(scene_fn, dev, n, adaptive_tol=MODES_TOL,
                             adaptive_min_frames=2)
        for _ in range(4):
            ada.step()
        plain = modes_renderer(scene_fn, dev, n)
        plain.render(2)
        out[str(dev)] = {
            "spp": spp.image(), "mean": ada.adaptive.mean.cpu().numpy(),
            "count": ada.adaptive.count.cpu().numpy(),
            "preview": plain.preview_image(PREVIEW_SCALE, denoise=False,
                                           upscale=False),
            "aovs": plain.aovs()}
        if dev != "cpu":
            quad_launches("(e)")
        log(f"phase 10 (e): {n}x{n} modes on {dev} in "
            f"{time.perf_counter() - t0:.2f} s")
    card, cpu = out[str(device)], out["cpu"]
    gate_pixels(f"(e) {n}x{n} spp_batch=2", card["spp"], cpu["spp"])
    gate_pixels(f"(e) {n}x{n} adaptive mean", card["mean"], cpu["mean"])
    count_diff = float((card["count"] != cpu["count"]).mean())
    log(f"phase 10 (e): adaptive counts differ on {count_diff:.4f} of the "
        f"pixels (converged {float((card['count'] < 4).mean()):.4f})")
    if count_diff > MAX_FLIPPED:
        raise RuntimeError("phase 10 (e): adaptive counts differ")
    gate_pixels(f"(e) {n}x{n} preview", card["preview"], cpu["preview"])
    gate_aovs(f"(e) {n}x{n}", card["aovs"], cpu["aovs"])


def gate_aovs(what, card, cpu, phase="phase 10"):
    """Raise unless two aovs() dicts agree: normal and albedo within
    PIXEL_ATOL / MAX_FLIPPED where both hit, hit flips and depths beyond a
    relative PIXEL_ATOL on at most MAX_FLIPPED of the pixels."""
    import numpy as np

    from raytracer_tpu_torch.integrator.denoise import MISS_DEPTH

    hit = (card["depth"] < MISS_DEPTH, cpu["depth"] < MISS_DEPTH)
    both = hit[0] & hit[1]
    gate_pixels(f"{what} AOV normal, albedo",
                np.concatenate([card["normal"], card["albedo"]], -1)[both],
                np.concatenate([cpu["normal"], cpu["albedo"]], -1)[both],
                phase=phase)
    rel = (np.abs(card["depth"] - cpu["depth"])[both]
           / cpu["depth"][both])
    flips = float((hit[0] != hit[1]).mean())
    log(f"{phase} {what}: AOV hit flips {flips:.4f}, max relative depth "
        f"difference {float(rel.max()):.3g}")
    if flips > MAX_FLIPPED or float((rel > PIXEL_ATOL).mean()) > MAX_FLIPPED:
        raise RuntimeError(f"{phase} {what}: AOV depth beyond tolerance")


def phase10(scene_fn, device, phase3_ms):
    """The render modes on the 1080p 300k atrium at the bench camera, with
    K1/K2's launch counts set to 0 before and read after each part."""
    t0 = time.perf_counter()
    spp = phase10_spp(scene_fn, device, phase3_ms)
    ada = phase10_adaptive(scene_fn, device)
    den = phase10_denoise_preview(scene_fn, device)
    phase10_small(scene_fn, device)
    log(f"phase 10: {time.perf_counter() - t0:.1f} s")
    return {"spp": spp, "adaptive": ada, "denoise": den}


# Phase 11: ReSTIR DI. The lightgrid's camera is the JAX package's ReSTIR
# lab's (tools/r5_restir_equaltime_lab.py:81-83).
LIGHTGRID_CAM = ((0.0, 4.2, -10.5), (0.0, 1.2, 1.5))
RESTIR_SMALL = {"atrium": 32, "lightgrid": 24}  # (e), card against CPU
RESTIR_SMALL_FRAMES = 3
# K1 (K3) and K2 (K4) launches of a ReSTIR frame at depth 3: the primary
# trace and two indirect bounces; step 3's and step 6's shadow rays and the
# two indirect bounces' NEE.
RESTIR_LAUNCHES = {"closest": 3, "occlusion": 4}


def restir_renderer(scene_fn, device, size, cam=(CAM_POS, CAM_TARGET),
                    **cfg):
    """A ProgressiveRenderer at `cam` (position, target), depth 3, (width,
    height) `size`, with RenderConfig(**cfg)."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.utils.config import RenderConfig

    w, h = size
    camera = Camera.create(position=cam[0], aspect=w / h, target=cam[1])
    return ProgressiveRenderer(
        scene_fn(), camera,
        RenderConfig(width=w, height=h, max_depth=3, **cfg), device=device)


def timed_frames(r, label):
    """2 warm and 4 timed steps of renderer `r`, with every launch count
    set to 0 just before and read just after: (ms/frame, Mrays/s, peak
    device memory, launch counts of the 6 frames)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    times, rays = [], []
    for f in range(6):
        _, ms = timed(r.step)
        if f >= 2:
            times.append(ms)
            rays.append(int(r.last_stats["total_rays"]))
    launches = all_launch_counts()
    ms = sum(times) / len(times)
    mrays = sum(rays) / (sum(times) / 1e3) / 1e6
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 11 {label}: timed frames "
        f"{', '.join(f'{t:.1f}' for t in times)} ms, mean {ms:.1f} ms/frame, {sum(rays) // len(rays)} rays/frame "
        f"(shadow rays included), {mrays:.2f} Mrays/s, peak device memory "
        f"{peak} B, launches in 6 frames {launches}")
    return ms, mrays, peak, launches


def phase11_main(scene_fn, device, accel, phase3_ms):
    """(a)/(b) ReSTIR on the 1080p atrium with `accel`: timed frames, the
    launches a frame, a finite non-black image, and M > 0 on every pixel
    that hits. Returns (renderer, image, ms/frame)."""
    import numpy as np

    from raytracer_tpu_torch.integrator.denoise import MISS_DEPTH

    part = "(a)" if accel == "auto" else "(b)"
    r = restir_renderer(scene_fn, device, (WIDTH, HEIGHT), use_restir=True,
                        accel=accel)
    ms, mrays, peak, launches = timed_frames(r, f"{part} accel={accel}")
    tree = "quad" if accel == "auto" else "binary"
    other = "binary" if accel == "auto" else "quad"
    want = {f"{tree}_{k}": 6 * n for k, n in RESTIR_LAUNCHES.items()}
    want.update({f"{other}_{k}": 0 for k in RESTIR_LAUNCHES})
    want["light_select"] = 6 * SELECT_PER_FRAME
    if launches != want:
        raise RuntimeError(f"phase 11 {part}: launches {launches}, want "
                           f"{want} in 6 frames")
    img = r.image()
    if not np.isfinite(img).all() or not img.mean() > 0:
        raise RuntimeError(f"phase 11 {part}: image is not finite and "
                           "non-black")
    hit = r.aovs()["depth"].reshape(-1) < MISS_DEPTH
    m = r.reservoir.m.cpu().numpy()
    sample = (r.reservoir.light_index.cpu().numpy() >= 0) & (
        r.reservoir.w.cpu().numpy() > 0)
    log(f"phase 11 {part}: {ms:.1f} ms/frame against phase 3's "
        f"{phase3_ms:.1f} ({ms / phase3_ms:.2f}x), {mrays:.2f} Mrays/s, peak "
        f"{peak} B; K{'1' if accel == 'auto' else '3'}/"
        f"K{'2' if accel == 'auto' else '4'} launches a frame "
        f"{launches[f'{tree}_closest'] / 6:g} / "
        f"{launches[f'{tree}_occlusion'] / 6:g}; image mean "
        f"{float(img.mean()):.5f}; {int(hit.sum())} pixels hit, M > 0 on "
        f"{int((m[hit] > 0).sum())}, a sample with W > 0 on "
        f"{int(sample[hit].sum())}; M max {float(m.max()):g}")
    if not (m[hit] > 0).all() or not sample[hit].any():
        raise RuntimeError(f"phase 11 {part}: the reservoir is empty on "
                           "pixels that hit")
    return r, img, ms


def phase11_capture(r):
    """(c) One more step of (a)'s renderer, its primary K1 launch and K2
    launch 1 (step 6's final visibility rays, skipping each sample's light
    object) kept and held against the plain walks on the card."""
    import torch

    with capture_launches(0, 1) as kept:
        r.step()
    check_captured("(c)", kept, phase="phase 11")
    # Without the feedback flag the reservoir the step hands on holds the
    # samples step 6 shaded: each live ray skips its sample's object.
    (o, d, tm, skip), _ = kept["occlusion"]
    live = tm > 1e-3
    ds = kept["scene"]
    li = torch.clamp(r.reservoir.light_index, 0,
                     ds.light_tri_object.shape[0] - 1).long()
    want = ds.light_tri_object[li]
    if not torch.equal(skip[live], want[live]):
        raise RuntimeError("phase 11 (c): a step-6 ray does not skip its "
                           "sample's light object")
    log(f"phase 11 (c): K2 launch 1 has {int(live.sum())} live rays, each "
        "skipping its sample's light object")


def phase11_lightgrid(device):
    """(d) The 64-light grid at 1080p: ReSTIR against plain NEE."""
    from raytracer_tpu_torch.scene.benchmark import (
        create_benchmark_lightgrid,
    )

    out = {}
    for name, restir in (("ReSTIR", True), ("NEE", False)):
        r = restir_renderer(create_benchmark_lightgrid, device,
                            (WIDTH, HEIGHT), cam=LIGHTGRID_CAM,
                            use_restir=restir)
        out[name] = timed_frames(r, f"(d) lightgrid {name}")
        quad_launches(f"(d) lightgrid {name}", phase="phase 11")
        gate_select(f"phase 11 (d) lightgrid {name}", 6)
        del r
    ratio = out["ReSTIR"][0] / out["NEE"][0]
    log(f"phase 11 (d): lightgrid 1080p ReSTIR {out['ReSTIR'][0]:.1f} "
        f"ms/frame, NEE {out['NEE'][0]:.1f} ({ratio:.2f}x); peak "
        f"{out['ReSTIR'][2]} / {out['NEE'][2]} B")
    return {"restir_ms": out["ReSTIR"][0], "nee_ms": out["NEE"][0],
            "ratio": ratio}


def phase11_small(scene_fn, device):
    """(e) The atrium and the lightgrid at RESTIR_SMALL, card against CPU:
    images within PIXEL_ATOL / MAX_FLIPPED, the reservoir's light_index
    equal on all but MAX_FLIPPED of the pixels."""
    import numpy as np

    from raytracer_tpu_torch.scene.benchmark import (
        create_benchmark_lightgrid,
    )

    cases = (("atrium", scene_fn, (CAM_POS, CAM_TARGET)),
             ("lightgrid", create_benchmark_lightgrid, LIGHTGRID_CAM))
    for name, make, cam in cases:
        n = RESTIR_SMALL[name]
        out = {}
        for dev in (device, "cpu"):
            t0 = time.perf_counter()
            reset_all_launch_counts()
            r = restir_renderer(make, dev, (n, n), cam=cam, use_restir=True)
            img = r.render(RESTIR_SMALL_FRAMES)
            if dev != "cpu":
                quad_launches(f"(e) {name}", phase="phase 11")
            out[str(dev)] = (img, r.reservoir.light_index.cpu().numpy())
            log(f"phase 11 (e): {name} {n}x{n} x{RESTIR_SMALL_FRAMES} "
                f"frames on {dev} in {time.perf_counter() - t0:.2f} s")
        (card, card_li), (cpu, cpu_li) = out[str(device)], out["cpu"]
        gate_pixels(f"(e) {name} {n}x{n}", card, cpu, phase="phase 11")
        same = float((card_li == cpu_li).mean())
        log(f"phase 11 (e): {name} light_index equal on {same:.4f} of the "
            "pixels")
        if same < 1 - MAX_FLIPPED:
            raise RuntimeError(f"phase 11 (e): {name} reservoirs differ")


def phase11(scene_fn, device, phase3_ms):
    """ReSTIR DI (use_restir=True) on the 1080p atrium with accel auto and
    bvh, the captured launches, the 1080p lightgrid, and card against CPU
    at small sizes."""
    t0 = time.perf_counter()
    r, img, ms = phase11_main(scene_fn, device, "auto", phase3_ms)
    phase11_capture(r)
    del r
    _, bvh_img, bvh_ms = phase11_main(scene_fn, device, "bvh", phase3_ms)
    gate_pixels("(b) 1080p accel=bvh vs accel=auto after the same frames",
                bvh_img, img, phase="phase 11")
    grid = phase11_lightgrid(device)
    phase11_small(scene_fn, device)
    log(f"phase 11: {time.perf_counter() - t0:.1f} s")
    return {"ms": ms, "bvh_ms": bvh_ms, **grid}


# Phase 12: the editor path (P3, P11).
EDIT_SMALL, EDIT_SMALL_FRAMES = 32, 3  # (d), card against CPU
# (a)'s branches: the replay each edit of interactive_session must take.
SESSION_BRANCHES = {"camera_move": None, "transform_drag": "refit",
                    "material_paint": "materials",
                    "light_brighten": "materials", "object_add": "prebake"}
# (b)/(c): the atrium's emissive object and an ordinary column in front of
# the bench camera, moved; a column collapsed to its position and restored
# (scale 1e-30: its edges round to exactly 0 in f32, and the scene model
# inverts the model matrix, so a scale of 0 cannot be set).
EDIT_LIGHT, EDIT_COLUMN, EDIT_COLLAPSE = "Skylight", "col_1_1_0", "col_2_1_0"


def phase12_session(device):
    """(a) examples/interactive_session.py's edits on the Cornell box at
    1080p, each shown on the 4x denoised native preview, with full-res
    accumulation resumed after each: each edit's latency to its visible
    frame, the resume, and the replay branch it took, checked."""
    from raytracer_tpu_torch.examples import interactive_session as session

    reset_all_launch_counts()
    t0 = time.perf_counter()
    out = session.run(session.build_parser().parse_args(
        ["--1080p", "--size", f"{WIDTH}x{HEIGHT}", "--device", str(device)]))
    counts = quad_launches("(a) session", phase="phase 12")
    for tag in session.EDITS:
        log(f"phase 12 (a): {tag}: {out['latency_ms'][tag]:.1f} ms to the "
            f"visible frame, {out['resume_ms'][tag]:.1f} ms to resume "
            f"full-res accumulation, replay {out['branch'][tag]}, same BVH "
            f"{out['same_bvh'][tag]}, same geometry tensors "
            f"{out['same_geometry'][tag]}")
    ok = (out["branch"] == SESSION_BRANCHES
          and out["same_bvh"]["transform_drag"]
          and out["same_geometry"]["material_paint"]
          and out["same_geometry"]["light_brighten"])
    if not ok:
        raise RuntimeError(f"phase 12 (a): replay branches {out['branch']}, "
                           f"want {SESSION_BRANCHES} (same BVH "
                           f"{out['same_bvh']}, same geometry "
                           f"{out['same_geometry']})")
    log(f"phase 12 (a): session {time.perf_counter() - t0:.1f} s, launches "
        f"{counts}")
    return out


def object_index(scene, name):
    return next(i for i, o in enumerate(scene.objects) if o.name == name)


def timed_replay(r, what, branch):
    """Time begin_frame() (the journal's replay, between two device
    syncs) and check the branch it took."""
    _, ms = timed(r.begin_frame)
    if r.last_replay != branch:
        raise RuntimeError(f"phase 12 {what}: replay {r.last_replay}, want "
                           f"{branch}")
    return ms


def captured_step(r, part, tree):
    """One step of `r` with its first closest-hit and first any-hit launch
    (bounce 0's NEE) captured and held against the plain walks."""
    with capture_launches(0, 0, tree=tree) as kept:
        r.step()
    check_captured(part, kept, phase="phase 12")


def phase12_refit(scene_fn, device, accel):
    """(b) on the 1080p atrium with `accel`: the refit replay after moving
    the emissive object and a column, the full bake of the same state, the
    refit's host part (and in it the tree's refit and repack) and upload
    apart, and a material-only edit; (c) one
    captured launch pair after the refit and after the material edit, and
    after a column's collapse and restore, each bit-equal to the plain
    walks. Returns (renderer, times)."""
    import dataclasses

    import numpy as np

    from raytracer_tpu_torch.ops import quad_traverse as qt
    from raytracer_tpu_torch.scene import device_scene

    tree = "quad" if accel == "auto" else "binary"
    part = f"accel={accel}"
    r = modes_renderer(scene_fn, device, (WIDTH, HEIGHT), accel=accel)
    r.step()
    r.step()
    scene, bvh = r.scene, r._host_bvh
    light, column = (object_index(scene, n) for n in (EDIT_LIGHT,
                                                       EDIT_COLUMN))
    for idx, dp in ((light, (1.5, 0.0, -0.5)), (column, (0.4, 0.3, -0.6))):
        pos = np.asarray(scene.objects[idx].transform.position) + dp
        scene.update_object_position(idx, tuple(pos))
    reset_all_launch_counts()
    times = {"refit_ms": timed_replay(r, f"(b) {part} refit", "refit")}
    if r._host_bvh is not bvh:
        raise RuntimeError("phase 12 (b): the refit replaced the BVH")
    captured_step(r, f"(c) {part} after the refit", tree)
    kw = r._bake_kwargs()
    _, times["full_bake_ms"] = timed(lambda: device_scene.bake_scene(
        scene, **kw))
    arrays, times["refit_host_ms"] = timed(
        lambda: device_scene._bake_arrays(scene, kw["leaf_size"], bvh)[0])
    _, times["refit_upload_ms"] = timed(
        lambda: device_scene._to_device(arrays, device))
    n = arrays["num_triangles"]  # the refit's part of the host time
    _, times["refit_tree_ms"] = timed(lambda: device_scene._repack_tree(
        bvh.refit(*(arrays[k][:n] for k in ("tri_v0", "tri_e1",
                                            "tri_e2")))))
    mat = scene.objects[column].material_index
    scene.update_material(mat, dataclasses.replace(
        scene.materials[mat], albedo=(0.9, 0.2, 0.1)))
    li = scene.objects[light].material_index
    scene.update_material(li, dataclasses.replace(
        scene.materials[li],
        emission_power=scene.materials[li].emission_power * 1.5))
    geometry = r.device_scene.ptris
    times["material_ms"] = timed_replay(r, f"(b) {part} material",
                                        "materials")
    if r.device_scene.ptris is not geometry:
        raise RuntimeError("phase 12 (b): the material edit replaced ptris")
    captured_step(r, f"(c) {part} after the material edit", tree)
    log(f"phase 12 (b) {part}: refit replay {times['refit_ms']:.1f} ms "
        f"(host {times['refit_host_ms']:.1f}, of it BVH.refit and the node "
        f"repack {times['refit_tree_ms']:.1f}, + upload "
        f"{times['refit_upload_ms']:.1f} ms apart), full bake of the same "
        f"state {times['full_bake_ms']:.1f} ms "
        f"({times['full_bake_ms'] / times['refit_ms']:.2f}x), material-only "
        f"edit {times['material_ms']:.1f} ms")
    # The collapse and the restore: the leaf counts follow ptris.
    col = object_index(scene, EDIT_COLLAPSE)
    sums = [int(qt.leaf_counts(r.device_scene).sum())]
    for scale, what in (((1e-30,) * 3, "collapsed"), ((1.0,) * 3,
                                                      "restored")):
        scene.update_object_scale(col, scale)
        captured_step(r, f"(c) {part} {EDIT_COLLAPSE} {what}", tree)
        ds = r.device_scene
        if not bool((qt.leaf_counts(ds) == qt.row_counts(ds.ptris)).all()):
            raise RuntimeError("phase 12 (c): stale leaf counts")
        sums.append(int(qt.leaf_counts(ds).sum()))
    log(f"phase 12 (c) {part}: leaf counts sum {sums[0]} -> {sums[1]} "
        f"({EDIT_COLLAPSE} collapsed) -> {sums[2]} (restored); each equal "
        "to the row counts of its ptris")
    if not sums[1] < sums[0] == sums[2]:
        raise RuntimeError("phase 12 (c): the collapse did not change the "
                           "leaf counts, or the restore did not bring them "
                           "back")
    counts = all_launch_counts()
    want = ((counts["quad_closest"], counts["quad_occlusion"])
            if tree == "quad" else
            (counts["binary_closest"], counts["binary_occlusion"]))
    if not all(want):
        raise RuntimeError(f"phase 12 (b)/(c) {part}: a kernel was not "
                           f"launched: {counts}")
    log(f"phase 12 (b)/(c) {part}: launches {counts}")
    return r, times


def phase12_fresh(r, scene_fn, device):
    """(d) The refit renderer's scene against a fresh bake of the same
    state: 2 frames each at 1080p, within PIXEL_ATOL / MAX_FLIPPED."""
    from raytracer_tpu_torch.api import ProgressiveRenderer

    reset_all_launch_counts()
    r.reset_accumulation()
    refit = r.render(2)
    fresh = ProgressiveRenderer(r.scene, r.camera, r.config,
                                device=device).render(2)
    quad_launches("(d) refit vs fresh", phase="phase 12")
    gate_pixels("(d) 1080p refit tree vs a fresh build, 2 frames", refit,
                fresh, phase="phase 12")


def edit_session(device, n, frames):
    """interactive_session's edits on the Cornell box at n x n, `frames`
    frames after each (the object add through prebake_async): the images
    after each edit's frames."""
    import dataclasses

    import numpy as np

    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.ops.camera import Camera
    from raytracer_tpu_torch.scene.model import (
        Material,
        create_cornell_box,
        create_sphere,
    )
    from raytracer_tpu_torch.utils.config import RenderConfig

    scene = create_cornell_box()
    r = ProgressiveRenderer(scene, None, RenderConfig(width=n, height=n),
                            device=device)
    tr = scene.objects[0].transform
    li = next(i for i, m in enumerate(scene.materials)
              if m.emission_power > 0)

    def add():
        mesh = scene.add_mesh(create_sphere(6, 6))
        mat = scene.add_material(Material(albedo=(0.2, 0.4, 0.9)))
        scene.add_object("added_sphere", mesh, mat,
                         position=(0.0, -0.3, 0.2), scale=(0.25, 0.25, 0.25))
        r.prebake_async()

    edits = (
        lambda: r.set_camera(Camera.create(position=(0.25, 0.1, -2.8),
                                           aspect=1.0)),
        lambda: scene.update_object_position(
            0, tuple(np.asarray(tr.position) + [0.05, 0.0, 0.0])),
        lambda: scene.update_material(0, dataclasses.replace(
            scene.materials[0], albedo=(0.85, 0.15, 0.1))),
        lambda: scene.update_material(li, dataclasses.replace(
            scene.materials[li],
            emission_power=scene.materials[li].emission_power * 2)),
        add)
    r.render(frames)
    images, branches = [], []
    for edit in edits:
        edit()
        r.step()
        branches.append(r.last_replay)
        images.append(r.render(frames - 1))
    return images, branches


def phase12_small(device):
    """(d) The edit session at EDIT_SMALL, card against CPU, image for
    image within PIXEL_ATOL / MAX_FLIPPED."""
    out = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        reset_all_launch_counts()
        out[str(dev)] = edit_session(dev, EDIT_SMALL, EDIT_SMALL_FRAMES)
        if dev != "cpu":
            quad_launches("(d) small session", phase="phase 12")
        log(f"phase 12 (d): {EDIT_SMALL}x{EDIT_SMALL} session x"
            f"{EDIT_SMALL_FRAMES} frames an edit on {dev} in "
            f"{time.perf_counter() - t0:.2f} s, branches "
            f"{out[str(dev)][1]}")
    (card, card_b), (cpu, cpu_b) = out[str(device)], out["cpu"]
    if card_b != cpu_b or card_b != list(SESSION_BRANCHES.values()):
        raise RuntimeError(f"phase 12 (d): branches {card_b} (CPU {cpu_b})")
    for tag, a, b in zip(SESSION_BRANCHES, card, cpu):
        gate_pixels(f"(d) {EDIT_SMALL}x{EDIT_SMALL} after {tag}", a, b,
                    phase="phase 12")


def phase12(scene_fn, device):
    """The editor path: (a) the interactive session at 1080p, (b)/(c) the
    refit and the material edit on the 1080p atrium with accel auto and
    bvh, each with captured launches, (d) refit against a fresh build and
    the small session card against CPU; (e) each part must launch its
    kernels."""
    t0 = time.perf_counter()
    session = phase12_session(device)
    r, times = phase12_refit(scene_fn, device, "auto")
    phase12_fresh(r, scene_fn, device)
    del r
    _, bvh_times = phase12_refit(scene_fn, device, "bvh")
    phase12_small(device)
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return {"session": session, "auto": times, "bvh": bvh_times}


# Phase 13: the sharded renderer (P12), each part in spawned ranks.
SHARD_FRAMES = 6  # 2 warm and 4 timed, as phase 3
SHARD_TIMEOUT_S = 600.0
# K1 (K3) and K2 (K4) launches a frame on each rank: the plain path
# (phase 3) and ReSTIR (phase 11).
# K1, K2 and S1 launches a frame on each rank.
SHARD_LAUNCHES = {"plain": (3, 3, 3), "restir": (3, 4, 3)}
SHARD_SMALL = 32  # (d), card against CPU
SHARD_SMALL_RESTIR = dict(use_restir=True, restir_spatial_radius=2.0)


def shard_renderer(mesh, device, **cfg):
    """The 1080p atrium at the bench camera, depth 3: on `mesh`, or on one
    device (mesh None)."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.utils.config import RenderConfig

    cam, _ = bench_camera_ubo(device, WIDTH, HEIGHT)
    return ProgressiveRenderer(
        create_benchmark_atrium(TARGET_TRIS), cam,
        RenderConfig(width=WIDTH, height=HEIGHT, max_depth=3, **cfg),
        device=device, mesh=mesh)


def shard_frames(r, label,
                 kinds=("quad_closest", "quad_occlusion", "light_select")):
    """SHARD_FRAMES steps of this rank's renderer `r` with its PhaseTimer
    on: each frame's ms (host clock between device syncs) and launch
    counts of `kinds`, read per frame from 0 set just before. Returns
    (ms/frame of the timed frames, the image after frame 0, peak device
    memory, launches by frame)."""
    import torch
    import torch.distributed as dist

    from raytracer_tpu_torch.utils.profiling import PhaseTimer

    r.timer = PhaseTimer()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launch_counts()
    times, per_frame, first = [], [], None
    for f in range(SHARD_FRAMES):
        before = all_launch_counts()
        _, ms = timed(r.step)
        after = all_launch_counts()
        per_frame.append(tuple(after[k] - before[k] for k in kinds))
        if f >= 2:
            times.append(ms)
        if f == 0:
            first = r.image()
    ms = sum(times) / len(times)
    peak = torch.cuda.max_memory_allocated()
    log(f"phase 13 {label} rank {dist.get_rank()}: {r._rows} pixels "
        f"({r._rows // WIDTH} rows) from {r._pixel_start}, timed frames "
        f"{', '.join(f'{t:.1f}' for t in times)} ms, mean {ms:.1f} "
        f"ms/frame, peak device memory {peak} B, {kinds} launches by "
        f"frame {per_frame}; spans:\n{r.timer.report()}")
    return ms, first, peak, per_frame


def shard_gate_launches(label, per_frame, want):
    if any(tuple(c) != tuple(want) for c in per_frame):
        raise RuntimeError(f"phase 13 {label}: launches by frame "
                           f"{per_frame}, want {want} each")


def phase13_world1(rank, world):
    """(a) A world of 1 over NCCL: the sharded 1080p frames against a
    single-device renderer after the same frames (bit-equal), and the
    single-device ReSTIR image (b) is held against."""
    import numpy as np

    from raytracer_tpu_torch.parallel.sharding import (
        local_device,
        make_pixel_mesh,
    )

    mesh = make_pixel_mesh()
    device = local_device(mesh.device_type)
    r = shard_renderer(mesh, device)
    ms, _, peak, per_frame = shard_frames(r, "(a) world 1, nccl")
    shard_gate_launches("(a)", per_frame, SHARD_LAUNCHES["plain"])
    img = r.image()
    del r
    out = {"ms": ms, "peak": peak, "launches": per_frame[0]}
    for name, cfg in (("plain", {}), ("restir", {"use_restir": True})):
        single = shard_renderer(None, device, **cfg)
        for _ in range(SHARD_FRAMES):
            single.step()
        out[f"{name}_single"] = single.image()
        del single
    same = bool(np.array_equal(img, out["plain_single"]))
    log(f"phase 13 (a): world 1 image bit-equal to the single-device "
        f"renderer's after {SHARD_FRAMES} frames: {same}")
    if not same:
        gate_pixels("(a) world 1 vs single", img, out["plain_single"],
                    phase="phase 13")
        raise RuntimeError("phase 13 (a): the world-1 image differs")
    return out


def phase13_world2(rank, world, refs):
    """(b) Plain NEE and ReSTIR at the defaults in a world of 2 over gloo,
    both ranks on the one card: per-rank ms/frame, spans, peak memory and
    launches by frame, one captured K1 and K2 launch per rank, the images
    against `refs` (a)'s single-device ones; (c) one accel="bvh" frame;
    (d) the Cornell box at SHARD_SMALL, the card's world of 2 against a
    single-device CPU render."""
    import numpy as np

    from raytracer_tpu_torch.parallel.sharding import (
        local_device,
        make_pixel_mesh,
    )

    mesh = make_pixel_mesh()
    device = local_device(mesh.device_type)
    out = {}
    imgs = {}
    for name, cfg in (("plain", {}), ("restir", {"use_restir": True})):
        r = shard_renderer(mesh, device, **cfg)
        ms, first, peak, per_frame = shard_frames(
            r, f"(b) {name} world 2, gloo")
        shard_gate_launches(f"(b) {name}", per_frame, SHARD_LAUNCHES[name])
        imgs[name] = r.image()
        if name == "plain":
            imgs["first"] = first
        out[name] = {"ms": ms, "peak": peak, "spans": dict(r.timer.totals),
                     "calls": dict(r.timer.counts)}
        with capture_launches(0, 0 if name == "plain" else 1) as kept:
            r.step()
        check_captured(f"(b) {name} rank {rank}", kept, phase="phase 13")
        del r
    for name in ("plain", "restir"):
        same = bool(np.array_equal(imgs[name], refs[f"{name}_single"]))
        log(f"phase 13 (b) rank {rank}: {name} gathered image bit-equal to "
            f"the single-device one after {SHARD_FRAMES} frames: {same}")
        if not same:
            gate_pixels(f"(b) {name} world 2 vs single", imgs[name],
                        refs[f"{name}_single"], phase="phase 13")
            raise RuntimeError(f"phase 13 (b): the {name} image differs")

    # (c) accel="bvh": K3/K4 on each rank, not K1/K2.
    kinds = ("binary_closest", "binary_occlusion", "quad_closest",
             "quad_occlusion")
    r = shard_renderer(mesh, device, accel="bvh")
    reset_all_launch_counts()
    r.step()
    counts = tuple(all_launch_counts()[k] for k in kinds)
    img = r.image()
    del r
    same = bool(np.array_equal(img, imgs["first"]))
    log(f"phase 13 (c) rank {rank}: accel=bvh frame, {kinds} launches "
        f"{counts}; bit-equal to (b)'s first frame: {same}")
    if counts != (3, 3, 0, 0) or not same:
        raise RuntimeError(f"phase 13 (c): launches {counts} or the image "
                           "differs")
    out["small"] = phase13_small(mesh, device, rank)
    return out


def phase13_small(mesh, device, rank):
    """(d) The Cornell box at SHARD_SMALL on the card's world of 2, and
    (rank 0) on one CPU device: plain, spp_batch=2, adaptive, previews,
    AOVs, the denoised image and ReSTIR within PIXEL_ATOL / MAX_FLIPPED."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.scene.model import create_cornell_box
    from raytracer_tpu_torch.utils.config import RenderConfig

    def modes(dev, m):
        n = SHARD_SMALL

        def make(**cfg):
            return ProgressiveRenderer(
                create_cornell_box(), None,
                RenderConfig(width=n, height=n, **cfg), device=dev, mesh=m)

        reset_all_launch_counts()
        out = {}
        r = make()
        out["plain"] = r.render(2)
        out["aovs"] = r.aovs()
        out["denoised"] = r.image(denoise=True)
        out["preview"] = r.preview_image(PREVIEW_SCALE, denoise=False)
        out["preview_denoised"] = r.preview_image(PREVIEW_SCALE,
                                                  denoise=True)
        out["spp"] = make(spp_batch=2).render(2)
        ada = make(adaptive_tol=MODES_TOL, adaptive_min_frames=2)
        out["adaptive"] = ada.render(4)
        out["restir"] = make(**SHARD_SMALL_RESTIR).render(
            RESTIR_SMALL_FRAMES)
        if m is not None:
            quad_launches(f"(d) rank {rank}", phase="phase 13")
        return out

    t0 = time.perf_counter()
    card = modes(device, mesh)
    log(f"phase 13 (d) rank {rank}: {SHARD_SMALL}x{SHARD_SMALL} modes on "
        f"the card's world of 2 in {time.perf_counter() - t0:.2f} s")
    if rank != 0:
        return None
    t0 = time.perf_counter()
    cpu = modes("cpu", None)
    log(f"phase 13 (d): the same on one CPU device in "
        f"{time.perf_counter() - t0:.2f} s")
    for key, a in card.items():
        if key == "aovs":
            gate_aovs(f"(d) {SHARD_SMALL}x{SHARD_SMALL}", a, cpu[key],
                      phase="phase 13")
        else:
            gate_pixels(f"(d) {SHARD_SMALL}x{SHARD_SMALL} {key}", a,
                        cpu[key], phase="phase 13")
    return True


def phase13(phase3_ms):
    """The sharded renderer in spawned ranks: (a) a world of 1 over NCCL,
    (b)-(d) a world of 2 over gloo on the one card."""
    from raytracer_tpu_torch.parallel.launch import spawn

    t0 = time.perf_counter()
    (a,) = spawn(phase13_world1, 1, backend="nccl",
                 timeout_s=SHARD_TIMEOUT_S)
    log(f"phase 13 (a): world 1 over NCCL {a['ms']:.1f} ms/frame against "
        f"phase 3's {phase3_ms:.1f} ({a['ms'] / phase3_ms:.3f}x), peak "
        f"{a['peak']} B, K1/K2/S1 launches a frame {a['launches']}")
    refs = {k: a[k] for k in ("plain_single", "restir_single")}
    ranks = spawn(phase13_world2, 2, (refs,), backend="gloo",
                  timeout_s=SHARD_TIMEOUT_S)
    for name in ("plain", "restir"):
        for rank, out in enumerate(ranks):
            b = out[name]
            spans = ", ".join(
                f"{k} {1e3 * v / b['calls'][k]:.1f} ms x{b['calls'][k]}"
                for k, v in b["spans"].items())
            log(f"phase 13 (b) {name} rank {rank}: {b['ms']:.1f} ms/frame "
                f"(phase 3 {phase3_ms:.1f}), peak {b['peak']} B; spans "
                f"{spans}")
    log(f"phase 13: {time.perf_counter() - t0:.1f} s")


# --- phase 14: deep compaction, multi-part and stable bakes, the walk -----

DEEP_DEPTH = 8  # (a)
MULTIPART_TRIS = 1_000_000  # (b)
# (b): the JAX package's PALLAS_VMEM_BUDGET (raytracer_tpu/api.py:40).
MULTIPART_BUDGET = 90 * 1024 * 1024
WALK_STACK_CAP = 16  # (d): below the atrium's binary depth + 2
SMALL_BUDGET = 96 * 1024  # (e): the Cornell box in parts, as the JAX tests
SMALL_DEEP = (64, 32)  # (e): (a) at 2048 lanes, so that a prefix runs
SMALL_DEEP_DECAY = 0.25  # (e): bounce 4 on a 1024-lane prefix


def renderer14(scene_fn, device, size, **cfg):
    """A ProgressiveRenderer at the bench camera with RenderConfig(width,
    height, **cfg) (depth 3 unless cfg says otherwise); the bake timed."""
    import torch

    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.utils.config import RenderConfig

    w, h = size
    cam, _ = bench_camera_ubo(device, w, h)
    t0 = time.perf_counter()
    r = ProgressiveRenderer(scene_fn(), cam, RenderConfig(
        width=w, height=h, **cfg), device=device)
    torch.cuda.synchronize()
    r.bake_s = time.perf_counter() - t0
    return r


def frames14(r, warm, timed_n):
    """`warm` + `timed_n` steps of `r` from a reset accumulation, every
    launch count set to 0 just before and read just after: (ms/frame over
    the timed steps, launches a frame, the image)."""
    r.reset_accumulation()
    reset_all_launch_counts()
    times = []
    for f in range(warm + timed_n):
        _, ms = timed(r.step)
        if f >= warm:
            times.append(ms)
    launches = {k: v / (warm + timed_n)
                for k, v in all_launch_counts().items()}
    return statistics.mean(times), launches, r.image()


# The launch functions of K1-K4 and the count of their ray arguments before
# the scene (or part) argument.
LAUNCH_FNS = (("quad", "_intersect_quad_cuda", "K1", 3),
              ("quad", "_occlusion_quad_cuda", "K2", 4),
              ("binary", "_intersect_binary_cuda", "K3", 4),
              ("binary", "_occlusion_binary_cuda", "K4", 5))


@contextlib.contextmanager
def record_launches(keep=None):
    """Wraps K1-K4's launch functions for the block (the launches and
    their counts stay the path's): yields rec, rec["launches"] holding
    (kernel, rays, part) of every launch, rec["kept"][(kernel, id(part))]
    the rays, results and tables of the first launch of each kernel and
    part that keep(kernel, rays) accepts (check_kept holds them against the
    plain walks)."""
    import torch

    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    mods = {"quad": qt, "binary": bt}
    rec = {"launches": [], "kept": {}}
    saved = []
    for tree, name, kernel, n_in in LAUNCH_FNS:
        fn = getattr(mods[tree], name)
        saved.append((mods[tree], name, fn))

        def wrapped(*args, _fn=fn, _kernel=kernel, _n_in=n_in, **kw):
            out = _fn(*args, **kw)
            part, n = args[_n_in], args[0].shape[0]
            rec["launches"].append((_kernel, n, part))
            key = (_kernel, id(part))
            if (keep is not None and key not in rec["kept"]
                    and keep(_kernel, n)):
                outs = out if isinstance(out, tuple) else (out,)
                rec["kept"][key] = (
                    _kernel, tuple(x.clone() if torch.is_tensor(x) else x
                                   for x in args[:_n_in]),
                    tuple(x.clone() for x in outs), part)
            return out

        setattr(mods[tree], name, wrapped)
    try:
        yield rec
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def check_kept(what, rec, want_kernels):
    """Raise unless every launch record_launches kept equals its plain
    walk, run on the card on the same rays and tables, bit for bit, and a
    launch of each of `want_kernels` was kept."""
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    t0 = time.perf_counter()
    said = []
    for kernel, inputs, got, p in rec["kept"].values():
        if kernel == "K1":
            ref = qt._intersect_quad_plain(*inputs, p.root, p.qmeta,
                                           p.qnodes, p.ptris)
        elif kernel == "K2":
            ref = (qt._occlusion_quad_plain(*inputs, p.root, p.qmeta,
                                            p.qnodes, p.ptris),)
        elif kernel == "K3":
            ref = bt._intersect_binary_plain(*inputs, p.binary_root,
                                             p.pnodes, p.ptris)
        else:
            ref = (bt._occlusion_binary_plain(*inputs, p.binary_root,
                                              p.pnodes, p.ptris),)
        if kernel in ("K1", "K3"):
            gate_closest(f"phase 14 {what} {kernel}", got, ref)
        else:
            mism = int((got[0] != ref[0]).sum())
            if mism:
                raise RuntimeError(f"phase 14 {what}: {kernel} != plain "
                                   f"version on {mism} rays")
        said.append((kernel, inputs[0].shape[0],
                     inactive_share(inputs[2])))
    missing = set(want_kernels) - {k for k, _, _ in said}
    if missing:
        raise RuntimeError(f"phase 14 {what}: no launch of {missing} kept")
    summary = "; ".join(
        f"{k} x{len(rows)} on {sorted({n for n, _ in rows})} rays, "
        f"{min(i for _, i in rows):.4f}-{max(i for _, i in rows):.4f} of "
        "the lanes inactive"
        for k in sorted({k for k, _, _ in said})
        for rows in [[(n, i) for kk, n, i in said if kk == k]])
    log(f"phase 14 {what}: {len(said)} captured launches equal to the "
        f"plain walks on the card, every ray: {summary} "
        f"({time.perf_counter() - t0:.2f} s)")


def phase14_deep(scene_fn, device):
    """(a) The 1080p atrium at depth DEEP_DEPTH, compact_deep on and off."""
    import numpy as np
    import torch

    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import quad_traverse as qt

    r = renderer14(scene_fn, device, (WIDTH, HEIGHT), max_depth=DEEP_DEPTH)
    n = WIDTH * HEIGHT
    out = {}
    for compact in (True, False):
        r.config = r.config.replace(compact_deep=compact)
        ms, launches, img = frames14(r, 2, 4)
        out[compact] = (ms, img)
        log(f"phase 14 (a) depth {DEEP_DEPTH} compact_deep={compact}: "
            f"{ms:.1f} ms/frame, launches a frame {launches}, image mean "
            f"{float(img.mean()):.5f}")
        if not (launches["quad_closest"] and launches["quad_occlusion"]):
            raise RuntimeError(f"phase 14 (a): K1/K2 not launched: "
                               f"{launches}")
        if not np.isfinite(img).all() or not img.mean() > 0:
            raise RuntimeError("phase 14 (a): image not finite, non-black")
    if not np.array_equal(out[True][1], out[False][1]):
        d = np.abs(out[True][1] - out[False][1])
        raise RuntimeError(f"phase 14 (a): compacted image != uncompacted "
                           f"({int((d.max(-1) > 0).sum())} pixels differ)")
    log(f"phase 14 (a): compacted and uncompacted images bit-equal after 6 "
        f"frames; {out[True][0]:.1f} against {out[False][0]:.1f} ms/frame "
        f"({out[True][0] / out[False][0]:.3f}x)")

    # One instrumented compacted frame: each bounce's lanes and live
    # count, the sorts' ms, the shadow sets, K1/K2's lanes; one K1 and one
    # K2 launch on a prefix kept.
    r.config = r.config.replace(compact_deep=True)
    bounces, sorts, shadow_sets = [], [], []
    bounce, sort, occluded = wf.path_bounce, wf._sort_wavefront, wf._occluded

    def counted_bounce(scene, state, depth, cfg, clear_color):
        bounces.append((depth, state.alive.shape[0],
                        int(state.alive.sum())))
        return bounce(scene, state, depth, cfg, clear_color)

    def timed_sort(state, scene):
        out, ms = timed(lambda: sort(state, scene))
        sorts.append(ms)
        return out

    def kept_occluded(*args):
        shadow_sets.append(tuple(a.clone() if torch.is_tensor(a) else a
                                 for a in args))
        return occluded(*args)

    wf.path_bounce, wf._sort_wavefront = counted_bounce, timed_sort
    wf._occluded = kept_occluded
    try:
        with record_launches(keep=lambda kernel, rays: rays < n) as rec:
            r.step()
    finally:
        wf.path_bounce, wf._sort_wavefront = bounce, sort
        wf._occluded = occluded
    for depth, lanes, live in bounces:
        k = wf._compact_prefix(n, depth, r.config)
        log(f"phase 14 (a) bounce {depth}: prefix k {k}, live {live}, run "
            f"on {lanes} lanes")
    log(f"phase 14 (a) launches and lanes: "
        f"{[(kernel, rays) for kernel, rays, _ in rec['launches']]}")
    if not any(lanes < n for _, lanes, _ in bounces):
        raise RuntimeError("phase 14 (a): no bounce ran on a prefix")
    log(f"phase 14 (a): {len(sorts)} bounce sorts (sort + state permute), "
        f"{sum(sorts):.2f} ms a frame, "
        f"{', '.join(f'{ms:.2f}' for ms in sorts)} ms each")
    check_kept("(a) compacted", rec, ("K1", "K2"))

    # The shadow-ray sort against the K2 time it saves, on the frame's
    # shadow sets: each set 3 times unsorted and sorted, K2 timed inside.
    k2_ms = []
    k2 = qt._occlusion_quad_cuda

    def timed_k2(*args, **kw):
        res, ms = timed(lambda: k2(*args, **kw))
        k2_ms.append(ms)
        return res

    qt._occlusion_quad_cuda = timed_k2
    totals = {"unsorted": [0.0, 0.0], "sorted": [0.0, 0.0]}
    try:
        for args in shadow_sets:
            masks = {}
            for label, fn in (("unsorted", occluded),
                              ("sorted", wf._occluded_sorted)):
                for _ in range(3):
                    k2_ms.clear()
                    masks[label], ms = timed(lambda: fn(*args))
                    totals[label][0] += ms / 3
                    totals[label][1] += sum(k2_ms) / 3
            if not torch.equal(masks["unsorted"], masks["sorted"]):
                raise RuntimeError("phase 14 (a): the sorted shadow rays' "
                                   "mask != the unsorted one")
    finally:
        qt._occlusion_quad_cuda = k2
    (u_all, u_k2), (s_all, s_k2) = totals["unsorted"], totals["sorted"]
    log(f"phase 14 (a) shadow sort over the frame's {len(shadow_sets)} "
        f"shadow sets: unsorted {u_all:.2f} ms (K2 {u_k2:.2f}), sorted "
        f"{s_all:.2f} ms (K2 {s_k2:.2f}, sort and scatter "
        f"{s_all - s_k2:.2f}); K2 saves {u_k2 - s_k2:.2f} ms for "
        f"{s_all - s_k2:.2f} ms of sorting")


def phase14_parts(device):
    """(b) The 1M atrium baked as one part and in parts at the JAX budget,
    each rendered with accel "cuda" and "bvh"."""
    import numpy as np

    import raytracer_tpu_torch.api as tapi
    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium

    imgs = {}
    for label, budget in (("one part", None), ("parts", MULTIPART_BUDGET)):
        tapi.PALLAS_VMEM_BUDGET = budget
        try:
            r = renderer14(lambda: create_benchmark_atrium(MULTIPART_TRIS),
                           device, (WIDTH, HEIGHT), accel="cuda")
        finally:
            tapi.PALLAS_VMEM_BUDGET = None
        ds = r.device_scene
        p = ds.num_parts
        log(f"phase 14 (b) {label}: {p} part(s), bake {r.bake_s:.2f} s, "
            f"{ds.num_triangles} triangles, qnodes {tuple(ds.qnodes.shape)}"
            f", ptris {tuple(ds.ptris.shape)}, {ds.pallas_vmem_bytes} B a "
            f"pass at the JAX budget's count")
        for accel, kinds in (("cuda", ("quad_closest", "quad_occlusion")),
                             ("bvh", ("binary_closest",
                                      "binary_occlusion"))):
            r.config = r.config.replace(accel=accel)
            ms, launches, img = frames14(r, 1, 2)
            imgs[(label, accel)] = img
            log(f"phase 14 (b) {label} accel={accel}: {ms:.1f} ms/frame, "
                f"launches a frame {launches}")
            if any(launches[k] != 3 * p for k in kinds):
                raise RuntimeError(f"phase 14 (b) {label} {accel}: want "
                                   f"{3 * p} launches a frame of {kinds}")
            if not np.isfinite(img).all() or not img.mean() > 0:
                raise RuntimeError("phase 14 (b): image not finite, "
                                   "non-black")
        if p > 1:
            with record_launches(keep=lambda kernel, rays: True) as rec:
                r.step()
                r.config = r.config.replace(accel="cuda")
                r.step()
            parts = {id(q) for q in ds.parts}
            kept = {(k, i) for k, i in rec["kept"] if i in parts}
            if len(kept) != 4 * p:
                raise RuntimeError(f"phase 14 (b): kept {len(kept)} "
                                   f"launches, want one per kernel and part")
            check_kept("(b) per part", rec, ("K1", "K2", "K3", "K4"))
    if imgs[("parts", "cuda")].shape != imgs[("one part", "cuda")].shape:
        raise RuntimeError("phase 14 (b): image shapes differ")
    for accel in ("cuda", "bvh"):
        a, b = imgs[("parts", accel)], imgs[("one part", accel)]
        if not np.array_equal(a, b):
            raise RuntimeError(f"phase 14 (b) accel={accel}: multi-part "
                               f"image != one-part image "
                               f"({int((np.abs(a - b).max(-1) > 0).sum())} "
                               "pixels differ)")
    log("phase 14 (b): multi-part images bit-equal to the one-part images "
        "under accel cuda and bvh after 3 frames")


def phase14_stable(scene_fn, device):
    """(c) Phase 3's frame on the exact bake and on the stable bake."""
    import numpy as np

    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import quad_traverse as qt

    imgs = {}
    for stable in (False, True):
        r = renderer14(scene_fn, device, (WIDTH, HEIGHT), stable_bake=stable)
        ds = r.device_scene
        log(f"phase 14 (c) stable_bake={stable}: bake {r.bake_s:.2f} s, "
            f"{ds.num_triangles} triangle rows, {ds.num_lights} light rows, "
            f"qnodes {tuple(ds.qnodes.shape)}, pnodes "
            f"{tuple(ds.pnodes.shape)}, ptris {tuple(ds.ptris.shape)}, "
            f"stack need {ds.q_stack_need} (K1/K2), {bt.stack_need(ds)} "
            f"(K3/K4), true counts "
            f"{None if ds.true_counts is None else ds.true_counts.tolist()}")
        for label, info in (("K1/K2", qt.launch_info),
                            ("K3/K4", bt.launch_info)):
            for kernel in ("closest", "occlusion"):
                i = info(kernel, ds)
                log(f"phase 14 (c) stable_bake={stable} {label} {kernel}: "
                    f"{i['registers']} registers, dynamic shared "
                    f"{i['smem_bytes']} B a block, {i['blocks_per_sm']} "
                    f"blocks a SM, grid {i['grid']}")
        for accel, kinds in (("cuda", ("quad_closest", "quad_occlusion")),
                             ("bvh", ("binary_closest",
                                      "binary_occlusion"))):
            r.config = r.config.replace(accel=accel)
            ms, launches, img = frames14(r, 2, 4)
            imgs[(stable, accel)] = img
            log(f"phase 14 (c) stable_bake={stable} accel={accel}: "
                f"{ms:.1f} ms/frame, launches a frame {launches}")
            if any(launches[k] != 3 for k in kinds):
                raise RuntimeError(f"phase 14 (c): want 3 launches a frame "
                                   f"of {kinds}: {launches}")
        if stable:
            with record_launches(keep=lambda kernel, rays: True) as rec:
                r.step()
                r.config = r.config.replace(accel="cuda")
                r.step()
            check_kept("(c) stable bake", rec, ("K1", "K2", "K3", "K4"))
    for accel in ("cuda", "bvh"):
        if not np.array_equal(imgs[(True, accel)], imgs[(False, accel)]):
            raise RuntimeError(f"phase 14 (c) accel={accel}: stable image "
                               "!= exact image")
    log("phase 14 (c): stable-bake images bit-equal to the exact bake's "
        "under accel cuda and bvh after 6 frames")


def phase14_walk(scene_fn, device):
    """(d) accel="bvh" with STACK_CAP lowered: the skip-link walk."""
    import numpy as np

    from raytracer_tpu_torch.integrator import wavefront as wf
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.ops import traverse

    ref = renderer14(scene_fn, device, (WIDTH, HEIGHT), accel="bvh")
    _, ref_launches, ref_img = frames14(ref, 0, 1)
    del ref
    steps = []
    walks = (wf.intersect_bvh, wf.occlusion_bvh)

    def counted(walk):
        def run(*args, **kw):
            before = traverse.steps
            out = walk(*args, **kw)
            steps.append((walk.__name__, traverse.steps - before))
            return out
        return run

    saved = bt.STACK_CAP
    bt.STACK_CAP = WALK_STACK_CAP
    wf.intersect_bvh, wf.occlusion_bvh = (counted(w) for w in walks)
    try:
        r = renderer14(scene_fn, device, (WIDTH, HEIGHT), accel="bvh")
        if bt.stack_fits(r.device_scene.bvh_max_depth):
            raise RuntimeError("phase 14 (d): the tree still fits")
        ms, launches, img = frames14(r, 0, 1)
    finally:
        bt.STACK_CAP = saved
        wf.intersect_bvh, wf.occlusion_bvh = walks
    log(f"phase 14 (d) skip-link walk (STACK_CAP {WALK_STACK_CAP}, depth "
        f"{r.device_scene.bvh_max_depth}): {ms:.1f} ms for the 1080p "
        f"frame, bake {r.bake_s:.2f} s, launches {launches}; micro-steps a "
        f"trace {steps}")
    if any(launches[k] for k in TRAVERSAL_KINDS) or not steps:
        raise RuntimeError(f"phase 14 (d): the frame did not take the walk "
                           f"alone: {launches}, {steps}")
    if not np.isfinite(img).all() or not img.mean() > 0:
        raise RuntimeError("phase 14 (d): image not finite, non-black")
    gate_pixels(f"(d) walk vs K3/K4 ({ref_launches} a frame) after 1 frame",
                img, ref_img, phase="phase 14")


def phase14_small(device):
    """(e) (a)-(d) on the Cornell box, card against CPU."""
    import raytracer_tpu_torch.api as tapi
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.ops import binary_traverse as bt
    from raytracer_tpu_torch.scene.model import create_cornell_box
    from raytracer_tpu_torch.utils.config import RenderConfig

    s = MODES_SMALL
    cases = (
        ("(a) deep", SMALL_DEEP, dict(max_depth=DEEP_DEPTH,
                                      compact_decay=SMALL_DEEP_DECAY), {}),
        ("(b) parts", (s, s), {}, {"PALLAS_VMEM_BUDGET": SMALL_BUDGET}),
        ("(c) stable", (s, s), dict(stable_bake=True), {}),
        ("(d) walk", (s, s), dict(accel="bvh"), {"STACK_CAP": 4}),
    )
    mods = {"PALLAS_VMEM_BUDGET": tapi, "STACK_CAP": bt}
    for what, (w, h), cfg, patch in cases:
        saved = {k: getattr(mods[k], k) for k in patch}
        for k, v in patch.items():
            setattr(mods[k], k, v)
        try:
            imgs = {}
            for dev in (device, "cpu"):
                reset_all_launch_counts()
                r = ProgressiveRenderer(create_cornell_box(), None,
                                        RenderConfig(width=w, height=h,
                                                     **cfg), device=dev)
                imgs[str(dev)] = r.render(2)
                if dev is device:
                    launches = all_launch_counts()
                    parts = r.device_scene.num_parts
        finally:
            for k, v in saved.items():
                setattr(mods[k], k, v)
        walked = what == "(d) walk"
        if walked == any(launches[k] for k in TRAVERSAL_KINDS):
            raise RuntimeError(f"phase 14 (e) {what}: launches {launches}")
        gate_pixels(f"(e) {what} Cornell {w}x{h} x2 card vs CPU ({parts} "
                    f"part(s), launches {launches})", imgs[str(device)],
                    imgs["cpu"], phase="phase 14")


def phase14(scene_fn, device):
    t0 = time.perf_counter()
    phase14_deep(scene_fn, device)
    phase14_parts(device)
    phase14_stable(scene_fn, device)
    phase14_walk(scene_fn, device)
    phase14_small(device)
    log(f"phase 14: {time.perf_counter() - t0:.1f} s")


# --- phase 15: NEE light selection (S1) on the renderer's own tensors -----

SELECT_REPS = 20  # CUDA-event launches timed


@contextlib.contextmanager
def capture_select(at):
    """Keeps the arguments and the outputs of `_shade`'s light selection
    call number `at`, counted from 0 within the block, as the path makes
    it: integrator/wavefront.py's select_lights is wrapped, so the launch
    is the path's own. Yields a dict with "args", "kw" and "out"."""
    import torch

    from raytracer_tpu_torch.integrator import wavefront as wf

    def clone(x):
        return x.clone() if isinstance(x, torch.Tensor) else x

    kept, seen = {}, [0]
    select = wf.select_lights

    def wrapped(*args, **kw):
        out = select(*args, **kw)
        if seen[0] == at:
            kept["args"] = tuple(clone(a) for a in args)
            kept["kw"] = {k: clone(v) for k, v in kw.items()}
            kept["out"] = type(out)(*(clone(x) for x in out))
        seen[0] += 1
        return out

    wf.select_lights = wrapped
    try:
        yield kept
    finally:
        wf.select_lights = select


def select_bound(n, num_lights, sel, draw, mis):
    """The bound of one S1 launch on `n` lanes over `num_lights` columns
    (bound_of()): bytes, each lane's inputs and outputs once (12 B of
    position; a draw's 13 in and 17 out; MIS's 4 in and 8 out) and the
    light rows once (20 B a row); FP32 operations, 10 a weight (3
    subtractions, 3 multiplies, 2 adds, the clamp and the division, each
    counted as one) and in the first pass 1 for MIS's sum and 2 for the
    draw's (a select and an add; the integer compare not counted), in the
    second pass up to each pick's column (its `selected` + 1) 13 a column,
    4 a lane for r1 and the pdf, and 10 for MIS's w_this."""
    nbytes = n * (12 + (30 if draw else 0) + (12 if mis else 0))
    nbytes += num_lights * 20
    ops = n * num_lights * (10 + (1 if mis else 0) + (2 if draw else 0))
    if draw:
        visited = int((sel.selected.long() + 1)[sel.found].sum())
        ops += 13 * visited + 4 * n
    if mis:
        ops += 10 * n
    return bound_of(nbytes, ops)


def phase15_scene(what, r):
    """One frame of renderer `r` with its bounce-1 selection kept, the
    kernel's outputs against the plain version's on the same inputs (on
    the CPU), bit for bit; the kernel's ms (CUDA events) and the plain
    version's on the card (host clock, one run) beside select_bound()."""
    import torch

    from raytracer_tpu_torch.lab.rays import cuda_ms
    from raytracer_tpu_torch.ops import light_select as ls

    r.step()
    with capture_select(1) as kept:
        r.step()
    args, kw, got = kept["args"], kept["kw"], kept["out"]
    pos, centers, powers, objects = args
    inputs = (*args, kw["obj"], kw["do_nee"], kw["seed"], kw["light_index"])
    draw, mis = kw["do_nee"] is not None, kw["light_index"] is not None
    n, num_lights = pos.shape[0], powers.shape[0]
    t0 = time.perf_counter()
    want, _ = ls._select_plain(
        *(None if x is None else x.cpu() for x in inputs), False)
    cpu_s = time.perf_counter() - t0
    for name in ls.LightSelection._fields:
        a, b = getattr(got, name), getattr(want, name)
        if (a is None) != (b is None) or (
                a is not None and not torch.equal(a.cpu(), b)):
            raise RuntimeError(f"phase 15 {what}: the kernel's {name} != "
                               "the plain version's")
    before = ls.launches
    ms = cuda_ms(lambda: ls.select_lights(*args, **kw), SELECT_REPS)
    if ls.launches != before + SELECT_REPS + 1:
        raise RuntimeError(f"phase 15 {what}: the timed calls launched "
                           f"{ls.launches - before} kernels")
    plain_out, plain_ms = timed(lambda: ls._select_plain(*inputs, False))
    plain_same = all(
        x is None or torch.equal(x.cpu(), getattr(want, k))
        for k, x in zip(ls.LightSelection._fields, plain_out[0]))
    b = select_bound(n, num_lights, got, draw, mis)
    drew = int(got.found.sum()) if draw else 0
    log(f"phase 15 {what}: bounce-1 selection, {n} lanes, L = "
        f"{num_lights} (draw {draw}, MIS {mis}), {drew} drew; kernel "
        f"bit-equal to the plain version on the CPU ({cpu_s:.2f} s); "
        f"kernel {ms:.4f} ms (mean of {SELECT_REPS}), plain on the card "
        f"{plain_ms:.2f} ms (bit-equal to the CPU's: {plain_same}); bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
        f"{b['ops']} FP32 operations), {100 * b['bound_ms'] / ms:.1f}% of "
        "the bound")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": 0.0,
            "lanes": n, "columns": num_lights, **b}


def phase15(scene_fn, device):
    """S1 on the bounce-1 wavefront of the 1080p atrium and of the 1080p
    64-light grid (NEE)."""
    from raytracer_tpu_torch.scene.benchmark import (
        create_benchmark_lightgrid,
    )

    t0 = time.perf_counter()
    out = {"atrium": phase15_scene(
        "atrium", modes_renderer(scene_fn, device, (WIDTH, HEIGHT)))}
    out["lightgrid"] = phase15_scene(
        "lightgrid", restir_renderer(create_benchmark_lightgrid, device,
                                     (WIDTH, HEIGHT), cam=LIGHTGRID_CAM,
                                     use_restir=False))
    log(f"phase 15: {time.perf_counter() - t0:.1f} s")
    return out


def phase4():
    from raytracer_tpu_torch import cli
    from raytracer_tpu_torch.utils.image import read_png

    with tempfile.TemporaryDirectory() as tmp:
        scene = os.path.join(tmp, "cornell.json")
        out = os.path.join(tmp, "cornell.png")
        with open(scene, "w") as f:
            json.dump(CORNELL_JSON, f)
        t0 = time.perf_counter()
        rc = cli.main([scene, "--width", "256", "--height", "256", "--spp",
                       "8", "--out", out])
        img = read_png(out) if os.path.exists(out) else None
        log(f"phase 4: CLI rc {rc} in {time.perf_counter() - t0:.2f} s, png "
            f"{None if img is None else img.shape}, pixel std "
            f"{None if img is None else float(img.std()):.4}")
        if rc != 0 or img is None or img.shape != (256, 256, 3) \
                or not img.std() > 0:
            raise RuntimeError("the CLI did not write a non-uniform PNG")


def main():
    phase0()  # exits before importing the port when there is no card
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    from raytracer_tpu_torch.scene.benchmark import create_benchmark_atrium
    from raytracer_tpu_torch.scene.device_scene import bake_scene

    device = torch.device("cuda", 0)
    phase1()
    t0 = time.perf_counter()
    ds, _ = bake_scene(create_benchmark_atrium(TARGET_TRIS), leaf_size=16,
                       device=device)
    torch.cuda.synchronize()
    log(f"phase 2: atrium bake {time.perf_counter() - t0:.2f} s, "
        f"{ds.num_triangles} triangles, stack need {ds.q_stack_need}")
    k = phase2(ds, device)
    del ds
    atrium = lambda: create_benchmark_atrium(TARGET_TRIS)  # noqa: E731
    cuda_launches, cuda_img, cuda_ms = phase3(atrium, device)
    phase4()
    bvh_launches = phase5(atrium, device, cuda_img)
    lab = phase6(device)
    lab2 = phase7(device)
    lab3 = phase8(device)
    lab4 = phase9(device)
    phase10(atrium, device, cuda_ms)
    phase11(atrium, device, cuda_ms)
    phase12(atrium, device)
    phase13(cuda_ms)
    phase14(atrium, device)
    select = phase15(atrium, device)

    def entry(name, source, replaces, launches, shown, *others):
        """A kernel's entry of the kernels line: the ms, plain ms and bound
        of the run `shown`, the largest error over it and `others`."""
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": max(r["max_abs_err"]
                                   for r in (shown, *others)),
                "ms": shown["ms"], "plain_ms": shown["plain_ms"],
                "bound_ms": shown["bound_ms"], "bound_by": shown["bound_by"],
                # No PyTorch call computes a BVH walk, a fixed-sequence
                # walk, a K-step chain or a light selection.
                "library_ms": None}

    kernels = [
        entry("quad_closest", KERNEL_SOURCE,
              "raytracer_tpu/ops/pallas_subpacket.py:329",
              cuda_launches["quad_closest"], k["closest_incoherent"],
              k["closest_primary"], k["closest_incoherent_inactive"]),
        entry("quad_occlusion", KERNEL_SOURCE,
              "raytracer_tpu/ops/pallas_subpacket.py:423",
              cuda_launches["quad_occlusion"], k["occlusion_shadow"],
              k["occlusion_shadow_inactive"]),
        entry("binary_closest", BINARY_SOURCE,
              "raytracer_tpu/ops/pallas_traverse.py:167",
              bvh_launches["binary_closest"], k["binary_closest_incoherent"],
              *(k[f"binary_closest_{name}"]
                for name, _, _ in BINARY_CLOSEST_RUNS)),
        entry("binary_occlusion", BINARY_SOURCE,
              "raytracer_tpu/ops/pallas_traverse.py:227",
              bvh_launches["binary_occlusion"], k["binary_occlusion_shadow"],
              *(k[f"binary_occlusion_{name}"]
                for name, _, _ in BINARY_SHADOW_RUNS)),
        entry("light_select", SELECT_SOURCE,
              "raytracer_tpu/integrator/wavefront.py:588",
              cuda_launches["light_select"], select["lightgrid"],
              select["atrium"]),
    ]
    for source, report, names in (
            (LAB_SOURCE, lab, (("lab_closest", "tools/kernel_lab.py:273"),
                               ("lab_closest_ts", "tools/kernel_lab.py:378"),
                               ("lab_occlusion", "tools/occl_lab.py:163"),
                               ("lab_closest4", "tools/bvh4_lab.py:302"))),
            (LAB2_SOURCE, lab2, (
                ("lab_closest_cm", "tools/v2_kernel_lab.py:174"),
                ("lab_closest_queued", "tools/v3_kernel_lab.py:290"),
                ("lab_closest_pair", "tools/v4_interleave_lab.py:276"),
                ("lab_closest4_queued", "tools/r3_kernel_lab.py:334"))),
            (LAB2_SOURCE, lab3, (
                ("lab_closest8_queued", "tools/r3_oct_lab.py:265"),
                ("lab_occlusion4_queued", "tools/r3_occl3_lab.py:133"))),
            (LAB3_SOURCE, lab4, (
                ("lab_visit", "tools/visit_cost_lab.py:266"),
                ("lab_leaf_visit", "tools/visit_cost_lab.py:231"),
                ("lab_smem", "tools/smem_lab.py:146"))),
            (BF16_SOURCE, lab4, (("lab_bf16", "tools/bf16_lab.py:73"),))):
        for name, replaces in names:
            kernels.append(entry(name, source, replaces,
                                 report[name]["launches"], report[name]))
    log(f"kernel ms and plain_ms: one launch on {WIDTH * HEIGHT} rays (the "
        "lab kernels: on the bounce-1 wavefront in renderer order, "
        "lab_occlusion and lab_occlusion4_queued on its shadow batch; phase "
        "7's: L3, L4 base, L5 shared, L6 without flags; phase 8's: L8 "
        "ordered); phase 9's: the card-size run at the lab's K (L11a full, "
        "L11b base, L10 smem) and L12 f32, their plain versions at k = "
        "K_CHECK (L12: at its K); light_select: the 1080p lightgrid's "
        "bounce-1 call (phase 15), its plain version on the card; "
        "library_ms null: no PyTorch call computes a BVH walk, a "
        "fixed-sequence walk, a K-step chain or a light selection")
    for name, r in (("quad_closest", k["closest_incoherent"]),
                    ("quad_occlusion", k["occlusion_shadow"]),
                    ("binary_closest", k["binary_closest_incoherent"]),
                    ("binary_occlusion", k["binary_occlusion_shadow"]),
                    *lab.items(), *lab2.items(), *lab3.items(),
                    *lab4.items(),
                    *((f"light_select {name}", r)
                      for name, r in select.items())):
        log(f"bound {name}: {r['ms']:.3f} ms against a bound of "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']} B, "
            f"{r['ops']} FP32 operations), {100 * r['bound_ms'] / r['ms']:.1f}"
            f"% of the bound")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
