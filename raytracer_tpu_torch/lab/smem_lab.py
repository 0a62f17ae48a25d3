"""Shared-memory lab L10: two ways to bring a 384-byte leaf row to the
rays, the port's counterpart of tools/smem_lab.py (`run` :137, its
`pallas_call` :146; `smem_kernel` :28, `transp_kernel` :66).

    python -m raytracer_tpu_torch.lab.smem_lab

Bakes the atrium with leaf 8 (as the JAX lab) and walks the fixed leaf
sequence (lab/fixed_seq.py) for K_SMEM = 65,536 leaf visits from best t
1e4 and best triangle -1; prints, at the JAX lab's size (one 8x128 tile,
1024 rays) and at the card size, each variant's clock64() cycles per leaf
visit, its time (CUDA events) and ns per ray-visit, beside the card's SM
clock, after each variant's launch shape.

  smem    the TPU kernel's DMA of the row into SMEM as Hopper's bulk
          copy: one thread a block copies each 384-byte row into a ring
          of row stages in shared memory, rows ahead, each stage with a
          full and an empty mbarrier (no block barrier a visit); the 8
          serial tests read the row as broadcasts. Per ray it computes
          what L11b `base` computes (lab/visit_cost_lab.py), from shared
          memory instead of direct float4 loads.
  transp  the row read column-wise from the same ring, as the TPU kernel
          reads it (col[8c:8c+8] is component c of triangles 0-7), the 8
          tests against the entry best t, the least t and the TPU
          kernel's largest-index reduction: cm_leaf's (csrc/
          traverse_common.cuh).
          The JAX lab feeds it the triangle-major bake, so its "triangles"
          are mixed components and its indices truncated coordinates: the
          output is deterministic and reproduced here, but it is not a
          closest hit; only its time means anything.

Outputs are btri + int(bt) i32[N], as acc[:8] + bt[:8].astype(int32). On
CUDA tensors `run_smem` launches csrc/lab3_traverse.cu:lab_smem; on CPU
tensors it runs the plain torch versions, which the kernels equal bit for
bit and the tests compare with the JAX lab kernels.
"""

from __future__ import annotations

import argparse
import sys

import torch

from raytracer_tpu_torch.lab import fixed_seq as fs
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.lab import visit_cost_lab as vc
from raytracer_tpu_torch.lab.v2_kernel_lab import _cm_leaf
from raytracer_tpu_torch.ops.quad_traverse import T_MIN

LEAF_SIZE = 8
VARIANTS = ("smem", "transp")
LAB_RAYS = (8 * fs.TILE_L,)  # TS = 8 (smem_lab.py:25)

# Kernel launches, counted where the CUDA wrapper launches.
smem_launches = 0


def reset_launch_counts():
    global smem_launches
    smem_launches = 0


def run_smem(origin, direction, ptris, variant, k=fs.K_SMEM, cycles=None):
    """L10: `k` visits of the fixed leaf sequence over ptris f32[NB,96]
    (leaf 8) by rays f32[N,3]. Returns btri + int(bt) i32[N]."""
    fs.check_inputs(origin, direction, ptris, LEAF_SIZE * 12, variant,
                    VARIANTS)
    fs.check_k(k)
    if origin.is_cuda:
        return _smem_cuda(origin, direction, ptris, variant, k, cycles)
    return fs.leaf_out(*smem_plain(origin, direction, ptris, variant, k))


def _smem_cuda(origin, direction, ptris, variant, k, cycles):
    """lab_smem with the variant's code, its index in VARIANTS."""
    global smem_launches
    out = fs.launch("lab_smem", origin, direction, ptris, k,
                    VARIANTS.index(variant), cycles)
    smem_launches += 1
    return out


def smem_plain(origin, direction, ptris, variant, k):
    """Plain torch version of lab_smem's `variant`. Returns the per-ray
    record (btri i32[N], bt f32[N])."""
    if variant == "smem":
        return vc.leaf_visit_plain(origin, direction, ptris, "base", k)
    n = origin.shape[0]
    bt = torch.full((n,), fs.T_CAP, dtype=torch.float32, device=origin.device)
    btri = torch.full((n,), -1, dtype=torch.int32, device=origin.device)
    nb = ptris.shape[0]
    for it in range(k):
        rows = ptris[it % nb].expand(n, ptris.shape[1])
        bt, btri, _, _ = _cm_leaf(origin, direction, rows, bt, btri, None,
                                  None, T_MIN)
    return btri, bt


def run(scene, reps=fs.REPS, log=print, k=fs.K_SMEM):
    """Both variants at the lab size and at the card size, on the lab's
    rays. Returns {(size label, variant): fixed_seq.timed's dict}. On the
    card it first prints each variant's launch shape."""
    if scene.ptris.is_cuda:
        for v in VARIANTS:
            log(fs.launch_line(fs.launch_index(f"L10 {v}"),
                               scene.ptris.device))
    results = {}
    for label, n in fs.sizes(scene.device, LAB_RAYS):
        o, d = fs.lab_rays_const(n, scene.device)
        for variant in VARIANTS:
            r = results[(label, variant)] = fs.timed(
                lambda c, v=variant: run_smem(o, d, scene.ptris, v, k, c),
                k, n, reps)
            log(fs.line(label, variant, r, "visit"))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=fs.REPS)
    args = p.parse_args(argv)
    device = lab_rays.require_cuda()
    scene = lab_rays.atrium(LEAF_SIZE, device)
    run(scene, args.reps, log=lambda m: print(m, flush=True))
    print(f"smem_lab on {lab_rays.card_line()} (SM clock read after the "
          "runs)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
