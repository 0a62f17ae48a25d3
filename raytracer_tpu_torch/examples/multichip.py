"""Multi-device rendering demo: pixel-tile data parallelism over
torch.distributed, with and without ReSTIR DI (port of the JAX package's
examples/multichip.py).

Every rank bakes the Cornell box, renders its contiguous tile of the
pixels with global pixel ids, and gathers the image; the only collective
inside a frame is ReSTIR's halo exchange with the neighbouring ranks. The
sharded images are bit-identical to single-device ones, which rank 0
renders too and compares.

    torchrun --nproc-per-node N -m raytracer_tpu_torch.examples.multichip
        [--size WxH] [--frames F] [--outdir DIR] [--device cuda|cpu]
    python -m raytracer_tpu_torch.examples.multichip --spawn N [...]

Under torchrun each process is one rank. --spawn N starts N local ranks
itself. The backend is NCCL when every rank has a card of its own, else
gloo (which moves card tensors through host memory). Rank 0 writes
multichip.png and multichip_restir.png into --outdir (default: multichip
in the temporary directory).
"""

from __future__ import annotations

import argparse
import datetime
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--size", default="64x64", help="WxH")
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--outdir",
                   default=os.path.join(tempfile.gettempdir(), "multichip"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--spawn", type=int, default=0,
                   help="start this many local ranks (0: run as one rank "
                        "of torchrun's group)")
    return p


def backend_for(device_type: str, world: int) -> str:
    """NCCL when each of `world` local ranks has a card of its own, else
    gloo (NCCL refuses two ranks on one card)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def run(args) -> dict:
    """One rank's part: the sharded renders, and on rank 0 the
    single-device renders and the comparison. Returns rank 0's max
    |sharded - single| by mode (empty on the other ranks)."""
    from raytracer_tpu_torch.api import ProgressiveRenderer
    from raytracer_tpu_torch.parallel.sharding import (
        ShardedProgressiveRenderer,
        make_pixel_mesh,
    )
    from raytracer_tpu_torch.scene.model import create_cornell_box
    from raytracer_tpu_torch.utils.config import RenderConfig
    from raytracer_tpu_torch.utils.image import write_image

    w, h = (int(x) for x in args.size.split("x"))
    device_type = torch.device(args.device).type
    mesh = make_pixel_mesh(device_type)
    rank, world = dist.get_rank(), mesh.size()
    cfg = RenderConfig(width=w, height=h)
    # ReSTIR DI: the reservoir tiles with the pixels; radius 2 keeps the
    # halo exact while a tile is at least 3 rows tall.
    modes = (("path tracing", cfg, "multichip.png"),
             ("ReSTIR DI", cfg.replace(use_restir=True,
                                       restir_spatial_radius=2.0,
                                       restir_spatial_neighbors=2),
              "multichip_restir.png"))
    diffs = {}
    for label, c, name in modes:
        sharded = ShardedProgressiveRenderer(create_cornell_box(), None, c,
                                             mesh=mesh, device=device_type)
        img = sharded.render(args.frames)
        if rank == 0:
            ref = ProgressiveRenderer(create_cornell_box(), None, c,
                                      device=sharded.device).render(
                                          args.frames)
            diffs[label] = float(np.abs(img - ref).max())
            print(f"{label} on {world} ranks "
                  f"({dist.get_backend()}, {sharded.device.type}): "
                  f"max |sharded - single| = {diffs[label]:.2e}",
                  flush=True)
            os.makedirs(args.outdir, exist_ok=True)
            write_image(os.path.join(args.outdir, name), img)
    return diffs


def _spawned(rank, world, args):
    return run(args)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device_type = torch.device(args.device).type
    if args.spawn:
        from raytracer_tpu_torch.parallel.launch import spawn

        spawn(_spawned, args.spawn, (args,),
              backend=backend_for(device_type, args.spawn),
              timeout_s=TIMEOUT_S)
        return 0
    world = int(os.environ.get("LOCAL_WORLD_SIZE",
                               os.environ.get("WORLD_SIZE", "1")))
    kw = {}
    backend = backend_for(device_type, world)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        kw["device_id"] = torch.device("cuda", local)
        torch.cuda.set_device(kw["device_id"])
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=TIMEOUT_S), **kw)
    try:
        run(args)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
