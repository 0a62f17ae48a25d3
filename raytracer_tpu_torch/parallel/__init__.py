from raytracer_tpu_torch.parallel.sharding import (  # noqa: F401
    make_pixel_mesh,
    render_frame_sharded,
    shard_accum,
)
