"""Render configuration (the port's copy of raytracer_tpu/utils/config.py).

Every field and default of the JAX package's RenderConfig is kept, so one
configuration describes the same render in both packages. `accel` takes
every JAX value, "auto", "pallas", "bvh" and "brute", plus "cuda", the
port's own name for "pallas": "auto" and "pallas" resolve to "cuda" (the
hand-written 4-wide tree kernels in ops/quad_traverse.py; on CPU tensors
their plain torch versions), "bvh" is the binary tree's kernels in
ops/binary_traverse.py (likewise) and "brute" the O(T) oracle.

The reference hard-codes its knobs at compile time in GLSL
(`shaders/simple.rchit:9-13`: USE_DIRECT_LIGHTING / USE_LIGHT_SAMPLING_ONLY /
USE_MIS, MAXLIGHTS=256; `shaders/simple.rgen:23`: MAX_DEPTH=3) and exposes a
few at runtime through the UI (background color, accumulation limit —
`src/raytracer/ui.odin:170-173,509-536`). Here every knob is a runtime config
field; all are static (hashable) so a config change triggers a re-jit, which
was the JAX package's analog of the reference's recompile; the port runs
eagerly and keeps the fields for parity.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static configuration for one render. Hashable -> usable as a jit
    static argument."""

    width: int = 1280
    height: int = 1020  # reference default window (src/main.odin:41-42)

    # Path tracing (shaders/simple.rgen:23, simple.rchit:9-13)
    max_depth: int = 3
    use_direct_lighting: bool = True
    use_mis: bool = True
    # USE_LIGHT_SAMPLING_ONLY (simple.rchit:10): declared in the reference
    # but referenced by no shader code; the natural semantics — direct light
    # exclusively via NEE (deterministic, MIS weight 1) with emissive hits
    # counted only on first-bounce/specular paths — are implemented here as
    # a runtime flag, completing the set of reference compile switches.
    use_light_sampling_only: bool = False
    max_lights: int = 256

    # Russian roulette starts at this bounce depth (simple.rgen:55-68).
    rr_start_depth: int = 3

    # Deep-bounce wavefront compaction ("cuda"/"pallas"/"auto" accel,
    # max_depth > rr_start_depth + 1 only): after the dead-last sort,
    # bounces past the RR onset run on a prefix of the lane arrays sized by
    # compact_decay^(depth - rr_start_depth) when the live count fits (one
    # read of the count to the host per such bounce; where more are live,
    # the latest earlier prefix that holds them, else the full-size path).
    # Excluded lanes are dead and untouched, and the port runs eagerly, so
    # the image is bit for bit the uncompacted one (integrator/wavefront.py).
    # Trades a sort per bounce for shrinking per-bounce traversal/shading
    # cost on depth-8+ configs.
    compact_deep: bool = True
    compact_decay: float = 0.75

    # Radiance clamp applied before accumulation (simple.rgen:121).
    radiance_clamp: float = 5.0

    # Background ("clear color"); reference default is sky-blue
    # (src/raytracer/raytracing_renderer.odin:77).
    background: Tuple[float, float, float] = (0.53, 0.81, 0.92)

    # Stop accumulating after this many frames (None = unlimited), mirroring
    # the reference's accumulation-limit UI modal (ui.odin:509-536).
    accumulation_limit: Optional[int] = None

    # Dielectric transmission/refraction. The reference *declares*
    # Material.transmission/ior (shaders/ray_common.glsl:9-10) but no shader
    # reads them; we implement them for real (BASELINE config 3).
    enable_transmission: bool = True

    # Intersection epsilons (traceRayEXT args, simple.rgen:92-104).
    t_min: float = 0.001
    t_max: float = 10000.0

    # Acceleration structure (every JAX value, plus "cuda"):
    #   "auto"   — "cuda"
    #   "pallas" — "cuda": the JAX name of the same 4-wide tree and kernels
    #   "cuda"   — 4-wide BVH traversal kernels (ops/quad_traverse.py,
    #              ports of the JAX ops/pallas_subpacket.py kernels); CPU
    #              tensors take their plain torch versions. t_min is fixed
    #              at 1e-3: the renderer falls back to "bvh" for another
    #              t_min or a tree too deep for the kernels' stack, as the
    #              JAX package does
    #   "bvh"    — binary-tree backend: the binary BVH traversal kernels
    #              (ops/binary_traverse.py, ports of the JAX
    #              ops/pallas_traverse.py kernels), any t_min; CPU tensors
    #              take their plain torch versions
    #   "brute"  — O(T) oracle
    accel: str = "auto"
    # 16 tris/leaf: the latency-bound sub-packet kernel trades cheap extra
    # VPU Moller-Trumbore work for ~35% fewer quad iterations — measured
    # +4.9% end-to-end at 1080p/300k tris, image byte-identical
    # (tools/r3_leaf16_frame_lab.py; sweep in tools/leafsweep_lab.py).
    bvh_leaf_size: int = 16
    # Capacity-padded (stable-shape) bakes for interactive editing: small
    # topology edits (object add/remove) re-bake into the SAME tensor
    # shapes (in the JAX package, the same jit signature: no re-compile).
    # Image-neutral (tests/test_torch_stable_bake.py); costs ≤ +12.5%
    # scene-table memory. Auto-skipped for multi-part bakes and when the
    # padding would overflow the bake's budget (scene/device_scene.py).
    stable_bake: bool = True

    # Preview denoising (BEYOND-REFERENCE; integrator/denoise.py): apply an
    # SVGF-style edge-aware a-trous filter at image()-time. Never touches
    # the accumulation buffer — convergence/checkpoints are unaffected.
    denoise_preview: bool = False
    denoise_iterations: int = 4

    # Adaptive sampling (BEYOND-REFERENCE; integrator/adaptive.py): a pixel
    # stops sampling once the relative standard error of its mean luminance
    # drops under this tolerance (0 = off — every pixel samples every frame,
    # bit-identical to the plain accumulation). Retired lanes sort dead-last
    # so their kernel groups terminate in one pop. Mutually exclusive with
    # use_restir (ReSTIR carries its own temporal state).
    adaptive_tol: float = 0.0
    adaptive_min_frames: int = 8

    # ReSTIR DI (BASELINE config 5). Off = plain NEE/MIS per the reference's
    # simple.* pipeline.
    use_restir: bool = False
    restir_initial_candidates: int = 8
    restir_spatial_neighbors: int = 4
    restir_spatial_radius: float = 16.0
    restir_max_m: int = 128
    # Step-3 visibility (Bitterli et al. Alg. 5 "visibility reuse"): trace a
    # shadow ray for the initial RIS survivor so occluded samples don't
    # poison temporal/spatial reuse. Costs one full any-hit pass per frame
    # on top of the final-sample visibility; disable to trade a little
    # reuse quality for ~halving ReSTIR's shadow-ray cost (the final
    # visibility pass always runs, so the estimator stays unbiased either
    # way). Consumes no RNG draws, so toggling never shifts streams.
    restir_initial_visibility: bool = True
    # Feed the step-6 final-visibility result back into the reservoir handed
    # to the next frame's temporal reuse (RTXDI's "final visibility feeds the
    # reservoir"). Without it, a sample imported by spatial reuse that is
    # occluded at THIS pixel survives temporal reuse with M up to
    # restir_max_m and keeps shading as black for ~M frames — the dominant
    # term of the atrium bias floor measured in RESTIR_BIAS_DIAG.json.
    # Costs zero extra rays (the step-6 ray is traced either way).
    # Default OFF, from measurement (RESTIR_FLOOR_LAB.json +
    # RESTIR_DEFAULT_LAB.json): it conditions the reused distribution on
    # "visible here", a +1.4–3% brightening that wins slightly on the
    # atrium (MSE 0.0697 vs 0.0738 at 256 frames) but loses on the
    # 64-light grid (0.00226 vs 0.00216, energy 1.014 vs 0.999); early
    # frames (the real-time regime) are identical either way.
    restir_final_visibility_feedback: bool = False
    # Unbiased spatial combination (Bitterli et al. 2020 Alg. 6): count the
    # denominator Z over only those participants (receiver + spatial taps)
    # whose surface could have produced the chosen sample (p-hat > 0 there),
    # instead of the biased M-sum over all of them. Costs one extra
    # unshadowed-radiance evaluation per tap (pure math + gathers, no rays).
    # Default OFF, from measurement: on both lab scenes the Alg.-6 Z-count
    # removes an M-sum underweighting that happens to offset the
    # visible-conditioning brightening, so enabling it RAISES long-run
    # error (atrium MSE 0.125 vs 0.0738; grid 0.00255 vs 0.00216) — and
    # both fixes together are the worst variant on both scenes (0.158
    # rising / energy 1.136 on the atrium). The measured +6% energy
    # divergence that motivated these fixes is radiance-clamp interplay,
    # not reuse bias: unclamped, RIS/plain flips to 0.956
    # (RESTIR_DEFAULT_LAB.json atrium_unclamped).
    restir_unbiased_spatial: bool = False

    # Samples-per-launch batching (BEYOND-REFERENCE; the measured small-tile
    # mitigation from TILESIZE_LAB.json): each progressive step renders
    # spp_batch jittered samples of every pixel in ONE wavefront launch
    # (repeated pixel ids + a per-lane frame vector), folding them into the
    # accumulation with the exact sequential formula. Per-chip throughput
    # falls with wavefront width (3.84 Mrays/s full-frame -> 1.47 on a 1/64
    # tile); batching restores the width a small per-chip tile loses —
    # S=16 on the 1/64 tile recovers 3.42 Mrays/s/chip, putting a v5e-64
    # slice at ~219 Mrays/s (above the 200 target; BASELINE.md). Latency
    # per step rises ~S-fold: use on multi-chip meshes where the per-chip
    # tile is small, not single-chip full frames. Mutually exclusive with
    # ReSTIR (per-frame temporal reuse is inherently sequential) and
    # adaptive sampling (per-pixel counts own the frame index).
    spp_batch: int = 1

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("width/height must be positive")
        if self.max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        if self.accel not in ("auto", "pallas", "cuda", "bvh", "brute"):
            raise ValueError(f"unknown accel {self.accel!r}")
        if self.spp_batch < 1:
            raise ValueError("spp_batch must be >= 1")
        if self.spp_batch > 1:
            if self.use_restir:
                raise ValueError(
                    "spp_batch > 1 is incompatible with ReSTIR: temporal "
                    "reuse consumes the previous frame's reservoir, so "
                    "samples cannot be batched into one launch")
            if self.adaptive_tol > 0:
                raise ValueError(
                    "spp_batch > 1 is incompatible with adaptive sampling: "
                    "each pixel's sample count is its own frame index")
            if (self.accumulation_limit is not None
                    and self.accumulation_limit % self.spp_batch != 0):
                raise ValueError(
                    "accumulation_limit must be a multiple of spp_batch "
                    "(each step() accumulates spp_batch samples)")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def resolve_accel(self) -> "RenderConfig":
        """Pin accel="auto" and "pallas" to "cuda" (the kernels' wrappers
        pick the plain torch versions for CPU tensors)."""
        if self.accel not in ("auto", "pallas"):
            return self
        return self.replace(accel="cuda")
