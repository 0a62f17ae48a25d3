"""ReSTIR DI in the port (raytracer_tpu_torch/integrator/restir.py) against
the JAX package's (raytracer_tpu/integrator/restir.py), on the CPU, where
the port's traversal kernels run as their plain torch versions.

Inputs are made by numpy from a seed, or by one JAX bake that both packages
read (scene/device_scene.py:from_jax_arrays), so both trace one tree.

Tolerance (the slice's): every pixel within PIXEL_ATOL of the reference but
at most MAX_FLIPPED of them; the reservoir ops bit for bit; the
unshadowed radiance within rtol RTOL, apart from sharp GGX lobes, where one
ulp of a cosine moves the lobe's value further (ROADMAP.md §3), at most
MAX_FLIPPED of the lanes; the reservoir's light_index equal on at least
1 - MAX_FLIPPED of the pixels. Each test prints its counts.

The whole renders are held against the JAX renderer twice. ReSTIR's spatial
reuse carries each pixel's primary hit into the reservoirs of every pixel
whose taps reach it, and from frame to frame through temporal reuse. On a
shared mesh edge the two packages' triangle tests can disagree (a hit
against a miss in a crack; ROADMAP.md §3 bounds these for the traversal
tests), and frame 0's rays pass through pixel centres, which lie on the
Cornell box's back-wall diagonal. So the pixel gate is held against a JAX
reference whose primary trace is served by the port's walk on the JAX rays
(the G-buffers agree; every other step is the JAX package's), and the
unaligned JAX renderer gives the light_index gate and the printed count.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytracer_tpu.accel.native_builder as jnative
import raytracer_tpu.scene.benchmark as jbench
import raytracer_tpu.scene.model as jmodel
import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu import api as japi
from raytracer_tpu.integrator import restir as jrs
from raytracer_tpu.integrator import wavefront as jwf
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu.ops.camera import Camera as JaxCamera
from raytracer_tpu.ops.intersect import HitRecord as JaxHit
from raytracer_tpu.scene.device_scene import bake_scene as jbake
from raytracer_tpu.utils.config import RenderConfig as JaxConfig
from raytracer_tpu_torch.api import ProgressiveRenderer
from raytracer_tpu_torch.integrator import restir as trs
from raytracer_tpu_torch.integrator import wavefront as twf
from raytracer_tpu_torch.ops.binary_traverse import intersect_bvh_binary
from raytracer_tpu_torch.ops.camera import Camera
from raytracer_tpu_torch.ops.intersect import HitRecord
from raytracer_tpu_torch.scene.device_scene import from_jax_arrays
from raytracer_tpu_torch.utils.config import RenderConfig

torch.set_num_threads(1)  # see test_torch_ops.py

PIXEL_ATOL = 1e-4
MAX_FLIPPED = 0.01
RTOL = 1e-5
N_OPS = 4096

# name: (JAX scene, port scene, camera, render size, frames)
SCENES = {
    "cornell": (jmodel.create_cornell_box, tmodel.create_cornell_box,
                dict(position=(0.0, 0.0, -3.0)), (32, 32), 3),
    "lightgrid": (jbench.create_benchmark_lightgrid,
                  tbench.create_benchmark_lightgrid,
                  dict(position=(0.0, 4.2, -10.5), target=(0.0, 1.2, 1.5)),
                  (24, 24), 3),
}

FLAG_SETS = {
    "defaults": {},
    "no_initial_visibility": dict(restir_initial_visibility=False),
    "final_visibility_feedback": dict(restir_final_visibility_feedback=True),
    "unbiased_spatial": dict(restir_unbiased_spatial=True),
}


@pytest.fixture(autouse=True)
def numpy_builders(monkeypatch):
    monkeypatch.setattr(jnative, "available", lambda: False)
    monkeypatch.setattr(tnative, "available", lambda: False)


def _flipped(a, b):
    """Lanes of [N, C] arrays `a` and `b` that differ by more than
    PIXEL_ATOL."""
    return np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1) > PIXEL_ATOL


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _to_port(nt, cls):
    return cls(*(_t(a) for a in nt))


# --- the reservoir ops -----------------------------------------------------

def _reservoir_inputs(seed):
    """Random reservoirs and candidates over N_OPS lanes: zero weights,
    index -1, and ties at r * w_sum == w (lanes 0-255: w_sum == w and r =
    0.5; lanes 256-511: w_sum = 0 and r = 1)."""
    g = np.random.default_rng(seed)
    n = N_OPS

    def f32(lo, hi, zero_share=0.0):
        a = g.uniform(lo, hi, n).astype(np.float32)
        a[g.random(n) < zero_share] = 0.0
        return a

    res = dict(
        weight_sum=f32(0.0, 4.0, 0.2), target_pdf=f32(0.0, 2.0, 0.2),
        m=g.integers(0, 64, n).astype(np.float32),
        light_index=g.integers(-1, 100, n).astype(np.int32),
        uv=g.random((n, 2)).astype(np.float32),
        distance=f32(0.01, 9.0), w=f32(0.0, 3.0, 0.25))
    cand = dict(light=g.integers(-1, 100, n).astype(np.int32),
                uv=g.random((n, 2)).astype(np.float32),
                dist=f32(0.01, 9.0), target=f32(0.0, 2.0, 0.2),
                weight=f32(0.0, 4.0, 0.25), r=g.random(n).astype(np.float32))
    res["weight_sum"][:256] = cand["weight"][:256]
    cand["r"][:256] = 0.5
    res["weight_sum"][256:512] = 0.0
    cand["r"][256:512] = 1.0
    other = dict(
        weight_sum=f32(0.0, 4.0), target_pdf=f32(0.0, 2.0),
        m=g.integers(0, 200, n).astype(np.float32),
        light_index=g.integers(-1, 100, n).astype(np.int32),
        uv=g.random((n, 2)).astype(np.float32),
        distance=f32(0.01, 9.0), w=f32(0.0, 3.0, 0.25))
    here = f32(0.0, 2.0, 0.2)
    valid = g.random(n) < 0.8
    # Merge ties: power-of-two factors make w_other exact.
    here[:256] = 2.0 ** g.integers(-3, 3, 256)
    other["w"][:256] = 2.0 ** g.integers(-3, 3, 256)
    other["m"][:256] = g.integers(1, 9, 256)
    valid[:256] = True
    merge_ties = here[:256] * other["w"][:256] * other["m"][:256]
    merge_res = dict(res, weight_sum=res["weight_sum"].copy())
    merge_res["weight_sum"][:256] = merge_ties
    z = g.integers(0, 64, n).astype(np.float32)
    z[g.random(n) < 0.2] = 0.0
    return res, cand, other, here, valid, merge_res, z


def _both(fields, cls_j, cls_t):
    return (cls_j(**{k: jnp.asarray(v) for k, v in fields.items()}),
            cls_t(**{k: torch.from_numpy(v.copy()) for k, v in
                     fields.items()}))


def _assert_reservoirs_equal(got, want):
    for k in trs.Reservoir._fields:
        a, b = _np(getattr(got, k)), np.asarray(getattr(want, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("op", ["update", "merge", "finalize", "finalize_z"])
def test_reservoir_ops_bit_equal(op):
    res, cand, other, here, valid, merge_res, z = _reservoir_inputs(7)
    if op == "update":
        jres, tres = _both(res, jrs.Reservoir, trs.Reservoir)
        args = [cand[k] for k in ("light", "uv", "dist", "target", "weight",
                                  "r")]
        want = jrs._reservoir_update(jres, *map(jnp.asarray, args))
        got = trs._reservoir_update(tres, *map(_t, args))
        taken = _np(got.light_index != tres.light_index)
    elif op == "merge":
        jres, tres = _both(merge_res, jrs.Reservoir, trs.Reservoir)
        jo, to = _both(other, jrs.Reservoir, trs.Reservoir)
        want = jrs._reservoir_merge(jres, jo, jnp.asarray(here),
                                    jnp.asarray(cand["r"]),
                                    jnp.asarray(valid))
        got = trs._reservoir_merge(tres, to, _t(here), _t(cand["r"]),
                                   _t(valid))
        taken = _np(got.light_index != tres.light_index)
    else:
        jres, tres = _both(res, jrs.Reservoir, trs.Reservoir)
        if op == "finalize":
            want, got = jrs._finalize(jres), trs._finalize(tres)
        else:
            want = jrs._finalize(jres, z=jnp.asarray(z))
            got = trs._finalize(tres, z=_t(z))
        taken = _np(got.w) > 0
    _assert_reservoirs_equal(got, want)
    print(f"{op}: {N_OPS} lanes bit-equal, {int(taken.sum())} changed "
          "sample or positive W")


def test_empty_reservoir_matches_jax():
    _assert_reservoirs_equal(trs.Reservoir.empty(5, "cpu"),
                             jrs.Reservoir.empty(5))


def test_ris_unbiased_single_lane():
    """RIS over 4 candidates of a two-light toy integrand (f = 1, 3,
    uniform source pdf 0.5): <f> * W averages to the integral 4."""
    from raytracer_tpu_torch.ops import rng

    f = torch.tensor([1.0, 3.0])
    n = 20000
    seed = rng.tea(torch.arange(n, dtype=torch.int64), 9)
    res = trs.Reservoir.empty(n)
    for _ in range(4):
        r_pick, seed = rng.rnd(seed)
        r_keep, seed = rng.rnd(seed)
        light = (r_pick < 0.5).to(torch.int32)
        target = f[light.long()]
        res = trs._reservoir_update(res, light, torch.zeros((n, 2)),
                                    torch.ones(n), target, target / 0.5,
                                    r_keep)
    res = trs._finalize(res)
    est = f[torch.clamp(res.light_index, 0, 1).long()] * res.w
    assert abs(float(est.mean()) - 4.0) < 0.1


# --- one G-buffer, both packages ---------------------------------------------

@functools.cache
def _bakes(name):
    """The JAX bake of scene `name` and the port's DeviceScene of the same
    arrays."""
    jds, _ = jbake(SCENES[name][0](), stable_shapes=False)
    fields = {f.name: np.asarray(getattr(jds, f.name))
              for f in dataclasses.fields(jds)
              if getattr(jds, f.name) is not None}
    return jds, from_jax_arrays(fields, "cpu")


def _camera(name, cls, w, h):
    return cls.create(aspect=w / h, **SCENES[name][2])


def _jax_config(name, **kw):
    w, h = SCENES[name][3]
    return JaxConfig(width=w, height=h, accel="bvh", stable_bake=False,
                     use_restir=True, **kw)


def _port_config(name, **kw):
    w, h = SCENES[name][3]
    return RenderConfig(width=w, height=h, use_restir=True, **kw)


@functools.cache
def _gbuffer(name):
    """The JAX G-buffer of one primary trace at frame 1's jitter: (JAX
    GBuffer, ray directions, hit record, camera ray origins)."""
    jds, _ = _bakes(name)
    cfg = _jax_config(name).resolve_accel()
    w, h = cfg.width, cfg.height
    mats = _camera(name, JaxCamera, w, h).matrices()
    n = w * h
    pix = jnp.arange(n, dtype=jnp.uint32)
    seed = jrng.seed_pixels(pix, jnp.uint32(1))
    r1, seed = jrng.rnd(seed)
    r2, seed = jrng.rnd(seed)
    jitter = 0.5 + (jnp.stack([r1, r2], axis=-1) - 0.5) * 0.4
    origin, direction = jwf._camera_rays(
        jnp.asarray(mats["inverse_view"]), jnp.asarray(mats["inverse_proj"]),
        w, h, jitter, pix)
    alive = jnp.ones((n,), bool)
    hit = jwf._trace(jds, origin, direction, cfg, alive)
    lane = alive & hit.hit
    s = jwf.fetch_surface(jds, hit, direction, lane)
    gbuf = jrs.GBuffer(
        position=s.world_pos, normal=s.world_nrm, albedo=s.albedo,
        roughness=s.roughness, metallic=s.metallic,
        emission=s.emission_color * s.emission_power[:, None], hit=lane,
        object=s.obj)
    return gbuf, direction, hit, origin, seed


@pytest.mark.parametrize("name", sorted(SCENES))
def test_unshadowed_radiance(name):
    jds, tds = _bakes(name)
    gbuf, direction, _, _, _ = _gbuffer(name)
    n = direction.shape[0]
    g = np.random.default_rng(11)
    # Light triangles mostly, then any triangle (no light: invalid) and -1.
    lt = tds.light_tri_packed.shape[0]
    lights = np.nonzero(_np(tds.light_tri_packed[:, 10]) >= 0)[0]
    tri = g.choice(lights, n).astype(np.int32)
    pick = g.random(n)
    tri[pick < 0.1] = g.integers(0, lt, int((pick < 0.1).sum()))
    tri[pick > 0.9] = -1
    uv = g.random((n, 2)).astype(np.float32)
    want = jrs._unshadowed_radiance(jds, gbuf, direction, jnp.asarray(tri),
                                    jnp.asarray(uv), _jax_config(name))
    got = trs._unshadowed_radiance(tds, _to_port(gbuf, trs.GBuffer),
                                   _t(direction), _t(tri), _t(uv))
    rad_j, rad_t = np.asarray(want[0]), _np(got[0])
    np.testing.assert_array_equal(_np(got[4]), np.asarray(want[4]))
    off = ~np.isclose(rad_t, rad_j, rtol=RTOL, atol=0.0).all(axis=-1)
    for k, what in ((1, "dist"), (2, "light position"), (3, "wi")):
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=RTOL, atol=1e-6, err_msg=what)
    valid = np.asarray(want[4])
    rel = np.abs(rad_t - rad_j) / np.maximum(np.abs(rad_j), 1e-30)
    print(f"{name}: {int(valid.sum())} valid of {n}; radiance beyond rtol "
          f"{RTOL} on {int(off.sum())} lanes (max rel {float(rel.max()):.3g})")
    assert valid.sum() > n // 20
    assert off.mean() <= MAX_FLIPPED


def _restir_direct_both(name, flags, prev_frame):
    """restir_direct of both packages on the JAX G-buffer at frame 1, each
    with its own occlusion walk (accel="bvh"). With prev_frame, the
    previous reservoir is the JAX package's frame 0 on the same G-buffer."""
    jds, tds = _bakes(name)
    gbuf, direction, _, _, _ = _gbuffer(name)
    jcfg = _jax_config(name, **flags).resolve_accel()
    tcfg = _port_config(name, accel="bvh", **flags).resolve_accel()

    def jocc(o, d, t_max, skip, active):
        return jwf._occluded(jds, o, d, t_max, skip, jcfg, active)

    def tocc(o, d, t_max, skip, active):
        return twf._occluded(tds, o, d, t_max, skip, tcfg, active)

    jprev = tprev = None
    if prev_frame:
        _, jprev, _ = jrs.restir_direct(jds, gbuf, direction, None, 0, jcfg,
                                        jocc)
        tprev = _to_port(jprev, trs.Reservoir)
    want = jrs.restir_direct(jds, gbuf, direction, jprev, 1, jcfg, jocc)
    got = trs.restir_direct(tds, _to_port(gbuf, trs.GBuffer),
                            _t(direction), tprev, 1, tcfg, tocc)
    return got, want


@pytest.mark.parametrize("prev", [False, True], ids=["fresh", "carried"])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
@pytest.mark.parametrize("name", sorted(SCENES))
def test_restir_direct_matches_jax(name, flags, prev):
    (t_direct, t_res, t_shadows), (j_direct, j_res, j_shadows) = (
        _restir_direct_both(name, FLAG_SETS[flags], prev))
    flipped = _flipped(_np(t_direct), j_direct)
    li = _np(t_res.light_index) == np.asarray(j_res.light_index)
    m_eq = _np(t_res.m) == np.asarray(j_res.m)
    print(f"{name} {flags} {'carried' if prev else 'fresh'}: direct flipped "
          f"{int(flipped.sum())} of {flipped.size}; light_index differs on "
          f"{int((~li).sum())}, M on {int((~m_eq).sum())}; shadow rays "
          f"{int(t_shadows)} (JAX {int(j_shadows)})")
    assert float(np.asarray(j_direct).sum()) > 0
    assert flipped.mean() <= MAX_FLIPPED
    assert li.mean() >= 1 - MAX_FLIPPED
    assert m_eq.mean() >= 1 - MAX_FLIPPED
    assert abs(int(t_shadows) - int(j_shadows)) <= MAX_FLIPPED * li.size


@pytest.mark.parametrize("name", sorted(SCENES))
def test_shade_suppress_nee_matches_jax(name):
    """One bounce of _shade(suppress_nee=True) on the same state and hit
    record: no NEE draws, no shadow rays, did_direct on the surface lanes,
    and the BRDF sample and emission as the JAX package's."""
    jds, tds = _bakes(name)
    _, direction, hit, origin, seed = _gbuffer(name)
    n = direction.shape[0]
    cfg = _jax_config(name).resolve_accel()
    zeros3 = np.zeros((n, 3), np.float32)
    fields = dict(
        origin=np.asarray(origin), direction=np.asarray(direction),
        color=zeros3, throughput=np.ones((n, 3), np.float32),
        seed_rgen=np.asarray(seed), seed=np.asarray(seed),
        alive=np.ones(n, bool), first_bounce=np.ones(n, bool),
        is_specular=np.zeros(n, bool),
        prev_brdf_pdf=np.ones(n, np.float32), prev_hit_pos=zeros3,
        p_sample_light=np.zeros(n, np.float32), did_direct=np.zeros(n, bool),
        channel=np.full(n, -1, np.int32))
    jstate = jwf.WavefrontState(**{k: jnp.asarray(v) for k, v in
                                   fields.items()},
                                pixel=jnp.arange(n, dtype=jnp.int32))
    tstate = twf.WavefrontState(**{
        k: _t(v.astype(np.int64) if k.startswith("seed") else v)
        for k, v in fields.items()}, pixel=_t(np.arange(n, dtype=np.int32)))
    thit = _to_port(hit, HitRecord)
    want, j_hit, j_sh = jwf._shade(jds, jstate, hit, cfg, suppress_nee=True)
    got, t_hit, t_sh = twf._shade(tds, tstate, thit,
                                  _port_config(name).resolve_accel(),
                                  suppress_nee=True)
    assert int(t_sh) == 0 and int(j_sh) == 0
    np.testing.assert_array_equal(_np(t_hit), np.asarray(j_hit))
    for k in twf.WavefrontState._fields:
        a, b = _np(getattr(got, k)), np.asarray(getattr(want, k))
        if a.dtype.kind in "bi":
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=k)
    lane = np.asarray(hit.hit)
    np.testing.assert_array_equal(_np(got.did_direct), lane)
    off = {k: int(_flipped(_np(getattr(got, k)),
                           np.asarray(getattr(want, k))).sum())
           for k in ("color", "throughput", "origin", "direction")}
    print(f"{name}: lanes beyond {PIXEL_ATOL}: {off} of {n}")
    assert max(off.values()) <= MAX_FLIPPED * n
    # Without suppress_nee the lottery draws: the seeds move on lit lanes.
    plain, _, _ = twf._shade(tds, tstate, thit,
                             _port_config(name).resolve_accel())
    assert (_np(plain.seed) != _np(got.seed)).any()


# --- whole renders -----------------------------------------------------------

def _port_primary_hits(tds, t_max):
    """A JAX-side stand-in for the primary trace: the port's binary walk on
    the JAX rays, through a host callback."""

    def walk(origin, direction, active):
        rec = intersect_bvh_binary(_t(origin), _t(direction), tds, 1e-3,
                                   t_max, active_mask=_t(active))
        return tuple(_np(x) for x in (rec.t, rec.tri, rec.u, rec.v, rec.hit))

    def trace(origin, direction, active):
        n = origin.shape[0]
        shapes = (jax.ShapeDtypeStruct((n,), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.int32),
                  jax.ShapeDtypeStruct((n,), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.float32),
                  jax.ShapeDtypeStruct((n,), jnp.bool_))
        return JaxHit(*jax.pure_callback(walk, shapes, origin, direction,
                                         active))

    return trace


@functools.cache
def _jax_render(name, aligned):
    """The JAX package's ReSTIR render of scene `name` (accel="bvh"):
    (image, reservoir). With `aligned`, its primary trace is the port's
    walk (see the module docstring); every other step is the JAX
    package's."""
    jmake, _, _, (w, h), frames = SCENES[name]
    cam = _camera(name, JaxCamera, w, h)
    if not aligned:
        r = japi.ProgressiveRenderer(jmake(), cam, _jax_config(name))
        img = r.render(frames)
        return img, jax.tree_util.tree_map(np.asarray, r.reservoir)
    jds, tds = _bakes(name)
    cfg = _jax_config(name).resolve_accel()
    mats = cam.matrices()
    ubo = {k: jnp.asarray(mats[k]) for k in ("inverse_view", "inverse_proj")}
    primary = _port_primary_hits(tds, cfg.t_max)
    own_trace = jwf._trace
    calls = []

    def trace(scene, origin, direction, c, active):
        calls.append(1)
        if len(calls) == 1:  # the first trace of render_wavefront_restir
            return primary(origin, direction, active)
        return own_trace(scene, origin, direction, c, active)

    step = jax.jit(lambda a, res, f: jrs.render_frame_restir(
        jds, ubo, a, res, f, cfg))
    accum = jnp.zeros((w * h, 3), jnp.float32)
    res = jrs.Reservoir.empty(w * h)
    jwf._trace = trace
    try:
        for f in range(frames):
            accum, res = step(accum, res, jnp.uint32(f))
    finally:
        jwf._trace = own_trace
    assert len(calls) == 2  # traced once: the primary and the bounce body
    return (np.asarray(accum).reshape(h, w, 3),
            jax.tree_util.tree_map(np.asarray, res))


@pytest.mark.parametrize("accel", ["auto", "bvh"])
@pytest.mark.parametrize("name", sorted(SCENES))
def test_render_matches_jax(name, accel):
    _, tmake, _, (w, h), frames = SCENES[name]
    r = ProgressiveRenderer(tmake(), _camera(name, Camera, w, h),
                            _port_config(name, accel=accel), device="cpu")
    got = r.render(frames)
    assert np.isfinite(got).all() and got.mean() > 0
    want, want_res = _jax_render(name, aligned=True)
    raw, raw_res = _jax_render(name, aligned=False)
    flipped = _flipped(got.reshape(-1, 3), want.reshape(-1, 3))
    raw_flipped = _flipped(got.reshape(-1, 3), raw.reshape(-1, 3))
    li = _np(r.reservoir.light_index) == want_res.light_index
    raw_li = _np(r.reservoir.light_index) == raw_res.light_index
    print(f"{name} {w}x{h} x{frames} frames, accel={accel}: "
          f"{int(flipped.sum())} flipped pixels of {flipped.size}, "
          f"light_index differs on {int((~li).sum())} (against the "
          f"unaligned JAX renderer: {int(raw_flipped.sum())} flipped, "
          f"light_index {int((~raw_li).sum())})")
    assert flipped.mean() <= MAX_FLIPPED
    assert li.mean() >= 1 - MAX_FLIPPED
    assert raw_li.mean() >= 1 - MAX_FLIPPED


# --- checkpoints across the packages -----------------------------------------

CK = dict(width=16, height=12)


def _jax_ck_renderer(**kw):
    return japi.ProgressiveRenderer(jmodel.create_cornell_box(), None,
                                    JaxConfig(accel="bvh", stable_bake=False,
                                              **CK, **kw))


def _port_ck_renderer(**kw):
    return ProgressiveRenderer(tmodel.create_cornell_box(), None,
                               RenderConfig(**CK, **kw), device="cpu")


def test_jax_checkpoint_resumes_in_port(tmp_path):
    path = str(tmp_path / "ck.npz")
    jr = _jax_ck_renderer(use_restir=True)
    jr.render(2)
    jr.save_checkpoint(path)
    port = _port_ck_renderer(use_restir=True)
    port.load_checkpoint(path)
    assert port.frame == 2
    _assert_reservoirs_equal(port.reservoir, jr.reservoir)
    np.testing.assert_array_equal(port.image(), jr.image())
    want = jr.render(1)
    got = port.render(1)
    flipped = _flipped(got.reshape(-1, 3), want.reshape(-1, 3))
    li = (_np(port.reservoir.light_index)
          == np.asarray(jr.reservoir.light_index))
    print(f"resumed frame 2 -> 3: {int(flipped.sum())} flipped pixels, "
          f"light_index differs on {int((~li).sum())}")
    assert flipped.mean() <= MAX_FLIPPED
    assert li.mean() >= 1 - MAX_FLIPPED


def test_port_checkpoint_loads_in_jax(tmp_path):
    path = str(tmp_path / "ck.npz")
    port = _port_ck_renderer(use_restir=True)
    img = port.render(3)
    port.save_checkpoint(path)
    jr = _jax_ck_renderer(use_restir=True)
    jr.load_checkpoint(path)
    assert jr.frame == 3
    _assert_reservoirs_equal(port.reservoir, jr.reservoir)
    np.testing.assert_array_equal(jr.image(), img)
    # And back again, unchanged.
    jr.save_checkpoint(path)
    port2 = _port_ck_renderer(use_restir=True)
    port2.load_checkpoint(path)
    _assert_reservoirs_equal(port2.reservoir, port.reservoir)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_checkpoint_without_reservoir_restarts_temporal_reuse(tmp_path,
                                                              saved_by):
    """A plain checkpoint resumes the accumulation under ReSTIR in both
    packages with an empty reservoir; their next frames agree."""
    path = str(tmp_path / "ck.npz")
    src = _jax_ck_renderer() if saved_by == "jax" else _port_ck_renderer()
    src.render(2)
    src.save_checkpoint(path)
    assert "reservoir_m" not in np.load(path)
    jr = _jax_ck_renderer(use_restir=True)
    port = _port_ck_renderer(use_restir=True)
    for r in (jr, port):
        r.load_checkpoint(path)
        assert r.frame == 2
        assert float(np.asarray(_np(r.reservoir.m)).max()) == 0.0
        assert (_np(r.reservoir.light_index) == -1).all()
    want, got = jr.render(1), port.render(1)
    flipped = _flipped(got.reshape(-1, 3), want.reshape(-1, 3))
    print(f"{saved_by} plain checkpoint, frame 2 under ReSTIR: "
          f"{int(flipped.sum())} flipped pixels")
    assert flipped.mean() <= MAX_FLIPPED
    assert float(_np(port.reservoir.m).max()) > 0


# --- the JAX package's behaviour tests, on the port --------------------------

def _port_gbuffer(w=16, h=16, **flags):
    cfg = RenderConfig(width=w, height=h, use_restir=True,
                       **flags).resolve_accel()
    ds = ProgressiveRenderer(tmodel.create_cornell_box(), None, cfg,
                             device="cpu").device_scene
    mats = Camera.create(position=(0, 0, -3), aspect=w / h).matrices()
    n = w * h
    origin, direction = twf._camera_rays(
        _t(mats["inverse_view"]), _t(mats["inverse_proj"]), w, h,
        torch.full((n, 2), 0.5), torch.arange(n))
    alive = torch.ones(n, dtype=torch.bool)
    hit = twf._trace(ds, origin, direction, cfg, alive)
    lane = alive & hit.hit
    s = twf.fetch_surface(ds, hit, direction, lane)
    gbuf = trs.GBuffer(
        position=s.world_pos, normal=s.world_nrm, albedo=s.albedo,
        roughness=s.roughness, metallic=s.metallic,
        emission=s.emission_color * s.emission_power[:, None], hit=lane,
        object=s.obj)
    return ds, gbuf, direction, cfg


def _all_visible(o, d, t_max, skip, active):
    return torch.zeros(o.shape[0], dtype=torch.bool)


def _all_occluded(o, d, t_max, skip, active):
    return torch.ones(o.shape[0], dtype=torch.bool)


def test_restir_visibility_kills_occluded_samples():
    """Occlusion removes energy, and a killed reservoir carries no weight
    that a later _finalize could resurrect."""
    ds, gbuf, direction, cfg = _port_gbuffer()
    direct_vis, _, _ = trs.restir_direct(ds, gbuf, direction, None, 1, cfg,
                                         _all_visible)
    direct_occ, res_occ, _ = trs.restir_direct(ds, gbuf, direction, None, 1,
                                               cfg, _all_occluded)
    assert float(direct_vis.sum()) > 0.0
    assert float(direct_occ.abs().sum()) == 0.0
    assert float(res_occ.weight_sum.max()) == 0.0
    assert float(res_occ.w.max()) == 0.0


def test_restir_final_visibility_feedback_invalidates_reservoir():
    """With step 3 off, only the step-6 feedback can kill: with it the
    reservoir handed on is empty, without it the occluded samples
    persist."""
    ds, gbuf, direction, cfg = _port_gbuffer(
        restir_initial_visibility=False,
        restir_final_visibility_feedback=True)
    direct, res, _ = trs.restir_direct(ds, gbuf, direction, None, 1, cfg,
                                       _all_occluded)
    assert float(direct.abs().sum()) == 0.0
    assert float(res.w.max()) == 0.0
    assert float(res.weight_sum.max()) == 0.0
    assert (res.light_index == -1).all()
    off = cfg.replace(restir_final_visibility_feedback=False)
    direct2, res2, _ = trs.restir_direct(ds, gbuf, direction, None, 1, off,
                                         _all_occluded)
    assert float(direct2.abs().sum()) == 0.0
    assert float(res2.w.max()) > 0.0


def test_restir_reset_on_camera_move():
    r = _port_ck_renderer(use_restir=True)
    r.step()
    r.step()
    assert float(r.reservoir.m.max()) > 0
    r.camera.move((0.05, 0, 0))
    r.step()
    assert r.frame == 1
    # The reservoir restarted with the accumulation: one frame's M at most
    # (its candidates and each tap's, nothing from the previous frame).
    cfg = r.config
    assert float(r.reservoir.m.max()) <= (
        (1 + cfg.restir_spatial_neighbors) * cfg.restir_initial_candidates)


def test_restir_many_lights_no_spatial_feedback():
    """The 16-light grid: spatial taps read a snapshot, so M keeps its
    design bound, the ReSTIR mean tracks plain NEE, and the running mean
    does not drift (reading the evolving buffer brightened the image to
    about twice the NEE mean by frame 16)."""
    w, h, frames = 40, 24, 10
    cfg = RenderConfig(width=w, height=h).resolve_accel()
    cfg_r = cfg.replace(use_restir=True)
    cam = Camera.create(position=(0.0, 4.2, -10.5), aspect=w / h,
                        target=(0.0, 1.2, 1.5))
    scene = tbench.create_benchmark_lightgrid(n_lights=16,
                                              target_triangles=2_000)
    r = ProgressiveRenderer(scene, cam, cfg_r, device="cpu")
    p = ProgressiveRenderer(scene, cam, cfg, device="cpu")
    means = []
    for _ in range(frames):
        r.step()
        p.step()
        means.append(float(r.accum.mean()))
    m_bound = (cfg_r.restir_initial_candidates + cfg_r.restir_max_m
               + cfg_r.restir_spatial_neighbors * cfg_r.restir_max_m)
    assert float(r.reservoir.m.max()) <= m_bound + 1e-3
    mp = float(p.accum.mean())
    print(f"ReSTIR mean {means[-1]:.5f}, NEE mean {mp:.5f}, frame-4 mean "
          f"{means[3]:.5f}")
    assert abs(means[-1] - mp) / max(mp, 1e-6) < 0.12
    assert abs(means[-1] - means[3]) / max(means[3], 1e-6) < 0.08
