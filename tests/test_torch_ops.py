"""The port's elementwise ops against the JAX package: the RNG bit for bit,
vector math and the GGX BRDF within 1e-6, and the brute-force oracle hit
for hit. Inputs are made with numpy from a seed and handed to both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytracer_tpu.ops import brdf as jbrdf
from raytracer_tpu.ops import intersect as jint
from raytracer_tpu.ops import math3d as jm
from raytracer_tpu.ops import rng as jrng
from raytracer_tpu_torch.ops import brdf as tbrdf
from raytracer_tpu_torch.ops import intersect as tint
from raytracer_tpu_torch.ops import math3d as tm
from raytracer_tpu_torch.ops import rng as trng

# One thread in every port test file (each sets it at import, so the last
# one imported sets it for a whole xdist worker): with two, torch's first
# parallel call of sqrt in a process now and then returns ~11-bit results
# for one thread's half of the array (3 of 145 processes here, up to 3,817
# ulps off; 0 of 148 with one thread). That, not rounding, failed
# test_math3d[length], [normalize] and [basis] in 5 of 30 runs under -n 6;
# in the other runs JAX and torch `length` differ by at most 1 ulp, on 25
# of the 4,096 vectors, well inside the tolerance below.
torch.set_num_threads(1)

ATOL = 1e-6  # f32 elementwise math: a few ulps of O(1) values


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("frame", [0, 1, 7, 123456789])
def test_seed_pixels_and_streams_bit_exact(frame):
    """tea / seed_pixels / rnd / rnd_masked over 10k pixels, per frame."""
    pix = np.arange(10_000, dtype=np.uint32)
    js = jrng.seed_pixels(jnp.asarray(pix), frame)
    ts = trng.seed_pixels(torch.from_numpy(pix.astype(np.int64)), frame)
    np.testing.assert_array_equal(np.asarray(js).astype(np.int64), _np(ts))

    mask = np.random.default_rng(frame % 1000).uniform(size=pix.size) < 0.5
    jstate, tstate = js, ts
    for _ in range(6):
        jr, jstate = jrng.rnd_masked(jstate, jnp.asarray(mask))
        tr, tstate = trng.rnd_masked(tstate, torch.from_numpy(mask))
        np.testing.assert_array_equal(np.asarray(jr), _np(tr))
        np.testing.assert_array_equal(np.asarray(jstate).astype(np.int64),
                                      _np(tstate))


def test_tea_extreme_inputs():
    v = np.asarray([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    a, b = np.meshgrid(v, v)
    want = np.asarray(jrng.tea(jnp.asarray(a), jnp.asarray(b)))
    got = trng.tea(torch.from_numpy(a.astype(np.int64)),
                   torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(want.astype(np.int64), _np(got))


def _vecs(rng, n=4096):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n, 3)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("name", ["dot", "cross", "length", "normalize",
                                  "reflect", "luminance_rec709", "basis",
                                  "local_world"])
def test_math3d(name, rng_np):
    a, b = _vecs(rng_np)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    if name == "basis":
        for jx, tx in zip(jm.make_basis(ja), tm.make_basis(ta)):
            np.testing.assert_allclose(_np(tx), np.asarray(jx), atol=ATOL)
        return
    if name == "local_world":
        jbasis, tbasis = jm.make_basis(ja), tm.make_basis(ta)
        want = jm.local_to_world(jm.world_to_local(jb, jbasis), jbasis)
        got = tm.local_to_world(tm.world_to_local(tb, tbasis), tbasis)
        np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)
        return
    args = {"dot": (2,), "cross": (2,), "length": (1,), "normalize": (1,),
            "reflect": (2,), "luminance_rec709": (1,)}[name][0]
    want = getattr(jm, name)(*((ja, jb)[:args]))
    got = getattr(tm, name)(*((ta, tb)[:args]))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL,
                               rtol=1e-6)


def test_mis_weight_power(rng_np):
    p1 = rng_np.uniform(-0.5, 4, 4096).astype(np.float32)
    p2 = rng_np.uniform(-0.5, 4, 4096).astype(np.float32)
    want = jm.mis_weight_power(jnp.asarray(p1), jnp.asarray(p2))
    got = tm.mis_weight_power(_t(p1), _t(p2))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=ATOL)


def _materials(rng, n):
    albedo = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rough = rng.uniform(0, 1, n).astype(np.float32)
    metal = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return albedo, rough, metal


def _hemi(rng, n):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[:, 2] = np.abs(w[:, 2]) * np.where(rng.uniform(size=n) < 0.9, 1, -1)
    return w


def test_brdf_evaluate_and_pdfs(rng_np):
    n = 4096
    wo, wi = _hemi(rng_np, n), _hemi(rng_np, n)
    albedo, rough, metal = _materials(rng_np, n)
    j = [jnp.asarray(x) for x in (wo, wi, albedo, rough, metal)]
    t = [_t(x) for x in (wo, wi, albedo, rough, metal)]
    np.testing.assert_allclose(
        _np(tbrdf.evaluate_full(*t)), np.asarray(jbrdf.evaluate_full(*j)),
        atol=ATOL, rtol=1e-5)
    np.testing.assert_allclose(
        _np(tbrdf.specular_probability(*t[2:])),
        np.asarray(jbrdf.specular_probability(*j[2:])), atol=ATOL)
    h_j = jm.normalize(j[0] + j[1])
    h_t = tm.normalize(t[0] + t[1])
    np.testing.assert_allclose(
        _np(tbrdf.microfacet_pdf(t[0], h_t, t[3])),
        np.asarray(jbrdf.microfacet_pdf(j[0], h_j, j[3])), rtol=1e-5,
        atol=ATOL)


def test_sample_brdf(rng_np):
    n = 4096
    wo = _hemi(rng_np, n)
    wo[:, 2] = np.abs(wo[:, 2])
    albedo, rough, metal = _materials(rng_np, n)
    seed = rng_np.integers(0, 2**32, n, dtype=np.uint64)
    js, jseed = jbrdf.sample_brdf(
        jnp.asarray(wo), jnp.asarray(albedo), jnp.asarray(rough),
        jnp.asarray(metal), jnp.asarray(seed.astype(np.uint32)))
    ts, tseed = tbrdf.sample_brdf(_t(wo), _t(albedo), _t(rough), _t(metal),
                                  _t(seed.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(jseed).astype(np.int64),
                                  _np(tseed))
    np.testing.assert_array_equal(np.asarray(js.is_specular),
                                  _np(ts.is_specular))
    # Near the pole sin_t = sqrt(1 - cos_t^2) turns a one-ulp difference in
    # the GGX sample's cos_t (XLA and torch round its sqrt/div chain
    # differently) into ~2e-6 in x/y; and D_GGX's denominator
    # nh^2 (a^2 - 1) + 1 cancels for a sharp lobe near its peak, so value
    # and pdf can differ by 1e-4 relative even where directions agree to
    # 1e-6. So: every direction within 1e-5; value and pdf within 1e-3
    # relative on the lanes whose directions agree to 1e-6, which must be
    # nearly all of them.
    jdir, tdir = np.asarray(js.direction), _np(ts.direction)
    np.testing.assert_allclose(tdir, jdir, atol=1e-5)
    close = np.abs(tdir - jdir).max(axis=1) <= ATOL
    assert close.mean() > 0.999, close.mean()
    np.testing.assert_allclose(_np(ts.value)[close],
                               np.asarray(js.value)[close],
                               atol=ATOL, rtol=1e-3)
    np.testing.assert_allclose(_np(ts.pdf)[close], np.asarray(js.pdf)[close],
                               rtol=1e-3, atol=ATOL)


def _random_tris(rng, t=200, r=600):
    v0 = rng.uniform(-3, 3, (t, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (t, 3)).astype(np.float32)
    o = rng.uniform(-4, 4, (r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return v0, e1, e2, o, d


def test_intersect_brute_matches(rng_np):
    v0, e1, e2, o, d = _random_tris(rng_np)
    want = jint.intersect_brute(*(jnp.asarray(x) for x in (o, d, v0, e1, e2)),
                                1e-3, 1e4, chunk_size=64)
    got = tint.intersect_brute(*(_t(x) for x in (o, d, v0, e1, e2)),
                               1e-3, 1e4, chunk_size=64)
    np.testing.assert_array_equal(_np(got.hit), np.asarray(want.hit))
    np.testing.assert_array_equal(_np(got.tri), np.asarray(want.tri))
    hits = np.asarray(want.hit)
    assert hits.sum() > 50
    np.testing.assert_allclose(_np(got.t)[hits], np.asarray(want.t)[hits],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(got.u)[hits], np.asarray(want.u)[hits],
                               atol=1e-5)


def test_occlusion_brute_matches(rng_np):
    v0, e1, e2, o, d = _random_tris(rng_np)
    t = v0.shape[0]
    obj = rng_np.integers(0, 10, t).astype(np.int32)
    t_max = rng_np.uniform(0.5, 8, o.shape[0]).astype(np.float32)
    skip = rng_np.integers(-1, 10, o.shape[0]).astype(np.int32)
    want = jint.occlusion_brute(
        jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max),
        jnp.asarray(v0), jnp.asarray(e1), jnp.asarray(e2), jnp.asarray(obj),
        jnp.asarray(skip), chunk_size=40)
    got = tint.occlusion_brute(
        _t(o), _t(d), 1e-3, _t(t_max), _t(v0), _t(e1), _t(e2), _t(obj),
        _t(skip), chunk_size=40)
    assert 0 < np.asarray(want).sum() < o.shape[0]
    np.testing.assert_array_equal(_np(got), np.asarray(want))
