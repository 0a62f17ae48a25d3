"""NEE light selection (raytracer_tpu_torch/ops/light_select.py) on the
CPU: its plain version against the JAX package's selection on the same
inputs (raytracer_tpu/integrator/wavefront.py _shade: the power/dist²
weights of _light_weights, jnp's sum and cumsum, argmax and gathers; run
by `_reference`), at L = 1, 4, 64 and 256 with zero-power padded columns,
on lanes whose own object is a light, lanes that do not draw and lanes
whose total is 0; the draw-only and MIS-only modes; N = 0 and N = 1; the
tracer's counters.

The op sums in the shader's column order, the JAX package in its
reduction and scan orders, so picks may differ only where r1 = r * total
lies within a few ulp of a running sum, and totals in their last bits.

The tests marked `card` skip without a CUDA card, and import no JAX; on
the card (this directory's conftest.py loads JAX, which the card's machine
lacks):

    python -m pytest --noconftest -m card tests/test_torch_light_select.py -q -s

There the kernel (csrc/light_select.cu) equals the plain version bit for
bit at 2,073,600 lanes (L = 4, 64, 256), on a compacted prefix of
1,555,456 lanes and at N = 1, in every mode, and its drawn counter counts
the lanes that drew. chip_smoke.py times it on the renderer's own
wavefront, beside its bound.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytracer_tpu_torch.ops import light_select, rng
from raytracer_tpu_torch.ops.light_select import select_lights
from raytracer_tpu_torch.utils import profiling

N = 65536
# (L, lights with power; the rest are padding: power 0, object -1)
COLUMNS = [(1, 1), (4, 1), (64, 48), (256, 200)]
ULPS = 4  # a pick may differ where r1 lies this close to a running sum


def _inputs(n, num_lights, real, seed=0, device="cpu"):
    """Lanes over a 24-unit room, lights on its ceiling at powers 1..16;
    30% of the lanes on a light's own object, 60% drawing, light_index in
    [-1, real); the first lanes sit on light centers (dist² clamped)."""
    g = np.random.default_rng(seed)
    pos = g.uniform(-12, 12, (n, 3)).astype(np.float32)
    centers = np.zeros((num_lights, 3), np.float32)
    centers[:real] = np.stack([g.uniform(-12, 12, real), np.full(real, 6.0),
                               g.uniform(-12, 12, real)], 1)
    on_center = min(n, 16)
    pos[:on_center] = centers[g.integers(0, real, on_center)]
    powers = np.zeros(num_lights, np.float32)
    powers[:real] = g.uniform(1, 16, real)
    objects = np.full(num_lights, -1, np.int32)
    objects[:real] = 5 + 2 * np.arange(real)
    obj = np.where(g.random(n) < 0.3, objects[g.integers(0, real, n)],
                   1000 + g.integers(0, 50, n)).astype(np.int32)
    arrays = dict(
        pos=pos, centers=centers, powers=powers, objects=objects, obj=obj,
        do_nee=g.random(n) < 0.6,
        seed=g.integers(0, 2**32, n, dtype=np.int64),
        light_index=g.integers(-1, real, n).astype(np.int32))
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _select(d, draw=True, mis=True):
    return select_lights(
        d["pos"], d["centers"], d["powers"], d["objects"],
        obj=d["obj"] if draw else None, do_nee=d["do_nee"] if draw else None,
        seed=d["seed"] if draw else None,
        light_index=d["light_index"] if mis else None)


def _reference(pos, centers, powers, objects, obj, do_nee, seed,
               light_index):
    """The JAX package's selection on the same inputs, as its _shade
    computes it (raytracer_tpu/integrator/wavefront.py): _light_weights
    over the skipped view, rnd_masked, the cumsum pick, argmax and gathers,
    and the emissive-MIS total and weight over the un-skipped view."""
    import jax.numpy as jnp

    from raytracer_tpu.integrator import wavefront as jwf
    from raytracer_tpu.ops import rng as jrng

    def j(t):
        return jnp.asarray(t.numpy())

    def t(x, dtype=None):
        x = np.array(x)
        return torch.from_numpy(x if dtype is None else x.astype(dtype))

    n, num_lights = pos.shape[0], powers.shape[0]
    scene = SimpleNamespace(num_lights=num_lights, light_center=j(centers),
                            light_power=j(powers), light_object=j(objects))
    cfg = SimpleNamespace(max_lights=num_lights)
    hit_pos = j(pos)
    w_base = jwf._light_weights_base(scene, hit_pos, cfg)
    weights, total_w = jwf._light_weights(scene, hit_pos, j(obj), cfg,
                                          w_all=w_base)
    m_sel = j(do_nee) & (total_w > 0.0)
    r_sel, seed_out = jrng.rnd_masked(
        jnp.asarray(seed.numpy().astype(np.uint32)), m_sel)
    r1 = r_sel * total_w
    cs = jnp.cumsum(weights, axis=1)
    found = jnp.any(cs >= r1[:, None], axis=1)
    selected = jnp.argmax(cs >= r1[:, None], axis=1).astype(jnp.int32)
    sel_c = jnp.clip(selected, 0, num_lights - 1)
    sel_w = jnp.take_along_axis(weights, sel_c[:, None], axis=1)[:, 0]
    pdf = sel_w / jnp.maximum(total_w, 1e-20)
    w_all, _ = jwf._light_weights(scene, hit_pos,
                                  jnp.full((n,), -1, jnp.int32), cfg,
                                  w_all=w_base)
    li_cap = jnp.clip(j(light_index), 0, num_lights - 1)
    return dict(selected=t(selected), found=t(m_sel & found), pdf=t(pdf),
                seed=t(seed_out, np.int64),
                total_all=t(jnp.sum(w_all, axis=-1)),
                w_this=t(jnp.take_along_axis(w_all, li_cap[:, None],
                                             axis=1)[:, 0]),
                m_sel=t(m_sel), r1=t(r1), cdf=t(cs), weights=t(weights))


def _ulp_distance(cdf, r1):
    """The fewest ulp of r1 between r1 and any running sum, per lane."""
    ulp = torch.from_numpy(np.spacing(np.abs(r1.numpy())))
    return ((cdf - r1[:, None]).abs() / ulp[:, None]).min(dim=1).values


def _rel(a, b):
    return ((a - b).abs() / b.abs().clamp_min(1e-30)).max().item()


@pytest.fixture(scope="module", params=COLUMNS, ids=lambda c: f"L{c[0]}")
def case(request):
    num_lights, real = request.param
    d = _inputs(N, num_lights, real, seed=num_lights)
    return num_lights, real, d, _select(d), _reference(**d)


def test_picks_agree_but_at_cdf_boundaries(case):
    """`selected` and `found` equal the JAX package's on every lane that
    draws, except where r1 lies within ULPS ulp of a running sum (in the
    shader's order or the JAX package's), and those are below 1e-4 of the
    lanes; a lane that draws always finds a light; a lane that does not
    draws nothing."""
    num_lights, _, d, got, want = case
    drew = want["m_sel"]
    assert 0 < int(drew.sum()) < N
    run = torch.empty_like(want["weights"])  # the shader's running sums
    acc = torch.zeros(N)
    for col in range(num_lights):
        acc = acc + want["weights"][:, col]
        run[:, col] = acc
    r = rng.rnd(d["seed"])[0]
    near = drew & ((_ulp_distance(run, r * acc) <= ULPS)
                   | (_ulp_distance(want["cdf"], want["r1"]) <= ULPS))
    differ = drew & ((got.selected != want["selected"])
                     | (got.found != want["found"]))
    print(f"L={num_lights}: {int(drew.sum())} lanes drew, {int(differ.sum())}"
          f" picks differ, {int(near.sum())} near a boundary")
    assert not (differ & ~near).any()
    assert int(near.sum()) < 1e-4 * N
    assert torch.equal(got.found, drew)
    assert not got.selected[~drew].any() and not got.pdf[~drew].any()
    assert got.selected.dtype == torch.int32
    assert int(got.selected.max()) < num_lights


def test_values_agree(case):
    """sel_pdf on the lanes whose pick agrees, total_all and w_this on
    every lane: within 1e-6 relative of the JAX package's."""
    _, _, _, got, want = case
    same = want["m_sel"] & (got.selected == want["selected"])
    assert _rel(got.pdf[same], want["pdf"][same]) <= 1e-6
    assert _rel(got.total_all, want["total_all"]) <= 1e-6
    assert _rel(got.w_this, want["w_this"]) <= 1e-6
    assert (got.pdf[same] > 0).all()


def test_seed_advances_where_a_light_is_drawn(case):
    """One LCG step exactly where do_nee & total > 0, as the JAX
    package's masked draw; lanes on a light's own object skip it, and with a
    single light those lanes' total is 0."""
    num_lights, real, d, got, want = case
    assert torch.equal(got.seed, want["seed"])
    drew = want["m_sel"]
    assert torch.equal(got.seed[drew], rng.lcg_step(d["seed"])[drew])
    assert torch.equal(got.seed[~drew], d["seed"][~drew])
    own = d["do_nee"] & (d["obj"][:, None] == d["objects"][None, :]).any(1)
    assert own.any()
    if real == 1:
        assert not drew[own].any()
    else:
        assert drew[own].all()


@pytest.mark.parametrize("num_lights", [4, 64])
def test_draw_only_and_mis_only(num_lights):
    """Without light_index (MIS off) the draw's outputs are the full op's
    and MIS's are None; without a draw (ReSTIR's primary vertex) MIS's
    outputs are the full op's and the draw's are None."""
    d = _inputs(4096, num_lights, max(1, num_lights // 2), seed=7)
    full = _select(d)
    draw_only = _select(d, mis=False)
    mis_only = _select(d, draw=False)
    for k in ("selected", "found", "pdf", "seed"):
        assert torch.equal(getattr(draw_only, k), getattr(full, k)), k
        assert getattr(mis_only, k) is None
    for k in ("total_all", "w_this"):
        assert torch.equal(getattr(mis_only, k), getattr(full, k)), k
        assert getattr(draw_only, k) is None


@pytest.mark.parametrize("n", [0, 1])
def test_edge_sizes(n):
    d = _inputs(n, 4, 3, seed=11)
    got = _select(d)
    for k, dtype in (("selected", torch.int32), ("found", torch.bool),
                     ("pdf", torch.float32), ("seed", torch.int64),
                     ("total_all", torch.float32), ("w_this", torch.float32)):
        assert getattr(got, k).shape == (n,) and \
            getattr(got, k).dtype == dtype, k
    if n:
        want = _reference(**d)
        assert torch.equal(got.seed, want["seed"])
        assert torch.equal(got.selected[want["m_sel"]],
                           want["selected"][want["m_sel"]])
        assert torch.equal(got.total_all, want["total_all"])


def test_no_lights_is_refused():
    d = _inputs(8, 1, 1)
    with pytest.raises(ValueError):
        select_lights(d["pos"], d["centers"][:0], d["powers"][:0],
                      d["objects"][:0], light_index=d["light_index"])


def test_counters_count_lanes_and_draws():
    """Traced, each call adds its lanes to `light_select.lanes` and, when
    it draws, its drawing lanes to `light_select.drawn`; untraced, nothing
    is counted and no counter is made."""
    d = _inputs(4096, 4, 3, seed=5)
    want = _reference(**d)
    assert not profiling.counting()
    _, drawn = light_select._select_plain(
        *(d[k] for k in ("pos", "centers", "powers", "objects", "obj",
                         "do_nee", "seed", "light_index")), False)
    assert drawn is None
    t = profiling.PhaseTimer(record=True)
    with profiling.activated(t), profiling.span("rt.step", frame=0):
        assert profiling.counting()
        _select(d)
        _select(d, draw=False)
    counters = t.export()["counters"]
    assert counters["light_select.lanes"] == {0: 2 * 4096}
    assert counters["light_select.drawn"] == {0: int(want["m_sel"].sum())}


# --- on the card ------------------------------------------------------------

CARD_CASES = [(2_073_600, 4, 1), (2_073_600, 64, 64), (2_073_600, 256, 200),
              (1_555_456, 64, 64), (1, 4, 1)]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _equal(got, want, what):
    for k in light_select.LightSelection._fields:
        a, b = getattr(got, k), getattr(want, k)
        assert (a is None) == (b is None), (what, k)
        if a is not None:
            assert torch.equal(a.cpu(), b), (what, k)


@pytest.mark.card
@pytest.mark.parametrize("n,num_lights,real", CARD_CASES)
def test_kernel_equals_plain_on_the_card(n, num_lights, real):
    """Every output of the kernel equals the plain version's (run on the
    CPU) bit for bit, with MIS and a draw, without MIS, and without a
    draw; the drawn counter counts the lanes that drew."""
    dev = _card()
    cpu = _inputs(n, num_lights, real, seed=n + num_lights)
    card = {k: v.to(dev) for k, v in cpu.items()}
    before = light_select.launches
    for draw, mis in ((True, True), (True, False), (False, True)):
        want = _select(cpu, draw, mis)
        _equal(_select(card, draw, mis), want,
               f"n={n} L={num_lights} draw={draw} mis={mis}")
    assert light_select.launches == before + 3
    t = profiling.PhaseTimer(record=True)
    with profiling.activated(t), profiling.span("rt.step", frame=0):
        got = _select(card)
    counted = t.export()["counters"]["light_select.drawn"][0]
    assert counted == int(got.found.sum())
