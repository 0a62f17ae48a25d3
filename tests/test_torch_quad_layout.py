"""What the 4-wide traversal kernels (csrc/quad_traverse.cu) rely on in the
baked arrays and in their wrappers, on the CPU at small sizes:

  - the child metas sit in the node rows (qnodes lanes 24-27) as exact f32,
    equal to qmeta, so the kernels read one 128-byte line per node;
  - the per-row leaf counts (ops/quad_traverse.leaf_counts) end at the last
    real triangle of each leaf row, and every slot past a count is a zero
    triangle, which Möller–Trumbore never accepts (det = 0). Together these
    make stopping a leaf at its count result-neutral;
  - the counts are cached per ptris tensor for as long as it lives, and
    each launch gets a ray counter of its own;
  - the variant lab (lab/quad_variant_lab.py) edits the kernels' two
    tuning constants and nothing else, builds another tree's kernels for
    --against, and digests SASS without names, addresses or encodings.

The scenes are the Cornell box and a ~4k-triangle atrium, each baked at
leaf 8 and 16 with the numpy BVH builder."""

from types import SimpleNamespace

import gc

import numpy as np
import pytest
import torch

import raytracer_tpu_torch.accel.native_builder as tnative
import raytracer_tpu_torch.scene.benchmark as tbench
import raytracer_tpu_torch.scene.model as tmodel
from raytracer_tpu_torch.lab import quad_variant_lab as qvl
from raytracer_tpu_torch.ops import quad_traverse as qt
from raytracer_tpu_torch.scene.device_scene import bake_scene

SCENES = {"cornell": tmodel.create_cornell_box,
          "atrium4k": lambda: tbench.create_benchmark_atrium(4_000)}
LEAVES = (8, 16)
_bakes = {}


@pytest.fixture(autouse=True)
def numpy_builder(monkeypatch):
    monkeypatch.setattr(tnative, "available", lambda: False)


def _bake(name, leaf):
    """(DeviceScene on the CPU, host BVH), baked once per module."""
    if (name, leaf) not in _bakes:
        _bakes[(name, leaf)] = bake_scene(SCENES[name](), leaf_size=leaf,
                                          device="cpu")
    return _bakes[(name, leaf)]


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_node_rows_hold_the_child_metas(name, leaf):
    """qnodes[:, 24:28] as int32 equals qmeta.view(-1, 4), and every meta
    is exact in f32 (|meta| < 2**24). An absent child has a NaN box, a NaN
    meta lane and qmeta 0: the kernels' __float2int_rz turns NaN into 0,
    and a NaN box is never hit, so its meta is never pushed."""
    ds, _ = _bake(name, leaf)
    lanes = ds.qnodes[:, 24:28]
    metas = ds.qmeta.view(-1, 4)
    absent = torch.isnan(lanes)
    boxes = ds.qnodes[:, :24].reshape(-1, 4, 6)
    assert torch.equal(absent, torch.isnan(boxes).all(dim=2))
    assert (metas[absent] == 0).all()
    present = lanes[~absent]
    assert (present.abs() < 2 ** 24).all()
    assert torch.equal(present, present.trunc())
    assert torch.equal(torch.where(absent, 0.0, lanes).to(torch.int32),
                       metas)
    assert (metas.abs() < 2 ** 24).all()


@pytest.mark.parametrize("leaf", LEAVES)
@pytest.mark.parametrize("name", sorted(SCENES))
def test_leaf_counts_end_at_the_last_real_triangle(name, leaf):
    """Every slot at or past a row's count has zero edges (e1 = e2 = 0),
    and the count equals the triangles the bake packed into the row
    (device_scene._pack_leaf_blocks: the leaf's count, at most leaf)."""
    ds, bvh = _bake(name, leaf)
    counts = qt.leaf_counts(ds)
    assert counts.dtype == torch.int32
    assert counts.shape == (ds.ptris.shape[0],)
    rows = ds.ptris.view(ds.ptris.shape[0], leaf, qt.TRI_STRIDE)
    past = torch.arange(leaf)[None, :] >= counts[:, None]
    assert (rows[:, :, 3:9][past] == 0).all()
    packed = np.minimum(bvh.nodes_count[bvh.nodes_count > 0], leaf)
    np.testing.assert_array_equal(counts.numpy(), packed)
    assert int(counts.min()) >= 1
    print(f"{name} leaf {leaf}: {len(packed)} rows, {counts.sum().item()} "
          f"triangles of {len(packed) * leaf} slots")


@pytest.mark.parametrize("t_cap", [1e-2, 1.0, 1e4, 3.0e38, float("inf")])
def test_zero_triangle_is_never_valid(t_cap):
    """_moller on a zero triangle (e1 = e2 = 0, the padding of a leaf row)
    for random rays, some with zero direction components, and any t_cap:
    det is 0, so 1/det is not taken, t = u = v = 0, and no hit is valid."""
    rng = np.random.default_rng(23)
    n = 4096
    o = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:256, 1:] = 0.0
    d[256:512, 0] = 0.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tri = np.zeros((n, qt.TRI_STRIDE), np.float32)
    tri[n // 2:, 0:3] = rng.uniform(-50, 50, (n - n // 2, 3))  # v0 != 0
    tri[:, 9] = rng.integers(0, 1000, n)
    tri[:, 10] = -1.0
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    t, u, v, valid = qt._moller(*ot.unbind(1), *dt.unbind(1),
                                torch.from_numpy(tri),
                                torch.full((n,), t_cap), qt.T_MIN)
    assert not valid.any()
    for x in (t, u, v):
        assert (x == 0).all()


def test_leaf_counts_of_crafted_rows():
    """A full row, trailing padding, a zero slot before a real one (the
    count runs to the last real slot) and a row without a real triangle."""
    leaf = 4
    rows = np.zeros((4, leaf, qt.TRI_STRIDE), np.float32)
    rows[0, :, 3] = 1.0  # full
    rows[1, :2, 8] = -2.0  # two, then padding
    rows[2, 0, 4] = 1.0  # slot 1 zero, slot 2 real
    rows[2, 2, 6] = 3.0
    rows[:, :, 0:3] = 5.0  # v0 alone does not make a triangle real
    scene = SimpleNamespace(ptris=torch.from_numpy(
        rows.reshape(4, leaf * qt.TRI_STRIDE)))
    assert qt.leaf_counts(scene).tolist() == [4, 2, 3, 0]


def test_leaf_counts_are_cached_per_ptris():
    """The counts are computed once per scene and recomputed when its ptris
    is another tensor."""
    rows = np.zeros((2, 2 * qt.TRI_STRIDE), np.float32)
    rows[0, 3] = rows[1, qt.TRI_STRIDE + 3] = 1.0
    scene = SimpleNamespace(ptris=torch.from_numpy(rows))
    first = qt.leaf_counts(scene)
    assert qt.leaf_counts(scene) is first
    assert first.tolist() == [1, 2]
    scene.ptris = torch.from_numpy(rows[::-1].copy())
    assert qt.leaf_counts(scene).tolist() == [2, 1]


def test_leaf_counts_cache_lets_go_of_ptris():
    """The cache holds no ptris alive: its entry goes with the tensor."""
    rows = np.zeros((3, 2 * qt.TRI_STRIDE), np.float32)
    rows[:, 4] = 1.0
    scene = SimpleNamespace(ptris=torch.from_numpy(rows))
    key = id(scene.ptris)
    assert qt.leaf_counts(scene).tolist() == [1, 1, 1]
    assert key in qt._leaf_counts
    del scene
    gc.collect()
    assert key not in qt._leaf_counts


def test_each_launch_has_its_own_ray_counter():
    """The kernels' scene arguments (root, qnodes, ptris, leaf counts, leaf
    size, stack need, ray counter) and a new int32[1] counter for each
    launch, so launches on two streams never share one."""
    ds, _ = _bake("cornell", 8)
    cpu = torch.device("cpu")
    args, counter = qt._launch_args(ds, cpu)
    args2, counter2 = qt._launch_args(ds, cpu)
    assert counter.shape == (1,) and counter.dtype == torch.int32
    assert counter2.data_ptr() != counter.data_ptr()
    assert len(args) == 7
    assert args[0] == ds.root
    assert args[4:6] == (8, ds.q_stack_need)
    assert args[6].value == counter.data_ptr()
    assert args[3].value == qt.leaf_counts(ds).data_ptr()


def _kernel_source():
    with open(qvl.SOURCE) as f:
        return f.read()


def test_variant_lab_covers_the_source_values():
    """The source's G and refill threshold are among the lab's variants,
    so the render path's build is one of those it times."""
    values = qvl.source_values(_kernel_source())
    assert (values["group"], values["refill_at"]) in qvl.variants(values)
    assert values["group"] in qvl.GROUPS
    assert values["refill_at"] in qvl.REFILLS


@pytest.mark.parametrize("group, refill_at", qvl.variants(
    qvl.source_values(_kernel_source())))
def test_variant_source_edits_only_the_constants(group, refill_at):
    """Each variant's source sets kGroup and kRefillAt to its values and
    is the kernel source in every other line."""
    text = _kernel_source()
    out = qvl.variant_source(text, group, refill_at)
    assert qvl.source_values(out) == {"group": group,
                                      "refill_at": refill_at}
    changed = [(a, b) for a, b in zip(text.splitlines(), out.splitlines())
               if a != b]
    assert len(out.splitlines()) == len(text.splitlines())
    assert all("constexpr int k" in a for a, _ in changed)
    assert len(changed) <= 2


def test_variant_source_refuses_a_missing_constant():
    with pytest.raises(ValueError, match="kRefillAt"):
        qvl.variant_source("constexpr int kGroup = 4;\n", 2, 16)


def test_ray_count_is_bounded():
    """The kernels' int32 ray counter takes at most MAX_RAYS rays."""
    qt._check_n(qt.MAX_RAYS)
    with pytest.raises(ValueError, match="rays"):
        qt._check_n(qt.MAX_RAYS + 1)


SASS = """
        Function : _ZN49_GLOBAL__N__{tag}_16_quad_traverse_cu_{tag}16occlusion_kernelEPKf
        .headerflags    @"EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
                                                            /* 0x000fe40000000800 */
        /*{addr}*/              @!P0 BRA 0x4a0 ;             /* 0x{enc} */
        Function : _ZN49_GLOBAL__N__{tag}_16_quad_traverse_cu_{tag}14closest_kernelEPKf
        /*0000*/                   {op} ;                   /* 0x00000a00ff017b82 */
"""


def test_sass_digest_ignores_names_addresses_and_encodings():
    """Two builds of the same code from two trees differ in the anonymous
    namespace's hash, and the digest leaves it out with the addresses and
    encodings; another instruction changes it."""
    a = SASS.format(tag="ef699a84", addr="0010", enc="0000000000007919",
                    op="EXIT")
    b = SASS.format(tag="2a483309", addr="0010", enc="1111111111117919",
                    op="EXIT")
    c = SASS.format(tag="ef699a84", addr="0010", enc="0000000000007919",
                    op="RET.REL.NODEC R20 0x0")
    assert qvl.sass_digest(a, "occlusion_kernel")[0] == 2
    for k in ("occlusion_kernel", "closest_kernel"):
        assert qvl.sass_digest(a, k) == qvl.sass_digest(b, k)
    assert qvl.sass_digest(a, "closest_kernel") != \
        qvl.sass_digest(c, "closest_kernel")
    assert qvl.sass_digest(a, "occlusion_kernel") == \
        qvl.sass_digest(c, "occlusion_kernel")


def test_against_builds_another_trees_kernels(monkeypatch, tmp_path):
    """--against DIR compiles DIR/quad_traverse.cu with DIR on the include
    path and DIR's headers in the library's hash, and reads its G and
    refill threshold."""
    seen = {}

    def compile_library(argv, src, stem, headers=()):
        seen.update(argv=argv, src=src, stem=stem, headers=headers)
        qvl._build.build_info[stem] = {"seconds": 0.0, "log": "log"}
        return str(tmp_path / f"{stem}.so")

    other = tmp_path / "csrc"
    other.mkdir()
    (other / "quad_traverse.cu").write_text(
        qvl.variant_source(_kernel_source(), 2, 8))
    (other / "traverse_common.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(qvl._build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(qvl._build, "compile_library", compile_library)
    monkeypatch.setattr(qvl.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(qvl._build, "bind", lambda lib, sigs: lib)
    lib, log, path, values = qvl.build_against(str(other))
    assert values == {"group": 2, "refill_at": 8}
    assert seen["src"] == str(other / "quad_traverse.cu")
    assert seen["headers"] == [str(other / "traverse_common.cuh")]
    i = seen["argv"].index("-I")
    assert seen["argv"][i + 1] == str(other)
    assert lib == path == str(tmp_path / "libquad_traverse_against.so")
    assert log == "log"
