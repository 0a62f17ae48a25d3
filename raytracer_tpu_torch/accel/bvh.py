"""Host-built BVH over world-space triangles, flattened for stackless
lockstep traversal on TPU.

This plays the role of the reference's VK_KHR_acceleration_structure
BLAS/TLAS (`src/raytracer/acceleration_structure.odin`,
`gpu_scene.odin:209-315`), redesigned TPU-first:

  - Instead of per-mesh BLAS + instance TLAS, all triangles are
    pre-transformed to world space at bake time and ONE BVH is built over
    them (scene sizes here — up to ~300k tris — easily fit; this removes a
    level of indirection from the per-ray inner loop, which on TPU is pure
    gather cost).
  - The Vulkan implementation's fixed-function BVH build is replaced by a
    host binned-SAH builder (numpy, with an optional native C++ fast path —
    see native/bvh_builder.cpp); "UPDATE mode" refit
    (acceleration_structure.odin:125-131) becomes `refit()`, which recomputes
    node AABBs bottom-up without changing topology.
  - Hardware traversal is replaced by a vectorized stackless skip-link walk
    (ops/traverse.py): depth-first node order, hit -> node+1,
    miss/leaf-done -> skip[node]. Per-ray state is just one node index, so a
    whole wavefront advances in lockstep with two gathers per step.

Flattened layout (SoA, static shapes):
  nodes_min/max f32[NN,3]  AABBs
  nodes_skip    i32[NN]    next node on miss / after leaf (NN = "done")
  nodes_first   i32[NN]    first triangle (leaves; 0 for internal)
  nodes_count   i32[NN]    triangle count (0 = internal node)
  tri_order     i32[T]     permutation: BVH leaf order -> input order
  parent        i32[NN]    for bottom-up refit
"""

from __future__ import annotations

import dataclasses

import numpy as np

_SAH_BINS = 32
_TRAVERSAL_COST = 1.0
_INTERSECT_COST = 1.5


@dataclasses.dataclass
class BVH:
    nodes_min: np.ndarray  # f32[NN,3]
    nodes_max: np.ndarray  # f32[NN,3]
    nodes_skip: np.ndarray  # i32[NN]
    nodes_first: np.ndarray  # i32[NN]
    nodes_count: np.ndarray  # i32[NN]
    tri_order: np.ndarray  # i32[R] (triangle ids in leaf order; with spatial
    # reference splitting R >= T and ids may REPEAT — see build_bvh_split)
    parent: np.ndarray  # i32[NN]
    # Number of distinct input triangles the build saw (refit validity
    # check; tri_order may be longer under reference splitting).
    input_tris: int = -1
    # The bake's packing of this tree (scene/device_scene.TreeLayout), set
    # by the bake so that a refit repacks the node boxes by gathers. Not a
    # dataclass field: a BVH made from another's fields has none.
    layout = None

    @property
    def num_nodes(self) -> int:
        return len(self.nodes_skip)

    def depths(self) -> np.ndarray:
        """i64[NN]: each node's depth (root = 0), one vectorized step per
        level."""
        p = self.parent.astype(np.int64)
        depth = np.zeros(len(p), np.int64)
        anc = p.copy()
        while (anc >= 0).any():
            live = anc >= 0
            depth += live
            anc = np.where(live, p[np.maximum(anc, 0)], -1)
        return depth

    def max_depth(self) -> int:
        """Deepest node's depth (root = 0). Binned SAH can emit highly skewed
        trees on adversarial (clustered / exponentially spaced) input, so the
        traversal kernels' fixed stacks must be validated against this at
        bake time, not assumed."""
        return int(self.depths().max(initial=0))

    def refit(self, v0: np.ndarray, e1: np.ndarray, e2: np.ndarray):
        """Recompute AABBs bottom-up for updated (already reordered) triangle
        world positions — the analog of TLAS UPDATE-mode rebuild
        (gpu_scene.odin:457-482). Topology is unchanged, so quality degrades
        under large motion exactly like a Vulkan UPDATE-mode refit would.

        The JAX package's refit loops over nodes; this one reduces whole
        arrays and gives the same boxes bit for bit (min and max are exact):
        each leaf's box is a `reduceat` over its contiguous range of the
        permuted triangles, then the internal nodes go one level at a time,
        deepest first, each as min(min(inf, right), left) like the loop."""
        lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
        hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
        nn = self.num_nodes
        new_min = np.full((nn, 3), np.inf, np.float32)
        new_max = np.full((nn, 3), -np.inf, np.float32)
        leaves = np.nonzero(self.nodes_count > 0)[0]
        leaves = leaves[np.argsort(self.nodes_first[leaves], kind="stable")]
        first = self.nodes_first[leaves].astype(np.int64)
        end = first + self.nodes_count[leaves]
        if not (first[0] == 0 and (first[1:] == end[:-1]).all()):
            raise ValueError("refit needs leaves that tile the permuted "
                             "triangles in order")
        new_min[leaves] = np.minimum.reduceat(lo[:end[-1]], first, axis=0)
        new_max[leaves] = np.maximum.reduceat(hi[:end[-1]], first, axis=0)
        internal = self.nodes_count == 0
        if nn > 1:
            depth = self.depths()
            for d in range(int(depth.max()) - 1, -1, -1):
                nodes = np.nonzero(internal & (depth == d))[0]
                left = nodes + 1
                right = self.nodes_skip[left]  # end of the left subtree
                new_min[nodes] = np.minimum(
                    np.minimum(new_min[nodes], new_min[right]),
                    new_min[left])
                new_max[nodes] = np.maximum(
                    np.maximum(new_max[nodes], new_max[right]),
                    new_max[left])
        self.nodes_min = new_min.astype(np.float32)
        self.nodes_max = new_max.astype(np.float32)
        return self


def _sah_split(lo, hi, centroids, idx):
    """3-axis binned SAH split of the triangle subset `idx`: all three
    centroid axes are binned and swept, and the global min-cost (axis, k)
    wins. Measured on the 300k bench scene (tools/r3_sah_cpu_proxy.py):
    vs the widest-axis-only split this cuts per-ray quad-tree visits ~24%
    (primary 19.4 -> 14.8, bounce 15.0 -> 11.3) — and per-visit serial
    latency is the traversal cost model, so tree quality pays 1:1.

    ALWAYS returns (left_idx, right_idx): the traversal's leaf loop is a
    static `range(leaf_size)`, so leaves may never exceed leaf_size — when
    no SAH split is usable we median-split instead of keeping a fat leaf.
    """
    c = centroids[idx]
    cmin = c.min(axis=0)
    cmax = c.max(axis=0)
    extent = cmax - cmin
    widest = int(np.argmax(extent))
    if extent[widest] <= 1e-12:
        # All centroids coincide: arbitrary halves.
        half = len(idx) // 2
        return idx[:half], idx[half:]

    def area(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    tlo = lo[idx]
    thi = hi[idx]
    # Bin all three axes in ONE scatter pass: flat index = axis*BINS + bin.
    # (Three separate np.minimum.at passes dominated build time; the
    # combined pass is ~2x faster and bit-identical — same bins, same
    # sweeps, same tie-breaking by axis order through argmin below.)
    live = extent > 1e-12
    scale = np.where(live, _SAH_BINS * (1.0 - 1e-6) / np.maximum(extent, 1e-30),
                     0.0)
    bins3 = ((c - cmin) * scale).astype(np.int32)  # [n,3]
    np.clip(bins3, 0, _SAH_BINS - 1, out=bins3)
    flat = bins3 + (np.arange(3, dtype=np.int32) * _SAH_BINS)  # [n,3]

    counts = np.bincount(flat.ravel(), minlength=3 * _SAH_BINS)
    bin_min = np.full((3 * _SAH_BINS, 3), np.inf, np.float32)
    bin_max = np.full((3 * _SAH_BINS, 3), -np.inf, np.float32)
    rep_lo = np.repeat(tlo, 3, axis=0)
    np.minimum.at(bin_min, flat.ravel(), rep_lo)
    np.maximum.at(bin_max, flat.ravel(), np.repeat(thi, 3, axis=0))

    counts = counts.reshape(3, _SAH_BINS)
    bin_min = bin_min.reshape(3, _SAH_BINS, 3)
    bin_max = bin_max.reshape(3, _SAH_BINS, 3)

    # Prefix/suffix sweeps, vectorized across the 3 axes.
    lmin = np.minimum.accumulate(bin_min, axis=1)
    lmax = np.maximum.accumulate(bin_max, axis=1)
    rmin = np.minimum.accumulate(bin_min[:, ::-1], axis=1)[:, ::-1]
    rmax = np.maximum.accumulate(bin_max[:, ::-1], axis=1)[:, ::-1]
    lcount = np.cumsum(counts, axis=1)
    rcount = np.cumsum(counts[:, ::-1], axis=1)[:, ::-1]

    # Split after bin k: left = bins[0..k], right = bins[k+1..].
    nl = lcount[:, :-1]
    nr = rcount[:, 1:]
    costs = np.where(
        (nl > 0) & (nr > 0) & live[:, None],
        area(lmin[:, :-1], lmax[:, :-1]) * nl
        + area(rmin[:, 1:], rmax[:, 1:]) * nr,
        np.inf,
    )
    flat_best = int(np.argmin(costs))
    best_axis, best_k = divmod(flat_best, _SAH_BINS - 1)
    if not np.isfinite(costs[best_axis, best_k]):
        best_axis = -1

    if best_axis < 0:
        # Fall back to a median split on the widest axis.
        order = np.argsort(c[:, widest], kind="stable")
        half = len(idx) // 2
        return idx[order[:half]], idx[order[half:]]

    left_sel = bins3[:, best_axis] <= best_k
    return idx[left_sel], idx[~left_sel]


def build_bvh(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
              leaf_size: int = 8) -> BVH:
    """Binned-SAH BVH over triangles given as (v0, edge1, edge2).

    Prefers the native C++ builder (native/bvh_builder.cpp) when its shared
    library has been built; falls back to the numpy implementation below.
    Triangles are reordered so each leaf owns a contiguous [first, count)
    range; apply `tri_order` to all per-triangle arrays after building.
    """
    import logging

    from raytracer_tpu_torch.accel import native_builder

    log = logging.getLogger(__name__)
    if native_builder.available():
        log.info("BVH build: native builder, %d triangles", len(v0))
        return native_builder.build_bvh_native(v0, e1, e2, leaf_size)
    log.info("BVH build: numpy builder, %d triangles", len(v0))
    return build_bvh_numpy(v0, e1, e2, leaf_size)


_SPLIT_REL_AREA = 64.0   # split refs whose AABB area > this x median
_SPLIT_MAX_FACTOR = 2.0  # total references capped at factor x triangles


def _clip_poly_axis(poly: np.ndarray, axis: int, pos: float,
                    keep_low: bool) -> np.ndarray:
    """Sutherland-Hodgman clip of a convex polygon ([k,3] vertices) against
    the axis-aligned half-space x[axis] <= pos (or >= pos)."""
    out = []
    k = len(poly)
    for i in range(k):
        a = poly[i]
        b = poly[(i + 1) % k]
        a_in = a[axis] <= pos if keep_low else a[axis] >= pos
        b_in = b[axis] <= pos if keep_low else b[axis] >= pos
        if a_in:
            out.append(a)
        if a_in != b_in:
            denom = b[axis] - a[axis]
            t = (pos - a[axis]) / denom if denom != 0.0 else 0.0
            out.append(a + t * (b - a))
    return np.asarray(out, np.float64) if out else np.zeros((0, 3))


def make_split_refs(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    rel_area: float = _SPLIT_REL_AREA,
                    max_factor: float = _SPLIT_MAX_FACTOR):
    """Spatial reference splitting (SBVH-lite, Ernst/Greiner early-split
    style): triangles whose AABB surface area is an outlier are split into
    multiple REFERENCES with tight clipped AABBs, so one room-sized wall
    quad no longer smears a scene-wide box across the tree. The triangle
    GEOMETRY is untouched — a ref only contributes its AABB to the build;
    leaves then hold (possibly duplicated) full triangles, which cannot
    change hit results (any true hit lies in some ref's box, and extra
    ref visits only re-test the same triangle).

    Returns (ref_tri i32[R], ref_lo f32[R,3], ref_hi f32[R,3]); R == T and
    ref boxes == tri boxes when nothing qualifies.

    Reference analog: the Vulkan BVH build quality knob PREFER_FAST_TRACE
    (acceleration_structure.odin:65-143) — split quality is the host
    builder's responsibility here.
    """
    import heapq

    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float64)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float64)

    def area(alo, ahi):
        d = np.maximum(ahi - alo, 0.0)
        return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2]
                      + d[..., 2] * d[..., 0])

    areas = area(lo, hi)
    pos_areas = areas[areas > 0]
    if len(pos_areas) == 0:
        return (np.arange(len(v0), dtype=np.int32), lo.astype(np.float32),
                hi.astype(np.float32))
    thresh = rel_area * float(np.median(pos_areas))
    budget = int(max_factor * len(v0)) - len(v0)

    ref_tri = list(range(len(v0)))
    ref_lo = [lo[i] for i in range(len(v0))]
    ref_hi = [hi[i] for i in range(len(v0))]
    polys = {}

    heap = [(-areas[i], i) for i in np.nonzero(areas > thresh)[0]]
    heapq.heapify(heap)
    while heap and budget > 0:
        neg_a, ri = heapq.heappop(heap)
        if -neg_a <= thresh:
            break
        poly = polys.get(ri)
        if poly is None:
            t = ref_tri[ri]
            poly = np.stack([v0[t], v1[t], v2[t]]).astype(np.float64)
        box_lo, box_hi = ref_lo[ri], ref_hi[ri]
        axis = int(np.argmax(box_hi - box_lo))
        pos = 0.5 * (box_lo[axis] + box_hi[axis])
        pieces = []
        for keep_low in (True, False):
            p = _clip_poly_axis(poly, axis, pos, keep_low)
            if len(p) >= 3:
                plo = np.maximum(p.min(axis=0), box_lo)
                phi = np.minimum(p.max(axis=0), box_hi)
                pieces.append((p, plo, phi))
        if len(pieces) < 2:
            continue  # numerically degenerate split: leave the ref as-is
        # First piece replaces the ref in place; the second is appended.
        (p0, lo0, hi0), (p1, lo1, hi1) = pieces
        polys[ri] = p0
        ref_lo[ri], ref_hi[ri] = lo0, hi0
        new_ri = len(ref_tri)
        ref_tri.append(ref_tri[ri])
        ref_lo.append(lo1)
        ref_hi.append(hi1)
        polys[new_ri] = p1
        budget -= 1
        for r, alo, ahi in ((ri, lo0, hi0), (new_ri, lo1, hi1)):
            a = float(area(alo, ahi))
            if a > thresh:
                heapq.heappush(heap, (-a, r))

    return (
        np.asarray(ref_tri, np.int32),
        np.stack(ref_lo).astype(np.float32),
        np.stack(ref_hi).astype(np.float32),
    )


def build_bvh_split(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    leaf_size: int = 8) -> BVH:
    """build_bvh with spatial reference splitting: large triangles become
    several leaf references with tight clipped AABBs. `tri_order` may repeat
    triangle ids; downstream packing duplicates those rows (hit records are
    unaffected — same triangle, same t/u/v). Proxy 'triangles' spanning each
    ref box feed the unmodified (numpy or native) SAH builder, so both build
    paths benefit."""
    ref_tri, ref_lo, ref_hi = make_split_refs(v0, e1, e2)
    if len(ref_tri) == len(v0):
        bvh = build_bvh(v0, e1, e2, leaf_size=leaf_size)
        bvh.input_tris = len(v0)
        return bvh
    # Proxy with the ref box's exact AABB/centroid: v0=lo, v1=hi, v2=lo.
    bvh = build_bvh(ref_lo, ref_hi - ref_lo, np.zeros_like(ref_lo),
                    leaf_size=leaf_size)
    bvh.tri_order = ref_tri[bvh.tri_order]
    bvh.input_tris = len(v0)
    return bvh


def collapse_bvh4(bvh: BVH):
    """Collapse the binary tree into 4-wide nodes for the sub-packet kernel:
    each quad node's children are its binary grandchildren (or the child
    itself where that child is a leaf), so ONE dynamic row read serves 4
    slab tests and internal pop/push/extract rounds halve — the measured
    cost of a traversal iteration is ~394 cyc of serial latency against
    ~70 cyc of slab VPU (ARCHITECTURE.md), so fewer, fatter iterations win.

    Leaf blocks are untouched (leaf ids match the binary packing, so ptris
    is shared and leaf-visit tie-breaking is unchanged).

    Returns (qnodes f32[N4,32], qmeta i32[4*N4], qroot i32[1],
    stack_need int). qnodes row: 4x(min.xyz, max.xyz), then the 4 child
    metas as exact-int f32 (quad id >= 0, ~leaf_block < 0). ABSENT children
    get NaN boxes — every slab comparison is false, a guaranteed miss (an
    inverted box does NOT work: the slab's per-axis min/max normalizes it
    into an infinite interval that hits everything). stack_need is the
    per-row SMEM stack bound: a 4-ary DFS holds <= 3 entries per level.

    Reference analog: the Vulkan PREFER_FAST_TRACE BVH build quality knob
    (acceleration_structure.odin:65-143) — wide nodes are the host
    builder's concern here."""
    return collapse_bvh4_slots(bvh)[:4]


def collapse_bvh4_slots(bvh: BVH):
    """collapse_bvh4, and the binary node of each child slot i64[N4,4]
    (-1 for an absent child): a refit refills the rows' box lanes 0:24
    from it (quad_boxes) and keeps their metas."""
    is_leaf = bvh.nodes_count > 0
    skip = bvh.nodes_skip
    if is_leaf[0]:
        # Single-leaf scene: the root meta routes straight into the leaf
        # queue (same convention as the binary packing's meta_of(0)); the
        # node arrays are never read.
        qnodes = np.full((1, 32), np.nan, np.float32)
        qnodes[:, 28:32] = 0.0
        qmeta = np.zeros((4,), np.int32)
        slots = np.full((1, 4), -1, np.int64)
        return qnodes, qmeta, np.asarray([~0], np.int32), 4, slots

    leaf_ids = (np.cumsum(is_leaf) - 1).astype(np.int64)
    quad_of = {}
    order = []
    children_of = {}
    depth4 = {0: 0}
    max_d4 = 0
    stack = [0]
    while stack:
        x = stack.pop()
        quad_of[x] = len(order)
        order.append(x)
        left = x + 1
        right = int(skip[left])
        kids = []
        for c in (left, right):
            if is_leaf[c]:
                kids.append(("leaf", int(leaf_ids[c]), c))
            else:
                cl = c + 1
                cr = int(skip[cl])
                for g in (cl, cr):
                    if is_leaf[g]:
                        kids.append(("leaf", int(leaf_ids[g]), g))
                    else:
                        kids.append(("quad", None, g))
        children_of[x] = kids
        for kind, _, node in reversed(kids):
            if kind == "quad":
                depth4[node] = depth4[x] + 1
                max_d4 = max(max_d4, depth4[node])
                stack.append(node)

    n4 = len(order)
    assert n4 < (1 << 24)
    qnodes = np.full((n4, 32), np.nan, np.float32)
    qnodes[:, 28:32] = 0.0
    qmeta = np.zeros((4 * n4,), np.int32)
    slots = np.full((n4, 4), -1, np.int64)
    for x in order:
        qid = quad_of[x]
        row = qnodes[qid]
        for c, (kind, lid, node) in enumerate(children_of[x]):
            row[6 * c + 0: 6 * c + 3] = bvh.nodes_min[node]
            row[6 * c + 3: 6 * c + 6] = bvh.nodes_max[node]
            meta = ~lid if kind == "leaf" else quad_of[node]
            row[24 + c] = np.float32(meta)
            qmeta[4 * qid + c] = meta
            slots[qid, c] = node
    return (qnodes, qmeta, np.asarray([0], np.int32), 3 * (max_d4 + 1) + 1,
            slots)




def quad_boxes(bvh: BVH, slots: np.ndarray) -> np.ndarray:
    """f32[N4,24]: lanes 0:24 of collapse_bvh4's rows from the tree's
    current node boxes, by one gather per lane group: each child slot's
    min.xyz, max.xyz, NaN for an absent child."""
    node = np.maximum(slots, 0)
    boxes = np.concatenate([bvh.nodes_min[node], bvh.nodes_max[node]], -1)
    boxes[slots < 0] = np.nan
    return boxes.reshape(len(slots), 24).astype(np.float32)


def build_bvh_numpy(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                    leaf_size: int = 8) -> BVH:
    t = len(v0)
    assert t > 0, "cannot build a BVH over zero triangles"
    v1 = v0 + e1
    v2 = v0 + e2
    lo = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    centroids = ((lo + hi) * 0.5).astype(np.float32)

    # Recursive top-down build using an explicit stack; children are emitted
    # in preorder so hit-links are implicit (node+1).
    nodes = []  # [min, max, first, count, parent] with count<0 marking internal
    order = []

    stack = [(np.arange(t, dtype=np.int64), -1)]
    while stack:
        idx, parent_slot = stack.pop()
        node_id = len(nodes)
        nmin = lo[idx].min(axis=0)
        nmax = hi[idx].max(axis=0)

        if len(idx) <= leaf_size:
            first = len(order)
            order.extend(idx.tolist())
            nodes.append([nmin, nmax, first, len(idx), parent_slot])
        else:
            left, right = _sah_split(lo, hi, centroids, idx)
            nodes.append([nmin, nmax, 0, -1, parent_slot])
            # Preorder: left child next -> push right first.
            stack.append((right, node_id))
            stack.append((left, node_id))

    nn = len(nodes)
    nodes_min = np.stack([n[0] for n in nodes]).astype(np.float32)
    nodes_max = np.stack([n[1] for n in nodes]).astype(np.float32)
    nodes_first = np.asarray([n[2] for n in nodes], np.int32)
    counts = np.asarray([n[3] for n in nodes], np.int32)
    parent = np.asarray([n[4] for n in nodes], np.int32)
    nodes_count = np.where(counts < 0, 0, counts).astype(np.int32)

    nodes_skip = _compute_skip_links(parent, counts, nn)

    return BVH(
        nodes_min=nodes_min,
        nodes_max=nodes_max,
        nodes_skip=nodes_skip,
        nodes_first=nodes_first,
        nodes_count=nodes_count,
        tri_order=np.asarray(order, np.int32),
        parent=parent,
    )


def _compute_skip_links(parent: np.ndarray, counts: np.ndarray, nn: int) -> np.ndarray:
    """skip[i] = next node in preorder after i's subtree (nn = done).

    In preorder layout a node's subtree is the contiguous index range
    [i, end_i), so the skip target is simply end_i.
    """
    del counts
    # In preorder layout a node's subtree occupies the contiguous index range
    # [i, end_i), so the skip target is simply end_i (== nn means done).
    # Subtree ends come from a reverse scan propagating child ends up to
    # parents (parents always precede children in preorder).
    end = np.arange(1, nn + 1, dtype=np.int32)  # a leaf's subtree ends at i+1
    for i in range(nn - 1, 0, -1):
        p = parent[i]
        if p >= 0 and end[i] > end[p]:
            end[p] = end[i]
    return end
