"""BVH builder: binned-SAH build + threaded (stackless) preorder flatten.

TPU-native equivalent of the reference's acceleration layer: the reference
builds an SAH BVH with the Rust ``bvh`` crate and flattens it into a threaded
array whose nodes carry an **exit index** — the next preorder node when the
subtree is skipped — so traversal needs no stack (``src/main.rs:198-244``,
device walk ``shader/scene.glsl:99-133``).

This builder keeps those traversal semantics but generalizes the layout for
TPU packet traversal: leaves reference a *contiguous range* of reordered
primitives (``first``/``count``) instead of a single shape index, so a Pallas
kernel can fetch a whole leaf with one scalar dynamic slice. ``leaf_size=1``
reproduces the reference's one-shape-per-leaf shape exactly.

Flat layout (preorder): interior node's left child is ``self+1``; right child
is ``self+1+size(left)``; ``exit`` threads to the sibling/ancestor successor.
Root's exit is ``num_nodes`` (reference uses sentinel 1000000 with a
``current < len`` loop guard — same effect, ``src/main.rs:231``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

N_BINS = 16


@dataclass
class FlatBVH:
    """SoA threaded BVH. All arrays have length num_nodes except prim_order."""

    aabb_min: np.ndarray  # (N,3) f32
    aabb_max: np.ndarray  # (N,3) f32
    first: np.ndarray  # (N,) i32: leaf -> first slot in prim_order
    count: np.ndarray  # (N,) i32: 0 interior, >=1 leaf
    exit: np.ndarray  # (N,) i32: next preorder node if subtree skipped
    prim_order: np.ndarray  # (P,) i32: reordered primitive slot -> input prim id

    @property
    def num_nodes(self) -> int:
        return self.aabb_min.shape[0]


def build_bvh(
    aabb_min: np.ndarray,
    aabb_max: np.ndarray,
    leaf_size: int = 1,
    backend: str = "auto",
) -> FlatBVH:
    """Build a threaded BVH over primitives given per-primitive AABBs.

    Binned SAH (16 bins) on centroids with median-split fallback; iterative
    (explicit stack) so huge scenes don't hit Python recursion limits.

    backend: "auto" (native C++ builder when compilable, else numpy),
    "native", or "numpy". Both builders implement the same split rule; trees
    may differ in float-tie details but satisfy identical invariants.
    """
    if backend in ("auto", "native"):
        from hijiki_tpu_torch.accel.native import build_bvh_native

        bvh = build_bvh_native(aabb_min, aabb_max, leaf_size)
        if bvh is not None:
            return bvh
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable (no g++?)")
    aabb_min = np.asarray(aabb_min, dtype=np.float32).reshape(-1, 3)
    aabb_max = np.asarray(aabb_max, dtype=np.float32).reshape(-1, 3)
    n = aabb_min.shape[0]
    if n == 0:
        raise ValueError("cannot build a BVH over zero primitives")
    centroids = 0.5 * (aabb_min + aabb_max)

    # Tree as parallel lists; children indices into these lists (-1 = leaf).
    t_min, t_max, t_left, t_right, t_first, t_count = [], [], [], [], [], []
    prim_order: list[int] = []

    def alloc() -> int:
        t_min.append(None)
        t_max.append(None)
        t_left.append(-1)
        t_right.append(-1)
        t_first.append(-1)
        t_count.append(0)
        return len(t_min) - 1

    root = alloc()
    stack = [(root, np.arange(n, dtype=np.int64))]
    while stack:
        node, ids = stack.pop()
        bmin = aabb_min[ids].min(axis=0)
        bmax = aabb_max[ids].max(axis=0)
        t_min[node], t_max[node] = bmin, bmax
        if len(ids) <= leaf_size:
            t_first[node] = len(prim_order)
            t_count[node] = len(ids)
            prim_order.extend(ids.tolist())
            continue

        cent = centroids[ids]
        cmin, cmax = cent.min(axis=0), cent.max(axis=0)
        extent = cmax - cmin
        axis = int(np.argmax(extent))
        left_ids = right_ids = None
        if extent[axis] > 0:
            # Binned SAH along the widest centroid axis.
            # float64 scale: a float32 subnormal extent (> 0 but < ~4.7e-38)
            # overflows a float32 divide to inf -> NaN bins -> IndexError;
            # the clip keeps any residual rounding inside the bin range
            scale = N_BINS * (1.0 - 1e-6) / float(extent[axis])
            bins = np.clip(
                ((cent[:, axis].astype(np.float64) - cmin[axis]) * scale).astype(np.int64),
                0,
                N_BINS - 1,
            )
            bin_min = np.full((N_BINS, 3), np.inf, dtype=np.float64)
            bin_max = np.full((N_BINS, 3), -np.inf, dtype=np.float64)
            bin_cnt = np.zeros(N_BINS, dtype=np.int64)
            np.minimum.at(bin_min, bins, aabb_min[ids])
            np.maximum.at(bin_max, bins, aabb_max[ids])
            np.add.at(bin_cnt, bins, 1)

            # Prefix/suffix sweep for SAH cost of each of the N_BINS-1 splits.
            lmin = np.minimum.accumulate(bin_min, axis=0)
            lmax = np.maximum.accumulate(bin_max, axis=0)
            rmin = np.minimum.accumulate(bin_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bin_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(bin_cnt)
            rcnt = np.cumsum(bin_cnt[::-1])[::-1]

            def area(mn, mx):
                d = np.maximum(mx - mn, 0)
                return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

            cost = area(lmin, lmax)[:-1] * lcnt[:-1] + area(rmin[1:], rmax[1:]) * rcnt[1:]
            cost = np.where((lcnt[:-1] == 0) | (rcnt[1:] == 0), np.inf, cost)
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                go_left = bins <= best
                left_ids, right_ids = ids[go_left], ids[~go_left]
        if left_ids is None or len(left_ids) == 0 or len(right_ids) == 0:
            # Degenerate centroids: median split (arbitrary halves if equal).
            order = np.argsort(cent[:, axis], kind="stable")
            half = len(ids) // 2
            left_ids, right_ids = ids[order[:half]], ids[order[half:]]

        li, ri = alloc(), alloc()
        t_left[node], t_right[node] = li, ri
        # Push right first so left is processed (and laid out) first — the
        # stack order itself doesn't matter since flattening re-walks the tree.
        stack.append((ri, right_ids))
        stack.append((li, left_ids))

    # Subtree sizes bottom-up, then preorder flatten with exit threading.
    num_t = len(t_min)
    size = np.ones(num_t, dtype=np.int64)
    # Children always have larger list indices than parents (allocation order),
    # so a reverse scan accumulates subtree sizes correctly.
    for i in range(num_t - 1, -1, -1):
        if t_left[i] >= 0:
            size[i] = 1 + size[t_left[i]] + size[t_right[i]]

    f_min = np.empty((num_t, 3), dtype=np.float32)
    f_max = np.empty((num_t, 3), dtype=np.float32)
    f_first = np.empty(num_t, dtype=np.int32)
    f_count = np.empty(num_t, dtype=np.int32)
    f_exit = np.empty(num_t, dtype=np.int32)

    # Iterative preorder: (tree_idx, exit_idx) with a running output cursor.
    out = 0
    stack2 = [(root, num_t)]
    while stack2:
        ti, exit_idx = stack2.pop()
        f_min[out], f_max[out] = t_min[ti], t_max[ti]
        f_exit[out] = exit_idx
        if t_left[ti] < 0:
            f_first[out] = t_first[ti]
            f_count[out] = t_count[ti]
        else:
            f_first[out] = out + 1  # left child in preorder
            f_count[out] = 0
            right_pos = out + 1 + size[t_left[ti]]
            stack2.append((t_right[ti], exit_idx))
            stack2.append((t_left[ti], right_pos))
        out += 1
    assert out == num_t

    return FlatBVH(
        aabb_min=f_min,
        aabb_max=f_max,
        first=f_first,
        count=f_count,
        exit=f_exit,
        prim_order=np.asarray(prim_order, dtype=np.int32),
    )


def brute_force_reference_order(bvh: FlatBVH) -> np.ndarray:
    """Preorder leaf visit order of primitives (useful in tests)."""
    return bvh.prim_order.copy()


def _reflatten(b: FlatBVH, sort_children) -> FlatBVH:
    """Re-emit the threaded preorder with each interior node's children
    reordered by ``sort_children(child_indices) -> child_indices``.

    Pure traversal-order change: leaves keep their first/count and
    prim_order is untouched, so closest hit is still the min-t winner and
    the estimator is unaffected.
    """
    n = b.num_nodes
    if n <= 1:
        return b
    exit_ = b.exit
    count = b.count

    def children(i):
        ks = []
        c = i + 1
        while c < exit_[i]:
            ks.append(c)
            c = int(exit_[c])
        return ks

    size = np.ones(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        if count[i] == 0:
            size[i] = 1 + sum(size[k] for k in children(i))

    f_min = np.empty((n, 3), dtype=np.float32)
    f_max = np.empty((n, 3), dtype=np.float32)
    f_first = np.empty(n, dtype=np.int32)
    f_count = np.empty(n, dtype=np.int32)
    f_exit = np.empty(n, dtype=np.int32)

    out = 0
    stack = [(0, n)]
    while stack:
        ti, exit_idx = stack.pop()
        f_min[out], f_max[out] = b.aabb_min[ti], b.aabb_max[ti]
        f_exit[out] = exit_idx
        if count[ti] > 0:
            f_first[out] = b.first[ti]
            f_count[out] = count[ti]
        else:
            f_first[out] = out + 1
            f_count[out] = 0
            ks = sort_children(children(ti))
            pos = out + 1
            entries = []
            for k in ks:
                entries.append((k, pos))
                pos += int(size[k])
            for idx in reversed(range(len(entries))):
                k, p = entries[idx]
                nxt = entries[idx + 1][1] if idx + 1 < len(entries) else exit_idx
                stack.append((k, nxt))
        out += 1
    assert out == n

    return FlatBVH(
        aabb_min=f_min,
        aabb_max=f_max,
        first=f_first,
        count=f_count,
        exit=f_exit,
        prim_order=b.prim_order.copy(),
    )


def order_children_by_area(b: FlatBVH) -> FlatBVH:
    """Re-emit the threaded preorder with each interior node's children
    sorted by descending surface area.

    The packet walker visits children in preorder; putting the child a ray is
    most likely to hit first tightens best_t sooner, which prunes the
    siblings' subtrees. Measured: -16% node visits in an idealized simulation
    but ~0% in real renders on cbox (the baked analytic prims already
    pre-tighten best_t); kept because it is free at render time and can only
    help on scenes without that pre-tightening.
    """

    def area(i):
        d = b.aabb_max[i] - b.aabb_min[i]
        return float(2 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2]))

    return _reflatten(b, lambda ks: sorted(ks, key=area, reverse=True))


def order_children_octant(b: FlatBVH, octant: int) -> FlatBVH:
    """Re-emit the threaded preorder with children ordered near-to-far for
    rays of direction octant ``octant`` (bit k set = positive axis k, the
    packet kernels' convention).

    A threaded/stackless walk has a fixed visit order, so near-first ordering
    needs one flattening per octant: children sort by ascending projection of
    their AABB centroid onto the octant diagonal. Rays matching the octant
    then reach the nearest subtree first, tightening best_t early and letting
    the slab test's ``t0 < best_t`` cull far siblings — the stackless
    equivalent of ordered (distance-sorted) BVH traversal.
    """
    d = np.array(
        [
            1.0 if octant & 1 else -1.0,
            1.0 if octant & 2 else -1.0,
            1.0 if octant & 4 else -1.0,
        ],
        dtype=np.float64,
    )
    cent = (b.aabb_min.astype(np.float64) + b.aabb_max.astype(np.float64)) @ d

    return _reflatten(b, lambda ks: sorted(ks, key=lambda k: cent[k]))


def collapse_bvh(bvh: FlatBVH, rounds: int = 1) -> FlatBVH:
    """Widen the tree by level-skipping: each kept interior node adopts its
    grandchildren (leaf children stay direct). Each round squares the arity:
    binary -> 4-ary -> 16-ary.

    Motivation (measured, cbox): ~83% of packet-traversal row visits are
    interior AABB rows, and a packet descends most visited nodes (union
    effect), so the intermediate level's culling rarely pays for its visits.
    Collapsing halves interior rows while keeping the same leaves; the
    threaded own-box walker is arity-agnostic, so only this builder changes.
    """
    for _ in range(rounds):
        bvh = _collapse_once(bvh)
    return bvh


def _collapse_once(b: FlatBVH) -> FlatBVH:
    n = b.num_nodes
    if n <= 1:
        return b
    exit_ = b.exit
    count = b.count

    def children(i):
        # threaded preorder: exit[i] == i + subtree_size(i), so siblings chain
        # c -> exit[c]; works for any arity (collapse rounds compose)
        ks = []
        c = i + 1
        while c < exit_[i]:
            ks.append(c)
            c = int(exit_[c])
        return ks

    def new_children(i):
        ks = []
        for c in children(i):
            if count[c] == 0:
                ks.extend(children(c))  # adopt grandchildren
            else:
                ks.append(c)
        return ks

    # new subtree sizes over KEPT nodes (reverse preorder: children first)
    size = np.ones(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        if count[i] == 0:
            size[i] = 1 + sum(size[k] for k in new_children(i))

    total = int(size[0])
    f_min = np.empty((total, 3), dtype=np.float32)
    f_max = np.empty((total, 3), dtype=np.float32)
    f_first = np.empty(total, dtype=np.int32)
    f_count = np.empty(total, dtype=np.int32)
    f_exit = np.empty(total, dtype=np.int32)

    out = 0
    stack = [(0, total)]
    while stack:
        ti, exit_idx = stack.pop()
        f_min[out], f_max[out] = b.aabb_min[ti], b.aabb_max[ti]
        f_exit[out] = exit_idx
        if count[ti] > 0:
            f_first[out] = b.first[ti]
            f_count[out] = count[ti]
        else:
            f_first[out] = out + 1
            f_count[out] = 0
            ks = new_children(ti)
            pos = out + 1
            entries = []
            for k in ks:
                entries.append((k, pos))
                pos += int(size[k])
            # each child's exit is the next sibling's position (last: ours);
            # push reversed so the first child pops first (lands at out+1)
            for idx in reversed(range(len(entries))):
                k, p = entries[idx]
                nxt = entries[idx + 1][1] if idx + 1 < len(entries) else exit_idx
                stack.append((k, nxt))
        out += 1
    assert out == total

    return FlatBVH(
        aabb_min=f_min,
        aabb_max=f_max,
        first=f_first,
        count=f_count,
        exit=f_exit,
        prim_order=b.prim_order.copy(),
    )
