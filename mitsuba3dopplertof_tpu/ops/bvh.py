"""Bounding-volume hierarchy for large meshes.

The reference accelerates rays with Embree BVHs / OptiX GASes (reference
src/render/scene_embree.inl, scene_optix.inl). Here: a host-built threaded
BVH (DFS order + escape links, leaf size <= 4) traversed *stacklessly* over
the whole wavefront in pure XLA — each lane carries one node pointer, a
`lax.while_loop` steps all lanes until every lane walks off the root's
escape link. Node AABBs and leaf triangles are fetched with vector gathers,
so the traversal is branch-free per lane: hit an inner node -> descend to
node+1 (first child in DFS order); miss -> jump to the escape index. Every
lane waits for the slowest lane of the wavefront; a per-thread traversal
kernel is the GPU's own idiom and is left for later (ROADMAP).

Build: binned-median split on the longest centroid axis (host numpy).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

LEAF_SIZE = 4
# triangle count of the static set, or of one animated instance, above
# which ray queries traverse a BVH instead of scanning every triangle
# (set from a hero-scene render on an H100, see PERF.md)
BVH_THRESHOLD = 64


class BVHArrays(NamedTuple):
    minx: jnp.ndarray
    miny: jnp.ndarray
    minz: jnp.ndarray
    maxx: jnp.ndarray
    maxy: jnp.ndarray
    maxz: jnp.ndarray
    first: jnp.ndarray     # leaf: first index into tri permutation
    count: jnp.ndarray     # 0 = inner node, >0 = leaf triangle count
    escape: jnp.ndarray    # node to jump to on miss / after a leaf
    tri: jnp.ndarray       # (T,) permutation into the original tri arrays


def build_bvh(v0, e1, e2) -> BVHArrays:
    """Host-side build over triangle (v0, e1, e2) component arrays
    (each a dict-like of x/y/z numpy arrays)."""
    v0 = np.stack(v0, axis=1)          # (T, 3)
    p1 = v0 + np.stack(e1, axis=1)
    p2 = v0 + np.stack(e2, axis=1)
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    # epsilon padding so float32 AABB rounding can't miss borderline hits
    pad = 1e-5 * np.maximum(np.abs(lo), np.abs(hi)) + 1e-7
    lo = lo - pad
    hi = hi + pad
    cen = 0.5 * (lo + hi)
    T = v0.shape[0]
    order = np.arange(T)

    # iterative DFS build; children emitted immediately after the parent so
    # that "descend" == node+1
    nodes_min, nodes_max = [], []
    nodes_first, nodes_count = [], []
    out_ranges = []
    stack = [(0, T)]         # ranges into `order`
    while stack:
        s, e = stack.pop()
        idx = order[s:e]
        nlo = lo[idx].min(axis=0)
        nhi = hi[idx].max(axis=0)
        nodes_min.append(nlo)
        nodes_max.append(nhi)
        out_ranges.append((s, e))
        if e - s <= LEAF_SIZE:
            nodes_first.append(s)
            nodes_count.append(e - s)
            continue
        # median split on the longest centroid axis
        c = cen[idx]
        ext = c.max(axis=0) - c.min(axis=0)
        axis = int(np.argmax(ext))
        m = (e - s) // 2
        part = np.argpartition(c[:, axis], m)
        order[s:e] = idx[part]
        nodes_first.append(-1)
        nodes_count.append(0)
        # push right first so the left child is emitted next (DFS)
        stack.append((s + m, e))
        stack.append((s, s + m))

    n_nodes = len(nodes_min)
    first = np.asarray(nodes_first, np.int32)
    count = np.asarray(nodes_count, np.int32)

    # escape links: in DFS order the node range-starts are non-decreasing
    # and subtree(i) is exactly the consecutive run of nodes whose range
    # start < end(i); escape(i) = first node with start >= end(i)
    rng = np.asarray(out_ranges, np.int64)          # (n_nodes, 2)
    escape = np.searchsorted(rng[:, 0], rng[:, 1],
                             side="left").astype(np.int32)
    nm = np.stack(nodes_min)
    nx = np.stack(nodes_max)
    return BVHArrays(
        jnp.asarray(nm[:, 0]), jnp.asarray(nm[:, 1]), jnp.asarray(nm[:, 2]),
        jnp.asarray(nx[:, 0]), jnp.asarray(nx[:, 1]), jnp.asarray(nx[:, 2]),
        jnp.asarray(first), jnp.asarray(count), jnp.asarray(escape),
        jnp.asarray(order.astype(np.int32)))


def _moller(ox, oy, oz, dx, dy, dz, v0x, v0y, v0z,
            e1x, e1y, e1z, e2x, e2y, e2z):
    """Watertight-enough Möller-Trumbore; returns (t, ok)."""
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    inv = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv
    ok = ((jnp.abs(det) > 1e-12) & (u >= 0.0) & (v >= 0.0)
          & (u + v <= 1.0) & (t > 1e-5))
    return t, ok


def bvh_closest(bvh: BVHArrays, tri_cols, o, d, maxt, best):
    """Stackless wavefront traversal. ``tri_cols``: dict of the 9 static
    vertex/edge component arrays; ``best``: (t, idx) running closest hit
    (idx in ORIGINAL triangle numbering). Returns updated (t, idx)."""
    n_nodes = int(bvh.count.shape[0])
    best_t, best_i = best
    inv_x = 1.0 / jnp.where(jnp.abs(d.x) > 1e-12, d.x,
                            jnp.where(d.x >= 0, 1e-12, -1e-12))
    inv_y = 1.0 / jnp.where(jnp.abs(d.y) > 1e-12, d.y,
                            jnp.where(d.y >= 0, 1e-12, -1e-12))
    inv_z = 1.0 / jnp.where(jnp.abs(d.z) > 1e-12, d.z,
                            jnp.where(d.z >= 0, 1e-12, -1e-12))

    def take(a, i):
        return jnp.take(a, i, mode="clip")

    def step(carry):
        node, bt, bi = carry
        act = node < n_nodes
        ni = jnp.minimum(node, n_nodes - 1)
        t0x = (take(bvh.minx, ni) - o.x) * inv_x
        t1x = (take(bvh.maxx, ni) - o.x) * inv_x
        t0y = (take(bvh.miny, ni) - o.y) * inv_y
        t1y = (take(bvh.maxy, ni) - o.y) * inv_y
        t0z = (take(bvh.minz, ni) - o.z) * inv_z
        t1z = (take(bvh.maxz, ni) - o.z) * inv_z
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                     jnp.maximum(t0y, t1y)),
                         jnp.maximum(t0z, t1z))
        tmax = jnp.minimum(bt, maxt)
        hit_box = act & (tf >= jnp.maximum(tn, 0.0)) & (tn < tmax)

        cnt = take(bvh.count, ni)
        fst = take(bvh.first, ni)
        leaf = cnt > 0
        do_leaf = hit_box & leaf
        for k in range(LEAF_SIZE):
            tri_ok = do_leaf & (k < cnt)
            tid = take(bvh.tri, jnp.minimum(fst + k,
                                            bvh.tri.shape[0] - 1))
            g = {c: take(tri_cols[c], tid) for c in tri_cols}
            t, ok = _moller(o.x, o.y, o.z, d.x, d.y, d.z,
                            g["v0x"], g["v0y"], g["v0z"],
                            g["e1x"], g["e1y"], g["e1z"],
                            g["e2x"], g["e2y"], g["e2z"])
            win = tri_ok & ok & (t < jnp.minimum(bt, maxt))
            bt = jnp.where(win, t, bt)
            bi = jnp.where(win, tid, bi)

        esc = take(bvh.escape, ni)
        nxt = jnp.where(hit_box & ~leaf, node + 1, esc)
        node = jnp.where(act, nxt, node)
        return node, bt, bi

    def cond(carry):
        node, _, _ = carry
        return jnp.any(node < n_nodes)

    node0 = jnp.zeros(o.x.shape, jnp.int32)
    node0, best_t, best_i = jax.lax.while_loop(
        cond, step, (node0, best_t, best_i))
    return best_t, best_i


def bvh_any(bvh: BVHArrays, tri_cols, o, d, maxt):
    """Any-hit traversal for shadow rays: lanes jump past the root as soon
    as one occluder is found. Returns the occlusion mask."""
    n_nodes = int(bvh.count.shape[0])
    inv_x = 1.0 / jnp.where(jnp.abs(d.x) > 1e-12, d.x,
                            jnp.where(d.x >= 0, 1e-12, -1e-12))
    inv_y = 1.0 / jnp.where(jnp.abs(d.y) > 1e-12, d.y,
                            jnp.where(d.y >= 0, 1e-12, -1e-12))
    inv_z = 1.0 / jnp.where(jnp.abs(d.z) > 1e-12, d.z,
                            jnp.where(d.z >= 0, 1e-12, -1e-12))

    def take(a, i):
        return jnp.take(a, i, mode="clip")

    def step(carry):
        node, occ = carry
        act = (node < n_nodes) & ~occ
        ni = jnp.minimum(node, n_nodes - 1)
        t0x = (take(bvh.minx, ni) - o.x) * inv_x
        t1x = (take(bvh.maxx, ni) - o.x) * inv_x
        t0y = (take(bvh.miny, ni) - o.y) * inv_y
        t1y = (take(bvh.maxy, ni) - o.y) * inv_y
        t0z = (take(bvh.minz, ni) - o.z) * inv_z
        t1z = (take(bvh.maxz, ni) - o.z) * inv_z
        tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                     jnp.minimum(t0y, t1y)),
                         jnp.minimum(t0z, t1z))
        tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                     jnp.maximum(t0y, t1y)),
                         jnp.maximum(t0z, t1z))
        hit_box = act & (tf >= jnp.maximum(tn, 0.0)) & (tn < maxt)

        cnt = take(bvh.count, ni)
        fst = take(bvh.first, ni)
        leaf = cnt > 0
        do_leaf = hit_box & leaf
        for k in range(LEAF_SIZE):
            tri_ok = do_leaf & (k < cnt)
            tid = take(bvh.tri, jnp.minimum(fst + k,
                                            bvh.tri.shape[0] - 1))
            g = {c: take(tri_cols[c], tid) for c in tri_cols}
            t, ok = _moller(o.x, o.y, o.z, d.x, d.y, d.z,
                            g["v0x"], g["v0y"], g["v0z"],
                            g["e1x"], g["e1y"], g["e1z"],
                            g["e2x"], g["e2y"], g["e2z"])
            occ = occ | (tri_ok & ok & (t < maxt))

        esc = take(bvh.escape, ni)
        nxt = jnp.where(hit_box & ~leaf, node + 1, esc)
        node = jnp.where(act, nxt, jnp.where(occ, n_nodes, node))
        return node, occ

    def cond(carry):
        node, occ = carry
        return jnp.any((node < n_nodes) & ~occ)

    node0 = jnp.zeros(o.x.shape, jnp.int32)
    occ0 = jnp.zeros(o.x.shape, bool)
    _, occ = jax.lax.while_loop(cond, step, (node0, occ0))
    return occ


__all__ = ["BVHArrays", "build_bvh", "bvh_closest", "bvh_any",
           "BVH_THRESHOLD", "LEAF_SIZE"]
