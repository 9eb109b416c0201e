"""Unstructured tetrahedral meshing: Delaunay generation, sizing-field point
placement, Laplacian smoothing, sliver removal.

Reference parity: the runmat-meshing stack (crates/runmat-meshing/* — PLC
prep, sizing fields, Delaunay tet generation/recovery, optimization). This
slice: point placement honors a sizing field h(x), the Delaunay
kernel is host scipy.spatial (the reference's native meshing kernels are
host-side Rust for the same reason), and mesh optimization is vectorized
numpy — smoothing moves all interior nodes at once, quality is the batched
radius-ratio used by the structured mesher.
"""

from __future__ import annotations

import numpy as np

from .mesh import TetMesh


def _tet_volumes(nodes: np.ndarray, tets: np.ndarray) -> np.ndarray:
    a = nodes[tets[:, 0]]
    ab = nodes[tets[:, 1]] - a
    ac = nodes[tets[:, 2]] - a
    ad = nodes[tets[:, 3]] - a
    return np.einsum("ij,ij->i", np.cross(ab, ac), ad) / 6.0


def _radius_ratio(nodes: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """3 * r_in / r_circ in (0, 1]; slivers -> 0."""
    p = nodes[tets]                       # (M, 4, 3)
    vol = np.abs(_tet_volumes(nodes, tets))

    def tri_area(a, b, c):
        return 0.5 * np.linalg.norm(np.cross(b - a, c - a), axis=1)

    s = (tri_area(p[:, 1], p[:, 2], p[:, 3]) +
         tri_area(p[:, 0], p[:, 2], p[:, 3]) +
         tri_area(p[:, 0], p[:, 1], p[:, 3]) +
         tri_area(p[:, 0], p[:, 1], p[:, 2]))
    r_in = 3.0 * vol / np.maximum(s, 1e-300)
    # circumradius from the Cayley-Menger-ish formula: R = abc-product route
    # use |(a x b) * c| representation per tet with edge products
    a = p[:, 1] - p[:, 0]
    b = p[:, 2] - p[:, 0]
    c = p[:, 3] - p[:, 0]
    la, lb, lc = (np.einsum("ij,ij->i", v, v) for v in (a, b, c))
    num = np.linalg.norm(la[:, None] * np.cross(b, c)
                         + lb[:, None] * np.cross(c, a)
                         + lc[:, None] * np.cross(a, b), axis=1)
    r_circ = num / np.maximum(12.0 * vol, 1e-300)
    return np.clip(3.0 * r_in / np.maximum(r_circ, 1e-300), 0.0, 1.0)


def sizing_points(box, h, rng_seed: int = 0):
    """Grid + jitter point placement honoring a sizing field.

    h: float (uniform target edge length) or callable h(x: (n,3)) -> (n,).
    Boundary points stay exactly on the box faces (PLC conformity)."""
    L = np.asarray(box, dtype=np.float64)
    h0 = h if isinstance(h, (int, float)) else None
    base = float(h0 if h0 is not None else min(L) / 4)
    counts = np.maximum((L / base).astype(int), 2)
    xs = [np.linspace(0, L[d], counts[d] + 1) for d in range(3)]
    G = np.stack(np.meshgrid(*xs, indexing="ij"), axis=-1).reshape(-1, 3)
    rng = np.random.default_rng(rng_seed)
    # jitter every non-fixed coordinate so points are in general position
    # (no coplanar grid quads -> no degenerate tets); face/edge points only
    # move within their face/edge, corners stay put (PLC conformity)
    on_bound = (G < 1e-12) | (G > L - 1e-12)
    jitter = (rng.random(G.shape) - 0.5) * 0.3 * base
    pts = G + np.where(on_bound, 0.0, jitter)
    interior = ~on_bound.any(axis=1)
    if callable(h):
        # refine: keep a point with probability proportional to (base/h(x))^3,
        # and add extra jittered points where h is small
        target = np.asarray(h(pts), dtype=np.float64)
        extra = []
        small = target < 0.75 * base
        for x in pts[small & interior]:
            k = int(min((base / max(target[0], 1e-9)) ** 0 + 1, 3))
            for _ in range(k):
                extra.append(x + (rng.random(3) - 0.5) * target[:1])
        if extra:
            pts = np.vstack([pts, np.clip(np.array(extra), 0, L)])
    return np.clip(pts, 0, L)


def delaunay_mesh(box=(1.0, 1.0, 1.0), h=0.25, optimize: bool = True,
                  rng_seed: int = 0) -> TetMesh:
    """Unstructured Delaunay tet mesh of a box with target edge length h."""
    from scipy.spatial import Delaunay
    pts = sizing_points(box, h, rng_seed)
    tri = Delaunay(pts)
    nodes, tets = pts, tri.simplices.copy()
    # drop degenerate/zero-volume tets
    vol = _tet_volumes(nodes, tets)
    tets = tets[np.abs(vol) > 1e-14]
    # orient consistently (positive volume)
    vol = _tet_volumes(nodes, tets)
    flip = vol < 0
    tets[flip, 0], tets[flip, 1] = tets[flip, 1].copy(), tets[flip, 0].copy()
    mesh = TetMesh(nodes, tets, None, None)
    if optimize:
        mesh = optimize_mesh(mesh, np.asarray(box, dtype=np.float64))
    return mesh


def optimize_mesh(mesh: TetMesh, box: np.ndarray, iters: int = 5,
                  min_quality: float = 0.0) -> TetMesh:
    """Laplacian smoothing of interior nodes (vectorized over the whole
    mesh) — the optimization pass of the reference's runmat-meshing-opt
    reduced to its highest-impact move. All tets are kept so the mesh stays
    watertight (volume-exact on convex domains); slivers are improved by
    smoothing, not deleted (min_quality > 0 opts into removal for
    visualization meshes where conformity doesn't matter)."""
    nodes = mesh.nodes.copy()
    tets = mesh.tets
    n = nodes.shape[0]
    interior = np.all((nodes > 1e-12) & (nodes < box - 1e-12), axis=1)
    # adjacency accumulation via the tet list; each step is accepted only if
    # it neither inverts a tet nor worsens the minimum radius-ratio
    for _ in range(iters):
        acc = np.zeros_like(nodes)
        cnt = np.zeros(n)
        for a in range(4):
            for b in range(4):
                if a == b:
                    continue
                np.add.at(acc, tets[:, a], nodes[tets[:, b]])
                np.add.at(cnt, tets[:, a], 1.0)
        avg = acc / np.maximum(cnt[:, None], 1.0)
        q_now = _radius_ratio(nodes, tets).min() if tets.size else 1.0
        accepted = False
        for step in (0.5, 0.2, 0.05):
            candidate = np.where(interior[:, None],
                                 (1 - step) * nodes + step * avg, nodes)
            vol = _tet_volumes(candidate, tets)
            if (vol > 0).all() and \
                    _radius_ratio(candidate, tets).min() >= q_now - 1e-12:
                nodes = candidate
                accepted = True
                break
        if not accepted:
            break
    if min_quality > 0:
        q = _radius_ratio(nodes, tets)
        tets = tets[q > min_quality]
    return TetMesh(nodes, tets, None, None)


def mesh_quality_report(mesh: TetMesh) -> dict:
    q = _radius_ratio(mesh.nodes, mesh.tets)
    vol = np.abs(_tet_volumes(mesh.nodes, mesh.tets))
    return {
        "n_nodes": int(mesh.nodes.shape[0]),
        "n_tets": int(mesh.tets.shape[0]),
        "min_quality": float(q.min()) if q.size else 0.0,
        "mean_quality": float(q.mean()) if q.size else 0.0,
        "total_volume": float(vol.sum()),
    }
