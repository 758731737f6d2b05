"""Mesh pairs of the shape-transfer traffic, made from a seed.

The reference program's demo meshes are not in the repository, so each
pair is fabricated: a source surface (a genus-0 blob, a sphere with seeded
low-frequency radial bumps, or a torus) and as its target a seeded Sim(3)
transform of a smoothly bent copy of it, with the source's faces.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshPair:
    kind: str                   # "blob" or "torus"
    vertices: int               # the vertex count asked for
    src: np.ndarray             # [V, 3] float32
    tgt: np.ndarray             # [V, 3] float32
    faces: np.ndarray           # [F, 3] int32


def _grid_faces(rows: int, cols: int, wrap_rows: bool) -> np.ndarray:
    """Two triangles a cell of a rows x cols vertex grid whose columns
    wrap around (and its rows too with ``wrap_rows``)."""
    idx = np.arange(rows * cols).reshape(rows, cols)
    a = idx if wrap_rows else idx[:-1]
    b = np.roll(idx, -1, 0) if wrap_rows else idx[1:]
    c, d = np.roll(a, -1, 1), np.roll(b, -1, 1)
    return np.concatenate([np.stack([a, b, d], -1).reshape(-1, 3),
                           np.stack([a, d, c], -1).reshape(-1, 3)])


def torus(n: int) -> tuple[np.ndarray, np.ndarray]:
    """A triangulated torus of about ``n`` vertices (radii 0.5 and 0.2,
    the grid's sides in the ratio of the radii)."""
    minor = max(3, int(round((n / 2.5) ** 0.5)))
    major = max(3, int(round(n / minor)))
    u = np.linspace(0, 2 * np.pi, major, endpoint=False)
    v = np.linspace(0, 2 * np.pi, minor, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    r = 0.5 + 0.2 * np.cos(vv)
    verts = np.stack([r * np.cos(uu), r * np.sin(uu), 0.2 * np.sin(vv)], -1)
    return verts.reshape(-1, 3), _grid_faces(major, minor, True)


def blob(n: int, rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """A genus-0 blob of about ``n`` vertices: a latitude-longitude sphere
    (two poles, each closed by a fan) whose radius carries five seeded
    low-frequency bumps, together at most 0.25 of the radius."""
    lat = max(3, int(round((n / 2.0) ** 0.5)))
    lon = max(3, int(round((n - 2) / lat)))
    theta = np.linspace(0, np.pi, lat + 2)[1:-1]
    phi = np.linspace(0, 2 * np.pi, lon, endpoint=False)
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    d = np.stack([np.sin(tt) * np.cos(pp), np.sin(tt) * np.sin(pp),
                  np.cos(tt)], -1).reshape(-1, 3)
    d = np.concatenate([d, [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]])
    axes = rng.normal(size=(5, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    freq = rng.uniform(1.0, 3.0, 5)
    phase = rng.uniform(0, 2 * np.pi, 5)
    amp = rng.uniform(0.3, 1.0, 5)
    amp *= 0.25 / amp.sum()
    radius = 1.0 + (amp * np.cos(freq * (d @ axes.T) + phase)).sum(1)
    verts = d * radius[:, None]
    faces = [_grid_faces(lat, lon, False)]
    ring = np.arange(lon)
    top, bottom = lat * lon, lat * lon + 1
    faces.append(np.stack([np.full(lon, top), (ring + 1) % lon, ring], -1))
    last = (lat - 1) * lon
    faces.append(np.stack([np.full(lon, bottom), last + ring,
                           last + (ring + 1) % lon], -1))
    return verts, np.concatenate(faces)


def _rotation(axis: np.ndarray, angle: float) -> np.ndarray:
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1 - np.cos(angle)) * (k @ k)


def _unit(rng: np.random.Generator) -> np.ndarray:
    v = rng.normal(size=3)
    return v / np.linalg.norm(v)


def sim3_bend(verts: np.ndarray, rng: np.random.Generator, rot: tuple,
              scale: tuple, offset: tuple, bend: tuple) -> np.ndarray:
    """A seeded Sim(3) transform of a smoothly bent copy of ``verts``: the
    bend moves each vertex along a random direction by ``bend`` (as a
    share of the extent, the bounding box's largest side) times a sine of
    its position along another; then a rotation of ``rot`` radians about
    a random axis, a scale in ``scale`` and an offset of a length in
    ``offset`` (a share of the extent) along a random direction."""
    extent = float((verts.max(0) - verts.min(0)).max())
    along, push = _unit(rng), _unit(rng)
    amp = rng.uniform(*bend) * extent
    bent = verts + amp * np.sin(3.0 * (verts @ along) / extent)[:, None] \
        * push
    r = _rotation(_unit(rng), rng.uniform(*rot))
    s = rng.uniform(*scale)
    t = _unit(rng) * rng.uniform(*offset) * extent
    return s * bent @ r.T + t


def mesh_pool(kinds: list[str], vertices: list[int], seed: int, rot: tuple,
              scale: tuple, offset: tuple, bend: tuple) -> list[MeshPair]:
    """One pair of each kind at each vertex count, all from ``seed``."""
    rng = np.random.default_rng(seed)
    pool = []
    for kind in kinds:
        for n in vertices:
            verts, faces = torus(n) if kind == "torus" else blob(n, rng)
            tgt = sim3_bend(verts, rng, rot, scale, offset, bend)
            pool.append(MeshPair(kind, n, verts.astype(np.float32),
                                 tgt.astype(np.float32),
                                 faces.astype(np.int32)))
    return pool
