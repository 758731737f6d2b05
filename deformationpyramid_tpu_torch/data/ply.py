"""Minimal PLY mesh/point-cloud I/O (no Open3D dependency).

A copy of ``deformationpyramid_tpu/data/ply.py`` (numpy only): importing
the JAX package would import JAX. tests/test_torch_shape_transfer.py holds
the copy to the original. Replaces the reference's Open3D mesh loading
in ``shape_transfer.py:69-83``.
Supports ascii and binary_little_endian, vertex positions + any extra float
properties, and triangular faces.
"""
from __future__ import annotations

import dataclasses

import numpy as np

_DTYPES = {
    "float": ("f4", 4), "float32": ("f4", 4), "double": ("f8", 8),
    "float64": ("f8", 8), "int": ("i4", 4), "int32": ("i4", 4),
    "uint": ("u4", 4), "uint32": ("u4", 4), "short": ("i2", 2),
    "ushort": ("u2", 2), "char": ("i1", 1), "uchar": ("u1", 1),
    "int8": ("i1", 1), "uint8": ("u1", 1),
}


@dataclasses.dataclass
class PlyMesh:
    vertices: np.ndarray          # [V, 3] float32
    faces: np.ndarray | None      # [F, 3] int32 or None
    normals: np.ndarray | None = None  # [V, 3] float32 or None


def load_ply(path: str) -> PlyMesh:
    with open(path, "rb") as f:
        data = f.read()
    header_end = data.index(b"end_header") + len(b"end_header")
    # consume the newline after end_header
    while data[header_end:header_end + 1] in (b"\r", b"\n"):
        header_end += 1
    header = data[:header_end].decode("ascii", errors="replace")
    body = data[header_end:]

    fmt = None
    elements: list[tuple[str, int, list[tuple[str, str]]]] = []
    for line in header.splitlines():
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[-1], f"list:{tok[2]}:{tok[3]}"))
            else:
                elements[-1][2].append((tok[2], tok[1]))

    verts = faces = normals = None
    if fmt == "ascii":
        lines = body.decode("ascii").split("\n")
        cursor = 0
        for name, count, props in elements:
            rows = lines[cursor:cursor + count]
            cursor += count
            if name == "vertex":
                arr = np.loadtxt(rows, dtype=np.float32).reshape(count, -1)
                cols = [p[0] for p in props]
                verts = arr[:, [cols.index(c) for c in "xyz"]]
                if all(c in cols for c in ("nx", "ny", "nz")):
                    normals = arr[:, [cols.index(c) for c in ("nx", "ny", "nz")]]
            elif name == "face":
                face_rows = [r.split() for r in rows if r.strip()]
                faces = np.array([[int(v) for v in r[1:1 + int(r[0])]]
                                  for r in face_rows], dtype=np.int32)
    elif fmt == "binary_little_endian":
        off = 0
        for name, count, props in elements:
            if any(t.startswith("list:") for _, t in props):
                # variable-length faces: parse sequentially (assume tris).
                out = []
                for _ in range(count):
                    for _, t in props:
                        if t.startswith("list:"):
                            _, ct, it = t.split(":")
                            cdt, csz = _DTYPES[ct]
                            idt, isz = _DTYPES[it]
                            n = int(np.frombuffer(body, f"<{cdt}", 1, off)[0])
                            off += csz
                            out.append(np.frombuffer(body, f"<{idt}", n, off).astype(np.int32))
                            off += isz * n
                        else:
                            off += _DTYPES[t][1]
                if name == "face":
                    faces = np.stack([o[:3] for o in out]).astype(np.int32)
            else:
                rec = np.dtype([(p, f"<{_DTYPES[t][0]}") for p, t in props])
                arr = np.frombuffer(body, rec, count, off)
                off += rec.itemsize * count
                if name == "vertex":
                    verts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float32)
                    if all(c in arr.dtype.names for c in ("nx", "ny", "nz")):
                        normals = np.stack([arr["nx"], arr["ny"], arr["nz"]], -1).astype(np.float32)
    else:
        raise ValueError(f"unsupported ply format {fmt!r}")
    return PlyMesh(vertices=verts, faces=faces, normals=normals)


def save_ply(path: str, vertices: np.ndarray, faces: np.ndarray | None = None) -> None:
    v = np.asarray(vertices, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(v)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar uint vertex_indices\n")
        f.write("end_header\n")
        for p in v:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
        if faces is not None:
            for t in faces:
                f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def sample_points_uniformly(mesh: PlyMesh, n: int, seed: int = 0) -> np.ndarray:
    """Area-weighted uniform surface sampling (Open3D-equivalent semantics)."""
    if mesh.faces is None:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, len(mesh.vertices), n)
        return mesh.vertices[idx]
    v = mesh.vertices
    tri = v[mesh.faces]  # [F, 3, 3]
    cross = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    prob = area / max(area.sum(), 1e-12)
    rng = np.random.default_rng(seed)
    fidx = rng.choice(len(prob), size=n, p=prob)
    r1 = np.sqrt(rng.random(n, dtype=np.float64))
    r2 = rng.random(n, dtype=np.float64)
    a, b, c = tri[fidx, 0], tri[fidx, 1], tri[fidx, 2]
    pts = (1 - r1)[:, None] * a + (r1 * (1 - r2))[:, None] * b + (r1 * r2)[:, None] * c
    return pts.astype(np.float32)
