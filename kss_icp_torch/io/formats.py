"""Point-cloud file I/O (port of kss_icp_tpu/io/formats.py).

Covers every format the reference touches:
  - PLY ascii (PlyLoad.cpp:10-172) plus binary little- and big-endian;
  - OFF meshes (LoadPointCloud.hpp:146-207);
  - OBJ vertices (LoadPointCloud.hpp:56-70 via GLM);
  - "count format" text clouds — first line N, then one point per line —
    used by .xyz/.gird/.wlop/.txt fixtures (LoadPointCloud.hpp:108-144) and
    .normal caches (normalCompute.hpp:405-435);
  - .xyz writer (Main_KSS_ICP.cpp:49-59). Deliberate fix vs. the reference:
    we truncate instead of ios::app (the reference appends, duplicating data
    on re-runs — flagged in SURVEY.md §5.4).

Host-side numpy, no torch: the readers return the float64 arrays of the JAX
package's Python readers, and the writers write its bytes. The JAX package
tries a native C++ parser first; the port reads and writes with these
readers only (the native reader is ROADMAP.md queue 1 item 13).
"""

from __future__ import annotations

from pathlib import Path
from typing import Union

import numpy as np

PathLike = Union[str, Path]

_PLY_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def load_points(path: PathLike) -> np.ndarray:
    """Load (N, 3) float64 points, dispatching on extension.

    .gird/.wlop/.xyz/.txt → count format; .ply/.off/.obj → mesh formats.
    """
    p = Path(path)
    ext = p.suffix.lower()
    if ext == ".ply":
        return load_ply(p)
    if ext == ".off":
        return load_off(p)
    if ext == ".obj":
        return load_obj(p)
    return load_xyz(p)


def load_xyz(path: PathLike) -> np.ndarray:
    """Count-format or plain whitespace text cloud; first 3 columns used."""
    with open(path, "r") as f:
        first = f.readline().split()
        rest = f.read()
    count = None
    prefix = np.zeros((0, 3))
    if len(first) == 1:
        count = int(float(first[0]))
    elif first:
        prefix = np.array([[float(v) for v in first[:3]]])
    data = np.array(rest.split(), dtype=np.float64)
    ncols = len(first) if prefix.size else (6 if count and data.size == 6 * count else 3)
    if data.size % ncols != 0:
        # Fall back: infer from divisibility.
        ncols = 3 if data.size % 3 == 0 else 6
    pts = data.reshape(-1, ncols)[:, :3]
    pts = np.concatenate([prefix, pts], axis=0)
    if count is not None:
        pts = pts[:count]
    return np.ascontiguousarray(pts, dtype=np.float64)


def load_normals(path: PathLike) -> np.ndarray:
    """A .normal cache: count line then one normal per line."""
    return load_xyz(path)


def load_off(path: PathLike) -> np.ndarray:
    """OFF mesh vertices (faces ignored — the reference registers points)."""
    with open(path, "r") as f:
        tokens = f.read().split()
    i = 0
    if tokens[i].upper().startswith("OFF"):
        i += 1
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3  # skip edge count
    vals = np.array(tokens[i : i + 3 * nv], dtype=np.float64)
    del nf
    return vals.reshape(nv, 3)


def load_obj(path: PathLike) -> np.ndarray:
    """OBJ 'v' lines only."""
    pts = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                pts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    return np.asarray(pts, dtype=np.float64)


def load_ply_vertex_data(path: PathLike) -> dict:
    """All vertex scalar properties of a PLY as {"points": (N,3), and when
    present "normals": (N,3), "colors": (N,3)} — the full CPLYLoader surface
    (PlyLoad.cpp:88-114 parses x y z nx ny nz r g b per vertex)."""
    pts, props = _load_ply_props(Path(path))
    out = {"points": pts}
    names = {p[2] if p[0] == "scalar" else None for p in props["props"]}
    cols = props["columns"]
    if {"nx", "ny", "nz"} <= names:
        out["normals"] = np.stack(
            [cols["nx"], cols["ny"], cols["nz"]], axis=-1
        )
    for keyset in (("red", "green", "blue"), ("r", "g", "b")):
        if set(keyset) <= names:
            out["colors"] = np.stack([cols[k] for k in keyset], axis=-1)
            break
    return out


def load_ply(path: PathLike) -> np.ndarray:
    """PLY vertex x/y/z. Handles ascii, binary_little_endian and binary_big_endian."""
    return _load_ply_props(Path(path))[0]


def _parse_ply_header(path: Path, data: bytes) -> tuple:
    """Parse a PLY header: (fmt, elements, header_end_offset). Each element
    is {"name", "count", "props"} with props ("scalar", dtype, name) or
    ("list", count_dtype, item_dtype, name)."""
    header_end = data.find(b"end_header")
    if header_end < 0:
        raise ValueError(f"{path}: not a PLY file (no end_header)")
    header_end = data.find(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace").splitlines()

    fmt = "ascii"
    elements = []  # list of (name, count, [(prop_name, dtype | list-marker)])
    cur = None
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            cur = {"name": parts[1], "count": int(parts[2]), "props": []}
            elements.append(cur)
        elif parts[0] == "property" and cur is not None:
            if parts[1] == "list":
                cur["props"].append(("list", parts[2], parts[3], parts[4]))
            else:
                cur["props"].append(("scalar", parts[1], parts[2]))
    return fmt, elements, header_end


# Byte-order prefix per PLY binary format name.
_PLY_ENDIAN = {"binary_little_endian": "<", "binary_big_endian": ">"}


def _load_ply_props(path: Path) -> tuple:
    """Internal: ((N, 3) xyz, {"props": vertex props, "columns": {name: col}})."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, header_end = _parse_ply_header(path, data)

    vertex = next((e for e in elements if e["name"] == "vertex"), None)
    if vertex is None:
        raise ValueError(f"{path}: no vertex element")

    if fmt == "ascii":
        body = data[header_end:].decode("ascii", errors="replace").split()
        n_scalar = sum(1 for p in vertex["props"] if p[0] == "scalar")
        if any(p[0] == "list" for p in vertex["props"]):
            raise ValueError("list properties on vertex element unsupported")
        names = [p[2] for p in vertex["props"]]
        # Vertex element always comes first in practice; parse its block.
        nv = vertex["count"]
        vals = np.array(body[: nv * n_scalar], dtype=np.float64).reshape(nv, n_scalar)
        ix, iy, iz = names.index("x"), names.index("y"), names.index("z")
        columns = {n: vals[:, i] for i, n in enumerate(names)}
        return (
            np.ascontiguousarray(vals[:, [ix, iy, iz]]),
            {"props": vertex["props"], "columns": columns},
        )

    if fmt not in _PLY_ENDIAN:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    bo = _PLY_ENDIAN[fmt]

    offset = header_end
    for elem in elements:
        if elem["name"] == "vertex":
            fields = []
            for p in elem["props"]:
                if p[0] == "list":
                    raise ValueError("list property on vertex unsupported")
                fields.append((p[2], bo + _PLY_TYPES[p[1]]))
            arr = np.frombuffer(
                data, dtype=np.dtype(fields), count=elem["count"], offset=offset
            )
            out = np.stack(
                [arr["x"], arr["y"], arr["z"]], axis=-1
            ).astype(np.float64)
            columns = {name: arr[name].astype(np.float64) for name, _ in fields}
            return (
                np.ascontiguousarray(out),
                {"props": elem["props"], "columns": columns},
            )
        # Skip a non-vertex element; only fixed-size elements can be skipped
        # blindly, list elements (faces) require a walk.
        has_list = any(p[0] == "list" for p in elem["props"])
        if has_list:
            for _ in range(elem["count"]):
                for p in elem["props"]:
                    if p[0] == "list":
                        cdt = np.dtype(bo + _PLY_TYPES[p[1]])
                        n = int(
                            np.frombuffer(data, cdt, count=1, offset=offset)[0]
                        )
                        offset += cdt.itemsize + n * np.dtype(
                            bo + _PLY_TYPES[p[2]]
                        ).itemsize
                    else:
                        offset += np.dtype(bo + _PLY_TYPES[p[1]]).itemsize
        else:
            size = sum(np.dtype(bo + _PLY_TYPES[p[1]]).itemsize for p in elem["props"])
            offset += size * elem["count"]
    raise ValueError(f"{path}: vertex element not reachable")


def _load_ply_mesh(path: Path) -> tuple[np.ndarray, np.ndarray]:
    """PLY vertices + triangle faces (CPLYLoader semantics, PlyLoad.cpp:
    118-172: faces come from the `vertex_indices`/`vertex_index` list of the
    face element; polygons are fan-triangulated exactly as the reference's
    (0, t, t+1) loop). Handles ascii, binary LE and binary BE bodies."""
    with open(path, "rb") as f:
        data = f.read()
    fmt, elements, header_end = _parse_ply_header(path, data)
    verts = load_ply(path)

    face = next((e for e in elements if e["name"] == "face"), None)
    if face is None or face["count"] == 0:
        return verts, np.zeros((0, 3), np.int64)

    if fmt == "ascii":
        body = data[header_end:].decode("ascii", errors="replace").split()
        pos = 0
        # Walk elements in declaration order; all-scalar elements consume
        # count*n_props tokens, list elements one count token + n items each.
        polys = []
        for elem in elements:
            if elem["name"] == "face":
                for _ in range(elem["count"]):
                    k = int(float(body[pos]))
                    polys.append(
                        [int(float(t)) for t in body[pos + 1 : pos + 1 + k]]
                    )
                    pos += 1 + k
                break
            if any(p[0] == "list" for p in elem["props"]):
                for _ in range(elem["count"]):
                    k = int(float(body[pos]))
                    pos += 1 + k
            else:
                pos += elem["count"] * len(elem["props"])
        return verts, _fan_triangulate(polys)

    if fmt not in _PLY_ENDIAN:
        raise ValueError(f"{path}: unsupported PLY format {fmt}")
    bo = _PLY_ENDIAN[fmt]

    offset = header_end
    for elem in elements:
        if elem["name"] == "face":
            polys = []
            for _ in range(elem["count"]):
                row = []
                for p in elem["props"]:
                    if p[0] == "list":
                        cdt = np.dtype(bo + _PLY_TYPES[p[1]])
                        idt = np.dtype(bo + _PLY_TYPES[p[2]])
                        k = int(np.frombuffer(data, cdt, 1, offset)[0])
                        offset += cdt.itemsize
                        vals = np.frombuffer(data, idt, k, offset)
                        offset += k * idt.itemsize
                        if p[3] in ("vertex_indices", "vertex_index"):
                            row = [int(v) for v in vals]
                    else:
                        offset += np.dtype(bo + _PLY_TYPES[p[1]]).itemsize
                if row:
                    polys.append(row)
            return verts, _fan_triangulate(polys)
        # skip this element's body
        if any(p[0] == "list" for p in elem["props"]):
            for _ in range(elem["count"]):
                for p in elem["props"]:
                    if p[0] == "list":
                        cdt = np.dtype(bo + _PLY_TYPES[p[1]])
                        k = int(np.frombuffer(data, cdt, 1, offset)[0])
                        offset += cdt.itemsize + k * np.dtype(
                            bo + _PLY_TYPES[p[2]]
                        ).itemsize
                    else:
                        offset += np.dtype(bo + _PLY_TYPES[p[1]]).itemsize
        else:
            size = sum(
                np.dtype(bo + _PLY_TYPES[p[1]]).itemsize for p in elem["props"]
            )
            offset += size * elem["count"]
    return verts, np.zeros((0, 3), np.int64)


class UniformInfo:
    """Record of a PointCloud_Uniform normalization (LoadPointCloud.hpp:
    347-427): the AABB-midpoint shift and longest-edge scale that map the
    cloud into [-1, 1]³, plus the AABB-extreme point indices, so the
    transform is invertible."""

    __slots__ = ("center", "scale", "border_indices")

    def __init__(self, center: np.ndarray, scale: float, border_indices: np.ndarray):
        self.center = center
        self.scale = scale  # the reference's scaleG: longest AABB edge / 2
        self.border_indices = border_indices  # [minX,minY,minZ,maxX,maxY,maxZ]

    def apply(self, points: np.ndarray) -> np.ndarray:
        return (np.asarray(points, np.float64) - self.center) / self.scale

    def invert(self, points: np.ndarray) -> np.ndarray:
        return np.asarray(points, np.float64) * self.scale + self.center


def border_indices(points: np.ndarray) -> np.ndarray:
    """AABB-extreme point indices [minX,minY,minZ,maxX,maxY,maxZ]
    (pointPipeline_Border, pointPipeline.hpp:105-158)."""
    pts = np.asarray(points)
    return np.concatenate([pts.argmin(axis=0), pts.argmax(axis=0)])


def uniform_normalize(points: np.ndarray) -> tuple[np.ndarray, UniformInfo]:
    """PointCloud_Uniform: recenter to the AABB midpoint and scale the longest
    AABB edge to 2, so the cloud fits [-1, 1]³ (LoadPointCloud.hpp:347-427).
    Returns (normalized points, invertible record)."""
    pts = np.asarray(points, dtype=np.float64)
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    center = (lo + hi) / 2.0
    scale = float(max((hi - lo).max() / 2.0, np.finfo(np.float64).tiny))
    info = UniformInfo(center, scale, border_indices(pts))
    return info.apply(pts), info


def save_normals(path: PathLike, normals: np.ndarray) -> None:
    """Write a `.normal` cache (count format, normalCompute.hpp:597-612)."""
    save_xyz(path, normals)


# ---------------------------------------------------------------------------
# Mesh loading (vertices + faces) and format converters
# ---------------------------------------------------------------------------

def load_mesh(path: PathLike) -> tuple[np.ndarray, np.ndarray]:
    """Load (vertices (V, 3) f64, triangle faces (F, 3) i64) from OFF, OBJ
    or PLY. Polygons are fan-triangulated. Face-free inputs return an empty
    face array. (The reference reads faces via GLM glmReadOBJ, the OFF
    parser at LoadPointCloud.hpp:146-207, and the PLY face parser at
    PlyLoad.cpp:118-172.)"""
    p = Path(path)
    ext = p.suffix.lower()
    if ext == ".off":
        return _load_off_mesh(p)
    if ext == ".obj":
        return _load_obj_mesh(p)
    if ext == ".ply":
        return _load_ply_mesh(p)
    raise ValueError(f"load_mesh: unsupported extension {ext}")


def _fan_triangulate(polys) -> np.ndarray:
    tris = []
    for poly in polys:
        for t in range(1, len(poly) - 1):
            tris.append((poly[0], poly[t], poly[t + 1]))
    return np.asarray(tris, dtype=np.int64).reshape(-1, 3)


def _load_off_mesh(path: Path) -> tuple[np.ndarray, np.ndarray]:
    tokens = Path(path).read_text().split()
    i = 1 if tokens[0].upper().startswith("OFF") else 0
    nv, nf = int(tokens[i]), int(tokens[i + 1])
    i += 3
    verts = np.array(tokens[i : i + 3 * nv], dtype=np.float64).reshape(nv, 3)
    i += 3 * nv
    polys = []
    for _ in range(nf):
        k = int(tokens[i])
        polys.append([int(t) for t in tokens[i + 1 : i + 1 + k]])
        i += 1 + k
    return verts, _fan_triangulate(polys)


def _load_obj_mesh(path: Path) -> tuple[np.ndarray, np.ndarray]:
    verts, polys = [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = [int(tok.split("/")[0]) - 1 for tok in line.split()[1:]]
                polys.append(idx)
    return np.asarray(verts, dtype=np.float64), _fan_triangulate(polys)


def save_obj(path: PathLike, vertices: np.ndarray, faces: np.ndarray | None = None) -> None:
    """Write an OBJ mesh (faces 0-based in, 1-based out)."""
    with open(path, "w") as f:
        for v in np.asarray(vertices, np.float64):
            f.write(f"v {v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        if faces is not None:
            for t in np.asarray(faces, np.int64):
                f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")


def save_off(path: PathLike, vertices: np.ndarray, faces: np.ndarray | None = None) -> None:
    """Write an OFF mesh."""
    verts = np.asarray(vertices, np.float64)
    tris = np.zeros((0, 3), np.int64) if faces is None else np.asarray(faces, np.int64)
    with open(path, "w") as f:
        f.write(f"OFF\n{verts.shape[0]} {tris.shape[0]} 0\n")
        for v in verts:
            f.write(f"{v[0]:.6g} {v[1]:.6g} {v[2]:.6g}\n")
        for t in tris:
            f.write(f"3 {t[0]} {t[1]} {t[2]}\n")


def convert_off_to_obj(src: PathLike, dst: PathLike | None = None, overwrite: bool = False) -> Path:
    """OFF → OBJ (LoadPointCloud.hpp:209-260 semantics: skip if the output
    already exists unless overwrite)."""
    src = Path(src)
    dst = Path(dst) if dst else src.with_suffix(".obj")
    if dst.exists() and not overwrite:
        return dst
    save_obj(dst, *_load_off_mesh(src))
    return dst


def convert_obj_to_off(src: PathLike, dst: PathLike | None = None, overwrite: bool = False) -> Path:
    """OBJ → OFF (LoadPointCloud.hpp:262-311 semantics)."""
    src = Path(src)
    dst = Path(dst) if dst else src.with_suffix(".off")
    if dst.exists() and not overwrite:
        return dst
    save_off(dst, *_load_obj_mesh(src))
    return dst


def save_xyz(path: PathLike, points: np.ndarray) -> None:
    """Write count-format .xyz (Main_KSS_ICP.cpp:49-59 layout, %.6g, truncating)."""
    pts = np.asarray(points, dtype=np.float64)
    with open(path, "w") as f:
        f.write(f"{pts.shape[0]}\n")
        np.savetxt(f, pts, fmt="%.6g")


def save_ply(
    path: PathLike,
    points: np.ndarray,
    faces: np.ndarray | None = None,
    fmt: str = "binary_little_endian",
) -> None:
    """Write a PLY. `faces` (F, 3) adds a face element with the standard
    `uchar count + int vertex_indices` list layout (the shape CPLYLoader
    parses, PlyLoad.cpp:118-172). fmt: "ascii" | "binary_little_endian" |
    "binary_big_endian"."""
    pts = np.ascontiguousarray(np.asarray(points, dtype=np.float32))
    tris = None if faces is None else np.asarray(faces, np.int32)
    header = (
        f"ply\nformat {fmt} 1.0\n"
        f"element vertex {pts.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
    )
    if tris is not None:
        header += (
            f"element face {tris.shape[0]}\n"
            "property list uchar int vertex_indices\n"
        )
    header += "end_header\n"
    if fmt == "ascii":
        with open(path, "w") as f:
            f.write(header)
            np.savetxt(f, pts, fmt="%.9g")
            if tris is not None:
                for t in tris:
                    f.write(f"3 {t[0]} {t[1]} {t[2]}\n")
        return
    if fmt not in _PLY_ENDIAN:
        raise ValueError(f"save_ply: unsupported format {fmt}")
    bo = _PLY_ENDIAN[fmt]
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(pts.astype(bo + "f4").tobytes())
        if tris is not None:
            row = np.dtype([("n", "u1"), ("idx", bo + "i4", (3,))])
            out = np.empty(tris.shape[0], row)
            out["n"] = 3
            out["idx"] = tris
            f.write(out.tobytes())
