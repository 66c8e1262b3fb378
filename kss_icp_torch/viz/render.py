"""Headless point-cloud renderer (port of kss_icp_tpu/viz/render.py, numpy
only, the same algorithm and so the same PNG bytes) — the replacement for the
reference's interactive GLUT viewer (View.h + Main_KSS_ICP.cpp's
"Main View ... Show Result" mode + GLM draw helpers, PlyLoad.cpp:192-210).

A batch job on an accelerator host has no OpenGL context; the equivalent capability is
rendering registration overlays (source / target / aligned) to image files
for inspection. The rasterizer is a pure-numpy orthographic z-buffer point
splatter writing PNG directly (zlib) — zero GL/matplotlib dependency — with
camera rotation supplied by viz/trackball.py."""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import numpy as np

PathLike = Union[str, Path]

# Overlay palette: target gray-blue, source red, aligned green.
DEFAULT_COLORS = ((90, 120, 200), (220, 80, 60), (70, 190, 90))


def write_png(path: PathLike, rgb: np.ndarray) -> None:
    """Minimal 8-bit RGB PNG writer (H, W, 3)."""
    img = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    Path(path).write_bytes(png)


def render_clouds(
    clouds: Sequence[np.ndarray],
    rotation: Optional[np.ndarray] = None,
    size: Tuple[int, int] = (800, 800),
    point_px: int = 2,
    colors: Sequence[Tuple[int, int, int]] = DEFAULT_COLORS,
    background: Tuple[int, int, int] = (18, 18, 22),
) -> np.ndarray:
    """Rasterize clouds into an (H, W, 3) uint8 image.

    Orthographic projection down −z after applying `rotation` (e.g. a
    Trackball matrix); nearer points win via a z-buffer; depth modulates
    brightness so shape reads without lighting."""
    h, w = size[1], size[0]
    img = np.tile(np.asarray(background, np.uint8), (h, w, 1))
    if not clouds or all(len(c) == 0 for c in clouds):
        return img

    rot = np.eye(3) if rotation is None else np.asarray(rotation, float)
    rotated = [np.asarray(c, float) @ rot.T for c in clouds if len(c)]
    allpts = np.concatenate(rotated, axis=0)
    lo, hi = allpts.min(axis=0), allpts.max(axis=0)
    center = (lo + hi) / 2.0
    span = max((hi - lo)[:2].max(), 1e-12)
    scale = 0.9 * min(w, h) / span

    zbuf = np.full((h, w), -np.inf)
    ci = 0
    for cloud in clouds:
        if len(cloud) == 0:
            ci += 1
            continue
        pts = (np.asarray(cloud, float) @ rot.T - center) * scale
        xs = np.round(pts[:, 0] + w / 2).astype(int)
        ys = np.round(h / 2 - pts[:, 1]).astype(int)
        zs = pts[:, 2]
        zlo, zspan = zs.min(), max(zs.max() - zs.min(), 1e-12)
        shade = 0.55 + 0.45 * (zs - zlo) / zspan
        color = np.asarray(colors[ci % len(colors)], float)
        order = np.argsort(zs)  # far-to-near so near splats overwrite
        r = max(point_px // 2, 0)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                x = xs[order] + dx
                y = ys[order] + dy
                ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
                xo, yo = x[ok], y[ok]
                zo, so = zs[order][ok], shade[order][ok]
                win = zo >= zbuf[yo, xo] - 1e-9
                zbuf[yo[win], xo[win]] = zo[win]
                img[yo[win], xo[win]] = np.clip(
                    color[None, :] * so[win, None], 0, 255
                ).astype(np.uint8)
        ci += 1
    return img


def render_registration(
    path: PathLike,
    target: np.ndarray,
    source: Optional[np.ndarray] = None,
    aligned: Optional[np.ndarray] = None,
    rotation: Optional[np.ndarray] = None,
    **kwargs,
) -> Path:
    """Write the standard registration overlay (target / raw source /
    aligned source) — the still-image equivalent of the reference viewer's
    "Show Result" window."""
    clouds = [np.asarray(target)]
    if source is not None:
        clouds.append(np.asarray(source))
    if aligned is not None:
        clouds.append(np.asarray(aligned))
    img = render_clouds(clouds, rotation=rotation, **kwargs)
    path = Path(path)
    write_png(path, img)
    return path
