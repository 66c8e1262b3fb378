"""Directory walking + stats (port of kss_icp_tpu/utils/fileproc.py) — cross-platform rebuild of the reference's
Win32 shell utilities (`FileProcess/`: CBrowseDir recursive walker,
CStatDir.hpp file/dir counters; the GetOpenFileName dialog has no headless
analogue and is deliberately dropped)."""

from __future__ import annotations

import dataclasses
import fnmatch
import os
from pathlib import Path
from typing import Callable, Iterator, List, Optional, Union

PathLike = Union[str, Path]

POINT_CLOUD_EXTENSIONS = {
    ".ply", ".off", ".obj", ".xyz", ".txt", ".gird", ".wlop", ".normal",
}


def browse_dir(
    root: PathLike,
    pattern: str = "*",
    on_file: Optional[Callable[[Path], bool]] = None,
) -> Iterator[Path]:
    """Recursive file walk with a glob filter (CBrowseDir::BeginBrowse).
    `on_file` mirrors ProcessFile: return False to stop the walk early."""
    for dirpath, _, filenames in os.walk(root):
        for name in sorted(filenames):
            if fnmatch.fnmatch(name, pattern):
                path = Path(dirpath) / name
                if on_file is not None and not on_file(path):
                    return
                yield path


@dataclasses.dataclass
class DirStats:
    """CStatDir's counters plus total bytes."""

    file_count: int = 0
    subdir_count: int = 0
    total_bytes: int = 0


def stat_dir(root: PathLike, pattern: str = "*") -> DirStats:
    """Count matching files, subdirectories and bytes under root
    (CStatDir.hpp semantics)."""
    stats = DirStats()
    for dirpath, dirnames, filenames in os.walk(root):
        stats.subdir_count += len(dirnames)
        for name in filenames:
            if fnmatch.fnmatch(name, pattern):
                stats.file_count += 1
                try:
                    stats.total_bytes += (Path(dirpath) / name).stat().st_size
                except OSError:
                    pass
    return stats


def find_point_clouds(root: PathLike) -> List[Path]:
    """All recognized point-cloud/mesh files under root — the batch-driver
    discovery step (Main_KSS_List's model-name loop without hardcoding)."""
    return [
        p
        for p in browse_dir(root)
        if p.suffix.lower() in POINT_CLOUD_EXTENSIONS
    ]
