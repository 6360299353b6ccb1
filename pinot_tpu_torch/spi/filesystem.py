"""The durable-write discipline of segment persistence.

Copy of the durable-write part of pinot_tpu/spi/filesystem.py: the one idiom
(tmp write -> flush -> fsync -> os.replace -> directory fsync) that segment
metadata commits through, so a crash at ANY point leaves either the old
committed file or the new one, never a torn file.  The deep-store
filesystems (PinotFS) and the line tailer (TailFollower) come with the
cluster and realtime slices of the port.
"""
from __future__ import annotations

import json
import os
from typing import Any, List

from pinot_tpu_torch.utils.crashpoints import crash_point


def fsync_dir(path: str) -> None:
    """fsync the directory entry so a rename survives power loss (best
    effort: some platforms/filesystems refuse O_RDONLY dir fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def durable_write_bytes(path: str, data: bytes, crash_prefix: str = "durable_write") -> None:
    """Atomically replace `path` with `data`: tmp + fsync + os.replace.

    `crash_prefix` names the kill-points a FaultPlan can arm between the
    steps ({prefix}.after_write before the fsync+rename commit,
    {prefix}.after_replace before the directory fsync)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        crash_point(f"{crash_prefix}.after_write")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    crash_point(f"{crash_prefix}.after_replace")
    fsync_dir(os.path.dirname(path) or ".")


def durable_write_json(path: str, obj: Any, crash_prefix: str = "durable_write", **dump_kw) -> None:
    durable_write_bytes(
        path, json.dumps(obj, **dump_kw).encode("utf-8"), crash_prefix=crash_prefix
    )


def sweep_tmp(dir_path: str) -> List[str]:
    """Remove stale `*.tmp` files a crash left behind (a tmp file is by
    definition uncommitted — deleting it is always safe).  Returns what was
    swept, for logs/metrics."""
    swept: List[str] = []
    if not os.path.isdir(dir_path):
        return swept
    for name in sorted(os.listdir(dir_path)):
        if name.endswith(".tmp"):
            p = os.path.join(dir_path, name)
            if os.path.isfile(p):
                try:
                    os.remove(p)
                    swept.append(p)
                except OSError:
                    pass
    return swept
