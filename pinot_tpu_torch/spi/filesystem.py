"""PinotFS: deep-store filesystem abstraction + durable-write discipline.

Copy of pinot_tpu/spi/filesystem.py.  The one durable-write idiom (tmp
write -> flush -> fsync -> os.replace -> directory fsync) that segment
metadata, realtime checkpoints and the coordinator journal commit through,
so a crash at ANY point leaves either the old committed file or the new
one, never a torn file; TailFollower, the incremental reader of an
append-only line file that the realtime file stream (realtime/stream.py)
and the standby coordinator's journal follower (cluster/election.py)
consume through; and the deep store's filesystem contract, `PinotFS`, with
`LocalPinotFS` first-party and other schemes registered by `register_fs`
(an s3:// URI with nothing registered fails with a pointed message).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import urlparse

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


class TailFollower:
    """Incremental line-tail over an append-only file: byte-offset memo +
    torn-tail park (copy of the JAX package's, which the realtime file
    stream and the standby coordinator's journal follower share):

      * a byte-offset memo maps "line index N" to its byte position, so a
        steady-state tail seeks straight to where it left off instead of
        re-reading the whole file every poll (O(total) per batch makes
        long-running tails quadratic);
      * a final line with no trailing newline is a TORN TAIL — a writer
        crashed (or is) mid-append.  It is never surfaced: the memo parks
        BEFORE the partial bytes so the next poll re-reads the completed
        line once the writer finishes (or a recovery truncates it);
      * a file that shrank below the memo (truncated / rewritten — e.g. a
        journal compaction) is reported as `truncated=True` so the caller
        can resynchronize from its snapshot; the scan restarts from 0.

    State is (line, pos) only; the file is opened per read() call, so the
    follower never holds a descriptor across polls (the writer may rename
    the file underneath — the next read simply reopens)."""

    def __init__(self, path: str):
        self.path = path
        self._line = 0  # line index the memo points at
        self._pos = 0  # byte offset where that line starts

    @property
    def position(self) -> Tuple[int, int]:
        """(line index, byte offset) of the next unread line."""
        return self._line, self._pos

    def reset(self) -> None:
        self._line = 0
        self._pos = 0

    def read(
        self,
        start_line: Optional[int] = None,
        max_lines: Optional[int] = None,
        count_line: Optional[Callable[[str], bool]] = None,
    ) -> Tuple[List[Tuple[int, str]], int, bool, bool]:
        """Read complete lines from `start_line` (default: the memo).

        Returns (lines, next_line, eof, truncated) where `lines` is a list
        of (1-based end line index, decoded text without the newline) —
        blank lines are included (they consume a line index), `next_line`
        is the index after the last consumed line, `eof` is True when the
        scan reached the (possibly torn) end of file, and `truncated`
        flags a file that shrank below the memo since the last read.

        `max_lines` bounds how many lines COUNT — by default every line;
        `count_line(text) -> bool` lets a caller bound only meaningful
        lines (FileStream bounds messages, not blanks)."""
        start = self._line if start_line is None else start_line
        if not os.path.exists(self.path):
            return [], start, True, False
        out: List[Tuple[int, str]] = []
        counted = 0
        truncated = False
        with open(self.path, "rb") as f:
            if start == self._line and self._pos > 0:
                # the memo only short-circuits an append-only file: if it
                # shrank (truncate/rewrite/compaction), reset the memo and
                # report — surfacing lines here would let the old line
                # index skip past the rewritten file's fresh content.  The
                # caller resynchronizes (snapshot re-read) and reads again
                # from the top.
                if os.fstat(f.fileno()).st_size >= self._pos:
                    f.seek(self._pos)
                    i = self._line
                else:
                    self._line, self._pos = 0, 0
                    return [], 0, False, True
            else:
                i = 0
            if i == 0 and start != 0:
                # skip to start the slow way (cold start / replay / rescan
                # of a rewritten file)
                while i < start:
                    if not f.readline():
                        break
                    i += 1
            next_line = i
            for raw in iter(f.readline, b""):
                if not raw.endswith(b"\n"):
                    # torn tail: park the memo BEFORE the partial bytes so
                    # the next read re-reads the completed line
                    self._line, self._pos = i, f.tell() - len(raw)
                    return out, next_line, True, truncated
                text = raw[:-1].decode("utf-8")
                if count_line is None or count_line(text):
                    if max_lines is not None and counted >= max_lines:
                        self._line, self._pos = i, f.tell() - len(raw)
                        return out, next_line, False, truncated
                    counted += 1
                i += 1
                next_line = i
                out.append((i, text))
            self._line, self._pos = i, f.tell()
        return out, next_line, True, truncated

    def torn_tail_offset(self) -> Optional[int]:
        """Byte offset of a torn (newline-less) final line, or None when the
        file ends cleanly — the truncation point a recovery path may cut
        back to (the torn bytes never committed: their fsync didn't
        return)."""
        if not os.path.exists(self.path):
            return None
        with open(self.path, "rb") as f:
            pos = 0
            for raw in iter(f.readline, b""):
                if not raw.endswith(b"\n"):
                    return pos
                pos = f.tell()
        return None


class PinotFS:
    """Filesystem contract (mkdir/delete/move/copy/exists/length/listFiles/
    copyToLocal/copyFromLocal), operating on scheme-less paths."""

    def mkdir(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str, force: bool = False) -> bool:
        raise NotImplementedError

    def move(self, src: str, dst: str) -> bool:
        raise NotImplementedError

    def copy(self, src: str, dst: str) -> bool:
        raise NotImplementedError

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def length(self, path: str) -> int:
        raise NotImplementedError

    def list_files(self, path: str, recursive: bool = False) -> List[str]:
        raise NotImplementedError

    def copy_to_local(self, src: str, dst: str) -> None:
        self.copy(src, dst)

    def copy_from_local(self, src: str, dst: str) -> None:
        self.copy(src, dst)


class LocalPinotFS(PinotFS):
    def mkdir(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def delete(self, path: str, force: bool = False) -> bool:
        if os.path.isdir(path):
            if os.listdir(path) and not force:
                return False
            shutil.rmtree(path)
            return True
        if os.path.exists(path):
            os.remove(path)
            return True
        return False

    def move(self, src: str, dst: str) -> bool:
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        shutil.move(src, dst)
        return True

    def copy(self, src: str, dst: str) -> bool:
        os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
        if os.path.isdir(src):
            shutil.copytree(src, dst, dirs_exist_ok=True)
        else:
            shutil.copy2(src, dst)
        return True

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def length(self, path: str) -> int:
        return os.path.getsize(path)

    def list_files(self, path: str, recursive: bool = False) -> List[str]:
        if not recursive:
            return sorted(os.path.join(path, f) for f in os.listdir(path))
        out = []
        for root, _, files in os.walk(path):
            out.extend(os.path.join(root, f) for f in files)
        return sorted(out)


_FS_REGISTRY: Dict[str, Callable[[], PinotFS]] = {
    "": lambda: LocalPinotFS(),
    "file": lambda: LocalPinotFS(),
}


def register_fs(scheme: str, factory: Callable[[], PinotFS]) -> None:
    _FS_REGISTRY[scheme] = factory


def fs_for_uri(uri: str) -> PinotFS:
    scheme = urlparse(uri).scheme
    factory = _FS_REGISTRY.get(scheme)
    if factory is None:
        raise ValueError(
            f"no PinotFS registered for scheme {scheme!r} (register via "
            "pinot_tpu_torch.spi.filesystem.register_fs; cloud plugins are not bundled)"
        )
    return factory()


def strip_scheme(uri: str) -> str:
    p = urlparse(uri)
    return p.path if p.scheme else uri
