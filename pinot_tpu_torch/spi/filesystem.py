"""The durable-write discipline of segment persistence, and the line tailer.

Copy of the durable-write part of pinot_tpu/spi/filesystem.py: the one idiom
(tmp write -> flush -> fsync -> os.replace -> directory fsync) that segment
metadata commits through, so a crash at ANY point leaves either the old
committed file or the new one, never a torn file; and of its TailFollower,
the incremental reader of an append-only line file that the realtime file
stream (realtime/stream.py) consumes through.  The deep-store filesystems
(PinotFS) come with the cluster slice of the port.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Optional, Tuple

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
