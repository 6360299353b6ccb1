"""Stream SPI: pluggable partitioned message sources with ordered offsets.

Copy of pinot_tpu/realtime/stream.py (host-only).  Reference parity:
pinot-spi/.../spi/stream/ — StreamConsumerFactory,
PartitionGroupConsumer.fetchMessages, MessageBatch, and the ordering-abstract
StreamPartitionMsgOffset.  Re-design: offsets are plain ints (the Kafka
LongMsgOffset case); the SPI stays ordering-abstract through compare-by-int.
Kafka/Kinesis/Pulsar bindings are out-of-image (zero egress); the two built-in
consumers — an in-memory topic for tests/simulation and a JSONL file tail —
exercise the same consume loop the reference drives against Kafka.
"""
from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

from pinot_tpu_torch.spi.config import StreamConfig
from pinot_tpu_torch.spi.filesystem import TailFollower
from pinot_tpu_torch.utils.hashing import partition_of


@dataclass
class StreamMessage:
    """One event: optional key (upsert/partition routing), dict payload, and
    the offset AFTER this message (next fetch position)."""

    value: Dict[str, Any]
    offset: int
    key: Optional[Any] = None


@dataclass
class MessageBatch:
    """fetchMessages result (MessageBatch analog): messages plus the offset to
    resume from (offsetOfNextBatch) and end-of-partition flag."""

    messages: List[StreamMessage]
    next_offset: int
    end_of_partition: bool = False

    def __len__(self) -> int:
        return len(self.messages)


class PartitionGroupConsumer:
    """Per-partition consumer contract (PartitionGroupConsumer analog)."""

    def fetch(self, start_offset: int, max_messages: int = 1024) -> MessageBatch:
        raise NotImplementedError

    def latest_offset(self) -> int:
        raise NotImplementedError

    def close(self) -> None:
        pass


class InMemoryStream:
    """A partitioned in-memory topic; the test/simulation stream plugin.

    publish() appends to a partition's log; consumers fetch by offset.  The
    log is append-only so any offset may be re-read (replay after restart —
    the property the consume loop's checkpoint/resume depends on)."""

    def __init__(self, num_partitions: int = 1):
        self.num_partitions = num_partitions
        self._logs: List[List[StreamMessage]] = [[] for _ in range(num_partitions)]
        self._lock = threading.Lock()

    def publish(self, value: Dict[str, Any], key: Optional[Any] = None, partition: Optional[int] = None) -> int:
        with self._lock:
            if partition is None:
                # stable hash (utils/hashing.py murmur2, the Kafka default
                # partitioner): Python's hash() is salted per process
                # (PYTHONHASHSEED), so a producer restart would re-route
                # keys and break partition-affinity invariants (upsert
                # locality, checkpointed offsets pointing at the wrong log)
                partition = partition_of(key, self.num_partitions) if key is not None else 0
            log = self._logs[partition]
            msg = StreamMessage(value=value, offset=len(log) + 1, key=key)
            log.append(msg)
            return msg.offset - 1

    def publish_many(self, values: List[Dict[str, Any]], partition: int = 0) -> None:
        for v in values:
            self.publish(v, partition=partition)

    def consumer(self, partition: int) -> "_MemoryConsumer":
        return _MemoryConsumer(self, partition)


class _MemoryConsumer(PartitionGroupConsumer):
    def __init__(self, stream: InMemoryStream, partition: int):
        self._stream = stream
        self._partition = partition

    def fetch(self, start_offset: int, max_messages: int = 1024) -> MessageBatch:
        with self._stream._lock:
            log = self._stream._logs[self._partition]
            msgs = log[start_offset : start_offset + max_messages]
            next_off = start_offset + len(msgs)
            return MessageBatch(messages=list(msgs), next_offset=next_off, end_of_partition=next_off >= len(log))

    def latest_offset(self) -> int:
        with self._stream._lock:
            return len(self._stream._logs[self._partition])


class FileStream(PartitionGroupConsumer):
    """JSONL file tail: offset = line number.  The batch-file analog of a
    stream partition (reference: pinot-file-ingestion via stream SPI); lines
    appended after open are visible to subsequent fetches.

    The incremental tail (byte-offset memo + torn-tail park) rides
    spi.filesystem.TailFollower."""

    def __init__(self, path: str):
        self.path = path
        self._tail = TailFollower(path)

    def fetch(self, start_offset: int, max_messages: int = 1024) -> MessageBatch:
        """Offsets are RAW line indices (blank lines consume an offset but
        emit no message) so fetch/next_offset/latest_offset stay aligned."""
        if not os.path.exists(self.path):
            return MessageBatch(messages=[], next_offset=start_offset, end_of_partition=True)
        lines, next_offset, eof, _truncated = self._tail.read(
            start_line=start_offset,
            max_lines=max_messages,
            count_line=lambda s: bool(s.strip()),
        )
        # a consumer's offset never regresses: a start past EOF (or a file
        # rewritten shorter) reports no progress, not a rewind
        next_offset = max(next_offset, start_offset)
        msgs: List[StreamMessage] = []
        for i, text in lines:
            text = text.strip()
            if text:
                msgs.append(StreamMessage(value=json.loads(text), offset=i))
        return MessageBatch(messages=msgs, next_offset=next_offset, end_of_partition=eof)

    def latest_offset(self) -> int:
        if not os.path.exists(self.path):
            return 0
        with open(self.path, "r", encoding="utf-8") as f:
            return sum(1 for _ in f)


# consumer-factory registry (StreamConsumerFactoryProvider analog)
_FACTORIES: Dict[str, Any] = {}


def register_stream_factory(stream_type: str, factory) -> None:
    _FACTORIES[stream_type] = factory


def make_consumer(cfg: StreamConfig, partition: int, stream: Optional[InMemoryStream] = None) -> PartitionGroupConsumer:
    """StreamConsumerFactory.createPartitionGroupConsumer analog."""
    if cfg.stream_type == "memory":
        if stream is None:
            raise ValueError("memory stream requires the InMemoryStream instance (topic object)")
        return stream.consumer(partition)
    if cfg.stream_type == "file":
        path = cfg.properties.get("path") or cfg.topic
        return FileStream(path)
    if cfg.stream_type in _FACTORIES:
        return _FACTORIES[cfg.stream_type](cfg, partition)
    raise ValueError(f"unknown stream type {cfg.stream_type!r} (register via register_stream_factory)")
