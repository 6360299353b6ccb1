"""Realtime ingestion: stream SPI, mutable segments, consume/seal/swap.

Port of pinot_tpu/realtime/ (host-only modules; the queries over sealed
segments and consuming snapshots run through query/engine.py, whose dense
group-bys launch the CUDA fused scan with the validDocIds mask ANDed into
the row mask).

Reference parity map (SURVEY.md §3.3):
  stream.py   - pinot-spi/.../spi/stream/ (StreamConsumerFactory,
                PartitionGroupConsumer, MessageBatch, StreamPartitionMsgOffset)
  mutable.py  - pinot-segment-local/.../indexsegment/mutable/MutableSegmentImpl.java
  manager.py  - pinot-core/.../data/manager/realtime/RealtimeSegmentDataManager.java
                (consumeLoop :470, processStreamEvents :591, commitSegment :971)
                + RealtimeTableDataManager.java:97
"""
from pinot_tpu_torch.realtime.stream import (
    FileStream,
    InMemoryStream,
    MessageBatch,
    StreamMessage,
    make_consumer,
)
from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.realtime.manager import (
    RealtimeSegmentDataManager,
    RealtimeTableDataManager,
)

__all__ = [
    "FileStream",
    "InMemoryStream",
    "MessageBatch",
    "StreamMessage",
    "make_consumer",
    "MutableSegment",
    "RealtimeSegmentDataManager",
    "RealtimeTableDataManager",
]
