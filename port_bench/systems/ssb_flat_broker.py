"""The flat SSB table served as Pinot serves an offline table: segments
built in worker processes with the program's build_segment, held by one
ServerInstance on the card under a Coordinator, queried through a Broker.

Each worker makes its parts of the fact table from the seed (one part is
one segment) and sends the built segment's parts home in memory; the
serving process assembles each ImmutableSegment from them (a segment holds
a lock, so it is not sent whole)."""
from __future__ import annotations

import time
from typing import Dict

from port_bench.harness import pool, schema, shipping, ssbgen


def build_part(task):
    """One segment, in a worker: (its constructor's arguments, the seconds
    to make the rows and to build it)."""
    seed, cfg, part = task
    from pinot_tpu_torch.segment.builder import build_segment

    t0 = time.perf_counter()
    d = ssbgen.dims(seed, cfg["scale_factor"])
    f = ssbgen.fact_part(seed, cfg["scale_factor"], part, cfg["orders_per_part"])
    more = ssbgen.fact_more(seed, part, cfg["orders_per_part"], f)
    cols = ssbgen.flat_columns(d, ssbgen.texts(seed, cfg["scale_factor"], d), f, more,
                               schema.column_names(cfg["columns"]))
    del f, more
    t1 = time.perf_counter()
    sch, tcfg = schema.table(cfg["table"], cfg["columns"])
    seg = build_segment(sch, cols, f"{cfg['table']}_{part}", table_config=tcfg)
    args = dict(name=seg.name, table_name=seg.table_name, schema=seg.schema, columns=seg.columns,
                num_docs=seg.num_docs, indexes=seg.indexes, creation_time_ms=seg.creation_time_ms,
                time_range=seg.time_range)
    return shipping.pack(args), t1 - t0, time.perf_counter() - t1


class System:
    """setup: build and load; query(sql) -> ResultTable; close().  device:
    the program's default (the card) unless the tests pass "cpu"."""

    def __init__(self, cfg: dict, seed: int, log, device=None):
        t0 = time.perf_counter()
        built = pool.run(build_part, [(seed, cfg, i) for i in range(cfg["parts"])])
        t1 = time.perf_counter()
        from pinot_tpu_torch.cluster.broker import Broker
        from pinot_tpu_torch.cluster.coordinator import Coordinator
        from pinot_tpu_torch.cluster.server import ServerInstance
        from pinot_tpu_torch.segment.segment import ImmutableSegment

        sch, tcfg = schema.table(cfg["table"], cfg["columns"])
        self.coordinator = Coordinator(replication=cfg["replication"])
        self.servers = [ServerInstance(f"server_{i}", device=device) for i in range(cfg["servers"])]
        for s in self.servers:
            self.coordinator.register_server(s)
        self.coordinator.add_table(sch, tcfg)
        rows = 0
        self._shared: list = []  # the segments' shared-memory mappings
        for args, _g, _b in built:
            seg = ImmutableSegment(**shipping.unpack(args, self._shared))
            rows += seg.num_docs
            self.coordinator.add_segment(cfg["table"], seg)
        self.broker = Broker(self.coordinator)
        self.rows = rows
        log("setup_build", workers=pool.workers(), parts=cfg["parts"], rows=rows, build_wall_s=t1 - t0,
            load_s=time.perf_counter() - t1, part_gen_s=max(g for _a, g, _b in built),
            part_build_s=max(b for _a, _g, b in built))
        del built

    def query(self, sql: str):
        return self.broker.query(sql)

    def residency(self) -> Dict:
        return {s.name: s.residency.snapshot() for s in self.servers if getattr(s, "residency", None)}

    def close(self) -> None:
        """Drop every reference to the program's state (the caller then
        collects it and empties the device cache)."""
        self.broker = self.coordinator = self.servers = self._shared = None
