"""Plain reference of the chained LSM store's point reads.

Built from the same key runs the store is flushed with, in the same order,
by the frozen builders in this package. For a key batch it gives what a
correct store answers, from the stored records themselves and the chain
rule over the rebuilt filters: ``found`` and ``values`` from the records,
``reads`` 1 where some table's filter fires (the chain rule reads only the
newest table that fires) and 0 elsewhere.

The control breaks the exactness the configuration states: it drops every
table's stage 2, so the newest table whose stage 1 fires is read, and a key
that lives in an older table reads as absent where a newer table's stage 1
fires falsely.
"""
from __future__ import annotations

import numpy as np

from .lsm import ChainedLevel, in_sorted


class StoreReference:
    def __init__(self, cfg: dict, keys: np.ndarray, values: np.ndarray):
        if cfg["filter_kind"] != "chained":
            raise ValueError("the store reference covers chained filters")
        per = int(cfg["records"]) // int(cfg["tables"])
        self.level = ChainedLevel(fp_alpha=int(cfg["fp_alpha"]))
        for i in range(int(cfg["tables"])):
            self.level.flush(keys[i * per:(i + 1) * per])
        order = np.argsort(keys)
        self.sorted_keys, self.sorted_vals = keys[order], values[order]

    def _records(self, keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        idx = np.minimum(np.searchsorted(self.sorted_keys, keys),
                         len(self.sorted_keys) - 1)
        found = self.sorted_keys[idx] == keys
        return found, np.where(found, self.sorted_vals[idx], np.uint64(0))

    def answer(self, keys: np.ndarray, control: bool = False) -> dict:
        keys = np.asarray(keys, dtype=np.uint64)
        stage1 = np.stack([f.f1.query(keys) for f in self.level.filters])
        if control:
            fires = stage1
        else:
            fires = stage1.copy()
            for t, f in enumerate(self.level.filters):
                sel = np.flatnonzero(stage1[t])
                fires[t, sel] = f.f2.query(keys[sel])
        reads = fires.any(axis=0).astype(np.int32)
        found, values = self._records(keys)
        if control:
            first = np.argmax(fires, axis=0)
            in_first = np.zeros(len(keys), dtype=bool)
            for t, own in enumerate(self.level.tables):
                sel = np.flatnonzero((first == t) & (reads == 1))
                in_first[sel] = in_sorted(own, keys[sel])
            found &= in_first
            values = np.where(found, values, np.uint64(0))
        return {"found": found, "values": values, "reads": reads,
                "stage1_passes": stage1.sum(axis=1).astype(np.int64)}

    def sizes(self) -> dict:
        """Bytes a probe of every table reads once, and each table's stage-1
        layout mode, for the roofline count."""
        tables = []
        for f in self.level.filters:
            oth = f.f2.oth
            tables.append({
                "mode": f.f1.tbl.layout.mode,
                "bytes": 4 * len(f.f1.tbl.table)
                + 4 * ((oth.ma + 31) // 32 + (oth.mb + 31) // 32)})
        return {"tables": tables}
