"""SSTable reads per key answered over the window: the store's own
``StoreStats.sstable_reads`` over ``StoreStats.gets`` (the sum of the
``sstable_reads`` that ``get_batch`` returns)."""


def read(run):
    c = run.counters
    if run.kind != "lsm_store" or not c.get("gets"):
        return None
    return c["sstable_reads"] / c["gets"]
