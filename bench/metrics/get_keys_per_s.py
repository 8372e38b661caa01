"""Keys answered by ``LsmStore.get_batch`` over every call of the window,
over the window's seconds (host clock)."""


def read(run):
    if run.kind != "lsm_store" or run.window_s <= 0:
        return None
    return run.keys / run.window_s
