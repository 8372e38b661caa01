"""Queries answered by ``FilterService.probe`` (each against every filter
of the bank) over every call of the window, over the window's seconds
(host clock)."""


def read(run):
    if run.kind != "filter_bank" or run.window_s <= 0:
        return None
    return run.keys / run.window_s
