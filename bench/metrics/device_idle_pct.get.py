"""Share of the traced window of a store cell in which no kernel, copy or
fill ran on the card, in %."""
from bench.harness.trace import idle_pct


def read(run):
    return idle_pct(run, "lsm_store")
