"""Seconds from process start to the first timed call: data drawn from the
seed, the deployment built, every shape of the window warmed up (the
reference is built only once the window has closed)."""


def read(run):
    return run.setup_s
