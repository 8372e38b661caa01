"""Filter bits per stored record: the store's ``filter_bits`` (every
table's chained filter, stage 1 and stage 2) over the records."""


def read(run):
    if run.kind != "lsm_store":
        return None
    return run.program.filter_bits / int(run.spec.config["records"])
