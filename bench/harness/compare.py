"""What decides ``correct``: the program's answers to the sampled keys of
the window against the reference's, field by field.

Every number compared is a count of sampled keys on which one field of the
program's answer differs from the reference's; each is an exact comparison
with the limit 0. ``missing`` counts the keys of the sample the traffic mix
asks for that were not compared (a lost answer is a wrong one). A bank is
also held to the guarantees its configuration states, from set membership
alone and so apart from the reference's builders: ``false_neg`` counts the
(filter, sampled key) pairs where a key the filter was built to hold reads
as no member, ``neg_admitted`` those where an exact filter (the exact
Bloomier, ChainedFilterAnd, the cascade) admits a negative it was built to
reject.
"""
from __future__ import annotations

import numpy as np

LIMITS = {"missing": 0, "found_diff": 0, "value_diff": 0, "reads_diff": 0,
          "member_diff": 0, "probes_diff": 0, "false_neg": 0,
          "neg_admitted": 0}
EXACT = ("exact", "chained_and", "cascade")


class Reservoir:
    """A uniform sample, drawn from the seed, of ``k`` of the window's
    calls: (call index, keys, the program's answers)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.kept = k, rng, []

    def offer(self, j: int, keys, answers) -> None:
        if len(self.kept) < self.k:
            self.kept.append((j, keys, answers))
            return
        r = int(self.rng.integers(0, j + 1))
        if r < self.k:
            self.kept[r] = (j, keys, answers)


def sample(kept: list, rows: int, rng: np.random.Generator
           ) -> tuple[np.ndarray, list]:
    """Up to ``rows`` keys spread over the kept calls, each call's rows drawn
    without replacement -> (keys, [(call answers, rows)])."""
    kept = sorted(kept, key=lambda t: t[0])
    per = -(-rows // max(1, len(kept)))
    keys, picks = [], []
    for _, batch, answers in kept:
        n = len(batch)
        idx = (np.arange(n) if per >= n
               else np.sort(rng.choice(n, per, replace=False)))
        keys.append(np.asarray(batch)[idx])
        picks.append((answers, idx))
    return (np.concatenate(keys) if keys else np.empty(0, np.uint64)), picks


def store_answers(picks: list) -> dict:
    found = np.concatenate([a[0][i] for a, i in picks])
    values = np.concatenate([a[1][i] for a, i in picks])
    reads = np.concatenate([a[2][i] for a, i in picks])
    return {"found": found.astype(bool), "values": values.astype(np.uint64),
            "reads": reads.astype(np.int64)}


def bank_answers(picks: list, names: list) -> dict:
    member = np.concatenate([a[0][:, i] for a, i in picks], axis=1)
    probes = np.concatenate([a[1][:, i] for a, i in picks], axis=1)
    return {name: {"member": member[f].astype(bool),
                   "probes": probes[f].astype(np.int64)}
            for f, name in enumerate(names)}


def store_diffs(prog: dict, ref: dict) -> dict:
    return {"found_diff": int((prog["found"] != ref["found"]).sum()),
            "value_diff": int((prog["values"] != ref["values"]).sum()),
            "reads_diff": int((prog["reads"] != ref["reads"]).sum())}


def bank_diffs(prog: dict, ref: dict) -> dict:
    member = probes = 0
    for name, p in prog.items():
        member += int((p["member"] != ref[name]["member"]).sum())
        probes += int((p["probes"] != ref[name]["probes"]).sum())
    return {"member_diff": member, "probes_diff": probes}


def bank_truth(cfg: dict, data: dict, keys: np.ndarray) -> dict:
    """For each filter of the bank: (which sampled keys it was built to
    hold, which it was built to reject), from the key sets themselves."""
    pos, neg = data["pos"], data["neg"]
    in_pos, in_neg = np.isin(keys, pos), np.isin(keys, neg)
    out = {}
    for spec in cfg["filters"]:
        if spec["type"] == "exact":
            held = np.isin(keys, pos[:int(spec["positives"])])
            rejected = np.isin(keys, neg[:int(spec["negatives"])])
        else:
            held, rejected = in_pos, in_neg
        out[spec["type"]] = (held, rejected if spec["type"] in EXACT
                             else np.zeros(len(keys), dtype=bool))
    return out


def bank_guarantees(answers: dict, truth: dict) -> dict:
    false_neg = admitted = 0
    for name, (held, rejected) in truth.items():
        member = answers[name]["member"]
        false_neg += int((held & ~member).sum())
        admitted += int((rejected & member).sum())
    return {"false_neg": false_neg, "neg_admitted": admitted}


def checks(diffs: dict, compared: int, wanted: int) -> dict:
    out = {"missing": {"value": max(0, wanted - compared), "limit": 0}}
    out.update({k: {"value": v, "limit": LIMITS[k]} for k, v in diffs.items()})
    return out


def correct(checked: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checked.values())
