"""Executor rounds with the data plane inside them, per warm query of the
window: the sum of the executor's per-round wall times (``round_us``)."""


def read(record):
    warm = record["warm"]
    if not warm:
        return None
    return sum(s["rounds_us"] for s in warm) / len(warm) / 1e3
