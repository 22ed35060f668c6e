"""Executor layer, per warm query of the window: host work outside the
scheduler's op rounds (residual dedup, row assembly, staging): the
executor's wall time less the sum of its round times (``SessionResult``)."""


def read(record):
    warm = record["warm"]
    if not warm:
        return None
    return sum(s["execute_us"] - s["rounds_us"] for s in warm) / len(warm) / 1e3
