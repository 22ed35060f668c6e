"""Service and statistics layer, per warm query of the window: the submit's
time outside the executor (the statistics pass, the plan-cache lookup and the
rebind), from the program's own ``SessionResult`` timings (host clock)."""


def read(record):
    warm = record["warm"]
    if not warm:
        return None
    return sum(s["total_us"] - s["execute_us"] for s in warm) / len(warm) / 1e3
