"""Service layer, cold: the host clock around the first submit of each
distinct query of the mix (plan compile, count-then-emit sizing, caps
learned), in a session that has already answered one small query of another
shape; the mean over the mix's distinct queries.  Set-up holds these
submits, so they move ``setup_s``."""


def read(record):
    cold = record["cold"]
    if not cold:
        return None
    return sum(s["wall_s"] for s in cold) / len(cold)
