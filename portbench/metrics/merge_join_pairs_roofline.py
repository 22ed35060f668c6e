"""``merge_join_pairs``'s share of its memory roofline over the traced window."""

from portbench.roofline import share


def read(record):
    return share(record, ["merge_join_pairs"])
