"""``hash_partition_pack``'s share of its memory roofline over the traced window."""

from portbench.roofline import share


def read(record):
    return share(record, ["hash_partition_pack"])
