"""The three join kernels together (hash_partition_pack, merge_join_counts,
merge_join_pairs): their bytes at the card's memory rate over their summed
device time in the traced window."""

from portbench.roofline import share


def read(record):
    return share(record, ["hash_partition_pack", "merge_join_counts", "merge_join_pairs"])
