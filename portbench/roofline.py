"""Shared arithmetic of the join kernels' roofline readers: the bytes the
traced window's calls must move at the card's memory rate, over the device
time torch.profiler gives those calls' kernels."""

from portbench.kernel_bytes import HBM_BYTES_PER_S


def share(record, ops):
    dev = record["device"]
    if not dev:
        return None
    need = sum(record["kernels"].get(op, {}).get("bytes", 0) for op in ops)
    spent = sum(dev["kernel_us"].get(op, 0.0) for op in ops)
    if need <= 0 or spent <= 0:
        return None
    return 100.0 * need / HBM_BYTES_PER_S / (spent * 1e-6)
