"""Device: the share of the traced window in which no kernel, copy or memset
ran on the card (torch.profiler)."""


def read(record):
    dev = record["device"]
    if not dev or dev["window_us"] <= 0 or dev["busy_us"] <= 0:
        return None
    return 100.0 * (1.0 - dev["busy_us"] / dev["window_us"])
