"""The share of one traced steady epoch (host range from its start to the end
of its device-to-host copy) in which no kernel or copy ran on the card: 100
less the union of the device intervals over the range."""


def read(ctx):
    if ctx.device.type != "cuda" or ctx.traced_window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.traced_window_s)
