"""``device.idle_pct.batch``: the share of the profiled stretch in which
nothing ran on the device: 1 - (union of the device's activity intervals
over the stretch's span), from ``torch.profiler``'s CUDA activity."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.n_device_events == 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
