"""device_idle_pct (layer: device): the share of the window in which no
kernel, copy or memset ran on the device, from the profiler's trace: 100 x
(1 - the union of their intervals / the window)."""


def read(trace):
    if not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
