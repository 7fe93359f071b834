"""device_idle_share: the share of the traced slice in which no operation
ran on the device."""

from bench import readers


def read(run):
    sl = run.slice
    return None if sl.window_s <= 0 else readers.share(
        sl.window_s - sl.busy_s, sl.window_s)
