"""The share of the traced window in which no device operation ran."""


def read(tw):
    if tw.window_s <= 0:
        return None
    return 100.0 * (1.0 - tw.busy_s / tw.window_s)
