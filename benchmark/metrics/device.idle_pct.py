"""Share of the traced window in which no operation ran on the device: 100
x (1 - the union of the device's intervals / the window)."""


def read(run):
    tr = run["trace"]
    if tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / 1e9 / tr.window_s)
