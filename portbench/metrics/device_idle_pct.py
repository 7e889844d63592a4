"""100 less the share of the traced window in which a device operation ran."""


def read(s: dict):
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
