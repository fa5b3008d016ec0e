"""The device's idle share of the traced unit, in percent: 1 - the union
of the device's operation intervals over the traced window."""


def read(run):
    t = run["trace"]
    if t is None or run["ctx"].device.type != "cuda":
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
