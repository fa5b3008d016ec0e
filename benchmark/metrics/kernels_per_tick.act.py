"""Device kernels of the traced worker segment (the rollout, then ship's
GAE and host copy) over its ticks: the worker segment's layer, not the
acting loop's alone."""


def read(run):
    t = run["trace"]
    if t is None or run["ctx"].device.type != "cuda":
        return None
    return len(t["kernels"]) / t["unit"]["ticks"]
