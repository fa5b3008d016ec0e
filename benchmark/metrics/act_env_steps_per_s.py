"""Env-steps of the window's whole units over the window's seconds (the
window closes at the end of the first unit that ends at or after
--seconds)."""


def read(run):
    return sum(u["env_steps"] for u in run["units"]) / run["window_s"]
