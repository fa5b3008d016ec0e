"""The worker's rollout per tick: CUDA events around each segment's
rollout call (the benchmark's own, entries/worker_ppo.py), over the
window's segments and their ticks."""


def read(run):
    if run["ctx"].device.type != "cuda":
        return None
    ms = sum(u["rollout_ms"] for u in run["units"])
    return ms / sum(u["ticks"] for u in run["units"])
