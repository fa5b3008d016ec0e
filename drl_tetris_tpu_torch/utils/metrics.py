"""Host-side reading of device stats and device profiles.

Counterpart of the parts of ``drl_tetris_tpu/utils/metrics.py`` that the
trainer uses (``fetch_stats``), plus the profile arithmetic that
``chip_smoke.py`` and ``tools/torch_profile_selfplay.py`` share.
"""
from __future__ import annotations

import time

import torch


def fetch_stats(stats) -> dict:
    """Device stats dict -> host float dict in one device-to-host transfer:
    the scalars are stacked on their device, then read with ``tolist``."""
    names = list(stats)
    if not names:
        return {}
    packed = torch.stack([torch.as_tensor(stats[k]).detach().to(
        torch.float32).reshape(()) for k in names])
    return dict(zip(names, packed.tolist()))


def busy_share(events, wall_us: float) -> float:
    """Union of the device kernels' [start, end) intervals (profiler events,
    us) over the wall window."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy / wall_us


def device_kernels(prof):
    """The CUDA kernel events of a finished ``torch.profiler.profile``
    (without user annotations such as ``Optimizer.step#Adam.step``, which
    the profiler also places on the device's timeline)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation]


def profile_update_steps(trainer, n_minibatches: int = 2):
    """Profile ``trainer.update`` on the card over n_minibatches x epochs
    minibatch steps, on a batch cut from a one-tick rollout of the
    trainer's games, after one unprofiled call of the same shape.  The
    steps train the trainer's net.  Returns (profile, wall_s, steps)."""
    from torch.profiler import ProfilerActivity, profile

    from drl_tetris_tpu_torch.algos.ppo import Batch, segment_to_batch
    from drl_tetris_tpu_torch.algos.rollout import make_rollout_fn
    from drl_tetris_tpu_torch.engine import rng

    ppo = trainer.cfg.ppo
    _, seg, last = make_rollout_fn(trainer.env, trainer.net, 1)(
        trainer.env_state, trainer.generator)
    batch, _ = segment_to_batch(ppo, seg, last)
    n = n_minibatches * ppo.minibatch_size
    if batch.piece.shape[0] < n:
        raise ValueError(f"one tick of {trainer.cfg.n_envs} games holds "
                         f"fewer than {n} samples")
    batch = Batch(*[a[:n] for a in batch])
    key = rng.prng_key(0, trainer.device)
    trainer.update(trainer.state, batch, key)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.update(trainer.state, batch, key)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    return prof, wall_s, n_minibatches * ppo.n_train_epochs
