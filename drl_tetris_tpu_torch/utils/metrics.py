"""Metrics and telemetry: stats from the device, scalar logs, wall-time
tables, and device profiles.

Counterpart of ``drl_tetris_tpu/utils/metrics.py`` (reference:
drl_tetris/utils/tb_writer.py, timekeeper.py, logging.py):

  fetch_stats    device stats -> host floats in one transfer
  MetricsWriter  scalars to JSONL (always) + TensorBoard when
                 ``torch.utils.tensorboard`` imports
  timekeeper     wall time per tagged function or section, as a table
  logstamp       entry/exit/changed-return logging decorator

plus the profile arithmetic that ``chip_smoke.py`` and
``tools/torch_profile_selfplay.py`` share.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

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


class MetricsWriter:
    """Scalars to ``<directory>/<name>.jsonl``, and to TensorBoard under
    ``<directory>/tb/<name>`` when ``torch.utils.tensorboard`` imports."""

    def __init__(self, directory: str, name: str = "train"):
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, f"{name}.jsonl")
        self._f = open(self._path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(os.path.join(directory, "tb", name))
        except Exception:
            pass

    def update(self, scalars: Dict[str, float], step: int):
        """tb_writer.update(dict, time) (tb_writer.py:14-18)."""
        rec = {"step": step, "time": time.time(), **{
            k: float(v) for k, v in scalars.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Timekeeper:
    """drl_tetris/utils/timekeeper.py:11-47: accumulate wall time per tagged
    function into a shared stats dict; flush as a timing table.  Host
    time: a section that launches device work and does not wait for it
    counts only the launches."""
    stats: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)

    @classmethod
    def timed(cls, name: Optional[str] = None):
        def deco(fn):
            tag = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    cls.stats[tag] += time.perf_counter() - t0
                    cls.counts[tag] += 1
            return wrapper
        return deco

    @classmethod
    @contextlib.contextmanager
    def section(cls, tag: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            cls.stats[tag] += time.perf_counter() - t0
            cls.counts[tag] += 1

    @classmethod
    def table(cls) -> str:
        """The trainer's console timing table (trainer.py:160-174)."""
        total = sum(cls.stats.values()) or 1.0
        rows = [f"{'section':<40}{'total_s':>10}{'calls':>8}{'share':>8}"]
        for tag, t in sorted(cls.stats.items(), key=lambda kv: -kv[1]):
            rows.append(f"{tag:<40}{t:>10.2f}{cls.counts[tag]:>8}"
                        f"{t / total:>8.1%}")
        return "\n".join(rows)

    @classmethod
    def flush(cls) -> Dict[str, float]:
        out = dict(cls.stats)
        cls.stats.clear()
        cls.counts.clear()
        return out


timekeeper = Timekeeper


class logstamp:
    """Entry/exit/changed-return logging decorator
    (drl_tetris/utils/logging.py:7-25).  ``only_new`` logs the exit stamp
    only when the return value changed from the previous call (the
    reference's condition is inverted, logging.py:23; this follows its
    documented intent, as the JAX package does); ``on_entry``/``on_exit``
    force unconditional stamps."""

    def __init__(self, loggerfunc, name=None, only_new=True,
                 on_entry=False, on_exit=False):
        self.loggerfunc = loggerfunc
        self.on_entry = on_entry
        self.on_exit = on_exit
        self.only_new = only_new
        self.name = name
        self._last_ret = object()

    def __call__(self, func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            stamp = time.strftime("%Y-%m-%d %H:%M:%S")
            label = self.name or func.__name__
            if self.on_entry and not self.only_new:
                self.loggerfunc(f"{stamp} [o] {label}")
            ret = func(*args, **kwargs)
            if self.on_exit or self.only_new:
                changed = not (type(ret) is type(self._last_ret)
                               and ret == self._last_ret)
                if not self.only_new or changed:
                    self.loggerfunc(f"{stamp} [x] {label}")
                self._last_ret = ret
            return ret

        return wrapper


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
        trainer.env_state, trainer.key)
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
