"""Experiment scheduling: presets + patches -> a sequence of runs.

The port's copy of ``drl_tetris_tpu/config/schedule.py`` (reference:
tools/experiment_schedule.py:3-40): an experiment is a base settings
dict plus a list of patches applied CUMULATIVELY (the null patch first, so
the unpatched base runs too, :13); each yielded item is a fully resolved
FrameworkConfig.  Experiments here are data (a preset list + override
dicts), not exec'd Python files (experiment_schedule.py:22-31 — the
reference executes experiment files with ``exec``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional, Sequence

from drl_tetris_tpu_torch.config.presets import (FrameworkConfig,
                                                 merge_settings, resolve)


@dataclasses.dataclass(frozen=True)
class Experiment:
    name: str
    presets: Sequence[str] = ("default", "sventon", "sventon_ppo",
                              "resblock", "experiment_sventon_ppo")
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)
    patches: Sequence[Dict[str, Any]] = ()


def experiment_schedule(experiments: Sequence[Experiment],
                        only_last: bool = False,
                        overrides: Optional[Dict[str, Any]] = None
                        ) -> Iterator[FrameworkConfig]:
    """Yield one resolved config per (experiment, cumulative patch), with
    the null patch first (experiment_schedule.py:10-21); ``only_last`` and
    CLI ``overrides`` match trainer_runscript.py:19-23."""
    items: List[FrameworkConfig] = []
    for exp in experiments:
        cumulative: Dict[str, Any] = {}
        for i, patch in enumerate(({},) + tuple(exp.patches)):
            cumulative.update(patch)
            s = merge_settings(exp.presets, exp.overrides, cumulative,
                               overrides or {})
            run_id = exp.name if i == 0 else f"{exp.name}-patch{i}"
            items.append(resolve(s, run_id=run_id))
    if only_last and items:
        items = items[-1:]
    yield from items


# ---------------------------------------------------------------------------
# Named experiments (the CLI's `train --experiment NAME` registry) — the
# analog of the reference's experiment FILES (experiments/sventon_ppo.py etc.,
# exec'd by experiment_schedule.py:22-31 and looped by
# trainer_runscript.py:19-23).  Patches are applied cumulatively after the
# null patch; the reference ships its patch lists empty/commented, so these
# default to () and are overridden per sweep (see `lr_sweep` for the shape).
# ---------------------------------------------------------------------------

EXPERIMENTS: Dict[str, Experiment] = {
    "sventon_ppo": Experiment(
        name="sventon_ppo",
        presets=("default", "sventon", "sventon_ppo", "resblock",
                 "experiment_sventon_ppo")),
    "sventon_dqn": Experiment(
        name="sventon_dqn",
        presets=("default", "sventon", "sventon_dqn", "resblock",
                 "experiment_sventon_dqn")),
    "sixten": Experiment(
        name="sixten", presets=("default", "experiment_sixten")),
    "sherlock": Experiment(
        name="sherlock", presets=("default", "sherlock")),
    # demo sweep: null patch + two cumulative lr patches -> 3 runs
    "lr_sweep": Experiment(
        name="lr_sweep",
        presets=("default", "sventon", "sventon_ppo", "resblock",
                 "experiment_sventon_ppo"),
        patches=({"value_lr": 1e-4}, {"value_lr": 1e-5})),
}
