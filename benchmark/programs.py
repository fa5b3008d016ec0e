"""What the entries share on the program's side: the configuration a file
states, resolved through the port's own presets, and held to the file."""
from __future__ import annotations

import dataclasses


def _plain(x):
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _differences(want, got, path=""):
    if isinstance(want, dict):
        return [d for k, v in want.items()
                for d in _differences(v, (got or {}).get(k), f"{path}.{k}")]
    return [] if want == got else [f"{path[1:]}: file {want!r}, "
                                   f"program {got!r}"]


def framework(config: dict):
    """The port's FrameworkConfig of the file's presets and ``set``
    overrides; raises where it differs from the file's env, model or ppo
    values or its learning-rate schedule."""
    from drl_tetris_tpu_torch.config import presets
    fw = presets.load(tuple(config["presets"]), dict(config["set"]))
    got = {"env": _plain(fw.env), "model": _plain(fw.model),
           "ppo": _plain(fw.ppo),
           "value_lr": _plain(fw.settings.get("value_lr")),
           "train_distribution": fw.train_distribution}
    diff = [d for k in got if k in config
            for d in _differences(config[k], got[k], "." + k)]
    if diff:
        raise ValueError("the presets resolve to another configuration than "
                         "the file states: " + "; ".join(diff))
    return fw
