"""The pluggable agent and trainer contract (the template agent).

Counterpart of ``drl_tetris_tpu/agents_api.py`` (reference:
agents/template_agent/*, template_agent.py:23-50): the skeleton every agent
family implements.  In the reference it is a pair of classes holding
mutable buffers and a TF session; in the JAX package, functions over
params pytrees.  Here the weights live in ``nn.Module``s and the data in
tensors, and every built-in family satisfies these protocols:

  worker side (sventon_agent.py:56-169):
    policy_fn(env_state, generator=None, gumbel=None, key=None, hp=None)
        -> action fields and recorded internals
        (algos/rollout.py make_policy_fn; algos/sixten.py
        make_sixten_policy, algos/sherlock.py make_sherlock_policy)
    rollout(env_state, ...) -> (env_state', segment, bootstrap value)
        (make_rollout_fn, algos/dual.py make_dual_rollout_fn,
        make_sixten_rollout, make_sherlock_rollout)
    process(segment, bootstrap) -> training batch
        (algos/ppo.py segment_to_batch, split_dual_segment,
        sherlock_segment_to_batch; the replay flavours' trainers take the
        segment itself)

  trainer side (sventon_agent_trainer_base.py:48-101):
    init_fn(net) -> learner state (the net, torch.optim.Adam, ...)
    update_fn(state, batch_or_replay, key, ...) -> (state', stats)
        (make_ppo_update, algos/dqn.py make_dqn_update, make_sixten_update,
        make_sherlock_update)
    weight export and import: the net's ``state_dict`` (runtime/checkpoint.py
    ``state.pt``; numpy over the store, runtime/runner.py)

To add an agent family: provide these five callables and a preset naming
them; the standalone trainers, the process runners, the data-parallel
trainer and the tournaments use only this interface.
"""
from __future__ import annotations

from typing import Any, Protocol, Tuple

import torch
from torch import nn


class PolicyFn(Protocol):
    def __call__(self, env_state: Any, *args: Any, **kwargs: Any
                 ) -> Tuple: ...


class RolloutFn(Protocol):
    def __call__(self, env_state: Any, *args: Any, **kwargs: Any
                 ) -> Tuple[Any, Any, torch.Tensor]: ...


class ProcessFn(Protocol):
    def __call__(self, segment: Any, bootstrap: torch.Tensor) -> Any: ...


class InitFn(Protocol):
    def __call__(self, net: nn.Module) -> Any: ...


class UpdateFn(Protocol):
    def __call__(self, state: Any, data: Any, key: torch.Tensor, *args: Any
                 ) -> Tuple[Any, ...]: ...
