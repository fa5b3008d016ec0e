"""One rank of the data-parallel PPO update, for tests/test_torch_mesh.py:
run in a process of its own (multiprocessing's spawn), it imports only
torch and the port.  Its inputs and outputs are pickles that the test
writes and reads."""
import pickle

import torch
import torch.distributed as dist


def update_rank(rank: int, world: int, init_method: str, inputs: str,
                out: str):
    from drl_tetris_tpu_torch.algos import ppo
    from drl_tetris_tpu_torch.engine.core import EngineConfig
    from drl_tetris_tpu_torch.models import nets

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init_method,
                            world_size=world, rank=rank)
    try:
        with open(inputs, "rb") as f:
            inp = pickle.load(f)
        net = nets.PPONet(nets.ModelConfig(compute_dtype="float32",
                                           **inp["model"]), device="cpu")
        net.load_params_(inp["params"])
        init_fn, update_fn = ppo.make_ppo_update(
            EngineConfig(), net, inp["cfg"], group=dist.group.WORLD)
        state = init_fn()
        first = {}

        def record(opt, args, kwargs):
            if not first:
                first.update({k: p.grad.clone()
                              for k, p in net.named_parameters()})
        state.optimizer.register_step_pre_hook(record)
        batch = ppo.Batch(*[torch.from_numpy(a)
                            for a in inp["batches"][rank]])
        state, stats = update_fn(state, batch,
                                 torch.from_numpy(inp["keys"][rank]))
        result = {
            "params": {k: p.detach().numpy().copy()
                       for k, p in net.named_parameters()},
            "first_grads": {k: g.numpy() for k, g in first.items()},
            "stats": {k: v.item() for k, v in stats.items()},
            "adv_comp": [x.item() for x in state.adv_comp],
            "vloss_comp": [x.item() for x in state.vloss_comp]}
        with open(out, "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()
