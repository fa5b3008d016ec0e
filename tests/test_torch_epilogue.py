"""The residual layers' epilogue (models/epilogue.py) on the CPU:

* its plain version, the path CPU tensors take, equals the eager chain the
  blocks ran before the kernel existed (``x + bias`` -> ``peephole_join``
  -> activation, written out below as it stood) bit for bit, on random
  bfloat16 inputs in NCHW and channels-last, for every join (conv side
  larger, input side larger, equal, ``truncate_add`` both ways, no
  peephole) and activation;
* ``ResidualBlock`` on the CPU, with autograd recording or not, runs that
  chain unchanged: its outputs equal the earlier forward's, and the kernel
  counts no launch;
* the NHWC path's plumbing (channels-last rows padded to a multiple of 8
  channels, kernels padded to match, the epilogue between convs), run on
  the CPU through the plain version with its output padded as the kernel
  pads it: every epilogue call gets channels-last inputs, a full 'silver'
  forward makes 31 of them and a worker-side one 25, SIXten's VNet 26 and
  Sherlock's net 36, and the outputs equal the NCHW path's bit for bit;
  an input whose dtype is not the block's raises there, where the NCHW
  path would join it in the promoted dtype.

The kernel itself runs on the card (tests/test_torch_cuda.py,
``chip_smoke.py``).
"""
import torch  # noqa: I001  (first: see test_torch_harness)

from tests.test_torch_harness import rekey_jax_cache

rekey_jax_cache()

import pytest  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from drl_tetris_tpu_torch.algos import sherlock, sixten  # noqa: E402
from drl_tetris_tpu_torch.models import checks  # noqa: E402
from drl_tetris_tpu_torch.models import epilogue as E  # noqa: E402
from drl_tetris_tpu_torch.models import nets  # noqa: E402
from drl_tetris_tpu_torch.models.convert import seeded_state_dict  # noqa: E402

CL = torch.channels_last


def old_peephole_join(x, y, mode, dim):
    nx, ny = x.shape[dim], y.shape[dim]
    larger, smaller = (x, y) if nx > ny else (y, x)
    n = smaller.shape[dim]
    a = larger.narrow(dim, 0, n) + smaller
    if mode == "truncate_add":
        return a
    return torch.cat([a, larger.narrow(dim, n, larger.shape[dim] - n)],
                     dim=dim)


def old_chain(c, bias, y, mode, act):
    x = c + bias.to(c.dtype)[None, :, None, None]
    if y is not None:
        x = old_peephole_join(x, y, mode, dim=1)
    if act == "elu":
        x = F.elu(x)
    elif act == "tanh":
        x = torch.tanh(x)
    return x


JOINS = {
    # name: (c_in, n, mode)
    "conv_larger": (5, 12, "add"),
    "input_larger": (20, 12, "add"),
    "equal": (12, 12, "add"),
    "truncate_input_larger": (20, 8, "truncate_add"),
    "truncate_conv_larger": (6, 12, "truncate_add"),
    "no_peephole": (0, 12, "add"),
}


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("act", ["elu", "tanh", None])
@pytest.mark.parametrize("join", sorted(JOINS))
def test_plain_epilogue_is_the_eager_chain(join, act, layout):
    cin, n, mode = JOINS[join]
    layer = checks.Layer(cin, n, mode, act, hw=(7, 5))
    c, bias, y = checks.layer_inputs(layer, 3, "cpu", seed=len(join))
    if layout == "nchw":
        c = c.contiguous()
        y = None if y is None else y.contiguous()
    before = E.LAUNCHES["epilogue"]
    got = E.epilogue(c, bias, y, mode, act)
    want = old_chain(c, bias, y, mode, act)
    assert E.LAUNCHES["epilogue"] == before
    assert got.dtype == torch.bfloat16
    out = n if y is None else E.join_channels(n, cin, mode)
    assert got.shape == (3, out, 7, 5)
    assert checks.bits_equal(got, want)
    assert (got < 0).any() and (got > 0).any()


def old_block_forward(block, x):
    """ResidualBlock.forward as it stood before the NHWC path."""
    dt = block.dtype
    last = len(block.convs) - 1
    for i, conv in enumerate(block.convs):
        y = x
        x = F.conv2d(x.to(dt), conv.weight.to(dt), None, 1, conv.padding)
        x = x + conv.bias.to(dt)[None, :, None, None]
        if block.peepholes:
            x = old_peephole_join(x, y, block.modes[i], dim=1)
        if i == last and block.norm is not None:
            x = block.norm(x.float().permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if block.acts[i] == "elu":
            x = F.elu(x)
        elif block.acts[i] == "tanh":
            x = torch.tanh(x)
        if block.pools:
            h, w = x.shape[2:]
            ph, pw = min(block.pool_size[0], h), min(block.pool_size[1], w)
            x = F.avg_pool2d(x, (ph, pw), stride=(ph, pw))
    return x


BLOCKS = {
    "tower": dict(in_channels=1, n_layers=3, n_filters=8),
    "value": dict(in_channels=14, n_layers=4, n_filters=12,
                  filter_size=(5, 5), pools=True, output_n_filters=3,
                  output_activation=None, output_layer=True,
                  normalization="layer"),
    "normalized_tanh": dict(in_channels=10, n_layers=2, n_filters=6,
                            output_n_filters=4, output_activation="tanh",
                            normalization="layer"),
    "no_peepholes_f32": dict(in_channels=3, n_layers=2, n_filters=5,
                             peepholes=False),
}


@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_block_on_cpu_runs_the_eager_chain(kind, grad):
    kw = dict(BLOCKS[kind])
    dtype = torch.float32 if kind.endswith("f32") else torch.bfloat16
    block = nets.ResidualBlock(dtype=dtype, **kw)
    g = torch.Generator().manual_seed(3)
    for p in block.parameters():
        p.data = 0.3 * torch.randn(p.shape, generator=g)
    x = torch.randn(4, kw["in_channels"], 12, 9, generator=g).to(dtype)
    before = E.LAUNCHES["epilogue"]
    with torch.set_grad_enabled(grad):
        got = block(x)
        want = old_block_forward(block, x)
    assert E.LAUNCHES["epilogue"] == before
    assert got.requires_grad == grad
    assert got.stride() == want.stride()
    assert checks.bits_equal(got.detach(), want.detach())


@pytest.fixture
def nhwc_on_cpu(monkeypatch):
    """The NHWC path taken on the CPU (no grad), every epilogue call
    checked for channels-last inputs and counted."""
    calls = []

    def counted(c, bias, y, mode, act, cin=None):
        assert c.is_contiguous(memory_format=CL)
        assert y is None or y.is_contiguous(memory_format=CL)
        calls.append(c.shape[1])
        return checks.pad_rows(E.epilogue(c, bias, y, mode, act, cin))

    def path(x):
        return not torch.is_grad_enabled()
    monkeypatch.setattr(nets, "nhwc_path", path)
    monkeypatch.setattr(nets, "epilogue", counted)
    return calls


SILVER = dict(tower_filters=8, val_filters=8)        # the layers of 'silver'


@pytest.mark.parametrize("net_kind", ["ppo", "ppo_worker", "vnet",
                                      "sherlock"])
def test_nhwc_path_plumbing_on_cpu(nhwc_on_cpu, net_kind):
    cfg = nets.ModelConfig(**SILVER)
    full = net_kind != "ppo_worker"
    cls = {"vnet": sixten.VNet, "sherlock": sherlock.SherlockNet}.get(
        net_kind, nets.PPONet)
    net = cls(cfg, full_network=full, device="cpu")
    net.load_state_dict(seeded_state_dict(net, 5))
    vec, vis = checks.board_inputs(6, 2, "cpu")
    with torch.no_grad():
        fast = net(vec, vis)
    n_calls = len(nhwc_on_cpu)
    with torch.enable_grad():
        slow = [t.detach() for t in net(vec, vis)]
    assert len(nhwc_on_cpu) == n_calls
    assert n_calls == {"ppo": 31, "ppo_worker": 25, "vnet": 26,
                       "sherlock": 36}[net_kind]
    for a, b in zip(fast, slow):
        assert checks.bits_equal(a, b)


@pytest.mark.parametrize("block_dtype,input_dtype", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)])
def test_nhwc_path_refuses_another_dtype(nhwc_on_cpu, block_dtype,
                                         input_dtype):
    block = nets.ResidualBlock(dtype=block_dtype, **BLOCKS["tower"])
    g = torch.Generator().manual_seed(4)
    for p in block.parameters():
        p.data = 0.3 * torch.randn(p.shape, generator=g)
    x = torch.randn(4, 1, 12, 9, generator=g)
    with torch.no_grad():
        with pytest.raises(ValueError, match="NHWC path"):
            block(x.to(input_dtype))
        assert nhwc_on_cpu == []
        got = block(x.to(block_dtype))
    assert nhwc_on_cpu == [8, 8, 8]
    with torch.enable_grad():
        want = block(x.to(block_dtype)).detach()
    # float32 CPU convs on padded channels-last rows and on NCHW rows
    # need not sum in one order
    torch.testing.assert_close(got, want)
