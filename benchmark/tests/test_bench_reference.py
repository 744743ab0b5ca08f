"""The plain reference against the port, in float32 at a tiny size on the
CPU, on the same weights (made by the benchmark from a seed) and inputs."""

import copy

import numpy as np
import pytest
import torch

from benchmark import run as RUN
from benchmark.reference import chain as C
from benchmark.reference import diffusion as D
from benchmark.reference import model as M

from . import tiny

FOUR_VARS = dict(tiny.MODEL, dataset="pendulum", in_channels=4, rep_dim=16, n_vars=4,
                 class_cond=False, image_size=96, num_channels=32)
PENDULUM_GRAPH = [[0.0, 0.0, 1.0, 1.0], [0.0, 0.0, 1.0, 1.0], [0.0] * 4, [0.0] * 4]


def _port(m, preset):
    from causaldiffae_torch.config import create_model, get_config

    cfg = get_config(preset).replace(**dict(m, use_bf16=False))
    model = create_model(cfg, device="cpu")
    P = {**M.make_weights(m, 7, "cpu"), **M.buffers(m, "cpu")}
    model.load_state_dict(P, strict=True)
    return cfg, model, P


@pytest.mark.parametrize("m, preset, graph", [
    (tiny.CONFIGS["tiny_morpho"]["model"], "morphomnist_causaldae", [[0.0, 1.0], [0.0, 0.0]]),
    (FOUR_VARS, "pendulum_causaldae", PENDULUM_GRAPH),
])
def test_forward_matches_the_port(m, preset, graph):
    """Encoder, SCM and UNet of the reference against the port's, fp32."""
    cfg, model, P = _port(m, preset)
    g = torch.Generator().manual_seed(3)
    s = m["image_size"]
    x = torch.rand((2, s, s, m["in_channels"]), generator=g) * 2 - 1
    t = torch.tensor([5, 900])
    y = torch.tensor([1, 7]) if m["class_cond"] else None
    with torch.no_grad():
        mu, var = model.encode(x)
        z = model.causalize(mu)
        eps = model.denoise(x, t, y=y, z=z)
        mu_r, var_r = M.encode(P, m, x, train=False)
        z_r = M.causalize(P, m, mu_r, graph)
        eps_r = M.unet(P, m, x, t, y=y, z=z_r)
    for a, b in ((mu, mu_r), (var, var_r), (z, z_r), (eps, eps_r)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_schedule_respacing_and_dpm_nodes_match_the_port():
    from causaldiffae_torch.config import create_diffusion, get_config
    from causaldiffae_torch.diffusion.sampling import dpm_solver_pp_nodes

    diff = create_diffusion(get_config("morphomnist_causaldae"), eval_mode=True)
    ref = D.Process(1000, "cpu", 250)
    assert np.array_equal(diff.timestep_map, ref.model_map)
    np.testing.assert_array_equal(diff.schedule.sqrt_alphas_cumprod, ref.sqrt_acp.numpy())
    desc, sratio, a_next, phi, c2 = dpm_solver_pp_nodes(diff, 2, 25)
    nodes = ref.dpm_nodes(25)
    assert np.array_equal(desc, nodes["t"])
    for a, k in ((sratio, "sratio"), (a_next, "a_next"), (phi, "phi"), (c2, "c2")):
        np.testing.assert_array_equal(a, nodes[k])


@pytest.fixture(scope="module")
def fp32_root(tmp_path_factory):
    saved = copy.deepcopy(tiny.CONFIGS)
    tiny.CONFIGS["tiny_morpho"]["model"]["use_bf16"] = False
    try:
        return tiny.make_root(tmp_path_factory.mktemp("fp32"))
    finally:
        tiny.CONFIGS.clear()
        tiny.CONFIGS.update(saved)


@pytest.mark.parametrize("cell, bounds", [
    (tiny.TRAIN, {"loss_gap": 1e-5, "grad_gap": 1e-4, "grad_gap_median": 1e-4, "update_gap": 1e-3,
                  "ema_gap": 0.02}),
    (tiny.SERVE, {"step_gap": 1e-4}),
])
def test_whole_cell_in_fp32_agrees_with_the_reference(fp32_root, cell, bounds):
    """The port run by the harness in fp32 stands within float32 rounding of
    the reference: the train step's losses, first gradient and changes
    (the EMA's change, ~1e-4 of the parameters', is where fp32 rounds it),
    and each chain step of the checked requests."""
    res = RUN.run_cell(cell, 2 ** 33 + 7, 1.0, False, "cpu", root=fp32_root)
    for name, bound in bounds.items():
        assert res["checks"][name]["value"] < bound, (name, res["checks"])


def test_chain_run_is_what_check_compares():
    """The reference's own chain passes its own check with zero gaps."""
    m = tiny.CONFIGS["tiny_morpho"]["model"]
    graph = tiny.CONFIGS["tiny_morpho"]["adjacency"]
    P = {**M.make_weights(m, 1, "cpu"), **M.buffers(m, "cpu")}
    ch = C.Chain(m, 250, 4, 249, "cpu")
    g = torch.Generator().manual_seed(0)
    req = {"x": torch.rand((2, 28, 28, 1), generator=g) * 2 - 1, "y": torch.tensor([3, 4]),
           "var": 1, "value": 0.5, "rep_noise": torch.randn((2, 16), generator=g),
           "abduction_noise": torch.randn((2, 28, 28, 1), generator=g)}
    with torch.no_grad():
        got = ch.run(P, m, graph, req)
    assert C.check(ch, P, m, graph, req, got) == {"step_gap": 0.0}
