"""The FLOP and byte counts of ``benchmark/counts.py``."""

import json
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import counts
from benchmark.reference import model as M

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _model(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())["model"]


@pytest.mark.parametrize("name", ["pendulum_causaldae", "morphomnist_causaldae"])
def test_forward_flops_match_the_flop_counter(name):
    """counts.py against torch's FlopCounterMode over the reference's
    forward of one image on meta tensors. The counter counts the products
    (conv, mm, the attention's bmm) as counts.py does; neither counts the
    elementwise work, the norms or the softmax."""
    m = _model(name)
    P = {k: torch.empty(v, device="meta") for k, v in M.param_shapes(m).items()}
    P.update(M.buffers(m, "meta"))
    s = m["image_size"]
    x = torch.empty((1, s, s, m["in_channels"]), device="meta")
    t = torch.zeros(1, dtype=torch.long, device="meta")
    y = torch.zeros(1, dtype=torch.long, device="meta") if m["class_cond"] else None
    with FlopCounterMode(display=False) as fc:
        mu, _ = M.encode(P, m, x, train=False)
        z = M.causalize(P, m, mu, json.loads((CONFIGS / f"{name}.json").read_text())["adjacency"])
        M.unet(P, m, x, t, y=y, z=z)
    assert fc.get_total_flops() == counts.unet_forward_flops(m) + counts.encoder_flops(m)


@pytest.mark.parametrize("shape, fwd_us, bwd_us", [
    ((16, 784, 4, 32), 5.09, None),     # morpho serving, bound by operations
    ((16, 49, 4, 64), 0.48, None),      # morpho serving's middle block, by bytes
    ((32, 144, 4, 128), 5.63, 9.86),    # pendulum training, by bytes
    ((16, 144, 4, 128), 2.82, None),    # pendulum serving
])
def test_attention_bound_matches_the_kernel_table(shape, fwd_us, bwd_us):
    """The bound column of PERF.md's kernel table (chip_smoke's arithmetic)."""
    assert counts.attention_fwd_bound_s(*shape) * 1e6 == pytest.approx(fwd_us, abs=0.005)
    if bwd_us is not None:
        assert counts.attention_bwd_bound_s(*shape) * 1e6 == pytest.approx(bwd_us, abs=0.005)


def test_attention_shapes_follow_the_configuration():
    assert counts.attention_shapes(_model("pendulum_causaldae"), 32) == [(32, 144, 4, 128)]
    morpho = counts.attention_shapes(_model("morphomnist_causaldae"), 16)
    assert sorted(set(morpho)) == [(16, 49, 4, 64), (16, 784, 4, 32)]
    assert morpho.count((16, 784, 4, 32)) == 7
